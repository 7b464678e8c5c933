"""GGUF metadata → LlamaConfig (counterpart of the JAX package's
models/registry.py, cut down to the architectures the port runs: `llama`,
`mistral`, the Qwen family (`qwen2`, `qwen2moe`, `qwen3`, `qwen3moe`),
`phi3`, `deepseek2` and the Gemma family (`gemma`, `gemma2`, `gemma3`)).

Per-architecture flags come from an override function, applied last, as
the JAX registry applies its `ArchSpec.overrides`; the rope mode is NEOX for
the architectures of `_NEOX_ROPE_ARCHS` and NORM otherwise, as in JAX. The
other architectures of the JAX registry are queued in ROADMAP.md (queue A,
A3).
"""

from __future__ import annotations

import math
from collections.abc import Callable
from dataclasses import dataclass
from typing import Any

from ..gguf.constants import Keys
from ..ops.rope import RopeParams
from .llama import LlamaConfig


def _deepseek(get) -> dict:
    """llm_build_deepseek (JAX registry.py::_deepseek): leading dense layers,
    a routed-weight scale, shared experts, no renormalisation."""
    return {
        "moe_shared_expert": True,
        "moe_norm_weights": False,
        "moe_scale": float(get(Keys.LLM.EXPERT_WEIGHTS_SCALE, 1.0)),
        "n_dense_layers": int(get(Keys.LLM.LEADING_DENSE_BLOCK_COUNT, 1) or 1),
    }


def _deepseek2(get) -> dict:
    """llm_build_deepseek2 (JAX registry.py::_deepseek2): MLA on top of
    `_deepseek`; the rope dims are rope.dimension_count, the nope dims the
    rest of key_length; gating func 2 (V3) is a sigmoid router."""
    rope_dim = int(get(Keys.LLM.ROPE_DIMENSION_COUNT, 64) or 64)
    key_len = int(get(Keys.LLM.ATTN_KEY_LENGTH, 192) or 192)
    gating = int(get(Keys.LLM.EXPERT_GATING_FUNC, 1) or 1)
    return {
        **_deepseek(get),
        "q_lora_rank": int(get(Keys.LLM.ATTN_Q_LORA_RANK, 0) or 0),
        "kv_lora_rank": int(get(Keys.LLM.ATTN_KV_LORA_RANK, 512) or 512),
        "qk_rope_dim": rope_dim,
        "qk_nope_dim": key_len - rope_dim,
        "v_head_dim": int(get(Keys.LLM.ATTN_VALUE_LENGTH, 128) or 128),
        "moe_norm_weights": bool(get(Keys.LLM.EXPERT_WEIGHTS_NORM, False)),
        "expert_gating": "sigmoid" if gating == 2 else "softmax",
    }


def _qwen2moe(get) -> dict:
    """llm_build_qwen2moe (JAX registry.py::_qwen2moe): a top-k softmax
    router without renormalisation, plus a sigmoid-gated shared expert."""
    return {"moe_norm_weights": False, "moe_shared_expert": True, "moe_gate_shexp": True}


def _qwen3moe(get) -> dict:
    """llm_build_qwen3moe: q/k norm; the top-k router weights renormalised
    unless the GGUF's expert_weights_norm (HF norm_topk_prob) says not."""
    return {"qk_norm": True,
            "moe_norm_weights": bool(get(Keys.LLM.EXPERT_WEIGHTS_NORM, True))}


def _gemma(get) -> dict:
    """llm_build_gemma (JAX registry.py::_gemma): GeGLU FFN, the LM head
    tied to token_embd, the embeddings scaled by √n_embd."""
    return {"act": "gelu", "tie_embeddings": True,
            "embd_scale": math.sqrt(int(get(Keys.LLM.EMBEDDING_LENGTH)))}


def _gemma2(get) -> dict:
    """llm_build_gemma2 (JAX registry.py::_gemma2): post norms, attention
    and final logit softcaps, a sliding window on every other layer."""
    return {**_gemma(get), "post_norms": True,
            "attn_logit_softcap": float(get(Keys.LLM.ATTN_LOGIT_SOFTCAPPING, 50.0)),
            "final_logit_softcap": float(get(Keys.LLM.FINAL_LOGIT_SOFTCAPPING, 30.0)),
            "swa_window": int(get(Keys.LLM.SLIDING_WINDOW, 4096) or 0), "swa_pattern": 2}


def _gemma3(get) -> dict:
    """llm_build_gemma3 (JAX registry.py::_gemma3): post norms, q/k norm, a
    sliding window on five layers of six, whose rope takes base 1e4."""
    return {**_gemma(get), "post_norms": True, "qk_norm": True,
            "swa_window": int(get(Keys.LLM.SLIDING_WINDOW, 1024) or 0), "swa_pattern": 6,
            "rope_local_base": 10000.0}


@dataclass(frozen=True)
class ArchSpec:
    name: str
    overrides: Callable[[Callable], dict] | None = None  # get → LlamaConfig fields
    # the arch's GGUF layout, for the writer (tools/synth.py): its files carry
    # blk.N.attn_qkv.weight; the loader splits an attn_qkv whatever the arch
    fused_qkv: bool = False
    fused_gate_up: bool = False  # blk.N.ffn_up.weight holds [2*n_ff, C]


ARCHS: dict[str, ArchSpec] = {spec.name: spec for spec in (
    ArchSpec("llama"),
    ArchSpec("mistral"),
    ArchSpec("qwen2"),
    ArchSpec("qwen2moe", _qwen2moe),
    ArchSpec("qwen3", lambda get: {"qk_norm": True}),
    ArchSpec("qwen3moe", _qwen3moe),
    ArchSpec("phi3", fused_qkv=True, fused_gate_up=True),
    ArchSpec("deepseek2", _deepseek2),
    ArchSpec("gemma", _gemma),
    ArchSpec("gemma2", _gemma2),
    ArchSpec("gemma3", _gemma3),
)}

# llama_model_rope_type's NEOX list (JAX registry.py::_NEOX_ROPE_ARCHS, cut
# down to the port's archs): every other arch rotates NORM (interleaved
# pairs). The wrong mode moves a tiny model's logits by only ~1e-3, below
# loose tolerances, so the tests pin it.
_NEOX_ROPE_ARCHS = {"qwen2", "qwen2moe", "qwen3", "qwen3moe", "phi3", "gemma", "gemma2",
                    "gemma3"}


def arch_spec(arch: str) -> ArchSpec:
    spec = ARCHS.get(arch)
    if spec is None:
        raise NotImplementedError(
            f"architecture {arch!r}: the port has {', '.join(map(repr, ARCHS))} "
            "(ROADMAP.md queue A, A3)")
    return spec


def config_from_gguf(kv: dict[str, Any]) -> LlamaConfig:
    """GGUF metadata → LlamaConfig (reference llama_model::load_hparams)."""
    arch = str(kv[Keys.General.ARCHITECTURE])
    spec = arch_spec(arch)

    def get(template: str, default=None):
        return kv.get(template.format(arch=arch), default)

    n_embd = int(get(Keys.LLM.EMBEDDING_LENGTH))
    n_heads = int(get(Keys.LLM.ATTN_HEAD_COUNT))
    n_kv_heads = int(get(Keys.LLM.ATTN_HEAD_COUNT_KV, n_heads) or n_heads)
    head_dim = int(get(Keys.LLM.ATTN_KEY_LENGTH, n_embd // n_heads))
    n_vocab = int(get(Keys.LLM.VOCAB_SIZE, 0)) or len(kv.get(Keys.Tokenizer.LIST, []))

    scaling_type = get(Keys.LLM.ROPE_SCALING_TYPE, "none")
    factor = float(get(Keys.LLM.ROPE_SCALING_FACTOR, 1.0) or 1.0)
    freq_scale, ext_factor = 1.0, 0.0
    if scaling_type == "linear" and factor:
        freq_scale = 1.0 / factor
    elif scaling_type == "yarn" and factor:
        freq_scale, ext_factor = 1.0 / factor, 1.0
    rope = RopeParams(
        n_dims=int(get(Keys.LLM.ROPE_DIMENSION_COUNT, head_dim)),
        mode="neox" if arch in _NEOX_ROPE_ARCHS else "norm",
        freq_base=float(get(Keys.LLM.ROPE_FREQ_BASE, 10000.0)),
        freq_scale=freq_scale,
        ext_factor=ext_factor,
        n_ctx_orig=int(get(Keys.LLM.ROPE_SCALING_ORIG_CTX, 0) or 0),
    )
    eps = get(Keys.LLM.ATTN_LAYERNORM_RMS_EPS)
    if eps is None:
        eps = get(Keys.LLM.ATTN_LAYERNORM_EPS, 1e-5)
    fields = dict(
        arch=arch,
        n_layers=int(get(Keys.LLM.BLOCK_COUNT)),
        n_embd=n_embd,
        n_heads=n_heads,
        n_kv_heads=n_kv_heads,
        head_dim=head_dim,
        n_ff=int(get(Keys.LLM.FEED_FORWARD_LENGTH, 0) or 0),
        n_vocab=n_vocab,
        n_ctx_train=int(get(Keys.LLM.CONTEXT_LENGTH, 2048)),
        rms_eps=float(eps),
        rope=rope,
        n_expert=int(get(Keys.LLM.EXPERT_COUNT, 0) or 0),
        n_expert_used=int(get(Keys.LLM.EXPERT_USED_COUNT, 0) or 0),
    )
    if spec.overrides:
        fields.update(spec.overrides(get))  # per-arch overrides win, as in JAX
    return LlamaConfig(**fields)
