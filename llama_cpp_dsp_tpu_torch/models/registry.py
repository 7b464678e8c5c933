"""GGUF metadata → LlamaConfig (counterpart of the JAX package's
models/registry.py, cut down to the `llama` architecture).

The other architectures of the JAX registry are queued in ROADMAP.md
(queue A, slice 3).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from ..gguf.constants import Keys
from ..ops.rope import RopeParams
from .llama import LlamaConfig


@dataclass(frozen=True)
class ArchSpec:
    name: str
    fused_gate_up: bool = False  # blk.N.ffn_up.weight holds [2*n_ff, C]


ARCHS: dict[str, ArchSpec] = {"llama": ArchSpec("llama")}


def arch_spec(arch: str) -> ArchSpec:
    spec = ARCHS.get(arch)
    if spec is None:
        raise NotImplementedError(
            f"architecture {arch!r}: only 'llama' is ported (ROADMAP.md queue A, slice 3)")
    return spec


def config_from_gguf(kv: dict[str, Any]) -> LlamaConfig:
    """GGUF metadata → LlamaConfig (reference llama_model::load_hparams)."""
    arch = str(kv[Keys.General.ARCHITECTURE])
    arch_spec(arch)

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
        mode="norm",
        freq_base=float(get(Keys.LLM.ROPE_FREQ_BASE, 10000.0)),
        freq_scale=freq_scale,
        ext_factor=ext_factor,
        n_ctx_orig=int(get(Keys.LLM.ROPE_SCALING_ORIG_CTX, 0) or 0),
    )
    eps = get(Keys.LLM.ATTN_LAYERNORM_RMS_EPS)
    if eps is None:
        eps = get(Keys.LLM.ATTN_LAYERNORM_EPS, 1e-5)
    return LlamaConfig(
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
    )
