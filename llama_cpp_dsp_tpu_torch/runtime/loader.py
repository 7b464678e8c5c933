"""Model loader: GGUF file → (config, params, vocab, tokenizer).

Counterpart of the JAX package's runtime/loader.py (`load_model`,
`_split_fused`, `LoadedModel`) for the architectures of
models/registry.py (llama, mistral, the Qwen family, phi3, deepseek2).
Tensors are repacked into QTensors on the CPU; LlamaContext moves them to
its device. An MLA model's attn_kv_b is split into bf16 W_uk / W_uv here,
once (`models/deepseek2.py::split_kv_b`). A tensor that the JAX loader maps
and the port cannot run yet (a bias, an extra norm or scale, another
family's rows) refuses the file, naming its ROADMAP.md row: running without
it would change the model's output.

`params_from_numpy` carries the JAX loader's parameter tree (numpy arrays
and JAX QTensors, read by duck typing: `.kind`, `.shape`, `.arrays`) over to
this port's tree, so both can run on the same weights.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..gguf.constants import GGMLType
from ..gguf.reader import GGUFModel
from ..models.deepseek2 import split_kv_b
from ..models.llama import LlamaConfig
from ..models.registry import arch_spec, config_from_gguf
from ..ops.qtensor import IQ_KINDS, PACKED_KINDS, QTensor, from_gguf_tensor
from ..tokenizer import Tokenizer, Vocab

log = logging.getLogger(__name__)

# per-layer tensor suffixes → param keys (the llama rows of the reference's
# LLM_TENSOR_NAMES)
_LAYER_TENSORS = {
    "attn_norm.weight": "attn_norm",
    "attn_q.weight": "attn_q",
    "attn_k.weight": "attn_k",
    "attn_v.weight": "attn_v",
    "attn_qkv.weight": "attn_qkv",
    "attn_output.weight": "attn_output",
    # Qwen2 q/k/v biases (a fused qkv bias is split like its weight) and
    # Qwen3 per-head q/k norms
    "attn_q.bias": "attn_q_bias",
    "attn_k.bias": "attn_k_bias",
    "attn_v.bias": "attn_v_bias",
    "attn_qkv.bias": "attn_qkv_bias",
    "attn_q_norm.weight": "attn_q_norm",
    "attn_k_norm.weight": "attn_k_norm",
    "ffn_norm.weight": "ffn_norm",
    # Gemma 2 / 3 post norms, under either of their GGUF names
    "attn_post_norm.weight": "attn_post_norm",
    "post_attention_norm.weight": "attn_post_norm",
    "ffn_post_norm.weight": "ffn_post_norm",
    "post_ffw_norm.weight": "ffn_post_norm",
    "ffn_gate.weight": "ffn_gate",
    "ffn_up.weight": "ffn_up",
    "ffn_down.weight": "ffn_down",
    # MoE (Mixtral): the router [E, C] and the expert stacks [E, N, K]
    "ffn_gate_inp.weight": "ffn_gate_inp",
    "ffn_gate_exps.weight": "ffn_gate_exps",
    "ffn_up_exps.weight": "ffn_up_exps",
    "ffn_down_exps.weight": "ffn_down_exps",
    # shared experts (DeepSeek-V2), with an optional sigmoid gate
    "ffn_gate_inp_shexp.weight": "ffn_gate_inp_shexp",
    "ffn_gate_shexp.weight": "ffn_gate_shexp",
    "ffn_up_shexp.weight": "ffn_up_shexp",
    "ffn_down_shexp.weight": "ffn_down_shexp",
    # DeepSeek-V3-style selection bias (sigmoid routers)
    "exp_probs_b.bias": "ffn_exp_probs_b",
    # DeepSeek-V2 MLA (the reference's LLM_ARCH_DEEPSEEK2 tensor table)
    "attn_q_a.weight": "attn_q_a",
    "attn_q_a_norm.weight": "attn_q_a_norm",
    "attn_q_b.weight": "attn_q_b",
    "attn_kv_a_mqa.weight": "attn_kv_a_mqa",
    "attn_kv_a_norm.weight": "attn_kv_a_norm",
    "attn_kv_b.weight": "attn_kv_b",
}

_GLOBAL_TENSORS = {
    "token_embd.weight": "token_embd",
    "output_norm.weight": "output_norm",
    "output.weight": "output",
    "rope_freqs.weight": "rope_freqs",
}

# tensors the JAX loader maps (its runtime/loader.py _LAYER_TENSORS and
# _GLOBAL_TENSORS) and the port does not run yet → the ROADMAP.md row that
# brings them: A3 the biases, norms, scales and arctic rows of other
# decoder archs, A8 the other model families (SSM, RWKV, BERT)
_A3_LAYER = (
    "attn_norm.bias", "attn_norm_2.weight", "attn_norm_2.bias", "attn_output.bias",
    "attn_q_norm.bias", "attn_k_norm.bias", "attn_sub_norm.weight", "ffn_sub_norm.weight",
    "attn_q.scale", "attn_k.scale", "attn_v.scale", "attn_output.scale", "ffn_gate.scale",
    "ffn_up.scale", "ffn_down.scale", "ffn_norm.bias", "ffn_gate.bias", "ffn_up.bias",
    "ffn_down.bias", "ffn_norm_exps.weight",
)
_A8_LAYER = (
    "ssm_in.weight", "ssm_conv1d.weight", "ssm_conv1d.bias", "ssm_x.weight", "ssm_dt.weight",
    "ssm_dt.bias", "ssm_a", "ssm_d", "ssm_out.weight",
    *(f"time_mix_{n}.weight" for n in (
        "w1", "w2", "lerp_x", "lerp_w", "lerp_k", "lerp_v", "lerp_r", "lerp_g", "first",
        "decay", "decay_w1", "decay_w2", "key", "value", "receptance", "gate", "ln", "output",
        "w0", "a0", "a1", "a2", "v0", "v1", "v2", "g1", "g2", "k_k", "k_a", "r_k",
        "lerp_fused")),
    "time_mix_key.bias", "time_mix_value.bias", "time_mix_receptance.bias",
    "time_mix_ln.bias",
    *(f"channel_mix_{n}.weight" for n in ("lerp_k", "lerp_r", "key", "value", "receptance")),
    "attn_output_norm.weight", "attn_output_norm.bias", "layer_output_norm.weight",
    "layer_output_norm.bias",
)
_UNPORTED_LAYER = {**{t: "A3" for t in _A3_LAYER}, **{t: "A8" for t in _A8_LAYER}}
_UNPORTED_GLOBAL = {
    "token_embd_norm.weight": "A3", "token_embd_norm.bias": "A3", "output_norm.bias": "A3",
    "output.bias": "A3", "rope_factors_long.weight": "A3", "position_embd.weight": "A8",
    "token_types.weight": "A8", "cls.weight": "A8", "cls.bias": "A8",
    "cls.output.weight": "A8", "cls.output.bias": "A8",
}


def _refuse_unported(name: str) -> None:
    """Raise for a tensor the JAX loader maps and the port cannot run yet."""
    rest = name.split(".", 2)[2] if name.startswith("blk.") else None
    row = _UNPORTED_LAYER.get(rest) if rest else _UNPORTED_GLOBAL.get(name)
    if row:
        raise NotImplementedError(
            f"tensor {name}: the port does not run it yet (ROADMAP.md queue A, {row})")


@dataclass
class LoadedModel:
    cfg: LlamaConfig
    params: dict[str, Any]
    vocab: Vocab
    tokenizer: Tokenizer | None

    @property
    def n_bytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in _iter_tensors(self.params))

    @property
    def n_params(self) -> int:
        """Weight elements (a packed tensor counts its logical [N, K], an
        expert stack E·N·K)."""
        def count(tree):
            if isinstance(tree, dict):
                return sum(count(v) for v in tree.values())
            if isinstance(tree, list):
                return sum(count(v) for v in tree)
            if isinstance(tree, QTensor):
                return tree.shape[0] * tree.shape[1] * max(tree.n_expert, 1)
            return 0 if tree is None else tree.numel()

        return count(self.params)


def _iter_tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _iter_tensors(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _iter_tensors(v)
    elif isinstance(tree, QTensor):
        yield from tree.arrays.values()
    elif tree is not None:
        yield tree


def map_tensors(tree, fn):
    """Apply fn to every tensor of a params tree (QTensor fields included)."""
    if isinstance(tree, dict):
        return {k: map_tensors(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_tensors(v, fn) for v in tree]
    if isinstance(tree, QTensor):
        return QTensor(tree.kind, tree.shape, {k: fn(a) for k, a in tree.arrays.items()},
                       tree.n_expert)
    return None if tree is None else fn(tree)


def _row_slice(w, start: int, stop: int):
    """Rows [start:stop) of a weight — QTensor fields are row-major on the
    axis after an expert stack's leading one."""
    if isinstance(w, QTensor):
        if w.n_expert:
            return QTensor(w.kind, (stop - start, w.shape[1]),
                           {k: a[:, start:stop].contiguous() for k, a in w.arrays.items()},
                           w.n_expert)
        return QTensor(w.kind, (stop - start, w.shape[1]),
                       {k: a[start:stop].contiguous() for k, a in w.arrays.items()})
    return w[start:stop].contiguous()


def _split_fused(params: dict[str, Any], cfg: LlamaConfig, spec) -> None:
    """Split fused attn_qkv (and its bias) / gate-up ffn_up tensors into the
    canonical keys."""
    qdim = cfg.n_heads * cfg.head_dim
    kvdim = cfg.n_kv_heads * cfg.head_dim
    parts = (("q", 0, qdim), ("k", qdim, qdim + kvdim), ("v", qdim + kvdim, qdim + 2 * kvdim))
    for layer in params["layers"]:
        for key, suffix in (("attn_qkv", ""), ("attn_qkv_bias", "_bias")):
            fused = layer.pop(key, None)
            if fused is not None:
                for part, lo, hi in parts:
                    layer[f"attn_{part}{suffix}"] = _row_slice(fused, lo, hi)
        if spec.fused_gate_up and "ffn_gate" not in layer and "ffn_up" in layer:
            up = layer.pop("ffn_up")
            ff = up.shape[0] // 2
            layer["ffn_gate"] = _row_slice(up, 0, ff)
            layer["ffn_up"] = _row_slice(up, ff, 2 * ff)


def load_model(path: str, device=None) -> LoadedModel:
    """`device`: where the IQ / TQ kinds' table carriers are decomposed and
    kept (`ops/qtensor.py::repack`; the CPU by default). The card does it in
    a fraction of the host's time for a multi-GB model; every other tensor
    is repacked on the CPU and moved by the context."""
    gm = GGUFModel.load(path)
    cfg = config_from_gguf(gm.kv)
    spec = arch_spec(cfg.arch)
    params: dict[str, Any] = {"layers": [{} for _ in range(cfg.n_layers)]}
    for name, info in gm.tensors.items():
        _refuse_unported(name)
        if name in _GLOBAL_TENSORS:
            params[_GLOBAL_TENSORS[name]] = from_gguf_tensor(
                info.data, info.ggml_type, info.np_shape, device)
            continue
        if name.startswith("blk."):
            _, idx, rest = name.split(".", 2)
            key = _LAYER_TENSORS.get(rest)
            if key is not None:
                params["layers"][int(idx)][key] = from_gguf_tensor(
                    info.data, info.ggml_type, info.np_shape, device)
                continue
        log.warning("unmapped tensor %s", name)
    _split_fused(params, cfg, spec)
    if cfg.kv_lora_rank:  # MLA: W_uk / W_uv split out of attn_kv_b once
        split_kv_b(params, cfg)
    ff = params.pop("rope_freqs", None)
    if ff is not None:  # shared by every layer (same tensor, no copy)
        for layer in params["layers"]:
            layer["rope_freqs"] = ff
    vocab = Vocab.from_gguf_kv(gm.kv)
    tokenizer = None
    try:
        tokenizer = Tokenizer(vocab)
    except NotImplementedError:
        log.warning("no tokenizer for vocab type %s", vocab.vocab_type)
    return LoadedModel(cfg, params, vocab, tokenizer)


def _dense_from_numpy(a: np.ndarray) -> torch.Tensor:
    if a.dtype.name == "bfloat16":  # ml_dtypes bf16
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def params_from_numpy(tree, device="cpu"):
    """The JAX loader's params (before its convert_params_to_kernel) → this
    port's tree on `device`. Packed leaves are recognized by duck typing
    (`.kind`, `.shape`, `.arrays` of numpy arrays); their fields, the IQ4
    nibbles and the table carrier's codes and scales among them, carry
    across unchanged."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [params_from_numpy(v, device) for v in tree]
    if tree is None:
        return None
    if hasattr(tree, "arrays") and hasattr(tree, "kind"):
        kind = GGMLType(int(tree.kind))
        if kind not in PACKED_KINDS and kind not in IQ_KINDS:
            raise NotImplementedError(f"params_from_numpy: {kind.name} has no packed layout")
        return QTensor(kind, tuple(int(s) for s in tree.shape),
                       {k: _dense_from_numpy(np.asarray(a)).to(device)
                        for k, a in tree.arrays.items()}, int(getattr(tree, "n_expert", 0)))
    return _dense_from_numpy(np.asarray(tree)).to(device)
