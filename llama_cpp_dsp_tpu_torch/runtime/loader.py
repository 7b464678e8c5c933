"""Model loader: GGUF file → (config, params, vocab, tokenizer).

Counterpart of the JAX package's runtime/loader.py (`load_model`,
`_split_fused`, `LoadedModel`) for the llama architecture. Tensors are
repacked into QTensors on the CPU; LlamaContext moves them to its device.

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
from ..models.llama import LlamaConfig
from ..models.registry import arch_spec, config_from_gguf
from ..ops.qtensor import PACKED_KINDS, QTensor, from_gguf_tensor
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
    "ffn_norm.weight": "ffn_norm",
    "ffn_gate.weight": "ffn_gate",
    "ffn_up.weight": "ffn_up",
    "ffn_down.weight": "ffn_down",
}

_GLOBAL_TENSORS = {
    "token_embd.weight": "token_embd",
    "output_norm.weight": "output_norm",
    "output.weight": "output",
    "rope_freqs.weight": "rope_freqs",
}


@dataclass
class LoadedModel:
    cfg: LlamaConfig
    params: dict[str, Any]
    vocab: Vocab
    tokenizer: Tokenizer | None

    @property
    def n_bytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in _iter_tensors(self.params))


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
        return QTensor(tree.kind, tree.shape, {k: fn(a) for k, a in tree.arrays.items()})
    return None if tree is None else fn(tree)


def _row_slice(w, start: int, stop: int):
    """Rows [start:stop) of a weight — QTensor fields are row-major on axis 0."""
    if isinstance(w, QTensor):
        return QTensor(w.kind, (stop - start, w.shape[1]),
                       {k: a[start:stop].contiguous() for k, a in w.arrays.items()})
    return w[start:stop].contiguous()


def _split_fused(params: dict[str, Any], cfg: LlamaConfig, spec) -> None:
    """Split fused attn_qkv / gate-up ffn_up tensors into the canonical keys."""
    qdim = cfg.n_heads * cfg.head_dim
    kvdim = cfg.n_kv_heads * cfg.head_dim
    for layer in params["layers"]:
        qkv = layer.pop("attn_qkv", None)
        if qkv is not None:
            layer["attn_q"] = _row_slice(qkv, 0, qdim)
            layer["attn_k"] = _row_slice(qkv, qdim, qdim + kvdim)
            layer["attn_v"] = _row_slice(qkv, qdim + kvdim, qdim + 2 * kvdim)
        if spec.fused_gate_up and "ffn_gate" not in layer and "ffn_up" in layer:
            up = layer.pop("ffn_up")
            ff = up.shape[0] // 2
            layer["ffn_gate"] = _row_slice(up, 0, ff)
            layer["ffn_up"] = _row_slice(up, ff, 2 * ff)


def load_model(path: str) -> LoadedModel:
    gm = GGUFModel.load(path)
    cfg = config_from_gguf(gm.kv)
    spec = arch_spec(cfg.arch)
    params: dict[str, Any] = {"layers": [{} for _ in range(cfg.n_layers)]}
    for name, info in gm.tensors.items():
        if name in _GLOBAL_TENSORS:
            params[_GLOBAL_TENSORS[name]] = from_gguf_tensor(
                info.data, info.ggml_type, info.np_shape)
            continue
        if name.startswith("blk."):
            _, idx, rest = name.split(".", 2)
            key = _LAYER_TENSORS.get(rest)
            if key is not None:
                params["layers"][int(idx)][key] = from_gguf_tensor(
                    info.data, info.ggml_type, info.np_shape)
                continue
        log.warning("unmapped tensor %s", name)
    _split_fused(params, cfg, spec)
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
    (`.kind`, `.shape`, `.arrays` of numpy arrays)."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [params_from_numpy(v, device) for v in tree]
    if tree is None:
        return None
    if hasattr(tree, "arrays") and hasattr(tree, "kind"):
        kind = GGMLType(int(tree.kind))
        if kind not in PACKED_KINDS or getattr(tree, "n_expert", 0):
            raise NotImplementedError(
                f"params_from_numpy: {kind.name} (ROADMAP.md queue B, row B1)")
        return QTensor(kind, tuple(int(s) for s in tree.shape),
                       {k: _dense_from_numpy(np.asarray(a)).to(device)
                        for k, a in tree.arrays.items()})
    return _dense_from_numpy(np.asarray(tree)).to(device)
