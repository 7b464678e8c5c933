"""Llama transformer on torch tensors (counterpart of the JAX package's
models/llama.py, for the plain-llama graph).

rms_norm → q/k/v projection → rope → attention over the KV cache → output
projection → rms_norm → SwiGLU FFN → residual; final norm → lm_head.
Weights are QTensors (packed GGUF blocks) or dense tensors; matmuls go
through ops.qmm, which launches the hand-written kernels on the card.

Decode (T=1) takes the fused attention kernel when `fused` is on and the
layer fits its scope, else the flash-decode kernel (head_dim 128); prefill
(T>1) and other head dims take the plain `attention` below, as the JAX
package's XLA path does.
The residual stream follows JAX's dtype promotion: bf16 embeddings, f32
after the first residual add.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any

import torch

from ..gguf.constants import GGMLType
from ..ops import QTensor, qmm, rms_norm, silu, softmax_f32, take_rows
from ..ops.rope import RopeParams, _rope_angles, apply_rope
from ..runtime.kv_cache import KVCache, causal_mask


@dataclass(frozen=True)
class LlamaConfig:
    arch: str
    n_layers: int
    n_embd: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    n_ff: int
    n_vocab: int
    n_ctx_train: int
    rms_eps: float = 1e-5
    rope: RopeParams = field(default_factory=lambda: RopeParams(n_dims=0))


Params = dict[str, Any]
COMPUTE_DTYPE = torch.bfloat16  # activations between the matmuls (as JAX's default)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor | None,
              scale: float) -> torch.Tensor:
    """Masked multi-head attention, f32 softmax and accumulation.
    q [B,T,H,D] (roped), k/v [B,Hkv,S,D], mask [B,T,S] bool → [B,T,H*D] f32."""
    b, t, h, d = q.shape
    hkv = k.shape[1]
    qf = q.float().reshape(b, t, hkv, h // hkv, d)
    scores = torch.einsum("bthrd,bhsd->bhrts", qf, k.float()) * scale
    if mask is not None:
        bias = torch.where(mask, 0.0, torch.finfo(torch.float32).min)
        scores = scores + bias[:, None, None, :, :]
    probs = softmax_f32(scores, dim=-1)
    out = torch.einsum("bhrts,bhsd->bthrd", probs, v.float())
    return out.reshape(b, t, h * d)


def ffn_dense(x: torch.Tensor, layer: Params, cfg: LlamaConfig) -> torch.Tensor:
    """SwiGLU FFN; a row-fused gate|up weight is one qmm call."""
    if "ffn_gateup_fused" in layer:
        gu = qmm(x, layer["ffn_gateup_fused"])
        gate, up = gu[..., :cfg.n_ff], gu[..., cfg.n_ff:]
    else:
        gate = qmm(x, layer["ffn_gate"])
        up = qmm(x, layer["ffn_up"])
    h = (silu(gate) * up).to(COMPUTE_DTYPE)
    return qmm(h, layer["ffn_down"])


def self_attention(x, layer: Params, cfg: LlamaConfig, positions, cache: KVCache,
                   layer_idx: int, n_past: int, fused: bool, angles: dict):
    """QKV → rope → cached attention → output projection. Returns out."""
    b, t = x.shape[:2]
    h, d = cfg.n_heads, cfg.head_dim
    if fused and t == 1:
        attn = _try_attn_fused(x, layer, cfg, positions, cache, layer_idx, n_past, angles)
        if attn is not None:
            attn = attn.reshape(b, 1, h * d).to(COMPUTE_DTYPE)
            return qmm(attn, layer["attn_output"])
    q, k, v = _project_qkv(x, layer, cfg, positions)
    return _cached_attention(q, k, v, layer, cfg, positions, cache, layer_idx, n_past)


def _try_attn_fused(x, layer, cfg, positions, cache, layer_idx, n_past, angles):
    """One-kernel decode attention (ops/kernels/attn_fused.py) when the layer
    is in the kernel's scope: Q4_0 row-fused QKV, head_dim 128, full-dim
    NORM rope, B ≤ 8 (attn_fused.in_scope). Returns attn [B, H, D] f32 or
    None. Unlike the JAX gate there is no K % 4096 rule: that rule is a TPU
    timing (misaligned scale lanes), not a limit of this kernel."""
    from ..ops.kernels.attn_fused import HEAD_DIM, attn_decode_fused, in_scope

    fused = layer.get("attn_qkv_fused")
    h, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    b = x.shape[0]
    if not (isinstance(fused, QTensor) and fused.kind == GGMLType.Q4_0):
        return None
    rp = cfg.rope
    if rp.mode != "norm" or rp.n_dims != d or d != HEAD_DIM:
        return None
    if not in_scope(b, h, hkv):
        return None
    ff = layer.get("rope_freqs")
    key = id(ff)
    if key not in angles:
        angles[key] = _rope_angles(positions[:, 0], rp, ff)
    cos, sin = angles[key]
    lengths = positions[:, 0] + 1
    write_pos = torch.full((b,), n_past, dtype=torch.int32, device=x.device)
    k_l, v_l = cache.layer(layer_idx)
    return attn_decode_fused(x[:, 0], fused, k_l, v_l, cos, sin, lengths, None, write_pos,
                             n_heads=h, n_kv_heads=hkv, scale=1.0 / math.sqrt(d))


def _project_qkv(x, layer: Params, cfg: LlamaConfig, positions):
    """QKV projections (fused or separate) and rope. Returns
    q [B,T,H,D], k [B,T,Hkv,D], v [B,T,Hkv,D]."""
    b, t, _ = x.shape
    h, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if "attn_qkv_fused" in layer:
        qkv = qmm(x, layer["attn_qkv_fused"])
        q, k, v = qkv[..., :h * d], qkv[..., h * d:(h + hkv) * d], qkv[..., (h + hkv) * d:]
    else:
        q = qmm(x, layer["attn_q"])
        k = qmm(x, layer["attn_k"])
        v = qmm(x, layer["attn_v"])
    q = q.reshape(b, t, h, d)
    k = k.reshape(b, t, hkv, d)
    v = v.reshape(b, t, hkv, d)
    ff = layer.get("rope_freqs")
    q = apply_rope(q, positions, cfg.rope, ff)
    k = apply_rope(k, positions, cfg.rope, ff)
    return q, k, v


def _cached_attention(q, k, v, layer, cfg: LlamaConfig, positions, cache: KVCache,
                      layer_idx: int, n_past: int):
    b, t = q.shape[:2]
    h, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    cache.write(layer_idx, k, v, n_past)
    scale = 1.0 / math.sqrt(d)
    k_all, v_all = cache.layer(layer_idx)
    if t == 1 and h % hkv == 0 and d == 128:
        from ..ops.kernels.attention import flash_decode

        attn = flash_decode(q[:, 0], k_all, v_all, positions[:, 0] + 1, None, scale=scale)
        attn = attn.reshape(b, 1, h * d).to(COMPUTE_DTYPE)
        return qmm(attn, layer["attn_output"])
    mask = causal_mask(positions, cache.capacity, n_past)
    attn = attention(q, k_all, v_all, mask, scale).to(COMPUTE_DTYPE)
    return qmm(attn, layer["attn_output"])


def decode_layer(x, layer: Params, cfg: LlamaConfig, positions, cache: KVCache,
                 layer_idx: int, n_past: int, fused: bool, angles: dict):
    attn_in = rms_norm(x, layer["attn_norm"], cfg.rms_eps)
    attn = self_attention(attn_in, layer, cfg, positions, cache, layer_idx, n_past, fused,
                          angles)
    x = x + attn
    ffn_in = rms_norm(x, layer["ffn_norm"], cfg.rms_eps)
    return x + ffn_dense(ffn_in, layer, cfg)


@torch.inference_mode()
def forward(params: Params, cfg: LlamaConfig, tokens: torch.Tensor, positions: torch.Tensor,
            cache: KVCache, n_past: int = 0, *, fused: bool = True) -> torch.Tensor:
    """tokens, positions [B, T] → logits [B, T, n_vocab] f32; the cache is
    written in place at rows n_past .. n_past+T-1.

    fused: decode (T=1) attention through the fused kernel when the layer is
    in its scope; off, or out of scope, decode takes flash decode."""
    x = take_rows(params["token_embd"], tokens, dtype=COMPUTE_DTYPE)
    angles: dict = {}  # rope angles, shared by the layers of one step
    for i, layer in enumerate(params["layers"]):
        x = decode_layer(x, layer, cfg, positions, cache, i, n_past, fused, angles)
    x = rms_norm(x, params["output_norm"], cfg.rms_eps)
    out_w = params.get("output")
    if out_w is None:
        out_w = params["token_embd"]
    return qmm(x, out_w)
