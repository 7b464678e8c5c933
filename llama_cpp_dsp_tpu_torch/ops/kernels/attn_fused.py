"""Fused decode attention step: Q4_0 QKV GEMV + NORM rope + in-place KV
write + attention, in one kernel (csrc/attn_fused.cu).

Counterpart of the JAX package's ops/pallas/attn_fused.py
(`attn_decode_fused`). Scope: T=1, head_dim 128, Q4_0 row-fused q|k|v
weight, contiguous bf16 cache [B,Hkv,S,128], B ≤ 8.

Rounding points follow the TPU kernel: k and v are rounded to bf16 before
they are written and before the new row's term is taken; q is rounded to
bf16 and then multiplied by the scale. Tolerance of the plain version
against the JAX kernel: max abs error 2e-2 on the output (as
tests/test_attn_fused.py), the written cache rows equal up to one bf16
rounding of the QKV products. Kernel against plain version (chip_smoke.py):
NMSE ≤ 5e-5 for each slot's output and written rows; the plain version
rounds the dequantized weight to bf16 and the kernel does not.
"""

from __future__ import annotations

import torch

from ...gguf.constants import GGMLType
from . import LAUNCHES, aligned16, stream_handle
from .qmm import qmm_plain

HEAD_DIM = 128
MAX_BATCH = 8
_SMEM_LIMIT = 160 * 1024  # the kernel's dynamic shared-memory opt-in


def in_scope(b: int, h: int, hkv: int) -> bool:
    """Batch and head counts the kernel takes: B ≤ 8, H a multiple of Hkv,
    and the block's QKV rows (f32, B × (H/Hkv + 2) × 128) in shared memory."""
    return (1 <= b <= MAX_BATCH and hkv > 0 and h % hkv == 0
            and b * (h // hkv + 2) * HEAD_DIM * 4 <= _SMEM_LIMIT)


def rope_norm(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """NORM-mode rope of [B, n, D] f32 with per-slot angles [B, D/2]."""
    x0, x1 = x[..., 0::2], x[..., 1::2]
    c, s = cos[:, None, :], sin[:, None, :]
    return torch.stack([x0 * c - x1 * s, x0 * s + x1 * c], dim=-1).reshape(x.shape)


def attn_fused_plain(x, w_qkv, k_cache, v_cache, cos, sin, lengths, starts, write_pos, *,
                     n_heads: int, n_kv_heads: int, scale: float,
                     softcap: float = 0.0) -> torch.Tensor:
    """Plain PyTorch version; writes the caches in place like the kernel."""
    b = x.shape[0]
    h, hkv, d = n_heads, n_kv_heads, HEAD_DIM
    s_total = k_cache.shape[2]
    qkv = qmm_plain(x, w_qkv)
    q = rope_norm(qkv[:, : h * d].reshape(b, h, d), cos, sin)
    k = rope_norm(qkv[:, h * d:(h + hkv) * d].reshape(b, hkv, d), cos, sin)
    kq = k.to(torch.bfloat16)
    vq = qkv[:, (h + hkv) * d:].reshape(b, hkv, d).to(torch.bfloat16)
    for bi in range(b):
        wp = int(write_pos[bi])
        if 0 <= wp < s_total:
            k_cache[bi, :, wp] = kq[bi]
            v_cache[bi, :, wp] = vq[bi]
    rep = h // hkv
    qs = (q.to(torch.bfloat16).float() * scale).reshape(b, hkv, rep, d)
    sc = torch.einsum("bhrd,bhsd->bhrs", qs, k_cache.float())
    s_new = (qs * kq.float()[:, :, None, :]).sum(-1, keepdim=True)
    if softcap:
        sc = torch.tanh(sc / softcap) * softcap
        s_new = torch.tanh(s_new / softcap) * softcap
    j = torch.arange(s_total, device=x.device)
    st = torch.zeros_like(lengths) if starts is None else starts
    valid = (j[None, :] < (lengths - 1)[:, None]) & (j[None, :] >= st[:, None])
    sc = sc.masked_fill(~valid[:, None, None, :], float("-inf"))
    sc = torch.cat([s_new, sc], dim=-1)  # the new row's term first
    p = torch.softmax(sc, dim=-1)
    vals = torch.cat([vq.float()[:, :, None, :], v_cache.float()], dim=2)
    return torch.einsum("bhrs,bhsd->bhrd", p, vals).reshape(b, h, d)


def attn_decode_fused(x, w_qkv, k_cache, v_cache, cos, sin, lengths, starts=None,
                      write_pos=None, *, n_heads: int, n_kv_heads: int, scale: float,
                      softcap: float = 0.0) -> torch.Tensor:
    """x [B, K] post-norm activations; w_qkv the row-fused Q4_0 q|k|v
    QTensor; k_cache/v_cache this layer's [B,Hkv,S,128] bf16 buffers
    (written at write_pos, dropped outside [0, S)); cos/sin [B, 64] f32;
    lengths [B] rows INCLUDING the new one; write_pos defaults to
    lengths-1. Returns attn [B, H, 128] f32."""
    if write_pos is None:
        write_pos = lengths - 1
    if x.device.type == "cpu":
        return attn_fused_plain(x, w_qkv, k_cache, v_cache, cos, sin, lengths, starts,
                                write_pos, n_heads=n_heads, n_kv_heads=n_kv_heads,
                                scale=scale, softcap=softcap)
    from .build import check, lib

    b, kdim = x.shape
    h, hkv, d = n_heads, n_kv_heads, HEAD_DIM
    qs, dsc = w_qkv["qs"], w_qkv["d"]
    if (not in_scope(b, h, hkv) or w_qkv.kind != GGMLType.Q4_0
            or w_qkv.shape != ((h + 2 * hkv) * d, kdim) or kdim % 32
            or k_cache.shape != (b, hkv, k_cache.shape[2], d) or k_cache.shape != v_cache.shape
            or k_cache.dtype != torch.bfloat16 or v_cache.dtype != torch.bfloat16):
        raise ValueError(f"attn_decode_fused: out of scope: x {tuple(x.shape)}, W "
                         f"{w_qkv.kind.name}{w_qkv.shape}, cache {tuple(k_cache.shape)} "
                         f"{k_cache.dtype}, H={h} Hkv={hkv}")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in (qs, k_cache, v_cache)):
        raise ValueError("attn_decode_fused: weight and cache must be contiguous and "
                         "16-byte aligned")
    if not dsc.is_contiguous():
        raise ValueError("attn_decode_fused: weight scales must be contiguous")
    for t in (qs, dsc, k_cache, v_cache, cos, sin, lengths, write_pos):
        if t.device != x.device:
            raise ValueError(f"attn_decode_fused: tensors on {t.device} and {x.device}")
    xb = aligned16(x.to(torch.bfloat16).contiguous())
    cs = cos.float().contiguous()
    sn = sin.float().contiguous()
    ln = lengths.to(torch.int32).contiguous()
    wp = write_pos.to(torch.int32).contiguous()
    st = None if starts is None else starts.to(device=x.device, dtype=torch.int32).contiguous()
    out = torch.empty(b, h, d, dtype=torch.float32, device=x.device)
    rc = lib().attn_fused_q4_0(
        xb.data_ptr(), qs.data_ptr(), dsc.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        cs.data_ptr(), sn.data_ptr(), ln.data_ptr(), None if st is None else st.data_ptr(),
        wp.data_ptr(), out.data_ptr(), b, h, hkv, k_cache.shape[2], kdim, float(scale),
        float(softcap), stream_handle(x))
    check(rc, "attn_fused_q4_0")
    LAUNCHES["attn_fused"] += 1
    return out
