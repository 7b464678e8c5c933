"""Decode attention (T=1) over a bf16 KV cache.

Counterpart of the JAX package's ops/pallas/attention.py (`flash_decode`).
The CUDA kernel (csrc/flash_decode.cu) is split-S flash decoding with a
log-sum-exp merge of the splits.

Tolerance against the JAX kernel and between kernel and plain version:
atol 2e-5 with f32 inputs and 2e-3 with a bf16 cache, as in
tests/test_flash_attention.py (sums are taken in another order); on the
card (chip_smoke.py) also NMSE ≤ 1e-8 for each slot's output, which a
dropped cache row exceeds.
"""

from __future__ import annotations

import torch

from . import LAUNCHES, aligned16, stream_handle

SPLIT_ROWS = 64  # cache rows per split (one block per split, kv head and slot)


def flash_decode_plain(q, k, v, lengths, starts=None, *, scale: float,
                       softcap: float = 0.0) -> torch.Tensor:
    """q [B,H,D], k/v [B,Hkv,S,D] → [B,H,D] f32 over rows [start, length)."""
    b, h, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    rep = h // hkv
    qf = q.float().reshape(b, hkv, rep, d) * scale
    sc = torch.einsum("bhrd,bhsd->bhrs", qf, k.float())
    if softcap:
        sc = torch.tanh(sc / softcap) * softcap
    j = torch.arange(s, device=q.device)
    st = torch.zeros_like(lengths) if starts is None else starts
    valid = (j[None, :] < lengths[:, None]) & (j[None, :] >= st[:, None])
    sc = sc.masked_fill(~valid[:, None, None, :], float("-inf"))
    m = sc.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(sc - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhrs,bhsd->bhrd", p, v.float()) / l.clamp_min(1e-30)
    return out.reshape(b, h, d)


def flash_decode(q, k, v, lengths, starts=None, *, scale: float,
                 softcap: float = 0.0) -> torch.Tensor:
    """Returns [B, H, D] f32 attention output (q roped, taken in f32)."""
    if q.device.type == "cpu":
        return flash_decode_plain(q, k, v, lengths, starts, scale=scale, softcap=softcap)
    from .build import check, lib

    b, h, d = q.shape
    _, hkv, s, dk = k.shape
    if (d != 128 or dk != d or k.shape != v.shape or k.shape[0] != b or h % hkv
            or k.dtype != torch.bfloat16 or v.dtype != torch.bfloat16):
        raise ValueError(f"flash_decode: q {tuple(q.shape)} k {tuple(k.shape)} {k.dtype}: "
                         "needs D=128, a bf16 cache and H % Hkv == 0")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in (k, v)):
        raise ValueError("flash_decode: cache must be contiguous and 16-byte aligned")
    for t in (k, v, lengths):
        if t.device != q.device:
            raise ValueError(f"flash_decode: tensors on {t.device} and {q.device}")
    qf = aligned16(q.float().contiguous())
    lengths = lengths.to(torch.int32).contiguous()
    st = None if starts is None else starts.to(device=q.device, dtype=torch.int32).contiguous()
    n_splits = -(-s // SPLIT_ROWS)
    out = torch.empty(b, h, d, dtype=torch.float32, device=q.device)
    ws_acc = torch.empty(b * h * n_splits * d, dtype=torch.float32, device=q.device)
    ws_ml = torch.empty(b * h * n_splits * 2, dtype=torch.float32, device=q.device)
    rc = lib().flash_decode(qf.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
                            None if st is None else st.data_ptr(), out.data_ptr(),
                            ws_acc.data_ptr(), ws_ml.data_ptr(), b, h, hkv, s, SPLIT_ROWS,
                            float(scale), float(softcap), stream_handle(q))
    check(rc, "flash_decode")
    LAUNCHES["flash_decode"] += 1
    return out
