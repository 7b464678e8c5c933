"""Packed dequant-matmul y = x · dequant(W)ᵀ for Q4_0 and Q8_0 weights.

Counterpart of the JAX package's ops/pallas/qmm.py (`qmm_fused`). The CUDA
kernels are in csrc/qmm.cu: a GEMV for B ≤ 8 (decode) and a tiled
tensor-core kernel for larger B (prefill).

Tolerance: the kernels and `qmm_plain` agree with x · exact-f32-dequant(W)ᵀ
to NMSE ≤ 5e-4 (the reference's MUL_MAT tolerance, as in
tests/test_pallas_qmm.py). The plain version rounds the dequantized weight
to bf16 before an f32 product, as the JAX package's XLA path does; the GEMV
keeps the exact f32 weight and applies each block's scale to the block's
integer dot, as ggml's vec_dot does.
"""

from __future__ import annotations

import torch

from ...gguf.constants import GGMLType
from ...quant.dequant import dequant
from . import LAUNCHES, aligned16, stream_handle

_ENTRY = {GGMLType.Q4_0: "qmm_q4_0", GGMLType.Q8_0: "qmm_q8_0"}
_QS_DTYPE = {GGMLType.Q4_0: torch.uint8, GGMLType.Q8_0: torch.int8}


def qmm_plain(x: torch.Tensor, w) -> torch.Tensor:
    """[..., K] · QTensor [N, K]ᵀ → [..., N] f32, plain PyTorch."""
    wd = dequant(w, torch.bfloat16).float()
    return x.to(torch.bfloat16).float() @ wd.T


def qmm(x: torch.Tensor, w) -> torch.Tensor:
    """[..., K] · QTensor [N, K]ᵀ → [..., N] f32 (x taken as bf16)."""
    if x.device.type == "cpu":
        return qmm_plain(x, w)
    from .build import check, lib

    n, k = w.shape
    entry = _ENTRY.get(w.kind)
    if entry is None:
        raise NotImplementedError(f"qmm kernel for {w.kind.name} (ROADMAP.md queue B, B1)")
    qs, d = w["qs"], w["d"]
    if x.shape[-1] != k or k % 32:
        raise ValueError(f"qmm: x {tuple(x.shape)} vs W {w.shape} (K % 32 == 0)")
    if qs.device != x.device or d.device != x.device:
        raise ValueError(f"qmm: x on {x.device}, W on {qs.device}")
    if (qs.dtype != _QS_DTYPE[w.kind] or d.dtype != torch.float16
            or qs.shape != (n, k // 2 if w.kind == GGMLType.Q4_0 else k)
            or d.shape != (n, k // 32)):
        raise ValueError(f"qmm: bad {w.kind.name} fields {qs.dtype}{tuple(qs.shape)} "
                         f"{d.dtype}{tuple(d.shape)}")
    if not (qs.is_contiguous() and d.is_contiguous()) or qs.data_ptr() % 16:
        raise ValueError("qmm: weight fields must be contiguous and 16-byte aligned")
    lead = x.shape[:-1]
    x2 = aligned16(x.reshape(-1, k).to(torch.bfloat16).contiguous())
    b = x2.shape[0]
    y = torch.empty(b, n, dtype=torch.float32, device=x.device)
    if b:
        rc = getattr(lib(), entry)(x2.data_ptr(), qs.data_ptr(), d.data_ptr(), y.data_ptr(),
                                   b, n, k, stream_handle(x))
        check(rc, entry)
        LAUNCHES[entry] += 1
    return y.reshape(*lead, n)
