"""Packed dequant-matmul y = x · dequant(W)ᵀ for Q4_0, Q8_0, Q4_K, Q5_K and
Q6_K weights.

Counterpart of the JAX package's ops/pallas/qmm.py (`qmm_fused`). The CUDA
kernels are in csrc/qmm.cu: a GEMV for B ≤ 8 (decode) and a tiled
tensor-core kernel for larger B (prefill).

Tolerance: the kernels and `qmm_plain` agree with x · exact-f32-dequant(W)ᵀ
to NMSE ≤ 5e-4 (the reference's MUL_MAT tolerance, as in
tests/test_pallas_qmm.py). The plain version rounds the dequantized weight
to bf16 before an f32 product, as the JAX package's XLA path does; the GEMV
keeps the exact integer values and applies each group's scale (and, for
Q4_K/Q5_K, its min term) to the group's dot, as ggml's vec_dot does.
"""

from __future__ import annotations

import torch

from ...gguf.constants import GGMLType
from ...quant.dequant import dequant
from . import LAUNCHES, aligned16, stream_handle


def _fields(kind: GGMLType, n: int, k: int) -> list[tuple[str, torch.dtype, tuple]]:
    """(name, dtype, shape) of each weight field, in the C entry's order."""
    s = k // 256
    if kind == GGMLType.Q4_0:
        return [("qs", torch.uint8, (n, k // 2)), ("d", torch.float16, (n, k // 32))]
    if kind == GGMLType.Q8_0:
        return [("qs", torch.int8, (n, k)), ("d", torch.float16, (n, k // 32))]
    if kind == GGMLType.Q6_K:
        return [("ql", torch.uint8, (n, k // 2)), ("qh", torch.uint8, (n, k // 4)),
                ("sc", torch.int8, (n, s, 16)), ("d", torch.float32, (n, s))]
    qh = [("qh", torch.uint8, (n, s, 32))] if kind == GGMLType.Q5_K else []
    return [("qs", torch.uint8, (n, k // 2)), *qh, ("sc", torch.uint8, (n, s, 8)),
            ("mn", torch.uint8, (n, s, 8)), ("d", torch.float32, (n, s)),
            ("dmin", torch.float32, (n, s))]


# kind → (C entry, the K multiple its blocks need)
_ENTRY = {GGMLType.Q4_0: ("qmm_q4_0", 32), GGMLType.Q8_0: ("qmm_q8_0", 32),
          GGMLType.Q4_K: ("qmm_q4_k", 256), GGMLType.Q5_K: ("qmm_q5_k", 256),
          GGMLType.Q6_K: ("qmm_q6_k", 256)}


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
    if w.kind not in _ENTRY:
        raise NotImplementedError(f"qmm kernel for {w.kind.name} (ROADMAP.md queue B, B1)")
    entry, block = _ENTRY[w.kind]
    if x.shape[-1] != k or k % block:
        raise ValueError(f"qmm: x {tuple(x.shape)} vs W {w.shape} (K % {block} == 0)")
    ptrs = []
    for name, dtype, shape in _fields(w.kind, n, k):
        a = w[name]
        if a.device != x.device:
            raise ValueError(f"qmm: x on {x.device}, W.{name} on {a.device}")
        if a.dtype != dtype or tuple(a.shape) != shape:
            raise ValueError(f"qmm: bad {w.kind.name} field {name} {a.dtype}{tuple(a.shape)}, "
                             f"want {dtype}{shape}")
        if not a.is_contiguous() or a.data_ptr() % 16:
            raise ValueError(f"qmm: W.{name} must be contiguous and 16-byte aligned")
        ptrs.append(a.data_ptr())
    lead = x.shape[:-1]
    x2 = aligned16(x.reshape(-1, k).to(torch.bfloat16).contiguous())
    b = x2.shape[0]
    y = torch.empty(b, n, dtype=torch.float32, device=x.device)
    if b:
        rc = getattr(lib(), entry)(x2.data_ptr(), *ptrs, y.data_ptr(), b, n, k,
                                   stream_handle(x))
        check(rc, entry)
        LAUNCHES[entry] += 1
    return y.reshape(*lead, n)
