"""Core compute ops (counterpart of the JAX package's ops/__init__.py).

Quantized matmul over packed weights, the quantized row gather, norms,
activations. f32 statistics as the reference kernels keep them.
"""

from __future__ import annotations

import torch

from ..quant.dequant import dequant, dequant_fields
from .qtensor import QTensor


def qmm(x: torch.Tensor, w) -> torch.Tensor:
    """y = x @ Wᵀ (ggml_mul_mat semantics, W [N, K] row-major) → f32, with x
    taken as bf16.

    QTensors (Q4_0, Q4_1, Q5_0, Q5_1, Q8_0, Q2_K, Q3_K, Q4_K, Q5_K, Q6_K) go
    through the hand-written kernels (ops/kernels/qmm.py); a dense weight is a plain bf16
    product with f32 accumulation."""
    if isinstance(w, QTensor):
        from .kernels.qmm import qmm as qmm_kernel

        return qmm_kernel(x, w)
    return x.to(torch.bfloat16).float() @ w.to(torch.bfloat16).float().T


def take_rows(w, ids: torch.Tensor, *, dtype=torch.float32) -> torch.Tensor:
    """Dequantized row gather (ggml GET_ROWS): gathers the packed rows, then
    dequantizes only those."""
    if isinstance(w, QTensor):
        flat = ids.reshape(-1)
        rows = dequant_fields(w.kind, {k: a[flat] for k, a in w.arrays.items()}, dtype)
        return rows.reshape(*ids.shape, w.shape[1])
    return w[ids].to(dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor | None, eps: float) -> torch.Tensor:
    """ggml_rms_norm + mul with f32 statistics; weight=None is non-parametric."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight.float()
    return y.to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    return (xf * torch.sigmoid(xf)).to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """GELU, tanh form, in f32 and cast back (JAX jax.nn.gelu approximate=True)."""
    return torch.nn.functional.gelu(x.float(), approximate="tanh").to(x.dtype)


def activate(x: torch.Tensor, act: str) -> torch.Tensor:
    """The gated FFN's activation by name (JAX models/llama.py::activate)."""
    if act == "silu":
        return silu(x)
    if act == "gelu":
        return gelu(x)
    raise ValueError(f"activation {act!r}: the port has silu and gelu")


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Logit soft-capping, cap·tanh(x / cap) (gemma2's scores and logits)."""
    return torch.tanh(x / cap) * cap


def softmax_f32(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return torch.softmax(x.float(), dim=dim)


__all__ = ["QTensor", "activate", "dequant", "gelu", "qmm", "rms_norm", "silu", "softcap",
           "softmax_f32", "take_rows"]
