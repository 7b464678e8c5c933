"""Torch dequantization of QTensors (counterpart of quant/jax_dequant.py).

Bit-exact with the reference dequantize_row_q4_0 / _q8_0 (the JAX
package's quant/ref_numpy.py): the products are taken in f32 in the same
order. Used by the plain qmm version and the embedding row gather.
"""

from __future__ import annotations

import torch

from ..gguf.constants import GGMLType


def dequant_fields(kind: GGMLType, qs: torch.Tensor, d: torch.Tensor,
                   dtype=torch.float32) -> torch.Tensor:
    """Packed fields of rows [N, ...] → dense [N, K]."""
    n = qs.shape[0]
    g = d.shape[-1]
    df = d.float()[:, :, None]
    if kind == GGMLType.Q8_0:
        y = qs.float().reshape(n, g, 32) * df
    elif kind == GGMLType.Q4_0:
        b = qs.reshape(n, g, 16)
        q = torch.cat([b & 0x0F, b >> 4], dim=-1).to(torch.int32) - 8
        y = q.float() * df
    else:
        raise NotImplementedError(f"dequant {kind.name} (ROADMAP.md queue B, B1)")
    return y.reshape(n, g * 32).to(dtype)


def dequant(qt, dtype=torch.float32) -> torch.Tensor:
    """QTensor (ops/qtensor.py) → dense [N, K]."""
    return dequant_fields(qt.kind, qt["qs"], qt["d"], dtype)
