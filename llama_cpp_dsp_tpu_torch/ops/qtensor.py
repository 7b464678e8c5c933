"""QTensor — GGUF block-quant weights as torch tensors.

Counterpart of the JAX package's ops/qtensor.py. The port keeps GGUF block
order (no TPU tile transpose): per 2-D weight [N, K], rows contiguous,

- kind=Q4_0 : qs uint8 [N, K/2], d f16 [N, K/32]   (x = d*(q-8); byte j of a
              32-block holds element j in its low and j+16 in its high nibble)
- kind=Q8_0 : qs int8 [N, K],    d f16 [N, K/32]   (x = d*q)
- F32 / F16 / BF16: a dense tensor.

Other kinds raise NotImplementedError: they are queued in ROADMAP.md
(queue B, row B1, the other qmm bodies).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..gguf.constants import GGMLType
from ..quant.blocks import _blocks

# GGUF kinds with a packed layout (and a hand-written qmm kernel) in the port
PACKED_KINDS = (GGMLType.Q4_0, GGMLType.Q8_0)


@dataclass
class QTensor:
    """Packed quantized 2-D tensor [N, K] (N = rows / output features)."""

    kind: GGMLType
    shape: tuple[int, int]
    arrays: dict[str, torch.Tensor] = field(default_factory=dict)

    def __getitem__(self, k: str) -> torch.Tensor:
        return self.arrays[k]

    @property
    def nbytes(self) -> int:
        return sum(a.numel() * a.element_size() for a in self.arrays.values())

    def to(self, device) -> "QTensor":
        return QTensor(self.kind, self.shape,
                       {k: a.to(device) for k, a in self.arrays.items()})


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def repack(raw: np.ndarray, kind: GGMLType, shape: tuple[int, ...]) -> QTensor:
    """raw: uint8 packed GGUF data for a row-major [N, K] tensor."""
    if len(shape) == 1:
        shape = (1, shape[0])
    if len(shape) != 2:
        raise NotImplementedError(
            f"repack of a {len(shape)}-D {kind.name} tensor (expert stacks: "
            "ROADMAP.md queue A, MoE)")
    n, k = shape
    if kind == GGMLType.Q8_0:
        b = _blocks(raw, kind)
        return QTensor(kind, (n, k), {
            "qs": _t(b["qs"].reshape(n, k)),
            "d": _t(b["d"].reshape(n, k // 32)),
        })
    if kind == GGMLType.Q4_0:
        b = _blocks(raw, kind)
        return QTensor(kind, (n, k), {
            "qs": _t(b["qs"].reshape(n, k // 2)),
            "d": _t(b["d"].reshape(n, k // 32)),
        })
    raise NotImplementedError(
        f"repack {kind.name}: only Q4_0 and Q8_0 are ported (ROADMAP.md "
        "queue B, row B1)")


def _bf16(raw: np.ndarray, np_shape) -> torch.Tensor:
    u16 = np.ascontiguousarray(raw).view(np.uint16).reshape(np_shape)
    return torch.from_numpy(u16.view(np.int16).copy()).view(torch.bfloat16)


def from_gguf_tensor(raw: np.ndarray, kind: GGMLType,
                     np_shape: tuple[int, ...]) -> QTensor | torch.Tensor:
    """Convert one GGUF tensor to a QTensor (packed kinds) or a dense tensor.

    np_shape is the row-major numpy shape (reversed ggml ne)."""
    if kind == GGMLType.F32:  # copies: raw may be a read-only mmap view
        return torch.from_numpy(np.ascontiguousarray(raw).view("<f4").reshape(np_shape).copy())
    if kind == GGMLType.F16:
        return torch.from_numpy(np.ascontiguousarray(raw).view("<f2").reshape(np_shape).copy())
    if kind == GGMLType.BF16:
        return _bf16(raw, np_shape)
    if kind in PACKED_KINDS:
        return repack(raw, kind, np_shape)
    raise NotImplementedError(
        f"GGUF tensor kind {kind.name}: not ported yet (ROADMAP.md queue B, "
        "row B1, the other qmm bodies)")
