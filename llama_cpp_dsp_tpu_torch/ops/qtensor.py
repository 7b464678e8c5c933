"""QTensor — GGUF block-quant weights as torch tensors.

Counterpart of the JAX package's ops/qtensor.py. The port keeps GGUF block
order (no TPU tile transpose): per 2-D weight [N, K], rows contiguous,

- kind=Q4_0 : qs uint8 [N, K/2], d f16 [N, K/32]   (x = d*(q-8); byte j of a
              32-block holds element j in its low and j+16 in its high nibble)
- kind=Q4_1 : qs u8 [N, K/2], d,m f16 [N, K/32]    (x = d*q + m; Q4_0's nibbles)
- kind=Q5_0 : the Q4_0 fields + qh u8 [N, K/8]      (x = d*(q-16); the block's
              four qh bytes are its little-endian 32-bit word, bit j the fifth
              bit of element j)
- kind=Q5_1 : the Q5_0 fields + m f16 [N, K/32]     (x = d*q + m)
- kind=Q8_0 : qs int8 [N, K],    d f16 [N, K/32]   (x = d*q)
- kind=Q2_K : qs u8 [N, K/4], sc,mn u8 [N, S, 16], d,dmin f32 [N, S]
              (x = (d*sc)*q - dmin*mn over 16-element groups; in each
              128-element half, bits 2j..2j+1 of byte l hold element 32j+l)
- kind=Q3_K : qs u8 [N, K/4] (Q2_K's order), hmask u8 [N, S, 32], sc i8
              [N, S, 16] (the 6-bit scales unpacked, -32 applied), d f32
              [N, S]   (x = (d*sc)*(q - 4 + 4h), h bit e/32 of hmask[e%32])
- kind=Q4_K : qs u8 [N, K/2], sc,mn u8 [N, S, 8], d,dmin f32 [N, S]
              (S = K/256; x = (d*sc)*q - dmin*mn over 32-element groups; in
              each 64-element chunk byte l holds element l in its low and
              l+32 in its high nibble; the 6-bit scales are unpacked here)
- kind=Q5_K : the Q4_K fields + qh u8 [N, S, 32] (bit g of byte l is the
              fifth bit of element 32g+l)
- kind=Q6_K : ql u8 [N, K/2], qh u8 [N, K/4], sc i8 [N, S, 16], d f32 [N, S]
              (x = d*sc*(q-32) over 16-element groups)
- kind=IQ4_NL: qs u8 [N, K/2], d f16 [N, K/32]   (x = d*kvalues_iq4nl[q];
              Q4_0's nibble order)
- kind=IQ4_XS: qs u8 [N, K/2], d f32 [N, K/32]   (d = the block's d times its
              signed 6-bit sub-scale ls − 32, folded in at load)
- the table carrier (IQ2_XXS, IQ2_XS, IQ2_S, IQ3_XXS, IQ3_S, IQ1_S, IQ1_M,
  TQ1_0, TQ2_0): qs u8 [N, K/2] of 4-bit indices into the kind's sorted
  value table `IQ_TABLES[kind]` (Q4_0's nibble order), d f32 [N, K/g] per
  group of g = 32 weights (16 for IQ2_XS, IQ2_S, IQ1_M): x = d*table[q],
  bit-exact with the reference dequantize_row_* (quant/iq.py).
- F32 / F16 / BF16: a dense tensor.

These are the JAX package's field names, dtypes and shapes. Other kinds
raise NotImplementedError.

An MoE expert stack [E, N, K] is one QTensor with `n_expert` = E: `shape`
stays one expert's (N, K) and every field carries a leading [E] axis, as in
the JAX package (`runtime/loader.py::_convert`). `expert(eid)` is one
expert's plain 2-D QTensor (a view).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..gguf.constants import QK_K, GGMLType
from ..quant.blocks import _blocks, _f32, unpack_q3_K_scales, unpack_scale_min_k4
from ..quant.iq import IQ_TABLES, TABLE_KINDS, carrier

# GGUF kinds with a packed layout (and a hand-written qmm kernel) in the port:
# the legacy and K-quant kinds, whose GGUF fields are kept (scales unpacked),
PACKED_KINDS = (GGMLType.Q4_0, GGMLType.Q4_1, GGMLType.Q5_0, GGMLType.Q5_1, GGMLType.Q8_0,
                GGMLType.Q2_K, GGMLType.Q3_K, GGMLType.Q4_K, GGMLType.Q5_K, GGMLType.Q6_K)
# and the IQ / TQ kinds: 4-bit codes into a ≤16-value table, f32 (IQ4_NL:
# f16) scales per 32 or 16 weights
IQ_KINDS = (GGMLType.IQ4_NL, GGMLType.IQ4_XS, *sorted(TABLE_KINDS))
__all__ = ["IQ_KINDS", "IQ_TABLES", "PACKED_KINDS", "QTensor", "TABLE_KINDS", "from_gguf_tensor",
           "repack"]


@dataclass
class QTensor:
    """Packed quantized 2-D tensor [N, K] (N = rows / output features), or
    a stack of n_expert of them (every field with a leading expert axis)."""

    kind: GGMLType
    shape: tuple[int, int]
    arrays: dict[str, torch.Tensor] = field(default_factory=dict)
    n_expert: int = 0  # >0: every field has a leading [n_expert] axis

    def __getitem__(self, k: str) -> torch.Tensor:
        return self.arrays[k]

    @property
    def nbytes(self) -> int:
        return sum(a.numel() * a.element_size() for a in self.arrays.values())

    def to(self, device) -> "QTensor":
        return QTensor(self.kind, self.shape,
                       {k: a.to(device) for k, a in self.arrays.items()}, self.n_expert)

    def expert(self, eid: int) -> "QTensor":
        """Expert eid of a stack as a 2-D QTensor (views of the fields; JAX
        models/llama.py::_expert_slice)."""
        if not self.n_expert:
            raise ValueError("expert() of a QTensor that is not an expert stack")
        return QTensor(self.kind, self.shape, {k: a[eid] for k, a in self.arrays.items()})


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def repack(raw: np.ndarray, kind: GGMLType, shape: tuple[int, ...], device=None) -> QTensor:
    """raw: uint8 packed GGUF data for a row-major [N, K] tensor, or an
    expert stack [E, N, K]: repacked as (E·N, K), then the expert axis is
    put back onto every field. `device`: where the table carrier's codes
    are computed and kept (the CPU by default; the other kinds repack on
    the CPU)."""
    if len(shape) == 1:
        shape = (1, shape[0])
    if len(shape) == 3:
        e, n, k = shape
        qt = repack(raw, kind, (e * n, k), device)
        return QTensor(kind, (n, k), {key: a.reshape(e, n, *a.shape[1:])
                                      for key, a in qt.arrays.items()}, n_expert=e)
    if len(shape) != 2:
        raise NotImplementedError(f"repack of a {len(shape)}-D {kind.name} tensor")
    n, k = shape
    if kind == GGMLType.Q8_0:
        b = _blocks(raw, kind)
        return QTensor(kind, (n, k), {
            "qs": _t(b["qs"].reshape(n, k)),
            "d": _t(b["d"].reshape(n, k // 32)),
        })
    if kind in (GGMLType.Q4_0, GGMLType.Q4_1, GGMLType.Q5_0, GGMLType.Q5_1):
        b = _blocks(raw, kind)
        out = {"qs": _t(b["qs"].reshape(n, k // 2))}
        if kind in (GGMLType.Q5_0, GGMLType.Q5_1):
            out["qh"] = _t(b["qh"].copy().view(np.uint8).reshape(n, k // 8))
        out["d"] = _t(b["d"].reshape(n, k // 32))
        if kind in (GGMLType.Q4_1, GGMLType.Q5_1):
            out["m"] = _t(b["m"].reshape(n, k // 32))
        return QTensor(kind, (n, k), out)
    if kind in (GGMLType.Q4_K, GGMLType.Q5_K):
        b = _blocks(raw, kind)
        s = k // QK_K
        sc, mn = unpack_scale_min_k4(b["scales"])
        out = {
            "qs": _t(b["qs"].reshape(n, k // 2)),
            "sc": _t(sc.reshape(n, s, 8)),
            "mn": _t(mn.reshape(n, s, 8)),
            "d": _t(_f32(b["d"]).reshape(n, s)),
            "dmin": _t(_f32(b["dmin"]).reshape(n, s)),
        }
        if kind == GGMLType.Q5_K:
            out["qh"] = _t(b["qh"].reshape(n, s, 32))
        return QTensor(kind, (n, k), out)
    if kind == GGMLType.Q2_K:
        b = _blocks(raw, kind)
        s = k // QK_K
        return QTensor(kind, (n, k), {
            "qs": _t(b["qs"].reshape(n, k // 4)),
            "sc": _t((b["scales"] & 0x0F).reshape(n, s, 16)),
            "mn": _t((b["scales"] >> 4).reshape(n, s, 16)),
            "d": _t(_f32(b["d"]).reshape(n, s)),
            "dmin": _t(_f32(b["dmin"]).reshape(n, s)),
        })
    if kind == GGMLType.Q3_K:
        b = _blocks(raw, kind)
        s = k // QK_K
        return QTensor(kind, (n, k), {
            "qs": _t(b["qs"].reshape(n, k // 4)),
            "hmask": _t(b["hmask"].reshape(n, s, 32)),
            "sc": _t(unpack_q3_K_scales(b["scales"]).astype(np.int8).reshape(n, s, 16)),
            "d": _t(_f32(b["d"]).reshape(n, s)),
        })
    if kind == GGMLType.Q6_K:
        b = _blocks(raw, kind)
        s = k // QK_K
        return QTensor(kind, (n, k), {
            "ql": _t(b["ql"].reshape(n, k // 2)),
            "qh": _t(b["qh"].reshape(n, k // 4)),
            "sc": _t(b["scales"].reshape(n, s, 16)),
            "d": _t(_f32(b["d"]).reshape(n, s)),
        })
    if kind == GGMLType.IQ4_NL:
        b = _blocks(raw, kind)
        return QTensor(kind, (n, k), {"qs": _t(b["qs"].reshape(n, k // 2)),
                                      "d": _t(b["d"].reshape(n, k // 32))})
    if kind == GGMLType.IQ4_XS:
        # per-32 effective scales d·(ls − 32) in f32; the 16-byte qs of each
        # 32-weight group is then IQ4_NL's (dequantize_row_iq4_xs)
        b = _blocks(raw, kind)
        ib = np.arange(8)
        ls_l = (b["scales_l"][:, ib // 2] >> (4 * (ib % 2))[None, :]) & 0x0F
        ls_h = (b["scales_h"][:, None] >> (2 * ib)[None, :]) & 3
        ls = (ls_l | (ls_h << 4)).astype(np.int32) - 32
        dl = _f32(b["d"])[:, None] * ls.astype(np.float32)  # [nb, 8]
        return QTensor(kind, (n, k), {"qs": _t(b["qs"].reshape(n, k // 2)),
                                      "d": _t(dl.reshape(n, k // 32))})
    if kind in TABLE_KINDS:
        return QTensor(kind, (n, k), carrier(raw, kind, n, k, device))
    raise NotImplementedError(
        f"repack {kind.name}: the port packs "
        f"{', '.join(k.name for k in PACKED_KINDS + IQ_KINDS)}")


def _bf16(raw: np.ndarray, np_shape) -> torch.Tensor:
    u16 = np.ascontiguousarray(raw).view(np.uint16).reshape(np_shape)
    return torch.from_numpy(u16.view(np.int16).copy()).view(torch.bfloat16)


def from_gguf_tensor(raw: np.ndarray, kind: GGMLType, np_shape: tuple[int, ...],
                     device=None) -> QTensor | torch.Tensor:
    """Convert one GGUF tensor to a QTensor (packed kinds) or a dense tensor.

    np_shape is the row-major numpy shape (reversed ggml ne); `device` as
    for `repack`."""
    if kind == GGMLType.F32:  # copies: raw may be a read-only mmap view
        return torch.from_numpy(np.ascontiguousarray(raw).view("<f4").reshape(np_shape).copy())
    if kind == GGMLType.F16:
        return torch.from_numpy(np.ascontiguousarray(raw).view("<f2").reshape(np_shape).copy())
    if kind == GGMLType.BF16:
        return _bf16(raw, np_shape)
    if kind in PACKED_KINDS or kind in IQ_KINDS:
        return repack(raw, kind, np_shape, device)
    raise NotImplementedError(f"GGUF tensor kind {kind.name}: no packed layout in the port")
