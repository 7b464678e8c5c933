"""The table carrier of the grid-codebook and ternary kinds (IQ2_XXS, IQ2_XS,
IQ2_S, IQ3_XXS, IQ3_S, IQ1_S, IQ1_M, TQ1_0, TQ2_0).

Every weight of these formats is scale × v, v drawn from a per-kind set of
at most 16 integers (`IQ_TABLES`): the grid magnitudes times a sign; for
IQ1 the ±0.125 delta folded in as 8·grid ± 1 with the scale times 0.125;
for TQ the trits. `carrier` maps GGUF blocks to the 4-bit index of each
weight's value in its (sorted) table plus one f32 scale per group of g
weights (g = 32, or 16 for IQ2_XS, IQ2_S and IQ1_M), such that
table[code] · scale reproduces the reference dequantize_row_* bit for bit.
`carrier` is the counterpart of the JAX package's quant/ref_numpy.py::
iq_int_decompose followed by the index search and nibble packing of its
ops/qtensor.py.

The grid lookup gives the code directly: each grid kind has two "code
grids" of uint8 (the code of +value and of −value of every grid entry),
built once from `iq_grids.npz`, so a chunk of blocks needs one gather and
one select, never an int32 payload of the whole tensor. Blocks are taken
in chunks of rows (`CHUNK_WEIGHTS` weights at a time).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..gguf.constants import GGML_TYPE_TRAITS, GGMLType
from .blocks import DT
from .iq_grids import byte_sign_table, grids, sign_table

# Integer value tables of the carrier kinds, sorted (JAX ops/qtensor.py
# IQ_TABLES): grid magnitudes {8, 25, 43} / {4 .. 62} / {1 .. 15 odd} × sign;
# IQ1: 8·grid ± 1; TQ: trits. TQ2_0's raw 2-bit field decodes (q & 3) − 1,
# so arbitrary bits give 2 as well (the encoder never writes it).
_T_IQ2 = (-43, -25, -8, 8, 25, 43)
_T_IQ3_XXS = (-62, -52, -44, -36, -28, -20, -12, -4, 4, 12, 20, 28, 36, 44, 52, 62)
_T_IQ3_S = (-15, -13, -11, -9, -7, -5, -3, -1, 1, 3, 5, 7, 9, 11, 13, 15)
_T_IQ1 = (-9, -7, -1, 1, 7, 9)
IQ_TABLES: dict[GGMLType, tuple[int, ...]] = {
    GGMLType.IQ2_XXS: _T_IQ2,
    GGMLType.IQ2_XS: _T_IQ2,
    GGMLType.IQ2_S: _T_IQ2,
    GGMLType.IQ3_XXS: _T_IQ3_XXS,
    GGMLType.IQ3_S: _T_IQ3_S,
    GGMLType.IQ1_S: _T_IQ1,
    GGMLType.IQ1_M: _T_IQ1,
    GGMLType.TQ1_0: (-1, 0, 1),
    GGMLType.TQ2_0: (-1, 0, 1, 2),
}
TABLE_KINDS = frozenset(IQ_TABLES)
# weights per scale
GROUP = {kind: 16 if kind in (GGMLType.IQ2_XS, GGMLType.IQ2_S, GGMLType.IQ1_M) else 32
         for kind in IQ_TABLES}
CHUNK_WEIGHTS = 1 << 22

_GRID = {GGMLType.IQ2_XXS: "iq2xxs_grid", GGMLType.IQ2_XS: "iq2xs_grid",
         GGMLType.IQ2_S: "iq2s_grid", GGMLType.IQ3_XXS: "iq3xxs_grid",
         GGMLType.IQ3_S: "iq3s_grid", GGMLType.IQ1_S: "iq1s_grid", GGMLType.IQ1_M: "iq1s_grid"}


def _codes_of(kind: GGMLType, values: np.ndarray) -> np.ndarray:
    """uint8 index of each value in the kind's sorted table; a value outside
    the table raises (the carrier would not be exact)."""
    table = np.asarray(IQ_TABLES[kind], np.int32)
    u = np.searchsorted(table, values).clip(0, len(table) - 1)
    if not (table[u] == values).all():
        raise ValueError(f"{kind.name}: a grid value lies outside its table {tuple(table)}")
    return u.astype(np.uint8)


@functools.cache
def _code_grids_np(kind: GGMLType) -> tuple[np.ndarray, np.ndarray]:
    """(code of the entry's value taken positive / with its delta +1, code
    taken negative / with delta −1), each uint8 [n_grid, width]."""
    g = grids()[_GRID[kind]].astype(np.int32)
    if kind in (GGMLType.IQ1_S, GGMLType.IQ1_M):
        return _codes_of(kind, 8 * g + 1), _codes_of(kind, 8 * g - 1)
    return _codes_of(kind, g), _codes_of(kind, -g)


def _code_grids(kind: GGMLType, device) -> tuple[torch.Tensor, torch.Tensor]:
    return tuple(torch.from_numpy(a).to(device) for a in _code_grids_np(kind))


def _negative(table: np.ndarray, device) -> torch.Tensor:
    """A ±1 sign table as bool (True: negative)."""
    return torch.from_numpy(table < 0).to(device)


def _f16(b: torch.Tensor, off: int) -> torch.Tensor:
    """The f16 field at byte `off` of every block → f32 [nb]."""
    return b[:, off:off + 2].contiguous().view(torch.float16)[:, 0].float()


def _u16(b: torch.Tensor) -> torch.Tensor:
    """Little-endian uint16 words of a [..., 2n] byte tensor → int32 [..., n]."""
    w = b.reshape(*b.shape[:-1], -1, 2).to(torch.int32)
    return w[..., 0] | (w[..., 1] << 8)


def _u32(b: torch.Tensor) -> torch.Tensor:
    """Little-endian uint32 words of a [..., 4n] byte tensor → int64 [..., n]."""
    w = b.reshape(*b.shape[:-1], -1, 4).to(torch.int64)
    return w[..., 0] | (w[..., 1] << 8) | (w[..., 2] << 16) | (w[..., 3] << 24)


def _signed(pos: torch.Tensor, neg: torch.Tensor, idx: torch.Tensor,
            negative: torch.Tensor) -> torch.Tensor:
    """Codes of grid entries idx [...] (each `width` weights) with the sign
    mask negative [..., width]."""
    return torch.where(negative, neg[idx], pos[idx])


def _nib_scale(d: torch.Tensor, sc: torch.Tensor, nb: int) -> torch.Tensor:
    """IQ2_XS / IQ2_S per-16 scales d·(0.5 + nibble)·0.25 → [nb, 16]."""
    nib = torch.stack([sc & 0x0F, sc >> 4], dim=-1).float()  # [nb, 8, 2]
    return ((d[:, None, None] * (0.5 + nib)) * 0.25).reshape(nb, 16)


def _trits(b: torch.Tensor, npow: int) -> torch.Tensor:
    """TQ1_0 trits of bytes b [nb, M] in (n, m) order → uint8 [nb, npow·M]:
    trit n of byte q is ((uint8)(q·3ⁿ)·3) >> 8, the uint8 wraparound kept."""
    pow3 = torch.tensor([1, 3, 9, 27, 81][:npow], dtype=torch.int32, device=b.device)
    q = (b[:, None, :].to(torch.int32) * pow3[None, :, None]) & 0xFF
    return ((q * 3) >> 8).to(torch.uint8).reshape(b.shape[0], -1)


def _decompose_blocks(b: torch.Tensor, kind: GGMLType) -> tuple[torch.Tensor, torch.Tensor]:
    """Blocks b uint8 [nb, block bytes] → (codes uint8 [nb, 256], scales f32
    [nb, 256 / g])."""
    nb, dev = b.shape[0], b.device
    if kind == GGMLType.IQ2_XXS:  # per 32-group: 4 grid bytes, then 4×7 sign bits + 4-bit scale
        d = _f16(b, 0)
        q = b[:, 2:66].reshape(nb, 8, 8)
        a1 = _u32(q[:, :, 4:])[..., 0]  # [nb, 8]
        s = (d[:, None] * (0.5 + (a1 >> 28).float())) * 0.25
        sidx = (a1[..., None] >> (7 * torch.arange(4, device=dev))) & 127  # [nb, 8, 4]
        pos, neg = _code_grids(kind, dev)
        codes = _signed(pos, neg, q[:, :, :4].long(), _negative(sign_table(), dev)[sidx])
        return codes.reshape(nb, 256), s
    if kind == GGMLType.IQ2_XS:
        d = _f16(b, 0)
        q = _u16(b[:, 2:66]).reshape(nb, 8, 4)
        pos, neg = _code_grids(kind, dev)
        codes = _signed(pos, neg, (q & 511).long(), _negative(sign_table(), dev)[(q >> 9).long()])
        return codes.reshape(nb, 256), _nib_scale(d, b[:, 66:74], nb)
    if kind == GGMLType.IQ2_S:
        d = _f16(b, 0)
        ql = b[:, 2:34].reshape(nb, 8, 4).long()
        signs = b[:, 34:66].reshape(nb, 8, 4).long()
        qh = b[:, 66:74].long()
        high = (qh[:, :, None] >> (2 * torch.arange(4, device=dev))) & 3
        pos, neg = _code_grids(kind, dev)
        codes = _signed(pos, neg, ql | (high << 8), _negative(byte_sign_table(), dev)[signs])
        return codes.reshape(nb, 256), _nib_scale(d, b[:, 74:82], nb)
    if kind == GGMLType.IQ3_XXS:  # 64 grid bytes, then one 32-bit sign/scale word per group
        d = _f16(b, 0)
        q = b[:, 2:66].reshape(nb, 8, 8).long()
        aux = _u32(b[:, 66:98])  # [nb, 8]
        s = (d[:, None] * (0.5 + (aux >> 28).float())) * 0.5
        sidx = (aux[..., None] >> (7 * torch.arange(4, device=dev))) & 127  # [nb, 8, 4]
        negative = _negative(sign_table(), dev)[sidx].reshape(nb, 8, 8, 4)
        pos, neg = _code_grids(kind, dev)
        return _signed(pos, neg, q, negative).reshape(nb, 256), s
    if kind == GGMLType.IQ3_S:
        d = _f16(b, 0)
        qs = b[:, 2:66].reshape(nb, 8, 8).long()
        qh = b[:, 66:74].long()
        high = (qh[:, :, None] >> torch.arange(8, device=dev)) & 1  # bit p: byte position p
        negative = _negative(byte_sign_table(), dev)[b[:, 74:106].reshape(nb, 8, 4).long()]
        sc = b[:, 106:110]
        nib = torch.stack([sc & 0x0F, sc >> 4], dim=-1).reshape(nb, 8).float()
        s = d[:, None] * (1.0 + 2.0 * nib)
        pos, neg = _code_grids(kind, dev)
        codes = _signed(pos, neg, qs | (high << 8), negative.reshape(nb, 8, 8, 4))
        return codes.reshape(nb, 256), s
    if kind == GGMLType.IQ1_S:
        d = _f16(b, 0)
        qs = b[:, 2:34].reshape(nb, 8, 4).long()
        qh = _u16(b[:, 34:50])  # [nb, 8]
        s = (d[:, None] * (2 * ((qh >> 12) & 7) + 1).float()) * 0.125
        high = (qh[:, :, None] >> (3 * torch.arange(4, device=dev))) & 7
        plus, minus = _code_grids(kind, dev)
        dneg = ((qh & 0x8000) != 0)[:, :, None, None].expand(nb, 8, 4, 8)
        codes = _signed(plus, minus, qs | (high.long() << 8), dneg)
        return codes.reshape(nb, 256), s
    if kind == GGMLType.IQ1_M:
        sc = _u16(b[:, 48:56])  # [nb, 4]
        d_bits = ((sc[:, 0] >> 12) | ((sc[:, 1] >> 8) & 0x00F0) | ((sc[:, 2] >> 4) & 0x0F00)
                  | (sc[:, 3] & 0xF000))
        dm = (d_bits - ((d_bits >> 15) << 16)).to(torch.int16).view(torch.float16).float()
        qs = b[:, 0:32].reshape(nb, 8, 4).long()
        qh = b[:, 32:48].reshape(nb, 8, 2).long()
        lo, hi = qh[..., 0], qh[..., 1]
        high = torch.stack([lo & 7, (lo >> 4) & 7, hi & 7, (hi >> 4) & 7], dim=-1)
        dneg = torch.stack([lo & 0x08, lo & 0x80, hi & 0x08, hi & 0x80], dim=-1) != 0
        plus, minus = _code_grids(kind, dev)
        codes = _signed(plus, minus, qs | (high << 8), dneg[..., None].expand(nb, 8, 4, 8))
        ib = torch.arange(8, device=dev)
        sc_ib = sc[:, ib // 2]  # [nb, 8]
        shift = 6 * (ib % 2)
        dl = torch.stack([(sc_ib >> shift) & 7, (sc_ib >> (shift + 3)) & 7], dim=-1)
        s = (dm[:, None, None] * (2 * dl + 1).float()) * 0.125  # [nb, 8, 2] per 16 weights
        return codes.reshape(nb, 256), s.reshape(nb, 16)
    if kind == GGMLType.TQ1_0:  # code = trit (the table is −1, 0, 1)
        d = _f16(b, 52)
        codes = torch.cat([_trits(b[:, 0:32], 5), _trits(b[:, 32:48], 5),
                           _trits(b[:, 48:52], 4)], dim=1)
        return codes, d[:, None].expand(nb, 8)
    if kind == GGMLType.TQ2_0:  # code = the raw 2-bit field (the table is −1, 0, 1, 2)
        d = _f16(b, 64)
        qs = b[:, 0:64].reshape(nb, 2, 1, 32)
        shifts = (2 * torch.arange(4, device=dev, dtype=torch.uint8)).reshape(1, 1, 4, 1)
        return ((qs >> shifts) & 3).reshape(nb, 256), d[:, None].expand(nb, 8)
    raise NotImplementedError(f"table carrier of {kind.name}")


def pack_nibbles(codes: torch.Tensor) -> torch.Tensor:
    """Codes uint8 [n, k] → IQ4_NL-shaped nibbles [n, k / 2]: byte j of each
    32-weight block holds weight j in its low nibble and j + 16 in its high."""
    n, k = codes.shape
    b = codes.reshape(n, k // 32, 2, 16)
    return (b[:, :, 0] | (b[:, :, 1] << 4)).reshape(n, k // 2)


def carrier(raw: np.ndarray, kind: GGMLType, n: int, k: int,
            device=None) -> dict[str, torch.Tensor]:
    """The carrier fields of a row-major [n, k] tensor of a table kind
    (k % 256 == 0): qs uint8 [n, k/2] (nibble codes) and d f32 [n, k/g],
    computed on `device` (the CPU by default) in chunks of rows."""
    if k % 256:
        raise ValueError(f"{kind.name}: row length {k} is not a multiple of 256")
    g, size = GROUP[kind], DT[kind].itemsize
    assert size == GGML_TYPE_TRAITS[kind].type_size
    dev = torch.device(device or "cpu")
    qs = torch.empty(n, k // 2, dtype=torch.uint8, device=dev)
    d = torch.empty(n, k // g, dtype=torch.float32, device=dev)
    flat = np.ascontiguousarray(raw).reshape(-1).view(np.uint8)
    per_row = k // 256
    rows = max(1, CHUNK_WEIGHTS // k)
    for r0 in range(0, n, rows):
        r1 = min(n, r0 + rows)
        # a copy: raw may be a read-only view of the file
        chunk = np.array(flat[r0 * per_row * size:r1 * per_row * size])
        codes, s = _decompose_blocks(torch.from_numpy(chunk).reshape(-1, size).to(dev), kind)
        qs[r0:r1] = pack_nibbles(codes.reshape(r1 - r0, k))
        d[r0:r1] = s.reshape(r1 - r0, k // g)
    return {"qs": qs, "d": d}
