"""Torch dequantization of QTensors (counterpart of quant/jax_dequant.py).

Bit-exact with the reference dequantize_row_q4_0 / _q4_1 / _q5_0 / _q5_1 /
_q8_0 / _q2_K / _q3_K / _q4_K / _q5_K / _q6_K and the IQ / TQ kinds' (the
JAX package's quant/ref_numpy.py): the products are taken in f32 in the
same order; an IQ / TQ weight is table[code] × its group's scale, one
product (quant/iq.py).
Used by the plain qmm version and the embedding row gather.
"""

from __future__ import annotations

import torch

from ..gguf.constants import GGMLType
from .blocks import KVALUES_IQ4NL
from .iq import IQ_TABLES


def _nibbles_k(qs: torch.Tensor, n: int, s: int) -> torch.Tensor:
    """K-quant 4-bit field [N, S*128] → int32 [N, S, 8, 32]: in each
    64-element chunk j, byte l's low nibble is element l of group 2j and its
    high nibble element l of group 2j+1."""
    b = qs.reshape(n, s, 4, 1, 32)
    return torch.cat([b & 0x0F, b >> 4], dim=3).reshape(n, s, 8, 32).to(torch.int32)


def _crumbs_k(qs: torch.Tensor, n: int, s: int) -> torch.Tensor:
    """Q2_K / Q3_K 2-bit field [N, S*64] → int32 [N, S, 2, 4, 32]: in each
    128-element half h, bits 2j..2j+1 of byte l are element 32j + l."""
    shifts = torch.arange(0, 8, 2, dtype=torch.uint8, device=qs.device)
    b = qs.reshape(n, s, 2, 1, 32)
    return ((b >> shifts[:, None]) & 3).to(torch.int32)


def dequant_fields(kind: GGMLType, f: dict[str, torch.Tensor],
                   dtype=torch.float32) -> torch.Tensor:
    """Packed fields of rows [N, ...] (ops/qtensor.py names) → dense [N, K]."""
    if kind in (GGMLType.Q8_0, GGMLType.Q4_0):
        qs, d = f["qs"], f["d"]
        n, g = qs.shape[0], d.shape[-1]
        df = d.float()[:, :, None]
        if kind == GGMLType.Q8_0:
            y = qs.float().reshape(n, g, 32) * df
        else:
            b = qs.reshape(n, g, 16)
            q = torch.cat([b & 0x0F, b >> 4], dim=-1).to(torch.int32) - 8
            y = q.float() * df
        return y.reshape(n, g * 32).to(dtype)
    if kind in (GGMLType.Q4_1, GGMLType.Q5_0, GGMLType.Q5_1):
        qs, d = f["qs"], f["d"]
        n, g = qs.shape[0], d.shape[-1]
        b = qs.reshape(n, g, 16)
        q = torch.cat([b & 0x0F, b >> 4], dim=-1).to(torch.int32)  # [N, G, 32]
        if kind != GGMLType.Q4_1:  # bit j of a block's 32-bit qh: element j's fifth bit
            qh = f["qh"].reshape(n, g, 4).to(torch.int32)
            j = torch.arange(32, device=q.device)
            q = q | (((qh[:, :, j // 8] >> (j % 8)) & 1) << 4)
        df = d.float()[:, :, None]
        if kind == GGMLType.Q5_0:
            y = (q - 16).float() * df
        else:
            y = q.float() * df + f["m"].float()[:, :, None]
        return y.reshape(n, g * 32).to(dtype)
    if kind in (GGMLType.Q4_K, GGMLType.Q5_K):
        n, s = f["d"].shape
        q = _nibbles_k(f["qs"], n, s)
        if kind == GGMLType.Q5_K:
            g = torch.arange(8, dtype=torch.uint8, device=q.device)
            hbit = (f["qh"][:, :, None, :] >> g[None, None, :, None]) & 1  # [N,S,8,32]
            q = q + hbit.to(torch.int32) * 16
        dl = f["d"][:, :, None] * f["sc"].float()  # effective scale per 32-group
        ml = f["dmin"][:, :, None] * f["mn"].float()
        y = q.float() * dl[..., None] - ml[..., None]
        return y.reshape(n, s * 256).to(dtype)
    if kind == GGMLType.Q2_K:  # x = (d*sc)*q - dmin*mn over 16-element groups
        n, s = f["d"].shape
        q = _crumbs_k(f["qs"], n, s).reshape(n, s, 16, 16).float()
        dl = f["d"][:, :, None] * f["sc"].float()
        ml = f["dmin"][:, :, None] * f["mn"].float()
        y = q * dl[..., None] - ml[..., None]
        return y.reshape(n, s * 256).to(dtype)
    if kind == GGMLType.Q3_K:  # x = (d*sc)*(q - 4 + 4h); bit 4h+j of hmask byte l
        n, s = f["d"].shape
        q = _crumbs_k(f["qs"], n, s)
        bit = torch.arange(8, dtype=torch.uint8, device=q.device)
        h = ((f["hmask"][:, :, None, :] >> bit[:, None]) & 1).to(torch.int32)  # [N,S,8,32]
        q = q - 4 + 4 * h.reshape(n, s, 2, 4, 32)
        dl = f["d"][:, :, None] * f["sc"].float()
        y = q.reshape(n, s, 16, 16).float() * dl[..., None]
        return y.reshape(n, s * 256).to(dtype)
    if kind == GGMLType.Q6_K:
        n, s = f["d"].shape
        ql = f["ql"].reshape(n, s, 2, 64).to(torch.int32)  # per 128-element half
        qh = f["qh"].reshape(n, s, 2, 32).to(torch.int32)
        lo, hi = ql[..., :32], ql[..., 32:]
        q = torch.cat([(lo & 0x0F) | ((qh & 3) << 4),
                       (hi & 0x0F) | (((qh >> 2) & 3) << 4),
                       (lo >> 4) | (((qh >> 4) & 3) << 4),
                       (hi >> 4) | (((qh >> 6) & 3) << 4)], dim=-1) - 32  # [N,S,2,128]
        q = q.reshape(n, s, 16, 16).float()
        y = q * f["sc"].float()[..., None] * f["d"][:, :, None, None]
        return y.reshape(n, s * 256).to(dtype)
    if kind in IQ_TABLES or kind in (GGMLType.IQ4_NL, GGMLType.IQ4_XS):
        # value = table[nibble] × the scale of its group of g weights; the
        # nibbles in Q4_0's order (byte j: weight j low, j + 16 high)
        qs, d = f["qs"], f["d"]
        n, k = qs.shape[0], qs.shape[1] * 2
        table = KVALUES_IQ4NL if kind not in IQ_TABLES else IQ_TABLES[kind]
        lut = torch.as_tensor(table, dtype=torch.float32, device=qs.device)
        b = qs.reshape(n, k // 32, 16)
        q = lut[torch.cat([b & 0x0F, b >> 4], dim=-1).long()]  # [N, K/32, 32]
        g = k // d.shape[-1]
        y = q.reshape(n, k // g, g) * d.float()[:, :, None]
        return y.reshape(n, k).to(dtype)
    raise NotImplementedError(f"dequant {kind.name}")


def dequant(qt, dtype=torch.float32) -> torch.Tensor:
    """QTensor (ops/qtensor.py) → dense [N, K]."""
    return dequant_fields(qt.kind, qt.arrays, dtype)
