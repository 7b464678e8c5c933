"""Row quantizers and plane layouts of the KV cache formats (the helpers of
the JAX package's runtime/kv_cache.py:275-608), shared by the contiguous
and paged caches (runtime/kv_cache.py, runtime/paged_kv.py) and the decode
kernels' plain versions (ops/kernels/attention.py).

Formats:
- q8_0: int8 rows with one f32 scale per row over the whole head dim;
- q4_0, q4_1, q5_0, q5_1, iq4_nl: codes in 32-wide groups of the head dim,
  stored as a byte plane of row pairs [..., S/2, D] (row 2j in the low
  nibble, 2j+1 in the high one) with f32 group scales (and mins for q4_1 /
  q5_1) stored parity-major as [..., 2G, S/2] (plane p·G + g at column j
  holds group g of row 2j + p); q5's fifth bit is a plane [..., S, D/8] of
  its own, one row each.
Every quantizer is bit-exact with the JAX package's, bf16 input included.
"""

from __future__ import annotations

import torch

from .blocks import KVALUES_IQ4NL

PACKED_KV_FORMATS = ("q4_0", "q4_1", "q5_0", "q5_1", "iq4_nl")


def q8_quant(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[..., D] → (qs int8 [..., D], d f32 [...]): one scale per row over the
    whole head dim, amax / 127, rounded half to even — reference
    quantize_row_q8_0's scheme."""
    xf = x.float()
    d = xf.abs().amax(dim=-1) / 127.0
    inv = torch.where(d > 0, 1.0 / torch.clamp(d, min=1e-30), torch.zeros_like(d))
    qs = torch.clamp(torch.round(xf * inv[..., None]), -127, 127)
    return qs.to(torch.int8), d


def q8_dequant(qs: torch.Tensor, d: torch.Tensor, dtype) -> torch.Tensor:
    return (qs.float() * d[..., None]).to(dtype)


def q4_groups(head_dim: int) -> int:
    """32-element scale groups along the head dim (reference block_q4_0);
    rows whose D is not 32-divisible take one group."""
    return head_dim // 32 if head_dim % 32 == 0 else 1


def _grouped(x: torch.Tensor) -> torch.Tensor:
    """[..., D] → f32 [..., G, D/G]."""
    g = q4_groups(x.shape[-1])
    return x.float().reshape(*x.shape[:-1], g, x.shape[-1] // g)


def _signed_max(xg: torch.Tensor) -> torch.Tensor:
    """The first element of largest |x| in each group, with its sign
    (jnp.argmax's first-maximum rule) → [..., G]."""
    return torch.gather(xg, -1, xg.abs().argmax(dim=-1, keepdim=True))[..., 0]


def _inv(d: torch.Tensor) -> torch.Tensor:
    """1/d, 0 where d is 0."""
    return torch.where(d != 0, 1.0 / torch.where(d == 0, 1.0, d), 0.0)


def q4_quant(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[..., D] → (codes u8 [..., D] ∈ [0, 15], d f32 [..., G]): reference
    quantize_row_q4_0 per 32-group: d = signed max / −8, q = floor(x/d + 8.5)
    (round half up) clipped to [0, 15]; value (q − 8)·d. A zero group has
    d = 0 and every code 8."""
    xg = _grouped(x)
    d = _signed_max(xg) / -8.0
    q = torch.floor(xg * _inv(d)[..., None] + 8.5).clamp(0, 15)
    return q.reshape(x.shape).to(torch.uint8), d


def q4_1_quant(x: torch.Tensor):
    """[..., D] → (codes u8 ∈ [0, 15], d, m f32 [..., G]): reference
    quantize_row_q4_1: d = (max − min)/15, m = min, q = floor((x − m)/d + 0.5)."""
    xg = _grouped(x)
    mn, mx = xg.amin(dim=-1), xg.amax(dim=-1)
    d = (mx - mn) / 15.0
    q = torch.floor((xg - mn[..., None]) * _inv(d)[..., None] + 0.5).clamp(0, 15)
    return q.reshape(x.shape).to(torch.uint8), d, mn


def q5_0_quant(x: torch.Tensor):
    """[..., D] → (codes u8 ∈ [0, 31], d f32 [..., G]): d = signed max / −16,
    q = floor(x/d + 16.5); value (q − 16)·d."""
    xg = _grouped(x)
    d = _signed_max(xg) / -16.0
    q = torch.floor(xg * _inv(d)[..., None] + 16.5).clamp(0, 31)
    return q.reshape(x.shape).to(torch.uint8), d


def q5_1_quant(x: torch.Tensor):
    """[..., D] → (codes u8 ∈ [0, 31], d, m): d = (max − min)/31, m = min,
    q = floor((x − m)/d + 0.5); value q·d + m."""
    xg = _grouped(x)
    mn, mx = xg.amin(dim=-1), xg.amax(dim=-1)
    d = (mx - mn) / 31.0
    q = torch.floor((xg - mn[..., None]) * _inv(d)[..., None] + 0.5).clamp(0, 31)
    return q.reshape(x.shape).to(torch.uint8), d, mn


def iq4nl_quant(x: torch.Tensor):
    """[..., D] → (codes u8 ∈ [0, 15], d f32 [..., G]): d = signed max / −127
    (the codebook's first level) and each element's nearest level (the first
    on a tie). The reference's ±ntry scale search is skipped, as JAX skips it
    for KV rows."""
    xg = _grouped(x)
    d = _signed_max(xg) / -127.0
    scaled = xg * _inv(d)[..., None]
    lut = torch.as_tensor(KVALUES_IQ4NL, dtype=torch.float32, device=x.device)
    codes = (scaled[..., None] - lut).abs().argmin(dim=-1)
    return codes.reshape(x.shape).to(torch.uint8), d


def pack_bit_plane(bits: torch.Tensor) -> torch.Tensor:
    """[..., D] 0/1 → [..., D/8] u8 (bit e % 8 of byte e // 8 holds elem e)."""
    b8 = bits.to(torch.int32).reshape(*bits.shape[:-1], bits.shape[-1] // 8, 8)
    w = torch.arange(8, dtype=torch.int32, device=bits.device)
    return (b8 << w).sum(dim=-1).to(torch.uint8)


def unpack_bit_plane(qh: torch.Tensor) -> torch.Tensor:
    """[..., D/8] u8 → [..., D] int32 0/1 (inverse of pack_bit_plane)."""
    w = torch.arange(8, dtype=torch.int32, device=qh.device)
    bits = (qh[..., None].to(torch.int32) >> w) & 1
    return bits.reshape(*qh.shape[:-1], qh.shape[-1] * 8)


def q4_pack_rows(q: torch.Tensor) -> torch.Tensor:
    """[..., 2·T2, D] codes → [..., T2, D] bytes: row 2j in the low nibble,
    row 2j+1 in the high one."""
    pairs = q.to(torch.int32).reshape(*q.shape[:-2], q.shape[-2] // 2, 2, q.shape[-1])
    return (pairs[..., 0, :] | (pairs[..., 1, :] << 4)).to(torch.uint8)


def q4_unpack_rows(b: torch.Tensor) -> torch.Tensor:
    """[..., S2, D] bytes → [..., 2·S2, D] int32 codes 0..15."""
    bi = b.to(torch.int32)
    inter = torch.stack([bi & 15, bi >> 4], dim=-2)  # [..., S2, 2, D]
    return inter.reshape(*b.shape[:-2], b.shape[-2] * 2, b.shape[-1])


def parity_to_rows(d: torch.Tensor) -> torch.Tensor:
    """Parity-major group values [..., 2G, S/2] → row-major [..., S, G]
    (plane p·G + g at column j holds row 2j + p's group g)."""
    *lead, twog, s2 = d.shape
    dr = d.reshape(*lead, 2, twog // 2, s2).movedim(-1, -3)  # [..., S2, 2, G]
    return dr.reshape(*lead, 2 * s2, twog // 2)


def rows_to_parity(d: torch.Tensor) -> torch.Tensor:
    """Inverse of parity_to_rows: [..., S, G] → [..., 2G, S/2]."""
    *lead, s, g = d.shape
    return d.reshape(*lead, s // 2, 2, g).movedim(-3, -1).reshape(*lead, 2 * g, s // 2)


def parity_view(d: torch.Tensor) -> torch.Tensor:
    """A parity-major plane [N, H, 2G, S/2] as a view [N, H, S/2, 2, G]:
    row r's group values sit at [.., r // 2, r % 2, :] (in-place writes)."""
    n, h, twog, s2 = d.shape
    return d.view(n, h, 2, twog // 2, s2).permute(0, 1, 4, 2, 3)


def row_quant(fmt: str, x: torch.Tensor) -> dict:
    """[..., D] rows → per-row fields of a packed format: 'q' low-nibble
    codes u8 [..., D], 'd' scales [..., G], optional 'm' mins [..., G] and
    'qh' fifth-bit plane u8 [..., D/8]."""
    if fmt == "q4_0":
        q, d = q4_quant(x)
        return {"q": q, "d": d}
    if fmt == "q4_1":
        q, d, m = q4_1_quant(x)
        return {"q": q, "d": d, "m": m}
    if fmt == "iq4_nl":
        q, d = iq4nl_quant(x)
        return {"q": q, "d": d}
    if fmt == "q5_0":
        q, d = q5_0_quant(x)
        return {"q": q & 15, "qh": pack_bit_plane(q >> 4), "d": d}
    q, d, m = q5_1_quant(x)
    return {"q": q & 15, "qh": pack_bit_plane(q >> 4), "d": d, "m": m}


def packed_deq(fmt: str, arrs: dict, dtype) -> torch.Tensor:
    """A packed plane's tensors ('qs' [..., S/2, D], 'd' [..., 2G, S/2] and
    optionally 'm', 'qh') → rows [..., S, D] in `dtype`."""
    codes = q4_unpack_rows(arrs["qs"])
    if "qh" in arrs:
        codes = codes + (unpack_bit_plane(arrs["qh"]) << 4)  # 0..31
    dr = parity_to_rows(arrs["d"])
    if fmt == "iq4_nl":
        lut = torch.as_tensor(KVALUES_IQ4NL, dtype=torch.float32, device=codes.device)
        vals = lut[codes.long()]
    elif fmt in ("q4_1", "q5_1"):
        vals = codes.float()
    else:
        vals = (codes - (8 if fmt == "q4_0" else 16)).float()
    g = dr.shape[-1]
    out = vals.reshape(*vals.shape[:-1], g, vals.shape[-1] // g) * dr[..., None]
    if "m" in arrs:
        out = out + parity_to_rows(arrs["m"])[..., None]
    return out.reshape(vals.shape).to(dtype)


def q4_deq_plane(qs: torch.Tensor, d: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """(byte plane [..., S/2, D], parity-major scales [..., 2G, S/2]) →
    rows [..., S, D] (q − 8)·d in `dtype` (bf16, as JAX's)."""
    return packed_deq("q4_0", {"qs": qs, "d": d}, dtype)
