"""Contiguous KV caches (counterpart of the JAX package's runtime/kv_cache.py
`KVCache`, `QuantKVCache`, `Q4KVCache`, `MixedKVCache`, `make_kv_cache` and
`causal_mask`).

One buffer per layer, [B, Hkv, S, D] — the reference's per-layer k_l / v_l
tensors — in every -ctk / -ctv type of the reference:
- `KVCache`: dense rows, bf16, f16 or f32;
- `QuantKVCache` (q8_0): int8 rows with one f32 scale per row;
- `Q4KVCache` (q4_0): row pairs packed into a byte plane [B, Hkv, S/2, D]
  (row 2j in the low nibble, 2j+1 in the high one) with f32 scales per
  32-wide group of D, stored parity-major as [B, Hkv, 2G, S/2];
- `MixedKVCache`: K and V in two formats of their own (a split -ctv), or
  q4_1, q5_0, q5_1 and iq4_nl, whose planes are nibble planes like q4_0's
  plus a per-group min (q4_1, q5_1) and a fifth-bit plane [B, Hkv, S, D/8]
  (q5_0, q5_1).
Every plane is bit-equal to the JAX cache's after the same writes.

The JAX package updates donated buffers functionally; here new rows are
written in place, so the kernels' operands are the layer buffers themselves,
and a slot's view (`slot`) is a narrow of dim 0 that prefill writes through.
Writes that JAX drops (a per-slot offset of `capacity` for an idle slot, a
packed row of `capacity` for padding) are dropped here too, without a host
sync: see `_drop_scatter`. A nibble write merges the new code into the byte
it shares with the neighbouring row; when both rows of a byte arrive in one
packed step, each takes its sibling's code from the batch.
"""

from __future__ import annotations

import torch

from ..quant.kv_planes import (PACKED_KV_FORMATS, packed_deq, parity_view, q4_groups,
                               q4_pack_rows, q4_unpack_rows, q8_dequant, q8_quant, row_quant)


def _drop_scatter(pairs, i0: torch.Tensor, i2: torch.Tensor, keep: torch.Tensor,
                  i3: torch.Tensor | None = None) -> None:
    """buf[i0[p], :, i2[p]] = val[p] (buf[i0[p], :, i2[p], i3[p]] when i3 is
    given) for every (buf, val) in `pairs` where keep[p]; entries with keep
    False are dropped (JAX's mode="drop").

    Done with no host sync: a dropped entry is pointed at the first kept
    entry's target and value, so targets that repeat always carry equal
    values (entries that share a target must carry equal values themselves);
    with nothing kept, every entry rewrites the value already at an in-range
    target. buf is [N0, H, N2, ...], val [P, H, ...]."""
    p = keep.shape[0]
    if p == 0:
        return
    first = torch.argmax(keep.to(torch.int32))
    src = torch.where(keep, torch.arange(p, device=keep.device), first)
    k_src = keep[src]
    t3 = () if i3 is None else (i3.long()[src],)
    for buf, val in pairs:
        t0 = i0.long()[src].clamp(0, buf.shape[0] - 1)
        t2 = i2.long()[src].clamp(0, buf.shape[2] - 1)
        new = val[src].to(buf.dtype)
        old = buf[(t0, slice(None), t2, *t3)]
        buf[(t0, slice(None), t2, *t3)] = torch.where(
            k_src.view(-1, *[1] * (new.dim() - 1)), new, old)


def _per_slot_rows(offset, b: int, t: int, capacity: int, device):
    """A [B] offset vector → (slot ids, rows, keep) of a T=1 write."""
    if t != 1:
        raise ValueError(f"per-slot cache offsets need T == 1, got T={t}")
    off = offset.to(device=device, dtype=torch.long)
    return torch.arange(b, device=device), off, (off >= 0) & (off < capacity)


def _check_rows(offset: int, t: int, capacity: int) -> int:
    off = int(offset)
    if not 0 <= off <= capacity - t:
        raise IndexError(f"cache write rows [{off}, {off + t}) outside capacity {capacity}")
    return off


def _is_per_slot(offset) -> bool:
    return torch.is_tensor(offset) and offset.dim() == 1


# ---------------------------------------------------------------------------
# planes: one of K or V in one format, as a dict of per-layer buffer lists
# (JAX kv_cache.py:610-853: "x" dense; "qs", "d" q8_0; "qs", "d" and
# optionally "m", "qh" for the packed formats of quant/kv_planes.py)
# ---------------------------------------------------------------------------

_DENSE_DTYPES = {"f32": torch.float32, "f16": torch.float16, "bf16": torch.bfloat16}
_DENSE_FORMATS = {dt: fmt for fmt, dt in _DENSE_DTYPES.items()}
KV_PLANE_FORMATS = ("f32", "f16", "bf16", "q8_0") + PACKED_KV_FORMATS


def _plane_create(fmt: str, n_layers, n_batch, n_ctx, n_kv_heads, head_dim, device) -> dict:
    def bufs(shape, dt):
        return [torch.zeros(shape, dtype=dt, device=device) for _ in range(n_layers)]

    rows = (n_batch, n_kv_heads, n_ctx, head_dim)
    if fmt in _DENSE_DTYPES:
        return {"x": bufs(rows, _DENSE_DTYPES[fmt])}
    if fmt == "q8_0":
        return {"qs": bufs(rows, torch.int8),
                "d": bufs((n_batch, n_kv_heads, 1, n_ctx), torch.float32)}
    if fmt not in PACKED_KV_FORMATS:
        raise ValueError(f"unknown KV plane format {fmt!r}")
    if n_ctx % 2:
        raise ValueError(f"-ctk/-ctv {fmt}: the context ({n_ctx}) must be even (row pairs)")
    dshape = (n_batch, n_kv_heads, 2 * q4_groups(head_dim), n_ctx // 2)
    out = {"qs": bufs((n_batch, n_kv_heads, n_ctx // 2, head_dim), torch.uint8),
           "d": bufs(dshape, torch.float32)}
    if fmt in ("q4_1", "q5_1"):
        out["m"] = bufs(dshape, torch.float32)
    if fmt in ("q5_0", "q5_1"):
        if head_dim % 8:
            raise ValueError(f"-ctk/-ctv {fmt}: head_dim {head_dim} is not a multiple of 8")
        out["qh"] = bufs((n_batch, n_kv_heads, n_ctx, head_dim // 8), torch.uint8)
    return out


def _plane_capacity(fmt: str, arrs: dict) -> int:
    if fmt in PACKED_KV_FORMATS:
        return arrs["qs"][0].shape[2] * 2
    return arrs["x" if fmt in _DENSE_DTYPES else "qs"][0].shape[2]


def _nibble_rows(bufs: dict, f: dict, i0, rows, keep, sib=None) -> None:
    """Write single rows of a nibble plane in place: entry p of the per-row
    fields f (q [P, H, D], d / m [P, H, G], qh [P, H, D/8]) goes to row
    rows[p] of index i0[p] (a slot, or a page) where keep[p]. The byte it
    shares with the neighbouring row keeps that row's code, or takes the
    code of the batch entry sib[p] lands on (a [P, P] bool; JAX's in-batch
    sibling merge). The merged bytes are computed before anything is
    written, so siblings that share a byte write equal values."""
    qs = bufs["qs"]
    r2, par = rows.long() // 2, (rows.long() % 2)
    old = qs[i0.long().clamp(0, qs.shape[0] - 1), :,
             r2.clamp(0, qs.shape[2] - 1)].to(torch.int32)  # [P, H, D]
    q = f["q"].to(torch.int32)
    pb = par.view(-1, 1, 1)
    other = torch.where(pb == 0, old >> 4, old & 15)
    if sib is not None:
        has = sib.any(dim=1).view(-1, 1, 1)
        other = torch.where(has, q[sib.to(torch.int32).argmax(dim=1)], other)
    byte = torch.where(pb == 0, q | (other << 4), other | (q << 4))
    _drop_scatter(((qs, byte),), i0, r2, keep)
    _drop_scatter([(parity_view(bufs[k]), f[k]) for k in ("d", "m") if k in f],
                  i0, r2, keep, par)
    if "qh" in f:
        _drop_scatter(((bufs["qh"], f["qh"]),), i0, rows, keep)


def _nibble_splice(bufs: dict, f: dict, off: int) -> None:
    """Write T rows [B, H, T, ...] of a nibble plane in place at rows
    off .. off+T-1: the byte rows they cover are unpacked, spliced and
    repacked (at an odd offset or an odd T the edge bytes keep their other
    row's code), and their group values written at their parity planes."""
    qs = bufs["qs"]
    t = f["q"].shape[2]
    lo, hi = off // 2, (off + t + 1) // 2
    codes = q4_unpack_rows(qs[:, :, lo:hi])
    codes[:, :, off - 2 * lo:off - 2 * lo + t] = f["q"]
    qs[:, :, lo:hi] = q4_pack_rows(codes)
    r = torch.arange(off, off + t, device=qs.device)
    for k in ("d", "m"):
        if k in f:
            parity_view(bufs[k])[:, :, r // 2, r % 2] = f[k]
    if "qh" in f:
        bufs["qh"][:, :, off:off + t] = f["qh"]


def _layer_bufs(arrs: dict, layer: int) -> dict:
    return {k: v[layer] for k, v in arrs.items()}


def _plane_write(fmt: str, arrs: dict, layer: int, new: torch.Tensor, offset) -> None:
    """new [B, T, Hkv, D] rows at `offset` (scalar, or [B] with T = 1)."""
    bufs = _layer_bufs(arrs, layer)
    b, t = new.shape[:2]
    cap = _plane_capacity(fmt, arrs)
    per_slot = _is_per_slot(offset)
    if per_slot:
        sid, rows, keep = _per_slot_rows(offset, b, t, cap, new.device)
        new_h = new[:, 0]  # [B, H, D]
    else:
        off = _check_rows(offset, t, cap)
        new_h = new.transpose(1, 2)  # [B, H, T, D]
    if fmt in _DENSE_DTYPES or fmt == "q8_0":
        if fmt == "q8_0":
            qv, dv = q8_quant(new_h)
            pairs = ((bufs["qs"], qv), (bufs["d"][:, :, 0], dv))
        else:
            pairs = ((bufs["x"], new_h),)
        if per_slot:
            _drop_scatter(pairs, sid, rows, keep)
        else:
            for buf, val in pairs:
                buf[:, :, off:off + t] = val
        return
    f = row_quant(fmt, new_h)
    if per_slot:
        _nibble_rows(bufs, f, sid, rows, keep)
    else:
        _nibble_splice(bufs, f, off)


def _plane_write_packed(fmt: str, arrs: dict, layer: int, new: torch.Tensor, slot_ids,
                        rows) -> None:
    """new [P, Hkv, D] rows at (slot_ids[p], rows[p]); rows == capacity are
    padding and dropped."""
    bufs = _layer_bufs(arrs, layer)
    cap = _plane_capacity(fmt, arrs)
    keep = rows < cap
    if fmt in _DENSE_DTYPES:
        _drop_scatter(((bufs["x"], new),), slot_ids, rows, keep)
    elif fmt == "q8_0":
        qv, dv = q8_quant(new)
        _drop_scatter(((bufs["qs"], qv), (bufs["d"][:, :, 0], dv)), slot_ids, rows, keep)
    else:
        sib = ((slot_ids[:, None] == slot_ids[None, :]) & ((rows[:, None] ^ 1) == rows[None, :])
               & keep[:, None] & keep[None, :])
        _nibble_rows(bufs, row_quant(fmt, new), slot_ids, rows, keep, sib)


def _plane_layer(fmt: str, arrs: dict, i: int, dtype=torch.bfloat16) -> torch.Tensor:
    """Rows [B, Hkv, S, D]: a dense plane as stored, a quantized one
    dequantized into `dtype` (bf16 for attention, as JAX's)."""
    if fmt in _DENSE_DTYPES:
        return arrs["x"][i]
    if fmt == "q8_0":
        return q8_dequant(arrs["qs"][i], arrs["d"][i][:, :, 0], dtype)
    return packed_deq(fmt, _layer_bufs(arrs, i), dtype)


class _PlaneCache:
    """A cache of two planes (K and V), each in a format of its own: the one
    write path of every format (`_plane_write`, `_plane_write_packed`)."""

    def __init__(self, k_fmt: str, v_fmt: str, k_arrs: dict, v_arrs: dict):
        self.k_fmt, self.v_fmt = k_fmt, v_fmt
        self.k_arrs, self.v_arrs = k_arrs, v_arrs

    @classmethod
    def _make(cls, n_layers, n_batch, n_ctx, n_kv_heads, head_dim, k_fmt, v_fmt, device):
        return cls(k_fmt, v_fmt,
                   _plane_create(k_fmt, n_layers, n_batch, n_ctx, n_kv_heads, head_dim, device),
                   _plane_create(v_fmt, n_layers, n_batch, n_ctx, n_kv_heads, head_dim, device))

    @property
    def capacity(self) -> int:
        return _plane_capacity(self.k_fmt, self.k_arrs)

    def planes(self) -> list[torch.Tensor]:
        """Every buffer of both planes (slot copies, state checks)."""
        return [b for arrs in (self.k_arrs, self.v_arrs) for bufs in arrs.values() for b in bufs]

    def write(self, layer: int, k_new: torch.Tensor, v_new: torch.Tensor, offset) -> None:
        """Write [B, T, Hkv, D] rows in place at sequence offset `offset`: a
        scalar (the whole batch; rows must fit) or a [B] tensor (per-slot
        decode, T=1; a slot whose offset is outside [0, capacity) is
        skipped). Each plane quantizes the rows into its own format."""
        _plane_write(self.k_fmt, self.k_arrs, layer, k_new, offset)
        _plane_write(self.v_fmt, self.v_arrs, layer, v_new, offset)

    def write_packed(self, layer: int, k_new, v_new, slot_ids, rows) -> None:
        """Scatter [P, Hkv, D] rows at (slot_ids[p], rows[p]) — the mixed
        prompt+decode ubatch; padding tokens carry rows == capacity and are
        dropped."""
        _plane_write_packed(self.k_fmt, self.k_arrs, layer, k_new, slot_ids, rows)
        _plane_write_packed(self.v_fmt, self.v_arrs, layer, v_new, slot_ids, rows)

    def layer(self, i: int, dtype=torch.bfloat16) -> tuple[torch.Tensor, torch.Tensor]:
        """(k, v) [B, Hkv, S, D]: dense planes as stored (the layer's own
        buffers), quantized ones dequantized into `dtype` (bf16 for
        attention, as JAX's; state files take f32)."""
        return (_plane_layer(self.k_fmt, self.k_arrs, i, dtype),
                _plane_layer(self.v_fmt, self.v_arrs, i, dtype))

    def slot(self, idx: int):
        """Slot idx's [1, ...] views (writes land in this cache)."""
        def narrow(arrs):
            return {k: [a.narrow(0, idx, 1) for a in bufs] for k, bufs in arrs.items()}

        return type(self)(self.k_fmt, self.v_fmt, narrow(self.k_arrs), narrow(self.v_arrs))


class KVCache(_PlaneCache):
    """Dense rows (-ctk bf16, f16 or f32): L × [B, Hkv, S, D] per plane."""

    @classmethod
    def create(cls, n_layers: int, n_batch: int, n_ctx: int, n_kv_heads: int, head_dim: int,
               device="cpu", dtype=torch.bfloat16) -> "KVCache":
        fmt = _DENSE_FORMATS[dtype]
        return cls._make(n_layers, n_batch, n_ctx, n_kv_heads, head_dim, fmt, fmt, device)

    k = property(lambda self: self.k_arrs["x"])
    v = property(lambda self: self.v_arrs["x"])


class _PackedLayerCache(_PlaneCache):
    """A quantized cache whose decode kernel reads its planes as stored."""

    k_qs = property(lambda self: self.k_arrs["qs"])
    k_d = property(lambda self: self.k_arrs["d"])
    v_qs = property(lambda self: self.v_arrs["qs"])
    v_d = property(lambda self: self.v_arrs["d"])

    def packed_layer(self, i: int):
        """(k_qs, k_d, v_qs, v_d) for the cache type's flash-decode kernel."""
        return self.k_qs[i], self.k_d[i], self.v_qs[i], self.v_d[i]


class QuantKVCache(_PackedLayerCache):
    """Q8_0 KV cache (-ctk q8_0): int8 rows [B, Hkv, S, D] and one f32 scale
    per row, [B, Hkv, 1, S] as the JAX package lays them out. Decode reads
    them as they are (flash_decode_q8, kernel B5)."""

    @classmethod
    def create(cls, n_layers: int, n_batch: int, n_ctx: int, n_kv_heads: int, head_dim: int,
               device="cpu") -> "QuantKVCache":
        return cls._make(n_layers, n_batch, n_ctx, n_kv_heads, head_dim, "q8_0", "q8_0", device)


class Q4KVCache(_PackedLayerCache):
    """Q4_0 KV cache (-ctk q4_0), a quarter of the bf16 bytes: byte planes
    [B, Hkv, S/2, D] u8 of row pairs and parity-major f32 group scales
    [B, Hkv, 2G, S/2], G = D/32 (plane p·G + g holds group g of the rows of
    parity p). Decode reads them as they are (flash_decode_q4, kernel B8);
    `layer` dequantizes for the plain attention of prompt chunks."""

    @classmethod
    def create(cls, n_layers: int, n_batch: int, n_ctx: int, n_kv_heads: int, head_dim: int,
               device="cpu") -> "Q4KVCache":
        return cls._make(n_layers, n_batch, n_ctx, n_kv_heads, head_dim, "q4_0", "q4_0", device)


class MixedKVCache(_PlaneCache):
    """K and V in formats of their own (reference -ctk / -ctv): any pair of
    KV_PLANE_FORMATS. Attention reads `layer`: each quantized plane
    dequantized to bf16 (dense planes as stored), as JAX's XLA path does;
    decode then runs the bf16 / f16 / f32 flash-decode kernel."""

    @classmethod
    def create(cls, n_layers: int, n_batch: int, n_ctx: int, n_kv_heads: int, head_dim: int,
               k_fmt: str = "q8_0", v_fmt: str = "q4_0", device="cpu") -> "MixedKVCache":
        return cls._make(n_layers, n_batch, n_ctx, n_kv_heads, head_dim, k_fmt, v_fmt, device)


def norm_kv_type(t: str) -> str:
    return {"q8": "q8_0", "q4": "q4_0"}.get(t, t)


def make_kv_cache(n_layers: int, n_batch: int, n_ctx: int, n_kv_heads: int, head_dim: int,
                  kv_type: str = "bf16", device="cpu", v_type: str | None = None):
    """-ctk `kv_type`, -ctv `v_type` (default: -ctk), any of KV_PLANE_FORMATS,
    routed as the JAX package routes them: f32 / f16 / bf16 → KVCache,
    q8_0 → QuantKVCache, q4_0 → Q4KVCache; a split pair, or q4_1, q5_0,
    q5_1, iq4_nl → MixedKVCache."""
    kv_type = norm_kv_type(kv_type)
    v_type = norm_kv_type(v_type or kv_type)
    for t in (kv_type, v_type):
        if t not in KV_PLANE_FORMATS:
            raise ValueError(f"unknown KV plane format {t!r}")
    if v_type != kv_type or kv_type in ("q4_1", "q5_0", "q5_1", "iq4_nl"):
        return MixedKVCache.create(n_layers, n_batch, n_ctx, n_kv_heads, head_dim, kv_type,
                                   v_type, device)
    if kv_type == "q8_0":
        return QuantKVCache.create(n_layers, n_batch, n_ctx, n_kv_heads, head_dim, device)
    if kv_type == "q4_0":
        return Q4KVCache.create(n_layers, n_batch, n_ctx, n_kv_heads, head_dim, device)
    return KVCache.create(n_layers, n_batch, n_ctx, n_kv_heads, head_dim, device,
                          _DENSE_DTYPES[kv_type])


def window_keep(j: torch.Tensor, pos: torch.Tensor, window: int = 0, chunk: int = 0):
    """The sliding-window or chunked-attention rule of a layer beside the
    causal one (JAX models/llama.py:777-787, :844-849): key cell j attends
    query position pos iff j > pos − window (window > 0), or j ≥
    ⌊pos / chunk⌋·chunk (chunk > 0). j and pos broadcast; None when the layer
    has neither."""
    if chunk:
        return j >= (pos // chunk) * chunk
    if window:
        return j > pos - window
    return None


def causal_mask(positions: torch.Tensor, n_kv: int, n_past, window: int = 0,
                chunk: int = 0) -> torch.Tensor:
    """[B, T] query positions → [B, T, n_kv] bool mask: key cell j is
    attendable iff j < n_past + T (written), j <= the query position and,
    on a sliding-window or chunked layer, `window_keep`. n_past is a scalar
    or a [B] tensor."""
    t = positions.shape[1]
    j = torch.arange(n_kv, device=positions.device)
    if torch.is_tensor(n_past) and n_past.dim() == 1:
        n_past = n_past.to(positions.device)[:, None, None]
    pos = positions[:, :, None]
    mask = (j[None, None, :] < (n_past + t)) & (j[None, None, :] <= pos)
    keep = window_keep(j[None, None, :], pos, window, chunk)
    return mask if keep is None else mask & keep
