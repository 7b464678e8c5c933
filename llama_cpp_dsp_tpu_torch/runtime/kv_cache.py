"""Contiguous KV caches (counterpart of the JAX package's runtime/kv_cache.py
`KVCache`, `QuantKVCache`, `make_kv_cache` and `causal_mask`).

One buffer per layer, [B, Hkv, S, D] — the reference's per-layer k_l / v_l
tensors: bf16 (`KVCache`) or int8 rows with one f32 scale per row
(`QuantKVCache`, -ctk q8_0). The JAX package updates donated buffers
functionally; here new rows are written in place, so the kernels' operands
are the layer buffers themselves, and a slot's view (`slot`) is a narrow of
dim 0 that prefill writes through.

Writes that JAX drops (a per-slot offset of `capacity` for an idle slot, a
packed row of `capacity` for padding) are dropped here too, without a host
sync: see `_drop_scatter`. The other -ctk types (q4_0, q4_1, q5_0, q5_1,
iq4_nl, f16, f32 and a split -ctv) are queued in ROADMAP.md queue A5.
"""

from __future__ import annotations

import torch


def _drop_scatter(pairs, i0: torch.Tensor, i2: torch.Tensor, keep: torch.Tensor) -> None:
    """buf[i0[p], :, i2[p]] = val[p] for every (buf, val) in `pairs` where
    keep[p]; entries with keep False are dropped (JAX's mode="drop").

    Done with no host sync: a dropped entry is pointed at the first kept
    entry's target and value, so targets that repeat always carry equal
    values; with nothing kept, every entry rewrites the value already at an
    in-range target. buf is [N0, H, N2, ...], val [P, H, ...]."""
    p = keep.shape[0]
    if p == 0:
        return
    first = torch.argmax(keep.to(torch.int32))
    src = torch.where(keep, torch.arange(p, device=keep.device), first)
    k_src = keep[src]
    t0 = i0.long()[src]
    for buf, val in pairs:
        t2 = i2.long()[src].clamp(0, buf.shape[2] - 1)
        new = val[src].to(buf.dtype)
        old = buf[t0, :, t2]
        buf[t0, :, t2] = torch.where(k_src.view(-1, *[1] * (new.dim() - 1)), new, old)


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


class KVCache:
    def __init__(self, k: list[torch.Tensor], v: list[torch.Tensor]):
        self.k = k  # L × [B, Hkv, S, D]
        self.v = v

    @classmethod
    def create(cls, n_layers: int, n_batch: int, n_ctx: int, n_kv_heads: int, head_dim: int,
               device="cpu") -> "KVCache":
        shape = (n_batch, n_kv_heads, n_ctx, head_dim)
        return cls(
            [torch.zeros(shape, dtype=torch.bfloat16, device=device) for _ in range(n_layers)],
            [torch.zeros(shape, dtype=torch.bfloat16, device=device) for _ in range(n_layers)])

    @property
    def capacity(self) -> int:
        return self.k[0].shape[2]

    def write(self, layer: int, k_new: torch.Tensor, v_new: torch.Tensor, offset) -> None:
        """Write [B, T, Hkv, D] rows in place at sequence offset `offset`: a
        scalar (the whole batch; rows must fit) or a [B] tensor (per-slot
        decode, T=1; a slot whose offset is outside [0, capacity) is skipped)."""
        b, t = k_new.shape[:2]
        if torch.is_tensor(offset) and offset.dim() == 1:
            sid, rows, keep = _per_slot_rows(offset, b, t, self.capacity, k_new.device)
            _drop_scatter(((self.k[layer], k_new[:, 0]), (self.v[layer], v_new[:, 0])),
                          sid, rows, keep)
            return
        off = _check_rows(offset, t, self.capacity)
        self.k[layer][:, :, off:off + t] = k_new.transpose(1, 2)
        self.v[layer][:, :, off:off + t] = v_new.transpose(1, 2)

    def write_packed(self, layer: int, k_new: torch.Tensor, v_new: torch.Tensor,
                     slot_ids: torch.Tensor, rows: torch.Tensor) -> None:
        """Scatter [P, Hkv, D] rows at (slot_ids[p], rows[p]) — the mixed
        prompt+decode ubatch; padding tokens carry rows == capacity and are
        dropped."""
        _drop_scatter(((self.k[layer], k_new), (self.v[layer], v_new)), slot_ids, rows,
                      rows < self.capacity)

    def layer(self, i: int) -> tuple[torch.Tensor, torch.Tensor]:
        """(k, v) as [B, Hkv, S, D] — the layer's own buffers."""
        return self.k[i], self.v[i]

    def slot(self, idx: int) -> "KVCache":
        """Slot idx's [1, Hkv, S, D] views (writes land in this cache)."""
        return KVCache([a.narrow(0, idx, 1) for a in self.k], [a.narrow(0, idx, 1) for a in self.v])


def _q8_quant(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[..., D] → (qs int8 [..., D], d f32 [...]): one scale per row over the
    whole head dim, amax / 127, rounded half to even — bit-exact with the
    JAX package's `_q8_quant` (reference quantize_row_q8_0's scheme)."""
    xf = x.float()
    d = xf.abs().amax(dim=-1) / 127.0
    inv = torch.where(d > 0, 1.0 / torch.clamp(d, min=1e-30), torch.zeros_like(d))
    qs = torch.clamp(torch.round(xf * inv[..., None]), -127, 127)
    return qs.to(torch.int8), d


def _q8_dequant(qs: torch.Tensor, d: torch.Tensor, dtype) -> torch.Tensor:
    return (qs.float() * d[..., None]).to(dtype)


class QuantKVCache:
    """Q8_0 KV cache (-ctk q8_0): int8 rows [B, Hkv, S, D] and one f32 scale
    per row, [B, Hkv, 1, S] as the JAX package lays them out."""

    def __init__(self, k_qs, k_d, v_qs, v_d):
        self.k_qs, self.k_d, self.v_qs, self.v_d = k_qs, k_d, v_qs, v_d

    @classmethod
    def create(cls, n_layers: int, n_batch: int, n_ctx: int, n_kv_heads: int, head_dim: int,
               device="cpu") -> "QuantKVCache":
        shape = (n_batch, n_kv_heads, n_ctx, head_dim)
        dshape = (n_batch, n_kv_heads, 1, n_ctx)

        def planes(shp, dt):
            return [torch.zeros(shp, dtype=dt, device=device) for _ in range(n_layers)]

        return cls(planes(shape, torch.int8), planes(dshape, torch.float32),
                   planes(shape, torch.int8), planes(dshape, torch.float32))

    @property
    def capacity(self) -> int:
        return self.k_qs[0].shape[2]

    def _planes(self, layer: int, k_new, v_new):
        """((qs buffer, qs rows), (scale buffer [.., S] view, scales)) pairs."""
        kq, kd = _q8_quant(k_new)
        vq, vd = _q8_quant(v_new)
        return ((self.k_qs[layer], kq), (self.k_d[layer][:, :, 0], kd),
                (self.v_qs[layer], vq), (self.v_d[layer][:, :, 0], vd))

    def write(self, layer: int, k_new: torch.Tensor, v_new: torch.Tensor, offset) -> None:
        """As KVCache.write, quantizing each new row."""
        b, t = k_new.shape[:2]
        if torch.is_tensor(offset) and offset.dim() == 1:
            sid, rows, keep = _per_slot_rows(offset, b, t, self.capacity, k_new.device)
            _drop_scatter(self._planes(layer, k_new[:, 0], v_new[:, 0]), sid, rows, keep)
            return
        off = _check_rows(offset, t, self.capacity)
        for buf, val in self._planes(layer, k_new.transpose(1, 2), v_new.transpose(1, 2)):
            buf[:, :, off:off + t] = val

    def write_packed(self, layer: int, k_new, v_new, slot_ids, rows) -> None:
        _drop_scatter(self._planes(layer, k_new, v_new), slot_ids, rows, rows < self.capacity)

    def layer(self, i: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Dequantized bf16 (k, v) [B, Hkv, S, D] for the plain attention."""
        return (_q8_dequant(self.k_qs[i], self.k_d[i][:, :, 0], torch.bfloat16),
                _q8_dequant(self.v_qs[i], self.v_d[i][:, :, 0], torch.bfloat16))

    def packed_layer(self, i: int):
        """(k_qs, k_d, v_qs, v_d) for the q8 flash-decode kernel."""
        return self.k_qs[i], self.k_d[i], self.v_qs[i], self.v_d[i]

    def slot(self, idx: int) -> "QuantKVCache":
        return QuantKVCache(*([a.narrow(0, idx, 1) for a in planes]
                              for planes in (self.k_qs, self.k_d, self.v_qs, self.v_d)))


def make_kv_cache(n_layers: int, n_batch: int, n_ctx: int, n_kv_heads: int, head_dim: int,
                  kv_type: str = "bf16", device="cpu"):
    """-ctk bf16 → KVCache, q8_0 → QuantKVCache; the other types raise."""
    kv_type = {"q8": "q8_0"}.get(kv_type, kv_type)
    if kv_type == "bf16":
        return KVCache.create(n_layers, n_batch, n_ctx, n_kv_heads, head_dim, device)
    if kv_type == "q8_0":
        return QuantKVCache.create(n_layers, n_batch, n_ctx, n_kv_heads, head_dim, device)
    raise NotImplementedError(
        f"-ctk {kv_type}: the port has bf16 and q8_0 KV caches (ROADMAP.md queue A5)")


def causal_mask(positions: torch.Tensor, n_kv: int, n_past) -> torch.Tensor:
    """[B, T] query positions → [B, T, n_kv] bool mask: key cell j is
    attendable iff j < n_past + T (written) and j <= the query position.
    n_past is a scalar or a [B] tensor."""
    t = positions.shape[1]
    j = torch.arange(n_kv, device=positions.device)
    if torch.is_tensor(n_past) and n_past.dim() == 1:
        n_past = n_past.to(positions.device)[:, None, None]
    written = j[None, None, :] < (n_past + t)
    causal = j[None, None, :] <= positions[:, :, None]
    return written & causal
