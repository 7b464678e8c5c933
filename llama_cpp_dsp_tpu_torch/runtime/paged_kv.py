"""Paged KV caches with shared-prefix page aliasing (counterpart of the JAX
package's runtime/paged_kv.py: `PagedKVCache`, `PagedQuantKVCache`,
`PagedQ4KVCache`, `PageAllocator`, `PagedSeq`).

K/V live in per-layer page pools [P, Hkv, page_size, D] (bf16, f16 or f32
rows; int8 rows with a scale per row; or Q4_0 pages of row pairs with
parity-major group scales, as `Q4KVCache` lays out a slot); each sequence
owns a block table of page ids ([B, max_blocks] int32 on the device, `P`
marks an unmapped block). Shared prompt prefixes alias the same pages with
host-side refcounts and copy-on-write. Writes route through the tables in
place; a row whose block is unmapped, or a padding row (== capacity), is
dropped. Decode attention reads the dense and q8 pages directly
(ops/kernels/attention.py `flash_decode_paged`, `flash_decode_paged_q8`);
Q4_0 pages are dequantized through the tables and decoded by
`flash_decode`, as the JAX package does (it has no paged-q4 kernel).
`layer` gathers a dense view for the plain attention of prompt chunks;
`gather_seq` / `scatter_seq` move one sequence's rows out and back in
(slot save and restore).
"""

from __future__ import annotations

import numpy as np
import torch

from ..quant.kv_planes import (q4_deq_plane, q4_groups, q4_pack_rows, q4_quant, q8_dequant,
                               q8_quant, row_quant, rows_to_parity)
from .kv_cache import _drop_scatter, _nibble_rows


class _PagedBase:
    """Table addressing shared by the bf16 and q8 paged caches. Subclasses
    keep their per-layer pools in `_pools()` (each [P, Hkv, ps, ...])."""

    tables: torch.Tensor  # [B, max_blocks] int32

    def _pools(self) -> list[list[torch.Tensor]]:
        raise NotImplementedError

    @property
    def n_pages(self) -> int:
        return self._pools()[0][0].shape[0]

    @property
    def n_layers(self) -> int:
        return len(self._pools()[0])

    @property
    def capacity(self) -> int:
        """Max per-sequence length (max_blocks × page_size)."""
        return self.tables.shape[1] * self.page_size

    def _targets(self, slot_ids: torch.Tensor, rows: torch.Tensor):
        """(page, in-page row, keep) of packed rows; rows ≥ capacity and
        unmapped blocks are not kept."""
        ps = self.page_size
        rows = rows.long()
        blk = torch.clamp(rows // ps, max=self.tables.shape[1] - 1)
        pages = self.tables[slot_ids.long(), blk].long()
        keep = (rows < self.capacity) & (pages < self.n_pages)
        return pages, rows % ps, keep

    def write(self, layer: int, k_new: torch.Tensor, v_new: torch.Tensor, offset) -> None:
        """[B, T, Hkv, D] per-slot rows at `offset` (scalar or [B])."""
        b, t = k_new.shape[:2]
        dev = k_new.device
        off = torch.as_tensor(offset, device=dev).long()
        if off.dim() == 0:
            off = off.expand(b)
        rows = off[:, None] + torch.arange(t, device=dev)[None, :]
        slot_ids = torch.arange(b, device=dev)[:, None].expand(b, t)
        self.write_packed(layer, k_new.reshape(b * t, *k_new.shape[2:]),
                          v_new.reshape(b * t, *v_new.shape[2:]),
                          slot_ids.reshape(-1), rows.reshape(-1))

    def copy_page(self, src: int, dst: int) -> None:
        """Copy-on-write: duplicate page src into page dst in every layer's
        pool, in place."""
        for pools in self._pools():
            for pool in pools:
                pool[dst].copy_(pool[src])

    def set_table_row(self, seq: int, row: np.ndarray) -> None:
        self.tables[seq].copy_(torch.from_numpy(np.asarray(row, np.int32)))

    def _gather(self, pool: torch.Tensor, seq: int | None = None) -> torch.Tensor:
        """Pool [P, Hkv, ps, X] → per-sequence dense [B, Hkv, max_blocks*ps, X]
        (unmapped blocks read the last page, as JAX clamps them); `seq`: that
        sequence only, [1, Hkv, S, X]."""
        tables = self.tables if seq is None else self.tables[seq:seq + 1]
        g = pool[torch.clamp(tables.long(), max=self.n_pages - 1)]  # [B, nb, Hkv, ps, X]
        b, nb, hkv, ps = g.shape[:4]
        return g.transpose(1, 2).reshape(b, hkv, nb * ps, *g.shape[4:])

    def _seq_pages(self, seq: int, s: int) -> torch.Tensor:
        """The page ids of sequence `seq`'s first s / page_size blocks
        (clamped to P-1, as JAX's scatter_seq clamps them)."""
        return torch.clamp(self.tables[seq, :s // self.page_size].long(), max=self.n_pages - 1)

    @staticmethod
    def _to_pages(rows: torch.Tensor, ps: int) -> torch.Tensor:
        """One sequence's rows [Hkv, S, X] → [S/ps, Hkv, ps, X]."""
        hkv, s = rows.shape[:2]
        return rows.reshape(hkv, s // ps, ps, *rows.shape[2:]).transpose(0, 1)


class PagedKVCache(_PagedBase):
    def __init__(self, k: list[torch.Tensor], v: list[torch.Tensor], tables: torch.Tensor):
        self.k, self.v, self.tables = k, v, tables  # L × [P, Hkv, ps, D]

    @classmethod
    def create(cls, n_layers: int, n_pages: int, n_seqs: int, max_blocks: int,
               n_kv_heads: int, head_dim: int, page_size: int = 128, device="cpu",
               dtype=torch.bfloat16) -> "PagedKVCache":
        shape = (n_pages, n_kv_heads, page_size, head_dim)
        return cls([torch.zeros(shape, dtype=dtype, device=device) for _ in range(n_layers)],
                   [torch.zeros(shape, dtype=dtype, device=device) for _ in range(n_layers)],
                   torch.full((n_seqs, max_blocks), n_pages, dtype=torch.int32, device=device))

    def _pools(self):
        return [self.k, self.v]

    @property
    def page_size(self) -> int:
        return self.k[0].shape[2]

    def write_packed(self, layer: int, k_new, v_new, slot_ids, rows) -> None:
        """Scatter [Ptok, Hkv, D] rows at (slot, row) through the tables."""
        pages, rin, keep = self._targets(slot_ids, rows)
        _drop_scatter(((self.k[layer], k_new), (self.v[layer], v_new)), pages, rin, keep)

    def layer(self, i: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Dense per-sequence gather view [B, Hkv, S, D]."""
        return self._gather(self.k[i]), self._gather(self.v[i])

    def gather_seq(self, seq: int) -> tuple[torch.Tensor, torch.Tensor]:
        """One sequence's rows [L, 1, Hkv, S, D] as stored."""
        return (torch.stack([self._gather(p, seq) for p in self.k]),
                torch.stack([self._gather(p, seq) for p in self.v]))

    def scatter_seq(self, seq: int, k: torch.Tensor, v: torch.Tensor) -> None:
        """Write [L, 1, Hkv, S, D] rows back into the sequence's first S / ps
        pages, in place (the pages must be its own: copy-on-write first)."""
        pages = self._seq_pages(seq, k.shape[3])
        for pools, rows in ((self.k, k), (self.v, v)):
            for pool, r in zip(pools, rows):
                pool[pages] = self._to_pages(r[0], self.page_size).to(pool.dtype)


class PagedQuantKVCache(_PagedBase):
    """Q8_0 pages: int8 rows [P, Hkv, ps, D] with one f32 scale per row,
    [P, Hkv, 1, ps]."""

    def __init__(self, k_qs, k_d, v_qs, v_d, tables):
        self.k_qs, self.k_d, self.v_qs, self.v_d, self.tables = k_qs, k_d, v_qs, v_d, tables

    @classmethod
    def create(cls, n_layers: int, n_pages: int, n_seqs: int, max_blocks: int,
               n_kv_heads: int, head_dim: int, page_size: int = 128,
               device="cpu") -> "PagedQuantKVCache":
        shape = (n_pages, n_kv_heads, page_size, head_dim)
        dshape = (n_pages, n_kv_heads, 1, page_size)

        def planes(shp, dt):
            return [torch.zeros(shp, dtype=dt, device=device) for _ in range(n_layers)]

        return cls(planes(shape, torch.int8), planes(dshape, torch.float32),
                   planes(shape, torch.int8), planes(dshape, torch.float32),
                   torch.full((n_seqs, max_blocks), n_pages, dtype=torch.int32, device=device))

    def _pools(self):
        return [self.k_qs, self.k_d, self.v_qs, self.v_d]

    @property
    def page_size(self) -> int:
        return self.k_qs[0].shape[2]

    def write_packed(self, layer: int, k_new, v_new, slot_ids, rows) -> None:
        pages, rin, keep = self._targets(slot_ids, rows)
        kq, kd = q8_quant(k_new)
        vq, vd = q8_quant(v_new)
        _drop_scatter(((self.k_qs[layer], kq), (self.k_d[layer][:, :, 0], kd),
                       (self.v_qs[layer], vq), (self.v_d[layer][:, :, 0], vd)),
                      pages, rin, keep)

    def layer(self, i: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Dequantized bf16 dense gather view [B, Hkv, S, D]."""
        return (q8_dequant(self._gather(self.k_qs[i]), self._gather(self.k_d[i][:, :, 0]),
                           torch.bfloat16),
                q8_dequant(self._gather(self.v_qs[i]), self._gather(self.v_d[i][:, :, 0]),
                           torch.bfloat16))

    def packed_pages(self, i: int):
        """(k_qs, k_d, v_qs, v_d) page pools for the paged q8 kernel."""
        return self.k_qs[i], self.k_d[i], self.v_qs[i], self.v_d[i]

    def gather_seq(self, seq: int, dtype=torch.bfloat16) -> tuple[torch.Tensor, torch.Tensor]:
        """One sequence's rows [L, 1, Hkv, S, D], dequantized into `dtype`
        (bf16, as JAX's; state files take f32)."""
        def one(q, d):
            return q8_dequant(self._gather(q, seq), self._gather(d[:, :, 0], seq), dtype)

        return (torch.stack([one(q, d) for q, d in zip(self.k_qs, self.k_d)]),
                torch.stack([one(q, d) for q, d in zip(self.v_qs, self.v_d)]))

    def scatter_seq(self, seq: int, k: torch.Tensor, v: torch.Tensor) -> None:
        """Quantize [L, 1, Hkv, S, D] rows into the sequence's pages, in place."""
        pages = self._seq_pages(seq, k.shape[3])
        ps = self.page_size
        for qpools, dpools, rows in ((self.k_qs, self.k_d, k), (self.v_qs, self.v_d, v)):
            for qpool, dpool, r in zip(qpools, dpools, rows):
                q, d = q8_quant(r[0])
                qpool[pages] = self._to_pages(q, ps)
                dpool[pages] = self._to_pages(d[..., None], ps).transpose(2, 3)


class PagedQ4KVCache(_PagedBase):
    """Q4_0 pages, a quarter of the bf16 page bytes: byte planes of row
    pairs [P, Hkv, ps/2, D] u8 and parity-major group scales
    [P, Hkv, 2G, ps/2] f32 (G = D/32), a page laid out as `Q4KVCache` lays
    out a slot. When both rows of a byte land in one packed step, each takes
    its sibling's code from the batch (same page, in-page row ^ 1)."""

    def __init__(self, k_qs, k_d, v_qs, v_d, tables):
        self.k_qs, self.k_d, self.v_qs, self.v_d, self.tables = k_qs, k_d, v_qs, v_d, tables

    @classmethod
    def create(cls, n_layers: int, n_pages: int, n_seqs: int, max_blocks: int,
               n_kv_heads: int, head_dim: int, page_size: int = 128,
               device="cpu") -> "PagedQ4KVCache":
        if page_size % 2:
            raise ValueError(f"paged q4_0: the page size ({page_size}) must be even")
        shape = (n_pages, n_kv_heads, page_size // 2, head_dim)
        dshape = (n_pages, n_kv_heads, 2 * q4_groups(head_dim), page_size // 2)

        def planes(shp, dt):
            return [torch.zeros(shp, dtype=dt, device=device) for _ in range(n_layers)]

        return cls(planes(shape, torch.uint8), planes(dshape, torch.float32),
                   planes(shape, torch.uint8), planes(dshape, torch.float32),
                   torch.full((n_seqs, max_blocks), n_pages, dtype=torch.int32, device=device))

    def _pools(self):
        return [self.k_qs, self.k_d, self.v_qs, self.v_d]

    @property
    def page_size(self) -> int:
        return self.k_qs[0].shape[2] * 2

    def write_packed(self, layer: int, k_new, v_new, slot_ids, rows) -> None:
        pages, rin, keep = self._targets(slot_ids, rows)
        sib = ((pages[:, None] == pages[None, :]) & ((rin[:, None] ^ 1) == rin[None, :])
               & keep[:, None] & keep[None, :])
        for qs, d, new in ((self.k_qs, self.k_d, k_new), (self.v_qs, self.v_d, v_new)):
            _nibble_rows({"qs": qs[layer], "d": d[layer]}, row_quant("q4_0", new), pages,
                         rin, keep, sib)

    def _deq(self, qpool, dpool, seq: int | None, dtype) -> torch.Tensor:
        """Pages through the tables → dense rows [B, Hkv, S, D] in `dtype`."""
        tables = self.tables if seq is None else self.tables[seq:seq + 1]
        safe = torch.clamp(tables.long(), max=self.n_pages - 1)
        out = q4_deq_plane(qpool[safe], dpool[safe], dtype)  # [B, nb, Hkv, ps, D]
        b, nb, hkv, ps, d = out.shape
        return out.transpose(1, 2).reshape(b, hkv, nb * ps, d)

    def layer(self, i: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Dequantized bf16 dense gather view [B, Hkv, S, D] (JAX's decode
        over these pages too: its flash_decode over this view)."""
        return (self._deq(self.k_qs[i], self.k_d[i], None, torch.bfloat16),
                self._deq(self.v_qs[i], self.v_d[i], None, torch.bfloat16))

    def gather_seq(self, seq: int, dtype=torch.bfloat16) -> tuple[torch.Tensor, torch.Tensor]:
        """One sequence's rows [L, 1, Hkv, S, D], dequantized into `dtype`."""
        return (torch.stack([self._deq(q, d, seq, dtype) for q, d in zip(self.k_qs, self.k_d)]),
                torch.stack([self._deq(q, d, seq, dtype) for q, d in zip(self.v_qs, self.v_d)]))

    def scatter_seq(self, seq: int, k: torch.Tensor, v: torch.Tensor) -> None:
        """Quantize [L, 1, Hkv, S, D] rows into the sequence's pages, in place."""
        pages = self._seq_pages(seq, k.shape[3])
        ps = self.page_size
        for qpools, dpools, rows in ((self.k_qs, self.k_d, k), (self.v_qs, self.v_d, v)):
            for qpool, dpool, r in zip(qpools, dpools, rows):
                q, d = q4_quant(r[0])  # [Hkv, S, D], [Hkv, S, G]
                qpool[pages] = self._to_pages(q4_pack_rows(q), ps // 2)
                dpool[pages] = rows_to_parity(self._to_pages(d, ps))


class PageAllocator:
    """Host-side page bookkeeping: free list + refcounts (shared-prefix
    pages are referenced by several sequences; freed when the last drops)."""

    def __init__(self, n_pages: int):
        self.n_pages = n_pages
        self.refs = np.zeros(n_pages, np.int32)
        self._free: list[int] = list(range(n_pages - 1, -1, -1))

    @property
    def n_free(self) -> int:
        return len(self._free)

    def alloc(self) -> int:
        if not self._free:
            raise MemoryError("paged KV: out of pages")
        pid = self._free.pop()
        self.refs[pid] = 1
        return pid

    def ref(self, pid: int) -> None:
        if self.refs[pid] <= 0:
            raise ValueError(f"paged KV: ref of free page {pid}")
        self.refs[pid] += 1

    def unref(self, pid: int) -> None:
        if self.refs[pid] <= 0:
            raise ValueError(f"paged KV: unref of free page {pid}")
        self.refs[pid] -= 1
        if self.refs[pid] == 0:
            self._free.append(pid)

    def is_shared(self, pid: int) -> bool:
        return self.refs[pid] > 1


class PagedSeq:
    """Host view of one sequence's block table."""

    def __init__(self, alloc: PageAllocator, max_blocks: int):
        self.alloc = alloc
        self.max_blocks = max_blocks
        self.pages: list[int] = []

    def table_row(self, n_pages_sentinel: int) -> np.ndarray:
        row = np.full(self.max_blocks, n_pages_sentinel, np.int32)
        row[: len(self.pages)] = self.pages
        return row

    def ensure(self, n_tokens: int, page_size: int) -> bool:
        """Allocate pages to cover n_tokens. Returns True if changed."""
        need = (n_tokens + page_size - 1) // page_size
        if need > self.max_blocks:
            raise MemoryError("paged KV: sequence exceeds max_blocks")
        changed = False
        while len(self.pages) < need:
            self.pages.append(self.alloc.alloc())
            changed = True
        return changed

    def share_prefix_from(self, donor: "PagedSeq", n_tokens: int, page_size: int) -> int:
        """Alias the donor's full pages covering n_tokens (refcounted).
        Returns the tokens shared (floored to a page boundary: the donor's
        partial page stays its own; copy-on-write covers the rest)."""
        self.release()
        n_full = min(n_tokens // page_size, len(donor.pages))
        for pid in donor.pages[:n_full]:
            self.alloc.ref(pid)
            self.pages.append(pid)
        return n_full * page_size

    def make_writable(self, block: int, cache: _PagedBase) -> bool:
        """Copy-on-write: if pages[block] is shared, copy it into a fresh
        page of `cache` (in place). Returns True if it copied."""
        pid = self.pages[block]
        if not self.alloc.is_shared(pid):
            return False
        new = self.alloc.alloc()
        cache.copy_page(pid, new)
        self.alloc.unref(pid)
        self.pages[block] = new
        return True

    def truncate(self, n_tokens: int, page_size: int) -> None:
        keep = (n_tokens + page_size - 1) // page_size
        while len(self.pages) > keep:
            self.alloc.unref(self.pages.pop())

    def release(self) -> None:
        for pid in self.pages:
            self.alloc.unref(pid)
        self.pages = []
