"""Paged KV caches with shared-prefix page aliasing (counterpart of the JAX
package's runtime/paged_kv.py: `PagedKVCache`, `PagedQuantKVCache`,
`PageAllocator`, `PagedSeq`).

K/V live in per-layer page pools [P, Hkv, page_size, D]; each sequence owns
a block table of page ids ([B, max_blocks] int32 on the device, `P` marks an
unmapped block). Shared prompt prefixes alias the same pages with host-side
refcounts and copy-on-write. Writes route through the tables in place; a row
whose block is unmapped, or a padding row (== capacity), is dropped. Decode
attention reads the pages directly (ops/kernels/attention.py
`flash_decode_paged`, `flash_decode_paged_q8`); `layer` gathers a dense view
for the plain attention of prompt chunks. The Q4_0 paged cache waits with
kernel B8 (ROADMAP.md queue B).
"""

from __future__ import annotations

import numpy as np
import torch

from .kv_cache import _drop_scatter, _q8_dequant, _q8_quant


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

    def _gather(self, pool: torch.Tensor) -> torch.Tensor:
        """Pool [P, Hkv, ps, X] → per-sequence dense [B, Hkv, max_blocks*ps, X]
        (unmapped blocks read the last page, as JAX clamps them)."""
        g = pool[torch.clamp(self.tables.long(), max=self.n_pages - 1)]  # [B, nb, Hkv, ps, X]
        b, nb, hkv, ps = g.shape[:4]
        return g.transpose(1, 2).reshape(b, hkv, nb * ps, *g.shape[4:])


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
        kq, kd = _q8_quant(k_new)
        vq, vd = _q8_quant(v_new)
        _drop_scatter(((self.k_qs[layer], kq), (self.k_d[layer][:, :, 0], kd),
                       (self.v_qs[layer], vq), (self.v_d[layer][:, :, 0], vd)),
                      pages, rin, keep)

    def layer(self, i: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Dequantized bf16 dense gather view [B, Hkv, S, D]."""
        return (_q8_dequant(self._gather(self.k_qs[i]), self._gather(self.k_d[i][:, :, 0]),
                            torch.bfloat16),
                _q8_dequant(self._gather(self.v_qs[i]), self._gather(self.v_d[i][:, :, 0]),
                            torch.bfloat16))

    def packed_pages(self, i: int):
        """(k_qs, k_d, v_qs, v_d) page pools for the paged q8 kernel."""
        return self.k_qs[i], self.k_d[i], self.v_qs[i], self.v_d[i]


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
