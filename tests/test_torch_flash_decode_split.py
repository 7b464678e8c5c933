"""The split-and-merge algebra of the cluster decode kernel
(llama_cpp_dsp_tpu_torch/csrc/flash_decode_gqa.cuh), emulated in PyTorch on
the CPU, against the JAX package's Pallas flash_decode (B2, dense rows) and
flash_decode_paged_q8 (B7, paged int8 rows) in interpret mode.

The emulation follows the kernel's rules: a (kv head, slot) pair's valid
span [start, length) is cut into C parts of ceil(span / C) rows (a span
shorter than C leaves parts empty), unless it fits in one tile, which the
first part takes alone; a part walks its rows in tiles (64 rows of bf16 at
D = 128, 32 of f32, 64 of int8), taking one max and one rescale per tile
and head for the whole GQA group; the C states (m, l, acc) merge by
log-sum-exp, skipping empty parts, and the output is acc / max(l, 1e-30).
B7's tiles do not line up with pages: each row finds its page through a
window of table entries (clamped to P − 1) that moves where a tile's pages
leave it; a score is (q·scale · codes)·kd[row], then the softcap, and the
value term (p·vd[row])·codes, l summing p.

Tolerance: atol/rtol 2e-5 with f32 K/V and with int8 rows (f32 math on
exact codes), 2e-3 with a bf16 cache, as in
tests/test_torch_flash_decode.py (f32 softmax in both; sums in another
order).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_cpp_dsp_tpu.ops.pallas.attention import flash_decode as jax_flash_decode
from llama_cpp_dsp_tpu.ops.pallas.attention import flash_decode_paged_q8 as jax_paged_q8
from llama_cpp_dsp_tpu_torch.quant.kv_planes import q8_quant
from torch_fixtures import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

D, S, HKV = 128, 320, 2
# slots: one row and a span of 5 (each within a tile: one part); 65 rows
# (16 parts of 5 leave three empty); the whole capacity (many tiles a part)
LENGTHS = (1, 5, 65, S)
# SWA starts inside a part (none lies on a tile or part boundary of the
# capacity)
STARTS = (0, 2, 37, 101)
PAGE_SIZES = (16, 128)  # B7: pages of 16 rows, and of 128 (S = 320 is no multiple)
TABLE_WINDOW = 256  # B7's table entries in shared memory


def tile_rows(d: int, itemsize: int) -> int:
    """The kernel's rows a tile: 32 KB of K and V, 32 rows at least; int8
    rows 64."""
    return 64 if itemsize == 1 else max(32, 16384 // (d * itemsize))


def part_rows(start: int, length: int, c: int, tile: int) -> int:
    """Rows of each of the C parts: the whole span when it fits in a tile
    (the first part alone), else ceil(span / C)."""
    span = max(length - start, 0)
    return span if span <= tile else -(-span // c)


def merge(states) -> torch.Tensor:
    """The C parts' (m [rep], l [rep], acc [rep, D]) merged by log-sum-exp,
    empty parts (m = −inf) weighing nothing → acc / max(l, 1e-30)."""
    ms = torch.stack([st[0] for st in states])  # [C, rep]
    mm = ms.amax(dim=0)
    w = torch.where(torch.isfinite(ms), torch.exp(ms - mm), torch.zeros_like(ms))
    w = torch.where(torch.isfinite(mm), w, torch.zeros_like(w))
    ll = (torch.stack([st[1] for st in states]) * w).sum(dim=0)
    aa = (torch.stack([st[2] for st in states]) * w[:, :, None]).sum(dim=0)
    return aa / ll.clamp_min(1e-30)[:, None]


def emulate(q, k, v, lengths, starts, *, scale: float, softcap: float, c: int):
    """B2's kernel algebra with C parts a (kv head, slot) pair; f32."""
    b, h, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    tile = tile_rows(d, k.element_size())
    rep = h // hkv
    out = torch.zeros(b, h, d)
    for bi in range(b):
        length = min(int(lengths[bi]), s)
        start = 0 if starts is None else max(int(starts[bi]), 0)
        part = part_rows(start, length, c, tile)
        for g in range(hkv):
            qg = q[bi, g * rep:(g + 1) * rep].float() * scale  # [rep, D]
            states = []
            for rank in range(c):
                lo = start + rank * part
                hi = min(lo + part, length)
                m = torch.full((rep,), float("-inf"))
                l = torch.zeros(rep)
                acc = torch.zeros(rep, d)
                for t0 in range(lo, hi, tile):
                    t1 = min(t0 + tile, hi)
                    sc = qg @ k[bi, g, t0:t1].float().T  # [rep, rows]
                    if softcap:
                        sc = torch.tanh(sc / softcap) * softcap
                    m_new = torch.maximum(m, sc.amax(dim=1))
                    p = torch.exp(sc - m_new[:, None])
                    alpha = torch.exp(m - m_new)
                    l = l * alpha + p.sum(dim=1)
                    acc = acc * alpha[:, None] + p @ v[bi, g, t0:t1].float()
                    m = m_new
                states.append((m, l, acc))
            out[bi, g * rep:(g + 1) * rep] = merge(states)
    return out


def page_walk(table_row, lo: int, hi: int, ps: int, n_pages: int, tile: int,
              tw: int = TABLE_WINDOW) -> list[tuple[int, int]]:
    """B7's (page, row in page) of each row of [lo, hi), tile by tile: the
    page ids of table entries [w0, w0 + tw) clamped to [0, P − 1], w0 = 0
    first and moved to a tile's first page where the tile's pages leave the
    window."""
    def window(w0):
        return [min(max(int(e), 0), n_pages - 1) for e in table_row[w0:w0 + tw]]

    w0, win, rows = 0, window(0), []
    for t0 in range(lo, hi, tile):
        t1 = min(t0 + tile, hi)
        if t0 // ps < w0 or (t1 - 1) // ps >= w0 + tw:
            w0 = t0 // ps
            win = window(w0)
        rows += [(win[r // ps - w0], r % ps) for r in range(t0, t1)]
    return rows


def emulate_paged_q8(q, kq, kd, vq, vd, tables, lengths, starts, *, scale: float,
                     softcap: float, c: int):
    """B7's kernel algebra with C parts a (kv head, slot) pair over int8
    pools [P, Hkv, ps, D] with row scales [P, Hkv, 1, ps]; f32."""
    b, h, d = q.shape
    n_pages, hkv, ps = kq.shape[:3]
    cap = tables.shape[1] * ps
    tile = tile_rows(d, 1)
    rep = h // hkv
    out = torch.zeros(b, h, d)
    for bi in range(b):
        length = min(int(lengths[bi]), cap)
        start = 0 if starts is None else max(int(starts[bi]), 0)
        part = part_rows(start, length, c, tile)
        for g in range(hkv):
            qg = q[bi, g * rep:(g + 1) * rep].float() * scale  # [rep, D]
            states = []
            for rank in range(c):
                lo = start + rank * part
                hi = min(lo + part, length)
                walk = page_walk(tables[bi].tolist(), lo, hi, ps, n_pages, tile)
                m = torch.full((rep,), float("-inf"))
                l = torch.zeros(rep)
                acc = torch.zeros(rep, d)
                for t0 in range(0, len(walk), tile):
                    pg = torch.tensor([p for p, _ in walk[t0:t0 + tile]])
                    off = torch.tensor([o for _, o in walk[t0:t0 + tile]])
                    sc = (qg @ kq[pg, g, off].float().T) * kd[pg, g, 0, off]  # [rep, rows]
                    if softcap:
                        sc = torch.tanh(sc / softcap) * softcap
                    m_new = torch.maximum(m, sc.amax(dim=1))
                    p = torch.exp(sc - m_new[:, None])
                    alpha = torch.exp(m - m_new)
                    l = l * alpha + p.sum(dim=1)
                    acc = (acc * alpha[:, None]
                           + (p * vd[pg, g, 0, off]) @ vq[pg, g, off].float())
                    m = m_new
                states.append((m, l, acc))
            out[bi, g * rep:(g + 1) * rep] = merge(states)
    return out


def _paged_table(ps: int, rng) -> tuple[np.ndarray, int]:
    """Block tables [B, ceil(S / ps)] over shuffled page ids, each slot's
    entries past its length ≥ P (P, and P + 3 once). Returns (tables, P)."""
    nb = -(-S // ps)
    need = [-(-n // ps) for n in LENGTHS]
    n_pages = sum(need)
    perm = rng.permutation(n_pages)
    tables = np.full((len(LENGTHS), nb), n_pages, np.int32)
    nxt = 0
    for bi, n in enumerate(need):
        tables[bi, :n] = perm[nxt:nxt + n]
        nxt += n
    tables[0, -1] = n_pages + 3
    return tables, n_pages


@functools.lru_cache(maxsize=None)
def _paged_inputs(rep: int, ps: int):
    """q, int8 pools and row scales (the port's own quantizer), tables."""
    rng = np.random.default_rng(40 + 3 * rep + ps)
    tables, n_pages = _paged_table(ps, rng)
    q = rng.standard_normal((len(LENGTHS), HKV * rep, D)).astype(np.float32)
    planes = []
    for _ in range(2):
        qs, dd = q8_quant(torch.from_numpy(
            rng.standard_normal((n_pages, HKV, ps, D)).astype(np.float32)))
        planes += [qs.numpy(), dd[:, :, None, :].numpy()]
    return q, *planes, tables


@functools.lru_cache(maxsize=None)
def _jax_paged_reference(rep: int, case: str, ps: int) -> np.ndarray:
    q, kq, kd, vq, vd, tables = _paged_inputs(rep, ps)
    starts = jnp.asarray(STARTS, jnp.int32) if case == "swa" else None
    return np.asarray(jax_paged_q8(
        jnp.asarray(q), jnp.asarray(kq), jnp.asarray(kd), jnp.asarray(vq), jnp.asarray(vd),
        jnp.asarray(tables), jnp.asarray(LENGTHS, jnp.int32), starts, scale=D ** -0.5,
        softcap=20.0 if case == "softcap" else 0.0, interpret=True))


def _inputs(rep: int):
    rng = np.random.default_rng(12 + rep)
    q = rng.standard_normal((len(LENGTHS), HKV * rep, D)).astype(np.float32)
    k = rng.standard_normal((len(LENGTHS), HKV, S, D)).astype(np.float32)
    v = rng.standard_normal((len(LENGTHS), HKV, S, D)).astype(np.float32)
    return q, k, v


@functools.lru_cache(maxsize=None)
def _jax_reference(rep: int, case: str, kv: str) -> np.ndarray:
    q, k, v = _inputs(rep)
    jdt = jnp.float32 if kv == "f32" else jnp.bfloat16
    starts = jnp.asarray(STARTS, jnp.int32) if case == "swa" else None
    return np.asarray(jax_flash_decode(
        jnp.asarray(q), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
        jnp.asarray(LENGTHS, jnp.int32), starts, scale=D ** -0.5,
        softcap=20.0 if case == "softcap" else 0.0, interpret=True))


@pytest.mark.parametrize("c", [1, 8, 16])
@pytest.mark.parametrize("rep", [1, 4, 7])
@pytest.mark.parametrize("case", ["ragged", "swa", "softcap"])
@pytest.mark.parametrize("kv", ["f32", "bf16", "paged_q8"])
def test_split_merge_matches_jax(c, rep, case, kv):
    if kv == "paged_q8":
        for ps in PAGE_SIZES:
            q, kq, kd, vq, vd, tables = map(torch.from_numpy, _paged_inputs(rep, ps))
            got = emulate_paged_q8(q, kq, kd, vq, vd, tables, torch.tensor(LENGTHS),
                                   torch.tensor(STARTS) if case == "swa" else None,
                                   scale=D ** -0.5, softcap=20.0 if case == "softcap" else 0.0,
                                   c=c)
            np.testing.assert_allclose(got.numpy(), _jax_paged_reference(rep, case, ps),
                                       rtol=2e-5, atol=2e-5, err_msg=f"ps={ps}")
        return
    q, k, v = _inputs(rep)
    tdt = torch.float32 if kv == "f32" else torch.bfloat16
    got = emulate(torch.from_numpy(q), torch.from_numpy(k).to(tdt), torch.from_numpy(v).to(tdt),
                  torch.tensor(LENGTHS), torch.tensor(STARTS) if case == "swa" else None,
                  scale=D ** -0.5, softcap=20.0 if case == "softcap" else 0.0, c=c)
    tol = 2e-5 if kv == "f32" else 2e-3
    np.testing.assert_allclose(got.numpy(), _jax_reference(rep, case, kv), rtol=tol, atol=tol)


def test_parts_cover_the_span_once():
    """The kernel's cut: every row of [start, length) in exactly one part,
    no row outside it; a span of more than a tile takes every part, at most
    ceil(span / C) rows each. B7's page walk over those parts: every valid
    row read exactly once, through its own page (a table entry ≥ P clamped
    to P − 1), by int8 tiles of 64 rows, with the whole table in the window
    and with the least window a tile fits in, which has to move."""
    for c in (1, 8, 16):
        for start, length in ((0, 1), (2, 5), (0, 64), (0, 65), (0, 3000), (2048, 4096),
                              (7, 7), (9, 4)):
            part = part_rows(start, length, c, 64)
            parts = [range(start + rank * part, min(start + (rank + 1) * part, length))
                     for rank in range(c)]
            assert [r for p in parts for r in p] == list(range(start, length))
            if length - start > 64:
                assert all(len(p) in (part, len(parts[-1])) for p in parts[:-1])
                assert part == -(-(length - start) // c)
    rng = np.random.default_rng(7)
    cap = 4096
    for ps in (1, 16, 50, 128):
        nb = -(-cap // ps)
        n_pages = nb + 5
        table = rng.permutation(n_pages)[:nb].tolist()
        table[-1] = n_pages + 7  # ≥ P: clamped to P − 1
        for c in (1, 8, 16):
            for start, length in ((0, 1), (2, 5), (0, 65), (37, 3000), (2048, 4096), (9, 4)):
                want = [(min(table[r // ps], n_pages - 1), r % ps)
                        for r in range(start, length)]
                part = part_rows(start, length, c, 64)
                for tw in (TABLE_WINDOW, 64 // ps + 2):
                    got = [row for rank in range(c)
                           for row in page_walk(table, start + rank * part,
                                                min(start + (rank + 1) * part, length), ps,
                                                n_pages, 64, tw)]
                    assert got == want, (ps, c, start, length, tw)
