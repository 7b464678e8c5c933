"""The port's paged KV caches, page bookkeeping and paged decode attention
(plain versions, CPU) against the JAX package's runtime/paged_kv.py and its
Pallas flash_decode_paged / flash_decode_paged_q8 in interpret mode.

Cache writes (bf16, f16, f32, Q8_0 and Q4_0 pools), gathers, one
sequence's gather and scatter, tables and refcounts must be identical; attention
agrees within atol/rtol 1e-5 (f32 math in both, sums in another order), as
tests/test_paged_kv.py holds the JAX kernels to their dense twins.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_cpp_dsp_tpu.ops.pallas import attention as jatt
from llama_cpp_dsp_tpu.runtime import paged_kv as jpk
from llama_cpp_dsp_tpu_torch.ops.kernels import LAUNCHES
from llama_cpp_dsp_tpu_torch.ops.kernels.attention import (
    flash_decode_paged, flash_decode_paged_q8)
from llama_cpp_dsp_tpu_torch.runtime.paged_kv import (
    PageAllocator, PagedKVCache, PagedQ4KVCache, PagedQuantKVCache, PagedSeq)
from torch_fixtures import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

L, HKV, PS, D = 2, 2, 8, 32
N_PAGES, N_SEQS, MAX_BLOCKS = 16, 3, 4


def _np(a) -> np.ndarray:
    if torch.is_tensor(a):
        return a.float().numpy() if a.dtype == torch.bfloat16 else a.numpy()
    return np.asarray(a, np.float32 if a.dtype == jnp.bfloat16 else a.dtype)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


class _Jax:
    """The JAX side's in-place face: set_table_row and writes rebind."""

    def __init__(self, cache):
        self.cache = cache

    def set_table_row(self, s, row):
        self.cache = self.cache.set_table_row(s, row)

    def write_packed(self, layer, k, v, sid, rows):
        self.cache = self.cache.write_packed(layer, jnp.asarray(k), jnp.asarray(v),
                                             jnp.asarray(sid), jnp.asarray(rows))


def _fill(seed, lens, q8: bool, *, jax: bool, ps=PS, max_blocks=MAX_BLOCKS, n_pages=N_PAGES):
    """Per-sequence rows made from `seed` into a paged cache of the port or
    of JAX (the fill of tests/test_paged_kv.py). Returns (alloc, seqs, cache)."""
    rng = np.random.default_rng(seed)
    alloc = (jpk.PageAllocator if jax else PageAllocator)(n_pages)
    seqs = [(jpk.PagedSeq if jax else PagedSeq)(alloc, max_blocks) for _ in lens]
    args = (L, n_pages, len(lens), max_blocks, HKV, D)
    if q8:
        cache = (jpk.PagedQuantKVCache if jax else PagedQuantKVCache).create(*args, page_size=ps)
    elif jax:
        cache = jpk.PagedKVCache.create(*args, page_size=ps, dtype=jnp.float32)
    else:
        cache = PagedKVCache.create(*args, page_size=ps, dtype=torch.float32)
    dst = _Jax(cache) if jax else cache
    for s, n in enumerate(lens):
        if seqs[s].ensure(n, ps):
            dst.set_table_row(s, seqs[s].table_row(n_pages))
        k = rng.standard_normal((L, n, HKV, D)).astype(np.float32)
        v = rng.standard_normal((L, n, HKV, D)).astype(np.float32)
        rows, sid = np.arange(n, dtype=np.int32), np.full(n, s, np.int32)
        for layer in range(L):
            if jax:
                dst.write_packed(layer, k[layer], v[layer], sid, rows)
            else:
                dst.write_packed(layer, _t(k[layer]), _t(v[layer]), _t(sid), _t(rows))
    return alloc, seqs, (dst.cache if jax else dst)


def _same_cache(port, jax_cache):
    np.testing.assert_array_equal(_np(port.tables), _np(jax_cache.tables))
    for i in range(L):
        for a, b in zip(port.layer(i), jax_cache.layer(i), strict=True):
            np.testing.assert_array_equal(_np(a), _np(b))


@pytest.mark.parametrize("q8", [False, True], ids=["bf16", "q8_0"])
def test_paged_writes_and_gathers_match_jax(q8):
    rng = np.random.default_rng(10)
    _, _, port = _fill(0, [5, 13, 20], q8, jax=False)
    _, _, theirs = _fill(0, [5, 13, 20], q8, jax=True)
    _same_cache(port, theirs)
    # batched decode through write(): slot 1 idle at capacity (dropped), and
    # a scalar-offset write over every slot
    k = rng.standard_normal((N_SEQS, 1, HKV, D)).astype(np.float32)
    off = np.array([5, port.capacity, 20], np.int32)
    port.write(1, _t(k), _t(k), _t(off))
    theirs = theirs.write(1, jnp.asarray(k), jnp.asarray(k), jnp.asarray(off))
    port.write(0, _t(k), _t(k), 3)
    theirs = theirs.write(0, jnp.asarray(k), jnp.asarray(k), 3)
    _same_cache(port, theirs)
    if q8:
        for a, b in zip(port.packed_pages(1), theirs.packed_pages(1), strict=True):
            np.testing.assert_array_equal(_np(a), _np(b))


def test_allocator_script_matches_jax():
    """One scripted sequence of ensure / share_prefix_from / make_writable /
    truncate / release leaves the same tables, pages and refcounts."""
    ours = _fill(1, [20, 0, 0], q8=False, jax=False)
    theirs = _fill(1, [20, 0, 0], q8=False, jax=True)
    states = []
    for side, (alloc, seqs, cache) in (("port", ours), ("jax", theirs)):
        log = []
        shared = seqs[1].share_prefix_from(seqs[0], 20, PS)
        log.append(("shared", shared, list(seqs[1].pages)))
        seqs[1].ensure(27, PS)
        copied = []
        for blk in range(len(seqs[1].pages)):
            if side == "jax":
                cache, c = seqs[1].make_writable(blk, cache)
            else:
                c = seqs[1].make_writable(blk, cache)
            copied.append(c)
        log.append(("cow", copied, list(seqs[1].pages)))
        seqs[2].share_prefix_from(seqs[1], 24, PS)
        seqs[0].truncate(9, PS)
        log.append(("truncate", list(seqs[0].pages), alloc.refs.tolist(), alloc.n_free))
        for s, seq in enumerate(seqs):
            row = seq.table_row(N_PAGES)
            if side == "jax":
                cache = cache.set_table_row(s, row)
            else:
                cache.set_table_row(s, row)
        seqs[1].release()
        log.append(("release", alloc.refs.tolist(), alloc.n_free, [list(q.pages) for q in seqs]))
        states.append((log, cache))
    (log_p, port), (log_j, jcache) = states
    assert log_p == log_j
    assert log_p[1][1] == [True, True, False, False][:len(log_p[1][1])]
    _same_cache(port, jcache)


@pytest.mark.parametrize("hq", [4, 8])
@pytest.mark.parametrize("case", ["ragged", "swa", "softcap"])
def test_flash_decode_paged_matches_jax(hq, case):
    """At the shapes of tests/test_paged_kv.py:63-74 (pages of 8 rows)."""
    rng = np.random.default_rng(12)
    lens = [7, 17, 29]
    _, _, port = _fill(2, lens, q8=False, jax=False)
    _, _, theirs = _fill(2, lens, q8=False, jax=True)
    q = rng.standard_normal((N_SEQS, hq, D)).astype(np.float32)
    lengths = np.asarray(lens, np.int32)
    starts = np.array([0, 5, 20], np.int32) if case == "swa" else None
    softcap = 20.0 if case == "softcap" else 0.0
    want = jatt.flash_decode_paged(jnp.asarray(q), theirs.k[0], theirs.v[0], theirs.tables,
                                   jnp.asarray(lengths),
                                   None if starts is None else jnp.asarray(starts),
                                   scale=0.2, softcap=softcap, interpret=True)
    before = dict(LAUNCHES)
    got = flash_decode_paged(_t(q), port.k[0], port.v[0], port.tables, _t(lengths),
                             None if starts is None else _t(starts), scale=0.2,
                             softcap=softcap)
    assert LAUNCHES == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("hq", [4, 8])
@pytest.mark.parametrize("case", ["ragged", "swa", "softcap"])
def test_flash_decode_paged_q8_matches_jax(hq, case):
    """At the shapes of tests/test_paged_kv.py:196-212 (pages of 128 rows)."""
    rng = np.random.default_rng(13)
    lens = [70, 150, 250]
    geometry = dict(ps=128, max_blocks=2, n_pages=8)
    _, _, port = _fill(3, lens, q8=True, jax=False, **geometry)
    _, _, theirs = _fill(3, lens, q8=True, jax=True, **geometry)
    q = rng.standard_normal((N_SEQS, hq, D)).astype(np.float32)
    lengths = np.asarray(lens, np.int32)
    starts = np.array([0, 40, 200], np.int32) if case == "swa" else None
    softcap = 20.0 if case == "softcap" else 0.0
    want = jatt.flash_decode_paged_q8(jnp.asarray(q), *theirs.packed_pages(0), theirs.tables,
                                      jnp.asarray(lengths),
                                      None if starts is None else jnp.asarray(starts),
                                      scale=0.2, softcap=softcap, interpret=True)
    before = dict(LAUNCHES)
    got = flash_decode_paged_q8(_t(q), *port.packed_pages(0), port.tables, _t(lengths),
                                None if starts is None else _t(starts), scale=0.2,
                                softcap=softcap)
    assert LAUNCHES == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_paged_q8_matches_dense_q8_in_the_port():
    """Paged q8 rows gather to the same dequantized rows as the contiguous
    q8 cache fed the same packed writes."""
    from llama_cpp_dsp_tpu_torch.runtime.kv_cache import QuantKVCache

    lens = [5, 13, 20]
    _, _, port = _fill(4, lens, q8=True, jax=False)
    dense = QuantKVCache.create(L, N_SEQS, MAX_BLOCKS * PS, HKV, D)
    rng = np.random.default_rng(4)
    for s, n in enumerate(lens):
        k = rng.standard_normal((L, n, HKV, D)).astype(np.float32)
        v = rng.standard_normal((L, n, HKV, D)).astype(np.float32)
        for layer in range(L):
            dense.write_packed(layer, _t(k[layer]), _t(v[layer]),
                               torch.full((n,), s, dtype=torch.int32),
                               torch.arange(n, dtype=torch.int32))
    for layer in range(L):
        for a, b in zip(port.layer(layer), dense.layer(layer)):
            for s, n in enumerate(lens):
                assert torch.equal(a[s, :, :n], b[s, :, :n])


def _op_by_op(fn, *args):
    """fn(*args) compiled by XLA without its algebraic simplifier, which would
    turn a Q8_0 scale's division by 127 into a multiplication by 1/127: JAX's
    op-by-op results in one program (compiling each op alone costs more)."""
    return jax.jit(fn).lower(*args).compile({"xla_disable_hlo_passes": "algsimp"})(*args)


def _pools(cache) -> list:
    groups = ([cache.k_qs, cache.k_d, cache.v_qs, cache.v_d] if hasattr(cache, "k_qs")
              else [cache.k, cache.v])
    return [_np(a) for g in groups for a in g]


@pytest.mark.parametrize("kind", ["f16", "q8_0", "q4_0"])
def test_pools_writes_and_seq_surgery_match_jax(kind):
    """Every pool of the f16, Q8_0 and Q4_0 paged caches is bit-equal to
    JAX's after a scalar write, a per-slot write (slot 1 idle) and a packed
    step (both rows of a Q4_0 byte on one page, a row of an unmapped block,
    padding); then scatter_seq into one sequence and gather_seq of each
    agree with JAX's."""
    rng = np.random.default_rng(12)
    n_pages, nb, ps, d = 7, 3, 4, 64
    args = (1, n_pages, 3, nb, HKV, d)
    if kind == "f16":
        port = PagedKVCache.create(*args, page_size=ps, dtype=torch.float16)
        theirs = jpk.PagedKVCache.create(*args, page_size=ps, dtype=jnp.float16)
    else:
        port = (PagedQuantKVCache if kind == "q8_0" else PagedQ4KVCache).create(*args,
                                                                                page_size=ps)
        theirs = (jpk.PagedQuantKVCache if kind == "q8_0" else jpk.PagedQ4KVCache).create(
            *args, page_size=ps)
    for s, row in enumerate(([2, 0, 7], [5, 1, 3], [4, 6, 7])):  # 7: unmapped
        port.set_table_row(s, np.array(row, np.int32))
        theirs = theirs.set_table_row(s, np.array(row, np.int32))
    writes = (  # (k rows, v rows, offset), then a packed step's (k, v, slots, rows)
        (rng.standard_normal((3, 5, HKV, d)).astype(np.float32), None, 1),
        (rng.standard_normal((3, 1, HKV, d)).astype(np.float32), None,
         np.array([6, nb * ps, 7], np.int32)))
    for k, _, off in writes:
        port.write(0, _t(k), _t(-k), _t(off) if isinstance(off, np.ndarray) else off)
        theirs = _op_by_op(lambda c, k, v, o: c.write(0, k, v, o), theirs, jnp.asarray(k),
                           jnp.asarray(-k), jnp.asarray(off))
    k = rng.standard_normal((6, HKV, d)).astype(np.float32)
    sid, rows = np.array([0, 0, 2, 1, 1, 0], np.int32), np.array([6, 7, 8, 9, nb * ps, 2],
                                                                   np.int32)
    port.write_packed(0, _t(k), _t(k + 1), _t(sid), _t(rows))
    theirs = _op_by_op(lambda c, k, v, s, r: c.write_packed(0, k, v, s, r), theirs,
                       jnp.asarray(k), jnp.asarray(k + 1), jnp.asarray(sid), jnp.asarray(rows))
    for a, b in zip(_pools(port), _pools(theirs), strict=True):
        np.testing.assert_array_equal(a, b)
    k = rng.standard_normal((1, 1, HKV, 2 * ps, d)).astype(np.float32)
    port.scatter_seq(1, _t(k), _t(k / 2))
    theirs = _op_by_op(lambda c, k, v: c.scatter_seq(1, k, v), theirs, jnp.asarray(k),
                       jnp.asarray(k / 2))
    for a, b in zip(_pools(port), _pools(theirs), strict=True):
        np.testing.assert_array_equal(a, b)
    gathered = _op_by_op(lambda c: [c.gather_seq(s) for s in range(3)], theirs)
    for seq, want in enumerate(gathered):
        for a, b in zip(port.gather_seq(seq), want, strict=True):
            np.testing.assert_array_equal(_np(a), _np(b))
