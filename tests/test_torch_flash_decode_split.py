"""The split-and-merge algebra of B2's cluster kernel
(llama_cpp_dsp_tpu_torch/csrc/flash_decode_gqa.cuh), emulated in PyTorch on
the CPU, against the JAX package's Pallas flash_decode in interpret mode.

The emulation follows the kernel's rules: a (kv head, slot) pair's valid
span [start, length) is cut into C parts of ceil(span / C) rows (a span
shorter than C leaves parts empty), unless it fits in one tile, which the
first part takes alone; a part walks its rows in tiles (64 rows of bf16 at
D = 128, 32 of f32), taking one max and one rescale per tile and head for
the whole GQA group; the C states (m, l, acc) merge by log-sum-exp,
skipping empty parts, and the output is acc / max(l, 1e-30).

Tolerance: atol/rtol 2e-5 with f32 K/V and 2e-3 with a bf16 cache, as in
tests/test_torch_flash_decode.py (f32 softmax in both; sums in another
order).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_cpp_dsp_tpu.ops.pallas.attention import flash_decode as jax_flash_decode
from torch_fixtures import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

D, S, HKV = 128, 320, 2
# slots: one row and a span of 5 (each within a tile: one part); 65 rows
# (16 parts of 5 leave three empty); the whole capacity (many tiles a part)
LENGTHS = (1, 5, 65, S)
# SWA starts inside a part (none lies on a tile or part boundary of the
# capacity)
STARTS = (0, 2, 37, 101)


def tile_rows(d: int, itemsize: int) -> int:
    """The kernel's rows a tile: 32 KB of K and V, 32 rows at least."""
    return max(32, 16384 // (d * itemsize))


def part_rows(start: int, length: int, c: int, tile: int) -> int:
    """Rows of each of the C parts: the whole span when it fits in a tile
    (the first part alone), else ceil(span / C)."""
    span = max(length - start, 0)
    return span if span <= tile else -(-span // c)


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
            ms = torch.stack([st[0] for st in states])  # [C, rep]
            mm = ms.amax(dim=0)
            w = torch.where(torch.isfinite(ms), torch.exp(ms - mm), torch.zeros_like(ms))
            w = torch.where(torch.isfinite(mm), w, torch.zeros_like(w))
            ll = (torch.stack([st[1] for st in states]) * w).sum(dim=0)
            aa = (torch.stack([st[2] for st in states]) * w[:, :, None]).sum(dim=0)
            out[bi, g * rep:(g + 1) * rep] = aa / ll.clamp_min(1e-30)[:, None]
    return out


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
@pytest.mark.parametrize("kv", ["f32", "bf16"])
def test_split_merge_matches_jax(c, rep, case, kv):
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
    ceil(span / C) rows each."""
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
