"""The port's Q4_0 KV cache (-ctk q4_0) and flash_decode_q4 (kernel B8's
plain version, CPU) against the JAX package's runtime/kv_cache.py and its
Pallas flash_decode_q4 in interpret mode.

The quantizer must be bit-exact (u8 codes and f32 scales, bf16 input
included), and so must every plane after the same writes: scalar writes at
even and odd offsets with odd and even T, per-slot writes with an idle
slot, and a packed step that carries both rows of a byte. The attention
tolerance is atol/rtol 1e-5 (f32 math in both; sums in another order), as
tests/test_quant_kv.py holds the JAX kernel to its dequantized reference.
The JAX writes run as one compiled program each, with XLA's algebraic
simplifier off (`op_by_op`): it would turn a division by a constant (a
q8_0, q4_1, q5_1 or iq4_nl scale: by 127, 15, 31, -127) into a
multiplication by the reciprocal, one ulp away from the op-by-op result
that JAX gives without jit and the port reproduces.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_cpp_dsp_tpu.ops.pallas.attention import flash_decode_q4 as jax_flash_decode_q4
from llama_cpp_dsp_tpu.runtime import kv_cache as jkv
from llama_cpp_dsp_tpu_torch.ops.kernels import LAUNCHES
from llama_cpp_dsp_tpu_torch.ops.kernels.attention import flash_decode_q4
from llama_cpp_dsp_tpu_torch.quant import kv_planes as pkp
from llama_cpp_dsp_tpu_torch.runtime import kv_cache as pkv
from torch_fixtures import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

B, HKV, S, D = 3, 2, 16, 64


def op_by_op(fn, *args):
    """fn(*args) compiled by XLA without its algebraic simplifier: JAX's
    op-by-op results, in one program (compiling each op alone costs more)."""
    return jax.jit(fn).lower(*args).compile({"xla_disable_hlo_passes": "algsimp"})(*args)


def _jax_write(cache, k, v, off):
    return op_by_op(lambda c, k, v, off: c.write(0, k, v, off), cache, k, v, off)


def _jax_write_packed(cache, k, v, sid, row):
    return op_by_op(lambda c, k, v, s, r: c.write_packed(0, k, v, s, r), cache, k, v, sid, row)


def np_of(a) -> np.ndarray:
    """A torch tensor or JAX array as numpy; bf16 widened to f32 (exact)."""
    if torch.is_tensor(a):
        return (a.float() if a.dtype == torch.bfloat16 else a).numpy()
    return np.asarray(a, np.float32 if a.dtype == jnp.bfloat16 else a.dtype)


def planes(cache) -> list:
    """Every buffer of a port or JAX contiguous cache, as numpy, in one
    order (a mixed cache's fields sorted by name, K then V)."""
    if hasattr(cache, "k_qs"):
        groups = [cache.k_qs, cache.k_d, cache.v_qs, cache.v_d]
    elif hasattr(cache, "k_arrs"):
        groups = [cache.k_arrs[k] for k in sorted(cache.k_arrs)]
        groups += [cache.v_arrs[k] for k in sorted(cache.v_arrs)]
    else:
        groups = [cache.k, cache.v]
    return [np_of(a) for g in groups for a in g]


def same_planes(port, theirs) -> None:
    got, want = planes(port), planes(theirs)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def run_writes(port, theirs, seed: int = 1):
    """The same writes into a port cache (in place) and a JAX cache; returns
    the JAX cache. Scalar writes at an even offset with odd T and at an odd
    offset with even T; per-slot writes with slot 1 idle (its
    offset is the capacity); a packed step with both rows of a byte (slot
    2, rows 4 and 5), a lone odd row and two padding rows (layer 0)."""
    rng = np.random.default_rng(seed)
    cap = port.capacity

    def rows(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    for off, t in ((2, 5), (7, 4)):
        k, v = rows(B, t, HKV, D), rows(B, t, HKV, D)
        port.write(0, torch.from_numpy(k), torch.from_numpy(v), off)
        theirs = _jax_write(theirs, jnp.asarray(k), jnp.asarray(v), off)
    off = np.array([13, cap, 0], np.int32)
    idle = [a[1].copy() for a in planes(port)]
    k, v = rows(B, 1, HKV, D), rows(B, 1, HKV, D)
    port.write(0, torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(off))
    theirs = _jax_write(theirs, jnp.asarray(k), jnp.asarray(v), jnp.asarray(off))
    for a, b in zip(planes(port), idle):
        np.testing.assert_array_equal(a[1], b)  # the idle slot's bytes and scales
    sid = np.array([0, 2, 2, 1, 0, 1], np.int32)
    row = np.array([9, 4, 5, 3, cap, cap], np.int32)
    k, v = rows(6, HKV, D), rows(6, HKV, D)
    port.write_packed(0, torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(sid),
                      torch.from_numpy(row))
    return _jax_write_packed(theirs, jnp.asarray(k), jnp.asarray(v), jnp.asarray(sid),
                             jnp.asarray(row))


def test_q4_quant_bit_exact_with_jax():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((4, 3, 6, 128)) * 3).astype(np.float32)
    x[0, 0, 0, :32] = 0.0  # an all-zero group: scale 0, every code 8
    x[1, 1, 1, :32] = 0.5
    x[1, 1, 1, 3], x[1, 1, 1, 9] = -4.0, 4.0  # a tie of |x|: the first decides the sign
    x[2, 2, 2, 32:64] = np.arange(-16, 16, dtype=np.float32) / 2  # exact halves after 1/d
    for dt_t, dt_j in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        q, d = pkp.q4_quant(torch.from_numpy(x).to(dt_t))
        jq, jd = jkv._q4_quant(jnp.asarray(x, dt_j))
        assert q.dtype == torch.uint8 and d.dtype == torch.float32
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    assert d[0, 0, 0, 0] == 0 and (q[0, 0, 0, :32] == 8).all()
    np.testing.assert_array_equal(  # row-pair packing and parity-major scales
        np_of(pkp.q4_deq_plane(pkp.q4_pack_rows(q), pkp.rows_to_parity(d))),
        np_of(jkv._q4_deq_plane(jkv._q4_pack_rows(jq), jkv._rows_to_parity(jd))))


def test_q4_cache_writes_match_jax():
    port = pkv.make_kv_cache(1, B, S, HKV, D, "q4_0")
    theirs = jkv.make_kv_cache(1, B, S, HKV, D, "q4_0")
    assert type(port).__name__ == type(theirs).__name__ == "Q4KVCache"
    assert port.k_qs[0].shape == (B, HKV, S // 2, D) and port.k_d[0].shape == (B, HKV, 4, S // 2)
    theirs = run_writes(port, theirs)
    same_planes(port, theirs)
    for a, b in zip(port.layer(0), theirs.layer(0)):
        np.testing.assert_array_equal(np_of(a), np_of(b))


@pytest.fixture(scope="module")
def b8_inputs():
    """q [3, 4, 128] over a Q4_0 cache of Hkv 2 and capacity 256 (one
    256-row chunk of the JAX kernel), quantized by JAX."""
    rng = np.random.default_rng(5)
    s, d = 256, 128
    q = rng.standard_normal((B, 4, d)).astype(np.float32)
    out = [q]
    for _ in range(2):  # K, then V
        codes, scales = jkv._q4_quant(jnp.asarray(rng.standard_normal((B, HKV, s, d)),
                                                  jnp.float32))
        out += [np.array(jkv._q4_pack_rows(codes)), np.array(jkv._rows_to_parity(scales))]
    return out


@pytest.mark.parametrize("case", ["ragged", "start-softcap"])
def test_flash_decode_q4_plain_matches_jax_interpret(b8_inputs, case):
    lengths = np.array([255, 37, 130], np.int32)  # odd and even, one short
    starts = np.array([0, 5, 101], np.int32) if case != "ragged" else None
    softcap = 50.0 if case != "ragged" else 0.0
    scale = 128 ** -0.5
    want = jax_flash_decode_q4(*(jnp.asarray(a) for a in b8_inputs), jnp.asarray(lengths),
                               None if starts is None else jnp.asarray(starts), scale=scale,
                               chunk=256, softcap=softcap, interpret=True)
    before = dict(LAUNCHES)
    got = flash_decode_q4(*(torch.from_numpy(a) for a in b8_inputs), torch.from_numpy(lengths),
                          None if starts is None else torch.from_numpy(starts), scale=scale,
                          softcap=softcap)
    assert LAUNCHES == before  # CPU tensors: the plain version
    assert got.shape == (B, 4, 128) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
