"""The port's Q8_0 KV cache and flash_decode_q8 (plain version, CPU) against
the JAX package's runtime/kv_cache.py and its Pallas flash_decode_q8 in
interpret mode.

The quantizer must be bit-exact (int8 values and f32 scales), and so must
every cache write built on it. The attention tolerance is atol/rtol 1e-5
(f32 math in both; sums in another order), as tests/test_quant_kv.py holds
the JAX kernel to its dequantized reference.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_cpp_dsp_tpu.ops.pallas.attention import flash_decode_q8 as jax_flash_decode_q8
from llama_cpp_dsp_tpu.runtime import kv_cache as jkv
from llama_cpp_dsp_tpu_torch.ops.kernels import LAUNCHES
from llama_cpp_dsp_tpu_torch.ops.kernels.attention import flash_decode_q8
from llama_cpp_dsp_tpu_torch.quant.kv_planes import q8_dequant, q8_quant
from llama_cpp_dsp_tpu_torch.runtime.kv_cache import KVCache, QuantKVCache, make_kv_cache
from torch_fixtures import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

L, B, HKV, S, D = 2, 3, 2, 16, 32


def _np(a) -> np.ndarray:
    """A torch tensor or JAX array as numpy; bf16 widened to f32 (exact)."""
    if torch.is_tensor(a):
        return (a.float() if a.dtype == torch.bfloat16 else a).numpy()
    return np.asarray(a, np.float32 if a.dtype == jnp.bfloat16 else a.dtype)


def _planes(cache):
    """Every array of a port or JAX cache, as numpy, in one order."""
    if isinstance(cache, (QuantKVCache, jkv.QuantKVCache)):
        groups = (cache.k_qs, cache.k_d, cache.v_qs, cache.v_d)
    else:
        groups = (cache.k, cache.v)
    return [_np(a) for g in groups for a in g]


def _same(port, jax_cache):
    for a, b in zip(_planes(port), _planes(jax_cache), strict=True):
        np.testing.assert_array_equal(a, b)


def test_q8_quant_bit_exact_with_jax():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((4, 3, 7, 128)) * 3).astype(np.float32)
    x[0, 0, 0] = 0.0  # an all-zero row: scale 0, values 0
    # exact halves after scaling exercise round-half-to-even
    x[1, 1, 1, :4] = np.array([127.0, 0.5, 1.5, -2.5], np.float32)
    for dt_t, dt_j in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        qs, d = q8_quant(torch.from_numpy(x).to(dt_t))
        jqs, jd = jkv._q8_quant(jnp.asarray(x, dt_j))
        assert qs.dtype == torch.int8 and d.dtype == torch.float32
        np.testing.assert_array_equal(qs.numpy(), np.asarray(jqs))
        np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(
            q8_dequant(qs, d, torch.float32).numpy(),
            np.asarray(jkv._q8_dequant(jqs, jd, jnp.float32)))


@pytest.mark.parametrize("kind", ["bf16", "q8_0"])
def test_cache_writes_match_jax(kind):
    rng = np.random.default_rng(1)
    port = make_kv_cache(L, B, S, HKV, D, kind)
    theirs = jkv.make_kv_cache(L, B, S, HKV, D, kind)
    assert isinstance(port, QuantKVCache if kind == "q8_0" else KVCache)
    assert type(port).__name__ == type(theirs).__name__

    def rows(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    for layer in range(L):
        # scalar offset: a 5-row prompt chunk for the whole batch
        k, v = rows(B, 5, HKV, D), rows(B, 5, HKV, D)
        port.write(layer, torch.from_numpy(k), torch.from_numpy(v), 2)
        theirs = theirs.write(layer, jnp.asarray(k), jnp.asarray(v), 2)
        # vector offsets: batched decode, slot 1 idle at `capacity` (dropped)
        off = np.array([7, S, 15], np.int32)
        k, v = rows(B, 1, HKV, D), rows(B, 1, HKV, D)
        port.write(layer, torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(off))
        theirs = theirs.write(layer, jnp.asarray(k), jnp.asarray(v), jnp.asarray(off))
        # packed rows of a mixed ubatch; the last two are padding (capacity)
        sid = np.array([0, 2, 2, 1, 0, 1], np.int32)
        row = np.array([9, 0, 1, 3, S, S], np.int32)
        k, v = rows(6, HKV, D), rows(6, HKV, D)
        port.write_packed(layer, torch.from_numpy(k), torch.from_numpy(v),
                          torch.from_numpy(sid), torch.from_numpy(row))
        theirs = theirs.write_packed(layer, jnp.asarray(k), jnp.asarray(v), jnp.asarray(sid),
                                     jnp.asarray(row))
    _same(port, theirs)
    # the idle slot's rows at and past its last write stay zero
    assert not _planes(port)[0][1, :, 7:].any()
    for i in range(L):
        for a, b in zip(port.layer(i), theirs.layer(i)):
            np.testing.assert_array_equal(a.float().numpy(), np.asarray(b, np.float32))


def test_slot_view_writes_through():
    """Per-slot prefill writes through the slot's narrow view, as JAX's
    slot_view + merge_slot does."""
    rng = np.random.default_rng(2)
    for kind in ("bf16", "q8_0"):
        port = make_kv_cache(L, B, S, HKV, D, kind)
        theirs = jkv.make_kv_cache(L, B, S, HKV, D, kind)
        k = rng.standard_normal((1, 4, HKV, D)).astype(np.float32)
        port.slot(2).write(1, torch.from_numpy(k), torch.from_numpy(k), 3)
        sub = theirs.slot_view(jnp.int32(2)).write(1, jnp.asarray(k), jnp.asarray(k), 3)
        _same(port, theirs.merge_slot(sub, jnp.int32(2)))


def test_other_kv_types_raise():
    """A type outside the reference's -ctk / -ctv set is refused, as JAX's
    make_kv_cache refuses it (every type of the set is accepted: see
    tests/test_torch_mixed_kv.py)."""
    with pytest.raises(ValueError, match="unknown KV plane format 'q2_k'"):
        make_kv_cache(L, B, S, HKV, D, "q2_k")
    with pytest.raises(ValueError, match="unknown KV plane format 'q3_k'"):
        make_kv_cache(L, B, S, HKV, D, "q8_0", v_type="q3_k")
    with pytest.raises(KeyError):
        jkv.make_kv_cache(L, B, S, HKV, D, "q2_k")
    with pytest.raises(ValueError, match="unknown KV plane format 'q3_k'"):
        jkv.make_kv_cache(L, B, S, HKV, D, "q8_0", v_type="q3_k")


@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)])
@pytest.mark.parametrize("case", ["ragged", "swa", "softcap"])
def test_flash_decode_q8_matches_jax(hq, hkv, case):
    rng = np.random.default_rng(3)
    b, s, d = 3, 256, 128
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    kq, kd = jkv._q8_quant(jnp.asarray(k))
    vq, vd = jkv._q8_quant(jnp.asarray(v))
    lengths = np.array([1, s // 2 + 3, s], np.int32)
    starts = np.array([0, 40, 200], np.int32) if case == "swa" else None
    softcap = 20.0 if case == "softcap" else 0.0
    scale = 1.0 / np.sqrt(d)
    want = jax_flash_decode_q8(jnp.asarray(q), kq, kd[:, :, None], vq, vd[:, :, None],
                               jnp.asarray(lengths),
                               None if starts is None else jnp.asarray(starts),
                               scale=scale, softcap=softcap, chunk=128, interpret=True)
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    before = dict(LAUNCHES)
    got = flash_decode_q8(t(q), t(kq), t(kd)[:, :, None], t(vq), t(vd)[:, :, None],
                          t(lengths), None if starts is None else t(starts), scale=scale,
                          softcap=softcap)
    assert LAUNCHES == before
    assert got.dtype == torch.float32 and got.shape == (b, hq, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
