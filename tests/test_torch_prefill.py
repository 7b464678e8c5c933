"""The port's causal prefill attention (B4, `flash_prefill`) and its decode
attention at head_dim 256, plain versions on the CPU, against the JAX
package's Pallas kernels in interpret mode.

- `flash_prefill_plain` against JAX `flash_prefill(..., interpret=True)`
  (as tests/test_flash_attention.py runs it): D 128 and 256, GQA, MHA and
  MQA, n_past 0 and > 0 (two slots at different offsets), 1e30 in the rows
  at or past n_past + T, softcap, a sliding window and chunked attention,
  f32 and bf16 caches. Tolerance atol/rtol 2e-5 (JAX's own for this kernel:
  f32 math in both, sums in another order).
- `flash_decode`, `flash_decode_q8`, `flash_decode_q4`, `flash_decode_paged`
  and `flash_decode_paged_q8` at D = 256 with SWA starts and a softcap,
  against the JAX entries of the same names; tolerances as
  tests/test_torch_flash_decode.py (2e-5 f32 rows, 2e-3 bf16) and
  tests/test_torch_q4_kv.py / test_torch_paged_kv.py (1e-5).
- The numeric design of B4's tensor-core kernel (q and p split into two
  bf16 terms each) emulated on the CPU against `flash_prefill_plain`.
- On CPU tensors every wrapper takes its plain version (no launch counted).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_cpp_dsp_tpu.ops.pallas import attention as jatt
from llama_cpp_dsp_tpu.runtime import kv_cache as jkv
from llama_cpp_dsp_tpu_torch.ops.kernels import LAUNCHES
from llama_cpp_dsp_tpu_torch.ops.kernels import attention as ka
from torch_fixtures import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

STALE = 1e30


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


# (H, Hkv, D, T, S, n_past per slot, softcap, window, chunk, cache)
PREFILL_CASES = {
    "gqa-fresh": (8, 2, 128, 16, 256, (0, 0), 0.0, 0, 0, "f32"),
    "mha-d256-continued": (4, 4, 256, 24, 512, (100, 100), 0.0, 0, 0, "f32"),
    "mqa": (8, 1, 128, 8, 128, (64, 64), 0.0, 0, 0, "f32"),
    "two-offsets-bf16": (4, 2, 256, 16, 128, (0, 37), 0.0, 0, 0, "bf16"),
    "swa-softcap-d256": (4, 2, 256, 32, 256, (40, 40), 30.0, 24, 0, "f32"),
    "swa-mqa-d256": (8, 1, 256, 16, 128, (0, 20), 0.0, 8, 0, "f32"),
    "chunked": (4, 2, 128, 32, 256, (40, 40), 0.0, 0, 64, "f32"),
}


@pytest.mark.parametrize("case", list(PREFILL_CASES))
def test_flash_prefill_plain_matches_jax_interpret(case):
    hq, hkv, d, t, s, n_past, softcap, window, chunk, kv = PREFILL_CASES[case]
    rng = np.random.default_rng(3)
    b = len(n_past)
    q = rng.standard_normal((b, t, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    for i, npb in enumerate(n_past):  # rows past each slot's prompt are stale
        k[i, :, npb + t:] = STALE
        v[i, :, npb + t:] = STALE
    np_ = np.asarray(n_past, np.int32)
    jdt, tdt = (jnp.float32, torch.float32) if kv == "f32" else (jnp.bfloat16, torch.bfloat16)
    kw = dict(scale=1.0 / np.sqrt(d), softcap=softcap, swa_window=window, attn_chunk=chunk)
    want = jatt.flash_prefill(jnp.asarray(q), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
                              jnp.asarray(np_), chunk=64, tile_q=8, interpret=True, **kw)
    before = dict(LAUNCHES)
    got = ka.flash_prefill(_t(q), _t(k).to(tdt), _t(v).to(tdt), _t(np_), **kw)
    assert LAUNCHES == before  # CPU tensors: the plain version
    assert got.dtype == torch.float32 and got.shape == (b, t, hq, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


def test_flash_prefill_rules():
    """The rules the kernel and the model share (`causal_mask` with a window
    or a chunk): each query's visible rows, counted."""
    from llama_cpp_dsp_tpu_torch.runtime.kv_cache import causal_mask

    pos = torch.arange(10, 20, dtype=torch.int32)[None]  # n_past 10, T 10
    full = causal_mask(pos, 32, 10)
    swa = causal_mask(pos, 32, 10, window=4)
    chunked = causal_mask(pos, 32, 10, chunk=8)
    assert full[0].sum(-1).tolist() == list(range(11, 21))
    assert swa[0].sum(-1).tolist() == [4] * 10
    assert swa[0, 0].nonzero()[:, 0].tolist() == [7, 8, 9, 10]
    assert chunked[0].sum(-1).tolist() == [3, 4, 5, 6, 7, 8, 1, 2, 3, 4]
    assert not full[0, :, 20:].any()  # never a row past n_past + T


def _split_emulation(q, k, v, n_past, *, scale, softcap, window, lo_terms, chunk=32):
    """The tensor-core kernel's arithmetic (csrc/flash_prefill.cu) on the
    CPU: q·scale and each chunk's p = exp(s − m) rounded to a bf16 hi term
    plus, with lo_terms, a bf16 lo term (x − hi, rounded), products of the
    terms with the bf16 rows summed in f32, an online softmax over chunks."""
    from llama_cpp_dsp_tpu_torch.ops import softcap as apply_softcap
    from llama_cpp_dsp_tpu_torch.runtime.kv_cache import causal_mask

    b, t, h, d = q.shape
    hkv, rows = k.shape[1], k.shape[2]

    def terms(x):
        hi = x.to(torch.bfloat16).float()
        return (hi, (x - hi).to(torch.bfloat16).float()) if lo_terms else (hi,)

    qs = terms(q.float().reshape(b, t, hkv, h // hkv, d) * scale)
    pos = n_past[:, None] + torch.arange(t, dtype=torch.int32)
    mask = causal_mask(pos, rows, n_past, window)[:, None, None]
    m = torch.full((b, hkv, h // hkv, t, 1), float("-inf"))
    l = torch.zeros_like(m)
    acc = torch.zeros(b, hkv, h // hkv, t, d)
    for c0 in range(0, rows, chunk):
        kc, vc = k[:, :, c0:c0 + chunk].float(), v[:, :, c0:c0 + chunk].float()
        sc = sum(torch.einsum("bthrd,bhsd->bhrts", x, kc) for x in qs)
        if softcap:
            sc = apply_softcap(sc, softcap)
        sc = sc.masked_fill(~mask[..., c0:c0 + chunk], float("-inf"))
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        base = torch.where(torch.isfinite(m_new), m_new, torch.zeros_like(m_new))
        alpha, p = torch.exp(m - base), torch.exp(sc - base)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + sum(torch.einsum("bhrts,bhsd->bhrtd", x, vc) for x in terms(p))
        m = m_new
    return (acc / l.clamp_min(1e-30)).permute(0, 3, 1, 2, 4).reshape(b, t, h, d)


@pytest.mark.parametrize("lo_terms", [True, False], ids=["split", "hi-only"])
def test_split_bf16_operands_keep_the_chip_limit(lo_terms):
    """The numeric design of B4's tensor-core kernel: with q and p each
    split into two bf16 terms the result lies within NMSE 1e-10 of
    `flash_prefill_plain` (chip_smoke.py holds the kernel to 1e-8); with the
    hi terms alone (a single-pass bf16 kernel, the fault chip_smoke.py
    plants) it lies above 1e-8. D 256, 16 heads over 8, T 64 from n_past 40,
    a 24-row window and a softcap that bends q scaled ×4."""
    rng = np.random.default_rng(7)
    h, hkv, d, t, rows = 16, 8, 256, 64, 128
    q = _t(rng.standard_normal((1, t, h, d)).astype(np.float32)) * 4.0
    k = _t(rng.standard_normal((1, hkv, rows, d)).astype(np.float32)).bfloat16()
    v = _t(rng.standard_normal((1, hkv, rows, d)).astype(np.float32)).bfloat16()
    n_past = torch.tensor([40], dtype=torch.int32)
    kw = dict(scale=d ** -0.5, softcap=10.0)
    want = ka.flash_prefill_plain(q, k, v, n_past, swa_window=24, **kw).double()
    got = _split_emulation(q, k, v, n_past, window=24, lo_terms=lo_terms, **kw).double()
    err = float(((got - want) ** 2).mean() / (want ** 2).mean())
    assert (err <= 1e-10) if lo_terms else (err > 1e-8), err


D = 256
B, H, HKV, S = 3, 4, 2, 256
LENGTHS = np.array([1, 140, 256], np.int32)


def _decode_case(case):
    starts = np.array([0, 40, 200], np.int32) if case == "swa" else None
    softcap = 30.0 if case == "softcap" else 0.0
    return starts, softcap


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("case", ["ragged", "swa", "softcap"])
@pytest.mark.parametrize("kv", ["f32", "bf16"])
def test_flash_decode_d256_matches_jax(case, kv):
    rng = np.random.default_rng(7)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    k = rng.standard_normal((B, HKV, S, D)).astype(np.float32)
    v = rng.standard_normal((B, HKV, S, D)).astype(np.float32)
    starts, softcap = _decode_case(case)
    jdt, tdt = (jnp.float32, torch.float32) if kv == "f32" else (jnp.bfloat16, torch.bfloat16)
    want = jatt.flash_decode(jnp.asarray(q), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
                             jnp.asarray(LENGTHS), _j(starts), scale=D ** -0.5,
                             softcap=softcap, interpret=True)
    before = dict(LAUNCHES)
    got = ka.flash_decode(_t(q), _t(k).to(tdt), _t(v).to(tdt), _t(LENGTHS),
                          None if starts is None else _t(starts), scale=D ** -0.5,
                          softcap=softcap)
    assert LAUNCHES == before and got.shape == (B, H, D)
    tol = 2e-5 if kv == "f32" else 2e-3
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("case", ["ragged", "swa", "softcap"])
def test_flash_decode_q8_and_q4_d256_match_jax(case):
    """Q8_0 rows and Q4_0 row pairs (8 scale groups a row at D = 256),
    quantized by JAX's own quantizers."""
    rng = np.random.default_rng(11)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    k = jnp.asarray(rng.standard_normal((B, HKV, S, D)), jnp.float32)
    v = jnp.asarray(rng.standard_normal((B, HKV, S, D)), jnp.float32)
    starts, softcap = _decode_case(case)
    kw = dict(scale=D ** -0.5, softcap=softcap)
    (kq, kd), (vq, vd) = jkv._q8_quant(k), jkv._q8_quant(v)
    want = jatt.flash_decode_q8(jnp.asarray(q), kq, kd[:, :, None], vq, vd[:, :, None],
                                jnp.asarray(LENGTHS), _j(starts), chunk=128, interpret=True,
                                **kw)
    before = dict(LAUNCHES)
    got = ka.flash_decode_q8(_t(q), _t(kq), _t(kd)[:, :, None], _t(vq), _t(vd)[:, :, None],
                             _t(LENGTHS), None if starts is None else _t(starts), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    planes = []
    for x in (k, v):
        codes, scales = jkv._q4_quant(x)
        planes += [np.array(jkv._q4_pack_rows(codes)), np.array(jkv._rows_to_parity(scales))]
    assert planes[1].shape == (B, HKV, 2 * D // 32, S // 2)
    want = jatt.flash_decode_q4(jnp.asarray(q), *(jnp.asarray(a) for a in planes),
                                jnp.asarray(LENGTHS), _j(starts), chunk=256, interpret=True,
                                **kw)
    got = ka.flash_decode_q4(_t(q), *(_t(a) for a in planes), _t(LENGTHS),
                             None if starts is None else _t(starts), **kw)
    assert LAUNCHES == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", ["ragged", "swa", "softcap"])
def test_flash_decode_paged_d256_match_jax(case):
    """Dense and Q8_0 pages of 16 rows, shuffled page ids, a table entry
    past the pool (the sentinel) where a slot has no page."""
    rng = np.random.default_rng(13)
    ps, nb = 16, S // 16
    n_pages = B * nb
    tables = rng.permutation(n_pages).astype(np.int32).reshape(B, nb)
    tables[0, 1:] = n_pages  # slot 0 holds one row: the rest are sentinels
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    kp = jnp.asarray(rng.standard_normal((n_pages, HKV, ps, D)), jnp.float32)
    vp = jnp.asarray(rng.standard_normal((n_pages, HKV, ps, D)), jnp.float32)
    starts, softcap = _decode_case(case)
    kw = dict(scale=D ** -0.5, softcap=softcap)
    args = (jnp.asarray(LENGTHS), _j(starts))
    targs = (_t(LENGTHS), None if starts is None else _t(starts))
    want = jatt.flash_decode_paged(jnp.asarray(q), kp, vp, jnp.asarray(tables), *args,
                                   interpret=True, **kw)
    before = dict(LAUNCHES)
    got = ka.flash_decode_paged(_t(q), _t(kp), _t(vp), _t(tables), *targs, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    (kq, kd), (vq, vd) = jkv._q8_quant(kp), jkv._q8_quant(vp)
    want = jatt.flash_decode_paged_q8(jnp.asarray(q), kq, kd[:, :, None], vq, vd[:, :, None],
                                      jnp.asarray(tables), *args, interpret=True, **kw)
    got = ka.flash_decode_paged_q8(_t(q), _t(kq), _t(kd)[:, :, None], _t(vq),
                                   _t(vd)[:, :, None], _t(tables), *targs, **kw)
    assert LAUNCHES == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_head_widths_and_cpu_wrappers():
    """The kernels' widths are 128 and 256 (the model sends D = 64 to the
    plain attention); on CPU tensors the prefill wrapper is its plain
    version, bit for bit."""
    assert ka.HEAD_DIMS == (128, 256)
    rng = np.random.default_rng(0)
    q = _t(rng.standard_normal((1, 5, 4, 256)).astype(np.float32))
    k = _t(rng.standard_normal((1, 2, 16, 256)).astype(np.float32)).to(torch.bfloat16)
    v = _t(rng.standard_normal((1, 2, 16, 256)).astype(np.float32)).to(torch.bfloat16)
    n_past = torch.tensor([3], dtype=torch.int32)
    before = dict(LAUNCHES)
    for kw in ({}, {"swa_window": 4, "softcap": 5.0}, {"attn_chunk": 4}):
        assert torch.equal(ka.flash_prefill(q, k, v, n_past, scale=0.1, **kw),
                           ka.flash_prefill_plain(q, k, v, n_past, scale=0.1, **kw))
    assert LAUNCHES == before
