"""The port's IQ / TQ weight kinds (IQ4_NL, IQ4_XS, IQ2_XXS, IQ2_XS, IQ2_S,
IQ3_XXS, IQ3_S, IQ1_S, IQ1_M, TQ1_0, TQ2_0) against the JAX package on the
CPU.

- The grids file and the two sign tables equal JAX's.
- Fields: the port's `from_gguf_tensor` (2-D) and its 3-D `repack` (an
  expert stack) give JAX's `from_gguf_tensor` / `_convert` fields exactly:
  names, dtypes, shapes, bytes. The carrier's decomposition equals
  `ref_numpy.iq_int_decompose` (payload = table[code], scales, g).
- Dequant is bit-exact with `ref_numpy.dequantize`; `take_rows` gives the
  same rows.
- The product: the plain version (CPU) against JAX's Pallas `qmm_fused` in
  interpret mode for one kind per JAX body (IQ4_XS and IQ4_NL: `_body_iq4`;
  IQ3_S, TQ2_0: `_body_tab32`; IQ2_S: `_body_tab16`), `qmm_expert_rows` for
  one tab32 and one tab16 kind, and the exact product for the others.
- `tools/synth.py`'s random blocks: rms ≈ 0.054, zero-mean groups.

Inputs are random blocks (`tools/synth.py::synth_raw`, seeded with numpy):
random bits are valid blocks of every kind. Tolerance: NMSE ≤ 5e-4 against
x · exact-f32-dequant(W)ᵀ and against the JAX kernel (the reference's
MUL_MAT tolerance, as tests/test_torch_qmm.py); fields, codes and dequant
exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_cpp_dsp_tpu.gguf import GGMLType
from llama_cpp_dsp_tpu.ops.pallas.layouts import to_kernel_layout, to_kernel_layout_experts
from llama_cpp_dsp_tpu.ops.pallas.qmm import qmm_expert_rows as jax_qmm_expert_rows
from llama_cpp_dsp_tpu.ops.pallas.qmm import qmm_fused
from llama_cpp_dsp_tpu.ops.qtensor import IQ_TABLES as JAX_IQ_TABLES
from llama_cpp_dsp_tpu.ops.qtensor import from_gguf_tensor as jax_from_gguf_tensor
from llama_cpp_dsp_tpu.quant import iq_grids as jax_iq_grids
from llama_cpp_dsp_tpu.quant.ref_numpy import dequantize, iq_int_decompose
from llama_cpp_dsp_tpu.runtime.loader import _convert as jax_convert
from llama_cpp_dsp_tpu_torch.gguf.constants import GGMLType as TGGMLType
from llama_cpp_dsp_tpu_torch.ops import take_rows
from llama_cpp_dsp_tpu_torch.ops.kernels import LAUNCHES
from llama_cpp_dsp_tpu_torch.ops.kernels import qmm as kqmm
from llama_cpp_dsp_tpu_torch.ops.qtensor import IQ_KINDS, from_gguf_tensor, repack
from llama_cpp_dsp_tpu_torch.quant import iq, iq_grids
from llama_cpp_dsp_tpu_torch.quant.dequant import dequant
from llama_cpp_dsp_tpu_torch.tools.synth import synth_raw
from torch_fixtures import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

NMSE_TOL = 5e-4
KINDS = [GGMLType[k.name] for k in IQ_KINDS]
TABLE_KINDS = [k for k in KINDS if k not in (GGMLType.IQ4_NL, GGMLType.IQ4_XS)]


def nmse(got, want):
    d = np.asarray(got, np.float64) - np.asarray(want, np.float64)
    return float((d * d).mean() / ((np.asarray(want, np.float64) ** 2).mean() + 1e-12))


def _raw(kind, shape, seed):
    return synth_raw(np.random.default_rng(seed), TGGMLType(int(kind)), shape)


def test_grids_and_sign_tables_match_jax():
    ours, theirs = iq_grids.grids(), jax_iq_grids.grids()
    assert sorted(ours) == sorted(theirs)
    for name, a in theirs.items():
        assert ours[name].dtype == a.dtype and np.array_equal(ours[name], a), name
    assert np.array_equal(iq_grids.sign_table(), jax_iq_grids.sign_table())
    assert np.array_equal(iq_grids.byte_sign_table(), jax_iq_grids.byte_sign_table())
    assert {int(k): v for k, v in iq.IQ_TABLES.items()} == {
        int(k): v for k, v in JAX_IQ_TABLES.items()}


def _same_fields(port_qt, jax_qt):
    assert (port_qt.kind, port_qt.shape, port_qt.n_expert) == (
        TGGMLType(int(jax_qt.kind)), tuple(jax_qt.shape), jax_qt.n_expert)
    assert sorted(port_qt.arrays) == sorted(jax_qt.arrays)
    for name, a in jax_qt.arrays.items():
        got, a = port_qt[name].numpy(), np.ascontiguousarray(a)
        assert got.dtype == a.dtype and got.shape == a.shape, name
        assert np.array_equal(got.view(np.uint8), a.view(np.uint8)), name


@pytest.mark.parametrize("kind", KINDS)
def test_fields_match_jax(kind):
    """A matrix and an expert stack [E, N, K]: the port's fields are JAX's."""
    n, k = 16, 512
    raw = _raw(kind, (n, k), int(kind))
    _same_fields(from_gguf_tensor(raw, TGGMLType(int(kind)), (n, k)),
                 jax_from_gguf_tensor(raw, kind, (n, k)))
    raw3 = _raw(kind, (3, 8, k), int(kind) + 1)
    qt = repack(raw3, TGGMLType(int(kind)), (3, 8, k))
    _same_fields(qt, jax_convert(raw3, kind, (3, 8, k)))
    assert qt.expert(2).shape == (8, k) and qt["qs"].shape == (3, 8, k // 2)


def _codes(qs):
    """The carrier's nibbles [n, k/2] → codes [n, k] in weight order."""
    b = qs.reshape(qs.shape[0], -1, 16)
    return torch.cat([b & 0x0F, b >> 4], dim=-1).reshape(qs.shape[0], -1)


@pytest.mark.parametrize("kind", TABLE_KINDS)
def test_decompose_matches_iq_int_decompose(kind):
    n, k = 8, 768
    raw = _raw(kind, (n, k), 40 + int(kind))
    q, s, g = iq_int_decompose(raw, kind)
    f = iq.carrier(raw, TGGMLType(int(kind)), n, k)
    table = np.asarray(iq.IQ_TABLES[TGGMLType(int(kind))], np.int32)
    codes = _codes(f["qs"])
    assert g == iq.GROUP[TGGMLType(int(kind))] and f["d"].shape == (n, k // g)
    assert int(codes.max()) < len(table)
    np.testing.assert_array_equal(table[codes.numpy().reshape(-1)], q)
    assert np.array_equal(f["d"].numpy().reshape(-1).view(np.uint32), s.view(np.uint32))


def test_decompose_in_chunks_of_rows(monkeypatch):
    """Row chunks of the carrier give the whole tensor's fields."""
    kind = TGGMLType.IQ2_S
    raw = _raw(GGMLType.IQ2_S, (12, 512), 3)
    whole = iq.carrier(raw, kind, 12, 512)
    monkeypatch.setattr(iq, "CHUNK_WEIGHTS", 512 * 5)  # 5 rows a chunk: 5, 5, 2
    chunked = iq.carrier(raw, kind, 12, 512)
    for name in whole:
        assert torch.equal(whole[name], chunked[name]), name


def test_grid_value_outside_the_table_raises(monkeypatch):
    """The exactness guard: a grid value the table lacks refuses the kind
    (a ValueError naming it, kept under python -O)."""
    monkeypatch.setitem(iq.IQ_TABLES, TGGMLType.IQ3_S, (-15, -13, 13, 15))
    iq._code_grids_np.cache_clear()
    try:
        with pytest.raises(ValueError, match="IQ3_S"):
            iq.carrier(_raw(GGMLType.IQ3_S, (1, 256), 0), TGGMLType.IQ3_S, 1, 256)
    finally:
        iq._code_grids_np.cache_clear()


@pytest.mark.parametrize("kind", KINDS)
def test_dequant_bit_exact_and_take_rows(kind):
    n, k = 12, 512
    raw = _raw(kind, (n, k), 7 + int(kind))
    qt = from_gguf_tensor(raw, TGGMLType(int(kind)), (n, k))
    want = dequantize(raw, kind).reshape(n, k)
    got = dequant(qt).numpy()
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    ids = torch.tensor([[3, 0], [11, 3]])
    rows = take_rows(qt, ids)
    assert rows.shape == (2, 2, k)
    np.testing.assert_array_equal(rows.numpy(), want[ids.numpy()])


@pytest.mark.parametrize("kind,b,k", [(kind, b, 512) for kind in (
    GGMLType.IQ4_XS, GGMLType.IQ4_NL, GGMLType.IQ3_S, GGMLType.IQ2_S, GGMLType.TQ2_0)
    for b in (1, 5)] + [(GGMLType.IQ4_NL, 5, 352)])
def test_qmm_matches_jax_qmm_fused(kind, b, k):
    n = 256
    raw = _raw(kind, (n, k), int(kind) + b)
    qt = from_gguf_tensor(raw, TGGMLType(int(kind)), (n, k))
    x = np.random.default_rng(b).standard_normal((b, k)).astype(np.float32)
    exact = x @ dequantize(raw, kind).reshape(n, k).T
    kw = to_kernel_layout(jax_from_gguf_tensor(raw, kind, (n, k)))
    want = np.asarray(qmm_fused(jnp.asarray(x), kw, tile_b=8, tile_n=128, tile_k=256))
    before = dict(LAUNCHES)
    got = kqmm.qmm(torch.from_numpy(x), qt)
    assert LAUNCHES == before  # a CPU tensor takes the plain version
    assert got.dtype == torch.float32 and got.shape == (b, n)
    assert nmse(got.numpy(), exact) < NMSE_TOL
    assert nmse(got.numpy(), want) < NMSE_TOL
    assert nmse(want, exact) < NMSE_TOL


@pytest.mark.parametrize("kind", [GGMLType.IQ3_XXS, GGMLType.IQ2_XS])
def test_qmm_expert_rows_matches_jax_kernel(kind):
    e, n, k = 4, 128, 256
    raw = _raw(kind, (e, n, k), 11)
    pq = repack(raw, TGGMLType(int(kind)), (e, n, k))
    exact = dequantize(raw, kind).reshape(e, n, k)
    x = np.random.default_rng(1).standard_normal((5, k)).astype(np.float32)
    sel = np.array([3, 0, 3, 1, 2], np.int32)  # a repeated expert, the last one
    kw = to_kernel_layout_experts(jax_convert(raw, kind, (e, n, k)), tile_k=256)
    want = np.asarray(jax_qmm_expert_rows(jnp.asarray(x), kw, jnp.asarray(sel), tile_n=128))
    before = dict(LAUNCHES)
    got = kqmm.qmm_expert_rows(torch.from_numpy(x), pq, torch.from_numpy(sel))
    assert LAUNCHES == before
    ref = np.stack([x[i] @ exact[sel[i]].T for i in range(5)])
    assert nmse(got.numpy(), ref) < NMSE_TOL
    assert nmse(got.numpy(), want) < NMSE_TOL
    assert nmse(want, ref) < NMSE_TOL


@pytest.mark.parametrize("kind", [GGMLType.IQ2_XXS, GGMLType.IQ2_XS, GGMLType.IQ3_XXS,
                                  GGMLType.IQ1_S, GGMLType.IQ1_M, GGMLType.TQ1_0])
def test_qmm_plain_matches_the_exact_product(kind):
    n, k = 64, 512
    raw = _raw(kind, (n, k), 20 + int(kind))
    qt = from_gguf_tensor(raw, TGGMLType(int(kind)), (n, k))
    x = np.random.default_rng(2).standard_normal((3, k)).astype(np.float32)
    got = kqmm.qmm(torch.from_numpy(x), qt).numpy()
    assert nmse(got, x @ dequantize(raw, kind).reshape(n, k).T) < NMSE_TOL


def test_kernel_entries_and_tables():
    """Every IQ / TQ kind has a GEMV / tiled and a selected-expert C entry
    (one per group size and scale type), a launch count of its own, and its
    table in four words, value v in byte v % 4 of word v // 4."""
    for kind in IQ_KINDS:
        entry, block = kqmm._ENTRY[kind]
        assert entry == {TGGMLType.IQ4_NL: "qmm_tab32_f16"}.get(
            kind, f"qmm_tab{iq.GROUP.get(kind, 32)}_f32")
        assert kqmm._EXPERT_ENTRY[kind] == "qmm_experts" + entry[3:]
        assert block == (32 if kind == TGGMLType.IQ4_NL else 256)
        for experts in (False, True):
            assert kqmm._counter(kind, experts) in LAUNCHES
        words = np.asarray(kqmm._table_words(kind), np.uint32).view(np.int8)
        table = kqmm._TABLE_OF[kind]
        assert list(words[:len(table)]) == list(table) and not words[len(table):].any()
    assert kqmm._table_words(TGGMLType.Q4_K) == ()


@pytest.mark.parametrize("kind", KINDS)
def test_synth_blocks_have_the_common_rms_and_zero_mean_groups(kind):
    n, k = 64, 1024
    raw = _raw(kind, (n, k), 5)
    w = dequantize(raw, kind).reshape(n, k // 32, 32).astype(np.float64)
    rms = float(np.sqrt((w * w).mean()))
    assert 0.035 < rms < 0.08, rms  # Q4_0's is ~0.054
    assert abs(w.mean()) < 0.02 * rms  # no common offset over the groups
    if kind == GGMLType.TQ2_0:  # the encoder's codes only: the raw value 3 (+2) never
        q = np.frombuffer(raw.tobytes(), np.uint8).reshape(-1, 66)[:, :64]
        assert not any(((q >> s) & 3 == 3).any() for s in (0, 2, 4, 6))
