"""The port's qmm (plain version, CPU) against the JAX package's Pallas
qmm_fused in interpret mode, and the port's repack and dequant against the
JAX package's repack and ref_numpy, for every kind with a port kernel.

The kinds of 32-element blocks also run at K = 352 (11 blocks), off the
256 grid, as DeepSeek-V2-Lite's K = 1408 expert rows are.

Tolerance: NMSE ≤ 5e-4 against x · exact-f32-dequant(W)ᵀ and against the
JAX kernel — the reference's MUL_MAT tolerance, as tests/test_pallas_qmm.py
states. The torch dequant is bit-exact with ref_numpy.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_cpp_dsp_tpu.gguf import GGMLType
from llama_cpp_dsp_tpu.ops.pallas.layouts import to_kernel_layout
from llama_cpp_dsp_tpu.ops.pallas.qmm import qmm_fused
from llama_cpp_dsp_tpu.ops.qtensor import from_gguf_tensor as jax_from_gguf_tensor
from llama_cpp_dsp_tpu.ops.qtensor import repack as jax_repack
from llama_cpp_dsp_tpu.quant import quantize
from llama_cpp_dsp_tpu.quant.ref_numpy import dequantize
from llama_cpp_dsp_tpu_torch.gguf.constants import GGMLType as TGGMLType
from llama_cpp_dsp_tpu_torch.ops import take_rows
from llama_cpp_dsp_tpu_torch.ops.kernels import LAUNCHES
from llama_cpp_dsp_tpu_torch.ops.kernels.qmm import qmm, qmm_plain
from llama_cpp_dsp_tpu_torch.ops.qtensor import PACKED_KINDS, from_gguf_tensor
from llama_cpp_dsp_tpu_torch.quant.dequant import dequant
from torch_fixtures import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

KINDS = [GGMLType.Q4_0, GGMLType.Q4_1, GGMLType.Q5_0, GGMLType.Q5_1, GGMLType.Q8_0,
         GGMLType.Q2_K, GGMLType.Q3_K, GGMLType.Q4_K, GGMLType.Q5_K, GGMLType.Q6_K]
NMSE_TOL = 5e-4
K_OFF_GRID = 352  # 11 blocks of 32: not a multiple of 256
SMALL_BLOCK_KINDS = [GGMLType.Q4_0, GGMLType.Q4_1, GGMLType.Q5_0, GGMLType.Q5_1, GGMLType.Q8_0]


def nmse(got, want):
    d = got.astype(np.float64) - want.astype(np.float64)
    return float((d * d).mean() / ((want.astype(np.float64) ** 2).mean() + 1e-12))


def _weights(kind, n, k, seed=0):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((n, k)) * 0.1).astype(np.float32)
    raw = quantize(w, kind)
    return raw, from_gguf_tensor(raw, TGGMLType(int(kind)), (n, k))


@pytest.mark.parametrize("kind,b,k", [(kind, b, 512) for kind in KINDS for b in (1, 5)]
                         + [(kind, 5, K_OFF_GRID) for kind in SMALL_BLOCK_KINDS])
def test_qmm_matches_jax_qmm_fused(kind, b, k):
    n = 256
    raw, qt = _weights(kind, n, k)
    x = np.random.default_rng(1).standard_normal((b, k)).astype(np.float32)
    exact = x @ dequantize(raw, kind).reshape(n, k).T
    kw = to_kernel_layout(jax_from_gguf_tensor(raw, kind, (n, k)))
    want = np.asarray(qmm_fused(jnp.asarray(x), kw, tile_b=8, tile_n=128, tile_k=256))
    before = dict(LAUNCHES)
    got = qmm(torch.from_numpy(x), qt)
    assert LAUNCHES == before  # a CPU tensor takes the plain version
    assert got.dtype == torch.float32 and got.shape == (b, n)
    got = got.numpy()
    assert nmse(got, exact) < NMSE_TOL
    assert nmse(got, want) < NMSE_TOL
    assert nmse(want, exact) < NMSE_TOL


@pytest.mark.parametrize("kind", KINDS)
def test_qmm_keeps_leading_dims(kind):
    raw, qt = _weights(kind, 64, 256, seed=2)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 3, 256)).astype(np.float32))
    y = qmm(x, qt)
    assert y.shape == (2, 3, 64)
    torch.testing.assert_close(y, qmm_plain(x.reshape(6, 256), qt).reshape(2, 3, 64))


@pytest.mark.parametrize("kind,k", [(kind, 256) for kind in KINDS]
                         + [(kind, K_OFF_GRID) for kind in SMALL_BLOCK_KINDS])
def test_dequant_bit_exact_with_ref_numpy(kind, k):
    n = 48
    raw, qt = _weights(kind, n, k, seed=4)
    want = dequantize(raw, kind).reshape(n, k)
    got = dequant(qt, torch.float32).numpy()
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    rows = torch.tensor([[5, 0], [47, 5]])
    np.testing.assert_array_equal(take_rows(qt, rows).numpy(), want[rows.numpy()])


def test_kinds_are_the_packed_kinds():
    assert [int(k) for k in KINDS] == [int(k) for k in PACKED_KINDS]


@pytest.mark.parametrize("kind,k", [(kind, 512) for kind in KINDS]
                         + [(kind, K_OFF_GRID) for kind in SMALL_BLOCK_KINDS])
def test_repack_fields_match_jax(kind, k):
    """Field names, dtypes, shapes and bytes as the JAX package's repack."""
    n = 32
    raw, qt = _weights(kind, n, k, seed=5)
    want = jax_repack(raw, kind, (n, k))
    assert qt.shape == want.shape and sorted(qt.arrays) == sorted(want.arrays)
    for name, a in want.arrays.items():
        got = qt[name].numpy()
        assert got.dtype == a.dtype and got.shape == a.shape, name
        assert np.array_equal(got, a), name
