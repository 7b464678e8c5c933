"""The port's qmm (plain version, CPU) against the JAX package's Pallas
qmm_fused in interpret mode, and the port's dequant against ref_numpy.

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
from llama_cpp_dsp_tpu.quant import quantize
from llama_cpp_dsp_tpu.quant.ref_numpy import dequantize
from llama_cpp_dsp_tpu_torch.gguf.constants import GGMLType as TGGMLType
from llama_cpp_dsp_tpu_torch.ops import take_rows
from llama_cpp_dsp_tpu_torch.ops.kernels import LAUNCHES
from llama_cpp_dsp_tpu_torch.ops.kernels.qmm import qmm, qmm_plain
from llama_cpp_dsp_tpu_torch.ops.qtensor import from_gguf_tensor
from llama_cpp_dsp_tpu_torch.quant.dequant import dequant

KINDS = [GGMLType.Q4_0, GGMLType.Q8_0]
NMSE_TOL = 5e-4


def nmse(got, want):
    d = got.astype(np.float64) - want.astype(np.float64)
    return float((d * d).mean() / ((want.astype(np.float64) ** 2).mean() + 1e-12))


def _weights(kind, n, k, seed=0):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((n, k)) * 0.1).astype(np.float32)
    raw = quantize(w, kind)
    return raw, from_gguf_tensor(raw, TGGMLType(int(kind)), (n, k))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("b", [1, 5])
def test_qmm_matches_jax_qmm_fused(kind, b):
    n, k = 256, 512
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


@pytest.mark.parametrize("kind", KINDS)
def test_dequant_bit_exact_with_ref_numpy(kind):
    n, k = 48, 256
    raw, qt = _weights(kind, n, k, seed=4)
    want = dequantize(raw, kind).reshape(n, k)
    got = dequant(qt, torch.float32).numpy()
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    rows = torch.tensor([[5, 0], [47, 5]])
    np.testing.assert_array_equal(take_rows(qt, rows).numpy(), want[rows.numpy()])
