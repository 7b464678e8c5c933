"""The port's Q4_1 / Q5_0 / Q5_1 expert stacks and kernel entries against
the JAX package on the CPU: `qmm_expert_rows` (its plain version) against
JAX `qmm_expert_rows` in Pallas interpret mode, with the 3-D repack equal to
JAX's `_convert`, and the field table the kernel entry is handed. K = 352
(11 blocks of 32) keeps the rows off the 256 grid, as DeepSeek-V2-Lite's
K = 1408 expert rows are. (Repack, dequant and `qmm` of these kinds run in
tests/test_torch_qmm.py, at K = 352 too.)

Tolerance: NMSE ≤ 5e-4 against x · exact-f32-dequant(W)ᵀ and against the
JAX kernel (the reference's MUL_MAT tolerance, as tests/test_torch_qmm.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_cpp_dsp_tpu.gguf import GGMLType
from llama_cpp_dsp_tpu.ops.pallas.layouts import to_kernel_layout_experts
from llama_cpp_dsp_tpu.ops.pallas.qmm import qmm_expert_rows as jax_qmm_expert_rows
from llama_cpp_dsp_tpu.quant import quantize
from llama_cpp_dsp_tpu.quant.ref_numpy import dequantize
from llama_cpp_dsp_tpu.runtime.loader import _convert as jax_convert
from llama_cpp_dsp_tpu_torch.gguf.constants import GGMLType as TGGMLType
from llama_cpp_dsp_tpu_torch.ops.kernels import LAUNCHES
from llama_cpp_dsp_tpu_torch.ops.kernels import qmm as kqmm
from llama_cpp_dsp_tpu_torch.ops.qtensor import repack
from torch_fixtures import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

KINDS = [GGMLType.Q4_1, GGMLType.Q5_0, GGMLType.Q5_1]
NMSE_TOL = 5e-4
K = 352  # 11 blocks: not a multiple of 256


def nmse(got, want):
    d = np.asarray(got, np.float64) - np.asarray(want, np.float64)
    return float((d * d).mean() / ((np.asarray(want, np.float64) ** 2).mean() + 1e-12))


def _raw(kind, rows, k, seed):
    """Weights quantized by the JAX package (ref_numpy's quantizer): the raw
    GGUF bytes and their exact f32 dequant [rows, k]."""
    w = (np.random.default_rng(seed).standard_normal((rows, k)) * 0.1).astype(np.float32)
    raw = quantize(w, kind)
    return raw, dequantize(raw, kind).reshape(rows, k)


@pytest.mark.parametrize("kind", KINDS)
def test_qmm_expert_rows_matches_jax_kernel(kind):
    e, n = 4, 128
    raw, exact = _raw(kind, e * n, K, 20 + int(kind))
    exact = exact.reshape(e, n, K)
    jq = jax_convert(raw, kind, (e, n, K))
    pq = repack(raw, TGGMLType(int(kind)), (e, n, K))
    assert pq.n_expert == e and pq.shape == (n, K)
    for name, a in jq.arrays.items():  # the 3-D repack is JAX's _convert
        assert np.array_equal(pq[name].numpy(), a), name
    x = np.random.default_rng(2).standard_normal((5, K)).astype(np.float32)
    sel = np.array([3, 0, 3, 1, 2], np.int32)  # a repeated expert, the last one
    kw = to_kernel_layout_experts(jq)
    want = np.asarray(jax_qmm_expert_rows(jnp.asarray(x), kw, jnp.asarray(sel), tile_n=128))
    before = dict(LAUNCHES)
    got = kqmm.qmm_expert_rows(torch.from_numpy(x), pq, torch.from_numpy(sel))
    assert LAUNCHES == before
    ref = np.stack([x[i] @ exact[sel[i]].T for i in range(5)])
    assert nmse(got.numpy(), ref) < NMSE_TOL
    assert nmse(got.numpy(), want) < NMSE_TOL
    assert nmse(want, ref) < NMSE_TOL


@pytest.mark.parametrize("kind", KINDS)
def test_wrapper_field_table_matches_repack(kind):
    """The fields the kernel entry is handed (`_fields`, in the C entry's
    order) are the repacked ones, with the repack's dtypes and shapes."""
    raw, _ = _raw(kind, 8, K, 30)
    pq = repack(raw, TGGMLType(int(kind)), (8, K))
    table = kqmm._fields(pq.kind, 8, K)
    assert {name for name, _, _ in table} == set(pq.arrays)
    for name, dtype, shape in table:
        assert (pq[name].dtype, tuple(pq[name].shape)) == (dtype, shape), name
    assert kqmm._ENTRY[pq.kind][1] == 32  # K % 32, not % 256
