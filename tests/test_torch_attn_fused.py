"""The port's attn_decode_fused (plain version, CPU) against the JAX
package's Pallas attn_decode_fused in interpret mode, on the cases of
tests/test_attn_fused.py.

Tolerance: the attention output within 2e-2 (as tests/test_attn_fused.py
holds the fused kernel against the unfused path); the written K/V rows
within 1e-2, because the QKV products round at other points — the TPU
kernel rounds q·s (q up to 15) to bf16 and folds the −8 through group sums,
which alone moves a K=256 dot by ~s·15·2⁻⁹·√K·|x| ≈ 3e-3 here, while the
port rounds (q−8)·s; every other cache row, and an idle slot's rows,
exactly equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_cpp_dsp_tpu.gguf.constants import GGMLType
from llama_cpp_dsp_tpu.ops.pallas.attn_fused import attn_decode_fused as jax_attn_fused
from llama_cpp_dsp_tpu.ops.pallas.layouts import to_kernel_layout
from llama_cpp_dsp_tpu.ops.qtensor import from_gguf_tensor as jax_from_gguf_tensor
from llama_cpp_dsp_tpu.ops.rope import RopeParams as JaxRopeParams
from llama_cpp_dsp_tpu.ops.rope import _rope_angles as jax_rope_angles
from llama_cpp_dsp_tpu.quant import quantize
from llama_cpp_dsp_tpu_torch.gguf.constants import GGMLType as TGGMLType
from llama_cpp_dsp_tpu_torch.ops.kernels import LAUNCHES
from llama_cpp_dsp_tpu_torch.ops.kernels.attn_fused import attn_decode_fused
from llama_cpp_dsp_tpu_torch.ops.qtensor import from_gguf_tensor
from llama_cpp_dsp_tpu_torch.ops.rope import RopeParams, _rope_angles

D, K_DIM, S = 128, 256, 128
ROW_ATOL = 1e-2


def _run_both(b, hq, hkv, n_past, seed):
    rng = np.random.default_rng(seed)
    n_rows = (hq + 2 * hkv) * D
    w = (rng.standard_normal((n_rows, K_DIM)) * 0.05).astype(np.float32)
    raw = quantize(w, GGMLType.Q4_0)
    x = (rng.standard_normal((b, K_DIM)) * 0.3).astype(np.float32)
    kc = (rng.standard_normal((b, hkv, S, D)) * 0.2).astype(np.float32)
    vc = (rng.standard_normal((b, hkv, S, D)) * 0.2).astype(np.float32)
    for bi, p in enumerate(n_past):
        kc[bi, :, min(p, S):] = 0
        vc[bi, :, min(p, S):] = 0
    pos = np.asarray(n_past, np.int32)
    scale = 1.0 / D ** 0.5

    kw = to_kernel_layout(jax_from_gguf_tensor(raw, GGMLType.Q4_0, (n_rows, K_DIM)),
                          tile_k=K_DIM)
    cos, sin = jax_rope_angles(jnp.asarray(pos), JaxRopeParams(n_dims=D), None)
    out_j, kc_j, vc_j = jax_attn_fused(
        jnp.asarray(x), kw, jnp.asarray(kc, jnp.bfloat16), jnp.asarray(vc, jnp.bfloat16),
        jnp.repeat(cos, 2, axis=-1), jnp.repeat(sin, 2, axis=-1), jnp.asarray(pos + 1), None,
        n_heads=hq, n_kv_heads=hkv, scale=scale)

    qt = from_gguf_tensor(raw, TGGMLType.Q4_0, (n_rows, K_DIM))
    kc_t = torch.from_numpy(kc).to(torch.bfloat16)
    vc_t = torch.from_numpy(vc).to(torch.bfloat16)
    tpos = torch.from_numpy(pos)
    cs, sn = _rope_angles(tpos, RopeParams(n_dims=D), None)
    before = dict(LAUNCHES)
    out_t = attn_decode_fused(torch.from_numpy(x), qt, kc_t, vc_t, cs, sn, tpos + 1,
                              n_heads=hq, n_kv_heads=hkv, scale=scale)
    assert LAUNCHES == before
    as_np = lambda a: np.asarray(jnp.asarray(a, jnp.float32))  # noqa: E731
    return (out_t.numpy(), as_np(out_j).reshape(b, hq, D), kc_t.float().numpy(), as_np(kc_j),
            vc_t.float().numpy(), as_np(vc_j), kc, vc)


def _check_cache(got, want, before, n_past):
    for bi, p in enumerate(n_past):
        rows = np.ones(S, bool)
        if p < S:
            rows[p] = False
            g, w = got[bi, :, p], want[bi, :, p]
            assert np.abs(g - w).max() < ROW_ATOL
            assert np.abs(g).max() > 0  # the new row was written
        np.testing.assert_array_equal(got[bi][:, rows], want[bi][:, rows])
        bf = np.asarray(jnp.asarray(before[bi][:, rows], jnp.bfloat16).astype(jnp.float32))
        np.testing.assert_array_equal(got[bi][:, rows], bf)


@pytest.mark.parametrize("b,hq,hkv,n_past", [
    (1, 4, 4, (37,)),  # MHA (the 7B shape class)
    (2, 8, 2, (5, 90)),  # GQA, ragged lengths
    (1, 2, 2, (0,)),  # first decoded token (no cached rows)
])
def test_attn_fused_matches_jax(b, hq, hkv, n_past):
    out_t, out_j, kc_t, kc_j, vc_t, vc_j, kc0, vc0 = _run_both(b, hq, hkv, n_past, seed=42)
    assert np.abs(out_t - out_j).max() < 2e-2
    _check_cache(kc_t, kc_j, kc0, n_past)
    _check_cache(vc_t, vc_j, vc0, n_past)


def test_attn_fused_idle_slot_drops_write():
    """A slot at position == capacity (idle in a batched step) keeps its
    cache untouched, in both implementations."""
    n_past = (10, S)
    out_t, out_j, kc_t, kc_j, vc_t, vc_j, kc0, vc0 = _run_both(2, 4, 4, n_past, seed=7)
    assert np.abs(out_t[0] - out_j[0]).max() < 2e-2
    _check_cache(kc_t, kc_j, kc0, n_past)
    _check_cache(vc_t, vc_j, vc0, n_past)
