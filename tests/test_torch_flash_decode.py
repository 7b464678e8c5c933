"""The port's flash_decode (plain version, CPU) against the JAX package's
Pallas flash_decode in interpret mode.

Tolerance: atol/rtol 2e-5 with f32 K/V and 2e-3 with a bf16 cache, as in
tests/test_flash_attention.py (f32 softmax in both; sums in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_cpp_dsp_tpu.ops.pallas.attention import flash_decode as jax_flash_decode
from llama_cpp_dsp_tpu_torch.ops.kernels import LAUNCHES
from llama_cpp_dsp_tpu_torch.ops.kernels.attention import flash_decode
from torch_fixtures import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

D, S = 128, 256


@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)])
@pytest.mark.parametrize("case", ["ragged", "swa", "softcap"])
@pytest.mark.parametrize("kv", ["f32", "bf16"])
def test_flash_decode_matches_jax(hq, hkv, case, kv):
    rng = np.random.default_rng(7)
    b = 3
    q = rng.standard_normal((b, hq, D)).astype(np.float32)
    k = rng.standard_normal((b, hkv, S, D)).astype(np.float32)
    v = rng.standard_normal((b, hkv, S, D)).astype(np.float32)
    lengths = np.array([1, S // 2 + 3, S], np.int32)
    starts = np.array([0, 40, 200], np.int32) if case == "swa" else None
    softcap = 20.0 if case == "softcap" else 0.0
    scale = 1.0 / np.sqrt(D)
    jdt = jnp.float32 if kv == "f32" else jnp.bfloat16
    tdt = torch.float32 if kv == "f32" else torch.bfloat16
    want = jax_flash_decode(
        jnp.asarray(q), jnp.asarray(k, jdt), jnp.asarray(v, jdt), jnp.asarray(lengths),
        None if starts is None else jnp.asarray(starts),
        scale=scale, softcap=softcap, interpret=True)
    before = dict(LAUNCHES)
    got = flash_decode(
        torch.from_numpy(q), torch.from_numpy(k).to(tdt), torch.from_numpy(v).to(tdt),
        torch.from_numpy(lengths), None if starts is None else torch.from_numpy(starts),
        scale=scale, softcap=softcap)
    assert LAUNCHES == before
    assert got.dtype == torch.float32 and got.shape == (b, hq, D)
    tol = 2e-5 if kv == "f32" else 2e-3
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)
