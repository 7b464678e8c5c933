"""DeepSeek-V2 multi-head latent attention: the port against the JAX package
on the CPU.

- `mla_flash_decode_plain` (the plain version of the MLA decode kernel,
  B10) against JAX `mla_flash_decode` in Pallas interpret mode, at the
  smallest shapes its asserts allow (C = 256, r = 128, H = 4, S = 128 and
  256, lengths 1, 77 and S); the wrapper takes the plain version for CPU
  tensors.
- `models/deepseek2.py::mla_self_attention` against JAX's, on the same
  weights (carried across by `params_from_numpy`) and inputs from a numpy
  seed: a 5-token prefill, then two cached decode steps (the port's decode
  is B10's plain version; JAX's CPU path is its XLA einsum path), each
  output and the cache rows of both planes after each step.
- `split_kv_b` (attn_kv_b → bf16 W_uk / W_uv, once at load) against the
  values JAX's `_dense` makes at every step, for an f32 and a packed
  attn_kv_b.

Tolerances: B10's plain version within 1e-5 of max|JAX out| (f32 sums in
another order); the attention output within 1e-2 of max|JAX out| (bf16
activations into the projections, as tests/test_torch_model.py's logits);
cache rows within 2 bf16 ulps (one rounding of an f32 entry whose last bits
differ with the sum order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_cpp_dsp_tpu.gguf import GGMLType
from llama_cpp_dsp_tpu.models.deepseek2 import mla_self_attention as jax_mla
from llama_cpp_dsp_tpu.models.llama import LlamaConfig as JaxConfig
from llama_cpp_dsp_tpu.ops.pallas.attention import mla_flash_decode as jax_mla_decode
from llama_cpp_dsp_tpu.ops.rope import RopeParams as JaxRope
from llama_cpp_dsp_tpu.quant import quantize
from llama_cpp_dsp_tpu.runtime.kv_cache import KVCache as JaxKVCache
from llama_cpp_dsp_tpu.runtime.kv_cache import causal_mask as jax_causal_mask
from llama_cpp_dsp_tpu.runtime.loader import _convert as jax_convert
from llama_cpp_dsp_tpu_torch.models.deepseek2 import mla_self_attention, split_kv_b
from llama_cpp_dsp_tpu_torch.models.llama import LlamaConfig
from llama_cpp_dsp_tpu_torch.ops.kernels import LAUNCHES
from llama_cpp_dsp_tpu_torch.ops.kernels.attention import (mla_flash_decode,
                                                            mla_flash_decode_plain)
from llama_cpp_dsp_tpu_torch.ops.rope import RopeParams
from llama_cpp_dsp_tpu_torch.runtime.kv_cache import KVCache
from llama_cpp_dsp_tpu_torch.runtime.loader import params_from_numpy
from torch_fixtures import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

DECODE_RTOL = 1e-5
ATTN_RTOL = 1e-2


@pytest.mark.parametrize("s", [128, 256])
def test_mla_decode_plain_matches_jax_kernel(s):
    rng = np.random.default_rng(s)
    b, h, c, r = 3, 4, 256, 128
    q = rng.standard_normal((b, h, c)).astype(np.float32)
    cache = rng.standard_normal((b, 1, s, c)).astype(np.float32)
    cache_bf16 = torch.from_numpy(cache).to(torch.bfloat16)
    lengths = np.array([1, 77, s], np.int32)
    scale = 0.125
    want = np.asarray(jax_mla_decode(jnp.asarray(q), jnp.asarray(cache_bf16.float().numpy(),
                                                                   jnp.bfloat16),
                                     jnp.asarray(lengths), scale=scale, r=r, interpret=True))
    before = dict(LAUNCHES)
    got = mla_flash_decode(torch.from_numpy(q), cache_bf16, torch.from_numpy(lengths),
                           scale=scale, r=r)
    assert LAUNCHES == before  # a CPU tensor takes the plain version
    assert got.shape == (b, h, r) and got.dtype == torch.float32
    err = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert err < DECODE_RTOL, err
    # length 1 attends to row 0 alone: the output is that row's latent
    np.testing.assert_allclose(got[0].numpy(), np.broadcast_to(cache_bf16[0, 0, 0, :r].float(),
                                                               (h, r)), rtol=1e-6)


def test_mla_decode_plain_ignores_rows_past_the_length():
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((2, 4, 256)).astype(np.float32))
    c = torch.from_numpy(rng.standard_normal((2, 1, 128, 256)).astype(np.float32))
    lengths = torch.tensor([40, 90])
    a = mla_flash_decode_plain(q, c, lengths, scale=0.1, r=128)
    c2 = c.clone()
    c2[0, 0, 40:] = 1e4  # rows past each length never count
    c2[1, 0, 90:] = -1e4
    torch.testing.assert_close(mla_flash_decode_plain(q, c2, lengths, scale=0.1, r=128), a)


# --------------------------------------------------------------------------
# mla_self_attention against JAX
# --------------------------------------------------------------------------

DIMS = dict(arch="deepseek2", n_layers=1, n_embd=256, n_heads=4, n_kv_heads=4, head_dim=96,
            n_ff=256, n_vocab=64, n_ctx_train=4096, rms_eps=1e-6, kv_lora_rank=128,
            qk_nope_dim=64, qk_rope_dim=32, v_head_dim=64)
ROPE = dict(n_dims=32, mode="norm", freq_base=10000.0, freq_scale=1 / 40, ext_factor=1.0,
            n_ctx_orig=4096)


def _layer(rng):
    """One MLA layer's JAX params: Q8_0 / Q4_K projections quantized by the
    JAX package, f32 norms and an f32 attn_kv_b, as JAX's synth makes it."""
    c, h, r = 256, 4, 128

    def q(kind, n, k):
        w = (rng.standard_normal((n, k)) * 0.05).astype(np.float32)
        return jax_convert(quantize(w, kind), kind, (n, k))

    return {
        "attn_q": q(GGMLType.Q8_0, h * 96, c),
        "attn_kv_a_mqa": q(GGMLType.Q4_K, r + 32, c),
        "attn_kv_a_norm": (1.0 + 0.1 * rng.standard_normal(r)).astype(np.float32),
        "attn_kv_b": (rng.standard_normal((h * (64 + 64), r)) * 0.05).astype(np.float32),
        "attn_output": q(GGMLType.Q8_0, c, h * 64),
    }


def test_mla_self_attention_matches_jax():
    rng = np.random.default_rng(7)
    layer = _layer(rng)
    jcfg = JaxConfig(**DIMS, rope=JaxRope(**ROPE))
    pcfg = LlamaConfig(**DIMS, rope=RopeParams(**ROPE))
    assert (pcfg.kv_cache_heads, pcfg.kv_cache_dim) == (jcfg.kv_cache_heads, jcfg.kv_cache_dim)
    assert pcfg.kv_cache_dim == 256  # 128 + 32, padded to a 128 multiple
    params = {"layers": [params_from_numpy(layer)]}
    split_kv_b(params, pcfg)  # as the loader does
    player = params["layers"][0]
    n_ctx = 32
    jcache = JaxKVCache.create(1, 1, n_ctx, jcfg.kv_cache_heads, jcfg.kv_cache_dim)
    pcache = KVCache.create(1, 1, n_ctx, pcfg.kv_cache_heads, pcfg.kv_cache_dim)
    steps = [(0, 5), (5, 6), (6, 7)]  # a prefill, then two decode steps
    x_all = rng.standard_normal((1, 7, 256)).astype(np.float32)
    for lo, hi in steps:
        x = x_all[:, lo:hi]
        pos = np.arange(lo, hi, dtype=np.int32)[None]
        mask = jax_causal_mask(jnp.asarray(pos), n_ctx, lo)
        want, jcache = jax_mla(jnp.asarray(x), layer, jcfg, jnp.asarray(pos), jcache, 0, lo, mask,
                               jnp.bfloat16)
        got = mla_self_attention(torch.from_numpy(x), player, pcfg, torch.from_numpy(pos),
                                 pcache, 0, lo)
        want = np.asarray(want, np.float32)
        assert got.shape == want.shape == (1, hi - lo, 256)
        err = np.abs(got.numpy() - want).max() / np.abs(want).max()
        assert err < ATTN_RTOL, (lo, err)
        for plane, (mine, theirs) in enumerate(zip(pcache.layer(0), jcache.layer(0))):
            mine = mine.float().numpy()
            theirs = np.asarray(theirs, np.float32)
            assert mine.shape == theirs.shape == (1, 1, n_ctx, 256)
            np.testing.assert_allclose(mine, theirs, rtol=2 ** -7, atol=1e-6,
                                       err_msg=f"plane {plane} after rows {lo}..{hi}")
            assert not mine[0, 0, :, 160:].any()  # the pad lanes stay zero
    k, v = pcache.layer(0)
    assert torch.equal(k, v)  # both planes hold the same latent entry, as JAX writes it


@pytest.mark.parametrize("packed", [False, True])
def test_split_kv_b_rounds_like_jax_dense(packed):
    """W_uk / W_uv are the bf16 values JAX's `_dense` reshapes, for an f32
    attn_kv_b (as JAX's synth makes it) and a packed one (as a GGUF holds
    it); attn_kv_b itself leaves the tree."""
    from llama_cpp_dsp_tpu.models.deepseek2 import _dense

    rng = np.random.default_rng(3)
    w = (rng.standard_normal((4 * 128, 128)) * 0.05).astype(np.float32)
    if packed:
        w = jax_convert(quantize(w, GGMLType.Q5_0), GGMLType.Q5_0, (4 * 128, 128))
    cfg = LlamaConfig(**DIMS, rope=RopeParams(**ROPE))
    params = {"layers": [params_from_numpy({"attn_kv_b": w})]}
    split_kv_b(params, cfg)
    layer = params["layers"][0]
    uk, uv = layer.pop("attn_kv_b_uk"), layer.pop("attn_kv_b_uv")
    assert not layer
    dense = np.asarray(_dense(w, jnp.bfloat16).astype(jnp.float32)).reshape(4, 128, 128)
    assert uk.shape == (4, 64, 128) and uv.shape == (4, 64, 128)
    assert uk.dtype == uv.dtype == torch.bfloat16
    assert uk.is_contiguous() and uv.is_contiguous()
    np.testing.assert_array_equal(uk.float().numpy(), dense[:, :64])
    np.testing.assert_array_equal(uv.float().numpy(), dense[:, 64:])
