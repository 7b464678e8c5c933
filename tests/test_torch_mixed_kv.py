"""The port's other KV cache types (-ctk / -ctv: f32, f16, q4_1, q5_0, q5_1,
iq4_nl and split pairs, `MixedKVCache`) against the JAX package on the CPU,
and every type end to end through LlamaContext.

The quantizers and the fifth-bit planes must be bit-exact, and so must every
plane of every format, as K and as V, after the writes of
tests/test_torch_q4_kv.py. `make_kv_cache` routes each pair to the class
JAX routes it to. LlamaContext logits over a tiny head_dim-128 GGUF agree
with JAX's LlamaContext(use_pallas=False) within test_torch_model.py's
tolerance (2e-2 of the logits' max magnitude); the quality budgets of
tests/test_kv_quality.py hold for the port's caches too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_cpp_dsp_tpu.gguf.constants import GGMLType
from llama_cpp_dsp_tpu.models.registry import synth_config
from llama_cpp_dsp_tpu.quant.ref_numpy import KVALUES_IQ4NL as JAX_KVALUES
from llama_cpp_dsp_tpu.runtime import kv_cache as jkv
from llama_cpp_dsp_tpu.runtime.context import LlamaContext as JaxContext
from llama_cpp_dsp_tpu.runtime.loader import load_model as jax_load_model
from llama_cpp_dsp_tpu.tools.synth import synth_params
from llama_cpp_dsp_tpu_torch.models.llama import LlamaConfig
from llama_cpp_dsp_tpu_torch.ops.rope import RopeParams
from llama_cpp_dsp_tpu_torch.quant import kv_planes as pkp
from llama_cpp_dsp_tpu_torch.quant.blocks import KVALUES_IQ4NL
from llama_cpp_dsp_tpu_torch.runtime import kv_cache as pkv
from llama_cpp_dsp_tpu_torch.runtime.context import LlamaContext
from llama_cpp_dsp_tpu_torch.runtime.loader import LoadedModel, load_model, params_from_numpy
from model_builder import build_tiny_llama
from test_torch_q4_kv import B, D, HKV, S, np_of, run_writes, same_planes
from torch_fixtures import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

LOGIT_RTOL = 2e-2


@pytest.mark.parametrize("name", ["_q4_1_quant", "_q5_0_quant", "_q5_1_quant", "_iq4nl_quant"])
def test_quantizers_bit_exact_with_jax(name):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 4, 128)) * 3).astype(np.float32)
    x[0, 0, :32] = 0.0  # an all-zero group
    x[1, 1, :32] = 0.25
    x[1, 1, 5], x[1, 1, 20] = -2.0, 2.0  # a tie of |x|
    for dt_t, dt_j in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        got = getattr(pkp, name[1:])(torch.from_numpy(x).to(dt_t))
        want = getattr(jkv, name)(jnp.asarray(x, dt_j))
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_bit_planes_and_codebook_match_jax():
    np.testing.assert_array_equal(KVALUES_IQ4NL, JAX_KVALUES)
    assert KVALUES_IQ4NL.dtype == JAX_KVALUES.dtype
    bits = np.random.default_rng(1).integers(0, 2, (2, 3, 128)).astype(np.uint8)
    packed = pkp.pack_bit_plane(torch.from_numpy(bits))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jkv._pack_bit_plane(bits)))
    np.testing.assert_array_equal(pkp.unpack_bit_plane(packed).numpy(), bits)


def test_make_kv_cache_routes_as_jax():
    for k in pkv.KV_PLANE_FORMATS:
        for v in (None, *pkv.KV_PLANE_FORMATS):
            port = pkv.make_kv_cache(1, 1, 4, 1, 32, k, v_type=v)
            theirs = jkv.make_kv_cache(1, 1, 4, 1, 32, k, v_type=v)
            assert type(port).__name__ == type(theirs).__name__, (k, v)
            assert [a.shape for a in planes_shapes(port)] == [
                tuple(a.shape) for a in planes_shapes(theirs)], (k, v)
    # the aliases JAX accepts
    assert isinstance(pkv.make_kv_cache(1, 1, 4, 1, 32, "q4"), pkv.Q4KVCache)
    assert isinstance(pkv.make_kv_cache(1, 1, 4, 1, 32, "q8"), pkv.QuantKVCache)


def planes_shapes(cache):
    if hasattr(cache, "k_qs"):
        return [cache.k_qs[0], cache.k_d[0], cache.v_qs[0], cache.v_d[0]]
    if hasattr(cache, "k_arrs"):
        return [cache.k_arrs[k][0] for k in sorted(cache.k_arrs)] + [
            cache.v_arrs[k][0] for k in sorted(cache.v_arrs)]
    return [cache.k[0], cache.v[0]]


# each format once as K and once as V (a cycle through KV_PLANE_FORMATS)
PAIRS = [("q4_0", "q5_0"), ("q5_0", "f32"), ("f32", "f16"), ("f16", "bf16"), ("bf16", "q4_1"),
         ("q4_1", "q5_1"), ("q5_1", "iq4_nl"), ("iq4_nl", "q8_0"), ("q8_0", "q4_0")]


@pytest.mark.parametrize("k_fmt,v_fmt", PAIRS)
def test_cache_writes_match_jax(k_fmt, v_fmt):
    port = pkv.make_kv_cache(1, B, S, HKV, D, k_fmt, v_type=v_fmt)
    theirs = jkv.make_kv_cache(1, B, S, HKV, D, k_fmt, v_type=v_fmt)
    theirs = run_writes(port, theirs, seed=3)
    same_planes(port, theirs)
    for a, b in zip(port.layer(0), theirs.layer(0)):
        assert a.dtype == {jnp.dtype(jnp.float32): torch.float32,
                           jnp.dtype(jnp.float16): torch.float16}.get(b.dtype, torch.bfloat16)
        np.testing.assert_array_equal(np_of(a), np_of(b))


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """(port model, JAX model) of a tiny head_dim-128 Q4_0 llama: decode
    takes flash_decode_q4's plain version for q4_0, flash_decode's over
    the dequantized planes for the others."""
    path = str(tmp_path_factory.mktemp("torch_mixed_kv") / "tiny-d128.gguf")
    build_tiny_llama(path, seed=3, qtype=GGMLType.Q4_0, n_embd=256, n_heads=2, n_kv_heads=2)
    return load_model(path), jax_load_model(path)


@pytest.mark.parametrize("kv", ["q4_0", "q4_1", "q5_0", "iq4_nl", "f16", "f32", "q8_0/q4_0"])
def test_llama_context_logits_match_jax(models, kv):
    k_type, _, v_type = kv.partition("/")
    prompt, nxt = [1, 5, 9, 13, 2, 7, 11], 4
    got, want = [], []
    ctx = LlamaContext(models[0], n_ctx=64, device="cpu", kv_dtype=k_type,
                       kv_v_dtype=v_type or None)
    jctx = JaxContext(models[1], n_ctx=64, kv_dtype=k_type, kv_v_dtype=v_type or None,
                      use_pallas=False)
    assert type(ctx.cache).__name__ == type(jctx.cache).__name__
    for toks in (prompt, [nxt], [nxt + 1]):  # a prefill, then decode at odd and even rows
        got.append(ctx.eval_tokens(toks))
        want.append(np.asarray(jctx.eval_tokens(toks)))
    for g, w in zip(got, want):
        err = np.abs(g - w).max() / np.abs(w).max()
        assert err < LOGIT_RTOL, (kv, err)


# --------------------------------------------------------------------------
# tests/test_kv_quality.py's budgets on the port's caches (the same model)
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def quality_model():
    jcfg = synth_config("llama", n_embd=128, n_heads=2, n_kv_heads=2, head_dim=64, n_ff=256,
                        n_vocab=128, n_layers=2)
    params = params_from_numpy(synth_params(jcfg, GGMLType.Q8_0, seed=11, tie=False))
    cfg = LlamaConfig(arch="llama", n_layers=2, n_embd=128, n_heads=2, n_kv_heads=2,
                      head_dim=64, n_ff=256, n_vocab=128, n_ctx_train=jcfg.n_ctx_train,
                      rms_eps=jcfg.rms_eps, rope=RopeParams(n_dims=64))
    return LoadedModel(cfg, params, None, None)


def _decode_logits(model, kv_dtype, steps=12):
    """Teacher-forced single-token decode, as tests/test_kv_quality.py."""
    ctx = LlamaContext(model, n_ctx=64, device="cpu", kv_dtype=kv_dtype)
    stream = np.random.default_rng(3).integers(3, 120, steps + 6)
    return np.stack([np.asarray(ctx.eval_tokens([int(t)]), np.float64) for t in stream])


def _kl(base, test):
    def ls(x):
        e = x - x.max(-1, keepdims=True)
        return e - np.log(np.exp(e).sum(-1, keepdims=True))

    b, t = ls(base), ls(test)
    return float((np.exp(b) * (b - t)).sum(-1).mean())


def test_quant_kv_quality_budgets(quality_model):
    base = _decode_logits(quality_model, "f32")
    q8 = _decode_logits(quality_model, "q8_0")
    q4 = _decode_logits(quality_model, "q4_0")
    kl8, kl4 = _kl(base, q8), _kl(base, q4)
    assert kl8 < 0.2, kl8
    assert kl4 < 5.0, kl4
    assert kl8 < kl4
    assert float((base.argmax(-1) == q8.argmax(-1)).mean()) >= 0.9
