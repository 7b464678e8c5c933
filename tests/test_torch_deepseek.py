"""The port's DeepSeek-V2 path against the JAX package on the CPU.

- A 3-layer tiny deepseek2 GGUF (layer 0 dense, 8 experts top-3 of width
  352, one shared expert, YaRN rope, a deepseek-llm vocab) written by the
  port's `write_synth_gguf` and read by both packages' loaders: the same
  config fields and the same weights.
- Logits of a prefill and of three decode steps, and a greedy 8-token
  stream, against JAX's `LlamaContext` at LLAMA_TPU_DECODE_CHUNK=1 (the
  chunked scan moves logits by about 1 ulp: ROADMAP.md queue C).
- The port's `tensor_type` against JAX's tools/quantize.py kinds for every
  tensor the writer emits for the full DeepSeek-V2-Lite, at Q4_K_M and
  Q5_K_M (names and shapes only; no weights are made).
- The engine on the tiny model: two slots decoding together give the
  streams of B=1 forwards; paged and -ctk q8_0 with MLA are refused.
- The YaRN scale handling the port copies from JAX (ROADMAP.md queue C).

Tolerances: logits within 2e-2 of max|JAX logit| (as tests/test_torch_model.py);
greedy streams identical.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from llama_cpp_dsp_tpu_torch.gguf.constants import GGMLType as TGGMLType
from llama_cpp_dsp_tpu_torch.ops.kernels import LAUNCHES
from llama_cpp_dsp_tpu_torch.runtime.sampling import make_chain
from llama_cpp_dsp_tpu_torch.tools import synth
from torch_fixtures import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

LOGIT_RTOL = 2e-2
TINY = dataclasses.replace(synth.DEEPSEEK_V2_LITE, n_layers=3, n_embd=256, n_heads=4,
                           n_kv_heads=4, head_dim=96, n_ff=512, n_vocab=2048, kv_lora_rank=128,
                           qk_nope_dim=64, qk_rope_dim=32, v_head_dim=64, n_expert=8,
                           n_expert_used=3,
                           rope=dataclasses.replace(synth.DEEPSEEK_V2_LITE.rope, n_dims=32))
TINY_EXPERTS = (352, 1)  # routed expert width, shared experts


@pytest.fixture(scope="module")
def ds_gguf(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("torch_deepseek") / "tiny-ds-q4_k_m.gguf")
    synth.write_synth_gguf(path, TINY, "Q4_K_M", seed=3, vocab="deepseek-llm",
                           experts=TINY_EXPERTS)
    return path


def test_gguf_loads_like_jax(ds_gguf):
    from llama_cpp_dsp_tpu.runtime.loader import load_model as jax_load_model
    from llama_cpp_dsp_tpu_torch.models.deepseek2 import split_kv_b
    from llama_cpp_dsp_tpu_torch.runtime.loader import load_model, params_from_numpy

    ours, theirs = load_model(ds_gguf), jax_load_model(ds_gguf)
    for f in ("arch", "n_layers", "n_embd", "n_heads", "n_ff", "n_vocab", "n_expert",
              "n_expert_used", "moe_norm_weights", "moe_shared_expert", "moe_scale",
              "expert_gating", "q_lora_rank", "kv_lora_rank", "qk_nope_dim", "qk_rope_dim",
              "v_head_dim", "n_dense_layers", "kv_cache_heads", "kv_cache_dim"):
        assert getattr(ours.cfg, f) == getattr(theirs.cfg, f), f
    assert ours.cfg.rope == TINY.rope and theirs.cfg.rope.ext_factor == 1.0
    assert ours.params["layers"][1]["ffn_up_exps"].shape == (352, TINY.n_embd)
    assert ours.params["layers"][1]["ffn_up_shexp"].shape == (352, TINY.n_embd)  # 1 × 352
    want = params_from_numpy(theirs.params)
    split_kv_b(want, ours.cfg)  # attn_kv_b → bf16 W_uk / W_uv, as the loader
    assert "attn_kv_b" not in ours.params["layers"][0]
    for mine, ref in zip(ours.params["layers"], want["layers"], strict=True):
        assert mine.keys() == ref.keys()
        for key, w in mine.items():
            if hasattr(w, "arrays"):
                assert (w.kind, w.shape, w.n_expert) == (ref[key].kind, ref[key].shape,
                                                         ref[key].n_expert), key
                assert all(torch.equal(a, ref[key][f]) for f, a in w.arrays.items()), key
            else:
                assert torch.equal(w, ref[key]), key
    layers = ours.params["layers"]
    assert "ffn_gate" in layers[0] and "ffn_gate_exps" not in layers[0]  # leading dense layer
    # K = 352 rows fall back: Q4_K → Q5_0 (layer 1), Q6_K → Q8_0 (layer 2, use_more_bits)
    assert [layers[i]["ffn_down_exps"].kind for i in (1, 2)] == [TGGMLType.Q5_0, TGGMLType.Q8_0]
    assert [layers[i]["ffn_down_shexp"].kind for i in (1, 2)] == [TGGMLType.Q5_0,
                                                                  TGGMLType.Q8_0]


def _jax_logits(jm, tokens, n_prefill):
    import jax.numpy as jnp

    from llama_cpp_dsp_tpu.models.llama import forward as jax_forward
    from llama_cpp_dsp_tpu.runtime.kv_cache import KVCache, causal_mask

    cfg = jm.cfg
    cache = KVCache.create(cfg.n_layers, 1, 64, cfg.kv_cache_heads, cfg.kv_cache_dim)
    outs = []
    for lo, hi in ((0, n_prefill), *((i, i + 1) for i in range(n_prefill, len(tokens)))):
        pos = jnp.arange(lo, hi, dtype=jnp.int32)[None]
        logits, cache = jax_forward(jm.params, cfg, jnp.asarray([tokens[lo:hi]], jnp.int32), pos,
                                    cache, lo, causal_mask(pos, 64, lo))
        outs.append(np.asarray(logits[0]))
    return np.concatenate(outs)


def _port_logits(pm, tokens, n_prefill):
    from llama_cpp_dsp_tpu_torch.models.llama import forward
    from llama_cpp_dsp_tpu_torch.runtime.context import convert_params_to_kernel
    from llama_cpp_dsp_tpu_torch.runtime.kv_cache import KVCache

    cfg = pm.cfg
    params = convert_params_to_kernel(pm.params)
    cache = KVCache.create(cfg.n_layers, 1, 64, cfg.kv_cache_heads, cfg.kv_cache_dim)
    outs = []
    for lo, hi in ((0, n_prefill), *((i, i + 1) for i in range(n_prefill, len(tokens)))):
        pos = torch.arange(lo, hi, dtype=torch.int32)[None]
        outs.append(forward(params, cfg, torch.tensor([tokens[lo:hi]]), pos, cache, lo)[0].numpy())
    return np.concatenate(outs)


def test_forward_and_stream_match_jax(ds_gguf, monkeypatch):
    from llama_cpp_dsp_tpu.runtime.context import LlamaContext as JaxContext
    from llama_cpp_dsp_tpu.runtime.loader import load_model as jax_load_model
    from llama_cpp_dsp_tpu.runtime.sampling import make_chain as jax_make_chain
    from llama_cpp_dsp_tpu_torch.ops.kernels import attention as katt
    from llama_cpp_dsp_tpu_torch.runtime.context import LlamaContext
    from llama_cpp_dsp_tpu_torch.runtime.loader import load_model

    tokens = [1792, 300, 301, 302, 305, 400, 7, 260, 261]
    jm = jax_load_model(ds_gguf)
    want = _jax_logits(jm, tokens, 6)
    calls = []
    inner = katt.mla_flash_decode
    monkeypatch.setattr(katt, "mla_flash_decode", lambda *a, **k: (calls.append(1),
                                                                   inner(*a, **k))[1])
    before = dict(LAUNCHES)
    pm = load_model(ds_gguf)
    got = _port_logits(pm, tokens, 6)
    assert LAUNCHES == before  # CPU tensors take the plain versions
    assert len(calls) == 3 * 3  # decode steps × layers: B10's wrapper on every decode
    assert got.shape == want.shape == (len(tokens), 2048)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err < LOGIT_RTOL, err
    monkeypatch.setenv("LLAMA_TPU_DECODE_CHUNK", "1")
    prompt = pm.tokenizer.encode("hello world", add_special=True)
    assert prompt[0] == pm.vocab.bos_id  # deepseek-llm adds <｜begin▁of▁sentence｜>
    want_ids = list(JaxContext(jm, n_ctx=64).generate(prompt, max_new_tokens=8,
                                                       sampler=jax_make_chain(temp=0)))
    ctx = LlamaContext(pm, n_ctx=64, device="cpu")
    assert list(ctx.generate(prompt, max_new_tokens=8, sampler=make_chain(temp=0))) == want_ids


def _recorded_tensors(monkeypatch, ftype):
    """(name, kind, ne shape) of every tensor write_synth_gguf emits for the
    full DeepSeek-V2-Lite, with the writer replaced by a recorder (no
    tensor is made)."""
    seen = []

    class Recorder:
        def __init__(self, path, arch):
            pass

        def __getattr__(self, name):  # the metadata adders
            return lambda *a, **k: None

        def add_tensor(self, name, data, *, ggml_type=None, ne_shape=None):
            if ggml_type is None:
                ggml_type, ne_shape = TGGMLType.F32, tuple(reversed(data.shape))
            seen.append((name, ggml_type, ne_shape))

    monkeypatch.setattr(synth, "GGUFWriter", Recorder)
    synth.write_synth_gguf("unused.gguf", synth.DEEPSEEK_V2_LITE, ftype,
                           vocab="deepseek-llm")
    return seen


@pytest.mark.parametrize("ftype", ["Q4_K_M", "Q5_K_M"])
def test_tensor_types_match_jax_quantize(monkeypatch, ftype):
    from llama_cpp_dsp_tpu.tools import quantize as jq

    seen = _recorded_tensors(monkeypatch, ftype)
    d = synth.DEEPSEEK_V2_LITE
    kv = {"general.architecture": "deepseek2", "deepseek2.block_count": d.n_layers,
          "deepseek2.attention.head_count": d.n_heads,
          "deepseek2.attention.head_count_kv": d.n_kv_heads,
          "deepseek2.expert_count": d.n_expert}
    state = jq._QuantizeState(kv, True, False)
    ft = jq.FTYPE_NAMES[ftype]
    kinds = {}
    for name, kind, ne in seen:
        np_shape = tuple(reversed(ne))
        if name.endswith("ffn_gate_inp.weight"):
            # llama.cpp leaves the router f32; the JAX quantizer quantizes it
            # (ROADMAP.md queue C): the port writes what llama.cpp writes
            assert kind == TGGMLType.F32, name
            continue
        if not jq.should_quantize(name, np_shape):
            assert kind == TGGMLType.F32, name
            continue
        want = jq.tensor_get_type(state, jq.FTYPE_DEFAULT_TYPE[ft], name, ne[0], ft)
        assert int(kind) == int(want), (name, kind, want)
        kinds.setdefault(name.split(".")[-2], []).append(kind)
    down = kinds["ffn_down_exps"]
    if ftype == "Q4_K_M":  # the mix ROADMAP.md and PERF.md describe
        assert (down.count(TGGMLType.Q5_0), down.count(TGGMLType.Q8_0)) == (14, 12)
        assert kinds["ffn_down"] == [TGGMLType.Q8_0]
        assert set(kinds["ffn_down_shexp"]) == {TGGMLType.Q4_K, TGGMLType.Q6_K}
    else:
        assert (down.count(TGGMLType.Q5_1), down.count(TGGMLType.Q8_0)) == (14, 12)
    assert kinds["output"] == [TGGMLType.Q6_K]


def test_engine_two_slots_match_b1_forwards(ds_gguf):
    """Two requests decoding together in the engine (per-slot prefill, then
    batched decode steps over B10's and B9's plain versions) give the
    greedy streams of B=1 forwards over contiguous caches, each prompt
    prefilled as the engine pads it; with -ctk q8_0 the latent rows are
    quantized and attention takes the einsum path, as in JAX."""
    from llama_cpp_dsp_tpu_torch.models.llama import forward
    from llama_cpp_dsp_tpu_torch.runtime.engine import Engine, Request
    from llama_cpp_dsp_tpu_torch.runtime.kv_cache import make_kv_cache
    from llama_cpp_dsp_tpu_torch.runtime.loader import load_model

    model = load_model(ds_gguf)
    eng = Engine(model, n_slots=2, n_ctx_per_slot=64, prefill_buckets=(8, 32), device="cpu")
    assert not eng._mixed_ok
    cfg, params = eng.cfg, eng.params
    prompts = [[1792, 300, 40, 7, 9], [1792, 301, 43, 7, 10, 11, 12]]
    reqs = [eng.submit(Request(0, p, max_new_tokens=6, sampler=make_chain(temp=0)))
            for p in prompts]
    while not all(r.done.is_set() for r in reqs):
        eng.step()

    def b1(prompt, kv="bf16"):
        cache = make_kv_cache(cfg.n_layers, 1, 64, cfg.kv_cache_heads, cfg.kv_cache_dim, kv)
        n, t = len(prompt), 8  # the engine's bucket: padding at position n_past (0)
        toks = torch.zeros(1, t, dtype=torch.long)
        toks[0, :n] = torch.tensor(prompt)
        pos = torch.zeros(1, t, dtype=torch.int32)
        pos[0, :n] = torch.arange(n)
        out = [int(forward(params, cfg, toks, pos, cache, 0)[0, n - 1].argmax())]
        for i in range(5):
            logits = forward(params, cfg, torch.tensor([[out[-1]]]),
                             torch.tensor([[n + i]], dtype=torch.int32), cache, n + i)
            out.append(int(logits[0, 0].argmax()))
        return out

    for r, p in zip(reqs, prompts):
        assert r.error is None and r.result_tokens == b1(p)
    with pytest.raises(ValueError, match="paged"):
        Engine(model, n_slots=2, n_ctx_per_slot=64, kv_layout="paged", device="cpu")
    eng = Engine(model, n_slots=2, n_ctx_per_slot=64, prefill_buckets=(8, 32), kv_dtype="q8_0",
                 device="cpu")
    req = eng.generate_sync(prompts[0], max_new_tokens=6, sampler=make_chain(temp=0))
    assert req.error is None and req.result_tokens == b1(prompts[0], "q8_0")


def test_forward_packed_refuses_mla(ds_gguf):
    from llama_cpp_dsp_tpu_torch.models.llama import forward_packed
    from llama_cpp_dsp_tpu_torch.runtime.loader import load_model

    model = load_model(ds_gguf)
    with pytest.raises(NotImplementedError, match="MLA"):
        forward_packed(model.params, model.cfg, torch.zeros(4, dtype=torch.long),
                       torch.zeros(4, dtype=torch.long), torch.zeros(4, dtype=torch.long),
                       None, torch.zeros(1, dtype=torch.long))


def test_yarn_scale_handling_follows_jax(ds_gguf):
    """Fence: the port copies the JAX package's DeepSeek-V2 YaRN handling,
    which differs from upstream llama.cpp's (ROADMAP.md queue C): the roped
    q / k lanes carry the YaRN mscale 1 + 0.1·ln(factor) (JAX ops/rope.py),
    the KQ scale is attn_factor² / √(dn + dr) with attn_factor 1, and
    rope.scaling.yarn_log_multiplier is not read. A change to any of these
    must move the JAX reference too."""
    from llama_cpp_dsp_tpu.runtime.loader import load_model as jax_load_model
    from llama_cpp_dsp_tpu_torch.ops.rope import _rope_angles
    from llama_cpp_dsp_tpu_torch.runtime.loader import load_model

    pm, jm = load_model(ds_gguf), jax_load_model(ds_gguf)
    rp = pm.cfg.rope
    assert rp.attn_factor == jm.cfg.rope.attn_factor == 1.0
    assert not any("yarn_log" in f.name for f in dataclasses.fields(pm.cfg))
    cos, sin = _rope_angles(torch.tensor([5.0]), rp, None)
    mscale = 1.0 + 0.1 * math.log(1.0 / rp.freq_scale)  # 1.3689 at factor 40
    torch.testing.assert_close(cos * cos + sin * sin, torch.full_like(cos, mscale ** 2))


def test_selection_bias_loads_and_steers_like_jax(tmp_path, monkeypatch):
    """A DeepSeek-V3-style deepseek2 GGUF: sigmoid routers (gating func 2)
    and a selection bias `blk.N.exp_probs_b.bias`. Both packages' loaders
    map the bias to `ffn_exp_probs_b`; an MoE layer given the same input
    selects the same experts (its output agrees with JAX's, and moves when
    the bias is dropped); the model's logits agree with JAX's."""
    import jax
    import jax.numpy as jnp

    from llama_cpp_dsp_tpu.models.llama import ffn_moe as jax_ffn_moe
    from llama_cpp_dsp_tpu.runtime.loader import load_model as jax_load_model
    from llama_cpp_dsp_tpu_torch.models.llama import ffn_moe
    from llama_cpp_dsp_tpu_torch.runtime.loader import load_model

    rng = np.random.default_rng(8)

    class Writer(synth.GGUFWriter):
        def add_tensor(self, name, data, **kw):
            super().add_tensor(name, data, **kw)
            if name.endswith("ffn_gate_inp.weight"):
                super().add_tensor(name.replace("ffn_gate_inp.weight", "exp_probs_b.bias"),
                                   (rng.standard_normal(TINY.n_expert) * 0.5).astype(np.float32))

    monkeypatch.setattr(synth, "GGUFWriter", Writer)
    path = str(tmp_path / "tiny-ds-v3.gguf")
    synth.write_synth_gguf(path, dataclasses.replace(TINY, expert_gating="sigmoid"), "Q4_K_M",
                           seed=3, vocab="deepseek-llm", experts=TINY_EXPERTS)
    pm, jm = load_model(path), jax_load_model(path)
    assert pm.cfg.expert_gating == jm.cfg.expert_gating == "sigmoid"
    for i in (1, 2):
        np.testing.assert_array_equal(pm.params["layers"][i]["ffn_exp_probs_b"].numpy(),
                                      np.asarray(jm.params["layers"][i]["ffn_exp_probs_b"]))
    x = rng.standard_normal((1, 1, TINY.n_embd)).astype(np.float32)
    want = np.asarray(jax.jit(jax_ffn_moe, static_argnums=(2, 3))(
        jnp.asarray(x), jm.params["layers"][1], jm.cfg, jnp.bfloat16))
    layer = pm.params["layers"][1]
    got = ffn_moe(torch.from_numpy(x), layer, pm.cfg).float().numpy()
    unbiased = {k: w for k, w in layer.items() if k != "ffn_exp_probs_b"}
    moved = ffn_moe(torch.from_numpy(x), unbiased, pm.cfg).float().numpy()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() / scale < 1e-2
    assert np.abs(moved - want).max() / scale > 0.1
    from llama_cpp_dsp_tpu.runtime.context import LlamaContext as JaxContext
    from llama_cpp_dsp_tpu_torch.runtime.context import LlamaContext

    ctx = LlamaContext(pm, n_ctx=64, device="cpu")
    jctx = JaxContext(jm, n_ctx=64, use_pallas=False)
    for toks in ([1792, 300, 40, 7, 9], [11]):  # a prefill, then a decode step
        got, want = ctx.eval_tokens(toks), np.asarray(jctx.eval_tokens(toks))
        assert np.abs(got - want).max() / np.abs(want).max() < LOGIT_RTOL
