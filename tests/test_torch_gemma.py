"""The port's Gemma family (gemma, gemma2, gemma3) against the JAX package on
the CPU.

- Unit-size GGUFs (`tools/synth.py::unit_config`: width 256, head_dim 256,
  two query heads over one KV head, so the q width 512 differs from n_embd;
  a 16-row window; gemma3 with 6 layers, one of them full attention; the
  Gemma SPM vocab and chat template) written by the port's
  `write_synth_gguf`: both registries give the same config (GeGLU, tied
  embeddings, √n_embd embedding scale, post norms, softcaps, the window and
  its pattern, gemma3's local rope base and linear ×8 scaling), both loaders
  the same weights (the post norms, no output.weight).
- Logits of a 34-token prefill (through the window) and four decode steps
  against JAX's forward, and negative controls that must fail the
  tolerance: gemma2 without its softcaps (and without its attention softcap
  alone), gemma3 with one rope base for all layers, the window taken away.
- Greedy streams against JAX's LlamaContext (LLAMA_TPU_DECODE_CHUNK=1), a
  packed prompt+decode step against JAX's `forward_packed` and an engine
  stream against JAX's engine, on the unit gemma2 (SWA + softcaps through
  the packed path, as tests/test_mixed_batch.py runs JAX's gemma2 flags).
- The Gemma vocab (BOS 2, `<end_of_turn>` an end of generation) and the chat
  template (rendered through the builtin "gemma" family, as JAX's jinja
  renders it less the leading BOS, which the tokenizer adds).
- `tensor_type` for the tied Gemma-3-12B / Gemma-2-9B Q4_K_M files against
  JAX's tools/quantize.py (token_embd takes the LM head's Q6_K).
- The Gemma quirks the port copies from JAX (ROADMAP.md queue C): the
  embedding scale rounded to bf16, the attention scale 1/√head_dim, a
  full-length cache on SWA layers.

Tolerance: logits within 2e-2 of max|JAX logit| (as tests/test_torch_qwen.py);
greedy streams identical.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from llama_cpp_dsp_tpu_torch.ops.kernels import LAUNCHES
from llama_cpp_dsp_tpu_torch.runtime.sampling import make_chain
from llama_cpp_dsp_tpu_torch.tools import synth
from test_torch_qwen import _jax_logits, _port_logits, _recorded_tensors, _rel, _same_tree
from torch_fixtures import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

LOGIT_RTOL = 2e-2
FILES = {  # name → (arch, ftype)
    "gemma-q4_k_m": ("gemma", "Q4_K_M"),
    "gemma2-q4_k_m": ("gemma2", "Q4_K_M"),
    "gemma3-q4_k_m": ("gemma3", "Q4_K_M"),
    "gemma3-q4_0": ("gemma3", "Q4_0"),
}
# BOS, then 33 tokens: a 34-token prompt crosses the 16-row window twice
TOKENS = [2, 300, 72, 101, 108, 108, 111, 33, 200, 7, *range(400, 424), 5, 9, 11, 13]
N_PREFILL = 34


@pytest.fixture(scope="module")
def ggufs(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_gemma")
    paths = {}
    for name, (arch, ftype) in FILES.items():
        paths[name] = str(root / f"{name}.gguf")
        synth.write_synth_gguf(paths[name], synth.unit_config(arch), ftype, seed=3,
                               vocab="gemma")
    return paths


@pytest.fixture(scope="module")
def models(ggufs):
    from llama_cpp_dsp_tpu.runtime.loader import load_model as jax_load_model
    from llama_cpp_dsp_tpu_torch.runtime.loader import load_model

    return {name: (load_model(p), jax_load_model(p)) for name, p in ggufs.items()}


@pytest.fixture(scope="module")
def jax_logits(models):
    """name → JAX's logits of TOKENS (a 34-token prefill, four decode
    steps), computed once a module: the parity test and the negative
    controls of a model share them."""
    memo = {}

    def get(name):
        if name not in memo:
            memo[name] = _jax_logits(models[name][1], TOKENS, N_PREFILL)
        return memo[name]

    return get


_CFG_FIELDS = ("arch", "n_layers", "n_embd", "n_heads", "n_kv_heads", "head_dim", "n_ff",
               "n_vocab", "n_ctx_train", "rms_eps", "qk_norm", "act", "tie_embeddings",
               "embd_scale", "attn_logit_softcap", "final_logit_softcap", "post_norms",
               "swa_window", "swa_pattern", "rope_local_base")
_ROPE_FIELDS = ("n_dims", "mode", "freq_base", "freq_scale", "ext_factor", "n_ctx_orig")


@pytest.mark.parametrize("name", ["gemma-q4_k_m", "gemma2-q4_k_m", "gemma3-q4_k_m"])
def test_config_matches_jax(ggufs, name):
    from llama_cpp_dsp_tpu.models.llama import _layer_rope
    from llama_cpp_dsp_tpu.models.registry import config_from_gguf as jax_config
    from llama_cpp_dsp_tpu_torch.gguf.reader import GGUFModel
    from llama_cpp_dsp_tpu_torch.models.registry import config_from_gguf

    kv = GGUFModel.load(ggufs[name]).kv
    ours, theirs = config_from_gguf(kv), jax_config(kv)
    for f in _CFG_FIELDS:
        assert getattr(ours, f) == getattr(theirs, f), f
    for il in range(ours.n_layers):
        assert ours.is_swa_layer(il) == theirs.is_swa_layer(il)
        for f in _ROPE_FIELDS:
            assert getattr(ours.layer_rope(il), f) == getattr(_layer_rope(theirs, il), f), f
    arch = FILES[name][0]
    # the writer's keys round-trip (rms eps through an f32 key)
    assert ours == dataclasses.replace(synth.unit_config(arch), rms_eps=ours.rms_eps)
    assert ours.rms_eps == pytest.approx(1e-6)
    assert (ours.rope.mode, ours.head_dim, ours.embd_scale) == ("neox", 256, 16.0)
    swa = [ours.is_swa_layer(il) for il in range(ours.n_layers)]
    assert swa == {"gemma": [False] * 2, "gemma2": [True, False],
                   "gemma3": [True] * 5 + [False]}[arch]
    if arch == "gemma3":  # SWA layers: base 1e4, no scaling; the full layer: 1e6 × 1/8
        assert ours.layer_rope(0).freq_base == 1e4 and ours.layer_rope(0).freq_scale == 1.0
        assert ours.layer_rope(5).freq_base == 1e6 and ours.layer_rope(5).freq_scale == 0.125


@pytest.mark.parametrize("name", list(FILES))
def test_gguf_loads_like_jax(models, name):
    from llama_cpp_dsp_tpu_torch.runtime.loader import params_from_numpy

    ours, theirs = models[name]
    _same_tree(ours.params, params_from_numpy(theirs.params))
    arch = FILES[name][0]
    layer = ours.params["layers"][0]
    assert "output" not in ours.params  # tied: the LM head is token_embd
    assert ("attn_post_norm" in layer and "ffn_post_norm" in layer) == (arch != "gemma")
    assert ("attn_q_norm" in layer) == (arch == "gemma3")
    assert layer["attn_q"].shape == (512, 256) and layer["attn_output"].shape == (256, 512)
    if FILES[name][1] == "Q4_K_M":  # the tied embedding takes the LM head's kind
        assert ours.params["token_embd"].kind.name == "Q6_K"


@pytest.mark.parametrize("name", list(FILES))
def test_forward_prefill_and_decode_match_jax(models, jax_logits, name):
    from llama_cpp_dsp_tpu_torch.runtime.context import convert_params_to_kernel

    pm = models[name][0]
    want = jax_logits(name)
    before = dict(LAUNCHES)
    params = convert_params_to_kernel(pm.params)
    got = _port_logits(params, pm.cfg, TOKENS, N_PREFILL)
    assert LAUNCHES == before  # CPU tensors take the plain versions
    assert got.shape == want.shape == (len(TOKENS), 2048)
    assert _rel(got, want) < LOGIT_RTOL


@pytest.mark.parametrize("name,control", [
    ("gemma2-q4_k_m", {"attn_logit_softcap": 0.0, "final_logit_softcap": 0.0}),
    ("gemma2-q4_k_m", {"attn_logit_softcap": 0.0}),
    ("gemma2-q4_k_m", {"swa_window": 0}),
    ("gemma3-q4_k_m", {"rope_local_base": 0.0}),
    ("gemma3-q4_k_m", {"swa_window": 0}),
])
def test_negative_controls_fail_the_tolerance(models, jax_logits, name, control):
    """The flags move the logits far past the tolerance: the parity above
    would catch a port that dropped any of them."""
    from llama_cpp_dsp_tpu_torch.runtime.context import convert_params_to_kernel

    pm = models[name][0]
    want = jax_logits(name)
    cfg = dataclasses.replace(pm.cfg, **control)
    assert _rel(_port_logits(convert_params_to_kernel(pm.params), cfg, TOKENS, N_PREFILL),
                want) > 2 * LOGIT_RTOL


def test_vocab_and_chat_template_like_jax(models):
    from llama_cpp_dsp_tpu.serve.chat import apply_chat_template as jax_apply
    from llama_cpp_dsp_tpu_torch.serve.chat import apply_chat_template

    pm, jm = models["gemma3-q4_k_m"]
    msgs = [{"role": "system", "content": "Be brief."}, {"role": "user", "content": "Hi"}]
    template = pm.vocab.chat_template
    assert template == synth.GEMMA_CHAT_TEMPLATE
    text = apply_chat_template(template, msgs)
    assert text == jax_apply("gemma", msgs)
    assert "<bos>" + text == jax_apply(template, msgs, bos_token="<bos>")
    assert text == "<start_of_turn>user\nBe brief.\n\nHi<end_of_turn>\n<start_of_turn>model\n"
    ids = pm.tokenizer.encode(text, add_special=True, parse_special=True)
    assert ids == jm.tokenizer.encode(text, add_special=True, parse_special=True)
    sot, eot = (pm.vocab.text_to_token(t) for t in ("<start_of_turn>", "<end_of_turn>"))
    assert ids[:2] == [2, sot] and ids.count(eot) == 1
    assert pm.vocab.is_eog(eot) and jm.vocab.is_eog(eot)
    # <eos> (1) follows JAX's Vocab quirk (ROADMAP.md queue C): eog_ids are
    # filled from the token texts before the GGUF's eos id is read
    assert pm.vocab.eog_ids == jm.vocab.eog_ids
    assert pm.tokenizer.decode(ids) == jm.tokenizer.decode(ids)


@pytest.mark.parametrize("name", ["gemma2-q4_k_m", "gemma3-q4_k_m"])
def test_greedy_stream_matches_jax(models, name, monkeypatch):
    from llama_cpp_dsp_tpu.runtime.context import LlamaContext as JaxContext
    from llama_cpp_dsp_tpu.runtime.sampling import make_chain as jax_make_chain
    from llama_cpp_dsp_tpu_torch.runtime.context import LlamaContext
    from llama_cpp_dsp_tpu_torch.serve.chat import apply_chat_template

    monkeypatch.setenv("LLAMA_TPU_DECODE_CHUNK", "1")
    pm, jm = models[name]
    text = apply_chat_template(pm.vocab.chat_template,
                               [{"role": "user", "content": "hello world, what is new?"}])
    prompt = pm.tokenizer.encode(text, add_special=True, parse_special=True)
    assert len(prompt) > 16  # past the window
    # a random model with a √n_embd-scaled tied embedding keeps emitting the
    # token it was fed (the input row dominates the last hidden state and
    # the LM head is the same matrix), in JAX as in the port: the stream
    # holds the first token, the decode loop and the stop rules
    want = list(JaxContext(jm, n_ctx=64).generate(prompt, max_new_tokens=10,
                                                  sampler=jax_make_chain(temp=0)))
    ctx = LlamaContext(pm, n_ctx=64, device="cpu")
    assert list(ctx.generate(prompt, max_new_tokens=10, sampler=make_chain(temp=0))) == want


def test_packed_step_matches_jax(models):
    """One packed prompt+decode step of the unit gemma2 (slots 0 and 1
    decode past their 20- and 5-row histories, slot 2 feeds an 18-token
    prompt: the window and both softcaps inside the packed path) against
    JAX's forward_packed, each package starting from its own prefills."""
    import jax.numpy as jnp

    from llama_cpp_dsp_tpu.models.llama import forward as jax_forward
    from llama_cpp_dsp_tpu.models.llama import forward_packed as jax_forward_packed
    from llama_cpp_dsp_tpu.runtime.kv_cache import KVCache as JaxKVCache
    from llama_cpp_dsp_tpu.runtime.kv_cache import causal_mask as jax_mask
    from llama_cpp_dsp_tpu_torch.models.llama import forward, forward_packed
    from llama_cpp_dsp_tpu_torch.runtime.kv_cache import KVCache

    pm, jm = models["gemma2-q4_k_m"]
    cfg, n_ctx = pm.cfg, 64
    rng = np.random.default_rng(4)
    hists = [list(rng.integers(300, 2000, n)) for n in (20, 5)]
    prompt2 = list(rng.integers(300, 2000, 18))
    nxt = [7, 9]
    cache = KVCache.create(cfg.n_layers, 3, n_ctx, cfg.n_kv_heads, cfg.head_dim)
    jcache = JaxKVCache.create(cfg.n_layers, 3, n_ctx, cfg.n_kv_heads, cfg.head_dim)
    for slot, hist in enumerate(hists):
        n = len(hist)
        forward(pm.params, cfg, torch.tensor([hist]), torch.arange(n)[None].int(),
                cache.slot(slot), 0)
        pos = jnp.arange(n, dtype=jnp.int32)[None]
        sub = jcache.slot_view(jnp.int32(slot))
        _, sub = jax_forward(jm.params, jm.cfg, jnp.asarray([hist], jnp.int32), pos, sub, 0,
                             jax_mask(pos, n_ctx, 0))
        jcache = jcache.merge_slot(sub, jnp.int32(slot))
    p = 24
    toks = np.zeros(p, np.int64)
    slots = np.zeros(p, np.int64)
    rows = np.full(p, n_ctx, np.int64)
    toks[:2], slots[:2], rows[:2] = nxt, [0, 1], [len(h) for h in hists]
    toks[2:20], slots[2:20], rows[2:20] = prompt2, 2, np.arange(18)
    out_idx = np.array([0, 1, 19])
    got = forward_packed(pm.params, cfg, *(torch.from_numpy(a) for a in (toks, slots, rows)),
                         cache, torch.from_numpy(out_idx)).numpy()
    want, _ = jax_forward_packed(jm.params, jm.cfg, *(jnp.asarray(a, jnp.int32) for a in (
        toks, slots, rows)), jcache, jnp.asarray(out_idx, jnp.int32))
    assert got.shape == (3, 2048)
    assert _rel(got, np.asarray(want)) < LOGIT_RTOL


def test_engine_stream_matches_jax_engine(models):
    from llama_cpp_dsp_tpu.runtime.engine import Engine as JaxEngine
    from llama_cpp_dsp_tpu.runtime.engine import Request as JaxRequest
    from llama_cpp_dsp_tpu.runtime.sampling import make_chain as jax_make_chain
    from llama_cpp_dsp_tpu_torch.runtime.engine import Engine, Request

    pm, jm = models["gemma2-q4_k_m"]
    kw = dict(n_slots=2, n_ctx_per_slot=64, prefill_buckets=(16,))
    long_prompt = [2, *range(500, 520)]  # 21 tokens: two prefill chunks, past the window

    def script(engine, req_cls, chain):
        r1 = engine.submit(req_cls(0, long_prompt, max_new_tokens=8, sampler=chain(temp=0)))
        while len(r1.result_tokens) < 2:
            engine.step()
        r2 = engine.submit(req_cls(0, [2, 400, 7, 8], max_new_tokens=6, sampler=chain(temp=0)))
        while not (r1.done.is_set() and r2.done.is_set()):
            engine.step()
        return [(r.result_tokens, r.stop_reason, r.error) for r in (r1, r2)]

    want = script(JaxEngine(jm, use_pallas=False, decode_chunk=1, context_shift=False, **kw),
                  JaxRequest, jax_make_chain)
    got = script(Engine(pm, device="cpu", **kw), Request, make_chain)
    assert got == want and len(got[0][0]) == 8


@pytest.mark.parametrize("model", ["gemma3-12b", "gemma2-9b"])
def test_tied_tensor_types_match_jax_quantize(monkeypatch, model):
    from llama_cpp_dsp_tpu.tools import quantize as jq
    from llama_cpp_dsp_tpu_torch.gguf.constants import GGMLType

    cfg = synth.CONFIGS[model]
    seen = _recorded_tensors(monkeypatch, cfg, "Q4_K_M")
    assert "output.weight" not in [name for name, _, _ in seen]
    a = cfg.arch
    kv = {"general.architecture": a, f"{a}.block_count": cfg.n_layers,
          f"{a}.attention.head_count": cfg.n_heads, f"{a}.attention.head_count_kv": cfg.n_kv_heads}
    state = jq._QuantizeState(kv, False, False)  # no output tensor
    ft = jq.FTYPE_NAMES["Q4_K_M"]
    kinds = {}
    for name, kind, ne in seen:
        if not jq.should_quantize(name, tuple(reversed(ne))):
            assert kind == GGMLType.F32, name
            continue
        want = jq.tensor_get_type(state, jq.FTYPE_DEFAULT_TYPE[ft], name, ne[0], ft)
        assert int(kind) == int(want), (name, kind, want)
        kinds.setdefault(name.split(".")[-2], []).append(kind.name)
    assert kinds["token_embd"] == ["Q6_K"]
    assert set(kinds["attn_q"]) == {"Q4_K"} and set(kinds["attn_v"]) == {"Q4_K", "Q6_K"}


def test_gemma_quirks_follow_jax(models):
    """Fenced quirks (ROADMAP.md queue C), copied from JAX: (1) the embedding
    scale is rounded to bf16 before the multiply (√3840 = 61.97 → 62.0; the
    reference multiplies in f32); (2) the attention scale is 1/√head_dim
    whatever n_embd / n_heads is (the unit models' 128 against head_dim 256
    pass the parity test above; Gemma-27B's query_pre_attn_scalar is not
    read); (3) an SWA layer's cache is as long as a full layer's."""
    import jax.numpy as jnp

    from llama_cpp_dsp_tpu.runtime.context import LlamaContext as JaxContext
    from llama_cpp_dsp_tpu_torch.models.llama import _embed
    from llama_cpp_dsp_tpu_torch.runtime.context import LlamaContext

    cfg = synth.GEMMA3_12B
    assert cfg.embd_scale == math.sqrt(3840)
    assert float(jnp.asarray(cfg.embd_scale, jnp.bfloat16)) == 62.0
    rows = torch.randn(4, 8, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    got = _embed({"token_embd": rows}, cfg, torch.tensor([[3, 1]]))
    assert torch.equal(got[0], rows[[3, 1]] * torch.tensor(62.0, dtype=torch.bfloat16))
    pm, jm = models["gemma3-q4_k_m"]
    assert pm.cfg.n_embd // pm.cfg.n_heads != pm.cfg.head_dim
    ctx, jctx = LlamaContext(pm, n_ctx=64, device="cpu"), JaxContext(jm, n_ctx=64)
    assert pm.cfg.is_swa_layer(0) and not pm.cfg.is_swa_layer(5)
    assert ctx.cache.k[0].shape == ctx.cache.k[5].shape == (1, 1, 64, 256)
    assert tuple(jctx.cache.k[0].shape) == tuple(jctx.cache.k[5].shape) == (1, 1, 64, 256)
