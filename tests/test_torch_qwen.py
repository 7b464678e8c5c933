"""The port's Qwen family (qwen2, qwen3, qwen2moe, qwen3moe), mistral and
phi3 against the JAX package on the CPU.

- Unit-size GGUFs of each arch (`tools/synth.py::unit_config`: 2 layers,
  width 256, head_dim 128, the qwen2 vocab; MoE 16 experts top-4, qwen2moe
  with a sigmoid-gated shared expert) in Q3_K_M / Q2_K / Q4_0 mixes,
  written by the port's `write_synth_gguf`: both registries give the same
  config, both loaders the same weights (phi3's fused attn_qkv and gate|up
  ffn_up split alike).
- Logits of a prefill and four decode steps against JAX's forward, and a
  NORM-rope run of the qwen2 file as the negative control: the rope mode
  moves logits far past the tolerance.
- Greedy streams against JAX's LlamaContext (LLAMA_TPU_DECODE_CHUNK=1) for
  qwen2 Q3_K_M and qwen3 Q2_K, and one engine stream against JAX's engine.
- The fused decode attention kernel's gate: a layer with q/k/v biases or
  with q/k norm never takes it; a q/k norm weight without the flag stays
  unused (JAX's rule).
- The port's `tensor_type` against JAX's tools/quantize.py for every tensor
  of Qwen2.5-7B Q3_K_M and Qwen3-8B Q2_K (names and shapes only).

Tolerance: logits within 2e-2 of max|JAX logit| (as tests/test_torch_model.py);
greedy streams identical.
"""

import dataclasses

import numpy as np
import pytest
import torch

from llama_cpp_dsp_tpu_torch.gguf.constants import GGMLType as TGGMLType
from llama_cpp_dsp_tpu_torch.ops.kernels import LAUNCHES
from llama_cpp_dsp_tpu_torch.runtime.sampling import make_chain
from llama_cpp_dsp_tpu_torch.tools import synth
from torch_fixtures import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

LOGIT_RTOL = 2e-2
FILES = {  # name → (arch, ftype)
    "qwen2-q3_k_m": ("qwen2", "Q3_K_M"),
    "qwen2-q4_0": ("qwen2", "Q4_0"),  # q|k|v row-fused, the biases added after the split
    "qwen3-q2_k": ("qwen3", "Q2_K"),
    "qwen2moe-q2_k": ("qwen2moe", "Q2_K"),
    "qwen3moe-q3_k_m": ("qwen3moe", "Q3_K_M"),
    "mistral-q4_0": ("mistral", "Q4_0"),
    "phi3-q3_k_m": ("phi3", "Q3_K_M"),
}
ARCH_FILES = ["qwen2-q3_k_m", "qwen3-q2_k", "qwen2moe-q2_k", "qwen3moe-q3_k_m", "mistral-q4_0",
              "phi3-q3_k_m"]
TOKENS = [1792, 72, 101, 108, 108, 111, 33, 200, 7]
N_PREFILL = 5


@pytest.fixture(scope="module")
def ggufs(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_qwen")
    paths = {}
    for name, (arch, ftype) in FILES.items():
        paths[name] = str(root / f"{name}.gguf")
        synth.write_synth_gguf(paths[name], synth.unit_config(arch), ftype, seed=3,
                               vocab="qwen2", experts=synth.UNIT_EXPERTS)
    return paths


@pytest.fixture(scope="module")
def models(ggufs):
    from llama_cpp_dsp_tpu.runtime.loader import load_model as jax_load_model
    from llama_cpp_dsp_tpu_torch.runtime.loader import load_model

    return {name: (load_model(p), jax_load_model(p)) for name, p in ggufs.items()}


_CFG_FIELDS = ("arch", "n_layers", "n_embd", "n_heads", "n_kv_heads", "head_dim", "n_ff",
               "n_vocab", "n_ctx_train", "rms_eps", "n_expert", "n_expert_used",
               "moe_norm_weights", "moe_shared_expert", "moe_gate_shexp", "expert_gating",
               "moe_scale", "qk_norm")
_ROPE_FIELDS = ("n_dims", "mode", "freq_base", "freq_scale", "ext_factor", "n_ctx_orig")


@pytest.mark.parametrize("name", ARCH_FILES)
def test_config_matches_jax(ggufs, name):
    from llama_cpp_dsp_tpu.models.registry import config_from_gguf as jax_config
    from llama_cpp_dsp_tpu_torch.gguf.reader import GGUFModel
    from llama_cpp_dsp_tpu_torch.models.registry import config_from_gguf

    kv = GGUFModel.load(ggufs[name]).kv
    ours, theirs = config_from_gguf(kv), jax_config(kv)
    for f in _CFG_FIELDS:
        assert getattr(ours, f) == getattr(theirs, f), f
    for f in _ROPE_FIELDS:
        assert getattr(ours.rope, f) == getattr(theirs.rope, f), f
    arch = FILES[name][0]
    assert ours.rope.mode == ("norm" if arch == "mistral" else "neox")
    assert ours.qk_norm == (arch in ("qwen3", "qwen3moe"))
    if arch == "qwen2moe":  # no renormalisation, a sigmoid-gated shared expert
        assert (ours.moe_norm_weights, ours.moe_shared_expert, ours.moe_gate_shexp) == (
            False, True, True)


def _same_tree(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same_tree(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b, strict=True):
            _same_tree(x, y)
    elif hasattr(a, "arrays"):
        assert (a.kind, a.shape, a.n_expert, a.arrays.keys()) == (
            b.kind, b.shape, b.n_expert, b.arrays.keys())
        for k in a.arrays:
            assert torch.equal(a.arrays[k], b.arrays[k]), k
    else:
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", ARCH_FILES)
def test_gguf_loads_like_jax(models, name):
    from llama_cpp_dsp_tpu_torch.runtime.loader import params_from_numpy

    ours, theirs = models[name]
    _same_tree(ours.params, params_from_numpy(theirs.params))
    layer = ours.params["layers"][0]
    arch = FILES[name][0]
    assert ("attn_q_bias" in layer) == (arch in ("qwen2", "qwen2moe"))
    assert ("attn_q_norm" in layer) == (arch in ("qwen3", "qwen3moe"))
    if arch == "phi3":  # fused in the file, split by the loader
        assert layer["attn_q"].shape == (256, 256) and layer["ffn_gate"].shape == (512, 256)


def test_split_fused_qkv_and_bias_like_jax(models):
    """A fused attn_qkv weight and its attn_qkv.bias (llama.cpp's qwen and
    phi2 files carry both) split into the q / k / v rows as JAX splits them."""
    from llama_cpp_dsp_tpu.models.registry import arch_spec as jax_arch_spec
    from llama_cpp_dsp_tpu.runtime.loader import _split_fused as jax_split_fused
    from llama_cpp_dsp_tpu_torch.models.registry import arch_spec
    from llama_cpp_dsp_tpu_torch.runtime.loader import _split_fused

    pm, jm = models["qwen2-q4_0"]
    rng = np.random.default_rng(5)
    rows = (pm.cfg.n_heads + 2 * pm.cfg.n_kv_heads) * pm.cfg.head_dim
    w = rng.standard_normal((rows, pm.cfg.n_embd)).astype(np.float32)
    b = rng.standard_normal(rows).astype(np.float32)
    theirs = {"layers": [{"attn_qkv": w, "attn_qkv_bias": b}]}
    ours = {"layers": [{"attn_qkv": torch.from_numpy(w), "attn_qkv_bias": torch.from_numpy(b)}]}
    jax_split_fused(theirs, jm.cfg, jax_arch_spec("qwen2"))
    _split_fused(ours, pm.cfg, arch_spec("qwen2"))
    assert sorted(ours["layers"][0]) == sorted(theirs["layers"][0]) == [
        "attn_k", "attn_k_bias", "attn_q", "attn_q_bias", "attn_v", "attn_v_bias"]
    for key, a in theirs["layers"][0].items():
        np.testing.assert_array_equal(ours["layers"][0][key].numpy(), a)


def _jax_logits(jm, tokens, n_prefill):
    import jax.numpy as jnp

    from llama_cpp_dsp_tpu.models.llama import forward as jax_forward
    from llama_cpp_dsp_tpu.runtime.kv_cache import KVCache, causal_mask

    cfg = jm.cfg
    cache = KVCache.create(cfg.n_layers, 1, 64, cfg.n_kv_heads, cfg.head_dim)
    outs = []
    for lo, hi in ((0, n_prefill), *((i, i + 1) for i in range(n_prefill, len(tokens)))):
        pos = jnp.arange(lo, hi, dtype=jnp.int32)[None]
        logits, cache = jax_forward(jm.params, cfg, jnp.asarray([tokens[lo:hi]], jnp.int32), pos,
                                    cache, lo, causal_mask(pos, 64, lo))
        outs.append(np.asarray(logits[0]))
    return np.concatenate(outs)


def _port_logits(params, cfg, tokens, n_prefill):
    from llama_cpp_dsp_tpu_torch.models.llama import forward
    from llama_cpp_dsp_tpu_torch.runtime.kv_cache import KVCache

    cache = KVCache.create(cfg.n_layers, 1, 64, cfg.n_kv_heads, cfg.head_dim)
    outs = []
    for lo, hi in ((0, n_prefill), *((i, i + 1) for i in range(n_prefill, len(tokens)))):
        pos = torch.arange(lo, hi, dtype=torch.int32)[None]
        outs.append(forward(params, cfg, torch.tensor([tokens[lo:hi]]), pos, cache, lo)[0].numpy())
    return np.concatenate(outs)


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("name", list(FILES))
def test_forward_prefill_and_decode_match_jax(models, name):
    from llama_cpp_dsp_tpu_torch.runtime.context import convert_params_to_kernel

    pm, jm = models[name]
    want = _jax_logits(jm, TOKENS, N_PREFILL)
    before = dict(LAUNCHES)
    params = convert_params_to_kernel(pm.params)
    got = _port_logits(params, pm.cfg, TOKENS, N_PREFILL)
    assert LAUNCHES == before  # CPU tensors take the plain versions
    assert got.shape == want.shape == (len(TOKENS), 2048)
    assert _rel(got, want) < LOGIT_RTOL
    if name == "qwen2-q4_0":  # all-Q4_0: q|k|v fused into one weight, biases kept apart
        assert "attn_qkv_fused" in params["layers"][0] and "attn_q_bias" in params["layers"][0]
    if name == "qwen2-q3_k_m":  # the negative control: the same file with NORM rope
        norm = dataclasses.replace(pm.cfg, rope=dataclasses.replace(pm.cfg.rope, mode="norm"))
        assert _rel(_port_logits(params, norm, TOKENS, N_PREFILL), want) > 5 * LOGIT_RTOL


@pytest.mark.parametrize("name", ["qwen2-q3_k_m", "qwen3-q2_k"])
def test_greedy_stream_matches_jax(models, name, monkeypatch):
    from llama_cpp_dsp_tpu.runtime.context import LlamaContext as JaxContext
    from llama_cpp_dsp_tpu.runtime.sampling import make_chain as jax_make_chain
    from llama_cpp_dsp_tpu_torch.runtime.context import LlamaContext

    monkeypatch.setenv("LLAMA_TPU_DECODE_CHUNK", "1")
    pm, jm = models[name]
    prompt = pm.tokenizer.encode("<|im_start|>user\nhello world<|im_end|>", add_special=True,
                                 parse_special=True)
    assert prompt == jm.tokenizer.encode("<|im_start|>user\nhello world<|im_end|>",
                                         add_special=True, parse_special=True)
    assert prompt[0] == 2048 - 256 + 1  # <|im_start|>; the qwen2 vocab adds no BOS
    want = list(JaxContext(jm, n_ctx=64).generate(prompt, max_new_tokens=10,
                                                  sampler=jax_make_chain(temp=0)))
    assert len(set(want)) >= 3  # not a degenerate stream
    ctx = LlamaContext(pm, n_ctx=64, device="cpu")
    assert list(ctx.generate(prompt, max_new_tokens=10, sampler=make_chain(temp=0))) == want


def test_engine_stream_matches_jax_engine(models):
    from llama_cpp_dsp_tpu.runtime.engine import Engine as JaxEngine
    from llama_cpp_dsp_tpu.runtime.engine import Request as JaxRequest
    from llama_cpp_dsp_tpu.runtime.sampling import make_chain as jax_make_chain
    from llama_cpp_dsp_tpu_torch.runtime.engine import Engine, Request

    pm, jm = models["qwen2-q3_k_m"]
    kw = dict(n_slots=2, n_ctx_per_slot=64, prefill_buckets=(16,))

    def script(engine, req_cls, chain):
        r1 = engine.submit(req_cls(0, [1793, 300, 301, 302, 7, 9, 11], max_new_tokens=8,
                                   sampler=chain(temp=0)))
        while len(r1.result_tokens) < 2:
            engine.step()
        r2 = engine.submit(req_cls(0, [1793, 400, 7, 8], max_new_tokens=6, sampler=chain(temp=0)))
        while not (r1.done.is_set() and r2.done.is_set()):
            engine.step()
        return [(r.result_tokens, r.stop_reason, r.error) for r in (r1, r2)]

    want = script(JaxEngine(jm, use_pallas=False, decode_chunk=1, context_shift=False, **kw),
                  JaxRequest, jax_make_chain)
    got = script(Engine(pm, device="cpu", **kw), Request, make_chain)
    assert got == want and len(got[0][0]) == 8


def test_fused_attention_gate(models):
    """The fused decode attention kernel (B3) takes neither a biased layer nor
    one with q/k norm (JAX llama.py:487-491): a qwen2 Q4_0 layer, its rope
    set to NORM so that only the bias stands in the way, takes it once the
    biases are gone; with cfg.qk_norm it does not."""
    from llama_cpp_dsp_tpu_torch.models.llama import _try_attn_fused
    from llama_cpp_dsp_tpu_torch.runtime.context import convert_params_to_kernel
    from llama_cpp_dsp_tpu_torch.runtime.kv_cache import KVCache

    pm, _ = models["qwen2-q4_0"]
    cfg = dataclasses.replace(pm.cfg, rope=dataclasses.replace(pm.cfg.rope, mode="norm"))
    layer = convert_params_to_kernel(pm.params)["layers"][0]
    x = torch.randn(1, 1, cfg.n_embd, generator=torch.Generator().manual_seed(0))
    pos = torch.tensor([[3]], dtype=torch.int32)

    def attempt(layer, cfg):
        cache = KVCache.create(cfg.n_layers, 1, 64, cfg.n_kv_heads, cfg.head_dim)
        return _try_attn_fused(x, layer, cfg, pos, cache, 0, 3, {})

    assert attempt(layer, cfg) is None
    unbiased = {k: w for k, w in layer.items() if not k.endswith("_bias")}
    assert attempt(unbiased, cfg) is not None
    assert attempt(unbiased, dataclasses.replace(cfg, qk_norm=True)) is None


def test_qk_norm_weight_unused_without_the_flag(tmp_path, monkeypatch):
    """A llama file that carries attn_q_norm / attn_k_norm loads (both
    loaders map the tensors) and runs as if they were absent: only
    cfg.qk_norm applies them, as in JAX."""
    from llama_cpp_dsp_tpu.runtime.loader import load_model as jax_load_model
    from llama_cpp_dsp_tpu_torch.runtime.loader import load_model

    cfg = dataclasses.replace(synth.unit_config("mistral"), arch="llama")
    plain = str(tmp_path / "llama.gguf")
    synth.write_synth_gguf(plain, cfg, "Q4_0", seed=4, vocab="qwen2")
    rng = np.random.default_rng(0)

    class Writer(synth.GGUFWriter):
        def add_tensor(self, name, data, **kw):
            super().add_tensor(name, data, **kw)
            if name.endswith("attn_v.weight"):
                for part in ("q", "k"):
                    super().add_tensor(name.replace("attn_v.weight", f"attn_{part}_norm.weight"),
                                       rng.random(cfg.head_dim).astype(np.float32) * 3)

    monkeypatch.setattr(synth, "GGUFWriter", Writer)
    normed = str(tmp_path / "llama-qk-norm.gguf")
    synth.write_synth_gguf(normed, cfg, "Q4_0", seed=4, vocab="qwen2")
    pm, base = load_model(normed), load_model(plain)
    assert "attn_q_norm" in pm.params["layers"][0] and not pm.cfg.qk_norm
    got = _port_logits(pm.params, pm.cfg, TOKENS, N_PREFILL)
    np.testing.assert_array_equal(got, _port_logits(base.params, base.cfg, TOKENS, N_PREFILL))
    assert _rel(got, _jax_logits(jax_load_model(normed), TOKENS, N_PREFILL)) < LOGIT_RTOL


def _recorded_tensors(monkeypatch, cfg, ftype):
    """(name, kind, ne shape) of every tensor write_synth_gguf emits for
    `cfg`, with the writer replaced by a recorder (no tensor is made)."""
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
    synth.write_synth_gguf("unused.gguf", cfg, ftype, vocab="qwen2")
    return seen


@pytest.mark.parametrize("model,ftype", [("qwen2.5-7b", "Q3_K_M"), ("qwen3-8b", "Q2_K")])
def test_tensor_types_match_jax_quantize(monkeypatch, model, ftype):
    from llama_cpp_dsp_tpu.tools import quantize as jq

    cfg = synth.CONFIGS[model]
    seen = _recorded_tensors(monkeypatch, cfg, ftype)
    a = cfg.arch
    kv = {"general.architecture": a, f"{a}.block_count": cfg.n_layers,
          f"{a}.attention.head_count": cfg.n_heads, f"{a}.attention.head_count_kv": cfg.n_kv_heads}
    state = jq._QuantizeState(kv, True, False)
    ft = jq.FTYPE_NAMES[ftype]
    kinds = {}
    for name, kind, ne in seen:
        if not jq.should_quantize(name, tuple(reversed(ne))):
            assert kind == TGGMLType.F32, name
            continue
        want = jq.tensor_get_type(state, jq.FTYPE_DEFAULT_TYPE[ft], name, ne[0], ft)
        assert int(kind) == int(want), (name, kind, want)
        kinds.setdefault(name.split(".")[-2], []).append(kind.name)
    if ftype == "Q3_K_M":  # the mix ROADMAP.md and PERF.md describe
        assert kinds["attn_v"] == ["Q5_K"] * 2 + ["Q4_K"] * 26
        assert kinds["ffn_down"] == ["Q5_K"] + ["Q4_K"] * 27
        assert {*kinds["attn_q"], *kinds["ffn_up"], *kinds["token_embd"]} == {"Q3_K"}
        assert set(kinds["attn_output"]) == {"Q4_K"}
    else:
        assert set(kinds["attn_v"]) == {"Q4_K"}  # n_gqa 4
        assert {*kinds["ffn_down"], *kinds["attn_output"]} == {"Q3_K"}
        assert {*kinds["attn_q"], *kinds["ffn_gate"], *kinds["token_embd"]} == {"Q2_K"}
    assert kinds["output"] == ["Q6_K"]
