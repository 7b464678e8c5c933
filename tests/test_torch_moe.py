"""The port's MoE path against the JAX package on the CPU.

- `qmm_expert_rows_plain` (the plain version of the selected-expert kernel,
  B9) against JAX `qmm_expert_rows` run in Pallas interpret mode on
  `to_kernel_layout_experts`, one small shape per kind; the 3-D repack
  against the JAX loader's `_convert`.
- `ffn_moe` against JAX `ffn_moe` on the same weights (carried across by
  `params_from_numpy`), at T=1 (the port takes the selected-expert branch;
  JAX without kernel layouts always takes dense-all) and T=12 (both
  dense-all), over the flags Mixtral does not use.
- A 2-layer, 4-expert Q4_K_M GGUF written by the port's `write_synth_gguf`
  through both loaders, both forwards and both greedy streams; an engine
  B=4 decode step and a packed prompt+decode step against B=1 forwards.

Tolerances: the kernel's plain version within NMSE 5e-4 of JAX's kernel and
of x · exact-f32-dequant(W)ᵀ (the reference's MUL_MAT tolerance, as
tests/test_torch_qmm.py); ffn_moe within 1e-3 of max|JAX out| (f32 sums
in another order move a bf16 rounding of the expert hidden state by one
ulp now and then); logits within 2e-2 of max|JAX logit|, as
tests/test_torch_model.py; greedy streams identical.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_cpp_dsp_tpu.gguf import GGMLType
from llama_cpp_dsp_tpu.models.llama import LlamaConfig as JaxConfig
from llama_cpp_dsp_tpu.models.llama import ffn_moe as jax_ffn_moe
from llama_cpp_dsp_tpu.ops.pallas.layouts import to_kernel_layout_experts
from llama_cpp_dsp_tpu.ops.pallas.qmm import qmm_expert_rows as jax_qmm_expert_rows
from llama_cpp_dsp_tpu.quant import quantize
from llama_cpp_dsp_tpu.quant.ref_numpy import dequantize
from llama_cpp_dsp_tpu.runtime.loader import _convert as jax_convert
from llama_cpp_dsp_tpu_torch.gguf.constants import GGMLType as TGGMLType
from llama_cpp_dsp_tpu_torch.models import llama as port_llama
from llama_cpp_dsp_tpu_torch.models.llama import LlamaConfig, ffn_moe
from llama_cpp_dsp_tpu_torch.ops.kernels import LAUNCHES
from llama_cpp_dsp_tpu_torch.ops.kernels import qmm as kqmm
from llama_cpp_dsp_tpu_torch.ops.qtensor import QTensor, repack
from llama_cpp_dsp_tpu_torch.ops.rope import RopeParams
from llama_cpp_dsp_tpu_torch.runtime.loader import params_from_numpy
from llama_cpp_dsp_tpu_torch.runtime.sampling import make_chain
from torch_fixtures import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

NMSE_TOL = 5e-4
FFN_RTOL = 1e-3
LOGIT_RTOL = 2e-2


def nmse(got, want):
    d = np.asarray(got, np.float64) - np.asarray(want, np.float64)
    return float((d * d).mean() / ((np.asarray(want, np.float64) ** 2).mean() + 1e-12))


def _stack(rng, kind, e, n, k, scale=0.1):
    """An expert stack [E, N, K] quantized by the JAX package: its raw GGUF
    bytes, the exact f32 dequant [E, N, K], the JAX QTensor (`_convert`)
    and the port's QTensor (`repack` of the 3-D shape)."""
    w = (rng.standard_normal((e * n, k)) * scale).astype(np.float32)
    raw = quantize(w, kind)
    exact = dequantize(raw, kind).reshape(e, n, k)
    return raw, exact, jax_convert(raw, kind, (e, n, k)), repack(raw, TGGMLType(int(kind)),
                                                                  (e, n, k))


@pytest.mark.parametrize("kind", [GGMLType.Q4_0, GGMLType.Q8_0, GGMLType.Q2_K, GGMLType.Q3_K,
                                  GGMLType.Q4_K, GGMLType.Q6_K])
def test_qmm_expert_rows_plain_matches_jax_kernel(kind):
    rng = np.random.default_rng(int(kind))
    e, n, k = 4, 128, 256
    raw, exact, jq, pq = _stack(rng, kind, e, n, k)
    assert pq.n_expert == e and pq.shape == (n, k)
    for name, a in jq.arrays.items():  # the 3-D repack is JAX's _convert
        assert np.array_equal(pq[name].numpy(), a), name
    x = rng.standard_normal((5, k)).astype(np.float32)
    sel = np.array([3, 0, 3, 1, 2], np.int32)  # a repeated expert, the last one
    kw = to_kernel_layout_experts(jq, tile_k=256)
    want = np.asarray(jax_qmm_expert_rows(jnp.asarray(x), kw, jnp.asarray(sel), tile_n=128))
    before = dict(LAUNCHES)
    got = kqmm.qmm_expert_rows(torch.from_numpy(x), pq, torch.from_numpy(sel))
    assert LAUNCHES == before  # a CPU tensor takes the plain version
    assert got.dtype == torch.float32 and got.shape == (5, n)
    ref = np.stack([x[i] @ exact[sel[i]].T for i in range(5)])
    assert nmse(got.numpy(), want) < NMSE_TOL
    assert nmse(got.numpy(), ref) < NMSE_TOL
    assert nmse(want, ref) < NMSE_TOL


@pytest.mark.parametrize("kind", [GGMLType.Q5_K, GGMLType.Q4_K])
def test_qmm_expert_rows_plain_is_qmm_of_the_expert(kind):
    """Row s equals qmm_plain of expert sel[s] (`expert()` views), ids are
    clamped as the kernel clamps them, and a plain qmm refuses a stack."""
    rng = np.random.default_rng(7)
    _, exact, _, pq = _stack(rng, kind, 3, 64, 512)
    x = torch.from_numpy(rng.standard_normal((4, 512)).astype(np.float32))
    sel = torch.tensor([2, 0, 5, -1], dtype=torch.int32)
    got = kqmm.qmm_expert_rows(x, pq, sel)
    for i, eid in enumerate([2, 0, 2, 0]):
        torch.testing.assert_close(got[i], kqmm.qmm_plain(x[i:i + 1], pq.expert(eid))[0])
        assert nmse(got[i].numpy(), x[i].numpy() @ exact[eid].T) < NMSE_TOL
    with pytest.raises(ValueError, match="expert stack"):
        kqmm.qmm(x, pq)
    with pytest.raises(ValueError, match="sel"):
        kqmm.qmm_expert_rows(x, pq, sel[:2])


# --------------------------------------------------------------------------
# ffn_moe against JAX
# --------------------------------------------------------------------------

E, U, C, FF = 4, 2, 256, 256
FLAGS = {
    "mixtral": {},
    "sigmoid": {"expert_gating": "sigmoid", "moe_scale": 2.5},
    "probs_b": {"probs_b": True, "moe_norm_weights": False},
    "weight_before": {"moe_weight_before": True, "moe_norm_weights": False},
    "shexp": {"moe_shared_expert": True},
    "shexp_gated": {"moe_shared_expert": True, "moe_gate_shexp": True},
}


def _moe_layer(rng, shexp: bool, probs_b: bool):
    """One MoE layer's JAX params (numpy leaves): router f32 [E, C], gate/up
    Q4_K and down Q6_K stacks, optionally a Q8_0 shared expert with its
    gate and a selection bias."""
    layer = {"ffn_gate_inp": (rng.standard_normal((E, C)) * 0.1).astype(np.float32)}
    for name, kind, n, k in (("ffn_gate_exps", GGMLType.Q4_K, FF, C),
                             ("ffn_up_exps", GGMLType.Q4_K, FF, C),
                             ("ffn_down_exps", GGMLType.Q6_K, C, FF)):
        layer[name] = _stack(rng, kind, E, n, k)[2]
    if shexp:
        for name, n, k in (("ffn_gate_shexp", FF, C), ("ffn_up_shexp", FF, C),
                           ("ffn_down_shexp", C, FF)):
            w = (rng.standard_normal((n, k)) * 0.1).astype(np.float32)
            layer[name] = jax_convert(quantize(w, GGMLType.Q8_0), GGMLType.Q8_0, (n, k))
        layer["ffn_gate_inp_shexp"] = (rng.standard_normal((1, C)) * 0.1).astype(np.float32)
    if probs_b:
        layer["ffn_exp_probs_b"] = (rng.standard_normal(E) * 0.3).astype(np.float32)
    return layer


@pytest.mark.parametrize("t", [1, 12])
@pytest.mark.parametrize("flags", list(FLAGS))
def test_ffn_moe_matches_jax(flags, t, monkeypatch):
    over = dict(FLAGS[flags])
    probs_b = over.pop("probs_b", False)
    rng = np.random.default_rng(11)
    layer = _moe_layer(rng, over.get("moe_shared_expert", False), probs_b)
    base = dict(arch="llama", n_layers=1, n_embd=C, n_heads=2, n_kv_heads=2, head_dim=128,
                n_ff=FF, n_vocab=64, n_ctx_train=64, n_expert=E, n_expert_used=U, **over)
    jcfg, pcfg = JaxConfig(**base), LlamaConfig(**base)
    x = rng.standard_normal((1, t, C)).astype(np.float32)
    want = np.asarray(jax_ffn_moe(jnp.asarray(x), layer, jcfg, jnp.bfloat16))
    calls = []
    inner = kqmm.qmm_expert_rows
    monkeypatch.setattr(kqmm, "qmm_expert_rows", lambda *a: (calls.append(1), inner(*a))[1])
    got = ffn_moe(torch.from_numpy(x), params_from_numpy(layer), pcfg).numpy()
    # b·t·u ≤ min(32, E): the selected-expert branch (three calls), else dense-all
    assert len(calls) == (3 if t * U <= E else 0)
    assert got.shape == want.shape == (1, t, C) and got.dtype == np.float32
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err < FFN_RTOL, err


def test_config_fields_match_jax():
    names = ("n_expert", "n_expert_used", "moe_norm_weights", "moe_shared_expert",
             "moe_gate_shexp", "expert_gating", "moe_scale", "moe_weight_before")
    jf = {f.name: f.default for f in dataclasses.fields(JaxConfig)}
    pf = {f.name: f.default for f in dataclasses.fields(LlamaConfig)}
    assert {n: pf[n] for n in names} == {n: jf[n] for n in names}


# --------------------------------------------------------------------------
# a 4-expert Q4_K_M GGUF through both packages
# --------------------------------------------------------------------------

SMALL_MOE = LlamaConfig(arch="llama", n_layers=2, n_embd=256, n_heads=2, n_kv_heads=1,
                        head_dim=128, n_ff=256, n_vocab=512, n_ctx_train=128,
                        rope=RopeParams(n_dims=128, freq_base=1e6), n_expert=4, n_expert_used=2)


@pytest.fixture(scope="module")
def moe_gguf(tmp_path_factory):
    from llama_cpp_dsp_tpu_torch.tools.synth import write_synth_gguf

    path = str(tmp_path_factory.mktemp("torch_moe") / "moe-q4_k_m.gguf")
    write_synth_gguf(path, SMALL_MOE, "Q4_K_M", seed=4)
    return path


def test_moe_gguf_loads_like_jax(moe_gguf):
    from llama_cpp_dsp_tpu.runtime.loader import load_model as jax_load_model
    from llama_cpp_dsp_tpu_torch.runtime.context import convert_params_to_kernel
    from llama_cpp_dsp_tpu_torch.runtime.loader import load_model

    ours, theirs = load_model(moe_gguf), jax_load_model(moe_gguf)
    assert (ours.cfg.n_expert, ours.cfg.n_expert_used) == (4, 2)
    assert (theirs.cfg.n_expert, theirs.cfg.n_expert_used) == (4, 2)
    assert ours.n_params == theirs.n_params
    want = params_from_numpy(theirs.params)
    for mine, ref in zip(ours.params["layers"], want["layers"]):
        assert mine.keys() == ref.keys()
        for key, w in mine.items():
            if isinstance(w, QTensor):
                assert (w.kind, w.shape, w.n_expert) == (ref[key].kind, ref[key].shape,
                                                         ref[key].n_expert), key
                assert all(torch.equal(a, ref[key][f]) for f, a in w.arrays.items()), key
            else:
                assert torch.equal(w, ref[key]), key
    layers = ours.params["layers"]
    assert layers[0]["ffn_gate_exps"].n_expert == 4 and layers[0]["ffn_gate_inp"].shape == (4, 256)
    # ffn_down_exps by use_more_bits(layer, 2): layer 0 Q4_K, layer 1 Q6_K
    assert [w["ffn_down_exps"].kind for w in layers] == [TGGMLType.Q4_K, TGGMLType.Q6_K]
    fused = convert_params_to_kernel(ours.params)["layers"][0]
    assert fused["ffn_gate_exps"] is layers[0]["ffn_gate_exps"]  # stacks are never fused


def test_moe_forward_and_stream_match_jax(moe_gguf, monkeypatch):
    """Prefill T=6 (dense-all in both) and four decode steps (the selected
    branch in the port), then greedy streams at LLAMA_TPU_DECODE_CHUNK=1."""
    from llama_cpp_dsp_tpu.runtime.context import LlamaContext as JaxContext
    from llama_cpp_dsp_tpu.runtime.loader import load_model as jax_load_model
    from llama_cpp_dsp_tpu.runtime.sampling import make_chain as jax_make_chain
    from llama_cpp_dsp_tpu_torch.runtime.context import LlamaContext
    from llama_cpp_dsp_tpu_torch.runtime.loader import load_model
    from test_torch_model import _jax_logits, _port_logits

    tokens = [1, 300, 301, 302, 305, 400, 7, 260, 261, 90]
    jm = jax_load_model(moe_gguf)
    want = _jax_logits(jm, tokens, 6)
    calls = []
    inner = kqmm.qmm_expert_rows
    monkeypatch.setattr(kqmm, "qmm_expert_rows", lambda *a: (calls.append(1), inner(*a))[1])
    got = _port_logits(load_model(moe_gguf), tokens, 6)
    assert len(calls) == 4 * 2 * 3  # decode steps × layers × gate, up, down
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err < LOGIT_RTOL, err
    monkeypatch.setenv("LLAMA_TPU_DECODE_CHUNK", "1")
    prompt = [1, 300, 301, 33]
    jctx = JaxContext(jm, n_ctx=64)
    want_ids = list(jctx.generate(prompt, max_new_tokens=10, sampler=jax_make_chain(temp=0)))
    ctx = LlamaContext(load_model(moe_gguf), n_ctx=64, device="cpu")
    assert list(ctx.generate(prompt, max_new_tokens=10, sampler=make_chain(temp=0))) == want_ids


def test_moe_engine_steps_match_b1_forwards(moe_gguf):
    """On the port alone: an engine's batched decode step over four slots
    (b·t·u = 8 > E = 4: dense-all) and a packed prompt+decode step (dense-
    all) against B=1 forwards over contiguous caches (decode at B=1 takes
    the selected branch), so the two branches check each other."""
    from llama_cpp_dsp_tpu_torch.models.llama import forward, forward_packed
    from llama_cpp_dsp_tpu_torch.runtime.engine import Engine
    from llama_cpp_dsp_tpu_torch.runtime.kv_cache import KVCache
    from llama_cpp_dsp_tpu_torch.runtime.loader import load_model

    model = load_model(moe_gguf)
    eng = Engine(model, n_slots=4, n_ctx_per_slot=64, prefill_buckets=(8, 32), device="cpu")
    cfg, params = eng.cfg, eng.params
    prompts = [[1, 300 + i, 40 + 3 * i, 7, 9 + i][: 3 + i % 3] for i in range(4)]
    nxt = [11, 12, 13, 14]

    def b1(prompt, extra):
        cache = KVCache.create(cfg.n_layers, 1, 64, cfg.n_kv_heads, cfg.head_dim)
        n = len(prompt)
        forward(params, cfg, torch.tensor([prompt]), torch.arange(n)[None].int(), cache, 0)
        out = forward(params, cfg, torch.tensor([[extra]]), torch.tensor([[n]]).int(), cache, n)
        return out[0, 0].numpy()

    want = np.stack([b1(p, t) for p, t in zip(prompts, nxt)])
    for i, p in enumerate(prompts):  # each prompt into slot i's rows
        forward(params, cfg, torch.tensor([p]), torch.arange(len(p))[None].int(),
                eng.cache.slot(i), 0)
    pos = torch.tensor([[len(p)] for p in prompts]).int()
    got = forward(params, cfg, torch.tensor([[t] for t in nxt]), pos, eng.cache,
                  pos[:, 0])[:, 0].numpy()
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err < LOGIT_RTOL, err
    # packed: slots 0-1 decode their next token, slot 2 re-runs its prompt
    # with the token appended, slot 3 its whole prompt again (padding after)
    toks = [nxt[0], nxt[1], *prompts[2], nxt[2], *prompts[3]]
    slots = [0, 1] + [2] * (len(prompts[2]) + 1) + [3] * len(prompts[3])
    rows = [len(prompts[0]), len(prompts[1]), *range(len(prompts[2]) + 1),
            *range(len(prompts[3]))]
    pad = 16 - len(toks)
    out_idx = torch.tensor([0, 1, 2 + len(prompts[2]), len(toks) - 1])
    logits = forward_packed(params, cfg, torch.tensor(toks + [0] * pad),
                            torch.tensor(slots + [0] * pad), torch.tensor(rows + [64] * pad),
                            eng.cache, out_idx).numpy()
    last3 = b1(prompts[3][:-1], prompts[3][-1])
    for got_row, want_row in ((logits[0], want[0]), (logits[1], want[1]),
                              (logits[2], want[2]), (logits[3], last3)):
        err = np.abs(got_row - want_row).max() / np.abs(want_row).max()
        assert err < LOGIT_RTOL, err


def test_mixtral_template_renders_like_jax():
    """Mixtral-Instruct's template has no system role: JAX's jinja raises on
    a system message and takes the builtin its markers name, which the port
    renders directly."""
    from llama_cpp_dsp_tpu.serve.chat import apply_chat_template as jax_apply
    from llama_cpp_dsp_tpu_torch.serve.chat import apply_chat_template
    from llama_cpp_dsp_tpu_torch.tools.synth import MIXTRAL_CHAT_TEMPLATE

    msgs = [{"role": "system", "content": "You answer questions about the sky."},
            {"role": "user", "content": "Why is the sky blue?"}]
    got = apply_chat_template(MIXTRAL_CHAT_TEMPLATE, msgs)
    assert got == jax_apply(MIXTRAL_CHAT_TEMPLATE, msgs)
    assert got.startswith("[INST] You answer") and got.endswith("blue? [/INST]")


def test_mixtral_config_and_kinds():
    from llama_cpp_dsp_tpu.tools.synth import CONFIGS as JAX_CONFIGS
    from llama_cpp_dsp_tpu_torch.tools.synth import CONFIGS, tensor_type

    ours, theirs = CONFIGS["mixtral-8x7b"], JAX_CONFIGS["mixtral-8x7b"]
    for f in ("n_layers", "n_embd", "n_heads", "n_kv_heads", "head_dim", "n_ff", "n_vocab",
              "n_ctx_train", "n_expert", "n_expert_used"):
        assert getattr(ours, f) == getattr(theirs, f), f
    assert ours.rope.freq_base == theirs.rope.freq_base == 1e6

    def kind(name):
        return tensor_type("Q4_K_M", name, 32, 8)

    assert kind("blk.3.attn_q.weight") == TGGMLType.Q4_K
    assert kind("blk.3.attn_k.weight") == kind("blk.0.attn_v.weight") == TGGMLType.Q8_0
    assert kind("blk.3.attn_output.weight") == TGGMLType.Q5_K
    assert kind("blk.3.ffn_gate_exps.weight") == kind("blk.3.ffn_up_exps.weight") == TGGMLType.Q4_K
    down = [kind(f"blk.{i}.ffn_down_exps.weight") for i in range(32)]
    assert down.count(TGGMLType.Q6_K) == 16 and down.count(TGGMLType.Q4_K) == 16
    assert kind("output.weight") == TGGMLType.Q6_K


def test_port_moe_module_has_no_host_sync_on_selection():
    """ffn_moe never brings the router's selection to the host."""
    import inspect

    src = inspect.getsource(port_llama.ffn_moe)
    assert ".item()" not in src and ".tolist()" not in src and ".cpu()" not in src
