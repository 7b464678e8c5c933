"""Models in the IQ / TQ mixes through the port and the JAX package on the
CPU.

- Unit-size llama GGUFs (`tools/synth.py::unit_config`, the qwen2 vocab) in
  IQ4_XS (every matrix IQ4_XS, the embedding too; Q6_K LM head) and IQ2_M
  (IQ2_S bulk, IQ3_S attn_k, Q4_K attn_v, Q2_K embedding, Q5_K LM head),
  written by the port's `write_synth_gguf`: both loaders give the same
  weights (`params_from_numpy` carries JAX's carrier QTensors across
  unchanged); logits of a prefill and four decode steps against JAX's
  forward; greedy streams against JAX's LlamaContext.
- A unit qwen3moe (16 experts top-4) in IQ3_XXS: its decode steps through
  the port's selected-expert branch (B9's plain version) against JAX's
  forward, which without kernel layouts runs every expert (dense-all).
- The port's `tensor_type` against JAX's tools/quantize.py for every tensor
  of Llama-3-8B IQ4_XS and IQ2_M (names and shapes only), and the IQ / TQ
  kinds' block-size fallback to F16.

Tolerance: logits within 2e-2 of max|JAX logit| (as tests/test_torch_model.py);
greedy streams identical.
"""

import numpy as np
import pytest

from llama_cpp_dsp_tpu_torch.gguf.constants import GGMLType as TGGMLType
from llama_cpp_dsp_tpu_torch.ops.kernels import LAUNCHES
from llama_cpp_dsp_tpu_torch.ops.kernels import qmm as kqmm
from llama_cpp_dsp_tpu_torch.runtime.sampling import make_chain
from llama_cpp_dsp_tpu_torch.tools import synth
from test_torch_qwen import _jax_logits, _port_logits, _recorded_tensors, _rel, _same_tree
from torch_fixtures import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

LOGIT_RTOL = 2e-2
FILES = {"llama-iq4_xs": ("llama", "IQ4_XS"), "llama-iq2_m": ("llama", "IQ2_M"),
         "qwen3moe-iq3_xxs": ("qwen3moe", "IQ3_XXS")}
TOKENS = [1792, 72, 101, 108, 108, 111, 33, 200, 7]
N_PREFILL = 5


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    from llama_cpp_dsp_tpu.runtime.loader import load_model as jax_load_model
    from llama_cpp_dsp_tpu_torch.runtime.loader import load_model

    root = tmp_path_factory.mktemp("torch_iq")
    out = {}
    for name, (arch, ftype) in FILES.items():
        path = str(root / f"{name}.gguf")
        synth.write_synth_gguf(path, synth.unit_config(arch), ftype, seed=3, vocab="qwen2",
                               experts=synth.UNIT_EXPERTS)
        out[name] = (load_model(path), jax_load_model(path))
    return out


@pytest.mark.parametrize("name", list(FILES))
def test_gguf_loads_like_jax(models, name):
    from llama_cpp_dsp_tpu_torch.runtime.loader import params_from_numpy

    ours, theirs = models[name]
    _same_tree(ours.params, params_from_numpy(theirs.params))
    layer = {k: w.kind for k, w in ours.params["layers"][0].items() if hasattr(w, "kind")}
    if name == "llama-iq4_xs":
        assert set(layer.values()) == {TGGMLType.IQ4_XS}
        assert (ours.params["token_embd"].kind, ours.params["output"].kind) == (
            TGGMLType.IQ4_XS, TGGMLType.Q6_K)
    elif name == "llama-iq2_m":
        assert (layer["attn_q"], layer["attn_k"], layer["attn_v"], layer["ffn_down"]) == (
            TGGMLType.IQ2_S, TGGMLType.IQ3_S, TGGMLType.Q4_K, TGGMLType.IQ2_S)
        assert (ours.params["token_embd"].kind, ours.params["output"].kind) == (
            TGGMLType.Q2_K, TGGMLType.Q5_K)
    else:  # IQ3_XXS experts; attn_v IQ3_S at n_gqa 2
        assert layer["ffn_gate_exps"] == TGGMLType.IQ3_XXS and ours.params["layers"][0][
            "ffn_gate_exps"].n_expert == 16
        assert layer["attn_v"] == TGGMLType.IQ3_S


@pytest.mark.parametrize("name", list(FILES))
def test_forward_prefill_and_decode_match_jax(models, name, monkeypatch):
    from llama_cpp_dsp_tpu_torch.runtime.context import convert_params_to_kernel

    pm, jm = models[name]
    want = _jax_logits(jm, TOKENS, N_PREFILL)
    calls = []
    inner = kqmm.qmm_expert_rows
    monkeypatch.setattr(kqmm, "qmm_expert_rows", lambda *a: (calls.append(1), inner(*a))[1])
    before = dict(LAUNCHES)
    params = convert_params_to_kernel(pm.params)
    got = _port_logits(params, pm.cfg, TOKENS, N_PREFILL)
    assert LAUNCHES == before  # CPU tensors take the plain versions
    assert got.shape == want.shape == (len(TOKENS), 2048)
    assert _rel(got, want) < LOGIT_RTOL
    layer = params["layers"][0]
    if name == "llama-iq4_xs":  # one kind: q|k|v and gate|up row-fused
        assert {"attn_qkv_fused", "ffn_gateup_fused"} <= set(layer) and "attn_q" not in layer
    elif name == "llama-iq2_m":  # q, k, v of three kinds stay apart; gate|up fuse
        assert "attn_qkv_fused" not in layer and "ffn_gateup_fused" in layer
    else:  # the decode steps took the selected-expert branch: layers × gate, up, down
        assert len(calls) == (len(TOKENS) - N_PREFILL) * 2 * 3


@pytest.mark.parametrize("name", ["llama-iq4_xs", "llama-iq2_m"])
def test_greedy_stream_matches_jax(models, name, monkeypatch):
    from llama_cpp_dsp_tpu.runtime.context import LlamaContext as JaxContext
    from llama_cpp_dsp_tpu.runtime.sampling import make_chain as jax_make_chain
    from llama_cpp_dsp_tpu_torch.runtime.context import LlamaContext

    monkeypatch.setenv("LLAMA_TPU_DECODE_CHUNK", "1")
    pm, jm = models[name]
    prompt = [1793, 300, 301, 302, 7]
    want = list(JaxContext(jm, n_ctx=64).generate(prompt, max_new_tokens=10,
                                                  sampler=jax_make_chain(temp=0)))
    assert len(set(want)) >= 3  # not a degenerate stream
    ctx = LlamaContext(pm, n_ctx=64, device="cpu")
    assert list(ctx.generate(prompt, max_new_tokens=10, sampler=make_chain(temp=0))) == want


@pytest.mark.parametrize("ftype", ["IQ4_XS", "IQ2_M"])
def test_tensor_types_match_jax_quantize(monkeypatch, ftype):
    from llama_cpp_dsp_tpu.tools import quantize as jq

    cfg = synth.CONFIGS["llama3-8b"]
    seen = _recorded_tensors(monkeypatch, cfg, ftype)
    kv = {"general.architecture": "llama", "llama.block_count": cfg.n_layers,
          "llama.attention.head_count": cfg.n_heads,
          "llama.attention.head_count_kv": cfg.n_kv_heads}
    state = jq._QuantizeState(kv, True, False)
    ft = jq.FTYPE_NAMES[ftype]
    kinds = {}
    for name, kind, ne in seen:
        if not jq.should_quantize(name, tuple(reversed(ne))):
            assert kind == TGGMLType.F32, name
            continue
        want = jq.tensor_get_type(state, jq.FTYPE_DEFAULT_TYPE[ft], name, ne[0], ft)
        assert int(kind) == int(want), (name, kind, want)
        kinds.setdefault(name.split(".")[-2], set()).add(kind.name)
    if ftype == "IQ4_XS":  # the mix PERF.md describes
        assert {k: v for k, v in kinds.items() if k != "output"} == {
            k: {"IQ4_XS"} for k in kinds if k != "output"}
        assert kinds["output"] == {"Q6_K"}
    else:
        assert kinds == {"token_embd": {"Q2_K"}, "attn_q": {"IQ2_S"}, "attn_k": {"IQ3_S"},
                         "attn_v": {"Q4_K"}, "attn_output": {"IQ2_S"}, "ffn_gate": {"IQ2_S"},
                         "ffn_up": {"IQ2_S"}, "ffn_down": {"IQ2_S"}, "output": {"Q5_K"}}


@pytest.mark.parametrize("ftype", ["IQ4_XS", "IQ2_XS", "IQ3_S", "TQ1_0"])
def test_block_size_fallback_is_f16_like_jax(ftype):
    """A row length that the kind's 256-weight block does not divide falls
    back to F16 (JAX's `_FALLBACK.get(..., F16)`); the writer's F16 tensor
    has the common rms."""
    from llama_cpp_dsp_tpu.tools import quantize as jq

    kv = {"general.architecture": "llama", "llama.block_count": 2,
          "llama.attention.head_count": 2, "llama.attention.head_count_kv": 1}
    ft = jq.FTYPE_NAMES[ftype]
    want = jq.tensor_get_type(jq._QuantizeState(kv, True, False), jq.FTYPE_DEFAULT_TYPE[ft],
                              "blk.0.ffn_up.weight", 1408, ft)
    got = synth.tensor_type(ftype, "blk.0.ffn_up.weight", 2, k=1408, n_gqa=2)
    assert int(got) == int(want) == int(TGGMLType.F16)
    raw = synth.synth_raw(np.random.default_rng(0), TGGMLType.F16, (64, 1408))
    w = raw.view(np.float16).astype(np.float64)
    assert w.shape == (64 * 1408,) and 0.05 < np.sqrt((w * w).mean()) < 0.058
