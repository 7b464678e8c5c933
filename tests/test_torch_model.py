"""The PyTorch port's model path against the JAX package on the CPU.

Tiny GGUFs from build_tiny_llama go through both loaders, both forwards
(prefill T>1 and decode T=1), both LlamaContext.generate loops and both
CLIs. The Q4_K_M model is build_tiny_llama's F32 model through the JAX
package's quantize_model, so layer 1's attn_v and ffn_down and the LM head
are Q6_K and the rest Q4_K. The JAX side runs its CPU path (XLA
dequant-matmul, plain attention); the port runs its kernels' plain versions
(fused decode attention and flash decode at head_dim 128).

Tolerance: logits within 2e-2 of the JAX logits relative to their max
magnitude (bf16 activations; the two frameworks round at the same points
but sum in another order), and greedy streams byte-identical.
"""

import io
import re
from contextlib import redirect_stderr, redirect_stdout

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_cpp_dsp_tpu.gguf.constants import FType, GGMLType
from llama_cpp_dsp_tpu.models.llama import forward as jax_forward
from llama_cpp_dsp_tpu.runtime.context import LlamaContext as JaxContext
from llama_cpp_dsp_tpu.runtime.kv_cache import KVCache as JaxKVCache
from llama_cpp_dsp_tpu.runtime.kv_cache import causal_mask as jax_causal_mask
from llama_cpp_dsp_tpu.runtime.loader import load_model as jax_load_model
from llama_cpp_dsp_tpu.runtime.sampling import make_chain as jax_make_chain
from llama_cpp_dsp_tpu.tools.quantize import quantize_model
from llama_cpp_dsp_tpu_torch.models.llama import forward
from llama_cpp_dsp_tpu_torch.ops.kernels import LAUNCHES
from llama_cpp_dsp_tpu_torch.ops.qtensor import QTensor
from llama_cpp_dsp_tpu_torch.runtime.context import LlamaContext, convert_params_to_kernel
from llama_cpp_dsp_tpu_torch.runtime.kv_cache import KVCache
from llama_cpp_dsp_tpu_torch.runtime.loader import load_model, params_from_numpy
from llama_cpp_dsp_tpu_torch.runtime.sampling import make_chain
from model_builder import build_tiny_llama
from torch_fixtures import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

MODELS = {
    "q4_0": dict(qtype=GGMLType.Q4_0),
    "q8_0": dict(qtype=GGMLType.Q8_0),
    # head_dim 128: the fused (Q4_0) and flash decode paths engage
    "q4_0_d128": dict(qtype=GGMLType.Q4_0, n_embd=256, n_heads=2, n_kv_heads=2),
    # F32, then JAX quantize_model to Q4_K_M; head_dim 128 with GQA: flash decode
    "q4_k_m": dict(qtype=GGMLType.F32, n_embd=256, n_ff=512, n_heads=2, n_kv_heads=1),
    # MoE: decode (b·t·u ≤ E) takes the selected-expert branch, prefill dense-all
    "moe_q4_0": dict(qtype=GGMLType.Q4_0, n_expert=4, n_expert_used=2),
    # 8 experts through JAX quantize_model: llama.cpp's n_expert == 8 rows
    "moe8_q4_k_m": dict(qtype=GGMLType.F32, n_embd=256, n_ff=256, n_heads=2, n_kv_heads=1,
                        n_expert=8, n_expert_used=2),
}
KQUANT = {"q4_k_m": FType.MOSTLY_Q4_K_M, "moe8_q4_k_m": FType.MOSTLY_Q4_K_M}
LOGIT_RTOL = 2e-2


@pytest.fixture(scope="module")
def gguf_paths(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_model")
    paths = {}
    for name, over in MODELS.items():
        paths[name] = str(root / f"{name}.gguf")
        if name in KQUANT:
            build_tiny_llama(str(root / f"{name}-f32.gguf"), seed=3, **over)
            quantize_model(str(root / f"{name}-f32.gguf"), paths[name], KQUANT[name])
        else:
            build_tiny_llama(paths[name], seed=3, **over)
    return paths


def test_q4_k_m_mix(gguf_paths):
    params = load_model(gguf_paths["q4_k_m"]).params
    kinds = [{k: w.kind for k, w in layer.items() if isinstance(w, QTensor)}
             for layer in params["layers"]]
    assert kinds[0] == {k: GGMLType.Q4_K for k in kinds[0]} and len(kinds[0]) == 7
    assert kinds[1]["attn_v"] == kinds[1]["ffn_down"] == GGMLType.Q6_K
    assert kinds[1]["attn_q"] == kinds[1]["ffn_up"] == GGMLType.Q4_K
    assert params["output"].kind == GGMLType.Q6_K and params["token_embd"].kind == GGMLType.Q4_K
    fused = convert_params_to_kernel(params)["layers"]
    # q|k|v fuse only where the three share a kind (as JAX's concat_qtensors)
    assert "attn_qkv_fused" in fused[0] and "attn_qkv_fused" not in fused[1]
    assert all("ffn_gateup_fused" in layer for layer in fused)


def test_moe8_q4_k_m_mix_is_synth_tensor_type(gguf_paths):
    """The JAX quantizer's Q4_K_M kinds for an 8-expert model are the rows
    that the port's synthetic writer uses (tools/synth.py::tensor_type). The
    router is the exception: llama.cpp keeps ffn_gate_inp f32 (as the
    synthetic writer does), the JAX quantizer makes it Q4_K (ROADMAP.md
    queue C); the port loads and runs either."""
    from llama_cpp_dsp_tpu_torch.tools.synth import tensor_type

    params = load_model(gguf_paths["moe8_q4_k_m"]).params
    for i, layer in enumerate(params["layers"]):
        for key, w in layer.items():
            if isinstance(w, QTensor) and key != "ffn_gate_inp":
                assert w.kind == tensor_type("Q4_K_M", f"blk.{i}.{key}.weight", 2, 8), key
        assert layer["ffn_gate_exps"].n_expert == 8
        assert layer["ffn_gate_inp"].kind == GGMLType.Q4_K
    assert params["output"].kind == tensor_type("Q4_K_M", "output.weight", 2, 8)


def _same_tree(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same_tree(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same_tree(x, y)
    elif isinstance(a, QTensor):
        assert (a.kind, a.shape, a.n_expert, a.arrays.keys()) == (
            b.kind, b.shape, b.n_expert, b.arrays.keys())
        for k in a.arrays:
            assert torch.equal(a.arrays[k], b.arrays[k])
    else:
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", list(MODELS))
def test_load_model_matches_jax_tree(gguf_paths, name):
    ours = load_model(gguf_paths[name])
    theirs = params_from_numpy(jax_load_model(gguf_paths[name]).params)
    _same_tree(ours.params, theirs)
    assert ours.cfg.n_layers == 2 and ours.cfg.rope.mode == "norm"


def _jax_logits(jm, tokens, n_prefill):
    cfg = jm.cfg
    cache = JaxKVCache.create(cfg.n_layers, 1, 64, cfg.n_kv_heads, cfg.head_dim)
    outs = []
    for lo, hi in ((0, n_prefill), *((i, i + 1) for i in range(n_prefill, len(tokens)))):
        pos = jnp.arange(lo, hi, dtype=jnp.int32)[None]
        mask = jax_causal_mask(pos, 64, lo)
        logits, cache = jax_forward(jm.params, cfg, jnp.asarray([tokens[lo:hi]], jnp.int32),
                                    pos, cache, lo, mask)
        outs.append(np.asarray(logits[0]))
    return np.concatenate(outs)


def _port_logits(pm, tokens, n_prefill, fuse=True):
    cfg = pm.cfg
    params = convert_params_to_kernel(pm.params) if fuse else pm.params
    cache = KVCache.create(cfg.n_layers, 1, 64, cfg.n_kv_heads, cfg.head_dim)
    outs = []
    for lo, hi in ((0, n_prefill), *((i, i + 1) for i in range(n_prefill, len(tokens)))):
        pos = torch.arange(lo, hi, dtype=torch.int32)[None]
        logits = forward(params, cfg, torch.tensor([tokens[lo:hi]]), pos, cache, lo)
        outs.append(logits[0].numpy())
    return np.concatenate(outs)


@pytest.mark.parametrize("name", list(MODELS))
def test_forward_prefill_and_decode_match_jax(gguf_paths, name):
    tokens = [1, 72, 101, 108, 108, 111, 33, 200, 7]
    n_prefill = 5  # rows 0..4 prefill (T=5), then four decode steps (T=1)
    jm = jax_load_model(gguf_paths[name])
    want = _jax_logits(jm, tokens, n_prefill)
    before = dict(LAUNCHES)
    got = _port_logits(load_model(gguf_paths[name]), tokens, n_prefill)
    assert LAUNCHES == before  # CPU tensors take the plain versions
    assert got.shape == want.shape == (len(tokens), 256)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err < LOGIT_RTOL, err


# n_ctx 16: the last steps no longer fit a decode chunk and go one by one
@pytest.mark.parametrize("name,n_ctx", [(n, 64) for n in MODELS] + [("q8_0", 16)])
def test_generate_greedy_stream_matches_jax(gguf_paths, name, n_ctx, monkeypatch):
    monkeypatch.setenv("LLAMA_TPU_DECODE_CHUNK", "1")
    prompt = [1, 104, 105, 33]
    jctx = JaxContext(jax_load_model(gguf_paths[name]), n_ctx=n_ctx)
    want = list(jctx.generate(prompt, max_new_tokens=12, sampler=jax_make_chain(temp=0)))
    ctx = LlamaContext(load_model(gguf_paths[name]), n_ctx=n_ctx, device="cpu")
    got = list(ctx.generate(prompt, max_new_tokens=12, sampler=make_chain(temp=0)))
    assert got == want
    assert ctx.n_past == jctx.n_past


def _run_cli(main, argv):
    out, err = io.BytesIO(), io.StringIO()
    wrapper = io.TextIOWrapper(out, encoding="utf-8", write_through=True)
    with redirect_stdout(wrapper), redirect_stderr(err):
        rc = main(argv)
    wrapper.flush()
    return rc, out.getvalue(), err.getvalue()


def test_cli_bytes_match_jax_cli(gguf_paths, monkeypatch):
    from llama_cpp_dsp_tpu.tools.cli import main as jax_main
    from llama_cpp_dsp_tpu_torch.tools.cli import main

    monkeypatch.setenv("LLAMA_TPU_DECODE_CHUNK", "1")
    args = ["-m", gguf_paths["q4_0_d128"], "-p", "hello", "-n", "10", "--temp", "0",
            "-c", "64"]
    rc_j, out_j, err_j = _run_cli(jax_main, args + ["--device", "cpu"])
    rc_t, out_t, err_t = _run_cli(main, args + ["--device", "cpu"])
    assert rc_j == rc_t == 0
    assert out_t == out_j and out_t.startswith(b"hello")
    # the same stderr lines: the load line, then the perf line
    assert err_t.splitlines()[0].split(" (")[0] == err_j.splitlines()[0].split(" (")[0]
    perf = (r"prefill: \d+ tok in [\d.]+ ms \([\d.]+ t/s\) \| decode: \d+ tok in "
            r"[\d.]+ ms \([\d.]+ t/s\) \| compile: [\d.]+ ms")
    assert re.fullmatch(perf, err_t.splitlines()[-1])
    assert re.fullmatch(perf, err_j.splitlines()[-1])


def test_synth_llama_bpe_q4_k_m_cli_matches_jax(tmp_path, monkeypatch):
    """write_synth_gguf's Q4_K_M mix with the llama-bpe vocab: the same
    token ids through both loaders' tokenizers, the same CLI bytes."""
    from llama_cpp_dsp_tpu.tools.cli import main as jax_main
    from llama_cpp_dsp_tpu_torch.models.llama import LlamaConfig
    from llama_cpp_dsp_tpu_torch.ops.rope import RopeParams
    from llama_cpp_dsp_tpu_torch.tools.cli import main
    from llama_cpp_dsp_tpu_torch.tools.synth import write_synth_gguf

    monkeypatch.setenv("LLAMA_TPU_DECODE_CHUNK", "1")
    path = str(tmp_path / "synth-q4_k_m.gguf")
    cfg = LlamaConfig(arch="llama", n_layers=2, n_embd=256, n_heads=2, n_kv_heads=1,
                      head_dim=128, n_ff=512, n_vocab=2048, n_ctx_train=256,
                      rope=RopeParams(n_dims=128, freq_base=500000.0))
    write_synth_gguf(path, cfg, "Q4_K_M", seed=2, vocab="llama-bpe")
    ours, theirs = load_model(path), jax_load_model(path)
    assert ours.params["output"].kind == GGMLType.Q6_K
    prompt = "<|start_header_id|>user<|end_header_id|>\n\nHello, world! 123"
    ids = ours.tokenizer.encode(prompt, add_special=True, parse_special=True)
    assert ids == theirs.tokenizer.encode(prompt, add_special=True, parse_special=True)
    assert ids[0] == ours.vocab.bos_id == 2048 - 256
    args = ["-m", path, "-p", "Hello, world!", "-n", "10", "--temp", "0", "-c", "64",
            "--device", "cpu"]
    rc_j, out_j, _ = _run_cli(jax_main, args)
    rc_t, out_t, _ = _run_cli(main, args)
    assert rc_j == rc_t == 0
    assert out_t == out_j and out_t.startswith(b"Hello, world!")


def test_loader_refuses_unported_tensors(tmp_path, monkeypatch):
    """A tensor that the JAX loader maps and the port cannot run yet (a
    bias, norm or scale of another decoder arch: ROADMAP row A3; another
    family's: A8) refuses the file, naming the tensor and the row; the
    port's table and its refusals together cover the JAX loader's."""
    from llama_cpp_dsp_tpu.runtime import loader as jax_loader
    from llama_cpp_dsp_tpu_torch.models.llama import LlamaConfig
    from llama_cpp_dsp_tpu_torch.ops.rope import RopeParams
    from llama_cpp_dsp_tpu_torch.runtime import loader as port_loader
    from llama_cpp_dsp_tpu_torch.tools import synth

    assert set(jax_loader._LAYER_TENSORS) == (set(port_loader._LAYER_TENSORS)
                                              | set(port_loader._UNPORTED_LAYER))
    assert set(jax_loader._GLOBAL_TENSORS) == (set(port_loader._GLOBAL_TENSORS)
                                               | set(port_loader._UNPORTED_GLOBAL))
    cfg = LlamaConfig(arch="llama", n_layers=2, n_embd=64, n_heads=2, n_kv_heads=2,
                      head_dim=32, n_ff=128, n_vocab=300, n_ctx_train=64,
                      rope=RopeParams(n_dims=32))
    base = synth.GGUFWriter
    for extra, after, row in (("blk.0.attn_sub_norm.weight", "blk.0.attn_norm.weight", "A3"),
                              ("blk.1.ffn_down.bias", "blk.1.attn_norm.weight", "A3"),
                              ("output.bias", "output_norm.weight", "A3"),
                              ("blk.1.ssm_a", "blk.1.attn_norm.weight", "A8")):
        class Writer(base):
            def add_tensor(self, name, data, extra=extra, after=after, **kw):
                super().add_tensor(name, data, **kw)
                if name == after:
                    super().add_tensor(extra, np.full(64, 0.5, np.float32))

        monkeypatch.setattr(synth, "GGUFWriter", Writer)
        path = str(tmp_path / f"{extra}.gguf")
        synth.write_synth_gguf(path, cfg, "Q8_0")
        with pytest.raises(NotImplementedError,
                           match=rf"tensor {re.escape(extra)}: .*ROADMAP.md queue A, {row}\)"):
            load_model(path)
        assert jax_load_model(path).cfg.n_layers == 2  # JAX maps it
    # the Gemma post norms, under both GGUF names, load as JAX maps them
    for name, key in (("attn_post_norm", "attn_post_norm"),
                      ("post_attention_norm", "attn_post_norm"),
                      ("ffn_post_norm", "ffn_post_norm"), ("post_ffw_norm", "ffn_post_norm")):
        assert port_loader._LAYER_TENSORS[f"{name}.weight"] == key
        assert jax_loader._LAYER_TENSORS[f"{name}.weight"] == key


@pytest.mark.parametrize("biases", [("k", "v"), ("q",)])
def test_qkv_biases_each_apply_like_jax_mm(tmp_path, monkeypatch, biases):
    """A llama file whose layers carry only some of the q / k / v biases:
    each present bias is added (JAX's unfused `_mm`, which the JAX forward
    takes on loaded params), on the port's fused q|k|v branch as on the
    separate one; without them the logits leave the tolerance."""
    from llama_cpp_dsp_tpu_torch.models.llama import LlamaConfig
    from llama_cpp_dsp_tpu_torch.ops.rope import RopeParams
    from llama_cpp_dsp_tpu_torch.tools import synth

    cfg = LlamaConfig(arch="llama", n_layers=2, n_embd=64, n_heads=2, n_kv_heads=1,
                      head_dim=32, n_ff=128, n_vocab=300, n_ctx_train=64,
                      rope=RopeParams(n_dims=32))
    rng = np.random.default_rng(11)
    base = synth.GGUFWriter

    class Writer(base):
        def add_tensor(self, name, data, **kw):
            super().add_tensor(name, data, **kw)
            m = re.fullmatch(r"blk\.(\d+)\.attn_norm\.weight", name)
            for part in biases if m else ():
                rows = cfg.n_heads * cfg.head_dim if part == "q" else cfg.head_dim
                super().add_tensor(f"blk.{m[1]}.attn_{part}.bias",
                                   rng.standard_normal(rows).astype(np.float32))

    monkeypatch.setattr(synth, "GGUFWriter", Writer)
    path = str(tmp_path / "bias.gguf")
    synth.write_synth_gguf(path, cfg, "Q8_0")
    tokens, n_prefill = [1, 72, 101, 108, 108, 111, 33], 5
    want = _jax_logits(jax_load_model(path), tokens, n_prefill)
    pm = load_model(path)
    assert all(sorted(k for k in layer if k.endswith("_bias"))
               == [f"attn_{p}_bias" for p in biases] for layer in pm.params["layers"])
    assert "attn_qkv_fused" in convert_params_to_kernel(pm.params)["layers"][0]
    fused = _port_logits(pm, tokens, n_prefill)
    scale = np.abs(want).max()
    assert np.abs(fused - want).max() / scale < LOGIT_RTOL
    separate = _port_logits(pm, tokens, n_prefill, fuse=False)
    assert np.abs(separate - want).max() / scale < LOGIT_RTOL
    for layer in pm.params["layers"]:
        for p in biases:
            del layer[f"attn_{p}_bias"]
    assert np.abs(_port_logits(pm, tokens, n_prefill) - want).max() / scale > LOGIT_RTOL
