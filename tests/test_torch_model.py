"""The PyTorch port's model path against the JAX package on the CPU.

Tiny GGUFs from build_tiny_llama go through both loaders, both forwards
(prefill T>1 and decode T=1), both LlamaContext.generate loops and both
CLIs. The JAX side runs its CPU path (XLA dequant-matmul, plain attention);
the port runs its kernels' plain versions (fused decode attention and flash
decode at head_dim 128).

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

from llama_cpp_dsp_tpu.gguf.constants import GGMLType
from llama_cpp_dsp_tpu.models.llama import forward as jax_forward
from llama_cpp_dsp_tpu.runtime.context import LlamaContext as JaxContext
from llama_cpp_dsp_tpu.runtime.kv_cache import KVCache as JaxKVCache
from llama_cpp_dsp_tpu.runtime.kv_cache import causal_mask as jax_causal_mask
from llama_cpp_dsp_tpu.runtime.loader import load_model as jax_load_model
from llama_cpp_dsp_tpu.runtime.sampling import make_chain as jax_make_chain
from llama_cpp_dsp_tpu_torch.models.llama import forward
from llama_cpp_dsp_tpu_torch.ops.kernels import LAUNCHES
from llama_cpp_dsp_tpu_torch.ops.qtensor import QTensor
from llama_cpp_dsp_tpu_torch.runtime.context import LlamaContext, convert_params_to_kernel
from llama_cpp_dsp_tpu_torch.runtime.kv_cache import KVCache
from llama_cpp_dsp_tpu_torch.runtime.loader import load_model, params_from_numpy
from llama_cpp_dsp_tpu_torch.runtime.sampling import make_chain
from model_builder import build_tiny_llama

MODELS = {
    "q4_0": dict(qtype=GGMLType.Q4_0),
    "q8_0": dict(qtype=GGMLType.Q8_0),
    # head_dim 128: the fused (Q4_0) and flash decode paths engage
    "q4_0_d128": dict(qtype=GGMLType.Q4_0, n_embd=256, n_heads=2, n_kv_heads=2),
}
LOGIT_RTOL = 2e-2


@pytest.fixture(scope="module")
def gguf_paths(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_model")
    paths = {}
    for name, over in MODELS.items():
        paths[name] = str(root / f"{name}.gguf")
        build_tiny_llama(paths[name], seed=3, **over)
    return paths


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
        assert (a.kind, a.shape, a.arrays.keys()) == (b.kind, b.shape, b.arrays.keys())
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


def _port_logits(pm, tokens, n_prefill):
    cfg = pm.cfg
    params = convert_params_to_kernel(pm.params)
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
