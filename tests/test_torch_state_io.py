"""The port's session and slot state files (runtime/state_io.py) on the CPU:
a save followed by a load continues as the saved context would have; a file
written by the JAX package loads in the port and the reverse, with the rows
each cache then holds checked against the other package's; a file of
another model is refused; and a slot saved from the engine and restored
into another slot (contiguous slots and pages, Q4_0 rows) continues as the
saved slot does.

Rows that pass through a file unchanged are compared bit for bit; a
quantized cache re-quantizes f32 rows, which gives back its codes and
scales exactly (the port writes quantized caches' rows in f32).
"""

import numpy as np
import pytest
import torch

from llama_cpp_dsp_tpu.gguf.constants import GGMLType
from llama_cpp_dsp_tpu.runtime import state_io as jstate
from llama_cpp_dsp_tpu.runtime.context import LlamaContext as JaxContext
from llama_cpp_dsp_tpu.runtime.loader import load_model as jax_load_model
from llama_cpp_dsp_tpu_torch.runtime import state_io
from llama_cpp_dsp_tpu_torch.runtime.context import LlamaContext
from llama_cpp_dsp_tpu_torch.runtime.engine import Engine, Request
from llama_cpp_dsp_tpu_torch.runtime.loader import load_model
from llama_cpp_dsp_tpu_torch.runtime.sampling import make_chain
from model_builder import build_tiny_llama
from test_torch_q4_kv import planes
from torch_fixtures import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

PROMPT = [1, 5, 9, 13, 2, 7, 11]


@pytest.fixture(scope="module")
def gguf(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("torch_state_io") / "tiny-d128.gguf")
    build_tiny_llama(path, seed=4, qtype=GGMLType.Q4_0, n_embd=256, n_heads=2, n_kv_heads=2)
    return path


@pytest.fixture(scope="module")
def model(gguf):
    return load_model(gguf)


def _rows(cache, n: int) -> list:
    """Every plane of a contiguous cache, cut to its first n rows: q4 byte
    planes [B, H, S/2, D] and parity-major scales [B, H, 2G, S/2] to the
    columns of those rows, q8 scales [B, H, 1, S] to n columns."""
    out = []
    for a in planes(cache):
        if a.dtype == np.uint8:
            out.append(a[:, :, :-(-n // 2)])
        elif a.dtype == np.float32 and a.shape[2] in (1, 8):
            out.append(a[..., :n] if a.shape[2] == 1 else a[..., :-(-n // 2)])
        else:
            out.append(a[:, :, :n])
    return out


@pytest.mark.parametrize("kv", ["bf16", "q4_0", "q8_0/q4_0"])
def test_save_then_load_continues_identically(model, tmp_path, kv):
    k_type, _, v_type = kv.partition("/")
    kw = dict(n_ctx=64, device="cpu", kv_dtype=k_type, kv_v_dtype=v_type or None)
    src = LlamaContext(model, **kw)
    src.eval_tokens(PROMPT)
    path = str(tmp_path / "session.npz")
    state_io.save_state(src, path, PROMPT)
    dst = LlamaContext(model, **kw)
    assert state_io.load_state(dst, path) == PROMPT and dst.n_past == src.n_past
    if k_type in ("bf16", "q4_0"):  # rows, codes and scales come back exactly
        for a, b in zip(_rows(dst.cache, len(PROMPT)), _rows(src.cache, len(PROMPT))):
            np.testing.assert_array_equal(a, b)
    steps = [[4], [8], [3]]
    got = [dst.eval_tokens(t) for t in steps]
    want = [src.eval_tokens(t) for t in steps]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6 * np.abs(w).max())


@pytest.mark.parametrize("kv", ["bf16", "q4_0"])
def test_files_cross_between_packages(model, gguf, tmp_path, kv):
    """JAX → port: a bf16 file's rows land exactly; port → JAX: a q4_0
    cache's f32 rows re-quantize in JAX to the port's codes and scales."""
    jctx = JaxContext(jax_load_model(gguf), n_ctx=64, kv_dtype=kv, use_pallas=False)
    ctx = LlamaContext(model, n_ctx=64, device="cpu", kv_dtype=kv)
    n = len(PROMPT)
    if kv == "bf16":
        jctx.eval_tokens(PROMPT)
        jstate.save_state(jctx, str(tmp_path / "jax.npz"), PROMPT)
        assert state_io.load_state(ctx, str(tmp_path / "jax.npz")) == PROMPT
    else:
        ctx.eval_tokens(PROMPT)
        state_io.save_state(ctx, str(tmp_path / "port.npz"), PROMPT)
        assert jstate.load_state(jctx, str(tmp_path / "port.npz")) == PROMPT
    assert ctx.n_past == jctx.n_past == n
    for a, b in zip(_rows(ctx.cache, n), _rows(jctx.cache, n)):
        np.testing.assert_array_equal(a, b)


def test_other_model_is_refused(model, tmp_path):
    ctx = LlamaContext(model, n_ctx=64, device="cpu")
    ctx.eval_tokens(PROMPT)
    path = str(tmp_path / "session.npz")
    state_io.save_state(ctx, path, PROMPT)
    path2 = str(tmp_path / "other.gguf")
    build_tiny_llama(path2, seed=4, qtype=GGMLType.Q4_0, n_embd=256, n_heads=2, n_kv_heads=2,
                     n_layers=3)
    with pytest.raises(ValueError, match="state mismatch: n_layers=2, model has 3"):
        state_io.load_state(LlamaContext(load_model(path2), n_ctx=64, device="cpu"), path)
    with pytest.raises(ValueError, match="state has 7 cells, context only 4"):
        state_io.load_state(LlamaContext(model, n_ctx=4, device="cpu"), path)
    np.savez(tmp_path / "bad.npz", meta='{"magic": "x"}', k=np.zeros(1), v=np.zeros(1))
    with pytest.raises(ValueError, match="not a state file"):
        state_io.load_state(ctx, str(tmp_path / "bad.npz"))


@pytest.mark.parametrize("layout", ["slots", "paged"])
def test_slot_save_restore_round_trip(model, tmp_path, layout):
    """Slot 0 serves a request; its rows are saved and restored into slot 1;
    a request that extends the saved tokens runs on each slot in turn (slot
    0 first: the lower id wins a tie; then slot 0 is erased) and both reuse
    the rows and continue alike."""
    kw = {"kv_layout": "paged", "page_size": 16} if layout == "paged" else {}
    eng = Engine(model, n_slots=2, n_ctx_per_slot=64, prefill_buckets=(16,), kv_dtype="q4_0",
                 device="cpu", **kw)
    first = eng.generate_sync(list(PROMPT), max_new_tokens=6, sampler=make_chain(temp=0))
    tokens = list(eng.slots[0].cache_tokens)
    assert first.error is None and len(tokens) == eng.slots[0].n_past == len(PROMPT) + 5
    path = str(tmp_path / "slot.bin")
    state_io.save_slot(eng, 0, path, tokens)
    assert state_io.load_slot(eng, 1, path) == tokens
    assert eng.slots[1].n_past == len(tokens) and eng.slots[1].cache_tokens == tokens
    if layout == "paged":
        got, want = (eng.cache.gather_seq(i, torch.float32) for i in (1, 0))
        for a, b in zip(got, want):
            assert torch.equal(a[..., :len(tokens), :], b[..., :len(tokens), :])
    else:
        for a, b in zip(_rows(eng.cache.slot(1), len(tokens)),
                        _rows(eng.cache.slot(0), len(tokens))):
            np.testing.assert_array_equal(a, b)
    outs = []
    for slot in (0, 1):
        cached = eng.metrics.get("prompt_tokens_cached", 0)
        r = eng.generate_sync(tokens + [3], max_new_tokens=5, sampler=make_chain(temp=0))
        assert r.error is None and eng.slots[slot].cache_tokens[:len(tokens) + 1] == tokens + [3]
        assert eng.metrics["prompt_tokens_cached"] - cached == len(tokens)
        outs.append(r.result_tokens)
        eng.erase_slot(slot)
    assert outs[0] == outs[1] and len(outs[0]) == 5
    eng.slots[0].req = Request(0, [1])  # a slot that serves a request is not restored into
    with pytest.raises(ValueError, match="slot 0 is busy"):
        state_io.load_slot(eng, 0, path)


def _cli(main, argv):
    import io
    from contextlib import redirect_stderr, redirect_stdout

    out, err = io.BytesIO(), io.StringIO()
    wrapper = io.TextIOWrapper(out, encoding="utf-8", write_through=True)
    with redirect_stdout(wrapper), redirect_stderr(err):
        rc = main(argv)
    wrapper.flush()
    assert rc == 0, err.getvalue()
    return out.getvalue(), err.getvalue()


def test_cli_cache_types_and_prompt_cache(gguf, tmp_path, monkeypatch):
    """The CLIs' -ctk / -ctv and --prompt-cache (JAX tools/cli.py): the same
    bytes as the JAX CLI with -ctk q4_0; the session file it saves is reused
    by the next run of the same prompt, which prints the same bytes; a split
    -ctk q8_0 -ctv q4_0 runs."""
    from llama_cpp_dsp_tpu.tools.cli import main as jax_main
    from llama_cpp_dsp_tpu_torch.tools.cli import main

    monkeypatch.setenv("LLAMA_TPU_DECODE_CHUNK", "1")
    args = ["-m", gguf, "-p", "hello world", "-n", "8", "--temp", "0", "-c", "64",
            "--device", "cpu", "-ctk", "q4_0"]
    want, _ = _cli(jax_main, args)
    cache = str(tmp_path / "session.npz")
    got, err = _cli(main, args + ["--prompt-cache", cache])
    assert got == want and got.startswith(b"hello world")
    assert "prompt-cache: saved" in err
    again, err = _cli(main, args + ["--prompt-cache", cache])
    assert "prompt-cache: reusing" in err and again == got
    split, _ = _cli(main, args[:-1] + ["q8_0", "-ctv", "q4_0"])
    assert split.startswith(b"hello world") and len(split) > len(b"hello world\n")
