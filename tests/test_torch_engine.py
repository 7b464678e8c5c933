"""The port's continuous-batching Engine against the JAX package's Engine on
the CPU.

A tiny head_dim-128 Q4_0 llama (build_tiny_llama n_embd=256, 2/2 heads) puts
the kernels' plain versions on the path: the fused decode attention for the
bf16 slots, flash_decode_q8 for -ctk q8_0, flash_decode_q4 for -ctk q4_0,
the paged decode attention for kv_layout="paged" (flash_decode over the
dequantized pages for Q4_0 pages, as JAX). The JAX side runs its XLA path (use_pallas=False,
decode_chunk=1). Greedy streams must be byte-identical.
"""

import numpy as np
import pytest
import torch

from llama_cpp_dsp_tpu.gguf.constants import GGMLType
from llama_cpp_dsp_tpu.runtime.engine import Engine as JaxEngine
from llama_cpp_dsp_tpu.runtime.engine import Request as JaxRequest
from llama_cpp_dsp_tpu.runtime.loader import load_model as jax_load_model
from llama_cpp_dsp_tpu.runtime.sampling import make_chain as jax_make_chain
from llama_cpp_dsp_tpu_torch.ops.kernels import LAUNCHES
from llama_cpp_dsp_tpu_torch.runtime.engine import Engine, Request, SlotState
from llama_cpp_dsp_tpu_torch.runtime.loader import load_model
from llama_cpp_dsp_tpu_torch.runtime.sampling import make_chain
from model_builder import build_tiny_llama
from torch_fixtures import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

N_CTX = 64
ENGINE_KW = dict(n_slots=2, n_ctx_per_slot=N_CTX, prefill_buckets=(16,))
CONFIGS = {
    "slots-bf16": {},
    "slots-q8_0": {"kv_dtype": "q8_0"},
    "paged-bf16": {"kv_layout": "paged", "page_size": 16},
    "paged-q8_0": {"kv_layout": "paged", "kv_dtype": "q8_0", "page_size": 16},
    "slots-q4_0": {"kv_dtype": "q4_0"},
    "paged-q4_0": {"kv_layout": "paged", "kv_dtype": "q4_0", "page_size": 16},
}
P1 = [1, 3, 5, 7, 9, 11, 13, 2, 4]
P2 = [1, 6, 10, 14, 8]
P3 = P1 + [21, 22, 23]  # P1's prefix is cached by then


@pytest.fixture(scope="module")
def gguf(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("torch_engine") / "tiny-d128.gguf")
    build_tiny_llama(path, seed=4, qtype=GGMLType.Q4_0, n_embd=256, n_heads=2, n_kv_heads=2)
    return path


@pytest.fixture(scope="module")
def model(gguf):
    return load_model(gguf)


def _script(engine, req_cls, chain):
    """r1 alone, r2 submitted once r1 is generating (a mixed prompt+decode
    step serves both), then r3, whose prompt extends r1's (prefix reuse).
    Returns each request's tokens and stop reason, and the tokens cached."""
    r1 = req_cls(0, list(P1), max_new_tokens=10, sampler=chain(temp=0))
    engine.submit(r1)
    while len(r1.result_tokens) < 3:
        engine.step()
    r2 = req_cls(0, list(P2), max_new_tokens=8, sampler=chain(temp=0))
    engine.submit(r2)
    while not (r1.done.is_set() and r2.done.is_set()):
        engine.step()
    r3 = engine.generate_sync(list(P3), max_new_tokens=6, sampler=chain(temp=0))
    return ([(r.result_tokens, r.stop_reason, r.error) for r in (r1, r2, r3)],
            engine.metrics.get("prompt_tokens_cached", 0))


def _port_script(model, **kw):
    eng = Engine(model, device="cpu", **ENGINE_KW, **kw)
    mixed = []
    inner = eng._mixed_step
    eng._mixed_step = lambda gen: (mixed.append(len(gen)), inner(gen))[1]
    out = _script(eng, Request, make_chain)
    return out, mixed


@pytest.fixture(scope="module")
def port_streams(model):
    return {name: _port_script(model, **kw) for name, kw in CONFIGS.items()}


@pytest.mark.parametrize("name", ["slots-bf16", "paged-q8_0", "slots-q4_0", "paged-q4_0"])
def test_engine_matches_jax(gguf, port_streams, name):
    jax_engine = JaxEngine(jax_load_model(gguf), use_pallas=False, decode_chunk=1,
                           context_shift=False, **ENGINE_KW, **CONFIGS[name])
    want = _script(jax_engine, JaxRequest, jax_make_chain)
    (got, mixed) = port_streams[name]
    assert got == want
    streams = [toks for toks, _, _ in got[0]]
    assert all(len(set(s)) >= 3 for s in streams)  # not a degenerate stream
    assert any(n >= 1 for n in mixed)  # a mixed step carried a decoding slot
    assert got[1] > 0  # r3 reused r1's cached prefix


@pytest.mark.parametrize("name", ["slots-q8_0", "paged-bf16"])
def test_layouts_match_slots_bf16(port_streams, name):
    """As the JAX package's test_paged_engine_matches_slots: the cache
    layout and type do not change the greedy streams."""
    ref = [toks for toks, _, _ in port_streams["slots-bf16"][0][0]]
    got = [toks for toks, _, _ in port_streams[name][0][0]]
    assert got == ref


def test_decode_chunk_8_matches_1(model):
    streams = []
    for chunk in (1, 8):
        eng = Engine(model, device="cpu", decode_chunk=chunk, **ENGINE_KW)
        reqs = [eng.submit(Request(0, list(p), max_new_tokens=12, sampler=make_chain(temp=0)))
                for p in (P1, P2)]
        while not all(r.done.is_set() for r in reqs):
            eng.step()
        streams.append([r.result_tokens for r in reqs])
    assert streams[0] == streams[1] and len(streams[0][0]) == 12


def _slot_rows(eng, slot: int):
    """Slot's K and V rows of every layer, as a dense [Hkv, S, D] view."""
    return [t[slot].clone() for i in range(eng.cfg.n_layers) for t in eng.cache.layer(i)]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_idle_slot_rows_survive_decode(model, name):
    eng = Engine(model, device="cpu", **ENGINE_KW, **CONFIGS[name])
    before_launches = dict(LAUNCHES)
    eng.generate_sync(list(P1), max_new_tokens=4, sampler=make_chain(temp=0))
    kept = _slot_rows(eng, 0)
    other = [2] + P2[1:]  # shares no prefix with P1: it goes to the empty slot 1
    r = eng.generate_sync(other, max_new_tokens=8, sampler=make_chain(temp=0))
    assert r.stop_reason == "length" and eng.slots[0].state == SlotState.FREE
    assert eng.slots[1].cache_tokens[:len(other)] == other
    for a, b in zip(_slot_rows(eng, 0), kept, strict=True):
        assert torch.equal(a, b)
    assert LAUNCHES == before_launches  # CPU tensors: plain versions only


def test_prompt_too_long_is_an_error(model):
    eng = Engine(model, device="cpu", **ENGINE_KW)
    r = eng.generate_sync(list(range(1, N_CTX + 1)), max_new_tokens=4)
    assert r.error and "exceeds" in r.error and not r.result_tokens
    assert eng.metrics["n_errors"] == 1


def test_cancel_running_and_queued(model):
    eng = Engine(model, device="cpu", n_slots=1, n_ctx_per_slot=N_CTX, prefill_buckets=(16,))
    running = eng.submit(Request(0, list(P1), max_new_tokens=40, sampler=make_chain(temp=0)))
    queued = eng.submit(Request(0, list(P2), max_new_tokens=4, sampler=make_chain(temp=0)))
    while len(running.result_tokens) < 2:
        eng.step()
    assert eng.cancel(queued.rid) and queued.done.is_set() and queued.error == "cancelled"
    assert eng.cancel(running.rid)
    while not running.done.is_set():
        eng.step()
    assert running.stop_reason == "cancelled" and len(running.result_tokens) < 40
    assert not eng.cancel(12345)


def test_context_full_stops_with_length(model):
    eng = Engine(model, device="cpu", **ENGINE_KW)
    r = eng.generate_sync(list(range(1, N_CTX - 4)), max_new_tokens=40,
                          sampler=make_chain(temp=0))
    assert r.stop_reason == "length" and r.error is None
    assert r.n_prompt + len(r.result_tokens) <= N_CTX
    with pytest.raises(NotImplementedError, match="queue A2"):
        Engine(model, device="cpu", context_shift=True, **ENGINE_KW)


@pytest.mark.parametrize("layout", ["slots", "paged"])
def test_prefix_reuse_from_a_busy_slot(model, layout):
    """A prompt that extends a busy slot's cached prefix reuses it: the
    slots layout copies the donor's rows into the free slot (copy_slot),
    the paged layout aliases its full pages (refcounted, no copy)."""
    kw = {"kv_layout": layout, "page_size": 16} if layout == "paged" else {}
    eng = Engine(model, device="cpu", **ENGINE_KW, **kw)
    prefix = [int(t) for t in np.arange(2, 36)]  # 34 tokens: two full pages of 16
    blocker = eng.submit(Request(0, list(prefix), max_new_tokens=30, sampler=make_chain(temp=0)))
    while not blocker.result_tokens:
        eng.step()
    r = eng.submit(Request(0, prefix + [40, 41], max_new_tokens=3, sampler=make_chain(temp=0)))
    while not r.done.is_set():
        eng.step()
    cached = eng.metrics["prompt_tokens_cached"]
    assert r.result_tokens and r.error is None
    if layout == "paged":
        assert cached == 32
        shared = eng._seqs[0].pages[:2]
        assert all(eng._page_alloc.refs[p] == 2 for p in shared)
        assert eng._seqs[1].pages[:2] == shared
    else:
        assert cached == len(prefix)
        for i in range(eng.cfg.n_layers):
            for t in eng.cache.layer(i):
                assert torch.equal(t[0, :, :len(prefix)], t[1, :, :len(prefix)])
    eng.cancel(blocker.rid)
    while not blocker.done.is_set():
        eng.step()
