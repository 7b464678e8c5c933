"""The port's HTTP server (standard library, CPU engine) against the JAX
package's aiohttp server on the same tiny model.

Both servers get the same requests in the same order (the engines' prompt
caches then hold the same prefixes), greedy at temperature 0. The content
of every answer must be identical, and so must the SSE framing: the
sequence of `data:` events, their JSON keys and their text, with ids,
timestamps and timings left out. A second model, a Q4_K_M mix with a
llama-3 byte-level BPE vocab and chat template, answers one chat request
through each server (the JAX server renders the template with jinja2, the
port through its llama3 builtin).
"""

import asyncio
import json
import threading
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import pytest
from aiohttp.test_utils import TestClient, TestServer

from llama_cpp_dsp_tpu.gguf.constants import GGMLType
from llama_cpp_dsp_tpu.runtime.engine import Engine as JaxEngine
from llama_cpp_dsp_tpu.runtime.loader import load_model as jax_load_model
from llama_cpp_dsp_tpu.serve.chat import CHATML_TEMPLATE
from llama_cpp_dsp_tpu.serve.chat import apply_chat_template as jax_apply_chat_template
from llama_cpp_dsp_tpu.serve.server import Server as JaxServer
from llama_cpp_dsp_tpu_torch.runtime.engine import Engine
from llama_cpp_dsp_tpu_torch.runtime.loader import load_model
from llama_cpp_dsp_tpu_torch.serve.chat import apply_chat_template
from llama_cpp_dsp_tpu_torch.serve.chat_builtin import BUILTIN_TEMPLATES
from llama_cpp_dsp_tpu_torch.serve.server import Server
from model_builder import build_tiny_llama
from torch_fixtures import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

AUTH = {"Authorization": "Bearer secret"}
ENGINE_KW = dict(n_slots=2, n_ctx_per_slot=160, prefill_buckets=(64,))
CHAT = {"messages": [{"role": "system", "content": "be brief"},
                     {"role": "user", "content": "hi there"}],
        "max_tokens": 8, "temperature": 0}
# (method, path, body, streamed) in the order both servers receive them
SCRIPT = [
    ("GET", "/health", None, False),
    ("POST", "/completion", {"prompt": "hello world", "n_predict": 8, "temperature": 0}, False),
    ("POST", "/v1/chat/completions", CHAT, False),
    ("POST", "/completion", {"prompt": "once upon", "n_predict": 6, "temperature": 0,
                             "stream": True}, True),
    ("POST", "/v1/chat/completions", {**CHAT, "max_tokens": 6, "stream": True}, True),
    ("POST", "/v1/completions", {"prompt": [3, 5, 7], "max_tokens": 5, "temperature": 0,
                                 "stream": True}, True),
    ("POST", "/tokenize", {"content": "hello"}, False),
    ("POST", "/detokenize", {"tokens": [1, 104, 101, 108]}, False),
]
VOLATILE = {"id", "created", "timings", "system_fingerprint", "model", "generation_settings",
            "id_slot", "tokens_cached"}


def _strip(obj):
    """Drop the fields that differ between any two runs."""
    if isinstance(obj, dict):
        return {k: _strip(v) for k, v in obj.items() if k not in VOLATILE}
    if isinstance(obj, list):
        return [_strip(v) for v in obj]
    return obj


def _events(raw: str) -> list:
    """SSE body → list of data payloads (JSON, or the literal [DONE])."""
    out = []
    for block in raw.split("\n\n"):
        if not block.strip():
            continue
        assert block.startswith("data: "), block
        data = block[len("data: "):]
        out.append(data if data == "[DONE]" else _strip(json.loads(data)))
    return out


def _port_call(base, method, path, body, headers=AUTH):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(base + path, data=data, method=method,
                                 headers={"Content-Type": "application/json", **headers})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.headers.get("Content-Type", ""), r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type", ""), e.read().decode()


@pytest.fixture(scope="module")
def gguf(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("torch_server") / "tiny-d128.gguf")
    build_tiny_llama(path, seed=4, qtype=GGMLType.Q4_0, n_embd=256, n_heads=2, n_kv_heads=2)
    return path


@pytest.fixture(scope="module")
def port_base(gguf):
    engine = Engine(load_model(gguf), device="cpu", **ENGINE_KW)
    server = Server(engine, model_name="tiny", api_key="secret")
    httpd = server.make_httpd("127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    engine.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    httpd.server_close()
    engine.stop()


@pytest.fixture(scope="module")
def replies(gguf, port_base):
    """Each SCRIPT entry's (status, parsed body) from the port and from JAX."""
    ours = []
    for method, path, body, stream in SCRIPT:
        status, _, text = _port_call(port_base, method, path, body)
        ours.append((status, _events(text) if stream else _strip(json.loads(text))))

    engine = JaxEngine(jax_load_model(gguf), use_pallas=False, context_shift=False,
                       **ENGINE_KW)
    engine.start()

    async def go():
        client = TestClient(TestServer(JaxServer(engine, model_name="tiny",
                                                 api_key="secret").make_app()))
        await client.start_server()
        out = []
        try:
            for method, path, body, stream in SCRIPT:
                r = await client.request(method, path, json=body, headers=AUTH)
                text = await r.text()
                out.append((r.status, _events(text) if stream else _strip(json.loads(text))))
        finally:
            await client.close()
        return out

    try:
        theirs = asyncio.new_event_loop().run_until_complete(go())
    finally:
        engine.stop()
    return ours, theirs


@pytest.mark.parametrize("i", range(len(SCRIPT)), ids=[f"{m} {p}{' stream' if s else ''}"
                                                       for m, p, _, s in SCRIPT])
def test_same_answer_as_jax(replies, i):
    ours, theirs = replies
    assert ours[i][0] == theirs[i][0] == 200
    got, want = ours[i][1], theirs[i][1]
    _, path, _, stream = SCRIPT[i]
    if stream and path == "/completion":
        # the native stream's final stop_type: the JAX engine sets the stop
        # reason after it hands the last event over, so JAX's value races
        assert got[-1]["stop_type"] == "limit" and want[-1]["stop_type"] in ("limit", "none")
        got, want = ([*e[:-1], {k: v for k, v in e[-1].items() if k != "stop_type"}]
                     for e in (got, want))
    assert got == want


def test_answers_carry_text_and_framing(replies):
    ours, _ = replies
    native, chat = ours[1][1], ours[2][1]
    assert native["content"] and native["stop"] is True and native["tokens_predicted"] == 8
    assert chat["choices"][0]["message"]["content"]
    assert chat["choices"][0]["finish_reason"] in ("stop", "length")
    native_stream, chat_stream, v1_stream = ours[3][1], ours[4][1], ours[5][1]
    # the native stream ends on its stop:true payload, the OpenAI ones on [DONE]
    assert native_stream[-1]["stop"] is True and "[DONE]" not in native_stream
    for events in (chat_stream, v1_stream):
        assert events[-1] == "[DONE]"
        assert events[-2]["choices"][0]["finish_reason"] in ("stop", "length")
        assert events[-2]["usage"]["completion_tokens"] >= 1


def test_auth_and_refusals(port_base):
    status, _, _ = _port_call(port_base, "POST", "/v1/completions",
                              {"prompt": "x", "max_tokens": 2}, headers={})
    assert status == 401
    for field, row in (({"grammar": "root ::= \"a\""}, "A1"), ({"logit_bias": {"5": 1.0}}, "A1"),
                       ({"n_probs": 3}, "A4"), ({"repeat_penalty": 1.3}, "A1"),
                       ({"response_format": {"type": "json_schema", "json_schema": {}}}, "A1")):
        status, _, text = _port_call(port_base, "POST", "/completion",
                                     {"prompt": "x", "n_predict": 2, **field})
        assert status == 400 and f"queue {row}" in json.loads(text)["error"]["message"], field
    status, _, text = _port_call(port_base, "POST", "/v1/embeddings", {"input": "x"})
    assert status == 404 and "queue A4" in text
    status, _, _ = _port_call(port_base, "GET", "/no-such-endpoint", None)
    assert status == 404


def test_streamed_prompt_too_long_ends_with_an_error(port_base):
    status, _, text = _port_call(port_base, "POST", "/v1/completions",
                                 {"prompt": "x" * 200, "max_tokens": 2, "stream": True})
    events = _events(text)
    assert status == 200 and events[-1] == "[DONE]"
    assert events[-2]["choices"][0]["finish_reason"] == "error"


def _errors_total(base) -> int:
    status, ctype, text = _port_call(base, "GET", "/metrics", None)
    assert status == 200 and ctype.startswith("text/plain")
    return int(text.split("\nllamacpp:errors_total ")[1].split()[0])


def test_parallel_requests(port_base):
    errors = _errors_total(port_base)
    bodies = [{"prompt": p, "n_predict": 4, "temperature": 0} for p in ("ab", "xyz", "hello")]
    with ThreadPoolExecutor(3) as ex:
        results = list(ex.map(lambda b: _port_call(port_base, "POST", "/completion", b), bodies))
    for status, _, text in results:
        assert status == 200 and json.loads(text)["tokens_predicted"] >= 1
    assert _errors_total(port_base) == errors
    status, _, text = _port_call(port_base, "GET", "/slots", None)
    assert [s["id"] for s in json.loads(text)] == [0, 1]


@pytest.mark.parametrize("template", [None, CHATML_TEMPLATE, *sorted(BUILTIN_TEMPLATES)])
def test_chat_template_matches_jax(template):
    """Builtin names render as in the JAX package; no template, and the
    jinja chatml text, render the JAX package's chatml (the port has no
    jinja2: it detects the family from the template's markers)."""
    messages = CHAT["messages"] + [{"role": "assistant", "content": "hello"},
                                   {"role": "user", "content": "and again?"}]
    assert (apply_chat_template(template, messages, add_generation_prompt=True)
            == jax_apply_chat_template(template, messages, add_generation_prompt=True))


def _serve_once(server_port, server_jax, method, path, body):
    """One request to the port's server and to the JAX server."""
    httpd = server_port.make_httpd("127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    server_port.engine.start()
    try:
        status, _, text = _port_call(f"http://127.0.0.1:{httpd.server_address[1]}", method,
                                     path, body)
    finally:
        httpd.shutdown()
        httpd.server_close()
        server_port.engine.stop()
    server_jax.engine.start()

    async def go():
        client = TestClient(TestServer(server_jax.make_app()))
        await client.start_server()
        try:
            r = await client.request(method, path, json=body, headers=AUTH)
            return r.status, await r.text()
        finally:
            await client.close()

    try:
        jstatus, jtext = asyncio.new_event_loop().run_until_complete(go())
    finally:
        server_jax.engine.stop()
    return (status, _strip(json.loads(text))), (jstatus, _strip(json.loads(jtext)))


def test_llama3_chat_on_q4_k_m_bpe_model_matches_jax(tmp_path):
    from llama_cpp_dsp_tpu_torch.models.llama import LlamaConfig
    from llama_cpp_dsp_tpu_torch.ops.rope import RopeParams
    from llama_cpp_dsp_tpu_torch.tools.synth import write_synth_gguf

    path = str(tmp_path / "synth-q4_k_m-bpe.gguf")
    cfg = LlamaConfig(arch="llama", n_layers=2, n_embd=256, n_heads=2, n_kv_heads=1,
                      head_dim=128, n_ff=512, n_vocab=2048, n_ctx_train=256,
                      rope=RopeParams(n_dims=128, freq_base=500000.0))
    write_synth_gguf(path, cfg, "Q4_K_M", seed=6, vocab="llama-bpe")
    model = load_model(path)
    assert model.vocab.chat_template and model.tokenizer is not None
    ours = Server(Engine(model, device="cpu", **ENGINE_KW), model_name="tiny", api_key="secret")
    theirs = JaxServer(JaxEngine(jax_load_model(path), use_pallas=False, context_shift=False,
                                 **ENGINE_KW), model_name="tiny", api_key="secret")
    got, want = _serve_once(ours, theirs, "POST", "/v1/chat/completions",
                            {**CHAT, "max_tokens": 10})
    assert got[0] == want[0] == 200
    assert got[1] == want[1]
    ch = got[1]["choices"][0]
    assert ch["finish_reason"] in ("stop", "length") and got[1]["usage"]["prompt_tokens"] > 12


def test_slots_save_restore_erase(gguf, port_base, tmp_path):
    """POST /slots/{id}?action=save|restore|erase (JAX serve/server.py
    ::slot_action): 501 without --slot-save-path; a saved slot restores
    into the other slot under the file name's basename; erase forgets a
    slot's rows; a bad slot id is a 400, as is an unknown action; the key
    is checked as for completions."""
    status, _, text = _port_call(port_base, "POST", "/slots/0?action=save", {})
    assert status == 501 and "--slot-save-path" in json.loads(text)["error"]["message"]
    engine = Engine(load_model(gguf), device="cpu", kv_dtype="q4_0", **ENGINE_KW)
    server = Server(engine, model_name="tiny", api_key="secret", slot_save_path=str(tmp_path))
    httpd = server.make_httpd("127.0.0.1", 0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    engine.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        status, _, _ = _port_call(base, "POST", "/completion",
                                  {"prompt": "hello world", "n_predict": 6, "temperature": 0})
        src = next(s for s in engine.slots if s.cache_tokens)
        dst = engine.slots[1 - src.idx]
        status, _, text = _port_call(base, "POST", f"/slots/{src.idx}?action=save",
                                     {"filename": "../../saved.bin"})
        assert status == 200 and json.loads(text) == {
            "id_slot": src.idx, "filename": str(tmp_path / "saved.bin"), "n_saved": src.n_past}
        status, _, text = _port_call(base, "POST", f"/slots/{dst.idx}?action=restore",
                                     {"filename": "saved.bin"})
        assert status == 200 and json.loads(text)["n_restored"] == src.n_past > 0
        assert dst.cache_tokens == src.cache_tokens and dst.n_past == src.n_past
        status, _, text = _port_call(base, "POST", f"/slots/{dst.idx}?action=erase", None)
        assert status == 200 and json.loads(text) == {"id_slot": dst.idx, "n_erased": 1}
        assert dst.cache_tokens == [] and dst.n_past == 0
        for path, want in (("/slots/7?action=erase", "bad slot"),
                           ("/slots/x?action=save", "bad slot"),
                           ("/slots/0?action=nope", "unknown action"),
                           ("/slots/0?action=restore", "No such file")):
            status, _, text = _port_call(base, "POST", path, None)
            assert status == 400 and want in json.loads(text)["error"]["message"], path
        status, _, _ = _port_call(base, "POST", "/slots/0?action=erase", None, headers={})
        assert status == 401
    finally:
        httpd.shutdown()
        httpd.server_close()
        engine.stop()
