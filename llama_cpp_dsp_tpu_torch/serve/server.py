"""OpenAI-compatible HTTP server with continuous batching (counterpart of the
JAX package's serve/server.py), on the Python standard library
(`http.server.ThreadingHTTPServer`): the JAX server's `aiohttp` is not a
dependency of the port.

Endpoints, with the JAX server's JSON fields and SSE framing
(`data: {...}\\n\\n` … `data: [DONE]\\n\\n`): GET /health, /v1/health, /props,
/models, /v1/models, /slots, /metrics; POST /tokenize, /detokenize,
/completion, /completions, /v1/completions, /chat/completions,
/v1/chat/completions, /slots/{id}?action=save|restore|erase (save and
restore need --slot-save-path; runtime/state_io.py); Bearer-key auth on the
completion and slot endpoints. Requests
queue into the Engine, whose thread drives the batched decode loop; each
HTTP connection is served on a thread of its own.

A request field the port cannot honour (grammar, JSON schema, logit bias,
logprobs, tools, a non-default penalty, DRY, XTC, typical, mirostat,
dynatemp or top-n-sigma value) is refused with HTTP 400 naming its ROADMAP.md
row. The JAX server's other endpoints (embeddings, rerank, infill, LoRA
adapters, POST /props, /apply-template, /api/show) answer 404 and are
queued in ROADMAP.md queue A4.

Run: python -m llama_cpp_dsp_tpu_torch.serve.server -m model.gguf --port 8080 -np 4
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import queue
import sys
import time
import urllib.parse
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..runtime.engine import Engine, Request
from ..runtime.kv_cache import KV_PLANE_FORMATS
from ..runtime.sampling import make_chain
from ..runtime.state_io import load_slot, save_slot
from .chat import apply_chat_template

log = logging.getLogger("server")

BUILD_INFO = "llama_cpp_dsp_tpu_torch (torch)"
SYSTEM_FINGERPRINT = "b-llama_cpp_dsp_tpu_torch"

# one defaults table for the sampler (_sampler_from) and the
# generation_settings echo (_effective_settings), as in the JAX server
SAMPLER_DEFAULTS = {
    "seed": 0,
    "temperature": 0.8,
    "dynatemp_range": 0.0,
    "dynatemp_exponent": 1.0,
    "top_k": 40,
    "top_p": 0.95,
    "min_p": 0.05,
    "typical_p": 1.0,
    "xtc_probability": 0.0,
    "xtc_threshold": 0.1,
    "top_n_sigma": -1.0,
    "repeat_last_n": 64,
    "repeat_penalty": 1.0,
    "presence_penalty": 0.0,
    "frequency_penalty": 0.0,
    "dry_multiplier": 0.0,
    "dry_base": 1.75,
    "dry_allowed_length": 2,
    "dry_penalty_last_n": -1,
    "mirostat": 0,
    "mirostat_tau": 5.0,
    "mirostat_eta": 0.1,
}
# sampler knobs the port's chain lacks: any value but the default is refused
_UNPORTED_KNOBS = ("dynatemp_range", "typical_p", "xtc_probability", "top_n_sigma",
                   "repeat_penalty", "presence_penalty", "frequency_penalty", "dry_multiplier",
                   "mirostat")
_LEFT_OUT = {"/props", "/apply-template", "/api/show", "/v1/embeddings", "/embedding",
             "/embeddings", "/v1/rerank", "/rerank", "/reranking", "/v1/reranking", "/infill",
             "/lora-adapters"}


class Unsupported(ValueError):
    """A request field the port cannot honour (HTTP 400)."""


def _effective_settings(body: dict) -> dict:
    """The reference's `generation_settings` echo: request values over the
    defaults."""
    g = body.get
    out = {k: g(k, d) for k, d in SAMPLER_DEFAULTS.items()}
    out.update({
        "n_predict": g("n_predict", g("max_tokens", -1)),
        "stop": g("stop", []),
        "n_keep": g("n_keep", 0),
        "n_discard": g("n_discard", 0),
        "ignore_eos": g("ignore_eos", False),
        "stream": bool(g("stream", False)),
        "n_probs": g("n_probs", 0),
        "grammar": g("grammar", ""),
    })
    return out


def _check_supported(body: dict) -> None:
    rf = body.get("response_format")
    refused = [
        ("grammar", bool(body.get("grammar")), "A1"),
        ("json_schema", body.get("json_schema") is not None, "A1"),
        ("response_format json_schema", isinstance(rf, dict) and rf.get("type") == "json_schema",
         "A1"),
        ("logit_bias", bool(body.get("logit_bias")), "A1"),
        ("samplers infill", "infill" in (body.get("samplers") or []), "A1"),
        ("n_probs", bool(body.get("n_probs")), "A4"),
        ("logprobs", bool(body.get("logprobs")), "A4"),
        ("tools", bool(body.get("tools")), "A4"),
    ]
    refused += [(k, k in body and float(body[k]) != float(SAMPLER_DEFAULTS[k]), "A1")
                for k in _UNPORTED_KNOBS]
    for name, hit, row in refused:
        if hit:
            raise Unsupported(f"'{name}' is not supported by the PyTorch port "
                              f"(ROADMAP.md queue {row})")


def _sampler_from(body: dict, seed_default: int = 0):
    """The request's sampler chain (top-k → top-p → min-p → temp → dist, or
    greedy at temperature ≤ 0); refuses what the port cannot honour."""
    _check_supported(body)

    def g(key):
        return body.get(key, SAMPLER_DEFAULTS[key])

    return make_chain(seed=int(body.get("seed", seed_default) or seed_default),
                      temp=float(g("temperature")), top_k=int(g("top_k")),
                      top_p=float(g("top_p")), min_p=float(g("min_p")))


class Server:
    def __init__(self, engine: Engine, *, model_name: str = "model",
                 api_key: str | None = None, chat_template: str | None = None,
                 slot_save_path: str | None = None):
        self.engine = engine
        self.model_name = model_name
        self.api_key = api_key
        self.chat_template = chat_template  # builtin name or jinja text
        self.slot_save_path = slot_save_path  # directory of slot files
        self.t_start = time.time()

    @property
    def _template(self) -> str | None:
        return self.chat_template or self.engine.vocab.chat_template

    # -- GET endpoints --------------------------------------------------------
    def health(self) -> dict:
        return {"status": "ok"}

    def props(self) -> dict:
        eng = self.engine
        tok, vocab = eng.tokenizer, eng.vocab

        def piece(tid):
            if tok is None or tid is None or tid < 0:
                return ""
            return tok.token_to_piece(int(tid), special=True).decode("utf-8", errors="replace")

        return {
            "model": self.model_name,
            "model_path": self.model_name,
            "n_ctx": eng.n_ctx,
            "n_slots": eng.n_slots,
            "total_slots": eng.n_slots,
            "arch": eng.cfg.arch,
            "n_params_layers": eng.cfg.n_layers,
            "chat_template": self._template or "",
            "bos_token": piece(vocab.bos_id),
            "eos_token": piece(vocab.eos_id),
            "build_info": BUILD_INFO,
            "default_generation_settings": {"id_slot": -1, "n_ctx": eng.n_ctx,
                                            "params": _effective_settings({})},
        }

    def models(self) -> dict:
        cfg, model = self.engine.cfg, self.engine.model
        return {"object": "list", "data": [{
            "id": self.model_name, "object": "model", "created": int(self.t_start),
            "owned_by": "llama_cpp_dsp_tpu",
            "meta": {"vocab_type": str(self.engine.vocab.vocab_type), "n_vocab": cfg.n_vocab,
                     "n_ctx_train": cfg.n_ctx_train, "n_embd": cfg.n_embd,
                     "n_params": model.n_params, "size": model.n_bytes}}]}

    def slots(self) -> list:
        return [{"id": s.idx, "state": s.state.value, "n_past": s.n_past,
                 "rid": s.req.rid if s.req else None} for s in self.engine.slots]

    def metrics(self) -> str:
        m = self.engine.metrics
        lines = [
            "# TYPE llamacpp:prompt_tokens_total counter",
            f"llamacpp:prompt_tokens_total {m['prompt_tokens_total']}",
            "# TYPE llamacpp:tokens_predicted_total counter",
            f"llamacpp:tokens_predicted_total {m['tokens_predicted_total']}",
            "# TYPE llamacpp:requests_total counter",
            f"llamacpp:requests_total {m['n_requests']}",
            "# TYPE llamacpp:errors_total counter",
            f"llamacpp:errors_total {m['n_errors']}",
            "# TYPE llamacpp:kv_cache_usage_ratio gauge",
            f"llamacpp:kv_cache_usage_ratio {self.engine.n_busy_slots / self.engine.n_slots}",
        ]
        return "\n".join(lines) + "\n"

    # -- POST endpoints -------------------------------------------------------
    def tokenize(self, body: dict) -> dict:
        return {"tokens": self.engine.tokenizer.encode(
            body.get("content", ""), add_special=bool(body.get("add_special", False)),
            parse_special=True)}

    def detokenize(self, body: dict) -> dict:
        return {"content": self.engine.tokenizer.decode([int(t) for t in body.get("tokens", [])])}

    def completion_ids(self, body: dict) -> list[int]:
        prompt = body.get("prompt", "")
        if isinstance(prompt, list) and prompt and isinstance(prompt[0], int):
            return [int(t) for t in prompt]
        if isinstance(prompt, list):
            prompt = "".join(prompt)
        return self.engine.tokenizer.encode(prompt, add_special=True, parse_special=True)

    def chat_ids(self, body: dict) -> list[int]:
        text = apply_chat_template(self._template, body.get("messages", []),
                                   add_generation_prompt=True)
        return self.engine.tokenizer.encode(text, add_special=True, parse_special=True)

    def make_request(self, ids: list[int], body: dict, stream_cb=None) -> Request:
        stop = body.get("stop") or []
        if isinstance(stop, str):
            stop = [stop]
        return Request(0, list(ids),
                       max_new_tokens=int(body.get("max_tokens") or body.get("n_predict") or 128),
                       sampler=_sampler_from(body), stop_strings=list(stop), stream_cb=stream_cb)

    @staticmethod
    def _usage(req: Request) -> dict:
        n = len(req.result_tokens)
        return {"prompt_tokens": req.n_prompt, "completion_tokens": n,
                "total_tokens": req.n_prompt + n}

    @staticmethod
    def _timings(req: Request) -> dict:
        return {"prompt_ms": round((req.t_first_token - req.t_start) * 1000, 2),
                "predicted_ms": round((req.t_end - req.t_first_token) * 1000, 2)}

    def native_payload(self, req: Request, body: dict, text: str, timings: dict) -> dict:
        """The reference's native /completion response (server.cpp
        to_json_non_oaicompat)."""
        pn, dn = req.n_prompt, len(req.result_tokens)
        pms, dms = max(timings["prompt_ms"], 0.0), max(timings["predicted_ms"], 0.0)
        if req.stop_reason == "length":
            stop_type = "limit"
        elif req.stop_reason == "stop":
            stop_type = "word" if req.stop_word else "eos"
        else:
            stop_type = "none"
        return {
            "index": 0, "content": text, "tokens": list(req.result_tokens), "id_slot": -1,
            "stop": True, "model": self.model_name, "tokens_predicted": dn,
            "tokens_evaluated": pn, "generation_settings": _effective_settings(body),
            "prompt": self.engine.tokenizer.decode(req.prompt_tokens),
            "has_new_line": text.endswith("\n"), "truncated": False, "stop_type": stop_type,
            "stopping_word": req.stop_word, "tokens_cached": pn + dn - 1,
            "timings": {
                "prompt_n": pn, "prompt_ms": pms,
                "prompt_per_token_ms": round(pms / max(pn, 1), 3),
                "prompt_per_second": round(pn / pms * 1000, 2) if pms else 0.0,
                "predicted_n": dn, "predicted_ms": dms,
                "predicted_per_token_ms": round(dms / max(dn, 1), 3),
                "predicted_per_second": round(dn / dms * 1000, 2) if dms else 0.0,
            },
        }

    def stream_chunk(self, req: Request, body: dict, ev: dict, *, rid: str, created: int,
                     chat: bool, native: bool) -> dict:
        """One SSE event's JSON for engine event `ev`."""
        # usage is null on every chunk but the last (OpenAI stream schema)
        usage = self._usage(req) if ev["finished"] else None
        if chat:
            return {"id": rid, "object": "chat.completion.chunk", "created": created,
                    "model": self.model_name, "system_fingerprint": SYSTEM_FINGERPRINT,
                    "choices": [{"index": 0,
                                 "delta": {"content": ev["piece"]} if ev["piece"] else {},
                                 "finish_reason": ev["finished"]}],
                    "usage": usage}
        if native:
            if ev["finished"] in ("error", "cancelled"):
                return {"index": 0, "content": "", "tokens": [], "stop": True,
                        "error": req.error or ev["finished"]}
            if ev["finished"]:
                text = self.engine.tokenizer.decode(req.result_tokens)
                return self.native_payload(req, body, text, self._timings(req))
            return {"index": 0, "content": ev["piece"],
                    "tokens": [ev["token"]] if ev["piece"] else [], "stop": False}
        return {"id": rid, "object": "text_completion", "created": created,
                "model": self.model_name, "system_fingerprint": SYSTEM_FINGERPRINT,
                "choices": [{"index": 0, "text": ev["piece"], "finish_reason": ev["finished"]}],
                "usage": usage}

    def final_payload(self, req: Request, body: dict, *, rid: str, created: int, chat: bool,
                      native: bool) -> dict:
        text = self.engine.tokenizer.decode(req.result_tokens)
        if body.get("echo") and not chat:
            text = self.engine.tokenizer.decode(req.prompt_tokens) + text
        timings = self._timings(req)
        if chat:
            # surrounding whitespace stripped, as the JAX server's tool-call
            # parser returns the content
            content = text.strip()
            return {"id": rid, "object": "chat.completion", "created": created,
                    "model": self.model_name, "system_fingerprint": SYSTEM_FINGERPRINT,
                    "choices": [{"index": 0,
                                 "message": {"role": "assistant", "content": content or None},
                                 "logprobs": None, "finish_reason": req.stop_reason}],
                    "usage": self._usage(req), "timings": timings}
        if native:
            return self.native_payload(req, body, text, timings)
        return {"id": rid, "object": "text_completion", "created": created,
                "model": self.model_name, "system_fingerprint": SYSTEM_FINGERPRINT,
                "choices": [{"index": 0, "text": text, "logprobs": None,
                             "finish_reason": req.stop_reason}],
                "usage": self._usage(req), "timings": timings}

    def slot_action(self, slot_id: str, action: str, body: dict) -> tuple[int, dict]:
        """Slot save / restore / erase (JAX serve/server.py::slot_action,
        reference server.cpp): save and restore need --slot-save-path (501
        without it) and keep only the file name's basename, joined under that
        directory; a bad slot id is a 400. Runs between engine steps. A save
        records the tokens the slot's rows hold, so a restored slot serves a
        prompt that starts with them as a cached prefix."""
        eng = self.engine
        if action in ("save", "restore"):
            if not self.slot_save_path:
                return 501, _error("start the server with --slot-save-path to enable slot "
                                   "save/restore", "not_supported_error")
            raw = body.get("filename", f"slot_{slot_id}.bin")
            filename = os.path.join(self.slot_save_path, os.path.basename(str(raw)))
        try:
            idx = int(slot_id)
        except ValueError:
            idx = -1
        if not 0 <= idx < eng.n_slots:
            return 400, _error("bad slot", "invalid_request_error")
        slot = eng.slots[idx]
        try:
            with eng.step_lock:
                if action == "save":
                    save_slot(eng, idx, filename, slot.cache_tokens[:slot.n_past])
                    return 200, {"id_slot": idx, "filename": filename, "n_saved": slot.n_past}
                if action == "restore":
                    load_slot(eng, idx, filename)
                    return 200, {"id_slot": idx, "filename": filename,
                                 "n_restored": slot.n_past}
                if action == "erase":
                    eng.erase_slot(idx)
                    return 200, {"id_slot": idx, "n_erased": 1}
        except (OSError, ValueError) as e:
            return 400, _error(str(e), "invalid_request_error")
        return 400, _error("unknown action", "invalid_request_error")

    def make_httpd(self, host: str, port: int) -> ThreadingHTTPServer:
        """The HTTP server bound to (host, port); port 0 takes a free one
        (read it from `.server_address`). Run it with serve_forever()."""
        httpd = ThreadingHTTPServer((host, port), _make_handler(self))
        httpd.daemon_threads = True
        return httpd


def _error(message: str, kind: str) -> dict:
    return {"error": {"message": message, "type": kind}}


def _make_handler(srv: Server):
    class Handler(BaseHTTPRequestHandler):
        server_version = "llama_cpp_dsp_tpu_torch"

        def log_message(self, fmt, *args):  # route the access log to logging
            log.debug("%s " + fmt, self.address_string(), *args)

        def _send(self, status: int, data: bytes, ctype: str) -> None:
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _json(self, status: int, obj) -> None:
            self._send(status, json.dumps(obj).encode(), "application/json; charset=utf-8")

        def _guarded(self, fn) -> None:
            try:
                fn()
            except json.JSONDecodeError:
                self._json(400, _error("invalid JSON body", "invalid_request_error"))
            except Unsupported as e:
                self._json(400, _error(str(e), "invalid_request_error"))
            except (BrokenPipeError, ConnectionResetError):
                pass  # the client went away
            except Exception as e:  # noqa: BLE001 — a handler error is a 500
                log.exception("handler error")
                self._json(500, _error(str(e), "server_error"))

        def do_GET(self) -> None:  # noqa: N802 — http.server's name
            self._guarded(self._get)

        def do_POST(self) -> None:  # noqa: N802
            self._guarded(self._post)

        def _get(self) -> None:
            path = self.path.split("?")[0]
            routes = {"/health": srv.health, "/v1/health": srv.health, "/props": srv.props,
                      "/models": srv.models, "/v1/models": srv.models, "/slots": srv.slots}
            if path in routes:
                self._json(200, routes[path]())
            elif path == "/metrics":
                self._send(200, srv.metrics().encode(), "text/plain; charset=utf-8")
            else:
                self._not_found(path)

        def _not_found(self, path: str) -> None:
            if path in _LEFT_OUT:
                msg = f"{path} is not ported to the PyTorch port (ROADMAP.md queue A4)"
            else:
                msg = f"no endpoint {path}"
            self._json(404, _error(msg, "not_found_error"))

        def _body(self) -> dict:
            n = int(self.headers.get("Content-Length") or 0)
            body = json.loads(self.rfile.read(n) or b"{}")
            if not isinstance(body, dict):
                raise json.JSONDecodeError("body is not a JSON object", "", 0)
            return body

        def _authorized(self) -> bool:
            if srv.api_key and self.headers.get("Authorization", "") != f"Bearer {srv.api_key}":
                self._json(401, _error("invalid api key", "authentication_error"))
                return False
            return True

        def _post(self) -> None:
            path, _, query = self.path.partition("?")
            if path.startswith("/slots/"):
                if self._authorized():
                    action = urllib.parse.parse_qs(query).get("action", [""])[0]
                    self._json(*srv.slot_action(path[len("/slots/"):], action, self._body()))
            elif path == "/tokenize":
                self._json(200, srv.tokenize(self._body()))
            elif path == "/detokenize":
                self._json(200, srv.detokenize(self._body()))
            elif path in ("/completion", "/completions", "/v1/completions",
                          "/chat/completions", "/v1/chat/completions"):
                if not self._authorized():
                    return
                body = self._body()
                chat = path.endswith("chat/completions")
                ids = srv.chat_ids(body) if chat else srv.completion_ids(body)
                # /completion and /completions answer in the reference's
                # native schema; only /v1/completions is OpenAI-shaped
                self._run(body, ids, chat=chat, native=not chat and not path.startswith("/v1/"))
            else:
                self._not_found(path)

        def _run(self, body: dict, ids: list[int], *, chat: bool, native: bool) -> None:
            rid = f"{'chatcmpl' if chat else 'cmpl'}-{uuid.uuid4().hex[:12]}"
            created = int(time.time())
            if not body.get("stream", False):
                req = srv.engine.submit(srv.make_request(ids, body))
                req.done.wait()
                if req.error:
                    self._json(req.error_status, _error(
                        req.error,
                        "server_error" if req.error_status >= 500 else "invalid_request_error"))
                    return
                self._json(200, srv.final_payload(req, body, rid=rid, created=created,
                                                  chat=chat, native=native))
                return
            events: queue.Queue = queue.Queue()
            req = srv.make_request(ids, body, lambda _rid, ev: events.put(ev))
            srv.engine.submit(req)
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.end_headers()
            try:
                while True:
                    ev = events.get()
                    chunk = srv.stream_chunk(req, body, ev, rid=rid, created=created,
                                             chat=chat, native=native)
                    self.wfile.write(f"data: {json.dumps(chunk)}\n\n".encode())
                    if ev["finished"]:
                        break
                if native:  # the native stream ends on its stop:true payload
                    return
                if (body.get("stream_options") or {}).get("include_usage"):
                    usage_chunk = {"id": rid,
                                   "object": "chat.completion.chunk" if chat
                                   else "text_completion",
                                   "created": created, "model": srv.model_name, "choices": [],
                                   "usage": srv._usage(req)}
                    self.wfile.write(f"data: {json.dumps(usage_chunk)}\n\n".encode())
                self.wfile.write(b"data: [DONE]\n\n")
            except (BrokenPipeError, ConnectionResetError):
                srv.engine.cancel(req.rid)

    return Handler


def build_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="llama-server", description=__doc__.splitlines()[0])
    ap.add_argument("-m", "--model", required=True)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("-c", "--ctx-size", type=int, default=2048, help="context per slot")
    ap.add_argument("-np", "--parallel", type=int, default=4, help="number of slots")
    ap.add_argument("--api-key", default=None)
    ap.add_argument("--alias", default=None, help="model name served")
    ap.add_argument("--kv-layout", default="slots", choices=("slots", "paged"),
                    help="paged = shared-prefix page-aliased KV cache")
    ap.add_argument("--kv-page-size", type=int, default=128)
    ap.add_argument("-ctk", "--cache-type-k", default="bf16", choices=KV_PLANE_FORMATS,
                    help="K cache data type (reference --cache-type-k)")
    ap.add_argument("-ctv", "--cache-type-v", default=None, choices=KV_PLANE_FORMATS,
                    help="V cache data type (reference --cache-type-v; defaults to -ctk)")
    ap.add_argument("--slot-save-path", default=None,
                    help="directory for slot save/restore files (required to enable "
                         "/slots/{id}?action=save|restore)")
    ap.add_argument("--chat-template", default=None,
                    help="builtin template name (chatml, llama3, ...) or jinja text "
                         "overriding the model's template")
    ap.add_argument("--decode-chunk", type=int, default=8,
                    help="decode steps per host round trip when every slot is generating")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain versions)")
    return ap


def build(args: argparse.Namespace, model=None):
    """(engine, server, httpd) for parsed arguments, the engine not yet
    started; `model` skips loading args.model when it is already loaded."""
    if model is None:
        from .. import resolve_device
        from ..runtime.loader import load_model

        model = load_model(args.model, resolve_device(args.device))
    engine = Engine(model, n_slots=args.parallel, n_ctx_per_slot=args.ctx_size,
                    kv_layout=args.kv_layout, page_size=args.kv_page_size,
                    kv_dtype=args.cache_type_k, kv_v_dtype=args.cache_type_v,
                    decode_chunk=args.decode_chunk, device=args.device)
    server = Server(engine, model_name=args.alias or args.model, api_key=args.api_key,
                    chat_template=args.chat_template, slot_save_path=args.slot_save_path)
    return engine, server, server.make_httpd(args.host, args.port)


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    engine, _, httpd = build(args)
    engine.start()
    print(f"listening on http://{args.host}:{httpd.server_address[1]}", file=sys.stderr)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        engine.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
