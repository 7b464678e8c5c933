"""Continuous-batching engine (counterpart of the JAX package's
runtime/engine.py: `SlotState`, `Request`, `_Slot`, `Engine`).

N fixed slots share one batched KV cache (contiguous slots of any -ctk /
-ctv type, or paged with shared-prefix pages of f32, f16, bf16, Q8_0 or
Q4_0 rows). Prompt processing is chunked into
bucketed shapes; all generating slots decode together in one [B, 1] step
per iteration, and when prompt work and decode work are both pending (or on
the paged layout) one packed prompt+decode pass serves them together.
Sampling and stop handling are host-side per slot, except that greedy and
uniform stateless chains sample on the device so only token ids come back.

The JAX package's jitted programs become eager calls into models/llama.py;
its `lax.scan` of decode+sample steps becomes a Python loop that keeps each
sampled id on the device and brings a chunk's ids back at once. Left out
(ROADMAP.md queue A4): the draft model and speculative decoding, tensor
parallelism, embeddings and rerank, LoRA hot-swap, echo+logprobs, and
context shift (A2): a slot that fills its context stops with "length".
"""

from __future__ import annotations

import contextlib
import enum
import logging
import queue
import threading
import time
from collections.abc import Callable
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import resolve_device
from ..models.llama import forward, forward_packed
from ..ops.device_sampling import sample_logits
from .cache_ops import copy_slot
from .context import convert_params_to_kernel
from .kv_cache import _DENSE_DTYPES, make_kv_cache, norm_kv_type
from .loader import LoadedModel, map_tensors
from .paged_kv import PageAllocator, PagedKVCache, PagedQ4KVCache, PagedQuantKVCache, PagedSeq
from .sampling import SamplerChain, make_chain

log = logging.getLogger(__name__)


class SlotState(enum.Enum):
    FREE = "free"
    PROMPT = "prompt"
    GENERATING = "generating"


@dataclass
class Request:
    rid: int
    prompt_tokens: list[int]
    max_new_tokens: int = 128
    sampler: SamplerChain | None = None
    stop_tokens: set[int] = field(default_factory=set)
    stop_strings: list[str] = field(default_factory=list)
    stream_cb: Callable[[int, dict], None] | None = None  # (rid, event)
    # filled by the engine
    result_tokens: list[int] = field(default_factory=list)
    done: threading.Event = field(default_factory=threading.Event)
    error: str | None = None
    error_status: int = 400  # HTTP status the server maps `error` to
    # (400 = request rejected, 500 = engine fault mid-decode)
    stop_reason: str = ""
    stop_word: str = ""  # the stop string that fired
    cancelled: bool = False
    t_start: float = 0.0
    t_first_token: float = 0.0
    t_end: float = 0.0

    @property
    def n_prompt(self) -> int:
        return len(self.prompt_tokens)


@dataclass
class _Slot:
    idx: int
    state: SlotState = SlotState.FREE
    req: Request | None = None
    n_past: int = 0
    prompt_pos: int = 0  # tokens of the prompt already processed
    last_token: int = -1
    generated: int = 0
    decoded_text_len: int = 0
    # tokens whose KV rows are valid in this slot (survives slot FREE — the
    # per-slot prompt cache, reference server slot.cache_tokens)
    cache_tokens: list[int] = field(default_factory=list)


class Engine:
    """Owns the device state; drive with submit() + start(), or step()."""

    def __init__(
        self,
        model: LoadedModel,
        *,
        n_slots: int = 4,
        n_ctx_per_slot: int = 1024,
        kv_dtype: str = "bf16",  # -ctk: f32 | f16 | bf16 | q8_0 | q4_0 | q4_1 | q5_0 | q5_1
        # | iq4_nl (paged: f32, f16, bf16, q8_0, q4_0)
        kv_v_dtype: str | None = None,  # -ctv, when V's type differs from K's (slots only)
        prefill_buckets: tuple[int, ...] = (32, 128, 512),
        context_shift: bool = False,
        kv_layout: str = "slots",  # "slots" | "paged" (shared-prefix pages)
        page_size: int = 128,
        decode_chunk: int | None = None,  # decode steps per host round trip
        # when every slot is generating; None = 8 on the card, 1 on the CPU
        device=None,  # None → the card; "cpu" runs the kernels' plain versions
    ):
        if context_shift:
            raise NotImplementedError("context shift is not ported (ROADMAP.md queue A2)")
        self.device = resolve_device(device)
        if decode_chunk is None:
            decode_chunk = 8 if self.device.type == "cuda" else 1
        self.decode_chunk = max(1, decode_chunk)
        self.model = model
        self.cfg = cfg = model.cfg
        self.vocab = model.vocab
        self.tokenizer = model.tokenizer
        self.n_slots = n_slots
        self.n_ctx = n_ctx_per_slot
        self.prefill_buckets = [b for b in prefill_buckets if b <= n_ctx_per_slot] or [
            n_ctx_per_slot]
        kv_dtype = norm_kv_type(kv_dtype)
        # JAX engine.py::_mixed_ok: MLA never takes the packed prompt+decode
        # pass (per-slot prefill, then the batched decode step), so it has
        # no paged layout
        self._mixed_ok = not cfg.kv_lora_rank
        if kv_layout == "paged":
            # the JAX engine's rules and wording (engine.py:163-200)
            if kv_v_dtype is not None and norm_kv_type(kv_v_dtype) != kv_dtype:
                raise ValueError("paged KV does not support split -ctk/-ctv "
                                 f"({kv_dtype} vs {kv_v_dtype}); use kv_layout='slots'")
            if kv_dtype not in ("q8_0", "q4_0", *_DENSE_DTYPES):
                raise ValueError(f"paged KV does not support -ctk {kv_dtype}; "
                                 "use q8_0/q4_0 or kv_layout='slots'")
            if not self._mixed_ok:
                raise ValueError(f"kv_layout='paged' requires the packed decoder path "
                                 f"(arch {cfg.arch} runs MLA)")
        self.params = convert_params_to_kernel(
            map_tensors(model.params, lambda t: t.to(self.device)))
        self.kv_layout = kv_layout
        # serializes engine steps with slot save / restore / erase, which
        # the server runs on its own threads
        self.step_lock = threading.Lock()
        if kv_layout == "paged":
            blocks = -(-n_ctx_per_slot // page_size)
            self.n_ctx = blocks * page_size
            n_pages = n_slots * blocks + n_slots  # + copy-on-write slack
            self._page_alloc = PageAllocator(n_pages)
            self._seqs = [PagedSeq(self._page_alloc, blocks) for _ in range(n_slots)]
            geometry = (cfg.n_layers, n_pages, n_slots, blocks, cfg.kv_cache_heads,
                        cfg.kv_cache_dim)
            if kv_dtype == "q8_0":
                self.cache = PagedQuantKVCache.create(*geometry, page_size=page_size,
                                                      device=self.device)
            elif kv_dtype == "q4_0":
                self.cache = PagedQ4KVCache.create(*geometry, page_size=page_size,
                                                   device=self.device)
            else:
                self.cache = PagedKVCache.create(*geometry, page_size=page_size,
                                                 device=self.device,
                                                 dtype=_DENSE_DTYPES[kv_dtype])
        elif kv_layout == "slots":
            self.cache = make_kv_cache(cfg.n_layers, n_slots, n_ctx_per_slot, cfg.kv_cache_heads,
                                       cfg.kv_cache_dim, kv_dtype, device=self.device,
                                       v_type=kv_v_dtype)
        else:
            raise ValueError(f"kv_layout {kv_layout!r}: 'slots' or 'paged'")
        self.slots = [_Slot(i) for i in range(n_slots)]
        self.queue: queue.Queue[Request] = queue.Queue()
        self._rid = 0
        self._prefill_rr = 0  # round-robin start over prompt slots
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(0)
        # metrics (reference server.cpp /metrics)
        self.metrics = {
            "prompt_tokens_total": 0,
            "tokens_predicted_total": 0,
            "n_requests": 0,
            "n_errors": 0,
        }

    # -- request API --------------------------------------------------------
    def submit(self, req: Request) -> Request:
        with self._lock:
            self._rid += 1
            req.rid = self._rid
            self.metrics["n_requests"] += 1
        req.t_start = time.perf_counter()
        self.queue.put(req)
        return req

    def generate_sync(self, prompt_tokens: list[int], **kw) -> Request:
        req = Request(0, list(prompt_tokens), **kw)
        self.submit(req)
        if self._thread is None:
            while not req.done.is_set():
                self.step()
        else:
            req.done.wait()
        return req

    def start(self) -> None:
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, name="engine", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=30)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                with self.step_lock:
                    worked = self.step()
            except Exception as e:  # noqa: BLE001 — last-resort fence: anything
                # escaping step()'s per-operation fences (e.g. slot assignment)
                # must not kill the worker thread and hang every queued request
                log.exception("engine loop error; failing busy slots")
                self._fail_slots([s for s in self.slots if s.state != SlotState.FREE], e)
                continue
            if not worked:
                try:
                    req = self.queue.get(timeout=0.05)
                    self.queue.put(req)  # step() will pick it up
                except queue.Empty:
                    pass

    # -- engine core ----------------------------------------------------------
    @staticmethod
    def _common_prefix(a: list[int], b: list[int]) -> int:
        n = 0
        for x, y in zip(a, b):
            if x != y:
                break
            n += 1
        return n

    def _assign_slots(self) -> None:
        while True:
            free = [s for s in self.slots if s.state == SlotState.FREE]
            if not free:
                return
            try:
                req = self.queue.get_nowait()
            except queue.Empty:
                return
            if req.n_prompt >= self.n_ctx:
                req.error = f"prompt ({req.n_prompt} tokens) exceeds slot context {self.n_ctx}"
                req.stop_reason = "error"
                self.metrics["n_errors"] += 1
                # a streamed request hears of it too (the JAX engine sets
                # only `done`, and its SSE stream waits forever)
                if req.stream_cb is not None:
                    req.stream_cb(req.rid, {"token": -1, "piece": "", "finished": "error"})
                req.done.set()
                continue
            # prompt-cache reuse (reference update_slots common-prefix reuse +
            # llama_kv_self_seq_cp): the FREE slot with the longest cached
            # common prefix (ties: the least cached content); if another slot
            # caches a longer one, its rows are copied (slots) or its full
            # pages aliased (paged) into the chosen slot
            slot = max(free, key=lambda s: (
                self._common_prefix(s.cache_tokens, req.prompt_tokens), -len(s.cache_tokens)))
            n_reuse = min(self._common_prefix(slot.cache_tokens, req.prompt_tokens),
                          req.n_prompt - 1)
            donor = max(self.slots, key=lambda s: self._common_prefix(
                s.cache_tokens, req.prompt_tokens))
            n_donor = min(self._common_prefix(donor.cache_tokens, req.prompt_tokens),
                          req.n_prompt - 1)
            if self.kv_layout == "paged":
                ps = self.cache.page_size
                if donor is not slot and (n_donor // ps) * ps > n_reuse:
                    # zero-copy: alias the donor's full prefix pages
                    shared = self._seqs[slot.idx].share_prefix_from(
                        self._seqs[donor.idx], n_donor, ps)
                    self.cache.set_table_row(
                        slot.idx, self._seqs[slot.idx].table_row(self.cache.n_pages))
                    slot.cache_tokens = list(donor.cache_tokens[:shared])
                    n_reuse = min(shared, req.n_prompt - 1)
                # blocks past the reused prefix must be exclusively owned
                self._cow_from(slot.idx, n_reuse)
            elif donor is not slot and n_donor > n_reuse + 16:
                copy_slot(self.cache, donor.idx, slot.idx)
                slot.cache_tokens = list(donor.cache_tokens)
                n_reuse = n_donor
            slot.state = SlotState.PROMPT
            slot.req = req
            slot.n_past = n_reuse
            slot.prompt_pos = n_reuse
            slot.generated = 0
            slot.decoded_text_len = 0
            slot.cache_tokens = list(req.prompt_tokens[:n_reuse])
            if n_reuse:
                self.metrics["prompt_tokens_cached"] = (
                    self.metrics.get("prompt_tokens_cached", 0) + n_reuse)
            if req.sampler is None:
                req.sampler = make_chain(temp=0.0)
            log.info("slot %d: rid=%d prompt=%d tokens (%d cached)", slot.idx, req.rid,
                     req.n_prompt, n_reuse)

    def step(self) -> bool:
        """One engine iteration. Returns True if any work was done.

        When prompt work and generating slots coexist (or on the paged
        layout, which has no per-slot contiguous view), one packed program
        serves them together; otherwise, and always for MLA, one prompt chunk
        per iteration (round-robin over prompt slots), then one batched
        decode."""
        self._assign_slots()
        worked = False

        gen = [s for s in self.slots if s.state == SlotState.GENERATING]
        has_prompt = any(s.state == SlotState.PROMPT for s in self.slots)
        if self._mixed_ok and has_prompt and (gen or self.kv_layout == "paged"):
            busy = [s for s in self.slots if s.state != SlotState.FREE]
            with self._kv_fence(busy):
                self._mixed_step(gen)
            return True

        # 1. one prompt chunk per iteration (round-robin over prompt slots)
        start = self._prefill_rr
        for slot in self.slots[start:] + self.slots[:start]:
            if slot.state != SlotState.PROMPT:
                continue
            with self._kv_fence([slot]):
                req = slot.req
                remaining = req.prompt_tokens[slot.prompt_pos:]
                chunk = remaining[:self._bucket(len(remaining))]
                logits = self._prefill_slot(slot, chunk)
                slot.prompt_pos += len(chunk)
                slot.n_past += len(chunk)
                slot.cache_tokens = list(req.prompt_tokens[:slot.prompt_pos])
                self.metrics["prompt_tokens_total"] += len(chunk)
                if slot.prompt_pos >= req.n_prompt:
                    token = req.sampler.sample(logits)
                    req.t_first_token = time.perf_counter()
                    slot.state = SlotState.GENERATING
                    self._emit_token(slot, token)
            worked = True
            self._prefill_rr = (slot.idx + 1) % self.n_slots
            break  # at most one chunk per step keeps decode latency bounded

        # 2. batched decode for all generating slots
        gen = [s for s in self.slots if s.state == SlotState.GENERATING]
        if gen:
            with self._kv_fence(gen):
                self._decode_gen(gen)
            worked = True
        return worked

    def _decode_steps(self, tokens, positions, active, chunk: int, spec: dict | None):
        """`chunk` batched decode steps. spec set: each step samples on the
        device (top_k 1 is argmax) and feeds the id back; returns the ids
        [B, chunk] (one host sync). spec None: one step; returns logits
        [B, V] on the host."""
        dev = self.device
        toks = torch.from_numpy(tokens).to(dev, torch.long)
        pos = torch.from_numpy(positions).to(dev)
        act = torch.from_numpy(active).to(dev)
        inc = act.to(torch.int32)[:, None]
        ids = []
        for _ in range(chunk):
            # idle slots write at capacity (dropped): a 0 offset would clobber
            # row 0 of their prompt caches every decode round
            offs = torch.where(act, pos[:, 0], self.cache.capacity)
            logits = forward(self.params, self.cfg, toks, pos, self.cache, offs)[:, 0]
            if spec is None:
                return logits.cpu().numpy()
            nxt = sample_logits(logits, self._generator, spec["temp"], top_k=spec["top_k"],
                                top_p=spec["top_p"], min_p=spec["min_p"])
            ids.append(nxt)
            toks = nxt[:, None]
            pos = pos + inc
        return torch.stack(ids, dim=1).cpu().numpy()

    def _decode_gen(self, gen: list[_Slot]) -> None:
        # several steps per host round trip when no prompt work is pending and
        # no slot can reach its context boundary mid-chunk
        chunk = 1
        if (self.decode_chunk > 1
                and not any(s.state == SlotState.PROMPT for s in self.slots)
                and self.queue.empty()
                and all(s.n_past + self.decode_chunk + 1 < self.n_ctx for s in gen)):
            chunk = self.decode_chunk
        self._ensure_pages([(s.idx, s.n_past + chunk) for s in gen])
        tokens = np.zeros((self.n_slots, 1), np.int64)
        positions = np.zeros((self.n_slots, 1), np.int32)
        active = np.zeros(self.n_slots, bool)
        for s in gen:
            tokens[s.idx, 0] = s.last_token
            positions[s.idx, 0] = s.n_past
            active[s.idx] = True

        specs = [s.req.sampler.device_spec for s in gen]
        if all(s.req.sampler.is_greedy for s in gen):
            spec = {"top_k": 1, "top_p": 1.0, "min_p": 0.0, "temp": 1.0}
        elif all(sp is not None and sp == specs[0] for sp in specs):
            spec = specs[0]  # uniform stateless chains sample on the device
        else:
            logits = self._decode_steps(tokens, positions, active, 1, None)
            for s in gen:
                s.cache_tokens.append(s.last_token)
                s.n_past += 1
                self._emit_token(s, s.req.sampler.sample(logits[s.idx]))
            return
        ids = self._decode_steps(tokens, positions, active, chunk, spec)
        for s in gen:
            for j in range(chunk):
                s.cache_tokens.append(s.last_token)
                s.n_past += 1
                self._emit_token(s, int(ids[s.idx, j]))
                if s.state != SlotState.GENERATING:
                    break  # overshoot rows sit beyond n_past

    def _fail_slots(self, slots: list[_Slot], exc: BaseException) -> None:
        """Fail every request on `slots` and free them; the engine keeps
        serving (reference server.cpp: send_error + slot.release)."""
        for s in slots:
            req = s.req
            s.state = SlotState.FREE
            s.req = None
            s.cache_tokens = []  # rows written by the failed step are untrusted
            if self.kv_layout == "paged":
                self._seqs[s.idx].release()
            self.metrics["n_errors"] += 1
            if req is not None and not req.done.is_set():
                req.error = f"decode failed: {type(exc).__name__}: {exc}"
                req.error_status = 500
                req.stop_reason = "error"
                req.t_end = time.perf_counter()
                if req.stream_cb is not None:
                    req.stream_cb(req.rid, {"token": -1, "piece": "", "finished": "error"})
                req.done.set()

    @contextlib.contextmanager
    def _kv_fence(self, slots: list[_Slot]):
        """Failure containment around one engine operation: if it raises,
        fail ONLY the participating requests, release their pages, re-sync
        every block-table row from the host PagedSeqs (the operation may have
        appended pages before raising), and keep the engine serving.

        The JAX package also restores the old functional cache handles. The
        port writes the cache in place and keeps no snapshot, which is safe:
        an operation writes only its participating slots' rows (an idle
        slot's decode write is dropped, a prompt chunk goes to its own slot
        or pages, shared pages are copied before a write), and every row it
        writes lies at or beyond its slot's n_past, which did not advance.
        Those rows are never attended before they are written again, and the
        failed slots' cache_tokens are cleared, so no prompt reuses them."""
        try:
            yield
        except Exception as e:  # noqa: BLE001 — the fence must catch everything
            log.exception("engine step failed; containing to slots %s", [s.idx for s in slots])
            self._fail_slots(slots, e)
            if self.kv_layout == "paged":
                for i in range(self.n_slots):
                    self.cache.set_table_row(i, self._seqs[i].table_row(self.cache.n_pages))

    def _ensure_pages(self, needs: list[tuple[int, int]]) -> None:
        """Paged layout: grow block tables to cover (slot, n_tokens) writes."""
        if self.kv_layout != "paged":
            return
        for idx, n in needs:
            if self._seqs[idx].ensure(n, self.cache.page_size):
                self.cache.set_table_row(idx, self._seqs[idx].table_row(self.cache.n_pages))

    def _cow_from(self, idx: int, from_row: int) -> None:
        """Paged layout: make every block of slot idx from `from_row` on
        exclusively owned (copy-on-write) before it is overwritten."""
        if self.kv_layout != "paged":
            return
        seq = self._seqs[idx]
        changed = False
        for blk in range(from_row // self.cache.page_size, len(seq.pages)):
            changed = seq.make_writable(blk, self.cache) or changed
        if changed:
            self.cache.set_table_row(idx, seq.table_row(self.cache.n_pages))

    def _mixed_step(self, gen: list[_Slot]) -> None:
        """One packed prompt+decode iteration: every generating slot's next
        token plus prompt chunks from as many PROMPT slots as fit the token
        budget, in one pass over the weights (reference update_slots)."""
        start = self._prefill_rr
        rotation = self.slots[start:] + self.slots[:start]
        prompts = [s for s in rotation if s.state == SlotState.PROMPT]
        budget = max(1, self.prefill_buckets[-1] - len(gen))
        chunks: list[tuple[_Slot, list[int]]] = []
        for s in prompts:
            if budget <= 0:
                break
            take = s.req.prompt_tokens[s.prompt_pos:][:budget]
            if take:
                chunks.append((s, take))
                budget -= len(take)
        p = self._bucket(len(gen) + sum(len(c) for _, c in chunks))
        room = p - len(gen)  # the bucket may be smaller: trim the last chunks
        trimmed = []
        for s, c in chunks:
            if room <= 0:
                break
            trimmed.append((s, c[:room]))
            room -= len(trimmed[-1][1])
        chunks = trimmed

        tokens = np.zeros(p, np.int64)
        slot_ids = np.zeros(p, np.int64)
        rows = np.full(p, self.n_ctx, np.int64)  # capacity ⇒ padding, dropped
        out_idx = np.zeros(self.n_slots, np.int64)
        i = 0
        for s in gen:
            tokens[i], slot_ids[i], rows[i] = s.last_token, s.idx, s.n_past
            out_idx[s.idx] = i
            i += 1
        for s, c in chunks:
            for j, t in enumerate(c):
                tokens[i], slot_ids[i], rows[i] = t, s.idx, s.n_past + j
                i += 1
            out_idx[s.idx] = i - 1

        self._ensure_pages([(s.idx, s.n_past + 1) for s in gen]
                           + [(s.idx, s.n_past + len(c)) for s, c in chunks])
        dev = self.device
        logits = forward_packed(self.params, self.cfg, *(torch.from_numpy(a).to(dev) for a in (
            tokens, slot_ids, rows)), self.cache, torch.from_numpy(out_idx).to(dev))
        logits = logits.cpu().numpy()

        for s in gen:
            s.cache_tokens.append(s.last_token)
            s.n_past += 1
            self._emit_token(s, s.req.sampler.sample(logits[s.idx]))
        for s, c in chunks:
            req = s.req
            s.prompt_pos += len(c)
            s.n_past += len(c)
            s.cache_tokens = list(req.prompt_tokens[:s.prompt_pos])
            self.metrics["prompt_tokens_total"] += len(c)
            if s.prompt_pos >= req.n_prompt:
                token = req.sampler.sample(logits[s.idx])
                req.t_first_token = time.perf_counter()
                s.state = SlotState.GENERATING
                self._emit_token(s, token)
        if chunks:
            self._prefill_rr = (chunks[-1][0].idx + 1) % self.n_slots

    def _bucket(self, n: int) -> int:
        for b in self.prefill_buckets:
            if n <= b:
                return b
        return self.prefill_buckets[-1]

    def _prefill_slot(self, slot: _Slot, chunk: list[int]) -> np.ndarray:
        """One prompt chunk into the slot's own cache rows (the slot's view
        of the batched cache, written in place); returns the last token's
        logits. Padding rows repeat position n_past, as in the JAX engine,
        and are cut at the slot's capacity (the JAX write would clamp the
        chunk's start there instead)."""
        n = len(chunk)
        tpad = min(self._bucket(n), self.n_ctx - slot.n_past)
        toks = np.zeros((1, tpad), np.int64)
        toks[0, :n] = chunk
        pos = np.full((1, tpad), slot.n_past, np.int32)
        pos[0, :n] = slot.n_past + np.arange(n)
        dev = self.device
        logits = forward(self.params, self.cfg, torch.from_numpy(toks).to(dev),
                         torch.from_numpy(pos).to(dev), self.cache.slot(slot.idx), slot.n_past)
        return logits[0, n - 1].cpu().numpy()

    def cancel(self, rid: int) -> bool:
        """Cancel a queued or running request (client disconnect / abort)."""
        for slot in self.slots:
            if slot.req is not None and slot.req.rid == rid:
                slot.req.cancelled = True
                return True
        drained, found = [], False
        try:
            while True:
                r = self.queue.get_nowait()
                if r.rid == rid:
                    r.cancelled = True
                    r.error = "cancelled"
                    r.done.set()
                    found = True
                else:
                    drained.append(r)
        except queue.Empty:
            pass
        for r in drained:
            self.queue.put(r)
        return found

    def _emit_token(self, slot: _Slot, token: int) -> None:
        req = slot.req
        if req.cancelled:
            req.stop_reason = "cancelled"
            req.t_end = time.perf_counter()
            slot.state = SlotState.FREE
            slot.req = None
            if req.stream_cb is not None:
                req.stream_cb(req.rid, {"token": -1, "piece": "", "finished": "cancelled"})
            req.done.set()
            return
        slot.last_token = token
        req.result_tokens.append(token)
        slot.generated += 1
        self.metrics["tokens_predicted_total"] += 1

        finished = None
        if self.vocab is not None and self.vocab.is_eog(token):
            finished = "stop"
        elif token in req.stop_tokens:
            finished = "stop"
        elif slot.generated >= req.max_new_tokens:
            finished = "length"
        elif slot.n_past + 1 >= self.n_ctx:
            finished = "length"  # context full; context shift is queue A2

        piece = ""
        if self.tokenizer is not None:
            text = self.tokenizer.decode(req.result_tokens)
            piece = text[slot.decoded_text_len:]
            for stop in req.stop_strings:
                if stop in text:
                    piece = text[slot.decoded_text_len:text.index(stop)]
                    finished = "stop"
                    req.stop_word = stop
                    break
            if not finished:
                slot.decoded_text_len = len(text)
        if finished:
            # set before the stream hears of the end: the server builds the
            # final chunk from them on another thread (the JAX engine sets
            # them after, and its native stream's stop_type races)
            req.stop_reason = finished
            req.t_end = time.perf_counter()
        if req.stream_cb is not None and (piece or finished):
            req.stream_cb(req.rid, {"token": token, "piece": piece, "finished": finished})

        if finished:
            slot.state = SlotState.FREE
            slot.req = None
            req.done.set()

    def erase_slot(self, idx: int) -> None:
        """Forget a free slot's cached rows (server /slots/{id}?action=erase);
        a paged slot gives its pages back."""
        slot = self.slots[idx]
        if slot.req is not None:
            raise ValueError(f"slot {idx} is busy")
        slot.n_past = 0
        slot.cache_tokens = []
        if self.kv_layout == "paged":
            self._seqs[idx].release()
            self.cache.set_table_row(idx, self._seqs[idx].table_row(self.cache.n_pages))

    @property
    def n_busy_slots(self) -> int:
        return sum(1 for s in self.slots if s.state != SlotState.FREE)
