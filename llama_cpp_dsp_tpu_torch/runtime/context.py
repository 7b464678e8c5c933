"""Decode context — counterpart of the JAX package's runtime/context.py
(`convert_params_to_kernel`, `LlamaContext`).

Owns the device params and the KV cache of any -ctk / -ctv type
(`make_kv_cache`), evaluates prompts and decode steps in bf16, and drives
generation. JAX's jit-compiled steps become eager calls;
its `lax.scan` of fused decode+sample steps becomes a Python loop that keeps
each sampled token on the device and brings the chunk's ids back at once.
"""

from __future__ import annotations

import time
from collections.abc import Iterator
from dataclasses import dataclass

import numpy as np
import torch

from .. import resolve_device
from ..models.llama import forward
from ..ops.device_sampling import sample_logits
from ..ops.qtensor import QTensor
from .kv_cache import make_kv_cache
from .loader import LoadedModel, map_tensors
from .sampling import Greedy, SamplerChain


PREFILL_BUCKETS = (32, 128, 512, 2048)  # prompt chunk sizes; the first call
# of each counts as warm-up in the perf line, as JAX counts compiles
DECODE_CHUNK = 8  # decode+sample steps per host round trip


def _bucket(n: int, buckets: list[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def _concat_rows(ws: list[QTensor]) -> QTensor:
    return QTensor(ws[0].kind, (sum(w.shape[0] for w in ws), ws[0].shape[1]),
                   {k: torch.cat([w.arrays[k] for w in ws]) for k in ws[0].arrays})


def convert_params_to_kernel(params: dict) -> dict:
    """Row-fuse the q|k|v and gate|up QTensors of each layer into one weight
    each ("attn_qkv_fused", "ffn_gateup_fused"), so each pair or triple is
    one kernel call. The port keeps GGUF block order, so fusing is a
    concatenation of rows. The q/k/v biases stay apart under their own keys
    and are added after the fused output is split, as JAX does. Expert
    stacks are never fused (JAX's `fusable`); they keep their expert axis
    for the selected-expert kernel."""
    params = dict(params)
    new_layers = []
    for layer in params["layers"]:
        layer = dict(layer)
        for fused_key, names in (("attn_qkv_fused", ("attn_q", "attn_k", "attn_v")),
                                 ("ffn_gateup_fused", ("ffn_gate", "ffn_up"))):
            ws = [layer.get(nm) for nm in names]
            if not all(isinstance(w, QTensor) and not w.n_expert for w in ws):
                continue
            if len({(w.kind, w.shape[1]) for w in ws}) != 1:
                continue
            layer[fused_key] = _concat_rows(ws)
            for nm in names:
                del layer[nm]
        new_layers.append(layer)
    params["layers"] = new_layers
    return params


@dataclass
class PerfCounters:
    """llama_perf_context-style counters. The first call of each step shape
    is counted apart (the JAX package's compile time; here the warm-up,
    which includes building the kernels on first use)."""

    t_prefill_ms: float = 0.0
    t_decode_ms: float = 0.0
    t_compile_ms: float = 0.0
    n_prefill: int = 0
    n_decode: int = 0

    def report(self) -> str:
        pp = self.n_prefill / self.t_prefill_ms * 1000 if self.t_prefill_ms else 0
        tg = self.n_decode / self.t_decode_ms * 1000 if self.t_decode_ms else 0
        return (
            f"prefill: {self.n_prefill} tok in {self.t_prefill_ms:.1f} ms ({pp:.2f} t/s) | "
            f"decode: {self.n_decode} tok in {self.t_decode_ms:.1f} ms ({tg:.2f} t/s) | "
            f"compile: {self.t_compile_ms:.1f} ms"
        )


class LlamaContext:
    def __init__(
        self,
        model: LoadedModel,
        *,
        n_ctx: int = 2048,
        device=None,  # None → the card; "cpu" runs the kernels' plain versions
        fused_attn: bool = True,  # decode through the fused QKV+rope+write+attention
        # kernel where in scope; off, decode attention takes flash decode
        kv_dtype: str = "bf16",  # -ctk: f32 | f16 | bf16 | q8_0 | q4_0 | q4_1 | q5_0
        # | q5_1 | iq4_nl
        kv_v_dtype: str | None = None,  # -ctv, when V's type differs from K's
    ):
        self.device = resolve_device(device)
        self.cfg = model.cfg
        self.vocab = model.vocab
        self.tokenizer = model.tokenizer
        self.n_ctx = n_ctx
        self.prefill_buckets = [b for b in PREFILL_BUCKETS if b <= n_ctx] or [n_ctx]
        self.fused_attn = fused_attn
        self.params = convert_params_to_kernel(
            map_tensors(model.params, lambda t: t.to(self.device)))
        self.cache = make_kv_cache(self.cfg.n_layers, 1, n_ctx, self.cfg.kv_cache_heads,
                                   self.cfg.kv_cache_dim, kv_dtype, self.device,
                                   v_type=kv_v_dtype)
        self.generator = torch.Generator(device=self.device)
        self.n_past = 0
        self.perf = PerfCounters()
        self._seen_shapes: set = set()

    def _forward(self, tokens: torch.Tensor, n_past: int) -> torch.Tensor:
        t = tokens.shape[1]
        pos = torch.arange(n_past, n_past + t, dtype=torch.int32, device=self.device)[None]
        return forward(self.params, self.cfg, tokens, pos, self.cache, n_past,
                       fused=self.fused_attn)

    def reset(self) -> None:
        self.n_past = 0

    def rollback_to(self, n_past: int) -> None:
        """Forget the rows past n_past: only the counter moves, since a row is
        written again before it can be attended."""
        if not 0 <= n_past <= self.n_past:
            raise ValueError(f"rollback to {n_past} outside [0, {self.n_past}]")
        self.n_past = n_past

    def _account(self, key, dt_ms: float, n: int, decode: bool) -> None:
        if key not in self._seen_shapes:
            self._seen_shapes.add(key)
            self.perf.t_compile_ms += dt_ms
        elif decode:
            self.perf.t_decode_ms += dt_ms
            self.perf.n_decode += n
        else:
            self.perf.t_prefill_ms += dt_ms
            self.perf.n_prefill += n

    def eval_tokens(self, tokens: list[int]) -> np.ndarray:
        """Feed tokens at the current position; returns the logits of the
        LAST token [vocab] (f32, host)."""
        n = len(tokens)
        if n == 0:
            raise ValueError("empty token batch")
        if self.n_past + n > self.n_ctx:
            raise RuntimeError(f"context overflow: {self.n_past}+{n} > {self.n_ctx}")
        tpad = 1 if n == 1 else _bucket(n, self.prefill_buckets)
        if tpad < n:  # chunked prefill for long prompts
            out = None
            for i in range(0, n, tpad):
                out = self.eval_tokens(tokens[i:i + tpad])
            return out
        t0 = time.perf_counter()
        toks = torch.tensor([tokens], dtype=torch.long, device=self.device)
        logits = self._forward(toks, self.n_past)
        out = logits[0, -1].cpu().numpy()
        self._account(tpad, (time.perf_counter() - t0) * 1000, n, decode=n == 1)
        self.n_past += n
        return out

    @torch.inference_mode()
    def _decode_sample(self, token: int, spec: dict, steps: int) -> list[int]:
        """`steps` decode+sample steps from row n_past, each sampled id
        staying on the device as the next input; one host sync at the end."""
        tok = torch.tensor([[token]], dtype=torch.long, device=self.device)
        toks = []
        for i in range(steps):
            logits = self._forward(tok, self.n_past + i)
            nxt = sample_logits(logits[:, -1, :], self.generator, spec["temp"],
                                top_k=spec["top_k"], top_p=spec["top_p"], min_p=spec["min_p"])
            toks.append(nxt)
            tok = nxt.reshape(1, 1)
        return torch.cat(toks).tolist()

    def _eval_sample_token(self, token: int, spec: dict) -> int:
        """Feed `token`, sample the next one on the device; advances n_past."""
        if self.n_past + 1 > self.n_ctx:
            raise RuntimeError(f"context overflow at {self.n_past}")
        t0 = time.perf_counter()
        out = self._decode_sample(token, spec, 1)[0]
        self.n_past += 1
        self._account("sample1", (time.perf_counter() - t0) * 1000, 1, decode=True)
        return out

    def _eval_sample_chunk(self, token: int, spec: dict, chunk: int) -> list[int]:
        """Feed `token` and run `chunk` decode+sample steps; returns the
        `chunk` ids. Does NOT advance n_past — the caller advances one row
        per CONSUMED token, so rows past n_past are unattendable and
        overwritten on the next feed."""
        if self.n_past + chunk > self.n_ctx:
            raise RuntimeError(f"context overflow at {self.n_past}+{chunk}")
        t0 = time.perf_counter()
        out = self._decode_sample(token, spec, chunk)
        self._account(("chunk", chunk), (time.perf_counter() - t0) * 1000, chunk, decode=True)
        return out

    def generate(self, prompt_tokens: list[int], *, max_new_tokens: int = 128,
                 sampler: SamplerChain | None = None,
                 stop_on_eog: bool = True) -> Iterator[int]:
        """Greedy or sampled generation; stops at EOG, at max_new_tokens, or
        when the context is full (context shift is queued in ROADMAP.md)."""
        sampler = sampler or SamplerChain([Greedy()])
        # stateless chains sample ON DEVICE fused with the decode step
        spec = sampler.device_spec
        if spec is not None:
            self.generator.manual_seed(int(sampler.rng.integers(1 << 31)))
        pending: list[int] = []
        logits = self.eval_tokens(list(prompt_tokens))
        token = sampler.sample(logits)  # first token: host (prefill logits)
        for step in range(max_new_tokens):
            yield token
            if step + 1 >= max_new_tokens:
                return
            if stop_on_eog and self.vocab is not None and self.vocab.is_eog(token):
                return
            if self.n_past >= self.n_ctx:
                return
            if pending:
                self.n_past += 1  # the consumed token's row was pre-written
                token = pending.pop(0)
            elif spec is not None:
                if self.n_past + DECODE_CHUNK <= self.n_ctx:
                    toks = self._eval_sample_chunk(token, spec, DECODE_CHUNK)
                    self.n_past += 1
                    token, pending = toks[0], toks[1:]
                else:
                    token = self._eval_sample_token(token, spec)
            else:
                token = sampler.sample(self.eval_tokens([token]))
