#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (llama_cpp_dsp_tpu_torch) on one GPU.

    python3 chip_smoke.py            # every phase, as a release check runs it
    python3 chip_smoke.py --phases build,kernels   # a short first look
    python3 chip_smoke.py --phases build,kernels --kernels flash_decode,decode_d256
                                     # B2's checks and timings alone

Phases:
  build    nvcc builds csrc/*.cu for sm_90a (one process per source).
  kernels  each hand-written kernel against its plain PyTorch version on the
           card, at the llama2-7B shapes (flash decode over bf16, f16 and f32
           rows, B2 also at capacities 770 and 4096 and both cluster sizes,
           timed beside sdpa at the 8B, Qwen2.5-7B and 8B-CLI shapes; paged
           Q8_0 decode B7 also over pages of 16, 50 and 128 rows, 512 pages,
           spans of 1 to 8192 rows and cluster sizes 0 / 8 / 16, timed at
           the same shapes; Q4_0
           decode at the 7B's and the 8B's heads and capacities 512, 4096
           and 770; qmm Q4_K/Q5_K/Q6_K: the Llama-3-8B
           Q4_K_M / Q5_K_M shapes; the Q4_1/Q5_0/Q5_1 kernels and MLA decode:
           DeepSeek-V2-Lite's shapes too; qmm Q2_K/Q3_K: the Qwen2.5-7B and
           Qwen3-8B shapes, their expert kernels at Qwen3-30B-A3B's; decode
           attention at H 28 over Hkv 4 too; the decode kernels at head_dim
           256 with Gemma-3-12B's heads; the causal prefill kernel B4 (its
           tensor-core kernel over bf16 / f16 rows, its CUDA-core kernel over
           f32) at the Gemma-3-12B, Gemma-2-9B, Llama-3-8B and Qwen2.5-7B
           shapes, with windows, chunks, softcaps and stale rows, timed at
           Gemma-3-12B's and Llama-3-8B's prefills; qmm for the 11 IQ / TQ
           kinds at the Llama-3-8B shapes, their expert kernels at
           Qwen3-30B-A3B's; B1 also at every B of 1-8, a ragged N and, for
           the 32-block kinds, K 1408 / 10944 / 352, timed at B 1 and 4), with
           its stated tolerance and, where it has one, a planted fault
           that the tolerance must catch (B1 at B <= 8 also x rotated
           inside each 16-element run and rows g / g+8 of a tile
           swapped; B7 its pages swapped and its row scales shifted, at
           100x the limit); times of kernel, plain version and a PyTorch
           yardstick call, each with the profiler window it came from.
  small    a 2-layer head_dim-128 Q4_0 model: logits and greedy stream on
           the card (kernels) against the same model on the CPU (plain).
  main     a full-width llama2-7B-geometry Q4_0 GGUF of random blocks through
           the port's CLI (`-p hello -n 32 --temp 0`), then the same prompt
           with the fused attention kernel off (flash decode instead): first
           decode-step logits compared, stream agreement and tokens/s.
  serve    the same 7B GGUF behind the port's HTTP server, in-process, over
           four engine configurations (contiguous slots or pages, bf16 or
           Q8_0 KV rows): four concurrent chat and completion requests each,
           two sharing a system prompt; then, on each engine, an idle slot's
           rows across a batched decode step and the first decode-step
           logits against the prompt's own forward over a cache of the
           engine's row type and layout at the engine's batch width (over Q8_0
           pages each layer's B7 output is also held to its plain version).
  q8       a TinyLlama-1.1B-geometry Q8_0 GGUF through the CLI.
  small_kq a 2-layer head_dim-128 Q4_K_M model with a llama-bpe vocab: logits
           and greedy stream on the card against the CPU.
  small_kv a 2-layer head_dim-128 Q4_0 model, card against CPU, over every
           KV cache type (-ctk f32 f16 q8_0 q4_0 q4_1 q5_0 q5_1 iq4_nl), the
           split -ctk q8_0 -ctv q4_0 and Q4_0 pages; a small DeepSeek-V2 with
           -ctk q8_0 (MLA's plain path over a quantized latent cache).
  llama3   a full-width, full-depth Llama-3-8B-geometry Q4_K_M GGUF with a
           llama-bpe vocab: the CLI (tokens/s, launches of one decode step,
           a profiled chunk, a profiled 512-token prefill), then the server
           (slots bf16 and paged q8_0) with chat through the llama3 template.
  kv8b     the same model over the KV cache types: the CLI with -ctk q4_0
           (B8 32 times a token; logits against B8's plain version), the
           CLI with -ctk q8_0 -ctv q4_0, the cache bytes per token of every
           type, then the server over Q4_0 slots and Q4_0 pages (the burst,
           an idle slot, first-step logits, a slot save and restore through
           /slots whose restored slot must continue as the saved one).
  small_moe a 2-layer Mixtral-shaped model (8 experts, top-2) at narrow
           widths in four mixes (Q4_K_M, Q5_K_M, Q4_0, Q8_0): a 34-token
           prefill (dense-all experts) and decode (the selected-expert
           kernel) on the card against the CPU.
  mixtral  a full-width, full-depth Mixtral-8x7B Q4_K_M GGUF (SPM vocab,
           Mixtral-Instruct chat template): the CLI, the launches of one
           decode step (96 selected-expert GEMVs a token), a profiled chunk
           and 512-token prefill, then a four-slot server burst.
  small_ds a 3-layer, 256-wide DeepSeek-V2 (MLA at DeepSeek-V2-Lite's
           widths, 8 experts top-3 of width 352, a shared expert) in three
           mixes (Q4_K_M, Q5_K_M, Q4_1): card against CPU over prefill and
           decode (MLA decode, the Q4_1 / Q5_0 / Q5_1 kernels).
  deepseek a full-width, full-depth DeepSeek-V2-Lite Q4_K_M GGUF (deepseek-llm
           vocab and chat template): the CLI, the launches of one decode
           step (27 MLA decodes, 78 selected-expert GEMVs), a profiled chunk
           and 512-token prefill, then a four-slot server burst.
  small_qwen unit-size qwen2 (Q3_K_M, Q2_K), qwen3 (Q2_K), qwen2moe (Q2_K),
           qwen3moe (Q3_K_M), mistral (Q4_0) and phi3 (Q3_K_M, fused GGUF
           tensors) with the qwen2 vocab: a 34-token prefill and a 16-token
           greedy stream on the card against the CPU.
  qwen     full-width, full-depth Qwen2.5-7B-Instruct Q3_K_M (the CLI, then
           the server over slots bf16 and paged q8_0 with chats through its
           ChatML template) and Qwen3-8B Q2_K (the CLI): tokens/s, launches
           of one decode step, bytes a token reads, a profiled chunk.
  small_gemma unit-size gemma, gemma2, gemma3 (head_dim 256, a 16-row window)
           with the Gemma vocab, Q4_K_M (and gemma3 Q4_0, -ctk q8_0, -ctk
           q4_0): a 34-token prefill (B4) and a 16-token greedy stream on the
           card against the CPU.
  gemma    full-width, full-depth Gemma-3-12B-it Q4_K_M (Gemma vocab and chat
           template): the CLI on a 1500-token prompt (B4 48 times a prefill,
           B2 48 times a token), every layer's B4 against its plain version,
           the first decode step against a plain-prefill twin, a profiled
           chunk and prefill; then the server over slots bf16 and paged q8_0
           with two ~1300-token chats sharing a system prompt.
  small_iq unit-size llama in every IQ / TQ ftype (IQ4_NL, IQ4_XS, IQ2_XXS,
           IQ2_XS, IQ2_S, IQ2_M, IQ3_XXS, IQ3_XS, IQ3_S, IQ3_M, IQ1_S, IQ1_M,
           TQ1_0, TQ2_0) and unit qwen3moe with experts in each of the 11
           kinds, the qwen2 vocab: a 34-token prefill and a 16-token greedy
           stream on the card against the CPU; every IQ / TQ qmm and
           selected-expert kernel must run.
  iq       full-width, full-depth Llama-3-8B IQ4_XS (the CLI: tokens/s,
           launches of one decode step, bytes a token reads, a profiled
           chunk and 512-token prefill; the server over slots bf16 and
           paged q8_0) and IQ2_M (the CLI).
  q5km     the Llama-3-8B model as Q5_K_M through the CLI (last: its file is
           written while iq runs).

Every kernel's launch count is set to 0 just before the path that uses it
and read just after; the script fails if a kernel of the path never ran.
It prints the card's name and power limit, then one JSON line listing the
kernels, then `{"ok": true, "device": {...}}` as its last line. It exits
non-zero on any failure, and when there is no CUDA device or no port next to
this file. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
BF16_FLOPS = 989e12  # H100 SXM dense bf16, published
F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores, published
L2_BYTES = 50 * 2**20
PHASES = ("build", "kernels", "small", "main", "serve", "q8", "small_kq", "small_kv", "llama3",
          "kv8b", "small_moe", "mixtral", "small_ds", "deepseek", "small_qwen", "qwen",
          "small_gemma", "gemma", "small_iq", "iq", "q5km")


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


def time_ms(fn, arg_sets, iters: int = 30) -> tuple[float, str]:
    """Device time of fn(*args) per call, and the window it came from:
    the durations of the CUDA kernels it runs (torch.profiler), cycling over
    arg_sets (enough copies to exceed L2 where the caller streams weights
    once). A window counts when every kernel in it was recorded at least
    `iters` times ("full"); each kernel then adds its mean duration × its
    launches per call. A window that lost events is taken again, five times
    at most; then the last one's summed durations over `iters` ("sum":
    every event it recorded; a lost one reads low). CUDA events around the
    loop would time the host instead: at decode sizes the host issues a call
    more slowly than the card runs it; they are the fallback ("events"), an
    upper bound, when the profiler returns no CUDA events five times."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for a in arg_sets[:3]:
        fn(*a)
    torch.cuda.synchronize()
    partial_us = 0.0
    for _ in range(5):  # the profiler now and then loses or returns no CUDA events
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(iters):
                fn(*arg_sets[i % len(arg_sets)])
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and e.count]
        if evs and all(e.count >= iters for e in evs):
            return sum(e.self_device_time_total / e.count * round(e.count / iters)
                       for e in evs) / 1e3, "full"
        partial_us = sum(e.self_device_time_total for e in evs) or partial_us
    if partial_us > 0:
        ms = partial_us / 1e3 / iters
        print(f"  (torch.profiler lost launches in five windows: the last one's sum, {ms:.4f} "
              "ms, may read low)")
        return ms, "sum"
    # CUDA events around the loop: an upper bound (host issue time included)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / iters
    print(f"  (torch.profiler recorded no device time five times: CUDA events, {ms:.4f} ms, "
          "an upper bound)")
    return ms, "events"


@contextlib.contextmanager
def seconds_into(acc: dict, key: str):
    """Add the block's wall seconds to acc[key]."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        acc[key] = acc.get(key, 0.0) + time.perf_counter() - t0


def add_window(wins: dict, field: str, window: str) -> None:
    """Note that figure `field` took a time_ms result from `window`; a figure
    summed over several results names each of their windows once
    ("full+sum")."""
    seen = set(wins[field].split("+")) if field in wins else set()
    wins[field] = "+".join(sorted(seen | {window}))


def n_copies(nbytes: int) -> int:
    return max(1, math.ceil(2.5 * L2_BYTES / max(nbytes, 1)))


def bound_ms(nbytes: float, flops: float, peak: float = BF16_FLOPS) -> tuple[float, str]:
    """The least time for the work: bytes over the memory rate or operations
    over `peak` (the rate of their type), whichever is larger."""
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def gguf_nbytes(w) -> int:
    """Bytes of a packed weight (or expert stack) in GGUF blocks: the least a
    product with it must read. The port's repacked K-quant fields are larger
    (per 256 weights Q2_K 104 B against 84, Q3_K 116 against 110, Q4_K 152
    against 144), so bounds count these bytes, not `w.nbytes`."""
    from llama_cpp_dsp_tpu_torch.gguf.constants import ggml_nbytes

    return ggml_nbytes(w.kind, (max(w.n_expert, 1), *w.shape))


def nmse(got, want) -> float:
    d = (got.double() - want.double())
    return float((d * d).mean() / ((want.double() ** 2).mean() + 1e-30))


def slot_nmse(got, want) -> list[float]:
    """NMSE of each batch slot's output [H, D] against its own magnitude:
    a long-context slot's output is small, so one absolute limit over the
    batch would let a kernel that drops its rows pass."""
    return [nmse(g, w) for g, w in zip(got, want)]


def check_slots(name: str, got, want, faults: dict, tol: float, margin: float = 1.0) -> float:
    """Fail unless every slot of got is within `tol` (NMSE) of want, and
    every planted fault (the plain version with a row dropped) is above
    margin × tol on every slot: the limit would catch that bug. A fault given
    as (output, slots) counts on those slots only (the ones where it changes
    what is read; none: it is not checked here, and the line says so).
    Returns the worst kernel NMSE."""
    import torch

    errs = slot_nmse(got, want)
    print(f"  {name}: per-slot nmse vs plain {' '.join(f'{e:.1e}' for e in errs)} "
          f"(tol {tol:g})")
    if not (max(errs) <= tol and torch.isfinite(got).all()):
        fail(f"{name} disagrees with its plain version")
    for label, bad in faults.items():
        bad, slots = bad if isinstance(bad, tuple) else (bad, range(len(bad)))
        if not slots:
            print(f"    planted fault '{label}': changes no slot's rows here")
            continue
        fe = slot_nmse(bad, want)
        print(f"    planted fault '{label}': per-slot nmse {' '.join(f'{e:.1e}' for e in fe)}"
              + (f" (slots {list(slots)})" if len(slots) < len(fe) else ""))
        if not min(fe[i] for i in slots) > margin * tol:
            fail(f"{name}: the tolerance would not catch '{label}' ({margin:g}x)")
    return max(errs)


# ---------------------------------------------------------------------------
# kernels against their plain versions
# ---------------------------------------------------------------------------

QMM_SHAPES_7B = [(12288, 4096), (4096, 4096), (22016, 4096), (4096, 11008), (32000, 4096)]
# (N, K) and calls per decode token on the fused-attention main path
DECODE_CALLS_7B = {(4096, 4096): 32, (22016, 4096): 32, (4096, 11008): 32, (32000, 4096): 1}
DECODE_CALLS_TINYLLAMA = {(2560, 2048): 22, (2048, 2048): 22, (11264, 2048): 22,
                          (2048, 5632): 22, (32000, 2048): 1}
# Llama-3-8B Q4_K_M / Q5_K_M: the 16 layers whose attn_v is Q4_K (Q5_K) fuse
# q|k|v into 6144 rows; the 16 use_more_bits layers run q and k apart and v
# and ffn_down as Q6_K; the LM head is Q6_K
QMM_SHAPES_L3 = [(6144, 4096), (4096, 4096), (1024, 4096), (28672, 4096), (4096, 14336)]
DECODE_CALLS_L3 = {(6144, 4096): 16, (4096, 4096): 48, (1024, 4096): 16, (28672, 4096): 32,
                   (4096, 14336): 16}
DECODE_CALLS_L3_Q6 = {(1024, 4096): 16, (4096, 14336): 16, (128256, 4096): 1}
KQ_BATCHES = (1, 4, 8, 128)
QMM_NMSE_TOL = 5e-4


def planted_qmm_fault(w):
    """The weight with a bug of one sub-block's size planted, or None for
    Q4_0/Q8_0: Q2_K/Q4_K/Q5_K with group 3's dmin·mn term dropped in every
    superblock, Q3_K with its high bits (hmask) dropped, Q6_K with 16-group
    5's scale zeroed, Q4_1 with its blocks' m dropped, Q5_0/Q5_1 with their
    fifth bits dropped, the IQ / TQ kinds with each block's low and high
    nibbles swapped (G = 32) or its high half taking the low half's scale
    (G = 16). The plain version on it
    must fail the NMSE limit, or the limit would not catch such a kernel."""
    from llama_cpp_dsp_tpu_torch.ops.qtensor import IQ_KINDS, QTensor

    if w.kind in IQ_KINDS:  # a bug of the table kinds' layout: one of their halves
        if w["d"].shape[-1] * 16 == w.shape[1]:  # G = 16: each block's high half scaled
            bad = w["d"].clone()                 # by its low half's scale
            bad[..., 1::2] = bad[..., 0::2]
            return QTensor(w.kind, w.shape, {**w.arrays, "d": bad}, w.n_expert), \
                "each block's high-half scale replaced by its low-half one"
        qs = w["qs"]
        return QTensor(w.kind, w.shape, {**w.arrays, "qs": (qs >> 4) | (qs << 4)},
                       w.n_expert), "low and high nibbles swapped"
    key, idx, label = {"Q2_K": ("mn", 3, "group 3's dmin*mn dropped"),
                       "Q3_K": ("hmask", None, "every high bit dropped"),
                       "Q4_K": ("mn", 3, "group 3's dmin*mn dropped"),
                       "Q5_K": ("mn", 3, "group 3's dmin*mn dropped"),
                       "Q6_K": ("sc", 5, "group 5's scale zeroed"),
                       "Q4_1": ("m", None, "every block's m dropped"),
                       "Q5_1": ("qh", None, "every fifth bit dropped"),
                       "Q5_0": ("qh", None, "every fifth bit dropped")}.get(w.kind.name,
                                                                            (None, 0, ""))
    if key is None:
        return None, ""
    bad = w[key].clone()
    if idx is None:
        bad.zero_()
    else:
        bad[:, :, idx] = 0
    return QTensor(w.kind, w.shape, {**w.arrays, key: bad}), label


def tc_faults(x, w, plain) -> dict:
    """Faults of the tensor-core GEMV's fragment maps, computed with the
    plain version: x rotated by one inside each 16-element run (an x
    fragment map that is off), and rows g and g + 8 of each whole 16-row
    tile swapped (an A fragment map that is off)."""
    from llama_cpp_dsp_tpu_torch.ops.kernels.qmm import qmm_plain

    b, k = x.shape
    n = plain.shape[-1]
    rot = qmm_plain(x.reshape(b, k // 16, 16).roll(1, dims=-1).reshape(b, k), w)
    full = n // 16 * 16
    swapped = plain.clone()
    tiles = swapped[:, :full].reshape(b, full // 16, 2, 8)
    swapped[:, :full] = tiles.flip(2).reshape(b, full)
    return {"x rotated by one inside each 16-element run": rot,
            "rows g and g+8 of each 16-row tile swapped": swapped}


def check_qmm(kind_name: str, shapes, batches, decode_calls, records, rng_seed=0):
    """B1 against exact f32 and its plain version at every (N, K) of
    `shapes` and B of `batches`, with the planted faults (the kind's
    `planted_qmm_fault` and the fragment-map faults of `tc_faults` at B <=
    8) above the limit; then, where `decode_calls` gives (N, K) calls per
    token, the device time at B = 1 (with the plain version and the
    library) and at B = 4, cold in L2."""
    import numpy as np
    import torch

    from llama_cpp_dsp_tpu_torch.gguf.constants import GGMLType
    from llama_cpp_dsp_tpu_torch.ops.kernels.qmm import qmm, qmm_plain
    from llama_cpp_dsp_tpu_torch.quant.dequant import dequant
    from llama_cpp_dsp_tpu_torch.tools.synth import synth_qtensor

    kind = GGMLType[kind_name.upper()]
    rng = np.random.default_rng(rng_seed)
    gen = torch.Generator(device="cuda").manual_seed(rng_seed)
    worst = worst_nmse = 0.0
    t = {"ms": 0.0, "ms_b4": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0.0,
         "carrier_bytes": 0.0, "flops": 0.0}
    wins = {}  # figure → time_ms windows (add_window)
    for n, k in shapes:
        w = synth_qtensor(rng, kind, (n, k), device="cuda").to("cuda")
        w_exact = dequant(w, torch.float32)
        for b in batches:
            x = torch.randn(b, k, generator=gen, device="cuda").to(torch.bfloat16)
            got = qmm(x, w)
            plain = qmm_plain(x, w)
            exact = x.float() @ w_exact.T
            w_bad, label = planted_qmm_fault(w)
            faults = {} if w_bad is None else {label: qmm_plain(x, w_bad)}
            if b <= 8:
                faults.update(tc_faults(x, w, plain))
            torch.cuda.synchronize()
            e_exact, e_plain = nmse(got, exact), nmse(got, plain)
            err = float((got - plain).abs().max())
            worst, worst_nmse = max(worst, err), max(worst_nmse, e_plain)
            e_bad = {lb: nmse(bad, plain) for lb, bad in faults.items()}
            print(f"  qmm_{kind_name} N={n} K={k} B={b}: nmse vs exact f32 {e_exact:.2e}, "
                  f"vs plain {e_plain:.2e}, max|kernel-plain| {err:.3e}"
                  + "".join(f", planted fault '{lb}' {e:.2e}" for lb, e in e_bad.items())
                  + f" (tol nmse {QMM_NMSE_TOL:g})")
            if not (e_exact <= QMM_NMSE_TOL and e_plain <= QMM_NMSE_TOL
                    and torch.isfinite(got).all()):
                fail(f"qmm_{kind_name} N={n} K={k} B={b} disagrees with its plain version")
            for lb, e in e_bad.items():
                if not e > QMM_NMSE_TOL:
                    fail(f"qmm_{kind_name}: the tolerance would not catch '{lb}'")
            del w_bad, faults
        calls = decode_calls.get((n, k), 0)
        if calls:  # time the decode GEMV (B=1, and B=4) with the weight cold in L2
            x = torch.randn(1, k, generator=gen, device="cuda").to(torch.bfloat16)
            x4 = torch.randn(4, k, generator=gen, device="cuda").to(torch.bfloat16)
            ws = [w] + [synth_qtensor(rng, kind, (n, k), device="cuda").to("cuda")
                        for _ in range(n_copies(w.nbytes) - 1)]
            dense = [dequant(wi, torch.bfloat16) for wi in ws[:n_copies(n * k * 2)]]
            ms, w_ms = time_ms(qmm, [(x, wi) for wi in ws])
            ms4, w_ms4 = time_ms(qmm, [(x4, wi) for wi in ws], iters=10)
            pms, w_pms = time_ms(qmm_plain, [(x, wi) for wi in ws], iters=5)
            # yardstick: PyTorch alone on the same packed inputs (dequant, then
            # a bf16 matmul); the dense bf16 matmul alone is printed beside it
            lms, w_lms = time_ms(lambda a, wi: torch.matmul(a, dequant(wi, torch.bfloat16).T),
                                 [(x, wi) for wi in ws], iters=10)
            dms, w_dms = time_ms(lambda a, m: torch.matmul(a, m.T), [(x, d) for d in dense])
            print(f"  qmm_{kind_name} N={n} K={k} B=1: kernel {ms:.4f} ms [{w_ms}] (B=4 "
                  f"{ms4:.4f} ms [{w_ms4}], {ms4 / ms:.2f}x), plain {pms:.4f} ms [{w_pms}], "
                  f"dequant+matmul {lms:.4f} ms [{w_lms}], matmul on dense bf16 {dms:.4f} ms "
                  f"[{w_dms}], {w.nbytes / ms / 1e6:.0f} GB/s, {calls} calls/token")
            for field, w_ in (("ms", w_ms), ("ms_b4", w_ms4), ("plain_ms", w_pms),
                              ("library_ms", w_lms)):
                add_window(wins, field, w_)
            t["ms"] += calls * ms
            t["ms_b4"] += calls * ms4
            t["plain_ms"] += calls * pms
            t["library_ms"] += calls * lms
            t["bytes"] += calls * (gguf_nbytes(w) + x.numel() * 2 + n * 4)
            t["carrier_bytes"] += calls * (w.nbytes + x.numel() * 2 + n * 4)
            t["flops"] += calls * 2.0 * n * k
            del ws, dense
    rec = records[f"qmm_{kind_name}"]
    rec["max_abs_err"] = max(rec.get("max_abs_err", 0.0), worst)
    rec["max_nmse"] = max(rec.get("max_nmse", 0.0), worst_nmse)
    if t["ms"]:  # per decode token of the path that uses this kind
        bms, by = bound_ms(t["bytes"], t["flops"])
        rec.update(ms=t["ms"], ms_b4=t["ms_b4"], plain_ms=t["plain_ms"],
                   library_ms=t["library_ms"], bound_ms=bms, bound_by=by, windows=wins)
        if kind_name.startswith(("iq", "tq")):  # the table carrier's bytes beside the GGUF's
            rec["carrier_bound_ms"] = bound_ms(t["carrier_bytes"], t["flops"])[0]


# Mixtral-8x7B: (N, K) of the expert stacks (gate/up, down), E = 8; calls of
# each B9 kind per CLI decode token (S = 2 rows: one token, top-2) on the
# Q4_K_M path (gate/up Q4_K in all 32 layers, down Q6_K in the 16
# use_more_bits layers and Q4_K in the rest) and, for the kinds it does not
# run, on a Q5_K_M (gate/up/down Q5_K, down Q6_K where use_more_bits) or an
# all-Q4_0 / all-Q8_0 file of the same model
MOE_SHAPES = [(14336, 4096), (4096, 14336)]
MOE_DECODE_CALLS = {"q4_k": {(14336, 4096): 64, (4096, 14336): 16},
                    "q6_k": {(4096, 14336): 16},
                    "q5_k": {(14336, 4096): 64, (4096, 14336): 16},
                    "q4_0": {(14336, 4096): 64, (4096, 14336): 32},
                    "q8_0": {(14336, 4096): 64, (4096, 14336): 32}}
MOE_ROWS = (1, 2, 8)  # one token top-1, the CLI's top-2, four slots top-2
# DeepSeek-V2-Lite: the expert stacks (gate/up [1408, 2048], down [2048,
# 1408]: K = 1408 is not a multiple of 256), E = 64, top-6; rows: one token
# top-1, a CLI token (S = 6), four slots (S = 24). Calls of each new B9 kind
# per decode token (S = 6): Q5_0 down in the 14 layers that are not
# use_more_bits (Q4_K_M); Q5_1 down there (Q5_K_M); a Q4_1 file runs all 78.
DS_EXPERT_SHAPES = [(1408, 2048), (2048, 1408)]
DS_EXPERT_ROWS = (1, 6, 24)
DS_DECODE_CALLS = {"q5_0": {(2048, 1408): 14}, "q5_1": {(2048, 1408): 14},
                   "q4_1": {(1408, 2048): 52, (2048, 1408): 26}}
# the same stacks' K-quant and Q8_0 kinds on the DeepSeek-V2-Lite paths:
# gate/up Q4_K (Q4_K_M) or Q5_K (Q5_K_M), down Q8_0 in the 12 use_more_bits
# MoE layers (Q6_K → Q8_0 at K = 1408); checked, timed at Mixtral's shapes
DS_EXPERT_KQ_SHAPES = {"q4_k": [(1408, 2048)], "q5_k": [(1408, 2048)], "q8_0": [(2048, 1408)]}
# Qwen2.5-7B Q3_K_M and Qwen3-8B Q2_K (GQA group 7 over K = 3584, and 32 /
# 8 heads over K = 4096): q, k, gate / up and down of each, plus the row-
# fused gate|up the decode path runs (q|k|v do not fuse: attn_v is another
# kind). Calls per decode token: Q3_K on the Qwen2.5 Q3_K_M path (q, k,
# gate|up in 28 layers), Q2_K on the Qwen3 Q2_K path (q, k, gate|up in 36);
# Qwen3's Q3_K attn_output and ffn_down are checked, not timed
QMM_SHAPES_QWEN = [(3584, 3584), (512, 3584), (18944, 3584), (3584, 18944), (4096, 4096),
                   (12288, 4096), (4096, 12288)]
DECODE_CALLS_QWEN = {"q3_k": {(3584, 3584): 28, (512, 3584): 28, (37888, 3584): 28},
                     "q2_k": {(4096, 4096): 36, (1024, 4096): 36, (24576, 4096): 36}}
# Qwen3-30B-A3B's expert stacks (Qwen/Qwen3-30B-A3B config.json: 48
# layers, hidden 2048, 128 experts top-8 of width 768: gate/up [768, 2048],
# down [2048, 768], K = 768 three superblocks); rows: one token top-1, a CLI
# token (S = 8), four slots (S = 32). Calls per decode token of a Q2_K file
# (gate/up Q2_K, down Q3_K in 48 layers)
QWEN_EXPERT_SHAPES = [(768, 2048), (2048, 768)]
QWEN_EXPERT_ROWS = (1, 8, 32)
QWEN_DECODE_CALLS = {"q2_k": {(768, 2048): 96}, "q3_k": {(2048, 768): 48}}
# the older K-quant kinds at the shapes the Qwen paths give them: Qwen2.5-7B
# Q3_K_M's Q4_K attn_v, attn_output and ffn_down (K = 3584, 18944) and Q5_K
# attn_v / ffn_down in its first layers, Qwen3-8B Q2_K's Q4_K attn_v, Q6_K
# on both LM heads (vocab 152064 over K 3584, 151936 over 4096); checked,
# timed at the 8B shapes
QWEN_KQ_SHAPES = {"q4_k": [(512, 3584), (3584, 3584), (3584, 18944), (1024, 4096)],
                  "q5_k": [(512, 3584), (3584, 18944)],
                  "q6_k": [(152064, 3584), (151936, 4096)]}
# the legacy qmm kinds: a DeepSeek expert-shaped matrix (K = 1408) and the
# 7B shapes, timed at the 7B decode calls (a llama2-7B of that kind) to set
# them beside qmm_q4_0; Q8_0 at layer 0's ffn_down (K = 10944)
LEGACY_QMM_SHAPES = [(2048, 1408), *QMM_SHAPES_7B]
# DeepSeek-V2-Lite Q4_K_M's dense K-quant matrices: attn_q, attn_kv_a_mqa,
# attn_output, the shared experts' gate / up (and Q4_K down where not
# use_more_bits), layer 0's fused gate|up (2 × 10944 rows); Q6_K for the
# shared experts' down in the use_more_bits layers and the LM head (vocab
# 102400); checked, timed at the 8B shapes
DS_QMM_SHAPES = {"q4_k": [(3072, 2048), (576, 2048), (2048, 2048), (2816, 2048),
                          (2048, 2816), (21888, 2048)],
                 "q6_k": [(2048, 2816), (102400, 2048)]}

# The IQ / TQ kinds (B1's table bodies and their B9 entries): checked at the
# Llama-3-8B shapes, each timed per token of an 8B whose matrices all take
# the kind, row-fused as the IQ4_XS file runs them (q|k|v, o, gate|up, down:
# 128 GEMVs); B9 at Qwen3-30B-A3B's expert stacks, timed per token of a file
# whose experts take the kind (S = 8: gate/up ×96, down ×48)
IQ_KINDS = ("iq4_nl", "iq4_xs", "iq2_xxs", "iq2_xs", "iq2_s", "iq3_xxs", "iq3_s", "iq1_s",
            "iq1_m", "tq1_0", "tq2_0")
DECODE_CALLS_L3_IQ = {(6144, 4096): 32, (4096, 4096): 32, (28672, 4096): 32, (4096, 14336): 32}
QWEN_DECODE_CALLS_IQ = {(768, 2048): 96, (2048, 768): 48}
# the Pallas body each kind's kernel replaces (llama_cpp_dsp_tpu/ops/pallas/qmm.py)
IQ_BODY_LINE = {k: 274 if k.startswith("iq4") else 293 if k in ("iq2_xs", "iq2_s", "iq1_m")
                else 283 for k in IQ_KINDS}


# B1's tensor-core GEMV beyond the main-path batches: every B of 1-8 (B is a
# runtime argument that masks x's columns) at one main-path shape of each
# kind, a ragged N (1000 rows: 62 whole tiles and a half one), and the kinds
# of 32-element blocks at K = 1408 and 10944 (not multiples of 256:
# DeepSeek-V2-Lite's expert and layer-0 rows) and 352 (an odd count of
# blocks: the unit DeepSeek's expert rows)
TC_SHAPE = {"q4_0": (4096, 4096), "q8_0": (2048, 2048), "q4_k": (4096, 4096),
            "q5_k": (4096, 4096), "q6_k": (1024, 4096), "q4_1": (4096, 4096),
            "q5_0": (4096, 4096), "q5_1": (4096, 4096), "q3_k": (512, 3584),
            "q2_k": (4096, 4096), **{k: (4096, 4096) for k in IQ_KINDS}}
TC_BLOCK32 = ("q4_0", "q4_1", "q5_0", "q5_1", "q8_0", "iq4_nl")


def check_qmm_tc(kind_name: str, records) -> None:
    n, k = TC_SHAPE[kind_name]
    check_qmm(kind_name, [(n, k)], tuple(range(1, 9)), {}, records, rng_seed=3)
    check_qmm(kind_name, [(1000, k)], (1, 5), {}, records, rng_seed=4)
    if kind_name in TC_BLOCK32:
        check_qmm(kind_name, [(2048, 1408), (2048, 10944), (256, 352)], (1, 3, 8), {}, records,
                  rng_seed=5)


def check_qmm_experts(kind_name: str, records, n_expert: int = 8, rng_seed=0,
                      shapes=MOE_SHAPES, rows=MOE_ROWS, decode_calls=None, s_time: int = 2):
    """B9 against its plain version (by default at the Mixtral shapes): per-
    row NMSE for S rows with random ids (repeats and the last expert), a
    planted fault (the plain version with the last row's expert swapped)
    that the limit must catch, and the device time per decode token (S =
    s_time rows on distinct experts, cold in L2; `decode_calls` (N, K) →
    calls per token, MOE_DECODE_CALLS of the kind by default)."""
    import numpy as np
    import torch

    from llama_cpp_dsp_tpu_torch.gguf.constants import GGMLType
    from llama_cpp_dsp_tpu_torch.ops.kernels.qmm import qmm_expert_rows, qmm_expert_rows_plain
    from llama_cpp_dsp_tpu_torch.quant.dequant import dequant_fields
    from llama_cpp_dsp_tpu_torch.tools.synth import synth_qtensor

    kind = GGMLType[kind_name.upper()]
    name = f"qmm_experts_{kind_name}"
    rng = np.random.default_rng(rng_seed)
    gen = torch.Generator(device="cuda").manual_seed(rng_seed)
    worst = worst_nmse = 0.0
    t = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0.0, "carrier_bytes": 0.0,
         "flops": 0.0}
    wins = {}  # figure → time_ms windows (add_window)

    def library(x, w, sel):  # PyTorch alone: dequant the selected experts, bmm
        s, (n, k) = x.shape[0], w.shape
        rows = {f: a[sel.long()].reshape(s * n, *a.shape[2:]) for f, a in w.arrays.items()}
        wd = dequant_fields(w.kind, rows, torch.bfloat16).reshape(s, n, k)
        return torch.bmm(wd, x.to(torch.bfloat16)[:, :, None])[:, :, 0]

    if decode_calls is None:
        decode_calls = MOE_DECODE_CALLS[kind_name]
    for n, k in shapes:
        w = synth_qtensor(rng, kind, (n_expert, n, k), device="cuda").to("cuda")
        per_expert = w.nbytes // n_expert
        for s in rows:
            ids = rng.integers(0, n_expert, s)
            ids[0] = ids[-1] = n_expert - 1  # the last expert, and a repeat for s > 1
            sel = torch.tensor(ids, dtype=torch.int32, device="cuda")
            bad_sel = sel.clone()
            bad_sel[-1] = (sel[-1] + 1) % n_expert  # the last row's expert swapped
            x = torch.randn(s, k, generator=gen, device="cuda").to(torch.bfloat16)
            got = qmm_expert_rows(x, w, sel)
            plain = qmm_expert_rows_plain(x, w, sel)
            bad = qmm_expert_rows_plain(x, w, bad_sel)
            torch.cuda.synchronize()
            errs = slot_nmse(got, plain)
            fault = max(slot_nmse(bad, plain))
            err = float((got - plain).abs().max())
            worst, worst_nmse = max(worst, err), max(worst_nmse, max(errs))
            print(f"  {name} N={n} K={k} S={s} sel={ids.tolist()}: worst row nmse vs plain "
                  f"{max(errs):.2e}, max|kernel-plain| {err:.3e}, planted fault 'row {s - 1}'s "
                  f"expert swapped' {fault:.2e} (tol nmse {QMM_NMSE_TOL:g})")
            if not (max(errs) <= QMM_NMSE_TOL and torch.isfinite(got).all()):
                fail(f"{name} N={n} K={k} S={s} disagrees with its plain version")
            if not fault > QMM_NMSE_TOL:
                fail(f"{name}: the tolerance would not catch a row's expert swapped")
        calls = decode_calls.get((n, k), 0)
        if calls:  # S = s_time rows (one token's top-k); sets rotate over the experts
            st = s_time
            x = torch.randn(st, k, generator=gen, device="cuda").to(torch.bfloat16)
            sets = [(x, w, torch.tensor([(st * i + j) % n_expert for j in range(st)],
                                        dtype=torch.int32, device="cuda"))
                    for i in range(max(1, n_expert // st))]
            ms, w_ms = time_ms(qmm_expert_rows, sets)
            pms, w_pms = time_ms(qmm_expert_rows_plain, sets, iters=5)
            lms, w_lms = time_ms(library, sets, iters=10)
            print(f"  {name} N={n} K={k} S={st}: kernel {ms:.4f} ms [{w_ms}], plain {pms:.4f} ms "
                  f"[{w_pms}], dequant+bmm {lms:.4f} ms [{w_lms}], "
                  f"{st * per_expert / ms / 1e6:.0f} GB/s of selected experts, "
                  f"{calls} calls/token")
            for field, w_ in (("ms", w_ms), ("plain_ms", w_pms), ("library_ms", w_lms)):
                add_window(wins, field, w_)
            t["ms"] += calls * ms
            t["plain_ms"] += calls * pms
            t["library_ms"] += calls * lms
            t["bytes"] += calls * (st * gguf_nbytes(w) // n_expert + x.numel() * 2 + 4 * st
                                   + st * n * 4)
            t["carrier_bytes"] += calls * (st * per_expert + x.numel() * 2 + 4 * st + st * n * 4)
            t["flops"] += calls * 2.0 * st * n * k
        del w
        torch.cuda.empty_cache()
    rec = records[name]
    rec["max_abs_err"] = max(rec.get("max_abs_err", 0.0), worst)
    rec["max_nmse"] = max(rec.get("max_nmse", 0.0), worst_nmse)
    if t["ms"]:  # per decode token of the path that uses this kind
        bms, by = bound_ms(t["bytes"], t["flops"])
        rec.update(ms=t["ms"], plain_ms=t["plain_ms"], library_ms=t["library_ms"],
                   bound_ms=bms, bound_by=by, windows=wins)
        if kind_name.startswith(("iq", "tq")):
            rec["carrier_bound_ms"] = bound_ms(t["carrier_bytes"], t["flops"])[0]


FLASH_ATOL = 2e-3  # bf16 cache, f32 math in both; sums in another order
# per slot: the kernel reads 1.7e-13 at most and a dropped row 8e-4 at least
# (H100, this script's inputs), so the limit sits far from both
FLASH_NMSE_TOL = 1e-8
# (query heads, KV heads): the 7B's MHA, the 8B's GQA group 4, Qwen2.5-7B's
# group 7 (28 over 4, the first group that is not a power of two)
HEAD_CASES = ((32, 32), (32, 8), (28, 4))
# B2's further caches: a capacity that is a multiple of nothing the kernel
# uses, and a 4096-row one; spans of 1 and 5 rows (within a tile: one block
# folds them), 33 and 65 (clusters with empty parts), and parts that cross
# many tiles; the SWA starts fall inside a part
B2_CACHES = {770: ((770, 1, 400, 65), (0, 0, 13, 32)),
             4096: ((1, 5, 3000, 4096), (0, 3, 1001, 1777))}
# B2 timed beside the 7B layer (H, Hkv, valid rows of a 512-row cache, layers
# a token): Llama-3-8B and Qwen2.5-7B layers at 512 rows, and the 8B CLI's
# own state, ~40 rows
B2_GQA_ROWS = {"llama3-8b": (32, 8, 512, 32), "qwen2.5-7b": (28, 4, 512, 28),
               "llama3-8b 40 rows": (32, 8, 40, 32)}


def b2_faults(plain, q, k, v, lengths, starts, **kw) -> dict:
    """The planted faults B2's checks must catch: the first or the last
    valid row dropped and, on a GQA case, the kv groups shifted (K and V
    rolled by one along Hkv: each query head reads its neighbour group)."""
    import torch

    st = torch.zeros_like(lengths) if starts is None else starts
    faults = {"first row dropped": plain(q, k, v, lengths, st + 1, **kw),
              "last row dropped": plain(q, k, v, lengths - 1, starts, **kw)}
    if 1 < k.shape[1] < q.shape[1]:
        faults["kv groups shifted"] = plain(q, k.roll(1, 1), v.roll(1, 1), lengths, starts, **kw)
    return faults


def kernel_names(fn, iters: int = 30) -> set[str]:
    """Names of the CUDA kernels fn runs (torch.profiler over `iters` calls:
    a window of one short call now and then records no CUDA event)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        names = {e.key for e in prof.key_averages() if e.device_type == DeviceType.CUDA}
        if names:
            return names
    fail("torch.profiler recorded no CUDA kernel five times")


def check_flash_decode(records):
    import torch
    import torch.nn.functional as F

    from llama_cpp_dsp_tpu_torch.ops.kernels.attention import flash_decode, flash_decode_plain

    gen = torch.Generator(device="cuda").manual_seed(1)
    b, h, d, s = 4, 32, 128, 512
    lengths = torch.tensor([512, 1, 300, 77], dtype=torch.int32, device="cuda")
    worst = worst_nmse = 0.0
    for hq, hkv in HEAD_CASES:
        q = torch.randn(b, hq, d, generator=gen, device="cuda")
        k = torch.randn(b, hkv, s, d, generator=gen, device="cuda").to(torch.bfloat16)
        v = torch.randn(b, hkv, s, d, generator=gen, device="cuda").to(torch.bfloat16)
        for label, starts, cap in (("full", None, 0.0),
                                   ("swa", torch.tensor([0, 0, 100, 50], dtype=torch.int32,
                                                        device="cuda"), 0.0),
                                   ("softcap", None, 30.0)):
            got = flash_decode(q, k, v, lengths, starts, scale=d ** -0.5, softcap=cap)
            want = flash_decode_plain(q, k, v, lengths, starts, scale=d ** -0.5, softcap=cap)
            faults = b2_faults(flash_decode_plain, q, k, v, lengths, starts, scale=d ** -0.5,
                               softcap=cap)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            worst = max(worst, err)
            print(f"  flash_decode Hkv={hkv} {label}: max|kernel-plain| {err:.3e} "
                  f"(atol {FLASH_ATOL:g})")
            if not err <= FLASH_ATOL:
                fail(f"flash_decode Hkv={hkv} {label} disagrees with its plain version")
            worst_nmse = max(worst_nmse, check_slots(f"flash_decode Hkv={hkv} {label}", got,
                                                     want, faults, FLASH_NMSE_TOL))
    # f16 and f32 rows (-ctk f16 / f32), and K and V of two types (a split
    # -ctk f32 -ctv bf16: both taken in f32 by the wrapper)
    for label, kdt, vdt in (("f16", torch.float16, torch.float16),
                            ("f32", torch.float32, torch.float32),
                            ("f32/bf16", torch.float32, torch.bfloat16)):
        for hq, hkv in HEAD_CASES:
            q = torch.randn(b, hq, d, generator=gen, device="cuda")
            k = torch.randn(b, hkv, s, d, generator=gen, device="cuda").to(kdt)
            v = torch.randn(b, hkv, s, d, generator=gen, device="cuda").to(vdt)
            for case, starts, cap in (("full", None, 0.0),
                                      ("swa", torch.tensor([0, 0, 100, 50], dtype=torch.int32,
                                                           device="cuda"), 0.0),
                                      ("softcap", None, 30.0)):
                got = flash_decode(q, k, v, lengths, starts, scale=d ** -0.5, softcap=cap)
                want = flash_decode_plain(q, k, v, lengths, starts, scale=d ** -0.5, softcap=cap)
                faults = b2_faults(flash_decode_plain, q, k, v, lengths, starts,
                                   scale=d ** -0.5, softcap=cap)
                torch.cuda.synchronize()
                worst = max(worst, float((got - want).abs().max()))
                worst_nmse = max(worst_nmse, check_slots(f"flash_decode {label} Hkv={hkv} {case}",
                                                         got, want, faults, FLASH_NMSE_TOL))
    # capacities 770 and 4096 (B2_CACHES), bf16 and f32 rows, both cluster
    # sizes as well as the kernel's own choice
    for cap_rows, (lens, sts) in B2_CACHES.items():
        ln = torch.tensor(lens, dtype=torch.int32, device="cuda")
        swa = torch.tensor(sts, dtype=torch.int32, device="cuda")
        for hq, hkv in HEAD_CASES:
            q = torch.randn(b, hq, d, generator=gen, device="cuda")
            k = torch.randn(b, hkv, cap_rows, d, generator=gen, device="cuda")
            v = torch.randn(b, hkv, cap_rows, d, generator=gen, device="cuda")
            for dt in (torch.bfloat16, torch.float32):
                kt, vt = k.to(dt), v.to(dt)
                for case, starts, cap in (("full", None, 0.0), ("swa", swa, 0.0),
                                          ("softcap", None, 30.0), ("swa+softcap", swa, 30.0)):
                    want = flash_decode_plain(q, kt, vt, ln, starts, scale=d ** -0.5, softcap=cap)
                    faults = b2_faults(flash_decode_plain, q, kt, vt, ln, starts,
                                       scale=d ** -0.5, softcap=cap)
                    for cl in (0, 8, 16):
                        got = flash_decode(q, kt, vt, ln, starts, scale=d ** -0.5,
                                           softcap=cap, cluster=cl)
                        torch.cuda.synchronize()
                        worst = max(worst, float((got - want).abs().max()))
                        worst_nmse = max(worst_nmse, check_slots(
                            f"flash_decode S={cap_rows} {str(dt)[6:]} Hkv={hkv} {case} "
                            f"cluster {cl or 'auto'}", got, want, faults, FLASH_NMSE_TOL))
    # the entry runs the cluster kernel, never the split kernel or a merge
    one = torch.tensor([512], dtype=torch.int32, device="cuda")
    q = torch.randn(1, 32, d, generator=gen, device="cuda")
    k = torch.randn(1, 8, 512, d, generator=gen, device="cuda").to(torch.bfloat16)
    names = kernel_names(lambda: flash_decode(q, k, k, one, scale=d ** -0.5))
    print(f"  flash_decode runs: {sorted(names)}")
    if not (len(names) == 1 and "flash_decode_gqa" in next(iter(names))):
        fail(f"flash_decode ran {sorted(names)}, not the cluster kernel flash_decode_gqa alone")
    # time: one 7B layer (B=1, Hkv=32) at a full 512-row context, cold
    # caches, per row type
    hkv, L = 32, 512
    by_type = {}
    for name, dt in (("bf16", torch.bfloat16), ("f16", torch.float16), ("f32", torch.float32)):
        kv_bytes = 2 * hkv * L * d * dt.itemsize
        sets = []
        for _ in range(n_copies(kv_bytes)):
            q = torch.randn(1, h, d, generator=gen, device="cuda")
            k = torch.randn(1, hkv, L, d, generator=gen, device="cuda").to(dt)
            v = torch.randn(1, hkv, L, d, generator=gen, device="cuda").to(dt)
            sets.append((q, k, v))
        ms, w_ms = time_ms(lambda q, k, v: flash_decode(q, k, v, one, scale=d ** -0.5), sets)
        pms, w_pms = time_ms(lambda q, k, v: flash_decode_plain(q, k, v, one, scale=d ** -0.5),
                             sets)
        lms, w_lms = time_ms(lambda q, k, v: F.scaled_dot_product_attention(
            q.to(dt)[:, :, None], k, v, scale=d ** -0.5), sets)
        bms, by = bound_ms(kv_bytes + 2 * h * d * 4, 4.0 * h * L * d, F32_FLOPS)
        print(f"  flash_decode {name} 7B layer, context {L}: kernel {ms:.4f} ms [{w_ms}], plain "
              f"{pms:.4f} ms [{w_pms}], sdpa {lms:.4f} ms [{w_lms}], bound {bms:.4f} ms, "
              f"{kv_bytes / ms / 1e6:.0f} GB/s")
        by_type[name] = {"ms": 32 * ms, "plain_ms": 32 * pms, "library_ms": 32 * lms,
                         "bound_ms": 32 * bms,
                         "windows": {"ms": w_ms, "plain_ms": w_pms, "library_ms": w_lms}}
    # time: the GQA layers (B2_GQA_ROWS), bf16, B=1, cold caches; the kernel
    # at its own cluster size and at 8 and 16, sdpa with enable_gqa; 100
    # calls a figure (a few µs each)
    gqa = {}
    for label, (hq, hkv, rows, layers) in B2_GQA_ROWS.items():
        kv_bytes = 2 * hkv * L * d * 2
        n = torch.tensor([rows], dtype=torch.int32, device="cuda")
        sets = [(torch.randn(1, hq, d, generator=gen, device="cuda"),
                 torch.randn(1, hkv, L, d, generator=gen, device="cuda").to(torch.bfloat16),
                 torch.randn(1, hkv, L, d, generator=gen, device="cuda").to(torch.bfloat16))
                for _ in range(n_copies(kv_bytes))]
        # a first figure of a sequence reads high (the card's clocks): one
        # warm-up figure, dropped
        time_ms(lambda q, k, v: flash_decode(q, k, v, n, scale=d ** -0.5), sets, iters=100)
        timed = {"ms": time_ms(lambda q, k, v: flash_decode(q, k, v, n, scale=d ** -0.5), sets,
                               iters=100)}
        for cl in (8, 16):
            timed[f"cluster{cl}_ms"] = time_ms(lambda q, k, v: flash_decode(
                q, k, v, n, scale=d ** -0.5, cluster=cl), sets, iters=100)
        timed["plain_ms"] = time_ms(
            lambda q, k, v: flash_decode_plain(q, k, v, n, scale=d ** -0.5), sets)
        timed["library_ms"] = time_ms(lambda q, k, v: F.scaled_dot_product_attention(
            q.to(torch.bfloat16)[:, :, None], k[:, :, :rows], v[:, :, :rows], scale=d ** -0.5,
            enable_gqa=True), sets, iters=100)
        row = {k_: v_[0] for k_, v_ in timed.items()}
        row["bound_ms"], row["bound_by"] = bound_ms(2 * hkv * rows * d * 2 + 2 * hq * d * 4 + 4,
                                                    4.0 * hq * rows * d, F32_FLOPS)
        print(f"  flash_decode bf16 {label} layer (H {hq} / Hkv {hkv}, {rows} of {L} rows): "
              + ", ".join(f"{k_} {v_[0]:.4f} [{v_[1]}]" for k_, v_ in timed.items())
              + f", bound_ms {row['bound_ms']:.4f} ms; per token ({layers} layers): kernel "
              f"{layers * row['ms']:.4f}, sdpa {layers * row['library_ms']:.4f}")
        gqa[label] = {k_: (layers * v_ if k_.endswith("ms") else v_) for k_, v_ in row.items()}
        gqa[label]["windows"] = {k_: v_[1] for k_, v_ in timed.items()}
    records["flash_decode"].update(max_abs_err=worst, max_nmse=worst_nmse, **by_type["bf16"],
                                   bound_by=by, by_row_type=by_type, gqa=gqa)


Q4_CAPACITIES = (512, 4096, 770)  # 770: even, not a multiple of 256 (JAX's gate)
Q4_SOFTCAP = 50.0


def _q4_planes(x):
    """A random f32 cache [B, Hkv, S, D] → (u8 row-pair plane, parity-major
    group scales) by the port's own quantizer."""
    from llama_cpp_dsp_tpu_torch.quant.kv_planes import q4_pack_rows, q4_quant, rows_to_parity

    q, dd = q4_quant(x)
    return q4_pack_rows(q).contiguous(), rows_to_parity(dd).contiguous()


def check_flash_decode_q4(records):
    """flash_decode_q4 (B8) against its plain version at D=128, H=32 over Hkv
    32 (the 7B layer) and 8 (the 8B's), B 1 and 4, capacities 512, 4096 and
    770, odd and even lengths, a slot starting past row 0, softcap 0 and 50:
    per-slot NMSE, with three planted faults (first or last valid row
    dropped, the two parity scale planes swapped). Timed at the 7B layer."""
    import torch
    import torch.nn.functional as F

    from llama_cpp_dsp_tpu_torch.ops.kernels import attention as ka
    from llama_cpp_dsp_tpu_torch.quant.kv_planes import q4_deq_plane

    gen = torch.Generator(device="cuda").manual_seed(4)
    h, d = 32, 128
    sc = d ** -0.5
    g = d // 32
    worst = [0.0, 0.0]

    def swap(dd):  # the parity planes exchanged: each row takes its sibling's scales
        return torch.cat([dd[:, :, g:], dd[:, :, :g]], dim=2)

    for hkv in (32, 8):
        for b in (1, 4):
            for cap in Q4_CAPACITIES:
                lens = (cap, 1, cap // 2 + 1, 77) if b == 4 else (cap - 1,)
                sts = (0, 0, 101, 0) if b == 4 else (3,)
                lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
                q = torch.randn(b, h, d, generator=gen, device="cuda")
                kq, kd = _q4_planes(torch.randn(b, hkv, cap, d, generator=gen, device="cuda"))
                vq, vd = _q4_planes(torch.randn(b, hkv, cap, d, generator=gen, device="cuda"))
                for case, starts, cap_s in (
                        ("full", None, 0.0),
                        ("start", torch.tensor(sts, dtype=torch.int32, device="cuda"), 0.0),
                        ("softcap", None, Q4_SOFTCAP)):
                    got = ka.flash_decode_q4(q, kq, kd, vq, vd, lengths, starts, scale=sc,
                                             softcap=cap_s)
                    plain = ka.flash_decode_q4_plain
                    want = plain(q, kq, kd, vq, vd, lengths, starts, scale=sc, softcap=cap_s)
                    st = torch.zeros_like(lengths) if starts is None else starts
                    faults = {
                        "first row dropped": plain(q, kq, kd, vq, vd, lengths, st + 1,
                                                   scale=sc, softcap=cap_s),
                        "last row dropped": plain(q, kq, kd, vq, vd, lengths - 1, starts,
                                                  scale=sc, softcap=cap_s),
                        "parity scale planes swapped": plain(q, kq, swap(kd), vq, swap(vd),
                                                             lengths, starts, scale=sc,
                                                             softcap=cap_s)}
                    torch.cuda.synchronize()
                    worst[0] = max(worst[0], float((got - want).abs().max()))
                    worst[1] = max(worst[1], check_slots(
                        f"flash_decode_q4 Hkv={hkv} B={b} S={cap} {case}", got, want, faults,
                        FLASH_NMSE_TOL))
    # time: one 7B layer (B=1, Hkv=32) at a full 512-row context, cold caches
    hkv, L = 32, 512
    one = torch.tensor([L], dtype=torch.int32, device="cuda")
    kv_bytes = 2 * hkv * L * (d // 2 + 4 * g)  # 80 B a row and head, K and V
    sets = []
    for _ in range(n_copies(kv_bytes)):
        q = torch.randn(1, h, d, generator=gen, device="cuda")
        sets.append((q, *_q4_planes(torch.randn(1, hkv, L, d, generator=gen, device="cuda")),
                     *_q4_planes(torch.randn(1, hkv, L, d, generator=gen, device="cuda"))))
    ms, w_ms = time_ms(lambda *a: ka.flash_decode_q4(*a, one, scale=sc), sets)
    pms, w_pms = time_ms(lambda *a: ka.flash_decode_q4_plain(*a, one, scale=sc), sets)
    lms, w_lms = time_ms(lambda q, kq, kd, vq, vd: F.scaled_dot_product_attention(
        q.to(torch.bfloat16)[:, :, None], q4_deq_plane(kq, kd), q4_deq_plane(vq, vd),
        scale=sc), sets)
    bms, by = bound_ms(kv_bytes + 2 * h * d * 4 + 4, 4.0 * h * L * d)
    print(f"  flash_decode_q4 7B layer, context {L}: kernel {ms:.4f} ms [{w_ms}], plain "
          f"{pms:.4f} ms [{w_pms}], dequant + sdpa {lms:.4f} ms [{w_lms}], bound {bms:.4f} ms, "
          f"{kv_bytes / ms / 1e6:.0f} GB/s")
    records["flash_decode_q4"].update(max_abs_err=worst[0], max_nmse=worst[1], ms=32 * ms,
                                      plain_ms=32 * pms, library_ms=32 * lms,
                                      bound_ms=32 * bms, bound_by=by,
                                      windows={"ms": w_ms, "plain_ms": w_pms,
                                               "library_ms": w_lms})


VARIANT_LENGTHS = (1, 37, 200, 511)  # ragged, one row to a full 512-row slot
VARIANT_STARTS = (0, 0, 100, 50)  # the SWA case


def _paged_tables(lengths, ps: int, s: int, gen):
    """Block tables [B, s/ps] over shuffled page ids: slot 3 shares slot 2's
    full first pages (a shared prefix), and the entries past each length
    hold the sentinel P. Returns (tables, P)."""
    import torch

    nb = s // ps
    need = [-(-n // ps) for n in lengths]
    shared = min(lengths[2], lengths[3]) // ps
    n_pages = sum(need) - shared
    perm = torch.randperm(n_pages, generator=gen, device="cpu").tolist()
    tables = torch.full((len(lengths), nb), n_pages, dtype=torch.int32)
    nxt = 0
    for b, n in enumerate(need):
        for blk in range(n):
            if b == 3 and blk < shared:
                tables[b, blk] = tables[2, blk]
            else:
                tables[b, blk] = perm[nxt]
                nxt += 1
    return tables.to("cuda"), n_pages


# B7's further paged caches (capacity, page size, lengths, SWA starts): spans
# of 1, 5 and 65 rows and a full capacity in one batch, SWA starts inside a
# page; pages of 50 rows, whose scale rows are not 16-byte aligned (200
# bytes a page); 512 pages of 16 rows, past the kernel's 256-entry table
# window. Every table entry past a length is P (≥ P: clamped, never read).
B7_CACHES = ((512, 128, (1, 5, 65, 512), (0, 3, 13, 77)),
             (500, 50, (1, 5, 65, 500), (0, 3, 13, 77)),
             (8192, 16, (1, 5, 4100, 8192), (0, 3, 30, 5000)))
B7_FAULT_MARGIN = 100.0  # B7's planted faults read at least 100x FLASH_NMSE_TOL


def b7_faults(plain, q, kq, kd, vq, vd, tables, lengths, starts, **kw) -> dict:
    """The planted faults B7's checks must catch, through its plain
    version: the first or the last valid row dropped; the table entries of
    the first and the last valid page swapped (counted on the slots where
    that changes the rows read: two pages or more, one of them partly
    valid; attention does not depend on the order of its rows); each row
    given its neighbour's K and V scales (the next row of its page)."""
    import torch

    ps = kq.shape[2]
    st = torch.zeros_like(lengths) if starts is None else starts
    swapped, slots = tables.clone(), []
    for b, (lo, hi) in enumerate(zip(st.tolist(), lengths.tolist())):
        first, last = lo // ps, (hi - 1) // ps
        if hi > lo and last > first and (lo % ps or hi % ps):
            swapped[b, first], swapped[b, last] = tables[b, last], tables[b, first]
            slots.append(b)
    return {"first row dropped": plain(q, kq, kd, vq, vd, tables, lengths, st + 1, **kw),
            "last row dropped": plain(q, kq, kd, vq, vd, tables, lengths - 1, starts, **kw),
            "pages swapped": (plain(q, kq, kd, vq, vd, swapped, lengths, starts, **kw), slots),
            "scales shifted": plain(q, kq, kd.roll(-1, -1), vq, vd.roll(-1, -1), tables,
                                    lengths, starts, **kw)}


def _dense_q8(k):
    """A random f32 cache [.., S, D] → int8 rows and [.., 1, S] scales, by
    the port's own quantizer."""
    from llama_cpp_dsp_tpu_torch.quant.kv_planes import q8_quant

    qs, d = q8_quant(k)
    return qs, d.unsqueeze(-2).contiguous()


def check_decode_variants(records):
    """flash_decode_q8, flash_decode_paged and flash_decode_paged_q8 against
    their plain versions at D=128 over HEAD_CASES (H 32 over Hkv 32 and 8,
    H 28 over Hkv 4), B=4 ragged slots of a 512-row context; per-slot NMSE
    with the planted faults. B7 also over B7_CACHES, at cluster sizes 0
    (its own choice), 8 and 16, with its faults (b7_faults) at
    B7_FAULT_MARGIN x the limit; its launch is the cluster kernel alone.
    Timed at the 7B layer (B7 at both cluster sizes too) and B7 at the
    Llama-3-8B, Qwen2.5-7B and 8B-CLI layers of B2_GQA_ROWS."""
    import torch
    import torch.nn.functional as F

    from llama_cpp_dsp_tpu_torch.ops.kernels import attention as ka

    gen = torch.Generator(device="cuda").manual_seed(3)
    cpu_gen = torch.Generator().manual_seed(3)
    b, h, d, s = 4, 32, 128, 512
    sc = d ** -0.5
    lengths = torch.tensor(VARIANT_LENGTHS, dtype=torch.int32, device="cuda")
    swa = torch.tensor(VARIANT_STARTS, dtype=torch.int32, device="cuda")
    worst = {n: [0.0, 0.0] for n in ("flash_decode_q8", "flash_decode_paged",
                                     "flash_decode_paged_q8")}
    b7_s = {}  # seconds of B7's checks and of its timing rows

    def run_case(name, label, kernel, plain, args, lengths=lengths, swa=swa):
        with seconds_into(b7_s if name == "flash_decode_paged_q8" else {}, "checks"):
            run_cases(name, label, kernel, plain, args, lengths, swa)

    def run_cases(name, label, kernel, plain, args, lengths, swa):
        for case, starts, cap in (("full", None, 0.0), ("swa", swa, 0.0),
                                  ("softcap", None, 30.0)):
            want = plain(*args, lengths, starts, scale=sc, softcap=cap)
            st = torch.zeros_like(lengths) if starts is None else starts
            if name == "flash_decode_paged_q8":
                faults = b7_faults(plain, *args, lengths, starts, scale=sc, softcap=cap)
                clusters, margin = ka.CLUSTERS, B7_FAULT_MARGIN
            else:
                faults = {"first row dropped": plain(*args, lengths, st + 1, scale=sc,
                                                     softcap=cap),
                          "last row dropped": plain(*args, lengths - 1, starts, scale=sc,
                                                    softcap=cap)}
                clusters, margin = (None,), 1.0
            for cl in clusters:
                kw = {} if cl is None else {"cluster": cl}
                got = kernel(*args, lengths, starts, scale=sc, softcap=cap, **kw)
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                w = worst[name]
                w[0] = max(w[0], err)
                tag = f"{name} {label} {case}" + ("" if cl is None else f" cluster {cl or 'auto'}")
                print(f"  {tag}: max|kernel-plain| {err:.3e}")
                w[1] = max(w[1], check_slots(tag, got, want, faults, FLASH_NMSE_TOL, margin))

    for hq, hkv in HEAD_CASES:
        q = torch.randn(b, hq, d, generator=gen, device="cuda")
        k = torch.randn(b, hkv, s, d, generator=gen, device="cuda")
        v = torch.randn(b, hkv, s, d, generator=gen, device="cuda")
        kq, kd = _dense_q8(k)
        vq, vd = _dense_q8(v)
        run_case("flash_decode_q8", f"Hkv={hkv}", ka.flash_decode_q8, ka.flash_decode_q8_plain,
                 (q, kq, kd, vq, vd))
        for ps in (128, 16):
            tables, n_pages = _paged_tables(VARIANT_LENGTHS, ps, s, cpu_gen)
            kp = torch.randn(n_pages, hkv, ps, d, generator=gen, device="cuda")
            vp = torch.randn(n_pages, hkv, ps, d, generator=gen, device="cuda")
            label = f"Hkv={hkv} ps={ps}"
            for dt in (torch.bfloat16, torch.float16, torch.float32):
                run_case("flash_decode_paged", f"{label} {str(dt)[6:]}", ka.flash_decode_paged,
                         ka.flash_decode_paged_plain, (q, kp.to(dt), vp.to(dt), tables))
            kpq, kpd = _dense_q8(kp)
            vpq, vpd = _dense_q8(vp)
            run_case("flash_decode_paged_q8", label, ka.flash_decode_paged_q8,
                     ka.flash_decode_paged_q8_plain, (q, kpq, kpd, vpq, vpd, tables))
        for cap_rows, ps, lens, sts in B7_CACHES:
            ln = torch.tensor(lens, dtype=torch.int32, device="cuda")
            tables, n_pages = _paged_tables(lens, ps, cap_rows, cpu_gen)
            kpq, kpd = _dense_q8(torch.randn(n_pages, hkv, ps, d, generator=gen, device="cuda"))
            vpq, vpd = _dense_q8(torch.randn(n_pages, hkv, ps, d, generator=gen, device="cuda"))
            run_case("flash_decode_paged_q8", f"Hkv={hkv} S={cap_rows} ps={ps}",
                     ka.flash_decode_paged_q8, ka.flash_decode_paged_q8_plain,
                     (q, kpq, kpd, vpq, vpd, tables), ln,
                     torch.tensor(sts, dtype=torch.int32, device="cuda"))
            del kpq, kpd, vpq, vpd
    # B7's entry is one launch of the cluster kernel: no split kernel, no merge
    tb = torch.arange(4, dtype=torch.int32, device="cuda")[None]
    kpq, kpd = _dense_q8(torch.randn(4, 8, 128, d, generator=gen, device="cuda"))
    q = torch.randn(1, 32, d, generator=gen, device="cuda")
    one = torch.tensor([512], dtype=torch.int32, device="cuda")
    names = kernel_names(lambda: ka.flash_decode_paged_q8(q, kpq, kpd, kpq, kpd, tb, one,
                                                          scale=sc))
    print(f"  flash_decode_paged_q8 runs: {sorted(names)}")
    if not (len(names) == 1 and "flash_decode_gqa" in next(iter(names))):
        fail(f"flash_decode_paged_q8 ran {sorted(names)}, not the cluster kernel alone")

    # time: one 7B layer (B=1, Hkv=32) at a full 512-row context, cold
    # caches, pages of 128 rows (the server's default) in shuffled order
    hkv, L, ps = 32, 512, 128
    one = torch.tensor([L], dtype=torch.int32, device="cuda")
    q8_bytes = 2 * hkv * L * (d + 4)
    bf_bytes = 2 * hkv * L * d * 2
    io = 2 * h * d * 4 + 4  # q in, out, the length
    flops = 4.0 * h * L * d

    def deq(qs, dd):
        return (qs.float() * dd.transpose(-1, -2)).to(torch.bfloat16)

    def sdpa(q, k, v):
        return F.scaled_dot_product_attention(q.to(torch.bfloat16)[:, :, None], k, v, scale=sc)

    sets = {"q8": [], "paged": [], "paged_q8": []}
    for i in range(max(n_copies(q8_bytes), n_copies(bf_bytes))):
        q = torch.randn(1, h, d, generator=gen, device="cuda")
        tb = torch.randperm(L // ps, generator=cpu_gen).to(torch.int32)[None].to("cuda")
        kp = torch.randn(L // ps, hkv, ps, d, generator=gen, device="cuda")
        vp = torch.randn(L // ps, hkv, ps, d, generator=gen, device="cuda")
        if i < n_copies(q8_bytes):
            k = torch.randn(1, hkv, L, d, generator=gen, device="cuda")
            v = torch.randn(1, hkv, L, d, generator=gen, device="cuda")
            sets["q8"].append((q, *_dense_q8(k), *_dense_q8(v)))
            sets["paged_q8"].append((q, *_dense_q8(kp), *_dense_q8(vp), tb))
        if i < n_copies(bf_bytes):
            sets["paged"].append((q, kp.to(torch.bfloat16), vp.to(torch.bfloat16), tb))
    timed = {
        "flash_decode_q8": (
            ka.flash_decode_q8, ka.flash_decode_q8_plain, sets["q8"], q8_bytes,
            lambda q, kq, kd, vq, vd: sdpa(q, deq(kq, kd), deq(vq, vd)),
            "dequant + sdpa"),
        "flash_decode_paged": (
            ka.flash_decode_paged, ka.flash_decode_paged_plain, sets["paged"], bf_bytes,
            lambda q, kp, vp, tb: sdpa(q, ka._gather_pages(kp, tb), ka._gather_pages(vp, tb)),
            "gather + sdpa"),
        "flash_decode_paged_q8": (
            ka.flash_decode_paged_q8, ka.flash_decode_paged_q8_plain, sets["paged_q8"],
            q8_bytes,
            lambda q, kq, kd, vq, vd, tb: sdpa(
                q, deq(ka._gather_pages(kq, tb), ka._gather_pages(kd[:, :, 0], tb)[:, :, None]),
                deq(ka._gather_pages(vq, tb), ka._gather_pages(vd[:, :, 0], tb)[:, :, None])),
            "gather + dequant + sdpa"),
    }
    for name, (kernel, plain, arg_sets, nbytes, library, lib_label) in timed.items():
        t0 = time.perf_counter()
        if name == "flash_decode_paged_q8":  # a first figure of a sequence reads high
            time_ms(lambda *a: kernel(*a, one, scale=sc), arg_sets, iters=100)
        ms, w_ms = time_ms(lambda *a: kernel(*a, one, scale=sc), arg_sets)
        pms, w_pms = time_ms(lambda *a: plain(*a, one, scale=sc), arg_sets)
        lms, w_lms = time_ms(library, arg_sets)
        extra = 4 * (L // ps) if "paged" in name else 0  # the table row, int32
        bms, by = bound_ms(nbytes + io + extra, flops)
        wins = {"ms": w_ms, "plain_ms": w_pms, "library_ms": w_lms}
        clusters = {}
        if name == "flash_decode_paged_q8":
            for cl in (8, 16):
                t_, w_ = time_ms(lambda *a: kernel(*a, one, scale=sc, cluster=cl), arg_sets,
                                 iters=100)
                clusters[f"cluster{cl}_ms"] = 32 * t_
                wins[f"cluster{cl}_ms"] = w_
        print(f"  {name} 7B layer, context {L}: kernel {ms:.4f} ms [{w_ms}], plain {pms:.4f} ms "
              f"[{w_pms}], {lib_label} {lms:.4f} ms [{w_lms}], bound {bms:.4f} ms, "
              f"{nbytes / ms / 1e6:.0f} GB/s"
              + "".join(f", {k_} {v_ / 32:.4f} [{wins[k_]}]" for k_, v_ in clusters.items()))
        records[name].update(max_abs_err=worst[name][0], max_nmse=worst[name][1], ms=32 * ms,
                             plain_ms=32 * pms, library_ms=32 * lms, bound_ms=32 * bms,
                             bound_by=by, windows=wins, **clusters)
        if name == "flash_decode_paged_q8":
            b7_s["timing"] = time.perf_counter() - t0
    # paged f16 / f32 pools (-ctk f16 / f32 --kv-layout paged), the same layer
    by_type = {"bf16": {k: records["flash_decode_paged"][k]
                        for k in ("ms", "plain_ms", "library_ms", "bound_ms")}}
    for name, dt in (("f16", torch.float16), ("f32", torch.float32)):
        nbytes = 2 * hkv * L * d * dt.itemsize
        arg_sets = [(a[0], a[1].to(dt), a[2].to(dt), a[3])
                    for a in sets["paged"][:n_copies(nbytes)]]
        ms, w_ms = time_ms(lambda *a: ka.flash_decode_paged(*a, one, scale=sc), arg_sets)
        pms, w_pms = time_ms(lambda *a: ka.flash_decode_paged_plain(*a, one, scale=sc),
                             arg_sets)
        lms, w_lms = time_ms(lambda q, kp, vp, tb: F.scaled_dot_product_attention(
            q.to(dt)[:, :, None], ka._gather_pages(kp, tb), ka._gather_pages(vp, tb), scale=sc),
            arg_sets)
        bms, _ = bound_ms(nbytes + io + 4 * (L // ps), flops)
        print(f"  flash_decode_paged {name} 7B layer, context {L}: kernel {ms:.4f} ms [{w_ms}], "
              f"plain {pms:.4f} ms [{w_pms}], gather + sdpa {lms:.4f} ms [{w_lms}], bound "
              f"{bms:.4f} ms")
        by_type[name] = {"ms": 32 * ms, "plain_ms": 32 * pms, "library_ms": 32 * lms,
                         "bound_ms": 32 * bms,
                         "windows": {"ms": w_ms, "plain_ms": w_pms, "library_ms": w_lms}}
    records["flash_decode_paged"]["by_row_type"] = by_type
    # B7 at the GQA layers of B2_GQA_ROWS (pages of 128 rows in shuffled
    # order, B = 1, cold caches), at its own cluster size and at 8 and 16,
    # beside gather + dequant + sdpa with enable_gqa
    gqa = {}
    t0 = time.perf_counter()
    for label, (hq, hkv_, rows, layers) in B2_GQA_ROWS.items():
        n = torch.tensor([rows], dtype=torch.int32, device="cuda")
        arg_sets = []
        for _ in range(n_copies(2 * hkv_ * L * (d + 4))):
            tb = torch.randperm(L // ps, generator=cpu_gen).to(torch.int32)[None].to("cuda")
            arg_sets.append((torch.randn(1, hq, d, generator=gen, device="cuda"),
                             *_dense_q8(torch.randn(L // ps, hkv_, ps, d, generator=gen,
                                                    device="cuda")),
                             *_dense_q8(torch.randn(L // ps, hkv_, ps, d, generator=gen,
                                                    device="cuda")), tb))
        time_ms(lambda *a: ka.flash_decode_paged_q8(*a, n, scale=sc), arg_sets, iters=100)
        timed = {"ms": time_ms(lambda *a: ka.flash_decode_paged_q8(*a, n, scale=sc), arg_sets,
                               iters=100)}
        for cl in (8, 16):
            timed[f"cluster{cl}_ms"] = time_ms(lambda *a: ka.flash_decode_paged_q8(
                *a, n, scale=sc, cluster=cl), arg_sets, iters=100)
        timed["plain_ms"] = time_ms(lambda *a: ka.flash_decode_paged_q8_plain(*a, n, scale=sc),
                                    arg_sets)
        timed["library_ms"] = time_ms(lambda q, kq, kd, vq, vd, tb: F.scaled_dot_product_attention(
            q.to(torch.bfloat16)[:, :, None],
            deq(ka._gather_pages(kq, tb), ka._gather_pages(kd[:, :, 0], tb)[:, :, None])[:, :, :rows],
            deq(ka._gather_pages(vq, tb), ka._gather_pages(vd[:, :, 0], tb)[:, :, None])[:, :, :rows],
            scale=sc, enable_gqa=True), arg_sets, iters=100)
        row = {k_: v_[0] for k_, v_ in timed.items()}
        row["bound_ms"], row["bound_by"] = bound_ms(
            2 * hkv_ * rows * (d + 4) + 2 * hq * d * 4 + 4 + 4 * (L // ps), 4.0 * hq * rows * d)
        print(f"  flash_decode_paged_q8 {label} layer (H {hq} / Hkv {hkv_}, {rows} of {L} rows, "
              f"pages of {ps}): "
              + ", ".join(f"{k_} {v_[0]:.4f} [{v_[1]}]" for k_, v_ in timed.items())
              + f", bound_ms {row['bound_ms']:.4f} ms; per token ({layers} layers): kernel "
              f"{layers * row['ms']:.4f}, library {layers * row['library_ms']:.4f}")
        gqa[label] = {k_: (layers * v_ if k_.endswith("ms") else v_) for k_, v_ in row.items()}
        gqa[label]["windows"] = {k_: v_[1] for k_, v_ in timed.items()}
    records["flash_decode_paged_q8"]["gqa"] = gqa
    b7_s["timing"] += time.perf_counter() - t0
    print(f"  flash_decode_paged_q8 at D=128: checks {b7_s['checks']:.1f} s, timing rows "
          f"{b7_s['timing']:.1f} s")


# B4's cases: (label, B, H, Hkv, D, T, n_past per slot, capacity, window,
# attention chunk, softcap, cache dtype, q scale, stale rows). Stale rows (at
# or past n_past + T) hold 1e30 (an f16 cache: 65504) and must never be
# read; otherwise they are random. q is scaled up where a softcap has to bend the scores.
PREFILL_CASES = (
    ("Gemma-3-12B SWA", 1, 16, 8, 256, 1500, (0,), 2048, 1024, 0, 0.0, "bf16", 1.0, False),
    ("Gemma-3-12B full", 1, 16, 8, 256, 1500, (0,), 2048, 0, 0, 0.0, "bf16", 1.0, False),
    ("Gemma-3-12B SWA continued", 1, 16, 8, 256, 512, (1536,), 2560, 1024, 0, 0.0, "bf16",
     1.0, True),
    ("Gemma-3-12B full continued", 1, 16, 8, 256, 512, (1536,), 2560, 0, 0, 0.0, "bf16", 1.0,
     True),
    ("Gemma-2-9B SWA softcap", 1, 16, 8, 256, 2048, (3072,), 5120, 4096, 0, 50.0, "bf16", 8.0,
     False),
    ("Gemma-2-9B full softcap", 1, 16, 8, 256, 2048, (3072,), 5120, 0, 0, 50.0, "bf16", 8.0,
     False),
    ("Llama-3-8B", 1, 32, 8, 128, 512, (0,), 512, 0, 0, 0.0, "bf16", 1.0, False),
    ("Llama-3-8B f16", 1, 32, 8, 128, 512, (0,), 512, 0, 0, 0.0, "f16", 1.0, False),
    ("Llama-3-8B f32 continued", 1, 32, 8, 128, 300, (200,), 1024, 0, 0, 0.0, "f32", 1.0,
     True),
    ("Qwen2.5-7B group 7", 1, 28, 4, 128, 300, (0,), 512, 0, 0, 0.0, "bf16", 1.0, False),
    ("chunk 64, two slots", 2, 4, 2, 128, 100, (37, 0), 256, 0, 64, 0.0, "bf16", 1.0, True),
    ("chunk 64 f32 D=256", 2, 4, 2, 256, 100, (37, 5), 256, 0, 64, 0.0, "f32", 1.0, True),
    ("window 24 f16 D=256, two slots", 2, 8, 2, 256, 77, (40, 0), 160, 24, 0, 5.0, "f16",
     4.0, True),
    ("group of 40 over one kv head", 1, 40, 1, 128, 45, (3,), 64, 0, 0, 0.0, "bf16", 1.0,
     False),
)
_DTYPES = {"bf16": "bfloat16", "f16": "float16", "f32": "float32"}
GEMMA3_LAYERS = (40, 8)  # (SWA, full) layers of Gemma-3-12B's 48


def _prefill_inputs(gen, b, h, hkv, d, t, n_past, cap, dtype, q_scale, stale):
    import torch

    dt = getattr(torch, _DTYPES[dtype])
    q = torch.randn(b, t, h, d, generator=gen, device="cuda") * q_scale
    k = torch.randn(b, hkv, cap, d, generator=gen, device="cuda")
    v = torch.randn(b, hkv, cap, d, generator=gen, device="cuda")
    if stale:  # 1e30, or an f16 cache's largest value
        big = min(1e30, torch.finfo(dt).max)
        for i, npb in enumerate(n_past):
            k[i, :, npb + t:] = big
            v[i, :, npb + t:] = big
    np_ = torch.tensor(n_past, dtype=torch.int32, device="cuda")
    return q, k.to(dt), v.to(dt), np_


def prefill_cost(h, hkv, d, t, n_past: int, window: int, chunk: int, kv_itemsize: int):
    """(bytes, f32 operations) of one slot's prefill: q read and the output
    written in f32, the K / V rows the tile span needs read once, n_past;
    4·H·D operations per visible (query, row) pair."""
    import numpy as np

    pos = n_past + np.arange(t)
    if window:
        first = np.maximum(pos - window + 1, 0)
    elif chunk:
        first = pos // chunk * chunk
    else:
        first = np.zeros_like(pos)
    visible = int((pos - first + 1).sum())
    rows = int(pos[-1] + 1 - first[0])
    nbytes = 2 * t * h * d * 4 + 2 * hkv * rows * d * kv_itemsize + 4
    return nbytes, 4.0 * h * d * visible


def prefill_single_pass_bf16(q, k, v, n_past, *, scale: float, softcap: float = 0.0,
                             swa_window: int = 0, attn_chunk: int = 0):
    """The plain version with q·scale and p each rounded once to bf16 and no
    lo terms: what a single-pass bf16 tensor-core kernel computes (the
    softmax's sum l from the unrounded p, as such kernels keep it). B4's
    split operands exist to stay clear of this error."""
    import torch

    from llama_cpp_dsp_tpu_torch.ops import softcap as apply_softcap
    from llama_cpp_dsp_tpu_torch.runtime.kv_cache import causal_mask

    b, t, h, d = q.shape
    hkv = k.shape[1]
    pos = n_past[:, None] + torch.arange(t, dtype=torch.int32, device=q.device)
    mask = causal_mask(pos, k.shape[2], n_past, swa_window, attn_chunk)
    qb = (q.float() * scale).to(torch.bfloat16).float().reshape(b, t, hkv, h // hkv, d)
    sc = torch.einsum("bthrd,bhsd->bhrts", qb, k.float())
    if softcap:
        sc = apply_softcap(sc, softcap)
    sc = sc.masked_fill(~mask[:, None, None], float("-inf"))
    p = torch.exp(sc - sc.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True).permute(0, 3, 1, 2, 4)
    out = torch.einsum("bhrts,bhsd->bthrd", p.to(torch.bfloat16).float(), v.float()) / l
    return out.reshape(b, t, h, d)


def _prefill_times(gen, label, h, hkv, d, t, cap, window, dtype, n_past=0):
    """B4, its plain version and scaled_dot_product_attention (the same
    boolean mask and GQA) on one layer of (h, hkv, d) at t queries from
    n_past over a `cap`-row cache of `dtype`, cold in L2; with the layer's
    bytes and operations, its bound on the tensor cores (bf16 operations at
    989 TFLOP/s) and on the CUDA cores (f32 at 67)."""
    import torch
    import torch.nn.functional as F

    from llama_cpp_dsp_tpu_torch.ops.kernels.attention import flash_prefill, flash_prefill_plain

    itemsize = {"bf16": 2, "f16": 2, "f32": 4}[dtype]
    nbytes, flops = prefill_cost(h, hkv, d, t, n_past, window, 0, itemsize)
    sets = [_prefill_inputs(gen, 1, h, hkv, d, t, (n_past,), cap, dtype, 1.0, False)
            for _ in range(n_copies(2 * hkv * cap * d * itemsize))]
    pos = n_past + torch.arange(t, device="cuda")
    j = torch.arange(n_past + t, device="cuda")
    mask = j[None, :] <= pos[:, None]
    if window:
        mask &= j[None, :] > pos[:, None] - window
    sc = d ** -0.5
    kw = {"scale": sc, "swa_window": window}
    ms, w_ms = time_ms(lambda q, k, v, n: flash_prefill(q, k, v, n, **kw), sets, iters=10)
    pms, w_pms = time_ms(lambda q, k, v, n: flash_prefill_plain(q, k, v, n, **kw), sets,
                         iters=5)
    lms, w_lms = time_ms(lambda q, k, v, n: F.scaled_dot_product_attention(
        q.transpose(1, 2).to(k.dtype), k[:, :, :n_past + t], v[:, :, :n_past + t],
        attn_mask=mask, scale=sc, enable_gqa=True), sets, iters=10)
    tc, by = bound_ms(nbytes, flops, BF16_FLOPS)
    split, _ = bound_ms(nbytes, 2 * flops, BF16_FLOPS)  # q_hi·k + q_lo·k, P_hi·V + P_lo·V
    f32, _ = bound_ms(nbytes, flops, F32_FLOPS)
    print(f"  flash_prefill {label} layer ({dtype} rows), {t} tokens from {n_past}: kernel "
          f"{ms:.4f} ms [{w_ms}], plain {pms:.4f} ms [{w_pms}], sdpa {lms:.4f} ms [{w_lms}]; "
          f"bound {tc:.4f} ms on the "
          f"tensor cores ({by}; {split:.4f} with the split's products), {f32:.4f} ms in f32 "
          f"({flops / 1e9:.2f} GFLOP, "
          f"{flops / ms / 1e9:.1f} TFLOP/s useful)")
    del sets
    return {"ms": ms, "plain_ms": pms, "library_ms": lms, "bound_ms": tc, "bound_by": by,
            "bound_split_ms": split, "bound_f32_ms": f32,
            "windows": {"ms": w_ms, "plain_ms": w_pms, "library_ms": w_lms}}


def check_flash_prefill(records):
    """flash_prefill (B4) against flash_prefill_plain on the card over
    PREFILL_CASES: per-slot NMSE (over [T, H, D]) ≤ FLASH_NMSE_TOL, with
    planted faults the limit must catch: a window one row wider (the SWA
    bound off by one); without a window, every query one row later (the
    causal limit one row late, whose stale 1e30 row gives a non-finite
    output); and, where the rows are bf16 or f16 (the tensor-core kernel),
    q and p rounded once to bf16 with no lo terms (a single-pass kernel).
    Timed at Gemma-3-12B's two layer kinds (T 1500, a bf16 cache) summed
    over its 48 layers, Llama-3-8B's layer (T 512, bf16) over its 32, and the
    f32-row kernel at the "Llama-3-8B f32 continued" shape, each beside its
    plain version, scaled_dot_product_attention with the same boolean mask
    and GQA, and its tensor-core and f32-operation bounds."""
    import torch

    from llama_cpp_dsp_tpu_torch.ops.kernels.attention import flash_prefill, flash_prefill_plain

    gen = torch.Generator(device="cuda").manual_seed(8)
    worst = [0.0, 0.0]
    for (label, b, h, hkv, d, t, n_past, cap, window, chunk, softcap, dtype, q_scale,
         stale) in PREFILL_CASES:
        q, k, v, np_ = _prefill_inputs(gen, b, h, hkv, d, t, n_past, cap, dtype, q_scale, stale)
        kw = {"scale": d ** -0.5, "softcap": softcap, "swa_window": window, "attn_chunk": chunk}
        got = flash_prefill(q, k, v, np_, **kw)
        want = flash_prefill_plain(q, k, v, np_, **kw)
        if window:
            faults = {"SWA bound off by one": flash_prefill_plain(
                q, k, v, np_, **{**kw, "swa_window": window + 1})}
        else:
            faults = {"causal limit one row late": flash_prefill_plain(q, k, v, np_ + 1, **kw)}
        if dtype != "f32":
            faults["q and p rounded once to bf16"] = prefill_single_pass_bf16(q, k, v, np_, **kw)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        errs = slot_nmse(got, want)
        print(f"  flash_prefill {label} (B {b}, H {h}/{hkv}, D {d}, T {t}, n_past {n_past}, "
              f"S {cap}, window {window}, chunk {chunk}, softcap {softcap:g}, {dtype}): "
              f"max|kernel-plain| {err:.3e}, per-slot nmse {' '.join(f'{e:.1e}' for e in errs)} "
              f"(tol {FLASH_NMSE_TOL:g})")
        if not (max(errs) <= FLASH_NMSE_TOL and torch.isfinite(got).all()):
            fail(f"flash_prefill {label} disagrees with its plain version")
        for name, bad in faults.items():
            fe = [float("inf") if not torch.isfinite(x).all() else e
                  for x, e in zip(bad, slot_nmse(bad, want))]
            print(f"    planted fault '{name}': per-slot nmse {' '.join(f'{e:.1e}' for e in fe)}")
            if not min(fe) > FLASH_NMSE_TOL:
                fail(f"flash_prefill {label}: the tolerance would not catch '{name}'")
        worst = [max(worst[0], err), max(worst[1], max(errs))]
        del q, k, v, got, want, faults
    # time: Gemma-3-12B's layer kinds at a 1500-token prompt (n_past 0)
    totals = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
              "bound_split_ms": 0.0, "bound_f32_ms": 0.0}
    wins = {}
    for (kind, window), n_layers in zip((("SWA", 1024), ("full", 0)), GEMMA3_LAYERS):
        r = _prefill_times(gen, f"Gemma-3-12B {kind}", 16, 8, 256, 1500, 2048, window, "bf16")
        for key in totals:
            totals[key] += n_layers * r[key]
        for key, w_ in r["windows"].items():
            add_window(wins, key, w_)
        by = r["bound_by"]
    print(f"  flash_prefill per Gemma-3-12B prefill of 1500 tokens (48 layers): "
          + ", ".join(f"{k} {v:.3f}" for k, v in totals.items()))
    # Llama-3-8B (D 128) over its 32 layers; the f32-row kernel on one layer
    r = _prefill_times(gen, "Llama-3-8B", 32, 8, 128, 512, 512, 0, "bf16")
    d128 = {k: (32 * v if k.endswith("ms") else v) for k, v in r.items()}
    print(f"  flash_prefill per Llama-3-8B prefill of 512 tokens (32 layers): "
          + ", ".join(f"{k} {v:.3f}" for k, v in d128.items() if k.endswith("ms")))
    f32_rows = _prefill_times(gen, "Llama-3-8B f32 continued", 32, 8, 128, 300, 1024, 0,
                              "f32", n_past=200)
    records["flash_prefill"].update(max_abs_err=worst[0], max_nmse=worst[1], bound_by=by,
                                    d128=d128, f32_rows=f32_rows, windows=wins, **totals)


# the decode kernels at D = 256: Gemma-3-12B's heads, B = 4 ragged slots
D256_LENGTHS = {512: (512, 1, 300, 77), 2048: (2048, 1, 1536, 1100)}
D256_WINDOW = 1024  # the SWA starts: max(length − 1024, 0)


def check_decode_d256(records):
    """B2, B5, B6, B7 and B8 at head_dim 256 (H 16 over Hkv 8, Gemma-3-12B)
    against their plain versions, B = 4 ragged slots of 512- and 2048-row
    caches, without and with SWA starts (window 1024) and with softcap 50:
    per-slot NMSE ≤ FLASH_NMSE_TOL with the planted faults of D = 128 (first
    or last valid row dropped; B2's kv groups shifted; Q4's parity scale
    planes swapped). B2 also over B2_CACHES (770 and 4096 rows; f32 rows at
    4096 stream through its ring). Timed at the Gemma-3-12B CLI's decode
    (1532 rows: 40 SWA layers over 1024 of them, 8 full layers), per token;
    B2 and B7 at both cluster sizes too. B7 is checked at cluster sizes 0,
    8 and 16, also over B7_CACHES, with its faults (b7_faults) at
    B7_FAULT_MARGIN x the limit."""
    import torch
    import torch.nn.functional as F

    from llama_cpp_dsp_tpu_torch.ops.kernels import attention as ka

    gen = torch.Generator(device="cuda").manual_seed(9)
    cpu_gen = torch.Generator().manual_seed(9)
    h, hkv, d = 16, 8, 256
    sc = d ** -0.5
    g = d // 32
    worst = {n: [0.0, 0.0] for n in ("flash_decode", "flash_decode_q8", "flash_decode_q4",
                                     "flash_decode_paged", "flash_decode_paged_q8")}

    def swap(dd):  # Q4: each row takes its sibling's scales
        return torch.cat([dd[:, :, g:], dd[:, :, :g]], dim=2)

    b7_s = {}  # seconds of B7's checks and of its timing rows

    def run_case(name, label, kernel, plain, args, lengths, extra_faults=None, swa=None):
        with seconds_into(b7_s if name == "flash_decode_paged_q8" else {}, "checks"):
            run_cases(name, label, kernel, plain, args, lengths, extra_faults, swa)

    def run_cases(name, label, kernel, plain, args, lengths, extra_faults, swa):
        if swa is None:
            swa = torch.clamp(lengths - D256_WINDOW, min=0)
        for case, starts, cap in (("full", None, 0.0), ("swa", swa, 0.0),
                                  ("softcap", None, 50.0)):
            want = plain(*args, lengths, starts, scale=sc, softcap=cap)
            st = torch.zeros_like(lengths) if starts is None else starts
            clusters, margin = (None,), 1.0
            if name == "flash_decode":
                faults = b2_faults(plain, *args, lengths, starts, scale=sc, softcap=cap)
            elif name == "flash_decode_paged_q8":
                faults = b7_faults(plain, *args, lengths, starts, scale=sc, softcap=cap)
                clusters, margin = ka.CLUSTERS, B7_FAULT_MARGIN
            else:
                faults = {"first row dropped": plain(*args, lengths, st + 1, scale=sc,
                                                     softcap=cap),
                          "last row dropped": plain(*args, lengths - 1, starts, scale=sc,
                                                    softcap=cap)}
            if extra_faults:
                for fname, fargs in extra_faults.items():
                    faults[fname] = plain(*fargs, lengths, starts, scale=sc, softcap=cap)
            for cl in clusters:
                kw = {} if cl is None else {"cluster": cl}
                got = kernel(*args, lengths, starts, scale=sc, softcap=cap, **kw)
                torch.cuda.synchronize()
                w = worst[name]
                w[0] = max(w[0], float((got - want).abs().max()))
                tag = f"{name} D=256 {label} {case}" + (
                    "" if cl is None else f" cluster {cl or 'auto'}")
                w[1] = max(w[1], check_slots(tag, got, want, faults, FLASH_NMSE_TOL, margin))

    for s, lens in D256_LENGTHS.items():
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        q = torch.randn(4, h, d, generator=gen, device="cuda")
        k = torch.randn(4, hkv, s, d, generator=gen, device="cuda")
        v = torch.randn(4, hkv, s, d, generator=gen, device="cuda")
        for dt in (torch.bfloat16, torch.float16, torch.float32):
            run_case("flash_decode", f"S={s} {str(dt)[6:]}", ka.flash_decode,
                     ka.flash_decode_plain, (q, k.to(dt), v.to(dt)), lengths)
        kq, kd = _dense_q8(k)
        vq, vd = _dense_q8(v)
        run_case("flash_decode_q8", f"S={s}", ka.flash_decode_q8, ka.flash_decode_q8_plain,
                 (q, kq, kd, vq, vd), lengths)
        k4, kd4 = _q4_planes(k)
        v4, vd4 = _q4_planes(v)
        run_case("flash_decode_q4", f"S={s}", ka.flash_decode_q4, ka.flash_decode_q4_plain,
                 (q, k4, kd4, v4, vd4), lengths,
                 {"parity scale planes swapped": (q, k4, swap(kd4), v4, swap(vd4))})
        for ps in (128, 16):
            tables, n_pages = _paged_tables(lens, ps, s, cpu_gen)
            kp = torch.randn(n_pages, hkv, ps, d, generator=gen, device="cuda")
            vp = torch.randn(n_pages, hkv, ps, d, generator=gen, device="cuda")
            run_case("flash_decode_paged", f"S={s} ps={ps}", ka.flash_decode_paged,
                     ka.flash_decode_paged_plain, (q, kp.to(torch.bfloat16),
                                                   vp.to(torch.bfloat16), tables), lengths)
            kpq, kpd = _dense_q8(kp)
            vpq, vpd = _dense_q8(vp)
            run_case("flash_decode_paged_q8", f"S={s} ps={ps}", ka.flash_decode_paged_q8,
                     ka.flash_decode_paged_q8_plain, (q, kpq, kpd, vpq, vpd, tables), lengths)
        del q, k, v
    for s, ps, lens, sts in B7_CACHES:
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        q = torch.randn(4, h, d, generator=gen, device="cuda")
        tables, n_pages = _paged_tables(lens, ps, s, cpu_gen)
        kpq, kpd = _dense_q8(torch.randn(n_pages, hkv, ps, d, generator=gen, device="cuda"))
        vpq, vpd = _dense_q8(torch.randn(n_pages, hkv, ps, d, generator=gen, device="cuda"))
        run_case("flash_decode_paged_q8", f"S={s} ps={ps}", ka.flash_decode_paged_q8,
                 ka.flash_decode_paged_q8_plain, (q, kpq, kpd, vpq, vpd, tables), lengths,
                 swa=torch.tensor(sts, dtype=torch.int32, device="cuda"))
        del kpq, kpd, vpq, vpd
    for s, (lens, sts) in B2_CACHES.items():
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        swa = torch.tensor(sts, dtype=torch.int32, device="cuda")
        q = torch.randn(4, h, d, generator=gen, device="cuda")
        k = torch.randn(4, hkv, s, d, generator=gen, device="cuda")
        v = torch.randn(4, hkv, s, d, generator=gen, device="cuda")
        for dt in (torch.bfloat16, torch.float16, torch.float32):
            run_case("flash_decode", f"S={s} {str(dt)[6:]}", ka.flash_decode,
                     ka.flash_decode_plain, (q, k.to(dt), v.to(dt)), lengths, swa=swa)
        del q, k, v

    # time: the Gemma-3-12B CLI's decode at 1532 rows, B=1: an SWA layer
    # reads its last 1024 rows, a full layer all of them
    L, ps = 1532, 128
    cap = 1536
    one = torch.tensor([L], dtype=torch.int32, device="cuda")
    io = 2 * h * d * 4 + 8  # q in, out, the length and start

    def deq(qs, dd):
        return (qs.float() * dd.transpose(-1, -2)).to(torch.bfloat16)

    def sdpa(q, k, v, lo):
        return F.scaled_dot_product_attention(q.to(torch.bfloat16)[:, :, None], k[:, :, lo:L],
                                              v[:, :, lo:L], scale=sc, enable_gqa=True)

    sets = []
    for _ in range(n_copies(2 * hkv * cap * d * 2)):
        q = torch.randn(1, h, d, generator=gen, device="cuda")
        k = torch.randn(1, hkv, cap, d, generator=gen, device="cuda")
        v = torch.randn(1, hkv, cap, d, generator=gen, device="cuda")
        tb = torch.randperm(cap // ps, generator=cpu_gen).to(torch.int32)[None].to("cuda")
        kp = k[0].reshape(hkv, cap // ps, ps, d).transpose(0, 1).contiguous()
        vp = v[0].reshape(hkv, cap // ps, ps, d).transpose(0, 1).contiguous()
        sets.append({"q": q, "bf16": (k.to(torch.bfloat16), v.to(torch.bfloat16)),
                     "q8": (*_dense_q8(k), *_dense_q8(v)), "q4": (*_q4_planes(k), *_q4_planes(v)),
                     "paged": (kp.to(torch.bfloat16), vp.to(torch.bfloat16), tb),
                     "paged_q8": (*_dense_q8(kp), *_dense_q8(vp), tb)})
    row_bytes = {"flash_decode": d * 2, "flash_decode_q8": d + 4, "flash_decode_q4": d // 2 + 4 * g,
                 "flash_decode_paged": d * 2, "flash_decode_paged_q8": d + 4}
    layouts = {
        "flash_decode": ("bf16", ka.flash_decode, ka.flash_decode_plain,
                         lambda q, k, v, lo: sdpa(q, k, v, lo)),
        "flash_decode_q8": ("q8", ka.flash_decode_q8, ka.flash_decode_q8_plain,
                            lambda q, kq, kd, vq, vd, lo: sdpa(q, deq(kq, kd), deq(vq, vd), lo)),
        "flash_decode_q4": ("q4", ka.flash_decode_q4, ka.flash_decode_q4_plain,
                            lambda q, kq, kd, vq, vd, lo: sdpa(
                                q, ka.q4_deq_plane(kq, kd), ka.q4_deq_plane(vq, vd), lo)),
        "flash_decode_paged": ("paged", ka.flash_decode_paged, ka.flash_decode_paged_plain,
                               lambda q, kp, vp, tb, lo: sdpa(q, ka._gather_pages(kp, tb),
                                                              ka._gather_pages(vp, tb), lo)),
        "flash_decode_paged_q8": (
            "paged_q8", ka.flash_decode_paged_q8, ka.flash_decode_paged_q8_plain,
            lambda q, kq, kd, vq, vd, tb, lo: sdpa(
                q, deq(ka._gather_pages(kq, tb), ka._gather_pages(kd[:, :, 0], tb)[:, :, None]),
                deq(ka._gather_pages(vq, tb), ka._gather_pages(vd[:, :, 0], tb)[:, :, None]),
                lo)),
    }
    for name, (key, kernel, plain, library) in layouts.items():
        t0 = time.perf_counter()
        arg_sets = [(st["q"], *st[key]) for st in sets]
        per_token = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
        wins = {}
        if name == "flash_decode_paged_q8":  # a first figure of a sequence reads high
            time_ms(lambda *a: kernel(*a, one, scale=sc), arg_sets)
        for (kind, lo), n_layers in zip((("SWA", L - D256_WINDOW), ("full", 0)), GEMMA3_LAYERS):
            starts = torch.tensor([lo], dtype=torch.int32, device="cuda") if lo else None
            timed = {"ms": time_ms(lambda *a: kernel(*a, one, starts, scale=sc), arg_sets),
                     "plain_ms": time_ms(lambda *a: plain(*a, one, starts, scale=sc), arg_sets),
                     "library_ms": time_ms(lambda *a: library(*a, lo), arg_sets)}
            if name in ("flash_decode", "flash_decode_paged_q8"):
                for cl in (8, 16):
                    timed[f"cluster{cl}_ms"] = time_ms(
                        lambda *a: kernel(*a, one, starts, scale=sc, cluster=cl), arg_sets)
            extra = 4 * (cap // ps) if "paged" in name else 0  # the table row, int32
            bms, by = bound_ms(2 * hkv * (L - lo) * row_bytes[name] + io + extra,
                               4.0 * h * (L - lo) * d)
            times = {k_: v_[0] for k_, v_ in timed.items()}
            times["bound_ms"] = bms
            for k_, v_ in times.items():
                per_token[k_] = per_token.get(k_, 0.0) + n_layers * v_
            for k_, v_ in timed.items():
                add_window(wins, k_, v_[1])
            print(f"  {name} D=256 Gemma-3-12B {kind} layer at {L} rows: "
                  + ", ".join(f"{k_} {v_[0]:.4f} [{v_[1]}]" for k_, v_ in timed.items())
                  + f", bound_ms {bms:.4f} ms")
        print(f"  {name} D=256 per Gemma-3-12B token (48 layers): "
              + ", ".join(f"{k_} {v_:.4f}" for k_, v_ in per_token.items()))
        records[name]["d256"] = {**per_token, "bound_by": by, "max_abs_err": worst[name][0],
                                 "max_nmse": worst[name][1], "windows": wins}
        if name == "flash_decode_paged_q8":
            b7_s["timing"] = time.perf_counter() - t0
    print(f"  flash_decode_paged_q8 at D=256: checks {b7_s['checks']:.1f} s, timing rows "
          f"{b7_s['timing']:.1f} s")


# per slot, of the output and of the written K/V rows: the plain version
# rounds the dequantized weight to bf16 and the kernel does not, which reads
# 7e-6 at most on the H100; a dropped row reads 1.3e-3 at least. The limit
# is 7x the one and 26x below the other.
FUSED_NMSE_TOL = 5e-5


def check_attn_fused(records):
    import numpy as np
    import torch

    from llama_cpp_dsp_tpu_torch.gguf.constants import GGMLType
    from llama_cpp_dsp_tpu_torch.ops.kernels.attn_fused import (
        attn_decode_fused, attn_fused_plain)
    from llama_cpp_dsp_tpu_torch.ops.rope import RopeParams, _rope_angles
    from llama_cpp_dsp_tpu_torch.tools.synth import synth_qtensor

    rng = np.random.default_rng(2)
    gen = torch.Generator(device="cuda").manual_seed(2)
    d, kdim, s = 128, 4096, 512
    rp = RopeParams(n_dims=d)
    worst = worst_nmse = 0.0

    def inputs(b, h, hkv, n_past):
        w = synth_qtensor(rng, GGMLType.Q4_0, ((h + 2 * hkv) * d, kdim)).to("cuda")
        x = (torch.randn(b, kdim, generator=gen, device="cuda") * 0.3).to(torch.bfloat16)
        # the cached rows at about the new rows' scale: the scores spread by
        # about 1, so the softmax is not flat at 512 rows
        kc = torch.randn(b, hkv, s, d, generator=gen, device="cuda").to(torch.bfloat16)
        vc = torch.randn(b, hkv, s, d, generator=gen, device="cuda").to(torch.bfloat16)
        for bi, p in enumerate(n_past):
            kc[bi, :, min(p, s):] = 0
            vc[bi, :, min(p, s):] = 0
        pos = torch.tensor(n_past, dtype=torch.int32, device="cuda")
        cos, sin = _rope_angles(pos, rp, None)
        return w, x, kc, vc, cos, sin, pos + 1

    for label, h, hkv, n_past in (("B=1 MHA", 32, 32, [37]),
                                  ("B=4 MHA, slot 3 idle", 32, 32, [5, 200, 511, s]),
                                  ("B=2 GQA", 32, 8, [90, 3])):
        b = len(n_past)
        w, x, kc, vc, cos, sin, lengths = inputs(b, h, hkv, n_past)
        kc2, vc2 = kc.clone(), vc.clone()
        before_k = kc.clone()
        got = attn_decode_fused(x, w, kc, vc, cos, sin, lengths, n_heads=h, n_kv_heads=hkv,
                                scale=d ** -0.5)

        def plain(ln, st):
            return attn_fused_plain(x, w, kc2, vc2, cos, sin, ln, st, lengths - 1,
                                    n_heads=h, n_kv_heads=hkv, scale=d ** -0.5)

        want = plain(lengths, None)
        faults = {"first row dropped": plain(lengths, torch.ones_like(lengths)),
                  "last cached row dropped": plain(lengths - 1, None)}
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        row_err = max([nmse(c[bi, :, p], c2[bi, :, p]) for bi, p in enumerate(n_past)
                       if p < s for c, c2 in ((kc, kc2), (vc, vc2))])
        untouched = kc.clone()
        for bi, p in enumerate(n_past):
            if p < s:
                untouched[bi, :, p] = before_k[bi, :, p]
        same_elsewhere = torch.equal(untouched, before_k)
        worst = max(worst, err)
        print(f"  attn_fused {label}: max|kernel-plain| out {err:.3e}, written rows "
              f"nmse {row_err:.1e} (tol {FUSED_NMSE_TOL:g}), other rows and idle slots "
              f"unchanged: {same_elsewhere}")
        if not (row_err <= FUSED_NMSE_TOL and same_elsewhere):
            fail(f"attn_fused {label}: cache writes disagree with the plain version")
        worst_nmse = max(worst_nmse, check_slots(f"attn_fused {label}", got, want, faults,
                                                 FUSED_NMSE_TOL))
    # time: one 7B layer (B=1) at a 512-row context, cold weights and caches
    h = hkv = 32
    L = 511  # cached rows; the new row is the 512th
    w_bytes = (h + 2 * hkv) * d * kdim // 32 * 18
    kv_bytes = 2 * hkv * L * d * 2
    sets = []
    for _ in range(n_copies(w_bytes + kv_bytes)):
        w, x, kc, vc, cos, sin, lengths = inputs(1, h, hkv, [L])
        sets.append((x, w, kc, vc, cos, sin, lengths))
    ms, w_ms = time_ms(lambda *a: attn_decode_fused(*a, n_heads=h, n_kv_heads=hkv,
                                                    scale=d ** -0.5), sets)
    pms, w_pms = time_ms(lambda x, w, kc, vc, cs, sn, ln: attn_fused_plain(
        x, w, kc, vc, cs, sn, ln, None, ln - 1, n_heads=h, n_kv_heads=hkv, scale=d ** -0.5),
        sets, iters=5)
    print(f"  attn_fused 7B layer, context {L + 1}: kernel {ms:.4f} ms [{w_ms}], plain "
          f"{pms:.4f} ms [{w_pms}], {(w_bytes + kv_bytes) / ms / 1e6:.0f} GB/s")
    bms, by = bound_ms(w_bytes + kv_bytes + kdim * 2 + h * d * 4 + 2 * hkv * d * 2,
                       2.0 * (h + 2 * hkv) * d * kdim + 4.0 * h * (L + 1) * d)
    records["attn_fused"].update(max_abs_err=worst, max_nmse=worst_nmse, ms=32 * ms,
                                 plain_ms=32 * pms, library_ms=None, bound_ms=32 * bms,
                                 bound_by=by, windows={"ms": w_ms, "plain_ms": w_pms})


# MLA decode (B10) at DeepSeek-V2-Lite's shapes: H 16 heads, C = 512 + 64
# padded to 640, r = 512; per slot the kernel against its plain version
# (NMSE; f32 sums in another order), with planted faults: the last valid row
# dropped, and (where every slot is shorter than S) the row past the length
# counted
MLA_H, MLA_C, MLA_R = 16, 640, 512
MLA_NMSE_TOL = 1e-8


def check_mla_decode(records):
    import torch
    import torch.nn.functional as F

    from llama_cpp_dsp_tpu_torch.ops.kernels.attention import (mla_flash_decode,
                                                                mla_flash_decode_plain)

    gen = torch.Generator(device="cuda").manual_seed(5)
    scale = 192 ** -0.5
    worst = worst_nmse = 0.0
    for s in (128, 512, 4096):
        for lens in ([s], [s - 1], [1, 77, s // 2 + 3, s - 1]):
            b = len(lens)
            # q at a scale that keeps the softmax broad (score std ~0.55), so
            # that a single row's weight is never negligible
            q = torch.randn(b, MLA_H, MLA_C, generator=gen, device="cuda") * 0.3
            c = torch.randn(b, 1, s, MLA_C, generator=gen, device="cuda").to(torch.bfloat16)
            ln = torch.tensor(lens, dtype=torch.int32, device="cuda")
            got = mla_flash_decode(q, c, ln, scale=scale, r=MLA_R)
            want = mla_flash_decode_plain(q, c, ln, scale=scale, r=MLA_R)
            faults = {"last row dropped": mla_flash_decode_plain(q, c, ln - 1, scale=scale,
                                                                 r=MLA_R)}
            if max(lens) < s:
                faults["the row past the length counted"] = mla_flash_decode_plain(
                    q, c, ln + 1, scale=scale, r=MLA_R)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            worst = max(worst, err)
            worst_nmse = max(worst_nmse, check_slots(f"mla_decode S={s} lengths={lens}", got,
                                                     want, faults, MLA_NMSE_TOL))
    # time: one DeepSeek-V2-Lite layer (B=1) at 40 rows of a 512-row cache
    # (the CLI cell's context), at a full 512-row and a full 4096-row cache,
    # cold caches; per token ×27 layers at 512 rows
    per_token = {}
    for L, cap in ((40, 512), (512, 512), (4096, 4096)):
        one = torch.tensor([L], dtype=torch.int32, device="cuda")
        c_bytes = L * MLA_C * 2
        sets = []
        for _ in range(n_copies(cap * MLA_C * 2)):
            q = torch.randn(1, MLA_H, MLA_C, generator=gen, device="cuda") * 0.3
            c = torch.randn(1, 1, cap, MLA_C, generator=gen, device="cuda").to(torch.bfloat16)
            sets.append((q, c))
        ms, w_ms = time_ms(lambda q, c: mla_flash_decode(q, c, one, scale=scale, r=MLA_R),
                           sets)
        pms, w_pms = time_ms(lambda q, c: mla_flash_decode_plain(q, c, one, scale=scale,
                                                                 r=MLA_R), sets, iters=10)
        # yardstick: SDPA with the latent expanded to H heads (K = c, V = c[..., :r])
        lms, w_lms = time_ms(lambda q, c: F.scaled_dot_product_attention(
            q.to(torch.bfloat16)[:, :, None], c[:, :, :L].expand(-1, MLA_H, -1, -1),
            c[:, :, :L, :MLA_R].expand(-1, MLA_H, -1, -1), scale=scale), sets, iters=10)
        # f32 products, as the TPU kernel's Precision.HIGHEST
        bms, by = bound_ms(c_bytes + MLA_H * MLA_C * 4 + MLA_H * MLA_R * 4,
                           2.0 * MLA_H * L * (MLA_C + MLA_R), F32_FLOPS)
        print(f"  mla_decode one layer, context {L} of {cap}: kernel {ms:.4f} ms [{w_ms}], "
              f"plain {pms:.4f} ms [{w_pms}], sdpa {lms:.4f} ms [{w_lms}], bound {bms:.5f} ms "
              f"({by}), {c_bytes / ms / 1e6:.0f} GB/s")
        per_token[L] = (ms, pms, lms, bms, by, {"ms": w_ms, "plain_ms": w_pms,
                                                "library_ms": w_lms})
    ms, pms, lms, bms, by, wins = per_token[512]
    records["mla_decode"].update(max_abs_err=worst, max_nmse=worst_nmse, ms=27 * ms,
                                 plain_ms=27 * pms, library_ms=27 * lms, bound_ms=27 * bms,
                                 bound_by=by, windows=wins)


# ---------------------------------------------------------------------------
# paths through the port
# ---------------------------------------------------------------------------

def run_cli(argv: list[str], model=None) -> tuple[str, str]:
    """The port's CLI in this process (on `model` when given, the GGUF of
    -m already loaded); returns (stdout text, stderr text)."""
    from llama_cpp_dsp_tpu_torch.tools.cli import main

    out, err = io.BytesIO(), io.StringIO()
    wrapper = io.TextIOWrapper(out, encoding="utf-8", write_through=True)
    with contextlib.redirect_stdout(wrapper), contextlib.redirect_stderr(err):
        rc = main(argv, model)
    wrapper.flush()
    text = out.getvalue().decode("utf-8", errors="replace")
    print(f"  cli {' '.join(argv[2:])}: rc {rc}")
    print("  | " + err.getvalue().strip().replace("\n", "\n  | "))
    print(f"  | stdout {text!r}")
    if rc != 0:
        fail(f"CLI exited {rc}")
    return text, err.getvalue()


def decode_tps(stderr: str) -> float:
    m = re.search(r"decode: \d+ tok in [\d.]+ ms \(([\d.]+) t/s\)", stderr)
    if not m:
        fail("no perf line from the CLI")
    return float(m.group(1))


def require(counts: dict, names: list[str], path: str) -> None:
    print(f"  launches on the {path} path: {counts}")
    for name in names:
        if counts[name] <= 0:
            fail(f"{name} was not launched on the {path} path")


# kernels whose line profile_steps prints even outside the top six: B2
PROFILE_WATCH = ("flash_decode_gqa",)


def profile_steps(fn, steps: int) -> None:
    """Where one step's time goes: host wall time of fn (which runs `steps`
    steps and ends in a host sync; no profiler), and the device time of its
    kernels by name (torch.profiler, a second call): the top six, and any
    kernel PROFILE_WATCH names."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    if not kernels:
        print(f"    wall {wall_ms:.3f} ms/step; device time not measured (no CUDA events)")
        return
    print(f"    wall {wall_ms:.3f} ms/step, device kernels {dev_ms:.3f} ms/step "
          f"(busy {dev_ms / wall_ms:.1%}), {sum(e.count for e in kernels) / steps:.0f} "
          "kernel launches/step; top kernels:")
    ranked = sorted(kernels, key=lambda e: -e.self_device_time_total)
    for i, e in enumerate(ranked):
        if i < 6 or any(w in e.key for w in PROFILE_WATCH):
            print(f"      {e.self_device_time_total / 1e3 / steps:.3f} ms/step "
                  f"{e.count / steps:.0f}x  {e.key[:70]}")


def profile_chunk(ctx, token: int, steps: int = 8) -> None:
    """An 8-step greedy decode chunk of `ctx`, profiled (profile_steps)."""
    greedy = {"top_k": 1, "top_p": 1.0, "min_p": 0.0, "temp": 1.0}
    profile_steps(lambda: ctx._eval_sample_chunk(token, greedy, steps), steps)


def small_model_check(path: Path | None, prompt_text: str, must: list[str], label: str,
                      model=None, ctx_kw: dict | None = None, cache_fn=None,
                      n_stream: int = 12, prefill_tol: float = 2e-2) -> dict:
    """A small synthetic GGUF (or `model`, already loaded): logits of a
    prompt (within prefill_tol) and of one decode step (2e-2), and a greedy
    stream, on the card (kernels) against the CPU (plain versions). ctx_kw:
    LlamaContext options (the KV types); cache_fn(device): a cache that
    replaces the context's own. Deletes `path` when done; returns the
    card's launches."""
    import torch

    from llama_cpp_dsp_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from llama_cpp_dsp_tpu_torch.runtime.context import LlamaContext
    from llama_cpp_dsp_tpu_torch.runtime.loader import load_model
    from llama_cpp_dsp_tpu_torch.runtime.sampling import make_chain

    model = model or load_model(str(path))
    prompt = model.tokenizer.encode(prompt_text)

    def context(device):
        ctx = LlamaContext(model, n_ctx=64, device=device, **(ctx_kw or {}))
        if cache_fn is not None:
            ctx.cache = cache_fn(device)
        return ctx

    ref = context("cpu")
    ref_logits = ref.eval_tokens(prompt)
    ref_stream = list(context("cpu").generate(prompt, max_new_tokens=n_stream,
                                              sampler=make_chain(temp=0)))
    reset_launches()
    ctx = context("cuda")
    logits = ctx.eval_tokens(prompt)
    step = ctx.eval_tokens([int(ref_logits.argmax())])
    ref_step = ref.eval_tokens([int(ref_logits.argmax())])
    stream = list(context("cuda").generate(prompt, max_new_tokens=n_stream,
                                           sampler=make_chain(temp=0)))
    counts = dict(LAUNCHES)
    scale = float(abs(ref_logits).max())
    e_pre = float(abs(logits - ref_logits).max()) / scale
    e_dec = float(abs(step - ref_step).max()) / float(abs(ref_step).max())
    print(f"  {label} card vs CPU: {len(prompt)}-token prefill logits rel err {e_pre:.2e} "
          f"(tol {prefill_tol:g}), decode step {e_dec:.2e} (tol 2e-2); stream {stream} vs "
          f"{ref_stream}")
    require(counts, must, label)
    if not (e_pre < prefill_tol and e_dec < 2e-2
            and torch.isfinite(torch.from_numpy(step)).all()):
        fail(f"{label} on the card disagrees with the CPU path")
    n_same = next((i for i, (a, b) in enumerate(zip(stream, ref_stream)) if a != b),
                  len(stream))
    print(f"  {label} greedy stream: {n_same}/{len(stream)} leading tokens agree")
    if path is not None:
        path.unlink()
    return counts


def phase_small() -> None:
    from llama_cpp_dsp_tpu_torch.models.llama import LlamaConfig
    from llama_cpp_dsp_tpu_torch.ops.rope import RopeParams
    from llama_cpp_dsp_tpu_torch.tools.synth import write_synth_gguf

    cfg = LlamaConfig(arch="llama", n_layers=2, n_embd=256, n_heads=2, n_kv_heads=2,
                      head_dim=128, n_ff=512, n_vocab=512, n_ctx_train=128,
                      rope=RopeParams(n_dims=128))
    path = ROOT / "build" / "smoke" / "small-q4_0.gguf"
    path.parent.mkdir(parents=True, exist_ok=True)
    write_synth_gguf(str(path), cfg, "Q4_0", seed=5)
    small_model_check(path, "hello world", ["qmm_q4_0", "attn_fused", "flash_prefill"], "small")


def phase_small_kq() -> None:
    """A 2-layer head_dim-128 GQA Q4_K_M model with the llama-bpe vocab: layer
    0 all Q4_K (q|k|v fused), layer 1 attn_v and ffn_down Q6_K, the LM head
    Q6_K. The prompt is longer than 8 tokens, so prefill runs the tiled
    kernels and decode the GEMVs."""
    from llama_cpp_dsp_tpu_torch.models.llama import LlamaConfig
    from llama_cpp_dsp_tpu_torch.ops.rope import RopeParams
    from llama_cpp_dsp_tpu_torch.tools.synth import write_synth_gguf

    cfg = LlamaConfig(arch="llama", n_layers=2, n_embd=256, n_heads=2, n_kv_heads=1,
                      head_dim=128, n_ff=512, n_vocab=2048, n_ctx_train=256,
                      rope=RopeParams(n_dims=128, freq_base=500000.0))
    path = ROOT / "build" / "smoke" / "small-q4_k_m.gguf"
    path.parent.mkdir(parents=True, exist_ok=True)
    write_synth_gguf(str(path), cfg, "Q4_K_M", seed=5, vocab="llama-bpe")
    small_model_check(path, "The quick brown fox jumps over the lazy dog, then rests a while.",
                      ["qmm_q4_k", "qmm_q6_k", "flash_decode", "flash_prefill"], "small_kq")


SMALL_KV_TYPES = {  # (-ctk, -ctv) → the decode attention kernel its path runs
    ("f32", None): "flash_decode", ("f16", None): "flash_decode",
    ("q8_0", None): "flash_decode_q8", ("q4_0", None): "flash_decode_q4",
    ("q4_1", None): "flash_decode", ("q5_0", None): "flash_decode",
    ("q5_1", None): "flash_decode", ("iq4_nl", None): "flash_decode",
    ("q8_0", "q4_0"): "flash_decode",
}


def phase_small_kv(records: dict) -> None:
    """A 2-layer head_dim-128 GQA Q4_0 model, card against CPU, over every
    -ctk type (-ctv its default), the split pair -ctk q8_0 -ctv q4_0 and
    Q4_0 pages (shuffled, 16 rows each); then a small DeepSeek-V2 with
    -ctk q8_0, whose latent attention takes the plain path over the
    quantized cache (no MLA decode kernel)."""
    import numpy as np

    from llama_cpp_dsp_tpu_torch.models.llama import LlamaConfig
    from llama_cpp_dsp_tpu_torch.ops.rope import RopeParams
    from llama_cpp_dsp_tpu_torch.runtime.loader import load_model
    from llama_cpp_dsp_tpu_torch.runtime.paged_kv import PagedQ4KVCache
    from llama_cpp_dsp_tpu_torch.tools.synth import write_synth_gguf

    cfg = LlamaConfig(arch="llama", n_layers=2, n_embd=256, n_heads=2, n_kv_heads=1,
                      head_dim=128, n_ff=512, n_vocab=512, n_ctx_train=128,
                      rope=RopeParams(n_dims=128))
    path = ROOT / "build" / "smoke" / "small-kv-q4_0.gguf"
    path.parent.mkdir(parents=True, exist_ok=True)
    write_synth_gguf(str(path), cfg, "Q4_0", seed=7)
    model = load_model(str(path))
    path.unlink()
    prompt = "hello world, the quick brown fox"
    for (ctk, ctv), kernel in SMALL_KV_TYPES.items():
        label = f"small_kv -ctk {ctk}" + (f" -ctv {ctv}" if ctv else "")
        dense = ctk in ("f32", "f16") and ctv is None  # a KVCache: B4 prefills it
        counts = small_model_check(None, prompt, ["qmm_q4_0", kernel] + ["flash_prefill"] * dense,
                                   label, model=model,
                                   ctx_kw={"kv_dtype": ctk, "kv_v_dtype": ctv}, n_stream=16)
        records[kernel]["launches"] = records[kernel]["launches"] or counts[kernel]

    def paged(device):
        cache = PagedQ4KVCache.create(cfg.n_layers, 5, 1, 4, cfg.n_kv_heads, cfg.head_dim,
                                      page_size=16, device=device)
        cache.set_table_row(0, np.array([3, 0, 4, 1], np.int32))
        return cache

    small_model_check(None, prompt, ["qmm_q4_0", "flash_decode"], "small_kv paged q4_0",
                      model=model, cache_fn=paged, n_stream=16)
    ds_path = ROOT / "build" / "smoke" / "small-kv-ds-q4_1.gguf"
    write_synth_gguf(str(ds_path), _small_ds_config(), "Q4_1", seed=6, vocab="deepseek-llm",
                     experts=SMALL_DS_EXPERTS)
    counts = small_model_check(ds_path, prompt, ["qmm_q4_1", "qmm_experts_q4_1"],
                               "small_kv deepseek2 -ctk q8_0", ctx_kw={"kv_dtype": "q8_0"},
                               n_stream=16)
    if counts["mla_decode"]:
        fail("MLA over a q8_0 latent cache launched the bf16 MLA decode kernel")


def write_model(path: Path, cfg_name: str, ftype: str, seed: int, vocab: str = "spm",
                chat_template: str | None = None) -> None:
    """A full-width, full-depth synthetic GGUF of `tools/synth.py` CONFIGS
    (written once per run, deleted after its last phase)."""
    from llama_cpp_dsp_tpu_torch.tools.synth import CONFIGS, write_synth_gguf

    cfg = CONFIGS[cfg_name]
    path.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    write_synth_gguf(str(path), cfg, ftype, seed=seed, vocab=vocab, chat_template=chat_template)
    print(f"  wrote {path.name} ({path.stat().st_size / 1e9:.2f} GB, {cfg.n_layers} layers, "
          f"{ftype}, {vocab} vocab) in {time.perf_counter() - t0:.1f} s")


# synthetic GGUF → the phases that read it, in the order the phases run
# in the order the phases take them: the writer keeps one file ahead, so
# Mixtral's 28.5 GB is written during llama3 and kv8b, and the short q5km
# phase comes last
FILE_PHASES = {"7b": ("main", "serve"), "l3": ("llama3", "kv8b"), "mx": ("mixtral",),
               "ds": ("deepseek",), "q25": ("qwen",), "q3": ("qwen",), "g3": ("gemma",),
               "iq4xs": ("iq",), "iq2m": ("iq",), "q5": ("q5km",)}


class BackgroundGGUFs:
    """The run's full-size synthetic GGUFs (`files`: key → path, config,
    ftype, vocab, chat template, seed), each written by a child process (a
    fresh interpreter that never touches the card) while the phases before
    its own run. One file ahead: the first is started here, the next when a
    phase asks for one (`ready`), so at most the file in use and the next
    lie on disk. `close` stops a write still running and deletes them all."""

    def __init__(self, files: dict, order: list):
        self.files, self.order, self.procs = files, order, {}
        if order:
            self._start(order[0])

    def _start(self, key: str) -> None:
        path, cfg_name, ftype, vocab, template, seed = self.files[key]
        code = ("import sys; from pathlib import Path; sys.path.insert(0, sys.argv[1]); "
                "import chip_smoke; a = sys.argv; chip_smoke.write_model(Path(a[2]), a[3], "
                "a[4], int(a[5]), a[6], a[7] or None)")
        self.procs[key] = subprocess.Popen(
            [sys.executable, "-c", code, str(ROOT), str(path), cfg_name, ftype, str(seed),
             vocab, template or ""], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def ready(self, key: str) -> Path:
        """The file of `key`, written (waiting for its child if it runs);
        the next file in order started."""
        path, cfg_name, ftype, vocab, template, seed = self.files[key]
        t0 = time.perf_counter()
        proc = self.procs.pop(key, None)
        if proc is not None:
            out, _ = proc.communicate()
            print("  " + out.strip().replace("\n", "\n  "))
            if proc.returncode:
                fail(f"writing {path.name} in the background exited {proc.returncode}")
            print(f"  ({path.name} written in the background; waited "
                  f"{time.perf_counter() - t0:.1f} s for it)")
        elif not path.exists():
            write_model(path, cfg_name, ftype, seed, vocab, template)
        nxt = self.order[self.order.index(key) + 1:][:1]
        if nxt and nxt[0] not in self.procs and not self.files[nxt[0]][0].exists():
            self._start(nxt[0])
        return path

    def close(self) -> None:
        for proc in self.procs.values():
            proc.kill()
            proc.wait()
        self.procs.clear()
        for path, *_ in self.files.values():
            path.unlink(missing_ok=True)


def phase_main(records: dict, path: Path, model) -> None:
    import numpy as np
    import torch

    from llama_cpp_dsp_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from llama_cpp_dsp_tpu_torch.runtime.context import LlamaContext
    from llama_cpp_dsp_tpu_torch.runtime.sampling import make_chain

    argv = ["-m", str(path), "-p", "hello", "-n", "32", "--temp", "0", "-c", "512"]
    reset_launches()
    _, err = run_cli(argv)
    counts = dict(LAUNCHES)
    require(counts, ["qmm_q4_0", "attn_fused", "flash_prefill"], "main (fused)")
    records["qmm_q4_0"]["launches"] = counts["qmm_q4_0"]
    records["attn_fused"]["launches"] = counts["attn_fused"]
    print(f"  main path (fused attention): {decode_tps(err):.2f} tokens/s decode")

    prompt = model.tokenizer.encode("hello")
    fused = LlamaContext(model, n_ctx=512, fused_attn=True)
    unfused = LlamaContext(model, n_ctx=512, fused_attn=False)
    pre_f, pre_u = fused.eval_tokens(prompt), unfused.eval_tokens(prompt)
    tok = int(pre_f.argmax())
    step_f, step_u = fused.eval_tokens([tok]), unfused.eval_tokens([tok])
    rel = float(np.abs(step_f - step_u).max() / np.abs(step_u).max())
    print(f"  first decode step logits, fused vs flash decode: max rel diff {rel:.3e} "
          f"(tol 2e-2); prefill identical: {np.array_equal(pre_f, pre_u)}; "
          f"finite: {bool(np.isfinite(step_f).all())}")
    if not (rel < 2e-2 and np.isfinite(step_f).all() and np.isfinite(step_u).all()):
        fail("fused and unfused decode disagree")
    del fused, unfused
    streams, tps = {}, {}
    for name, fa in (("fused", True), ("unfused", False)):
        ctx = LlamaContext(model, n_ctx=512, fused_attn=fa)
        reset_launches()
        streams[name] = list(ctx.generate(prompt, max_new_tokens=32,
                                          sampler=make_chain(temp=0)))
        torch.cuda.synchronize()
        counts = dict(LAUNCHES)
        tps[name] = ctx.perf.n_decode / ctx.perf.t_decode_ms * 1e3 if ctx.perf.t_decode_ms else 0
        print(f"  {name} decode step at context {ctx.n_past}:")
        profile_chunk(ctx, streams[name][-1])
        if name == "unfused":
            require(counts, ["qmm_q4_0", "flash_decode"], "main (flash decode)")
            records["flash_decode"]["launches"] = counts["flash_decode"]
        del ctx
    n_same = sum(a == b for a, b in zip(streams["fused"], streams["unfused"]))
    print(f"  decode tokens/s: fused {tps['fused']:.2f}, flash decode {tps['unfused']:.2f}; "
          f"{n_same}/{len(streams['fused'])} stream tokens agree")


SERVE_CONFIGS = {  # name → (server flags, kernels its decode must launch)
    "slots bf16": ([], ["attn_fused", "qmm_q4_0"]),
    "slots q8_0": (["-ctk", "q8_0"], ["flash_decode_q8", "qmm_q4_0"]),
    "paged bf16": (["--kv-layout", "paged"], ["flash_decode_paged", "qmm_q4_0"]),
    "paged q8_0": (["--kv-layout", "paged", "-ctk", "q8_0"],
                   ["flash_decode_paged_q8", "qmm_q4_0"]),
}
SERVE_N_PREDICT = 32
LOGIT_RTOL = 2e-2


def _post(base: str, path: str, body: dict, on_first=None) -> dict:
    """POST a JSON body. Returns status, the parsed body (or the SSE events,
    JSON or the literal [DONE]), seconds to the first event and in all."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(base + path, data=json.dumps(body).encode(), method="POST",
                                 headers={"Content-Type": "application/json",
                                          "Authorization": "Bearer smoke"})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            out = {"path": path, "stream": bool(body.get("stream")), "status": r.status,
                   "first_s": None}
            if not out["stream"]:
                out["body"] = json.loads(r.read())
            else:
                events = []
                for raw in r:
                    line = raw.decode().rstrip("\n")
                    if not line:
                        continue
                    if not line.startswith("data: "):
                        fail(f"{path}: SSE line {line[:80]!r} is not `data: ...`")
                    if out["first_s"] is None:
                        out["first_s"] = time.perf_counter() - t0
                        if on_first is not None:
                            on_first()
                    data = line[len("data: "):]
                    events.append(data if data == "[DONE]" else json.loads(data))
                out["body"] = events
    except urllib.error.HTTPError as e:
        fail(f"{path} answered HTTP {e.code}: {e.read()[:300]!r}")
    out["total_s"] = time.perf_counter() - t0
    return out


def _check_reply(r: dict) -> tuple[int, str, str]:
    """Fail unless the reply is well formed and carries tokens and a JAX
    stop reason. Returns (tokens, stop reason, text)."""
    body, path = r["body"], r["path"]
    if r["status"] != 200:
        fail(f"{path}: HTTP {r['status']}")
    chat = path.endswith("chat/completions")
    if chat and not r["stream"]:
        ch = body["choices"][0]
        n, reason, text = body["usage"]["completion_tokens"], ch["finish_reason"], \
            ch["message"]["content"] or ""
        ok = body["object"] == "chat.completion" and ch["message"]["role"] == "assistant"
    elif chat:
        ok = body[-1] == "[DONE]" and all(e["object"] == "chat.completion.chunk"
                                          for e in body[:-1])
        last = body[-2]
        n, reason = last["usage"]["completion_tokens"], last["choices"][0]["finish_reason"]
        text = "".join(e["choices"][0]["delta"].get("content", "") for e in body[:-1])
        ok = ok and all(e["choices"][0]["finish_reason"] is None for e in body[:-2])
    else:  # native /completion; its stream ends on the stop:true payload (JAX framing)
        last = body if not r["stream"] else body[-1]
        ok = last["stop"] is True and "[DONE]" not in (body if r["stream"] else [])
        if r["stream"]:
            ok = ok and all(e["stop"] is False for e in body[:-1])
        n, text = last["tokens_predicted"], last["content"]
        reason = {"limit": "length", "eos": "stop", "word": "stop"}.get(last["stop_type"])
    if not (ok and n >= 1 and reason in ("stop", "length")):
        fail(f"{path}{' (stream)' if r['stream'] else ''}: malformed reply, {n} tokens, "
             f"stop reason {reason!r}")
    return n, reason, text


def _slot_state(cache, idx: int) -> list:
    """Every cached row of slot idx, as stored (pages gathered)."""
    from llama_cpp_dsp_tpu_torch.runtime.kv_cache import _PlaneCache
    from llama_cpp_dsp_tpu_torch.runtime.paged_kv import PagedQ4KVCache, PagedQuantKVCache

    if isinstance(cache, _PlaneCache):
        return [b[idx].clone() for b in cache.planes()]
    if isinstance(cache, PagedQuantKVCache):
        pools = [*cache.k_qs, *cache.v_qs, *(p[:, :, 0] for p in (*cache.k_d, *cache.v_d))]
    elif isinstance(cache, PagedQ4KVCache):
        pools = [*cache.k_qs, *cache.k_d, *cache.v_qs, *cache.v_d]
    else:
        pools = [*cache.k, *cache.v]
    return [cache._gather(p)[idx].clone() for p in pools]


@contextlib.contextmanager
def _record_moe(log: list):
    """Record every MoE layer's FFN input and output inside the block, in
    layer order, with the layer's params."""
    from llama_cpp_dsp_tpu_torch.models import llama

    inner = llama.ffn_moe

    def ffn_moe(x, layer, cfg):
        out = inner(x, layer, cfg)
        log.append((x.detach().clone(), out.detach().clone(), layer))
        return out

    llama.ffn_moe = ffn_moe
    try:
        yield log
    finally:
        llama.ffn_moe = inner


def _rel(a, b) -> float:
    return float((a.float() - b.float()).abs().max() / b.float().abs().max())


# an MoE layer of the batched decode step, rerun at B=1 on the same input
# row, must give the same output: B9 computes a row alike at any S and the
# router and the rest of the layer are row-wise; the first layer's input
# (embedding, attention) must agree with the reference's
MOE_LAYER_RTOL = 1e-3


def _reference_first_step(engine, prompt: list[int], as_engine: bool = False,
                          moe_log: list | None = None, own_layout: bool = True):
    """LlamaContext's computation on the engine's weights: `forward` over a
    cache of its own with the engine's row type (bf16, Q8_0 or Q4_0), the
    prompt as one prefill, then one decode step on the prompt's argmax.
    Returns (that token, the decode step's logits of row 0, the cache's
    description).

    own_layout: the engine's layout (slots or pages) at the engine's batch
    width, the prompt in every row, its own slot each. The kernels then tile
    both steps alike (B1 splits K by B, B2 / B7 choose their cluster size
    from B·Hkv), so the comparison holds the engine's bookkeeping (slots or
    pages, packed prefill, batched decode) bit for bit; that the kernels
    compute the right thing is held layer by layer (`_checking_kernels`).
    Otherwise B=1 over a contiguous cache (Q4_0 pages: one sequence's
    pages), which runs other kernels or other tilings than the engine's
    step; a random 8B-size model grows their last-bit differences to 1-2e-2
    over its layers (Llama-3-8B IQ4_XS: slots bf16 1.8e-2, paged q8_0
    2.0-2.1e-2; PERF.md §6).

    as_engine: the prompt as the engine's slot prefill runs it
    (`Engine._prefill_slot`: one chunk of the bucket's length, the padding
    rows at position 0), so that the cached rows come out bit-equal and the
    comparison holds the engine's batched decode step alone. An MoE model
    needs it: a random router's top-2 choice flips under the last-bit
    differences that another prefill shape brings, somewhere in 32 layers
    of the prompt's tokens, and one flip moves the logits by O(1).
    moe_log: a list that receives the decode step's MoE layer inputs and
    outputs (`_record_moe`)."""
    import numpy as np
    import torch

    from llama_cpp_dsp_tpu_torch.models.llama import forward
    from llama_cpp_dsp_tpu_torch.runtime.kv_cache import Q4KVCache, QuantKVCache, make_kv_cache
    from llama_cpp_dsp_tpu_torch.runtime.paged_kv import (PagedKVCache, PagedQ4KVCache,
                                                          PagedQuantKVCache)

    cfg = engine.cfg
    b = engine.n_slots if own_layout else 1
    kv = ("q8_0" if isinstance(engine.cache, (QuantKVCache, PagedQuantKVCache)) else
          "q4_0" if isinstance(engine.cache, (Q4KVCache, PagedQ4KVCache)) else "bf16")
    paged = isinstance(engine.cache, (PagedKVCache, PagedQuantKVCache, PagedQ4KVCache))
    if paged and (own_layout or isinstance(engine.cache, PagedQ4KVCache)):
        # the same attention path: pages of the engine's size, nb a row
        nb, ps = engine.cache.tables.shape[1], engine.cache.page_size
        rows = {"dtype": engine.cache.k[0].dtype} if isinstance(engine.cache, PagedKVCache) else {}
        cache = type(engine.cache).create(cfg.n_layers, b * nb, b, nb, cfg.kv_cache_heads,
                                          cfg.kv_cache_dim, page_size=ps, device="cuda", **rows)
        for i in range(b):
            cache.set_table_row(i, np.arange(i * nb, (i + 1) * nb, dtype=np.int32))
        kv = f"paged {kv}"
    else:
        cache = make_kv_cache(cfg.n_layers, b, engine.cache.capacity, cfg.kv_cache_heads,
                              cfg.kv_cache_dim, kv, "cuda")
    kv = f"B={b} forward over a {kv} cache"
    n = len(prompt)
    t = engine._bucket(n) if as_engine else n
    toks = torch.zeros(b, t, dtype=torch.long)
    toks[:, :n] = torch.tensor(prompt)
    pos = torch.zeros(b, t, dtype=torch.int32)
    pos[:, :n] = torch.arange(n)
    logits = forward(engine.params, cfg, toks.to("cuda"), pos.to("cuda"), cache, 0)
    tok = int(logits[0, n - 1].argmax())
    with _record_moe([] if moe_log is None else moe_log):
        step = forward(engine.params, cfg, torch.full((b, 1), tok, device="cuda"),
                       torch.full((b, 1), n, dtype=torch.int32, device="cuda"), cache, n)
    return tok, step[0, 0].float().cpu().numpy(), kv


def _idle_slot_and_first_logits(engine, prompts, must=()) -> float:
    """Prefill `prompts` into three slots through the engine, then one
    batched decode step through `forward` at B=4 with the fourth slot idle
    (its write offset is the capacity). Fails unless the idle slot's rows are
    byte-identical afterwards, prompts[0]'s logits agree with
    `_reference_first_step`'s at the engine's width and layout, the step
    launched every kernel of `must`, and every kernel launch of the step is
    within its limit of its plain version on the same inputs
    (`_checking_kernels`). The B=1 reference over a contiguous cache is
    printed beside it, not gated (see `_reference_first_step`). Returns the
    relative diff."""
    import numpy as np
    import torch

    from llama_cpp_dsp_tpu_torch.models.llama import forward
    from llama_cpp_dsp_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from llama_cpp_dsp_tpu_torch.runtime.engine import Request
    from llama_cpp_dsp_tpu_torch.runtime.sampling import make_chain

    moe = engine.cfg.n_expert > 0
    ref_moe, eng_moe = [], []
    ref_token, ref_logits, kv = _reference_first_step(engine, list(prompts[0]), as_engine=moe,
                                                      moe_log=ref_moe)
    if moe:  # the same reference with the prompt prefilled at once (not gated)
        _, once, _ = _reference_first_step(engine, list(prompts[0]))
        print(f"  MoE reference prefilled at once instead of in the engine's padded chunk: "
              f"its first decode logits differ from the chunked one's by "
              f"{float(np.abs(once - ref_logits).max() / np.abs(ref_logits).max()):.3e}")
    reqs = [engine.submit(Request(0, list(p), max_new_tokens=1, sampler=make_chain(temp=0)))
            for p in prompts]
    while not all(r.done.is_set() for r in reqs):
        engine.step()
    where = {}
    for i, p in enumerate(prompts):
        where[i] = next(s.idx for s in engine.slots if s.cache_tokens == list(p))
    idle = next(i for i in range(engine.n_slots) if i not in where.values())
    b = engine.n_slots
    toks = torch.zeros(b, 1, dtype=torch.long)
    pos = torch.zeros(b, 1, dtype=torch.int32)
    for i, p in enumerate(prompts):
        toks[where[i], 0] = ref_token if i == 0 else reqs[i].result_tokens[0]
        pos[where[i], 0] = len(p)
    engine._ensure_pages([(where[i], len(p) + 1) for i, p in enumerate(prompts)])
    offs = pos[:, 0].clone()
    offs[idle] = engine.cache.capacity
    before = _slot_state(engine.cache, idle)
    reset_launches()
    checked = {}
    with _record_moe(eng_moe), _checking_kernels(checked):
        logits = forward(engine.params, engine.cfg, toks.to("cuda"), pos.to("cuda"),
                         engine.cache, offs.to("cuda"))[:, 0]
    torch.cuda.synchronize()
    launched = {k: v for k, v in LAUNCHES.items() if v}
    if must:
        require(launched, list(must), f"B={b} decode step")
    _report_checked(checked, launched, f"B={b} decode step")
    same = all(torch.equal(a, c) for a, c in zip(before, _slot_state(engine.cache, idle)))
    got = logits[where[0]].float().cpu().numpy()
    rel = float(np.abs(got - ref_logits).max() / np.abs(ref_logits).max())
    print(f"  idle slot {idle} byte-identical after a B={b} decode step: {same}; first decode "
          f"logits vs the prompt's own {kv}"
          f"{' (prefilled as the engine does)' if moe else ''}: max rel diff {rel:.3e} "
          f"({'MoE: gated layer by layer below' if moe else f'tol {LOGIT_RTOL:g}'}); "
          f"engine's own first token {reqs[0].result_tokens[0]} vs "
          f"{ref_token}")
    if not moe:  # other kernels or tilings than the step's (printed, not gated)
        tok1, logits1, kv1 = _reference_first_step(engine, list(prompts[0]), own_layout=False)
        print(f"  the same logits vs a {kv1}: " + (
            f"max rel diff {float(np.abs(got - logits1).max() / np.abs(logits1).max()):.3e} "
            f"(not gated)" if tok1 == ref_token else
            f"its prompt's argmax {tok1} differs from {ref_token} (not gated)"))
    if not same:
        fail("a batched decode step changed an idle slot's cache rows")
    if not np.isfinite(got).all():
        fail("first decode-step logits are not finite")
    if moe:
        _check_moe_layers(engine, ref_moe, eng_moe, where[0], rel)
    elif rel >= LOGIT_RTOL:
        fail("first decode-step logits disagree with the reference forward")
    # the same step again (it rewrites the same rows), profiled
    print(f"  B={b} decode step (three slots decoding, one idle):")
    profile_steps(lambda: forward(engine.params, engine.cfg, toks.to("cuda"), pos.to("cuda"),
                                  engine.cache, offs.to("cuda"))[:, 0].float().cpu(), 1)
    return rel


def _check_moe_layers(engine, ref_moe: list, eng_moe: list, row: int, rel: float) -> None:
    """The MoE engine's batched decode step against the reference, layer
    by layer. The logits are not gated: a random 32-layer MoE is chaotic,
    so the last-bit differences between a batched and a B=1 step (another
    FMA contraction in the K-quant GEMV, another cuBLAS kernel for the
    router) grow through the layers and flip routers. Gated instead: every
    layer's output for `row`, rerun at B=1 on the engine's own input row
    (B9 at S=2 against S=8), and the first layer's input (the embedding and
    the batched attention against the B=1 path)."""
    from llama_cpp_dsp_tpu_torch.models.llama import ffn_moe

    layer_rel = [_rel(ffn_moe(x[row:row + 1], layer, engine.cfg)[0], out[row])
                 for x, out, layer in eng_moe]
    drift = [_rel(x[row], rx[0]) for (x, _, _), (rx, _, _) in zip(eng_moe, ref_moe)]
    print(f"  MoE layers of the B={engine.n_slots} step rerun at B=1 on the same input row: "
          f"worst rel diff {max(layer_rel):.3e} over {len(layer_rel)} layers (tol "
          f"{MOE_LAYER_RTOL:g}); FFN input against the reference's, layers 0, 4, 8, ...: "
          f"{' '.join(f'{d:.1e}' for d in drift[::4])} (layer 0 tol {MOE_LAYER_RTOL:g}); "
          f"the logits' {rel:.3e} is that drift at the end (not gated)")
    n_moe = sum("ffn_gate_exps" in layer for layer in engine.params["layers"])
    if not (len(layer_rel) == n_moe and max(layer_rel) < MOE_LAYER_RTOL):
        fail("an MoE layer of the batched decode step disagrees with its B=1 rerun")
    if not drift[0] < MOE_LAYER_RTOL:
        fail("the batched decode step's first layer disagrees with the reference")


def _cache_bytes(cache) -> int:
    """Bytes of every buffer a cache holds (block tables included)."""
    import torch

    bufs = []
    for v in vars(cache).values():
        if torch.is_tensor(v):
            bufs.append(v)
        elif isinstance(v, list):
            bufs += [t for t in v if torch.is_tensor(t)]
        elif isinstance(v, dict):
            bufs += [t for ts in v.values() for t in ts]
    return sum(t.numel() * t.element_size() for t in bufs)


def _slot_save_restore(engine, base: str) -> None:
    """Through the server's /slots endpoints: save the slot holding the most
    rows, restore the file into another slot, then run one greedy request
    that starts with the saved tokens on each of the two (the first lands
    on the lower slot id; that slot is then erased, so the second lands on
    the other) and fail unless both continue alike from the cached rows."""
    from llama_cpp_dsp_tpu_torch.runtime.engine import Request
    from llama_cpp_dsp_tpu_torch.runtime.sampling import make_chain

    src = max(engine.slots, key=lambda s: len(s.cache_tokens))
    dst = next(s for s in engine.slots if s is not src)
    tokens = list(src.cache_tokens)
    saved = _post(base, f"/slots/{src.idx}?action=save", {"filename": "smoke-slot.bin"})["body"]
    restored = _post(base, f"/slots/{dst.idx}?action=restore",
                     {"filename": "../smoke-slot.bin"})["body"]  # the basename is kept
    print(f"    slot save {saved}, restore {restored}")
    if not (saved["n_saved"] == restored["n_restored"] == len(tokens)
            and dst.cache_tokens == tokens):
        fail("slot restore did not bring back the saved rows and tokens")
    prompt = tokens + [tokens[-1]]
    outs, where = [], []
    for _ in range(2):
        cached = engine.metrics.get("prompt_tokens_cached", 0)
        req = engine.submit(Request(0, list(prompt), max_new_tokens=16,
                                    sampler=make_chain(temp=0)))
        req.done.wait()
        slot = next(s for s in engine.slots if s.cache_tokens[:len(prompt)] == prompt)
        outs.append(req.result_tokens)
        where.append(slot.idx)
        if req.error or engine.metrics["prompt_tokens_cached"] - cached != len(tokens):
            fail(f"slot {slot.idx}: the request did not reuse the {len(tokens)} restored rows "
                 f"({req.error})")
        _post(base, f"/slots/{slot.idx}?action=erase", {})
    print(f"    greedy continuations of {len(tokens)} cached tokens from slots {where}: "
          f"equal {outs[0] == outs[1]} ({outs[0]})")
    if sorted(where) != sorted((src.idx, dst.idx)) or outs[0] != outs[1]:
        fail("the restored slot does not continue as the saved one")


def phase_serve(records: dict, path: Path, model, configs=SERVE_CONFIGS, n_ctx: int = 1024,
                system_repeat: int = 7, step_must=(), slot_io: bool = False) -> None:
    """The port's server in-process over each engine configuration: four
    concurrent requests through HTTP, two sharing a system prompt, the
    second of those sent once the first has decoded its first token (a
    mixed prompt+decode step, except on an MLA model, whose engine prefills
    per slot; a cached prefix). Chat requests go through the
    GGUF's chat template (none: chatml). slot_io: then a slot save and
    restore through /slots (`_slot_save_restore`)."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    from llama_cpp_dsp_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from llama_cpp_dsp_tpu_torch.serve.server import build, build_arg_parser

    rng = np.random.default_rng(7)
    tok = model.tokenizer
    system = "You answer questions about the sky. " * system_repeat  # a shared system prompt
    n_system = len(tok.encode(system, add_special=False))
    # the prefix a later request reuses: the whole prompt (slots) or its full
    # 128-row pages (paged)
    min_cached = max(128, n_system // 128 * 128)
    chats = [{"messages": [{"role": "system", "content": system},
                           {"role": "user", "content": q}]}
             for q in ("Why is the sky blue?", "What makes sunsets red and orange?")]
    prompt_20 = "Tell me a short story"
    prompt_90 = ("The quick brown fox jumps over the lazy dog near the river bank, "
                 "then rests a while.")
    print(f"  prompt tokens: completions {len(tok.encode(prompt_20, add_special=True))}, "
          f"{len(tok.encode(prompt_90, add_special=True))}; chats about "
          f"{len(tok.encode(system, add_special=True)) + 40} each")
    decode_prompts = [[int(t) for t in rng.integers(300, model.cfg.n_vocab, n)]
                      for n in (20, 45, 70)]
    texts, summary = {}, {}
    for name, (flags, must) in configs.items():
        argv = ["-m", str(path), "--port", "0", "-np", "4", "-c", str(n_ctx), "--api-key",
                "smoke", *flags]
        if slot_io:
            (ROOT / "build" / "smoke" / "slots").mkdir(parents=True, exist_ok=True)
            argv += ["--slot-save-path", str(ROOT / "build" / "smoke" / "slots")]
        args = build_arg_parser().parse_args(argv)
        engine, _, httpd = build(args, model)
        mixed = []  # decoding slots carried by each packed prompt+decode step
        inner = engine._mixed_step
        engine._mixed_step = lambda gen, inner=inner, mixed=mixed: (mixed.append(len(gen)),
                                                                    inner(gen))[1]
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        print(f"  [{name}] server {' '.join(argv[2:])} on {base}", flush=True)
        n = SERVE_N_PREDICT
        jobs = [("/v1/chat/completions", {**chats[0], "max_tokens": n, "temperature": 0,
                                          "stream": True}),
                ("/completion", {"prompt": prompt_20, "n_predict": n, "temperature": 0}),
                ("/completion", {"prompt": prompt_90, "n_predict": n, "temperature": 0,
                                 "stream": True})]
        late = ("/v1/chat/completions", {**chats[1], "max_tokens": n, "temperature": 0})
        try:
            reset_launches()
            engine.start()
            t0 = time.perf_counter()
            with ThreadPoolExecutor(4) as ex:
                late_future = []
                first = lambda: late_future.append(ex.submit(_post, base, *late))  # noqa: E731
                futures = [ex.submit(_post, base, *jobs[0], on_first=first)]
                futures += [ex.submit(_post, base, *j) for j in jobs[1:]]
                replies = [f.result() for f in futures]
                replies.insert(1, late_future[0].result())
            wall = time.perf_counter() - t0
            torch.cuda.synchronize()
            counts = dict(LAUNCHES)
            m = dict(engine.metrics)  # the burst's, before any slot save / restore
            if slot_io:
                _slot_save_restore(engine, base)
        finally:
            engine.stop()
            httpd.shutdown()
            httpd.server_close()
        checked = [_check_reply(r) for r in replies]
        n_tok = sum(c[0] for c in checked)
        ttft = []
        for r in replies:
            if r["stream"]:
                ttft.append(f"{r['first_s'] * 1e3:.1f} (client, stream)")
            else:
                ttft.append(f"{r['body']['timings']['prompt_ms']:.1f}")
        shapes = [(r["path"], "stream" if r["stream"] else "json", c[0], c[1])
                  for r, c in zip(replies, checked)]
        print(f"    replies (path, form, tokens, stop reason): {shapes}")
        print(f"    {n_tok} tokens in {wall:.3f} s: {n_tok / wall:.2f} tokens/s aggregate; time to "
              f"first token ms {ttft}; metrics {m}")
        require(counts, must, f"serve {name}")
        print(f"    packed prompt+decode steps: {len(mixed)}, decoding slots in them {mixed}")
        if engine._mixed_ok and not any(mixed):
            fail(f"serve {name}: no mixed prompt+decode step carried a decoding slot")
        if not engine._mixed_ok and mixed:  # MLA prefills per slot, as JAX's engine
            fail(f"serve {name}: an MLA engine took a packed prompt+decode step")
        if m["n_errors"]:
            fail(f"serve {name}: the engine counted {m['n_errors']} errors")
        if not m.get("prompt_tokens_cached", 0) >= min_cached:
            fail(f"serve {name}: the shared {n_system}-token system prompt was not reused "
                 f"from the cache")
        for k in must:  # a kernel's count comes from the first path that runs it
            records[k]["launches"] = records[k]["launches"] or counts[k]
        texts[name] = [c[2] for c in checked]
        summary[name] = {"tokens_per_s": n_tok / wall, "ttft_ms": ttft,
                         "cached": m["prompt_tokens_cached"], "launches": counts,
                         "kv_cache_bytes": _cache_bytes(engine.cache),
                         "device_bytes_in_use": torch.cuda.memory_allocated()}
        _idle_slot_and_first_logits(engine, decode_prompts, step_must)
        del engine
        torch.cuda.empty_cache()
    for name, t in texts.items():
        same = [a == b for a, b in zip(t, texts[next(iter(texts))])]
        print(f"  [{name}] replies equal to {next(iter(texts))}'s: {same}")
    print(f"  serve summary: {json.dumps(summary)}")
    return summary


def _cli_step(records: dict, path: Path, model, label: str, must: list[str], own: list[str]):
    """A full-width model through the CLI (`-c 512 -p hello -n 32`) on the
    loaded model, then, on a LlamaContext of it, the launches of one decode
    step by kernel, a 32-token greedy stream and a profiled 8-step chunk
    (three chunks: warm-up, timed, profiled) with its launches per token.
    Fails unless the CLI launched every kernel of `must`; the launches of
    `own` are this CLI's. Returns the context, the step's launches and the
    CLI's."""
    import torch

    from llama_cpp_dsp_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from llama_cpp_dsp_tpu_torch.runtime.context import LlamaContext
    from llama_cpp_dsp_tpu_torch.runtime.sampling import make_chain

    reset_launches()
    _, err = run_cli(["-m", str(path), "-p", "hello", "-n", "32", "--temp", "0", "-c", "512"],
                     model)
    counts = dict(LAUNCHES)
    require(counts, must, f"{label} CLI")
    for k in own:
        records[k]["launches"] = counts[k]
    print(f"  {label} CLI: {decode_tps(err):.2f} tokens/s decode")
    prompt = model.tokenizer.encode("hello")
    ctx = LlamaContext(model, n_ctx=512)
    first = int(ctx.eval_tokens(prompt).argmax())
    reset_launches()
    ctx.eval_tokens([first])
    torch.cuda.synchronize()
    step = {k: v for k, v in LAUNCHES.items() if v}
    print(f"  launches of one decode step: {step}")
    stream = list(ctx.generate(prompt, max_new_tokens=32, sampler=make_chain(temp=0)))
    print(f"  decode step at context {ctx.n_past}:")
    reset_launches()
    profile_chunk(ctx, stream[-1])
    print(f"    port kernel launches per token: "
          f"{ {k: v / 24 for k, v in LAUNCHES.items() if v} }")
    return ctx, step, counts


SERVE_CONFIGS_L3 = {  # name → (server flags, kernels its decode must launch)
    "slots bf16": ([], ["flash_decode", "qmm_q4_k", "qmm_q6_k"]),
    "paged q8_0": (["--kv-layout", "paged", "-ctk", "q8_0"],
                   ["flash_decode_paged_q8", "qmm_q4_k", "qmm_q6_k"]),
}


def phase_llama3(records: dict, path: Path, model) -> None:
    """Llama-3-8B Q4_K_M at full width and depth: the CLI, the launches of
    one decode step by kernel, a profiled 8-step chunk and a profiled
    512-token prefill, then the server in two configurations (B7 at Hkv 8 in
    paged q8_0) through the llama3 chat template."""
    import torch

    ctx, _, _ = _cli_step(records, path, model, "Llama-3-8B Q4_K_M",
                          ["qmm_q4_k", "qmm_q6_k", "flash_decode", "flash_prefill"],
                          ["qmm_q4_k", "qmm_q6_k"])
    _profile_prefill_512(ctx, model)
    del ctx
    torch.cuda.empty_cache()
    phase_serve(records, path, model, SERVE_CONFIGS_L3, n_ctx=2048, system_repeat=16)


def _profile_prefill_512(ctx, model) -> None:
    """A prefill at a llama-3 prompt length: one call of 512 tokens (the
    tiled qmm, B4), profiled."""
    long = model.tokenizer.encode("The quick brown fox jumps over the lazy dog. " * 80)[:512]

    def prefill():
        ctx.n_past = 0
        ctx.eval_tokens(long)

    print(f"  prefill of {len(long)} tokens in one call:")
    profile_steps(prefill, 1)


SERVE_CONFIGS_KV8B = {  # name → (server flags, kernels its decode must launch)
    "slots q4_0": (["-ctk", "q4_0"], ["flash_decode_q4", "qmm_q4_k", "qmm_q6_k"]),
    "paged q4_0": (["--kv-layout", "paged", "-ctk", "q4_0"],
                   ["flash_decode", "qmm_q4_k", "qmm_q6_k"]),
}
KV_TYPES = ("bf16", "f16", "f32", "q8_0", "q4_0", "q4_1", "q5_0", "q5_1", "iq4_nl")


@contextlib.contextmanager
def _swap_kernel(name: str, fn):
    """The attention wrapper `name` is `fn(kernel)` inside the block (`fn`
    wraps the kernel's wrapper or replaces it)."""
    from llama_cpp_dsp_tpu_torch.ops.kernels import attention as ka

    kernel = getattr(ka, name)
    setattr(ka, name, fn(kernel))
    try:
        yield
    finally:
        setattr(ka, name, kernel)


def _new_row_codes(cache, n: int) -> list:
    """The Q4_0 codes of row n in every layer's K then V plane, each
    [B, Hkv, D]."""
    from llama_cpp_dsp_tpu_torch.quant.kv_planes import q4_unpack_rows

    return [q4_unpack_rows(qs[:, :, n // 2:n // 2 + 1])[:, :, n % 2].clone()
            for qs in (*cache.k_qs, *cache.v_qs)]


def _amplifier_witness(model, prompt: list, q4_codes: tuple) -> None:
    """What grows B8's last-bit differences into the 8B's logits (printed,
    not gated). q4_codes: the new row's codes after the -ctk q4_0 step with
    B8 and after the step with its plain version (`_new_row_codes`): a code
    that differs is a K/V value re-quantized a whole Q4 step apart. Then the
    same pair of steps over a bf16 cache, where nothing is re-quantized: B2
    against flash_decode_plain in every layer."""
    import numpy as np
    import torch

    from llama_cpp_dsp_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from llama_cpp_dsp_tpu_torch.ops.kernels import attention as ka
    from llama_cpp_dsp_tpu_torch.runtime.context import LlamaContext

    n_layers = model.cfg.n_layers
    a, b = q4_codes
    per_layer = [int((x != y).sum()) + int((xv != yv).sum()) for x, y, xv, yv in
                 zip(a[:n_layers], b[:n_layers], a[n_layers:], b[n_layers:])]
    step_size = max(int((x - y).abs().max()) for x, y in zip(a, b))
    hit = [i for i, c in enumerate(per_layer) if c]
    print(f"  the new K/V row's Q4 codes, B8 step against plain step: {sum(per_layer)} of "
          f"{sum(x.numel() for x in a)} differ, in {len(hit)} of {n_layers} layers (first "
          f"{hit[0] if hit else None}; layer 0, whose input is the same, {per_layer[0]}), "
          f"largest difference {step_size} code(s)")
    ctx = LlamaContext(model, n_ctx=512)  # a bf16 cache
    tok = int(ctx.eval_tokens(prompt).argmax())
    reset_launches()
    step = ctx.eval_tokens([tok])
    n_b2 = LAUNCHES["flash_decode"]
    ctx.rollback_to(ctx.n_past - 1)
    with _swap_kernel("flash_decode", lambda kernel: ka.flash_decode_plain):
        ref = ctx.eval_tokens([tok])
    rel = float(np.abs(step - ref).max() / np.abs(ref).max())
    print(f"  the same step over a bf16 cache (no re-quantization): B2 ({n_b2} launches) "
          f"against flash_decode_plain in every layer: max rel diff {rel:.3e}; same argmax "
          f"{int(step.argmax()) == int(ref.argmax())}")
    if n_b2 != n_layers:
        fail(f"a bf16 decode step launched B2 {n_b2} times, not {n_layers}")
    del ctx
    torch.cuda.empty_cache()


def _recording(calls: list):
    """A decode attention wrapper (flash_decode_q4, flash_decode_paged_q8)
    that records each call's q, other arguments and output. The cache planes
    it reads are the layers' own buffers, which the rest of the step leaves
    as they were."""
    def wrap(kernel):
        def run(q, *args, **kw):
            out = kernel(q, *args, **kw)
            calls.append((q.clone(), args, kw, out.clone()))
            return out
        return run
    return wrap


@contextlib.contextmanager
def _checking_kernels(checked: dict):
    """Inside the block every kernel wrapper that a decode step can launch
    (B1, B9, B2, B3, B5-B8, B10) runs its plain version on the same inputs
    after the kernel, and checked[counter] collects each call's worst
    per-slot (attention) or per-row (GEMV) NMSE beside its limit: the
    engine's own step, kernel by kernel, at each kernel's limit. B3 writes
    the new K/V row into the cache it reads: its plain version runs on
    copies taken before the call, and its written rows are held too. B3's
    plain version is held with the kernel's weight arithmetic (exact f32
    dequantized q|k|v weights, as B1's checks also hold it): with the
    plain version's bf16-rounded weights a real step's peaked softmax
    grows that rounding past the limit (8.0e-5 on the 7B; printed beside
    it, not gated)."""
    import torch

    from llama_cpp_dsp_tpu_torch.ops.kernels import attention as ka
    from llama_cpp_dsp_tpu_torch.ops.kernels import attn_fused as af
    from llama_cpp_dsp_tpu_torch.ops.kernels import qmm as kq
    from llama_cpp_dsp_tpu_torch.quant.dequant import dequant

    def note(name, tol, errs):
        checked.setdefault(name, ([], tol))[0].append(max(errs))

    def exact(x, w):  # B1's and B3's weight arithmetic
        return x.to(torch.bfloat16).float() @ dequant(w, torch.float32).T

    def attention(name, plain, tol):
        def wrap(kernel):
            def run(*args, **kw):
                out = kernel(*args, **kw)
                note(name, tol, slot_nmse(out, plain(*args, **kw)))
                return out
            return run
        return wrap

    def fused(kernel):
        def run(x, w, k_cache, v_cache, *rest, **kw):
            refs = [(k_cache.clone(), v_cache.clone()) for _ in range(2)]
            out = kernel(x, w, k_cache, v_cache, *rest, **kw)
            wp = rest[4]
            rows = [i for i in range(x.shape[0]) if 0 <= int(wp[i]) < k_cache.shape[2]]
            for (k_ref, v_ref), name, tol in zip(refs, ("attn_fused", "attn_fused, bf16 weights"),
                                                 (FUSED_NMSE_TOL, None)):
                rounded = af.qmm_plain
                if tol is not None:
                    af.qmm_plain = exact
                try:
                    want = af.attn_fused_plain(x, w, k_ref, v_ref, *rest, **kw)
                finally:
                    af.qmm_plain = rounded
                note(name, tol, slot_nmse(out, want) + [
                    nmse(c[i, :, int(wp[i])], r[i, :, int(wp[i])])
                    for i in rows for c, r in ((k_cache, k_ref), (v_cache, v_ref))])
            return out
        return run

    def gemv(kernel):
        def run(x, w):
            out = kernel(x, w)
            n = out.shape[-1]
            note(kq._counter(w.kind), QMM_NMSE_TOL,
                 slot_nmse(out.reshape(-1, n), kq.qmm_plain(x, w).reshape(-1, n)))
            return out
        return run

    def experts(kernel):
        def run(x, w, sel):
            out = kernel(x, w, sel)
            note(kq._counter(w.kind, experts=True), QMM_NMSE_TOL,
                 slot_nmse(out, kq.qmm_expert_rows_plain(x, w, sel)))
            return out
        return run

    swaps = [(ka, name, attention(name, getattr(ka, f"{name}_plain"), FLASH_NMSE_TOL))
             for name in ("flash_decode", "flash_decode_q8", "flash_decode_q4",
                          "flash_decode_paged", "flash_decode_paged_q8")]
    swaps += [(ka, "mla_flash_decode", attention("mla_decode", ka.mla_flash_decode_plain,
                                                 MLA_NMSE_TOL)),
              (af, "attn_decode_fused", fused), (kq, "qmm", gemv),
              (kq, "qmm_expert_rows", experts)]
    kept = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, wrap in swaps:
        setattr(mod, name, wrap(getattr(mod, name)))
    try:
        yield checked
    finally:
        for mod, name, kernel in kept:
            setattr(mod, name, kernel)


def _report_checked(checked: dict, launched: dict, label: str) -> None:
    """Print `_checking_kernels`' results; fail unless every launch of the
    step was checked and each is within its limit."""
    for name, (errs, tol) in sorted(checked.items()):
        print(f"  {label}: {name}, {len(errs)} calls against the plain version on the same "
              f"inputs: worst NMSE {max(errs):.1e} "
              + ("(not gated)" if tol is None else f"(tol {tol:g})"))
    unchecked = {k: v for k, v in launched.items() if len(checked.get(k, ((), 0))[0]) != v}
    if unchecked:
        fail(f"{label}: launches not held against a plain version: {unchecked}")
    bad = [name for name, (errs, tol) in checked.items()
           if tol is not None and not (max(errs) <= tol and all(e == e for e in errs))]
    if bad:
        fail(f"{label}: {', '.join(bad)} disagree with their plain versions")


def phase_kv8b(records: dict, path: Path, model) -> None:
    """The KV cache types on Llama-3-8B Q4_K_M (the `llama3` phase's model):
    the CLI with -ctk q4_0 (B8 in every layer of every decode step; the
    first decode step's logits against the same step with B8's plain
    version in every layer, over the same cache), the CLI with -ctk q8_0
    -ctv q4_0 (B2 over the dequantized planes), the cache's bytes per token
    for every type, then a four-slot server burst over Q4_0 slots and Q4_0
    pages, each with a slot save and restore through /slots."""
    import numpy as np
    import torch

    from llama_cpp_dsp_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from llama_cpp_dsp_tpu_torch.ops.kernels import attention as ka
    from llama_cpp_dsp_tpu_torch.runtime.context import LlamaContext
    from llama_cpp_dsp_tpu_torch.runtime.kv_cache import make_kv_cache
    from llama_cpp_dsp_tpu_torch.runtime.sampling import make_chain

    cfg = model.cfg
    reset_launches()
    _, err = run_cli(["-m", str(path), "-ctk", "q4_0", "-c", "512", "-p", "hello", "-n", "32",
                      "--temp", "0"], model)
    counts = dict(LAUNCHES)
    require(counts, ["flash_decode_q4", "qmm_q4_k", "qmm_q6_k"], "kv8b CLI -ctk q4_0")
    if counts["flash_decode_q4"] % cfg.n_layers:
        fail(f"B8 launched {counts['flash_decode_q4']} times: not {cfg.n_layers} a token")
    records["flash_decode_q4"]["launches"] = counts["flash_decode_q4"]
    print(f"  Llama-3-8B Q4_K_M CLI -ctk q4_0: {decode_tps(err):.2f} tokens/s decode, "
          f"B8 {counts['flash_decode_q4']} launches = {cfg.n_layers} x "
          f"{counts['flash_decode_q4'] // cfg.n_layers} decode steps")
    ctx = LlamaContext(model, n_ctx=512, kv_dtype="q4_0")
    prompt = model.tokenizer.encode("hello")
    tok = int(ctx.eval_tokens(prompt).argmax())
    reset_launches()
    calls = []
    with _swap_kernel("flash_decode_q4", _recording(calls)):
        step = ctx.eval_tokens([tok])
    torch.cuda.synchronize()
    codes_b8 = _new_row_codes(ctx.cache, ctx.n_past - 1)
    n_b8 = LAUNCHES["flash_decode_q4"]
    # each layer's B8 call against its plain version on the same inputs
    layer_nmse = [max(slot_nmse(out, ka.flash_decode_q4_plain(q, *args, **kw)))
                  for q, args, kw, out in calls]
    ctx.rollback_to(ctx.n_past - 1)  # the same step again, B8's plain version in every layer
    with _swap_kernel("flash_decode_q4", lambda kernel: ka.flash_decode_q4_plain):
        ref = ctx.eval_tokens([tok])
    codes_plain = _new_row_codes(ctx.cache, ctx.n_past - 1)
    rel = float(np.abs(step - ref).max() / np.abs(ref).max())
    print(f"  one decode step: B8 launched {n_b8} times ({cfg.n_layers} layers); each layer's "
          f"B8 output against its plain version on the same inputs: worst per-slot NMSE "
          f"{max(layer_nmse):.1e} (tol {FLASH_NMSE_TOL:g}); the step's logits against the step "
          f"with flash_decode_q4_plain in every layer: max rel diff {rel:.3e} (not gated: what grows "
          f"the kernels' last-bit differences is printed below); same argmax {int(step.argmax()) == int(ref.argmax())}; finite "
          f"{bool(np.isfinite(step).all())}")
    if n_b8 != cfg.n_layers or len(calls) != cfg.n_layers:
        fail(f"a -ctk q4_0 decode step launched B8 {n_b8} times, not {cfg.n_layers}")
    if not (max(layer_nmse) <= FLASH_NMSE_TOL and np.isfinite(step).all()):
        fail("B8 on the -ctk q4_0 decode step disagrees with its plain version")
    stream = list(ctx.generate(prompt, max_new_tokens=16, sampler=make_chain(temp=0)))
    print(f"  -ctk q4_0 decode step at context {ctx.n_past}:")
    profile_chunk(ctx, stream[-1])
    del ctx
    _amplifier_witness(model, prompt, (codes_b8, codes_plain))
    reset_launches()
    _, err = run_cli(["-m", str(path), "-ctk", "q8_0", "-ctv", "q4_0", "-c", "512", "-p",
                      "hello", "-n", "16", "--temp", "0"], model)
    require(dict(LAUNCHES), ["flash_decode", "qmm_q4_k"], "kv8b CLI -ctk q8_0 -ctv q4_0")
    print(f"  Llama-3-8B Q4_K_M CLI -ctk q8_0 -ctv q4_0: {decode_tps(err):.2f} tokens/s decode")
    per_token = {}
    for t in KV_TYPES:
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        cache = make_kv_cache(cfg.n_layers, 1, 512, cfg.kv_cache_heads, cfg.kv_cache_dim, t,
                              "cuda")
        per_token[t] = (_cache_bytes(cache) // 512, (torch.cuda.memory_allocated() - base) // 512)
        del cache
    print(f"  KV cache bytes per token at the 8B (buffers, device memory): {per_token}")
    if per_token["bf16"][0] != 131072 or per_token["q8_0"][0] != 67584 \
            or per_token["q4_0"][0] != 40960:
        fail(f"cache bytes per token {per_token}")
    phase_serve(records, path, model, SERVE_CONFIGS_KV8B, n_ctx=2048, system_repeat=16,
                slot_io=True)


def phase_q5km(records: dict, path: Path) -> None:
    from llama_cpp_dsp_tpu_torch.ops.kernels import LAUNCHES, reset_launches

    reset_launches()
    _, err = run_cli(["-m", str(path), "-p", "hello", "-n", "16", "--temp", "0", "-c", "256"])
    counts = dict(LAUNCHES)
    require(counts, ["qmm_q5_k", "qmm_q6_k", "flash_decode", "flash_prefill"], "q5km")
    records["qmm_q5_k"]["launches"] = counts["qmm_q5_k"]
    print(f"  Llama-3-8B Q5_K_M CLI: {decode_tps(err):.2f} tokens/s decode")


SMALL_MOE_MIXES = {  # ftype → the selected-expert kernels its path runs
    "Q4_K_M": ["qmm_experts_q4_k", "qmm_experts_q6_k"],
    "Q5_K_M": ["qmm_experts_q5_k", "qmm_experts_q6_k"],
    "Q4_0": ["qmm_experts_q4_0"],
    "Q8_0": ["qmm_experts_q8_0"],
}


def phase_small_moe(records: dict) -> None:
    """A 2-layer Mixtral-shaped model (8 experts, top-2, GQA, head_dim 128)
    at width 256 in four mixes. The 35-token prompt is one 32-token chunk
    (b·t·u = 64 > 8: every expert over every row) and a 3-token one (6 ≤ 8:
    the selected-expert kernel), decode the kernel; card against CPU."""
    from llama_cpp_dsp_tpu_torch.models.llama import LlamaConfig
    from llama_cpp_dsp_tpu_torch.ops.rope import RopeParams
    from llama_cpp_dsp_tpu_torch.tools.synth import write_synth_gguf

    cfg = LlamaConfig(arch="llama", n_layers=2, n_embd=256, n_heads=2, n_kv_heads=1,
                      head_dim=128, n_ff=512, n_vocab=512, n_ctx_train=256,
                      rope=RopeParams(n_dims=128, freq_base=1e6), n_expert=8, n_expert_used=2)
    for ftype, must in SMALL_MOE_MIXES.items():
        path = ROOT / "build" / "smoke" / f"small-moe-{ftype.lower()}.gguf"
        path.parent.mkdir(parents=True, exist_ok=True)
        write_synth_gguf(str(path), cfg, ftype, seed=5)
        counts = small_model_check(path, "The quick brown fox jumps over it.",
                                   [*must, "flash_prefill"], f"small_moe {ftype}")
        for k in must:  # a kernel's count comes from the first path that runs it
            records[k]["launches"] = records[k]["launches"] or counts[k]


MIXTRAL_B9 = ["qmm_experts_q4_k", "qmm_experts_q6_k"]
SERVE_CONFIGS_MX = {"slots bf16": ([], ["flash_decode", *MIXTRAL_B9])}


def phase_mixtral(records: dict, path: Path, model) -> None:
    """Mixtral-8x7B Q4_K_M at full width and depth: the CLI on the loaded
    model, the launches of one decode step by kernel (96 selected-expert
    GEMVs: gate, up and down in 32 layers), a profiled 8-step chunk and a
    profiled 512-token prefill (every expert over every row), then a
    four-slot server burst with chats through the Mixtral-Instruct
    template, whose B=4 decode step runs the kernel (b·t·u = 8 ≤ 8)."""
    import torch

    from llama_cpp_dsp_tpu_torch.serve.chat import apply_chat_template

    ctx, step, _ = _cli_step(records, path, model, "Mixtral-8x7B Q4_K_M",
                             [*MIXTRAL_B9, "qmm_q4_k", "qmm_q5_k", "qmm_q6_k", "qmm_q8_0",
                              "flash_decode", "flash_prefill"], MIXTRAL_B9)
    n_b9 = sum(v for k, v in step.items() if k.startswith("qmm_experts_"))
    print(f"  selected-expert GEMVs of one decode step: {n_b9}")
    if n_b9 != 3 * model.cfg.n_layers:
        fail(f"one Mixtral decode step launched {n_b9} selected-expert GEMVs, "
             f"not {3 * model.cfg.n_layers}")
    long = model.tokenizer.encode("The quick brown fox jumps over the lazy dog. " * 12)[:512]

    def prefill():
        ctx.n_past = 0
        ctx.eval_tokens(long)

    print(f"  prefill of {len(long)} tokens in one call:")
    profile_steps(prefill, 1)
    del ctx
    torch.cuda.empty_cache()
    chat = apply_chat_template(model.vocab.chat_template,
                               [{"role": "system", "content": "Be brief."},
                                {"role": "user", "content": "Hi"}])
    print(f"  the GGUF's chat template renders a system+user chat as {chat!r}")
    if not chat.startswith("[INST]"):
        fail("the Mixtral-Instruct template did not render through the [INST] family")
    phase_serve(records, path, model, SERVE_CONFIGS_MX, n_ctx=2048, system_repeat=16,
                step_must=MIXTRAL_B9)


def _small_ds_config():
    """A 3-layer, 256-wide DeepSeek-V2 with DeepSeek-V2-Lite's MLA widths
    (16 heads, kv_lora_rank 512, rope 64, nope 128, v 128: the kernel's real
    C = 640, r = 512), layer 0 dense, 8 experts top-3 of width 352 (K % 256
    != 0: the fallback kinds), one shared expert, vocab 2048."""
    import dataclasses

    from llama_cpp_dsp_tpu_torch.tools.synth import DEEPSEEK_V2_LITE

    return dataclasses.replace(DEEPSEEK_V2_LITE, n_layers=3, n_embd=256, n_ff=512,
                               n_vocab=2048, n_ctx_train=4096, n_expert=8, n_expert_used=3)


SMALL_DS_EXPERTS = (352, 1)  # routed expert width, shared experts
SMALL_DS_MIXES = {  # ftype → the kernels its path runs
    "Q4_K_M": ["mla_decode", "qmm_experts_q4_k", "qmm_experts_q5_0", "qmm_experts_q8_0",
               "qmm_q4_k", "qmm_q5_k", "qmm_q6_k", "qmm_q5_0", "qmm_q8_0"],
    "Q5_K_M": ["mla_decode", "qmm_experts_q5_k", "qmm_experts_q5_1", "qmm_experts_q8_0",
               "qmm_q5_k", "qmm_q6_k", "qmm_q5_1", "qmm_q8_0"],
    "Q4_1": ["mla_decode", "qmm_experts_q4_1", "qmm_q4_1"],
}


def phase_small_ds(records: dict) -> None:
    """`_small_ds_config` at Q4_K_M, Q5_K_M and Q4_1 with a deepseek-llm
    vocab: a ~30-token prefill (MLA's plain path, every expert over every
    row through the tiled qmm), then decode (B10, the selected-expert
    kernel, the GEMVs); card against CPU."""
    from llama_cpp_dsp_tpu_torch.tools.synth import write_synth_gguf

    cfg = _small_ds_config()
    for ftype, must in SMALL_DS_MIXES.items():
        path = ROOT / "build" / "smoke" / f"small-ds-{ftype.lower()}.gguf"
        path.parent.mkdir(parents=True, exist_ok=True)
        write_synth_gguf(str(path), cfg, ftype, seed=6, vocab="deepseek-llm",
                         experts=SMALL_DS_EXPERTS)
        counts = small_model_check(
            path, "The quick brown fox jumps over the lazy dog, then rests a while.", must,
            f"small_ds {ftype}")
        for k in must:  # a kernel's count comes from the first path that runs it
            records[k]["launches"] = records[k]["launches"] or counts[k]


DS_B9 = ["qmm_experts_q4_k", "qmm_experts_q5_0", "qmm_experts_q8_0"]
SERVE_CONFIGS_DS = {"slots bf16": ([], ["mla_decode", *DS_B9])}


def phase_deepseek(records: dict, path: Path, model) -> None:
    """DeepSeek-V2-Lite Q4_K_M at full width and depth: the CLI on the loaded
    model, the launches of one decode step by kernel (27 B10, 78 B9: gate,
    up and down in 26 MoE layers), a profiled 8-step chunk, a profiled
    512-token prefill (every expert over every row; the Q5_0 expert
    matrices through the tiled qmm), then a four-slot server burst with
    chats through the deepseek2 template, whose B=4 decode step runs B9 at
    S = 24 and B10 at B = 4."""
    import torch

    from llama_cpp_dsp_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from llama_cpp_dsp_tpu_torch.serve.chat import apply_chat_template

    cfg = model.cfg
    n_moe = sum("ffn_gate_exps" in layer for layer in model.params["layers"])
    ctx, step, _ = _cli_step(records, path, model, "DeepSeek-V2-Lite Q4_K_M",
                             ["mla_decode", *DS_B9, "qmm_q4_k", "qmm_q6_k", "qmm_q8_0"],
                             ["mla_decode", "qmm_experts_q5_0"])
    n_b9 = sum(v for k, v in step.items() if k.startswith("qmm_experts_"))
    print(f"  one decode step: B10 {step.get('mla_decode', 0)}, selected-expert GEMVs {n_b9} "
          f"({n_moe} MoE layers)")
    if step.get("mla_decode", 0) != cfg.n_layers or n_b9 != 3 * n_moe:
        fail(f"one DeepSeek decode step launched B10 {step.get('mla_decode', 0)} times and B9 "
             f"{n_b9} times, not {cfg.n_layers} and {3 * n_moe}")
    long = model.tokenizer.encode("The quick brown fox jumps over the lazy dog. " * 80)[:512]

    def prefill():
        ctx.n_past = 0
        ctx.eval_tokens(long)

    print(f"  prefill of {len(long)} tokens in one call:")
    reset_launches()
    profile_steps(prefill, 1)
    counts = dict(LAUNCHES)  # three prefills: warm-up, timed, profiled
    require(counts, ["qmm_q5_0", "qmm_q8_0", "qmm_q4_k", "qmm_q6_k"], "deepseek prefill")
    records["qmm_q5_0"]["launches"] = counts["qmm_q5_0"] // 3
    del ctx
    torch.cuda.empty_cache()
    chat = apply_chat_template(model.vocab.chat_template,
                               [{"role": "system", "content": "Be brief."},
                                {"role": "user", "content": "Hi"}])
    print(f"  the GGUF's chat template renders a system+user chat as {chat!r}")
    if chat != "Be brief.\n\nUser: Hi\n\nAssistant:":
        fail("the DeepSeek-V2 template did not render through the deepseek2 family")
    phase_serve(records, path, model, SERVE_CONFIGS_DS, n_ctx=2048, system_repeat=16,
                step_must=["mla_decode", *DS_B9])


SMALL_QWEN = {  # (arch, ftype) → the kernels its path must launch
    ("qwen2", "Q3_K_M"): ["qmm_q3_k", "qmm_q4_k", "qmm_q5_k", "qmm_q6_k", "flash_decode"],
    ("qwen2", "Q2_K"): ["qmm_q2_k", "qmm_q3_k", "qmm_q6_k", "flash_decode"],
    ("qwen3", "Q2_K"): ["qmm_q2_k", "qmm_q3_k", "qmm_q6_k", "flash_decode"],
    ("qwen2moe", "Q2_K"): ["qmm_experts_q2_k", "qmm_experts_q3_k", "qmm_q2_k", "qmm_q3_k"],
    ("qwen3moe", "Q3_K_M"): ["qmm_experts_q3_k", "qmm_experts_q4_k", "qmm_q3_k", "qmm_q4_k"],
    ("mistral", "Q4_0"): ["qmm_q4_0", "attn_fused"],
    ("phi3", "Q3_K_M"): ["qmm_q3_k", "qmm_q4_k", "qmm_q6_k", "flash_decode"],
}
SMALL_QWEN_PROMPT = "The quick brown fox jumps over the lazy dog, then rests a while.."


def phase_small_qwen(records: dict) -> None:
    """The Qwen family, mistral and phi3 as unit-size models
    (`tools/synth.py::unit_config`: 2 layers, width 256, head_dim 128, the
    qwen2 vocab; MoE 16 experts top-4) in the mixes of SMALL_QWEN, card
    against CPU: a 34-token prompt (a 32-token chunk through the tiled
    kernels, then two rows through the GEMVs; every expert over every row
    in the MoE layers) and a 16-token greedy stream (the GEMVs and the
    selected-expert kernel)."""
    from llama_cpp_dsp_tpu_torch.runtime.loader import load_model
    from llama_cpp_dsp_tpu_torch.tools.synth import UNIT_EXPERTS, unit_config, write_synth_gguf

    for (arch, ftype), must in SMALL_QWEN.items():
        path = ROOT / "build" / "smoke" / f"small-{arch}-{ftype.lower()}.gguf"
        path.parent.mkdir(parents=True, exist_ok=True)
        write_synth_gguf(str(path), unit_config(arch), ftype, seed=5, vocab="qwen2",
                         experts=UNIT_EXPERTS)
        model = load_model(str(path))
        n_prompt = len(model.tokenizer.encode(SMALL_QWEN_PROMPT))
        if n_prompt != 34 or model.cfg.rope.mode != ("norm" if arch == "mistral" else "neox"):
            fail(f"small_qwen {arch}: a {n_prompt}-token prompt, rope {model.cfg.rope.mode}")
        counts = small_model_check(path, SMALL_QWEN_PROMPT, [*must, "flash_prefill"],
                                   f"small_qwen {arch} {ftype}", model=model, n_stream=16)
        for k in must:  # a kernel's count comes from the first path that runs it
            records[k]["launches"] = records[k]["launches"] or counts[k]


def _weight_bytes_per_token(model) -> tuple[int, int]:
    """Bytes of the weights one decode token reads, in GGUF blocks (the
    least it needs) and in the port's repacked layout: every matrix but the
    embedding (a row gather); an expert stack counts n_expert_used of its
    n_expert experts."""
    from llama_cpp_dsp_tpu_torch.ops.qtensor import QTensor

    gguf = layout = 0
    for w in [model.params.get("output")] + [
            w for layer in model.params["layers"] for w in layer.values()]:
        if isinstance(w, QTensor):
            used, n = (model.cfg.n_expert_used, w.n_expert) if w.n_expert else (1, 1)
            gguf += gguf_nbytes(w) * used // n
            layout += w.nbytes * used // n
        elif w is not None and w.dim() == 2:
            gguf += w.numel() * w.element_size()
            layout += w.numel() * w.element_size()
    return gguf, layout


SERVE_CONFIGS_QWEN = {  # name → (server flags, kernels its decode must launch)
    "slots bf16": ([], ["flash_decode", "qmm_q3_k", "qmm_q4_k", "qmm_q6_k"]),
    "paged q8_0": (["--kv-layout", "paged", "-ctk", "q8_0"],
                   ["flash_decode_paged_q8", "qmm_q3_k", "qmm_q4_k", "qmm_q6_k"]),
}


def _cli_and_bytes(records: dict, path: Path, model, label: str, must: list[str],
                   own: list[str]):
    """A full-width model through `_cli_step`, with the weight and KV bytes
    a token reads. The launches of `own` (the kernels this CLI is the main
    path of) are this CLI's; another kernel of `must` takes its count from
    the first path that runs it. Returns the launches of one decode step."""
    import torch

    ctx, step, counts = _cli_step(records, path, model, label, must, own)
    for k in must:
        records[k]["launches"] = records[k]["launches"] or counts[k]
    cfg = model.cfg
    kv = 2 * cfg.n_layers * cfg.n_kv_heads * cfg.head_dim * 2  # bf16 K and V rows
    wb, lb = _weight_bytes_per_token(model)
    print(f"  bytes per decode token: weights {wb} in GGUF blocks ({wb / HBM_BYTES_PER_S * 1e3:.3f}"
          f" ms at 3.35 TB/s), {lb} in the port's layout; KV cache {kv} a cached row")
    del ctx
    torch.cuda.empty_cache()
    return step


def phase_qwen(records: dict, files: dict, model_of, done_with) -> None:
    """Qwen2.5-7B-Instruct Q3_K_M at full width and depth (GQA group 7,
    q/k/v biases; Q3_K q, k, gate|up; Q5_K / Q4_K attn_v and ffn_down; Q6_K
    LM head) through the CLI, then the server (slots bf16 and paged q8_0)
    with chats through its ChatML template; then Qwen3-8B Q2_K (q/k norm;
    Q2_K q, k, gate|up; Q3_K attn_output and ffn_down; Q4_K attn_v) through
    the CLI."""
    from llama_cpp_dsp_tpu_torch.serve.chat import apply_chat_template

    model = model_of("q25")
    _cli_and_bytes(records, files["q25"][0], model, "Qwen2.5-7B Q3_K_M",
                   ["qmm_q3_k", "qmm_q4_k", "qmm_q5_k", "qmm_q6_k", "flash_decode",
                    "flash_prefill"], ["qmm_q3_k"])
    chat = apply_chat_template(model.vocab.chat_template,
                               [{"role": "system", "content": "Be brief."},
                                {"role": "user", "content": "Hi"}])
    print(f"  the GGUF's chat template renders a system+user chat as {chat!r}")
    if not chat.startswith("<|im_start|>system\nBe brief.<|im_end|>"):
        fail("the Qwen2.5 template did not render through the chatml family")
    phase_serve(records, files["q25"][0], model, SERVE_CONFIGS_QWEN, n_ctx=2048,
                system_repeat=16)
    done_with("q25")
    del model
    _cli_and_bytes(records, files["q3"][0], model_of("q3"), "Qwen3-8B Q2_K",
                   ["qmm_q2_k", "qmm_q3_k", "qmm_q4_k", "qmm_q6_k", "flash_decode",
                    "flash_prefill"], ["qmm_q2_k"])
    done_with("q3")


SMALL_GEMMA = {  # (arch, ftype, -ctk) → the kernels its path must launch
    ("gemma", "Q4_K_M", "bf16"): ["flash_prefill", "flash_decode", "qmm_q4_k", "qmm_q6_k"],
    ("gemma2", "Q4_K_M", "bf16"): ["flash_prefill", "flash_decode", "qmm_q4_k", "qmm_q6_k"],
    ("gemma3", "Q4_K_M", "bf16"): ["flash_prefill", "flash_decode", "qmm_q4_k", "qmm_q6_k"],
    ("gemma3", "Q4_0", "bf16"): ["flash_prefill", "flash_decode", "qmm_q4_0"],
    ("gemma3", "Q4_K_M", "q8_0"): ["flash_decode_q8", "qmm_q4_k", "qmm_q6_k"],
    ("gemma3", "Q4_K_M", "q4_0"): ["flash_decode_q4", "qmm_q4_k", "qmm_q6_k"],
}
SMALL_GEMMA_PROMPT = "The quick brown fox jumps over it"  # with <bos>: 34 tokens
# A prefill into a quantized cache runs no attention kernel (the plain
# einsum on the card and on the CPU alike), but the K/V rows it writes are
# re-quantized: the qmm kernels' exact f32 weights against the plain
# versions' bf16-rounded ones (QMM_NMSE_TOL) flip some Q4 codes, each a
# whole quantization step, and the layers grow that. `_qmm_rounding_witness`
# measures the effect on the CPU alone in every run; the card's prefill is
# held to this limit over Q4_0 rows (2e-2 otherwise), and each decode kernel
# call to its plain version on the same inputs (FLASH_NMSE_TOL).
SMALL_GEMMA_PREFILL_RTOL = {"q4_0": 6e-2}
SMALL_GEMMA_DECODE = {"bf16": "flash_decode", "q8_0": "flash_decode_q8",  # -ctk → B2, B5, B8
                      "q4_0": "flash_decode_q4"}


def _qmm_rounding_witness(model, prompt_text: str, ctk: str) -> float:
    """The prefill logits of `model` over a `ctk` cache on the CPU with the
    plain qmm against the same with the kernels' weight arithmetic (exact
    f32 dequantized weights, x in bf16): the part of a card-against-CPU
    difference that the cache's re-quantization makes of the qmm rounding."""
    import numpy as np
    import torch

    from llama_cpp_dsp_tpu_torch.ops.kernels import qmm as kqmm
    from llama_cpp_dsp_tpu_torch.quant.dequant import dequant
    from llama_cpp_dsp_tpu_torch.runtime.context import LlamaContext

    def exact(x, w):
        y = x.reshape(-1, w.shape[1]).to(torch.bfloat16).float() @ dequant(w, torch.float32).T
        return y.reshape(*x.shape[:-1], w.shape[0])

    prompt = model.tokenizer.encode(prompt_text)
    plain = LlamaContext(model, n_ctx=64, device="cpu", kv_dtype=ctk).eval_tokens(prompt)
    qmm = kqmm.qmm
    kqmm.qmm = exact
    try:
        other = LlamaContext(model, n_ctx=64, device="cpu", kv_dtype=ctk).eval_tokens(prompt)
    finally:
        kqmm.qmm = qmm
    return float(np.abs(other - plain).max() / np.abs(plain).max())


def _gate_decode_calls(model, prompt_text: str, ctk: str, kernel: str, label: str) -> None:
    """One decode step on the card after the prompt: every call of the
    step's decode kernel against its plain version on the same inputs."""
    import torch

    from llama_cpp_dsp_tpu_torch.ops.kernels import attention as ka
    from llama_cpp_dsp_tpu_torch.runtime.context import LlamaContext

    ctx = LlamaContext(model, n_ctx=64, kv_dtype=ctk)
    tok = int(ctx.eval_tokens(model.tokenizer.encode(prompt_text)).argmax())
    calls = []
    with _swap_kernel(kernel, _recording(calls)):
        ctx.eval_tokens([tok])
    torch.cuda.synchronize()
    plain = getattr(ka, kernel + "_plain")
    worst = max(max(slot_nmse(out, plain(q, *args, **kw))) for q, args, kw, out in calls)
    print(f"  {label}: {len(calls)} {kernel} calls of a decode step against {plain.__name__} "
          f"on their own inputs: worst nmse {worst:.2e} (tol {FLASH_NMSE_TOL:g})")
    if len(calls) != model.cfg.n_layers or not worst <= FLASH_NMSE_TOL:
        fail(f"{label}: {kernel} disagrees with its plain version inside the model")


def phase_small_gemma(records: dict) -> None:
    """The Gemma family as unit-size models (`tools/synth.py::unit_config`:
    head_dim 256, 2 heads over 1 KV head, a 16-row window, gemma3 with 6
    layers; the Gemma vocab) card against CPU: a 34-token prompt (a 32-token
    chunk, then 2 tokens: B4 over the window at D = 256 on a dense cache)
    and a 16-token greedy stream (decode with SWA starts: B2, or B5 / B8 with
    -ctk q8_0 / q4_0)."""
    from llama_cpp_dsp_tpu_torch.runtime.loader import load_model
    from llama_cpp_dsp_tpu_torch.tools.synth import unit_config, write_synth_gguf

    for (arch, ftype, ctk), must in SMALL_GEMMA.items():
        path = ROOT / "build" / "smoke" / f"small-{arch}-{ftype.lower()}.gguf"
        path.parent.mkdir(parents=True, exist_ok=True)
        write_synth_gguf(str(path), unit_config(arch), ftype, seed=5, vocab="gemma")
        model = load_model(str(path))
        n_prompt = len(model.tokenizer.encode(SMALL_GEMMA_PROMPT))
        if n_prompt != 34 or model.cfg.head_dim != 256:
            fail(f"small_gemma {arch}: a {n_prompt}-token prompt, head_dim {model.cfg.head_dim}")
        label = f"small_gemma {arch} {ftype} -ctk {ctk}"
        if ctk != "bf16":
            print(f"  {label}: the CPU's prefill logits with the kernels' qmm arithmetic "
                  f"against the plain one: rel diff "
                  f"{_qmm_rounding_witness(model, SMALL_GEMMA_PROMPT, ctk):.2e}")
        counts = small_model_check(path, SMALL_GEMMA_PROMPT, must, label, model=model,
                                   ctx_kw={"kv_dtype": ctk}, n_stream=16,
                                   prefill_tol=SMALL_GEMMA_PREFILL_RTOL.get(ctk, 2e-2))
        kernel = SMALL_GEMMA_DECODE[ctk]
        _gate_decode_calls(model, SMALL_GEMMA_PROMPT, ctk, kernel, label)
        r = records[kernel].setdefault("d256", {})  # B5 / B8 at D = 256 run on no other path
        r["launches"] = r.get("launches") or counts[kernel]


GEMMA_PROMPT = "The quick brown fox jumps over the lazy dog. " * 34  # 1499 chars are taken
# the B4 step twin: the first decode step's logits after a prefill whose 48
# B4 calls are swapped for flash_prefill_plain. Each layer's B4 output is
# gated against its plain version (NMSE ≤ FLASH_NMSE_TOL); the logits are
# not bit-equal (last-bit differences flip bf16 roundings of the
# activations), and are held to the logit limit of the other same-model
# comparisons
GEMMA_TWIN_RTOL = LOGIT_RTOL
SERVE_CONFIGS_GEMMA = {  # name → (server flags, kernels its decode must launch)
    "slots bf16": ([], ["flash_prefill", "flash_decode", "qmm_q4_k", "qmm_q6_k"]),
    "paged q8_0": (["--kv-layout", "paged", "-ctk", "q8_0"],
                   ["flash_decode_paged_q8", "qmm_q4_k", "qmm_q6_k"]),
}


def phase_gemma(records: dict, files: dict, model_of, done_with) -> None:
    """Gemma-3-12B-it Q4_K_M at full width and depth (48 layers, 40 of them
    sliding-window; head_dim 256; the Gemma vocab and chat template): the
    CLI on a 1500-token prompt (past the 1024-row window) and a 32-token
    greedy stream, the launches of the prefill (B4 48 times) and of one
    decode step (B2 48 times), every layer's B4 output against its plain
    version on the same inputs, the first decode step against a prefill
    with B4 swapped for its plain version, a profiled decode chunk and
    prefill; then the server over slots bf16 and paged q8_0 (-np 4 -c 2048)
    with two ~1300-token chats sharing a ~1260-token system prompt."""
    import numpy as np
    import torch

    from llama_cpp_dsp_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from llama_cpp_dsp_tpu_torch.ops.kernels import attention as ka
    from llama_cpp_dsp_tpu_torch.runtime.context import LlamaContext
    from llama_cpp_dsp_tpu_torch.serve.chat import apply_chat_template

    model = model_of("g3")
    path = files["g3"][0]
    cfg = model.cfg
    text = GEMMA_PROMPT[:1499]
    prompt = model.tokenizer.encode(text)
    print(f"  prompt: {len(prompt)} tokens; {sum(map(cfg.is_swa_layer, range(cfg.n_layers)))} "
          f"of {cfg.n_layers} layers sliding-window ({cfg.swa_window} rows)")
    reset_launches()
    _, err = run_cli(["-m", str(path), "-p", text, "-n", "32", "--temp", "0", "-c", "2048"],
                     model)
    counts = dict(LAUNCHES)
    must = ["flash_prefill", "flash_decode", "qmm_q4_k", "qmm_q6_k"]
    require(counts, must, "Gemma-3-12B CLI")
    records["flash_prefill"]["launches"] = counts["flash_prefill"]
    records["flash_decode"].setdefault("d256", {})["launches"] = counts["flash_decode"]
    print(f"  Gemma-3-12B Q4_K_M CLI: {decode_tps(err):.2f} tokens/s decode")

    ctx = LlamaContext(model, n_ctx=2048)
    reset_launches()
    pre = ctx.eval_tokens(prompt)
    torch.cuda.synchronize()
    pre_counts = {k: v for k, v in LAUNCHES.items() if v}
    first = int(pre.argmax())
    reset_launches()
    step = ctx.eval_tokens([first])
    torch.cuda.synchronize()
    step_counts = {k: v for k, v in LAUNCHES.items() if v}
    print(f"  launches of the {len(prompt)}-token prefill: {pre_counts}")
    print(f"  launches of one decode step: {step_counts}")
    if pre_counts.get("flash_prefill") != cfg.n_layers or step_counts.get("flash_decode") != \
            cfg.n_layers or "flash_prefill" in step_counts:
        fail("the prefill and the decode step did not launch B4 and B2 once a layer")

    calls = []  # every layer's B4 call, rerun through the plain version
    ctx.rollback_to(0)
    with _swap_kernel("flash_prefill", _recording(calls)):
        ctx.eval_tokens(prompt)
    worst = 0.0
    for q, args, kw, out in calls:
        worst = max(worst, *slot_nmse(out, ka.flash_prefill_plain(q, *args, **kw)))
    print(f"  B4 in each of the {len(calls)} layers against flash_prefill_plain on its own "
          f"inputs: worst nmse {worst:.2e} (tol {FLASH_NMSE_TOL:g})")
    if len(calls) != cfg.n_layers or not worst <= FLASH_NMSE_TOL:
        fail("a layer's B4 output disagrees with its plain version")
    del calls
    ctx.rollback_to(0)
    with _swap_kernel("flash_prefill", lambda kernel: ka.flash_prefill_plain):
        pre_plain = ctx.eval_tokens(prompt)
    step_plain = ctx.eval_tokens([first])
    rel = float(np.abs(step - step_plain).max() / np.abs(step_plain).max())
    print(f"  first decode step after a B4 prefill against one through flash_prefill_plain: "
          f"max rel diff {rel:.3e} (tol {GEMMA_TWIN_RTOL:g}); prefill argmax "
          f"{first} vs {int(pre_plain.argmax())}, step argmax {int(step.argmax())} vs "
          f"{int(step_plain.argmax())}")
    if not (rel < GEMMA_TWIN_RTOL and np.isfinite(step).all()):
        fail("the B4 prefill's first decode step disagrees with the plain prefill's")
    print(f"  decode step at context {ctx.n_past}:")
    reset_launches()
    profile_chunk(ctx, int(step.argmax()))
    print(f"    port kernel launches per token: "
          f"{ {k: v / 24 for k, v in LAUNCHES.items() if v} }")

    def prefill():
        ctx.rollback_to(0)
        ctx.eval_tokens(prompt)

    print(f"  prefill of {len(prompt)} tokens in one call:")
    profile_steps(prefill, 1)
    del ctx
    torch.cuda.empty_cache()
    chat = apply_chat_template(model.vocab.chat_template,
                               [{"role": "system", "content": "Be brief."},
                                {"role": "user", "content": "Hi"}])
    print(f"  the GGUF's chat template renders a system+user chat as {chat!r}")
    if chat != "<start_of_turn>user\nBe brief.\n\nHi<end_of_turn>\n<start_of_turn>model\n":
        fail("the Gemma template did not render through the gemma family")
    summary = phase_serve(records, path, model, SERVE_CONFIGS_GEMMA, n_ctx=2048,
                          system_repeat=35)
    records["flash_decode_paged_q8"].setdefault("d256", {})["launches"] = \
        summary["paged q8_0"]["launches"]["flash_decode_paged_q8"]
    done_with("g3")


# unit llama models in every IQ / TQ ftype, and a unit qwen3moe in each
# ftype whose experts take another of the 11 kinds (the experts take the
# ftype's default kind)
SMALL_IQ_LLAMA = ("IQ4_NL", "IQ4_XS", "IQ2_XXS", "IQ2_XS", "IQ2_S", "IQ2_M", "IQ3_XXS", "IQ3_XS",
                  "IQ3_S", "IQ3_M", "IQ1_S", "IQ1_M", "TQ1_0", "TQ2_0")
SMALL_IQ_MOE = ("IQ4_NL", "IQ4_XS", "IQ2_XXS", "IQ2_XS", "IQ2_S", "IQ3_XXS", "IQ3_S", "IQ1_S",
                "IQ1_M", "TQ1_0", "TQ2_0")


def _qmm_counters(model) -> list[str]:
    """The launch counts of the qmm / B9 kernels a model's packed matrices
    take (an expert stack: the selected-expert kernel)."""
    from llama_cpp_dsp_tpu_torch.ops.kernels.qmm import _counter
    from llama_cpp_dsp_tpu_torch.ops.qtensor import QTensor

    ws = [model.params.get("output")] + [w for layer in model.params["layers"]
                                         for w in layer.values()]
    return sorted({_counter(w.kind, bool(w.n_expert)) for w in ws if isinstance(w, QTensor)})


def phase_small_iq(records: dict) -> None:
    """The IQ / TQ kinds at unit size (`tools/synth.py::unit_config`, the
    qwen2 vocab): a llama in every ftype of SMALL_IQ_LLAMA and a qwen3moe
    (16 experts top-4) in every ftype of SMALL_IQ_MOE, card against CPU: a
    34-token prompt (a 32-token chunk through the tiled kernels, every
    expert over every row in the MoE layers, then two rows through the
    GEMVs) and a 16-token greedy stream (the GEMVs, the selected-expert
    kernel). Fails unless every IQ / TQ qmm and B9 kernel ran in the phase."""
    from llama_cpp_dsp_tpu_torch.runtime.loader import load_model
    from llama_cpp_dsp_tpu_torch.tools.synth import UNIT_EXPERTS, unit_config, write_synth_gguf

    total = {}
    for arch, ftypes in (("llama", SMALL_IQ_LLAMA), ("qwen3moe", SMALL_IQ_MOE)):
        for ftype in ftypes:
            path = ROOT / "build" / "smoke" / f"small-{arch}-{ftype.lower()}.gguf"
            path.parent.mkdir(parents=True, exist_ok=True)
            write_synth_gguf(str(path), unit_config(arch), ftype, seed=5, vocab="qwen2",
                             experts=UNIT_EXPERTS)
            model = load_model(str(path))
            must = _qmm_counters(model)
            counts = small_model_check(path, SMALL_QWEN_PROMPT, [*must, "flash_prefill"],
                                       f"small_iq {arch} {ftype}", model=model, n_stream=16)
            for k in must:  # a kernel's count comes from the first path that runs it
                records[k]["launches"] = records[k]["launches"] or counts[k]
                total[k] = total.get(k, 0) + counts[k]
    require(total, [f"qmm{part}_{k}" for part in ("", "_experts") for k in IQ_KINDS], "small_iq")


SERVE_CONFIGS_IQ = {  # name → (server flags, kernels its decode must launch)
    "slots bf16": ([], ["flash_decode", "qmm_iq4_xs", "qmm_q6_k"]),
    "paged q8_0": (["--kv-layout", "paged", "-ctk", "q8_0"],
                   ["flash_decode_paged_q8", "qmm_iq4_xs", "qmm_q6_k"]),
}


def phase_iq(records: dict, files: dict, model_of, done_with) -> None:
    """Llama-3-8B at full width and depth in two IQ mixes (the kinds of the
    JAX package's tools/quantize.py::tensor_get_type): IQ4_XS (every matrix,
    the embedding too; Q6_K LM head) through the CLI (tokens/s, the launches
    of one decode step, the bytes a token reads, a profiled chunk, a
    profiled 512-token prefill), then the server over slots bf16 and paged
    q8_0; IQ2_M (IQ2_S q, o, gate|up, down; IQ3_S attn_k; Q4_K attn_v; Q2_K
    embedding; Q5_K LM head) through the CLI."""
    import torch

    model = model_of("iq4xs")
    ctx, step, _ = _cli_step(records, files["iq4xs"][0], model, "Llama-3-8B IQ4_XS",
                             ["qmm_iq4_xs", "qmm_q6_k", "flash_decode", "flash_prefill"],
                             ["qmm_iq4_xs"])
    wb, lb = _weight_bytes_per_token(model)
    print(f"  bytes per decode token: weights {wb} in GGUF blocks ({wb / HBM_BYTES_PER_S * 1e3:.3f}"
          f" ms at 3.35 TB/s), {lb} in the port's layout; IQ4_XS GEMVs a step "
          f"{step.get('qmm_iq4_xs', 0)}")
    _profile_prefill_512(ctx, model)
    del ctx
    torch.cuda.empty_cache()
    phase_serve(records, files["iq4xs"][0], model, SERVE_CONFIGS_IQ, n_ctx=2048,
                system_repeat=16)
    done_with("iq4xs")
    del model
    step = _cli_and_bytes(records, files["iq2m"][0], model_of("iq2m"), "Llama-3-8B IQ2_M",
                          ["qmm_iq2_s", "qmm_iq3_s", "qmm_q4_k", "qmm_q5_k", "flash_decode",
                           "flash_prefill"], ["qmm_iq2_s", "qmm_iq3_s"])
    print(f"  IQ2_M GEMVs a step: IQ2_S {step.get('qmm_iq2_s', 0)}, IQ3_S "
          f"{step.get('qmm_iq3_s', 0)}, Q4_K {step.get('qmm_q4_k', 0)}, Q5_K "
          f"{step.get('qmm_q5_k', 0)}")
    done_with("iq2m")


def phase_q8(records: dict) -> None:
    from llama_cpp_dsp_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from llama_cpp_dsp_tpu_torch.tools.synth import TINYLLAMA_1B, write_synth_gguf

    path = ROOT / "build" / "smoke" / "tinyllama-q8_0.gguf"
    path.parent.mkdir(parents=True, exist_ok=True)
    write_synth_gguf(str(path), TINYLLAMA_1B, "Q8_0", seed=1)
    reset_launches()
    _, err = run_cli(["-m", str(path), "-p", "hello", "-n", "16", "--temp", "0", "-c", "256"])
    counts = dict(LAUNCHES)
    require(counts, ["qmm_q8_0"], "q8")
    records["qmm_q8_0"]["launches"] = counts["qmm_q8_0"]
    print(f"  TinyLlama Q8_0: {decode_tps(err):.2f} tokens/s decode")
    path.unlink()


SOURCES = {  # name → (source, TPU kernel it replaces, tolerance against the plain version)
    "qmm_q4_0": ("llama_cpp_dsp_tpu_torch/csrc/qmm.cu",
                 "llama_cpp_dsp_tpu/ops/pallas/qmm.py:221", f"nmse <= {QMM_NMSE_TOL:g}"),
    "qmm_q8_0": ("llama_cpp_dsp_tpu_torch/csrc/qmm.cu",
                 "llama_cpp_dsp_tpu/ops/pallas/qmm.py:174", f"nmse <= {QMM_NMSE_TOL:g}"),
    "flash_decode": ("llama_cpp_dsp_tpu_torch/csrc/flash_decode.cu",
                     "llama_cpp_dsp_tpu/ops/pallas/attention.py:128",
                     f"atol {FLASH_ATOL:g}, per-slot nmse <= {FLASH_NMSE_TOL:g}"),
    "attn_fused": ("llama_cpp_dsp_tpu_torch/csrc/attn_fused.cu",
                   "llama_cpp_dsp_tpu/ops/pallas/attn_fused.py:62",
                   f"per-slot nmse <= {FUSED_NMSE_TOL:g}"),
    "flash_decode_q8": ("llama_cpp_dsp_tpu_torch/csrc/flash_decode.cu",
                        "llama_cpp_dsp_tpu/ops/pallas/attention.py:420",
                        f"per-slot nmse <= {FLASH_NMSE_TOL:g}"),
    "flash_decode_q4": ("llama_cpp_dsp_tpu_torch/csrc/flash_decode.cu",
                        "llama_cpp_dsp_tpu/ops/pallas/attention.py:735",
                        f"per-slot nmse <= {FLASH_NMSE_TOL:g}"),
    "flash_decode_paged": ("llama_cpp_dsp_tpu_torch/csrc/flash_decode.cu",
                           "llama_cpp_dsp_tpu/ops/pallas/attention.py:1022",
                           f"per-slot nmse <= {FLASH_NMSE_TOL:g}"),
    "flash_decode_paged_q8": ("llama_cpp_dsp_tpu_torch/csrc/flash_decode_gqa_paged_q8.cu",
                              "llama_cpp_dsp_tpu/ops/pallas/attention.py:1277",
                              f"per-slot nmse <= {FLASH_NMSE_TOL:g}"),
    "qmm_q4_k": ("llama_cpp_dsp_tpu_torch/csrc/qmm.cu",
                 "llama_cpp_dsp_tpu/ops/pallas/qmm.py:310", f"nmse <= {QMM_NMSE_TOL:g}"),
    "qmm_q6_k": ("llama_cpp_dsp_tpu_torch/csrc/qmm.cu",
                 "llama_cpp_dsp_tpu/ops/pallas/qmm.py:345", f"nmse <= {QMM_NMSE_TOL:g}"),
    "qmm_q5_k": ("llama_cpp_dsp_tpu_torch/csrc/qmm.cu",
                 "llama_cpp_dsp_tpu/ops/pallas/qmm.py:328", f"nmse <= {QMM_NMSE_TOL:g}"),
    **{f"qmm_experts_{k}": ("llama_cpp_dsp_tpu_torch/csrc/qmm.cu",
                            "llama_cpp_dsp_tpu/ops/pallas/qmm.py:781",
                            f"per-row nmse <= {QMM_NMSE_TOL:g}")
       for k in ("q4_0", "q8_0", "q4_k", "q5_k", "q6_k", "q4_1", "q5_0", "q5_1", "q2_k",
                 "q3_k")},
    "qmm_q4_1": ("llama_cpp_dsp_tpu_torch/csrc/qmm.cu",
                 "llama_cpp_dsp_tpu/ops/pallas/qmm.py:225", f"nmse <= {QMM_NMSE_TOL:g}"),
    "qmm_q5_0": ("llama_cpp_dsp_tpu_torch/csrc/qmm.cu",
                 "llama_cpp_dsp_tpu/ops/pallas/qmm.py:229", f"nmse <= {QMM_NMSE_TOL:g}"),
    "qmm_q5_1": ("llama_cpp_dsp_tpu_torch/csrc/qmm.cu",
                 "llama_cpp_dsp_tpu/ops/pallas/qmm.py:241", f"nmse <= {QMM_NMSE_TOL:g}"),
    "qmm_q2_k": ("llama_cpp_dsp_tpu_torch/csrc/qmm.cu",
                 "llama_cpp_dsp_tpu/ops/pallas/qmm.py:364", f"nmse <= {QMM_NMSE_TOL:g}"),
    "qmm_q3_k": ("llama_cpp_dsp_tpu_torch/csrc/qmm.cu",
                 "llama_cpp_dsp_tpu/ops/pallas/qmm.py:374", f"nmse <= {QMM_NMSE_TOL:g}"),
    "mla_decode": ("llama_cpp_dsp_tpu_torch/csrc/mla_decode.cu",
                   "llama_cpp_dsp_tpu/ops/pallas/attention.py:623",
                   f"per-slot nmse <= {MLA_NMSE_TOL:g}"),
    "flash_prefill": ("llama_cpp_dsp_tpu_torch/csrc/flash_prefill.cu",
                      "llama_cpp_dsp_tpu/ops/pallas/attention.py:1474",
                      f"per-slot nmse <= {FLASH_NMSE_TOL:g}"),
    **{f"qmm_{k}": ("llama_cpp_dsp_tpu_torch/csrc/qmm.cu",
                    f"llama_cpp_dsp_tpu/ops/pallas/qmm.py:{IQ_BODY_LINE[k]}",
                    f"nmse <= {QMM_NMSE_TOL:g}") for k in IQ_KINDS},
    **{f"qmm_experts_{k}": ("llama_cpp_dsp_tpu_torch/csrc/qmm.cu",
                            "llama_cpp_dsp_tpu/ops/pallas/qmm.py:781",
                            f"per-row nmse <= {QMM_NMSE_TOL:g}") for k in IQ_KINDS},
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {','.join(PHASES)}")
    ap.add_argument("--kernels", default=None,
                    help="comma-separated subset of the kernels phase's checks (default: all): "
                         "qmm (B1), qmm_experts (B9), flash_decode, flash_decode_q4, "
                         "attn_fused, decode_variants, mla_decode, decode_d256, flash_prefill")
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    if not (ROOT / "llama_cpp_dsp_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: the port is not next to {__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from llama_cpp_dsp_tpu_torch.ops.kernels import build

    t_start = time.perf_counter()
    card = gpu_line()
    print(f"device: {torch.cuda.get_device_name(0)} | {card} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    records = {name: {"launches": 0} for name in SOURCES}
    smoke = ROOT / "build" / "smoke"
    # synthetic GGUFs shared by phases: written one ahead in the background,
    # loaded on first use, deleted after their last phase (and at the end in
    # any case)
    from llama_cpp_dsp_tpu_torch.tools.synth import MIXTRAL_CHAT_TEMPLATE

    files = {"7b": (smoke / "llama2-7b-q4_0.gguf", "llama2-7b", "Q4_0", "spm", None, 0),
             "l3": (smoke / "llama3-8b-q4_k_m.gguf", "llama3-8b", "Q4_K_M", "llama-bpe", None,
                    0),
             "q5": (smoke / "llama3-8b-q5_k_m.gguf", "llama3-8b", "Q5_K_M", "llama-bpe", None,
                    2),
             "mx": (smoke / "mixtral-8x7b-q4_k_m.gguf", "mixtral-8x7b", "Q4_K_M", "spm",
                    MIXTRAL_CHAT_TEMPLATE, 0),
             "ds": (smoke / "deepseek-v2-lite-q4_k_m.gguf", "deepseek-v2-lite", "Q4_K_M",
                    "deepseek-llm", None, 0),
             "q25": (smoke / "qwen2.5-7b-q3_k_m.gguf", "qwen2.5-7b", "Q3_K_M", "qwen2", None,
                     0),
             "q3": (smoke / "qwen3-8b-q2_k.gguf", "qwen3-8b", "Q2_K", "qwen2", None, 0),
             "g3": (smoke / "gemma3-12b-q4_k_m.gguf", "gemma3-12b", "Q4_K_M", "gemma", None, 0),
             "iq4xs": (smoke / "llama3-8b-iq4_xs.gguf", "llama3-8b", "IQ4_XS", "llama-bpe", None,
                       0),
             "iq2m": (smoke / "llama3-8b-iq2_m.gguf", "llama3-8b", "IQ2_M", "llama-bpe", None,
                      0)}
    loaded = {}

    def model_of(key):
        if key not in loaded:
            from llama_cpp_dsp_tpu_torch.runtime.loader import load_model

            path = ggufs.ready(key)
            t0 = time.perf_counter()
            loaded[key] = load_model(str(path), "cuda")
            print(f"  loaded {path.name} in {time.perf_counter() - t0:.1f} s")
        return loaded[key]

    def done_with(key):
        loaded.pop(key, None)
        files[key][0].unlink(missing_ok=True)
        torch.cuda.empty_cache()

    # name → the kernels phase's checks of that kernel family, attention first: after
    # the qmm checks most torch.profiler windows lose events (PERF.md §7)
    kernel_checks = {
        "flash_decode": lambda: check_flash_decode(records),
        "flash_decode_q4": lambda: check_flash_decode_q4(records),
        "attn_fused": lambda: check_attn_fused(records),
        "decode_variants": lambda: check_decode_variants(records),
        "mla_decode": lambda: check_mla_decode(records),
        "decode_d256": lambda: check_decode_d256(records),
        "flash_prefill": lambda: check_flash_prefill(records),
        "qmm": lambda: (check_qmm("q4_0", QMM_SHAPES_7B, (1, 8, 128),
                                  DECODE_CALLS_7B, records),
                        check_qmm("q8_0", QMM_SHAPES_7B, (1, 8, 128), {}, records),
                        check_qmm("q8_0", list(DECODE_CALLS_TINYLLAMA), (1,),
                                  DECODE_CALLS_TINYLLAMA, records),
                        check_qmm("q4_k", QMM_SHAPES_L3, KQ_BATCHES, DECODE_CALLS_L3,
                                  records),
                        check_qmm("q6_k", list(DECODE_CALLS_L3_Q6), KQ_BATCHES,
                                  DECODE_CALLS_L3_Q6, records),
                        check_qmm("q5_k", QMM_SHAPES_L3, KQ_BATCHES, DECODE_CALLS_L3,
                                  records),
                        *(check_qmm(k, LEGACY_QMM_SHAPES, (1, 8, 128),
                                    DECODE_CALLS_7B, records)
                          for k in ("q4_1", "q5_0", "q5_1")),
                        check_qmm("q8_0", [(2048, 10944)], (1, 8, 128), {}, records),
                        check_qmm("q3_k", [*QMM_SHAPES_QWEN, (37888, 3584)],
                                  (1, 8, 128), DECODE_CALLS_QWEN["q3_k"], records),
                        check_qmm("q2_k", [*QMM_SHAPES_QWEN, (1024, 4096),
                                           (24576, 4096)],
                                  (1, 8, 128), DECODE_CALLS_QWEN["q2_k"], records),
                        *(check_qmm(k, shapes, (1, 8, 128), {}, records)
                          for k, shapes in QWEN_KQ_SHAPES.items()),
                        *(check_qmm(k, shapes, KQ_BATCHES, {}, records)
                          for k, shapes in DS_QMM_SHAPES.items()),
                        *(check_qmm(k, QMM_SHAPES_L3, KQ_BATCHES, DECODE_CALLS_L3_IQ,
                                    records) for k in IQ_KINDS),
                        *(check_qmm_tc(k, records) for k in TC_SHAPE)),
        "qmm_experts": lambda: (*(check_qmm_experts(k, records) for k in MOE_DECODE_CALLS),
                                *(check_qmm_experts(k, records, n_expert=128,
                                                    shapes=QWEN_EXPERT_SHAPES,
                                                    rows=QWEN_EXPERT_ROWS,
                                                    decode_calls=QWEN_DECODE_CALLS[k],
                                                    s_time=8)
                                  for k in QWEN_DECODE_CALLS),
                                *(check_qmm_experts(k, records, n_expert=64,
                                                    shapes=DS_EXPERT_SHAPES,
                                                    rows=DS_EXPERT_ROWS,
                                                    decode_calls=DS_DECODE_CALLS[k], s_time=6)
                                  for k in DS_DECODE_CALLS),
                                *(check_qmm_experts(k, records, n_expert=64, shapes=shapes,
                                                    rows=DS_EXPERT_ROWS, decode_calls={})
                                  for k, shapes in DS_EXPERT_KQ_SHAPES.items()),
                                *(check_qmm_experts(k, records, n_expert=128,
                                                    shapes=QWEN_EXPERT_SHAPES,
                                                    rows=QWEN_EXPERT_ROWS,
                                                    decode_calls=QWEN_DECODE_CALLS_IQ,
                                                    s_time=8)
                                  for k in IQ_KINDS))}
    checks = list(kernel_checks) if args.kernels is None else args.kernels.split(",")
    if set(checks) - set(kernel_checks):
        fail(f"--kernels takes a subset of {','.join(kernel_checks)}")
    def run_kernel_checks():
        for c in checks:
            t0 = time.perf_counter()
            kernel_checks[c]()
            print(f"  [kernels] {c}: {time.perf_counter() - t0:.1f} s", flush=True)

    steps = [("kernels", run_kernel_checks),
             ("small", phase_small),
             ("main", lambda: phase_main(records, files["7b"][0], model_of("7b"))),
             ("serve", lambda: (phase_serve(records, files["7b"][0], model_of("7b")),
                                done_with("7b"))),
             ("q8", lambda: phase_q8(records)),
             ("small_kq", phase_small_kq),
             ("small_kv", lambda: phase_small_kv(records)),
             ("llama3", lambda: (phase_llama3(records, files["l3"][0], model_of("l3")),
                                 "kv8b" in phases or done_with("l3"))),
             ("kv8b", lambda: (phase_kv8b(records, files["l3"][0], model_of("l3")),
                               done_with("l3"))),
             ("small_moe", lambda: phase_small_moe(records)),
             ("mixtral", lambda: (phase_mixtral(records, files["mx"][0], model_of("mx")),
                                  done_with("mx"))),
             ("small_ds", lambda: phase_small_ds(records)),
             ("deepseek", lambda: (phase_deepseek(records, files["ds"][0], model_of("ds")),
                                   done_with("ds"))),
             ("small_qwen", lambda: phase_small_qwen(records)),
             ("qwen", lambda: phase_qwen(records, files, model_of, done_with)),
             ("small_gemma", lambda: phase_small_gemma(records)),
             ("gemma", lambda: phase_gemma(records, files, model_of, done_with)),
             ("small_iq", lambda: phase_small_iq(records)),
             ("iq", lambda: phase_iq(records, files, model_of, done_with)),
             ("q5km", lambda: (phase_q5km(records, ggufs.ready("q5")), done_with("q5")))]
    ggufs = BackgroundGGUFs(files, [key for key, uses in FILE_PHASES.items()
                                    if set(uses) & set(phases)])
    try:
        t0 = time.perf_counter()
        build.lib()
        print(f"[build] {time.perf_counter() - t0:.1f} s")
        for line in build.build_log.splitlines():
            if "registers" in line or "bytes stack" in line or line.startswith("=="):
                print("  " + line.strip())
        for name, fn in steps:
            if name in phases:
                t0 = time.perf_counter()
                print(f"[{name}]", flush=True)
                fn()
                print(f"[{name}] done in {time.perf_counter() - t0:.1f} s", flush=True)
    finally:
        ggufs.close()
    print(f"total {time.perf_counter() - t_start:.1f} s")
    kernels = []
    for name, (src, replaces, tol) in SOURCES.items():
        r = records[name]
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": r["launches"], "max_abs_err": r.get("max_abs_err"),
                        "max_nmse": r.get("max_nmse"), "tolerance": tol,
                        "ms": r.get("ms"), "plain_ms": r.get("plain_ms"),
                        "bound_ms": r.get("bound_ms"), "bound_by": r.get("bound_by"),
                        "library_ms": r.get("library_ms"),
                        **{k: r[k] for k in ("windows", "ms_b4", "by_row_type", "gqa", "d256",
                                             "carrier_bound_ms",
                                             "bound_split_ms", "bound_f32_ms", "d128",
                                             "f32_rows", "cluster8_ms", "cluster16_ms")
                                   if k in r}})
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
