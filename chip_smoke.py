#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (llama_cpp_dsp_tpu_torch) on one GPU.

    python3 chip_smoke.py            # every phase, as a release check runs it
    python3 chip_smoke.py --phases build,kernels   # a short first look

Phases:
  build    nvcc builds csrc/*.cu for sm_90a (one process per source).
  kernels  each hand-written kernel against its plain PyTorch version on the
           card, at the llama2-7B shapes, with its stated tolerance; times of
           kernel, plain version and a PyTorch yardstick call.
  small    a 2-layer head_dim-128 Q4_0 model: logits and greedy stream on
           the card (kernels) against the same model on the CPU (plain).
  main     a full-width llama2-7B-geometry Q4_0 GGUF of random blocks through
           the port's CLI (`-p hello -n 32 --temp 0`), then the same prompt
           with the fused attention kernel off (flash decode instead): first
           decode-step logits compared, stream agreement and tokens/s.
  q8       a TinyLlama-1.1B-geometry Q8_0 GGUF through the CLI.

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
L2_BYTES = 50 * 2**20
PHASES = ("build", "kernels", "small", "main", "q8")


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


def time_ms(fn, arg_sets, iters: int = 30) -> float:
    """Device time of fn(*args) per call: the summed durations of the CUDA
    kernels it runs (torch.profiler), cycling over arg_sets (enough copies to
    exceed L2 where the caller streams weights once). CUDA events around the
    loop would time the host instead: at decode sizes the host issues a call
    more slowly than the card runs it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for a in arg_sets[:3]:
        fn(*a)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(*arg_sets[i % len(arg_sets)])
        torch.cuda.synchronize()
    dev_us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA)
    if dev_us <= 0:
        fail("torch.profiler recorded no device time")
    return dev_us / 1e3 / iters


def n_copies(nbytes: int) -> int:
    return max(1, math.ceil(2.5 * L2_BYTES / max(nbytes, 1)))


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def nmse(got, want) -> float:
    d = (got.double() - want.double())
    return float((d * d).mean() / ((want.double() ** 2).mean() + 1e-30))


def slot_nmse(got, want) -> list[float]:
    """NMSE of each batch slot's output [H, D] against its own magnitude:
    a long-context slot's output is small, so one absolute limit over the
    batch would let a kernel that drops its rows pass."""
    return [nmse(g, w) for g, w in zip(got, want)]


def check_slots(name: str, got, want, faults: dict, tol: float) -> float:
    """Fail unless every slot of got is within `tol` (NMSE) of want, and
    every planted fault (the plain version with a row dropped) is outside
    it on every slot: the limit would catch that bug. Returns the worst
    kernel NMSE."""
    import torch

    errs = slot_nmse(got, want)
    print(f"  {name}: per-slot nmse vs plain {' '.join(f'{e:.1e}' for e in errs)} "
          f"(tol {tol:g})")
    if not (max(errs) <= tol and torch.isfinite(got).all()):
        fail(f"{name} disagrees with its plain version")
    for label, bad in faults.items():
        fe = slot_nmse(bad, want)
        print(f"    planted fault '{label}': per-slot nmse {' '.join(f'{e:.1e}' for e in fe)}")
        if not min(fe) > tol:
            fail(f"{name}: the tolerance would not catch '{label}'")
    return max(errs)


# ---------------------------------------------------------------------------
# kernels against their plain versions
# ---------------------------------------------------------------------------

QMM_SHAPES_7B = [(12288, 4096), (4096, 4096), (22016, 4096), (4096, 11008), (32000, 4096)]
# (N, K) and calls per decode token on the fused-attention main path
DECODE_CALLS_7B = {(4096, 4096): 32, (22016, 4096): 32, (4096, 11008): 32, (32000, 4096): 1}
DECODE_CALLS_TINYLLAMA = {(2560, 2048): 22, (2048, 2048): 22, (11264, 2048): 22,
                          (2048, 5632): 22, (32000, 2048): 1}
QMM_NMSE_TOL = 5e-4


def check_qmm(kind_name: str, shapes, batches, decode_calls, records, rng_seed=0):
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
    t = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0.0, "flops": 0.0}
    for n, k in shapes:
        w = synth_qtensor(rng, kind, (n, k)).to("cuda")
        w_exact = dequant(w, torch.float32)
        for b in batches:
            x = torch.randn(b, k, generator=gen, device="cuda").to(torch.bfloat16)
            got = qmm(x, w)
            plain = qmm_plain(x, w)
            exact = x.float() @ w_exact.T
            torch.cuda.synchronize()
            e_exact, e_plain = nmse(got, exact), nmse(got, plain)
            err = float((got - plain).abs().max())
            worst, worst_nmse = max(worst, err), max(worst_nmse, e_plain)
            print(f"  qmm_{kind_name} N={n} K={k} B={b}: nmse vs exact f32 {e_exact:.2e}, "
                  f"vs plain {e_plain:.2e}, max|kernel-plain| {err:.3e} "
                  f"(tol nmse {QMM_NMSE_TOL:g})")
            if not (e_exact <= QMM_NMSE_TOL and e_plain <= QMM_NMSE_TOL
                    and torch.isfinite(got).all()):
                fail(f"qmm_{kind_name} N={n} K={k} B={b} disagrees with its plain version")
        calls = decode_calls.get((n, k), 0)
        if calls:  # time the decode GEMV (B=1) with the weight cold in L2
            x = torch.randn(1, k, generator=gen, device="cuda").to(torch.bfloat16)
            ws = [w] + [synth_qtensor(rng, kind, (n, k)).to("cuda")
                        for _ in range(n_copies(w.nbytes) - 1)]
            dense = [dequant(wi, torch.bfloat16) for wi in ws[:n_copies(n * k * 2)]]
            ms = time_ms(qmm, [(x, wi) for wi in ws])
            pms = time_ms(qmm_plain, [(x, wi) for wi in ws], iters=5)
            # yardstick: PyTorch alone on the same packed inputs (dequant, then
            # a bf16 matmul); the dense bf16 matmul alone is printed beside it
            lms = time_ms(lambda a, wi: torch.matmul(a, dequant(wi, torch.bfloat16).T),
                          [(x, wi) for wi in ws], iters=10)
            dms = time_ms(lambda a, m: torch.matmul(a, m.T), [(x, d) for d in dense])
            print(f"  qmm_{kind_name} N={n} K={k} B=1: kernel {ms:.4f} ms, plain {pms:.4f} ms, "
                  f"dequant+matmul {lms:.4f} ms, matmul on dense bf16 {dms:.4f} ms, "
                  f"{w.nbytes / ms / 1e6:.0f} GB/s, {calls} calls/token")
            t["ms"] += calls * ms
            t["plain_ms"] += calls * pms
            t["library_ms"] += calls * lms
            t["bytes"] += calls * (w.nbytes + x.numel() * 2 + n * 4)
            t["flops"] += calls * 2.0 * n * k
            del ws, dense
    rec = records[f"qmm_{kind_name}"]
    rec["max_abs_err"] = max(rec.get("max_abs_err", 0.0), worst)
    rec["max_nmse"] = max(rec.get("max_nmse", 0.0), worst_nmse)
    if t["ms"]:  # per decode token of the path that uses this kind
        bms, by = bound_ms(t["bytes"], t["flops"])
        rec.update(ms=t["ms"], plain_ms=t["plain_ms"], library_ms=t["library_ms"],
                   bound_ms=bms, bound_by=by)


FLASH_ATOL = 2e-3  # bf16 cache, f32 math in both; sums in another order
# per slot: the kernel reads 1.7e-13 at most and a dropped row 8e-4 at least
# (H100, this script's inputs), so the limit sits far from both
FLASH_NMSE_TOL = 1e-8


def check_flash_decode(records):
    import torch
    import torch.nn.functional as F

    from llama_cpp_dsp_tpu_torch.ops.kernels.attention import flash_decode, flash_decode_plain

    gen = torch.Generator(device="cuda").manual_seed(1)
    b, h, d, s = 4, 32, 128, 512
    lengths = torch.tensor([512, 1, 300, 77], dtype=torch.int32, device="cuda")
    worst = worst_nmse = 0.0
    for hkv in (32, 8):
        q = torch.randn(b, h, d, generator=gen, device="cuda")
        k = torch.randn(b, hkv, s, d, generator=gen, device="cuda").to(torch.bfloat16)
        v = torch.randn(b, hkv, s, d, generator=gen, device="cuda").to(torch.bfloat16)
        for label, starts, cap in (("full", None, 0.0),
                                   ("swa", torch.tensor([0, 0, 100, 50], dtype=torch.int32,
                                                        device="cuda"), 0.0),
                                   ("softcap", None, 30.0)):
            got = flash_decode(q, k, v, lengths, starts, scale=d ** -0.5, softcap=cap)
            want = flash_decode_plain(q, k, v, lengths, starts, scale=d ** -0.5, softcap=cap)
            st = torch.zeros_like(lengths) if starts is None else starts
            faults = {"first row dropped": flash_decode_plain(
                          q, k, v, lengths, st + 1, scale=d ** -0.5, softcap=cap),
                      "last row dropped": flash_decode_plain(
                          q, k, v, lengths - 1, starts, scale=d ** -0.5, softcap=cap)}
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            worst = max(worst, err)
            print(f"  flash_decode Hkv={hkv} {label}: max|kernel-plain| {err:.3e} "
                  f"(atol {FLASH_ATOL:g})")
            if not err <= FLASH_ATOL:
                fail(f"flash_decode Hkv={hkv} {label} disagrees with its plain version")
            worst_nmse = max(worst_nmse, check_slots(f"flash_decode Hkv={hkv} {label}", got,
                                                     want, faults, FLASH_NMSE_TOL))
    # time: one 7B layer (B=1, Hkv=32) at a full 512-row context, cold caches
    hkv, L = 32, 512
    one = torch.tensor([L], dtype=torch.int32, device="cuda")
    kv_bytes = 2 * hkv * L * d * 2
    sets = []
    for _ in range(n_copies(kv_bytes)):
        q = torch.randn(1, h, d, generator=gen, device="cuda")
        k = torch.randn(1, hkv, L, d, generator=gen, device="cuda").to(torch.bfloat16)
        v = torch.randn(1, hkv, L, d, generator=gen, device="cuda").to(torch.bfloat16)
        sets.append((q, k, v))
    ms = time_ms(lambda q, k, v: flash_decode(q, k, v, one, scale=d ** -0.5), sets)
    pms = time_ms(lambda q, k, v: flash_decode_plain(q, k, v, one, scale=d ** -0.5), sets)
    lms = time_ms(lambda q, k, v: F.scaled_dot_product_attention(
        q.to(torch.bfloat16)[:, :, None], k, v, scale=d ** -0.5), sets)
    print(f"  flash_decode 7B layer, context {L}: kernel {ms:.4f} ms, plain {pms:.4f} ms, "
          f"sdpa {lms:.4f} ms, {kv_bytes / ms / 1e6:.0f} GB/s")
    bms, by = bound_ms(kv_bytes + 2 * h * d * 4, 4.0 * h * L * d)
    records["flash_decode"].update(max_abs_err=worst, max_nmse=worst_nmse, ms=32 * ms,
                                   plain_ms=32 * pms, library_ms=32 * lms, bound_ms=32 * bms,
                                   bound_by=by)


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
    ms = time_ms(lambda *a: attn_decode_fused(*a, n_heads=h, n_kv_heads=hkv,
                                              scale=d ** -0.5), sets)
    pms = time_ms(lambda x, w, kc, vc, cs, sn, ln: attn_fused_plain(
        x, w, kc, vc, cs, sn, ln, None, ln - 1, n_heads=h, n_kv_heads=hkv, scale=d ** -0.5),
        sets, iters=5)
    print(f"  attn_fused 7B layer, context {L + 1}: kernel {ms:.4f} ms, plain {pms:.4f} ms, "
          f"{(w_bytes + kv_bytes) / ms / 1e6:.0f} GB/s")
    bms, by = bound_ms(w_bytes + kv_bytes + kdim * 2 + h * d * 4 + 2 * hkv * d * 2,
                       2.0 * (h + 2 * hkv) * d * kdim + 4.0 * h * (L + 1) * d)
    records["attn_fused"].update(max_abs_err=worst, max_nmse=worst_nmse, ms=32 * ms,
                                 plain_ms=32 * pms, library_ms=None, bound_ms=32 * bms,
                                 bound_by=by)


# ---------------------------------------------------------------------------
# paths through the port
# ---------------------------------------------------------------------------

def run_cli(argv: list[str]) -> tuple[str, str]:
    """The port's CLI in this process; returns (stdout text, stderr text)."""
    from llama_cpp_dsp_tpu_torch.tools.cli import main

    out, err = io.BytesIO(), io.StringIO()
    wrapper = io.TextIOWrapper(out, encoding="utf-8", write_through=True)
    with contextlib.redirect_stdout(wrapper), contextlib.redirect_stderr(err):
        rc = main(argv)
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


def profile_chunk(ctx, token: int, steps: int = 8) -> None:
    """Where one decode step's time goes: host wall time of an 8-step greedy
    chunk (no profiler), and the device time of its kernels by name
    (torch.profiler, a second chunk)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    greedy = {"top_k": 1, "top_p": 1.0, "min_p": 0.0, "temp": 1.0}
    ctx._eval_sample_chunk(token, greedy, steps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ctx._eval_sample_chunk(token, greedy, steps)
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ctx._eval_sample_chunk(token, greedy, steps)
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    if not kernels:
        print(f"    wall {wall_ms:.3f} ms/token; device time not measured (no CUDA events)")
        return
    print(f"    wall {wall_ms:.3f} ms/token, device kernels {dev_ms:.3f} ms/token "
          f"(busy {dev_ms / wall_ms:.1%}), {sum(e.count for e in kernels) / steps:.0f} "
          "kernel launches/token; top kernels:")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]:
        print(f"      {e.self_device_time_total / 1e3 / steps:.3f} ms/token "
              f"{e.count / steps:.0f}x  {e.key[:70]}")


def phase_small() -> None:
    import torch

    from llama_cpp_dsp_tpu_torch.gguf.constants import GGMLType
    from llama_cpp_dsp_tpu_torch.models.llama import LlamaConfig
    from llama_cpp_dsp_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from llama_cpp_dsp_tpu_torch.ops.rope import RopeParams
    from llama_cpp_dsp_tpu_torch.runtime.context import LlamaContext
    from llama_cpp_dsp_tpu_torch.runtime.loader import load_model
    from llama_cpp_dsp_tpu_torch.runtime.sampling import make_chain
    from llama_cpp_dsp_tpu_torch.tools.synth import write_synth_gguf

    cfg = LlamaConfig(arch="llama", n_layers=2, n_embd=256, n_heads=2, n_kv_heads=2,
                      head_dim=128, n_ff=512, n_vocab=512, n_ctx_train=128,
                      rope=RopeParams(n_dims=128))
    path = ROOT / "build" / "smoke" / "small-q4_0.gguf"
    path.parent.mkdir(parents=True, exist_ok=True)
    write_synth_gguf(str(path), cfg, GGMLType.Q4_0, seed=5)
    model = load_model(str(path))
    prompt = model.tokenizer.encode("hello world")
    ref = LlamaContext(model, n_ctx=64, device="cpu")
    ref_logits = ref.eval_tokens(prompt)
    ref_stream = list(LlamaContext(model, n_ctx=64, device="cpu").generate(
        prompt, max_new_tokens=12, sampler=make_chain(temp=0)))
    reset_launches()
    ctx = LlamaContext(model, n_ctx=64)
    logits = ctx.eval_tokens(prompt)
    step = ctx.eval_tokens([int(ref_logits.argmax())])
    ref_step = ref.eval_tokens([int(ref_logits.argmax())])
    stream = list(LlamaContext(model, n_ctx=64).generate(
        prompt, max_new_tokens=12, sampler=make_chain(temp=0)))
    counts = dict(LAUNCHES)
    scale = float(abs(ref_logits).max())
    e_pre = float(abs(logits - ref_logits).max()) / scale
    e_dec = float(abs(step - ref_step).max()) / float(abs(ref_step).max())
    print(f"  small model card vs CPU: prefill logits rel err {e_pre:.2e}, decode step "
          f"{e_dec:.2e} (tol 2e-2); stream {stream} vs {ref_stream}")
    require(counts, ["qmm_q4_0", "attn_fused"], "small")
    if not (e_pre < 2e-2 and e_dec < 2e-2 and torch.isfinite(torch.from_numpy(step)).all()):
        fail("small model on the card disagrees with the CPU path")
    n_same = next((i for i, (a, b) in enumerate(zip(stream, ref_stream)) if a != b),
                  len(stream))
    print(f"  small model greedy stream: {n_same}/{len(stream)} leading tokens agree")
    path.unlink()


def phase_main(records: dict) -> None:
    import numpy as np
    import torch

    from llama_cpp_dsp_tpu_torch.gguf.constants import GGMLType
    from llama_cpp_dsp_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from llama_cpp_dsp_tpu_torch.runtime.context import LlamaContext
    from llama_cpp_dsp_tpu_torch.runtime.loader import load_model
    from llama_cpp_dsp_tpu_torch.runtime.sampling import make_chain
    from llama_cpp_dsp_tpu_torch.tools.synth import LLAMA2_7B, write_synth_gguf

    cfg = LLAMA2_7B  # full width and depth
    path = ROOT / "build" / "smoke" / "llama2-7b-q4_0.gguf"
    path.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    write_synth_gguf(str(path), cfg, GGMLType.Q4_0, seed=0)
    print(f"  wrote {path.name} ({path.stat().st_size / 1e9:.2f} GB, {cfg.n_layers} layers) "
          f"in {time.perf_counter() - t0:.1f} s")
    argv = ["-m", str(path), "-p", "hello", "-n", "32", "--temp", "0", "-c", "512"]
    reset_launches()
    _, err = run_cli(argv)
    counts = dict(LAUNCHES)
    require(counts, ["qmm_q4_0", "attn_fused"], "main (fused)")
    records["qmm_q4_0"]["launches"] = counts["qmm_q4_0"]
    records["attn_fused"]["launches"] = counts["attn_fused"]
    print(f"  main path (fused attention): {decode_tps(err):.2f} tokens/s decode")

    model = load_model(str(path))
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
    del model
    path.unlink()


def phase_q8(records: dict) -> None:
    from llama_cpp_dsp_tpu_torch.gguf.constants import GGMLType
    from llama_cpp_dsp_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from llama_cpp_dsp_tpu_torch.tools.synth import TINYLLAMA_1B, write_synth_gguf

    path = ROOT / "build" / "smoke" / "tinyllama-q8_0.gguf"
    path.parent.mkdir(parents=True, exist_ok=True)
    write_synth_gguf(str(path), TINYLLAMA_1B, GGMLType.Q8_0, seed=1)
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
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {','.join(PHASES)}")
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
    t0 = time.perf_counter()
    build.lib()
    print(f"[build] {time.perf_counter() - t0:.1f} s")
    for line in build.build_log.splitlines():
        if "registers" in line or "bytes stack" in line or line.startswith("=="):
            print("  " + line.strip())
    records = {name: {"launches": 0} for name in SOURCES}
    steps = [("kernels", lambda: (check_qmm("q4_0", QMM_SHAPES_7B, (1, 8, 128),
                                            DECODE_CALLS_7B, records),
                                  check_qmm("q8_0", QMM_SHAPES_7B, (1, 8, 128), {}, records),
                                  check_qmm("q8_0", list(DECODE_CALLS_TINYLLAMA), (1,),
                                            DECODE_CALLS_TINYLLAMA, records),
                                  check_flash_decode(records), check_attn_fused(records))),
             ("small", phase_small),
             ("main", lambda: phase_main(records)),
             ("q8", lambda: phase_q8(records))]
    for name, fn in steps:
        if name in phases:
            t0 = time.perf_counter()
            print(f"[{name}]", flush=True)
            fn()
            print(f"[{name}] done in {time.perf_counter() - t0:.1f} s", flush=True)
    print(f"total {time.perf_counter() - t_start:.1f} s")
    kernels = []
    for name, (src, replaces, tol) in SOURCES.items():
        r = records[name]
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": r["launches"], "max_abs_err": r.get("max_abs_err"),
                        "max_nmse": r.get("max_nmse"), "tolerance": tol,
                        "ms": r.get("ms"), "plain_ms": r.get("plain_ms"),
                        "bound_ms": r.get("bound_ms"), "bound_by": r.get("bound_by"),
                        "library_ms": r.get("library_ms")})
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
