"""Build and load the port's CUDA kernels.

`csrc/*.cu` compile for Hopper (`-gencode arch=compute_90a,code=sm_90a`)
with one `nvcc -c` per source, all started together, and link into
`build/kernels/libkernels.so` beside the package (a directory `.gitignore`
lists). The library has a plain C interface and is bound with ctypes; its
sources do not include PyTorch's headers, so a build takes seconds. A digest
of the sources and flags, kept next to the library, decides whether the
next call rebuilds.

Nothing here runs at import: the first kernel launch calls `lib()`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_U = ctypes.c_uint32
# C entry → argument types (pointers and the stream as c_void_p)
_SIGNATURES = {
    "qmm_q4_0": [_P, _P, _P, _P, _I, _I, _I, _P],
    "qmm_q8_0": [_P, _P, _P, _P, _I, _I, _I, _P],
    "qmm_q4_1": [_P] * 5 + [_I] * 3 + [_P],  # x, qs, d, m, y
    "qmm_q5_0": [_P] * 5 + [_I] * 3 + [_P],  # x, qs, qh, d, y
    "qmm_q5_1": [_P] * 6 + [_I] * 3 + [_P],  # x, qs, qh, d, m, y
    "qmm_q2_k": [_P] * 7 + [_I] * 3 + [_P],  # x, qs, sc, mn, d, dmin, y
    "qmm_q3_k": [_P] * 6 + [_I] * 3 + [_P],  # x, qs, hmask, sc, d, y
    "qmm_q4_k": [_P] * 7 + [_I] * 3 + [_P],  # x, qs, sc, mn, d, dmin, y
    "qmm_q5_k": [_P] * 8 + [_I] * 3 + [_P],  # x, qs, qh, sc, mn, d, dmin, y
    "qmm_q6_k": [_P] * 6 + [_I] * 3 + [_P],  # x, ql, qh, sc, d, y
    # the table kinds: x, qs, d, the table's four words, y; B, N, K
    **{f"qmm_{t}": [_P] * 3 + [_U] * 4 + [_P] + [_I] * 3 + [_P]
       for t in ("tab32_f16", "tab32_f32", "tab16_f32")},
    # MoE selected-expert GEMV: x, sel, the kind's fields, y; S, E, N, K
    "qmm_experts_q4_0": [_P] * 5 + [_I] * 4 + [_P],
    "qmm_experts_q8_0": [_P] * 5 + [_I] * 4 + [_P],
    "qmm_experts_q4_1": [_P] * 6 + [_I] * 4 + [_P],
    "qmm_experts_q5_0": [_P] * 6 + [_I] * 4 + [_P],
    "qmm_experts_q5_1": [_P] * 7 + [_I] * 4 + [_P],
    "qmm_experts_q2_k": [_P] * 8 + [_I] * 4 + [_P],
    "qmm_experts_q3_k": [_P] * 7 + [_I] * 4 + [_P],
    "qmm_experts_q4_k": [_P] * 8 + [_I] * 4 + [_P],
    "qmm_experts_q5_k": [_P] * 9 + [_I] * 4 + [_P],
    "qmm_experts_q6_k": [_P] * 7 + [_I] * 4 + [_P],
    **{f"qmm_experts_{t}": [_P] * 4 + [_U] * 4 + [_P] + [_I] * 4 + [_P]
       for t in ("tab32_f16", "tab32_f32", "tab16_f32")},
    # q, k, v, lengths, starts, out; B, H, Hkv, D, S, row type, cluster
    "flash_decode": [_P] * 6 + [_I] * 7 + [_F, _F, _P],
    "flash_decode_q8": [_P] * 10 + [_I] * 6 + [_F, _F, _P],
    "flash_decode_q4": [_P] * 10 + [_I] * 6 + [_F, _F, _P],
    # ... tables ...; B, H, Hkv, D, ps, max_blocks, n_pages, pages_per_split, row type
    "flash_decode_paged": [_P] * 9 + [_I] * 9 + [_F, _F, _P],
    # q, kq, kd, vq, vd, tables, lengths, starts, out; B, H, Hkv, D, ps,
    # max_blocks, n_pages, cluster
    "flash_decode_paged_q8": [_P] * 9 + [_I] * 8 + [_F, _F, _P],
    # q, k, v, n_past, out; B, T, H, Hkv, D, S, row type, window, attn_chunk
    "flash_prefill": [_P] * 5 + [_I] * 9 + [_F, _F, _P],
    # q, c, lengths, out, ws_acc, ws_ml; B, H, C, r, S, split_rows; scale
    "mla_decode": [_P] * 6 + [_I] * 7 + [_F, _P],
    "attn_fused_q4_0": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                        _I, _I, _I, _I, _I, _F, _F, _P],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_log = ""  # ptxas register / shared-memory report of the last build


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")
    return path


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()


def build() -> Path:
    """Compile csrc/ into build/kernels/libkernels.so unless it is current."""
    global build_log
    sources = sorted(CSRC.glob("*.cu"))
    so = BUILD_DIR / "libkernels.so"
    stamp = BUILD_DIR / "libkernels.so.sha256"
    digest = _digest()
    if so.exists() and stamp.exists() and stamp.read_text() == digest:
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    objs = [BUILD_DIR / (src.stem + ".o") for src in sources]
    t0 = time.monotonic()
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources, objs)]
    ended = {}  # source → (compiler output, seconds from the start to its end)

    def wait(src, p):
        out, _ = p.communicate()
        ended[src] = (out, time.monotonic() - t0)

    waiters = [threading.Thread(target=wait, args=a) for a in zip(sources, procs)]
    for w in waiters:
        w.start()
    for w in waiters:
        w.join()
    logs, failed = [], []
    for src, p in zip(sources, procs):
        out, secs = ended[src]
        logs.append(f"== {src.name} ({secs:.1f} s)\n{out}")
        if p.returncode:
            failed.append(src.name)
    build_log = "\n".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n{build_log}")
    tmp = BUILD_DIR / f"libkernels.so.tmp{os.getpid()}"
    link = subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
                           "-o", str(tmp), *map(str, objs)],
                          capture_output=True, text=True)
    if link.returncode:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    os.replace(tmp, so)
    stamp.write_text(digest)
    return so


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, args in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = args
                fn.restype = ctypes.c_int
            handle.kernels_error_string.argtypes = [ctypes.c_int]
            handle.kernels_error_string.restype = ctypes.c_char_p
            _lib = handle
        return _lib


def check(rc: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry."""
    if rc:
        msg = lib().kernels_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")
