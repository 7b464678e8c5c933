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
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry → argument types (pointers and the stream as c_void_p)
_SIGNATURES = {
    "qmm_q4_0": [_P, _P, _P, _P, _I, _I, _I, _P],
    "qmm_q8_0": [_P, _P, _P, _P, _I, _I, _I, _P],
    "flash_decode": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _P],
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
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources, objs)]
    logs, failed = [], []
    for src, p in zip(sources, procs):
        out, _ = p.communicate()
        logs.append(f"== {src.name}\n{out}")
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
