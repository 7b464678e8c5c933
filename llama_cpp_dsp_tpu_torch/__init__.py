"""PyTorch / CUDA port of llama_cpp_dsp_tpu.

The same GGUF inference path as the JAX package, on torch tensors, with the
TPU's Pallas kernels rewritten by hand in CUDA C++ for Hopper (sm_90a,
sources under `csrc/`, built at first use by `ops/kernels/build.py`).

Entry points run on the card unless the caller asks for the CPU: a CPU run
takes each kernel's plain PyTorch version and exists for the tests.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` means the card. Asking for CUDA without one raises instead of
    quietly running on the CPU; pass `device="cpu"` for a CPU run."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: torch.cuda.is_available() is False. Pass "
            "device='cpu' (CLI: --device cpu) to run the plain PyTorch path.")
    return dev
