"""Hand-written Hopper kernels and their plain PyTorch versions.

Each wrapper takes the plain version only when its tensors lie on the CPU;
on CUDA tensors it launches its kernel or raises. `LAUNCHES` counts kernel
launches per wrapper (process-wide, so a run can show that the main path
went through the kernels); `reset_launches()` sets every count to 0.
"""

from __future__ import annotations

LAUNCHES: dict[str, int] = {
    "qmm_q4_0": 0,
    "qmm_q8_0": 0,
    "flash_decode": 0,
    "attn_fused": 0,
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def aligned16(t):
    """t, or a copy of it where its data does not start on a 16-byte
    boundary: the kernels read their inputs in 16-byte vectors."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def stream_handle(t) -> int:
    """PyTorch's current stream on the tensor's device, as a raw pointer."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
