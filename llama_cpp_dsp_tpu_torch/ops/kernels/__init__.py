"""Hand-written Hopper kernels and their plain PyTorch versions.

Each wrapper takes the plain version only when its tensors lie on the CPU;
on CUDA tensors it launches its kernel or raises. `LAUNCHES` counts kernel
launches per wrapper (process-wide, so a run can show that the main path
went through the kernels); `reset_launches()` sets every count to 0.
"""

from __future__ import annotations

LAUNCHES: dict[str, int] = {
    "qmm_q4_0": 0,
    "qmm_q4_1": 0,
    "qmm_q5_0": 0,
    "qmm_q5_1": 0,
    "qmm_q8_0": 0,
    "qmm_q2_k": 0,
    "qmm_q3_k": 0,
    "qmm_q4_k": 0,
    "qmm_q5_k": 0,
    "qmm_q6_k": 0,
    "qmm_experts_q4_0": 0,
    "qmm_experts_q4_1": 0,
    "qmm_experts_q5_0": 0,
    "qmm_experts_q5_1": 0,
    "qmm_experts_q8_0": 0,
    "qmm_experts_q2_k": 0,
    "qmm_experts_q3_k": 0,
    "qmm_experts_q4_k": 0,
    "qmm_experts_q5_k": 0,
    "qmm_experts_q6_k": 0,
    # the IQ / TQ kinds: one count per kind (the C entries are shared by kinds
    # of one group size and scale type)
    **{f"qmm{part}_{kind}": 0 for part in ("", "_experts")
       for kind in ("iq4_nl", "iq4_xs", "iq2_xxs", "iq2_xs", "iq2_s", "iq3_xxs", "iq3_s",
                    "iq1_s", "iq1_m", "tq1_0", "tq2_0")},
    "flash_decode": 0,
    "flash_decode_q8": 0,
    "flash_decode_q4": 0,
    "flash_decode_paged": 0,
    "flash_decode_paged_q8": 0,
    "flash_prefill": 0,
    "attn_fused": 0,
    "mla_decode": 0,
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
