"""On-device token sampling (top-k → top-p → min-p → temp → categorical).

Counterpart of the JAX package's ops/device_sampling.py: for the stateless
default chain only the sampled token id leaves the device. The draws come
from an explicit torch.Generator, so they differ from jax.random's; top_k=1
is argmax with the first-max tie-break, identical in both.
"""

from __future__ import annotations

import math

import torch

# top-k sizes above this go to the host chain
MAX_DEVICE_TOP_K = 512


def sample_logits(logits: torch.Tensor, generator: torch.Generator | None, temp: float, *,
                  top_k: int, top_p: float, min_p: float) -> torch.Tensor:
    """logits [B, V] f32 → sampled token ids [B] int64. top-p/min-p
    thresholds use the untempered logits (temp comes after the filters, as
    in the reference chain)."""
    if top_k == 1:
        return torch.argmax(logits, dim=-1)
    vals, idx = torch.topk(logits, top_k, dim=-1)  # sorted descending
    probs0 = torch.softmax(vals, dim=-1)
    cum_before = torch.cumsum(probs0, dim=-1) - probs0
    keep = cum_before < top_p
    keep &= vals >= vals[:, :1] + math.log(max(min_p, 1e-30))
    keep[:, 0] = True  # min_keep = 1
    masked = torch.where(keep, vals / max(temp, 1e-6), float("-inf"))
    choice = torch.multinomial(torch.softmax(masked, dim=-1), 1, generator=generator)
    return torch.gather(idx, 1, choice)[:, 0]
