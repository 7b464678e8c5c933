"""Contiguous KV cache (counterpart of the JAX package's runtime/kv_cache.py
`KVCache` and `causal_mask`).

One bf16 buffer per layer, [B, Hkv, S, D] (the other cache types are
queued in ROADMAP.md) — the reference's per-layer
k_l / v_l tensors. The JAX package updates donated buffers functionally;
here new rows are written in place, so the kernels' operands are the layer
buffers themselves.
"""

from __future__ import annotations

import torch


class KVCache:
    def __init__(self, k: list[torch.Tensor], v: list[torch.Tensor]):
        self.k = k  # L × [B, Hkv, S, D]
        self.v = v

    @classmethod
    def create(cls, n_layers: int, n_batch: int, n_ctx: int, n_kv_heads: int, head_dim: int,
               device="cpu") -> "KVCache":
        shape = (n_batch, n_kv_heads, n_ctx, head_dim)
        return cls(
            [torch.zeros(shape, dtype=torch.bfloat16, device=device) for _ in range(n_layers)],
            [torch.zeros(shape, dtype=torch.bfloat16, device=device) for _ in range(n_layers)])

    @property
    def capacity(self) -> int:
        return self.k[0].shape[2]

    def write(self, layer: int, k_new: torch.Tensor, v_new: torch.Tensor, offset: int) -> None:
        """Write [B, T, Hkv, D] rows at sequence offset `offset`, in place."""
        t = k_new.shape[1]
        if not 0 <= offset <= self.capacity - t:
            raise IndexError(f"cache write rows [{offset}, {offset + t}) outside "
                             f"capacity {self.capacity}")
        self.k[layer][:, :, offset:offset + t] = k_new.transpose(1, 2)
        self.v[layer][:, :, offset:offset + t] = v_new.transpose(1, 2)

    def layer(self, i: int) -> tuple[torch.Tensor, torch.Tensor]:
        """(k, v) as [B, Hkv, S, D] — the layer's own buffers."""
        return self.k[i], self.v[i]


def causal_mask(positions: torch.Tensor, n_kv: int, n_past: int) -> torch.Tensor:
    """[B, T] query positions → [B, T, n_kv] bool mask: key cell j is
    attendable iff j < n_past + T (written) and j <= the query position."""
    t = positions.shape[1]
    j = torch.arange(n_kv, device=positions.device)
    written = j[None, None, :] < (n_past + t)
    causal = j[None, None, :] <= positions[:, :, None]
    return written & causal
