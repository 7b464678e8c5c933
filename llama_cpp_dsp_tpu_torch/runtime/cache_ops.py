"""KV-cache sequence surgery (counterpart of the JAX package's
runtime/cache_ops.py), cut to what the serving engine needs: `copy_slot`
for cross-slot prompt-cache reuse. Context shift, self-extend and the other
edits are queued in ROADMAP.md queue A2.
"""

from __future__ import annotations

from .kv_cache import _PlaneCache


def copy_slot(cache, src_slot: int, dst_slot: int) -> None:
    """seq_cp: copy one slot's cells into another slot, in place, in every
    buffer of every layer (reference llama_kv_self_seq_cp)."""
    if not isinstance(cache, _PlaneCache):
        raise TypeError(f"copy_slot: {type(cache).__name__} is not a contiguous cache")
    for buf in cache.planes():
        buf[dst_slot].copy_(buf[src_slot])
