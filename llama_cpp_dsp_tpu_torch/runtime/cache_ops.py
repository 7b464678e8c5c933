"""KV-cache sequence surgery (counterpart of the JAX package's
runtime/cache_ops.py), cut to what the serving engine needs: `copy_slot`
for cross-slot prompt-cache reuse. Context shift, self-extend and the other
edits are queued in ROADMAP.md queue A2.
"""

from __future__ import annotations

from .kv_cache import KVCache, QuantKVCache


def copy_slot(cache: KVCache | QuantKVCache, src_slot: int, dst_slot: int) -> None:
    """seq_cp: copy one slot's cells into another slot, in place, in every
    layer's buffers (reference llama_kv_self_seq_cp)."""
    if isinstance(cache, QuantKVCache):
        planes = (cache.k_qs, cache.k_d, cache.v_qs, cache.v_d)
    else:
        planes = (cache.k, cache.v)
    for bufs in planes:
        for buf in bufs:
            buf[dst_slot].copy_(buf[src_slot])
