"""Session and slot state save / load (counterpart of the JAX package's
runtime/state_io.py, reference llama_state_save_file / llama_state_seq_*):
the token history plus the populated KV rows, for the CLI's --prompt-cache
and the server's POST /slots/{id}?action=save|restore.

The file is the JAX package's: an npz with a JSON `meta` (the same MAGIC,
the model's dims, n_past, the rows' dtype and the tokens) and K/V arrays
[L, 1, Hkv, n_past, D] trimmed to n_past. bf16 rows are stored as their
uint16 bits with dtype "bfloat16", so no ml_dtypes is needed; a file written
by either package loads in the other. A dense cache saves its rows as
stored. A quantized one (and any mixed pair) saves them dequantized in f32,
where JAX saves bf16: re-quantizing f32 rows on restore gives back a q4_0
row's codes and scales exactly, so a restored slot continues as the saved
one did. Restoring into a quantized cache re-quantizes the rows through its
`write`.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from .kv_cache import KVCache
from .paged_kv import PagedKVCache

MAGIC = "llama_cpp_dsp_tpu-state-v1"
_NAMES = {torch.bfloat16: "bfloat16", torch.float16: "float16", torch.float32: "float32"}


def _meta(cfg, n_past: int, tokens: list[int], dtype: torch.dtype) -> str:
    return json.dumps({
        "magic": MAGIC,
        "arch": cfg.arch,
        "n_layers": cfg.n_layers,
        "n_kv_heads": cfg.n_kv_heads,
        "head_dim": cfg.head_dim,
        "n_past": n_past,
        "dtype": _NAMES[dtype],
        "tokens": list(map(int, tokens)),
    })


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_numpy(a: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a).astype(np.dtype(dtype_name), copy=True))


def _save(path: str, cfg, n: int, tokens, k: torch.Tensor, v: torch.Tensor) -> None:
    with open(path, "wb") as f:
        np.savez_compressed(f, meta=_meta(cfg, n, tokens, k.dtype), k=_to_numpy(k),
                            v=_to_numpy(v))


def _read(path: str, cfg, n_ctx: int, device):
    """(meta, k, v) of a state file for a model of config cfg: the magic and
    the model's dims must match, and n_past fit n_ctx."""
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(str(data["meta"]))
        if meta.get("magic") != MAGIC:
            raise ValueError(f"not a state file: {path}")
        for key in ("n_layers", "n_kv_heads", "head_dim"):
            want = getattr(cfg, key)
            if meta[key] != want:
                raise ValueError(f"state mismatch: {key}={meta[key]}, model has {want}")
        n = int(meta["n_past"])
        if n > n_ctx:
            raise ValueError(f"state has {n} cells, context only {n_ctx}")
        k = _from_numpy(data["k"], meta["dtype"]).to(device)
        v = _from_numpy(data["v"], meta["dtype"]).to(device)
    return meta, k, v


def _rows(cache, n_layers: int, n: int):
    """Rows [L, B, Hkv, n, D] of a contiguous cache: a dense one as stored,
    any other dequantized in f32."""
    if isinstance(cache, KVCache):
        pairs = [cache.layer(i) for i in range(n_layers)]
    else:  # a dense plane of a mixed pair comes as stored: widen it too
        pairs = [[t.float() for t in cache.layer(i, torch.float32)] for i in range(n_layers)]
    return (torch.stack([k[:, :, :n] for k, _ in pairs]),
            torch.stack([v[:, :, :n] for _, v in pairs]))


def _fill(cache, n_layers: int, k: torch.Tensor, v: torch.Tensor) -> None:
    """Rows [L, B, Hkv, n, D] into rows 0..n-1 of a contiguous cache (or a
    slot's view of one), through its `write`: copied into a dense plane,
    quantized into any other."""
    if not k.shape[3]:
        return
    for i in range(n_layers):
        cache.write(i, k[i].transpose(1, 2), v[i].transpose(1, 2), 0)


def save_state(ctx, path: str, tokens: list[int]) -> None:
    """Save a LlamaContext's session: the tokens and its n_past rows."""
    k, v = _rows(ctx.cache, ctx.cfg.n_layers, ctx.n_past)
    _save(path, ctx.cfg, ctx.n_past, tokens, k, v)


def load_state(ctx, path: str) -> list[int]:
    """Restore a session into `ctx` (rows 0..n_past-1); returns the saved
    token history."""
    meta, k, v = _read(path, ctx.cfg, ctx.n_ctx, ctx.device)
    _fill(ctx.cache, ctx.cfg.n_layers, k, v)
    ctx.n_past = int(meta["n_past"])
    return [int(t) for t in meta["tokens"]]


def _slot_rows(engine, idx: int, n: int):
    """Slot idx's rows [L, 1, Hkv, n, D], whatever the engine's layout."""
    cache = engine.cache
    if engine.kv_layout == "paged":
        engine._ensure_pages([(idx, max(n, 1))])
        k, v = (cache.gather_seq(idx) if isinstance(cache, PagedKVCache)
                else cache.gather_seq(idx, torch.float32))
        return k[:, :, :, :n], v[:, :, :, :n]
    return _rows(cache.slot(idx), engine.cfg.n_layers, n)


def save_slot(engine, slot_idx: int, path: str, tokens: list[int]) -> None:
    """Save one slot's rows (0..n_past-1) and `tokens`, the tokens they
    hold (reference server slot save)."""
    n = engine.slots[slot_idx].n_past
    k, v = _slot_rows(engine, slot_idx, n)
    _save(path, engine.cfg, n, tokens, k, v)


def load_slot(engine, slot_idx: int, path: str) -> list[int]:
    """Restore a saved slot into the free slot `slot_idx` (reference server
    slot restore); its rows then serve a prompt that starts with the saved
    tokens, as any cached prefix does. Returns the saved tokens."""
    slot = engine.slots[slot_idx]
    if slot.req is not None:
        raise ValueError(f"slot {slot_idx} is busy")
    meta, k, v = _read(path, engine.cfg, engine.n_ctx, engine.device)
    n = int(meta["n_past"])
    cache = engine.cache
    if engine.kv_layout == "paged":  # the slot's own pages (copy-on-write), all of them
        engine._ensure_pages([(slot_idx, engine.n_ctx)])
        engine._cow_from(slot_idx, 0)
        pad = (0, 0, 0, engine.n_ctx - n)
        cache.scatter_seq(slot_idx, torch.nn.functional.pad(k, pad),
                          torch.nn.functional.pad(v, pad))
    else:
        _fill(cache.slot(slot_idx), engine.cfg.n_layers, k, v)
    tokens = [int(t) for t in meta["tokens"]]
    slot.n_past = n
    slot.cache_tokens = tokens if len(tokens) == n else []
    return tokens
