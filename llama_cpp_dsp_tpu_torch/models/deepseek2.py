"""DeepSeek-V2 multi-head latent attention (MLA) on torch tensors
(counterpart of the JAX package's models/deepseek2.py).

The cache holds the compressed latent itself, one "head" of
kv_cache_dim = kv_lora_rank + qk_rope_dim padded to a 128 multiple:
[latent; roped k; 0-pad], written into both planes of the `KVCache`, as the
JAX package writes it. The key up-projection W_uk is absorbed into the
query (q_nope·(W_uk c) = (W_ukᵀ q_nope)·c), so attention runs over the
latents, and W_uv is applied to the attention-weighted latent after.
The latent entry goes into whatever cache -ctk / -ctv made (quantized
caches quantize it as any row). Decode (T = 1 over a bf16 `KVCache`) runs
the latent-attention kernel (`ops/kernels/attention.py::mla_flash_decode`,
B10); prefill and the other caches (f16, f32, q8_0, q4_0, ..., read through
`cache.layer`) take the plain einsum path, as the JAX package's XLA path
does for its quantized caches.

The surrounding layer (norms, the dense FFN of the leading layers, MoE
with shared experts) is the generic one of models/llama.py.
"""

from __future__ import annotations

import math

import torch

from ..ops import QTensor, dequant, qmm, rms_norm, softmax_f32
from ..ops.rope import apply_rope
from ..runtime.kv_cache import KVCache, causal_mask


def split_kv_b(params: dict, cfg) -> None:
    """Replace each layer's attn_kv_b [H·(dn+dv), r] by W_uk [H, dn, r] and
    W_uv [H, dv, r] ("attn_kv_b_uk", "attn_kv_b_uv"), bf16 and contiguous:
    the values JAX's `_dense` gives at every step (a packed weight
    dequantized to bf16, a dense one cast to bf16), made once. The loader
    calls it for an MLA model; a params tree carried across from the JAX
    package goes through it too."""
    h, dn, dv, r = cfg.n_heads, cfg.qk_nope_dim, cfg.v_head_dim, cfg.kv_lora_rank
    for layer in params["layers"]:
        w = layer.pop("attn_kv_b")
        wd = dequant(w, torch.bfloat16) if isinstance(w, QTensor) else w.to(torch.bfloat16)
        wkv_b = wd.reshape(h, dn + dv, r)
        layer["attn_kv_b_uk"] = wkv_b[:, :dn].contiguous()
        layer["attn_kv_b_uv"] = wkv_b[:, dn:].contiguous()


def mla_self_attention(x: torch.Tensor, layer: dict, cfg, positions: torch.Tensor, cache,
                       layer_idx: int, n_past) -> torch.Tensor:
    """Absorbed-MLA attention of the normed input x [B, T, C]; writes the
    new latent rows into `cache` (rows n_past .., or a [B] offset per slot
    at T = 1) and returns the attention output projection [B, T, C] f32."""
    from .llama import COMPUTE_DTYPE

    b, t, _ = x.shape
    h, r = cfg.n_heads, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    cpad = cfg.kv_cache_dim

    # queries
    if cfg.q_lora_rank and "attn_q_a" in layer:
        qa = rms_norm(qmm(x, layer["attn_q_a"]), layer["attn_q_a_norm"], cfg.rms_eps)
        q = qmm(qa, layer["attn_q_b"])
    else:
        q = qmm(x, layer["attn_q"])
    q = q.reshape(b, t, h, dn + dr)
    q_nope, q_rope = q[..., :dn], apply_rope(q[..., dn:], positions, cfg.rope)

    # the latent KV entry [latent; roped k; 0-pad], written in place
    kv = qmm(x, layer["attn_kv_a_mqa"])  # [B, T, r + dr]
    latent = rms_norm(kv[..., :r], layer["attn_kv_a_norm"], cfg.rms_eps)
    k_rope = apply_rope(kv[..., None, r:], positions, cfg.rope)[..., 0, :]
    entry = torch.cat([latent, k_rope], dim=-1)[:, :, None, :]  # [B, T, 1, r + dr]
    if cpad > r + dr:
        entry = torch.nn.functional.pad(entry, (0, cpad - r - dr))
    cache.write(layer_idx, entry, entry, n_past)

    # absorb W_uk into q (bf16 weights, f32 products as JAX's einsum)
    w_uk, w_uv = layer["attn_kv_b_uk"].float(), layer["attn_kv_b_uv"].float()
    q_lat = torch.einsum("bthn,hnr->bthr", q_nope.float(), w_uk)  # [B, T, H, r]
    scale = 1.0 / math.sqrt(dn + dr) * cfg.rope.attn_factor ** 2

    if t == 1 and type(cache) is KVCache and cache.k[layer_idx].dtype == torch.bfloat16:
        # one pass over the cached latents gives the scores and the weighted
        # latent sum: score = [q_lat; q_rope; 0]·[latent; k_rope; 0]
        from ..ops.kernels.attention import mla_flash_decode

        q_cat = torch.cat([q_lat[:, 0], q_rope[:, 0].float()], dim=-1)
        if cpad > r + dr:
            q_cat = torch.nn.functional.pad(q_cat, (0, cpad - r - dr))
        attn_lat = mla_flash_decode(q_cat, cache.k[layer_idx], positions[:, 0] + 1,
                                    scale=scale, r=r)[:, None]  # [B, 1, H, r]
    else:
        kc = cache.layer(layer_idx)[0][:, 0].float()  # [B, S, cpad]
        lat_c, rope_c = kc[..., :r], kc[..., r:r + dr]
        scores = (torch.einsum("bthr,bsr->bhts", q_lat, lat_c)
                  + torch.einsum("bthd,bsd->bhts", q_rope.float(), rope_c)) * scale
        mask = causal_mask(positions, kc.shape[1], n_past)
        scores = scores + torch.where(mask, 0.0, torch.finfo(torch.float32).min)[:, None]
        attn_lat = torch.einsum("bhts,bsr->bthr", softmax_f32(scores, dim=-1), lat_c)
    out = torch.einsum("bthr,hvr->bthv", attn_lat, w_uv).reshape(b, t, h * dv)
    return qmm(out.to(COMPUTE_DTYPE), layer["attn_output"])
