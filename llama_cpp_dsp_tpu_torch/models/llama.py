"""Llama transformer on torch tensors (counterpart of the JAX package's
models/llama.py, for the decoder graph of the port's archs).

(embedding × embd_scale, gemma) → rms_norm → q/k/v projection (+ q/k/v
biases when the layer has them, qwen2) → per-head q/k rms norm
(cfg.qk_norm, qwen3, gemma3) → rope (the layer's own: gemma3's SWA layers
take a local base) → attention over the KV cache (softcapped scores and a
sliding window on gemma2 / gemma3's SWA layers) → output projection
(→ attn_post_norm, gemma2/3) → residual → rms_norm → SwiGLU or GeGLU FFN
(or the MoE FFN, `ffn_moe`) (→ ffn_post_norm) → residual; final norm →
lm_head (token_embd when the file has no output.weight) → final logit
softcap (gemma2). Weights are QTensors (packed GGUF blocks) or dense
tensors; matmuls go through ops.qmm, which launches the hand-written
kernels on the card.

DeepSeek-V2 layers (cfg.kv_lora_rank > 0) take multi-head latent attention
(models/deepseek2.py) in place of self_attention.

Decode (T=1) takes the fused attention kernel when `fused` is on, the
cache is the bf16 `KVCache` and the layer fits its scope; otherwise the
decode kernel of the cache's type (head_dim 128 or 256): flash_decode (bf16,
f16 or f32 rows), flash_decode_q8 (q8_0), flash_decode_q4 (q4_0),
flash_decode_paged (bf16, f16 or f32 pages) or flash_decode_paged_q8 (q8_0
pages), an SWA layer's rows starting at max(length − window, 0). A
`MixedKVCache` (a split -ctk / -ctv, or q4_1, q5_0, q5_1, iq4_nl) and Q4_0
pages are dequantized (`cache.layer`) and decoded by flash_decode, as the
JAX package does. Prefill (T>1) over a dense `KVCache` at head_dim 128 or
256 takes flash_prefill (JAX's own gate, without its opt-in switch); other
caches, other head dims and the packed mixed prompt+decode step
(`forward_packed`) take the plain attention, as the JAX package's XLA path
does. `n_past`, the cache write offset, is a scalar or a [B] tensor
(batched decode over slots; an offset of `capacity` leaves an idle slot
untouched). The residual stream follows JAX's dtype promotion: bf16
embeddings, f32 after the first residual add.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Any

import torch

from ..gguf.constants import GGMLType
from ..ops import QTensor, activate, qmm, rms_norm, softcap, softmax_f32, take_rows
from ..ops.kernels.attention import attention_plain as attention
from ..ops.rope import RopeParams, _rope_angles, apply_rope
from ..runtime.kv_cache import KVCache, Q4KVCache, QuantKVCache, causal_mask, window_keep
from ..runtime.paged_kv import PagedKVCache, PagedQuantKVCache
from .deepseek2 import mla_self_attention


@dataclass(frozen=True)
class LlamaConfig:
    arch: str
    n_layers: int
    n_embd: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    n_ff: int
    n_vocab: int
    n_ctx_train: int
    rms_eps: float = 1e-5
    rope: RopeParams = field(default_factory=lambda: RopeParams(n_dims=0))
    qk_norm: bool = False  # per-head q/k rms norm before rope (qwen3, qwen3moe)
    # MoE (JAX models/llama.py:44-45, :68-72, :85); defaults = Mixtral's
    n_expert: int = 0
    n_expert_used: int = 0
    moe_norm_weights: bool = True  # renormalize the top-k router weights
    moe_shared_expert: bool = False  # an always-on expert (ffn_*_shexp)
    moe_gate_shexp: bool = False  # the shared expert sigmoid-gated
    expert_gating: str = "softmax"  # "softmax" | "sigmoid"
    moe_scale: float = 1.0  # scale of the routed weights
    moe_weight_before: bool = False  # router weights scale the expert inputs
    # DeepSeek-V2 multi-head latent attention (JAX models/llama.py:92-98)
    q_lora_rank: int = 0  # 0: a direct q projection (DeepSeek-V2-Lite)
    kv_lora_rank: int = 0  # > 0 enables MLA (models/deepseek2.py)
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    n_dense_layers: int = 0  # leading dense (non-MoE) layers
    # Gemma (JAX models/llama.py:49-69); the defaults are the plain llama graph
    act: str = "silu"  # the gated FFN's activation: "silu" | "gelu" (tanh form)
    tie_embeddings: bool = False  # no output.weight: the LM head is token_embd
    embd_scale: float = 1.0  # gemma: √n_embd, applied to the bf16 embeddings
    attn_logit_softcap: float = 0.0  # gemma2: cap·tanh(score / cap), 50
    final_logit_softcap: float = 0.0  # gemma2: the same on the logits, 30
    post_norms: bool = False  # gemma2/3: attn_post_norm / ffn_post_norm on each branch
    swa_window: int = 0  # sliding-window width (0: full attention everywhere)
    swa_pattern: int = 1  # every swa_pattern-th layer is full attention (gemma3: 6)
    rope_local_base: float = 0.0  # gemma3: the SWA layers' rope base

    def is_swa_layer(self, il: int) -> bool:
        """Layer il attends through a sliding window (gemma2 alternates,
        gemma3 five of six; JAX models/llama.py::is_swa_layer)."""
        return self.swa_window > 0 and (il + 1) % max(self.swa_pattern, 1) != 0

    def layer_window(self, il: int) -> int:
        """Layer il's sliding window in rows, 0 on a full-attention layer."""
        return self.swa_window if self.is_swa_layer(il) else 0

    def layer_rope(self, il: int) -> RopeParams:
        """Layer il's rope: gemma3's SWA layers take the local base with no
        long-context scaling (JAX models/llama.py::_layer_rope)."""
        if self.rope_local_base and self.is_swa_layer(il):
            return dataclasses.replace(self.rope, freq_base=self.rope_local_base,
                                       freq_scale=1.0, ext_factor=0.0)
        return self.rope

    @property
    def kv_cache_heads(self) -> int:
        """KV-cache heads: MLA caches one latent "head"."""
        return 1 if self.kv_lora_rank else self.n_kv_heads

    @property
    def kv_cache_dim(self) -> int:
        """KV-cache row width: MLA caches [latent; roped k; 0-pad], padded
        to a 128 multiple as the JAX package pads it (the pad lanes are zero
        and drop out of every dot product)."""
        if self.kv_lora_rank:
            return -(-(self.kv_lora_rank + self.qk_rope_dim) // 128) * 128
        return self.head_dim


Params = dict[str, Any]
COMPUTE_DTYPE = torch.bfloat16  # activations between the matmuls (as JAX's default)


def ffn_dense(x: torch.Tensor, layer: Params, cfg: LlamaConfig,
              suffix: str = "") -> torch.Tensor:
    """Gated FFN (SwiGLU, or GeGLU with cfg.act "gelu") over
    ffn_{gate,up,down}{suffix} ("_shexp": an MoE's shared expert); a
    row-fused gate|up weight is one qmm call."""
    if not suffix and "ffn_gateup_fused" in layer:
        gu = qmm(x, layer["ffn_gateup_fused"])
        gate, up = gu[..., :cfg.n_ff], gu[..., cfg.n_ff:]
    else:
        gate = qmm(x, layer[f"ffn_gate{suffix}"])
        up = qmm(x, layer[f"ffn_up{suffix}"])
    h = (activate(gate, cfg.act) * up).to(COMPUTE_DTYPE)
    return qmm(h, layer[f"ffn_down{suffix}"])


def _expert_slice(w, eid: int):
    """One expert of a stack: a QTensor's fields or a dense [E, N, K]."""
    return w.expert(eid) if isinstance(w, QTensor) else w[eid]


def ffn_moe(x: torch.Tensor, layer: Params, cfg: LlamaConfig) -> torch.Tensor:
    """MoE FFN (JAX models/llama.py::ffn_moe; reference build_moe_ffn):
    router logits, softmax or sigmoid, top-k (the optional ffn_exp_probs_b
    bias steers only the selection), renormalized and scaled weights, the
    experts' SwiGLU FFNs mixed by those weights, an optional shared expert.

    The branch is a rule of shapes and weight types only, so the CPU takes
    it too: packed expert stacks with b·t·u ≤ min(32, E) rows (decode) run
    the selected-expert GEMV (`qmm_expert_rows`, kernel B9 on the card)
    over the rows repeated per used expert; otherwise (prefill) every expert
    runs over every row and a one-hot of the selection mixes them. The
    selected ids stay on the device: the kernel reads them there."""
    from ..ops.kernels.qmm import qmm_expert_rows

    e, u = cfg.n_expert, cfg.n_expert_used
    logits = qmm(x, layer["ffn_gate_inp"])  # [B, T, E] f32
    if cfg.expert_gating == "sigmoid":
        probs = torch.sigmoid(logits.float())
    else:
        probs = softmax_f32(logits)
    probs_b = layer.get("ffn_exp_probs_b")
    if probs_b is not None:
        _, sel = torch.topk(probs + probs_b.float(), u, dim=-1)
        weights = torch.gather(probs, -1, sel)
    else:
        weights, sel = torch.topk(probs, u, dim=-1)  # [B, T, U]
    if cfg.moe_norm_weights:
        weights = weights / weights.sum(dim=-1, keepdim=True)
    weights = weights * cfg.moe_scale
    gate_w, up_w, down_w = layer["ffn_gate_exps"], layer["ffn_up_exps"], layer["ffn_down_exps"]
    b, t = x.shape[:2]
    stacked = all(isinstance(w, QTensor) and w.n_expert for w in (gate_w, up_w, down_w))
    if stacked and b * t * u <= min(32, e):
        sel_rows = sel.reshape(-1).to(torch.int32)  # [M·U]
        w_rows = weights.reshape(-1, 1).float()
        xr = x.reshape(b * t, -1).repeat_interleave(u, dim=0)  # [M·U, C]
        if cfg.moe_weight_before:
            xr = xr.float() * w_rows
        xr = xr.to(COMPUTE_DTYPE)
        g = qmm_expert_rows(xr, gate_w, sel_rows)
        up = qmm_expert_rows(xr, up_w, sel_rows)
        d = qmm_expert_rows((activate(g, cfg.act) * up).to(COMPUTE_DTYPE), down_w,
                            sel_rows)  # f32
        if not cfg.moe_weight_before:
            d = d * w_rows
        mix = d.reshape(b, t, u, -1).sum(dim=2)
    else:
        def expert_ffn(xin, eid):
            g = qmm(xin, _expert_slice(gate_w, eid))
            up = qmm(xin, _expert_slice(up_w, eid))
            return qmm((activate(g, cfg.act) * up).to(COMPUTE_DTYPE),
                       _expert_slice(down_w, eid))

        onehot = torch.nn.functional.one_hot(sel, e).float() * weights[..., None]  # [B,T,U,E]
        if cfg.moe_weight_before:
            w_full = onehot.sum(dim=2)  # [B, T, E]
            presence = (w_full != 0).float()
            outs = torch.stack([expert_ffn((x.float() * w_full[..., eid, None])
                                           .to(COMPUTE_DTYPE), eid)
                                for eid in range(e)], dim=2)  # [B, T, E, D]
            mix = torch.einsum("bte,bted->btd", presence, outs.float())
        else:
            outs = torch.stack([expert_ffn(x, eid) for eid in range(e)], dim=2)
            mix = torch.einsum("btue,bted->btd", onehot, outs.float())
    if cfg.moe_shared_expert:
        sh = ffn_dense(x, layer, cfg, "_shexp")
        if cfg.moe_gate_shexp:
            g = qmm(x, layer["ffn_gate_inp_shexp"])
            sh = sh * torch.sigmoid(g.float()).to(sh.dtype)
        mix = mix + sh.float()
    return mix.to(x.dtype)


def self_attention(x, layer: Params, cfg: LlamaConfig, positions, cache, layer_idx: int,
                   n_past, fused: bool, memo: dict):
    """QKV → rope → cached attention → output projection. Returns out.
    memo: what the layers of one step share (rope angles, SWA starts)."""
    b, t = x.shape[:2]
    h, d = cfg.n_heads, cfg.head_dim
    if fused and t == 1:
        attn = _try_attn_fused(x, layer, cfg, positions, cache, layer_idx, n_past, memo)
        if attn is not None:
            attn = attn.reshape(b, 1, h * d).to(COMPUTE_DTYPE)
            return qmm(attn, layer["attn_output"])
    q, k, v = _project_qkv(x, layer, cfg, positions, layer_idx)
    return _cached_attention(q, k, v, layer, cfg, positions, cache, layer_idx, n_past, memo)


def _decode_starts(cfg: LlamaConfig, layer_idx: int, positions, memo: dict):
    """The first row each slot's decode query attends on an SWA layer (JAX
    llama.py:670-676): max(length − window, 0); None on a full-attention
    layer."""
    window = cfg.layer_window(layer_idx)
    if not window:
        return None
    key = ("starts", window)
    if key not in memo:
        memo[key] = torch.clamp(positions[:, 0] + 1 - window, min=0).to(torch.int32)
    return memo[key]


def _try_attn_fused(x, layer, cfg, positions, cache, layer_idx, n_past, memo):
    """One-kernel decode attention (ops/kernels/attn_fused.py) when the layer
    is in the kernel's scope: a bf16 KVCache, Q4_0 row-fused QKV without
    q/k/v biases or q/k norm (JAX llama.py:487-491), head_dim 128, full-dim
    NORM rope, B ≤ 8 (attn_fused.in_scope). Returns attn
    [B, H, D] f32 or None. Unlike the JAX gate there is no K % 4096 rule
    and no capacity % 128 rule: both are TPU lane layouts, not limits of
    this kernel, which takes any capacity."""
    from ..ops.kernels.attn_fused import HEAD_DIM, attn_decode_fused, in_scope

    fused = layer.get("attn_qkv_fused")
    h, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    b = x.shape[0]
    if not (isinstance(fused, QTensor) and fused.kind == GGMLType.Q4_0
            and type(cache) is KVCache and cache.k[0].dtype == torch.bfloat16):
        return None
    if cfg.qk_norm or any(f"attn_{part}_bias" in layer for part in "qkv"):
        return None
    rp = cfg.layer_rope(layer_idx)
    if rp.mode != "norm" or rp.n_dims != d or d != HEAD_DIM:
        return None
    if not in_scope(b, h, hkv):
        return None
    ff = layer.get("rope_freqs")
    key = ("angles", id(ff), rp)  # the two rope kinds of a gemma3-style model never share
    if key not in memo:
        memo[key] = _rope_angles(positions[:, 0], rp, ff)
    cos, sin = memo[key]
    lengths = positions[:, 0] + 1
    # per-slot write rows (a scalar n_past broadcasts); the kernel drops a
    # write outside [0, S), which leaves an idle slot's rows untouched
    write_pos = torch.as_tensor(n_past, device=x.device).to(torch.int32).expand(b)
    k_l, v_l = cache.layer(layer_idx)
    return attn_decode_fused(x[:, 0], fused, k_l, v_l, cos, sin, lengths,
                             _decode_starts(cfg, layer_idx, positions, memo), write_pos,
                             n_heads=h, n_kv_heads=hkv, scale=1.0 / math.sqrt(d),
                             softcap=cfg.attn_logit_softcap)


def _project_qkv(x, layer: Params, cfg: LlamaConfig, positions, layer_idx: int):
    """QKV projections (fused or separate), each plus its own bias where the
    layer has one (as JAX's unfused `_mm` and upstream's llama graph; JAX's
    fused branch adds all three only when attn_q_bias is present), the
    per-head q/k rms norm when cfg.qk_norm (a norm weight in a file without
    the flag stays unused, as in JAX), and the layer's rope. Returns
    q [B,T,H,D], k [B,T,Hkv,D], v [B,T,Hkv,D]."""
    b, t, _ = x.shape
    h, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if "attn_qkv_fused" in layer:
        qkv = qmm(x, layer["attn_qkv_fused"])
        q, k, v = qkv[..., :h * d], qkv[..., h * d:(h + hkv) * d], qkv[..., (h + hkv) * d:]
    else:
        q = qmm(x, layer["attn_q"])
        k = qmm(x, layer["attn_k"])
        v = qmm(x, layer["attn_v"])
    biases = (layer.get(f"attn_{part}_bias") for part in "qkv")
    q, k, v = (y if bias is None else y + bias for y, bias in zip((q, k, v), biases))
    q = q.reshape(b, t, h, d)
    k = k.reshape(b, t, hkv, d)
    v = v.reshape(b, t, hkv, d)
    if cfg.qk_norm:
        q = rms_norm(q, layer["attn_q_norm"], cfg.rms_eps)
        k = rms_norm(k, layer["attn_k_norm"], cfg.rms_eps)
    rp = cfg.layer_rope(layer_idx)
    ff = layer.get("rope_freqs")
    q = apply_rope(q, positions, rp, ff)
    k = apply_rope(k, positions, rp, ff)
    return q, k, v


def _cached_attention(q, k, v, layer, cfg: LlamaConfig, positions, cache, layer_idx: int,
                      n_past, memo: dict):
    b, t = q.shape[:2]
    h, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    cache.write(layer_idx, k, v, n_past)
    scale = 1.0 / math.sqrt(d)
    cap = cfg.attn_logit_softcap
    window = cfg.layer_window(layer_idx)
    from ..ops.kernels import attention as ka

    if t == 1 and h % hkv == 0 and d in ka.HEAD_DIMS:
        # decode kernel of the cache's type (JAX llama.py:682-716). The TPU
        # gates capacity % 128 (q8), capacity % 256 (q4) and, for paged q8,
        # page_size % 128 are not carried over: they are Mosaic lane layouts,
        # and these kernels take any capacity and any page size. A mixed
        # cache and Q4_0 pages go through `layer` (dequantized) and
        # flash_decode, as in JAX.
        lengths = positions[:, 0] + 1
        starts = _decode_starts(cfg, layer_idx, positions, memo)
        kw = {"scale": scale, "softcap": cap}
        if isinstance(cache, PagedQuantKVCache):
            attn = ka.flash_decode_paged_q8(q[:, 0], *cache.packed_pages(layer_idx),
                                            cache.tables, lengths, starts, **kw)
        elif isinstance(cache, PagedKVCache):
            attn = ka.flash_decode_paged(q[:, 0], cache.k[layer_idx], cache.v[layer_idx],
                                         cache.tables, lengths, starts, **kw)
        elif isinstance(cache, Q4KVCache):
            attn = ka.flash_decode_q4(q[:, 0], *cache.packed_layer(layer_idx), lengths, starts,
                                      **kw)
        elif isinstance(cache, QuantKVCache):
            attn = ka.flash_decode_q8(q[:, 0], *cache.packed_layer(layer_idx), lengths, starts,
                                      **kw)
        else:
            attn = ka.flash_decode(q[:, 0], *cache.layer(layer_idx), lengths, starts, **kw)
        attn = attn.reshape(b, 1, h * d).to(COMPUTE_DTYPE)
        return qmm(attn, layer["attn_output"])
    if (t > 1 and type(cache) is KVCache and h % hkv == 0 and d in ka.HEAD_DIMS
            and not (torch.is_tensor(n_past) and n_past.dim())):
        # B4 over the dense cache (JAX llama.py:726-766): the rows of a
        # prompt chunk are contiguous from n_past (padding queries of the
        # engine's bucketed chunk attend ≤ their row and are discarded)
        np_vec = torch.full((b,), int(n_past), dtype=torch.int32, device=q.device)
        attn = ka.flash_prefill(q, *cache.layer(layer_idx), np_vec, scale=scale, softcap=cap,
                                swa_window=window)
        return qmm(attn.reshape(b, t, h * d).to(COMPUTE_DTYPE), layer["attn_output"])
    k_all, v_all = cache.layer(layer_idx)
    mask = causal_mask(positions, k_all.shape[2], n_past, window)
    attn = attention(q, k_all, v_all, mask, scale, cap).to(COMPUTE_DTYPE)
    return qmm(attn, layer["attn_output"])


def packed_self_attention(x, layer: Params, cfg: LlamaConfig, positions, cache, layer_idx: int,
                          slot_ids: torch.Tensor):
    """Attention of a packed prompt+decode ubatch (JAX llama.py:807-867):
    x [1, P, C], positions [1, P] = each token's cache row (== capacity for
    padding), slot_ids [P]. K/V are scattered at (slot, row) first (padding
    dropped); every token then attends to its own slot's rows ≤ its row
    (and in its window on an SWA layer), scores softcapped as in `attention`.
    Plain PyTorch, as the JAX package leaves it to XLA: scores over every
    slot, then each token's own slot is gathered."""
    q, k, v = _project_qkv(x, layer, cfg, positions, layer_idx)
    p = q.shape[1]
    h, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    rows = positions[0]
    cache.write_packed(layer_idx, k[0], v[0], slot_ids, rows)
    k_all, v_all = cache.layer(layer_idx)  # [B, Hkv, S, D] (a gather for pages)
    nb, _, s, _ = k_all.shape
    qf = q[0].float().reshape(p, hkv, h // hkv, d)
    scores = torch.einsum("phrd,bhsd->bhrps", qf, k_all.float()) * (1.0 / math.sqrt(d))
    if cfg.attn_logit_softcap:
        scores = softcap(scores, cfg.attn_logit_softcap)
    j = torch.arange(s, device=x.device)
    causal = j[None, :] <= rows[:, None]  # [P, S]
    keep = window_keep(j[None, :], rows[:, None], cfg.layer_window(layer_idx))
    if keep is not None:
        causal = causal & keep
    own = slot_ids[None, :] == torch.arange(nb, device=x.device)[:, None]  # [B, P]
    attend = own[:, :, None] & causal[None]
    bias = torch.where(attend, 0.0, torch.finfo(torch.float32).min)
    probs = softmax_f32(scores + bias[:, None, None], dim=-1)
    out = torch.einsum("bhrps,bhsd->bhrpd", probs, v_all.float())
    sel = out.permute(3, 0, 1, 2, 4)[torch.arange(p, device=x.device), slot_ids.long()]
    attn = sel.reshape(1, p, h * d).to(COMPUTE_DTYPE)
    return qmm(attn, layer["attn_output"])


def decode_layer(x, layer: Params, cfg: LlamaConfig, positions, cache, layer_idx: int, n_past,
                 fused: bool, memo: dict, slot_ids: torch.Tensor | None = None):
    """One block; slot_ids set means a packed mixed ubatch (forward_packed).
    With cfg.post_norms each branch is normed before its residual add."""
    attn_in = rms_norm(x, layer["attn_norm"], cfg.rms_eps)
    if cfg.kv_lora_rank:
        attn = mla_self_attention(attn_in, layer, cfg, positions, cache, layer_idx, n_past)
    elif slot_ids is not None:
        attn = packed_self_attention(attn_in, layer, cfg, positions, cache, layer_idx, slot_ids)
    else:
        attn = self_attention(attn_in, layer, cfg, positions, cache, layer_idx, n_past, fused,
                              memo)
    if cfg.post_norms:
        attn = rms_norm(attn, layer["attn_post_norm"], cfg.rms_eps)
    x = x + attn
    ffn_in = rms_norm(x, layer["ffn_norm"], cfg.rms_eps)
    if cfg.n_expert > 0 and "ffn_gate_exps" in layer:
        ffn = ffn_moe(ffn_in, layer, cfg)
    else:
        ffn = ffn_dense(ffn_in, layer, cfg)
    if cfg.post_norms:
        ffn = rms_norm(ffn, layer["ffn_post_norm"], cfg.rms_eps)
    return x + ffn


def _embed(params: Params, cfg: LlamaConfig, tokens: torch.Tensor) -> torch.Tensor:
    """Token rows in bf16, times cfg.embd_scale rounded to bf16 (JAX
    llama.py:994-995 multiplies by jnp.asarray(scale, bf16))."""
    x = take_rows(params["token_embd"], tokens, dtype=COMPUTE_DTYPE)
    if cfg.embd_scale != 1.0:
        x = x * torch.tensor(cfg.embd_scale, dtype=COMPUTE_DTYPE, device=x.device)
    return x


def _lm_head(params: Params, cfg: LlamaConfig, x: torch.Tensor) -> torch.Tensor:
    """Final norm, LM head (token_embd without an output.weight), and the
    final logit softcap on the f32 logits."""
    x = rms_norm(x, params["output_norm"], cfg.rms_eps)
    out_w = params.get("output")
    if out_w is None:
        out_w = params["token_embd"]
    logits = qmm(x, out_w)
    if cfg.final_logit_softcap:
        logits = softcap(logits, cfg.final_logit_softcap)
    return logits


@torch.inference_mode()
def forward(params: Params, cfg: LlamaConfig, tokens: torch.Tensor, positions: torch.Tensor,
            cache, n_past=0, *, fused: bool = True) -> torch.Tensor:
    """tokens, positions [B, T] → logits [B, T, n_vocab] f32; the cache is
    written in place at rows n_past .. n_past+T-1 (n_past a scalar, or a [B]
    tensor with T=1).

    fused: decode (T=1) attention through the fused kernel when the layer is
    in its scope; off, or out of scope, decode takes the cache's decode
    kernel."""
    x = _embed(params, cfg, tokens)
    memo: dict = {}  # rope angles and SWA starts, shared by the layers of one step
    for i, layer in enumerate(params["layers"]):
        x = decode_layer(x, layer, cfg, positions, cache, i, n_past, fused, memo)
    return _lm_head(params, cfg, x)


@torch.inference_mode()
def forward_packed(params: Params, cfg: LlamaConfig, tokens: torch.Tensor,
                   slot_ids: torch.Tensor, rows: torch.Tensor, cache,
                   out_idx: torch.Tensor) -> torch.Tensor:
    """Mixed prompt+decode step over one packed token list (JAX
    llama.py:1032-1083): tokens, slot_ids, rows [P] (rows == the cache
    capacity for padding), out_idx [n_slots] the packed index whose logits
    each slot needs. One pass over the weights serves every slot; only the
    out_idx rows reach the LM head. Returns logits [n_slots, n_vocab] f32.
    MLA (DeepSeek-V2) raises: the engine prefills it per slot, as JAX's does."""
    if cfg.kv_lora_rank:
        raise NotImplementedError("forward_packed with MLA: the JAX package never packs "
                                  "MLA; the engine prefills it per slot")
    x = _embed(params, cfg, tokens[None, :])
    positions = rows[None, :]
    for i, layer in enumerate(params["layers"]):
        x = decode_layer(x, layer, cfg, positions, cache, i, 0, False, {}, slot_ids)
    return _lm_head(params, cfg, x[0, out_idx.long()])
