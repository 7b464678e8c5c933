"""Rotary position embeddings (counterpart of the JAX package's ops/rope.py).

Reference ggml_rope_ext semantics: NORM mode rotates adjacent pairs
(x[2i], x[2i+1]); NEOX mode rotates split halves (x[i], x[i+n/2]).
theta = pos * freq_base^(-2i/n_dims), optionally divided by per-dim
freq_factors and scaled by freq_scale; YaRN as ggml_rope_yarn_corr_dims.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class RopeParams:
    n_dims: int  # rotated dims (n_rot)
    mode: str = "norm"  # "norm" | "neox"
    freq_base: float = 10000.0
    freq_scale: float = 1.0
    ext_factor: float = 0.0  # YaRN extrapolation mix
    attn_factor: float = 1.0
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    n_ctx_orig: int = 0  # original context for YaRN


def _yarn_corr_dim(n_dims: int, n_ctx_orig: int, n_rot: float, base: float) -> float:
    return n_dims * math.log(n_ctx_orig / (n_rot * 2 * math.pi)) / (2 * math.log(base))


def _rope_angles(pos: torch.Tensor, rp: RopeParams, freq_factors: torch.Tensor | None):
    """pos [...] → (cos, sin) each [..., n_dims/2] in f32."""
    half = rp.n_dims // 2
    i = torch.arange(half, dtype=torch.float32, device=pos.device)
    theta_scale = rp.freq_base ** (-2.0 / rp.n_dims)
    inv_freq = torch.pow(theta_scale, i)  # a scalar base: no host→device copy
    if freq_factors is not None:
        inv_freq = inv_freq / freq_factors.float()[:half]

    theta_extrap = pos.float()[..., None] * inv_freq
    theta_interp = rp.freq_scale * theta_extrap
    mscale = rp.attn_factor
    if rp.ext_factor != 0.0:
        n_ctx_orig = rp.n_ctx_orig or 1
        low = max(0.0, math.floor(
            _yarn_corr_dim(rp.n_dims, n_ctx_orig, rp.beta_fast, rp.freq_base)))
        high = min(rp.n_dims - 1.0, math.ceil(
            _yarn_corr_dim(rp.n_dims, n_ctx_orig, rp.beta_slow, rp.freq_base)))
        span = max(0.001, high - low)
        ramp = 1.0 - torch.clamp((2.0 * i - low) / span, 0.0, 1.0)
        ramp_mix = ramp * rp.ext_factor
        theta = theta_interp * (1 - ramp_mix) + theta_extrap * ramp_mix
        if rp.freq_scale < 1:
            mscale = mscale * (1.0 + 0.1 * math.log(1.0 / rp.freq_scale))
    else:
        theta = theta_interp
    return torch.cos(theta) * mscale, torch.sin(theta) * mscale


def apply_rope(x: torch.Tensor, pos: torch.Tensor, rp: RopeParams,
               freq_factors: torch.Tensor | None = None) -> torch.Tensor:
    """x [..., T, H, D], pos [..., T]: rotate the first n_dims dims of each
    head; pass the rest through."""
    n = rp.n_dims
    cos, sin = _rope_angles(pos, rp, freq_factors)
    cos = cos[..., None, :]  # broadcast over heads
    sin = sin[..., None, :]
    xf = x.float()
    rot, rest = xf[..., :n], xf[..., n:]
    if rp.mode == "norm":
        x0, x1 = rot[..., 0::2], rot[..., 1::2]
        out = torch.stack([x0 * cos - x1 * sin, x0 * sin + x1 * cos], dim=-1).reshape(rot.shape)
    elif rp.mode == "neox":
        half = n // 2
        x0, x1 = rot[..., :half], rot[..., half:]
        out = torch.cat([x0 * cos - x1 * sin, x0 * sin + x1 * cos], dim=-1)
    else:
        raise ValueError(rp.mode)
    if rest.shape[-1]:
        out = torch.cat([out, rest], dim=-1)
    return out.to(x.dtype)
