"""IQ-quant codebook grids (format constants).

The IQ1 / IQ2 / IQ3 GGUF formats store 8- (or 4-) element groups as indices
into fixed codebooks that are part of the format definition (ggml-common.h:
iq2xxs_grid, iq2xs_grid, iq2s_grid, iq3xxs_grid, iq3s_grid, iq1s_grid).
`iq_grids.npz` holds them as data, the same values as the JAX package's copy;
every decoder of these formats embeds identical values.

Sign bits of IQ2_XXS / IQ2_XS and IQ3_XXS come from a 7-bit index whose 8th
bit is the parity of the other seven (ksigns_iq2xs, ggml-common.h): computed
here, not stored.
"""

from __future__ import annotations

import functools
from pathlib import Path

import numpy as np

IQ1S_DELTA = np.float32(0.125)  # ggml-common.h IQ1S_DELTA
IQ1M_DELTA = np.float32(0.125)


@functools.cache
def grids() -> dict[str, np.ndarray]:
    with np.load(Path(__file__).parent / "iq_grids.npz") as z:
        return {k: z[k] for k in z.files}


@functools.cache
def sign_table() -> np.ndarray:
    """[128, 8] float32 of ±1: row s = signs of an 8-element group whose
    7-bit sign index is s; element 7's sign is the parity bit."""
    s = np.arange(128, dtype=np.uint8)
    bits = (s[:, None] >> np.arange(7)[None, :]) & 1  # [128, 7]
    parity = bits.sum(axis=1, dtype=np.uint8)[:, None] & 1
    all_bits = np.concatenate([bits, parity], axis=1)
    return np.where(all_bits != 0, np.float32(-1), np.float32(1))


@functools.cache
def byte_sign_table() -> np.ndarray:
    """[256, 8] float32 of ±1: row b = signs from a full sign byte
    (IQ2_S / IQ3_S store 8 explicit sign bits per group)."""
    b = np.arange(256, dtype=np.uint16)
    bits = (b[:, None] >> np.arange(8)[None, :]) & 1
    return np.where(bits != 0, np.float32(-1), np.float32(1))
