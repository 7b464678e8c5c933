"""GGUF block records of the kinds this port runs (Q4_0, Q4_1, Q5_0, Q5_1,
Q8_0, Q2_K, Q3_K, Q4_K, Q5_K, Q6_K; the IQ kinds IQ4_NL, IQ4_XS, IQ2_XXS,
IQ2_XS, IQ2_S, IQ3_XXS, IQ3_S, IQ1_S, IQ1_M and the ternary TQ1_0, TQ2_0).

The block dtypes, `_blocks`, `_f32`, `unpack_scale_min_k4`,
`unpack_q3_K_scales` and the IQ4_NL
codebook `KVALUES_IQ4NL` (the iq4_nl KV cache's) of the JAX package's
quant/ref_numpy.py, cut down to the kinds on the port's path; the layouts
match ggml-common.h.
"""

from __future__ import annotations

import numpy as np

from ..gguf.constants import GGML_TYPE_TRAITS, GGMLType

DT = {
    GGMLType.Q4_0: np.dtype([("d", "<f2"), ("qs", "u1", (16,))]),
    GGMLType.Q4_1: np.dtype([("d", "<f2"), ("m", "<f2"), ("qs", "u1", (16,))]),
    GGMLType.Q5_0: np.dtype([("d", "<f2"), ("qh", "<u4"), ("qs", "u1", (16,))]),
    GGMLType.Q5_1: np.dtype([("d", "<f2"), ("m", "<f2"), ("qh", "<u4"), ("qs", "u1", (16,))]),
    GGMLType.Q8_0: np.dtype([("d", "<f2"), ("qs", "i1", (32,))]),
    GGMLType.Q2_K: np.dtype(
        [("scales", "u1", (16,)), ("qs", "u1", (64,)), ("d", "<f2"), ("dmin", "<f2")]),
    GGMLType.Q3_K: np.dtype(
        [("hmask", "u1", (32,)), ("qs", "u1", (64,)), ("scales", "u1", (12,)), ("d", "<f2")]),
    GGMLType.Q4_K: np.dtype(
        [("d", "<f2"), ("dmin", "<f2"), ("scales", "u1", (12,)), ("qs", "u1", (128,))]),
    GGMLType.Q5_K: np.dtype(
        [("d", "<f2"), ("dmin", "<f2"), ("scales", "u1", (12,)), ("qh", "u1", (32,)),
         ("qs", "u1", (128,))]),
    GGMLType.Q6_K: np.dtype(
        [("ql", "u1", (128,)), ("qh", "u1", (64,)), ("scales", "i1", (16,)), ("d", "<f2")]),
    GGMLType.IQ4_NL: np.dtype([("d", "<f2"), ("qs", "u1", (16,))]),
    GGMLType.IQ4_XS: np.dtype(
        [("d", "<f2"), ("scales_h", "<u2"), ("scales_l", "u1", (4,)), ("qs", "u1", (128,))]),
    GGMLType.IQ2_XXS: np.dtype([("d", "<f2"), ("qs", "<u2", (32,))]),
    GGMLType.IQ2_XS: np.dtype([("d", "<f2"), ("qs", "<u2", (32,)), ("scales", "u1", (8,))]),
    GGMLType.IQ2_S: np.dtype(
        [("d", "<f2"), ("qs", "u1", (64,)), ("qh", "u1", (8,)), ("scales", "u1", (8,))]),
    GGMLType.IQ3_XXS: np.dtype([("d", "<f2"), ("qs", "u1", (96,))]),
    GGMLType.IQ3_S: np.dtype(
        [("d", "<f2"), ("qs", "u1", (64,)), ("qh", "u1", (8,)), ("signs", "u1", (32,)),
         ("scales", "u1", (4,))]),
    GGMLType.IQ1_S: np.dtype([("d", "<f2"), ("qs", "u1", (32,)), ("qh", "<u2", (8,))]),
    # no d field: the f16 super-scale is scattered over the top nibbles of the
    # four 16-bit scale words (dequantize_row_iq1_m)
    GGMLType.IQ1_M: np.dtype([("qs", "u1", (32,)), ("qh", "u1", (16,)), ("scales", "u1", (8,))]),
    GGMLType.TQ1_0: np.dtype([("qs", "u1", (48,)), ("qh", "u1", (4,)), ("d", "<f2")]),
    GGMLType.TQ2_0: np.dtype([("qs", "u1", (64,)), ("d", "<f2")]),
}

# the 16 non-linear IQ4_NL levels (ggml-quants.c kvalues_iq4nl)
KVALUES_IQ4NL = np.array(
    [-127, -104, -83, -65, -49, -35, -22, -10, 1, 13, 25, 38, 53, 69, 89, 113],
    dtype=np.int8,
)


def _blocks(raw: np.ndarray, t: GGMLType) -> np.ndarray:
    """View raw uint8 data as an array of block records."""
    dt = DT[t]
    tr = GGML_TYPE_TRAITS[t]
    assert dt.itemsize == tr.type_size, (t, dt.itemsize, tr.type_size)
    raw = np.ascontiguousarray(raw).reshape(-1).view(np.uint8)
    assert raw.nbytes % dt.itemsize == 0
    return raw.view(dt)


def _f32(h: np.ndarray) -> np.ndarray:
    return h.astype(np.float32)


def unpack_scale_min_k4(scales: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Unpack 12-byte 6-bit scale/min pairs → (sc[nb, 8], m[nb, 8]) uint8
    (get_scale_min_k4, reference ggml-quants.c:631)."""
    q = scales.astype(np.uint8)
    sc = np.empty(q.shape[:-1] + (8,), dtype=np.uint8)
    m = np.empty_like(sc)
    sc[..., :4] = q[..., 0:4] & 63
    m[..., :4] = q[..., 4:8] & 63
    sc[..., 4:] = (q[..., 8:12] & 0x0F) | ((q[..., 0:4] >> 6) << 4)
    m[..., 4:] = (q[..., 8:12] >> 4) | ((q[..., 4:8] >> 6) << 4)
    return sc, m


def unpack_q3_K_scales(scales: np.ndarray) -> np.ndarray:
    """12 packed bytes → 16 signed 6-bit scales [nb, 16] int32, the −32 bias
    applied (the kmask bit shuffle of dequantize_row_q3_K)."""
    a = np.ascontiguousarray(scales).view("<u4").reshape(-1, 3)
    kmask1, kmask2 = np.uint32(0x03030303), np.uint32(0x0F0F0F0F)
    tmp = a[:, 2]
    out = np.empty((len(a), 4), dtype=np.uint32)
    out[:, 0] = (a[:, 0] & kmask2) | (((tmp >> 0) & kmask1) << 4)
    out[:, 1] = (a[:, 1] & kmask2) | (((tmp >> 2) & kmask1) << 4)
    out[:, 2] = ((a[:, 0] >> 4) & kmask2) | (((tmp >> 4) & kmask1) << 4)
    out[:, 3] = ((a[:, 1] >> 4) & kmask2) | (((tmp >> 6) & kmask1) << 4)
    return out.view(np.int8).astype(np.int32) - 32
