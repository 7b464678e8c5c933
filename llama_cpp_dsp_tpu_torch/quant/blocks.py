"""GGUF block records of the kinds this port runs (Q4_0, Q8_0).

The block dtypes and the `_blocks` helper of the JAX package's
quant/ref_numpy.py, cut down to the kinds on the port's path; the layouts
match ggml-common.h.
"""

from __future__ import annotations

import numpy as np

from ..gguf.constants import GGML_TYPE_TRAITS, GGMLType

DT = {
    GGMLType.Q4_0: np.dtype([("d", "<f2"), ("qs", "u1", (16,))]),
    GGMLType.Q8_0: np.dtype([("d", "<f2"), ("qs", "i1", (32,))]),
}


def _blocks(raw: np.ndarray, t: GGMLType) -> np.ndarray:
    """View raw uint8 data as an array of block records."""
    dt = DT[t]
    tr = GGML_TYPE_TRAITS[t]
    assert dt.itemsize == tr.type_size, (t, dt.itemsize, tr.type_size)
    raw = np.ascontiguousarray(raw).reshape(-1).view(np.uint8)
    assert raw.nbytes % dt.itemsize == 0
    return raw.view(dt)
