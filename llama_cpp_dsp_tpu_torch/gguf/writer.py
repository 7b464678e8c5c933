"""GGUF v3 writer.

Produces files byte-compatible with the reference writer
(ggml/src/gguf.cpp gguf_write_to_file / gguf-py GGUFWriter): header, KV
section, tensor-info table, alignment padding, then tensor blobs each padded
to the alignment. A tensor's data may be given as a function that makes it:
`write()` then makes and writes one tensor at a time, so a file larger than
the host's memory can be written.
"""

from __future__ import annotations

import struct
from collections.abc import Callable
from typing import Any, BinaryIO

import numpy as np

from .constants import (
    GGML_TYPE_TRAITS,
    GGUF_DEFAULT_ALIGNMENT,
    GGUF_MAGIC,
    GGUF_SCALAR_FMT,
    GGUF_VERSION,
    GGMLType,
    GGUFValueType,
    Keys,
)

_NP_TO_VTYPE = {
    np.dtype(np.uint8): GGUFValueType.UINT8,
    np.dtype(np.int8): GGUFValueType.INT8,
    np.dtype(np.uint16): GGUFValueType.UINT16,
    np.dtype(np.int16): GGUFValueType.INT16,
    np.dtype(np.uint32): GGUFValueType.UINT32,
    np.dtype(np.int32): GGUFValueType.INT32,
    np.dtype(np.uint64): GGUFValueType.UINT64,
    np.dtype(np.int64): GGUFValueType.INT64,
    np.dtype(np.float32): GGUFValueType.FLOAT32,
    np.dtype(np.float64): GGUFValueType.FLOAT64,
    np.dtype(np.bool_): GGUFValueType.BOOL,
}

_NP_TO_GGML = {
    np.dtype(np.float32): GGMLType.F32,
    np.dtype(np.float16): GGMLType.F16,
    np.dtype(np.int8): GGMLType.I8,
    np.dtype(np.int16): GGMLType.I16,
    np.dtype(np.int32): GGMLType.I32,
    np.dtype(np.int64): GGMLType.I64,
    np.dtype(np.float64): GGMLType.F64,
}


def _infer_vtype(v: Any) -> GGUFValueType:
    if isinstance(v, bool | np.bool_):
        return GGUFValueType.BOOL
    if isinstance(v, int | np.integer):
        if isinstance(v, np.unsignedinteger):
            return GGUFValueType.UINT32 if v <= 0xFFFFFFFF else GGUFValueType.UINT64
        return GGUFValueType.INT32 if -(2**31) <= int(v) < 2**31 else GGUFValueType.INT64
    if isinstance(v, float | np.floating):
        return GGUFValueType.FLOAT32
    if isinstance(v, str):
        return GGUFValueType.STRING
    if isinstance(v, list | tuple | np.ndarray):
        return GGUFValueType.ARRAY
    raise TypeError(f"cannot infer GGUF value type for {type(v)}")


class GGUFWriter:
    def __init__(
        self, path: str, arch: str | None, *, alignment: int = GGUF_DEFAULT_ALIGNMENT
    ):
        """arch=None is raw mode: no keys are auto-added; the caller
        supplies every KV explicitly."""
        self.path = path
        self.alignment = alignment
        self._kv: list[tuple[str, GGUFValueType, Any, GGUFValueType | None]] = []
        # (name, ne-shape, type, data bytes or the function that makes them, byte count)
        self._tensors: list[tuple[str, tuple[int, ...], GGMLType,
                                  np.ndarray | Callable[[], np.ndarray], int]] = []
        if arch is not None:
            self.add_kv(Keys.General.ARCHITECTURE, arch)
            if alignment != GGUF_DEFAULT_ALIGNMENT:
                self.add_kv(Keys.General.ALIGNMENT, np.uint32(alignment))

    # -- KV ---------------------------------------------------------------
    def add_kv(
        self,
        key: str,
        value: Any,
        vtype: GGUFValueType | None = None,
        etype: GGUFValueType | None = None,
    ) -> None:
        self._kv.append((key, vtype or _infer_vtype(value), value, etype))

    def add_uint32(self, key: str, value: int) -> None:
        self.add_kv(key, value, GGUFValueType.UINT32)

    def add_float32(self, key: str, value: float) -> None:
        self.add_kv(key, value, GGUFValueType.FLOAT32)

    def add_bool(self, key: str, value: bool) -> None:
        self.add_kv(key, bool(value), GGUFValueType.BOOL)

    def add_string(self, key: str, value: str) -> None:
        self.add_kv(key, value, GGUFValueType.STRING)

    # -- tensors ----------------------------------------------------------
    def add_tensor(
        self,
        name: str,
        data: np.ndarray | Callable[[], np.ndarray],
        *,
        ggml_type: GGMLType | None = None,
        ne_shape: tuple[int, ...] | None = None,
    ) -> None:
        """Add a tensor.

        For float/int arrays pass the numpy array directly (row-major; the
        written ne is the reversed numpy shape). For pre-quantized data pass
        raw uint8 `data` plus explicit `ggml_type` and logical `ne_shape`.
        `data` may be a function of no arguments that returns the array
        (`ggml_type` and `ne_shape` then required): it runs when `write()`
        reaches the tensor, and its array is dropped once written.
        """
        if ggml_type is None:
            if callable(data):
                raise ValueError(f"tensor {name!r}: a made tensor needs ggml_type and ne_shape")
            ggml_type = _NP_TO_GGML[data.dtype]
            ne_shape = tuple(reversed(data.shape))
        else:
            assert ne_shape is not None, "ne_shape required for quantized tensors"
        tr = GGML_TYPE_TRAITS[ggml_type]
        n = 1
        for d in ne_shape:
            n *= d
        expect = n // tr.block_size * tr.type_size
        if not callable(data):
            data = self._raw(name, data, expect)
        self._tensors.append((name, ne_shape, ggml_type, data, expect))

    @staticmethod
    def _raw(name: str, data: np.ndarray, expect: int) -> np.ndarray:
        raw = np.ascontiguousarray(data).view(np.uint8).reshape(-1)
        if raw.nbytes != expect:
            raise ValueError(f"tensor {name!r}: got {raw.nbytes} bytes, expected {expect}")
        return raw

    # -- serialization ----------------------------------------------------
    @staticmethod
    def _w_str(f: BinaryIO, s: str) -> None:
        b = s.encode("utf-8")
        f.write(struct.pack("<Q", len(b)))
        f.write(b)

    def _w_value(
        self, f: BinaryIO, vtype: GGUFValueType, v: Any, etype: GGUFValueType | None = None
    ) -> None:
        f.write(struct.pack("<I", int(vtype)))
        self._w_value_raw(f, vtype, v, etype)

    def _w_value_raw(
        self, f: BinaryIO, vtype: GGUFValueType, v: Any, etype: GGUFValueType | None = None
    ) -> None:
        if vtype == GGUFValueType.STRING:
            self._w_str(f, v)
        elif vtype == GGUFValueType.ARRAY:
            if etype is None:
                if isinstance(v, np.ndarray) and v.dtype in _NP_TO_VTYPE:
                    etype = _NP_TO_VTYPE[v.dtype]
                elif isinstance(v, np.ndarray):
                    etype = _infer_vtype(v.reshape(-1)[0].item() if v.size else 0)
                else:
                    etype = _infer_vtype(v[0]) if len(v) else GGUFValueType.INT32
            f.write(struct.pack("<IQ", int(etype), len(v)))
            for item in v:
                self._w_value_raw(f, etype, item)
        else:
            fmt, _ = GGUF_SCALAR_FMT[vtype]
            f.write(struct.pack(fmt, v))

    def write(self) -> None:
        align = self.alignment
        with open(self.path, "wb") as f:
            f.write(GGUF_MAGIC)
            f.write(struct.pack("<IQQ", GGUF_VERSION, len(self._tensors), len(self._kv)))
            for key, vtype, v, etype in self._kv:
                self._w_str(f, key)
                self._w_value(f, vtype, v, etype)
            offset = 0
            for name, ne, ttype, _data, nbytes in self._tensors:
                self._w_str(f, name)
                f.write(struct.pack("<I", len(ne)))
                for d in ne:
                    f.write(struct.pack("<Q", d))
                f.write(struct.pack("<IQ", int(ttype), offset))
                offset += (nbytes + align - 1) // align * align
            pad = (-f.tell()) % align
            f.write(b"\x00" * pad)
            for name, _ne, _ttype, data, nbytes in self._tensors:
                raw = self._raw(name, data(), nbytes) if callable(data) else data
                f.write(memoryview(raw))
                f.write(b"\x00" * ((-nbytes) % align))
