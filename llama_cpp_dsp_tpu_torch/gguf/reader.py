"""Zero-copy mmap GGUF reader.

Parses the GGUF v2/v3 container the same way as the reference
(ggml/src/gguf.cpp:319 gguf_init_from_file_impl): magic, version,
tensor-count, kv-count, typed KV metadata, tensor-info table, then an
alignment-padded data blob. Tensor data is exposed as zero-copy numpy views
over one mmap per file.

Multi-file split models ("model-00001-of-00003.gguf", reference
src/llama-model-loader.cpp:443 + examples/gguf-split) are merged by
`GGUFModel.load`.
"""

from __future__ import annotations

import mmap
import os
import re
import struct
from dataclasses import dataclass, field
from typing import Any, BinaryIO

import numpy as np

from .constants import (
    GGML_TYPE_TRAITS,
    GGUF_DEFAULT_ALIGNMENT,
    GGUF_MAGIC,
    GGUF_SCALAR_FMT,
    GGMLType,
    GGUFValueType,
    Keys,
    ggml_nbytes,
)

GGML_MAX_DIMS = 4
_SPLIT_RE = re.compile(r"^(.*)-(\d{5})-of-(\d{5})\.gguf$")


class GGUFFormatError(Exception):
    """Raised on any malformed GGUF input (bad magic, truncation, overlaps...)."""


class _Parser:
    __slots__ = ("buf", "pos", "n")

    def __init__(self, buf) -> None:
        self.buf = buf
        self.pos = 0
        self.n = len(buf)

    def read(self, size: int) -> bytes:
        if size < 0 or self.pos + size > self.n:
            raise GGUFFormatError(
                f"truncated file: need {size} bytes at offset {self.pos}, have {self.n}"
            )
        out = self.buf[self.pos : self.pos + size]
        self.pos += size
        return out

    def scalar(self, fmt: str, size: int):
        return struct.unpack(fmt, self.read(size))[0]

    def u32(self) -> int:
        return self.scalar("<I", 4)

    def u64(self) -> int:
        return self.scalar("<Q", 8)

    def string(self) -> str:
        n = self.u64()
        if n > self.n:
            raise GGUFFormatError(f"string length {n} exceeds file size")
        return bytes(self.read(n)).decode("utf-8", errors="replace")

    def value(self, vtype: GGUFValueType) -> Any:
        if vtype == GGUFValueType.STRING:
            return self.string()
        if vtype == GGUFValueType.ARRAY:
            etype = GGUFValueType(self.u32())
            count = self.u64()
            if etype == GGUFValueType.ARRAY:
                raise GGUFFormatError("nested arrays are not allowed in GGUF")
            if etype == GGUFValueType.STRING:
                return [self.string() for _ in range(count)]
            fmt, size = GGUF_SCALAR_FMT[etype]
            raw = self.read(count * size)
            dt = np.dtype(fmt[1:]).newbyteorder("<")
            arr = np.frombuffer(raw, dtype=dt, count=count)
            if etype == GGUFValueType.BOOL:
                arr = arr.astype(bool)
            return arr
        fmt, size = GGUF_SCALAR_FMT[vtype]
        return self.scalar(fmt, size)


@dataclass
class GGUFTensorInfo:
    name: str
    shape: tuple[int, ...]  # ggml ne order: shape[0] is the contiguous (row) dim
    ggml_type: GGMLType
    offset: int  # relative to data section
    data: np.ndarray | None = None  # uint8 view over the mmap, length nbytes

    @property
    def n_elements(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n

    @property
    def nbytes(self) -> int:
        return ggml_nbytes(self.ggml_type, self.shape)

    @property
    def np_shape(self) -> tuple[int, ...]:
        """Row-major numpy shape (reversed ne), e.g. weight [n_out, n_in]."""
        return tuple(reversed(self.shape))


@dataclass
class GGUFFile:
    path: str
    version: int
    kv: dict[str, Any]
    tensors: dict[str, GGUFTensorInfo]
    alignment: int
    data_offset: int
    _mm: mmap.mmap | None = field(default=None, repr=False)
    _f: BinaryIO | None = field(default=None, repr=False)

    def close(self) -> None:
        # numpy tensor views may still hold exported buffer pointers; in that
        # case dropping our references lets the mmap be reclaimed by GC once
        # the views die (mmap.close() would raise BufferError).
        if self._mm is not None:
            try:
                self._mm.close()
            except BufferError:
                pass
            self._mm = None
        if self._f is not None:
            self._f.close()
            self._f = None


def read_gguf(path: str | os.PathLike, *, load_data: bool = True) -> GGUFFile:
    f = open(path, "rb")
    try:
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
    except ValueError as e:  # empty file
        f.close()
        raise GGUFFormatError(f"cannot mmap {path}: {e}") from None

    try:
        return _parse(str(path), f, mm, load_data=load_data)
    except Exception:
        try:
            mm.close()
        except BufferError:
            pass
        f.close()
        raise


def _parse(path: str, f: BinaryIO, mm: mmap.mmap, *, load_data: bool) -> GGUFFile:
    mv = memoryview(mm)
    try:
        return _parse_inner(path, f, mm, mv, load_data=load_data)
    finally:
        mv.release()


def _parse_inner(
    path: str, f: BinaryIO, mm: mmap.mmap, mv: memoryview, *, load_data: bool
) -> GGUFFile:
    p = _Parser(mv)
    magic = p.read(4)
    if magic != GGUF_MAGIC:
        raise GGUFFormatError(f"bad magic {magic!r}, expected {GGUF_MAGIC!r}")
    version = p.u32()
    if version == 1 or version > 3:
        raise GGUFFormatError(f"unsupported GGUF version {version}")

    n_tensors = p.u64()
    n_kv = p.u64()
    if n_tensors > 1 << 32 or n_kv > 1 << 32:
        raise GGUFFormatError("implausible tensor/kv count")

    kv: dict[str, Any] = {}
    for _ in range(n_kv):
        key = p.string()
        vtype_raw = p.u32()
        try:
            vtype = GGUFValueType(vtype_raw)
        except ValueError:
            raise GGUFFormatError(f"invalid value type {vtype_raw} for key {key!r}") from None
        if key in kv:
            raise GGUFFormatError(f"duplicate key {key!r}")
        kv[key] = p.value(vtype)

    alignment = int(kv.get(Keys.General.ALIGNMENT, GGUF_DEFAULT_ALIGNMENT))
    if alignment == 0 or alignment & (alignment - 1):
        raise GGUFFormatError(f"alignment {alignment} is not a power of two")

    tensors: dict[str, GGUFTensorInfo] = {}
    for _ in range(n_tensors):
        name = p.string()
        if len(name) >= 64:
            raise GGUFFormatError(f"tensor name too long: {name!r}")
        n_dims = p.u32()
        if n_dims > GGML_MAX_DIMS:
            raise GGUFFormatError(f"tensor {name!r}: n_dims {n_dims} > {GGML_MAX_DIMS}")
        shape = tuple(p.u64() for _ in range(n_dims))
        ttype_raw = p.u32()
        try:
            ttype = GGMLType(ttype_raw)
        except ValueError:
            raise GGUFFormatError(f"tensor {name!r}: invalid type {ttype_raw}") from None
        if ttype not in GGML_TYPE_TRAITS:
            raise GGUFFormatError(f"tensor {name!r}: unsupported type {ttype}")
        offset = p.u64()
        if offset % alignment:
            raise GGUFFormatError(f"tensor {name!r}: offset {offset} not aligned")
        tr = GGML_TYPE_TRAITS[ttype]
        if shape and shape[0] % tr.block_size:
            raise GGUFFormatError(
                f"tensor {name!r}: first dim {shape[0]} not divisible by "
                f"block size {tr.block_size} of {ttype.name}"
            )
        if name in tensors:
            raise GGUFFormatError(f"duplicate tensor name {name!r}")
        tensors[name] = GGUFTensorInfo(name, shape, ttype, offset)

    data_offset = (p.pos + alignment - 1) // alignment * alignment
    file_size = len(mm)

    # validate offsets are monotone / in-bounds, attach zero-copy views
    base = np.frombuffer(mm, dtype=np.uint8)
    expected = 0
    for t in sorted(tensors.values(), key=lambda t: t.offset):
        if t.offset != expected:
            raise GGUFFormatError(
                f"tensor {t.name!r}: offset {t.offset}, expected {expected} "
                "(overlap or gap in data section)"
            )
        end = data_offset + t.offset + t.nbytes
        if end > file_size:
            raise GGUFFormatError(f"tensor {t.name!r} extends past end of file")
        if load_data:
            t.data = base[data_offset + t.offset : end]
        expected = (t.offset + t.nbytes + alignment - 1) // alignment * alignment

    return GGUFFile(path, version, kv, tensors, alignment, data_offset, mm, f)


def split_paths(path: str) -> list[str]:
    """Expand a split-model first-file path into all shard paths.

    Mirrors reference llama_model_loader handling of
    "-%05d-of-%05d.gguf" suffixes (src/llama-model-loader.cpp:443+).
    """
    m = _SPLIT_RE.match(str(path))
    if not m:
        return [str(path)]
    prefix, _idx, total = m.group(1), int(m.group(2)), int(m.group(3))
    return [f"{prefix}-{i:05d}-of-{total:05d}.gguf" for i in range(1, total + 1)]


@dataclass
class GGUFModel:
    """All shards of a (possibly split) model merged into one namespace."""

    files: list[GGUFFile]
    kv: dict[str, Any]
    tensors: dict[str, GGUFTensorInfo]

    @classmethod
    def load(cls, path: str | os.PathLike) -> "GGUFModel":
        paths = split_paths(str(path))
        files = [read_gguf(pth) for pth in paths]
        kv: dict[str, Any] = {}
        tensors: dict[str, GGUFTensorInfo] = {}
        for gf in files:
            for k, v in gf.kv.items():
                kv.setdefault(k, v)
            for name, t in gf.tensors.items():
                if name in tensors:
                    raise GGUFFormatError(f"tensor {name!r} appears in multiple shards")
                tensors[name] = t
        n_split_tensors = kv.get(Keys.Split.TENSORS_COUNT)
        if n_split_tensors is not None and int(n_split_tensors) != len(tensors):
            raise GGUFFormatError(
                f"split metadata says {n_split_tensors} tensors, found {len(tensors)}"
            )
        return cls(files, kv, tensors)

    def close(self) -> None:
        for gf in self.files:
            gf.close()
