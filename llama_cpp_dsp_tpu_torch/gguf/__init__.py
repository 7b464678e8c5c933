from .constants import (
    GGML_TYPE_TRAITS,
    GGUF_DEFAULT_ALIGNMENT,
    FType,
    GGMLType,
    GGUFValueType,
    Keys,
    TokenType,
    ggml_nbytes,
    ggml_row_size,
)
from .reader import GGUFFile, GGUFFormatError, GGUFModel, GGUFTensorInfo, read_gguf
from .writer import GGUFWriter

__all__ = [
    "GGML_TYPE_TRAITS",
    "GGUF_DEFAULT_ALIGNMENT",
    "FType",
    "GGMLType",
    "GGUFFile",
    "GGUFFormatError",
    "GGUFModel",
    "GGUFTensorInfo",
    "GGUFValueType",
    "GGUFWriter",
    "Keys",
    "TokenType",
    "ggml_nbytes",
    "ggml_row_size",
    "read_gguf",
]
