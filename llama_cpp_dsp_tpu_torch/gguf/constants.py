"""GGUF / GGML format constants.

Numerically faithful to the reference headers:
- ggml type ids: reference ggml/include/ggml.h:352-391 (enum ggml_type)
- gguf value types: reference ggml/include/gguf.h:54-68 (enum gguf_type)
- block layouts: reference ggml/src/ggml-common.h:166-420
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

GGUF_MAGIC = b"GGUF"
GGUF_VERSION = 3
GGUF_DEFAULT_ALIGNMENT = 32

QK_K = 256
K_SCALE_SIZE = 12


class GGMLType(enum.IntEnum):
    """Tensor data types; ids match reference ggml/include/ggml.h:352-391."""

    F32 = 0
    F16 = 1
    Q4_0 = 2
    Q4_1 = 3
    # 4, 5 removed upstream (Q4_2 / Q4_3)
    Q5_0 = 6
    Q5_1 = 7
    Q8_0 = 8
    Q8_1 = 9
    Q2_K = 10
    Q3_K = 11
    Q4_K = 12
    Q5_K = 13
    Q6_K = 14
    Q8_K = 15
    IQ2_XXS = 16
    IQ2_XS = 17
    IQ3_XXS = 18
    IQ1_S = 19
    IQ4_NL = 20
    IQ3_S = 21
    IQ2_S = 22
    IQ4_XS = 23
    I8 = 24
    I16 = 25
    I32 = 26
    I64 = 27
    F64 = 28
    IQ1_M = 29
    BF16 = 30
    # 31-33 removed upstream (Q4_0_4_4 etc.)
    TQ1_0 = 34
    TQ2_0 = 35
    # 36-38 removed upstream (IQ4_NL_4_4 etc.)
    COUNT = 39


@dataclass(frozen=True)
class TypeTraits:
    """block_size: elements per block; type_size: bytes per block.

    Mirrors reference ggml/src/ggml.c type_traits table; sizes follow the
    packed structs in ggml/src/ggml-common.h.
    """

    block_size: int
    type_size: int
    is_quantized: bool = True

    @property
    def bytes_per_elem(self) -> float:
        return self.type_size / self.block_size


GGML_TYPE_TRAITS: dict[GGMLType, TypeTraits] = {
    GGMLType.F32: TypeTraits(1, 4, False),
    GGMLType.F16: TypeTraits(1, 2, False),
    GGMLType.BF16: TypeTraits(1, 2, False),
    GGMLType.F64: TypeTraits(1, 8, False),
    GGMLType.I8: TypeTraits(1, 1, False),
    GGMLType.I16: TypeTraits(1, 2, False),
    GGMLType.I32: TypeTraits(1, 4, False),
    GGMLType.I64: TypeTraits(1, 8, False),
    # legacy 32-element block quants (ggml-common.h:166-230)
    GGMLType.Q4_0: TypeTraits(32, 2 + 16, True),
    GGMLType.Q4_1: TypeTraits(32, 4 + 16, True),
    GGMLType.Q5_0: TypeTraits(32, 2 + 4 + 16, True),
    GGMLType.Q5_1: TypeTraits(32, 4 + 4 + 16, True),
    GGMLType.Q8_0: TypeTraits(32, 2 + 32, True),
    GGMLType.Q8_1: TypeTraits(32, 4 + 32, True),
    # K-quants: 256-element super-blocks (ggml-common.h:252-340)
    GGMLType.Q2_K: TypeTraits(QK_K, QK_K // 16 + QK_K // 4 + 4),
    GGMLType.Q3_K: TypeTraits(QK_K, QK_K // 8 + QK_K // 4 + 12 + 2),
    GGMLType.Q4_K: TypeTraits(QK_K, 4 + K_SCALE_SIZE + QK_K // 2),
    GGMLType.Q5_K: TypeTraits(QK_K, 4 + K_SCALE_SIZE + QK_K // 8 + QK_K // 2),
    GGMLType.Q6_K: TypeTraits(QK_K, QK_K // 2 + QK_K // 4 + QK_K // 16 + 2),
    GGMLType.Q8_K: TypeTraits(QK_K, 4 + QK_K + QK_K // 16 * 2),
    # i-quants (ggml-common.h:345-420)
    GGMLType.IQ2_XXS: TypeTraits(QK_K, 2 + QK_K // 8 * 2),
    GGMLType.IQ2_XS: TypeTraits(QK_K, 2 + QK_K // 8 * 2 + QK_K // 32),
    GGMLType.IQ2_S: TypeTraits(QK_K, 2 + QK_K // 4 + QK_K // 16),
    GGMLType.IQ3_XXS: TypeTraits(QK_K, 2 + 3 * QK_K // 8),
    GGMLType.IQ3_S: TypeTraits(QK_K, 2 + 13 * QK_K // 32 + QK_K // 64),
    GGMLType.IQ1_S: TypeTraits(QK_K, 2 + QK_K // 8 + QK_K // 16),
    GGMLType.IQ1_M: TypeTraits(QK_K, QK_K // 8 + QK_K // 16 + QK_K // 32),
    GGMLType.IQ4_NL: TypeTraits(32, 2 + 16, True),
    GGMLType.IQ4_XS: TypeTraits(QK_K, 2 + 2 + QK_K // 64 + QK_K // 2),
    # ternary (ggml-common.h:232-250)
    GGMLType.TQ1_0: TypeTraits(QK_K, 2 + QK_K // 64 + (QK_K - 4 * QK_K // 64) // 5),
    GGMLType.TQ2_0: TypeTraits(QK_K, 2 + QK_K // 4),
}


class GGUFValueType(enum.IntEnum):
    """Metadata KV value types; ids match reference ggml/include/gguf.h:54-68."""

    UINT8 = 0
    INT8 = 1
    UINT16 = 2
    INT16 = 3
    UINT32 = 4
    INT32 = 5
    FLOAT32 = 6
    BOOL = 7
    STRING = 8
    ARRAY = 9
    UINT64 = 10
    INT64 = 11
    FLOAT64 = 12


# struct format char + size for scalar value types
GGUF_SCALAR_FMT: dict[GGUFValueType, tuple[str, int]] = {
    GGUFValueType.UINT8: ("<B", 1),
    GGUFValueType.INT8: ("<b", 1),
    GGUFValueType.UINT16: ("<H", 2),
    GGUFValueType.INT16: ("<h", 2),
    GGUFValueType.UINT32: ("<I", 4),
    GGUFValueType.INT32: ("<i", 4),
    GGUFValueType.FLOAT32: ("<f", 4),
    GGUFValueType.BOOL: ("<?", 1),
    GGUFValueType.UINT64: ("<Q", 8),
    GGUFValueType.INT64: ("<q", 8),
    GGUFValueType.FLOAT64: ("<d", 8),
}


def ggml_row_size(ggml_type: GGMLType, n_elements: int) -> int:
    tr = GGML_TYPE_TRAITS[ggml_type]
    assert n_elements % tr.block_size == 0, (
        f"{ggml_type.name}: {n_elements} not divisible by block size {tr.block_size}"
    )
    return n_elements // tr.block_size * tr.type_size


def ggml_nbytes(ggml_type: GGMLType, shape: tuple[int, ...]) -> int:
    """Total bytes for a contiguous tensor of `shape` (ne order, first dim innermost)."""
    n = 1
    for d in shape:
        n *= d
    return ggml_row_size(ggml_type, n)


# Standard metadata keys (subset; reference src/llama-arch.cpp LLM_KV table)
class Keys:
    class General:
        ARCHITECTURE = "general.architecture"
        NAME = "general.name"
        ALIGNMENT = "general.alignment"
        QUANTIZATION_VERSION = "general.quantization_version"
        FILE_TYPE = "general.file_type"

    class Split:
        NO = "split.no"
        COUNT = "split.count"
        TENSORS_COUNT = "split.tensors.count"

    class LLM:  # per-arch keys use {arch} prefix
        CONTEXT_LENGTH = "{arch}.context_length"
        EMBEDDING_LENGTH = "{arch}.embedding_length"
        BLOCK_COUNT = "{arch}.block_count"
        FEED_FORWARD_LENGTH = "{arch}.feed_forward_length"
        EXPERT_COUNT = "{arch}.expert_count"
        EXPERT_USED_COUNT = "{arch}.expert_used_count"
        EXPERT_FEED_FORWARD_LENGTH = "{arch}.expert_feed_forward_length"
        # DeepSeek-V2 (the JAX package reads these as string literals:
        # models/registry.py::_deepseek, ::_deepseek2)
        EXPERT_SHARED_COUNT = "{arch}.expert_shared_count"
        EXPERT_WEIGHTS_SCALE = "{arch}.expert_weights_scale"
        EXPERT_WEIGHTS_NORM = "{arch}.expert_weights_norm"
        EXPERT_GATING_FUNC = "{arch}.expert_gating_func"
        LEADING_DENSE_BLOCK_COUNT = "{arch}.leading_dense_block_count"
        ATTN_Q_LORA_RANK = "{arch}.attention.q_lora_rank"
        ATTN_KV_LORA_RANK = "{arch}.attention.kv_lora_rank"
        ROPE_DIMENSION_COUNT = "{arch}.rope.dimension_count"
        ROPE_FREQ_BASE = "{arch}.rope.freq_base"
        ROPE_SCALING_TYPE = "{arch}.rope.scaling.type"
        ROPE_SCALING_FACTOR = "{arch}.rope.scaling.factor"
        ROPE_SCALING_ORIG_CTX = "{arch}.rope.scaling.original_context_length"
        ROPE_SCALING_LOW_FREQ_FACTOR = "{arch}.rope.scaling.low_freq_factor"
        ROPE_SCALING_HIGH_FREQ_FACTOR = "{arch}.rope.scaling.high_freq_factor"
        ATTN_HEAD_COUNT = "{arch}.attention.head_count"
        ATTN_HEAD_COUNT_KV = "{arch}.attention.head_count_kv"
        ATTN_LAYERNORM_RMS_EPS = "{arch}.attention.layer_norm_rms_epsilon"
        ATTN_LAYERNORM_EPS = "{arch}.attention.layer_norm_epsilon"
        ATTN_KEY_LENGTH = "{arch}.attention.key_length"
        ATTN_VALUE_LENGTH = "{arch}.attention.value_length"
        VOCAB_SIZE = "{arch}.vocab_size"
        SLIDING_WINDOW = "{arch}.attention.sliding_window"
        # gemma2 (the JAX package reads these as string literals:
        # models/registry.py::_gemma2)
        ATTN_LOGIT_SOFTCAPPING = "{arch}.attn_logit_softcapping"
        FINAL_LOGIT_SOFTCAPPING = "{arch}.final_logit_softcapping"
        SSM_CONV_KERNEL = "{arch}.ssm.conv_kernel"
        SSM_INNER_SIZE = "{arch}.ssm.inner_size"
        SSM_STATE_SIZE = "{arch}.ssm.state_size"
        SSM_TIME_STEP_RANK = "{arch}.ssm.time_step_rank"

    class Tokenizer:
        MODEL = "tokenizer.ggml.model"  # "llama"(spm) | "gpt2"(bpe) | "bert"(wpm) | ...
        PRE = "tokenizer.ggml.pre"
        LIST = "tokenizer.ggml.tokens"
        TOKEN_TYPE = "tokenizer.ggml.token_type"
        SCORES = "tokenizer.ggml.scores"
        MERGES = "tokenizer.ggml.merges"
        BOS_ID = "tokenizer.ggml.bos_token_id"
        EOS_ID = "tokenizer.ggml.eos_token_id"
        EOT_ID = "tokenizer.ggml.eot_token_id"
        EOM_ID = "tokenizer.ggml.eom_token_id"
        UNK_ID = "tokenizer.ggml.unknown_token_id"
        SEP_ID = "tokenizer.ggml.seperator_token_id"
        PAD_ID = "tokenizer.ggml.padding_token_id"
        ADD_BOS = "tokenizer.ggml.add_bos_token"
        ADD_EOS = "tokenizer.ggml.add_eos_token"
        ADD_SPACE_PREFIX = "tokenizer.ggml.add_space_prefix"
        REMOVE_EXTRA_WS = "tokenizer.ggml.remove_extra_whitespaces"
        CHAT_TEMPLATE = "tokenizer.chat_template"


class TokenType(enum.IntEnum):
    """Matches reference llama_token_attr-era token types (gguf constant)."""

    UNDEFINED = 0
    NORMAL = 1
    UNKNOWN = 2
    CONTROL = 3
    USER_DEFINED = 4
    UNUSED = 5
    BYTE = 6


# llama_ftype — model-level file types (reference include/llama.h:107-150)
class FType(enum.IntEnum):
    ALL_F32 = 0
    MOSTLY_F16 = 1
    MOSTLY_Q4_0 = 2
    MOSTLY_Q4_1 = 3
    MOSTLY_Q8_0 = 7
    MOSTLY_Q5_0 = 8
    MOSTLY_Q5_1 = 9
    MOSTLY_Q2_K = 10
    MOSTLY_Q3_K_S = 11
    MOSTLY_Q3_K_M = 12
    MOSTLY_Q3_K_L = 13
    MOSTLY_Q4_K_S = 14
    MOSTLY_Q4_K_M = 15
    MOSTLY_Q5_K_S = 16
    MOSTLY_Q5_K_M = 17
    MOSTLY_Q6_K = 18
    MOSTLY_IQ2_XXS = 19
    MOSTLY_IQ2_XS = 20
    MOSTLY_Q2_K_S = 21
    MOSTLY_IQ3_XS = 22
    MOSTLY_IQ3_XXS = 23
    MOSTLY_IQ1_S = 24
    MOSTLY_IQ4_NL = 25
    MOSTLY_IQ3_S = 26
    MOSTLY_IQ3_M = 27
    MOSTLY_IQ2_S = 28
    MOSTLY_IQ2_M = 29
    MOSTLY_IQ4_XS = 30
    MOSTLY_IQ1_M = 31
    MOSTLY_BF16 = 32
    MOSTLY_TQ1_0 = 36
    MOSTLY_TQ2_0 = 37
