"""Vocabulary loaded from GGUF metadata.

Counterpart of the JAX package's tokenizer/vocab.py, cut down to what the
llama SPM vocab needs. Mirrors reference src/llama-vocab.cpp: token
list/scores/types, the SPM defaults (add_bos/add_space_prefix,
:1630-1665), the special-token cache sorted by text length (:1985-2013), and
the byte→token fallback (:2827-2850). The other vocab types' defaults (BPE
merges and pre-tokenizer presets, WPM, UGM) are queued in ROADMAP.md with
their tokenizers.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any

from ..gguf.constants import Keys, TokenType

TOKEN_NULL = -1


class VocabType(enum.Enum):
    NONE = "none"
    SPM = "spm"  # sentencepiece-style byte-fallback BPE (tokenizer.ggml.model = "llama")
    BPE = "bpe"  # gpt2 byte-level BPE
    WPM = "wpm"  # bert wordpiece
    UGM = "ugm"  # t5 unigram
    RWKV = "rwkv"


_MODEL_TO_TYPE = {
    "no_vocab": VocabType.NONE,
    "none": VocabType.NONE,
    "llama": VocabType.SPM,
    "gpt2": VocabType.BPE,
    "bert": VocabType.WPM,
    "t5": VocabType.UGM,
    "rwkv": VocabType.RWKV,
}


class TokenAttr(enum.IntFlag):
    """reference include/llama.h llama_token_attr."""

    UNDEFINED = 0
    UNKNOWN = 1 << 0
    UNUSED = 1 << 1
    NORMAL = 1 << 2
    CONTROL = 1 << 3
    USER_DEFINED = 1 << 4
    BYTE = 1 << 5
    NORMALIZED = 1 << 6
    LSTRIP = 1 << 7
    RSTRIP = 1 << 8
    SINGLE_WORD = 1 << 9


_TYPE_TO_ATTR = {
    int(TokenType.UNDEFINED): TokenAttr.UNDEFINED,
    int(TokenType.NORMAL): TokenAttr.NORMAL,
    int(TokenType.UNKNOWN): TokenAttr.UNKNOWN,
    int(TokenType.CONTROL): TokenAttr.CONTROL,
    int(TokenType.USER_DEFINED): TokenAttr.USER_DEFINED,
    int(TokenType.UNUSED): TokenAttr.UNUSED,
    int(TokenType.BYTE): TokenAttr.BYTE,
}

# end-of-generation tokens recognised by text (reference llama-vocab.cpp)
_EOG_TEXTS = ("<|eot_id|>", "<|im_end|>", "<|end|>", "<end_of_turn>", "<|endoftext|>",
              "<EOT>", "_<EOT>", "<｜end▁of▁sentence｜>")


@dataclass
class Vocab:
    vocab_type: VocabType
    tokens: list[str]
    scores: list[float]
    attrs: list[TokenAttr]

    add_bos: bool = False
    add_eos: bool = False
    add_space_prefix: bool = False

    bos_id: int = TOKEN_NULL
    eos_id: int = TOKEN_NULL
    eot_id: int = TOKEN_NULL
    eom_id: int = TOKEN_NULL
    unk_id: int = TOKEN_NULL

    token_to_id: dict[str, int] = field(default_factory=dict, repr=False)
    special_tokens: list[int] = field(default_factory=list, repr=False)
    eog_ids: set[int] = field(default_factory=set, repr=False)

    def __post_init__(self) -> None:
        if not self.token_to_id:
            # last occurrence wins (reference llama-vocab.cpp:1696 assigns in a loop)
            for i, t in enumerate(self.tokens):
                self.token_to_id[t] = i
        if not self.special_tokens:
            special = [
                i
                for i, a in enumerate(self.attrs)
                if a & (TokenAttr.CONTROL | TokenAttr.USER_DEFINED | TokenAttr.UNKNOWN)
            ]
            # sorted by token text length, longest first (llama-vocab.cpp:2009)
            special.sort(key=lambda i: -len(self.tokens[i]))
            self.special_tokens = special
        if not self.eog_ids:
            for tid in (self.eos_id, self.eot_id, self.eom_id):
                if tid != TOKEN_NULL:
                    self.eog_ids.add(tid)
            for i, t in enumerate(self.tokens):
                if t in _EOG_TEXTS and self.attrs[i] & TokenAttr.CONTROL:
                    self.eog_ids.add(i)

    @property
    def n_tokens(self) -> int:
        return len(self.tokens)

    def byte_to_token(self, byte: int) -> int:
        """SPM byte fallback: the <0xXX> token, else the character itself."""
        tok = self.token_to_id.get(f"<0x{byte:02X}>")
        if tok is not None:
            return tok
        return self.token_to_id[chr(byte)]

    def is_eog(self, tid: int) -> bool:
        return tid in self.eog_ids

    @classmethod
    def from_gguf_kv(cls, kv: dict[str, Any]) -> "Vocab":
        model = str(kv.get(Keys.Tokenizer.MODEL, "llama"))
        vtype = _MODEL_TO_TYPE.get(model)
        if vtype is None:
            raise ValueError(f"unknown tokenizer model {model!r}")
        tokens = list(kv.get(Keys.Tokenizer.LIST, []))
        n = len(tokens)
        scores_raw = kv.get(Keys.Tokenizer.SCORES)
        scores = [float(s) for s in scores_raw] if scores_raw is not None else [0.0] * n
        types_raw = kv.get(Keys.Tokenizer.TOKEN_TYPE)
        if types_raw is not None:
            attrs = [_TYPE_TO_ATTR.get(int(t), TokenAttr.UNDEFINED) for t in types_raw]
        else:
            attrs = [TokenAttr.NORMAL] * n

        v = cls(vtype, tokens, scores, attrs)
        if vtype == VocabType.SPM:  # reference llama-vocab.cpp:1630-1665
            v.add_space_prefix = True
            v.add_bos, v.add_eos = True, False
            v.bos_id, v.eos_id, v.unk_id = 1, 2, 0

        # explicit overrides from GGUF
        for key, attr in [
            (Keys.Tokenizer.BOS_ID, "bos_id"),
            (Keys.Tokenizer.EOS_ID, "eos_id"),
            (Keys.Tokenizer.EOT_ID, "eot_id"),
            (Keys.Tokenizer.EOM_ID, "eom_id"),
            (Keys.Tokenizer.UNK_ID, "unk_id"),
        ]:
            if key in kv:
                setattr(v, attr, int(kv[key]))
        for key, attr in [
            (Keys.Tokenizer.ADD_BOS, "add_bos"),
            (Keys.Tokenizer.ADD_EOS, "add_eos"),
            (Keys.Tokenizer.ADD_SPACE_PREFIX, "add_space_prefix"),
        ]:
            if key in kv:
                setattr(v, attr, bool(kv[key]))
        v.__post_init__()  # rebuild caches after overrides (as the JAX package does)
        return v
