"""Vocabulary loaded from GGUF metadata.

Counterpart of the JAX package's tokenizer/vocab.py, cut down to what the
llama SPM and gpt2 byte-level BPE vocabs need. Mirrors reference
src/llama-vocab.cpp: token list/scores/types, the per-type defaults
(add_bos/add_space_prefix, :1630-1665), BPE merge ranks (:1425-1440) and the
pre-tokenizer presets that flip vocab flags (:1505-1620), the special-token
cache sorted by text length (:1985-2013), and the byte→token mapping
(:2827-2850). The WPM and UGM defaults and the FIM ids are queued in
ROADMAP.md with their tokenizers.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from functools import lru_cache
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


@lru_cache(maxsize=1)
def byte_to_unicode_map() -> dict[int, str]:
    """gpt2 bytes_to_unicode (reference src/unicode.cpp:154 unicode_byte_to_utf8_map)."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(0xA1, 0xAC + 1))
          + list(range(0xAE, 0xFF + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


@lru_cache(maxsize=1)
def unicode_to_byte_map() -> dict[str, int]:
    return {c: b for b, c in byte_to_unicode_map().items()}


def bpe_byte_encode(word: str) -> str:
    """UTF-8 bytes → gpt2 byte-alphabet string (unicode_byte_encoding_process)."""
    m = byte_to_unicode_map()
    return "".join(m[b] for b in word.encode("utf-8"))


def bpe_byte_decode(piece: str) -> bytes:
    m = unicode_to_byte_map()
    return bytes(m.get(ch, 0) for ch in piece)


@dataclass
class Vocab:
    vocab_type: VocabType
    tokens: list[str]
    scores: list[float]
    attrs: list[TokenAttr]
    pre: str = "default"  # tokenizer.ggml.pre: the BPE pre-tokenizer preset

    add_bos: bool = False
    add_eos: bool = False
    add_space_prefix: bool = False
    ignore_merges: bool = False  # BPE: a word that is a token is not merged
    clean_spaces: bool = False
    chat_template: str | None = None  # tokenizer.chat_template (jinja text)

    bos_id: int = TOKEN_NULL
    eos_id: int = TOKEN_NULL
    eot_id: int = TOKEN_NULL
    eom_id: int = TOKEN_NULL
    unk_id: int = TOKEN_NULL

    bpe_ranks: dict[tuple[str, str], int] = field(default_factory=dict, repr=False)
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

    def text_to_token(self, text: str) -> int:
        return self.token_to_id.get(text, TOKEN_NULL)

    def byte_to_token(self, byte: int) -> int:
        """SPM: the <0xXX> token, else the character itself; BPE: the byte's
        gpt2 byte-alphabet character."""
        if self.vocab_type == VocabType.BPE:
            return self.token_to_id[byte_to_unicode_map()[byte]]
        tok = self.token_to_id.get(f"<0x{byte:02X}>")
        if tok is not None:
            return tok
        return self.token_to_id[chr(byte)]

    def find_bpe_rank(self, left: str, right: str) -> int:
        return self.bpe_ranks.get((left, right), -1)

    def is_eog(self, tid: int) -> bool:
        return tid in self.eog_ids

    def is_control(self, tid: int) -> bool:
        return bool(self.attrs[tid] & TokenAttr.CONTROL)

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
        elif vtype == VocabType.BPE:
            v.clean_spaces = True
            v.bos_id = v.eos_id = 11
            v.pre = str(kv.get(Keys.Tokenizer.PRE, "default"))
            v.add_bos = v.pre in _PRE_ADD_BOS
            v.ignore_merges = v.pre in _PRE_IGNORE_MERGES
            if v.pre in _PRE_NO_CLEAN_SPACES:
                v.clean_spaces = False
            for rank, m in enumerate(kv.get(Keys.Tokenizer.MERGES, [])):
                pos = m.find(" ", 1)
                if pos > 0:
                    v.bpe_ranks[(m[:pos], m[pos + 1:])] = rank

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
        if Keys.Tokenizer.CHAT_TEMPLATE in kv:
            v.chat_template = str(kv[Keys.Tokenizer.CHAT_TEMPLATE])
        v.__post_init__()  # rebuild caches after overrides (as the JAX package does)
        return v


# pre-tokenizer presets that flip vocab flags (llama-vocab.cpp:1505-1620)
_PRE_IGNORE_MERGES = {"llama3", "llama-v3", "llama-bpe", "falcon3", "pixtral", "tekken"}
_PRE_ADD_BOS = {"llama3", "llama-v3", "llama-bpe", "falcon3", "pixtral", "tekken", "jais"}
_PRE_NO_CLEAN_SPACES = {
    "deepseek-llm", "deepseek-coder", "deepseek-v3", "command-r", "qwen2", "deepseek-r1-qwen",
    "olmo", "dbrx", "smaug-bpe", "jina-v1-en", "jina-v2-es", "jina-v2-de", "jina-v2-code",
    "poro-chat", "bloom", "gpt3-finnish", "chatglm-bpe", "viking", "tekken", "smollm",
    "codeshell", "bailingmoe", "exaone", "minerva-7b", "gpt-4o", "superbpe", "trillion",
}
