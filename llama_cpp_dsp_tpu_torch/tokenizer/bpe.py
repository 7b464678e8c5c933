"""Byte-level BPE tokenizer (gpt2 family).

Counterpart of the JAX package's tokenizer/bpe.py, its Python merge loop
(`BpeTokenizer(vocab, use_native=False)`; the native C++ twin is not
ported). Faithful to reference src/llama-vocab.cpp
llm_tokenizer_bpe(_session) (:364-640) + src/unicode.cpp unicode_regex_split
(:670-848):
- per-pre-type regex pre-tokenization applied sequentially; matches and the
  gaps between them all become words
- words are byte-encoded into the gpt2 byte-alphabet before merging
  (unicode_byte_encoding_process, unicode.cpp:218)
- merge loop: lowest merge rank first, ties by lower left index
  (llm_bigram_bpe comparator), stale-entry skip by concatenated text
- unmatched symbols fall back to per-byte token lookup (missing → dropped)

The presets are the JAX package's, as data; stdlib `re` compiles them after
unicode_re.translate spells out their \\p{...} classes (the JAX package
uses the third-party `regex` module, which the port does not).
"""

from __future__ import annotations

import heapq
import re
from functools import lru_cache

from .unicode_re import translate
from .vocab import TOKEN_NULL, Vocab, bpe_byte_encode

# Pre-tokenizer regex presets — reference src/llama-vocab.cpp:367-510.
# Keyed by pre_type string from tokenizer.ggml.pre.
_GPT2 = r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)"""
_LLAMA3 = r"""(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+"""
_QWEN2 = r"""(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+"""
_STARCODER = [r"\p{N}", _GPT2]
_GPT4O = r"""[^\r\n\p{L}\p{N}]?[\p{Lu}\p{Lt}\p{Lm}\p{Lo}\p{M}]*[\p{Ll}\p{Lm}\p{Lo}\p{M}]+(?i:'s|'t|'re|'ve|'m|'ll|'d)?|[^\r\n\p{L}\p{N}]?[\p{Lu}\p{Lt}\p{Lm}\p{Lo}\p{M}]+[\p{Ll}\p{Lm}\p{Lo}\p{M}]*(?i:'s|'t|'re|'ve|'m|'ll|'d)?|\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n/]*|\s*[\r\n]+|\s+(?!\S)|\s+"""

_DEEPSEEK_LETTERS = (
    "\\s?[A-Za-zµÀ-ÖØ-öø-ƺƼ-ƿǄ-ʓʕ-ʯͰ-ͳͶͷͻ-ͽͿΆΈ-ΊΌΎ-ΡΣ-ϵϷ-ҁҊ-ԯԱ-ՖႠ-ჅᎠ-Ᏽᏸ-ᏽᲐ-ᲺᲽ-Ჿᴀ-ᴫᵫ-ᵷᵹ-ᶚḀ-ἕἘ-Ἕἠ-ὅὈ-Ὅὐ-ὗὙὛὝὟ-ώᾀ-ᾴᾶ-ᾼιῂ-ῄῆ-ῌῐ-ΐῖ-Ίῠ-Ῥῲ-ῴῶ-ῼℂℇℊ-ℓℕℙ-ℝℤΩℨK-ℭℯ-ℴℹℼ-ℿⅅ-ⅉⅎↃↄⰀ-ⱻⱾ-ⳤⳫ-ⳮⳲⳳꙀ-ꙭꚀ-ꚛꜢ-ꝯꝱ-ꞇꞋ-ꞎꭰ-ꮿﬀ-ﬆﬓ-ﬗＡ-Ｚａ-ｚ\\U00010400-\\U0001044f\\U000104b0-\\U000104d3\\U000104d8-\\U000104fb\\U00010c80-\\U00010cb2\\U00010cc0-\\U00010cf2\\U000118a0-\\U000118df\\U0001e900-\\U0001e943]+"
)

PRE_REGEXES: dict[str, list[str]] = {
    "default": [r"[\p{P}\$\+<=>\^~\|]+", _GPT2, r"\p{N}+", r"[0-9][0-9][0-9]"],
    "llama3": [_LLAMA3],
    "llama-v3": [_LLAMA3],
    "llama-bpe": [_LLAMA3],
    "falcon3": [_LLAMA3],
    "dbrx": [_LLAMA3],
    "smaug-bpe": [_LLAMA3],
    "deepseek-llm": [
        r"[\r\n]",
        _DEEPSEEK_LETTERS,
        "\\s?[!-/:-~\uff01-\uff0f\uff1a-\uff5e\u2018-\u201f\u3000-\u3002]+",
        r"\s+$",
        "[\u4e00-\u9fa5\u0800-\u4e00\uac00-\ud7ff]+",
        r"\p{N}+",
    ],
    "deepseek-coder": [
        r"[\r\n]",
        r"\s?\p{L}+",
        r"\s?\p{P}+",
        "[\u4e00-\u9fa5\u0800-\u4e00\uac00-\ud7ff]+",
        r"\p{N}",
    ],
    "deepseek-v3": [
        r"\p{N}{1,3}",
        "[\u4e00-\u9fa5\u3040-\u309f\u30a0-\u30ff]+",
        r"""[!"#$%&'()*+,\-./:;<=>?@\[\\\]^_`{|}~][A-Za-z]+|[^\r\n\p{L}\p{P}\p{S}]?[\p{L}\p{M}]+| ?[\p{P}\p{S}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+""",
    ],
    "deepseek-r1-qwen": [_QWEN2],
    "falcon": [
        r"[\p{P}\$\+<=>\^~\|`]+",
        _GPT2,
        r"[0-9][0-9][0-9]",
    ],
    "starcoder": _STARCODER,
    "refact": _STARCODER,
    "command-r": _STARCODER,
    "smollm": _STARCODER,
    "codeshell": _STARCODER,
    "exaone": _STARCODER,
    "minerva-7b": _STARCODER,
    "gpt-2": [_GPT2],
    "mpt": [_GPT2],
    "olmo": [_GPT2],
    "jais": [_GPT2],
    "trillion": [_GPT2],
    "stablelm2": [_QWEN2],
    "qwen2": [_QWEN2],
    "poro-chat": [" ?[^(\\s|.,!?\u2026\u3002\uff0c\u3001\u0964\u06d4\u060c)]+"],
    "bloom": [" ?[^(\\s|.,!?\u2026\u3002\uff0c\u3001\u0964\u06d4\u060c)]+"],
    "gpt3-finnish": [" ?[^(\\s|.,!?\u2026\u3002\uff0c\u3001\u0964\u06d4\u060c)]+"],
    "chatglm-bpe": [_LLAMA3],
    "viking": [" ?[^(\\s|.,!?\u2026\u3002\uff0c\u3001\u0964\u06d4\u060c)]+", r"\p{N}"],
    "tekken": [
        r"[^\r\n\p{L}\p{N}]?[\p{Lu}\p{Lt}\p{Lm}\p{Lo}\p{M}]*[\p{Ll}\p{Lm}\p{Lo}\p{M}]+|[^\r\n\p{L}\p{N}]?[\p{Lu}\p{Lt}\p{Lm}\p{Lo}\p{M}]+[\p{Ll}\p{Lm}\p{Lo}\p{M}]*|\p{N}| ?[^\s\p{L}\p{N}]+[\r\n/]*|\s*[\r\n]+|\s+(?!\S)|\s+"
    ],
    "chameleon": [
        r"<sentinel:[0-9]+>",
        r"(IMGIMG)((A|B|C|D|E|F|G|H|I){1,4})Z",
        r"([\t\n]|    |  )",
        r"\p{N}",
        r"[\p{P}!-/:-@\[-`{-~]",
        _GPT2,
    ],
    "gpt-4o": [_GPT4O],
    "superbpe": [r"\p{N}+", r"(?=(\d{3})+(?!\d))"],
    "bailingmoe": [
        r"'(?i:[sdmt]|ll|ve|re)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]|\s+(?!\S)|\s+"
    ],
}


@lru_cache(maxsize=None)
def _compile(expr: str) -> re.Pattern:
    return re.compile(translate(expr))


def regex_split(text: str, exprs: list[str]) -> list[str]:
    """Sequentially split text by each regex; matches and gaps both become
    pieces (reference unicode_regex_split semantics)."""
    pieces = [text]
    for expr in exprs:
        pat = _compile(expr)
        out: list[str] = []
        for piece in pieces:
            prev = 0
            for m in pat.finditer(piece):
                s, e = m.span()
                if e == s:
                    continue  # zero-width match: boundary only
                if s > prev:
                    out.append(piece[prev:s])
                out.append(piece[s:e])
                prev = e
            if prev < len(piece):
                out.append(piece[prev:])
        pieces = out
    return pieces


class BpeTokenizer:
    def __init__(self, vocab: Vocab):
        self.vocab = vocab
        self.regex_exprs = PRE_REGEXES.get(vocab.pre, PRE_REGEXES["default"])

    def tokenize(self, text: str, output: list[int]) -> None:
        vocab = self.vocab
        final_symbols: list[str] = []
        for word in (bpe_byte_encode(w) for w in regex_split(text, self.regex_exprs)):
            if vocab.ignore_merges and vocab.text_to_token(word) != TOKEN_NULL:
                final_symbols.append(word)
                continue
            final_symbols.extend(self._merge(word))
        for sym in final_symbols:
            token = vocab.text_to_token(sym)
            if token != TOKEN_NULL:
                output.append(token)
            else:
                for ch in sym:
                    tid = vocab.text_to_token(ch)
                    if tid != TOKEN_NULL:
                        output.append(tid)

    def _merge(self, word: str) -> list[str]:
        """The merge loop over one byte-encoded word → its symbols."""
        vocab = self.vocab
        n = len(word)
        if n == 0:
            return []
        texts = list(word)  # unicode chars of the byte-encoded word
        size = [len(s) for s in texts]
        prev = list(range(-1, n - 1))
        nxt = list(range(1, n + 1))
        nxt[-1] = -1
        heap: list[tuple[int, int, int, str]] = []  # (rank, left, right, text)

        def add_bigram(left: int, right: int) -> None:
            if left == -1 or right == -1:
                return
            rank = vocab.find_bpe_rank(texts[left], texts[right])
            if rank >= 0:
                heapq.heappush(heap, (rank, left, right, texts[left] + texts[right]))

        for i in range(1, n):
            add_bigram(i - 1, i)
        while heap:
            _, left, right, cat = heapq.heappop(heap)
            if size[left] == 0 or size[right] == 0:
                continue
            if texts[left] + texts[right] != cat:
                continue  # outdated entry
            texts[left] = cat
            size[left] += size[right]
            size[right] = 0
            nxt[left] = nxt[right]
            if nxt[right] >= 0:
                prev[nxt[right]] = left
            add_bigram(prev[left], left)
            add_bigram(left, nxt[left])
        out = []
        i = 0
        while i != -1:
            if size[i] > 0:
                out.append(texts[i])
            i = nxt[i]
        return out
