"""SPM (sentencepiece-style) tokenizer.

Greedy highest-score bigram merging with byte fallback, faithful to
reference src/llama-vocab.cpp llm_tokenizer_spm_session (:111-236):
priority = higher score first, ties broken by lower left index
(llm_bigram_spm::comparator :94-98); unmatched symbols resegment through
rev_merge then fall back to <0xXX> byte tokens.
"""

from __future__ import annotations

import heapq

from .vocab import TOKEN_NULL, Vocab


_UTF8_LEN = (1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 3, 4)


def _utf8_len(b: int) -> int:
    """unicode_len_utf8: leading-byte high nibble → sequence length."""
    return _UTF8_LEN[b >> 4]


def escape_whitespace(text: str) -> str:
    """llama_escape_whitespace: ' ' → U+2581 (▁)."""
    return text.replace(" ", "▁")


def unescape_whitespace(text: str) -> str:
    return text.replace("▁", " ")


class SpmTokenizer:
    def __init__(self, vocab: Vocab):
        self.vocab = vocab

    def tokenize(self, text: str, output: list[int]) -> None:
        data = text.encode("utf-8")
        if not data:
            return

        # split into utf-8 characters (byte spans)
        sym_bytes: list[bytes] = []
        offs = 0
        while offs < len(data):
            n = min(_utf8_len(data[offs]), len(data) - offs)
            sym_bytes.append(data[offs : offs + n])
            offs += n

        n_sym = len(sym_bytes)
        prev = list(range(-1, n_sym - 1))
        nxt = list(range(1, n_sym + 1))
        nxt[-1] = -1
        size = [len(b) for b in sym_bytes]
        texts = sym_bytes[:]  # current text per live symbol

        heap: list[tuple[float, int, int, int]] = []  # (-score, left, right, size)
        rev_merge: dict[bytes, tuple[int, int]] = {}

        vocab = self.vocab

        def try_add_bigram(left: int, right: int) -> None:
            if left == -1 or right == -1:
                return
            cat = texts[left] + texts[right]
            try:
                token = vocab.token_to_id.get(cat.decode("utf-8"), TOKEN_NULL)
            except UnicodeDecodeError:
                return
            if token == TOKEN_NULL or token >= vocab.n_tokens:
                return
            score = vocab.scores[token]
            heapq.heappush(heap, (-score, left, right, len(cat)))
            rev_merge[cat] = (left, right)

        for i in range(1, n_sym):
            try_add_bigram(i - 1, i)

        while heap:
            neg_score, left, right, bsize = heapq.heappop(heap)
            if size[left] == 0 or size[right] == 0 or size[left] + size[right] != bsize:
                continue
            # merge right into left
            texts[left] = texts[left] + texts[right]
            size[left] += size[right]
            size[right] = 0
            nxt[left] = nxt[right]
            if nxt[right] >= 0:
                prev[nxt[right]] = left
            try_add_bigram(prev[left], left)
            try_add_bigram(left, nxt[left])

        def resegment(i: int) -> None:
            bs = texts[i]
            try:
                token = vocab.token_to_id.get(bs.decode("utf-8"), TOKEN_NULL)
            except UnicodeDecodeError:
                token = TOKEN_NULL
            if token != TOKEN_NULL:
                output.append(token)
                return
            pair = rev_merge.get(bs)
            if pair is None:
                for byte in bs:
                    output.append(vocab.byte_to_token(byte))
                return
            resegment(pair[0])
            resegment(pair[1])

        i = 0
        while i != -1:
            if size[i] > 0:
                resegment(i)
            i = nxt[i]
