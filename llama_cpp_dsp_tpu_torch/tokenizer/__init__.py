"""Tokenizer facade: special-token partitioning + the SPM session.

Counterpart of the JAX package's tokenizer/__init__.py (reference
src/llama-vocab.cpp llama_vocab::tokenize :2360-2520 and
tokenizer_st_partition :1311+), for the llama SPM vocab. The BPE, WPM, UGM
and RWKV sessions are queued in ROADMAP.md (queue A, slice 3).
"""

from __future__ import annotations

from dataclasses import dataclass

from .spm import SpmTokenizer, escape_whitespace, unescape_whitespace
from .vocab import TOKEN_NULL, TokenAttr, Vocab, VocabType

__all__ = ["Tokenizer", "Vocab", "VocabType", "TokenAttr"]


@dataclass
class _Fragment:
    token: int = TOKEN_NULL  # set → special-token fragment
    text: str = ""  # set → raw-text fragment

    @property
    def is_token(self) -> bool:
        return self.token != TOKEN_NULL


def _isspace_c(ch: str) -> bool:
    """C isspace() over the byte — reference uses it on raw utf-8 bytes."""
    return ch in " \t\n\r\x0b\x0c"


class Tokenizer:
    def __init__(self, vocab: Vocab):
        self.vocab = vocab
        if vocab.vocab_type != VocabType.SPM:
            raise NotImplementedError(
                f"tokenizer type {vocab.vocab_type}: only SPM is ported "
                "(ROADMAP.md queue A, slice 3)")
        self._spm = SpmTokenizer(vocab)

    def _partition(self, text: str, parse_special: bool) -> list[_Fragment]:
        fragments = [_Fragment(text=text)]
        vocab = self.vocab
        for special_id in vocab.special_tokens:
            attr = vocab.attrs[special_id]
            if not parse_special and attr & (TokenAttr.CONTROL | TokenAttr.UNKNOWN):
                continue
            st = vocab.tokens[special_id]
            if not st:
                continue
            out: list[_Fragment] = []
            for frag in fragments:
                if frag.is_token or not frag.text:
                    out.append(frag)
                    continue
                rest = frag.text
                while rest:
                    pos = rest.find(st)
                    if pos < 0:
                        out.append(_Fragment(text=rest))
                        break
                    left = rest[:pos]
                    if attr & TokenAttr.LSTRIP:
                        while left and _isspace_c(left[-1]):
                            left = left[:-1]
                    if left:
                        out.append(_Fragment(text=left))
                    out.append(_Fragment(token=special_id))
                    rest = rest[pos + len(st):]
                    if attr & TokenAttr.RSTRIP:
                        while rest and _isspace_c(rest[0]):
                            rest = rest[1:]
            fragments = out
        return fragments

    def encode(self, text: str, *, add_special: bool = True,
               parse_special: bool = False) -> list[int]:
        vocab = self.vocab
        output: list[int] = []
        fragments = self._partition(text, parse_special) if text else []
        is_prev_special = True  # prefix the first raw fragment with a space
        if add_special and vocab.add_bos:
            output.append(vocab.bos_id)
        for frag in fragments:
            if frag.is_token:
                output.append(frag.token)
                is_prev_special = True
            else:
                t = frag.text
                if vocab.add_space_prefix and is_prev_special:
                    t = " " + t
                self._spm.tokenize(escape_whitespace(t), output)
                is_prev_special = False
        if add_special and vocab.add_eos:
            output.append(vocab.eos_id)
        return output

    def token_to_piece(self, tid: int, *, special: bool = True) -> bytes:
        """reference llama_vocab::token_to_piece (llama-vocab.cpp:2861+)."""
        vocab = self.vocab
        attr = vocab.attrs[tid]
        text = vocab.tokens[tid]
        if attr & (TokenAttr.CONTROL | TokenAttr.UNKNOWN):
            return text.encode("utf-8") if special else b""
        if attr & TokenAttr.BYTE:
            return bytes([int(text[3:5], 16)]) if text.startswith("<0x") else text.encode()
        return unescape_whitespace(text).encode("utf-8")
