"""Tokenizer facade: special-token partitioning + the SPM and BPE sessions.

Counterpart of the JAX package's tokenizer/__init__.py (reference
src/llama-vocab.cpp llama_vocab::tokenize :2360-2520 and
tokenizer_st_partition :1311+), for the llama SPM and gpt2 byte-level BPE
vocabs. The WPM, UGM and RWKV sessions are queued in ROADMAP.md (queue A,
item A3).
"""

from __future__ import annotations

from dataclasses import dataclass

from .bpe import BpeTokenizer
from .spm import SpmTokenizer, escape_whitespace, unescape_whitespace
from .vocab import TOKEN_NULL, TokenAttr, Vocab, VocabType, bpe_byte_decode

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
        if vocab.vocab_type == VocabType.SPM:
            self._spm = SpmTokenizer(vocab)
        elif vocab.vocab_type == VocabType.BPE:
            self._bpe = BpeTokenizer(vocab)
        else:
            raise NotImplementedError(
                f"tokenizer type {vocab.vocab_type}: only SPM and BPE are ported "
                "(ROADMAP.md queue A, item A3)")

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
        is_prev_special = True  # SPM: prefix the first raw fragment with a space
        if add_special and vocab.add_bos:
            output.append(vocab.bos_id)
        for frag in fragments:
            if frag.is_token:
                output.append(frag.token)
                is_prev_special = True
            elif vocab.vocab_type == VocabType.BPE:
                self._bpe.tokenize(frag.text, output)
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
        if vocab.vocab_type == VocabType.BPE:
            return bpe_byte_decode(text)
        if attr & TokenAttr.BYTE:
            return bytes([int(text[3:5], 16)]) if text.startswith("<0x") else text.encode()
        return unescape_whitespace(text).encode("utf-8")

    def decode(self, tokens: list[int], *, remove_special: bool = False,
               unparse_special: bool = False) -> str:
        """reference llama_vocab::detokenize (llama-vocab.cpp:3000+)."""
        vocab = self.vocab
        toks = list(tokens)
        if remove_special and vocab.add_bos and toks and toks[0] == vocab.bos_id:
            toks = toks[1:]
        if remove_special and vocab.add_eos and toks and toks[-1] == vocab.eos_id:
            toks = toks[:-1]
        raw = b"".join(self.token_to_piece(t, special=unparse_special) for t in toks)
        text = raw.decode("utf-8", errors="replace")
        # spm adds a leading space on encode; strip it back off
        if (vocab.vocab_type == VocabType.SPM and text.startswith(" ")
                and not (unparse_special and vocab.is_control(toks[0]))):
            text = text[1:]
        if vocab.clean_spaces:
            # minimal clean_spaces: collapse the artifacts the reference cleans
            for a, b in ((" .", "."), (" ,", ","), (" !", "!"), (" ?", "?"), (" '", "'"),
                         (" n't", "n't")):
                text = text.replace(a, b)
        return text
