"""The port's byte-level BPE tokenizer against the JAX package's.

The port's pre-tokenizer compiles the JAX presets with the standard
library's `re` (unicode_re spells out the \\p{...} classes); it must split
exactly as the JAX `regex_split` does, for every preset. Token ids, pieces
and decoded text must equal the JAX package's Python merge loop
(`BpeTokenizer(vocab, use_native=False)`). The corpus avoids code points
assigned after Unicode 15.0, the database of Python 3.12's `unicodedata`.
"""

import pytest

from llama_cpp_dsp_tpu.gguf.reader import GGUFModel as JaxGGUFModel
from llama_cpp_dsp_tpu.tokenizer import Tokenizer as JaxTokenizer
from llama_cpp_dsp_tpu.tokenizer import Vocab as JaxVocab
from llama_cpp_dsp_tpu.tokenizer.bpe import PRE_REGEXES as JAX_PRE_REGEXES
from llama_cpp_dsp_tpu.tokenizer.bpe import BpeTokenizer as JaxBpeTokenizer
from llama_cpp_dsp_tpu.tokenizer.bpe import regex_split as jax_regex_split
from llama_cpp_dsp_tpu_torch.gguf.reader import GGUFModel
from llama_cpp_dsp_tpu_torch.tokenizer import Tokenizer, Vocab
from llama_cpp_dsp_tpu_torch.tokenizer.bpe import PRE_REGEXES, BpeTokenizer, regex_split
from llama_cpp_dsp_tpu_torch.tokenizer.unicode_re import translate
from llama_cpp_dsp_tpu_torch.tools.synth import bpe_vocab
from test_tokenizer_reference import MODELS_DIR
from torch_fixtures import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

CORPUS = [
    "Hello world! It's a test, isn't it? I'VE got 12345 apples.",
    "  leading spaces\tand\ttabs\r\nnew lines\n\n\nend  ",
    "数字123と日本語のテキスト。中文，标点！한국어 텍스트",
    "Café naïve résumé façade Ångström ǅemal Ǆ ǆ",
    "emoji 🎉🚀 mixed 👍🏽 text 😀!!",
    "Ⅻ ² ½ ٣ ߃ ௰ numbers: 3.14159, 1,000,000 and 007",
    'code: def f(x): return x**2 + y_z / 3 // {a: [b]} <tag attr="v">',
    "\x1c\x1d\x1e\x1f separators nbsp em　ideo",
    "Ελληνικά Русский текст עברית العربية हिन्दी",
    "<sentinel:12> IMGIMGABZ IMGIMGZ    four spaces\t\n",
    "CamelCaseWords HTTPServer don'T WON'T they'll we'd",
    "1234567890123 9999 00000 a1b22c333",
    "á ë combining marks ̀ alone",
    "",
]


def test_presets_are_the_jax_presets():
    assert PRE_REGEXES == JAX_PRE_REGEXES


@pytest.mark.parametrize("pre", sorted(JAX_PRE_REGEXES))
def test_pre_tokenizer_splits_like_jax(pre):
    for text in CORPUS:
        assert regex_split(text, PRE_REGEXES[pre]) == jax_regex_split(
            text, JAX_PRE_REGEXES[pre]), (pre, text)


def test_translate_keeps_plain_syntax():
    plain = r"[\r\n]|a{1,3}|\d+(?=x)|[^\]a]|[]a]"
    assert translate(plain) == plain.replace("[]", "[\\]")
    assert "\\u0041" in translate(r"\p{Lu}") and "\\u001c" not in translate(r"\s")
    with pytest.raises(ValueError):
        translate(r"\p{Xx}")


def _vocabs(n_vocab=2048, pre="llama-bpe", ignore_merges=None):
    kv = bpe_vocab(n_vocab)
    kv["tokenizer.ggml.pre"] = pre
    ours, theirs = Vocab.from_gguf_kv(kv), JaxVocab.from_gguf_kv(kv)
    if ignore_merges is not None:
        ours.ignore_merges = theirs.ignore_merges = ignore_merges
    assert ours.bpe_ranks == theirs.bpe_ranks and len(ours.bpe_ranks) == n_vocab - 512
    assert ours.eog_ids == theirs.eog_ids
    assert [ours.byte_to_token(b) for b in range(256)] == [theirs.byte_to_token(b)
                                                            for b in range(256)]
    assert (ours.add_bos, ours.ignore_merges, ours.clean_spaces, ours.bos_id, ours.eos_id,
            ours.eot_id) == (theirs.add_bos, theirs.ignore_merges, theirs.clean_spaces,
                             theirs.bos_id, theirs.eos_id, theirs.eot_id)
    return ours, theirs


@pytest.mark.parametrize("pre,ignore_merges", [("llama-bpe", None), ("llama-bpe", False),
                                               ("gpt-2", None), ("qwen2", True)])
def test_bpe_ids_match_jax_merge_loop(pre, ignore_merges):
    ours, theirs = _vocabs(pre=pre, ignore_merges=ignore_merges)
    tok, jtok = BpeTokenizer(ours), JaxBpeTokenizer(theirs, use_native=False)
    for text in CORPUS + ["the quick brown fox", "Abc abc ABC aBc " * 3]:
        got, want = [], []
        tok.tokenize(text, got)
        jtok.tokenize(text, want)
        assert got == want, (pre, text)


def _tokenizers(vocab, jax_vocab):
    jt = JaxTokenizer(jax_vocab)
    jt._bpe = JaxBpeTokenizer(jax_vocab, use_native=False)
    return Tokenizer(vocab), jt


def test_encode_decode_with_control_tokens_match_jax():
    tok, jtok = _tokenizers(*_vocabs())
    chat = ("<|begin_of_text|><|start_header_id|>system<|end_header_id|>\n\nBe brief."
            "<|eot_id|><|start_header_id|>user<|end_header_id|>\n\nWhy is the sky blue?"
            "<|eot_id|><|start_header_id|>assistant<|end_header_id|>\n\n")
    for text in [chat, *CORPUS]:
        for add_special in (True, False):
            for parse_special in (True, False):
                ids = tok.encode(text, add_special=add_special, parse_special=parse_special)
                assert ids == jtok.encode(text, add_special=add_special,
                                          parse_special=parse_special)
        ids = tok.encode(text, parse_special=True)
        for special in (True, False):
            assert ([tok.token_to_piece(t, special=special) for t in ids]
                    == [jtok.token_to_piece(t, special=special) for t in ids])
        for remove, unparse in ((False, False), (True, True), (True, False)):
            assert (tok.decode(ids, remove_special=remove, unparse_special=unparse)
                    == jtok.decode(ids, remove_special=remove, unparse_special=unparse))
    ids = tok.encode(chat, parse_special=True)
    assert ids[:2] == [tok.vocab.bos_id] * 2 and ids.count(tok.vocab.eot_id) == 2
    assert tok.vocab.is_eog(tok.vocab.eot_id)
    # as in the JAX vocab, the GGUF's eos (<|end_of_text|>) is not an
    # end-of-generation token: ROADMAP.md queue C
    assert not tok.vocab.is_eog(tok.vocab.eos_id)


@pytest.mark.parametrize("name", ["llama-bpe"])
def test_reference_vocab_vectors(name):
    """The reference's own test vectors for a real BPE vocab (as
    tests/test_tokenizer_reference.py holds the JAX tokenizer to them)."""
    gguf = MODELS_DIR / f"ggml-vocab-{name}.gguf"
    if not (gguf.exists() and gguf.with_suffix(".gguf.inp").exists()):
        pytest.skip(f"{gguf} and its .inp/.out vectors are not present")
    vocab = Vocab.from_gguf_kv(GGUFModel.load(str(gguf)).kv)
    jvocab = JaxVocab.from_gguf_kv(JaxGGUFModel.load(str(gguf)).kv)
    tok, jtok = _tokenizers(vocab, jvocab)
    texts = gguf.with_suffix(".gguf.inp").read_text(encoding="utf-8").split(
        "\n__ggml_vocab_test__\n")
    expected = [[int(t) for t in line.split()] for line in
                gguf.with_suffix(".gguf.out").read_text(encoding="utf-8").split("\n")]
    for text, want in zip(texts, expected):
        got = tok.encode(text, add_special=False, parse_special=False)
        assert got == want == jtok.encode(text, add_special=False, parse_special=False), text
