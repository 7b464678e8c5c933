"""Synthetic models: random packed Q4_0 / Q8_0 blocks at real shapes.

Counterpart of the JAX package's tools/synth.py (`CONFIGS`,
`synth_qtensor`), plus `write_synth_gguf`, which writes a whole model as a
GGUF file so the port's loader and CLI run on it. The blocks are random bits
with small finite f16 scales — no quantizer runs — so a full-width 7B file
is written in seconds; decode cost does not depend on weight values.
"""

from __future__ import annotations

import numpy as np

from ..gguf.constants import GGML_TYPE_TRAITS, GGMLType
from ..gguf.writer import GGUFWriter
from ..models.llama import LlamaConfig
from ..ops.qtensor import QTensor, repack
from ..ops.rope import RopeParams
from ..quant.blocks import DT

# flagship configs (shapes of the reference's target model zoo)
LLAMA3_8B = LlamaConfig(
    arch="llama", n_layers=32, n_embd=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    n_ff=14336, n_vocab=128256, n_ctx_train=8192, rms_eps=1e-5,
    rope=RopeParams(n_dims=128, mode="norm", freq_base=500000.0),
)
TINYLLAMA_1B = LlamaConfig(
    arch="llama", n_layers=22, n_embd=2048, n_heads=32, n_kv_heads=4, head_dim=64,
    n_ff=5632, n_vocab=32000, n_ctx_train=2048, rms_eps=1e-5,
    rope=RopeParams(n_dims=64, mode="norm", freq_base=10000.0),
)
LLAMA2_7B = LlamaConfig(
    arch="llama", n_layers=32, n_embd=4096, n_heads=32, n_kv_heads=32, head_dim=128,
    n_ff=11008, n_vocab=32000, n_ctx_train=4096, rms_eps=1e-5,
    rope=RopeParams(n_dims=128, mode="norm", freq_base=10000.0),
)
LLAMA2_13B = LlamaConfig(
    arch="llama", n_layers=40, n_embd=5120, n_heads=40, n_kv_heads=40, head_dim=128,
    n_ff=13824, n_vocab=32000, n_ctx_train=4096, rms_eps=1e-5,
    rope=RopeParams(n_dims=128, mode="norm", freq_base=10000.0),
)

CONFIGS = {
    "llama3-8b": LLAMA3_8B,
    "tinyllama-1.1b": TINYLLAMA_1B,
    "llama2-7b": LLAMA2_7B,
    "llama2-13b": LLAMA2_13B,
}


def synth_raw(rng: np.random.Generator, kind: GGMLType, shape: tuple[int, int]) -> np.ndarray:
    """Random GGUF blocks (uint8) for a [N, K] tensor, block scales in [0, 0.02)."""
    n_blocks = shape[0] * shape[1] // GGML_TYPE_TRAITS[kind].block_size
    raw = rng.integers(0, 256, size=n_blocks * DT[kind].itemsize, dtype=np.uint8)
    raw.view(DT[kind])["d"] = (rng.random(n_blocks, dtype=np.float32) * 0.02).astype(np.float16)
    return raw


def synth_qtensor(rng: np.random.Generator, kind: GGMLType, shape: tuple[int, int]) -> QTensor:
    """Random packed blocks with small finite scales (half-sane dequant)."""
    return repack(synth_raw(rng, kind, shape), kind, shape)


def _spm_vocab(n_vocab: int) -> tuple[list[str], list[float], list[int]]:
    """An SPM vocab of n_vocab pieces: <unk> <s> </s>, the 256 byte tokens,
    the printable ASCII characters, then filler words."""
    tokens = ["<unk>", "<s>", "</s>"] + [f"<0x{i:02X}>" for i in range(256)]
    types = [2, 3, 3] + [6] * 256  # UNKNOWN, CONTROL ×2, BYTE ×256
    tokens += ["▁" if c == " " else c for c in map(chr, range(32, 127))]
    tokens += [f"▁w{i}" for i in range(n_vocab - len(tokens))]
    tokens = tokens[:n_vocab]
    types += [1] * (n_vocab - len(types))  # NORMAL
    scores = [0.0] * 259 + [-float(i) for i in range(n_vocab - 259)]
    return tokens, scores, types[:n_vocab]


def write_synth_gguf(path: str, cfg: LlamaConfig, kind: GGMLType, *, seed: int = 0) -> None:
    """Write `cfg` as a GGUF of random `kind` blocks (every matrix, the
    embedding and the LM head included), f32 norm weights of ones and a
    synthetic SPM vocab."""
    rng = np.random.default_rng(seed)
    arch = cfg.arch
    w = GGUFWriter(path, arch)
    w.add_uint32(f"{arch}.block_count", cfg.n_layers)
    w.add_uint32(f"{arch}.context_length", cfg.n_ctx_train)
    w.add_uint32(f"{arch}.embedding_length", cfg.n_embd)
    w.add_uint32(f"{arch}.feed_forward_length", cfg.n_ff)
    w.add_uint32(f"{arch}.attention.head_count", cfg.n_heads)
    w.add_uint32(f"{arch}.attention.head_count_kv", cfg.n_kv_heads)
    w.add_uint32(f"{arch}.rope.dimension_count", cfg.rope.n_dims)
    w.add_float32(f"{arch}.rope.freq_base", cfg.rope.freq_base)
    w.add_float32(f"{arch}.attention.layer_norm_rms_epsilon", cfg.rms_eps)
    w.add_uint32(f"{arch}.vocab_size", cfg.n_vocab)
    tokens, scores, types = _spm_vocab(cfg.n_vocab)
    w.add_kv("tokenizer.ggml.model", "llama")
    w.add_kv("tokenizer.ggml.tokens", tokens)
    w.add_kv("tokenizer.ggml.scores", scores)
    w.add_kv("tokenizer.ggml.token_type", types)

    def add_q(name: str, n: int, k: int) -> None:
        w.add_tensor(name, synth_raw(rng, kind, (n, k)), ggml_type=kind, ne_shape=(k, n))

    c, hd = cfg.n_embd, cfg.head_dim
    ones = np.ones(c, np.float32)
    add_q("token_embd.weight", cfg.n_vocab, c)
    for i in range(cfg.n_layers):
        p = f"blk.{i}."
        w.add_tensor(p + "attn_norm.weight", ones)
        add_q(p + "attn_q.weight", cfg.n_heads * hd, c)
        add_q(p + "attn_k.weight", cfg.n_kv_heads * hd, c)
        add_q(p + "attn_v.weight", cfg.n_kv_heads * hd, c)
        add_q(p + "attn_output.weight", c, cfg.n_heads * hd)
        w.add_tensor(p + "ffn_norm.weight", ones)
        add_q(p + "ffn_gate.weight", cfg.n_ff, c)
        add_q(p + "ffn_up.weight", cfg.n_ff, c)
        add_q(p + "ffn_down.weight", c, cfg.n_ff)
    w.add_tensor("output_norm.weight", ones)
    add_q("output.weight", cfg.n_vocab, c)
    w.write()
