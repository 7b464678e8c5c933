"""Synthetic models: random packed blocks at real shapes.

Counterpart of the JAX package's tools/synth.py (`CONFIGS`,
`synth_qtensor`), plus `write_synth_gguf`, which writes a whole model as a
GGUF file so the port's loader, CLI and server run on it. The blocks are
random bits with small finite f16 scales — no quantizer runs — so a
full-width 8B file is written in seconds; decode cost does not depend on
weight values. The ftype picks each tensor's kind: every matrix Q4_0, Q4_1
or Q8_0, or llama.cpp's Q2_K / Q3_K_M / Q4_K_M / Q5_K_M mix or IQ / TQ mix
(IQ4_NL, IQ4_XS, IQ2_XXS, IQ2_XS, IQ2_S, IQ2_M, IQ3_XXS, IQ3_XS, IQ3_S,
IQ3_M, IQ1_S, IQ1_M, TQ1_0, TQ2_0; `tensor_type`, with its block-size
fallback for rows whose K is not a multiple of 256).
The vocab is a synthetic SPM one, or a byte-level BPE one in the style of
llama-3 ("llama-bpe"), DeepSeek ("deepseek-llm") or Qwen ("qwen2", with a
ChatML template). The Qwen family's files carry q/k/v biases (qwen2,
qwen2moe) or per-head q/k norms (qwen3, qwen3moe); a phi3 file carries
fused attn_qkv and gate|up ffn_up tensors. An MoE config (n_expert > 0,
e.g. Mixtral-8x7B) gets an f32 router `ffn_gate_inp` [E, C] and expert
stacks `ffn_{gate,up,down}_exps` [E, N, K] in place of the dense FFN; a
DeepSeek-V2 config (arch "deepseek2") gets the MLA attention tensors, a
dense FFN in its leading layers and shared experts `ffn_*_shexp`. Each
tensor's blocks are made when the writer reaches it, so the host holds one
tensor at a time (a Mixtral file is ~26 GB).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from ..gguf.constants import GGML_TYPE_TRAITS, GGMLType
from ..gguf.writer import GGUFWriter
from ..models.llama import LlamaConfig
from ..models.registry import arch_spec
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
# mistralai/Mixtral-8x7B-v0.1 config.json
MIXTRAL_8X7B = LlamaConfig(
    arch="llama", n_layers=32, n_embd=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    n_ff=14336, n_vocab=32000, n_ctx_train=32768, rms_eps=1e-5,
    rope=RopeParams(n_dims=128, mode="norm", freq_base=1000000.0),
    n_expert=8, n_expert_used=2,
)
# deepseek-ai/DeepSeek-V2-Lite config.json: 27 layers, hidden 2048, 16
# heads, MLA (no q LoRA, kv_lora_rank 512, qk_nope 128, qk_rope 64, v_head
# 128), 64 routed experts top-6 (softmax, norm_topk_prob false, routed
# scale 1.0) of width 1408, 2 shared experts, first_k_dense_replace 1 with
# intermediate_size 10944, vocab 102400, rms eps 1e-6, YaRN rope (theta
# 1e4, factor 40, original context 4096), max_position_embeddings 163840.
# GGUF keys as llama.cpp's convert_hf_to_gguf.py writes them
# (`write_synth_gguf`).
DEEPSEEK_V2_LITE = LlamaConfig(
    arch="deepseek2", n_layers=27, n_embd=2048, n_heads=16, n_kv_heads=16, head_dim=192,
    n_ff=10944, n_vocab=102400, n_ctx_train=163840, rms_eps=1e-6,
    rope=RopeParams(n_dims=64, mode="norm", freq_base=10000.0, freq_scale=1 / 40,
                    ext_factor=1.0, n_ctx_orig=4096),
    n_expert=64, n_expert_used=6, moe_norm_weights=False, moe_shared_expert=True,
    kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128, n_dense_layers=1,
)
# (routed expert width, shared experts) a deepseek2 file is written with by
# default: DeepSeek-V2-Lite's moe_intermediate_size and n_shared_experts.
# The forward reads every width from the weights; only the writer needs these.
DEEPSEEK_V2_LITE_EXPERTS = (1408, 2)
# yarn_log_multiplier = 0.1 · mscale_all_dim (0.707), as the converter writes it
DEEPSEEK_V2_YARN_LOG_MUL = 0.0707
# Qwen/Qwen2.5-7B-Instruct config.json: 28 layers, hidden 3584, 28 heads
# over 4 KV heads (head_dim 128), intermediate 18944, vocab 152064, rope
# theta 1e6 (NEOX), rms eps 1e-6, max_position_embeddings 32768, untied
# output, q/k/v biases (arch qwen2)
QWEN2_5_7B = LlamaConfig(
    arch="qwen2", n_layers=28, n_embd=3584, n_heads=28, n_kv_heads=4, head_dim=128,
    n_ff=18944, n_vocab=152064, n_ctx_train=32768, rms_eps=1e-6,
    rope=RopeParams(n_dims=128, mode="neox", freq_base=1000000.0),
)
# Qwen/Qwen3-8B config.json: 36 layers, hidden 4096, 32 heads over 8 KV
# heads, head_dim 128, intermediate 12288, vocab 151936, rope theta 1e6
# (NEOX), rms eps 1e-6, max_position_embeddings 40960, untied output, q/k
# rms norms, no biases (arch qwen3)
QWEN3_8B = LlamaConfig(
    arch="qwen3", n_layers=36, n_embd=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    n_ff=12288, n_vocab=151936, n_ctx_train=40960, rms_eps=1e-6,
    rope=RopeParams(n_dims=128, mode="neox", freq_base=1000000.0), qk_norm=True,
)
# google/gemma-3-12b-it config.json, text part: 48 layers, hidden 3840, 16
# heads over 8 KV heads of head_dim 256 (query_pre_attn_scalar 256: scale
# 1/16), intermediate 15360 (GeGLU, tanh GELU), rms eps 1e-6, rope theta 1e6
# with linear scaling x8 on the full-attention layers and local base 1e4 on
# the sliding-window ones (window 1024, every 6th layer full), q/k norm,
# tied embeddings scaled by √3840, max_position_embeddings 131072; vocab the
# GGUF's 262144 SPM tokens (the HF config's 262208 pads the embedding)
GEMMA3_12B = LlamaConfig(
    arch="gemma3", n_layers=48, n_embd=3840, n_heads=16, n_kv_heads=8, head_dim=256,
    n_ff=15360, n_vocab=262144, n_ctx_train=131072, rms_eps=1e-6,
    rope=RopeParams(n_dims=256, mode="neox", freq_base=1000000.0, freq_scale=1 / 8),
    qk_norm=True, act="gelu", tie_embeddings=True, embd_scale=math.sqrt(3840),
    post_norms=True, swa_window=1024, swa_pattern=6, rope_local_base=10000.0,
)
# google/gemma-2-9b-it config.json: 42 layers, hidden 3584, 16 heads over 8
# KV heads of head_dim 256 (query_pre_attn_scalar 256), intermediate 14336,
# vocab 256000, rms eps 1e-6, rope theta 1e4, sliding window 4096 on every
# other layer, attention / final logit softcaps 50 / 30, tied embeddings
# scaled by √3584, max_position_embeddings 8192
GEMMA2_9B = LlamaConfig(
    arch="gemma2", n_layers=42, n_embd=3584, n_heads=16, n_kv_heads=8, head_dim=256,
    n_ff=14336, n_vocab=256000, n_ctx_train=8192, rms_eps=1e-6,
    rope=RopeParams(n_dims=256, mode="neox", freq_base=10000.0),
    act="gelu", tie_embeddings=True, embd_scale=math.sqrt(3584), post_norms=True,
    attn_logit_softcap=50.0, final_logit_softcap=30.0, swa_window=4096, swa_pattern=2,
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
    "mixtral-8x7b": MIXTRAL_8X7B,
    "deepseek-v2-lite": DEEPSEEK_V2_LITE,
    "qwen2.5-7b": QWEN2_5_7B,
    "qwen3-8b": QWEN3_8B,
    "gemma3-12b": GEMMA3_12B,
    "gemma2-9b": GEMMA2_9B,
}


def unit_config(arch: str) -> LlamaConfig:
    """A unit-size model of `arch` (2 layers, width 256, two query heads over
    one KV head, vocab 2048) with the flags its GGUF carries: the Qwen
    family's rope (head_dim 128), q/k norm (qwen3, qwen3moe) and MoE (16
    experts top-4, so that no Mixtral-only row of `tensor_type` applies;
    qwen2moe with a sigmoid-gated shared expert and no renormalisation);
    the Gemma family at head_dim 256, so that the q width (512) differs from
    n_embd as in the 12B, a 16-row window (a 34-token prompt crosses it) and,
    for gemma3, 6 layers so that one is a full-attention layer; gemma2's
    softcaps are cut to `UNIT_GEMMA2_SOFTCAPS` with the width (a unit model's
    scores and logits never reach 50 or 30). Its expert widths are
    `UNIT_EXPERTS`."""
    if arch in ("gemma", "gemma2", "gemma3"):
        g3 = arch == "gemma3"
        cfg = LlamaConfig(arch=arch, n_layers=6 if g3 else 2, n_embd=256, n_heads=2,
                          n_kv_heads=1, head_dim=256, n_ff=512, n_vocab=2048, n_ctx_train=256,
                          rms_eps=1e-6,
                          rope=RopeParams(n_dims=256, mode="neox",
                                          freq_base=1000000.0 if g3 else 10000.0,
                                          freq_scale=1 / 8 if g3 else 1.0),
                          qk_norm=g3, act="gelu", tie_embeddings=True, embd_scale=16.0)
        if arch == "gemma":
            return cfg
        cfg = dataclasses.replace(cfg, post_norms=True, swa_window=16)
        if g3:
            return dataclasses.replace(cfg, swa_pattern=6, rope_local_base=10000.0)
        attn_cap, final_cap = UNIT_GEMMA2_SOFTCAPS
        return dataclasses.replace(cfg, swa_pattern=2, attn_logit_softcap=attn_cap,
                                   final_logit_softcap=final_cap)
    cfg = LlamaConfig(arch=arch, n_layers=2, n_embd=256, n_heads=2, n_kv_heads=1,
                      head_dim=128, n_ff=512, n_vocab=2048, n_ctx_train=256, rms_eps=1e-6,
                      rope=RopeParams(n_dims=128, mode="norm" if arch == "mistral" else "neox",
                                      freq_base=1000000.0),
                      qk_norm=arch in ("qwen3", "qwen3moe"))
    if arch == "qwen2moe":
        return dataclasses.replace(cfg, n_expert=16, n_expert_used=4, moe_norm_weights=False,
                                   moe_shared_expert=True, moe_gate_shexp=True)
    if arch == "qwen3moe":
        return dataclasses.replace(cfg, n_expert=16, n_expert_used=4)
    return cfg


# the unit gemma2's (attention, final logit) softcaps: at width 256 its
# scores and logits reach a few units, where these caps bend them
UNIT_GEMMA2_SOFTCAPS = (3.0, 10.0)
UNIT_EXPERTS = (256, 2)  # routed expert width, shared experts (qwen2moe's)


# A block's d is uniform in [0, D_MAX): for Q4_0 the dequantized weights
# then have an rms of about 0.054, and the Q8_0 and K-quant maxima give the
# same rms over int8 values (Q8_0: rms 74, against Q4_0's 4.6) and random
# 6-bit scales or random int8 scales (Q6_K). A Q8_0 at Q4_0's maximum had
# 16× the rms, and a model mixing it with other kinds (Mixtral's Q8_0
# attn_k / attn_v) was far off a real one's scales.
_D_MAX = {GGMLType.Q4_0: 0.02, GGMLType.Q4_1: 0.02, GGMLType.Q5_0: 0.01,
          GGMLType.Q5_1: 0.01, GGMLType.Q8_0: 1.25e-3, GGMLType.Q4_K: 5.5e-4,
          GGMLType.Q5_K: 2.8e-4, GGMLType.Q6_K: 7e-5, GGMLType.Q2_K: 9.5e-3,
          GGMLType.Q3_K: 2.5e-3,
          # the IQ / TQ kinds over random bits (their sub-scales and grid
          # entries included): rms ≈ 0.054 as well
          GGMLType.IQ4_NL: 1.4e-3, GGMLType.IQ4_XS: 7.5e-5, GGMLType.IQ2_XXS: 1.75e-3,
          GGMLType.IQ2_XS: 1.67e-3, GGMLType.IQ2_S: 1.66e-3, GGMLType.IQ3_XXS: 6.6e-4,
          GGMLType.IQ3_S: 6.7e-4, GGMLType.IQ1_S: 1.3e-2, GGMLType.IQ1_M: 1.3e-2,
          GGMLType.TQ1_0: 0.115, GGMLType.TQ2_0: 0.115}
# K-quant mins: each group's 6-bit min equals its scale and dmin = d·mean(q),
# so every 32-element group d·sc·q − dmin·mn is zero-mean, as Q4_0's q − 8
# is. Random mins would give each group a common offset; the offsets of two
# matrices line up along K, and 32 layers of them make the activations and
# attention scores far larger than a real model's.
_DMIN_PER_D = {GGMLType.Q4_K: 7.5, GGMLType.Q5_K: 15.5, GGMLType.Q2_K: 1.5}
# Q4_1 / Q5_1 blocks alike: m = -d·mean(q), so d·q + m is zero-mean
_M_PER_D = {GGMLType.Q4_1: -7.5, GGMLType.Q5_1: -15.5}


def synth_raw(rng: np.random.Generator, kind: GGMLType, shape: tuple[int, ...]) -> np.ndarray:
    """Random GGUF blocks (uint8) for a [N, K] tensor (or [E, N, K]): random
    bits with the f16 block scales set small and finite (`_D_MAX`,
    `_DMIN_PER_D`). Random bits are valid blocks of every kind (each grid
    index is in range, each decoded value in the kind's table); where they
    would give every group of a kind a common offset, the bits are drawn so
    that groups are zero-mean: IQ4_NL's d takes a random sign (its codebook's
    mean is −5.9), TQ2_0's codes come from {0, 1, 2} as the encoder writes
    them (code 3 decodes to +2). An F16 tensor (the IQ kinds' block-size
    fallback) is Gaussian with the same rms."""
    if kind == GGMLType.F16:
        return (rng.standard_normal(math.prod(shape), dtype=np.float32)
                * np.float32(0.054)).astype(np.float16).view(np.uint8)
    n_blocks = math.prod(shape) // GGML_TYPE_TRAITS[kind].block_size
    raw = rng.integers(0, 256, size=n_blocks * DT[kind].itemsize, dtype=np.uint8)
    blocks = raw.view(DT[kind])
    d = rng.random(n_blocks, dtype=np.float32) * np.float32(_D_MAX[kind])
    if kind == GGMLType.IQ4_NL:
        d = np.where(rng.random(n_blocks) < 0.5, -d, d)
    if kind == GGMLType.IQ1_M:  # the f16 d in the top nibbles of the four scale words
        bits = d.astype(np.float16).view(np.uint16)
        sc = blocks["scales"].view("<u2").reshape(n_blocks, 4)
        for i in range(4):
            sc[:, i] = (sc[:, i] & 0x0FFF) | (((bits >> (4 * i)) & 0xF) << 12)
        return raw
    blocks["d"] = d.astype(np.float16)
    if kind == GGMLType.TQ2_0:
        u = rng.integers(0, 3, size=(n_blocks, 64, 4), dtype=np.uint8)
        blocks["qs"] = (u << (2 * np.arange(4, dtype=np.uint8))).sum(axis=-1, dtype=np.uint8)
    if kind in _M_PER_D:
        blocks["m"] = (d * np.float32(_M_PER_D[kind])).astype(np.float16)
    if kind in _DMIN_PER_D:
        blocks["dmin"] = (d * np.float32(_DMIN_PER_D[kind])).astype(np.float16)
    if kind == GGMLType.Q2_K:  # each group's 4-bit min (high nibble) = its scale
        blocks["scales"] = (blocks["scales"] & 0x0F) * 0x11
    elif kind == GGMLType.Q3_K:
        # no min: the codes q - 4 + 4h are drawn from -3..3 (never -4), so
        # every group is zero-mean; the 6-bit scales stay random (signed)
        u = rng.integers(1, 8, size=(n_blocks, 2, 4, 32), dtype=np.uint8)  # [half, j, l]
        j = np.arange(4, dtype=np.uint8)[:, None]
        blocks["qs"] = ((u & 3) << (2 * j)).sum(axis=2, dtype=np.uint8).reshape(n_blocks, 64)
        bit = (4 * np.arange(2, dtype=np.uint8)[:, None, None] + j)  # bit 4·half + j
        blocks["hmask"] = ((u >> 2) << bit).reshape(n_blocks, 8, 32).sum(axis=1, dtype=np.uint8)
    elif kind in _DMIN_PER_D:
        # get_scale_min_k4 packing: bytes 4-7 hold the mins of groups 0-3
        # (and the top bits of 4-7), bytes 8-11 the low bits of groups 4-7
        # (scale in the low nibble, min in the high one)
        sc = blocks["scales"]
        sc[:, 4:8] = sc[:, 0:4]
        sc[:, 8:12] = (sc[:, 8:12] & 0x0F) * 0x11
    return raw


def synth_qtensor(rng: np.random.Generator, kind: GGMLType, shape: tuple[int, ...],
                  device=None) -> QTensor:
    """Random packed blocks with small finite scales (half-sane dequant); a
    3-D shape [E, N, K] gives an expert stack. `device`: where a table
    kind's carrier is computed (`repack`)."""
    return repack(synth_raw(rng, kind, shape), kind, shape, device)


_SPM_SPECIALS = (("<unk>", 2), ("<s>", 3), ("</s>", 3))  # (text, UNKNOWN / CONTROL)
# Gemma's SPM control tokens (ids 0-3 as in its GGUFs; the two turn markers
# follow here, where the real vocab has them at 106 and 107)
_GEMMA_SPECIALS = (("<pad>", 3), ("<eos>", 3), ("<bos>", 3), ("<unk>", 2),
                   ("<start_of_turn>", 3), ("<end_of_turn>", 3))


def _spm_vocab(n_vocab: int, specials=_SPM_SPECIALS) -> tuple[list[str], list[float], list[int]]:
    """An SPM vocab of n_vocab pieces: the special tokens, the 256 byte
    tokens, the printable ASCII characters, then filler words."""
    tokens = [t for t, _ in specials] + [f"<0x{i:02X}>" for i in range(256)]
    types = [k for _, k in specials] + [6] * 256  # BYTE ×256
    tokens += ["▁" if c == " " else c for c in map(chr, range(32, 127))]
    tokens += [f"▁w{i}" for i in range(n_vocab - len(tokens))]
    tokens = tokens[:n_vocab]
    types += [1] * (n_vocab - len(types))  # NORMAL
    n_fixed = len(specials) + 256
    scores = [0.0] * n_fixed + [-float(i) for i in range(n_vocab - n_fixed)]
    return tokens, scores, types[:n_vocab]


# llama-3's chat template (Meta-Llama-3-8B-Instruct tokenizer_config.json)
LLAMA3_CHAT_TEMPLATE = (
    "{% set loop_messages = messages %}{% for message in loop_messages %}"
    "{% set content = '<|start_header_id|>' + message['role'] + '<|end_header_id|>\n\n'"
    "+ message['content'] | trim + '<|eot_id|>' %}{% if loop.index0 == 0 %}"
    "{% set content = bos_token + content %}{% endif %}{{ content }}{% endfor %}"
    "{% if add_generation_prompt %}{{ '<|start_header_id|>assistant<|end_header_id|>\n\n' }}"
    "{% endif %}")
# Mixtral-8x7B-Instruct-v0.1's chat template (tokenizer_config.json). It has
# no system role: with a system message its jinja raises, and the JAX
# package then takes the builtin family its markers name ("llama2"), which
# is what the port renders without jinja.
MIXTRAL_CHAT_TEMPLATE = (
    "{{ bos_token }}{% for message in messages %}{% if (message['role'] == 'user') != "
    "(loop.index0 % 2 == 0) %}{{ raise_exception('Conversation roles must alternate "
    "user/assistant/user/assistant/...') }}{% endif %}{% if message['role'] == 'user' %}"
    "{{ '[INST] ' + message['content'] + ' [/INST]' }}{% elif message['role'] == "
    "'assistant' %}{{ message['content'] + eos_token}}{% else %}{{ raise_exception('Only "
    "user and assistant roles are supported!') }}{% endif %}{% endfor %}")
# DeepSeek-V2-Lite-Chat's chat template (tokenizer_config.json); the server
# renders it through the builtin "deepseek2" family its markers name
DEEPSEEK2_CHAT_TEMPLATE = (
    "{% if not add_generation_prompt is defined %}{% set add_generation_prompt = false %}"
    "{% endif %}{{ bos_token }}{% for message in messages %}{% if message['role'] == 'user' %}"
    "{{ 'User: ' + message['content'] + '\\n\\n' }}{% elif message['role'] == 'assistant' %}"
    "{{ 'Assistant: ' + message['content'] + eos_token }}{% elif message['role'] == 'system' %}"
    "{{ message['content'] + '\\n\\n' }}{% endif %}{% endfor %}{% if add_generation_prompt %}"
    "{{ 'Assistant:' }}{% endif %}")
# Qwen2.5-7B-Instruct's ChatML template (tokenizer_config.json, without the
# tool-calling branches): a default system turn when the chat has none; the
# server renders it through the builtin "chatml" family its markers name
QWEN2_CHAT_TEMPLATE = (
    "{%- if messages[0]['role'] == 'system' %}{{- '<|im_start|>system\\n' + "
    "messages[0]['content'] + '<|im_end|>\\n' }}{%- else %}{{- '<|im_start|>system\\nYou are "
    "Qwen, created by Alibaba Cloud. You are a helpful assistant.<|im_end|>\\n' }}{%- endif %}"
    "{%- for message in messages %}{%- if not (message.role == 'system' and loop.first) %}"
    "{{- '<|im_start|>' + message.role + '\\n' + message.content + '<|im_end|>' + '\\n' }}"
    "{%- endif %}{%- endfor %}{%- if add_generation_prompt %}{{- '<|im_start|>assistant\\n' }}"
    "{%- endif %}")
# gemma-3-12b-it's chat template (tokenizer_config.json): no system role of
# its own (a system message prefixes the first user turn), "model" for the
# assistant; the server renders it through the builtin "gemma" family its
# markers name
GEMMA_CHAT_TEMPLATE = (
    "{{ bos_token }}\n{%- if messages[0]['role'] == 'system' -%}\n"
    "    {%- if messages[0]['content'] is string -%}\n"
    "        {%- set first_user_prefix = messages[0]['content'] + '\\n\\n' -%}\n"
    "    {%- else -%}\n"
    "        {%- set first_user_prefix = messages[0]['content'][0]['text'] + '\\n\\n' -%}\n"
    "    {%- endif -%}\n    {%- set loop_messages = messages[1:] -%}\n{%- else -%}\n"
    "    {%- set first_user_prefix = \"\" -%}\n    {%- set loop_messages = messages -%}\n"
    "{%- endif -%}\n{%- for message in loop_messages -%}\n"
    "    {%- if (message['role'] == 'user') != (loop.index0 % 2 == 0) -%}\n"
    "        {{ raise_exception(\"Conversation roles must alternate "
    "user/assistant/user/assistant/...\") }}\n    {%- endif -%}\n"
    "    {%- if (message['role'] == 'assistant') -%}\n        {%- set role = \"model\" -%}\n"
    "    {%- else -%}\n        {%- set role = message['role'] -%}\n    {%- endif -%}\n"
    "    {{ '<start_of_turn>' + role + '\\n' + (first_user_prefix if loop.first else \"\") }}\n"
    "    {%- if message['content'] is string -%}\n        {{ message['content'] | trim }}\n"
    "    {%- elif message['content'] is iterable -%}\n"
    "        {%- for item in message['content'] -%}\n"
    "            {%- if item['type'] == 'image' -%}\n                {{ '<start_of_image>' }}\n"
    "            {%- elif item['type'] == 'text' -%}\n                {{ item['text'] | trim }}\n"
    "            {%- endif -%}\n        {%- endfor -%}\n    {%- else -%}\n"
    "        {{ raise_exception(\"Invalid content type\") }}\n    {%- endif -%}\n"
    "    {{ '<end_of_turn>\\n' }}\n{%- endfor -%}\n{%- if add_generation_prompt -%}\n"
    "    {{'<start_of_turn>model\\n'}}\n{%- endif -%}\n")
N_CONTROL = 256  # control tokens in the last ids (llama-3: 128000.. at full size)
# the byte-level BPE presets `bpe_vocab` writes: pre-tokenizer → (control
# tokens first in the control block, index of bos, eos and eot among them,
# add_bos_token, chat template)
_LLAMA3_CONTROL = ["<|begin_of_text|>", "<|end_of_text|>", "<|reserved_special_token_0|>",
                   "<|reserved_special_token_1|>", "<|finetune_right_pad_id|>",
                   "<|reserved_special_token_2|>", "<|start_header_id|>", "<|end_header_id|>",
                   "<|eom_id|>", "<|eot_id|>", "<|python_tag|>"]
_DEEPSEEK_CONTROL = ["<｜begin▁of▁sentence｜>", "<｜end▁of▁sentence｜>", "<｜fim▁hole｜>",
                     "<｜fim▁begin｜>", "<｜fim▁end｜>"]
# Qwen2 / Qwen3 GGUFs: bos <|endoftext|>, eos <|im_end|>, no BOS added
_QWEN2_CONTROL = ["<|endoftext|>", "<|im_start|>", "<|im_end|>"]
BPE_PRESETS = {
    "llama-bpe": (_LLAMA3_CONTROL, (0, 1, 9), None, LLAMA3_CHAT_TEMPLATE),
    "deepseek-llm": (_DEEPSEEK_CONTROL, (0, 1, None), True, DEEPSEEK2_CHAT_TEMPLATE),
    "qwen2": (_QWEN2_CONTROL, (0, 2, None), False, QWEN2_CHAT_TEMPLATE),
}


def bpe_vocab(n_vocab: int, pre: str = "llama-bpe") -> dict:
    """A byte-level BPE vocab of n_vocab tokens for pre-tokenizer `pre`
    (`BPE_PRESETS`): the 256 byte-alphabet tokens, one token per merge
    (Ġ+letter, letter pairs, Ġ+letter+lowercase, digit pairs; as many as
    fit), filler words, then N_CONTROL control tokens in the last ids (the
    preset's named ones first, then reserved fillers). Returns the tokenizer
    KVs, the preset's chat template among them."""
    from ..tokenizer.vocab import byte_to_unicode_map

    named, (bos, eos, eot), add_bos, template = BPE_PRESETS[pre]
    alpha = [byte_to_unicode_map()[b] for b in range(256)]
    lower = [chr(c) for c in range(ord("a"), ord("z") + 1)]
    letters = lower + [c.upper() for c in lower]
    digits = [str(i) for i in range(10)]
    pairs = ([("Ġ", c) for c in letters] + [(a, b) for a in lower for b in lower]
             + [("Ġ" + a, b) for a in letters for b in lower]
             + [(a, b) for a in digits for b in digits])
    n_merges = min(len(pairs), n_vocab - 256 - N_CONTROL)
    if n_merges < 0:
        raise ValueError(f"a byte-level BPE vocab needs at least {256 + N_CONTROL} tokens")
    merges = [f"{a} {b}" for a, b in pairs[:n_merges]]
    tokens = alpha + [a + b for a, b in pairs[:n_merges]]
    tokens += [f"Ġw{i}" for i in range(n_vocab - N_CONTROL - len(tokens))]
    control = named + [f"<|reserved_special_token_{i}|>"
                       for i in range(3, 3 + N_CONTROL - len(named))]
    first = len(tokens)
    tokens += control
    kv = {
        "tokenizer.ggml.model": "gpt2",
        "tokenizer.ggml.pre": pre,
        "tokenizer.ggml.tokens": tokens,
        "tokenizer.ggml.token_type": [1] * first + [3] * N_CONTROL,  # NORMAL, CONTROL
        "tokenizer.ggml.merges": merges,
        "tokenizer.ggml.bos_token_id": first + bos,
        "tokenizer.ggml.eos_token_id": first + eos,
        "tokenizer.chat_template": template,
    }
    if eot is not None:
        kv["tokenizer.ggml.eot_token_id"] = first + eot
    if add_bos is not None:
        kv["tokenizer.ggml.add_bos_token"] = add_bos
    return kv


def use_more_bits(i_layer: int, n_layers: int) -> bool:
    """llama-quant.cpp:227 (the JAX package's tools/quantize.py:91)."""
    return (i_layer < n_layers // 8 or i_layer >= 7 * n_layers // 8
            or (i_layer - n_layers // 8) % 3 == 2)


FTYPES = ("Q4_0", "Q4_1", "Q8_0", "Q2_K", "Q3_K_M", "Q4_K_M", "Q5_K_M",
          "IQ4_NL", "IQ4_XS", "IQ2_XXS", "IQ2_XS", "IQ2_S", "IQ2_M", "IQ3_XXS", "IQ3_XS",
          "IQ3_S", "IQ3_M", "IQ1_S", "IQ1_M", "TQ1_0", "TQ2_0")
# an ftype's default kind (the JAX package's tools/quantize.py FTYPE_DEFAULT_TYPE)
_DEFAULT_KIND = {"Q2_K": GGMLType.Q2_K, "Q3_K_M": GGMLType.Q3_K, "Q4_K_M": GGMLType.Q4_K,
                 "Q5_K_M": GGMLType.Q5_K, "IQ2_M": GGMLType.IQ2_S, "IQ3_XS": GGMLType.IQ3_S,
                 "IQ3_M": GGMLType.IQ3_S,
                 **{f: GGMLType[f] for f in ("IQ4_NL", "IQ4_XS", "IQ2_XXS", "IQ2_XS", "IQ2_S",
                                             "IQ3_XXS", "IQ3_S", "IQ1_S", "IQ1_M", "TQ1_0",
                                             "TQ2_0")}}
# the low-bit IQ ftypes and the 3-bit ones (quantize.py:131-134)
_IQ_LOW = ("IQ1_S", "IQ1_M", "IQ2_XXS", "IQ2_XS", "IQ2_S", "IQ2_M")
_IQ3 = ("IQ3_XXS", "IQ3_XS", "IQ3_S", "IQ3_M")
_KQUANT = ("Q2_K", "Q3_K_M", "Q4_K_M", "Q5_K_M")
# llama.cpp's kind for a row length K that is not a multiple of the chosen
# kind's block (the JAX package's tools/quantize.py:81-89, :220-227); a kind
# without a row here (the IQ / TQ kinds) falls back to F16
_FALLBACK = {GGMLType.Q2_K: GGMLType.Q4_0, GGMLType.Q3_K: GGMLType.Q4_1,
             GGMLType.Q4_K: GGMLType.Q5_0, GGMLType.Q5_K: GGMLType.Q5_1,
             GGMLType.Q6_K: GGMLType.Q8_0}


def tensor_type(ftype: str, name: str, n_layers: int, n_expert: int = 0,
                k: int = 0, n_gqa: int = 1, tied: bool = False) -> GGMLType:
    """The kind of tensor `name` (row length k) in a file of `ftype`. Q4_0 /
    Q4_1 / Q8_0: every matrix that kind. The K-quant and IQ / TQ mixes:
    llama_tensor_get_type's rows (the JAX package's tools/quantize.py:
    121-228), with attn_v and ffn_down counted by layer index (one of each a
    layer). The LM head (with `tied`, a file without output.weight,
    token_embd is the LM head and takes its kind, quantize.py:136): Q8_0
    where the default kind's block does not divide k, Q5_K for the low-bit
    IQ ftypes (IQ1_S, IQ1_M, IQ2_XXS, IQ2_XS, IQ2_S, IQ2_M), else Q6_K. The
    low-bit IQ ftypes: token_embd Q2_K, attn_v Q4_K, attn_k IQ3_S; the IQ3
    ftypes: attn_v Q4_K at n_gqa ≥ 4, else IQ3_S. The K-quant mixes: attn_v
    Q4_K (Q2_K at n_gqa ≥ 4, else Q3_K), Q5_K in layers 0-1 then Q4_K
    (Q3_K_M), or Q6_K in the use_more_bits layers (Q4_K_M, Q5_K_M); every
    ffn_down (a dense one, an expert stack's, a shared expert's) Q3_K (Q2_K),
    Q5_K in the first n_layers/16 layers then Q4_K (Q3_K_M), or Q6_K where
    use_more_bits (Q4_K_M, Q5_K_M); attn_output Q3_K (Q2_K) or Q4_K
    (Q3_K_M); a fused attn_qkv Q4_K (Q3_K_M), Q5_K (Q4_K_M) or Q6_K
    (Q5_K_M); with 8 experts (Mixtral) attn_k and attn_v Q8_0 (every mix but
    the low-bit IQ ones, and the IQ3 ones' attn_v) and attn_output Q5_K (the
    K-quant mixes); the rest the ftype's kind. Then the block-size
    fallback: a kind whose block does not divide k becomes Q4_0 (from Q2_K),
    Q4_1 (Q3_K), Q5_0 (Q4_K), Q5_1 (Q5_K), Q8_0 (Q6_K) or F16 (the IQ / TQ
    kinds), as DeepSeek-V2-Lite's K = 1408 expert rows and K = 10944 dense
    ffn_down do."""
    if ftype in ("Q4_0", "Q4_1", "Q8_0"):
        return GGMLType[ftype]
    if ftype not in FTYPES:
        raise ValueError(f"ftype {ftype!r}: one of {FTYPES}")
    kind = _DEFAULT_KIND[ftype]
    layer = int(name.split(".")[1]) if name.startswith("blk.") else 0
    iq_low, iq3 = ftype in _IQ_LOW, ftype in _IQ3
    if name == "output.weight" or (tied and name == "token_embd.weight"):
        if k % GGML_TYPE_TRAITS[kind].block_size:
            kind = GGMLType.Q8_0
        else:
            kind = GGMLType.Q5_K if iq_low else GGMLType.Q6_K
    elif iq_low and name == "token_embd.weight":
        kind = GGMLType.Q2_K
    elif iq_low and ("attn_v.weight" in name or "attn_k.weight" in name):
        kind = GGMLType.Q4_K if "attn_v.weight" in name else GGMLType.IQ3_S
    elif iq3 and "attn_v.weight" in name:
        kind = GGMLType.Q4_K if n_gqa >= 4 else GGMLType.IQ3_S
    elif name == "token_embd.weight":
        pass
    elif "attn_v.weight" in name:
        if ftype == "Q2_K":
            kind = GGMLType.Q4_K if n_gqa >= 4 else GGMLType.Q3_K
        elif ftype == "Q3_K_M":
            kind = GGMLType.Q5_K if layer < 2 else GGMLType.Q4_K
        elif ftype in ("Q4_K_M", "Q5_K_M") and use_more_bits(layer, n_layers):
            kind = GGMLType.Q6_K
        if n_expert == 8:
            kind = GGMLType.Q8_0
    elif "attn_k.weight" in name:
        if n_expert == 8:
            kind = GGMLType.Q8_0
    elif "ffn_down" in name:
        if ftype == "Q2_K":
            kind = GGMLType.Q3_K
        elif ftype == "Q3_K_M":
            kind = GGMLType.Q5_K if layer < n_layers // 16 else GGMLType.Q4_K
        elif ftype in ("Q4_K_M", "Q5_K_M") and use_more_bits(layer, n_layers):
            kind = GGMLType.Q6_K
    elif "attn_output.weight" in name:
        if n_expert == 8:
            if ftype in _KQUANT:
                kind = GGMLType.Q5_K
        elif ftype == "Q2_K":
            kind = GGMLType.Q3_K
        elif ftype == "Q3_K_M":
            kind = GGMLType.Q4_K
    elif "attn_qkv.weight" in name:
        kind = {"Q3_K_M": GGMLType.Q4_K, "Q4_K_M": GGMLType.Q5_K,
                "Q5_K_M": GGMLType.Q6_K}.get(ftype, kind)
    if k % GGML_TYPE_TRAITS[kind].block_size:
        kind = _FALLBACK.get(kind, GGMLType.F16)
    return kind


def write_synth_gguf(path: str, cfg: LlamaConfig, ftype: str, *, seed: int = 0,
                     vocab: str = "spm", chat_template: str | None = None,
                     experts: tuple[int, int] | None = None) -> None:
    """Write `cfg` as a GGUF of random blocks whose kinds follow `ftype`
    (`tensor_type`: for Q4_0 / Q4_1 / Q8_0 every matrix, the embedding and
    the LM head included), f32 norm weights of ones and a synthetic vocab:
    "spm", or a byte-level BPE one ("llama-bpe", "deepseek-llm", "qwen2":
    `bpe_vocab`, with the preset's chat template). A `chat_template` given
    is written as the GGUF's template. A deepseek2 config is written with
    its MLA, shared-expert, leading-dense and YaRN keys, as llama.cpp's
    converter writes them. The Qwen family adds f32 q/k/v biases (qwen2,
    qwen2moe) or per-head q/k norm weights near 1 (cfg.qk_norm); qwen2moe's
    shared expert has its f32 gate `ffn_gate_inp_shexp` [1, C]; an arch
    whose registry row has fused_qkv / fused_gate_up (phi3) gets one
    attn_qkv [(H + 2·Hkv)·D, C] and one gate|up ffn_up [2·n_ff, C] a layer.
    `experts` = (routed expert width, shared experts): by default
    DEEPSEEK_V2_LITE_EXPERTS for deepseek2, else (n_ff, 0). A head_dim
    other than n_embd / n_heads is written as attention.key_length /
    value_length; linear rope scaling as rope.scaling.type / factor. The
    Gemma family (vocab "gemma": Gemma's SPM specials and chat template)
    adds the sliding window and gemma2's softcaps as llama.cpp's converter
    writes them, post_attention_norm / post_ffw_norm with post_norms, and
    no output.weight with tie_embeddings (token_embd then takes the LM
    head's kind)."""
    rng = np.random.default_rng(seed)
    arch = cfg.arch
    mla = cfg.kv_lora_rank > 0
    spec = arch_spec(arch)
    biased = arch in ("qwen2", "qwen2moe")  # llm_build_qwen2 / _qwen2moe: q/k/v biases
    if experts is None:
        experts = DEEPSEEK_V2_LITE_EXPERTS if arch == "deepseek2" else (cfg.n_ff, 0)
    ff_exp, n_shared = experts
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
    if not mla and cfg.head_dim != cfg.n_embd // cfg.n_heads:
        w.add_uint32(f"{arch}.attention.key_length", cfg.head_dim)
        w.add_uint32(f"{arch}.attention.value_length", cfg.head_dim)
    if cfg.swa_window:
        w.add_uint32(f"{arch}.attention.sliding_window", cfg.swa_window)
    if cfg.attn_logit_softcap:
        w.add_float32(f"{arch}.attn_logit_softcapping", cfg.attn_logit_softcap)
    if cfg.final_logit_softcap:
        w.add_float32(f"{arch}.final_logit_softcapping", cfg.final_logit_softcap)
    if cfg.n_expert:
        w.add_uint32(f"{arch}.expert_count", cfg.n_expert)
        w.add_uint32(f"{arch}.expert_used_count", cfg.n_expert_used)
    if cfg.n_expert and arch in ("qwen2moe", "qwen3moe"):
        w.add_uint32(f"{arch}.expert_feed_forward_length", ff_exp)
        if n_shared:
            w.add_uint32(f"{arch}.expert_shared_feed_forward_length", n_shared * ff_exp)
        if arch == "qwen3moe":
            w.add_bool(f"{arch}.expert_weights_norm", cfg.moe_norm_weights)
    if mla:
        w.add_uint32(f"{arch}.leading_dense_block_count", cfg.n_dense_layers)
        w.add_uint32(f"{arch}.attention.kv_lora_rank", cfg.kv_lora_rank)
        if cfg.q_lora_rank:
            w.add_uint32(f"{arch}.attention.q_lora_rank", cfg.q_lora_rank)
        w.add_uint32(f"{arch}.attention.key_length", cfg.qk_nope_dim + cfg.qk_rope_dim)
        w.add_uint32(f"{arch}.attention.value_length", cfg.v_head_dim)
        w.add_uint32(f"{arch}.expert_feed_forward_length", ff_exp)
        w.add_uint32(f"{arch}.expert_shared_count", n_shared)
        w.add_float32(f"{arch}.expert_weights_scale", cfg.moe_scale)
        w.add_bool(f"{arch}.expert_weights_norm", cfg.moe_norm_weights)
        w.add_uint32(f"{arch}.expert_gating_func", 2 if cfg.expert_gating == "sigmoid" else 1)
    if cfg.rope.ext_factor:  # YaRN: the keys of a converted DeepSeek-V2
        w.add_string(f"{arch}.rope.scaling.type", "yarn")
        w.add_float32(f"{arch}.rope.scaling.factor", 1.0 / cfg.rope.freq_scale)
        w.add_uint32(f"{arch}.rope.scaling.original_context_length", cfg.rope.n_ctx_orig)
        w.add_float32(f"{arch}.rope.scaling.yarn_log_multiplier", DEEPSEEK_V2_YARN_LOG_MUL)
    elif cfg.rope.freq_scale != 1.0:  # linear (gemma3's full-attention layers)
        w.add_string(f"{arch}.rope.scaling.type", "linear")
        w.add_float32(f"{arch}.rope.scaling.factor", 1.0 / cfg.rope.freq_scale)
    if vocab in BPE_PRESETS:
        for key, val in bpe_vocab(cfg.n_vocab, vocab).items():
            w.add_kv(key, val)
    elif vocab in ("spm", "gemma"):
        gemma = vocab == "gemma"
        tokens, scores, types = _spm_vocab(cfg.n_vocab, _GEMMA_SPECIALS if gemma
                                           else _SPM_SPECIALS)
        w.add_kv("tokenizer.ggml.model", "llama")
        w.add_kv("tokenizer.ggml.tokens", tokens)
        w.add_kv("tokenizer.ggml.scores", scores)
        w.add_kv("tokenizer.ggml.token_type", types)
        if gemma:  # as llama.cpp's converter writes a Gemma tokenizer
            for key, val in (("bos_token_id", 2), ("eos_token_id", 1),
                             ("unknown_token_id", 3), ("padding_token_id", 0),
                             ("add_bos_token", True), ("add_eos_token", False),
                             ("add_space_prefix", False)):
                w.add_kv(f"tokenizer.ggml.{key}", val)
            w.add_kv("tokenizer.chat_template", GEMMA_CHAT_TEMPLATE)
    else:
        raise ValueError(f"vocab {vocab!r}: 'spm', 'gemma' or one of {sorted(BPE_PRESETS)}")
    if chat_template is not None:
        w.add_kv("tokenizer.chat_template", chat_template)

    def add_q(name: str, n: int, k: int, e: int = 0) -> None:
        """A packed [N, K] tensor, or an expert stack [E, N, K] for e > 0."""
        kind = tensor_type(ftype, name, cfg.n_layers, cfg.n_expert, k,
                           cfg.n_heads // cfg.n_kv_heads, cfg.tie_embeddings)
        if k % GGML_TYPE_TRAITS[kind].block_size:
            raise ValueError(f"{name}: K={k} is not a multiple of {kind.name}'s block")
        w.add_tensor(name, lambda: synth_raw(rng, kind, (max(e, 1), n, k)), ggml_type=kind,
                     ne_shape=(k, n, e) if e else (k, n))

    def add_ffn(p: str, suffix: str, ff: int, e: int = 0) -> None:
        if spec.fused_gate_up and not suffix:  # phi3: gate rows, then up rows
            add_q(f"{p}ffn_up.weight", 2 * ff, c)
        else:
            add_q(f"{p}ffn_gate{suffix}.weight", ff, c, e)
            add_q(f"{p}ffn_up{suffix}.weight", ff, c, e)
        add_q(f"{p}ffn_down{suffix}.weight", c, ff, e)

    def add_f32(name: str, shape: tuple[int, ...], mean: float, std: float) -> None:
        w.add_tensor(name, lambda: (mean + rng.standard_normal(shape) * std).astype(np.float32),
                     ggml_type=GGMLType.F32, ne_shape=tuple(reversed(shape)))

    c, hd = cfg.n_embd, cfg.head_dim
    ones = np.ones(c, np.float32)
    add_q("token_embd.weight", cfg.n_vocab, c)
    for i in range(cfg.n_layers):
        p = f"blk.{i}."
        w.add_tensor(p + "attn_norm.weight", ones)
        if mla:  # DeepSeek-V2: the latent-attention tensors (no q LoRA)
            h, r = cfg.n_heads, cfg.kv_lora_rank
            add_q(p + "attn_q.weight", h * (cfg.qk_nope_dim + cfg.qk_rope_dim), c)
            add_q(p + "attn_kv_a_mqa.weight", r + cfg.qk_rope_dim, c)
            w.add_tensor(p + "attn_kv_a_norm.weight", np.ones(r, np.float32))
            add_q(p + "attn_kv_b.weight", h * (cfg.qk_nope_dim + cfg.v_head_dim), r)
            add_q(p + "attn_output.weight", c, h * cfg.v_head_dim)
        else:
            qdim, kvdim = cfg.n_heads * hd, cfg.n_kv_heads * hd
            if spec.fused_qkv:
                add_q(p + "attn_qkv.weight", qdim + 2 * kvdim, c)
            else:
                add_q(p + "attn_q.weight", qdim, c)
                add_q(p + "attn_k.weight", kvdim, c)
                add_q(p + "attn_v.weight", kvdim, c)
            if biased:
                for part, dim in (("q", qdim), ("k", kvdim), ("v", kvdim)):
                    add_f32(f"{p}attn_{part}.bias", (dim,), 0.0, 0.5)
            if cfg.qk_norm:  # per-head weights [D], told apart by their values
                add_f32(p + "attn_q_norm.weight", (hd,), 1.0, 0.1)
                add_f32(p + "attn_k_norm.weight", (hd,), 1.0, 0.1)
            add_q(p + "attn_output.weight", c, qdim)
        if cfg.post_norms:
            w.add_tensor(p + "post_attention_norm.weight", ones)
        w.add_tensor(p + "ffn_norm.weight", ones)
        if cfg.n_expert and i >= cfg.n_dense_layers:  # the router stays f32, as llama.cpp
            e = cfg.n_expert                          # leaves it
            # std 0.02 at Mixtral's width (as the JAX package's synth), scaled
            # so that router logits spread alike at every width
            std = np.float32(0.02 * math.sqrt(4096 / c))
            w.add_tensor(p + "ffn_gate_inp.weight",
                         lambda: (rng.standard_normal((e, c)) * std).astype(np.float32),
                         ggml_type=GGMLType.F32, ne_shape=(c, e))
            add_ffn(p, "_exps", ff_exp, e)
            if cfg.moe_shared_expert:
                add_ffn(p, "_shexp", n_shared * ff_exp)
            if cfg.moe_gate_shexp:  # qwen2moe: the shared expert's sigmoid gate
                add_f32(p + "ffn_gate_inp_shexp.weight", (1, c), 0.0, float(std))
            continue
        add_ffn(p, "", cfg.n_ff)
        if cfg.post_norms:
            w.add_tensor(p + "post_ffw_norm.weight", ones)
    w.add_tensor("output_norm.weight", ones)
    if not cfg.tie_embeddings:
        add_q("output.weight", cfg.n_vocab, c)
    w.write()
