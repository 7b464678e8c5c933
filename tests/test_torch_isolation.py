"""The PyTorch port stands alone: it imports nothing of JAX or of the JAX
package (nor the JAX server's aiohttp and jinja2, nor `regex` and
`ml_dtypes`, which the machine with the card lacks), its entry points refuse
to fall back to the CPU silently, and its kernel wrappers take the plain
versions only for CPU tensors."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from llama_cpp_dsp_tpu_torch.gguf.constants import GGMLType
from llama_cpp_dsp_tpu_torch.ops.kernels import LAUNCHES
from llama_cpp_dsp_tpu_torch.ops.kernels.attention import (flash_decode, flash_decode_plain,
                                                            flash_prefill, flash_prefill_plain,
                                                            mla_flash_decode,
                                                            mla_flash_decode_plain)
from llama_cpp_dsp_tpu_torch.ops.kernels.attn_fused import attn_decode_fused, attn_fused_plain
from llama_cpp_dsp_tpu_torch.ops.kernels.qmm import (qmm, qmm_expert_rows,
                                                     qmm_expert_rows_plain, qmm_plain)
from llama_cpp_dsp_tpu_torch.ops.rope import RopeParams, _rope_angles
from llama_cpp_dsp_tpu_torch.tools.synth import synth_qtensor
from torch_fixtures import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

ROOT = Path(__file__).resolve().parent.parent

_BLOCKER = """
import importlib.abc, sys
BLOCKED = ("jax", "jaxlib", "llama_cpp_dsp_tpu", "aiohttp", "jinja2", "regex", "ml_dtypes")
class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import of {name}")
        return None
for m in [m for m in sys.modules if m.split(".")[0] in BLOCKED]:
    del sys.modules[m]
sys.meta_path.insert(0, _Block())
"""


def _run(code: str, cwd: Path) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    return subprocess.run([sys.executable, "-c", _BLOCKER + textwrap.dedent(code)], cwd=cwd,
                          env=env, capture_output=True, text=True, timeout=300)


def test_port_imports_with_jax_blocked():
    res = _run("""
        import importlib, pkgutil
        import llama_cpp_dsp_tpu_torch as P
        names = [m.name for m in pkgutil.walk_packages(P.__path__, P.__name__ + ".")]
        for name in names:
            importlib.import_module(name)
        import chip_smoke
        # the BPE tokenizer (stdlib re) and the K-quant repack and dequant run
        import numpy as np
        from llama_cpp_dsp_tpu_torch.gguf.constants import GGMLType
        from llama_cpp_dsp_tpu_torch.quant.dequant import dequant
        from llama_cpp_dsp_tpu_torch.tokenizer import Tokenizer, Vocab
        from llama_cpp_dsp_tpu_torch.tools.synth import bpe_vocab, synth_qtensor
        tok = Tokenizer(Vocab.from_gguf_kv(bpe_vocab(1024)))
        ids = tok.encode("<|begin_of_text|>Hello, wörld 123!", parse_special=True)
        assert ids[:2] == [tok.vocab.bos_id] * 2 and tok.decode(ids) == "Hello, wörld 123!"
        rng = np.random.default_rng(0)
        for kind in (GGMLType.Q2_K, GGMLType.Q3_K, GGMLType.Q4_K, GGMLType.Q5_K,
                     GGMLType.Q6_K):
            assert dequant(synth_qtensor(rng, kind, (4, 512))).isfinite().all()
        # an expert stack, the selected-expert plain path and the MoE FFN
        import torch
        from llama_cpp_dsp_tpu_torch.models.llama import LlamaConfig, ffn_moe
        from llama_cpp_dsp_tpu_torch.ops.kernels.qmm import qmm_expert_rows
        stack = synth_qtensor(rng, GGMLType.Q4_K, (4, 64, 256))
        x = torch.ones(2, 256)
        assert qmm_expert_rows(x, stack, torch.tensor([3, 0], dtype=torch.int32)).shape == (2, 64)
        cfg = LlamaConfig(arch="llama", n_layers=1, n_embd=256, n_heads=2, n_kv_heads=2,
                          head_dim=128, n_ff=256, n_vocab=8, n_ctx_train=8, n_expert=4,
                          n_expert_used=2)
        layer = {"ffn_gate_inp": torch.ones(4, 256) * 0.01,
                 "ffn_gate_exps": synth_qtensor(rng, GGMLType.Q4_K, (4, 256, 256)),
                 "ffn_up_exps": synth_qtensor(rng, GGMLType.Q4_K, (4, 256, 256)),
                 "ffn_down_exps": synth_qtensor(rng, GGMLType.Q6_K, (4, 256, 256))}
        for t in (1, 5):  # the selected-expert branch, then dense-all
            assert ffn_moe(torch.ones(1, t, 256), layer, cfg).isfinite().all()
        # the legacy kinds, MLA decode's plain version and a deepseek2 layer
        import dataclasses
        from llama_cpp_dsp_tpu_torch.models.deepseek2 import split_kv_b
        from llama_cpp_dsp_tpu_torch.models.llama import decode_layer
        from llama_cpp_dsp_tpu_torch.ops.kernels.attention import mla_flash_decode
        from llama_cpp_dsp_tpu_torch.runtime.kv_cache import KVCache
        from llama_cpp_dsp_tpu_torch.tools.synth import DEEPSEEK_V2_LITE
        for kind in (GGMLType.Q4_1, GGMLType.Q5_0, GGMLType.Q5_1):
            assert dequant(synth_qtensor(rng, kind, (4, 352))).isfinite().all()
        out = mla_flash_decode(torch.ones(2, 4, 256), torch.ones(2, 1, 16, 256),
                               torch.tensor([3, 16]), scale=0.1, r=128)
        assert out.shape == (2, 4, 128)
        ds = dataclasses.replace(DEEPSEEK_V2_LITE, n_layers=1, n_embd=256, n_heads=4,
                                 kv_lora_rank=128, qk_nope_dim=64, qk_rope_dim=32,
                                 v_head_dim=64,
                                 rope=dataclasses.replace(DEEPSEEK_V2_LITE.rope, n_dims=32))
        ds_layer = {"attn_norm": torch.ones(256), "ffn_norm": torch.ones(256),
                    "attn_q": synth_qtensor(rng, GGMLType.Q5_0, (4 * 96, 256)),
                    "attn_kv_a_mqa": synth_qtensor(rng, GGMLType.Q4_1, (160, 256)),
                    "attn_kv_a_norm": torch.ones(128),
                    "attn_kv_b": synth_qtensor(rng, GGMLType.Q5_1, (4 * 128, 128)),
                    "attn_output": synth_qtensor(rng, GGMLType.Q8_0, (256, 256)),
                    "ffn_gate": synth_qtensor(rng, GGMLType.Q4_K, (256, 256)),
                    "ffn_up": synth_qtensor(rng, GGMLType.Q4_K, (256, 256)),
                    "ffn_down": synth_qtensor(rng, GGMLType.Q5_0, (256, 256))}
        split_kv_b({"layers": [ds_layer]}, ds)  # as the loader does
        cache = KVCache.create(1, 1, 8, ds.kv_cache_heads, ds.kv_cache_dim)
        for lo, hi in ((0, 3), (3, 4)):  # prefill, then decode through B10's wrapper
            pos = torch.arange(lo, hi, dtype=torch.int32)[None]
            y = decode_layer(torch.ones(1, hi - lo, 256), ds_layer, ds, pos, cache, 0, lo,
                             True, {})
            assert y.isfinite().all()
        # the KV cache types, B8's plain version and a bf16 state file
        # (written and read without ml_dtypes)
        import tempfile
        from llama_cpp_dsp_tpu_torch.ops.kernels.attention import flash_decode_q4
        from llama_cpp_dsp_tpu_torch.runtime import state_io
        from llama_cpp_dsp_tpu_torch.runtime.context import LlamaContext
        from llama_cpp_dsp_tpu_torch.runtime.kv_cache import KV_PLANE_FORMATS, make_kv_cache
        from llama_cpp_dsp_tpu_torch.runtime.paged_kv import PagedQ4KVCache
        for fmt in KV_PLANE_FORMATS:
            kv = make_kv_cache(1, 2, 8, 2, 128, fmt, v_type="q4_0")
            kv.write(0, torch.ones(2, 3, 2, 128), torch.ones(2, 3, 2, 128), 1)
            assert kv.layer(0)[0].float().isfinite().all()
        q4 = make_kv_cache(1, 2, 8, 2, 128, "q4_0")
        assert flash_decode_q4(torch.ones(2, 4, 128), *q4.packed_layer(0),
                               torch.tensor([3, 8]), scale=0.1).shape == (2, 4, 128)
        PagedQ4KVCache.create(1, 4, 2, 2, 2, 128, page_size=16)
        from llama_cpp_dsp_tpu_torch.ops.rope import RopeParams
        from llama_cpp_dsp_tpu_torch.runtime.loader import load_model
        from llama_cpp_dsp_tpu_torch.tools.synth import write_synth_gguf
        path = tempfile.mkdtemp() + "/m.gguf"
        write_synth_gguf(path, LlamaConfig(arch="llama", n_layers=1, n_embd=64, n_heads=2,
                                           n_kv_heads=2, head_dim=32, n_ff=128, n_vocab=300,
                                           n_ctx_train=64, rope=RopeParams(n_dims=32)), "Q8_0")
        tiny = load_model(path)
        ctx = LlamaContext(tiny, n_ctx=16, device="cpu")
        ctx.eval_tokens([1, 2, 3])
        path += ".npz"
        state_io.save_state(ctx, path, [1, 2, 3])
        other = LlamaContext(tiny, n_ctx=16, device="cpu")
        assert state_io.load_state(other, path) == [1, 2, 3]
        assert torch.equal(other.cache.k[0][:, :, :3], ctx.cache.k[0][:, :, :3])
        # the Qwen family: a qwen2moe Q2_K file (biases, a gated shared
        # expert, NEOX rope) through the loader and a prompt + decode step
        from llama_cpp_dsp_tpu_torch.tools.synth import UNIT_EXPERTS, unit_config
        write_synth_gguf(path, unit_config("qwen2moe"), "Q2_K", vocab="qwen2",
                         experts=UNIT_EXPERTS)
        qctx = LlamaContext(load_model(path), n_ctx=16, device="cpu")
        qctx.eval_tokens([1, 2, 3])
        assert np.isfinite(qctx.eval_tokens([4])).all()
        # the Gemma family: a unit gemma3 file (head_dim 256, a sliding
        # window, post norms, a tied embedding, the Gemma vocab) through a
        # prompt past the window and a decode step, and B4's plain version
        from llama_cpp_dsp_tpu_torch.ops.kernels.attention import flash_prefill
        write_synth_gguf(path, unit_config("gemma3"), "Q4_0", vocab="gemma")
        gctx = LlamaContext(load_model(path), n_ctx=40, device="cpu")
        gctx.eval_tokens(list(range(2, 22)))
        assert np.isfinite(gctx.eval_tokens([4])).all()
        out = flash_prefill(torch.ones(1, 3, 4, 256), torch.ones(1, 2, 8, 256),
                            torch.ones(1, 2, 8, 256), torch.tensor([2]), scale=0.1,
                            swa_window=2)
        assert out.shape == (1, 3, 4, 256)
        assert not [m for m in sys.modules if m.split(".")[0] in BLOCKED]
        print("imported", len(names))
    """, ROOT)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 34


def test_iq_kinds_run_with_jax_blocked():
    """The IQ / TQ kinds with JAX blocked: the port's own grids file and
    carrier (`quant/iq_grids.py`, `quant/iq.py`) repack every kind, the
    plain product and selected-expert path run, and a unit IQ2_M file
    (IQ2_S, IQ3_S, Q4_K, Q2_K, Q5_K) goes through a prompt and a decode step."""
    res = _run("""
        import tempfile
        import numpy as np
        import torch
        from llama_cpp_dsp_tpu_torch.ops.kernels.qmm import qmm, qmm_expert_rows
        from llama_cpp_dsp_tpu_torch.ops.qtensor import IQ_KINDS
        from llama_cpp_dsp_tpu_torch.quant.dequant import dequant
        from llama_cpp_dsp_tpu_torch.quant.iq_grids import grids
        from llama_cpp_dsp_tpu_torch.runtime.context import LlamaContext
        from llama_cpp_dsp_tpu_torch.runtime.loader import load_model
        from llama_cpp_dsp_tpu_torch.tools.synth import synth_qtensor, unit_config, write_synth_gguf
        assert len(grids()) == 6
        rng = np.random.default_rng(0)
        for kind in IQ_KINDS:
            w = synth_qtensor(rng, kind, (8, 512))
            assert dequant(w).isfinite().all() and qmm(torch.ones(3, 512), w).shape == (3, 8)
            stack = synth_qtensor(rng, kind, (4, 8, 256))
            sel = torch.tensor([3, 0], dtype=torch.int32)
            assert qmm_expert_rows(torch.ones(2, 256), stack, sel).shape == (2, 8)
        path = tempfile.mkdtemp() + "/m.gguf"
        write_synth_gguf(path, unit_config("llama"), "IQ2_M", vocab="qwen2")
        ctx = LlamaContext(load_model(path), n_ctx=16, device="cpu")
        ctx.eval_tokens([1, 2, 3])
        assert np.isfinite(ctx.eval_tokens([4])).all()
        assert not [m for m in sys.modules if m.split(".")[0] in BLOCKED]
        print("ok")
    """, ROOT)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split()[-1] == "ok"


def test_chip_smoke_refuses_without_card_or_port(tmp_path):
    # no CUDA device here: non-zero exit and no result line
    res = _run("import chip_smoke; sys.exit(chip_smoke.main([]))", ROOT)
    assert res.returncode != 0 and '"ok"' not in res.stdout
    # a directory holding chip_smoke.py and nothing else of the repo, even
    # with a card reported present
    (tmp_path / "chip_smoke.py").write_text((ROOT / "chip_smoke.py").read_text())
    res = subprocess.run(
        [sys.executable, "-c", "import sys, torch; torch.cuda.is_available = lambda: True; "
         "import chip_smoke; sys.exit(chip_smoke.main([]))"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(tmp_path)))
    assert res.returncode != 0 and '"ok"' not in res.stdout


def test_entry_points_raise_without_gpu(tmp_path):
    from llama_cpp_dsp_tpu_torch.models.llama import LlamaConfig
    from llama_cpp_dsp_tpu_torch.runtime.context import LlamaContext
    from llama_cpp_dsp_tpu_torch.runtime.engine import Engine
    from llama_cpp_dsp_tpu_torch.runtime.loader import load_model
    from llama_cpp_dsp_tpu_torch.serve.server import main as server_main
    from llama_cpp_dsp_tpu_torch.tools.cli import main
    from llama_cpp_dsp_tpu_torch.tools.synth import write_synth_gguf

    assert not torch.cuda.is_available()
    path = str(tmp_path / "m.gguf")
    cfg = LlamaConfig(arch="llama", n_layers=1, n_embd=64, n_heads=2, n_kv_heads=2,
                      head_dim=32, n_ff=128, n_vocab=300, n_ctx_train=64,
                      rope=RopeParams(n_dims=32))
    write_synth_gguf(path, cfg, "Q8_0")
    model = load_model(path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LlamaContext(model)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["-m", path, "-p", "hi", "-n", "2"])
    assert LlamaContext(model, device="cpu").device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(model)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        server_main(["-m", path, "--port", "0"])
    assert Engine(model, device="cpu").device.type == "cpu"


def test_wrappers_take_plain_version_on_cpu():
    rng = np.random.default_rng(0)
    t = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32))  # noqa: E731
    before = dict(LAUNCHES)
    for kind in (GGMLType.Q4_0, GGMLType.Q4_1, GGMLType.Q5_0, GGMLType.Q5_1, GGMLType.Q8_0,
                 GGMLType.Q2_K, GGMLType.Q3_K, GGMLType.Q4_K, GGMLType.Q5_K, GGMLType.Q6_K):
        w = synth_qtensor(rng, kind, (64, 256))
        x = t(3, 256)
        assert torch.equal(qmm(x, w), qmm_plain(x, w))
        stack = synth_qtensor(rng, kind, (3, 64, 256))
        sel = torch.tensor([2, 0, 2], dtype=torch.int32)
        assert torch.equal(qmm_expert_rows(x, stack, sel), qmm_expert_rows_plain(x, stack, sel))
    q = t(2, 4, 128)
    k = t(2, 2, 16, 128).to(torch.bfloat16)
    v = t(2, 2, 16, 128).to(torch.bfloat16)
    lengths = torch.tensor([3, 16], dtype=torch.int32)
    assert torch.equal(flash_decode(q, k, v, lengths, scale=0.1),
                       flash_decode_plain(q, k, v, lengths, scale=0.1))
    w = synth_qtensor(rng, GGMLType.Q4_0, ((2 + 2 * 2) * 128, 64))
    x = t(2, 64)
    cos, sin = _rope_angles(lengths - 1, RopeParams(n_dims=128), None)
    kc, vc = k.clone(), v.clone()
    got = attn_decode_fused(x, w, kc, vc, cos, sin, lengths, n_heads=2, n_kv_heads=2,
                            scale=0.1)
    want = attn_fused_plain(x, w, k, v, cos, sin, lengths, None, lengths - 1, n_heads=2,
                            n_kv_heads=2, scale=0.1)
    assert torch.equal(got, want) and torch.equal(kc, k) and torch.equal(vc, v)
    q = t(2, 5, 4, 256)  # B4: a 5-token prompt chunk after 3 cached rows, a 4-row window
    n_past = torch.tensor([3, 0], dtype=torch.int32)
    kp, vp = t(2, 2, 16, 256).to(torch.bfloat16), t(2, 2, 16, 256).to(torch.bfloat16)
    assert torch.equal(flash_prefill(q, kp, vp, n_past, scale=0.1, swa_window=4),
                       flash_prefill_plain(q, kp, vp, n_past, scale=0.1, swa_window=4))
    q = t(2, 4, 256)
    c = t(2, 1, 16, 256).to(torch.bfloat16)
    assert torch.equal(mla_flash_decode(q, c, lengths, scale=0.1, r=128),
                       mla_flash_decode_plain(q, c, lengths, scale=0.1, r=128))
    assert LAUNCHES == before
