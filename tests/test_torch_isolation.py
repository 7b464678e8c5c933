"""The PyTorch port stands alone: it imports nothing of JAX or of the JAX
package, its entry points refuse to fall back to the CPU silently, and its
kernel wrappers take the plain versions only for CPU tensors."""

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
from llama_cpp_dsp_tpu_torch.ops.kernels.attention import flash_decode, flash_decode_plain
from llama_cpp_dsp_tpu_torch.ops.kernels.attn_fused import attn_decode_fused, attn_fused_plain
from llama_cpp_dsp_tpu_torch.ops.kernels.qmm import qmm, qmm_plain
from llama_cpp_dsp_tpu_torch.ops.rope import RopeParams, _rope_angles
from llama_cpp_dsp_tpu_torch.tools.synth import synth_qtensor

ROOT = Path(__file__).resolve().parent.parent

_BLOCKER = """
import importlib.abc, sys
BLOCKED = ("jax", "jaxlib", "llama_cpp_dsp_tpu")
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
        assert not [m for m in sys.modules if m.split(".")[0] in BLOCKED]
        print("imported", len(names))
    """, ROOT)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 25


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
    from llama_cpp_dsp_tpu_torch.runtime.loader import load_model
    from llama_cpp_dsp_tpu_torch.tools.cli import main
    from llama_cpp_dsp_tpu_torch.tools.synth import write_synth_gguf

    assert not torch.cuda.is_available()
    path = str(tmp_path / "m.gguf")
    cfg = LlamaConfig(arch="llama", n_layers=1, n_embd=64, n_heads=2, n_kv_heads=2,
                      head_dim=32, n_ff=128, n_vocab=300, n_ctx_train=64,
                      rope=RopeParams(n_dims=32))
    write_synth_gguf(path, cfg, GGMLType.Q8_0)
    model = load_model(path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LlamaContext(model)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["-m", path, "-p", "hi", "-n", "2"])
    assert LlamaContext(model, device="cpu").device.type == "cpu"


def test_wrappers_take_plain_version_on_cpu():
    rng = np.random.default_rng(0)
    t = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32))  # noqa: E731
    before = dict(LAUNCHES)
    for kind in (GGMLType.Q4_0, GGMLType.Q8_0):
        w = synth_qtensor(rng, kind, (64, 128))
        x = t(3, 128)
        assert torch.equal(qmm(x, w), qmm_plain(x, w))
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
    assert LAUNCHES == before
