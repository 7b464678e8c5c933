"""llama-cli on the PyTorch / CUDA port: one-shot generation.

Counterpart of the JAX package's tools/cli.py for the flags of the main
path; stdout carries the prompt and the generated bytes, stderr the load
line and the perf line, in the JAX CLI's formats. Runs on the card unless
`--device cpu` is given. Usage:
    python -m llama_cpp_dsp_tpu_torch.tools.cli -m model.gguf -p "prompt" -n 64
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from .. import resolve_device
from ..runtime.context import LlamaContext
from ..runtime.loader import LoadedModel, load_model
from ..runtime.sampling import make_chain


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="llama-cli", description=__doc__)
    p.add_argument("-m", "--model", required=True, help="GGUF model path")
    p.add_argument("-p", "--prompt", default="", help="prompt text")
    p.add_argument("-n", "--n-predict", type=int, default=128)
    p.add_argument("-c", "--ctx-size", type=int, default=2048)
    p.add_argument("-s", "--seed", type=int, default=0)
    p.add_argument("--temp", type=float, default=0.8)
    p.add_argument("-fa", "--flash-attn", action="store_true",
                   help="accepted as in the reference CLI; decode attention on the "
                        "card always runs the fused / flash kernels")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain versions)")
    return p


def main(argv=None, model: LoadedModel | None = None) -> int:
    """`model`: the GGUF named by -m, already loaded (a caller that runs the
    CLI on a model it holds, as `serve.server.build` takes one)."""
    args = build_arg_parser().parse_args(argv)
    device = resolve_device(args.device)
    if not os.path.exists(args.model):
        print(f"error: model file not found: {args.model}", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    try:
        model = model or load_model(args.model)
    except (OSError, ValueError, NotImplementedError) as e:
        print(f"error: failed to load model: {e}", file=sys.stderr)
        return 1
    print(f"loaded {args.model} ({model.cfg.arch}, {model.cfg.n_layers} layers, "
          f"{model.n_bytes / 1e9:.2f} GB) in {time.perf_counter() - t0:.1f}s",
          file=sys.stderr)
    ctx = LlamaContext(model, n_ctx=args.ctx_size, device=device)
    sampler = make_chain(seed=args.seed, temp=args.temp)
    tok = model.tokenizer
    ids = tok.encode(args.prompt, add_special=True, parse_special=True)
    if len(ids) >= ctx.n_ctx:
        print(f"error: prompt is {len(ids)} tokens but context size is {ctx.n_ctx}",
              file=sys.stderr)
        return 0
    sys.stdout.write(args.prompt)
    sys.stdout.flush()
    # stream raw piece BYTES like the reference's main.cpp (pieces may be
    # partial UTF-8 sequences)
    out = sys.stdout.buffer
    for t in ctx.generate(ids, max_new_tokens=args.n_predict, sampler=sampler):
        out.write(tok.token_to_piece(t, special=False))
        out.flush()
    out.write(b"\n")
    out.flush()
    print(ctx.perf.report(), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
