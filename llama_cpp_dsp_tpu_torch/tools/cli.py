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
from ..runtime.kv_cache import KV_PLANE_FORMATS
from ..runtime.loader import LoadedModel, load_model
from ..runtime.sampling import make_chain
from ..runtime.state_io import load_state, save_state


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
    p.add_argument("--prompt-cache", metavar="FILE",
                   help="load/save prompt KV state (reference --prompt-cache)")
    p.add_argument("-ctk", "--cache-type-k", default="bf16", choices=KV_PLANE_FORMATS,
                   help="K cache data type (reference --cache-type-k)")
    p.add_argument("-ctv", "--cache-type-v", default=None, choices=KV_PLANE_FORMATS,
                   help="V cache data type (reference --cache-type-v; defaults to -ctk)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain versions)")
    return p


def _restore_prompt_cache(ctx: LlamaContext, path: str, ids: list[int]) -> list[int]:
    """The JAX CLI's prompt-cache reuse (reference examples/main): restore the
    saved session and keep its longest prefix shared with this prompt, when
    that is more than one token. Returns the reused tokens ([] for none)."""
    try:
        cached = load_state(ctx, path)
    except (OSError, ValueError, KeyError) as e:
        print(f"prompt-cache: ignoring ({e})", file=sys.stderr)
        return []
    n_match = 0
    for a, b in zip(cached, ids):
        if a != b:
            break
        n_match += 1
    n_match = min(n_match, ctx.n_past)  # the session's last token has no row yet
    if n_match <= 1:
        ctx.reset()
        return []
    ctx.rollback_to(n_match)
    print(f"prompt-cache: reusing {n_match} tokens", file=sys.stderr)
    return cached[:n_match]


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
        model = model or load_model(args.model, device)
    except (OSError, ValueError, NotImplementedError) as e:
        print(f"error: failed to load model: {e}", file=sys.stderr)
        return 1
    print(f"loaded {args.model} ({model.cfg.arch}, {model.cfg.n_layers} layers, "
          f"{model.n_bytes / 1e9:.2f} GB) in {time.perf_counter() - t0:.1f}s",
          file=sys.stderr)
    ctx = LlamaContext(model, n_ctx=args.ctx_size, device=device,
                       kv_dtype=args.cache_type_k, kv_v_dtype=args.cache_type_v)
    sampler = make_chain(seed=args.seed, temp=args.temp)
    tok = model.tokenizer
    ids = tok.encode(args.prompt, add_special=True, parse_special=True)
    cached = []
    if args.prompt_cache and os.path.exists(args.prompt_cache):
        cached = _restore_prompt_cache(ctx, args.prompt_cache, ids)
    if len(ids) >= ctx.n_ctx:
        print(f"error: prompt is {len(ids)} tokens but context size is {ctx.n_ctx}",
              file=sys.stderr)
        return 0
    sys.stdout.write(args.prompt)
    sys.stdout.flush()
    if cached:  # feed the rest; a fully cached prompt re-evaluates its last token
        if not ids[len(cached):]:
            ctx.rollback_to(ctx.n_past - 1)
        ids = ids[len(cached):] or [ids[-1]]
    gen_ids = []
    # stream raw piece BYTES like the reference's main.cpp (pieces may be
    # partial UTF-8 sequences)
    out = sys.stdout.buffer
    for t in ctx.generate(ids, max_new_tokens=args.n_predict, sampler=sampler):
        gen_ids.append(t)
        out.write(tok.token_to_piece(t, special=False))
        out.flush()
    out.write(b"\n")
    out.flush()
    if args.prompt_cache and not cached:  # the session: prompt + generated
        save_state(ctx, args.prompt_cache, ids + gen_ids)
        print(f"prompt-cache: saved {len(ids) + len(gen_ids)} tokens", file=sys.stderr)
    print(ctx.perf.report(), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
