"""Packed dequant-matmul y = x · dequant(W)ᵀ for Q4_0, Q4_1, Q5_0, Q5_1,
Q8_0, Q2_K, Q3_K, Q4_K, Q5_K and Q6_K weights, and for the IQ / TQ kinds
(IQ4_NL, IQ4_XS and the table carrier of IQ2_XXS, IQ2_XS, IQ2_S, IQ3_XXS,
IQ3_S, IQ1_S, IQ1_M, TQ1_0, TQ2_0: 4-bit codes into the kind's value table,
one C entry per group size and scale type, the table passed as four words;
launches are counted per kind).

Counterpart of the JAX package's ops/pallas/qmm.py (`qmm_fused`,
`qmm_expert_rows`). The CUDA kernels are in csrc/qmm.cu: a tensor-core GEMV
for B ≤ 8 (decode: the integer codes as exact bf16 operands of mma.sync,
x's rows as its columns), a tiled tensor-core kernel for larger B
(prefill), and the MoE selected-expert GEMV (`qmm_expert_rows`: row s
against expert sel[s] of a stacked QTensor, reading only the selected
experts' bytes).

Tolerance: the kernels and `qmm_plain` agree with x · exact-f32-dequant(W)ᵀ
to NMSE ≤ 5e-4 (the reference's MUL_MAT tolerance, as in
tests/test_pallas_qmm.py). The plain version rounds the dequantized weight
to bf16 before an f32 product, as the JAX package's XLA path does; the GEMV
keeps the exact integer values and applies each group's scale (and, for
the kinds with mins, its min term) to the group's dot, as ggml's vec_dot
does: it differs from exact f32 only in the order of its sums
(tests/test_torch_qmm_tc.py emulates its arithmetic).
"""

from __future__ import annotations

import numpy as np
import torch

from ...gguf.constants import GGMLType
from ...quant.blocks import KVALUES_IQ4NL
from ...quant.dequant import dequant, dequant_fields
from ...quant.iq import GROUP, IQ_TABLES
from . import LAUNCHES, aligned16, stream_handle


def _fields(kind: GGMLType, n: int, k: int) -> list[tuple[str, torch.dtype, tuple]]:
    """(name, dtype, shape) of each weight field, in the C entry's order."""
    s = k // 256
    if kind == GGMLType.Q4_0:
        return [("qs", torch.uint8, (n, k // 2)), ("d", torch.float16, (n, k // 32))]
    if kind == GGMLType.Q8_0:
        return [("qs", torch.int8, (n, k)), ("d", torch.float16, (n, k // 32))]
    if kind in (GGMLType.Q4_1, GGMLType.Q5_0, GGMLType.Q5_1):
        f16 = (n, k // 32)
        qh = [("qh", torch.uint8, (n, k // 8))] if kind != GGMLType.Q4_1 else []
        m = [("m", torch.float16, f16)] if kind != GGMLType.Q5_0 else []
        return [("qs", torch.uint8, (n, k // 2)), *qh, ("d", torch.float16, f16), *m]
    if kind == GGMLType.Q6_K:
        return [("ql", torch.uint8, (n, k // 2)), ("qh", torch.uint8, (n, k // 4)),
                ("sc", torch.int8, (n, s, 16)), ("d", torch.float32, (n, s))]
    if kind == GGMLType.Q2_K:
        return [("qs", torch.uint8, (n, k // 4)), ("sc", torch.uint8, (n, s, 16)),
                ("mn", torch.uint8, (n, s, 16)), ("d", torch.float32, (n, s)),
                ("dmin", torch.float32, (n, s))]
    if kind == GGMLType.Q3_K:
        return [("qs", torch.uint8, (n, k // 4)), ("hmask", torch.uint8, (n, s, 32)),
                ("sc", torch.int8, (n, s, 16)), ("d", torch.float32, (n, s))]
    if kind in _TABLE_OF:
        g = GROUP.get(kind, 32)
        dtype = torch.float16 if kind == GGMLType.IQ4_NL else torch.float32
        return [("qs", torch.uint8, (n, k // 2)), ("d", dtype, (n, k // g))]
    qh = [("qh", torch.uint8, (n, s, 32))] if kind == GGMLType.Q5_K else []
    return [("qs", torch.uint8, (n, k // 2)), *qh, ("sc", torch.uint8, (n, s, 8)),
            ("mn", torch.uint8, (n, s, 8)), ("d", torch.float32, (n, s)),
            ("dmin", torch.float32, (n, s))]


# kind → (C entry, the K multiple its blocks need)
_ENTRY = {GGMLType.Q4_0: ("qmm_q4_0", 32), GGMLType.Q4_1: ("qmm_q4_1", 32),
          GGMLType.Q5_0: ("qmm_q5_0", 32), GGMLType.Q5_1: ("qmm_q5_1", 32),
          GGMLType.Q8_0: ("qmm_q8_0", 32),
          GGMLType.Q2_K: ("qmm_q2_k", 256), GGMLType.Q3_K: ("qmm_q3_k", 256),
          GGMLType.Q4_K: ("qmm_q4_k", 256), GGMLType.Q5_K: ("qmm_q5_k", 256),
          GGMLType.Q6_K: ("qmm_q6_k", 256)}


# the IQ / TQ kinds' value tables: IQ4's codebook or the carrier's
_TABLE_OF = {GGMLType.IQ4_NL: tuple(int(v) for v in KVALUES_IQ4NL),
             GGMLType.IQ4_XS: tuple(int(v) for v in KVALUES_IQ4NL), **IQ_TABLES}
_ENTRY.update({kind: ("qmm_tab32_f16" if kind == GGMLType.IQ4_NL else
                      f"qmm_tab{GROUP.get(kind, 32)}_f32",
                      32 if kind == GGMLType.IQ4_NL else 256) for kind in _TABLE_OF})
_EXPERT_ENTRY = {kind: "qmm_experts" + entry[3:] for kind, (entry, _) in _ENTRY.items()}


def _table_words(kind: GGMLType) -> tuple[int, ...]:
    """The kind's table as the C entry takes it: its int8 values (padded to
    16) as four little-endian 32-bit words, value v in byte v % 4 of word
    v // 4; no words for the other kinds."""
    if kind not in _TABLE_OF:
        return ()
    vals = np.zeros(16, np.int8)
    table = _TABLE_OF[kind]
    vals[:len(table)] = table
    return tuple(int(w) for w in vals.view("<u4"))


def _counter(kind: GGMLType, experts: bool = False) -> str:
    """The launch count of a kind's kernel (`LAUNCHES`): qmm_q4_k,
    qmm_experts_iq2_s, ..."""
    return f"qmm{'_experts' if experts else ''}_{kind.name.lower()}"


def _field_ptrs(w, x: torch.Tensor, name: str, lead: tuple = ()) -> list[int]:
    """Check every field of w against the kind's (name, dtype, shape), with
    `lead` dims in front (an expert stack's [E]); return the data pointers."""
    n, k = w.shape
    ptrs = []
    for field, dtype, shape in _fields(w.kind, n, k):
        a = w[field]
        shape = (*lead, *shape)
        if a.device != x.device:
            raise ValueError(f"{name}: x on {x.device}, W.{field} on {a.device}")
        if a.dtype != dtype or tuple(a.shape) != shape:
            raise ValueError(f"{name}: bad {w.kind.name} field {field} {a.dtype}"
                             f"{tuple(a.shape)}, want {dtype}{shape}")
        if not a.is_contiguous() or a.data_ptr() % 16:
            raise ValueError(f"{name}: W.{field} must be contiguous and 16-byte aligned")
        ptrs.append(a.data_ptr())
    return ptrs


def _entry(w, table: dict, name: str) -> str:
    if w.kind not in table:
        raise NotImplementedError(f"{name}: no kernel for {w.kind.name} weights")
    return table[w.kind]


def qmm_plain(x: torch.Tensor, w) -> torch.Tensor:
    """[..., K] · QTensor [N, K]ᵀ → [..., N] f32, plain PyTorch."""
    wd = dequant(w, torch.bfloat16).float()
    return x.to(torch.bfloat16).float() @ wd.T


def qmm(x: torch.Tensor, w) -> torch.Tensor:
    """[..., K] · QTensor [N, K]ᵀ → [..., N] f32 (x taken as bf16)."""
    if w.n_expert:
        raise ValueError("qmm of an expert stack: take w.expert(eid) or qmm_expert_rows")
    if x.device.type == "cpu":
        return qmm_plain(x, w)
    from .build import check, lib

    n, k = w.shape
    entry, block = _entry(w, _ENTRY, "qmm")
    if x.shape[-1] != k or k % block:
        raise ValueError(f"qmm: x {tuple(x.shape)} vs W {w.shape} (K % {block} == 0)")
    ptrs = _field_ptrs(w, x, "qmm")
    lead = x.shape[:-1]
    x2 = aligned16(x.reshape(-1, k).to(torch.bfloat16).contiguous())
    b = x2.shape[0]
    y = torch.empty(b, n, dtype=torch.float32, device=x.device)
    if b:
        rc = getattr(lib(), entry)(x2.data_ptr(), *ptrs, *_table_words(w.kind), y.data_ptr(),
                                   b, n, k, stream_handle(x))
        check(rc, entry)
        LAUNCHES[_counter(w.kind)] += 1
    return y.reshape(*lead, n)


def qmm_expert_rows_plain(x: torch.Tensor, w, sel: torch.Tensor) -> torch.Tensor:
    """x [S, K] · expert sel[s] of the stack w [E, N, K] → [S, N] f32, plain
    PyTorch: the selected experts' fields gathered per row, dequantized and
    rounded to bf16 like `qmm_plain`. Ids are clamped to [0, E), as the
    kernel clamps them."""
    s = x.shape[0]
    n, k = w.shape
    idx = sel.long().clamp(0, w.n_expert - 1)
    rows = {name: a[idx].reshape(s * n, *a.shape[2:]) for name, a in w.arrays.items()}
    wd = dequant_fields(w.kind, rows, torch.bfloat16).float().reshape(s, n, k)
    return torch.bmm(wd, x.to(torch.bfloat16).float()[:, :, None])[:, :, 0]


def qmm_expert_rows(x: torch.Tensor, w, sel: torch.Tensor) -> torch.Tensor:
    """Per-row expert GEMV (ggml MUL_MAT_ID): y[s] = x[s] · dequant(W[sel[s]])ᵀ.
    x [S, K] (taken as bf16), w a QTensor expert stack [E, N, K], sel [S]
    int32 expert ids on x's device (never read by the host) → [S, N] f32."""
    if not w.n_expert or x.ndim != 2 or tuple(sel.shape) != (x.shape[0],):
        raise ValueError(f"qmm_expert_rows: x {tuple(x.shape)}, sel {tuple(sel.shape)}, "
                         f"W n_expert {w.n_expert} (want x [S,K], sel [S], an expert stack)")
    if x.device.type == "cpu":
        return qmm_expert_rows_plain(x, w, sel)
    from .build import check, lib

    n, k = w.shape
    entry = _entry(w, _EXPERT_ENTRY, "qmm_expert_rows")
    block = _ENTRY[w.kind][1]
    s = x.shape[0]
    if x.shape[1] != k or k % block or s > 65535:
        raise ValueError(f"qmm_expert_rows: x {tuple(x.shape)} vs W {w.shape} "
                         f"(K % {block} == 0, S ≤ 65535)")
    if sel.device != x.device or sel.dtype != torch.int32:
        raise ValueError(f"qmm_expert_rows: sel must be int32 on {x.device}, "
                         f"got {sel.dtype} on {sel.device}")
    ptrs = _field_ptrs(w, x, "qmm_expert_rows", (w.n_expert,))
    x2 = aligned16(x.to(torch.bfloat16).contiguous())
    sel = sel.contiguous()
    y = torch.empty(s, n, dtype=torch.float32, device=x.device)
    if s:
        rc = getattr(lib(), entry)(x2.data_ptr(), sel.data_ptr(), *ptrs, *_table_words(w.kind),
                                   y.data_ptr(), s, w.n_expert, n, k, stream_handle(x))
        check(rc, entry)
        LAUNCHES[_counter(w.kind, experts=True)] += 1
    return y
