"""Attention over the KV caches: decode (T=1) over dense rows of bf16, f16 or
f32 (`flash_decode`), Q8_0 rows (`flash_decode_q8`), Q4_0 row pairs
(`flash_decode_q4`), dense pages (`flash_decode_paged`) and Q8_0 pages
(`flash_decode_paged_q8`); causal prefill (T>1) over dense rows
(`flash_prefill`, csrc/flash_prefill.cu); and DeepSeek-V2's latent
attention over an MLA cache (`mla_flash_decode`, csrc/mla_decode.cu).

Counterpart of the JAX package's ops/pallas/attention.py entries of the same
names. `flash_decode` (B2) and `flash_decode_paged_q8` (B7) run a cluster
kernel (csrc/flash_decode_gqa.cuh): a cluster of 8 or 16 blocks a (kv head,
slot) pair cuts the valid span into even parts on the card, each block
streams its part's rows through a shared-memory ring once for the whole GQA
group (B7: each 16-byte chunk through its own page, the row scales beside
the rows), and the parts merge by log-sum-exp through distributed shared
memory in the same launch. The three other decode entries run one templated
CUDA kernel (csrc/flash_decode.cu): split-S flash decoding with a second
launch that merges the splits. A q8 score is (q·kq)·kd[row] and a q8 value
term (p·vd[row])·vq, as the TPU kernels fold the row scales; a q4 score sums
kd[row, g]·(q·(k − 8)) over the 32-wide groups g and its value term folds
vd[row, g] the same way; no cache is dequantized into a buffer. A paged
split of `flash_decode_paged` is a run of pages read through the block
table. Where K and V come in two dense types, both are taken in f32
(exact: the kernel converts every element to f32 as it loads it). The
decode and prefill kernels take head widths 128 and 256 (`HEAD_DIMS`); a
CUDA tensor of another width raises (ROADMAP.md queue B, item 5), and the
model sends such layers (TinyLlama's 64) to the plain attention.

Tolerances against the JAX kernels (plain versions, CPU): atol 2e-5 with
f32 inputs and 2e-3 with a bf16 cache (tests/test_flash_attention.py), 1e-5
for the q8, q4 and paged forms (tests/test_quant_kv.py,
tests/test_torch_q4_kv.py, tests/test_paged_kv.py), 2e-5 for prefill;
sums are taken in another order. Kernel against plain version on the card
(chip_smoke.py): per-slot NMSE ≤ 1e-8, which a dropped cache row (decode)
or a window or causal bound one row off (prefill) exceeds; the same limit
for `mla_flash_decode`.
"""

from __future__ import annotations

import torch

from ...quant.kv_planes import q4_deq_plane
from .. import softcap as apply_softcap
from . import LAUNCHES, aligned16, stream_handle

SPLIT_ROWS = 64  # cache rows per split of the q8, q4 and bf16 / f16 / f32 paged entries
HEAD_DIMS = (128, 256)  # the kernels' head widths (Llama / Qwen / Mixtral; Gemma)
MAX_REP = 16  # B2's and B7's query heads a kv head
CLUSTERS = (0, 8, 16)  # B2's and B7's blocks a (kv head, slot) pair; 0: the kernel's choice
_WIDTH_ROW = "ROADMAP.md queue B, item 5"
_Q8_DTYPES = (torch.int8, torch.float32, torch.int8, torch.float32)
_Q4_DTYPES = (torch.uint8, torch.float32, torch.uint8, torch.float32)
_ROW_TYPES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}  # the C entries' codes


def _softmax_out(sc, v, lengths, starts, softcap, vscale=None):
    """Masked softmax over scores [B,Hkv,rep,S] and the value sum; vscale
    [B,Hkv,1,S] folds a q8 row scale into the probabilities."""
    b, hkv, rep, s = sc.shape
    if softcap:
        sc = apply_softcap(sc, softcap)
    j = torch.arange(s, device=sc.device)
    st = torch.zeros_like(lengths) if starts is None else starts
    valid = (j[None, :] < lengths[:, None]) & (j[None, :] >= st[:, None])
    sc = sc.masked_fill(~valid[:, None, None, :], float("-inf"))
    m = sc.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(sc - m)
    l = p.sum(dim=-1, keepdim=True)
    pv = p if vscale is None else p * vscale
    out = torch.einsum("bhrs,bhsd->bhrd", pv, v.float()) / l.clamp_min(1e-30)
    return out.reshape(b, hkv * rep, -1)


def flash_decode_plain(q, k, v, lengths, starts=None, *, scale: float,
                       softcap: float = 0.0) -> torch.Tensor:
    """q [B,H,D], k/v [B,Hkv,S,D] → [B,H,D] f32 over rows [start, length)."""
    b, h, d = q.shape
    hkv = k.shape[1]
    qf = q.float().reshape(b, hkv, h // hkv, d) * scale
    sc = torch.einsum("bhrd,bhsd->bhrs", qf, k.float())
    return _softmax_out(sc, v, lengths, starts, softcap)


def flash_decode_q8_plain(q, k_qs, k_d, v_qs, v_d, lengths, starts=None, *, scale: float,
                          softcap: float = 0.0) -> torch.Tensor:
    """q [B,H,D], int8 k_qs/v_qs [B,Hkv,S,D], f32 row scales k_d/v_d
    [B,Hkv,1,S] → [B,H,D] f32."""
    b, h, d = q.shape
    hkv = k_qs.shape[1]
    qf = q.float().reshape(b, hkv, h // hkv, d) * scale
    sc = torch.einsum("bhrd,bhsd->bhrs", qf, k_qs.float()) * k_d
    return _softmax_out(sc, v_qs, lengths, starts, softcap, vscale=v_d)


def flash_decode_q4_plain(q, k_qs, k_d, v_qs, v_d, lengths, starts=None, *, scale: float,
                          softcap: float = 0.0) -> torch.Tensor:
    """q [B,H,D]; u8 row-pair planes k_qs/v_qs [B,Hkv,S/2,D]; parity-major f32
    group scales k_d/v_d [B,Hkv,2G,S/2] → [B,H,D] f32: the rows unpacked and
    scaled in f32, then the masked softmax of flash_decode_plain."""
    b, h, d = q.shape
    hkv = k_qs.shape[1]
    qf = q.float().reshape(b, hkv, h // hkv, d) * scale
    sc = torch.einsum("bhrd,bhsd->bhrs", qf, q4_deq_plane(k_qs, k_d, torch.float32))
    return _softmax_out(sc, q4_deq_plane(v_qs, v_d, torch.float32), lengths, starts, softcap)


def _gather_pages(pool, tables):
    """Pool [P, Hkv, ps, X] through tables [B, nb] (clamped to P-1) →
    [B, Hkv, nb*ps, X]."""
    g = pool[torch.clamp(tables.long(), max=pool.shape[0] - 1)]
    b, nb, hkv, ps = g.shape[:4]
    return g.transpose(1, 2).reshape(b, hkv, nb * ps, *g.shape[4:])


def flash_decode_paged_plain(q, k_pages, v_pages, tables, lengths, starts=None, *,
                             scale: float, softcap: float = 0.0) -> torch.Tensor:
    """q [B,H,D], pools [P,Hkv,ps,D], tables [B,max_blocks] → [B,H,D] f32."""
    return flash_decode_plain(q, _gather_pages(k_pages, tables), _gather_pages(v_pages, tables),
                              lengths, starts, scale=scale, softcap=softcap)


def flash_decode_paged_q8_plain(q, k_qs, k_d, v_qs, v_d, tables, lengths, starts=None, *,
                                scale: float, softcap: float = 0.0) -> torch.Tensor:
    """As flash_decode_paged_plain over int8 pools with scales [P,Hkv,1,ps]."""
    def scales(pool):
        return _gather_pages(pool[:, :, 0], tables)[:, :, None, :]

    return flash_decode_q8_plain(q, _gather_pages(k_qs, tables), scales(k_d),
                                 _gather_pages(v_qs, tables), scales(v_d), lengths, starts,
                                 scale=scale, softcap=softcap)


def _operands(name: str, q, planes, dtypes, tables, lengths, starts):
    """Check a decode entry's operands; returns q in f32, the lengths, the
    starts (or None) and the tables (or ()) as the C entries take them.
    planes: the cache operands in the entry's order, dtypes: the dtype each
    must have."""
    b, h, d = q.shape
    hkv = planes[0].shape[1]
    if d not in HEAD_DIMS or planes[0].shape[-1] != d or h % hkv or lengths.shape != (b,):
        raise ValueError(f"{name}: q {tuple(q.shape)} cache {tuple(planes[0].shape)}: needs "
                         f"D in {HEAD_DIMS} ({_WIDTH_ROW}) and H % Hkv == 0")
    for t, want in zip(planes, dtypes):
        if t.dtype != want or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: cache operand {t.dtype}{tuple(t.shape)} must be "
                             f"{want}, contiguous and 16-byte aligned")
    for t in (*planes, lengths) + (() if tables is None else (tables,)):
        if t.device != q.device:
            raise ValueError(f"{name}: tensors on {t.device} and {q.device}")
    qf = aligned16(q.float().contiguous())
    ln = lengths.to(torch.int32).contiguous()
    st = None if starts is None else starts.to(device=q.device, dtype=torch.int32).contiguous()
    tb = () if tables is None else (tables.to(torch.int32).contiguous(),)
    return qf, ln, st, tb


def _launch(name: str, q, planes, dtypes, tables, lengths, starts, n_splits: int,
            tail: tuple, scale: float, softcap: float) -> torch.Tensor:
    """Check the operands, allocate output and scratch, launch split-kernel
    C entry `name` and count it."""
    from .build import check, lib

    b, h, d = q.shape
    hkv = planes[0].shape[1]
    qf, ln, st, tb = _operands(name, q, planes, dtypes, tables, lengths, starts)
    out = torch.empty(b, h, d, dtype=torch.float32, device=q.device)
    ws_acc = torch.empty(b * h * n_splits * d, dtype=torch.float32, device=q.device)
    ws_ml = torch.empty(b * h * n_splits * 2, dtype=torch.float32, device=q.device)
    ptrs = [t.data_ptr() for t in (qf, *planes, *tb, ln)]
    rc = getattr(lib(), name)(*ptrs, None if st is None else st.data_ptr(), out.data_ptr(),
                              ws_acc.data_ptr(), ws_ml.data_ptr(), b, h, hkv, d, *tail,
                              float(scale), float(softcap), stream_handle(q))
    check(rc, name)
    LAUNCHES[name] += 1
    return out


def _row_type(name: str, k, v):
    """(k, v, code): dense K/V of one of the kernel's row types; two
    different types are both taken in f32."""
    if k.dtype not in _ROW_TYPES or v.dtype not in _ROW_TYPES:
        raise ValueError(f"{name}: rows {k.dtype} / {v.dtype}: the kernel takes bf16, f16 and "
                         "f32")
    if k.dtype != v.dtype:
        k, v = k.float(), v.float()
    return k, v, _ROW_TYPES[k.dtype]


def flash_decode(q, k, v, lengths, starts=None, *, scale: float, softcap: float = 0.0,
                 cluster: int = 0) -> torch.Tensor:
    """q [B,H,D] (roped, taken in f32), k/v [B,Hkv,S,D] of bf16, f16 or f32
    → [B,H,D] f32. On the card one launch of B2's cluster kernel
    (csrc/flash_decode_gqa.cuh), `cluster` blocks a (kv head, slot) pair:
    8, 16, or 0 for the kernel's own choice (what the model passes)."""
    if q.device.type == "cpu":
        return flash_decode_plain(q, k, v, lengths, starts, scale=scale, softcap=softcap)
    from .build import check, lib

    b, h, d = q.shape
    if k.shape != v.shape or k.dim() != 4 or k.shape[0] != b:
        raise ValueError(f"flash_decode: k {tuple(k.shape)} v {tuple(v.shape)} q {tuple(q.shape)}")
    hkv, s = k.shape[1], k.shape[2]
    if h % hkv == 0 and h // hkv > MAX_REP or cluster not in CLUSTERS:
        raise ValueError(f"flash_decode: H={h} over Hkv={hkv}, cluster {cluster}: the kernel "
                         f"takes H / Hkv <= {MAX_REP} and a cluster in {CLUSTERS}")
    k, v, code = _row_type("flash_decode", k, v)
    qf, ln, st, _ = _operands("flash_decode", q, (k, v), (k.dtype,) * 2, None, lengths, starts)
    out = torch.empty(b, h, d, dtype=torch.float32, device=q.device)
    rc = lib().flash_decode(qf.data_ptr(), k.data_ptr(), v.data_ptr(), ln.data_ptr(),
                            None if st is None else st.data_ptr(), out.data_ptr(), b, h, hkv, d,
                            s, code, cluster, float(scale), float(softcap), stream_handle(q))
    check(rc, "flash_decode")
    LAUNCHES["flash_decode"] += 1
    return out


def flash_decode_q8(q, k_qs, k_d, v_qs, v_d, lengths, starts=None, *, scale: float,
                    softcap: float = 0.0) -> torch.Tensor:
    """q [B,H,D]; int8 k_qs/v_qs [B,Hkv,S,D]; f32 k_d/v_d [B,Hkv,1,S]."""
    if q.device.type == "cpu":
        return flash_decode_q8_plain(q, k_qs, k_d, v_qs, v_d, lengths, starts, scale=scale,
                                     softcap=softcap)
    b, hkv, s, _ = k_qs.shape
    if (v_qs.shape != k_qs.shape or k_d.shape != (b, hkv, 1, s) or v_d.shape != k_d.shape
            or b != q.shape[0]):
        raise ValueError(f"flash_decode_q8: k_qs {tuple(k_qs.shape)} k_d {tuple(k_d.shape)} "
                         f"v_qs {tuple(v_qs.shape)} v_d {tuple(v_d.shape)} q {tuple(q.shape)}")
    return _launch("flash_decode_q8", q, (k_qs, k_d, v_qs, v_d), _Q8_DTYPES, None, lengths,
                   starts, -(-s // SPLIT_ROWS), (s, SPLIT_ROWS), scale, softcap)


def flash_decode_q4(q, k_qs, k_d, v_qs, v_d, lengths, starts=None, *, scale: float,
                    softcap: float = 0.0) -> torch.Tensor:
    """Decode attention over a Q4_0 cache (JAX ops/pallas/attention.py
    ::flash_decode_q4): q [B,H,D] taken in f32; u8 k_qs/v_qs [B,Hkv,S/2,D]
    (row 2j in the low nibble of byte row j, 2j+1 in the high one); f32
    k_d/v_d [B,Hkv,2G,S/2] parity-major group scales, G = D/32 → [B,H,D] f32
    over rows [start, length). Any even capacity S."""
    if q.device.type == "cpu":
        return flash_decode_q4_plain(q, k_qs, k_d, v_qs, v_d, lengths, starts, scale=scale,
                                     softcap=softcap)
    b, hkv, s2, d = k_qs.shape
    if (v_qs.shape != k_qs.shape or k_d.shape != (b, hkv, 2 * (d // 32), s2)
            or v_d.shape != k_d.shape or b != q.shape[0]):
        raise ValueError(f"flash_decode_q4: k_qs {tuple(k_qs.shape)} k_d {tuple(k_d.shape)} "
                         f"v_qs {tuple(v_qs.shape)} v_d {tuple(v_d.shape)} q {tuple(q.shape)}")
    return _launch("flash_decode_q4", q, (k_qs, k_d, v_qs, v_d), _Q4_DTYPES, None, lengths,
                   starts, -(-2 * s2 // SPLIT_ROWS), (2 * s2, SPLIT_ROWS), scale, softcap)


def _pages_per_split(ps: int) -> int:
    return max(1, SPLIT_ROWS // ps)


def _paged_tail(name, pool, tables, q):
    n_pages, _, ps, _ = pool.shape
    nb = tables.shape[1]
    if tables.dim() != 2 or tables.shape[0] != q.shape[0]:
        raise ValueError(f"{name}: tables {tuple(tables.shape)} for q {tuple(q.shape)}")
    pps = _pages_per_split(ps)
    return -(-nb // pps), (ps, nb, n_pages, pps)


def flash_decode_paged(q, k_pages, v_pages, tables, lengths, starts=None, *, scale: float,
                       softcap: float = 0.0) -> torch.Tensor:
    """q [B,H,D]; pools [P,Hkv,ps,D] of bf16, f16 or f32; tables
    [B,max_blocks] int32 page ids (an entry ≥ P is clamped to P-1 and never
    read below the length)."""
    if q.device.type == "cpu":
        return flash_decode_paged_plain(q, k_pages, v_pages, tables, lengths, starts,
                                        scale=scale, softcap=softcap)
    if v_pages.shape != k_pages.shape:
        raise ValueError(f"flash_decode_paged: k {tuple(k_pages.shape)} v {tuple(v_pages.shape)}")
    k_pages, v_pages, code = _row_type("flash_decode_paged", k_pages, v_pages)
    n_splits, tail = _paged_tail("flash_decode_paged", k_pages, tables, q)
    return _launch("flash_decode_paged", q, (k_pages, v_pages), (k_pages.dtype,) * 2, tables,
                   lengths, starts, n_splits, (*tail, code), scale, softcap)


def flash_decode_paged_q8(q, k_qs, k_d, v_qs, v_d, tables, lengths, starts=None, *,
                          scale: float, softcap: float = 0.0, cluster: int = 0) -> torch.Tensor:
    """q [B,H,D] (taken in f32); int8 pools [P,Hkv,ps,D]; f32 row scales
    [P,Hkv,1,ps]; tables [B,max_blocks] int32 page ids (an entry ≥ P is
    clamped to P-1 and never read below the length) → [B,H,D] f32. On the
    card one launch of B7's cluster kernel (csrc/flash_decode_gqa.cuh, no
    workspace), `cluster` blocks a (kv head, slot) pair: 8, 16, or 0 for the
    kernel's own choice (what the model passes). Any page size."""
    if q.device.type == "cpu":
        return flash_decode_paged_q8_plain(q, k_qs, k_d, v_qs, v_d, tables, lengths, starts,
                                           scale=scale, softcap=softcap)
    from .build import check, lib

    name = "flash_decode_paged_q8"
    b, h, d = q.shape
    p, hkv, ps, _ = k_qs.shape
    if v_qs.shape != k_qs.shape or k_d.shape != (p, hkv, 1, ps) or v_d.shape != k_d.shape:
        raise ValueError(f"{name}: k_qs {tuple(k_qs.shape)} k_d {tuple(k_d.shape)} v_qs "
                         f"{tuple(v_qs.shape)} v_d {tuple(v_d.shape)}")
    if tables.dim() != 2 or tables.shape[0] != b:
        raise ValueError(f"{name}: tables {tuple(tables.shape)} for q {tuple(q.shape)}")
    if h % hkv == 0 and h // hkv > MAX_REP or cluster not in CLUSTERS:
        raise ValueError(f"{name}: H={h} over Hkv={hkv}, cluster {cluster}: the kernel takes "
                         f"H / Hkv <= {MAX_REP} and a cluster in {CLUSTERS}")
    qf, ln, st, (tb,) = _operands(name, q, (k_qs, k_d, v_qs, v_d), _Q8_DTYPES, tables, lengths,
                                  starts)
    out = torch.empty(b, h, d, dtype=torch.float32, device=q.device)
    rc = lib().flash_decode_paged_q8(
        qf.data_ptr(), k_qs.data_ptr(), k_d.data_ptr(), v_qs.data_ptr(), v_d.data_ptr(),
        tb.data_ptr(), ln.data_ptr(), None if st is None else st.data_ptr(), out.data_ptr(), b,
        h, hkv, d, ps, tables.shape[1], p, cluster, float(scale), float(softcap),
        stream_handle(q))
    check(rc, name)
    LAUNCHES[name] += 1
    return out


# ---------------------------------------------------------------------------
# Causal prefill (T > 1) over a dense cache
# ---------------------------------------------------------------------------

def attention_plain(q, k, v, mask, scale: float, softcap: float = 0.0) -> torch.Tensor:
    """Masked multi-head attention, f32 softmax and accumulation (JAX
    models/llama.py::attention). q [B,T,H,D] (roped), k/v [B,Hkv,S,D], mask
    [B,T,S] bool (None: every row) → [B,T,H*D] f32."""
    b, t, h, d = q.shape
    hkv = k.shape[1]
    qf = q.float().reshape(b, t, hkv, h // hkv, d)
    scores = torch.einsum("bthrd,bhsd->bhrts", qf, k.float()) * scale
    if softcap:
        scores = apply_softcap(scores, softcap)
    if mask is not None:
        bias = torch.where(mask, 0.0, torch.finfo(torch.float32).min)
        scores = scores + bias[:, None, None, :, :]
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhrts,bhsd->bthrd", probs, v.float())
    return out.reshape(b, t, h * d)


def flash_prefill_plain(q, k, v, n_past, *, scale: float, softcap: float = 0.0,
                        swa_window: int = 0, attn_chunk: int = 0) -> torch.Tensor:
    """q [B,T,H,D], k/v [B,Hkv,S,D], n_past [B] → [B,T,H,D] f32: query t of
    slot b at position n_past[b] + t over the rows `causal_mask` gives it
    (the causal, window and chunk rules)."""
    from ...runtime.kv_cache import causal_mask

    b, t, h, d = q.shape
    n_past = n_past.to(device=q.device, dtype=torch.int32)
    pos = n_past[:, None] + torch.arange(t, dtype=torch.int32, device=q.device)
    mask = causal_mask(pos, k.shape[2], n_past, swa_window, attn_chunk)
    return attention_plain(q, k, v, mask, scale, softcap).reshape(b, t, h, d)


def flash_prefill(q, k, v, n_past, *, scale: float, softcap: float = 0.0,
                  swa_window: int = 0, attn_chunk: int = 0) -> torch.Tensor:
    """Causal prefill attention (JAX ops/pallas/attention.py::flash_prefill):
    q [B,T,H,D] (roped, taken in f32), k/v [B,Hkv,S,D] of bf16, f16 or f32
    (rows [0, n_past + T) written), n_past [B] int32 → [B,T,H,D] f32. Query t
    attends rows j ≤ n_past + t, and j > n_past + t − swa_window (swa_window >
    0) or j ≥ ⌊(n_past + t) / attn_chunk⌋·attn_chunk (attn_chunk > 0); rows past
    n_past + T are never read. The C entry takes bf16 and f16 rows to the
    split-operand tensor-core kernel and f32 rows (or two different row
    types, both taken in f32) to the CUDA-core kernel (csrc/flash_prefill.cu)."""
    if q.device.type == "cpu":
        return flash_prefill_plain(q, k, v, n_past, scale=scale, softcap=softcap,
                                   swa_window=swa_window, attn_chunk=attn_chunk)
    from .build import check, lib

    b, t, h, d = q.shape
    k, v, code = _row_type("flash_prefill", k, v)
    if (d not in HEAD_DIMS or k.shape != v.shape or k.dim() != 4 or k.shape[0] != b
            or k.shape[3] != d or h % k.shape[1] or n_past.shape != (b,)):
        raise ValueError(f"flash_prefill: q {tuple(q.shape)} k {tuple(k.shape)} v "
                         f"{tuple(v.shape)} n_past {tuple(n_past.shape)}: needs D in "
                         f"{HEAD_DIMS} ({_WIDTH_ROW}), H % Hkv == 0 and n_past [B]")
    for x in (k, v):
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError("flash_prefill: k and v must be contiguous and 16-byte aligned")
    for x in (k, v, n_past):
        if x.device != q.device:
            raise ValueError(f"flash_prefill: tensors on {x.device} and {q.device}")
    qf = aligned16(q.float().contiguous())
    np_ = n_past.to(torch.int32).contiguous()
    out = torch.empty(b, t, h, d, dtype=torch.float32, device=q.device)
    rc = lib().flash_prefill(qf.data_ptr(), k.data_ptr(), v.data_ptr(), np_.data_ptr(),
                             out.data_ptr(), b, t, h, k.shape[1], d, k.shape[2], code,
                             int(swa_window), int(attn_chunk), float(scale), float(softcap),
                             stream_handle(q))
    check(rc, "flash_prefill")
    LAUNCHES["flash_prefill"] += 1
    return out


# ---------------------------------------------------------------------------
# MLA latent-attention decode (DeepSeek-V2, models/deepseek2.py)
# ---------------------------------------------------------------------------

MLA_MIN_ROWS = 16  # latent rows a split takes at least
MLA_MAX_HEADS = 16
MLA_MAX_RANK = 512
MLA_MAX_DIM = 768  # a cache row's width C: a lane holds q's words l, l + 32, ... (12 at most)


def mla_flash_decode_plain(q, c, lengths, *, scale: float, r: int) -> torch.Tensor:
    """q [B,H,C] (q_lat ⊕ q_rope ⊕ 0), latents c [B,1,S,C], lengths [B] →
    [B,H,r] f32: softmax over the rows j < length of (q·scale)·c[j], then
    the weighted sum of c[j, :r] (JAX mla_flash_decode's math)."""
    s = c.shape[2]
    rows = c[:, 0].float()  # [B, S, C]
    sc = torch.einsum("bhc,bsc->bhs", q.float() * scale, rows)
    valid = torch.arange(s, device=q.device)[None, :] < lengths.to(q.device)[:, None]
    sc = sc.masked_fill(~valid[:, None, :], float("-inf"))
    m = sc.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(sc - m)
    l = p.sum(dim=-1, keepdim=True)
    return torch.einsum("bhs,bsr->bhr", p, rows[..., :r]) / l.clamp_min(1e-30)


def mla_flash_decode(q, c, lengths, *, scale: float, r: int) -> torch.Tensor:
    """Latent attention decode over an MLA cache (JAX ops/pallas/attention.py
    ::mla_flash_decode): q [B,H,C] taken in f32, bf16 c [B,1,S,C] (the
    cache layer's own buffer), lengths [B] → [B,H,r] f32. Any capacity S
    and any length ≤ S."""
    if q.device.type == "cpu":
        return mla_flash_decode_plain(q, c, lengths, scale=scale, r=r)
    from .build import check, lib

    b, h, cdim = q.shape
    if (c.dim() != 4 or c.shape[0] != b or c.shape[1] != 1 or c.shape[3] != cdim
            or lengths.shape != (b,)):
        raise ValueError(f"mla_flash_decode: q {tuple(q.shape)} c {tuple(c.shape)} "
                         f"lengths {tuple(lengths.shape)} (want c [B,1,S,C], lengths [B])")
    if h > MLA_MAX_HEADS or r > min(MLA_MAX_RANK, cdim) or r % 2 or cdim % 8 \
            or cdim > MLA_MAX_DIM:
        raise ValueError(f"mla_flash_decode: H={h} r={r} C={cdim} (the kernel takes "
                         f"H ≤ {MLA_MAX_HEADS}, r ≤ min({MLA_MAX_RANK}, C), r even, "
                         f"C % 8 == 0, C ≤ {MLA_MAX_DIM})")
    if c.dtype != torch.bfloat16 or not c.is_contiguous() or c.data_ptr() % 16:
        raise ValueError("mla_flash_decode: c must be bf16, contiguous and 16-byte aligned")
    if c.device != q.device or lengths.device != q.device:
        raise ValueError(f"mla_flash_decode: tensors on {c.device}, {lengths.device} "
                         f"and {q.device}")
    s = c.shape[2]
    # blocks per slot: one wave over the SMs in all, no more than the
    # capacity's runs of MLA_MIN_ROWS; each slot spreads its own valid rows
    # over them on the card (the lengths stay there)
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    n_splits = max(1, min(-(-s // MLA_MIN_ROWS), -(-sms // b)))
    qf = aligned16(q.float().contiguous())  # read in 8-byte vectors
    ln = lengths.to(torch.int32).contiguous()
    out = torch.empty(b, h, r, dtype=torch.float32, device=q.device)
    ws_acc = torch.empty(b * h * n_splits * r, dtype=torch.float32, device=q.device)
    ws_ml = torch.empty(b * h * n_splits * 2, dtype=torch.float32, device=q.device)
    rc = lib().mla_decode(qf.data_ptr(), c.data_ptr(), ln.data_ptr(), out.data_ptr(),
                          ws_acc.data_ptr(), ws_ml.data_ptr(), b, h, cdim, r, s, n_splits,
                          MLA_MIN_ROWS, float(scale), stream_handle(q))
    check(rc, "mla_decode")
    LAUNCHES["mla_decode"] += 1
    return out
