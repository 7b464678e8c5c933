"""The algebra of B1's tensor-core GEMV (`csrc/qmm.cu::qmm_tc`, B ≤ 8),
emulated on the CPU at the level of the kernel's registers, against the
JAX package's Pallas `qmm_fused` (interpret mode) and against a float64
product.

What is emulated, as the kernel does it:
- each lane's words: lane (g, t) of a 16-row tile loads the bytes of rows
  g and g + 8 that the kind's struct names (`tc_load`), and every 32-bit
  word becomes four codes of consecutive logical k (`code word`);
- bf16 codes without a conversion: a code c < 128 goes under exponent 134
  (`prmt` with 0x43 bytes: 128 + c) and one bf16x2 fma takes the kind's
  offset away; Q8_0's int8 is split into its nibbles, 2048 + 16·h and
  128 + l, and two bf16x2 fmas give it back; the table kinds look their
  values up as bf16 bytes (two byte tables, `prmt`);
- the fragment map: bytes 0, 1 of a word fill k-slots 2t, 2t + 1 of A,
  bytes 2, 3 k-slots 2t + 8, 2t + 9; the x fragment takes the same logical
  k: x's own words;
- one f32 accumulator per scale group (a k16 step never leaves its group),
  scaled after the group by d·sc in f32, and the group's Σx (an MMA of ones
  against the same x fragment) times the min for Q4_K, Q5_K, Q4_1 and Q5_1;
  Q2_K's 4-bit sub-scale enters its codes instead (sc·q ≤ 45, exact in
  bf16: one fma (128 + q)·sc − 128·sc) and its min is an MMA of the group's
  mn against x, both summed over the superblock in four sums taken in turn
  and scaled by d, dmin;
- split K: the units of K cut into S contiguous slices of whole batches
  (128 qs bytes a row for the kinds of 32-element blocks: 8 blocks, Q8_0's
  4; one superblock for the K-quants), each summed alone, then the slices
  added in slice order, as the block's warps and the cluster's ranks are.

Tolerance: NMSE ≤ 1e-9 against a float64 product of the bf16-rounded x with
the exact dequant (only the order of the f32 sums differs), and ≤ 5e-4
(the reference's MUL_MAT limit, as tests/test_torch_qmm.py) against JAX's
`qmm_fused`. Every emulated bf16 code is checked to equal its integer.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_cpp_dsp_tpu.gguf import GGMLType
from llama_cpp_dsp_tpu.ops.pallas.layouts import to_kernel_layout
from llama_cpp_dsp_tpu.ops.pallas.qmm import qmm_fused
from llama_cpp_dsp_tpu.ops.qtensor import from_gguf_tensor as jax_from_gguf_tensor
from llama_cpp_dsp_tpu.quant.ref_numpy import dequantize
from llama_cpp_dsp_tpu_torch.gguf.constants import GGMLType as TGGMLType
from llama_cpp_dsp_tpu_torch.ops.kernels.qmm import _table_words
from llama_cpp_dsp_tpu_torch.ops.qtensor import from_gguf_tensor
from llama_cpp_dsp_tpu_torch.tools.synth import synth_raw
from torch_fixtures import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

KINDS = [GGMLType.Q4_0, GGMLType.Q4_1, GGMLType.Q5_0, GGMLType.Q5_1, GGMLType.Q8_0,
         GGMLType.Q2_K, GGMLType.Q3_K, GGMLType.Q4_K, GGMLType.Q5_K, GGMLType.Q6_K,
         GGMLType.IQ4_NL, GGMLType.IQ4_XS, GGMLType.IQ2_S]
BLOCK32 = (GGMLType.Q4_0, GGMLType.Q4_1, GGMLType.Q5_0, GGMLType.Q5_1, GGMLType.Q8_0,
           GGMLType.IQ4_NL)
N = 40  # two whole 16-row tiles and a ragged one
F64_TOL = 1e-9
JAX_TOL = 5e-4


def nmse(got, want):
    d = np.asarray(got, np.float64) - np.asarray(want, np.float64)
    return float((d * d).mean() / ((np.asarray(want, np.float64) ** 2).mean() + 1e-30))


# ---- register-level helpers (int64 tensors holding 32-bit words) ----------

def prmt(a, b, sel):
    """__byte_perm(a, b, sel): byte i of the result is byte (sel >> 4i) & 7
    of the pair (b << 32) | a; sel an int or a tensor of selectors."""
    sel = torch.as_tensor(sel)
    out = torch.zeros_like(a)
    for i in range(4):
        s = (sel >> (4 * i)) & 7
        sh = 8 * (s & 3)
        out = out | (torch.where(s < 4, a >> sh, b >> sh) & 0xFF) << (8 * i)
    return out


def word(field: torch.Tensor, rows: torch.Tensor, off) -> torch.Tensor:
    """The little-endian 32-bit word at byte `off` (an int or a per-row
    tensor) of each row of a field, as int64."""
    b = field.reshape(field.shape[0], -1).view(torch.uint8).to(torch.int64)[rows]
    off = torch.as_tensor(off).expand(rows.shape[0])
    idx = off[:, None] + torch.arange(4)
    v = torch.gather(b, 1, idx)
    return v[:, 0] | (v[:, 1] << 8) | (v[:, 2] << 16) | (v[:, 3] << 24)


def scalar(field: torch.Tensor, rows: torch.Tensor, i) -> torch.Tensor:
    """Element i (int or per-row tensor) of each row of a field, as f32."""
    f = field.reshape(field.shape[0], -1)[rows]
    return torch.gather(f, 1, torch.as_tensor(i).expand(rows.shape[0])[:, None])[:, 0].float()


def bf16_bits(v: torch.Tensor) -> torch.Tensor:
    """bf16x2 register (int64 holding 32 bits) → its two bf16 as f32 [.., 2]."""
    lo = (v & 0xFFFF).to(torch.int32) << 16
    hi = ((v >> 16) & 0xFFFF).to(torch.int32) << 16
    return torch.stack([lo.view(torch.float32), hi.view(torch.float32)], -1)


def hfma2(a, c_bits: int, b=None):
    """bf16x2 a·1 + c (c a constant pair, or the register b): the exact sum
    rounded to bf16, as the kernel's fma.rn.bf16x2; returns f32 [.., 2]."""
    av = a if a.dtype == torch.float32 else bf16_bits(a)
    cv = bf16_bits(torch.tensor(c_bits)) if b is None else b
    return (av + cv).to(torch.bfloat16).float()


def neg(v: int) -> int:
    """The bf16x2 constant pair -(128 + v)."""
    bits = int(torch.tensor(-(128.0 + v)).to(torch.bfloat16).view(torch.int16)) & 0xFFFF
    return bits | (bits << 16)


NEG_2304 = 0xC510C510


def pairs7(cw, off: int):
    """Four codes < 128 (bytes of cw, elements e..e+3) → the bf16 pairs
    (e, e+1) and (e+2, e+3) less `off`: prmt under 0x43, one fma."""
    p01 = hfma2(prmt(cw, 0x43434343, 0x4140), neg(off - 128))
    p23 = hfma2(prmt(cw, 0x43434343, 0x4342), neg(off - 128))
    return p01, p23


def pairs8(cw):
    """Four int8 (bytes of cw) → bf16 pairs (e, e+1), (e+2, e+3): nibbles of
    q + 128 as 2048 + 16h and 128 + l, (H − 2304) + L."""
    u = cw ^ 0x80808080
    lo, hi = u & 0x0F0F0F0F, (u >> 4) & 0x0F0F0F0F
    out = []
    for sel in (0x4140, 0x4342):
        h = hfma2(prmt(hi, 0x45454545, sel), NEG_2304)
        out.append(hfma2(h, 0, bf16_bits(prmt(lo, 0x43434343, sel))))
    return out


def spread4(n):
    """Bits 0..3 of n to bit 0 of bytes 0..3 (an IMAD and a mask)."""
    return ((n & 0xF) * 0x00204081) & 0x01010101


def u8f(w, i: int):
    """Byte i of w as f32 (prmt under 0x4B000000, less 2^23)."""
    return (prmt(w, 0x4B000000, 0x7440 | i).to(torch.int32).view(torch.float32)
            - np.float32(8388608.0))


def s8f(w, i: int):
    """Signed byte i of w as f32."""
    return (prmt(w ^ 0x80808080, 0x4B000000, 0x7440 | i).to(torch.int32).view(torch.float32)
            - np.float32(8388736.0))


# ---- the kinds: per unit, per lane t, the MMAs of each scale group --------
# A kind's `unit(w, rows, u, t, K)` returns a list of groups, each a dict:
#   mmas: [(p01, p23, xoff)] (p01/p23 f32 [R, 2], the x words start at xoff)
#   dl:   f32 [R]  (the group's d·sc), ml: f32 [R] or None (its min)
# The lists have the same length and order for every t, as the kernel's
# loops do.

def unit_q4k(w, rows, u, t, K, q5=False):
    scw = [word(w["sc"], rows, u * 8 + 4 * i) for i in range(2)]
    mnw = [word(w["mn"], rows, u * 8 + 4 * i) for i in range(2)]
    d, dm = scalar(w["d"], rows, u), scalar(w["dmin"], rows, u)
    groups = []
    for j in range(4):
        q = [word(w["qs"], rows, u * 128 + 32 * j + 8 * t + 4 * wd) for wd in range(2)]
        h = [word(w["qh"], rows, u * 32 + 8 * t + 4 * wd) for wd in range(2)] if q5 else None
        for hn in range(2):
            g = 2 * j + hn
            mmas = []
            for wd in range(2):
                cw = (q[wd] >> (4 * hn)) & 0x0F0F0F0F
                if q5:
                    cw |= ((h[wd] >> g) & 0x01010101) << 4
                mmas.append((*pairs7(cw, 128), 256 * u + 32 * g + 8 * t + 4 * wd))
            groups.append(dict(mmas=mmas, dl=d * u8f(scw[g >> 2], g & 3),
                               ml=dm * u8f(mnw[g >> 2], g & 3)))
    return groups


def unit_q6k(w, rows, u, t, K):
    scw = [word(w["sc"], rows, u * 16 + 4 * i) for i in range(4)]
    d = scalar(w["d"], rows, u)
    groups = []
    for hh in range(2):
        for i in range(4):
            for lq in range(2):
                ql = word(w["ql"], rows, u * 128 + 64 * hh + 32 * (i & 1) + 16 * lq + 4 * t)
                qh = word(w["qh"], rows, u * 64 + 32 * hh + 16 * lq + 4 * t)
                nib = ql if i < 2 else ql >> 4
                cw = (nib & 0x0F0F0F0F) | (((qh >> (2 * i)) & 0x03030303) << 4)
                gi = 8 * hh + 2 * i + lq
                groups.append(dict(mmas=[(*pairs7(cw, 160),
                                          256 * u + 128 * hh + 32 * i + 16 * lq + 4 * t)],
                                   dl=d * s8f(scw[gi >> 2], gi & 3), ml=None))
    return groups


def unit_q23k(w, rows, u, t, K, q3=False):
    scw = [word(w["sc"], rows, u * 16 + 4 * i) for i in range(4)]
    mnw = None if q3 else [word(w["mn"], rows, u * 16 + 4 * i) for i in range(4)]
    d = scalar(w["d"], rows, u)
    dm = None if q3 else scalar(w["dmin"], rows, u)
    hm = [word(w["hmask"], rows, u * 32 + 16 * lq + 4 * t) for lq in range(2)] if q3 else None
    groups, mmas, mins = [], [[] for _ in range(4)], [[] for _ in range(4)]
    for hh in range(2):
        for j in range(4):
            for lq in range(2):
                q = word(w["qs"], rows, u * 64 + 32 * hh + 16 * lq + 4 * t)
                cw = (q >> (2 * j)) & 0x03030303
                if q3:
                    cw |= ((hm[lq] >> (4 * hh + j)) & 0x01010101) << 2
                gi = 8 * hh + 2 * j + lq
                xoff = 256 * u + 128 * hh + 32 * j + 16 * lq + 4 * t
                if q3:
                    groups.append(dict(mmas=[(*pairs7(cw, 132), xoff)],
                                       dl=d * s8f(scw[gi >> 2], gi & 3), ml=None))
                else:  # the sub-scale in the codes: fma (128 + q)·sc − 128·sc
                    sc = u8f(scw[gi >> 2], gi & 3).to(torch.bfloat16).float()[:, None]
                    e = 2 * (j & 1) + lq  # one of four sums in turn
                    mmas[e].append((*(((bf16_bits(prmt(cw, 0x43434343, sel)) * sc - 128 * sc)
                                       .to(torch.bfloat16).float()) for sel in (0x4140, 0x4342)),
                                    xoff))
                    mn = u8f(mnw[gi >> 2], gi & 3)[:, None].expand(-1, 2)
                    mins[e].append((mn, mn, xoff))
    if not q3:  # four sums a superblock: d · Σ sc·q·x, then − dmin · Σ mn·x, each
        groups = [grp for e in range(4) for grp in (dict(mmas=mmas[e], dl=d, ml=None),
                                                   dict(mmas=mins[e], dl=-dm, ml=None))]
    return groups


def unit_legacy(w, rows, u, t, K, kind):
    d = scalar(w["d"], rows, u)
    if kind == GGMLType.Q8_0:  # word t of each 16-byte half
        q = [word(w["qs"], rows, 32 * u + 16 * h + 4 * t) for h in range(2)]
        return [dict(mmas=[(*pairs8(q[h]), 32 * u + 16 * h + 4 * t) for h in range(2)],
                     dl=d, ml=None)]
    q = word(w["qs"], rows, 16 * u + 4 * t)
    lo, hi = q & 0x0F0F0F0F, (q >> 4) & 0x0F0F0F0F
    if kind in (GGMLType.Q5_0, GGMLType.Q5_1):
        h = word(w["qh"], rows, 4 * u)
        lo |= spread4(h >> (4 * t)) << 4
        hi |= spread4(h >> (16 + 4 * t)) << 4
    off = {GGMLType.Q4_0: 136, GGMLType.Q5_0: 144}.get(kind, 128)
    m = scalar(w["m"], rows, u) if kind in (GGMLType.Q4_1, GGMLType.Q5_1) else None
    return [dict(mmas=[(*pairs7(lo, off), 32 * u + 4 * t), (*pairs7(hi, off), 32 * u + 16 + 4 * t)],
                 dl=d, ml=None if m is None else -m)]


def bf16_tables(kind):
    """The kind's values as two byte tables, the low and the high byte of
    bf16(v), in the layout of the int8 table (value v in byte v % 4 of word
    v // 4), as the C entry builds them on the host."""
    words = _table_words(TGGMLType(int(kind)))
    vals = torch.tensor(np.array(words, np.uint32).view(np.int8).astype(np.float32))
    bits = vals.to(torch.bfloat16).view(torch.int16).to(torch.int64) & 0xFFFF
    tlo = [int(sum((int(bits[4 * i + j]) & 0xFF) << (8 * j) for j in range(4))) for i in range(4)]
    thi = [int(sum((int(bits[4 * i + j]) >> 8) << (8 * j) for j in range(4))) for i in range(4)]
    return tlo, thi


def lookup_bf16(tlo, thi, q4):
    """TableNib::lookup_bf16: the 8 codes of a qs word → bf16 pairs (e, e+1),
    (e+2, e+3) of the low nibbles' values, then of the high nibbles'."""
    lo_t, hi_t = ([torch.full_like(q4, v) for v in tab] for tab in (tlo, thi))
    t8 = tlo[2] == tlo[3] == thi[2] == thi[3] == 0  # at most 8 values: one prmt
    sel = 0x32103210 | ((q4 & 0x88888888) >> 1)
    lo, hi = [], []
    for i in range(2):
        idx, s2 = (q4 >> (16 * i)) & 0x7777, (sel >> (16 * i)) & 0xFFFF
        if t8:
            lo.append(prmt(lo_t[0], lo_t[1], idx))
            hi.append(prmt(hi_t[0], hi_t[1], idx))
            continue
        lo.append(prmt(prmt(lo_t[0], lo_t[1], idx), prmt(lo_t[2], lo_t[3], idx), s2))
        hi.append(prmt(prmt(hi_t[0], hi_t[1], idx), prmt(hi_t[2], hi_t[3], idx), s2))
    return [bf16_bits(prmt(lo[i], hi[i], sel2)) for sel2 in (0x6240, 0x7351) for i in range(2)]


def unit_table(w, rows, u, t, K, kind):
    G = 16 if kind == GGMLType.IQ2_S else 32
    q = word(w["qs"], rows, 16 * u + 4 * t)
    p = lookup_bf16(*bf16_tables(kind), q)
    s0 = scalar(w["d"], rows, u if G == 32 else 2 * u)
    mlo = (p[0], p[1], 32 * u + 4 * t)
    mhi = (p[2], p[3], 32 * u + 16 + 4 * t)
    if G == 32:
        return [dict(mmas=[mlo, mhi], dl=s0, ml=None)]
    s1 = scalar(w["d"], rows, 2 * u + 1)
    return [dict(mmas=[mlo], dl=s0, ml=None), dict(mmas=[mhi], dl=s1, ml=None)]


def unit_fn(kind):
    return {GGMLType.Q4_K: unit_q4k,
            GGMLType.Q5_K: functools.partial(unit_q4k, q5=True),
            GGMLType.Q6_K: unit_q6k,
            GGMLType.Q2_K: unit_q23k,
            GGMLType.Q3_K: functools.partial(unit_q23k, q3=True)}.get(
        kind, functools.partial(unit_table if kind in (
            GGMLType.IQ4_NL, GGMLType.IQ4_XS, GGMLType.IQ2_S) else unit_legacy, kind=kind))


def unit_size(kind) -> int:
    return 256 if kind in (GGMLType.Q2_K, GGMLType.Q3_K, GGMLType.Q4_K, GGMLType.Q5_K,
                           GGMLType.Q6_K) else 32


def x_fragment(xb: torch.Tensor, xoff: int):
    """Lane (g, t)'s x fragment for column g: the words of x[g, xoff..+3],
    (x_e, x_{e+1}) and (x_{e+2}, x_{e+3}), as they pair with the weight
    pairs; f32 [B, 2] each."""
    bits = xb[:, xoff:xoff + 4].view(torch.int16).to(torch.int64) & 0xFFFF
    x0 = bits[:, 0] | (bits[:, 1] << 16)
    x1 = bits[:, 2] | (bits[:, 3] << 16)
    return bf16_bits(x0), bf16_bits(x1)


def mma(a01, a23, b01, b23):
    """One k16 product of the quad's four lanes: A [R, 16] · B [16, Bn] in
    f32, k-slots (2t, 2t+1) from the 01 pairs and (2t+8, 2t+9) from the 23
    pairs of lane t."""
    A = torch.zeros(a01[0].shape[0], 16)
    Bm = torch.zeros(16, b01[0].shape[0])
    for t in range(4):
        A[:, 2 * t:2 * t + 2] = a01[t]
        A[:, 2 * t + 8:2 * t + 10] = a23[t]
        Bm[2 * t:2 * t + 2] = b01[t].T
        Bm[2 * t + 8:2 * t + 10] = b23[t].T
    return (A.double() @ Bm.double()).float(), Bm.sum(0)


@functools.lru_cache(maxsize=None)
def emulate_units(kind, b: int, k: int):
    """Per unit of K: the f32 sum over its groups of (d·sc · the group's
    product − min · Σx), [nu, B, N], from the kernel's register-level
    arithmetic over tiles of 16 rows (rows past N read row N − 1)."""
    raw, w, x = inputs(kind, b, k)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    nu = k // unit_size(kind)
    tiles = (N + 15) // 16
    rows = torch.arange(tiles * 16).clamp(max=N - 1)  # tile row i: 16·(i // 16) + i % 16
    fn = unit_fn(kind)
    out = torch.zeros(nu, b, tiles * 16)
    for u in range(nu):
        per_t = [fn(w, rows, u, t, k) for t in range(4)]
        acc = torch.zeros(tiles * 16, b)
        for gi in range(len(per_t[0])):
            groups = [p[gi] for p in per_t]
            c = torch.zeros(tiles * 16, b)
            s = torch.zeros(b)
            for mi in range(len(groups[0]["mmas"])):
                a01 = [grp["mmas"][mi][0] for grp in groups]
                a23 = [grp["mmas"][mi][1] for grp in groups]
                xf = [x_fragment(xb, grp["mmas"][mi][2]) for grp in groups]
                prod, sx = mma(a01, a23, [f[0] for f in xf], [f[1] for f in xf])
                c = c + prod
                s = s + sx
            acc = acc + groups[0]["dl"][:, None] * c
            if groups[0]["ml"] is not None:
                acc = acc - groups[0]["ml"][:, None] * s[None, :]
        out[u] = acc.T
    return out[:, :, :N]


@functools.lru_cache(maxsize=None)
def inputs(kind, b: int, k: int):
    raw = synth_raw(np.random.default_rng(int(kind) * 10 + b), TGGMLType(int(kind)), (N, k))
    w = from_gguf_tensor(raw, TGGMLType(int(kind)), (N, k))
    x = np.random.default_rng(b).standard_normal((b, k)).astype(np.float32)
    return raw, w, x


def split_k(units: torch.Tensor, slices: int, align: int) -> torch.Tensor:
    """Slice s sums its units in order: whole batches of `align` units,
    batches [nb·s/S, nb·(s+1)/S); the slices are then added in order (warps
    of a block, then ranks of a cluster)."""
    nu = units.shape[0]
    nb = -(-nu // align)
    total = torch.zeros_like(units[0])
    for s in range(slices):
        part = torch.zeros_like(units[0])
        u0, u1 = (min(nu, align * (nb * i // slices)) for i in (s, s + 1))
        for u in range(u0, u1):
            part = part + units[u]
        total = total + part
    return total


def _k(kind):
    return 352 if kind in BLOCK32 else 768


@pytest.mark.parametrize("kind", KINDS)
def test_codes_are_exact(kind):
    """Every bf16 code the kernel builds equals its integer: the exponent
    trick's 7-bit codes less the kind's offset, and the int8 nibble route
    over all 256 bytes."""
    allb = torch.arange(256, dtype=torch.int64)
    cw = allb | (allb << 8) | (allb << 16) | (allb << 24)
    p01, p23 = pairs8(cw)
    q = allb.to(torch.int8).float()
    assert torch.equal(p01[:, 0], q) and torch.equal(p23[:, 1], q)
    off = {GGMLType.Q4_0: 136, GGMLType.Q5_0: 144, GGMLType.Q6_K: 160,
           GGMLType.Q3_K: 132}.get(kind, 128)
    c7 = torch.arange(128, dtype=torch.int64)
    p01, _ = pairs7(c7 | (c7 << 8), off)
    assert torch.equal(p01[:, 0], c7.float() - (off - 128))


@pytest.mark.parametrize("kind,b,slices", [(kind, b, s) for kind in KINDS for b in (1, 3, 8)
                                           for s in (1, 3, 4)])
def test_tensor_core_gemv_algebra(kind, b, slices):
    k = _k(kind)
    raw, w, x = inputs(kind, b, k)
    align = 1 if unit_size(kind) == 256 else 4 if kind == GGMLType.Q8_0 else 8
    got = split_k(emulate_units(kind, b, k), slices, align).numpy()
    xr = torch.from_numpy(x).to(torch.bfloat16).double().numpy()
    exact = xr @ dequantize(raw, kind).reshape(N, k).astype(np.float64).T
    assert got.shape == (b, N) and np.isfinite(got).all()
    assert nmse(got, exact) <= F64_TOL
    if slices == 1:
        kw = to_kernel_layout(jax_from_gguf_tensor(raw, kind, (N, k)))
        want = np.asarray(qmm_fused(jnp.asarray(x), kw))
        assert nmse(got, want) <= JAX_TOL
