"""The arithmetic of the port's ``conv1d_bwd_weight`` kernel, on the CPU.

``csrc/conv1d_bwd_weight.cu`` runs the fp32 weight gradient on Hopper's
TF32 tensor cores in three terms: each operand v is split into hi =
tf32(v) and lo = tf32(v - hi) (round to nearest, ties away from zero, 13
low bits cleared), and every k-step of 8 columns adds lo.hi, hi.lo and
hi.hi, in that order, to an fp32 accumulator.  bf16 inputs are exact in
tf32, so they take hi.hi alone.  The sums are split into fixed column
ranges (one block of the grid each, a contiguous range of the list of
(sample, column tile)), warpgroups that split a tile's k-steps add theirs
in warpgroup order, and a second pass adds the blocks' rows in order.

The card is not reachable here, so a numpy emulation of that arithmetic
stands in for it: each wgmma as an exact (float64) 8-term dot product
added to the float32 accumulator, the kernel's two bodies and their
tilings (the taps body for K > 1 with d % 4 == 0 and for K == 1; the unit
body for the rest, the stem among them) and the fixed-order second pass.
At AtacWorks widths (C = K = 15, S = 51, dilation 8; N = 2, Q = 2,048;
inputs from a seed) it is held

  * within 1e-4 of the largest value (``chip_smoke.py``'s ``BWD_TOL``) of
    JAX's ``conv1d_bwd_weight`` (its Pallas kernel in interpret mode, as
    the JAX package's tests run it), dw and dbias, for the 15->15 layer,
    the stem (C = 1) and a head (K = 1);
  * to miss that bound with one term (hi.hi), so that no later change
    drops the small terms unnoticed.  This emulates the rounding of each
    product's operands, not the tensor core's own accumulation inside a
    wgmma, so it shows that one term misses in the emulation; the card's
    one-term reading is ``chip_smoke.py``'s phase 4 on a one-term build;
  * bitwise equal, one term and three, on bf16 inputs;
  * bitwise equal across two runs, and across column ranges of one and of
    several tiles a block only to rounding.
"""
from __future__ import annotations

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from repro.kernels import conv1d_brgemm as jbrgemm

KERNEL = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
          / "kernels" / "csrc" / "conv1d_bwd_weight.cu")
S, DIL = 51, 8     # AtacWorks taps and dilation
N, Q = 2, 2048     # Q a multiple of JAX's 256-column tile
SPAN = (S - 1) * DIL
TOL = 1e-4         # chip_smoke.py's BWD_TOL["float32"], of max|plain|
# the kernel's constants (test_emulation_mirrors_the_kernel reads them)
TQ = 384           # columns a tile (the first of TQS; these shapes fit)
KSTEP = 8          # columns of one wgmma (k8, tf32)
TT = 13            # taps body, K > 1: taps a group
TR = 64            # taps body, K == 1: taps
TAPS, UNITS_PER_WG = 3, 64  # unit body: a unit's taps; units that k-split
NWG, TCONS = 4, 2  # unit body warpgroups; taps body consumers
SMS = 132          # the H100's SMs: column ranges of the grid

SHAPES = {"conv": (15, 15), "stem": (1, 15), "head": (15, 1)}


def _operands(C, K, seed=0, bf16=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, C, Q + SPAN)).astype(np.float32)
    g = rng.standard_normal((N, K, Q)).astype(np.float32)
    if bf16:  # bf16 values held in float32
        x, g = (_to_bf16(a) for a in (x, g))
    return x, g


def _to_bf16(a):
    u = a.astype(np.float32).view(np.uint32)
    u = (u + np.uint32(0x7FFF) + ((u >> 16) & 1)) & np.uint32(0xFFFF0000)
    return u.view(np.float32)


def tf32_rna(a):
    """float32 -> tf32 held in float32: 10 mantissa bits, to nearest, ties
    away from zero (the 13 low bits cleared): ``tf32_rna`` of the kernel,
    cvt.rna.tf32.f32's rule."""
    u = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(a):
    """v -> (hi, lo): hi = tf32(v), lo = tf32(v - hi)."""
    hi = tf32_rna(a)
    return hi, tf32_rna(a - hi)


def _plan(C, K):
    """The kernel's body and its geometry (``make_plan``, ``geometry``)."""
    if (K == 1 and S <= TR) or (K > 1 and C > 1 and DIL % 4 == 0):
        lag = (S - 1) * DIL if K == 1 else (TT - 1) * DIL
        return dict(body="taps", lag=lag, groups=-(-S // TT),
                    shares=TCONS if K == 1 else 1)
    units = C * -(-S // TAPS) + 1  # with the ones unit (dbias)
    return dict(body="unit", lag=0,
                shares=NWG if units <= UNITS_PER_WG else 1)


def _shift(a, off, cols):
    """a[..., off : off + cols] with zeros outside a's columns."""
    out = np.zeros(a.shape[:-1] + (cols,), np.float32)
    lo, hi = max(off, 0), min(off + cols, a.shape[-1])
    if hi > lo:
        out[..., lo - off:hi - off] = a[..., lo:hi]
    return out


def _tile(plan, x, g, n, v0):
    """The GEMM of one tile as the kernel lays it out: A (M, TQ) from the
    input (its last row the ones that sum dbias), B (TQ, Ncols) from the
    cotangent, and where D's entries go: (dw index (s, k, c) or dbias k)."""
    C, K = x.shape[1], g.shape[1]
    if plan["body"] == "unit":  # rows (s, c), columns k
        A = np.stack([_shift(x[n, :, :], v0 + s * DIL, TQ)
                      for s in range(S)]).reshape(S * C, TQ)
        B = _shift(g[n], v0, TQ).T
        dmap = ("unit", C, K)
    elif K == 1:  # rows c, columns n' = tap S-1-n'
        A = _shift(x[n], v0, TQ)
        B = np.stack([_shift(g[n, 0], v0 - (S - 1 - t) * DIL, TQ)
                      for t in range(S)]).T
        dmap = ("rep", C, K)
    else:  # rows (j, c), columns (G, k): tap TT-1-G + TT j
        A = np.concatenate([_shift(x[n], v0 + TT * j * DIL, TQ)
                            for j in range(plan["groups"])])
        B = np.stack([_shift(g[n], v0 - (TT - 1 - G) * DIL, TQ)
                      for G in range(TT)]).reshape(TT * K, TQ).T
        dmap = ("filters", C, K, plan["groups"])
    A = np.concatenate([A, np.ones((1, TQ), np.float32)])
    return A, B, dmap


def _scatter(D, dmap):
    """(dw (S, K, C), dbias (K,)) from one D."""
    dw = np.zeros((S, dmap[2], dmap[1]), np.float32)
    if dmap[0] == "unit":
        _, C, K = dmap
        dw[:] = D[:-1].reshape(S, C, K).transpose(0, 2, 1)
        return dw, D[-1].copy()
    if dmap[0] == "rep":
        _, C, K = dmap
        dw[:, 0, :] = D[:-1, ::-1].T
        return dw, D[-1, S - 1:S].copy()
    _, C, K, groups = dmap
    Dr = D[:-1].reshape(groups, C, TT, K)
    for j in range(groups):
        for G in range(TT):
            s = TT - 1 - G + TT * j
            if s < S:
                dw[s] = Dr[j, :, G, :].T
    return dw, D[-1].reshape(TT, K)[TT - 1].copy()


def _step(acc, A, B, one_term):
    """One k-step of wgmmas: each product an exact 8-term dot product
    (float64) added to the float32 accumulator; lo.hi, hi.lo, hi.hi."""
    ah, al = split(A)
    bh, bl = split(B)
    terms = [(ah, bh)] if one_term else [(al, bh), (ah, bl), (ah, bh)]
    for a, b in terms:
        acc = (acc.astype(np.float64)
               + a.astype(np.float64) @ b.astype(np.float64)
               ).astype(np.float32)
    return acc


def emulate(x, g, one_term=False, sms=SMS):
    """(dw, dbias) as conv1d_bwd_weight.cu sums them with ``sms`` column
    ranges."""
    C, K = x.shape[1], g.shape[1]
    plan = _plan(C, K)
    ntiles = -(-(Q + plan["lag"]) // TQ)
    tiles = N * ntiles
    parts = min(sms, tiles)
    steps = TQ // KSTEP
    shares = plan["shares"]
    rows = []
    for p in range(parts):
        acc = None
        for t in range(p * tiles // parts, (p + 1) * tiles // parts):
            A, B, dmap = _tile(plan, x, g, t // ntiles, t % ntiles * TQ)
            if acc is None:
                acc = [np.zeros((A.shape[0], B.shape[1]), np.float32)
                       for _ in range(shares)]
            for w in range(shares):  # warpgroup w's share of the steps
                for kk in range(w * steps // shares,
                                (w + 1) * steps // shares):
                    cols = slice(kk * KSTEP, (kk + 1) * KSTEP)
                    acc[w] = _step(acc[w], A[:, cols], B[cols], one_term)
        D = acc[0]
        for w in range(1, shares):  # the shares in warpgroup order
            D = (D + acc[w]).astype(np.float32)
        dw, db = _scatter(D, dmap)
        rows.append(np.concatenate([dw.ravel(), db]))
    total = np.zeros_like(rows[0])
    for r in rows:  # reduce_partials: rows 0..P-1 in order
        total = (total + r).astype(np.float32)
    n_dw = S * K * C
    return total[:n_dw].reshape(S, K, C), total[n_dw:]


def _jax(x, g):
    dw, db = jbrgemm.conv1d_bwd_weight(jnp.asarray(x), jnp.asarray(g), S=S,
                                       dilation=DIL, wblk=256,
                                       with_dbias=True, interpret=True)
    return np.asarray(dw), np.asarray(db)


def _rel_err(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("layer", sorted(SHAPES))
def test_three_terms_match_jax(layer):
    """dw and dbias of the emulated kernel within TOL of JAX's Pallas
    conv1d_bwd_weight (interpret mode), each against its largest value."""
    x, g = _operands(*SHAPES[layer], seed=1)
    dw, db = emulate(x, g)
    want_dw, want_db = _jax(x, g)
    assert _rel_err(dw, want_dw) <= TOL
    assert _rel_err(db, want_db) <= TOL


def test_one_term_misses_the_bound():
    """hi.hi alone carries about 2^-11 of each product: the 15->15 layer's
    dw then misses TOL in this emulation, which is why the kernel takes
    three terms."""
    x, g = _operands(15, 15, seed=2)
    want_dw, _ = _jax(x, g)
    one, _ = emulate(x, g, one_term=True)
    three, _ = emulate(x, g)
    assert _rel_err(one, want_dw) > TOL
    assert _rel_err(three, want_dw) <= TOL / 10


def test_bf16_one_term_equals_three():
    """bf16 values are exact in tf32 (lo = 0), so the kernel's one term on
    bf16 gives what three would, bit for bit."""
    x, g = _operands(16, 16, seed=3, bf16=True)
    one = emulate(x, g, one_term=True)
    three = emulate(x, g)
    np.testing.assert_array_equal(one[0], three[0])
    np.testing.assert_array_equal(one[1], three[1])


@pytest.mark.parametrize("layer", ["conv", "stem"])
def test_fixed_order(layer):
    """Two runs are bitwise equal; column ranges of several tiles each (5
    blocks) agree with one tile a block to rounding."""
    x, g = _operands(*SHAPES[layer], seed=4)
    a, b = emulate(x, g), emulate(x, g)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    few = emulate(x, g, sms=5)
    assert _rel_err(few[0], a[0]) <= TOL / 10


def test_tf32_rounding():
    """tf32_rna: to nearest with ties away from zero, 13 bits cleared."""
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)
    vals = np.array([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 2 ** -12,
                     1 + 3 * 2 ** -11], np.float32)
    np.testing.assert_array_equal(
        tf32_rna(vals),
        np.array([one + ulp, -(one + ulp), one, one + 2 * ulp], np.float32))
    v = np.random.default_rng(5).standard_normal(1000).astype(np.float32)
    hi, lo = split(v)
    assert not (hi.view(np.uint32) & 0x1FFF).any()
    assert not (lo.view(np.uint32) & 0x1FFF).any()
    assert np.abs((hi.astype(np.float64) + lo) - v).max() <= (
        2.0 ** -22 * np.abs(v).max())


def test_emulation_mirrors_the_kernel():
    """The constants and the order of terms the emulation copies from
    conv1d_bwd_weight.cu."""
    src = KERNEL.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])

    assert int(re.search(r"TQS\[\] = \{(\d+)", src)[1]) == TQ
    assert (const("KSTEP"), const("TT"), const("TR"), const("TAPS"),
            const("NWG"), const("TCONS")) == (KSTEP, TT, TR, TAPS, NWG,
                                              TCONS)
    assert "UNITS / NWG" in src and const("NWG") * 32 * 2 // NWG == (
        UNITS_PER_WG)
    assert "(__float_as_uint(v) + 0x1000u) & 0xFFFFE000u" in src
    body = src[src.index("void terms("):src.index("// wgmma's descriptor")]
    assert re.findall(r"wgmma_tf32\(d, (\w+), (\w+)\)", body) == [
        ("al", "bh"), ("ah", "bl"), ("ah", "bh")]
