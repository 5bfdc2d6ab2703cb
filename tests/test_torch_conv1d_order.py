"""The summation order of the port's ``conv1d_fwd`` kernel, on the CPU.

``csrc/conv1d_fwd.cu`` sums every output element in one fixed order:
channels c = 0..C-1, inside a channel taps s = 0..S-1, one ``fmaf`` each
into an fp32 accumulator that starts at 0, then the epilogue.  The order
does not depend on the register tile a launch takes (J columns spaced d
apart x KT filters a thread), on the block width, on Q or on N.  The
server's bitwise gate rests on it (``chip_smoke.py`` phase 3: every served
stream equals the one-shot causal forward), since a stream step and a
one-shot pass take different tiles.

The card is not reachable here, so a numpy emulation of the kernel's body
stands in for it: its column-tile geometry (groups of d threads, each
covering J*d columns), its window of J inputs rotating through registers
one tap at a time, its filter tiles padded with zero weights, and fmaf
(emulated in float64, where a float32 product is exact, then rounded to
float32).  At AtacWorks widths (C = K = 15, S = 51, dilation 8, width
2,048 + span, inputs from a seed) it is held

  * bitwise across tiles and block widths;
  * bitwise between a stream of steps over ``state ++ chunk`` and one pass
    over the whole causal input;
  * within atol = rtol = 1e-4 (``chip_smoke.py``'s fp32 ``TOL``) of JAX's
    ``conv1d_fwd``: its Pallas kernel in interpret mode, as the JAX
    package's tests run it.
"""
from __future__ import annotations

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from repro.kernels import conv1d_brgemm as jbrgemm

KERNEL = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
          / "kernels" / "csrc" / "conv1d_fwd.cu")
BLOCK = 128        # conv1d_fwd.cu's threads a block
C = K = 15         # AtacWorks widths
S, DIL = 51, 8
N, Q = 2, 2048     # Q a multiple of JAX's 256-column tile
SPAN = (S - 1) * DIL
TOL = dict(atol=1e-4, rtol=1e-4)


def _operands(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, C, Q + SPAN)).astype(np.float32)
    w = (rng.standard_normal((S, K, C)) / np.sqrt(C * S)).astype(np.float32)
    b = (0.1 * rng.standard_normal(K)).astype(np.float32)
    return x, w, b


def _geometry(J, d, block):
    """conv1d_fwd.cu's ``geometry``: (columns a block, threads that own
    columns, each such thread's first column in the tile)."""
    t = np.arange(block)
    if J == 1:
        return block, t
    groups = block // d
    t = t[:groups * d]
    return groups * J * d, (t // d) * J * d + t % d


def _fma(a, b, c):
    """float32 fmaf, up to the rare double rounding (the product of two
    float32 values is exact in float64)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def emulate(x, w, bias, d, J, KT, block=BLOCK):
    """``relu(conv + bias)`` (N, K, Q) as conv1d_fwd's body computes it with
    the tile (J, KT) and ``block`` threads a block."""
    n, c_in, wp = x.shape
    s_taps, k_out, _ = w.shape
    q = wp - (s_taps - 1) * d
    tq, ql = _geometry(J, d, block)
    tiles = -(-q // tq)
    first = (np.arange(tiles)[:, None] * tq + ql[None, :]).ravel()
    # the staged footprint reads zeros past the row's end
    xz = np.concatenate([x, np.zeros((n, c_in, tiles * tq + J * d),
                                     np.float32)], axis=-1)
    out = np.zeros((n, k_out, q), np.float32)
    written = np.zeros((k_out, q), np.int64)
    for k0 in range(0, k_out, KT):
        kk = min(KT, k_out - k0)
        wk = np.zeros((s_taps, KT, c_in), np.float32)  # zeros past K
        wk[:, :kk] = w[:, k0:k0 + kk]
        acc = np.zeros((n, first.size, J, KT), np.float32)
        for c in range(c_in):
            def load(m):  # input m of every thread: column q + m*d
                return xz[:, c, first + m * d]

            def tap(s, u):
                for j in range(J):
                    acc[:, :, j] = _fma(wk[s, :, c][None, None, :],
                                        buf[(u + j) % J][:, :, None],
                                        acc[:, :, j])

            buf = [load(u) for u in range(J - 1)] + [None]
            s = 0
            while s + J <= s_taps:
                for u in range(J):
                    buf[(u + J - 1) % J] = load(s + u + J - 1)
                    tap(s + u, u)
                s += J
            for u in range(s_taps - s):  # the last S % J taps
                buf[(u + J - 1) % J] = load(s + u + J - 1)
                tap(s + u, u)
        for j in range(J):
            cols = first + j * d
            keep = cols < q
            for k in range(kk):
                u_ = acc[:, keep, j, k] + bias[k0 + k]
                out[:, k0 + k, cols[keep]] = np.maximum(u_, np.float32(0))
                written[k0 + k, cols[keep]] += 1
    assert (written == 1).all(), "the tiles must cover each output once"
    return out


# (J, KT, block) pairs: the training layer's tile against the stream
# step's, the one-shot pass's at a narrower block, and the heads' scheme
TILE_PAIRS = [((6, 16, BLOCK), (2, 4, BLOCK)),
              ((6, 16, BLOCK), (4, 8, 64)),
              ((1, 4, BLOCK), (16, 1, BLOCK))]


@pytest.mark.parametrize("a,b", TILE_PAIRS,
                         ids=lambda t: "J{}KT{}B{}".format(*t))
def test_tiles_sum_in_one_order(a, b):
    x, w, bias = _operands()
    np.testing.assert_array_equal(emulate(x, w, bias, DIL, *a),
                                  emulate(x, w, bias, DIL, *b))


def test_stream_steps_equal_one_pass():
    """Chunks of 512 over ``state ++ chunk`` (the stream step's tile, J=2
    KT=4, on a VALID pass of span + 512 columns) give the one-shot causal
    pass's columns (J=4 KT=8 over span + 2,048 columns) bitwise."""
    x, w, bias = _operands(1)
    track = x[:, :, SPAN:]  # (N, C, 2048) new columns
    causal = np.concatenate([np.zeros((N, C, SPAN), np.float32), track], -1)
    one = emulate(causal, w, bias, DIL, 4, 8)
    state = np.zeros((N, C, SPAN), np.float32)
    steps = []
    for q0 in range(0, Q, 512):
        xc = np.concatenate([state, track[:, :, q0:q0 + 512]], -1)
        steps.append(emulate(xc, w, bias, DIL, 2, 4))
        state = xc[:, :, -SPAN:]
    np.testing.assert_array_equal(np.concatenate(steps, -1), one)


def test_emulation_matches_jax_conv1d_fwd():
    """The emulated body against JAX's Pallas conv1d_fwd (interpret mode),
    bias + relu on the fp32 accumulator."""
    x, w, bias = _operands(2)
    want = jbrgemm.conv1d_fwd(jnp.asarray(x), jnp.asarray(w),
                              bias=jnp.asarray(bias), activation="relu",
                              dilation=DIL, wblk=256, interpret=True)
    got = emulate(x, w, bias, DIL, 6, 16)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_emulation_mirrors_the_kernel():
    """The constants the emulation copies from conv1d_fwd.cu: the block
    width, and the tiles it takes (each emulated tile is one the kernel
    may launch)."""
    src = KERNEL.read_text()
    assert int(re.search(r"constexpr int BLOCK = (\d+);", src)[1]) == BLOCK
    tiles = {(int(j), int(kt)) for j, kt in
             re.findall(r"\{(\d+), (\d+)\}", src[src.index("WIDE[]"):
                                                src.index("fits(")])}
    used = {t[:2] for pair in TILE_PAIRS for t in pair} | {(4, 8), (2, 4)}
    assert used <= tiles, used - tiles
