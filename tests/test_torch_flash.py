"""The port's flash attention (``repro_torch.kernels.flash_attention``) and
its plain attention (``models.common.gqa_attention``) against the JAX
package, on the CPU.

On a CPU tensor ``flash_fwd`` and ``flash_bwd`` compute their plain
versions (``ref.flash_fwd_ref``, ``ref.flash_bwd_ref``), and
``FlashAttentionFunction`` joins them as the JAX ``custom_vjp`` does; the
JAX side runs its Pallas kernels in interpret mode.  The inputs are made
with numpy from a seed and handed to both.

Tolerances are JAX's own in ``tests/test_flash_attention.py``: 2e-5 for
fp32 outputs and lse (sums in another order), 2e-4 for fp32 gradients
(longer chains of such sums), 2e-2 for bf16 outputs (one bf16 rounding,
2^-8 relative, of values up to a few units).
"""
from __future__ import annotations

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels import flash_attention as jfa
from repro.models import common as jcm
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref
from repro_torch.models import common as cm

FWD_TOL, GRAD_TOL, BF16_TOL = 2e-5, 2e-4, 2e-2

# tests/test_flash_attention.py's SWEEP: (B, Tq, Tk, KV, G, hd, causal)
SWEEP = [
    (1, 64, 64, 2, 4, 16, True),
    (2, 128, 128, 1, 8, 32, True),
    (1, 64, 64, 4, 1, 64, True),
    (2, 64, 64, 2, 2, 16, False),
]


def _inputs(B, Tq, Tk, KV, G, hd, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Tq, KV, G, hd)).astype(np.float32)
    k = rng.standard_normal((B, Tk, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, Tk, KV, hd)).astype(np.float32)
    cot = rng.standard_normal((B, Tq, KV, G, hd)).astype(np.float32)
    return q, k, v, cot


def _jax(a, dtype=jnp.float32):
    return jnp.asarray(a, dtype)


def _torch(a, dtype=torch.float32):
    return torch.from_numpy(a).to(dtype)


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=what)


@pytest.mark.parametrize("B,Tq,Tk,KV,G,hd,causal", SWEEP)
def test_fwd_and_lse_match_jax(B, Tq, Tk, KV, G, hd, causal):
    q, k, v, _ = _inputs(B, Tq, Tk, KV, G, hd)
    jo, jlse = jfa.flash_fwd(_jax(q), _jax(k), _jax(v), causal=causal,
                             bq=32, interpret=True)
    before = fa.flash_fwd.launches
    o, lse = fa.flash_fwd(_torch(q), _torch(k), _torch(v), causal=causal,
                          bq=32)
    assert fa.flash_fwd.launches == before  # a CPU tensor takes the plain
    assert o.shape == (B, Tq, KV, G, hd) and o.dtype == torch.float32
    assert lse.shape == (B, Tq, KV, G) and lse.dtype == torch.float32
    _close(o, jo, FWD_TOL, "o")
    _close(lse, jlse, FWD_TOL, "lse")


@pytest.mark.parametrize("B,Tq,Tk,KV,G,hd,causal", SWEEP)
def test_grads_match_jax(B, Tq, Tk, KV, G, hd, causal):
    """``FlashAttentionFunction`` (forward and ``flash_bwd``) against
    ``jax.grad`` through the JAX ``custom_vjp`` and its Pallas backward."""
    q, k, v, cot = _inputs(B, Tq, Tk, KV, G, hd, seed=1)

    def jloss(q, k, v):
        return jnp.vdot(jfa.flash_attention(q, k, v, causal, 32, True),
                        _jax(cot))

    jg = jax.grad(jloss, argnums=(0, 1, 2))(_jax(q), _jax(k), _jax(v))
    tq, tk, tv = (_torch(a).requires_grad_() for a in (q, k, v))
    before = fa.flash_bwd.launches
    (fa.flash_attention(tq, tk, tv, causal, 32) * _torch(cot)).sum().backward()
    assert fa.flash_bwd.launches == before
    for t, want, name in zip((tq, tk, tv), jg, "qkv"):
        assert t.grad.shape == t.shape
        _close(t.grad, want, GRAD_TOL, f"d{name}")


def test_bwd_ref_matches_jax_flash_bwd():
    """``flash_bwd`` on its own, from JAX's o and lse, against JAX's
    ``flash_bwd``: delta from the stored o, dk and dv summed over G."""
    q, k, v, cot = _inputs(2, 64, 64, 2, 3, 16, seed=2)
    jq, jk, jv = _jax(q), _jax(k), _jax(v)
    jo, jlse = jfa.flash_fwd(jq, jk, jv, causal=True, bq=32, interpret=True)
    want = jfa.flash_bwd(jq, jk, jv, jo, jlse, _jax(cot), causal=True, bq=32,
                         bk=32, interpret=True)
    got = fa.flash_bwd(_torch(q), _torch(k), _torch(v),
                       torch.from_numpy(np.array(jo)),
                       torch.from_numpy(np.array(jlse)), _torch(cot),
                       causal=True)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        _close(g, w, GRAD_TOL, name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fwd_dtypes_match_jax(dtype):
    q, k, v, _ = _inputs(1, 64, 64, 2, 2, 32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jo, _ = jfa.flash_fwd(_jax(q, jdt), _jax(k, jdt), _jax(v, jdt),
                          causal=True, bq=32, interpret=True)
    o, lse = fa.flash_fwd(_torch(q, tdt), _torch(k, tdt), _torch(v, tdt),
                          causal=True, bq=32)
    assert o.dtype == tdt and lse.dtype == torch.float32
    _close(o.float(), np.asarray(jo, np.float32),
           BF16_TOL if dtype == "bfloat16" else FWD_TOL)


def test_bf16_grads_match_jax():
    q, k, v, cot = _inputs(1, 64, 64, 2, 4, 16, seed=3)
    bf = jnp.bfloat16

    def jloss(q, k, v):
        o = jfa.flash_attention(q, k, v, True, 32, True)
        return jnp.vdot(o.astype(jnp.float32), _jax(cot))

    jg = jax.grad(jloss, argnums=(0, 1, 2))(_jax(q, bf), _jax(k, bf),
                                             _jax(v, bf))
    tq, tk, tv = (_torch(a, torch.bfloat16).requires_grad_()
                  for a in (q, k, v))
    (fa.flash_attention(tq, tk, tv, True, 32).float()
     * _torch(cot)).sum().backward()
    for t, want, name in zip((tq, tk, tv), jg, "qkv"):
        assert t.grad.dtype == torch.bfloat16
        _close(t.grad.float(), np.asarray(want, np.float32), BF16_TOL,
               f"d{name}")


def test_lse_is_logsumexp():
    q, k, v, _ = _inputs(1, 32, 32, 1, 2, 16)
    _, lse = fa.flash_fwd(_torch(q), _torch(k), _torch(v), causal=False)
    s = torch.einsum("bqkgh,bskh->bqkgs", _torch(q) * 16 ** -0.5, _torch(k))
    _close(lse, torch.logsumexp(s, dim=-1), FWD_TOL)


def test_causal_output_ignores_future_keys():
    """Changing keys and values after position t leaves rows <= t as they
    were, bitwise; the gradient of an early row reaches no later key."""
    q, k, v, _ = _inputs(1, 48, 48, 2, 3, 16, seed=4)
    o1, _ = fa.flash_fwd(_torch(q), _torch(k), _torch(v), causal=True)
    k2, v2 = k.copy(), v.copy()
    k2[:, 20:] += 3.0
    v2[:, 20:] -= 2.0
    o2, _ = fa.flash_fwd(_torch(q), _torch(k2), _torch(v2), causal=True)
    assert torch.equal(o1[:, :20], o2[:, :20])
    assert not torch.equal(o1[:, 20:], o2[:, 20:])
    tk = _torch(k).requires_grad_()
    tv = _torch(v).requires_grad_()
    fa.flash_attention(_torch(q), tk, tv, True)[:, :10].sum().backward()
    assert not tk.grad[:, 10:].any() and not tv.grad[:, 10:].any()
    assert tv.grad[:, :10].abs().sum() > 0


@pytest.mark.parametrize("q_offset", [0, 32, 64])
def test_q_offset_matches_jax(q_offset):
    """Queries placed at ``q_offset + t`` over a longer key row (a later
    query block), as JAX's ``flash_fwd`` places them."""
    q, k, v, _ = _inputs(1, 32, 96, 2, 2, 16, seed=5)
    jo, jlse = jfa.flash_fwd(_jax(q), _jax(k), _jax(v), causal=True, bq=32,
                             q_offset=q_offset, interpret=True)
    o, lse = fa.flash_fwd(_torch(q), _torch(k), _torch(v), causal=True,
                          bq=32, q_offset=q_offset)
    _close(o, jo, FWD_TOL, "o")
    _close(lse, jlse, FWD_TOL, "lse")


def test_q_offset_off_the_tile_raises():
    """JAX floors ``q_offset`` to a multiple of ``bq``; the port refuses an
    offset where the two meanings part."""
    q, k, v, _ = _inputs(1, 32, 64, 1, 2, 16)
    with pytest.raises(ValueError, match="multiple of the query tile"):
        fa.flash_fwd(_torch(q), _torch(k), _torch(v), bq=32, q_offset=16)


def test_ragged_length_matches_the_plain_attention():
    """A length that no tile divides (the JAX kernel asserts Tq % bq == 0,
    so JAX's plain attention is the reference): forward and gradients."""
    B, T, KV, G, hd = 2, 50, 2, 3, 16
    q, k, v, cot = _inputs(B, T, T, KV, G, hd, seed=6)

    def jloss(q, k, v):
        o = jcm.gqa_attention(q.reshape(B, T, KV * G, hd), k, v, causal=True)
        return jnp.vdot(o.reshape(q.shape), _jax(cot)), o

    (_, jo), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        _jax(q), _jax(k), _jax(v))
    tq, tk, tv = (_torch(a).requires_grad_() for a in (q, k, v))
    o = fa.flash_attention(tq, tk, tv, True, 256)
    (o * _torch(cot)).sum().backward()
    _close(o.detach().reshape(B, T, KV * G, hd), jo, FWD_TOL, "o")
    for t, want, name in zip((tq, tk, tv), jg, "qkv"):
        _close(t.grad, want, GRAD_TOL, f"d{name}")


def test_strided_views_read_as_the_model_lays_them_out():
    """q as the model makes it, a (B, T, KV, G, hd) view of (B, T, H, hd),
    and k, v as strided slices of one packed tensor, give what contiguous
    copies give."""
    rng = np.random.default_rng(7)
    B, T, KV, G, hd = 1, 24, 2, 2, 16
    q = torch.from_numpy(rng.standard_normal((B, T, KV * G, hd))).float()
    kv = torch.from_numpy(rng.standard_normal((B, T, KV, 2, hd))).float()
    k, v = kv[:, :, :, 0], kv[:, :, :, 1]
    assert not k.is_contiguous()
    qg = q.view(B, T, KV, G, hd)
    o, lse = fa.flash_fwd(qg, k, v)
    o2, lse2 = fa.flash_fwd(qg.contiguous(), k.contiguous(), v.contiguous())
    assert torch.equal(o, o2) and torch.equal(lse, lse2)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    q, k, v, _ = _inputs(1, 16, 16, 2, 2, 16)
    tq, tk, tv = _torch(q), _torch(k), _torch(v)
    with pytest.raises(ValueError, match="shape"):
        fa.flash_fwd(tq, tk[:, :, :1], tv)
    with pytest.raises(ValueError, match="dtype"):
        fa.flash_fwd(tq, tk.double(), tv)
    with pytest.raises(ValueError, match="fp32/bf16"):
        fa.flash_fwd(tq.half(), tk.half(), tv.half())
    with pytest.raises(ValueError, match="last dimension"):
        fa.flash_fwd(tq, tk.transpose(1, 3).contiguous().transpose(1, 3), tv)
    with pytest.raises(ValueError, match=r"\(B, Tq, KV, G, hd\)"):
        fa.flash_fwd(tq[0], tk, tv)
    o, lse = fa.flash_fwd(tq, tk, tv)
    with pytest.raises(ValueError, match="lse"):
        fa.flash_bwd(tq, tk, tv, o, lse[..., :1], o)
    with pytest.raises(ValueError, match="do has dtype"):
        fa.flash_bwd(tq, tk, tv, o, lse, o.double())
    # on the card every row must start 16-byte aligned (the bf16 kernels'
    # cp.async of 8 elements): strides that are multiples of 8 bf16 or 4
    # fp32 elements, and an aligned start.  _check_cuda reads only the
    # strides and the pointer, so CPU tensors stand in.
    def rows(pitch, dtype):  # (1, 16, 2, 2, 16) with rows `pitch` apart
        return torch.zeros(1, 16, 2, 2, pitch, dtype=dtype)[..., :16]

    fa._check_cuda("q", rows(20, torch.float32))    # 80 bytes: taken
    fa._check_cuda("q", rows(24, torch.bfloat16))   # 48 bytes: taken
    with pytest.raises(ValueError, match="multiples of 8 elements"):
        fa._check_cuda("q", rows(20, torch.bfloat16))  # 40 bytes
    shifted = torch.zeros(1 + 16 * 2 * 16, dtype=torch.bfloat16)[1:]
    with pytest.raises(ValueError, match="16-byte aligned start"):
        fa._check_cuda("k", shifted.view(1, 16, 2, 16))


@pytest.mark.parametrize("chunk,kv_len", [(0, None), (16, None), (0, 40),
                                          (16, 40)],
                         ids=["unchunked", "chunked", "kv_len",
                              "chunked+kv_len"])
def test_gqa_attention_matches_jax(chunk, kv_len):
    """The plain (``attn_impl="chunked"``) attention against the JAX
    package's, in fp32 and bf16."""
    B, T, KV, G, hd = 2, 64, 2, 3, 16
    q, k, v, _ = _inputs(B, T, T, KV, G, hd, seed=8)
    q = q.reshape(B, T, KV * G, hd)
    for jdt, tdt, tol in ((jnp.float32, torch.float32, FWD_TOL),
                          (jnp.bfloat16, torch.bfloat16, BF16_TOL)):
        want = jcm.gqa_attention(_jax(q, jdt), _jax(k, jdt), _jax(v, jdt),
                                 causal=True, chunk=chunk, kv_len=kv_len)
        got = cm.gqa_attention(_torch(q, tdt), _torch(k, tdt),
                               _torch(v, tdt), causal=True, chunk=chunk,
                               kv_len=kv_len)
        assert got.shape == (B, T, KV * G, hd) and got.dtype == tdt
        _close(got.float(), np.asarray(want, np.float32), tol, str(tdt))


def test_gqa_attention_gradients_match_jax():
    B, T, KV, G, hd = 1, 64, 2, 2, 16
    q, k, v, _ = _inputs(B, T, T, KV, G, hd, seed=9)
    q = q.reshape(B, T, KV * G, hd)
    cot = np.random.default_rng(10).standard_normal(q.shape).astype(
        np.float32)

    def jloss(q, k, v):
        return jnp.vdot(jcm.gqa_attention(q, k, v, causal=True, chunk=16),
                        _jax(cot))

    jg = jax.grad(jloss, argnums=(0, 1, 2))(_jax(q), _jax(k), _jax(v))
    tq, tk, tv = (_torch(a).requires_grad_() for a in (q, k, v))
    (cm.gqa_attention(tq, tk, tv, causal=True, chunk=16)
     * _torch(cot)).sum().backward()
    for t, want, name in zip((tq, tk, tv), jg, "qkv"):
        _close(t.grad, want, GRAD_TOL, f"d{name}")


def test_flash_and_plain_attention_agree():
    """The two ``attn_impl`` paths of the port on the model's layout."""
    B, T, KV, G, hd = 2, 40, 2, 4, 16
    q, k, v, _ = _inputs(B, T, T, KV, G, hd, seed=11)
    tq = _torch(q).reshape(B, T, KV * G, hd)
    cfg = type("Cfg", (), {"attn_chunk": 16})()
    got = cm.flash_or_phantom(tq, _torch(k), _torch(v), cfg, causal=True)
    want = cm.gqa_attention(tq, _torch(k), _torch(v), causal=True)
    _close(got, want, FWD_TOL)


def test_delta_is_taken_from_the_stored_output():
    """``flash_delta`` reads o in its own dtype (bf16 here), as JAX's
    wrapper does, not an fp32 o."""
    rng = np.random.default_rng(12)
    o = torch.from_numpy(rng.standard_normal((1, 4, 1, 2, 8))).to(
        torch.bfloat16)
    do = torch.from_numpy(rng.standard_normal((1, 4, 1, 2, 8))).to(
        torch.bfloat16)
    want = jnp.einsum("bqkgh,bqkgh->bqkg",
                      jnp.asarray(do.float().numpy()).astype(jnp.float32),
                      jnp.asarray(o.float().numpy()).astype(jnp.float32))
    got = ref.flash_delta(o, do)
    assert got.dtype == torch.float32
    _close(got, want, 1e-6)


# --- chip_smoke.py's bound on the flash kernels' bf16 outputs ------------

def _chip_smoke():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("fault", ["none", "late rows x 1.02",
                                   "late rows miss a key tile"])
def test_chip_smoke_bf16_bound_is_per_element(fault):
    """chip_smoke.py holds each bf16 element of the kernels' outputs to one
    bf16 ulp of its own value plus 1e-3 of the largest value.  o summed
    in another order (fp64) passes; a 2% error of the late causal rows,
    whose values are far below the first rows', fails, and so does a key
    tile that the late rows miss."""
    cs = _chip_smoke()
    T, G, hd, half = 2048, 2, 64, 1024
    q, k, v, _ = (_torch(a, torch.bfloat16)
                  for a in _inputs(1, T, T, 1, G, hd, seed=7))
    o_p, _ = ref.flash_fwd_ref(q, k, v, causal=True)
    s = torch.einsum("qgh,kh->qgk", q[0, :, 0].double() * hd ** -0.5,
                     k[0, :, 0].double())
    keep = torch.ones(T, T, dtype=torch.bool).tril()
    if fault == "late rows miss a key tile":
        keep[half:, 256:320] = False
    p = torch.softmax(s.masked_fill(~keep[:, None, :], -torch.inf), -1)
    o = torch.einsum("qgk,kh->qgh", p, v[0, :, 0].double())
    if fault == "late rows x 1.02":
        o[half:] *= 1.02
    o = o.to(torch.bfloat16)[None, :, None]
    check = (lambda: cs._check_elementwise(
        "o", o, o_p, cs.FA_RTOL_BF16, cs.FA_ATOL_BF16))
    if fault == "none":
        assert check()[2] <= 1.0
    else:
        with pytest.raises(AssertionError, match="element"):
            check()


# --- the bf16 kernels' numerical scheme, emulated in fp32 -----------------

def _bf16_terms(x, split):
    """x as the bf16 kernels feed it to the tensor cores: hi = bf16(x) and
    lo = bf16(x - hi), or hi alone (one rounding), each back in fp32."""
    hi = x.to(torch.bfloat16).float()
    return (hi, (x - hi).to(torch.bfloat16).float()) if split else (hi,)


def _emulate_bf16_kernels(q, k, v, do, o, lse, split_ds, tile=None,
                          scale=None):
    """The bf16 kernels' arithmetic in fp32 on the CPU, for B = KV = 1: S =
    Q.K^T and dP = dO.V^T exact products of bf16 inputs with fp32 sums; P
    and dS formed in fp32; every product with P (forward and backward) as
    two bf16 terms, and with dS as two (``split_ds``) or one; l over the
    fp32 p; the backward fed the given o and lse.  -> (o, dq, dk, dv) in
    bf16.  With ``tile`` the operands sit zero-padded in a tile of that
    many columns, as the kernels hold hd 112 in 128: the products over hd
    (S, dP) read its first hd columns, the others (P.V, dS.K, dS^T.Q,
    P^T.dO) run at the tile's width, and the first hd columns of their
    outputs are kept.  ``scale`` defaults to q's hd ** -0.5."""
    hd = q.shape[-1]
    scale = hd ** -0.5 if scale is None else scale
    qf, kf, vf, dof = (F.pad(t[0, :, 0].float(), (0, (tile or hd) - hd))
                       for t in (q, k, v, do))
    T = qf.shape[0]
    keep = torch.ones(T, T, dtype=torch.bool).tril()[:, None, :]
    s = torch.einsum("qgh,kh->qgk", qf[..., :hd], kf[..., :hd]) * scale
    s = s.masked_fill(~keep, ref.NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o_e = sum(torch.einsum("qgk,kh->qgh", t, vf)
              for t in _bf16_terms(p, True)) / p.sum(-1, keepdim=True)
    p = torch.exp(s - lse[0, :, 0][..., None])
    delta = ref.flash_delta(o, do)[0, :, 0][..., None]
    ds = p * (torch.einsum("qgh,kh->qgk", dof[..., :hd], vf[..., :hd])
              - delta)
    dq = sum(torch.einsum("qgk,kh->qgh", t, kf)
             for t in _bf16_terms(ds, split_ds)) * scale
    dk = sum(torch.einsum("qgk,qgh->kh", t, qf)
             for t in _bf16_terms(ds, split_ds)) * scale
    dv = sum(torch.einsum("qgk,qgh->kh", t, dof)
             for t in _bf16_terms(p, True))
    return tuple(t[..., :hd].to(torch.bfloat16)[None, :, None]
                 for t in (o_e, dq, dk, dv))


@pytest.mark.parametrize("split_ds", [True, False],
                         ids=["dS as two bf16 terms", "dS rounded once"])
def test_bf16_kernel_scheme_meets_chip_smoke_bound(split_ds):
    """The bf16 kernels feed P and dS to the tensor cores as two bf16 terms
    each: emulated in fp32 at StarCoder2-3B's group (G 12, hd 128, causal,
    T 1,024), every element of o, dq, dk and dv stays within chip_smoke.py's
    per-element bf16 bound of the plain version.  dS rounded once to bf16
    instead breaks the bound for the gradients it feeds, dq and dk (the
    scheme is not loosened to fit); o and dv, which it does not feed, stay
    within."""
    cs = _chip_smoke()
    q, k, v, do = (_torch(a, torch.bfloat16)
                   for a in _inputs(1, 1024, 1024, 1, 12, 128, seed=13))
    o, lse = ref.flash_fwd_ref(q, k, v, causal=True)
    plain = dict(zip(("o", "dq", "dk", "dv"), (
        o, *ref.flash_bwd_ref(q, k, v, o, lse, do, causal=True))))
    got = dict(zip(plain, _emulate_bf16_kernels(q, k, v, do, o, lse,
                                                split_ds)))

    def check(name):
        return cs._check_elementwise(name, got[name], plain[name],
                                     cs.FA_RTOL_BF16, cs.FA_ATOL_BF16)[2]

    for name in ("o", "dv") if not split_ds else plain:
        assert check(name) <= 1.0
    if not split_ds:
        with pytest.raises(AssertionError, match="element"):
            for name in ("dq", "dk"):
                check(name)


@pytest.mark.parametrize("scale_hd", [112, 128],
                         ids=["scale 112 ** -0.5", "scale 128 ** -0.5"])
def test_bf16_kernel_scheme_at_head_dim_112(scale_hd):
    """Head_dim 112 in the kernels' tile of 128 columns, the last 16
    zeros (Zamba2's shared attention, G = 1 as at its full width; T 512):
    the emulated padded computation equals the unpadded one at the same
    scale, and at ``112 ** -0.5`` every element of o, dq, dk and dv stays
    within chip_smoke.py's per-element bf16 bound of the plain version.
    Padding q, k and v to 128 on the host and running the hd-128 kernel
    would scale the scores by ``128 ** -0.5``: far outside the bound."""
    cs = _chip_smoke()
    q, k, v, do = (_torch(a, torch.bfloat16)
                   for a in _inputs(1, 512, 512, 1, 1, 112, seed=14))
    o, lse = ref.flash_fwd_ref(q, k, v, causal=True)
    plain = dict(zip(("o", "dq", "dk", "dv"), (
        o, *ref.flash_bwd_ref(q, k, v, o, lse, do, causal=True))))
    factor = scale_hd ** -0.5
    padded = _emulate_bf16_kernels(q, k, v, do, o, lse, True, tile=128,
                                   scale=factor)
    unpadded = _emulate_bf16_kernels(q, k, v, do, o, lse, True,
                                     scale=factor)
    for name, a, b in zip(plain, padded, unpadded):
        assert a.shape == plain[name].shape
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)
    got = dict(zip(plain, padded))

    def check(name):
        return cs._check_elementwise(name, got[name], plain[name],
                                     cs.FA_RTOL_BF16, cs.FA_ATOL_BF16)[2]

    if scale_hd == 112:
        for name in plain:
            assert check(name) <= 1.0
    else:
        with pytest.raises(AssertionError, match="element"):
            check("o")


@pytest.mark.parametrize("G", [1, 2])
def test_head_dim_112_matches_jax(G):
    """``FlashAttentionFunction`` at head_dim 112 (Zamba2's shared block:
    G = 1 at full width, 2 reduced), causal: the forward, lse and the q,
    k and v gradients against JAX's Pallas flash in interpret mode, whose
    scale is 112 ** -0.5."""
    B, T, KV, hd = 1, 64, 2, 112
    q, k, v, cot = _inputs(B, T, T, KV, G, hd, seed=15)
    jo, jlse = jfa.flash_fwd(_jax(q), _jax(k), _jax(v), causal=True, bq=32,
                             interpret=True)
    o, lse = fa.flash_fwd(_torch(q), _torch(k), _torch(v), causal=True,
                          bq=32)
    _close(o, jo, FWD_TOL, "o")
    _close(lse, jlse, FWD_TOL, "lse")

    def jloss(q, k, v):
        return jnp.vdot(jfa.flash_attention(q, k, v, True, 32, True),
                        _jax(cot))

    jg = jax.grad(jloss, argnums=(0, 1, 2))(_jax(q), _jax(k), _jax(v))
    tq, tk, tv = (_torch(a).requires_grad_() for a in (q, k, v))
    (fa.flash_attention(tq, tk, tv, True, 32) * _torch(cot)).sum().backward()
    for t, want, name in zip((tq, tk, tv), jg, "qkv"):
        _close(t.grad, want, GRAD_TOL, f"d{name}")


@pytest.mark.parametrize("v_width", [192, 128], ids=["v 192", "v 128 padded"])
def test_head_dim_192_matches_jax(v_width):
    """``flash_fwd`` and ``flash_bwd`` at head_dim 192 (DeepSeek-V3's MLA:
    G = 1, causal) against JAX's Pallas ``flash_fwd`` and ``flash_bwd`` in
    interpret mode, whose scale is 192 ** -0.5: o, lse, dq, dk and dv, with
    v (and the cotangent) of 192 real columns, and with v's last 64
    columns zeros as the MLA block pads them (the output's and dv's last
    64 columns are zeros then, on both sides)."""
    B, T, KV, G, hd = 1, 64, 2, 1, 192
    q, k, v, cot = _inputs(B, T, T, KV, G, hd, seed=16)
    v[..., v_width:] = 0.0
    cot[..., v_width:] = 0.0
    jq, jk, jv = _jax(q), _jax(k), _jax(v)
    jo, jlse = jfa.flash_fwd(jq, jk, jv, causal=True, bq=32, interpret=True)
    o, lse = fa.flash_fwd(_torch(q), _torch(k), _torch(v), causal=True,
                          bq=32)
    _close(o, jo, FWD_TOL, "o")
    _close(lse, jlse, FWD_TOL, "lse")
    want = jfa.flash_bwd(jq, jk, jv, jo, jlse, _jax(cot), causal=True, bq=32,
                         bk=32, interpret=True)
    got = fa.flash_bwd(_torch(q), _torch(k), _torch(v), o, lse, _torch(cot),
                       causal=True)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert g.shape == w.shape
        _close(g, w, GRAD_TOL, name)
    if v_width < hd:
        assert not o[..., v_width:].any() and not got[2][..., v_width:].any()


def test_padded_v_slice_is_attention_at_v_width():
    """The MLA block's flash call (``mla.flash_mla``: v padded with zeros
    from 128 to the qk width 192, the output sliced back) equals plain
    attention with v at its own width (``common.gqa_attention``), and so
    do the gradients of q, k and the unpadded v through the pad and the
    slice; H = 4 heads of their own (G = 1)."""
    from repro_torch.models import mla

    B, T, H, qh, vh = 1, 64, 4, 192, 128
    rng = np.random.default_rng(17)
    q, k = (rng.standard_normal((B, T, H, qh)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((B, T, H, vh)).astype(np.float32)
    cot = rng.standard_normal((B, T, H, vh)).astype(np.float32)
    cfg = type("Cfg", (), {"attn_chunk": 32})()
    outs = {}
    for name in ("flash", "plain"):
        tq, tk, tv = (_torch(a).requires_grad_() for a in (q, k, v))
        o = (mla.flash_mla(tq, tk, tv, cfg) if name == "flash" else
             cm.gqa_attention(tq, tk, tv, causal=True))
        assert o.shape == (B, T, H, vh)
        (o * _torch(cot)).sum().backward()
        outs[name] = (o.detach(), tq.grad, tk.grad, tv.grad)
    for a, b, what in zip(outs["flash"], outs["plain"], ("o", "dq", "dk",
                                                        "dv")):
        _close(a, b, GRAD_TOL if what != "o" else FWD_TOL, what)


def test_head_dims_are_the_kernels_templates():
    """The wrapper's ``_HEAD_DIMS``, read beside the sources: each C entry
    point refuses every other head dimension and dispatches a template
    for each, and the wrapper refuses the others on the card (its check
    runs before any launch, so a CPU test reaches it through
    ``_check_on_card`` with a stand-in device)."""
    assert fa._HEAD_DIMS == (64, 112, 128, 192)
    csrc = Path(fa.__file__).parent / "csrc"
    for name in ("flash_fwd.cu", "flash_bwd.cu"):
        src = (csrc / name).read_text()
        refused = re.search(r"if \((hd != \d+(?: && hd != \d+)*)\) return "
                            r"ERR_HEAD_DIM;", src)
        assert refused, name
        assert tuple(int(d) for d in re.findall(r"\d+", refused[1])) == \
            fa._HEAD_DIMS, name
        for hd in fa._HEAD_DIMS:
            assert re.search(rf"return launch<T, {hd}>\(", src), (name, hd)
    assert fa._REFUSED[-1] == "head_dim must be one of (64, 112, 128, 192)"
    common = (csrc / "flash_common.cuh").read_text()
    assert "constexpr int pad64(int hd)" in common

    class Card:
        type = "cuda"

    q = torch.zeros(1, 16, 1, 1, 96)
    with pytest.raises(ValueError,
                       match=r"one of \(64, 112, 128, 192\), got 96"):
        fa._check_on_card("flash_fwd", ("q", type("T", (), {
            "device": Card(), "shape": q.shape})()))
