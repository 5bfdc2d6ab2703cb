"""Parity of the port's depthwise conv (``repro_torch.kernels``:
``ref.depthwise_*``, ``conv1d_brgemm.depthwise_conv1d_fwd`` /
``depthwise_conv1d_bwd_weight`` and ``ops.depthwise_conv1d`` /
``ops.DepthwiseConv1dFunction``) with the JAX package, on the CPU.

The same numpy inputs, made from a seed, go through JAX's
``ops.depthwise_conv1d`` (its Pallas kernels in interpret mode,
``backend="pallas"``, and its plain version, ``backend="ref"``) and
through the port: its plain backend (``backend="ref"``) and the Function
on CPU tensors, whose wrappers then compute each pass's plain version.  So
the tests hold the Function's own algebra (cotangent padding, flipped taps,
activation mask, dbias, dresidual, dtypes); the CUDA kernels are held
against the plain versions on the card by ``chip_smoke.py``.

Tolerances, each against the largest value of the JAX result:
  * fp32: ``|port - jax| <= 1e-5 * max|jax|`` (sums in another order);
  * bf16 (inputs rounded to bf16 once, the same values on both sides, and
    each side computing in its own bf16 dtypes): one bf16 rounding of the
    largest value, ``|port - jax| <= 2**-7 * max|jax|`` (2**-7 is one bf16
    unit in the last place relative to a value).  The two sides round
    the same fp32 results, which differ only in their last fp32 bits, so a
    rounded value lands on one of two neighbours; a cotangent rounded to
    bf16 on a neighbour carries that through the weight gradient's sums,
    hence the largest value as the scale.  (JAX's ``backend="ref"``
    rounds its bf16 data gradient tap by tap, differentiating its
    oracle's per-tap casts; it stays within the same bound here.)
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels import epilogue as jep
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import conv1d_brgemm, ops, ref

F32_REL = 1e-5
BF16_ULP = 2.0 ** -7
N, C, W = 2, 6, 37


def _close(got, want, dtype, what=""):
    """Within the module's tolerance: 1e-5 of the largest value in fp32,
    one bf16 rounding of it in bf16."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    rel = BF16_ULP if dtype == "bfloat16" else F32_REL
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale,
                               err_msg=what)


def _operands(S, Q, *, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, C, W)).astype(np.float32)
    w = (rng.standard_normal((S, C)) / np.sqrt(S)).astype(np.float32)
    b = (0.5 * rng.standard_normal(C)).astype(np.float32)
    r = rng.standard_normal((N, C, Q)).astype(np.float32)
    g = rng.standard_normal((N, C, Q)).astype(np.float32)
    return x, w, b, r, g


def _jax(a, dtype):
    return None if a is None else jnp.asarray(a).astype(jnp.dtype(dtype))


def _torch(a, dtype):
    return None if a is None else torch.from_numpy(a).to(getattr(torch, dtype))


# (S, dilation, padding, bias, activation, residual, dtype, out_dtype)
CASES = [
    (4, 1, "CAUSAL", True, "silu", False, "float32", None),   # Mamba2's
    (4, 3, "CAUSAL", True, "gelu", True, "float32", None),
    (4, 1, "SAME", False, "relu", True, "float32", None),
    (4, 3, "SAME", True, None, False, "float32", None),
    (3, 1, "CAUSAL", False, None, True, "float32", None),
    (3, 3, "SAME", False, "silu", False, "float32", None),
    # the bf16 model's conv: bf16 in, fp32 out, fp32 cotangent
    (4, 1, "CAUSAL", True, "silu", False, "bfloat16", "float32"),
    (4, 3, "SAME", True, "relu", True, "bfloat16", None),
    (4, 1, "CAUSAL", True, "gelu", True, "bfloat16", None),
    (3, 3, "CAUSAL", False, None, False, "bfloat16", None),
]


def _case_id(c):
    S, d, pad, b, act, r, dt, od = c
    return (f"S{S}d{d}-{pad}-" + jep.signature(b, act, r) + f"-{dt}"
            + (f"-out_{od}" if od else ""))


def _inputs(case):
    S, d, padding, has_b, act, has_r, dt, od = case
    Q = W  # CAUSAL and SAME keep the width
    x, w, b, r, g = _operands(S, Q)
    ins = {"x": x, "w": w, "b": b if has_b else None,
           "r": r if has_r else None}
    return ins, g


def _jax_fwd_and_grads(ins, g, *, S, d, padding, act, dt, od, backend):
    names = [k for k, v in ins.items() if v is not None]
    out_dtype = jnp.dtype(od) if od else None

    def fwd(*args):
        kw = dict(zip(names, args))
        return jops.depthwise_conv1d(
            kw["x"], kw["w"], bias=kw.get("b"), residual=kw.get("r"),
            activation=act, dilation=d, padding=padding, backend=backend,
            out_dtype=out_dtype)

    args = tuple(_jax(ins[k], dt) for k in names)
    y, vjp = jax.vjp(fwd, *args)
    grads = vjp(jnp.asarray(g).astype(y.dtype))
    return y, dict(zip(names, grads))


def _port_fwd_and_grads(ins, g, *, S, d, padding, act, dt, od, path):
    t = {k: None if v is None else _torch(v, dt).requires_grad_()
         for k, v in ins.items()}
    kw = dict(bias=t["b"], residual=t["r"], activation=act, dilation=d,
              out_dtype=getattr(torch, od) if od else None)
    if path == "function":
        lo, hi = ops._pad_amounts(S, d, padding)
        y = ops.fused_depthwise_conv1d(F.pad(t["x"], (lo, hi)), t["w"], **kw)
        assert type(y.grad_fn).__name__ == "DepthwiseConv1dFunctionBackward"
    else:
        y = ops.depthwise_conv1d(t["x"], t["w"], padding=padding,
                                 backend="ref", **kw)
    y.backward(torch.from_numpy(g).to(y.dtype))
    grads = {}
    for k, v in t.items():
        if v is not None:
            assert v.grad.dtype == v.dtype, k  # cast back to the primal's
            grads[k] = v.grad
    return y.detach(), grads


@pytest.mark.parametrize("jax_backend", ["pallas", "ref"])
@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_depthwise_fwd_and_grads_match_jax(case, jax_backend):
    """The output and dx, dw, dbias, dresidual of the port's Function and
    of its plain backend against ``jax.vjp`` of JAX's
    ``depthwise_conv1d``, in the case's dtypes on both sides."""
    S, d, padding, has_b, act, has_r, dt, od = case
    ins, g = _inputs(case)
    y_j, g_j = _jax_fwd_and_grads(ins, g, S=S, d=d, padding=padding,
                                  act=act, dt=dt, od=od, backend=jax_backend)
    for path in ("function", "ref"):
        y, grads = _port_fwd_and_grads(ins, g, S=S, d=d, padding=padding,
                                       act=act, dt=dt, od=od, path=path)
        assert y.dtype == getattr(torch, od or dt)
        # an fp32 output is one fp32 sum either way; a bf16 one a rounding
        _close(y.float(), y_j, od or dt, f"{path} y")
        assert set(grads) == set(g_j)
        for k, v in grads.items():
            _close(v.float(), g_j[k], dt, f"{path} d{k}")


@pytest.mark.parametrize("dilation", [1, 3])
def test_plain_versions_match_jax_refs(dilation):
    """The oracles of ``kernels/ref.py`` against the JAX package's."""
    S = 4
    Q = W - (S - 1) * dilation
    x, w, b, r, _ = _operands(S, Q)
    g = np.random.default_rng(5).standard_normal((N, C, Q)).astype(np.float32)
    tx, tw, tb, tr, tg = (_torch(a, "float32") for a in (x, w, b, r, g))
    jx, jw, jb, jr, jg = (jnp.asarray(a) for a in (x, w, b, r, g))
    _close(ref.depthwise_conv1d_fused_ref(tx, tw, dilation=dilation, bias=tb,
                                          residual=tr, activation="silu"),
           jref.depthwise_conv1d_fused_ref(jx, jw, dilation=dilation,
                                           bias=jb, residual=jr,
                                           activation="silu"), "float32")
    _close(ref.depthwise_conv1d_preact_ref(tx, tw, dilation=dilation, bias=tb,
                                           residual=tr),
           jref.depthwise_conv1d_fused_ref(jx, jw, dilation=dilation,
                                           bias=jb, residual=jr), "float32")
    _close(ref.depthwise_conv1d_bwd_weight_ref(tx, tg, dilation=dilation),
           jref.depthwise_conv1d_bwd_weight_ref(jx, jg, dilation=dilation),
           "float32")
    # the data gradient: the vjp of JAX's plain depthwise conv wrt x
    _, vjp = jax.vjp(lambda a: jref.depthwise_conv1d_ref(a, jw,
                                                         dilation=dilation),
                     jx)
    _close(ref.depthwise_conv1d_bwd_data_ref(tg, tw, dilation=dilation),
           vjp(jg)[0], "float32")


@pytest.mark.parametrize("save_preact", [False, True])
def test_depthwise_fwd_on_cpu_is_the_plain_version(save_preact):
    S, d = 4, 2
    x, w, b, r, _ = _operands(S, W - (S - 1) * d)
    tx, tw, tb, tr = (_torch(a, "float32") for a in (x, w, b, r))
    before = conv1d_brgemm.depthwise_conv1d_fwd.launches
    out = conv1d_brgemm.depthwise_conv1d_fwd(
        tx, tw, bias=tb, residual=tr, activation="gelu",
        save_preact=save_preact, dilation=d, out_dtype=torch.bfloat16)
    u = ref.depthwise_conv1d_preact_ref(tx, tw, dilation=d, bias=tb,
                                        residual=tr)
    want = ref.depthwise_conv1d_fused_ref(tx, tw, dilation=d, bias=tb,
                                          residual=tr, activation="gelu",
                                          out_dtype=torch.bfloat16)
    y = out[0] if save_preact else out
    assert torch.equal(y, want) and y.dtype == torch.bfloat16
    if save_preact:
        assert torch.equal(out[1], u) and out[1].dtype == torch.float32
    # the plain version on the CPU is no launch
    assert conv1d_brgemm.depthwise_conv1d_fwd.launches == before


@pytest.mark.parametrize("dtypes", [("float32", "float32"),
                                    ("bfloat16", "float32"),
                                    ("float32", "bfloat16")])
@pytest.mark.parametrize("with_dbias", [False, True])
def test_depthwise_bwd_weight_on_cpu_is_the_plain_version(dtypes, with_dbias):
    """x and the cotangent each in its own dtype, as the kernel takes them."""
    S, d = 4, 3
    Q = W - (S - 1) * d
    x, _, _, _, _ = _operands(S, Q)
    g = np.random.default_rng(8).standard_normal((N, C, Q)).astype(np.float32)
    tx, tg = _torch(x, dtypes[0]), _torch(g, dtypes[1])
    before = conv1d_brgemm.depthwise_conv1d_bwd_weight.launches
    out = conv1d_brgemm.depthwise_conv1d_bwd_weight(tx, tg, S=S, dilation=d,
                                                    with_dbias=with_dbias)
    dw = out[0] if with_dbias else out
    assert dw.shape == (S, C) and dw.dtype == torch.float32
    assert torch.equal(dw, ref.depthwise_conv1d_bwd_weight_ref(tx, tg,
                                                               dilation=d))
    if with_dbias:
        assert torch.equal(out[1], ref.conv1d_dbias_ref(tg))
    assert conv1d_brgemm.depthwise_conv1d_bwd_weight.launches == before


def _bad(what):
    x = torch.zeros(2, 4, 20)
    w = torch.zeros(4, 4)
    kw = {}
    if what == "shape":
        w = torch.zeros(4, 5)
    elif what == "rank":
        w = torch.zeros(4, 4, 1)
    elif what == "dtype":
        w = w.to(torch.bfloat16)
    elif what == "dilation":
        kw["dilation"] = 0
    elif what == "narrow":
        kw["dilation"] = 7
    elif what == "strided":
        x = torch.zeros(2, 20, 4).transpose(1, 2)
    elif what == "bias":
        kw["bias"] = torch.zeros(3)
    elif what == "residual":
        kw["residual"] = torch.zeros(2, 4, 20)
    elif what == "half":
        x, w = x.half(), w.half()
    return x, w, kw


@pytest.mark.parametrize("what", ["shape", "rank", "dtype", "dilation",
                                  "narrow", "strided", "bias", "residual",
                                  "half"])
def test_depthwise_fwd_rejects_bad_inputs(what):
    x, w, kw = _bad(what)
    with pytest.raises(ValueError):
        conv1d_brgemm.depthwise_conv1d_fwd(x, w, **kw)


@pytest.mark.parametrize("what", ["width", "rank", "strided", "half", "taps"])
def test_depthwise_bwd_weight_rejects_bad_inputs(what):
    x, g, S = torch.zeros(2, 4, 23), torch.zeros(2, 4, 20), 4
    if what == "width":
        S = 3
    elif what == "rank":
        g = torch.zeros(8, 20)
    elif what == "strided":
        g = torch.zeros(2, 20, 4).transpose(1, 2)
    elif what == "half":
        x = x.half()
    elif what == "taps":
        S = 0
    with pytest.raises(ValueError):
        conv1d_brgemm.depthwise_conv1d_bwd_weight(x, g, S=S)


def test_cuda_backend_on_cpu_tensor_raises():
    with pytest.raises(ValueError, match="CUDA"):
        ops.depthwise_conv1d(torch.zeros(1, 4, 8), torch.zeros(4, 4),
                             backend="cuda")
    with pytest.raises(ValueError, match="backend"):
        ops.depthwise_conv1d(torch.zeros(1, 4, 8), torch.zeros(4, 4),
                             backend="xla")


def test_function_passes_and_no_grad_path(monkeypatch):
    """A recorded call runs the forward, then in the backward one bwd-data
    pass through the forward wrapper and one bwd-weight pass (none for dx
    when the input needs no gradient); under ``inference_mode`` the path
    is one forward call with no autograd record.  Counted through the
    wrappers."""
    calls = {"fwd": 0, "bwd_weight": 0}

    def counted(name, fn):
        def wrapper(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapper

    monkeypatch.setattr(conv1d_brgemm, "depthwise_conv1d_fwd",
                        counted("fwd", conv1d_brgemm.depthwise_conv1d_fwd))
    monkeypatch.setattr(
        conv1d_brgemm, "depthwise_conv1d_bwd_weight",
        counted("bwd_weight", conv1d_brgemm.depthwise_conv1d_bwd_weight))
    x, w, b, _, _ = _operands(4, W)
    for x_grad, want in ((False, 1), (True, 2)):
        calls.update(fwd=0, bwd_weight=0)
        xt = _torch(x, "float32").requires_grad_(x_grad)
        wt, bt = _torch(w, "float32").requires_grad_(), \
            _torch(b, "float32").requires_grad_()
        y = ops.fused_depthwise_conv1d(F.pad(xt, (3, 0)), wt, bias=bt,
                                       activation="silu")
        y.sum().backward()
        assert calls == {"fwd": want, "bwd_weight": 1}
        assert (xt.grad is not None) == x_grad
    calls.update(fwd=0, bwd_weight=0)
    with torch.inference_mode():
        y = ops.fused_depthwise_conv1d(_torch(x, "float32"), wt,
                                       activation="silu")
    assert y.grad_fn is None and calls == {"fwd": 1, "bwd_weight": 0}


def test_mixed_dtypes_follow_the_jax_rule():
    """bf16 x with fp32 weights (and the reverse): fp32 math on the values
    given, output in x's dtype, as JAX's ``backend="ref"``."""
    x, w, b, _, _ = _operands(4, W)
    for xd, wd in (("bfloat16", "float32"), ("float32", "bfloat16")):
        got = ops.fused_depthwise_conv1d(
            F.pad(_torch(x, xd), (3, 0)), _torch(w, wd),
            bias=_torch(b, wd), activation="silu")
        want = jops.depthwise_conv1d(_jax(x, xd), _jax(w, wd),
                                     bias=_jax(b, wd), activation="silu",
                                     backend="ref")
        assert got.dtype == getattr(torch, xd)
        _close(got.float(), want, xd, f"{xd} x, {wd} w")
