"""Parity of the port's kernel modules (``repro_torch.kernels``) with the JAX
package, on the CPU.

The same numpy inputs, made from a seed, go through the JAX function and
its counterpart in the port.  On the CPU the port computes its plain
PyTorch version; the JAX side runs its Pallas kernel in interpret mode
(``backend="pallas"``) and its own plain version (``backend="ref"``).
Tolerances: ``atol=rtol=1e-5`` in fp32 (the two frameworks sum in another
order); ``2e-2`` for bf16, against JAX's fp32 math on bf16-rounded inputs.
Gradients: ``atol=rtol=1e-4`` in fp32 (the weight gradient sums every
batch and width position, and dx passes through a second conv, in
another order); for bf16, ``2e-2`` of the largest value (the port rounds
dx, dw and dbias to bf16).  The backward cases call
``ops.fused_conv1d`` on CPU tensors: it runs ``ops.Conv1dFunction``, whose
wrappers then compute each pass's plain version, so they check the
Function's own algebra (flip, transpose, cotangent padding, activation
mask, dbias, dresidual, mixed head dtypes).  The CUDA kernels themselves
are held against their plain versions on the card by ``chip_smoke.py``.
"""
from __future__ import annotations

import os
import stat
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch.nn.functional as F

from repro.kernels import epilogue as jep
from repro.kernels import ops as jops
from repro_torch.kernels import build, conv1d_brgemm, epilogue, ops, ref

F32_TOL = dict(atol=1e-5, rtol=1e-5)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)


def _operands(C, K, S, W, *, N=2, residual_q=None, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, C, W)).astype(np.float32)
    w = (rng.standard_normal((S, K, C)) / np.sqrt(C * S)).astype(np.float32)
    b = (0.5 * rng.standard_normal(K)).astype(np.float32)
    r = (rng.standard_normal((N, K, residual_q)).astype(np.float32)
         if residual_q else None)
    return x, w, b, r


def _jax(a):
    return None if a is None else jnp.asarray(a)


def _torch(a, dtype=torch.float32):
    return None if a is None else torch.from_numpy(a).to(dtype)


def _out_width(W, S, d, padding):
    return W - (S - 1) * d if padding == "VALID" else W


# (C, K, S, dilation, padding, bias, activation, residual, out_dtype)
CASES = [
    (3, 4, 3, 2, "SAME", True, "relu", True, None),
    (3, 4, 3, 1, "VALID", False, None, False, None),
    (3, 4, 3, 3, "CAUSAL", True, "gelu", False, None),
    (3, 4, 3, 8, "CAUSAL", True, "silu", True, None),
    (1, 4, 3, 4, "CAUSAL", True, "relu", False, None),          # stem: C=1
    (4, 1, 3, 5, "CAUSAL", True, "relu", False, None),          # head: K=1
    (4, 1, 3, 6, "SAME", True, None, False, None),              # head: K=1
    (2, 3, 5, 7, "VALID", True, "relu", True, None),
    (3, 2, 4, 2, "CAUSAL", True, "relu", True, "bfloat16"),     # out_dtype
]


def _case_id(c):
    C, K, S, d, pad, b, act, r, od = c
    return (f"C{C}K{K}S{S}d{d}-{pad}-" + jep.signature(b, act, r)
            + (f"-{od}" if od else ""))


@pytest.mark.parametrize("jax_backend", ["pallas", "ref"])
@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_conv1d_matches_jax(case, jax_backend):
    C, K, S, d, padding, has_b, act, has_r, od = case
    W = 40
    Q = _out_width(W, S, d, padding)
    x, w, b, r = _operands(C, K, S, W, residual_q=Q if has_r else None)
    b = b if has_b else None
    want = jops.conv1d(_jax(x), _jax(w), bias=_jax(b), activation=act,
                       residual=_jax(r), dilation=d, padding=padding,
                       backend=jax_backend,
                       out_dtype=jnp.dtype(od) if od else None)
    got = ops.conv1d(_torch(x), _torch(w), bias=_torch(b), activation=act,
                     residual=_torch(r), dilation=d, padding=padding,
                     out_dtype=getattr(torch, od) if od else None)
    assert got.shape == (2, K, Q)
    assert got.dtype == (getattr(torch, od) if od else torch.float32)
    tol = BF16_TOL if od == "bfloat16" else F32_TOL
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("dilation", [1, 8])
def test_conv1d_bf16_matches_jax_fp32_math(dilation):
    """bf16 tensors through the port against JAX's fp32 math on the same
    bf16-rounded inputs."""
    S, W = 3, 48
    x, w, b, r = _operands(4, 4, S, W, residual_q=W)
    xb, wb, bb, rb = (_torch(a, torch.bfloat16) for a in (x, w, b, r))
    got = ops.conv1d(xb, wb, bias=bb, residual=rb, activation="relu",
                     dilation=dilation, padding="CAUSAL")
    assert got.dtype == torch.bfloat16
    want = jops.conv1d(*(_jax(a.float().numpy()) for a in (xb, wb)),
                       bias=_jax(bb.float().numpy()),
                       residual=_jax(rb.float().numpy()), activation="relu",
                       dilation=dilation, padding="CAUSAL", backend="pallas")
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want),
                               **BF16_TOL)


def test_plain_conv1d_ref_matches_jax():
    from repro.kernels import ref as jref
    x, w, _, _ = _operands(3, 4, 5, 40)
    got = ref.conv1d_ref(_torch(x), _torch(w), dilation=3)
    want = jref.conv1d_ref(_jax(x), _jax(w), dilation=3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("act", ["none", "relu", "gelu", "silu"])
def test_epilogue_matches_jax(act):
    rng = np.random.default_rng(1)
    u = (3 * rng.standard_normal((2, 3, 17))).astype(np.float32)
    b = rng.standard_normal(3).astype(np.float32)
    r = rng.standard_normal((2, 3, 17)).astype(np.float32)
    want = jep.apply_ref(jnp.asarray(u), bias=jnp.asarray(b),
                         residual=jnp.asarray(r), activation=act)
    got = epilogue.apply_ref(_torch(u), bias=_torch(b), residual=_torch(r),
                             activation=act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-6)


@pytest.mark.parametrize("has_b,act,has_r", [
    (False, None, False), (True, "relu", False), (True, "relu", True),
    (False, "gelu", True), (True, "SiLU", False)])
def test_epilogue_signature_matches_jax(has_b, act, has_r):
    assert (epilogue.signature(has_b, act, has_r)
            == jep.signature(has_b, act, has_r))


def test_unknown_activation_raises():
    with pytest.raises(ValueError, match="activation"):
        epilogue.canon("tanh")


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_conv1d_streaming_matches_jax(fused):
    S, d, chunks = 5, 3, [1, 7, 64, 29]
    W = sum(chunks)
    x, w, b, r = _operands(6, 5, S, W, residual_q=W)
    ep = dict(bias=b, activation="relu") if fused else {}
    jstate = jops.conv_stream_state(2, 6, S, d)
    tstate = ops.conv_stream_state(2, 6, S, d)
    outs, pos = [], 0
    for c in chunks:
        res = r[:, :, pos:pos + c] if fused else None
        jy, jstate = jops.conv1d_streaming(
            _jax(x[:, :, pos:pos + c]), _jax(w), state=jstate, dilation=d,
            residual=_jax(res), backend="ref",
            **{k: _jax(v) if k == "bias" else v for k, v in ep.items()})
        ty, tstate = ops.conv1d_streaming(
            _torch(x[:, :, pos:pos + c]), _torch(w), state=tstate,
            dilation=d, residual=_torch(res),
            **{k: _torch(v) if k == "bias" else v for k, v in ep.items()})
        assert tstate.is_contiguous()
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **F32_TOL)
        outs.append(ty)
        pos += c
    np.testing.assert_array_equal(tstate.numpy(), np.asarray(jstate))
    # the chunked stream is the one-shot CAUSAL conv (tolerance: the CPU's
    # einsum may block differently by width)
    one = ops.conv1d(_torch(x), _torch(w), dilation=d, padding="CAUSAL",
                     residual=_torch(r) if fused else None,
                     **{k: _torch(v) if k == "bias" else v
                        for k, v in ep.items()})
    np.testing.assert_allclose(torch.cat(outs, -1).numpy(), one.numpy(),
                               **F32_TOL)


def test_stream_state_mismatch_raises():
    x = torch.zeros(2, 3, 8)
    w = torch.zeros(3, 4, 3)
    with pytest.raises(ValueError, match="shape"):
        ops.conv1d_streaming(x, w, state=torch.zeros(2, 3, 5), dilation=2)
    with pytest.raises(ValueError, match="dtype"):
        ops.conv1d_streaming(x, w, dilation=2, state=torch.zeros(
            2, 3, 4, dtype=torch.bfloat16))


def test_conv1d_fwd_on_cpu_is_the_plain_version():
    """On a CPU tensor the wrapper computes the plain version and launches
    nothing."""
    x, w, b, r = _operands(3, 4, 3, 30, residual_q=30 - 2 * 4)
    before = conv1d_brgemm.conv1d_fwd.launches
    got = conv1d_brgemm.conv1d_fwd(_torch(x), _torch(w), bias=_torch(b),
                                   residual=_torch(r), activation="gelu",
                                   dilation=4)
    want = ref.conv1d_fused_ref(_torch(x), _torch(w), bias=_torch(b),
                                residual=_torch(r), activation="gelu",
                                dilation=4)
    assert torch.equal(got, want)
    assert conv1d_brgemm.conv1d_fwd.launches == before


def _bad_inputs():
    x, w = torch.zeros(2, 3, 20), torch.zeros(3, 4, 3)
    return {
        "dtype": (x.double(), w.double(), {}),
        "channels": (x, torch.zeros(3, 4, 5), {}),
        "narrow": (torch.zeros(2, 3, 4), w, {"dilation": 2}),
        "bias_shape": (x, w, {"bias": torch.zeros(5)}),
        "bias_dtype": (x, w, {"bias": torch.zeros(4, dtype=torch.bfloat16)}),
        "residual_shape": (x, w, {"residual": torch.zeros(2, 4, 20)}),
        "noncontiguous": (torch.zeros(2, 20, 3).transpose(1, 2), w, {}),
        "dilation": (x, w, {"dilation": 0}),
    }


@pytest.mark.parametrize("what", sorted(_bad_inputs()))
def test_conv1d_fwd_rejects_bad_inputs(what):
    x, w, kw = _bad_inputs()[what]
    with pytest.raises(ValueError):
        conv1d_brgemm.conv1d_fwd(x, w, **kw)


def test_cuda_backend_on_cpu_tensor_raises():
    with pytest.raises(ValueError, match="cuda"):
        ops.conv1d(torch.zeros(1, 2, 16), torch.zeros(3, 2, 2),
                   backend="cuda")


def test_default_backend_follows_the_device():
    assert ops.default_backend(torch.zeros(1)) == "ref"
    with pytest.raises(ValueError, match="backend"):
        ops.conv1d(torch.zeros(1, 2, 16), torch.zeros(3, 2, 2),
                   backend="pallas")


def _fake_nvcc(tmp_path, body: str) -> str:
    path = tmp_path / "bin" / "nvcc"
    path.parent.mkdir(exist_ok=True)
    path.write_text("#!/bin/sh\n" + body)
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path)


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()


def test_build_is_keyed_on_the_sources(monkeypatch, tmp_path):
    """A build runs once per content hash; a failed build raises and
    leaves nothing behind."""
    calls = tmp_path / "calls"
    nvcc = _fake_nvcc(tmp_path, f'echo run >> {calls}\n'
                      'while [ "$1" != "-o" ]; do shift; done\n'
                      'echo lib > "$2"\n')
    monkeypatch.setattr(build, "find_nvcc", lambda: nvcc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    first = build.build("conv1d_fwd", ("conv1d_fwd.cu",))
    again = build.build("conv1d_fwd", ("conv1d_fwd.cu",))
    assert first == again and first.exists()
    assert calls.read_text().count("run") == 1
    assert first.with_suffix(".log").exists()

    broken = _fake_nvcc(tmp_path, "echo 'error: nope' >&2\nexit 2\n")
    monkeypatch.setattr(build, "find_nvcc", lambda: broken)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out2")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        build.build("conv1d_fwd", ("conv1d_fwd.cu",))
    assert not list((tmp_path / "out2").glob("*.so"))
    assert os.path.isdir(tmp_path / "out2")


def test_build_hashes_headers_and_compiles_only_sources(monkeypatch,
                                                       tmp_path):
    """A header among the sources enters the library's hash and is not
    handed to nvcc: the ``.cu`` files include it."""
    args = tmp_path / "args"
    nvcc = _fake_nvcc(tmp_path, f'echo "$@" > {args}\n'
                      'while [ "$1" != "-o" ]; do shift; done\n'
                      'echo lib > "$2"\n')
    monkeypatch.setattr(build, "find_nvcc", lambda: nvcc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    with_header = build.build("flash_fwd", ("flash_fwd.cu",
                                            "flash_common.cuh"))
    assert "flash_fwd.cu" in args.read_text()
    assert "flash_common.cuh" not in args.read_text()
    assert with_header != build.build("flash_fwd", ("flash_fwd.cu",))


def test_ops_docstring_example_runs():
    import doctest
    res = doctest.testmod(ops, optionflags=doctest.ELLIPSIS)
    assert res.attempted >= 2 and res.failed == 0


# --- backward: Conv1dFunction and the plain backward passes -------------

# (C, K, S, dilation, padding, bias, activation, residual, dtype, out_dtype)
GRAD_CASES = [
    (3, 4, 3, 1, "VALID", True, None, False, "float32", None),
    (3, 4, 3, 8, "SAME", True, "relu", True, "float32", None),
    (3, 4, 3, 8, "CAUSAL", True, "gelu", False, "float32", None),
    (3, 4, 3, 1, "SAME", True, "silu", True, "float32", None),
    (3, 3, 5, 2, "CAUSAL", False, "gelu", True, "float32", None),
    (3, 4, 3, 8, "VALID", False, "relu", True, "float32", None),
    (3, 3, 3, 1, "CAUSAL", True, "silu", False, "float32", None),
    (1, 4, 3, 8, "SAME", True, "relu", False, "float32", None),    # stem
    (4, 1, 3, 8, "SAME", True, "relu", False, "float32", None),    # head
    (4, 1, 3, 1, "CAUSAL", True, None, False, "float32", None),    # head
    (4, 4, 3, 8, "SAME", True, "relu", True, "bfloat16", None),
    (4, 4, 3, 1, "CAUSAL", True, "gelu", False, "bfloat16", None),
    # the bf16 model's heads: fp32 output, so an fp32 cotangent against
    # bf16 weights and inputs
    (4, 1, 3, 8, "SAME", True, "relu", False, "bfloat16", "float32"),
    (4, 1, 3, 8, "SAME", True, None, False, "bfloat16", "float32"),
]


def _grad_case_id(c):
    C, K, S, d, pad, b, act, r, dt, od = c
    return (f"C{C}K{K}S{S}d{d}-{pad}-" + jep.signature(b, act, r) + f"-{dt}"
            + (f"-out_{od}" if od else ""))


def _grad_operands(C, K, S, d, padding, has_b, has_r, dtype, W=40):
    Q = _out_width(W, S, d, padding)
    x, w, b, r = _operands(C, K, S, W, residual_q=Q if has_r else None)
    g = np.random.default_rng(9).standard_normal((2, K, Q)).astype(np.float32)
    ins = {"x": x, "w": w, "b": b if has_b else None, "r": r}
    if dtype == "bfloat16":  # the values both sides see: bf16-rounded
        ins = {k: None if v is None else
               _torch(v, torch.bfloat16).float().numpy()
               for k, v in ins.items()}
        g = _torch(g, torch.bfloat16).float().numpy()
    return ins, g


def _jax_grads(ins, g, *, d, padding, act, backend, out_dtype):
    names = [k for k, v in ins.items() if v is not None]

    def loss(*args):
        kw = dict(zip(names, args))
        y = jops.conv1d(kw["x"], kw["w"], bias=kw.get("b"),
                        residual=kw.get("r"), activation=act, dilation=d,
                        padding=padding, backend=backend)
        return jnp.sum(y.astype(jnp.float32) * g)

    grads = jax.grad(loss, argnums=tuple(range(len(names))))(
        *(jnp.asarray(ins[k]) for k in names))
    return {k: np.asarray(v, np.float32) for k, v in zip(names, grads)}


def _port_grads(ins, g, *, S, d, padding, act, dtype, out_dtype, path):
    dt = getattr(torch, dtype)
    t = {k: None if v is None else _torch(v, dt).requires_grad_()
         for k, v in ins.items()}
    kw = dict(bias=t["b"], residual=t["r"], activation=act, dilation=d,
              out_dtype=getattr(torch, out_dtype) if out_dtype else None)
    if path == "function":
        lo, hi = ops._pad_amounts(S, d, padding)
        y = ops.fused_conv1d(F.pad(t["x"], (lo, hi)), t["w"], **kw)
    else:
        y = ops.conv1d(t["x"], t["w"], padding=padding, backend="ref", **kw)
    gy = _torch(g).to(y.dtype)
    y.backward(gy)
    out = {}
    for k, v in t.items():
        if v is not None:
            assert v.grad.dtype == v.dtype, k  # cast back to the primal's
            out[k] = v.grad.float().numpy()
    return out


@pytest.mark.parametrize("jax_backend", ["pallas", "ref"])
@pytest.mark.parametrize("case", GRAD_CASES, ids=_grad_case_id)
def test_conv1d_grads_match_jax(case, jax_backend):
    """dx, dw, dbias and dresidual of the port's Function and of its plain
    backend against ``jax.grad`` of JAX's conv1d."""
    C, K, S, d, padding, has_b, act, has_r, dtype, od = case
    ins, g = _grad_operands(C, K, S, d, padding, has_b, has_r, dtype)
    want = _jax_grads(ins, g, d=d, padding=padding, act=act,
                      backend=jax_backend, out_dtype=od)
    for path in ("function", "ref"):
        got = _port_grads(ins, g, S=S, d=d, padding=padding, act=act,
                          dtype=dtype, out_dtype=od, path=path)
        assert set(got) == set(want)
        for k in want:
            if dtype == "bfloat16":
                scale = float(np.abs(want[k]).max())
                tol = dict(atol=2e-2 * scale, rtol=2e-2)
            else:
                tol = GRAD_TOL
            np.testing.assert_allclose(got[k], want[k], err_msg=f"{path} d{k}",
                                       **tol)


def test_function_skips_dx_for_data_inputs(monkeypatch):
    """No bwd-data pass when the input needs no gradient (the stem), one
    bwd-weight pass either way; counted through the wrappers."""
    x, w, b, _ = _operands(3, 4, 3, 30)
    calls = {"fwd": 0, "bwd_weight": 0}

    def counted(name, fn):
        def wrapper(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapper

    monkeypatch.setattr(conv1d_brgemm, "conv1d_fwd",
                        counted("fwd", conv1d_brgemm.conv1d_fwd))
    monkeypatch.setattr(conv1d_brgemm, "conv1d_bwd_weight",
                        counted("bwd_weight", conv1d_brgemm.conv1d_bwd_weight))
    for x_grad, want in ((False, 1), (True, 2)):
        calls.update(fwd=0, bwd_weight=0)
        xt = _torch(x).requires_grad_(x_grad)
        wt, bt = _torch(w).requires_grad_(), _torch(b).requires_grad_()
        y = ops.fused_conv1d(xt, wt, bias=bt, activation="relu", dilation=2)
        y.sum().backward()
        assert calls == {"fwd": want, "bwd_weight": 1}
        assert (xt.grad is not None) == x_grad
        assert wt.grad is not None and bt.grad is not None


def test_no_grad_calls_launch_the_forward_only():
    """Under inference_mode (the server) the kernel path is one forward
    call with no autograd record."""
    x, w, b, _ = _operands(3, 4, 3, 30)
    wt = _torch(w).requires_grad_()
    with torch.inference_mode():
        y = ops.fused_conv1d(_torch(x), wt, bias=_torch(b), dilation=2)
    assert y.grad_fn is None
    y = ops.fused_conv1d(_torch(x), wt, bias=_torch(b), dilation=2)
    assert type(y.grad_fn).__name__ == "Conv1dFunctionBackward"


@pytest.mark.parametrize("dilation", [1, 8])
def test_plain_backward_passes_match_jax(dilation):
    from repro.kernels import ref as jref
    S, W = 3, 40
    x, w, _, _ = _operands(3, 4, S, W)
    Q = W - (S - 1) * dilation
    g = np.random.default_rng(2).standard_normal((2, 4, Q)).astype(np.float32)
    np.testing.assert_allclose(
        ref.conv1d_bwd_data_ref(_torch(g), _torch(w), dilation=dilation),
        jref.conv1d_bwd_data_ref(_jax(g), _jax(w), dilation=dilation),
        **F32_TOL)
    np.testing.assert_allclose(
        ref.conv1d_bwd_weight_ref(_torch(x), _torch(g), dilation=dilation),
        jref.conv1d_bwd_weight_ref(_jax(x), _jax(g), dilation=dilation),
        **GRAD_TOL)
    np.testing.assert_allclose(ref.conv1d_dbias_ref(_torch(g)),
                               g.sum(axis=(0, 2)), **F32_TOL)


@pytest.mark.parametrize("act", ["none", "relu", "gelu", "silu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_epilogue_cotangent_matches_jax(act, dtype):
    rng = np.random.default_rng(4)
    u = (3 * rng.standard_normal((2, 3, 17))).astype(np.float32)
    gout = rng.standard_normal((2, 3, 17)).astype(np.float32)
    dt = getattr(torch, dtype)
    y = epilogue.ACTIVATIONS[act](_torch(u))
    saved = {"none": None, "relu": y.to(dt), "gelu": _torch(u),
             "silu": _torch(u)}[act]
    got = epilogue.cotangent(act, saved, _torch(gout, dt))
    assert got.dtype == dt
    jsaved = None if saved is None else jnp.asarray(saved.float().numpy())
    want = jops._epilogue_cotangent(
        types.SimpleNamespace(activation=act), jsaved,
        jnp.asarray(_torch(gout, dt).float().numpy()))
    # fp32: where tanh saturates the two frameworks' tanh differ in the
    # last bit, which gelu's (1 - tanh^2) term turns into up to ~2e-6
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want), **tol)
    assert epilogue.needs_preact(act) == jops._needs_preact(act)


def test_save_preact_on_cpu_is_the_plain_version():
    x, w, b, r = _operands(3, 4, 3, 30, residual_q=30 - 2 * 4)
    before = conv1d_brgemm.conv1d_fwd.launches
    y, u = conv1d_brgemm.conv1d_fwd(
        _torch(x), _torch(w), bias=_torch(b), residual=_torch(r),
        activation="silu", save_preact=True, dilation=4)
    assert u.dtype == torch.float32
    assert torch.equal(u, ref.conv1d_preact_ref(
        _torch(x), _torch(w), bias=_torch(b), residual=_torch(r), dilation=4))
    assert torch.equal(y, ref.conv1d_fused_ref(
        _torch(x), _torch(w), bias=_torch(b), residual=_torch(r),
        activation="silu", dilation=4))
    assert conv1d_brgemm.conv1d_fwd.launches == before


@pytest.mark.parametrize("with_dbias", [False, True])
def test_conv1d_bwd_weight_on_cpu_is_the_plain_version(with_dbias):
    x, _, _, _ = _operands(3, 4, 3, 30)
    g = np.random.default_rng(5).standard_normal((2, 4, 22)).astype(
        np.float32)
    before = conv1d_brgemm.conv1d_bwd_weight.launches
    got = conv1d_brgemm.conv1d_bwd_weight(_torch(x), _torch(g), S=3,
                                          dilation=4, with_dbias=with_dbias)
    dw = ref.conv1d_bwd_weight_ref(_torch(x), _torch(g), dilation=4)
    if with_dbias:
        assert torch.equal(got[0], dw)
        assert torch.equal(got[1], ref.conv1d_dbias_ref(_torch(g)))
    else:
        assert torch.equal(got, dw)
    assert conv1d_brgemm.conv1d_bwd_weight.launches == before


def _bad_bwd_inputs():
    x, g = torch.zeros(2, 3, 20), torch.zeros(2, 4, 16)
    return {
        "dtype": (x.double(), g.double(), {}),
        "mixed_dtype": (x, g.bfloat16(), {}),
        "width": (x, torch.zeros(2, 4, 15), {}),
        "batch": (x, torch.zeros(3, 4, 16), {}),
        "noncontiguous": (torch.zeros(2, 20, 3).transpose(1, 2), g, {}),
        "dilation": (x, g, {"dilation": 0}),
    }


@pytest.mark.parametrize("what", sorted(_bad_bwd_inputs()))
def test_conv1d_bwd_weight_rejects_bad_inputs(what):
    x, g, kw = _bad_bwd_inputs()[what]
    kw = {"S": 3, "dilation": 2, **kw}
    with pytest.raises(ValueError):
        conv1d_brgemm.conv1d_bwd_weight(x, g, **kw)


@pytest.mark.parametrize("C,widest,want", [
    (15, 15, [(0, 15)]),
    (128, 108, [(0, 64), (64, 128)]),
    (1280, 108, [(i * 1280 // 12, (i + 1) * 1280 // 12) for i in range(12)]),
    (7, 1, [(i, i + 1) for i in range(7)]),
])
def test_bwd_weight_channel_ranges(C, widest, want):
    """The fewest contiguous ranges of near-equal width that fit (the
    kernel's footprint rule, here a widest width), covering [0, C)."""
    asked = []

    def fits(c):
        asked.append(c)
        return c <= widest

    got = conv1d_brgemm.channel_ranges(C, fits)
    assert got == want
    assert got[0][0] == 0 and got[-1][1] == C
    assert all(a[1] == b[0] for a, b in zip(got, got[1:]))
    assert all(0 < c1 - c0 <= widest for c0, c1 in got)
    assert len(got) == -(-C // widest)
    assert len(asked) <= 2 + C.bit_length()  # a bisection, not a scan
    with pytest.raises(ValueError, match="footprint"):
        conv1d_brgemm.channel_ranges(C + 1, lambda c: False)


@pytest.mark.parametrize("with_dbias", [False, True])
def test_bwd_weight_by_channel_ranges_is_the_whole_gradient(with_dbias):
    """One launch a channel range (the plain version standing in for the
    kernel) concatenates to the whole range's dw, bitwise; dbias from the
    first range; each range gets a contiguous copy of its channels."""
    rng = np.random.default_rng(8)
    x = _torch(rng.standard_normal((2, 10, 26)).astype(np.float32))
    g = _torch(rng.standard_normal((2, 4, 24)).astype(np.float32))
    calls = []

    def launch(xc, dbias):
        assert xc.is_contiguous()
        calls.append((xc.shape[1], dbias))
        return conv1d_brgemm.conv1d_bwd_weight(xc, g, S=3, dilation=1,
                                               with_dbias=dbias)

    got = conv1d_brgemm.by_channel_ranges(
        x, [(0, 3), (3, 6), (6, 10)], launch, with_dbias)
    want = conv1d_brgemm.conv1d_bwd_weight(x, g, S=3, dilation=1,
                                           with_dbias=with_dbias)
    assert calls == [(3, with_dbias), (3, False), (4, False)]
    if with_dbias:
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    else:
        assert torch.equal(got, want)
