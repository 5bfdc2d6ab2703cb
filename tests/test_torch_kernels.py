"""Parity of the port's kernel modules (``repro_torch.kernels``) with the JAX
package, on the CPU.

The same numpy inputs, made from a seed, go through the JAX function and
its counterpart in the port.  On the CPU the port computes its plain
PyTorch version; the JAX side runs its Pallas kernel in interpret mode
(``backend="pallas"``) and its own plain version (``backend="ref"``).
Tolerances: ``atol=rtol=1e-5`` in fp32 (the two frameworks sum in another
order); ``2e-2`` for bf16, against JAX's fp32 math on bf16-rounded inputs.
The CUDA kernel itself is held against its plain version on the card by
``chip_smoke.py``.
"""
from __future__ import annotations

import os
import stat

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import epilogue as jep
from repro.kernels import ops as jops
from repro_torch.kernels import build, conv1d_brgemm, epilogue, ops, ref

F32_TOL = dict(atol=1e-5, rtol=1e-5)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)


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


def test_ops_docstring_example_runs():
    import doctest
    res = doctest.testmod(ops, optionflags=doctest.ELLIPSIS)
    assert res.attempted >= 2 and res.failed == 0
