"""Gradient compression with error feedback (``repro_torch.optim.
compression``, ``make_train_step(grad_compression=True)`` and the
checkpoint's ``ef`` leaves) against the JAX package on the CPU.

``compress``/``decompress`` take the same numpy gradients and buffers in
both packages and must agree bitwise: both round fp32 to bf16 to nearest
even (ties included).  A NaN must stay a NaN in the same places; its bits
are not a value (the host's fp32 add may set the sign of a NaN).  The
train step runs the reduced AtacWorks config (JAX's initial weights,
random non-zero biases) for three steps from the same state on the same
batches as JAX's jitted step: losses within rtol 1e-5, gradient norms
within rtol 1e-4, parameters within 1e-5 absolute, and the error feedback
within ``EF_TOL`` = 2^9 x 1e-5 of each leaf's largest value: the buffer
is a gradient's bf16 rounding residual, at most 2^-9 of the gradient, so
gradients that agree within 1e-5 of the largest one (as the port's do
with JAX's) leave residuals that agree within 2^9 x 1e-5 of the largest
residual.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint import checkpoint as jckpt
from repro.configs.base import reduced as jreduced
from repro.core import blocks as jblocks
from repro.optim import compression as jcompression
from repro.train import train_step as jtrain_step
from repro_torch import configs, convert
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs.base import reduced
from repro_torch.core import blocks
from repro_torch.data import synthetic
from repro_torch.optim import compression
from repro_torch.train.train_step import init_state, make_train_step

LR = 1e-3
EF_TOL = 2 ** 9 * 1e-5


@pytest.fixture(scope="module")
def cfgs():
    return jreduced(jconfigs.get("atacworks")), reduced(
        configs.get("atacworks"))


@pytest.fixture(scope="module")
def jparams(cfgs):
    tree = jax.tree.map(np.asarray,
                        jblocks.init_params(jax.random.key(0), cfgs[0]))
    rng = np.random.default_rng(3)

    def with_bias(p):
        return {"w": p["w"], "b": (0.1 * rng.standard_normal(p["b"].shape)
                                   ).astype(np.float32)}

    return {"stem": with_bias(tree["stem"]),
            "res": [{k: with_bias(v) for k, v in blk.items()}
                    for blk in tree["res"]],
            "head_signal": with_bias(tree["head_signal"]),
            "head_peak": with_bias(tree["head_peak"])}


def _grads_np(seed):
    """Gradients and buffers over many magnitudes, with values on bf16
    rounding ties (the low 16 bits exactly 0x8000, both parities of the
    kept bit) and non-finite values.  The ties are normal numbers whose
    residuals are normal too: XLA's host code flushes subnormal results to
    zero, PyTorch's keeps them, and neither is the rounding rule."""
    rng = np.random.default_rng(seed)
    g = (rng.standard_normal((6, 257)) * 10.0 ** rng.integers(
        -8, 4, (6, 257))).astype(np.float32)
    sign = rng.integers(0, 2, 64, dtype=np.uint32) << 31
    exponent = rng.integers(64, 190, 64, dtype=np.uint32) << 23
    kept = rng.integers(0, 1 << 7, 64, dtype=np.uint32) << 16
    g[0, :64] = (sign | exponent | kept | 0x8000).view(np.float32)
    g[1, :3] = [np.inf, -np.inf, np.nan]
    e = (1e-3 * rng.standard_normal((6, 257))).astype(np.float32)
    e[0, :64] = 0.0  # keep the ties ties
    return {"a": g, "b": g[2].copy()}, {"a": e, "b": e[3].copy()}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compress_is_bitwise_the_jax_packages(seed):
    g, e = _grads_np(seed)
    jq, je = jcompression.compress(jax.tree.map(jnp.asarray, g),
                                   jax.tree.map(jnp.asarray, e))
    q, ne = compression.compress({k: torch.from_numpy(v) for k, v in g.items()},
                                 {k: torch.from_numpy(v) for k, v in e.items()})
    for k in g:
        assert q[k].dtype == torch.bfloat16 and ne[k].dtype == torch.float32
        got = [q[k].float().numpy(), ne[k].numpy(),
               compression.decompress(q)[k].numpy()]
        want = [np.asarray(jq[k].astype(jnp.float32)), np.asarray(je[k]),
                np.asarray(jcompression.decompress(jq)[k])]
        for a, b in zip(got, want):
            nan = np.isnan(b)
            np.testing.assert_array_equal(np.isnan(a), nan, err_msg=k)
            np.testing.assert_array_equal(a[~nan].view(np.int32),
                                          b[~nan].view(np.int32), err_msg=k)


def test_error_feedback_starts_at_zero(cfgs):
    _, cfg = cfgs
    model = blocks.init_params(cfg)
    ef = compression.init_error_feedback(dict(model.named_parameters()))
    assert len(ef) == 50
    for k, p in model.named_parameters():
        assert ef[k].shape == p.shape and ef[k].dtype == torch.float32
        assert not ef[k].any()
    assert init_state(model).ef is None


def _batch(i):
    return synthetic.atacseq_batch(np.random.default_rng(200 + i), 4, 256)


def test_three_compressed_steps_match_jax(cfgs, jparams):
    jcfg, cfg = cfgs
    kw = dict(peak_lr=LR, warmup_steps=2, total_steps=3)
    jstate = jtrain_step.init_state(jax.tree.map(jnp.asarray, jparams),
                                    grad_compression=True)
    jstep = jax.jit(jtrain_step.make_train_step(jcfg, grad_compression=True,
                                                **kw))
    model = blocks.init_params(cfg)
    model.load_state_dict(convert.params_from_jax(jparams))
    state = init_state(model, grad_compression=True)
    step = make_train_step(cfg, grad_compression=True, **kw)
    for i in range(3):
        b = _batch(i)
        jstate, jm = jstep(jstate, b)
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(m["grad_norm"].item(),
                                   float(jm["grad_norm"]), rtol=1e-4)
        assert m["skipped"].item() == float(jm["skipped"]) == 0.0
    want = convert.params_from_jax(jax.tree.map(np.asarray, jstate.params))
    for k, p in state.params.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[k].numpy(),
                                   atol=1e-5, rtol=0, err_msg=k)
    want_ef = convert.params_from_jax(jax.tree.map(np.asarray, jstate.ef))
    assert set(state.ef) == set(want_ef)
    for k, e in state.ef.items():
        scale = want_ef[k].abs().max().item()
        assert e.abs().max() > 0 and scale > 0, k
        np.testing.assert_allclose(e.numpy(), want_ef[k].numpy(),
                                   atol=EF_TOL * scale, rtol=0, err_msg=k)


def test_compression_without_error_feedback_raises(cfgs):
    _, cfg = cfgs
    state = init_state(blocks.init_params(cfg))
    step = make_train_step(cfg, grad_compression=True)
    with pytest.raises(ValueError, match="grad_compression=True"):
        step(state, {k: torch.from_numpy(v) for k, v in _batch(0).items()})


def _trained(cfg, jparams, steps=2):
    model = blocks.init_params(cfg)
    model.load_state_dict(convert.params_from_jax(jparams))
    state = init_state(model, grad_compression=True)
    step = make_train_step(cfg, grad_compression=True, peak_lr=LR,
                           warmup_steps=1, total_steps=4)
    for i in range(steps):
        state, _ = step(state, {k: torch.from_numpy(v)
                                for k, v in _batch(i).items()})
    return state


def test_checkpoint_with_ef_port_writes_jax_restores(cfgs, jparams,
                                                     tmp_path):
    jcfg, cfg = cfgs
    state = _trained(cfg, jparams)
    ckpt.Checkpointer(str(tmp_path)).save(state, 2)
    template = jtrain_step.init_state(
        jblocks.init_params(jax.random.key(1), jcfg), grad_compression=True)
    flat = jckpt._flatten(jckpt.Checkpointer(str(tmp_path)).restore(template))
    ours = ckpt.state_tensors(state)
    assert set(flat) == set(ours) and len(flat) == 202
    assert sum(k.startswith(".ef/") for k in flat) == 50
    for k, t in ours.items():
        np.testing.assert_array_equal(np.asarray(flat[k]),
                                      t.detach().numpy(), err_msg=k)


def test_checkpoint_with_ef_jax_writes_port_restores(cfgs, jparams,
                                                     tmp_path):
    jcfg, cfg = cfgs
    jstate = jtrain_step.init_state(jax.tree.map(jnp.asarray, jparams),
                                    grad_compression=True)
    jstep = jax.jit(jtrain_step.make_train_step(
        jcfg, grad_compression=True, peak_lr=LR, warmup_steps=1,
        total_steps=4))
    for i in range(2):
        jstate, _ = jstep(jstate, _batch(i))
    jckpt.Checkpointer(str(tmp_path)).save(jstate, 2)
    state = ckpt.Checkpointer(str(tmp_path)).restore(
        init_state(blocks.init_params(cfg, seed=9), grad_compression=True))
    flat = jckpt._flatten(jax.tree.map(np.asarray, jstate))
    got = ckpt.state_tensors(state)
    assert set(got) == set(flat) and len(got) == 202
    for k, t in got.items():
        np.testing.assert_array_equal(t.detach().numpy(), np.asarray(flat[k]),
                                      err_msg=k)
