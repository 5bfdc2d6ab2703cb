"""Parity of the port's tuner (``repro_torch.tune``) and its ``"auto"`` and
``"library"`` backends with the JAX package, on the CPU.

The presets, ``ConvProblem``'s derived views and cache keys must equal
``repro.tune``'s; the cache behaves as ``tests/test_tune.py`` holds the
JAX one to (round trip, a miss that measures nothing, atomic writes,
reload on a new mtime).  ``backend="auto"`` driven by a cache entry naming
``"library"`` for all three passes must give the JAX package's
``backend="xla"`` forward and gradients within ``atol=rtol=1e-5`` (fp32:
two libraries' sums in other orders).  On the CPU the kernels' place is
taken by the plain version (``"ref"``); the CUDA kernels' tiles, bodies
and the card's timing are checked on the card by ``chip_smoke.py``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.tune import presets as jpresets
from repro.tune import problem as jproblem
from repro_torch import tune
from repro_torch.kernels import conv1d_brgemm, ops
from repro_torch.tune import cost, measure, presets, space, sweep

TOL = dict(atol=1e-5, rtol=1e-5)
H100 = "NVIDIA H100 80GB HBM3"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def tmp_cache(tmp_path, monkeypatch):
    """The default cache is a fresh file for the test's duration."""
    path = str(tmp_path / "tune_cache.json")
    monkeypatch.setenv(tune.cache.ENV_CACHE_PATH, path)
    monkeypatch.delenv(tune.ENV_TUNE, raising=False)
    monkeypatch.delenv(ops.ENV_BACKEND, raising=False)
    tune.reset_default_cache()
    yield path
    tune.reset_default_cache()


def _no_measure(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("a candidate was timed on a cached/miss path")
    monkeypatch.setattr(measure, "time_candidate", boom)


# --- presets ---------------------------------------------------------------

@pytest.mark.parametrize("name", [
    "FIGSETS", "Q_SET", "Q_SET_FULL", "S_SET", "S_SET_FULL", "N", "SMOKE",
    "ATACWORKS_CELLS", "SERVING_CHUNKS", "SERVING_BATCHES",
    "SERVING_EPILOGUES"])
def test_preset_data_equals_jax(name):
    assert getattr(presets, name) == getattr(jpresets, name)


@pytest.mark.parametrize("gen", ["fig4", "fig5", "fig6", "fig5-full",
                                 "serving", "atacworks", "smoke", "mp2"])
def test_preset_work_lists_equal_jax(gen):
    def lists(mod):
        if gen.startswith("fig"):
            return list(mod.figset_shapes(gen.split("-")[0],
                                          full=gen.endswith("full")))
        if gen == "mp2":
            return list(mod.model_sharded_shapes(mod.ATACWORKS_CELLS, 2))
        return list(getattr(mod, f"{gen}_shapes")())
    assert lists(presets) == lists(jpresets)


# --- ConvProblem -------------------------------------------------------------

@pytest.mark.parametrize("pass_", ["fwd", "bwd_data", "bwd_weight"])
@pytest.mark.parametrize("depthwise,epilogue,dtype", [
    (False, "none", "float32"), (False, "b+relu+r", "bfloat16"),
    (True, "b+silu", "float32")])
def test_problem_views_and_key_equal_jax(pass_, depthwise, epilogue, dtype):
    kw = dict(N=4, C=16 if depthwise else 15, K=16 if depthwise else 24,
              S=51, dilation=8, Q=5000, padding="SAME",
              depthwise=depthwise, epilogue=epilogue, pass_=pass_)
    ours = tune.ConvProblem(dtype=getattr(torch, dtype), **kw)
    theirs = jproblem.ConvProblem(dtype=dtype, **kw)
    for view in ("span", "dtype_bytes", "q_out", "contraction", "n_filters",
                 "pass_epilogue", "dtype"):
        assert getattr(ours, view) == getattr(theirs, view), view
    assert ours.key(H100) == theirs.key(H100)
    assert ours.key("cpu") == theirs.key("cpu")
    assert (ours.with_pass("fwd").key("cpu")
            == theirs.with_pass("fwd").key("cpu"))


# --- the cache ---------------------------------------------------------------

TINY = dict(N=1, C=4, K=8, S=3, dilation=2, Q=64, dtype="float32")


def test_cache_roundtrip_hit_without_remeasure(tmp_cache, monkeypatch):
    cfg = tune.tune(**TINY, device="cpu", iters=1, warmup=1, top_k=2)
    assert cfg.source == "measured" and cfg.sec is not None
    assert cfg.backend in ("ref", "library")
    reloaded = tune.TuneCache(tmp_cache)  # a new process's view
    _no_measure(monkeypatch)
    monkeypatch.setenv(tune.ENV_TUNE, "1")  # even with tuning on
    hit = tune.get_config(**TINY, device="cpu", cache=reloaded)
    assert hit.source == "cache"
    assert (hit.backend, hit.tile, hit.body) == (cfg.backend, cfg.tile,
                                                 cfg.body)


def test_cache_miss_is_the_default_without_measuring(tmp_cache, monkeypatch):
    _no_measure(monkeypatch)
    cfg = tune.get_config(**TINY, device="cpu", pass_="bwd_weight")
    assert cfg == tune.TunedConfig("ref", None, None, "default")
    assert len(tune.get_default_cache()) == 0
    assert not os.path.exists(tmp_cache)


def test_cache_atomic_write_and_mtime_reload(tmp_cache):
    c1 = tune.TuneCache(tmp_cache)
    c1.put("k1", {"backend": "library"})
    c2 = tune.TuneCache(tmp_cache)
    assert c2.get("k1") == {"backend": "library"}
    c2.put("k2", {"backend": "cuda", "tile": 408})
    assert set(json.load(open(tmp_cache))) == {"k1", "k2"}
    os.utime(tmp_cache, (1, 1))  # another writer: a new mtime
    assert c1.get("k2") == {"backend": "cuda", "tile": 408}
    assert not [f for f in os.listdir(os.path.dirname(tmp_cache))
                if f.endswith(".tune.tmp")]


def test_default_cache_is_not_the_jax_packages(monkeypatch):
    monkeypatch.delenv(tune.cache.ENV_CACHE_PATH, raising=False)
    path = tune.cache.default_cache_path()
    assert path.endswith(os.path.join("repro_torch", "tune_cache.json"))


# --- "auto" and "library" against the JAX package's "xla" --------------------

def _put_library_plan(prob_kw, *, depthwise=False, epilogue="none"):
    for pass_ in tune.PASSES:
        prob = tune.ConvProblem(**prob_kw, depthwise=depthwise,
                                epilogue=epilogue, pass_=pass_)
        tune.get_default_cache().put(prob.key("cpu"), {
            "backend": "library", "tile": None, "body": None,
            "source": "measured", "sec": 1e-3})


def _operands(shape_x, shape_w, K, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape_x).astype(np.float32)
    w = (rng.standard_normal(shape_w) / np.sqrt(np.prod(shape_w[:-1]) + 1)
         ).astype(np.float32)
    b = (0.3 * rng.standard_normal(K)).astype(np.float32)
    r = rng.standard_normal((shape_x[0], K, shape_x[2])).astype(np.float32)
    return rng, x, w, b, r


def _torch_grads(fn, arrays, g):
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    y = fn(*ts)
    grads = torch.autograd.grad(y, ts, torch.tensor(g))
    return [y.detach().numpy()] + [t.numpy() for t in grads]


def _jax_grads(fn, arrays, g):
    y, vjp = jax.vjp(fn, *[jnp.asarray(a) for a in arrays])
    return [np.asarray(y)] + [np.asarray(t) for t in vjp(jnp.asarray(g))]


@pytest.mark.parametrize("act,has_b,has_r", [
    (None, False, False), ("relu", True, False), ("gelu", True, True)])
def test_auto_library_plan_matches_jax_xla(tmp_cache, monkeypatch, act,
                                           has_b, has_r):
    N, C, K, S, d, Q = 2, 6, 5, 5, 3, 80
    from repro_torch.kernels import epilogue as ep
    _put_library_plan(dict(N=N, C=C, K=K, S=S, dilation=d, Q=Q,
                           dtype="float32", padding="SAME"),
                      epilogue=ep.signature(has_b, act, has_r))
    _no_measure(monkeypatch)
    rng, x, w, b, r = _operands((N, C, Q), (S, K, C), K, 0)
    arrays = [x, w] + [b] * has_b + [r] * has_r

    def split(args):
        it = iter(args[2:])
        return dict(bias=next(it) if has_b else None,
                    residual=next(it) if has_r else None)

    def ours(*a):
        return ops.conv1d(a[0], a[1], activation=act, dilation=d,
                          padding="SAME", backend="auto", **split(a))

    def theirs(*a):
        return jops.conv1d(a[0], a[1], activation=act, dilation=d,
                           padding="SAME", backend="xla", **split(a))

    g = rng.standard_normal((N, K, Q)).astype(np.float32)
    for got, want in zip(_torch_grads(ours, arrays, g),
                         _jax_grads(theirs, arrays, g)):
        np.testing.assert_allclose(got, want, **TOL)
    plan = next(iter(tune.PLANS.values()))
    assert plan == (ops.PassConfig("library"),) * 3


# bf16: both sides sum in fp32 and round the result once to bf16, so an
# output differs by at most one bf16 ulp of the largest value (2^-7 of
# it).  The gradients may differ by more: for gelu and silu the port
# rounds du = act'(u) * dy to bf16 (as on the kernels' path) where JAX
# keeps it in fp32, one more 2^-8 relative rounding per term, and the
# result is rounded once more; measured at most 6.5e-3 of the largest
# value at these shapes, held to 2^-6.
BF16_Y_TOL, BF16_GRAD_TOL = 2.0 ** -7, 2.0 ** -6


def _bf16(a):
    return torch.tensor(a).to(torch.bfloat16).requires_grad_()


@pytest.mark.parametrize("act,has_b,has_r", [
    ("gelu", True, True), ("relu", True, False), ("silu", False, True),
    (None, False, False)])
def test_library_bf16_matches_jax_xla(act, has_b, has_r):
    """``"library"`` in bf16 computes as JAX's ``"xla"`` does: operands
    widened, the epilogue on the fp32 sum, one rounding of the result."""
    N, C, K, S, d, Q = 2, 6, 5, 5, 3, 80
    rng, x, w, b, r = _operands((N, C, Q), (S, K, C), K, 4)
    arrays = [x, w] + [b] * has_b + [r] * has_r
    g = rng.standard_normal((N, K, Q)).astype(np.float32)

    def split(args):
        it = iter(args[2:])
        return dict(bias=next(it) if has_b else None,
                    residual=next(it) if has_r else None)

    ts = [_bf16(a) for a in arrays]
    y = ops.conv1d(ts[0], ts[1], activation=act, dilation=d, padding="SAME",
                   backend="library", **split(ts))
    assert y.dtype == torch.bfloat16
    grads = torch.autograd.grad(y, ts, torch.tensor(g).to(torch.bfloat16))
    ours = [y.detach()] + list(grads)
    ja = [jnp.asarray(a, dtype=jnp.bfloat16) for a in arrays]
    yj, vjp = jax.vjp(lambda *a: jops.conv1d(
        a[0], a[1], activation=act, dilation=d, padding="SAME",
        backend="xla", **split(a)), *ja)
    theirs = [yj] + list(vjp(jnp.asarray(g, dtype=jnp.bfloat16)))
    for i, (got, want) in enumerate(zip(ours, theirs)):
        got = got.float().numpy()
        want = np.asarray(want).astype(np.float32)
        tol = BF16_Y_TOL if i == 0 else BF16_GRAD_TOL
        assert np.abs(got - want).max() <= tol * np.abs(want).max(), i


def test_library_bf16_matches_jax_xla_depthwise():
    N, C, S, d, Q = 2, 8, 4, 2, 70
    rng, x, w, b, _ = _operands((N, C, Q), (S, C), C, 5)
    g = rng.standard_normal((N, C, Q)).astype(np.float32)
    ts = [_bf16(a) for a in (x, w, b)]
    y = ops.depthwise_conv1d(ts[0], ts[1], bias=ts[2], activation="silu",
                             dilation=d, backend="library")
    ours = [y.detach()] + list(torch.autograd.grad(
        y, ts, torch.tensor(g).to(torch.bfloat16)))
    yj, vjp = jax.vjp(lambda x, w, b: jops.depthwise_conv1d(
        x, w, bias=b, activation="silu", dilation=d, backend="xla"),
        *[jnp.asarray(a, dtype=jnp.bfloat16) for a in (x, w, b)])
    theirs = [yj] + list(vjp(jnp.asarray(g, dtype=jnp.bfloat16)))
    for i, (got, want) in enumerate(zip(ours, theirs)):
        got = got.float().numpy()
        want = np.asarray(want).astype(np.float32)
        tol = BF16_Y_TOL if i == 0 else BF16_GRAD_TOL
        assert np.abs(got - want).max() <= tol * np.abs(want).max(), i


@pytest.mark.parametrize("padding", ["CAUSAL", "SAME"])
def test_auto_library_plan_matches_jax_xla_depthwise(tmp_cache, monkeypatch,
                                                     padding):
    N, C, S, d, Q = 2, 8, 4, 2, 70
    _put_library_plan(dict(N=N, C=C, K=C, S=S, dilation=d, Q=Q,
                           dtype="float32", padding=padding),
                      depthwise=True, epilogue="b+silu")
    _no_measure(monkeypatch)
    rng, x, w, b, _ = _operands((N, C, Q), (S, C), C, 1)

    def ours(x, w, b):
        return ops.depthwise_conv1d(x, w, bias=b, activation="silu",
                                    dilation=d, padding=padding,
                                    backend="auto")

    def theirs(x, w, b):
        return jops.depthwise_conv1d(x, w, bias=b, activation="silu",
                                     dilation=d, padding=padding,
                                     backend="xla")

    g = rng.standard_normal((N, C, Q)).astype(np.float32)
    for got, want in zip(_torch_grads(ours, [x, w, b], g),
                         _jax_grads(theirs, [x, w, b], g)):
        np.testing.assert_allclose(got, want, **TOL)


_ENV_CHILD = """
import sys
import numpy as np
import torch
from repro_torch import tune
from repro_torch.kernels import ops
x, w = (torch.from_numpy(np.load(f)) for f in sys.argv[1:3])
y = ops.conv1d(x, w, dilation=2, padding="CAUSAL")
np.save(sys.argv[3], y.numpy())
print(ops.default_backend(x), len(tune.PLANS))
"""


@pytest.mark.parametrize("env", ["auto", "library"])
def test_backend_env_is_honoured(tmp_cache, tmp_path, env):
    """``REPRO_CONV_BACKEND`` as the process starts with it (it is read
    once, when ``ops`` is imported) names the backend of a call that
    names none."""
    N, C, K, S, d, Q = 1, 4, 4, 3, 2, 96
    _put_library_plan(dict(N=N, C=C, K=K, S=S, dilation=d, Q=Q,
                           dtype="float32", padding="CAUSAL"))
    _, x, w, _, _ = _operands((N, C, Q), (S, K, C), K, 2)
    files = [str(tmp_path / f) for f in ("x.npy", "w.npy", "y.npy")]
    np.save(files[0], x)
    np.save(files[1], w)
    env_vars = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                    **{ops.ENV_BACKEND: env})
    out = subprocess.run([sys.executable, "-c", _ENV_CHILD, *files],
                         capture_output=True, text=True, env=env_vars,
                         cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    want = jops.conv1d(jnp.asarray(x), jnp.asarray(w), dilation=d,
                       padding="CAUSAL", backend="xla")
    np.testing.assert_allclose(np.load(files[2]), np.asarray(want), **TOL)
    assert out.stdout.split() == [env, "1" if env == "auto" else "0"]


def test_auto_reads_the_cache_file_once(tmp_cache, monkeypatch):
    N, C, K, S, d, Q = 1, 4, 4, 3, 2, 64
    _put_library_plan(dict(N=N, C=C, K=K, S=S, dilation=d, Q=Q,
                           dtype="float32", padding="SAME"))
    tune.reset_default_cache()  # forget the entries the writer holds
    loads = []
    real = json.load
    monkeypatch.setattr(tune.cache.json, "load",
                        lambda f: loads.append(f.name) or real(f))
    x, w = torch.randn(N, C, Q), torch.randn(S, K, C)
    first = ops.conv1d(x, w, dilation=d, backend="auto")
    for _ in range(99):
        assert torch.equal(ops.conv1d(x, w, dilation=d, backend="auto"),
                           first)
    assert loads == [tmp_cache]
    tune.reset_default_cache()
    assert not tune.PLANS


def test_auto_miss_on_cpu_runs_the_plain_version(tmp_cache, monkeypatch):
    _no_measure(monkeypatch)
    x, w = torch.randn(2, 3, 50), torch.randn(5, 4, 3)
    got = ops.conv1d(x, w, dilation=2, backend="auto")
    assert torch.equal(got, ops.conv1d(x, w, dilation=2, backend="ref"))
    assert next(iter(tune.PLANS.values())) == (ops.PassConfig("ref"),) * 3


# --- space and cost model ----------------------------------------------------

@pytest.mark.parametrize("pass_", ["fwd", "bwd_data", "bwd_weight"])
def test_cost_model_never_ranks_cuda_on_the_cpu(pass_):
    prob = tune.ConvProblem(**TINY, pass_=pass_)
    cands = space.enumerate_candidates(prob, device_kind="cpu")
    assert {c.backend for c in cands} == {"ref", "library"}
    ranked = cost.rank(cands, prob, device_kind="cpu")
    assert ranked[0].backend == "library"  # oneDNN before the tap loop
    # on a card: the instantiated knobs that the kernel's rule allows
    allow = {"fwd": lambda p, c: c.tile != 104,
             "bwd_data": lambda p, c: True,
             "bwd_weight": lambda p, c: c.body == "unit"}[pass_]
    gpu = space.enumerate_candidates(prob, device_kind=H100, allowed=allow)
    want = {"fwd": [616, 408, 204], "bwd_data": [616, 408, 204, 104],
            "bwd_weight": ["unit"]}[pass_]
    assert [c.tile or c.body for c in gpu if c.backend == "cuda"] == want
    assert gpu[-1] == space.Candidate("library")
    assert all(cost.estimate_seconds(c, prob, device_kind=H100) > 0
               for c in gpu)


def test_kernel_shape_of_bwd_data_swaps_channels_and_filters():
    prob = tune.ConvProblem(N=4, C=1, K=15, S=51, dilation=8, Q=1000,
                            dtype="float32", pass_="bwd_data")
    assert space.kernel_shape(prob) == (4, 15, 1, 51, 1000 + 800, 8)
    assert space.cuda_candidates(prob)[0].tile == 1601  # one filter out


# --- tile and body pins ------------------------------------------------------

@pytest.mark.parametrize("pin", [{"tile": 512}, {"tile": 616}])
def test_fwd_tile_pin_is_validated_and_ignored_on_cpu(pin):
    x, w = torch.randn(2, 3, 40), torch.randn(5, 4, 3)
    if pin["tile"] not in conv1d_brgemm.FWD_TILES:
        with pytest.raises(ValueError, match="unknown conv1d_fwd tile"):
            conv1d_brgemm.conv1d_fwd(x, w, dilation=2, **pin)
        return
    assert torch.equal(conv1d_brgemm.conv1d_fwd(x, w, dilation=2, **pin),
                       conv1d_brgemm.conv1d_fwd(x, w, dilation=2))


@pytest.mark.parametrize("body", ["wide", "taps"])
def test_bwd_weight_body_pin_is_validated_and_ignored_on_cpu(body):
    x, g = torch.randn(2, 3, 48), torch.randn(2, 4, 40)
    if body not in conv1d_brgemm.BWD_BODIES:
        with pytest.raises(ValueError, match="unknown conv1d_bwd_weight"):
            conv1d_brgemm.conv1d_bwd_weight(x, g, S=5, dilation=2, body=body)
        return
    assert torch.equal(
        conv1d_brgemm.conv1d_bwd_weight(x, g, S=5, dilation=2, body=body),
        conv1d_brgemm.conv1d_bwd_weight(x, g, S=5, dilation=2))


def test_depthwise_has_no_tile_to_pin():
    with pytest.raises(ValueError, match="no tile"):
        ops.depthwise_conv1d(torch.randn(1, 4, 20), torch.randn(3, 4),
                             tile=616)


@pytest.mark.parametrize("pass_", ["fwd", "bwd_data", "bwd_weight"])
def test_time_candidate_runs_each_pass_on_cpu(pass_):
    prob = tune.ConvProblem(**TINY, padding="SAME", epilogue="b+relu",
                            pass_=pass_)
    for cand in (space.Candidate("ref"), space.Candidate("library")):
        sec = measure.time_candidate(cand, prob, device=torch.device("cpu"),
                                     iters=2, warmup=1)
        assert 0 < sec < 10


# --- the command line and the sweep ------------------------------------------

def test_cli_writes_every_pass_of_fig4(tmp_path):
    path = tmp_path / "c.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.tune",
                          "--figset", "fig4", "--device", "cpu",
                          "--cache", str(path)],
                         capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    entries = json.load(open(path))
    assert len(entries) == 27  # 9 cells x 3 passes
    assert {e["source"] for e in entries.values()} == {"cost"}
    assert sum("|pass:bwd_weight" in k for k in entries) == 9


def test_sweep_rehearses_on_cpu(tmp_path, monkeypatch):
    """The sweep's control flow at a tiny size: checks (the plain version's
    stand-in, the library and auto against plain), tuning every
    candidate, auto bitwise to its pinned plan, rows and the figure
    summary (host times only: no efficiency or bound off the card)."""
    monkeypatch.setattr(sweep, "cells", lambda figsets, full: iter([
        ("fig4", dict(N=2, C=3, K=4, S=3, dilation=2, Q=40,
                      dtype="float32", padding="SAME")),
        ("fig6", dict(N=1, C=4, K=4, S=5, dilation=1, Q=30,
                      dtype="bfloat16", padding="SAME"))]))
    res = sweep.run(device="cpu", cache=str(tmp_path / "c.json"), iters=1)
    assert res["device"] == "cpu"
    assert all(c["auto_bitwise_to_pinned"] for c in res["checks"])
    assert all(len(c["library_errs"]) == len(c["auto_errs"]) == 3
               for c in res["checks"])
    modes = {r["mode"] for r in res["rows"]}
    assert modes == {f"{m}-{b}" for m in ("fwd", "fwdbwd")
                     for b in ("ref", "library", "auto")} | {"fwd-cudnn"}
    assert all(r["efficiency"] is None for r in res["rows"])
    assert all(r["bound_ms"] is None for r in res["rows"]
               if r["mode"].startswith("fwd-"))
    assert set(res["summary"]) == {"fig4", "fig6"}
    fig4 = res["summary"]["fig4"]
    assert fig4["fwd"]["cells"] == 1
    assert set(fig4["cost_pick_is_winner"]) == set(tune.PASSES)


# --- the device rule ---------------------------------------------------------

@pytest.mark.parametrize("entry", ["as_device", "device_kind", "get_config",
                                   "get_plan", "tune", "sweep"])
def test_entry_points_need_a_card_unless_asked(tmp_cache, monkeypatch,
                                               entry):
    """As the launchers: without a card and without ``device="cpu"`` the
    tuner's entry points raise instead of timing on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    call = {"as_device": tune.as_device, "device_kind": tune.device_kind,
            "get_config": lambda: tune.get_config(**TINY),
            "get_plan": lambda: tune.get_plan(**TINY),
            "tune": lambda: tune.tune(**TINY, measure=False),
            "sweep": lambda: sweep.run(iters=1)}[entry]
    with pytest.raises(RuntimeError, match="--device cpu"):
        call()
    assert not os.path.exists(tmp_cache)
    assert tune.as_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("module", ["repro_torch.tune",
                                    "repro_torch.tune.sweep"])
def test_cli_needs_a_card_unless_asked(tmp_path, module):
    path = tmp_path / "c.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m", module, "--figset", "fig4",
                          "--cache", str(path)],
                         capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=300)
    assert out.returncode != 0
    assert "--device cpu" in out.stderr
    assert not path.exists()


def test_get_plan_measures_only_the_forward_on_a_miss(tmp_cache,
                                                      monkeypatch):
    monkeypatch.setenv(tune.ENV_TUNE, "1")
    seen = []

    def fake(prob, **kw):
        seen.append(prob.pass_)
        return tune.TunedConfig("library", None, None, "measured", 1e-3)

    monkeypatch.setattr(tune, "tune_problem", fake)
    plan = tune.get_plan(**TINY, device="cpu")
    assert seen == ["fwd"]
    assert plan["fwd"].backend == "library"
    assert plan["bwd_data"] == plan["bwd_weight"] == tune.TunedConfig(
        "ref", None, None, "default")


# --- the default path ----------------------------------------------------------

@pytest.mark.parametrize("depthwise", [False, True])
def test_default_path_calls_the_wrappers_directly(monkeypatch, depthwise):
    """With no plan the autograd Functions call the kernel wrappers
    themselves, as before the tuner existed: no pass dispatch runs (on
    CPU tensors the wrappers run their plain versions)."""
    def boom(*a, **k):
        raise AssertionError("pass dispatch on the default path")

    for name in ("_fwd_pass", "_bwd_data_pass", "_bwd_weight_pass",
                 "_plan"):
        monkeypatch.setattr(ops, name, boom)
    gen = torch.Generator().manual_seed(3)
    C, S, d = 4, 3, 2
    x = torch.randn(2, C, 40 + (S - 1) * d, generator=gen,
                    requires_grad=True)
    w = torch.randn((S, C) if depthwise else (S, 5, C), generator=gen,
                    requires_grad=True)
    b = torch.randn(C if depthwise else 5, generator=gen, requires_grad=True)
    fused = ops.fused_depthwise_conv1d if depthwise else ops.fused_conv1d
    ref = ops.depthwise_conv1d if depthwise else ops.conv1d
    y = fused(x, w, bias=b, activation="gelu", dilation=d)
    want = ref(x, w, bias=b, activation="gelu", dilation=d,
               padding="VALID", backend="ref")
    g = torch.randn(y.shape, generator=gen)
    got = torch.autograd.grad(y, (x, w, b), g)
    expect = torch.autograd.grad(want, (x, w, b), g)
    for u, v in zip((y, *got), (want, *expect)):
        torch.testing.assert_close(u, v, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("module", ["repro_torch.tune",
                                    "repro_torch.kernels.ops"])
def test_docstring_examples_run(tmp_cache, module):
    import doctest
    import importlib
    res = doctest.testmod(importlib.import_module(module))
    assert res.attempted > 0 and res.failed == 0
