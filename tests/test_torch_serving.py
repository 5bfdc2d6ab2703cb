"""The port's serving slice (``repro_torch``: configs, layer, AtacWorks stack,
streaming, serve-step factories, ``ConvStreamServer``) against the JAX
package, on the CPU.

The reduced AtacWorks config (C=8, S=9, dilation 8, 25 layers) with the
JAX package's initial weights and random non-zero biases, carried across
with ``convert.params_from_jax``, runs through both packages; the JAX side
uses its plain ``backend="ref"``.  Tolerance ``atol=rtol=1e-4`` (fp32, 25
layers summed in another order).  Within the port on the CPU a tolerance
too, not bitwise: torch's CPU einsum may block differently by width.
"""
from __future__ import annotations

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import reduced as jreduced
from repro.core import blocks as jblocks
from repro.core import streaming as jstreaming
from repro_torch import configs, convert
from repro_torch.configs.base import reduced
from repro_torch.core import blocks, streaming
from repro_torch.launch import serve

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(atol=1e-4, rtol=1e-4)
CHUNKS = [1, 7, 64, 29]
HIST = 32


@pytest.fixture(scope="module")
def cfgs():
    return jreduced(jconfigs.get("atacworks")), reduced(
        configs.get("atacworks"))


@pytest.fixture(scope="module")
def params(cfgs):
    """The JAX package's initial parameters with random non-zero biases
    (zeros at init would leave the bias path untested), as numpy."""
    jcfg, _ = cfgs
    tree = jax.tree.map(np.asarray,
                        jblocks.init_params(jax.random.key(0), jcfg))
    rng = np.random.default_rng(3)

    def with_bias(p):
        return {"w": p["w"], "b": (0.1 * rng.standard_normal(p["b"].shape)
                                   ).astype(np.float32)}

    tree = {"stem": with_bias(tree["stem"]),
            "res": [{k: with_bias(v) for k, v in blk.items()}
                    for blk in tree["res"]],
            "head_signal": with_bias(tree["head_signal"]),
            "head_peak": with_bias(tree["head_peak"])}
    return tree


@pytest.fixture(scope="module")
def models(cfgs, params):
    jcfg, cfg = cfgs
    model = blocks.init_params(cfg, seed=0)
    model.load_state_dict(convert.params_from_jax(params))
    return jax.tree.map(jnp.asarray, params), model


@pytest.fixture(scope="module")
def track():
    return np.random.default_rng(4).standard_normal(
        (2, HIST + sum(CHUNKS))).astype(np.float32)


def test_configs_match_jax():
    for name in ("atacworks", "atacworks-bf16"):
        j, t = jconfigs.get(name), configs.get(name)
        for f in ("name", "family", "conv_channels",
                  "conv_filter", "conv_dilation", "dtype"):
            assert getattr(t, f) == getattr(j, f), (name, f)
        jr, tr = jreduced(j), reduced(t)
        for f in ("name", "conv_channels", "conv_filter", "conv_dilation",
                  "dtype"):
            assert getattr(tr, f) == getattr(jr, f), (name, f)
    assert configs.names() == jconfigs.names() == [
        "atacworks", "atacworks-bf16", "deepseek-v3-671b", "internvl2-2b",
        "mamba2-370m", "moonshot-v1-16b-a3b", "qwen2-7b", "qwen3-14b",
        "qwen3-8b", "starcoder2-3b", "whisper-large-v3", "zamba2-7b"]


def test_lm_families_raise_not_implemented():
    """Every architecture of the JAX package has its config (the VLM was
    the last); the LM launcher's ``--model-parallel``, which shards the
    parameters in the JAX launcher, serves every LM family and still
    refuses the layouts with no explicit form: SSM heads that do not
    divide over the model ranks among them."""
    assert configs.get("internvl2-2b").family == "vlm"
    with pytest.raises(ValueError,
                       match="SSM heads do not divide.*queue A item 7"):
        serve.main(["--arch", "mamba2-370m", "--device", "cpu", "--smoke",
                    "--model-parallel", "32"])


def test_state_dict_mirrors_the_jax_tree(cfgs, params):
    _, cfg = cfgs
    model = blocks.init_params(cfg, seed=0)
    sd = convert.params_from_jax(params)
    assert set(sd) == set(model.state_dict())
    assert len(sd) == 2 * (2 * blocks.N_RES_BLOCKS + 3)
    for k, v in model.state_dict().items():
        assert v.shape == sd[k].shape and v.dtype == sd[k].dtype, k


def test_init_is_seeded_and_follows_the_jax_layout(cfgs):
    _, cfg = cfgs
    a, b = blocks.init_params(cfg, seed=5), blocks.init_params(cfg, seed=5)
    c = blocks.init_params(cfg, seed=6)
    for (k, va), vb, vc in zip(a.state_dict().items(),
                               b.state_dict().values(),
                               c.state_dict().values()):
        assert torch.equal(va, vb), k
        if k.endswith(".b"):
            assert not va.any(), k       # biases start at zero
        else:
            assert not torch.equal(va, vc), k
    C, S = cfg.conv_channels, cfg.conv_filter
    w = a.res[0].conv1.w
    assert w.shape == (S, C, C)      # (S, K, C)
    assert abs(w.std().item() - (C * S) ** -0.5) < 0.3 * (C * S) ** -0.5


def test_bf16_config_builds_bf16_params():
    model = blocks.init_params(reduced(configs.get("atacworks-bf16"),
                                       dtype="bfloat16"))
    assert {p.dtype for p in model.parameters()} == {torch.bfloat16}


@pytest.mark.parametrize("padding", ["CAUSAL", "SAME"])
def test_forward_matches_jax(cfgs, models, track, padding):
    jcfg, cfg = cfgs
    jparams, model = models
    want = jblocks.forward(jparams, jcfg, jnp.asarray(track),
                           padding=padding, backend="ref")
    with torch.inference_mode():
        got = model(torch.from_numpy(track), padding=padding)
    for g, w_ in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == track.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), **TOL)


def test_prefill_then_stream_matches_jax(cfgs, models, track):
    """Prefill a 32-sample history, then stream ragged chunks (1, 7, 64,
    29): every chunk's outputs and the final ring buffers against JAX's
    streaming, and the whole against JAX's one-shot CAUSAL forward."""
    jcfg, cfg = cfgs
    jparams, model = models
    x = torch.from_numpy(track)
    (jsig, jpeak), jstate = jstreaming.prefill(
        jparams, jcfg, jnp.asarray(track[:, :HIST]), backend="ref")
    with torch.inference_mode():
        (sig, peak), state = streaming.prefill(model, cfg, x[:, :HIST])
    sigs, peaks = [sig], [peak]
    np.testing.assert_allclose(sig.numpy(), np.asarray(jsig), **TOL)
    pos = HIST
    for c in CHUNKS:
        (jsig, jpeak), jstate = jstreaming.stream_step(
            jparams, jcfg, jstate, jnp.asarray(track[:, pos:pos + c]),
            backend="ref")
        with torch.inference_mode():
            (sig, peak), state = streaming.stream_step(
                model, cfg, state, x[:, pos:pos + c])
        np.testing.assert_allclose(sig.numpy(), np.asarray(jsig), **TOL)
        np.testing.assert_allclose(peak.numpy(), np.asarray(jpeak), **TOL)
        sigs.append(sig)
        peaks.append(peak)
        pos += c
    flat = list(serve._leaves(jstate))
    ours = list(serve._leaves(state))
    assert len(flat) == len(ours) == 2 * blocks.N_RES_BLOCKS + 3
    for j, t in zip(flat, ours):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)
    one_sig, one_peak = jblocks.forward(jparams, jcfg, jnp.asarray(track),
                                        padding="CAUSAL", backend="ref")
    np.testing.assert_allclose(torch.cat(sigs, 1).numpy(),
                               np.asarray(one_sig), **TOL)
    np.testing.assert_allclose(torch.cat(peaks, 1).numpy(),
                               np.asarray(one_peak), **TOL)


def _requests(n_streams, *, seed, lengths=None, hist_len=24,
              no_history=()):
    rng = np.random.default_rng(seed)
    reqs = []
    for rid in range(n_streams):
        n = lengths[rid] if lengths else int(rng.integers(20, 90))
        hist = rng.standard_normal(int(rng.integers(5, hist_len + 1)))
        reqs.append(serve.StreamRequest(
            rid, rng.standard_normal(n).astype(np.float32),
            history=None if rid in no_history else hist.astype(np.float32)))
    return reqs


def test_server_matches_oneshot(cfgs, models):
    """Ragged streams with short histories (left-padded to prompt_len),
    more streams than slots: every served stream is the one-shot causal
    forward over [history | track]."""
    _, cfg = cfgs
    _, model = models
    server = serve.ConvStreamServer(model, cfg, batch=2, chunk=16,
                                    prompt_len=24, device="cpu")
    reqs = _requests(3, seed=5)
    for r in reqs:
        server.submit(r)
    done = server.run()
    assert [r.id for r in done] == [0, 1, 2]
    assert server.chunks_run == len(server.chunk_times) > 0
    for r in done:
        sig, peak = r.result()
        assert sig.shape == peak.shape == r.track.shape
        want = serve.one_shot(model, cfg, r.track, server.context(r))
        np.testing.assert_allclose(sig, want[0], **TOL)
        np.testing.assert_allclose(peak, want[1], **TOL)


def test_server_matches_jax_server(cfgs, models):
    """The same requests through JAX's ConvStreamServer (plain backend) and
    the port's: ragged tracks, histories shorter than prompt_len (left-
    padded) and longer (cut), one stream without history, more streams
    than slots, non-zero biases.  Pins the port's own bookkeeping (context,
    slot reset, prefill copy, zero-padded last chunk, valid columns) to the
    reference server's."""
    from repro.launch import serve as jserve
    jcfg, cfg = cfgs
    jparams, model = models
    reqs = _requests(5, seed=7, hist_len=32, no_history={2})
    assert any(len(r.history) < 24 for r in reqs if r.history is not None)
    assert any(len(r.history) > 24 for r in reqs if r.history is not None)
    jserver = jserve.ConvStreamServer(jparams, jcfg, batch=2, chunk=16,
                                      prompt_len=24, backend="ref")
    server = serve.ConvStreamServer(model, cfg, batch=2, chunk=16,
                                    prompt_len=24, device="cpu")
    for r in reqs:
        jserver.submit(jserve.StreamRequest(r.id, r.track, history=r.history))
        server.submit(r)
    jdone, done = jserver.run(), server.run()
    assert [r.id for r in done] == [r.id for r in jdone] == list(range(5))
    assert server.chunks_run == jserver.chunks_run
    for j, t in zip(jdone, done):
        for got, want in zip(t.result(), j.result()):
            assert got.shape == want.shape == t.track.shape
            np.testing.assert_allclose(got, want, **TOL)


def test_server_slot_reuse_matches_serving_alone(cfgs, models):
    """A slot freed mid-run and re-admitted serves the same outputs as that
    stream served alone: with a new history (the prefill copy into the
    slot) and without one (the in-place slot reset), nothing of the
    previous stream is left behind."""
    _, cfg = cfgs
    _, model = models
    # slot 1: stream 1 (2 chunks), then stream 2 with a history (2 chunks),
    # then stream 3 without one, all while stream 0 runs in slot 0
    kw = dict(seed=6, lengths=[90, 20, 20, 40], no_history={3})
    reqs = _requests(4, **kw)
    server = serve.ConvStreamServer(model, cfg, batch=2, chunk=16,
                                    prompt_len=24, device="cpu")
    for r in reqs:
        server.submit(r)
    server.step()
    server.step()
    assert server.slots[1] is None and server.slots[0] is reqs[0]
    server.step()
    assert server.slots[1] is reqs[2]
    server.step()
    server.step()
    assert server.slots == [reqs[0], reqs[3]]
    server.run()
    assert all(r.done for r in reqs)
    for r in reqs:
        alone = _requests(4, **kw)[r.id]
        solo = serve.ConvStreamServer(model, cfg, batch=2, chunk=16,
                                      prompt_len=24, device="cpu")
        solo.submit(alone)
        solo.run()
        for got, want in zip(r.result(), alone.result()):
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
        # and both are the one-shot forward over the stream's own context
        for got, want in zip(r.result(), serve.one_shot(
                model, cfg, r.track, server.context(r))):
            np.testing.assert_allclose(got, want, **TOL)


def test_non_causal_padding_raises(cfgs, models):
    _, cfg = cfgs
    _, model = models
    with pytest.raises(streaming.StreamingUnsupported):
        streaming.validate_streamable("SAME")
    x = torch.zeros(1, 8)
    with pytest.raises(streaming.StreamingUnsupported):
        streaming.prefill(model, cfg, x, padding="SAME")
    state = streaming.init_stream_state(cfg, 1)
    with pytest.raises(streaming.StreamingUnsupported):
        streaming.stream_step(model, cfg, state, x, padding="VALID")
    with pytest.raises(SystemExit, match="streaming"):
        serve.main(["--arch", "atacworks", "--smoke", "--device", "cpu",
                    "--conv-padding", "same"])


def test_stream_state_layout(cfgs):
    _, cfg = cfgs
    state = streaming.init_stream_state(cfg, 3)
    span = streaming.layer_span(cfg)
    assert span == (cfg.conv_filter - 1) * cfg.conv_dilation
    assert streaming.receptive_field(cfg) == 25 * span
    bufs = list(serve._leaves(state))
    assert len(bufs) == 25
    assert bufs[0].shape == (3, 1, span)
    assert all(b.shape == (3, cfg.conv_channels, span) for b in bufs[1:])


def test_default_device_without_cuda_raises(cfgs, models):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    _, cfg = cfgs
    _, model = models
    with pytest.raises(RuntimeError, match="--device cpu"):
        serve.ConvStreamServer(model, cfg, batch=1, chunk=8)
    with pytest.raises(RuntimeError, match="--device cpu"):
        serve.main(["--arch", "atacworks", "--smoke"])


def test_cli_serves_on_cpu(capsys):
    rc = serve.main(["--arch", "atacworks", "--smoke", "--device", "cpu",
                     "--streams", "3", "--batch", "2", "--chunk", "32",
                     "--prompt-len", "16", "--track-len", "40"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "served 3 streams" in out and "smoke: stream 0" in out


_HYGIENE = r"""
import importlib, pkgutil, sys
sys.path[:0] = [{root!r}, {src!r}]
import repro_torch
mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                              "repro_torch.")]
# the training slice's modules by name, whether or not the walk finds them
named = ["repro_torch.launch.train", "repro_torch.train.train_step",
         "repro_torch.train.losses", "repro_torch.optim.adamw",
         "repro_torch.optim.schedule", "repro_torch.data.synthetic",
         "repro_torch.checkpoint.checkpoint", "repro_torch.models",
         "repro_torch.models.common", "repro_torch.models.mamba2",
         "repro_torch.configs.mamba2_370m", "repro_torch.models.transformer",
         "repro_torch.kernels.flash_attention",
         "repro_torch.configs.starcoder2_3b", "repro_torch.launch.serve",
         "repro_torch.train.serve_step", "repro_torch.convert",
         "repro_torch.launch.mesh", "repro_torch.kernels.sharded",
         "repro_torch.train.data_parallel", "repro_torch.optim.compression",
         "repro_torch.obs", "repro_torch.obs.report",
         "repro_torch.obs.trace_export", "repro_torch.runtime.health",
         "repro_torch.runtime.straggler", "repro_torch.runtime.faults",
         "repro_torch.runtime.elastic", "repro_torch.models.whisper",
         "repro_torch.configs.whisper_large_v3", "repro_torch.models.zamba2",
         "repro_torch.configs.zamba2_7b"]
assert set(named) <= set(mods), sorted(set(named) - set(mods))
for m in mods + named:
    importlib.import_module(m)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
print(len(mods))
"""


def test_port_imports_no_jax_and_no_repro():
    """Every module of the port (the training, Mamba2, transformer,
    data-parallel, telemetry, elastic, Whisper and Zamba2 slices' named) and
    chip_smoke.py import without jax or any module of the JAX package."""
    code = _HYGIENE.format(root=ROOT, src=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": ""})
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 32


def test_chip_smoke_refuses_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
