"""Parity of the port's roofline arithmetic (``repro_torch.roofline``) with
the JAX package's (``repro.roofline``), on the CPU: the conv layer's
operation and byte counts, the model counts of every ported config (a
decode step's bytes beside the two terms JAX's count gets wrong), a
decode step's cache bytes against the port's own cache, and the H100 peaks
and bounds that ``chip_smoke.py`` states (the values its phase 4 printed
before the bounds moved here must not move).  Counts are integers carried
in floats: equal exactly."""
from __future__ import annotations

import pytest
import torch

from repro.configs import get as jget
from repro.roofline import flops as jflops
from repro_torch import configs
from repro_torch.configs.base import reduced
from repro_torch.roofline import analysis, flops
from repro_torch.train import serve_step

CONV_SHAPES = [(4, 15, 15, 51, 5000), (4, 64, 64, 25, 20000),
               (8, 1, 15, 51, 60000)]


@pytest.mark.parametrize("shape", CONV_SHAPES)
def test_conv1d_flops_match_jax(shape):
    assert flops.conv1d_flops(*shape) == jflops.conv1d_flops(*shape)


@pytest.mark.parametrize("dilation,es", [(8, 4), (4, 2)])
def test_conv1d_min_bytes_match_jax(dilation, es):
    for N, C, K, S, Q in CONV_SHAPES:
        assert (flops.conv1d_min_bytes(N, C, K, S, Q, dilation, es)
                == jflops.conv1d_min_bytes(N, C, K, S, Q, dilation, es))


@pytest.mark.parametrize("arch", configs.names())
def test_model_counts_match_jax(arch):
    cfg, jcfg = configs.get(arch), jget(arch)
    assert flops.param_count(cfg) == jflops.param_count(jcfg)
    for kind, T, B in (("train", 4096, 8), ("prefill", 2048, 4),
                       ("decode", 4096, 16)):
        shape = flops.StepShape(kind, T, B)
        assert flops.model_flops(cfg, shape) == jflops.model_flops(
            jcfg, shape), kind
        want = jflops.model_bytes(jcfg, shape)
        if kind == "decode" and cfg.family != "conv":
            # JAX's count reads the whole untied table and leaves out the
            # SSM's conv window (read and written); an
            # encoder-decoder's decode reads no encoder weight and reads
            # the cross K/V (bf16), which JAX's count leaves out
            if not cfg.tie_embeddings:
                want -= 2 * (cfg.vocab_size - B) * cfg.d_model
            if cfg.family == "encdec":
                per_layer = (jflops._attn_params(jcfg)
                             + jflops._mlp_params(jcfg, jcfg.d_ff))
                want -= 2 * cfg.n_encoder_layers * per_layer
                want += 2 * B * cfg.encoder_width * 2 * cfg.n_heads \
                    * cfg.head_dim * cfg.n_layers
            if cfg.family in ("ssm", "hybrid"):
                # a hybrid's conv window is fp32, whatever the cache's dtype
                s = cfg.ssm
                conv_dim = s.expand * cfg.d_model + 2 * s.n_groups * s.d_state
                nbytes = 4 if cfg.family == "hybrid" else 2
                want += 2 * nbytes * B * (s.conv_width - 1) * conv_dim \
                    * cfg.n_layers
        assert flops.model_bytes(cfg, shape) == want, kind


@pytest.mark.parametrize("arch", ["mamba2-370m", "starcoder2-3b",
                                  "whisper-large-v3"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_decode_cache_bytes_are_the_caches(arch, dtype):
    """A decode step's cache bytes are those of the port's own cache
    (``make_cache``): an SSM's leaves each read and written, a KV cache of
    ``seq_len`` positions read once (the new row written in its place),
    and an encoder-decoder's cross K/V read once."""
    cfg = reduced(configs.get(arch))
    B, T = 3, 7
    cache = serve_step.make_cache(cfg, B, T, dtype=dtype)
    leaves = cache["dense"].values() if "dense" in cache else cache.values()
    nbytes = sum(t.numel() * t.element_size() for t in leaves)
    got = flops.decode_cache_bytes(cfg, B, T, dtype.itemsize)
    assert got == (2 * nbytes if cfg.family == "ssm" else nbytes)


def test_peaks_by_device_name():
    h100 = analysis.peaks_for("NVIDIA H100 80GB HBM3")
    assert (h100.float32, h100.tf32, h100.bfloat16, h100.bytes_per_s) == (
        67e12, 495e12, 989e12, 3.35e12)
    assert not analysis.is_gpu("cpu") and analysis.is_gpu("NVIDIA H100")
    assert analysis.achieved_fraction_of_peak(
        2e9, 1e-3, "NVIDIA H100 80GB HBM3") == 2e12 / 67e12
    assert analysis.achieved_fraction_of_peak(
        2e9, 1e-3, "NVIDIA H100 80GB HBM3", "bfloat16") == 2e12 / 989e12


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA A100-SXM4-80GB",
                                  "Tesla V100-SXM2-16GB"])
def test_peaks_refuse_a_device_they_do_not_know(kind):
    """No share of a made-up peak: the host and unknown cards raise."""
    with pytest.raises(ValueError, match="no peaks known"):
        analysis.peaks_for(kind)
    with pytest.raises(ValueError, match="no peaks known"):
        analysis.achieved_fraction_of_peak(2e9, 1e-3, kind)


# phase 4 of chip_smoke.py at batch 8 x 60,000, S 51, d 8: the 15->15
# forward (FMA-bound), its weight gradient in three TF32 terms, and the
# stem's (bound by its bytes), as phase 4 printed them
@pytest.mark.parametrize("what,want_ms,by", [
    ("fwd 15->15", 0.1644, "operations"),
    ("bwd_weight 15->15 tf32", 0.0668, "operations"),
    ("bwd_weight stem tf32", 0.0092, "bytes")])
def test_bounds_stay_what_chip_smoke_printed(what, want_ms, by):
    N, Q, S, d = 8, 60000, 51, 8
    Wp = Q + (S - 1) * d
    if what.startswith("fwd"):
        ms, got_by = analysis.conv1d_fwd_bound(N, 15, 15, S, Wp, Q,
                                               "float32", True, False, 4)
    else:
        C, K = (15, 15) if "15->15" in what else (1, 15)
        nbytes = (N * C * Wp + N * K * Q) * 4 + (S * K * C + K) * 4
        ms, got_by = analysis.bound(analysis.tf32_flops(N, C, K, S, Q),
                                    nbytes, "tf32")
    assert round(ms, 4) == want_ms and got_by == by
