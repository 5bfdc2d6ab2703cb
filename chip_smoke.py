#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--out results/chip_smoke.json]

Phases (any failed check raises, so the run exits non-zero):
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
     build the six CUDA kernels' libraries from the checkout's sources, in
     parallel and timed, with ptxas' registers, spills and warnings (no
     kernel of ``conv1d_fwd``, ``depthwise_conv1d_fwd`` or
     ``conv1d_bwd_weight`` may spill); count the HGMMA (wgmma)
     instructions of each flash and each ``conv1d_bwd_weight`` kernel in
     the libraries' SASS (``cuobjdump -sass``): the bf16 flash kernels and
     every ``bwd_weight_partial`` kernel (the fp32 ones run three TF32
     terms) must have some; the FFMA and LDS instructions of each
     ``conv1d_fwd`` kernel's main loop, and the instructions, HGMMA and LDS
     of each ``bwd_weight_partial`` kernel's main loop;
  2. the kernel ``conv1d_fwd`` against its plain PyTorch version on the
     card at every layer shape of the serving path (stem 1->15, conv1,
     conv2 with residual, the two 15->1 heads), at the stream-step shape
     (4 slots x chunk 4096 over a 400 + 4096 window) and at the one-shot
     causal width 60,000, in fp32; the same in bf16 at C=K=16; gelu, silu
     and SAME padding once each; two generic cases (fig5: fp32 C=K=64,
     d=1, S=25; fig6: bf16 C=K=32, d=4, S=51; batch 4 x 5,000), checked
     only.  Device times (CUDA graphs replayed between CUDA events) of the
     kernel, the plain version and ``F.conv1d`` (weights permuted to (K,
     C, S), cuDNN TF32 off) beside the least time the card could take,
     the rate (GFLOP/s), the share of the bound and the register tile the
     launch took, and the time of one call as a caller sees it (host work
     included); at the stream step also the host time of one call through
     ``ops.conv1d`` (as the server makes it) beside the bare wrapper's;
  3. serve the full ``atacworks`` config (C=K=15, S=51, d=8, 25 layers;
     seeded weights, random non-zero biases) with ``ConvStreamServer``: 4
     slots, chunk 4096, 4096-sample histories, 8 queued ragged streams of
     about 50,000 samples; both outputs of every served stream must equal
     the one-shot causal forward through the kernel bitwise, and stream 0
     the plain forward within atol=rtol=1e-4; the kernel must have
     launched 25 times per stream step.  The same streams are then served
     again SERVE_REPEATS times, so chunk p50/p99 and samples/s are read
     per run and pooled, with their spread between runs;
  4. the training path's kernels at every layer shape it runs (batch 8 x
     width 60,000, SAME, fp32: stem 1->15, conv 15->15, the 15->1 heads):
     the forward, bwd-data through ``conv1d_fwd`` (the padded cotangent
     against the flipped, transposed weights) and ``conv1d_bwd_weight``
     with and without dbias, each against its plain version, with device,
     call, plain and library times (cuDNN's gradients through
     ``torch.nn.grad``, TF32 off) beside the bound, with the rate, the
     share of the bound and the forward's tile; each bwd-weight row has
     two bounds: the three-term TF32 bound its tensor-core body answers to
     (the bytes, or three products of the unpadded (S*C, K) GEMM at 495
     TFLOP/s) and the fp32 FMA bound of the kernel it replaced,
     with the share of each; ``save_preact`` against the plain
     pre-activation (gelu, silu); bf16 at C=K=16; bwd-weight with and
     without dbias at phase 2's generic shapes (fig5, fig6; batch 4 x
     5,000), checked only; two launches of each pass bitwise equal;
  5. the whole model's gradient: the full ``atacworks`` widths at batch 2
     x width 8,192 (seeded weights, random non-zero biases): the loss and
     all 50 parameter gradients through the kernels against autograd over
     the plain version on the card, TF32 off; then 3 AdamW steps both ways,
     their losses and the parameters they leave;
  6. train ``atacworks`` through ``repro_torch.launch.train``'s own entry
     point at batch 8 x 60,000 for 10 steps: every loss finite,
     ``conv1d_fwd`` launched 49 times per step (25 forward + 24 bwd-data)
     and ``conv1d_bwd_weight`` 25 times; step p50, samples/s, and the
     kernels' device time per step against the step; then PROFILE_STEPS
     more steps under ``torch.profiler``: device time by kernel and the
     device's busy share of a step;
  7. the depthwise kernels against their plain versions at the Mamba2-370M
     conv layer of its training cell (batch 8 x 2,048, C = 2304, S = 4):
     the forward (bf16 in, bias + silu, fp32 out and preact), bwd-data
     (the padded fp32 cotangent against the flipped taps, bf16 out) and
     bwd-weight (bf16 x, fp32 cotangent) with and without dbias, two
     launches of each bitwise equal, one fp32, one residual and one
     dilation-3 case; device, call, plain and library
     (``F.conv1d(groups=C)``, ``torch.nn.grad``) times beside the bound,
     the rate (GB/s) and the share of the bound;
  8. the whole Mamba2 gradient: the full widths in an fp32 copy of the
     config cut to 2 layers (remat on), batch 2 x 512, TF32 off: the loss
     and all 12 gradients through the kernels against autograd over the
     plain version, and 3 x 2 forward and 2 bwd-weight launches;
  9. train ``mamba2-370m`` (48 layers, bf16, remat on) through
     ``repro_torch.launch.train``'s own entry point at batch 8 x 2,048 for
     10 steps: every loss and gradient norm finite, 144 depthwise forward
     launches (forward, recompute, bwd-data) and 48 bwd-weight launches a
     step; step p50, tokens/s, peak memory; then M2_PROFILE_STEPS more
     steps under ``torch.profiler``: device time of the depthwise
     kernels, the projections' matrix products, the SSD's batched
     products, the rest, and the idle time;
  10. the flash kernels against their plain versions at StarCoder2-3B's
      attention in its training cell (batch 4 x 4,096, 24 heads over 2
      KV heads of 128, bf16, causal): o, lse, dq, dk, dv, two backward
      launches bitwise equal; one fp32, one non-causal, one G = 1, one
      ragged (T = 1,000) and one head_dim 64 case (forward and backward),
      the forward with q_offset 1,024 over 2,048 keys at head_dim 64, and
      forward and backward with 1,024 queries over 2,048 keys (no offset);
      device, call, plain and library (``F.scaled_dot_product_attention``,
      a yardstick the port never calls) times beside the bound, and the
      rate each kernel reaches (the bound's flops over its time);
  11. the whole StarCoder2-3B gradient: the full widths in an fp32 copy of
      the config cut to 2 layers (remat on), batch 2 x 512, TF32 off: the
      loss and all 19 gradients through the flash kernels against
      autograd over the plain attention (``attn_impl="chunked"``), and
      2 x 2 ``flash_fwd`` and 2 ``flash_bwd`` launches;
  12. train ``starcoder2-3b`` (30 layers, bf16, remat on) through
      ``repro_torch.launch.train``'s own entry point with ``--attn-impl
      flash`` at batch 4 x 4,096 for 8 steps: every loss and gradient norm
      finite, no step skipped, 60 ``flash_fwd`` (forward and remat
      recompute) and 30 ``flash_bwd`` launches a step, peak memory under
      80 GB; step p50, tokens/s; then LM_PROFILE_STEPS more steps under
      ``torch.profiler``: device time of the flash kernels, the matrix
      products, the rest, and the idle time;
  13. the paper's Figs 4-6 grid (``repro_torch.tune.sweep``: fig4 fp32
      C=K=15 d=8, fig5 fp32 C=K=64 d=1, fig6 bf16 C=K=32 d=4; S in {5,
      25, 51} x Q in {1,000, 5,000, 20,000}; batch 4, SAME): per cell the
      forward and the forward + backward on the kernels (their own
      tiles), cuDNN (``backend="library"``, TF32 off, deterministic) and
      ``backend="auto"`` after a measured ``tune`` of the three passes
      (top 3 each) into a fresh cache; device ms (graph replay),
      GFLOP/s, efficiency against the dtype's peak, speedup over cuDNN,
      each backward pass's own time and the taps/unit race of
      ``conv1d_bwd_weight``.  Checked: the kernels' outputs within
      ``TOL`` and gradients within ``BWD_TOL`` of the plain version;
      every tile and body the kernels instantiate launched unless their
      own rule refuses it (a tile changes no forward or bwd-data bit; a
      body's dw within ``BWD_TOL``, bitwise on two launches); each
      ``"auto"`` result bitwise equal to the call with its plan pinned.
      One summary line a figure: median efficiency of kernel and cuDNN,
      the cells the kernel wins, the worst cell, ``"auto"``'s winners;
  14. a JSON line of the six kernels, the card's line, and last the
      result line.

Exits non-zero without printing a result when there is no CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# The least time of a call (the H100 SXM's published peaks, stated against
# the card's power limit): the larger of its bytes over HBM bandwidth and
# its operations over the peak of their type (repro_torch.roofline).
from repro_torch.roofline import analysis as roofline  # noqa: E402
# outputs |kernel - plain| <= atol + rtol * |plain| per dtype (TOL); the
# backward passes max|kernel - plain| <= BWD_TOL * max|plain|; one copy,
# with the sweep that holds Figs 4-6 to them (its comment says why)
from repro_torch.tune.sweep import BWD_TOL, TOL  # noqa: E402
# whole model: each of the 50 gradients within GRAD_TOL * max|plain| of
# autograd over the plain version (25 layers of fp32 sums taken in another
# order, the errors carried through the chain), the loss within LOSS_RTOL
GRAD_TOL, LOSS_RTOL = 1e-3, 1e-5
# after GRAD_STEPS AdamW steps (lr ADAMW_LR) both ways: the losses within
# LOSS_RTOL, and the parameters within PARAM_ATOL, except that AdamW's
# first updates are sign-like (about lr each), so an element whose
# gradient lies within the gradients' error of zero may step the other
# way: at most PARAM_FLIP_FRAC of all elements may differ by more
ADAMW_LR, PARAM_ATOL, PARAM_FLIP_FRAC = 3e-4, 1e-5, 1e-4

MAIN_SHAPE = "conv1 b+relu 15->15 stream"  # the row the kernels line reports
DEVICE = "cuda"

# the serving cell: 4 slots x chunk 4096, 4096-sample histories, 8 queued
# streams of 50,000 + U[0, 4096) samples (more streams than slots, ragged)
SLOTS, CHUNK, PROMPT_LEN, STREAMS, TRACK_LEN = 4, 4096, 4096, 8, 50000
SERVE_REPEATS = 5  # timed runs after the checked one

# the training cell: batch 8 x width 60,000 (paper §4.2), 10 steps
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 60000, 10
# the whole-model gradient check: full widths at batch 2 x 8,192
GRAD_BATCH, GRAD_SEQ, GRAD_STEPS = 2, 8192, 3
PROFILE_STEPS = 4  # training steps traced by torch.profiler after the run

# the Mamba2-370M conv layer of the training cell: batch 8 x 2,048,
# conv_dim 2304 (d_inner 2048 + 2 x d_state 128), conv width 4
DW_BATCH, DW_SEQ, DW_CHANNELS, DW_TAPS = 8, 2048, 2304, 4
# depthwise kernels vs plain: max|kernel - plain| <= tol * max|plain|.
# fp32 results: sums of S products, or of 16,384 per channel for the
# weight gradient, in another order; bf16 results: one bf16 rounding
DW_TOL_F32, DW_TOL_BF16 = 1e-5, 2.0 ** -7
# the whole Mamba2 gradient: the full widths in fp32, 2 layers, batch 2 x
# 512; the loss within LOSS_RTOL, each gradient within GRAD_TOL of its
# leaf's largest value (as for AtacWorks)
M2_GRAD_LAYERS, M2_GRAD_BATCH, M2_GRAD_SEQ = 2, 2, 512
# the Mamba2-370M training cell: batch 8 x 2,048 (the Mamba-2 paper's
# pretraining context), 10 steps; then M2_PROFILE_STEPS traced
M2_BATCH, M2_SEQ, M2_STEPS, M2_PROFILE_STEPS = 8, 2048, 10, 3

# StarCoder2-3B's attention in its training cell: batch 4 x 4,096, 24
# query heads over 2 KV heads (G = 12) of 128, bf16, causal
FA_B, FA_T, FA_KV, FA_G, FA_HD = 4, 4096, 2, 12, 128
# flash kernels vs plain.  fp32 results: max|kernel - plain| <= FA_TOL_F32
# * max|plain|, since dk and dv sum up to 4,096 x 12 = 49,152 terms in
# another order, whose rounding alone is sqrt(n) x 2^-24, about 1e-5 of
# the largest value; lse (one log-sum-exp per row, fp32 in both dtypes)
# within FA_TOL_LSE of the largest.  bf16 results, each element against
# its own value: |kernel - plain| <= FA_RTOL_BF16 * |plain| + FA_ATOL_BF16
# * max|plain|.  Both sides round fp32 values that differ only in
# summation order once to bf16 (to nearest even), so they differ by at
# most one bf16 ulp, 2^-7 of the value, plus the fp32 difference (about
# 1e-5 of the largest value), which the atol covers many times over.  A
# bound held per element also holds the late causal rows, whose values
# are 50 to 100 times smaller than the first rows'.
FA_TOL_F32, FA_TOL_LSE = 1e-4, 1e-5
FA_RTOL_BF16, FA_ATOL_BF16 = 2.0 ** -7, 1e-3
# the whole StarCoder2-3B gradient: the full widths in fp32, 2 layers,
# batch 2 x 512; the loss within LOSS_RTOL, each gradient within GRAD_TOL
# of its leaf's largest value (as for AtacWorks and Mamba2)
LM_GRAD_LAYERS, LM_GRAD_BATCH, LM_GRAD_SEQ = 2, 2, 512
# the StarCoder2-3B training cell: batch 4 x 4,096 (its pretraining
# context), 8 steps; then LM_PROFILE_STEPS traced
LM_BATCH, LM_SEQ, LM_STEPS, LM_PROFILE_STEPS = 4, 4096, 8, 2
LM_MEMORY_LIMIT_GB = 80.0
# the paper's Figs 4-6 sweep: graph replays per timing (cut these, never
# the cells, if the phase runs long); the tuner times every candidate
SWEEP_ITERS = 5


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def _call_ms(fn, reps: int = 20) -> float:
    """Median CUDA-event time of single calls as a caller sees them: the
    host's work in the call (checks, allocation, launch) is inside the
    window whenever it is longer than the device's."""
    import torch
    fn()  # warm-up
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def _device_ms(fn, per_graph: int = 10, reps: int = 5) -> float:
    """Device time of one call: ``per_graph`` calls captured in one CUDA
    graph, replayed ``reps`` times back to back between two events, so no
    host work sits between the kernels (``repro_torch.tune.measure``)."""
    from repro_torch.tune.measure import device_ms
    return device_ms(fn, per_graph, reps)


def _host_us(fn, reps: int = 200, rounds: int = 5) -> float:
    """Host time of one call in microseconds: ``reps`` calls enqueued back
    to back, timed on the host clock to the last return while the device
    runs behind; median over ``rounds``."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        times.append((time.perf_counter() - t0) / reps * 1e6)
        torch.cuda.synchronize()
    times.sort()
    return times[len(times) // 2]


def _fwd_tile(conv1d_brgemm, N, C, K, S, Wp, d):
    """The register tile ``conv1d_fwd`` takes at this shape on this card:
    "J=8 KT=16" (J columns spaced d apart x KT filters a thread)."""
    code = conv1d_brgemm.fwd_tile(N, C, K, S, Wp, d)
    if code is None:
        raise AssertionError("conv1d_fwd_tile refused the shape")
    return f"J={code // 100} KT={code % 100}"


def _rates(row, flops=None, nbytes=None):
    """The rate the row's device time reaches (GFLOP/s of ``flops``, GB/s of
    ``nbytes``) and its share of the bound (bound / time)."""
    ms = row["kernel_ms"]
    if flops is not None:
        row["gflop_per_s"] = flops / ms / 1e6
    if nbytes is not None:
        row["gb_per_s"] = nbytes / ms / 1e6
    row["bound_share"] = row["bound_ms"] / ms


def kernel_checks(torch, conv1d_brgemm, ops, ref, ep):
    """Phase 2: every layer shape of the path, kernel vs plain version."""
    import torch.nn.functional as F

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    # (label, C, K, activation, residual, out_dtype is fp32)
    layers = [("stem", 1, 15, "relu", False, False),
              ("conv1", 15, 15, "relu", False, False),
              ("conv2", 15, 15, "relu", True, False),
              ("head_signal", 15, 1, "relu", False, True),
              ("head_peak", 15, 1, None, False, True)]
    cases = []  # ... (S, dilation), dtype, N, Q, padding, where
    for name, C, K, act, res, f32out in layers:
        cases.append((name, C, K, act, res, f32out, (51, 8), "float32", 4,
                      4096, "CAUSAL", "stream"))
        cases.append((name, C, K, act, res, f32out, (51, 8), "float32", 1,
                      60000, "CAUSAL", "oneshot"))
    for name, C, K, act, res, f32out in layers:  # atacworks-bf16: C=K=16
        cases.append((name, 1 if C == 1 else 16, 1 if K == 1 else 16, act,
                      res, f32out, (51, 8), "bfloat16", 4, 4096, "CAUSAL",
                      "stream"))
    cases.append(("conv1", 15, 15, "gelu", False, False, (51, 8), "float32",
                  4, 4096, "SAME", "stream"))
    cases.append(("conv2", 15, 15, "silu", True, False, (51, 8), "float32",
                  4, 4096, "CAUSAL", "stream"))
    # the generic tiling beyond the path (the paper's Figure 5 and 6
    # parameter sets, repro/tune/presets.py): K > 16 in filter tiles,
    # dilation 1 and 4, bf16; checked, not timed
    cases.append(("fig5", 64, 64, "relu", False, False, (25, 1), "float32",
                  4, 5000, "SAME", "d=1 S=25"))
    cases.append(("fig6", 32, 32, "relu", False, False, (51, 4), "bfloat16",
                  4, 5000, "SAME", "d=4 S=51"))

    rows = []
    for (name, C, K, act, res, f32out, (S, d), dt, N, Q, padding,
         where) in cases:
        span = (S - 1) * d
        dtype = getattr(torch, dt)
        x = torch.randn((N, C, Q), generator=gen, device=DEVICE).to(dtype)
        w = (torch.randn((S, K, C), generator=gen, device=DEVICE)
             * (C * S) ** -0.5).to(dtype)
        b = (0.1 * torch.randn((K,), generator=gen, device=DEVICE)).to(dtype)
        r = ((torch.randn((N, K, Q), generator=gen, device=DEVICE)).to(dtype)
             if res else None)
        out_dtype = torch.float32 if f32out else None
        kw = dict(bias=b, activation=act, residual=r, dilation=d,
                  padding=padding, out_dtype=out_dtype)
        got = ops.conv1d(x, w, backend="cuda", **kw)
        want = ops.conv1d(x, w, backend="ref", **kw)
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        max_abs = diff.max().item()
        max_rel = max_abs / max(want.float().abs().max().item(), 1e-30)
        atol, rtol = TOL[dt]
        ok = bool((diff <= atol + rtol * want.float().abs()).all().item())
        sig = ep.signature(True, act, res)
        label = f"{name} {sig} {C}->{K} {where}" + (
            f" {padding}" if padding != "CAUSAL" else "") + (
            " bf16" if dt == "bfloat16" else "")
        row = dict(shape=label, dtype=dt, N=N, C=C, K=K, S=S, dilation=d,
                   Q=Q, max_abs_err=max_abs, max_rel_diff=max_rel,
                   atol=atol, rtol=rtol, ok=ok,
                   tile=_fwd_tile(conv1d_brgemm, N, C, K, S, Q + span, d))
        if not ok:
            raise AssertionError(f"kernel disagrees with plain version: {row}")
        if dt == "float32" and padding == "CAUSAL" and act in ("relu", None):
            # times at the path's shapes: the kernel on the padded input,
            # the plain version on the same, and one library call
            xp = F.pad(x, (span, 0)).contiguous()
            w_kcs = w.permute(1, 2, 0).contiguous()  # (K, C, S) for torch

            def kernel():
                return conv1d_brgemm.conv1d_fwd(
                    xp, w, bias=b, residual=r, activation=act, dilation=d,
                    out_dtype=out_dtype)

            def plain():
                return ref.conv1d_fused_ref(
                    xp, w, bias=b, residual=r, activation=act, dilation=d,
                    out_dtype=out_dtype)

            def library():
                return F.conv1d(xp, w_kcs, b, dilation=d)

            row["kernel_ms"] = _device_ms(kernel)
            row["plain_ms"] = _device_ms(plain, per_graph=2)
            row["library_ms"] = _device_ms(library)
            row["kernel_call_ms"] = _call_ms(kernel)
            row["library_call_ms"] = _call_ms(library)
            row["bound_ms"], row["bound_by"] = roofline.conv1d_fwd_bound(
                N, C, K, S, Q + span, Q, dt, True, res, 4)
            _rates(row, flops=2.0 * N * K * C * S * Q)
            if where == "stream":
                # what ops adds to a served call on the host: the server
                # calls ops.conv1d VALID on [state | chunk] under
                # inference_mode, which ends in the wrapper call
                def via_ops():
                    return ops.conv1d(
                        xp, w, bias=b, residual=r, activation=act,
                        dilation=d, padding="VALID", out_dtype=out_dtype)

                with torch.inference_mode():
                    row["wrapper_host_us"] = _host_us(kernel)
                    row["ops_host_us"] = _host_us(via_ops)
                row["ops_added_host_us"] = (row["ops_host_us"]
                                            - row["wrapper_host_us"])
        rows.append(row)
        print("kernel-check " + json.dumps(row), flush=True)
    torch.cuda.synchronize()
    return rows


def serve_check(torch, np, configs, blocks, serve, conv1d_brgemm):
    """Phase 3: the full atacworks config served through the kernel."""
    cfg = configs.get("atacworks")
    # seed 4: with these biases the signal head's relu passes about two
    # thirds of the columns (seed 0 zeroes nearly all of them, which would
    # leave the signal comparison empty)
    model = blocks.init_params(cfg, seed=4, device=DEVICE)
    gen = torch.Generator().manual_seed(2)
    with torch.no_grad():  # biases are zeros at init: make them count
        for name, p in model.named_parameters():
            if name.endswith(".b"):
                p.copy_(0.1 * torch.randn(p.shape, generator=gen))

    def make_server():
        rng = np.random.default_rng(0)
        server = serve.ConvStreamServer(model, cfg, batch=SLOTS, chunk=CHUNK,
                                        prompt_len=PROMPT_LEN, device=DEVICE)
        for rid in range(STREAMS):
            n = TRACK_LEN + int(rng.integers(0, CHUNK))
            server.submit(serve.StreamRequest(
                rid, rng.normal(size=n).astype(np.float32),
                history=rng.normal(size=PROMPT_LEN).astype(np.float32)))
        return server

    def timed_run(server):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = server.run()
        torch.cuda.synchronize()
        return done, time.perf_counter() - t0

    server = make_server()
    conv1d_brgemm.conv1d_fwd.launches = 0
    done, wall = timed_run(server)
    launches = conv1d_brgemm.conv1d_fwd.launches
    prefills = sum(r.history is not None for r in done)
    per_step = (launches - 25 * prefills) / server.chunks_run
    if len(done) != STREAMS:
        raise AssertionError(f"{len(done)} of {STREAMS} streams done")
    if per_step < 25:
        raise AssertionError(f"{per_step} kernel launches per stream step; "
                             "the serve path must launch it 25 times")
    times = np.asarray(server.chunk_times[1:])
    samples = sum(len(r.track) for r in done)
    stats = dict(streams=len(done), samples=samples,
                 chunks_run=server.chunks_run, prefills=prefills,
                 launches=launches, launches_per_step=per_step, wall_s=wall,
                 chunk_p50_ms=float(np.median(times) * 1e3),
                 chunk_p99_ms=float(np.percentile(times, 99) * 1e3),
                 streams_per_s=len(done) / wall, samples_per_s=samples / wall)

    for req in done:  # outputs are finite and of the expected shape
        sig, peak = req.result()
        if sig.shape != req.track.shape or peak.shape != req.track.shape:
            raise AssertionError(f"stream {req.id}: shapes {sig.shape}, "
                                 f"{peak.shape} != {req.track.shape}")
        if not (np.isfinite(sig).all() and np.isfinite(peak).all()):
            raise AssertionError(f"stream {req.id}: non-finite outputs")
        want = serve.one_shot(model, cfg, req.track, server.context(req))
        for name, got, ref_ in (("signal", sig, want[0]),
                                ("peak", peak, want[1])):
            if not np.array_equal(got, ref_):
                raise AssertionError(
                    f"stream {req.id} {name} != one-shot causal forward "
                    f"through the kernel (maxdiff {np.abs(got - ref_).max()})")
    got0 = np.stack(done[0].result())
    plain = np.stack(serve.one_shot(model, cfg, done[0].track,
                                    server.context(done[0]), backend="ref"))
    plain_err = float(np.abs(got0 - plain).max())
    if not np.allclose(got0, plain, rtol=1e-4, atol=1e-4):
        raise AssertionError(f"stream 0 vs the plain forward: max abs diff "
                             f"{plain_err}, beyond atol=rtol=1e-4")
    torch.cuda.synchronize()
    stats.update(bitwise_vs_oneshot_kernel=True,
                 max_abs_err_vs_plain_forward=plain_err,
                 max_abs_output=float(np.abs(plain).max()),
                 signal_nonzero_frac=float((got0[0] != 0).mean()))

    # the same streams again, timed only: the run-to-run spread of the
    # host-clock metrics, and p50/p99 over all runs' chunk times pooled
    runs, pooled = [], list(times)
    for _ in range(SERVE_REPEATS):
        again = make_server()
        _, wall_r = timed_run(again)
        t = np.asarray(again.chunk_times[1:])
        pooled += list(t)
        runs.append(dict(chunk_p50_ms=float(np.median(t) * 1e3),
                         chunk_p99_ms=float(np.percentile(t, 99) * 1e3),
                         samples_per_s=samples / wall_r))
    pooled = np.asarray(pooled)
    stats.update(
        repeats=runs,
        pooled_chunks=len(pooled),
        pooled_chunk_p50_ms=float(np.median(pooled) * 1e3),
        pooled_chunk_p99_ms=float(np.percentile(pooled, 99) * 1e3),
        repeat_samples_per_s_min=min(r["samples_per_s"] for r in runs),
        repeat_samples_per_s_max=max(r["samples_per_s"] for r in runs),
        repeat_chunk_p50_ms_min=min(r["chunk_p50_ms"] for r in runs),
        repeat_chunk_p50_ms_max=max(r["chunk_p50_ms"] for r in runs))
    torch.cuda.synchronize()
    print("serve " + json.dumps(stats), flush=True)
    return stats


def _check_close(label, got, want, tol):
    """max|got - want| <= tol * max|want|; returns (max_abs, max_rel)."""
    scale = max(want.float().abs().max().item(), 1e-30)
    max_abs = (got.float() - want.float()).abs().max().item()
    if not max_abs <= tol * scale:
        raise AssertionError(f"{label}: max abs diff {max_abs} > {tol} x "
                             f"max|plain| {scale}")
    return max_abs, max_abs / scale


def _check_elementwise(label, got, want, rtol, atol_of_max):
    """|got - want| <= rtol * |want| + atol_of_max * max|want| for every
    element; returns (max_abs, max_abs / max|want|, the largest share of
    its own limit that an element uses: at most 1)."""
    g, w = got.float(), want.float()
    scale = max(w.abs().max().item(), 1e-30)
    diff = (g - w).abs()
    share = diff / (rtol * w.abs() + atol_of_max * scale)
    use = share.max().item()
    if not use <= 1.0:
        i = int(share.argmax())
        raise AssertionError(
            f"{label}: element {i}: |kernel - plain| "
            f"{diff.flatten()[i].item()} > {rtol} x |plain| "
            f"{w.flatten()[i].abs().item()} + {atol_of_max} x max|plain| "
            f"{scale}")
    max_abs = diff.max().item()
    return max_abs, max_abs / scale, use


def bwd_kernel_checks(torch, conv1d_brgemm, ref):
    """Phase 4: the training path's kernels at its layer shapes."""
    import torch.nn.functional as F

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    N, Q, S, d = TRAIN_BATCH, TRAIN_SEQ, 51, 8
    span = (S - 1) * d
    Wp = Q + span
    # (label, C, K, dtype): every layer shape of the training path, fp32,
    # and the bf16 config's widths
    layers = [("stem", 1, 15, "float32"), ("conv", 15, 15, "float32"),
              ("head", 15, 1, "float32"), ("stem", 1, 16, "bfloat16"),
              ("conv", 16, 16, "bfloat16"), ("head", 16, 1, "bfloat16")]

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=DEVICE).to(dtype)

    rows = []
    for name, C, K, dt in layers:
        dtype = getattr(torch, dt)
        tol = BWD_TOL[dt]
        x = rnd(N, C, Wp, dtype=dtype)                 # padded input
        w = (rnd(S, K, C) * (C * S) ** -0.5).to(dtype)
        b = (0.1 * rnd(K)).to(dtype)
        g = rnd(N, K, Q, dtype=dtype)                  # cotangent of u
        g_pad = F.pad(g, (span, span))
        w_t = w.flip(0).transpose(1, 2).contiguous()   # (S, C, K)
        w_kcs = w.permute(1, 2, 0).contiguous()        # (K, C, S), torch's
        fp32 = dt == "float32"

        def fwd():
            return conv1d_brgemm.conv1d_fwd(x, w, bias=b, activation="relu",
                                            dilation=d)

        def bwd_data():
            return conv1d_brgemm.conv1d_fwd(g_pad, w_t, dilation=d)

        def bwd_w(with_dbias=True):
            return conv1d_brgemm.conv1d_bwd_weight(x, g, S=S, dilation=d,
                                                   with_dbias=with_dbias)

        passes = {
            "fwd": (fwd, lambda: ref.conv1d_fused_ref(
                x, w, bias=b, activation="relu", dilation=d),
                lambda: F.conv1d(x, w_kcs, b, dilation=d),
                2.0 * N * K * C * S * Q,
                (N * C * Wp + S * K * C + K + N * K * Q) * x.element_size()),
            "bwd_data": (bwd_data, lambda: ref.conv1d_bwd_data_ref(
                g, w, dilation=d),
                lambda: torch.nn.grad.conv1d_input(
                    (N, C, Wp), w_kcs, g, dilation=d),
                # the function: only the Q cotangent columns are non-zero
                # (the span padding is zeros the wrapper adds), so
                # 2NKCSQ flops, and g read unpadded
                2.0 * N * K * C * S * Q,
                (N * K * Q + S * K * C + N * C * Wp) * x.element_size()),
            "bwd_weight": (bwd_w, lambda: (
                ref.conv1d_bwd_weight_ref(x, g, dilation=d),
                ref.conv1d_dbias_ref(g)),
                lambda: torch.nn.grad.conv1d_weight(
                    x, (K, C, S), g, dilation=d),
                2.0 * N * K * C * S * Q,
                (N * C * Wp + N * K * Q) * x.element_size()
                + (S * K * C + K) * 4),
        }
        for pname, (kern, plain, lib, flops, nbytes) in passes.items():
            got, want = kern(), plain()
            torch.cuda.synchronize()
            label = f"{pname} {name} {C}->{K} N={N} Q={Q}" + (
                "" if fp32 else " bf16")
            if pname == "bwd_weight":
                err_w = _check_close(label + " dw", got[0], want[0], tol)
                err_b = _check_close(label + " dbias", got[1], want[1], tol)
                nod = bwd_w(with_dbias=False)
                err_n = _check_close(label + " dw (no dbias)", nod, want[0],
                                     tol)
                again = bwd_w()
                torch.cuda.synchronize()
                if not (torch.equal(again[0], got[0])
                        and torch.equal(again[1], got[1])
                        and torch.equal(nod, got[0])):
                    raise AssertionError(f"{label}: two launches differ")
                max_abs = max(err_w[0], err_b[0], err_n[0])
                max_rel = max(err_w[1], err_b[1], err_n[1])
            else:
                max_abs, max_rel = _check_close(label, got, want, tol)
                again = kern()
                torch.cuda.synchronize()
                if not torch.equal(again, got):
                    raise AssertionError(f"{label}: two launches differ")
            row = dict(shape=label, pass_=pname, layer=name, dtype=dt, N=N,
                       C=C, K=K, S=S, dilation=d, Q=Q, max_abs_err=max_abs,
                       max_rel_diff=max_rel, tol_rel_to_max_plain=tol,
                       bitwise_two_launches=True, ok=True)
            if pname == "fwd":
                row["tile"] = _fwd_tile(conv1d_brgemm, N, C, K, S, Wp, d)
            elif pname == "bwd_data":  # K channels in, C filters out
                row["tile"] = _fwd_tile(conv1d_brgemm, N, K, C, S,
                                        Wp + span, d)
            if fp32:
                row["kernel_ms"] = _device_ms(kern)
                row["kernel_call_ms"] = _call_ms(kern)
                row["plain_ms"] = _device_ms(plain, per_graph=2)
                row["library_ms"] = _device_ms(lib)
                row["bound_ms"], row["bound_by"] = roofline.bound(flops,
                                                                  nbytes, dt)
                if pname == "bwd_weight":
                    # the FMA bound of the kernel this one replaced beside
                    # the three-term TF32 bound of its tensor-core bodies
                    row["fma_bound_ms"] = row["bound_ms"]
                    row["fma_bound_by"] = row["bound_by"]
                    row["fma_bound_share"] = row["fma_bound_ms"] / row[
                        "kernel_ms"]
                    row["bound_ms"], row["bound_by"] = roofline.bound(
                        roofline.tf32_flops(N, C, K, S, Q), nbytes, "tf32")
                _rates(row, flops=flops)
            rows.append(row)
            print("bwd-check " + json.dumps(row), flush=True)

    # bwd-weight at phase 2's generic shapes (the paper's Figure 5 and 6
    # parameter sets): more filters and channels than one block takes,
    # dilation 1 (the unit body) and 4 (the taps body), bf16; checked only
    for name, C, K, S_, d_, dt in (("fig5", 64, 64, 25, 1, "float32"),
                                   ("fig6", 32, 32, 51, 4, "bfloat16")):
        dtype, Nf, Qf = getattr(torch, dt), 4, 5000
        tol = BWD_TOL[dt]
        x = rnd(Nf, C, Qf + (S_ - 1) * d_, dtype=dtype)
        g = rnd(Nf, K, Qf, dtype=dtype)
        label = f"bwd_weight {name} {C}->{K} d={d_} S={S_} N={Nf} Q={Qf}" + (
            " bf16" if dt == "bfloat16" else "")
        got = conv1d_brgemm.conv1d_bwd_weight(x, g, S=S_, dilation=d_,
                                              with_dbias=True)
        nod = conv1d_brgemm.conv1d_bwd_weight(x, g, S=S_, dilation=d_)
        again = conv1d_brgemm.conv1d_bwd_weight(x, g, S=S_, dilation=d_,
                                                with_dbias=True)
        torch.cuda.synchronize()
        want = ref.conv1d_bwd_weight_ref(x, g, dilation=d_)
        errs = (_check_close(label + " dw", got[0], want, tol),
                _check_close(label + " dbias", got[1],
                             ref.conv1d_dbias_ref(g), tol),
                _check_close(label + " dw (no dbias)", nod, want, tol))
        if not (torch.equal(again[0], got[0]) and torch.equal(again[1], got[1])
                and torch.equal(nod, got[0])):
            raise AssertionError(f"{label}: two launches differ")
        row = dict(shape=label, pass_="bwd_weight", layer=name, dtype=dt,
                   N=Nf, C=C, K=K, S=S_, dilation=d_, Q=Qf,
                   max_abs_err=max(e[0] for e in errs),
                   max_rel_diff=max(e[1] for e in errs),
                   tol_rel_to_max_plain=tol, bitwise_two_launches=True,
                   ok=True)
        rows.append(row)
        print("bwd-check " + json.dumps(row), flush=True)

    # save_preact: the fp32 pre-activation beside the output, gelu and silu
    C = K = 15
    x, r = rnd(N, C, Wp), rnd(N, K, Q)
    w, b = rnd(S, K, C) * (C * S) ** -0.5, 0.1 * rnd(K)
    for act in ("gelu", "silu"):
        y, u = conv1d_brgemm.conv1d_fwd(x, w, bias=b, residual=r,
                                        activation=act, save_preact=True,
                                        dilation=d)
        want_u = ref.conv1d_preact_ref(x, w, bias=b, residual=r, dilation=d)
        want_y = ref.conv1d_fused_ref(x, w, bias=b, residual=r,
                                      activation=act, dilation=d)
        label = f"save_preact {act} conv {C}->{K} N={N} Q={Q}"
        err_u = _check_close(label + " preact", u, want_u, BWD_TOL["float32"])
        err_y = _check_close(label + " out", y, want_y, BWD_TOL["float32"])
        row = dict(shape=label, pass_="save_preact", dtype="float32",
                   max_abs_err=max(err_u[0], err_y[0]),
                   max_rel_diff=max(err_u[1], err_y[1]),
                   tol_rel_to_max_plain=BWD_TOL["float32"], ok=True)
        rows.append(row)
        print("bwd-check " + json.dumps(row), flush=True)
    torch.cuda.synchronize()
    return rows


def dw_kernel_checks(torch, conv1d_brgemm, ref):
    """Phase 7: both depthwise kernels against their plain versions at the
    Mamba2-370M layer shape of the training cell (batch 8 x 2,048, C =
    2304, S = 4, CAUSAL): the forward (bf16 in, silu, fp32 out and
    preact), bwd-data (the padded fp32 cotangent against the flipped,
    widened taps, bf16 out) and bwd-weight (bf16 x, fp32 cotangent) with
    and without dbias, two launches of each bitwise equal; then one fp32,
    one residual and one dilation-3 case.  Device, call, plain and library
    times beside the bound, the rate and the share of the bound for the
    three passes of the path."""
    import torch.nn.functional as F

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=DEVICE).manual_seed(11)
    N, C, Q, S = DW_BATCH, DW_CHANNELS, DW_SEQ, DW_TAPS
    bf16, f32 = torch.bfloat16, torch.float32

    def rnd(*shape, dtype=f32, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device=DEVICE)
                ).to(dtype)

    def operands(d, dtype):
        span = (S - 1) * d
        return (rnd(N, C, Q + span, dtype=dtype),
                rnd(S, C, dtype=dtype, scale=S ** -0.5),
                rnd(C, dtype=dtype, scale=0.1), rnd(N, C, Q), span)

    def tol_of(t):
        return DW_TOL_BF16 if t.dtype == bf16 else DW_TOL_F32

    rows = []

    def record(label, pname, pairs, extra=None):
        errs = [_check_close(f"{label} {k}", got, want, tol_of(got))
                for k, (got, want) in pairs.items()]
        row = dict(shape=label, pass_=pname, N=N, C=C, Q=Q, S=S,
                   max_abs_err=max(e[0] for e in errs),
                   max_rel_diff=max(e[1] for e in errs),
                   tol_rel_to_max_plain={k: tol_of(g) for k, (g, _) in
                                         pairs.items()}, ok=True)
        row.update(extra or {})
        rows.append(row)
        print("dw-check " + json.dumps(row), flush=True)
        return row

    # the path's three passes, timed
    x, w, b, g, span = operands(1, bf16)
    g_pad = F.pad(g, (span, span))
    w_flip = w.flip(0).float().contiguous()
    w_c1s = w.t().unsqueeze(1).contiguous()          # (C, 1, S), torch's
    x32, w32_c1s = x.float(), w_c1s.float()

    def fwd():
        return conv1d_brgemm.depthwise_conv1d_fwd(
            x, w, bias=b, activation="silu", save_preact=True,
            out_dtype=f32)

    def fwd_plain():
        u = ref.depthwise_conv1d_preact_ref(x, w, bias=b)
        return F.silu(u), u

    def bwd_data():
        return conv1d_brgemm.depthwise_conv1d_fwd(g_pad, w_flip,
                                                  out_dtype=bf16)

    def bwd_w(with_dbias=True):
        return conv1d_brgemm.depthwise_conv1d_bwd_weight(
            x, g, S=S, with_dbias=with_dbias)

    def bwd_w_plain():
        return (ref.depthwise_conv1d_bwd_weight_ref(x, g),
                ref.conv1d_dbias_ref(g))

    Wp = Q + span
    # bytes: each input read once, each output written once; the ops are
    # fp32 FMAs whatever the input type
    passes = {
        "fwd": (fwd, fwd_plain,
                lambda: F.conv1d(x, w_c1s, b, groups=C),
                2.0 * N * C * S * Q,
                N * C * Wp * 2 + (S * C + C) * 2 + 2 * N * C * Q * 4),
        "bwd_data": (bwd_data, lambda: ref.depthwise_conv1d_bwd_data_ref(
            g, w.float(), out_dtype=bf16),
            lambda: torch.nn.grad.conv1d_input((N, C, Wp), w32_c1s, g,
                                               groups=C),
            2.0 * N * C * S * Q, N * C * Q * 4 + S * C * 4 + N * C * Wp * 2),
        "bwd_weight": (bwd_w, bwd_w_plain,
                       lambda: torch.nn.grad.conv1d_weight(
                           x32, (C, 1, S), g, groups=C),
                       2.0 * N * C * (S + 1) * Q,
                       N * C * Wp * 2 + N * C * Q * 4 + (S * C + C) * 4),
    }
    for pname, (kern, plain, lib, flops, nbytes) in passes.items():
        got, want = kern(), plain()
        torch.cuda.synchronize()
        label = f"{pname} mamba2 C={C} N={N} Q={Q}"
        extra = {}
        if pname in ("fwd", "bwd_data"):
            again = kern()
            torch.cuda.synchronize()
            same = (torch.equal(again[0], got[0])
                    and torch.equal(again[1], got[1]) if pname == "fwd"
                    else torch.equal(again, got))
            if not same:
                raise AssertionError(f"{label}: two launches differ")
            extra["bitwise_two_launches"] = True
            # each thread: 8 outputs of one row, one register window for
            # all taps at dilation 1 (depthwise_conv1d_fwd.cu)
            extra["tile"] = "8 outputs a thread, one window"
        if pname == "fwd":
            pairs = {"out": (got[0], want[0]), "preact": (got[1], want[1])}
        elif pname == "bwd_data":
            pairs = {"dx": (got, want)}
        else:
            nod = bwd_w(with_dbias=False)
            again = bwd_w()
            torch.cuda.synchronize()
            if not (torch.equal(again[0], got[0])
                    and torch.equal(again[1], got[1])
                    and torch.equal(nod, got[0])):
                raise AssertionError(f"{label}: two launches differ")
            pairs = {"dw": (got[0], want[0]), "dbias": (got[1], want[1]),
                     "dw (no dbias)": (nod, want[0])}
            extra["bitwise_two_launches"] = True
        extra["kernel_ms"] = _device_ms(kern)
        extra["kernel_call_ms"] = _call_ms(kern)
        extra["plain_ms"] = _device_ms(plain, per_graph=2)
        extra["library_ms"] = _device_ms(lib)
        extra["bound_ms"], extra["bound_by"] = roofline.bound(
            flops, nbytes, "float32")
        _rates(extra, nbytes=nbytes)
        record(label, pname, pairs, extra)

    # one fp32, one residual (gelu, bf16 out) and one dilation-3 case
    x, w, b, g, _ = operands(1, f32)
    y, u = conv1d_brgemm.depthwise_conv1d_fwd(x, w, bias=b,
                                              activation="silu",
                                              save_preact=True)
    record(f"fwd fp32 silu C={C}", "fwd", {
        "out": (y, F.silu(ref.depthwise_conv1d_preact_ref(x, w, bias=b))),
        "preact": (u, ref.depthwise_conv1d_preact_ref(x, w, bias=b))})
    dw, db = conv1d_brgemm.depthwise_conv1d_bwd_weight(x, g, S=S,
                                                       with_dbias=True)
    record(f"bwd_weight fp32 C={C}", "bwd_weight", {
        "dw": (dw, ref.depthwise_conv1d_bwd_weight_ref(x, g)),
        "dbias": (db, ref.conv1d_dbias_ref(g))})
    x, w, b, _, _ = operands(1, bf16)
    r = rnd(N, C, Q, dtype=bf16)
    record(f"fwd bf16 gelu+residual C={C}", "fwd", {"out": (
        conv1d_brgemm.depthwise_conv1d_fwd(x, w, bias=b, residual=r,
                                           activation="gelu"),
        ref.depthwise_conv1d_fused_ref(x, w, bias=b, residual=r,
                                       activation="gelu"))})
    x, w, b, g, _ = operands(3, bf16)
    record(f"fwd+bwd_weight dilation 3 C={C}", "fwd", {
        "out": (conv1d_brgemm.depthwise_conv1d_fwd(
            x, w, bias=b, activation="silu", dilation=3, out_dtype=f32),
            ref.depthwise_conv1d_fused_ref(x, w, bias=b, activation="silu",
                                           dilation=3, out_dtype=f32)),
        "dw": (conv1d_brgemm.depthwise_conv1d_bwd_weight(x, g, S=S,
                                                         dilation=3),
               ref.depthwise_conv1d_bwd_weight_ref(x, g, dilation=3))})
    torch.cuda.synchronize()
    return rows


def _batch(torch, synthetic, cfg, batch, seq, seed):
    """A synthetic batch of the config's family on the card."""
    return {k: torch.from_numpy(v).to(DEVICE) for k, v in
            synthetic.make_batch(cfg, batch, seq, seed=seed).items()}


def _seeded_model(torch, blocks, cfg, seed):
    """The stack from a seed, with random non-zero biases (zeros at init
    would leave the bias path untested)."""
    model = blocks.init_params(cfg, seed=seed, device=DEVICE)
    gen = torch.Generator().manual_seed(seed + 100)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".b"):
                p.copy_(0.1 * torch.randn(p.shape, generator=gen))
    return model


def model_grad_check(torch, configs, blocks, synthetic, adamw,
                     conv1d_brgemm):
    """Phase 5: the whole model's loss and gradients through the kernels
    against autograd over the plain version, then 3 AdamW steps."""
    import copy

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = configs.get("atacworks")
    model = _seeded_model(torch, blocks, cfg, seed=5)
    batch = _batch(torch, synthetic, cfg, GRAD_BATCH, GRAD_SEQ, 7)
    names = [n for n, _ in model.named_parameters()]

    def loss_and_grads(m, backend):
        params = [p for _, p in m.named_parameters()]
        loss, _ = blocks.loss_fn(m, cfg, batch, backend=backend)
        return loss.detach(), torch.autograd.grad(loss, params)

    fwd0, bw0 = conv1d_brgemm.conv1d_fwd.launches, \
        conv1d_brgemm.conv1d_bwd_weight.launches
    loss_k, grads_k = loss_and_grads(model, None)
    launched = (conv1d_brgemm.conv1d_fwd.launches - fwd0,
                conv1d_brgemm.conv1d_bwd_weight.launches - bw0)
    loss_p, grads_p = loss_and_grads(model, "ref")
    torch.cuda.synchronize()
    if launched != (49, 25):
        raise AssertionError(f"one gradient launched {launched} kernels, "
                             "expected (49 conv1d_fwd, 25 bwd_weight)")
    loss_rel = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    if not loss_rel <= LOSS_RTOL:
        raise AssertionError(f"loss through the kernels {loss_k.item()} vs "
                             f"plain {loss_p.item()}: rel {loss_rel}")
    if len(grads_k) != 50:
        raise AssertionError(f"{len(grads_k)} gradients, expected 50")
    worst = (0.0, "")
    for name, gk, gp in zip(names, grads_k, grads_p):
        if not torch.isfinite(gk).all():
            raise AssertionError(f"non-finite gradient of {name}")
        _, rel = _check_close(f"grad {name}", gk, gp, GRAD_TOL)
        worst = max(worst, (rel, name))

    def adamw_steps(backend):
        m = copy.deepcopy(model)
        state = adamw.init(dict(m.named_parameters()))
        losses = []
        for _ in range(GRAD_STEPS):
            loss, grads = loss_and_grads(m, backend)
            grads = dict(zip(names, grads))
            gnorm = adamw.global_norm(grads)
            adamw.update_(grads, state, dict(m.named_parameters()),
                          lr=ADAMW_LR, grad_norm=gnorm,
                          finite=torch.isfinite(gnorm))
            losses.append(loss.item())
        return losses, m

    (steps_k, model_k), (steps_p, model_p) = (adamw_steps(None),
                                              adamw_steps("ref"))
    step_rel = max(abs(a - b) / abs(b) for a, b in zip(steps_k, steps_p))
    if not step_rel <= LOSS_RTOL:
        raise AssertionError(f"AdamW losses through the kernels {steps_k} "
                             f"vs plain {steps_p}: rel {step_rel}")
    diffs = torch.cat([(pk.detach() - pp.detach()).abs().flatten()
                       for pk, pp in zip(model_k.parameters(),
                                         model_p.parameters())])
    beyond = int((diffs > PARAM_ATOL).sum().item())
    param_max = diffs.max().item()
    if beyond > PARAM_FLIP_FRAC * diffs.numel():
        raise AssertionError(
            f"after {GRAD_STEPS} AdamW steps {beyond} of {diffs.numel()} "
            f"parameters differ by more than {PARAM_ATOL} (max {param_max})")
    stats = dict(batch=GRAD_BATCH, seq=GRAD_SEQ, loss_kernel=loss_k.item(),
                 loss_plain=loss_p.item(), loss_rel_diff=loss_rel,
                 n_grads=len(grads_k), worst_grad_rel_diff=worst[0],
                 worst_grad=worst[1], grad_tol_rel_to_max_plain=GRAD_TOL,
                 adamw_losses_kernel=steps_k, adamw_losses_plain=steps_p,
                 adamw_loss_max_rel_diff=step_rel,
                 adamw_param_max_abs_diff=param_max,
                 adamw_params_beyond_atol=beyond, adamw_params=diffs.numel(),
                 adamw_param_atol=PARAM_ATOL,
                 launches_per_gradient=list(launched))
    print("model-grad " + json.dumps(stats), flush=True)
    return stats


def train_check(torch, np, train, conv1d_brgemm):
    """Phase 6: train atacworks through the launcher's own entry point."""
    torch.cuda.reset_peak_memory_stats()
    conv1d_brgemm.conv1d_fwd.launches = 0
    conv1d_brgemm.conv1d_bwd_weight.launches = 0
    summary = train.run(["--arch", "atacworks", "--steps", str(TRAIN_STEPS),
                         "--batch", str(TRAIN_BATCH), "--seq",
                         str(TRAIN_SEQ)])
    fwd = conv1d_brgemm.conv1d_fwd.launches
    bw = conv1d_brgemm.conv1d_bwd_weight.launches
    losses = summary["losses"]
    if len(losses) != TRAIN_STEPS or not np.isfinite(losses).all():
        raise AssertionError(f"training losses {losses}")
    if (fwd, bw) != (49 * TRAIN_STEPS, 25 * TRAIN_STEPS):
        raise AssertionError(
            f"{fwd} conv1d_fwd and {bw} conv1d_bwd_weight launches in "
            f"{TRAIN_STEPS} steps; expected 49 and 25 per step")
    times = np.asarray(summary["step_s"][train.WARMUP_STEPS:])
    stats = dict(steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                 losses=losses, step_s=summary["step_s"],
                 step_p50_ms=float(np.median(times) * 1e3),
                 step_min_ms=float(times.min() * 1e3),
                 step_max_ms=float(times.max() * 1e3),
                 samples_per_s=summary["samples_per_s"],
                 conv1d_fwd_launches=fwd, conv1d_bwd_weight_launches=bw,
                 fwd_launches_per_step=fwd / TRAIN_STEPS,
                 bwd_weight_launches_per_step=bw / TRAIN_STEPS,
                 peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    stats.update(_model_rate("atacworks", TRAIN_BATCH, TRAIN_SEQ,
                             stats["step_p50_ms"]))
    print("train " + json.dumps(stats), flush=True)
    return stats


def _model_rate(arch, batch, seq, step_ms):
    """A training step's useful work and least memory traffic by the
    roofline's count (``repro_torch.roofline.flops``: 6 N D plus the
    attention or SSD terms; 3x the forward for the conv net) and the rate
    the measured step ran at."""
    from repro_torch import configs
    from repro_torch.roofline import flops as counts

    cfg, shape = configs.get(arch), counts.StepShape("train", seq, batch)
    flops = counts.model_flops(cfg, shape)
    return dict(model_flops_per_step=flops,
                model_bytes_per_step=counts.model_bytes(cfg, shape),
                model_tflops_per_s=flops / (step_ms * 1e-3) / 1e12)


def _profile_steps(torch, train, argv, steps, port_names):
    """Run the launcher with ``argv`` (``steps`` steps) under
    ``torch.profiler``; returns its summary, the device kernels by name
    (calls, device ms per step, ``port`` if the name holds one of
    ``port_names``; longest first), and each host op's self device ms per
    step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        summary = train.run(argv)
        torch.cuda.synchronize()

    def dev_ms(e, self_only):
        for attr in (("self_device_time_total", "self_cuda_time_total")
                     if self_only else
                     ("device_time_total", "cuda_time_total")):
            us = getattr(e, attr, None)
            if us is not None:
                return us / 1e3 / steps
        return 0.0

    kernels, by_op = [], {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            kernels.append(dict(
                name=e.key[:120], calls=e.count, ms_per_step=dev_ms(e, False),
                port=any(t in e.key for t in port_names)))
        else:
            by_op[e.key] = by_op.get(e.key, 0.0) + dev_ms(e, True)
    kernels.sort(key=lambda k: -k["ms_per_step"])
    return summary, kernels, by_op


def train_profile(torch, train):
    """Phase 6, second part: where a training step's time goes.
    PROFILE_STEPS more steps of the launcher under ``torch.profiler``
    (kept apart from the timed run, whose step times it would inflate):
    device time by kernel name per step, and the device's busy share,
    the kernels' summed time over the steps' summed host-clock time."""
    summary, kernels, _ = _profile_steps(
        torch, train, ["--arch", "atacworks", "--steps", str(PROFILE_STEPS),
                       "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ)],
        PROFILE_STEPS, ("conv1d_fwd_kernel", "bwd_weight_partial",
                        "reduce_partials"))
    step_ms = 1e3 * sum(summary["step_s"]) / PROFILE_STEPS
    busy = sum(k["ms_per_step"] for k in kernels)
    ours = sum(k["ms_per_step"] for k in kernels if k["port"])
    stats = dict(steps=PROFILE_STEPS, traced_step_ms=step_ms,
                 device_busy_ms_per_step=busy,
                 port_kernels_ms_per_step=ours,
                 other_device_ms_per_step=busy - ours,
                 device_busy_share=busy / step_ms if step_ms else None,
                 kernel_names=len(kernels), top=kernels[:15])
    print("train-profile " + json.dumps(stats), flush=True)
    return stats


def _mamba2_model(torch, cfg, init_model, seed):
    """Mamba2 from a seed with random non-zero conv biases (zeros at init
    would leave the fused bias path untested)."""
    model = init_model(cfg, seed=seed, device=DEVICE)
    gen = torch.Generator().manual_seed(seed + 100)
    with torch.no_grad():
        b = model.layers.mixer.conv_b
        b.copy_(0.1 * torch.randn(b.shape, generator=gen))
    return model


def _model_grad_check(torch, losses, label, cfg, model, batch, run_kernel,
                      run_plain, counters, expected, why, n_grads):
    """The loss and every gradient of ``model`` on ``batch`` through the
    kernels (``run_kernel(tokens)`` -> logits) against autograd over the
    plain version (``run_plain``): the loss within LOSS_RTOL, each of the
    ``n_grads`` gradients finite and within GRAD_TOL of its leaf's
    largest value; the kernel run must have launched ``counters``
    ``expected`` times (``why`` says what they are)."""
    names, params = zip(*model.named_parameters())

    def loss_and_grads(run):
        loss = losses.softmax_xent(run(batch["tokens"]), batch["labels"])
        return loss.detach(), torch.autograd.grad(loss, params)

    before = [c.launches for c in counters]
    loss_k, grads_k = loss_and_grads(run_kernel)
    launched = tuple(c.launches - n for c, n in zip(counters, before))
    loss_p, grads_p = loss_and_grads(run_plain)
    torch.cuda.synchronize()
    if launched != expected:
        raise AssertionError(f"{label}: one gradient launched {launched} of "
                             f"{[c.__name__ for c in counters]}, expected "
                             f"{expected} ({why})")
    loss_rel = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    if not loss_rel <= LOSS_RTOL:
        raise AssertionError(f"{label} loss through the kernels "
                             f"{loss_k.item()} vs plain {loss_p.item()}: "
                             f"rel {loss_rel}")
    if len(grads_k) != n_grads:
        raise AssertionError(f"{len(grads_k)} gradients, expected {n_grads}")
    worst = (0.0, "")
    for name, gk, gp in zip(names, grads_k, grads_p):
        if not torch.isfinite(gk).all():
            raise AssertionError(f"non-finite gradient of {name}")
        _, rel = _check_close(f"{label} grad {name}", gk, gp, GRAD_TOL)
        worst = max(worst, (rel, name))
    stats = dict(layers=cfg.n_layers, d_model=cfg.d_model,
                 batch=batch["tokens"].shape[0],
                 seq=batch["tokens"].shape[1], dtype=cfg.dtype,
                 remat=cfg.remat, loss_kernel=loss_k.item(),
                 loss_plain=loss_p.item(), loss_rel_diff=loss_rel,
                 n_grads=len(grads_k), worst_grad_rel_diff=worst[0],
                 worst_grad=worst[1], grad_tol_rel_to_max_plain=GRAD_TOL,
                 launches_per_gradient=list(launched))
    print(f"{label}-grad " + json.dumps(stats), flush=True)
    return stats


def _train_check(np, train, label, argv, steps, counters, per_step,
                 memory_limit_gb=None):
    """Train through the launcher's own entry point with ``argv``
    (``steps`` steps): every loss and gradient norm finite, no step
    skipped, ``counters`` launched ``per_step`` times a step, and peak
    device memory under ``memory_limit_gb`` where given.  Returns the
    step times, throughput, peak memory and launches."""
    for c in counters:
        c.launches = 0
    summary = train.run(argv)
    launches = {c.__name__: c.launches for c in counters}
    losses = summary["losses"]
    if len(losses) != steps or not np.isfinite(losses).all():
        raise AssertionError(f"{label} training losses {losses}")
    if not np.isfinite(summary["grad_norms"]).all():
        raise AssertionError(f"{label} gradient norms "
                             f"{summary['grad_norms']}")
    if summary["skipped_steps"]:
        raise AssertionError(f"{summary['skipped_steps']} {label} steps "
                             "skipped for a non-finite gradient norm")
    want = {c.__name__: n * steps for c, n in zip(counters, per_step)}
    if launches != want:
        raise AssertionError(f"{label}: {launches} launches in {steps} "
                             f"steps; expected {want}")
    if memory_limit_gb and not summary["peak_memory_gb"] < memory_limit_gb:
        raise AssertionError(f"{label}: peak device memory "
                             f"{summary['peak_memory_gb']} GB")
    times = np.asarray(summary["step_s"][train.WARMUP_STEPS:])
    stats = dict(argv=argv, steps=steps, losses=losses,
                 grad_norms=summary["grad_norms"], step_s=summary["step_s"],
                 step_p50_ms=float(np.median(times) * 1e3),
                 step_min_ms=float(times.min() * 1e3),
                 step_max_ms=float(times.max() * 1e3),
                 tokens_per_s=summary["tokens_per_s"],
                 samples_per_s=summary["samples_per_s"],
                 peak_memory_gb=summary["peak_memory_gb"],
                 launches=launches,
                 launches_per_step={k: n / steps for k, n in launches.items()})
    arg = dict(zip(argv[::2], argv[1::2]))
    stats.update(_model_rate(arg["--arch"], int(arg["--batch"]),
                             int(arg["--seq"]), stats["step_p50_ms"]))
    print(f"{label}-train " + json.dumps(stats), flush=True)
    return stats


def mamba2_grad_check(torch, configs, init_model, synthetic, losses,
                      conv1d_brgemm):
    """Phase 8: the whole Mamba2 gradient at the full widths (an fp32 copy
    of mamba2-370m cut to M2_GRAD_LAYERS layers, remat on) at batch 2 x
    512: the loss and all 12 gradients through the depthwise kernels
    against autograd over the plain version on the card, TF32 off."""
    import dataclasses

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(configs.get("mamba2-370m"),
                              n_layers=M2_GRAD_LAYERS, dtype="float32")
    model = _mamba2_model(torch, cfg, init_model, seed=21)
    batch = _batch(torch, synthetic, cfg, M2_GRAD_BATCH, M2_GRAD_SEQ, 22)
    L = cfg.n_layers
    return _model_grad_check(
        torch, losses, "mamba2", cfg, model, batch,
        lambda x: model(x, backend=None), lambda x: model(x, backend="ref"),
        (conv1d_brgemm.depthwise_conv1d_fwd,
         conv1d_brgemm.depthwise_conv1d_bwd_weight), (3 * L, L),
        "forward, recompute and bwd-data; bwd-weight", 12)


def _m2_argv(steps):
    return ["--arch", "mamba2-370m", "--steps", str(steps), "--batch",
            str(M2_BATCH), "--seq", str(M2_SEQ)]


def mamba2_train_check(torch, np, train, conv1d_brgemm, n_layers):
    """Phase 9: train the full Mamba2-370M through the launcher's own entry
    point at batch 8 x 2,048 for M2_STEPS steps: every loss and gradient
    norm finite (no step skipped), the depthwise forward launched 3 x 48
    times a step (forward, remat recompute, bwd-data) and the weight
    gradient 48 times."""
    torch.cuda.empty_cache()
    return _train_check(
        np, train, "mamba2", _m2_argv(M2_STEPS), M2_STEPS,
        (conv1d_brgemm.depthwise_conv1d_fwd,
         conv1d_brgemm.depthwise_conv1d_bwd_weight),
        (3 * n_layers, n_layers))


def mamba2_profile(torch, train):
    """Phase 9, second part: M2_PROFILE_STEPS more steps under
    ``torch.profiler``: device time per step of the depthwise kernels, of
    the matrix products outside the SSD (``aten::mm``/``addmm``: the
    projections, the unembedding and their gradients, bf16), of the SSD's
    batched products (``aten::bmm``, fp32), of everything else, and the
    device's idle time against the steps' host-clock time."""
    n = M2_PROFILE_STEPS
    summary, kernels, by_op = _profile_steps(
        torch, train, _m2_argv(n), n,
        ("dw_fwd_kernel", "dw_bwd_weight_partial", "dw_reduce_partials"))
    step_ms = 1e3 * sum(summary["step_s"]) / n
    busy = sum(k["ms_per_step"] for k in kernels)
    ours = sum(k["ms_per_step"] for k in kernels if k["port"])
    mm = sum(by_op.get(k, 0.0) for k in ("aten::mm", "aten::addmm"))
    bmm = sum(by_op.get(k, 0.0) for k in ("aten::bmm", "aten::baddbmm"))
    stats = dict(steps=n, traced_step_ms=step_ms,
                 device_busy_ms_per_step=busy,
                 depthwise_kernels_ms_per_step=ours,
                 projection_matmuls_ms_per_step=mm,
                 ssd_bmm_ms_per_step=bmm,
                 other_device_ms_per_step=busy - ours - mm - bmm,
                 idle_ms_per_step=step_ms - busy,
                 device_busy_share=busy / step_ms if step_ms else None,
                 kernel_names=len(kernels), top=kernels[:15])
    print("mamba2-profile " + json.dumps(stats), flush=True)
    return stats


def _attn_bound(B, T, H, KV, hd, causal, dtype_name, products, nbytes):
    """Least time of ``products`` (B, H, T, T, hd)-sized products over the
    (query, key) pairs the mask keeps (see ``_bound``)."""
    pairs = T * (T + 1) // 2 if causal else T * T
    return roofline.bound(2.0 * products * B * H * hd * pairs, nbytes,
                          dtype_name)


def _flash_errs(label, pairs, lse, lse_p, bf16):
    """Each (kernel, plain) pair of ``pairs`` against its tolerance (bf16:
    per element; fp32: FA_TOL_F32 of the largest value) and lse within
    FA_TOL_LSE -> {name: (max_abs, max_abs / max|plain|, share of the
    per-element limit used or None)}."""
    errs = {"lse": (*_check_close(f"{label} lse", lse, lse_p, FA_TOL_LSE),
                    None)}
    for name, (got, want) in pairs.items():
        if bf16:
            errs[name] = _check_elementwise(f"{label} {name}", got, want,
                                            FA_RTOL_BF16, FA_ATOL_BF16)
        else:
            errs[name] = (*_check_close(f"{label} {name}", got, want,
                                        FA_TOL_F32), None)
    return errs


def _flash_err_fields(errs, bf16):
    """A flash-check row's error readings and the tolerances they meet."""
    fields = dict(max_abs_err={k: e[0] for k, e in errs.items()},
                  max_rel_diff={k: e[1] for k, e in errs.items()},
                  lse_tol_rel_to_max_plain=FA_TOL_LSE)
    if bf16:
        fields.update(rtol=FA_RTOL_BF16, atol_rel_to_max_plain=FA_ATOL_BF16,
                      elementwise_limit_use={k: e[2] for k, e in errs.items()
                                             if e[2] is not None})
    else:
        fields.update(tol_rel_to_max_plain=FA_TOL_F32)
    return fields


def flash_kernel_checks(torch, fa, ref):
    """Phase 10: ``flash_fwd`` and ``flash_bwd`` against their plain
    versions at StarCoder2-3B's attention in the training cell (batch 4 x
    4,096, 24 heads over 2 KV heads of 128, bf16, causal; q a (B, T, KV,
    G, hd) view of the model's (B, T, H, hd)), the backward from the
    kernel's o and lse, two backward launches bitwise equal, each bf16
    element within its own bound; then the same shape in fp32, one
    non-causal, one G = 1 and one ragged case, the forward with a query
    offset at head_dim 64, and forward and backward with fewer queries
    than keys.  Device, call, plain and library times
    beside the bound at the cell's shape."""
    import torch.nn.functional as F

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=DEVICE).manual_seed(41)
    rows = []

    def operands(B, T, KV, G, hd, dtype):
        def rnd(*shape):
            return torch.randn(shape, generator=gen, device=DEVICE).to(dtype)
        q = rnd(B, T, KV * G, hd).view(B, T, KV, G, hd)
        return q, rnd(B, T, KV, hd), rnd(B, T, KV, hd), rnd(B, T, KV, G, hd)

    def check(label, B, T, KV, G, dtype, causal, timed=False, hd=FA_HD):
        q, k, v, do = operands(B, T, KV, G, hd, dtype)

        def fwd():
            return fa.flash_fwd(q, k, v, causal=causal)

        o, lse = fwd()

        def bwd():
            return fa.flash_bwd(q, k, v, o, lse, do, causal=causal)

        grads, again = bwd(), bwd()
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(grads, again)):
            raise AssertionError(f"{label}: two flash_bwd launches differ")
        o_p, lse_p = ref.flash_fwd_ref(q, k, v, causal=causal)
        grads_p = ref.flash_bwd_ref(q, k, v, o, lse, do, causal=causal)
        bf16 = dtype == torch.bfloat16
        pairs = dict(o=(o, o_p), **{n: (g, gp) for n, g, gp in zip(
            ("dq", "dk", "dv"), grads, grads_p)})
        errs = _flash_errs(label, pairs, lse, lse_p, bf16)
        del o_p, lse_p, grads_p, again, pairs
        dtype_name = str(dtype).removeprefix("torch.")
        row = dict(shape=label, B=B, T=T, H=KV * G, KV=KV, hd=hd,
                   dtype=dtype_name, causal=causal,
                   **_flash_err_fields(errs, bf16),
                   bitwise_two_bwd_launches=True, ok=True)
        if timed:
            H, es = KV * G, q.element_size()
            big, small = B * T * H * hd, B * T * KV * hd
            # fwd: q, k, v in, o and lse out; bwd: q, k, v, o, do, lse in,
            # dq, dk, dv out (delta is computed inside the call)
            f_bytes = (2 * big + 2 * small) * es + B * T * H * 4
            b_bytes = (4 * big + 4 * small) * es + B * T * H * 4
            qt, kt, vt = (t.transpose(1, 2) for t in (
                q.reshape(B, T, H, hd), k, v))
            qg, kg, vg = (t.detach().requires_grad_() for t in (qt, kt, vt))

            def lib_fwd():
                return F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal, enable_gqa=True)

            o_lib = F.scaled_dot_product_attention(
                qg, kg, vg, is_causal=causal, enable_gqa=True)
            do_lib = do.reshape(B, T, H, hd).transpose(1, 2)

            def lib_bwd():
                return torch.autograd.grad(o_lib, (qg, kg, vg), do_lib,
                                           retain_graph=True)

            for name, kern, plain, lib, products, nbytes in (
                    ("fwd", fwd, lambda: ref.flash_fwd_ref(
                        q, k, v, causal=causal), lib_fwd, 2, f_bytes),
                    ("bwd", bwd, lambda: ref.flash_bwd_ref(
                        q, k, v, o, lse, do, causal=causal), lib_bwd, 5,
                     b_bytes)):
                row[f"{name}_kernel_ms"] = _device_ms(kern, per_graph=2,
                                                      reps=3)
                row[f"{name}_kernel_call_ms"] = _call_ms(kern, reps=5)
                row[f"{name}_plain_ms"] = _call_ms(plain, reps=3)
                row[f"{name}_library_ms"] = _call_ms(lib, reps=5)
                (row[f"{name}_bound_ms"],
                 row[f"{name}_bound_by"]) = _attn_bound(
                    B, T, H, KV, hd, causal, dtype_name, products, nbytes)
                # the bound's flops over the kernel's time, and its share
                # of the bound
                n_pairs = T * (T + 1) // 2 if causal else T * T
                row[f"{name}_tflops"] = (2.0 * products * B * H * hd * n_pairs
                                         / row[f"{name}_kernel_ms"] / 1e9)
                row[f"{name}_bound_share"] = (row[f"{name}_bound_ms"]
                                              / row[f"{name}_kernel_ms"])
            del o_lib
        rows.append(row)
        print("flash-check " + json.dumps(row), flush=True)
        torch.cuda.empty_cache()

    bf16, f32 = torch.bfloat16, torch.float32
    check(f"cell B={FA_B} T={FA_T} KV={FA_KV} G={FA_G} bf16 causal", FA_B,
          FA_T, FA_KV, FA_G, bf16, True, timed=True)
    check(f"cell B={FA_B} T={FA_T} KV={FA_KV} G={FA_G} fp32 causal", FA_B,
          FA_T, FA_KV, FA_G, f32, True)
    check("bf16 non-causal T=2048", 1, 2048, FA_KV, FA_G, bf16, False)
    check("G=1 bf16 causal T=2048 (8 heads of their own)", 1, 2048, 8, 1,
          bf16, True)
    check("ragged T=1000 bf16 causal", 2, 1000, FA_KV, FA_G, bf16, True)
    check("hd=64 bf16 causal T=2048", 1, 2048, FA_KV, FA_G, bf16, True,
          hd=64)

    # queries at q_offset + t over a longer key row, head_dim 64: the
    # forward only (the backward, as in JAX, takes no offset)
    B, Tq, Tk, KV, G, hd, off = 1, 1024, 2048, 2, 4, 64, 1024

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=DEVICE).to(bf16)

    q, k, v = rnd(B, Tq, KV, G, hd), rnd(B, Tk, KV, hd), rnd(B, Tk, KV, hd)
    o, lse = fa.flash_fwd(q, k, v, causal=True, bq=256, q_offset=off)
    o_p, lse_p = ref.flash_fwd_ref(q, k, v, causal=True, q_offset=off)
    label = f"q_offset={off} Tq={Tq} Tk={Tk} hd={hd} bf16 causal forward"
    errs = _flash_errs(label, dict(o=(o, o_p)), lse, lse_p, True)
    row = dict(shape=label, B=B, T=Tq, Tk=Tk, H=KV * G, KV=KV, hd=hd,
               dtype="bfloat16", causal=True, q_offset=off,
               **_flash_err_fields(errs, True), ok=True)
    rows.append(row)
    print("flash-check " + json.dumps(row), flush=True)

    # the backward with fewer queries than keys (no offset: query t sees
    # keys 0..t, so keys past Tq get no gradient), head_dim 64
    do = rnd(B, Tq, KV, G, hd)
    o, lse = fa.flash_fwd(q, k, v, causal=True)
    grads = fa.flash_bwd(q, k, v, o, lse, do, causal=True)
    again = fa.flash_bwd(q, k, v, o, lse, do, causal=True)
    torch.cuda.synchronize()
    label = f"Tq={Tq} Tk={Tk} hd={hd} bf16 causal backward"
    if not all(torch.equal(a, b) for a, b in zip(grads, again)):
        raise AssertionError(f"{label}: two flash_bwd launches differ")
    o_p, lse_p = ref.flash_fwd_ref(q, k, v, causal=True)
    grads_p = ref.flash_bwd_ref(q, k, v, o, lse, do, causal=True)
    errs = _flash_errs(label, dict(o=(o, o_p), **{
        n: (g, gp) for n, g, gp in zip(("dq", "dk", "dv"), grads, grads_p)}),
        lse, lse_p, True)
    row = dict(shape=label, B=B, T=Tq, Tk=Tk, H=KV * G, KV=KV, hd=hd,
               dtype="bfloat16", causal=True,
               **_flash_err_fields(errs, True),
               bitwise_two_bwd_launches=True, ok=True)
    rows.append(row)
    print("flash-check " + json.dumps(row), flush=True)
    return rows


def _lm_model(torch, cfg, init_model, seed):
    """StarCoder2 from a seed with random non-zero biases and norm
    parameters (zeros and ones at init would leave those paths
    untested)."""
    model = init_model(cfg, seed=seed, device=DEVICE)
    gen = torch.Generator().manual_seed(seed + 100)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() > 2 or (p.dim() == 2 and "dense_layers" not in name):
                continue  # projections and the embedding keep their init
            noise = 0.1 * torch.randn(p.shape, generator=gen)
            p.copy_(p + noise.to(p.device, p.dtype))
    return model


def lm_grad_check(torch, configs, init_model, synthetic, losses, fa):
    """Phase 11: the whole StarCoder2-3B gradient at the full widths (an
    fp32 copy of the config cut to LM_GRAD_LAYERS layers, remat on) at
    batch 2 x 512: the loss and all 19 gradients through the flash
    kernels against autograd over the plain attention on the card, TF32
    off."""
    import dataclasses

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(configs.get("starcoder2-3b"),
                              n_layers=LM_GRAD_LAYERS, dtype="float32",
                              attn_impl="flash")
    model = _lm_model(torch, cfg, init_model, seed=51)
    batch = _batch(torch, synthetic, cfg, LM_GRAD_BATCH, LM_GRAD_SEQ, 52)

    def run(attn_impl):
        def logits(tokens):
            model.cfg = dataclasses.replace(cfg, attn_impl=attn_impl)
            return model(tokens)
        return logits

    L = cfg.n_layers
    return _model_grad_check(
        torch, losses, "starcoder2", cfg, model, batch, run("flash"),
        run("chunked"), (fa.flash_fwd, fa.flash_bwd), (2 * L, L),
        "forward and remat recompute; backward", 19)


def _lm_argv(steps):
    return ["--arch", "starcoder2-3b", "--attn-impl", "flash", "--steps",
            str(steps), "--batch", str(LM_BATCH), "--seq", str(LM_SEQ)]


def lm_train_check(torch, np, train, fa, n_layers):
    """Phase 12: train the full StarCoder2-3B through the launcher's own
    entry point at batch 4 x 4,096 for LM_STEPS steps: every loss and
    gradient norm finite (no step skipped), ``flash_fwd`` launched 2 x 30
    times a step (forward, remat recompute) and ``flash_bwd`` 30 times,
    peak device memory under LM_MEMORY_LIMIT_GB."""
    torch.cuda.empty_cache()
    return _train_check(np, train, "starcoder2", _lm_argv(LM_STEPS),
                        LM_STEPS, (fa.flash_fwd, fa.flash_bwd),
                        (2 * n_layers, n_layers), LM_MEMORY_LIMIT_GB)


def lm_profile(torch, train):
    """Phase 12, second part: LM_PROFILE_STEPS more steps under
    ``torch.profiler``: device time per step of the flash kernels, of the
    matrix products (``aten::mm``/``addmm``: the projections, the
    unembedding and their gradients, bf16), of everything else, and the
    device's idle time against the steps' host-clock time.  The window
    also holds the model's upload before the first step (host-to-device
    copies, outside the steps' time): it is reported apart."""
    torch.cuda.empty_cache()
    n = LM_PROFILE_STEPS
    summary, kernels, by_op = _profile_steps(
        torch, train, _lm_argv(n), n,
        ("flash_fwd_", "flash_bwd_dq_", "flash_bwd_dkv_"))
    step_ms = 1e3 * sum(summary["step_s"]) / n
    upload = sum(k["ms_per_step"] for k in kernels
                 if k["name"].startswith("Memcpy HtoD"))
    busy = sum(k["ms_per_step"] for k in kernels) - upload
    ours = sum(k["ms_per_step"] for k in kernels if k["port"])
    fwd_ms = sum(k["ms_per_step"] for k in kernels
                 if "flash_fwd_" in k["name"])
    mm = sum(by_op.get(k, 0.0) for k in ("aten::mm", "aten::addmm"))
    stats = dict(steps=n, traced_step_ms=step_ms,
                 upload_ms_per_step=upload,
                 device_busy_ms_per_step=busy,
                 flash_kernels_ms_per_step=ours,
                 flash_fwd_ms_per_step=fwd_ms,
                 flash_bwd_ms_per_step=ours - fwd_ms,
                 matmuls_ms_per_step=mm,
                 other_device_ms_per_step=busy - ours - mm,
                 idle_ms_per_step=step_ms - busy,
                 device_busy_share=busy / step_ms if step_ms else None,
                 kernel_names=len(kernels), top=kernels[:15])
    print("starcoder2-profile " + json.dumps(stats), flush=True)
    return stats


def sweep_check(sweep):
    """Phase 13: the paper's Figs 4-6 grid (``repro_torch.tune.sweep``):
    every cell's forward and forward + backward on the kernels (their own
    tiles), cuDNN (TF32 off) and ``"auto"`` after a measured tune of its
    three passes into a fresh cache; every result checked (see the sweep's
    ``--check``); one line a row, then one summary line a figure."""
    import tempfile
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        res = sweep.run(grad=True, tuned=True, algs=True, check=True,
                        device="cuda", cache=os.path.join(tmp, "tune.json"),
                        iters=SWEEP_ITERS,
                        log=lambda r: print("sweep " + json.dumps(r),
                                            flush=True))
    for chk in res["checks"]:
        print("sweep-check " + json.dumps(chk), flush=True)
    for fig, summ in res["summary"].items():
        print(f"sweep-summary {fig} " + json.dumps(summ), flush=True)
    res["seconds"] = time.perf_counter() - t0
    print(f"sweep: {len(res['checks'])} cells, {len(res['rows'])} rows in "
          f"{res['seconds']:.1f} s", flush=True)
    return res


def _build_all(conv1d_brgemm, flash_attention, build):
    """Build the six kernels' libraries at once (one nvcc each, started
    together), timed; and ptxas' lines naming each kernel, its registers
    and spills, and any warning."""
    from concurrent.futures import ThreadPoolExecutor

    def timed(fn):
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0

    with ThreadPoolExecutor(6) as pool:
        t0 = time.perf_counter()
        futs = {name: pool.submit(timed, fn) for name, fn in
                (("conv1d_fwd", conv1d_brgemm._lib),
                 ("conv1d_bwd_weight", conv1d_brgemm._bwd_lib),
                 ("depthwise_conv1d_fwd", conv1d_brgemm._dw_lib),
                 ("depthwise_conv1d_bwd_weight",
                  conv1d_brgemm._dw_bwd_lib),
                 ("flash_fwd", flash_attention._fwd_lib),
                 ("flash_bwd", flash_attention._bwd_lib))}
        each = {name: f.result() for name, f in futs.items()}
        total = time.perf_counter() - t0
    ptxas = {}
    for name in each:
        log = next(build.BUILD_DIR.glob(f"{name}-*.log"), None)
        ptxas[name] = ([ln.strip() for ln in log.read_text().splitlines()
                        if any(w in ln for w in ("entry function",
                                                 "registers", "spill",
                                                 "arning", "(C75"))]
                       if log else [])
    return total, each, ptxas


def _check_no_spills(ptxas, names):
    """Raise if ptxas reports a spill store or load in any kernel of the
    libraries ``names`` (the register-tiled bodies must hold their tiles
    in registers)."""
    import re
    for name in names:
        for ln in ptxas[name]:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", ln)
            if m and (int(m[1]) or int(m[2])):
                raise AssertionError(f"{name} spills: {ln}")


def _check_wgmma_not_serialized(ptxas, names):
    """Raise if ptxas serializes the wgmma instructions of any kernel of
    the libraries ``names`` (notices C7513 and C7520: a register an
    in-flight wgmma reads is rewritten, or a wgmma sits under a branch
    that warpgroups take differently)."""
    for name in names:
        for ln in ptxas[name]:
            if "(C7513)" in ln or "(C7520)" in ln:
                raise AssertionError(f"{name} serializes wgmma: {ln}")


def _kernel_name(mangled):
    """``flash_fwd_wgmma_kernel<128>``, ``flash_fwd_kernel<float, 64>`` or
    ``bwd_weight_partial_taps<float, false>`` from a mangled name of
    the flash or bwd-weight sources; else the name itself."""
    import re
    m = re.search(r"\d+(flash_\w*?kernel)I(f?)Li(\d+)E", mangled)
    if m:
        return f"{m[1]}<{'float, ' if m[2] else ''}{m[3]}>"
    m = re.search(r"\d+(bwd_weight_partial\w*?)I(f|13__nv_bfloat16)"
                  r"((?:L[bi]\d+E)*)E", mangled)
    if m:
        args = ["float" if m[2] == "f" else "bf16"] + [
            ("true" if v == "1" else "false") if k == "b" else v
            for k, v in re.findall(r"L([bi])(\d+)E", m[3])]
        return f"{m[1]}<{', '.join(args)}>"
    return mangled


def _sass_functions(build, lib):
    """{kernel name: its SASS} of a loaded library (``cuobjdump -sass``)."""
    tool = os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", lib._name], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    return {_kernel_name(fn.split()[0]): fn
            for fn in sass.split("Function :")[1:]}


def _loops(fn):
    """The opcodes of each loop of a kernel's SASS: a backward branch and
    the code it jumps back over."""
    import re
    ops = [(int(a, 16), [w for w in t.split() if not w.startswith("@")])
           for a, t in re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", fn)]
    for a, t in ops:
        if t and t[0].startswith("BRA") and t[-1].startswith("0x") and (
                int(t[-1], 16) < a):
            yield [u[0].split(".")[0] for b, u in ops
                   if int(t[-1], 16) <= b <= a and u]


def hgmma_counts(build, flash_attention, conv1d_brgemm):
    """HGMMA instructions (wgmma in SASS) of each flash and each
    conv1d_bwd_weight kernel.  Raises unless all six bf16 flash kernels
    (``*_wgmma_kernel``, head_dim 64 and 128) and every
    ``bwd_weight_partial`` kernel have some: the proof that their
    products run on the tensor cores."""
    counts = {}
    for lib in (flash_attention._fwd_lib(), flash_attention._bwd_lib(),
                conv1d_brgemm._bwd_lib()):
        for name, fn in _sass_functions(build, lib).items():
            counts[name] = fn.count("HGMMA")
    bf16 = {k: n for k, n in counts.items() if "wgmma" in k}
    if len(bf16) != 6 or not all(bf16.values()):
        raise AssertionError(f"flash kernels' HGMMA counts {counts}: each "
                             "of the six bf16 kernels must have some")
    bw = {k: n for k, n in counts.items()
          if k.startswith("bwd_weight_partial")}
    if not any("<float" in k for k in bw) or not all(bw.values()):
        raise AssertionError(f"conv1d_bwd_weight's HGMMA counts {bw}: each "
                             "bwd_weight_partial kernel must have some")
    return counts


def conv_loop_mix(build, conv1d_brgemm):
    """The instruction mix of each ``conv1d_fwd`` kernel's main loop from
    ``cuobjdump -sass``: of the loops with no MUFU (the epilogue's exp and
    tanh), the one with the largest share of FFMA.  {"conv1d_fwd_kernel<J,
    KT>": {"instructions": n, "FFMA": a, "LDS": b}}, loads of any width
    counted as one LDS each."""
    import re
    mix = {}
    for name, fn in _sass_functions(build, conv1d_brgemm._lib()).items():
        m = re.search(r"conv1d_fwd_kernelILi(\d+)ELi(\d+)E", name)
        if not m:
            continue
        best = {"instructions": 1, "FFMA": 0, "LDS": 0}
        for body in _loops(fn):
            if "MUFU" in body:
                continue
            if body.count("FFMA") / len(body) > (best["FFMA"]
                                                  / best["instructions"]):
                best = {"instructions": len(body), "FFMA": body.count("FFMA"),
                        "LDS": body.count("LDS")}
        mix[f"conv1d_fwd_kernel<{m[1]}, {m[2]}>"] = best
    return mix


def bwd_loop_mix(build, conv1d_brgemm):
    """The main loop of each ``bwd_weight_partial`` kernel from
    ``cuobjdump -sass``: of its loops with HGMMA, the one with the largest
    share of HGMMA.  {name: {"instructions": n, "HGMMA": h, "LDS": l}}."""
    mix = {}
    for name, fn in _sass_functions(build, conv1d_brgemm._bwd_lib()).items():
        if not name.startswith("bwd_weight_partial"):
            continue
        best = {"instructions": 1, "HGMMA": 0, "LDS": 0}
        for body in _loops(fn):
            if body.count("HGMMA") / len(body) > (best["HGMMA"]
                                                   / best["instructions"]):
                best = {"instructions": len(body),
                        "HGMMA": body.count("HGMMA"),
                        "LDS": body.count("LDS")}
        mix[name] = best
    return mix


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="also write every result as JSON to this file")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; nothing was run")
    from repro_torch import configs
    from repro_torch.core import blocks
    from repro_torch.data import synthetic
    from repro_torch.kernels import (build, conv1d_brgemm, flash_attention,
                                     ops, ref)
    from repro_torch.kernels import epilogue as ep
    from repro_torch.launch import serve, train
    from repro_torch.models import init_model
    from repro_torch.optim import adamw
    from repro_torch.train import losses
    from repro_torch.tune import sweep

    card = _card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind}; nvidia-smi: {card}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    build_s, build_each, ptxas = _build_all(conv1d_brgemm, flash_attention,
                                            build)
    print(f"built the six kernels in {build_s:.1f} s (" + ", ".join(
        f"{k} {v:.1f} s" for k, v in build_each.items()) + ")", flush=True)
    for name, lines in ptxas.items():
        for ln in lines:
            print(f"ptxas {name}: {ln}")
    _check_no_spills(ptxas, ("conv1d_fwd", "depthwise_conv1d_fwd",
                             "conv1d_bwd_weight"))
    _check_wgmma_not_serialized(ptxas, ("conv1d_bwd_weight", "flash_fwd",
                                        "flash_bwd"))
    hgmma = hgmma_counts(build, flash_attention, conv1d_brgemm)
    print("hgmma " + json.dumps(hgmma), flush=True)
    loop_mix = conv_loop_mix(build, conv1d_brgemm)
    print("conv1d_fwd main loops " + json.dumps(loop_mix), flush=True)
    bwd_mix = bwd_loop_mix(build, conv1d_brgemm)
    print("bwd_weight_partial main loops " + json.dumps(bwd_mix), flush=True)

    rows = kernel_checks(torch, conv1d_brgemm, ops, ref, ep)
    stats = serve_check(torch, np, configs, blocks, serve, conv1d_brgemm)
    bwd_rows = bwd_kernel_checks(torch, conv1d_brgemm, ref)
    grad_stats = model_grad_check(torch, configs, blocks, synthetic, adamw,
                                  conv1d_brgemm)
    train_stats = train_check(torch, np, train, conv1d_brgemm)
    profile_stats = train_profile(torch, train)
    dw_rows = dw_kernel_checks(torch, conv1d_brgemm, ref)
    m2_grad = mamba2_grad_check(torch, configs, init_model, synthetic,
                                losses, conv1d_brgemm)
    m2_layers = configs.get("mamba2-370m").n_layers
    m2_train = mamba2_train_check(torch, np, train, conv1d_brgemm, m2_layers)
    m2_profile = mamba2_profile(torch, train)
    fa_rows = flash_kernel_checks(torch, flash_attention, ref)
    lm_grad = lm_grad_check(torch, configs, init_model, synthetic, losses,
                            flash_attention)
    lm_layers = configs.get("starcoder2-3b").n_layers
    lm_train = lm_train_check(torch, np, train, flash_attention, lm_layers)
    lm_prof = lm_profile(torch, train)
    sweep_res = sweep_check(sweep)

    main_row = next(r for r in rows if r["shape"] == MAIN_SHAPE)
    # device time of the 25 kernels of one stream step, from the per-layer
    # device times above, against the host-clock chunk time
    per_layer = {r["shape"].split()[0]: r["kernel_ms"] for r in rows
                 if r.get("kernel_ms") is not None
                 and r["shape"].endswith("stream")}
    step_kernel_ms = (per_layer["stem"] + 11 * per_layer["conv1"]
                      + 11 * per_layer["conv2"] + per_layer["head_signal"]
                      + per_layer["head_peak"])
    stats["step_kernel_ms"] = step_kernel_ms
    # host time ops.conv1d adds over the wrapper, summed over a step's 25
    added = {r["shape"].split()[0]: r["ops_added_host_us"] for r in rows
             if "ops_added_host_us" in r}
    stats["step_ops_added_host_us"] = (
        added["stem"] + 11 * added["conv1"] + 11 * added["conv2"]
        + added["head_signal"] + added["head_peak"])
    stats["kernel_share_of_chunk_p50"] = step_kernel_ms / stats["chunk_p50_ms"]
    print(f"stream step: kernels {step_kernel_ms:.4f} ms of device time, "
          f"chunk p50 {stats['chunk_p50_ms']:.4f} ms on the host clock; "
          f"ops.conv1d adds {stats['step_ops_added_host_us']:.1f} us of "
          "host time over the bare wrapper calls", flush=True)

    # device time of one training step's kernels, from the per-shape
    # device times above: 25 forward (stem, 22 conv, 2 heads), 24 bwd-data
    # (22 conv; the heads' is the 1->15 shape) and 25 bwd-weight passes
    t = {(r["pass_"], r["layer"]): r["kernel_ms"] for r in bwd_rows
         if r.get("kernel_ms") is not None}
    fwd_ms = t["fwd", "stem"] + 22 * t["fwd", "conv"] + 2 * t["fwd", "head"]
    bd_ms = 22 * t["bwd_data", "conv"] + 2 * t["bwd_data", "head"]
    bw_ms = (t["bwd_weight", "stem"] + 22 * t["bwd_weight", "conv"]
             + 2 * t["bwd_weight", "head"])
    train_stats.update(step_fwd_kernel_ms=fwd_ms,
                       step_bwd_data_kernel_ms=bd_ms,
                       step_bwd_weight_kernel_ms=bw_ms,
                       step_kernel_ms=fwd_ms + bd_ms + bw_ms)
    train_stats["kernel_share_of_step_p50"] = (
        train_stats["step_kernel_ms"] / train_stats["step_p50_ms"])
    print(f"train step: kernels {train_stats['step_kernel_ms']:.3f} ms of "
          f"device time (fwd {fwd_ms:.3f}, bwd-data {bd_ms:.3f}, "
          f"bwd-weight {bw_ms:.3f}), step p50 "
          f"{train_stats['step_p50_ms']:.3f} ms, "
          f"{train_stats['samples_per_s']:.2f} samples/s", flush=True)

    fp32_bwd = [r for r in bwd_rows if r["dtype"] == "float32"]
    conv_fwd = next(r for r in bwd_rows
                    if (r["pass_"], r["layer"], r["dtype"])
                    == ("fwd", "conv", "float32"))
    conv_bd = next(r for r in bwd_rows
                   if (r["pass_"], r["layer"], r["dtype"])
                   == ("bwd_data", "conv", "float32"))
    conv_bw = next(r for r in bwd_rows
                   if (r["pass_"], r["layer"], r["dtype"])
                   == ("bwd_weight", "conv", "float32"))
    fwd_entry = dict(
        name="conv1d_fwd", route="cuda",
        source="src/repro_torch/kernels/csrc/conv1d_fwd.cu",
        replaces="src/repro/kernels/conv1d_brgemm.py:492",
        launches=train_stats["conv1d_fwd_launches"],
        max_abs_err=max([r["max_abs_err"] for r in rows
                         if r["dtype"] == "float32"]
                        + [r["max_abs_err"] for r in fp32_bwd
                           if r["pass_"] != "bwd_weight"]),
        ms=conv_fwd["kernel_ms"], plain_ms=conv_fwd["plain_ms"],
        bound_ms=conv_fwd["bound_ms"], bound_by=conv_fwd["bound_by"],
        library_ms=conv_fwd["library_ms"], shape=conv_fwd["shape"],
        tile=conv_fwd["tile"], gflop_per_s=conv_fwd["gflop_per_s"],
        bound_share=conv_fwd["bound_share"],
        launches_per_step=train_stats["fwd_launches_per_step"],
        bwd_data={k: conv_bd[k] for k in (
            "shape", "kernel_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "max_abs_err", "tile", "gflop_per_s",
            "bound_share")},
        serve=dict(shape=MAIN_SHAPE, launches=stats["launches"],
                   launches_per_step=stats["launches_per_step"],
                   ms=main_row["kernel_ms"], plain_ms=main_row["plain_ms"],
                   bound_ms=main_row["bound_ms"],
                   bound_by=main_row["bound_by"],
                   library_ms=main_row["library_ms"],
                   tile=main_row["tile"],
                   gflop_per_s=main_row["gflop_per_s"],
                   bound_share=main_row["bound_share"],
                   max_rel_diff=max(r["max_rel_diff"] for r in rows)))
    # bound_ms: the three-term TF32 bound; fma_bound_ms: the fp32 FMA one
    bw_keys = ("shape", "kernel_ms", "plain_ms", "library_ms", "bound_ms",
               "bound_by", "bound_share", "fma_bound_ms", "fma_bound_by",
               "fma_bound_share", "gflop_per_s")
    bw_entry = dict(
        name="conv1d_bwd_weight", route="cuda",
        source="src/repro_torch/kernels/csrc/conv1d_bwd_weight.cu",
        replaces="src/repro/kernels/conv1d_brgemm.py:688",
        launches=train_stats["conv1d_bwd_weight_launches"],
        max_abs_err=max(r["max_abs_err"] for r in fp32_bwd
                        if r["pass_"] == "bwd_weight"),
        ms=conv_bw["kernel_ms"], plain_ms=conv_bw["plain_ms"],
        bound_ms=conv_bw["bound_ms"], bound_by=conv_bw["bound_by"],
        library_ms=conv_bw["library_ms"], shape=conv_bw["shape"],
        bound_share=conv_bw["bound_share"],
        fma_bound_ms=conv_bw["fma_bound_ms"],
        fma_bound_share=conv_bw["fma_bound_share"],
        gflop_per_s=conv_bw["gflop_per_s"],
        layers={layer: {k: r[k] for k in bw_keys}
                for r in bwd_rows for layer in ("stem", "head")
                if (r["pass_"], r.get("layer"), r["dtype"])
                == ("bwd_weight", layer, "float32")},
        hgmma={k: n for k, n in hgmma.items()
               if k.startswith("bwd_weight_partial")},
        main_loops=bwd_mix,
        launches_per_step=train_stats["bwd_weight_launches_per_step"])
    # the depthwise pair: times at the Mamba2 layer shape, launches from
    # the Mamba2 training run, and the device time of one step's launches
    dw = {r["pass_"]: r for r in dw_rows if "kernel_ms" in r}
    m2_train.update(
        step_dw_fwd_kernel_ms=2 * m2_layers * dw["fwd"]["kernel_ms"],
        step_dw_bwd_data_kernel_ms=m2_layers * dw["bwd_data"]["kernel_ms"],
        step_dw_bwd_weight_kernel_ms=m2_layers * dw["bwd_weight"][
            "kernel_ms"],
        step_dw_bound_ms=m2_layers * (2 * dw["fwd"]["bound_ms"]
                                      + dw["bwd_data"]["bound_ms"]
                                      + dw["bwd_weight"]["bound_ms"]))
    m2_train["step_dw_kernel_ms"] = (m2_train["step_dw_fwd_kernel_ms"]
                                     + m2_train["step_dw_bwd_data_kernel_ms"]
                                     + m2_train[
                                         "step_dw_bwd_weight_kernel_ms"])
    print(f"mamba2 train step: depthwise kernels "
          f"{m2_train['step_dw_kernel_ms']:.3f} ms of device time (bound "
          f"{m2_train['step_dw_bound_ms']:.3f} ms), step p50 "
          f"{m2_train['step_p50_ms']:.1f} ms, "
          f"{m2_train['tokens_per_s']:.0f} tokens/s, peak memory "
          f"{m2_train['peak_memory_gb']:.2f} GB", flush=True)
    dw_fwd_entry = dict(
        name="depthwise_conv1d_fwd", route="cuda",
        source="src/repro_torch/kernels/csrc/depthwise_conv1d_fwd.cu",
        replaces="src/repro/kernels/conv1d_brgemm.py:843",
        launches=m2_train["launches"]["depthwise_conv1d_fwd"],
        max_abs_err=max(r["max_abs_err"] for r in dw_rows
                        if r["pass_"] in ("fwd", "bwd_data")),
        ms=dw["fwd"]["kernel_ms"], plain_ms=dw["fwd"]["plain_ms"],
        bound_ms=dw["fwd"]["bound_ms"], bound_by=dw["fwd"]["bound_by"],
        library_ms=dw["fwd"]["library_ms"], shape=dw["fwd"]["shape"],
        tile=dw["fwd"]["tile"], gb_per_s=dw["fwd"]["gb_per_s"],
        bound_share=dw["fwd"]["bound_share"],
        launches_per_step=m2_train["launches_per_step"][
            "depthwise_conv1d_fwd"],
        bwd_data={k: dw["bwd_data"][k] for k in (
            "shape", "kernel_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "max_abs_err", "tile", "gb_per_s",
            "bound_share")})
    dw_bw_entry = dict(
        name="depthwise_conv1d_bwd_weight", route="cuda",
        source="src/repro_torch/kernels/csrc/depthwise_conv1d_bwd_weight.cu",
        replaces="src/repro/kernels/conv1d_brgemm.py:998",
        launches=m2_train["launches"]["depthwise_conv1d_bwd_weight"],
        max_abs_err=max(r["max_abs_err"] for r in dw_rows
                        if r["pass_"] == "bwd_weight"),
        ms=dw["bwd_weight"]["kernel_ms"],
        plain_ms=dw["bwd_weight"]["plain_ms"],
        bound_ms=dw["bwd_weight"]["bound_ms"],
        bound_by=dw["bwd_weight"]["bound_by"],
        library_ms=dw["bwd_weight"]["library_ms"],
        shape=dw["bwd_weight"]["shape"],
        launches_per_step=m2_train["launches_per_step"][
            "depthwise_conv1d_bwd_weight"])
    # the flash pair: times at the cell's attention shape, launches from
    # the StarCoder2 training run, and the device time of one step's
    cell = fa_rows[0]
    lm_train.update(
        step_flash_fwd_kernel_ms=2 * lm_layers * cell["fwd_kernel_ms"],
        step_flash_bwd_kernel_ms=lm_layers * cell["bwd_kernel_ms"],
        step_flash_bound_ms=lm_layers * (2 * cell["fwd_bound_ms"]
                                         + cell["bwd_bound_ms"]))
    lm_train["step_flash_kernel_ms"] = (lm_train["step_flash_fwd_kernel_ms"]
                                        + lm_train["step_flash_bwd_kernel_ms"])
    print(f"starcoder2 train step: flash kernels "
          f"{lm_train['step_flash_kernel_ms']:.1f} ms of device time (bound "
          f"{lm_train['step_flash_bound_ms']:.2f} ms), step p50 "
          f"{lm_train['step_p50_ms']:.1f} ms, "
          f"{lm_train['tokens_per_s']:.0f} tokens/s, peak memory "
          f"{lm_train['peak_memory_gb']:.2f} GB", flush=True)
    flash_entries = []
    for name, line, pas, errs in (
            ("flash_fwd", 60, "fwd", ("o", "lse")),
            ("flash_bwd", 142, "bwd", ("dq", "dk", "dv"))):
        flash_entries.append(dict(
            name=name, route="cuda",
            source=f"src/repro_torch/kernels/csrc/{name}.cu",
            replaces=f"src/repro/kernels/flash_attention.py:{line}",
            launches=lm_train["launches"][name],
            max_abs_err=max(r["max_abs_err"][e] for r in fa_rows
                            for e in errs if e in r["max_abs_err"]),
            max_rel_diff=max(r["max_rel_diff"][e] for r in fa_rows
                             for e in errs if e in r["max_rel_diff"]),
            ms=cell[f"{pas}_kernel_ms"], call_ms=cell[f"{pas}_kernel_call_ms"],
            plain_ms=cell[f"{pas}_plain_ms"],
            bound_ms=cell[f"{pas}_bound_ms"],
            bound_by=cell[f"{pas}_bound_by"],
            library_ms=cell[f"{pas}_library_ms"], shape=cell["shape"],
            tflops=cell[f"{pas}_tflops"],
            bound_share=cell[f"{pas}_bound_share"],
            hgmma={k: n for k, n in hgmma.items() if k.startswith(name)},
            launches_per_step=lm_train["launches_per_step"][name]))
    kernels = [fwd_entry, bw_entry, dw_fwd_entry, dw_bw_entry,
               *flash_entries]
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(card=card, kind=kind, torch=torch.__version__,
                           cuda=torch.version.cuda, build_s=build_s,
                           build_each_s=build_each, ptxas=ptxas,
                           hgmma=hgmma, conv1d_fwd_loops=loop_mix,
                           bwd_weight_loops=bwd_mix,
                           kernel_checks=rows, serve=stats,
                           bwd_checks=bwd_rows, model_grad=grad_stats,
                           train=train_stats, train_profile=profile_stats,
                           dw_checks=dw_rows, mamba2_grad=m2_grad,
                           mamba2_train=m2_train, mamba2_profile=m2_profile,
                           flash_checks=fa_rows, starcoder2_grad=lm_grad,
                           starcoder2_train=lm_train,
                           starcoder2_profile=lm_prof, sweep=sweep_res,
                           kernels=kernels), f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
