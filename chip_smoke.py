#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--out results/chip_smoke.json]

Phases (any failed check raises, so the run exits non-zero):
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
     build the CUDA kernel from the checkout's sources, timed;
  2. the kernel ``conv1d_fwd`` against its plain PyTorch version on the
     card at every layer shape of the serving path (stem 1->15, conv1,
     conv2 with residual, the two 15->1 heads), at the stream-step shape
     (4 slots x chunk 4096 over a 400 + 4096 window) and at the one-shot
     causal width 60,000, in fp32; the same in bf16 at C=K=16; gelu, silu
     and SAME padding once each.  Device times (CUDA graphs replayed
     between CUDA events) of the kernel, the plain version and
     ``F.conv1d`` (weights permuted to (K, C, S), cuDNN TF32 off) beside
     the least time the card could take, and the time of one call as a
     caller sees it (host work included);
  3. serve the full ``atacworks`` config (C=K=15, S=51, d=8, 25 layers;
     seeded weights, random non-zero biases) with ``ConvStreamServer``: 4
     slots, chunk 4096, 4096-sample histories, 8 queued ragged streams of
     about 50,000 samples; both outputs of every served stream must equal
     the one-shot causal forward through the kernel bitwise, and stream 0
     the plain forward within atol=rtol=1e-4; the kernel must have
     launched 25 times per stream step.  The same streams are then served
     again SERVE_REPEATS times, so chunk p50/p99 and samples/s are read
     per run and pooled, with their spread between runs;
  4. a JSON line of the kernels, the card's line, and last the result line.

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

# H100 SXM published peaks (dense): fp32 outside the tensor cores, bf16 in
# them, and HBM3 bandwidth.  Stated against the card's power limit.
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12

TOL = {"float32": (1e-4, 1e-4),   # 765-term fp32 sums taken in another order
       "bfloat16": (1e-2, 1e-2)}  # outputs rounded to bf16 (2^-8 relative)

MAIN_SHAPE = "conv1 b+relu 15->15 stream"  # the row the kernels line reports
DEVICE = "cuda"

# the serving cell: 4 slots x chunk 4096, 4096-sample histories, 8 queued
# streams of 50,000 + U[0, 4096) samples (more streams than slots, ragged)
SLOTS, CHUNK, PROMPT_LEN, STREAMS, TRACK_LEN = 4, 4096, 4096, 8, 50000
SERVE_REPEATS = 5  # timed runs after the checked one


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
    host work sits between the kernels.  Median over the replays."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    graph.replay()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / per_graph)
    times.sort()
    return times[len(times) // 2]


def _bound_ms(N, C, K, S, Wp, Q, dtype_name, has_bias, has_res, out_bytes):
    """Least time for one layer: the larger of its bytes (each input read
    once, the output written once) over HBM bandwidth and its flops over
    the peak for the input type."""
    es = 4 if dtype_name == "float32" else 2
    nbytes = (N * C * Wp + S * K * C + K * has_bias + N * K * Q * has_res) * es
    nbytes += N * K * Q * out_bytes
    flops = 2.0 * N * K * C * S * Q
    t_mem = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return max(t_mem, t_ops), ("operations" if t_ops >= t_mem else "bytes")


def kernel_checks(torch, conv1d_brgemm, ops, ref, ep):
    """Phase 2: every layer shape of the path, kernel vs plain version."""
    import torch.nn.functional as F

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    S, d = 51, 8
    span = (S - 1) * d
    # (label, C, K, activation, residual, out_dtype is fp32)
    layers = [("stem", 1, 15, "relu", False, False),
              ("conv1", 15, 15, "relu", False, False),
              ("conv2", 15, 15, "relu", True, False),
              ("head_signal", 15, 1, "relu", False, True),
              ("head_peak", 15, 1, None, False, True)]
    cases = []
    for name, C, K, act, res, f32out in layers:
        cases.append((name, C, K, act, res, f32out, "float32", 4, 4096,
                      "CAUSAL", "stream"))
        cases.append((name, C, K, act, res, f32out, "float32", 1, 60000,
                      "CAUSAL", "oneshot"))
    for name, C, K, act, res, f32out in layers:  # atacworks-bf16: C=K=16
        cases.append((name, 1 if C == 1 else 16, 1 if K == 1 else 16, act,
                      res, f32out, "bfloat16", 4, 4096, "CAUSAL", "stream"))
    cases.append(("conv1", 15, 15, "gelu", False, False, "float32", 4, 4096,
                  "SAME", "stream"))
    cases.append(("conv2", 15, 15, "silu", True, False, "float32", 4, 4096,
                  "CAUSAL", "stream"))

    rows = []
    for (name, C, K, act, res, f32out, dt, N, Q, padding, where) in cases:
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
                   atol=atol, rtol=rtol, ok=ok)
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
            row["bound_ms"], row["bound_by"] = _bound_ms(
                N, C, K, S, Q + span, Q, dt, True, res, 4)
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
    from repro_torch.kernels import build, conv1d_brgemm, ops, ref
    from repro_torch.kernels import epilogue as ep
    from repro_torch.launch import serve

    card = _card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind}; nvidia-smi: {card}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    conv1d_brgemm._lib()  # builds and loads the .so
    build_s = time.perf_counter() - t0
    log = next(build.BUILD_DIR.glob("conv1d_fwd-*.log"), None)
    ptxas = ([ln.strip() for ln in log.read_text().splitlines()
              if "registers" in ln or "spill" in ln] if log else [])
    print(f"built conv1d_fwd in {build_s:.1f} s", flush=True)
    for ln in ptxas:
        print("ptxas " + ln)

    rows = kernel_checks(torch, conv1d_brgemm, ops, ref, ep)
    stats = serve_check(torch, np, configs, blocks, serve, conv1d_brgemm)

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
    stats["kernel_share_of_chunk_p50"] = step_kernel_ms / stats["chunk_p50_ms"]
    print(f"stream step: kernels {step_kernel_ms:.4f} ms of device time, "
          f"chunk p50 {stats['chunk_p50_ms']:.4f} ms on the host clock",
          flush=True)
    entry = dict(
        name="conv1d_fwd", route="cuda",
        source="src/repro_torch/kernels/csrc/conv1d_fwd.cu",
        replaces="src/repro/kernels/conv1d_brgemm.py:492",
        launches=stats["launches"],
        max_abs_err=max(r["max_abs_err"] for r in rows
                        if r["dtype"] == "float32"),
        ms=main_row["kernel_ms"], plain_ms=main_row["plain_ms"],
        bound_ms=main_row["bound_ms"], bound_by=main_row["bound_by"],
        library_ms=main_row["library_ms"],
        shape=MAIN_SHAPE, max_rel_diff=max(r["max_rel_diff"] for r in rows),
        launches_per_step=stats["launches_per_step"])
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(card=card, kind=kind, torch=torch.__version__,
                           cuda=torch.version.cuda, build_s=build_s,
                           ptxas=ptxas, kernel_checks=rows, serve=stats,
                           kernels=[entry]), f, indent=1)
    print(json.dumps({"kernels": [entry]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
