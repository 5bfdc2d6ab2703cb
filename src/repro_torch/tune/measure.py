"""Timing of tuner candidates (counterpart of ``repro/tune/measure.py``).

On the card a call's time is device time: ``per_graph`` calls captured in
one CUDA graph, replayed back to back between two CUDA events, so no host
work sits between the kernels; the median over the replays (``device_ms``,
what ``chip_smoke.py`` times every kernel with).  On the CPU it is the
median ``time.perf_counter`` time of single calls.

A forward problem times the forward call with the candidate's backend
and tile.  A backward problem pins the candidate on its own pass
(``bwd_data_cfg`` / ``bwd_weight_cfg``; the forward runs at the device's
default) and times ``torch.autograd.grad`` of that pass alone: only x
asks for a gradient when bwd-data is tuned, only the weights and bias
when bwd-weight is, so the other backward pass does not run.
"""
from __future__ import annotations

import contextlib
import statistics
import time

import torch

from repro_torch.kernels import epilogue as _ep
from repro_torch.kernels import ops

from .problem import PASS_BWD_DATA, PASS_FWD, ConvProblem
from .space import Candidate


def device_ms(fn, per_graph: int = 10, reps: int = 5,
              stream: torch.cuda.Stream | None = None) -> float:
    """Device time of one call in ms: ``per_graph`` calls captured in one
    CUDA graph on ``stream`` (a new side stream by default), replayed
    ``reps`` times between two events; the median over the replays.
    Work ``fn`` depends on that ran on ``stream`` (an autograd forward
    whose backward ``fn`` runs) is captured with the rest."""
    side = stream or torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
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
    return statistics.median(times)


def median_time(fn, *, device: torch.device, iters: int = 5,
                warmup: int = 2, stream=None) -> float:
    """Seconds per call of ``fn`` on ``device``: graph-replayed device time
    on a card (``iters`` replays of 10 calls), else the host clock."""
    if device.type == "cuda":
        return device_ms(fn, reps=iters, stream=stream) / 1e3
    for _ in range(warmup):
        fn()
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def problem_operands(prob: ConvProblem, *, device: torch.device,
                     seed: int = 0):
    """Random layer operands of one problem, drawn on the CPU from a seed:
    the input's width gives output width Q under the problem's padding."""
    has_bias, activation, has_residual = _ep.parse(prob.epilogue)
    nf = prob.C if prob.depthwise else prob.K
    dtype = getattr(torch, prob.dtype)
    W = prob.Q + prob.span if prob.padding == "VALID" else prob.Q
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((prob.N, prob.C, W), generator=gen)
    wshape = (prob.S, prob.C) if prob.depthwise else (prob.S, prob.K, prob.C)
    w = torch.randn(wshape, generator=gen) * 0.1
    bias = torch.randn((nf,), generator=gen) * 0.1 if has_bias else None
    res = torch.randn((prob.N, nf, prob.Q), generator=gen) \
        if has_residual else None

    def put(t):
        return None if t is None else t.to(device=device, dtype=dtype)

    return put(x), put(w), put(bias), put(res), activation


def time_pass(conv, x, w, pass_: str, *, device: torch.device,
              layer: dict, call: dict, iters: int = 5, warmup: int = 2
              ) -> float:
    """Seconds of one pass of ``conv(x, w, **layer, **call)`` (``call``:
    the backend and any pins).  The forward is timed without autograd;
    a backward pass as ``torch.autograd.grad`` of that pass alone, its
    forward run once beforehand on the stream the backward is captured
    on."""
    if pass_ == PASS_FWD:
        def fwd():
            with torch.no_grad():
                return conv(x, w, **layer, **call)
        return median_time(fwd, device=device, iters=iters, warmup=warmup)
    x, w = x.detach(), w.detach()
    bias = layer.get("bias")
    bias = None if bias is None else bias.detach()
    if pass_ == PASS_BWD_DATA:
        wanted = [x.requires_grad_()]
    else:
        wanted = [t.requires_grad_() for t in (w, bias) if t is not None]
    layer = {**layer, "bias": bias}
    stream, ctx = None, contextlib.nullcontext()
    if device.type == "cuda":
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        ctx = torch.cuda.stream(stream)
    with ctx:
        y = conv(x, w, **layer, **call)
        g = torch.ones_like(y)

    def bwd():
        return torch.autograd.grad(y, wanted, g, retain_graph=True)

    return median_time(bwd, device=device, iters=iters, warmup=warmup,
                       stream=stream)


def time_candidate(cand: Candidate, prob: ConvProblem, *,
                   device: torch.device, iters: int = 5, warmup: int = 2,
                   seed: int = 0) -> float:
    """Seconds per execution of one candidate on the problem's pass, with
    the problem's epilogue: a backward candidate is pinned on its own
    pass, the forward running at the device's default."""
    x, w, bias, res, activation = problem_operands(prob, device=device,
                                                   seed=seed)
    conv = ops.depthwise_conv1d if prob.depthwise else ops.conv1d
    layer = dict(bias=bias, activation=activation, residual=res,
                 dilation=prob.dilation, padding=prob.padding)
    if prob.pass_ == PASS_FWD:
        call = dict(backend=cand.backend, tile=cand.tile)
    else:
        cfg = ops.PassConfig(cand.backend, cand.tile, cand.body)
        pin = ("bwd_data_cfg" if prob.pass_ == PASS_BWD_DATA
               else "bwd_weight_cfg")
        call = {"backend": "cuda" if x.is_cuda else "ref", pin: cfg}
    return time_pass(conv, x, w, prob.pass_, device=device, layer=layer,
                     call=call, iters=iters, warmup=warmup)
