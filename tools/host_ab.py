"""Compare two checkouts' host-clock metrics on one card, in alternation.

    python tools/host_ab.py --a PARENT_ROOT --b . [--rounds 2]
        [--out host_ab.json]

The serving and AtacWorks training cells are host-bound, so their host
metrics move with the machine as much as with the code.  This runs, each
in a process of its own, phase 2 (the forward kernel rows, which time the
host work ``ops.conv1d`` adds over the bare wrapper), phase 3 (serving)
and phase 6 (AtacWorks training) of each checkout's ``chip_smoke.py``, in
the order A B B A, ``--rounds`` times.  Each run prints one line
``host-ab {...}``: the serving chunk p50 (pooled over its repeats) and
p99, samples/s, the host time ``ops.conv1d`` adds over the wrapper in a
stream step's 25 calls, and the training step p50 and samples/s.  The
last line, ``host-ab-summary {...}``, gives per metric each side's
values, their medians, B's median over A's and whether the two sides'
ranges overlap.  Each checkout builds its kernels once, in its own
``build/``.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

# one run of one checkout: phases 2, 3 and 6 of its chip_smoke.py
CHILD = r"""
import json, os, sys
root = sys.argv[1]
sys.path[:0] = [os.path.join(root, "src"), root]
import numpy as np
import torch
import chip_smoke as cs
from repro_torch import configs
from repro_torch.core import blocks
from repro_torch.kernels import conv1d_brgemm, ops, ref
from repro_torch.kernels import epilogue as ep
from repro_torch.launch import serve, train

rows = cs.kernel_checks(torch, conv1d_brgemm, ops, ref, ep)
added = {r["shape"].split()[0]: r["ops_added_host_us"] for r in rows
         if "ops_added_host_us" in r}
s = cs.serve_check(torch, np, configs, blocks, serve, conv1d_brgemm)
t = cs.train_check(torch, np, train, conv1d_brgemm)
print("host-ab-run " + json.dumps(dict(
    serve_pooled_chunk_p50_ms=s["pooled_chunk_p50_ms"],
    serve_pooled_chunk_p99_ms=s["pooled_chunk_p99_ms"],
    serve_samples_per_s=s["samples_per_s"],
    step_ops_added_host_us=added["stem"] + 11 * added["conv1"]
    + 11 * added["conv2"] + added["head_signal"] + added["head_peak"],
    train_step_p50_ms=t["step_p50_ms"],
    train_samples_per_s=t["samples_per_s"])), flush=True)
"""


def run_once(root: str, timeout: float) -> dict:
    out = subprocess.run([sys.executable, "-c", CHILD, os.path.abspath(root)],
                         capture_output=True, text=True, timeout=timeout)
    line = next((ln for ln in out.stdout.splitlines()
                 if ln.startswith("host-ab-run ")), None)
    if out.returncode != 0 or line is None:
        raise RuntimeError(f"run of {root} failed ({out.returncode}):\n"
                           f"{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
    return json.loads(line.split(" ", 1)[1])


def summarize(runs: list[dict]) -> dict:
    out = {}
    for metric in runs[0]["metrics"]:
        vals = {side: [r["metrics"][metric] for r in runs
                       if r["side"] == side] for side in ("a", "b")}
        med = {side: statistics.median(v) for side, v in vals.items()}
        out[metric] = dict(
            a=vals["a"], b=vals["b"], a_median=med["a"],
            b_median=med["b"], b_over_a=med["b"] / med["a"],
            ranges_overlap=(min(vals["b"]) <= max(vals["a"])
                            and min(vals["a"]) <= max(vals["b"])))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--a", required=True, help="root of checkout A")
    ap.add_argument("--b", required=True, help="root of checkout B")
    ap.add_argument("--rounds", type=int, default=2,
                    help="rounds of A B B A")
    ap.add_argument("--timeout", type=float, default=600,
                    help="seconds one run may take")
    ap.add_argument("--out", default=None, help="also write JSON here")
    args = ap.parse_args(argv)
    runs = []
    for rnd in range(args.rounds):
        for side in ("a", "b", "b", "a"):
            metrics = run_once(getattr(args, side), args.timeout)
            runs.append(dict(round=rnd, side=side, metrics=metrics))
            print("host-ab " + json.dumps(runs[-1]), flush=True)
    summary = summarize(runs)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(a=args.a, b=args.b, runs=runs, summary=summary),
                      f, indent=1)
    print("host-ab-summary " + json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
