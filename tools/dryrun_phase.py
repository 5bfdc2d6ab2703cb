"""Phase 28 of ``chip_smoke.py`` alone: the dry-run's count of one rank
(StarCoder2-3B with flash and Mamba2-370M, each cut to 2 layers, at
``prefill_32k`` on the (16, 16) production mesh, the origin) against the
same rank run on the card, and ``flash_fwd`` and ``depthwise_conv1d_fwd``
at that rank's 32,768 columns against their plain versions, after
building the six kernels.  It prints the card's name and power limit
before and after, the build's seconds, the phase's own lines and its
seconds, and writes the phase's results as JSON to ``--out``.  Run on a
machine with a GPU, from the root of the repository:

    python3 tools/dryrun_phase.py [--out chiprun_out/dryrun_phase.json]
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))
import chip_smoke as cs  # noqa: E402

if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("dryrun_phase: no CUDA device; nothing was run")
    from repro_torch import configs
    from repro_torch.kernels import build, conv1d_brgemm, flash_attention, ref
    print(cs._card_line(), flush=True)
    t = time.perf_counter()
    cs._build_all(conv1d_brgemm, flash_attention, build)
    print(f"build {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    res = cs.dryrun_check(torch, configs, ref, conv1d_brgemm,
                          flash_attention)
    print(f"phase 28 alone {time.perf_counter() - t:.1f} s", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(card=cs._card_line(), torch=torch.__version__,
                           dryrun=res), f, indent=1, default=str)
    print(cs._card_line())
