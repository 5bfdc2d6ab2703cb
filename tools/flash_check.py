"""A short card check of the flash kernels at every head dimension they
take, before a whole ``chip_smoke.py`` run.

    python tools/flash_check.py

Builds the six kernel libraries (``chip_smoke._build_all``), fails if a
flash kernel spills or has its wgmmas serialized, prints each flash
kernel's HGMMA count, then holds ``flash_fwd`` and ``flash_bwd`` against
their plain versions by ``chip_smoke.py``'s rule (``_flash_check``): at
head_dim 112 in bf16 (causal and ragged with G = 2, non-causal) and fp32
(causal, and non-causal ragged), at 128 and 64 in bf16 and at 64 in fp32,
at 192 (DeepSeek-V3's MLA) in bf16 and fp32, with v of 192 real columns
and with v's last 64 zeros as the MLA block pads it (causal, ragged,
non-causal), then at Zamba2's training shape (batch 4 x 4,096, 32 heads
over 32 KV heads of 112, bf16, causal) and DeepSeek-V3's (batch 4 x
4,096, 128 heads of 192, v 128, G = 1), timed beside SDPA and the bound;
and checks that a head dimension without a template (96, 120) is
refused.  A
wrong wgmma descriptor gives wrong numbers, not a fault: run this after
touching the tile layout or the descriptors.  About a minute of command
time with the build.
"""
from __future__ import annotations

import os
import sys
import time


def main() -> int:
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build, conv1d_brgemm, ref
    from repro_torch.kernels import flash_attention as fa

    if not torch.cuda.is_available():
        raise SystemExit("flash_check: no CUDA device; nothing was run")
    t0 = time.perf_counter()
    print(cs._card_line(), flush=True)
    _, _, ptxas = cs._build_all(conv1d_brgemm, fa, build)
    for name in ("flash_fwd", "flash_bwd"):
        for ln in ptxas[name]:
            print(f"ptxas {name}: {ln}")
    cs._check_no_spills(ptxas, ("flash_fwd", "flash_bwd"))
    cs._check_wgmma_not_serialized(ptxas, ("flash_fwd", "flash_bwd"))
    print("hgmma", cs.hgmma_counts(build, fa, conv1d_brgemm), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(5)
    rows = []
    bf16, f32 = torch.bfloat16, torch.float32
    for args, kw in (
            (("hd112 bf16 causal G=2 ragged", 2, 1000, 4, 2, bf16, True),
             dict(hd=112)),
            (("hd112 bf16 non-causal", 1, 1000, 4, 2, bf16, False),
             dict(hd=112)),
            (("hd112 fp32 causal", 1, 512, 4, 2, f32, True), dict(hd=112)),
            (("hd112 fp32 non-causal ragged", 1, 300, 2, 3, f32, False),
             dict(hd=112)),
            (("hd128 bf16 causal", 1, 2048, 2, 12, bf16, True),
             dict(hd=128)),
            (("hd64 bf16 causal", 1, 2048, 2, 4, bf16, True), dict(hd=64)),
            (("hd64 fp32 causal", 1, 512, 2, 4, f32, True), dict(hd=64)),
            (("hd192 bf16 causal G=1 ragged v=128", 2, 1000, 4, 1, bf16,
              True), dict(hd=192, vd=128)),
            (("hd192 bf16 causal G=2", 1, 1024, 2, 2, bf16, True),
             dict(hd=192)),
            (("hd192 bf16 non-causal ragged", 1, 700, 4, 1, bf16, False),
             dict(hd=192)),
            (("hd192 fp32 causal v=128", 1, 512, 4, 1, f32, True),
             dict(hd=192, vd=128)),
            (("hd192 fp32 non-causal ragged G=3", 1, 300, 2, 3, f32, False),
             dict(hd=192)),
            (("hd112 bf16 causal B=4 T=4096 H=32 G=1", 4, 4096, 32, 1,
              bf16, True), dict(hd=112, timed=True)),
            (("hd192 bf16 causal B=4 T=4096 H=128 G=1 v=128", 4, 4096, 128,
              1, bf16, True), dict(hd=192, vd=128, timed=True))):
        cs._flash_check(torch, fa, ref, gen, rows, *args, **kw)
    for hd in (96, 120):
        q = torch.zeros(1, 64, 1, 1, hd, device="cuda", dtype=bf16)
        k = torch.zeros(1, 64, 1, hd, device="cuda", dtype=bf16)
        try:
            fa.flash_fwd(q, k, k)
        except ValueError as e:
            print(f"refused: {e}")
        else:
            raise AssertionError(f"flash_fwd took head_dim {hd}")
    print(f"flash_check: {len(rows)} rows in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
