"""Phase 27 of ``chip_smoke.py`` alone: tensor-parallel serving where the
heads or KV heads do not divide the model axis (Qwen2-7B and
Whisper-large-v3 at (1, 8), StarCoder2-3B at (2, 4); one world of 8 gloo
ranks sharing the card), after building the six kernels.  It prints the
card's name and power limit before and after, the build's seconds, the
phase's own lines (the flash rows at the ranks' new shapes, its gates,
decode times, collectives, bytes and peak memory) and the phase's
seconds.  Run on a machine with a GPU, from the root of the repository:

    python3 tools/head_layouts_phase.py
"""
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))
import chip_smoke as cs  # noqa: E402

if __name__ == "__main__":
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("head_layouts_phase: no CUDA device; nothing was "
                         "run")
    from repro_torch import configs
    from repro_torch.kernels import build, conv1d_brgemm, flash_attention, ref
    from repro_torch.launch import serve, train
    from repro_torch.models import init_model
    print(cs._card_line(), flush=True)
    t = time.perf_counter()
    cs._build_all(conv1d_brgemm, flash_attention, build)
    print(f"build {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    with cs._drawn_once(torch, train):
        cs.head_layouts_check(torch, configs, init_model, serve, ref,
                              conv1d_brgemm, flash_attention)
    print(f"phase 27 alone {time.perf_counter() - t:.1f} s", flush=True)
    print(cs._card_line())
