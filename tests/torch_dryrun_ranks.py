"""Rank-side job of ``test_torch_dryrun_groups.py``: one decode step and
one fused prefill of a reduced language model served by gloo ranks on a
(2, 2) mesh, counting the collectives each rank's groups run.

Kept apart from the test module so that each spawned rank imports torch
and the port, not JAX.  ``spawn(tmp, cases)`` starts 4 ranks (start
method ``spawn``, one thread each, a file store under ``tmp``), lays them
out as (2, 2) with ``launch.mesh.init_mesh`` and returns every rank's
counts: ``{case: {"decode"|"prefill": dict(sums, gathers,
data_gathers)}}``.
"""
from __future__ import annotations

import os
import pickle

import torch
import torch.multiprocessing as mp

from repro_torch import models
from repro_torch.launch import mesh
from repro_torch.train import serve_step

WORLD, MP = 4, 2


def counts(model) -> dict:
    """The model and data groups' calls so far."""
    return dict(sums=model.tp.sums, gathers=model.tp.gathers,
                data_gathers=0 if model.ds is None else model.ds.gathers)


def step_counts(model, cfg, batch: int, seq: int) -> dict:
    """The calls of one decode step (at position ``seq - 1`` of a ``seq``
    cache) and of one fused prefill over ``seq`` tokens, each from 0."""
    dp = WORLD // MP
    device = next(model.parameters()).device
    rows = batch // dp if batch % dp == 0 else batch
    g = torch.Generator().manual_seed(5)
    tokens = torch.randint(0, cfg.vocab_size, (rows, seq), generator=g,
                           dtype=torch.int32).to(device)
    out = {}
    cache = serve_step.make_cache(cfg, batch, seq, dtype=torch.float32,
                                  device=device, dp=dp, mp=MP,
                                  rank=model.tp.rank)
    before = counts(model)
    serve_step.make_serve_step(cfg)(model, cache, tokens[:, :1], seq - 1)
    out["decode"] = {k: v - before[k] for k, v in counts(model).items()}
    before = counts(model)
    serve_step.make_prefill_step(cfg)(model, {"tokens": tokens})
    out["prefill"] = {k: v - before[k] for k, v in counts(model).items()}
    return out


def _rank_main(rank, tmp, cases):
    torch.set_num_threads(1)
    mesh.init_data_group("gloo", f"file://{tmp}/store", WORLD, rank)
    try:
        data, model_group = mesh.init_mesh(WORLD // MP, MP)
        shape, coords = mesh.make_host_mesh(model=MP)
        out = {}
        for name, (cfg, batch, seq) in cases.items():
            whole = models.init_model(cfg, seed=0)
            model = models.local_model(whole, shape, coords, model_group,
                                       data_group=data, batch=batch)
            out[name] = step_counts(model, cfg, batch, seq)
    finally:
        mesh.destroy()
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def spawn(tmp, cases) -> list[dict]:
    """Run ``cases`` (name -> (cfg, batch, seq)) on 4 gloo ranks at
    (2, 2); every rank's counts."""
    tmp = str(tmp)
    os.makedirs(tmp, exist_ok=True)
    mp.start_processes(_rank_main, args=(tmp, cases), nprocs=WORLD,
                       start_method="spawn")
    out = []
    for r in range(WORLD):
        with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out
