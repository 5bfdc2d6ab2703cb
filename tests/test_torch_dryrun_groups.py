"""The counting groups count what runs, on the CPU: a dry-run's rank
(``models.rank_model`` over ``sharding.CountingGroup`` stand-ins, on the
``meta`` device) records the same model sums, model gathers and data
gathers in one decode step and one fused prefill as a rank of 4 gloo
processes at (2, 2) runs on the same step (``tests/torch_dryrun_ranks.py``),
for a reduced dense, SSM and MoE model; and the bytes it records are the
operands of those calls.  The counting groups are never a fallback: a
model placed on a real group runs its collectives on it."""
from __future__ import annotations

import pytest
import torch

from repro_torch import configs, models
from repro_torch.models import sharding
from repro_torch.roofline import analysis

import torch_dryrun_ranks as ranks

MESH = sharding.MeshShape(("data", "model"), (2, 2))
CASES = {
    "dense": (configs.reduced(configs.get("qwen3-8b")), 4, 8),
    "ssm": (configs.reduced(configs.get("mamba2-370m")), 4, 16),
    "moe": (configs.reduced(configs.get("moonshot-v1-16b-a3b")), 4, 8),
}


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    return ranks.spawn(tmp_path_factory.mktemp("dryrun_ranks"), CASES)


def _counting(name, coords, device):
    cfg, batch, seq = CASES[name]
    g = sharding.counting_groups(MESH, coords)
    model = models.rank_model(cfg, MESH, coords, device=device,
                              seed=0 if device != "meta" else None,
                              model_group=g["model"], data_group=g["data"],
                              batch=batch)
    return model, g, cfg, batch, seq


def _kinds(calls):
    out = {}
    for kind, axis, _ in calls:
        out[(kind, axis)] = out.get((kind, axis), 0) + 1
    return out


@pytest.mark.parametrize("device", ["meta", "cpu"])
@pytest.mark.parametrize("name", list(CASES))
def test_counting_groups_count_what_the_gloo_ranks_run(gloo, name, device):
    for rank in range(ranks.WORLD):
        coords = {"data": rank // ranks.MP, "model": rank % ranks.MP}
        model, g, cfg, batch, seq = _counting(name, coords, device)
        got = ranks.step_counts(model, cfg, batch, seq)
        assert got == gloo[rank][name], (name, rank)
        # the same calls as the groups' records, by kind and axis
        calls = g["model"].calls + g["data"].calls
        want = got["decode"]["sums"] + got["prefill"]["sums"]
        kinds = _kinds(calls)
        assert kinds.get(("all-reduce", "model"), 0) == want
        assert kinds.get(("all-gather", "model"), 0) == (
            got["decode"]["gathers"] + got["prefill"]["gathers"])
        assert kinds.get(("all-gather", "data"), 0) >= (
            got["decode"]["data_gathers"] + got["prefill"]["data_gathers"])


def test_collective_bytes_are_the_operands():
    """One decode step of the dense rank on meta: the model axis's
    all-reduces carry (rows, 1, D) fp32 partials (the embedding's and two
    a layer), the logits' gather the rank's (rows, 1, V / mp) fp32 block;
    the data axis gathers each layer's blocks in one collective and each
    table's in its own."""
    coords = {"data": 0, "model": 0}
    model, g, cfg, batch, seq = _counting("dense", coords, "meta")
    from repro_torch.train import serve_step
    cache = serve_step.make_cache(cfg, batch, seq, device="meta", dp=2,
                                  mp=2, rank=0)
    tokens = torch.empty((batch // 2, 1), dtype=torch.int32, device="meta")
    m = analysis.count_step(serve_step.make_serve_step(cfg),
                            (model, cache, tokens, seq - 1),
                            groups=[g["model"], g["data"]])
    rows, D = batch // 2, cfg.d_model
    sums = [n for kind, axis, n in g["model"].calls if kind == "all-reduce"]
    assert sums == [rows * D * 4] * (1 + 2 * cfg.n_layers)
    gathers = [n for kind, _, n in g["model"].calls if kind == "all-gather"]
    assert gathers == [rows * cfg.padded_vocab // 2 * 4]
    data = [n for _, _, n in g["data"].calls]
    assert len(data) == cfg.n_layers + 2  # a layer's, the two tables'
    assert m["coll_by_axis"] == {"model": sum(sums) + sum(gathers),
                                 "data": sum(data)}
    assert m["coll_bytes"] == sum(sums) + sum(gathers) + sum(data)
    assert m["coll_by_kind"]["all-reduce"] == sum(sums)


def test_a_process_group_is_never_counted():
    """``collectives`` wraps anything but a DistGroup or CountingGroup as a
    process group: the default group (None) with none started raises, it
    never counts."""
    with pytest.raises(ValueError):
        sharding.ModelGroup(None)
    assert isinstance(sharding.collectives(sharding.CountingGroup(2)),
                      sharding.CountingGroup)
