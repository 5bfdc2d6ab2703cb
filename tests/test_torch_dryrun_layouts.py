"""Which (dp, mp) layouts can be placed at all, on the CPU: the port's
serving refusals (``serve.tp_refusal``) against what JAX's launchers
can place.

Both of JAX's launchers place each parameter with ``jax.device_put(p,
NamedSharding(mesh, spec))`` under ``param_pspecs``, which refuses a
dimension that does not divide over its axes (pinned here in a
subprocess on 3 CPU devices); GSPMD pads nothing there.  So a layout JAX
can place is one where every leaf of ``param_pspecs`` splits evenly, and
over the grid of every language-model config, mp 1-16 and dp in {1, 2,
3, 4, 6, 8, 16} the port serves each such layout.  The reverse does not
hold: the port's head-aligned blocks also serve layouts JAX cannot place
(StarCoder2-3B at mp 6 and 12)."""
from __future__ import annotations

import math
import os
import subprocess
import sys

import jax
import pytest

from repro.configs import get as jget
from repro.models import get_model as jget_model
from repro.models import sharding as jsharding
from repro_torch import configs
from repro_torch.launch import serve
from repro_torch.models import sharding

LM_ARCHS = [a for a in configs.names() if configs.get(a).family != "conv"]
MPS = range(1, 17)
DPS = (1, 2, 3, 4, 6, 8, 16)


def _jax_places(params, mesh) -> bool:
    """Whether every leaf of JAX's ``param_pspecs`` on ``mesh`` (read for
    its axis names and sizes only) splits evenly."""
    specs = jax.tree.leaves(
        jsharding.param_pspecs(params, mesh),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    for leaf, spec in zip(jax.tree.leaves(params), specs):
        for n, entry in zip(leaf.shape, tuple(spec)):
            axes = () if entry is None else (
                (entry,) if isinstance(entry, str) else entry)
            if n % math.prod(mesh.shape[a] for a in axes):
                return False
    return True


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_every_layout_jax_can_place_serves(arch):
    jcfg = jget(arch)
    params = jax.eval_shape(
        lambda: jget_model(jcfg).init_params(jax.random.key(0), jcfg))
    cfg = configs.get(arch)
    placed = served_only = 0
    for mp in MPS:
        for dp in DPS:
            mesh = sharding.MeshShape(("data", "model"), (dp, mp))
            why = serve.tp_refusal(cfg, mp, world=dp * mp)
            if _jax_places(params, mesh):
                placed += 1
                assert why is None, (mp, dp, why)
            elif why is None:
                served_only += 1
    assert placed >= len(DPS)  # mp 1 at least
    if arch == "starcoder2-3b":
        # 24 query heads over 2 KV heads: JAX cannot split 2 KV heads'
        # 256 columns of wk over 6 or 12, the port's head-aligned
        # blocks serve them
        for mp in (6, 12):
            mesh = sharding.MeshShape(("data", "model"), (1, mp))
            assert not _jax_places(params, mesh)
            assert serve.tp_refusal(cfg, mp) is None
        assert served_only > 0


_REFUSAL = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=3"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
mesh = Mesh(np.array(jax.devices()), ("data",))
ok = jax.device_put(jnp.ones((8, 1023)), NamedSharding(mesh, P(None, "data")))
print("EVEN", ok.sharding.shard_shape(ok.shape))
try:
    jax.device_put(jnp.ones((8, 1024)), NamedSharding(mesh, P(None, "data")))
    print("PLACED")
except ValueError as e:
    print("REFUSED", str(e).replace("\n", " "))
"""


def test_jax_device_put_refuses_an_uneven_leaf():
    """JAX's own placement on 3 CPU devices: 1,023 columns split 341 a
    device; 1,024 are refused, not padded."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", _REFUSAL], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "EVEN (8, 341)" in proc.stdout
    line = next(ln for ln in proc.stdout.splitlines()
                if ln.startswith(("REFUSED", "PLACED")))
    assert line.startswith("REFUSED"), line
    assert "divisible by 3" in line and "1024" in line
