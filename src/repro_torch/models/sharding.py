"""Parameter, batch and cache placement rules (counterpart of
``repro/models/sharding.py``), the blocks a device holds under them, and
the model group a tensor-parallel model reduces over.

The rules are the JAX package's, copied verbatim: tensor-parallel
dimensions (heads, d_ff, experts, vocabulary) on ``'model'``, the other
large dimension on ``'data'`` (and ``'pod'``), FSDP-style.  They are
name-based: :func:`spec_for_path` reads a leaf's dotted state-dict key
split on ``.``, which is the JAX tree's path (``convert.py``), so the
layer-stack padding and the ``moe``/``shared`` scoping are JAX's.

A spec is a tuple with one entry a dimension: ``None`` (replicated), an
axis name, or a tuple of axis names (the dimension split over their
product, the first axis major), as ``tuple(jax.sharding.PartitionSpec)``
gives it; a one-name tuple is written as the name, as PartitionSpec
normalises it.  A mesh is a :class:`MeshShape`: the rules read its axis
names and sizes and nothing else.

The torch side: :func:`local_block` is the block of a tensor that the
device at given mesh coordinates holds under even tiling (a dimension
that does not divide raises: JAX's launchers cannot place such a leaf
either, ``jax.device_put`` refusing an uneven shard), and
:func:`local_state_dict` does the same for a whole state dict.  Where
an explicit form cannot follow JAX's block, a rank's execution block
departs from it: an SSM model's fused ``in_proj``, ``conv_w`` and
``conv_b`` (and its cache's conv state) take segment-aligned blocks
(:func:`segment_block`), every rank keeping B and C whole; the
attention's leaves (and its cache's K and V) take head-aligned blocks
(:func:`head_blocks`), whole query heads of one group and the KV heads
they read, a KV head replicated on the ranks that share it where the KV
heads do not divide over the model axis.

:class:`ModelGroup` is the model axis of a tensor-parallel language
model (``models/common.py``, ``transformer.py``, ``moe.py``, ``mla.py``,
``mamba2.py``, ``zamba2.py``, ``whisper.py`` read it): the all-reduce
after each row-parallel product (and of Mamba2's gated norm's sum of
squares) and the gather of the logits' column blocks, where GSPMD
inserts them in the JAX launcher's sharded decode.  Each sum runs in fp32 (a partial cast,
summed, cast back): the sum itself is exact in fp32 and rounded once.  In a
bf16 model each rank's partial is already rounded to bf16 by its product
before the sum, so a two-rank result is rounded three times against one
process's once; ``serve.prefill_tol`` absorbs that.

:class:`DataShards` is the data axis of a language model placed
FSDP-style: trained on JAX's launcher's ``(dp, 1)`` mesh
(``models.fsdp_model``), served on its serve launcher's ``(dp, mp)``
host mesh (``models.local_model``).  A rank holds :func:`local_block` of
each leaf (the 2-D block), gathers over its data group the block its
model column executes where a layer runs, and in training
reduce-scatters the gradients back to its blocks.  :func:`expert_ids`
names the experts a model column's gathered stacks hold,
:func:`batch_rows` the rows a data row serves.  :func:`data_mean` takes
a statistic of the global batch (an MoE layer's load-balance means) over
the data group, :func:`assignments_ahead` ranks a capacity dispatch's
assignments over it.

Not ported: ``constrain_like_params`` (JAX ``:151``), a
``with_sharding_constraint`` layout hint to GSPMD for gradients.  Eager
PyTorch has no compiler to hint, and the hint changes no number
(``tests/test_perf_features.py::test_constrain_grads_is_noop_numerically``).
"""
from __future__ import annotations

import math
import time

import torch
import torch.distributed as dist

from repro_torch.kernels import meta as _kmeta
from repro_torch.kernels.sharded import _block

# rule: leaf-name -> logical spec for the *trailing* dims (layer-stack dims
# are detected by ndim surplus and padded with None on the left).
_RULES: dict[str, tuple] = {
    # embeddings / unembedding
    "tok": ("mp", "dp"),
    "pos": (None, "dp"),
    "unembed": ("dp", "mp"),
    # attention
    "wq": ("dp", "mp"), "wk": ("dp", "mp"), "wv": ("dp", "mp"),
    "wo": ("mp", "dp"),
    "bq": ("mp",), "bk": ("mp",), "bv": ("mp",), "bo": (None,),
    "q_norm": (None,), "k_norm": (None,),
    # MLA
    "q_down": ("dp", None), "q_up": (None, "mp"),
    "kv_down": ("dp", None), "kv_up": (None, "mp"),
    "kv_norm": (None,),
    # MLP
    "w_gate": ("dp", "mp"), "w_up": ("dp", "mp"), "w_down": ("mp", "dp"),
    "b_up": ("mp",), "b_down": (None,),
    # MoE (experts on 'mp' = expert parallelism; hidden dims on 'dp' = FSDP)
    "router": ("dp", None), "router_bias": (None,),
    # SSM
    "in_proj": ("dp", "mp"), "out_proj": ("mp", "dp"),
    "conv_w": (None, "mp"), "conv_b": ("mp",),
    "dt_bias": ("mp",), "A_log": ("mp",), "D": ("mp",),
    "gate_norm": ("mp",),
    # norms
    "scale": (None,), "bias": (None,),
    # conv nets (channels are tiny; replicate)
    "w": (None, None, None), "b": (None,),
    # whisper frontend
    "conv1_w": (None, "mp", None), "conv1_b": ("mp",),
    "conv2_w": (None, "mp", "dp"), "conv2_b": ("mp",),
}

# MoE expert stacks get a 3D rule keyed on name within a 'moe' scope.
# 'ep' = expert parallelism over the COMBINED (pod·data·model) axes: each
# device owns whole experts, so FSDP's per-microbatch weight all-gather
# disappears (tokens move instead — §Perf cell 1 it-6).  Falls back to the
# ('mp', 'dp', ·) TP+FSDP layout when n_experts doesn't divide the combined
# axis size (translation in to_mesh_specs, which sees the leaf shapes).
_MOE_RULES = {
    "w_gate": ("ep", "dp", None),
    "w_up": ("ep", "dp", None),
    "w_down": ("ep", None, "dp"),
}
_EP_FALLBACK = {"ep": "mp"}  # per-dim fallback when divisibility fails


class MeshShape:
    """The axis names and sizes of a device mesh, all the rules read of
    one: ``MeshShape(("data", "model"), (1, 2))``; ``shape`` maps each
    name to its size, as a JAX mesh's does."""

    def __init__(self, axis_names, shape):
        self.axis_names = tuple(axis_names)
        sizes = tuple(shape.values()) if isinstance(shape, dict) else shape
        if len(sizes) != len(self.axis_names):
            raise ValueError(f"{len(self.axis_names)} axis names for "
                             f"{len(sizes)} sizes")
        self.shape = dict(zip(self.axis_names, (int(s) for s in sizes)))

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def __repr__(self) -> str:
        return f"MeshShape({self.axis_names}, {tuple(self.shape.values())})"


def _names(key) -> list[str]:
    return key.split(".") if isinstance(key, str) else [str(k) for k in key]


def spec_for_path(names, shape) -> tuple:
    """The logical spec (``'dp'``/``'mp'``/``'ep'``/None a dimension) of
    the leaf at ``names`` (a dotted key, or its parts) of ``shape``."""
    names = _names(names)
    ndim = len(shape)
    leaf_name = names[-1]
    in_moe = "moe" in names and "shared" not in names
    rule = None
    if in_moe and leaf_name in _MOE_RULES:
        rule = _MOE_RULES[leaf_name]
    elif leaf_name in _RULES:
        rule = _RULES[leaf_name]
    if rule is None:
        rule = (None,) * ndim
    # layer-stacked params carry extra leading dims -> replicate those
    extra = ndim - len(rule)
    if extra > 0:
        rule = (None,) * extra + tuple(rule)
    elif extra < 0:
        rule = tuple(rule[-ndim:]) if ndim else ()
    return rule


def _shapes(params) -> dict[str, tuple[int, ...]]:
    """key -> shape of a model's state dict, or of a dict of tensors or
    shapes."""
    if isinstance(params, torch.nn.Module):
        params = params.state_dict()
    return {k: tuple(v.shape) if hasattr(v, "shape") else tuple(v)
            for k, v in params.items()}


def logical_param_specs(params) -> dict[str, tuple]:
    """key -> logical spec of every leaf of ``params`` (a model, or a
    dict of tensors or shapes under the state-dict keys)."""
    return {k: spec_for_path(k, s) for k, s in _shapes(params).items()}


def _axis(names: tuple):
    """A spec entry over ``names``: None, the name, or the tuple."""
    if not names:
        return None
    return names[0] if len(names) == 1 else tuple(names)


def _data_axes(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def data_size(mesh) -> int:
    """The ranks of the mesh's data axes together (``('pod', 'data')``):
    the data rows a batch splits over."""
    return math.prod(mesh.shape[a] for a in _data_axes(mesh))


def data_index(mesh, coords) -> int:
    """The data row of the device at ``coords``: its index row-major over
    the data axes (``'pod'`` major), its rank in its data group."""
    return split_index(_axis(_data_axes(mesh)), mesh, _coords(mesh, coords))[1]


def to_mesh_specs(logical: dict, mesh, shapes: dict | None = None) -> dict:
    """Translate logical (``'dp'``/``'mp'``/``'ep'``/None) specs to the
    mesh's axis names.

    ``'ep'`` needs the leaf's dim size (the expert count) to check that
    it divides the combined ``(data, model)`` size; pass ``shapes`` (key
    -> shape, or tensors) to enable it; without shapes, ``'ep'``
    degrades to ``'mp'``.  When ``'ep'`` binds the combined axes, any
    ``'dp'`` in the same spec is dropped (a mesh axis may appear once a
    spec)."""
    names = tuple(mesh.axis_names)
    dp = _axis(_data_axes(mesh))
    mp = "model" if "model" in names else None
    ep_axes = tuple(a for a in ("data", "model") if a in names)
    ep = _axis(ep_axes)
    ep_size = math.prod(mesh.shape[a] for a in ep_axes)
    shapes = None if shapes is None else _shapes(shapes)

    def tr(key, t):
        use_ep = ("ep" in t and ep is not None and shapes is not None
                  and shapes[key][t.index("ep")] % ep_size == 0)
        out = []
        for a in t:
            if a == "ep":
                out.append(ep if use_ep else mp)
            elif a == "dp":
                out.append(None if use_ep else dp)
            elif a == "mp":
                out.append(mp)
            else:
                out.append(None)
        return tuple(out)

    return {k: tr(k, t) for k, t in logical.items()}


def param_pspecs(params, mesh) -> dict[str, tuple]:
    """key -> mesh spec of every leaf of ``params`` (JAX's
    ``param_pspecs``)."""
    return to_mesh_specs(logical_param_specs(params), mesh, shapes=params)


def batch_pspec(mesh) -> tuple:
    """A batch's spec: its leading dimension over the data axes."""
    return (_axis(_data_axes(mesh)),)


def cache_pspecs(cache, mesh, batch_size: int):
    """KV / SSM caches (nested dicts of tensors or shapes, the port's
    cache trees): the batch on the data axes when it divides, heads or
    channels on ``'model'``; the same nesting of specs.

    Cache layouts (leading layer-stack dim handled by padding):
      k/v        : (L, B, T, KV, hd)   -> (None, dp, None, mp, None)
      c_kv/k_rope: (L, B, T, r)        -> (None, dp, None, None)
      conv state : (L, B, S-1, cd)     -> (None, dp, None, mp)
      ssm state  : (L, B, H, N, P)     -> (None, dp, mp, None, None)
      cross_k/v  : (L, B, Te, H, hd)   -> (None, dp, None, mp, None)
    """
    names = tuple(mesh.axis_names)
    dp_axes = _data_axes(mesh)
    dp = _axis(dp_axes)
    mp = "model" if "model" in names else None
    n_mp = mesh.shape["model"] if mp else 1
    n_dp = math.prod(mesh.shape[a] for a in dp_axes)
    bdp = dp if (dp and batch_size % n_dp == 0) else None

    def spec(name, shape):
        nd = len(shape)
        if name in ("k", "v", "cross_k", "cross_v"):
            # shard KV heads on mp when they divide the axis; otherwise
            # fall back to sharding head_dim (GQA archs with KV < mp)
            kv_heads, hd = shape[-2], shape[-1]
            if kv_heads % n_mp == 0:
                s = (None, bdp, None, mp, None)
            elif hd % n_mp == 0:
                s = (None, bdp, None, None, mp)
            else:
                s = (None, bdp, None, None, None)
        elif name == "c_kv":
            # latent cache: shard the rank dim on mp (it is 512 — divisible)
            s = (None, bdp, None, mp)
        elif name == "k_rope":
            s = (None, bdp, None, None)
        elif name == "conv":
            s = (None, bdp, None, mp)
        elif name == "ssm":
            s = (None, bdp, mp, None, None)
        else:
            s = (None,) * nd
        if len(s) > nd:
            s = s[len(s) - nd:]
        elif len(s) < nd:
            s = (None,) * (nd - len(s)) + s
        return s

    def walk(tree, name=None):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        return spec(name, tuple(tree.shape) if hasattr(tree, "shape")
                    else tuple(tree))

    return walk(cache)


def batch_splits(batch: int, dp: int) -> bool:
    """Whether a ``batch`` splits over ``dp`` data rows: where it divides
    (the batch on the data axes, :func:`cache_pspecs`' ``bdp``); else
    the spec replicates it."""
    return batch % dp == 0


def batch_rows(batch: int, dp: int, d: int) -> slice:
    """The rows of a ``batch`` that data row ``d`` of ``dp`` serves: its
    equal share ``[d B/dp, (d+1) B/dp)`` where the batch splits
    (:func:`batch_splits`), else the whole batch."""
    if not batch_splits(batch, dp):
        return slice(0, batch)
    n = batch // dp
    return slice(d * n, (d + 1) * n)


def tree_leaves(tree):
    """The leaves of a nested dict (a cache tree), in order."""
    for v in tree.values():
        yield from (tree_leaves(v) if isinstance(v, dict) else (v,))


# --- the blocks a device holds ---------------------------------------------

def _coords(mesh, coords) -> dict[str, int]:
    if not isinstance(coords, dict):
        coords = dict(zip(mesh.axis_names, coords))
    for a in mesh.axis_names:
        if not 0 <= coords[a] < mesh.shape[a]:
            raise ValueError(f"coordinate {coords[a]} is off the mesh's "
                             f"{a!r} axis of {mesh.shape[a]}")
    return coords


def split_index(entry, mesh, coords) -> tuple[int, int]:
    """(parts, index) of a dimension under spec entry ``entry`` at
    ``coords``: the index row-major over the entry's axes."""
    axes = () if entry is None else (
        (entry,) if isinstance(entry, str) else tuple(entry))
    parts, index = 1, 0
    for a in axes:
        parts *= mesh.shape[a]
        index = index * mesh.shape[a] + coords[a]
    return parts, index


def local_shape(shape, spec, mesh) -> tuple[int, ...]:
    """The shape of a device's block of a ``shape`` tensor under
    ``spec`` (even tiling: a dimension that does not divide raises)."""
    out = []
    for dim, (n, entry) in enumerate(zip(shape, spec)):
        parts, _ = split_index(entry, mesh, {a: 0 for a in mesh.axis_names})
        if n % parts:
            raise ValueError(f"dimension {dim} of {tuple(shape)} ({n}) does "
                             f"not divide over {entry!r} ({parts} parts)")
        out.append(n // parts)
    return tuple(out)


def local_block(t: torch.Tensor, spec: tuple, mesh, coords,
                heads: tuple[range, int] | None = None) -> torch.Tensor:
    """The block of ``t`` that the device at ``coords`` (a dict axis ->
    index, or a tuple in the mesh's axis order) holds under ``spec``: a
    view, each split dimension narrowed to its equal part.  ``heads``,
    ``(range, n)``: the ``'model'`` dimension holds ``n`` heads' equal
    slices, and the block takes the range's (:func:`head_blocks`)
    instead of an equal part."""
    if len(spec) != t.dim():
        raise ValueError(f"a spec of {len(spec)} entries for a tensor of "
                         f"{t.dim()} dimensions")
    coords = _coords(mesh, coords)
    if heads is not None:
        dim = _model_dim(spec)
        if dim is None:
            raise ValueError(f"a head block of a spec {spec} with no "
                             "'model' dimension")
        t = head_block(t, dim, *heads)
        spec = (*spec[:dim], None, *spec[dim + 1:])
    local_shape(t.shape, spec, mesh)  # raises where a dimension is uneven
    for dim, entry in enumerate(spec):
        parts, index = split_index(entry, mesh, coords)
        if parts > 1:
            t = _block(t, dim, parts, index)
    return t


def local_state_dict(params, mesh, coords, device=None,
                     cfg=None) -> dict[str, torch.Tensor]:
    """The state dict of the device at ``coords``: each leaf of
    ``params`` (a model or a state dict) narrowed to its block under
    :func:`param_pspecs`, contiguous, on ``device`` (default: where it
    is).  With the model's ``cfg``, the blocks a rank executes: an SSM
    model's fused leaves (:data:`SSM_SEGMENTS`) take their
    segment-aligned blocks over ``'model'`` (:func:`segment_block`)
    instead of JAX's contiguous ones, and the attention's leaves
    (:data:`HEAD_LEAVES`) their head-aligned ones (:func:`head_blocks`)."""
    if isinstance(params, torch.nn.Module):
        params = params.state_dict()
    specs = param_pspecs(params, mesh)
    coords = _coords(mesh, coords)
    out = {}
    for k, t in params.items():
        name = _names(k)[-1]
        if cfg is None or cfg.ssm is None or name not in SSM_SEGMENTS:
            b = local_block(t, specs[k], mesh, coords,
                            heads=leaf_head_range(cfg, k, specs[k], mesh,
                                                  coords))
        else:
            *lead, last = specs[k]
            parts, index = split_index(last, mesh, coords)
            b = segment_block(local_block(t, (*lead, None), mesh, coords),
                              ssm_segments(cfg, name, parts), parts, index)
        out[k] = b.contiguous().to(device if device is not None
                                   else t.device)
    return out


# --- the segment-aligned blocks of the fused SSM leaves ----------------------
#
# Mamba2 fuses its projections: ``in_proj``'s columns are [z | x | B | C |
# dt] (widths d_inner, d_inner, G·N, G·N, H), ``conv_w``'s and
# ``conv_b``'s channels and the cache's conv state [x | B | C].  JAX's
# rule splits the fused dimension contiguously on 'model' and GSPMD
# re-lays it out at run time; at Mamba2-370M and mp 2, rank 0's contiguous
# half of ``in_proj`` (2,192 of 4,384 columns) is all of z and 144
# columns of x, no rank's share of the heads.  A rank's execution block
# instead takes its heads' share of each segment: z, x and dt split by
# heads; B and C split by groups where the groups divide over the ranks,
# else (one group, every config's) whole on every rank, 2·G·N columns of
# ``in_proj`` and channels of the conv more than JAX's block.  The specs
# (``param_pspecs``, ``cache_pspecs``) stay JAX's.

SSM_SEGMENTS = {"in_proj": "zxBCt", "conv_w": "xBC", "conv_b": "xBC",
                "conv": "xBC"}


def ssm_segments(cfg, name: str, parts: int) -> list[tuple[int, bool]]:
    """The segments of the last dimension of the fused SSM leaf ``name``
    (``SSM_SEGMENTS``: a parameter, or ``"conv"``, the cache's state) of
    ``cfg`` over ``parts`` model ranks: ``(width, split)`` each, in
    order.  Raises where the heads do not divide over ``parts``, or where
    more than one group does not."""
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    H, G = d_inner // s.head_dim, s.n_groups
    if H % parts:
        raise ValueError(f"{H} SSM heads do not divide over {parts} model "
                         "ranks")
    groups = G % parts == 0
    if G > 1 and not groups:
        raise ValueError(f"{G} SSM groups do not divide over {parts} model "
                         "ranks (a rank's heads would read another's)")
    width = {"z": (d_inner, True), "x": (d_inner, True),
             "B": (G * s.d_state, groups), "C": (G * s.d_state, groups),
             "t": (H, True)}
    return [width[c] for c in SSM_SEGMENTS[name]]


def ssm_local_width(cfg, name: str, parts: int) -> int:
    """The width of a rank's segment-aligned block of ``name``."""
    return sum(w // parts if split else w
               for w, split in ssm_segments(cfg, name, parts))


def segment_block(t: torch.Tensor, segments, parts: int,
                  index: int) -> torch.Tensor:
    """Block ``index`` of ``parts`` of ``t``'s last dimension, taken
    segment by segment (``segments``: ``(width, split)`` in order): a
    split segment's ``index``-th equal part, a whole one entire, joined
    in order (a copy)."""
    if sum(w for w, _ in segments) != t.shape[-1]:
        raise ValueError(f"segments {segments} do not tile a last "
                         f"dimension of {t.shape[-1]}")
    out, start = [], 0
    for w, split in segments:
        seg = t.narrow(-1, start, w)
        out.append(_block(seg, t.dim() - 1, parts, index) if split else seg)
        start += w
    return torch.cat(out, -1)


# --- the head-aligned blocks of the attention's leaves ---------------------
#
# JAX's rules split the attention's head dimensions contiguously on 'model'
# (``wq``'s H·hd columns, ``wk``'s KV·hd, ``wo``'s H·hd rows), and GSPMD
# re-lays out at run time a split that does not fall on whole heads; where the
# KV heads do not divide the axis, ``cache_pspecs`` splits the cache's
# head_dim.  A rank's execution block instead takes whole heads
# (:func:`head_blocks`): where the KV heads divide over the ranks, JAX's
# even blocks; where the ranks divide over the KV heads, each KV head on
# mp/KV consecutive ranks (its ``wk``/``wv`` columns, ``bk``/``bv`` and
# cache replicated on each) and its group's query heads split among them;
# multi-head attention's heads in contiguous blocks as even as they go.
# Every rank then holds whole query heads of one uniform group size and
# the KV heads they read.  The specs stay JAX's.

# leaf name -> the heads its 'model' dimension holds: the query heads
# ("q": also MLA's ``q_up``, ``kv_up`` and ``wo``, whose K and V are
# per query head) or the KV heads ("kv"); Whisper's cross-attention
# leaves hold every query head's (``leaf_heads``)
HEAD_LEAVES = {"wq": "q", "bq": "q", "wo": "q", "q_up": "q", "kv_up": "q",
               "wk": "kv", "wv": "kv", "bk": "kv", "bv": "kv"}


def _even_part(n: int, parts: int, index: int) -> range:
    """Part ``index`` of ``n`` items split into ``parts`` contiguous parts
    as even as they go, the larger parts first."""
    base, extra = divmod(n, parts)
    start = index * base + min(index, extra)
    return range(start, start + base + (index < extra))


def head_blocks(cfg, mp: int) -> list[tuple[range, range]]:
    """The query heads and KV heads each of ``mp`` model ranks holds,
    ``[(q_heads, kv_heads)] * mp`` (query head h reads KV head h // G,
    G = H / KV): the KV heads' equal blocks with their groups where they
    divide over the ranks; else, where the ranks divide over the KV heads,
    each KV head on mp / KV consecutive ranks, its G query heads split
    among them as evenly as they go, the larger blocks first (Qwen2-7B's
    7 a group over 2 ranks: 4 and 3); else for multi-head attention (G =
    1) contiguous blocks as even as they go (Whisper's 20 over 8: 3, 3,
    3, 3, 2, 2, 2, 2).  Raises where a rank's heads would straddle two
    groups, or where a rank would hold none.  MLA's heads each expand
    their own K and V from the latent: multi-head attention whatever
    ``n_kv_heads`` says."""
    H = cfg.n_heads
    KV = H if cfg.mla else cfg.n_kv_heads
    if H < 1 or KV < 1 or H % KV:
        raise ValueError(f"{H} heads over {KV} KV heads")
    G = H // KV
    if KV % mp == 0:
        n = KV // mp
        return [(range(m * n * G, (m + 1) * n * G), range(m * n, (m + 1) * n))
                for m in range(mp)]
    if (mp % KV == 0 and G < mp // KV) or (G == 1 and H < mp):
        raise ValueError(f"{H} heads over {KV} KV heads leave some of {mp} "
                         "model ranks no head")
    if mp % KV == 0:
        per = mp // KV  # ranks a KV head
        out = []
        for m in range(mp):
            kv, j = divmod(m, per)
            q = _even_part(G, per, j)
            out.append((range(kv * G + q.start, kv * G + q.stop),
                        range(kv, kv + 1)))
        return out
    if G == 1:
        return [(_even_part(H, mp, m),) * 2 for m in range(mp)]
    raise ValueError(f"{H} heads do not divide over {mp} model ranks in whole "
                     f"groups of {G}: neither {KV} KV heads over {mp} ranks "
                     f"nor {mp} ranks over {KV} KV heads divide, so a rank's "
                     "heads would straddle two groups")


def rank_heads(cfg, mesh, coords) -> tuple[range, range]:
    """``(query heads, KV heads)`` of the model rank at ``coords`` of
    ``mesh`` (:func:`head_blocks`)."""
    coords = _coords(mesh, coords)
    return head_blocks(cfg, mesh.shape.get("model", 1))[
        coords.get("model", 0)]


def leaf_heads(cfg, key) -> str | None:
    """Which heads the ``'model'`` dimension of leaf ``key`` holds:
    ``"q"`` or ``"kv"`` (:data:`HEAD_LEAVES`; a Whisper cross-attention
    leaf's are the query heads), None for a leaf of no head, a config
    with no attention, or no config."""
    names = _names(key)
    kind = HEAD_LEAVES.get(names[-1])
    if kind is None or cfg is None or not cfg.n_heads:
        return None
    return "q" if "cross" in names else kind


def _model_dim(spec) -> int | None:
    """The dimension of ``spec`` split over ``'model'``, or None."""
    return next((d for d, e in enumerate(spec) if e is not None
                 and "model" in ((e,) if isinstance(e, str) else e)), None)


def leaf_head_range(cfg, key, spec, mesh, coords) -> tuple[range, int] | None:
    """``(heads, n)`` of leaf ``key`` under ``spec`` at ``coords``: the
    heads (of its ``n``) the model rank there holds (:func:`head_blocks`),
    or None for a leaf of no head (:func:`leaf_heads`) or none split over
    ``'model'``."""
    kind, dim = leaf_heads(cfg, key), _model_dim(spec)
    if kind is None or dim is None:
        return None
    parts, index = split_index(spec[dim], mesh, _coords(mesh, coords))
    q, kv = head_blocks(cfg, parts)[index]
    return (q, cfg.n_heads) if kind == "q" else (kv, cfg.n_kv_heads)


def head_block(t: torch.Tensor, dim: int, heads: range,
               n: int) -> torch.Tensor:
    """The slices of ``heads`` of the ``n`` equal head slices along
    ``dim`` of ``t`` (a view)."""
    if t.shape[dim] % n:
        raise ValueError(f"dimension {dim} of {tuple(t.shape)} does not hold "
                         f"{n} equal heads")
    w = t.shape[dim] // n
    return t.narrow(dim, heads.start * w, len(heads) * w)


# --- the groups a model's collectives run on ---------------------------------

class DistGroup:
    """A ``torch.distributed`` process group behind the collectives a
    model runs (:class:`ModelGroup`, :class:`DataShards`,
    :func:`data_mean`, :func:`assignments_ahead`): its size, this rank's
    place in it, and the four collectives, each on the group."""

    def __init__(self, group):
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)

    def all_reduce(self, t: torch.Tensor) -> None:
        dist.all_reduce(t, group=self.group)

    def all_gather(self, parts: list, t: torch.Tensor) -> None:
        dist.all_gather(parts, t, group=self.group)

    def all_gather_into_tensor(self, out: torch.Tensor,
                               t: torch.Tensor) -> None:
        dist.all_gather_into_tensor(out, t, group=self.group)

    def reduce_scatter_tensor(self, out: torch.Tensor,
                              t: torch.Tensor) -> None:
        dist.reduce_scatter_tensor(out, t, group=self.group)


class CountingGroup:
    """One rank's stand-in for its group on a mesh axis, where the other
    ranks do not run (the dry-run, ``launch/dryrun.py``, and its probe on
    the card): ``size`` and ``rank`` as the group's, and collectives
    that move nothing and record each call in ``calls`` as ``(kind,
    axis, operand bytes)``, ``kind`` JAX's name (``all-reduce``,
    ``all-gather``, ``reduce-scatter``), ``axis`` the mesh axis it
    stands for.  An all-reduce leaves its operand as it is (this rank's
    partial); a gather fills every part with this rank's block, a
    reduce-scatter takes this rank's part of its input, so the outputs
    have the right shapes, dtypes and devices and finite values.  The
    fills run under ``kernels.meta.quiet``: they are not the rank's work.

    It is chosen explicitly, by whoever builds a rank for counting; a
    model placed on a real group never falls back to it."""

    def __init__(self, size: int, rank: int = 0, axis: str = "model"):
        if not 0 <= rank < size:
            raise ValueError(f"rank {rank} of a group of {size}")
        self.size, self.rank, self.axis = int(size), int(rank), axis
        self.calls: list[tuple[str, str, int]] = []

    def _record(self, kind: str, t: torch.Tensor) -> None:
        self.calls.append((kind, self.axis, t.numel() * t.element_size()))

    def all_reduce(self, t: torch.Tensor) -> None:
        self._record("all-reduce", t)

    def all_gather(self, parts: list, t: torch.Tensor) -> None:
        self._record("all-gather", t)
        with _kmeta.quiet():
            for p in parts:
                p.copy_(t)

    def all_gather_into_tensor(self, out: torch.Tensor,
                               t: torch.Tensor) -> None:
        self._record("all-gather", t)
        with _kmeta.quiet():
            out.view(self.size, -1).copy_(t.reshape(1, -1))

    def reduce_scatter_tensor(self, out: torch.Tensor,
                              t: torch.Tensor) -> None:
        self._record("reduce-scatter", t)
        with _kmeta.quiet():
            out.copy_(t.view(self.size, -1)[self.rank])


def counting_groups(mesh, coords) -> dict:
    """The :class:`CountingGroup` stand-ins of the device at ``coords``:
    ``model`` its model axis (None for one rank), ``data`` its data
    group over ``('pod', 'data')`` (None for one rank), and ``groups``
    for ``place_rank``: on a mesh with a ``'pod'`` axis, its pod's data
    ranks, ``{("data",): group}``."""
    coords = _coords(mesh, coords)
    mp, dp = mesh.shape.get("model", 1), data_size(mesh)
    out = dict(
        model=CountingGroup(mp, coords.get("model", 0), "model")
        if mp > 1 else None,
        data=CountingGroup(dp, data_index(mesh, coords),
                           ",".join(_data_axes(mesh))) if dp > 1 else None,
        groups={})
    if "pod" in mesh.axis_names and mesh.shape["data"] > 1:
        out["groups"][("data",)] = CountingGroup(mesh.shape["data"],
                                                 coords["data"], "data")
    return out


def collectives(group):
    """The collectives of ``group``: a :class:`DistGroup` or a
    :class:`CountingGroup` as it is, a process group wrapped in a
    :class:`DistGroup`."""
    if isinstance(group, (DistGroup, CountingGroup)):
        return group
    return DistGroup(group)


# --- the model group ---------------------------------------------------------

class ModelGroup:
    """The model axis of a tensor-parallel model: its group (a process
    group, or a :class:`CountingGroup`), its size and this rank's place
    in it, and the two collectives the model runs on it.  ``sums`` and
    ``gathers`` count the calls, ``seconds`` their host time (to the
    collective's end: gloo and a synchronous call)."""

    def __init__(self, group):
        self.group = group
        self.comm = collectives(group)
        self.size, self.rank = self.comm.size, self.comm.rank
        self.sums = self.gathers = 0
        self.seconds = 0.0

    def counts(self) -> dict:
        return dict(sums=self.sums, gathers=self.gathers,
                    seconds=self.seconds)

    @staticmethod
    def _check_no_grad(x: torch.Tensor) -> None:
        if x.requires_grad and torch.is_grad_enabled():
            raise ValueError("a tensor-parallel language model serves only "
                             "(no gradient crosses the model group; the JAX "
                             "package trains no language model on a model "
                             "axis either)")

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the group, in fp32, cast back to x's dtype:
        the same tensor on every rank."""
        self._check_no_grad(x)
        t0 = time.perf_counter()
        y = x.to(torch.float32, copy=True)
        self.comm.all_reduce(y)
        self.sums += 1
        self.seconds += time.perf_counter() - t0
        return y.to(x.dtype)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The ranks' blocks of ``x`` joined along its last dimension in
        rank order: the same tensor on every rank."""
        self._check_no_grad(x)
        t0 = time.perf_counter()
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.size)]
        self.comm.all_gather(parts, x)
        self.gathers += 1
        self.seconds += time.perf_counter() - t0
        return torch.cat(parts, -1)


# --- the data axis of an FSDP-placed model ------------------------------------

def fsdp_mesh(dp: int) -> MeshShape:
    """The ``(data, model)`` mesh of ``dp`` data ranks and a model axis of
    one: the layout JAX's launcher trains a language model on."""
    return MeshShape(("data", "model"), (dp, 1))


def fsdp_dims(shapes, dp) -> tuple[dict, dict]:
    """(key -> spec, key -> the dimension split over the data ranks or
    None) of every leaf of ``shapes`` on :func:`fsdp_mesh` of ``dp`` data
    ranks, or on ``dp`` itself, a ``(data, model)`` :class:`MeshShape`;
    raises where a leaf would split two dimensions over the data axis or
    a split one does not divide."""
    mesh = dp if isinstance(dp, MeshShape) else fsdp_mesh(dp)
    data = set(_data_axes(mesh))
    specs = param_pspecs(shapes, mesh)
    shapes, dims = _shapes(shapes), {}
    for k, spec in specs.items():
        split = [d for d, e in enumerate(spec) if e is not None
                 and data & set((e,) if isinstance(e, str) else e)]
        if len(split) > 1:
            raise ValueError(f"{k}: {spec} splits {len(split)} dimensions "
                             "over the data ranks")
        # raises where a split one is uneven (the 'model' dimensions are
        # the model column's blocks: head- or segment-aligned, or even)
        local_shape(shapes[k], [spec[d] if d in split else None
                                for d in range(len(spec))], mesh)
        parts = data_parts(spec[split[0]], mesh)[0] if split else 1
        dims[k] = split[0] if parts > 1 else None
    return specs, dims


def data_parts(entry, mesh) -> tuple[int, tuple]:
    """(parts, axes) of a spec entry's data axes: the entry's axes among
    ``('pod', 'data')``, in its order, and the product of their sizes."""
    axes = tuple(a for a in ((entry,) if isinstance(entry, str) else entry)
                 if a in ("pod", "data"))
    return math.prod(mesh.shape[a] for a in axes), axes


def model_block_shape(key: str, shape, spec, mesh, cfg=None, coords=None
                      ) -> tuple[int, ...]:
    """The shape of the block of leaf ``key`` (of ``shape``, under
    ``spec``) that the model column of ``mesh`` at ``coords`` (default:
    the first) executes once its data ranks' blocks are joined: every
    ``'model'``-split dimension (an MoE stack's experts on ``('data',
    'model')`` too) divided by the model axis, the ``'data'`` ones whole;
    with ``cfg``, an SSM model's fused leaves segment-aligned
    (``ssm_local_width``) and the attention's leaves head-aligned
    (:func:`head_blocks`: the column's heads, so the shape may differ from
    column to column)."""
    mp = mesh.shape.get("model", 1)
    out = [n // mp if e is not None and "model" in (
        (e,) if isinstance(e, str) else e) else n
        for n, e in zip(shape, spec)]
    name = _names(key)[-1]
    if cfg is not None and cfg.ssm is not None and name in SSM_SEGMENTS:
        out[-1] = ssm_local_width(cfg, name, mp)
    heads = leaf_head_range(cfg, key, spec, mesh, {
        a: 0 for a in mesh.axis_names} if coords is None else coords)
    if heads is not None:
        dim = _model_dim(spec)
        out[dim] = shape[dim] // heads[1] * len(heads[0])
    return tuple(out)


def expert_ids(n_experts: int, entry, mesh, coords) -> list[int]:
    """The ids of the experts, in order, that the model column of the
    device at ``coords`` runs under an expert stack's spec entry
    ``entry`` once its data ranks' blocks are joined (data rank order):
    on ``('data', 'model')`` (JAX's ``'ep'`` where the experts divide
    the combined axes) rank ``(d, m)`` holds chunk ``d * mp + m`` of ``dp
    * mp``, so the column runs chunks ``d' * mp + m`` for every ``d'``;
    on ``'model'`` (the fallback) chunk ``m`` of ``mp``; replicated, all
    of them."""
    coords = _coords(mesh, coords)
    axes = () if entry is None else (
        (entry,) if isinstance(entry, str) else tuple(entry))
    rows = range(mesh.shape["data"]) if "data" in axes else (
        coords["data"],)
    ids: list[int] = []
    for d in rows:
        parts, index = split_index(entry, mesh, {**coords, "data": d})
        n = n_experts // parts
        ids.extend(range(index * n, (index + 1) * n))
    return ids


def assignments_ahead(ids: torch.Tensor, n_ids: int, group
                      ) -> tuple[torch.Tensor, int]:
    """(the count of each of ``n_ids`` ids among the lower ranks' ``ids``
    of the data group ``group``, (n_ids,) int64 on ids' device; the
    group's size): every rank's flat ``ids`` (equal sizes) gathered in
    one all-gather, then counted without a host sync."""
    comm = collectives(group)
    size, me = comm.size, comm.rank
    ids = ids.contiguous()
    buf = ids.new_empty(size * ids.numel())
    comm.all_gather_into_tensor(buf, ids)
    lower = buf[:me * ids.numel()]
    ahead = torch.zeros(n_ids, dtype=torch.long, device=ids.device)
    return ahead.scatter_add_(0, lower, torch.ones_like(lower)), size


class _DataMean(torch.autograd.Function):
    """The mean over a data group; the gradient passes as it is."""

    @staticmethod
    def forward(ctx, x, group):
        comm = collectives(group)
        y = x.clone()
        comm.all_reduce(y)
        return y / comm.size

    @staticmethod
    def backward(ctx, g):
        return g, None


def data_mean(x: torch.Tensor, group) -> torch.Tensor:
    """The mean of ``x`` over the data group ``group`` (one all-reduce),
    for a statistic of the global batch that every rank then uses alike
    (an MoE layer's load-balance means).  Its backward hands each rank's
    ``x`` the mean's gradient: what is computed from the mean is the same
    on every rank, so the gradient of the global loss (each rank's
    gradient of its loss over dp, summed over the ranks) reaches every
    rank's ``x`` scaled by 1/dp, as the mean's own derivative asks."""
    return _DataMean.apply(x, group)


class _Gather(torch.autograd.Function):
    """Blocks -> whole leaves (:meth:`DataShards.gather`); the backward
    reduce-scatters the whole leaves' gradients back to the blocks."""

    @staticmethod
    def forward(ctx, shards, keys, *blocks):
        ctx.shards, ctx.keys = shards, keys
        ctx.metas = [(b.shape, b.dtype, b.device) for b in blocks]
        return tuple(shards._all_gather(keys, blocks))

    @staticmethod
    def backward(ctx, *grads):
        shards = ctx.shards
        grads = [torch.zeros(shards.whole_shape(k, len(shape)), dtype=dtype,
                             device=device) if g is None else g
                 for g, k, (shape, dtype, device) in zip(grads, ctx.keys,
                                                         ctx.metas)]
        return (None, None, *shards._reduce_scatter(ctx.keys, grads))


class DataShards:
    """The data axis of a language model placed FSDP-style (JAX's
    launcher: the parameters placed by :func:`param_pspecs` on a ``(dp,
    mp)`` mesh, trained on ``(dp, 1)``, served on any): its group, the
    leaves' shapes and the one dimension of each that is split over the
    data ranks, and the collectives that move the blocks.

    A rank holds :func:`local_block` of each leaf (JAX's 2-D block; an
    SSM model's fused leaves segment-aligned on ``'model'``), its
    parameters and, in training, both AdamW moments alike: every
    ``'dp'`` dimension split over the data ranks, an MoE stack's ``'ep'``
    dimension (the experts) where they divide, every other leaf whole
    over the data axis.  A model reads its "whole" weights through
    :meth:`gather`: the block its model column executes (on a model axis
    of one, the whole leaf), a layer's leaves at once where the layer
    runs (``models/common.py gather_layer``): one all-gather of a flat
    buffer a dtype, whose backward reduce-scatters the gathered leaves'
    gradients back to the blocks (the sum over the ranks, in the
    gradient's dtype).  ``shapes`` holds those gathered shapes.
    ``gathers`` and ``scatters`` count those calls, ``seconds`` their
    host time, as :class:`ModelGroup` counts its.

    On a mesh with a ``'pod'`` axis (JAX's multi-pod production mesh,
    ``launch/mesh.make_production_mesh``) the data group is the
    ``('pod', 'data')`` ranks of a model column, pod major
    (:func:`data_index`), and a ``'dp'`` leaf is split over all of them;
    an expert stack's ``'ep'`` entry names ``'data'`` alone, so it is
    split over the data ranks of this pod and gathered over those:
    ``groups`` maps such a tuple of data axes (``("data",)``) to its
    group.  ``axes`` holds each split leaf's data axes.

    A gathered weight lives while its layer runs and no longer: the
    placement exists so that no rank holds its column's whole block, and
    the model keeps nothing gathered across calls.

    The collectives are ``all_gather_into_tensor`` and
    ``reduce_scatter_tensor``, which gloo takes on CUDA tensors as on CPU
    ones (``tools/gloo_bench.py --fsdp``: torch 2.11 on an H100, moving
    a CUDA tensor through the host at about 0.8 GB/s); the group may be a
    ``CountingGroup`` (a dry-run's rank)."""

    def __init__(self, group, shapes, mesh=None, coords=None, cfg=None,
                 groups=None):
        self.group = group
        self.comm = collectives(group)
        self.size, self.rank = self.comm.size, self.comm.rank
        self.mesh = fsdp_mesh(self.size) if mesh is None else mesh
        if data_size(self.mesh) != self.size:
            raise ValueError(f"a data group of {self.size} ranks for "
                             f"{self.mesh!r}")
        self.coords = _coords(self.mesh, {"data": self.rank, "model": 0}
                              if coords is None else coords)
        if data_index(self.mesh, self.coords) != self.rank:
            raise ValueError(f"data rank {self.rank} at coordinates "
                             f"{self.coords}")
        whole = _shapes(shapes)
        self.specs, self.dims = fsdp_dims(whole, self.mesh)
        self.axes = {k: data_parts(self.specs[k][d], self.mesh)[1]
                     for k, d in self.dims.items() if d is not None}
        self.comms = {_data_axes(self.mesh): self.comm}
        for axes, g in (groups or {}).items():
            self.comms[tuple(axes)] = collectives(g)
        for k, axes in self.axes.items():
            if axes not in self.comms:
                raise ValueError(f"{k} is split over {axes}: pass its "
                                 "group in groups=")
        self.shapes = {k: model_block_shape(k, s, self.specs[k], self.mesh,
                                            cfg, self.coords)
                       for k, s in whole.items()}
        self.gathers = self.scatters = 0
        self.seconds = 0.0

    def counts(self) -> dict:
        return dict(gathers=self.gathers, scatters=self.scatters,
                    seconds=self.seconds)

    def split(self, key: str) -> bool:
        """Whether the leaf ``key`` is held as blocks."""
        return self.dims[key] is not None

    def _part(self, key: str) -> tuple[int, int]:
        """(parts, index) of ``key``'s split dimension at this rank."""
        axes = self.axes[key]
        return split_index(_axis(axes), self.mesh, self.coords)

    def whole_shape(self, key: str, ndim: int) -> tuple[int, ...]:
        """The whole shape of ``key``'s last ``ndim`` dimensions (a layer's
        slice of a stacked leaf has one fewer than the leaf)."""
        return self.shapes[key][len(self.shapes[key]) - ndim:]

    def block_shape(self, key: str, ndim: int | None = None
                    ) -> tuple[int, ...]:
        """The shape of this rank's block of ``key`` (its last ``ndim``
        dimensions)."""
        shape = list(self.shapes[key])
        if self.dims[key] is not None:
            shape[self.dims[key]] //= self._part(key)[0]
        return tuple(shape[len(shape) - (ndim or len(shape)):])

    def block(self, key: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's block of the gathered leaf ``t`` of ``key`` (a
        view)."""
        if tuple(t.shape) != self.shapes[key]:
            raise ValueError(f"{key}: a whole leaf of {self.shapes[key]}, "
                             f"got {tuple(t.shape)}")
        if self.dims[key] is None:
            return t
        return _block(t, self.dims[key], *self._part(key))

    def _dim(self, key: str, t: torch.Tensor) -> int:
        """The split dimension of ``t``, ``key``'s block or a layer's
        slice of it; raises where ``t`` is not that block's shape."""
        want = self.block_shape(key, t.dim())
        if tuple(t.shape) != want:
            raise ValueError(
                f"{key}: this data rank holds blocks of {want}, and was "
                f"handed {tuple(t.shape)} (a whole leaf where a block is "
                "expected?)")
        return self.dims[key] - (len(self.shapes[key]) - t.dim())

    def _batches(self, keys, tensors):
        """The indices of ``tensors`` by (group, dtype), in first-seen
        order: one collective each."""
        out: dict = {}
        for i, (k, t) in enumerate(zip(keys, tensors)):
            out.setdefault((self.axes[k], t.dtype), []).append(i)
        return out.items()

    def _all_gather(self, keys, blocks) -> list[torch.Tensor]:
        t0 = time.perf_counter()
        dims = [self._dim(k, b) for k, b in zip(keys, blocks)]
        out: list = [None] * len(blocks)
        for (axes, _), idx in self._batches(keys, blocks):
            comm = self.comms[axes]
            flat = torch.cat([blocks[i].reshape(-1) for i in idx])
            buf = flat.new_empty(comm.size * flat.numel())
            comm.all_gather_into_tensor(buf, flat)
            buf = buf.view(comm.size, -1)
            start = 0
            for i in idx:
                n, shape = blocks[i].numel(), blocks[i].shape
                out[i] = torch.cat([row.narrow(0, start, n).view(shape)
                                    for row in buf.unbind(0)], dims[i])
                start += n
        self.gathers += 1
        self.seconds += time.perf_counter() - t0
        return out

    def _reduce_scatter(self, keys, grads) -> list[torch.Tensor]:
        t0 = time.perf_counter()
        dims = []
        for k, g in zip(keys, grads):
            if tuple(g.shape) != self.whole_shape(k, g.dim()):
                raise ValueError(f"{k}: a whole gradient of "
                                 f"{self.whole_shape(k, g.dim())}, got "
                                 f"{tuple(g.shape)}")
            dims.append(self.dims[k] - (len(self.shapes[k]) - g.dim()))
        out: list = [None] * len(grads)
        for (axes, _), idx in self._batches(keys, grads):
            comm = self.comms[axes]
            parts = [grads[i].chunk(comm.size, dims[i]) for i in idx]
            buf = torch.cat([p[r].reshape(-1) for r in range(comm.size)
                             for p in parts])
            flat = buf.new_empty(buf.numel() // comm.size)
            comm.reduce_scatter_tensor(flat, buf)
            start = 0
            for j, i in enumerate(idx):
                shape = parts[j][comm.rank].shape
                n = parts[j][comm.rank].numel()
                out[i] = flat.narrow(0, start, n).view(shape)
                start += n
        self.scatters += 1
        self.seconds += time.perf_counter() - t0
        return out

    def gather(self, keys, tensors) -> list[torch.Tensor]:
        """The whole leaves of ``tensors`` (each ``keys``' leaf, or a
        layer's slice of it): a split leaf's block gathered over the data
        group (one collective a dtype, differentiable: the backward
        reduce-scatters the gradient), any other passed as it is."""
        idx = [i for i, k in enumerate(keys) if self.dims[k] is not None]
        out = list(tensors)
        if idx:
            whole = _Gather.apply(self, [keys[i] for i in idx],
                                  *(tensors[i] for i in idx))
            for i, t in zip(idx, whole):
                out[i] = t
        return out

    @torch.no_grad()
    def whole(self, key: str, t: torch.Tensor) -> torch.Tensor:
        """The whole leaf of ``key`` from this rank's block ``t`` (every
        rank of the group calls it, in the same order); a whole leaf is
        returned as it is."""
        if self.dims[key] is None:
            return t
        return self._all_gather([key], [t.detach()])[0]
