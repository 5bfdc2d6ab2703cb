"""Mixture-of-Experts FFN (counterpart of ``repro/models/moe.py``):
DeepSeek-V3 / Moonlight routing (sigmoid scores, a top-k whose selection
reads ``router_bias`` and whose weights come from the raw scores,
renormalised and scaled by ``routed_scaling``), or softmax routing; the
Switch-style load-balance loss; shared (always-on) experts.

Two dispatches, as in the JAX package:

* dropless (``capacity_factor == 0``): the ``n * k`` assignments are
  sorted by expert (a stable sort, so each expert's rows keep token
  order) and each expert's contiguous group of rows runs three products
  (``torch.mm`` on slices; JAX's ``jax.lax.ragged_dot``, an XLA op with
  no Pallas kernel behind it).  The group sizes are read on the host:
  one device sync a layer;
* capacity (``capacity_factor > 0``): each expert takes at most ``cap =
  ceil(n * k / E * capacity_factor)`` rows, gathered into an (E, cap, D)
  buffer (empty slots zero) for three ``torch.bmm``; assignments past an
  expert's capacity are dropped.  No host sync.

The combine is deterministic: each token's k outputs are gathered back
to (n, k, D), weighted and summed one after another in ascending expert
id, each product and partial sum in the activations' dtype (the order of
JAX's scatter-add over the expert-sorted rows).  No ``index_add_``: its
atomics on the card change the sum's order from run to run.

Routing is discontinuous: where a token's k-th and (k+1)-th selection
scores lie closer than two computations' difference, the two select
different experts.  :class:`RoutingLog` records every MoE layer's
selection in a pass (or replays another pass's), and
:func:`compare_routing` counts the flips between two passes beside the
smallest selection margin and the largest score difference.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import common as cm

def moe_leaves(cfg) -> dict[str, tuple]:
    """The MoE FFN's leaves (JAX's ``init_moe``): ``name -> (shape, init,
    scale[, dtype])`` as ``common.attention_leaves``, the router (D, E)
    and ``router_bias`` (E,) (sigmoid routing: zeros; it steers the
    selection only) in fp32 whatever the model's dtype, the experts'
    ``w_gate``/``w_up`` (E, D, F) and ``w_down`` (E, F, D), and the shared
    experts as one MLP of ``n_shared * d_ff_expert``."""
    m = cfg.moe
    D, E, Fe = cfg.d_model, m.n_experts, m.d_ff_expert
    spec = {"router": ((D, E), "normal", D ** -0.5, "float32")}
    if m.score_fn == "sigmoid":
        spec["router_bias"] = ((E,), "zeros", 0.0, "float32")
    spec.update(w_gate=((E, D, Fe), "normal", D ** -0.5),
                w_up=((E, D, Fe), "normal", D ** -0.5),
                w_down=((E, Fe, D), "normal", Fe ** -0.5))
    if m.n_shared:
        spec.update({f"shared.{k}": v for k, v in
                     cm.mlp_leaves(cfg, d_ff=Fe * m.n_shared).items()})
    return spec


# --- routing -------------------------------------------------------------------

class RoutingLog:
    """The expert selection of every MoE layer a pass runs, recorded by
    ``(layer, first position)``: the selected experts (B, T, k) and the
    selection scores (B, T, E) fp32 (sigmoid: scores + ``router_bias``;
    softmax: the probabilities), detached.  A model whose ``routing`` is
    a log records into it (``transformer.forward`` and ``decode_step``).
    A log made with ``replay`` (another log) makes each layer take the
    replayed log's selection at the same positions instead of its own
    top-k, and records that."""

    def __init__(self, replay: "RoutingLog | None" = None):
        self.entries: dict[tuple[int, int], tuple] = {}
        self.replay = replay

    def layers(self) -> list[int]:
        return sorted({layer for layer, _ in self.entries})

    def selection(self, layer: int) -> tuple[torch.Tensor, torch.Tensor]:
        """``layer``'s experts (B, T, k) and scores (B, T, E) over the
        positions recorded, in order."""
        parts = sorted((pos, v) for (i, pos), v in self.entries.items()
                       if i == layer)
        return (torch.cat([v[0] for _, v in parts], dim=1),
                torch.cat([v[1] for _, v in parts], dim=1))

    def forced(self, layer: int, pos: int, B: int, T: int
               ) -> torch.Tensor | None:
        """The replayed selection of ``layer`` at positions pos..pos+T-1
        as (B * T, k), or None without a replay."""
        if self.replay is None:
            return None
        experts, _ = self.replay.selection(layer)
        return experts[:, pos:pos + T].reshape(B * T, -1)

    def record(self, layer: int, pos: int, experts: torch.Tensor,
               scores: torch.Tensor) -> None:
        self.entries[(layer, pos)] = (experts.detach(), scores.detach())


def compare_routing(ref: RoutingLog, other: RoutingLog) -> dict:
    """The two passes' selections layer by layer: ``flips`` (per layer,
    the (row, position) pairs whose selected sets differ), ``min_margin``
    (the smallest k-th minus (k+1)-th selection score of ``ref``: score
    differences below half of it cannot flip a selection) and
    ``max_score_diff`` (the largest |ref - other| selection score)."""
    flips, margin, diff = {}, float("inf"), 0.0
    for layer in ref.layers():
        e_a, s_a = ref.selection(layer)
        e_b, s_b = other.selection(layer)
        k = e_a.shape[-1]
        same = (e_a.sort(-1).values == e_b.sort(-1).values).all(-1)
        flips[layer] = int((~same).sum())
        if k < s_a.shape[-1]:
            top = s_a.topk(k + 1, dim=-1).values
            margin = min(margin, float((top[..., k - 1] - top[..., k]).min()))
        diff = max(diff, float((s_a - s_b).abs().max()))
    return dict(flips=flips, total_flips=sum(flips.values()),
                min_margin=margin, max_score_diff=diff)


def route(p: dict, x2d: torch.Tensor, cfg,
          forced: torch.Tensor | None = None):
    """x2d (n, D) -> weights (n, k) fp32, experts (n, k) int64, the
    load-balance loss (0-d fp32: E * sum_e f_e * mean p_e) and the
    selection scores (n, E) fp32.  The logits are fp32 (``x.float() @
    router``).  ``forced`` (n, k) replaces the top-k selection (the
    weights still come from this pass's scores)."""
    m = cfg.moe
    logits = x2d.float() @ p["router"].float()
    if m.score_fn == "sigmoid":
        scores = torch.sigmoid(logits)
        sel = scores + p["router_bias"]  # the bias steers selection only
    elif m.score_fn == "softmax":
        scores = sel = torch.softmax(logits, dim=-1)
    else:
        raise ValueError(f"unknown score_fn {m.score_fn!r}")
    idx = sel.topk(m.top_k, dim=-1).indices if forced is None else forced
    w = scores.gather(-1, idx)  # weights from the raw scores
    w = w / (w.sum(-1, keepdim=True) + 1e-9)
    if m.score_fn == "sigmoid":
        w = w * m.routed_scaling
    probs = scores / (scores.sum(-1, keepdim=True) + 1e-9)
    onehot = F.one_hot(idx, m.n_experts).float().sum(1)  # (n, E)
    aux = m.n_experts * (onehot.mean(0) * probs.mean(0)).sum()
    return w, idx, aux, sel.detach()


# --- dispatch --------------------------------------------------------------------

def _expert_mlp(x: torch.Tensor, w_gate, w_up, w_down, mm) -> torch.Tensor:
    """The experts' SwiGLU, the activation in fp32 (JAX's cast points)."""
    h = F.silu(mm(x, w_gate).float()).to(x.dtype) * mm(x, w_up)
    return mm(h, w_down)


def _combine(o: torch.Tensor, row_of: torch.Tensor, w: torch.Tensor,
             idx: torch.Tensor, kept: torch.Tensor | None = None
             ) -> torch.Tensor:
    """o (rows, D), row_of (n, k): the row of ``o`` token i's j-th
    selection produced -> (n, D): sum_j w[i, j] * o[row_of[i, j]], the
    selections taken in ascending expert id, each product and partial sum
    in o's dtype; a selection not ``kept`` adds zero."""
    by_expert = idx.argsort(dim=-1)
    ws = w.gather(1, by_expert).to(o.dtype)
    c = o[row_of.gather(1, by_expert)] * ws[..., None]  # (n, k, D)
    if kept is not None:
        c = torch.where(kept.gather(1, by_expert)[..., None], c, 0.0)
    out = c[:, 0]
    for j in range(1, c.shape[1]):
        out = out + c[:, j]
    return out


def _group_starts(e_sorted: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Where each expert's rows start in the expert-sorted assignments,
    and where the last ends: (E + 1,) on the device.  (``torch.bincount``
    would read its input's min and max on the host: two syncs.)"""
    return torch.searchsorted(e_sorted, torch.arange(
        n_experts + 1, device=e_sorted.device))


def _dropless(p: dict, x2d: torch.Tensor, w: torch.Tensor,
              idx: torch.Tensor, cfg) -> torch.Tensor:
    m = cfg.moe
    n, k = idx.shape
    flat_e = idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)  # rows grouped by expert
    xs = x2d[order // k]                          # (n * k, D)
    bounds = _group_starts(flat_e[order], m.n_experts).tolist()  # the sync
    weights = [p[name].unbind(0) for name in ("w_gate", "w_up", "w_down")]
    outs = []
    for e, (start, end) in enumerate(zip(bounds, bounds[1:])):
        if end > start:
            outs.append(_expert_mlp(xs[start:end],
                                    *(wt[e] for wt in weights), torch.mm))
    inverse = torch.empty_like(order)
    inverse[order] = torch.arange(n * k, device=order.device)
    return _combine(torch.cat(outs), inverse.view(n, k), w, idx)


def capacity(cfg, n: int) -> int:
    """Rows an expert takes from ``n`` tokens: ceil(n * k / E *
    capacity_factor) as JAX computes it (``+ 0.999``), at least 1."""
    m = cfg.moe
    return max(1, int(n * m.top_k / m.n_experts * m.capacity_factor + 0.999))


def _capacity(p: dict, x2d: torch.Tensor, w: torch.Tensor,
              idx: torch.Tensor, cfg) -> torch.Tensor:
    m = cfg.moe
    (n, D), k, E = x2d.shape, m.top_k, m.n_experts
    cap = capacity(cfg, n)
    dev = x2d.device
    flat_e = idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    e_sorted = flat_e[order]
    rank = torch.arange(n * k, device=dev) - _group_starts(e_sorted, E)[
        e_sorted]
    keep = rank < cap
    slot = e_sorted * cap + torch.where(keep, rank, 0)
    # slot -> source token, n for an empty slot; a dropped assignment
    # writes the spare slot E * cap, which is cut off
    slot_token = torch.full((E * cap + 1,), n, dtype=torch.long, device=dev)
    slot_token.scatter_(0, torch.where(keep, slot, E * cap), order // k)
    slot_token = slot_token[:E * cap]
    valid = (slot_token < n)[:, None].to(x2d.dtype)
    xe = torch.cat([x2d, x2d.new_zeros(1, D)])[slot_token] * valid
    o = _expert_mlp(xe.view(E, cap, D), p["w_gate"], p["w_up"], p["w_down"],
                    torch.bmm).view(E * cap, D)
    inverse = torch.empty_like(order)
    inverse[order] = torch.arange(n * k, device=dev)
    return _combine(o, slot[inverse].view(n, k), w, idx,
                    kept=keep[inverse].view(n, k))


def moe_ffn(p: dict, x: torch.Tensor, cfg, *,
            routing: RoutingLog | None = None, layer: int = 0,
            pos: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, T, D) -> (out (B, T, D), load-balance loss): the routed
    experts by the config's dispatch (module docstring), plus the shared
    experts.  ``routing`` records (or replays) this layer's selection as
    layer ``layer`` at positions ``pos``.. ``pos + T - 1``."""
    m = cfg.moe
    B, T, D = x.shape
    x2d = x.reshape(B * T, D)
    forced = None if routing is None else routing.forced(layer, pos, B, T)
    w, idx, aux, sel = route(p, x2d, cfg, forced=forced)
    if routing is not None:
        routing.record(layer, pos, idx.view(B, T, -1), sel.view(B, T, -1))
    experts = _capacity if m.capacity_factor > 0 else _dropless
    out = experts(p, x2d, w, idx, cfg).view(B, T, D)
    if m.n_shared:
        out = out + cm.apply_mlp(p["shared"], x, cfg)
    return out, aux
