"""Mixture-of-Experts FFN: the top-k router, the dense dispatch, the
dropless one-device dispatch and the sharded dispatch with its three
schedules (mirrors ``src/repro/models/moe.py``; the dropless dispatch is
the port's own).

``apply_moe_dense`` is the reference's semantics: exact top-k of the
softmax, renormalised, no capacity and no drops; every expert runs over
all tokens with the unchosen ones masked to zero, and the combine weighs
each expert's output by its gate weight.  That is E / k times the expert
work the chosen pairs need (4x for Granite's top-8 of 32).  The expert
products are plain batched matmuls, as the reference leaves its einsums
to XLA.  On a mesh its load-balancing loss is the reference's over the
global batch: the token counts per expert are summed over the batch
shards, and each rank's loss is its share, whose sum over the shards is
the global loss (:func:`aux_load_balance_loss`).

``apply_moe_dropless`` computes the same function at the work the chosen
pairs need, on one device: the (token, choice) pairs sorted by expert,
each expert's SwiGLU over its own rows only, then each token's k outputs
weighed by their gates and summed.  On the card (bf16, no gradient) the
products are ``torch._grouped_mm`` over the experts' row ranges, whose
ends stay on the device, so nothing waits for the card; elsewhere one
``torch.mm`` per expert that has rows.  It adds to the tallies
``moe.pairs`` (T k) and ``moe.max_expert_rows`` (the busiest expert's
rows), and opens the spans ``granite.moe.route`` and
``granite.moe.experts``.

``apply_moe_sharded`` is the production dispatch on a mesh: each rank
routes its own tokens, scatters the pairs each expert can take into an
(E, cap, D) buffer with cap = max(4, ceil(capacity_factor k T / E)) from
the rank's own T, drops the rest, sends every expert's slots to the rank
that holds it (``all_to_all``), runs the experts and sends the results
home.  Which pairs drop depends on each rank's T and on token order, so
the ranks take the tokens the reference's ``shard_map`` gives them: the
port's activations are batch shards over (pod, data), replicated over
``model``, and each rank takes its ``model`` block of the sequence
(``2d``, ``ep_tp``; the whole sequence where it does not divide, as in
decode) or of D (``2d_dshard``), and gathers the output back.  The
expert weights are never gathered whole: each schedule redistributes
them to its own layout (:data:`LAYOUTS`) and keeps this rank's shard.
Its load-balancing loss is the reference's: each shard's loss over its
own tokens, averaged over the shards.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.distributed import collectives as col
from repro_torch.sharding.rules import BATCH_AXES, PartitionSpec, mesh_axes, placements
from repro_torch.tracing import recording, span, tally
from .common import Params, dense_init


def init_moe(gen: torch.Generator, d_model: int, d_ff: int, n_experts: int,
             top_k: int, dtype: torch.dtype = torch.float32) -> Params:
    """The router is float32 whatever ``dtype`` is, as in the reference."""
    return {
        "router": dense_init(gen, (d_model, n_experts), dtype=torch.float32),
        "w_gate": dense_init(gen, (n_experts, d_model, d_ff), in_axis=1, dtype=dtype),
        "w_up": dense_init(gen, (n_experts, d_model, d_ff), in_axis=1, dtype=dtype),
        "w_down": dense_init(gen, (n_experts, d_ff, d_model), in_axis=1, dtype=dtype),
    }


def router_probs(router: torch.Tensor, x: torch.Tensor, top_k: int):
    """x: (..., D).  Returns (indices (..., k), weights (..., k) in x's
    dtype, float32 logits (..., E)): the top k of the softmax, then
    renormalised over those k."""
    logits = torch.matmul(x.float(), router.float())
    weights, idx = torch.topk(torch.softmax(logits, dim=-1), top_k, dim=-1)
    weights = weights / torch.sum(weights, dim=-1, keepdim=True)
    return idx, weights.to(x.dtype), logits


def aux_load_balance_loss(logits: torch.Tensor, idx: torch.Tensor,
                          n_experts: int, mesh=None) -> torch.Tensor:
    """Switch-style load-balancing loss: E * sum_e (mean router probability
    of e) * (share of tokens that chose e).  On a mesh both means are over
    the global batch: the shares come from counts summed over the batch
    shards, and the probabilities' sum over this rank's tokens is divided
    by the global token count, so the loss returned is this rank's share
    of the global one."""
    probs = torch.softmax(logits, dim=-1)
    chosen = torch.zeros((idx[..., 0].numel(), n_experts), dtype=torch.float32,
                         device=idx.device)
    chosen.scatter_(1, idx.reshape(-1, idx.shape[-1]), 1.0)
    if mesh is None:
        me = torch.mean(probs.reshape(-1, n_experts), dim=0)
        ce = torch.mean(chosen, dim=0)
        return n_experts * torch.sum(me * ce)
    from repro_torch.distributed.collectives import batch_sum
    counts = torch.cat([chosen.sum(dim=0), chosen.new_full((1,), chosen.shape[0])])
    counts = batch_sum(counts, mesh)
    n = counts[-1]
    me_share = torch.sum(probs.reshape(-1, n_experts), dim=0) / n
    return n_experts * torch.sum(me_share * (counts[:-1] / n))


def _expert_ffn(w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor,
                x: torch.Tensor) -> torch.Tensor:
    """x: (E, T, D) grouped tokens -> (E, T, D), a SwiGLU per expert."""
    h = F.silu(torch.bmm(x, w_gate)) * torch.bmm(x, w_up)
    return torch.bmm(h, w_down)


def apply_moe_dense(params: Params, x: torch.Tensor, top_k: int,
                    n_experts: int, mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact dispatch, no drops.  x: (B, S, D) -> (y, aux); on a mesh x is
    this rank's batch shard and aux its share (:func:`aux_load_balance_loss`)."""
    B, S, D = x.shape
    idx, w, logits = router_probs(params["router"], x, top_k)        # (B, S, k)
    combine = torch.zeros((B, S, n_experts), dtype=x.dtype, device=x.device)
    combine = combine.scatter(-1, idx, w)                             # (B, S, E)
    mask = (combine != 0).to(x.dtype)
    xe = x.reshape(1, B * S, D) * mask.reshape(B * S, n_experts).t()[..., None]
    ye = _expert_ffn(params["w_gate"], params["w_up"], params["w_down"], xe)
    y = torch.einsum("etd,te->td", ye, combine.reshape(B * S, n_experts))
    return y.reshape(B, S, D), aux_load_balance_loss(logits, idx, n_experts, mesh)


# ---------------------------------------------------------------------------
# dropless one-device dispatch
# ---------------------------------------------------------------------------

def _grouped(x: torch.Tensor, *ws: torch.Tensor) -> bool:
    """Whether ``torch._grouped_mm`` takes these products: bf16 on the card,
    rows 16 bytes wide, and no gradient to carry."""
    return (x.is_cuda and hasattr(torch, "_grouped_mm")
            and all(t.dtype == torch.bfloat16 and t.shape[-1] % 8 == 0 for t in (x, *ws))
            and not (torch.is_grad_enabled() and any(t.requires_grad for t in (x, *ws))))


def _experts_grouped(xs: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                     w_down: torch.Tensor, ends: torch.Tensor) -> torch.Tensor:
    """xs (M, D), its rows sorted by expert, expert e's rows ending at
    ``ends[e]`` -> (M, D): each row through its expert's SwiGLU, three
    grouped products."""
    g = torch._grouped_mm(xs, w_gate, offs=ends)
    u = torch._grouped_mm(xs, w_up, offs=ends)
    return torch._grouped_mm(F.silu(g) * u, w_down, offs=ends)


def _experts_looped(xs: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                    w_down: torch.Tensor, counts: List[int]) -> torch.Tensor:
    """:func:`_experts_grouped` with the row counts on the host, one expert
    at a time."""
    out, start = [], 0
    for e, n in enumerate(counts):
        if n:
            r = xs[start:start + n]
            out.append(torch.mm(F.silu(torch.mm(r, w_gate[e])) * torch.mm(r, w_up[e]), w_down[e]))
        start += n
    return torch.cat(out) if out else xs.new_zeros((0, w_down.shape[-1]))


def apply_moe_dropless(params: Params, x: torch.Tensor, top_k: int, n_experts: int,
                       with_aux: bool = True) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """:func:`apply_moe_dense`'s function on one device at the work the
    chosen pairs need.  x: (..., D) -> (y of x's shape, aux), aux None
    unless ``with_aux``.  The token gather and the combine run outside the
    two spans, in the caller's, so that a caller's device range spans the
    experts' products."""
    D = x.shape[-1]
    xf = x.reshape(-1, D)
    T = xf.shape[0]
    with span("granite.moe.route", T=T, E=n_experts, k=top_k):
        idx, gates, logits = router_probs(params["router"], xf, top_k)   # (T, k)
        by_expert, order = torch.sort(idx.reshape(-1), stable=True)   # pair order within one
        ends = torch.searchsorted(by_expert, torch.arange(1, n_experts + 1,
                                                          device=by_expert.device))
        counts = torch.diff(ends, prepend=ends.new_zeros(1))
        busiest = counts.max()
    tally("moe.pairs", T * top_k)
    tally("moe.max_expert_rows", busiest)
    ws = (params["w_gate"], params["w_up"], params["w_down"])
    attrs = ({"pairs": T * top_k, "max_rows": busiest, "experts": torch.count_nonzero(counts)}
             if recording() else {})
    xs = xf.index_select(0, order // top_k)                 # the pairs' rows, by expert
    with span("granite.moe.experts", **attrs):
        if _grouped(xs, *ws):
            ys = _experts_grouped(xs, *ws, ends.to(torch.int32))
        else:
            ys = _experts_looped(xs, *ws, counts.tolist())
    del xs
    back = torch.empty_like(order).scatter_(0, order, torch.arange(order.numel(),
                                                                   device=order.device))
    ys = ys.index_select(0, back).view(T, top_k, D)         # each token's k outputs
    y = torch.bmm(gates.view(T, 1, top_k), ys).view(x.shape)
    aux = aux_load_balance_loss(logits, idx, n_experts) if with_aux else None
    return y, aux


# ---------------------------------------------------------------------------
# sharded (production) dispatch
# ---------------------------------------------------------------------------

def choose_schedule(n_experts: int, d_model: int, d_ff: int, mesh,
                    ep_axis: str = "data", tp_axis: str = "model",
                    budget_bytes: int = 64 * 2**20) -> str:
    """Pick the sharded dispatch's schedule.

    ``ep_tp`` (experts sharded over the tensor axis, full-width FFN, no
    token all-gather) wins when the per-device expert weights it implies
    -- total expert params / |tp|, replicated over the data axis -- fit a
    modest budget.  Small-expert models (granite: 6 MB/layer) qualify;
    kimi-k2 (2.1 GB/layer) must keep the 2D schedule.  When experts are
    narrower than d_model, ``2d_dshard`` dispatches D/tp slices and sums
    only the (tokens, F) hidden over the tensor axis."""
    tp = mesh_axes(mesh).get(tp_axis, 1)
    if n_experts % tp == 0:
        per_dev = 3 * n_experts * d_model * d_ff * 2 // tp
        if per_dev <= budget_bytes:
            return "ep_tp"
    if d_ff < d_model and d_model % tp == 0:
        return "2d_dshard"
    return "2d"


# (w_gate / w_up, w_down, router) per schedule: the mesh axis that splits
# each dimension (the reference's shard_map in_specs, :214-219, :290-296,
# :372-378); every other axis replicates the weight
LAYOUTS: Dict[str, Dict[str, PartitionSpec]] = {
    "2d": {"w_gate": PartitionSpec("data", None, "model"),
           "w_up": PartitionSpec("data", None, "model"),
           "w_down": PartitionSpec("data", "model", None),
           "router": PartitionSpec()},
    "ep_tp": {"w_gate": PartitionSpec("model", None, None),
              "w_up": PartitionSpec("model", None, None),
              "w_down": PartitionSpec("model", None, None),
              "router": PartitionSpec()},
    "2d_dshard": {"w_gate": PartitionSpec("data", "model", None),
                  "w_up": PartitionSpec("data", "model", None),
                  "w_down": PartitionSpec("data", None, "model"),
                  "router": PartitionSpec("model", None)},
}

_ROUTE_LOG: Optional[List[dict]] = None


@contextlib.contextmanager
def route_log():
    """For the duration, every sharded dispatch appends to the list
    yielded a dict of its ``schedule``, ``cap``, local ``tokens`` T and,
    per (token, choice) pair in the order t k + j, its ``expert``,
    ``slot`` and ``keep`` (tensors on the dispatch's device)."""
    global _ROUTE_LOG
    prev, _ROUTE_LOG = _ROUTE_LOG, []
    try:
        yield _ROUTE_LOG
    finally:
        _ROUTE_LOG = prev


def capacity(tokens: int, top_k: int, n_experts: int, capacity_factor: float) -> int:
    """Slots per expert on a shard of ``tokens`` tokens (reference :182)."""
    return max(4, math.ceil(capacity_factor * top_k * tokens / n_experts))


def slots(flat_e: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Each pair's slot on its expert: the count of earlier pairs (in the
    order t k + j) that chose the same expert, the reference's cumulative
    count (:184-185), here by a stable sort of the pairs by expert, which
    keeps pair order within an expert.  (The count's (T k, E) one-hot is
    1.6 GB per layer for Kimi's train_4k shard, and its scan along T k
    runs one thread per expert.)"""
    sorted_e, order = torch.sort(flat_e, stable=True)
    start = torch.searchsorted(sorted_e, torch.arange(n_experts, device=flat_e.device))
    place = torch.arange(flat_e.numel(), device=flat_e.device) - start[sorted_e]
    return torch.empty_like(flat_e).scatter_(0, order, place)


def _axis(mesh, name: str):
    """(group, size) of mesh axis ``name``."""
    return mesh.get_group(name), mesh.size(mesh.mesh_dim_names.index(name))


def _local_weight(p: torch.Tensor, mesh, spec: PartitionSpec) -> torch.Tensor:
    """This rank's shard of ``p`` in the layout ``spec``.  Its gradient is
    that shard's on every axis ``spec`` splits and partial on every other,
    where the ranks see other tokens (or, on the batch axes, shares of
    the same ones).  A plain tensor is taken as the same whole weight on
    every rank."""
    if not isinstance(p, DTensor):
        p = DTensor.from_local(p, mesh, [Replicate()] * mesh.ndim, run_check=False)
    want = placements(spec, mesh)
    return col.local_of(p, want, [pl if isinstance(pl, Shard) else Partial() for pl in want])


def _scatter(xf: torch.Tensor, dest: torch.Tensor, n_experts: int, cap: int,
             top_k: int) -> torch.Tensor:
    """The (E, cap, D) buffer: each kept pair's token added into zeros at
    its slot ``dest`` = expert cap + slot (reference :187-189).  A dropped
    pair's ``dest`` is a row past the buffer, cut off after: no pair
    lands twice on a kept slot, so the sum is exact and its order moot."""
    buf = xf.new_zeros((n_experts * cap + 1, xf.shape[-1]))
    buf = buf.index_add(0, dest, xf.repeat_interleave(top_k, dim=0))
    return buf[:-1].reshape(n_experts, cap, -1)


def _combine(back: torch.Tensor, dest: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(T, D): each token's kept pairs' expert outputs weighted by their
    gate weights and summed (reference :208-211); a dropped pair reads
    the zero row past the buffer."""
    rows = F.pad(back.reshape(-1, back.shape[-1]), (0, 0, 0, 1))
    got = rows.index_select(0, dest) * w.reshape(-1, 1)
    T, k = w.shape
    return got.reshape(T, k, -1).sum(dim=1)


def _exchange(buf: torch.Tensor, group, n: int) -> torch.Tensor:
    """(E, cap, D) -> (E/n, n cap, D): every expert's slots from the n
    ranks of ``group``, on the rank that holds the expert."""
    E, cap, D = buf.shape
    recv = col.all_to_all(buf.reshape(n, E // n, cap, D), group)
    return recv.transpose(0, 1).reshape(E // n, n * cap, D)


def _return(ye: torch.Tensor, group, n: int) -> torch.Tensor:
    """The inverse of :func:`_exchange`."""
    e_local, ncap, D = ye.shape
    ye = ye.reshape(e_local, n, ncap // n, D).transpose(0, 1).contiguous()
    return col.all_to_all(ye, group).reshape(n * e_local, ncap // n, D)


def apply_moe_sharded(params: Params, x: torch.Tensor, top_k: int, n_experts: int,
                      mesh, ep_axis: str = "data", tp_axis: str = "model",
                      capacity_factor: float = 1.25,
                      schedule: str = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
    """The sharded dispatch (reference :134-382).  x: this rank's batch
    shard (Bl, S, D), the same on every rank of ``tp_axis``; the params
    are DTensors (or whole tensors) of any layout.  Returns (y, aux): y
    of x's shape, the same on every rank of ``tp_axis``, and this rank's
    share of the load-balancing loss: the mean of every shard's own loss
    over the (pod, data, model) shards, divided by |pod| |data|, so that
    its sum over the batch shards is that mean, which is the reference's
    ``pmean`` over ``ep_axis`` and ``tp_axis``.

    ``schedule``: ``2d`` (experts over ``ep_axis``, each expert's F over
    ``tp_axis``; tokens all-gathered over ``tp_axis`` and the partial
    outputs reduce-scattered back), ``ep_tp`` (whole experts over
    ``tp_axis``, one all_to_all over it), ``2d_dshard`` (experts over
    ``ep_axis``, D over ``tp_axis``: the router's logits and the hidden
    summed over ``tp_axis``), or ``auto`` (:func:`choose_schedule`)."""
    if schedule == "auto":
        schedule = choose_schedule(n_experts, x.shape[-1], params["w_gate"].shape[-1],
                                   mesh, ep_axis, tp_axis)
    if schedule not in LAYOUTS:
        raise ValueError(f"unknown MoE schedule {schedule!r}; have {', '.join(LAYOUTS)}")
    ep_group, ep = _axis(mesh, ep_axis)
    tp_group, tp = _axis(mesh, tp_axis)
    owners = tp if schedule == "ep_tp" else ep
    if n_experts % owners:
        raise ValueError(f"{n_experts} experts do not split over {owners} ranks")
    layout = LAYOUTS[schedule]
    if (ep_axis, tp_axis) != ("data", "model"):
        swap = {"data": ep_axis, "model": tp_axis}
        layout = {k: PartitionSpec(*(swap.get(a, a) for a in spec))
                  for k, spec in layout.items()}
    w = {k: _local_weight(params[k], mesh, layout[k]) for k in layout}
    S = x.shape[1]
    if schedule == "2d_dshard":
        x_l = col.split(x, tp_group, 2)
    elif S % tp == 0:
        x_l = col.split(x, tp_group, 1)
    else:                                   # decode: every tp rank has every token
        x_l = col.varying(x, tp_group)
    T = x_l.shape[0] * x_l.shape[1]
    xf = x_l.reshape(T, x_l.shape[2])
    if schedule == "2d_dshard":             # partial logits over D slices
        logits = col.all_reduce(torch.matmul(xf.float(), w["router"].float()), tp_group)
        gw, idx = torch.topk(torch.softmax(logits, dim=-1), top_k, dim=-1)
        gw = (gw / torch.sum(gw, dim=-1, keepdim=True)).to(x.dtype)
    else:
        idx, gw, logits = router_probs(w["router"], xf, top_k)
    cap = capacity(T, top_k, n_experts, capacity_factor)
    flat_e = idx.reshape(-1)
    slot = slots(flat_e, n_experts)
    keep = slot < cap
    if _ROUTE_LOG is not None:
        _ROUTE_LOG.append({"schedule": schedule, "cap": cap, "tokens": T,
                           "expert": flat_e.detach(), "slot": slot, "keep": keep})
    dest = torch.where(keep, flat_e * cap + slot, n_experts * cap)
    buf = _scatter(xf, dest, n_experts, cap, top_k)
    if schedule == "ep_tp":                 # one hop over the tensor axis
        ye = _expert_ffn(w["w_gate"], w["w_up"], w["w_down"], _exchange(buf, tp_group, tp))
        back = _return(ye, tp_group, tp)
    elif schedule == "2d":
        toks = col.all_gather(_exchange(buf, ep_group, ep), tp_group, 1)
        part = _expert_ffn(w["w_gate"], w["w_up"], w["w_down"], toks)
        back = _return(col.reduce_scatter(part, tp_group, 1), ep_group, ep)
    else:
        toks = _exchange(buf, ep_group, ep)
        g = col.all_reduce(torch.bmm(toks, w["w_gate"]), tp_group)
        u = col.all_reduce(torch.bmm(toks, w["w_up"]), tp_group)
        back = _return(torch.bmm(F.silu(g) * u, w["w_down"]), ep_group, ep)
    y = _combine(back, dest, gw).reshape(x_l.shape)
    if schedule == "2d_dshard":
        y = col.gather(y, tp_group, 2)
    elif S % tp == 0:
        y = col.gather(y, tp_group, 1)
    else:
        y = col.replicated(y, tp_group)
    aux = aux_load_balance_loss(logits, idx, n_experts)
    aux = col.replicated(col.all_reduce(aux, tp_group) / tp, tp_group)
    shards = math.prod(mesh.size(i) for i, n in enumerate(mesh.mesh_dim_names)
                       if n in BATCH_AXES)
    return y, aux / shards
