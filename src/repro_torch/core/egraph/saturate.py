"""Mirrors ``src/repro/core/egraph/saturate.py`` (only the imports differ).

Saturation driver: cross-flow load CSE + budgeted rule application.

``run_saturate`` is the body of the ``saturate`` pass.  It builds the
per-block e-graphs (:mod:`.build`), then adds the one equality source
that needs whole-kernel evidence — **cross-flow load CSE** — before
running the rewrite rules to a budgeted fixpoint.

Cross-flow load CSE uses the symbolic value numbers the emulator
already computed: two non-coherent global loads in the same block are
unioned when *every* symbolic flow observed them producing identical
value terms.  This is sound even inside loop bodies because the
emulator widens loop-written registers to fresh ``loop(id)`` atoms at
the header, so equal terms are equal for a *generic* iteration, not
just the first.  The check is skipped entirely when the emulation was
truncated (step/fork budgets) — a partial flow set proves nothing —
and any load observed guarded or invalidated (a store may alias it)
disqualifies its site.

Budgets: rule application stops after ``MAX_ITERS`` passes or once a
block's e-graph exceeds ``MAX_NODES`` e-nodes; either trip is counted
in ``sat_budget_hits`` so the stats surface shows when a kernel was cut
short rather than saturated.
"""

from __future__ import annotations

from typing import Dict, List

from ..emulator.trace import LoadEvent
from .build import BlockGraph, build_blocks
from .egraph import EGraph
from .rules import Rule, default_rules

MAX_ITERS = 8
MAX_NODES = 4096

# flow terminations that leave a trustworthy (complete or prefix) trace
_SOUND_TERMINATIONS = ("ret", "backedge", "memo", "pruned")


def saturate_block(eg: EGraph, rules, max_iters: int = MAX_ITERS,
                   max_nodes: int = MAX_NODES) -> Dict[str, int]:
    """Apply ``rules`` to fixpoint under budgets; returns counters."""
    eg.rebuild()
    applied = 0
    iters = 0
    budget_hit = 0
    while iters < max_iters:
        iters += 1
        changed = False
        snapshot = list(eg.classes())
        for cid, nodes in snapshot:
            for node in nodes:
                for rule in rules:
                    for other in rule.fn(eg, cid, node):
                        if eg.union(cid, other):
                            applied += 1
                            changed = True
                if eg.n_nodes > max_nodes:
                    budget_hit = 1
                    break
            if budget_hit:
                break
        eg.rebuild()
        if budget_hit or not changed:
            break
    else:
        budget_hit = 1
    return {"iterations": iters, "applied": applied,
            "budget_hits": budget_hit}


def cross_flow_load_unions(blocks: List[BlockGraph], flows,
                           emulator_counters: Dict[str, int]) -> int:
    """Union same-block nc-load classes proven equal in every flow."""
    if emulator_counters.get("truncated_steps") \
            or emulator_counters.get("truncated_forks"):
        return 0
    if any(fr.terminated not in _SOUND_TERMINATIONS for fr in flows):
        return 0
    candidates = {uid for bg in blocks for uid in bg.load_classes}
    if len(candidates) < 2:
        return 0

    # per-flow: load uid -> ordered value terms; poisoned sites drop out
    per_flow: List[Dict[int, list]] = []
    poisoned: set = set()
    for fr in flows:
        vals: Dict[int, list] = {}
        for ev in fr.trace:
            if isinstance(ev, LoadEvent) and ev.stmt_uid in candidates:
                if ev.guarded or ev.invalidated:
                    poisoned.add(ev.stmt_uid)
                vals.setdefault(ev.stmt_uid, []).append(ev.value)
        per_flow.append(vals)

    unions = 0
    for bg in blocks:
        uids = [u for u in sorted(bg.load_classes) if u not in poisoned]
        for i, a in enumerate(uids):
            for b in uids[i + 1:]:
                evidence = False
                equal = True
                for vals in per_flow:
                    va, vb = vals.get(a, []), vals.get(b, [])
                    if va != vb:
                        equal = False
                        break
                    if va:
                        evidence = True
                if equal and evidence:
                    if bg.eg.union(bg.load_classes[a], bg.load_classes[b]):
                        unions += 1
        if unions:
            bg.eg.rebuild()
    return unions


def run_saturate(ctx) -> None:
    """Body of the ``saturate`` pass (see ``passes/stages.py``)."""
    cfg = ctx.get("cfg")
    flows = ctx.get("flows")
    kernel = ctx.kernel
    blocks = build_blocks(kernel, cfg, decoded=ctx.get("decoded"))
    emu_counters = ctx.products.get("emulator_counters", {})
    load_unions = cross_flow_load_unions(blocks, flows, emu_counters)

    rules = default_rules()
    iterations = 0
    applied = 0
    budget_hits = 0
    for bg in blocks:
        stats = saturate_block(bg.eg, rules)
        iterations += stats["iterations"]
        applied += stats["applied"]
        budget_hits += stats["budget_hits"]

    counters = ctx.products.setdefault("saturation_counters", {})
    counters["sat_blocks"] = counters.get("sat_blocks", 0) + len(blocks)
    counters["sat_eclasses"] = counters.get("sat_eclasses", 0) \
        + sum(bg.eg.n_classes for bg in blocks)
    counters["sat_enodes"] = counters.get("sat_enodes", 0) \
        + sum(bg.eg.n_nodes for bg in blocks)
    counters["sat_iterations"] = counters.get("sat_iterations", 0) + iterations
    counters["sat_rules_applied"] = counters.get("sat_rules_applied", 0) + applied
    counters["sat_vn_unions"] = counters.get("sat_vn_unions", 0) \
        + sum(bg.vn_unions for bg in blocks)
    counters["sat_load_unions"] = counters.get("sat_load_unions", 0) + load_unions
    counters["sat_budget_hits"] = counters.get("sat_budget_hits", 0) + budget_hits
    ctx.products["_egraph_state"] = blocks
