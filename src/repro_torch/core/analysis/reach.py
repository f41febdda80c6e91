"""Mirrors ``src/repro/core/analysis/reach.py`` (only the imports differ).

Detection-relevance reachability over the decoded micro-op stream.

The symbolic emulator's ``prune_flows`` fast path drops a forked child
flow when nothing it can ever execute matters downstream.  "Matters"
has two parts:

* **detection-relevant** statements — ``ld``/``st``/``shfl``: a flow
  that can reach none of these can contribute no trace events, hence no
  shuffle pairs, no alias facts, and no e-graph load classes;
* **memoization-relevant** statements — ``Label``s: block-entry
  memoization keys on (label uid, env signature), so a pruned flow that
  could still reach a label might have seeded ``seen_entries`` and
  thereby suppressed (or admitted) *sibling* flows.  A child that can
  reach no label provably cannot perturb the memo table either.

Only when a pc can reach neither is pruning a pure no-op on every
observable output — that is what lets ``prune_flows`` default to on
while the 20-kernel emulator golden stays byte-identical.

The successor approximation is deliberately conservative (it mirrors
the one the emulator used when pruning was opt-in): a branch may go to
its target and, when predicated, fall through; a predicated ``ret``
falls through; everything else advances.
"""

from __future__ import annotations

from typing import List, Sequence

from ..emulator.decode import (
    Decoded, K_BRA, K_LABEL, K_LD, K_RET, K_SHFL, K_ST,
)

_SEED_KINDS = frozenset((K_LD, K_ST, K_SHFL, K_LABEL))


def reach_flags(ops: Sequence[Decoded]) -> List[bool]:
    """``flags[pc]`` — may execution starting at ``pc`` still reach a
    detection- or memoization-relevant statement?"""
    n = len(ops)
    flags = [False] * n
    succs: List[tuple] = [()] * n
    for i, d in enumerate(ops):
        if d.kind in _SEED_KINDS:
            flags[i] = True
        if d.kind == K_BRA:
            out = []
            if d.target is not None:
                out.append(d.target)
                if d.pred is not None and i + 1 < n:
                    out.append(i + 1)
            elif i + 1 < n:
                out.append(i + 1)     # unresolved label: assume fallthrough
            succs[i] = tuple(out)
        elif d.kind == K_RET:
            succs[i] = (i + 1,) if d.pred is not None and i + 1 < n else ()
        else:
            succs[i] = (i + 1,) if i + 1 < n else ()

    changed = True
    while changed:
        changed = False
        for i in range(n - 1, -1, -1):
            if flags[i]:
                continue
            if any(flags[s] for s in succs[i]):
                flags[i] = True
                changed = True
    return flags
