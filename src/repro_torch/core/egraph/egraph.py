"""Mirrors ``src/repro/core/egraph/egraph.py`` (only the imports differ).

E-graph core: e-nodes, e-classes, union-find, congruence closure.

The equality-saturation middle-end (ACC Saturator, arXiv:2306.13002)
needs a compact equality store over per-block PTX dataflow: an *e-class*
is a set of provably equivalent value computations, an *e-node* is one
operator applied to e-class ids.  This module keeps the store minimal
and deterministic:

* e-class ids are dense ints allocated in insertion order; the
  union-find always keeps the **smallest** id of a merged set as the
  canonical root, so block-entry values stay canonical and extraction
  order is reproducible;
* the hashcons ``memo`` maps canonical e-nodes to their class, giving
  congruence-by-construction for nodes added after their children
  merged;
* :meth:`rebuild` restores congruence closure after arbitrary unions by
  re-canonicalizing every node to a fixed point (egg's deferred-rebuild
  idea; the per-block graphs here are small enough that the simple
  fixed-point pass beats worklist bookkeeping).

Nothing in this file knows about PTX: leaves are ``"sym"``/``"const"``
e-nodes whose ``payload`` carries the identity (register name, load
site, immediate value), written by :mod:`repro.core.egraph.build`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple


@dataclass(frozen=True)
class ENode:
    """One operator over e-class ids.

    ``op`` is the semantic operator key (``"add"``, ``"shr.s"``,
    ``"op:mul.wide.s32"`` for opaque passthroughs, ``"const"``/``"sym"``
    for leaves); ``payload`` disambiguates leaves (immediate value, or a
    hashable symbol identity) and participates in hashcons equality.
    """

    op: str
    width: int
    children: Tuple[int, ...] = ()
    payload: object = None


class EGraph:
    """Union-find + hashcons over :class:`ENode`, with rebuild."""

    def __init__(self) -> None:
        self._parent: List[int] = []
        self._memo: Dict[ENode, int] = {}
        # root id -> ordered node set (dict used as an ordered set)
        self._classes: Dict[int, Dict[ENode, None]] = {}
        self._const: Dict[int, int] = {}    # root id -> known const value
        self.n_unions = 0
        self._dirty = False

    # ------------------------------------------------------------------
    @property
    def n_classes(self) -> int:
        return len(self._classes)

    @property
    def n_nodes(self) -> int:
        return sum(len(nodes) for nodes in self._classes.values())

    def find(self, cid: int) -> int:
        parent = self._parent
        while parent[cid] != cid:
            parent[cid] = parent[parent[cid]]   # path halving
            cid = parent[cid]
        return cid

    def canonicalize(self, node: ENode) -> ENode:
        ch = tuple(self.find(c) for c in node.children)
        if ch == node.children:
            return node
        return ENode(node.op, node.width, ch, node.payload)

    def add(self, node: ENode) -> int:
        """Insert (hashconsed); returns the canonical class id."""
        node = self.canonicalize(node)
        cid = self._memo.get(node)
        if cid is not None:
            return self.find(cid)
        cid = len(self._parent)
        self._parent.append(cid)
        self._memo[node] = cid
        self._classes[cid] = {node: None}
        if node.op == "const":
            self._const[cid] = node.payload   # type: ignore[assignment]
        return cid

    def union(self, a: int, b: int) -> bool:
        """Merge two classes; returns True when they were distinct."""
        a, b = self.find(a), self.find(b)
        if a == b:
            return False
        if a > b:           # smallest id wins: deterministic canonicals
            a, b = b, a
        self._parent[b] = a
        self._classes[a].update(self._classes.pop(b))
        if b in self._const:
            self._const.setdefault(a, self._const.pop(b))
        self.n_unions += 1
        self._dirty = True
        return True

    # ------------------------------------------------------------------
    def rebuild(self) -> int:
        """Restore congruence closure; returns unions performed.

        Repeatedly re-canonicalizes every node and merges classes that
        now share a canonical node, until a fixed point.  Idempotent: a
        second call right after performs zero unions.
        """
        before = self.n_unions
        changed = self._dirty
        while changed:
            changed = False
            # find congruent classes under the current union-find
            memo: Dict[ENode, int] = {}
            pending: List[Tuple[int, int]] = []
            for cid in sorted(self._classes):
                for node in self._classes[cid]:
                    cn = self.canonicalize(node)
                    prev = memo.get(cn)
                    if prev is None:
                        memo[cn] = cid
                    elif self.find(prev) != self.find(cid):
                        pending.append((prev, cid))
            for a, b in pending:
                if self.union(a, b):
                    changed = True
            # re-key node sets and the hashcons canonically
            new_classes: Dict[int, Dict[ENode, None]] = {}
            new_memo: Dict[ENode, int] = {}
            for cid in sorted(self._classes):
                root = self.find(cid)
                bucket = new_classes.setdefault(root, {})
                for node in self._classes[cid]:
                    cn = self.canonicalize(node)
                    bucket[cn] = None
                    new_memo[cn] = root
            self._classes = new_classes
            self._memo = new_memo
        self._dirty = False
        return self.n_unions - before

    # ------------------------------------------------------------------
    def classes(self) -> Iterator[Tuple[int, Tuple[ENode, ...]]]:
        """Iterate ``(root id, nodes)`` in deterministic id order."""
        for cid in sorted(self._classes):
            yield cid, tuple(self._classes[cid])

    def nodes_of(self, cid: int) -> Tuple[ENode, ...]:
        return tuple(self._classes.get(self.find(cid), ()))

    def const_of(self, cid: int) -> Optional[int]:
        return self._const.get(self.find(cid))

    # ------------------------------------------------------------------
    def check_invariants(self) -> None:
        """Raise ``AssertionError`` on a broken e-graph (test hook).

        Valid immediately after :meth:`rebuild`: class keys are their
        own roots, every stored node is canonical and hashconsed to its
        class, and no two distinct classes share a congruent node.
        """
        seen: Dict[ENode, int] = {}
        for cid, nodes in self._classes.items():
            assert 0 <= cid < len(self._parent), f"class id {cid} out of range"
            assert self.find(cid) == cid, f"class key {cid} is not a root"
            assert nodes, f"class {cid} is empty"
            for node in nodes:
                cn = self.canonicalize(node)
                assert cn == node, f"non-canonical node {node} in {cid}"
                assert self._memo.get(node) is not None, \
                    f"node {node} missing from hashcons"
                assert self.find(self._memo[node]) == cid, \
                    f"hashcons maps {node} to {self._memo[node]}, not {cid}"
                prev = seen.get(node)
                assert prev is None or prev == cid, \
                    f"congruent node {node} in classes {prev} and {cid}"
                seen[node] = cid
                if node.op == "const":
                    assert self._const.get(cid) == node.payload, \
                        f"const cache disagrees with {node} in {cid}"
        for node, cid in self._memo.items():
            root = self.find(cid)
            assert root in self._classes, f"hashcons points at dead class {cid}"
