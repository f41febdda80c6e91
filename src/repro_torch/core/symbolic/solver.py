"""Mirrors ``src/repro/core/symbolic/solver.py`` (only the imports differ).

SMT-lite decision procedures over affine terms.

Plays the role Z3 plays in the paper (Section 4.2/5.1):

* consistency of assumption sets (branch-predicate recording; conflicting
  values removed / unrealizable paths pruned),
* entailment queries (``can this branch be taken?``),
* the shuffle-delta equation ``A(lane + N) = B(lane)`` solved for constant
  ``N`` (Section 5.1), closed-form on affine addresses with a bounded
  search fallback.

Inequalities use the integer idealization of bitvectors (sound for the
in-range loop/index arithmetic of the target benchmarks; equality and
disequality are exact modular affine reasoning).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Set, Tuple

from .terms import Atom, BoolConst, BoolExpr, BoolOp, Cmp, Term, to_signed

_INF = float("inf")


class _Facts:
    """Interval + disequality facts per canonical affine form."""

    __slots__ = ("lo", "hi", "ne")

    def __init__(self) -> None:
        self.lo: float = -_INF
        self.hi: float = _INF
        self.ne: Set[int] = set()

    def consistent(self) -> bool:
        if self.lo > self.hi:
            return False
        if self.lo == self.hi and int(self.lo) in self.ne:
            return False
        return True


class AssumptionSet:
    """A set of path predicates with incremental contradiction detection.

    ``add`` returns False when the new predicate makes the path
    unrealizable (the emulator prunes it).  ``implied`` returns
    True/False/None for entailed/contradicted/unknown.
    """

    def __init__(self) -> None:
        self._facts: Dict[Tuple, _Facts] = {}
        self._exprs: List[BoolExpr] = []
        self._expr_set: Set[BoolExpr] = set()

    # ------------------------------------------------------------------
    def copy(self) -> "AssumptionSet":
        new = AssumptionSet.__new__(AssumptionSet)
        new._facts = {}
        for k, f in self._facts.items():
            nf = _Facts()
            nf.lo, nf.hi, nf.ne = f.lo, f.hi, set(f.ne)
            new._facts[k] = nf
        new._exprs = list(self._exprs)
        new._expr_set = set(self._expr_set)
        return new

    @property
    def exprs(self) -> List[BoolExpr]:
        return self._exprs

    # ------------------------------------------------------------------
    @staticmethod
    def _canon(diff: Term) -> Tuple[Tuple, int, int]:
        """Canonicalize ``diff rel 0``: returns (form-key, sign, const).

        The form key ignores the constant; ``sign`` is +1/-1 applied so the
        lowest-uid atom has positive coefficient (stable across  a-b  vs
        b-a).  The tracked quantity is ``sign * (diff - const)`` and facts
        are intervals on that quantity ``q`` with ``q rel' (-sign*const)``.
        """
        items = sorted(diff.coeffs.items(), key=lambda kv: kv[0].uid)
        if not items:
            return ((diff.width,), 1, to_signed(diff.const, diff.width))
        lead = to_signed(items[0][1], diff.width)
        sign = 1 if lead > 0 else -1
        key = (diff.width, tuple((a.uid, to_signed(c, diff.width) * sign) for a, c in items))
        return (key, sign, to_signed(diff.const, diff.width))

    def _fact(self, key: Tuple) -> _Facts:
        f = self._facts.get(key)
        if f is None:
            f = _Facts()
            self._facts[key] = f
        return f

    # ------------------------------------------------------------------
    def add(self, expr: BoolExpr) -> bool:
        """Record ``expr`` as true; returns False on contradiction."""
        if isinstance(expr, BoolConst):
            return expr.value
        if isinstance(expr, BoolOp):
            if expr.op == "and":
                return all(self.add(a) for a in expr.args)
            if expr.op == "not":
                return self.add(expr.args[0].negate())
            # or/xor: keep as opaque expression; only contradiction with an
            # identical negation is caught.
            if expr.negate() in self._expr_set:
                return False
            self._exprs.append(expr)
            self._expr_set.add(expr)
            return True
        assert isinstance(expr, Cmp)
        const_val = expr.eval_const()
        if const_val is not None:
            return const_val
        if expr.negate() in self._expr_set:
            return False
        self._exprs.append(expr)
        self._expr_set.add(expr)

        diff = expr.diff()
        key, sign, c = self._canon(diff)
        f = self._fact(key)
        rel = expr.rel
        if sign < 0:
            rel = {"lt": "gt", "gt": "lt", "le": "ge", "ge": "le"}.get(rel, rel)
        # fact variable q = sign*(diff - c);  constraint: q rel (-sign*c)
        bound = -sign * c
        if rel == "eq":
            f.lo = max(f.lo, bound)
            f.hi = min(f.hi, bound)
        elif rel == "ne":
            f.ne.add(bound)
        elif not expr.signed and expr.rel in ("lt", "le", "gt", "ge"):
            # Unsigned inequality on a symbolic form: only use the implied
            # nonnegativity of the smaller side when rhs is const.
            pass
        elif rel == "lt":
            f.hi = min(f.hi, bound - 1)
        elif rel == "le":
            f.hi = min(f.hi, bound)
        elif rel == "gt":
            f.lo = max(f.lo, bound + 1)
        elif rel == "ge":
            f.lo = max(f.lo, bound)
        return f.consistent()

    # ------------------------------------------------------------------
    def implied(self, expr: BoolExpr) -> Optional[bool]:
        """Entailment: True (must hold), False (cannot hold), None unknown."""
        if isinstance(expr, BoolConst):
            return expr.value
        if isinstance(expr, BoolOp):
            if expr in self._expr_set:
                return True
            if expr.negate() in self._expr_set:
                return False
            return None
        assert isinstance(expr, Cmp)
        cv = expr.eval_const()
        if cv is not None:
            return cv
        if expr in self._expr_set:
            return True
        if expr.negate() in self._expr_set:
            return False
        diff = expr.diff()
        key, sign, c = self._canon(diff)
        f = self._facts.get(key)
        if f is None:
            return None
        rel = expr.rel
        if sign < 0:
            rel = {"lt": "gt", "gt": "lt", "le": "ge", "ge": "le"}.get(rel, rel)
        if not expr.signed and expr.rel in ("lt", "le", "gt", "ge"):
            return None
        bound = -sign * c
        lo, hi = f.lo, f.hi
        if rel == "eq":
            if lo == hi == bound:
                return True
            if bound < lo or bound > hi or bound in f.ne:
                return False
        elif rel == "ne":
            if bound < lo or bound > hi or bound in f.ne:
                return True
            if lo == hi == bound:
                return False
        elif rel == "lt":
            if hi < bound:
                return True
            if lo >= bound:
                return False
        elif rel == "le":
            if hi <= bound:
                return True
            if lo > bound:
                return False
        elif rel == "gt":
            if lo > bound:
                return True
            if hi <= bound:
                return False
        elif rel == "ge":
            if lo >= bound:
                return True
            if hi < bound:
                return False
        return None

    # ------------------------------------------------------------------
    def signature(self) -> frozenset:
        """Hashable content signature (used for block-entry memoization)."""
        return frozenset(self._expr_set)


# ---------------------------------------------------------------------------
# Shuffle-delta solving (Section 5.1)
# ---------------------------------------------------------------------------

def solve_shift(
    src_addr: Term,
    dst_addr: Term,
    lane: Atom,
    elem_bytes: int = 4,
    max_delta: int = 31,
) -> Optional[int]:
    """Find constant N with ``src(lane + N) == dst(lane)``, |N| <= max_delta.

    Closed form on affine addresses: writing ``src = s0 + k*lane + R`` and
    ``dst = d0 + k'*lane + R'``, a solution requires the non-lane parts to
    cancel (R == R'), equal lane strides (k == k'), and
    ``N = (d0 - s0) / k`` integral.  ``k`` must look like a sane element
    stride (non-zero, multiple of the element size) so that lane-adjacency
    in the paper's sense holds.  The fallback covers the remaining cases
    (e.g. strides hidden inside UF atoms) — since terms are affine over
    interned atoms, substituting ``lane -> lane + N`` only shifts the
    constant by ``k*N``, so the historical bounded substitution search is
    equivalent to scanning ``k*N == d0 - s0  (mod 2**w)`` over candidate
    ``N`` once the coefficient maps agree, which is what runs here (same
    answers, no term allocation — this is the detection hot path).
    """
    w = src_addr.width
    if dst_addr.width != w:
        return None
    k_src = to_signed(src_addr.coeffs.get(lane, 0), w)
    k_dst = to_signed(dst_addr.coeffs.get(lane, 0), w)
    if k_src == k_dst and k_src != 0:
        diff = dst_addr.sub(src_addr)  # d0 - s0 if non-lane parts cancel
        if diff.is_const:
            d = to_signed(diff.const, w)
            if d % k_src == 0:
                n = d // k_src
                if -max_delta <= n <= max_delta:
                    return n
            return None
    # fallback: src(lane+N) == dst  <=>  coeffs equal (incl. the lane
    # stride, possibly zero) and  s0 + k*N == d0 (mod 2**w); N == 0 means
    # plain equality.  Scanned in ascending N exactly like the historical
    # substitution search so tie-breaking is unchanged.
    if src_addr.coeffs != dst_addr.coeffs:
        return None
    mask = (1 << w) - 1
    ks = src_addr.coeffs.get(lane, 0)
    diffc = (dst_addr.const - src_addr.const) & mask
    for n in range(-max_delta, max_delta + 1):
        if n == 0:
            if diffc == 0:
                return 0
            continue
        if (ks * n - diffc) & mask == 0:
            return n
    return None


def may_alias(addr_a: Term, addr_b: Term) -> bool:
    """Conservative may-alias test used for store invalidation (Sec. 4.3).

    Two affine addresses definitely differ when their difference is a
    non-zero constant; otherwise they may alias.  (The difference is
    constant exactly when the coefficient maps agree, so this compares
    them directly instead of materializing the difference term.)
    """
    if addr_a.width != addr_b.width:
        return True
    if addr_a.coeffs == addr_b.coeffs:
        return addr_a.const == addr_b.const
    return True
