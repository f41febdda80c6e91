"""Mirrors ``src/repro/core/egraph/rules.py`` (only the imports differ).

Rewrite-rule registry for the equality-saturation middle-end.

A rule is a function ``fn(eg, cid, node) -> iterable of class ids``:
given one e-node in class ``cid`` it yields classes that must be
unioned with ``cid`` (the driver performs the unions and the rebuild).
Rules only *add* equalities — the e-graph grows monotonically and the
saturation driver bounds work with node/iteration budgets, so rules
never need their own termination argument.

The seed set covers the identities the saturator targets: commutativity
and associativity of the bitwise/arithmetic monoids, constant folding,
add/mul identity and zero absorption, ``x*2^k ↔ x<<k`` strength
reduction (both directions — the reverse feeds mad fusion), mad
fusion/unfusion, and unsigned div/rem by powers of two.  All arithmetic
is done modulo ``2**width`` to match the PTX register semantics the
concrete emulator implements; signed variants (``.s`` suffixed ops)
fold through two's-complement views.  Floating-point classes are never
rewritten here — they enter the e-graph as opaque ``op:`` nodes and
only benefit from CSE, so no reassociation can perturb rounding.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Iterator, List, Tuple

from .egraph import EGraph, ENode

RuleFn = Callable[[EGraph, int, ENode], Iterable[int]]


class Rule:
    __slots__ = ("name", "fn")

    def __init__(self, name: str, fn: RuleFn) -> None:
        self.name = name
        self.fn = fn

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"Rule({self.name!r})"


RULE_REGISTRY: Dict[str, Rule] = {}


def register_rule(name: str) -> Callable[[RuleFn], RuleFn]:
    def deco(fn: RuleFn) -> RuleFn:
        if name in RULE_REGISTRY:
            raise ValueError(f"duplicate rule {name!r}")
        RULE_REGISTRY[name] = Rule(name, fn)
        return fn
    return deco


def default_rules() -> Tuple[Rule, ...]:
    """All registered rules, in registration order (deterministic)."""
    return tuple(RULE_REGISTRY.values())


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

_COMMUTATIVE = {"add", "mul", "and", "or", "xor", "mad",
                "min.s", "min.u", "max.s", "max.u"}
_ASSOCIATIVE = {"add", "mul", "and", "or", "xor"}

# ops whose (op, width, const children) can be folded to a const
_FOLDABLE = {"add", "sub", "mul", "mad", "and", "or", "xor", "not", "neg",
             "shl", "shr.s", "shr.u", "min.s", "min.u", "max.s", "max.u",
             "div.s", "div.u", "rem.s", "rem.u"}


def _mask(value: int, width: int) -> int:
    return value & ((1 << width) - 1)


def _signed(value: int, width: int) -> int:
    value = _mask(value, width)
    return value - (1 << width) if value >> (width - 1) else value


def _const_node(eg: EGraph, value: int, width: int) -> int:
    return eg.add(ENode("const", width, (), _mask(value, width)))


def _pow2_exp(value: int) -> int:
    """log2 of a power of two, or -1."""
    if value > 0 and value & (value - 1) == 0:
        return value.bit_length() - 1
    return -1


def _fold(op: str, width: int, args: List[int]) -> int:
    """Evaluate one folded op on masked constants; raises on div-by-0."""
    if op == "add":
        return args[0] + args[1]
    if op == "sub":
        return args[0] - args[1]
    if op == "mul":
        return args[0] * args[1]
    if op == "mad":
        return args[0] * args[1] + args[2]
    if op == "and":
        return args[0] & args[1]
    if op == "or":
        return args[0] | args[1]
    if op == "xor":
        return args[0] ^ args[1]
    if op == "not":
        return ~args[0]
    if op == "neg":
        return -args[0]
    if op == "shl":
        sh = args[1] & (width - 1) if args[1] < width else width
        return args[0] << sh if sh < width else 0
    if op in ("shr.u", "shr.s"):
        base = args[0] if op == "shr.u" else _signed(args[0], width)
        sh = min(args[1], width - 1 if op == "shr.s" else width)
        return base >> sh
    sa, sb = _signed(args[0], width), _signed(args[1], width)
    if op == "min.s":
        return min(sa, sb)
    if op == "max.s":
        return max(sa, sb)
    if op == "min.u":
        return min(args[0], args[1])
    if op == "max.u":
        return max(args[0], args[1])
    if op == "div.u":
        return args[0] // args[1]
    if op == "rem.u":
        return args[0] % args[1]
    if op == "div.s":
        q = abs(sa) // abs(sb)
        return -q if (sa < 0) != (sb < 0) else q
    if op == "rem.s":
        r = abs(sa) % abs(sb)
        return -r if sa < 0 else r
    raise ValueError(op)


# ---------------------------------------------------------------------------
# rules
# ---------------------------------------------------------------------------

@register_rule("commute")
def _commute(eg: EGraph, cid: int, node: ENode) -> Iterator[int]:
    """a op b = b op a (mad commutes its first two operands)."""
    if node.op not in _COMMUTATIVE:
        return
    if node.op == "mad":
        a, b, c = node.children
        if a != b:
            yield eg.add(ENode("mad", node.width, (b, a, c)))
        return
    a, b = node.children
    if a != b:
        yield eg.add(ENode(node.op, node.width, (b, a)))


@register_rule("assoc")
def _assoc(eg: EGraph, cid: int, node: ENode) -> Iterator[int]:
    """(p op q) op b = p op (q op b), rotating right."""
    if node.op not in _ASSOCIATIVE:
        return
    a, b = node.children
    for inner in eg.nodes_of(a):
        if inner.op == node.op and inner.width == node.width:
            p, q = inner.children
            qb = eg.add(ENode(node.op, node.width, (q, b)))
            yield eg.add(ENode(node.op, node.width, (p, qb)))


@register_rule("const-fold")
def _const_fold(eg: EGraph, cid: int, node: ENode) -> Iterator[int]:
    if node.op not in _FOLDABLE:
        return
    args: List[int] = []
    for child in node.children:
        cv = eg.const_of(child)
        if cv is None:
            return
        args.append(cv)
    if node.op in ("div.s", "div.u", "rem.s", "rem.u") \
            and _mask(args[1], node.width) == 0:
        return
    yield _const_node(eg, _fold(node.op, node.width, args), node.width)


@register_rule("identity")
def _identity(eg: EGraph, cid: int, node: ENode) -> Iterator[int]:
    """Unit/absorber laws; yields an existing operand class (or const)."""
    op, w, ch = node.op, node.width, node.children
    cv = [eg.const_of(c) for c in ch]
    if op == "add":
        if cv[0] == 0:
            yield ch[1]
        if cv[1] == 0:
            yield ch[0]
    elif op == "sub":
        if cv[1] == 0:
            yield ch[0]
        if ch[0] == ch[1]:
            yield _const_node(eg, 0, w)
    elif op == "mul":
        if cv[0] == 1:
            yield ch[1]
        if cv[1] == 1:
            yield ch[0]
        if 0 in (cv[0], cv[1]):
            yield _const_node(eg, 0, w)
    elif op == "mad":
        a, b, c = ch
        if cv[0] == 1:
            yield eg.add(ENode("add", w, (b, c)))
        if cv[1] == 1:
            yield eg.add(ENode("add", w, (a, c)))
        if cv[0] == 0 or cv[1] == 0:
            yield c
        if cv[2] == 0:
            yield eg.add(ENode("mul", w, (a, b)))
    elif op in ("and", "or"):
        if ch[0] == ch[1]:
            yield ch[0]
        ones = _mask(-1, w)
        for i in (0, 1):
            if cv[i] == 0:
                yield _const_node(eg, 0, w) if op == "and" else ch[1 - i]
            if cv[i] == ones:
                yield ch[1 - i] if op == "and" else _const_node(eg, ones, w)
    elif op == "xor":
        if ch[0] == ch[1]:
            yield _const_node(eg, 0, w)
        if cv[0] == 0:
            yield ch[1]
        if cv[1] == 0:
            yield ch[0]
    elif op in ("shl", "shr.u", "shr.s"):
        if cv[1] == 0:
            yield ch[0]
    elif op == "neg":
        for inner in eg.nodes_of(ch[0]):
            if inner.op == "neg" and inner.width == w:
                yield inner.children[0]


@register_rule("mul-pow2-shl")
def _mul_pow2(eg: EGraph, cid: int, node: ENode) -> Iterator[int]:
    """x * 2^k = x << k (k > 0; both directions feed other rules)."""
    w = node.width
    if node.op == "mul":
        for i in (0, 1):
            k = _pow2_exp(eg.const_of(node.children[i]) or 0)
            if 0 < k < w:
                yield eg.add(ENode("shl", w,
                                   (node.children[1 - i],
                                    _const_node(eg, k, w))))
    elif node.op == "shl":
        k = eg.const_of(node.children[1])
        if k is not None and 0 < k < w:
            yield eg.add(ENode("mul", w,
                               (node.children[0],
                                _const_node(eg, 1 << k, w))))


@register_rule("div-pow2-shr")
def _div_pow2(eg: EGraph, cid: int, node: ENode) -> Iterator[int]:
    """unsigned x / 2^k = x >> k, x % 2^k = x & (2^k - 1)."""
    if node.op not in ("div.u", "rem.u"):
        return
    w = node.width
    k = _pow2_exp(eg.const_of(node.children[1]) or 0)
    if k < 0:
        return
    if node.op == "div.u":
        yield eg.add(ENode("shr.u", w,
                           (node.children[0], _const_node(eg, k, w))))
    else:
        yield eg.add(ENode("and", w,
                           (node.children[0],
                            _const_node(eg, (1 << k) - 1, w))))


@register_rule("mad-fuse")
def _mad_fuse(eg: EGraph, cid: int, node: ENode) -> Iterator[int]:
    """(x*y) + c = mad(x, y, c) — and the unfused direction."""
    w = node.width
    if node.op == "add":
        a, b = node.children
        for prod_cid, addend in ((a, b), (b, a)):
            for inner in eg.nodes_of(prod_cid):
                if inner.op == "mul" and inner.width == w:
                    x, y = inner.children
                    yield eg.add(ENode("mad", w, (x, y, addend)))
    elif node.op == "mad":
        x, y, c = node.children
        prod = eg.add(ENode("mul", w, (x, y)))
        yield eg.add(ENode("add", w, (prod, c)))
