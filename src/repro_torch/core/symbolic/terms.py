"""Mirrors ``src/repro/core/symbolic/terms.py`` (only the imports differ).

Concolic bitvector terms in affine normal form.

The paper's emulator (Section 4.1) keeps a symbolic bitvector per PTX
register.  We keep every value in *affine normal form*

    value  =  const  +  sum_i  coeff_i * atom_i      (mod 2**width)

where atoms are interned opaque objects: named symbols (kernel params,
``%tid.x`` ...) and uninterpreted functions (memory loads, loop iterators,
floating-point ops, non-linear integer ops).  Affine normal form makes
equality, difference and the paper's shuffle-delta equation
``A(tid + N) = B(tid)`` decidable in closed form (the role Z3 plays in the
paper) while remaining exact for every address the evaluated benchmarks
produce.

Widths follow the PTX register classes: pred=1, b16/u16/s16=16,
b32/u32/s32/f32=32, b64/u64/s64/f64=64.  Constants are canonicalized
modulo ``2**width``; helpers expose the signed view.
"""

from __future__ import annotations

import itertools
import threading
from typing import Dict, Iterable, Optional, Tuple

_atom_counter = itertools.count()

# guards the Sym/UF intern tables: module compilation fans kernels out
# over threads (repro.core.passes), and a check-then-insert race would
# mint two distinct atoms for one key, silently breaking the
# "same address -> same value" identity that detection relies on.
# Reads stay lock-free (a plain dict.get under the GIL); only the
# insert path takes the lock.
_intern_lock = threading.Lock()

#: common PTX widths, precomputed (``_mask`` stays for odd widths)
_MASKS = {1: 0x1, 8: 0xFF, 16: 0xFFFF, 32: 0xFFFFFFFF,
          64: 0xFFFFFFFFFFFFFFFF}


def _mask(width: int) -> int:
    m = _MASKS.get(width)
    return m if m is not None else (1 << width) - 1


def intern_stats() -> Dict[str, int]:
    """Sizes of the process-wide intern tables (observability gauge)."""
    return {
        "syms": len(Sym._interned),
        "ufs": len(UF._interned),
        "const_terms": len(_CONST_CACHE),
        "atom_terms": len(_ATOM_CACHE),
    }


def to_signed(value: int, width: int) -> int:
    value &= _mask(width)
    if value >= (1 << (width - 1)):
        value -= 1 << width
    return value


class Atom:
    """Interned opaque leaf of a term."""

    __slots__ = ("uid", "__weakref__")

    def __init__(self) -> None:
        self.uid = next(_atom_counter)

    def __lt__(self, other: "Atom") -> bool:
        return self.uid < other.uid

    def sort_key(self) -> int:
        return self.uid


class Sym(Atom):
    """A named runtime unknown (kernel parameter, special register)."""

    __slots__ = ("name", "width")
    _interned: Dict[Tuple[str, int], "Sym"] = {}

    def __new__(cls, name: str, width: int = 32) -> "Sym":
        key = (name, width)
        inst = cls._interned.get(key)
        if inst is None:
            with _intern_lock:
                inst = cls._interned.get(key)
                if inst is None:
                    inst = super().__new__(cls)
                    Atom.__init__(inst)
                    inst.name = name
                    inst.width = width
                    cls._interned[key] = inst
        return inst

    def __init__(self, name: str, width: int = 32) -> None:  # noqa: D401
        pass  # handled in __new__ (interning)

    def __repr__(self) -> str:
        return self.name


class UF(Atom):
    """Uninterpreted function application.

    Used for memory loads (``load(addr, epoch)``), loop iterators
    (``loop(id)``), floating-point ops and non-linear integer ops.  Two
    applications with equal ``fn`` and structurally equal args are the same
    atom (hash-consed), which gives the paper's "same address -> same
    value" treatment of loads for free.
    """

    __slots__ = ("fn", "args", "width")
    _interned: Dict[Tuple, "UF"] = {}

    def __new__(cls, fn: str, args: Tuple["Term", ...], width: int = 32) -> "UF":
        key = (fn, args, width)
        inst = cls._interned.get(key)
        if inst is None:
            with _intern_lock:
                inst = cls._interned.get(key)
                if inst is None:
                    inst = super().__new__(cls)
                    Atom.__init__(inst)
                    inst.fn = fn
                    inst.args = args
                    inst.width = width
                    cls._interned[key] = inst
        return inst

    def __init__(self, fn: str, args: Tuple["Term", ...], width: int = 32) -> None:
        pass

    def __repr__(self) -> str:
        return f"{self.fn}({', '.join(map(repr, self.args))})"


#: hash-cons caches for the two hottest term shapes.  Reads are lock-free
#: dict gets; concurrent inserts may race but produce equal values, so
#: last-write-wins is harmless.
_CONST_CACHE: Dict[Tuple[int, int], "Term"] = {}
_ATOM_CACHE: Dict[Tuple[int, int], "Term"] = {}
_TLS = threading.local()


class Term:
    """Immutable affine combination of atoms, modulo 2**width.

    Terms are value-immutable and their ``coeffs`` dict is never mutated
    after construction, so internal fast paths (:meth:`_make`) share
    coefficient dicts between terms instead of copying, and frequently
    recreated shapes — constants and single-atom terms — are hash-consed
    through lock-free read caches (:data:`_CONST_CACHE`,
    :data:`_ATOM_CACHE`; racing inserts are idempotent because the
    cached values compare equal).
    """

    __slots__ = ("width", "const", "coeffs", "_hash")

    def __init__(self, width: int, const: int, coeffs: Optional[Dict[Atom, int]] = None):
        m = _MASKS.get(width)
        if m is None:
            m = (1 << width) - 1
        self.width = width
        self.const = const & m
        clean: Dict[Atom, int] = {}
        if coeffs:
            for atom, c in coeffs.items():
                c &= m
                if c:
                    clean[atom] = c
        self.coeffs = clean
        self._hash = None

    @classmethod
    def _make(cls, width: int, const: int, coeffs: Dict[Atom, int]) -> "Term":
        """Fast internal constructor: ``const`` already masked, ``coeffs``
        already clean (masked, zero-free) and safe to share, not copy."""
        t = cls.__new__(cls)
        t.width = width
        t.const = const
        t.coeffs = coeffs
        t._hash = None
        return t

    # -- constructors ------------------------------------------------------
    @staticmethod
    def const_(value: int, width: int = 32) -> "Term":
        key = (value, width)
        t = _CONST_CACHE.get(key)
        if t is None:
            t = Term(width, value)
            if -1024 <= value <= 4096:      # bound the hot-constant cache
                _CONST_CACHE[key] = t
        return t

    @staticmethod
    def atom(a: Atom, width: int = 32) -> "Term":
        key = (a.uid, width)
        t = _ATOM_CACHE.get(key)
        if t is None:
            t = Term._make(width, 0, {a: 1})
            _ATOM_CACHE[key] = t
        return t

    @staticmethod
    def sym(name: str, width: int = 32) -> "Term":
        """Named-symbol term, memoized per thread.

        ``%tid.x``/param reads dominate operand decoding, so each thread
        keeps a private front cache: reads never contend with the intern
        lock or other threads' inserts.
        """
        cache = getattr(_TLS, "syms", None)
        if cache is None:
            cache = _TLS.syms = {}
        key = (name, width)
        t = cache.get(key)
        if t is None:
            t = cache[key] = Term.atom(Sym(name, width), width)
        return t

    @staticmethod
    def uf(fn: str, args: Tuple["Term", ...], width: int = 32) -> "Term":
        return Term.atom(UF(fn, args, width), width)

    # -- predicates --------------------------------------------------------
    @property
    def is_const(self) -> bool:
        return not self.coeffs

    @property
    def as_const(self) -> Optional[int]:
        return self.const if not self.coeffs else None

    @property
    def signed_const(self) -> Optional[int]:
        return to_signed(self.const, self.width) if not self.coeffs else None

    def atoms(self) -> Iterable[Atom]:
        return self.coeffs.keys()

    # -- arithmetic --------------------------------------------------------
    def add(self, other: "Term") -> "Term":
        w = self.width
        m = _MASKS.get(w) or ((1 << w) - 1)
        if not other.coeffs:                # x + const: share the coeff map
            if not other.const:
                return self
            return Term._make(w, (self.const + other.const) & m, self.coeffs)
        if not self.coeffs:                 # const + x
            if not self.const:
                return other
            return Term._make(w, (self.const + other.const) & m, other.coeffs)
        coeffs: Dict[Atom, int] = dict(self.coeffs)
        for atom, c in other.coeffs.items():
            nc = (coeffs.get(atom, 0) + c) & m
            if nc:
                coeffs[atom] = nc
            else:
                coeffs.pop(atom, None)
        return Term._make(w, (self.const + other.const) & m, coeffs)

    def neg(self) -> "Term":
        w = self.width
        m = _MASKS.get(w) or ((1 << w) - 1)
        return Term._make(w, -self.const & m,
                          {a: -c & m for a, c in self.coeffs.items()})

    def sub(self, other: "Term") -> "Term":
        w = self.width
        m = _MASKS.get(w) or ((1 << w) - 1)
        if not other.coeffs:                # x - const: share the coeff map
            if not other.const:
                return self
            return Term._make(w, (self.const - other.const) & m, self.coeffs)
        return self.add(other.neg())

    def mul_const(self, k: int) -> "Term":
        if k == 1:
            return self
        w = self.width
        m = _MASKS.get(w) or ((1 << w) - 1)
        if not (k & m):
            return Term.const_(0, w)
        coeffs: Dict[Atom, int] = {}
        for a, c in self.coeffs.items():
            nc = (c * k) & m
            if nc:
                coeffs[a] = nc
        return Term._make(w, (self.const * k) & m, coeffs)

    def mul(self, other: "Term") -> "Term":
        if other.is_const:
            return self.mul_const(other.const)
        if self.is_const:
            return other.mul_const(self.const)
        a, b = _canon_pair(self, other)
        return Term.uf("mul", (a, b), self.width)

    def madd(self, b: "Term", c: "Term") -> "Term":
        return self.mul(b).add(c)

    # -- bitwise / misc (exact when concrete, UF otherwise) -----------------
    def _binop(self, other: "Term", name: str, fn) -> "Term":
        if self.is_const and other.is_const:
            return Term(self.width, fn(self.const, other.const))
        if name in ("and", "or", "xor"):
            a, b = _canon_pair(self, other)
        else:
            a, b = self, other
        return Term.uf(name, (a, b), self.width)

    def and_(self, other: "Term") -> "Term":
        if other.is_const and other.const == _mask(self.width):
            return self
        if self.is_const and self.const == _mask(self.width):
            return other
        if (other.is_const and other.const == 0) or (self.is_const and self.const == 0):
            return Term(self.width, 0)
        return self._binop(other, "and", lambda a, b: a & b)

    def or_(self, other: "Term") -> "Term":
        if other.is_const and other.const == 0:
            return self
        if self.is_const and self.const == 0:
            return other
        return self._binop(other, "or", lambda a, b: a | b)

    def xor_(self, other: "Term") -> "Term":
        return self._binop(other, "xor", lambda a, b: a ^ b)

    def not_(self) -> "Term":
        if self.is_const:
            return Term(self.width, ~self.const)
        return Term.uf("not", (self,), self.width)

    def shl(self, other: "Term") -> "Term":
        if other.is_const:
            return self.mul_const(1 << (other.const & 63))
        return self._binop(other, "shl", lambda a, b: a << (b & 63))

    def shr(self, other: "Term", signed: bool) -> "Term":
        if self.is_const and other.is_const:
            sh = other.const & 63
            v = to_signed(self.const, self.width) if signed else self.const
            return Term(self.width, v >> sh)
        name = "ashr" if signed else "lshr"
        return self._binop(other, name, lambda a, b: a >> (b & 63))

    def div(self, other: "Term", signed: bool) -> "Term":
        if self.is_const and other.is_const and other.const != 0:
            if signed:
                a = to_signed(self.const, self.width)
                b = to_signed(other.const, self.width)
                return Term(self.width, int(a / b))
            return Term(self.width, self.const // other.const)
        return Term.uf("sdiv" if signed else "udiv", (self, other), self.width)

    def rem(self, other: "Term", signed: bool) -> "Term":
        if self.is_const and other.is_const and other.const != 0:
            if signed:
                a = to_signed(self.const, self.width)
                b = to_signed(other.const, self.width)
                return Term(self.width, a - int(a / b) * b)
            return Term(self.width, self.const % other.const)
        return Term.uf("srem" if signed else "urem", (self, other), self.width)

    def min_(self, other: "Term", signed: bool) -> "Term":
        if self.is_const and other.is_const:
            key = (lambda v: to_signed(v, self.width)) if signed else (lambda v: v)
            return Term(self.width, min(self.const, other.const, key=key))
        a, b = _canon_pair(self, other)
        return Term.uf("smin" if signed else "umin", (a, b), self.width)

    def max_(self, other: "Term", signed: bool) -> "Term":
        if self.is_const and other.is_const:
            key = (lambda v: to_signed(v, self.width)) if signed else (lambda v: v)
            return Term(self.width, max(self.const, other.const, key=key))
        a, b = _canon_pair(self, other)
        return Term.uf("smax" if signed else "umax", (a, b), self.width)

    # -- width changes ------------------------------------------------------
    def resize(self, width: int, signed: bool) -> "Term":
        """Width conversion.

        Truncation and extension of affine terms are passed through (the
        paper's Listing 5 note: "Sign extensions are omitted") -- sound for
        the in-range address arithmetic these kernels perform; exact for
        constants.
        """
        if self.is_const:
            v = to_signed(self.const, self.width) if signed else self.const
            return Term.const_(v, width) if v >= 0 else Term(width, v)
        if width >= self.width:
            # widening keeps every masked value valid: share the map
            return Term._make(width, self.const, self.coeffs)
        return Term(width, self.const, self.coeffs)

    # -- substitution (used by bounded delta search) ------------------------
    def subst_atom(self, atom: Atom, repl: "Term") -> "Term":
        if atom not in self.coeffs:
            return self
        coeffs = dict(self.coeffs)
        k = coeffs.pop(atom)
        return Term(self.width, self.const, coeffs).add(repl.mul_const(k))

    # -- equality -----------------------------------------------------------
    def __eq__(self, other: object) -> bool:
        return (
            isinstance(other, Term)
            and self.width == other.width
            and self.const == other.const
            and self.coeffs == other.coeffs
        )

    def __hash__(self) -> int:
        if self._hash is None:
            self._hash = hash(
                (self.width, self.const, frozenset(self.coeffs.items()))
            )
        return self._hash

    def __repr__(self) -> str:
        parts = []
        if self.const or not self.coeffs:
            parts.append(hex(self.const))
        for atom, c in sorted(self.coeffs.items(), key=lambda kv: kv[0].uid):
            parts.append(repr(atom) if c == 1 else f"{hex(c)}*{atom!r}")
        return " + ".join(parts)

    def key(self) -> Tuple:
        """Stable canonical key for the atom-combination (without const)."""
        return (self.width, tuple(sorted(((a.uid, c) for a, c in self.coeffs.items()))))


def _canon_pair(a: Term, b: Term) -> Tuple[Term, Term]:
    """Canonical argument order for commutative UF ops."""
    ka = (a.const, tuple(sorted(x.uid for x in a.coeffs)))
    kb = (b.const, tuple(sorted(x.uid for x in b.coeffs)))
    return (a, b) if ka <= kb else (b, a)


# ---------------------------------------------------------------------------
# Boolean expressions (predicates)
# ---------------------------------------------------------------------------

_SWAP = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le", "eq": "eq", "ne": "ne"}


class BoolExpr:
    __slots__ = ()

    def negate(self) -> "BoolExpr":
        raise NotImplementedError


class BoolConst(BoolExpr):
    __slots__ = ("value",)

    def __init__(self, value: bool) -> None:
        self.value = value

    def negate(self) -> "BoolExpr":
        return BoolConst(not self.value)

    def __eq__(self, other: object) -> bool:
        return isinstance(other, BoolConst) and self.value == other.value

    def __hash__(self) -> int:
        return hash(("bc", self.value))

    def __repr__(self) -> str:
        return "TRUE" if self.value else "FALSE"


TRUE = BoolConst(True)
FALSE = BoolConst(False)

_NEG = {"eq": "ne", "ne": "eq", "lt": "ge", "ge": "lt", "le": "gt", "gt": "le"}


class Cmp(BoolExpr):
    """``lhs REL rhs`` — REL in {eq,ne,lt,le,gt,ge}; ``signed`` selects the
    integer interpretation used for inequalities."""

    __slots__ = ("rel", "lhs", "rhs", "signed")

    def __init__(self, rel: str, lhs: Term, rhs: Term, signed: bool = True) -> None:
        self.rel = rel
        self.lhs = lhs
        self.rhs = rhs
        self.signed = signed

    def negate(self) -> "BoolExpr":
        return Cmp(_NEG[self.rel], self.lhs, self.rhs, self.signed)

    def diff(self) -> Term:
        return self.lhs.sub(self.rhs)

    def eval_const(self) -> Optional[bool]:
        d = self.diff()
        if not d.is_const:
            return None
        v = to_signed(d.const, d.width)
        if not self.signed and self.rel in ("lt", "le", "gt", "ge"):
            # unsigned compare: need actual operand values; only decidable
            # when both sides are const.
            if self.lhs.is_const and self.rhs.is_const:
                a, b = self.lhs.const, self.rhs.const
                return {"lt": a < b, "le": a <= b, "gt": a > b, "ge": a >= b}[self.rel]
            if self.rel in ("eq", "ne"):
                pass
            return None
        return {
            "eq": v == 0,
            "ne": v != 0,
            "lt": v < 0,
            "le": v <= 0,
            "gt": v > 0,
            "ge": v >= 0,
        }[self.rel]

    def __eq__(self, other: object) -> bool:
        return (
            isinstance(other, Cmp)
            and self.rel == other.rel
            and self.signed == other.signed
            and self.lhs == other.lhs
            and self.rhs == other.rhs
        )

    def __hash__(self) -> int:
        return hash(("cmp", self.rel, self.signed, self.lhs, self.rhs))

    def __repr__(self) -> str:
        s = "" if self.signed else "u"
        return f"({self.lhs!r} {s}{self.rel} {self.rhs!r})"


class BoolOp(BoolExpr):
    __slots__ = ("op", "args")

    def __init__(self, op: str, args: Tuple[BoolExpr, ...]) -> None:
        self.op = op
        self.args = args

    def negate(self) -> "BoolExpr":
        if self.op == "not":
            return self.args[0]
        if self.op == "and":
            return BoolOp("or", tuple(a.negate() for a in self.args))
        if self.op == "or":
            return BoolOp("and", tuple(a.negate() for a in self.args))
        return BoolOp("not", (self,))

    def __eq__(self, other: object) -> bool:
        return isinstance(other, BoolOp) and self.op == other.op and self.args == other.args

    def __hash__(self) -> int:
        return hash(("bop", self.op, self.args))

    def __repr__(self) -> str:
        return f"{self.op}{self.args!r}"


def bool_and(a: BoolExpr, b: BoolExpr) -> BoolExpr:
    if isinstance(a, BoolConst):
        return b if a.value else FALSE
    if isinstance(b, BoolConst):
        return a if b.value else FALSE
    return BoolOp("and", (a, b))


def bool_or(a: BoolExpr, b: BoolExpr) -> BoolExpr:
    if isinstance(a, BoolConst):
        return TRUE if a.value else b
    if isinstance(b, BoolConst):
        return TRUE if b.value else a
    return BoolOp("or", (a, b))


def bool_not(a: BoolExpr) -> BoolExpr:
    return a.negate()


def bool_xor(a: BoolExpr, b: BoolExpr) -> BoolExpr:
    if isinstance(a, BoolConst):
        return b.negate() if a.value else b
    if isinstance(b, BoolConst):
        return a.negate() if b.value else a
    return BoolOp("xor", (a, b))
