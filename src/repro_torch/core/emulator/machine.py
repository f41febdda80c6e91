"""Mirrors ``src/repro/core/emulator/machine.py`` (only the imports differ).

The symbolic PTX emulator (paper Section 4).

Each register holds a concolic :class:`~repro.core.symbolic.Term`; predicate
registers hold :class:`BoolExpr`.  Branching duplicates the register
environment; branch predicates are recorded into an
:class:`~repro.core.symbolic.AssumptionSet` which prunes unrealizable paths
(the Z3 role).  Loop iterators are abstracted to uninterpreted functions at
the loop-header entry with their initial value clipped out and re-added
(Section 4.2, induction-variable recognition); flows finish at re-entry to
iterative blocks, at ``ret``/``exit``, or when a block entry repeats an
already-seen register environment (memoization).

Performance architecture:

* the kernel body is decoded **once** into slotted micro-ops
  (:mod:`.decode`); the hot loop dispatches on an integer kind and reads
  precomputed fields instead of re-parsing opcode strings per flow step;
* flow environments (registers, predicates, trace) are **copy-on-write**:
  :meth:`_Flow.fork` is O(1) and a forked flow only pays for the entries
  it actually writes.  Trace *event objects* stay shared across sibling
  flows exactly like the historical shallow ``list(trace)`` copy, so
  in-place ``invalidated`` marking keeps its pre-COW semantics;
* per-flow store epochs replace the O(trace) store scan per load;
* flow ids, loop-UF ids and bool->term ids are **per-emulator** counters,
  so every compile of the same kernel produces identical terms regardless
  of process history;
* relevance-gated pruning (``prune_flows``, on by default) drops forked
  flows whose remaining path can reach neither a memory/shuffle
  instruction (no trace events) **nor a block label** (no block-entry
  memoization, so sibling flows cannot observe the difference through
  ``seen_entries`` either — the reachability proof lives in
  :mod:`repro.core.analysis.reach`); a stub ``FlowResult`` with
  ``terminated="pruned"`` preserves flow counts.

The emulator exposes a :attr:`SymbolicEmulator.counters` dict (steps,
forks, memoization hits, truncations, terms interned) consumed by the
``flows`` analysis and the benchmark snapshot writer.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

from ..ptx.ir import (
    Imm,
    Instr,
    Kernel,
    Label,
    LabelRef,
    MemRef,
    Reg,
    SPECIAL_REGS,
    TYPE_WIDTH,
)
from ..symbolic import (
    AssumptionSet,
    BoolConst,
    BoolExpr,
    Cmp,
    FALSE,
    Sym,
    Term,
    TRUE,
    bool_and,
    bool_not,
    bool_or,
    bool_xor,
)
from ..symbolic.terms import intern_stats
from .decode import (
    CMP_MAP as _CMP_MAP,
    Decoded,
    FLOAT_TYPES as _FLOAT_TYPES,
    INT_TYPES as _INT_TYPES,
    K_ACTIVEMASK,
    K_BARRIER,
    K_BRA,
    K_CVT,
    K_CVTA,
    K_FLOAT,
    K_INT,
    K_LABEL,
    K_LD,
    K_MOV,
    K_OTHER,
    K_PREDLOGIC,
    K_RET,
    K_SELP,
    K_SETP,
    K_SHFL,
    K_ST,
    decode_kernel,
)
from .trace import FlowResult, LoadEvent, StoreEvent

#: default emulation limits (overridable per compile via CompilerOptions)
DEFAULT_MAX_FLOWS = 256
DEFAULT_MAX_STEPS = 200_000


class _CowDict:
    """Copy-on-write string->value map for flow environments.

    ``fork`` marks both sides shared in O(1); the first mutation on
    either side copies the underlying dict.  Reads never copy.
    """

    __slots__ = ("_map", "_shared")

    def __init__(self) -> None:
        self._map: Dict[str, object] = {}
        self._shared = False

    def fork(self) -> "_CowDict":
        other = _CowDict.__new__(_CowDict)
        other._map = self._map
        other._shared = True
        self._shared = True
        return other

    def get(self, key, default=None):
        return self._map.get(key, default)

    def __contains__(self, key) -> bool:
        return key in self._map

    def __getitem__(self, key):
        return self._map[key]

    def __setitem__(self, key, value) -> None:
        if self._shared:
            self._map = dict(self._map)
            self._shared = False
        self._map[key] = value

    def pop(self, key, default=None):
        if key in self._map:
            if self._shared:
                self._map = dict(self._map)
                self._shared = False
            return self._map.pop(key, default)
        return default

    def items(self):
        return self._map.items()

    def __len__(self) -> int:
        return len(self._map)


class _CowList:
    """Copy-on-write event trace.

    Only the list *spine* is copied on append-after-fork; the event
    objects themselves remain shared between sibling flows (the
    historical ``list(trace)`` shallow-copy semantics that store
    invalidation relies on).
    """

    __slots__ = ("_list", "_shared")

    def __init__(self) -> None:
        self._list: List[object] = []
        self._shared = False

    def fork(self) -> "_CowList":
        other = _CowList.__new__(_CowList)
        other._list = self._list
        other._shared = True
        self._shared = True
        return other

    def append(self, event) -> None:
        if self._shared:
            self._list = list(self._list)
            self._shared = False
        self._list.append(event)

    def __len__(self) -> int:
        return len(self._list)

    def __iter__(self):
        return iter(self._list)

    def to_list(self) -> List[object]:
        """The underlying list; safe to hand out because any flow still
        sharing it will copy the spine before its next append."""
        return self._list


class _Flow:
    __slots__ = ("pc", "regs", "preds", "assumptions", "trace", "flow_id",
                 "entered_headers", "store_epochs")

    def __init__(self, pc: int, flow_id: int) -> None:
        self.pc = pc
        self.flow_id = flow_id
        self.regs = _CowDict()
        self.preds = _CowDict()
        self.assumptions = AssumptionSet()
        self.trace = _CowList()
        self.entered_headers: Set[int] = set()
        self.store_epochs: Dict[str, int] = {}

    def fork(self, flow_id: int) -> "_Flow":
        f = _Flow.__new__(_Flow)
        f.pc = self.pc
        f.flow_id = flow_id
        f.regs = self.regs.fork()
        f.preds = self.preds.fork()
        f.assumptions = self.assumptions.copy()
        f.trace = self.trace.fork()
        f.entered_headers = set(self.entered_headers)
        f.store_epochs = dict(self.store_epochs)
        return f


class SymbolicEmulator:
    """Emulates one PTX kernel over symbolic inputs."""

    def __init__(self, kernel: Kernel, max_flows: int = DEFAULT_MAX_FLOWS,
                 max_steps: int = DEFAULT_MAX_STEPS,
                 prune_flows: bool = True,
                 ops: Optional[List[Decoded]] = None) -> None:
        self.kernel = kernel
        self.max_flows = max_flows
        self.max_steps = max_steps
        self.prune_flows = prune_flows
        kernel.renumber()
        self.labels = kernel.labels()
        # ``ops`` lets the pass pipeline share one decode of the kernel
        # between the emulator and the static analyzers (Decoded is
        # never mutated after decode)
        self.ops: List[Decoded] = (ops if ops is not None
                                   else decode_kernel(kernel, self.labels))
        self._analyze_cfg()
        if prune_flows:
            self._analyze_reach()
        # per-emulator id wells (deterministic per compile)
        self._flow_ids = 0
        self._uf_ids = 0x1000
        self._b2i_ids: Dict[BoolExpr, int] = {}
        self.counters: Dict[str, int] = {
            "steps": 0, "forks": 0, "flows": 0, "memo_hits": 0,
            "backedge_exits": 0, "infeasible_flows": 0, "pruned_flows": 0,
            "truncated_steps": 0, "truncated_forks": 0, "terms_interned": 0,
        }

    def _next_flow_id(self) -> int:
        v = self._flow_ids
        self._flow_ids = v + 1
        return v

    def _next_uf_id(self) -> int:
        v = self._uf_ids
        self._uf_ids = v + 1
        return v

    # ------------------------------------------------------------------
    # static pre-analysis: basic blocks, loop headers, loop-written regs
    # ------------------------------------------------------------------
    def _analyze_cfg(self) -> None:
        body = self.kernel.body
        # basic-block ids: a new block starts at every label and after
        # every branch instruction.
        self.block_of: List[int] = []
        block = 0
        for stmt in body:
            if isinstance(stmt, Label):
                block += 1
            self.block_of.append(block)
            if isinstance(stmt, Instr) and stmt.base in ("bra", "ret", "exit"):
                block += 1
        # loop headers: targets of backward branches
        self.loop_written: Dict[int, Set[str]] = {}
        for i, stmt in enumerate(body):
            if isinstance(stmt, Instr) and stmt.base == "bra":
                target = stmt.operands[0]
                if isinstance(target, LabelRef) and target.name in self.labels:
                    t = self.labels[target.name]
                    if t <= i:  # back-edge
                        written = self.loop_written.setdefault(t, set())
                        for j in range(t, i + 1):
                            s = body[j]
                            if isinstance(s, Instr):
                                written.update(self._dsts(s))

    def _analyze_reach(self) -> None:
        """Which pcs can still reach a statement pruning must preserve?

        Delegates to :func:`repro.core.analysis.reach.reach_flags`,
        which seeds memory/shuffle instructions (trace events) *and*
        labels (block-entry memoization points) — a pc reaching neither
        can be dropped without any observable effect, which is what
        makes pruning sound enough to be the default.  Imported lazily:
        the analysis package must stay importable without the emulator
        and vice versa.
        """
        from ..analysis.reach import reach_flags
        self._reach_mem = reach_flags(self.ops)

    @staticmethod
    def _dsts(instr: Instr) -> List[str]:
        base = instr.base
        if base in ("st", "bra", "ret", "exit", "bar", "membar"):
            return []
        out = []
        if instr.operands and isinstance(instr.operands[0], Reg):
            out.append(instr.operands[0].name)
        # dual-destination forms (shfl.sync %d|%p, setp %p|%q)
        if base in ("shfl", "setp") and len(instr.operands) > 1 \
                and isinstance(instr.operands[1], Reg) \
                and instr.operands[1].name.startswith("%") \
                and instr.parts[0] == "shfl":
            out.append(instr.operands[1].name)
        return out

    # ------------------------------------------------------------------
    # operand access
    # ------------------------------------------------------------------
    def _read(self, flow: _Flow, op, width: int) -> Term:
        if isinstance(op, Imm):
            return Term.const_(op.value, width)
        if isinstance(op, Reg):
            name = op.name
            if name in SPECIAL_REGS:
                if name == "WARP_SZ":
                    return Term.const_(32, width)
                return Term.sym(name.lstrip("%"), width)
            t = flow.regs.get(name)
            if t is not None:
                if t.width != width:
                    return t.resize(width, signed=True)
                return t
            p = flow.preds.get(name)
            if p is not None:
                return self._bool_to_term(p, width)
            # parameter referenced directly by name
            ptype = self.kernel.param_type(name)
            if ptype is not None:
                return Term.sym(f"param:{name}", TYPE_WIDTH[ptype]).resize(width, True)
            # read-before-write: give it a stable fresh symbol
            t = Term.sym(f"undef:{name}", width)
            flow.regs[name] = t
            return t
        raise TypeError(f"cannot read operand {op!r}")

    def _read_pred(self, flow: _Flow, name: str) -> BoolExpr:
        expr = flow.preds.get(name)
        if expr is not None:
            return expr
        expr = Cmp("ne", Term.uf("predin", (Term.sym(f"undef:{name}", 32),), 32),
                   Term.const_(0, 32))
        flow.preds[name] = expr
        return expr

    def _bool_to_term(self, expr: BoolExpr, width: int) -> Term:
        if isinstance(expr, BoolConst):
            return Term.const_(1 if expr.value else 0, width)
        bid = self._b2i_ids.get(expr)
        if bid is None:
            bid = self._b2i_ids[expr] = len(self._b2i_ids)
        return Term.uf("b2i", (Term.const_(bid, 32),), width)

    def _write(self, flow: _Flow, op, value: Term) -> None:
        assert isinstance(op, Reg)
        flow.regs[op.name] = value
        flow.preds.pop(op.name, None)

    def _write_pred(self, flow: _Flow, op, expr: BoolExpr) -> None:
        assert isinstance(op, Reg)
        flow.preds[op.name] = expr
        flow.regs.pop(op.name, None)

    # ------------------------------------------------------------------
    # main loop
    # ------------------------------------------------------------------
    def run(self) -> List[FlowResult]:
        interned0 = sum(intern_stats().values())
        ops = self.ops
        n_ops = len(ops)
        counters = self.counters
        init = _Flow(pc=0, flow_id=self._next_flow_id())
        worklist: List[_Flow] = [init]
        results: List[FlowResult] = []
        seen_entries: Set[Tuple[int, frozenset]] = set()
        max_steps = self.max_steps
        steps = 0

        while worklist:
            flow = worklist.pop()
            status = "ret"
            while flow.pc < n_ops:
                steps += 1
                if steps > max_steps:
                    status = "limit"
                    counters["truncated_steps"] += 1
                    break
                d = ops[flow.pc]
                kind = d.kind
                if kind == K_LABEL:
                    uid = d.label_uid
                    if uid in self.loop_written:
                        if uid in flow.entered_headers:
                            status = "backedge"
                            break
                        flow.entered_headers.add(uid)
                        self._abstract_loop(flow, uid)
                    # memoization of block entries (Section 4.2)
                    sig = self._env_signature(flow)
                    key = (uid, sig)
                    if key in seen_entries:
                        status = "memo"
                        break
                    seen_entries.add(key)
                    flow.pc += 1
                    continue

                # predicated execution
                guard: Optional[BoolExpr] = None
                if d.pred is not None:
                    neg, pname = d.pred
                    guard = self._read_pred(flow, pname)
                    if neg:
                        guard = bool_not(guard)
                    implied = flow.assumptions.implied(guard)
                    if implied is False:
                        flow.pc += 1
                        continue
                    if implied is True:
                        guard = None

                if kind == K_BRA:
                    next_flows = self._exec_branch(flow, d, guard)
                    if next_flows is None:      # both paths contradictory
                        status = "pruned"
                        counters["infeasible_flows"] += 1
                        break
                    if len(next_flows) == 2:
                        child = next_flows[1]
                        if self.prune_flows and not self._reach_mem[child.pc]:
                            counters["pruned_flows"] += 1
                            results.append(FlowResult(
                                flow_id=child.flow_id,
                                trace=child.trace.to_list(),
                                assumptions=child.assumptions,
                                terminated="pruned"))
                        elif len(worklist) + len(results) < self.max_flows:
                            worklist.append(child)
                        else:
                            counters["truncated_forks"] += 1
                    flow = next_flows[0]
                    continue
                if kind == K_RET:
                    status = "ret"
                    break

                self._exec(flow, d, guard)
                flow.pc += 1

            results.append(FlowResult(flow_id=flow.flow_id,
                                      trace=flow.trace.to_list(),
                                      assumptions=flow.assumptions,
                                      terminated=status))
            if status == "memo":
                counters["memo_hits"] += 1
            elif status == "backedge":
                counters["backedge_exits"] += 1

        counters["steps"] += steps
        counters["flows"] += len(results)
        counters["terms_interned"] += sum(intern_stats().values()) - interned0
        return results

    # ------------------------------------------------------------------
    def _env_signature(self, flow: _Flow) -> frozenset:
        items = [("r", n, v) for n, v in flow.regs.items()]
        items += [("p", n, e) for n, e in flow.preds.items()]
        return frozenset(items) | flow.assumptions.signature()

    def _abstract_loop(self, flow: _Flow, header_uid: int) -> None:
        """Clip initial values, add unique loop UFs (Section 4.2)."""
        for reg in sorted(self.loop_written.get(header_uid, ())):
            if reg in flow.regs:
                init = flow.regs[reg]
                it = Term.uf("loop", (Term.const_(self._next_uf_id(), 32),),
                             init.width)
                flow.regs[reg] = init.add(it)
            elif reg in flow.preds:
                flow.preds[reg] = Cmp(
                    "ne",
                    Term.uf("loopp", (Term.const_(self._next_uf_id(), 32),), 32),
                    Term.const_(0, 32),
                )

    # ------------------------------------------------------------------
    def _exec_branch(self, flow: _Flow, d: Decoded,
                     guard: Optional[BoolExpr]) -> Optional[List[_Flow]]:
        target = d.target
        if target is None:
            flow.pc += 1
            return [flow]
        if guard is None:
            flow.pc = target
            return [flow]
        # fork: taken (assume guard) and fallthrough (assume !guard)
        taken = flow.fork(self._next_flow_id())
        self.counters["forks"] += 1
        ok_taken = taken.assumptions.add(guard)
        taken.pc = target
        ok_fall = flow.assumptions.add(bool_not(guard))
        flow.pc += 1
        out: List[_Flow] = []
        if ok_taken:
            out.append(taken)
        if ok_fall:
            out.append(flow)
        if not out:
            return None
        return out

    # ------------------------------------------------------------------
    # instruction semantics
    # ------------------------------------------------------------------
    def _exec(self, flow: _Flow, d: Decoded, guard: Optional[BoolExpr]) -> None:
        kind = d.kind
        width = d.width
        operands = d.operands

        if kind == K_LD:
            self._exec_ld(flow, d, guard)
        elif kind == K_ST:
            self._exec_st(flow, d)
        elif kind == K_MOV:
            if d.tsuf == "pred":
                src = operands[1]
                self._write_pred(flow, operands[0],
                                 self._read_pred(flow, src.name)
                                 if isinstance(src, Reg) else TRUE)
            else:
                val = self._read(flow, operands[1], width)
                self._store_result(flow, operands[0], val, guard)
        elif kind == K_SETP:
            self._exec_setp(flow, d)
        elif kind == K_SELP:
            dst, a, b, p = operands
            cond = self._read_pred(flow, p.name)
            implied = flow.assumptions.implied(cond)
            if implied is True:
                val = self._read(flow, a, width)
            elif implied is False:
                val = self._read(flow, b, width)
            else:
                val = Term.uf("ite", (self._bool_to_term(cond, 32),
                                      self._read(flow, a, width),
                                      self._read(flow, b, width)), width)
            self._store_result(flow, dst, val, guard)
        elif kind == K_CVTA:
            val = self._read(flow, operands[1], width)
            self._store_result(flow, operands[0], val, guard)
        elif kind == K_CVT:
            self._exec_cvt(flow, d, guard)
        elif kind == K_PREDLOGIC:
            base = d.base
            if base == "not":
                e = bool_not(self._read_pred(flow, operands[1].name))
            else:
                a = self._read_pred(flow, operands[1].name)
                b = self._read_pred(flow, operands[2].name)
                e = {"and": bool_and, "or": bool_or, "xor": bool_xor}[base](a, b)
            self._write_pred(flow, operands[0], e)
        elif kind == K_FLOAT:
            args = tuple(self._read(flow, o, width) for o in operands[1:])
            if d.commutative and len(args) == 2:
                ka = (args[0].const, tuple(sorted(x.uid for x in args[0].coeffs)))
                kb = (args[1].const, tuple(sorted(x.uid for x in args[1].coeffs)))
                if kb < ka:
                    args = (args[1], args[0])
            val = Term.uf(d.fname, args, width)
            self._store_result(flow, operands[0], val, guard)
        elif kind == K_INT:
            self._exec_int(flow, d, guard)
        elif kind == K_SHFL:
            dst = operands[0]
            rest = operands[1:]
            pred_dst = None
            # sync forms carry a trailing membermask operand; legacy
            # (pre-sm_70) forms do not
            if len(rest) > d.plain_ops:  # %d|%p form parsed into two regs
                pred_dst, rest = rest[0], rest[1:]
            args = tuple(self._read(flow, o, 32) for o in rest[:2])
            val = Term.uf(f"shfl.{d.mode}",
                          args + (Term.const_(self._next_uf_id(), 32),), 32)
            self._store_result(flow, dst, val, guard)
            if pred_dst is not None and isinstance(pred_dst, Reg) \
                    and self.kernel.reg_type(pred_dst.name) == "pred":
                self._write_pred(flow, pred_dst, Cmp(
                    "ne", Term.uf("shflp", (val,), 32), Term.const_(0, 32)))
        elif kind == K_ACTIVEMASK:
            val = Term.uf("activemask", (Term.const_(d.uid, 32),), 32)
            self._store_result(flow, operands[0], val, guard)
        elif kind == K_BARRIER:
            pass
        else:
            # unknown op: opaque result if it has a register destination
            if operands and isinstance(operands[0], Reg):
                args = tuple(self._read(flow, o, width)
                             for o in operands[1:]
                             if isinstance(o, (Reg, Imm)))
                self._store_result(
                    flow, operands[0],
                    Term.uf(d.instr.opcode, args +
                            (Term.const_(self._next_uf_id(), 32),), width),
                    guard)

    # ------------------------------------------------------------------
    def _store_result(self, flow: _Flow, dst, value: Term,
                      guard: Optional[BoolExpr]) -> None:
        if guard is not None and isinstance(dst, Reg):
            old = flow.regs.get(dst.name)
            if old is None:
                old = Term.sym(f"undef:{dst.name}", value.width)
            value = Term.uf("ite", (self._bool_to_term(guard, 32), value,
                                    old.resize(value.width, True)), value.width)
        self._write(flow, dst, value)

    def _mem_addr(self, flow: _Flow, ref: MemRef) -> Term:
        base = ref.base
        ptype = self.kernel.param_type(base)
        if ptype is not None:
            t = Term.sym(f"param:{base}", TYPE_WIDTH[ptype])
        else:
            t = self._read(flow, Reg(base), 64)
        if t.width != 64:
            t = t.resize(64, signed=False)
        if ref.offset == 0:
            return t
        return t.add(Term.const_(ref.offset, 64))

    def _exec_ld(self, flow: _Flow, d: Decoded,
                 guard: Optional[BoolExpr]) -> None:
        space = d.space
        nc = d.nc
        width = d.width
        dst, ref = d.operands[0], d.operands[1]
        assert isinstance(ref, MemRef)
        if space == "param":
            val = Term.sym(f"param:{ref.base}", width)
            self._store_result(flow, dst, val, guard)
            return
        addr = self._mem_addr(flow, ref)
        # load value: UF over (address, store-epoch) for non-.nc loads
        if nc:
            args = (addr,)
        else:
            epoch = flow.store_epochs.get(space, 0)
            args = (addr, Term.const_(epoch, 32))
        val = Term.uf(f"load.{space}.{d.tsuf}", args, width)
        event = LoadEvent(
            stmt_uid=d.uid, space=space, nc=nc, addr=addr, width=width,
            value=val, block=self.block_of[d.uid], order=len(flow.trace),
            guarded=guard is not None,
        )
        flow.trace.append(event)
        self._store_result(flow, dst, val, guard)

    def _exec_st(self, flow: _Flow, d: Decoded) -> None:
        space = d.space
        ref, src = d.operands[0], d.operands[1]
        assert isinstance(ref, MemRef)
        addr = self._mem_addr(flow, ref)
        val = self._read(flow, src, d.width)
        from ..symbolic.solver import may_alias
        for e in flow.trace:
            if isinstance(e, LoadEvent) and e.space == space and not e.nc \
                    and may_alias(addr, e.addr):
                e.invalidated = True
        flow.trace.append(StoreEvent(
            stmt_uid=d.uid, space=space, addr=addr, width=d.width,
            value=val, block=self.block_of[d.uid], order=len(flow.trace)))
        flow.store_epochs[space] = flow.store_epochs.get(space, 0) + 1

    def _exec_setp(self, flow: _Flow, d: Decoded) -> None:
        width = d.width
        operands = d.operands
        if not d.float_cmp:
            a = self._read(flow, operands[1], width)
            b = self._read(flow, operands[2], width)
            expr: BoolExpr = Cmp(d.rel, a, b, signed=d.cmp_signed)
        else:
            # float compare: opaque (NaN-sound) — UF per comparison
            a = self._read(flow, operands[1], width)
            b = self._read(flow, operands[2], width)
            t = Term.uf(f"fcmp.{d.cmp_op}.{d.tsuf}", (a, b), 32)
            expr = Cmp("ne", t, Term.const_(0, 32))
        cv = expr.eval_const() if isinstance(expr, Cmp) else None
        if cv is not None:
            expr = TRUE if cv else FALSE
        self._write_pred(flow, operands[0], expr)

    def _exec_cvt(self, flow: _Flow, d: Decoded, guard) -> None:
        to_t, from_t = d.to_t, d.from_t
        src = self._read(flow, d.operands[1], TYPE_WIDTH[from_t])
        if to_t in _FLOAT_TYPES or from_t in _FLOAT_TYPES:
            val = Term.uf(f"cvt.{to_t}.{from_t}", (src,), TYPE_WIDTH[to_t])
        else:
            val = src.resize(TYPE_WIDTH[to_t], signed=from_t.startswith("s"))
        self._store_result(flow, d.operands[0], val, guard)

    def _exec_int(self, flow: _Flow, d: Decoded, guard) -> None:
        base = d.base
        signed = d.signed
        ops = d.operands
        width = d.width
        if d.unary:
            a = self._read(flow, ops[1], width)
            if base == "neg":
                val = a.neg()
            elif base == "not":
                val = a.not_()
            elif base == "abs":
                if a.signed_const is not None:
                    val = Term.const_(abs(a.signed_const), width)
                else:
                    val = Term.uf("abs", (a,), width)
            else:
                val = Term.uf(base, (a,), width)
            self._store_result(flow, ops[0], val, guard)
            return
        # ``.wide`` ops: the type suffix names the *source* type; the
        # destination is twice as wide (e.g. mul.wide.s32 -> 64-bit dst).
        src_width = width
        if d.wide:
            width = width * 2
        a = self._read(flow, ops[1], src_width)
        b = self._read(flow, ops[2], src_width)
        if d.wide:
            a = a.resize(width, signed)
            b = b.resize(width, signed)
        if base == "add":
            val = a.add(b)
        elif base == "sub":
            val = a.sub(b)
        elif base == "mul":
            if d.hi:
                val = Term.uf("mulhi", (a, b), width)
            else:
                val = a.mul(b)
        elif base == "mad":
            c = self._read(flow, ops[3], width)
            val = a.mul(b).add(c)
        elif base == "div":
            val = a.div(b, signed)
        elif base == "rem":
            val = a.rem(b, signed)
        elif base == "min":
            val = a.min_(b, signed)
        elif base == "max":
            val = a.max_(b, signed)
        elif base == "shl":
            val = a.shl(b)
        elif base == "shr":
            val = a.shr(b, signed)
        elif base == "and":
            val = a.and_(b)
        elif base == "or":
            val = a.or_(b)
        elif base == "xor":
            val = a.xor_(b)
        else:
            val = Term.uf(base, (a, b), width)
        self._store_result(flow, ops[0], val, guard)


def emulate(kernel: Kernel, counters: Optional[Dict[str, int]] = None,
            **kw) -> List[FlowResult]:
    """One-shot emulation.  When ``counters`` is given, the emulator's
    phase counters are merged into it (the ``flows`` analysis passes the
    context's product dict here)."""
    emu = SymbolicEmulator(kernel, **kw)
    flows = emu.run()
    if counters is not None:
        for key, value in emu.counters.items():
            counters[key] = counters.get(key, 0) + value
    return flows
