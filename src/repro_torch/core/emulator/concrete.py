"""Mirrors ``src/repro/core/emulator/concrete.py`` (only the imports differ).

Concrete SIMT warp emulator for the PTX subset.

Substitutes for GPU execution in this environment: runs original and
shuffle-synthesized kernels on concrete inputs with faithful warp
semantics — 32-lane warps, min-PC lockstep scheduling (immediate-
reconvergence approximation), ``activemask``, ``shfl.sync`` with
out-of-range/inactive-lane behavior, incomplete final warps — and
produces per-category event counts that feed the Table-1-calibrated
cycle model (benchmarks E2/E4).
"""

from __future__ import annotations

import math
import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..ptx.ir import (
    Imm,
    Instr,
    Kernel,
    Label,
    LabelRef,
    MemRef,
    Reg,
    TYPE_WIDTH,
)
from .decode import Decoded, K_LABEL, decode_kernel

_F_TYPES = {"f32", "f64"}


def _mask(width: int) -> int:
    return (1 << width) - 1


def _signed(v: int, width: int) -> int:
    v &= _mask(width)
    return v - (1 << width) if v >= (1 << (width - 1)) else v


def f32_bits(x: float) -> int:
    return struct.unpack("<I", struct.pack("<f", float(np.float32(x))))[0]


def bits_f32(b: int) -> float:
    return float(np.float32(struct.unpack("<f", struct.pack("<I", b & 0xFFFFFFFF))[0]))


def f64_bits(x: float) -> int:
    return struct.unpack("<Q", struct.pack("<d", float(x)))[0]


def bits_f64(b: int) -> float:
    return struct.unpack("<d", struct.pack("<Q", b & _mask(64)))[0]


@dataclass
class RunStats:
    """Executed-event counts, whole grid (feed the cycle model)."""

    counts: Dict[str, int] = field(default_factory=dict)

    def bump(self, key: str, n: int = 1) -> None:
        self.counts[key] = self.counts.get(key, 0) + n

    def get(self, key: str) -> int:
        return self.counts.get(key, 0)


class Memory:
    """Flat byte-addressed memory backed by the caller's numpy buffers."""

    BASE_STRIDE = 1 << 32

    def __init__(self) -> None:
        self.buffers: List[Tuple[int, np.ndarray]] = []

    def register(self, arr: np.ndarray) -> int:
        base = (len(self.buffers) + 1) * self.BASE_STRIDE
        raw = arr.view(np.uint8).reshape(-1)
        self.buffers.append((base, raw))
        return base

    def _locate(self, addr: int) -> Tuple[np.ndarray, int]:
        idx = addr // self.BASE_STRIDE - 1
        if idx < 0 or idx >= len(self.buffers):
            raise IndexError(f"wild address {addr:#x}")
        base, raw = self.buffers[idx]
        off = addr - base
        if off < 0 or off >= len(raw):
            raise IndexError(f"OOB address {addr:#x} (buffer {idx}, off {off})")
        return raw, off

    def load(self, addr: int, nbytes: int) -> int:
        raw, off = self._locate(addr)
        return int.from_bytes(raw[off:off + nbytes].tobytes(), "little")

    def store(self, addr: int, nbytes: int, value: int) -> None:
        raw, off = self._locate(addr)
        raw[off:off + nbytes] = np.frombuffer(
            (value & _mask(8 * nbytes)).to_bytes(nbytes, "little"), np.uint8)


@dataclass(eq=False)
class _Thread:
    tid: Tuple[int, int, int]
    ctaid: Tuple[int, int, int]
    regs: Dict[str, int] = field(default_factory=dict)
    preds: Dict[str, bool] = field(default_factory=dict)
    pc: Optional[int] = 0


class ConcreteEmulator:
    def __init__(self, kernel: Kernel, params: Dict[str, Union[np.ndarray, int]],
                 ntid: Tuple[int, int, int] = (32, 1, 1),
                 nctaid: Tuple[int, int, int] = (1, 1, 1)) -> None:
        kernel.renumber()
        self.kernel = kernel
        self.labels = kernel.labels()
        #: shared one-shot micro-op decode (same stream the symbolic
        #: emulator dispatches on); per-thread re-parsing of opcode
        #: strings was the concrete hot loop's dominant cost
        self.ops = decode_kernel(kernel, self.labels)
        self.mem = Memory()
        self.params: Dict[str, int] = {}
        self.param_arrays: Dict[str, np.ndarray] = {}
        for name, _t in kernel.params:
            v = params[name]
            if isinstance(v, np.ndarray):
                self.params[name] = self.mem.register(v)
                self.param_arrays[name] = v
            else:
                self.params[name] = int(v)
        self.ntid = ntid
        self.nctaid = nctaid
        self.stats = RunStats()

    # ------------------------------------------------------------------
    def run(self, blocks: Optional[Sequence[Tuple[int, int, int]]] = None) -> RunStats:
        if blocks is None:
            blocks = [(x, y, z)
                      for z in range(self.nctaid[2])
                      for y in range(self.nctaid[1])
                      for x in range(self.nctaid[0])]
        for ctaid in blocks:
            self._run_block(ctaid)
        return self.stats

    def _run_block(self, ctaid: Tuple[int, int, int]) -> None:
        nx, ny, nz = self.ntid
        threads = [_Thread(tid=(x, y, z), ctaid=ctaid)
                   for z in range(nz) for y in range(ny) for x in range(nx)]
        for w0 in range(0, len(threads), 32):
            self._run_warp(threads[w0:w0 + 32])

    # ------------------------------------------------------------------
    def _run_warp(self, warp: List[_Thread]) -> None:
        ops = self.ops
        fuel = 3_000_000
        while True:
            alive = [t for t in warp if t.pc is not None]
            if not alive:
                return
            fuel -= 1
            if fuel <= 0:
                raise RuntimeError("warp emulation fuel exhausted")
            cur = min(t.pc for t in alive)
            active = [t for t in alive if t.pc == cur]
            d = ops[cur]
            if d.kind == K_LABEL:
                for t in active:
                    t.pc = cur + 1
                continue
            self._exec_warp_instr(d, active, warp)

    # ------------------------------------------------------------------
    def _exec_warp_instr(self, d: Decoded, active: List[_Thread],
                         warp: List[_Thread]) -> None:
        base = d.base
        # resolve per-thread guards
        executing: List[_Thread] = []
        for t in active:
            if d.pred is not None:
                neg, pname = d.pred
                p = t.preds.get(pname, False)
                if neg:
                    p = not p
                if not p:
                    self.stats.bump("pred_off")
                    continue
            executing.append(t)

        if base == "bra":
            target = d.target
            self.stats.bump("branch", len(active))
            for t in active:
                t.pc = target if t in executing else t.pc + 1
            return
        if base in ("ret", "exit"):
            for t in active:
                t.pc = None if t in executing else t.pc + 1
            return

        if base == "activemask":
            m = 0
            for t in executing:
                m |= 1 << (warp.index(t) % 32)
            for t in executing:
                t.regs[d.operands[0].name] = m
            self.stats.bump("alu", len(executing))
        elif base == "shfl":
            self._exec_shfl(d, executing, warp)
        else:
            for t in executing:
                self._exec_thread(d, t)
        for t in active:
            if t.pc is not None:
                t.pc += 1

    # ------------------------------------------------------------------
    def _exec_shfl(self, d: Decoded, executing: List[_Thread],
                   warp: List[_Thread]) -> None:
        mode = d.mode
        ops = d.operands
        # sync forms:   d, a, b, c, mask   |  d|p, a, b, c, mask
        # legacy forms: d, a, b, c         |  d|p, a, b, c
        has_pred = len(ops) == d.plain_ops + 2
        dst = ops[0]
        pd = ops[1] if has_pred else None
        a_i, b_i = (2, 3) if has_pred else (1, 2)
        lane_of = {id(t): warp.index(t) % 32 for t in executing}
        exec_lanes = {lane_of[id(t)]: t for t in executing}
        srcs = {lane_of[id(t)]: self._rd(t, ops[a_i], 32) for t in executing}
        deltas = {lane_of[id(t)]: self._rd(t, ops[b_i], 32) for t in executing}
        self.stats.bump("shfl", len(executing))
        for t in executing:
            lane = lane_of[id(t)]
            b = deltas[lane]
            if mode == "up":
                j = lane - b
                ok = j >= 0
            elif mode == "down":
                j = lane + b
                ok = j <= 31
            elif mode == "bfly":
                j = lane ^ b
                ok = j <= 31
            else:
                j = b & 31
                ok = True
            ok = ok and (j in exec_lanes)
            val = srcs[j] if ok else srcs[lane]
            t.regs[dst.name] = val & _mask(32)
            if pd is not None:
                t.preds[pd.name] = bool(ok)

    # ------------------------------------------------------------------
    def _rd(self, t: _Thread, op, width: int) -> int:
        if isinstance(op, Imm):
            return op.value & _mask(width)
        assert isinstance(op, Reg)
        name = op.name
        if name.startswith("%tid."):
            return t.tid["xyz".index(name[-1])]
        if name.startswith("%ntid."):
            return self.ntid["xyz".index(name[-1])]
        if name.startswith("%ctaid."):
            return t.ctaid["xyz".index(name[-1])]
        if name.startswith("%nctaid."):
            return self.nctaid["xyz".index(name[-1])]
        if name == "%laneid":
            return (t.tid[0] + self.ntid[0] * (t.tid[1] + self.ntid[1] * t.tid[2])) % 32
        if name == "WARP_SZ":
            return 32
        if name in t.preds:
            return int(t.preds[name])
        return t.regs.get(name, 0) & _mask(width)

    def _wr(self, t: _Thread, op, value: int, width: int) -> None:
        t.regs[op.name] = value & _mask(width)

    # ------------------------------------------------------------------
    def _exec_thread(self, d: Decoded, t: _Thread) -> None:
        base = d.base
        tsuf = d.tsuf
        width = d.width
        ops = d.operands

        if base == "ld":
            space = d.space
            ref = ops[1]
            if space == "param":
                self._wr(t, ops[0], self.params[ref.base], width)
                self.stats.bump("alu")
                return
            addr = self._addr(t, ref)
            val = self.mem.load(addr, width // 8)
            self._wr(t, ops[0], val, width)
            self.stats.bump(f"load_{space}")
            if d.pred is not None:
                self.stats.bump("corner_load")
            return
        if base == "st":
            space = d.space
            addr = self._addr(t, ops[0])
            val = self._rd(t, ops[1], width)
            self.mem.store(addr, width // 8, val)
            self.stats.bump(f"store_{space}")
            return
        if base == "mov":
            if tsuf == "pred":
                t.preds[ops[0].name] = bool(self._rd(t, ops[1], 1))
            else:
                src = ops[1]
                if isinstance(src, Reg) and self.kernel.param_type(src.name):
                    self._wr(t, ops[0], self.params[src.name], width)
                else:
                    self._wr(t, ops[0], self._rd(t, src, width), width)
            self.stats.bump("alu")
            return
        if base == "setp":
            self._exec_setp(d, t, tsuf, width)
            return
        if base == "selp":
            p = t.preds.get(ops[3].name, False)
            v = self._rd(t, ops[1] if p else ops[2], width)
            self._wr(t, ops[0], v, width)
            self.stats.bump("alu")
            return
        if base == "cvta":
            self._wr(t, ops[0], self._rd(t, ops[1], width), width)
            self.stats.bump("alu")
            return
        if base == "cvt":
            self._exec_cvt(d, t)
            return
        if tsuf == "pred" and base in ("and", "or", "xor", "not"):
            if base == "not":
                t.preds[ops[0].name] = not t.preds.get(ops[1].name, False)
            else:
                a = t.preds.get(ops[1].name, False)
                b = t.preds.get(ops[2].name, False)
                t.preds[ops[0].name] = {"and": a and b, "or": a or b,
                                        "xor": a != b}[base]
            self.stats.bump("alu")
            return
        if tsuf in _F_TYPES:
            self._exec_float(d, t, base, tsuf, width)
            return
        self._exec_int(d, t, base, tsuf, width)

    # ------------------------------------------------------------------
    def _addr(self, t: _Thread, ref: MemRef) -> int:
        if self.kernel.param_type(ref.base):
            base = self.params[ref.base]
        else:
            base = t.regs.get(ref.base, 0)
        return (base + ref.offset) & _mask(64)

    def _exec_setp(self, d: Decoded, t: _Thread, tsuf, width) -> None:
        cmp_op = d.cmp_op
        ops = d.operands
        a = self._rd(t, ops[1], width)
        b = self._rd(t, ops[2], width)
        self.stats.bump("alu")
        if tsuf in _F_TYPES:
            fa = bits_f32(a) if width == 32 else bits_f64(a)
            fb = bits_f32(b) if width == 32 else bits_f64(b)
            res = {"eq": fa == fb, "ne": fa != fb, "lt": fa < fb,
                   "le": fa <= fb, "gt": fa > fb, "ge": fa >= fb,
                   "neu": not (fa == fb), "ltu": not (fa >= fb),
                   "leu": not (fa > fb), "gtu": not (fa <= fb),
                   "geu": not (fa < fb), "equ": not (fa != fb)}.get(cmp_op, False)
        else:
            signed = tsuf is None or tsuf.startswith("s")
            if cmp_op in ("lo", "ls", "hi", "hs"):
                signed = False
                cmp_op = {"lo": "lt", "ls": "le", "hi": "gt", "hs": "ge"}[cmp_op]
            if not signed or (tsuf and (tsuf.startswith("u") or tsuf.startswith("b"))):
                va, vb = a, b
            else:
                va, vb = _signed(a, width), _signed(b, width)
            res = {"eq": va == vb, "ne": va != vb, "lt": va < vb,
                   "le": va <= vb, "gt": va > vb, "ge": va >= vb}.get(cmp_op, False)
        t.preds[ops[0].name] = bool(res)

    def _exec_cvt(self, d: Decoded, t: _Thread) -> None:
        to_t, from_t = d.to_t, d.from_t
        wv = TYPE_WIDTH[from_t]
        v = self._rd(t, d.operands[1], wv)
        self.stats.bump("alu")
        if from_t in _F_TYPES:
            f = bits_f32(v) if wv == 32 else bits_f64(v)
            if to_t in _F_TYPES:
                out = f32_bits(f) if TYPE_WIDTH[to_t] == 32 else f64_bits(f)
            else:
                out = int(math.trunc(f))
        else:
            val = _signed(v, wv) if from_t.startswith("s") else v
            if to_t in _F_TYPES:
                out = f32_bits(val) if TYPE_WIDTH[to_t] == 32 else f64_bits(val)
            else:
                out = val
        self._wr(t, d.operands[0], out, TYPE_WIDTH[to_t])

    def _exec_float(self, d: Decoded, t: _Thread, base, tsuf, width) -> None:
        unpack = bits_f32 if width == 32 else bits_f64
        pack = f32_bits if width == 32 else f64_bits
        ft = np.float32 if width == 32 else np.float64
        ops = d.operands
        args = [unpack(self._rd(t, o, width)) for o in ops[1:]]
        self.stats.bump("falu")
        if base == "add":
            r = ft(ft(args[0]) + ft(args[1]))
        elif base == "sub":
            r = ft(ft(args[0]) - ft(args[1]))
        elif base == "mul":
            r = ft(ft(args[0]) * ft(args[1]))
        elif base == "div":
            r = ft(ft(args[0]) / ft(args[1])) if args[1] != 0 else ft(math.inf)
        elif base in ("fma", "mad"):
            r = ft(np.fma(ft(args[0]), ft(args[1]), ft(args[2]))) \
                if hasattr(np, "fma") else ft(ft(args[0]) * ft(args[1]) + ft(args[2]))
        elif base == "neg":
            r = ft(-args[0])
        elif base == "abs":
            r = ft(abs(args[0]))
        elif base == "min":
            r = ft(min(args[0], args[1]))
        elif base == "max":
            r = ft(max(args[0], args[1]))
        elif base == "sqrt":
            r = ft(math.sqrt(args[0])) if args[0] >= 0 else ft(math.nan)
        elif base in ("rcp",):
            r = ft(1.0 / args[0]) if args[0] != 0 else ft(math.inf)
        elif base == "rsqrt":
            r = ft(1.0 / math.sqrt(args[0])) if args[0] > 0 else ft(math.inf)
        elif base == "sin":
            r = ft(math.sin(args[0]))
        elif base == "cos":
            r = ft(math.cos(args[0]))
        elif base == "lg2":
            r = ft(math.log2(args[0])) if args[0] > 0 else ft(-math.inf)
        elif base == "ex2":
            r = ft(2.0 ** args[0])
        elif base == "tanh":
            r = ft(math.tanh(args[0]))
        else:
            r = ft(0.0)
        self._wr(t, ops[0], pack(float(r)), width)

    def _exec_int(self, d: Decoded, t: _Thread, base, tsuf, width) -> None:
        # d.signed/wide/hi are decoded only for K_INT ops; this is also
        # the fallback path for ops decode classed differently (e.g.
        # f16 arithmetic), so re-derive the flags there
        if d.signed is not None:
            signed, wide, hi = d.signed, d.wide, d.hi
        else:
            signed = bool(tsuf) and tsuf.startswith("s")
            wide = "wide" in d.parts
            hi = "hi" in d.parts
        ops = d.operands
        self.stats.bump("alu")
        src_w = width
        dst_w = width * 2 if wide else width
        if base in ("neg", "abs", "not", "popc", "clz"):
            a = self._rd(t, ops[1], src_w)
            sa = _signed(a, src_w) if signed else a
            if base == "neg":
                out = -sa
            elif base == "abs":
                out = abs(sa)
            elif base == "not":
                out = ~a
            elif base == "popc":
                out = bin(a).count("1")
            else:
                out = src_w - 1 - a.bit_length() if a else src_w
            self._wr(t, ops[0], out, dst_w)
            return
        a = self._rd(t, ops[1], src_w)
        b = self._rd(t, ops[2], src_w)
        sa = _signed(a, src_w) if signed else a
        sb = _signed(b, src_w) if signed else b
        if base == "add":
            out = sa + sb
        elif base == "sub":
            out = sa - sb
        elif base == "mul":
            prod = sa * sb
            out = (prod >> src_w) if hi else prod
        elif base == "mad":
            c = self._rd(t, ops[3], dst_w)
            sc = _signed(c, dst_w) if signed else c
            prod = sa * sb
            out = ((prod >> src_w) if hi else prod) + sc
        elif base == "div":
            out = int(sa / sb) if sb else 0
        elif base == "rem":
            out = sa - int(sa / sb) * sb if sb else 0
        elif base == "min":
            out = min(sa, sb)
        elif base == "max":
            out = max(sa, sb)
        elif base == "shl":
            out = a << (b & 63)
        elif base == "shr":
            out = (sa if signed else a) >> (b & 63)
        elif base == "and":
            out = a & b
        elif base == "or":
            out = a | b
        elif base == "xor":
            out = a ^ b
        else:
            out = 0
        self._wr(t, ops[0], out, dst_w)


def run_concrete(kernel: Kernel, params: Dict[str, Union[np.ndarray, int]],
                 ntid: Tuple[int, int, int] = (32, 1, 1),
                 nctaid: Tuple[int, int, int] = (1, 1, 1),
                 blocks: Optional[Sequence[Tuple[int, int, int]]] = None) -> RunStats:
    emu = ConcreteEmulator(kernel, params, ntid=ntid, nctaid=nctaid)
    return emu.run(blocks=blocks)
