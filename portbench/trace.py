"""Spans, marks and the reading of a ``torch.profiler`` trace.

The benchmark wraps the program's call sites from outside (:func:`sites`):
each call of a wrapped function runs inside a ``portbench::<site>``
``record_function`` range and leaves its arguments' shapes in
:class:`Calls`.  A range leaves a device-side annotation spanning the
kernels launched inside it; a kernel belongs to the range whose span holds
its start (one stream).  The SSD's gradient is timed between two marks,
identity autograd Functions on the SSD's outputs and inputs that record a
CUDA event in their backward, so it reads the same whatever computes it.
"""

from __future__ import annotations

import bisect
import contextlib
import importlib
import warnings
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import torch

PREFIX = "portbench::"
#: the program's call sites: name -> (module, attribute)
SITES = {
    "conv1d": ("repro_torch.models.mamba2", "causal_conv1d"),
    "ssd": ("repro_torch.models.mamba2", "ssd"),
    "adamw": ("repro_torch.train.step", "adamw_update"),
}


def traced(fn: Callable[[], None], what: str, attempts: int = 3):
    """The events of a ``torch.profiler`` trace (CPU and CUDA activity) of
    ``fn()``.  A trace that holds no device event at all is taken again,
    up to ``attempts`` traces: the profiler's device tracing has come back
    empty on a card whose kernels ran."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, attempts + 1):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                torch.cuda.synchronize()
                fn()
                torch.cuda.synchronize()
        events = prof.events()
        if any(e.device_type == DeviceType.CUDA for e in events):
            return events
        print(f"[portbench] {what}: trace {attempt} of {attempts} held no device event",
              flush=True)
    raise RuntimeError(f"{what}: {attempts} profiler traces held no device event")


@dataclass
class Mark:
    """One SSD call's backward: an event when dy arrives, one when the
    inputs' gradients are done, and the call's shapes."""
    meta: dict
    start: Optional[torch.cuda.Event] = None
    end: Optional[torch.cuda.Event] = None


class _MarkOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mark, *outs):
        ctx.mark = mark
        ctx.set_materialize_grads(False)      # an unused final state stays None
        return tuple(t.view_as(t) for t in outs)

    @staticmethod
    def backward(ctx, *grads):
        ctx.mark.start = torch.cuda.Event(enable_timing=True)
        ctx.mark.start.record()
        return (None, *grads)


class _MarkIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mark, *ins):
        ctx.mark = mark
        ctx.set_materialize_grads(False)
        return tuple(t.view_as(t) for t in ins)

    @staticmethod
    def backward(ctx, *grads):
        ctx.mark.end = torch.cuda.Event(enable_timing=True)
        ctx.mark.end.record()
        return (None, *grads)


@dataclass
class Calls:
    """What the wrapped call sites saw: each call's shapes by site, and the
    backward marks of the SSD."""
    by_site: Dict[str, List[dict]] = field(default_factory=dict)
    marks: List[Mark] = field(default_factory=list)

    def add(self, site: str, meta: dict) -> None:
        self.by_site.setdefault(site, []).append(meta)


def _dtype(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


def _meta(site: str, args, kwargs) -> dict:
    if site == "conv1d":
        x, w = args[0], args[1]
        return dict(B=x.shape[0], L=x.shape[1], C=x.shape[2], W=w.shape[0], dtype=_dtype(x))
    if site == "ssd":
        xh, Bm, chunk = args[0], args[3], args[5]
        B, L, H, P = xh.shape
        return dict(B=B, L=L, H=H, P=P, N=Bm.shape[-1], chunk=chunk, dtype=_dtype(xh))
    return {}


def _wrap(site: str, fn: Callable, calls: Calls, marks: bool) -> Callable:
    from torch.profiler import record_function

    def wrapper(*args, **kwargs):
        meta = _meta(site, args, kwargs)
        calls.add(site, meta)
        grads = site == "ssd" and marks and torch.is_grad_enabled()
        if grads and any(t.requires_grad for t in args[:5]):
            mark = Mark(meta)
            calls.marks.append(mark)
            ins = _MarkIn.apply(mark, *args[:5])
            with record_function(PREFIX + site):
                y, state = fn(*ins, *args[5:], **kwargs)
            return _MarkOut.apply(mark, y, state)
        with record_function(PREFIX + site):
            return fn(*args, **kwargs)

    return wrapper


@contextlib.contextmanager
def sites(calls: Calls, marks: bool = False):
    """For the duration, every call site of :data:`SITES` wrapped."""
    saved = []
    for site, (mod_name, attr) in SITES.items():
        mod = importlib.import_module(mod_name)
        saved.append((mod, attr, getattr(mod, attr)))
        setattr(mod, attr, _wrap(site, getattr(mod, attr), calls, marks))
    try:
        yield calls
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


# ---------------------------------------------------------------------------
# reading a trace
# ---------------------------------------------------------------------------

def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


class Trace:
    """A trace's device operations (kernels, copies, fills; microseconds),
    the benchmark's device spans by site, and the host's operations.  The
    window runs from the first host or device operation to the end of the
    last device operation; ``busy`` is the union of the device
    operations."""

    def __init__(self, events):
        from torch.autograd import DeviceType

        self.ops: List[Tuple[float, float, str]] = []
        self.spans: Dict[str, List[Tuple[float, float]]] = {}
        host = []
        for e in events:
            a, b = e.time_range.start, e.time_range.end
            if e.device_type == DeviceType.CUDA:
                if e.name.startswith(PREFIX):
                    self.spans.setdefault(e.name[len(PREFIX):], []).append((a, b))
                elif not getattr(e, "is_user_annotation", False):
                    self.ops.append((a, b, e.name))
            elif b > a:
                host.append((a, b, e.name))
        if not self.ops:
            raise RuntimeError("the trace holds no device operation")
        self.ops.sort()
        self.host = sorted(host)
        self.t0 = min(self.host[0][0], self.ops[0][0]) if self.host else self.ops[0][0]
        self.t1 = max(b for _, b, _ in self.ops)
        self.busy = _union([(a, b) for a, b, _ in self.ops])

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy) / 1e6

    def in_site(self, site: str) -> Tuple[int, float]:
        """(operations, device seconds) of the operations that start inside
        the site's spans."""
        spans = _union(self.spans.get(site, []))
        starts = [s for s, _ in spans]
        n, total = 0, 0.0
        for a, b, _ in self.ops:
            i = bisect.bisect_right(starts, a) - 1
            if i >= 0 and a <= spans[i][1]:
                n += 1
                total += b - a
        return n, total / 1e6

    def busy_by_span(self, site: str) -> List[float]:
        """Device seconds of busy time inside each of the site's spans, in
        the order the spans start."""
        out = []
        for a, b in sorted(self.spans.get(site, [])):
            inside = _union([(s, min(e, b)) for s, e, _ in self.ops if a <= s <= b])
            out.append(sum(e - s for s, e in inside) / 1e6)
        return out

    def top_ops(self, k: int = 10) -> List[list]:
        by: Dict[str, float] = {}
        for a, b, name in self.ops:
            by[name] = by.get(name, 0.0) + (b - a) / 1e6
        return [[n, s] for n, s in sorted(by.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10) -> List[list]:
        """The ``k`` longest idle gaps between device operations, each
        named by the innermost host operation running at its middle."""
        gaps = sorted(((b - a, a, b) for (_, a), (b, _) in zip(self.busy, self.busy[1:])),
                      reverse=True)[:k]
        out = []
        for length, a, b in gaps:
            mid = (a + b) / 2
            inner = [(e - s, name) for s, e, name in self.host if s <= mid <= e]
            out.append([min(inner)[1] if inner else "(no host operation)", length / 1e6])
        return out
