"""Spans and counters: where the program's time goes, on the profiler's
clock.

A span is on while a ``torch.profiler`` session records
(``torch.autograd._profiler_enabled()``); otherwise :func:`span` and
:func:`unit` return one shared no-op context, so a span costs one call and
a branch.  An open span opens
``torch.profiler.record_function("repro::<name>")``, so its host interval
lies in the profiler's trace beside the device operations (and, on the
card, a device-side range holds the kernels launched inside it), and
leaves a :class:`Span` in a bounded in-memory buffer when it closes.

A unit is one prefill batch or one training step: :func:`unit` opens a
span that starts a unit, and every span opened until it closes carries
its id, on any thread.  The current unit lives in one process-wide slot,
not a thread-local, because autograd runs the backward
(``PlainGrad.backward``, the remat recompute) on a thread of its own.  A
span's parent is the innermost span open on its own thread, or, on a
thread with none open, the innermost span open on the unit's thread.

Counters (:func:`count`) are always on and are called off the hot path
only (kernel builds).  Tallies (:func:`tally`) are always on too and may
sit on the hot path: each adds a value, a number or a 0-dim tensor on the
card, to a running total and a running maximum without waiting for the
card, which is read only when :func:`tallies` is called.  A span's
attribute may likewise be a 0-dim tensor, read when :func:`spans` is
called.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional

import torch
from torch.profiler import record_function

PREFIX = "repro::"
#: finished spans kept, the oldest dropped first: a traced prefill deck of
#: the benchmark (20 batches of 48 blocks) leaves about 3,900 and a
#: training step about 500
MAX_SPANS = 1 << 16

_enabled = torch.autograd._profiler_enabled
_NULL = contextlib.nullcontext()


@dataclass
class Span:
    """A finished span.  ``backward``: autograd was running a backward
    node when it opened (``PlainGrad.backward``, the remat recompute).
    Host times are ``time.perf_counter_ns``."""
    name: str
    id: int
    parent: Optional[int]
    unit: Optional[int]
    backward: bool
    start_ns: int
    end_ns: int = 0
    attrs: Dict[str, object] = field(default_factory=dict)


_buffer: Deque[Span] = deque(maxlen=MAX_SPANS)
_ids = itertools.count(1)
#: the open unit: (its id, the open spans of its thread)
_unit: List[Optional[tuple]] = [None]
_local = threading.local()
_counters: Dict[str, List] = {}
_tallies: Dict[str, List] = {}
_lock = threading.Lock()


def _stack() -> List[Span]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _attr(value):
    return str(value).replace("torch.", "") if isinstance(value, torch.dtype) else value


class _Open:
    """One span while it is open."""

    def __init__(self, name: str, attrs: dict, starts_unit: bool):
        self.name, self.attrs, self.starts_unit = name, attrs, starts_unit

    def __enter__(self):
        stack, outer = _stack(), _unit[0]
        if stack:
            parent = stack[-1].id
        else:
            parent = outer[1][-1].id if outer and outer[1] else None
        sid = next(_ids)
        if self.starts_unit:
            self.outer = outer
            _unit[0] = outer = (sid, stack)
        self.rf = record_function(PREFIX + self.name)
        self.rf.__enter__()
        self.span = Span(self.name, sid, parent, outer[0] if outer else None,
                         torch._C._current_autograd_node() is not None,
                         time.perf_counter_ns(),
                         attrs={k: _attr(v) for k, v in self.attrs.items()})
        stack.append(self.span)
        return self.span

    def __exit__(self, *exc):
        span = self.span
        span.end_ns = time.perf_counter_ns()
        _stack().pop()
        if self.starts_unit:
            _unit[0] = self.outer
        self.rf.__exit__(*exc)
        _buffer.append(span)
        return False


def span(name: str, **attrs):
    """A context that records the span ``name`` with ``attrs`` (a dtype
    is kept as its name) while the profiler records, and does nothing
    otherwise."""
    if not _enabled():
        return _NULL
    return _Open(name, attrs, False)


def unit(name: str, **attrs):
    """:func:`span`, starting a unit."""
    if not _enabled():
        return _NULL
    return _Open(name, attrs, True)


def recording() -> bool:
    """Whether spans are recorded now (a ``torch.profiler`` session is on):
    an attribute that costs work is computed only then."""
    return _enabled()


def _read(span: Span) -> Span:
    for k, v in span.attrs.items():
        if isinstance(v, torch.Tensor):
            span.attrs[k] = v.item()
    return span


def spans() -> List[Span]:
    """The finished spans in the buffer, in the order they closed; an
    attribute given as a tensor is read (and kept) as its number."""
    return [_read(s) for s in list(_buffer)]


def reset() -> None:
    """Empties the span buffer."""
    _buffer.clear()


def count(name: str, seconds: float = 0.0) -> None:
    """Adds one, and ``seconds``, to the counter ``name``."""
    with _lock:
        c = _counters.setdefault(name, [0, 0.0])
        c[0] += 1
        c[1] += seconds


def counters() -> Dict[str, Dict[str, float]]:
    """Every counter: ``{name: {"count": n, "seconds": s}}``."""
    with _lock:
        return {k: {"count": n, "seconds": s} for k, (n, s) in _counters.items()}


def tally(name: str, value) -> None:
    """Adds one call and ``value`` (an int, or a 0-dim integer tensor on
    any device, which is not read here) to the tally ``name``: its running
    total and its running maximum."""
    with _lock:
        t = _tallies.get(name)
        if t is None:
            _tallies[name] = [1, value, value]
        else:
            t[0] += 1
            t[1] = t[1] + value
            on = next((v.device for v in (value, t[2]) if isinstance(v, torch.Tensor)), None)
            t[2] = max(t[2], value) if on is None else torch.maximum(
                torch.as_tensor(t[2], device=on), torch.as_tensor(value, device=on))


def tallies() -> Dict[str, Dict[str, int]]:
    """Every tally: ``{name: {"count": calls, "total": sum, "max": largest}}``
    (reading a value kept on the card waits for it)."""
    with _lock:
        return {k: {"count": n, "total": int(total), "max": int(top)}
                for k, (n, total, top) in _tallies.items()}


def reset_tallies() -> None:
    """Forgets every tally."""
    with _lock:
        _tallies.clear()
