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
only (kernel builds).
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


def spans() -> List[Span]:
    """The finished spans in the buffer, in the order they closed."""
    return list(_buffer)


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
