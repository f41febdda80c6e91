"""Mirrors ``src/repro/launch/fleet/coalesce.py`` (only the module
references differ).

Cross-request coalescing: the in-flight join table.

``Compiler.compile_many`` already dedupes *within* one batch; the
coalescer extends that across concurrent HTTP requests.  Requests are
keyed on the :class:`repro_torch.core.driver.PreparedSource` dedup key
(module text, pipeline cache token, pass list): the first request for
a key starts a *flight* and enqueues the compile; every identical
request arriving while that flight is open joins it and blocks on the
same outcome — one ``emulate-flows`` run, K byte-identical responses.

A flight stays joinable until the worker *delivers* (not merely
starts) the compile, so the join window spans the whole queue wait +
compile; requests that arrive after delivery start a new flight and
are served warm by the compile cache instead.
"""

from __future__ import annotations

import threading
from typing import Dict, Hashable, Optional, Tuple


class FlightTimeout(Exception):
    """``Flight.wait`` ran out of deadline before delivery."""


class Flight:
    """One in-flight compile and the requests waiting on it.

    Exactly one of :meth:`resolve` / :meth:`fail` is called, once, by
    the worker (or by the front-end when the enqueue itself fails);
    every waiter's :meth:`wait` then returns the shared payload or
    re-raises the shared error.
    """

    def __init__(self, key: Hashable) -> None:
        self.key = key
        self.n_waiters = 1
        self._done = threading.Event()
        self._payload: Optional[object] = None
        self._error: Optional[BaseException] = None

    def resolve(self, payload: object) -> None:
        self._payload = payload
        self._done.set()

    def fail(self, error: BaseException) -> None:
        self._error = error
        self._done.set()

    def wait(self, timeout: Optional[float] = None) -> object:
        if not self._done.wait(timeout):
            raise FlightTimeout(
                f"compile not delivered within {timeout:.1f}s")
        if self._error is not None:
            raise self._error
        return self._payload


class RequestCoalescer:
    """The join table: key -> open :class:`Flight`.

    Counters: ``flights`` (compiles actually started), ``joined``
    (requests that piggybacked on an open flight — each one is a whole
    compile *not* run), ``abandoned`` (flights failed before reaching a
    worker, e.g. queue-full backpressure).
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._flights: Dict[Hashable, Flight] = {}
        self._n_flights = 0
        self._n_joined = 0
        self._n_abandoned = 0

    def join(self, key: Hashable) -> Tuple[Flight, bool]:
        """Return ``(flight, created)``: join the open flight for
        ``key``, or open a new one (``created=True`` means the caller
        owns enqueueing the compile)."""
        with self._lock:
            flight = self._flights.get(key)
            if flight is not None:
                flight.n_waiters += 1
                self._n_joined += 1
                return flight, False
            flight = Flight(key)
            self._flights[key] = flight
            self._n_flights += 1
            return flight, True

    def finish(self, flight: Flight) -> None:
        """Close the join window for ``flight`` (call *before* resolve/
        fail: a request arriving after delivery must start a fresh
        flight — the compile cache serves it warm — rather than join a
        stale one forever)."""
        with self._lock:
            if self._flights.get(flight.key) is flight:
                del self._flights[flight.key]

    def abandon(self, flight: Flight, error: BaseException) -> None:
        """Enqueue failed: close the window and fail every waiter.

        Waiters that joined between ``join`` and the failed ``put``
        would otherwise block until their deadline on a flight no
        worker will ever deliver.
        """
        with self._lock:
            if self._flights.get(flight.key) is flight:
                del self._flights[flight.key]
            self._n_abandoned += 1
        flight.fail(error)

    def counters(self) -> Dict[str, int]:
        with self._lock:
            return {
                "open": len(self._flights),
                "flights": self._n_flights,
                "joined": self._n_joined,
                "abandoned": self._n_abandoned,
            }
