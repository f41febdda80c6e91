"""Mirrors ``src/repro/launch/fleet/queue.py`` (only the module
references differ).

Bounded job queue for the fleet front-end / worker split.

The accept loop enqueues; a worker pool drains.  The queue is the
backpressure point: ``put`` on a full queue raises :class:`QueueFull`
*immediately* (the front-end answers 503 + ``Retry-After``) instead of
buffering unbounded work and converting overload into unbounded tail
latency.  ``take_batch`` gives workers the coalescing window: the
first job is handed over as soon as it exists, then the worker lingers
up to ``window_s`` collecting whatever else arrived so one
``compile_many``-shaped batch absorbs a burst.

Shutdown is a *drain*: ``close()`` refuses new work but workers keep
taking until the queue is empty, then ``take_batch`` returns ``None``
and the worker exits — in-flight clients get their responses.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional


class QueueFull(Exception):
    """Raised by ``put`` when the queue is at capacity (backpressure)."""


class QueueClosed(Exception):
    """Raised by ``put`` after ``close()`` — the server is draining."""


@dataclass
class Job:
    """One unit of queued compile work.

    ``prepared`` is the :class:`repro_torch.core.driver.PreparedSource` to
    execute; ``flight`` is the coalescer entry whose waiters receive
    the outcome; ``deadline`` is an absolute ``time.monotonic`` instant
    after which the job is dead — workers skip expired jobs instead of
    compiling for clients that already got their 504.
    """

    prepared: object
    flight: object
    enqueued_at: float = field(default_factory=time.monotonic)
    deadline: Optional[float] = None

    def expired(self, now: Optional[float] = None) -> bool:
        if self.deadline is None:
            return False
        return (now if now is not None else time.monotonic()) > self.deadline


class JobQueue:
    """Thread-safe bounded FIFO with batch draining and a drain-close.

    Counters (all monotonic, read via :meth:`counters`):

    * ``enqueued`` — jobs accepted
    * ``rejected`` — puts refused at capacity (the 503 count's source)
    * ``expired`` — jobs whose deadline passed while queued (workers
      report them back via :meth:`count_expired`)
    * ``max_depth`` — high-water mark of the queue depth
    """

    def __init__(self, capacity: int = 64) -> None:
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._items: List[Job] = []
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._closed = False
        self._enqueued = 0
        self._rejected = 0
        self._expired = 0
        self._max_depth = 0

    # ------------------------------------------------------------------
    def put(self, job: Job) -> None:
        with self._lock:
            if self._closed:
                raise QueueClosed("queue is draining; server shutting down")
            if len(self._items) >= self.capacity:
                self._rejected += 1
                raise QueueFull(
                    f"queue at capacity ({self.capacity} jobs)")
            self._items.append(job)
            self._enqueued += 1
            if len(self._items) > self._max_depth:
                self._max_depth = len(self._items)
            self._not_empty.notify()

    def take_batch(self, max_items: int = 16,
                   window_s: float = 0.0) -> Optional[List[Job]]:
        """Block for the next job, then gather up to ``max_items``
        within ``window_s``; ``None`` means closed *and* drained.

        The first job is never delayed by the window — ``window_s``
        only bounds how long the worker lingers for company once it
        already holds work.
        """
        with self._not_empty:
            while not self._items:
                if self._closed:
                    return None
                self._not_empty.wait(timeout=0.5)
            batch = [self._items.pop(0)]
            deadline = time.monotonic() + window_s
            while len(batch) < max_items:
                if self._items:
                    batch.append(self._items.pop(0))
                    continue
                remaining = deadline - time.monotonic()
                if remaining <= 0 or self._closed:
                    break
                self._not_empty.wait(timeout=remaining)
                if not self._items:
                    break           # window elapsed (or spurious wake)
            return batch

    # ------------------------------------------------------------------
    def count_expired(self, n: int = 1) -> None:
        with self._lock:
            self._expired += n

    def close(self) -> None:
        """Refuse new work; wake every waiting worker to drain."""
        with self._lock:
            self._closed = True
            self._not_empty.notify_all()

    @property
    def closed(self) -> bool:
        with self._lock:
            return self._closed

    @property
    def depth(self) -> int:
        with self._lock:
            return len(self._items)

    def counters(self) -> Dict[str, int]:
        with self._lock:
            return {
                "depth": len(self._items),
                "capacity": self.capacity,
                "enqueued": self._enqueued,
                "rejected": self._rejected,
                "expired": self._expired,
                "max_depth": self._max_depth,
            }
