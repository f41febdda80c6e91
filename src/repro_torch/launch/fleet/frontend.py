"""Mirrors ``src/repro/launch/fleet/frontend.py`` (only the imports
differ).

The fleet replica front-end: accept loop + bounded queue + workers.

:class:`FleetServer` keeps the whole :class:`~repro_torch.launch.ptx_service.
PtxServiceServer` endpoint surface but splits ``POST /compile`` into an
accept path and a compile path:

1. the handler thread validates, resolves options, and *prepares* the
   source (:meth:`repro_torch.core.driver.Compiler.prepare`) — cheap, and any
   client error is a synchronous 4xx;
2. the request joins the coalescer: an identical request already in
   flight means no new work at all — the handler just blocks on the
   shared flight;
3. otherwise a job goes onto the bounded queue.  A full queue is
   answered **503 + Retry-After** immediately (backpressure, not
   buffering); a drained-for-shutdown queue likewise;
4. the worker pool drains the queue in small batches (the batching
   window), fans each batch out on the compiler session pool, and
   delivers one shared JSON payload to every waiter of each flight —
   K coalesced requests get K byte-identical responses from one
   ``emulate-flows`` run;
5. every job carries an absolute deadline: expired-in-queue jobs are
   skipped by workers, and a handler whose flight outlives the
   deadline answers 504.

``close()`` is a graceful drain: stop accepting, let workers finish
every queued job (in-flight clients get responses), then shut the
compiler session down.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

from repro_torch.launch.ptx_service import (
    DEFAULT_MAX_BODY_BYTES,
    PtxServiceServer,
    _ServiceError,
)

from .coalesce import FlightTimeout, RequestCoalescer
from .queue import Job, JobQueue, QueueClosed, QueueFull
from .stats import LatencyHistogram

#: exception families that are the client's fault (bad PTX / options)
_CLIENT_ERRORS = (ValueError, TypeError, KeyError, SyntaxError)


class FleetServer(PtxServiceServer):
    """One fleet replica: queued, coalescing, deadline-bounded serving.

    Parameters beyond :class:`PtxServiceServer`:

    * ``workers`` — queue-draining threads (defaults to 4)
    * ``queue_capacity`` — bounded queue size; the backpressure point
    * ``batch_window_s`` / ``batch_max`` — how long a worker lingers
      collecting a burst into one batch, and the batch size cap
    * ``deadline_s`` — per-job wall budget from accept to delivery
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0, *,
                 cache_dir: Optional[str] = None,
                 remote_cache: Optional[str] = None,
                 jobs: Optional[int] = None, selection: str = "all",
                 max_body_bytes: int = DEFAULT_MAX_BODY_BYTES,
                 workers: int = 4, queue_capacity: int = 64,
                 batch_window_s: float = 0.005, batch_max: int = 8,
                 deadline_s: float = 120.0,
                 verbose: bool = False) -> None:
        super().__init__(host, port, cache_dir=cache_dir,
                         remote_cache=remote_cache, jobs=jobs,
                         selection=selection,
                         max_body_bytes=max_body_bytes, verbose=verbose)
        if workers < 1:
            raise ValueError(f"workers must be >= 1, got {workers}")
        self.deadline_s = deadline_s
        self.batch_window_s = batch_window_s
        self.batch_max = batch_max
        self.queue = JobQueue(capacity=queue_capacity)
        self.coalescer = RequestCoalescer()
        self.hist_queue_wait = LatencyHistogram()
        self.hist_compile = LatencyHistogram()
        self.hist_total = LatencyHistogram()
        self._workers = [
            threading.Thread(target=self._worker_loop,
                             name=f"fleet-worker-{i}", daemon=True)
            for i in range(workers)]
        for t in self._workers:
            t.start()

    # ------------------------------------------------------------------
    # accept path (handler threads)
    # ------------------------------------------------------------------
    def _retry_after_hint(self) -> int:
        """Seconds a 503'd client should wait: roughly the time for the
        current queue to drain at the observed compile rate."""
        p50 = self.hist_compile.percentile(50) or 1.0
        drain = self.queue.depth * p50 / max(1, len(self._workers))
        return max(1, min(60, int(round(drain))))

    def handle_compile(self, payload: Dict) -> Dict:
        t_start = time.monotonic()
        req = self._request_input(payload)
        if req["bench"] is not None:
            from repro_torch.core.frontend.kernelgen import get_bench
            src = get_bench(req["bench"])
        else:
            src = req["ptx"]
        try:
            prepared = self.compiler.prepare(src, **req["options"])
        except _CLIENT_ERRORS as e:
            raise _ServiceError(400, f"{type(e).__name__}: {e}")
        if not prepared.ns.module.kernels:
            raise _ServiceError(400, "input contained no kernels")

        deadline = t_start + self.deadline_s
        flight, created = self.coalescer.join(prepared.key)
        if created:
            job = Job(prepared=prepared, flight=flight,
                      enqueued_at=t_start, deadline=deadline)
            try:
                self.queue.put(job)
            except (QueueFull, QueueClosed) as e:
                err = _ServiceError(
                    503, f"server overloaded: {e}",
                    headers={"Retry-After": str(self._retry_after_hint())})
                # joiners racing between join() and this failed put()
                # must not block until their deadline on a flight no
                # worker will ever see
                self.coalescer.abandon(flight, err)
                raise self._fresh_error(err)

        try:
            result_payload = flight.wait(
                max(0.0, deadline - time.monotonic()))
        except FlightTimeout:
            raise _ServiceError(
                504, f"deadline of {self.deadline_s:.1f}s exceeded "
                     "(job still queued or compiling)")
        except _ServiceError as e:
            raise self._fresh_error(e)
        except _CLIENT_ERRORS as e:
            raise _ServiceError(400, f"{type(e).__name__}: {e}")
        # anything else propagates -> 500 via the handler's catch-all

        self.hist_total.record(time.monotonic() - t_start)
        with self._stats_lock:
            self._requests += 1
        return result_payload

    @staticmethod
    def _fresh_error(e: _ServiceError) -> _ServiceError:
        """Per-waiter copy: K coalesced handler threads re-raising one
        shared exception object would race on its ``__traceback__``."""
        return _ServiceError(e.status, str(e), dict(e.headers))

    # ------------------------------------------------------------------
    # compile path (worker threads)
    # ------------------------------------------------------------------
    def _worker_loop(self) -> None:
        while True:
            batch = self.queue.take_batch(self.batch_max,
                                          self.batch_window_s)
            if batch is None:
                return                          # closed and drained
            now = time.monotonic()
            live: List[Job] = []
            for job in batch:
                if job.expired(now):
                    # the waiter already got (or will get) its 504;
                    # compiling for nobody just burns the fleet's CPU
                    self.queue.count_expired()
                    self._fail(job, _ServiceError(
                        504, "deadline exceeded while queued"))
                else:
                    self.hist_queue_wait.record(now - job.enqueued_at)
                    live.append(job)
            if not live:
                continue
            # fan the batch out on the compiler session pool; this
            # worker just collects — so one worker holding a burst
            # does not serialize it
            t0 = time.monotonic()
            submitted: List[Tuple[Job, object]] = [
                (job, self.compiler.submit_prepared(job.prepared))
                for job in live]
            for job, fut in submitted:
                try:
                    result = fut.result()
                except Exception as e:  # noqa: BLE001 — per-job fault
                    self._fail(job, e)
                    continue
                self.hist_compile.record(time.monotonic() - t0)
                payload = result.to_json_dict()
                # close the join window *before* resolving: late
                # arrivals start a fresh flight and hit the cache
                self.coalescer.finish(job.flight)
                job.flight.resolve(payload)

    def _fail(self, job: Job, error: BaseException) -> None:
        self.coalescer.finish(job.flight)
        job.flight.fail(error)

    # ------------------------------------------------------------------
    # observability + lifecycle
    # ------------------------------------------------------------------
    def stats_payload(self) -> Dict:
        payload = super().stats_payload()
        payload["fleet"] = {
            "workers": len(self._workers),
            "deadline_s": self.deadline_s,
            "batch_window_s": self.batch_window_s,
            "queue": self.queue.counters(),
            "coalesce": self.coalescer.counters(),
            "latency": {
                "queue_wait": self.hist_queue_wait.to_dict(),
                "compile": self.hist_compile.to_dict(),
                "total": self.hist_total.to_dict(),
            },
        }
        return payload

    def close(self) -> None:
        """Graceful drain: stop accepting, finish queued work, then
        shut the compiler session down."""
        self._shutdown_http()
        self.queue.close()
        for t in self._workers:
            t.join(timeout=60)
        if self._owns_compiler:
            self.compiler.close()
