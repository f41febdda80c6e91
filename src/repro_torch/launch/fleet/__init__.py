"""Mirrors ``src/repro/launch/fleet/__init__.py`` (only the module
references differ).

Fleet serving subsystem: multi-replica PTX compile serving.

This package turns the single-process :mod:`repro_torch.launch.ptx_service`
into a fleet:

* :class:`FleetServer` — a replica front-end that coalesces identical
  in-flight requests, queues work on a bounded queue drained by a
  worker pool (backpressure: 503 + ``Retry-After`` when full), and
  bounds every job with a wall deadline;
* :class:`CacheTierServer` — the shared network cache tier: a tiny
  stdlib HTTP blob store every replica reads through after its memory
  and disk tiers miss;
* :class:`RemoteCache` — the client side of that tier, slotted into
  :class:`repro_torch.core.passes.cache.CompileCache` as
  memory → disk → remote → compile.

CLI (see ``python -m repro_torch.launch.fleet --help``)::

  # the shared cache tier
  python -m repro_torch.launch.fleet cache-server --port 8790

  # a replica pointed at it
  python -m repro_torch.launch.fleet serve --port 8080 \
      --remote-cache http://127.0.0.1:8790 --cache-dir /tmp/ptx-cache

  # self-contained 2-replica smoke (CI runs this)
  python -m repro_torch.launch.fleet smoke
"""

from .coalesce import Flight, FlightTimeout, RequestCoalescer
from .frontend import FleetServer
from .queue import Job, JobQueue, QueueClosed, QueueFull
from .remote_cache import CacheTierServer, RemoteCache
from .stats import LatencyHistogram

__all__ = [
    "CacheTierServer",
    "FleetServer",
    "Flight",
    "FlightTimeout",
    "Job",
    "JobQueue",
    "LatencyHistogram",
    "QueueClosed",
    "QueueFull",
    "RemoteCache",
    "RequestCoalescer",
]
