"""Mirrors ``src/repro/core/passes/cache.py`` (only the imports differ).

Content-addressed result cache for the middle-end.

Key = SHA-256 over (printed kernel PTX text, pipeline config token,
pass list).  Value = (synthesized kernel, report).  Eviction is true
LRU: hits move the entry to the most-recently-used end, so hot kernels
(the serving path recompiling one module) survive a scan of cold ones.
Kernels are deep-copied on both put and get so neither the pipeline nor
its callers can mutate a cached entry; reports are returned with
``cached=True``.

The cache is what lets the serving / benchmark paths compile the same
module repeatedly without re-running symbolic emulation (the dominant
cost — the paper's Table 2 reports seconds-to-minutes per kernel).
With a :class:`~repro.core.passes.diskcache.DiskCache` attached
(``CompileCache(disk=...)``, or ``Compiler(cache_dir=...)`` /
``REPRO_CACHE_DIR`` at the driver level) lookups tier memory → disk →
compile, disk hits are promoted into memory, and *separate processes*
sharing one directory amortize emulation across the fleet.  A network
tier (``CompileCache(remote=...)``, speaking the same schema-versioned
wire form — see :mod:`repro_torch.launch.fleet.remote_cache`) slots in below
disk, so replicas without a shared filesystem amortize it too:
memory → disk → remote → compile.
"""

from __future__ import annotations

import copy
import dataclasses
import hashlib
import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple, TYPE_CHECKING

from ..ptx.ir import Kernel
from .context import PipelineConfig

if TYPE_CHECKING:  # pragma: no cover — import cycle guard only
    from .diskcache import DiskCache


@dataclass
class CacheStats:
    """Tiered counters: memory (``hits``/``misses``/``evictions``),
    the disk tier underneath it (``disk_*``), and the network tier
    underneath that (``remote_*``).

    Invariants: every lookup increments exactly one of ``hits`` /
    ``misses`` (so ``hits + misses == lookups``); with a disk tier
    attached, every memory miss then increments exactly one of
    ``disk_hits`` / ``disk_misses``; ``disk_evictions`` counts entries
    GC removed from disk.  With a remote tier attached, every miss
    that fell through the tiers above it increments exactly one of
    ``remote_hits`` / ``remote_misses`` (a remote transport failure
    counts as a miss — the serving path degrades to recompilation).

    Mutation happens under the owning :class:`CompileCache`'s lock.
    Reads (``hit_rate`` / ``summary`` / ``snapshot`` / ``to_dict``) go
    through :meth:`snapshot`, which takes that same lock when the stats
    object is cache-owned — a multi-field read never tears against a
    concurrent increment or :meth:`reset`.
    """

    hits: int = 0
    misses: int = 0
    evictions: int = 0
    disk_hits: int = 0
    disk_misses: int = 0
    disk_evictions: int = 0
    remote_hits: int = 0
    remote_misses: int = 0

    # injected by the owning CompileCache (shared with its entry lock);
    # deliberately *not* a dataclass field: snapshots and
    # dataclasses.replace copies are plain unlocked value objects
    _lock = None

    def snapshot(self) -> "CacheStats":
        """A consistent point-in-time copy (plain, lock-free object)."""
        lock = self._lock
        if lock is None:
            return CacheStats(self.hits, self.misses, self.evictions,
                              self.disk_hits, self.disk_misses,
                              self.disk_evictions, self.remote_hits,
                              self.remote_misses)
        with lock:
            return CacheStats(self.hits, self.misses, self.evictions,
                              self.disk_hits, self.disk_misses,
                              self.disk_evictions, self.remote_hits,
                              self.remote_misses)

    @property
    def hit_rate(self) -> float:
        s = self.snapshot() if self._lock is not None else self
        total = s.hits + s.misses
        return s.hits / total if total else 0.0

    @property
    def disk_hit_rate(self) -> float:
        """Hit rate of the disk tier over the lookups that reached it."""
        s = self.snapshot() if self._lock is not None else self
        total = s.disk_hits + s.disk_misses
        return s.disk_hits / total if total else 0.0

    @property
    def remote_hit_rate(self) -> float:
        """Hit rate of the remote tier over the lookups that reached it."""
        s = self.snapshot() if self._lock is not None else self
        total = s.remote_hits + s.remote_misses
        return s.remote_hits / total if total else 0.0

    @property
    def summary(self) -> str:
        s = self.snapshot() if self._lock is not None else self
        base = (f"hits {s.hits} misses {s.misses} "
                f"hit-rate {s.hit_rate:.1%} evictions {s.evictions}")
        if s.disk_hits or s.disk_misses or s.disk_evictions:
            base += (f" | disk hits {s.disk_hits} misses {s.disk_misses} "
                     f"hit-rate {s.disk_hit_rate:.1%} "
                     f"evictions {s.disk_evictions}")
        if s.remote_hits or s.remote_misses:
            base += (f" | remote hits {s.remote_hits} "
                     f"misses {s.remote_misses} "
                     f"hit-rate {s.remote_hit_rate:.1%}")
        return base

    def to_dict(self) -> Dict[str, float]:
        """JSON-ready counters (the `/stats` endpoint payload shape)."""
        s = self.snapshot()
        return {"hits": s.hits, "misses": s.misses,
                "evictions": s.evictions, "hit_rate": s.hit_rate,
                "disk_hits": s.disk_hits, "disk_misses": s.disk_misses,
                "disk_evictions": s.disk_evictions,
                "disk_hit_rate": s.disk_hit_rate,
                "remote_hits": s.remote_hits,
                "remote_misses": s.remote_misses,
                "remote_hit_rate": s.remote_hit_rate}

    def reset(self) -> None:
        """Zero the counters *in place* — callers holding a reference
        (hit-rate reporting across a clear) observe the reset instead of
        silently reading a dead object.  Called under the owning cache's
        lock (``CompileCache.clear``), never takes ``_lock`` itself."""
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.disk_hits = 0
        self.disk_misses = 0
        self.disk_evictions = 0
        self.remote_hits = 0
        self.remote_misses = 0


def _require_dataclass_report(report: object) -> None:
    """Hits are re-stamped via ``dataclasses.replace(report,
    cached=True)``; a non-dataclass report would make that *read* blow
    up long after the writer is gone, so the writer fails instead."""
    if not dataclasses.is_dataclass(report) or isinstance(report, type):
        raise TypeError(
            "cache reports must be dataclass instances (hits are "
            "re-stamped with dataclasses.replace(report, cached=True)); "
            f"got {type(report).__name__}")


class CompileCache:
    """Thread-safe LRU-bounded map: content hash -> (kernel, report).

    With ``disk=`` a :class:`~repro.core.passes.diskcache.DiskCache`
    becomes the second tier: ``get`` falls through memory → disk and
    promotes disk hits into memory; ``put`` writes through to both.
    With ``remote=`` a network tier (any object with the DiskCache
    ``load``/``store`` signature, e.g.
    :class:`repro_torch.launch.fleet.RemoteCache`) slots in *below* disk:
    lookups tier memory → disk → remote → compile, remote hits are
    promoted into both local tiers, and puts write through to all
    three — replicas without a shared filesystem still amortize
    symbolic emulation through the shared cache server.  ``clear``
    empties only the memory tier — the disk and remote tiers are
    shared across processes and are cleared explicitly
    (``cache.disk.clear()`` / the cache server's lifetime).
    """

    def __init__(self, max_entries: int = 4096,
                 disk: Optional["DiskCache"] = None,
                 remote: Optional[object] = None) -> None:
        self.max_entries = max_entries
        self._entries: "OrderedDict[str, Tuple[Kernel, object]]" = OrderedDict()
        self._lock = threading.Lock()
        self._disk = disk
        self._remote = remote
        self.stats = CacheStats()
        self.stats._lock = self._lock   # reads snapshot under our lock

    @property
    def disk(self) -> Optional["DiskCache"]:
        return self._disk

    @property
    def remote(self) -> Optional[object]:
        return self._remote

    @staticmethod
    def key(ptx_text: str, config: PipelineConfig,
            pass_names: Sequence[str]) -> str:
        payload = repr((ptx_text, config.cache_token(),
                        tuple(pass_names))).encode()
        return hashlib.sha256(payload).hexdigest()

    def get(self, key: str) -> Optional[Tuple[Kernel, object]]:
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                self.stats.hits += 1
                self._entries.move_to_end(key)     # LRU: a hit is a touch
                kernel, report = entry
                # copy the report too: its pass_times dict and detection
                # object are mutable, and a shared reference would let
                # one caller poison every later hit
                return (copy.deepcopy(kernel),
                        dataclasses.replace(copy.deepcopy(report),
                                            cached=True))
            self.stats.misses += 1
            disk = self._disk
            remote = self._remote
        if disk is not None:
            loaded = disk.load(key)       # file I/O outside the entry lock
            with self._lock:
                if loaded is None:
                    self.stats.disk_misses += 1
                else:
                    self.stats.disk_hits += 1
                    kernel, report = loaded
                    # promote: freshly deserialized objects, so no
                    # defensive copy is needed on insert (a racing
                    # promote of the same key rewrites identical
                    # content — last write wins)
                    self._insert_locked(key, kernel, report)
                    return (copy.deepcopy(kernel),
                            dataclasses.replace(copy.deepcopy(report),
                                                cached=True))
        if remote is None:
            return None
        loaded = remote.load(key)     # network I/O outside the entry lock
        if loaded is None:
            with self._lock:
                self.stats.remote_misses += 1
            return None
        kernel, report = loaded
        with self._lock:
            self.stats.remote_hits += 1
            self._insert_locked(key, kernel, report)
            out = (copy.deepcopy(kernel),
                   dataclasses.replace(copy.deepcopy(report), cached=True))
        if disk is not None:
            # warm the local disk tier too, so the next process on this
            # replica needs neither the network nor a recompile;
            # store() swallows its own failures
            disk.store(key, kernel, report)
        return out

    def _insert_locked(self, key: str, kernel: Kernel,
                       report: object) -> None:
        if key not in self._entries and \
                len(self._entries) >= self.max_entries:
            self._entries.popitem(last=False)   # least-recently used
            self.stats.evictions += 1
        self._entries[key] = (kernel, report)
        self._entries.move_to_end(key)

    def put(self, key: str, kernel: Kernel, report: object) -> None:
        _require_dataclass_report(report)
        with self._lock:
            self._insert_locked(key, copy.deepcopy(kernel),
                                copy.deepcopy(report))
            disk = self._disk
            remote = self._remote
        if disk is not None:
            evicted = disk.store(key, kernel, report)
            if evicted:
                with self._lock:
                    self.stats.disk_evictions += evicted
        if remote is not None:
            # write-through to the fleet tier; the client swallows
            # transport failures (a dead cache server degrades the
            # fleet to local caching, it never fails a compile)
            remote.store(key, kernel, report)

    def clear(self) -> None:
        """Empty the *memory* tier and zero the counters (the shared
        disk tier, if any, is left intact)."""
        with self._lock:
            self._entries.clear()
            # reset, never reassign: self.stats identity is part of the
            # API (benchmarks keep a reference for hit-rate reporting)
            self.stats.reset()

    def __len__(self) -> int:
        # under the lock: len() racing a concurrent put/clear must not
        # observe the OrderedDict mid-mutation
        with self._lock:
            return len(self._entries)


#: process-wide default cache shared by every pipeline invocation
GLOBAL_CACHE = CompileCache()
