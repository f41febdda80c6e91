"""Mirrors ``src/repro/core/passes/diskcache.py``; besides the imports,
the port's entries are its own.  The package name participates in the
hashed entry name, so a directory shared with the reference package holds
two disjoint sets of entries, and the reader unpickles only this
package's classes and plain builtin values: an entry that names anything
else (the reference's classes, say) is a miss, and nothing of the
reference package is ever imported.

Disk-backed tier for the compile cache: cross-process amortization.

Symbolic emulation dominates compile cost (the paper's Table 2 reports
seconds-to-minutes per kernel), so one process paying it should pay it
for the whole fleet: replicas sharing a ``cache_dir`` serve each
other's kernels warm from disk with zero re-emulations — the
ccache/sccache shape of a persistent content-addressed compile cache.

Layout (content-addressed, two-level fan-out)::

    <root>/ab/abcdef.../kernel.ptx    printed synthesized kernel
    <root>/ab/abcdef.../report.pkl    pickled KernelReport
    <root>/ab/abcdef.../meta.json     schema version + logical key (debug)
    <root>/tmp/...                    staging for atomic publication

The directory name is ``sha256(package ':' schema_version ':' logical_key)`` where
the logical key is :meth:`CompileCache.key`'s content hash — the
schema version participates in the *hashed* key, so a format bump makes
every stale entry miss cleanly instead of failing to deserialize.

Concurrency model: **no file locks anywhere**.  Writers stage the
entry under ``tmp/`` and publish with a single ``os.rename`` (atomic
on POSIX); concurrent writers of the same key race benignly (same
content — first rename wins, the loser discards its staging dir).
Readers just read; an entry mid-GC or torn (impossible post-rename,
but the miss path is the safety net) deserializes badly and reports a
miss.  GC is size-bounded by mtime: when the tree exceeds
``max_bytes``, oldest entries go first (reads touch the entry mtime,
best-effort, so hot entries survive a scan of cold ones).
"""

from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import os
import pickle
import shutil
import threading
import time
import uuid
from pathlib import Path
from typing import List, Optional, Tuple

from ..ptx.ir import Kernel
from ..ptx.printer import print_kernel

#: bump when the on-disk entry format changes; participates in the
#: hashed key so stale-format entries miss instead of mis-deserializing
#: (v2: KernelReport grew the static-analysis ``findings`` field)
SCHEMA_VERSION = 2

_TMP_DIR = "tmp"

#: the package whose classes an entry may name; part of the hashed name
PACKAGE = "repro_torch"

#: builtins a pickled report may name (values, never callables)
_SAFE_BUILTINS = frozenset({
    "bool", "bytes", "complex", "dict", "float", "frozenset", "int",
    "list", "set", "str", "tuple"})


class _PackageUnpickler(pickle.Unpickler):
    """Resolves only :data:`PACKAGE`'s own classes and plain builtins."""

    def find_class(self, module: str, name: str):
        if module == PACKAGE or module.startswith(PACKAGE + "."):
            return super().find_class(module, name)
        if module == "builtins" and name in _SAFE_BUILTINS:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(f"entry names {module}.{name}")


def loads_report(blob: bytes) -> object:
    """Unpickle a stored report, resolving only :data:`PACKAGE`'s classes
    and plain builtins (anything else raises ``UnpicklingError``).

    Shared by the disk tier and the fleet's network tier."""
    return _PackageUnpickler(io.BytesIO(blob)).load()


def entry_digest(key: str) -> str:
    """Storage name for a :meth:`CompileCache.key` content hash.

    Shared by the disk tier (directory name) and the remote tier (URL
    path): the schema version participates in the *hashed* name, so a
    format bump makes every stale entry miss cleanly in both tiers
    instead of failing to deserialize.
    """
    return hashlib.sha256(
        f"{PACKAGE}:{SCHEMA_VERSION}:{key}".encode()).hexdigest()


class DiskCache:
    """Content-addressed on-disk store of (kernel PTX, pickled report).

    Pure storage: it holds no counters of its own — the owning
    :class:`~repro.core.passes.cache.CompileCache` folds hit/miss/
    eviction accounting into its ``CacheStats`` ``disk_*`` tier.  Safe
    for concurrent use from many threads *and* many processes sharing
    one directory.
    """

    def __init__(self, root: os.PathLike, *,
                 max_bytes: int = 256 * 1024 * 1024) -> None:
        self.root = Path(root)
        self.max_bytes = max_bytes
        # GC is amortized: stores accumulate an approximate tree size
        # (seeded by one scan, advanced by bytes written locally) and
        # only pay the full os.scandir walk once the budget is
        # plausibly exceeded.  Other processes' writes are invisible to
        # the approximation, so the bound is enforced per-writer — each
        # replica's own stores keep the shared tree near max_bytes.
        self._size_lock = threading.Lock()
        self._approx_bytes: Optional[int] = None
        (self.root / _TMP_DIR).mkdir(parents=True, exist_ok=True)

    # ------------------------------------------------------------------
    # key -> path
    # ------------------------------------------------------------------
    def path_for(self, key: str) -> Path:
        """Entry directory for a :meth:`CompileCache.key` content hash."""
        digest = entry_digest(key)
        return self.root / digest[:2] / digest

    # ------------------------------------------------------------------
    # read path (lock-free)
    # ------------------------------------------------------------------
    def load(self, key: str) -> Optional[Tuple[Kernel, object]]:
        """Return the cached ``(kernel, report)`` or ``None`` on miss.

        Anything short of a well-formed entry — absent, mid-GC,
        unparsable PTX, unpicklable or non-dataclass report — is a
        miss, never an exception: a shared cache must degrade to
        recompilation, not take the serving path down.
        """
        entry = self.path_for(key)
        try:
            ptx_text = (entry / "kernel.ptx").read_text()
            report_blob = (entry / "report.pkl").read_bytes()
            from ..ptx.parser import parse
            module = parse(ptx_text)
            if len(module.kernels) != 1:
                return None
            report = loads_report(report_blob)
            if not dataclasses.is_dataclass(report) \
                    or isinstance(report, type):
                return None
        except Exception:  # noqa: BLE001 — any corruption is a miss
            return None
        try:
            os.utime(entry)         # a hit is a touch (GC is by mtime)
        except OSError:
            pass
        return module.kernels[0], report

    # ------------------------------------------------------------------
    # write path (atomic write-then-rename)
    # ------------------------------------------------------------------
    def store(self, key: str, kernel: Kernel, report: object) -> int:
        """Persist one entry; returns the number of entries GC evicted.

        The entry is staged under ``tmp/`` and published with one
        ``os.rename``, so readers never observe a partial entry.  A
        report that is not a dataclass instance is a ``TypeError``
        *here*, at the writer — the same put-time contract the memory
        tier enforces.
        """
        from .cache import _require_dataclass_report
        _require_dataclass_report(report)
        final = self.path_for(key)
        if final.exists():
            return 0                      # no-op put: no write, no GC
        stage = self.root / _TMP_DIR / uuid.uuid4().hex
        stage.mkdir(parents=True)
        wrote = 0
        try:
            (stage / "kernel.ptx").write_text(print_kernel(kernel))
            # store the pristine (cached=False) report; the reader
            # re-stamps cached=True exactly like a memory hit
            (stage / "report.pkl").write_bytes(pickle.dumps(
                dataclasses.replace(report, cached=False)
                if getattr(report, "cached", False) else report,
                protocol=pickle.HIGHEST_PROTOCOL))
            (stage / "meta.json").write_text(json.dumps(
                {"package": PACKAGE, "schema": SCHEMA_VERSION,
                 "key": key}))
            wrote = sum(f.stat().st_size for f in stage.iterdir())
            final.parent.mkdir(parents=True, exist_ok=True)
            os.rename(stage, final)
        except Exception:  # noqa: BLE001
            # a concurrent writer published the same content first
            # (rename onto a non-empty dir), the filesystem is unhappy,
            # or the report refused to serialize (an unpicklable pass
            # product) — a persistence failure must degrade to
            # recompilation, never take the compile itself down
            shutil.rmtree(stage, ignore_errors=True)
            return 0
        with self._size_lock:
            if self._approx_bytes is None:
                self._approx_bytes = sum(
                    size for _, size, _ in self._entries())
            else:
                self._approx_bytes += wrote
            over_budget = self._approx_bytes > self.max_bytes
        return self.gc() if over_budget else 0

    # ------------------------------------------------------------------
    # maintenance
    # ------------------------------------------------------------------
    def _entries(self) -> List[Tuple[float, int, Path]]:
        """(mtime, bytes, path) for every published entry directory."""
        out: List[Tuple[float, int, Path]] = []
        try:
            shards = list(os.scandir(self.root))
        except OSError:
            return out
        for shard in shards:
            if shard.name == _TMP_DIR or not shard.is_dir():
                continue
            try:
                children = list(os.scandir(shard.path))
            except OSError:
                continue
            for entry in children:
                if not entry.is_dir():
                    continue
                size = 0
                try:
                    for f in os.scandir(entry.path):
                        size += f.stat().st_size
                    out.append((entry.stat().st_mtime, size,
                                Path(entry.path)))
                except OSError:
                    continue    # entry vanished mid-scan (concurrent GC)
        return out

    def _sweep_tmp(self, max_age_s: float = 3600.0) -> None:
        """Remove staging dirs orphaned by writers killed mid-store.

        A live stage is seconds old (written then immediately renamed);
        anything older than ``max_age_s`` is an orphan from a crashed
        process and would otherwise grow ``tmp/`` without bound in a
        long-lived fleet directory."""
        cutoff = time.time() - max_age_s
        try:
            stages = list(os.scandir(self.root / _TMP_DIR))
        except OSError:
            return
        for stage in stages:
            try:
                if stage.stat().st_mtime < cutoff:
                    shutil.rmtree(stage.path, ignore_errors=True)
            except OSError:
                continue

    def gc(self) -> int:
        """Evict oldest-mtime entries until the tree fits ``max_bytes``
        (and sweep staging orphans left by crashed writers)."""
        self._sweep_tmp()
        entries = self._entries()
        total = sum(size for _, size, _ in entries)
        evicted = 0
        if total > self.max_bytes:
            for _, size, path in sorted(entries):
                if total <= self.max_bytes:
                    break
                shutil.rmtree(path, ignore_errors=True)
                total -= size
                evicted += 1
        with self._size_lock:
            self._approx_bytes = total    # re-seed from the real scan
        return evicted

    def clear(self) -> None:
        """Remove every entry (the staging dir survives)."""
        for _, _, path in self._entries():
            shutil.rmtree(path, ignore_errors=True)
        with self._size_lock:
            self._approx_bytes = 0

    def __len__(self) -> int:
        return len(self._entries())

    @property
    def approx_bytes(self) -> int:
        """Cheap size estimate (no tree walk until something wrote)."""
        with self._size_lock:
            return self._approx_bytes or 0

    def __repr__(self) -> str:  # pragma: no cover — debugging aid
        return (f"DiskCache({str(self.root)!r}, "
                f"max_bytes={self.max_bytes})")
