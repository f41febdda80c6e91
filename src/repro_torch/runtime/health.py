"""Fleet-health runtime: heartbeats, straggler detection, elastic hooks
(a copy of ``src/repro/runtime/health.py``).

On a real multi-pod fleet these hooks integrate with the cluster
manager; here they are fully implemented against process-local state so
the policies are testable:

* ``Heartbeat`` — per-host step watermarks with a wall-clock lease;
  hosts that stop advancing past ``lease_s`` are declared dead.
* ``StragglerDetector`` — per-step host timing; a host slower than
  ``threshold`` x the rolling median for ``patience`` consecutive steps
  is flagged (on a fleet: triggers eviction + elastic restart).
* ``ElasticPlan`` — given the surviving host set, recomputes the mesh
  shape (largest (pods, data, model) grid the survivors fill) and the
  data-pipeline host slices; checkpoints are mesh-shape independent
  (checkpoint/store.py), so restart-with-fewer-pods is a pure re-shard.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Dict, List, Optional, Sequence, Tuple


@dataclasses.dataclass
class HostState:
    step: int = -1
    last_beat: float = 0.0
    slow_streak: int = 0


class Heartbeat:
    def __init__(self, hosts: Sequence[str], lease_s: float = 60.0):
        self.lease_s = lease_s
        self.hosts: Dict[str, HostState] = {h: HostState() for h in hosts}

    def beat(self, host: str, step: int, now: Optional[float] = None) -> None:
        st = self.hosts[host]
        st.step = max(st.step, step)
        st.last_beat = time.monotonic() if now is None else now

    def dead_hosts(self, now: Optional[float] = None) -> List[str]:
        now = time.monotonic() if now is None else now
        return [h for h, st in self.hosts.items()
                if st.last_beat and now - st.last_beat > self.lease_s]

    def watermark(self) -> int:
        """Lowest completed step across live hosts (safe checkpoint step)."""
        return min((st.step for st in self.hosts.values()), default=-1)


class StragglerDetector:
    def __init__(self, threshold: float = 1.5, patience: int = 3):
        self.threshold = threshold
        self.patience = patience
        self.streak: Dict[str, int] = {}

    def observe_step(self, timings: Dict[str, float]) -> List[str]:
        """timings: host -> seconds for this step.  Returns flagged hosts."""
        if len(timings) < 2:
            return []
        med = statistics.median(timings.values())
        flagged = []
        for host, t in timings.items():
            if t > self.threshold * med:
                self.streak[host] = self.streak.get(host, 0) + 1
            else:
                self.streak[host] = 0
            if self.streak.get(host, 0) >= self.patience:
                flagged.append(host)
        return flagged


@dataclasses.dataclass
class ElasticPlan:
    mesh_shape: Tuple[int, ...]
    mesh_axes: Tuple[str, ...]
    host_slices: Dict[str, Tuple[int, int]]    # host -> (index, count)


def plan_elastic(alive_hosts: Sequence[str], chips_per_host: int = 4,
                 model_axis: int = 16) -> ElasticPlan:
    """Largest (pod=1, data, model) grid the survivors can fill.

    The model axis is held fixed (param shardings depend on it); the
    data axis shrinks to the largest power-of-two the surviving chips
    support; leftover hosts idle until the next resize window.
    """
    hosts = sorted(alive_hosts)
    chips = len(hosts) * chips_per_host
    data = 1
    while data * 2 * model_axis <= chips:
        data *= 2
    used_hosts = (data * model_axis) // chips_per_host
    slices = {h: (i, used_hosts) for i, h in enumerate(hosts[:used_hosts])}
    return ElasticPlan(mesh_shape=(data, model_axis),
                       mesh_axes=("data", "model"),
                       host_slices=slices)
