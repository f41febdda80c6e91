"""One run of one cell: set-up, the measured window, the traced part and
the check of what the window produced.

Everything a cell needs is found by name, so a later cell adds files and
edits none: the cell's entry in ``BENCHMARK.json`` names its
configuration (``configs/<config>.json``) and its traffic mix
(``traffic/<mix>.json``); the mix names its kind, whose generator, window
and check are ``kinds/<kind>.py``; each per-layer metric is read by
``metrics/<metric>.py``; the limits of the cell's check are
``limits/<cell>.json``.

The program under test is ``repro_torch`` (under ``src/``); the benchmark
takes from it the model, the serving and training entries and the
functions it wraps at their call sites.  The reference
(``reference/``) takes nothing of it.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import random
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from . import rooflines, weights
from .trace import Calls, Trace, sites, traced

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: top-level module names no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: the streams a seed's token ids and samples come from
TOKEN_STREAM, WARM_STREAM, SAMPLE_STREAM = 0x70CE_0001, 0x3A53_0002, 0x5A3F_0003


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path) -> ModuleType:
    """The Python file at ``path`` as a module of its own (metric files
    carry dots in their names)."""
    if not path.is_file():
        raise FileNotFoundError(f"no file {path.relative_to(ROOT)}")
    name = f"portbench.{path.parent.name}.{path.stem}"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, path)
        sys.modules[name] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(sys.modules[name])
    return sys.modules[name]


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one of :data:`FORBIDDEN`."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


# ---------------------------------------------------------------------------
# finding a cell's pieces
# ---------------------------------------------------------------------------

@dataclass
class Cell:
    name: str
    chips: int
    config: dict           # configs/<config>.json
    traffic: dict          # traffic/<mix>.json
    limits: dict           # limits/<cell>.json
    end_to_end: List[dict]
    per_layer: List[dict]


def find_cell(name: str, bench_file: Path = ROOT / "BENCHMARK.json") -> Cell:
    bench = read_json(bench_file)
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r}; have {sorted(work)}")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in moved)]
    return Cell(name=name, chips=w["chips"], config=read_json(ROOT / conf["file"]),
                traffic=read_json(HERE / "traffic" / f"{w['traffic']}.json"),
                limits=read_json(HERE / "limits" / f"{name}.json"),
                end_to_end=e2e, per_layer=per_layer)


# ---------------------------------------------------------------------------
# the run's context, handed to the kind
# ---------------------------------------------------------------------------

class Deck:
    """Fixed counts of each value, shuffled by the seed and dealt in turn;
    an empty deck is shuffled again."""

    def __init__(self, counts: Sequence[Sequence[int]], rng: random.Random):
        self.cards = [v for v, n in counts for _ in range(n)]
        self.rng = rng
        self.left: List[int] = []

    def deal(self) -> int:
        if not self.left:
            self.left = list(self.cards)
            self.rng.shuffle(self.left)
        return self.left.pop()

    def values(self) -> List[int]:
        return sorted(set(self.cards))


@dataclass
class Run:
    cell: Cell
    seed: int
    seconds: float
    device: torch.device
    model_cfg: dict         # the configuration's widths (``model``)
    traffic: dict
    port_cfg: object        # repro_torch's ModelConfig of the same widths
    controls: Tuple[str, ...] = ()
    min_units: int = 0
    weights_sum: float = field(default=0.0)

    def generator(self, stream: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed((self.seed ^ stream) % 2**63)

    def rng(self, stream: int) -> random.Random:
        return random.Random(self.seed ^ stream)

    def deck(self) -> Deck:
        return Deck(self.traffic["deck"], self.rng(TOKEN_STREAM))

    def ids(self, gen: torch.Generator, B: int, L: int) -> torch.Tensor:
        """(B, L) token ids uniform over the vocabulary."""
        return torch.randint(0, self.model_cfg["vocab"], (B, L), generator=gen,
                             device=self.device)

    def build(self):
        """The program's model, built bare and given the seed's weights."""
        from repro_torch.models.lm import build_model

        model = build_model(self.port_cfg, device="meta")
        params = weights.draw(self.model_cfg, self.cell.config["assumed"]["init"],
                              self.seed, self.device)
        self.weights_sum = weights.checksum(params)
        weights.load(model, params)
        return model

    def reference_params(self) -> Dict[str, torch.Tensor]:
        """The seed's weights drawn again, as drawn (checked against the
        program's draw)."""
        params = weights.draw(self.model_cfg, self.cell.config["assumed"]["init"],
                              self.seed, self.device)
        if weights.checksum(params) != self.weights_sum:
            raise RuntimeError("a second draw of the seed's weights differs from the first")
        return params

    def sample(self, items: Sequence, size: int, length: Callable) -> List:
        """``size`` of ``items`` drawn from the seed, one of the longest
        among them."""
        rng = self.rng(SAMPLE_STREAM)
        top = max(length(it) for it in items)
        longest = [i for i, it in enumerate(items) if length(it) == top]
        first = rng.choice(longest)
        rest = [i for i in range(len(items)) if i != first]
        picked = [first] + rng.sample(rest, min(size - 1, len(rest)))
        return [items[i] for i in sorted(picked)]

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def port_config(config: Mapping, overrides: Mapping):
    """repro_torch's ModelConfig of ``config["arch"]`` with every width of
    the configuration file (``model``) put in, the configuration as it is
    run; ``overrides`` (CPU tests) change it further."""
    from repro_torch.configs.base import get_config

    pc = get_config(config["arch"]).replace(**config["model"])
    return pc.replace(**overrides) if overrides else pc


def percentile(values: Sequence[float], q: float) -> float:
    """Nearest rank: the smallest value with at least q % at or below it."""
    s = sorted(values)
    return s[max(math.ceil(q / 100 * len(s)) - 1, 0)]


# ---------------------------------------------------------------------------
# per-layer readings
# ---------------------------------------------------------------------------

@dataclass
class Readings:
    """What a per-layer metric's reader may read: the kind, the widths, the
    trace of the traced part with what its call sites saw, and the
    untraced window's work and wall time."""
    kind: str
    cfg: dict
    trace: Trace
    calls: Calls
    window: dict
    traced: dict

    def roofline(self, site: str, bound: Callable[[dict], float]) -> Optional[float]:
        """The site's bound summed over its calls over the device time of
        the operations inside its spans, in %."""
        calls = self.calls.by_site.get(site)
        n, seconds = self.trace.in_site(site)
        if not calls or not n:
            return None
        return 100.0 * sum(bound(m) for m in calls) / seconds

    def idle(self) -> Optional[float]:
        """The device's idle share of the untraced window, in %, derived
        from two clocks: each unit of the window's work (a batch of one
        prompt length, a training step) taken at the device's busy time
        for a unit of its kind in the trace (inside the unit's spans, or
        the whole trace's over its units where the work runs on threads a
        span does not follow), over the window's host time.  The profiler
        slows the host, so the traced window's own share (the line's
        ``busy_s`` and ``window_s``) reads high where the host sets the
        pace.  No reading where the estimated busy time exceeds the
        window: the two clocks then disagree."""
        keys = self.traced.get("unit_keys")
        if not keys or not self.window.get("seconds"):
            return None
        site = self.traced.get("unit_site")
        busy = (self.trace.busy_by_span(site) if site
                else [self.trace.busy_s / len(keys)] * len(keys))
        if len(busy) != len(keys):
            return None
        per: Dict[object, List[float]] = {}
        for key, b in zip(keys, busy):
            per.setdefault(key, []).append(b)
        est = sum(n * sum(per[k]) / len(per[k]) for k, n in self.window["units"].items())
        if est > self.window["seconds"]:
            return None
        return 100.0 * (1.0 - est / self.window["seconds"])

    def mfu(self) -> Optional[float]:
        if not self.window.get("seconds"):
            return None
        return 100.0 * self.window["flops"] / (self.window["seconds"] * rooflines.MFU_PEAK)


def per_layer(cell: Cell, r: Readings) -> Dict[str, dict]:
    out = {}
    for m in cell.per_layer:
        value = load_module(HERE / "metrics" / f"{m['name']}.py").read(r)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


# ---------------------------------------------------------------------------
# one run
# ---------------------------------------------------------------------------

def free() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def run(cell_name: str, seed: int, seconds: float, trace: bool, *, t0: float,
        device: str = "cuda", overrides: Optional[Mapping] = None,
        controls: Sequence[str] = (), min_units: int = 0,
        bench_file: Path = ROOT / "BENCHMARK.json") -> dict:
    """Run the cell once and return its result line.  ``t0`` is the
    process's start on ``time.perf_counter``.  ``overrides`` (CPU tests)
    holds ``model`` widths and ``traffic`` parameters; ``controls`` also
    reads the check with those stand-ins in the program's place
    (``control.py``)."""
    overrides = overrides or {}
    cell = find_cell(cell_name, bench_file)
    model_cfg = {**cell.config["model"], **overrides.get("model", {})}
    ctx = Run(cell=cell, seed=seed, seconds=seconds, device=torch.device(device),
              model_cfg=model_cfg,
              traffic={**cell.traffic, **overrides.get("traffic", {})},
              port_cfg=port_config(cell.config, overrides.get("model", {})),
              controls=tuple(controls), min_units=min_units)
    kind = load_module(HERE / "kinds" / f"{cell.traffic['kind']}.py").Kind(ctx)
    if ctx.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(ctx.device)

    kind.setup()
    setup_s = time.perf_counter() - t0
    phases = {"setup": setup_s}
    t = time.perf_counter()
    e2e, attempted, failed, window = kind.window(seconds)
    phases["window"] = time.perf_counter() - t
    line: dict = {"correct": False, "attempted": attempted, "failed": failed}
    device_info = {"platform": "gpu" if ctx.device.type == "cuda" else ctx.device.type,
                   "kind": (torch.cuda.get_device_name(ctx.device)
                            if ctx.device.type == "cuda" else "cpu"),
                   "count": cell.chips}
    metrics: Dict[str, dict] = {}
    breakdown = None
    t = time.perf_counter()
    if trace:
        marked = Calls()
        if getattr(kind, "marked", False):     # backward marks, timed without the profiler
            with sites(marked, marks=True):
                kind.traced_part()
                ctx.sync()
        calls = Calls(marks=marked.marks)
        with sites(calls):
            events = traced(kind.traced_part, cell_name)
        work = kind.traced_work()
        tr = Trace(events)
        metrics = per_layer(cell, Readings(kind=cell.traffic["kind"], cfg=model_cfg,
                                           trace=tr, calls=calls, window=window,
                                           traced=work))
        device_info.update(busy_s=tr.busy_s, window_s=tr.window_s)
        breakdown = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}
    else:
        values = {**e2e, "setup_s": setup_s}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    device_info["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(ctx.device)
                                        if ctx.device.type == "cuda" else 0)
    kind.free()
    free()
    phases["trace"] = time.perf_counter() - t
    t = time.perf_counter()
    numbers, control_numbers = kind.check()
    phases["check"] = time.perf_counter() - t
    checks = {}
    for name, value in numbers.items():
        checks[name] = {"value": value, "limit": cell.limits[name]["limit"]}
    line["correct"] = failed == 0 and all(c["value"] <= c["limit"] for c in checks.values())
    line["metrics"] = metrics
    line["device"] = device_info
    if breakdown is not None:
        line["breakdown"] = breakdown
    if control_numbers:
        line["controls"] = control_numbers
    if getattr(kind, "notes", None):
        line["notes"] = kind.notes
    line["seconds"] = phases
    line["checks"] = checks
    return line
