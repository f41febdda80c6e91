"""Mirrors ``src/repro/core/targets/calibrate.py`` (only the imports differ).

Autotuned target-profile calibration (ROADMAP: autotuned profiles).

The registry ships Table 1 as static data cards.  This module turns
those cards into a *data pipeline*: it generates a suite of
microbenchmark PTX kernels with known event-count mixes, measures them
through a pluggable :class:`MeasurementBackend`, and fits the profile
parameters the cycle model weights events with — ``latency`` (``shfl``
/ ``sm`` / ``l1``), ``mlp`` and ``shfl_ilp`` — so ``selection="cost"``
decisions can track measured hardware instead of shipped tables (the
ACC-Saturator / parametric-kernel-autotuning direction,
arXiv:2306.13002, arXiv:1801.04348).

Observation model
-----------------
Every microbenchmark yields an :class:`~repro.core.emulator.observe.
Observation`: the feature vector extracted from concrete-emulation
:class:`RunStats` plus measured cycles.  Two kinds mirror how latency
microbenchmarks are run on real GPUs (the Table-1 papers [16, 33]):

* **latency probes** — serialized dependent chains (pointer chases, a
  shuffle feeding itself): every event waits for its predecessor, so
  each latency contributes unhidden (divisor 1);
* **throughput mixes** — independent streams (lowered KernelGen
  stencils, shuffle/shared-memory streams): events overlap exactly as
  :func:`~repro.core.emulator.cycles.estimate_cycles` scores them
  (loads by ``mlp``, shuffles by ``min(mlp, shfl_ilp)``).

Fit method
----------
The closed form is linear in the latencies given the hiding factors and
linear in the *inverse* hiding factors given the latencies, so the
solver runs linear least squares per stage (latencies from the probe
rows, ``1/mlp`` and ``1/shfl_hide`` from the throughput rows) and then
polishes all five coordinates jointly by exact coordinate descent over
the full overdetermined system until the updates vanish.  Only
``min(mlp, shfl_ilp)`` is observable from cycles (that is all the model
ever uses); the fitted ``shfl_ilp`` records that observable value.

The default backend replays the measurement on the concrete warp
emulator scored with the reference profile — the same wall-clock
substitution the cycle model documents — so fitted parameters recover
the shipped Table-1 cards almost exactly; dropping in a wall-clock
backend on a real GPU requires implementing one ``measure`` method.
"""

from __future__ import annotations

import dataclasses
import json
import math
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

try:  # pragma: no cover - always present on 3.8+
    from typing import Protocol
except ImportError:  # pragma: no cover
    Protocol = object  # type: ignore[assignment]

from ..emulator.concrete import run_concrete
from ..emulator.observe import Observation, extract_features
from ..ptx.parser import parse_kernel
from .profile import TargetProfile
from .registry import register_target, resolve_target

#: calibration JSON schema version (bump on incompatible layout changes)
SCHEMA_VERSION = 1

#: where ``save_calibration`` writes by default
DEFAULT_CALIBRATION_DIR = Path("experiments/calibration")

#: the parameters the fit recovers (everything else in a profile is an
#: ISA capability or a compiler constant, not a measured latency)
FITTED_PARAMS = ("l1", "sm", "shfl", "mlp", "shfl_ilp")


# ---------------------------------------------------------------------------
# microbenchmark suite
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Microbench:
    """One calibration kernel plus the launch that measures it."""

    name: str
    kind: str                                  # "latency" | "throughput"
    kernel: object                             # ptx.ir.Kernel
    make_params: Callable[[], Dict[str, object]]
    ntid: Tuple[int, int, int] = (32, 1, 1)
    nctaid: Tuple[int, int, int] = (1, 1, 1)


def _chase_params() -> Dict[str, object]:
    # the chase table is all zeros: every step reloads index 0, which
    # keeps the chain data-dependent without leaving the buffer
    return {"buf": np.zeros(64, np.uint32), "out": np.zeros(1, np.uint32)}


def _chain_kernel(name: str, space: str, steps: int):
    """Pointer-chase latency probe: each load's address depends on the
    previously loaded value (1 load + 2 ALU per step)."""
    lines = [
        f".visible .entry {name}(.param .u64 buf, .param .u64 out)",
        "{",
        "  .reg .b32 %r<3>;",
        "  .reg .b64 %rd<7>;",
        "  ld.param.u64 %rd1, [buf];",
        "  cvta.to.global.u64 %rd2, %rd1;",
        "  mov.u64 %rd3, %rd2;",
    ]
    for _ in range(steps):
        lines += [
            f"  ld.{space}.u32 %r1, [%rd3];",
            "  mul.wide.u32 %rd4, %r1, 4;",
            "  add.s64 %rd3, %rd2, %rd4;",
        ]
    lines += [
        "  ld.param.u64 %rd5, [out];",
        "  cvta.to.global.u64 %rd6, %rd5;",
        "  st.global.u32 [%rd6], %r1;",
        "  ret;",
        "}",
    ]
    return parse_kernel("\n".join(lines))


def _shfl_chain_kernel(name: str, steps: int):
    """Shuffle latency probe: each shuffle sources its own result."""
    lines = [
        f".visible .entry {name}(.param .u64 out)",
        "{",
        "  .reg .b32 %r<3>;",
        "  .reg .b64 %rd<3>;",
        "  mov.u32 %r1, %tid.x;",
    ]
    for _ in range(steps):
        # bfly with delta 1 is always in-range: a pure serial chain
        lines.append("  shfl.bfly.b32 %r1, %r1, 1, 31;")
    lines += [
        "  ld.param.u64 %rd1, [out];",
        "  cvta.to.global.u64 %rd2, %rd1;",
        "  st.global.u32 [%rd2], %r1;",
        "  ret;",
        "}",
    ]
    return parse_kernel("\n".join(lines))


def _shfl_stream_kernel(name: str, count: int):
    """Independent shuffles (all source one register): throughput row
    that pins the shuffle hiding factor."""
    lines = [
        f".visible .entry {name}(.param .u64 out)",
        "{",
        f"  .reg .b32 %r<{count + 3}>;",
        "  .reg .b64 %rd<3>;",
        "  mov.u32 %r1, %tid.x;",
    ]
    for i in range(count):
        lines.append(f"  shfl.bfly.b32 %r{i + 2}, %r1, {1 + i % 3}, 31;")
    for i in range(count):
        lines.append(f"  or.b32 %r1, %r1, %r{i + 2};")
    lines += [
        "  ld.param.u64 %rd1, [out];",
        "  cvta.to.global.u64 %rd2, %rd1;",
        "  st.global.u32 [%rd2], %r1;",
        "  ret;",
        "}",
    ]
    return parse_kernel("\n".join(lines))


def _sm_stream_kernel(name: str, count: int):
    """Independent shared-memory reads at distinct offsets."""
    lines = [
        f".visible .entry {name}(.param .u64 buf, .param .u64 out)",
        "{",
        f"  .reg .b32 %r<{count + 3}>;",
        "  .reg .b64 %rd<5>;",
        "  ld.param.u64 %rd1, [buf];",
        "  cvta.to.global.u64 %rd2, %rd1;",
        "  mov.u32 %r1, 0;",
    ]
    for i in range(count):
        lines.append(f"  ld.shared.u32 %r{i + 2}, [%rd2+{4 * i}];")
    for i in range(count):
        lines.append(f"  or.b32 %r1, %r1, %r{i + 2};")
    lines += [
        "  ld.param.u64 %rd3, [out];",
        "  cvta.to.global.u64 %rd4, %rd3;",
        "  st.global.u32 [%rd4], %r1;",
        "  ret;",
        "}",
    ]
    return parse_kernel("\n".join(lines))


def _stencil_microbench(bench_name: str, *, synthesized: bool = False,
                        target: Union[TargetProfile, str, None] = None
                        ) -> Microbench:
    """Lower a KernelGen program through the frontend (the L1-bound /
    mixed workloads); ``synthesized=True`` measures the PTXASW rewrite
    instead (adds shuffle + checker + corner events to the mix)."""
    from ..frontend.kernelgen import get_bench
    from ..frontend.stencil import lower_to_ptx

    b = get_bench(bench_name)
    prog = b.program
    kernel = lower_to_ptx(prog)
    label = bench_name
    if synthesized:
        from ..emulator.machine import emulate
        from ..synthesis.codegen import synthesize
        from ..synthesis.detect import detect

        detection = detect(kernel, emulate(kernel), max_delta=b.max_delta)
        kernel = synthesize(kernel, detection, mode="ptxasw", target=target)
        label = f"{bench_name}_ptxasw"

    nd = prog.ndim
    h0 = prog.halo[0]
    h1 = prog.halo[1] if nd >= 2 else 0
    h2 = prog.halo[2] if nd == 3 else 0
    block_x = 32
    interior_x = 64
    if nd == 1:
        shape: Tuple[int, ...] = (interior_x + 2 * h0,)
    elif nd == 2:
        shape = (4 + 2 * h1, interior_x + 2 * h0)
    else:
        shape = (3 + 2 * h2, 4 + 2 * h1, interior_x + 2 * h0)
    nbx = interior_x // block_x
    nctaid = (nbx,
              shape[-2] - 2 * h1 if nd >= 2 else 1,
              shape[0] - 2 * h2 if nd == 3 else 1)

    def make_params() -> Dict[str, object]:
        rng = np.random.default_rng(0)
        p: Dict[str, object] = {}
        for arr, adim in prog.arrays.items():
            p[arr] = (np.zeros(shape[-adim:], np.float32)
                      if arr == prog.out.array else
                      rng.standard_normal(shape[-adim:]).astype(np.float32))
        for d in range(nd):
            p[f"n{d}"] = shape[::-1][d]
        for s in prog.scalars:
            p[s] = int(np.frombuffer(np.float32(0.3).tobytes(),
                                     np.uint32)[0])
        return p

    return Microbench(name=f"thr_{label}", kind="throughput", kernel=kernel,
                      make_params=make_params, ntid=(block_x, 1, 1),
                      nctaid=nctaid)


def default_suite(target: Union[TargetProfile, str, None] = None
                  ) -> List[Microbench]:
    """The stock calibration suite: latency probes for each fitted
    latency at two chain depths (overdetermination), plus throughput
    mixes — frontend-lowered stencils (L1-bound and mixed), a
    shared-memory stream, shuffle streams, and the synthesized PTXASW
    variant of jacobi (shuffle + checker + corner-lane events)."""
    profile = resolve_target(target)
    suite: List[Microbench] = []
    for steps in (16, 48):
        suite.append(Microbench(
            name=f"lat_l1_chase_{steps}", kind="latency",
            kernel=_chain_kernel(f"cal_l1_chase_{steps}", "global", steps),
            make_params=_chase_params))
        suite.append(Microbench(
            name=f"lat_sm_chase_{steps}", kind="latency",
            kernel=_chain_kernel(f"cal_sm_chase_{steps}", "shared", steps),
            make_params=_chase_params))
        suite.append(Microbench(
            name=f"lat_shfl_chain_{steps}", kind="latency",
            kernel=_shfl_chain_kernel(f"cal_shfl_chain_{steps}", steps),
            make_params=lambda: {"out": np.zeros(1, np.uint32)}))
    for count in (8, 24):
        suite.append(Microbench(
            name=f"thr_shfl_stream_{count}", kind="throughput",
            kernel=_shfl_stream_kernel(f"cal_shfl_stream_{count}", count),
            make_params=lambda: {"out": np.zeros(1, np.uint32)}))
    suite.append(Microbench(
        name="thr_sm_stream_16", kind="throughput",
        kernel=_sm_stream_kernel("cal_sm_stream_16", 16),
        make_params=_chase_params))
    suite.append(_stencil_microbench("vecadd"))
    suite.append(_stencil_microbench("jacobi"))
    suite.append(_stencil_microbench("gaussblur"))
    suite.append(_stencil_microbench("jacobi", synthesized=True,
                                     target=profile))
    return suite


# ---------------------------------------------------------------------------
# measurement backends
# ---------------------------------------------------------------------------

class MeasurementBackend(Protocol):
    """Anything that can turn a :class:`Microbench` into an
    :class:`Observation`.  Implementations: :class:`EmulatorBackend`
    (default, this environment); a wall-clock CUDA-events backend on a
    real GPU plugs in here without touching the fitter."""

    name: str

    def measure(self, bench: Microbench) -> Observation:  # pragma: no cover
        ...


class EmulatorBackend:
    """Default backend: concrete warp emulation scored with a reference
    profile — the stand-in for wall-clock measurement in this
    environment (the same substitution ``estimate_cycles`` documents).
    Latency probes are scored serialized (nothing hidden), throughput
    mixes with the reference's hiding factors.  ``noise`` adds
    multiplicative Gaussian jitter for robustness experiments."""

    name = "emulator"

    def __init__(self, reference: Union[TargetProfile, str, None],
                 noise: float = 0.0, seed: int = 0) -> None:
        self.reference = resolve_target(reference)
        self.noise = float(noise)
        self._rng = np.random.default_rng(seed)

    def measure(self, bench: Microbench) -> Observation:
        from ..emulator.cycles import cycles_from_features

        stats = run_concrete(bench.kernel, bench.make_params(),
                             ntid=bench.ntid, nctaid=bench.nctaid)
        features = extract_features(stats)
        cycles = cycles_from_features(features, self.reference,
                                      hidden=bench.kind == "throughput")
        if self.noise:
            cycles *= 1.0 + self.noise * float(self._rng.standard_normal())
        return Observation(name=bench.name, kind=bench.kind,
                           features=features, cycles=cycles)


# ---------------------------------------------------------------------------
# fitting
# ---------------------------------------------------------------------------

@dataclass
class FitResult:
    """A fitted profile plus how well the fit explains the observations."""

    profile: TargetProfile
    base: str                       # reference profile the suite/ISA came from
    backend: str
    quality: float                  # R^2 over all observations
    residuals: Dict[str, float]     # per-parameter sensitivity-weighted RMS
    n_observations: int
    observations: List[Observation] = field(default_factory=list, repr=False)

    def fitted_params(self) -> Dict[str, float]:
        p = self.profile
        return {"l1": float(p.latency["l1"]), "sm": float(p.latency["sm"]),
                "shfl": float(p.latency["shfl"]), "mlp": float(p.mlp),
                "shfl_ilp": float(p.shfl_ilp)}

    def rel_errors(self, reference: Union[TargetProfile, str, None] = None
                   ) -> Dict[str, float]:
        """Per-parameter |fitted - reference| / reference (the
        fitted-vs-Table-1 deltas the CLI prints)."""
        ref = resolve_target(reference if reference is not None else self.base)
        ref_params = {"l1": ref.latency["l1"], "sm": ref.latency["sm"],
                      "shfl": ref.latency["shfl"], "mlp": ref.mlp,
                      "shfl_ilp": min(ref.mlp, ref.shfl_ilp)}
        fit = self.fitted_params()
        return {k: abs(fit[k] - ref_params[k]) / abs(ref_params[k])
                for k in FITTED_PARAMS}

    def max_rel_error(self, reference: Union[TargetProfile, str, None] = None
                      ) -> float:
        return max(self.rel_errors(reference).values())

    @property
    def summary(self) -> str:
        p = self.fitted_params()
        return (f"{self.profile.name}: l1={p['l1']:.2f} sm={p['sm']:.2f} "
                f"shfl={p['shfl']:.2f} mlp={p['mlp']:.2f} "
                f"ilp={p['shfl_ilp']:.2f} (R^2={self.quality:.6f}, "
                f"{self.n_observations} obs via {self.backend})")


def _const_cycles(obs: Observation, base: TargetProfile) -> float:
    """Issue-cost terms: compiler constants, not fitted latencies."""
    return (obs.feature("alu") * base.alu_cost
            + obs.feature("falu") * base.falu_cost
            + obs.feature("branch") * base.branch_cost
            + obs.feature("pred_off") * base.pred_off_cost)


def _coef(obs: Observation, coord: str, theta: Dict[str, float]) -> float:
    """d(prediction)/d(coord): the exact per-coordinate linearization.

    ``x`` and ``y`` are the inverse hiding factors (1/mlp and
    1/shfl_hide); latency probes bypass them (divisor 1)."""
    thr = obs.kind == "throughput"
    if coord == "l1":
        return obs.feature("l1") * (theta["x"] if thr else 1.0)
    if coord == "sm":
        return obs.feature("sm") * (theta["x"] if thr else 1.0)
    if coord == "shfl":
        return obs.feature("shfl") * (theta["y"] if thr else 1.0)
    if coord == "x":
        return (theta["l1"] * obs.feature("l1")
                + theta["sm"] * obs.feature("sm")) if thr else 0.0
    if coord == "y":
        return theta["shfl"] * obs.feature("shfl") if thr else 0.0
    raise KeyError(coord)


def _predict(obs: Observation, theta: Dict[str, float],
             base: TargetProfile) -> float:
    thr = obs.kind == "throughput"
    x = theta["x"] if thr else 1.0
    y = theta["y"] if thr else 1.0
    return (theta["l1"] * obs.feature("l1") * x
            + theta["sm"] * obs.feature("sm") * x
            + theta["shfl"] * obs.feature("shfl") * y
            + _const_cycles(obs, base))


def _lstsq(rows: List[List[float]], rhs: List[float],
           fallback: List[float]) -> List[float]:
    """Least squares with per-column fallback when a parameter has no
    coverage in the design matrix (keeps the fit usable on partial
    suites instead of returning NaN)."""
    A = np.asarray(rows, float)
    b = np.asarray(rhs, float)
    if A.size == 0:
        return list(fallback)
    sol, *_ = np.linalg.lstsq(A, b, rcond=None)
    out = []
    for j, v in enumerate(sol):
        covered = bool(np.any(np.abs(A[:, j]) > 1e-12))
        out.append(float(v) if covered and math.isfinite(v)
                   else float(fallback[j]))
    return out


def fit_profile(observations: Sequence[Observation],
                base: Union[TargetProfile, str],
                name: Optional[str] = None,
                backend_name: str = "emulator",
                max_sweeps: int = 200, tol: float = 1e-12) -> FitResult:
    """Solve the overdetermined system for (l1, sm, shfl, mlp, shfl_ilp).

    Staged linear least squares seeds the solution (latencies from the
    probe rows, inverse hiding factors from the throughput rows); exact
    coordinate descent over the full system then polishes all five
    coordinates jointly until the sweep-to-sweep change vanishes.
    """
    base = resolve_target(base)
    obs = list(observations)
    if not obs:
        raise ValueError("fit_profile needs at least one observation")

    lat_obs = [o for o in obs if o.kind == "latency"]
    thr_obs = [o for o in obs if o.kind == "throughput"]

    base_lat = [float(base.latency["l1"]), float(base.latency["sm"]),
                float(base.latency["shfl"])]
    l1, sm, shfl = _lstsq(
        [[o.feature("l1"), o.feature("sm"), o.feature("shfl")]
         for o in lat_obs],
        [o.cycles - _const_cycles(o, base) for o in lat_obs],
        base_lat)

    xy = _lstsq(
        [[l1 * o.feature("l1") + sm * o.feature("sm"),
          shfl * o.feature("shfl")] for o in thr_obs],
        [o.cycles - _const_cycles(o, base) for o in thr_obs],
        [1.0 / base.mlp, 1.0 / base.shfl_hide])
    theta = {"l1": l1, "sm": sm, "shfl": shfl,
             "x": max(xy[0], 1e-9), "y": max(xy[1], 1e-9)}

    for _ in range(max_sweeps):
        delta = 0.0
        for coord in ("l1", "sm", "shfl", "x", "y"):
            num = den = 0.0
            for o in obs:
                c = _coef(o, coord, theta)
                if c == 0.0:
                    continue
                partial = o.cycles - (_predict(o, theta, base)
                                      - c * theta[coord])
                num += c * partial
                den += c * c
            if den <= 0.0:
                continue
            new = num / den
            if coord in ("x", "y"):
                new = max(new, 1e-9)
            delta = max(delta, abs(new - theta[coord])
                        / max(abs(theta[coord]), 1e-9))
            theta[coord] = new
        if delta < tol:
            break

    # quality + per-parameter residuals at the solution
    residual = [o.cycles - _predict(o, theta, base) for o in obs]
    sse = sum(r * r for r in residual)
    mean = sum(o.cycles for o in obs) / len(obs)
    sst = sum((o.cycles - mean) ** 2 for o in obs)
    quality = 1.0 - sse / sst if sst > 0 else (1.0 if sse < 1e-9 else 0.0)
    res: Dict[str, float] = {}
    for coord, label in (("l1", "l1"), ("sm", "sm"), ("shfl", "shfl"),
                         ("x", "mlp"), ("y", "shfl_ilp")):
        wsum = wres = 0.0
        for o, r in zip(obs, residual):
            w = abs(_coef(o, coord, theta))
            wsum += w
            wres += w * r * r
        res[label] = math.sqrt(wres / wsum) if wsum > 0 else 0.0

    mlp = 1.0 / theta["x"]
    # only min(mlp, shfl_ilp) is observable from cycles — record the
    # observable hiding; when it saturates at mlp the true ILP could be
    # anything >= mlp and the model's behaviour is identical either way
    shfl_hide = 1.0 / theta["y"]
    profile = dataclasses.replace(
        base,
        name=name or f"{base.name}-tuned",
        latency={"shfl": theta["shfl"], "sm": theta["sm"],
                 "l1": theta["l1"]},
        mlp=mlp,
        shfl_ilp=shfl_hide,
        calibration="fitted")
    return FitResult(profile=profile, base=base.name, backend=backend_name,
                     quality=quality, residuals=res,
                     n_observations=len(obs), observations=obs)


# ---------------------------------------------------------------------------
# driver + persistence
# ---------------------------------------------------------------------------

def calibrate(target: Union[TargetProfile, str, None],
              backend: Optional[MeasurementBackend] = None,
              suite: Optional[Sequence[Microbench]] = None,
              name: Optional[str] = None,
              register: bool = True) -> FitResult:
    """Measure the suite through the backend, fit, and (by default)
    register the tuned profile as ``"<base>-tuned"`` with
    ``calibration="fitted"`` — resolvable by name everywhere
    (``selection="cost"``, ``compile_for_targets``, codegen, the
    benchmarks).  Re-calibration re-registers idempotently."""
    base = resolve_target(target)
    backend = backend or EmulatorBackend(base)
    suite = list(suite) if suite is not None else default_suite(base)
    observations = [backend.measure(b) for b in suite]
    fit = fit_profile(observations, base, name=name,
                      backend_name=getattr(backend, "name",
                                           type(backend).__name__))
    if register:
        register_target(fit.profile, overwrite=True)
    return fit


def save_calibration(fit: FitResult,
                     directory: Union[str, Path] = DEFAULT_CALIBRATION_DIR
                     ) -> Path:
    """Persist a fit as ``<directory>/<profile name>.json``."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    path = directory / f"{fit.profile.name}.json"
    payload = {
        "schema": SCHEMA_VERSION,
        "profile": fit.profile.to_dict(),
        "fit": {
            "base": fit.base,
            "backend": fit.backend,
            "quality": fit.quality,
            "residuals": fit.residuals,
            "n_observations": fit.n_observations,
        },
    }
    path.write_text(json.dumps(payload, indent=2, sort_keys=True) + "\n")
    return path


def load_calibration(path: Union[str, Path],
                     register: bool = False) -> FitResult:
    """Load a persisted calibration; ``register=True`` also installs the
    profile in the registry (idempotently, like re-calibrating)."""
    data = json.loads(Path(path).read_text())
    if data.get("schema") != SCHEMA_VERSION:
        raise ValueError(f"unsupported calibration schema in {path}: "
                         f"{data.get('schema')!r} != {SCHEMA_VERSION}")
    profile = TargetProfile.from_dict(data["profile"])
    meta = data["fit"]
    fit = FitResult(profile=profile, base=meta["base"],
                    backend=meta["backend"], quality=meta["quality"],
                    residuals=dict(meta["residuals"]),
                    n_observations=meta["n_observations"])
    if register:
        register_target(profile, overwrite=True)
    return fit
