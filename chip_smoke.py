#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Phases, each fatal on failure:

1. toolchain: torch, CUDA, device capability, nvcc, card and power limit;
2. build: every (KernelGen stencil bench, mode) kernel in one nvcc call,
   then ``SHFL`` instructions counted per kernel in the built SASS;
3. parity: per bench, the shuffle plan (emulator detection vs schedule)
   and each mode's kernel against the plain PyTorch version at a ragged
   medium shape, the three modes bitwise equal;
4. the main path at the paper's sizes (Jacobi 32768x32768, tricubic
   512x1024x1024): DSL program -> PTX -> symbolic emulation -> shuffle
   detection -> ``stencil_apply`` in every mode, with launch counts read
   around it; then each kernel timed with CUDA events against its bound,
   the plain version, a copy of the same bytes and (Jacobi) ``conv2d``;
5. a ``kernels`` JSON line, and as the last line the device record.

Run from the repository root:  python3 chip_smoke.py
Needs one CUDA device and nvcc for sm_90a; exits non-zero without them.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
REPORT = os.path.join(ROOT, "build", "chip_smoke.json")
SEED = 0
TOL = dict(rtol=2e-4, atol=2e-4)        # the reference kernel tests' tolerance
HBM_BYTES_PER_S = 3.35e12               # H100 SXM data sheet
F32_FLOPS = 67e12                       # H100 SXM, float32 outside tensor cores
MEDIUM = {1: (1_048_579,), 2: (2050, 4100), 3: (66, 260, 1030)}
PAPER = {"jacobi": (32768, 32768), "tricubic": (512, 1024, 1024)}
STENCIL_BENCHES = ["jacobi", "gaussblur", "laplacian", "wave13pt",
                   "whispering", "gradient", "divergence", "gameoflife",
                   "lapgsrb", "uxx1", "tricubic", "sincos", "vecadd"]
REPLACES = "src/repro/kernels/stencil/stencil.py:141"
SOURCE = "src/repro_torch/kernels/stencil/csrc/stencil_common.cuh"


def sh(*cmd: str) -> str:
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout.strip()


def card_line() -> str:
    return sh("nvidia-smi", "--query-gpu=name,power.limit",
              "--format=csv,noheader").splitlines()[0]


def event_times(fn, n: int, warmup: int = 2):
    """Per-call device milliseconds of ``fn``: an event pair around each
    call, the calls queued back to back, one synchronise at the end."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in pairs]


def inputs(prog, shape, seed, device):
    """Input tensors and scalars made from one numpy generator."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    arrays = {}
    for a in sorted(prog.arrays):
        if a != prog.out.array:
            host = rng.standard_normal(shape, dtype=np.float32)
            arrays[a] = torch.from_numpy(host).to(device)
            del host
    scalars = {s: float(rng.uniform(0.1, 1.0)) for s in prog.scalars}
    return arrays, scalars


def flops_per_point(expr) -> int:
    from repro_torch.core.frontend.stencil import Bin, Call

    if isinstance(expr, Bin):
        return 1 + flops_per_point(expr.a) + flops_per_point(expr.b)
    if isinstance(expr, Call):
        return 1 + flops_per_point(expr.arg)
    return 0


def sass_counts(so_path: str) -> dict:
    """Per kernel: SHFL and LDG instructions in the SASS."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    counts, fn = {}, None
    for line in sh(cuobjdump, "-sass", so_path).splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = {"shfl": 0, "ldg": 0}
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+([^;]+);", line)
        if fn and m:
            op = m.group(1)
            counts[fn]["shfl"] += bool(re.search(r"\bSHFL\.", op))
            counts[fn]["ldg"] += bool(re.search(r"\bLDG\.", op))
    return counts


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import numpy as np
    import torch.nn.functional as F

    from repro_torch.build import nvcc_path
    from repro_torch.core.frontend.cuda_lower import synthesize_cuda
    from repro_torch.core.frontend.kernelgen import get_bench
    from repro_torch.kernels.stencil import (
        MODES, build_kernels, launch_counts, reference,
        reset_launch_counts, stencil_apply, traffic_report,
    )

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = "cuda"
    t_start = time.perf_counter()
    report = {"sass": {}, "medium": {}, "paper": {}}

    # -- 1. toolchain -------------------------------------------------------
    card = card_line()
    cap = torch.cuda.get_device_capability(0)
    nvcc = sh(nvcc_path(), "--version").splitlines()[-1]
    print(f"[toolchain] torch {torch.__version__} cuda {torch.version.cuda} "
          f"sm_{cap[0]}{cap[1]} | {nvcc} | {card}")
    if cap != (9, 0):
        raise RuntimeError(f"the kernels are built for sm_90a; device is sm_{cap[0]}{cap[1]}")

    # -- 2. build -------------------------------------------------------------
    benches = {n: get_bench(n) for n in STENCIL_BENCHES}
    items = [(b.program, m, b.max_delta) for b in benches.values() for m in MODES]
    t0 = time.perf_counter()
    kernels = dict(zip([(n, m) for n in benches for m in MODES],
                       build_kernels(items)))
    build_s = time.perf_counter() - t0
    lib = next(iter(kernels.values())).library
    print(f"[build] {len(kernels)} kernels, one nvcc call: {lib.seconds:.1f} s "
          f"compile, {build_s:.1f} s with emulation -> {os.path.relpath(lib.path, ROOT)}")
    sass = sass_counts(str(lib.path))
    for (name, mode), k in kernels.items():
        if k.symbol not in sass:
            raise RuntimeError(f"{k.symbol} missing from the SASS")
        c = sass[k.symbol]
        print(f"[sass] {name:<11} {mode:<5} SHFL {c['shfl']:>3} LDG {c['ldg']:>3}")
        report["sass"][f"{name}/{mode}"] = c
    for name, b in benches.items():
        n_pairs = synthesize_cuda(b.program, b.max_delta).n_shuffles
        if sass[kernels[(name, "naive")].symbol]["shfl"] != 0:
            raise RuntimeError(f"{name}: naive kernel contains SHFL")
        if n_pairs and sass[kernels[(name, "paper")].symbol]["shfl"] == 0:
            raise RuntimeError(f"{name}: {n_pairs} detected pairs but no SHFL")

    # -- 3. parity on the card at a ragged medium shape ------------------------
    for i, (name, b) in enumerate(benches.items()):
        prog = b.program
        plan = synthesize_cuda(prog, b.max_delta)
        if not plan.consistent:
            raise RuntimeError(f"{name}: schedule inconsistent with detection")
        shape = MEDIUM[prog.ndim]
        xs, sc = inputs(prog, shape, SEED + i, dev)
        want = reference(prog, xs, sc)
        outs, errs = [], {}
        for mode in MODES:
            k = kernels[(name, mode)]
            before = k.launches
            out = k(xs, sc)
            torch.cuda.synchronize()
            if k.launches != before + 1:
                raise RuntimeError(f"{k.symbol}: launch count did not move")
            torch.testing.assert_close(out, want, **TOL)
            errs[mode] = float((out - want).abs().max())
            outs.append(out)
        if not all(torch.equal(outs[0], o) for o in outs[1:]):
            raise RuntimeError(f"{name}: modes are not bitwise equal")
        report["medium"][name] = {"shape": shape, "shuffles": plan.n_shuffles,
                                  "taps": plan.n_taps, "consistent": plan.consistent,
                                  "max_abs_err": errs}
        print(f"[parity] {name:<11} shape {shape} shuffles {plan.n_shuffles:>2} "
              f"taps {plan.n_taps:>2} consistent {plan.consistent} max|err| "
              + " ".join(f"{m} {e:.2e}" for m, e in errs.items())
              + " bitwise-equal modes")
        del xs, want, outs

    # -- 4. the main path at the paper's sizes ------------------------------
    entries = []
    for name, shape in PAPER.items():
        b = benches[name]
        prog = b.program
        torch.cuda.empty_cache()
        xs, sc = inputs(prog, shape, SEED, dev)
        torch.cuda.synchronize()

        reset_launch_counts()
        plan = synthesize_cuda(prog, b.max_delta)          # compile side
        outs = {m: stencil_apply(prog, xs, sc, mode=m, max_delta=b.max_delta)
                for m in MODES}
        torch.cuda.synchronize()
        counts = launch_counts()
        launches = {m: counts[kernels[(name, m)].symbol] for m in MODES}
        if not plan.consistent or any(n < 1 for n in launches.values()):
            raise RuntimeError(f"{name}: main path launches {launches}")

        for o in outs.values():
            if o.shape != outs["naive"].shape or not bool(torch.isfinite(o).all()):
                raise RuntimeError(f"{name}: non-finite or misshapen output")
        if not all(torch.equal(outs["naive"], o) for o in outs.values()):
            raise RuntimeError(f"{name}: modes are not bitwise equal at {shape}")
        keep = outs["naive"]
        del outs
        torch.cuda.reset_peak_memory_stats()
        plain_t = event_times(lambda: reference(prog, xs, sc), n=3, warmup=1)
        want = reference(prog, xs, sc)
        err = float((keep - want).abs().max())
        torch.testing.assert_close(keep, want, **TOL)
        plain_peak = torch.cuda.max_memory_allocated() / 2**30
        del want

        traffic = traffic_report(prog, shape)
        interior = [s - 2 * h for s, h in zip(shape, reversed(prog.halo))]
        n_out = int(np.prod(interior))
        bytes_ = traffic["compulsory"]
        flops = flops_per_point(prog.expr) * n_out
        bound = {"bytes": bytes_ / HBM_BYTES_PER_S * 1e3,
                 "operations": flops / F32_FLOPS * 1e3}
        bound_by = max(bound, key=bound.get)

        half = int(bytes_ // 8)                       # copy reads + writes bytes_
        src = torch.empty(half, dtype=torch.float32, device=dev)
        dst = torch.empty_like(src)
        copy_ms = statistics.median(event_times(lambda: dst.copy_(src), n=10))
        del src, dst

        library_ms = None
        if name == "jacobi":
            c0, c1, c2 = sc["c0"], sc["c1"], sc["c2"]
            w = torch.tensor([[c2, c1, c2], [c1, c0, c1], [c2, c1, c2]],
                             dtype=torch.float32, device=dev)[None, None]
            x4 = xs["w0"][None, None]
            library_ms = statistics.median(event_times(lambda: F.conv2d(x4, w), n=10))
            torch.testing.assert_close(F.conv2d(x4, w)[0, 0], keep, **TOL)
        del keep

        rec = {"shape": shape, "compulsory_bytes": bytes_, "traffic": traffic,
               "bound_ms": bound[bound_by], "bound_by": bound_by,
               "plain_ms": statistics.median(plain_t), "plain_peak_gib": plain_peak,
               "copy_ms": copy_ms, "library_ms": library_ms, "modes": {}}
        for m in MODES:
            k = kernels[(name, m)]
            ms = statistics.median(event_times(lambda: k(xs, sc), n=10))
            rec["modes"][m] = {"ms": ms, "launches": launches[m],
                               "gbps": bytes_ / ms / 1e6}
            entries.append({
                "name": f"stencil_{m}[{name}]", "route": "cuda",
                "source": SOURCE, "replaces": REPLACES,
                "launches": launches[m], "max_abs_err": err, "ms": ms,
                "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                "bound_by": bound_by, "library_ms": library_ms})
            print(f"[paper-size] {name} {shape} {m:<5} {ms:.3f} ms "
                  f"{rec['modes'][m]['gbps']:.0f} GB/s compulsory, bound "
                  f"{rec['bound_ms']:.3f} ms ({bound_by}), "
                  f"model bytes {traffic[m]:.3e}, "
                  f"launches {launches[m]}")
        print(f"[paper-size] {name} plain {rec['plain_ms']:.2f} ms (peak "
              f"{plain_peak:.1f} GiB) max|err| {err:.2e}, copy_ms {copy_ms:.3f}, "
              f"library_ms {library_ms}")
        report["paper"][name] = rec
        del xs

    # -- 5. records ------------------------------------------------------------
    report["card"] = card
    report["seconds"] = time.perf_counter() - t_start
    os.makedirs(os.path.dirname(REPORT), exist_ok=True)
    with open(REPORT, "w") as f:
        json.dump(report, f, indent=1, default=str)
    print(f"[done] {report['seconds']:.1f} s")
    print(card_line())
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
