"""Run one cell of the benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds the program (``src/repro_torch``)
and a card for each chip the cell asks for.  The last line of standard
output is one JSON object (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` also ``breakdown``, and last
``checks``: each number compared with its limit); the last lines of
standard error repeat the checks.  Kernels are built into ``build/`` in
the checkout, so only a checkout's first run of a cell compiles.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def fail(msg: str, code: int = 2) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"no program under {ROOT / 'src' / 'repro_torch'}")
    os.environ["USE_FLAX"] = "0"
    os.environ.pop("REPRO_CACHE_DIR", None)
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    chips = {w["name"]: w["chips"] for w in bench["workloads"]}.get(args.workload)
    if chips is None:
        fail(f"no workload {args.workload!r} in BENCHMARK.json")

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        fail(f"{args.workload} needs {chips} CUDA device(s); "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available")

    from portbench import harness

    line = harness.run(args.workload, args.seed, args.seconds, bool(args.trace), t0=T0)
    loaded = harness.forbidden_modules()
    if loaded:
        fail(f"the run loaded {', '.join(loaded)}", 3)
    print("[portbench] seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in line["seconds"].items()),
          file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
