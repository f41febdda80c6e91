"""Readings that the limits of a cell's check are set from.

    python3 portbench/control.py --workload <cell> --seeds 11,12,... \
        --control-seeds 21,22,23 [--controls fp8,half_batch] --seconds 4 \
        [--min-units N] [--out FILE]

In one process, runs the cell once per seed, the program as the window
drives it, and prints one JSON line per seed: the compared numbers and,
on the control seeds, the same numbers with each stand-in in the
program's place (``fp8``: the reference with its products in float8;
``half_batch``: training on half of each batch).  The benchmark's own
runs never run the stand-ins.  Needs a card, as ``run.py`` does.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--controls", default="fp8")
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--min-units", type=int, default=0)
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    from portbench import harness

    seeds = [int(s) for s in args.seeds.split(",") if s]
    control_seeds = [int(s) for s in args.control_seeds.split(",") if s]
    controls = tuple(c for c in args.controls.split(",") if c)
    out = open(args.out, "a") if args.out else None
    for seed in seeds + [s for s in control_seeds if s not in seeds]:
        t = time.perf_counter()
        try:
            line = harness.run(args.workload, seed, args.seconds, False, t0=t,
                               controls=controls if seed in control_seeds else (),
                               min_units=args.min_units)
            rec = {"seed": seed, "correct": line["correct"], "checks": line["checks"],
                   "controls": line.get("controls", {}), "metrics": line["metrics"],
                   "attempted": line["attempted"], "phases": line["seconds"],
                   "notes": line.get("notes", {})}
        except Exception:                       # a stand-in that crashes sets no end
            rec = {"seed": seed, "error": traceback.format_exc()[-2000:]}
        rec["seconds"] = time.perf_counter() - t
        text = json.dumps(rec)
        print(text, flush=True)
        if out:
            out.write(text + "\n")
            out.flush()
        harness.free()
        torch.cuda.reset_peak_memory_stats()
    print(f"[control] {args.workload}: {time.perf_counter() - T0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
