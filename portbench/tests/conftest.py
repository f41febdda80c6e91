"""The benchmark's own tests: ``python -m pytest -q portbench/tests`` from
the repository's root (the repository's ``testpaths`` leaves them out).
Tests marked ``cuda`` need a card and skip without one."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

#: widths of the CPU tests' stand-in configuration (the traffic shrinks too)
SMALL = {"n_layers": 3, "d_model": 64, "vocab": 256, "dtype": "float32", "ssm_chunk": 16,
         "ssm_state": 16, "ssm_head_dim": 16, "remat": "none"}
OVERRIDES = {
    "mamba2-1.3b.prefill-pool": {"model": SMALL, "traffic": {
        "batch": 2, "deck": [[16, 2], [32, 1]], "check_requests": 4}},
    "mamba2-1.3b.pretrain-2k": {"model": {**SMALL, "remat": "block"}, "traffic": {
        "batch": 2, "seq": 32}},
}


def run_small(cell: str, seed: int = 2**31 + 12345, **kw) -> dict:
    """One run of ``cell`` on the CPU at the stand-in size."""
    import time

    from portbench import harness

    kw.setdefault("min_units", 3)
    return harness.run(cell, seed, 0.0, False, t0=time.perf_counter(), device="cpu",
                       overrides=OVERRIDES[cell], **kw)


@pytest.fixture
def card():
    """Skips a test without a CUDA card."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")
