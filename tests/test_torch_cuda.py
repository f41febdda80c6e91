"""The CUDA stencil kernels on the card, against their plain PyTorch
version.  Imports only torch and the port, so it runs where JAX is not
installed:  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
Every test here skips without a CUDA device."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

from repro_torch.core.frontend.kernelgen import get_bench
from repro_torch.interop import arrays_from_numpy
from repro_torch.kernels.stencil import (
    MODES,
    build_kernels,
    reference,
    stencil_apply,
)

STENCIL_BENCHES = ["jacobi", "gaussblur", "laplacian", "wave13pt",
                   "whispering", "gradient", "divergence", "gameoflife",
                   "lapgsrb", "uxx1", "tricubic", "sincos", "vecadd"]
TOL = dict(rtol=2e-4, atol=2e-4)     # the reference kernel tests' tolerance

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda_device():
    """Skips without a card; with one, builds every kernel of this file
    in one nvcc call before the first test."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    build_kernels([(get_bench(n).program, m, get_bench(n).max_delta)
                   for n in STENCIL_BENCHES for m in MODES])
    return "cuda"


def _inputs(prog, shape, seed, device):
    rng = np.random.default_rng(seed)
    arrays = {a: rng.standard_normal(shape).astype(np.float32)
              for a in sorted(prog.arrays) if a != prog.out.array}
    scalars = {s: float(rng.uniform(0.1, 1.0)) for s in prog.scalars}
    return arrays_from_numpy(arrays, device), scalars


@pytest.mark.parametrize("name", STENCIL_BENCHES)
def test_kernels_match_plain(cuda_device, name):
    """Each mode's kernel against the plain version at a ragged shape,
    and the three modes bitwise equal."""
    b = get_bench(name)
    prog = b.program
    shape = {1: (100_003,), 2: (133, 517), 3: (13, 37, 261)}[prog.ndim]
    xs, scalars = _inputs(prog, shape, 3, cuda_device)
    want = reference(prog, xs, scalars)
    kernels = build_kernels([(prog, m, b.max_delta) for m in MODES])
    outs = []
    for k in kernels:
        before = k.launches
        outs.append(k(xs, scalars))
        assert k.launches == before + 1
    torch.cuda.synchronize()
    for out in outs:
        torch.testing.assert_close(out, want, **TOL)
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[1], outs[2])


@pytest.mark.parametrize("shape", [(5, 5), (6, 37), (40, 70)])
@pytest.mark.parametrize("mode", MODES)
def test_entry_point_small_and_ragged(cuda_device, shape, mode):
    """Interiors narrower than a warp or a CTA, through ``stencil_apply``."""
    prog = get_bench("gaussblur").program
    xs, scalars = _inputs(prog, shape, 4, cuda_device)
    out = stencil_apply(prog, xs, scalars, mode=mode)
    torch.testing.assert_close(out, reference(prog, xs, scalars), **TOL)


def test_wrapper_rejects_bad_inputs(cuda_device):
    prog = get_bench("jacobi").program
    (kernel,) = build_kernels([(prog, "paper", 31)])
    xs, scalars = _inputs(prog, (64, 64), 5, cuda_device)
    with pytest.raises(TypeError):
        kernel({"w0": xs["w0"].double()}, scalars)
    with pytest.raises(ValueError):
        kernel({"w0": xs["w0"].t()}, scalars)
    with pytest.raises(ValueError):
        kernel({"w0": xs["w0"].cpu()}, scalars)
    with pytest.raises(ValueError):
        kernel({"w0": xs["w0"][0]}, scalars)
