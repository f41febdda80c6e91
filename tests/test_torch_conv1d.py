"""The port's conv1d against the JAX package: the plain PyTorch version
against the Pallas kernel (interpret mode, both modes) and its jnp
oracle; the shuffle schedule against the emulator's detection; the
analytic traffic model against the reference's."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

from repro.kernels.conv1d import causal_conv1d as jax_conv1d
from repro.kernels.conv1d import hbm_bytes as jax_hbm_bytes
from repro.kernels.conv1d import ref as jax_conv_ref
from repro_torch.core.frontend import cuda_lower
from repro_torch.kernels import conv1d as tconv
from repro_torch.kernels.conv1d import conv1d as tconv_gen

SHAPES = [(2, 64, 32, 4), (1, 100, 48, 4), (3, 33, 17, 3), (2, 256, 96, 4)]
TOL = {np.float32: 1e-5, "bfloat16": 5e-2}     # the reference kernel tests'


def _inputs(shape, dtype, seed):
    B, L, C, W = shape
    rng = np.random.default_rng(seed)
    host = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, L, C), (W, C), (C,))]
    jdt = jnp.float32 if dtype == np.float32 else jnp.bfloat16
    tdt = torch.float32 if dtype == np.float32 else torch.bfloat16
    jx = [jnp.asarray(h, jdt) for h in host]
    # the same rounded values on both sides
    tx = [torch.from_numpy(np.array(j, np.float32)).to(tdt) for j in jx]
    return jx, tx


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("mode", tconv.MODES)
def test_plain_matches_pallas_and_oracle(shape, dtype, mode):
    (jx, jw, jb), (x, w, b) = _inputs(shape, dtype, seed=sum(shape))
    pallas = jax_conv1d(jx, jw, jb, mode=mode, block_seq=32, block_ch=16)
    oracle = jax_conv_ref.causal_conv1d(jx, jw, jb)
    out = tconv.causal_conv1d(x, w, b, mode=mode)           # CPU: plain version
    assert out.dtype == x.dtype and out.shape == x.shape
    got = out.float().numpy()
    tol = TOL[dtype]
    for want in (pallas, oracle):
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   rtol=tol, atol=tol)


def test_plain_without_activation_is_the_sum():
    (_, _, _), (x, w, b) = _inputs((2, 9, 5, 4), np.float32, seed=1)
    out = tconv.causal_conv1d(x, w, b, activation=False)
    xp = torch.nn.functional.pad(x, (0, 0, 3, 0))
    want = b + sum(xp[:, t:t + 9] * w[t] for t in range(4))
    torch.testing.assert_close(out, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("W", [2, 3, 4])
def test_shuffle_schedule_is_the_detection(W):
    """The port of ``test_ptxasw_finds_conv_deltas``: the width-W conv
    program yields W - 1 shuffles with deltas 1..W-1, the shuffle mode's
    schedule moves exactly those taps by those deltas, and the generated
    kernel issues exactly those shuffles."""
    prog = tconv.conv_program(W)
    det = cuda_lower.analyze(prog)
    assert sorted(p.delta for p in det.pairs) == list(range(1, W))
    spec = tconv.make_spec("shuffle", W)
    assert spec.sources == (1 - W,)
    assert sorted(d for _, _, d in spec.covered) == list(range(1, W))
    assert all(dst - src == d for dst, src, d in spec.covered)
    src = tconv.kernel_source(spec)
    assert src.count("rc::shfl_or_reload") == W - 1
    for dst, s, d in spec.covered:
        assert f"shfl_or_reload<T, VEC>({tconv_gen._var(s)}, {d}, x, s, {dst})" in src
    naive = tconv.kernel_source(tconv.make_spec("naive", W))
    assert "shfl" not in naive and naive.count("rc::load_tap") == W


def test_reference_program_deltas():
    """The reference test's own program (coefficients 0.1..0.4) gives the
    same deltas through the port's middle-end."""
    from repro_torch.core.frontend.stencil import Array, I, Program

    x = Array("x")
    expr = (0.1 * x[I(-3)] + 0.2 * x[I(-2)] + 0.3 * x[I(-1)] + 0.4 * x[I(0)])
    prog = Program(name="conv1d", ndim=1, out=Array("y")[I()], expr=expr)
    assert sorted(p.delta for p in cuda_lower.analyze(prog).pairs) == [1, 2, 3]


def test_shuffle_build_refuses_a_disagreeing_detection(monkeypatch):
    real = cuda_lower.synthesize_cuda

    def wrong(prog, max_delta=31):
        plan = real(prog, max_delta)
        plan.consistent = False
        return plan

    monkeypatch.setattr(cuda_lower, "synthesize_cuda", wrong)
    with pytest.raises(ValueError, match="disagrees"):
        tconv.make_spec("shuffle", 4)


@pytest.mark.parametrize("L", [1, 5, 8, 13, 37])
@pytest.mark.parametrize("W", [3, 4])
def test_warp_replay_of_the_shuffle_schedule(L, W):
    """Replay the shuffle kernel's warp lane by lane (8 positions x 4
    channel groups, ``__shfl_down_sync`` by 4 * delta, lanes past the
    warp reloading, loads masked on their own position) over a ragged L,
    and check every valid lane gets exactly its own W taps."""
    spec = tconv.make_spec("shuffle", W)
    pos, groups = 8, 4
    xs = np.arange(L, dtype=np.float64) + 1.0          # x[l], nonzero

    def load(l, off):
        q = l + off
        return xs[q] if 0 <= q < L else 0.0

    for warp_l0 in range(0, L, pos):
        lanes = [(p, g) for p in range(pos) for g in range(groups)]
        held = {}
        for p, g in lanes:
            for off in spec.sources:
                held[(p, g, off)] = load(warp_l0 + p, off)
        for dst, src, d in spec.covered:
            for p, g in lanes:
                lane = p * groups + g
                other = lane + groups * d
                if other < 32:
                    v = held[(other // groups, other % groups, src)]
                else:
                    v = held[(p, g, src)]
                if p + d >= pos:
                    v = load(warp_l0 + p, dst)
                held[(p, g, dst)] = v
        for p, g in lanes:
            l = warp_l0 + p
            if l >= L:
                continue
            for off in range(1 - W, 1):
                assert held[(p, g, off)] == load(l, off), (l, off)


@pytest.mark.parametrize("args", [(4096, 4096, 4, "naive"), (4096, 4096, 4, "shuffle"),
                                  (1024, 4352, 4, "shuffle"), (33, 17, 3, "naive"),
                                  (100, 48, 4, "shuffle")])
def test_hbm_bytes_equals_reference(args):
    assert tconv.hbm_bytes(*args) == jax_hbm_bytes(*args)
    assert tconv.hbm_bytes(*args, block_seq=32, block_ch=16, itemsize=4) == \
        jax_hbm_bytes(*args, block_seq=32, block_ch=16, itemsize=4)


def test_entry_point_checks_mode():
    x = torch.zeros(1, 4, 2)
    with pytest.raises(ValueError, match="unknown mode"):
        tconv.causal_conv1d(x, torch.zeros(4, 2), torch.zeros(2), mode="tile")
