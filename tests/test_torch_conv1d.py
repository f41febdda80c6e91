"""The port's conv1d against the JAX package: the plain PyTorch version
against the Pallas kernel (interpret mode, both modes) and its jnp
oracle; the shuffle schedule against the emulator's detection; the
analytic traffic model against the reference's."""

from dataclasses import replace

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
    # one source row per segment, from the prefetched ring; each covered
    # tap by one rc::covered from this segment's and the next one's row
    assert src.count("rc::source_row<") == 2 and "rc::load_tap" not in src
    assert f"const rc::Pack<T, VEC> {tconv_gen._var(1 - W)} = row[i];" in src
    assert src.count("rc::covered<") == W - 1
    for dst, _, d in spec.covered:
        assert (f"{tconv_gen._var(dst)} = rc::covered<T, VEC>(row[i], row[i + 1], "
                f"{d}, s);") in src
    assert src.count("wb.tap(") == W and f"RC_LAUNCHER({spec.symbol}, " in src
    naive = tconv.kernel_source(tconv.make_spec("naive", W))
    assert "rc::covered" not in naive and "row[" not in naive
    assert naive.count("rc::load_tap") == W and naive.count("wb.tap(") == W


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


def _corner_next(d):
    """The kernel's corner source: the next segment's source row, lane
    ``lane - (32 - 4d)`` (``__shfl_up_sync`` by ``32 - 4d``)."""
    return "next", 32 - 4 * d


def _masked(pos, L):
    """``load_tap``'s own test: a position that yields zeros, not a load."""
    return (pos < 0) | (pos >= L)


def _replay_march(spec, L, corner=_corner_next, masked=_masked):
    """Replay the kernel's march lane by lane along L, as
    ``csrc/conv1d_common.cuh`` runs it for one channel tile: CTAs of
    ``WARPS_L`` warps, each marching over ``STEPS`` segments of 8
    positions x 4 channel groups; the march stops at the first step past
    L for the whole CTA.  ``shuffle``: segment i's source row fetched
    ``AHEAD`` steps early (of the extra row ``STEPS`` only lanes p < W - 1
    load), each covered tap taken by ``__shfl_down_sync`` by 4d from the
    current row and, for a corner lane (p + d >= 8), from the row
    ``corner(d)`` names by ``__shfl_up_sync``; ``naive``: one load per
    tap.  A load dereferences x at every position that ``masked`` lets
    through, and each such position must lie in [0, L); every valid lane
    must get exactly its own W taps, and every output position be stored
    once per channel group."""
    W, S, A = spec.W, tconv_gen.STEPS, tconv_gen.AHEAD
    P, G = tconv_gen.POSITIONS, tconv_gen.GROUPS
    x = np.arange(L * G, dtype=np.float64).reshape(L, G) + 1.0   # x[l, g], nonzero
    lanes = np.arange(32)
    p, g = lanes // G, lanes % G

    def tap(pos):
        """What a lane should hold for the tap at ``pos``: its element, or
        zero outside the sequence."""
        inside = (pos >= 0) & (pos < L)
        return np.where(inside, x[np.clip(pos, 0, L - 1), g], 0.0)

    def load(pos, lanes_that_load=True):
        """load_tap: the lanes whose position ``masked`` lets through
        dereference x there; the others hold zeros."""
        deref = ~masked(pos, L) & lanes_that_load
        assert np.all((pos[deref] >= 0) & (pos[deref] < L)), \
            f"a load at {sorted(set(pos[deref][(pos[deref] < 0) | (pos[deref] >= L)]))}"
        out = np.zeros(32)
        out[deref] = x[pos[deref], g[deref]]
        return out

    def down(v, n):                        # __shfl_down_sync
        src = lanes + n
        return np.where(src < 32, v[np.minimum(src, 31)], v)

    def up(v, n):                          # __shfl_up_sync
        src = lanes - n
        return np.where(src >= 0, v[np.maximum(src, 0)], v)

    stored = np.zeros((L, G), dtype=int)
    for lcta in range(0, L, tconv_gen.WARPS_L * P * S):
        for wl in range(tconv_gen.WARPS_L):
            l = lcta + wl * P * S + p                 # the lane's first output
            row = {}

            def source_row(i):
                return load(l + P * i + spec.sources[0], (i < S) | (p < W - 1))

            if spec.mode == "shuffle":
                for i in range(min(A, S) + 1):
                    row[i] = source_row(i)
            for i in range(S):
                if lcta + P * i >= L:                  # past_end
                    break
                held = {}
                if spec.mode == "shuffle":
                    if i + A + 1 <= S:
                        row[i + A + 1] = source_row(i + A + 1)
                    held[spec.sources[0]] = row[i]
                    for dst, _, d in spec.covered:
                        which, n = corner(d)
                        other = row[i + 1] if which == "next" else row[i]
                        held[dst] = np.where(p + d >= P, up(other, n), down(row[i], G * d))
                else:
                    for off in spec.sources:
                        held[off] = load(l + P * i + off)
                out = l + P * i
                valid = out < L
                for off in range(1 - W, 1):
                    want = tap(out + off)
                    assert np.array_equal(held[off][valid], want[valid]), (i, off)
                np.add.at(stored, (out[valid], g[valid]), 1)
    assert (stored == 1).all(), "an output stored other than once"


def _lengths():
    """The original ragged lengths, then 1, 8S - 1, 8S, 8S + 1 and one
    ragged across CTAs, for the march of S segments."""
    S = tconv_gen.STEPS
    per_cta = tconv_gen.WARPS_L * tconv_gen.POSITIONS * S
    return sorted({1, 5, 8, 13, 37, 8 * S - 1, 8 * S, 8 * S + 1, 2 * per_cta + 37})


@pytest.mark.parametrize("mode, W, L", [
    # the shuffle mode's cases keep their ids "W-L"
    pytest.param(mode, W, L, id=f"{W}-{L}" if mode == "shuffle" else f"{mode}-{W}-{L}")
    for mode in tconv.MODES for W in (3, 4) for L in _lengths()])
def test_warp_replay_of_the_shuffle_schedule(mode, W, L):
    """The march, replayed lane by lane (see :func:`_replay_march`) at
    lengths ragged against the segment, the march and the CTA."""
    _replay_march(tconv.make_spec(mode, W), L)


_RAGGED_L = 2 * tconv_gen.WARPS_L * tconv_gen.POSITIONS * tconv_gen.STEPS + 5


@pytest.mark.parametrize("fault", ["delta", "corner_row", "corner_lane"])
def test_replay_sees_a_wrong_shuffle(fault):
    """The replay is not blind: a schedule whose deltas are one lane off,
    corner taps taken from the current segment's row, or from the next
    row one position off, hand valid lanes another position's tap."""
    spec = tconv.make_spec("shuffle", 4)
    corner = _corner_next
    if fault == "delta":
        spec = replace(spec, covered=tuple((dst, src, d + 1) for dst, src, d in spec.covered))
    elif fault == "corner_row":
        def corner(d):
            return "current", 32 - 4 * d
    else:
        def corner(d):
            return "next", 32 - 4 * d - 4
    with pytest.raises(AssertionError):
        _replay_march(spec, _RAGGED_L, corner)


@pytest.mark.parametrize("side", ["before", "past"])
@pytest.mark.parametrize("mode", tconv.MODES)
def test_replay_sees_a_missing_mask(side, mode):
    """A load without its test of the causal halo (before position 0) or
    of the ragged end (past L) dereferences x outside [0, L), and the
    replay says where."""
    def masked(pos, L):
        return pos >= L if side == "before" else pos < 0

    with pytest.raises(AssertionError, match="a load at"):
        _replay_march(tconv.make_spec(mode, 4), _RAGGED_L, masked=masked)


@pytest.mark.parametrize("case", [
    # (itemsize, C, strides, addresses, want)
    (2, 4352, (1024 * 8512, 8512), (0, 8192), 8),       # Mamba-2's proj columns
    (2, 4224, (1024 * 8384, 8384), (0, 8192), 8),       # Zamba2's
    (2, 4352, (1024 * 4352, 4352), (0,), 8),            # contiguous
    (2, 4352, (8511,), (0,), 1),                        # odd row stride
    (2, 4352, (8514,), (0,), 2),                        # row stride 4 bytes aligned
    (2, 4352, (8516,), (0,), 4),
    (2, 4352, (8512,), (2,), 1),                        # base 2 bytes off
    (2, 4352, (8512,), (8,), 4),
    (2, 4350, (4350,), (0,), 2),                        # C not a multiple of 4
    (4, 4352, (8512,), (0,), 4),
    (4, 77, (77,), (0,), 1),
    (4, 6, (12,), (0, 16), 2),
    (4, 4352, (4352 * 5,), (0, 4), 1),
])
def test_vec_width(case):
    itemsize, C, strides, addresses, want = case
    assert tconv_gen.vec_width(itemsize, C, strides, addresses) == want


def test_plain_reads_a_column_slice():
    """The CPU path takes the strided view the model passes (a column range
    of a wider tensor) and gives what it gives on the same data copied."""
    (_, _, _), (x, w, b) = _inputs((2, 19, 30, 4), np.float32, seed=3)
    wide = torch.nn.functional.pad(x, (5, 7))
    view = wide[..., 5:35]
    assert view.stride() == (19 * 42, 42, 1)
    torch.testing.assert_close(tconv.causal_conv1d(view, w, b),
                               tconv.causal_conv1d(x, w, b), rtol=0, atol=0)


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
