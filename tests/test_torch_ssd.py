"""The port's SSD chunked scan against the JAX package: the plain PyTorch
version against the Pallas kernel (interpret mode), its oracle and the
final state of ``ssd_chunked``; the state carried across chunks."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

from repro.kernels.ssd import ssd_pallas, ssd_ref
from repro.models.mamba2 import ssd_chunked as jax_ssd_chunked
from repro_torch.kernels import ssd as tssd

SHAPES = [(2, 64, 4, 16, 16, 16), (1, 128, 2, 32, 64, 32),
          (2, 96, 3, 8, 16, 32), (1, 64, 2, 16, 16, 64)]
TOL = {np.float32: 1e-4, "bfloat16": 8e-2}     # the reference kernel tests'


def _inputs(B, L, H, P, N, dtype, seed):
    rng = np.random.default_rng(seed)
    host = dict(xh=rng.standard_normal((B, L, H, P)),
                dt=rng.uniform(0.01, 0.2, (B, L, H)),
                A=-rng.uniform(0.5, 2.0, (H,)),
                Bm=rng.standard_normal((B, L, 1, N)),
                Cm=rng.standard_normal((B, L, 1, N)))
    jdt = jnp.float32 if dtype == np.float32 else jnp.bfloat16
    tdt = torch.float32 if dtype == np.float32 else torch.bfloat16
    jx = {k: jnp.asarray(v, jnp.float32 if k in ("dt", "A") else jdt)
          for k, v in host.items()}
    tx = {k: torch.from_numpy(np.array(v, np.float32)).to(
              torch.float32 if k in ("dt", "A") else tdt)
          for k, v in jx.items()}
    return jx, tx


def _args(d):
    return d["xh"], d["dt"], d["A"], d["Bm"], d["Cm"]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_plain_matches_pallas_and_oracle(shape, dtype):
    B, L, H, P, N, Q = shape
    jx, tx = _inputs(B, L, H, P, N, dtype, seed=sum(shape))
    pallas = ssd_pallas(*_args(jx), chunk=Q)
    oracle = ssd_ref(*_args(jx), chunk=Q)
    y, state = tssd.ssd(*_args(tx), chunk=Q)               # CPU: plain version
    assert y.dtype == tx["xh"].dtype and tuple(y.shape) == (B, L, H, P)
    assert state.dtype == torch.float32 and tuple(state.shape) == (B, H, N, P)
    tol = TOL[dtype]
    for want in (pallas, oracle):
        np.testing.assert_allclose(y.float().numpy(), np.asarray(want, np.float32),
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("shape", SHAPES)
def test_final_state_matches_ssd_chunked(shape):
    B, L, H, P, N, Q = shape
    jx, tx = _inputs(B, L, H, P, N, np.float32, seed=7 + sum(shape))
    _, want = jax_ssd_chunked(*_args(jx), Q)
    _, state = tssd.ssd(*_args(tx), chunk=Q)
    np.testing.assert_allclose(state.numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)


def test_state_carries_across_chunks():
    """Single long chunk == many short chunks (y and the final state)."""
    _, tx = _inputs(1, 64, 2, 8, 16, np.float32, seed=3)
    one, s_one = tssd.ssd(*_args(tx), chunk=64)
    many, s_many = tssd.ssd(*_args(tx), chunk=8)
    torch.testing.assert_close(one, many, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(s_one, s_many, rtol=2e-4, atol=2e-4)


def test_equals_the_recurrence():
    """The chunked scan against the token-by-token recurrence."""
    B, L, H, P, N = 2, 24, 3, 4, 8
    _, tx = _inputs(B, L, H, P, N, np.float32, seed=5)
    xh, dt, A, Bm, Cm = _args(tx)
    h = torch.zeros(B, H, N, P)
    ys = []
    for t in range(L):
        h = (h * torch.exp(dt[:, t] * A)[:, :, None, None]
             + torch.einsum("bn,bhp->bhnp", Bm[:, t, 0], xh[:, t] * dt[:, t, :, None]))
        ys.append(torch.einsum("bn,bhnp->bhp", Cm[:, t, 0], h))
    y, state = tssd.ssd(xh, dt, A, Bm, Cm, chunk=8)
    torch.testing.assert_close(y, torch.stack(ys, 1), rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(state, h, rtol=1e-4, atol=1e-4)


def test_chunk_must_divide_the_sequence():
    _, tx = _inputs(1, 24, 2, 4, 8, np.float32, seed=6)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        tssd.ssd(*_args(tx), chunk=16)


# The bf16 tensor-core instance on the card splits the scan into three
# passes (chunk states, state passing, chunk scan) and rounds each float32
# operand of a bf16 product; its plain version here does the same.
TC_SHAPES = SHAPES + [(1, 256, 2, 64, 64, 64), (1, 512, 2, 64, 128, 256)]


@pytest.mark.parametrize("shape", TC_SHAPES)
def test_three_passes_match_pallas_and_oracle(shape):
    """The three-pass split in float32, unrounded: y against the Pallas
    kernel (interpret mode) and its oracle, the final state against
    ``ssd_chunked``, at the reference's 1e-4."""
    B, L, H, P, N, Q = shape
    jx, tx = _inputs(B, L, H, P, N, np.float32, seed=11 + sum(shape))
    y, state = tssd.ref.ssd_passes(*_args(tx), chunk=Q)
    for want in (ssd_pallas(*_args(jx), chunk=Q), ssd_ref(*_args(jx), chunk=Q)):
        np.testing.assert_allclose(y.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    _, want_state = jax_ssd_chunked(*_args(jx), Q)
    np.testing.assert_allclose(state.numpy(), np.asarray(want_state), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shape", TC_SHAPES)
def test_tensor_core_numerics_match_pallas_and_oracle(shape):
    """The three passes with every operand rounded as the tensor-core
    instance rounds it (w x and g x to bf16; the diagonal scores, C B^T
    below the diagonal and the entering state to bf16 hi + lo), in bf16:
    y against the Pallas kernel and its oracle, the final state against
    ``ssd_chunked``, at the reference's 8e-2."""
    B, L, H, P, N, Q = shape
    jx, tx = _inputs(B, L, H, P, N, "bfloat16", seed=13 + sum(shape))
    y, state = tssd.ref.ssd_passes(*_args(tx), chunk=Q, round_operands=True)
    assert y.dtype == torch.bfloat16 and state.dtype == torch.float32
    for want in (ssd_pallas(*_args(jx), chunk=Q), ssd_ref(*_args(jx), chunk=Q)):
        np.testing.assert_allclose(y.float().numpy(), np.asarray(want, np.float32),
                                   rtol=8e-2, atol=8e-2)
    _, want_state = jax_ssd_chunked(*_args(jx), Q)
    np.testing.assert_allclose(state.numpy(), np.asarray(want_state, np.float32),
                               rtol=8e-2, atol=8e-2)


def test_instance_selection():
    """bf16 with P 64, N 64 or 128, a chunk that is a multiple of 64 up to
    256 and aligned x, B, C take the tensor cores; the rest the CUDA cores."""
    def t(shape, dtype=torch.bfloat16):
        return torch.zeros(shape, dtype=dtype)

    xh = t((2, 512, 4, 64))
    for N in (64, 128):
        Bm = t((2, 512, 1, N))
        for chunk in (64, 128, 192, 256):
            assert tssd.select_instance(xh, Bm, Bm, chunk) == "tensor_core"
        for chunk in (32, 96, 512):
            assert tssd.select_instance(xh, Bm, Bm, chunk) == "cuda_core"
        assert tssd.select_instance(xh.float(), Bm.float(), Bm.float(), 256) == "cuda_core"
    assert tssd.select_instance(xh, t((2, 512, 1, 32)), t((2, 512, 1, 32)), 256) == "cuda_core"
    assert tssd.select_instance(t((2, 512, 4, 32)), t((2, 512, 1, 128)),
                                t((2, 512, 1, 128)), 256) == "cuda_core"
    # x, B and C as slices of one projection, as the model passes them
    conv = t((2, 512, 4 * 64 + 2 * 128))
    x_v = conv[..., :256].view(2, 512, 4, 64)
    B_v = conv[..., 256:384].view(2, 512, 1, 128)
    C_v = conv[..., 384:].view(2, 512, 1, 128)
    assert tssd.select_instance(x_v, B_v, C_v, 256) == "tensor_core"
    odd = t((2, 512, 1, 132))[..., 4:]                  # 8-byte offset
    assert tssd.select_instance(xh, odd, odd, 256) == "cuda_core"


def test_rounded_check_sees_a_dropped_lo_half(monkeypatch):
    """The card's tight check of the tensor-core instance
    (``instances.check_rounded`` against ``ssd_passes(round_operands=True)``'s
    float32 result) passes that version's own bf16 result and the unrounded
    plain version, and fails a version that drops the lo half of the
    operands the instance splits into bf16 hi + lo: an error below the
    reference's 8e-2 at |y| of up to about 25."""
    from repro_torch.kernels.instances import check_rounded

    _, tx = _inputs(1, 512, 4, 64, 128, "bfloat16", seed=17)
    x, dt, A, Bm, Cm = _args(tx)
    want_y, want_state = tssd.ref.ssd_passes(x.float(), dt, A, Bm.float(), Cm.float(),
                                             256, round_operands=True)
    assert check_rounded("rounded", want_y.to(torch.bfloat16), want_y)["norm_ratio"] == 1.0
    y, state = tssd.ref.ssd_chunked(x, dt, A, Bm, Cm, 256)
    check_rounded("unrounded y", y, want_y)
    check_rounded("unrounded state", state, want_state)
    monkeypatch.setattr(tssd.ref, "_split", tssd.ref._bf16)
    y, _ = tssd.ref.ssd_passes(x, dt, A, Bm, Cm, 256, round_operands=True)
    np.testing.assert_allclose(y.float().numpy(), want_y.numpy(), rtol=8e-2, atol=8e-2)
    with pytest.raises(AssertionError, match="bf16 ulps"):
        check_rounded("hi only", y, want_y)


# (B, L, H, P, N, chunk, groups): one chunk and several, P and N apart,
# two B/C groups, and the tensor-core instance's widths at chunk 64
BWD_SHAPES = [(1, 16, 2, 4, 8, 16, 1), (2, 48, 3, 8, 4, 16, 1), (2, 64, 4, 16, 16, 32, 2),
              (1, 96, 2, 8, 16, 32, 1), (1, 192, 2, 64, 128, 64, 1)]


@pytest.mark.parametrize("shape", BWD_SHAPES)
@pytest.mark.parametrize("final", [False, True], ids=["no_final", "final"])
def test_passes_bwd_matches_autograd(shape, final):
    """The backward in the CUDA kernels' factoring (``ref.ssd_passes_bwd``)
    against autograd of ``ssd_chunked`` in float32, from y's cotangent and,
    with ``final``, the final state's too: every gradient within 1e-5 of
    its largest element (the two sum in other orders)."""
    B, L, H, P, N, Q, G = shape
    rng = np.random.default_rng(sum(shape) + final)

    def t(*s, lo=None, hi=None):
        a = rng.standard_normal(s) if lo is None else rng.uniform(lo, hi, s)
        return torch.from_numpy(a.astype(np.float32))

    inputs = (t(B, L, H, P), t(B, L, H, lo=0.01, hi=0.2), -t(H, lo=0.5, hi=2.0),
              t(B, L, G, N), t(B, L, G, N))
    dy, d_final = t(B, L, H, P), (t(B, H, N, P) if final else None)
    leaves = [v.clone().requires_grad_() for v in inputs]
    y, state = tssd.ref.ssd_chunked(*leaves, Q)
    want = torch.autograd.grad([y, state] if final else [y], leaves,
                               [dy, d_final] if final else [dy])
    got = tssd.ref.ssd_passes_bwd(*inputs, Q, dy, d_final)
    for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC"), got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5 * float(w.abs().max()),
                                   msg=lambda m, n=name: f"{n}: {m}")


@pytest.mark.parametrize("shape", BWD_SHAPES[2:])
def test_passes_bwd_rounded_stays_near_unrounded(shape):
    """With every operand rounded as the CUDA backward rounds it (w x in
    the chunk states to one bf16, the rest to bf16 hi + lo), each gradient
    stays within 1e-2 of its largest element of the unrounded one: the
    one-bf16 rounding of w x (2^-9 relative a term) is the largest change,
    and it reaches the gradients only through the entering states."""
    B, L, H, P, N, Q, G = shape
    rng = np.random.default_rng(sum(shape))

    def t(*s, lo=None, hi=None):
        a = rng.standard_normal(s) if lo is None else rng.uniform(lo, hi, s)
        return torch.from_numpy(a.astype(np.float32))

    inputs = (t(B, L, H, P), t(B, L, H, lo=0.01, hi=0.2), -t(H, lo=0.5, hi=2.0),
              t(B, L, G, N), t(B, L, G, N))
    dy, d_final = t(B, L, H, P), t(B, H, N, P)
    want = tssd.ref.ssd_passes_bwd(*inputs, Q, dy, d_final)
    got = tssd.ref.ssd_passes_bwd(*inputs, Q, dy, d_final, round_operands=True)
    for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC"), got, want):
        assert not torch.equal(g, w), name
        torch.testing.assert_close(g, w, rtol=0, atol=1e-2 * float(w.abs().max()),
                                   msg=lambda m, n=name: f"{n}: {m}")
