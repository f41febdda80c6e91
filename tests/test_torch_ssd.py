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
