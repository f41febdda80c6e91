"""The port's attention, rotary embeddings and MLP against the JAX
package on the CPU (``src/repro/models/{attention,common,mlp}.py``): the
same numpy-made parameters and inputs go through both, float32."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import mlp as jmlp
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import mlp as tmlp

# float32 on both sides: the two agree to float32 rounding (~1e-7 on
# values of magnitude 1); 1e-5 leaves room for summation order.
TOL = dict(rtol=1e-5, atol=1e-5)


def _both(rng, shape, scale=1.0):
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x.copy())


def _params(rng, cfg):
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    shapes = {"wq": (d, h, hd), "wk": (d, kv, hd), "wv": (d, kv, hd), "wo": (h, hd, d)}
    pairs = {n: _both(rng, s, 0.2) for n, s in shapes.items()}
    return ({n: j for n, (j, _) in pairs.items()}, {n: t for n, (_, t) in pairs.items()})


def _close(got, want, **tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **(tol or TOL))


CFGS = [jattn.AttnConfig(d_model=32, n_heads=4, n_kv_heads=2, head_dim=8,
                         q_block=16, kv_block=16),
        jattn.AttnConfig(d_model=48, n_heads=3, n_kv_heads=3, head_dim=16,
                         rope_theta=0.0, q_block=8, kv_block=16)]


def _tcfg(cfg):
    return tattn.AttnConfig(**cfg._asdict())


@pytest.mark.parametrize("theta", [1e4, 5e5])
def test_rope_matches_reference(theta):
    rng = np.random.default_rng(0)
    jx, tx = _both(rng, (2, 11, 3, 16))
    pos = rng.integers(0, 4000, (2, 11))
    _close(tcommon.rope_frequencies(16, theta), jcommon.rope_frequencies(16, theta))
    got = tcommon.apply_rope(tx, torch.from_numpy(pos), theta)
    _close(got, jcommon.apply_rope(jx, jnp.asarray(pos), theta))


def test_rope_keeps_dtype_and_rotates_by_position():
    x = torch.ones(1, 2, 1, 4, dtype=torch.bfloat16)
    out = tcommon.apply_rope(x, torch.tensor([[0, 1]]))
    assert out.dtype == torch.bfloat16
    assert torch.equal(out[0, 0], x[0, 0])            # position 0 is the identity


@pytest.mark.parametrize("cfg", CFGS, ids=["gqa-rope", "mha-norope"])
def test_qkv_matches_reference(cfg):
    rng = np.random.default_rng(1)
    jp, tp = _params(rng, cfg)
    jx, tx = _both(rng, (2, 9, cfg.d_model))
    pos = np.broadcast_to(np.arange(9), (2, 9))
    want = jattn.qkv(jp, jx, jnp.asarray(pos), cfg)
    got = tattn.qkv(tp, tx, torch.from_numpy(pos.copy()), _tcfg(cfg))
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("shape", [(2, 20, 20, 4, 2, 8, True, 0),
                                   (1, 7, 30, 2, 1, 16, True, 23),
                                   (2, 33, 40, 4, 4, 8, False, 0)])
def test_naive_and_blockwise_match_reference(shape):
    """Ragged against the blocks of 16, GQA, a query offset (prefill
    continuation) and a non-causal call."""
    B, Sq, Sk, H, KV, Dh, causal, off = shape
    rng = np.random.default_rng(sum(shape))
    jq, tq = _both(rng, (B, Sq, H, Dh))
    jk, tk = _both(rng, (B, Sk, KV, Dh))
    jv, tv = _both(rng, (B, Sk, KV, Dh))
    cfg = jattn.AttnConfig(d_model=H * Dh, n_heads=H, n_kv_heads=KV, head_dim=Dh,
                           causal=causal, q_block=16, kv_block=16)
    _close(tattn.naive_attention(tq, tk, tv, _tcfg(cfg), q_offset=off),
           jattn.naive_attention(jq, jk, jv, cfg, q_offset=off))
    _close(tattn.blockwise_attention(tq, tk, tv, _tcfg(cfg), q_offset=off),
           jattn.blockwise_attention(jq, jk, jv, cfg, q_offset=off))


@pytest.mark.parametrize("cfg", CFGS, ids=["gqa-rope", "mha-norope"])
def test_prefill_attention_matches_reference(cfg):
    rng = np.random.default_rng(2)
    jp, tp = _params(rng, cfg)
    jx, tx = _both(rng, (2, 21, cfg.d_model))
    jout, (jk, jv) = jattn.prefill_attention(jp, jx, cfg)
    out, (k, v) = tattn.prefill_attention(tp, tx, _tcfg(cfg))
    _close(out, jout)
    _close(k, jk)
    _close(v, jv)


@pytest.mark.parametrize("cfg", CFGS, ids=["gqa-rope", "mha-norope"])
def test_decode_attention_matches_reference(cfg):
    """One token per row at different positions in the middle of a
    partly filled cache; the new k/v land at ``pos``."""
    rng = np.random.default_rng(3)
    jp, tp = _params(rng, cfg)
    S = 24
    jck, tck = _both(rng, (3, S, cfg.n_kv_heads, cfg.head_dim))
    jcv, tcv = _both(rng, (3, S, cfg.n_kv_heads, cfg.head_dim))
    jx, tx = _both(rng, (3, 1, cfg.d_model))
    pos = np.array([5, 11, 17], np.int32)
    jout, (jk2, jv2) = jattn.decode_attention(jp, jx, (jck, jcv), jnp.asarray(pos), cfg)
    out, (k2, v2) = tattn.decode_attention(tp, tx, (tck, tcv), torch.from_numpy(pos),
                                           _tcfg(cfg))
    _close(out, jout)
    _close(k2, jk2)
    _close(v2, jv2)
    assert k2.data_ptr() == tck.data_ptr()            # written in place


def test_init_attention_shapes_match_reference():
    import jax

    cfg = CFGS[0]
    want = jcommon.unbox(jattn.init_attention(jax.random.PRNGKey(0), cfg))
    got = tattn.init_attention(torch.Generator().manual_seed(0), _tcfg(cfg))
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}


@pytest.mark.parametrize("kind", ["swiglu", "gelu"])
def test_apply_mlp_matches_reference(kind):
    rng = np.random.default_rng(4)
    names = {"w_up": (16, 40), "w_down": (40, 16)}
    if kind == "swiglu":
        names["w_gate"] = (16, 40)
    pairs = {n: _both(rng, s, 0.3) for n, s in names.items()}
    jx, tx = _both(rng, (2, 5, 16))
    want = jmlp.apply_mlp({n: j for n, (j, _) in pairs.items()}, jx, kind)
    got = tmlp.apply_mlp({n: t for n, (_, t) in pairs.items()}, tx, kind)
    _close(got, want)
    init = tmlp.init_mlp(torch.Generator().manual_seed(0), 16, 40, kind)
    assert {k: tuple(v.shape) for k, v in init.items()} == names
