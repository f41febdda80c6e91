"""The port's flash attention on the CPU against the JAX package: the plain
PyTorch version (the CPU path of ``flash_attention``) against the JAX
oracle ``attention_ref`` and the Pallas kernel in interpret mode, at the
reference kernel tests' shapes, dtypes and tolerances; plus the
reference's shape contract."""

import jax.numpy as jnp
import numpy as np
import pytest

try:
    from hypothesis import given, settings, strategies as st
except ImportError:               # degrade: property tests skip
    from _hypothesis_stub import given, settings, st

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

from repro.kernels.flash_attention import attention_ref as jax_attention_ref
from repro.kernels.flash_attention import flash_attention as jax_flash_attention
from repro_torch.kernels import flash_attention as tfa

# (B, Sq, Sk, H, KV, Dh, causal): tests/test_kernels.py's shapes
SHAPES = [(2, 64, 64, 4, 2, 16, True), (1, 100, 100, 4, 4, 8, True),
          (2, 64, 64, 8, 2, 16, False), (1, 33, 33, 2, 1, 32, True),
          (2, 48, 96, 4, 1, 16, True)]
TOL = {"float32": 2e-5, "bfloat16": 6e-2}      # the reference kernel tests'


def _inputs(B, Sq, Sk, H, KV, Dh, dtype, seed):
    """The same values for both packages: numpy draws rounded to the JAX
    dtype, then carried over exactly (bfloat16 through float32)."""
    rng = np.random.default_rng(seed)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    shapes = ((B, Sq, H, Dh), (B, Sk, KV, Dh), (B, Sk, KV, Dh))
    jx = [jnp.asarray(rng.standard_normal(s), jdt) for s in shapes]
    tx = [torch.from_numpy(np.array(a, np.float32)).to(tdt) for a in jx]
    return jx, tx


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_oracle_and_pallas(shape, dtype):
    B, Sq, Sk, H, KV, Dh, causal = shape
    (jq, jk, jv), (q, k, v) = _inputs(B, Sq, Sk, H, KV, Dh, dtype, seed=sum(shape))
    out = tfa.flash_attention(q, k, v, causal=causal)      # CPU: plain version
    assert out.dtype == q.dtype and tuple(out.shape) == (B, Sq, H, Dh)
    oracle = jax_attention_ref(jq, jk, jv, causal=causal)
    pallas = jax_flash_attention(jq, jk, jv, causal=causal, block_q=16, block_k=16)
    for want in (oracle, pallas):
        _close(out, want, TOL[dtype])


@settings(max_examples=8, deadline=None, database=None)
@given(st.integers(1, 3), st.integers(17, 80), st.integers(1, 2),
       st.sampled_from([8, 16]))
def test_plain_matches_pallas_property(B, S, KV, Dh):
    """The reference's property sweep (tests/test_kernels.py:131-142), in
    both dtypes: 3e-5 in float32 as there, 6e-2 in bfloat16."""
    H = KV * 2
    for dtype, tol in (("float32", 3e-5), ("bfloat16", 6e-2)):
        (jq, jk, jv), (q, k, v) = _inputs(B, S, S, H, KV, Dh, dtype,
                                          seed=B * 1000 + S * 10 + KV + Dh)
        want = jax_flash_attention(jq, jk, jv, causal=True, block_q=16, block_k=16)
        _close(tfa.flash_attention(q, k, v, causal=True), want, tol)
        _close(tfa.flash_attention(q, k, v, causal=True),
               jax_attention_ref(jq, jk, jv, causal=True), tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_more_queries_than_ragged_keys_follows_the_oracle(dtype):
    """Sq = 40 > Sk = 20, causal.  Held against the JAX oracle only: the
    Pallas kernel pads Sk to its block with zero keys and lets the causal
    mask pass them for queries at positions >= Sk, so it departs from its
    own oracle there (by 0.18 on these inputs, float32, block 16).  The
    port masks keys at or past Sk, as the oracle does."""
    (jq, jk, jv), (q, k, v) = _inputs(1, 40, 20, 2, 1, 8, dtype, seed=40)
    out = tfa.flash_attention(q, k, v, causal=True)
    _close(out, jax_attention_ref(jq, jk, jv, causal=True), TOL[dtype])


def test_non_causal_ragged_keys_are_refused():
    """The reference asserts Sk % block_k == 0 for a non-causal call
    (flash_attention.py:98); the port refuses Sk ragged against its key
    tile, on the CPU as on the card."""
    (jq, jk, jv), (q, k, v) = _inputs(1, 16, 100, 2, 1, 8, "float32", seed=0)
    with pytest.raises(AssertionError):
        jax_flash_attention(jq, jk, jv, causal=False, block_q=16, block_k=16)
    with pytest.raises(ValueError, match="non-causal"):
        tfa.flash_attention(q, k, v, causal=False)
    (_, jk2, jv2), (_, k2, v2) = _inputs(1, 16, 2 * tfa.KEY_TILE, 2, 1, 8,
                                         "float32", seed=1)
    out = tfa.flash_attention(q, k2, v2, causal=False)
    _close(out, jax_attention_ref(jq, jk2, jv2, causal=False), TOL["float32"])


def test_shape_contract():
    _, (q, k, v) = _inputs(1, 8, 8, 3, 2, 8, "float32", seed=2)
    with pytest.raises(ValueError, match="multiple"):
        tfa.flash_attention(q, k, v)
    _, (q, k, v) = _inputs(1, 8, 8, 4, 2, 8, "float32", seed=3)
    with pytest.raises(ValueError, match="do not agree"):
        tfa.flash_attention(q, k, v[..., :4])


def test_cpu_path_launches_nothing():
    _, (q, k, v) = _inputs(2, 24, 24, 4, 2, 16, "float32", seed=4)
    before = tfa.launch_counts()
    out = tfa.flash_attention(q, k, v)
    assert torch.equal(out, tfa.ref.attention_ref(q, k, v))
    assert tfa.launch_counts() == before


# The bf16 tensor-core instance on the card walks its own key tiles and
# rounds P to bf16 before P V; its plain version here does the same.
TC_SHAPES = [s for s in SHAPES if s[5] in tfa.TENSOR_CORE_HEAD_DIMS] + [
    (1, 40, 20, 2, 1, 16, True), (2, 200, 200, 8, 2, 128, True), (1, 130, 250, 4, 1, 64, True)]


@pytest.mark.parametrize("shape", TC_SHAPES)
def test_tensor_core_numerics_match_oracle_and_pallas(shape):
    """The tensor-core instance's plain version (its key tile, P rounded to
    bf16) against the JAX oracle and the Pallas kernel in interpret mode, in
    bf16 at the reference's 6e-2; its algebra in float32 at 2e-5.  The
    Pallas kernel is left out where Sq exceeds a ragged Sk (it pads keys
    that its causal mask lets in; see the test above)."""
    B, Sq, Sk, H, KV, Dh, causal = shape
    tile = tfa.TENSOR_CORE_KEY_TILE[Dh]
    (jq, jk, jv), (q, k, v) = _inputs(B, Sq, Sk, H, KV, Dh, "bfloat16", seed=sum(shape))
    out = tfa.ref.attention_tiled(q, k, v, causal, key_tile=tile, round_p=True)
    assert out.dtype == q.dtype and tuple(out.shape) == (B, Sq, H, Dh)
    wants = [jax_attention_ref(jq, jk, jv, causal=causal)]
    if Sq <= Sk:
        wants.append(jax_flash_attention(jq, jk, jv, causal=causal, block_q=16, block_k=16))
    for want in wants:
        _close(out, want, TOL["bfloat16"])
    (jq, jk, jv), (q, k, v) = _inputs(B, Sq, Sk, H, KV, Dh, "float32", seed=sum(shape))
    _close(tfa.ref.attention_tiled(q, k, v, causal, key_tile=tile),
           jax_attention_ref(jq, jk, jv, causal=causal), TOL["float32"])


def test_instance_selection():
    """bf16 with Dh 16-128 and operands a bulk tensor copy can read take the
    tensor cores; float32, Dh 8, and unaligned layouts the CUDA cores."""
    def t(shape, dtype=torch.bfloat16):
        return torch.zeros(shape, dtype=dtype)

    for Dh in (16, 32, 64, 128):
        q, kv = t((2, 8, 4, Dh)), t((2, 8, 2, Dh))
        assert tfa.select_instance(q, kv, kv) == "tensor_core"
        assert tfa.select_instance(q.float(), kv.float(), kv.float()) == "cuda_core"
    q8, kv8 = t((2, 8, 4, 8)), t((2, 8, 2, 8))
    assert tfa.select_instance(q8, kv8, kv8) == "cuda_core"
    q, kv = t((2, 8, 4, 64)), t((2, 8, 2, 64))
    assert tfa.select_instance(q[:, 2:], kv[:, 2:], kv[:, 2:]) == "tensor_core"
    buf = t((2 * 8 * 260 + 4,))
    odd = buf.as_strided((2, 8, 4, 64), (8 * 260, 260, 64, 1))      # 520-byte rows
    assert tfa.select_instance(odd, kv, kv) == "cuda_core"
    shifted = buf[4:4 + q.numel()].view(q.shape)                    # 8-byte offset
    assert tfa.select_instance(shifted, kv, kv) == "cuda_core"


def test_rounded_check_fails_a_fault_the_reference_tolerance_passes():
    """At a long causal sequence |o| is about 0.05-0.15, so the reference's
    bf16 tolerance (6e-2) passes an output whose later rows are 10 % off.
    The card's tight check of the tensor-core instance
    (``instances.check_rounded`` against ``attention_tiled(round_p=True)``'s
    float32 result) fails it and passes that version's own bf16 result."""
    from repro_torch.kernels.instances import ROUNDED_ULPS, check_rounded, rounded_agreement

    _, (q, k, v) = _inputs(1, 512, 512, 4, 4, 64, "bfloat16", seed=19)
    want = tfa.ref.attention_tiled(q.float(), k.float(), v.float(), True,
                                   key_tile=tfa.TENSOR_CORE_KEY_TILE[64], round_p=True)
    r = check_rounded("rounded", want.to(torch.bfloat16), want)
    assert r["norm_ratio"] == 1.0 and r["ulps"] <= 0.5
    bad = want.clone()
    bad[:, 256:] *= 1.1
    bad = bad.to(torch.bfloat16)
    ref = tfa.ref.attention_ref(q, k, v)
    torch.testing.assert_close(bad.float(), ref.float(), rtol=TOL["bfloat16"],
                               atol=TOL["bfloat16"])
    assert rounded_agreement(bad, want)["ulps"] > 2 * ROUNDED_ULPS
    with pytest.raises(AssertionError, match="bf16 ulps"):
        check_rounded("late rows 10 % off", bad, want)


def test_rounded_agreement_counts_bf16_ulps():
    """Errors in bf16 ulps (8 significant bits) of max(|x|, its row's rms)."""
    from repro_torch.kernels.instances import rounded_agreement

    want = torch.tensor([[1.0, -1.0, 1.0, -1.0], [4.0, 0.0, 0.0, 0.0]])
    # row 1: |x| = rms = 1; row 2: rms 2, so the zeros are measured at 2
    ulp = torch.tensor([[2.0 ** -7] * 4, [2.0 ** -5, 2.0 ** -6, 2.0 ** -6, 2.0 ** -6]])
    for n in (1.0, 3.0):
        assert rounded_agreement(want + n * ulp, want)["ulps"] == pytest.approx(n)
    assert rounded_agreement(want + 0.5 * ulp[:, :1], want)["ulps"] == pytest.approx(1.0)
    assert rounded_agreement(want, want) == {"ulps": 0.0, "norm_ratio": 0.0}
