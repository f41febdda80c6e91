"""The CUDA kernels on the card (stencil, conv1d, SSD, flash attention; the
SSD and flash attention in both their instances, bf16 tensor cores and
CUDA cores) and the Mamba-2, Zamba2 and dense-transformer serving paths,
against their plain PyTorch versions.  Imports only torch
and the port, so it runs where JAX is not installed:  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
Every test here skips without a CUDA device."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

from repro_torch.build import sass_counts
from repro_torch.configs import get_config, reduced
from repro_torch.core.frontend.kernelgen import get_bench
from repro_torch.interop import arrays_from_numpy
from repro_torch.kernels import conv1d as tconv
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ssd as tssd
from repro_torch.kernels.instances import check_rounded
from repro_torch.models import build_model
from repro_torch.kernels.stencil import (
    MARCH,
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


def _shape(prog, case):
    """A ragged full shape: ``wide``, or an interior whose march is 1,
    R - 1 or R + 1 outputs long (R outputs per thread) over 31 or 33
    lanes along i."""
    nd, R = prog.ndim, MARCH[prog.ndim]
    if case == "wide":
        return {1: (100_003,), 2: (133, 517), 3: (13, 37, 261)}[nd]
    outer, wi = {"1x31": (1, 31), "R-1x33": (R - 1, 33), "R+1x31": (R + 1, 31),
                 "R+1x33": (R + 1, 33)}[case]
    interior = {1: (wi,), 2: (outer, wi), 3: (outer, 11, wi)}[nd]
    return tuple(n + 2 * h for n, h in zip(interior, reversed(prog.halo)))


CASES = ["wide", "1x31", "R-1x33", "R+1x31", "R+1x33"]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("name", STENCIL_BENCHES)
def test_kernels_match_plain(cuda_device, name, case):
    """Each mode's kernel against the plain version at a ragged shape,
    and the three modes bitwise equal."""
    b = get_bench(name)
    prog = b.program
    shape = _shape(prog, case)
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


@pytest.mark.parametrize("name,shape", [
    ("gaussblur", (5, 5)), ("gaussblur", (6, 37)), ("gaussblur", (40, 70)),
    *[(n, c) for n in ("gaussblur", "tricubic") for c in CASES[1:]]])
@pytest.mark.parametrize("mode", MODES)
def test_entry_point_small_and_ragged(cuda_device, name, shape, mode):
    """Interiors narrower than a warp or a CTA, and marches ragged along
    the outer axis, through ``stencil_apply``."""
    prog = get_bench(name).program
    if isinstance(shape, str):
        shape = _shape(prog, shape)
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


# ---------------------------------------------------------------------------
# conv1d and SSD (the Mamba-2 serving path)
# ---------------------------------------------------------------------------

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
CONV_TOL = {"float32": 1e-5, "bfloat16": 5e-2}     # the reference's
SSD_TOL = {"float32": 1e-4, "bfloat16": 8e-2}      # the reference's


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return "cuda"


def _randn(shape, dtype, rng, scale=1.0):
    return torch.from_numpy(
        (rng.standard_normal(shape) * scale).astype(np.float32)).to("cuda", dtype)


_MARCH = tconv.conv1d.STEPS * tconv.conv1d.POSITIONS   # positions per warp's march


@pytest.mark.parametrize("shape", [(2, 1000, 4352, 4), (3, 37, 77, 4),
                                   (1, 129, 200, 3), (4, 16, 6, 4), (1, 5, 24, 4),
                                   (3, 1, 77, 4), (2, _MARCH - 1, 200, 4),
                                   (2, _MARCH + 1, 136, 3)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_conv1d_kernels_match_plain(card, shape, dtype):
    """Both modes against the plain version at ragged L and C (and C that
    forces narrower vectors); bitwise equal to each other, and to the
    plain version without the SiLU."""
    B, L, C, W = shape
    rng = np.random.default_rng(sum(shape))
    x = _randn((B, L, C), DTYPES[dtype], rng)
    w = _randn((W, C), DTYPES[dtype], rng)
    b = _randn((C,), DTYPES[dtype], rng)
    kernels = tconv.build_kernels([(m, W) for m in tconv.MODES])
    want = tconv.ref.causal_conv1d(x, w, b)
    outs = []
    for k in kernels:
        before = k.launches
        outs.append(k(x, w, b))
        assert k.launches == before + 1
    torch.cuda.synchronize()
    tol = CONV_TOL[dtype]
    for out in outs:
        torch.testing.assert_close(out.float(), want.float(), rtol=tol, atol=tol)
    assert torch.equal(outs[0], outs[1])
    linear = [k(x, w, b, activation=False) for k in kernels]
    plain = tconv.ref.causal_conv1d(x, w, b, activation=False)
    assert torch.equal(linear[0], plain) and torch.equal(linear[1], plain)


def test_conv1d_wrapper_rejects_bad_inputs(card):
    (k,) = tconv.build_kernels([("shuffle", 4)])
    rng = np.random.default_rng(0)
    x = _randn((2, 16, 8), torch.float32, rng)
    w = _randn((4, 8), torch.float32, rng)
    b = _randn((8,), torch.float32, rng)
    with pytest.raises(TypeError):
        k(x.double(), w.double(), b.double())
    with pytest.raises(TypeError):
        k(x, w.bfloat16(), b)
    with pytest.raises(ValueError, match="contiguous channels"):
        k(_randn((2, 16, 16), torch.float32, rng)[..., ::2], w, b)   # last stride 2
    with pytest.raises(ValueError):
        k(x.transpose(1, 2), w, b)
    with pytest.raises(ValueError):
        k(x.cpu(), w, b)
    with pytest.raises(ValueError):
        k(x, w[:3], b)
    with pytest.raises(ValueError):
        k(x, w.t().contiguous().t(), b)


@pytest.mark.parametrize("pad", [(4096, 64), (4096, 65), (4097, 63)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_conv1d_reads_a_column_slice_in_place(card, pad, dtype):
    """Both modes on x as a column range of a wider tensor, as the model
    passes its in-projection: bitwise equal to the same data made
    contiguous.  (4096, 64) keeps the row stride and the base 16-byte
    aligned; (4096, 65) makes the row stride odd and (4097, 63) the base,
    so the kernel takes narrower vectors."""
    left, right = pad
    B, L, C, W = 2, 2 * _MARCH + 5, 456, 4
    rng = np.random.default_rng(left)
    wide = _randn((B, L, left + C + right), DTYPES[dtype], rng)
    view = wide[..., left:left + C]
    assert view.stride() == (L * (left + C + right), left + C + right, 1)
    w = _randn((W, C), DTYPES[dtype], rng)
    b = _randn((C,), DTYPES[dtype], rng)
    dense = view.contiguous()
    for k in tconv.build_kernels([(m, W) for m in tconv.MODES]):
        got, want = k(view, w, b), k(dense, w, b)
        torch.cuda.synchronize()
        assert torch.equal(got, want), k.symbol
        assert got.is_contiguous()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_conv1d_at_zamba2_7b_width(card, dtype):
    """Zamba2-7B's 7,424 channels (x 7168 and two groups of B and C of 64)
    read in place from its 14,704-wide in-projection at column 7168, as the
    mixer passes them: both modes against the plain version, bitwise equal
    to each other and to the same data made contiguous."""
    B, L, C, W = 2, 1024, 7424, 4
    rng = np.random.default_rng(7424)
    proj = _randn((B, L, 14704), DTYPES[dtype], rng)
    x = proj[..., 7168:7168 + C]
    w = _randn((W, C), DTYPES[dtype], rng, 0.5)
    b = _randn((C,), DTYPES[dtype], rng, 0.5)
    want = tconv.ref.causal_conv1d(x, w, b)
    outs = [k(x, w, b) for k in tconv.build_kernels([(m, W) for m in tconv.MODES])]
    torch.cuda.synchronize()
    tol = CONV_TOL[dtype]
    for out in outs:
        torch.testing.assert_close(out.float(), want.float(), rtol=tol, atol=tol)
    assert torch.equal(outs[0], outs[1])
    assert torch.equal(outs[0], tconv.build_kernels([("shuffle", W)])[0](x.contiguous(), w, b))


def _ssd_inputs(B, L, H, P, N, dtype, seed, G=1):
    rng = np.random.default_rng(seed)
    xh = _randn((B, L, H, P), dtype, rng)
    dt = torch.from_numpy(rng.uniform(0.01, 0.2, (B, L, H)).astype(np.float32)).cuda()
    A = -torch.from_numpy(rng.uniform(0.5, 2.0, (H,)).astype(np.float32)).cuda()
    return xh, dt, A, _randn((B, L, G, N), dtype, rng), _randn((B, L, G, N), dtype, rng)


def _ssd_rounded(y, state, xh, dt, A, Bm, Cm, chunk):
    """A tensor-core result against the float32 result of the plain version
    that rounds what the tensor cores round, at a few bf16 ulps of each
    row's scale (``instances.check_rounded``)."""
    want_y, want_state = tssd.ref.ssd_passes(xh.float(), dt, A, Bm.float(), Cm.float(),
                                             chunk, round_operands=True)
    check_rounded("ssd y", y, want_y)
    check_rounded("ssd state", state, want_state)


@pytest.mark.parametrize("shape", [(2, 64, 4, 16, 16, 16), (1, 128, 2, 32, 64, 32),
                                   (2, 96, 3, 8, 16, 32), (1, 64, 2, 16, 16, 64),
                                   (2, 512, 3, 64, 128, 256), (1, 384, 2, 12, 20, 96),
                                   (2, 512, 3, 64, 64, 64), (2, 512, 3, 64, 64, 256),
                                   (1, 512, 4, 64, 128, 64), (1, 768, 5, 64, 128, 192)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_ssd_kernel_matches_plain(card, shape, dtype):
    """y and the final state against the plain version, at the reference
    test's shapes, the model's (P 64, N 128, chunk 256), a ragged one, and
    the tensor-core instance's (P 64, N 64 and 128, chunks 64 to 256 over
    several chunks); each call on the instance the selection names, bf16 at
    P 64 on the tensor cores, and there also held against the plain version
    that rounds what it rounds."""
    B, L, H, P, N, Q = shape
    args = _ssd_inputs(B, L, H, P, N, DTYPES[dtype], sum(shape))
    k = tssd.build_kernel()
    instance = tssd.select_instance(args[0], args[3], args[4], Q)
    assert (instance == "tensor_core") == (dtype == "bfloat16" and P == 64 and Q % 64 == 0
                                           and N in (64, 128))
    before, before_i = k.launches, dict(k.instance_launches)
    y, state = tssd.ssd(*args, chunk=Q)
    torch.cuda.synchronize()
    assert k.launches == before + 1
    assert {i: n - before_i[i] for i, n in k.instance_launches.items()} == {
        i: int(i == instance) for i in tssd.INSTANCES}
    want_y, want_state = tssd.ref.ssd_chunked(*args, chunk=Q)
    tol = SSD_TOL[dtype]
    torch.testing.assert_close(y.float(), want_y.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(state, want_state, rtol=tol, atol=tol)
    if instance == "tensor_core":
        _ssd_rounded(y, state, *args, Q)


def test_ssd_kernel_chunk_8_equals_64(card):
    args = _ssd_inputs(1, 64, 2, 8, 16, torch.float32, 3)
    one, s_one = tssd.ssd(*args, chunk=64)
    many, s_many = tssd.ssd(*args, chunk=8)
    torch.testing.assert_close(one, many, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(s_one, s_many, rtol=2e-4, atol=2e-4)


def test_ssd_tensor_core_chunk_64_equals_256(card):
    """The tensor-core instance, bf16: chunk 64 against chunk 256 (more
    passes of state, other tiles) within the reference's bf16 tolerance."""
    args = _ssd_inputs(2, 1024, 4, 64, 128, torch.bfloat16, 8)
    k = tssd.build_kernel()
    before = k.instance_launches["tensor_core"]
    one, s_one = tssd.ssd(*args, chunk=256)
    many, s_many = tssd.ssd(*args, chunk=64)
    torch.cuda.synchronize()
    assert k.instance_launches["tensor_core"] == before + 2
    tol = SSD_TOL["bfloat16"]
    torch.testing.assert_close(one.float(), many.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(s_one, s_many, rtol=tol, atol=tol)


def test_ssd_tensor_core_takes_strided_views(card):
    """x, B and C as slices of one conv output, as the model passes them,
    through the tensor-core instance."""
    rng = np.random.default_rng(9)
    B, L, H, N = 2, 512, 4, 128
    conv = _randn((B, L, H * 64 + 2 * N), torch.bfloat16, rng)
    xh, Bm, Cm = torch.split(conv, [H * 64, N, N], dim=-1)
    xh, Bm, Cm = xh.view(B, L, H, 64), Bm.view(B, L, 1, N), Cm.view(B, L, 1, N)
    _, dt, A, _, _ = _ssd_inputs(B, L, H, 64, N, torch.bfloat16, 9)
    assert not xh.is_contiguous()
    assert tssd.select_instance(xh, Bm, Cm, 256) == "tensor_core"
    y, state = tssd.ssd(xh, dt, A, Bm, Cm, chunk=256)
    want_y, want_state = tssd.ref.ssd_chunked(xh, dt, A, Bm, Cm, chunk=256)
    tol = SSD_TOL["bfloat16"]
    torch.testing.assert_close(y.float(), want_y.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(state, want_state, rtol=tol, atol=tol)
    _ssd_rounded(y, state, xh, dt, A, Bm, Cm, 256)


# (B, L, H, P, N, Q, G): groups on the tensor-core instance (Zamba2-7B's
# 112 heads of 64, state 64, two groups; 16 heads in 2 and 4 groups; a head
# count whose groups split the CTAs' head blocks unevenly) and on the CUDA
# cores (float32, a ragged P)
SSD_GROUP_SHAPES = [(2, 1024, 112, 64, 64, 256, 2), (2, 512, 16, 64, 128, 256, 2),
                    (1, 512, 16, 64, 64, 128, 4), (1, 256, 12, 64, 64, 64, 2),
                    (2, 128, 6, 16, 16, 32, 3)]


@pytest.mark.parametrize("shape", SSD_GROUP_SHAPES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_ssd_groups_match_plain(card, shape, dtype):
    """G > 1 groups of B and C, head h reading group h // (H / G): y and the
    final state against the plain version, and on the tensor cores against
    the one that rounds what they round."""
    B, L, H, P, N, Q, G = shape
    args = _ssd_inputs(B, L, H, P, N, DTYPES[dtype], sum(shape), G)
    k = tssd.build_kernel()
    instance = tssd.select_instance(args[0], args[3], args[4], Q)
    assert (instance == "tensor_core") == (dtype == "bfloat16" and P == 64)
    before = dict(k.instance_launches)
    y, state = tssd.ssd(*args, chunk=Q)
    torch.cuda.synchronize()
    assert k.instance_launches[instance] == before[instance] + 1
    want_y, want_state = tssd.ref.ssd_chunked(*args, chunk=Q)
    tol = SSD_TOL[dtype]
    torch.testing.assert_close(y.float(), want_y.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(state, want_state, rtol=tol, atol=tol)
    if instance == "tensor_core":
        _ssd_rounded(y, state, *args, Q)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_ssd_one_group_equals_two_equal_groups(card, dtype):
    """The group index moves addresses only: two groups holding the same B
    and C give the bits of one group (16 heads: the same head blocks per
    CTA either way)."""
    xh, dt, A, Bm, Cm = _ssd_inputs(2, 512, 16, 64, 64, DTYPES[dtype], 21)
    one = tssd.ssd(xh, dt, A, Bm, Cm, chunk=256)
    two = tssd.ssd(xh, dt, A, Bm.expand(-1, -1, 2, -1).contiguous(),
                   Cm.expand(-1, -1, 2, -1).contiguous(), chunk=256)
    torch.cuda.synchronize()
    assert torch.equal(one[0], two[0]) and torch.equal(one[1], two[1])


def test_ssd_groups_take_strided_views(card):
    """x, B and C of two groups as slices of one conv output (Zamba2-7B's
    layout: 7168 | 2 x 64 | 2 x 64), through the tensor-core instance."""
    rng = np.random.default_rng(10)
    B, L, H, N, G = 2, 512, 112, 64, 2
    conv = _randn((B, L, H * 64 + 2 * G * N), torch.bfloat16, rng)
    xh, Bm, Cm = torch.split(conv, [H * 64, G * N, G * N], dim=-1)
    xh, Bm, Cm = xh.view(B, L, H, 64), Bm.view(B, L, G, N), Cm.view(B, L, G, N)
    _, dt, A, _, _ = _ssd_inputs(B, L, H, 64, N, torch.bfloat16, 10)
    assert tssd.select_instance(xh, Bm, Cm, 256) == "tensor_core"
    y, state = tssd.ssd(xh, dt, A, Bm, Cm, chunk=256)
    want_y, want_state = tssd.ref.ssd_chunked(xh, dt, A, Bm, Cm, chunk=256)
    tol = SSD_TOL["bfloat16"]
    torch.testing.assert_close(y.float(), want_y.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(state, want_state, rtol=tol, atol=tol)
    _ssd_rounded(y, state, xh, dt, A, Bm, Cm, 256)


def test_ssd_groups_take_the_plain_gradient(card):
    """With two groups the backward is autograd of the plain version
    (``PlainGrad``); the backward kernel, which sums dB and dC over all
    heads, never runs."""
    xh, dt, A, Bm, Cm = _ssd_inputs(1, 256, 8, 64, 64, torch.bfloat16, 22, 2)
    xh.requires_grad_()
    k = tssd.build_kernel()
    before = k.backward.launches
    y, _ = tssd.ssd(xh, dt, A, Bm, Cm, chunk=128)
    y.float().sum().backward()
    torch.cuda.synchronize()
    assert k.backward.launches == before and xh.grad is not None


def test_ssd_wrapper_rejects_bad_inputs(card):
    xh, dt, A, Bm, Cm = _ssd_inputs(1, 32, 2, 8, 16, torch.float32, 4)
    k = tssd.build_kernel()
    with pytest.raises(ValueError, match="multiple of the chunk"):
        k(xh, dt, A, Bm, Cm, 12)
    with pytest.raises(ValueError):
        k(xh, dt, A, Bm.expand(1, 32, 2, 16), Cm.expand(1, 32, 2, 16), 16)
    with pytest.raises(TypeError):
        k(xh, dt.bfloat16(), A, Bm, Cm, 16)
    with pytest.raises(TypeError):
        k(xh.bfloat16(), dt, A, Bm, Cm, 16)
    with pytest.raises(ValueError):
        k(xh[..., :6], dt, A, Bm, Cm, 16)
    with pytest.raises(ValueError):
        k(xh.cpu(), dt, A, Bm, Cm, 16)


def test_mamba2_prefill_on_card_matches_plain(card):
    """The reduced model's prefill and one decode step on the card (through
    both kernels, one launch each per layer) against the same weights on
    the CPU (plain versions)."""
    cfg = reduced(get_config("mamba2-1.3b"))
    cpu = build_model(cfg, device="cpu")
    gpu = build_model(cfg, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 48)))
    tconv.reset_launch_counts()
    tssd.reset_launch_counts()
    got, cache = gpu.prefill({"tokens": tokens.cuda()})
    torch.cuda.synchronize()
    assert tconv.launch_counts()["conv1d_shuffle_w4"] == cfg.n_layers
    assert tssd.launch_counts()["ssd"] == cfg.n_layers
    want, want_cache = cpu.prefill({"tokens": tokens})
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    for key in ("conv", "ssm"):
        torch.testing.assert_close(cache[key].cpu(), want_cache[key],
                                   rtol=1e-4, atol=1e-4)
    nxt = want.argmax(-1)
    got2, _ = gpu.decode_step(nxt.cuda(), cache)
    want2, _ = cpu.decode_step(nxt, want_cache)
    torch.testing.assert_close(got2.cpu(), want2, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# flash attention (the Zamba2 serving path)
# ---------------------------------------------------------------------------

FLASH_TOL = {"float32": 2e-5, "bfloat16": 6e-2}    # the reference's
# (B, Sq, Sk, H, KV, Dh, causal): the reference test's five shapes, Sq
# above a ragged Sk, GQA with Dh 128, ragged Sq and Sk at Dh 64 and (GQA)
# 128, and the serving shapes of Zamba2, OLMo-1B, Yi-9B, Granite (GQA
# 16/8 at Dh 64) and the Seamless encoder (non-causal)
FLASH_SHAPES = [(2, 64, 64, 4, 2, 16, True), (1, 100, 100, 4, 4, 8, True),
                (2, 64, 64, 8, 2, 16, False), (1, 33, 33, 2, 1, 32, True),
                (2, 48, 96, 4, 1, 16, True), (1, 40, 20, 2, 1, 8, True),
                (2, 200, 200, 8, 2, 128, True), (1, 300, 177, 4, 2, 64, True),
                (2, 130, 250, 8, 2, 128, True), (1, 70, 128, 4, 1, 64, False),
                (4, 1024, 1024, 32, 32, 64, True), (4, 1024, 1024, 16, 16, 128, True),
                (4, 1024, 1024, 32, 4, 128, True), (4, 1024, 1024, 16, 8, 64, True),
                (4, 1024, 1024, 16, 16, 64, False),
                # Zamba2-7B's 224-wide heads: ragged Sq and Sk, and its serving shape
                (2, 200, 200, 4, 4, 224, True), (1, 300, 177, 4, 2, 224, True),
                (1, 130, 250, 2, 2, 224, True), (2, 1024, 1024, 32, 32, 224, True)]


def _flash_rounded(out, q, k, v, causal=True):
    """A tensor-core result against the float32 result of the plain version
    that rounds P as the kernel does, over its key tiles, at a few bf16 ulps
    of each row's scale (``instances.check_rounded``): the reference's 6e-2
    is as large as |o| itself at long sequences."""
    want = tfa.ref.attention_tiled(q.float(), k.float(), v.float(), causal,
                                   key_tile=tfa.TENSOR_CORE_KEY_TILE[q.shape[-1]],
                                   round_p=True)
    check_rounded("flash_attention", out, want)


def _qkv(B, Sq, Sk, H, KV, Dh, dtype, seed):
    rng = np.random.default_rng(seed)
    return (_randn((B, Sq, H, Dh), dtype, rng), _randn((B, Sk, KV, Dh), dtype, rng),
            _randn((B, Sk, KV, Dh), dtype, rng))


@pytest.mark.parametrize("shape", FLASH_SHAPES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_flash_attention_matches_plain(card, shape, dtype):
    B, Sq, Sk, H, KV, Dh, causal = shape
    q, k, v = _qkv(B, Sq, Sk, H, KV, Dh, DTYPES[dtype], sum(shape))
    kernel = tfa.build_kernel()
    instance = tfa.select_instance(q, k, v)
    assert (instance == "tensor_core") == (dtype == "bfloat16" and Dh >= 16)
    before, before_i = kernel.launches, dict(kernel.instance_launches)
    out = tfa.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert {i: n - before_i[i] for i, n in kernel.instance_launches.items()} == {
        i: int(i == instance) for i in tfa.INSTANCES}
    assert out.dtype == q.dtype and tuple(out.shape) == (B, Sq, H, Dh)
    want = tfa.ref.attention_ref(q, k, v, causal)
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(out.float(), want.float(), rtol=tol, atol=tol)
    if instance == "tensor_core":
        _flash_rounded(out, q, k, v, causal)


@pytest.mark.parametrize("Dh", [64, 224])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_flash_attention_takes_a_scale(card, Dh, dtype):
    """``scale`` in place of Dh^-1/2 (Zamba2's (Dh / 2)^-1/2) at ragged
    lengths, against the plain version given the same scale; the default
    stays Dh^-1/2."""
    q, k, v = _qkv(2, 300, 300, 4, 2, Dh, DTYPES[dtype], Dh)
    scale = (Dh / 2) ** -0.5
    out = tfa.flash_attention(q, k, v, scale=scale)
    want = tfa.ref.attention_ref(q, k, v, scale=scale)
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(out.float(), want.float(), rtol=tol, atol=tol)
    assert (out.float() - tfa.ref.attention_ref(q, k, v).float()).abs().max() > 10 * tol
    if tfa.select_instance(q, k, v) == "tensor_core":
        check_rounded("flash_attention scale", out,
                      tfa.ref.attention_tiled(q.float(), k.float(), v.float(),
                                              key_tile=tfa.TENSOR_CORE_KEY_TILE[Dh],
                                              round_p=True, scale=scale))


def test_flash_tensor_core_at_zamba2_7b_serving_shape(card):
    """(8, 4096, 32, 224) bf16 causal with Zamba2's scale, the cell's largest
    batch: on the tensor cores, against the plain version one row of the
    batch at a time."""
    q, k, v = _qkv(8, 4096, 4096, 32, 32, 224, torch.bfloat16, 224)
    scale = 112 ** -0.5
    kernel = tfa.build_kernel()
    before = kernel.instance_launches["tensor_core"]
    out = tfa.flash_attention(q, k, v, scale=scale)
    torch.cuda.synchronize()
    assert kernel.instance_launches["tensor_core"] == before + 1
    for b in range(8):
        row = slice(b, b + 1)
        want = tfa.ref.attention_ref(q[row], k[row], v[row], scale=scale)
        torch.testing.assert_close(out[row].float(), want.float(), rtol=6e-2, atol=6e-2)
        check_rounded("flash_attention 224", out[row],
                      tfa.ref.attention_tiled(q[row].float(), k[row].float(), v[row].float(),
                                              key_tile=64, round_p=True, scale=scale))


def test_flash_attention_takes_strided_positions(card):
    """q, k, v as slices along the batch and position axes (each
    position's heads x Dh contiguous), as a caller may pass them."""
    q, k, v = _qkv(3, 90, 90, 4, 2, 32, torch.float32, 5)
    qs, ks, vs = q[::2, 10:], k[::2, 10:], v[::2, 10:]
    assert not qs.is_contiguous()
    out = tfa.flash_attention(qs, ks, vs)
    want = tfa.ref.attention_ref(qs, ks, vs)
    torch.testing.assert_close(out, want, rtol=2e-5, atol=2e-5)


def test_flash_tensor_core_takes_strided_positions(card):
    """The same slices in bf16, through the tensor-core instance."""
    q, k, v = _qkv(3, 200, 200, 4, 2, 64, torch.bfloat16, 5)
    qs, ks, vs = q[::2, 10:], k[::2, 10:], v[::2, 10:]
    assert tfa.select_instance(qs, ks, vs) == "tensor_core"
    out = tfa.flash_attention(qs, ks, vs)
    want = tfa.ref.attention_ref(qs, ks, vs)
    tol = FLASH_TOL["bfloat16"]
    torch.testing.assert_close(out.float(), want.float(), rtol=tol, atol=tol)
    _flash_rounded(out, qs, ks, vs)


def test_tensor_core_instances_carry_hgmma(card):
    """Every kernel of the tensor-core instances runs wgmma (HGMMA in the
    SASS); the CUDA-core instances run none."""
    for kernel, tc, simt in ((tfa.build_kernel(), ("flash_wgmma_kernel",), "flash_kernel"),
                             (tssd.build_kernel(), ("states_kernel", "pass_kernel",
                                                    "scan_kernel"), "ssd_kernel")):
        counts = {f: c["hgmma"] for f, c in sass_counts(kernel.library.path).items()}
        for name in tc:
            found = {f: n for f, n in counts.items() if name in f}
            assert found and all(found.values()), (name, found)
        found = {f: n for f, n in counts.items() if simt in f}
        assert found and not any(found.values()), (simt, found)


def test_flash_wrapper_rejects_bad_inputs(card):
    q, k, v = _qkv(1, 16, 16, 4, 2, 16, torch.float32, 6)
    kernel = tfa.build_kernel()
    with pytest.raises(TypeError):
        kernel(q.double(), k.double(), v.double())
    with pytest.raises(TypeError):
        kernel(q, k.bfloat16(), v)
    with pytest.raises(ValueError):
        kernel(q.cpu(), k, v)
    with pytest.raises(ValueError, match="head dim"):
        kernel(q[..., :12].contiguous(), k[..., :12].contiguous(), v[..., :12].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        kernel(q.transpose(1, 2), k, v)
    with pytest.raises(ValueError, match="multiple"):
        kernel(q[:, :, :3].contiguous(), k, v)
    q2, k2, v2 = _qkv(1, 16, 100, 2, 1, 16, torch.float32, 7)
    with pytest.raises(ValueError, match="non-causal"):
        kernel(q2, k2, v2, causal=False)


@pytest.mark.parametrize("arch,n_layers,n_flash", [("zamba2-1.2b", 5, 2), ("zamba2-7b", 6, 4)])
def test_zamba2_prefill_on_card_matches_plain(card, arch, n_layers, n_flash):
    """The reduced 5-layer hybrid (two supercells, one trailing block) and
    the reduced Zamba2-7B (6 layers, 4 of them with a shared-block
    application, two B/C groups): prefill and one decode step on the card
    (a flash-attention launch per application, a conv1d and an SSD
    launch per layer) against the same weights on the CPU, caches
    included."""
    cfg = reduced(get_config(arch)).replace(n_layers=n_layers)
    cpu = build_model(cfg, device="cpu")
    gpu = build_model(cfg, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 48)))
    for mod in (tconv, tssd, tfa):
        mod.reset_launch_counts()
    got, cache = gpu.prefill({"tokens": tokens.cuda()}, max_len=50)
    torch.cuda.synchronize()
    assert tconv.launch_counts()["conv1d_shuffle_w4"] == cfg.n_layers
    assert tssd.launch_counts()["ssd"] == cfg.n_layers
    n_apps = gpu.n_super if cfg.family == "hybrid" else len(cfg.hybrid_layer_ids)
    assert tfa.launch_counts()["flash_attention"] == n_apps == n_flash
    want, want_cache = cpu.prefill({"tokens": tokens}, max_len=50)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    keys = ("conv", "ssm", "attn_k", "attn_v")
    for key in keys:
        torch.testing.assert_close(cache[key].cpu(), want_cache[key],
                                   rtol=1e-4, atol=1e-4)
    nxt = want.argmax(-1)
    got2, cache2 = gpu.decode_step(nxt.cuda(), cache)
    want2, want_cache2 = cpu.decode_step(nxt, want_cache)
    torch.testing.assert_close(got2.cpu(), want2, rtol=1e-4, atol=1e-4)
    for key in keys:
        assert cache2[key] is cache[key]
        torch.testing.assert_close(cache2[key].cpu(), want_cache2[key],
                                   rtol=1e-4, atol=1e-4)
    assert tfa.launch_counts()["flash_attention"] == n_flash      # decode launches none


@pytest.mark.parametrize("arch", ["olmo-1b", "yi-9b", "starcoder2-3b"])
def test_dense_prefill_on_card_matches_plain(card, arch):
    """The reduced dense model (float32, Dh 16: the CUDA-core flash
    instance, one launch per layer): prefill, one decode step and the loss
    on the card against the same weights on the CPU."""
    cfg = reduced(get_config(arch))
    cpu = build_model(cfg, device="cpu")
    gpu = build_model(cfg, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 48)))
    tfa.reset_launch_counts()
    got, cache = gpu.prefill({"tokens": tokens.cuda()}, max_len=50)
    torch.cuda.synchronize()
    assert tfa.launch_counts()["flash_attention"] == cfg.n_layers
    assert tfa.instance_counts()["flash_attention/cuda_core"] == cfg.n_layers
    want, want_cache = cpu.prefill({"tokens": tokens}, max_len=50)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    for key in ("k", "v"):
        torch.testing.assert_close(cache[key].cpu(), want_cache[key],
                                   rtol=1e-4, atol=1e-4)
    nxt = want.argmax(-1)
    got2, _ = gpu.decode_step(nxt.cuda(), cache)
    want2, _ = cpu.decode_step(nxt, want_cache)
    torch.testing.assert_close(got2.cpu(), want2, rtol=1e-4, atol=1e-4)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, dims=1)}
    torch.testing.assert_close(gpu.loss(batch)[0].cpu(), cpu.loss(batch)[0],
                               rtol=1e-4, atol=1e-4)


def _stub(cfg, B, rng):
    """Seeded media (vlm) or frames (audio), as the reference's tests."""
    key, rows = {"vlm": ("media", cfg.n_media_tokens),
                 "audio": ("frames", cfg.n_frames)}.get(cfg.family, (None, 0))
    return {} if key is None else {key: torch.from_numpy(
        rng.standard_normal((B, rows, cfg.d_model)).astype(np.float32))}


def _reduced_pair(arch, remat="none"):
    """The reduced config, a CPU model and a card model with its weights
    (``remat`` on the card's), the VLM's gates (0 at init) at 0.5."""
    cfg = reduced(get_config(arch))
    if cfg.family == "hybrid":
        cfg = cfg.replace(n_layers=5)
    cpu = build_model(cfg, device="cpu")
    with torch.no_grad():
        for cross in getattr(cpu, "cross", ()):
            cross.gate.fill_(0.5)
    gpu = build_model(cfg.replace(remat=remat), device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    return cfg, cpu, gpu


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "kimi-k2-1t-a32b",
                                  "seamless-m4t-large-v2", "llama-3.2-vision-90b"])
def test_new_family_prefill_on_card_matches_plain(card, arch):
    """The reduced MoE, enc-dec and VLM models (float32): prefill (one flash
    launch per self-attention layer, the encoder's too), one decode step
    (none) and the loss on the card against the same weights on the CPU."""
    cfg, cpu, gpu = _reduced_pair(arch)
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 48)))
    stub = _stub(cfg, 2, rng)
    on_card = {"tokens": tokens.cuda(), **{k: v.cuda() for k, v in stub.items()}}
    n_attn = (cfg.n_layers // cfg.cross_every * (cfg.cross_every - 1) if cfg.family == "vlm"
              else cfg.n_layers + cfg.n_encoder_layers)           # the encoder's too
    tfa.reset_launch_counts()
    got, cache = gpu.prefill(on_card, max_len=50)
    torch.cuda.synchronize()
    assert tfa.launch_counts()["flash_attention"] == n_attn
    want, want_cache = cpu.prefill({"tokens": tokens, **stub}, max_len=50)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    nxt = want.argmax(-1)
    got2, _ = gpu.decode_step(nxt.cuda(), cache)
    want2, _ = cpu.decode_step(nxt, want_cache)
    torch.testing.assert_close(got2.cpu(), want2, rtol=1e-4, atol=1e-4)
    assert tfa.launch_counts()["flash_attention"] == n_attn      # decode launches none
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, dims=1), **stub}
    torch.testing.assert_close(gpu.loss(batch)[0].cpu(), cpu.loss(batch)[0],
                               rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# training: each kernel's autograd Function, and a reduced train step
# ---------------------------------------------------------------------------

def _first(out):
    return out[0] if isinstance(out, tuple) else out


def _function_vs_plain(counts, entry, plain, make, tol, seed, backward="PlainGradBackward"):
    """``entry`` (the kernel's public entry point, through its autograd
    Function on the card; ``counts`` its package) against autograd of
    ``plain`` on equal inputs and a seeded cotangent: the output and every
    gradient within ``tol``; the forward launches once, and the backward
    (``backward``, the Function's node) once more where it is a kernel's
    own, else never."""
    leaves, inputs = make()
    counts.reset_launch_counts()
    y = _first(entry(*inputs))
    launched = sum(counts.launch_counts().values())
    assert launched == 1 and type(y.grad_fn).__name__ == backward
    cot = _randn(y.shape, y.dtype, np.random.default_rng(seed))
    got = torch.autograd.grad(y, leaves, cot)
    assert sum(counts.launch_counts().values()) == 1 + (backward != "PlainGradBackward")
    pleaves, pinputs = make()
    want = torch.autograd.grad(_first(plain(*pinputs)), pleaves, cot)
    torch.testing.assert_close(y.float(), _first(plain(*pinputs)).float(), rtol=tol, atol=tol)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        torch.testing.assert_close(g.float(), w.float(), rtol=tol, atol=tol)
    return got


@pytest.mark.parametrize("shape", [(3, 37, 77, 4, 0, 0), (2, 333, 200, 3, 0, 0),
                                   (2, 129, 456, 4, 4097, 63), (1, 70, 200, 4, 4096, 65)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_conv1d_function_gradient_matches_plain(card, shape, dtype):
    """Ragged shapes, and x as a column slice of a wider tensor at odd row
    strides and bases: the gradient lands in x's columns of that tensor,
    and nowhere else."""
    B, L, C, W, left, right = shape
    rng = np.random.default_rng(sum(shape))
    wide0 = _randn((B, L, left + C + right), DTYPES[dtype], rng)
    w0, b0 = _randn((W, C), DTYPES[dtype], rng), _randn((C,), DTYPES[dtype], rng)

    def make():
        leaves = [t.clone().requires_grad_() for t in (wide0, w0, b0)]
        return leaves, (leaves[0][..., left:left + C], leaves[1], leaves[2])

    gwide = _function_vs_plain(tconv, tconv.causal_conv1d, tconv.ref.causal_conv1d, make,
                               CONV_TOL[dtype], 1)[0]
    assert float(gwide[..., :left].abs().sum()) == 0 == float(gwide[..., left + C:].abs().sum())


@pytest.mark.parametrize("shape", [(2, 64, 4, 16, 16, 16), (1, 96, 3, 8, 16, 32),
                                   (2, 512, 6, 64, 64, 64), (1, 256, 4, 64, 128, 256)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_ssd_function_gradient_matches_plain(card, shape, dtype):
    """Both instances (the bf16 shapes with P 64 run on ``tensor_core``,
    whose backward is the backward kernel; the others go through
    ``PlainGrad``); gradients for xh, dt, A, Bm and Cm from y's cotangent
    alone."""
    B, L, H, P, N, Q = shape
    rng = np.random.default_rng(sum(shape))
    xh = _randn((B, L, H, P), DTYPES[dtype], rng)
    dt = torch.from_numpy(rng.uniform(0.01, 0.2, (B, L, H)).astype(np.float32)).cuda()
    A = -torch.from_numpy(rng.uniform(0.5, 2.0, (H,)).astype(np.float32)).cuda()
    Bm, Cm = _randn((B, L, 1, N), DTYPES[dtype], rng), _randn((B, L, 1, N), DTYPES[dtype], rng)

    def make():
        leaves = [t.clone().requires_grad_() for t in (xh, dt, A, Bm, Cm)]
        return leaves, tuple(leaves)

    tensor_core = tssd.select_instance(xh, Bm, Cm, Q) == "tensor_core"
    grads = _function_vs_plain(tssd, lambda *a: tssd.ssd(*a, Q), lambda *a: tssd.ref.ssd_chunked(*a, Q),
                               make, SSD_TOL[dtype], 2,
                               "SSDFunctionBackward" if tensor_core else "PlainGradBackward")
    assert all(float(g.abs().max()) > 0 for g in grads)


# (B, L, H, P, N, chunk): Mamba-2's training shape, Zamba2's (N 64), and
# smaller ones at chunks 64 and 192
SSD_BWD_SHAPES = [(4, 2048, 64, 64, 128, 256), (4, 2048, 64, 64, 64, 256),
                  (2, 512, 6, 64, 128, 64), (1, 384, 3, 64, 64, 192)]
#: the backward kernel's float32 gradients (ddt, dA) against the plain
#: version that rounds what it rounds, as a fraction of the largest element:
#: the two round w x to one bf16 in the chunk states, but w = exp(total -
#: cum) dt comes from two exp()s an ulp apart, so a few terms round to the
#: neighbouring bf16 (2^-8 relative); summed over a chunk for ddt and over
#: every position for dA (1.1e-4 and 5.5e-4 at most on the card)
SSD_BWD_F32_TOL = {"ddt": 5e-4, "dA": 2e-3}
#: the same against float32 autograd of ``ref.ssd_chunked``: the entering
#: states come from the forward's pass a, which rounds w x to one bf16 (2^-9
#: relative a term); through U and the dots that reaches ddt, and dA sums
#: it over every position of the batch (3.2e-4 and 1.3e-2 at most on the
#: card)
SSD_BWD_F32_EXACT_TOL = {"ddt": 2e-3, "dA": 4e-2}


def _ssd_bwd_inputs(B, L, H, P, N, seed):
    """x, B and C as strided views of one conv output (as the model
    passes them), dt, A, y's cotangent and the final state's."""
    rng = np.random.default_rng(seed)
    conv = _randn((B, L, H * P + 2 * N + 64), torch.bfloat16, rng)
    xh = conv[..., :H * P].view(B, L, H, P)
    Bm = conv[..., H * P:H * P + N].view(B, L, 1, N)
    Cm = conv[..., H * P + N:H * P + 2 * N].view(B, L, 1, N)
    dt = torch.from_numpy(rng.uniform(0.01, 0.2, (B, L, H)).astype(np.float32)).cuda()
    A = -torch.from_numpy(rng.uniform(0.5, 2.0, (H,)).astype(np.float32)).cuda()
    return (xh, dt, A, Bm, Cm), _randn((B, L, H, P), torch.bfloat16, rng), \
        _randn((B, H, N, P), torch.float32, rng)


@pytest.mark.parametrize("shape", SSD_BWD_SHAPES)
@pytest.mark.parametrize("final", [False, True], ids=["no_final", "final"])
def test_ssd_backward_kernel_matches_plain(card, shape, final, monkeypatch):
    """The tensor-core instance's backward kernel through ``ssd``'s
    Function, x, B and C strided views of one conv output, from y's
    cotangent and, with ``final``, the final state's: one call adds one to
    the backward's count (``ssd_bwd/tensor_core``) and enters no
    ``PlainGrad``; the gradients come back in their inputs' dtypes.  dx, dB
    and dC against the plain version that rounds what the kernels round
    (``ref.ssd_passes_bwd(round_operands=True)``) by
    ``instances.check_rounded`` and against float32 autograd of
    ``ref.ssd_chunked`` at 4 bf16 ulps of each row's scale; ddt and dA at
    :data:`SSD_BWD_F32_TOL` and :data:`SSD_BWD_F32_EXACT_TOL` of their
    largest elements.  (dC's state term reads the entering states, so
    against float32 autograd it is some 2 ulps off: pass a's rounding.)"""
    from repro_torch.kernels.autograd import PlainGrad
    from repro_torch.kernels.instances import rounded_agreement

    B, L, H, P, N, Q = shape
    args, dy, d_final = _ssd_bwd_inputs(B, L, H, P, N, sum(shape) + final)
    entered = []
    real = PlainGrad.backward
    monkeypatch.setattr(PlainGrad, "backward",
                        staticmethod(lambda ctx, *g: entered.append(1) or real(ctx, *g)))
    k = tssd.build_kernel()
    bk = k.backward
    assert tssd.select_instance(args[0], args[3], args[4], Q) == "tensor_core"
    leaves = [t.detach().requires_grad_() for t in args]
    y, state = tssd.ssd(*leaves, Q)
    assert type(y.grad_fn).__name__ == "SSDFunctionBackward"
    before, before_bwd = k.launches, dict(bk.instance_launches)
    got = torch.autograd.grad([y, state] if final else [y], leaves,
                              [dy, d_final] if final else [dy])
    torch.cuda.synchronize()
    assert k.launches == before and not entered
    assert bk.instance_launches == {"tensor_core": before_bwd["tensor_core"] + 1}
    assert tssd.instance_counts()["ssd_bwd/tensor_core"] == bk.launches
    df = d_final if final else None
    f32 = [t.float() for t in args]
    rounded = tssd.ref.ssd_passes_bwd(*f32, Q, dy.float(), df, round_operands=True)
    pleaves = [t.clone().requires_grad_() for t in f32]
    py, pstate = tssd.ref.ssd_chunked(*pleaves, Q)
    exact = torch.autograd.grad([py, pstate] if final else [py], pleaves,
                                [dy.float(), d_final] if final else [dy.float()])
    for name, g, r, e, inp in zip(("dx", "ddt", "dA", "dB", "dC"), got, rounded, exact, args):
        assert g.shape == inp.shape and g.dtype == inp.dtype, name
        if g.dtype == torch.bfloat16:
            check_rounded(f"ssd backward {name}", g, r)
            assert rounded_agreement(g, e)["ulps"] <= 4.0, name
        else:
            scale = float(e.abs().max())
            assert float((g - r).abs().max()) <= SSD_BWD_F32_TOL[name] * scale, name
            assert float((g - e).abs().max()) <= SSD_BWD_F32_EXACT_TOL[name] * scale, name


def test_ssd_backward_kernel_is_deterministic(card):
    """Every sum across CTAs runs in a fixed order: two calls on the same
    inputs give the same gradients bit for bit."""
    args, dy, d_final = _ssd_bwd_inputs(4, 2048, 64, 64, 128, 5)
    bk = tssd.build_kernel().backward
    one, two = bk(*args, 256, dy, d_final), bk(*args, 256, dy, d_final)
    assert all(torch.equal(a, b) for a, b in zip(one, two))


_FLASH_GRAD_SHAPES = [(1, 100, 100, 4, 4, 8, True), (2, 64, 64, 8, 2, 16, False),
                      (2, 200, 200, 8, 2, 128, True), (1, 130, 250, 8, 2, 128, True),
                      (1, 300, 177, 4, 2, 64, True)]


@pytest.mark.parametrize("shape", _FLASH_GRAD_SHAPES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_flash_function_gradient_matches_plain(card, shape, dtype):
    """GQA and MHA, causal and not, ragged Sq and Sk."""
    B, Sq, Sk, H, KV, Dh, causal = shape
    q, k, v = _qkv(B, Sq, Sk, H, KV, Dh, DTYPES[dtype], sum(shape))

    def make():
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        return leaves, tuple(leaves)

    _function_vs_plain(tfa, lambda *a: tfa.flash_attention(*a, causal=causal),
                       lambda *a: tfa.ref.attention_ref(*a, causal=causal),
                       make, FLASH_TOL[dtype], 3)


def test_grad_disabled_forward_launches_once_per_call(card):
    """With trainable parameters but grad mode off (and under inference
    mode), each entry point launches exactly one kernel per call and its
    result has no graph."""
    cfg = reduced(get_config("zamba2-1.2b")).replace(n_layers=5)
    model = build_model(cfg, device="cuda")
    assert all(p.requires_grad for p in model.parameters())
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, 48))).cuda()
    for ctx in (torch.no_grad, torch.inference_mode):
        for mod in (tconv, tssd, tfa):
            mod.reset_launch_counts()
        with ctx():
            h, _ = model.hidden({"tokens": tokens})
        torch.cuda.synchronize()
        assert h.grad_fn is None
        assert tconv.launch_counts()["conv1d_shuffle_w4"] == cfg.n_layers
        assert tssd.launch_counts()["ssd"] == cfg.n_layers
        assert tfa.launch_counts()["flash_attention"] == model.n_super


@pytest.mark.parametrize("arch", ["olmo-1b", "mamba2-1.3b", "zamba2-1.2b",
                                  "granite-moe-1b-a400m", "seamless-m4t-large-v2",
                                  "llama-3.2-vision-90b"])
def test_reduced_train_step_on_card_matches_cpu(card, arch):
    """One train step of the reduced float32 model on the card (blocks
    recomputed) against the CPU from the same weights: every gradient
    within delta = 1e-4 of its leaf's largest, the loss and gradient norm
    within 1e-4 relative (the reduced models' card-vs-CPU tolerance), and
    each parameter after AdamW's first step within what such gradients
    allow (``train.optim.first_step_bound``)."""
    from repro_torch.train import OptConfig, init_opt_state, make_train_step
    from repro_torch.train.optim import first_step_bound

    cfg, cpu, gpu = _reduced_pair(arch, remat="block")
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 48)))
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, dims=1), **_stub(cfg, 4, rng)}
    grads = []
    for m in (cpu, gpu):
        params = dict(m.named_parameters())
        loss, _ = m.loss(batch)
        grads.append({k: g.detach().cpu() for k, g in
                      zip(params, torch.autograd.grad(loss, list(params.values())))})
    for k, g in grads[0].items():
        torch.testing.assert_close(grads[1][k], g, rtol=0, atol=1e-4 * float(g.abs().max()))
    old = {k: p.detach().clone() for k, p in cpu.named_parameters()}
    opt = OptConfig(lr=3e-3, warmup_steps=2, total_steps=10)
    mets = [make_train_step(m, opt)(init_opt_state(dict(m.named_parameters())), batch)[1]
            for m in (cpu, gpu)]
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(mets[1][key]), float(mets[0][key]), rtol=1e-4)
    lr = float(mets[0]["lr"])
    scale = min(1.0, 1.0 / float(mets[0]["grad_norm"]))
    card = dict(gpu.named_parameters())
    for k, p in cpu.named_parameters():
        tol = first_step_bound(old[k], p.detach(), grads[0][k], scale, lr, 1e-4)
        diff = (card[k].detach().cpu().double() - p.detach().double()).abs()
        assert bool((diff <= tol).all()), k


def test_one_rank_nccl_mesh_train_step_matches_one_device(card):
    """A one-rank NCCL process group and its (1, 1) ``("data", "model")``
    mesh: the reduced olmo-1b placed on it as DTensors trains two steps
    through ``launch.train``'s mesh branch with the same losses and
    parameters as the one-device path on the card (the same kernels on
    the same values; 1e-6 of each leaf's largest for the order of a
    reduction), and its flash launches are the one-device path's."""
    import socket

    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.launch import train as ttrain
    from repro_torch.launch.mesh import make_mesh

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", rank=0,
                            world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), "cuda")
        cfg = reduced(get_config("olmo-1b")).replace(remat="block")
        pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=4))
        dev = torch.device("cuda")
        runs = []
        for m in (None, mesh):
            model, state, step = ttrain.build(cfg, dev, 3e-3, 10, mesh=m)
            tfa.reset_launch_counts()
            losses = []
            for i in range(2):
                state, met = step(state, ttrain.batch_at(pipe, i, cfg, dev, m))
                losses.append(float(met["loss"]))
            torch.cuda.synchronize()
            params = {k: (p.full_tensor() if isinstance(p, DTensor) else p).detach().cpu()
                      for k, p in model.named_parameters()}
            runs.append((losses, params, tfa.launch_counts()))
        (l0, p0, n0), (l1, p1, n1) = runs
        assert n0 == n1 and n0["flash_attention"] == 2 * 2 * cfg.n_layers
        np.testing.assert_allclose(l1, l0, rtol=1e-6)
        for k, p in p0.items():
            torch.testing.assert_close(p1[k], p, rtol=0, atol=1e-6 * float(p.abs().max()))
    finally:
        dist.destroy_process_group()
