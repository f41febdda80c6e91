"""The Mamba-2 mixer's tail (the D skip, the SiLU gate and the grouped
RMSNorm): the plain version against the mixer's former expression bit for
bit, the routing between the CUDA kernel and the plain version, the
wrapper's checks, and on the card the kernel against the plain version and
its launches per prefill.  Imports only torch and the port, so it runs
where JAX is not installed:
PYTHONPATH=src python -m pytest -q tests/test_torch_gated_norm.py
(the ``cuda``-marked tests skip without a card)."""

import re

import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch
import torch.nn.functional as F  # noqa: E402

from repro_torch.kernels import gated_norm as tgn  # noqa: E402
from repro_torch.kernels.gated_norm import ops as gn_ops  # noqa: E402
from repro_torch.models import mamba2 as m2  # noqa: E402
from repro_torch.models.common import rmsnorm  # noqa: E402

#: (B, L, H, P, N, G): Mamba-2's layout and Zamba2-7B's (two groups) at the
#: reduced configurations' widths (``configs.reduced``)
SMALL = {1: (2, 24, 8, 16, 16, 1), 2: (2, 24, 8, 16, 16, 2)}
#: the published widths: Mamba-2 1.3B and Zamba2-7B
FULL = {"mamba2-1.3b": (64, 64, 128, 1), "zamba2-7b": (112, 64, 64, 2)}


def _operands(B, L, H, P, N, G, dtype, device="cpu", seed=0):
    """The tail's operands as the mixer passes them: y the SSD's output
    (contiguous), xh a column range of the conv output (B, L, H P + 2 G N)
    and z one of the in-projection (B, L, 2 H P + 2 G N + H), D positive,
    the scale near one; on ``meta``, drawn on the CPU and moved there."""
    draw = "cpu" if device == "meta" else device
    g = torch.Generator(device=draw).manual_seed(seed)
    C = H * P

    def randn(*shape):
        return torch.randn(shape, generator=g, device=draw).to(device, dtype)

    proj = randn(B, L, 2 * C + 2 * G * N + H)
    conv_out = randn(B, L, C + 2 * G * N)
    y = randn(B, L, H, P)
    y[..., : H // 2, :] *= 4.0            # groups of different scale
    z = proj[..., :C]
    xh = conv_out[..., :C].reshape(B, L, H, P)
    d_skip = (0.5 + torch.rand((H,), generator=g, device=draw)).to(device)
    scale = (1 + 0.1 * torch.randn((C,), generator=g, device=draw)).to(device, dtype)
    return y, xh, z, d_skip, scale


def _former(y, xh, z, d_skip, scale, groups, eps, dtype):
    """The mixer's tail as ``Mamba2.forward`` wrote it before the kernel."""
    B, L, H, P = xh.shape
    y = y + d_skip[None, None, :, None] * xh
    y = y.reshape(B, L, H * P).to(dtype)
    h = y * F.silu(z)
    if groups == 1:
        return rmsnorm(h, scale, eps)
    h = rmsnorm(h.unflatten(-1, (groups, -1)), None, eps).flatten(-2)
    return h * scale.to(h.dtype)


# ---------------------------------------------------------------------------
# on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("groups", [1, 2])
def test_plain_tail_is_the_former_expression(groups, dtype):
    """Bit for bit, on xh and z passed as column ranges of wider tensors."""
    ops = _operands(*SMALL[groups], dtype, seed=groups)
    assert not ops[1].is_contiguous() and not ops[2].is_contiguous()
    got = tgn.ref.gated_norm_tail(*ops, groups, 1e-5, dtype)
    want = _former(*ops, groups, 1e-5, dtype)
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.equal(got, want)
    assert torch.equal(tgn.gated_norm_tail(*ops, groups, 1e-5, dtype), want)


def test_mixer_reexports_the_plain_gated_norm():
    assert m2.gated_norm is tgn.ref.gated_norm
    assert m2.gated_norm_tail is tgn.gated_norm_tail


def _leaves(ops):
    """Leaves that need a gradient: y, the conv output xh views, the
    in-projection z views, d_skip and the scale."""
    y, xh, z, d_skip, scale = ops
    return [t.detach().clone().requires_grad_() for t in (y, xh._base, z._base, d_skip, scale)]


def _views(leaves):
    """The tail's operands on :func:`_leaves`, viewed as the mixer views them."""
    y, conv_out, proj, d_skip, scale = leaves
    B, L, H, P = y.shape
    return (y, conv_out[..., :H * P].reshape(B, L, H, P), proj[..., :H * P], d_skip, scale)


def _fake_kernel(calls):
    def kernel(*args):
        calls.append(args)
        return tgn.ref.gated_norm_tail(*args)
    return kernel


@pytest.mark.parametrize("case", ["cpu", "meta", "needs_grad", "card_no_grad",
                                  "card_inference", "card_needs_grad"])
def test_routing(case, monkeypatch):
    """The CPU and ``meta`` take the plain version; on the card (the CPU
    standing in for it, the kernel faked) every call launches the kernel,
    through ``PlainGrad`` where its inputs need a gradient."""
    calls = []
    monkeypatch.setattr(gn_ops, "build_kernel", lambda: _fake_kernel(calls))
    if case.startswith("card"):
        monkeypatch.setattr(gn_ops, "PLAIN_DEVICES", ("meta",))
    ops = _operands(*SMALL[2], torch.float32, device="meta" if case == "meta" else "cpu")
    if case.endswith("needs_grad"):
        ops = (ops[0].requires_grad_(),) + ops[1:]
    ctx = torch.inference_mode() if case == "card_inference" else torch.no_grad() \
        if case == "card_no_grad" else torch.enable_grad()
    with ctx:
        out = tgn.gated_norm_tail(*ops, 2, 1e-5, torch.float32)
    assert tuple(out.shape) == (2, 24, 128) and out.device == ops[0].device
    assert len(calls) == case.startswith("card")
    assert out.requires_grad == case.endswith("needs_grad")
    assert (out.grad_fn is not None and "PlainGrad" in type(out.grad_fn).__name__) == \
        (case == "card_needs_grad")


@pytest.mark.parametrize("groups", [1, 2])
def test_kernel_route_takes_the_plain_gradient(groups, monkeypatch):
    """On the card route (the CPU standing in, the kernel faked by the plain
    version) the gradient of every operand, xh's and z's reaching the
    tensors they view, is the plain version's bit for bit."""
    calls = []
    monkeypatch.setattr(gn_ops, "build_kernel", lambda: _fake_kernel(calls))
    ops = _operands(*SMALL[groups], torch.float32, seed=7)
    cot = torch.randn(2, 24, 128, generator=torch.Generator().manual_seed(8))
    grads = []
    for plain_devices in (("cpu", "meta"), ("meta",)):
        monkeypatch.setattr(gn_ops, "PLAIN_DEVICES", plain_devices)
        leaves = _leaves(ops)
        out = tgn.gated_norm_tail(*_views(leaves), groups, 1e-5, torch.float32)
        out.backward(cot)
        grads.append([t.grad for t in leaves])
    assert len(calls) == 1
    for got, want in zip(grads[1], grads[0]):
        assert torch.equal(got, want)


def test_training_step_takes_the_plain_tail(monkeypatch):
    """A mixer's loss on the CPU reaches D, the scale and z's projection
    through the plain tail, and no kernel is built."""
    monkeypatch.setattr(gn_ops, "build_kernel", lambda: pytest.fail("kernel built on the CPU"))
    cfg = m2.SSMConfig(d_model=32, d_state=16, head_dim=16, chunk=8)
    mixer = m2.Mamba2(cfg, torch.Generator().manual_seed(0))
    x = torch.randn(2, 16, 32, generator=torch.Generator().manual_seed(1))
    mixer(x).square().mean().backward()
    for name in ("d_skip", "norm_scale", "w_in"):
        assert float(getattr(mixer, name).grad.abs().max()) > 0


#: one fault each: the error it raises and its message
BAD = {"groups": (ValueError, "groups do not divide"),
       "group_vectors": (ValueError, "groups do not divide"),
       "head_size": (ValueError, "head size"),
       "group_width": (ValueError, "exceeds the kernel's"),
       "dtype": (TypeError, "expected one dtype"),
       "output_dtype": (TypeError, "expected one dtype"),
       "d_skip_dtype": (TypeError, "d_skip"),
       "row_stride": (ValueError, "xh: batch and position strides"),
       "batch_stride": (ValueError, "z: batch and position strides"),
       "base": (ValueError, "z: base address")}


def _bad_operands(case):
    """bf16 operands at Zamba2's layout cut down (C = 128 channels in two
    groups), with the fault ``case``."""
    B, L, H, P, N, G = SMALL[2]
    if case == "head_size":                    # heads of 4 elements, 8 a vector
        H, P = 32, 4
    if case == "group_width":                  # one group of 16,384 channels
        B, L, H, P, G = 1, 1, 256, 64, 1
    y, xh, z, d_skip, scale = _operands(B, L, H, P, N, G, torch.bfloat16)
    C, groups, dtype = H * P, G, torch.bfloat16
    if case == "groups":
        groups = 3
    if case == "group_vectors":                # groups of 4 channels
        groups = 32
    if case == "dtype":
        z = z.float()
    if case == "output_dtype":
        dtype = torch.float32
    if case == "d_skip_dtype":
        d_skip = d_skip.to(torch.bfloat16)
    if case == "row_stride":                   # a conv output 4 columns wider: 392 B rows
        xh = torch.zeros((B, L, C + 2 * G * N + 4), dtype=torch.bfloat16)[..., :C] \
            .reshape(B, L, H, P)
    if case == "batch_stride":                 # rows of 256 B, batches 8 B apart from that
        z = torch.zeros(B * (L * 2 * C + 4), dtype=torch.bfloat16) \
            .as_strided((B, L, C), (L * 2 * C + 4, 2 * C, 1))
    if case == "base":                         # 8 B past a 16-byte boundary
        z = torch.zeros((B, L, C + 4), dtype=torch.bfloat16)[..., 4:]
    return y, xh, z, d_skip, scale, groups, dtype


@pytest.mark.parametrize("case", sorted(BAD))
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    """Each check raises on the CPU, before any device is needed; the
    operands without the fault pass."""
    error, match = BAD[case]
    with pytest.raises(error, match=match):
        tgn.check_operands(*_bad_operands(case))


@pytest.mark.parametrize("groups", [1, 2])
def test_wrapper_takes_the_mixers_operands(groups):
    for dtype in (torch.float32, torch.bfloat16):
        ops = _operands(*SMALL[groups], dtype)
        tgn.check_operands(*ops, groups, dtype)


@pytest.mark.parametrize("arch", sorted(FULL))
def test_wrapper_takes_the_published_layouts(arch):
    """The published widths' strides (in elements: xh's row 7,424 or 4,352,
    z's 14,704 or 8,512) on ``meta``, where nothing is allocated."""
    H, P, N, G = FULL[arch]
    tgn.check_operands(*_operands(2, 8, H, P, N, G, torch.bfloat16, device="meta"),
                       G, torch.bfloat16)


def test_kernel_constants_match_the_source():
    src = gn_ops.SOURCE.read_text()
    assert int(re.search(r"kThreads = (\d+);", src).group(1)) == gn_ops.THREADS
    assert int(re.search(r"kMaxVpt = (\d+);", src).group(1)) == gn_ops.MAX_VPT


@pytest.mark.parametrize("groups", [1, 2])
def test_compare_bf16_finds_a_difference_off_a_tie(groups):
    """The card's comparison: the plain version against itself differs
    nowhere; one element moved by one ulp in a row-group away from a tie
    counts as a difference off a tie."""
    ops = _operands(*SMALL[groups], torch.bfloat16, seed=5)
    same = tgn.ref.gated_norm_tail(*ops, groups, 1e-5, torch.bfloat16)
    c = tgn.ref.compare_bf16(same, *ops, groups, 1e-5)
    assert (c["max_ulps"], c["bit_identical"], c["differ"], c["differ_off_tie"]) == (0, 1.0, 0, 0)
    assert c["groups"] == 2 * 24 * groups
    moved = same.clone()
    moved.view(torch.int16)[1, 3, -1] += 1
    c = tgn.ref.compare_bf16(moved, *ops, groups, 1e-5)
    assert (c["max_ulps"], c["differ"], c["near_tie"], c["differ_off_tie"]) == (1, 1, 0, 1)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    tgn.build_kernel()
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [(8, 4096), (4, 1)], ids=["prefill", "decode"])
@pytest.mark.parametrize("arch", sorted(FULL))
def test_kernel_matches_plain_bf16(card, arch, rows):
    """At the published widths and the mixer's strides: bit for bit the
    plain version on the card in every (row, group) whose float32
    statistic is not within ``TIE_ULPS`` of a bf16 rounding midpoint (there
    the float32 sum's order decides), within ``TIE_MOVE_ULPS`` everywhere;
    the share of bit-identical elements is printed."""
    H, P, N, G = FULL[arch]
    ops = _operands(*rows, H, P, N, G, torch.bfloat16, device="cuda", seed=3)
    eps = 1e-5
    tgn.reset_launch_counts()
    got = tgn.gated_norm_tail(*ops, G, eps, torch.bfloat16)
    assert tgn.launch_counts() == {"gated_norm": 1}
    c = tgn.ref.compare_bf16(got, *ops, G, eps)
    print(f"[gated_norm] {arch} {rows}: bit-identical {100 * c['bit_identical']:.4f} %, "
          f"max {c['max_ulps']} ulp; row-groups {c['groups']}, near a tie {c['near_tie']}, "
          f"differing {c['differ']}")
    assert c["differ_off_tie"] == 0 and c["sign_flips"] == 0
    assert c["max_ulps"] <= tgn.ref.TIE_MOVE_ULPS


@pytest.mark.cuda
@pytest.mark.parametrize("groups", [1, 2])
def test_kernel_matches_plain_float32(card, groups):
    ops = _operands(4, 64, 8, 64, 64, groups, torch.float32, device="cuda", seed=4)
    got = tgn.gated_norm_tail(*ops, groups, 1e-6, torch.float32)
    want = tgn.ref.gated_norm_tail(*ops, groups, 1e-6, torch.float32)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", sorted(FULL))
def test_prefill_launches_one_tail_kernel_per_mixer(card, arch):
    """An 8 x 4096 prefill at the published widths launches one tail kernel
    per mixer (48 for Mamba-2, 81 for Zamba2-7B)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = get_config(arch)
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = build_model(cfg, device="cuda", generator=gen)
    tokens = torch.randint(0, cfg.vocab, (8, 4096), generator=gen, device="cuda")
    tgn.reset_launch_counts()
    model.prefill({"tokens": tokens})
    torch.cuda.synchronize()
    assert tgn.launch_counts() == {"gated_norm": cfg.n_layers}
    del model
    torch.cuda.empty_cache()


@pytest.mark.cuda
def test_training_step_launches_one_tail_kernel_per_mixer_forward(card):
    """A reduced Mamba-2 loss and backward on the card: the tail's kernel
    runs once per mixer forward, as conv1d's does (the blocks' recompute
    included), and its plain backward gives D and the scale a gradient."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels import conv1d as tconv
    from repro_torch.models import build_model

    cfg = reduced(get_config("mamba2-1.3b"))
    model = build_model(cfg, device="cuda")
    tokens = torch.randint(0, cfg.vocab, (2, 64), device="cuda")
    tgn.reset_launch_counts()
    tconv.reset_launch_counts()
    loss, _ = model.loss({"tokens": tokens, "labels": tokens})
    loss.backward()
    n = tgn.launch_counts()["gated_norm"]
    assert n == sum(tconv.launch_counts().values()) and n in (cfg.n_layers, 2 * cfg.n_layers)
    for name, p in model.named_parameters():
        if name.endswith((".mamba.d_skip", ".mamba.norm_scale")):
            assert torch.isfinite(p.grad).all() and float(p.grad.abs().max()) > 0, name


@pytest.mark.cuda
@pytest.mark.parametrize("groups", [1, 2])
def test_kernel_gradient_is_the_plain_versions(card, groups):
    """Kernel forward and plain backward on float32 operands at the mixer's
    strides: the gradient of every operand equals autograd of the plain
    tail on the card, and the outputs agree as the float32 test's do."""
    ops = _operands(4, 64, 8, 64, 64, groups, torch.float32, device="cuda", seed=9)
    cot = torch.randn(4, 64, 512, device="cuda")
    res = []
    for fn in (tgn.gated_norm_tail, tgn.ref.gated_norm_tail):
        leaves = _leaves(ops)
        out = fn(*_views(leaves), groups, 1e-6, torch.float32)
        out.backward(cot)
        res.append((out.detach(), [t.grad for t in leaves]))
    torch.testing.assert_close(res[0][0], res[1][0], rtol=1e-6, atol=1e-6)
    for got, want in zip(res[0][1], res[1][1]):
        assert torch.equal(got, want)
