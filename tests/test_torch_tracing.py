"""The port's spans and counters (``repro_torch.tracing``): the span tree
of a prefill batch and of a training step with block remat, recorded under
``torch.profiler`` and nothing without it; call sites that stay
wrappable; the kernel-build counters.  On the CPU at the benchmark's
stand-in widths; the last test needs a card."""

import collections
import stat
import threading
from unittest import mock

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import build, tracing
from repro_torch.configs import get_config
from repro_torch.kernels import autograd as kag
from repro_torch.kernels.conv1d import ops as conv_ops
from repro_torch.kernels.conv1d import ref as conv_ref
from repro_torch.kernels.ssd import ref as ssd_ref
from repro_torch.models import build_model
from repro_torch.models import mamba2 as m2
from repro_torch.serve.step import generate
from repro_torch.train.optim import OptConfig, init_opt_state
from repro_torch.train.step import make_train_step

#: the widths of the benchmark's CPU stand-in (``portbench/tests/conftest.py``)
SMALL = dict(n_layers=3, d_model=64, vocab=256, dtype="float32", ssm_chunk=16,
             ssm_state=16, ssm_head_dim=16)
B, L = 2, 32
MIXER = ["mamba2.in_proj", "mamba2.conv1d", "mamba2.ssd", "mamba2.out_proj"]


def _model(remat: str, device: str = "cpu", **widths):
    cfg = get_config("mamba2-1.3b").replace(**{**SMALL, **widths}, remat=remat)
    return build_model(cfg, device=device,
                       generator=torch.Generator(device=device).manual_seed(0))


def _tokens(n: int = L, device: str = "cpu") -> torch.Tensor:
    return torch.randint(0, SMALL["vocab"], (B, n), generator=torch.Generator().manual_seed(1)
                         ).to(device)


def _step(model):
    step = make_train_step(model, OptConfig())
    state = init_opt_state(dict(model.named_parameters()))
    ids = _tokens(L + 1, str(model.device))
    batch = {"tokens": ids[:, :-1], "labels": ids[:, 1:]}
    return lambda: step(state, batch)


def _traced(fn, activities=(ProfilerActivity.CPU,)):
    tracing.reset()
    with profile(activities=list(activities)) as prof:
        fn()
    return tracing.spans(), prof


def _children(spans, parent):
    return sorted((s for s in spans if s.parent == parent.id), key=lambda s: s.start_ns)


def _names(spans):
    return [s.name for s in spans]


@pytest.fixture
def plain_grad(monkeypatch):
    """The mixer's two kernel calls as the card makes them, through
    ``PlainGrad``, with each plain version standing in for its kernel."""
    def conv(x, w, b):
        return kag.with_plain_grad("conv1d", conv_ref.causal_conv1d, conv_ref.causal_conv1d,
                                   x, w, b)

    def ssd(xh, dt, A, Bm, Cm, chunk):
        plain = lambda *a: ssd_ref.ssd_chunked(*a, chunk)      # noqa: E731
        return kag.with_plain_grad("ssd", plain, plain, xh, dt, A, Bm, Cm)

    monkeypatch.setattr(m2, "causal_conv1d", conv)
    monkeypatch.setattr(m2, "ssd", ssd)


def test_generate_records_the_span_tree():
    model = _model("none")
    spans, prof = _traced(lambda: generate(model, {"tokens": _tokens()}, 2))
    (gen,) = [s for s in spans if s.parent is None]
    assert gen.name == "serve.generate" and gen.unit == gen.id
    assert gen.attrs == {"B": B, "L": L, "n_tokens": 2}
    assert all(s.unit == gen.id and not s.backward for s in spans)
    blocks = _children(spans, gen)            # the prefill's, then the decode step's
    assert _names(blocks) == ["model.block"] * 6
    assert [b.attrs for b in blocks] == [{"layer": i} for i in (0, 1, 2, 0, 1, 2)]
    for blk, mixer in zip(blocks, [MIXER] * 3 + [[]] * 3):
        assert _names(_children(spans, blk)) == mixer
    in_proj, conv, ssd, out_proj = _children(spans, blocks[0])
    assert in_proj.attrs == dict(M=B * L, K=64, N=2 * 128 + 2 * 16 + 8, dtype="float32")
    assert conv.attrs == dict(B=B, L=L, C=128 + 2 * 16, W=4, dtype="float32")
    assert ssd.attrs == dict(B=B, L=L, H=8, P=16, N=16, chunk=16, dtype="float32")
    assert out_proj.attrs == dict(M=B * L, K=128, N=64, dtype="float32")
    by_id = {s.id: s for s in spans}
    for s in spans:
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
    ranges = collections.Counter(e.name for e in prof.events() if e.name.startswith("repro::"))
    assert ranges == collections.Counter(tracing.PREFIX + s.name for s in spans)


def test_train_step_with_block_remat_records_the_backward(plain_grad):
    spans, _ = _traced(_step(_model("block")))
    (st,) = [s for s in spans if s.parent is None]
    assert st.name == "train.step" and st.attrs == {"B": B, "L": L}
    assert all(s.unit == st.id for s in spans)
    assert set(_names(spans)) == {"train.step", "model.block", "autograd.backward", *MIXER}
    by_id = {s.id: s for s in spans}
    blocks = [s for s in spans if s.name == "model.block"]
    forward = sorted((b for b in blocks if not b.backward), key=lambda s: s.start_ns)
    recompute = [b for b in blocks if b.backward]
    assert [b.attrs["layer"] for b in forward] == [0, 1, 2]
    assert sorted(b.attrs["layer"] for b in recompute) == [0, 1, 2]
    assert all(b.parent == st.id for b in forward)
    for b in forward:
        assert _names(_children(spans, b)) == MIXER
    for b in recompute:          # the recompute stops once it has what the backward needs
        inner = _children(spans, b)
        assert set(_names(inner)) <= set(MIXER) and all(s.backward for s in inner)
        assert by_id[b.parent].name in ("train.step", "autograd.backward")
    backward = [s for s in spans if s.name == "autograd.backward"]
    assert collections.Counter(s.attrs["kernel"] for s in backward) == {"conv1d": 3, "ssd": 3}
    assert all(s.backward and st.start_ns <= s.start_ns <= s.end_ns <= st.end_ns
               for s in backward)


def test_without_a_profiler_nothing_is_recorded(monkeypatch, plain_grad):
    entered = []
    monkeypatch.setattr(tracing, "record_function", entered.append)
    tracing.reset()
    generate(_model("none"), {"tokens": _tokens()}, 2)
    _step(_model("block"))()
    assert tracing.spans() == [] and entered == []
    assert tracing.span("a", k=1) is tracing.unit("b")


def test_a_wrapper_on_the_mixer_call_sites_sees_every_call(monkeypatch, plain_grad):
    """The benchmark wraps ``models.mamba2.ssd`` and ``causal_conv1d`` from
    outside: the forward and the remat recompute both call through them."""
    seen = collections.Counter()
    for attr in ("ssd", "causal_conv1d"):
        real = getattr(m2, attr)
        monkeypatch.setattr(m2, attr, lambda *a, _f=real, _n=attr: seen.update([_n]) or _f(*a))
    spans, _ = _traced(_step(_model("block")))
    assert seen == {"ssd": 6, "causal_conv1d": 6}
    assert _names(spans).count("mamba2.ssd") == 6


def test_spans_close_in_order_when_the_body_raises():
    with profile(activities=[ProfilerActivity.CPU]):
        tracing.reset()
        with pytest.raises(ValueError):
            with tracing.unit("u"), tracing.span("inner"):
                raise ValueError("stop")
        with tracing.span("after"):
            pass
    inner, u, after = tracing.spans()
    assert (inner.name, inner.parent, u.name, u.parent) == ("inner", u.id, "u", None)
    assert after.parent is None and after.unit is None


def _fake_nvcc(tmp_path):
    script = tmp_path / "nvcc"
    script.write_text('#!/bin/sh\nwhile [ $# -gt 0 ]; do\n'
                      '  if [ "$1" = "-o" ]; then : > "$2"; fi\n  shift\ndone\n')
    script.chmod(script.stat().st_mode | stat.S_IXUSR)
    return str(script)


def test_build_counters(tmp_path, monkeypatch):
    """A build and its load, then nothing for a library already loaded,
    then (a process that has not loaded it) a load alone."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "_LOADED", {})
    monkeypatch.setattr(build, "nvcc_path", lambda: _fake_nvcc(tmp_path))
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: mock.MagicMock(path=path))

    def delta(before):
        now = tracing.counters()
        return {k: now[k]["count"] - before.get(k, {"count": 0})["count"] for k in now
                if now[k]["count"] != before.get(k, {"count": 0})["count"]}

    src = "extern \"C\" int f() { return 0; }\n"
    before = tracing.counters()
    first = build.build_library(src, [])
    assert delta(before) == {"build.nvcc": 1, "build.disk": 1}
    before = tracing.counters()
    assert build.build_library(src, []) is first
    assert delta(before) == {}
    build._LOADED.clear()
    before = tracing.counters()
    build.build_library(src, [])
    assert delta(before) == {"build.disk": 1}
    assert tracing.counters()["build.nvcc"]["seconds"] > 0


def test_counters_lose_no_update_across_threads():
    """The stencil kernels build on a thread pool: concurrent counts all
    land."""
    n_threads, per = 8, 1000
    before = tracing.counters().get("test.stress", {"count": 0, "seconds": 0.0})
    workers = [threading.Thread(target=lambda: [tracing.count("test.stress", 0.5)
                                                for _ in range(per)])
               for _ in range(n_threads)]
    for w in workers:
        w.start()
    for w in workers:
        w.join(timeout=60)
    assert not any(w.is_alive() for w in workers)
    after = tracing.counters()["test.stress"]
    assert after["count"] - before["count"] == n_threads * per
    assert after["seconds"] - before["seconds"] == pytest.approx(0.5 * n_threads * per)


def test_the_conv1d_schedule_detection_is_counted(monkeypatch):
    monkeypatch.setattr(conv_ops, "_KERNELS", {})
    monkeypatch.setattr(conv_ops, "build_library",
                        lambda source, dirs: build.Library(mock.MagicMock(), None, 0.0))
    before = tracing.counters().get("kernels.synthesize", {"count": 0, "seconds": 0.0})
    conv_ops.build_kernels([("shuffle", 4), ("naive", 4), ("shuffle", 4)])
    after = tracing.counters()["kernels.synthesize"]
    assert after["count"] == before["count"] + 2
    assert after["seconds"] > before["seconds"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_spans_leave_device_ranges_on_the_card(card):
    """On the card each span that launches work leaves a device-side
    ``repro::`` range over its kernels in the profiler's trace: one a
    block, mixer layer and plain backward, each mixer layer's inside a
    block's, and the backward spans name their kernels.  The remat
    recompute stops once the out-projection's inputs are saved, before
    its kernel, so its ``mamba2.out_proj`` spans leave none."""
    from torch.autograd import DeviceType

    model = _model("block", "cuda", dtype="bfloat16", d_model=256, ssm_head_dim=64,
                   ssm_state=64, ssm_chunk=64)
    run = _step(model)
    run()
    spans, prof = _traced(run, (ProfilerActivity.CPU, ProfilerActivity.CUDA))
    ranges = collections.defaultdict(list)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and e.name.startswith(tracing.PREFIX):
            ranges[e.name[len(tracing.PREFIX):]].append((e.time_range.start, e.time_range.end))
    launched = collections.Counter(s.name for s in spans
                                   if not (s.backward and s.name == "mamba2.out_proj"))
    for name in ("model.block", *MIXER, "autograd.backward"):
        assert len(ranges[name]) == launched[name] > 0, name
    for name in MIXER:
        for a, b in ranges[name]:
            assert any(s <= a <= b <= e for s, e in ranges["model.block"]), name
    kernels = collections.Counter(s.attrs["kernel"] for s in spans
                                  if s.name == "autograd.backward")
    assert kernels == {"conv1d": 3, "ssd": 3}
