"""The per-layer metrics that read the program's spans and counters
(``plain_bwd_launches.train``, ``kernel_build_s.setup``) on hand-made
trace events and counters; and, on the card at the cells' own sizes, the
program's spans against the trace: the kernels inside the blocks' and the
mixer layers' device-side ``repro::`` ranges against the deck's busy time
and the benchmark's own ranges, and the counted launch calls against the
device operations they enqueued."""

import collections
from types import SimpleNamespace

import pytest
import torch

from portbench import harness
from portbench.trace import Calls, Trace, sites, traced
from repro_torch import tracing

PREFILL, TRAIN = "mamba2-1.3b.prefill-pool", "mamba2-1.3b.pretrain-2k"


def metric(name):
    return harness.load_module(harness.HERE / "metrics" / f"{name}.py")


def readings(kind, host=()):
    """Readings whose trace holds one device operation and ``host``."""
    ev = [SimpleNamespace(name=n, time_range=SimpleNamespace(start=a, end=b),
                          device_type=torch.autograd.DeviceType.CPU) for a, b, n in host]
    ev.append(SimpleNamespace(name="k", time_range=SimpleNamespace(start=0, end=1),
                              device_type=torch.autograd.DeviceType.CUDA))
    return harness.Readings(kind=kind, cfg={}, trace=Trace(ev), calls=Calls(), window={},
                            traced={})


def test_plain_backward_launches_a_step():
    m = metric("plain_bwd_launches.train")
    host = [(0, 100, "repro::train.step"),
            (10, 20, "repro::autograd.backward"), (12, 13, "cudaLaunchKernel"),
            (14, 15, "cudaMemsetAsync"), (16, 17, "cudaEventRecord"), (18, 19, "aten::mm"),
            (21, 22, "cudaLaunchKernel"),                       # after the range
            (30, 50, "repro::autograd.backward"), (35, 45, "repro::model.block"),
            (40, 41, "cuLaunchKernelEx"), (42, 43, "cudaLaunchKernelExC"),
            (44, 45, "cudaMemcpyAsync"),
            (100, 200, "repro::train.step"),
            (110, 120, "repro::autograd.backward"), (111, 112, "cudaLaunchKernel")]
    assert m.launches_inside(sorted(host)) == 6
    assert m.read(readings("train", host)) == 3 and isinstance(m.read(readings("train", host)), int)
    assert m.read(readings("train", host[:-2])) == 2.5
    assert m.read(readings("prefill", host)) is None
    assert m.read(readings("train", [(0, 100, "repro::train.step")])) is None


def test_kernel_build_seconds(monkeypatch):
    m = metric("kernel_build_s.setup")
    monkeypatch.setattr(tracing, "counters", lambda: {
        "build.nvcc": {"count": 2, "seconds": 30.0}, "build.disk": {"count": 3, "seconds": 0.5},
        "kernels.synthesize": {"count": 2, "seconds": 1.25}})
    assert m.read(readings("prefill")) == pytest.approx(1.75)      # no nvcc seconds
    monkeypatch.setattr(tracing, "counters", lambda: {"other": {"count": 1, "seconds": 9.0}})
    assert m.read(readings("train")) is None


# ---------------------------------------------------------------------------
# on the card, at the cells' own sizes
# ---------------------------------------------------------------------------

def kind_of(cell_name, seed):
    """The cell's kind, set up on the card at the cell's size."""
    cell = harness.find_cell(cell_name)
    ctx = harness.Run(cell=cell, seed=seed, seconds=0.0, device=torch.device("cuda"),
                      model_cfg=dict(cell.config["model"]), traffic=dict(cell.traffic),
                      port_cfg=harness.port_config(cell.config, {}))
    kind = harness.load_module(harness.HERE / "kinds" / f"{cell.traffic['kind']}.py").Kind(ctx)
    kind.setup()
    return kind


def repro_ranges(tr, events):
    """The trace's device-side ``repro::<name>`` ranges put beside the
    benchmark's own under the site name ``repro::<name>``."""
    from torch.autograd import DeviceType

    for e in events:
        if e.device_type == DeviceType.CUDA and e.name.startswith(tracing.PREFIX):
            tr.spans.setdefault(e.name, []).append((e.time_range.start, e.time_range.end))
    return tr


@pytest.mark.cuda
def test_the_deck_spans_agree_with_the_trace(card):
    """The kernels inside the ``model.block`` spans' device-side ranges
    take at least 90 % of the deck's busy time, and those inside the
    ``mamba2.ssd`` and ``mamba2.conv1d`` ranges take within 5 % of the
    device time inside the benchmark's own ranges around the same calls;
    the readings are printed.  A kernel's device-side range is that of
    the innermost range open at its launch, so the benchmark's wrappers,
    which open inside the mixer's spans, leave those spans no range of
    their own: the spans are read from a second trace of the deck, made
    without the wrappers."""
    kind = kind_of(PREFILL, 2**31 + 2801)
    with sites(Calls()):
        wrapped = Trace(traced(kind.traced_part, PREFILL))
    events = traced(kind.traced_part, PREFILL)
    tr = repro_ranges(Trace(events), events)
    seconds = {name[len(tracing.PREFIX):]: tr.in_site(name)[1] for name in tr.spans
               if name.startswith(tracing.PREFIX)}
    block_share = seconds["model.block"] / tr.busy_s
    ratio = {site: seconds[f"mamba2.{site}"] / wrapped.in_site(site)[1]
             for site in ("ssd", "conv1d")}
    print(f"[spans] deck busy {tr.busy_s:.4f} s of {tr.window_s:.4f} s (wrapped "
          f"{wrapped.busy_s:.4f} of {wrapped.window_s:.4f}); blocks "
          f"{seconds['model.block']:.4f} s = {100 * block_share:.2f} % of busy; repro / "
          f"portbench: ssd {ratio['ssd']:.4f}, conv1d {ratio['conv1d']:.4f}; device s by span "
          f"{seconds}; idle gaps {tr.idle_gaps()}")
    assert block_share >= 0.90
    assert all(abs(r - 1) <= 0.05 for r in ratio.values())


@pytest.mark.cuda
def test_the_counted_launches_are_the_ones_that_enqueue_work(card):
    """Inside ``PlainGrad.backward``'s ranges, every runtime or driver call
    (a host event linked to the operation that made it) that enqueued a
    device operation (by correlation id in the raw profiler events) is one
    the metric counts, and each counted call enqueued one; two steps read
    the same count."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    m = metric("plain_bwd_launches.train")
    kind = kind_of(TRAIN, 2**31 + 2802)
    counts = []
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            kind.traced_part()
            torch.cuda.synchronize()
        counts.append(m.read(readings_of(prof.events())))
    raw = prof.profiler.kineto_results.events()
    on_host = [e for e in raw if e.device_type() == DeviceType.CPU]
    ranges = sorted((e.start_ns(), e.start_ns() + e.duration_ns()) for e in on_host
                    if e.name() == m.BACKWARD)
    inside = lambda t: any(a <= t <= b for a, b in ranges)      # noqa: E731
    device = collections.defaultdict(list)
    for e in raw:
        if e.device_type() == DeviceType.CUDA and not e.name().startswith(("repro::",
                                                                           "portbench::")):
            device[e.correlation_id()].append(e.name())
    calls = [e for e in on_host if e.linked_correlation_id() > 0 and inside(e.start_ns())]
    enqueuing = collections.Counter(e.name() for e in calls if device.get(e.correlation_id()))
    counted = [e for e in calls if e.name() in m.LAUNCHES]
    print(f"[spans] plain backward launches a step {counts}; {len(ranges)} ranges; enqueuing "
          f"calls {dict(enqueuing)}; calls inside {dict(collections.Counter(e.name() for e in calls))}; "
          f"device operations of counted calls "
          f"{sum(len(device.get(e.correlation_id(), [])) for e in counted)}")
    assert set(enqueuing) <= set(m.LAUNCHES)
    assert all(device.get(e.correlation_id()) for e in counted)
    assert counts[0] == counts[1] == len(counted) > 0


def readings_of(events):
    return harness.Readings(kind="train", cfg={}, trace=Trace(events), calls=Calls(),
                            window={}, traced={})
