"""Reading a trace: spans, busy and idle time, gaps, rooflines; and the
control on the card."""

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from portbench import harness, rooflines
from portbench.trace import PREFIX, Calls, Trace


def ev(name, a, b, device=True, annotation=False):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=a, end=b),
                           device_type=DeviceType.CUDA if device else DeviceType.CPU,
                           is_user_annotation=annotation)


EVENTS = [
    ev("aten::mm", 0, 100, device=False),
    ev("cudaLaunchKernel", 40, 45, device=False),
    ev(PREFIX + "unit", 100, 300, device=False),
    ev("aten::copy_", 250, 260, device=False),
    ev("gemm_a", 10, 50),
    ev("gemm_a", 40, 60),                  # overlaps the first: busy counts it once
    ev(PREFIX + "ssd", 150, 200, annotation=True),
    ev("ssd_tc::chunk", 150, 170),
    ev("ssd_tc::scan", 175, 200),
    ev("elementwise", 255, 265),
    ev("other_annotation", 0, 400, annotation=True),
]


def test_busy_spans_and_window():
    tr = Trace(EVENTS)
    assert tr.t0 == 0 and tr.t1 == 265
    assert tr.busy_s == pytest.approx((50 + 20 + 25 + 10) / 1e6)
    assert tr.in_site("ssd") == (2, pytest.approx(45 / 1e6))
    assert tr.in_site("flash") == (0, 0.0)
    assert tr.busy_by_span("ssd") == [pytest.approx(45 / 1e6)]
    assert tr.top_ops(2) == [["gemm_a", pytest.approx(60 / 1e6)],
                             ["ssd_tc::scan", pytest.approx(25 / 1e6)]]


def test_idle_gaps_by_host_operation():
    gaps = Trace(EVENTS).idle_gaps()
    assert gaps == [[PREFIX + "unit", pytest.approx(90 / 1e6)],      # 60-150
                    [PREFIX + "unit", pytest.approx(55 / 1e6)],      # 200-255
                    [PREFIX + "unit", pytest.approx(5 / 1e6)]]       # 170-175


def test_roofline_reads_the_bound_over_the_spans_time():
    calls = Calls()
    calls.add("ssd", dict(B=4, L=1024, H=64, P=64, N=128, chunk=256, dtype="bfloat16"))
    r = harness.Readings(kind="prefill", cfg={}, trace=Trace(EVENTS), calls=calls,
                         window={"flops": 989e12 * 0.5, "seconds": 1.0, "units": {512: 4000}},
                         traced={"unit_site": "ssd", "unit_keys": [512]})
    bound = rooflines.ssd_bound_s(4, 1024, 64, 64, 128, 256, "bfloat16")
    assert r.roofline("ssd", lambda m: rooflines.ssd_bound_s(**m)) == \
        pytest.approx(100 * bound / 45e-6)
    assert r.roofline("conv1d", lambda m: 1.0) is None
    assert r.mfu() == pytest.approx(50.0)
    # 4000 units at the traced unit's 45 us of busy time in a 1 s window
    assert r.idle() == pytest.approx(100 * (1 - 4000 * 45e-6))
    # busier than the window: the two clocks disagree, so no reading
    r.window["units"] = {512: 40000}
    assert r.idle() is None


def test_a_trace_without_device_operations_is_refused():
    with pytest.raises(RuntimeError):
        Trace([ev("aten::mm", 0, 10, device=False)])


@pytest.mark.cuda
def test_the_control_fails_the_check_on_the_card(card):
    """The reference in float8 put in the program's place, at the cell's
    own size: its widest gap must pass the limit the program stays under."""
    import time

    line = harness.run("mamba2-1.3b.prefill-pool", 2**31 + 77, 0.0, False,
                       t0=time.perf_counter(), controls=("fp8",), min_units=25)
    limit = line["checks"]["served_gap_max"]["limit"]
    assert line["correct"]
    assert line["controls"]["fp8"]["served_gap_max"] > limit


@pytest.mark.cuda
def test_the_training_stand_ins_fail_the_check_on_the_card(card):
    import time

    cell = "mamba2-1.3b.pretrain-2k"
    line = harness.run(cell, 2**31 + 78, 0.0, False, t0=time.perf_counter(),
                       controls=("fp8", "half_batch"), min_units=1)
    limits = {k: c["limit"] for k, c in line["checks"].items()}
    assert line["correct"]
    for stand_in in ("fp8", "half_batch"):
        assert any(v > limits[k] for k, v in line["controls"][stand_in].items())
