"""Whole runs on the CPU at the stand-in size: the result line, the faults
the check must catch, the import rules, the look for a card, and the
pieces found by name."""

import json
import shutil
import subprocess
import sys
import textwrap

import pytest
import torch

from conftest import OVERRIDES, ROOT, run_small
from portbench import harness

CELLS = sorted(OVERRIDES)
SERVED = [c for c in CELLS if "pretrain" not in c]
TRAIN = "mamba2-1.3b.pretrain-2k"


@pytest.mark.parametrize("cell", CELLS)
def test_result_line_shape(cell):
    line = run_small(cell)
    notes = ["notes"] if cell == TRAIN else []
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", *notes,
                          "seconds", "checks"]
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    bench = harness.read_json(ROOT / "BENCHMARK.json")
    want = {m["name"] for m in bench["end_to_end"] if cell in m.get("workloads", [cell])}
    assert set(line["metrics"]) == want
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    limits = harness.read_json(harness.HERE / "limits" / f"{cell}.json")
    assert set(line["checks"]) == set(limits)
    json.dumps(line)


# ---------------------------------------------------------------------------
# faults underneath the timed path: each must read as not correct
# ---------------------------------------------------------------------------

def altered_generate(real):
    def generate(model, batch, n_tokens, *args, **kwargs):
        out = real(model, batch, n_tokens, *args, **kwargs)
        out[0, -1] = (out[0, -1] + model.cfg.vocab // 2) % model.cfg.vocab
        return out
    return generate


@pytest.mark.parametrize("cell", SERVED)
def test_a_token_altered_where_it_is_produced_is_caught(cell, monkeypatch):
    from repro_torch.serve import step

    monkeypatch.setattr(step, "generate", altered_generate(step.generate))
    line = run_small(cell)
    assert line["correct"] is False
    assert line["checks"]["served_gap_max"]["value"] > line["checks"]["served_gap_max"]["limit"]


def test_a_step_that_leaves_the_state_unchanged_is_caught(monkeypatch):
    import repro_torch.train.step as tstep

    real = tstep.adamw_update

    def unchanged(cfg, grads, state, params, ndims=None):
        return params, state._replace(count=state.count + 1), {
            "grad_norm": torch.zeros(()), "lr": torch.zeros(())}

    monkeypatch.setattr(tstep, "adamw_update", unchanged)
    line = run_small(TRAIN)
    assert line["correct"] is False
    assert line["checks"]["change_gap"]["value"] == pytest.approx(1.0)
    assert line["checks"]["change_diff_f32_median"]["value"] == pytest.approx(1.0)
    assert real is not unchanged


def test_a_float32_update_in_the_wrong_direction_is_caught(monkeypatch):
    """The float32 leaves stepped against their update: every norm of a
    change reads as the reference's, the change itself does not."""
    import repro_torch.train.step as tstep

    real = tstep.adamw_update

    def reversed_f32(cfg, grads, state, params, ndims=None):     # updates in place
        old = {k: p.detach().clone() for k, p in params.items() if p.dtype == torch.float32}
        out = real(cfg, grads, state, params, ndims)
        with torch.no_grad():
            for k, p in old.items():
                params[k].copy_(2 * p - params[k])
        return out

    monkeypatch.setattr(tstep, "adamw_update", reversed_f32)
    line = run_small(TRAIN)
    assert line["correct"] is False
    checks = line["checks"]
    assert checks["change_diff_f32_median"]["value"] > checks["change_diff_f32_median"]["limit"]
    assert checks["change_gap"]["value"] < checks["change_gap"]["limit"]


def test_half_the_batch_left_out_is_caught(monkeypatch):
    from repro_torch.models.lm import SSMModel

    real = SSMModel.loss

    def half_loss(self, batch):
        rows = batch["tokens"].shape[0] // 2
        return real(self, {k: v[:rows] for k, v in batch.items()})

    monkeypatch.setattr(SSMModel, "loss", half_loss)
    line = run_small(TRAIN)
    assert line["correct"] is False


# ---------------------------------------------------------------------------
# what the runs load, and where they refuse to run
# ---------------------------------------------------------------------------

def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = textwrap.dedent(f"""
        import sys
        sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'portbench' / 'tests')!r}]
        from conftest import OVERRIDES, run_small
        from portbench import harness
        for cell in sorted(OVERRIDES):
            assert run_small(cell)["correct"]
        print(sorted(m for m in sys.modules if m.split(".")[0] in harness.FORBIDDEN))
        print("repro_torch" in sys.modules)
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split("\n")[:2] == ["[]", "True"]


def test_the_reference_loads_nothing_of_the_program():
    code = textwrap.dedent(f"""
        import sys
        sys.path[:0] = [{str(ROOT)!r}]
        import portbench.reference.model, portbench.reference.adamw
        print(sorted({{m.split(".")[0] for m in sys.modules}}
                     & {{"repro_torch", "repro", "jax"}}))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"


def test_forbidden_names_compare_whole():
    import repro_torch  # noqa: F401  (its name begins with the JAX package's)

    assert "repro_torch" not in harness.forbidden_modules()


def run_py(cwd):
    return subprocess.run([sys.executable, "portbench/run.py", "--workload",
                           "mamba2-1.3b.prefill-pool", "--seed", str(2**31 + 1),
                           "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, cwd=cwd, timeout=300)


def test_run_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = run_py(ROOT)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA" in out.stderr


def test_run_without_the_program_prints_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = run_py(tmp_path)
    assert out.returncode != 0 and out.stdout == ""


# ---------------------------------------------------------------------------
# a new configuration, mix, metric or limit is found by name
# ---------------------------------------------------------------------------

def test_new_pieces_are_found_by_name(tmp_path):
    made = {
        harness.HERE / "configs" / "test-new-config.json":
            {**harness.read_json(harness.HERE / "configs" / "mamba2-1.3b.json"),
             "name": "test-new-config"},
        harness.HERE / "traffic" / "test-new-mix.json":
            {**harness.read_json(harness.HERE / "traffic" / "prefill-pool.json"),
             "deck": [[16, 1], [48, 1]]},
        harness.HERE / "limits" / "test-new-config.test-new-mix.json":
            harness.read_json(harness.HERE / "limits" / "mamba2-1.3b.prefill-pool.json"),
    }
    metric = harness.HERE / "metrics" / "test_new_metric.prefill.py"
    bench = harness.read_json(ROOT / "BENCHMARK.json")
    cell = "test-new-config.test-new-mix"
    bench["configs"].append({"name": "test-new-config", "source": "test",
                             "file": "portbench/configs/test-new-config.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": cell, "config": "test-new-config",
                               "traffic": "test-new-mix", "chips": 1, "why": "test"})
    bench["end_to_end"][0]["workloads"].append(cell)
    bench["per_layer"].append({"name": "test_new_metric.prefill", "unit": "count",
                               "better": "higher", "source": "program_counter",
                               "layer": "test", "moves": "ttft_ms_p95", "workloads": [cell]})
    bench_file = tmp_path / "BENCHMARK.json"
    bench_file.write_text(json.dumps(bench))
    try:
        for path, obj in made.items():
            path.write_text(json.dumps(obj))
        metric.write_text("def read(r):\n    return 7.0\n")
        found = harness.find_cell(cell, bench_file)
        assert found.traffic["deck"] == [[16, 1], [48, 1]]
        assert [m["name"] for m in found.per_layer] == ["test_new_metric.prefill"]
        line = harness.run(cell, 2**31 + 5, 0.0, False, t0=0.0, device="cpu",
                           overrides={"model": OVERRIDES["mamba2-1.3b.prefill-pool"]["model"],
                                      "traffic": {"batch": 2, "check_requests": 2}},
                           min_units=2, bench_file=bench_file)
        assert line["correct"] and "ttft_ms_p95" in line["metrics"]
        assert harness.per_layer(found, None) == {"test_new_metric.prefill":
                                                  {"value": 7.0, "unit": "count"}}
    finally:
        for path in [*made, metric]:
            path.unlink(missing_ok=True)


# ---------------------------------------------------------------------------
# the stand-ins the limits' upper readings come from (on the card:
# test_portbench_trace.py, at the cells' own sizes)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cell", SERVED)
def test_the_fp8_control_reads_no_less_than_the_program(cell):
    line = run_small(cell, controls=("fp8",))
    program = line["checks"]["served_gap_max"]["value"]
    assert line["controls"]["fp8"]["served_gap_max"] >= program


def test_the_training_stand_ins_read_above_the_program():
    line = run_small(TRAIN, controls=("fp8", "half_batch"))
    for stand_in in ("fp8", "half_batch"):
        for name, check in line["checks"].items():
            assert line["controls"][stand_in][name] > 10 * check["value"]
