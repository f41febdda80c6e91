"""Parity of the port's static analyzer (``repro_torch.core.analysis.lint``
with ``defuse``, ``races``, ``sync`` and ``relational``) with the JAX
package's: the findings on every ``tests/lint_corpus/`` file and on the 19
KernelGen sources (lowered and synthesized), the ``verify-ptx`` pass's
diagnostics under ``lint="warn"`` and ``"strict"``, the CLI's exit codes
and output, and a cached recompile that keeps its findings."""

import glob
import json
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")  # the port's tests need PyTorch

from emulator_golden import BRANCHY_PTX
from test_lint import CORPUS_EXPECTATIONS, GATED_PTX, UNGATED_PTX

from repro.core.analysis import lint as ref_lint
from repro.core import driver as ref_driver
from repro.core.frontend import kernelgen as ref_kernelgen
from repro.core.frontend.stencil import lower_to_ptx as ref_lower
from repro_torch.core.analysis import lint
from repro_torch.core import driver
from repro_torch.core.frontend import kernelgen
from repro_torch.core.frontend.stencil import lower_to_ptx

CORPUS_DIR = os.path.join(os.path.dirname(__file__), "lint_corpus")
CORPUS = sorted(os.path.basename(p) for p in glob.glob(os.path.join(CORPUS_DIR, "*.ptx")))
SOURCES = sorted(ref_kernelgen.all_benches(include_apps=True))
SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")


def _corpus(name):
    with open(os.path.join(CORPUS_DIR, name), encoding="utf-8") as fh:
        return fh.read()


def findings(fs):
    """Package-free view of findings: code, severity, uid, message and the
    rest of the wire form."""
    return [f.to_dict() for f in fs]


def diagnostics(result):
    return [(d.severity.name, d.message, d.source, d.kernel, d.code, d.location)
            for d in result.diagnostics]


def strip_times(obj):
    """A wire form without its times and the process-history counter."""
    if isinstance(obj, dict):
        return {k: (sorted(v) if k == "pass_times" else strip_times(v))
                for k, v in obj.items()
                if not k.endswith("time_s") and k != "terms_interned"}
    if isinstance(obj, list):
        return [strip_times(x) for x in obj]
    return obj


def test_corpora_are_the_reference_s():
    assert set(CORPUS) == set(CORPUS_EXPECTATIONS) and len(CORPUS) == 10
    for which in ("kernelgen", "apps", "all"):
        assert [n for n, _ in lint.corpus_kernels(which)] == \
            [n for n, _ in ref_lint.corpus_kernels(which)]
    assert len(lint.corpus_kernels("all")) == len(SOURCES) == 19


@pytest.mark.parametrize("fname", CORPUS)
def test_corpus_findings_match_reference(fname):
    """Every planted bug, with the reference's code, severity, uid and
    message; the clean twins clean in both."""
    text = _corpus(fname)
    got, ref = lint.lint_source(text), ref_lint.lint_source(text)
    assert findings(got) == findings(ref)
    assert {(f.code, f.severity.name, f.uid) for f in got} == CORPUS_EXPECTATIONS[fname]
    assert lint.summarize(got) == ref_lint.summarize(ref)


@pytest.mark.parametrize("text", [BRANCHY_PTX, GATED_PTX, UNGATED_PTX],
                         ids=["branchy", "gated", "ungated"])
def test_hand_written_kernels_match_reference(text):
    assert findings(lint.lint_source(text)) == findings(ref_lint.lint_source(text))


@pytest.mark.parametrize("name", SOURCES)
def test_sources_lint_like_reference(name):
    """Each lowered source lints clean in both; its synthesized PTX (Volta,
    full-mask ``shfl.sync``) gives the reference's ``membermask-proven``
    NOTEs."""
    port_k = lower_to_ptx(kernelgen.get_bench(name).program)
    ref_k = ref_lower(ref_kernelgen.get_bench(name).program)
    assert lint.lint_kernel(port_k, kernel_name=name) == []
    assert ref_lint.lint_kernel(ref_k, kernel_name=name) == []
    syn = driver.Compiler(jobs=0).compile(kernelgen.get_bench(name), target="volta")
    ref_syn = ref_driver.Compiler(jobs=0).compile(ref_kernelgen.get_bench(name),
                                                  target="volta")
    assert syn.ptx == ref_syn.ptx
    got, ref = lint.lint_source(syn.ptx), ref_lint.lint_source(ref_syn.ptx)
    assert findings(got) == findings(ref)
    assert all(f.code == "membermask-proven" for f in got)


@pytest.mark.parametrize("mode", ["warn", "strict"])
@pytest.mark.parametrize("fname", CORPUS)
def test_compile_diagnostics_match_reference(fname, mode):
    """The ``verify-ptx`` pass: findings, diagnostics (strict escalates a
    WARNING to an ERROR, NOTEs stay NOTEs), lint counters and PTX."""
    text = _corpus(fname)
    with driver.Compiler(jobs=0, lint=mode) as cc:
        res = cc.compile(text, cache=None)
    with ref_driver.Compiler(jobs=0, lint=mode) as cc:
        ref = cc.compile(text, cache=None)
    assert res.ptx == ref.ptx
    assert findings(res.findings) == findings(ref.findings)
    assert diagnostics(res) == diagnostics(ref)
    assert res.lint_counters == ref.lint_counters
    assert "verify-ptx" in res.pass_times
    if mode == "strict":
        assert all(d.severity.name in ("ERROR", "NOTE")
                   for d in res.diagnostics if d.source == "verify-ptx")


def test_lint_off_runs_no_verify_pass_like_reference():
    res = driver.Compiler(jobs=0).compile(BRANCHY_PTX, cache=None)
    ref = ref_driver.Compiler(jobs=0).compile(BRANCHY_PTX, cache=None)
    assert "verify-ptx" not in res.pass_times and res.findings == []
    assert diagnostics(res) == diagnostics(ref)


def test_duplicate_kernel_diagnostics_dedupe_like_reference():
    text = _corpus("width_mismatch.ptx") * 2
    res = driver.Compiler(jobs=0, lint="warn").compile(text, cache=None)
    ref = ref_driver.Compiler(jobs=0, lint="warn").compile(text, cache=None)
    assert diagnostics(res) == diagnostics(ref)
    assert len([d for d in res.diagnostics if d.code == "width-mismatch"]) == 1


def test_wire_form_matches_reference():
    text = _corpus("shared_race.ptx")
    res = driver.Compiler(jobs=0, lint="warn").compile(text, cache=None)
    ref = ref_driver.Compiler(jobs=0, lint="warn").compile(text, cache=None)
    wire, ref_wire = res.to_json_dict(), ref.to_json_dict()
    assert strip_times(wire) == strip_times(ref_wire)
    back = driver.CompileResult.from_json_dict(json.loads(json.dumps(wire)))
    assert findings(back.findings) == findings(res.findings)
    assert back.lint_counters == res.lint_counters


@pytest.mark.parametrize("disk", [False, True], ids=["memory", "disk"])
def test_cached_recompile_keeps_findings(disk, tmp_path):
    """Findings ride the report, so a memory hit (and, with a disk tier, a
    fresh session's disk hit) gives the reference's findings again."""
    text = _corpus("undef_use.ptx")
    with ref_driver.Compiler(jobs=0, lint="warn") as cc:
        ref = cc.compile(text)
    cache_dir = str(tmp_path) if disk else None
    with driver.Compiler(jobs=0, lint="warn", cache_dir=cache_dir) as cc:
        first = cc.compile(text)
        second = cc.compile(text)
    assert second.cached and not first.cached
    assert findings(second.findings) == findings(first.findings) == findings(ref.findings)
    if disk:
        with driver.Compiler(jobs=0, lint="warn", cache_dir=cache_dir) as cc:
            third = cc.compile(text)
            assert cc.cache_stats.disk_hits == 1 and not cc.pass_times
        assert findings(third.findings) == findings(ref.findings)
        assert diagnostics(third) == diagnostics(ref)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def _files(*names):
    return [os.path.join(CORPUS_DIR, n) for n in names]


CLI_CASES = {
    "clean_corpus": (["--corpus", "all", "--strict"], 0),
    "corpus_files_strict": (["--strict", *_files(*CORPUS)], 1),
    "corpus_files_default": (_files(*CORPUS), 1),
    "corpus_files_errors_only": (["--errors-only", *_files(*CORPUS)], 1),
    "proven_note": (_files("mask_reg_full.ptx"), 0),
    "warning": (_files("mask_loop_carried.ptx"), 1),
    "warning_errors_only": (["--errors-only", *_files("mask_loop_carried.ptx")], 0),
    "missing_file": (_files("no_such_file.ptx"), 2),
    "json": (["--json", *_files("undef_use.ptx")], 1),
    "json_corpus": (["--json", *_files(*CORPUS)], 1),
    "synthesized": (["--bench", "jacobi", "--synthesized", "--target", "volta", "--json"], 0),
    "synthesized_widen": (["--bench", "laplacian,wave13pt", "--synthesized",
                           "--target", "volta", "--widen", "--json"], 0),
}


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_cli_matches_reference(case, capsys):
    """Exit codes 0 clean / 1 findings >= WARNING / 2 usage error, and the
    same text or JSON on standard output."""
    argv, code = CLI_CASES[case]
    assert lint.main(list(argv)) == code
    out = capsys.readouterr().out
    assert ref_lint.main(list(argv)) == code
    ref_out = capsys.readouterr().out
    assert out == ref_out
    if "--json" in argv:
        payload = json.loads(out)
        assert payload["schema"] == lint.JSON_SCHEMA == ref_lint.JSON_SCHEMA
        assert payload["schema_version"] == 1
    elif case == "corpus_files_strict":
        assert "4 error(s), 3 warning(s), 2 note(s)" in out


def test_cli_runs_as_a_module_without_the_reference():
    """``python -m repro_torch.core.analysis.lint`` in a subprocess that
    cannot import ``jax`` or ``repro``."""
    code = (
        "import sys, runpy\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        f"sys.argv = ['lint', '--json', {os.path.join(CORPUS_DIR, 'div_shfl.ptx')!r}]\n"
        "try:\n"
        "    runpy.run_module('repro_torch.core.analysis.lint', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    bad = sorted(m for m in sys.modules if m.split('.')[0] in ('repro', 'jax')\n"
        "                 and sys.modules[m] is not None)\n"
        "    assert not bad, bad\n"
        "    raise\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, env=dict(os.environ, PYTHONPATH=SRC))
    assert out.returncode == 1, out.stderr
    [f] = json.loads(out.stdout)["findings"]
    assert (f["code"], f["severity"], f["uid"]) == ("divergent-shfl", "ERROR", 7)
