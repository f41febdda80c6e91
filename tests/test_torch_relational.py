"""Parity of the port's relational abstract interpreter
(``repro_torch.core.analysis.relational``) with the JAX package's: the
per-lane solver (``lanes_may``, ``_lane_invariant``) on the reference
test's expressions, the fixpoint, the survivor sets per block, the
membermask prover's verdicts on the ``mask_*`` corpus files, and
proof-widened synthesis (``widen=True``) on the 19 KernelGen sources and
on the reference's two widen fixtures."""

import os

import pytest

pytest.importorskip("torch")  # the port's tests need PyTorch

from test_lint import GATED_PTX, UNGATED_PTX
from test_relational import STRAIGHT_PTX, TWO_RACES_PTX, VACUOUS_PTX

import repro.core.analysis.relational as ref_rel
import repro.core.passes.analyses  # noqa: F401  (registers cfg etc.)
from repro.core import driver as ref_driver
from repro.core.emulator.decode import K_SHFL as REF_K_SHFL
from repro.core.frontend import kernelgen as ref_kernelgen
from repro.core.passes.context import KernelContext as RefContext
from repro.core.passes.context import PipelineConfig as RefConfig
from repro.core.ptx.parser import parse as ref_parse
from repro.core.symbolic import terms as ref_terms
import repro_torch.core.analysis.relational as rel
import repro_torch.core.passes.analyses  # noqa: F401
from repro_torch.core import driver
from repro_torch.core.analysis.lint import lint_source, summarize
from repro_torch.core.emulator.decode import K_SHFL
from repro_torch.core.frontend import kernelgen
from repro_torch.core.passes.context import KernelContext, PipelineConfig
from repro_torch.core.ptx.parser import parse
from repro_torch.core.symbolic import terms

CORPUS_DIR = os.path.join(os.path.dirname(__file__), "lint_corpus")
SOURCES = sorted(ref_kernelgen.all_benches(include_apps=True))
FULL = 0xFFFFFFFF
MASK_FILES = ["mask_reg_full.ptx", "mask_wrong.ptx", "mask_guarded_covering.ptx",
              "mask_loop_carried.ptx"]


def _corpus(name):
    with open(os.path.join(CORPUS_DIR, name), encoding="utf-8") as fh:
        return fh.read()


def _ctxs(text, **config):
    """The same kernel in a context of each package."""
    return (KernelContext(parse(text).kernels[0], PipelineConfig(**config)),
            RefContext(ref_parse(text).kernels[0], RefConfig(**config)))


# ---------------------------------------------------------------------------
# the per-lane solver, on the reference test's expressions
# ---------------------------------------------------------------------------

def _expressions(t):
    """name -> the reference test's boolean expressions, built from one
    package's ``symbolic.terms``."""
    Cmp, Term = t.Cmp, t.Term
    tid, laneid = Term.sym("tid.x"), Term.sym("laneid")
    lt16 = Cmp("lt", tid, Term.const_(16), signed=False)
    ge32 = Cmp("ge", laneid, Term.const_(32), signed=False)
    lt8 = Cmp("lt", tid, Term.const_(8), signed=False)
    ge4 = Cmp("ge", tid, Term.const_(4), signed=False)
    return {
        "tid_lt16": lt16, "tid_ge16": lt16.negate(),
        "laneid_ge32": ge32, "laneid_lt32": ge32.negate(),
        "tid_eq5": Cmp("eq", tid, Term.const_(5), signed=False),
        "conjunction": t.bool_and(lt8, ge4),
        "disjunction": t.bool_or(lt8, ge4),
        "unknown": None,
        "opaque": Cmp("lt", Term.sym("x"), Term.sym("y"), signed=False),
        "uniform": Cmp("lt", Term.const_(2), Term.const_(4), signed=False),
        "opaque_k": Cmp("lt", Term.sym("k"), Term.const_(4), signed=False),
        "cancel": Cmp("lt", tid.add(Term.const_(1)), tid, signed=False),
        "laneid_and": Cmp("lt", laneid.add(Term.const_(3)), Term.const_(9), signed=False),
        "signed_tid": Cmp("lt", tid, Term.const_(20), signed=True),
    }


EXPRESSIONS = sorted(_expressions(terms))
#: what the reference test asserts of ``lanes_may`` where it asserts it
LANES_MAY = {"tid_lt16": 0xFFFF, "tid_ge16": FULL, "laneid_ge32": 0,
             "laneid_lt32": FULL, "tid_eq5": 1 << 5, "conjunction": 0xFF,
             "unknown": FULL, "opaque": FULL}
LANE_INVARIANT = {"uniform": True, "tid_lt16": False, "opaque_k": False, "cancel": True}


@pytest.mark.parametrize("name", EXPRESSIONS)
def test_lanes_may_and_lane_invariant_match_reference(name):
    e, ref_e = _expressions(terms)[name], _expressions(ref_terms)[name]
    for lane in ("tid.x", "laneid"):
        got = rel.lanes_may(e, lane)
        assert got == ref_rel.lanes_may(ref_e, lane)
        if e is not None:
            assert rel._lane_invariant(e, lane) == ref_rel._lane_invariant(ref_e, lane)
    if name in LANES_MAY:
        assert rel.lanes_may(e, "tid.x") == LANES_MAY[name]
    if name in LANE_INVARIANT:
        assert rel._lane_invariant(e, "tid.x") == LANE_INVARIANT[name]


# ---------------------------------------------------------------------------
# the fixpoint, survivor sets and the prover
# ---------------------------------------------------------------------------

def _env(env):
    return ({k: repr(v) for k, v in env.regs.items()},
            {k: repr(v) for k, v in env.preds.items()})


def _relational(ctx):
    info = ctx.get("relational")
    return ([_env(e) for e in info.entry], [_env(e) for e in info.exit],
            {u: repr(c) for u, c in info.branch_cond.items()}, info.iterations)


def _survivors(ctx):
    s = ctx.get("survivors")
    n = len(s.lanes)
    return (s.lanes, s.branch_class, s.block_level, s.n_refined,
            [s.proven_full(b) for b in range(n)], [s.contiguous_bound(b) for b in range(n)])


KERNELS = {**{f: _corpus(f) for f in sorted(os.listdir(CORPUS_DIR)) if f.endswith(".ptx")},
           "straight": STRAIGHT_PTX, "vacuous": VACUOUS_PTX, "gated": GATED_PTX,
           "ungated": UNGATED_PTX, "two_races": TWO_RACES_PTX}


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_fixpoint_and_survivors_match_reference(name):
    """Entry and exit environments, branch facts, survivor lanes and
    refined levels per block, the refined JOIN blocks and the proofs."""
    ctx, ref_ctx = _ctxs(KERNELS[name])
    assert _relational(ctx) == _relational(ref_ctx)
    assert _survivors(ctx) == _survivors(ref_ctx)
    assert rel.refined_join_block_ids(ctx) == ref_rel.refined_join_block_ids(ref_ctx)
    uids = [d.uid for d in ctx.get("decoded")]
    assert [rel.refined_level_of_uid(ctx, u) for u in uids] == \
        [ref_rel.refined_level_of_uid(ref_ctx, u) for u in uids]
    proofs = {u: (p.verdict, p.mask, p.survivors, p.via)
              for u, p in rel.prove_shfl_masks(ctx).items()}
    assert proofs == {u: (p.verdict, p.mask, p.survivors, p.via)
                      for u, p in ref_rel.prove_shfl_masks(ref_ctx).items()}


@pytest.mark.parametrize("fname", MASK_FILES)
def test_prover_verdicts_on_the_mask_quartet(fname):
    ctx, ref_ctx = _ctxs(_corpus(fname))
    [shfl] = [d for d in ctx.get("decoded") if d.kind == K_SHFL]
    [ref_shfl] = [d for d in ref_ctx.get("decoded") if d.kind == REF_K_SHFL]
    p = rel.prove_shfl_masks(ctx)[shfl.uid]
    r = ref_rel.prove_shfl_masks(ref_ctx)[ref_shfl.uid]
    assert (p.verdict, p.mask, p.survivors, p.via) == (r.verdict, r.mask, r.survivors, r.via)
    want = {"mask_reg_full.ptx": "proven", "mask_wrong.ptx": "noncovering",
            "mask_guarded_covering.ptx": "proven", "mask_loop_carried.ptx": "unknown"}
    assert p.verdict == want[fname]


def test_survivor_clamps_match_reference():
    """The clamp the widened ``synthesize-shuffles`` reads, on the
    exit-guarded fixture's detection."""
    ctx, ref_ctx = _ctxs(UNGATED_PTX, widen=True)
    clamps = rel.survivor_clamps(ctx, ctx.get("detection"))
    assert clamps == ref_rel.survivor_clamps(ref_ctx, ref_ctx.get("detection"))
    assert list(clamps.values()) == [16]


# ---------------------------------------------------------------------------
# proof-widened synthesis
# ---------------------------------------------------------------------------

def _pair(src, ref_src, **opts):
    with driver.Compiler(jobs=0, **opts) as cc:
        res = cc.compile(src, cache=None)
    with ref_driver.Compiler(jobs=0, **opts) as cc:
        ref = cc.compile(ref_src, cache=None)
    assert res.ptx == ref.ptx
    assert res.lint_counters == ref.lint_counters
    assert [(d.severity.name, d.message, d.code) for d in res.diagnostics] == \
        [(d.severity.name, d.message, d.code) for d in ref.diagnostics]
    return res


@pytest.mark.parametrize("name", SOURCES)
def test_widen_on_sources_matches_reference(name):
    """``widen=True`` on each source for Volta: byte-equal to the
    reference's and, since no source has a vacuous guard, to widen-off."""
    on = _pair(kernelgen.get_bench(name), ref_kernelgen.get_bench(name),
               target="volta", widen=True)
    off = _pair(kernelgen.get_bench(name), ref_kernelgen.get_bench(name), target="volta")
    assert on.ptx == off.ptx and on.n_shuffles == off.n_shuffles
    assert "lint_widening_reverted" not in on.lint_counters


def test_widen_keeps_vacuously_gated_pair():
    """The reference's first widen fixture: off drops the pair at the raw
    JOIN gate, on keeps it, in both packages."""
    off = _pair(VACUOUS_PTX, VACUOUS_PTX)
    on = _pair(VACUOUS_PTX, VACUOUS_PTX, widen=True)
    assert off.n_shuffles == 0 and off.lint_counters.get("lint_gated_pairs") == 1
    assert on.n_shuffles == 1 and on.lint_counters.get("lint_widened_pairs") == 1


def test_widen_clamps_exit_guard_masks():
    """The reference's second widen fixture: the survivor prefix clamps the
    corner-case checks and the membermask, which the prover then proves."""
    off = _pair(UNGATED_PTX, UNGATED_PTX, target="volta")
    on = _pair(UNGATED_PTX, UNGATED_PTX, target="volta", widen=True)
    assert "0xffffffff" in off.ptx and "0xffff;" not in off.ptx
    assert on.n_shuffles == 1 and on.lint_counters.get("lint_survivor_clamps") == 1
    assert "0xffff" in on.ptx and "shfl.sync.down.b32" in on.ptx
    s = summarize(lint_source(on.ptx))
    assert (s["errors"], s["warnings"], s["proven_masks"]) == (0, 0, 1)


def test_widen_is_in_the_cache_token_like_reference():
    assert PipelineConfig(widen=True).cache_token() == RefConfig(widen=True).cache_token()
    assert PipelineConfig().cache_token() != PipelineConfig(widen=True).cache_token()
