"""Parity of the port's e-graph (``repro_torch.core.egraph``) with the JAX
package's: one seeded sequence of adds, unions and rebuilds replayed into
both ``EGraph``s, ``saturate_block``'s counters, every rewrite rule on the
reference test's unit cases, and the reference's const-cache fault at the
two seeds its property tests found, raised alike by both."""

from __future__ import annotations

import random

import pytest

pytest.importorskip("torch")  # the port's tests need PyTorch

import repro.core.egraph as ref_egraph
from repro.core.egraph import rules as ref_rules
from repro.core.egraph import saturate as ref_saturate
import repro_torch.core.egraph as egraph
from repro_torch.core.egraph import rules, saturate

#: (package, its rules module, its saturate module)
PACKAGES = {"port": (egraph, rules, saturate),
            "reference": (ref_egraph, ref_rules, ref_saturate)}
OPS = ["add", "mul", "and", "xor", "not", "sub", "shl", "or"]


def _sym(pkg, eg, name, width=32):
    return eg.add(pkg.ENode("sym", width, (), ("in", name)))


def _const(pkg, eg, value, width=32):
    return eg.add(pkg.ENode("const", width, (), rules._mask(value, width)))


def _state(eg, cids):
    """Everything observable of an e-graph, in package-free terms."""
    node = lambda n: (n.op, n.width, n.children, n.payload)  # noqa: E731
    return {"roots": [eg.find(c) for c in cids],
            "classes": [(cid, [node(n) for n in nodes]) for cid, nodes in eg.classes()],
            "const_of": [eg.const_of(c) for c in cids],
            "n_unions": eg.n_unions, "n_classes": eg.n_classes, "n_nodes": eg.n_nodes}


def _replay(which, seed, n_steps=60):
    """One seeded op sequence: leaves, operators over earlier classes,
    unions (of non-constant classes, so the const cache stays sound) and
    rebuilds, with the e-graph's state recorded after each rebuild."""
    pkg, _, _ = PACKAGES[which]
    rng = random.Random(seed)
    eg = pkg.EGraph()
    cids = [_sym(pkg, eg, f"v{i}") for i in range(4)]
    cids += [_const(pkg, eg, rng.randrange(0, 16)) for _ in range(3)]
    consts = set(cids[4:])
    trace = []
    for _ in range(n_steps):
        step = rng.random()
        if step < 0.6:
            op = rng.choice(OPS)
            ch = (rng.choice(cids),) if op == "not" else (rng.choice(cids), rng.choice(cids))
            cids.append(eg.add(pkg.ENode(op, 32, ch)))
        elif step < 0.85:
            free = [c for c in cids if eg.const_of(c) is None and c not in consts]
            a, b = rng.choice(free), rng.choice(free)
            trace.append(("union", eg.union(a, b)))
        else:
            trace.append(("rebuild", eg.rebuild(), _state(eg, cids)))
    trace.append(("rebuild", eg.rebuild(), _state(eg, cids)))
    eg.check_invariants()
    return trace


@pytest.mark.parametrize("seed", range(6))
def test_replayed_sequence_matches_reference(seed):
    """Equal roots, node sets, ``const_of``, ``n_unions`` and rebuild
    counts after every rebuild of one seeded sequence."""
    assert _replay("port", seed) == _replay("reference", seed)


def _random_graph(which, rng, n_leaves, n_ops, n_unions):
    """The reference test's random DAG e-graph with random unions."""
    pkg, _, _ = PACKAGES[which]
    eg = pkg.EGraph()
    cids = [_sym(pkg, eg, f"v{i}") for i in range(n_leaves)]
    cids += [_const(pkg, eg, rng.randrange(0, 8)) for _ in range(2)]
    for _ in range(n_ops):
        op = rng.choice(["add", "mul", "and", "xor", "not"])
        ch = (rng.choice(cids),) if op == "not" else (rng.choice(cids), rng.choice(cids))
        cids.append(eg.add(pkg.ENode(op, 32, ch)))
    for _ in range(n_unions):
        eg.union(rng.choice(cids), rng.choice(cids))
    return eg, cids


@pytest.mark.parametrize("seed", range(4))
def test_saturate_block_counters_match_reference(seed):
    """``saturate_block``'s counters and the saturated graph, under the
    default budgets and under the reference property test's tight ones."""
    for budget in ({}, dict(max_iters=6, max_nodes=2048), dict(max_nodes=64)):
        out = {}
        for which, (pkg, _, sat) in PACKAGES.items():
            rng = random.Random(1000 + seed)
            eg, cids = _random_graph(which, rng, n_leaves=4, n_ops=25, n_unions=0)
            counters = sat.saturate_block(eg, pkg.default_rules(), **budget)
            out[which] = (counters, _state(eg, cids))
        assert out["port"] == out["reference"], budget
        assert out["port"][0]["iterations"] <= budget.get("max_iters", saturate.MAX_ITERS)


def test_registries_and_budgets_match_reference():
    assert [r.name for r in egraph.default_rules()] == \
        [r.name for r in ref_egraph.default_rules()]
    assert list(rules.RULE_REGISTRY) == list(ref_rules.RULE_REGISTRY)
    assert (saturate.MAX_ITERS, saturate.MAX_NODES) == \
        (ref_saturate.MAX_ITERS, ref_saturate.MAX_NODES)


# ---------------------------------------------------------------------------
# the reference test's rule cases, in both packages
# ---------------------------------------------------------------------------

def _c(v, w=32):
    return ("const", v, w)


def _s(name):
    return ("sym", name)


#: name -> (expressions to build, what to read after saturation): an
#: expression is a leaf tuple or (op, width, child, ...)
RULE_CASES = {
    "const_fold_add": ([("add", 32, _c(3), _c(4))], "const"),
    "const_fold_masks_to_width": ([("add", 16, _c(0xFFFF, 16), _c(1, 16))], "const"),
    "commutativity": ([("add", 32, _s("a"), _s("b")), ("add", 32, _s("b"), _s("a"))], "same"),
    "associativity": ([("add", 32, ("add", 32, _s("a"), _s("b")), _s("c")),
                       ("add", 32, _s("a"), ("add", 32, _s("b"), _s("c")))], "same"),
    "add_zero_identity": ([_s("x"), ("add", 32, _s("x"), _c(0))], "same"),
    "mul_zero_absorbs": ([("mul", 32, _s("x"), _c(0))], "const"),
    "sub_self_is_zero": ([("sub", 32, _s("x"), _s("x"))], "const"),
    "mul_pow2_is_shl": ([("mul", 32, _s("x"), _c(8)), ("shl", 32, _s("x"), _c(3))], "same"),
    "div_pow2_is_shr": ([("div.u", 32, _s("x"), _c(4)), ("shr.u", 32, _s("x"), _c(2))], "same"),
    "rem_pow2_is_and": ([("rem.u", 32, _s("x"), _c(32)), ("and", 32, _s("x"), _c(31))], "same"),
    "mad_fusion": ([("add", 32, ("mul", 32, _s("x"), _s("y")), _s("c")),
                    ("mad", 32, _s("x"), _s("y"), _s("c"))], "same"),
    "float_ops_stay_opaque": ([("op:add.f32", 32, _s("fa"), _s("fb")),
                               ("op:add.f32", 32, _s("fb"), _s("fa"))], "same"),
}


def _build(pkg, eg, expr):
    if expr[0] == "const":
        return _const(pkg, eg, expr[1], expr[2])
    if expr[0] == "sym":
        return _sym(pkg, eg, expr[1])
    op, width, *children = expr
    return eg.add(pkg.ENode(op, width, tuple(_build(pkg, eg, c) for c in children)))


def _rule_case(which, exprs, read):
    pkg, _, sat = PACKAGES[which]
    eg = pkg.EGraph()
    cids = [_build(pkg, eg, e) for e in exprs]
    counters = sat.saturate_block(eg, pkg.default_rules())
    got = [eg.const_of(c) for c in cids] if read == "const" else \
        len({eg.find(c) for c in cids}) == 1
    return got, counters, _state(eg, cids)


@pytest.mark.parametrize("case", sorted(RULE_CASES))
def test_rule_case_matches_reference(case):
    exprs, read = RULE_CASES[case]
    port, ref = _rule_case("port", exprs, read), _rule_case("reference", exprs, read)
    assert port == ref
    want = {"const_fold_add": [7], "const_fold_masks_to_width": [0],
            "mul_zero_absorbs": [0], "sub_self_is_zero": [0],
            "float_ops_stay_opaque": False}.get(case, True)
    assert port[0] == want


_FOLD_OPS = ["add", "sub", "mul", "and", "or", "xor", "shl", "shr.u",
             "shr.s", "min.u", "max.s"]


@pytest.mark.parametrize("seed", range(6))
def test_const_fold_matches_reference(seed):
    """The reference test's const-fold cases: the folded class's value and
    ``_fold`` itself agree between the packages."""
    out = {}
    for which, (pkg, rmod, sat) in PACKAGES.items():
        rng = random.Random(seed)
        width = rng.choice([16, 32, 64])
        op = rng.choice(_FOLD_OPS)
        a = rng.randrange(0, 1 << width)
        b = rng.randrange(0, width if op.startswith("sh") else 1 << width)
        eg = pkg.EGraph()
        cid = eg.add(pkg.ENode(op, width, (_const(pkg, eg, a, width), _const(pkg, eg, b, width))))
        sat.saturate_block(eg, pkg.default_rules())
        out[which] = (eg.const_of(cid), rmod._mask(rmod._fold(op, width, [a, b]), width))
    assert out["port"] == out["reference"]
    assert out["port"][0] == out["port"][1]


# ---------------------------------------------------------------------------
# the reference's const-cache fault, copied faithfully
# ---------------------------------------------------------------------------

def _fault_random_unions(which):
    """``tests/test_egraph.py::test_property_random_unions`` at its
    falsifying seed: a union of two classes that hold distinct constants."""
    eg, _ = _random_graph(which, random.Random(895240147), n_leaves=5, n_ops=30, n_unions=10)
    eg.rebuild()
    eg.check_invariants()


def _fault_saturation(which):
    """``test_property_saturation_terminates`` at its falsifying seed."""
    pkg, _, sat = PACKAGES[which]
    eg, _ = _random_graph(which, random.Random(8), n_leaves=4, n_ops=20, n_unions=5)
    counters = sat.saturate_block(eg, pkg.default_rules(), max_iters=6, max_nodes=2048)
    assert counters["iterations"] <= 6
    eg.check_invariants()


@pytest.mark.parametrize("fault", [_fault_random_unions, _fault_saturation],
                         ids=["random_unions", "saturation_terminates"])
def test_const_cache_fault_matches_reference(fault):
    """Both packages raise the same ``AssertionError`` at the reference's
    two falsifying seeds (ROADMAP Queue 3: a fault of the reference, left
    unfixed, so the port's e-graph stays byte-for-byte the reference's)."""
    errors = {}
    for which in PACKAGES:
        with pytest.raises(AssertionError) as exc:
            fault(which)
        errors[which] = str(exc.value)
    assert errors["port"] == errors["reference"]
    assert errors["port"].startswith("const cache disagrees with ENode(op='const'")
