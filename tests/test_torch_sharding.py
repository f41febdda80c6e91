"""The port's sharding rules and meshes against the JAX package, in this
process and without ranks: ``resolve_spec`` (with its report strings) for
every parameter of the ten configs, reduced and at full width, on five
mesh shapes; the logical-axes table; ``choose_schedule`` and
``rules_for``; the batch specs; ``placements``; and what the mesh
functions ask ``torch.distributed`` for.  The reference's functions read
``mesh.shape`` only, so its side runs on a JAX ``AbstractMesh`` and the
port's on a ``{name: size}`` mapping; they are compared exactly.
"""

import subprocess
import sys

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

from jax.sharding import AbstractMesh
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import build_model as jax_build_model
from repro.models import moe as jax_moe
from repro.models.common import LogicalArray
from repro.sharding import rules as jax_rules
from repro_torch.configs import ARCHS, get_config, reduced
from repro_torch.interop import logical_axes, reference_tree
from repro_torch.launch import mesh as tmesh
from repro_torch.models import build_model
from repro_torch.models.moe import choose_schedule
from repro_torch.sharding import (
    PartitionSpec,
    batch_sharding,
    batch_spec,
    placements,
    resolve_spec,
    rules_for,
    shard_batch_spec,
)
from torch.distributed.tensor import Replicate, Shard

MESHES = [((1, 1), ("data", "model")), ((2, 2), ("data", "model")),
          ((4, 2), ("data", "model")), ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
MESH_IDS = ["x".join(map(str, s)) for s, _ in MESHES]


def _meshes(shape, axes):
    """(the reference's AbstractMesh, the port's {name: size})."""
    return AbstractMesh(shape, axes), dict(zip(axes, shape))


@pytest.fixture(scope="module")
def leaves():
    """Per (arch, width): [(reference LogicalArray, [port parameter names it
    holds])], and the port's logical axes and shapes by name.  The port's
    model is built on the ``meta`` device; ``reference_tree`` of the
    parameters' indices says which port parameters each reference leaf
    stacks."""
    cache = {}

    def get(arch, width):
        if (arch, width) not in cache:
            jcfg, cfg = jax_get_config(arch), get_config(arch)
            if width == "reduced":
                jcfg, cfg = jax_reduced(jcfg), reduced(cfg)
            jm = jax_build_model(jcfg)
            boxed = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
            ref = jax.tree_util.tree_leaves(boxed, is_leaf=lambda x: isinstance(x, LogicalArray))
            model = build_model(cfg, device="meta")
            names = [n for n, _ in model.named_parameters()]
            idx = reference_tree(cfg, {n: torch.tensor(i) for i, n in enumerate(names)})
            held = [[names[int(i)] for i in t.reshape(-1)] for t in jax.tree_util.tree_leaves(idx)]
            assert len(ref) == len(held)
            shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
            cache[arch, width] = list(zip(ref, held)), logical_axes(cfg, model), shapes
        return cache[arch, width]

    return get


@pytest.mark.parametrize("width", ["reduced", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_logical_axes_match_reference(arch, width, leaves):
    """Every port parameter's logical axes are its reference leaf's less the
    stacked ``layers`` axes, and its shape the leaf's less those axes."""
    pairs, axes, shapes = leaves(arch, width)
    assert sorted(n for _, held in pairs for n in held) == sorted(axes)
    for la, held in pairs:
        for name in held:
            lead = la.value.ndim - len(shapes[name])
            assert la.axes[:lead] == ("layers",) * lead, (name, la.axes)
            assert axes[name] == la.axes[lead:], name
            assert shapes[name] == tuple(la.value.shape[lead:]), name


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("width", ["reduced", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_resolve_spec_matches_reference(arch, width, mesh, leaves):
    """Each parameter's spec is its reference leaf's with the layer axes'
    leading Nones taken off, and the divisibility report is the leaf's,
    string for string."""
    jmesh, tmesh_ = _meshes(*mesh)
    pairs, axes, shapes = leaves(arch, width)
    for la, held in pairs:
        rep_ref = []
        ref = jax_rules.resolve_spec(tuple(la.value.shape), la.axes, jmesh, report=rep_ref)
        lead = la.value.ndim - len(shapes[held[0]])
        for name in held:
            rep = []
            spec = resolve_spec(shapes[name], axes[name], tmesh_, report=rep)
            assert isinstance(spec, PartitionSpec)
            want = tuple(ref)[lead:] if len(tuple(ref)) > lead else ()
            assert tuple(spec) == want, (name, spec, ref)
            assert rep == rep_ref, name


def test_resolve_spec_divisibility_fallback():
    """``tests/test_substrate.py``'s: (1, 1) divides everything; 4 kv heads
    do not shard over a 16-wide model axis, and the report says so."""
    spec = resolve_spec((64, 32), ("vocab", "embed"), {"data": 1, "model": 1})
    assert spec == PartitionSpec("model", "data")
    mesh16 = {"data": 1, "model": 16}
    spec = resolve_spec((64, 4, 8), ("embed", "kv_heads", "head_dim"), mesh16)
    assert len(spec) < 2 or spec[1] is None      # kv replicated
    rep = []
    resolve_spec((64, 4, 8), ("embed", "kv_heads", "head_dim"), mesh16, report=rep)
    assert any("kv_heads" in r for r in rep)


def test_resolve_spec_no_duplicate_axis():
    """``tests/test_substrate.py``'s: two dims mapped to 'model', the
    second falls back."""
    spec = resolve_spec((8, 8), ("vocab", "ff"), {"data": 2, "model": 2})
    assert spec == PartitionSpec("model")


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_schedule_and_rules_match_reference(mesh):
    """``choose_schedule`` and ``rules_for`` of Granite and Kimi (full and
    reduced, every schedule setting) equal the reference's; so do the
    reference test's two cases of ``choose_schedule``."""
    jmesh, tmesh_ = _meshes(*mesh)
    for arch in ("granite-moe-1b-a400m", "kimi-k2-1t-a32b"):
        for jcfg, cfg in ((jax_get_config(arch), get_config(arch)),
                          (jax_reduced(jax_get_config(arch)), reduced(get_config(arch)))):
            args = (cfg.n_experts, cfg.d_model, cfg.d_ff)
            assert choose_schedule(*args, tmesh_) == jax_moe.choose_schedule(*args, jmesh)
            for sched in ("2d", "ep_tp", "auto"):
                assert (rules_for(cfg.replace(moe_schedule=sched), tmesh_)
                        == jax_rules.rules_for(jcfg.replace(moe_schedule=sched), jmesh))
    big = {"data": 16, "model": 16}
    assert choose_schedule(384, 7168, 2048, big) == "2d_dshard"
    assert choose_schedule(32, 1024, 512, big) == "ep_tp"


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_batch_specs_match_reference(mesh):
    """``shard_batch_spec`` (dividing and not) and the token batches' spec
    and placements (the reference's ``batch_sharding``) equal the
    reference's."""
    jmesh, tmesh_ = _meshes(*mesh)
    spec = jax_rules.batch_sharding(jmesh).spec
    assert tuple(batch_spec(tmesh_)) == tuple(spec)
    assert batch_sharding(tmesh_) == placements(PartitionSpec(*spec), tmesh_)
    for shape in ((8, 32), (64, 128, 16), (3, 5), (1, 7)):
        for dim in range(len(shape) - 1):
            assert (tuple(shard_batch_spec(tmesh_, shape, dim))
                    == tuple(jax_rules.shard_batch_spec(jmesh, shape, dim)))


def test_placements():
    """A spec's placements: Shard(d) on each mesh dimension that splits d,
    Replicate elsewhere; a dimension over (pod, data) takes both in mesh
    order, and the other order is refused."""
    mesh = {"pod": 2, "data": 2, "model": 4}
    assert placements(PartitionSpec("model", "data"), mesh) == [Replicate(), Shard(1), Shard(0)]
    assert placements(PartitionSpec(("pod", "data"), None), mesh) == [Shard(0), Shard(0),
                                                                      Replicate()]
    assert placements(PartitionSpec(), mesh) == [Replicate()] * 3
    with pytest.raises(NotImplementedError):
        placements(PartitionSpec(("data", "pod")), mesh)


def test_production_mesh_request(monkeypatch):
    """``make_production_mesh`` asks for the reference's (16, 16) and
    (2, 16, 16) meshes over 256 and 512 ranks; ``make_mesh`` refuses a
    process group of another size and a missing one."""
    asked = []
    monkeypatch.setattr(tmesh, "init_device_mesh",
                        lambda dev, shape, mesh_dim_names: asked.append(
                            (dev, shape, mesh_dim_names)))
    monkeypatch.setattr(tmesh.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(tmesh.dist, "get_backend", lambda: "nccl")
    monkeypatch.setattr(tmesh.dist, "get_world_size", lambda: 256)
    tmesh.make_production_mesh()
    with pytest.raises(RuntimeError, match="512 ranks"):
        tmesh.make_production_mesh(multi_pod=True)
    monkeypatch.setattr(tmesh.dist, "get_world_size", lambda: 512)
    tmesh.make_production_mesh(multi_pod=True)
    assert asked == [("cuda", (16, 16), ("data", "model")),
                     ("cuda", (2, 16, 16), ("pod", "data", "model"))]
    with pytest.raises(RuntimeError, match="gloo"):
        tmesh.make_mesh((512,), ("data",), "cpu")
    monkeypatch.setattr(tmesh.dist, "is_initialized", lambda: False)
    with pytest.raises(RuntimeError, match="none is initialized"):
        tmesh.make_mesh((2, 2), ("data", "model"), "cpu")


def test_host_mesh_standalone():
    """``make_host_mesh`` without a process group starts a one-rank gloo
    group of its own and gives the (1, 1) CPU mesh (a fresh process, so
    this one starts no group)."""
    code = ("import sys; sys.path.insert(0, 'src'); "
            "from repro_torch.launch.mesh import make_host_mesh; m = make_host_mesh(); "
            "print(m.device_type, tuple(m.shape), m.mesh_dim_names)")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=__file__.rsplit("/tests", 1)[0])
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.split("\n")[0] == "cpu (1, 1) ('data', 'model')"
