"""The dry run (``launch.dryrun``) against the reference's cells, its
accounting and shardings, and against a real mesh.

* ``cell_applicable`` equals the reference's on all 10 x 4 cells.
* A full-width cell (granite-moe-1b-a400m x train_4k on the fake (16, 16)
  mesh) completes, with its parameter count equal to
  ``models.accounting.param_counts``'s and its per-rank argument bytes
  equal to the shards' own.
* Every parameter's rank-0 shard on the fake (16, 16) mesh has the shape
  the reference's ``NamedSharding`` gives it (``param_struct``, from
  ``jax.eval_shape`` alone, no compile), for all ten archs.
* On reduced cells, the fake (2, 2) run counts the same bytes, matmul
  FLOPs and collectives (by kind, count and bytes) per rank as a real
  gloo (2, 2) run of the same step under the same counters.

Each case runs in a subprocess with its own timeout: a fake process
group, and the reference's 512 host devices, stay out of this process.
"""

import json
import os
import signal
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import cell_applicable as jax_cell_applicable
from repro.configs import get_config as jax_get_config
from repro_torch.configs import ARCHS, SHAPES, cell_applicable, get_config

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_distributed import ROOT, TIMEOUT, _ranks  # noqa: E402

# reduced cells: a sharded MoE train step (all-to-all), ring attention
# in a prefill (send/recv), a Mamba-2 decode step
CELLS = [
    {"name": "granite_train", "arch": "granite-moe-1b-a400m",
     "cfg": {"moe_impl": "sharded", "moe_schedule": "2d"},
     "shape": {"name": "t", "kind": "train", "seq_len": 32, "global_batch": 4}},
    {"name": "starcoder_prefill", "arch": "starcoder2-3b", "cfg": {},
     "shape": {"name": "p", "kind": "prefill", "seq_len": 32, "global_batch": 4}},
    {"name": "mamba_decode", "arch": "mamba2-1.3b", "cfg": {},
     "shape": {"name": "d", "kind": "decode", "seq_len": 32, "global_batch": 4}},
]

_PORT_SHAPES = """
import json, sys
sys.path.insert(0, "src")
import torch
from repro_torch.configs import ARCHS, get_config
from repro_torch.interop import reference_tree
from repro_torch.launch.dryrun import fake_mesh, production_shape
from repro_torch.models import build_model
from repro_torch.sharding import place_params
from repro_torch.sharding.rules import rules_for

def flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flat(v, prefix + k + "/")
        else:
            yield prefix + k, list(v.shape)

mesh = fake_mesh(*production_shape())
out = {}
for arch in ARCHS:
    cfg = get_config(arch)
    model = place_params(build_model(cfg, device="meta", mesh=mesh), mesh, rules_for(cfg, mesh))
    local = {k: p.to_local() for k, p in model.named_parameters()}
    out[arch] = dict(flat(reference_tree(cfg, local)))
print(json.dumps(out))
"""

_REF_SHAPES = """
import json, sys
sys.path.insert(0, "src")
from repro.launch.dryrun import param_struct   # forces its 512 host devices
import jax
from repro.configs import ARCHS, get_config
from repro.launch.mesh import make_production_mesh
from repro.models import build_model
mesh = make_production_mesh()
out = {}
for arch in ARCHS:
    sds, _ = param_struct(build_model(get_config(arch), mesh), mesh)
    out[arch] = {"/".join(str(getattr(q, "key", q)) for q in path):
                 list(s.sharding.shard_shape(s.shape))
                 for path, s in jax.tree_util.tree_flatten_with_path(sds)[0]}
print(json.dumps(out))
"""

_FAKE_CELLS = """
import json, sys
sys.path.insert(0, "src")
import torch
from repro_torch.configs import ShapeSpec, get_config, reduced
from repro_torch.launch.dryrun import fake_mesh, lower_cell, measure
out = {}
mesh = fake_mesh((2, 2), ("data", "model"))
for cell in json.loads(sys.argv[1]):
    cfg = reduced(get_config(cell["arch"])).replace(**cell["cfg"])
    out[cell["name"]] = measure(cfg, ShapeSpec(**cell["shape"]), mesh, torch.device("meta"))
out["full"] = lower_cell("granite-moe-1b-a400m", "train_4k")
print(json.dumps(out))
"""


def _python(code: str, *args: str) -> dict:
    """Run ``code`` in a subprocess (killed after TIMEOUT); its last
    printed line, as JSON."""
    proc = subprocess.Popen([sys.executable, "-c", textwrap.dedent(code), *args],
                            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        pytest.fail(f"subprocess outlived {TIMEOUT} s")
    assert proc.returncode == 0, err[-4000:]
    return json.loads(out.strip().splitlines()[-1])


def test_cell_applicable_matches_reference():
    """All 10 x 4 (arch, shape) cells: the same verdict and reason."""
    assert sorted(SHAPES) == sorted(JAX_SHAPES)
    for arch in ARCHS:
        for name in SHAPES:
            assert (cell_applicable(get_config(arch), SHAPES[name])
                    == jax_cell_applicable(jax_get_config(arch), JAX_SHAPES[name]))
    assert [get_config(a).sub_quadratic for a in ARCHS] == \
        [jax_get_config(a).sub_quadratic for a in ARCHS]


def test_shard_shapes_match_reference():
    """Every parameter's rank-0 shard on the (16, 16) mesh, stacked into
    the reference's tree, has the shape of the reference's shard."""
    port, ref = _python(_PORT_SHAPES), _python(_REF_SHAPES)
    assert sorted(port) == sorted(ref) == sorted(ARCHS)
    for arch in ARCHS:
        assert port[arch] == ref[arch], arch


@pytest.fixture(scope="module")
def fake_and_real(tmp_path_factory):
    fake = _python(_FAKE_CELLS, json.dumps(CELLS))
    real = _ranks("dryrun_gloo", 4, tmp_path_factory.mktemp("dryrun"),
                  cells=np.array(json.dumps(CELLS)))
    return fake, [{k: json.loads(str(v)) for k, v in out.items()} for out in real]


def test_full_width_cell_counts_match_accounting(fake_and_real):
    """granite-moe-1b-a400m x train_4k on the fake (16, 16) mesh: every
    parameter counted once (``accounting.param_counts``), the argument
    bytes the sum of their parts, FLOPs and collectives recorded."""
    from repro_torch.models.accounting import param_counts
    full = fake_and_real[0]["full"]
    total = param_counts(get_config("granite-moe-1b-a400m"))["total"]
    assert full["n_params"] == full["accounting_params"] == total
    mem = full["memory"]
    assert mem["argument_bytes"] == sum(mem[k] for k in ("param_bytes", "opt_bytes",
                                                         "batch_bytes", "cache_bytes"))
    assert mem["opt_bytes"] == 2 * 4 * full["n_local_params"]      # two f32 moments
    assert full["n_local_params"] * 2 < mem["param_bytes"] < full["n_local_params"] * 4
    assert mem["temp_bytes"] is None
    assert full["matmul_flops"] > full["model_flops_per_device"] > 0
    assert full["collective_count"]["all-to-all"] + full["collective_count"]["all-gather"] > 0


@pytest.mark.parametrize("cell", [c["name"] for c in CELLS])
def test_fake_mesh_counts_what_a_real_mesh_runs(fake_and_real, cell):
    """The same bytes, matmul FLOPs, and collective counts and bytes by
    kind, on the fake (2, 2) mesh as on every rank of a real one."""
    fake, real = fake_and_real
    for out in real:
        assert out[cell] == fake[cell]
    assert sum(fake[cell]["collective_count"].values()) > 0
