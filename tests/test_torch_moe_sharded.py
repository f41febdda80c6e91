"""The port's sharded MoE dispatch (``models.moe.apply_moe_sharded``) on
gloo ranks against the JAX package's on as many host devices.

* The reference's own MoE tests (``tests/test_distributed.py``), ported:
  the sharded dispatch equals the dense one when nothing drops (S = 1
  too), a tiny capacity gives finite values, and ``2d_dshard`` equals the
  dense dispatch.
* Each schedule (``2d``, ``ep_tp``, ``2d_dshard``) at capacity factors
  E/k, 1.25 and 0.5 on a (4, 2) mesh against the reference's
  ``apply_moe_sharded`` on a (4, 2) mesh: y and aux, the slot of every
  (token, choice) pair and whether it is kept, and the gradients of
  sum(y^2) + aux with respect to the weights and x against ``jax.grad``.
* The one-device mesh: the port's reduced granite with
  ``moe_impl="sharded"`` on a (1, 1) mesh is the reference's on a
  one-device mesh, which drops tokens where the dense dispatch does not.
* The reduced granite on the (4, 2) mesh under each schedule (the
  prefill's logits, one decode step and the loss, with drops live at
  B 8, S 32), and one train step on (2, 2) under each schedule.

The reference runs in one subprocess with 8 forced host devices (as
``tests/test_distributed.py::_run`` does), so this process keeps one JAX
device; the port's ranks run through ``tests/_torch_ranks.py``, one
launch per mesh for all its cases.  All inputs are made here from numpy
seeds, the model weights from the reference's ``PRNGKey(0)`` init.
Tolerance 1e-5 of each leaf's largest value: both run float32, in other
summation orders.
"""

import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import build_model as jax_build_model
from repro.models import unbox
from repro_torch.configs import get_config, reduced
from repro_torch.interop import params_from_reference

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_distributed import ROOT, TIMEOUT, _batch, _near, _ranks  # noqa: E402

SCHEDULES = ("2d", "ep_tp", "2d_dshard")
E, K, D = 8, 2, 16
F = {"f": 32, "ds": 8}                 # 2d_dshard runs where F < D
CFS = (E / K, 1.25, 0.5)
ARCH = "granite-moe-1b-a400m"
ONE_DEVICE = {"b2s64": (2, 64, 1), "b2s16": (2, 16, 0)}   # (B, S, seed)

_JAX = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, "src")
import math
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.configs import get_config, reduced
from repro.models import build_model, unbox
from repro.models.moe import apply_moe_dense, apply_moe_sharded, router_probs

inp = dict(np.load(sys.argv[1]))
out = {}
E, k = int(inp["E"]), int(inp["k"])
devs = np.array(jax.devices())
mesh42 = Mesh(devs.reshape(4, 2), ("data", "model"))
mesh22 = Mesh(devs[:4].reshape(2, 2), ("data", "model"))
mesh11 = Mesh(devs[:1].reshape(1, 1), ("data", "model"))

@jax.jit
def shard_slots(router, xs):
    # one shard's slots by the reference's rule (moe.py:181-186)
    idx, _, _ = router_probs(router, xs.reshape(-1, xs.shape[-1]), k)
    oh = jax.nn.one_hot(idx.reshape(-1), E, dtype=jnp.int32)
    return jnp.sum(jnp.cumsum(oh, axis=0) * oh, axis=-1) - 1

def slots(router, x, sched, cf):
    # every (4, 2) shard's slots and keeps, rank 2 d + m
    B, S, _ = x.shape
    res = {}
    for d in range(4):
        for m in range(2):
            xs = x[2 * d:2 * d + 2]
            if sched != "2d_dshard" and S % 2 == 0:
                xs = xs[:, S // 2 * m:S // 2 * (m + 1)]
            slot = np.asarray(shard_slots(router, xs))
            cap = max(4, math.ceil(cf * k * xs.shape[0] * xs.shape[1] / E))
            res[2 * d + m] = (slot, slot < cap)
    return res

for sched in ("2d", "ep_tp", "2d_dshard"):
    tag = "ds" if sched == "2d_dshard" else "f"
    p = {n: jnp.asarray(inp[f"{tag}/{n}"]) for n in ("router", "w_gate", "w_up", "w_down")}
    x = jnp.asarray(inp["x"])
    dense = jax.jit(lambda p, x: apply_moe_dense(p, x, k, E)[0])
    out[f"{tag}/dense"] = np.asarray(dense(p, x))
    out[f"{tag}/dense1"] = np.asarray(dense(p, jnp.asarray(inp["x1"])))
    for cf in inp["cfs"]:
        def obj(p, x):
            y, aux = apply_moe_sharded(p, x, k, E, mesh42, capacity_factor=float(cf),
                                       schedule=sched)
            return jnp.sum(y ** 2) + aux, (y, aux)
        (_, (y, aux)), (gp, gx) = jax.jit(
            jax.value_and_grad(obj, argnums=(0, 1), has_aux=True))(p, x)
        key = f"{sched}/{cf:g}"
        out.update({f"{key}/y": np.asarray(y), f"{key}/aux": np.asarray(aux),
                    f"{key}/gx": np.asarray(gx),
                    **{f"{key}/g_{n}": np.asarray(g) for n, g in gp.items()}})
        for r, (slot, keep) in slots(p["router"], x, sched, float(cf)).items():
            out[f"{key}/slot{r}"], out[f"{key}/keep{r}"] = slot, keep

base = reduced(get_config("granite-moe-1b-a400m")).replace(moe_impl="sharded")
toks = jnp.asarray(inp["tokens"])
for sched in ("2d", "ep_tp", "2d_dshard"):
    model = build_model(base.replace(moe_schedule=sched), mesh42)
    params = unbox(model.init(jax.random.PRNGKey(0)))
    S = toks.shape[1]
    logits, cache = jax.jit(lambda p, b: model.prefill(p, b, max_len=S + 2))(params, {"tokens": toks})
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    logits2, _ = jax.jit(model.decode_step)(params, tok, cache)
    loss, met = jax.jit(model.loss)(params, {"tokens": toks, "labels": toks})
    out.update({f"{sched}/logits": np.stack([np.asarray(logits), np.asarray(logits2)], 1),
                f"{sched}/loss": np.asarray(loss), f"{sched}/aux_model": np.asarray(met["aux"])})
    model = build_model(base.replace(moe_schedule=sched), mesh22)
    batch = {"tokens": jnp.asarray(inp["t/tokens"]), "labels": jnp.asarray(inp["t/labels"])}
    (loss, _), grads = jax.jit(jax.value_and_grad(model.loss, has_aux=True))(params, batch)
    out[f"{sched}/train_loss"] = np.asarray(loss)
    flat = jax.tree_util.tree_flatten_with_path(grads)[0]
    out.update({f"{sched}/grad/" + "/".join(str(getattr(q, "key", q)) for q in path): np.asarray(g)
                for path, g in flat})

model = build_model(base, mesh11)
for key in inp["cases"]:
    batch = {"tokens": jnp.asarray(inp[f"{key}/tokens"])}
    batch["labels"] = batch["tokens"]
    logits, _ = jax.jit(model.prefill)(params, {"tokens": batch["tokens"]})
    loss, _ = jax.jit(model.loss)(params, batch)
    dense = build_model(base.replace(moe_impl="dense"))
    out[f"{key}/logits"], out[f"{key}/loss"] = np.asarray(logits), np.asarray(loss)
    out[f"{key}/dense_logits"] = np.asarray(jax.jit(dense.prefill)(params, {"tokens": batch["tokens"]})[0])
    out[f"{key}/dense_loss"] = np.asarray(jax.jit(dense.loss)(params, batch)[0])
np.savez(sys.argv[2], **out)
"""


def _moe_weights(rng, f: int) -> dict:
    """Router (D, E), w_gate / w_up (E, D, f), w_down (E, f, D), scaled as
    the reference's ``dense_init``."""
    return {"router": rng.standard_normal((D, E)) / np.sqrt(D),
            "w_gate": rng.standard_normal((E, D, f)) / np.sqrt(D),
            "w_up": rng.standard_normal((E, D, f)) / np.sqrt(D),
            "w_down": rng.standard_normal((E, f, D)) / np.sqrt(f)}


def _from_paths(flat: dict) -> dict:
    """A nested tree from ``a/b/c`` keys."""
    tree: dict = {}
    for key, v in flat.items():
        node = tree
        *head, leaf = key.split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[leaf] = v
    return tree


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The inputs, the reference's values and every rank's, computed once
    for the file: the JAX subprocess and the port's ranks run at once."""
    tmp = tmp_path_factory.mktemp("moe_sharded")
    rng = np.random.default_rng(0)
    inp = {"E": E, "k": K, "cfs": np.array(CFS),
           "x": rng.standard_normal((8, 4, D)), "x1": rng.standard_normal((8, 1, D))}
    for tag, f in F.items():
        inp.update({f"{tag}/{n}": v for n, v in _moe_weights(rng, f).items()})
    inp = {k: (v.astype(np.float32) if isinstance(v, np.ndarray) and v.dtype == np.float64
               and k != "cfs" else v) for k, v in inp.items()}
    jm = jax_build_model(jax_reduced(jax_get_config(ARCH)))
    params = jax.tree_util.tree_map(np.asarray, unbox(jm.init(jax.random.PRNGKey(0))))
    sd = params_from_reference(reduced(get_config(ARCH)), params)
    inp["tokens"] = np.random.default_rng(3).integers(0, 256, (8, 32)).astype(np.int32)
    train = _batch(256, 8, 32, seed=2)
    inp.update({f"t/{k}": v for k, v in train.items()})
    inp["cases"] = np.array(list(ONE_DEVICE))
    for key, (B, S, seed) in ONE_DEVICE.items():
        inp[f"{key}/tokens"] = np.random.default_rng(seed).integers(0, 256, (B, S)).astype(np.int32)
    np.savez(tmp / "jax_in.npz", **inp)
    jax_proc = subprocess.Popen([sys.executable, "-c", textwrap.dedent(_JAX),
                                 str(tmp / "jax_in.npz"), str(tmp / "jax_out.npz")],
                                cwd=ROOT, stderr=subprocess.PIPE, text=True,
                                start_new_session=True)
    try:
        state = {f"sd/{k}": v.numpy() for k, v in sd.items()}
        port = {"fn": _ranks("moe_fn", 8, tmp_path_factory.mktemp("fn"), **inp, **state),
                "train": _ranks("moe_train", 4, tmp_path_factory.mktemp("train"),
                                **train, **state),
                "one": _ranks("moe_one", 1, tmp_path_factory.mktemp("one"), **inp, **state)}
        _, err = jax_proc.communicate(timeout=TIMEOUT)
    finally:
        if jax_proc.poll() is None:
            os.killpg(jax_proc.pid, 9)
            jax_proc.communicate()
    assert jax_proc.returncode == 0, err[-4000:]
    ref = dict(np.load(tmp / "jax_out.npz"))
    return inp, ref, port, sd


# ---------------------------------------------------------------------------
# the reference's MoE tests, ported
# ---------------------------------------------------------------------------

def test_moe_sharded_matches_dense(runs):
    """``2d`` with capacity E/k (nothing drops) equals the dense dispatch
    within 1e-5 on every rank's rows, at S = 4 and at S = 1 (decode, where
    the sequence cannot split over the tensor axis)."""
    _, ref, port, _ = runs
    for out in port["fn"]:
        rows = slice(2 * int(out["data_rank"]), 2 * int(out["data_rank"]) + 2)
        assert np.abs(out[f"2d/{E / K:g}/y"] - ref["f/dense"][rows]).max() < 1e-5
        assert np.abs(out["2d/y1"] - ref["f/dense1"][rows]).max() < 1e-5
        assert out[f"2d/{E / K:g}/keep"].all()


def test_moe_capacity_drops_tokens_gracefully(runs):
    """Capacity factor 0.5: finite y and aux, some pairs dropped."""
    _, _, port, _ = runs
    dropped = 0
    for out in port["fn"]:
        for sched in SCHEDULES:
            assert np.isfinite(out[f"{sched}/0.5/y"]).all()
            assert np.isfinite(out[f"{sched}/0.5/aux"])
            dropped += int((~out[f"{sched}/0.5/keep"].astype(bool)).sum())
    assert dropped > 0


def test_moe_dshard_matches_dense(runs):
    """``2d_dshard`` (F < D) with capacity E/k equals the dense dispatch,
    at S = 4 and S = 1."""
    _, ref, port, _ = runs
    for out in port["fn"]:
        rows = slice(2 * int(out["data_rank"]), 2 * int(out["data_rank"]) + 2)
        assert np.abs(out[f"2d_dshard/{E / K:g}/y"] - ref["ds/dense"][rows]).max() < 1e-5
        assert np.abs(out["2d_dshard/y1"] - ref["ds/dense1"][rows]).max() < 1e-5


# ---------------------------------------------------------------------------
# each schedule against the reference's apply_moe_sharded
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cf", CFS, ids=lambda c: f"cf{c:g}")
@pytest.mark.parametrize("sched", SCHEDULES)
def test_schedule_matches_reference(runs, sched, cf):
    """On (4, 2): every rank's y within 1e-5 of the reference's rows, aux
    (summed over the batch shards) within 1e-5, each pair's slot and keep
    equal, and the gradients of sum(y^2) + aux (weights whole, x per rank)
    within 1e-5 of each leaf's largest ``jax.grad``."""
    _, ref, port, _ = runs
    key = f"{sched}/{cf:g}"
    for r, out in enumerate(port["fn"]):
        rows = slice(2 * int(out["data_rank"]), 2 * int(out["data_rank"]) + 2)
        _near(out[f"{key}/y"], ref[f"{key}/y"][rows])
        _near(out[f"{key}/aux"], ref[f"{key}/aux"])
        np.testing.assert_array_equal(out[f"{key}/slot"], ref[f"{key}/slot{r}"])
        np.testing.assert_array_equal(out[f"{key}/keep"].astype(bool), ref[f"{key}/keep{r}"])
        for n in ("router", "w_gate", "w_up", "w_down"):
            _near(out[f"{key}/g_{n}"], ref[f"{key}/g_{n}"])
        _near(out[f"{key}/gx"], ref[f"{key}/gx"][rows])


# ---------------------------------------------------------------------------
# the model on a mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", list(ONE_DEVICE))
def test_one_device_mesh_runs_the_sharded_dispatch(runs, case):
    """The reduced granite with ``moe_impl="sharded"`` on a (1, 1) mesh:
    the prefill's logits and the loss within 1e-5 of the reference's on a
    one-device mesh, which take the sharded dispatch and its drops (at
    B 2, S 64 the dense dispatch's logits differ from them)."""
    _, ref, port, _ = runs
    (out,) = port["one"]
    _near(out[f"{case}/logits"], ref[f"{case}/logits"])
    _near(out[f"{case}/loss"], ref[f"{case}/loss"])
    if case == "b2s64":
        assert np.abs(ref[f"{case}/logits"] - ref[f"{case}/dense_logits"]).max() > 1e-2


@pytest.mark.parametrize("sched", SCHEDULES)
def test_model_on_mesh_matches_reference(runs, sched):
    """The reduced granite (``moe_impl="sharded"``) on (4, 2) at B 8, S 32,
    where tokens drop: each rank's prefill logits and one decode step's
    within 1e-5 of the reference's rows, the same greedy tokens, and the
    loss and its aux within 1e-5."""
    _, ref, port, _ = runs
    for out in port["fn"]:
        rows = slice(2 * int(out["data_rank"]), 2 * int(out["data_rank"]) + 2)
        _near(out[f"{sched}/logits"], ref[f"{sched}/logits"][rows])
        np.testing.assert_array_equal(out[f"{sched}/tokens"],
                                      ref[f"{sched}/logits"][rows].argmax(-1))
        _near(out[f"{sched}/loss"], ref[f"{sched}/loss"])
        _near(out[f"{sched}/aux_model"], ref[f"{sched}/aux_model"])


@pytest.mark.parametrize("sched", SCHEDULES)
def test_train_step_on_mesh_matches_reference(runs, sched):
    """One train step of the reduced granite (``moe_impl="sharded"``) on
    (2, 2): the loss and every gradient AdamW receives within 1e-5 of each
    leaf's largest of the reference's ``jax.grad`` on a (2, 2) mesh."""
    _, ref, port, _ = runs
    tree = _from_paths({k.split("/grad/", 1)[1]: v for k, v in ref.items()
                        if k.startswith(f"{sched}/grad/")})
    want = params_from_reference(reduced(get_config(ARCH)), tree)
    for out in port["train"]:
        _near(out[f"{sched}/loss"], ref[f"{sched}/train_loss"])
        got = {k.split("/g/", 1)[1]: v for k, v in out.items() if k.startswith(f"{sched}/g/")}
        assert set(got) == set(want)
        for k, g in want.items():
            _near(got[k], g.numpy())
