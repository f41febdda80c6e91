"""Serving on a mesh: ``prefill`` and ``decode_step`` of every family on
a (2, 2) gloo mesh against the single-process port on the reference's
weights.

One reduced arch per family: dense (olmo-1b), a ring-attention arch
(starcoder2-3b, whose prefill runs ``distributed.ring_attention`` over
``model``), SSM (mamba2-1.3b), hybrid (zamba2-1.2b), VLM
(llama-3.2-vision-90b, its gates at 0.5 since they are 0 at init),
enc-dec (seamless-m4t-large-v2) and MoE with ``moe_impl="dense"``
(granite-moe-1b-a400m; the sharded dispatch on a mesh is held in
``tests/test_torch_moe_sharded.py``).  Each rank serves its batch shard:
its rows of the prefill's logits and of one decode step's within 1e-5 of
the single-process port's, and the same three greedy tokens through
``serve.generate``.  The ranks run in one launch
(``tests/_torch_ranks.py``); the single-process values are computed here.
"""

import os
import sys

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
from repro_torch.models import build_model
from repro_torch.serve import generate

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_distributed import _near, _ranks  # noqa: E402

ARCHS = ["olmo-1b", "starcoder2-3b", "mamba2-1.3b", "zamba2-1.2b",
         "llama-3.2-vision-90b", "seamless-m4t-large-v2", "granite-moe-1b-a400m"]
B, S = 4, 32
GATE = 0.5


def _inputs(arch: str, cfg) -> dict:
    """The batch: tokens, and the seeded media or frames of the family."""
    rng = np.random.default_rng(ARCHS.index(arch))
    out = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int64)}
    if cfg.family == "vlm":
        out["media"] = rng.standard_normal((B, cfg.n_media_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        out["frames"] = rng.standard_normal((B, cfg.n_frames, cfg.d_model)).astype(np.float32)
    return out


def _single(cfg, sd, inp):
    """The single-process port: the prefill's logits and one decode
    step's, and three greedy tokens."""
    model = build_model(cfg, device="cpu")
    model.load_state_dict(sd)
    batch = {k: torch.from_numpy(v) for k, v in inp.items()}
    logits, cache = model.prefill(batch, max_len=S + 2)
    step, _ = model.decode_step(logits.argmax(-1), cache)
    return torch.stack([logits, step], 1).numpy(), generate(model, batch, 3).numpy()


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Every arch on the (2, 2) mesh in one launch, and single-process."""
    inputs, want = {}, {}
    for arch in ARCHS:
        cfg = reduced(get_config(arch))
        jm = jax_build_model(jax_reduced(jax_get_config(arch)))
        tree = jax.tree_util.tree_map(np.asarray, unbox(jm.init(jax.random.PRNGKey(0))))
        sd = params_from_reference(cfg, tree)
        if cfg.family == "vlm":
            sd = {k: (torch.full_like(v, GATE) if k.endswith(".gate") else v)
                  for k, v in sd.items()}
        inp = _inputs(arch, cfg)
        want[arch] = _single(cfg, sd, inp)
        inputs.update({f"{arch}/sd/{k}": v.numpy() for k, v in sd.items()})
        inputs.update({f"{arch}/in/{k}": v for k, v in inp.items()})
    outs = _ranks("mesh_serve", 4, tmp_path_factory.mktemp("mesh_serve"),
                  archs=np.array(ARCHS), **inputs)
    return want, outs


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_on_mesh_match_single_process(served, arch):
    """Each rank's rows: prefill and decode logits within 1e-5 of the
    single-process port's largest, and the same greedy tokens."""
    want, outs = served
    logits, tokens = want[arch]
    for out in outs:
        rows = slice(2 * int(out["data_rank"]), 2 * int(out["data_rank"]) + 2)
        _near(out[f"{arch}/logits"], logits[rows])
        np.testing.assert_array_equal(out[f"{arch}/tokens"], tokens[rows])
