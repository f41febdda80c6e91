"""The plain reference against the program's eager path on the CPU, at the
stand-in widths, float32; and the drawn parameter set against the
program's at the published widths."""

import pytest
import torch

from conftest import SMALL
from portbench import harness, weights
from portbench.reference import adamw as ref_adamw
from portbench.reference import model as ref

CONFIGS = {"mamba2-1.3b": SMALL}


def pair(name, seed=2**32 + 3, **extra):
    from repro_torch.models.lm import build_model

    config = harness.read_json(harness.HERE / "configs" / f"{name}.json")
    cfg = {**config["model"], **CONFIGS[name], **extra}
    port = harness.port_config(config, {**CONFIGS[name], **extra})
    params = weights.draw(cfg, config["assumed"]["init"], seed, "cpu")
    model = build_model(port, device="meta")
    weights.load(model, {k: v.clone() for k, v in params.items()})
    return cfg, params, model


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_drawn_parameters_are_the_programs_at_published_widths(name):
    from repro_torch.models.lm import build_model

    config = harness.read_json(harness.HERE / "configs" / f"{name}.json")
    model = build_model(harness.port_config(config, {}), device="meta")
    have = {n: (tuple(p.shape), p.dtype) for n, p in model.named_parameters()}
    want = {n: (s, weights.dtype_of(n, config["model"]))
            for n, s in weights.shapes(config["model"]).items()}
    assert have == want


def test_the_program_is_built_with_the_files_widths():
    config = harness.read_json(harness.HERE / "configs" / "mamba2-1.3b.json")
    port = harness.port_config(config, {})
    assert (port.vocab, port.padded_vocab) == (50277, 50288)
    assert all(getattr(port, k) == v for k, v in config["model"].items())


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_draws_repeat_and_follow_their_rules(name):
    config = harness.read_json(harness.HERE / "configs" / f"{name}.json")
    cfg = {**config["model"], **CONFIGS[name]}
    a = weights.draw(cfg, config["assumed"]["init"], 2**31 + 9, "cpu")
    b = weights.draw(cfg, config["assumed"]["init"], 2**31 + 9, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    A = -torch.exp(a["blocks.0.mamba.a_log"])
    assert bool(((A <= -1) & (A >= -16)).all())
    dt = torch.nn.functional.softplus(a["blocks.0.mamba.dt_bias"])
    assert bool(((dt >= 1e-4 * 0.999) & (dt <= 0.1 * 1.001)).all())
    assert bool((a["blocks.0.mamba.d_skip"] == 1).all())
    assert float(a["embed.table"].std()) == pytest.approx(0.02, rel=0.1)


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("length", [32, 48])
def test_prefill_logits_match_the_program(name, length):
    cfg, params, model = pair(name)
    tokens = torch.randint(0, cfg["vocab"], (2, length), generator=torch.Generator().manual_seed(1))
    got, _ = model.prefill({"tokens": tokens})
    want = ref.last_logits(ref.as_f32(params), cfg, tokens)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_train_step_matches_the_restated_adamw():
    from repro_torch.train.optim import OptConfig, init_opt_state
    from repro_torch.train.step import make_train_step

    cfg, params, model = pair("mamba2-1.3b", remat="block")
    opt = {"lr": 1e-2, "warmup_steps": 1}
    step = make_train_step(model, OptConfig(**opt))
    state = init_opt_state(dict(model.named_parameters()))
    p = {k: v.float().clone().requires_grad_(True) for k, v in params.items()}
    mine = ref_adamw.AdamW(p, ref.dtypes_of(params), {**ref_adamw.DEFAULTS, **opt})
    gen = torch.Generator().manual_seed(3)
    for _ in range(2):
        ids = torch.randint(0, cfg["vocab"], (2, 33), generator=gen)
        state, metrics = step(state, {"tokens": ids[:, :-1], "labels": ids[:, 1:]})
        loss = ref.loss(p, cfg, ids[:, :-1], ids[:, 1:], chunk=16)
        mine.step(p, dict(zip(p, torch.autograd.grad(loss, list(p.values())))))
        assert float(metrics["loss"]) == pytest.approx(float(loss.detach()), rel=1e-5)
    for k, v in model.named_parameters():     # Adam's step is g / |g|: 2 % of lr for tiny g
        torch.testing.assert_close(v.detach(), p[k].detach(), rtol=1e-4, atol=2e-4)
