"""The ``zamba2-7b.prefill-pool`` cell: whole runs on the CPU at a small
size (its own overrides; ``conftest.py``'s cover the Mamba-2 cells), the
reference's imports and numerics, the weight draw, the six readers on a
traced run, the stand-ins; on the card, the decode agreement at the
published widths."""

import json
import subprocess
import sys
import textwrap
import time
from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType

from conftest import ROOT
from portbench import harness, weights
from portbench import zamba2 as zw
from portbench.reference import zamba2 as zref
from portbench.trace import PREFIX

CELL = "zamba2-7b.prefill-pool"
#: a small Zamba2 of the cell's kind: 6 layers, 1, 2, 4 and 5 hybrid (two
#: applications of each shared block), heads 2 d_model / H wide, two groups
SMALL = {"n_layers": 6, "d_model": 64, "vocab": 256, "dtype": "float32", "ssm_chunk": 16,
         "ssm_state": 16, "ssm_head_dim": 16, "n_heads": 4, "n_kv_heads": 4,
         "attn_width": 128, "d_ff": 128, "adapter_rank": 8, "hybrid_layer_ids": [1, 2, 4, 5]}
OVERRIDES = {"model": SMALL, "traffic": {"batch": 2, "deck": [[16, 2], [32, 1]],
                                         "check_requests": 4}}
READERS = ("flash_roofline.prefill_zamba2", "ssd_roofline.prefill_zamba2",
        "shared_share.prefill_zamba2", "mfu.prefill_zamba2", "device_idle.prefill_zamba2",
        "conv1d_roofline.prefill_zamba2")


def run_small(seed=2**31 + 4321, trace=False, **kw):
    kw.setdefault("min_units", 3)
    return harness.run(CELL, seed, 0.0, trace, t0=time.perf_counter(), device="cpu",
                       overrides=OVERRIDES, **kw)


def small_cfg():
    return {**harness.find_cell(CELL).config["model"], **SMALL}


def test_result_line_and_check():
    line = run_small()
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert set(line["metrics"]) == {"ttft_ms_p95", "setup_s"}
    assert line["checks"]["served_gap_max"]["value"] < 1e-3      # float32 on both sides
    json.dumps(line)


def test_the_configuration_is_the_catalogs():
    """Every catalog number at the top level, and the program's widths in
    ``model`` agree with them."""
    conf = harness.read_json(ROOT / "portbench" / "configs" / "zamba2-7b.json")
    m = conf["model"]
    assert conf["reduced"] == [] and conf["num_hidden_layers"] == m["n_layers"] == 81
    assert conf["hidden_size"] == m["d_model"] and conf["attention_hidden_size"] == m["attn_width"]
    assert conf["attention_head_dim"] == m["attn_width"] // m["n_heads"] == 224
    assert conf["hybrid_layer_ids"] == m["hybrid_layer_ids"]
    assert [i for i, k in enumerate(conf["layers_block_type"]) if k == "hybrid"] == \
        m["hybrid_layer_ids"]
    assert (conf["mamba_ngroups"], conf["mamba_d_state"], conf["n_mamba_heads"]) == \
        (m["ssm_groups"], m["ssm_state"], 2 * m["d_model"] // m["ssm_head_dim"])
    assert (conf["adapter_rank"], conf["num_mem_blocks"], conf["intermediate_size"]) == \
        (m["adapter_rank"], m["n_shared_blocks"], m["d_ff"])
    assert conf["rms_norm_eps"] == m["norm_eps"] and conf["vocab_size"] == m["vocab"]
    shapes = zw.shapes(m)
    assert sum(torch.Size(s).numel() for s in shapes.values()) == 7_356_749_648


def test_the_weight_draw_is_the_same_twice_and_fits_the_program():
    from repro_torch.models.lm import build_model

    cfg = small_cfg()
    init = harness.find_cell(CELL).config["assumed"]["init"]
    one, two = zw.draw(cfg, init, 2**31 + 9, "cpu"), zw.draw(cfg, init, 2**31 + 9, "cpu")
    assert list(one) == list(two) and all(torch.equal(one[k], two[k]) for k in one)
    assert weights.checksum(one) == weights.checksum(two)
    other = zw.draw(cfg, init, 2**31 + 10, "cpu")
    assert not torch.equal(one["blocks.0.mamba.w_in"], other["blocks.0.mamba.w_in"])
    assert not one["embed.table"][0].any() and one["embed.table"][1].any()
    H = 2 * cfg["d_model"] // cfg["ssm_head_dim"]
    assert torch.equal(one["blocks.0.mamba.a_log"], torch.log(torch.arange(1.0, H + 1)))
    for leaf in ("conv_w", "conv_b"):                # nn.Conv1d's U(+-1/sqrt(width))
        t = one[f"blocks.3.mamba.{leaf}"]
        assert t.abs().max() <= 0.5 and t.std() > 0.2, leaf
    model = build_model(harness.port_config(harness.find_cell(CELL).config, SMALL), device="meta")
    weights.load(model, one)


def test_the_reference_loads_nothing_of_the_program():
    code = textwrap.dedent(f"""
        import sys
        sys.path[:0] = [{str(ROOT)!r}]
        import portbench.reference.zamba2
        print(sorted({{m.split(".")[0] for m in sys.modules}}
                     & {{"repro_torch", "repro", "jax", "transformers"}}))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"


def test_tf32_is_off_after_the_check(monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    run_small()
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_blocked_attention_equals_whole(monkeypatch):
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(2, 40, 3, 8, generator=g) for _ in range(3))
    whole = zref.attention(q, k, v, 0.3, "f32")
    monkeypatch.setattr(zref, "Q_BLOCK", 7)
    torch.testing.assert_close(zref.attention(q, k, v, 0.3, "f32"), whole,
                               rtol=1e-6, atol=1e-6)


def test_a_token_altered_where_it_is_produced_reads_far_above_the_program(monkeypatch):
    from repro_torch.serve import step

    program = run_small()["checks"]["served_gap_max"]["value"]
    real = step.generate

    def generate(model, batch, n_tokens, *args, **kwargs):
        out = real(model, batch, n_tokens, *args, **kwargs)
        out[0, -1] = (out[0, -1] + model.cfg.vocab // 2) % model.cfg.vocab
        return out

    monkeypatch.setattr(step, "generate", generate)
    altered = run_small()["checks"]["served_gap_max"]["value"]
    # the limit is set at the published widths, where the logits spread
    # about 1.2; at this size they spread about 0.16, so the reading is held
    # against the program's own and not against the limit
    assert altered > 1e-2 and altered > 1000 * program


def test_the_stand_ins_read_no_less_than_the_program():
    """At this size a stand-in may keep every greedy token (a gap of 0);
    the limit's upper readings come from the cell's own size on the card
    (``control.py``)."""
    line = run_small(controls=("fp8", "scale_dh", "no_adapter", "one_group"))
    program = line["checks"]["served_gap_max"]["value"]
    for stand_in in ("fp8", "scale_dh", "no_adapter", "one_group"):
        assert line["controls"][stand_in]["served_gap_max"] >= program, stand_in


def test_one_group_moves_the_mixers_where_rounding_does_not():
    """One mixer at the published widths with the cell's initialisation,
    over 512 normalised tokens: every head reading group 0 moves its output
    by far more than bf16 operands do, so the grouped SSD is a term the
    check can see."""
    cfg = {**harness.find_cell(CELL).config["model"], "n_layers": 1, "hybrid_layer_ids": [],
           "n_shared_blocks": 0, "vocab": 16}
    params = zref.as_f32(zw.draw(cfg, harness.find_cell(CELL).config["assumed"]["init"],
                                 2**31 + 77, "cpu"))
    x = torch.randn(1, 512, cfg["d_model"], generator=torch.Generator().manual_seed(77))
    x = zref.rmsnorm(x, 1.0, cfg["norm_eps"])
    with torch.no_grad():
        out = {p: zref.mixer(params, "blocks.0.mamba.", x, cfg, p)
               for p in ("f32", "one_group", "bf16")}
    rel = {p: float((out[p] - out["f32"]).norm() / out["f32"].norm())
           for p in ("one_group", "bf16")}
    assert 0 < rel["bf16"] < 0.02 and rel["one_group"] > 5 * rel["bf16"], rel


def test_one_group_is_the_reference_when_the_groups_are_equal():
    """The stand-in changes which group a head reads and nothing else: with
    both groups' B and C columns of the in-projection equal, it is the
    reference."""
    cfg = small_cfg()
    init = harness.find_cell(CELL).config["assumed"]["init"]
    params = zref.as_f32(zw.draw(cfg, init, 2**31 + 78, "cpu"))
    d, N, G = cfg["d_model"], cfg["ssm_state"], cfg["ssm_groups"]
    di = cfg["ssm_expand"] * d
    for i in range(cfg["n_layers"]):
        pre = f"blocks.{i}.mamba."
        for lo in (2 * di, 2 * di + G * N):          # B's, then C's columns in w_in
            params[pre + "w_in"][:, lo + N:lo + G * N] = params[pre + "w_in"][:, lo:lo + N].repeat(1, G - 1)
            cv = lo - di                              # the same columns in conv1d's x|B|C
            for k in ("conv_w", "conv_b"):
                t = params[pre + k]
                t[..., cv + N:cv + G * N] = t[..., cv:cv + N].repeat(*([1] * (t.ndim - 1)), G - 1)
    tokens = torch.randint(0, cfg["vocab"], (2, 40), generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        want = zref.hidden(params, cfg, tokens)
        got = zref.hidden(params, cfg, tokens, "one_group")
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def _ev(name, a, b, device=True, annotation=False):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=a, end=b),
                           device_type=DeviceType.CUDA if device else DeviceType.CPU,
                           is_user_annotation=annotation)


def cpu_traced(fn, what, attempts=3):
    """A stand-in for ``trace.traced`` on the CPU: the profiler's host
    events, with each ``portbench::`` range also as a device range and each
    innermost ``aten::`` operation also as a device operation, each taking a
    thousandth of its host time, so that the device reads as mostly idle."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    out = []
    for e in prof.events():
        a, b = e.time_range.start * 1e-3, e.time_range.end * 1e-3
        if e.name.startswith(PREFIX):
            out.append(_ev(e.name, a, b, annotation=True))
        elif e.name.startswith("aten::") and not e.cpu_children:
            out.append(_ev(e.name, a, b))
        out.append(_ev(e.name, a, b, device=False))
    return out


def test_the_five_readers_read_a_traced_run(monkeypatch):
    monkeypatch.setattr(harness, "traced", cpu_traced)
    line = run_small(trace=True)
    got = {k: v["value"] for k, v in line["metrics"].items()}
    assert set(got) == set(READERS), got
    assert all(isinstance(v, float) and v > 0 for v in got.values()), got
    for share in ("shared_share.prefill_zamba2", "device_idle.prefill_zamba2"):
        assert got[share] < 100


def test_the_readers_read_nothing_of_another_kind():
    r = harness.Readings(kind="prefill", cfg={}, trace=None, calls=None, window={},
                         traced={"flash": [{}]})
    for name in READERS:
        assert harness.load_module(harness.HERE / "metrics" / f"{name}.py").read(r) is None


# ---------------------------------------------------------------------------
# on the card, at the published widths
# ---------------------------------------------------------------------------

def _published(dtype="bfloat16", seed=2**31 + 808):
    """The cell's run context at the published widths, in ``dtype``."""
    cell = harness.find_cell(CELL)
    model_cfg = {**cell.config["model"], "dtype": dtype}
    return harness.Run(cell=cell, seed=seed, seconds=0.0, device=torch.device("cuda"),
                       model_cfg=model_cfg, traffic=cell.traffic,
                       port_cfg=harness.port_config(cell.config, {"dtype": dtype}))


def _agreement(got, want, tokens):
    """Per row and position: the served gap of ``tokens`` (the check's
    measure) and the logits' error relative to their spread."""
    gap = want.max(-1).values - want.gather(-1, tokens[..., None])[..., 0]
    rel = (got - want).norm(dim=-1) / (want - want.mean(-1, keepdim=True)).norm(dim=-1)
    return gap, rel


@pytest.mark.cuda
def test_decode_agrees_with_the_reference_at_published_widths(card):
    """4 prompts of 512 tokens prefilled, then 32 greedy steps through the
    caches; at every step the program's bf16 logits against the float32
    reference's full forward pass over the same tokens: the served gap of
    each step's greedy token under the cell's limit, and the logits' error
    relative to their spread."""
    from repro_torch.serve import step as sstep
    from portbench.kinds import prefill_zamba2 as kind

    ctx = _published()
    model = kind.build(ctx)
    prompt = ctx.ids(ctx.generator(harness.TOKEN_STREAM), 4, 512)
    steps, toks = [], []
    with torch.inference_mode():
        logits, cache = model.prefill({"tokens": prompt}, max_len=512 + 32)
        for _ in range(32):
            steps.append(logits.float().cpu())
            toks.append(logits.argmax(-1))
            logits, cache = model.decode_step(toks[-1], cache)
    served = sstep.generate(model, {"tokens": prompt}, 32).cuda()
    assert torch.equal(served, torch.stack(toks, dim=1).to(torch.int32))
    del model, cache, logits
    harness.free()
    params = zref.as_f32(zw.draw(ctx.model_cfg, ctx.cell.config["assumed"]["init"], ctx.seed,
                                 ctx.device))
    zref.exact()
    full = torch.cat([prompt, torch.stack(toks[:-1], dim=1)], dim=1)
    with torch.no_grad():
        want = zref.logits(params, ctx.model_cfg, zref.hidden(params, ctx.model_cfg, full)[:, 511:])
    gap, rel = _agreement(torch.stack(steps, dim=1), want.cpu(), torch.stack(toks, 1).cpu())
    print(f"\n[decode agreement] served gap max {float(gap.max()):.4f}, per step "
          f"{[round(float(x), 3) for x in gap.max(0).values]}; relative logit error "
          f"max {float(rel.max()):.4f}, median {float(rel.median()):.4f}, prefill "
          f"{[round(float(x), 4) for x in rel[:, 0]]}")
    limit = harness.read_json(harness.HERE / "limits" / f"{CELL}.json")["served_gap_max"]["limit"]
    assert float(gap.max()) <= limit
    # bf16 rounding, amplified through 81 layers at this initialisation,
    # leaves 15-18 % of the logits' spread (the float32 program: 7e-5)
    assert float(rel.max()) < 0.3


@pytest.mark.cuda
def test_float32_program_agrees_at_published_widths(card):
    """The same path with every parameter and activation in float32 (the
    kernels' float32 instances): the program and the reference then differ
    by the order of their sums alone, so what the bf16 program's gap holds
    beyond this is bf16 rounding and not a fault of the path."""
    from portbench.kinds import prefill_zamba2 as kind

    ctx = _published("float32", seed=2**31 + 809)
    model = kind.build(ctx)
    prompt = ctx.ids(ctx.generator(harness.TOKEN_STREAM), 2, 512)
    with torch.inference_mode():
        got, _ = model.prefill({"tokens": prompt})
    got = got.float().cpu()
    del model
    harness.free()
    params = zw.draw(ctx.model_cfg, ctx.cell.config["assumed"]["init"], ctx.seed, ctx.device)
    zref.exact()
    with torch.no_grad():
        want = zref.last_logits(params, ctx.model_cfg, prompt).cpu()
    gap, rel = _agreement(got, want, got.argmax(-1))
    print(f"\n[float32 agreement] served gap max {float(gap.max()):.6f}, relative logit "
          f"error max {float(rel.max()):.6f}")
    assert float(gap.max()) < 1e-2 and float(rel.max()) < 1e-3
