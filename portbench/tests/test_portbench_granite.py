"""The ``granite-4.0-h-small.prefill-pool`` cell: whole runs on the CPU at a
small size (its own overrides), the configuration against the catalog,
the weight draw against the program's parameters, the work and the
bounds against hand counts, the reference's imports, the six readers on
a traced run, and the stand-ins."""

import json
import subprocess
import sys
import textwrap
import time

import pytest
import torch

from conftest import ROOT
from portbench import granite as gw
from portbench import harness, weights
from portbench.reference import granite as gref
from test_portbench_zamba2 import cpu_traced

CELL = "granite-4.0-h-small.prefill-pool"
#: a small Granite-4.0-H of the cell's kind: mamba, attention, mamba, each
#: with 12 experts (top 10, so that ``top8`` has experts to drop) and a
#: shared expert
SMALL = {"n_layers": 3, "layer_types": ["mamba", "attention", "mamba"], "d_model": 64,
         "vocab": 256, "dtype": "float32", "ssm_chunk": 16, "ssm_state": 16, "ssm_head_dim": 16,
         "n_heads": 4, "n_kv_heads": 2, "d_ff": 16, "shared_ff": 32, "n_experts": 12,
         "moe_top_k": 10}
OVERRIDES = {"model": SMALL, "traffic": {"batch": 2, "deck": [[16, 2], [32, 1]],
                                         "check_requests": 4}}
READERS = ("mfu.prefill_granite", "device_idle.prefill_granite", "moe_roofline.prefill_granite",
           "moe_share.prefill_granite", "ssd_roofline.prefill_granite",
           "flash_roofline.prefill_granite")
STAND_INS = ("fp8", "top8", "no_shared", "rope", "scale_dh")


def run_small(seed=2**31 + 5432, trace=False, **kw):
    kw.setdefault("min_units", 3)
    return harness.run(CELL, seed, 0.0, trace, t0=time.perf_counter(), device="cpu",
                       overrides=OVERRIDES, **kw)


def cell():
    return harness.find_cell(CELL)


def small_cfg():
    return {**cell().config["model"], **SMALL}


def test_result_line_and_check():
    line = run_small()
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert set(line["metrics"]) == {"ttft_ms_p95", "setup_s"}
    assert line["checks"]["served_gap_max"]["value"] < 1e-3      # float32 on both sides
    json.dumps(line)


def test_the_configuration_is_the_catalogs_cut_to_20_layers():
    """Every catalog number at the top level (the layer count and
    ``layer_types`` cut, as ``reduced`` says), and the program's widths in
    ``model`` agree with them."""
    conf = cell().config
    m = conf["model"]
    assert conf["reduced"] == ["num_hidden_layers", "layer_types"]
    bench = harness.read_json(ROOT / "BENCHMARK.json")
    assert next(c for c in bench["configs"] if c["name"] == "granite-4.0-h-small")["reduced"] == \
        conf["reduced"]
    assert conf["num_hidden_layers"] == m["n_layers"] == 20
    assert conf["layer_types"] == m["layer_types"]
    assert [i for i, k in enumerate(m["layer_types"]) if k == "attention"] == [5, 15]
    assert (conf["hidden_size"], conf["intermediate_size"], conf["shared_intermediate_size"]) == \
        (m["d_model"], m["d_ff"], m["shared_ff"])
    assert (conf["num_local_experts"], conf["num_experts_per_tok"]) == (m["n_experts"], m["moe_top_k"])
    assert (conf["num_attention_heads"], conf["num_key_value_heads"]) == (m["n_heads"], m["n_kv_heads"])
    assert (conf["mamba_n_heads"], conf["mamba_d_head"], conf["mamba_d_state"],
            conf["mamba_n_groups"], conf["mamba_chunk_size"], conf["mamba_d_conv"]) == \
        (m["ssm_expand"] * m["d_model"] // m["ssm_head_dim"], m["ssm_head_dim"], m["ssm_state"],
         m["ssm_groups"], m["ssm_chunk"], m["conv_width"])
    for key in ("embedding_multiplier", "residual_multiplier", "logits_scaling",
                "attention_multiplier"):
        assert conf[key] == m[key], key
    assert conf["rms_norm_eps"] == m["norm_eps"] and conf["vocab_size"] == m["vocab"]
    assert conf["position_embedding_type"] == "nope" and m["rope_theta"] == 0.0
    shapes = gw.shapes(m)
    assert sum(torch.Size(s).numel() for s in shapes.values()) == 16_309_191_936


@pytest.mark.parametrize("widths", ["small", "published"])
def test_the_draws_parameter_set_is_the_models(widths):
    """Names, shapes and dtypes of the draw equal the program's
    ``named_parameters`` (a build on ``meta``), at both sizes."""
    from repro_torch.models.lm import build_model

    m = small_cfg() if widths == "small" else cell().config["model"]
    over = SMALL if widths == "small" else {}
    model = build_model(harness.port_config(cell().config, over), device="meta")
    have = {n: (tuple(p.shape), p.dtype) for n, p in model.named_parameters()}
    want = {n: (s, gw.dtype_of(n, m)) for n, s in gw.shapes(m).items()}
    assert have == want
    assert want["ffn.0.moe.router"][1] == torch.float32


def test_the_weight_draw_is_the_same_twice_and_fits_the_program():
    from repro_torch.models.lm import build_model

    cfg = small_cfg()
    init = cell().config["assumed"]["init"]
    one, two = gw.draw(cfg, init, 2**31 + 9, "cpu"), gw.draw(cfg, init, 2**31 + 9, "cpu")
    assert list(one) == list(two) and all(torch.equal(one[k], two[k]) for k in one)
    assert weights.checksum(one) == weights.checksum(two)
    other = gw.draw(cfg, init, 2**31 + 10, "cpu")
    assert not torch.equal(one["ffn.0.moe.w_gate"], other["ffn.0.moe.w_gate"])
    a = one["blocks.0.mamba.a_log"].exp()                     # mamba_ssm's A = U(1, 16)
    assert a.min() >= 1 and a.max() <= 16 and a.std() > 1
    dt = torch.nn.functional.softplus(one["blocks.1.mamba.dt_bias"])
    assert dt.min() >= 1e-4 * 0.999 and dt.max() <= 0.1 * 1.001
    for leaf in ("conv_w", "conv_b"):                # nn.Conv1d's U(+-1/sqrt(width))
        t = one[f"blocks.1.mamba.{leaf}"]
        assert t.abs().max() <= 0.5 and t.std() > 0.2, leaf
    std = lambda k: float(one[k].std())  # noqa: E731
    assert 0.09 < std("attn.0.attn.wq") < 0.11 and 0.07 < std("attn.0.attn.wo") < 0.09
    assert 0.11 < std("ffn.2.moe.w_down") < 0.13 and 0.035 < std("ffn.2.shared.w_down") < 0.045
    assert 0.009 < std("ffn.1.moe.router") < 0.011
    assert 0.015 < std("attn.0.attn.wv") < 0.025 and 0.015 < std("ffn.0.moe.w_up") < 0.025
    model = build_model(harness.port_config(cell().config, SMALL), device="meta")
    weights.load(model, one)


def test_prefill_flops_is_a_hand_count():
    """At the published widths: per token 18 mixers of 2 x 102.24 M, 2
    attention layers of 2 x 41.94 M, 20 feed-forwards of 2 x 113.55 M
    (router, 10 experts, the shared one); the unembedding once a row; the
    SSD and the causal attention's products."""
    m = cell().config["model"]
    d, di, E, F, Fs = 4096, 8192, 72, 768, 1536
    mixer = d * (2 * di + 2 * 128 + 128) + di * d
    att = d * 128 * (2 * 32 + 2 * 8)
    ffn = d * E + 3 * d * (10 * F + Fs)
    assert (mixer, att, ffn) == (102_236_160, 41_943_040, 113_541_120)
    B, S = 8, 4096
    ssd = B * (S // 256) * (2.0 * 256 * 256 * 128 + 128 * (2.0 * 256 * 256 * 64 + 4.0 * 256 * 128 * 64))
    want = (2.0 * B * S * (18 * mixer + 2 * att + 20 * ffn) + 2.0 * B * d * 100352
            + 18 * ssd + 2 * 2.0 * B * 32 * 128 * S * (S + 1))
    assert gw.prefill_flops(m, B, S) == want
    assert 270e12 < want < 290e12                                    # about 282 TFLOP
    assert 20 * ffn / (18 * mixer + 2 * att + 20 * ffn) > 0.5        # the experts' share


def test_the_bounds_are_hand_counts():
    call = {"T": 32768, "D": 4096, "E": 72, "k": 10, "F": 768, "Fs": 1536, "dtype": "bfloat16"}
    flops = 2.0 * 3 * 4096 * 768 * 327680 + 2.0 * 3 * 4096 * 1536 * 32768 + 2.0 * 4096 * 72 * 32768
    nbytes = 2 * (72 * 3 * 4096 * 768 + 3 * 4096 * 1536 + 2 * 32768 * 4096) + 4 * 4096 * 72
    assert gw.moe_flops(call) == flops and gw.moe_bytes(call) == nbytes
    assert gw.moe_bound_s(call) == pytest.approx(flops / 989e12)
    few = {**call, "T": 3}                                           # 30 pairs: 30 experts
    assert gw.moe_bytes(few) == 2 * (30 * 3 * 4096 * 768 + 3 * 4096 * 1536 + 6 * 4096) + 4 * 4096 * 72
    f = {"B": 8, "S": 4096, "H": 32, "KV": 8, "Dh": 128, "dtype": "bfloat16"}
    assert gw.flash_bound_s(f) == pytest.approx(
        max(2 * 2 * 8 * 4096 * 128 * 40 / 3.35e12, 2.0 * 8 * 32 * 4096 * 4097 * 128 / 989e12))


def test_the_reference_loads_nothing_of_the_program():
    code = textwrap.dedent(f"""
        import sys
        sys.path[:0] = [{str(ROOT)!r}]
        import portbench.reference.granite
        print(sorted({{m.split(".")[0] for m in sys.modules}}
                     & {{"repro_torch", "repro", "jax", "transformers"}}))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"


def test_the_reference_reads_bf16_weights_a_layer_at_a_time():
    """The bf16 draw given as it is: the same logits as its float32 copy,
    every layer's parameters taken to float32 as the layer runs."""
    cfg = {**small_cfg(), "dtype": "bfloat16"}
    p = gw.draw(cfg, cell().config["assumed"]["init"], 2**31 + 11, "cpu")
    assert p["ffn.0.moe.w_gate"].dtype == torch.bfloat16
    tokens = torch.randint(0, cfg["vocab"], (2, 32), generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        got = gref.last_logits(p, cfg, tokens)
        want = gref.last_logits({k: v.float() for k, v in p.items()}, cfg, tokens)
    assert torch.equal(got, want)


def test_the_six_readers_read_a_traced_run(monkeypatch):
    monkeypatch.setattr(harness, "traced", cpu_traced)
    line = run_small(trace=True)
    got = {k: v["value"] for k, v in line["metrics"].items()}
    assert set(got) == set(READERS), got
    assert all(isinstance(v, float) and v > 0 for v in got.values()), got
    for share in ("moe_share.prefill_granite", "device_idle.prefill_granite"):
        assert got[share] < 100


def test_the_kind_sees_every_feed_forward_and_flash_call(monkeypatch):
    from portbench.kinds import prefill_granite as kind

    monkeypatch.setattr(harness, "traced", cpu_traced)
    seen = {}
    real = kind.Kind.traced_work

    def traced_work(self):
        seen.update(real(self))
        return seen

    monkeypatch.setattr(kind.Kind, "traced_work", traced_work)
    run_small(trace=True)
    units = len(seen["unit_keys"])
    assert len(seen["moe"]) == 3 * units and len(seen["flash"]) == units
    B = OVERRIDES["traffic"]["batch"]
    assert {m["T"] for m in seen["moe"]} == {B * L for L in seen["unit_keys"]}
    assert {(m["H"], m["KV"], m["Dh"]) for m in seen["flash"]} == {(4, 2, 16)}


def test_the_readers_read_nothing_of_another_kind():
    r = harness.Readings(kind="prefill", cfg={}, trace=None, calls=None, window={},
                         traced={"flash": [{}], "moe": [{}]})
    for name in READERS:
        assert harness.load_module(harness.HERE / "metrics" / f"{name}.py").read(r) is None


def _strong(init):
    """The cell's rules with every layer's normal draw at 0.25 and q, k at
    0.5 (the embedding's as it is): at this size the layers then move the
    logits as much as at the published widths, where the file's scales do
    it."""
    out = {k: (["normal", 0.25] if r[0] == "normal" and k != "table" else r)
           for k, r in init.items()}
    out["attn.wq"] = out["attn.wk"] = ["normal", 0.5]
    return out


@pytest.mark.parametrize("stand_in", STAND_INS)
def test_each_stand_in_moves_the_reference(stand_in):
    """Each stand-in computes another function than the reference: its
    logits lie far beyond float32 rounding from the reference's."""
    cfg = small_cfg()
    p = gw.draw(cfg, _strong(cell().config["assumed"]["init"]), 2**31 + 7, "cpu")
    tokens = torch.randint(0, cfg["vocab"], (16, 32), generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        best = gref.last_logits(p, cfg, tokens)
        low = gref.last_logits(p, cfg, tokens, stand_in)
    rel = float((low - best).norm() / (best - best.mean(-1, keepdim=True)).norm())
    assert rel > 1e-3, rel


def test_the_stand_ins_move_the_check(monkeypatch):
    """Through the kind's check at this size: every stand-in reads no less
    than the program (float32 on both sides), and those that change a
    greedy token here read above it.  The limit's upper readings come from
    the cell's own size on the card (``control.py``)."""
    real = harness.find_cell

    def strong_cell(name, *a, **kw):
        c = real(name, *a, **kw)
        c.config = {**c.config, "assumed": {**c.config["assumed"],
                                            "init": _strong(c.config["assumed"]["init"])}}
        return c

    monkeypatch.setattr(harness, "find_cell", strong_cell)
    over = {**OVERRIDES, "traffic": {**OVERRIDES["traffic"], "check_requests": 16}}
    line = harness.run(CELL, 2**31 + 7, 0.0, False, t0=time.perf_counter(), device="cpu",
                       overrides=over, min_units=8, controls=STAND_INS)
    program = line["checks"]["served_gap_max"]["value"]
    assert program < 1e-4
    got = {s: line["controls"][s]["served_gap_max"] for s in STAND_INS}
    assert all(v >= program for v in got.values()), got
    for s in ("fp8", "no_shared", "scale_dh"):
        assert got[s] > 10 * max(program, 1e-6), got


# ---------------------------------------------------------------------------
# on the card, at the cell's widths
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_decode_agrees_with_the_reference_at_the_cells_widths(card):
    """2 prompts of 512 tokens prefilled, then 16 greedy steps through the
    cache (the Mamba-2 layers' states, the attention layers' k/v); at
    every step the program's bf16 logits against the float32 reference's
    full forward pass over the same tokens: the served gap of each step's
    greedy token under the cell's limit."""
    from portbench.kinds import prefill_granite as kind
    from repro_torch.serve import step as sstep

    c = cell()
    ctx = harness.Run(cell=c, seed=2**31 + 909, seconds=0.0, device=card,
                      model_cfg=c.config["model"], traffic=c.traffic,
                      port_cfg=harness.port_config(c.config, {}))
    model = kind.build(ctx)
    prompt = ctx.ids(ctx.generator(harness.TOKEN_STREAM), 2, 512)
    steps, toks = [], []
    with torch.inference_mode():
        logits, cache = model.prefill({"tokens": prompt}, max_len=512 + 16)
        for _ in range(16):
            steps.append(logits.float().cpu())
            toks.append(logits.argmax(-1))
            logits, cache = model.decode_step(toks[-1], cache)
    served = sstep.generate(model, {"tokens": prompt}, 16).cuda()
    assert torch.equal(served, torch.stack(toks, dim=1).to(torch.int32))
    del model, cache, logits
    harness.free()
    params = kind.reference_params(ctx)
    gref.exact()
    full = torch.cat([prompt, torch.stack(toks[:-1], dim=1)], dim=1)
    with torch.no_grad():
        want = gref.logits(params, ctx.model_cfg, gref.hidden(params, ctx.model_cfg, full)[:, 511:])
    want, got, picked = want.cpu(), torch.stack(steps, dim=1), torch.stack(toks, 1).cpu()
    gap = want.max(-1).values - want.gather(-1, picked[..., None])[..., 0]
    rel = (got - want).norm(dim=-1) / (want - want.mean(-1, keepdim=True)).norm(dim=-1)
    print(f"\n[granite decode agreement] served gap max {float(gap.max()):.5f}, per step "
          f"{[round(float(x), 5) for x in gap.max(0).values]}; relative logit error max "
          f"{float(rel.max()):.4f}, median {float(rel.median()):.4f}")
    limit = harness.read_json(harness.HERE / "limits" / f"{CELL}.json")["served_gap_max"]["limit"]
    assert float(gap.max()) <= limit
