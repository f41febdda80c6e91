"""The granite_hybrid family (IBM's Granite-4.0-H: Mamba-2 and NoPE GQA
layers, each followed by routed experts and a shared expert) on the CPU:
the port's plain path against the plain reference
``portbench/reference/granite.py``, the reference against the published
``GraniteMoeHybridForCausalLM`` where ``transformers`` is installed, the
cache through prefill and decode, the dropless MoE dispatch against the
dense one, and the Mamba-2 block's residual factor.

The model is the registered ``granite-4.0-h-small`` cut to a small size
(``configs.reduced``): d_model 64, layers mamba, attention, mamba, 4 query
and 2 KV heads of 16, 6 experts of 128 (top 3) and a shared expert of 96,
the published multipliers.  Everything here is float32: the tolerances
are float32 rounding over a few layers, not bf16's.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

from repro_torch import tracing
from repro_torch.configs import get_config, reduced
from repro_torch.models import build_model
from repro_torch.models import granite_hybrid as gh
from repro_torch.models import lm
from repro_torch.models import moe

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
from portbench.reference import granite as ref  # noqa: E402

#: float32 end to end: the port and the reference sum in other orders
#: (chunked SSD against Listing 1, the flash kernel's plain version against
#: blocked attention, the experts grouped against one at a time), a few
#: float32 ulps of the logits' scale per layer; a wrong equation moves
#: the logits by 1e-2 or more
TOL = dict(rtol=1e-4, atol=1e-4)
REF_KEYS = ("d_model", "n_layers", "layer_types", "vocab", "n_heads", "n_kv_heads",
            "attention_multiplier", "ssm_state", "ssm_head_dim", "ssm_expand", "ssm_groups",
            "ssm_chunk", "norm_eps", "n_experts", "moe_top_k", "embedding_multiplier",
            "residual_multiplier", "logits_scaling")


def _cfg(**kw):
    return reduced(get_config("granite-4.0-h-small")).replace(n_kv_heads=2, **kw)


def _ref_cfg(cfg) -> dict:
    return {k: getattr(cfg, k) for k in REF_KEYS}


def _model(cfg, seed=0):
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(seed))
    # norms away from one and biases away from zero, so that a wrong
    # placement of either shows
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("scale", "norm_scale"):
                p.copy_(1 + 0.2 * torch.randn(p.shape, generator=g))
            elif leaf == "conv_b":
                p.copy_(0.1 * torch.randn(p.shape, generator=g))
    return model


def _params(model):
    return {k: v.detach() for k, v in model.named_parameters()}


def _tokens(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)))


def test_config_is_the_published_one():
    """The registered widths of Granite-4.0-H-Small (its config.json)."""
    cfg = get_config("granite-4.0-h-small")
    assert (cfg.family, cfg.n_layers, cfg.d_model, cfg.vocab) == ("granite_hybrid", 40, 4096, 100352)
    assert [i for i, k in enumerate(cfg.layer_types) if k == "attention"] == [5, 15, 25, 35]
    assert (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.rope_theta) == (32, 8, 128, 0.0)
    assert (cfg.n_experts, cfg.moe_top_k, cfg.d_ff, cfg.shared_ff) == (72, 10, 768, 1536)
    assert (cfg.ssm_state, cfg.ssm_head_dim, cfg.ssm_groups, cfg.ssm_chunk) == (128, 64, 1, 256)
    assert (cfg.embedding_multiplier, cfg.residual_multiplier, cfg.logits_scaling,
            cfg.attention_multiplier) == (12.0, 0.22, 16.0, 0.0078125)
    assert cfg.norm_eps == 1e-5 and cfg.padded_vocab == 100352
    model = build_model(cfg, device="meta")
    assert sum(p.numel() for p in model.parameters()) == 32_207_337_984
    assert len(model.blocks) == 36 and len(model.attn) == 4 and len(model.ffn) == 40
    assert model.blocks[0].mamba.cfg.n_heads == 128 and model.blocks[0].mamba.cfg.conv_dim == 8448


def test_reduced_has_both_kinds_of_layer():
    cfg = reduced(get_config("granite-4.0-h-small"))
    assert set(cfg.layer_types) == {"mamba", "attention"} and len(cfg.layer_types) == cfg.n_layers
    assert cfg.moe_impl == "dense" and cfg.shared_ff and cfg.n_experts > cfg.moe_top_k


@pytest.mark.parametrize("impl", ["dense", "sharded"])
def test_prefill_matches_reference(impl):
    """Last logits and final hidden states, with either dispatch."""
    cfg = _cfg(moe_impl=impl)
    model = _model(cfg)
    tokens = _tokens(cfg, 2, 48, 1)
    got, cache = model.prefill({"tokens": tokens})
    p, rc = _params(model), _ref_cfg(cfg)
    with torch.no_grad():
        h = ref.hidden(p, rc, tokens)
        torch.testing.assert_close(got, ref.logits(p, rc, h[:, -1]), **TOL)
        mine, _ = model.hidden({"tokens": tokens})
    torch.testing.assert_close(mine, h, **TOL)
    assert cache["attn_k"].shape == (1, 2, 48, 2, 16) and cache["ssm"].shape[0] == 2


def test_reference_matches_transformers():
    """The reference against ``GraniteMoeHybridForCausalLM`` (eager
    attention, the plain Mamba-2 path) with the same weights mapped to its
    layout, every position's logits."""
    tr = pytest.importorskip("transformers")
    cfg = _cfg()
    model = _model(cfg, seed=7)
    p, rc = _params(model), _ref_cfg(cfg)
    di = cfg.ssm_expand * cfg.d_model
    hf_cfg = tr.GraniteMoeHybridConfig(
        vocab_size=cfg.vocab, hidden_size=cfg.d_model, intermediate_size=cfg.d_ff,
        num_hidden_layers=cfg.n_layers, num_attention_heads=cfg.n_heads,
        num_key_value_heads=cfg.n_kv_heads, rms_norm_eps=cfg.norm_eps,
        embedding_multiplier=cfg.embedding_multiplier, logits_scaling=cfg.logits_scaling,
        residual_multiplier=cfg.residual_multiplier,
        attention_multiplier=cfg.attention_multiplier, num_local_experts=cfg.n_experts,
        num_experts_per_tok=cfg.moe_top_k, shared_intermediate_size=cfg.shared_ff,
        position_embedding_type="nope", layer_types=list(cfg.layer_types),
        mamba_n_heads=di // cfg.ssm_head_dim, mamba_n_groups=cfg.ssm_groups,
        mamba_d_state=cfg.ssm_state, mamba_d_head=cfg.ssm_head_dim,
        mamba_d_conv=cfg.conv_width, mamba_expand=cfg.ssm_expand,
        mamba_chunk_size=cfg.ssm_chunk, mamba_conv_bias=True, mamba_proj_bias=False,
        tie_word_embeddings=True, attn_implementation="eager")
    hf = tr.GraniteMoeHybridForCausalLM(hf_cfg).eval()
    sd = {"model.embed_tokens.weight": p["embed.table"], "model.norm.weight": p["ln_f.scale"]}
    seen = {"mamba": 0, "attention": 0}
    for i, kind in enumerate(cfg.layer_types):
        j, L = seen[kind], f"model.layers.{i}."
        seen[kind] += 1
        if kind == "mamba":
            b, m = f"blocks.{j}.", f"blocks.{j}.mamba."
            sd.update({L + "input_layernorm.weight": p[b + "ln.scale"],
                       L + "mamba.in_proj.weight": p[m + "w_in"].t(),
                       L + "mamba.conv1d.weight": p[m + "conv_w"].t()[:, None],
                       L + "mamba.conv1d.bias": p[m + "conv_b"],
                       L + "mamba.dt_bias": p[m + "dt_bias"], L + "mamba.A_log": p[m + "a_log"],
                       L + "mamba.D": p[m + "d_skip"], L + "mamba.norm.weight": p[m + "norm_scale"],
                       L + "mamba.out_proj.weight": p[m + "w_out"].t()})
        else:
            a = f"attn.{j}."
            flat = lambda w: w.reshape(cfg.d_model, -1).t()  # noqa: E731
            sd.update({L + "input_layernorm.weight": p[a + "ln.scale"],
                       L + "self_attn.q_proj.weight": flat(p[a + "attn.wq"]),
                       L + "self_attn.k_proj.weight": flat(p[a + "attn.wk"]),
                       L + "self_attn.v_proj.weight": flat(p[a + "attn.wv"]),
                       L + "self_attn.o_proj.weight": p[a + "attn.wo"].reshape(-1, cfg.d_model).t()})
        f = f"ffn.{i}."
        sd.update({L + "post_attention_layernorm.weight": p[f + "ln.scale"],
                   L + "block_sparse_moe.router.layer.weight": p[f + "moe.router"].t(),
                   L + "block_sparse_moe.input_linear.weight":
                       torch.cat([p[f + "moe.w_gate"], p[f + "moe.w_up"]], -1).transpose(1, 2),
                   L + "block_sparse_moe.output_linear.weight": p[f + "moe.w_down"].transpose(1, 2),
                   L + "shared_mlp.input_linear.weight":
                       torch.cat([p[f + "shared.w_gate"], p[f + "shared.w_up"]], -1).t(),
                   L + "shared_mlp.output_linear.weight": p[f + "shared.w_down"].t()})
    missing, unexpected = hf.load_state_dict({k: v.contiguous() for k, v in sd.items()},
                                             strict=False)
    assert not unexpected and set(missing) <= {"lm_head.weight"}, (missing, unexpected)
    tokens = _tokens(cfg, 2, 48, 8)
    with torch.no_grad():
        want = hf(input_ids=tokens).logits
        got = ref.logits(p, rc, ref.hidden(p, rc, tokens))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("impl", ["dense", "sharded"])
def test_prefill_then_decode_matches_full_forward(impl):
    """Prefill 32 tokens, then 8 greedy steps through the cache (the
    Mamba-2 layers' conv and SSM states, the attention layer's k/v at
    ``pos``): every step's logits against the reference's full forward
    pass over the same tokens."""
    cfg = _cfg(moe_impl=impl)
    model = _model(cfg, seed=5)
    tokens = _tokens(cfg, 2, 32, 6)
    logits, cache = model.prefill({"tokens": tokens}, max_len=40)
    seq, steps = tokens, [logits]
    for _ in range(8):
        nxt = logits.argmax(-1)
        seq = torch.cat([seq, nxt[:, None]], dim=1)
        logits, cache = model.decode_step(nxt, cache)
        steps.append(logits)
    p, rc = _params(model), _ref_cfg(cfg)
    with torch.no_grad():
        want = ref.logits(p, rc, ref.hidden(p, rc, seq[:, :40]))[:, 31:]
    torch.testing.assert_close(torch.stack(steps[:9], dim=1), want, **TOL)
    assert int(cache["pos"][0]) == 40


def _moe_params(E, D=32, F=24, seed=0):
    return moe.init_moe(torch.Generator().manual_seed(seed), D, F, E, 1)


@pytest.mark.parametrize("E,k,silent", [(8, 2, None), (8, 2, 3), (6, 6, None), (1, 1, None),
                                        (16, 4, 0)])
def test_dropless_dispatch_equals_the_dense_one(E, k, silent):
    """The same function as ``apply_moe_dense`` (output and load-balancing
    loss) at float32 rounding, with an expert that receives no token and
    with k = E."""
    p = _moe_params(E)
    x = torch.randn(3, 20, 32, generator=torch.Generator().manual_seed(E + k))
    if silent is not None:                   # that expert's logit far below the others
        p["router"][:, silent] = -p["router"].abs().sum(0).max() - 1.0
        x = x.abs()
        idx, _, _ = moe.router_probs(p["router"], x, k)
        assert not (idx == silent).any()
    yd, auxd = moe.apply_moe_dense(p, x, k, E)
    yl, auxl = moe.apply_moe_dropless(p, x, k, E)
    torch.testing.assert_close(yl, yd, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(auxl, auxd, rtol=1e-6, atol=1e-6)
    assert moe.apply_moe_dropless(p, x[0], k, E, with_aux=False)[1] is None


def test_dropless_dispatch_does_the_chosen_pairs_work_only(monkeypatch):
    """Each expert's products see its own rows only: T k rows in all, and
    no (E, T, D) masked copy of the tokens."""
    E, k, T = 8, 2, 40
    p = _moe_params(E)
    x = torch.randn(T, 32, generator=torch.Generator().manual_seed(1))
    rows, real = [], torch.mm

    def mm(a, b, *args, **kwargs):
        rows.append(a.shape[0])
        return real(a, b, *args, **kwargs)

    monkeypatch.setattr(torch, "mm", mm)
    monkeypatch.setattr(moe, "_expert_ffn", None)      # the dense dispatch's products
    tracing.reset_tallies()
    moe.apply_moe_dropless(p, x, k, E)
    assert sum(rows) == 3 * T * k
    t = tracing.tallies()
    assert t["moe.pairs"] == {"count": 1, "total": T * k, "max": T * k}
    idx, _, _ = moe.router_probs(p["router"], x, k)
    assert t["moe.max_expert_rows"]["max"] == int(torch.bincount(idx.reshape(-1)).max())


def test_sharded_impl_without_a_mesh_is_the_dropless_dispatch():
    cfg = reduced(get_config("granite-moe-1b-a400m")).replace(moe_impl="sharded")
    model = build_model(cfg, device="cpu")
    x = torch.randn(2, 8, cfg.d_model)
    want = moe.apply_moe_dropless(model.blocks[0].moe, x, cfg.moe_top_k, cfg.n_experts)
    got = lm._apply_ffn(model.blocks[0], x, cfg)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssm_block_at_residual_factor_one_is_x_plus_y(dtype):
    """``torch.add(x, y, alpha=1)``, the block's residual at the factor
    every other configuration has, is ``x + y`` bit for bit."""
    cfg = get_config("mamba2-1.3b").replace(n_layers=1, d_model=64, vocab=256, ssm_state=16,
                                           ssm_head_dim=16, ssm_chunk=16, dtype="float32")
    model = build_model(cfg, device="cpu")
    blk = model.blocks[0].to(dtype)
    x = torch.randn(2, 32, 64, generator=torch.Generator().manual_seed(2)).to(dtype)
    with torch.no_grad():
        y = blk.mamba(lm._norm(blk.ln, x, cfg))
        assert torch.equal(blk(x), x + y)
        assert torch.equal(torch.add(x, y, alpha=cfg.residual_multiplier), x + y)


def test_the_residual_factor_scales_the_mixer():
    cfg = _cfg()
    model = _model(cfg)
    blk = model.blocks[0]
    x = torch.randn(2, 32, cfg.d_model, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        y = blk.mamba(lm._norm(blk.ln, x, cfg))
        torch.testing.assert_close(blk(x), x + 0.22 * y, rtol=1e-6, atol=1e-6)


def test_a_mesh_and_bad_layer_types_are_refused():
    cfg = _cfg()
    with pytest.raises(ValueError, match="one device"):
        gh.GraniteHybridModel(cfg, device="cpu", mesh=object())
    with pytest.raises(ValueError, match="layer_types"):
        build_model(cfg.replace(layer_types=("mamba", "conv", "mamba")), device="cpu")


def test_the_spans_of_a_prefill():
    """``granite.attention`` once per attention layer, and per layer
    ``granite.moe`` (holding ``granite.moe.route`` and
    ``granite.moe.experts``) and ``granite.shared_mlp``."""
    from torch.profiler import ProfilerActivity, profile

    cfg = _cfg(moe_impl="sharded")
    model = _model(cfg)
    tokens = _tokens(cfg, 2, 32, 2)
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        model.prefill({"tokens": tokens})
    spans = tracing.spans()
    names = [s.name for s in spans]
    assert names.count("granite.attention") == 1 and names.count("granite.moe") == 3
    assert names.count("granite.shared_mlp") == 3 and names.count("granite.moe.route") == 3
    by_id = {s.id: s for s in spans}
    for s in spans:
        if s.name in ("granite.moe.route", "granite.moe.experts"):
            assert by_id[s.parent].name == "granite.moe"
    att = next(s for s in spans if s.name == "granite.attention")
    assert att.attrs == {"B": 2, "S": 32, "H": 4, "KV": 2, "Dh": 16}
    ex = next(s for s in spans if s.name == "granite.moe.experts")
    assert ex.attrs["pairs"] == 64 * cfg.moe_top_k
    assert isinstance(ex.attrs["max_rows"], int) and 0 < ex.attrs["experts"] <= cfg.n_experts


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("E,k,silent", [(72, 10, None), (72, 10, 5), (8, 8, None)])
def test_grouped_dispatch_on_the_card(card, E, k, silent):
    """bf16 on the card: the grouped products (``torch._grouped_mm``) give
    the one-expert-at-a-time products' output within bf16 rounding, an
    expert without rows included, and nothing waits for the card."""
    p = {n: t.to(card, torch.float32 if n == "router" else torch.bfloat16)
         for n, t in moe.init_moe(torch.Generator().manual_seed(E), 512, 256, E, k).items()}
    x = torch.randn(4, 300, 512, generator=torch.Generator().manual_seed(1)).to(card, torch.bfloat16)
    if silent is not None:
        p["router"][:, silent] = -1e4
        x = x.abs()
    with torch.inference_mode():
        assert moe._grouped(x, p["w_gate"], p["w_up"], p["w_down"])
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got, _ = moe.apply_moe_dropless(p, x, k, E, with_aux=False)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        want, _ = moe.apply_moe_dense({n: t.float() for n, t in p.items()}, x.float(), k, E)
    err = float((got.float() - want).norm() / want.norm())
    assert err < 1e-2, err


@pytest.mark.cuda
def test_granite_prefill_on_card_matches_plain(card):
    """The reduced model in float32 on the card (conv1d, the SSD, the tail
    and flash kernels; the experts one at a time) against the plain path
    on the CPU, prefill and 4 decode steps."""
    cfg = _cfg(moe_impl="sharded")
    cpu = _model(cfg, seed=11)
    gpu = build_model(cfg, device="cuda", generator=torch.Generator(device="cuda").manual_seed(0))
    gpu.load_state_dict(cpu.state_dict())
    tokens = _tokens(cfg, 2, 64, 12)
    want, wc = cpu.prefill({"tokens": tokens}, max_len=68)
    got, gc = gpu.prefill({"tokens": tokens.cuda()}, max_len=68)
    torch.testing.assert_close(got.cpu(), want, rtol=2e-4, atol=2e-4)
    for _ in range(4):
        nxt = want.argmax(-1)
        want, wc = cpu.decode_step(nxt, wc)
        got, gc = gpu.decode_step(nxt.cuda(), gc)
        torch.testing.assert_close(got.cpu(), want, rtol=2e-4, atol=2e-4)
