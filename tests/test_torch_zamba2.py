"""The zamba2 family (Zyphra's shared attention blocks over grouped Mamba-2
mixers) on the CPU: the port's plain path against the plain reference
``tests/zamba2_reference.py``, the reference against the published
``Zamba2ForCausalLM`` where ``transformers`` is installed, the grouped
gated norm, and the SSD's gradient routing at G > 1.

The model is the registered ``zamba2-7b`` cut to a small size
(``configs.reduced``): d_model 64, 6 layers of which 1, 2, 4 and 5 are
hybrid (two applications of each of the two shared blocks), 4 heads of
32 = 2 d_model / 4, two B/C groups.  Everything here is float32: the
tolerances are float32 rounding over a few layers, not bf16's.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

from repro_torch.configs import get_config, reduced
from repro_torch.kernels import ssd as tssd
from repro_torch.kernels.autograd import PlainGrad
from repro_torch.models import build_model
from repro_torch.models import zamba2 as z2
from repro_torch.models.common import rmsnorm
from repro_torch.models.mamba2 import gated_norm
from repro_torch.serve import step

sys.path.insert(0, str(Path(__file__).resolve().parent))
import zamba2_reference as ref  # noqa: E402

#: float32 end to end: the port and the reference sum in other orders
#: (chunked SSD against Listing 1, tiled against whole attention), which
#: leaves differences of a few float32 ulps of the logits' scale (about 1)
#: per layer; 1e-4 holds six layers with room, and a wrong equation moves
#: the logits by 1e-2 or more
TOL = dict(rtol=1e-4, atol=1e-4)


def _cfg(**kw):
    return reduced(get_config("zamba2-7b")).replace(**kw)


def _ref_cfg(cfg) -> dict:
    keys = ("d_model", "n_layers", "vocab", "n_heads", "attn_width", "ssm_state",
            "ssm_head_dim", "ssm_expand", "ssm_groups", "ssm_chunk", "norm_eps",
            "rope_theta", "n_shared_blocks", "hybrid_layer_ids")
    return {k: getattr(cfg, k) for k in keys}


def _model(cfg, seed=0):
    torch.manual_seed(seed)
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(seed))
    # norms away from one and biases away from zero, so that a wrong
    # placement of either shows
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("scale", "ln_in", "ln_ff", "norm_scale"):
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
    """The registered widths of Zamba2-7B-Instruct (its config.json)."""
    cfg = get_config("zamba2-7b")
    assert (cfg.family, cfg.n_layers, cfg.d_model, cfg.vocab) == ("zamba2", 81, 3584, 32000)
    assert cfg.hybrid_layer_ids == (6, 11, 17, 23, 29, 35, 41, 47, 53, 59, 65, 71, 77)
    assert (cfg.n_shared_blocks, cfg.adapter_rank, cfg.attn_width, cfg.n_heads) == (2, 128, 7168, 32)
    assert z2.attn_head_dim(cfg) == 224 and cfg.d_ff == 14336
    assert (cfg.ssm_state, cfg.ssm_head_dim, cfg.ssm_groups, cfg.ssm_chunk) == (64, 64, 2, 256)
    assert cfg.norm_eps == 1e-5 and cfg.padded_vocab == 32000
    model = build_model(cfg, device="meta")
    assert sum(p.numel() for p in model.parameters()) == 7_356_749_648
    assert model.blocks[0].mamba.cfg.n_heads == 112 and model.blocks[0].mamba.cfg.conv_dim == 7424


def test_prefill_logits_match_reference():
    cfg = _cfg()
    model = _model(cfg)
    tokens = _tokens(cfg, 2, 48, 1)
    got, cache = model.prefill({"tokens": tokens})
    want = ref.logits(_params(model), _ref_cfg(cfg), tokens)[:, -1]
    torch.testing.assert_close(got, want, **TOL)
    assert cache["attn_k"].shape == (4, 2, 48, 4, 32) and cache["ssm"].shape[0] == 6


def test_full_forward_matches_reference():
    """``hidden`` (the full-sequence path, no cache) at every position."""
    cfg = _cfg()
    model = _model(cfg, seed=3)
    tokens = _tokens(cfg, 2, 32, 4)
    with torch.no_grad():
        h, _ = model.hidden({"tokens": tokens})
        got = model._logits(h)
    torch.testing.assert_close(got, ref.logits(_params(model), _ref_cfg(cfg), tokens), **TOL)


def test_prefill_then_decode_matches_full_forward():
    """Prefill 32 tokens, then 8 greedy steps through the caches (each
    application's K/V written at ``pos``, the mixers' conv and SSM
    states): every step's logits against the reference's full forward
    pass over the same tokens."""
    cfg = _cfg()
    model = _model(cfg, seed=5)
    prompt = _tokens(cfg, 2, 32, 6)
    n = 8
    logits, cache = model.prefill({"tokens": prompt}, max_len=32 + n)
    assert cache["attn_k"].shape[2] == 32 + n and not cache["attn_k"][:, :, 32:].any()
    steps, toks = [logits], [logits.argmax(-1)]
    for _ in range(n - 1):
        logits, cache = model.decode_step(toks[-1], cache)
        steps.append(logits)
        toks.append(logits.argmax(-1))
    full = torch.cat([prompt, torch.stack(toks[:-1], dim=1)], dim=1)
    want = ref.logits(_params(model), _ref_cfg(cfg), full)[:, 31:]
    torch.testing.assert_close(torch.stack(steps, dim=1), want, **TOL)
    served = step.generate(model, {"tokens": prompt}, n)
    assert torch.equal(served, torch.stack(toks, dim=1).to(torch.int32))


@pytest.mark.parametrize("app", range(4))
def test_each_adapter_reaches_the_output(app):
    """Zeroing one application's adapter moves the logits far beyond the
    tolerance, and the reference moves with the program."""
    cfg = _cfg()
    model = _model(cfg, seed=7)
    tokens = _tokens(cfg, 2, 32, 8)
    before, _ = model.prefill({"tokens": tokens})
    with torch.no_grad():
        model.apps[app].adapter_b.zero_()
    after, _ = model.prefill({"tokens": tokens})
    assert (after - before).abs().max() > 1e-2
    torch.testing.assert_close(after, ref.logits(_params(model), _ref_cfg(cfg), tokens)[:, -1],
                               **TOL)


def test_attention_scale_is_half_head_dim(monkeypatch):
    """Every application's flash call scores with (Dh / 2)^-1/2, and a
    reference scored with Dh^-1/2 disagrees with the program."""
    cfg = _cfg()
    model = _model(cfg, seed=9)
    scales = []
    real = z2.flash_attention

    def spy(q, k, v, causal=True, scale=None):
        scales.append((q.shape[-1], scale))
        return real(q, k, v, causal=causal, scale=scale)

    monkeypatch.setattr(z2, "flash_attention", spy)
    tokens = _tokens(cfg, 1, 32, 10)
    got, _ = model.prefill({"tokens": tokens})
    assert scales == [(32, 16 ** -0.5)] * 4
    assert z2.attn_scale(get_config("zamba2-7b")) == 112 ** -0.5
    monkeypatch.setattr(ref, "attention", lambda q, k, v, scale, _a=ref.attention:
                        _a(q, k, v, q.shape[-1] ** -0.5))
    wrong = ref.logits(_params(model), _ref_cfg(cfg), tokens)[:, -1]
    assert (got - wrong).abs().max() > 1e-2


@pytest.mark.parametrize("shape", [(2, 5, 64), (3, 128)])
def test_grouped_gated_norm(shape):
    """One group is the RMSNorm over all channels, bit for bit; two groups
    normalise each half on its own, which differs when the halves differ
    in scale."""
    g = torch.Generator().manual_seed(11)
    y = torch.randn(shape, generator=g)
    y[..., shape[-1] // 2:] *= 5.0
    z = torch.randn(shape, generator=g)
    w = 1 + 0.1 * torch.randn(shape[-1], generator=g)
    assert torch.equal(gated_norm(y, z, w, 1, 1e-6), rmsnorm(y * torch.nn.functional.silu(z), w))
    two = gated_norm(y, z, w, 2, 1e-5)
    h = (y * torch.nn.functional.silu(z)).unflatten(-1, (2, -1))
    want = (h * torch.rsqrt(h.pow(2).mean(-1, keepdim=True) + 1e-5)).flatten(-2) * w
    torch.testing.assert_close(two, want, rtol=1e-6, atol=1e-6)
    assert (two - gated_norm(y, z, w, 1, 1e-5)).abs().max() > 0.1


def test_mixer_groups_read_their_own_b_and_c():
    """With two groups, heads of the second half read the second B/C
    group: the plain SSD against the reference's Listing 1 with groups,
    and against two one-group calls, one per half of the heads."""
    g = torch.Generator().manual_seed(12)
    B, L, H, P, G, N, Q = 2, 32, 4, 8, 2, 16, 16
    x = torch.randn(B, L, H, P, generator=g)
    dt = torch.rand(B, L, H, generator=g) * 0.2 + 0.01
    A = -torch.rand(H, generator=g) - 0.5
    Bm, Cm = torch.randn(B, L, G, N, generator=g), torch.randn(B, L, G, N, generator=g)
    y, _ = tssd.ssd(x, dt, A, Bm, Cm, Q)
    torch.testing.assert_close(y, ref.ssd(x, dt, A, Bm, Cm, Q), **TOL)
    for grp in range(G):
        hs = slice(grp * H // G, (grp + 1) * H // G)
        half, _ = tssd.ssd(x[:, :, hs], dt[:, :, hs], A[hs], Bm[:, :, grp:grp + 1],
                           Cm[:, :, grp:grp + 1], Q)
        torch.testing.assert_close(y[:, :, hs], half, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("groups", [1, 2])
def test_ssd_gradient_routing_by_groups(groups, monkeypatch):
    """On the card a tensor-core call that needs a gradient takes the
    backward kernel only with one B/C group; with two it goes through
    ``PlainGrad`` (autograd of the plain version).  Rehearsed here with the
    CPU made to look like the card: the plain version as the kernel and
    the instance forced to ``tensor_core``."""
    routes = []
    monkeypatch.setattr(tssd.ops, "PLAIN_DEVICES", ())
    monkeypatch.setattr(tssd.ops, "build_kernel",
                        lambda: lambda *a: tssd.ref.ssd_chunked(*a))
    monkeypatch.setattr(tssd.ops, "select_instance", lambda *a: "tensor_core")
    monkeypatch.setattr(tssd.ops.SSDFunction, "apply",
                        lambda *a: routes.append("backward kernel") or (None, None))
    real_plain = PlainGrad.apply
    monkeypatch.setattr(PlainGrad, "apply",
                        lambda *a: routes.append("plain") or real_plain(*a))
    g = torch.Generator().manual_seed(13)
    B, L, H, P, N = 1, 32, 4, 8, 16
    x = torch.randn(B, L, H, P, generator=g, requires_grad=True)
    dt = torch.rand(B, L, H, generator=g) * 0.2 + 0.01
    A = -torch.rand(H, generator=g) - 0.5
    Bm = torch.randn(B, L, groups, N, generator=g, requires_grad=True)
    Cm = torch.randn(B, L, groups, N, generator=g)
    y, _ = tssd.ssd(x, dt, A, Bm, Cm, 16)
    if groups == 1:
        assert routes == ["backward kernel"]
        return
    assert routes == ["plain"]
    y.sum().backward()
    xr, br = x.detach().requires_grad_(), Bm.detach().requires_grad_()
    tssd.ref.ssd_chunked(xr, dt, A, br, Cm, 16)[0].sum().backward()
    torch.testing.assert_close(x.grad, xr.grad, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(Bm.grad, br.grad, rtol=1e-6, atol=1e-6)


def test_the_serve_launcher_takes_zamba2_7b(capsys):
    from repro_torch.launch import serve

    out = serve.main(["--arch", "zamba2-7b", "--reduced", "--device", "cpu", "--batch", "2",
                      "--gen", "3"])
    assert out["tokens"].shape == (2, 3)
    assert "[serve] zamba2-7b on cpu" in capsys.readouterr().out


def test_reference_imports_neither_jax_nor_the_port():
    code = ("import sys; sys.path.insert(0, sys.argv[1]); import zamba2_reference; "
            "print(sorted({m.split('.')[0] for m in sys.modules} "
            "& {'jax', 'repro', 'repro_torch', 'transformers'}))")
    out = subprocess.run([sys.executable, "-c", code, str(Path(__file__).resolve().parent)],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"


def _hf_model(cfg, params):
    """``Zamba2ForCausalLM`` of the same small widths, given ``params``."""
    transformers = pytest.importorskip("transformers")
    kinds = ["hybrid" if i in cfg.hybrid_layer_ids else "mamba" for i in range(cfg.n_layers)]
    hc = transformers.Zamba2Config(
        vocab_size=cfg.vocab, hidden_size=cfg.d_model, num_hidden_layers=cfg.n_layers,
        layers_block_type=kinds, mamba_d_state=cfg.ssm_state, mamba_d_conv=cfg.conv_width,
        mamba_expand=cfg.ssm_expand, mamba_ngroups=cfg.ssm_groups,
        n_mamba_heads=cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim,
        chunk_size=cfg.ssm_chunk, intermediate_size=cfg.d_ff, hidden_act="gelu",
        num_attention_heads=cfg.n_heads, num_mem_blocks=cfg.n_shared_blocks,
        adapter_rank=cfg.adapter_rank, use_shared_attention_adapter=False,
        use_mem_rope=True, rope_theta=cfg.rope_theta, rms_norm_eps=cfg.norm_eps,
        max_position_embeddings=256, attn_implementation="eager")
    hf = transformers.Zamba2ForCausalLM(hc).eval()
    A = cfg.attn_width
    t = lambda name: params[name].t().contiguous()  # noqa: E731
    with torch.no_grad():
        hf.model.embed_tokens.weight.copy_(params["embed.table"])
        hf.lm_head.weight.copy_(params["embed.table"])
        hf.model.final_layernorm.weight.copy_(params["ln_f.scale"])
        for i, layer in enumerate(hf.model.layers):
            mamba = layer.mamba_decoder if hasattr(layer, "mamba_decoder") else layer
            pre = f"blocks.{i}."
            mamba.input_layernorm.weight.copy_(params[pre + "ln.scale"])
            mx, p = mamba.mamba, lambda leaf: params[pre + "mamba." + leaf]  # noqa: E731
            mx.in_proj.weight.copy_(p("w_in").t())
            mx.conv1d.weight.copy_(p("conv_w").t()[:, None])
            mx.conv1d.bias.copy_(p("conv_b"))
            mx.dt_bias.copy_(p("dt_bias"))
            mx.A_log.copy_(p("a_log"))
            mx.D.copy_(p("d_skip"))
            mx.norm.weight.copy_(p("norm_scale"))
            mx.out_proj.weight.copy_(p("w_out").t())
            if i not in cfg.hybrid_layer_ids:
                continue
            j = cfg.hybrid_layer_ids.index(i)
            blk, sb = layer.shared_transformer, f"shared.{j % cfg.n_shared_blocks}."
            layer.linear.weight.copy_(t(f"apps.{j}.linear"))
            qkv = params[sb + "w_qkv"]
            for k, proj in enumerate((blk.self_attn.q_proj, blk.self_attn.k_proj,
                                      blk.self_attn.v_proj)):
                proj.weight.copy_(qkv[:, k * A:(k + 1) * A].t())
            blk.self_attn.o_proj.weight.copy_(t(sb + "w_o"))
            blk.input_layernorm.weight.copy_(params[sb + "ln_in"])
            blk.pre_ff_layernorm.weight.copy_(params[sb + "ln_ff"])
            blk.feed_forward.gate_up_proj.weight.copy_(t(sb + "w_gate_up"))
            blk.feed_forward.down_proj.weight.copy_(t(sb + "w_down"))
            adapter = blk.feed_forward.gate_up_proj_adapter_list[j]
            adapter[0].weight.copy_(t(f"apps.{j}.adapter_a"))
            adapter[1].weight.copy_(t(f"apps.{j}.adapter_b"))
    return hf


def test_reference_matches_published_zamba2():
    """The reference's equations against ``Zamba2ForCausalLM`` on copied
    weights.  dt_bias is set to 0 so that softplus(dt) stays far above
    ``time_step_min``: the published plain path clamps dt there and its
    kernel path does not (the reference follows the kernel path), so the
    two agree only where the clamp is idle."""
    cfg = _cfg()
    model = _model(cfg, seed=14)
    with torch.no_grad():
        for blk in model.blocks:
            blk.mamba.dt_bias.zero_()
    params = _params(model)
    hf = _hf_model(cfg, params)
    tokens = _tokens(cfg, 2, 48, 15)
    with torch.no_grad():
        want = hf(input_ids=tokens, use_cache=False).logits
    got = ref.logits(params, _ref_cfg(cfg), tokens)
    torch.testing.assert_close(got, want, **TOL)
