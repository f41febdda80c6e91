"""Plain PyTorch reference of the benchmarked language model.

Written from the published equations, not from the program: the Mamba-2
block and its SSD in the chunked dual form of Listing 1 of
arXiv:2405.21060.  It imports nothing of the program and
reads only the parameters the benchmark drew (``portbench.weights``),
keyed by name.

Every product runs in float32 with TF32 off (:func:`exact`), or, for the
control, with its operands rounded to float8 e4m3 (``precision="fp8"``):
one scale per operand, its largest magnitude mapped to 448.  The rounding
passes gradients straight through, so the same functions give the
control's training step.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

Params = Mapping[str, torch.Tensor]

PRECISIONS = ("f32", "fp8")
FP8_MAX = 448.0
RMS_EPS = 1e-6


def exact() -> None:
    """float32 products stay float32 on the card (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def rounded(x: torch.Tensor, precision: str) -> torch.Tensor:
    """``x`` as the product of ``precision`` reads it; the gradient passes
    through the rounding unchanged."""
    if precision == "f32":
        return x
    if precision != "fp8":
        raise ValueError(f"unknown precision {precision!r}; expected {PRECISIONS}")
    d = x.detach()
    scale = FP8_MAX / d.abs().amax().clamp(min=1e-30)
    q = (d * scale).to(torch.float8_e4m3fn).float() / scale
    return x + (q - d)


def prod(eq: str, *ops: torch.Tensor, precision: str = "f32") -> torch.Tensor:
    """One product (an einsum) of float32 operands at ``precision``."""
    return torch.einsum(eq, *[rounded(o.float(), precision) for o in ops])


def rmsnorm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + RMS_EPS) * scale


# ---------------------------------------------------------------------------
# Mamba-2
# ---------------------------------------------------------------------------

def segsum(a: torch.Tensor) -> torch.Tensor:
    """(..., T) -> (..., T, T): out[i, j] = a[j+1] + ... + a[i] for i >= j,
    -inf above the diagonal (Listing 1's stable segment sum)."""
    T = a.shape[-1]
    x = a[..., None].expand(*a.shape, T)
    below = torch.tril(torch.ones(T, T, dtype=torch.bool, device=a.device), diagonal=-1)
    x = torch.cumsum(x.masked_fill(~below, 0.0), dim=-2)
    keep = torch.tril(torch.ones(T, T, dtype=torch.bool, device=a.device))
    return x.masked_fill(~keep, -math.inf)


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
        Cm: torch.Tensor, chunk: int, precision: str = "f32") -> torch.Tensor:
    """The SSD from a zero state.  x (b, l, h, p); dt (b, l, h) after the
    softplus; A (h,) negative; Bm, Cm (b, l, n), one group for all heads.
    h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t^T, y_t = C_t h_t, computed
    chunk by chunk as Listing 1 of arXiv:2405.21060 does; a ragged last
    chunk is padded after the sequence, which no earlier position reads."""
    b, l, h, p = x.shape
    pad = -l % chunk
    if pad:
        grow = lambda t: F.pad(t, (0, 0) * (t.ndim - 2) + (0, pad))   # noqa: E731
        return ssd(grow(x), grow(dt), A, grow(Bm), grow(Cm), chunk, precision)[:, :l]
    n, c = Bm.shape[-1], l // chunk
    mm = dict(precision=precision)
    X = (x * dt[..., None]).reshape(b, c, chunk, h, p)
    Adt = (dt * A).reshape(b, c, chunk, h).permute(0, 3, 1, 2)        # b h c q
    Bc = Bm.reshape(b, c, chunk, n)
    Cc = Cm.reshape(b, c, chunk, n)
    A_cum = torch.cumsum(Adt, dim=-1)
    decay = torch.exp(segsum(Adt))                                     # b h c q s
    CB = prod("bcln,bcsn->bcls", Cc, Bc, **mm)
    y_diag = prod("bhcls,bcshp->bclhp", decay * CB[:, None], X, **mm)
    to_end = torch.exp(A_cum[..., -1:] - A_cum).permute(0, 2, 3, 1)   # b c q h
    states = prod("bcln,bclhp->bchpn", Bc, X * to_end[..., None], **mm)
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    across = torch.exp(segsum(F.pad(A_cum[..., -1], (1, 0))))          # b h c+1 c+1
    states = prod("bhzc,bchpn->bzhpn", across, states, **mm)[:, :-1]
    from_start = torch.exp(A_cum).permute(0, 2, 3, 1)                  # b c q h
    y_off = prod("bcln,bchpn->bclhp", Cc, states, **mm) * from_start[..., None]
    return (y_diag + y_off).reshape(b, l, h, p)


def mamba_mixer(p: Params, pre: str, x: torch.Tensor, cfg: Mapping,
                precision: str) -> torch.Tensor:
    """One Mamba-2 mixer over x (b, l, d): the in-projection to z, x|B|C
    and dt; the depthwise causal conv1d and SiLU over x|B|C; the SSD with
    the skip D x; the gated RMSNorm, norm(y * silu(z)); the out-projection."""
    d, N, P = cfg["d_model"], cfg["ssm_state"], cfg["ssm_head_dim"]
    di = cfg["ssm_expand"] * d
    H = di // P
    b, l, _ = x.shape
    zxbcdt = prod("bld,de->ble", x, p[pre + "w_in"], precision=precision)
    z, xbc, dt = torch.split(zxbcdt, [di, di + 2 * N, H], dim=-1)
    w = p[pre + "conv_w"]
    W = w.shape[0]
    xp = F.pad(xbc, (0, 0, W - 1, 0))
    conv = p[pre + "conv_b"] + sum(xp[:, t:t + l] * w[t] for t in range(W))
    xs, Bm, Cm = torch.split(F.silu(conv), [di, N, N], dim=-1)
    dt = F.softplus(dt + p[pre + "dt_bias"])
    A = -torch.exp(p[pre + "a_log"])
    xh = xs.reshape(b, l, H, P)
    y = ssd(xh, dt, A, Bm, Cm, min(cfg["ssm_chunk"], l), precision)
    y = (y + p[pre + "d_skip"][:, None] * xh).reshape(b, l, di)
    y = rmsnorm(y * F.silu(z), p[pre + "norm_scale"])
    return prod("ble,ed->bld", y, p[pre + "w_out"], precision=precision)


# ---------------------------------------------------------------------------
# the language model
# ---------------------------------------------------------------------------

def hidden(p: Params, cfg: Mapping, tokens: torch.Tensor, precision: str = "f32",
           remat: bool = False) -> torch.Tensor:
    """tokens (b, s) -> final-norm hidden states (b, s, d), float32.  With
    ``remat`` each block is recomputed in the backward."""
    x = p["embed.table"][tokens.long()].float()

    def block(i, x):
        pre = f"blocks.{i}."
        return x + mamba_mixer(p, pre + "mamba.", rmsnorm(x, p[pre + "ln.scale"]), cfg,
                               precision)

    for i in range(cfg["n_layers"]):
        x = checkpoint(block, i, x, use_reentrant=False) if remat else block(i, x)
    return rmsnorm(x, p["ln_f.scale"])


def logits(p: Params, cfg: Mapping, h: torch.Tensor, precision: str = "f32") -> torch.Tensor:
    """(..., d) -> (..., vocab) against the tied embedding's real rows."""
    return prod("...d,vd->...v", h, p["embed.table"][:cfg["vocab"]], precision=precision)


def last_logits(p: Params, cfg: Mapping, tokens: torch.Tensor,
                precision: str = "f32") -> torch.Tensor:
    """Logits after the last position of each row: (b, vocab)."""
    return logits(p, cfg, hidden(p, cfg, tokens, precision)[:, -1], precision)


def loss(p: Params, cfg: Mapping, tokens: torch.Tensor, labels: torch.Tensor,
         precision: str = "f32", chunk: int = 512) -> torch.Tensor:
    """Mean cross-entropy of ``labels`` (b, s) after each position, the
    blocks recomputed in the backward and the logits taken ``chunk``
    positions at a time."""
    h = hidden(p, cfg, tokens, precision, remat=True)

    def part(h, lab):
        lg = logits(p, cfg, h, precision)
        return F.cross_entropy(lg.reshape(-1, lg.shape[-1]), lab.reshape(-1).long(),
                               reduction="sum")

    s = h.shape[1]
    total = sum(checkpoint(part, h[:, i:i + chunk], labels[:, i:i + chunk],
                           use_reentrant=False) for i in range(0, s, chunk))
    return total / labels.numel()


def as_f32(params: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """float32 copies of the drawn parameters (the values unchanged)."""
    return {k: v.detach().float() for k, v in params.items()}


def dtypes_of(params: Mapping[str, torch.Tensor]) -> Dict[str, torch.dtype]:
    return {k: v.dtype for k, v in params.items()}

