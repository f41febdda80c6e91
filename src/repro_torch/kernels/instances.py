"""What the kernels with a bf16 tensor-core instance share (SSD and flash
attention): which operands a bulk tensor copy can read, launch counts per
instance, and how a tensor-core instance is held against the plain version
that rounds the operands it rounds (``ssd.ref.ssd_passes(round_operands=True)``,
``flash_attention.ref.attention_tiled(round_p=True)``).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

#: bf16 ulps, at the scale of each output row, by which a tensor-core
#: instance may differ from the float32 result of the plain version that
#: rounds what it rounds (its own bf16 output rounding is half of one)
ROUNDED_ULPS = 4.0
#: how far the instance's error from that float32 result may exceed, in
#: norm, the error of rounding that result to bf16 itself
ROUNDED_NORM_RATIO = 1.25


def tma_ready(t: torch.Tensor) -> bool:
    """A bulk tensor copy needs a 16-byte aligned base and strides that are
    multiples of 16 bytes (the last dimension is contiguous)."""
    return (t.data_ptr() % 16 == 0
            and all((s * t.element_size()) % 16 == 0 for s in t.stride()[:-1]))


class InstanceCounts:
    """Launch counts of a kernel with several instances: ``launches`` in
    all and ``instance_launches`` per instance.  ``count`` is called where
    an instance is launched, and nowhere else."""

    symbol: str
    instances: Tuple[str, ...]

    def __init__(self):
        self.reset()

    def count(self, instance: str) -> None:
        self.launches += 1
        self.instance_launches[instance] += 1

    def reset(self) -> None:
        self.launches = 0
        self.instance_launches = dict.fromkeys(self.instances, 0)

    def instance_counts(self) -> Dict[str, int]:
        """Launches per instance, keyed ``<symbol>/<instance>``."""
        return {f"{self.symbol}/{i}": n for i, n in self.instance_launches.items()}


def rounded_agreement(out: torch.Tensor, want32: torch.Tensor) -> Dict[str, float]:
    """``out``, a tensor-core instance's result, against ``want32``, the
    float32 result of the plain version that rounds the operands the
    instance rounds, on the same inputs.  Returns

    * ``ulps``: the largest |out - want32| in bf16 ulps (8 significant
      bits) of max(|want32|, the root mean square of its row), rows being
      the last dimension, so that an element near zero is measured at the
      scale of its row;
    * ``norm_ratio``: ||out - want32|| over ||bf16(want32) - want32||, the
      error of rounding the plain result itself to bf16.  An instance that
      computes what that version computes and rounds its result to bf16
      reads about 1; one off by half an ulp throughout reads about 1.4.

    :func:`check_rounded` holds them to :data:`ROUNDED_ULPS` and
    :data:`ROUNDED_NORM_RATIO`."""
    want32 = want32.float()
    err = out.float() - want32
    rms = want32.square().mean(dim=-1, keepdim=True).sqrt()
    scale = torch.maximum(want32.abs(), rms).clamp(min=1e-30)
    ulp = torch.ldexp(torch.ones_like(scale), torch.frexp(scale).exponent - 8)
    control = (want32.to(torch.bfloat16).float() - want32).norm()
    return {"ulps": float((err.abs() / ulp).max()),
            "norm_ratio": float(err.norm() / control.clamp(min=1e-30))}


def check_rounded(name: str, out: torch.Tensor, want32: torch.Tensor) -> Dict[str, float]:
    """:func:`rounded_agreement`, raising ``AssertionError`` past its
    limits; returns the readings."""
    r = rounded_agreement(out, want32)
    if r["ulps"] > ROUNDED_ULPS or r["norm_ratio"] > ROUNDED_NORM_RATIO:
        raise AssertionError(f"{name}: against the plain version that rounds what the "
                             f"tensor cores round, {r['ulps']:.2f} bf16 ulps (limit "
                             f"{ROUNDED_ULPS}) and {r['norm_ratio']:.3f} times the "
                             f"bf16 rounding of its result (limit {ROUNDED_NORM_RATIO})")
    return r
