"""Mirrors ``src/repro/core/egraph/verify.py`` (only the imports differ).

Differential soundness gate for extracted rewrites.

Equality saturation is only as trustworthy as its weakest rule, so no
rewritten kernel replaces the original on symbolic reasoning alone:
``differential_check`` runs both kernels through the *concrete* warp
emulator (``emulator/concrete.py``) on sampled grid shapes and random
inputs and demands **bitwise-identical** output buffers.  The rewrite
set is integer-exact and float-CSE-only, so bitwise equality is the
right bar — any drift means a rule or the extractor miscompiled, and
the caller drops the rewrite (keeping the original kernel) and reports
a WARNING diagnostic instead.

Parameter synthesis follows the frontends' conventions: ``u64`` params
are float32 buffers (sized past every in-bounds index the sampled dims
can produce, plus slack), ``u32`` params named ``n0``/``n1``/… are the
grid dims, other ``u32`` params get a small constant, and ``f32``
scalars are passed as raw bits (the emulator reads them via
``ld.param.f32``).  Any emulator fault — wild address, fuel
exhaustion, unsupported opcode — is treated as a failed check:
when we cannot *prove* equivalence we do not rewrite.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..emulator.concrete import f32_bits, run_concrete
from ..ptx.ir import Kernel

# (dims for n0/n1/n2…, nctaid): one shape with masked tail threads and a
# multi-CTA sweep, one deliberately misaligned smaller shape
SAMPLE_CONFIGS: Tuple[Tuple[Tuple[int, ...], Tuple[int, int, int]], ...] = (
    ((40, 8, 5), (2, 1, 1)),
    ((33, 5, 4), (1, 1, 1)),
)
_NTID = (32, 1, 1)


def _make_params(kernel: Kernel, dims: Tuple[int, ...],
                 seed: int) -> Dict[str, object]:
    """Fresh, deterministic params for one run of ``kernel``."""
    rng = np.random.RandomState(seed)
    size = 1
    for d in dims:
        size *= d + 16        # halo/offset slack in every dimension
    size += 1024
    params: Dict[str, object] = {}
    scalar_idx = 0

    def synth(name: str, ptype: str) -> object:
        nonlocal scalar_idx
        if ptype == "u64":
            return rng.uniform(-4.0, 4.0, size).astype(np.float32)
        if ptype == "f32":
            scalar_idx += 1
            return f32_bits(1.5 + 0.25 * (scalar_idx - 1))
        if name.startswith("n") and name[1:].isdigit():
            d = int(name[1:])
            return dims[d] if d < len(dims) else 1
        return 7

    for name, ptype in kernel.params:
        params[name] = synth(name, ptype)
    return params


def _declare_loaded_params(kernel: Kernel) -> Kernel:
    """Some frontends emit ``ld.param`` reads of names missing from the
    declared param list (the symbolic emulator shrugs; the concrete one
    only registers *declared* params and KeyErrors).  Return a shallow
    copy whose param list also declares those, typed by the load
    suffix, so ``_make_params`` synthesizes values for them."""
    declared = {name for name, _t in kernel.params}
    extra: List[Tuple[str, str]] = []
    for stmt in kernel.body:
        opcode = getattr(stmt, "opcode", "")
        if not opcode.startswith("ld.param"):
            continue
        for op in stmt.operands:
            base = getattr(op, "base", None)
            if base is not None and base not in declared:
                declared.add(base)
                extra.append((base, opcode.rsplit(".", 1)[-1]))
    if not extra:
        return kernel
    aug = copy.copy(kernel)
    aug.params = list(kernel.params) + extra
    return aug


def differential_check(original: Kernel, rewritten: Kernel,
                       configs=SAMPLE_CONFIGS) -> Optional[str]:
    """Run both kernels on identical inputs; ``None`` when equivalent,
    else a short human-readable reason for the mismatch/fault."""
    original = _declare_loaded_params(original)
    rewritten = _declare_loaded_params(rewritten)
    for ci, (dims, nctaid) in enumerate(configs):
        pa = _make_params(original, dims, seed=0xC0FE + ci)
        pb = _make_params(rewritten, dims, seed=0xC0FE + ci)
        try:
            run_concrete(original, pa, ntid=_NTID, nctaid=nctaid)
            run_concrete(rewritten, pb, ntid=_NTID, nctaid=nctaid)
        except Exception as exc:  # wild address / fuel / unsupported op
            return f"concrete run failed on config {ci}: {exc}"
        for name, va in pa.items():
            if not isinstance(va, np.ndarray):
                continue
            vb = pb[name]
            if not np.array_equal(va.view(np.uint32), vb.view(np.uint32)):
                bad = int(np.flatnonzero(
                    va.view(np.uint32) != vb.view(np.uint32))[0])
                return (f"buffer {name!r} diverges at element {bad} "
                        f"on config {ci}")
    return None
