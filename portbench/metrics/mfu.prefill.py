"""``mfu.prefill``: the window's prefills' model FLOPs (``flops.prefill_flops``) over
the window's wall time at the bf16 peak, in %."""


def read(r):
    return r.mfu() if r.kind == "prefill" else None
