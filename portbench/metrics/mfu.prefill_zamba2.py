"""``mfu.prefill_zamba2``: the window's prefills' model FLOPs
(``zamba2.prefill_flops``) over the window's wall time at the bf16 peak, in %."""


def read(r):
    return r.mfu() if r.kind == "prefill_zamba2" else None
