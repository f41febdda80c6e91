"""``mfu.train``: the window's steps' model FLOPs (``flops.train_flops``, no
recompute) over the window's wall time at the bf16 peak, in %."""


def read(r):
    return r.mfu() if r.kind == "train" else None
