"""``conv1d_roofline.prefill_zamba2``: ``conv1d_roofline.prefill`` in the
Zamba2 cell, over its mixers' conv1d calls at 7,424 channels: the calls'
bound (``rooflines.conv1d_bound_s``) over the device time of the
operations inside the ``portbench::conv1d`` ranges, in %."""

from portbench import rooflines


def read(r):
    if r.kind != "prefill_zamba2":
        return None
    return r.roofline("conv1d", lambda m: rooflines.conv1d_bound_s(m["B"], m["L"], m["C"], m["W"],
                                             m["dtype"]))
