"""``conv1d_roofline.prefill``: the conv1d kernel's calls' bound
(``rooflines.conv1d_bound_s``) over the device time of the operations inside
its call sites' spans, in %."""

from portbench import rooflines


def read(r):
    if r.kind != "prefill":
        return None
    return r.roofline("conv1d", lambda m: rooflines.conv1d_bound_s(m["B"], m["L"], m["C"], m["W"],
                                             m["dtype"]))
