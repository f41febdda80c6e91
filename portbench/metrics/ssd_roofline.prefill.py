"""``ssd_roofline.prefill``: the SSD kernel's calls' bound (``rooflines.ssd_bound_s``) over
the device time of the operations inside its call sites' spans, in %."""

from portbench import rooflines


def read(r):
    if r.kind != "prefill":
        return None
    return r.roofline("ssd", lambda m: rooflines.ssd_bound_s(m["B"], m["L"], m["H"], m["P"], m["N"],
                                          m["chunk"], m["dtype"]))
