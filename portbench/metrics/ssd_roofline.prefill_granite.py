"""``ssd_roofline.prefill_granite``: the SSD calls' bound
(``rooflines.ssd_bound_s``, one B/C group) over the device time of the
operations inside the ``portbench::ssd`` ranges, in %."""

from portbench import rooflines


def read(r):
    if r.kind != "prefill_granite":
        return None
    return r.roofline("ssd", lambda m: rooflines.ssd_bound_s(m["B"], m["L"], m["H"], m["P"], m["N"],
                                          m["chunk"], m["dtype"]))
