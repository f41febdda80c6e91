"""``ssd_bwd_roofline.train``: the SSD gradient's bound
(``rooflines.ssd_bwd_bound_s``) summed over the traced steps' calls, over
the device time between each call's backward marks (from dy's arrival to
the inputs' gradients), in %."""

from portbench import rooflines


def read(r):
    marks = [m for m in r.calls.marks if m.start is not None and m.end is not None]
    if r.kind != "train" or not marks:
        return None
    seconds = sum(m.start.elapsed_time(m.end) for m in marks) / 1e3
    bound = sum(rooflines.ssd_bwd_bound_s(m.meta["B"], m.meta["L"], m.meta["H"], m.meta["P"],
                                          m.meta["N"], m.meta["chunk"], m.meta["dtype"])
                for m in marks)
    return 100.0 * bound / seconds
