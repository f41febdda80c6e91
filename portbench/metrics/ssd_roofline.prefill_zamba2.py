"""``ssd_roofline.prefill_zamba2``: the grouped SSD calls' bound
(``zamba2.ssd_bound_s``, with the configuration's B/C groups) over the
device time of the operations inside the ``portbench::ssd`` ranges, in %."""

from portbench import zamba2


def read(r):
    if r.kind != "prefill_zamba2":
        return None
    return r.roofline("ssd", lambda m: zamba2.ssd_bound_s(m, r.cfg["ssm_groups"]))
