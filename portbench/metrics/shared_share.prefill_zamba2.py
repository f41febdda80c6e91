"""``shared_share.prefill_zamba2``: the device time of the operations inside
the ``portbench::shared`` ranges around ``repro_torch.models.zamba2.shared``
(each application of a shared block, its flash call and MLP included) over
the traced deck's busy time, in %."""


def read(r):
    if r.kind != "prefill_zamba2" or not r.traced.get("shared"):
        return None
    n, seconds = r.trace.in_site("shared")
    return 100.0 * seconds / r.trace.busy_s if n else None
