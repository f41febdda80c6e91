"""``flash_roofline.prefill_zamba2``: the flash calls' bound
(``zamba2.flash_bound_s``: q, k, v and o moved once, the causal products)
over the device time of the operations inside the ``portbench::flash``
ranges around ``repro_torch.models.zamba2.flash_attention``, in %."""

from portbench import zamba2


def read(r):
    calls = r.traced.get("flash") if r.kind == "prefill_zamba2" else None
    if not calls:
        return None
    n, seconds = r.trace.in_site("flash")
    if not n:
        return None
    return 100.0 * sum(zamba2.flash_bound_s(m) for m in calls) / seconds
