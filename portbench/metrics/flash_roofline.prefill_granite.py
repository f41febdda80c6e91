"""``flash_roofline.prefill_granite``: the flash calls' bound
(``granite.flash_bound_s``: q and o at H heads, k and v at KV heads, moved
once; the causal products) over the device time of the operations inside
the ``portbench::flash`` ranges around
``repro_torch.models.attention.flash_attention``, in %."""

from portbench import granite


def read(r):
    calls = r.traced.get("flash") if r.kind == "prefill_granite" else None
    if not calls:
        return None
    n, seconds = r.trace.in_site("flash")
    if not n:
        return None
    return 100.0 * sum(granite.flash_bound_s(m) for m in calls) / seconds
