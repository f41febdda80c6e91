"""``moe_roofline.prefill_granite``: the feed-forward calls' bound
(``granite.moe_bound_s``: the routed pairs', the shared expert's and the
router's products, or the weights of the experts that received rows, x
and y moved once) over the device time of the operations inside the
``portbench::moe`` ranges around ``repro_torch.models.granite_hybrid.moe_ffn``,
in %."""

from portbench import granite


def read(r):
    calls = r.traced.get("moe") if r.kind == "prefill_granite" else None
    if not calls:
        return None
    n, seconds = r.trace.in_site("moe")
    if not n:
        return None
    return 100.0 * sum(granite.moe_bound_s(m) for m in calls) / seconds
