"""``moe_share.prefill_granite``: the device time of the operations inside
the ``portbench::moe`` ranges around ``repro_torch.models.granite_hybrid.moe_ffn``
(each layer's router, routed experts and shared expert) over the traced
deck's busy time, in %."""


def read(r):
    if r.kind != "prefill_granite" or not r.traced.get("moe"):
        return None
    n, seconds = r.trace.in_site("moe")
    return 100.0 * seconds / r.trace.busy_s if n else None
