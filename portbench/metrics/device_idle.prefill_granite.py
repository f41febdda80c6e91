"""``device_idle.prefill_granite``: the device's idle share of the untraced
window, in %, derived from the trace's busy time for each prompt length's
batch and the window's host time (``Readings.idle``)."""


def read(r):
    return r.idle() if r.kind == "prefill_granite" else None
