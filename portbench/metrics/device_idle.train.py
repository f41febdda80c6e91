"""``device_idle.train``: the device's idle share of the untraced window,
in %, derived from the trace's busy time for a training step and the
window's host time (``Readings.idle``)."""


def read(r):
    return r.idle() if r.kind == "train" else None
