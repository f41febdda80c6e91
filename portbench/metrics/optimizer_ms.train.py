"""``optimizer_ms.train``: device milliseconds a step of the operations
inside the spans of ``train.step.adamw_update``."""


def read(r):
    n, seconds = r.trace.in_site("adamw")
    if r.kind != "train" or not n:
        return None
    return 1e3 * seconds / r.traced["train_steps"]
