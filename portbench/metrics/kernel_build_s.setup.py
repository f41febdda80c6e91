"""``kernel_build_s.setup``: the seconds the process spent in set-up
loading its kernels and deriving their schedules: the program's counters
(``repro_torch.tracing``) of library loads from ``build/``
(``build.disk``) and the conv1d schedule's detection by the emulator
(``kernels.synthesize``).  ``nvcc`` builds (``build.nvcc``) are left out:
only a checkout's first run makes them, so the reading is the same
whether the checkout was built before or not (a library built in the
run is loaded from ``build/`` too).
Nothing where the program has no such counters."""

COUNTERS = ("build.disk", "kernels.synthesize")


def read(r):
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    c = tracing.counters()
    if not any(n in c for n in COUNTERS):
        return None
    return sum(c[n]["seconds"] for n in COUNTERS if n in c)
