"""``plain_bwd_launches.train``: calls that enqueue device work a training
step, made inside the program's ``PlainGrad.backward``: the host events of
the trace named ``cudaLaunchKernel``, ``cudaLaunchKernelExC``,
``cuLaunchKernel``, ``cuLaunchKernelEx``, ``cudaMemcpyAsync`` or
``cudaMemsetAsync`` that start inside a ``repro::autograd.backward`` host
range, over the trace's ``repro::train.step`` ranges.  A count, the same in
every run of one program at one shape.  Nothing where the program has no
such ranges."""

import bisect

from portbench.trace import _union

LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
            "cudaMemcpyAsync", "cudaMemsetAsync")
BACKWARD, STEP = "repro::autograd.backward", "repro::train.step"


def launches_inside(host, name: str = BACKWARD) -> int:
    """The :data:`LAUNCHES` among ``host`` ((start, end, name), sorted)
    that start inside the union of the ranges called ``name``."""
    ranges = _union([(a, b) for a, b, n in host if n == name])
    starts = [a for a, _ in ranges]
    n = 0
    for a, _, e in host:
        if e in LAUNCHES:
            i = bisect.bisect_right(starts, a) - 1
            n += i >= 0 and a <= ranges[i][1]
    return n


def read(r):
    if r.kind != "train":
        return None
    steps = sum(n == STEP for _, _, n in r.trace.host)
    if not steps or not any(n == BACKWARD for _, _, n in r.trace.host):
        return None
    total = launches_inside(r.trace.host)
    return total // steps if total % steps == 0 else total / steps
