"""The AdamW update over many tensors: the plain version against the
optimizer's former per-tensor expression, the wrapper's checks, the work
table's chunks, the routing between the CUDA kernel and the plain version,
and on the card the kernel against the plain version bit for bit, its
norm, its repeatability, and its launches in a training step.  Imports
only torch and the port, so it runs where JAX is not installed:
PYTHONPATH=src python -m pytest -q tests/test_torch_adamw.py
(the ``cuda``-marked tests skip without a card)."""

import re

import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

from repro_torch.kernels import adamw as tadam  # noqa: E402
from repro_torch.kernels.adamw import ops as adam_ops  # noqa: E402
from repro_torch.train import optim  # noqa: E402
from repro_torch.train.optim import OptConfig, init_opt_state, lr_schedule  # noqa: E402

F32, BF16 = torch.float32, torch.bfloat16

#: (name, shape, parameter dtype, gradient dtype, decays): bf16 matrices
#: and float32 vectors, decayed and not, float32 gradients of bf16
#: parameters (as ``accum_steps`` > 1 gives them), and lengths 1, 7 and 4097
MIXED = [("w_in", (48, 40), BF16, BF16, True),
         ("table", (7, 33), BF16, BF16, False),
         ("a_log", (24,), F32, F32, True),
         ("norm", (40,), F32, F32, False),
         ("one", (1,), BF16, BF16, True),
         ("seven", (7,), F32, F32, False),
         ("w_out", (4097,), BF16, F32, True),
         ("bias", (4097,), F32, F32, True)]


def _former(cfg, grads, state, params, ndims=None):
    """``adamw_update`` as ``train/optim.py`` wrote it before the kernel."""
    gnorm = optim.global_norm(grads[k] for k in params)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    count = state.count + 1
    lr = lr_schedule(cfg, count)
    b1c = 1 - cfg.b1 ** count.float()
    b2c = 1 - cfg.b2 ** count.float()
    for k, p in params.items():
        g = grads[k].float() * scale
        m, v = state.mu[k], state.nu[k]
        m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
        v.copy_(cfg.b2 * v + (1 - cfg.b2) * torch.square(g))
        step = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        if (p.ndim if ndims is None else ndims[k]) >= 2:
            step = step + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * step)
    return params, optim.OptState(state.mu, state.nu, count), {"grad_norm": gnorm, "lr": lr}


def _problem(spec, device="cpu", seed=0, big=None):
    """Parameters, gradients of their dtypes and ``ndims`` (decay where 2)
    for ``spec``; ``big`` adds one bf16 tensor of that many elements."""
    spec = list(spec) + ([("big", (big,), BF16, BF16, True)] if big else [])
    g = torch.Generator(device=device).manual_seed(seed)
    params, grads, ndims = {}, {}, {}
    for name, shape, pdt, gdt, decays in spec:
        params[name] = (0.5 * torch.randn(shape, generator=g, device=device)).to(pdt)
        # gradients of very different scales across tensors
        grads[name] = (torch.randn(shape, generator=g, device=device)
                       * float(torch.rand((), generator=g, device=device)) ** 3).to(gdt)
        ndims[name] = 2 if decays else 1
    return params, grads, ndims


def _clone(params, state):
    return ({k: p.clone() for k, p in params.items()},
            optim.OptState({k: m.clone() for k, m in state.mu.items()},
                           {k: v.clone() for k, v in state.nu.items()}, state.count.clone()))


# ---------------------------------------------------------------------------
# on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("clip", [1e9, 1e-2], ids=["clip_off", "clip_on"])
def test_plain_update_is_the_former_expression(clip):
    """Three steps on the CPU: bit for bit the former per-tensor code."""
    cfg = OptConfig(lr=1e-2, warmup_steps=2, total_steps=10, clip_norm=clip)
    params, _, ndims = _problem(MIXED, seed=1)
    state = init_opt_state(params)
    p2, s2 = _clone(params, state)
    for step in range(3):
        _, grads, _ = _problem(MIXED, seed=10 + step)
        _, state, met = optim.adamw_update(cfg, grads, state, params, ndims)
        _, s2, met2 = _former(cfg, grads, s2, p2, ndims)
        assert torch.equal(met["grad_norm"], met2["grad_norm"])
        assert torch.equal(met["lr"], met2["lr"])
        for k in params:
            for got, want in ((params[k], p2[k]), (state.mu[k], s2.mu[k]),
                              (state.nu[k], s2.nu[k])):
                assert torch.equal(got, want), k


def _fake_kernel(calls):
    """The kernel's call on the CPU: the norm by ``global_norm``, each tensor
    by the plain version, the operands recorded."""
    def kernel(entries, cfg, lr, b1c, b2c, sum_shards=None):
        calls.append([(g.is_contiguous(), g.dtype, p.dtype, decay)
                      for g, p, m, v, decay in entries])
        for g, p, m, v, _ in entries:
            tadam.check_operands(g, p, m, v)
        gnorm = optim.global_norm(g for g, *_ in entries)
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
        for g, p, m, v, decay in entries:
            tadam.ref.adamw_tensor(cfg, p, g, m, v, scale, lr, b1c, b2c, decay)
        return gnorm
    return kernel


def test_card_route_hands_every_tensor_to_the_kernel(monkeypatch):
    """On the card route (the CPU standing in, the kernel faked by the plain
    version) every tensor reaches the one kernel call, its decay flag from
    ``ndims``, a strided gradient made dense; the result is the plain
    route's bit for bit."""
    calls = []
    monkeypatch.setattr(tadam, "build_kernel", lambda: _fake_kernel(calls))
    cfg = OptConfig(lr=1e-2, warmup_steps=2, clip_norm=1e-2)
    params, grads, ndims = _problem(MIXED, seed=2)
    grads["w_in"] = grads["w_in"].t().contiguous().t()        # a transposed layout
    state = init_opt_state(params)
    p2, s2 = _clone(params, state)
    _, s2, met2 = optim.adamw_update(cfg, grads, s2, p2, ndims)
    assert calls == []
    monkeypatch.setattr(optim, "PLAIN_DEVICES", ("meta",))
    _, state, met = optim.adamw_update(cfg, grads, state, params, ndims)
    assert calls == [[(True, grads[k].dtype, params[k].dtype, d)
                      for k, (_, _, _, _, d) in zip(params, MIXED)]]
    assert torch.equal(met["grad_norm"], met2["grad_norm"])
    for k in params:
        assert torch.equal(params[k], p2[k]) and torch.equal(state.mu[k], s2.mu[k]), k


def test_meta_takes_the_plain_update(monkeypatch):
    monkeypatch.setattr(tadam, "build_kernel", lambda: pytest.fail("kernel built on meta"))
    params, grads, ndims = _problem(MIXED[:3])
    params = {k: p.to("meta") for k, p in params.items()}
    grads = {k: g.to("meta") for k, g in grads.items()}
    _, state, met = optim.adamw_update(OptConfig(), grads, init_opt_state(params), params, ndims)
    assert met["grad_norm"].device.type == "meta" and int(state.count.numel()) == 1


#: one fault each: the error it raises and its message
BAD = {"grad_dtype": (TypeError, "float32 or bfloat16"),
       "param_dtype": (TypeError, "float32 or bfloat16"),
       "moment_dtype": (TypeError, "moments: expected float32"),
       "device": (ValueError, "expected one device"),
       "shape": (ValueError, "do not agree"),
       "grad_strided": (ValueError, "g: expected a contiguous"),
       "param_strided": (ValueError, "p: expected a contiguous")}


def _bad_operands(case):
    g, p = torch.zeros(8, 4, dtype=BF16), torch.zeros(8, 4, dtype=BF16)
    m, v = torch.zeros(8, 4), torch.zeros(8, 4)
    if case == "grad_dtype":
        g = g.half()
    if case == "param_dtype":
        p = p.double()
    if case == "moment_dtype":
        v = v.to(BF16)
    if case == "device":
        m = m.to("meta")
    if case == "shape":
        g = g.reshape(4, 8)
    if case == "grad_strided":
        g = torch.zeros(4, 8, dtype=BF16).t()
    if case == "param_strided":
        p = torch.zeros(8, 8, dtype=BF16)[:, :4]
    return g, p, m, v


@pytest.mark.parametrize("case", sorted(BAD))
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    """Each check raises on the CPU, before any device is needed."""
    error, match = BAD[case]
    with pytest.raises(error, match=match):
        tadam.check_operands(*_bad_operands(case))


@pytest.mark.parametrize("gdt", [F32, BF16])
@pytest.mark.parametrize("pdt", [F32, BF16])
def test_wrapper_takes_every_dtype_pair(gdt, pdt):
    tadam.check_operands(torch.zeros(3, 5, dtype=gdt), torch.zeros(3, 5, dtype=pdt),
                         torch.zeros(3, 5), torch.zeros(3, 5))


def test_work_table_chunks_each_tensor_in_order():
    """ceil(n / CHUNK) chunks a tensor, in order; an empty tensor owns none
    and shares its first chunk with the next."""
    C = tadam.ops.CHUNK
    entries = [(torch.zeros(n), torch.zeros(n), torch.zeros(n), torch.zeros(n), False)
               for n in (1, 7, C, C + 1, 0, 3 * C, 4097)]
    rows, chunks = tadam.work_table(entries)
    assert [r[5] for r in rows] == [0, 1, 2, 3, 5, 5, 8] and chunks == 9
    assert [r[4] for r in rows] == [1, 7, C, C + 1, 0, 3 * C, 4097]
    assert tadam.work_table([]) == ([], 0)


def test_work_table_checks_every_tensor():
    g, p, m, v = _bad_operands("shape")
    ok = tuple(torch.zeros(8, 4) for _ in range(4))
    with pytest.raises(ValueError, match="do not agree"):
        tadam.work_table([(*ok, True), (g, p, m, v, True)])


def test_work_table_rows():
    """A row a tensor: the four pointers, the length, the first chunk and
    the flags (gradient bf16, parameter bf16, decay)."""
    params, grads, _ = _problem(MIXED, seed=3)
    state = init_opt_state(params)
    entries = [(grads[k], params[k], state.mu[k], state.nu[k], d)
               for k, (_, _, _, _, d) in zip(params, MIXED)]
    rows, chunks = tadam.work_table(entries)
    assert chunks == len(MIXED) and len(rows) == len(MIXED)
    for i, ((g, p, m, v, d), row) in enumerate(zip(entries, rows)):
        flags = ((g.dtype == BF16) * tadam.ops.GRAD_BF16 + (p.dtype == BF16) * tadam.ops.PARAM_BF16
                 + d * tadam.ops.DECAY)
        assert row == [g.data_ptr(), p.data_ptr(), m.data_ptr(), v.data_ptr(), p.numel(),
                       i, flags, 0]
        assert len(row) == tadam.ops.FIELDS


def test_kernel_constants_match_the_source():
    src = adam_ops.SOURCE.read_text()
    assert int(re.search(r"kChunk = (\d+);", src).group(1)) == adam_ops.CHUNK
    assert int(re.search(r"kThreads = (\d+);", src).group(1)) == adam_ops.THREADS
    assert int(re.search(r"kFields = (\d+);", src).group(1)) == adam_ops.FIELDS
    flags = dict(re.findall(r"k(GradBf16|ParamBf16|Decay) = (\d+)", src))
    assert (int(flags["GradBf16"]), int(flags["ParamBf16"]), int(flags["Decay"])) == (
        adam_ops.GRAD_BF16, adam_ops.PARAM_BF16, adam_ops.DECAY)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    tadam.build_kernel()
    return "cuda"


def _misaligned(params, grads, state):
    """One bf16 tensor whose four bases sit 2 bytes past a 16-byte boundary
    (the kernel's scalar path)."""
    n = 4099
    bufs = [torch.zeros(n + 1, dtype=dt, device="cuda") for dt in (BF16, BF16, F32, F32)]
    g, p, m, v = (b[1:] for b in bufs)
    g.normal_()
    p.normal_()
    params["odd"], grads["odd"], state.mu["odd"], state.nu["odd"] = p, g, m, v


@pytest.mark.cuda
@pytest.mark.parametrize("clip", [1e9, 1e-2], ids=["clip_off", "clip_on"])
def test_kernel_matches_plain_bit_for_bit(card, clip):
    """Three steps over the mixed set, one tensor of 2^25 elements and one
    misaligned: the kernel's m, v and p equal the plain version's on the
    card given the same clip scale, bit for bit; its norm is within 1e-6 of
    a float64 sum; the update makes no host sync."""
    cfg = OptConfig(lr=1e-2, warmup_steps=3, total_steps=10, clip_norm=clip)
    params, _, ndims = _problem(MIXED, device="cuda", seed=4, big=2 ** 25)
    state = init_opt_state(params)
    ndims["odd"] = 2
    for step in range(3):
        _, grads, _ = _problem(MIXED, device="cuda", seed=20 + step, big=2 ** 25)
        if step == 0:
            _misaligned(params, grads, state)
        else:
            grads["odd"] = torch.randn_like(params["odd"])
        assert params["odd"].data_ptr() % 16 == 2
        before, s0 = _clone(params, state)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            _, state, met = optim.adamw_update(cfg, grads, state, params, ndims)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        gnorm = met["grad_norm"]
        want = sum(float(torch.sum(g.double() ** 2)) for g in grads.values()) ** 0.5
        assert abs(float(gnorm) - want) <= 1e-6 * want
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
        assert (float(scale) < 1) == (clip < 1)
        count = s0.count + 1
        assert torch.equal(met["lr"], lr_schedule(cfg, count))
        b1c, b2c = 1 - cfg.b1 ** count.float(), 1 - cfg.b2 ** count.float()
        for k in params:
            tadam.ref.adamw_tensor(cfg, before[k], grads[k], s0.mu[k], s0.nu[k], scale,
                                   met["lr"], b1c, b2c, ndims[k] >= 2)
            for name, got, ref in (("p", params[k], before[k]), ("m", state.mu[k], s0.mu[k]),
                                   ("v", state.nu[k], s0.nu[k])):
                assert torch.equal(got, ref), (step, k, name)


@pytest.mark.cuda
def test_kernel_repeats_bit_for_bit(card):
    """Two runs of two steps from the same state: the same norm and the same
    p, m and v, bit for bit (no float atomics)."""
    cfg = OptConfig(lr=1e-2, warmup_steps=3, clip_norm=1e-2)
    params, _, ndims = _problem(MIXED, device="cuda", seed=5, big=3 * 2 ** 20 + 5)
    state = init_opt_state(params)
    grads = [_problem(MIXED, device="cuda", seed=30 + i, big=3 * 2 ** 20 + 5)[1]
             for i in range(2)]
    runs = []
    for _ in range(2):
        p, s = _clone(params, state)
        norms = []
        for g in grads:
            _, s, met = optim.adamw_update(cfg, g, s, p, ndims)
            norms.append(met["grad_norm"].clone())
        runs.append((norms, p, s))
    (n0, p0, s0), (n1, p1, s1) = runs
    assert all(torch.equal(a, b) for a, b in zip(n0, n1))
    for k in params:
        assert torch.equal(p0[k], p1[k]) and torch.equal(s0.mu[k], s1.mu[k]) \
            and torch.equal(s0.nu[k], s1.nu[k]), k


@pytest.mark.cuda
def test_training_step_launches_the_kernel(card):
    """One training step of the reduced Mamba-2 on the card: the update is
    the kernel's three launches (``adamw.kernel`` counted as many times),
    and the device kernels inside one ``adamw_update`` call, the schedule's
    and the bias corrections' 0-dim operations included, number at most 25
    (the table's one copy to the card apart)."""
    from torch.autograd import DeviceType

    from repro_torch import tracing
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import build_model
    from repro_torch.train import step as tstep

    cfg = reduced(get_config("mamba2-1.3b"))
    model = build_model(cfg, device="cuda")
    params = dict(model.named_parameters())
    train_step = tstep.make_train_step(model, OptConfig())
    state = init_opt_state(params)
    tokens = torch.randint(0, cfg.vocab, (2, 65), device="cuda")
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    state, _ = train_step(state, batch)               # warm: build, cuBLAS, kernels
    real, seen = tstep.adamw_update, []

    def traced_update(*args, **kwargs):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            out = real(*args, **kwargs)
            torch.cuda.synchronize()
        seen.extend(e.name for e in prof.events()
                    if e.device_type == DeviceType.CUDA and not e.name.startswith("Memcpy"))
        return out

    tstep.adamw_update = traced_update
    try:
        # the profiler's device tracing has come back empty on a card whose
        # kernels ran (chip_smoke.traced): up to three steps
        for _ in range(3):
            seen.clear()
            tadam.reset_launch_counts()
            before = tracing.counters().get("adamw.kernel", {"count": 0})["count"]
            state, metrics = train_step(state, batch)
            if seen:
                break
    finally:
        tstep.adamw_update = real
    assert tadam.launch_counts() == {"adamw": 3}
    assert tracing.counters()["adamw.kernel"]["count"] - before == 3
    assert sum("adamw::" in n for n in seen) == 3, seen
    assert len(seen) <= 25, seen
    assert torch.isfinite(metrics["grad_norm"]) and float(metrics["grad_norm"]) > 0
    print(f"[adamw] {len(params)} tensors: {len(seen)} device kernels in one update")
