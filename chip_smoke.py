#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Phases, each fatal on failure:

1. toolchain: torch, CUDA, device capability, nvcc, card and power limit;
2. build: every (KernelGen stencil bench, mode) kernel, one nvcc call per
   bench, and, at the same time, the conv1d kernels (naive / shuffle, widths 3
   and 4, float32 and bfloat16), the SSD kernels (the bf16 tensor-core
   instance's three passes and the CUDA-core instance) and the
   flash-attention kernels (the bf16 tensor-core instance at Dh 16-128,
   the CUDA-core one at Dh 8-128 in float32 and bfloat16) and the mixer's
   tail kernel (``gated_norm``), each source in an nvcc call of its own; then ``SHFL``/``LDG``/``HGMMA``/``HMMA``
   instructions counted per kernel in the built SASS (``HGMMA`` in every
   tensor-core instance, in no CUDA-core one), and per stencil and conv1d
   kernel its registers and its SASS by class (integer, float, shared
   memory, barriers) per output (per output vector for conv1d).  Each
   bench's ``paper`` plan and each conv1d ``shuffle`` build analyses its
   lowered PTX through ``synthesize_cuda`` and so through the default
   ``Compiler`` session (``Compiler.analyze``, memory cache shared with
   phases 3-4);
3. parity: per stencil bench, the shuffle plan (emulator detection vs
   schedule) and each mode's kernel against the plain PyTorch version at
   a ragged medium shape and at shapes ragged along the march (1, R - 1,
   R + 1 outputs) and along i (31, 33, 77 lanes), the three modes bitwise
   equal; conv1d (both
   modes, bitwise equal; L ragged against the march, x a column range of
   a wider tensor at an aligned and at odd strides) and SSD (y and final
   state; chunk 8 vs 64, and
   the tensor-core instance's chunk 64 vs 256 in bf16) against their
   plain versions at ragged shapes; flash attention against its plain
   version at the reference test's five shapes, Sq > a ragged Sk, GQA
   with Dh 128, ragged Sq and Sk at Dh 64 and 128 and the serving shape,
   float32 and bfloat16; each record names the instance that ran;
4. the stencil main path at the paper's sizes (Jacobi 32768x32768,
   tricubic 512x1024x1024): DSL program -> PTX -> symbolic emulation ->
   shuffle detection -> ``stencil_apply`` in every mode, with launch
   counts read around it; then each kernel timed with CUDA events against
   its bound, the plain version, a copy of the same bytes and ``conv2d``
   (Jacobi) or ``conv3d`` of the separable weights plus u + v + s
   (tricubic).  After this phase the default session's cache counts are
   printed: 15 misses, one per distinct lowered kernel phases 2-4 analyse
   (the 13 benches' paper plans, the conv1d programs of widths 3 and 4),
   memory hits for every later analysis, no disk tier; after phase 11 the
   misses are still 15;
5. the serving path: mamba2-1.3b at its published widths (bf16, random
   weights from a seed) serves 4 requests x 1024-token prompts x 32
   greedy tokens through ``repro_torch.launch.serve``, with launch counts
   read around the run (48 conv1d ``shuffle``, 48 SSD and 48 tail
   (``gated_norm``) launches per prefill, every SSD call on the
   tensor-core instance); layer 0's conv1d
   and SSD inputs are captured on that run (the conv's is required to be
   the in-projection's column view the model passes), each kernel (conv1d
   in both modes, bitwise equal) is held against its plain version on them
   and timed beside its bound, the plain version and (conv1d)
   ``F.conv1d(groups=C)`` + SiLU and a copy of the same bytes, and the
   SSD's CUDA kernels timed one by
   one from a ``torch.profiler`` trace; one more warm prefill is traced
   and its device time split by kernel family (SSD, flash attention,
   conv1d, cat, matmul, other) beside its wall time; the reduced model on the card against
   the plain path on the CPU; and a float32 continuity check at full
   width (prefill 512 == prefill 256 + 256 decode steps);
6. the hybrid serving path, the same way: zamba2-1.2b at its published
   widths serves the same traffic (per prefill 6 flash-attention, 38
   conv1d ``shuffle``, 38 SSD and 38 tail launches, every flash-attention and SSD
   call on its tensor-core instance); the inputs of the first
   shared-attention call and of layer 0's conv1d and SSD are captured,
   held against the plain versions and timed (flash attention beside
   ``scaled_dot_product_attention``); the reduced 5-layer model (two
   supercells and a trailing block) on the card against the CPU; f32
   continuity at full width;
7. the dense serving path, the same way: olmo-1b (16 layers, MHA 16/16)
   and then yi-9b (48 layers, GQA 32/4), both at Dh 128 and published
   widths, serve the same traffic (per prefill one flash-attention launch
   per layer, all on the tensor-core instance, and no conv1d or SSD
   launch); the first flash-attention call's inputs are captured, held
   against the plain version and timed beside ``scaled_dot_product_attention``;
   the reduced model on the card against the CPU (logits, greedy tokens
   and the loss), also for starcoder2-3b, which runs reduced only; f32
   continuity at full width for olmo-1b; then the MoE and enc-dec paths
   the same way: granite-moe-1b-a400m (24 layers, GQA 16/8 at Dh 64, 32
   experts top-8 by the dropless dispatch; 24 flash launches per prefill,
   its traced prefill with a ``moe`` share for the dispatch, f32
   continuity) and seamless-m4t-large-v2 (24 encoder layers, non-causal
   over 1024 seeded frames, and 24 decoder layers with cross attention;
   48 flash launches per prefill, none per decode step; its first
   encoder and first decoder call held and timed); kimi-k2-1t-a32b and
   llama-3.2-vision-90b (gates set non-zero) reduced only, card vs CPU;
7b. Zamba2-7B-Instruct (``zamba2-7b``) at its published widths: one
   prefill of 8 x 4096 tokens, the benchmark cell's largest batch,
   through ``serve.step.generate``, launch counts zeroed just before it
   (81 conv1d ``shuffle``, 81 SSD, 13 flash-attention and 81 tail
   launches, every SSD and flash call on its tensor-core instance); the
   first conv1d, SSD (two B/C groups), flash call (Dh 224, scale
   (Dh / 2)^-1/2) and tail (two groups) of that prefill held against the
   plain versions and timed beside their bounds;
7c. the mixer's tail at Mamba-2's 8 x 4096 prefill (the
   mamba2-1.3b.prefill-pool cell's largest batch): launch counts zeroed
   before one prefill (48 conv1d, 48 SSD, 48 tail kernels), its first tail call held against the plain tail (bit
   for bit but in row-groups whose statistic sits at a bf16 rounding
   tie, ``ref.compare_bf16``; the share of bit-identical elements
   printed) and
   timed beside its bound (8 bytes a channel) and the plain tail;
7d. AdamW alone over mamba2-1.3b's whole parameter set at its published
   widths (1.34 B parameters, bf16 weights and gradients, float32
   moments): one update through ``train.optim.adamw_update`` (the
   multi-tensor kernel, three launches) held bit for bit against the
   plain per-tensor update on the card given the kernel's clip scale, its
   norm against a float64 sum; then the update timed beside its bound (22
   bytes a parameter) and the plain update, its device kernels split from
   a trace, and the host's time to enqueue it;
8. the training path: one train step of the reduced olmo-1b, mamba2-1.3b,
   zamba2-1.2b, granite-moe-1b-a400m, seamless-m4t-large-v2 and
   llama-3.2-vision-90b in float32 on the card (every kernel through its
   autograd Function, blocks recomputed) against the CPU (gradients, loss,
   gradient norm, parameters after AdamW); the reduced olmo-1b's loss
   falling over 40 steps on the card; a checkpoint round trip on the card
   (float32 and bf16), bitwise; then olmo-1b, mamba2-1.3b and
   granite-moe-1b-a400m at published widths (bf16, random weights from a
   seed) trained through ``repro_torch.launch.train`` for 6 steps of 4 x
   1024 tokens, one after the other, with launch counts read around the
   run (per step forward + recompute: 32 flash-attention launches for
   OLMo, 48 for Granite, 96 conv1d ``shuffle``, 96 SSD and 96 tail
   (``gated_norm``) for Mamba-2, and 48 of the SSD's backward kernel,
   every flash and SSD call on
   ``tensor_core``), every loss finite and
   every parameter's gradient at step 1 finite and not zero everywhere
   (Granite's experts that no token chose counted); the layer-0 inputs of
   each kernel at step 1 held
   and timed as in phases 5-7, and the kernel's autograd Function held
   against the plain version's autograd on them, its backward timed; one
   more warm step traced and split into the kernels, their plain-autograd
   backward, cuBLAS, the optimizer, other kernels and idle time (the
   plain backward by the device spans of the program's
   ``repro::autograd.backward`` ranges, the optimizer by a profiler range
   the smoke opens around it);
9. the mesh path at world size 1: a one-rank NCCL process group and a
   (1, 1) ``("data", "model")`` mesh (``launch.mesh.make_mesh``); olmo-1b
   at published widths trained on it through the functions
   ``launch.train``'s mesh branch calls (``build`` with the mesh, which
   places every parameter as a DTensor by ``param_shardings``;
   ``batch_at``, which shards phase 8's batches), for phase 8's steps at
   its lr: every loss within 1e-3 relative of phase 8's at the same
   step, exactly phase 8's flash launches per step (32, all
   ``tensor_core``), every gradient finite; its step ms, tokens/s and
   peak GiB beside phase 8's; one ``self_attention(impl="ring")`` at
   OLMo's attention shape through the mesh, launching no flash kernel,
   its ring attention held against the flash kernel's on the same q, k,
   v within ``FLASH_TOL``, the call timed beside ``impl="blockwise"``; a reduced olmo-1b's DTensor train state after a step on the mesh
   saved through ``CheckpointStore`` and restored onto its placements,
   leaf for leaf equal; the group destroyed at the end.  The card holds
   one GPU, so the mesh is (1, 1): the ranks' arithmetic is held in the
   CPU tests on gloo (``tests/test_torch_distributed.py``);
10. the sharded MoE dispatch on phase 9's (1, 1) NCCL mesh: the reduced
   granite with ``moe_impl="sharded"`` under each schedule on the card
   against the CPU's (1, 1) mesh (logits and loss within 1e-4, every
   dispatch's kept pairs equal; the CPU side runs first, on a gloo group
   of its own); full-width granite-moe-1b-a400m with its published
   ``moe_impl="sharded"``, ``moe_schedule="auto"`` (``2d_dshard`` at one
   rank), built with the mesh, serves phase 6's traffic through
   ``serve.generate`` with launch counts read around the run (24 flash
   per prefill, all ``tensor_core``, none per decode step): prefill and
   decode times and peak beside phase 7's granite (the dropless dispatch),
   cap and the share of dropped pairs per layer, a traced prefill with
   the dispatch as its ``moe`` family; layer 0's MoE input from that run
   through the dispatch against the dense dispatch with the dropped
   pairs' gates zeroed (kept pairs by a cumulative count, equal exactly; the
   output within 4 bf16 ulps of its row's scale), both timed cold; the
   flash kernel's entry on that run; then 6 steps of phase 8's training
   through ``launch.train``'s mesh branch (48 flash per step, finite
   losses and gradients, the drop share per step, step ms, tokens/s and
   peak beside phase 8's, one warm step traced with a ``moe`` family);
11. the dry run (``python -m repro_torch.launch.dryrun``), each cell in a
   subprocess of its own: granite-moe-1b-a400m x train_4k on (16, 16)
   and kimi-k2-1t-a32b x decode_32k on (2, 16, 16) (its MoE on
   ``2d_dshard``), their per-rank bytes, FLOPs and collectives;
12. the compile side, on the host: a ``Compiler(jobs=4)`` session with a
   disk tier in a temporary directory under ``build/`` compiles the 19
   KernelGen sources (``SUITE`` and ``APPLICATIONS``) for ``hopper``
   through ``compile_many`` (19 misses, 19 emulations), again (19 memory
   hits, 0 emulations), and in a fresh session on the same directory (19
   disk hits, 0 emulations), with the three walls, the pass times, the
   shuffles and the emulator counters printed; every Hopper shuffle is
   ``shfl.sync`` with mask ``0xffffffff``; ``variants`` over the six
   targets with cost selection prints kept/dropped per target and source,
   Jacobi's as the paper's Fig. 2 (Pascal and Maxwell keep all 6 pairs,
   Kepler and Volta drop some); per bench of phase 2 the original and the
   synthesized PTX run on the concrete emulator at the reference test's
   grid (70 x 6 x 5, blocks of 64, inputs from ``default_rng(0)``) are
   bitwise equal, and ``stencil_apply(mode="paper")`` on the card is
   within ``TOL`` of them;
13. the full middle-end and the compile service, on the host but for the
   stencil launches: a ``PtxServiceServer(jobs=4)`` with a disk tier in a
   temporary directory under ``build/`` answers ``/healthz``; ``POST /lint``
   of the 13 stencil benches (all clean) and of ``tests/lint_corpus/`` (the
   clean twins clean, each planted bug found with the code its header
   names); ``POST /compile`` of the 19 KernelGen sources by name with
   ``target="hopper"``, ``saturate``, ``widen`` and ``lint="strict"``, cold
   (19 misses) and again (19 memory hits, 0 emulations), each response's PTX
   byte-equal to an in-process compile, no ERROR and no ``sat-gate``
   diagnostic; per stencil bench a plan from ``Compiler(widen=True,
   lint="strict")``, consistent and with the built ``paper`` kernel's
   schedule, ``stencil_apply(mode="paper")`` on the card within ``TOL`` of
   the saturated synthesized PTX on the concrete emulator (itself bitwise
   equal to the original PTX's run), Jacobi and tricubic at the paper's
   sizes bitwise equal to phase 4's paper output, launch counts read
   around it; then ``drive_requests`` (64 requests, 8 clients) against a
   second server on the same directory: req/s, p50/p99, no emulation;
14. the fleet, on the host but for the stencil launches: the port's fleet
   load test (``launch.fleet.smoke.run_smoke``, 24 requests, 6 clients) in
   subprocesses, a cache tier and replicas A, B (each its own disk
   directory, both on the tier) and C (1 worker, queue capacity 1), its
   five contracts held here from the summary (coalesce: one miss and one
   distinct payload; warm-remote: B's remote hits equal to its plan's
   distinct sources, no emulation; at least one 503 from C; every drain
   exit code 0), each phase's wall, req/s and p50/p99 and the tier's
   ``/stats`` printed, B's req/s beside phase 13(e)'s; then two
   ``Compiler`` sessions, each over a ``CompileCache`` whose only tier
   below memory is a ``RemoteCache`` on one in-process
   ``CacheTierServer``, plan the 13 benches (A: 13 misses and 13 puts;
   B: 13 remote hits, no emulation, each plan consistent, its schedule
   the built ``paper`` kernel's, its detection pairs A's), and
   ``stencil_apply(mode="paper")`` on the card on phase 13(d)'s inputs is
   bitwise equal to its outputs and within ``TOL`` of the concrete
   emulator, with launch counts read around it;
15. a ``kernels`` JSON line, and as the last line the device record.

Run from the repository root:  python3 chip_smoke.py
(``--only prefill-8x4096``: phases 1, the conv1d, SSD, flash and tail
builds of 2, and the two 8 x 4096 prefills, 7c and 7b, alone, then the
``kernels`` line.)
Needs one CUDA device and nvcc for sm_90a; exits non-zero without them.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
REPORT = os.path.join(ROOT, "build", "chip_smoke.json")
SEED = 0
TOL = dict(rtol=2e-4, atol=2e-4)        # the reference kernel tests' tolerance
HBM_BYTES_PER_S = 3.35e12               # H100 SXM data sheet
F32_FLOPS = 67e12                       # H100 SXM, float32 outside tensor cores
BF16_FLOPS = 989e12                     # H100 SXM, bf16 tensor cores, dense
MEDIUM = {1: (1_048_579,), 2: (2050, 4100), 3: (66, 260, 1030)}
PAPER = {"jacobi": (32768, 32768), "tricubic": (512, 1024, 1024)}
STENCIL_BENCHES = ["jacobi", "gaussblur", "laplacian", "wave13pt",
                   "whispering", "gradient", "divergence", "gameoflife",
                   "lapgsrb", "uxx1", "tricubic", "sincos", "vecadd"]
REPLACES = "src/repro/kernels/stencil/stencil.py:141"
SASS_PER_OUTPUT = ("ldg", "shfl", "int", "float", "lds_sts", "bar", "total")
SOURCE = "src/repro_torch/kernels/stencil/csrc/stencil_common.cuh"
CONV_REPLACES = "src/repro/kernels/conv1d/conv1d.py:31"
CONV_SOURCE = "src/repro_torch/kernels/conv1d/csrc/conv1d_common.cuh"
SSD_REPLACES = "src/repro/kernels/ssd/ssd.py:30"
SSD_SOURCE = "src/repro_torch/kernels/ssd/csrc/ssd.cu"
FLASH_REPLACES = "src/repro/kernels/flash_attention/flash_attention.py:33"
FLASH_SOURCE = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
TAIL_SOURCE = "src/repro_torch/kernels/gated_norm/csrc/gated_norm.cu"
# the mixer's tail is jnp in the JAX package, no Pallas kernel
TAIL_REPLACES = "none: src/repro/models/mamba2.py:218-220 (jnp)"
MAMBA, HYBRID = "mamba2-1.3b", "zamba2-1.2b"
# phase 7b: the benchmark's zamba2-7b.prefill-pool cell's largest batch
ZAMBA2_7B, ZAMBA2_7B_BATCH = "zamba2-7b", (8, 4096)
# phase 7c: the mixer's tail at the mamba2-1.3b.prefill-pool cell's largest batch
MAMBA_TAIL_BATCH = (8, 4096)
# ``--only``: phases 7c and 7b, the two 8 x 4096 prefills, alone; phase 7d alone
ONLY_PREFILLS, ONLY_ADAMW = "prefill-8x4096", "adamw"
ADAMW_SOURCE = "src/repro_torch/kernels/adamw/csrc/adamw.cu"
# the optimizer is jnp in the JAX package, no Pallas kernel
ADAMW_REPLACES = "none: src/repro/train/optim.py (jnp)"
DENSE = ("olmo-1b", "yi-9b")                        # served at full width
MOE, ENCDEC = "granite-moe-1b-a400m", "seamless-m4t-large-v2"     # the same
# card vs CPU, reduced only: kimi-k2 (1.04 T parameters) and
# llama-3.2-vision-90b (86.6 B) do not fit one card
REDUCED_ONLY = ("starcoder2-3b", "kimi-k2-1t-a32b", "llama-3.2-vision-90b")
# f32 continuity at full width; Yi-9B in f32 (34 GB) would hold nothing
# about the dense k/v cache that olmo-1b's run does not
CONTINUITY_ARCHS = (MAMBA, HYBRID, "olmo-1b", MOE)
# the VLM's gates are 0 at init, which makes its cross blocks no-ops; the
# card-vs-CPU checks set them to this on both sides
VLM_GATE = 0.5
SERVE = dict(batch=4, prompt_len=1024, gen=32)      # 4 chunks of 256 per prompt
CONV_TOL = {"float32": 1e-5, "bfloat16": 5e-2}      # the reference kernel tests'
SSD_TOL = {"float32": 1e-4, "bfloat16": 8e-2}       # the reference kernel tests'
FLASH_TOL = {"float32": 2e-5, "bfloat16": 6e-2}     # the reference kernel tests'
# (B, Sq, Sk, H, KV, Dh, causal): tests/test_kernels.py's five shapes, Sq
# above a ragged Sk, GQA with Dh 128, ragged Sq and Sk at Dh 64 and (GQA)
# 128, and the serving shapes: Zamba2's, Granite's (GQA 16/8 at Dh 64) and
# the Seamless encoder's (non-causal over 1024 frames)
FLASH_SHAPES = [(2, 64, 64, 4, 2, 16, True), (1, 100, 100, 4, 4, 8, True),
                (2, 64, 64, 8, 2, 16, False), (1, 33, 33, 2, 1, 32, True),
                (2, 48, 96, 4, 1, 16, True), (1, 40, 20, 2, 1, 8, True),
                (2, 200, 200, 8, 2, 128, True), (1, 300, 177, 4, 2, 64, True),
                (1, 130, 250, 8, 2, 128, True), (4, 1024, 1024, 32, 32, 64, True),
                (4, 1024, 1024, 16, 8, 64, True), (4, 1024, 1024, 16, 16, 64, False)]
# f32 continuity at full width: prefill 512 vs prefill 256 + 256 decode
# steps, 48 layers (16 for olmo-1b).  Both sides are exact float32
# algorithms that sum in other orders (a chunked scan against a
# recurrence, the flash kernel's online softmax against a plain one,
# batched against single-row matmuls); rounding of ~1e-7 per operation
# grows over 256 steps and 48 layers to well under 1e-3 on logits of
# magnitude ~1, while a wrong carried state, conv window or k/v row moves
# them by O(0.1).
CONTINUITY_TOL = 1e-3
# training at full width: the serving cells' traffic (4 x 1024 tokens from
# TokenPipeline(seed=0)), 6 steps, no checkpoint (a save would write 12-16 GB)
TRAIN = dict(batch=4, seq=1024, steps=6, lr=3e-3)
TRAIN_ARCHS = ("olmo-1b", MAMBA, MOE)
# one train step card vs CPU, reduced float32 (the hybrid with 5 layers):
# loss, gradient norm and every gradient (of its leaf's largest) within
# 1e-4, the reduced models' card-vs-CPU tolerance; each parameter after
# the step within train.optim.first_step_bound of that gradient tolerance
REDUCED_TRAIN = ("olmo-1b", MAMBA, HYBRID, MOE, ENCDEC, "llama-3.2-vision-90b")
TRAIN_TOL = 1e-4
# the mesh path at world size 1 against phase 8's run of the same steps:
# the same weights, batches and kernels in the same order (at one rank the
# global norm sums tensor by tensor as on one device), so the losses come
# out equal on an H100; these bf16 steps at lr 3e-3 with gradient norms up
# to ~66 amplify any rounding difference (a norm summed in another order
# gave 4.5e-4 by step 5), and 1e-3 relative still catches a wrong gradient
# scale (a mean taken twice, a shard counted twice) at O(1)
MESH_ARCH, MESH_LOSS_RTOL = "olmo-1b", 1e-3
# the sharded MoE dispatch on the (1, 1) mesh (phase 10): the reduced
# granite card vs CPU (float32) within the reduced models' tolerance, per
# schedule; the dry run's cells (phase 11), each in a subprocess of its own
MOE_SCHEDULES = ("2d", "ep_tp", "2d_dshard")
MOE_CARD_TOL = 1e-4
DRYRUN_CELLS = (("granite-moe-1b-a400m", "train_4k", False),
                ("kimi-k2-1t-a32b", "decode_32k", True))
# the conv1d widths built in phase 2; with the benches' paper plans, the
# distinct kernels phases 2-4 analyse through the default compiler session
CONV_WIDTHS = (4, 3)
# the compile side (phase 12): the reference test's concrete-emulator grid
# (tests/test_core_pipeline.py::_run_versions) and the session's workers
CONCRETE_GRID = dict(nx=70, ny=6, nz=5, block_x=64)
COMPILE_JOBS = 4
# the full middle-end and the compile service (phase 13): every knob of the
# reference's pipeline, the service's own load (--bench's defaults) and the
# lint corpus, whose headers name each file's expected finding
FULL_MIDDLE_END = dict(saturate=True, widen=True, lint="strict")
SERVICE_LOAD = dict(requests=64, clients=8)
# the fleet (phase 14): its own load test at the reference CLI's defaults
FLEET_LOAD = dict(requests=24, clients=6)
LINT_CORPUS = os.path.join(ROOT, "tests", "lint_corpus")


def sh(*cmd: str) -> str:
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout.strip()


def card_line() -> str:
    return sh("nvidia-smi", "--query-gpu=name,power.limit",
              "--format=csv,noheader").splitlines()[0]


def event_times(fn, n: int, warmup: int = 2, flush=None):
    """Per-call device milliseconds of ``fn``: an event pair around each
    call, the calls queued back to back, one synchronise at the end.
    ``flush``, a tensor larger than the L2 cache, is overwritten before
    each call (outside the events), so every call starts from a cold L2."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(n):
        if flush is not None:
            flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in pairs]


def inputs(prog, shape, seed, device):
    """Input tensors and scalars made from one numpy generator."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    arrays = {}
    for a in sorted(prog.arrays):
        if a != prog.out.array:
            host = rng.standard_normal(shape, dtype=np.float32)
            arrays[a] = torch.from_numpy(host).to(device)
            del host
    scalars = {s: float(rng.uniform(0.1, 1.0)) for s in prog.scalars}
    return arrays, scalars


def ragged_shapes(prog, steps: int) -> list:
    """Full shapes whose interior is ragged along the march (1, R - 1 and
    R + 1 outputs; j 11 in 3-D) and along i (31, 33 and 77 lanes)."""
    halo = tuple(reversed(prog.halo))
    interiors = {1: [(31,), (33,), (77,)],
                 2: [(1, 31), (steps - 1, 33), (steps + 1, 77)],
                 3: [(1, 11, 31), (steps - 1, 11, 33), (steps + 1, 11, 77)]}
    return [tuple(n + 2 * h for n, h in zip(m, halo)) for m in interiors[prog.ndim]]


def flops_per_point(expr) -> int:
    from repro_torch.core.frontend.stencil import Bin, Call

    if isinstance(expr, Bin):
        return 1 + flops_per_point(expr.a) + flops_per_point(expr.b)
    if isinstance(expr, Call):
        return 1 + flops_per_point(expr.arg)
    return 0


def sass_instances(counts: dict, symbol: str) -> dict:
    """SASS counts of every compiled template instance of ``symbol``,
    keyed by its (dtype, vector width) read from the mangled name."""
    out = {}
    for fn, c in counts.items():
        if symbol in fn:
            m = re.search(r"I(f|13__nv_bfloat16)(?:Li(\d+)E)?E", fn)
            key = (({"f": "f32", "13__nv_bfloat16": "bf16"}[m.group(1)]
                    + (f"x{m.group(2)}" if m.group(2) else "")) if m else fn)
            out[key] = c
    return out


def tc_instances(counts: dict, symbol: str) -> dict:
    """SASS counts of every instance of the tensor-core kernel ``symbol``
    (template arguments all integers), keyed by those arguments."""
    out = {}
    for fn, c in counts.items():
        m = re.search(re.escape(symbol) + r"I((?:Li\d+E)+)E", fn)
        if m:
            out["x".join(re.findall(r"Li(\d+)E", m.group(1)))] = c
    return out


def check_tensor_cores(name: str, tc: dict, other: dict, report) -> None:
    """HGMMA in every tensor-core instance, none in the CUDA-core ones."""
    if not tc or any(c["hgmma"] == 0 for c in tc.values()):
        raise RuntimeError(f"{name}: tensor-core instances without HGMMA: {tc}")
    if any(c["hgmma"] or c["hmma"] for c in other.values()):
        raise RuntimeError(f"{name}: CUDA-core instances with tensor-core products: {other}")
    for i, c in {**tc, **other}.items():
        print(f"[sass] {name:<15} {i:<12} HGMMA {c['hgmma']:>3} HMMA {c['hmma']:>2} "
              f"SHFL {c['shfl']:>3} LDG {c['ldg']:>3}")
    report["sass"][name] = {"tensor_core": tc, "cuda_core": other}


def traced(fn, what: str, attempts: int = 3):
    """The events of a ``torch.profiler`` trace (CPU and CUDA activity) of
    ``fn()``.  A trace that holds no device event at all is taken again, up
    to ``attempts`` traces, each reported: the profiler's device tracing has
    come back empty on a card whose kernels ran (a trace of five SSD calls
    once held nothing).  A trace with device events is returned as it is,
    so a kernel missing from it still fails the caller's checks."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, attempts + 1):
        with warnings.catch_warnings():         # the profiler's note on its cycles
            warnings.simplefilter("ignore", UserWarning)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
        events = prof.events()
        if any(e.device_type == DeviceType.CUDA for e in events):
            return events
        print(f"[profiler] {what}: trace {attempt} of {attempts} held no device event",
              flush=True)
    raise RuntimeError(f"{what}: {attempts} profiler traces held no device event")


def kernel_times(fn, what: str, n: int = 5) -> dict:
    """Device microseconds per call of each CUDA kernel that ``fn``
    launches, from a trace of n calls."""
    import torch
    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
    us = {}
    for e in traced(lambda: [fn() for _ in range(n)], what):
        if e.device_type == DeviceType.CUDA:
            key = e.name.split("(")[0]
            us[key] = us.get(key, 0.0) + e.device_time_total / n
    return us


def cold_ms(fns: dict, n: int) -> dict:
    """Median cold-L2 milliseconds of each function, timed in turns
    (a, b, ..., b, a) so that drift in clocks or power hits every one.
    Overwriting a buffer larger than L2 before each call also keeps the
    card busy while the host enqueues the call: back to back, the event
    pair around a 50 us kernel measured the host's launch latency."""
    import torch

    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    order = list(fns) + list(reversed(fns))
    samples = {k: [] for k in fns}
    for k in order:
        samples[k] += event_times(fns[k], n=max(1, n // 2), flush=flush)
    return {k: statistics.median(v) for k, v in samples.items()}


def randn(shape, dtype, rng, device="cuda"):
    import numpy as np
    import torch

    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
        device, dtype)


def ssd_inputs(B, L, H, P, N, dtype, rng):
    import numpy as np
    import torch

    xh = randn((B, L, H, P), dtype, rng)
    dt = torch.from_numpy(rng.uniform(0.01, 0.2, (B, L, H)).astype(np.float32)).cuda()
    A = -torch.from_numpy(rng.uniform(0.5, 2.0, (H,)).astype(np.float32)).cuda()
    return xh, dt, A, randn((B, L, 1, N), dtype, rng), randn((B, L, 1, N), dtype, rng)


def flash_rounded(name, instance, out, q, k, v, causal):
    """A tensor-core result against ``attention_tiled(round_p=True)`` over
    the instance's key tiles, its float32 result (``instances.check_rounded``:
    4 bf16 ulps of each row's scale, 1.25 times the norm of that result's
    own bf16 rounding); None for the CUDA-core instance."""
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.kernels.instances import check_rounded

    if instance != "tensor_core":
        return None
    want = tfa.ref.attention_tiled(q.float(), k.float(), v.float(), causal,
                                   key_tile=tfa.TENSOR_CORE_KEY_TILE[q.shape[-1]],
                                   round_p=True)
    return check_rounded(name, out, want)


def ssd_rounded(name, instance, y, state, args, chunk):
    """A tensor-core result (y and the final state) against
    ``ssd_passes(round_operands=True)``'s float32 result, as
    :func:`flash_rounded`; None for the CUDA-core instance."""
    from repro_torch.kernels import ssd as tssd
    from repro_torch.kernels.instances import check_rounded

    if instance != "tensor_core":
        return None
    xh, dt, A, Bm, Cm = args
    want_y, want_st = tssd.ref.ssd_passes(xh.float(), dt, A, Bm.float(), Cm.float(),
                                          chunk, round_operands=True)
    return {"y": check_rounded(f"{name} y", y, want_y),
            "state": check_rounded(f"{name} state", state, want_st)}


def rounded_note(r) -> str:
    if r is None:
        return ""
    parts = r.items() if "y" in r else [("", r)]
    return "; vs rounding plain " + ", ".join(
        f"{k + ' ' if k else ''}{v['ulps']:.2f} ulp x{v['norm_ratio']:.3f}" for k, v in parts)


def serving_parity(conv, ssd_kernel, report) -> None:
    """Phase 3b: conv1d and SSD against their plain versions at ragged
    shapes (neither L nor C a multiple of the CTA tile, L ragged against
    the conv march, x as a column range of a wider tensor; chunks that are
    not multiples of the 64-row score tile)."""
    import numpy as np
    import torch

    from repro_torch.kernels import conv1d as tconv
    from repro_torch.kernels import ssd as tssd

    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    rng = np.random.default_rng(SEED)
    report["conv1d_parity"], report["ssd_parity"] = [], []
    march = tconv.conv1d.STEPS * tconv.conv1d.POSITIONS
    # (B, L, C, W, columns left and right of x in a wider tensor): ragged L
    # and C; L ragged against the march (1, 8S - 1, 8S + 1); x as Mamba-2's
    # in-projection columns (aligned) and at an odd row stride and base
    for B, L, C, W, left, right in [
            (4, 1000, 4352, 4, 0, 0), (3, 37, 77, 4, 0, 0), (1, 129, 200, 3, 0, 0),
            (2, 333, 4350, 4, 0, 0), (3, 1, 77, 4, 0, 0), (2, march - 1, 4352, 4, 0, 0),
            (2, march + 1, 200, 3, 0, 0), (4, 1024, 4352, 4, 4096, 64),
            (2, 333, 200, 4, 4096, 65), (2, 2 * march + 3, 456, 3, 4097, 63)]:
        for dname, dtype in dtypes.items():
            x = randn((B, L, left + C + right), dtype, rng)[..., left:left + C]
            w, b = randn((W, C), dtype, rng), randn((C,), dtype, rng)
            want = tconv.ref.causal_conv1d(x, w, b)
            outs = [conv[(m, W)](x, w, b) for m in tconv.MODES]
            torch.cuda.synchronize()
            errs = []
            for out in outs:
                torch.testing.assert_close(out.float(), want.float(),
                                           rtol=CONV_TOL[dname], atol=CONV_TOL[dname])
                errs.append(float((out.float() - want.float()).abs().max()))
            if not torch.equal(outs[0], outs[1]):
                raise RuntimeError(f"conv1d {(B, L, C, W)} {dname}: modes differ")
            report["conv1d_parity"].append({"shape": (B, L, C, W), "dtype": dname,
                                            "x_strides": x.stride(), "max_abs_err": errs})
            print(f"[parity] conv1d {(B, L, C, W)} {dname:<8} x strides {x.stride()} "
                  f"max|err| naive {errs[0]:.2e} shuffle {errs[1]:.2e}, modes bitwise equal")
    for B, L, H, P, N, Q in [(2, 64, 4, 16, 16, 16), (1, 128, 2, 32, 64, 32),
                             (2, 96, 3, 8, 16, 32), (1, 64, 2, 16, 16, 64),
                             (2, 768, 5, 64, 128, 256), (1, 384, 3, 12, 20, 96),
                             (2, 512, 6, 64, 64, 64), (1, 768, 4, 64, 128, 192)]:
        for dname, dtype in dtypes.items():
            args = ssd_inputs(B, L, H, P, N, dtype, rng)
            before = dict(ssd_kernel.instance_launches)
            y, st = ssd_kernel(*args, Q)
            inst = [i for i, n in ssd_kernel.instance_launches.items() if n != before[i]]
            want_y, want_st = tssd.ref.ssd_chunked(*args, Q)
            torch.cuda.synchronize()
            tol = SSD_TOL[dname]
            torch.testing.assert_close(y.float(), want_y.float(), rtol=tol, atol=tol)
            torch.testing.assert_close(st, want_st, rtol=tol, atol=tol)
            ey = float((y.float() - want_y.float()).abs().max())
            es = float((st - want_st).abs().max())
            rounded = ssd_rounded(f"ssd {(B, L, H, P, N, Q)}", inst[0], y, st, args, Q)
            report["ssd_parity"].append({"shape": (B, L, H, P, N, Q), "dtype": dname,
                                         "instance": inst, "y_err": ey, "state_err": es,
                                         "rounded": rounded})
            print(f"[parity] ssd {(B, L, H, P, N, Q)} {dname:<8} {inst[0]:<11} max|err| y "
                  f"{ey:.2e} state {es:.2e}{rounded_note(rounded)}")
    args = ssd_inputs(1, 64, 2, 8, 16, torch.float32, rng)
    (one, s1), (many, s8) = ssd_kernel(*args, 64), ssd_kernel(*args, 8)
    torch.testing.assert_close(one, many, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(s1, s8, rtol=2e-4, atol=2e-4)
    print(f"[parity] ssd chunk 64 vs chunk 8: max|diff| y "
          f"{float((one - many).abs().max()):.2e} state {float((s1 - s8).abs().max()):.2e}")
    # the tensor-core instance against itself across chunk sizes, bf16
    args = ssd_inputs(2, 1024, 4, 64, 128, torch.bfloat16, rng)
    (one, s1), (many, s4) = ssd_kernel(*args, 256), ssd_kernel(*args, 64)
    tol = SSD_TOL["bfloat16"]
    torch.testing.assert_close(one.float(), many.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(s1, s4, rtol=tol, atol=tol)
    report["ssd_chunk_invariance_bf16"] = {"y": float((one.float() - many.float()).abs().max()),
                                           "state": float((s1 - s4).abs().max())}
    print(f"[parity] ssd tensor_core bf16 chunk 256 vs chunk 64: max|diff| y "
          f"{report['ssd_chunk_invariance_bf16']['y']:.2e} state "
          f"{report['ssd_chunk_invariance_bf16']['state']:.2e}")


def flash_parity(fa_kernel, report) -> None:
    """Phase 3c: flash attention against its plain version."""
    import numpy as np
    import torch

    from repro_torch.kernels import flash_attention as tfa

    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    rng = np.random.default_rng(SEED)
    report["flash_parity"] = []
    for B, Sq, Sk, H, KV, Dh, causal in FLASH_SHAPES:
        for dname, dtype in dtypes.items():
            q = randn((B, Sq, H, Dh), dtype, rng)
            k, v = randn((B, Sk, KV, Dh), dtype, rng), randn((B, Sk, KV, Dh), dtype, rng)
            before = dict(fa_kernel.instance_launches)
            out = fa_kernel(q, k, v, causal)
            inst = [i for i, n in fa_kernel.instance_launches.items() if n != before[i]]
            want = tfa.ref.attention_ref(q, k, v, causal)
            torch.cuda.synchronize()
            tol = FLASH_TOL[dname]
            torch.testing.assert_close(out.float(), want.float(), rtol=tol, atol=tol)
            err = float((out.float() - want.float()).abs().max())
            shape = (B, Sq, Sk, H, KV, Dh, causal)
            rounded = flash_rounded(f"flash_attention {shape}", inst[0], out, q, k, v, causal)
            report["flash_parity"].append({"shape": shape, "dtype": dname,
                                           "instance": inst, "max_abs_err": err,
                                           "rounded": rounded})
            print(f"[parity] flash_attention {shape} {dname:<8} {inst[0]:<11} "
                  f"max|err| {err:.2e}{rounded_note(rounded)}")


def flash_per_forward(cfg) -> int:
    """Flash-attention launches of one full-sequence forward of ``cfg``:
    one per self-attention layer (the encoder's too; cross attention never
    reaches the kernel), one per application of the hybrid's shared
    block."""
    L = cfg.n_layers
    return {"dense": L, "moe": L, "audio": L + cfg.n_encoder_layers,
            "vlm": L // max(cfg.cross_every, 1) * (cfg.cross_every - 1),
            "hybrid": L // cfg.attn_every}.get(cfg.family, 0)


def stub_batch(cfg, B: int, rng, device) -> dict:
    """The launcher's stubbed media (vlm) or frames (audio), drawn as
    seeded standard normals, as the reference's model tests draw them; {}
    for the other families."""
    import torch

    from repro_torch.launch.serve import stub_inputs

    return {k: randn(tuple(v.shape), torch.float32, rng, device)
            for k, v in stub_inputs(cfg, B, "meta").items()}


def reduced_pair(arch: str, remat: str = "none"):
    """The reduced config (the hybrid with 5 layers: two supercells and a
    trailing block), a model on the CPU from the seed and one on the card
    with the same weights (``remat`` on the card's), the VLM's gates at
    VLM_GATE on both."""
    import torch

    from repro_torch.configs import get_config, reduced
    from repro_torch.models import build_model

    rcfg = reduced(get_config(arch))
    if rcfg.family == "hybrid":
        rcfg = rcfg.replace(n_layers=5)
    cpu = build_model(rcfg, device="cpu", generator=torch.Generator().manual_seed(SEED))
    with torch.no_grad():
        for cross in getattr(cpu, "cross", ()):
            cross.gate.fill_(VLM_GATE)
    gpu = build_model(rcfg.replace(remat=remat), device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    return rcfg, cpu, gpu


def reduced_card_vs_cpu(report, arch: str) -> None:
    """The reduced model on the card (every kernel) against the plain path
    on the CPU with the same weights (``reduced_pair``): logits, greedy
    tokens and the loss, with seeded media or frames."""
    import numpy as np
    import torch

    from repro_torch.serve import generate

    rcfg, cpu, gpu = reduced_pair(arch)
    rng = np.random.default_rng(SEED)
    toks = torch.from_numpy(rng.integers(0, rcfg.vocab, (2, 48)))
    stub = stub_batch(rcfg, 2, rng, "cpu")
    on_card = {"tokens": toks.cuda(), **{k: v.cuda() for k, v in stub.items()}}
    got, _ = gpu.prefill(on_card)
    ref, _ = cpu.prefill({"tokens": toks, **stub})
    err = float((got.cpu() - ref).abs().max())
    torch.testing.assert_close(got.cpu(), ref, rtol=1e-4, atol=1e-4)
    if not torch.equal(generate(gpu, on_card, 8).cpu(),
                       generate(cpu, {"tokens": toks, **stub}, 8)):
        raise RuntimeError(f"reduced {arch}: greedy tokens differ card vs CPU")
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, dims=1), **stub}
    with torch.inference_mode():
        loss, ref_loss = gpu.loss(batch)[0].cpu(), cpu.loss(batch)[0]
    loss_err = float((loss - ref_loss).abs())
    torch.testing.assert_close(loss, ref_loss, rtol=1e-4, atol=1e-4)
    report["reduced_card_vs_cpu_err"] = err
    report["reduced_loss_err"] = loss_err
    print(f"[serve] reduced {arch} ({rcfg.n_layers} layers) on the card vs plain on "
          f"the CPU: max|err| logits {err:.2e}, greedy tokens equal, loss "
          f"{float(ref_loss):.4f} |err| {loss_err:.2e}")


def prefill_split(model, batch, arch: str, moe_fn: str = "apply_moe_dropless") -> dict:
    """Device time of one warm full-width prefill by kernel family, from a
    ``torch.profiler`` trace (CPU and CUDA activity), beside the prefill's
    wall time measured without the profiler.  A MoE's dispatch (the
    function of ``moe`` named ``moe_fn``, wrapped here in a ``smoke::moe``
    range: the one-device dropless dispatch, or the whole sharded dispatch
    on a mesh) is the ``moe`` family: every kernel that starts inside that
    range's device span, as ``train_split`` reads its ranges."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import record_function

    import repro_torch.models.moe as moem

    families = (("ssd", ("ssd_tc::", "ssd::")), ("flash_attention", ("flash_tc::", "flash::")),
                ("conv1d", ("conv1d_",)), ("gated_norm", ("gated_norm::",)),
                ("cat", ("CatArrayBatchedCopy",)),
                ("matmul", ("gemm", "xmma", "cutlass", "nvjet", "sm90_")))
    model.prefill(batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.prefill(batch)
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    real_ffn = getattr(moem, moe_fn)

    def traced_ffn(*args, **kwargs):
        with record_function("smoke::moe"):
            return real_ffn(*args, **kwargs)

    setattr(moem, moe_fn, traced_ffn)
    try:
        events = traced(lambda: model.prefill(batch), f"{arch} prefill")
    finally:
        setattr(moem, moe_fn, real_ffn)
    spans, kernels = [], []
    for e in events:
        if e.device_type == DeviceType.CUDA:
            (spans if e.name == "smoke::moe" else kernels).append(e)
    spans = [(e.time_range.start, e.time_range.end) for e in spans]
    split, other = {name: 0.0 for name, _ in families}, {}
    if spans:
        split["moe"] = 0.0
    for e in kernels:
        t, ms = e.time_range.start, e.device_time_total / 1e3
        fam = ("moe" if any(a <= t <= b for a, b in spans) else
               next((name for name, keys in families if any(k in e.name for k in keys)), None))
        if fam is None:
            other[e.name[:60]] = other.get(e.name[:60], 0.0) + ms
        else:
            split[fam] += ms
    split["other"] = sum(other.values())
    device_ms = sum(split.values())
    top = dict(sorted(other.items(), key=lambda kv: -kv[1])[:5])
    print(f"[trace] {arch} warm prefill: wall {wall_ms:.1f} ms, device busy "
          f"{device_ms:.1f} ms ({100 * device_ms / wall_ms:.0f} %): "
          + ", ".join(f"{k} {v:.1f}" for k, v in split.items())
          + (f" ms (moe {100 * split['moe'] / device_ms:.0f} % of busy, {len(spans)} spans)"
             if spans else " ms")
          + "; largest other: " + ", ".join(f"{k} {v:.2f}" for k, v in top.items()))
    return {"wall_ms": wall_ms, "device_ms": device_ms, "by_family_ms": split,
            "other_top_ms": top}


def serve_run(report, arch: str, want: dict):
    """``arch`` at full width through ``launch.serve``, launch counts read
    around the run and required to equal ``want``; returns the launch
    counts and the inputs of the first conv1d, SSD and flash-attention
    calls, captured on that run (flash attention's also keyed by its
    causal flag: the enc-dec's encoder calls are non-causal).  An enc-dec
    model is served seeded standard-normal frames in place of the
    launcher's zeros, with which every q, k and v of the encoder's first
    layer would be zero."""
    import numpy as np
    import torch

    import repro_torch.models.attention as attn
    import repro_torch.models.mamba2 as m2
    from repro_torch.configs import get_config
    from repro_torch.kernels import conv1d as tconv
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.kernels import gated_norm as tgn
    from repro_torch.kernels import ssd as tssd
    from repro_torch.kernels import stencil as tstencil
    from repro_torch.launch import serve
    from repro_torch.models import build_model

    cfg = get_config(arch)
    frames = stub_batch(cfg, SERVE["batch"], np.random.default_rng(SEED), "cuda")
    argv = ["--arch", arch, "--device", "cuda", "--batch", str(SERVE["batch"]),
            "--prompt-len", str(SERVE["prompt_len"]), "--gen", str(SERVE["gen"]),
            "--seed", str(SEED)]
    captured = {}
    real = (m2.causal_conv1d, m2.ssd, attn.flash_attention, serve.generate)

    def capture_conv(x, w, b, mode="shuffle", activation=True):
        # w and b are trainable parameters: held off the autograd graph
        captured.setdefault("conv", (x, w.detach(), b.detach()))
        return real[0](x, w, b, mode=mode, activation=activation)

    def capture_ssd(xh, dt, A, Bm, Cm, chunk):
        captured.setdefault("ssd", (xh, dt, A, Bm, Cm, chunk))
        return real[1](xh, dt, A, Bm, Cm, chunk)

    def capture_flash(q, k, v, causal=True):
        captured.setdefault("flash", (q, k, v, causal))
        captured.setdefault(("flash", causal), (q, k, v, causal))
        return real[2](q, k, v, causal=causal)

    def generate_on_frames(model, batch, *args, **kwargs):
        if cfg.family == "audio":
            batch.update(frames)              # the launcher's batch, in place
        return real[3](model, batch, *args, **kwargs)

    # warm-up: one full-width prefill outside the counted run (the first
    # use of each cuBLAS kernel loads its module), so the run is warm
    model = build_model(cfg, device="cuda")
    batch = {"tokens": torch.zeros((SERVE["batch"], SERVE["prompt_len"]),
                                   dtype=torch.long, device="cuda"),
             **serve.stub_inputs(cfg, SERVE["batch"], "cuda")}
    t0 = time.perf_counter()
    model.prefill(batch)
    torch.cuda.synchronize()
    report["first_prefill_ms"] = 1e3 * (time.perf_counter() - t0)
    print(f"[serve] {arch} warm-up: the first full-width prefill after start-up "
          f"took {report['first_prefill_ms']:.1f} ms")
    del model, batch

    torch.cuda.empty_cache()
    m2.causal_conv1d, m2.ssd, attn.flash_attention = capture_conv, capture_ssd, capture_flash
    serve.generate = generate_on_frames
    for mod in (tconv, tssd, tfa, tstencil, tgn):
        mod.reset_launch_counts()
    try:
        out = serve.main(argv)
        torch.cuda.synchronize()
    finally:
        m2.causal_conv1d, m2.ssd, attn.flash_attention, serve.generate = real
    counts = {**tconv.launch_counts(), **tssd.launch_counts(), **tssd.instance_counts(),
              **tfa.launch_counts(), **tfa.instance_counts(), **tstencil.launch_counts(),
              **tgn.launch_counts()}
    if {k: counts.get(k) for k in want} != want or \
            any(n for k, n in counts.items() if k not in want):
        raise RuntimeError(f"serve {arch}: launches {counts}, expected {want}")
    launches = {k: n for k, n in counts.items() if n}
    tokens = out["tokens"]
    if tokens.shape != (SERVE["batch"], SERVE["gen"]) or \
            tokens.min() < 0 or tokens.max() >= cfg.vocab:
        raise RuntimeError(f"serve {arch}: tokens {tokens.shape} out of range")
    print(f"[serve] {arch} launches per served run: "
          + " ".join(f"{k} {n}" for k, n in launches.items()))
    model, batch = out.pop("model"), out.pop("batch")
    logits, _ = model.prefill(batch)
    if not bool(torch.isfinite(logits).all()) or \
            logits.shape != (SERVE["batch"], cfg.vocab) or \
            not np.array_equal(logits.argmax(-1).cpu().numpy(), tokens[:, 0]):
        raise RuntimeError(f"serve {arch}: prefill logits non-finite, misshapen "
                           "or not the first generated token")
    report["prefill_split"] = prefill_split(model, batch, arch)
    del model, batch, logits
    report["serve"] = {k: v for k, v in out.items() if k != "tokens"}
    report["serve"]["launches"] = launches
    return launches, captured


def layer0_conv1d(conv, args, launches, report, entries, name, phase="serve") -> None:
    """Both conv1d modes on layer 0's input, the in-projection's column
    view the model passes: parity with the plain version, times beside the
    bound, the plain version, F.conv1d + SiLU and a copy of the same bytes.
    Only ``shuffle``, the mode the model runs, enters the kernels line."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import conv1d as tconv

    x, w, b = args
    B, L, C = x.shape
    W = w.shape[0]
    if x.is_contiguous() or x.stride(2) != 1:
        raise RuntimeError(f"conv1d: layer 0's input {tuple(x.shape)}, strides "
                           f"{x.stride()}, is not a column view of the in-projection")
    tol = CONV_TOL["bfloat16" if x.dtype == torch.bfloat16 else "float32"]
    want = tconv.ref.causal_conv1d(x, w, b)
    outs = {m: conv[(m, W)](x, w, b) for m in tconv.MODES}
    torch.cuda.synchronize()
    err = max(float((o.float() - want.float()).abs().max()) for o in outs.values())
    for o in outs.values():
        torch.testing.assert_close(o.float(), want.float(), rtol=tol, atol=tol)
    if not torch.equal(outs["naive"], outs["shuffle"]):
        raise RuntimeError("conv1d: modes differ on layer 0's input")
    xt = x.transpose(1, 2)
    wt = w.t().contiguous().unsqueeze(1)                          # (C, 1, W)

    def library():
        return F.silu(F.conv1d(xt, wt, b, padding=W - 1, groups=C)[..., :L])

    torch.testing.assert_close(library().transpose(1, 2).float(), want.float(),
                               rtol=tol, atol=tol)
    print(f"[{phase}-kernel] conv1d layer 0's input {tuple(x.shape)} {x.dtype} is the "
          f"in-projection's column view, strides {x.stride()}")
    item = x.element_size()
    nbytes = 2 * x.numel() * item + (W + 1) * C * item
    flops = x.numel() * (2 * W + 4)           # W mul-adds, SiLU (exp, add, div)
    bound = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "operations": flops / F32_FLOPS * 1e3}
    bound_by = max(bound, key=bound.get)
    dense = torch.empty((B, L, C), dtype=x.dtype, device=x.device)
    times = cold_ms({**{m: (lambda k=conv[(m, W)]: k(x, w, b)) for m in tconv.MODES},
                     "plain": lambda: tconv.ref.causal_conv1d(x, w, b), "library": library,
                     "copy": lambda: dense.copy_(x)}, 40)
    plain_ms, library_ms, copy_ms = times["plain"], times["library"], times["copy"]
    rec = {"shape": (B, L, C, W), "x_strides": x.stride(), "dtype": str(x.dtype),
           "bytes": nbytes,
           "bound_ms": bound[bound_by], "bound_by": bound_by, "plain_ms": plain_ms,
           "library_ms": library_ms, "copy_ms": copy_ms, "max_abs_err": err, "ms": {}}
    for m in tconv.MODES:
        ms = times[m]
        rec["ms"][m] = ms
        print(f"[{phase}-kernel] conv1d {m:<7} {(B, L, C, W)} {x.dtype} {ms:.4f} ms, "
              f"bound {bound[bound_by]:.4f} ms ({bound_by}), "
              f"{nbytes / ms / 1e6:.0f} GB/s")
    print(f"[{phase}-kernel] conv1d plain {plain_ms:.4f} ms, F.conv1d+silu "
          f"{library_ms:.4f} ms, a copy of x into a contiguous tensor (the same "
          f"bytes) {copy_ms:.4f} ms, max|err| {err:.2e}")
    entries.append({"name": name, "route": "cuda", "source": CONV_SOURCE,
                    "replaces": CONV_REPLACES, "launches": launches["conv1d_shuffle_w4"],
                    "max_abs_err": err, "ms": times["shuffle"], "plain_ms": plain_ms,
                    "bound_ms": bound[bound_by], "bound_by": bound_by,
                    "library_ms": library_ms})
    report["conv1d_layer0"] = rec


def layer0_ssd(ssd_kernel, args, launches, report, entries, name, phase="serve") -> None:
    """The SSD kernel on layer 0's inputs: parity with the plain version
    (y and final state), time beside the bound and the plain version."""
    import torch

    from repro_torch.kernels import ssd as tssd

    xh, dt, A, Bm, Cm, Q = args
    Bsz, L, H, P = xh.shape
    N = Bm.shape[3]
    y, st = ssd_kernel(xh, dt, A, Bm, Cm, Q)
    want_y, want_st = tssd.ref.ssd_chunked(xh, dt, A, Bm, Cm, Q)
    torch.cuda.synchronize()
    tol = SSD_TOL["bfloat16" if xh.dtype == torch.bfloat16 else "float32"]
    torch.testing.assert_close(y.float(), want_y.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(st, want_st, rtol=tol, atol=tol)
    ey = float((y.float() - want_y.float()).abs().max())
    es = float((st - want_st).abs().max())
    instance = tssd.select_instance(xh, Bm, Cm, Q)
    rounded = ssd_rounded(f"ssd layer 0 ({name})", instance, y, st, args[:5], Q)
    item = xh.element_size()
    nbytes = (2 * xh.numel() * item + dt.numel() * 4 + A.numel() * 4
              + (Bm.numel() + Cm.numel()) * item + Bsz * H * N * P * 4)
    # what the function needs per chunk: causal C.B^T once per (b, chunk,
    # group), and per head causal scores @ x, C @ state, the state update
    chunks = Bsz * (L // Q)
    flops = chunks * (Q * (Q + 1) * N * Bm.shape[2]
                      + H * (Q * (Q + 1) * P + 4 * Q * N * P))
    # what the instance executes
    T, nc = Q // 64, L // Q
    if instance == "tensor_core":
        # a: B^T (w x); b: C S_c as hi + lo for chunks c >= 1; c: C B^T for
        # the tiles on and below the diagonal once per 8 heads, then per head
        # the diagonal tile's scores @ x as hi + lo and C B^T (g x) below it
        # as hi + lo
        hs = 8 if H % 8 == 0 else 4 if H % 4 == 0 else 2 if H % 2 == 0 else 1
        tile = 2 * 64 * 64
        kernel_flops = Bsz * (nc * H * 2 * Q * N * P + (nc - 1) * H * 2 * 2 * Q * N * P
                              + nc * (H // hs) * (T * (T + 1) // 2) * tile * N
                              + nc * H * (T * 2 * tile * P + (T * (T - 1) // 2) * 2 * tile * P))
    else:
        # C.B^T and scores @ x on every 64 x 64 tile pair on or below the
        # diagonal, per head (Q a multiple of 64)
        kernel_flops = chunks * H * (T * (T + 1) // 2 * 2 * 64 * 64 * (N + P) + 4 * Q * N * P)
    # the Pallas kernel's: full Q x Q tiles, C.B^T per head
    pallas_flops = chunks * H * (2 * Q * Q * (N + P) + 4 * Q * N * P)
    peak = BF16_FLOPS if xh.dtype == torch.bfloat16 else F32_FLOPS
    bound = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "operations": flops / peak * 1e3}
    bound_by = max(bound, key=bound.get)
    passes = kernel_times(lambda: ssd_kernel(xh, dt, A, Bm, Cm, Q), f"ssd ({name})")
    if len(passes) != tssd.KERNELS_PER_CALL[instance]:
        raise RuntimeError(f"ssd ({instance}): {len(passes)} CUDA kernels per call: {passes}")
    times = cold_ms({"kernel": lambda: ssd_kernel(xh, dt, A, Bm, Cm, Q),
                     "plain": lambda: tssd.ref.ssd_chunked(xh, dt, A, Bm, Cm, Q)}, 10)
    ms, plain_ms = times["kernel"], times["plain"]
    report["ssd_layer0"] = {
        "shape": (Bsz, L, H, P, N, Q), "dtype": str(xh.dtype), "instance": instance,
        "bytes": nbytes, "flops": flops, "kernel_flops": kernel_flops,
        "pallas_flops": pallas_flops, "bound_ms": bound[bound_by], "bound_by": bound_by,
        "ms": ms, "plain_ms": plain_ms, "kernels_per_call": len(passes),
        "kernel_us_warm": passes, "y_err": ey, "state_err": es, "rounded": rounded}
    entries.append({"name": name, "route": "cuda", "source": SSD_SOURCE,
                    "replaces": SSD_REPLACES, "launches": launches["ssd"],
                    "max_abs_err": max(ey, es), "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound[bound_by], "bound_by": bound_by,
                    "library_ms": None})
    print(f"[{phase}-kernel] ssd {(Bsz, L, H, P, N, Q)} {xh.dtype} ({instance}, "
          f"{len(passes)} CUDA kernels per call) {ms:.4f} ms, bound "
          f"{bound[bound_by]:.4f} ms ({bound_by}; needs {flops / 1e9:.2f} GFLOP, "
          f"{nbytes / 1e6:.1f} MB); executes {kernel_flops / 1e9:.2f} GFLOP "
          f"(Pallas {pallas_flops / 1e9:.2f}) at {kernel_flops / ms / 1e9:.1f} TFLOP/s; "
          f"plain {plain_ms:.3f} ms; max|err| y {ey:.2e} state {es:.2e}"
          f"{rounded_note(rounded)}")
    print(f"[{phase}-kernel] ssd warm, per CUDA kernel: "
          + ", ".join(f"{k.split('::')[-1]} {v:.1f} us" for k, v in passes.items()))


def layer0_flash(fa_kernel, args, launches, report, entries, arch, phase="serve") -> None:
    """The flash-attention kernel on the inputs of ``arch``'s first
    attention call: parity with the plain version, time beside the bound,
    the plain version and ``scaled_dot_product_attention`` on the same
    tensors transposed to (B, H, S, Dh) outside the timed call."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as tfa

    q, k, v, causal = args
    B, Sq, H, Dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    tol = FLASH_TOL["bfloat16" if q.dtype == torch.bfloat16 else "float32"]
    out = fa_kernel(q, k, v, causal)
    want = tfa.ref.attention_ref(q, k, v, causal)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), want.float(), rtol=tol, atol=tol)
    err = float((out.float() - want.float()).abs().max())
    instance = tfa.select_instance(q, k, v)
    rounded = flash_rounded(f"flash_attention, {arch}'s first call", instance,
                            out, q, k, v, causal)
    G = H // KV
    qt = q.transpose(1, 2).contiguous()
    kt = k.repeat_interleave(G, dim=2).transpose(1, 2).contiguous()
    vt = v.repeat_interleave(G, dim=2).transpose(1, 2).contiguous()

    def library():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)

    torch.testing.assert_close(library().transpose(1, 2).float(), want.float(),
                               rtol=tol, atol=tol)
    item = q.element_size()
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * item
    # the function's work: q.k and p.v (2 FLOP each per element of Dh) on
    # every (query, key) pair the mask keeps
    kept = (sum(min(i + 1, Sk) for i in range(Sq)) if causal else Sq * Sk)
    flops = B * H * kept * 4 * Dh
    # what the instance executes: whole (query rows x key tile) score tiles
    # up to the diagonal, 64 query rows per warpgroup (tensor cores) or per
    # CTA (CUDA cores)
    key_tile = tfa.TENSOR_CORE_KEY_TILE[Dh] if instance == "tensor_core" else tfa.KEY_TILE
    n_k = -(-Sk // key_tile)
    tiles = sum(min(n_k, (min(r0 + 64, Sq) - 1) // key_tile + 1) if causal else n_k
                for r0 in range(0, Sq, 64))
    kernel_flops = B * H * tiles * 64 * key_tile * 4 * Dh
    peak = BF16_FLOPS if q.dtype == torch.bfloat16 else F32_FLOPS
    bound = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "operations": flops / peak * 1e3}
    bound_by = max(bound, key=bound.get)
    times = cold_ms({"kernel": lambda: fa_kernel(q, k, v, causal),
                     "plain": lambda: tfa.ref.attention_ref(q, k, v, causal),
                     "library": library}, 20)
    ms, plain_ms, library_ms = times["kernel"], times["plain"], times["library"]
    report["flash_layer0"] = {
        "shape": (B, Sq, Sk, H, KV, Dh, causal), "dtype": str(q.dtype),
        "instance": instance, "bytes": nbytes, "flops": flops,
        "kernel_flops": kernel_flops, "bound_ms": bound[bound_by],
        "bound_by": bound_by, "ms": ms, "plain_ms": plain_ms,
        "library_ms": library_ms, "max_abs_err": err, "rounded": rounded}
    entries.append({"name": f"flash_attention[{arch}]", "route": "cuda", "source": FLASH_SOURCE,
                    "replaces": FLASH_REPLACES, "launches": launches["flash_attention"],
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound[bound_by], "bound_by": bound_by,
                    "library_ms": library_ms})
    print(f"[{phase}-kernel] flash_attention [{arch}] {(B, Sq, Sk, H, KV, Dh)} causal {causal} "
          f"{q.dtype} ({instance}) {ms:.4f} ms, bound {bound[bound_by]:.4f} ms ({bound_by}; "
          f"{nbytes / 1e6:.1f} MB, needs {flops / 1e9:.2f} GFLOP, executes "
          f"{kernel_flops / 1e9:.2f}) at {kernel_flops / ms / 1e9:.1f} TFLOP/s; "
          f"plain {plain_ms:.4f} ms; "
          f"scaled_dot_product_attention {library_ms:.4f} ms; max|err| {err:.2e}"
          f"{rounded_note(rounded)}")


def continuity(report, arch: str) -> None:
    """float32 at full width: the last logits of a 512-token prefill equal
    those of a 256-token prefill followed by 256 decode steps, which holds
    the SSD kernel's final state, the conv state and (hybrid, dense) the
    attention k/v cache against plain decode."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.models import build_model

    cfg = get_config(arch).replace(dtype="float32")
    model = build_model(cfg, device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(SEED + 1))
    toks = torch.from_numpy(TokenPipeline(DataConfig(cfg.vocab, 512, 2, seed=SEED + 1))
                            .batch_at(0)["tokens"]).long().cuda()
    t0 = time.perf_counter()
    full, _ = model.prefill({"tokens": toks})
    _, cache = model.prefill({"tokens": toks[:, :256]}, max_len=512)
    for t in range(256, 512):
        logits, cache = model.decode_step(toks[:, t], cache)
    torch.cuda.synchronize()
    err = float((logits - full).abs().max())
    report["continuity"] = {"max_abs_err": err, "tol": CONTINUITY_TOL,
                            "logit_absmax": float(full.abs().max()),
                            "seconds": time.perf_counter() - t0}
    print(f"[continuity] f32 {arch}: prefill 512 vs prefill 256 + 256 decode steps, "
          f"max|err| logits {err:.2e} (|logits| <= {float(full.abs().max()):.2f}, "
          f"tolerance {CONTINUITY_TOL})")
    torch.testing.assert_close(logits, full, rtol=CONTINUITY_TOL, atol=CONTINUITY_TOL)


def serving_path(arch, kernels, report, entries) -> None:
    """Phases 5-7.  The small-input check runs first and also warms the
    card (cuBLAS, the kernels' modules) before the timed full-width runs.
    Entries other than Mamba-2's carry the arch in their name; the
    enc-dec's two flash entries are its first encoder (non-causal) and
    its first decoder call."""
    import torch

    from repro_torch.configs import get_config

    cfg = get_config(arch)
    # every SSD and flash-attention call of the served run on its tensor-core
    # instance, none on the CUDA-core one, and no launch of another kernel;
    # one prefill's launches in all, so none in the decode steps
    want = {}
    if cfg.family in ("ssm", "hybrid"):
        want = {"conv1d_shuffle_w4": cfg.n_layers, "ssd": cfg.n_layers,
                "ssd/tensor_core": cfg.n_layers, "gated_norm": cfg.n_layers}
    n_attn = flash_per_forward(cfg)
    if n_attn:
        want["flash_attention"] = want["flash_attention/tensor_core"] = n_attn
    tag = "" if arch == MAMBA else f"[{arch}]"
    rec = report.setdefault("serving", {}).setdefault(arch, {})
    reduced_card_vs_cpu(rec, arch)
    launches, captured = serve_run(rec, arch, want)
    if "conv" in captured:
        layer0_conv1d(kernels["conv"], captured.pop("conv"), launches, rec, entries,
                      "conv1d_shuffle" + tag)
    if "ssd" in captured:
        layer0_ssd(kernels["ssd"], captured.pop("ssd"), launches, rec, entries, "ssd" + tag)
    if cfg.family == "audio":
        for causal, part in ((False, "encoder"), (True, "decoder")):
            layer0_flash(kernels["flash"], captured.pop(("flash", causal)), launches,
                         rec.setdefault(part, {}), entries, f"{arch} {part}")
    elif "flash" in captured:
        layer0_flash(kernels["flash"], captured.pop("flash"), launches, rec, entries, arch)
    captured.clear()
    torch.cuda.empty_cache()
    if arch in CONTINUITY_ARCHS:
        continuity(rec, arch)
    torch.cuda.empty_cache()


def zamba2_7b_flash(fa_kernel, args, launches, report, entries) -> None:
    """The flash kernel on the first shared-attention call of the 8 x 4096
    prefill, Dh 224 at Zamba2's scale: parity with ``attention_ref`` one
    batch row at a time (the whole batch's float32 scores would take
    17 GB), time beside the bound and ``scaled_dot_product_attention``."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as tfa

    q, k, v, causal, scale = args
    B, S, H, Dh = q.shape
    instance = tfa.select_instance(q, k, v)
    if instance != "tensor_core":
        raise RuntimeError(f"zamba2-7b flash {tuple(q.shape)}: {instance} instance")
    tol = FLASH_TOL["bfloat16"]
    out = fa_kernel(q, k, v, causal, scale)
    err = 0.0
    for b in range(B):
        want = tfa.ref.attention_ref(q[b:b + 1], k[b:b + 1], v[b:b + 1], causal, scale=scale)
        torch.testing.assert_close(out[b:b + 1].float(), want.float(), rtol=tol, atol=tol)
        err = max(err, float((out[b:b + 1].float() - want.float()).abs().max()))
        del want
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    nbytes = 4 * q.numel() * q.element_size()
    flops = B * H * (S * (S + 1) // 2) * 4 * Dh
    bound = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3, "operations": flops / BF16_FLOPS * 1e3}
    bound_by = max(bound, key=bound.get)
    times = cold_ms({"kernel": lambda: fa_kernel(q, k, v, causal, scale),
                     "library": lambda: F.scaled_dot_product_attention(
                         qt, kt, vt, is_causal=causal, scale=scale)}, 10)
    ms, library_ms = times["kernel"], times["library"]
    report["flash"] = {"shape": (B, S, H, Dh), "scale": scale, "instance": instance,
                       "bytes": nbytes, "flops": flops, "bound_ms": bound[bound_by],
                       "bound_by": bound_by, "ms": ms, "library_ms": library_ms,
                       "max_abs_err": err}
    entries.append({"name": f"flash_attention[{ZAMBA2_7B}]", "route": "cuda",
                    "source": FLASH_SOURCE, "replaces": FLASH_REPLACES,
                    "launches": launches["flash_attention"], "max_abs_err": err, "ms": ms,
                    "plain_ms": None, "bound_ms": bound[bound_by], "bound_by": bound_by,
                    "library_ms": library_ms})
    print(f"[zamba2-7b-kernel] flash_attention {(B, S, H, Dh)} causal {causal} scale "
          f"{scale:.5f} {q.dtype} ({instance}) {ms:.4f} ms, bound {bound[bound_by]:.4f} ms "
          f"({bound_by}; {100 * bound[bound_by] / ms:.1f} %); scaled_dot_product_attention "
          f"{library_ms:.4f} ms; max|err| {err:.2e} over {B} rows against attention_ref")


def zamba2_7b_prefill(kernels, report, entries) -> None:
    """Phase 7b.  ``zamba2-7b`` at its published widths (random weights
    from a seed) through ``serve.step.generate``: after a warm-up, launch
    counts zeroed just before one prefill of ``ZAMBA2_7B_BATCH`` tokens
    and required to be one conv1d and one SSD (tensor cores) per mixer and
    one flash call (tensor cores) per application and one tail kernel per
    mixer, nothing else; that prefill's first conv1d, SSD, flash and tail
    calls captured and held against the plain versions, then timed beside
    their bounds."""
    import torch

    import repro_torch.models.mamba2 as m2
    import repro_torch.models.zamba2 as z2
    from repro_torch.configs import get_config
    from repro_torch.kernels import conv1d as tconv
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.kernels import gated_norm as tgn
    from repro_torch.kernels import ssd as tssd
    from repro_torch.models import build_model
    from repro_torch.serve import step

    cfg = get_config(ZAMBA2_7B)
    B, L = ZAMBA2_7B_BATCH
    apps = len(cfg.hybrid_layer_ids)
    want = {"conv1d_shuffle_w4": cfg.n_layers, "ssd": cfg.n_layers,
            "ssd/tensor_core": cfg.n_layers, "flash_attention": apps,
            "flash_attention/tensor_core": apps, "gated_norm": cfg.n_layers}
    rec = report.setdefault("serving", {}).setdefault(ZAMBA2_7B, {})
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    model = build_model(cfg, device="cuda", generator=gen)
    tokens = torch.randint(0, cfg.vocab, (B, L), generator=gen, device="cuda")
    t0 = time.perf_counter()
    step.generate(model, {"tokens": tokens[:, :512]}, 1)     # cuBLAS and kernel modules
    torch.cuda.synchronize()
    print(f"[zamba2-7b] warm-up: a {B} x 512 prefill after start-up took "
          f"{1e3 * (time.perf_counter() - t0):.1f} ms")
    captured = {}
    real = (m2.causal_conv1d, m2.ssd, z2.flash_attention, m2.gated_norm_tail)

    def capture_conv(x, w, b, mode="shuffle", activation=True):
        captured.setdefault("conv", (x, w.detach(), b.detach()))
        return real[0](x, w, b, mode=mode, activation=activation)

    def capture_ssd(xh, dt, A, Bm, Cm, chunk):
        captured.setdefault("ssd", (xh, dt, A, Bm, Cm, chunk))
        return real[1](xh, dt, A, Bm, Cm, chunk)

    def capture_flash(q, k, v, causal=True, scale=None):
        captured.setdefault("flash", (q, k, v, causal, scale))
        return real[2](q, k, v, causal=causal, scale=scale)

    def capture_tail(*args):
        captured.setdefault("tail", args)
        return real[3](*args)

    m2.causal_conv1d, m2.ssd, z2.flash_attention, m2.gated_norm_tail = (
        capture_conv, capture_ssd, capture_flash, capture_tail)
    for mod in (tconv, tssd, tfa, tgn):
        mod.reset_launch_counts()
    times = {}
    try:
        out = step.generate(model, {"tokens": tokens}, 1, times=times)
    finally:
        m2.causal_conv1d, m2.ssd, z2.flash_attention, m2.gated_norm_tail = real
    counts = {**tconv.launch_counts(), **tssd.launch_counts(), **tssd.instance_counts(),
              **tfa.launch_counts(), **tfa.instance_counts(), **tgn.launch_counts()}
    launches = {k: n for k, n in counts.items() if n}
    if launches != want:
        raise RuntimeError(f"zamba2-7b prefill: launches {launches}, expected {want}")
    if out.shape != (B, 1) or out.min() < 0 or out.max() >= cfg.vocab:
        raise RuntimeError(f"zamba2-7b prefill: tokens {tuple(out.shape)} out of range")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    rec.update({"prefill_ms": 1e3 * times["prefill_s"], "launches": launches,
                "peak_gib": peak})
    print(f"[zamba2-7b] prefill {B} x {L}: {1e3 * times['prefill_s']:.1f} ms, peak "
          f"{peak:.2f} GiB; launches " + " ".join(f"{k} {n}" for k, n in launches.items()))
    del model, out, tokens
    torch.cuda.empty_cache()
    layer0_conv1d(kernels["conv"], captured.pop("conv"), launches, rec, entries,
                  f"conv1d_shuffle[{ZAMBA2_7B}]", phase="zamba2-7b")
    Bm = captured["ssd"][3]
    if Bm.shape[2] != cfg.ssm_groups:
        raise RuntimeError(f"zamba2-7b ssd: {Bm.shape[2]} B/C groups, expected {cfg.ssm_groups}")
    layer0_ssd(kernels["ssd"], captured.pop("ssd"), launches, rec, entries,
               f"ssd[{ZAMBA2_7B}]", phase="zamba2-7b")
    zamba2_7b_flash(kernels["flash"], captured.pop("flash"), launches, rec, entries)
    layer0_tail(captured.pop("tail"), launches, rec, entries, f"gated_norm[{ZAMBA2_7B}]",
                phase="zamba2-7b")
    torch.cuda.empty_cache()


def layer0_tail(args, launches, report, entries, name, phase) -> None:
    """The mixer's tail kernel on the first mixer's operands of a prefill,
    as the mixer passes them (xh and z column ranges of the conv output and
    the in-projection): against the plain tail on the card (bf16 ulps, the
    share of bit-identical elements), time beside its bound (y, xh, z read
    and the output written once, the scale and D) and the plain tail."""
    import torch

    from repro_torch.kernels import gated_norm as tgn

    y, xh, z, d_skip, scale, groups, eps, dtype = args
    B, L, H, P = xh.shape
    C = H * P
    kernel = tgn.build_kernel()
    with torch.inference_mode():             # the captured operands are inference tensors
        got = kernel(*args)
        c = tgn.ref.compare_bf16(got, y, xh, z, d_skip, scale, groups, eps)
    if c["differ_off_tie"] or c["sign_flips"] or c["max_ulps"] > tgn.ref.TIE_MOVE_ULPS:
        raise RuntimeError(f"gated_norm ({name}) against the plain tail: {c}")
    del got
    item = xh.element_size()
    nbytes = 4 * B * L * C * item + C * item + H * 4
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    with torch.inference_mode():
        times = cold_ms({"kernel": lambda: kernel(*args),
                         "plain": lambda: tgn.ref.gated_norm_tail(*args)}, 10)
    ms, plain_ms = times["kernel"], times["plain"]
    report["tail_layer0"] = {"shape": (B, L, C, groups), "dtype": str(dtype),
                             "strides": {"xh": xh.stride(), "z": z.stride()},
                             "bytes": nbytes, "bound_ms": bound_ms, "ms": ms,
                             "plain_ms": plain_ms, "against_plain": c}
    entries.append({"name": name, "route": "cuda", "source": TAIL_SOURCE,
                    "replaces": TAIL_REPLACES, "launches": launches["gated_norm"],
                    "max_ulps": c["max_ulps"], "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None})
    print(f"[{phase}-kernel] gated_norm {(B, L, C)} G {groups} {dtype} (xh row "
          f"{xh.stride(1)}, z row {z.stride(1)} elements) {ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"(bytes, {nbytes / 1e9:.3f} GB; {100 * bound_ms / ms:.1f} %); plain "
          f"{plain_ms:.3f} ms; {launches['gated_norm']} launches per prefill; "
          f"bit-identical {100 * c['bit_identical']:.4f} %, max {c['max_ulps']} ulp "
          f"({c['differ']} of {c['groups']} row-groups differ, {c['near_tie']} near a tie)")


def mamba2_tail_prefill(report, entries) -> None:
    """Phase 7c.  ``mamba2-1.3b`` at its published widths through
    ``serve.step.generate``: after a warm-up, launch counts zeroed just
    before one prefill of ``MAMBA_TAIL_BATCH`` tokens (the
    mamba2-1.3b.prefill-pool cell's largest batch) and required to be one
    conv1d, one SSD and one tail kernel per mixer, nothing else; that
    prefill's first tail call held against the plain tail and timed."""
    import torch

    import repro_torch.models.mamba2 as m2
    from repro_torch.configs import get_config
    from repro_torch.kernels import conv1d as tconv
    from repro_torch.kernels import gated_norm as tgn
    from repro_torch.kernels import ssd as tssd
    from repro_torch.models import build_model
    from repro_torch.serve import step

    cfg = get_config(MAMBA)
    B, L = MAMBA_TAIL_BATCH
    want = {"conv1d_shuffle_w4": cfg.n_layers, "ssd": cfg.n_layers,
            "ssd/tensor_core": cfg.n_layers, "gated_norm": cfg.n_layers}
    rec = report.setdefault("serving", {}).setdefault(f"{MAMBA} {B}x{L}", {})
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    model = build_model(cfg, device="cuda", generator=gen)
    tokens = torch.randint(0, cfg.vocab, (B, L), generator=gen, device="cuda")
    step.generate(model, {"tokens": tokens[:, :512]}, 1)      # cuBLAS and kernel modules
    captured, real = {}, m2.gated_norm_tail

    def capture_tail(*args):
        captured.setdefault("tail", args)
        return real(*args)

    m2.gated_norm_tail = capture_tail
    for mod in (tconv, tssd, tgn):
        mod.reset_launch_counts()
    times = {}
    try:
        step.generate(model, {"tokens": tokens}, 1, times=times)
    finally:
        m2.gated_norm_tail = real
    counts = {**tconv.launch_counts(), **tssd.launch_counts(), **tssd.instance_counts(),
              **tgn.launch_counts()}
    launches = {k: n for k, n in counts.items() if n}
    if launches != want:
        raise RuntimeError(f"{MAMBA} {B} x {L} prefill: launches {launches}, expected {want}")
    rec.update({"prefill_ms": 1e3 * times["prefill_s"], "launches": launches})
    print(f"[mamba2-tail] prefill {B} x {L}: {1e3 * times['prefill_s']:.1f} ms; launches "
          + " ".join(f"{k} {n}" for k, n in launches.items()))
    del model, tokens
    torch.cuda.empty_cache()
    layer0_tail(captured.pop("tail"), launches, rec, entries, "gated_norm",
                phase="mamba2-tail")
    torch.cuda.empty_cache()


def adamw_full_set(report, entries) -> None:
    """Phase 7d.  AdamW over ``mamba2-1.3b``'s parameters at its published
    widths, with random gradients of the parameters' dtypes large enough
    to clip: one update through ``adamw_update`` (the kernel) against the
    plain update on the card, m, v and p bit for bit given the kernel's
    scale; then the kernel and the plain update (``adamw_update`` with the
    card among the plain devices) timed in turns, the kernel's device
    operations read from a trace and the host's enqueue time taken."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.interop import reference_ndims
    from repro_torch.kernels import adamw as tadam
    from repro_torch.models import build_model
    from repro_torch.train import optim

    cfg = get_config(MAMBA)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    model = build_model(cfg, device="cuda", generator=gen)
    params = dict(model.named_parameters())
    ndims = reference_ndims(cfg, params)
    grads = {k: (1e-3 * torch.randn(p.shape, generator=gen, device="cuda")).to(p.dtype)
             for k, p in params.items()}
    opt = optim.OptConfig()
    state = optim.init_opt_state(params)
    n = sum(p.numel() for p in params.values())
    tadam.build_kernel()

    # one update, held against the plain update on the card
    p0 = {k: p.detach().clone() for k, p in params.items()}
    mu0 = {k: m.clone() for k, m in state.mu.items()}
    nu0 = {k: v.clone() for k, v in state.nu.items()}
    tadam.reset_launch_counts()
    _, _, met = optim.adamw_update(opt, grads, state, params, ndims)
    torch.cuda.synchronize()
    launches = tadam.launch_counts()
    if launches != {"adamw": 3}:
        raise RuntimeError(f"adamw: launches {launches}, expected 3")
    gnorm = met["grad_norm"]
    scale = torch.clamp(opt.clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    steps = (state.count + 1).float()
    b1c, b2c = 1 - opt.b1 ** steps, 1 - opt.b2 ** steps
    with torch.no_grad():
        for k in params:
            tadam.ref.adamw_tensor(opt, p0[k], grads[k], mu0[k], nu0[k], scale, met["lr"],
                                   b1c, b2c, ndims[k] >= 2)
    differ = [k for k, p in params.items() if not (
        torch.equal(p, p0[k]) and torch.equal(state.mu[k], mu0[k])
        and torch.equal(state.nu[k], nu0[k]))]
    exact = sum(float(torch.sum(g.double() ** 2)) for g in grads.values()) ** 0.5
    plain_norm = float(optim.global_norm(grads[k] for k in params))
    del p0, mu0, nu0
    torch.cuda.empty_cache()
    if differ:
        raise RuntimeError(f"adamw: {len(differ)} tensors differ from the plain update, "
                           f"first {differ[:4]}")
    norm_rel = abs(float(gnorm) - exact) / exact
    if norm_rel > 1e-6:
        raise RuntimeError(f"adamw: norm {float(gnorm)} against float64 {exact}")

    def kernel_step():
        optim.adamw_update(opt, grads, state, params, ndims)

    def plain_step():
        real = optim.PLAIN_DEVICES
        optim.PLAIN_DEVICES = real + ("cuda",)
        try:
            optim.adamw_update(opt, grads, state, params, ndims)
        finally:
            optim.PLAIN_DEVICES = real

    times = cold_ms({"kernel": kernel_step, "plain": plain_step}, 6)
    ms, plain_ms = times["kernel"], times["plain"]
    ops_us = kernel_times(kernel_step, "adamw", n=3)
    host_ms = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        kernel_step()
        host_ms.append(1e3 * (time.perf_counter() - t0))
    torch.cuda.synchronize()
    nbytes = sum(p.numel() * (2 * grads[k].element_size() + 2 * p.element_size() + 16)
                 for k, p in params.items())
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    kernel_ms = {k: us / 1e3 for k, us in ops_us.items() if "adamw::" in k}
    report["adamw"] = {"arch": MAMBA, "tensors": len(params), "parameters": n,
                       "bytes": nbytes, "bound_ms": bound_ms, "ms": ms, "plain_ms": plain_ms,
                       "kernels_ms": kernel_ms, "device_ops": len(ops_us),
                       "host_enqueue_ms": statistics.median(host_ms), "norm_rel": norm_rel,
                       "plain_norm_rel": abs(plain_norm - exact) / exact}
    entries.append({"name": "adamw", "route": "cuda", "source": ADAMW_SOURCE,
                    "replaces": ADAMW_REPLACES, "launches": launches["adamw"], "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
                    "library_ms": None})
    print(f"[adamw] {MAMBA}: {len(params)} tensors, {n} parameters; m, v and p bit for bit "
          f"the plain update's; norm {float(gnorm):.6f} ({norm_rel:.2e} of float64; plain "
          f"{report['adamw']['plain_norm_rel']:.2e})")
    print(f"[adamw] update {ms:.3f} ms, bound {bound_ms:.3f} ms (bytes, {nbytes / 1e9:.2f} "
          f"GB; {100 * bound_ms / ms:.1f} %); plain {plain_ms:.3f} ms; host enqueue "
          f"{statistics.median(host_ms):.3f} ms; device operations "
          + ", ".join(f"{k.split('(')[0]} {us / 1e3:.3f} ms" for k, us in ops_us.items()))
    del model, params, grads, state
    torch.cuda.empty_cache()


def reduced_train_card_vs_cpu(report, arch: str) -> None:
    """One train step of the reduced model in float32 on the card (every
    kernel, through its autograd Function, blocks recomputed) against the
    plain path on the CPU (no recomputation) from the same weights."""
    import numpy as np
    import torch

    from repro_torch.kernels import conv1d as tconv
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.kernels import gated_norm as tgn
    from repro_torch.kernels import ssd as tssd
    from repro_torch.train import OptConfig, init_opt_state, make_train_step
    from repro_torch.train.optim import first_step_bound

    rcfg, cpu, gpu = reduced_pair(arch, remat="block")
    rng = np.random.default_rng(SEED)
    toks = torch.from_numpy(rng.integers(0, rcfg.vocab, (4, 48)))
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, dims=1),
             **stub_batch(rcfg, 4, rng, "cpu")}
    grads, counts = {}, {}
    for side, m in (("cpu", cpu), ("card", gpu)):
        for mod in (tconv, tssd, tfa, tgn):
            mod.reset_launch_counts()
        params = dict(m.named_parameters())
        loss, _ = m.loss(batch)
        grads[side] = {k: g.detach().cpu() for k, g in
                       zip(params, torch.autograd.grad(loss, list(params.values())))}
        counts[side] = {k: n for k, n in {**tconv.launch_counts(), **tssd.launch_counts(),
                                          **tfa.launch_counts(),
                                          **tgn.launch_counts()}.items() if n}
    gerr = max(float((grads["card"][k] - g).abs().max() / g.abs().max())
               for k, g in grads["cpu"].items())
    if gerr > TRAIN_TOL:
        raise RuntimeError(f"reduced {arch}: gradients card vs CPU differ by {gerr:.2e} "
                           f"of their leaves' largest")
    if rcfg.family != "hybrid":     # forward + recompute per block
        want = ({"conv1d_shuffle_w4": 2 * rcfg.n_layers, "ssd": 2 * rcfg.n_layers,
                 "gated_norm": 2 * rcfg.n_layers}
                if rcfg.family == "ssm" else {"flash_attention": 2 * flash_per_forward(rcfg)})
        if counts["card"] != want:
            raise RuntimeError(f"reduced {arch}: launches per loss + gradient "
                               f"{counts['card']}, expected {want}")
    opt = OptConfig(lr=TRAIN["lr"], warmup_steps=2, total_steps=10)
    old = {k: p.detach().clone() for k, p in cpu.named_parameters()}
    mets = {}
    for side, m in (("cpu", cpu), ("card", gpu)):
        _, met = make_train_step(m, opt)(init_opt_state(dict(m.named_parameters())), batch)
        mets[side] = {k: float(v) for k, v in met.items()}
    rel = {k: abs(mets["card"][k] - mets["cpu"][k]) / abs(mets["cpu"][k])
           for k in ("loss", "grad_norm")}
    if max(rel.values()) > TRAIN_TOL:
        raise RuntimeError(f"reduced {arch}: train step card vs CPU {mets}")
    scale = min(1.0, 1.0 / mets["cpu"]["grad_norm"])
    card = dict(gpu.named_parameters())
    ratio = max(float(((card[k].detach().cpu().double() - p.detach().double()).abs()
                       / first_step_bound(old[k], p.detach(), grads["cpu"][k], scale,
                                          mets["cpu"]["lr"], TRAIN_TOL)).max())
                for k, p in cpu.named_parameters())
    if ratio > 1.0:
        raise RuntimeError(f"reduced {arch}: parameters after the step card vs CPU at "
                           f"{ratio:.2f} of the bound")
    report["reduced_train"] = {"grad_rel_err": gerr, "loss_rel_err": rel["loss"],
                               "grad_norm_rel_err": rel["grad_norm"],
                               "param_err_of_bound": ratio, "launches": counts["card"]}
    print(f"[train] reduced {arch} ({rcfg.n_layers} layers, f32) one step on the card "
          f"(blocks recomputed; launches for loss + gradient {counts['card']}) vs plain on "
          f"the CPU: gradients {gerr:.2e} of each leaf's largest, loss {rel['loss']:.2e}, "
          f"grad norm {rel['grad_norm']:.2e} relative, parameters at {ratio:.2e} of the "
          f"AdamW first-step bound")


def reduced_training_falls(report):
    """``tests/test_train_integration.py::test_training_reduces_loss`` on the
    card: reduced OLMo, 40 steps of 8 x 64 tokens at lr 3e-3; returns the
    trained model, its optimizer state and config."""
    import torch

    from repro_torch.configs import get_config, reduced
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.models import build_model
    from repro_torch.train import OptConfig, init_opt_state, make_train_step

    rcfg = reduced(get_config("olmo-1b"))
    model = build_model(rcfg, device="cuda")
    step = make_train_step(model, OptConfig(lr=3e-3, warmup_steps=3, total_steps=40))
    state = init_opt_state(dict(model.named_parameters()))
    pipe = TokenPipeline(DataConfig(vocab=rcfg.vocab, seq_len=64, global_batch=8))
    losses = []
    for s in range(40):
        state, m = step(state, {k: torch.from_numpy(v).long().cuda()
                                for k, v in pipe.batch_at(s).items()})
        losses.append(float(m["loss"]))
    report["reduced_40_steps"] = {"first_loss": losses[0], "last_loss": losses[-1]}
    print(f"[train] reduced olmo-1b on the card, 40 steps of 8 x 64 tokens: loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}")
    if not losses[-1] < losses[0] - 0.5:
        raise RuntimeError(f"reduced olmo-1b: the loss fell from {losses[0]:.4f} only to "
                           f"{losses[-1]:.4f}")
    return model, state, rcfg


def checkpoint_round_trip(report, model, state, rcfg) -> None:
    """The trained reduced state (float32) and a reduced bf16 Mamba-2's
    saved from the card, restored onto the card into fresh models: every
    parameter, moment and count bitwise equal."""
    import shutil

    import torch

    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.configs import get_config, reduced
    from repro_torch.interop import load_train_state, train_state_tree
    from repro_torch.models import build_model
    from repro_torch.train import init_opt_state

    root = os.path.join(ROOT, "build", "smoke_checkpoints")
    shutil.rmtree(root, ignore_errors=True)
    bcfg = reduced(get_config(MAMBA)).replace(dtype="bfloat16")
    bmodel = build_model(bcfg, device="cuda")
    bstate = init_opt_state(dict(bmodel.named_parameters()))
    leaves = 0
    try:
        for i, (cfg, m, st) in enumerate(((rcfg, model, state), (bcfg, bmodel, bstate))):
            store = CheckpointStore(os.path.join(root, str(i)))
            store.save(40, train_state_tree(cfg, m, st), extra={"data_step": 40})
            fresh = build_model(cfg, device="cuda",
                                generator=torch.Generator(device="cuda").manual_seed(SEED + 5))
            fst = init_opt_state(dict(fresh.named_parameters()))
            step, tree, extra = store.restore_latest(train_state_tree(cfg, fresh, fst))
            fst = load_train_state(cfg, fresh, fst, tree)
            pairs = [(p, q) for (_, p), (_, q) in zip(m.named_parameters(),
                                                      fresh.named_parameters())]
            pairs += [(st.mu[k], fst.mu[k]) for k in st.mu] + [(st.nu[k], fst.nu[k])
                                                               for k in st.nu]
            pairs.append((st.count, fst.count))
            if (step, extra) != (40, {"data_step": 40}) or not all(
                    q.device.type == "cuda" and p.dtype == q.dtype and torch.equal(p, q)
                    for p, q in pairs):
                raise RuntimeError(f"checkpoint round trip of reduced {cfg.name} "
                                   f"({cfg.dtype}) is not bitwise")
            leaves += len(pairs)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    report["checkpoint_round_trip_tensors"] = leaves
    print(f"[train] checkpoint round trip on the card (reduced olmo-1b f32 after 40 "
          f"steps, reduced mamba2-1.3b bf16): {leaves} tensors bitwise equal")


def train_split(model, step, state, batch, arch: str, moe: bool = False):
    """Device time of one warm full-width train step by family, from a
    ``torch.profiler`` trace (CPU and CUDA activity), beside the step's
    wall time measured without the profiler: the port's kernels (forward
    and the backward's recompute), the kernels' plain-autograd backward
    (the ``repro::autograd.backward`` ranges the program opens in
    ``PlainGrad.backward``; the SSD's backward kernels inside the same
    ranges count as the port's kernels), cuBLAS elsewhere, the optimizer (in ``smoke::adamw_update``)
    and other kernels.  A range leaves a device-side annotation spanning
    the kernels launched inside it; a kernel belongs to the range whose
    span holds its start (one stream, so spans hold nothing else).
    With ``moe`` the sharded MoE dispatch (``moe.apply_moe_sharded``, in a
    ``smoke::moe`` range: routing, buffers and expert products, in the
    forward and in the backward's recompute) is a family of its own.
    Returns the split, the state and the launches of the traced step."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import record_function

    import repro_torch.models.moe as moem

    from repro_torch.kernels import conv1d as tconv
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.kernels import gated_norm as tgn
    from repro_torch.kernels import ssd as tssd

    port = ("ssd_tc::", "ssd::", "ssd_bwd::", "flash_tc::", "flash::", "conv1d_", "gated_norm::")
    gemm = ("gemm", "xmma", "cutlass", "nvjet", "sm90_")
    nccl = "nccl"                   # the mesh path's collectives (phase 9)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, _ = step(state, batch)
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    real_moe = moem.apply_moe_sharded

    def traced_moe(*args, **kwargs):
        with record_function("smoke::moe"):
            return real_moe(*args, **kwargs)

    def traced_step():
        nonlocal state
        for mod in (tconv, tssd, tfa, tgn):
            mod.reset_launch_counts()
        state, _ = step(state, batch)

    if moe:
        moem.apply_moe_sharded = traced_moe
    try:
        events = traced(traced_step, f"{arch} train step")
    finally:
        moem.apply_moe_sharded = real_moe
    launches = {k: n for k, n in {**tconv.launch_counts(), **tssd.launch_counts(),
                                  **tssd.instance_counts(), **tfa.launch_counts(),
                                  **tfa.instance_counts(), **tgn.launch_counts()}.items() if n}
    ranges = {"repro::autograd.backward": "plain_backward", "smoke::adamw_update": "optimizer",
              **({"smoke::moe": "moe"} if moe else {})}
    spans, kernels = [], []
    for e in events:
        if e.device_type != DeviceType.CUDA:
            continue
        if e.name in ranges:
            spans.append((e.time_range.start, e.time_range.end, ranges[e.name]))
        elif not e.name.startswith("repro::"):     # the program's other ranges hold no time
            kernels.append(e)
    if {f for *_, f in spans} != set(ranges.values()):
        raise RuntimeError(f"{arch}: the trace holds no device span of {sorted(ranges)}")
    split = dict.fromkeys(("kernels", "plain_backward", *(("moe",) if moe else ()), "cublas",
                           "optimizer", "nccl", "other"), 0.0)
    for e in kernels:
        t = e.time_range.start
        fam = ("kernels" if any(p in e.name for p in port) else
               next((f for a, b, f in spans if a <= t <= b), None)
               or ("nccl" if nccl in e.name.lower() else
                   "cublas" if any(g in e.name for g in gemm) else "other"))
        split[fam] += e.device_time_total / 1e3
    device_ms = sum(split.values())
    print(f"[trace] {arch} warm train step: wall {wall_ms:.1f} ms, device busy "
          f"{device_ms:.1f} ms ({100 * device_ms / wall_ms:.0f} %), idle "
          f"{wall_ms - device_ms:.1f} ms: " + ", ".join(f"{k} {v:.1f}" for k, v in split.items())
          + f" ms; {len(spans)} spans")
    if split["kernels"] <= 0 or split["plain_backward"] <= 0 or split["optimizer"] <= 0:
        raise RuntimeError(f"{arch}: the traced train step lacks a family: {split}")
    return {"wall_ms": wall_ms, "device_ms": device_ms, "by_family_ms": split}, state, launches


def function_gradients(captured, rec, label) -> dict:
    """Each kernel's autograd Function on its layer-0 inputs from training
    step 1 (conv1d's x as the column view of the in-projection it was):
    its output and its gradients against the plain version's autograd on
    the same inputs and a seeded cotangent, at the kernel's bf16
    tolerance; then the Function's backward timed (cold L2) beside the
    plain version's forward + backward.  Returns backward ms per kernel."""
    import numpy as np
    import torch

    from repro_torch.kernels import conv1d as tconv
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.kernels import ssd as tssd

    rng = np.random.default_rng(SEED)
    clone = lambda t: t.detach().clone().requires_grad_()
    cases = {}
    if "conv" in captured:
        x, w, b = captured["conv"]
        B, L, C = x.shape
        width = x.stride(1)
        col0 = x.storage_offset() % width
        if x.stride() != (L * width, width, 1):
            raise RuntimeError(f"conv1d: training's layer-0 input strides {x.stride()}")

        def conv_leaves():
            wide = torch.as_strided(x, (B, L, width), x.stride(),
                                    x.storage_offset() - col0).detach().clone()
            leaves = [wide.requires_grad_(), clone(w), clone(b)]
            return leaves, (leaves[0][..., col0:col0 + C], leaves[1], leaves[2])

        cases["conv1d"] = (tconv.causal_conv1d, tconv.ref.causal_conv1d, conv_leaves,
                           CONV_TOL)
    if "ssd" in captured:
        *args, Q = captured["ssd"]

        def ssd_leaves():
            leaves = [clone(t) for t in args]
            return leaves, tuple(leaves)

        cases["ssd"] = (lambda *a: tssd.ssd(*a, Q), lambda *a: tssd.ref.ssd_chunked(*a, Q),
                        ssd_leaves, SSD_TOL)
    if "flash" in captured:
        *qkv, causal = captured["flash"]

        def flash_leaves():
            leaves = [clone(t) for t in qkv]
            return leaves, tuple(leaves)

        cases["flash_attention"] = (lambda *a: tfa.flash_attention(*a, causal=causal),
                                    lambda *a: tfa.ref.attention_ref(*a, causal=causal),
                                    flash_leaves, FLASH_TOL)
    first = lambda o: o[0] if isinstance(o, tuple) else o
    out = {}
    for name, (entry, plain, leaves_fn, tols) in cases.items():
        leaves, inputs = leaves_fn()
        y = first(entry(*inputs))
        node = ("SSDFunctionBackward" if name == "ssd" and tssd.select_instance(
            inputs[0], inputs[3], inputs[4], Q) == "tensor_core" else "PlainGradBackward")
        if type(y.grad_fn).__name__ != node:
            raise RuntimeError(f"{name}: the entry point's output comes from {y.grad_fn}")
        cot = randn(y.shape, y.dtype, rng)
        got = torch.autograd.grad(y, leaves, cot, retain_graph=True)
        pleaves, pinputs = leaves_fn()
        py = first(plain(*pinputs))
        want = torch.autograd.grad(py, pleaves, cot)
        tol = tols["bfloat16" if inputs[0].dtype == torch.bfloat16 else "float32"]
        torch.testing.assert_close(y.float(), py.float(), rtol=tol, atol=tol)
        errs = []
        for g, wg in zip(got, want):
            torch.testing.assert_close(g.float(), wg.float(), rtol=tol, atol=tol)
            errs.append(float((g.float() - wg.float()).abs().max()))
        del got, want
        times = cold_ms({"backward": lambda: torch.autograd.grad(y, leaves, cot,
                                                                 retain_graph=True),
                         "plain_forward_backward": lambda: torch.autograd.grad(
                             first(plain(*pinputs)), pleaves, cot)}, 10)
        out[name] = {"shapes": [tuple(t.shape) for t in inputs], "grad_max_abs_err": errs,
                     "backward_ms": times["backward"],
                     "plain_forward_backward_ms": times["plain_forward_backward"]}
        print(f"[train-grad] {name} [{label}] Function on layer 0's inputs "
              f"{[tuple(t.shape) for t in inputs]}: gradients vs the plain version's "
              f"autograd max|err| {max(errs):.2e} (tolerance {tol}); backward ({node}) "
              f"{times['backward']:.4f} ms, plain forward + backward "
              f"{times['plain_forward_backward']:.4f} ms")
        del y, leaves, pleaves, inputs, pinputs, py
        torch.cuda.empty_cache()
    rec["function_gradients"] = out
    return out


def training_run(report, arch: str, kernels, entries) -> None:
    """``arch`` trained at full width through ``launch.train`` for
    ``TRAIN["steps"]`` steps, with launch counts read around the run and
    required to equal steps x (forward + recompute) per layer; the losses
    finite; every parameter's gradient at step 1 finite and not zero
    everywhere (read where the train step hands it to AdamW); the layer-0
    inputs of each kernel at step 1 captured for the kernel entries and
    the Function's gradient check; one more warm step traced."""
    import numpy as np
    import torch

    import repro_torch.models.attention as attn
    import repro_torch.models.mamba2 as m2
    import repro_torch.train.step as tstep
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.kernels import conv1d as tconv
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.kernels import gated_norm as tgn
    from repro_torch.kernels import ssd as tssd
    from repro_torch.kernels import stencil as tstencil
    from repro_torch.launch import train as ttrain
    from repro_torch.launch.serve import stub_inputs
    from repro_torch.train import OptConfig, init_opt_state, make_train_step

    cfg = get_config(arch)
    L, n_attn = cfg.n_layers, flash_per_forward(cfg)
    per_step = ({"conv1d_shuffle_w4": 2 * L, "ssd": 2 * L, "ssd/tensor_core": 2 * L,
                 "ssd_bwd": L, "ssd_bwd/tensor_core": L, "gated_norm": 2 * L}
                if cfg.family == "ssm" else
                {"flash_attention": 2 * n_attn, "flash_attention/tensor_core": 2 * n_attn})
    rec = report.setdefault("training", {}).setdefault(arch, {})
    captured, first = {}, {}
    real = (m2.causal_conv1d, m2.ssd, attn.flash_attention, tstep.adamw_update)

    def capture_conv(x, w, b, mode="shuffle", activation=True):
        captured.setdefault("conv", (x.detach(), w.detach(), b.detach()))
        return real[0](x, w, b, mode=mode, activation=activation)

    def capture_ssd(xh, dt, A, Bm, Cm, chunk):
        captured.setdefault("ssd", (*(t.detach() for t in (xh, dt, A, Bm, Cm)), chunk))
        return real[1](xh, dt, A, Bm, Cm, chunk)

    def capture_flash(q, k, v, causal=True):
        captured.setdefault("flash", (q.detach(), k.detach(), v.detach(), causal))
        return real[2](q, k, v, causal=causal)

    def adamw(cfg_, grads, state, params, ndims=None):
        if "grads" not in first:
            first["grads"] = {k: (bool(torch.isfinite(g).all()), float(g.abs().max()))
                              for k, g in grads.items()}
            # experts no token chose: their slices of the stacked expert
            # weights get no gradient
            first["idle_experts"] = sum(
                int((g.flatten(1).abs().amax(1) == 0).sum()) for k, g in grads.items()
                if k.endswith(".moe.w_gate"))
        with torch.profiler.record_function("smoke::adamw_update"):
            return real[3](cfg_, grads, state, params, ndims)

    argv = ["--arch", arch, "--device", "cuda", "--batch", str(TRAIN["batch"]),
            "--seq", str(TRAIN["seq"]), "--steps", str(TRAIN["steps"]),
            "--lr", str(TRAIN["lr"]), "--log-every", "1"]
    m2.causal_conv1d, m2.ssd, attn.flash_attention = capture_conv, capture_ssd, capture_flash
    tstep.adamw_update = adamw
    for mod in (tconv, tssd, tfa, tstencil, tgn):
        mod.reset_launch_counts()
    try:
        out = ttrain.main(argv)
        torch.cuda.synchronize()
        counts = {**tconv.launch_counts(), **tssd.launch_counts(), **tssd.instance_counts(),
                  **tfa.launch_counts(), **tfa.instance_counts(), **tstencil.launch_counts(),
                  **tgn.launch_counts()}
        want = {k: TRAIN["steps"] * n for k, n in per_step.items()}
        if {k: counts.get(k) for k in want} != want or \
                any(n for k, n in counts.items() if k not in want):
            raise RuntimeError(f"train {arch}: launches {counts}, expected {want}")
        launches = {k: n for k, n in counts.items() if n}
        losses = out["losses"]
        if len(losses) != TRAIN["steps"] or not all(np.isfinite(losses)):
            raise RuntimeError(f"train {arch}: losses {losses}")
        bad = [k for k, (finite, mx) in first["grads"].items() if not finite or mx == 0]
        if bad or len(first["grads"]) != len(list(out["model"].parameters())):
            raise RuntimeError(f"train {arch}: step 1 gradients non-finite or zero: {bad}")
        tokens = TRAIN["batch"] * TRAIN["seq"]
        rec.update({"losses": losses, "step_ms": out["step_ms"],
                    "tokens_per_s": tokens / (out["step_ms"] / 1e3), "peak_gib": out["peak_gib"],
                    "wall_s": out["wall_s"], "launches": launches,
                    "launches_per_step": per_step, "params_with_grad": len(first["grads"])})
        print(f"[train] {arch} at full width, {TRAIN['steps']} steps of {TRAIN['batch']} x "
              f"{TRAIN['seq']} tokens: step {out['step_ms']:.1f} ms (median after the "
              f"first), {rec['tokens_per_s']:.0f} tokens/s, peak {out['peak_gib']:.2f} GiB; "
              f"losses " + " ".join(f"{x:.4f}" for x in losses))
        if cfg.n_experts:
            rec["idle_experts_step1"] = first["idle_experts"]
            print(f"[train] {arch}: experts that no token chose at step 1 (a zero "
                  f"gradient slice): {first['idle_experts']} of {L * cfg.n_experts}")
        print(f"[train] {arch}: at step 1 all {len(first['grads'])} parameters have a "
              f"finite gradient, none zero everywhere; launches per step "
              + " ".join(f"{k} {n}" for k, n in per_step.items())
              + f" (forward + recompute per layer), {TRAIN['steps']} steps: "
              + " ".join(f"{k} {n}" for k, n in launches.items()))
        model = out.pop("model")
        del out
        pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=TRAIN["seq"],
                                        global_batch=TRAIN["batch"]))
        batch = {k: torch.from_numpy(v).long().cuda() for k, v in pipe.batch_at(0).items()}
        batch.update(stub_inputs(cfg, TRAIN["batch"], "cuda"))
        state = init_opt_state(dict(model.named_parameters()))
        step = make_train_step(model, OptConfig(lr=TRAIN["lr"], warmup_steps=5,
                                                total_steps=TRAIN["steps"]))
        rec["split"], state, traced = train_split(model, step, state, batch, arch)
        if traced != per_step:
            raise RuntimeError(f"train {arch}: the traced step launched {traced}, "
                               f"expected {per_step}")
        del model, state, step, batch
    finally:
        m2.causal_conv1d, m2.ssd, attn.flash_attention, tstep.adamw_update = real
    torch.cuda.empty_cache()
    label = f"{arch} train"
    if "conv" in captured:
        layer0_conv1d(kernels["conv"], captured["conv"], launches, rec, entries,
                      f"conv1d_shuffle[{label}]", phase="train")
    if "ssd" in captured:
        layer0_ssd(kernels["ssd"], captured["ssd"], launches, rec, entries,
                   f"ssd[{label}]", phase="train")
    if "flash" in captured:
        layer0_flash(kernels["flash"], captured["flash"], launches, rec, entries, label,
                     phase="train")
    function_gradients(captured, rec, label)
    captured.clear()
    torch.cuda.empty_cache()


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def mesh_train(report, mesh) -> None:
    """olmo-1b at published widths trained on the (1, 1) mesh through
    ``launch.train``'s mesh branch, against phase 8's run."""
    import numpy as np
    import torch

    import repro_torch.train.step as tstep
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.kernels import conv1d as tconv
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.kernels import ssd as tssd
    from repro_torch.launch import train as ttrain
    from torch.distributed.tensor import DTensor

    cfg, dev = get_config(MESH_ARCH), torch.device("cuda")
    before = report["training"][MESH_ARCH]
    per_step = 2 * flash_per_forward(cfg)
    rec = report.setdefault("mesh", {})
    grads_ok, real = [], tstep.adamw_update

    def adamw(cfg_, grads, state, params, ndims=None):
        grads_ok.append(all(bool(torch.isfinite(g.to_local() if isinstance(g, DTensor)
                                                else g).all()) for g in grads.values()))
        with torch.profiler.record_function("smoke::adamw_update"):
            return real(cfg_, grads, state, params, ndims)

    torch.cuda.reset_peak_memory_stats(dev)
    model, state, step = ttrain.build(cfg, dev, TRAIN["lr"], TRAIN["steps"], mesh=mesh)
    placed = sum(isinstance(p, DTensor) for p in model.parameters())
    if placed != len(list(model.parameters())):
        raise RuntimeError(f"mesh: {placed} of the parameters are DTensors")
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=TRAIN["seq"],
                                    global_batch=TRAIN["batch"]))
    for mod in (tconv, tssd, tfa):
        mod.reset_launch_counts()
    tstep.adamw_update = adamw
    losses, step_s = [], []
    try:
        for i in range(TRAIN["steps"]):
            batch = ttrain.batch_at(pipe, i, cfg, dev, mesh)
            t0 = time.time()
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))                # waits for the step
            step_s.append(time.time() - t0)
        torch.cuda.synchronize()
        counts = {**tconv.launch_counts(), **tssd.launch_counts(), **tssd.instance_counts(),
                  **tfa.launch_counts(), **tfa.instance_counts()}
        rec["split"], state, traced = train_split(
            model, step, state, ttrain.batch_at(pipe, 0, cfg, dev, mesh), f"{MESH_ARCH} mesh")
    finally:
        tstep.adamw_update = real
    want = {"flash_attention": TRAIN["steps"] * per_step,
            "flash_attention/tensor_core": TRAIN["steps"] * per_step}
    if {k: counts.get(k) for k in want} != want or any(
            n for k, n in counts.items() if k not in want):
        raise RuntimeError(f"mesh: launches {counts}, expected {want}")
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, before["losses"])]
    if len(losses) != len(before["losses"]) or not all(np.isfinite(losses)) or \
            max(rel) > MESH_LOSS_RTOL:
        raise RuntimeError(f"mesh: losses {losses} against phase 8's {before['losses']}")
    if traced != {k: n // TRAIN["steps"] for k, n in want.items()}:
        raise RuntimeError(f"mesh: the traced step launched {traced}")
    if len(grads_ok) != TRAIN["steps"] + 2 or not all(grads_ok):
        raise RuntimeError(f"mesh: a gradient is not finite ({grads_ok})")
    step_ms = 1e3 * statistics.median(step_s[1:])
    tokens = TRAIN["batch"] * TRAIN["seq"]
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    rec.update({"losses": losses, "loss_rel_vs_phase8": max(rel), "step_ms": step_ms,
                "tokens_per_s": tokens / (step_ms / 1e3), "peak_gib": peak,
                "launches_per_step": per_step, "phase8": {
                    k: before[k] for k in ("step_ms", "tokens_per_s", "peak_gib")}})
    print(f"[mesh] {MESH_ARCH} on the (1, 1) mesh at full width, {TRAIN['steps']} steps of "
          f"{TRAIN['batch']} x {TRAIN['seq']} tokens: step {step_ms:.1f} ms (phase 8 "
          f"{before['step_ms']:.1f}), {rec['tokens_per_s']:.0f} tokens/s (phase 8 "
          f"{before['tokens_per_s']:.0f}), peak {peak:.2f} GiB (phase 8 "
          f"{before['peak_gib']:.2f}); losses " + " ".join(f"{x:.4f}" for x in losses)
          + f", max relative gap to phase 8 {max(rel):.2e}; flash {per_step} per step, all "
          f"tensor_core; every gradient finite")
    del model, state, step


def mesh_ring(report, mesh) -> None:
    """``self_attention(impl="ring")`` at OLMo's attention shape on the
    (1, 1) mesh: its attention (``ring_attention`` on the projections)
    held against the flash kernel's on the same q, k, v within
    ``FLASH_TOL``, the call launching no flash kernel; the whole call
    timed beside ``impl="blockwise"``, which runs the flash kernel."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.distributed import ring_attention
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.models import attention as attn
    from repro_torch.models.lm import _attn_cfg

    cfg = get_config(MESH_ARCH)
    acfg = _attn_cfg(cfg)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = attn.init_attention(gen, acfg, torch.bfloat16)
    rng = np.random.default_rng(SEED)
    B, S = TRAIN["batch"], TRAIN["seq"]
    x = randn((B, S, cfg.d_model), torch.bfloat16, rng)
    with torch.no_grad():
        q, k, v = attn.qkv(params, x, torch.arange(S, device="cuda").expand(B, S), acfg)
        tfa.reset_launch_counts()
        attn.self_attention(params, x, acfg, impl="ring", mesh=mesh)
        n_ring = tfa.launch_counts().get("flash_attention", 0)
        ring = ring_attention(q, k, v, mesh, axis="model", causal=True)
        flash = tfa.flash_attention(q, k, v, causal=True)
        err = float((ring.float() - flash.float()).abs().max())
        ring_ms = statistics.median(event_times(
            lambda: attn.self_attention(params, x, acfg, impl="ring", mesh=mesh), n=5))
        flash_ms = statistics.median(event_times(
            lambda: attn.self_attention(params, x, acfg, impl="blockwise"), n=5))
    if n_ring or not err <= FLASH_TOL["bfloat16"]:
        raise RuntimeError(f"mesh ring: max|err| {err:.3e} against the flash kernel "
                           f"(tolerance {FLASH_TOL['bfloat16']}); the ring call launched "
                           f"{n_ring} flash kernels")
    shape = (B, S, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
    report.setdefault("mesh", {})["ring"] = {"shape": shape, "max_abs_err": err,
                                            "ms": ring_ms, "flash_ms": flash_ms}
    print(f"[mesh] self_attention(impl='ring') {shape} bf16 on the (1, 1) mesh: "
          f"{ring_ms:.3f} ms, impl='blockwise' (the flash kernel) {flash_ms:.3f} ms; "
          f"ring attention against the flash kernel max|err| {err:.3e} (tolerance "
          f"{FLASH_TOL['bfloat16']})")


def mesh_checkpoint(report, mesh) -> None:
    """A reduced olmo-1b's DTensor train state after a step on the mesh,
    saved and restored onto its placements: every leaf equal."""
    import shutil

    import torch

    from repro_torch.checkpoint import CheckpointStore, tree_flatten
    from repro_torch.configs import get_config, reduced
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.interop import train_state_tree
    from repro_torch.launch import train as ttrain
    from torch.distributed.tensor import DTensor

    rcfg, dev = reduced(get_config(MESH_ARCH)), torch.device("cuda")
    model, state, step = ttrain.build(rcfg, dev, 3e-3, 10, mesh=mesh)
    pipe = TokenPipeline(DataConfig(vocab=rcfg.vocab, seq_len=64, global_batch=8))
    state, _ = step(state, ttrain.batch_at(pipe, 0, rcfg, dev, mesh))
    root = os.path.join(ROOT, "build", "smoke_mesh_checkpoint")
    shutil.rmtree(root, ignore_errors=True)
    try:
        tree = train_state_tree(rcfg, model, state)
        store = CheckpointStore(root)
        store.save(1, tree, extra={"data_step": 1})
        at, got, extra = store.restore_latest(tree, ttrain.state_placements(tree), mesh)
        a, _ = tree_flatten(tree)
        b, _ = tree_flatten(got)
        same = [type(p) is type(q) and (not isinstance(p, DTensor) or
                                        p.placements == q.placements)
                and torch.equal(p.full_tensor() if isinstance(p, DTensor) else p,
                                q.full_tensor() if isinstance(q, DTensor) else q)
                for p, q in zip(a, b)]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    n_dt = sum(isinstance(p, DTensor) for p in a)
    if (at, extra) != (1, {"data_step": 1}) or len(a) != len(b) or not all(same):
        raise RuntimeError(f"mesh checkpoint: {sum(same)} of {len(a)} leaves equal")
    report.setdefault("mesh", {})["checkpoint_leaves"] = len(a)
    print(f"[mesh] reduced {MESH_ARCH}'s train state on the mesh ({n_dt} DTensor leaves "
          f"of {len(a)}) saved and restored onto its placements: every leaf equal")


def drop_share(log) -> float:
    """The share of (token, choice) pairs that the dispatches in ``log``
    (``moe.route_log``) dropped."""
    pairs = sum(int(e["keep"].numel()) for e in log)
    kept = sum(int(e["keep"].sum()) for e in log)
    return (pairs - kept) / max(pairs, 1)


def moe_cpu_reference() -> dict:
    """The reduced granite (``moe_impl="sharded"``) on the CPU's (1, 1)
    mesh, on a one-rank gloo group of its own (destroyed after), per
    schedule: the prefill's logits, the loss and every dispatch's kept
    pairs, for phase 10's card-vs-CPU check."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.models.moe import route_log
    from repro_torch.sharding import place_params, shard_batch

    rng = np.random.default_rng(SEED)
    toks = torch.from_numpy(rng.integers(0, 256, (2, 48)))
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, dims=1)}
    out = {"batch": batch}
    mesh = make_host_mesh()
    try:
        for sched in MOE_SCHEDULES:
            rcfg = reduced(get_config(MOE)).replace(moe_impl="sharded", moe_schedule=sched)
            model = build_model(rcfg, device="cpu", mesh=mesh,
                                generator=torch.Generator().manual_seed(SEED))
            state = {k: v.detach().clone() for k, v in model.state_dict().items()}
            place_params(model, mesh)
            with torch.inference_mode(), route_log() as log:
                logits, _ = model.prefill(shard_batch(batch, mesh))
                loss, _ = model.loss(shard_batch(batch, mesh))
            out[sched] = {"logits": logits, "loss": loss, "state": state,
                          "keep": [e["keep"].clone() for e in log]}
    finally:
        dist.destroy_process_group()
    return out


def moe_card_vs_cpu(report, mesh, cpu_ref) -> None:
    """Phase 10: the reduced granite (``moe_impl="sharded"``) on the card's
    (1, 1) NCCL mesh under each schedule against the CPU's (1, 1) mesh:
    the prefill's logits and the loss within ``MOE_CARD_TOL``, every
    dispatch's kept pairs equal."""
    import torch

    from repro_torch.configs import get_config, reduced
    from repro_torch.models import build_model
    from repro_torch.models.moe import route_log
    from repro_torch.sharding import place_params, shard_batch

    rec = report.setdefault("mesh_moe", {}).setdefault("reduced_card_vs_cpu", {})
    batch = {k: v.cuda() for k, v in cpu_ref["batch"].items()}
    for sched in MOE_SCHEDULES:
        want = cpu_ref[sched]
        rcfg = reduced(get_config(MOE)).replace(moe_impl="sharded", moe_schedule=sched)
        model = build_model(rcfg, device="cuda", mesh=mesh)
        model.load_state_dict(want["state"])
        place_params(model, mesh)
        with torch.inference_mode(), route_log() as log:
            logits, _ = model.prefill(shard_batch(batch, mesh))
            loss, _ = model.loss(shard_batch(batch, mesh))
        err = float((logits.cpu() - want["logits"]).abs().max())
        loss_err = float((loss.cpu() - want["loss"]).abs())
        same = len(log) == len(want["keep"]) and all(
            torch.equal(e["keep"].cpu(), k) for e, k in zip(log, want["keep"]))
        if not (err <= MOE_CARD_TOL and loss_err <= MOE_CARD_TOL and same):
            raise RuntimeError(f"mesh moe {sched}: card vs CPU max|err| logits {err:.2e}, "
                               f"loss {loss_err:.2e} (tolerance {MOE_CARD_TOL}); kept pairs "
                               f"equal: {same}")
        dropped = drop_share(log)
        rec[sched] = {"logits_err": err, "loss_err": loss_err, "drop_share": dropped}
        print(f"[mesh-moe] reduced {MOE} (moe_impl='sharded', {sched}) on the card's (1, 1) "
              f"mesh vs the CPU's: max|err| logits {err:.2e}, loss {float(want['loss']):.4f} "
              f"|err| {loss_err:.2e}, kept pairs equal in all {len(log)} dispatches "
              f"({100 * dropped:.2f} % of pairs dropped)")


def moe_model_on_mesh(mesh):
    """Full-width granite (its published ``moe_impl="sharded"``,
    ``moe_schedule="auto"``) built with the mesh from the serving seed and
    placed by ``rules_for``."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.sharding import place_params
    from repro_torch.sharding.rules import rules_for

    cfg = get_config(MOE)
    model = build_model(cfg, device="cuda", mesh=mesh,
                        generator=torch.Generator(device="cuda").manual_seed(SEED))
    return place_params(model, mesh, rules_for(cfg, mesh))


def moe_route_check(report, mesh, captured) -> None:
    """Phase 10: layer 0's MoE input from the served prefill through the
    sharded dispatch, against the dense dispatch with the dropped pairs'
    gate weights set to zero.  The oracle finds the kept pairs its own way,
    by the reference's cumulative count over a one-hot (the dispatch sorts
    the pairs by expert); they must equal the dispatch's exactly, and its
    output the dispatch's within ``ROUNDED_ULPS`` bf16 ulps of its row's
    scale.  Both timed, cold L2."""
    import torch

    import repro_torch.models.moe as moem
    from repro_torch.configs import get_config
    from repro_torch.distributed.collectives import local_of
    from repro_torch.kernels.instances import ROUNDED_ULPS, rounded_agreement
    from torch.distributed.tensor import Replicate

    cfg = get_config(MOE)
    params, x = captured
    E, k = cfg.n_experts, cfg.moe_top_k
    with torch.inference_mode():
        with moem.route_log() as log:
            y, _ = moem.apply_moe_sharded(params, x, k, E, mesh, schedule=cfg.moe_schedule)
        (entry,) = log
        whole = {n: local_of(p, [Replicate()] * p.device_mesh.ndim)   # (1, 1): whole
                 for n, p in params.items()}
        T = x.shape[0] * x.shape[1]
        idx, w, _ = moem.router_probs(whole["router"], x.reshape(T, -1), k)
        onehot = torch.nn.functional.one_hot(idx.reshape(-1), E)
        slot = torch.sum(torch.cumsum(onehot, dim=0) * onehot, dim=-1) - 1
        keep = slot < entry["cap"]
        same = torch.equal(keep, entry["keep"]) and torch.equal(slot, entry["slot"])
        gated = (w.reshape(-1) * keep).reshape(T, k)
        combine = torch.zeros((T, E), dtype=x.dtype, device=x.device).scatter(-1, idx, gated)
        mask = (combine != 0).to(x.dtype)
        xe = x.reshape(1, T, -1) * mask.t()[..., None]
        ye = moem._expert_ffn(whole["w_gate"], whole["w_up"], whole["w_down"], xe)
        want = torch.einsum("etd,te->td", ye, combine).reshape(x.shape)
        r = rounded_agreement(y, want)
        ms = cold_ms({"sharded": lambda: moem.apply_moe_sharded(
                          params, x, k, E, mesh, schedule=cfg.moe_schedule),
                      "dense": lambda: moem.apply_moe_dense(whole, x, k, E)}, n=10)
    dropped = 1.0 - float(keep.float().mean())
    if not same or r["ulps"] > ROUNDED_ULPS:
        raise RuntimeError(f"mesh moe route: kept pairs equal {same}; {r['ulps']:.2f} bf16 "
                           f"ulps from the dense dispatch with the dropped gates zeroed "
                           f"(limit {ROUNDED_ULPS})")
    report["route"] = {"schedule": entry["schedule"], "cap": entry["cap"], "tokens": T,
                       "drop_share": dropped, "ulps": r["ulps"], "sharded_ms": ms["sharded"],
                       "dense_ms": ms["dense"]}
    print(f"[mesh-moe] layer 0's dispatch ({entry['schedule']}, T {T}, cap {entry['cap']}, "
          f"{100 * dropped:.2f} % of pairs dropped): kept pairs and slots equal the cumulative "
          f"count's; output {r['ulps']:.2f} bf16 ulps of its row's scale from the dense "
          f"dispatch with the dropped gates zeroed (limit {ROUNDED_ULPS}); cold L2 "
          f"{ms['sharded']:.3f} ms, the dense dispatch {ms['dense']:.3f} ms")


def moe_mesh_serve(report, mesh, kernels, entries) -> None:
    """Phase 10: full-width granite (``moe_impl="sharded"``) built with the
    (1, 1) NCCL mesh serves phase 6's traffic through ``serve.generate``:
    the launch counts around the run (24 flash per prefill, all
    ``tensor_core``, none per decode step), prefill and decode times and
    peak beside phase 7's granite, the resolved schedule, cap and drop
    share per layer; then the route check and the flash kernel's entry."""
    import torch

    import repro_torch.models.attention as attn
    import repro_torch.models.moe as moem
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.kernels import conv1d as tconv
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.kernels import ssd as tssd
    from repro_torch.serve import generate
    from repro_torch.sharding import shard_batch

    cfg = get_config(MOE)
    rec = report.setdefault("mesh_moe", {})
    before = report["serving"][MOE]["serve"]
    model = moe_model_on_mesh(mesh)
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=SERVE["prompt_len"],
                                    global_batch=SERVE["batch"]))
    tokens = torch.from_numpy(pipe.batch_at(0)["tokens"]).long().cuda()
    batch = shard_batch({"tokens": tokens}, mesh)
    generate(model, batch, 2)                             # warm-up, outside the count
    torch.cuda.synchronize()
    captured, real = {}, (moem.apply_moe_sharded, attn.flash_attention)

    def capture_moe(params, x, *args, **kwargs):
        captured.setdefault("moe", (params, x.detach().clone()))
        return real[0](params, x, *args, **kwargs)

    def capture_flash(q, k, v, causal=True):
        captured.setdefault("flash", (q, k, v, causal))
        return real[1](q, k, v, causal=causal)

    torch.cuda.reset_peak_memory_stats()
    for mod in (tconv, tssd, tfa):
        mod.reset_launch_counts()
    moem.apply_moe_sharded, attn.flash_attention = capture_moe, capture_flash
    times = {}
    try:
        with moem.route_log() as log:
            out = generate(model, batch, SERVE["gen"], times=times,
                           max_len=SERVE["prompt_len"] + SERVE["gen"])
        torch.cuda.synchronize()
    finally:
        moem.apply_moe_sharded, attn.flash_attention = real
    counts = {k: n for k, n in {**tconv.launch_counts(), **tssd.launch_counts(),
                                **tfa.launch_counts(), **tfa.instance_counts()}.items() if n}
    want = {"flash_attention": cfg.n_layers, "flash_attention/tensor_core": cfg.n_layers}
    if counts != want:
        raise RuntimeError(f"mesh moe serve: launches {counts}, expected {want}")
    out = out.cpu().numpy()
    if out.shape != (SERVE["batch"], SERVE["gen"]) or out.min() < 0 or out.max() >= cfg.vocab:
        raise RuntimeError(f"mesh moe serve: tokens {out.shape} out of range")
    prefill_log, decode_log = log[:cfg.n_layers], log[cfg.n_layers:]
    if len(decode_log) != cfg.n_layers * (SERVE["gen"] - 1) or \
            {e["schedule"] for e in log} != {"2d_dshard"}:
        raise RuntimeError(f"mesh moe serve: {len(log)} dispatches, schedules "
                           f"{ {e['schedule'] for e in log} }")
    per_layer = [drop_share([e]) for e in prefill_log]
    decode_ms = 1e3 * times["decode_s"] / (SERVE["gen"] - 1)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    rec["serve"] = {"prefill_ms": 1e3 * times["prefill_s"], "decode_ms_per_token": decode_ms,
                    "peak_gib": peak, "schedule": "2d_dshard", "cap": prefill_log[0]["cap"],
                    "prefill_drop_share_per_layer": per_layer,
                    "decode_drop_share": drop_share(decode_log), "launches": counts,
                    "phase7": {k: before[k] for k in ("prefill_ms", "decode_ms_per_token",
                                                       "peak_gib")}}
    print(f"[mesh-moe] {MOE} (moe_impl='sharded', schedule auto -> 2d_dshard) on the (1, 1) "
          f"mesh at full width serves {SERVE['batch']} x {SERVE['prompt_len']}-token prompts "
          f"x {SERVE['gen']} tokens: prefill {1e3 * times['prefill_s']:.1f} ms (phase 7, dense "
          f"dispatch: {before['prefill_ms']:.1f}), decode {decode_ms:.2f} ms/token (phase 7 "
          f"{before['decode_ms_per_token']:.2f}), peak {peak:.2f} GiB (phase 7 "
          f"{before['peak_gib']:.2f}); flash {counts['flash_attention']} per prefill, all "
          f"tensor_core, none per decode step")
    print(f"[mesh-moe] prefill cap {prefill_log[0]['cap']} slots per expert (T "
          f"{prefill_log[0]['tokens']}); pairs dropped per layer (%): "
          + " ".join(f"{100 * d:.2f}" for d in per_layer)
          + f"; decode steps (cap {decode_log[0]['cap']}): "
          f"{100 * drop_share(decode_log):.3f} %")
    rec["prefill_split"] = prefill_split(model, batch, f"{MOE} mesh",
                                         moe_fn="apply_moe_sharded")
    del model, log
    torch.cuda.empty_cache()
    moe_route_check(rec, mesh, captured.pop("moe"))
    layer0_flash(kernels["flash"], captured.pop("flash"), counts, rec, entries, f"{MOE} mesh")
    captured.clear()
    torch.cuda.empty_cache()


def moe_mesh_train(report, mesh) -> None:
    """Phase 10: full-width granite (``moe_impl="sharded"``) trained on the
    (1, 1) mesh through ``launch.train``'s mesh branch for phase 8's steps
    at its lr: finite losses and gradients, exactly 48 flash launches per
    step, the drop share per step, step ms, tokens/s and peak beside phase
    8's granite (the dropless dispatch, without a mesh), one warm step
    traced with a ``moe`` family."""
    import numpy as np
    import torch

    import repro_torch.models.moe as moem
    import repro_torch.train.step as tstep
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.kernels import conv1d as tconv
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.kernels import ssd as tssd
    from repro_torch.launch import train as ttrain
    from torch.distributed.tensor import DTensor

    cfg, dev = get_config(MOE), torch.device("cuda")
    before = report["training"][MOE]
    per_step = 2 * flash_per_forward(cfg)
    rec = report.setdefault("mesh_moe", {}).setdefault("train", {})
    grads_ok, real = [], tstep.adamw_update

    def adamw(cfg_, grads, state, params, ndims=None):
        grads_ok.append(all(bool(torch.isfinite(g.to_local() if isinstance(g, DTensor)
                                                else g).all()) for g in grads.values()))
        with torch.profiler.record_function("smoke::adamw_update"):
            return real(cfg_, grads, state, params, ndims)

    torch.cuda.reset_peak_memory_stats(dev)
    model, state, step = ttrain.build(cfg, dev, TRAIN["lr"], TRAIN["steps"], mesh=mesh)
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=TRAIN["seq"],
                                    global_batch=TRAIN["batch"]))
    for mod in (tconv, tssd, tfa):
        mod.reset_launch_counts()
    tstep.adamw_update = adamw
    losses, step_s, drops = [], [], []
    try:
        for i in range(TRAIN["steps"]):
            batch = ttrain.batch_at(pipe, i, cfg, dev, mesh)
            t0 = time.time()
            with moem.route_log() as log:
                state, metrics = step(state, batch)
                losses.append(float(metrics["loss"]))            # waits for the step
            step_s.append(time.time() - t0)
            drops.append(drop_share(log))
        torch.cuda.synchronize()
        counts = {k: n for k, n in {**tconv.launch_counts(), **tssd.launch_counts(),
                                    **tfa.launch_counts(), **tfa.instance_counts()}.items()
                  if n}
        rec["split"], state, traced = train_split(
            model, step, state, ttrain.batch_at(pipe, 0, cfg, dev, mesh), f"{MOE} mesh",
            moe=True)
    finally:
        tstep.adamw_update = real
    want = {"flash_attention": TRAIN["steps"] * per_step,
            "flash_attention/tensor_core": TRAIN["steps"] * per_step}
    if counts != want:
        raise RuntimeError(f"mesh moe train: launches {counts}, expected {want}")
    if traced != {k: n // TRAIN["steps"] for k, n in want.items()}:
        raise RuntimeError(f"mesh moe train: the traced step launched {traced}")
    if len(losses) != TRAIN["steps"] or not all(np.isfinite(losses)):
        raise RuntimeError(f"mesh moe train: losses {losses}")
    if len(grads_ok) != TRAIN["steps"] + 2 or not all(grads_ok):
        raise RuntimeError(f"mesh moe train: a gradient is not finite ({grads_ok})")
    step_ms = 1e3 * statistics.median(step_s[1:])
    tokens = TRAIN["batch"] * TRAIN["seq"]
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    rec.update({"losses": losses, "drop_share_per_step": drops, "step_ms": step_ms,
                "tokens_per_s": tokens / (step_ms / 1e3), "peak_gib": peak,
                "launches_per_step": per_step, "phase8": {
                    k: before[k] for k in ("step_ms", "tokens_per_s", "peak_gib", "losses")}})
    print(f"[mesh-moe] {MOE} (moe_impl='sharded') trained on the (1, 1) mesh at full width, "
          f"{TRAIN['steps']} steps of {TRAIN['batch']} x {TRAIN['seq']} tokens: step "
          f"{step_ms:.1f} ms (phase 8, dropless dispatch: {before['step_ms']:.1f}), "
          f"{rec['tokens_per_s']:.0f} tokens/s (phase 8 {before['tokens_per_s']:.0f}), peak "
          f"{peak:.2f} GiB (phase 8 {before['peak_gib']:.2f}); losses "
          + " ".join(f"{x:.4f}" for x in losses) + " (phase 8 "
          + " ".join(f"{x:.4f}" for x in before["losses"]) + "); pairs dropped per step (%): "
          + " ".join(f"{100 * d:.2f}" for d in drops)
          + f"; flash {per_step} per step, all tensor_core; every gradient finite")
    del model, state, step


def dryrun_phase(report) -> None:
    """Phase 11: the dry run's cells, each in a subprocess of its own (a
    fake process group cannot share a process with the NCCL one): per-rank
    bytes, FLOPs and collectives; a cell that errors fails the smoke."""
    out_dir = os.path.join(ROOT, "build", "smoke_dryrun")
    rec = report.setdefault("dryrun", {})
    for arch, shape, multi_pod in DRYRUN_CELLS:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
               "--shape", shape, "--force", "--out-dir", out_dir,
               *(["--multi-pod"] if multi_pod else [])]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600,
                             env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))
        wall = time.perf_counter() - t0
        mesh_tag = "2x16x16" if multi_pod else "16x16"
        path = os.path.join(out_dir, mesh_tag, f"{arch}__{shape}.json")
        if res.returncode != 0 or not os.path.exists(path):
            raise RuntimeError(f"dry run {arch} x {shape} ({mesh_tag}): rc {res.returncode}\n"
                               f"{res.stdout[-2000:]}\n{res.stderr[-2000:]}")
        with open(path) as f:
            cell = json.load(f)
        if "error" in cell or "skipped" in cell:
            raise RuntimeError(f"dry run {arch} x {shape} ({mesh_tag}): {cell}")
        rec[f"{arch}/{shape}/{mesh_tag}"] = {**cell, "subprocess_s": wall}
        mem = cell["memory"]
        print(f"[dryrun] {arch} x {shape} on ({mesh_tag}) per rank: arguments "
              f"{mem['argument_bytes'] / 1e9:.3f} GB (params {mem['param_bytes'] / 1e9:.3f}, "
              f"moments {mem['opt_bytes'] / 1e9:.3f}, batch {mem['batch_bytes'] / 1e9:.3f}, "
              f"cache {mem['cache_bytes'] / 1e9:.3f}); {cell['n_params']:,} parameters; "
              f"matmul {cell['matmul_flops'] / 1e12:.3f} TFLOP (model FLOPs / ranks "
              f"{cell['model_flops_per_device'] / 1e12:.3f}); collectives "
              + ", ".join(f"{k} {n} ({cell['collective_bytes'][k] / 1e9:.3f} GB)"
                          for k, n in cell["collective_count"].items() if n)
              + f"; {cell['wall_s']:.1f} s in the cell, {wall:.1f} s with start-up")


def concrete_versions(prog, max_delta, compiler, nx, ny, nz, block_x):
    """The original and the synthesized (``ptxasw``) PTX of ``prog`` on the
    concrete warp emulator, as ``tests/test_core_pipeline.py::_run_versions``
    runs them: the same inputs from ``default_rng(0)`` for both, scalars
    0.3.  Returns both outputs (full arrays) and the inputs."""
    import numpy as np

    from repro_torch.core.emulator.concrete import f32_bits, run_concrete
    from repro_torch.core.frontend.stencil import lower_to_ptx

    kernel = lower_to_ptx(prog)
    syn = compiler.compile(kernel, max_delta=max_delta).module.kernels[0]
    nd = prog.ndim
    shape = {1: (nx,), 2: (ny, nx), 3: (nz, ny, nx)}[nd]
    h = prog.halo
    nbx = -(-(shape[-1] - 2 * h[0]) // block_x)
    grid = (nbx, 1, 1) if nd == 1 else (nbx, shape[0] - 2 * h[1], 1) if nd == 2 \
        else (nbx, shape[1] - 2 * h[1], shape[0] - 2 * h[2])
    outs = []
    for k in (kernel, syn):
        rng = np.random.default_rng(0)
        params = {a: (np.zeros(shape[-d:], np.float32) if a == prog.out.array
                      else rng.standard_normal(shape[-d:]).astype(np.float32))
                  for a, d in prog.arrays.items()}
        arrays = {a: v.copy() for a, v in params.items() if a != prog.out.array}
        params.update({f"n{d}": shape[::-1][d] for d in range(nd)})
        params.update({s: f32_bits(0.3) for s in prog.scalars})
        run_concrete(k, params, ntid=(block_x, 1, 1), nctaid=grid)
        outs.append(params[prog.out.array])
    return outs, arrays


def compile_side(report, benches, device="cuda") -> None:
    """Phase 12: the compile side on the card's machine, fatal on any failure.
    (a) a ``Compiler(jobs=4)`` session with a disk tier compiles the 19
    KernelGen sources for ``hopper`` through ``compile_many``: cold, again
    from memory, then in a fresh session from disk, with no emulation in
    either warm pass; (b) ``variants`` over every registered target with
    cost selection, Jacobi's keep/drop split as the paper's Fig. 2 and
    every Hopper shuffle ``shfl.sync`` with the full mask; (c) per bench
    in ``benches``, the original and synthesized PTX on the concrete
    emulator bitwise equal, and ``stencil_apply(mode="paper")`` on
    ``device`` within the stencil tolerance of them."""
    import tempfile

    import numpy as np
    import torch

    from repro_torch.core.driver import Compiler
    from repro_torch.core.frontend.kernelgen import APPLICATIONS, SUITE, get_bench
    from repro_torch.kernels.stencil import stencil_apply

    rec = report.setdefault("compile_side", {})
    names = [*SUITE, *APPLICATIONS]

    def batch(cc):
        before = cc.cache_stats.snapshot()
        t0 = time.perf_counter()
        results = cc.compile_many([get_bench(n) for n in names], target="hopper")
        wall = time.perf_counter() - t0
        after = cc.cache_stats.snapshot()
        delta = {f: getattr(after, f) - getattr(before, f)
                 for f in ("hits", "misses", "disk_hits", "disk_misses")}
        emulations = sum(not r.cached for res in results for r in res.reports)
        return {"wall_s": wall, "emulations": emulations, **delta}, results

    with tempfile.TemporaryDirectory(prefix="compile-side-",
                                     dir=os.path.join(ROOT, "build")) as cache_dir:
        with Compiler(jobs=COMPILE_JOBS, cache_dir=cache_dir) as cc:
            cold, results = batch(cc)
            warm, again = batch(cc)
            pass_times, counters = cc.pass_times, cc.counters
        with Compiler(jobs=COMPILE_JOBS, cache_dir=cache_dir) as cc:
            disk, from_disk = batch(cc)
            disk_pass_times = cc.pass_times
    n = len(names)
    want = {"cold": dict(misses=n, disk_misses=n, emulations=n),
            "memory-warm": dict(hits=n, misses=0, emulations=0),
            "disk-warm": dict(misses=n, disk_hits=n, disk_misses=0, emulations=0)}
    for tag, got in (("cold", cold), ("memory-warm", warm), ("disk-warm", disk)):
        if any(got[k] != v for k, v in want[tag].items()):
            raise RuntimeError(f"compile side, {tag} pass: {got}, expected {want[tag]}")
    if disk_pass_times:
        raise RuntimeError(f"compile side: the disk-warm session ran passes {disk_pass_times}")
    ptx = [r.ptx for r in results]
    if [r.ptx for r in again] != ptx or [r.ptx for r in from_disk] != ptx:
        raise RuntimeError("compile side: a warm pass printed other PTX")
    shuffles = {name: r.n_shuffles for name, r in zip(names, results)}
    shfl_lines = [ln for text in ptx for ln in text.splitlines() if "shfl." in ln]
    if not shfl_lines or not all("shfl.sync." in ln and ln.rstrip(";").endswith("0xffffffff")
                                 for ln in shfl_lines):
        raise RuntimeError("compile side: a hopper shuffle is not shfl.sync with the full mask")
    rec.update(cold=cold, memory_warm=warm, disk_warm=disk, pass_times_s=pass_times,
               counters=counters, shuffles=shuffles, shfl_sync_lines=len(shfl_lines))
    print(f"[compile] {n} sources for hopper, Compiler(jobs={COMPILE_JOBS}) with a disk "
          f"tier: cold {cold['wall_s']:.3f} s ({cold['emulations']} emulations), "
          f"memory-warm {warm['wall_s']:.4f} s ({warm['hits']} hits, "
          f"{warm['emulations']} emulations), disk-warm in a fresh session "
          f"{disk['wall_s']:.4f} s ({disk['disk_hits']} disk hits, "
          f"{disk['emulations']} emulations)")
    print("[compile] pass times (s): " + ", ".join(
        f"{k} {v:.4f}" for k, v in pass_times.items()))
    print(f"[compile] {n} kernels, {sum(shuffles.values())} shuffles, "
          f"{len(shfl_lines)} shfl.sync lines with mask 0xffffffff; counters "
          + ", ".join(f"{k} {v}" for k, v in sorted(counters.items())))

    # (b) per-target variants under cost selection
    split = {}
    with Compiler(jobs=COMPILE_JOBS) as cc:
        for name in names:
            for target, res in cc.variants(get_bench(name), selection="cost").items():
                sel = res.reports[0].selection
                split.setdefault(target, {})[name] = (sel.n_kept, sel.n_dropped)
    jac = {t: split[t]["jacobi"] for t in split}
    if not (jac["pascal"] == jac["maxwell"] == (6, 0)
            and jac["kepler"][1] >= 1 and jac["volta"][1] >= 1):
        raise RuntimeError(f"compile side: Jacobi's keep/drop split {jac} is not Fig. 2's")
    rec["kept_dropped"] = split
    for target, per in split.items():
        print(f"[compile] cost selection {target:<8} kept/dropped: "
              + " ".join(f"{k} {a}/{b}" for k, (a, b) in per.items()))

    # (c) synthesis changes no output, and the card agrees
    conc = rec.setdefault("concrete", {})
    with Compiler() as cc:
        for name, b in benches.items():
            prog = b.program
            (orig, syn), arrays = concrete_versions(prog, b.max_delta, cc, **CONCRETE_GRID)
            if not np.array_equal(orig.view(np.uint32), syn.view(np.uint32)):
                raise RuntimeError(f"compile side: {name}: synthesis changed the "
                                   f"concrete emulator's output")
            interior = tuple(slice(h, orig.shape[ax] - h)
                             for ax, h in enumerate(reversed(prog.halo[:prog.ndim])))
            want_out = torch.from_numpy(orig[interior]).to(device)
            got = stencil_apply(prog, arrays, {s: 0.3 for s in prog.scalars},
                                mode="paper", max_delta=b.max_delta, device=device)
            err = float((got - want_out).abs().max())
            torch.testing.assert_close(got, want_out, **TOL)
            conc[name] = {"shape": list(orig.shape), "max_abs_err": err}
    print(f"[compile] concrete emulator at {CONCRETE_GRID}: original == synthesized "
          f"bitwise for {len(benches)} benches; stencil_apply(paper) on {device} within "
          f"{TOL['atol']:g}, max|err| " + " ".join(f"{k} {v['max_abs_err']:.1e}"
                                                for k, v in conc.items()))


class TimedClient:
    """Wraps a ``PtxServiceClient``: each ``compile`` call's wall time is
    kept (``drive_requests`` reports only the total)."""

    def __init__(self, client):
        self.client = client
        self.latencies = []

    def compile(self, *args, **kwargs):
        t0 = time.perf_counter()
        out = self.client.compile(*args, **kwargs)
        self.latencies.append(time.perf_counter() - t0)
        return out


def corpus_expectations() -> dict:
    """File stem -> (severity, code, uid) from each corpus file's
    ``// expect:`` header line; None for a file that expects no finding."""
    out = {}
    for fname in sorted(os.listdir(LINT_CORPUS)):
        if not fname.endswith(".ptx"):
            continue
        with open(os.path.join(LINT_CORPUS, fname)) as f:
            m = re.search(r"^// expect: (\w+) ([\w-]+) @uid:(\d+)", f.read(), re.M)
        out[fname[:-4]] = (m.group(1), m.group(2), int(m.group(3))) if m else None
    return out


def middle_end_service(report, benches, kernels, paper_out, device="cuda") -> dict:
    """Phase 13: the full middle-end and the compile service, fatal on any
    failure.  (a) a ``PtxServiceServer(jobs=4)`` with a disk tier under
    ``build/``; (b) ``POST /lint`` of the stencil benches (every one clean)
    and of the lint corpus (the clean twins clean, every planted bug found
    with its header's code); (c) ``POST /compile`` of the 19 KernelGen
    sources with every knob of the middle-end, cold then again, each
    response byte-equal to an in-process compile; (d) per stencil bench, a
    widened, strictly linted plan whose schedule is the built ``paper``
    kernel's, ``stencil_apply(mode="paper")`` on ``device`` within ``TOL`` of
    the saturated synthesized PTX on the concrete emulator (bitwise equal to
    the original's), and the paper sizes (``paper_out``: phase 4's paper
    outputs) again, bitwise; (e) ``drive_requests`` against a second server
    on the same directory, with no emulation.  Returns (d)'s inputs, the
    concrete emulator's interior and the ``paper`` outputs per bench, on the
    host, for phase 14."""
    import random
    import tempfile
    from concurrent.futures import ThreadPoolExecutor as Pool

    import numpy as np
    import torch

    from repro_torch.core.driver import Compiler
    from repro_torch.core.frontend.cuda_lower import synthesize_cuda
    from repro_torch.core.frontend.kernelgen import APPLICATIONS, SUITE, get_bench
    from repro_torch.kernels.stencil import launch_counts, reset_launch_counts, stencil_apply
    from repro_torch.launch.ptx_service import (
        PtxServiceClient, PtxServiceServer, drive_requests)

    t_phase = time.perf_counter()
    rec = report.setdefault("middle_end", {})
    names = [*SUITE, *APPLICATIONS]
    options = dict(target="hopper", **FULL_MIDDLE_END)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="service-",
                                     dir=os.path.join(ROOT, "build")) as cache_dir:
        # (a) the service
        with PtxServiceServer(port=0, jobs=COMPILE_JOBS, cache_dir=cache_dir) as server:
            server.start()
            client = PtxServiceClient(server.host, server.port)
            if not client.healthz():
                raise RuntimeError("service: /healthz failed")

            # (b) lint
            benches_lint = {n: client.lint(bench=n) for n in benches}
            dirty = {n: r["findings"] for n, r in benches_lint.items() if not r["clean"]}
            if dirty:
                raise RuntimeError(f"service: /lint of the stencil benches: {dirty}")
            corpus = {}
            for stem, want in corpus_expectations().items():
                with open(os.path.join(LINT_CORPUS, stem + ".ptx")) as f:
                    r = client.lint(ptx=f.read())
                got = {(x["severity"], x["code"], x["uid"]) for x in r["findings"]}
                clean = want is None or want[0] == "NOTE"
                if r["clean"] != clean or (want is not None and want not in got):
                    raise RuntimeError(f"service: /lint {stem}: clean {r['clean']}, "
                                       f"findings {sorted(got)}, expected {want}")
                corpus[stem] = {"clean": r["clean"], "counts": r["counts"]}
            lint_stats = client.stats()["lint_counters"]
            rec["lint"] = {"benches": len(benches_lint), "corpus": corpus,
                           "counters": lint_stats}
            print(f"[service] /lint: {len(benches_lint)} stencil benches clean; corpus "
                  + ", ".join(f"{k} {'clean' if v['clean'] else 'found'}"
                              for k, v in corpus.items())
                  + "; findings " + ", ".join(f"{k} {v}" for k, v in sorted(lint_stats.items())))

            # (c) compile, cold then again
            with Compiler(**FULL_MIDDLE_END) as cc:
                local = {n: cc.compile(get_bench(n), target="hopper").ptx for n in names}
            passes = {}
            for tag in ("cold", "warm"):
                before = client.stats()["cache"]
                t0 = time.perf_counter()
                with Pool(max_workers=COMPILE_JOBS) as pool:
                    resps = dict(zip(names, pool.map(
                        lambda n: client.compile(bench=n, **options), names)))
                wall = time.perf_counter() - t0
                after = client.stats()
                moved = {k: after["cache"][k] - before[k]
                         for k in ("hits", "misses", "disk_hits", "disk_misses")}
                emulations = sum(not r["cached"] for resp in resps.values()
                                 for r in resp["reports"])
                for n, resp in resps.items():
                    if resp["ptx"] != local[n]:
                        raise RuntimeError(f"service: /compile {n} ({tag}) is not the "
                                           "in-process compile's PTX")
                    bad = [d for d in resp["diagnostics"]
                           if d["severity"] == "ERROR" or d.get("code") == "sat-gate"]
                    if bad:
                        raise RuntimeError(f"service: /compile {n} ({tag}): {bad}")
                want = dict(misses=len(names), hits=0) if tag == "cold" else \
                    dict(misses=0, hits=len(names))
                if any(moved[k] != v for k, v in want.items()) or \
                        (tag == "warm" and emulations):
                    raise RuntimeError(f"service: {tag} pass moved {moved} with "
                                       f"{emulations} emulations, expected {want}")
                passes[tag] = {"wall_s": wall, "req_per_s": len(names) / wall,
                               "emulations": emulations, **moved}
            stats = client.stats()
            ptx_bytes = sum(len(t) for t in local.values())
            rec["compile"] = {**passes, "ptx_bytes": ptx_bytes,
                              "saturation_counters": stats["saturation_counters"],
                              "lint_counters": stats["lint_counters"],
                              "pass_times_s": stats["pass_times"]}
            print(f"[service] /compile of {len(names)} sources with {options}: cold "
                  f"{passes['cold']['wall_s']:.3f} s ({passes['cold']['req_per_s']:.1f} "
                  f"req/s, {passes['cold']['misses']} misses), again "
                  f"{passes['warm']['wall_s']:.4f} s ({passes['warm']['req_per_s']:.1f} req/s, "
                  f"{passes['warm']['hits']} memory hits, {passes['warm']['emulations']} "
                  f"emulations); {ptx_bytes} bytes of PTX, each response byte-equal to "
                  "the in-process compile")
            print("[service] counters: " + ", ".join(
                f"{k} {v}" for k, v in sorted({**stats["saturation_counters"],
                                                **stats["lint_counters"]}.items())))

        # (d) the stencil main path through the full middle-end
        planner = Compiler(widen=True, lint="strict")
        saturated = Compiler(target="hopper", **FULL_MIDDLE_END)
        conc, held = {}, {}
        reset_launch_counts()
        for name, b in benches.items():
            prog = b.program
            plan = synthesize_cuda(prog, b.max_delta, compiler=planner)
            kernel = kernels[(name, "paper")]
            if not plan.consistent or tuple(plan.schedule) != kernel.spec.rows:
                raise RuntimeError(f"middle-end: {name}: plan consistent {plan.consistent}, "
                                   "schedule equal to the built kernel's "
                                   f"{tuple(plan.schedule) == kernel.spec.rows}")
            (orig, syn), arrays = concrete_versions(prog, b.max_delta, saturated,
                                                    **CONCRETE_GRID)
            if not np.array_equal(orig.view(np.uint32), syn.view(np.uint32)):
                raise RuntimeError(f"middle-end: {name}: the saturated synthesized PTX "
                                   "changed the concrete emulator's output")
            interior = tuple(slice(h, orig.shape[ax] - h)
                             for ax, h in enumerate(reversed(prog.halo[:prog.ndim])))
            want_out = torch.from_numpy(syn[interior]).to(device)
            got = stencil_apply(prog, arrays, {s: 0.3 for s in prog.scalars},
                                mode="paper", max_delta=b.max_delta, device=device)
            torch.testing.assert_close(got, want_out, **TOL)
            conc[name] = {"shuffles": plan.n_shuffles,
                          "max_abs_err": float((got - want_out).abs().max())}
            held[name] = {"arrays": arrays, "emulated": want_out.cpu(), "paper": got.cpu()}
        for name, want in paper_out.items():
            b = benches[name]
            xs, sc = inputs(b.program, PAPER[name], SEED, device)
            out = stencil_apply(b.program, xs, sc, mode="paper", max_delta=b.max_delta,
                                device=device)
            same = torch.equal(out.cpu(), want)
            del xs, out
            if not same:
                raise RuntimeError(f"middle-end: {name} at {PAPER[name]} is not phase 4's "
                                   "paper output bit for bit")
        if device != "cpu":
            torch.cuda.synchronize()
        counts = launch_counts()
        launches = {n: counts.get(kernels[(n, "paper")].symbol, 0) for n in benches}
        need = {n: 1 + (n in paper_out) for n in benches}
        if device != "cpu" and any(launches[n] < need[n] for n in benches):
            raise RuntimeError(f"middle-end: paper launches {launches}, expected {need}")
        sat = saturated.counters
        rec["stencil"] = {"concrete": conc, "launches": launches, "paper_bitwise": list(paper_out),
                          "saturation_counters": {k: v for k, v in sat.items()
                                                  if k.startswith("sat_")},
                          "plan_cache": planner.cache_stats.to_dict()}
        planner.close()
        saturated.close()
        print(f"[middle-end] {len(benches)} benches planned by Compiler(widen=True, "
              f"lint=\"strict\"): consistent, schedules equal to the built paper kernels'; "
              f"saturated PTX ({sat.get('sat_rewrites', 0)} rewrites, "
              f"{sat.get('sat_soundness_failures', 0)} gate failures) == original on the "
              f"concrete emulator at {CONCRETE_GRID}, bitwise; stencil_apply(paper) on "
              f"{device} within {TOL['atol']:g}, max|err| "
              + " ".join(f"{k} {v['max_abs_err']:.1e}" for k, v in conc.items()))
        print(f"[middle-end] {', '.join(paper_out)} at the paper's sizes: bitwise equal to "
              f"phase 4's paper output; paper launches "
              + " ".join(f"{k} {v}" for k, v in launches.items()))

        # (e) the service's own load against a second server on the disk tier
        rng = random.Random(SEED)
        plan = [rng.choice(names) for _ in range(SERVICE_LOAD["requests"])]
        with Compiler(jobs=COMPILE_JOBS, cache_dir=cache_dir, **options) as cc, \
                PtxServiceServer(port=0, compiler=cc) as server:
            server.start()
            timed = TimedClient(PtxServiceClient(server.host, server.port))
            wall = drive_requests(timed, plan, SERVICE_LOAD["clients"])
            emulate_s = cc.pass_times.get("emulate-flows", 0.0)
            stats = cc.cache_stats
            if emulate_s != 0.0 or stats.disk_hits == 0:
                raise RuntimeError(f"service load: emulate-flows {emulate_s} s, "
                                   f"{stats.summary}; expected a disk-warm run")
            lat = timed.latencies
            rec["load"] = {**SERVICE_LOAD, "wall_s": wall, "req_per_s": len(plan) / wall,
                           "p50_ms": statistics.median(lat) * 1e3,
                           "p99_ms": statistics.quantiles(lat, n=100)[98] * 1e3,
                           "cache": stats.to_dict(), "distinct": len(set(plan))}
        load = rec["load"]
        print(f"[service] load: {load['requests']} requests over {load['clients']} clients "
              f"({load['distinct']} distinct sources) on a second server on the same disk "
              f"directory: {load['wall_s']:.3f} s, {load['req_per_s']:.1f} req/s, p50 "
              f"{load['p50_ms']:.2f} ms, p99 {load['p99_ms']:.2f} ms; {stats.summary}; "
              "0 emulations")
    rec["seconds"] = time.perf_counter() - t_phase
    print(f"[middle-end] phase 13 took {rec['seconds']:.1f} s")
    return held


def fleet_phase(report, benches, kernels, held, device="cuda") -> None:
    """Phase 14: the fleet, fatal on any failure.  (a) the port's own fleet
    load test (``launch.fleet.smoke.run_smoke``): a cache tier and three
    replica processes, its five contracts held here from the summary;
    (b) the stencil main path through the fleet's network cache tier: two
    ``Compiler`` sessions with no cache of their own but a ``RemoteCache``
    on one in-process ``CacheTierServer``, the second planning every bench
    from remote hits with no emulation; the ``paper`` kernels launched on
    ``device`` on phase 13(d)'s inputs (``held``), bitwise equal to its
    outputs and within ``TOL`` of the concrete emulator."""
    import torch

    from repro_torch.core.driver import Compiler
    from repro_torch.core.frontend.cuda_lower import synthesize_cuda
    from repro_torch.core.passes.cache import CompileCache
    from repro_torch.kernels.stencil import launch_counts, reset_launch_counts, stencil_apply
    from repro_torch.launch.fleet import CacheTierServer, RemoteCache
    from repro_torch.launch.fleet.smoke import run_smoke

    t_phase = time.perf_counter()
    rec = report.setdefault("fleet", {})

    # (a) the fleet's own load test, in subprocesses (run_smoke kills its
    # children in a finally, so a failed phase leaves no port held)
    summary = run_smoke(seed=SEED, **FLEET_LOAD)
    ph = summary["phases"]
    warm, bp = ph["warm_remote"], ph["backpressure"]
    faults = []
    if ph["coalesce"]["new_misses"] != 1 or ph["coalesce"]["distinct_payloads"] != 1:
        faults.append(f"coalesce {ph['coalesce']}")
    if warm["remote_hits"] != warm["distinct_sources"] or warm["emulate_flows_s"] != 0.0:
        faults.append(f"warm-remote {warm}")
    if bp["rejected_503"] < 1:
        faults.append(f"backpressure {bp}")
    if any(code != 0 for code in ph["drain"]["exit_codes"].values()):
        faults.append(f"drain {ph['drain']}")
    if faults:
        raise RuntimeError("fleet smoke: " + "; ".join(faults))
    for name in ("cold", "coalesce", "warm_remote", "backpressure"):
        p = ph[name]
        lat = p["latency"]
        print(f"[fleet] {name:<12} wall {p['wall_s']:.3f} s, {p['req_per_s']:.2f} req/s, "
              f"total latency p50 {lat['p50_s'] * 1e3:.1f} ms p99 {lat['p99_s'] * 1e3:.1f} ms "
              f"(log2 bucket bounds; mean {lat['mean_s'] * 1e3:.2f} ms, max "
              f"{lat['max_s'] * 1e3:.2f} ms, {lat['count']} requests)")
    print(f"[fleet] coalesce: {ph['coalesce']['k']} identical requests, "
          f"{ph['coalesce']['new_misses']} miss, {ph['coalesce']['distinct_payloads']} "
          f"distinct payload; warm-remote: {warm['remote_hits']} remote hits for "
          f"{warm['distinct_sources']} distinct sources, emulate-flows "
          f"{warm['emulate_flows_s']} s; backpressure: {bp['rejected_503']} 503s, queue "
          f"{bp['queue']}; drain exit codes {ph['drain']['exit_codes']}")
    print(f"[fleet] cache server /stats: {json.dumps(summary['cache_server'])}")
    print(f"[fleet] replica B warm-remote {warm['req_per_s']:.2f} req/s "
          f"({warm['wall_s']:.3f} s for {warm['latency']['count']} requests, "
          f"{FLEET_LOAD['clients']} clients) beside phase 13(e)'s single server "
          f"on a warm disk {report['middle_end']['load']['req_per_s']:.2f} req/s")
    rec["smoke"] = summary

    # (b) the stencil main path through the fleet's network cache tier
    with CacheTierServer(port=0) as tier:
        tier.start()
        sessions, plans, remotes = {}, {}, {}
        for tag in ("A", "B"):
            remotes[tag] = RemoteCache(tier.url)
            sessions[tag] = Compiler(cache=CompileCache(remote=remotes[tag]))
            plans[tag] = {name: synthesize_cuda(b.program, b.max_delta,
                                                compiler=sessions[tag])
                          for name, b in benches.items()}
        stats = {t: c.cache_stats.snapshot() for t, c in sessions.items()}
        n = len(benches)
        if stats["A"].misses != n or remotes["A"].counters["puts"] != n:
            raise RuntimeError(f"fleet tier: session A {stats['A'].summary}, remote "
                               f"{remotes['A'].counters}; expected {n} misses and puts")
        emulated = sessions["B"].pass_times.get("emulate-flows")
        if stats["B"].remote_hits != n or emulated is not None:
            raise RuntimeError(f"fleet tier: session B {stats['B'].summary}, "
                               f"emulate-flows {emulated}; expected {n} remote hits "
                               "and no emulation")
        pairs = {}
        for name in benches:
            plan = plans["B"][name]
            key = {t: [(p.dst_uid, p.src_uid, p.delta) for p in plans[t][name].detection.pairs]
                   for t in plans}
            if not plan.consistent or tuple(plan.schedule) != kernels[(name, "paper")].spec.rows \
                    or key["A"] != key["B"]:
                raise RuntimeError(f"fleet tier: {name}: consistent {plan.consistent}, "
                                   "schedule equal to the built paper kernel's "
                                   f"{tuple(plan.schedule) == kernels[(name, 'paper')].spec.rows}"
                                   f", detection pairs equal to session A's "
                                   f"{key['A'] == key['B']}")
            pairs[name] = len(key["B"])
        tier_stats = tier.stats_payload()
        for c in sessions.values():
            c.close()

    reset_launch_counts()
    errs = {}
    for name, b in benches.items():
        h = held[name]
        out = stencil_apply(b.program, h["arrays"], {s: 0.3 for s in b.program.scalars},
                            mode="paper", max_delta=b.max_delta, device=device).cpu()
        if not torch.equal(out, h["paper"]):
            raise RuntimeError(f"fleet tier: {name}: paper output is not phase 13(d)'s "
                               "bit for bit")
        torch.testing.assert_close(out, h["emulated"], **TOL)
        errs[name] = float((out - h["emulated"]).abs().max())
    if device != "cpu":
        torch.cuda.synchronize()
    counts = launch_counts()
    launches = {n: counts.get(kernels[(n, "paper")].symbol, 0) for n in benches}
    if device != "cpu" and any(v < 1 for v in launches.values()):
        raise RuntimeError(f"fleet tier: paper launches {launches}, expected >= 1 each")
    rec["tier"] = {"session_a": stats["A"].to_dict(), "session_b": stats["B"].to_dict(),
                   "remote_a": remotes["A"].counters, "remote_b": remotes["B"].counters,
                   "server": tier_stats, "pairs": pairs, "launches": launches,
                   "max_abs_err": errs}
    print(f"[fleet] tier: session A {stats['A'].summary}, remote {remotes['A'].counters}; "
          f"session B {stats['B'].summary}, remote {remotes['B'].counters}, no "
          f"emulate-flows; server {tier_stats['entries']} entries, {tier_stats['bytes']} "
          "bytes")
    print(f"[fleet] {len(benches)} plans from remote hits: consistent, schedules equal to "
          "the built paper kernels', detection pairs equal to session A's ("
          + " ".join(f"{k} {v}" for k, v in pairs.items()) + "); stencil_apply(paper) on "
          f"{device} at {CONCRETE_GRID} bitwise equal to phase 13(d), max|err| vs the "
          "concrete emulator " + " ".join(f"{k} {v:.1e}" for k, v in errs.items())
          + "; paper launches " + " ".join(f"{k} {v}" for k, v in launches.items()))
    rec["seconds"] = time.perf_counter() - t_phase
    print(f"[fleet] phase 14 took {rec['seconds']:.1f} s")


def mesh_path(report, kernels, entries) -> None:
    """Phases 9 and 10: the mesh path at world size 1 over NCCL, then the
    sharded MoE dispatch on the same group (its CPU reference first, on a
    gloo group of its own)."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    cpu_ref = moe_cpu_reference()
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), "cuda")
        mesh_train(report, mesh)
        torch.cuda.empty_cache()
        mesh_ring(report, mesh)
        mesh_checkpoint(report, mesh)
        torch.cuda.empty_cache()
        moe_card_vs_cpu(report, mesh, cpu_ref)
        moe_mesh_serve(report, mesh, kernels, entries)
        moe_mesh_train(report, mesh)
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()


def training_path(kernels, report, entries) -> None:
    """Phase 8: the reduced models' train step card vs CPU, the reduced loss
    falling over 40 steps, a checkpoint round trip, then olmo-1b,
    mamba2-1.3b and granite-moe-1b-a400m trained at full width, one after
    the other."""
    import torch

    rec = report.setdefault("training", {})
    for arch in REDUCED_TRAIN:
        reduced_train_card_vs_cpu(rec.setdefault(arch, {}), arch)
    model, state, rcfg = reduced_training_falls(rec)
    checkpoint_round_trip(rec, model, state, rcfg)
    del model, state
    for arch in TRAIN_ARCHS:
        torch.cuda.empty_cache()
        training_run(report, arch, kernels, entries)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import numpy as np
    import torch.nn.functional as F

    from repro_torch.build import nvcc_path, register_counts, sass_counts
    from repro_torch.core.driver import default_compiler
    from repro_torch.core.frontend.cuda_lower import synthesize_cuda
    from repro_torch.core.frontend.kernelgen import get_bench
    from repro_torch.kernels import conv1d as tconv
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.kernels import gated_norm as tgn
    from repro_torch.kernels import ssd as tssd
    from repro_torch.kernels.stencil import (
        MARCH, MODES, build_kernels, launch_counts, reference,
        reset_launch_counts, stencil_apply, traffic_report,
    )

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = "cuda"
    t_start = time.perf_counter()
    report = {"sass": {}, "medium": {}, "paper": {}}
    only = sys.argv[sys.argv.index("--only") + 1] if "--only" in sys.argv else None
    if only not in (None, ONLY_PREFILLS, ONLY_ADAMW):
        raise ValueError(f"--only {only!r}: the phases run alone are {ONLY_PREFILLS!r} "
                         f"and {ONLY_ADAMW!r}")

    # -- 1. toolchain -------------------------------------------------------
    card = card_line()
    cap = torch.cuda.get_device_capability(0)
    nvcc = sh(nvcc_path(), "--version").splitlines()[-1]
    print(f"[toolchain] torch {torch.__version__} cuda {torch.version.cuda} "
          f"sm_{cap[0]}{cap[1]} | {nvcc} | {card}")
    if cap != (9, 0):
        raise RuntimeError(f"the kernels are built for sm_90a; device is sm_{cap[0]}{cap[1]}")

    if only == ONLY_ADAMW:
        entries = []
        adamw_full_set(report, entries)
        print(f"[done] {time.perf_counter() - t_start:.1f} s")
        print(card)
        print(json.dumps({"kernels": entries}))
        return 0
    if only is not None:
        entries = []
        kernels = {"conv": dict(zip([(m, 4) for m in tconv.MODES],
                                    tconv.build_kernels([(m, 4) for m in tconv.MODES]))),
                   "ssd": tssd.build_kernel(), "flash": tfa.build_kernel()}
        tail_lib = tgn.build_kernel().library
        print(f"[build] gated_norm: one nvcc call: {tail_lib.seconds:.1f} s; "
              + ", ".join(f"{k.split('(')[0]} regs {v['regs']} spill {v['local']}"
                          for k, v in register_counts(str(tail_lib.path)).items()))
        mamba2_tail_prefill(report, entries)
        zamba2_7b_prefill(kernels, report, entries)
        print(f"[done] {time.perf_counter() - t_start:.1f} s")
        print(card)
        print(json.dumps({"kernels": entries}))
        return 0

    # -- 2. build: one nvcc per source, all started together -----------------
    conv_items = [(m, W) for W in CONV_WIDTHS for m in tconv.MODES]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=3) as pool:
        conv_job = pool.submit(tconv.build_kernels, conv_items)
        ssd_job = pool.submit(tssd.build_kernel)
        fa_job = pool.submit(tfa.build_kernel)
        tail_job = pool.submit(tgn.build_kernel)
        benches = {n: get_bench(n) for n in STENCIL_BENCHES}
        items = [(b.program, m, b.max_delta) for b in benches.values() for m in MODES]
        kernels = dict(zip([(n, m) for n in benches for m in MODES],
                           build_kernels(items)))
        conv = dict(zip(conv_items, conv_job.result()))
        ssd_kernel = ssd_job.result()
        fa_kernel = fa_job.result()
        tail_job.result()
    build_s = time.perf_counter() - t0
    libs = {str(k.library.path): k.library for k in kernels.values()}
    print(f"[build] {len(kernels)} kernels, {len(libs)} nvcc calls (one per bench) "
          f"together: the longest {max(lib.seconds for lib in libs.values()):.1f} s, "
          f"{build_s:.1f} s with emulation -> build/repro_torch/")
    sass, regs = {}, {}
    for path in libs:
        sass.update(sass_counts(path))
        regs.update(register_counts(path))
    for (name, mode), k in kernels.items():
        if k.symbol not in sass:
            raise RuntimeError(f"{k.symbol} missing from the SASS")
        c = sass[k.symbol]
        # static counts over the march's R outputs; naive and paper hold the
        # march twice (full warps, the edge warp), tile once
        per = {cls: c[cls] / k.spec.steps for cls in SASS_PER_OUTPUT}
        print(f"[sass] {name:<11} {mode:<5} regs {regs[k.symbol]['regs']:>3} "
              f"spill {regs[k.symbol]['local']} | per output: "
              + " ".join(f"{cls} {v:.1f}" for cls, v in per.items()))
        report["sass"][f"{name}/{mode}"] = dict(c, per_output=per, **regs[k.symbol])
    for name, b in benches.items():
        n_pairs = synthesize_cuda(b.program, b.max_delta).n_shuffles
        if sass[kernels[(name, "naive")].symbol]["shfl"] != 0:
            raise RuntimeError(f"{name}: naive kernel contains SHFL")
        if n_pairs and sass[kernels[(name, "paper")].symbol]["shfl"] == 0:
            raise RuntimeError(f"{name}: {n_pairs} detected pairs but no SHFL")
    conv_lib = conv[conv_items[0]].library
    print(f"[build] conv1d: {len(conv_items)} kernels x (f32, bf16) vector widths, "
          f"one nvcc call: {conv_lib.seconds:.1f} s; ssd: one nvcc call: "
          f"{ssd_kernel.library.seconds:.1f} s; flash_attention (Dh 8-128 x f32, "
          f"bf16): one nvcc call: {fa_kernel.library.seconds:.1f} s; all four "
          f"builds together {build_s:.1f} s")
    conv_sass = sass_counts(str(conv_lib.path))
    conv_regs = register_counts(str(conv_lib.path))
    for k in conv.values():
        inst = sass_instances(conv_sass, k.symbol)
        regs = sass_instances(conv_regs, k.symbol)
        if len(inst) != 7:
            raise RuntimeError(f"{k.symbol}: {len(inst)} template instances in the SASS")
        shuffles = {i: c["shfl"] for i, c in inst.items()}
        if (k.spec.mode == "naive") == any(shuffles.values()) or \
                (k.spec.mode == "shuffle" and not all(shuffles.values())):
            raise RuntimeError(f"{k.symbol}: SHFL per instance {shuffles}")
        for i in ("bf16x8", "f32x4"):
            # static counts over the march's S steps; per output vector (one
            # lane's VEC channels at one position)
            per = {cls: inst[i][cls] / tconv.conv1d.STEPS for cls in SASS_PER_OUTPUT}
            inst[i] = dict(inst[i], per_output=per, **regs[i])
            print(f"[sass] {k.symbol:<18} {i:<6} regs {regs[i]['regs']:>3} spill "
                  f"{regs[i]['local']} | per output vector: "
                  + " ".join(f"{cls} {v:.1f}" for cls, v in per.items()))
        report["sass"][k.symbol] = inst
    ssd_counts = sass_counts(str(ssd_kernel.library.path))
    ssd_tc = {f"{part.split('_')[0]} {i}": c
              for part in ("states_kernel", "pass_kernel", "scan_kernel")
              for i, c in tc_instances(ssd_counts, part).items()}
    check_tensor_cores("ssd", ssd_tc, sass_instances(ssd_counts, "ssd_kernel"), report)
    fa_counts = sass_counts(str(fa_kernel.library.path))
    fa_sass = sass_instances(fa_counts, "flash_kernel")
    fa_tc = tc_instances(fa_counts, "flash_wgmma_kernel")
    if len(fa_sass) != 2 * len(tfa.HEAD_DIMS) or len(fa_tc) != len(tfa.TENSOR_CORE_HEAD_DIMS):
        raise RuntimeError(f"flash: {len(fa_sass)} CUDA-core and {len(fa_tc)} tensor-core "
                           f"template instances in the SASS")
    check_tensor_cores("flash_attention", fa_tc, fa_sass, report)

    # -- 3. parity on the card at a ragged medium shape and at shapes ragged
    #       along the march and along i ------------------------------------------
    def stencil_parity(name, prog, shape, seed):
        xs, sc = inputs(prog, shape, seed, dev)
        want = reference(prog, xs, sc)
        outs, errs = [], {}
        for mode in MODES:
            k = kernels[(name, mode)]
            before = k.launches
            out = k(xs, sc)
            torch.cuda.synchronize()
            if k.launches != before + 1:
                raise RuntimeError(f"{k.symbol}: launch count did not move")
            torch.testing.assert_close(out, want, **TOL)
            errs[mode] = float((out - want).abs().max())
            outs.append(out)
        if not all(torch.equal(outs[0], o) for o in outs[1:]):
            raise RuntimeError(f"{name}: modes are not bitwise equal at {shape}")
        return errs

    for i, (name, b) in enumerate(benches.items()):
        prog = b.program
        plan = synthesize_cuda(prog, b.max_delta)
        if not plan.consistent:
            raise RuntimeError(f"{name}: schedule inconsistent with detection")
        shape = MEDIUM[prog.ndim]
        errs = stencil_parity(name, prog, shape, SEED + i)
        ragged = [stencil_parity(name, prog, s, SEED + i)
                  for s in ragged_shapes(prog, MARCH[prog.ndim])]
        report["medium"][name] = {"shape": shape, "shuffles": plan.n_shuffles,
                                  "taps": plan.n_taps, "consistent": plan.consistent,
                                  "max_abs_err": errs, "ragged_max_abs_err": ragged}
        print(f"[parity] {name:<11} shape {shape} shuffles {plan.n_shuffles:>2} "
              f"taps {plan.n_taps:>2} consistent {plan.consistent} max|err| "
              + " ".join(f"{m} {e:.2e}" for m, e in errs.items())
              + f"; {len(ragged)} shapes ragged along the march and i, max|err| "
              + f"{max(max(e.values()) for e in ragged):.2e}; bitwise-equal modes")

    serving_parity(conv, ssd_kernel, report)
    flash_parity(fa_kernel, report)

    # -- 4. the main path at the paper's sizes ------------------------------
    entries = []
    paper_out = {}
    for name, shape in PAPER.items():
        b = benches[name]
        prog = b.program
        torch.cuda.empty_cache()
        xs, sc = inputs(prog, shape, SEED, dev)
        torch.cuda.synchronize()

        reset_launch_counts()
        plan = synthesize_cuda(prog, b.max_delta)          # compile side
        outs = {m: stencil_apply(prog, xs, sc, mode=m, max_delta=b.max_delta)
                for m in MODES}
        torch.cuda.synchronize()
        counts = launch_counts()
        launches = {m: counts[kernels[(name, m)].symbol] for m in MODES}
        if not plan.consistent or any(n < 1 for n in launches.values()):
            raise RuntimeError(f"{name}: main path launches {launches}")

        for o in outs.values():
            if o.shape != outs["naive"].shape or not bool(torch.isfinite(o).all()):
                raise RuntimeError(f"{name}: non-finite or misshapen output")
        if not all(torch.equal(outs["naive"], o) for o in outs.values()):
            raise RuntimeError(f"{name}: modes are not bitwise equal at {shape}")
        paper_out[name] = outs["paper"].cpu()     # held against phase 13
        keep = outs["naive"]
        del outs, o
        torch.cuda.reset_peak_memory_stats()
        plain_t = event_times(lambda: reference(prog, xs, sc), n=3, warmup=1)
        want = reference(prog, xs, sc)
        err = float((keep - want).abs().max())
        torch.testing.assert_close(keep, want, **TOL)
        plain_peak = torch.cuda.max_memory_allocated() / 2**30
        del want

        traffic = traffic_report(prog, shape)
        interior = [s - 2 * h for s, h in zip(shape, reversed(prog.halo))]
        n_out = int(np.prod(interior))
        bytes_ = traffic["compulsory"]
        flops = flops_per_point(prog.expr) * n_out
        bound = {"bytes": bytes_ / HBM_BYTES_PER_S * 1e3,
                 "operations": flops / F32_FLOPS * 1e3}
        bound_by = max(bound, key=bound.get)

        half = int(bytes_ // 8)                       # copy reads + writes bytes_
        src = torch.empty(half, dtype=torch.float32, device=dev)
        dst = torch.empty_like(src)
        copy_ms = statistics.median(event_times(lambda: dst.copy_(src), n=10))
        del src, dst

        library_ms = None
        if name == "jacobi":
            c0, c1, c2 = sc["c0"], sc["c1"], sc["c2"]
            w = torch.tensor([[c2, c1, c2], [c1, c0, c1], [c2, c1, c2]],
                             dtype=torch.float32, device=dev)[None, None]
            x4 = xs["w0"][None, None]
            library_ms = statistics.median(event_times(lambda: F.conv2d(x4, w), n=10))
            torch.testing.assert_close(F.conv2d(x4, w)[0, 0], keep, **TOL)
            del x4
        if name == "tricubic":
            # the separable 4x4x4 weights over w0, plus u + v + s
            wts = torch.tensor([-0.0625, 0.5625, 0.5625, -0.0625], device=dev)
            w = (wts[:, None, None] * wts[None, :, None] * wts[None, None, :])[None, None]
            x5 = xs["w0"][None, None]
            inner = (slice(2, -2),) * 3

            def library():
                frac = xs["u"][inner] + xs["v"][inner] + xs["s"][inner]
                return F.conv3d(x5, w)[0, 0, 1:, 1:, 1:] + frac

            library_ms = statistics.median(event_times(library, n=5, warmup=1))
            torch.testing.assert_close(library(), keep, **TOL)
            del x5
        del keep

        rec = {"shape": shape, "compulsory_bytes": bytes_, "traffic": traffic,
               "bound_ms": bound[bound_by], "bound_by": bound_by,
               "plain_ms": statistics.median(plain_t), "plain_peak_gib": plain_peak,
               "copy_ms": copy_ms, "library_ms": library_ms, "modes": {}}
        for m in MODES:
            k = kernels[(name, m)]
            ms = statistics.median(event_times(lambda: k(xs, sc), n=10))
            rec["modes"][m] = {"ms": ms, "launches": launches[m],
                               "gbps": bytes_ / ms / 1e6}
            entries.append({
                "name": f"stencil_{m}[{name}]", "route": "cuda",
                "source": SOURCE, "replaces": REPLACES,
                "launches": launches[m], "max_abs_err": err, "ms": ms,
                "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                "bound_by": bound_by, "library_ms": library_ms})
            print(f"[paper-size] {name} {shape} {m:<5} {ms:.3f} ms "
                  f"{rec['modes'][m]['gbps']:.0f} GB/s compulsory, bound "
                  f"{rec['bound_ms']:.3f} ms ({bound_by}), "
                  f"model bytes {traffic[m]:.3e}, "
                  f"launches {launches[m]}")
        print(f"[paper-size] {name} plain {rec['plain_ms']:.2f} ms (peak "
              f"{plain_peak:.1f} GiB) max|err| {err:.2e}, copy_ms {copy_ms:.3f}, "
              f"library_ms {library_ms}")
        report["paper"][name] = rec
        del xs

    # phases 2-4 analysed every paper plan and conv1d shuffle build through the
    # default compiler session: one miss per distinct lowered kernel, hits after
    session = default_compiler()
    main_stats = session.cache_stats.snapshot()
    distinct = len(STENCIL_BENCHES) + len(CONV_WIDTHS)
    report["compiler_cache"] = {"after_phase_4": main_stats.to_dict(), "distinct": distinct}
    print(f"[compile] default session after phase 4: {main_stats.summary}; "
          f"{distinct} distinct kernels ({len(STENCIL_BENCHES)} benches' paper plans, "
          f"conv1d widths {', '.join(map(str, CONV_WIDTHS))})")
    if main_stats.misses != distinct or main_stats.hits < 1 or main_stats.disk_hits \
            or main_stats.disk_misses:
        raise RuntimeError(f"default session after phase 4: {main_stats}, expected "
                           f"{distinct} misses and memory hits only")

    # -- 5-7. the serving paths at full width: mamba2-1.3b, zamba2-1.2b, the
    #         dense olmo-1b and yi-9b, the MoE granite and the enc-dec
    #         seamless; starcoder2-3b, kimi-k2 and llama-vision reduced only --
    serving_kernels = {"conv": conv, "ssd": ssd_kernel, "flash": fa_kernel}
    for arch in (MAMBA, HYBRID, *DENSE, MOE, ENCDEC):
        torch.cuda.empty_cache()
        serving_path(arch, serving_kernels, report, entries)
    for arch in REDUCED_ONLY:
        reduced_card_vs_cpu(report["serving"].setdefault(arch, {}), arch)

    # -- 7b. Zamba2-7B-Instruct at its published widths ------------------------
    torch.cuda.empty_cache()
    zamba2_7b_prefill(serving_kernels, report, entries)

    # -- 7c. the mixer's tail at Mamba-2's 8 x 4096 prefill ---------------------
    torch.cuda.empty_cache()
    mamba2_tail_prefill(report, entries)

    # -- 7d. AdamW alone over Mamba-2's parameters -------------------------------
    torch.cuda.empty_cache()
    adamw_full_set(report, entries)

    # -- 8. training: reduced card vs CPU, the loss falling, a checkpoint
    #       round trip; olmo-1b, mamba2-1.3b and granite at full width -------
    torch.cuda.empty_cache()
    training_path(serving_kernels, report, entries)

    # -- 9-10. the mesh path at world size 1 over NCCL, and the sharded MoE
    #          dispatch on it --------------------------------------------------
    mesh_path(report, serving_kernels, entries)

    # -- 11. the dry run's cells, on the host --------------------------------------
    dryrun_phase(report)

    # every later analysis of a program phases 2-4 analysed was a memory hit
    end_stats = session.cache_stats.snapshot()
    report["compiler_cache"]["after_phase_11"] = end_stats.to_dict()
    print(f"[compile] default session after phase 11: {end_stats.summary}")
    if end_stats.misses != distinct:
        raise RuntimeError(f"default session after phase 11: {end_stats}, expected "
                           f"still {distinct} misses")

    # -- 12. the compile side on the card's machine ---------------------------------
    compile_side(report, benches)

    # -- 13. the full middle-end and the compile service ------------------------------
    held = middle_end_service(report, benches, kernels, paper_out)
    del paper_out

    # -- 14. the fleet: replicas over a network cache tier, and the stencil plans
    #        taken from that tier ---------------------------------------------------
    fleet_phase(report, benches, kernels, held)
    del held

    # -- 15. records -----------------------------------------------------------
    report["card"] = card
    report["seconds"] = time.perf_counter() - t_start
    os.makedirs(os.path.dirname(REPORT), exist_ok=True)
    with open(REPORT, "w") as f:
        json.dump(report, f, indent=1, default=str)
    print(f"[done] {report['seconds']:.1f} s")
    print(card_line())
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
