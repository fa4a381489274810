#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # full size, one card, ~13-19 minutes; no options

Phases, each an assertion (any failure exits non-zero and prints no result):

1. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (nvcc, sm_90a);
2. hold each per-op kernel (TRSV, TRSM, GEMV, GEMM, panel TRSV, grouped
   GEMV) against its plain PyTorch version on the card, rtol = atol = 2e-5
   (float32; the kernels and the plain versions sum in different orders),
   bit-identical on dyadic batches; grouped GEMV bit-equal to GEMV (groups
   of 1, 4, 8 and 40, also for a batch that is no multiple of the group),
   each GEMM column bit-equal to the GEMV of that column alone and each
   TRSM column to the TRSV of that column alone; at B = 7, 8, 16 and 32
   the GEMV, every GEMM column (R = 1, 2, 3, 8, 16, 17), the grouped GEMV,
   the TRSV and every TRSM column bit-equal to the bit oracles
   (``ref.gemv_bits_ref``, ``ref.rowsweep_bits_ref``, run on the host), the
   TRSV also at k = 1, 32 and 4096 tiles, and the panel TRSV bit-equal to
   ``ref.panel_bits_ref`` at (B, P) = (8, 4), (16, 8), (24, 3), (24, 6),
   (32, 1), (32, 8), (32, 32) and k = 1, 17, 1003;
3. the main path at full size: the suite's ``delaunay_n20`` generator at its
   Table-I size (``grid2d_factor(1024, seed=6)``, n = 1,048,576, B = 32,
   levelset, taskpool) through ``SpTRSVContext().analyse`` -> ``solve`` for
   ``L x = b``, ``L^T x = b`` and an (n, 8) panel, each within 2e-4
   (``max|x - x_ref| / max|x|``) of scipy; every kernel must have been
   launched by this phase, exactly once per level that has work; then a
   forward solve with ``PlanOptions(gemv_group=8)`` (one grouped GEMV per
   level with updates) and the panel TRSV's entry point
   (``ops.batched_block_trsv(algorithm="panel")``) on every level's tiles;
4. IC(0)-PCG (``solve_ic0_pcg``) on the SPD matrix of ``grid2d_factor(512)``
   to ``tol = 1e-6``: the true residual must be within 10 * tol and each
   triangular sweep must run once per iteration;
5. the superstep megakernel (``PlanOptions(kernel="fused")``, held resident:
   ``REPRO_TORCH_STREAM_LIMIT`` above the plan's store for the phase, the
   plan reporting ``streamed`` false) on the same
   factor: forward, transpose and (n, 8) panel solves each within 2e-4 of
   scipy, each exactly one megakernel launch and no per-level kernel
   launch, two forward solves bit-equal; the kernel against its plain
   version (bit-identical on a dyadic problem, within 2e-4 on
   ``grid2d_factor(256)`` and on the full factor); fused IC(0)-PCG with
   phase 4's iterations and residual bound;
6. the streamed megakernel (``PlanOptions(kernel="fused_streamed")``) on the
   same factor: the same three solves, each one streamed launch and
   bit-equal to phase 5's result; the kernel against its plain version
   (bit-identical on the dyadic problem at B = 16 and B = 7, within 2e-4 at
   side 256 and full size); a refresh solving with the new values;
   streamed IC(0)-PCG; its times, and the streamed-vs-resident time per
   solve at sides 256, 512 and 1024;
7. the syncfree executor (``PlanOptions(sched="syncfree")``) on the same
   factor, its dense scan (``kernel="cuda"``) and its frontier-bucketed form
   (``kernel="fused"``): forward, transpose and (n, 8) panel solves each
   within 2e-4 of scipy, each launching the block TRSV (TRSM) once per
   level and the GEMV (GEMM) once per level (dense) or once per level that
   sources tiles (frontier), no plain version run; a refresh to dyadic
   values with ``b = L x`` for an integer ``x`` (every partial sum exact,
   so any correct order gives ``x``): forward and transpose bit-equal to
   the megakernel's and to ``x``; the block kernels at the largest batches
   each form hands them (dense: every local row and every tile;
   frontier: the top ladder rungs), R = 1 and 8, on the solve's data,
   against their plain versions and (TRSV, GEMV) their bit oracles, each
   panel column bit-equal to the vector kernel; syncfree IC(0)-PCG
   (frontier form) with its exact launch counts;
8. ILU(0)-BiCGStab (``solve_ilu0_bicgstab``) on phase 4's system under
   ``kernel="cuda"``, ``"fused"`` (held resident as in phase 5) and
   ``"fused_streamed"``: converged, the
   true residual within 10 * tol, two L and two U solves per iteration, and
   exactly the backend's launches (one megakernel launch per triangular
   solve for the fused forms, one TRSV and GEMV per level with work for
   ``cuda``; three GEMV launches per matvec);
9. telemetry, calibration and auto (seconds per sub-step printed):
   (a) a traced session (``obs.trace.trace_to``) over phase 3's factor —
   analyse, solve, factorize, solve, transpose solve — whose spans include
   ``sptrsv.analyse``, ``.partition``, ``.schedule``, ``.solve``,
   ``.factorize`` and ``.refresh``, every parent present; dyadic solves
   bit-equal with tracing on and off under ``cuda``, ``fused``,
   ``fused_streamed`` and syncfree ``fused``; a ``torch.profiler`` capture
   of a traced switch solve holding ``sptrsv.level_solve`` ranges; the
   switch forward ms with tracing off and on (5 alternating pairs);
   (b) that session's ``metrics_snapshot``: ``plan.*`` equal to
   ``dispatch_stats`` and ``cut_stats``, ``session.solves`` and the
   ``session.solve_us`` count equal to the solves made; (c) the measured
   weights ``calibrate_weights(B, "cuda")`` at B = 16 and 32 (finite,
   ``w_solve == 1``, tile weights >= 0, the measured ones); (d) the
   resident/streamed table (``perf/stream_crossover.py`` at sides 32-256,
   B = 16 and 32) beside phase 6's, and ``stream_limit()``; plain ``fused``
   at full size on the dyadic twin takes the form the table finds faster
   there, one launch of that kernel per solve, bit-equal to phase 7's
   resident solve; where the table finds resident faster, plain ``fused``
   stays resident; (e) ``PlanOptions(sched="auto", kernel="auto",
   probe_solves=3)`` on phase 4's system, probed at R = 1 and R = 8 (the
   stream limit above its store, so ``fused`` is probed resident beside
   ``fused_streamed``): the winner the fastest probe, its solve within 2e-4
   of scipy, one calibration sample per probed candidate, a calibrated
   stream limit; the store saved to a file and reloaded into a fresh store,
   a second session with ``probe_solves=0`` resolving ``modelled``, and
   ``calibrate_weights`` then returning the fitted weights;
10. the verifier, the plan store and the solve service (seconds per
   sub-step printed): (a) ``verify_plan(level="strict")`` passes on every
   plan the smoke built on the factor (phase 3's, 5's, 6's and 7's, forward
   and transpose) and on a dagpart plan, host seconds each; a copy with the
   solve slots of levels 1 and 2 swapped fails with ``hb.upd.src-before``
   and ``hb.upd.dest-after``; (b) under ``kernel="cuda"`` and ``"fused"``
   a cold session with a ``PlanStore`` analyses and saves, and a fresh one
   on the store makes 0 analyses, 1 store hit (2 after its transpose solve)
   and 0 rejections, its forward, transpose and (n, 8) solves of the
   dyadic twin bit-equal to the cold session's; (c) under ``"cuda"`` and
   plain ``"fused"``, ``launch/serve_solve.py`` serves 48 requests of 4
   tenants (``max_batch`` 8; hot pattern ``grid2d_factor(SERVICE_SIDE)``,
   n = 262,144, and a cold tail) cold on exact dyadic problems — every
   ticket exact and bit-equal to a solo solve of its column, TRSV/TRSM and
   GEMV/GEMM once per level with work per batch (``cuda``) or one
   megakernel launch per batch (``fused``), no plain version — then warm
   on real values (0 analyses, hit rate 1, every solution within 2e-4 of
   scipy), then from the engine's background thread to 16 blocking
   tenants with the cold run's bits; (d) ``launch/solve.py --matrix
   webbase-1M --scale CLI_SCALE --verify`` (n = 996,000) exits 0 within
   2e-4 of scipy;
11. multi-device ``comm="unified"`` (seconds per sub-step printed): (a)
   ``UNIFIED_RANKS`` processes, one gloo group, all on ``cuda:0``, each
   ``SpTRSVContext(device="cuda:0", group=...)`` on phase 3's factor (each
   rank half the tiles; a non-empty cut), every plan strict-verified:
   plain ``fused`` (the streamed split form) levelset forward and
   transpose and dagpart forward, the resident split form
   (``REPRO_TORCH_STREAM_LIMIT`` above the store) and ``kernel="cuda"``
   (the block kernels once per level with work) forward, each within 2e-4
   of scipy with exactly ``n_supersteps`` launches of the split form and
   ``n_supersteps`` exchanges, as ``dispatch_stats`` says, and no plain
   version; the dyadic twin under ``fused``, resident and ``cuda``, every
   rank's ``x`` equal to ``x_int``; an (n, 8) panel of
   ``grid2d_factor(PCG_SIDE)`` under ``fused``; ms per solve beside the
   one-device megakernel's; (b) the split kernel, resident and streamed,
   against its plain version on one launch of a dagpart merged step with
   non-zero carries (bit-equal on a dyadic problem, within 2e-4 on the
   factor's widest merged step, timed there); (c) ``launch/solve.py
   --comm unified --dist-backend gloo --device cuda:0`` under
   ``torch.distributed.run`` with ``UNIFIED_RANKS`` ranks exits 0. These
   ranks share one card through gloo over host memory: no interconnect is
   measured;
12. multi-device ``comm="zerocopy"`` and ``sched="syncfree"``, run by phase
   11's ranks after phase 11 (a fresh session on each): (a) the same forms
   as phase 11 under ``comm="zerocopy"`` — plain ``fused`` (the streamed
   split form, one launch per exchange segment) forward and transpose and
   dagpart forward, the resident split form and ``kernel="cuda"`` forward,
   the dyadic twin under ``fused``, resident and ``cuda`` (``x_int``
   exactly), the (n, 8) panel of ``grid2d_factor(PCG_SIDE)`` — each with
   as many packed exchanges and split launches as ``dispatch_stats`` says;
   syncfree under ``comm="zerocopy"``, dense (``cuda``) and frontier
   (``fused``) forward and on the dyadic twin, and under ``comm="unified"``
   one forward solve each: ``n_levels`` sweeps, one exchange each, one
   TRSV and GEMV per sweep (dense) or per sweep where the rank has rows or
   tiles (frontier); every solve within 2e-4 of scipy, every plan
   strict-verified, no plain version; ms per solve on rank 0 beside phase
   11's and the one-device time, exchanges and bytes all-reduced per
   solve; (b) the split kernel, resident and streamed, with a zero ``acc``
   over the widest zerocopy segment against its plain version, timed
   there; (c) ``launch/solve.py --sched syncfree`` (its default ``--comm
   zerocopy``) under ``torch.distributed.run`` exits 0;
13. the multi-device tail, run by phase 11's ranks after phase 12 (fresh
   sessions; seconds per sub-step printed): (a) ``SpMV(plan, "cuda:0",
   group)`` on phase 4's system: every rank's ``y`` bit-equal to the
   one-device SpMV on its dyadic twin (a vector and an (n, 8) panel),
   within ``TOL_KERNEL`` on real values, exactly three GEMV (GEMM) launches
   and one ``all_reduce`` of the padded ``y`` a matvec, no plain version;
   ms a matvec beside one device; (b) IC(0)-PCG and ILU(0)-BiCGStab with
   ``group=`` under ``comm="zerocopy"``, plain ``fused``: converged, the
   true residual within 10 * tol, PCG within one iteration of phase 5's,
   BiCGStab phase 8's ``fused`` iterations and within ``TOL_SOLVE`` of
   scipy, both ranks the same iterations, history and bits of ``x``, the
   split launches ``dispatch_stats`` gives per solve, three GEMV launches
   a matvec, no plain version; (c) ``"auto"`` on
   ``grid2d_factor(AUTO_SIDE)``, probed (``probe_solves=1``) and modelled:
   both comm modes in the grid, every rank the same choice, scores and
   probe times, the calibration file written by rank 0 alone; (d) the plan
   store on phase 3's dyadic twin: cold sessions analyse and rank 0 alone
   saves, warm sessions hit once and analyse nothing on every rank, warm
   ``x`` == cold ``x`` == ``x_int``; (e) ``launch/serve_solve.py
   --dyadic --solo-check`` under ``torch.distributed.run`` on the two gloo
   ranks (``SERVE_REQUESTS`` requests, hot pattern
   ``grid2d_factor(SERVICE_SIDE)``, plain ``fused``) exits 0: every ticket
   exact and its solo solve's bits;
14. the streamed megakernel at B > 169, where it copies each tile in row
   chunks (wall time printed): on ``grid2d_factor(PCG_SIDE)`` (n = 262,144)
   and its dyadic twin at each of ``WIDE_BLOCKS`` (176, 256),
   ``kernel="fused_streamed"`` and the resident ``"fused"`` through
   ``SpTRSVContext``: forward, transpose and (n, 8) solves each within 2e-4
   of scipy, streamed bit-equal to resident, one launch each as
   ``dispatch_stats`` says, no plain version; the twin's solves exactly
   ``x``; the shape (W warps a CTA, one CTA an item; rows a stage, shared
   bytes, bytes copied per solve); ms per solve (median, min, max of 5) for
   both forms and cuSPARSE (and its device ms), the kernels alone in turns
   (CUDA events and ``torch.profiler``), the streamed kernel against its
   plain version, its split per level (``perf/profile_solve.py``) and one
   CTA's bulk-copy rate (``perf/bulk_copy.py``); plain ``fused`` takes the
   form measured faster there; the split forms at B = 176 on a merged step
   of a two-device unified plan (bit-equal to their plain versions on a
   shallow dyadic problem, to each other on the real factor, timed there);
   ``perf/stream_crossover.py`` at B = 64, 128, 176, 256. Phase 12's ranks
   also solve the twin with ``comm="zerocopy"``, ``fused_streamed``, at
   B = 176 (the split form in row chunks): ``x`` exactly, its launches as
   ``dispatch_stats`` says.

15. (run after the kernel timings below) the LM serving path (no
   kernel of its own: plain PyTorch on the card),
   TF32 off: (a) every reduced config in float32, the card against the port
   on the CPU (``serve.crosscheck.serve_outputs``, same parameters and
   ``SyntheticLM.batch(0)``): forward logits, the encoder's output, the
   loss and the prefill's logits within rel_err ``TOL_LM`` (1e-5), the
   prefill's token and 16 greedy decode steps equal; (b) ``LM_ARCH``
   (llama3.2-1b) at its full published config, random weights from
   ``SEED``: in float32, batch 2, a 512-token prompt and 32 greedy steps,
   each step's logits within 2e-4 of one full forward over the same tokens
   and the engine's tokens equal to the loop's; ``loss_fn`` at batch 2,
   S = 2048, where ``_flash`` must run once a layer, against the same loss
   on the plain path; in bfloat16 as configured, batch 8, a 512-token
   prompt and 64 new tokens through the engine: prefill tokens/s, decode ms
   per step beside its bound (parameters and KV cache read once), peak
   ``torch.cuda.max_memory_allocated`` and one step's device-busy share
   (``torch.profiler``); (c) ``python -m repro_torch.launch.serve --arch
   llama3.2-1b`` on the card exits 0.
16. (run after 15) the LM training path (plain PyTorch on the card; no
   kernel of its own), TF32 off: (a) every reduced config in float32, the
   card against the port on the CPU from the same parameters and
   ``SyntheticLM.batch(0)``: the loss within rel_err ``TOL_LM`` (1e-5) and
   every gradient within 1e-5 of the tree's largest |gradient| (``remat``
   on), ``remat`` on against off on the card within the same bounds, and
   three ``make_train_step`` steps (``warmup=0``, ``microbatches=2`` for
   ``LM_ARCH``) card against CPU, losses and gradient norms within 1e-5
   (the parameters' difference printed); (b) ``LM_ARCH`` at its
   full published config in float32, batch 1, S = 2048 (``_flash`` on its
   differentiable path, counted once a layer, recomputations not counted):
   the loss and every gradient with ``remat`` off and on the plain
   attention path against flash with ``remat``, within ``TOL_LM_GRAD``
   (1e-4) of the largest gradient, the peak memory of each; (c) in
   bfloat16 as configured, batch 4, S = 2048, through ``make_train_step``:
   the median ms of 8 steps after 2 warm-up steps, tokens/s, the model
   FLOPs ``6 N_active tokens`` and their share of the dense bf16 peak,
   peak ``torch.cuda.max_memory_allocated`` above what the earlier phases
   hold, one step's device-busy share and kernel count
   (``torch.profiler``), and on a repeated batch with ``warmup=0`` the loss
   after 8 steps below the first step's, finite throughout; (d) that run's
   parameters and AdamW moments saved by ``CheckpointManager`` under
   ``build/`` and restored to the card bit-equal, and a reduced run that
   stops after step 9 and resumes to step 14 giving the uninterrupted run's
   losses within rtol 1e-5; (e) ``python -m repro_torch.launch.train --arch
   llama3.2-1b --steps 3`` on the card exits 0.
17. (run after 16) the LM sharding layer (no kernel of its own), (a) and
   (b) side by side: (a) in a spawned process, on fake worlds of 256 and 512 ranks (torch's ``fake``
   backend; no communication), every applicable cell's ``input_specs`` on
   the production mesh (16 x 16, 2 x 16 x 16): every leaf a meta DTensor,
   every spec dividing its dim, each local shape the spec's share, every
   leaf of at least 2^24 elements sharded on some axis; per cell the
   argument bytes a rank holds (parameters + AdamW state, or parameters +
   cache; counted from the local shapes, not a measured memory size) and
   the model FLOPs; (b) ``SHARD_RANKS`` (4) gloo ranks sharing the card on
   a 2 x 2 ``("data", "model")`` mesh, each drawing ``LM_ARCH``'s full
   bf16 parameters from ``SEED`` on the card and placing them by
   ``shard_tree`` on ``param_specs(..., fsdp_axes=dp_axes(mesh))``: every
   local shard bit-equal to the slice its spec names (pod/data-major, as
   the reference splits), its bytes the spec's count; ``embed`` gathered
   back across the ranks on card tensors through the mesh's gloo groups
   (``dist.all_gather`` per mesh dim: DTensor's ``full_tensor()`` dies of
   a segmentation fault on gloo with CUDA tensors in torch 2.11),
   bit-equal; the same for float32 AdamW moments; per-rank bytes and
   seconds.
18. (run after 17) the LM steps on a mesh (no kernel of its own):
   ``MESH_RANKS`` (4) ranks sharing the card on a 2 x 2 ``("data",
   "model")`` mesh, their group on the ``staged`` backend
   (``repro_torch.distributed.staged``: each collective through gloo on
   host copies); (a) every reduced config in float32: three train steps
   through ``make_train_step(mesh=...)`` and a prefill with four greedy
   decode steps through the mesh serve steps, against the same steps with
   no mesh on the card, loss and ``gnorm`` within ``TOL_MESH`` relative,
   tokens equal, and the first batch's gradients leaf by leaf within
   ``TOL_MESH`` of the largest; the train steps have no warm-up, so the
   first runs at the peak learning rate; (b) ``LM_ARCH`` at its full
   published width in float32 at batch 1, S = 2048: the gradients on the
   mesh (every rank's shards against their slices of the gradients with
   no mesh, of the largest) and the loss, then one train step at the peak
   learning rate (loss, ``gnorm``), within ``TOL_MESH``; the parameters
   after it are printed, not gated (AdamW's first step turns rounding in
   gradient entries near its eps into changes of up to twice the learning
   rate); bf16 train steps at batch 4, S = 2048 with ``remat`` and FSDP
   (the slowest timed step), and bf16 serving at batch 8 (a 512-token
   prompt, 64 new tokens, after a warm-up pass as in 15b), ms a step and
   peak memory a rank beside phases 16c and 15b's numbers with no mesh.

Then it times each kernel at the main path's shapes (CUDA events), beside
its plain version, the one-call PyTorch equivalent and its bound (for the
row-sweep kernels also ``chain_bound_ms``: B times one dependent division
and FMA, measured by ``perf/chain_latency.py``'s microbenchmark); times
each block kernel's device work alone (``torch.profiler``'s
``key_averages()``, without the host's launch gaps), also at k = 4096
tiles; times the GEMV family
and ``torch.bmm`` at the tile count of phase 4's SpMV, and the four per-op
kernels at the syncfree dense scan's batches (``at_dense_scan``); prints them as one
``{"kernels": [...]}`` line, and ends with the line
``{"ok": true, "device": {...}}``. It needs the repository's ``src/`` next to
it and a CUDA device; without either it exits non-zero.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

SIDE = 1024  # main-path factor: grid2d_factor(SIDE), n = SIDE^2, delaunay_n20 size
# IC(0)-PCG and ILU(0)-BiCGStab system, cut from SIDE: the host-side ic0 and
# ilu0 factorizations are Python loops
PCG_SIDE = 512
# phase 10: the served mix's hot pattern, grid2d_factor(SERVICE_SIDE) (the
# size phase 9e probes), and launch/solve.py's webbase-1M at n ~ 1M
SERVICE_SIDE = 512
CLI_SCALE = 83
SEED = 0  # right-hand sides and kernel-check inputs
TOL_KERNEL = 2e-5
TOL_SOLVE = 2e-4
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
PEAK_FP32_PER_S = 67e12  # H100 SXM float32 outside the tensor cores

# file:line of the Pallas kernel each CUDA kernel replaces, and its source
KERNELS = {
    "block_trsv": ("src/repro/kernels/block_trsv.py:22", "block_trsv.cu"),
    "block_trsm": ("src/repro/kernels/block_trsv.py:77", "block_trsv.cu"),
    "block_gemv": ("src/repro/kernels/block_spmv.py:23", "block_spmv.cu"),
    "block_gemm": ("src/repro/kernels/block_spmv.py:54", "block_spmv.cu"),
    "block_trsv_panel": ("src/repro/kernels/block_trsv.py:41", "block_trsv.cu"),
    "block_gemv_grouped": ("src/repro/kernels/block_spmv.py:30", "block_spmv.cu"),
    "superstep": ("src/repro/kernels/superstep.py:146", "superstep.cu"),
    "superstep_streamed": ("src/repro/kernels/superstep.py:182", "superstep.cu"),
    # split_delta=True (the carries at :163, the solve's rhs at :237)
    "superstep_split": ("src/repro/kernels/superstep.py:163", "superstep.cu"),
    "superstep_streamed_split": ("src/repro/kernels/superstep.py:237", "superstep.cu"),
    # the streamed forms at B >= 170, each tile copied in row chunks (phase 14)
    "superstep_streamed_chunked": ("src/repro/kernels/superstep.py:182", "superstep.cu"),
    "superstep_streamed_split_chunked": ("src/repro/kernels/superstep.py:237", "superstep.cu"),
}
# the wrapper (ops.KERNELS name) that launches each row's kernel
WRAPPER = {"superstep_streamed_chunked": "superstep_streamed",
           "superstep_streamed_split_chunked": "superstep_streamed_split"}
PER_OP = ("block_trsv", "block_trsm", "block_gemv", "block_gemm")
# the __global__ function that serves each block kernel at the timed shapes
# (B = 32), matched in the profiler's kernel name whether demangled
# ("...::gemm_kernel(float const*, ...)", "...::trsv_panel_sweep_kernel<8>(")
# or not ("_ZN12_GLOBAL__N_111gemm_kernelEPKf...", "...kernelILi8EEEvPKf..."),
# and the kernels of a cuBLAS call (torch.bmm, torch.linalg.solve_triangular);
# the device-only times count these alone
DEVICE_SYMBOL = {
    "block_trsv": "trsv_kernel", "block_trsm": "trsm_kernel",
    "block_gemv": "gemv_grouped_kernel", "block_gemm": "gemm_kernel",
    "block_trsv_panel": "trsv_panel_sweep_kernel", "block_gemv_grouped": "gemv_grouped_kernel"}
DEVICE_KERNEL = {name: rf"(?<![A-Za-z_]){sym}(?=[(<EI ]|$)"
                 for name, sym in DEVICE_SYMBOL.items()}
ROW_SWEEPS = ("block_trsv", "block_trsm", "block_trsv_panel")  # rows with a chain_bound_ms
PANEL_BP = ((8, 4), (16, 8), (24, 3), (24, 6), (32, 1), (32, 8), (32, 32))  # panel oracle
LIBRARY_KERNEL = r"(?i)gemm|gemv|trsm|trsv|xmma|cutlass|cublas|sm90_"
GEMM_KERNEL = r"(?i)gemm|gemv|xmma|cutlass|cublas|sm90_|nvjet"  # cuBLAS's matmul kernels
ORACLE_CHUNK = 4096  # tiles per host oracle call at the syncfree shapes
UNIFIED_RANKS = 2  # phase 11: gloo ranks, all on cuda:0
UNIFIED_TIMEOUT = 720  # seconds phase 11's ranks may take (phases 11-13)
AUTO_SIDE = 256  # phase 13c: "auto" at D = 2 on grid2d_factor(AUTO_SIDE), B = 32
SERVE_REQUESTS = 16  # phase 13e: the dyadic mix served on two ranks
WIDE_BLOCKS = (176, 256)  # phase 14: the streamed kernel in row chunks, on grid2d_factor(PCG_SIDE)
CROSSOVER_BLOCKS = (64, 128, 176, 256)  # phase 14: perf/stream_crossover.py's ladder
LM_ARCH = "llama3.2-1b"  # phase 15b: the full published config, random weights
LM_REDUCED_STEPS = 16  # phase 15a: greedy steps after each reduced config's prefill
LM_PROMPT = 512  # phase 15b: prompt tokens
LM_FP32 = (2, 32)  # phase 15b: batch, greedy steps each held to a full forward (fp32)
LM_BF16 = (8, 64)  # phase 15b: batch, new tokens timed in bfloat16
LM_LOSS_SEQ = 2048  # phase 15b: loss_fn's sequence length, where _flash runs
TOL_LM = 1e-5  # phase 15a: reduced configs, card vs CPU (rel_err)
TOL_LM_DECODE = 2e-4  # phase 15b: each fp32 decode step vs the full forward (rel_err)
LM_TRAIN_FP32 = (1, 2048)  # phase 16b: batch, S of the fp32 gradients (_flash differentiable)
LM_TRAIN_BF16 = (4, 2048)  # phase 16c: batch, S of the bf16 train steps
LM_TRAIN_STEPS = (2, 8)  # phase 16c: warm-up steps, timed steps
LM_TRAIN_FIT = 8  # phase 16c: steps on a repeated batch after its first
SHARD_RANKS = 4  # phase 17b: gloo ranks sharing one card
SHARD_MESH = (2, 2)  # phase 17b: the ("data", "model") mesh of those ranks
LM_TRAIN_PARITY_STEPS = 3  # phase 16a: make_train_step steps card vs CPU per reduced config
MESH_RANKS = 4  # phase 18: ranks sharing the card (the "staged" backend)
MESH_SHAPE = (2, 2)  # phase 18: their ("data", "model") mesh
MESH_REDUCED = (4, 32, 3, 16, 4)  # phase 18a: batch, S, train steps; prompt, decode steps
MESH_GATE = (1, 2048)  # phase 18b: batch, S of the float32 gate step
MESH_TRAIN_BF16 = (4, 2048, 1, 2)  # phase 18b: batch, S, warm-up and timed bf16 steps
MESH_SERVE_BF16 = (8, 64)  # phase 18b: batch, new tokens (LM_PROMPT-token prompt)
TOL_MESH = 1e-5  # phase 18: mesh against no mesh (relative; parameters of the largest)
TOL_LM_GRAD = 1e-4  # phase 16b: fp32 gradients, of the tree's largest |gradient|
PEAK_BF16_PER_S = 989e12  # H100 SXM dense bf16 tensor cores, NVIDIA data sheet
# each megakernel instantiation's name in the profiler, demangled or not
MEGAKERNEL_SYMBOL = {
    (stream, split): rf"superstep_kernel(<{str(stream).lower()}, {str(split).lower()}>"
                     rf"|ILb{int(stream)}ELb{int(split)}E)"
    for stream in (False, True) for split in (False, True)}


def fail(msg: str) -> None:
    print(f"[smoke] FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def log(msg: str) -> None:
    print(f"[smoke] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def rel_err(x, ref) -> float:
    import numpy as np

    return float(np.abs(x - ref).max() / np.abs(x).max())


def time_ms(fn, iters: int = 200, warmup: int = 10) -> float:
    """Mean time of one call over ``iters`` back-to-back calls, by CUDA
    events on the current stream (the gaps the host leaves count too)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, kernel: str, iters: int = 50) -> float | None:
    """Mean device time of one call (ms) of the kernels whose name matches
    the regular expression ``kernel`` (searched in the profiler's kernel
    name), as ``torch.profiler``'s ``key_averages()`` report them over
    ``iters`` calls, without the host's gaps between launches; any other
    kernel the call launches (a fill, a copy) is left out. Profiles twice at
    most; ``None``, logged with the kernel names it did see, if no kernel
    matches."""
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        us = sum(e.self_device_time_total for e in events if re.search(kernel, e.key))
        if us > 0:
            return us / 1e3 / iters
    log(f"device_ms: no kernel matching {kernel!r} in the profile; saw "
        f"{sorted({e.key for e in events})}")
    return None


def bound(name: str, k: int, B: int, R: int) -> tuple[float, str]:
    """Least time (ms) for the work: each input read once, each output
    written once, at peak bandwidth; its float32 operations at peak rate."""
    if name.startswith("block_tr"):
        nbytes = 4 * k * (B * (B + 1) // 2 + 2 * B * R)  # lower triangle + rhs + x
        flops = k * B * B * R  # B(B-1)/2 multiply-adds and B divides per column
    else:
        nbytes = 4 * k * (B * B + 2 * B * R)
        flops = 2 * k * B * B * R
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_FP32_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_kernels(ops, ref, torch, seed: int) -> dict:
    """Every kernel against its plain version at the test shapes; ``ops``
    is :mod:`repro_torch.kernels.ops`, whose ``KERNELS`` are the wrappers."""
    trsv, trsm = ops.KERNELS["block_trsv"], ops.KERNELS["block_trsm"]
    gemv, gemm = ops.KERNELS["block_gemv"], ops.KERNELS["block_gemm"]
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def uniform(*shape):
        return torch.rand(*shape, device="cuda", generator=gen) * 2 - 1

    def tri(k, B):
        L = torch.tril(uniform(k, B, B))
        idx = torch.arange(B, device="cuda")
        L[:, idx, idx] = 2.0 + (uniform(k, B) + 1) / 2
        return L

    err = {name: 0.0 for name in PER_OP + ("block_trsv_panel", "block_gemv_grouped")}

    def compare(name, got, want):
        torch.cuda.synchronize()
        ok = torch.allclose(got, want, rtol=TOL_KERNEL, atol=TOL_KERNEL)
        check(bool(ok) and got.shape == want.shape,
              f"{name} disagrees with its plain version at {tuple(got.shape)}: "
              f"max abs err {float((got - want).abs().max()):.3e}")
        err[name] = max(err[name], float((got - want).abs().max()))

    for B in (8, 16, 32, 64):
        for k in (1, 17, 1000):
            L, r = tri(k, B), uniform(k, B)
            x = trsv(L, r)
            compare("block_trsv", x, ref.block_trsv_ref(L, r))
            for R in (2, 8):
                rp = uniform(k, B, R)
                xp = trsm(L, rp)
                compare("block_trsm", xp, ref.block_trsv_ref(L, rp))
                for c in range(R):  # each column is swept as the TRSV sweeps it alone
                    check(torch.equal(xp[..., c], trsv(L, rp[..., c].contiguous())),
                          f"block_trsm column {c} != independent block_trsv at B={B} k={k} "
                          f"R={R}")
    for B in (8, 32, 128):
        for m in (1, 17, 1000):
            T, xv = uniform(m, B, B), uniform(m, B)
            compare("block_gemv", gemv(T, xv), ref.block_gemv_ref(T, xv))
            for R in (1, 2, 3, 4, 8, 16):
                X = uniform(m, B, R)
                Y = gemm(T, X)
                compare("block_gemm", Y, ref.block_gemv_ref(T, X))
                for c in range(R):  # each column is summed as the GEMV sums it alone
                    check(torch.equal(Y[..., c], gemv(T, X[..., c].contiguous())),
                          f"block_gemm column {c} != block_gemv bit for bit at B={B} m={m} R={R}")
    panel, grouped = ops.KERNELS["block_trsv_panel"], ops.KERNELS["block_gemv_grouped"]
    for B in (8, 16, 32, 64):
        for k in (1, 17, 1000):
            L, r = tri(k, B), uniform(k, B)
            compare("block_trsv_panel", panel(L, r), ref.block_trsv_panel_ref(L, r))
    for B in (8, 32, 128):
        for m in (1, 17, 1000, 1003):
            T, xv = uniform(m, B, B), uniform(m, B)
            for G in (1, 4, 8, 40):  # 17 and 1003 are no multiple of 4, 8 or 40
                y = grouped(T, xv, G)
                compare("block_gemv_grouped", y, ref.block_gemv_ref(T, xv))
                check(torch.equal(y, gemv(T, xv)),
                      f"grouped GEMV (G={G}) != block_gemv bit for bit at m={m} B={B}")
    # the bit oracles (plain PyTorch on the host, B <= 32): each kernel's
    # summation order, one float32 operation at a time
    def host(*ts):
        torch.cuda.synchronize()
        return [t.cpu() for t in ts]

    for B in (7, 8, 16, 32):
        k = 1000
        T, xv, L, r = uniform(k, B, B), uniform(k, B), tri(k, B), uniform(k, B)
        want_y, want_x = ref.gemv_bits_ref(*host(T, xv)), ref.rowsweep_bits_ref(*host(L, r))
        check(torch.equal(host(gemv(T, xv))[0], want_y), f"block_gemv != its bit oracle at B={B}")
        for G in (1, 4, 8, 40):
            check(torch.equal(host(grouped(T, xv, G))[0], want_y),
                  f"grouped GEMV (G={G}) != its bit oracle at B={B}")
        check(torch.equal(host(trsv(L, r))[0], want_x), f"block_trsv != its bit oracle at B={B}")
        if B == 32:  # the TRSV at a batch of one tile, the widest level and a wide batch
            for kt in (1, 32, 4096):
                Lk, rk = tri(kt, B), uniform(kt, B)
                check(torch.equal(host(trsv(Lk, rk))[0], ref.rowsweep_bits_ref(*host(Lk, rk))),
                      f"block_trsv != its bit oracle at B={B} k={kt}")
        for R in (1, 2, 3, 8, 16, 17):
            X, rp = uniform(k, B, R), uniform(k, B, R)
            check(torch.equal(host(gemm(T, X))[0], ref.gemv_bits_ref(*host(T, X))),
                  f"a block_gemm column != its bit oracle at B={B} R={R}")
            check(torch.equal(host(trsm(L, rp))[0], ref.rowsweep_bits_ref(*host(L, rp))),
                  f"a block_trsm column != its bit oracle at B={B} R={R}")
    for B, P in PANEL_BP:  # P = 3, 6: no power of two, the products rotated
        for k in (1, 17, 1003):
            L, r = tri(k, B), uniform(k, B)
            check(torch.equal(host(panel(L, r, P))[0], ref.panel_bits_ref(*host(L, r), P)),
                  f"panel TRSV != its bit oracle at B={B} P={P} k={k}")
    # dyadic batches: integer tiles and vectors, every partial sum exact
    for B, k in ((16, 33), (32, 1000)):
        Li = torch.tril(torch.randint(-1, 2, (k, B, B), device="cuda", generator=gen).float(), -1)
        Li += torch.eye(B, device="cuda")
        xi = torch.randint(-3, 4, (k, B), device="cuda", generator=gen).float()
        ri = torch.einsum("kij,kj->ki", Li, xi)
        check(torch.equal(panel(Li, ri), ref.block_trsv_panel_ref(Li, ri)),
              f"panel TRSV != its plain version on a dyadic batch at B={B}")
        check(torch.equal(grouped(Li, xi, 8), ref.block_gemv_ref(Li, xi)),
              f"grouped GEMV != its plain version on a dyadic batch at B={B}")
        Ti = torch.randint(-1, 2, (k, B, B), device="cuda", generator=gen).float()
        for R in (3, 8):  # scalar and float4 column accesses
            Xi = torch.randint(-3, 4, (k, B, R), device="cuda", generator=gen).float()
            check(torch.equal(gemm(Ti, Xi), ref.block_gemv_ref(Ti, Xi)),
                  f"GEMM != its plain version on a dyadic batch at B={B} R={R}")
    # an empty batch launches nothing
    before = ops.launch_counts()
    check(trsv(tri(0, 8), uniform(0, 8)).shape == (0, 8), "k=0 TRSV shape")
    check(gemv(uniform(0, 8, 8), uniform(0, 8)).shape == (0, 8), "m=0 GEMV shape")
    check(ops.launch_counts() == before, "a k=0 call launched a kernel")
    torch.cuda.synchronize()
    return err


def hold_at_path_shape(kops, ref, torch, pair, mat, vec, panel, err: dict,
                       where: str) -> None:
    """The block kernels ``pair`` (TRSV and TRSM, or GEMV and GEMM) on the
    batches a path hands them, ``mat`` with ``vec`` (k, B) and ``panel``
    (k, B, R): each against its plain version (``TOL_KERNEL``), the vector
    form bit for bit against its oracle on the host (B <= 32, in chunks of
    tiles), each panel column against the vector form of that column alone."""
    vec_k, panel_k = pair
    plain = ref.block_trsv_ref if vec_k == "block_trsv" else ref.block_gemv_ref
    oracle = ref.rowsweep_bits_ref if vec_k == "block_trsv" else ref.gemv_bits_ref
    got = {}
    for name, v in ((vec_k, vec), (panel_k, panel)):
        got[name], want = kops.KERNELS[name](mat, v), plain(mat, v)
        torch.cuda.synchronize()
        e = float((got[name] - want).abs().max())
        check(bool(torch.allclose(got[name], want, rtol=TOL_KERNEL, atol=TOL_KERNEL)),
              f"{name} disagrees with its plain version at {where} {tuple(v.shape)}: {e:.3e}")
        err[name] = max(err[name], e)
    if mat.shape[-1] <= 32:
        for s0 in range(0, mat.shape[0], ORACLE_CHUNK):
            m, v, g = (t[s0:s0 + ORACLE_CHUNK].cpu() for t in (mat, vec, got[vec_k]))
            check(torch.equal(g, oracle(m, v)),
                  f"{vec_k} != its bit oracle at {where} {tuple(vec.shape)}, tiles {s0}..")
    for c in range(panel.shape[-1]):
        check(torch.equal(got[panel_k][..., c],
                          kops.KERNELS[vec_k](mat, panel[..., c].contiguous())),
              f"{panel_k} column {c} != {vec_k} bit for bit at {where} {tuple(panel.shape)}")


def solve_times(ctx, h, b, panel, runs: int = 5) -> dict:
    """ms per ``ctx.solve`` (numpy in and out, so the device is synchronised
    at the end) for the three forms, ``runs`` runs each, sorted."""
    timing = {}
    for form, fn in (("forward", lambda: ctx.solve(h, b)),
                     ("transpose", lambda: ctx.solve(h, b, transpose=True)),
                     ("panel_r8", lambda: ctx.solve(h, panel))):
        reps = []
        for _ in range(runs):
            t0 = time.perf_counter()
            fn()
            reps.append(1e3 * (time.perf_counter() - t0))
        timing[form] = sorted(reps)
    return timing


def fused_inputs(torch, plan, b_pad):
    """The megakernel's operands for a one-device plan on the card: the
    reference's tables, the stores, ``b_pad`` and zero carries."""
    import numpy as np

    from repro_torch.core.solver import level_widths, step_offsets

    def dev(t):
        return torch.from_numpy(np.ascontiguousarray(t, dtype=np.int32)).cuda()

    tables = [dev(t) for t in ([0, plan.n_supersteps], plan.lvl_off, level_widths(plan),
                               plan.solve_rows[0], plan.upd_tiles[0], plan.tile_row[0],
                               plan.tile_col[0])]
    zeros = torch.zeros(b_pad.shape, device="cuda")
    stores = [torch.from_numpy(plan.diag).cuda(),
              torch.from_numpy(np.ascontiguousarray(plan.tiles[0])).cuda(),
              torch.from_numpy(np.ascontiguousarray(b_pad, dtype=np.float32)).cuda()]
    return tables, stores + [zeros, zeros], dev(step_offsets(plan))


def streamed_from(plan, tables, vecs):
    """The streamed megakernel's operands from :func:`fused_inputs`' output:
    ``[values, b_pad, acc, x]`` (the streamed store built from the
    uploaded stores) and the plan's layout on the card."""
    from repro_torch.core.solver import fused_layouts
    from repro_torch.kernels import superstep

    layout = fused_layouts(plan)[0].to("cuda")
    return [superstep.streamed_values(layout, vecs[0], vecs[1])] + vecs[2:], layout


def superstep_bound(plan, table, R: int) -> tuple[float, str]:
    """Least time (ms) of one megakernel solve with these inputs: each
    solved row's lower triangle, each pulled tile, b and the incoming acc
    read once, acc and x written once, the int32 tables it reads; float32
    operations B^2 per solved row and 2 B^2 per pulled tile, per column."""
    B = plan.bs.B
    rows = int((plan.solve_rows[0] >= 0).sum())
    tiles = int(table.pull_ptr[-1])  # pulled tiles (the device copy may hold a pad entry)
    index_ints = plan.solve_rows[0].size + table.n_solve_slots + 1 + 2 * tiles
    nbytes = 4 * (rows * B * (B + 1) // 2 + tiles * B * B + 4 * rows * B * R + index_ints)
    flops = R * (rows * B * B + tiles * 2 * B * B)
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_FP32_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


class PlainCalls:
    """Counts the calls of every plain version in ``ref`` (its ``*_ref``
    functions) while the block is open, through the module attributes the
    wrappers and ``ops`` call."""

    def __init__(self, ref):
        self.ref, self.calls, self.saved = ref, 0, {}

    def __enter__(self):
        def counted(fn):
            def wrapper(*args, **kwargs):
                self.calls += 1
                return fn(*args, **kwargs)
            return wrapper

        for name in dir(self.ref):
            if name.endswith("_ref") and callable(getattr(self.ref, name)):
                self.saved[name] = getattr(self.ref, name)
                setattr(self.ref, name, counted(self.saved[name]))
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.ref, name, fn)


def widths(plan, col: int):
    """Per-level bucket widths of schedule ``col`` (0 = solve rows, 1 =
    update tiles): the batch each level hands the kernels."""
    from repro_torch.core.solver import level_widths

    return level_widths(plan)[:, col]


def widest(plan, col: int) -> tuple[int, int]:
    """(offset, width) of the plan's widest level slice in schedule ``col``."""
    w = widths(plan, col)
    t = int(w.argmax())
    return int(plan.lvl_off[t, col]), int(w[t])


def phase_service(a, a_dy, x_int, plans: dict, rng) -> dict:
    """Phase 10 on the n = SIDE^2 factor ``a`` and its dyadic twin ``a_dy``
    (``x_int`` the integer solution of ``b = L x``): the verifier on
    ``plans`` and a dagpart plan, the plan store cold and warm, the solve
    service through ``launch/serve_solve.py``, and ``launch/solve.py`` at
    n ~ 1M. Returns the kernel launches of the served runs."""
    import io
    import threading

    import numpy as np
    import torch

    from repro_torch.api import PlanOptions, SpTRSVContext, pattern_key
    from repro_torch.core.solver import SolverConfig, build_plan, level_widths
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref
    from repro_torch.launch import serve_solve
    from repro_torch.launch import solve as solve_cli
    from repro_torch.obs import trace as otr
    from repro_torch.service import PlanStore, SolveEngine
    from repro_torch.sparse.matrix import to_scipy
    from repro_torch.verify import verify_plan

    sub_s = {}

    def span_s(records) -> str:
        """Seconds in the host spans of a served run, by name."""
        tot = {}
        for r in records:
            if r.get("type") == "span" and r["name"] in (
                    "service.batch", "sptrsv.analyse", "planstore.load", "sptrsv.verify",
                    "sptrsv.schedule", "sptrsv.solve"):
                tot[r["name"]] = tot.get(r["name"], 0.0) + r["dur_us"] / 1e6
        return ", ".join(f"{k}={v:.2f}" for k, v in sorted(tot.items()))

    # (a) strict verification of every plan the smoke built, and a dagpart plan
    t0 = time.perf_counter()
    plans = dict(plans)
    t1 = time.perf_counter()
    plans["dagpart forward"] = build_plan(a, 1, SolverConfig(sched="dagpart"))
    dag_build_s = time.perf_counter() - t1
    verify_s = {}
    for name, p in plans.items():
        t1 = time.perf_counter()
        report = verify_plan(p, level="strict")
        verify_s[name] = time.perf_counter() - t1
        check(report.passed, f"phase 10a: {name} plan fails strict verification: "
                              + "; ".join(str(f) for f in report.findings[:5]))
        check(len(report.rules_checked) >= 11, f"phase 10a: {name}: {report.summary()}")
    # one mutated copy: the solve slots of levels 1 and 2 swapped (the CPU
    # test's mutation), which must break happens-before with its rules
    p = plans["switch forward"]
    sr = p.solve_rows.copy()
    l1, l2 = int(p.lvl_off[1, 0]), int(p.lvl_off[2, 0])
    sr[:, [l1, l2]] = sr[:, [l2, l1]]
    bad = verify_plan(dataclasses.replace(p, solve_rows=sr), level="basic")
    ids = sorted({f.rule for f in bad.findings})
    check(not bad.passed and {"hb.upd.src-before", "hb.upd.dest-after"} <= set(ids)
          and all(r.startswith("hb.") for r in ids),
          f"phase 10a: the swapped-level copy gave {ids}")
    log("phase 10a strict verify, host s per plan (n = "
        f"{a.n}): " + ", ".join(f"{k}={v:.2f}" for k, v in verify_s.items())
        + f" (dagpart plan built in {dag_build_s:.2f} s); swapped levels 1, 2 -> {ids}")
    sub_s["a verify"] = time.perf_counter() - t0

    # (b) the plan store: cold analyse + save, then a fresh warm session
    t0 = time.perf_counter()
    L = to_scipy(a_dy)
    b_dy = (L @ x_int).astype(np.float32)
    bt_dy = (L.T @ x_int).astype(np.float32)
    X = rng.integers(-4, 5, (a.n, 8)).astype(np.float64)
    p_dy = (L @ X).astype(np.float32)
    for kernel in ("cuda", "fused"):
        with tempfile.TemporaryDirectory() as root:
            opts = PlanOptions(kernel=kernel)
            t1 = time.perf_counter()
            cold = SpTRSVContext(options=opts, plan_store=PlanStore(root))
            ch = cold.analyse(a_dy)
            cold.plan(ch), cold.plan(ch, transpose=True)
            cold_s = time.perf_counter() - t1
            xs = [cold.solve(ch, b_dy), cold.solve(ch, bt_dy, transpose=True),
                  cold.solve(ch, p_dy)]
            check(np.array_equal(xs[0], x_int) and np.array_equal(xs[1], x_int)
                  and np.array_equal(xs[2], X), f"phase 10b {kernel}: cold solves not exact")
            del cold, ch
            store = PlanStore(root)
            t1 = time.perf_counter()
            warm = SpTRSVContext(options=opts, plan_store=store)
            wh = warm.analyse(a_dy)
            warm_s = time.perf_counter() - t1
            s1 = dict(warm.stats())
            check(s1.get("analyses", 0) == 0 and s1.get("plan_store_hits") == 1
                  and store.stats.get("rejected", 0) == 0,
                  f"phase 10b {kernel}: warm session {s1}, store {store.stats}")
            t1 = time.perf_counter()
            warm.plan(wh, transpose=True)
            warm_t_s = time.perf_counter() - t1
            ws = [warm.solve(wh, b_dy), warm.solve(wh, bt_dy, transpose=True),
                  warm.solve(wh, p_dy)]
            check(all(np.array_equal(w, c) for w, c in zip(ws, xs)),
                  f"phase 10b {kernel}: warm solves differ from the cold session's bits")
            s2 = warm.stats()
            check(s2.get("analyses", 0) == 0 and s2.get("transpose_extensions", 0) == 0
                  and s2["plan_store_hits"] == 2 and store.stats.get("rejected", 0) == 0,
                  f"phase 10b {kernel}: after the transpose solve {s2}, store {store.stats}")
            log(f"phase 10b plan store ({kernel}): cold analyse+plan+save (forward and "
                f"transpose) {cold_s:.2f} s; warm load+refresh+strict verify {warm_s:.2f} s "
                f"forward, {warm_t_s:.2f} s transpose; 0 analyses, store {store.stats}; "
                f"forward, transpose and (n, 8) panel bit-equal to the cold session's")
            del warm, wh
    sub_s["b store"] = time.perf_counter() - t0

    # (c) the service: a hot/cold mix through launch/serve_solve.py
    t0 = time.perf_counter()
    served = dict.fromkeys(kops.KERNELS, 0)

    def add(counts):
        for k, v in counts.items():
            served[k] += v

    for kernel in ("cuda", "fused"):
        with tempfile.TemporaryDirectory() as root:
            argv = ["--hot-side", str(SERVICE_SIDE), "--requests", "48", "--tenants", "4",
                    "--max-batch", "8", "--kernel", kernel, "--plan-store", root,
                    "--tol", str(TOL_SOLVE)]
            kops.reset_launch_counts()
            with PlainCalls(ref) as plain, otr.trace_to() as tracer:
                run = serve_solve.serve(serve_solve.parse_args(argv + ["--dyadic"]))
                batches = [r["attrs"] for r in tracer.export()
                           if r.get("type") == "span" and r["name"] == "service.batch"]
            counts = kops.launch_counts()
            add(counts)
            check(run.exit_code == 0, f"phase 10c {kernel}: the dyadic mix failed "
                                      f"(exit {run.exit_code})")
            check(plain.calls == 0, f"phase 10c {kernel}: {plain.calls} plain-version calls")
            eng = run.engine
            st = eng.stats()
            check(st["requests"] == st["results"] == 48 and len(batches) == st["batches"],
                  f"phase 10c {kernel}: {st}")
            # launches: per batch, one TRSV/TRSM and one GEMV/GEMM a level with
            # work (cuda), or one megakernel launch (fused)
            plans_by = {pattern_key(m): eng.ctx.plan(eng.ctx.analyse(m)) for m in run.mats}
            want = dict.fromkeys(kops.KERNELS, 0)
            for bt in batches:
                if kernel == "cuda":
                    w = level_widths(plans_by[bt["pattern"]])
                    wide = bt["padded_width"] > 1
                    want["block_trsm" if wide else "block_trsv"] += int((w[:, 0] > 0).sum())
                    want["block_gemm" if wide else "block_gemv"] += int((w[:, 1] > 0).sum())
            if kernel == "fused":
                mega = counts["superstep"] + counts["superstep_streamed"]
                check(mega == len(batches) and sum(counts.values()) == mega,
                      f"phase 10c fused: launches {counts} for {len(batches)} batches")
            else:
                check(counts == want, f"phase 10c cuda: launches {counts}, not {want}")
            # every ticket bit-equal to a solo solve of its column
            t1 = time.perf_counter()
            with PlainCalls(ref) as plain:
                for t in run.tickets:
                    solo = eng.ctx.solve(eng.ctx.analyse(t.request.matrix), t.request.rhs)
                    check(np.array_equal(solo, t.result(0)),
                          f"phase 10c {kernel}: request {t.request.id} != its solo solve")
            check(plain.calls == 0, f"phase 10c {kernel}: plain versions in the solo solves")
            solo_s = time.perf_counter() - t1
            per_batch = {k: round(v / len(batches), 2) for k, v in counts.items() if v}
            width = st["coalesced_columns"] / st["batches"]
            log(f"phase 10c service ({kernel}, cold, dyadic) seconds in spans: "
                f"{span_s(tracer.export())}")
            log(f"phase 10c service ({kernel}, cold, dyadic): {st['batches']} batches, "
                f"{st['solves'] / run.wall_s:.2f} solves/s, {48 / run.wall_s:.2f} requests/s, "
                f"coalesce width {width:.2f}, store hit rate "
                f"{st['plan_store']['hit_rate']:.2f}; launches per batch {json.dumps(per_batch)}; "
                f"every ticket exact and bit-equal to its solo solve ({solo_s:.1f} s)")
            bits = {t.request.id: t.result(0) for t in run.tickets}
            reqs = [(t.request.matrix, t.request.rhs, t.request.id) for t in run.tickets]
            del run, eng, plans_by
            # warm, on real values: zero analyses, every solution within TOL_SOLVE
            kops.reset_launch_counts()
            out = io.StringIO()
            with PlainCalls(ref) as plain, contextlib.redirect_stdout(out), \
                    otr.trace_to() as tracer:
                code = serve_solve.main(argv + ["--assert-warm", "--assert-hit-rate", "1"])
            add(kops.launch_counts())
            for line in out.getvalue().splitlines():
                log(f"phase 10c service ({kernel}, warm, real values): {line}")
            log(f"phase 10c service ({kernel}, warm, real values) seconds in spans: "
                f"{span_s(tracer.export())}")
            check(code == 0 and plain.calls == 0,
                  f"phase 10c {kernel}: warm run exit {code}, {plain.calls} plain calls")
            # the background thread serving blocking tenants, on the engine's stream
            kops.reset_launch_counts()
            eng = SolveEngine(options=PlanOptions(kernel=kernel), plan_store=root,
                              max_batch=8, max_wait_s=0.005)
            got = {}

            def tenant(m, rhs, rid):
                got[rid] = eng.submit(f"tenant{rid % 4}", m, rhs).result(timeout=300)

            t1 = time.perf_counter()
            with eng:
                threads = [threading.Thread(target=tenant, args=r) for r in reqs[:16]]
                for th in threads:
                    th.start()
                for th in threads:
                    th.join()
            bg_s = time.perf_counter() - t1
            add(kops.launch_counts())
            check(len(got) == 16 and all(np.array_equal(got[r], bits[r]) for r in got),
                  f"phase 10c {kernel}: the background engine's bits differ")
            bst = eng.stats()
            check(bst["session"].get("analyses", 0) == 0,
                  f"phase 10c {kernel}: the background engine analysed {bst['session']}")
            log(f"phase 10c service ({kernel}, background thread, 16 blocking tenants): "
                f"{bst['batches']} batches in {bg_s:.2f} s on stream {eng.stream}, bit-equal "
                "to the cold run; 0 analyses")
            del eng
    torch.cuda.synchronize()
    sub_s["c service"] = time.perf_counter() - t0

    # (d) launch/solve.py at n ~ 1M, verified
    t0 = time.perf_counter()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = solve_cli.main(["--matrix", "webbase-1M", "--scale", str(CLI_SCALE), "--verify",
                               "--repeats", "3", "--tol", str(TOL_SOLVE)])
    for line in out.getvalue().splitlines():
        log(f"phase 10d {line}")
    check(code == 0, f"phase 10d: launch/solve.py exited {code}")
    sub_s["d solve cli"] = time.perf_counter() - t0
    log("phase 10 seconds per sub-step: " + ", ".join(f"{k}={v:.1f}" for k, v in sub_s.items()))
    return served


# ---------------------------------------------------------------------------
# phase 11: multi-device comm="unified", UNIFIED_RANKS gloo ranks on one card
# ---------------------------------------------------------------------------


def rank_launches(plan, rank: int, kernel: str, wide: bool) -> dict:
    """The block-kernel launches one solve of ``plan`` makes on device
    ``rank``: the switch executor one TRSV (TRSM) per level with solve rows
    and one GEMV (GEMM) per level with update tiles on any device (the
    widths are the busiest device's); syncfree one of each per sweep (dense
    scan, ``cuda``) or per sweep where this rank has rows to solve or tiles
    to apply (frontier form, ``fused``)."""
    import numpy as np

    from repro_torch.core.solver import level_widths

    w = level_widths(plan)
    if plan.config.sched != "syncfree":
        n_solve, n_upd = int((w[:, 0] > 0).sum()), int((w[:, 1] > 0).sum())
    elif kernel == "cuda":
        n_solve = n_upd = plan.n_levels
    else:
        pad = plan.tiles.shape[1] - 1
        sr, ut = plan.solve_rows[rank], plan.upd_tiles[rank]
        spans = list(zip(plan.lvl_off[:, 0], w[:, 0], plan.lvl_off[:, 1], w[:, 1]))
        n_solve = sum(bool((sr[s0:s0 + ws] >= 0).any()) for s0, ws, _, _ in spans)
        n_upd = sum(bool((ut[u0:u0 + wu] != pad).any()) for _, _, u0, wu in spans)
    return {"block_trsm" if wide else "block_trsv": n_solve,
            "block_gemm" if wide else "block_gemv": n_upd}


def unified_rank(rank: int, inputs: str, rdv: str, out) -> None:
    """One rank of phases 11 and 12 (a process of its own, started by
    ``spawn``): joins the gloo group, solves the n = SIDE^2 factor on
    ``cuda:0`` through ``SpTRSVContext(group=...)`` in each form, with
    ``comm="unified"`` (phase 11), then ``comm="zerocopy"`` and syncfree
    under both comm modes (phase 12), checks each solve, and puts its
    results on ``out``. A failed check exits non-zero, which fails the
    phase."""
    import datetime
    import os

    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.api import PlanOptions, SpTRSVContext
    from repro_torch.core import comm
    from repro_torch.core.solver import dispatch_stats
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref
    from repro_torch.launch.serve_solve import dyadic
    from repro_torch.sparse import suite
    from repro_torch.verify import verify_plan

    sys.path.insert(0, str(ROOT / "perf"))
    import stream_crossover

    dist.init_process_group("gloo", init_method=f"file://{rdv}", rank=rank,
                            world_size=UNIFIED_RANKS, timeout=datetime.timedelta(seconds=300))
    group = dist.group.WORLD
    data = np.load(inputs)
    a = suite.grid2d_factor(int(data["side"]), seed=6)
    a_dy = dyadic(a, seed=SEED)
    ctx = SpTRSVContext(device=str(data["device"]), group=group)
    res = {"rank": rank, "forms": {}, "zc": {}, "wide": {}, "seconds": {}}
    sent = []  # bytes of each all_reduce of the solve being counted
    all_reduce = comm.all_reduce_sum_

    def counted_all_reduce(t, g):
        sent.append(t.numel() * t.element_size())
        return all_reduce(t, g)

    counted_all_reduce.calls = all_reduce.calls  # all_reduce_sum_ counts by its module name
    comm.all_reduce_sum_ = counted_all_reduce

    def one_solve(name, h, rhs, want=None, transpose=False, phase=11):
        """A solve after a barrier, its host-clock ms, launches, exchanges,
        bytes all-reduced and plain-version calls, checked against
        ``dispatch_stats`` (syncfree: ``n_levels`` sweeps, one exchange
        each)."""
        solver = ctx.executor(h, transpose=transpose)
        plan = solver.plan
        cfg = plan.config
        tag = f"phase {phase} {name}"
        torch.cuda.synchronize()
        dist.barrier()
        kops.reset_launch_counts()
        sent.clear()
        with PlainCalls(ref) as plain:
            t0 = time.perf_counter()
            x = ctx.solve(h, rhs, transpose=transpose)
            ms = 1e3 * (time.perf_counter() - t0)
        counts = kops.launch_counts()
        stats = dispatch_stats(plan)
        n_steps = plan.n_supersteps
        check(plan.n_boundary_rows > 0, f"{tag}: the cut is empty")
        check(plain.calls == 0, f"{tag}: {plain.calls} plain-version calls")
        if cfg.sched == "syncfree":
            check(solver._syncfree.sweeps == solver.exchanges == plan.n_levels,
                  f"{tag}: {solver._syncfree.sweeps} sweeps, {solver.exchanges} exchanges, "
                  f"{plan.n_levels} levels")
        else:
            want_ex = n_steps if cfg.comm == "unified" else stats["exchanges"]
            check(solver.exchanges == stats["exchanges"] == want_ex > 0,
                  f"{tag}: {solver.exchanges} exchanges, dispatch_stats "
                  f"{stats['exchanges']}, want {want_ex}")
        if cfg.kernel_backend == "cuda" or cfg.sched == "syncfree":
            want_counts = {**dict.fromkeys(counts, 0),
                           **rank_launches(plan, rank, cfg.kernel_backend, np.ndim(rhs) == 2)}
        else:
            split = "superstep_streamed_split" if stats["streamed"] else "superstep_split"
            want_counts = {**dict.fromkeys(counts, 0), split: stats["fused_launches"]}
            want_l = n_steps if cfg.comm == "unified" else stats["exchanges"] + 1
            check(stats["fused_launches"] == want_l,
                  f"{tag}: dispatch_stats fused_launches {stats['fused_launches']}, "
                  f"want {want_l}")
        check(counts == want_counts, f"{tag}: launches {counts}, not {want_counts}")
        row = {"ms": ms, "launches": counts, "exchanges": solver.exchanges,
               "supersteps": n_steps, "levels": plan.n_levels, "streamed": stats["streamed"],
               "boundary_rows": plan.n_boundary_rows, "all_reduces": len(sent),
               "exchange_bytes": sum(sent[:-1])}  # the last all_reduce is the gather
        if want is not None:
            e = rel_err(x, want)
            check(np.isfinite(e) and e <= TOL_SOLVE, f"{tag}: rel err {e:.3e}")
            row["rel_err"] = e
        res[{11: "forms", 14: "wide"}.get(phase, "zc")][name] = row
        return x

    def verified(h, transpose=False):
        report = verify_plan(ctx.plan(h, transpose=transpose), level="strict")
        check(report.passed, f"phase 11/12: rank {rank} plan fails strict verify: "
                             f"{report.summary()}")

    b, b_dy, x_int = data["b"], data["b_dy"], data["x_int"]
    store = 2 * int(data["store_bytes"])
    a_p = suite.grid2d_factor(int(data["panel_side"]), seed=6)

    def run_forms(comm_mode: str, phase: int) -> None:
        """The levelset/dagpart forms under ``comm_mode``: plain ``fused``
        (the streamed split form) forward and transpose, dagpart, the
        resident split form, ``cuda``; the dyadic twin under three of them,
        ``x_int`` exactly; an (n, 8) panel of ``a_p``."""
        t0 = time.perf_counter()
        forms = {"fused": (PlanOptions(comm=comm_mode, kernel="fused"), False),
                 "fused_dagpart": (PlanOptions(comm=comm_mode, sched="dagpart",
                                               kernel="fused"), False),
                 "resident": (PlanOptions(comm=comm_mode, kernel="fused"), True),
                 "cuda": (PlanOptions(comm=comm_mode, kernel="cuda"), False)}
        handles = {}
        for name, (opts, resident) in forms.items():
            with (stream_crossover.stream_limit_env(store) if resident
                  else contextlib.nullcontext()):
                h = handles[name] = ctx.analyse(a, opts, tag=f"{comm_mode}/{name}")
                verified(h)
                ctx.executor(h)  # tables, layouts, stores, upload
                check(ctx.dispatch_stats(h)["streamed"] == (name in ("fused", "fused_dagpart")),
                      f"phase {phase} {name}: streamed={ctx.dispatch_stats(h)['streamed']}")
                one_solve(name, h, b, data["want_forward"], phase=phase)
                if name == "fused":
                    verified(h, transpose=True)
                    one_solve("fused_transpose", h, b, data["want_transpose"], transpose=True,
                              phase=phase)
        res["seconds"][f"{phase} real"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        # the dyadic twin: every rank's x is x_int bit for bit under each form
        for name in ("fused", "resident", "cuda"):
            with (stream_crossover.stream_limit_env(store) if name == "resident"
                  else contextlib.nullcontext()):
                ctx.factorize(a_dy, handles[name])
                x = one_solve(f"{name}_dyadic", handles[name], b_dy, phase=phase)
            check(np.array_equal(x, x_int), f"phase {phase} {name}: the dyadic twin's x != "
                                            f"x_int on rank {rank}")
        res["seconds"][f"{phase} dyadic"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        # an (n, 8) panel on the n = PCG_SIDE^2 factor under plain fused
        hp = ctx.analyse(a_p, PlanOptions(comm=comm_mode, kernel="fused"))
        verified(hp)
        ctx.executor(hp)
        one_solve("fused_panel_r8", hp, data["panel_p"], data["want_panel_p"], phase=phase)
        res["seconds"][f"{phase} panel"] = time.perf_counter() - t0
        if phase == 11:
            res["n_boundary_rows"] = ctx.plan(handles["fused"]).n_boundary_rows
            res["n_tiles_here"] = int(ctx.executor(handles["cuda"])._tiles.shape[0])

    run_forms("unified", 11)
    # a fresh session for phase 12: phase 11's plans and executors go
    ctx = SpTRSVContext(device=str(data["device"]), group=group)
    gc.collect()
    torch.cuda.empty_cache()
    # phase 12: zerocopy, then syncfree under both comm modes
    run_forms("zerocopy", 12)
    t0 = time.perf_counter()
    for comm_mode, kernel, name in (("zerocopy", "cuda", "syncfree_dense"),
                                    ("zerocopy", "fused", "syncfree_frontier"),
                                    ("unified", "cuda", "syncfree_unified_dense"),
                                    ("unified", "fused", "syncfree_unified_frontier")):
        h = ctx.analyse(a, PlanOptions(comm=comm_mode, sched="syncfree", kernel=kernel),
                        tag=name)
        verified(h)
        ctx.executor(h)
        one_solve(name, h, b, data["want_forward"], phase=12)
        if comm_mode == "zerocopy":  # the dyadic twin, exactly
            ctx.factorize(a_dy, h)
            x = one_solve(f"{name}_dyadic", h, b_dy, phase=12)
            check(np.array_equal(x, x_int), f"phase 12 {name}: the dyadic twin's x != x_int "
                                            f"on rank {rank}")
        res["seconds"][f"12 {name}"] = time.perf_counter() - t0
        t0 = time.perf_counter()
    # phase 14's two-rank path: zerocopy fused_streamed at WIDE_BLOCKS[0], the
    # streamed split form in row chunks, on the dyadic twin of a_p, x exactly
    hw = ctx.analyse(dyadic(a_p, seed=SEED), PlanOptions(
        block_size=WIDE_BLOCKS[0], comm="zerocopy", kernel="fused_streamed"), tag="wide")
    verified(hw)
    ctx.executor(hw)
    x = one_solve("wide_dyadic", hw, data["b_wide"], phase=14)
    check(np.array_equal(x, data["x_wide"]), f"phase 14 zerocopy B={WIDE_BLOCKS[0]}: x != "
                                            f"x_int on rank {rank}")
    res["seconds"]["14 wide"] = time.perf_counter() - t0
    # phase 13: fresh sessions; phase 12's plans and executors go
    ctx = None
    gc.collect()
    torch.cuda.empty_cache()
    res["tail"] = tail_rank(rank, group, data, a_dy, sent)
    comm.all_reduce_sum_ = all_reduce
    out.put(res)
    dist.barrier()
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# phase 13: the multi-device tail (SpMV, Krylov, "auto", plan store, service)
# ---------------------------------------------------------------------------


def digest(x) -> str:
    """The bits of an array, for comparing ranks' results through a queue."""
    import hashlib

    import numpy as np

    return hashlib.sha1(np.ascontiguousarray(x).tobytes()).hexdigest()


def tail_rank(rank: int, group, data, a_dy, sent: list) -> dict:
    """Phase 13 (a)-(d) on one rank of phase 11's group, with fresh
    sessions: the SpMV, IC(0)-PCG and ILU(0)-BiCGStab on the n =
    PCG_SIDE^2 system, ``"auto"`` on ``grid2d_factor(AUTO_SIDE)`` and the
    plan store on phase 3's dyadic twin ``a_dy``. Checks what one rank can
    see; returns the digests, counts and times the parent compares across
    ranks. ``sent`` collects the bytes of each ``all_reduce_sum_``."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.api import PlanOptions, SpTRSVContext
    from repro_torch.core.solver import SolverConfig, build_plan, dispatch_stats
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref
    from repro_torch.krylov import (
        SpMV, matvec_lower, solve_ic0_pcg, solve_ilu0_bicgstab, spd_lower_from_triangular,
    )
    from repro_torch.launch.serve_solve import dyadic
    from repro_torch.obs import calibration as ocal
    from repro_torch.service import PlanStore
    from repro_torch.sparse import suite

    dev = str(data["device"])
    tol = float(data["tol"])
    zeros = dict.fromkeys(kops.KERNELS, 0)
    out = {"seconds": {}, "paths": {}, "digests": {}, "ms": {}}

    def together():
        torch.cuda.synchronize()
        dist.barrier()

    # (a) the SpMV on the n = PCG_SIDE^2 system: dyadic values exact, one
    # all_reduce of nb * B floats a matvec, three GEMV (GEMM) launches
    t0 = time.perf_counter()
    a_spd = spd_lower_from_triangular(suite.grid2d_factor(int(data["panel_side"]), seed=6))
    b_spd = data["b_spd"]
    for values, mat in (("dyadic", dyadic(a_spd, seed=SEED)), ("real", a_spd)):
        p2, p1 = (build_plan(mat, D, SolverConfig()) for D in (UNIFIED_RANKS, 1))
        spmv2, spmv1 = SpMV(p2, dev, group), SpMV(p1, dev)
        for form, v in (("vector", data[f"v_{values}"]), ("panel", data[f"v8_{values}"])):
            want = spmv1.matvec(v)
            tag = f"phase 13a SpMV {values} {form}"
            together()
            kops.reset_launch_counts()
            sent.clear()
            with PlainCalls(ref) as plain:
                y = spmv2.matvec(v)
            counts = kops.launch_counts()
            gemv = "block_gemv" if form == "vector" else "block_gemm"
            check(counts == {**zeros, gemv: 3}, f"{tag}: launches {counts}")
            check(plain.calls == 0, f"{tag}: {plain.calls} plain-version calls")
            R = 1 if form == "vector" else v.shape[1]
            check(sent == [p2.bs.nb * p2.bs.B * R * 4],
                  f"{tag}: all_reduce bytes {sent}, want one of {p2.bs.nb * p2.bs.B * R * 4}")
            if values == "dyadic":
                check(np.array_equal(y, want), f"{tag}: rank {rank} != the one-device SpMV")
            else:
                e = float(np.abs(y - want).max() / np.abs(want).max())
                check(e <= TOL_KERNEL, f"{tag}: rel err {e:.3e} against the one-device SpMV")
                out[f"spmv_{form}_rel_err"] = e
            out["digests"][f"spmv {values} {form}"] = digest(y)
            out["paths"][f"spmv_{values}_{form}"] = counts
        if values == "real":  # ms a matvec: the group's, then one device alone on rank 0
            v = data["v_real"]
            together()
            t = time.perf_counter()
            for _ in range(10):
                spmv2.matvec(v)
            out["ms"]["spmv D=2"] = (time.perf_counter() - t) * 100
            together()
            if rank == 0:
                t = time.perf_counter()
                for _ in range(10):
                    spmv1.matvec(v)
                out["ms"]["spmv one device"] = (time.perf_counter() - t) * 100
            together()
    out["seconds"]["13a spmv"] = time.perf_counter() - t0

    # (b) IC(0)-PCG and ILU(0)-BiCGStab, zerocopy, plain "fused" (the split
    # megakernel, streamed by the card's rule): launches as dispatch_stats
    # says, no plain version, the one-device runs' iterations
    opts = PlanOptions(comm="zerocopy", kernel="fused")
    for method, solve in (("pcg", solve_ic0_pcg), ("bicgstab", solve_ilu0_bicgstab)):
        tag = f"phase 13b {method}"
        together()
        kops.reset_launch_counts()
        t0 = time.perf_counter()
        with PlainCalls(ref) as plain:
            r = solve(a_spd, b_spd, tol=tol, maxiter=400, config=opts, device=dev, group=group)
        secs = time.perf_counter() - t0
        counts = kops.launch_counts()
        want = {**zeros, "block_gemv": 3 * r.info["spmv"].n_matvecs}
        split = {}
        for side in ("forward", "backward"):
            solver = r.info[side]
            st = dispatch_stats(solver.plan)
            key = "superstep_streamed_split" if st["streamed"] else "superstep_split"
            want[key] += solver.n_solves * st["fused_launches"]
            split[side] = {"fused_launches": st["fused_launches"], "exchanges": st["exchanges"],
                           "solves": solver.n_solves, "streamed": st["streamed"]}
        check(counts == want, f"{tag}: launches {counts}, not {want}")
        check(plain.calls == 0, f"{tag}: {plain.calls} plain-version calls")
        true_res = float(np.linalg.norm(b_spd - matvec_lower(a_spd, r.x))
                         / np.linalg.norm(b_spd))
        check(r.converged and true_res <= 10 * tol,
              f"{tag}: converged={r.converged} in {r.n_iters} iterations, true residual "
              f"{true_res:.3e}")
        per_iter = 1 if method == "pcg" else 2
        check(r.info["forward"].n_solves == r.info["backward"].n_solves
              == per_iter * r.n_iters,
              f"{tag}: {r.info['forward'].n_solves}/{r.info['backward'].n_solves} sweeps for "
              f"{r.n_iters} iterations")
        if method == "pcg":
            check(abs(r.n_iters - int(data["pcg_iters"])) <= 1,
                  f"{tag}: {r.n_iters} iterations, phase 5 took {int(data['pcg_iters'])}")
        else:
            check(r.n_iters == int(data["bicgstab_iters"]),
                  f"{tag}: {r.n_iters} iterations, phase 8's fused run took "
                  f"{int(data['bicgstab_iters'])}")
            e = rel_err(r.x, data["x_spd"])
            check(e <= TOL_SOLVE, f"{tag}: rel err {e:.3e} against scipy")
            out["bicgstab_rel_err"] = e
        matvecs = r.info["spmv"].n_matvecs
        # where an iteration's time goes: each of its steps once more on the
        # group, after a barrier (median of 3, host clock, numpy out)
        b32 = np.asarray(b_spd, np.float32)
        steps = {}
        for step, run in (("forward", lambda: r.info["forward"].solve(b32)),
                          ("backward", lambda: r.info["backward"].solve(b32)),
                          ("matvec", lambda: r.info["spmv"].matvec(b32))):
            times = []
            for _ in range(3):
                together()
                t = time.perf_counter()
                run()
                times.append(time.perf_counter() - t)
            steps[step] = sorted(times)[1] * 1e3
        out[method] = {"n_iters": r.n_iters, "seconds": secs, "true_res": true_res,
                       "matvecs": matvecs, "split": split,
                       "history": r.history, "step_ms": steps}
        out["digests"][method] = digest(r.x)
        out["paths"][f"{method}_zerocopy_fused"] = counts
        out["seconds"][f"13b {method}"] = secs

    # (c) "auto" at D = 2: probed (the calibration file rank 0's alone), then
    # modelled; the parent compares the ranks' decisions
    t0 = time.perf_counter()
    a_auto = suite.grid2d_factor(AUTO_SIDE, seed=6)
    store = ocal.CalibrationStore(path=str(data["calibration"]))
    saves = []
    real_save = store.save
    store.save = lambda path: (saves.append(path), real_save(path))
    ocal.set_store(store)
    auto = dict(sched="auto", comm="auto", kernel="auto")
    b_auto = data["b_auto"]
    try:
        decisions = {}
        for probes in (1, 0):
            ctx = SpTRSVContext(device=dev, group=group)
            together()
            kops.reset_launch_counts()
            h = ctx.analyse(a_auto, PlanOptions(**auto, probe_solves=probes))
            x = ctx.solve(h, b_auto)
            d = h.auto
            e = rel_err(x, data["want_auto"])
            check(e <= TOL_SOLVE, f"phase 13c auto (probes {probes}): rel err {e:.3e}")
            check({c[1] for c in d.scores} == {"zerocopy", "unified"},
                  f"phase 13c: the candidate grid's comm modes {sorted(d.scores)}")
            check(d.mode == ("probed" if probes else "modelled"), f"phase 13c: mode {d.mode}")
            decisions[probes] = {"chosen": list(d.chosen), "mode": d.mode,
                                 "probe_us": {"/".join(c): v for c, v in d.probe_us.items()},
                                 "scores": {"/".join(c): v for c, v in d.scores.items()},
                                 "candidates": len(d.scores),
                                 "overhead_s": d.probe_overhead_us / 1e6}
            out["paths"][f"auto_{'probed' if probes else 'modelled'}"] = kops.launch_counts()
        out["auto"] = decisions
        out["calibration_saves"] = len(saves)
        out["calibration_samples"] = store.n_samples()
    finally:
        ocal.set_store(None)
    out["seconds"]["13c auto"] = time.perf_counter() - t0

    # (d) the plan store on phase 3's dyadic twin (n = SIDE^2): the cold
    # sessions analyse and rank 0 saves; warm sessions hit on every rank
    t0 = time.perf_counter()
    opts = PlanOptions(comm="zerocopy", kernel="fused")
    xs = {}
    for phase in ("cold", "warm"):
        store = PlanStore(str(data["plan_store"]))
        ctx = SpTRSVContext(device=dev, group=group, plan_store=store, options=opts)
        together()
        kops.reset_launch_counts()
        t = time.perf_counter()
        h = ctx.analyse(a_dy)
        ctx.executor(h)
        out["seconds"][f"13d {phase} analyse+plan"] = time.perf_counter() - t
        with PlainCalls(ref) as plain:
            xs[phase] = ctx.solve(h, data["b_dy"])
        check(plain.calls == 0, f"phase 13d {phase}: {plain.calls} plain-version calls")
        st, ps = ctx.stats(), store.stats
        if phase == "cold":
            check(st.get("analyses") == 1 and ps.get("saves", 0) == (1 if rank == 0 else 0),
                  f"phase 13d cold on rank {rank}: session {st}, store {ps}")
        else:
            check(st.get("plan_store_hits") == 1 and not st.get("analyses")
                  and not ps.get("rejected"),
                  f"phase 13d warm on rank {rank}: session {st}, store {ps}")
        out[f"store_{phase}"] = {"session": {k: v for k, v in st.items() if k != "cache_hit_rate"},
                                 "store": ps}
        out["paths"][f"store_{phase}"] = kops.launch_counts()
    check(np.array_equal(xs["warm"], xs["cold"]) and np.array_equal(xs["cold"], data["x_int"]),
          f"phase 13d: warm solve != cold solve or != x_int on rank {rank}")
    out["digests"]["store"] = digest(xs["warm"])
    out["seconds"]["13d store"] = time.perf_counter() - t0
    return out


def split_bound(plan, d: int, table, R: int) -> tuple[float, str]:
    """Least time (ms) of one split launch of device ``d``'s ``table``
    with these inputs: each solved
    row's lower triangle and each pulled tile read once; per solved row b,
    acc and delta read, delta and x written, per orphan its delta read and
    written; the int32 tables it reads; float32 operations B^2 per solved
    row and 2 B^2 per pulled tile, per column."""
    import numpy as np

    B = plan.bs.B
    t_lo, t_hi = table.levels
    off = plan.lvl_off.astype(np.int64)
    slots = np.arange(off[t_lo, 0], table.n_solve_slots)
    rows = int((plan.solve_rows[d][slots] >= 0).sum())
    ptr = table.pull_ptr[table.ptr_at:]
    tiles = int(ptr[table.n_solve_slots + table.n_orphans] - ptr[off[t_lo, 0]])
    ints = slots.size + table.n_orphans + 1 + 2 * tiles
    nbytes = 4 * (rows * B * (B + 1) // 2 + tiles * B * B
                  + (5 * rows + 2 * table.n_orphans) * B * R + ints)
    flops = R * (rows * B * B + tiles * 2 * B * B)
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_FP32_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def split_kernel_rows(a, r0: dict, rng, device: str = "cuda:0") -> list:
    """The split kernel, resident and streamed, against its plain version on
    one launch of a dagpart merged step with non-zero carries: bit-equal on a
    dyadic problem (the card tests' merged step), within TOL_SOLVE on ``a``'s
    widest merged step (device 0 of UNIFIED_RANKS); there, its ms per launch
    beside its bound and its plain version's. ``r0`` is rank 0's results
    (launches per solve). Returns the two kernel rows."""
    import numpy as np
    import torch

    from repro_torch.core.solver import SolverConfig, build_plan, level_widths, step_offsets
    from repro_torch.kernels import ref, superstep
    from repro_torch.launch.serve_solve import dyadic
    from repro_torch.sparse import suite

    rows_out, err = [], {}
    for values in ("dyadic", "real"):
        # dyadic: the card tests' merged step (tests/test_torch_cuda.py, B = 16):
        # device 1 of four, small-integer carries; real: the factor, device 0 of two
        if values == "dyadic":
            src, D, B, d, vrng = (dyadic(suite.random_levelled(1600, 12, 4.0, seed=6)), 4, 16,
                                  1, np.random.default_rng(16))
        else:
            src, D, B, d, vrng = a, UNIFIED_RANKS, 32, 0, rng
        plan = build_plan(src, D, SolverConfig(block_size=B, comm="unified", sched="dagpart"))
        so = step_offsets(plan)
        sw = level_widths(plan)[:, 0]
        merged = np.nonzero(np.diff(so) > 1)[0]
        steps = merged if merged.size else np.arange(plan.n_supersteps)
        width = np.array([sw[so[s]:so[s + 1]].sum() for s in steps])
        s = int(steps[np.argmax(width)]) if values == "real" else int(np.argmax(np.diff(so)))
        host = [np.array([s, 1])] + [plan.lvl_off, level_widths(plan), plan.solve_rows[d],
                                     plan.upd_tiles[d], plan.tile_row[d], plan.tile_col[d]]
        tables = [torch.from_numpy(np.ascontiguousarray(t, dtype=np.int32)).to(device)
                  for t in host]
        stp = torch.from_numpy(np.ascontiguousarray(so, dtype=np.int32)).to(device)
        host_layout = superstep.segmented_layout(*host[1:], n_rows=plan.bs.nb + 1, stp=so,
                                                 bounds=np.arange(len(so)))
        layout = host_layout.to(device)
        table = layout.segments[s]
        shape = (plan.bs.nb + 1, plan.bs.B)
        vecs = [(vrng.uniform(-1, 1, shape) if values == "real"
                 else vrng.integers(-3, 4, shape)).astype(np.float32) for _ in range(4)]
        for v in vecs:
            v[-1] = 0
        b_pad, acc, delta, x = (torch.from_numpy(v).to(device) for v in vecs)
        diag = torch.from_numpy(plan.diag).to(device)
        tiles = torch.from_numpy(np.ascontiguousarray(plan.tiles[d])).to(device)
        values_ = superstep.streamed_values(layout, diag, tiles)
        flags = superstep.ReadyFlags(shape[0], device)
        plain = ref.superstep_ref(*tables, diag, tiles, b_pad, acc, x, stp, delta=delta)
        if values == "dyadic":  # nothing rounds: float32 gives the float64 result
            exact = ref.superstep_ref(*tables, diag.double(), tiles.double(), b_pad.double(),
                                      acc.double(), x.double(), stp, delta=delta.double())
            check(all(torch.equal(p_, e_.float()) for p_, e_ in zip(plain, exact)),
                  "phase 11: the dyadic merged step rounds: no bit check possible")
        for form in ("superstep_split", "superstep_streamed_split"):
            d_, x_ = delta.clone(), x.clone()
            if form == "superstep_split":
                superstep.superstep_split_(*tables, diag, tiles, b_pad, acc, d_, x_, stp,
                                           table=table, flags=flags)
            else:
                superstep.superstep_streamed_split_(*tables, values_, b_pad, acc, d_, x_, stp,
                                                    layout=layout, table=table, flags=flags)
            torch.cuda.synchronize()
            got = (acc, d_, x_)
            if values == "dyadic":
                check(all(torch.equal(g, w) for g, w in zip(got, plain)),
                      f"{form} != its plain version on the dyadic merged step")
                continue
            e = max(float((g - w).abs().max()) for g, w in zip(got, plain))
            scale = max(float(w.abs().max()) for w in plain)
            check(e <= TOL_SOLVE * scale, f"{form} vs plain: max abs err {e:.3e}")
            err[form] = e

            def launch(form=form, d_=d_, x_=x_):
                if form == "superstep_split":
                    superstep.superstep_split_(*tables, diag, tiles, b_pad, acc, d_, x_, stp,
                                               table=table, flags=flags)
                else:
                    superstep.superstep_streamed_split_(*tables, values_, b_pad, acc, d_, x_,
                                                        stp, layout=layout, table=table,
                                                        flags=flags)

            bound_ms, bound_by = split_bound(plan, d, host_layout.segments[s], 1)
            path = "fused" if form == "superstep_streamed_split" else "resident"
            rows_out.append({
                "name": form, "route": "cuda",
                "source": f"src/repro_torch/kernels/csrc/{KERNELS[form][1]}",
                "replaces": KERNELS[form][0],
                "launches": r0["forms"][path]["launches"][form], "max_abs_err": e,
                "ms": time_ms(launch, 50),
                "plain_ms": time_ms(lambda: ref.superstep_ref(
                    *tables, diag, tiles, b_pad, acc, x, stp, delta=delta), 3, warmup=1),
                "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
                "device_ms": device_ms(launch, MEGAKERNEL_SYMBOL[
                    form == "superstep_streamed_split", True], 50),
                "shape": [a.n, plan.bs.B, 1], "superstep": s,
                "levels": [int(so[s]), int(so[s + 1])],
                "launches_per_solve": r0["forms"][path]["supersteps"]})
        log(f"phase 11 split kernels vs plain ({values}, {D} devices, B={B}, device {d}, "
            f"superstep {s}: levels {int(so[s])}..{int(so[s + 1]) - 1}, "
            f"{int(sw[so[s]:so[s + 1]].sum())} solve slots, "
            f"{table.n_orphans} orphans): "
            + ("bit-identical, resident and streamed" if values == "dyadic" else
               ", ".join(f"{k} max abs {v:.2e}" for k, v in err.items())))
    for row in rows_out:
        log(f"phase 11 {row['name']}: {row['ms']:.4f} ms per launch (CUDA events, 50 "
            f"launches) at superstep {row['superstep']}, bound {row['bound_ms']:.5f} ms "
            f"({row['bound_by']}), plain {row['plain_ms']:.2f} ms; "
            f"{row['launches_per_solve']} launches per solve")
    return rows_out


def zerocopy_segment_times(a, rows_out: list, rng, device: str = "cuda:0") -> str:
    """Phase 12b: the split kernel, resident and streamed, as the zerocopy
    fused executor launches it (``acc`` zero, the accumulator in ``delta``)
    over the widest exchange segment (most solve slots) of device 0 of
    ``a``'s UNIFIED_RANKS-device zerocopy plan, on real values: within
    TOL_SOLVE of its plain version, ``acc`` still zero, its ms per launch
    beside its bound and its plain version's, added to the split rows of
    ``rows_out`` as ``at_zerocopy_segment``. Returns the log line."""
    import numpy as np
    import torch

    from repro_torch.core.solver import (
        SolverConfig, build_plan, fused_segments, level_widths,
    )
    from repro_torch.kernels import ref, superstep

    plan = build_plan(a, UNIFIED_RANKS, SolverConfig(block_size=32, comm="zerocopy"))
    segs = fused_segments(plan)
    sw = level_widths(plan)[:, 0]
    slots = np.array([sw[lo:hi].sum() for lo, hi in segs])
    s = int(np.argmax(slots))
    d = 0
    host = [np.array([segs[s, 0], segs[s, 1] - segs[s, 0]])] + [
        plan.lvl_off, level_widths(plan), plan.solve_rows[d], plan.upd_tiles[d],
        plan.tile_row[d], plan.tile_col[d]]
    tables = [torch.from_numpy(np.ascontiguousarray(t, dtype=np.int32)).to(device)
              for t in host]
    host_layout = superstep.segmented_layout(*host[1:], n_rows=plan.bs.nb + 1,
                                             bounds=np.concatenate([segs[:, 0],
                                                                    [plan.n_levels]]))
    layout = host_layout.to(device)
    table = layout.segments[s]
    shape = (plan.bs.nb + 1, plan.bs.B)
    b_pad, delta, x = (torch.from_numpy(rng.uniform(-1, 1, shape).astype(np.float32)).to(device)
                       for _ in range(3))
    for v in (b_pad, delta, x):
        v[-1] = 0
    acc = torch.zeros_like(b_pad)
    diag = torch.from_numpy(plan.diag).to(device)
    tiles = torch.from_numpy(np.ascontiguousarray(plan.tiles[d])).to(device)
    values_ = superstep.streamed_values(layout, diag, tiles)
    flags = superstep.ReadyFlags(shape[0], device)
    plain = ref.superstep_ref(*tables, diag, tiles, b_pad, acc, x, delta=delta)
    scale = max(float(w.abs().max()) for w in plain)
    bound_ms, bound_by = split_bound(plan, d, host_layout.segments[s], 1)
    parts = []
    for form in ("superstep_split", "superstep_streamed_split"):
        def launch(form=form, d_=delta.clone(), x_=x.clone()):
            if form == "superstep_split":
                superstep.superstep_split_(*tables, diag, tiles, b_pad, acc, d_, x_,
                                           table=table, flags=flags)
            else:
                superstep.superstep_streamed_split_(*tables, values_, b_pad, acc, d_, x_,
                                                    layout=layout, table=table, flags=flags)
            return acc, d_, x_

        got = launch()  # fresh copies of the carries: one launch from the inputs
        torch.cuda.synchronize()
        check(not bool(acc.any()), f"phase 12 {form}: acc written")
        e = max(float((g - w).abs().max()) for g, w in zip(got, plain))
        check(e <= TOL_SOLVE * scale, f"phase 12 {form} at the zerocopy segment vs plain: "
                                      f"max abs err {e:.3e}")
        at = {"segment": s, "levels": [int(segs[s, 0]), int(segs[s, 1])],
              "solve_slots": int(slots[s]), "max_abs_err": e, "ms": time_ms(launch, 50),
              "plain_ms": time_ms(lambda: ref.superstep_ref(
                  *tables, diag, tiles, b_pad, acc, x, delta=delta), 3, warmup=1),
              "bound_ms": bound_ms, "bound_by": bound_by}
        for row in rows_out:
            if row["name"] == form:
                row["at_zerocopy_segment"] = at
        parts.append(f"{form} {at['ms']:.4f} ms (plain {at['plain_ms']:.2f}, max abs err "
                     f"{e:.2e})")
    return (f"phase 12 split kernels at the widest zerocopy segment (device 0 of "
            f"{UNIFIED_RANKS}, segment {s}: levels {segs[s, 0]}..{segs[s, 1] - 1}, "
            f"{slots[s]} solve slots, {len(segs)} segments; acc zero): "
            + "; ".join(parts) + f"; bound {bound_ms:.5f} ms ({bound_by}); CUDA events, "
            f"50 launches")


def run_spawned(jobs: list, timeout: float, what: str) -> list:
    """Start one spawned process per ``(target, args)`` of ``jobs`` (each
    calls ``target(*args, out)``), all at once; collect one result from each
    through a queue, and check that every process exited 0."""
    import multiprocessing
    import queue

    spawn = multiprocessing.get_context("spawn")
    out = spawn.Queue()
    procs = [spawn.Process(target=target, args=(*args, out)) for target, args in jobs]
    for p in procs:
        p.start()
    results = []
    try:
        deadline = time.perf_counter() + timeout
        while len(results) < len(procs):
            check(time.perf_counter() < deadline, f"{what}: timed out")
            bad = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
            check(not bad, f"{what}: a process exited {bad}")
            with contextlib.suppress(queue.Empty):
                results.append(out.get(timeout=5))
        for p in procs:
            p.join(60)
        check(all(p.exitcode == 0 for p in procs),
              f"{what}: exited {[p.exitcode for p in procs]}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
    return results


def phase_unified(a, b, b_dy, x_int, want: dict, store_bytes: int, one_device: dict,
                  rng, tail: dict, side: int = SIDE, panel_side: int = PCG_SIDE,
                  device: str = "cuda:0") -> tuple:
    """Phases 11 and 12 on ``a`` (``grid2d_factor(side, seed=6)``; ``b``,
    ``b_dy``, ``x_int`` and ``want`` as in main): the ranks' solves
    (:func:`unified_rank`, both phases in one start of the ranks), the
    split kernel against its plain version and its times
    (:func:`split_kernel_rows`, :func:`zerocopy_segment_times`), and the
    CLI under ``torch.distributed.run`` (unified, then zerocopy syncfree).
    ``tail``: phase 13's inputs (:func:`tail_rank`, run by the same ranks
    after phase 12). Returns the kernel rows of the split forms, the
    launches of each rank-0 solve by path, phase 12's seconds and every
    rank's results (phase 13's under ``"tail"``)."""
    import numpy as np

    from repro_torch.launch.serve_solve import dyadic
    from repro_torch.sparse import suite
    from repro_torch.sparse.matrix import reference_solve, to_scipy

    sub_s = {}
    t0 = time.perf_counter()
    a_p = suite.grid2d_factor(panel_side, seed=6)
    panel_p = rng.uniform(-1, 1, (a_p.n, 8))
    x_wide = rng.integers(-4, 5, a_p.n).astype(np.float64)
    b_wide = (to_scipy(dyadic(a_p, seed=SEED)) @ x_wide).astype(np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        inputs = str(Path(tmp) / "inputs.npz")
        np.savez(inputs, b=b, b_dy=b_dy, x_int=x_int, want_forward=want["forward"],
                 want_transpose=want["transpose"], panel_p=panel_p,
                 want_panel_p=reference_solve(a_p, panel_p), store_bytes=store_bytes,
                 side=side, panel_side=panel_side, device=device, x_wide=x_wide, b_wide=b_wide,
                 calibration=str(Path(tmp) / "calibration.json"),
                 plan_store=str(Path(tmp) / "plan_store"), **tail)
        results = run_spawned([(unified_rank, (r, inputs, str(Path(tmp) / "rendezvous")))
                               for r in range(UNIFIED_RANKS)], UNIFIED_TIMEOUT,
                              "phase 11 ranks")
        check(Path(tmp, "calibration.json").exists(),
              "phase 13c: no calibration file was written")
    sub_s["a ranks"] = time.perf_counter() - t0
    results.sort(key=lambda r: r["rank"])
    r0 = results[0]
    for name, row in r0["forms"].items():
        other = [r["forms"][name]["ms"] for r in results[1:]]
        log(f"phase 11 {name}: {row['ms']:.1f} ms/solve on rank 0 (others {other}), "
            f"{row['supersteps']} supersteps of {row['levels']} levels, {row['exchanges']} "
            f"exchanges, launches {json.dumps({k: v for k, v in row['launches'].items() if v})}"
            + (f", rel err {row['rel_err']:.2e}" if "rel_err" in row else ", bit-equal to x"))
    log(f"phase 11 ({UNIFIED_RANKS} ranks sharing one card through gloo over host memory; "
        f"no interconnect measured): boundary rows {r0['n_boundary_rows']}, tiles per rank "
        f"{[r['n_tiles_here'] for r in results]}; ms/solve beside the one-device megakernel "
        f"(phases 5 and 6, ctx.solve medians): fused {r0['forms']['fused']['ms']:.1f} vs "
        f"streamed {one_device['streamed']:.2f}; resident {r0['forms']['resident']['ms']:.1f} "
        f"vs {one_device['resident']:.2f}; cuda {r0['forms']['cuda']['ms']:.1f} vs the "
        f"one-device switch {one_device['switch']:.2f}")
    # phase 12: beside phase 11's unified solve of the same form and the
    # one-device solve (phases 3, 5, 6, 7 medians)
    alone = {"fused": one_device["streamed"], "fused_transpose": None,
             "fused_dagpart": None, "resident": one_device["resident"],
             "cuda": one_device["switch"], "syncfree_dense": one_device["syncfree_dense"],
             "syncfree_frontier": one_device["syncfree_frontier"],
             "syncfree_unified_dense": one_device["syncfree_dense"],
             "syncfree_unified_frontier": one_device["syncfree_frontier"]}
    for name, row in r0["zc"].items():
        other = [r["zc"][name]["ms"] for r in results[1:]]
        uni = r0["forms"].get(name, {}).get("ms")
        one = alone.get(name)
        log(f"phase 12 {name}: {row['ms']:.1f} ms/solve on rank 0 (others {other}; phase 11 "
            f"unified {'—' if uni is None else f'{uni:.1f}'}; one device "
            f"{'—' if one is None else f'{one:.2f}'}), {row['levels']} levels, "
            f"{row['exchanges']} exchanges, {row['exchange_bytes']} bytes exchanged, "
            f"{row['all_reduces']} all_reduces, launches "
            f"{json.dumps({k: v for k, v in row['launches'].items() if v})}"
            + (f", rel err {row['rel_err']:.2e}" if "rel_err" in row else ", bit-equal to x"))
    log(f"phase 12 ({UNIFIED_RANKS} ranks sharing one card through gloo over host memory; no "
        f"interconnect measured): zerocopy fused {r0['zc']['fused']['ms']:.1f} ms/solve vs "
        f"unified {r0['forms']['fused']['ms']:.1f} vs one device {one_device['streamed']:.2f}; "
        f"zerocopy cuda {r0['zc']['cuda']['ms']:.1f} vs unified "
        f"{r0['forms']['cuda']['ms']:.1f}; seconds per sub-step on rank 0: "
        + ", ".join(f"{k}={v:.1f}" for k, v in r0["seconds"].items()))

    w = r0["wide"]["wide_dyadic"]
    log(f"phase 14 zerocopy fused_streamed at B={WIDE_BLOCKS[0]} on the dyadic twin of "
        f"grid2d_factor({panel_side}) ({UNIFIED_RANKS} ranks, phase 12's): {w['ms']:.1f} "
        f"ms/solve on rank 0, {w['levels']} levels, {w['exchanges']} exchanges, launches "
        f"{json.dumps({k: v for k, v in w['launches'].items() if v})}, x exact on every rank; "
        f"{r0['seconds']['14 wide']:.1f} s")
    t0 = time.perf_counter()
    rows_out = split_kernel_rows(a, r0, rng, device)
    sub_s["b split kernels"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    log(zerocopy_segment_times(a, rows_out, rng, device))
    sub_s["12b split kernels"] = time.perf_counter() - t0

    # the CLI under torch.distributed.run, both ranks on this card (full
    # option names only: torch.distributed.run reads an abbreviation of one
    # of its own, such as --n, as its own)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), GLOO_SOCKET_IFNAME="lo")
    for phase, opts in ((11, ["--comm", "unified", "--sched", "dagpart", "--kernel", "fused"]),
                        (12, ["--sched", "syncfree"])):  # 12: the default --comm zerocopy
        t0 = time.perf_counter()
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc-per-node", str(UNIFIED_RANKS), "-m", "repro_torch.launch.solve",
               "--matrix", "webbase-1M", "--scale", "2", *opts, "--dist-backend", "gloo",
               "--device", device, "--repeats", "2", "--tol", str(TOL_SOLVE), "--verify"]
        run = subprocess.run(cmd, capture_output=True, text=True, timeout=300, env=env,
                             cwd=ROOT)
        for line in run.stdout.splitlines():
            if line.startswith("[solve]"):
                log(f"phase {phase} cli {line}")
        check(run.returncode == 0, f"phase {phase}: the CLI under torch.distributed.run "
                                   f"exited {run.returncode}: {run.stderr[-2000:]}")
        sub_s[f"{'c' if phase == 11 else '12c'} cli"] = time.perf_counter() - t0
    log("phase 11 and 12 seconds per sub-step (a: both phases' ranks): "
        + ", ".join(f"{k}={v:.1f}" for k, v in sub_s.items()))
    zeros = dict.fromkeys(r0["forms"]["fused"]["launches"], 0)
    paths = {**{f"unified_{name}": {**zeros, **row["launches"]}
                for name, row in r0["forms"].items()},
             **{f"zerocopy_{name}": {**zeros, **row["launches"]}
                for name, row in r0["zc"].items()}}
    phase12_s = (sum(v for k, v in r0["seconds"].items() if k.startswith("12"))
                 + sub_s["12b split kernels"] + sub_s["12c cli"])
    return rows_out, paths, phase12_s, results


def phase_tail(results: list, card: str, device: str = "cuda:0") -> tuple:
    """Phase 13 from the parent: every rank's results of (a)-(d) held to
    rank 0's (the same bits, iterations, decisions), rank 0's numbers
    logged, and (e) ``launch/serve_solve.py`` under
    ``torch.distributed.run`` on ``UNIFIED_RANKS`` gloo ranks on
    ``device``. Returns rank 0's launches by path and the phase's
    seconds."""
    r0 = results[0]["tail"]
    for r in results[1:]:
        t = r["tail"]
        check(t["digests"] == r0["digests"],
              f"phase 13: rank {r['rank']}'s bits differ from rank 0's: "
              f"{sorted(k for k in t['digests'] if t['digests'][k] != r0['digests'][k])}")
        for method in ("pcg", "bicgstab"):
            check(t[method]["n_iters"] == r0[method]["n_iters"]
                  and t[method]["history"] == r0[method]["history"],
                  f"phase 13b {method}: rank {r['rank']} took {t[method]['n_iters']} "
                  f"iterations, rank 0 {r0[method]['n_iters']}")
        for probes in (1, 0):
            mine, first = t["auto"][probes], r0["auto"][probes]
            check(mine["chosen"] == first["chosen"] and mine["probe_us"] == first["probe_us"]
                  and mine["scores"] == first["scores"],
                  f"phase 13c (probes {probes}): rank {r['rank']} chose {mine['chosen']}, "
                  f"rank 0 {first['chosen']}")
        check(t["calibration_saves"] == 0 and t["calibration_samples"]
              == r0["calibration_samples"],
              f"phase 13c: rank {r['rank']} saved the calibration file "
              f"{t['calibration_saves']} times")
    probed = r0["auto"][1]
    check(r0["calibration_saves"] == probed["candidates"] > 1,
          f"phase 13c: rank 0 saved {r0['calibration_saves']} times for "
          f"{probed['candidates']} candidates")
    note = (f"{UNIFIED_RANKS} ranks sharing one card through gloo; no NVLink measured; "
            f"card {card}")
    log(f"phase 13a SpMV at D={UNIFIED_RANKS} (n = {PCG_SIDE}^2; {note}): dyadic vector "
        f"and (n, 8) panel bit-equal to the one-device SpMV on every rank, real within "
        f"{max(r0['spmv_vector_rel_err'], r0['spmv_panel_rel_err']):.2e}; 3 GEMV (GEMM) "
        f"launches and one all_reduce a matvec; {r0['ms']['spmv D=2']:.2f} ms a matvec "
        f"on rank 0 against {r0['ms']['spmv one device']:.2f} ms on one device")
    for method in ("pcg", "bicgstab"):
        m = r0[method]
        log(f"phase 13b {method} at D={UNIFIED_RANKS} (zerocopy, fused; {note}): "
            f"{m['n_iters']} iterations (every rank), {m['seconds']:.1f} s (analysis + "
            f"factorization + iterations), true rel residual "
            f"{m['true_res']:.2e}, {m['matvecs']} matvecs, split launches a solve "
            f"(forward, backward) {m['split']['forward']['fused_launches']}, "
            f"{m['split']['backward']['fused_launches']}, exchanges "
            f"{m['split']['forward']['exchanges']}, {m['split']['backward']['exchanges']}, "
            f"launches {json.dumps({k: v for k, v in r0['paths'][method + '_zerocopy_fused'].items() if v})}; "
            f"an iteration's steps (median of 3, ms): "
            + ", ".join(f"{k} {v:.1f}" for k, v in m["step_ms"].items()))
    for probes, d in r0["auto"].items():
        log(f"phase 13c auto at D={UNIFIED_RANKS} (probe_solves={probes}; "
            f"grid2d_factor({AUTO_SIDE}); {note}): chose {'/'.join(d['chosen'])} "
            f"({d['mode']}, {d['candidates']} candidates, both comm modes, every rank), "
            f"probe overhead {d['overhead_s']:.1f} s"
            + (", probe ms " + ", ".join(f"{k}={v / 1e3:.1f}" for k, v in
                                          sorted(d["probe_us"].items(), key=lambda kv: kv[1]))
               if d["probe_us"] else ""))
    sec = r0["seconds"]
    log(f"phase 13d plan store at D={UNIFIED_RANKS} (n = {SIDE}^2 dyadic twin; {note}): "
        f"cold analyse+plan {sec['13d cold analyse+plan']:.1f} s, warm load+plan "
        f"{sec['13d warm analyse+plan']:.1f} s, warm hits 1 on every rank, rank 0 alone "
        f"saved, warm x == cold x == x_int")

    # (e) the service on both ranks: every ticket exact and its solo solve's bits
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), GLOO_SOCKET_IFNAME="lo")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(UNIFIED_RANKS), "-m", "repro_torch.launch.serve_solve",
           "--hot-side", str(SERVICE_SIDE), "--requests", str(SERVE_REQUESTS), "--dyadic",
           "--solo-check", "--kernel", "fused", "--dist-backend", "gloo", "--device", device]
    run = subprocess.run(cmd, capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    for line in run.stdout.splitlines():
        if line.startswith("[serve]"):
            log(f"phase 13e serve ({note}) {line}")
    check(run.returncode == 0, f"phase 13e: serve_solve under torch.distributed.run exited "
                               f"{run.returncode}: {run.stdout[-1500:]} {run.stderr[-1500:]}")
    sec = {**{k: v for k, v in sec.items() if not k.startswith("13d ")},
           "13e serve": time.perf_counter() - t0}
    log("phase 13 seconds per sub-step (rank 0): "
        + ", ".join(f"{k}={v:.1f}" for k, v in sec.items()))
    zeros = dict.fromkeys(next(iter(r0["paths"].values())), 0)
    paths = {f"d2_{name}": {**zeros, **counts} for name, counts in r0["paths"].items()}
    return paths, sum(sec.values())


def cusparse_ms(a, b, want) -> tuple:
    """``torch.triangular_solve`` on ``a``'s CSR on the card (cuSPARSE): its
    ms per solve (CUDA events, 5 solves) and its device ms (``torch.profiler``,
    every kernel of the call, 5 calls) where it agrees with scipy within
    ``TOL_SOLVE``, else ``None`` for both, and a note. A yardstick only: the
    port never calls it."""
    import numpy as np
    import torch

    from repro_torch.sparse.matrix import to_scipy

    bvec = torch.from_numpy(np.asarray(b, np.float32)).cuda().reshape(-1, 1)
    sp = to_scipy(a)
    L_csr = torch.sparse_csr_tensor(
        torch.from_numpy(sp.indptr.astype(np.int64)), torch.from_numpy(sp.indices.astype(np.int64)),
        torch.from_numpy(sp.data.astype(np.float32)), size=sp.shape).cuda()
    try:
        lib_x = torch.triangular_solve(bvec, L_csr, upper=False).solution
        lib_err = rel_err(lib_x.cpu().numpy().ravel(), want)
        if lib_err > TOL_SOLVE:
            return None, None, f"rel err {lib_err:.2e} vs scipy"
        ms = time_ms(lambda: torch.triangular_solve(bvec, L_csr, upper=False), 5, warmup=1)
        dev = device_ms(lambda: torch.triangular_solve(bvec, L_csr, upper=False), ".", 5)
        return ms, dev, f"rel err {lib_err:.2e} vs scipy"
    except (RuntimeError, NotImplementedError) as e:  # a yardstick only, never on the path
        return None, None, f"refused: {str(e).splitlines()[0][:160]}"


# ---------------------------------------------------------------------------
# phase 14: the streamed megakernel at B > 169 (row chunks), one device
# ---------------------------------------------------------------------------


def wide_split_row(a, a_dy, B: int, rng, launches: int, device: str = "cuda:0") -> dict:
    """The split forms at block size ``B`` (the streamed one copying row
    chunks) against their plain versions on one launch of a merged step of
    a ``UNIFIED_RANKS``-device unified dagpart plan, with non-zero carries.
    On the dyadic problem ``a_dy``, bit-equal, at the merged step and device
    solving the most rows whose float32 plain result is its float64 one
    (nothing rounds, so every correct order gives those bits); on ``a``, at
    the step and device solving
    the most rows, within ``TOL_SOLVE`` of the plain version, streamed
    bit-equal to resident, and timed. Returns the chunked split row
    (``launches``: phase 14's two-rank path)."""
    import numpy as np
    import torch

    from repro_torch.core.solver import SolverConfig, build_plan, level_widths, step_offsets
    from repro_torch.kernels import ref, superstep

    def launch_inputs(plan, so, s, d, values):
        """Tables, layout and carries of one split launch of step ``s`` on device ``d``."""
        host = [np.array([s, 1])] + [plan.lvl_off, level_widths(plan), plan.solve_rows[d],
                                     plan.upd_tiles[d], plan.tile_row[d], plan.tile_col[d]]
        tables = [torch.from_numpy(np.ascontiguousarray(t, dtype=np.int32)).to(device)
                  for t in host]
        host_layout = superstep.segmented_layout(*host[1:], n_rows=plan.bs.nb + 1, stp=so,
                                                 bounds=np.arange(len(so)))
        shape = (plan.bs.nb + 1, B)
        vecs = [(rng.uniform(-1, 1, shape) if values == "real"
                 else rng.integers(-3, 4, shape)).astype(np.float32) for _ in range(4)]
        for v in vecs:
            v[-1] = 0
        return (tables, host_layout, host_layout.to(device),
                [torch.from_numpy(v).to(device) for v in vecs])

    out = {}
    for values, src in (("dyadic", a_dy), ("real", a)):
        plan = build_plan(src, UNIFIED_RANKS, SolverConfig(block_size=B, comm="unified",
                                                           sched="dagpart"))
        so = step_offsets(plan)
        sw = level_widths(plan)[:, 0]
        stp = torch.from_numpy(np.ascontiguousarray(so, dtype=np.int32)).to(device)
        diag = torch.from_numpy(plan.diag).to(device)
        merged = np.nonzero(np.diff(so) > 1)[0]
        # (rows solved, step, device), most rows first
        cands = sorted(((int((plan.solve_rows[d][plan.lvl_off[so[t], 0]:plan.lvl_off[so[t], 0]
                                                   + sw[so[t]:so[t + 1]].sum()] >= 0).sum()),
                         int(t), d) for t in merged for d in range(UNIFIED_RANKS)), reverse=True)
        cands = [c for c in cands if c[0] > 0]
        check(bool(cands), f"phase 14 split B={B} ({values}): no merged step solves a row")
        for rows, s, d in cands:
            tables, host_layout, layout, (b_pad, acc, delta, x) = launch_inputs(
                plan, so, s, d, values)
            tiles = torch.from_numpy(np.ascontiguousarray(plan.tiles[d])).to(device)
            plain = ref.superstep_ref(*tables, diag, tiles, b_pad, acc, x, stp, delta=delta)
            if values == "real":
                break
            exact = ref.superstep_ref(*tables, diag.double(), tiles.double(), b_pad.double(),
                                      acc.double(), x.double(), stp, delta=delta.double())
            if all(torch.equal(p_, e_.float()) for p_, e_ in zip(plain, exact)):
                break
        else:
            fail(f"phase 14 split B={B}: every dyadic merged step rounds: no bit check")
        table = layout.segments[s]
        check(superstep.streamed_shape(B, layout.max_item_tiles)[2] < B,
              f"phase 14 split B={B}: the streamed form does not take row chunks")
        values_ = superstep.streamed_values(layout, diag, tiles)
        flags = superstep.ReadyFlags(plan.bs.nb + 1, device)

        def launch(form, d_, x_):
            if form == "resident":
                superstep.superstep_split_(*tables, diag, tiles, b_pad, acc, d_, x_, stp,
                                           table=table, flags=flags)
            else:
                superstep.superstep_streamed_split_(*tables, values_, b_pad, acc, d_, x_, stp,
                                                    layout=layout, table=table, flags=flags)

        got = {}
        for form in ("resident", "streamed"):
            d_, x_ = delta.clone(), x.clone()
            launch(form, d_, x_)
            torch.cuda.synchronize()
            got[form] = (acc, d_, x_)
            if values == "dyadic":
                check(all(torch.equal(g, w) for g, w in zip(got[form], plain)),
                      f"phase 14 split B={B} {form} != its plain version on the dyadic step")
        check(all(torch.equal(g, w) for g, w in zip(got["streamed"], got["resident"])),
              f"phase 14 split B={B} ({values}): streamed != resident bit for bit")
        step = {"superstep": s, "levels": [int(so[s]), int(so[s + 1])],
                "n_levels": int(so[s + 1] - so[s]), "device": d,
                "rows_solved": rows, "orphans": table.n_orphans}
        if values == "dyadic":
            log(f"phase 14 split kernels at B={B}, shallow dyadic problem (device {d} of "
                f"{UNIFIED_RANKS}, merged step {s}: levels {so[s]}..{so[s + 1] - 1}, {rows} "
                f"rows solved, {table.n_orphans} orphans): resident and streamed bit-identical "
                f"to the plain version")
            continue
        e = max(float((g - w).abs().max()) for g, w in zip(got["streamed"], plain))
        scale = max(float(w.abs().max()) for w in plain)
        check(e <= TOL_SOLVE * scale, f"phase 14 split B={B} vs plain: max abs err {e:.3e}")
        d_, x_ = delta.clone(), x.clone()
        turns = [time_ms(lambda form=form: launch(form, d_, x_), 20)
                 for form in ("resident", "streamed", "streamed", "resident")]
        bound_ms, bound_by = split_bound(plan, d, host_layout.segments[s], 1)
        out = {
            "name": "superstep_streamed_split_chunked", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/superstep.cu",
            "replaces": KERNELS["superstep_streamed_split_chunked"][0], "launches": launches,
            "max_abs_err": e, "ms": (turns[1] + turns[2]) / 2,
            "plain_ms": time_ms(lambda: ref.superstep_ref(*tables, diag, tiles, b_pad, acc, x,
                                                          stp, delta=delta), 2, warmup=1),
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "device_ms": device_ms(lambda: launch("streamed", d_, x_),
                                   MEGAKERNEL_SYMBOL[True, True], 20),
            "resident_ms": (turns[0] + turns[3]) / 2, "turns_ms": turns,
            "resident_device_ms": device_ms(lambda: launch("resident", d_, x_),
                                            MEGAKERNEL_SYMBOL[False, True], 20),
            "shape": [a.n, B, 1], **step}
    log(f"phase 14 split kernels at B={B}, real values (device {out['device']} of "
        f"{UNIFIED_RANKS}, merged step {out['superstep']}: levels {out['levels'][0]}.."
        f"{out['levels'][1] - 1}, {out['rows_solved']} rows solved, {out['orphans']} "
        f"orphans): max abs {out['max_abs_err']:.2e} vs plain, streamed bit-equal to "
        f"resident; ms per launch (CUDA events, 20 launches, turns resident, streamed, "
        f"streamed, resident {[round(t, 4) for t in out['turns_ms']]}) streamed "
        f"{out['ms']:.4f} (device {out['device_ms']}), resident {out['resident_ms']:.4f} "
        f"(device {out['resident_device_ms']}), plain {out['plain_ms']:.2f}, bound "
        f"{out['bound_ms']:.5f} ({out['bound_by']})")
    return out


def phase_wide(rng, wide_rank: dict, copy_lib) -> tuple:
    """Phase 14 on ``grid2d_factor(PCG_SIDE)`` and its dyadic twin, at each
    of ``WIDE_BLOCKS``: ``kernel="fused_streamed"`` (row chunks) and the
    resident ``"fused"`` (``REPRO_TORCH_STREAM_LIMIT`` above every store)
    through ``SpTRSVContext``; forward, transpose and (n, 8) solves within
    ``TOL_SOLVE`` of scipy, streamed bit-equal to resident, one launch
    each as ``dispatch_stats`` says, no plain version; the dyadic twin
    exact; ms per solve (median, min, max of 5) and per launch (in turns)
    for both forms and cuSPARSE; the kernel against its plain version; the
    split forms at the first block (:func:`wide_split_row`); then
    ``perf/stream_crossover.py`` at ``CROSSOVER_BLOCKS``. ``wide_rank`` is
    rank 0's two-rank zerocopy solve at ``WIDE_BLOCKS[0]`` (phase 12's
    ranks). Per B, the streamed kernel's split per level
    (``perf/profile_solve.py``'s: whole, without tile products, launch and
    level walk alone) and one CTA's bulk-copy rate at its chunk size
    (``perf/bulk_copy.py``, ``copy_lib`` its library). Returns the two
    kernel rows and the launches of each path."""
    import numpy as np
    import scipy.sparse.linalg as spla
    import torch

    from repro_torch.api import PlanOptions, SpTRSVContext
    from repro_torch.core.blocking import pad_rhs
    from repro_torch.core.solver import (
        SolverConfig, build_plan, dispatch_stats, fused_streaming, resident_store_bytes,
    )
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref, superstep
    from repro_torch.launch.serve_solve import dyadic
    from repro_torch.sparse import suite
    from repro_torch.sparse.matrix import reference_solve, to_scipy

    sys.path.insert(0, str(ROOT / "perf"))
    import bulk_copy
    import profile_solve
    import stream_crossover

    t_start = time.perf_counter()
    a = suite.grid2d_factor(PCG_SIDE, seed=6)
    a_dy = dyadic(a, seed=SEED)
    x_int = rng.integers(-4, 5, a.n).astype(np.float64)
    L_dy = to_scipy(a_dy)
    b_dy, bt_dy = ((M @ x_int).astype(np.float32) for M in (L_dy, L_dy.T.tocsr()))
    b, panel = rng.uniform(-1, 1, a.n), rng.uniform(-1, 1, (a.n, 8))
    want = {"forward": reference_solve(a, b),
            "transpose": spla.spsolve_triangular(to_scipy(a).T.tocsr(), b, lower=False),
            "panel_r8": reference_solve(a, panel)}
    library_ms, library_device_ms, lib_note = cusparse_ms(a, b, want["forward"])
    paths, chunked, faster = {}, {}, {}
    for B in WIDE_BLOCKS:
        t0 = time.perf_counter()
        forms = {}
        with stream_crossover.stream_limit_env(2**62):  # "fused" held resident
            for name, kernel in (("streamed", "fused_streamed"), ("resident", "fused")):
                c = SpTRSVContext(options=PlanOptions(block_size=B, kernel=kernel))
                h = c.analyse(a)
                c.executor(h), c.executor(h, transpose=True)  # plans, tables, stores, upload
                forms[name] = (c, h)
            torch.cuda.synchronize()
            analyse_s = time.perf_counter() - t0
            plan = forms["streamed"][0].plan(forms["streamed"][1])
            stats = dispatch_stats(plan)
            fused = forms["streamed"][0].executor(forms["streamed"][1])._fused
            warps, cap, rows = superstep.streamed_shape(B, fused.layout.max_item_tiles)
            check(stats["streamed"] and (warps, cap) == (superstep.chunk_warps(B), 1)
                  and rows < B, f"phase 14 B={B}: the streamed plan's shape "
                  f"{(warps, cap, rows)}")
            check(not dispatch_stats(forms["resident"][0].plan(forms["resident"][1]))["streamed"],
                  f"phase 14 B={B}: fused did not stay resident under the raised limit")
            log(f"phase 14 B={B}: n={a.n} nb={plan.bs.nb} levels={plan.n_levels}, "
                f"resident_store_bytes {resident_store_bytes(plan)}, streamed store "
                f"{fused.values.numel() * 4} B; W = {warps} warps a CTA, one CTA an item, "
                f"sharing two stages of {rows} tile rows "
                f"({len(superstep.stream_chunks(B, rows))} bulk copies a tile), "
                f"{stats['fused_vmem_bytes']} B shared memory/CTA; bulk-copied per solve "
                f"{stats['stream_dma_bytes']} B (vector); analyse+plan+layout+upload "
                f"(forward and transpose, both forms) {analyse_s:.1f} s")
            xs, ms = {}, {}
            for name, (c, h) in forms.items():
                mega = "superstep_streamed" if name == "streamed" else "superstep"
                kops.reset_launch_counts()
                with PlainCalls(ref) as plain:
                    xs[name] = {"forward": c.solve(h, b),
                                "transpose": c.solve(h, b, transpose=True),
                                "panel_r8": c.solve(h, panel)}
                made = kops.launch_counts()
                n_launch = sum(dispatch_stats(c.plan(h, transpose=t))["fused_launches"]
                               for t in (False, True, False))
                check(made == {**dict.fromkeys(made, 0), mega: n_launch},
                      f"phase 14 B={B} {name}: launches {made}, dispatch_stats {n_launch}")
                check(plain.calls == 0, f"phase 14 B={B} {name}: {plain.calls} plain calls")
                paths[f"wide_B{B}_{name}"] = made
                for form, x in xs[name].items():
                    e = rel_err(x, want[form])
                    check(np.isfinite(e) and e <= TOL_SOLVE,
                          f"phase 14 B={B} {name} {form}: rel err {e:.3e}")
                ms[name] = solve_times(c, h, b, panel)
            for form in want:
                check(np.array_equal(xs["streamed"][form], xs["resident"][form]),
                      f"phase 14 B={B} {form}: streamed != resident bit for bit")
            # the kernels alone, in turns, and the streamed one against its plain version
            solver_r = forms["resident"][0].executor(forms["resident"][1])
            res_f = solver_r._fused
            b_pad = torch.from_numpy(np.concatenate(
                [pad_rhs(np.asarray(b, np.float32), plan.bs),
                 np.zeros((1, B), np.float32)])).cuda()
            zeros = torch.zeros_like(b_pad)

            def streamed_fn():
                return superstep.superstep_streamed_call(
                    *fused.tables, fused.values, b_pad, zeros, zeros, stp=fused.stp,
                    layout=fused.layout, flags=fused.flags)

            def resident_fn():
                return superstep.superstep_call(
                    *res_f.tables, solver_r._diag, solver_r._tiles, b_pad, zeros, zeros,
                    stp=res_f.stp, table=res_f.table, flags=res_f.flags)

            turns = [time_ms(fn, 5, warmup=1)
                     for fn in (resident_fn, streamed_fn, streamed_fn, resident_fn)]
            r_ms, s_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
            faster[B] = s_ms <= r_ms
            got = streamed_fn()[1]
            plain_fn = (lambda: ref.superstep_streamed_ref(
                *fused.tables, fused.values, fused.layout.diag_entry, fused.layout.tile_entry,
                b_pad, zeros, zeros, fused.stp))
            plain_x = plain_fn()[1]
            torch.cuda.synchronize()
            check(torch.equal(got, resident_fn()[1]),
                  f"phase 14 B={B}: the streamed launch != the resident one bit for bit")
            e_plain = float((got - plain_x).abs().max())
            check(e_plain <= TOL_SOLVE * float(plain_x.abs().max()),
                  f"phase 14 B={B}: kernel vs plain max abs err {e_plain:.3e}")
            bound_ms, bound_by = superstep_bound(plan, fused.layout.table, 1)
            chunked[B] = {
                "ms": s_ms, "resident_ms": r_ms, "turns_ms": turns, "max_abs_err": e_plain,
                "plain_ms": time_ms(plain_fn, 1, warmup=0), "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": library_ms,
                "library_device_ms": library_device_ms,
                "device_ms": device_ms(streamed_fn, MEGAKERNEL_SYMBOL[True, False], 5),
                "resident_device_ms": device_ms(resident_fn, MEGAKERNEL_SYMBOL[False, False], 3),
                "solve_ms": {k: v["forward"] for k, v in ms.items()},
                "shape": [a.n, B, 1], "n_levels": plan.n_levels, "warps": warps, "rows": rows,
                "shared_bytes": stats["fused_vmem_bytes"],
                "copied_bytes": stats["stream_dma_bytes"]}
            log(f"phase 14 B={B} rel err vs scipy: " + ", ".join(
                f"{f}={rel_err(xs['streamed'][f], want[f]):.2e}" for f in want)
                + "; streamed bit-equal to resident in each form; no plain-version call")
            log(f"phase 14 B={B} ms/solve (ctx.solve, median of 5; min, max): " + "; ".join(
                f"{name} " + ", ".join(f"{k}={v[2]:.2f} ({v[0]:.2f}, {v[-1]:.2f})"
                                       for k, v in t.items()) for name, t in ms.items())
                + f"; cuSPARSE (torch.triangular_solve on the CSR) "
                f"{'n/a' if library_ms is None else f'{library_ms:.3f}'} ms (device "
                f"{library_device_ms}; {lib_note})")
            log(f"phase 14 B={B} kernel alone, ms per launch (CUDA events, 5 launches, turns "
                f"resident, streamed, streamed, resident {[round(t, 4) for t in turns]}): "
                f"streamed {s_ms:.4f} (device {chunked[B]['device_ms']}), resident {r_ms:.4f} "
                f"(device {chunked[B]['resident_device_ms']}), streamed/resident "
                f"{s_ms / r_ms:.4f}; plain {chunked[B]['plain_ms']:.1f}; kernel vs plain max "
                f"abs {e_plain:.2e}; bound {bound_ms:.4f} ({bound_by})")
            # where a level's time goes, and what one CTA's copies can carry
            split = profile_solve.megakernel_split(
                forms["streamed"][0].executor(forms["streamed"][1]),
                torch.from_numpy(pad_rhs(b, plan.bs)).cuda())
            copy = bulk_copy.rates(copy_lib, B)
            chunked[B]["split_ms"] = split
            chunked[B]["copy_bytes_per_us"] = {k: v[2] for k, v in copy.items()}
            log(f"phase 14 B={B} streamed kernel split over {plan.n_levels} levels "
                f"(perf/profile_solve.py), ms per launch (us per level): " + "; ".join(
                    f"{k} {v:.3f} ({1e3 * v / plan.n_levels:.3f})" for k, v in split.items())
                + f"; bulk copies of one CTA (perf/bulk_copy.py) "
                + bulk_copy.format_rates(B, copy) + f"; bytes copied a level "
                f"{stats['stream_dma_bytes'] / plan.n_levels:.0f}")
            # the dyadic twin: any correct order gives x_int exactly
            for name, (c, h) in forms.items():
                c.factorize(a_dy, h)
                check(np.array_equal(c.solve(h, b_dy), x_int)
                      and np.array_equal(c.solve(h, bt_dy, transpose=True), x_int),
                      f"phase 14 B={B} {name}: the dyadic twin's solve is not x_int")
        del forms, fused, solver_r, res_f
        gc.collect()
        torch.cuda.empty_cache()
        plain_fused = build_plan(a, 1, SolverConfig(block_size=B, kernel_backend="fused"))
        check(fused_streaming(plain_fused) == faster[B],
              f"phase 14 B={B}: plain fused {'streams' if faster[B] else 'stays resident'} "
              f"by the rule, but the {'resident' if faster[B] else 'streamed'} kernel "
              f"measured faster")
        log(f"phase 14 B={B}: dyadic twin exact (forward, transpose) in both forms; plain "
            f"fused by the rule: {'streamed' if fused_streaming(plain_fused) else 'resident'}; "
            f"{time.perf_counter() - t0:.1f} s")

    # the dyadic split check on a shallow problem (12 row levels, 24 block
    # rows): a merged step of the factor's twin is too deep to stay exact
    # under non-zero carries
    shallow = dyadic(suite.random_levelled(24 * WIDE_BLOCKS[0], 12, 4.0, seed=6), seed=SEED)
    split_row = wide_split_row(a, shallow, WIDE_BLOCKS[0], rng,
                               wide_rank["launches"]["superstep_streamed_split"])
    t0 = time.perf_counter()
    table = stream_crossover.measure(blocks=CROSSOVER_BLOCKS, solves=10)
    for r in table:
        log("phase 14 crossover " + stream_crossover.format_row(r))
    log(f"phase 14 crossover ({time.perf_counter() - t0:.1f} s) crossover_bytes "
        f"{stream_crossover.crossover_bytes(table)}")
    B0 = WIDE_BLOCKS[0]
    row = {"name": "superstep_streamed_chunked", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/superstep.cu",
           "replaces": KERNELS["superstep_streamed_chunked"][0],
           "launches": sum(p["superstep_streamed"] for p in paths.values()),
           **{k: v for k, v in chunked[B0].items() if k != "solve_ms"},
           "at_B": {str(B): v for B, v in chunked.items() if B != B0}}
    paths[f"wide_zerocopy_B{B0}"] = wide_rank["launches"]
    log(f"phase 14 the streamed kernel in row chunks: {time.perf_counter() - t_start:.1f} s")
    return [row, split_row], paths


# ---------------------------------------------------------------------------
# phase 15: the LM serving path (reduced configs, then llama3.2-1b in full)
# ---------------------------------------------------------------------------


def lm_decode_bound_ms(param_bytes: int, cache_bytes: int) -> float:
    """Least time (ms) of one greedy decode step: every parameter and the
    whole KV cache read once at peak bandwidth (the step's operations,
    2 x parameters x batch, take far less at the bfloat16 peak)."""
    return 1e3 * (param_bytes + cache_bytes) / PEAK_BYTES_PER_S


def kernel_profile(fn, top: int = 4) -> tuple[float, float, int, str, float]:
    """(wall ms, device-busy ms, kernel count, its ``top`` kernels, GEMM ms)
    of ``fn()``: the host clock around it (ended by a synchronize), the
    sum of its CUDA kernels' times in ``torch.profiler`` (one stream, so the
    kernels do not overlap), how many kernels ran, the kernels that took
    the most, as "name ms xcount", and the ms of the kernels whose name
    matches ``GEMM_KERNEL`` (cuBLAS's matmuls)."""
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in kernels)
    gemm = sum(e.self_device_time_total for e in kernels if re.search(GEMM_KERNEL, e.key))
    heads = "; ".join(f"{e.key[:60]} {e.self_device_time_total / 1e3:.3f} x{e.count}"
                      for e in kernels[:top])
    return 1e3 * wall, busy / 1e3, sum(e.count for e in kernels), heads, gemm / 1e3


def device_busy_ms(fn, top: int = 4) -> tuple[float, float, str]:
    """``kernel_profile`` with the count folded into the text:
    (wall ms, device-busy ms, "N kernels; heads")."""
    wall, busy, n, heads, _ = kernel_profile(fn, top)
    return wall, busy, f"{n} kernels; {heads}"


def phase_lm(card: str) -> dict:
    """Phase 15 (see the module docstring); returns the numbers it printed."""
    import torch

    from repro_torch.configs import ARCH_IDS, get_config, get_reduced
    from repro_torch.data import SyntheticLM
    from repro_torch.models import attention, init_cache, init_params, param_count
    from repro_torch.models.layers import vocab_pad_mask
    from repro_torch.models.model import forward, loss_fn
    from repro_torch.obs.metrics import get_registry
    from repro_torch.serve.crosscheck import serve_outputs
    from repro_torch.serve.engine import make_decode_step, make_prefill_step

    vocab = get_config(LM_ARCH).vocab

    def greedy(logits):
        return torch.argmax(vocab_pad_mask(logits.float(), vocab), dim=-1).to(torch.int32)

    t_start = time.perf_counter()
    sub_s = {}
    out = {}
    f32 = dict(dtype="float32", param_dtype="float32")

    # (a) every reduced config in float32: the card against the port on the CPU
    t0 = time.perf_counter()
    worst = {}
    for arch in ARCH_IDS:
        cfg = dataclasses.replace(get_reduced(arch), **f32)
        params = init_params(cfg, torch.Generator().manual_seed(SEED), device="cpu")
        batch = SyntheticLM(cfg, 2, 32).batch(0)
        cpu = serve_outputs(cfg, params, batch, device="cpu", steps=LM_REDUCED_STEPS)
        gpu = serve_outputs(cfg, params, batch, device="cuda", steps=LM_REDUCED_STEPS)
        errs = {k: rel_err(gpu[k].numpy(), cpu[k].numpy())
                for k in ("logits", "prefill", "encode") if cpu[k] is not None}
        errs["loss"] = abs(float(gpu["loss"]) - float(cpu["loss"])) / abs(float(cpu["loss"]))
        for k, e in errs.items():
            check(e <= TOL_LM, f"phase 15a {arch}: {k} rel err {e:.3e} (card vs CPU)")
        check(gpu["tokens"].shape == (2, LM_REDUCED_STEPS + 1)
              and torch.equal(gpu["tokens"], cpu["tokens"]),
              f"phase 15a {arch}: greedy tokens differ, card {gpu['tokens'].tolist()} "
              f"vs CPU {cpu['tokens'].tolist()}")
        worst[arch] = max(errs.values())
    sub_s["a reduced"] = time.perf_counter() - t0
    log("phase 15a reduced configs, float32, card vs CPU: forward logits, encoder, loss, "
        f"prefill within rel err {TOL_LM:g}, prefill + {LM_REDUCED_STEPS} greedy tokens equal; "
        "worst rel err per arch: " + ", ".join(f"{a}={e:.2e}" for a, e in worst.items()))
    out["reduced_rel_err"] = worst

    # (b) the full published config
    cfg = dataclasses.replace(get_config(LM_ARCH), **f32)
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.d_ff, cfg.vocab)
          == (16, 2048, 32, 8, 8192, 128256), f"phase 15b: {LM_ARCH} is not at full width: {cfg}")
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = init_params(cfg, gen, device="cuda")
    n_params = param_count(params)
    B, steps = LM_FP32
    prompt = torch.randint(0, cfg.vocab, (B, LM_PROMPT), generator=gen, device="cuda")
    with torch.no_grad():
        # each decode step's logits against one full forward over the same tokens
        cache = init_cache(cfg, B, LM_PROMPT + steps, device="cuda")
        last, cache = forward(params, cfg, prompt, cache=cache, last_only=True)
        step_logits, toks = [last[:, 0]], []
        for t in range(steps):
            toks.append(greedy(step_logits[-1]))
            lg, cache = forward(params, cfg, toks[-1][:, None], cache=cache,
                                pos_offset=LM_PROMPT + t)
            step_logits.append(lg[:, 0])
        full, _ = forward(params, cfg, torch.cat([prompt, torch.stack(toks, 1)], 1))
        errs = [rel_err(s.cpu().numpy(), full[:, LM_PROMPT - 1 + i].cpu().numpy())
                for i, s in enumerate(step_logits)]
        del cache, full
    check(max(errs) <= TOL_LM_DECODE,
          f"phase 15b fp32: decode step logits vs the full forward, rel err {max(errs):.3e}")
    # the engine's greedy tokens are the loop's
    prefill, decode = make_prefill_step(cfg, device="cuda"), make_decode_step(cfg, device="cuda")
    cache = init_cache(cfg, B, LM_PROMPT + steps, device="cuda")
    logits, cache = prefill(params, {"tokens": prompt}, cache)
    eng = [greedy(logits[:, -1])]
    for t in range(steps):
        tok, cache = decode(params, {"tokens": eng[-1][:, None]}, cache, LM_PROMPT + t)
        eng.append(tok)
    want = torch.stack(toks + [greedy(step_logits[-1])], 1)
    check(torch.equal(torch.stack(eng, 1), want),
          "phase 15b fp32: the engine's greedy tokens differ from the forward loop's")
    del cache, step_logits
    sub_s["b fp32 decode"] = time.perf_counter() - t0
    log(f"phase 15b {LM_ARCH} fp32 ({n_params} parameters), batch {B}, {LM_PROMPT}-token "
        f"prompt, {steps} greedy steps: each step's logits vs one full forward, rel err max "
        f"{max(errs):.3e} (prefill {errs[0]:.3e}); the engine's tokens equal")
    out["fp32_decode_rel_err"] = max(errs)

    # one loss at S = LM_LOSS_SEQ, where _flash runs, against the plain path
    t0 = time.perf_counter()
    batch = {k: torch.from_numpy(v).cuda() for k, v in
             SyntheticLM(cfg, 2, LM_LOSS_SEQ).batch(0).items()}
    flash = get_registry().counter("attention.flash")
    n0 = flash.value
    with torch.no_grad():
        loss = float(loss_fn(params, cfg, batch["tokens"], batch["labels"]))
        n_flash = flash.value - n0
        saved = attention.FLASH_THRESHOLD
        attention.FLASH_THRESHOLD = LM_LOSS_SEQ + 1  # the plain path, same inputs
        try:
            loss_plain = float(loss_fn(params, cfg, batch["tokens"], batch["labels"]))
        finally:
            attention.FLASH_THRESHOLD = saved
    check(n_flash == cfg.n_layers and flash.value - n0 == n_flash,
          f"phase 15b loss: _flash ran {n_flash} times, want {cfg.n_layers}")
    e = abs(loss - loss_plain) / abs(loss_plain)
    check(math.isfinite(loss) and e <= TOL_KERNEL,
          f"phase 15b loss: flash {loss} vs plain {loss_plain} (rel {e:.3e})")
    del batch, params
    torch.cuda.empty_cache()
    sub_s["b fp32 loss"] = time.perf_counter() - t0
    log(f"phase 15b {LM_ARCH} fp32 loss_fn, batch 2, S={LM_LOSS_SEQ}: {loss:.6f} "
        f"(ln vocab {math.log(cfg.vocab):.6f}); _flash ran {n_flash} times (one a layer); "
        f"plain path {loss_plain:.6f}, rel {e:.2e}")
    out.update(loss=loss, flash_calls=n_flash)

    # bfloat16 as configured: prefill rate, decode step time, peak memory
    t0 = time.perf_counter()
    cfg = get_config(LM_ARCH)
    base = torch.cuda.memory_allocated()  # earlier phases' tensors, left out of the peak
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = init_params(cfg, gen, device="cuda")
    B, new = LM_BF16
    prompt = torch.randint(0, cfg.vocab, (B, LM_PROMPT), generator=gen, device="cuda")
    prefill, decode = make_prefill_step(cfg, device="cuda"), make_decode_step(cfg, device="cuda")

    def serve(n_new):
        cache = init_cache(cfg, B, LM_PROMPT + new, device="cuda")
        t = time.perf_counter()
        logits, cache = prefill(params, {"tokens": prompt}, cache)
        torch.cuda.synchronize()
        t_pre = time.perf_counter() - t
        toks = [greedy(logits[:, -1])]
        t = time.perf_counter()
        for i in range(n_new - 1):
            tok, cache = decode(params, {"tokens": toks[-1][:, None]}, cache, LM_PROMPT + i)
            toks.append(tok)
        torch.cuda.synchronize()
        return t_pre, time.perf_counter() - t, torch.stack(toks, 1), cache

    serve(3)  # warm-up: cuBLAS handles, allocator
    torch.cuda.reset_peak_memory_stats()
    t_pre, t_dec, toks, cache = serve(new)
    peak = torch.cuda.max_memory_allocated() - base
    check(toks.shape == (B, new) and int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab,
          f"phase 15b bf16: tokens out of range {toks.shape}")
    cache_bytes = sum(t.numel() * t.element_size() for st in cache for slot in st["slots"].values()
                      for t in (slot["attn"]["k"], slot["attn"]["v"]))
    param_bytes = n_params * 2
    bound_ms = lm_decode_bound_ms(param_bytes, cache_bytes)
    # the prefill's and one decode step's device-busy share (torch.profiler)
    cache = init_cache(cfg, B, LM_PROMPT + new, device="cuda")
    pre_prof = {}

    def profiled_prefill():
        pre_prof["logits"], pre_prof["cache"] = prefill(params, {"tokens": prompt}, cache)

    pre_wall, pre_busy, pre_top = device_busy_ms(profiled_prefill)
    cache, tok = pre_prof["cache"], greedy(pre_prof["logits"][:, -1])
    steps_prof = [device_busy_ms(lambda i=i: decode(params, {"tokens": tok[:, None]}, cache,
                                                    LM_PROMPT + i)) for i in range(3)]
    wall_ms, busy_ms, dec_top = steps_prof[-1]
    sub_s["b bf16 serve"] = time.perf_counter() - t0
    out.update(prefill_tok_s=B * LM_PROMPT / t_pre, prefill_ms=1e3 * t_pre,
               decode_ms=1e3 * t_dec / (new - 1), peak_bytes=peak, decode_bound_ms=bound_ms,
               decode_wall_ms=wall_ms, decode_busy_ms=busy_ms)
    log(f"phase 15b {LM_ARCH} bf16, batch {B}, {LM_PROMPT}-token prompt, {new} new tokens "
        f"(card: {card}): prefill {1e3 * t_pre:.3f} ms = {out['prefill_tok_s']:.1f} tokens/s; "
        f"decode {out['decode_ms']:.4f} ms per step (host clock over {new - 1} steps); "
        f"bound {bound_ms:.4f} ms ({param_bytes} parameter + {cache_bytes} KV-cache bytes at "
        f"{PEAK_BYTES_PER_S:.3g} B/s); peak torch.cuda.max_memory_allocated {peak} bytes above "
        f"the {base} held before the bf16 parameters")
    log(f"phase 15b {LM_ARCH} bf16 under torch.profiler (card: {card}): prefill wall "
        f"{pre_wall:.3f} ms, kernels {pre_busy:.3f} ms (device busy {pre_busy / pre_wall:.1%}; "
        f"{pre_top}); one decode step wall {wall_ms:.4f} ms, kernels {busy_ms:.4f} ms (device "
        f"busy {busy_ms / wall_ms:.1%}; {dec_top}); earlier steps wall/kernels "
        f"{[f'{w:.3f}/{b:.3f}' for w, b, _ in steps_prof[:-1]]}")
    del params, cache
    torch.cuda.empty_cache()

    # (c) the launcher on the card
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    run = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--arch", LM_ARCH],
                         capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    line = (run.stdout.strip().splitlines() or [""])[-1]
    check(run.returncode == 0 and "on cuda" in line,
          f"phase 15c: launch/serve.py exited {run.returncode}: {line} {run.stderr[-2000:]}")
    sub_s["c launcher"] = time.perf_counter() - t0
    log(f"phase 15c python -m repro_torch.launch.serve --arch {LM_ARCH}: {line}")
    log("phase 15 seconds per sub-step: " + ", ".join(f"{k}={v:.1f}" for k, v in sub_s.items())
        + f"; total {time.perf_counter() - t_start:.1f}")
    return out


# ---------------------------------------------------------------------------
# phase 16: the LM training path (reduced configs, then llama3.2-1b in full)
# ---------------------------------------------------------------------------


def tree_rel(got, want) -> float:
    """max |got - want| over the leaves of two trees of tensors, over the
    largest |leaf entry| of ``want`` (never per leaf: a leaf whose true
    gradient is zero holds rounding noise on both sides)."""
    from repro_torch.models.model import tree_leaves

    a, b = tree_leaves(got), tree_leaves(want)
    check(len(a) == len(b), f"trees of {len(a)} and {len(b)} leaves")
    big = max(float(y.abs().max()) for y in b)
    return max(float((x.to(y.device).float() - y.float()).abs().max())
               for x, y in zip(a, b)) / big


def phase_lm_train(card: str) -> dict:
    """Phase 16 (see the module docstring); returns the numbers it printed."""
    import shutil

    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import ARCH_IDS, get_config, get_reduced
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.specs import active_param_count
    from repro_torch.launch.train import run as train_run
    from repro_torch.models import attention, init_params, param_count
    from repro_torch.models.model import tree_leaves, tree_map
    from repro_torch.obs.metrics import get_registry
    from repro_torch.train import adamw_init, make_train_step
    from repro_torch.train.step import value_and_grad

    dev = torch.device("cuda")
    t_start = time.perf_counter()
    sub_s, out = {}, {}
    f32 = dict(dtype="float32", param_dtype="float32")

    def on_dev(batch):
        return {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}

    # (a) every reduced config in float32: gradients and train steps, card vs CPU
    t0 = time.perf_counter()
    worst, params_err = {}, {}
    for arch in ARCH_IDS:
        cfg = dataclasses.replace(get_reduced(arch), **f32)
        params = init_params(cfg, torch.Generator().manual_seed(SEED), device="cpu")
        data = SyntheticLM(cfg, 2, 32)
        batch = {k: torch.as_tensor(v) for k, v in data.batch(0).items()}
        loss, grads = value_and_grad(cfg, params, batch)
        p_card = tree_map(lambda t: t.to(dev), params)
        l_on, g_on = value_and_grad(cfg, p_card, on_dev(batch), remat=True)
        l_off, g_off = value_and_grad(cfg, p_card, on_dev(batch), remat=False)
        errs = {"loss": abs(float(l_on) - float(loss)) / abs(float(loss)),
                "grads": tree_rel(g_on, grads),
                "remat loss": abs(float(l_off) - float(l_on)) / abs(float(l_on)),
                "remat grads": tree_rel(g_off, g_on)}
        # three train steps on each side (warmup 0: the later losses follow
        # updates); microbatches 2 on LM_ARCH
        mb = 2 if arch == LM_ARCH else 1
        runs = []
        for d in (torch.device("cpu"), dev):
            p = tree_map(lambda t: t.to(d, copy=True), params)  # the step updates in place
            opt = adamw_init(p)
            step = make_train_step(cfg, d, microbatches=mb, peak_lr=1e-3, warmup=0)
            metrics = [step(p, opt, data.batch(i), i)[2] for i in range(LM_TRAIN_PARITY_STEPS)]
            runs.append(([(float(m["loss"]), float(m["gnorm"])) for m in metrics], p))
        (cpu_m, cpu_p), (card_m, card_p) = runs
        for i, ((cl, cg), (gl, gg)) in enumerate(zip(cpu_m, card_m)):
            errs[f"step {i} loss"] = abs(gl - cl) / abs(cl)
            errs[f"step {i} gnorm"] = abs(gg - cg) / abs(cg)
        # printed, not held to TOL_LM: AdamW divides by sqrt(v) + eps, so a
        # leaf whose gradient is zero in exact arithmetic (llama4-maverick's
        # router under top_k = 1) moves by its rounding noise over eps
        params_err[arch] = tree_rel(card_p, cpu_p)
        for k, e in errs.items():
            check(math.isfinite(e) and e <= TOL_LM,
                  f"phase 16a {arch}: {k} rel err {e:.3e} (limit {TOL_LM:g})")
        worst[arch] = max(errs.values())
    sub_s["a reduced"] = time.perf_counter() - t0
    log("phase 16a reduced configs, float32, card vs CPU: loss and gradients (remat on), "
        f"remat on vs off on the card, {LM_TRAIN_PARITY_STEPS} make_train_step steps' losses "
        f"and gradient norms (microbatches 2 on {LM_ARCH}) within rel err {TOL_LM:g} "
        "(gradients of the tree's largest); worst per arch: "
        + ", ".join(f"{a}={e:.2e}" for a, e in worst.items())
        + "; parameters after the steps, of the largest: "
        + ", ".join(f"{a}={e:.2e}" for a, e in params_err.items()))
    out.update(reduced_rel_err=worst, reduced_params_err=params_err)

    # (b) the full published config in float32: flash vs plain, remat on vs off
    cfg = dataclasses.replace(get_config(LM_ARCH), **f32)
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.d_ff, cfg.vocab)
          == (16, 2048, 32, 8, 8192, 128256), f"phase 16b: {LM_ARCH} is not at full width: {cfg}")
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED), device="cuda")
    n_params = param_count(params)
    B, S = LM_TRAIN_FP32
    batch = on_dev(SyntheticLM(cfg, B, S).batch(0))
    flash = get_registry().counter("attention.flash")

    def grads_of(remat: bool, plain: bool = False):
        torch.cuda.synchronize()
        start = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        n0, saved = flash.value, attention.FLASH_THRESHOLD
        if plain:
            attention.FLASH_THRESHOLD = S + 1  # the plain path, same inputs
        t = time.perf_counter()
        try:
            loss, grads = value_and_grad(cfg, params, batch, remat=remat)
            torch.cuda.synchronize()
        finally:
            attention.FLASH_THRESHOLD = saved
        return (float(loss), grads, torch.cuda.max_memory_allocated() - start,
                flash.value - n0, time.perf_counter() - t)

    grads_of(True)  # warm-up: cuBLAS handles, allocator
    loss, ref, peak_on, n_flash, s_on = grads_of(True)
    check(n_flash == cfg.n_layers,
          f"phase 16b: _flash counted {n_flash} forward calls with remat, want {cfg.n_layers}")
    checks = {}
    for name, remat, plain in (("remat off", False, False), ("plain attention", True, True)):
        l2, g2, peak, n2, sec = grads_of(remat, plain)
        e_loss, e_grad = abs(l2 - loss) / abs(loss), tree_rel(g2, ref)
        del g2
        check(n2 == (0 if plain else cfg.n_layers),
              f"phase 16b {name}: _flash counted {n2} calls")
        check(math.isfinite(l2) and e_loss <= TOL_LM_GRAD and e_grad <= TOL_LM_GRAD,
              f"phase 16b {name}: loss rel {e_loss:.3e}, gradients rel {e_grad:.3e} "
              f"(limit {TOL_LM_GRAD:g} of the largest gradient)")
        checks[name] = (e_loss, e_grad, peak, sec)
    del ref, params, batch
    gc.collect()
    torch.cuda.empty_cache()
    sub_s["b fp32 grads"] = time.perf_counter() - t0
    log(f"phase 16b {LM_ARCH} fp32 ({n_params} parameters), batch {B}, S={S}, "
        f"value_and_grad (card: {card}): loss {loss:.6f}; flash + remat {1e3 * s_on:.1f} ms, "
        f"peak {peak_on} bytes above the run's start, _flash {n_flash} forward calls; "
        + "; ".join(f"{k}: loss rel {el:.2e}, gradients rel {eg:.2e}, {1e3 * sec:.1f} ms, "
                    f"peak {pk} bytes" for k, (el, eg, pk, sec) in checks.items()))
    out.update(fp32_loss=loss, fp32_peak_remat=peak_on, fp32_ms_remat=1e3 * s_on,
               fp32_checks=checks)

    # (c) bfloat16 as configured through make_train_step
    t0 = time.perf_counter()
    cfg = get_config(LM_ARCH)
    base = torch.cuda.memory_allocated()  # earlier phases' tensors, left out of the peak
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED), device="cuda")
    opt = adamw_init(params)
    B, S = LM_TRAIN_BF16
    data = SyntheticLM(cfg, B, S)
    step = make_train_step(cfg, "cuda")
    warm, timed = LM_TRAIN_STEPS
    losses, times = [], []
    for i in range(warm + timed):
        t = time.perf_counter()
        params, opt, metrics = step(params, opt, data.batch(i), i)
        losses.append(float(metrics["loss"]))  # waits for the step
        times.append(time.perf_counter() - t)
    peak = torch.cuda.max_memory_allocated() - base
    check(all(math.isfinite(x) for x in losses), f"phase 16c: losses {losses}")
    ms = 1e3 * sorted(times[warm:])[timed // 2]
    n_active = int(active_param_count(cfg))
    flops = 6 * n_active * B * S
    mfu = flops / (ms / 1e3) / PEAK_BF16_PER_S
    wall, busy, n_kernels, top, gemm = kernel_profile(
        lambda: step(params, opt, data.batch(warm + timed), warm + timed), top=6)
    # a repeated batch, warmup 0: the loss comes down
    del opt
    opt = adamw_init(params)
    fit = make_train_step(cfg, "cuda", warmup=0)
    fit_losses = [float(fit(params, opt, data.batch(0), i)[2]["loss"])
                  for i in range(LM_TRAIN_FIT + 1)]
    check(all(math.isfinite(x) for x in fit_losses) and fit_losses[-1] < fit_losses[0],
          f"phase 16c: repeated-batch losses {fit_losses} do not come down")
    sub_s["c bf16 steps"] = time.perf_counter() - t0
    out.update(ms_per_step=ms, tokens_s=B * S / (ms / 1e3), mfu=mfu, peak_bytes=peak,
               step_wall_ms=wall, step_busy_ms=busy, kernels_per_step=n_kernels, gemm_ms=gemm,
               fit_losses=fit_losses)
    log(f"phase 16c {LM_ARCH} bf16 train step, batch {B}, S={S} (card: {card}): median "
        f"{ms:.3f} ms of {timed} after {warm} warm-up (each "
        f"{[round(1e3 * t, 3) for t in times]}), {out['tokens_s']:.1f} tokens/s; model FLOPs "
        f"6 x {n_active} x {B * S} = {flops:.4e} a step, {mfu:.2%} of the {PEAK_BF16_PER_S:.3g} "
        f"FLOP/s dense bf16 peak; peak torch.cuda.max_memory_allocated {peak} bytes above the "
        f"{base} held before the phase; losses {[round(x, 4) for x in losses]}")
    log(f"phase 16c one step under torch.profiler: wall {wall:.3f} ms, kernels {busy:.3f} ms "
        f"(device busy {busy / wall:.1%}), {n_kernels} kernels, of them cuBLAS/GEMM {gemm:.3f} "
        f"ms ({gemm / busy:.1%}); {top}; repeated batch, warmup "
        f"0: losses {[round(x, 4) for x in fit_losses]}")

    # (d) the checkpoint manager on the card, then a crash and resume
    t0 = time.perf_counter()
    ckpt = ROOT / "build" / "smoke_checkpoint"
    shutil.rmtree(ckpt, ignore_errors=True)
    ckpt.mkdir(parents=True)
    need = 4 * sum(t.numel() for t in tree_leaves([params, opt]))  # float32 on disk
    free = shutil.disk_usage(ckpt).free
    check(free > 1.2 * need, f"phase 16d: {free} bytes free under {ckpt}, the checkpoint "
          f"needs {need}")
    mgr = CheckpointManager(str(ckpt), keep=1)
    t = time.perf_counter()
    mgr.save(LM_TRAIN_FIT, params, opt, {"arch": LM_ARCH, "device": "cuda"})
    save_s = time.perf_counter() - t
    disk = sum(f.stat().st_size for f in ckpt.rglob("*") if f.is_file())
    t = time.perf_counter()
    p2, o2, manifest = mgr.restore(mgr.latest_step(), params, opt, device="cuda")
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t
    pairs = list(zip(tree_leaves([p2, o2]), tree_leaves([params, opt])))
    check(len(pairs) == len(tree_leaves([params, opt])) and all(
        a.is_cuda and a.dtype == b.dtype and torch.equal(a, b) for a, b in pairs),
        "phase 16d: the restored checkpoint differs from the live tensors")
    check(manifest == {"step": LM_TRAIN_FIT, "arch": LM_ARCH, "device": "cuda"},
          f"phase 16d: manifest {manifest}")
    del p2, o2, pairs, params, opt
    shutil.rmtree(ckpt, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    kw = dict(ckpt_every=5, global_batch=2, seq_len=16, device="cuda", quiet=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        full = train_run(LM_ARCH, steps=14, ckpt_dir=os.path.join(tmp, "a"), **kw)
        train_run(LM_ARCH, steps=10, ckpt_dir=os.path.join(tmp, "b"), **kw)  # stops after 9
        resumed = train_run(LM_ARCH, steps=14, ckpt_dir=os.path.join(tmp, "b"), **kw)
    e = max(abs(a - b) / abs(b) for a, b in zip(resumed, full[10:]))
    check(len(resumed) == 4 and e <= 1e-5,
          f"phase 16d: resumed losses {resumed} vs uninterrupted {full[10:]}")
    sub_s["d checkpoint"] = time.perf_counter() - t0
    out.update(save_s=save_s, restore_s=restore_s, ckpt_bytes=disk)
    log(f"phase 16d CheckpointManager on the card: save {disk} bytes ({need} of float32 "
        f"arrays) in {save_s:.2f} s, restore to the card in {restore_s:.2f} s, every leaf "
        f"bit-equal; reduced {LM_ARCH} run stopped after step 9 and resumed to 14: losses "
        f"within rel {e:.2e} of the uninterrupted run's")

    # (e) the launcher on the card
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    run = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--arch", LM_ARCH,
                          "--steps", "3"],
                         capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    lines = run.stdout.strip().splitlines() or [""]
    check(run.returncode == 0 and "on cuda" in run.stdout and "step    2 loss" in lines[-1],
          f"phase 16e: launch/train.py exited {run.returncode}: {lines[-3:]} "
          f"{run.stderr[-2000:]}")
    sub_s["e launcher"] = time.perf_counter() - t0
    log(f"phase 16e python -m repro_torch.launch.train --arch {LM_ARCH} --steps 3: "
        + " | ".join(lines))
    log("phase 16 seconds per sub-step: " + ", ".join(f"{k}={v:.1f}" for k, v in sub_s.items())
        + f"; total {time.perf_counter() - t_start:.1f}")
    return out


# ---------------------------------------------------------------------------
# phase 17: the LM sharding rules at production scale, and placement on the card
# ---------------------------------------------------------------------------


def with_specs(tree, specs, path: str = ""):
    """``(path, leaf, spec)`` for every tensor leaf of ``tree`` beside its
    spec (a cache's host-int ``pos`` has none and is skipped)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from with_specs(v, specs[k], f"{path}/{k}")
    elif isinstance(tree, list):
        for i, (v, s) in enumerate(zip(tree, specs, strict=True)):
            yield from with_specs(v, s, f"{path}/{i}")
    elif hasattr(tree, "shape"):
        yield path, tree, specs


def spec_axes(entry) -> tuple:
    """The mesh axes of one spec entry (``None``, a name or a tuple of names)."""
    return () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)


def spec_slice(shape, spec, sizes: dict, coord: dict) -> tuple:
    """The part of a ``shape`` tensor that the rank at mesh coordinates
    ``coord`` holds under ``spec``: each dim split evenly over the product of
    its axes, the first axis major (the reference's order)."""
    out = []
    for n, entry in zip(shape, spec):
        idx, parts = 0, 1
        for a in spec_axes(entry):
            idx, parts = idx * sizes[a] + coord[a], parts * sizes[a]
        out.append(slice(idx * (n // parts), (idx + 1) * (n // parts)))
    return tuple(out)


def rules_child(device_type: str, out) -> None:
    """Phase 17a, in a process of its own (a fake world is process-wide):
    every applicable cell's ``input_specs`` on the production mesh at 256
    and 512 ranks of torch's ``fake`` backend, as the last rank. Every spec
    divides its dim, each leaf's local shape is the spec's share, every
    leaf of at least 2^24 elements is sharded on some axis, nothing is
    allocated. Puts one record per cell on ``out``: the argument bytes a
    rank holds, counted from the local shapes, and the cell's model FLOPs."""
    import torch
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.configs import all_cells, cell_applicable
    from repro_torch.distributed import axis_sizes
    from repro_torch.distributed.sharding import local_shape
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.specs import input_specs, model_flops

    t_start = time.perf_counter()
    if device_type == "cuda":
        torch.cuda.set_device(0)
    cells = []
    for world in (256, 512):
        dist.init_process_group("fake", store=FakeStore(), rank=world - 1, world_size=world)
        try:
            mesh = make_production_mesh(multi_pod=world == 512, device_type=device_type)
            sizes = axis_sizes(mesh)
            for arch, shape in all_cells():
                if not cell_applicable(arch, shape)[0]:
                    continue
                t0 = time.perf_counter()
                inp = input_specs(arch, shape, mesh)
                rank_bytes, n_leaves = {}, 0
                for tree in ("params", "opt", "batch", "cache"):
                    if tree not in inp:
                        continue
                    specs = inp["param_specs" if tree == "params" else tree + "_specs"]
                    rank_bytes[tree] = 0
                    for path, leaf, spec in with_specs(inp[tree], specs, tree):
                        local = leaf.to_local()
                        where = f"phase 17a {world} ranks {arch} {shape} {path} {tuple(leaf.shape)} {spec}"
                        check(local.is_meta, f"{where}: allocated on {local.device}")
                        check(all(n % math.prod(sizes[a] for a in spec_axes(e)) == 0
                                  for n, e in zip(leaf.shape, spec)), f"{where}: does not divide")
                        check(tuple(local.shape) == local_shape(leaf.shape, spec, mesh),
                              f"{where}: local shape {tuple(local.shape)}")
                        check(leaf.numel() < 1 << 24 or any(e is not None for e in spec),
                              f"{where}: a leaf of {leaf.numel()} elements is not sharded")
                        rank_bytes[tree] += local.numel() * local.element_size()
                        n_leaves += 1
                cell = inp["cell"]
                cells.append({"world": world, "arch": arch, "shape": shape, "leaves": n_leaves,
                              "bytes": rank_bytes, "s": time.perf_counter() - t0,
                              "flops": model_flops(inp["cfg"], cell.seq_len, cell.global_batch,
                                                   cell.step)})
        finally:
            dist.destroy_process_group()
    out.put({"cells": cells, "s": time.perf_counter() - t_start})


def shard_rank(rank: int, rdv: str, device: str, out) -> None:
    """One rank of phase 17b: ``SHARD_RANKS`` gloo ranks on ``device``, a
    ``SHARD_MESH`` ``("data", "model")`` mesh. Draws ``LM_ARCH``'s full
    parameters from ``SEED``, places them by ``shard_tree`` on the rules'
    specs (FSDP over the data axis), holds each local shard bit for bit to
    the slice its spec names and its bytes to the spec's count; ``embed``
    gathered back across the ranks through gloo, bit-equal; then the same
    for float32 AdamW moments drawn from ``SEED + 1``. A failed check exits
    non-zero."""
    import datetime

    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import Shard

    from repro_torch.configs import get_config
    from repro_torch.distributed import axis_sizes, dp_axes, make_mesh, param_specs, shard_tree
    from repro_torch.distributed.sharding import local_shape
    from repro_torch.models import init_params
    from repro_torch.models.model import tree_leaves, tree_map
    from repro_torch.train import adamw_init

    def bits(t):
        return t.contiguous().view({2: torch.int16, 4: torch.int32}[t.element_size()])

    def gather(dt):
        """``dt``'s whole tensor, gathered through the mesh's per-dim groups
        by ``dist.all_gather`` (the inner mesh dim first, so a dim over
        several axes comes back major-first). DTensor's own ``full_tensor()``
        dies of a segmentation fault in ``wait_tensor`` on gloo with CUDA
        tensors in torch 2.11 (PERF.md section 7)."""
        t = dt.to_local()
        for i in reversed(range(mesh.ndim)):
            if isinstance(dt.placements[i], Shard):
                parts = [torch.empty_like(t) for _ in range(mesh.size(i))]
                dist.all_gather(parts, t.contiguous(), group=mesh.get_group(i))
                t = torch.cat(parts, dim=dt.placements[i].dim)
        return t

    def hold(full, placed, specs, what: str) -> int:
        """Check every local shard against its slice of ``full``; its bytes."""
        total = 0
        for (path, src, spec), (_, dt, _) in zip(with_specs(full, specs, what),
                                                 with_specs(placed, specs, what), strict=True):
            local = dt.to_local()
            want = src[spec_slice(src.shape, spec, sizes, coord)]
            check(local.device == src.device and torch.equal(bits(local), bits(want)),
                  f"phase 17b rank {rank} {path} {spec}: the local shard is not its slice")
            nbytes = math.prod(local_shape(src.shape, spec, mesh)) * src.element_size()
            check(local.untyped_storage().nbytes() == nbytes,
                  f"phase 17b rank {rank} {path}: holds {local.untyped_storage().nbytes()} "
                  f"bytes, the spec {nbytes}")
            total += nbytes
        return total

    dist.init_process_group("gloo", init_method=f"file://{rdv}", rank=rank,
                            world_size=SHARD_RANKS, timeout=datetime.timedelta(seconds=300))
    try:
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev.index or 0)  # every rank on this one card
        mesh = make_mesh(SHARD_MESH, ("data", "model"), dev.type)
        sizes = axis_sizes(mesh)
        coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
        res = {"rank": rank, "coord": coord, "s": {}}
        cfg = get_config(LM_ARCH)
        t0 = time.perf_counter()
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
        specs = param_specs(params, mesh, fsdp_axes=dp_axes(mesh))
        placed = shard_tree(params, specs, mesh)
        res["param_bytes"] = hold(params, placed, specs, "params")
        res["full_bytes"] = sum(t.numel() * t.element_size() for t in tree_leaves(params))
        res["s"]["params"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        embed = gather(placed["embed"])
        check(embed.device == params["embed"].device
              and torch.equal(bits(embed), bits(params["embed"])),
              f"phase 17b rank {rank}: embed gathered across the ranks differs from the "
              f"drawn tensor")
        res["s"]["gather"] = time.perf_counter() - t0
        res["embed_spec"] = specs["embed"]
        res["embed_local"] = tuple(placed["embed"].to_local().shape)
        meta = adamw_init(init_params(cfg, device="meta"))
        del params, embed
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        g = torch.Generator(device=dev).manual_seed(SEED + 1)
        res["opt_bytes"] = 0
        t0 = time.perf_counter()
        for k in ("m", "v"):
            full = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device=dev)
                            .normal_(generator=g), meta[k])
            check(all(t.dtype == torch.float32 for t in tree_leaves(full)),
                  "phase 17b: the AdamW moments are not float32")
            mspecs = param_specs(full, mesh, fsdp_axes=dp_axes(mesh))
            res["opt_bytes"] += hold(full, shard_tree(full, mspecs, mesh), mspecs, k)
            del full
        res["s"]["moments"] = time.perf_counter() - t0
        out.put(res)
    finally:
        dist.destroy_process_group()


def phase_sharding(card: str, device: str = "cuda:0") -> dict:
    """Phase 17 (see the module docstring): 17a's process and 17b's ranks
    run side by side. Returns the numbers it printed."""
    t_start = time.perf_counter()
    gc.collect()
    if device.startswith("cuda"):
        import torch
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        results = run_spawned(
            [(rules_child, (device.split(":")[0],))]
            + [(shard_rank, (r, str(Path(tmp) / "rendezvous"), device))
               for r in range(SHARD_RANKS)], 300, "phase 17")
    (rules,) = [r for r in results if "cells" in r]
    ranks = sorted((r for r in results if "rank" in r), key=lambda r: r["rank"])
    for c in rules["cells"]:
        held = " + ".join(f"{k} {v}" for k, v in c["bytes"].items() if k != "batch")
        log(f"phase 17a {c['world']} {c['arch']} {c['shape']}: {c['leaves']} leaves; "
            f"{held} = {sum(v for k, v in c['bytes'].items() if k != 'batch')} B a rank "
            f"(batch {c['bytes']['batch']}); model_flops {c['flops']:.4e}; {c['s']:.3f} s")
    log(f"phase 17a: {len(rules['cells'])} cells at 256 and 512 ranks (B a rank: the "
        f"argument bytes a rank holds, counted from the local shapes; not a measured memory "
        f"size), every spec dividing, every leaf of >= 2^24 elements sharded, nothing "
        f"allocated; {rules['s']:.1f} s in its process")
    check(len({(r["param_bytes"], r["opt_bytes"]) for r in ranks}) == 1,
          f"phase 17b: ranks hold unequal bytes "
          f"{[(r['param_bytes'], r['opt_bytes']) for r in ranks]}")
    for r in ranks:
        log(f"phase 17b rank {r['rank']} {r['coord']}: {LM_ARCH} bf16 parameters "
            f"{r['param_bytes']} of {r['full_bytes']} bytes, float32 AdamW moments "
            f"{r['opt_bytes']} bytes, every shard bit-equal to its slice; embed "
            f"{r['embed_spec']} local {r['embed_local']}; seconds "
            + ", ".join(f"{k}={v:.2f}" for k, v in r["s"].items()))
    total = time.perf_counter() - t_start
    log(f"phase 17b ({SHARD_RANKS} gloo ranks sharing {device}, a {SHARD_MESH} mesh; {card}); "
        f"phase 17 (17a's process beside 17b's ranks) {total:.1f} s")
    return {"cells": rules["cells"], "ranks": ranks, "seconds": total}


# ---------------------------------------------------------------------------
# phase 18: the LM steps on a mesh
# ---------------------------------------------------------------------------


def mesh_rank(rank: int, rdv: str, device: str, out) -> None:
    """One rank of phase 18: ``MESH_RANKS`` ranks sharing ``device`` on a
    ``MESH_SHAPE`` ``("data", "model")`` mesh, the group on the ``staged``
    backend (every collective through gloo on host copies: gloo's own CUDA
    path dies under DTensor's collectives, PERF.md section 7). (a) every
    reduced config in float32: gradients, train steps and a prefill with
    greedy decode steps on the mesh against the same with no mesh on the
    card; (b) ``LM_ARCH`` at its full width: float32 gradients and one train
    step on the mesh against no mesh's (each rank runs no mesh's in turn and
    holds its shards to their slices), then bf16 train steps (``remat``,
    FSDP) and bf16 serving, timed. A failed check
    exits non-zero."""
    import datetime

    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.configs import ARCH_IDS, get_config, get_reduced
    from repro_torch.data import SyntheticLM
    from repro_torch.distributed import make_mesh, staged
    from repro_torch.distributed.meshutil import set_mesh
    from repro_torch.distributed.sharding import (
        SSM_WEIGHT_NAMES, batch_specs, param_specs, shard_tree,
    )
    from repro_torch.models import init_cache, init_params
    from repro_torch.models.model import tree_leaves, tree_map
    from repro_torch.serve.engine import make_decode_step, make_prefill_step
    from repro_torch.train import adamw_init, make_train_step
    from repro_torch.train.step import value_and_grad

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(1)  # four ranks on the host's cores: DTensor's dispatch is serial
    staged.register()
    dist.init_process_group(staged.BACKEND, init_method=f"file://{rdv}", rank=rank,
                            world_size=MESH_RANKS, timeout=datetime.timedelta(seconds=600))
    dev = torch.device(device)
    torch.cuda.set_device(dev.index or 0)  # every rank on this one card
    res = {"rank": rank, "s": {}, "a": {}}

    def whole(t):
        return t.full_tensor() if isinstance(t, DTensor) else t

    def rel(a, b) -> float:
        a, b = float(whole(a)), float(whole(b))
        return abs(a - b) / max(abs(b), 1e-30)

    def sync():
        torch.cuda.synchronize()
        dist.barrier()

    def placed_opt(params, dtype=torch.float32):
        """AdamW state shaped as placed ``params``: each rank's zeros alone."""
        zeros = lambda t: torch.zeros_like(t, dtype=dtype)  # noqa: E731
        step = DTensor.from_local(torch.zeros((), dtype=torch.int32, device=dev), mesh,
                                  [Replicate()] * mesh.ndim, run_check=False)
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params), "step": step}

    def own(tree):
        """Each DTensor's local shard copied out of the whole tensor it was
        sliced from, so the whole draw can be freed."""
        return tree_map(lambda t: DTensor.from_local(t.to_local().clone(), mesh, t.placements,
                                                     run_check=False), tree)

    try:
        mesh = make_mesh(MESH_SHAPE, ("data", "model"), dev.type)
        f32 = dict(dtype="float32", param_dtype="float32")
        # (a) every reduced config, mesh against no mesh, both on the card
        B, S, n_steps, prompt_len, n_dec = MESH_REDUCED
        for arch in ARCH_IDS:
            t0 = time.perf_counter()
            cfg = dataclasses.replace(get_reduced(arch), **f32)
            params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
            opt = adamw_init(params)
            data = SyntheticLM(cfg, B, S)
            # the first batch's gradients, leaf by leaf: the mesh's (its
            # parameters and batch placed by the rules) against no mesh's
            b0 = {k: torch.as_tensor(v).to(dev) for k, v in data.batch(0).items()}
            _, g0 = value_and_grad(cfg, params, b0)
            no_tp = SSM_WEIGHT_NAMES if not cfg.ssm_tp else frozenset()
            with set_mesh(mesh):
                _, g1 = value_and_grad(
                    cfg, shard_tree(params, param_specs(params, mesh, no_tp_names=no_tp), mesh),
                    shard_tree(b0, batch_specs(b0, mesh, dp_axes=("data",)), mesh))
            g_err = tree_rel(tree_map(whole, g1), g0)
            check(g_err <= TOL_MESH, f"phase 18a rank {rank} {arch}: gradients on the mesh "
                                     f"differ by {g_err:.3e} of the largest")
            del g0, g1
            # no warm-up: the first step's learning rate is the peak
            one = make_train_step(cfg, dev, warmup=0)
            on_mesh = make_train_step(cfg, mesh=mesh, warmup=0, example_params=params,
                                      example_opt=opt, example_batch=data.batch(0))
            p0, o0 = tree_map(lambda t: t.clone(), params), tree_map(lambda t: t.clone(), opt)
            p1, o1 = tree_map(lambda t: t.clone(), params), tree_map(lambda t: t.clone(), opt)
            errs = []
            for i in range(n_steps):
                p0, o0, m0 = one(p0, o0, data.batch(i), i)
                p1, o1, m1 = on_mesh(p1, o1, data.batch(i), i)
                errs.append(max(rel(m1["loss"], m0["loss"]), rel(m1["gnorm"], m0["gnorm"])))
            check(max(errs) <= TOL_MESH,
                  f"phase 18a rank {rank} {arch}: loss/gnorm on the mesh differ by {errs}")
            p_err = tree_rel(tree_map(whole, p1), p0)
            del p0, o0, p1, o1
            tokens_equal = None
            if cfg.input_kind == "tokens" and not cfg.enc_layers:
                prompts = torch.as_tensor(data.batch(0)["tokens"][:, :prompt_len]).to(dev)
                toks = []
                for m in (None, mesh):
                    cache = init_cache(cfg, B, prompt_len + n_dec, device=dev)
                    kw = {} if m is None else dict(mesh=m, example_params=params,
                                                   example_cache=cache,
                                                   example_batch={"tokens": prompts})
                    prefill, decode = (make_prefill_step(cfg, dev, **kw),
                                       make_decode_step(cfg, dev, **kw))
                    logits, cache = prefill(params, {"tokens": prompts}, cache)
                    tok = torch.argmax(whole(logits)[:, -1, :cfg.vocab], -1).to(torch.int32)
                    seq = [tok]
                    for i in range(n_dec):
                        tok, cache = decode(params, {"tokens": whole(tok)[:, None]}, cache,
                                            prompt_len + i)
                        seq.append(whole(tok))
                    toks.append(torch.stack(seq, 1))
                tokens_equal = bool(torch.equal(toks[0], toks[1]))
                check(tokens_equal, f"phase 18a rank {rank} {arch}: tokens on the mesh differ")
            res["a"][arch] = {"err": max(errs), "grads": g_err, "params": p_err,
                              "tokens_equal": tokens_equal, "s": time.perf_counter() - t0}
        res["s"]["a"] = sum(v["s"] for v in res["a"].values())
        gc.collect()
        torch.cuda.empty_cache()

        # (b) LM_ARCH at full width. The float32 gate: each rank in turn
        # runs no mesh's gradients and step (no warm-up: the peak learning
        # rate) on the card and keeps its own slices of them on the host;
        # then the mesh's gradients and step
        t0 = time.perf_counter()
        cfg = dataclasses.replace(get_config(LM_ARCH), **f32)
        gB, gS = MESH_GATE
        batch = SyntheticLM(cfg, gB, gS).batch(0)
        b_dev = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
        coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))

        def mine(tree, specs):
            return [t[spec_slice(t.shape, spec, sizes, coord)].cpu()
                    for _, t, spec in with_specs(tree, specs)]

        def top(tree):
            return max(t.abs().max().item() for t in tree_leaves(tree))

        ref = {}
        for turn in range(MESH_RANKS):
            if turn == rank:
                full = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
                specs = param_specs(full, mesh)
                ref["loss"], grads = value_and_grad(cfg, full, b_dev)
                ref["grads"], ref["gtop"] = mine(grads, specs), top(grads)
                del grads
                full, opt, m0 = make_train_step(cfg, dev, warmup=0)(full, adamw_init(full),
                                                                    batch, 0)
                ref.update(params=mine(full, specs), top=top(full), gnorm=float(m0["gnorm"]))
                del full, opt, m0
                torch.cuda.empty_cache()
            dist.barrier()
        full = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
        specs = param_specs(full, mesh)
        params = own(shard_tree(full, specs, mesh))
        del full
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        with set_mesh(mesh):
            loss, grads = value_and_grad(cfg, params, shard_tree(
                b_dev, batch_specs(b_dev, mesh, dp_axes=("data",)), mesh))
        sync()
        grad_s = time.perf_counter() - t
        errs = {"grad_loss": rel(loss, ref["loss"]),
                "grads": max((g.to_local().cpu() - w).abs().max().item()
                             for (_, g, _), w in zip(with_specs(grads, specs), ref["grads"]))
                / ref["gtop"]}
        del loss, grads
        gc.collect()
        torch.cuda.empty_cache()  # four processes share the card: hand the cache back
        sync()
        step = make_train_step(cfg, mesh=mesh, warmup=0, example_params=params,
                               example_opt=placed_opt(params), example_batch=batch)
        t = time.perf_counter()
        params, opt, m1 = step(params, placed_opt(params), batch, 0)
        sync()
        step_s = time.perf_counter() - t
        errs.update(loss=rel(m1["loss"], ref["loss"]), gnorm=rel(m1["gnorm"], ref["gnorm"]))
        check(max(errs.values()) <= TOL_MESH,
              f"phase 18b rank {rank}: the float32 mesh gradients or step differ from no "
              f"mesh: {errs}")
        # parameters after the peak-lr step: reported, not gated (AdamW's first
        # step divides each gradient entry by its own size plus eps, so entries
        # near eps turn rounding into changes of up to 2 lr)
        p_err = max((p.to_local().cpu() - w).abs().max().item()
                    for (_, p, _), w in zip(with_specs(params, specs), ref["params"])) / ref["top"]
        res["gate"] = {**errs, "params": p_err, "grad_s": grad_s, "s": step_s,
                       "peak": torch.cuda.max_memory_allocated()}
        del params, opt, step, ref, b_dev
        torch.cuda.empty_cache()
        res["s"]["b gate"] = time.perf_counter() - t0

        # bf16 train steps: remat, FSDP over the data axis
        t0 = time.perf_counter()
        cfg = get_config(LM_ARCH)
        tB, tS, warm, timed = MESH_TRAIN_BF16
        data = SyntheticLM(cfg, tB, tS)
        full = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
        specs = param_specs(full, mesh, fsdp_axes=("data",))
        params = own(shard_tree(full, specs, mesh))
        del full
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        opt = placed_opt(params)
        step = make_train_step(cfg, mesh=mesh, fsdp=True, example_params=params,
                               example_opt=opt, example_batch=data.batch(0))
        times, losses = [], []
        for i in range(warm + timed):
            sync()
            t = time.perf_counter()
            params, opt, m = step(params, opt, data.batch(i), i)
            losses.append(float(m["loss"].to_local()))
            sync()
            times.append(time.perf_counter() - t)
        check(all(math.isfinite(x) for x in losses), f"phase 18b rank {rank}: losses {losses}")
        res["train"] = {"ms": 1e3 * max(times[warm:]), "times": times,
                        "losses": losses, "peak": torch.cuda.max_memory_allocated() - base,
                        "held": base}
        del params, opt, step
        torch.cuda.empty_cache()
        res["s"]["b bf16 train"] = time.perf_counter() - t0

        # bf16 serving: prefill LM_PROMPT tokens, then greedy decode steps
        t0 = time.perf_counter()
        sB, new = MESH_SERVE_BF16
        gen = torch.Generator(device=dev).manual_seed(SEED)
        full = init_params(cfg, gen, device=dev)
        prompt = torch.randint(0, cfg.vocab, (sB, LM_PROMPT), generator=gen, device=dev)
        cache = init_cache(cfg, sB, LM_PROMPT + new, device=dev)
        prefill = make_prefill_step(cfg, mesh=mesh, example_params=full, example_cache=cache,
                                    example_batch={"tokens": prompt})
        decode = make_decode_step(cfg, mesh=mesh, example_params=full, example_cache=cache,
                                  example_batch={"tokens": prompt[:, :1]})
        params = own(shard_tree(full, param_specs(full, mesh), mesh))
        del full, cache
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()

        def serve(n_new):
            cache = init_cache(cfg, sB, LM_PROMPT + new, device=dev)
            sync()
            t = time.perf_counter()
            logits, cache = prefill(params, {"tokens": prompt}, cache)
            sync()
            t_pre = time.perf_counter() - t
            toks = [torch.argmax(whole(logits)[:, -1, :cfg.vocab], -1).to(torch.int32)]
            t = time.perf_counter()
            for i in range(n_new - 1):
                tok, cache = decode(params, {"tokens": toks[-1][:, None]}, cache,
                                    LM_PROMPT + i)
                toks.append(whole(tok))
            sync()
            return t_pre, time.perf_counter() - t, toks

        serve(3)  # warm-up, as phase 15b: DTensor's sharding caches, allocator
        torch.cuda.reset_peak_memory_stats()
        t_pre, t_dec, toks = serve(new)
        toks = torch.stack(toks, 1)
        check(toks.shape == (sB, new) and int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab,
              f"phase 18b rank {rank}: tokens out of range")
        res["serve"] = {"prefill_ms": 1e3 * t_pre, "decode_ms": 1e3 * t_dec / (new - 1),
                        "peak": torch.cuda.max_memory_allocated() - base, "held": base}
        res["s"]["b bf16 serve"] = time.perf_counter() - t0
        out.put(res)
    finally:
        dist.destroy_process_group()


def phase_mesh(card: str, lm: dict, train: dict, device: str = "cuda:0") -> dict:
    """Phase 18 (see the module docstring): ``MESH_RANKS`` ranks sharing the
    card on a mesh; ``lm`` and ``train`` are phases 15 and 16's numbers from
    this run, printed beside. Returns the numbers it printed."""
    import torch

    t_start = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        ranks = sorted(run_spawned(
            [(mesh_rank, (r, str(Path(tmp) / "rendezvous"), device))
             for r in range(MESH_RANKS)], 600, "phase 18"), key=lambda r: r["rank"])
    r0 = ranks[0]
    for arch, a in r0["a"].items():
        worst = {k: max(r["a"][arch][k] for r in ranks) for k in ("err", "grads", "params")}
        log(f"phase 18a {arch} float32 on a {MESH_SHAPE} mesh of {MESH_RANKS} ranks sharing "
            f"the card: the first batch's gradients within {worst['grads']:.2e} of the largest "
            f"(leaf by leaf); {MESH_REDUCED[2]} train steps at the peak lr (no warm-up), loss "
            f"and gnorm within rel {worst['err']:.2e} of the same steps with no mesh, "
            f"parameters after them {worst['params']:.2e} of the largest (not gated); prefill "
            f"+ {MESH_REDUCED[4]} greedy decode steps tokens equal {a['tokens_equal']}; "
            f"{a['s']:.1f} s")
    gate = {k: max(r["gate"][k] for r in ranks)
            for k in ("grad_loss", "grads", "loss", "gnorm", "params")}
    log(f"phase 18b {LM_ARCH} float32, batch {MESH_GATE[0]}, S={MESH_GATE[1]}, on the mesh "
        f"against no mesh on the card: gradients {gate['grads']:.2e} of the largest (every "
        f"rank's shards against their slices), loss rel {gate['grad_loss']:.2e}; one train "
        f"step at the peak lr: loss rel {gate['loss']:.2e}, gnorm rel {gate['gnorm']:.2e}, "
        f"parameters after it {gate['params']:.2e} of the largest (not gated); gradients "
        f"{r0['gate']['grad_s']:.2f} s, step {r0['gate']['s']:.2f} s; peak a rank "
        f"{[r['gate']['peak'] for r in ranks]} bytes")
    tB, tS, warm, timed = MESH_TRAIN_BF16
    ms = [r["train"]["ms"] for r in ranks]
    log(f"phase 18b {LM_ARCH} bf16 train step on the mesh (remat, FSDP over data), batch {tB}, "
        f"S={tS} (card: {card}): {max(ms):.3f} ms a step (the slowest of {timed} timed steps "
        f"after {warm} warm-up, slowest rank; rank 0 "
        f"{[round(1e3 * t, 3) for t in r0['train']['times']]}); "
        f"no mesh (phase 16c, this run) {train['ms_per_step']:.3f} ms; peak a rank above its "
        f"parameters {[r['train']['peak'] for r in ranks]} bytes, sum "
        f"{sum(r['train']['peak'] + r['train']['held'] for r in ranks)} with them; no mesh "
        f"{train['peak_bytes']}; losses {[round(x, 4) for x in r0['train']['losses']]}")
    sB, new = MESH_SERVE_BF16
    pre, dec = max(r["serve"]["prefill_ms"] for r in ranks), max(r["serve"]["decode_ms"]
                                                                 for r in ranks)
    log(f"phase 18b {LM_ARCH} bf16 serving on the mesh, batch {sB}, {LM_PROMPT}-token prompt, "
        f"{new} new tokens (card: {card}), after one warm-up pass of a prefill and 2 decode "
        f"steps: prefill {pre:.3f} ms, decode {dec:.4f} ms a step (slowest rank); no mesh (phase 15b, this run) prefill {lm['prefill_ms']:.3f} ms, "
        f"decode {lm['decode_ms']:.4f} ms; peak a rank {[r['serve']['peak'] for r in ranks]} "
        f"bytes, sum {sum(r['serve']['peak'] + r['serve']['held'] for r in ranks)} with the "
        f"parameters; no mesh {lm['peak_bytes']}")
    total = time.perf_counter() - t_start
    log(f"phase 18 seconds (rank 0): " + ", ".join(f"{k}={v:.1f}" for k, v in r0["s"].items())
        + f"; total {total:.1f}")
    return {"ranks": ranks, "seconds": total}


def main() -> None:
    if len(sys.argv) > 1:
        fail(f"chip_smoke.py takes no arguments, got {sys.argv[1:]}")

    import numpy as np
    import scipy.sparse.linalg as spla
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA device")
    try:
        from repro_torch.api import PlanOptions, SpTRSVContext
        from repro_torch.core.blocking import pad_rhs
        from repro_torch.core import costmodel
        from repro_torch.core.costmodel import calibrate_weights
        from repro_torch.core.partition import cut_stats
        from repro_torch.core.solver import (
            DEFAULT_STREAM_LIMIT, SolverConfig, build_plan, dispatch_stats, fused_streaming,
            refresh_plan, stream_dma_bytes_per_solve, stream_limit,
        )
        from repro_torch.obs import calibration as ocal
        from repro_torch.obs import metrics as omet
        from repro_torch.obs import trace as otr
        from repro_torch.kernels import extension, ref, superstep
        from repro_torch.kernels import ops as kops
        from repro_torch.krylov import (
            matvec_lower, solve_ic0_pcg, solve_ilu0_bicgstab, spd_lower_from_triangular,
            symmetric_full_csr,
        )
        from repro_torch.launch.serve_solve import dyadic
        from repro_torch.sparse import suite
        from repro_torch.sparse.matrix import CSR, reference_solve, to_scipy
        sys.path.insert(0, str(ROOT / "perf"))
        import bulk_copy
        import chain_latency
        import stream_crossover
    except ImportError as e:
        fail(f"the repro_torch package is not next to chip_smoke.py ({e})")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full float32
    torch.backends.cudnn.allow_tf32 = False

    kind = torch.cuda.get_device_name(0)
    card = card_line()
    log(f"device {kind}; nvidia-smi: {card}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    phase_start = {}  # each phase's start on the host clock, for its seconds

    # 1. build (the chain-latency microbenchmark alongside the kernels)
    phase_start["1 build"] = time.perf_counter()
    t0 = time.perf_counter()
    chain_build, copy_build = chain_latency.start_build(), bulk_copy.start_build()
    libs = extension.build()
    chain_lib, copy_lib = chain_latency.load(chain_build), bulk_copy.load(copy_build)
    log(f"phase 1 build: {time.perf_counter() - t0:.1f} s "
        f"({', '.join(p.name for p in libs.values())}, {chain_latency.LIBRARY.name}, "
        f"{bulk_copy.LIBRARY.name})")

    # 2. kernels against their plain versions
    phase_start["2 kernels"] = time.perf_counter()
    t0 = time.perf_counter()
    err = phase_kernels(kops, ref, torch, SEED)
    log(f"phase 2 kernels vs plain: ok in {time.perf_counter() - t0:.1f} s, max abs err "
        + ", ".join(f"{k}={v:.2e}" for k, v in err.items()))

    # 3. main path at full size
    phase_start["3 switch"] = time.perf_counter()
    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    a = suite.grid2d_factor(SIDE, seed=6)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ctx = SpTRSVContext()
    h = ctx.analyse(a)
    plan, tplan = ctx.plan(h), ctx.plan(h, transpose=True)
    ctx.executor(h), ctx.executor(h, transpose=True)  # uploads both plans
    torch.cuda.synchronize()
    analysis_s = time.perf_counter() - t0
    store_mb = (plan.diag.nbytes + plan.tiles.nbytes) / 1e6
    log(f"phase 3 problem: n={a.n} nnz={a.nnz} B={plan.bs.B} levels={plan.n_levels} "
        f"tiles={plan.bs.n_tiles} diag+tiles={store_mb:.0f} MB; generate {gen_s:.1f} s, "
        f"analyse+plan+upload (forward and transpose) {analysis_s:.1f} s")
    b = rng.uniform(-1, 1, a.n)
    panel = rng.uniform(-1, 1, (a.n, 8))
    kops.reset_launch_counts()
    x = ctx.solve(h, b)
    xt = ctx.solve(h, b, transpose=True)
    xp = ctx.solve(h, panel)
    launches = kops.launch_counts()

    def with_work(p, col):
        return int((widths(p, col) > 0).sum())

    expect = {**dict.fromkeys(launches, 0),
              "block_trsv": with_work(plan, 0) + with_work(tplan, 0),
              "block_gemv": with_work(plan, 1) + with_work(tplan, 1),
              "block_trsm": with_work(plan, 0), "block_gemm": with_work(plan, 1)}
    check(launches == expect, f"main-path launches {launches} != one per level with work "
                              f"{expect}")
    log(f"phase 3 launches (forward + transpose + panel): {json.dumps(launches)}")
    want = {"forward": reference_solve(a, b),
            "transpose": spla.spsolve_triangular(to_scipy(a).T.tocsr(), b, lower=False),
            "panel_r8": reference_solve(a, panel)}
    errs = {"forward": rel_err(x, want["forward"]), "transpose": rel_err(xt, want["transpose"]),
            "panel_r8": rel_err(xp, want["panel_r8"])}
    for form, e in errs.items():
        check(np.isfinite(e) and e <= TOL_SOLVE, f"{form} solve rel err {e:.3e} > {TOL_SOLVE}")
    timing = solve_times(ctx, h, b, panel)
    log("phase 3 rel err vs scipy: " + ", ".join(f"{k}={v:.2e}" for k, v in errs.items()))
    log("phase 3 ms/solve (median of 5; min, max): " + ", ".join(
        f"{k}={v[2]:.2f} ({v[0]:.2f}, {v[-1]:.2f})" for k, v in timing.items()))

    # the switch executor with grouped GEMVs (gemv_group = 8): one grouped
    # launch per level with tile updates, in place of the GEMV
    gctx = SpTRSVContext(options=PlanOptions(gemv_group=8))
    gh = gctx.analyse(a)
    gctx.executor(gh)
    kops.reset_launch_counts()
    xg = gctx.solve(gh, b)
    grouped_launches = kops.launch_counts()
    expect_g = {**dict.fromkeys(grouped_launches, 0), "block_trsv": with_work(plan, 0),
                "block_gemv_grouped": with_work(plan, 1)}
    check(grouped_launches == expect_g,
          f"gemv_group=8 launches {grouped_launches} != one per level with work {expect_g}")
    eg = rel_err(xg, want["forward"])
    check(np.isfinite(eg) and eg <= TOL_SOLVE, f"gemv_group=8 solve rel err {eg:.3e}")
    # the panel TRSV's entry point, ops.batched_block_trsv(algorithm="panel"),
    # on every level's diagonal tiles of the factor
    diag_dev = torch.from_numpy(plan.diag).cuda()
    sr_all = plan.solve_rows[0]
    level_rows = [sr_all[o:o + w] for o, w in zip(plan.lvl_off[:, 0], widths(plan, 0)) if w]
    batches = [torch.from_numpy(np.where(sr < 0, plan.bs.nb, sr).astype(np.int64)).cuda()
               for sr in level_rows]
    rhs_lv = [torch.rand(len(i), plan.bs.B, device="cuda") * 2 - 1 for i in batches]
    kops.reset_launch_counts()
    xs_panel = [kops.batched_block_trsv(diag_dev[i], r, algorithm="panel")
                for i, r in zip(batches, rhs_lv)]
    panel_launches = kops.launch_counts()
    check(panel_launches == {**dict.fromkeys(panel_launches, 0),
                             "block_trsv_panel": len(batches)},
          f"panel TRSV path launches {panel_launches} for {len(batches)} levels")
    e_panel = max(float((xp_ - ref.block_trsv_panel_ref(diag_dev[i], r)).abs().max())
                  for xp_, i, r in zip(xs_panel, batches, rhs_lv))
    check(e_panel <= TOL_KERNEL, f"panel TRSV path vs plain: max abs err {e_panel:.3e}")
    err["block_trsv_panel"] = max(err["block_trsv_panel"], e_panel)
    log(f"phase 3 gemv_group=8 forward solve rel err {eg:.2e}, launches "
        f"{json.dumps(grouped_launches)}; panel TRSV path (one call per level) launches "
        f"{json.dumps(panel_launches)}, max abs err vs plain {e_panel:.2e}")

    # 4. IC(0)-PCG
    phase_start["4 pcg"] = time.perf_counter()
    a_spd = spd_lower_from_triangular(suite.grid2d_factor(PCG_SIDE, seed=6))
    b_spd = rng.uniform(-1, 1, a_spd.n)
    tol = 1e-6
    kops.reset_launch_counts()
    t0 = time.perf_counter()
    res = solve_ic0_pcg(a_spd, b_spd, tol=tol, maxiter=400)
    pcg_s = time.perf_counter() - t0
    pcg_launches = kops.launch_counts()
    check(res.converged, f"IC(0)-PCG did not converge in {res.n_iters} iterations")
    true_res = float(np.linalg.norm(b_spd - matvec_lower(a_spd, res.x)) / np.linalg.norm(b_spd))
    check(true_res <= 10 * tol, f"PCG true residual {true_res:.3e} > {10 * tol}")
    nf, nbk = res.info["forward"].n_solves, res.info["backward"].n_solves
    check(nf == nbk == res.n_iters, f"PCG sweeps {nf}/{nbk} != iterations {res.n_iters}")
    check(pcg_launches["block_trsv"] > 0 and pcg_launches["block_gemv"] > 0,
          f"PCG did not run the kernels: {pcg_launches}")
    log(f"phase 4 IC(0)-PCG n={a_spd.n}: {res.n_iters} iterations, {pcg_s:.1f} s "
        f"(analysis + ic0 + iterations), true rel residual {true_res:.2e}, "
        f"launches {json.dumps(pcg_launches)}")

    # 5. the superstep megakernel: each solve is one launch
    phase_start["5 megakernel"] = time.perf_counter()
    # plain "fused" streams above the stream limit (0 on this card, phase 9):
    # this phase holds the resident kernel, the limit above the plan's store
    resident_env = stream_crossover.stream_limit_env(2 * (plan.diag.nbytes + plan.tiles.nbytes))
    resident_env.__enter__()
    t0 = time.perf_counter()
    fctx = SpTRSVContext(options=PlanOptions(kernel="fused"))
    fh = fctx.analyse(a)
    fctx.executor(fh), fctx.executor(fh, transpose=True)  # plans, tables, upload
    torch.cuda.synchronize()
    check(not fctx.dispatch_stats(fh)["streamed"] and fctx.executor(fh)._fused.layout is None,
          "phase 5: plain fused did not stay resident under the raised stream limit")
    log(f"phase 5 fused analyse+plan+tables+upload (forward and transpose) "
        f"{time.perf_counter() - t0:.1f} s")
    one_launch = {**dict.fromkeys(kops.KERNELS, 0), "superstep": 1}
    kops.reset_launch_counts()
    fx = {}
    for form, fn in (("forward", lambda: fctx.solve(fh, b)),
                     ("transpose", lambda: fctx.solve(fh, b, transpose=True)),
                     ("panel_r8", lambda: fctx.solve(fh, panel))):
        before = kops.launch_counts()
        fx[form] = fn()
        after = kops.launch_counts()
        made = {k: after[k] - before[k] for k in after}
        check(made == one_launch, f"fused {form} solve launched {made}, not {one_launch}")
    fused_launches = kops.launch_counts()
    ferrs = {form: rel_err(fx[form], want[form]) for form in fx}
    for form, e in ferrs.items():
        check(np.isfinite(e) and e <= TOL_SOLVE, f"fused {form} rel err {e:.3e} > {TOL_SOLVE}")
    check(np.array_equal(fctx.solve(fh, b), fx["forward"]),
          "two fused forward solves of the same b differ")
    ftiming = solve_times(fctx, fh, b, panel)
    log("phase 5 fused rel err vs scipy: " + ", ".join(f"{k}={v:.2e}" for k, v in ferrs.items())
        + "; two forward solves bit-equal")
    log("phase 5 fused ms/solve (median of 5; min, max), beside phase 3's median: " + ", ".join(
        f"{k}={v[2]:.2f} ({v[0]:.2f}, {v[-1]:.2f}) vs {timing[k][2]:.2f}"
        for k, v in ftiming.items()))

    # the megakernel against its plain version: bit-identical on a dyadic
    # problem, within TOL_SOLVE on real values
    def pad_b(p, rhs):
        blocks = pad_rhs(np.asarray(rhs, np.float32), p.bs)
        return np.concatenate([blocks, np.zeros((1,) + blocks.shape[1:], np.float32)])

    dy = dyadic(suite.random_levelled(400, 8, 4.0, seed=6))
    dplan = build_plan(dy, 1, SolverConfig(block_size=16, kernel_backend="fused"))
    for R in (1, 3):
        rhs = rng.integers(-4, 5, dy.n if R == 1 else (dy.n, R)).astype(np.float32)
        tables, vecs, stp = fused_inputs(torch, dplan, pad_b(dplan, rhs))
        got = superstep.superstep_call(*tables, *vecs, stp=stp,
                                       flags=superstep.ReadyFlags(dplan.bs.nb + 1, "cuda"))
        plain_out = ref.superstep_ref(*tables, *vecs, stp=stp)
        check(all(torch.equal(g, w) for g, w in zip(got, plain_out)),
              f"megakernel != its plain version on the dyadic problem, R={R}")

    def against_plain(p, rhs):
        """Max abs and relative error of x, kernel vs plain, and the inputs."""
        tables, vecs, stp = fused_inputs(torch, p, pad_b(p, rhs))
        table = superstep.superstep_table(
            *[t.cpu().numpy() for t in tables], n_rows=p.bs.nb + 1,
            stp=stp.cpu().numpy()).to("cuda")
        got = superstep.superstep_call(*tables, *vecs, stp=stp, table=table,
                                       flags=superstep.ReadyFlags(p.bs.nb + 1, "cuda"))[1]
        plain_x = ref.superstep_ref(*tables, *vecs, stp=stp)[1]
        torch.cuda.synchronize()
        e = float((got - plain_x).abs().max())
        return e, e / float(plain_x.abs().max()), (tables, vecs, stp, table)

    a256 = suite.grid2d_factor(256, seed=6)
    p256 = build_plan(a256, 1, SolverConfig(kernel_backend="fused"))
    e256, r256, _ = against_plain(p256, rng.uniform(-1, 1, a256.n))
    check(r256 <= TOL_SOLVE, f"megakernel vs plain at side 256: rel err {r256:.3e}")
    fplan = fctx.plan(fh)
    e_full, r_full, (ftab, fvec, fstp, ftable) = against_plain(fplan, b)
    check(r_full <= TOL_SOLVE, f"megakernel vs plain at full size: rel err {r_full:.3e}")
    log(f"phase 5 megakernel vs plain: dyadic bit-identical (R = 1, 3); side 256 max abs "
        f"{e256:.2e} (rel {r256:.2e}); full size max abs {e_full:.2e} (rel {r_full:.2e})")

    # fused IC(0)-PCG: two megakernel solves per iteration, SpMV on the GEMV kernel
    kops.reset_launch_counts()
    t0 = time.perf_counter()
    fres = solve_ic0_pcg(a_spd, b_spd, tol=tol, maxiter=400, config=PlanOptions(kernel="fused"))
    fpcg_s = time.perf_counter() - t0
    fpcg_launches = kops.launch_counts()
    check(fres.converged and fres.n_iters == res.n_iters,
          f"fused IC(0)-PCG: converged={fres.converged} in {fres.n_iters} iterations, "
          f"phase 4 took {res.n_iters}")
    ftrue = float(np.linalg.norm(b_spd - matvec_lower(a_spd, fres.x)) / np.linalg.norm(b_spd))
    check(ftrue <= 10 * tol, f"fused PCG true residual {ftrue:.3e} > {10 * tol}")
    check(fpcg_launches["superstep"] == 2 * fres.n_iters and fpcg_launches["block_trsv"] == 0
          and fpcg_launches["block_gemv"] > 0,
          f"fused PCG launches {fpcg_launches} for {fres.n_iters} iterations")
    log(f"phase 5 fused IC(0)-PCG: {fres.n_iters} iterations, {fpcg_s:.1f} s, true rel "
        f"residual {ftrue:.2e} (phase 4: {true_res:.2e}), launches {json.dumps(fpcg_launches)}")
    resident_env.__exit__(None, None, None)

    # the megakernel's own times at full size, beside its plain version and
    # cuSPARSE; one ReadyFlags kept across the timed launches, as a Solver does
    ready = superstep.ReadyFlags(fplan.bs.nb + 1, "cuda")
    fms = time_ms(lambda: superstep.superstep_call(*ftab, *fvec, stp=fstp, table=ftable,
                                                   flags=ready), 20)
    b8 = torch.from_numpy(pad_b(fplan, panel)).cuda()
    z8 = torch.zeros_like(b8)
    fms8 = time_ms(lambda: superstep.superstep_call(*ftab, *fvec[:2], b8, z8, z8, stp=fstp,
                                                    table=ftable, flags=ready), 10)
    fplain_ms = time_ms(lambda: ref.superstep_ref(*ftab, *fvec, stp=fstp), 3, warmup=1)
    library_ms, library_device_ms, lib_note = cusparse_ms(a, b, want["forward"])
    log(f"phase 5 megakernel {fms:.3f} ms/solve (CUDA events, 20 solves; (n, 8) panel "
        f"{fms8:.3f} ms, 10 solves), plain version "
        f"{fplain_ms:.1f} ms, torch.triangular_solve(CSR L) "
        f"{'n/a' if library_ms is None else f'{library_ms:.3f} ms'} (device "
        f"{library_device_ms} ms; {lib_note})")
    fbound = superstep_bound(fplan, ftable, 1)
    superstep_row = {
        "name": "superstep", "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{KERNELS['superstep'][1]}",
        "replaces": KERNELS["superstep"][0], "launches": fused_launches["superstep"],
        "max_abs_err": e_full, "ms": fms, "plain_ms": fplain_ms,
        "bound_ms": fbound[0], "bound_by": fbound[1], "library_ms": library_ms,
        "library_device_ms": library_device_ms,
        "device_ms": device_ms(lambda: superstep.superstep_call(
            *ftab, *fvec, stp=fstp, table=ftable, flags=ready), MEGAKERNEL_SYMBOL[False, False],
            10),
        "shape": [a.n, fplan.bs.B, 1],
    }

    # 6. the streamed megakernel (kernel="fused_streamed") on the same factor
    phase_start["6 streamed"] = time.perf_counter()
    t0 = time.perf_counter()
    sctx = SpTRSVContext(options=PlanOptions(kernel="fused_streamed"))
    sh = sctx.analyse(a)
    ssolver = sctx.executor(sh)
    sctx.executor(sh, transpose=True)  # plans, tables, layouts, stores, upload
    torch.cuda.synchronize()
    splan, slayout = ssolver.plan, ssolver._fused.layout
    S = slayout.table.n_solve_slots
    pulls = np.diff(slayout.table.pull_ptr[:S + 1].cpu().numpy())[splan.solve_rows[0] >= 0]
    warps, cap, _ = superstep.streamed_shape(splan.bs.B, slayout.max_item_tiles)
    sstats = sctx.dispatch_stats(sh)
    log(f"phase 6 streamed analyse+plan+layout+store+upload (forward and transpose) "
        f"{time.perf_counter() - t0:.1f} s; incoming tiles per solved row: most "
        f"{int(pulls.max())}, rows by count {np.bincount(pulls).tolist()}; widest work item "
        f"{slayout.max_item_tiles} tiles -> {warps} warps/CTA, 2 stages x {cap} tiles each, "
        f"{sstats['fused_vmem_bytes']} B shared memory/CTA; bulk-copied per solve "
        f"{sstats['stream_dma_bytes']} B (vector), "
        f"{stream_dma_bytes_per_solve(splan, 8)} B ((n, 8) panel); store "
        f"{ssolver._fused.values.numel() * 4} B")
    stream_launch = {**dict.fromkeys(kops.KERNELS, 0), "superstep_streamed": 1}
    kops.reset_launch_counts()
    sx = {}
    for form, fn in (("forward", lambda: sctx.solve(sh, b)),
                     ("transpose", lambda: sctx.solve(sh, b, transpose=True)),
                     ("panel_r8", lambda: sctx.solve(sh, panel))):
        before = kops.launch_counts()
        sx[form] = fn()
        after = kops.launch_counts()
        made = {k: after[k] - before[k] for k in after}
        check(made == stream_launch, f"streamed {form} solve launched {made}")
    streamed_launches = kops.launch_counts()
    serrs = {form: rel_err(sx[form], want[form]) for form in sx}
    for form, e in serrs.items():
        check(np.isfinite(e) and e <= TOL_SOLVE, f"streamed {form} rel err {e:.3e} > {TOL_SOLVE}")
        check(np.array_equal(sx[form], fx[form]),
              f"streamed {form} solve != the resident megakernel's (phase 5) bit for bit")
    check(np.array_equal(sctx.solve(sh, b), sx["forward"]),
          "two streamed forward solves of the same b differ")
    stiming = solve_times(sctx, sh, b, panel)
    log("phase 6 streamed rel err vs scipy: "
        + ", ".join(f"{k}={v:.2e}" for k, v in serrs.items())
        + "; each bit-equal to phase 5's resident result; two forward solves bit-equal")
    log("phase 6 streamed ms/solve (median of 5; min, max), beside phase 5's median: "
        + ", ".join(f"{k}={v[2]:.2f} ({v[0]:.2f}, {v[-1]:.2f}) vs {ftiming[k][2]:.2f}"
                    for k, v in stiming.items()))

    # the streamed kernel against its plain version: bit-identical on a dyadic
    # problem at an even and an odd B, within TOL_SOLVE on real values
    def streamed_against_plain(p, rhs, inputs=None):
        tables, vecs, stp = inputs or fused_inputs(torch, p, pad_b(p, rhs))
        svecs, layout = streamed_from(p, tables, vecs)
        got = superstep.superstep_streamed_call(
            *tables, *svecs, stp=stp, layout=layout,
            flags=superstep.ReadyFlags(p.bs.nb + 1, "cuda"))
        plain_out = ref.superstep_streamed_ref(*tables, svecs[0], layout.diag_entry,
                                               layout.tile_entry, *svecs[1:], stp=stp)
        torch.cuda.synchronize()
        return got, plain_out, (tables, svecs, stp, layout)

    for B_dy in (16, 7):
        splan_dy = build_plan(dy, 1, SolverConfig(block_size=B_dy,
                                                  kernel_backend="fused_streamed"))
        for R in (1, 3):
            rhs = rng.integers(-4, 5, dy.n if R == 1 else (dy.n, R)).astype(np.float32)
            got, plain_out, _ = streamed_against_plain(splan_dy, rhs)
            check(all(torch.equal(g, w) for g, w in zip(got, plain_out)),
                  f"streamed kernel != its plain version on the dyadic problem, B={B_dy}, R={R}")
    got, plain_out, _ = streamed_against_plain(p256, rng.uniform(-1, 1, a256.n))
    se256 = float((got[1] - plain_out[1]).abs().max())
    sr256 = se256 / float(plain_out[1].abs().max())
    check(sr256 <= TOL_SOLVE, f"streamed kernel vs plain at side 256: rel err {sr256:.3e}")
    got, plain_out, (stab, svec, sstp, slay) = streamed_against_plain(
        fplan, b, (ftab, fvec, fstp))
    se_full = float((got[1] - plain_out[1]).abs().max())
    sr_full = se_full / float(plain_out[1].abs().max())
    check(sr_full <= TOL_SOLVE, f"streamed kernel vs plain at full size: rel err {sr_full:.3e}")
    del got, plain_out
    log(f"phase 6 streamed kernel vs plain: dyadic bit-identical (B = 16 and 7; R = 1, 3); "
        f"side 256 max abs {se256:.2e} (rel {sr256:.2e}); full size max abs {se_full:.2e} "
        f"(rel {sr_full:.2e})")

    # a refresh re-arms the streamed store: new values solve with the new values
    a2 = CSR(n=a.n, row_ptr=a.row_ptr, col_idx=a.col_idx,
             val=(a.val * (1.0 + 0.25 * np.sin(np.arange(a.nnz)))).astype(a.val.dtype))
    ssolver.refresh(refresh_plan(splan, a2))
    x2 = ssolver.solve(b)
    e2 = rel_err(x2, reference_solve(a2, b))
    check(np.isfinite(e2) and e2 <= TOL_SOLVE and not np.array_equal(x2, sx["forward"]),
          f"streamed solve after a refresh: rel err {e2:.3e} against the new values")
    ssolver.refresh(splan)
    check(np.array_equal(ssolver.solve(b), sx["forward"]),
          "refreshing back to the old values did not give the old solve")
    log(f"phase 6 refresh: new values rel err {e2:.2e} vs scipy on them; back to the old "
        f"values bit-equal to the first solve")

    # streamed IC(0)-PCG: two streamed launches per iteration
    kops.reset_launch_counts()
    t0 = time.perf_counter()
    sres = solve_ic0_pcg(a_spd, b_spd, tol=tol, maxiter=400,
                         config=PlanOptions(kernel="fused_streamed"))
    spcg_s = time.perf_counter() - t0
    spcg_launches = kops.launch_counts()
    check(sres.converged and sres.n_iters == res.n_iters,
          f"streamed IC(0)-PCG: converged={sres.converged} in {sres.n_iters} iterations, "
          f"phase 4 took {res.n_iters}")
    strue = float(np.linalg.norm(b_spd - matvec_lower(a_spd, sres.x)) / np.linalg.norm(b_spd))
    check(strue <= 10 * tol, f"streamed PCG true residual {strue:.3e} > {10 * tol}")
    check(spcg_launches["superstep_streamed"] == 2 * sres.n_iters
          and spcg_launches["superstep"] == 0 and spcg_launches["block_trsv"] == 0,
          f"streamed PCG launches {spcg_launches} for {sres.n_iters} iterations")
    log(f"phase 6 streamed IC(0)-PCG: {sres.n_iters} iterations, {spcg_s:.1f} s, true rel "
        f"residual {strue:.2e} (phase 4: {true_res:.2e}), launches {json.dumps(spcg_launches)}")

    # the streamed kernel's own times at full size, and the crossover against
    # the resident kernel at three sizes (in turns: resident, streamed,
    # streamed, resident; 10 solves each)
    sms = time_ms(lambda: superstep.superstep_streamed_call(*stab, *svec, stp=sstp,
                                                            layout=slay, flags=ready), 20)
    sms8 = time_ms(lambda: superstep.superstep_streamed_call(*stab, svec[0], b8, z8, z8,
                                                             stp=sstp, layout=slay,
                                                             flags=ready), 10)
    splain_ms = time_ms(lambda: ref.superstep_streamed_ref(
        *stab, svec[0], slay.diag_entry, slay.tile_entry, *svec[1:], stp=sstp), 3, warmup=1)
    log(f"phase 6 streamed megakernel {sms:.3f} ms/solve (CUDA events, 20 solves; (n, 8) "
        f"panel {sms8:.3f} ms, 10 solves), plain version {splain_ms:.1f} ms; resident "
        f"(phase 5) {fms:.3f} / {fms8:.3f} ms")
    cross, cross_ratio = [], {}
    for side in (256, 512, SIDE):
        if side == SIDE:
            p_, tables, vecs, stp, table = fplan, ftab, fvec, fstp, ftable
            svecs, layout = svec, slay
        else:
            a_ = suite.grid2d_factor(side, seed=6)
            p_ = build_plan(a_, 1, SolverConfig(kernel_backend="fused"))
            tables, vecs, stp = fused_inputs(torch, p_, pad_b(p_, rng.uniform(-1, 1, a_.n)))
            table = superstep.superstep_table(
                *[t.cpu().numpy() for t in tables], n_rows=p_.bs.nb + 1,
                stp=stp.cpu().numpy()).to("cuda")
            svecs, layout = streamed_from(p_, tables, vecs)
        side_ready = superstep.ReadyFlags(p_.bs.nb + 1, "cuda")

        def resident_fn():
            superstep.superstep_call(*tables, *vecs, stp=stp, table=table, flags=side_ready)

        def streamed_fn():
            superstep.superstep_streamed_call(*tables, *svecs, stp=stp, layout=layout,
                                              flags=side_ready)

        turns = [time_ms(fn, 10, warmup=2)
                 for fn in (resident_fn, streamed_fn, streamed_fn, resident_fn)]
        r_ms, s_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
        cross_ratio[side] = s_ms / r_ms
        cross.append(f"side {side} (n={side * side}, {p_.n_levels} levels, diag+tiles "
                     f"{(p_.diag.nbytes + p_.tiles.nbytes) / 1e6:.1f} MB): resident "
                     f"{r_ms:.3f} ms ({turns[0]:.3f}, {turns[3]:.3f}), streamed {s_ms:.3f} ms "
                     f"({turns[1]:.3f}, {turns[2]:.3f}), streamed/resident {s_ms / r_ms:.4f}")
    log("phase 6 crossover, ms per vector solve (CUDA events): " + "; ".join(cross))
    sbound = superstep_bound(splan, slay.table, 1)  # the same function as row 7
    streamed_row = {
        "name": "superstep_streamed", "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{KERNELS['superstep_streamed'][1]}",
        "replaces": KERNELS["superstep_streamed"][0],
        "launches": streamed_launches["superstep_streamed"], "max_abs_err": se_full,
        "ms": sms, "plain_ms": splain_ms, "bound_ms": sbound[0], "bound_by": sbound[1],
        "library_ms": library_ms, "library_device_ms": library_device_ms,
        "device_ms": device_ms(lambda: superstep.superstep_streamed_call(
            *stab, *svec, stp=sstp, layout=slay, flags=ready), MEGAKERNEL_SYMBOL[True, False],
            10),
        "shape": [a.n, splan.bs.B, 1],
    }

    # 7. the syncfree executor at full size: its dense scan (kernel="cuda")
    # and its frontier-bucketed form (kernel="fused"), on the card's block kernels
    phase_start["7 syncfree"] = time.perf_counter()
    x_int = rng.integers(-4, 5, a.n).astype(np.float64)
    a_dy = dyadic(a, seed=SEED)  # b = L x_int: every partial sum exact, x_int the answer
    b_dy = (to_scipy(a_dy) @ x_int).astype(np.float32)
    bt_dy = (to_scipy(a_dy).T @ x_int).astype(np.float32)
    fctx.factorize(a_dy, fh)  # phase 5's megakernel, now on the dyadic values
    x_mega, xt_mega = fctx.solve(fh, b_dy), fctx.solve(fh, bt_dy, transpose=True)
    check(np.array_equal(x_mega, x_int) and np.array_equal(xt_mega, x_int),
          "the megakernel's solve of the dyadic problem is not exact")
    path_launches7, sf_ms, dense_in, sf_plans = {}, {}, {}, {}
    for kernel, name in (("cuda", "dense"), ("fused", "frontier")):
        t0 = time.perf_counter()
        yctx = SpTRSVContext(options=PlanOptions(sched="syncfree", kernel=kernel))
        yh = yctx.analyse(a)
        ysolver, _ = yctx.executor(yh), yctx.executor(yh, transpose=True)
        torch.cuda.synchronize()
        y_an_s = time.perf_counter() - t0
        yplan, ytplan = yctx.plan(yh), yctx.plan(yh, transpose=True)
        sf_plans[name] = (yplan, ytplan)
        check(ysolver._syncfree.frontier == (kernel == "fused"),
              f"syncfree kernel={kernel} did not select the {name} form")

        def expect(p, solve_k, upd_k):
            upd = with_work(p, 1) if kernel == "fused" else p.n_levels
            return {**dict.fromkeys(kops.KERNELS, 0), solve_k: p.n_levels, upd_k: upd}

        yx, made = {}, {}
        with PlainCalls(ref) as plain:
            for form, fn, want_l in (
                    ("forward", lambda: yctx.solve(yh, b),
                     expect(yplan, "block_trsv", "block_gemv")),
                    ("transpose", lambda: yctx.solve(yh, b, transpose=True),
                     expect(ytplan, "block_trsv", "block_gemv")),
                    ("panel_r8", lambda: yctx.solve(yh, panel),
                     expect(yplan, "block_trsm", "block_gemm"))):
                kops.reset_launch_counts()
                yx[form] = fn()
                made[form] = kops.launch_counts()
                check(made[form] == want_l,
                      f"syncfree {name} {form} solve launched {made[form]}, not {want_l}")
        check(plain.calls == 0, f"syncfree {name}: {plain.calls} plain-version calls on the card")
        path_launches7[name] = {k: sum(m[k] for m in made.values()) for k in kops.KERNELS}
        yerrs = {form: rel_err(yx[form], want[form]) for form in yx}
        for form, e in yerrs.items():
            check(np.isfinite(e) and e <= TOL_SOLVE,
                  f"syncfree {name} {form} rel err {e:.3e} > {TOL_SOLVE}")
        sweeps, reads = ysolver._syncfree.sweeps, ysolver._syncfree.host_reads
        check(sweeps == yplan.n_levels, f"syncfree {name}: {sweeps} sweeps for "
                                        f"{yplan.n_levels} levels")
        # the block kernels at the largest batches this form hands them
        # (dense: every local row and every tile; frontier: the top ladder
        # rungs), on this solve's data: the first sweep's right-hand sides
        # and the last sweep's sources; outside the counted run
        sch = ysolver._syncfree
        rows = sch.lr[:sch.lad_s[-1]] if sch.frontier else sch.lr
        srcs = sch.tcol[:sch.lad_u[-1]] if sch.frontier else sch.tcol
        b1, b8 = (torch.from_numpy(pad_b(yplan, r)).cuda()[rows] for r in (b, panel))
        x1, x8 = (torch.from_numpy(pad_b(yplan, r)).cuda()[srcs]
                  for r in (yx["forward"], yx["panel_r8"]))
        ldiag, ltiles = ysolver._diag[rows], ysolver._tiles[:srcs.shape[0]]
        hold_at_path_shape(kops, ref, torch, ("block_trsv", "block_trsm"), ldiag, b1, b8, err,
                           f"syncfree {name}")
        hold_at_path_shape(kops, ref, torch, ("block_gemv", "block_gemm"), ltiles, x1, x8, err,
                           f"syncfree {name}")
        if not sch.frontier:
            dense_in = {"block_trsv": (ldiag, b1), "block_trsm": (ldiag, b8),
                        "block_gemv": (ltiles, x1), "block_gemm": (ltiles, x8)}
        log(f"phase 7 syncfree {name}: TRSV/TRSM at k={rows.shape[0]} and GEMV/GEMM at "
            f"m={srcs.shape[0]} tiles (R = 1, 8; this solve's data) within {TOL_KERNEL} of "
            f"their plain versions, TRSV and GEMV bit-equal to their oracles, every panel "
            f"column bit-equal to the vector kernel")
        sf_ms[name] = solve_times(yctx, yh, b, panel, runs=3)
        log(f"phase 7 syncfree {name} (kernel={kernel}): analyse+plan+upload (forward and "
            f"transpose) {y_an_s:.1f} s; rel err vs scipy "
            + ", ".join(f"{k}={v:.2e}" for k, v in yerrs.items())
            + f"; per forward solve {sweeps} sweeps, {reads} host reads, launches "
            f"{json.dumps({k: v for k, v in made['forward'].items() if v})}; no plain version")
        log(f"phase 7 syncfree {name} ms/solve (median of 3; min, max), beside phase 3's "
            f"(switch) and phase 5's (megakernel) medians: " + ", ".join(
                f"{k}={v[1]:.2f} ({v[0]:.2f}, {v[-1]:.2f}) vs {timing[k][2]:.2f} / "
                f"{ftiming[k][2]:.2f}" for k, v in sf_ms[name].items()))
        # a refresh to the dyadic values: any correct order gives x_int exactly
        yctx.factorize(a_dy, yh)
        yd, ydt = yctx.solve(yh, b_dy), yctx.solve(yh, bt_dy, transpose=True)
        check(np.array_equal(yd, x_mega) and np.array_equal(ydt, xt_mega),
              f"syncfree {name} after a refresh to dyadic values != the megakernel's bits")
        log(f"phase 7 syncfree {name} refresh to dyadic values: forward and transpose "
            f"bit-equal to the megakernel's solve and to the integer solution")
        del yctx, yh, ysolver
    fctx.factorize(a, fh)

    kops.reset_launch_counts()
    t0 = time.perf_counter()
    yres = solve_ic0_pcg(a_spd, b_spd, tol=tol, maxiter=400,
                         config=PlanOptions(sched="syncfree", kernel="fused"))
    ypcg_s = time.perf_counter() - t0
    ypcg_launches = kops.launch_counts()
    ytrue = float(np.linalg.norm(b_spd - matvec_lower(a_spd, yres.x)) / np.linalg.norm(b_spd))
    check(yres.converged and ytrue <= 10 * tol,
          f"syncfree IC(0)-PCG: converged={yres.converged} in {yres.n_iters} iterations, "
          f"true residual {ytrue:.3e}")
    yfw, ybw = yres.info["forward"], yres.info["backward"]
    ypcg_want = {**dict.fromkeys(kops.KERNELS, 0),
                 "block_trsv": yfw.plan.n_levels * yfw.n_solves
                 + ybw.plan.n_levels * ybw.n_solves,
                 "block_gemv": with_work(yfw.plan, 1) * yfw.n_solves
                 + with_work(ybw.plan, 1) * ybw.n_solves + 3 * yres.info["spmv"].n_matvecs}
    check(ypcg_launches == ypcg_want,
          f"syncfree PCG launches {ypcg_launches}, not {ypcg_want} (one TRSV a level, one "
          f"GEMV a level with tiles, three a matvec)")
    log(f"phase 7 syncfree (frontier) IC(0)-PCG: {yres.n_iters} iterations (phase 4: "
        f"{res.n_iters}), {ypcg_s:.1f} s, true rel residual {ytrue:.2e}, launches "
        f"{json.dumps(ypcg_launches)}")

    # 8. ILU(0)-BiCGStab: two L and two U solves per iteration, U as the
    # transpose solve of the reversed U^T
    phase_start["8 bicgstab"] = time.perf_counter()
    path_launches8 = {}
    spd_plan = build_plan(a_spd, 1, SolverConfig())
    spd_store = spd_plan.diag.nbytes + spd_plan.tiles.nbytes
    bicgstab_iters = {}
    for kernel in ("cuda", "fused", "fused_streamed"):
        kops.reset_launch_counts()
        t0 = time.perf_counter()
        with stream_crossover.stream_limit_env(2 * spd_store):  # "fused" held resident
            bres = solve_ilu0_bicgstab(a_spd, b_spd, tol=tol, maxiter=400,
                                       config=PlanOptions(kernel=kernel))
            streamed = [dispatch_stats(bres.info[k].plan)["streamed"]
                        for k in ("forward", "backward")]
        bsecs = time.perf_counter() - t0
        blaunch = kops.launch_counts()
        check(streamed == [kernel == "fused_streamed"] * 2,
              f"ILU(0)-BiCGStab ({kernel}): plans report streamed {streamed}")
        path_launches8[kernel] = blaunch
        bicgstab_iters[kernel] = bres.n_iters
        btrue = float(np.linalg.norm(b_spd - matvec_lower(a_spd, bres.x))
                      / np.linalg.norm(b_spd))
        check(bres.converged and btrue <= 10 * tol,
              f"ILU(0)-BiCGStab ({kernel}): converged={bres.converged} in {bres.n_iters} "
              f"iterations, true residual {btrue:.3e}")
        nfw, nbw = bres.info["forward"].n_solves, bres.info["backward"].n_solves
        check(nfw == nbw == 2 * bres.n_iters,
              f"ILU(0)-BiCGStab ({kernel}): {nfw}/{nbw} sweeps for {bres.n_iters} iterations")
        # the SpMV: three GEMV launches a matvec; a fused form one megakernel
        # launch a triangular solve, the switch executor one TRSV a level
        # with rows and one GEMV a level with tiles
        fwp, bwp = bres.info["forward"].plan, bres.info["backward"].plan
        bwant = {**dict.fromkeys(kops.KERNELS, 0), "block_gemv": 3 * bres.info["spmv"].n_matvecs}
        mega = {"fused": "superstep", "fused_streamed": "superstep_streamed"}.get(kernel)
        if mega:
            bwant[mega] = nfw + nbw
        else:
            bwant["block_trsv"] = with_work(fwp, 0) * nfw + with_work(bwp, 0) * nbw
            bwant["block_gemv"] += with_work(fwp, 1) * nfw + with_work(bwp, 1) * nbw
        check(blaunch == bwant,
              f"ILU(0)-BiCGStab ({kernel}) launches {blaunch}, not {bwant}, for "
              f"{bres.n_iters} iterations")
        log(f"phase 8 ILU(0)-BiCGStab ({kernel}) n={a_spd.n}: {bres.n_iters} iterations, "
            f"{bsecs:.1f} s (analysis + ilu0 + iterations), true rel residual {btrue:.2e}, "
            f"{nfw} L + {nbw} U solves, launches "
            f"{json.dumps({k: v for k, v in blaunch.items() if v})}")

    # 9. telemetry, calibration and auto
    phase_start["9 telemetry"] = time.perf_counter()
    sub_s = {}  # seconds per sub-step
    path_launches9 = {}

    # (a) a traced session over phase 3's factor
    t0 = time.perf_counter()
    reg = omet.MetricsRegistry()
    kops.reset_launch_counts()
    with otr.trace_to() as tracer:
        tctx = SpTRSVContext(registry=reg)
        th = tctx.analyse(a)
        tctx.solve(th, b)
        a2 = CSR(n=a.n, row_ptr=a.row_ptr, col_idx=a.col_idx,
                 val=(a.val * (1.0 + 0.25 * np.sin(np.arange(a.nnz)))).astype(a.val.dtype))
        tctx.factorize(a2, th)
        x_traced = tctx.solve(th, b)
        tctx.solve(th, b, transpose=True)
        records = tracer.export()
    path_launches9["traced_session"] = kops.launch_counts()
    check(rel_err(x_traced, reference_solve(a2, b)) <= TOL_SOLVE,
          "traced session: the solve after factorize disagrees with scipy on the new values")
    spans = {r["id"]: r for r in records if r["type"] == "span"}
    names = sorted({r["name"] for r in spans.values()})
    want_spans = {"sptrsv.analyse", "sptrsv.partition", "sptrsv.schedule", "sptrsv.solve",
                  "sptrsv.factorize", "sptrsv.refresh"}
    check(want_spans <= set(names), f"traced session spans {names} lack "
                                    f"{sorted(want_spans - set(names))}")
    check(all(r["parent"] is None or r["parent"] in spans for r in spans.values()),
          "traced session: a span names a parent that does not exist")
    top = {r["name"]: round(r["dur_us"] / 1e3, 1) for r in spans.values() if r["parent"] is None}
    log(f"phase 9a traced session: {len(spans)} spans, names {names}; top-level ms "
        f"{json.dumps(top)}")
    # dyadic solves bit-equal with tracing on and off, per backend
    yctx = SpTRSVContext(options=PlanOptions(sched="syncfree", kernel="fused"))
    yh = yctx.analyse(a_dy)
    backends = {"cuda": (ctx, h), "fused": (fctx, fh), "fused_streamed": (sctx, sh),
                "syncfree_fused": (yctx, yh)}
    for name, (c_, h_) in backends.items():
        if c_ is not yctx:
            c_.factorize(a_dy, h_)
        off = c_.solve(h_, b_dy)
        with otr.trace_to():
            on = c_.solve(h_, b_dy)
        check(np.array_equal(off, on) and np.array_equal(off, x_int),
              f"{name}: the dyadic solve differs with tracing on and off, or from x")
    check(fctx.executor(fh)._fused.layout is None and sctx.executor(sh)._fused.layout is not None,
          "phase 9a: phase 5's executor is not resident or phase 6's not streamed")
    del yctx, yh
    # one profiler capture of a traced switch solve holds the level ranges
    with otr.trace_to(), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
        ctx.solve(h, b_dy)
    level_ranges = [e for e in prof.key_averages() if e.key == "sptrsv.level_solve"]
    check(level_ranges and level_ranges[0].count == with_work(plan, 0),
          f"profiler capture: sptrsv.level_solve ranges {[e.count for e in level_ranges]}, "
          f"levels with rows {with_work(plan, 0)}")
    # the switch forward solve with tracing off and on, in alternating pairs
    pairs = {"off": [], "on": []}
    for _ in range(5):
        for mode in ("off", "on"):
            tracing = otr.trace_to() if mode == "on" else contextlib.nullcontext()
            with tracing:
                t1 = time.perf_counter()
                ctx.solve(h, b)
                pairs[mode].append(1e3 * (time.perf_counter() - t1))
    for mode in pairs:
        pairs[mode].sort()
    log("phase 9a dyadic solves bit-equal with tracing on and off (cuda, fused resident, "
        "fused_streamed, syncfree fused) and equal to x; profiler capture of a traced switch "
        f"solve: {level_ranges[0].count} sptrsv.level_solve ranges; switch forward ms, 5 "
        "alternating pairs, median (min, max): " + ", ".join(
            f"tracing {m} {v[2]:.2f} ({v[0]:.2f}, {v[-1]:.2f})" for m, v in pairs.items())
        + f"; on/off {pairs['on'][2] / pairs['off'][2]:.4f}")
    sub_s["a tracing"] = time.perf_counter() - t0

    # (b) the traced session's metrics
    t0 = time.perf_counter()
    snap = tctx.metrics_snapshot(th)
    tplan = tctx.plan(th)
    for k, v in dispatch_stats(tplan).items():
        check(snap[f"plan.{k}"] == (int(v) if isinstance(v, bool) else v),
              f"metrics plan.{k} = {snap[f'plan.{k}']} != dispatch_stats {v}")
    cs = cut_stats(tplan.bs, tplan.part)
    for f in dataclasses.fields(cs):
        check(snap[f"plan.{f.name}"] == getattr(cs, f.name),
              f"metrics plan.{f.name} != cut_stats")
    made = tctx.stats()["solves"]
    check(snap["session.solves"] == snap["session.solve_us"]["count"] == made == 3,
          f"metrics: session.solves {snap['session.solves']}, solve_us count "
          f"{snap['session.solve_us']['count']}, solves made {made}")
    log(f"phase 9b metrics: plan.* equal to dispatch_stats and cut_stats; session.solves "
        f"{snap['session.solves']}, solve_us {json.dumps(snap['session.solve_us'])}")
    sub_s["b metrics"] = time.perf_counter() - t0

    # (c) the weights measured on the card
    t0 = time.perf_counter()
    measured = {}
    for Bw in (16, 32):
        w = calibrate_weights(Bw, "cuda")
        tile_ms = costmodel.measured_tile_ms(Bw, "cuda")
        check(w == costmodel.measured_weights(Bw, "cuda") and w != costmodel.analytic_weights(Bw),
              f"calibrate_weights({Bw}, 'cuda') on the card is not the measured weights")
        check(all(np.isfinite(v) for v in w) and w[0] == 1.0 and w[1] >= 0 and w[2] >= 0,
              f"measured weights at B={Bw} are not well formed: {w}")
        measured[Bw] = w
        log(f"phase 9c measured weights B={Bw}: {w} from device ms per tile "
            f"{json.dumps(tile_ms)} ({costmodel.MEASURE_CALLS} calls of "
            f"{costmodel.MEASURE_TILES} tiles each; analytic {costmodel.analytic_weights(Bw)})")
    sub_s["c weights"] = time.perf_counter() - t0

    # (d) the resident/streamed crossover, and plain fused at full size
    t0 = time.perf_counter()
    table = stream_crossover.measure()
    for r in table:
        log("phase 9d crossover " + stream_crossover.format_row(r))
    log("phase 9d beside phase 6 (raw launches, B=32): " + "; ".join(cross))
    limit = stream_limit()
    log(f"phase 9d crossover_bytes of the table {stream_crossover.crossover_bytes(table)}, "
        f"DEFAULT_STREAM_LIMIT {DEFAULT_STREAM_LIMIT}, stream_limit() {limit}")
    faster_streamed = cross_ratio[SIDE] < 1.0
    kops.reset_launch_counts()
    pctx = SpTRSVContext(options=PlanOptions(kernel="fused"))
    ph = pctx.analyse(a_dy)
    check(pctx.dispatch_stats(ph)["streamed"] == faster_streamed,
          f"plain fused at full size reports streamed={pctx.dispatch_stats(ph)['streamed']}, "
          f"but phase 6 measured streamed/resident {cross_ratio[SIDE]:.4f}")
    x_rule = pctx.solve(ph, b_dy)  # builds the executor
    kops.reset_launch_counts()
    x_rule2 = pctx.solve(ph, b_dy)
    path_launches9["fused_by_rule"] = kops.launch_counts()
    form = "superstep_streamed" if faster_streamed else "superstep"
    check(path_launches9["fused_by_rule"] == {**dict.fromkeys(kops.KERNELS, 0), form: 1},
          f"plain fused launched {path_launches9['fused_by_rule']}, not one {form}")
    check(np.array_equal(x_rule, x_mega) and np.array_equal(x_rule2, x_mega),
          "plain fused (by the rule) != phase 7's resident megakernel solve bit for bit")
    del pctx, ph
    resident_wins = [r for r in table if r["ratio"] > 1.0]
    for r in resident_wins:
        p_ = build_plan(suite.grid2d_factor(r["side"], seed=6), 1,
                        SolverConfig(block_size=r["B"], kernel_backend="fused"))
        check(not fused_streaming(p_), f"side {r['side']} B={r['B']}: resident won "
                                       f"({r['ratio']:.4f}) but plain fused streams")
    log(f"phase 9d plain fused at full size: {form} (one launch per solve), bit-equal to phase "
        f"7's resident solve of the dyadic twin; resident faster at "
        f"{[(r['side'], r['B']) for r in resident_wins] or 'no size measured'}")
    sub_s["d crossover"] = time.perf_counter() - t0

    # (e) auto on phase 4's system, probed at R = 1 and R = 8, with the stream
    # limit above its store so "fused" is probed resident beside
    # "fused_streamed"; then a probe-free session on the reloaded store
    t0 = time.perf_counter()
    ocal.set_store(ocal.CalibrationStore())
    auto_opts = PlanOptions(sched="auto", kernel="auto", probe_solves=3)
    with stream_crossover.stream_limit_env(2 * spd_store):
        kops.reset_launch_counts()
        actx = SpTRSVContext(options=auto_opts)
        ah = actx.analyse(a_spd)
        path_launches9["auto_probed"] = kops.launch_counts()
        d = ah.auto
        n_probed = ocal.get_store().n_samples()
        d8 = SpTRSVContext(options=dataclasses.replace(auto_opts, rhs_hint=8)).analyse(
            a_spd).auto
    check(d.mode == "probed" and d.chosen == min(d.probe_us, key=d.probe_us.get),
          f"auto: mode {d.mode}, chosen {d.chosen} is not the fastest probe {d.probe_us}")
    check(n_probed == len(d.probe_us), f"auto: {n_probed} samples for {len(d.probe_us)} probes")
    check(("levelset", "zerocopy", "fused_streamed") in d.probe_us,
          "auto: fused_streamed was not probed beside the resident fused")
    xa = actx.solve(ah, b_spd)
    ea = rel_err(xa, reference_solve(a_spd, b_spd))
    check(np.isfinite(ea) and ea <= TOL_SOLVE, f"auto solve rel err {ea:.3e} > {TOL_SOLVE}")
    ratio = ocal.calibrated_stream_ratio()
    cal_limit = ocal.calibrated_stream_limit()
    check(cal_limit is not None, "auto: no paired fused/fused_streamed samples")
    for dd, R in ((d, 1), (d8, 8)):
        log(f"phase 9e auto (R={R}) chosen {'/'.join(dd.chosen)} ({dd.mode}); probe overhead "
            f"{dd.probe_overhead_us / 1e6:.2f} s; probe_us / compile_us: " + "; ".join(
                f"{'/'.join(c)} {dd.probe_us[c]:.0f} / {dd.compile_us[c]:.0f}"
                for c in sorted(dd.probe_us, key=dd.probe_us.get)))
    log(f"phase 9e auto solve rel err vs scipy {ea:.2e}; {n_probed} samples after the R=1 "
        f"session, {ocal.get_store().n_samples()} after R=8; probed streamed/resident per "
        f"work unit {ratio:.4f}, calibrated_stream_limit() {cal_limit}")
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "weights.json")
        ocal.get_store().save(path)
        reloaded = ocal.CalibrationStore(path=path)
    check(reloaded.sample_groups() == ocal.get_store().sample_groups(),
          "the calibration store did not round-trip through its file")
    ocal.set_store(reloaded)
    mctx = SpTRSVContext(options=dataclasses.replace(auto_opts, probe_solves=0))
    mh = mctx.analyse(a_spd)
    fitted = {}
    for key in sorted(reloaded.sample_groups()):
        backend, Bk = key.split(":", 1)[1].split("/B")
        fit = reloaded.fitted_weights(int(Bk), backend, "cuda")
        if fit is not None:
            fitted[(backend, int(Bk))] = fit
            check(calibrate_weights(int(Bk), backend) == fit
                  and fit != costmodel.measured_weights(int(Bk), backend),
                  f"calibrate_weights({Bk}, {backend!r}) is not the reloaded store's fit")
    check(mh.auto.mode == "modelled" and fitted,
          f"probe-free session: mode {mh.auto.mode}, fitted groups {sorted(fitted)}")
    log(f"phase 9e reloaded store ({reloaded.n_samples()} samples): probe-free session "
        f"{mh.auto.mode}, chosen {'/'.join(mh.auto.chosen)}; fitted weights (the ones "
        f"calibrate_weights returns) " + "; ".join(
            f"{k[0]}/B{k[1]} {v}" for k, v in fitted.items())
        + f"; measured B=32 {measured[32]}")
    ocal.set_store(None)
    del actx, ah, mctx, mh
    sub_s["e auto"] = time.perf_counter() - t0
    log("phase 9 seconds per sub-step: " + ", ".join(f"{k}={v:.1f}" for k, v in sub_s.items()))

    # 10. the verifier, the plan store and the solve service
    phase_start["10 service"] = time.perf_counter()
    plans10 = {"switch forward": plan, "switch transpose": ctx.plan(h, transpose=True),
               "resident forward": fctx.plan(fh), "resident transpose": fctx.plan(fh, transpose=True),
               "streamed forward": splan, "streamed transpose": sctx.plan(sh, transpose=True),
               **{f"syncfree {k} {d}": p for k, pair in sf_plans.items()
                  for d, p in zip(("forward", "transpose"), pair)}}
    service_launches = phase_service(a, a_dy, x_int, plans10, rng)

    # 11. multi-device comm="unified": UNIFIED_RANKS gloo ranks on this card
    phase_start["11-13 unified, zerocopy, tail (ranks)"] = time.perf_counter()
    # 12. multi-device comm="zerocopy" and syncfree, run by phase 11's ranks
    # 13. the multi-device tail, run by the same ranks after phase 12:
    # its inputs (the one-device runs' iterations, scipy's x, the vectors)
    a_auto = suite.grid2d_factor(AUTO_SIDE, seed=6)
    b_auto = rng.uniform(-1, 1, a_auto.n)
    n_spd = a_spd.n
    tail = {"b_spd": b_spd, "tol": tol, "pcg_iters": fres.n_iters,
            "bicgstab_iters": bicgstab_iters["fused"],
            "x_spd": spla.spsolve(to_scipy(symmetric_full_csr(a_spd)).tocsc(), b_spd),
            "v_dyadic": rng.integers(-4, 5, n_spd).astype(np.float32),
            "v8_dyadic": rng.integers(-4, 5, (n_spd, 8)).astype(np.float32),
            "v_real": rng.uniform(-1, 1, n_spd).astype(np.float32),
            "v8_real": rng.uniform(-1, 1, (n_spd, 8)).astype(np.float32),
            "b_auto": b_auto, "want_auto": reference_solve(a_auto, b_auto)}
    split_rows, unified_paths, phase12_s, rank_results = phase_unified(
        a, b, b_dy, x_int, want, plan.diag.nbytes + plan.tiles.nbytes,
        {"streamed": stiming["forward"][2], "resident": ftiming["forward"][2],
         "switch": timing["forward"][2], "syncfree_dense": sf_ms["dense"]["forward"][1],
         "syncfree_frontier": sf_ms["frontier"]["forward"][1]}, rng, tail)
    log(f"phase 12 zerocopy and multi-rank syncfree: {phase12_s:.1f} s of phase 11's "
        f"(its ranks, split-kernel check and CLI)")
    phase_start["13 tail (report, service)"] = time.perf_counter()
    tail_paths, phase13_s = phase_tail(rank_results, card)
    log(f"phase 13 the multi-device tail: {phase13_s:.1f} s (its share of the ranks, and "
        f"the service)")

    # 14. the streamed megakernel at B > 169 (row chunks), one device, and the
    # split forms (the two-rank zerocopy path ran in phase 12's ranks)
    phase_start["14 wide blocks"] = time.perf_counter()
    wide_rows, wide_paths = phase_wide(rng, rank_results[0]["wide"]["wide_dyadic"], copy_lib)

    # kernel timings at the main path's widest level (B = 32, R = 8 panels)
    phase_start["kernel timings"] = time.perf_counter()
    s0, ws = widest(plan, 0)
    u0, wu = widest(plan, 1)
    sr = plan.solve_rows[0][s0:s0 + ws]
    L = torch.from_numpy(plan.diag[np.where(sr < 0, plan.bs.nb, sr)]).cuda()
    T = torch.from_numpy(plan.tiles[0][plan.upd_tiles[0][u0:u0 + wu]]).cuda()
    Bsz = plan.bs.B
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    shapes = {"block_trsv": (L, (ws, Bsz, 1)), "block_trsm": (L, (ws, Bsz, 8)),
              "block_gemv": (T, (wu, Bsz, 1)), "block_gemm": (T, (wu, Bsz, 8)),
              "block_trsv_panel": (L, (ws, Bsz, 1)), "block_gemv_grouped": (T, (wu, Bsz, 1))}
    path_launches = {**launches, "block_trsv_panel": panel_launches["block_trsv_panel"],
                     "block_gemv_grouped": grouped_launches["block_gemv_grouped"]}
    library = {"block_trsv": lambda m, v: torch.linalg.solve_triangular(
                   m, v.unsqueeze(-1), upper=False),
               "block_trsm": lambda m, v: torch.linalg.solve_triangular(m, v, upper=False),
               "block_gemv": lambda m, v: torch.bmm(m, v.unsqueeze(-1)),
               "block_gemm": lambda m, v: torch.bmm(m, v),
               "block_trsv_panel": lambda m, v: torch.linalg.solve_triangular(
                   m, v.unsqueeze(-1), upper=False),
               "block_gemv_grouped": lambda m, v: torch.bmm(m, v.unsqueeze(-1))}
    plain = {"block_trsv": ref.block_trsv_ref, "block_trsm": ref.block_trsv_ref,
             "block_gemv": ref.block_gemv_ref, "block_gemm": ref.block_gemv_ref,
             "block_trsv_panel": ref.block_trsv_panel_ref,
             "block_gemv_grouped": ref.block_gemv_ref}
    step_ms = chain_latency.step_ms(chain_lib)
    log(f"one dependent __fdiv_rn + fmaf (perf/chain_latency.cu): {step_ms * 1e6:.3f} ns")
    rows_out = []
    for name, (mat, (k, B, R)) in shapes.items():
        vec = torch.rand((k, B) if R == 1 else (k, B, R), device="cuda", generator=gen) * 2 - 1
        fn = kops.KERNELS[name]
        got, want = fn(mat, vec), plain[name](mat, vec)
        torch.cuda.synchronize()
        e = float((got - want).abs().max())
        check(torch.allclose(got, want, rtol=TOL_KERNEL, atol=TOL_KERNEL),
              f"{name} disagrees with its plain version at the main-path shape: {e:.3e}")
        lib_out = library[name](mat, vec).reshape(want.shape)
        check(torch.allclose(lib_out, want, rtol=TOL_KERNEL, atol=TOL_KERNEL),
              f"{name}: the library yardstick computes something else")
        bound_ms, bound_by = bound(name, k, B, R)
        rows_out.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{KERNELS[name][1]}",
            "replaces": KERNELS[name][0], "launches": path_launches[name],
            "max_abs_err": max(e, err[name]),
            "ms": time_ms(lambda: fn(mat, vec)),
            "plain_ms": time_ms(lambda: plain[name](mat, vec)),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "chain_bound_ms": B * step_ms if name in ROW_SWEEPS else None,
            "library_ms": time_ms(lambda: library[name](mat, vec)),
            "device_ms": device_ms(lambda: fn(mat, vec), DEVICE_KERNEL[name]),
            "library_device_ms": device_ms(lambda: library[name](mat, vec), LIBRARY_KERNEL),
            "shape": [k, B, R],
        })
    # the same kernels on a wide batch, where the device, not the host, sets the pace
    wide = []
    for name, (k, B, R) in (("block_trsv", (4096, 32, 1)), ("block_gemv", (4096, 32, 1)),
                            ("block_trsm", (4096, 32, 8)), ("block_gemm", (4096, 32, 8)),
                            ("block_trsv_panel", (4096, 32, 1)),
                            ("block_gemv_grouped", (4096, 32, 1))):
        mat = torch.rand(k, B, B, device="cuda", generator=gen) * 2 - 1
        if name.startswith("block_tr"):  # well-conditioned lower-triangular tiles
            mat = torch.tril(mat, -1) / B + 2 * torch.eye(B, device="cuda")
        vec = torch.rand((k, B) if R == 1 else (k, B, R), device="cuda", generator=gen)
        fn = kops.KERNELS[name]
        wide.append(f"{name}[{k}x{B}x{R}] ms={time_ms(lambda: fn(mat, vec), 50):.4f} "
                    f"plain_ms={time_ms(lambda: plain[name](mat, vec), 50):.4f} "
                    f"library_ms={time_ms(lambda: library[name](mat, vec), 50):.4f} "
                    f"bound_ms={bound(name, k, B, R)[0]:.4f} "
                    f"device_ms={device_ms(lambda: fn(mat, vec), DEVICE_KERNEL[name])} "
                    f"library_device_ms="
                    f"{device_ms(lambda: library[name](mat, vec), LIBRARY_KERNEL)}")
    log("kernel times at k=4096 tiles (device_ms from torch.profiler): " + "; ".join(wide))
    # the GEMV family at the tile count of phase 4's SpMV (every tile of the
    # n = PCG_SIDE^2 problem, B = 32), where the SpMV calls the GEMV
    sp_tiles = torch.from_numpy(np.ascontiguousarray(spd_plan.tiles[0])).cuda()
    m_sp = sp_tiles.shape[0]
    at_spmv = []
    for row in rows_out:
        name = row["name"]
        if name not in ("block_gemv", "block_gemm", "block_gemv_grouped"):
            continue
        R = row["shape"][2]
        vec = torch.rand((m_sp, Bsz) if R == 1 else (m_sp, Bsz, R), device="cuda",
                         generator=gen) * 2 - 1
        fn = kops.KERNELS[name]
        got, want = fn(sp_tiles, vec), plain[name](sp_tiles, vec)
        torch.cuda.synchronize()
        check(torch.allclose(got, want, rtol=TOL_KERNEL, atol=TOL_KERNEL),
              f"{name} disagrees with its plain version at the SpMV's {m_sp} tiles")
        row["at_spmv"] = {
            "shape": [m_sp, Bsz, R], "ms": time_ms(lambda: fn(sp_tiles, vec)),
            "library_ms": time_ms(lambda: library[name](sp_tiles, vec)),
            "device_ms": device_ms(lambda: fn(sp_tiles, vec), DEVICE_KERNEL[name]),
            "library_device_ms": device_ms(lambda: library[name](sp_tiles, vec),
                                           LIBRARY_KERNEL),
            "bound_ms": bound(name, m_sp, Bsz, R)[0]}
        at_spmv.append(f"{name}[{m_sp}x{Bsz}x{R}] " + " ".join(
            f"{k}={v}" for k, v in row["at_spmv"].items() if k != "shape"))
    log("GEMV family at the SpMV's tile count (ms; device_ms from torch.profiler): "
        + "; ".join(at_spmv))
    # the per-op kernels at the dense scan's batches (phase 7: every local
    # row, every tile, on the solve's data), where its device time goes
    at_dense = []
    for row in rows_out:
        name = row["name"]
        if name not in dense_in:
            continue
        mat, vec = dense_in[name]
        fn = kops.KERNELS[name]
        kd, R = mat.shape[0], vec.shape[2] if vec.ndim == 3 else 1
        row["at_dense_scan"] = {
            "shape": [kd, Bsz, R], "ms": time_ms(lambda: fn(mat, vec), 50),
            "plain_ms": time_ms(lambda: plain[name](mat, vec), 20),
            "library_ms": time_ms(lambda: library[name](mat, vec), 50),
            "device_ms": device_ms(lambda: fn(mat, vec), DEVICE_KERNEL[name]),
            "library_device_ms": device_ms(lambda: library[name](mat, vec), LIBRARY_KERNEL),
            "bound_ms": bound(name, kd, Bsz, R)[0]}
        at_dense.append(f"{name}[{kd}x{Bsz}x{R}] " + " ".join(
            f"{k}={v}" for k, v in row["at_dense_scan"].items() if k != "shape"))
    log("per-op kernels at the syncfree dense scan's batches (ms; device_ms from "
        "torch.profiler): " + "; ".join(at_dense))
    log("block kernels' device-only ms at the widest level (kernel / torch library call): "
        + ", ".join(f"{r['name']}={r['device_ms']} / {r['library_device_ms']}"
                    for r in rows_out))
    # the row-chunked kernels' chain floor: B dependent divisions and FMAs a
    # level, over the launch's levels
    for row in wide_rows:
        for at in [row, *row.get("at_B", {}).values()]:
            at["chain_bound_ms"] = at["n_levels"] * at["shape"][1] * step_ms
    rows_out += [superstep_row, streamed_row] + split_rows + wide_rows
    # each later path's launches, counted from 0 around that path alone; the
    # chunked rows' wrappers over phase 14's paths (B > 169) alone
    paths = {**{f"syncfree_{k}": v for k, v in path_launches7.items()},
             "syncfree_pcg": ypcg_launches, "service": service_launches,
             **{f"bicgstab_{k}": v for k, v in path_launches8.items()},
             **path_launches9, **unified_paths, **tail_paths}
    for row in rows_out:
        wrapper = WRAPPER.get(row["name"], row["name"])
        row["launches_by_path"] = {path: counts[wrapper] for path, counts in
                                   (wide_paths if row["name"] in WRAPPER else paths).items()}
    for row in wide_rows:
        check(row["launches"] > 0, f"{row['name']}: no launch on phase 14's paths")
    torch.cuda.synchronize()

    # 15. the LM serving path: reduced configs card vs CPU, llama3.2-1b in full
    phase_start["15 lm serving"] = time.perf_counter()
    lm_out = phase_lm(card)
    # 16. the LM training path: reduced configs card vs CPU, llama3.2-1b in full
    phase_start["16 lm training"] = time.perf_counter()
    train_out = phase_lm_train(card)
    # 17. the LM sharding rules at 256 and 512 ranks; llama3.2-1b placed on 4 ranks
    phase_start["17 lm sharding"] = time.perf_counter()
    phase_sharding(card)
    # 18. the LM steps on a 2 x 2 mesh of ranks sharing the card
    phase_start["18 lm on a mesh"] = time.perf_counter()
    phase_mesh(card, lm_out, train_out)
    phase_start["end"] = time.perf_counter()
    names = list(phase_start)
    log("seconds per phase: " + ", ".join(
        f"{n}={phase_start[m] - phase_start[n]:.1f}" for n, m in zip(names, names[1:])))

    print(card)
    print(json.dumps({"kernels": rows_out}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
