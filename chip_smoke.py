#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py            # all phases, one card
    python3 chip_smoke.py --sass-against OTHER/src/repro_torch/kernels/build
        # the same, and phase 1 compares each kernel function's SASS with
        # another tree's build of the same source (built there first)
    python3 chip_smoke.py --telemetry-repeats 3
        # the same, with 3 pairs of traced and bare drains in phases 15
        # and 17 (in turns) to time telemetry's cost against the spread

Phases (any failure raises and exits non-zero):

  1. build the six kernels from ``kernels/csrc`` with nvcc, one process
     per source, all at once; print the card and its power limit, and the
     SASS instruction counts (``cuobjdump -sass``) that show each
     redesigned kernel's hardware path: ``HGMMA`` and ``UTMALDG`` for
     ``flash_attention`` (bf16 route), ``BMMA`` and ``POPC`` for
     ``count_stats``, ``REDUX`` for ``masked_row_reduce``, ``HMMA`` for
     ``ssd_scan`` (bf16 route); and ptxas's spill bytes of every kernel
     function, none allowed but the listed exception (``SPILLS_ALLOWED``);
  2. hold ``count_stats`` bitwise against its plain PyTorch version on
     CUDA tensors (n in {1, 31, 33, 100, 300, 1000, 1025, 1500} x L in
     {1, 7, 1024, 8192}, all-invalid lanes, all-tied circulant degrees)
     and the ``degree_stats`` / ``domination_stats`` bindings;
  3. drain ``vc gnp:100:10:7`` and ``ds gnp:60:10:5`` at 1024 lanes
     through ``Solver.solve`` and check the optima (69, 11); run one
     drained solve on the card and on the CPU and require identical
     ``SolveStats`` and lane arrays;
  4. the 60-cell analogue of the paper, ``vc cell60`` (n=300, w=10) at
     4096 lanes: a fixed number of rounds through ``Solver.solve``
     (nodes/s); the same first rounds driven step by step through
     ``make_step`` with the kernel checked against the plain version on
     every step's live masks; the round time split into expand and
     balance; one round, a replay of its CUDA graph, under the profiler:
     the card's busy share, and ``count_stats``'s kernels on the card
     equal to the launches counted for the round;
  5. time ``count_stats`` (profiler device time, and CUDA events) and its
     plain version at (n=300, w=10, L=4096) and (n=100, w=4, L=1024),
     and compute the bounds from the inputs: bytes (the one it is held
     to: its binary products run on the tensor cores) and, beside it,
     the popcount issue of the same work on the CUDA cores;
  6. hold ``stacked_count_stats`` bitwise against its plain version (K in
     {1, 4, 16, 64} x n in {1, 31, 33, 100, 300, 1000, 1025, 1500} x L in
     {1, 7, 1024, 8192}; mixed ids with parked lanes, all lanes parked, ids
     sorted so each instance's lanes lie together, every lane on one
     instance, all-tied circulant tables);
  7. the multi-tenant service at full width through ``Solver.serve``:
     1024 lanes, 4 slots of n = 100, 8 requests of both families drained
     to their serial optima; the same first rounds again with the kernel
     checked against the plain version on every step's live inputs; one
     round's split into expand, balance and an admission's rebuild; one
     service round, a graph replay, under the profiler, its
     ``stacked_count_stats`` kernels on the card equal to the launches
     counted;
  8. the test-sized service mix (a deadline, a budget, a cancel) on the
     card and on the CPU: identical results, tickets, rounds and lanes
     after every round;
  9. checkpoints: a service saved mid-run on the card restores onto 512
     lanes and drains to the same optima; a solve saved on the card
     resumes on the CPU to the same optimum;
 10. time ``stacked_count_stats`` and its plain version at the service's
     shape (K=4, n=100, L=1024, its live inputs) and at (K=16, n=300,
     L=4096) with interleaved and with sorted ids, held to the
     popcount-issue bound (its popcounts run on the CUDA cores) with the
     bytes beside it;
 11. ``popcount_reduce`` and ``masked_row_reduce`` at cell60's shape and a
     sweep (n up to 1500), bitwise; ``masked_row_reduce`` timed in both
     forms (OR, AND), ``popcount_reduce`` beside an empty kernel of its
     grid and block (the launch floor);
 12. ``flash_attention`` at qwen2-7b's and gemma2-27b's prefill widths
     (bf16: the wgmma kernel) and a sweep of both routes, held against the
     plain version with planted faults; timed over 50 launches with SDPA
     in the same call;
 13. ``ssd_scan`` at mamba2-130m's width and a sweep, timed as the sum
     of its three passes' kernels;
 14. a graph of more than 1024 vertices, ``vc gnp:1100:1:3`` (w = 35):
     1024 lanes for 2 rounds after one bootstrap round through
     ``Solver.solve`` with every ``count_stats`` launch held against the
     plain version on its live inputs; one round at 16 lanes on the card
     and on the CPU, identical ``SolveStats`` and lanes; ``count_stats``
     timed at n = 1100 and n = 1500 (w = 47);
 15. telemetry on the card: ``vc gnp:100:10:7`` drained at 1024 lanes
     with ``trace_path`` and ``metrics=True`` and with neither: equal
     ``SolveStats``, bitwise equal lanes, the optimum 69; the trace read
     back by the port's ``obs.trace.read_trace`` (every record validated),
     its last summary the run's nodes and rounds, the snapshot's
     ``engine_nodes`` the run's nodes; each drain's wall time printed, and
     the host time spent inside the collector's calls;
 16. ``vc cell60`` at 4096 lanes for the bootstrap round and 2 more,
     traced against bare, the same checks;
 17. phase 7's drain again, traced and metered: phase 7's results,
     ticket states, rounds and lanes; the trace validates and its
     ``retire`` records are the retirements;
 18. subset sum (``SUBSET_SUM``, n = 36) drained at 1024 lanes on the card
     to the optimum of the port's ``serial_rb``, with the CPU's
     ``SolveStats`` and lanes, and no kernel launch (it has no kernel);
 19. the mesh: ``vc gnp:100:10:7`` on 4 shards of ``cuda:0`` x 256 lanes
     drained through ``Solver.solve`` to 69 with tasks crossing shards,
     beside phase 3's unsharded drain at 1024 lanes; its first 5 rounds,
     driven by hand (bootstrap rounds emit no event) and the last held
     against the solve's, bitwise the CPU's 4 shards; the next round
     split into the shards' expand, their intra-shard steals, the
     cross-device steal and the one replay of the receivers; a one-shard
     mesh giving the unsharded ``SolveStats`` and lanes;
 20. ``vc cell60`` on 4 shards x 1024 lanes, the bootstrap round and 2
     more, bitwise the CPU's for as many rounds as the CPU twin's budget
     runs;
 21. phase 19's drain as saved after round 10, resumed on 2 shards and on
     one device, each drained to 69;
 22. phase 7's mix on the sharded service (2 shards x 512), resized to 4 x
     256 at round 12, saved at round 24 and restored on 2 x 512: every
     result the serial optimum; results, ticket states, rounds and resize
     events the CPU's run of the same schedule; the traces validate and
     hold the ``resize``;
 23. with a second card, phase 19's drain on ``cuda:0`` and ``cuda:1``
     (else one line saying none is present);
 24. the autotuner: ``choose`` and ``predict_cost`` at phase 4's shape;
     both routes of both count kernels bitwise equal to the plain
     versions from 1 to 32 words a row; ``measured_choice`` timing both
     routes at cell60's root shape and the service's;
 25. the host-sync audit: ``python -m repro_torch.analysis`` must report
     no error; the round functions of cell60 (4096 lanes, from phase 4's
     lanes), the service (1024 lanes, 4 slots, phase 7's mix), the mesh
     (4 x 1024 on ``cuda:0``, from phase 20's lanes) and subset sum run
     under ``torch.cuda.set_sync_debug_mode("warn")``, each round making
     exactly its one readback (a planted extra sync must be caught),
     their lanes bitwise those of the same rounds unaudited; whole
     rounds of ``Solver.solve`` counted under
     ``"warn"`` must show ``SYNCS_PER_ROUND`` (1 bare, 2 traced, 1 on
     the mesh);
 26. LM serving: zamba2-2.7b at full width and depth (bf16, 2.7 B
     parameters from the port's seeded init on the card): a batched
     prefill of 4 x 1024 tokens with each of its 9 ``flash_attention``
     and 54 ``ssd_scan`` launches held against the plain version on its
     live inputs, then timed (prefill tokens/s, the profiled device
     share); ``BatchedServer`` (4 slots) serving the 4 prompts for 32
     tokens each: 9 and 54 launches per admission's prefill, none per
     decode step, the first decode step under
     ``set_sync_debug_mode("error")``, decode tokens/s per tick, peak
     memory; both kernels timed on the first site's live inputs (SDPA
     beside the attention); one hybrid group at full width (B=2, S=256,
     8 teacher-forced decode steps) and qwen2-7b at full width cut to 2
     layers (B=1, S=256, 4 steps) on the card against the CPU within
     0.08;
 27. LM serving of the moe, vlm and audio families and the int8 KV
     cache, bf16 at full width: mixtral-8x22b (4 of 56 layers) through
     ``BatchedServer``, 2 slots x 6144 tokens (past its 4096 window: the
     kernel's window and the rolling cache), 16 new each, the first
     prefill's 4 ``flash_attention`` launches held against the plain
     version, the prefill profiled by group (expert GEMMs,
     dispatch/combine, elementwise, attention); llama4-scout (4 of 48)
     with 4 slots x 1024, bf16 and int8 caches; musicgen-large (all 48
     layers, 4 codebooks) with 4 slots x 1024; internvl2-76b (4 of 80)
     through the launcher's path with 256 vision embeddings; each run's
     prefill and decode tokens/s, launches per prefill and tick (none),
     the first tick under ``set_sync_debug_mode("error")``, peak memory;
     ``flash_attention`` timed at mixtral's and llama4's live shapes
     beside SDPA (mixtral's window as a mask); the four families' smoke
     configurations (hd 16 through the padded kernel) and mixtral's first
     layer (B=1, S=128) on the card against the CPU within 0.08, routing
     compared first (near-ties counted; with one, layer by layer);
 28. LM training: zamba2-2.7b at full width and depth (2.34 B
     parameters, f32 masters and AdamW state, bf16 compute, ``remat=
     "full"``) takes 3 AdamW steps of 4 x 1024 tokens through the
     launcher's ``train()``: 18 ``flash_attention`` and 108 ``ssd_scan``
     launches a step (forward and the recompute; the backward
     differentiates the plain versions inside ``kernels/plain_grad.py``'s
     Function), step time, train tokens/s, peak memory; one more step
     under ``set_sync_debug_mode("error")`` with every parameter leaf
     given a non-zero gradient; one step profiled by phase (forward,
     backward, optimizer) and kernel group; the Function on that step's
     live inputs (value within the kernels' tolerances, gradients bitwise
     the plain version's); the zamba2 smoke configuration and one group at
     full width, one step on the card against the CPU; mamba2-130m at
     full width and depth, 20 steps at 8 x 256 resumed from its step-10
     checkpoint to the unbroken run's losses; ``compressed_psum`` and
     ``pipeline_forward`` on 4 shards of ``cuda:0`` against the CPU's;
 29. the dry run (``repro_torch.launch.dryrun``), started after phase 1
     on the host's CPU in three processes of its own with the card hidden
     (the launcher's ``--all``; ``--dry-run train_4x1024`` and
     ``--dry-run solver``) and collected here: each of the 33 (arch x
     shape) cells' peak, ``fits`` against the card's ``total_memory``,
     dominant roofline term and trace time; the solver round on 16 x 16
     placeholder shards, the bytes a shard sends against its compute and
     memory terms; the modelled peaks of ``DRYRUN_MEASURED`` (phase 28's
     step and four cells run on the card through the same step on zeros)
     against ``max_memory_allocated`` within ``PEAK_TOL`` or
     ``PEAK_SLACK``, the roofline time beside the measured step (not
     gated); ``examples/torch_guided_decode.py`` on the card (its
     attention on ``flash_attention``) against the CPU from the same
     parameters; phase 29's own seconds;
     then the ``kernels`` line for all six kernels (``launches`` of the
     LM kernels: phases 26 and 27's serving runs, phase 28's training
     runs and phase 29's), and the seconds each phase took.  The CPU's
     side of phases 19, 20 and 22 runs in three processes of its own
     (``--cpu-twin``) while the card runs 19-24.

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Details go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import argparse
import atexit
import contextlib
import ctypes
import json
import math
import os
import pathlib
import re
import subprocess
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
# The H100's rates, kept with the autotuner's cost model; every bound
# below is a kernel's cost function (``<kernel>.cost`` /
# ``bitset_ops.<kernel>_cost``), the one the dry run's roofline reads.
from repro_torch.kernels.autotune import (  # noqa: E402
    HBM_BYTES_PER_S, PEAK_FLOPS, SFU_PER_CLOCK_PER_SM, popcount_issue_s)

KERNELS = ("count_stats", "stacked_count_stats", "popcount_reduce",
           "masked_row_reduce", "flash_attention", "ssd_scan")
CSRC = "src/repro_torch/kernels/csrc/{}.cu"
REPLACES = {"count_stats": "src/repro/kernels/bitset_ops.py:258",
            "stacked_count_stats": "src/repro/kernels/bitset_ops.py:374",
            "popcount_reduce": "src/repro/kernels/bitset_ops.py:416",
            "masked_row_reduce": "src/repro/kernels/bitset_ops.py:453",
            "flash_attention": "src/repro/kernels/flash_attention.py:79",
            "ssd_scan": "src/repro/kernels/ssd_scan.py:76"}

#: The rates above (``repro_torch.kernels.autotune``): H100 SXM HBM at
#: 3.35 TB/s, 989 TFLOP/s dense bf16 on the tensor cores and 67 TFLOP/s
#: float32 outside them (NVIDIA data sheet); ``__popc`` and the SFU issue
#: 16 results per clock per SM and 32-bit AND/OR 64 on compute capability
#: 9.0 (CUDA C++ Programming Guide).  The SM count and clock are read from
#: the card.

#: Where the port runs, and the sizes of each phase.
DEV = "cuda"
PARITY_NS = (1, 31, 33, 100, 300, 1000, 1025, 1500)
PARITY_LANES = (1, 7, 1024, 8192)
DRAIN = (("vc", "gnp:100:10:7", 69), ("ds", "gnp:60:10:5", 11))
DRAIN_LANES = 1024
TWIN = ("vc", "gnp:60:15:7", 64)          # solved on the card and the CPU
CELL60_LANES = 4096
STACKED_KS = (1, 4, 16, 64)
#: Phase 6's id layouts (see ``stacked_case``): ids mixed with parked
#: lanes as the service leaves them, and the extremes of sorted ids, one
#: instance and every lane parked.
STACKED_KINDS = ("mixed", "parked", "sorted", "one", "tied")
#: The service phase: 4 slots of n = 100 on 1024 lanes, 8 requests, so
#: slots are reused.  Optima from the reference's serial oracle:
#:   PYTHONPATH=src python -c "from repro import registry; \
#:     from repro.core.serial import serial_rb; \
#:     print(serial_rb(registry.problem('vc', 'gnp:100:10:7').oracle())[0])"
#: (and likewise for each instance below).
SERVICE = dict(lanes=1024, steps=64, max_n=100, slots=4, restore_lanes=512)
SERVICE_MIX = (("vc", "gnp:100:10:7", 69), ("ds", "gnp:60:10:5", 11),
               ("vc", "gnp:60:15:7", 42), ("vc", "gnp:40:20:3", 27),
               ("ds", "gnp:30:15:2", 8), ("vc", "reg:36:4:3", 21),
               ("ds", "gnp:25:20:6", 6), ("ds", "gnp:40:15:3", 8))
#: The test-sized service mix run on the card and on the CPU: rid 1
#: expires on its deadline, rid 3 on its node budget, rid 4 is cancelled
#: before round 10 while it runs.
SVC_TWIN_MIX = (("vc", "gnp:20:30:5", {}),
                ("ds", "gnp:16:30:7", {"deadline_rounds": 2}),
                ("vc", "reg:18:3:2", {"priority": 3}),
                ("ds", "gnp:18:25:4", {"node_budget": 40}),
                ("vc", "gnp:16:35:9", {}), ("ds", "gnp:14:25:2", {}))
SVC_TWIN_CANCEL = (4, 9)
#: A solve checkpointed on the card and resumed on the CPU (optimum from
#: the serial oracle, as above).
SOLVE_CKPT = ("vc", "gnp:60:15:7", 42)
#: Phase 14: a graph of more than 1024 vertices (w = 35 words), one
#: bootstrap round and 2 more at full width; the kernel timed at its n and
#: at n = 1500 (w = 47).
WIDE = ("vc", "gnp:1100:1:3")
WIDE_LANES = 1024
WIDE_BOOT, WIDE_ROUNDS = 1, 2
WIDE_TIMED = (("gnp:1100:1:3", 1024), ("gnp:1500:1:3", 1024))
#: Phases 15-17: telemetry on the card, traced against bare.  Traces go to
#: ``TRACES``; ``--telemetry-repeats`` sets the pairs of phases 15 and 17.
TELEMETRY_DRAIN = DRAIN[0]
TRACES = ROOT / "chiprun_out" / "traces"
#: Phase 18: subset sum at 1024 lanes (n >= 30; on an H100 it drains in
#: about 4 s, and so does its twin on the host's CPU).
SUBSET_SUM = "ss:36:0"
#: Phases 19-22: the mesh.  ``MESH_SHARDS`` shards on one card (a mesh may
#: repeat a device), ``MESH_LANES`` lanes each: phase 3's drain at its
#: width, checkpointed after round ``CHECKPOINT_ROUND`` and resumed on
#: each layout of ``ELASTIC_ON`` (shards, lanes per shard); its first
#: ``MESH_CHECK_ROUNDS`` rounds held against the CPU.  cell60 at
#: ``MESH_CELL60_LANES`` a shard for ``MESH_CELL60_ROUNDS`` rounds (one a
#: bootstrap round).  Phase 7's mix on ``MESH_SERVICE`` (shards, lanes),
#: resized to ``RESIZE_TO`` at round ``RESIZE_AT`` and saved at round
#: ``SAVE_AT``, then restored on ``MESH_SERVICE``.
DEV_MESH = "cuda:0"
MESH_SHARDS = 4
MESH_DRAIN = DRAIN[0]
MESH_LANES = 256
MESH_CHECK_ROUNDS = 5
CHECKPOINT_ROUND = 10
ELASTIC_ON = ((2, 512), (1, 1024))
MESH_CELL60_LANES = 1024
MESH_CELL60_ROUNDS = 3
MESH_SERVICE = (2, 512)
RESIZE_AT, RESIZE_TO, SAVE_AT = 12, (4, 256), 24
#: Phase 24: both routes of the count kernels at each (n, lanes), n from 1
#: to 32 words a row (cell60's root shape and the service's among them),
#: ``stacked_count_stats`` on ``ROUTE_K`` tables.
ROUTE_SHAPES = ((31, 7), (100, 1024), (300, 4096), (1024, 1024))
ROUTE_K = 4
#: The CPU's side of phases 19, 20 and 22 runs beside the card's phases
#: 19-24, each part in a process of its own (``--cpu-twin``) on
#: ``TWIN_THREADS`` threads: the drain's first rounds, cell60's (a round
#: there takes tens of seconds, so no round starts after
#: ``TWIN_CELL60_BUDGET_S``) and the service's schedule.  They are stopped
#: ``TWIN_WAIT_S`` after their start.
TWIN_PARTS = ("drain", "cell60", "service")
TWIN_THREADS = 2
TWIN_CELL60_BUDGET_S = 30
TWIN_WAIT_S = 600
#: Phase 25, the host-sync audit: whole rounds of ``Solver.solve`` of
#: ``SYNC_SOLVE`` (``DRAIN_LANES`` lanes; on the mesh ``MESH_SHARDS`` x
#: ``MESH_LANES``), ``SYNC_ROUNDS`` rounds and one fewer, counted under
#: ``set_sync_debug_mode("warn")``: the syncs of a round are the
#: difference.  ``SYNCS_PER_ROUND`` is what each path must show, and the
#: line that makes each sync: the round's readback of its open work (and,
#: on one device, the deepest task received) in
#: ``src/repro_torch/core/round_graph.py::read_back`` and, when traced,
#: the collector's one ``flat.cpu()`` (``obs/collect.py``, ``_read``).
SYNC_SOLVE = DRAIN[0][:2]
SYNC_ROUNDS = 2
SYNCS_PER_ROUND = {"one device, bare": 1, "one device, traced": 2,
                   "mesh, bare": 1}
#: The round functions run under ``set_sync_debug_mode("warn")`` for
#: ``AUDIT_ROUNDS`` rounds: cell60's (from phase 4's lanes), the service's
#: and subset sum's; the mesh's (from phase 20's lanes) for one.  Each
#: round must make exactly ``ROUND_FN_SYNCS`` syncs: its readback.
AUDIT_ROUNDS = 2
ROUND_FN_SYNCS = 1
#: The kernel library's phases.  The bitset pair at cell60's shape and a
#: sweep; attention at the full width of two of the repo's model
#: configurations (src/repro/configs: qwen2_7b, gemma2_27b) and a sweep
#: at small S; SSD at mamba2_130m's width and a sweep.
REDUCE_NS = (1, 31, 32, 33, 100, 300, 1024, 1025, 1500)
REDUCE_LANES = (1, 7, 1024, 4096)
#: (name, B, S, H, G, hd, window, softcap, query_scale, dtype)
ATTN_FULL = (("qwen2_7b", 1, 4096, 28, 4, 128, None, 0.0, None, "bf16"),
             ("gemma2_27b", 1, 8192, 32, 16, 128, 4096, 50.0, 1 / 12,
              "bf16"))
ATTN_SWEEP = (("f32", 1, 256, 4, 4, 64, None, 0.0, None, "f32"),
              ("f32 window", 2, 512, 4, 4, 64, 128, 0.0, None, "f32"),
              ("f32 softcap", 1, 256, 4, 2, 64, None, 50.0, None, "f32"),
              ("f32 r=7", 1, 256, 7, 1, 128, None, 0.0, None, "f32"),
              ("f32 hd=80 ragged", 1, 300, 4, 2, 80, None, 0.0, None,
               "f32"),
              ("bf16 hd=80 ragged", 2, 333, 8, 2, 80, 100, 30.0, None,
               "bf16"),
              ("bf16 query_scale", 1, 200, 4, 1, 128, None, 50.0, 1 / 12,
               "bf16"),
              ("bf16 hd=64 S<tile r=8", 1, 100, 8, 1, 64, None, 0.0, None,
               "bf16"),
              ("bf16 S=tile r=1", 2, 128, 4, 4, 128, None, 0.0, None,
               "bf16"),
              ("bf16 r=7 window<tile", 1, 640, 14, 2, 128, 50, 0.0, None,
               "bf16"),
              ("bf16 window>S", 1, 300, 8, 1, 80, 1000, 30.0, None,
               "bf16"))
#: flash_attention's timing: launches after one warm-up (the plain version
#: runs once: it takes tens of milliseconds).
ATTN_ITERS = 50
#: (name, B, S, H, P, G, N, chunk, dtype, dt_shift): dt is
#: softplus(N(0, 1) + dt_shift).  At -5 it lies in mamba2's range (1e-3
#: to 1e-1, a few draws either side), so a chunk carries on a sizeable
#: share of the state (held in SSD_DECAY_RANGE) and a wrong carry shows in
#: y and the state.  At +1 (dt about 1.5) the decay inside a chunk passes
#: exp(88): the case for the mask inside the exponent.
SSD_FULL = ("mamba2_130m", 4, 4096, 24, 64, 1, 128, 128, "bf16", -5.0)
SSD_SWEEP = (("f32", 1, 256, 4, 64, 1, 128, 64, "f32", -5.0),
             ("f32 G=2", 1, 256, 4, 64, 2, 64, 128, "f32", -5.0),
             ("f32 ragged", 2, 300, 4, 32, 2, 64, 64, "f32", -5.0),
             ("f32 fast decay", 1, 256, 4, 64, 1, 128, 128, "f32", 1.0),
             ("bf16 G=2 ragged", 2, 1000, 8, 64, 2, 128, 128, "bf16",
              -5.0))
SSD_DECAY_RANGE = (0.05, 0.95)
#: Phase 26, LM serving: ``LM_ARCH`` at full width and depth in bf16,
#: weights from the port's init (a generator seeded ``LM_SEED`` on the
#: card).  A batched prefill of ``LM_REQUESTS`` prompts of ``LM_PROMPT``
#: tokens (the launcher's path; every kernel launch held against its
#: plain version, then ``LM_PREFILL_REPEATS`` timed), then
#: ``BatchedServer`` with ``LM_SLOTS`` slots serving the same prompts for
#: ``LM_NEW`` tokens each.  ``LM_TWIN``: (B, S, decode steps) of one hybrid
#: group at full width on the card and on the CPU.  ``LM_DENSE``: (arch,
#: layers, B, S, decode steps) of the dense path the same way.  Both held
#: within ``LM_TOL`` (the reference's serving check, rtol = atol).
LM_ARCH = "zamba2-2.7b"
LM_SEED = 26
LM_REQUESTS, LM_SLOTS, LM_PROMPT, LM_NEW = 4, 4, 1024, 32
LM_PREFILL_REPEATS = 3
LM_TWIN = (2, 256, 8)
LM_DENSE = ("qwen2-7b", 2, 1, 256, 4)
LM_TOL = 0.08
#: Phase 27, LM serving of the moe, vlm and audio families and the int8
#: KV cache, in bf16 at full width, weights from the port's init (a
#: generator seeded ``FAMILY_SEED`` on the card), depth cut where the
#: card's 80 GB or the phase's time forces it.  ``FAMILY_SERVE``: (arch,
#: layers (None: all), slots = requests, prompt tokens, new tokens,
#: kv_quant runs) through ``BatchedServer``; mixtral's 6144-token prompts
#: pass its 4096-token window, so the kernel's window and the rolling
#: cache both act.  ``FAMILY_LAUNCHER``: (arch, layers, B, S, decode
#: steps) through the launcher's path with its vision input.
#: ``FAMILY_TWIN``: (B, S, decode steps) of the four smoke configurations
#: on the card and the CPU; ``MOE_LAYER_TWIN``: (B, S) of mixtral's first
#: layer at full width fed one input on both sides.
FAMILY_SEED = 27
FAMILY_SERVE = (("mixtral-8x22b", 4, 2, 6144, 16, (False,)),
                ("llama4-scout-17b-a16e", 4, 4, 1024, 16, (False, True)),
                ("musicgen-large", None, 4, 1024, 32, (False,)))
FAMILY_LAUNCHER = ("internvl2-76b", 4, 2, 1024, 8)
FAMILY_TWIN = (2, 40, 3)
MOE_LAYER_TWIN = (1, 128)
#: The MoE's steps, profiled as ranges of one mixtral prefill.
MOE_STEPS = ("route", "dispatch", "gather_tokens", "expert_ffn", "combine")
#: Phase 28, LM training: ``TRAIN_ARCH`` at full width and depth through
#: the launcher's ``train()`` (f32 masters, bf16 compute, ``remat="full"``,
#: one microbatch, AdamW), ``TRAIN_STEPS`` steps of ``TRAIN_BATCH`` x
#: ``TRAIN_SEQ`` tokens from the port's pipeline; then one step with every
#: sync an error and each gradient leaf checked, one profiled step, and the
#: two kernels' gradient Function on that step's live inputs.
#: ``TRAIN_TWINS``: (arch, groups (None: the smoke configuration), B, S) run
#: one step on the card and on the CPU from the same parameters and batch:
#: the loss within ``TRAIN_LOSS_TOL`` (relative), the gradient norm and
#: the whole gradient within ``TRAIN_GRAD_TOL`` (normalised error ||card -
#: cpu|| / ||cpu||), the parameters after the step within 2 lr + 1e-6 (a
#: gradient near zero may flip the sign of Adam's first update); then the
#: gradients in float32 compute, the loss and every leaf within
#: ``TRAIN_F32_TOL`` (relative, normalised).  ``TRAIN_RESUME``: (arch, B,
#: S, steps, checkpoint step) through ``train()`` at full width and depth,
#: resumed from the checkpoint: the unbroken run's losses within
#: ``TRAIN_RESUME_TOL`` (absolute; the card's atomics may reorder a sum).
#: ``TRAIN_MESH``: shards of ``cuda:0`` for ``compressed_psum`` and
#: ``pipeline_forward``, held to the CPU's.
TRAIN_ARCH = "zamba2-2.7b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 1024, 3
TRAIN_SEED = 28
TRAIN_TWINS = (("zamba2-2.7b", None, 2, 64), ("zamba2-2.7b", 1, 1, 128))
TRAIN_LOSS_TOL = 1e-2
TRAIN_GRAD_TOL = 5e-2
TRAIN_F32_TOL = 1e-2
TRAIN_RESUME = ("mamba2-130m", 8, 256, 20, 10)
TRAIN_RESUME_TOL = 1e-3
TRAIN_MESH = 4
#: Phase 29, the dry run (``repro_torch.launch.dryrun``), on the host's
#: CPU in processes of its own (``--dry-run PART PATH`` and the
#: launcher's ``--all``) started after phase 1 and collected in phase 29
#: (``DRYRUN_WAIT_S`` at most from their start).  ``DRYRUN_MEASURED``:
#: (arch, shape, card batch) modelled and measured on the card: phase
#: 28's training step (its measured peak), then four cells of ``--all``;
#: each modelled peak within ``PEAK_TOL`` of the measured one, or within
#: ``PEAK_SLACK`` bytes where that is larger (cuBLAS's workspace is a
#: fixed cost that weighs on the small cells).  ``DRYRUN_TRAIN``: phase
#: 28's settings.  ``DRYRUN_SOLVER``: the solver round on the production
#: mesh (16 x 16 placeholder shards, 8 lanes each, 256 steps), its
#: instance cut to n = 64: each placeholder's replay of its received
#: tasks, one ``apply`` per index position, costs the host about 8 s at
#: the reference's n = 512.  ``GUIDED_COST_TOL``: the guided decode's
#: optimum on the card against the CPU's, in the example's integer units
#: (1e-3 nats) over its ``DEPTH`` steps.
DRYRUN_TAG = "chip"
DRYRUN_WAIT_S = 900
DRYRUN_TRAIN = dict(microbatches=1, block_q=64, block_k=64)
DRYRUN_MEASURED = (("zamba2-2.7b", "train_4x1024", TRAIN_BATCH),
                   ("zamba2-2.7b", "prefill_32k", 1),
                   ("mamba2-130m", "train_4k", 1),
                   ("mamba2-130m", "decode_32k", 1),
                   ("mamba2-130m", "long_500k", 1))
DRYRUN_SOLVER = dict(instance="reg:64:4:1")
PEAK_TOL = 0.20
PEAK_SLACK = 64 * 2 ** 20
GUIDED_COST_TOL = 64
#: q and k are drawn at this scale, so the scores scale * q.k spread by
#: about 6 (held at MIN_SCORE_STD or more): the softmax is peaked, a
#: window changes which key wins, and the softcap bends the largest
#: scores.
QK_SCALE = 2.5
MIN_SCORE_STD = 3.0
#: Tolerances: allclose with rtol = atol = TOL (the reference's own), and
#: the normalised error ||out - want|| / ||want|| at most REL_TOL, which
#: the rounding of a bf16 output passes and a missing softcap, window or
#: state carry does not (the planted checks show that on every run).  The
#: SSD state is f32 on both sides and is held at STATE_TOL in every case.
TOL = {"bf16": 2e-2, "f32": 2e-5}
REL_TOL = {"bf16": 5e-3, "f32": 2e-5}
SSD_TOL = {"bf16": 5e-2, "f32": 1e-4}
SSD_REL_TOL = {"bf16": 5e-3, "f32": 1e-4}
STATE_TOL = 1e-4
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def sync_ms(fn):
    """(host milliseconds of ``fn()`` between two synchronizes, result)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def span_ms(run, round_no):
    """The program's own spans of round ``round_no`` of span run ``run``:
    host milliseconds of each phase by name (self times, so ``admit``
    leaves out its ``rebuild``) and ``round``, the whole round; the
    device spans of the same names are left out."""
    from repro_torch.obs import spans
    mine = [s for s in spans.RECORDER.spans(run)
            if s.round == round_no and s.rid is None and s.clock == "host"]
    own = spans.self_ns(mine)
    out = {}
    for s in mine:
        key = "round" if s.name == "round" else s.name
        add = s.duration_ns if s.name == "round" else own[s.id]
        out[key] = out.get(key, 0.0) + add / 1e6
    return out


def span_line(split):
    return ", ".join(f"{k} {v:.1f} ms" for k, v in split.items()
                     if isinstance(v, float))


# -- phase 2 ----------------------------------------------------------------

def rand_words(rng, shape):
    return rng.randint(0, 2 ** 32, size=shape, dtype=np.uint64).astype(
        np.uint32)


def random_case(rng, n, lanes):
    from repro_torch.convert import words
    from repro_torch.problems.graphs import num_words
    w = num_words(n)
    table = rand_words(rng, (n, w))
    mask = rand_words(rng, (lanes, w))
    valid = mask & rand_words(rng, (lanes, w))
    valid[:: 3] = 0                       # every third lane: nothing valid
    return words(table, DEV), words(mask, DEV), words(valid, DEV)


def tied_case(rng, n, lanes):
    """All-tied degrees: every vertex of a circulant graph has degree 4
    under the full mask, so the smallest valid id must win across thread,
    warp and block boundaries."""
    from repro_torch.convert import words
    from repro_torch.problems.graphs import circulant_graph, full_mask
    g = circulant_graph(n, (1, 7) if n > 14 else (1,))
    mask = np.broadcast_to(full_mask(n), (lanes, g.words)).copy()
    valid = mask & rand_words(rng, mask.shape)
    valid[:: 5] = mask[:: 5]
    return words(g.adj, DEV), words(mask, DEV), words(valid, DEV)


def compare(kernel_out, plain_out, what, parity):
    """Hold a kernel's output bitwise against its plain version's;
    ``parity`` is that kernel's tally (compared, mismatches, max_abs_err)."""
    torch.cuda.synchronize()
    err = int((kernel_out.long() - plain_out.long()).abs().max())
    parity["max_abs_err"] = max(parity["max_abs_err"], err)
    parity["compared"] += 1
    if not torch.equal(kernel_out, plain_out):
        parity["mismatches"] += 1
        raise RuntimeError(f"chip_smoke: kernel != plain on {what} "
                           f"(max abs err {err})")


def phase_parity(report):
    from repro_torch.kernels import bitset_degree, bitset_ops, ref
    parity = report["parity"]["count_stats"]
    rng = np.random.RandomState(0)
    shapes = []
    for n in PARITY_NS:
        for lanes in PARITY_LANES:
            for kind, make in (("random", random_case), ("tied", tied_case)):
                if kind == "tied" and n < 3:
                    continue
                table, mask, valid = make(rng, n, lanes)
                out = bitset_ops.count_stats(table, mask, valid)
                compare(out, ref.count_stats_ref(table, mask, valid),
                        f"count_stats {kind} n={n} L={lanes}", parity)
                deg = bitset_degree.degree_stats(table, mask)
                compare(deg, ref.degree_stats_ref(table, mask),
                        f"degree_stats n={n} L={lanes}", parity)
                fullm = mask[0].clone()
                dom = bitset_ops.domination_stats(table, valid, mask, fullm)
                compare(dom, ref.domination_stats_ref(table, valid, mask,
                                                      fullm),
                        f"domination_stats n={n} L={lanes}", parity)
                shapes.append((kind, n, lanes))
    print(f"phase 2: count_stats / degree_stats / domination_stats bitwise "
          f"equal to plain on {parity['compared']} calls over "
          f"{len(shapes)} cases", flush=True)


# -- phases 3 and 4 ---------------------------------------------------------

def run_solve(problem, instance, lanes, device, max_rounds=100000,
              bootstrap_rounds=4, trace_path=None):
    """One ``Solver.solve`` with the launch counts set to 0 just before;
    with ``trace_path``, traced there and metered.  Returns (result, host
    ms, count_stats launches, the solver)."""
    from repro_torch import registry
    from repro_torch.kernels import bitset_ops
    from repro_torch.solver import Solver, SolverConfig
    cfg = SolverConfig(lanes=lanes, steps_per_round=64,
                       bootstrap_rounds=bootstrap_rounds, bootstrap_steps=8,
                       max_rounds=max_rounds, device=device,
                       trace_path=None if trace_path is None
                       else str(trace_path),
                       metrics=trace_path is not None)
    handle = registry.problem(problem, instance)
    solver = Solver(cfg)
    bitset_ops.reset_launches()
    ms, res = sync_ms(lambda: solver.solve(handle))
    launches = bitset_ops.LAUNCHES["count_stats"]
    return res, ms, launches, solver


def phase_drain(report):
    for problem, instance, want in DRAIN:
        res, ms, launches, _ = run_solve(problem, instance, DRAIN_LANES,
                                         DEV)
        s = res.stats
        print(f"phase 3: {problem} {instance} lanes={DRAIN_LANES}: "
              f"optimum={s.best} "
              f"rounds={s.rounds} nodes={s.nodes} T_S={s.t_s} T_R={s.t_r} "
              f"wall={ms:.1f} ms nodes/s={s.nodes / ms * 1e3:.0f} "
              f"count_stats launches={launches}", flush=True)
        check(s.best == want, f"{problem} {instance}: optimum {s.best} != "
                              f"{want}")
        check(launches > 0, f"{problem} {instance}: count_stats never "
                            f"launched on the solve path")
        report["solves"].append(dict(problem=problem, instance=instance,
                                     lanes=DRAIN_LANES, stats=s._asdict(),
                                     wall_ms=ms, launches=launches))
        report["launches"]["count_stats"] += launches

    # The same drained solve on the card and on the CPU.
    gpu, gpu_ms, launches, _ = run_solve(*TWIN, DEV)
    cpu, cpu_ms, _, _ = run_solve(*TWIN, "cpu")
    print(f"phase 3: {' '.join(map(str, TWIN))} (problem, instance, lanes)"
          f"\n  cuda {tuple(gpu.stats)} "
          f"({gpu_ms:.0f} ms, {launches} launches)\n  cpu  "
          f"{tuple(cpu.stats)} ({cpu_ms:.0f} ms)", flush=True)
    for field in gpu.stats._fields:
        print(f"  {field:8s} cuda={getattr(gpu.stats, field)} "
              f"cpu={getattr(cpu.stats, field)}")
    check(gpu.stats == cpu.stats, "SolveStats differ between cuda and cpu")
    check(launches > 0, "count_stats never launched on the cuda solve")
    check_same_lanes(gpu.lanes, cpu.lanes, "solve twin")
    report["launches"]["count_stats"] += launches
    report["cpu_vs_cuda"] = dict(problem=TWIN[0], instance=TWIN[1],
                                 lanes=TWIN[2],
                                 stats=gpu.stats._asdict(), cuda_ms=gpu_ms,
                                 cpu_ms=cpu_ms)


def phase_cell60(report, rounds_after_boot=2):
    from repro_torch.convert import words
    from repro_torch.core import round_graph, steal
    from repro_torch.core.distributed import make_round
    from repro_torch.core.engine import init_lanes, make_expand, make_step
    from repro_torch.kernels import bitset_ops, ref
    from repro_torch.obs import spans
    from repro_torch.problems.graphs import cell60_graph
    from repro_torch.problems.vertex_cover import make_vertex_cover

    lanes_n = CELL60_LANES
    graph = cell60_graph()
    problem = make_vertex_cover(graph, device=DEV)
    adj = words(graph.adj, DEV)

    # (a) The main path: Solver.solve for 4 bootstrap + N main rounds.  The
    # root's bound, ceil(m / max degree) = 150, is the optimum of this
    # 4-regular analogue, so the search may drain before N rounds.
    res, ms, launches, _ = run_solve("vc", "cell60", lanes_n, DEV,
                                     max_rounds=4 + rounds_after_boot)
    s = res.stats
    drained = int(res.lanes.active.sum()) == 0
    print(f"phase 4: vc cell60 lanes={lanes_n} rounds={s.rounds}: "
          f"incumbent={s.best} nodes={s.nodes} T_S={s.t_s} T_R={s.t_r} "
          f"wall={ms:.1f} ms nodes/s={s.nodes / ms * 1e3:.0f} "
          f"count_stats launches={launches} drained={drained}", flush=True)
    check(s.rounds == 4 + rounds_after_boot or (drained and s.best == 150),
          f"cell60: {s.rounds} rounds, drained={drained}, best={s.best}")
    check(launches > 0, "cell60: count_stats never launched")
    report["launches"]["count_stats"] += launches
    report["solves"].append(dict(problem="vc", instance="cell60",
                                 lanes=lanes_n, stats=s._asdict(),
                                 wall_ms=ms, launches=launches))

    # (b) The same rounds driven step by step through make_step: the
    # kernel on every step's live alive masks, held against the plain
    # version, for the 4 bootstrap rounds and the first main round.
    step = make_step(problem)
    lanes = init_lanes(problem, lanes_n)
    il = lanes.idx.shape[1]
    ar = torch.arange(lanes_n, device=DEV)
    checked = 0
    for steps in [8] * 4 + [64]:
        for _ in range(steps):
            alive = lanes.stack.alive[ar, lanes.depth.clamp(0, il - 1)]
            compare(bitset_ops.count_stats(adj, alive, alive),
                    ref.count_stats_ref(adj, alive, alive),
                    "cell60 live masks", report["parity"]["count_stats"])
            checked += 1
            ran = lanes.active.any().to(torch.int32)
            lanes = step(lanes)._replace(steps=lanes.steps + ran)
        lanes = steal.balance_device(problem, lanes)
    active = int(lanes.active.sum())
    print(f"phase 4: cell60 lanes={lanes_n}: kernel == plain on the live "
          f"masks of all {checked} steps of the first 5 rounds "
          f"({active} lanes active after them)", flush=True)

    # (c) Two more rounds through the round function, as Solver.solve
    # runs them (expand, the steal and its replay, the open-work
    # readback), timed by the program's own spans.
    round_fn = make_round(problem, 64)
    run = spans.begin_run("solve")
    split = []
    for r in (1, 2):
        before = bitset_ops.LAUNCHES["count_stats"]
        passes = steal.REPLAYS["passes"]
        nodes0 = int(lanes.nodes.sum())
        with spans.span("round", run=run, round=r):
            lanes, open_work = round_fn(lanes)
            open_now = int(open_work.sum())
        launches = bitset_ops.LAUNCHES["count_stats"] - before
        passes = steal.REPLAYS["passes"] - passes
        split.append(dict(span_ms(run, r), launches=launches,
                          nodes=int(lanes.nodes.sum()) - nodes0,
                          open_work=open_now, replay_passes=passes,
                          active_after=int(lanes.active.sum())))
        check(launches == 64 + passes,
              f"launches per round: {launches} (want 64 expand steps + "
              f"the {passes} replay passes steal.REPLAYS counted, of "
              f"IDX_LEN {il})")
        check({"expand", "balance", "replay", "readback"} <= set(split[-1]),
              f"round {r}: spans {sorted(split[-1])}")
    for r in split:
        print(f"phase 4: round spans: {span_line(r)}; {r['launches']} "
              f"launches, nodes {r['nodes']}, active lanes after "
              f"{r['active_after']}", flush=True)
    report["cell60_split"] = split
    expand = make_expand(problem, 64)

    # (d) One more round under the profiler, a replay of the graph that
    # round 2 captured: the kernels the card ran held against the launches
    # counted for them (a replay adds the captured counts, it does not
    # count), and how busy the card is (its output is dropped).  Then the
    # eager expand and balance alone.
    replays = round_graph.COUNTS["replays"]
    before = bitset_ops.LAUNCHES["count_stats"]
    passes = steal.REPLAYS["passes"]
    busy = {"round": device_busy(lambda: round_fn(lanes))}
    busy["round"].pop("out")
    counted = bitset_ops.LAUNCHES["count_stats"] - before
    passes = steal.REPLAYS["passes"] - passes
    ran = busy["round"]["kernel_launches"]["count_stats"]
    check(round_graph.COUNTS["replays"] == replays + 1,
          "cell60: the profiled round did not replay the graph")
    check(counted == ran == 64 + passes,
          f"cell60: a replayed round counted {counted} count_stats "
          f"launches and the card ran {ran} (want 64 + the {passes} "
          f"replay passes steal.REPLAYS counted)")
    print(f"phase 4: profiled graph replay: wall "
          f"{busy['round']['wall_ms']:.1f} ms, device busy "
          f"{busy['round']['device_ms']:.2f} ms (share "
          f"{busy['round']['busy_share']:.3f}) over "
          f"{busy['round']['device_ops']} device operations; count_stats "
          f"ran {ran} times, counted {counted}", flush=True)
    for name, fn in (("expand", expand),
                     ("balance", lambda l: steal.balance_device(problem, l))):
        busy[name] = device_busy(lambda: fn(lanes))
        lanes = busy[name].pop("out")
        print(f"phase 4: profiled {name}: wall {busy[name]['wall_ms']:.1f} ms, "
              f"device busy {busy[name]['device_ms']:.2f} ms "
              f"(share {busy[name]['busy_share']:.3f}) over "
              f"{busy[name]['device_ops']} device operations, count_stats "
              f"{busy[name]['kernel_ms']['count_stats']:.2f} ms", flush=True)
    report["cell60_busy"] = busy
    return lanes


def is_kernel(name, key):
    """Does the profiler's ``key`` (mangled or demangled) name a kernel of
    ``csrc/<name>.cu`` (``<name>_kernel`` or ``<name>_<pass>_kernel``)?
    ``count_stats`` must not match ``stacked_count_stats``."""
    return re.search(r"(?<![A-Za-z_])" + name + r"(_\w+)?_kernel",
                     key) is not None


#: Kernel name patterns of ``device_busy``'s groups (first match wins).
KERNEL_GROUPS = (("flash_attention", r"flash_attention"),
                 ("ssd_scan", r"ssd_scan"),
                 ("GEMM", r"gemm|nvjet|xmma|cutlass|cublas"),
                 ("reduction", r"reduce|norm|softmax"),
                 ("copy/cat/fill", r"copy|cat|fill|memcpy|memset|index|pad"),
                 ("elementwise", r"elementwise|vectorized|unrolled"))


def device_busy(fn):
    """Wall time of ``fn()`` between two synchronizes, and the device time
    the profiler records inside it: the events that ran on the card
    (kernels, copies), not the host operations that launched them, which
    carry the same time again (``all_events_ms`` sums both).  With each
    of the port's kernels' share and the times the card ran it,
    the time of each group of ``KERNEL_GROUPS`` and the 5 longest
    kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_ms, out = sync_ms(fn)
    device_us, all_us, ops = 0.0, 0.0, 0
    kernel_us = dict.fromkeys(KERNELS, 0.0)
    kernel_n = dict.fromkeys(KERNELS, 0)
    groups = dict.fromkeys([g for g, _ in KERNEL_GROUPS] + ["other"], 0.0)
    by_name = {}
    for evt in prof.key_averages():
        us = evt.self_device_time_total
        all_us += us
        if us <= 0 or evt.device_type != DeviceType.CUDA:
            continue
        device_us += us
        ops += evt.count
        by_name[evt.key] = by_name.get(evt.key, 0.0) + us
        for name in KERNELS:
            if is_kernel(name, evt.key):
                kernel_us[name] += us
                kernel_n[name] += evt.count
        groups[next((g for g, pat in KERNEL_GROUPS
                     if re.search(pat, evt.key, re.IGNORECASE)),
                    "other")] += us
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return dict(wall_ms=wall_ms, device_ms=device_us / 1e3,
                busy_share=device_us / 1e3 / wall_ms, device_ops=ops,
                all_events_ms=all_us / 1e3,
                kernel_ms={k: v / 1e3 for k, v in kernel_us.items()},
                kernel_launches=kernel_n,
                groups_ms={g: us / 1e3 for g, us in groups.items()},
                top_ms=[(k[:80], us / 1e3) for k, us in top], out=out)


# -- phase 5 ----------------------------------------------------------------

def rate_bound(cost):
    """(bound in ms, what bounds it) of a kernel's ``KernelCost``: the
    larger of its operations at the card's peak rate for them and its
    bytes over HBM's rate."""
    seconds, bound_by = cost.bound()
    return seconds * 1e3, bound_by


def events_ms(fn, iters):
    """CUDA-event milliseconds per call of ``fn`` over ``iters`` calls,
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def profiled_ms(fn, name, iters, attempts=3):
    """The profiler's device time per launch of each kernel of
    ``csrc/<name>.cu`` over ``iters`` calls of ``fn``, and their sum, the
    time of one call (``ssd_scan`` launches three passes, the others one
    kernel); (None, {}) if no attempt records at least half of the
    launches of each kernel (the caller then keeps the CUDA-event time).
    Each kernel's time is averaged over the launches the profiler
    recorded."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total, count = {}, {}
        for evt in prof.key_averages():
            if is_kernel(name, evt.key) and evt.device_time_total:
                kernel = re.search(name + r"\w*_kernel", evt.key).group(0)
                total[kernel] = total.get(kernel, 0.0) + evt.device_time_total
                count[kernel] = count.get(kernel, 0) + evt.count
        if total and min(count.values()) >= iters / 2:
            parts = {k: total[k] / count[k] / 1e3 for k in total}
            return sum(parts.values()), parts
    return None, {}


def measure(name, kernel, plain, iters, plain_iters, bound_ms,
                        bound_by, library=None, **shape):
    """The kernel of ``csrc/<name>.cu`` timed on one input (profiler device
    time, else CUDA events), with its plain version, the PyTorch call that
    computes the same function where there is one, and the bound."""
    ev_ms = events_ms(kernel, iters)
    prof_ms, parts = profiled_ms(kernel, name, max(1, min(iters, 20)))
    plain_ms = events_ms(plain, plain_iters)
    library_ms = events_ms(library, iters) if library is not None else None
    return dict(shape, ms=prof_ms if prof_ms is not None else ev_ms,
                ms_source="profiler" if prof_ms is not None else "events",
                ms_events=ev_ms, ms_profiler=prof_ms, kernels_ms=parts,
                plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def kernel_times(table, mask, valid, clock_hz, sms):
    """``count_stats`` timed on one input, against ``autotune.roofline``:
    its binary products run on the tensor cores, so the bound is the bytes
    of reading each input once and writing the output once.  Beside it
    stands the popcount-issue bound of the same work on the CUDA cores
    (the popcounts of every valid vertex), which bounded its first,
    CUDA-core design."""
    from repro_torch.kernels import bitset_ops, ref
    from repro_torch.kernels.ref import bit_set
    n, w = table.shape
    lanes = mask.shape[0]
    n_valid = int(bit_set(valid, n).sum())
    cost = bitset_ops.count_stats_cost(table, mask, valid, sms=sms,
                                       clock_hz=clock_hz)
    return measure("count_stats",
                   lambda: bitset_ops.count_stats(table, mask, valid),
                   lambda: ref.count_stats_ref(table, mask, valid), 200, 20,
                   *rate_bound(cost), popcounts=n_valid * w,
                   bytes=cost.nbytes, popc_bound_ms=popcount_issue_s(
                       n_valid * w, sms, clock_hz) * 1e3,
                   n=n, w=w, L=lanes, valid_pairs=n_valid)


def live_alive(lanes):
    """Each lane's alive mask at its current depth: what the next engine
    step hands the kernel."""
    il = lanes.idx.shape[1]
    ar = torch.arange(lanes.idx.shape[0], device=DEV)
    return lanes.stack.alive[ar, lanes.depth.clamp(0, il - 1)]


def phase_timing(cell60_lanes, report):
    """The kernel at (n=300, w=10, L=4096) and (n=100, w=4, L=1024).  At
    cell60's shape it is timed on the heaviest masks of that shape (every
    lane at the root: all 300 vertices alive, L*n*w = 12.3 M popcounts)
    and on the live masks the search left; at the small shape on the live
    masks of a saturated ``vc gnp:100:10:7`` solve."""
    from repro_torch.convert import words
    from repro_torch.problems.graphs import (cell60_graph, full_mask,
                                             parse_graph_instance)
    clock_hz = float(smi("clocks.max.sm").split()[0]) * 1e6
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    adj = words(cell60_graph().adj, DEV)
    root = words(np.broadcast_to(full_mask(300), (CELL60_LANES, 10)).copy(),
                 DEV)
    full = dict(kernel_times(adj, root, root, clock_hz, sms),
                masks="cell60, every lane at the root")
    alive = live_alive(cell60_lanes)
    live = dict(kernel_times(adj, alive, alive, clock_hz, sms),
                masks="cell60, live masks after the split rounds")

    problem, instance, _ = DRAIN[0]
    res, _, _, _ = run_solve(problem, instance, DRAIN_LANES, DEV,
                             max_rounds=14)
    alive = live_alive(res.lanes)
    small = dict(kernel_times(words(parse_graph_instance(instance).adj, DEV),
                              alive, alive, clock_hz, sms),
                 masks=f"{instance}, live masks after 14 rounds "
                       f"({int(res.lanes.active.sum())} lanes active)")
    for t in (full, live, small):
        print(f"phase 5: count_stats n={t['n']} w={t['w']} L={t['L']} "
              f"({t['masks']}): kernel {t['ms'] * 1e3:.2f} us "
              f"({t['ms_source']}; events {t['ms_events'] * 1e3:.2f} us), "
              f"plain {t['plain_ms'] * 1e3:.1f} us, bound "
              f"{t['bound_ms'] * 1e3:.3f} us ({t['bound_by']}: "
              f"{t['bytes']} bytes); popcount issue of the same work "
              f"{t['popc_bound_ms'] * 1e3:.3f} us ({t['popcounts']} "
              f"popcounts)", flush=True)
    report["timing"] = [full, live, small]
    report["clock_max_sm_hz"] = clock_hz
    report["sms"] = sms
    return full, live, small


# -- phase 6 ----------------------------------------------------------------

def stacked_case(rng, k, n, lanes, kind):
    """Inputs of ``stacked_count_stats``: random tables with mixed ids (a
    third of the lanes parked), the same with every lane parked, with ids
    sorted (each instance's lanes together, none parked) or all on one
    instance, or circulant tables, whose counts all tie under the full
    mask (ids mixed)."""
    from repro_torch.convert import words
    from repro_torch.problems.graphs import (circulant_graph, full_mask,
                                             num_words)
    w = num_words(n)
    if kind == "tied":
        tables = np.stack([circulant_graph(n, (1, 2 + s)).adj
                           for s in range(k)])
        mask = np.broadcast_to(full_mask(n), (lanes, w)).copy()
    else:
        tables = rand_words(rng, (k, n, w))
        mask = rand_words(rng, (lanes, w))
    valid = mask & rand_words(rng, (lanes, w))
    valid[1::5] = mask[1::5]
    inst = rng.randint(0, k, size=lanes).astype(np.int32)
    inst[::3] = -1
    if kind == "parked":
        inst[:] = -1
    elif kind == "sorted":
        inst = np.sort(rng.randint(0, k, size=lanes)).astype(np.int32)
    elif kind == "one":
        inst[:] = k - 1
    return (words(tables, DEV), torch.from_numpy(inst).to(DEV),
            words(mask, DEV), words(valid, DEV))


def phase_stacked_parity(report):
    from repro_torch.kernels import bitset_ops, ref
    parity = report["parity"]["stacked_count_stats"]
    rng = np.random.RandomState(1)
    parked_row = torch.tensor([-1, -1, 0, 0], dtype=torch.int32, device=DEV)
    cases = 0
    for k in STACKED_KS:
        for n in PARITY_NS:
            for lanes in PARITY_LANES:
                for kind in STACKED_KINDS:
                    if kind == "tied" and n < 3:
                        continue
                    tables, inst, mask, valid = stacked_case(rng, k, n,
                                                             lanes, kind)
                    out = bitset_ops.stacked_count_stats(tables, inst, mask,
                                                         valid)
                    compare(out, ref.stacked_count_stats_ref(tables, inst,
                                                             mask, valid),
                            f"stacked_count_stats {kind} K={k} n={n} "
                            f"L={lanes}", parity)
                    check(bool((out[inst < 0] == parked_row).all()),
                          f"parked lanes not (-1, -1, 0, 0) at K={k} n={n} "
                          f"L={lanes}")
                    cases += 1
    print(f"phase 6: stacked_count_stats bitwise equal to plain on {cases} "
          f"cases (mixed ids with parked lanes, all parked, sorted ids, one "
          f"instance, all tied)", flush=True)


# -- phases 7 to 9 ----------------------------------------------------------

def new_service(device, lanes, steps, max_n, slots, **telemetry):
    from repro_torch.solver import Solver, SolverConfig
    return Solver(SolverConfig(lanes=lanes, steps_per_round=steps,
                               device=device, **telemetry)).serve(
        max_n=max_n, slots=slots)


def submit_all(svc, mix):
    """Submit ``(family, spec, lifecycle kwargs)`` as rids 0, 1, ...;
    returns the tickets."""
    from repro_torch.problems.graphs import parse_graph_instance
    from repro_torch.service import SolveRequest
    return [svc.submit(SolveRequest(rid=rid, graph=parse_graph_instance(spec),
                                    family=family, **kw))
            for rid, (family, spec, kw) in enumerate(mix)]


def check_optima(results, what):
    for rid, (family, spec, want) in enumerate(SERVICE_MIX):
        res = results[rid]
        check(res.status == "done" and res.optimum == want,
              f"{what}: rid {rid} {family} {spec}: {res.status} "
              f"{res.optimum} (want done {want})")


def check_same_lanes(a, b, what):
    from repro_torch.convert import to_numpy
    a_np, b_np = to_numpy(a), to_numpy(b)
    for field in a_np._fields:
        for x, y in zip(*((v,) if isinstance(v, np.ndarray) else tuple(v)
                          for v in (getattr(a_np, field),
                                    getattr(b_np, field)))):
            check(np.array_equal(x, y), f"{what}: lanes.{field} differ")


def phase_service(report):
    """The main path of the slice: ``Solver.serve`` at full width, drained,
    with the launch counts set to 0 just before and read just after."""
    from repro_torch.core import checkpoint as ckpt
    from repro_torch.core import steal
    from repro_torch.kernels import bitset_ops
    cfg = SERVICE
    svc = new_service(DEV, cfg["lanes"], cfg["steps"], cfg["max_n"],
                      cfg["slots"])
    submit_all(svc, [(f, s, {}) for f, s, _ in SERVICE_MIX])
    bitset_ops.reset_launches()
    ckpt.reset_rebuilds()
    steal.reset_replays()
    ms, results = sync_ms(svc.drain)
    launches = dict(bitset_ops.LAUNCHES)
    rebuilds = dict(ckpt.REBUILDS)
    replays = dict(steal.REPLAYS)
    check_optima(results, "service")
    # Expand steps, then the passes of the replay chunks each round ran.
    per_round = f"{cfg['steps']} + the replay passes"
    extra = (launches["stacked_count_stats"] - svc.rounds * cfg["steps"]
             - replays["passes"])
    # Every admission seeds roots (no pending pool): its rebuild replays
    # the seeded lanes alone, in 0 passes, and launches nothing.
    check(extra == rebuilds["passes"] == 0
          and replays["rounds"] == svc.rounds
          and rebuilds["lanes"] == len(SERVICE_MIX),
          f"service: {launches['stacked_count_stats']} stacked_count_stats "
          f"launches in {svc.rounds} rounds (want {per_round} per round, "
          f"replays {replays}, and none per admission rebuild); rebuilds "
          f"{rebuilds} (want 0 passes over {len(SERVICE_MIX)} seeded "
          f"lanes)")
    check(launches["count_stats"] == 0,
          "service: the single-table count_stats ran on the service path")
    nodes = int(svc.lanes.nodes.sum())
    print(f"phase 7: service lanes={cfg['lanes']} slots={cfg['slots']} "
          f"max_n={cfg['max_n']}: {len(SERVICE_MIX)} requests drained to "
          f"their serial optima in {svc.rounds} rounds, wall={ms:.1f} ms, "
          f"instances/s={len(SERVICE_MIX) / ms * 1e3:.3f}, nodes={nodes} "
          f"nodes/s={nodes / ms * 1e3:.0f}, stacked_count_stats "
          f"launches={launches['stacked_count_stats']} ({per_round} per "
          f"round: {replays['passes']} passes in {replays['chunks']} "
          f"chunks, {replays['no_receiver']} rounds without a receiver, "
          f"against {replays['full_passes']} for whole replays); "
          f"{rebuilds['calls']} admission rebuilds of "
          f"{rebuilds['lanes']} lanes in {rebuilds['passes']} passes",
          flush=True)
    for rid, (family, spec, _) in enumerate(SERVICE_MIX):
        res = results[rid]
        print(f"  rid={rid} {family}[{spec}] optimum={res.optimum} rounds="
              f"{res.admitted_round}..{res.retired_round}", flush=True)
    report["service"] = dict(
        lanes=cfg["lanes"], slots=cfg["slots"], max_n=cfg["max_n"],
        steps_per_round=cfg["steps"], rounds=svc.rounds, wall_ms=ms,
        requests=len(SERVICE_MIX), nodes=nodes, launches=launches,
        rebuilds=rebuilds, replays=replays,
        results={rid: [r.optimum, r.admitted_round, r.retired_round]
                 for rid, r in results.items()})
    report["launches"]["stacked_count_stats"] += launches[
        "stacked_count_stats"]
    return svc, ms


def phase_service_steps(report, check_rounds=3):
    """The same service again: its first rounds with every kernel launch
    held against the plain version on the live inputs, then two rounds
    timed by the service's own spans, and one round under the profiler.  Returns the service (mid-run) and its live
    kernel inputs."""
    from repro_torch.core import round_graph, steal
    from repro_torch.core.api import tree_map
    from repro_torch.kernels import bitset_ops, ref
    from repro_torch.obs import spans
    from repro_torch.service import batch_problem
    cfg = SERVICE
    parity = report["parity"]["stacked_count_stats"]
    svc = new_service(DEV, cfg["lanes"], cfg["steps"], cfg["max_n"],
                      cfg["slots"])
    submit_all(svc, [(f, s, {}) for f, s, _ in SERVICE_MIX])

    # (a) The bound problem looks the kernel up at call time: route it
    # through a check for the first rounds (expand steps, steal replay and
    # admission rebuilds alike).
    kernel = batch_problem.stacked_count_stats
    checked = [0]

    def checked_kernel(tables, inst, mask, valid):
        out = kernel(tables, inst, mask, valid)
        compare(out, ref.stacked_count_stats_ref(tables, inst, mask, valid),
                "service live inputs", parity)
        checked[0] += 1
        return out

    batch_problem.stacked_count_stats = checked_kernel
    failed = round_graph.COUNTS["capture_failed"]
    try:
        for _ in range(check_rounds):
            svc.step_round()
    finally:
        batch_problem.stacked_count_stats = kernel
    print(f"phase 7: kernel == plain on all {checked[0]} launches of the "
          f"first {check_rounds} service rounds (slots {svc.slot_rid})",
          flush=True)
    # The check reads the kernel's output back to the host, which a CUDA
    # graph's capture refuses: those rounds ran eager after the warm-up.
    # (b) and (c) run the same body in a fresh graph: the first round of
    # (b) warms it, the second captures and replays, (c) replays.
    check(round_graph.COUNTS["capture_failed"] == failed + check_rounds - 1,
          "service: the checked rounds did not fall back to eager")
    svc._round = round_graph.GraphedRound(
        svc._round.plan, svc._round.chunk, svc._round.chunks)

    # (b) Two more rounds of the service, timed by its own spans: the
    # admission and its rebuild, expand, balance, replay, the readback,
    # retirement.
    run = spans.newest_run("service")
    split = []
    for _ in range(2):
        before = bitset_ops.LAUNCHES["stacked_count_stats"]
        svc.step_round()
        split.append(dict(
            span_ms(run, svc.rounds),
            launches=bitset_ops.LAUNCHES["stacked_count_stats"] - before,
            active_after=int(svc.lanes.active.sum())))
        check({"admit", "expand", "balance", "replay", "readback",
               "retire"} <= set(split[-1]),
              f"service round {svc.rounds}: spans {sorted(split[-1])}")
    for r in split:
        print(f"phase 7: service round spans: {span_line(r)}; "
              f"{r['launches']} launches, active lanes after "
              f"{r['active_after']}", flush=True)
    report["service_split"] = split

    # (c) One service round under the profiler, a replay of the graph (its
    # result is dropped): the kernels the card ran held against the
    # launches counted for them.
    replays = round_graph.COUNTS["replays"]
    before = bitset_ops.LAUNCHES["stacked_count_stats"]
    passes = steal.REPLAYS["passes"]
    busy = device_busy(lambda: svc._round(svc.lanes))
    busy.pop("out")
    counted = bitset_ops.LAUNCHES["stacked_count_stats"] - before
    passes = steal.REPLAYS["passes"] - passes
    ran = busy["kernel_launches"]["stacked_count_stats"]
    check(round_graph.COUNTS["replays"] == replays + 1,
          "service: the profiled round did not replay the graph")
    check(counted == ran == cfg["steps"] + passes,
          f"service: a replayed round counted {counted} stacked_count_stats "
          f"launches and the card ran {ran} (want {cfg['steps']} + the "
          f"{passes} replay passes steal.REPLAYS counted)")
    print(f"phase 7: profiled service round (graph replay): wall "
          f"{busy['wall_ms']:.1f} ms, "
          f"device busy {busy['device_ms']:.2f} ms (share "
          f"{busy['busy_share']:.3f}) over {busy['device_ops']} device "
          f"operations, stacked_count_stats "
          f"{busy['kernel_ms']['stacked_count_stats']:.2f} ms, ran {ran} "
          f"times, counted {counted}", flush=True)
    report["service_busy"] = busy

    # The kernel's live inputs at this point, for the timing phase.
    ar = torch.arange(svc.num_lanes, device=DEV)
    d = svc.lanes.depth.clamp(0, svc.lanes.idx.shape[1] - 1)
    states = tree_map(lambda x: x[ar, d], svc.lanes.stack)
    inst, mask, valid = svc.spec.stats_inputs(svc._tables_dev, states)
    live = (svc._tables_dev.adj, inst.contiguous(), mask.contiguous(),
            valid.contiguous())
    return svc, live


def phase_service_twin(report, lanes=16, slots=3, steps=6):
    """The test-sized mix (a deadline, a budget, a cancel) on the card and
    on the CPU, compared after every round."""
    from repro_torch import registry
    from repro_torch.core.serial import serial_rb
    from repro_torch.kernels import bitset_ops
    gpu, cpu = (new_service(d, lanes, steps, 20, slots) for d in (DEV, "cpu"))
    tickets = [submit_all(svc, SVC_TWIN_MIX) for svc in (gpu, cpu)]
    bitset_ops.reset_launches()
    rid_cancel, at_round = SVC_TWIN_CANCEL
    while cpu._has_work():
        check(gpu._has_work(), "twin: the card's service drained early")
        if cpu.rounds == at_round:
            for ticket in (t[rid_cancel] for t in tickets):
                check(ticket.status.value == "running",
                      f"twin: rid {rid_cancel} not running at round "
                      f"{at_round}")
                check(ticket.cancel(), "twin: cancel failed")
        open_gpu, open_cpu = gpu.step_round(), cpu.step_round()
        where = f"twin round {cpu.rounds}"
        check(np.array_equal(open_gpu, open_cpu), f"{where}: open work")
        check_same_lanes(gpu.lanes, cpu.lanes, where)
        check(gpu.slot_rid == cpu.slot_rid and gpu.rounds == cpu.rounds,
              f"{where}: slots or rounds differ")
        check({r: (t.status, t.nodes_used) for r, t in gpu.tickets.items()}
              == {r: (t.status, t.nodes_used)
                  for r, t in cpu.tickets.items()}, f"{where}: tickets")
        check(sorted(gpu.results) == sorted(cpu.results), f"{where}: results")
        for rid, b in cpu.results.items():
            a = gpu.results[rid]
            check((a.optimum, a.admitted_round, a.retired_round, a.status)
                  == (b.optimum, b.admitted_round, b.retired_round, b.status)
                  and np.array_equal(a.payload, b.payload),
                  f"{where}: result of rid {rid}")
    check(not gpu._has_work(), "twin: the card's service did not drain")
    launches = bitset_ops.LAUNCHES["stacked_count_stats"]
    check(launches > 0, "twin: stacked_count_stats never launched")
    status = {rid: r.status for rid, r in cpu.results.items()}
    check(status == {0: "done", 1: "expired", 2: "done", 3: "expired",
                     4: "cancelled", 5: "done"}, f"twin: statuses {status}")
    for rid, (family, spec, _) in enumerate(SVC_TWIN_MIX):
        if status[rid] == "done":
            want = serial_rb(registry.problem(family, spec).oracle())[0]
            check(cpu.results[rid].optimum == want,
                  f"twin: rid {rid} optimum {cpu.results[rid].optimum} != "
                  f"{want}")
    print(f"phase 8: service twin (lanes={lanes}, slots={slots}): card and "
          f"CPU equal after each of {cpu.rounds} rounds (lanes, open work, "
          f"slots, tickets, results); statuses {status}; "
          f"{launches} stacked_count_stats launches on the card", flush=True)
    report["service_twin"] = dict(rounds=cpu.rounds, statuses=status,
                                  launches=launches)


def phase_checkpoints(report, svc):
    """A service saved mid-run on the card restores onto fewer lanes and
    drains to the same optima; a solve saved on the card resumes on the
    CPU (and on the card) to the same optimum and ``SolveStats``."""
    from repro_torch import registry
    from repro_torch.service import SolverService
    from repro_torch.solver import Solver, SolverConfig
    # Run on until more tasks are live than the restore has lanes, so the
    # restore parks the surplus in its pending pool.
    while (int(svc.lanes.active.sum()) <= SERVICE["restore_lanes"]
           and svc.rounds < 16 and len(svc.queue)):
        svc.step_round()
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    svc_path = out / "chip_smoke_service.ckpt"
    svc.save(str(svc_path))
    restored = SolverService.restore(
        str(svc_path), num_lanes=SERVICE["restore_lanes"],
        steps_per_round=SERVICE["steps"], device=DEV)
    check([r.rid for r in restored.queue] == [r.rid for r in svc.queue],
          "restored queue order differs")
    pool, saved_round = len(restored.pool), restored.rounds
    ms, results = sync_ms(restored.drain)
    check_optima(results, f"restore on {SERVICE['restore_lanes']} lanes")
    print(f"phase 9: service saved at round {saved_round} on "
          f"{svc.num_lanes} lanes ({int(svc.lanes.active.sum())} active, "
          f"{len(svc.queue)} queued), restored on "
          f"{restored.num_lanes} lanes ({pool} tasks pooled): drained to "
          f"the same optima by round {restored.rounds} in {ms:.0f} ms",
          flush=True)

    family, instance, want = SOLVE_CKPT
    solve_path = out / "chip_smoke_solve.ckpt"
    base = dict(steps_per_round=64, bootstrap_rounds=4, bootstrap_steps=8)
    handle = registry.problem(family, instance)
    mid = Solver(SolverConfig(lanes=64, max_rounds=6, device=DEV,
                              checkpoint_every=2,
                              checkpoint_path=str(solve_path), **base)
                 ).solve(handle)
    resumed = {d: Solver(SolverConfig(lanes=32, device=d,
                                      resume_from=str(solve_path), **base)
                         ).solve(handle).stats for d in ("cpu", DEV)}
    check(resumed["cpu"].best == want and resumed["cpu"] == resumed[DEV],
          f"solve resume: cpu {tuple(resumed['cpu'])}, card "
          f"{tuple(resumed[DEV])}, want optimum {want}")
    print(f"phase 9: {family} {instance} saved on the card at round "
          f"{mid.stats.rounds} (64 lanes), resumed on 32 lanes: cpu "
          f"{tuple(resumed['cpu'])} == card {tuple(resumed[DEV])}",
          flush=True)
    report["checkpoints"] = dict(
        service_saved_round=saved_round, service_pool=pool,
        service_restore_ms=ms, service_rounds=restored.rounds,
        solve_resumed=resumed["cpu"]._asdict())
    svc_path.unlink()
    solve_path.unlink()


# -- phase 10 ---------------------------------------------------------------

def stacked_times(tables, inst, mask, valid, clock_hz, sms):
    """``stacked_count_stats`` timed on one input, against
    ``autotune.roofline``: the popcounts of the valid vertices of every
    unparked lane (its popcounts run on the CUDA cores), or the bytes of
    reading each input once and writing the output once."""
    from repro_torch.kernels import bitset_ops, ref
    from repro_torch.kernels.ref import bit_set
    k, n, w = tables.shape
    lanes = mask.shape[0]
    n_valid = int(bit_set(valid, n)[inst >= 0].sum())
    cost = bitset_ops.stacked_count_stats_cost(
        tables, inst, mask, valid, valid_pairs=n_valid, sms=sms,
        clock_hz=clock_hz)
    return measure("stacked_count_stats",
                   lambda: bitset_ops.stacked_count_stats(tables, inst, mask,
                                                          valid),
                   lambda: ref.stacked_count_stats_ref(tables, inst, mask,
                                                       valid), 200, 20,
                   *rate_bound(cost), popcounts=n_valid * w,
                   bytes=cost.nbytes, popc_bound_ms=cost.op_s * 1e3,
                   bytes_bound_ms=cost.nbytes / HBM_BYTES_PER_S * 1e3, K=k,
                   n=n, w=w, L=lanes, valid_pairs=n_valid)


def phase_stacked_timing(report, live):
    """The kernel at the service's shape (K=4, n=100, w=4, L=1024) on the
    live inputs of the service phase, and at (K=16, n=300, w=10, L=4096)
    with every lane at the root of its instance, the ids interleaved
    (lane l on instance l mod 16, as the service deals lanes over its
    slots) and sorted (each instance's 256 lanes together)."""
    from repro_torch.convert import words
    from repro_torch.problems.graphs import full_mask
    clock_hz, sms = report["clock_max_sm_hz"], report["sms"]
    service = dict(stacked_times(*live, clock_hz, sms),
                   inputs="service phase, live inputs after its split")
    rng = np.random.RandomState(2)
    k, n, lanes = 16, 300, CELL60_LANES
    full = words(np.broadcast_to(full_mask(n), (lanes, 10)).copy(), DEV)
    tables = words(rand_words(rng, (k, n, 10)), DEV)
    lane = torch.arange(lanes, dtype=torch.int32, device=DEV)
    interleaved = dict(stacked_times(tables, lane % k, full, full, clock_hz,
                                     sms),
                       inputs="random tables, every lane at its root, ids "
                              "interleaved")
    in_order = dict(stacked_times(tables, lane // (lanes // k), full, full,
                                  clock_hz, sms),
                    inputs="random tables, every lane at its root, ids "
                           "sorted")
    for t in (service, interleaved, in_order):
        print(f"phase 10: stacked_count_stats K={t['K']} n={t['n']} "
              f"w={t['w']} L={t['L']} ({t['inputs']}): kernel "
              f"{t['ms'] * 1e3:.2f} us ({t['ms_source']}; events "
              f"{t['ms_events'] * 1e3:.2f} us), plain "
              f"{t['plain_ms'] * 1e3:.1f} us, bound "
              f"{t['bound_ms'] * 1e3:.3f} us ({t['bound_by']}): popcount "
              f"issue {t['popc_bound_ms'] * 1e3:.3f} us ({t['popcounts']} "
              f"popcounts), bytes {t['bytes_bound_ms'] * 1e3:.3f} us "
              f"({t['bytes']} bytes)", flush=True)
    report["stacked_timing"] = [service, interleaved, in_order]
    return service, interleaved, in_order


# -- phases 11 to 13: the kernel library ------------------------------------

def reduce_inputs(rng, n, lanes):
    """A random table and selects with bits >= n set in the last word,
    one empty select and one all-ones select."""
    from repro_torch.convert import words
    from repro_torch.problems.graphs import num_words
    w = num_words(n)
    table = rand_words(rng, (n, w))
    select = rand_words(rng, (lanes, w))
    select[0] = 0
    if lanes > 1:
        select[1] = 0xFFFFFFFF
    return words(table, DEV), words(select, DEV)


def phase_bitset_library(report):
    """``ops.popcount_reduce`` and ``ops.masked_row_reduce`` at cell60's
    shape (the library's call, counted), then parity and timing."""
    from repro_torch.kernels import _build, bitset_ops, ops, ref
    from repro_torch.kernels.ref import bit_set
    from repro_torch.problems.graphs import full_mask
    rng = np.random.RandomState(11)
    n, lanes = 300, CELL60_LANES
    table, select = reduce_inputs(rng, n, lanes)
    select[2:] &= torch.from_numpy(full_mask(n).view(np.int32)).to(DEV)

    _build.reset_launches()
    outs = {"popcount_reduce": ops.popcount_reduce(select),
            "or": ops.masked_row_reduce(table, select, op="or"),
            "and": ops.masked_row_reduce(table, select, op="and")}
    torch.cuda.synchronize()
    launches = {k: _build.LAUNCHES[k] for k in ("popcount_reduce",
                                                 "masked_row_reduce")}
    check(launches == {"popcount_reduce": 1, "masked_row_reduce": 2},
          f"bitset library: launches {launches}")
    report["launches"].update(launches)
    compare(outs["popcount_reduce"], ref.popcount_reduce_ref(select),
            "popcount_reduce cell60", report["parity"]["popcount_reduce"])
    for op in ("or", "and"):
        compare(outs[op], ref.masked_row_reduce_ref(table, select, op=op),
                f"masked_row_reduce {op} cell60",
                report["parity"]["masked_row_reduce"])

    cases = 0
    for n_ in REDUCE_NS:
        for lanes_ in REDUCE_LANES:
            t, sel = reduce_inputs(rng, n_, lanes_)
            compare(ops.popcount_reduce(sel), ref.popcount_reduce_ref(sel),
                    f"popcount_reduce n={n_} L={lanes_}",
                    report["parity"]["popcount_reduce"])
            for op in ("or", "and"):
                compare(ops.masked_row_reduce(t, sel, op=op),
                        ref.masked_row_reduce_ref(t, sel, op=op),
                        f"masked_row_reduce {op} n={n_} L={lanes_}",
                        report["parity"]["masked_row_reduce"])
            cases += 1
    print(f"phase 11: popcount_reduce and masked_row_reduce (or, and) "
          f"through repro_torch.kernels.ops at n=300, w=10, L={lanes}: "
          f"launches {launches}; bitwise equal to plain there and on "
          f"{cases} cases (n in {REDUCE_NS} x L in {REDUCE_LANES}, bits "
          f">= n, empty and all-ones selects)", flush=True)

    clock_hz, sms = report["clock_max_sm_hz"], report["sms"]
    w = table.shape[1]
    popcounts = lanes * w
    pc_bound = rate_bound(bitset_ops.popcount_reduce_cost(
        select, sms=sms, clock_hz=clock_hz))
    floor = launch_floor(select)
    pc = measure(
        "popcount_reduce", lambda: ops.popcount_reduce(select),
        lambda: ref.popcount_reduce_ref(select), 200, 20, *pc_bound,
        n=n, w=w, L=lanes, popcounts=popcounts, floor_ms=floor["ms"],
        floor_ms_source=floor["ms_source"],
        floor_ms_events=floor["ms_events"])
    # selected * w / 2 LOP3s at the 32-bit logic rate, or the bytes
    # (``bitset_ops.masked_row_reduce_cost``).
    selected = int(bit_set(select, n).sum())
    lop3s = (selected * w + 1) // 2
    mr_bound = rate_bound(bitset_ops.masked_row_reduce_cost(
        table, select, selected=selected, sms=sms, clock_hz=clock_hz))
    mr = {op: measure(
        "masked_row_reduce",
        lambda: ops.masked_row_reduce(table, select, op=op),
        lambda: ref.masked_row_reduce_ref(table, select, op=op), 200, 20,
        *mr_bound, n=n, w=w, L=lanes, op=op, selected_pairs=selected,
        word_ops=selected * w, lop3s=lop3s) for op in ("or", "and")}
    for name, t in (("popcount_reduce", pc),
                    ("masked_row_reduce or", mr["or"]),
                    ("masked_row_reduce and", mr["and"])):
        print(f"phase 11: {name} n={n} w={w} L={lanes}: kernel "
              f"{t['ms'] * 1e3:.2f} us ({t['ms_source']}; events "
              f"{t['ms_events'] * 1e3:.2f} us), plain "
              f"{t['plain_ms'] * 1e3:.1f} us, bound {t['bound_ms'] * 1e3:.3f}"
              f" us ({t['bound_by']})", flush=True)
    print(f"phase 11: launch floor (an empty kernel of popcount_reduce's "
          f"grid and block) {floor['ms'] * 1e3:.2f} us ({floor['ms_source']};"
          f" events {floor['ms_events'] * 1e3:.2f} us)", flush=True)
    report["library_timing"] = dict(popcount_reduce=pc,
                                    masked_row_reduce=mr)
    return pc, mr


def launch_floor(rows):
    """An empty kernel launched with ``popcount_reduce``'s grid and block
    for ``rows``, timed as the kernels are (not counted: it is no kernel
    of the library)."""
    from repro_torch.kernels import _build
    # torch-lint: disable=kernel-contract -- the floor is timed, not counted
    fn = _build.load("popcount_reduce").popcount_reduce_floor_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run():
        err = fn(rows.shape[0], rows.shape[1],
                 torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"launch floor kernel: CUDA error {err}")
    ev_ms = events_ms(run, 200)
    prof_ms, _ = profiled_ms(run, "launch_floor", 20)
    return dict(ms=prof_ms if prof_ms is not None else ev_ms,
                ms_source="profiler" if prof_ms is not None else "events",
                ms_events=ev_ms)


def randn(gen, shape, dtype, scale=0.5):
    """Normal values made on the card from a seeded generator, in f32 and
    then rounded to ``dtype``."""
    x = torch.randn(shape, generator=gen, device=DEV, dtype=torch.float32)
    return (x * scale).to(dtype)


def close(got, want, tol, rel_tol):
    """(max abs error, normalised error ||got - want|| / ||want||, ok):
    ok when allclose with rtol = atol = tol holds and the normalised
    error is at most rel_tol."""
    diff = (got.float() - want.float()).abs()
    rel = float(diff.norm() / want.float().norm().clamp_min(1e-30))
    ok = bool((diff <= tol + tol * want.float().abs()).all())
    return float(diff.max()), rel, ok and rel <= rel_tol


def note_error(parity, err, rel):
    parity["compared"] += 1
    parity["max_abs_err"] = max(parity["max_abs_err"], err)
    parity["max_rel_err"] = max(parity.get("max_rel_err", 0.0), rel)


def attention_inputs(gen, case):
    name, b, s, h, g, hd, window, softcap, qs, dt = case
    return [randn(gen, (b, s, n_, hd), DTYPES[dt], scale)
            for n_, scale in ((h, QK_SCALE), (g, QK_SCALE), (g, 0.5))]


def score_std(q, k, query_scale):
    """Spread of the scores scale * q.k of head 0 over (at most) the first
    512 positions."""
    scale = query_scale if query_scale is not None else q.shape[-1] ** -0.5
    qh, kh = q[0, :512, 0].float(), k[0, :512, 0].float()
    return float((scale * qh @ kh.T).std())


def attention_parity(parity, case, q, k, v, out):
    """Hold ``out`` against the plain version, and show that the check
    would catch a kernel that skipped the softcap or the window: the
    plain version without either must fail it.  Returns (max abs error,
    normalised error, {fault: its normalised error})."""
    from repro_torch.kernels import ref
    name, b, s, h, g, hd, window, softcap, qs, dt = case
    spread = score_std(q, k, qs)
    check(spread >= MIN_SCORE_STD,
          f"flash_attention {name}: scores spread {spread:.3g} < "
          f"{MIN_SCORE_STD}, the softmax is too flat to test the kernel")
    check(bool(torch.isfinite(out.float()).all()),
          f"flash_attention {name}: non-finite output")

    def plain(window=window, softcap=softcap):
        return ref.flash_attention_ref(q, k, v, window=window,
                                       softcap=softcap, query_scale=qs,
                                       block_q=128, block_k=128)
    want = plain()
    err, rel, ok = close(out, want, TOL[dt], REL_TOL[dt])
    note_error(parity, err, rel)
    check(ok, f"flash_attention {name}: max abs err {err} (tol {TOL[dt]}), "
              f"normalised err {rel} (tol {REL_TOL[dt]})")
    faults = {}
    if softcap:
        faults["no softcap"] = plain(softcap=0.0)
    if window is not None and window < s:
        faults["no window"] = plain(window=None)
    planted = {}
    for fault, bad in faults.items():
        f_err, f_rel, f_ok = close(bad, want, TOL[dt], REL_TOL[dt])
        check(not f_ok, f"flash_attention {name}: the plain version with "
                        f"{fault} passes the check (max abs err {f_err}, "
                        f"normalised {f_rel}): the inputs cannot tell")
        planted[fault] = f_rel
    return err, rel, planted


def time_attention(report, name, q, k, v, out, window, softcap, qs,
                   **extra):
    """``ops.flash_attention`` on (q, k, v) timed over ``ATTN_ITERS``
    launches beside its plain version (once) and, without a softcap or
    query scale, SDPA (held against the kernel's ``out``): causal, a
    window as a boolean [S, S] mask with k, v repeated to H heads before
    the timing (SDPA has no window argument); with the bound from the
    inputs (``flash_attention.cost``): the
    tensor cores' (or CUDA cores') rate for its products, the SFU's for
    its exps (and tanh), or the bytes."""
    from repro_torch.kernels import flash_attention, ops, ref
    b, s, h, hd = q.shape
    g = k.shape[2]
    dt = "bf16" if q.dtype == torch.bfloat16 else "f32"
    cost = flash_attention.cost(q, k, v, window=window, softcap=softcap,
                                sms=report["sms"],
                                clock_hz=report["clock_max_sm_hz"])
    flops, nbytes = cost.flops, cost.nbytes
    bound_ms, bound_by = rate_bound(cost)
    # An exp per pair on the SFU, and a tanh with a softcap.
    sfu_ops = h * b * flash_attention.causal_pairs(s, window) * (
        2 if softcap else 1)
    sfu_ms = sfu_ops / (SFU_PER_CLOCK_PER_SM * report["sms"]
                        * report["clock_max_sm_hz"]) * 1e3
    library = None
    if window is None and softcap == 0.0 and qs is None:
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

        def library():
            return torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True)
        lib_err, lib_rel, _ = close(library().transpose(1, 2), out, TOL[dt],
                                    REL_TOL[dt])
    elif softcap == 0.0 and qs is None:
        r = h // g
        qt = q.transpose(1, 2)
        kt, vt = (x.repeat_interleave(r, dim=2).transpose(1, 2)
                  for x in (k, v))
        pos = torch.arange(s, device=q.device)
        mask = ((pos[None, :] <= pos[:, None])
                & (pos[:, None] - pos[None, :] < window))

        def library():
            return torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask)
        lib_err, lib_rel, _ = close(library().transpose(1, 2), out, TOL[dt],
                                    REL_TOL[dt])
    t = measure(
        "flash_attention",
        lambda: ops.flash_attention(q, k, v, window=window, softcap=softcap,
                                    query_scale=qs),
        lambda: ref.flash_attention_ref(
            q, k, v, window=window, softcap=softcap, query_scale=qs,
            block_q=128, block_k=128),
        ATTN_ITERS, 1, bound_ms, bound_by, library=library,
        config=name, B=b, S=s, H=h, G=g, hd=hd, window=window,
        softcap=softcap, query_scale=qs, dtype=dt, flops=flops,
        sfu_ops=sfu_ops, sfu_bound_ms=sfu_ms, bytes=nbytes,
        tolerance=TOL[dt], rel_tolerance=REL_TOL[dt], **extra)
    if library is not None:
        t["library"] = "torch.nn.functional.scaled_dot_product_attention"
        if window is not None:
            t["library"] += (" (the window as a boolean mask; k, v "
                             "repeated to H heads outside the timing)")
        t["library_vs_kernel_max_abs_err"] = lib_err
        t["library_vs_kernel_rel_err"] = lib_rel
    return t


def timing_text(t):
    """The timing of ``time_attention`` / ``time_ssd`` as printed."""
    lib = ""
    if "hd" in t:                       # attention: SDPA beside it
        lib = (f", SDPA{' (window as a mask)' if t['window'] else ''} "
               f"{t['library_ms']:.3f} ms"
               if t["library_ms"] is not None
               else ", SDPA: none (window/softcap/query_scale)")
    work = (f"{t['flops'] / 1e9:.1f} GFLOP, {t['bytes'] / 1e6:.1f} MB")
    return (f"kernel {t['ms']:.3f} ms ({t['ms_source']}; events "
            f"{t['ms_events']:.3f} ms), plain {t['plain_ms']:.1f} ms{lib}, "
            f"bound {t['bound_ms']:.3f} ms ({t['bound_by']}: {work})")


def phase_attention(report):
    """``ops.flash_attention`` at qwen2-7b's and gemma2-27b's widths (the
    library's call, counted), held against the plain version, a sweep at
    small S, and the timing."""
    from repro_torch.kernels import _build, ops
    parity = report["parity"]["flash_attention"]
    gen = torch.Generator(device=DEV)
    gen.manual_seed(12)
    inputs = [attention_inputs(gen, case) for case in ATTN_FULL]
    _build.reset_launches()
    outs = [ops.flash_attention(q, k, v, window=case[6], softcap=case[7],
                                query_scale=case[8])
            for case, (q, k, v) in zip(ATTN_FULL, inputs)]
    torch.cuda.synchronize()
    launches = _build.LAUNCHES["flash_attention"]
    check(launches == len(ATTN_FULL), f"flash_attention launches "
                                      f"{launches}")
    report["launches"]["flash_attention"] = launches

    results = []
    for case, (q, k, v), out in zip(ATTN_FULL, inputs, outs):
        name, b, s, h, g, hd, window, softcap, qs, dt = case
        err, rel, planted = attention_parity(parity, case, q, k, v, out)
        t = time_attention(report, name, q, k, v, out, window, softcap, qs,
                           max_abs_err=err, rel_err=rel,
                           planted_rel_err=planted)
        results.append(t)
        caught = "".join(f"; plain with {f} caught (normalised err "
                         f"{e:.3g})" for f, e in planted.items())
        print(f"phase 12: flash_attention {name} (B={b} S={s} H={h} G={g} "
              f"hd={hd} window={window} softcap={softcap} {dt}): max abs "
              f"err {err:.3g} (tol {TOL[dt]}), normalised {rel:.3g} (tol "
              f"{REL_TOL[dt]}){caught}; {timing_text(t)}", flush=True)
    del inputs, outs

    for case in ATTN_SWEEP:
        q, k, v = attention_inputs(gen, case)
        out = ops.flash_attention(q, k, v, window=case[6], softcap=case[7],
                                  query_scale=case[8])
        attention_parity(parity, case, q, k, v, out)
    print(f"phase 12: flash_attention sweep of {len(ATTN_SWEEP)} cases "
          f"(f32 and bf16; hd 64, 80, 128; r 1, 2, 7, 8; S below, at and "
          f"not a multiple of the tile; windows below a tile and beyond S; "
          f"softcaps; query_scale) within tolerance; the plain version "
          f"without its softcap or window (where the window hides a key) "
          f"failed the check in every such case", flush=True)
    report["attention"] = results
    return results


def ssd_inputs(gen, case):
    """x, dt, a, B, C and d of an SSD case.  B and C are drawn at the
    reference's own 0.3: at larger values the f32 plain version itself
    strays past 1e-4 from the exact recurrence in the fast-decay case."""
    name, b, s, h, p, g, n, chunk, dt, dt_shift = case
    dtype = DTYPES[dt]
    x = randn(gen, (b, s, h, p), dtype)
    dtv = torch.nn.functional.softplus(
        randn(gen, (b, s, h), torch.float32, 1.0) + dt_shift)
    a = -torch.exp(randn(gen, (h,), torch.float32, 0.3))
    bm = randn(gen, (b, s, g, n), dtype, 0.3)
    cm = randn(gen, (b, s, g, n), dtype, 0.3)
    d = 1.0 + randn(gen, (h,), torch.float32)          # a gain per head
    return x, dtv, a, bm, cm, d


def chunk_decays(dtv, a, chunk):
    """exp(sum of dt * a over each whole chunk), per (batch, chunk, head),
    in f64: the share of the state that a chunk carries on."""
    b, s, h = dtv.shape
    whole = s // chunk * chunk
    da = (dtv[:, :whole].double() * a.double()).reshape(b, -1, chunk, h)
    return torch.exp(da.sum(2))


def ssd_carry_dropped(args, chunk):
    """The plain version with the state carried from chunk to chunk
    dropped: each chunk scanned alone from a zero state."""
    from repro_torch.kernels import ref
    x, dtv, a, bm, cm, d = args
    ys, state = [], None
    for c0 in range(0, x.shape[1], chunk):
        cut = slice(c0, c0 + chunk)
        y, state = ref.ssd_scan_ref(x[:, cut], dtv[:, cut], a, bm[:, cut],
                                    cm[:, cut], d, chunk=chunk)
        ys.append(y)
    return torch.cat(ys, 1), state


def ssd_parity(parity, case, args, y, state, planted=False):
    """Hold (y, state) against the plain version: y at the reference's
    tolerance and REL_TOL, the f32 state at STATE_TOL.  Checks the decay
    the inputs give.  With ``planted``, also shows that the check would
    catch a kernel that dropped the state carried between chunks.
    Returns ((y err, y normalised err, state err), {fault check: its
    normalised error})."""
    from repro_torch.kernels import ref
    name, b, s, h, p, g, n, chunk, dt, dt_shift = case
    decays = chunk_decays(args[1], args[2], chunk)
    if dt_shift < 0:
        lo, hi = SSD_DECAY_RANGE
        mean = float(decays.mean())
        check(lo <= mean <= hi, f"ssd_scan {name}: a chunk carries on "
                                f"{mean:.3g} of the state, outside {lo} to "
                                f"{hi}: the carry cannot be tested")
    else:
        check(float(decays.min()) < math.exp(-88),
              f"ssd_scan {name}: no chunk decays past exp(-88)")
    check(bool(torch.isfinite(y.float()).all()
               and torch.isfinite(state).all()),
          f"ssd_scan {name}: non-finite output")
    y_want, st_want = ref.ssd_scan_ref(*args, chunk=chunk)

    def held(y_got, st_got):
        y_err, y_rel, y_ok = close(y_got, y_want, SSD_TOL[dt],
                                   SSD_REL_TOL[dt])
        st_err, st_rel, st_ok = close(st_got, st_want, STATE_TOL,
                                      STATE_TOL)
        return (y_err, y_rel, y_ok), (st_err, st_rel, st_ok)
    (y_err, y_rel, y_ok), (st_err, st_rel, st_ok) = held(y, state)
    note_error(parity, y_err, y_rel)
    note_error(parity, st_err, st_rel)
    check(y_ok, f"ssd_scan {name} y: max abs err {y_err} (tol "
                f"{SSD_TOL[dt]}), normalised {y_rel} (tol "
                f"{SSD_REL_TOL[dt]})")
    check(st_ok, f"ssd_scan {name} state: max abs err {st_err}, normalised "
                 f"{st_rel} (tol {STATE_TOL})")
    caught = {}
    if planted:
        bad_y, bad_st = held(*ssd_carry_dropped(args, chunk))
        check(not bad_y[2] and not bad_st[2],
              f"ssd_scan {name}: the plain version without the state carry "
              f"passes the check (y {bad_y}, state {bad_st})")
        caught = {"no carry, y": bad_y[1], "no carry, state": bad_st[1]}
    return (y_err, y_rel, st_err), caught


def time_ssd(name, args, chunk, **extra):
    """``ops.ssd_scan`` on ``args`` (x, dt, a, B, C, d) timed over 10
    launches, as the sum of its three passes' kernels, beside its plain
    version (once), with the bound from the inputs
    (``ssd_scan.cost``)."""
    from repro_torch.kernels import ops, ref, ssd_scan
    x, b_mat = args[0], args[3]
    b, s, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    dt = "bf16" if x.dtype == torch.bfloat16 else "f32"
    cost = ssd_scan.cost(*args, chunk=chunk)
    flops, nbytes = cost.flops, cost.nbytes
    bound_ms, bound_by = rate_bound(cost)
    return measure(
        "ssd_scan", lambda: ops.ssd_scan(*args, chunk=chunk),
        lambda: ref.ssd_scan_ref(*args, chunk=chunk), 10, 1, bound_ms,
        bound_by, config=name, B=b, S=s, H=h, P=p, G=g, N=n, chunk=chunk,
        dtype=dt, flops=flops, bytes=nbytes, tolerance=SSD_TOL[dt],
        rel_tolerance=SSD_REL_TOL[dt], state_tolerance=STATE_TOL, **extra)


def phase_ssd(report):
    """``ops.ssd_scan`` at mamba2-130m's width (the library's call,
    counted), held against the plain version, a sweep, and the timing."""
    from repro_torch.kernels import _build, ops
    parity = report["parity"]["ssd_scan"]
    gen = torch.Generator(device=DEV)
    gen.manual_seed(13)
    name, b, s, h, p, g, n, chunk, dt, _ = SSD_FULL
    args = ssd_inputs(gen, SSD_FULL)
    _build.reset_launches()
    y, state = ops.ssd_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    launches = _build.LAUNCHES["ssd_scan"]
    check(launches == 1, f"ssd_scan launches {launches}")
    report["launches"]["ssd_scan"] = launches
    (y_err, y_rel, st_err), caught = ssd_parity(parity, SSD_FULL, args, y,
                                                state, planted=True)
    decay = float(chunk_decays(args[1], args[2], chunk).mean())
    t = time_ssd(name, args, chunk, y_max_abs_err=y_err, y_rel_err=y_rel,
                 state_max_abs_err=st_err, chunk_decay_mean=decay,
                 planted_rel_err=caught)
    print(f"phase 13: ssd_scan {name} (B={b} S={s} H={h} P={p} G={g} N={n} "
          f"chunk={chunk} {dt}, a chunk carries on {decay:.3g} of the "
          f"state): y max abs err {y_err:.3g} (tol {SSD_TOL[dt]}), "
          f"normalised {y_rel:.3g} (tol {SSD_REL_TOL[dt]}); state max abs "
          f"err {st_err:.3g} (tol {STATE_TOL}); plain without the carry "
          f"caught (normalised err y {caught['no carry, y']:.3g}, state "
          f"{caught['no carry, state']:.3g}); {timing_text(t)}; passes "
          + ", ".join(f"{k} {v * 1e3:.1f} us" for k, v in
                      t["kernels_ms"].items())
          + f"; {b * h * -(-s // chunk)} blocks a pass on {report['sms']} "
          f"SMs", flush=True)
    del args, y, state

    for case in SSD_SWEEP:
        args = ssd_inputs(gen, case)
        y, state = ops.ssd_scan(*args, chunk=case[7])
        ssd_parity(parity, case, args, y, state, planted=case[9] < 0)
    print(f"phase 13: ssd_scan sweep of {len(SSD_SWEEP)} cases (f32, G > 1, "
          f"S not a multiple of the chunk, a decay past exp(88)) within "
          f"tolerance for y and the state; the plain version without the "
          f"carry failed the check in every case with mamba2's dt",
          flush=True)
    report["ssd"] = t
    return t


# -- phase 14: a graph of more than 1024 vertices ---------------------------

def phase_wide(report):
    """``WIDE`` through ``Solver.solve`` at ``WIDE_LANES`` for ``WIDE_BOOT``
    bootstrap round and ``WIDE_ROUNDS`` more, every kernel launch held
    against the plain version on its live inputs; one round at 16 lanes on
    the card and on the CPU; the kernel timed at ``WIDE_TIMED``.

    Each round replays D + 1 = n + 1 launches, and past the deepest lane's
    path a replay step repeats the step before's inputs.  The plain
    version, a function of its inputs, is computed anew only where the
    table, mask or valid words differ from the previous launch's; every
    launch's output is held against it."""
    from repro_torch import registry
    from repro_torch.convert import words
    from repro_torch.kernels import bitset_ops, ref
    from repro_torch.problems.graphs import full_mask, parse_graph_instance
    from repro_torch.solver import Solver, SolverConfig
    problem, instance = WIDE
    rounds = WIDE_BOOT + WIDE_ROUNDS
    parity = report["parity"]["count_stats"]
    kernel = bitset_ops.count_stats
    checked, computed, last = [0], [0], []

    def checked_kernel(table, mask, valid):
        out = kernel(table, mask, valid)
        inputs = (table, mask, valid)
        if not (last and all(torch.equal(a, b)
                             for a, b in zip(last[:3], inputs))):
            last[:] = [x.clone() for x in inputs] + [
                ref.count_stats_ref(table, mask, valid)]
            computed[0] += 1
        compare(out, last[3], f"{instance} live inputs", parity)
        checked[0] += 1
        return out

    bitset_ops.count_stats = checked_kernel      # bitset_degree's lookup
    try:
        res, ms, launches, _ = run_solve(problem, instance, WIDE_LANES,
                                         DEV, max_rounds=rounds,
                                         bootstrap_rounds=WIDE_BOOT)
    finally:
        bitset_ops.count_stats = kernel
    s = res.stats
    w = parse_graph_instance(instance).words
    print(f"phase 14: {problem} {instance} (w={w}) lanes={WIDE_LANES} "
          f"rounds={s.rounds}: incumbent={s.best} nodes={s.nodes} "
          f"T_S={s.t_s} T_R={s.t_r} wall={ms:.1f} ms (every launch "
          f"checked) count_stats launches={launches}, each bitwise equal to "
          f"plain on its live inputs ({computed[0]} distinct inputs, the "
          f"rest the launch before's)", flush=True)
    check(s.rounds == rounds, f"{instance}: {s.rounds} rounds (want "
                              f"{rounds})")
    check(launches > 0 and launches == checked[0],
          f"{instance}: {launches} launches, {checked[0]} checked")
    report["launches"]["count_stats"] += launches
    report["solves"].append(dict(problem=problem, instance=instance,
                                 lanes=WIDE_LANES, stats=s._asdict(),
                                 wall_ms=ms, launches=launches,
                                 checked=checked[0],
                                 plain_computed=computed[0]))

    # One round at 16 lanes on the card and on the CPU.
    cfg = dict(lanes=16, steps_per_round=64, bootstrap_rounds=1,
               bootstrap_steps=8, max_rounds=1)
    handle = registry.problem(problem, instance)
    bitset_ops.reset_launches()
    gpu_ms, gpu = sync_ms(
        lambda: Solver(SolverConfig(device=DEV, **cfg)).solve(handle))
    twin_launches = bitset_ops.LAUNCHES["count_stats"]
    t0 = time.perf_counter()
    cpu = Solver(SolverConfig(device="cpu", **cfg)).solve(handle)
    cpu_ms = (time.perf_counter() - t0) * 1e3
    print(f"phase 14: {problem} {instance} lanes=16, 1 round: cuda "
          f"{tuple(gpu.stats)} ({gpu_ms:.0f} ms, {twin_launches} launches),"
          f" cpu {tuple(cpu.stats)} ({cpu_ms:.0f} ms)", flush=True)
    check(gpu.stats == cpu.stats, f"{instance}: SolveStats differ between "
                                  f"cuda and cpu")
    check(twin_launches > 0, f"{instance}: count_stats never launched")
    check_same_lanes(gpu.lanes, cpu.lanes, f"{instance} twin")
    report["launches"]["count_stats"] += twin_launches
    report["wide_twin"] = dict(stats=gpu.stats._asdict(), cuda_ms=gpu_ms,
                               cpu_ms=cpu_ms, launches=twin_launches)

    clock_hz, sms = report["clock_max_sm_hz"], report["sms"]
    timed_cases = []
    for spec, lanes in WIDE_TIMED:
        graph = parse_graph_instance(spec)
        root = words(np.broadcast_to(full_mask(graph.n),
                                     (lanes, graph.words)).copy(), DEV)
        timed_cases.append(dict(
            kernel_times(words(graph.adj, DEV), root, root, clock_hz, sms),
            masks=f"{spec}, every lane at the root"))
    alive = live_alive(res.lanes)
    timed_cases.append(dict(
        kernel_times(words(parse_graph_instance(instance).adj, DEV), alive,
                     alive, clock_hz, sms),
        masks=f"{instance}, live masks after {s.rounds} rounds"))
    for t in timed_cases:
        print(f"phase 14: count_stats n={t['n']} w={t['w']} L={t['L']} "
              f"({t['masks']}): kernel {t['ms'] * 1e3:.2f} us "
              f"({t['ms_source']}; events {t['ms_events'] * 1e3:.2f} us), "
              f"plain {t['plain_ms'] * 1e3:.1f} us, bound "
              f"{t['bound_ms'] * 1e3:.3f} us ({t['bound_by']}: "
              f"{t['bytes']} bytes); popcount issue of the same work "
              f"{t['popc_bound_ms'] * 1e3:.3f} us ({t['popcounts']} "
              f"popcounts)", flush=True)
    report["wide_timing"] = timed_cases
    return timed_cases


# -- phases 15 to 18: telemetry on the card, and subset sum ----------------

def check_trace(path, nodes, rounds, snap, what):
    """Read ``path`` back through the port's ``read_trace`` (which
    validates every record against the schema) and hold its last summary
    and the metrics snapshot to the run's own counts."""
    from repro_torch.obs.trace import read_trace
    records = read_trace(str(path))
    kinds = [r["t"] for r in records]
    check(kinds[0] == "meta" and records[0]["backend"] == DEV,
          f"{what}: trace does not open with a {DEV} meta record")
    summary = [r for r in records if r["t"] == "summary"][-1]
    check(summary["nodes"] == nodes == sum(summary["lane_nodes"]),
          f"{what}: trace summary nodes {summary['nodes']} (lanes "
          f"{sum(summary['lane_nodes'])}) != {nodes}")
    check(summary["rounds"] == rounds == kinds.count("round"),
          f"{what}: trace has {kinds.count('round')} rounds, summary "
          f"{summary['rounds']}, run {rounds}")
    check(snap.value("engine_nodes") == nodes,
          f"{what}: metrics engine_nodes {snap.value('engine_nodes')} != "
          f"{nodes}")
    return records


@contextlib.contextmanager
def collector_clock():
    """Host milliseconds spent inside the telemetry collector's calls
    (its one copy a round included), accumulated into the yielded list
    while the ``with`` block runs.  The collector copies after the
    round's open-work readback, when the card has no work queued, so this
    is what telemetry adds to a round."""
    from repro_torch.obs.collect import RoundCollector
    spent = [0.0]
    saved = {name: getattr(RoundCollector, name) for name in
             ("start", "before_round", "after_round", "lifecycle", "finish")}

    def timed(fn):
        def wrapper(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                spent[0] += (time.perf_counter() - t0) * 1e3
        return wrapper

    for name, fn in saved.items():
        setattr(RoundCollector, name, timed(fn))
    try:
        yield spent
    finally:
        for name, fn in saved.items():
            setattr(RoundCollector, name, fn)


def alternate(repeats, first):
    """Run kinds in turns: ``first`` then the other, the other then
    ``first``, and so on, ``repeats`` pairs."""
    other = "bare" if first == "traced" else "traced"
    for i in range(repeats):
        yield from ((first, other) if i % 2 == 0 else (other, first))


def telemetry_solves(report, problem, instance, lanes, phase, repeats,
                     **kw):
    """``repeats`` pairs of the same solve traced and bare, in turns; the
    launch counts set to 0 before each.  Returns the runs by kind."""
    runs = {"traced": [], "bare": []}
    for kind in alternate(repeats, "traced"):
        path = (TRACES / f"{instance.replace(':', '_')}_"
                         f"{len(runs['traced'])}.jsonl"
                if kind == "traced" else None)
        with collector_clock() as spent:
            res, ms, launches, solver = run_solve(problem, instance, lanes,
                                                  DEV, trace_path=path, **kw)
        s = res.stats
        print(f"phase {phase}: {problem} {instance} lanes={lanes} {kind}: "
              f"wall={ms:.1f} ms rounds={s.rounds} nodes={s.nodes} "
              f"count_stats launches={launches}" + (
                  f", in the collector {spent[0]:.1f} ms "
                  f"({spent[0] / s.rounds:.2f} ms a round)"
                  if path is not None else ""), flush=True)
        check(launches > 0, f"{instance} {kind}: count_stats never launched")
        report["launches"]["count_stats"] += launches
        if path is not None:
            check_trace(path, s.nodes, s.rounds, solver.metrics(),
                        f"{instance} traced")
        runs[kind].append(dict(res=res, wall_ms=ms, launches=launches,
                               collector_ms=spent[0]))
    want = runs["bare"][0]["res"]
    for run in runs["traced"] + runs["bare"]:
        check(run["res"].stats == want.stats,
              f"{instance}: SolveStats differ with telemetry on and off")
        check_same_lanes(run["res"].lanes, want.lanes,
                         f"{instance} telemetry on/off")
    report.setdefault("telemetry", {})[instance] = {
        kind: [{k: v for k, v in r.items() if k != "res"} for r in rs]
        for kind, rs in runs.items()}
    report["telemetry"][instance]["stats"] = want.stats._asdict()
    walls = {k: [round(r["wall_ms"], 1) for r in rs]
             for k, rs in runs.items()}
    print(f"phase {phase}: {instance}: traced and bare give equal "
          f"SolveStats and bitwise equal lanes; every trace read back and "
          f"validated, its summary the run's; wall ms traced "
          f"{walls['traced']}, bare {walls['bare']}", flush=True)
    return want


def phase_telemetry_drain(report, repeats):
    """``TELEMETRY_DRAIN`` drained at 1024 lanes with ``trace_path`` and
    ``metrics=True`` and with neither, in turns."""
    problem, instance, want = TELEMETRY_DRAIN
    res = telemetry_solves(report, problem, instance, DRAIN_LANES, 15,
                           repeats)
    check(res.stats.best == want, f"{instance}: optimum {res.stats.best} "
                                  f"!= {want}")


def phase_telemetry_cell60(report):
    """vc cell60 at 4096 lanes: the bootstrap round and 2 more, traced and
    bare."""
    telemetry_solves(report, "vc", "cell60", CELL60_LANES, 16, 1,
                     bootstrap_rounds=1, max_rounds=3)


def phase_telemetry_service(report, bare_svc, bare_ms, repeats):
    """Phase 7's drain again with ``trace_path`` and ``metrics=True``: the
    same results, ticket states and rounds as phase 7's untraced drain
    (``bare_svc``); the trace validates and its ``retire`` records are the
    retirements.  With ``repeats`` > 1, more traced and bare drains in
    turns (times only)."""
    from repro_torch.kernels import bitset_ops
    cfg = SERVICE
    walls = {"traced": [], "bare": [bare_ms], "collector": []}
    kinds = ["traced"] + list(alternate(repeats - 1, "bare"))
    for i, kind in enumerate(kinds):
        path = TRACES / f"service_{i}.jsonl"
        tele = (dict(trace_path=str(path), metrics=True)
                if kind == "traced" else {})
        svc = new_service(DEV, cfg["lanes"], cfg["steps"], cfg["max_n"],
                          cfg["slots"], **tele)
        submit_all(svc, [(f, sp, {}) for f, sp, _ in SERVICE_MIX])
        bitset_ops.reset_launches()
        with collector_clock() as spent:
            ms, results = sync_ms(svc.drain)
        launches = bitset_ops.LAUNCHES["stacked_count_stats"]
        check(launches > 0, "traced service: stacked_count_stats never "
                            "launched")
        report["launches"]["stacked_count_stats"] += launches
        walls[kind].append(ms)
        if kind == "traced":
            walls["collector"].append(spent[0])
        print(f"phase 17: service {kind}: wall={ms:.1f} ms rounds="
              f"{svc.rounds} stacked_count_stats launches={launches}" + (
                  f", in the collector {spent[0]:.1f} ms "
                  f"({spent[0] / svc.rounds:.2f} ms a round)"
                  if kind == "traced" else ""), flush=True)
        check_optima(results, f"service {kind}")
        check(svc.rounds == bare_svc.rounds,
              f"service {kind}: {svc.rounds} rounds, untraced "
              f"{bare_svc.rounds}")
        check({r: t.status.value for r, t in svc.tickets.items()} ==
              {r: t.status.value for r, t in bare_svc.tickets.items()},
              f"service {kind}: ticket states differ from the untraced")
        for rid, res in bare_svc.results.items():
            got = results[rid]
            check((got.optimum, got.status, got.admitted_round,
                   got.retired_round) == (res.optimum, res.status,
                                          res.admitted_round,
                                          res.retired_round)
                  and np.array_equal(got.payload, res.payload),
                  f"service {kind}: rid {rid} differs from the untraced")
        check_same_lanes(svc.lanes, bare_svc.lanes, f"service {kind}")
        if kind == "traced":
            records = check_trace(path, int(svc.lanes.nodes.sum()),
                                  svc.rounds, svc.metrics(),
                                  "traced service")
            retired = sorted((r["rid"], r["round"]) for r in records
                             if r["t"] == "retire")
            check(retired == sorted((rid, res.retired_round)
                                    for rid, res in results.items()
                                    if res.status == "done"),
                  f"traced service: retire records {retired} are not the "
                  f"retirements")
    print(f"phase 17: service traced: the untraced drain's results, ticket "
          f"states, {bare_svc.rounds} rounds and lanes; the trace validates "
          f"and its {len(SERVICE_MIX)} retire records are the retirements; "
          f"wall ms traced {[round(w, 1) for w in walls['traced']]}, bare "
          f"{[round(w, 1) for w in walls['bare']]} (the first bare is phase "
          f"7's)", flush=True)
    report.setdefault("telemetry", {})["service"] = dict(
        rounds=bare_svc.rounds, **walls)


def phase_subset_sum(report):
    """``SUBSET_SUM`` drained at 1024 lanes on the card to the port's serial
    optimum, with the CPU's ``SolveStats`` and lanes.  Subset sum has no
    kernel: no launch may happen."""
    from repro_torch.core.serial import serial_rb
    from repro_torch.kernels import bitset_ops
    from repro_torch.problems.subset_sum import (make_subset_sum_py,
                                                 parse_ss_instance)
    spec = SUBSET_SUM
    inst = parse_ss_instance(spec)
    t0 = time.perf_counter()
    best, serial_nodes, _ = serial_rb(make_subset_sum_py(inst.values,
                                                         inst.target))
    serial_s = time.perf_counter() - t0
    gpu, gpu_ms, _, _ = run_solve("ss", spec, DRAIN_LANES, DEV)
    # Launches only: the registry also counts routes and stack bytes.
    launches = sum(bitset_ops.LAUNCHES[k] for k in KERNELS)
    cpu, cpu_ms, _, _ = run_solve("ss", spec, DRAIN_LANES, "cpu")
    print(f"phase 18: ss {spec} (n={inst.n}, target={inst.target}) lanes="
          f"{DRAIN_LANES}: cuda {tuple(gpu.stats)} wall={gpu_ms:.1f} ms; "
          f"cpu {tuple(cpu.stats)} wall={cpu_ms:.1f} ms; serial_rb "
          f"optimum={best} nodes={serial_nodes} ({serial_s:.1f} s)",
          flush=True)
    check(gpu.stats.best == best, f"{spec}: optimum {gpu.stats.best} != "
                                  f"serial {best}")
    check(gpu.stats == cpu.stats, f"{spec}: SolveStats differ between cuda "
                                  f"and cpu")
    check_same_lanes(gpu.lanes, cpu.lanes, f"{spec} twin")
    check(launches == 0, f"{spec}: {launches} kernel launches on a path "
                         f"that has no kernel")
    report["subset_sum"] = dict(spec=spec, n=inst.n, target=inst.target,
                                stats=gpu.stats._asdict(), cuda_ms=gpu_ms,
                                cpu_ms=cpu_ms, serial_best=best,
                                serial_nodes=serial_nodes)


# -- phases 19 to 24: the mesh, the sharded service, the autotuner ---------

def lanes_digest(lanes):
    """SHA-256 of every array of the gathered lanes (dtype, shape and
    bytes): two runs with equal digests have bitwise equal lanes."""
    import hashlib
    from repro_torch.core.api import tree_leaves
    from repro_torch.core.distributed import _gather_lanes
    h = hashlib.sha256()
    for leaf in tree_leaves(_gather_lanes(lanes)):
        arr = leaf.detach().cpu().contiguous().numpy()
        h.update(f"{arr.dtype}{arr.shape}".encode())
        h.update(arr.tobytes())
    return h.hexdigest()


def shard_mesh(device, shards):
    from repro_torch.core.distributed import Mesh
    return Mesh([device] * shards)


def mesh_rounds(family, instance, mesh, lanes, boot_rounds, rounds):
    """The first ``rounds`` rounds of a ``Solver.solve`` on ``mesh``
    (``lanes`` per shard, ``boot_rounds`` bootstrap rounds of 8 steps,
    then rounds of 64, ``max_ship`` 16), driven as ``Solver.solve`` drives
    them; yields (problems, lanes) after each round."""
    from repro_torch import registry
    from repro_torch.core.distributed import _shard_lanes, make_round
    from repro_torch.core.engine import init_lanes
    handle = registry.problem(family, instance)
    problems = {dev: handle.build(device=str(dev))
                for dev in mesh.distinct()}
    boot = make_round(problems, 8, mesh=mesh)
    main = make_round(problems, 64, mesh=mesh)
    cur = _shard_lanes(init_lanes(problems[mesh.devices[0]],
                                  lanes * mesh.size), mesh)
    for r in range(rounds):
        cur, _ = (boot if r < boot_rounds else main)(cur)
        yield problems, cur


def mesh_service_schedule(device, workdir, trace_dir=None):
    """Phase 7's mix on ``MESH_SERVICE`` shards of ``device``: resized to
    ``RESIZE_TO`` at round ``RESIZE_AT``, saved at round ``SAVE_AT`` and
    restored onto the first layout, then drained.  Returns what the card's
    and the CPU's runs must share, and the service and its launches."""
    from repro_torch.kernels import bitset_ops
    from repro_torch.service import SolverService
    from repro_torch.solver import Solver, SolverConfig
    dev_type = torch.device(device).type
    shards, lanes = MESH_SERVICE
    traced = {} if trace_dir is None else dict(
        trace_path=str(trace_dir / "mesh_service.jsonl"), metrics=True)
    svc = Solver(SolverConfig(lanes=lanes, steps_per_round=SERVICE["steps"],
                              device=dev_type,
                              mesh=shard_mesh(device, shards), **traced)
                 ).serve(max_n=SERVICE["max_n"], slots=SERVICE["slots"])
    events = []
    svc.on_event = events.append
    submit_all(svc, [(f, s, {}) for f, s, _ in SERVICE_MIX])
    bitset_ops.reset_launches()
    t0 = time.perf_counter()
    while svc._has_work() and svc.rounds < RESIZE_AT:
        svc.step_round()
    svc.resize(mesh=shard_mesh(device, RESIZE_TO[0]), num_lanes=RESIZE_TO[1])
    while svc._has_work() and svc.rounds < SAVE_AT:
        svc.step_round()
    check(svc._has_work(), "mesh service drained before its save")
    svc.finalize_trace()
    path = workdir / f"mesh_service_{dev_type}.ckpt"
    svc.save(str(path))
    back = SolverService.restore(
        str(path), num_lanes=lanes, steps_per_round=SERVICE["steps"],
        device=dev_type, mesh=shard_mesh(device, shards),
        **({} if trace_dir is None else dict(
            trace_path=str(trace_dir / "mesh_service_restored.jsonl"),
            metrics=True)))
    path.unlink()
    back.on_event = events.append
    results = back.drain()
    if dev_type == "cuda":
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(bitset_ops.LAUNCHES)
    shared = dict(
        results={str(rid): [r.optimum, r.status, r.admitted_round,
                            r.retired_round]
                 for rid, r in sorted(results.items())},
        tickets={str(rid): t.status.value
                 for rid, t in sorted(back.tickets.items())},
        rounds=back.rounds,
        resizes=[e.reason for e in events if e.kind == "resize"])
    return shared, back, launches, wall_ms


def twin_part(part, path):
    """One part of the CPU's side of phases 19, 20 and 22, run in a
    process of its own beside the card's phases (``--cpu-twin PART
    PATH``); writes its results to ``path`` (JSON) after each round it
    holds.  ``cell60`` starts no round after ``TWIN_CELL60_BUDGET_S``."""
    import tempfile
    torch.set_num_threads(TWIN_THREADS)
    t0 = time.perf_counter()
    out = {}

    def save():
        out["seconds"] = time.perf_counter() - t0
        tmp = pathlib.Path(str(path) + ".tmp")
        tmp.write_text(json.dumps(out))
        tmp.replace(path)

    mesh = shard_mesh("cpu", MESH_SHARDS)
    if part == "cell60":
        out["digests"] = []
        for _, lanes in mesh_rounds("vc", "cell60", mesh, MESH_CELL60_LANES,
                                    1, MESH_CELL60_ROUNDS):
            out["digests"].append(lanes_digest(lanes))
            save()
            if time.perf_counter() - t0 > TWIN_CELL60_BUDGET_S:
                break
    elif part == "drain":
        family, instance, _ = MESH_DRAIN
        out["digests"] = [lanes_digest(lanes) for _, lanes in mesh_rounds(
            family, instance, mesh, MESH_LANES, 4, MESH_CHECK_ROUNDS)]
    elif part == "service":
        with tempfile.TemporaryDirectory() as tmp:
            out["service"] = mesh_service_schedule("cpu",
                                                   pathlib.Path(tmp))[0]
    else:
        raise ValueError(f"no CPU twin part {part!r}")
    out["done"] = True
    save()


def start_twin():
    """Start every part of the CPU twin, each in its own process."""
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    procs = {}
    for part in TWIN_PARTS:
        path = out / f"cpu_twin_{part}.json"
        if path.exists():
            path.unlink()
        log = open(out / f"cpu_twin_{part}.log", "w")
        procs[part] = (subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--cpu-twin", part,
             str(path)], stdout=log, stderr=subprocess.STDOUT), path, log)
    return procs, time.perf_counter()


def finish_twin(twin):
    """Wait for the CPU twin's parts (at most ``TWIN_WAIT_S`` from their
    start), stop any still running, and return each part's results."""
    procs, t0 = twin
    res = {}
    for part, (proc, path, log) in procs.items():
        try:
            proc.wait(timeout=max(1.0, TWIN_WAIT_S
                                  - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            pass
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
        res[part] = json.loads(path.read_text()) if path.exists() else {}
        res[part]["rc"] = proc.returncode
    return res


def phase_mesh_drain(report):
    """``MESH_DRAIN`` on ``MESH_SHARDS`` shards of the card, drained
    through ``Solver.solve``, with the launch counts set to 0 just before;
    the lanes after round ``CHECKPOINT_ROUND`` saved for phase 21; beside
    it phase 3's unsharded drain of the same instance at the same width.
    Then the first ``MESH_CHECK_ROUNDS`` rounds driven by hand (digests
    for the CPU twin: the bootstrap rounds emit no event), the last of
    them held against the solve's, and the next round timed in its parts;
    and a one-shard mesh against the unsharded solve."""
    from repro_torch import registry
    from repro_torch.core import checkpoint as ckpt
    from repro_torch.core import distributed as dist
    from repro_torch.core import steal
    from repro_torch.core.engine import make_expand
    from repro_torch.kernels import bitset_ops
    from repro_torch.solver import Solver, SolverConfig
    family, instance, want = MESH_DRAIN
    mesh = shard_mesh(DEV_MESH, MESH_SHARDS)
    ckpt_path = ROOT / "chiprun_out" / "chip_smoke_mesh.ckpt"
    at_check = []

    def at_round(ev):
        if ev.kind != "round":
            return
        if ev.round == MESH_CHECK_ROUNDS:
            at_check.append(lanes_digest(ev.lanes))
        if ev.round == CHECKPOINT_ROUND:
            ckpt.save(str(ckpt_path), dist._gather_lanes(ev.lanes))

    solver = Solver(SolverConfig(lanes=MESH_LANES, steps_per_round=64,
                                 bootstrap_rounds=4, bootstrap_steps=8,
                                 device=DEV, mesh=mesh), on_event=at_round)
    handle = registry.problem(family, instance)
    bitset_ops.reset_launches()
    ms, res = sync_ms(lambda: solver.solve(handle))
    launches = bitset_ops.LAUNCHES["count_stats"]
    s = res.stats
    plain = next(d for d in report["solves"]
                 if (d["problem"], d["instance"], d["lanes"])
                 == (family, instance, MESH_SHARDS * MESH_LANES))
    print(f"phase 19: {family} {instance} on {MESH_SHARDS} shards of "
          f"{DEV_MESH} x {MESH_LANES} lanes: optimum={s.best} "
          f"rounds={s.rounds} nodes={s.nodes} T_S={s.t_s} T_R={s.t_r} "
          f"T_C={s.t_c} wall={ms:.1f} ms count_stats launches={launches}; "
          f"unsharded at {MESH_SHARDS * MESH_LANES} lanes (phase 3): "
          f"{plain['stats']['rounds']} rounds wall={plain['wall_ms']:.1f} ms",
          flush=True)
    check(s.best == want, f"mesh drain: optimum {s.best} != {want}")
    check(s.t_c > 0, "mesh drain: no task crossed a shard")
    check(s.lanes == MESH_SHARDS * MESH_LANES, f"mesh drain: {s.lanes} lanes")
    check(launches > 0, "mesh drain: count_stats never launched")
    report["launches"]["count_stats"] += launches
    report["mesh_drain"] = dict(stats=s._asdict(), wall_ms=ms,
                                launches=launches,
                                unsharded_wall_ms=plain["wall_ms"],
                                unsharded_rounds=plain["stats"]["rounds"])

    # The first rounds by hand, for the CPU twin, and the next one's parts.
    digests = []
    for problems, lanes in mesh_rounds(family, instance, mesh, MESH_LANES,
                                       4, MESH_CHECK_ROUNDS):
        digests.append(lanes_digest(lanes))
    check(digests[-1:] == at_check,
          f"mesh drain: round {MESH_CHECK_ROUNDS} by hand differs from the "
          f"solve's")
    report["mesh_drain"]["digests"] = digests
    plist = [problems[d] for d in mesh.devices]
    expand = make_expand(plist[0], 64)
    round_ms, _ = sync_ms(lambda: dist.make_distributed_round(
        problems, mesh, 64)(lanes))
    expand_ms, expanded = sync_ms(lambda: [expand(x) for x in lanes.shards])
    intra_ms, intra = sync_ms(lambda: [
        steal.assign_tasks(*steal.balance_plan(x)) for x in expanded])
    shards = [x for x, _ in intra]
    cross = sorted(sync_ms(lambda: dist.cross_device_assign(shards, 16))[0]
                   for _ in range(3))
    assigned, got = dist.cross_device_assign(shards, 16)
    replay_ms, _ = sync_ms(lambda: dist.replay_per_device(
        plist, mesh, assigned, [a | b for (_, a), b in zip(intra, got)]))
    print(f"phase 19: round {MESH_CHECK_ROUNDS + 1} "
          f"({int(lanes.active.sum())} lanes active at its start): "
          f"{round_ms:.1f} ms; its parts: expand of the {MESH_SHARDS} shards "
          f"{expand_ms:.1f} ms, intra-shard steals {intra_ms:.1f} ms, "
          f"cross-device steal {cross[1]:.1f} ms (median of "
          f"{', '.join(f'{c:.1f}' for c in cross)}), one replay of the "
          f"receivers {replay_ms:.1f} ms", flush=True)
    report["mesh_drain"]["round_parts"] = dict(
        round_ms=round_ms, expand_ms=expand_ms, intra_ms=intra_ms,
        cross_ms=cross, replay_ms=replay_ms)

    # A mesh of one shard is the unsharded solve.
    tw_family, tw_instance, tw_lanes = TWIN
    base = dict(lanes=tw_lanes, steps_per_round=64, bootstrap_rounds=4,
                bootstrap_steps=8, device=DEV)
    handle = registry.problem(tw_family, tw_instance)
    one = Solver(SolverConfig(mesh=shard_mesh(DEV_MESH, 1), **base)).solve(
        handle)
    plain = Solver(SolverConfig(**base)).solve(handle)
    check(one.stats == plain.stats, f"one-shard mesh {tuple(one.stats)} != "
                                    f"unsharded {tuple(plain.stats)}")
    check_same_lanes(one.lanes.gather(), plain.lanes, "one-shard mesh")
    print(f"phase 19: {tw_family} {tw_instance} lanes={tw_lanes}: a mesh of "
          f"one shard gives the unsharded SolveStats {tuple(plain.stats)} "
          f"and lanes", flush=True)
    return ckpt_path


def phase_mesh_cell60(report):
    """``vc cell60`` on ``MESH_SHARDS`` shards x ``MESH_CELL60_LANES``
    lanes: the bootstrap round and 2 more, driven as ``Solver.solve``
    drives them (digests for the CPU twin), with the launch counts set to
    0 just before."""
    from repro_torch.kernels import bitset_ops
    mesh = shard_mesh(DEV_MESH, MESH_SHARDS)
    bitset_ops.reset_launches()
    digests, last = [], []

    def rounds():
        for problems, lanes in mesh_rounds("vc", "cell60", mesh,
                                           MESH_CELL60_LANES, 1,
                                           MESH_CELL60_ROUNDS):
            digests.append(lanes_digest(lanes))
            last[:] = [problems, lanes]
    ms, _ = sync_ms(rounds)
    launches = bitset_ops.LAUNCHES["count_stats"]
    check(len(digests) == MESH_CELL60_ROUNDS and launches > 0,
          f"mesh cell60: {len(digests)} rounds, {launches} launches")
    print(f"phase 20: vc cell60 on {MESH_SHARDS} shards x "
          f"{MESH_CELL60_LANES} lanes, {len(digests)} rounds: wall={ms:.1f} "
          f"ms (each round's lanes hashed) count_stats launches={launches}",
          flush=True)
    report["launches"]["count_stats"] += launches
    report["mesh_cell60"] = dict(wall_ms=ms, launches=launches,
                                 digests=digests)
    return (mesh, *last)


def phase_mesh_elastic(report, ckpt_path):
    """Phase 19's solve as saved after round ``CHECKPOINT_ROUND``,
    resumed on each layout of ``ELASTIC_ON`` and drained."""
    from repro_torch import registry
    from repro_torch.kernels import bitset_ops
    from repro_torch.solver import Solver, SolverConfig
    family, instance, want = MESH_DRAIN
    out = {}
    for shards, lanes in ELASTIC_ON:
        mesh = shard_mesh(DEV_MESH, shards) if shards > 1 else None
        bitset_ops.reset_launches()
        ms, res = sync_ms(lambda: Solver(SolverConfig(
            lanes=lanes, steps_per_round=64, device=DEV, mesh=mesh,
            resume_from=str(ckpt_path))).solve(registry.problem(
                family, instance)))
        launches = bitset_ops.LAUNCHES["count_stats"]
        s = res.stats
        print(f"phase 21: saved after round {CHECKPOINT_ROUND} on "
              f"{MESH_SHARDS} shards, resumed on {shards} x {lanes} lanes: "
              f"optimum={s.best} rounds={s.rounds} nodes={s.nodes} "
              f"T_C={s.t_c} wall={ms:.1f} ms count_stats launches="
              f"{launches}", flush=True)
        check(s.best == want, f"elastic {shards} x {lanes}: optimum "
                              f"{s.best} != {want}")
        check(launches > 0, "elastic: count_stats never launched")
        report["launches"]["count_stats"] += launches
        out[f"{shards}x{lanes}"] = dict(stats=s._asdict(), wall_ms=ms)
    report["mesh_elastic"] = out
    ckpt_path.unlink()


def phase_mesh_service(report):
    """Phase 7's mix on the sharded service: resized, saved and restored
    mid-drain; every result its serial optimum; the trace validates and
    holds the resize."""
    from repro_torch.obs.trace import read_trace
    shared, svc, launches, ms = mesh_service_schedule(
        DEV_MESH, ROOT / "chiprun_out", trace_dir=TRACES)
    check_optima(svc.results, "mesh service")
    check(launches["stacked_count_stats"] > 0,
          "mesh service: stacked_count_stats never launched")
    records = read_trace(str(TRACES / "mesh_service.jsonl"))
    resizes = [r for r in records if r["t"] == "resize"]
    check([(r["devices"], r["lanes"]) for r in resizes] == [
        (RESIZE_TO[0], RESIZE_TO[0] * RESIZE_TO[1])],
        f"mesh service trace: resize records {resizes}")
    read_trace(str(TRACES / "mesh_service_restored.jsonl"))
    print(f"phase 22: service on {MESH_SERVICE[0]} shards x "
          f"{MESH_SERVICE[1]} lanes, resized at round {RESIZE_AT} "
          f"({shared['resizes']}), saved at round {SAVE_AT} and restored on "
          f"{MESH_SERVICE[0]} x {MESH_SERVICE[1]}: {len(SERVICE_MIX)} "
          f"requests drained to their serial optima in {shared['rounds']} "
          f"rounds, wall={ms:.1f} ms, stacked_count_stats launches="
          f"{launches['stacked_count_stats']}; traces validate",
          flush=True)
    report["launches"]["stacked_count_stats"] += launches[
        "stacked_count_stats"]
    report["mesh_service"] = dict(shared, wall_ms=ms, launches=launches)
    return shared


def phase_two_cards(report):
    from repro_torch import registry
    from repro_torch.core.distributed import Mesh
    from repro_torch.solver import Solver, SolverConfig
    count = torch.cuda.device_count()
    if count < 2:
        print(f"phase 23: no second card present ({count} card): the mesh "
              f"over cards is not run", flush=True)
        report["two_cards"] = None
        return
    family, instance, want = MESH_DRAIN
    mesh = Mesh(["cuda:0", "cuda:1"])
    ms, res = sync_ms(lambda: Solver(SolverConfig(
        lanes=512, steps_per_round=64, bootstrap_rounds=4, bootstrap_steps=8,
        device=DEV, mesh=mesh)).solve(registry.problem(family, instance)))
    check(res.stats.best == want, f"two cards: optimum {res.stats.best}")
    print(f"phase 23: {family} {instance} on cuda:0 and cuda:1 x 512 lanes: "
          f"{tuple(res.stats)} wall={ms:.1f} ms", flush=True)
    report["two_cards"] = dict(stats=res.stats._asdict(), wall_ms=ms)


def phase_autotune(report, card):
    """``choose`` and ``predict_cost`` at phase 4's shape.  Both routes of
    each count kernel held bitwise against the plain version at every row
    width the narrow route takes up to 32 words, the shapes
    ``measured_choice`` then times among them: cell60's root shape for
    ``count_stats``, the service's (K=4, n=100, L=1024) for
    ``stacked_count_stats``."""
    from repro_torch.kernels import autotune, bitset_ops, ref
    n, w, lanes = 300, 10, CELL60_LANES
    choice = autotune.choose(n, w, lanes)
    costs = {r: autotune.predict_cost(n, w, lanes, 1, r)
             for r in autotune.routes(w)}
    rl = autotune.roofline(n, w, lanes)
    print(f"phase 24: autotune.choose({n}, {w}, {lanes}) = {choice.route}; "
          f"predict_cost " + ", ".join(f"{r} {c * 1e6:.3f} us"
                                       for r, c in costs.items())
          + f" (roofline {rl.seconds * 1e6:.3f} us by {rl.bound_by} + "
          f"launch {autotune.LAUNCH_OVERHEAD_S * 1e6:.2f} us)", flush=True)
    check(choice.route == "narrow", f"choose picked {choice.route}")

    rng = np.random.RandomState(24)
    cases = 0
    for rn, rlanes in ROUTE_SHAPES:
        for case in (random_case, tied_case):
            table, mask, valid = case(rng, rn, rlanes)
            want = ref.count_stats_ref(table, mask, valid)
            for route in autotune.ROUTES:
                compare(bitset_ops.count_stats(table, mask, valid,
                                               route=route), want,
                        f"count_stats route={route} n={rn} L={rlanes}",
                        report["parity"]["count_stats"])
                cases += 1
        for kind in STACKED_KINDS:
            tables, inst, mask, valid = stacked_case(rng, ROUTE_K, rn,
                                                     rlanes, kind)
            want = ref.stacked_count_stats_ref(tables, inst, mask, valid)
            for route in autotune.ROUTES:
                compare(bitset_ops.stacked_count_stats(
                    tables, inst, mask, valid, route=route), want,
                    f"stacked_count_stats route={route} {kind} "
                    f"K={ROUTE_K} n={rn} L={rlanes}",
                    report["parity"]["stacked_count_stats"])
                cases += 1
    print(f"phase 24: both routes of count_stats and stacked_count_stats "
          f"(K={ROUTE_K}) bitwise equal to plain on {cases} cases at "
          f"(n, L) in {ROUTE_SHAPES}", flush=True)

    measured = {}
    for name, shape in (("count_stats", (n, w, lanes, 1)),
                        ("stacked_count_stats", (100, 4, 1024, ROUTE_K))):
        got = autotune.measured_choice(*shape)
        measured[name] = dict(shape=shape, route=got.route,
                              ms=got.measured_ms)
        print(f"phase 24: measured_choice{shape} ({name}) = {got.route}: "
              + ", ".join(f"{r} {ms * 1e3:.2f} us" for r, ms in
                          got.measured_ms.items())
              + f" a launch (CUDA events over 200) on {card}", flush=True)
    autotune.clear_cache()
    report["autotune"] = dict(choose=choice.route, predict_cost_s=costs,
                              route_cases=cases, measured=measured)


def check_twin(report, twin):
    """Hold phases 19, 20 and 22 against the CPU twin's parts."""
    for part in TWIN_PARTS:
        check(twin[part].get("done") or (part == "cell60"
                                         and twin[part].get("digests")),
              f"CPU twin {part} failed or ran out of time (rc "
              f"{twin[part].get('rc')}; chiprun_out/cpu_twin_{part}.log)")
    card = report["mesh_drain"]["digests"]
    differ = [i + 1 for i, (a, b) in enumerate(zip(card,
                                                   twin["drain"]["digests"]))
              if a != b]
    check(twin["drain"]["digests"] == card,
          f"mesh drain: lanes differ from the CPU's in rounds {differ}")
    print(f"phase 19: the first {len(card)} rounds' gathered lanes are "
          f"bitwise the CPU's {MESH_SHARDS}-shard run's (SHA-256 of every "
          f"array); the drained CPU run is not compared: its rounds take "
          f"seconds each on the host", flush=True)
    shared = report["mesh_service"]
    cpu = twin["service"]["service"]
    for key in ("results", "tickets", "rounds", "resizes"):
        check(shared[key] == cpu[key],
              f"mesh service: {key} differ from the CPU's: {shared[key]} "
              f"vs {cpu[key]}")
    print("phase 22: results, ticket states, rounds and resize events equal "
          "the CPU's run of the same schedule", flush=True)
    cpu60 = twin["cell60"]["digests"]
    card60 = report["mesh_cell60"]["digests"]
    check(cpu60 == card60[:len(cpu60)],
          f"mesh cell60: {len(cpu60)} CPU rounds, digests differ")
    seconds = {part: round(twin[part].get("seconds", 0), 1)
               for part in TWIN_PARTS}
    print(f"phase 20: the first {len(cpu60)} of {len(card60)} rounds' "
          f"gathered lanes are bitwise the CPU's; the CPU twin's parts ran "
          f"{seconds} s beside the card's phases", flush=True)
    report["cpu_twin"] = dict(seconds=seconds, cell60_rounds=len(cpu60),
                              rc={p: twin[p].get("rc") for p in TWIN_PARTS})


# -- phase 25: the host-sync audit ------------------------------------------

def static_checks():
    """``python -m repro_torch.analysis`` over the checkout (in a process
    of its own, as a user runs it): fails on any error; returns its JSON
    report (files, the round loop's scanned functions)."""
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    path = out / "torch_lint.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--json", str(path)],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        capture_output=True, text=True, timeout=300)
    check(proc.returncode == 0, f"python -m repro_torch.analysis exited "
                                f"{proc.returncode}:\n{proc.stdout}"
                                f"{proc.stderr}")
    return json.loads(path.read_text())


@contextlib.contextmanager
def sync_debug(mode):
    """``torch.cuda.set_sync_debug_mode(mode)`` inside the block: "error"
    raises at any synchronizing CUDA operation, "warn" warns at each."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode(mode)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)


def audited_rounds(what, round_fn, lanes, rounds):
    """``rounds`` applications of ``round_fn`` from ``lanes``, every sync
    counted: each round must make ``ROUND_FN_SYNCS``, its readback, and
    raises otherwise; then the same rounds with debug mode off: the lanes
    must be bitwise equal (SHA-256 of every array).  Returns the
    digest."""
    def go(audit):
        cur, syncs = lanes, []
        for _ in range(rounds):
            if audit:
                n, (cur, _) = counted_syncs(lambda c=cur: round_fn(c))
                syncs.append(n)
            else:
                cur, _ = round_fn(cur)
        return lanes_digest(cur), syncs

    audited, syncs = go(True)
    if any(n != ROUND_FN_SYNCS for n in syncs):
        raise RuntimeError(f"chip_smoke: {what}: host syncs in its rounds "
                           f"{syncs} (want {ROUND_FN_SYNCS} each: the "
                           f"round's readback)")
    plain, _ = go(False)
    check(audited == plain, f"{what}: lanes after {rounds} audited rounds "
                            f"differ from the same rounds unaudited")
    return audited


def counted_syncs(fn):
    """(synchronizing CUDA operations inside ``fn()``, its result)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")     # every repeat, not the first
        with sync_debug("warn"):
            out = fn()
    return sum("synchronizing CUDA operation" in str(w.message)
               for w in caught), out


def sync_solve(mesh, rounds, traced=False):
    """A ``Solver.solve`` of ``SYNC_SOLVE`` for ``rounds`` rounds with no
    listener (bare, or traced and metered), ready to run."""
    from repro_torch import registry
    from repro_torch.solver import Solver, SolverConfig
    tag = "mesh" if mesh is not None else "one_device"
    trace = (str(TRACES / f"sync_audit_{tag}_{rounds}.jsonl")
             if traced else None)
    config = SolverConfig(
        lanes=MESH_LANES if mesh is not None else DRAIN_LANES,
        steps_per_round=64, max_rounds=rounds, device=DEV, mesh=mesh,
        trace_path=trace, metrics=traced)
    return lambda: Solver(config).solve(registry.problem(*SYNC_SOLVE))


def phase_sync_audit(report, cell60_lanes, mesh60):
    """The static claim (no host sync inside the round loop) held against
    the card: the lint first, then the round functions of the cell60
    solve, the service, the 4-shard mesh and subset sum with every sync
    an error, then whole host rounds counted."""
    from repro_torch import registry
    from repro_torch.core.distributed import make_round
    from repro_torch.core.engine import init_lanes
    from repro_torch.problems.graphs import cell60_graph
    from repro_torch.problems.vertex_cover import make_vertex_cover
    t0 = time.perf_counter()
    lint = static_checks()
    lint_s = time.perf_counter() - t0
    print(f"phase 25: python -m repro_torch.analysis: {lint['files']} "
          f"files, 0 errors, {len(lint['scanned'])} functions in the round "
          f"loop's scope ({lint_s:.1f} s)", flush=True)

    audited = {}
    cell60 = make_vertex_cover(cell60_graph(), device=DEV)
    audited["cell60"] = (CELL60_LANES, AUDIT_ROUNDS, audited_rounds(
        "cell60", make_round(cell60, 64), cell60_lanes, AUDIT_ROUNDS))

    svc = new_service(DEV, SERVICE["lanes"], SERVICE["steps"],
                      SERVICE["max_n"], SERVICE["slots"])
    submit_all(svc, [(f, s, {}) for f, s, _ in SERVICE_MIX])
    svc.step_round()                        # admissions: host surgery
    audited["service"] = (SERVICE["lanes"], AUDIT_ROUNDS, audited_rounds(
        "service", svc._round, svc.lanes, AUDIT_ROUNDS))

    mesh, problems, lanes = mesh60
    audited["mesh cell60"] = (MESH_SHARDS * MESH_CELL60_LANES, 1,
                              audited_rounds("mesh cell60", make_round(
                                  problems, 64, mesh=mesh), lanes, 1))

    ss = registry.problem("ss", SUBSET_SUM).build(device=DEV)
    ss_round = make_round(ss, 64)
    ss_lanes, _ = ss_round(init_lanes(ss, DRAIN_LANES))
    audited["subset sum"] = (DRAIN_LANES, AUDIT_ROUNDS, audited_rounds(
        "subset sum", ss_round, ss_lanes, AUDIT_ROUNDS))

    def planted(lanes):                     # the check must be able to fail
        lanes, open_work = ss_round(lanes)
        int(lanes.nodes.sum())
        return lanes, open_work
    try:
        audited_rounds("planted", planted, ss_lanes, 1)
        caught = False
    except RuntimeError:
        caught = True
    check(caught, "a sync planted in a round function went unnoticed")
    for what, (width, rounds, _) in audited.items():
        print(f"phase 25: {what} round function at {width} lanes, "
              f"{rounds} round(s) with set_sync_debug_mode(\"warn\"): "
              f"{ROUND_FN_SYNCS} sync a round, its readback; lanes bitwise "
              f"those of the same rounds unaudited", flush=True)
    # The host-copy hazard of the lint (``torch.tensor`` in a round, as
    # subset sum's root() once made three a round) on this card.
    copies, _ = counted_syncs(
        lambda: torch.tensor(0, dtype=torch.int32, device=DEV))
    print(f"phase 25: an int() planted in subset sum's round is caught; "
          f"one torch.tensor(0, device=...) is {copies} sync(s)", flush=True)

    # A round's syncs: those of a SYNC_ROUNDS-round solve less those of a
    # one-round-shorter one (their set-up and wind-down are the same).
    counts = {}
    for where, mesh_of, kinds in (
            ("one device", None, ("bare", "traced")),
            ("mesh", shard_mesh(DEV_MESH, MESH_SHARDS), ("bare",))):
        plain = lanes_digest(sync_solve(mesh_of, SYNC_ROUNDS)().lanes)
        for kind in kinds:
            traced = kind == "traced"
            few, _ = counted_syncs(sync_solve(mesh_of, SYNC_ROUNDS - 1,
                                              traced))
            many, res = counted_syncs(sync_solve(mesh_of, SYNC_ROUNDS,
                                                 traced))
            what = f"{where}, {kind}"
            counts[what] = many - few
            check(res.stats.rounds == SYNC_ROUNDS
                  and lanes_digest(res.lanes) == plain,
                  f"{what}: {res.stats.rounds} rounds, or lanes that differ "
                  f"from the same solve's without debug mode")
            check(counts[what] == SYNCS_PER_ROUND[what],
                  f"{what}: {counts[what]} syncs a round, documented "
                  f"{SYNCS_PER_ROUND[what]}")
    seconds = time.perf_counter() - t0
    print(f"phase 25: whole rounds of Solver.solve ({' '.join(SYNC_SOLVE)}, "
          f"{DRAIN_LANES} lanes; mesh {MESH_SHARDS} x {MESH_LANES}): host "
          f"syncs a round {counts} (documented {SYNCS_PER_ROUND}); lanes "
          f"bitwise those of the same solves without debug mode; "
          f"{seconds:.1f} s on {report['card']}", flush=True)
    report["sync_audit"] = dict(
        lint_files=lint["files"], lint_scanned=len(lint["scanned"]),
        lint_s=lint_s, audited={k: dict(lanes=w, rounds=r, digest=d)
                                for k, (w, r, d) in audited.items()},
        syncs_per_round=counts, host_copy_syncs=copies, seconds=seconds)


# -- phase 26: LM serving ---------------------------------------------------

@contextlib.contextmanager
def kernels_held(report, live):
    """Inside the block, every call of the model's two kernel wrappers
    (``kernels.flash_attention.flash_attention``, ``kernels.ssd_scan
    .ssd_scan``, which ``models.blocks`` calls through their modules) is
    held against its plain version on the same live inputs, at phase
    12's and 13's tolerances; ``live`` keeps the first call of each
    (inputs and outputs) for the timing."""
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as ssd_mod
    flash, scan = fa_mod.flash_attention, ssd_mod.ssd_scan

    def held_flash(q, k, v, *, window=None, softcap=0.0, query_scale=None,
                   block_q=128, block_k=128):
        out = flash(q, k, v, window=window, softcap=softcap,
                    query_scale=query_scale)
        want = ref.flash_attention_ref(q, k, v, window=window,
                                       softcap=softcap,
                                       query_scale=query_scale,
                                       block_q=128, block_k=128)
        dt = "bf16" if q.dtype == torch.bfloat16 else "f32"
        err, rel, ok = close(out, want, TOL[dt], REL_TOL[dt])
        note_error(report["parity"]["flash_attention"], err, rel)
        check(ok, f"flash_attention on the model's live inputs "
                  f"{tuple(q.shape)}: max abs err {err}, normalised {rel}")
        live.setdefault("flash_attention", (q, k, v, out, window, softcap,
                                            query_scale))
        return out

    def held_scan(x, dt, a, b, c, d, chunk=64):
        y, state = scan(x, dt, a, b, c, d, chunk=chunk)
        y_want, st_want = ref.ssd_scan_ref(x, dt, a, b, c, d, chunk=chunk)
        kind = "bf16" if x.dtype == torch.bfloat16 else "f32"
        y_err, y_rel, y_ok = close(y, y_want, SSD_TOL[kind],
                                   SSD_REL_TOL[kind])
        st_err, st_rel, st_ok = close(state, st_want, STATE_TOL, STATE_TOL)
        parity = report["parity"]["ssd_scan"]
        note_error(parity, y_err, y_rel)
        note_error(parity, st_err, st_rel)
        check(y_ok and st_ok, f"ssd_scan on the model's live inputs "
                              f"{tuple(x.shape)}: y max abs err {y_err}, "
                              f"normalised {y_rel}; state {st_err}, "
                              f"{st_rel}")
        live.setdefault("ssd_scan", ((x, dt, a, b, c, d), chunk))
        return y, state

    fa_mod.flash_attention, ssd_mod.ssd_scan = held_flash, held_scan
    try:
        yield
    finally:
        fa_mod.flash_attention, ssd_mod.ssd_scan = flash, scan


def launches_since(before):
    """The model kernels' launches since the ``before`` snapshot."""
    from repro_torch.kernels import _build
    return {k: _build.LAUNCHES[k] - before[k]
            for k in ("flash_attention", "ssd_scan")}


def lm_run(cfg, params, toks, s, n, vision=None):
    """Prefill ``toks[:, :s]`` (and a vlm model's ``vision``), then ``n``
    teacher-forced decode steps, on the parameters' device: ({step:
    logits}, {"prefill" / "decoded": cache}), in f32 on the CPU, and the
    prefill's launches."""
    from repro_torch.core.api import tree_map
    from repro_torch.kernels import _build
    from repro_torch.models import model
    from repro_torch.serve import make_decode_step, make_prefill_step
    dev = params["embed"].device
    toks = torch.from_numpy(toks).to(dev)
    before = dict(_build.LAUNCHES)
    logits, cache = make_prefill_step(cfg, 128, 128)(
        params, toks[:, :s], None if vision is None else vision.to(dev))
    launched = launches_since(before)
    # A copy, always: on the CPU ``.float().cpu()`` of an f32 leaf is the
    # leaf itself, which the decode steps then write in place.
    host = lambda tree: tree_map(  # noqa: E731
        lambda x: x.to("cpu", torch.float32, copy=True), tree)
    out = {"prefill": logits.float().cpu()}
    caches = {"prefill": host(cache)}
    cache = model.pad_cache(cfg, cache, s + n)
    decode = make_decode_step(cfg)
    for i in range(n):
        logits, cache = decode(params, cache, toks[:, s + i:s + i + 1], s + i)
        out[f"decode {i}"] = logits.float().cpu()
    caches["decoded"] = host(cache)
    return out, caches, launched


def card_against_cpu(what, cfg, params, toks, s, n, vision=None):
    """``lm_run`` on the card and on the CPU (the same parameters, moved):
    every logits row and the prefill's cache within ``LM_TOL``; the cache
    after the decode steps measured (max abs and normalised error per
    leaf), not held.  Returns the errors and the card's prefill
    launches."""
    from repro_torch.core.api import tree_leaves, tree_map
    card, card_cache, launched = lm_run(cfg, params, toks, s, n, vision)
    cpu_params = tree_map(lambda x: x.cpu(), params)
    cpu, cpu_cache, _ = lm_run(cfg, cpu_params, toks, s, n, vision)
    errs = {}
    for step in card:
        errs[step] = float((card[step] - cpu[step]).abs().max())
        check(torch.allclose(card[step], cpu[step], rtol=LM_TOL,
                             atol=LM_TOL),
              f"{what}: {step} logits, card against CPU: max abs err "
              f"{errs[step]} (tol {LM_TOL})")
    for when in card_cache:
        for site in card_cache[when]:
            for name in card_cache[when][site]:
                got = tree_leaves(card_cache[when][site][name])
                want = tree_leaves(cpu_cache[when][site][name])
                err = max(float((x - y).abs().max())
                          for x, y in zip(got, want))
                rel = max(float((x - y).norm() / y.norm().clamp_min(1e-30))
                          for x, y in zip(got, want))
                key = f"{when} {site}.{name}"
                errs[key] = (err, rel)
                check(when != "prefill" or all(
                    torch.allclose(x, y, rtol=LM_TOL, atol=LM_TOL)
                    for x, y in zip(got, want)),
                    f"{what}: cache {key}, card against CPU: max abs err "
                    f"{err}, normalised {rel} (tol {LM_TOL})")
    return errs, launched


def errors_text(errs):
    return ", ".join(f"{k} {v:.3g}" if not isinstance(v, tuple) else
                     f"{k} {v[0]:.3g} (normalised {v[1]:.2g})"
                     for k, v in errs.items())


def profile_text(prof):
    """``device_busy``'s result as printed."""
    return (f"wall {prof['wall_ms']:.1f} ms, device {prof['device_ms']:.1f}"
            f" ms (busy {prof['busy_share']:.2f}, {prof['device_ops']} "
            f"kernels and copies; every profiler event: "
            f"{prof['all_events_ms']:.1f} ms): " + ", ".join(
                f"{g} {ms:.2f}" for g, ms in prof["groups_ms"].items())
            + " ms; longest: " + "; ".join(f"{k} {ms:.2f} ms" for k, ms in
                                            prof["top_ms"]))


def phase_lm_serving(report):
    """``LM_ARCH`` at full width and depth on the card through the port's
    serving path: a batched prefill with every kernel launch held against
    its plain version, timed; ``BatchedServer`` serving the prompts (the
    path whose launches the kernels line counts), one decode step with
    every sync an error; one group at full width and the dense path
    (``LM_DENSE``) card against CPU; the two kernels timed at the
    model's shapes."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.core.api import tree_leaves
    from repro_torch.kernels import _build
    from repro_torch.models import model
    from repro_torch.serve import BatchedServer, Request, make_prefill_step
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = configs.get(LM_ARCH)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(LM_SEED)
    params = model.init(cfg, gen, DEV)
    n_params = sum(x.numel() for x in tree_leaves(params))
    check(n_params == cfg.param_count(), f"{LM_ARCH}: {n_params} "
                                         f"parameters, declared "
                                         f"{cfg.param_count()}")
    per_prefill = {"flash_attention": model.n_groups(cfg),
                   "ssd_scan": cfg.n_layers}
    rng = np.random.RandomState(LM_SEED)
    prompts = rng.randint(0, cfg.vocab, (LM_REQUESTS, LM_PROMPT)).astype(
        np.int32)

    # The batched prefill (the launcher's path), every launch checked.
    prefill = make_prefill_step(cfg, block_q=128, block_k=128)
    toks = torch.from_numpy(prompts).to(DEV)
    live = {}
    before = dict(_build.LAUNCHES)
    with kernels_held(report, live):
        logits, _ = prefill(params, toks)
    torch.cuda.synchronize()
    launched = launches_since(before)
    check(launched == per_prefill, f"{LM_ARCH} prefill launches {launched},"
                                   f" expected {per_prefill}")
    check(tuple(logits.shape) == (LM_REQUESTS, cfg.vocab)
          and bool(torch.isfinite(logits.float()).all()),
          f"{LM_ARCH} prefill logits {tuple(logits.shape)}, or not finite")
    del logits
    prefill_ms = []
    for _ in range(LM_PREFILL_REPEATS):
        ms, _ = sync_ms(lambda: prefill(params, toks)[0])
        prefill_ms.append(ms)
    busy = device_busy(lambda: prefill(params, toks)[0])
    busy.pop("out")
    tokens = LM_REQUESTS * LM_PROMPT
    best = min(prefill_ms)
    print(f"phase 26: {LM_ARCH} ({n_params / 1e9:.3f} B parameters, bf16, "
          f"{model.n_groups(cfg)} shared-block sites, {cfg.n_layers} mamba "
          f"layers) prefill of {LM_REQUESTS} x {LM_PROMPT} tokens: "
          f"{launched['flash_attention']} flash_attention and "
          f"{launched['ssd_scan']} ssd_scan launches, each within tolerance "
          f"of its plain version on its live inputs; "
          f"{', '.join(f'{m:.1f}' for m in prefill_ms)} ms, "
          f"{tokens / best * 1e3:.0f} prefill tokens/s at the best; "
          f"profiled: {profile_text(busy)}", flush=True)

    # BatchedServer: the serving entry point.  Each admission's prefill
    # and each tick's decode step are timed between synchronizes, and
    # their launches counted; the first decode step runs with every sync
    # an error (the tick's read of the sampled tokens is outside it).
    server = BatchedServer(cfg, params, LM_SLOTS, LM_PROMPT + LM_NEW,
                           block=128)
    step_prefill, step_decode = server.prefill, server.decode
    admits, ticks = [], []

    def timed(step, into, audit=False):
        def run(*args):
            before = dict(_build.LAUNCHES)
            torch.cuda.synchronize()
            t = time.perf_counter()
            if audit and not into:
                with sync_debug("error"):
                    out = step(*args)
            else:
                out = step(*args)
            torch.cuda.synchronize()
            into.append(((time.perf_counter() - t) * 1e3,
                         launches_since(before)))
            return out
        return run
    server.prefill = timed(step_prefill, admits)
    server.decode = timed(step_decode, ticks, audit=True)
    reqs = [Request(rid=i, prompt=prompts[i], max_new=LM_NEW)
            for i in range(LM_REQUESTS)]
    _build.reset_launches()
    t_run = time.perf_counter()
    server.run(reqs)
    run_s = time.perf_counter() - t_run
    for name in ("flash_attention", "ssd_scan"):
        report["launches"][name] = _build.LAUNCHES[name]
    check(all(r.done and len(r.out) == LM_NEW
              and all(0 <= x < cfg.vocab for x in r.out) for r in reqs),
          f"BatchedServer: requests not served {LM_NEW} tokens each")
    check(len(admits) == LM_REQUESTS and len(ticks) == LM_NEW,
          f"BatchedServer: {len(admits)} prefills, {len(ticks)} ticks")
    check(all(c == per_prefill for _, c in admits),
          f"launches per admission's prefill {[c for _, c in admits]}")
    check(all(c == {"flash_attention": 0, "ssd_scan": 0} for _, c in ticks),
          f"launches per decode step {[c for _, c in ticks]}")
    decode_busy = device_busy(lambda: step_decode(
        params, server.cache, server.next_tok, server.pos - 1)[0])
    decode_busy.pop("out")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    tick_ms = sorted(ms for ms, _ in ticks)
    admit_ms = [ms for ms, _ in admits]
    median_tick = tick_ms[len(tick_ms) // 2]
    print(f"phase 26: BatchedServer ({LM_SLOTS} slots, {LM_REQUESTS} "
          f"requests of {LM_PROMPT} tokens, {LM_NEW} new each) in "
          f"{run_s:.2f} s: {per_prefill['flash_attention']} flash_attention "
          f"and {per_prefill['ssd_scan']} ssd_scan launches per "
          f"admission's prefill, none per decode step; the first decode "
          f"step under set_sync_debug_mode(\"error\"): no sync; prefill "
          f"(B=1) {', '.join(f'{m:.1f}' for m in admit_ms)} ms, "
          f"{LM_PROMPT / min(admit_ms) * 1e3:.0f} tokens/s at the best; "
          f"decode step {tick_ms[0]:.2f} / {median_tick:.2f} / "
          f"{tick_ms[-1]:.2f} ms (min / median / max), "
          f"{LM_SLOTS / median_tick * 1e3:.1f} decode tokens/s at the "
          f"median; peak memory {peak:.2f} GiB; on {report['card']}",
          flush=True)
    print(f"phase 26: profiled decode step: {profile_text(decode_busy)}",
          flush=True)
    del server, step_prefill, step_decode

    # The kernels at the model's shapes, on the first site's live inputs.
    q, k, v, out, window, softcap, qs = live["flash_attention"]
    attn = time_attention(report, LM_ARCH, q, k, v, out, window, softcap, qs,
                          inputs="live: the first shared-block site of the "
                                 "batched prefill")
    args, chunk = live["ssd_scan"]
    ssd = time_ssd(LM_ARCH, args, chunk,
                   inputs="live: the first mamba layer of the batched "
                          "prefill")
    print(f"phase 26: flash_attention at {LM_ARCH}'s prefill (B={q.shape[0]}"
          f" S={q.shape[1]} H={q.shape[2]} G={k.shape[2]} hd={q.shape[3]}, "
          f"bf16): {timing_text(attn)}", flush=True)
    print(f"phase 26: ssd_scan at {LM_ARCH}'s prefill (B={args[0].shape[0]}"
          f" S={args[0].shape[1]} H={args[0].shape[2]} P={args[0].shape[3]} "
          f"G={args[3].shape[2]} N={args[3].shape[3]} chunk={chunk}, bf16): "
          f"{timing_text(ssd)}; passes " + ", ".join(
              f"{kk} {vv * 1e3:.1f} us" for kk, vv in
              ssd["kernels_ms"].items()), flush=True)
    del live, q, k, v, out, args

    # One hybrid group at full width, card against CPU.
    b, s, n = LM_TWIN
    one = dataclasses.replace(cfg, n_layers=cfg.hybrid_period)
    one_params = dict(params, layers=params["layers"][:1])
    del params
    torch.cuda.empty_cache()
    twin_toks = rng.randint(0, cfg.vocab, (b, s + n)).astype(np.int32)
    t_twin = time.perf_counter()
    twin_errs, twin_launched = card_against_cpu(
        f"{LM_ARCH}, one group", one, one_params, twin_toks, s, n)
    twin_s = time.perf_counter() - t_twin
    check(twin_launched == {"flash_attention": 1,
                            "ssd_scan": cfg.hybrid_period},
          f"one group's prefill launches {twin_launched}")
    print(f"phase 26: {LM_ARCH} cut to one group (the shared block and "
          f"{cfg.hybrid_period} mamba layers, full width), B={b} S={s}, "
          f"{n} teacher-forced decode steps: card against CPU, logits and "
          f"the prefill's cache within {LM_TOL}: max abs err "
          f"{errors_text(twin_errs)} ({twin_s:.1f} s)", flush=True)
    del one_params
    torch.cuda.empty_cache()

    # The dense path.
    arch, layers, b, s, n = LM_DENSE
    dense = dataclasses.replace(configs.get(arch), n_layers=layers)
    gen.manual_seed(LM_SEED)
    dense_params = model.init(dense, gen, DEV)
    dense_toks = rng.randint(0, dense.vocab, (b, s + n)).astype(np.int32)
    t_dense = time.perf_counter()
    dense_errs, dense_launched = card_against_cpu(
        f"{arch}, {layers} layers", dense, dense_params, dense_toks, s, n)
    dense_s = time.perf_counter() - t_dense
    check(dense_launched == {"flash_attention": layers, "ssd_scan": 0},
          f"{arch} prefill launches {dense_launched}")
    print(f"phase 26: {arch} at full width, {layers} of its "
          f"{configs.get(arch).n_layers} layers, B={b} S={s}, {n} "
          f"teacher-forced decode steps ({dense_launched['flash_attention']}"
          f" flash_attention launches per prefill, hd={dense.head_dim}, "
          f"GQA r={dense.kv_groups}): card against CPU, logits and the "
          f"prefill's cache within {LM_TOL}: max abs err "
          f"{errors_text(dense_errs)} ({dense_s:.1f} s)", flush=True)
    del dense_params
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t0
    print(f"phase 26: {seconds:.1f} s on {report['card']}", flush=True)
    report["lm"] = dict(
        arch=LM_ARCH, parameters=n_params, prefill_launches=launched,
        prefill_ms=prefill_ms, prefill_tokens_per_s=tokens / best * 1e3,
        prefill_profile=busy, serve_s=run_s, admit_ms=admit_ms,
        decode_step_ms=[ms for ms, _ in ticks],
        decode_tokens_per_s=LM_SLOTS / median_tick * 1e3,
        decode_profile=decode_busy, peak_gib=peak,
        serve_launches={k: report["launches"][k]
                        for k in ("flash_attention", "ssd_scan")},
        one_group_errors=twin_errs, one_group_s=twin_s,
        dense_errors=dense_errs, dense_s=dense_s, seconds=seconds)
    return attn, ssd


# -- phase 27: the moe, vlm and audio families and the int8 KV cache -------

def cut(cfg, layers):
    """``cfg`` with its first ``layers`` layers (None: all of them)."""
    import dataclasses
    return cfg if layers is None else dataclasses.replace(cfg,
                                                          n_layers=layers)


def cache_bytes(cache):
    from repro_torch.core.api import tree_leaves
    return sum(x.numel() * x.element_size() for x in tree_leaves(cache))


def serve_run(report, cfg, params, prompts, new, kv_quant, live=None):
    """``BatchedServer`` with one slot a prompt serving ``prompts`` for
    ``new`` tokens each: every admission's prefill and tick timed between
    synchronizes with its launches counted, the first admission's
    prefill with every kernel launch held against its plain version (when
    ``live`` is given), the first tick under
    ``set_sync_debug_mode("error")``.  The launches are counted from 0
    over the run and added to the kernels line's."""
    from repro_torch.kernels import _build
    from repro_torch.serve import BatchedServer, Request
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    slots, plen = len(prompts), prompts.shape[1]
    server = BatchedServer(cfg, params, slots, plen + new, block=128,
                           kv_quant=kv_quant)
    step_prefill, step_decode = server.prefill, server.decode
    admits, ticks = [], []

    def timed(step, into, first):
        def run(*args):
            before = dict(_build.LAUNCHES)
            torch.cuda.synchronize()
            t = time.perf_counter()
            with (first() if not into else contextlib.nullcontext()):
                out = step(*args)
            torch.cuda.synchronize()
            into.append(((time.perf_counter() - t) * 1e3,
                         launches_since(before)))
            return out
        return run
    server.prefill = timed(step_prefill, admits, lambda: (
        kernels_held(report, live) if live is not None
        else contextlib.nullcontext()))
    server.decode = timed(step_decode, ticks, lambda: sync_debug("error"))
    reqs = [Request(rid=i, prompt=prompts[i], max_new=new)
            for i in range(slots)]
    _build.reset_launches()
    t_run = time.perf_counter()
    server.run(reqs)
    run_s = time.perf_counter() - t_run
    served = {k: _build.LAUNCHES[k] for k in ("flash_attention", "ssd_scan")}
    for name, count in served.items():
        report["launches"][name] += count
    per_prefill = {"flash_attention": cfg.n_layers, "ssd_scan": 0}
    def ok_token(x):                 # audio: a list of n_codebooks codes
        return all(0 <= c < cfg.vocab for c in (
            x if cfg.n_codebooks else [x]))
    check(all(r.done and len(r.out) == new and all(map(ok_token, r.out))
              for r in reqs),
          f"{cfg.name}: requests not served {new} tokens each")
    check(len(admits) == slots and len(ticks) == new,
          f"{cfg.name}: {len(admits)} prefills, {len(ticks)} ticks")
    check(all(c == per_prefill for _, c in admits),
          f"{cfg.name}: launches per admission's prefill "
          f"{[c for _, c in admits]}, expected {per_prefill}")
    check(all(c == {"flash_attention": 0, "ssd_scan": 0} for _, c in ticks),
          f"{cfg.name}: launches per decode step {[c for _, c in ticks]}")
    admit_ms = [ms for ms, _ in admits]
    tick_ms = sorted(ms for ms, _ in ticks)
    median = tick_ms[len(tick_ms) // 2]
    return dict(
        run_s=run_s, admit_ms=admit_ms, decode_step_ms=[ms for ms, _ in
                                                        ticks],
        prefill_tokens_per_s=plen / min(admit_ms) * 1e3,
        decode_tokens_per_s=slots / median * 1e3, median_tick_ms=median,
        min_tick_ms=tick_ms[0], max_tick_ms=tick_ms[-1],
        launches_per_prefill=per_prefill, launches=served,
        peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        cache_bytes=cache_bytes(server.cache),
        tokens=[r.out for r in reqs])


def serve_text(arch, kv_quant, r, slots, plen, new):
    per_prefill = r["launches_per_prefill"]["flash_attention"]
    return (f"{arch}{' (int8 KV cache)' if kv_quant else ''}: "
            f"BatchedServer, {slots} slots x {plen} tokens, {new} new each, "
            f"in {r['run_s']:.2f} s: {per_prefill} flash_attention launches"
            f" per admission's prefill, none per decode step; the first "
            f"tick under "
            f"set_sync_debug_mode(\"error\"): no sync; prefill (B=1) "
            f"{', '.join(f'{m:.1f}' for m in r['admit_ms'])} ms, "
            f"{r['prefill_tokens_per_s']:.0f} tokens/s at the best; decode "
            f"tick {r['min_tick_ms']:.2f} / {r['median_tick_ms']:.2f} / "
            f"{r['max_tick_ms']:.2f} ms (min / median / max), "
            f"{r['decode_tokens_per_s']:.1f} decode tokens/s at the median;"
            f" peak memory {r['peak_gib']:.2f} GiB; cache "
            f"{r['cache_bytes'] / 1e6:.1f} MB")


@contextlib.contextmanager
def moe_recorded(calls, layers=None):
    """Inside the block, every MoE call's (router input, router) goes to
    ``calls`` and, with ``layers``, every transformer layer's (parameters,
    input, context, window), on the host, in call order."""
    from repro_torch.models import blocks
    moe_ffn, layer = blocks.moe_ffn, blocks.apply_transformer_layer

    def rec_moe(x, prm, cfg):
        calls.append((x.to("cpu", copy=True), prm["router"].cpu()))
        return moe_ffn(x, prm, cfg)

    def rec_layer(p, h, ctx, window, cache=None):
        layers.append((p, h.to("cpu", copy=True), ctx, window))
        return layer(p, h, ctx, window, cache)
    blocks.moe_ffn = rec_moe
    if layers is not None:
        blocks.apply_transformer_layer = rec_layer
    try:
        yield
    finally:
        blocks.moe_ffn, blocks.apply_transformer_layer = moe_ffn, layer


def routing_ties(what, cfg, cpu_calls, card_calls):
    """The card's routing against the CPU's, MoE call by call: expert ids
    equal on every token that is no near-tie on the CPU side
    (``models.moe.near_ties``, bf16: the larger of 1e-4 and the bf16
    resolution of the router input carried to the gap in quadrature).
    The near-tie masks, and their count."""
    from repro_torch.models import moe
    check(len(cpu_calls) == len(card_calls) > 0,
          f"{what}: {len(cpu_calls)} MoE calls on the CPU, "
          f"{len(card_calls)} on the card")
    masks = []
    for i, ((x, r), (y, _)) in enumerate(zip(cpu_calls, card_calls)):
        tied = moe.near_ties(x, r, cfg.moe, bf16=x.dtype == torch.bfloat16)
        want, _ = moe.route(x, r, cfg.moe)
        got, _ = moe.route(y, r, cfg.moe)
        bad = (want != got).any(dim=-1) & ~tied
        check(not bool(bad.any()), f"{what}: MoE call {i} routes "
                                   f"{int(bad.sum())} token(s) otherwise "
                                   f"on the card, no near-tie")
        masks.append(tied)
    return masks, sum(int(m.sum()) for m in masks)


def layer_pair(what, cfg, card_p, cpu_p, h, ctx, window):
    """One transformer layer on the card and on the CPU from the same
    input ``h`` (host): the output's max abs error over the tokens whose
    routing (a MoE layer's) is no near-tie, held within ``LM_TOL``; the
    near-tie count."""
    from repro_torch.models import blocks
    calls = []
    with moe_recorded(calls):
        want, _ = blocks.apply_transformer_layer(cpu_p, h, ctx, window)
        got, _ = blocks.apply_transformer_layer(card_p, h.to(DEV), ctx,
                                                window)
    keep = torch.ones(h.shape[:2], dtype=torch.bool)
    ties = 0
    if cfg.moe is not None:
        (tied,), ties = routing_ties(what, cfg, calls[:1], calls[1:])
        keep = ~tied.reshape(h.shape[:2])
    got, want = got.float().cpu()[keep], want.float()[keep]
    err = float((got - want).abs().max())
    check(torch.allclose(got, want, rtol=LM_TOL, atol=LM_TOL),
          f"{what}: output card against CPU, max abs err {err} (tol "
          f"{LM_TOL})")
    return err, ties


def family_twin(arch):
    """``arch``'s smoke configuration (bf16, head_dim 16: the flash kernel
    zero-pads it to 64) on the card and on the CPU from the same
    parameters.  A MoE model's routing first, at every MoE call; with a
    near-tie, the layers of the CPU's prefill again, each on both sides
    from the CPU's input to it; without one, ``card_against_cpu``."""
    from repro_torch import configs
    from repro_torch.core.api import tree_map
    from repro_torch.models import model
    cfg = configs.smoke(arch)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(FAMILY_SEED)
    params = model.init(cfg, gen, DEV)
    b, s, n = FAMILY_TWIN
    rng = np.random.RandomState(FAMILY_SEED)
    toks = rng.randint(0, cfg.vocab, (b, s + n) + (
        (cfg.n_codebooks,) if cfg.n_codebooks else ())).astype(np.int32)
    vision = (torch.from_numpy(rng.standard_normal(
        (b, cfg.vision_tokens, cfg.d_model)).astype(np.float32) * 0.02)
        if cfg.vision_tokens else None)
    if cfg.moe is None:
        errs, launched = card_against_cpu(f"{arch} smoke", cfg, params, toks,
                                          s, n, vision)
        check(launched == {"flash_attention": cfg.n_layers, "ssd_scan": 0},
              f"{arch} smoke prefill launches {launched}")
        return f"logits and the prefill's cache within {LM_TOL}: " \
               f"max abs err {errors_text(errs)}"
    cpu_params = tree_map(lambda x: x.cpu(), params)
    cpu_calls, card_calls, cpu_layers = [], [], []
    with moe_recorded(cpu_calls, cpu_layers):
        cpu, _, _ = lm_run(cfg, cpu_params, toks, s, n)
    with moe_recorded(card_calls):
        card, _, launched = lm_run(cfg, params, toks, s, n)
    check(launched == {"flash_attention": cfg.n_layers, "ssd_scan": 0},
          f"{arch} smoke prefill launches {launched}")
    _, ties = routing_ties(f"{arch} smoke", cfg, cpu_calls, card_calls)
    if not ties:
        errs = {}
        for step in card:
            errs[step] = float((card[step] - cpu[step]).abs().max())
            check(torch.allclose(card[step], cpu[step], rtol=LM_TOL,
                                 atol=LM_TOL),
                  f"{arch} smoke: {step} logits, card against CPU: max abs "
                  f"err {errs[step]}")
        return (f"routing equal in {len(cpu_calls)} MoE calls, no "
                f"near-tie; "
                f"logits within {LM_TOL}: max abs err {errors_text(errs)}")
    prefill = [c for c in cpu_layers if c[2].mode == "prefill"]
    check(len(prefill) == cfg.n_layers, f"{arch}: {len(prefill)} layers")
    errs, layer_ties = [], 0
    for i, (p, h, ctx, window) in enumerate(prefill):
        err, t = layer_pair(f"{arch} smoke layer {i}", cfg,
                            params["layers"][i]["blk"], p, h, ctx, window)
        errs.append(err)
        layer_ties += t
    return (f"routing equal in {len(cpu_calls)} MoE calls outside {ties} "
            f"near-tie token(s), so layer by layer (each fed the CPU's "
            f"input): "
            f"max abs err {', '.join(f'{e:.3g}' for e in errs)} within "
            f"{LM_TOL} ({layer_ties} near-tie token(s) left out)")


def moe_profile(fn):
    """One call of ``fn`` under the profiler with each MoE step of
    ``MOE_STEPS`` a range: the device time of its kernels by group, each
    kernel attributed through the host operation that launched it to
    the innermost range around it.  Expert GEMMs are the GEMM kernels
    inside ``expert_ffn``; dispatch/combine every kernel inside route,
    dispatch, gather_tokens and combine; attention the flash kernel;
    elementwise, copies, reductions and the other GEMMs (projections,
    shared expert, head) outside those."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.models import moe
    saved = {name: getattr(moe, name) for name in MOE_STEPS}

    def ranged(name, f):
        def run(*args, **kw):
            with record_function(f"moe.{name}"):
                return f(*args, **kw)
        return run
    for name, f in saved.items():
        setattr(moe, name, ranged(name, f))
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall_ms, _ = sync_ms(fn)
    finally:
        for name, f in saved.items():
            setattr(moe, name, f)
    groups = {}
    total = 0.0
    for evt in prof.events():
        if evt.device_type != DeviceType.CPU or not evt.kernels:
            continue
        rng, up = None, evt
        while up is not None and rng is None:
            if up.name.startswith("moe."):
                rng = up.name[4:]
            up = up.cpu_parent
        for kern in evt.kernels:
            kind = next((g for g, pat in KERNEL_GROUPS
                         if re.search(pat, kern.name, re.IGNORECASE)),
                        "other")
            if kind == "flash_attention":
                group = "attention (flash_attention)"
            elif rng == "expert_ffn":
                group = ("expert GEMMs" if kind == "GEMM"
                         else "expert SwiGLU elementwise")
            elif rng is not None:
                group = "dispatch/combine"
            else:
                group = {"GEMM": "other GEMMs (projections, shared "
                                 "expert, router, head)"}.get(kind, kind)
            groups[group] = groups.get(group, 0.0) + kern.duration
            total += kern.duration
    return dict(wall_ms=wall_ms, device_ms=total / 1e3,
                busy_share=total / 1e3 / wall_ms,
                groups_ms={g: us / 1e3 for g, us in sorted(
                    groups.items(), key=lambda kv: -kv[1])})


def moe_layer_twin(cfg, params):
    """Mixtral's first layer at full width (attention + MoE, bf16) on the
    card and on the CPU from one seeded input [B, S, D]."""
    from repro_torch.core.api import tree_map
    from repro_torch.models import blocks
    b, s = MOE_LAYER_TWIN
    gen = torch.Generator().manual_seed(FAMILY_SEED)
    h = torch.randn((b, s, cfg.d_model), generator=gen).to(torch.bfloat16)
    card_p = params["layers"][0]["blk"]
    cpu_p = tree_map(lambda x: x.cpu(), card_p)
    ctx = blocks.Ctx(cfg=cfg, mode="prefill", block_q=128, block_k=128)
    return layer_pair(f"{cfg.name} layer 0", cfg, card_p, cpu_p, h, ctx,
                      cfg.window)


def phase_lm_families(report):
    """The moe, vlm and audio families and the int8 KV cache on the card
    at full width, through the port's serving entry points: mixtral
    (4 layers) and llama4-scout (4 layers, bf16 and int8 caches) and
    musicgen (all 48) through ``BatchedServer``; internvl2 (4 layers)
    through the launcher's path with its vision input; mixtral's prefill
    profiled by group; ``flash_attention`` timed at mixtral's and
    llama4's live prefill shapes; the four families' smoke configurations
    and mixtral's first layer card against CPU."""
    from repro_torch import configs
    from repro_torch.core.api import tree_leaves
    from repro_torch.kernels import _build
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import model, moe
    from repro_torch.serve import auto_kv_quant, make_prefill_step
    t0 = time.perf_counter()
    out = {"serve": {}, "attention": {}}
    attention = []
    for arch, layers, slots, plen, new, quants in FAMILY_SERVE:
        t_arch = time.perf_counter()
        torch.cuda.empty_cache()
        full = configs.get(arch)
        cfg = cut(full, layers)
        gen = torch.Generator(device=DEV)
        gen.manual_seed(FAMILY_SEED)
        params = model.init(cfg, gen, DEV)
        n_params = sum(x.numel() for x in tree_leaves(params))
        check(n_params == cfg.param_count(), f"{arch}: {n_params} "
                                             f"parameters, declared "
                                             f"{cfg.param_count()}")
        print(f"phase 27: {arch}: {cfg.n_layers} of {full.n_layers} layers "
              f"at full width, {n_params / 1e9:.3f} B parameters "
              f"({n_params * 2 / 1e9:.1f} GB bf16, "
              f"{n_params * 2 / HBM_BYTES_PER_S * 1e3:.2f} ms at HBM rate; "
              f"the full model {full.param_count() / 1e9:.1f} B)",
              flush=True)
        rng = np.random.RandomState(FAMILY_SEED)
        prompts = rng.randint(0, cfg.vocab, (slots, plen) + (
            (cfg.n_codebooks,) if cfg.n_codebooks else ())).astype(np.int32)
        runs = {}
        for kv_quant in quants:
            live = {} if not kv_quant else None
            r = serve_run(report, cfg, params, prompts, new, kv_quant, live)
            runs[kv_quant] = r
            held = ("; every flash_attention launch of the first prefill "
                    "within tolerance of its plain version on its live "
                    "inputs" if live is not None else "")
            print(f"phase 27: "
                  f"{serve_text(arch, kv_quant, r, slots, plen, new)}{held}",
                  flush=True)
            if live is not None and cfg.moe is not None:
                q, k, v, o, window, softcap, qs = live["flash_attention"]
                t = time_attention(
                    report, arch, q, k, v, o, window, softcap, qs,
                    inputs="live: the first layer of the first admission's "
                           "prefill")
                attention.append(t)
                out["attention"][arch] = t
                print(f"phase 27: flash_attention at {arch}'s prefill (B="
                      f"{q.shape[0]} S={q.shape[1]} H={q.shape[2]} G="
                      f"{k.shape[2]} hd={q.shape[3]}, window {window}, "
                      f"bf16): {timing_text(t)}", flush=True)
                del q, k, v, o
            live = None
        if len(runs) == 2:
            same = sum(a == b for x, y in zip(runs[False]["tokens"],
                                             runs[True]["tokens"])
                       for a, b in zip(x, y))
            int8, bf16 = (runs[q]["cache_bytes"] for q in (True, False))
            memory = torch.cuda.get_device_properties(DEV).total_memory
            print(f"phase 27: {arch}: the int8 cache {int8 / 1e6:.1f} MB "
                  f"against the bf16 cache's {bf16 / 1e6:.1f} MB "
                  f"({int8 / bf16:.3f}); {same} of {slots * new} emitted "
                  f"tokens the same in both; auto_kv_quant at the full "
                  f"model, 128 x 32768 on one card of "
                  f"{memory / 2 ** 30:.1f} GiB: "
                  f"{auto_kv_quant(full, 128, 32768, 1, memory)}",
                  flush=True)
        if arch == "mixtral-8x22b":
            toks = torch.from_numpy(prompts[:1]).to(DEV)
            prefill = make_prefill_step(cfg, 128, 128)
            prof = moe_profile(lambda: prefill(params, toks)[0])
            out["mixtral_prefill_profile"] = prof
            # The expert GEMMs' work: 3 GEMMs of [E * C, D] x [D, F] a layer.
            m = cfg.moe
            flops = (6 * m.num_experts * moe.capacity(plen, m) * cfg.d_model
                     * m.d_ff * cfg.n_layers)
            rate = flops / (prof["groups_ms"].get("expert GEMMs", 0.0)
                            or float("inf")) / 1e9
            print(f"phase 27: {arch} prefill (B=1, S={plen}) profiled: "
                  f"wall {prof['wall_ms']:.1f} ms, device "
                  f"{prof['device_ms']:.1f} ms (busy "
                  f"{prof['busy_share']:.2f}): " + ", ".join(
                      f"{g} {ms:.2f}" for g, ms in
                      prof["groups_ms"].items()) + f" ms; the expert GEMMs "
                  f"{flops / 1e12:.1f} TFLOP at capacity "
                  f"{moe.capacity(plen, m)}, {rate:.0f} TFLOP/s "
                  f"({rate * 1e12 / PEAK_FLOPS[torch.bfloat16]:.2f} of the "
                  f"bf16 peak)", flush=True)
            t_layer = time.perf_counter()
            err, ties = moe_layer_twin(cfg, params)
            out["mixtral_layer_twin"] = dict(max_abs_err=err, near_ties=ties)
            b, s = MOE_LAYER_TWIN
            print(f"phase 27: {arch} layer 0 at full width (B={b}, S={s}), "
                  f"one input on both sides: routing equal outside {ties} "
                  f"near-tie token(s), output card against CPU max abs err "
                  f"{err:.4g} within {LM_TOL} on the rest "
                  f"({time.perf_counter() - t_layer:.1f} s)", flush=True)
        out["serve"][arch] = {str(k): {kk: vv for kk, vv in r.items()
                                       if kk != "tokens"}
                              for k, r in runs.items()}
        out["serve"][arch]["seconds"] = time.perf_counter() - t_arch
        print(f"phase 27: {arch}: {time.perf_counter() - t_arch:.1f} s",
              flush=True)
        del params
    # The launcher's path: internvl2 with its vision input.
    arch, layers, b, plen, steps = FAMILY_LAUNCHER
    t_arch = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = cut(configs.get(arch), layers)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(FAMILY_SEED)
    params = model.init(cfg, gen, DEV)
    prompts, vision = launch_serve.inputs(cfg, b, plen, DEV)
    _build.reset_launches()
    r = launch_serve.serve(cfg, params, prompts, steps, vision)
    report["launches"]["flash_attention"] += _build.LAUNCHES[
        "flash_attention"]
    check(_build.LAUNCHES["flash_attention"] == cfg.n_layers
          and _build.LAUNCHES["ssd_scan"] == 0,
          f"{arch}: launches {dict(_build.LAUNCHES)}, expected "
          f"{cfg.n_layers} flash_attention (prefill), none in decode")
    check(tuple(r["tokens"].shape) == (b, steps)
          and bool(((r["tokens"] >= 0) & (r["tokens"] < cfg.vocab)).all()),
          f"{arch}: tokens {tuple(r['tokens'].shape)}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    out["launcher"] = dict(arch=arch, layers=layers, B=b, S=plen,
                           steps=steps, prefill_s=r["prefill_s"],
                           decode_s=r["decode_s"], peak_gib=peak,
                           prefill_tokens_per_s=b * plen / r["prefill_s"],
                           decode_tokens_per_s=b * steps / r["decode_s"])
    print(f"phase 27: {arch} ({layers} of {configs.get(arch).n_layers} "
          f"layers, full width) through the launcher's path, B={b}, "
          f"{plen} tokens with {cfg.vision_tokens} vision embeddings: "
          f"{cfg.n_layers} flash_attention launches in the prefill, none in "
          f"{steps} decode steps; prefill {r['prefill_s'] * 1e3:.1f} ms "
          f"({b * plen / r['prefill_s']:.0f} tokens/s), decode "
          f"{r['decode_s'] / steps * 1e3:.2f} ms a step "
          f"({b * steps / r['decode_s']:.1f} tokens/s); peak memory "
          f"{peak:.2f} GiB ({time.perf_counter() - t_arch:.1f} s)",
          flush=True)
    del params, prompts, vision
    torch.cuda.empty_cache()
    # The smoke configurations, card against CPU.
    out["twins"] = {}
    for arch in ("mixtral-8x22b", "llama4-scout-17b-a16e", "internvl2-76b",
                 "musicgen-large"):
        t_twin = time.perf_counter()
        text = family_twin(arch)
        out["twins"][arch] = text
        print(f"phase 27: {arch} smoke (bf16, hd 16 through the flash "
              f"kernel padded to 64), B={FAMILY_TWIN[0]} S={FAMILY_TWIN[1]}, "
              f"{FAMILY_TWIN[2]} decode steps, card against CPU: {text} "
              f"({time.perf_counter() - t_twin:.1f} s)", flush=True)
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 27: {out['seconds']:.1f} s on {report['card']}",
          flush=True)
    report["lm_families"] = out
    return attention


# -- phase 28: LM training -------------------------------------------------

#: The training step's host ranges (``train/step.py``), in order.
TRAIN_RANGES = ("train.forward", "train.backward", "train.optimizer")


def train_launches(cfg):
    """Each kernel's launches in one training step at one microbatch: one
    a site in the forward, and as many again in the backward's recompute
    under remat; the backward itself runs the plain versions."""
    from repro_torch.models import model
    passes = 1 if cfg.remat == "none" else 2
    sites = model.n_groups(cfg) if cfg.family == "hybrid" else (
        0 if cfg.family == "ssm" else cfg.n_layers)
    return {"flash_attention": passes * sites,
            "ssd_scan": passes * (cfg.n_layers if cfg.family in
                                  ("ssm", "hybrid") else 0)}


def train_args(arch, batch, seq, steps, **kw):
    """The launcher's flags for ``train()`` on the card, ``kw`` over them."""
    from repro_torch.launch import train as launch_train
    args = launch_train.parser().parse_args(
        ["--arch", arch, "--batch", str(batch), "--seq", str(seq),
         "--steps", str(steps), "--seed", str(TRAIN_SEED), "--device", DEV])
    return argparse.Namespace(**{**vars(args), **kw})


@contextlib.contextmanager
def train_taps(grads_out, live):
    """Inside the block: each gradient tree the training step computes
    (``train.step.loss_and_grads``) goes to ``grads_out``, and ``live``
    keeps detached copies of the first inputs (and keyword arguments) of
    each kernel wrapper the model calls."""
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import ssd_scan as ssd_mod
    from repro_torch.train import step as tstep
    grads_fn, flash, scan = (tstep.loss_and_grads, fa_mod.flash_attention,
                             ssd_mod.ssd_scan)

    def tapped_grads(loss, cparams, batch):
        value, grads = grads_fn(loss, cparams, batch)
        grads_out.append(grads)
        return value, grads

    def tap(name, fn):
        def run(*args, **kw):
            if name not in live:
                live[name] = ([t.detach().clone() for t in args], kw)
            return fn(*args, **kw)
        return run

    tstep.loss_and_grads = tapped_grads
    fa_mod.flash_attention = tap("flash_attention", flash)
    ssd_mod.ssd_scan = tap("ssd_scan", scan)
    try:
        yield
    finally:
        tstep.loss_and_grads = grads_fn
        fa_mod.flash_attention, ssd_mod.ssd_scan = flash, scan


def gradient_flags(grads):
    """(leaves, leaves whose gradient is None, a bool tensor on the device:
    True where a leaf's gradient has an element other than 0)."""
    from repro_torch.core.api import tree_leaves
    leaves = tree_leaves(grads)
    given = [g for g in leaves if g is not None]
    return len(leaves), len(leaves) - len(given), torch.stack(
        [torch.amax(torch.abs(g)).float() > 0 for g in given])


def function_parity(report, live):
    """The kernels' gradient Function (``kernels/plain_grad.py``) on the
    step's live inputs: its value within the kernel's tolerances of the
    plain version's, and every input's gradient for one seeded output
    gradient bitwise that of autograd through the plain version."""
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as ssd_mod
    gen = torch.Generator(device=DEV)
    gen.manual_seed(TRAIN_SEED)
    out = {}
    for name, wrapper, plain in (
            ("flash_attention", fa_mod.flash_attention,
             ref.flash_attention_ref),
            ("ssd_scan", ssd_mod.ssd_scan, ref.ssd_scan_ref)):
        args, kw = live[name]
        ins = [t.clone().requires_grad_() for t in args]
        got = wrapper(*ins, **kw)
        want = plain(*ins, **kw)
        got, want = ((x,) if name == "flash_attention" else x
                     for x in (got, want))
        check(type(got[0].grad_fn).__name__ == "PlainGradBackward",
              f"{name}: the wrapper's output on the card has grad_fn "
              f"{type(got[0].grad_fn).__name__}, not the Function's")
        kind = "bf16" if ins[0].dtype == torch.bfloat16 else "f32"
        tol, rel_tol = ((TOL[kind], REL_TOL[kind]) if name == "flash_attention"
                        else (SSD_TOL[kind], SSD_REL_TOL[kind]))
        err, rel, ok = close(got[0].detach(), want[0].detach(), tol,
                             rel_tol)
        note_error(report["parity"][name], err, rel)
        if name == "ssd_scan":
            st_err, st_rel, st_ok = close(got[1].detach(), want[1].detach(),
                                          STATE_TOL, STATE_TOL)
            note_error(report["parity"][name], st_err, st_rel)
            ok = ok and st_ok
        check(ok, f"{name}: the Function's value on the live inputs "
                  f"{tuple(ins[0].shape)}: max abs err {err}, normalised "
                  f"{rel}")
        # Train mode uses y alone: the state gets no gradient.
        g = torch.randn(got[0].shape, generator=gen, device=DEV).to(
            got[0].dtype)
        mine = torch.autograd.grad(got[0], ins, g, allow_unused=True)
        theirs = torch.autograd.grad(want[0], ins, g, allow_unused=True)
        same = [(a is None and b is None) or (
            a is not None and b is not None and bool(torch.equal(a, b)))
            for a, b in zip(mine, theirs)]
        check(all(same), f"{name}: the Function's gradients on the live "
                         f"inputs differ from the plain version's: {same}")
        out[name] = dict(shape=list(ins[0].shape), max_abs_err=err,
                         normalised_err=rel, grads_equal=len(same))
    return out


def train_profile(fn):
    """One call of ``fn`` (a training step) under the profiler: its
    kernels' device time by the step's phase (the range of
    ``TRAIN_RANGES`` whose span holds the start of the host operation
    that launched the kernel; the backward runs in autograd's threads, so
    spans, not parents; "other" is the cast, the schedule and the
    gradient norm) and by group (``KERNEL_GROUPS``; the plain versions
    run inside the kernels' gradient Function, every kernel under a
    ``PlainGradBackward`` node, a group of their own)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_ms, _ = sync_ms(fn)
    events = prof.events()
    spans = [(e.name, e.time_range.start, e.time_range.end) for e in events
             if e.name in TRAIN_RANGES]
    phases = dict.fromkeys(list(TRAIN_RANGES) + ["other"], 0.0)
    groups, total, launches = {}, 0.0, 0
    for evt in events:
        if evt.device_type != DeviceType.CPU or not evt.kernels:
            continue
        phase = next((n for n, a, b in spans
                      if a <= evt.time_range.start <= b), "other")
        up, in_plain = evt, False
        while up is not None and not in_plain:
            in_plain = "PlainGradBackward" in up.name
            up = up.cpu_parent
        for kern in evt.kernels:
            kind = next((g for g, pat in KERNEL_GROUPS
                         if re.search(pat, kern.name, re.IGNORECASE)),
                        "other")
            if in_plain and kind not in ("flash_attention", "ssd_scan"):
                kind = "plain versions in the kernels' backward"
            groups[kind] = groups.get(kind, 0.0) + kern.duration
            phases[phase] += kern.duration
            total += kern.duration
            launches += 1
    return dict(wall_ms=wall_ms, device_ms=total / 1e3,
                busy_share=total / 1e3 / wall_ms, device_ops=launches,
                phases_ms={k: us / 1e3 for k, us in phases.items()},
                groups_ms={g: us / 1e3 for g, us in sorted(
                    groups.items(), key=lambda kv: -kv[1])})


def normalised(got, want):
    return float((got.float() - want.float()).norm()
                 / want.float().norm().clamp_min(1e-30))


def named_leaves(tree, path=""):
    """[(path, leaf)] of a parameter tree, in ``tree_leaves``' order."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in named_leaves(v, f"{path}.{k}" if path else k)]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in named_leaves(v, f"{path}[{i}]")]
    return [(path, tree)]


def train_twin(arch, groups, b, s):
    """One training step of ``arch`` (its smoke configuration, or
    ``groups`` groups at full width) on the card and on the CPU from the
    same float32 masters (the port's init, a CPU generator seeded
    ``TRAIN_SEED``) and batch, as it trains (bf16 compute): the loss, the
    gradient norm, the whole gradient (every leaf in one vector) and the
    parameters after the step held to the CPU's.  Then the gradients in
    float32 compute (the masters themselves, the kernels' float32 routes
    on the card), each leaf held to the CPU's: bf16's rounding, summed
    with cancellation into a small leaf (a head's ``dt_bias`` gathers
    every token), can move such a leaf by more than the whole, so the
    per-leaf check is made where rounding does not hide a dropped term."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.core.api import tree_leaves, tree_map
    from repro_torch.data import pipeline
    from repro_torch.models import model
    from repro_torch.train.optim import adamw_init
    from repro_torch.train.step import (loss_and_grads, make_loss,
                                        make_train_step, master_params)
    cfg = configs.smoke(arch)
    if groups is not None:
        full = configs.get(arch)
        cfg = dataclasses.replace(full, n_layers=groups * (
            full.hybrid_period if full.family == "hybrid" else 1))
    params = master_params(cfg, model.init(
        cfg, torch.Generator().manual_seed(TRAIN_SEED), "cpu"))
    names = [name for name, _ in named_leaves(params)]
    batch = pipeline.synthetic_batch(cfg, b, s, seed=TRAIN_SEED, step=0)
    host = lambda t: t.to("cpu", torch.float32)  # noqa: E731
    runs = {}
    for dev in (DEV, "cpu"):
        p = tree_map(lambda x: x.to(dev, copy=True), params)
        on_dev = {k: v.to(dev) for k, v in batch.items()}
        grads = []
        with train_taps(grads, {}):
            step = make_train_step(cfg, microbatches=1, block_q=64,
                                   block_k=64, device=dev)
            new, _, m = step(p, adamw_init(p), on_dev, 1)
        bf16 = [host(g) for g in tree_leaves(grads[0])]
        new = [host(x) for x in tree_leaves(new)]
        del p, grads
        loss32, grads32 = loss_and_grads(
            make_loss(cfg, 64, 64),
            tree_map(lambda x: x.to(dev, copy=True), params), on_dev)
        runs[dev] = ({k: float(v) for k, v in m.items()}, bf16, new,
                     float(loss32), [host(g) for g in tree_leaves(grads32)])
        del grads32
    (card_m, card_g, card_p, card_l32, card_g32) = runs[DEV]
    (cpu_m, cpu_g, cpu_p, cpu_l32, cpu_g32) = runs["cpu"]
    what = cfg.name if groups is None else f"{arch}, {groups} group(s)"
    loss_err = abs(card_m["loss"] - cpu_m["loss"]) / abs(cpu_m["loss"])
    gnorm_err = abs(card_m["grad_norm"] - cpu_m["grad_norm"]) / abs(
        cpu_m["grad_norm"])
    whole_err = normalised(torch.cat([g.ravel() for g in card_g]),
                           torch.cat([g.ravel() for g in cpu_g]))
    leaf_errs = [normalised(x, y) for x, y in zip(card_g, cpu_g)]
    worst = max(range(len(leaf_errs)), key=leaf_errs.__getitem__)
    step_err = max(float((x - y).abs().max()) for x, y in zip(card_p, cpu_p))
    bound = 2 * cpu_m["lr"] + 1e-6
    loss32_err = abs(card_l32 - cpu_l32) / abs(cpu_l32)
    errs32 = [normalised(x, y) for x, y in zip(card_g32, cpu_g32)]
    worst32 = max(range(len(errs32)), key=errs32.__getitem__)
    check(loss_err <= TRAIN_LOSS_TOL and gnorm_err <= TRAIN_GRAD_TOL
          and whole_err <= TRAIN_GRAD_TOL and step_err <= bound,
          f"{what}: one training step, card against CPU: loss "
          f"{card_m['loss']} / {cpu_m['loss']} (relative {loss_err}, tol "
          f"{TRAIN_LOSS_TOL}), grad_norm relative {gnorm_err}, the whole "
          f"gradient normalised {whole_err} (tol {TRAIN_GRAD_TOL}), "
          f"parameters after the step {step_err} (tol {bound})")
    check(loss32_err <= TRAIN_F32_TOL and errs32[worst32] <= TRAIN_F32_TOL,
          f"{what}: float32 gradients, card against CPU: loss relative "
          f"{loss32_err}, leaf {names[worst32]} normalised "
          f"{errs32[worst32]} (tol {TRAIN_F32_TOL})")
    return dict(what=what, B=b, S=s, leaves=len(cpu_g),
                loss=[card_m["loss"], cpu_m["loss"]], loss_rel_err=loss_err,
                grad_norm_rel_err=gnorm_err, whole_grad_err=whole_err,
                worst_bf16_leaf=(names[worst], leaf_errs[worst]),
                params_max_abs_err=step_err, params_bound=bound,
                f32_loss_rel_err=loss32_err,
                worst_f32_leaf=(names[worst32], errs32[worst32]))


def train_resume():
    """``TRAIN_RESUME`` through ``train()``: a run to the checkpoint, a
    run resumed from it, and an unbroken run; the losses of both halves
    against the unbroken run's.  The schedule's warmup (100 steps) covers
    all of them, so the first run's rate does not depend on its
    ``--steps``."""
    from repro_torch.kernels import _build
    from repro_torch.launch.train import train
    arch, b, s, steps, at = TRAIN_RESUME
    path = ROOT / "chiprun_out" / "chip_smoke_train.ckpt"
    _build.reset_launches()
    first = train(train_args(arch, b, s, at, ckpt=str(path), ckpt_every=at))
    resumed = train(train_args(arch, b, s, steps, ckpt=str(path),
                               resume=True, ckpt_every=steps))
    whole = train(train_args(arch, b, s, steps))
    launched = launches_since(dict.fromkeys(("flash_attention", "ssd_scan"),
                                            0))
    path.unlink()
    check(resumed["start"] == at, f"{arch}: resumed at step "
                                  f"{resumed['start']}, not {at}")
    losses = [float(m["loss"]) for m in whole["metrics"]]
    halves = [float(m["loss"]) for m in first["metrics"]
              + resumed["metrics"]]
    err = max(abs(x - y) for x, y in zip(halves, losses))
    check(len(halves) == len(losses) == steps and err <= TRAIN_RESUME_TOL
          and all(math.isfinite(x) for x in losses),
          f"{arch}: {steps} steps resumed at {at}: losses {halves} against "
          f"the unbroken run's {losses} (max abs diff {err}, tol "
          f"{TRAIN_RESUME_TOL})")
    per_step = train_launches(whole["cfg"])
    check(launched == {k: 2 * steps * v for k, v in per_step.items()},
          f"{arch}: launches {launched} over {2 * steps} steps, expected "
          f"{per_step} a step")
    return dict(arch=arch, B=b, S=s, steps=steps, resumed_at=at,
                losses=losses, resumed_losses=halves, max_abs_diff=err,
                step_s=whole["step_s"], launches=launched,
                bitwise=halves == losses)


def train_mesh():
    """``compressed_psum`` and ``pipeline_forward`` on ``TRAIN_MESH``
    shards of ``cuda:0`` and of the CPU from the same inputs: the means
    bitwise, the residuals within 1e-5 of the shared scale, the pipeline's
    outputs within 1e-5 (float32, TF32 off) and the stages' sequence."""
    from repro_torch.core.api import tree_map
    from repro_torch.core.distributed import Mesh
    from repro_torch.distributed.pipeline_parallel import pipeline_forward
    from repro_torch.train.compression import compressed_psum
    n = TRAIN_MESH
    gen = torch.Generator().manual_seed(TRAIN_SEED)
    grads = [{"w": torch.randn(512, 640, generator=gen),
              "b": torch.randn(640, generator=gen) * 1e-3} for _ in range(n)]
    errors = [tree_map(lambda x: x * 1e-2, g) for g in grads]
    ws = [torch.randn(256, 256, generator=gen) / 16 + torch.eye(256)
          for _ in range(n)]
    x = torch.randn(6, 8, 256, generator=gen)
    out = {}
    for name, mesh in (("card", shard_mesh(DEV_MESH, n)),
                       ("cpu", Mesh(["cpu"] * n))):
        put = lambda trees: [tree_map(lambda t, d=d: t.to(d), tr)  # noqa
                             for tr, d in zip(trees, mesh.devices)]
        means, errs = compressed_psum(put(grads), mesh, put(errors))
        y = pipeline_forward(lambda w, h: torch.tanh(h @ w), ws,
                             x.to(mesh.devices[0]), mesh)
        out[name] = ([tree_map(lambda t: t.cpu(), m) for m in means],
                     [tree_map(lambda t: t.cpu(), e) for e in errs], y.cpu())
    (cm, ce, cy), (pm, pe, py) = out["card"], out["cpu"]
    same_means = all(torch.equal(a[k], b[k]) for a, b in zip(cm, pm)
                     for k in a)
    scale = max(float((g[k] + e[k]).abs().max())
                for g, e in zip(grads, errors) for k in g) / 127
    res_diff = max(float((a[k] - b[k]).abs().max())
                   for a, b in zip(ce, pe) for k in a)
    pipe_diff = float((cy - py).abs().max())
    seq = x
    for w in ws:
        seq = torch.tanh(seq @ w)
    check(same_means and res_diff <= 1e-5 * scale and pipe_diff <= 1e-5
          and torch.equal(py, seq),
          f"{n} shards of {DEV_MESH} against the CPU's: compressed_psum "
          f"means bitwise {same_means}, residuals max abs diff {res_diff} "
          f"(tol {1e-5 * scale}); pipeline_forward max abs diff "
          f"{pipe_diff} (tol 1e-5)")
    return dict(shards=n, means_bitwise=same_means,
                residual_max_abs_diff=res_diff, pipeline_max_abs_diff=pipe_diff)


def phase_lm_training(report):
    """``TRAIN_ARCH`` at full width and depth trained on the card through
    the launcher's ``train()``: launches per step, step time, train
    tokens/s, peak memory; one step with every sync an error and every
    gradient leaf non-zero; one step profiled by phase and kernel group;
    the gradient Function on live inputs; ``TRAIN_TWINS`` card against
    CPU; ``TRAIN_RESUME`` resumed from its checkpoint; the mesh's
    ``compressed_psum`` and ``pipeline_forward``."""
    import statistics
    from repro_torch.core.api import tree_leaves
    from repro_torch.data import pipeline
    from repro_torch.kernels import _build
    from repro_torch.launch.train import train
    from repro_torch.train.step import make_train_step
    t0 = time.perf_counter()
    out = {}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    r = train(train_args(TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    launched = launches_since(dict.fromkeys(("flash_attention", "ssd_scan"),
                                            0))
    for name, count in launched.items():
        report["launches"][name] += count
    cfg, params, opt = r["cfg"], r["params"], r["opt"]
    n_params = sum(x.numel() for x in tree_leaves(params))
    per_step = train_launches(cfg)
    check(launched == {k: TRAIN_STEPS * v for k, v in per_step.items()},
          f"{TRAIN_ARCH}: launches {launched} in {TRAIN_STEPS} steps, "
          f"expected {per_step} a step")
    losses = [float(m["loss"]) for m in r["metrics"]]
    gnorms = [float(m["grad_norm"]) for m in r["metrics"]]
    check(all(math.isfinite(x) for x in losses + gnorms),
          f"{TRAIN_ARCH}: losses {losses}, grad norms {gnorms}")
    step_s = r["step_s"]
    median = statistics.median(step_s[1:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    print(f"phase 28: {TRAIN_ARCH} trained through the launcher's train() "
          f"({n_params / 1e9:.3f} B parameters, f32 masters, bf16 compute, "
          f"remat={cfg.remat!r}, {TRAIN_STEPS} AdamW steps of "
          f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens): losses "
          f"{', '.join(f'{x:.4f}' for x in losses)}, grad norms "
          f"{', '.join(f'{x:.3f}' for x in gnorms)}; "
          f"{per_step['flash_attention']} flash_attention and "
          f"{per_step['ssd_scan']} ssd_scan launches a step (the forward"
          f"{'' if cfg.remat == 'none' else ' and the remat recompute'}); "
          f"step times "
          f"{', '.join(f'{x * 1e3:.1f}' for x in step_s)} ms, "
          f"{median * 1e3:.1f} ms the median of steps 2-{TRAIN_STEPS}, "
          f"{tokens / median:.0f} train tokens/s; peak memory {peak:.2f} "
          f"GiB; on {report['card']}", flush=True)

    # One more step: every sync an error, every gradient leaf checked,
    # the kernel wrappers' first live inputs kept.
    step = make_train_step(cfg, microbatches=1, block_q=64, block_k=64,
                           device=DEV)
    batch = pipeline.synthetic_batch(cfg, TRAIN_BATCH, TRAIN_SEQ,
                                     seed=TRAIN_SEED, step=TRAIN_STEPS,
                                     device=DEV)
    grads, live = [], {}
    before = dict(_build.LAUNCHES)
    with train_taps(grads, live), sync_debug("error"):
        params, opt, m = step(params, opt, batch, TRAIN_STEPS + 1)
        n_leaves, missing, nonzero = gradient_flags(grads[0])
    del grads
    audited = launches_since(before)
    nonzero = nonzero.cpu()
    check(missing == 0 and bool(nonzero.all()) and n_leaves == len(
        tree_leaves(params)) and audited == per_step,
          f"{TRAIN_ARCH}: the audited step: {missing} of {n_leaves} leaves "
          f"without a gradient, {int((~nonzero).sum())} all zero; launches "
          f"{audited}")
    print(f"phase 28: one more step under set_sync_debug_mode(\"error\"): "
          f"no sync; {n_leaves} parameter leaves, each given a gradient "
          f"with a non-zero element; launches {audited}; loss "
          f"{float(m['loss']):.4f}", flush=True)
    prof = train_profile(lambda: step(params, opt, batch, TRAIN_STEPS + 2))
    print(f"phase 28: one step profiled: wall {prof['wall_ms']:.1f} ms, "
          f"device {prof['device_ms']:.1f} ms (busy "
          f"{prof['busy_share']:.2f}, {prof['device_ops']} kernels and "
          f"copies): " + ", ".join(f"{k} {v:.1f}" for k, v in
                                   prof["phases_ms"].items())
          + " ms; by group " + ", ".join(f"{k} {v:.1f}" for k, v in
                                         prof["groups_ms"].items())
          + " ms", flush=True)
    functions = function_parity(report, live)
    print(f"phase 28: the gradient Function on the audited step's live "
          f"inputs: " + "; ".join(
              f"{k} {tuple(v['shape'])} value max abs err "
              f"{v['max_abs_err']:.3g} (normalised {v['normalised_err']:.2g}"
              f"), {v['grads_equal']} input gradients bitwise the plain "
              f"version's" for k, v in functions.items()), flush=True)
    out.update(arch=TRAIN_ARCH, parameters=n_params, batch=TRAIN_BATCH,
               seq=TRAIN_SEQ, losses=losses, grad_norms=gnorms,
               step_s=step_s, median_step_s=median,
               train_tokens_per_s=tokens / median, peak_gib=peak,
               launches_per_step=per_step, leaves=n_leaves, profile=prof,
               functions=functions)
    del r, params, opt, step, batch, live, m
    torch.cuda.empty_cache()

    out["twins"] = []
    for arch, groups, b, s in TRAIN_TWINS:
        t_twin = time.perf_counter()
        twin = train_twin(arch, groups, b, s)
        twin["seconds"] = time.perf_counter() - t_twin
        out["twins"].append(twin)
        print(f"phase 28: {twin['what']}, B={b} S={s}, one training step "
              f"card against CPU: loss {twin['loss'][0]:.5f} / "
              f"{twin['loss'][1]:.5f} (relative {twin['loss_rel_err']:.2g}"
              f"), grad norm relative {twin['grad_norm_rel_err']:.2g}, the "
              f"whole gradient normalised {twin['whole_grad_err']:.3g} (the "
              f"worst of {twin['leaves']} leaves "
              f"{twin['worst_bf16_leaf'][0]} "
              f"{twin['worst_bf16_leaf'][1]:.3g}), parameters after the "
              f"step max abs diff {twin['params_max_abs_err']:.3g} (2 lr + "
              f"1e-6 = {twin['params_bound']:.3g}); float32 gradients: "
              f"loss relative {twin['f32_loss_rel_err']:.2g}, the worst leaf "
              f"{twin['worst_f32_leaf'][0]} normalised "
              f"{twin['worst_f32_leaf'][1]:.3g} ({twin['seconds']:.1f} s)",
              flush=True)
    torch.cuda.empty_cache()

    t_resume = time.perf_counter()
    resume = train_resume()
    for name, count in resume["launches"].items():
        report["launches"][name] += count
    out["resume"] = resume
    arch, b, s, steps, at = TRAIN_RESUME
    print(f"phase 28: {arch} at full width and depth through train() (B={b}"
          f" S={s}), {steps} steps, checkpoint at step {at} and a resume "
          f"from it: the halves' losses against the unbroken run's max abs "
          f"diff {resume['max_abs_diff']:.3g} (tol {TRAIN_RESUME_TOL}; "
          f"bitwise: {resume['bitwise']}); losses "
          f"{resume['losses'][0]:.4f} -> {resume['losses'][-1]:.4f}; "
          f"median step {statistics.median(resume['step_s']) * 1e3:.1f} ms "
          f"({time.perf_counter() - t_resume:.1f} s)", flush=True)

    mesh = train_mesh()
    out["mesh"] = mesh
    print(f"phase 28: compressed_psum and pipeline_forward on {TRAIN_MESH} "
          f"shards of {DEV_MESH} against the CPU's: means bitwise "
          f"{mesh['means_bitwise']}, residuals max abs diff "
          f"{mesh['residual_max_abs_diff']:.3g}, pipeline max abs diff "
          f"{mesh['pipeline_max_abs_diff']:.3g}", flush=True)
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 28: {out['seconds']:.1f} s on {report['card']}",
          flush=True)
    report["lm_training"] = out


# -- phase 29: the dry run ---------------------------------------------------

def dryrun_part(part, path):
    """One part of phase 29's dry run, in a process of its own on the
    host's CPU (``--dry-run PART PATH``): ``train_4x1024`` (phase 28's
    training step, modelled with its settings) or ``solver`` (the round
    on the production mesh); writes its JSON to ``path``."""
    from repro_torch.launch import dryrun, solver_dryrun
    from repro_torch.models.config import ShapeConfig
    torch.set_num_threads(1)
    if part == "train_4x1024":
        out = dryrun.run_cell(TRAIN_ARCH, ShapeConfig(
            part, TRAIN_SEQ, TRAIN_BATCH, "train"), DRYRUN_TRAIN)
    elif part == "solver":
        out = solver_dryrun.run(tag=DRYRUN_TAG, **DRYRUN_SOLVER)
    else:
        raise ValueError(f"no dry-run part {part!r}")
    pathlib.Path(path).write_text(json.dumps(out))


def start_dryrun():
    """Start phase 29's dry runs on the host's CPU, each in a process of
    its own with the card hidden (a dry run touches no card): the
    launcher's ``--all`` and the two ``dryrun_part`` s."""
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT / "src"))
    cmds = {"all": [sys.executable, "-m", "repro_torch.launch.dryrun",
                    "--all", "--tag", DRYRUN_TAG]}
    for part in ("train_4x1024", "solver"):
        cmds[part] = [sys.executable, str(ROOT / "chip_smoke.py"),
                      "--dry-run", part, str(out / f"dryrun_{part}.json")]
    procs = {}
    for part, cmd in cmds.items():
        path = out / f"dryrun_{part}.json"
        if path.exists():
            path.unlink()
        log = open(out / f"dryrun_{part}.log", "w")
        procs[part] = (subprocess.Popen(cmd, stdout=log,
                                        stderr=subprocess.STDOUT, env=env,
                                        cwd=ROOT), log)
    # A phase that fails before phase 29 leaves them running: stop them
    # at exit.
    atexit.register(lambda: [p.kill() for p, _ in procs.values()
                             if p.poll() is None])
    return procs, time.perf_counter()


def finish_dryrun(dry):
    """Wait for the dry runs (at most ``DRYRUN_WAIT_S`` from their
    start), stop any still running; each part's exit code and log."""
    procs, t0 = dry
    res = {}
    for part, (proc, log) in procs.items():
        try:
            proc.wait(timeout=max(1.0, DRYRUN_WAIT_S
                                  - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            pass
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
        res[part] = dict(rc=proc.returncode, log=(
            ROOT / "chiprun_out" / f"dryrun_{part}.log").read_text())
    return res


def measured_cell(arch, shape_name, batch, memory_bytes):
    """The dry run's cell run on the card through the same step on zeros
    (``dryrun.input_specs(device="cuda")``): once to warm up, then once
    between CUDA events with the peak reset just before.  (Peak bytes
    above what the process held before the arguments, ms, the timed
    step's launches.)"""
    from repro_torch import configs
    from repro_torch.kernels import _build
    from repro_torch.launch import dryrun
    from repro_torch.models.config import shapes_for
    cfg = configs.get(arch)
    shape = dryrun.card_shape(
        {x.name: x for x in shapes_for(cfg)}[shape_name], batch)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    step, args = dryrun.input_specs(cfg, shape, None, memory_bytes,
                                    device=DEV)
    out = step(*args)
    del out
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = dict(_build.LAUNCHES)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = step(*args)
    end.record()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - held
    launched = launches_since(before)
    del out, args, step
    torch.cuda.empty_cache()
    return peak, start.elapsed_time(end), launched


def guided_decode(report):
    """``examples/torch_guided_decode.py`` on the card and on the CPU
    from the same parameters: the greedy path, the exact optimum through
    ``serial_rb`` and the simulator's, the card's attention on the
    ``flash_attention`` kernel (hd 16 padded to 64)."""
    import importlib.util
    from repro_torch.core.api import tree_map
    from repro_torch.core.serial import ParallelRBSimulator, serial_rb
    from repro_torch.kernels import _build
    spec = importlib.util.spec_from_file_location(
        "torch_guided_decode", ROOT / "examples" / "torch_guided_decode.py")
    gd = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gd)
    params, prompt = gd.init(0, "cpu")
    runs = {}
    for dev in ("cpu", DEV):
        t0 = time.perf_counter()
        before = dict(_build.LAUNCHES)
        expand = gd.build_lattice(tree_map(lambda t: t.to(dev), params),
                                  prompt.to(dev))
        greedy = gd.greedy(gd.make_problem(expand))
        best, nodes, _ = serial_rb(gd.make_problem(expand))
        sim = ParallelRBSimulator(gd.make_problem(expand), c=8).run()
        runs[dev] = dict(greedy_tokens=list(greedy[1]), greedy=greedy[2],
                         best=best, nodes=nodes, sim_best=sim.best,
                         makespan=sim.makespan,
                         launches=launches_since(before),
                         seconds=time.perf_counter() - t0)
    card, cpu = runs[DEV], runs["cpu"]
    for name, count in card["launches"].items():
        report["launches"][name] += count
    check(card["launches"]["flash_attention"] > 0
          and card["sim_best"] == card["best"] <= card["greedy"]
          and abs(card["best"] - cpu["best"]) <= GUIDED_COST_TOL,
          f"guided decode: card {card}, CPU {cpu}")
    return runs


def phase_dryrun(report, dry):
    """The dry runs started after phase 1, collected: all 33 cells' peak,
    ``fits`` against the card's memory, dominant term and trace time;
    the solver round's collective bytes against its compute term; the
    modelled peaks of ``DRYRUN_MEASURED`` against the card's; the guided
    decode on the card."""
    from repro_torch import configs
    from repro_torch.models.config import shapes_for
    t0 = time.perf_counter()
    res = finish_dryrun(dry)
    waited = time.perf_counter() - t0
    for part, r in res.items():
        check(r["rc"] == 0 and "[FAIL]" not in r["log"],
              f"dry run {part}: exit {r['rc']}\n{r['log'][-3000:]}")
    total = torch.cuda.get_device_properties(0).total_memory
    cells, fits = {}, {}
    for arch in configs.ARCH_IDS:
        for shape in shapes_for(configs.get(arch)):
            c = json.loads((ROOT / "dryrun_out" / f"{arch}__{shape.name}__"
                            f"{DRYRUN_TAG}.json").read_text())
            cells[arch, shape.name] = c
            mem, r = c["memory"], c["roofline"]
            fits[f"{arch} {shape.name}"] = mem["peak_bytes"] <= total
            print(f"phase 29: dry run {arch} {shape.name} (B={c['batch']} "
                  f"S={c['seq_len']}): peak "
                  f"{mem['peak_bytes'] / 2 ** 30:.2f} GiB, fits the card's "
                  f"{total / 2 ** 30:.2f} GiB: "
                  f"{fits[f'{arch} {shape.name}']}; dominant "
                  f"{r['dominant']} (compute {r['compute_s'] * 1e3:.3f} ms, "
                  f"memory {r['memory_s'] * 1e3:.3f} ms, score "
                  f"{r['score_bytes_per_dev'] / 1e9:.3f} GB); trace "
                  f"{c['trace_s']:.2f} s", flush=True)
    check(len(cells) == 33, f"dry run: {len(cells)} cells, not 33")
    solver = json.loads((ROOT / "chiprun_out" / "dryrun_solver.json"
                         ).read_text())
    print(f"phase 29: solver round on {solver['mesh']} ({solver['problem']} "
          f"{solver['instance']}, {solver['lanes_total']} lanes, "
          f"{solver['steps_per_round']} steps): "
          f"{solver['collective_bytes_per_round_per_dev']:.0f} bytes sent "
          f"a shard a round ({solver['per_collective']}), collective term "
          f"{solver['collective_s'] * 1e6:.4f} us against compute "
          f"{solver['compute_s'] * 1e3:.4f} ms and memory "
          f"{solver['memory_s'] * 1e3:.4f} ms; trace "
          f"{solver['trace_s']:.1f} s", flush=True)

    measured = []
    for arch, shape, batch in DRYRUN_MEASURED:
        if shape == "train_4x1024":
            model = json.loads((ROOT / "chiprun_out" /
                                "dryrun_train_4x1024.json").read_text())
            train = report["lm_training"]
            peak = train["peak_gib"] * 2 ** 30
            ms = train["median_step_s"] * 1e3
            launched = train["launches_per_step"]
        else:
            model = cells[configs.ALIASES.get(arch, arch), shape]
            peak, ms, launched = measured_cell(
                arch, shape, batch, model["memory"]["device_bytes"])
            for name, count in launched.items():
                report["launches"][name] += count
        modelled = model["memory"]["peak_bytes"]
        r = model["roofline"]
        roof_ms = max(r["compute_s"], r["memory_s"], r["collective_s"]) * 1e3
        row = dict(arch=arch, shape=shape, batch=batch, modelled=modelled,
                   measured=peak, ratio=modelled / peak, roofline_ms=roof_ms,
                   step_ms=ms, dominant=r["dominant"], launches=launched)
        measured.append(row)
        print(f"phase 29: {arch} {shape} B={batch}: modelled peak "
              f"{modelled / 2 ** 30:.3f} GiB, measured "
              f"{peak / 2 ** 30:.3f} GiB, ratio {row['ratio']:.3f}; roofline "
              f"{roof_ms:.2f} ms ({r['dominant']}), measured step "
              f"{ms:.2f} ms (CUDA events); launches {launched}", flush=True)
        check(abs(modelled - peak) <= max(PEAK_TOL * peak, PEAK_SLACK),
              f"{arch} {shape}: modelled peak {modelled} bytes, measured "
              f"{peak}: outside {PEAK_TOL:.0%} and {PEAK_SLACK} bytes")

    runs = guided_decode(report)
    for dev, g in runs.items():
        print(f"phase 29: guided decode on {dev}: greedy tokens "
              f"{g['greedy_tokens']} -logprob {g['greedy'] / 1e3:.3f}; exact "
              f"optimum {g['best'] / 1e3:.3f} ({g['nodes']} lattice nodes); "
              f"PARALLEL-RB x8 {g['sim_best'] / 1e3:.3f} in {g['makespan']} "
              f"ticks; launches {g['launches']}; {g['seconds']:.1f} s",
              flush=True)
    seconds = time.perf_counter() - t0
    print(f"phase 29: {seconds - waited:.1f} s of its own, "
          f"{waited:.1f} s more waiting for the dry runs, on "
          f"{report['card']}", flush=True)
    report["dryrun"] = dict(fits=fits, solver=solver, measured=measured,
                            guided_decode=runs, seconds=seconds,
                            waited_s=waited)


# -- driver -----------------------------------------------------------------

def kernel_entry(name, report, headline, shapes, tolerance="bitwise (0)"):
    parity = report["parity"][name]
    library_ms = headline.get("library_ms")
    return {"name": name, "route": "cuda", "source": CSRC.format(name),
            "replaces": REPLACES[name], "launches": report["launches"][name],
            "max_abs_err": parity["max_abs_err"], "ms": headline["ms"],
            "plain_ms": headline["plain_ms"],
            "bound_ms": headline["bound_ms"],
            "bound_by": headline["bound_by"], "library_ms": library_ms,
            "library": headline.get("library") if library_ms is not None
            else "none: no single PyTorch call computes this function",
            "mismatches": parity["mismatches"],
            "max_rel_err": parity.get("max_rel_err"),
            "compared": parity["compared"], "tolerance": tolerance,
            "shapes": shapes}


#: The SASS instructions that show each redesigned kernel's hardware path:
#: the tensor cores fed by TMA (flash_attention's bf16 route), the tensor
#: cores' binary product beside the popcounts of the mask counts
#: (count_stats), the warp-wide reductions that fold the branch-free
#: partial rows (masked_row_reduce) and the tensor cores' bf16 product
#: (ssd_scan's bf16 route, mma.sync).  Each must appear at least once.
SASS_PATHS = {"flash_attention": ("HGMMA", "UTMALDG"),
              "count_stats": ("BMMA", "POPC"),
              "masked_row_reduce": ("REDUX",),
              "ssd_scan": ("HMMA",)}
#: An instruction whose opcode is {} (after its address and an optional
#: predicate), not a modifier of another opcode (BMMA's ".POPC").
SASS_OP = r"^\s*/\*[0-9a-f]{{4,}}\*/\s+(?:@!?U?P[T0-9]+\s+)?{}\b"


#: nvcc's name for a source's anonymous namespace, which holds a hash of
#: the file: left out where two builds' functions are matched by name.
ANON_NAMESPACE = r"\d+_GLOBAL__N__[0-9a-f]{8}_\d+_\w+?_cu_[0-9a-f]{8}"


def sass_of(lib):
    """{kernel function: its SASS lines} of a built library (``cuobjdump
    -sass``): each instruction and both halves of its encoding (the
    second holds the scheduling bits)."""
    from repro_torch.kernels import _build
    tool = pathlib.Path(_build._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(lib)],
                          capture_output=True, text=True, timeout=120,
                          check=True).stdout
    parts = re.split(r"^\s*Function : (\S+)\s*$", text, flags=re.MULTILINE)
    return {re.sub(ANON_NAMESPACE, "(anonymous)", fn):
            [line.strip() for line in body.splitlines()
             if line.strip().startswith("/*")]
            for fn, body in zip(parts[1::2], parts[2::2])}


def sass_against(libs, other):
    """{kernel: {function: "same" or what differs}}: each kernel
    function's SASS against the library of the same source in the build
    directory ``other``; a report, not a check (a changed kernel is meant
    to differ)."""
    found = {}
    for name, lib in libs.items():
        theirs = sorted(pathlib.Path(other).glob(f"{name}-*.so"))
        check(len(theirs) == 1, f"--sass-against: {len(theirs)} builds of "
                                f"{name} in {other}")
        mine, old = sass_of(lib), sass_of(theirs[0])
        found[name] = {}
        for fn in sorted(set(mine) | set(old)):
            a, b = mine.get(fn), old.get(fn)
            found[name][fn] = (
                "only here" if b is None else "only there" if a is None
                else "same" if a == b else
                f"differs ({len(a)} against {len(b)} instructions, "
                f"{sum(x != y for x, y in zip(a, b))} of the first "
                f"{min(len(a), len(b))} unequal)")
            print(f"phase 1: SASS of {fn} against {theirs[0].name}: "
                  f"{found[name][fn]}", flush=True)
    return found


def sass_counts(libs):
    """{kernel: {instruction: count}} from ``cuobjdump -sass`` of the
    built libraries of ``SASS_PATHS``; fails if an instruction is
    missing."""
    from repro_torch.kernels import _build
    tool = pathlib.Path(_build._nvcc()).with_name("cuobjdump")
    counts = {}
    for name, ops in SASS_PATHS.items():
        text = subprocess.run([str(tool), "-sass", str(libs[name])],
                              capture_output=True, text=True, timeout=120,
                              check=True).stdout
        counts[name] = {op: len(re.findall(SASS_OP.format(op), text,
                                           re.MULTILINE)) for op in ops}
        for op, n in counts[name].items():
            check(n > 0, f"{name}: no {op} in its SASS")
        print(f"phase 1: SASS of {name}: " + ", ".join(
            f"{op} {c}" for op, c in counts[name].items()), flush=True)
    return counts


#: Spill bytes (stores) ptxas may report for a kernel function, by the
#: name in its mangled symbol; every other function must spill none.
#: ``ssd_scan``'s bf16 output pass is compiled for two blocks an SM (128
#: registers a thread) and spills 148 bytes there; for one block an SM it
#: spills none and took 0.475 ms against 0.358 ms (PERF.md).
SPILLS_ALLOWED = {"ssd_scan_output_bf16_kernel": 148}
#: ptxas -v: a function's name, then its stack and spill bytes.
PTXAS_SPILLS = (r"Function properties for (\S+)\s+\d+ bytes stack frame, "
                r"(\d+) bytes spill stores, (\d+) bytes spill loads")


def check_spills(libs):
    """{kernel: {function: spill store bytes}} from each library's ptxas
    report (``<lib>.log``); fails where a function spills more than
    ``SPILLS_ALLOWED`` lets it (0 unless listed)."""
    spills = {}
    for name, lib in libs.items():
        text = pathlib.Path(str(lib) + ".log").read_text()
        found = re.findall(PTXAS_SPILLS, text)
        check(found, f"{name}: no spill report in its ptxas log")
        spills[name] = {}
        for fn, stores, loads in found:
            allowed = max([b for part, b in SPILLS_ALLOWED.items()
                           if part in fn] or [0])
            check(int(stores) <= allowed and int(loads) <= allowed,
                  f"{name}: {fn} spills {stores} / {loads} bytes (allowed "
                  f"{allowed})")
            if int(stores) or int(loads):
                spills[name][fn] = int(stores)
        print(f"phase 1: ptxas spills of {name}: " + (", ".join(
            f"{fn} {b} bytes (allowed)" for fn, b in spills[name].items())
            or "none"), flush=True)
    return spills


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sass-against", metavar="BUILD_DIR",
                    help="another tree's kernels/build directory: phase 1 "
                         "compares each kernel function's SASS with it")
    ap.add_argument("--telemetry-repeats", type=int, default=1, metavar="N",
                    help="pairs of traced and bare drains in phases 15 and "
                         "17, in turns (default 1)")
    ap.add_argument("--cpu-twin", nargs=2, metavar=("PART", "PATH"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--dry-run", nargs=2, metavar=("PART", "PATH"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.cpu_twin:
        twin_part(*args.cpu_twin)
        return 0
    if args.dry_run:
        dryrun_part(*args.dry_run)
        return 0
    if args.telemetry_repeats < 1:
        ap.error("--telemetry-repeats must be >= 1")
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false: no card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    # The plain versions' float32 products in full float32 (no TF32).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    card = smi("name,power.limit")
    print(f"phase 1: torch {torch.__version__} cuda {torch.version.cuda} "
          f"on {kind}; nvidia-smi: {card}", flush=True)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:    # one nvcc per source
        libs = list(pool.map(_build.build, KERNELS))
    build_s = time.perf_counter() - t0
    for lib in libs:
        print(f"phase 1: built {lib.name} ({build_s:.1f} s for all); nvcc: "
              f"{pathlib.Path(str(lib) + '.log').read_text().strip()}",
              flush=True)
    sass = sass_counts(dict(zip(KERNELS, libs)))
    spills = check_spills(dict(zip(KERNELS, libs)))
    sass_diff = (sass_against(dict(zip(KERNELS, libs)), args.sass_against)
                 if args.sass_against else None)
    dry = start_dryrun()

    report = dict(device=kind, card=card, build_s=build_s, sass=sass,
                  spills=spills, sass_against=sass_diff,
                  parity={k: dict(compared=0, mismatches=0, max_abs_err=0)
                          for k in KERNELS},
                  launches=dict.fromkeys(KERNELS, 0), solves=[])
    seconds = report["phase_seconds"] = {}

    def run(phase, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[phase] = round(time.perf_counter() - t0, 1)
        return out

    seconds[1] = round(time.perf_counter() - t_start, 1)
    run(2, phase_parity, report)
    run(3, phase_drain, report)
    cell60_lanes = run(4, phase_cell60, report)
    full, live, small = run(5, phase_timing, cell60_lanes, report)
    run(6, phase_stacked_parity, report)
    bare_svc, bare_ms = run(7, phase_service, report)
    svc, service_inputs = run("7b", phase_service_steps, report)
    run(8, phase_service_twin, report)
    run(9, phase_checkpoints, report, svc)
    service, interleaved, in_order = run(10, phase_stacked_timing, report,
                                         service_inputs)
    popcount, row_reduce = run(11, phase_bitset_library, report)
    attention = run(12, phase_attention, report)
    ssd = run(13, phase_ssd, report)
    wide = run(14, phase_wide, report)
    TRACES.mkdir(parents=True, exist_ok=True)
    run(15, phase_telemetry_drain, report, args.telemetry_repeats)
    run(16, phase_telemetry_cell60, report)
    run(17, phase_telemetry_service, report, bare_svc, bare_ms,
        args.telemetry_repeats)
    run(18, phase_subset_sum, report)
    twin = start_twin()
    try:
        ckpt_path = run(19, phase_mesh_drain, report)
        mesh60 = run(20, phase_mesh_cell60, report)
        run(21, phase_mesh_elastic, report, ckpt_path)
        run(22, phase_mesh_service, report)
        run(23, phase_two_cards, report)
        run(24, phase_autotune, report, card)
    finally:
        twin_result = run("twin", finish_twin, twin)
    check_twin(report, twin_result)
    run(25, phase_sync_audit, report, cell60_lanes, mesh60)
    lm_attention, lm_ssd = run(26, phase_lm_serving, report)
    family_attention = run(27, phase_lm_families, report)
    run(28, phase_lm_training, report)
    run(29, phase_dryrun, report, dry)
    kernels_line = {"kernels": [
        kernel_entry("count_stats", report, full, [full, live, small, *wide]),
        kernel_entry("stacked_count_stats", report, service,
                     [service, interleaved, in_order]),
        kernel_entry("popcount_reduce", report, popcount, [popcount]),
        kernel_entry("masked_row_reduce", report, row_reduce["or"],
                     [row_reduce["or"], row_reduce["and"]]),
        kernel_entry("flash_attention", report, lm_attention,
                     [lm_attention, *family_attention, *attention],
                     "allclose rtol = atol = 2e-2 (bf16), 2e-5 (f32); "
                     "normalised error <= 5e-3 (bf16), 2e-5 (f32)"),
        kernel_entry("ssd_scan", report, lm_ssd, [lm_ssd, ssd],
                     "y: allclose rtol = atol = 5e-2 (bf16), 1e-4 (f32), "
                     "normalised error <= 5e-3 (bf16), 1e-4 (f32); "
                     "state (f32): allclose and normalised error 1e-4")]}
    report["seconds"] = time.perf_counter() - t_start
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print(f"all phases passed in {report['seconds']:.1f} s; seconds by "
          f"phase {seconds}", flush=True)
    print(smi("name,power.limit"))
    print(json.dumps(kernels_line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
