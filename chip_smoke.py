#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernel-times [--src OTHER_CHECKOUT/src]
    python3 chip_smoke.py --step-times [--src OTHER_CHECKOUT/src]
    python3 chip_smoke.py --serving
    python3 chip_smoke.py --trainer
    python3 chip_smoke.py --processes
    python3 chip_smoke.py --loss-jump

Phases, in order; any failure exits non-zero and prints no result:

1. Card: the GPU's name and power limit, as nvidia-smi reports them.
2. Build: compile the port's CUDA kernels from the sources in this checkout.
3. Kernel parity: each simulator kernel against its plain PyTorch version
   on the card, bitwise (torch.equal, NaN where the plain version has NaN),
   at the main path's shapes, at large
   shapes and at the edges of randk_mask's 16-byte lanes (odd rows, views
   off the 16-byte grid, windows that wrap inside a lane, k == d, windows
   that end at d) and of diana_shift_update's (each h/Q dtype pair, n not
   a multiple of 4 or 8, n = 1, 3 ranks, 2 groups of 2, inputs off the
   16-byte grid, aliased inputs) and of qsgd_quantize's (one tile, x and u
   views off the 16-byte grid in f32 and bf16, an all-zero tile, a tile
   holding a NaN, levels 1 and 127); diana_shift_update also at the train
   path's stacked leaves, (1, 4, n) beside (1, n) for stablelm-1.6b's
   embedding and w_up, and flat at the embedding's bytes; at the path and
   large shapes also the median time of each (CUDA events after warm-up),
   torch.profiler's device time per launch, the bytes it must move and its
   bound at the card's memory rate (and the three unfused adds' time for
   diana_shift_update, the tile-wise PyTorch ops' for qsgd_quantize); beside
   qsgd_quantize at w8a, the device time of one launch of a plain PyTorch
   fill and copy of its 245,760 bytes, the practical floor of a launch.
4. Main path: the paper's simulator round at the w8a shape (20 clients x
   2487 datapoints x 300 features, L/mu = 1e4): one epoch of each of the
   eight methods of experiments 1 and 2 with Rand-k (k/d = 0.02) at theory
   stepsizes, then one epoch of Q-RR with QSGD (8 levels). Every f - f*
   must be finite, each kernel must have launched in this run, and one more
   DIANA-RR epoch on the kernels must equal the same epoch on the plain
   versions (same state, order and draws), bitwise.
5. Profile: the device's busy share over 200 DIANA-RR rounds at w8a.
   Informational: where the profiler sees no kernel it says so.
6. Wire kernel parity: the five kernels of the compressed shared wire
   (randk_compress, randk_decompress, pack_slab, unpack_slab,
   unpack_reduce) against their plain versions, bitwise, at the train
   path's shapes (stablelm-1.6b's embedding leaf and its stacked w_up
   leaf, 4 ranks), at large ones ((4, 976, 5632), nibbles at (4, 2000,
   2048)) and at ragged ones (a wrapping window, one block, D not a
   multiple of 4, bf16, nibbles, 3 ranks, weighted scales; for pack_slab
   also one slab, R = 1 and 8, odd K in nibbles, views off the 16-byte
   grid, and rows past its register variant; for randk_compress's flat
   lanes D = 25, 60, 5, 33 and 1 in f32 and bf16, 1 and 3 ranks and (N, D)
   rows, a wrapping window, kb == nb, a start below 0 and rows views off
   the grid; for randk_decompress's flat
   16-byte lanes D = 25, 60, 64, 5 and 33 in f32 and bf16, one group and
   four, and a slab view off the grid; for unpack_reduce's flat units D =
   25, 60, 1408, 1003 and 2048 at 1, 3, 9 and 64 ranks, odd n_rows in
   nibbles, zero weights and packed views off the 8- and 4-byte grids; for
   unpack_slab's, unpack_reduce's at one rank a group, D = 25,
   60, 64, 1408, 5632 and 1003 at one slab and R = 1, 3 and 4, odd n_rows
   < Kp in nibbles, an all-zero row, packed views off the 8- and 4-byte
   grids and a NaN scale),
   with times, device times, bounds, the plain versions' and the nearest
   composite's; and at the model families' new leaf shapes (qwen2-moe's
   expert leaf, D = 1408, and its f32 router, D = 60; hymba's wdt, D = 25;
   rwkv6's f32 bonus u, D = 64), timed alike; and at the model axis's
   shard shapes at T = 2 (stablelm-1.6b's embedding shard (4, 50176,
   2048) with kb = 125, its w_up, w_down and wo shards, hymba's per-head
   ln shard split on its last axis), parity only; diana_shift_update at
   the embedding's and w_up's shards in phase 3.
7. Train path: stablelm-1.6b at full width through `init_train_state` and
   `make_train_step`: DIANA-RR on the packed8 wire at all 24 layers (4
   clients, 2 shift slots, k/d = 0.02), one warm-up step and 2 timed, then
   a profiler window of one more step (device idle share, device time per
   kernel per step); DIANA-NASTYA (2 local steps, eta 0.1) on the flat (4,
   1) mesh at all 24 layers, each client its own pod (no profiler window
   since PR 22); DIANA-RR packed8 on the reference's (4, 2) mesh at all
   24 layers (the layers computing on their two model shards in turn,
   each split leaf exchanged shard by shard: one launch of each wire
   kernel a shard), one warm-up step, 2 timed and a one-step profiler
   window, its peak memory beside the (4, 1) step's; the two
   layouts of a split leaf's shards on the wire at the embedding (one
   exchange a shard, kept, against the shards folded into the rank
   dimension), bitwise equal, with their times, launches and peak memory;
   then, at 2 layers, q, diana, ef, diana_rr, diana on the
   f32 QSGD wire (127 levels), packed4 and bf16, the independent wire,
   diana and packed8 diana_rr on 2 pods x 2 clients, DIANA-RR NASTYA on 2
   pods, elastic diana with weights (1, 0, 0.5, 1), and debug_metrics.
   Losses must be finite and each wire kernel's launches must equal the
   count the wire implies (per leaf, per level, per step).
8. Cuda against reference: at 2 layers, a diana step on the f32, 127-level,
   packed8, packed4 and bf16 wires, an elastic step, a two-pod NASTYA
   step, a packed8 DIANA-RR step on the (4, 2) mesh and a diana step on
   the (2, 2, 2) mesh equal the same steps with backend="reference",
   bitwise; and on the kernels, packed8 equals the f32 wire at 127
   levels, bitwise.
9. Model families: qwen2-moe-a2.7b, rwkv6-7b, hymba-1.5b, qwen2-vl-2b and
   whisper-medium at full width (depths in FAMILY_RUNS: qwen2-moe's cut
   where the card's memory forces it, the others cut to an eighth or a
   sixteenth for the script's time) through `init_train_state` and
   `make_train_step`: DIANA-RR on the packed8 wire, 4 clients on the (4, 1)
   mesh, 2 shift slots, k/d = 0.02, random weights from a seed, stub patch
   and frame embeddings from a seeded generator; one warm-up step and 2
   timed (no profiler window for qwen2-moe and qwen2-vl: the windows'
   analysis took two thirds of the phase). rwkv6-7b, hymba-1.5b and
   whisper-medium (FAMILY_TP) take one warm-up step, one timed and a
   one-step profiler window on (4, 1), then the
   same on the trainer's (4, 2) mesh, their layers on the two model shards
   side by side in one process; each prints s/step, device ms, kernels a
   step, idle share and peak memory beside its (4, 1) run. Losses must be
   finite and each wire kernel's launches must equal the count the wire
   implies.
10. Families, cuda against reference: each family at 2 layers (whisper: 2
   encoder and 2 decoder layers), one packed8 DIANA-RR step on the kernels
   equals the same step with backend="reference", bitwise; for
   FAMILY_TP on (4, 1) and on (4, 2), the layers by shard.
11. Serving: stablelm-1.6b, qwen2-moe-a2.7b, rwkv6-7b, hymba-1.5b,
   qwen2-vl-2b, whisper-medium and starcoder2-15b at full width and full
   depth (SERVE_RUNS: 8 requests of 128 prompt tokens; hymba 8 x 1152 and
   starcoder2 2 x 4160, past their windows, so both ring buffers have
   wrapped; qwen2-vl's 256 patch positions before its text; whisper over
   1500 stub frames) through `make_prefill_step` and `make_serve_step`:
   seeded bf16 weights on the card, a cold and a timed prefill, one
   warm-up decode token, SERVE_TIMED timed greedy tokens (host clock,
   synchronised on each token's logits; the cache has room for
   SERVE_TOKENS) and a profiler window of SERVE_PROFILE tokens (device
   ms/token, kernels/token, idle share); each model is freed before the
   next. Logits must be finite and the cache's bytes exact. Then a 2-layer
   copy of each at full width (whisper: 2 + 2): a prefill of the patches
   and half the text plus teacher-forced decoding of the rest must lie
   within 0.1 + 0.05 |forward logit| of the port's own forward for every
   row at every position; for MoE the forward takes the served pass's
   experts where a near-tie flips them, and the flips, printed with their
   routing margins, stay within a quarter of the pairs (the reference's
   allowance). stablelm-1.6b is also served the same way on the
   reference front end's (4, 2) mesh (SERVE_MESH) by shard in this
   process: 4 clients of 2 model shards, its cache laid out by
   `cache_specs` (264,241,152 B, 33,030,144 a (client, shard) cell,
   exact), with ms/token, device ms/token, kernels/token, idle share and
   peak. Every teacher-forced check runs through the (4, 2) serve steps
   by shard (SERVE_TF_ROWS requests, one a client); stablelm-1.6b's also
   through the whole layers the timed runs decode. The serving path
   launches none of the eight kernels: every count must stay 0.

12. Trainer: the production front end `launch.train` (its `main`, given
   stablelm-1.6b at full width cut to TRAINER_LAYERS of 24 layers) on its
   default (4, 2) mesh, 4 client ranks of 2 model shards, packed8 DIANA at
   k/d = 0.02, seq 128 and batch 8, TRAINER_STEPS
   steps: (a) with --telemetry and --trace, whose JSONL the telemetry CLI
   must validate, summarise and export; (a0) telemetry off and (b)
   telemetry and prefetch off, each bitwise equal to (a); under the
   profiler, 3 steps with the sink on and 3 with it off, which must issue
   as many device-to-host copies and synchronise calls (the sink's writer
   thread polls its events and copies nothing);
   (c) a step short of TRAINER_STEPS, a checkpoint (its bytes, save and
   load seconds), then --resume to TRAINER_STEPS, bitwise equal to (a);
   (d) the fleet at --clients 4, bitwise equal to (a), with its gather
   and scatter seconds a round; (e) the buffered-async fleet of 8 clients
   (buffer 3, late reports dropped, dropout, stragglers and store faults)
   on a paged data store for TRAINER_STEPS rounds, whose participation
   counters must equal the planner's
   closed-form replay. Each run prints s/step (host clock, synchronised by
   the loss), peak memory and the kernels' launches; each must launch the
   five wire kernels and diana_shift_update.
13. Processes: phase 12's configuration (PROC_STEPS steps) with the (4, 2) mesh's
   cells spread over processes on the one card, each started as torchrun
   starts it (`train.main --dist-backend`, its environment, a store this
   process hosts), after the same run stacked in this process (and a
   3-step stacked run that writes a checkpoint): (a) NCCL at W = 1 (NCCL
   takes one process a card); (f) gloo at W = 8, one (client, model
   shard) a process, the model axis over processes (each holds its shards
   of the split leaves, its layers compute on them and it exchanges
   activations with its model group), resumed from the stacked 3-step
   checkpoint, the trainer's default seq_shard keeping each process's
   half of every block's input for the backward: its stash, measured by
   the saved-tensor hooks over one block, times L + 1 equal to
   `launch.train.stash_bytes` and its model-group bytes to
   `model_bytes` with the stash's re-gathers; (l) the fleet, --clients 8
   (cohort 4 a round), and (m) phase 12 (e)'s buffered-async fleet under
   chaos on paged data, over the same 8 processes, each process serving
   its client rank's shard and owning the shift rows of clients c = its
   rank's position mod 4: each bitwise to the same fleet run in this
   process (digests of every state leaf over the process's rows and
   shards), its "fleet" bytes a run exactly `fleet_bytes` of its
   rounds, (l)'s checkpoint the one-process file byte for byte and this
   process's --resume of it the one-process state, (m)'s participation
   counters the planner's replay; (e) the checkpoint (f) writes, whose
   leaves must
   equal the stacked state, and a stacked --resume from it to step
   PROC_STEPS + PROC_STEPS // 2 equal to the stacked run of as many
   steps; (d) two pods of two clients of two shards, packed8
   DIANA-NASTYA with 2 local steps, over gloo at W = 2 (a pod a process,
   its layers on both model shards of its clients) against the same run
   stacked; (g) qwen2.5-32b at full width (d_model
   5120, 40 heads / 8 kv heads, d_ff 27648, vocab 152064, untied head) cut
   to QWEN_LAYERS of its 64 layers, phase 12's flags for QWEN_STEPS steps
   on a (1, 8) mesh over 8 gloo processes, one (client, model shard) a
   process, the same processes that ran (f) (a (2, 4) mesh's processes
   do not fit the card together), its reckoning
   (a process's bytes, sized on the meta device) printed first and held
   to the card, then the same mesh on one process: every step's loss and
   gradient norm and a digest of each state leaf (each process's over its
   rows and shards, the one-process state's over the same) equal, its
   stash an eighth of the sequence (16 of 128 rows), held as (f)'s; (h)
   rwkv6-7b, hymba-1.5b and whisper-medium at full width and 2 layers
   (whisper: 2 encoder and 2 decoder layers over 1500 frames), phase 12's
   flags for FAMILY_STEPS steps on (2, 2) over 4 gloo processes, one
   (client, model shard) each, the three in one start of the processes
   (each run its own store), the same checks against the one-process
   run, each
   process's model-group bytes a step equal to `model_bytes`; (i)
   stablelm-1.6b served at full width and depth on (4, 2) over 8 gloo
   processes, one (client, model shard) each (prefill 8 x 128, then
   PROC_SERVE_TOKENS greedy tokens), and (j) qwen2.5-32b served at full
   width, QWEN_SERVE_LAYERS of its 64 layers, on (1, 8)
   (QWEN_SERVE_TOKENS greedy tokens), both over the
   same 8 gloo processes: each against the same mesh served in this
   process first, every process's ids, every
   token's logits and its cache slice bitwise (digests on the card), its
   cache slice exactly 33,030,144 and 5,505,024 bytes, its bytes to its
   model group exactly `launch.sharding.serve_model_bytes` at the
   prefill and at each token; each draws the whole tree in turn and
   keeps its shards (one whole copy on the card at a time); and (k),
   phase 14's part (c), over the same 8 processes: LONG_SPREAD at
   long_500k, its one request served whole by every client, bitwise to
   phase 14 (b)'s one-process run, each process's cache slice exactly
   its joint parts' bytes and its bytes to the joint group exactly
   `launch.sharding.serve_joint_bytes` a token. (The
   gloo W = 2
   and W = 4 runs of the flat mesh went to keep the script inside its
   time; tests/test_torch_distributed.py holds them on the host.)
   Each process hands its state to this one on the card (CUDA IPC; (g):
   its digests) and must hold the stacked run's bits (its own rows of
   the per-rank and per-pod tables and its own shards), launch the five
   wire kernels and diana_shift_update, and send, per level, the bytes
   its shards' `wire_bytes_per_round` implies (and to its model group the
   activations of its shards' forward and backward, and the leaves a
   layer puts together, `launch.sharding.model_bytes`); a
   failed or silent process fails the phase. Each prints s/step, peak
   memory per process and bytes sent per step. Then experiment3 at
   EXP3_EPOCHS of its 30 epochs, its other defaults (the four non-local
   methods on the tiny transformer LM): finite rows, and randk_mask and
   diana_shift_update launched.

14. long_500k (run after phase 12 and before phase 13, whose (k) is its
   part (c)): `configs.shapes.INPUT_SHAPES`' long_500k, one request over
   524,288 slots, for the three configs it takes (LONG_RUNS: rwkv6-7b,
   hymba-1.5b, starcoder2-15b) at full width and depth, each prompt past
   its window, LONG_TOKENS greedy tokens (the rings overwrite their
   oldest slots as they decode), the last LONG_PROFILE under the
   profiler: (a) the whole layers, without a mesh: ms/token, device
   ms/token, kernels/token, idle share, peak, the cache's exact bytes;
   (b) the same on LONG_MESH by shard in this process (the one request
   fewer than its 4 client ranks: every cache leaf split over the
   clients and the model shards jointly, an eighth of it a cell, exact);
   then both again at f32, full depth, where (b)'s logits must lie within
   1e-2 of (a)'s largest (tests/test_torch_serving.py's f32 bound) at
   every token while the ids agree, the ids equal or a near tie within
   that bound (at bf16 the two paths' roundings compound over the full
   depth past any bound of that file: on an H100, rwkv6-7b's prefill
   logits lay 2.1x 0.1 + 0.05 |logit| apart); (c) is 13 (k).
   Every line names the card and its power limit.
15. Dry run (after phase 13): the dry run's census (`launch.dryrun`,
   `launch.cost_analysis`: a step run on fake tensors, its kernels'
   launches recorded by their wrappers, its messages by the collective,
   its allocations by storage) on this host for two steps earlier phases
   ran on the card, held against what the card measured there: (a) phase
   7's first step (stablelm-1.6b at full width and depth, packed8
   DIANA-RR on (4, 1), one process): each wire kernel's census launches
   equal the profiler's count for one step, the census's wire bytes equal
   the ranks' `wire_bytes_per_round`, and its traced peak lies within 10%
   of `torch.cuda.max_memory_allocated` of that run; (b) phase 13 (f)'s
   process 0 (2 layers, one (client, shard) of (4, 2), phase 12's flags):
   its "model" bytes a step equal `model_bytes` (14,158,848), its stash
   (the saved-tensor hooks over one block, x (L + 1)) `stash_bytes`
   (1,572,864), and its traced peak lies within 10% of that process's
   `max_memory_allocated`; (c) `python -m repro_torch.analysis --lint`
   exits 0. Each comparison prints on its own line with the card's name
   and power limit.

The last three lines are the kernels' JSON record, the card's name and
power limit, and the run's verdict, {"ok": true, "device": {"platform":
"gpu", ...}}. Imports nothing of JAX.

--kernel-times runs phases 1-2 and then only the bitwise check and the
device time per launch of unpack_slab and qsgd_quantize (COMPARED), and of
unpack_reduce, which shares unpack_slab's code, at their path, large and
family shapes, beside each bound, the nearest composite's time and the
launch floor, ending in a JSON line and the card's SM clock, temperature
and power. --step-times runs phases 1-2 and then only phase 9's family
steps, 5 timed steps each without the profiler, then one step under it
(each wire kernel's device time per launch against its bound).
--loss-jump runs phases 1-2 and then only ROADMAP C5's bisection: DIANA-RR
at 2 layers for 3 steps over stablelm-1.6b's widths, three transports and
two meshes.
--serving runs phases 1-2 and then only phases 11 and 14, --trainer only
phase 12, --processes only phase 13 ((k) then serves its own one-process
run first), --dry-run only phase 15, after the two runs it compares with
(phase 7's first step, and phase 13 (f)'s W = 8 trainer from a fresh
state instead of a resumed one). --src points any of
them (or the whole run) at another checkout's src/, so that two trees'
kernels or steps are timed in turns on one card.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import json
import math
import os
import queue
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
F32_OPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
# epochs a method of phase 4 (2 until phase 13 needed the time)
W8A_EPOCHS = 1
# the train path: stablelm-1.6b at full width, 4 clients, seq 128 x 2 each
TRAIN_CLIENTS, TRAIN_SEQ, TRAIN_BATCH = 4, 128, 2
# depth of the train path's method sweep and of phase 8 (4 until phase
# 13 needed their time)
CUT_LAYERS = 2
SIM_KERNELS = ("randk_mask", "diana_shift_update", "qsgd_quantize")
WIRE_KERNELS = ("randk_compress", "randk_decompress", "pack_slab",
                "unpack_slab", "unpack_reduce")
ELASTIC_WEIGHTS = (1.0, 0.0, 0.5, 1.0)
# the model-families phase: (config, layers, tokens per client row, remat);
# qwen2-moe's depth is what the card's 79.18 GiB allows (PERF.md); the
# others were cut to a quarter (rwkv6 from 7, hymba 32, qwen2-vl 28,
# whisper 24 + 24) to pay for serving over processes in the script's
# time, and hymba, qwen2-vl and whisper again (8 -> 4, 7 -> 4, 6 + 6 ->
# 3 + 3) to pay for long_500k (phase 14); whisper's
# decoder layers come with as many encoder layers over 1500 frames, whose
# activations need the recomputation
FAMILY_RUNS = (("qwen2-moe-a2.7b", 2, 128, False),
               ("rwkv6-7b", 2, 128, False),
               ("hymba-1.5b", 4, 128, False),
               ("qwen2-vl-2b", 4, 512, False),
               ("whisper-medium", 3, 128, "full"))
FAMILY_CUT = 2  # depth of the families' cuda-vs-reference steps
# the ssm, hybrid and audio families: phase 9 runs them on (4, 1) and on
# (4, 2), their layers by shard, phase 10 on both, phase 13 (h) over
# processes
FAMILY_TP = ("rwkv6-7b", "hymba-1.5b", "whisper-medium")
# the serving phase at full width and full depth: (config, batch, text
# tokens of the prompt (the VLM's 256 patch positions come before them),
# the cache's exact bytes); cache_len = prompt + SERVE_TOKENS + 8, as the
# reference's serve front end sizes it
SERVE_RUNS = (("stablelm-1.6b", 8, 128, 264_241_152),
              ("qwen2-moe-a2.7b", 8, 128, 264_241_152),
              ("rwkv6-7b", 8, 128, 270_532_608),
              ("hymba-1.5b", 8, 1152, 361_758_720),
              ("qwen2-vl-2b", 8, 128, 97_255_424),
              ("whisper-medium", 8, 128, 1_311_768_576),
              ("starcoder2-15b", 2, 4160, 671_088_640))
SERVE_TOKENS = 32  # decode tokens the cache holds room for
# the seven runs' timed greedy tokens, after one warm-up token (32 until
# serving over processes needed the time, 16 until long_500k did, 8 until
# phase 15 did)
SERVE_TIMED = 6
SERVE_PROFILE = 2  # decode tokens in the profiler window (4 until long_500k)
# the teacher-forced check: layers, text tokens (64 until it took 4
# requests by shard instead of 2 whole: the (row, position) pairs, 68,
# stay as many as the 66 before, at about the old cost)
SERVE_CUT, SERVE_TEXT = 2, 32
# the reference serve front end's (data, model) mesh: phase 11 serves
# SERVE_TP_RUN on it by shard in one process (config, batch, text tokens,
# the cache's bytes, one (client, shard) cell's bytes) and runs every
# teacher-forced check through it, SERVE_TF_ROWS requests (one a client)
SERVE_MESH = (4, 2)
SERVE_TP_RUN = ("stablelm-1.6b", 8, 128, 264_241_152, 33_030_144)
# its timed tokens and profiler window (about 0.5 s a token on an H100
# machine: the host's launches; 8 and 2 until long_500k needed the time)
SERVE_TP_TOKENS, SERVE_TP_PROFILE = 4, 1
SERVE_TF_ROWS = 4
# phase 14: long_500k (`configs.shapes.INPUT_SHAPES`: one request over
# 524,288 slots) for the three configs with a sub-quadratic decode at full
# width and depth: (config, prompt tokens (past hymba's 1,024-slot and
# starcoder2's 4,096-slot windows), the whole cache's exact bytes, a
# process's (one (client, shard) cell's) bytes on LONG_MESH: an eighth of
# every leaf, split over the clients and the model shards jointly)
LONG_RUNS = (("rwkv6-7b", 128, 33_816_576, 4_227_072),
             ("hymba-1.5b", 1152, 45_219_840, 5_652_480),
             ("starcoder2-15b", 4160, 335_544_320, 41_943_040))
LONG_TOKENS, LONG_PROFILE = 8, 2  # greedy tokens, the last ones profiled
LONG_MESH = (4, 2)
LONG_SPREAD = "hymba-1.5b"  # (c): over phase 13's 8 processes, as 13 (k)
COMPARED = ("unpack_slab", "qsgd_quantize")  # what --kernel-times compares
# timed by --kernel-times beside COMPARED: unpack_reduce shares
# unpack_slab's unit indexing and stores (csrc/pack.cu)
ALSO_TIMED = ("unpack_reduce",)
# --loss-jump (ROADMAP C5): stablelm-1.6b's widths (d_model, vocab) at
# CUT_LAYERS layers, full width first, then each cut alone, then both
JUMP_WIDTHS = ((2048, 100352), (2048, 25088), (2048, 6272), (2048, 1568),
               (1024, 100352), (512, 100352), (256, 100352), (128, 100352),
               (1024, 25088), (512, 6272), (256, 1568), (128, 512))
JUMP_WIRES = (("f32", {}), ("f32@127", {"wire_levels": 127}),
              ("packed8", {"wire_dtype": "packed8"}))
# the production trainer's phase: stablelm-1.6b at full width, cut to
# TRAINER_LAYERS of its 24 layers, through `launch.train`
# (6 steps until serving over processes needed the time, 4, and 4 async
# rounds, until long_500k did)
TRAINER_LAYERS, TRAINER_STEPS = 2, 3
# phase 13's runs of that trainer (6 steps until serving over processes
# needed the time)
PROC_STEPS = 3
# phase 13 (g): qwen2.5-32b at full width, cut to QWEN_LAYERS of its 64
# layers, on the flat QWEN_MESH (clients x model shards) over 8 processes:
# one client of 8 shards, since 8 processes of (2, 4) would need 8 x 11.7
# GB with their CUDA contexts, more than the card (the reckoning of
# `launch.train.reckon`; the card ran out of memory in their first step)
# (3 steps until serving over processes needed the time)
QWEN_LAYERS, QWEN_MESH, QWEN_STEPS = 1, "1x8", 2
# phase 13 (i): greedy tokens (32, the cache's room, until long_500k
# needed the time, 8 until phase 15 did)
PROC_SERVE_TOKENS = 4
# phase 13 (j): qwen2.5-32b served at full width, QWEN_SERVE_LAYERS of its
# 64 layers (16 until long_500k needed the time), on (1, 8) over 8
# processes; a process's cache slice in bytes
QWEN_SERVE_LAYERS, QWEN_SERVE_MESH, QWEN_SERVE_CELL = 8, (1, 8), 5_505_024
# greedy tokens: 1.4-1.8 s each over gloo, H100 (4 until phase 15 needed
# the time)
QWEN_SERVE_TOKENS = 2
# phase 13's experiment3: epochs of its default 30 (30 until serving over
# processes needed the time, 6 until long_500k did, 3 until phase 15
# did)
EXP3_EPOCHS = 2
# phase 13 (h): the families of FAMILY_TP at FAMILY_CUT layers on this
# flat mesh over 4 processes, one (client, model shard) each
# (3 steps until serving over processes needed the time)
FAMILY_MESH, FAMILY_STEPS = "2x2", 2
# phase 12 (e) and phase 13 (m): the buffered-async fleet of 8 clients
ASYNC_ARGV = ("--clients", "8", "--buffer-k", "3", "--late", "drop",
              "--chaos-dropout", "0.2", "--chaos-straggler", "0.3",
              "--chaos-store-fail", "0.2")
TRAINER_ARGV = ("--arch", "stablelm-1.6b", "--agg", "diana", "--wire-dtype",
                "packed8", "--fraction", "0.02", "--seq", "128", "--batch",
                "8", "--log-every", "1")
# each kernel's name as the profiler reports it ("pack_slab" alone would
# also match unpack_slab's kernel; the qualified prefix covers pack_slab's
# wide variant too)
# phase 15's budget of the traced peak against the card's measured one
DRY_RUN_PEAK_TOLERANCE = 0.10
# what phases 7 and 13 measured, for phase 15: "7" (phase 7's first run:
# cfg, agg, peak, profile) and "13f" (13 (f)'s processes' numbers, by rank,
# and the steps they ran)
MEASURED: dict = {}
KERNEL_KEYS = {"randk_mask": "repro_torch::randk_mask_kernel",
               "diana_shift_update": "repro_torch::diana_shift_kernel",
               "qsgd_quantize": "repro_torch::qsgd_kernel",
               "randk_compress": "repro_torch::randk_compress_kernel",
               "randk_decompress": "repro_torch::randk_decompress_kernel",
               "pack_slab": "repro_torch::pack_slab",
               "unpack_slab": "repro_torch::unpack_slab_kernel",
               "unpack_reduce": "repro_torch::unpack_reduce_kernel"}


@dataclasses.dataclass
class Case:
    """One kernel call beside its plain version. kind: "path" (the main
    path's shape: timed, profiled, a kernel's first one recorded in the
    JSON line), "large" and
    "family" (a model family's leaf shape; both timed and profiled) or
    "edge" (parity only)."""
    name: str
    label: str
    kern: object
    plain: object
    nbytes: int
    ops: int
    kind: str
    composite: object = None
    floor: object = None  # one plain PyTorch call that moves the same bytes


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


@contextlib.contextmanager
def phase_clock(phase: str):
    """Prints the wall time of a phase when it ends."""
    t0 = time.perf_counter()
    yield
    print(f"phase {phase}: {time.perf_counter() - t0:.1f} s", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, inner: int, samples: int = 15) -> float:
    """Median milliseconds of one call: CUDA events around `inner` calls."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def bound_ms(nbytes: int, ops: int) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_cases(torch, dev):
    """The simulator's three kernels: a list of Case."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.diana_shift import diana_shift_update
    from repro_torch.kernels.qsgd import TILE, qsgd_quantize
    from repro_torch.kernels.randk import randk_mask

    g = torch.Generator(device=dev).manual_seed(0)
    cases = []

    def randk(m, dp, d, k, dtype, kind, offset=0, starts=None):
        flat = torch.randn(m * dp + offset, generator=g, device=dev).to(dtype)
        x = flat[offset:].view(m, dp)  # offset: a view off the 16-byte grid
        st = (torch.randint(0, d, (m,), generator=g, device=dev,
                            dtype=torch.int32) if starts is None
              else torch.tensor(starts, dtype=torch.int32, device=dev))
        item = x.element_size()
        # the function needs only the k window values of each row of x: the
        # read is M*k elements (data-dependent), the write all M*Dp
        cases.append(Case(
            "randk_mask", f"({m}, {dp}) d={d} k={k} {dtype}"
            f"{f' offset={offset}' if offset else ''}",
            lambda: randk_mask(x, st, d=d, k=k),
            lambda: ref.randk_mask_ref(x, st, d=d, k=k),
            (m * k + m * dp) * item + 4 * m, m * dp, kind))

    def diana(h_shape, m_shape, kind, hd=torch.float32, qd=torch.float32,
              offset=0, aliased=False, tag=""):
        """h, Q_own of h_shape beside H, Q_mean of m_shape (h and H in hd,
        the Q's in qd); `offset` puts every input that many elements off the
        16-byte grid, `aliased` passes h as H and Q_own as Q_mean (the
        simulator's server update). The inputs are made at the case's first
        call and freed with the case: the train leaves' take 8-11 GB."""
        alpha = 1.0 / 50.0  # 1/(1+omega) of Rand-k at k/d = 0.02

        @functools.cache
        def ins():
            def one(shape, dtype):
                flat = torch.randn(math.prod(shape) + offset, generator=g,
                                   device=dev).to(dtype)
                return flat[offset:].view(shape)
            h, qo = one(h_shape, hd), one(h_shape, qd)
            return (h, qo, h, qo) if aliased else (
                h, qo, one(m_shape, hd), one(m_shape, qd))

        def composite():  # the three adds, unfused, as a yardstick
            h, qo, mh, qm = ins()
            return (torch.add(mh, qm), torch.add(h, qo, alpha=alpha),
                    torch.add(mh, qm, alpha=alpha))

        hn, mn = math.prod(h_shape), math.prod(m_shape)
        sh, sq = hd.itemsize, qd.itemsize
        shape = (f"N={hn}" if len(h_shape) == 1
                 else f"{tuple(h_shape)} + {tuple(m_shape)}")
        cases.append(Case(
            "diana_shift_update",
            f"{shape} {hd}/{qd}{f' offset={offset}' if offset else ''}"
            f"{' aliased' if aliased else ''}{tag}",
            lambda: diana_shift_update(*ins(), alpha=alpha),
            lambda: ref.diana_shift_update_ref(*ins(), alpha),
            # the h side: h and Q_own in, h' out; the H side: H and Q_mean
            # in, the direction and H' out
            hn * (2 * sh + sq) + mn * 2 * (sh + sq), 2 * hn + 3 * mn, kind,
            composite))

    def qsgd(n, dtype, kind, levels=8, x_offset=0, u_offset=0, zero=False,
             nan=False):
        """`x_offset` / `u_offset` put x / u that many elements off the
        16-byte grid (the scalar-lane variant); `zero` makes the first tile
        all zeros, `nan` puts a NaN into it."""
        flat = (torch.randn(n + x_offset, generator=g, device=dev) * 3
                ).to(dtype)
        x = flat[x_offset:]
        if zero:
            x[:TILE] = 0.0
        if nan:
            x[7] = float("nan")
        u = torch.rand(n + u_offset, generator=g, device=dev)[u_offset:]
        label = (f"N={n} {dtype} L={levels}"
                 f"{f' x_offset={x_offset}' if x_offset else ''}"
                 f"{f' u_offset={u_offset}' if u_offset else ''}"
                 f"{' zero tile' if zero else ''}{' NaN' if nan else ''}")

        def composite():  # the tile-wise max-abs, floor and rounding
            xt, ut = x.view(-1, TILE).float(), u.view(-1, TILE)
            scale = xt.abs().amax(1, keepdim=True) + 1e-30
            y = xt.abs() / scale * levels
            f = y.floor()
            return (xt.sign() * (f + (ut < y - f)) * (scale / levels)
                    ).to(x.dtype)

        out = torch.empty_like(x)
        cases.append(Case("qsgd_quantize", label,
                          lambda: qsgd_quantize(x, u, levels=levels),
                          lambda: ref.qsgd_quantize_ref(x, u, levels=levels),
                          n * (2 * x.element_size() + 4), 10 * n, kind,
                          composite, lambda: torch.add(x, u, out=out)))

    f32, bf16 = torch.float32, torch.bfloat16
    # the main path's shapes at w8a: Rand-k on the (20, 300) matrix of raveled
    # client gradients, k = 6; DIANA over 20*300 = 6000 (non-local rounds)
    # and 300 (DIANA-NASTYA's server update); QSGD over the 20 clients each
    # padded to one 1024-element tile
    randk(20, 300, 300, 6, f32, "path")
    diana((6000,), (6000,), "path")
    diana((300,), (300,), "edge")
    # the train path's stacked leaves, (1, 4, n) beside (1, n): stablelm's
    # embedding (100352 x 2048) and its 24 w_up (2048 x 5632); and a flat
    # call that moves the embedding's bytes (16 n = 7 N f32 values), which
    # tells the stacked layout's cost from the access's
    embed, w_up = 100352 * 2048, 24 * 2048 * 5632
    diana((1, 4, embed), (1, embed), "path", tag=" (embed)")
    diana((1, 4, w_up), (1, w_up), "path", tag=" (w_up)")
    # the same leaves' shards at T = 2 (the (4, 2) mesh's per-shard update)
    diana((1, 4, embed // 2), (1, embed // 2), "edge",
          tag=" (embed shard, T=2)")
    diana((1, 4, w_up // 2), (1, w_up // 2), "edge", tag=" (w_up shard, T=2)")
    diana((16 * embed // 7,), (16 * embed // 7,), "large",
          tag=" (the embed leaf's bytes, flat)")
    qsgd(20 * 1024, f32, "path")
    # large
    big, k_big = 2**20 - 77, int(0.02 * (2**20 - 77))
    randk(20, 2**20, big, k_big, f32, "large")
    randk(20, 2**20, big, k_big, bf16, "large")
    diana((2**24 + 128,), (2**24 + 128,), "large")
    diana((2**24 + 128,), (2**24 + 128,), "large", bf16, bf16)
    qsgd(2**24, f32, "large")
    qsgd(2**24, bf16, "large")
    # the edges of randk_mask's lanes: the w8a shape in bf16, an odd Dp, a
    # view off the 16-byte grid, every start of a short row (one value a
    # lane), windows wrapping across 16-byte lanes, k == d, and windows that
    # end at d inside a lane that runs into the padding
    randk(20, 300, 300, 6, bf16, "edge")
    for dtype in (f32, bf16):
        randk(64, 1001, 1001, 20, dtype, "edge")
        randk(64, 1024, 1024, 37, dtype, "edge", offset=1)
        randk(61, 64, 61, 13, dtype, "edge", starts=list(range(61)))
        randk(64, 1024, 1021, 13, dtype, "edge",
              starts=list(range(978, 1021)) + list(range(21)))
        randk(5, 4096, 4000, 4000, dtype, "edge")
        randk(4, 1024, 1024, 1024, dtype, "edge")
        randk(4, 1024, 1001, 9, dtype, "edge", starts=[992, 993, 1000, 0])
    # the edges of diana_shift_update's lanes, for each dtype pair (h/Q):
    # n not a multiple of 4 or 8, n = 1, 3 ranks, 2 groups of 2, inputs
    # off the 16-byte grid, and aliased inputs
    for hd in (f32, bf16):
        for qd in (f32, bf16):
            for n in (1, 1001, 1004, 6000):
                diana((n,), (n,), "edge", hd, qd)
            diana((1, 3, 1000), (1, 1000), "edge", hd, qd)
            diana((2, 2, 1000), (2, 1000), "edge", hd, qd)
            diana((2, 2, 1003), (2, 1003), "edge", hd, qd)
            diana((1, 4, 4096), (1, 4096), "edge", hd, qd, offset=1)
            diana((6000,), (6000,), "edge", hd, qd, aliased=True)
    # the edges of qsgd_quantize's lanes, in both dtypes: one tile, x and u
    # views off the 16-byte grid (the scalar-lane variant), an all-zero
    # tile, a tile holding a NaN, levels 1 and 127
    for dtype in (f32, bf16):
        qsgd(TILE, dtype, "edge")
        for x_off, u_off in ((1, 0), (0, 1), (2, 3)):
            qsgd(20 * TILE, dtype, "edge", x_offset=x_off, u_offset=u_off)
        qsgd(3 * TILE, dtype, "edge", zero=True)
        qsgd(3 * TILE, dtype, "edge", nan=True)
        qsgd(3 * TILE, dtype, "edge", nan=True, x_offset=1)
        for levels in (1, 127):
            qsgd(20 * TILE, dtype, "edge", levels=levels)
    return cases


def same_values(torch, a, b) -> tuple[bool, float]:
    """torch.equal, with NaN equal to NaN in the same places (torch.equal
    fails on any NaN), and the max abs difference of the other values."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False, math.inf
    if a.is_floating_point():
        nan = a.isnan()
        if not torch.equal(nan, b.isnan()):
            return False, math.nan
        a, b = a.masked_fill(nan, 0.0), b.masked_fill(nan, 0.0)
    err = float((a.float() - b.float()).abs().max()) if a.numel() else 0.0
    return torch.equal(a, b), err


def parity(torch, case) -> float:
    """Run the kernel and its plain version; fail unless bitwise equal (NaN
    where the plain version has NaN). Returns the max abs difference of
    the other values (0.0)."""
    got, want = case.kern(), case.plain()
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    pairs = [same_values(torch, a, b) for a, b in zip(got, want)]
    err = max(e for _, e in pairs)
    check(all(ok for ok, _ in pairs), f"{case.name} [{case.label}] differs "
                                      f"from its plain version (max abs err "
                                      f"{err})")
    return err


def device_us(torch, case, launches: int = 50):
    """torch.profiler's device time per launch of the case's kernel (None
    where the profiler saw no kernel)."""
    from torch.profiler import ProfilerActivity, profile

    case.kern()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(launches):
            case.kern()
        torch.cuda.synchronize()
    us, count = _device_us(torch, _device_rows(torch, prof),
                           [KERNEL_KEYS[case.name]])
    return None if us is None else us / count


def plain_device_us(torch, fn, launches: int = 50):
    """torch.profiler's device time per launch of `fn`, one PyTorch call
    (every device event of the window; None where it saw none)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(launches):
            fn()
        torch.cuda.synchronize()
    us, count = _device_us(torch, _device_rows(torch, prof), None)
    return None if us is None else us / count


def launch_floor(torch, nbytes: int) -> str:
    """The device time per launch of a plain PyTorch fill of `nbytes` and of
    a copy that moves them (half read, half written): the practical floor
    of one launch on the card, for a kernel that moves as many bytes."""
    dev = torch.device("cuda")
    filled = torch.empty(nbytes // 4, device=dev)
    src = torch.randn(nbytes // 8, device=dev)
    dst = torch.empty_like(src)
    times = [plain_device_us(torch, fn) for fn in (
        lambda: filled.fill_(1.0), lambda: dst.copy_(src))]
    fill, copy = ("not measured" if t is None else f"{t:.2f} us"
                  for t in times)
    return (f"launch floor ({nbytes} bytes): fill {fill}, copy {copy} per "
            f"launch (device)")


def card_state() -> str:
    """The card's SM clock, temperature and power draw now."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,temperature.gpu,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def run_cases(torch, cases, prefix: str):
    """Parity for every case; for path and large cases also the wrapper's
    and the plain version's times (CUDA events), the composite's where
    there is one, the bound, and the device time per launch. Returns each
    kernel's record: its parity, and the times of its first path case."""
    records = {}
    while cases:
        case = cases.pop(0)  # frees the inputs of the cases before it
        err = parity(torch, case)
        rec = records.setdefault(case.name, {"max_abs_err": 0.0})
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        if case.kind == "edge":
            print(f"{prefix} {case.name} [{case.label}]: bitwise=True",
                  flush=True)
            continue
        inner = 200 if case.nbytes < 2**24 else 10
        ms = time_ms(torch, case.kern, inner)
        plain_ms = time_ms(torch, case.plain, inner)
        comp_ms = (None if case.composite is None
                   else time_ms(torch, case.composite, inner))
        b_ms, b_by = bound_ms(case.nbytes, case.ops)
        us = device_us(torch, case)
        comp = "none" if comp_ms is None else f"{comp_ms * 1e3:.2f} us"
        dev = "not measured" if us is None else f"{us:.2f} us"
        print(f"{prefix} {case.name} [{case.label}] ({case.kind}): "
              f"bitwise=True max_abs_err={err} time={ms * 1e3:.2f} us "
              f"device={dev} plain={plain_ms * 1e3:.2f} us composite={comp} "
              f"bytes={case.nbytes} bound={b_ms * 1e3:.3f} us ({b_by})",
              flush=True)
        if case.kind == "path" and "ms" not in rec:  # the first: the JSON's
            rec.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
            if case.name == "qsgd_quantize":  # w8a: a launch's fixed cost
                print(f"{prefix} {case.name} [{case.label}]: device {dev} "
                      f"beside the {launch_floor(torch, case.nbytes)}",
                      flush=True)
    torch.cuda.empty_cache()
    return records


def phase_kernels(torch, dev):
    return run_cases(torch, kernel_cases(torch, dev), "kernel")


def phase_main_path(torch, dev):
    from repro_torch import experiments
    from repro_torch.compression.ops import QSGDQuantizer, RandK
    from repro_torch.core.algorithms import (
        init_algorithm,
        make_epoch_fn,
        theoretical_stepsizes,
    )
    from repro_torch.data.pipeline import run_epochs
    from repro_torch.data.reshuffle import ReshuffleSampler
    from repro_torch.kernels import LAUNCHES, reset_launches

    t0 = time.perf_counter()
    problem = experiments.make_problem("w8a", device=dev)
    print(f"w8a problem: a {tuple(problem.data['a'].shape)}, L_max="
          f"{problem.l_max:.6g}, mu={problem.mu:.6g}, f*={problem.f_star:.12g}, "
          f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    # warm-up (cuBLAS handles, first-call costs) so the first timed method
    # does not carry them
    warm = experiments.make_problem("paper", device=dev)
    for name in ("qsgd", "diana_nastya"):
        experiments.run_method(warm, name, RandK(fraction=0.02), 1)

    reset_launches()
    rows = (experiments.experiment1(W8A_EPOCHS, quick=True, problem=problem)
            + experiments.experiment2(W8A_EPOCHS, quick=True, problem=problem))
    sub, dt, _ = experiments.run_method(problem, "q_rr",
                                           QSGDQuantizer(levels=8), 1)
    rows.append(("q_rr/qsgd8", dt * 1e6, sub))
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    for name, us, sub in rows:
        print(f"main path {name}: {us / 1e6:.3f} s/epoch, f - f* = {sub!r}",
              flush=True)
        check(math.isfinite(sub), f"{name}: f - f* is not finite ({sub})")
    print(f"main path launches: {launches}", flush=True)
    for name in SIM_KERNELS:
        check(launches[name] > 0, f"kernel {name} was not launched on the "
                                  "main path")

    # one DIANA-RR epoch, kernels vs plain versions, from a state with
    # non-zero shift tables (one epoch in), same order and draws
    comp = RandK(fraction=0.02)
    th = theoretical_stepsizes("diana_rr", l_max=problem.l_max, mu=problem.mu,
                               omega=comp.omega(problem.d), m=problem.m,
                               n=problem.n)
    loss = problem.loss_fn()
    spec, ep_cuda = make_epoch_fn("diana_rr", loss, comp, gamma=th["gamma"],
                                  alpha=th["alpha"], backend="cuda")
    _, ep_ref = make_epoch_fn("diana_rr", loss, comp, gamma=th["gamma"],
                              alpha=th["alpha"], backend="reference")
    sampler = ReshuffleSampler(problem.m, problem.n, mode="rr_once", seed=0)
    st = init_algorithm(spec, {"w": torch.zeros(problem.d, device=dev)},
                        problem.m, problem.n)
    st = run_epochs(ep_cuda, st, problem.data, sampler, epochs=1)
    g = torch.Generator(device=dev).manual_seed(1)
    draws = {"starts": torch.randint(0, problem.d, (problem.n, problem.m),
                                     generator=g, device=dev)}
    order = torch.from_numpy(sampler.epoch_order(1)).to(dev)
    a = ep_cuda(st, problem.data, g, order, draws)
    b = ep_ref(st, problem.data, g, order, draws)
    torch.cuda.synchronize()
    diff = max(float((a.params["w"] - b.params["w"]).abs().max()),
               float((a.shifts["w"] - b.shifts["w"]).abs().max()))
    same = (torch.equal(a.params["w"], b.params["w"])
            and torch.equal(a.shifts["w"], b.shifts["w"]))
    print(f"diana_rr epoch, cuda vs reference backend (tolerance: bitwise): "
          f"equal={same} max_abs_diff={diff}", flush=True)
    check(same, f"diana_rr: cuda and reference backends differ by {diff}")
    return launches, problem


DeviceRow = collections.namedtuple("DeviceRow",
                                   "key self_device_time_total count")


def _device_rows(torch, prof):
    """The device events of a torch.profiler run summed by name, most
    device time first: what `key_averages()` gives for them, read from the
    profiler's raw records (`kineto_results`) without parsing every host
    event into a tree (20 s for a train step's window of 10^5 kernels)."""
    raw = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    if raw is None:
        raise RuntimeError("the profiler kept no raw records "
                           "(kineto_results) to read the device events from")
    totals = {}
    cuda = torch.autograd.DeviceType.CUDA
    for e in raw.events():
        if e.device_type() != cuda:
            continue
        us, n = totals.get(e.name(), (0.0, 0))
        totals[e.name()] = (us + e.duration_ns() / 1e3, n + 1)
    return sorted((DeviceRow(k, us, n) for k, (us, n) in totals.items()),
                  key=lambda r: -r.self_device_time_total)


def _device_us(torch, rows, names):
    """Summed device time (us) and count of the kernels whose name contains
    one of `names` (all for None), from `_device_rows` (None if it saw no
    kernel)."""
    total, count = 0.0, 0
    for row in rows:
        if names is None or any(n in row.key for n in names):
            total += row.self_device_time_total
            count += row.count
    return (total, count) if count else (None, 0)


def phase_profile(torch, dev, problem):
    """The device's busy share over a window of DIANA-RR rounds at w8a."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.compression.ops import RandK
    from repro_torch.core.algorithms import (
        init_algorithm,
        make_round_fn,
        theoretical_stepsizes,
    )
    from repro_torch.data.reshuffle import ReshuffleSampler

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    comp = RandK(fraction=0.02)
    th = theoretical_stepsizes("diana_rr", l_max=problem.l_max, mu=problem.mu,
                               omega=comp.omega(problem.d), m=problem.m,
                               n=problem.n)
    spec, round_fn = make_round_fn("diana_rr", problem.loss_fn(), comp,
                                   gamma=th["gamma"], alpha=th["alpha"])
    st = init_algorithm(spec, {"w": torch.zeros(problem.d, device=dev)},
                        problem.m, problem.n)
    order = torch.from_numpy(ReshuffleSampler(
        problem.m, problem.n, mode="rr_once").epoch_order(0)).to(dev).long()
    gen = torch.Generator(device=dev).manual_seed(0)
    params, shifts = st.params, st.shifts
    warm, rounds = min(20, problem.n // 2), min(200, problem.n // 2)
    for i in range(warm):
        params, shifts = round_fn(params, shifts, problem.data, order[:, i], gen)
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(warm, warm + rounds):
            params, shifts = round_fn(params, shifts, problem.data, order[:, i],
                                      gen)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = _device_rows(torch, prof)
    busy, kernels = _device_us(torch, rows, None)
    if busy is None:
        print("profile diana_rr rounds: device busy share not measured "
              "(the profiler saw no kernels)", flush=True)
    else:
        print(f"profile diana_rr rounds (w8a, {rounds} rounds, profiler on): "
              f"{wall_us / rounds:.1f} us/round wall, {busy / rounds:.1f} "
              f"us/round device busy ({kernels / rounds:.1f} kernels/round), "
              f"device idle share {1 - busy / wall_us:.3f}", flush=True)
        for r in rows[:8]:
            print(f"  {r.self_device_time_total / rounds:8.2f} us/round "
                  f"{r.count / rounds:5.2f}/round  {r.key[:90]}", flush=True)


def wire_cases(torch, dev):
    """The five wire kernels: a list of Case, with the nearest PyTorch
    composite where there is one."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.pack import pack_slab, unpack_reduce, unpack_slab
    from repro_torch.kernels.randk import randk_compress, randk_decompress

    g = torch.Generator(device=dev).manual_seed(0)
    cases = []
    f32, bf16 = torch.float32, torch.bfloat16

    def rows_case(r, n, d, kb, start, dtype, kind, tag="", offset=0):
        """randk_compress and randk_decompress on (r, n, d) rows, or (n, d)
        for r None; `offset` puts the rows that many elements off the
        16-byte grid."""
        lead = () if r is None else (r,)
        ranks = r or 1
        flat = torch.randn(ranks * n * d + offset, generator=g,
                           device=dev).to(dtype)
        rows = flat[offset:].view(*lead, n, d)
        s = torch.tensor(start, dtype=torch.int32, device=dev)
        nb, item, k = n // 8, rows.element_size(), kb * 8
        idx = (s.long() + torch.arange(kb, device=dev)) % nb
        scale = ref.randk_scale(nb, kb)
        vals = randk_compress(rows, s, k_blocks=kb)
        label = (f"({', '.join(map(str, (*lead, n, d)))}) kb={kb} "
                 f"start={start} {dtype}"
                 f"{f' offset={offset}' if offset else ''}{tag}")
        cases.append(Case(
            "randk_compress", label,
            lambda: randk_compress(rows, s, k_blocks=kb),
            lambda: ref.randk_compress_ref(rows, s, k_blocks=kb),
            2 * ranks * k * d * item + 4, ranks * k * d, kind,
            lambda: rows.view(ranks, nb, 8, d).index_select(1, idx) * scale))
        cases.append(Case(
            "randk_decompress", label,
            lambda: randk_decompress(vals, s, n_rows=n),
            lambda: ref.randk_decompress_ref(vals, s, n_rows=n),
            ranks * (k + n) * d * item + 4, 0, kind,
            lambda: torch.zeros(ranks, nb, 8, d, dtype=dtype, device=dev
                                ).index_copy_(1, idx,
                                              vals.view(ranks, kb, 8, d))))

    def pack_case(r, k, d, levels, nibble, kind, dtype=f32, offset=0,
                  unpack=True, tag=""):
        lead = () if r is None else (r,)
        n = k * d * (r or 1)
        flat = (torch.randn(n + offset, generator=g, device=dev) * 3).to(dtype)
        vals = flat[offset:].view(*lead, k, d)  # offset: off the 16-byte grid
        vals[..., 1, :] = 0.0  # an all-zero row
        u = torch.rand(k, d, generator=g, device=dev)
        packed, scales = pack_slab(vals, u, levels=levels, nibble=nibble)
        kp = scales.shape[-2]
        pbytes, ranks = packed.numel(), r or 1
        label = (f"({'' if r is None else f'{r}, '}{k}, {d}) L={levels} "
                 f"nibble={nibble} {dtype}{f' offset={offset}' if offset else ''}"
                 f"{tag}")
        # bytes: each rank's values once, the shared uniforms once, the
        # packed bytes and the scales
        cases.append(Case(
            "pack_slab", label,
            lambda: pack_slab(vals, u, levels=levels, nibble=nibble),
            lambda: ref.pack_slab_ref(vals, u, levels=levels, nibble=nibble),
            ranks * k * d * vals.element_size() + k * d * 4 + pbytes
            + ranks * kp * 4, 10 * ranks * k * d, kind))
        if not unpack:
            return
        cases.append(Case(
            "unpack_slab", label,
            lambda: unpack_slab(packed, scales, levels=levels, n_rows=k,
                                nibble=nibble),
            lambda: ref.unpack_slab_ref(packed, scales, levels=levels,
                                        n_rows=k, nibble=nibble),
            pbytes + ranks * kp * 4 + ranks * k * d * 4, 2 * ranks * k * d,
            kind,
            None if nibble else (lambda: (packed.float() - levels) * scales),
            # the bytes to f32 in one conversion: the same bytes, less the
            # scales, where k == Kp
            None if nibble or k != kp else packed.float))

    def reduce_case(r, k, d, levels, nibble, weighted, kind, tag="",
                    offset=0):
        vals = torch.randn(r, k, d, generator=g, device=dev) * 3
        u = torch.rand(k, d, generator=g, device=dev)
        packed, scales = pack_slab(vals, u, levels=levels, nibble=nibble)
        if weighted:  # the elastic weights (one of them 0) fold into the scales
            w = torch.tensor([ELASTIC_WEIGHTS[i % len(ELASTIC_WEIGHTS)]
                              for i in range(r)], device=dev)
            scales = scales * w.reshape(r, 1, 1)
        if offset:  # a packed view off the 8- (and 4-) byte grid
            flat = torch.zeros(packed.numel() + offset, dtype=torch.uint8,
                               device=dev)
            packed = flat[offset:].view(packed.shape).copy_(packed)
        kp = scales.shape[1]
        label = (f"({r}, {k}, {d}) L={levels} nibble={nibble}"
                 f"{' weighted' if weighted else ''}"
                 f"{f' offset={offset}' if offset else ''}{tag}")
        cases.append(Case(
            "unpack_reduce", label,
            lambda: unpack_reduce(packed, scales, levels=levels, n_rows=k,
                                  nibble=nibble),
            lambda: ref.unpack_reduce_ref(packed, scales, levels=levels,
                                          n_rows=k, nibble=nibble),
            packed.numel() + r * kp * 4 + k * d * 4, 3 * r * k * d, kind,
            None if nibble else (
                lambda: ((packed.float() - levels) * scales).sum(0) / r)))

    def slab_case(r, k, d, levels, nibble, offset=0, nan=False):
        """unpack_slab alone on real packed slabs of (r, k, d), or (k, d)
        for r None; `offset` puts the packed view that many bytes off the
        grid, `nan` makes row 2's scale NaN."""
        lead = () if r is None else (r,)
        vals = torch.randn(*lead, k, d, generator=g, device=dev) * 3
        vals[..., 1, :] = 0.0  # an all-zero row
        u = torch.rand(k, d, generator=g, device=dev)
        packed, scales = pack_slab(vals, u, levels=levels, nibble=nibble)
        if nan:
            scales[..., 2, :] = float("nan")
        if offset:
            flat = torch.zeros(packed.numel() + offset, dtype=torch.uint8,
                               device=dev)
            packed = flat[offset:].view(packed.shape).copy_(packed)
        kp, ranks = scales.shape[-2], r or 1
        cases.append(Case(
            "unpack_slab", f"({'' if r is None else f'{r}, '}{k}, {d}) "
            f"L={levels} nibble={nibble}{f' offset={offset}' if offset else ''}"
            f"{' NaN scale' if nan else ''}",
            lambda: unpack_slab(packed, scales, levels=levels, n_rows=k,
                                nibble=nibble),
            lambda: ref.unpack_slab_ref(packed, scales, levels=levels,
                                        n_rows=k, nibble=nibble),
            packed.numel() + ranks * kp * 4 + ranks * k * d * 4,
            2 * ranks * k * d, "edge"))

    def decompress_case(lead, n, d, kb, start, dtype, offset=0):
        k = kb * 8
        flat = torch.randn(math.prod(lead) * k * d + offset, generator=g,
                           device=dev).to(dtype)
        vals = flat[offset:].view(*lead, k, d)  # offset: off the 16-byte grid
        s = torch.tensor(start, dtype=torch.int32, device=dev)
        cases.append(Case(
            "randk_decompress", f"({', '.join(map(str, lead))}{', ' if lead else ''}"
            f"{k}, {d}) -> {n} rows start={start} {dtype}"
            f"{f' offset={offset}' if offset else ''}",
            lambda: randk_decompress(vals, s, n_rows=n),
            lambda: ref.randk_decompress_ref(vals, s, n_rows=n),
            math.prod(lead) * (k + n) * d * vals.element_size() + 4, 0,
            "edge"))

    # the model families' new leaf shapes on the packed8 wire, 4 ranks,
    # k/d = 0.02, f32 payloads, windows that wrap: qwen2-moe's expert leaf
    # (2 layers x 60 experts x 2048 rows of 1408) and its f32 router (2 x
    # 2048 rows of 60), hymba's wdt (32 x 1600 rows of 25: pack_slab's
    # one-value-a-unit variant) and rwkv6's f32 bonus u (layers x 64 rows
    # of 64)
    rwkv_layers = {n: layers for n, layers, _, _ in FAMILY_RUNS}["rwkv6-7b"]
    for tag, n, d in (("qwen2-moe expert", 2 * 60 * 2048, 1408),
                      ("qwen2-moe router", 2 * 2048, 60),
                      ("hymba wdt", 32 * 1600, 25),
                      ("rwkv6 u", rwkv_layers * 64, 64)):
        nb = n // 8
        kb = max(1, int(0.02 * nb))
        rows_case(4, n, d, kb, nb - kb // 2, f32, "family", f" ({tag})")
        pack_case(4, kb * 8, d, 127, False, "family", tag=f" ({tag})")
        reduce_case(4, kb * 8, d, 127, False, False, "family", f" ({tag})")
    # the model axis at T = 2: each shard's rows as the wire exchanges them
    # (4 ranks, k/d = 0.02, f32 payloads, windows that wrap): stablelm-
    # 1.6b's embedding shard (50176, 2048), kb = 125, its 24 layers' w_up
    # and w_gate shards (24 * 2048, 2816), w_down (24 * 2816, 2048) and wo
    # (24 * 1024, 2048) shards, and hymba's per-head ln shard: 25 heads do
    # not split in two, so the last axis does (32 * 25 rows of 32)
    for tag, n, d in (("embed shard", 50176, 2048),
                      ("w_up shard", 24 * 2048, 2816),
                      ("w_down shard", 24 * 2816, 2048),
                      ("wo shard", 24 * 1024, 2048),
                      ("hymba ln shard", 32 * 25, 32)):
        nb = n // 8
        kb = max(1, int(0.02 * nb))
        rows_case(4, n, d, kb, nb - kb // 2, f32, "edge", f" ({tag}, T=2)")
        pack_case(4, kb * 8, d, 127, False, "edge", tag=f" ({tag}, T=2)")
        reduce_case(4, kb * 8, d, 127, False, False, "edge",
                    f" ({tag}, T=2)")
    # the path: stablelm-1.6b's embedding leaf (100352, 2048) and its stacked
    # w_up leaf as rows (24 * 2048, 5632), 4 ranks, k/d = 0.02
    rows_case(4, 100352, 2048, 250, 12400, f32, "path", " (embed)")
    rows_case(4, 24 * 2048, 5632, 122, 6100, f32, "large", " (w_up)")
    pack_case(4, 2000, 2048, 127, False, "path")
    pack_case(4, 976, 5632, 127, False, "large")
    pack_case(4, 2000, 2048, 7, True, "large")
    reduce_case(4, 2000, 2048, 127, False, False, "path")
    reduce_case(4, 976, 5632, 127, False, False, "large")
    # ragged: a window that wraps, one block (kb == nb), D % 4 != 0, bf16
    rows_case(4, 64, 33, 3, 7, f32, "edge")
    rows_case(4, 64, 33, 3, 7, bf16, "edge")
    rows_case(2, 8, 5, 1, 0, f32, "edge")
    rows_case(2, 1024, 1003, 128, 100, bf16, "edge")
    rows_case(4, 100352, 2048, 250, 12540, bf16, "edge", " (embed)")
    # randk_compress's flat lanes: narrow and odd D in both types, 1 and 3
    # ranks and (N, D) rows, a window that wraps, kb == nb rotated, a start
    # below 0, and rows views off the 16-byte grid (one element a lane)
    for d in (25, 60, 5, 33, 1):
        for dtype in (f32, bf16):
            rows_case(3, 64, d, 3, 7, dtype, "edge")
            rows_case(1, 64, d, 8, 5, dtype, "edge")
            rows_case(None, 96, d, 5, -2, dtype, "edge")
    rows_case(4, 64, 25, 3, 7, f32, "edge", offset=1)
    rows_case(3, 64, 60, 8, 5, bf16, "edge", offset=3)
    rows_case(4, 64, 2048, 3, 7, bf16, "edge", offset=1)
    pack_case(4, 13, 1003, 127, False, "edge")
    pack_case(4, 13, 1003, 7, True, "edge")
    # pack_slab's variants: bf16 (8-value units), one slab, R = 1 and 8, odd
    # K in nibbles, D % 4 != 0, views off the 16-byte grid, the widest rows
    # the registers take and rows past them (the wide variant), both lanes
    pack_case(4, 64, 2048, 127, False, "edge", bf16)
    pack_case(4, 64, 2048, 7, True, "edge", bf16)
    pack_case(None, 24, 2048, 127, False, "edge", unpack=False)
    pack_case(1, 24, 5632, 127, False, "edge")
    pack_case(8, 40, 2048, 127, False, "edge")
    pack_case(8, 37, 2048, 7, True, "edge")
    pack_case(4, 13, 1002, 127, False, "edge")
    pack_case(4, 16, 2048, 127, False, "edge", offset=1)
    pack_case(4, 16, 2048, 7, True, "edge", bf16, offset=3)
    pack_case(2, 10, 20000, 127, False, "edge")
    pack_case(2, 10, 20000, 7, True, "edge")
    pack_case(2, 10, 16384, 127, False, "edge")
    pack_case(2, 10, 8192, 7, True, "edge")
    pack_case(2, 9, 5632, 7, True, "edge", bf16)
    reduce_case(4, 2000, 2048, 7, True, False, "edge")
    reduce_case(3, 13, 1003, 127, False, False, "edge")
    reduce_case(3, 13, 1003, 7, True, False, "edge")
    reduce_case(4, 2000, 2048, 127, False, True, "edge")
    # randk_decompress's flat 16-byte lanes: narrow and odd D in both types,
    # one group and four, a window that wraps and one of every block, and a
    # slab view one element off the grid (one element a lane)
    for d in (25, 60, 64, 5, 33):
        for dtype in (f32, bf16):
            decompress_case((1,), 64, d, 3, 7, dtype)
            decompress_case((4,), 64, d, 8, 5, dtype)
    decompress_case((4,), 64, 25, 3, 7, f32, offset=1)
    decompress_case((4,), 64, 2048, 3, 7, bf16, offset=1)
    # unpack_reduce's flat units: D on the 8-, 4- and 1-byte grids, one
    # rank, odd counts and ranks past the kernel's chunk of 4, odd n_rows <
    # Kp in nibbles, weighted scales with a zero weight, packed views off
    # the 8- and 4-byte grids
    for d in (25, 60, 1408, 1003, 2048):
        for ranks in (1, 3, 9, 64):
            reduce_case(ranks, 13, d, 127, False, True, "edge")
            reduce_case(ranks, 13, d, 7, True, True, "edge")
    for offset in (4, 1):
        reduce_case(4, 13, 2048, 127, False, True, "edge", offset=offset)
        reduce_case(4, 13, 1408, 7, True, True, "edge", offset=offset)
    # unpack_slab's flat units (unpack_reduce's at one rank a group): D on
    # the 8-, 4- and 1-byte grids, one slab and R = 1, 3 and 4, K = 13 (odd
    # n_rows < Kp, so in nibble mode the last stored row holds one output
    # row), an all-zero row, packed views off the 8- and 4-byte grids, and a
    # NaN scale (its row decodes to NaN on both sides)
    for d in (25, 60, 64, 1408, 5632, 1003):
        for r in (1, 3, 4):
            slab_case(r, 13, d, 127, False)
            slab_case(r, 13, d, 7, True)
    slab_case(None, 13, 64, 127, False)
    slab_case(None, 13, 60, 7, True)
    for offset in (4, 1):
        slab_case(4, 13, 2048, 127, False, offset=offset)
        slab_case(4, 13, 1408, 7, True, offset=offset)
    slab_case(4, 13, 2048, 127, False, nan=True)
    slab_case(3, 13, 1003, 7, True, nan=True)
    return cases


def phase_wire_kernels(torch, dev):
    return run_cases(torch, wire_cases(torch, dev), "wire kernel")


def _train_batches(cfg, steps: int, n_slots: int, local_steps: int = 1,
                   seq: int = TRAIN_SEQ):
    """Client-major token batches (each client's local_steps micro-batches
    in turn) and the shared slots of each step (the rr_shared order over
    n_slots batches per client)."""
    import numpy as np

    from repro_torch.data.pipeline import shared_slots_for_step
    from repro_torch.data.reshuffle import ReshuffleSampler
    from repro_torch.data.tokens import synthetic_token_batches

    toks = synthetic_token_batches(vocab=cfg.vocab, seq_len=seq,
                                   batch=TRAIN_BATCH, num_batches=n_slots,
                                   num_clients=TRAIN_CLIENTS, seed=0)
    sampler = ReshuffleSampler(TRAIN_CLIENTS, n_slots, mode="rr_shared",
                               seed=0)
    out = []
    for t in range(steps):
        slots = shared_slots_for_step(sampler, t, local_steps,
                                      n_slots=n_slots)
        rows = toks[:, slots].reshape(-1, seq + 1)
        out.append((np.ascontiguousarray(rows), slots))
    return out


def _model_batch(torch, dev, cfg, rows, step: int) -> dict:
    """A step's batch: the tokens and, for the VLM and the encoder-decoder,
    the stub patch or frame embeddings (the vision tower's and the audio
    frontend's outputs), drawn from a generator seeded by the step."""
    batch = {"tokens": rows}
    gen = torch.Generator(device=dev).manual_seed(1000 + step)
    if cfg.family == "vlm":
        batch["patches"] = torch.randn(
            rows.shape[0], cfg.vision_patches, cfg.d_model, generator=gen,
            device=dev).to(cfg.dtype)
    if cfg.is_encdec:
        batch["frames"] = torch.randn(
            rows.shape[0], cfg.encoder_seq, cfg.d_model, generator=gen,
            device=dev).to(cfg.dtype)
    return batch


def _wire_launches(agg, n_leaves: int, steps: int,
                   local_steps: int = 1) -> dict:
    """Launches of each wire kernel that `steps` steps of the configured
    `agg` imply: one exchange per leaf (per model shard of a split leaf)
    per level, the inner level once per local step, the outer once per
    step."""
    levels = (local_steps if agg.client_axes else 0) + (
        1 if agg.pod_axes and agg.pod_size > 1 else 0)
    shards = agg.local_shards.stop - agg.local_shards.start
    exchanges = n_leaves if agg.model_size == 1 else sum(
        1 if ax is None else shards for ax in agg.model_axes)
    per = exchanges * levels * steps
    shared = agg.wire == "shared"
    packed = agg.wire_dtype in ("packed8", "packed4")
    quant = agg.wire_levels is not None or packed
    return {"randk_compress": per if shared else 0,
            "randk_decompress": 2 * per if shared else 0,
            "pack_slab": per if quant else 0,
            "unpack_slab": per if quant else 0,
            "unpack_reduce": per if packed else 0,
            "diana_shift_update": per if agg.method in ("diana", "diana_rr")
            else 0}


@contextlib.contextmanager
def call_bytes(torch):
    """While the block runs, the bytes each wire kernel's call must move
    (each input read once, each output written once; randk_compress reads
    only the window's rows, as many bytes as it writes): {kernel: [bytes
    per call]}. Wraps the backend's bindings, so every call is seen."""
    from repro_torch.compression import backend

    seen = {name: [] for name in WIRE_KERNELS + ("diana_shift_update",)}
    saved = {name: getattr(backend, name) for name in seen}

    def recorder(name, fn):
        def call(*args, **kwargs):
            out = fn(*args, **kwargs)
            outs = out if isinstance(out, tuple) else (out,)
            moved = sum(t.nbytes for t in outs)
            ins = [a for a in args if isinstance(a, torch.Tensor)]
            if name == "randk_compress":
                ins = ins[1:]  # the start; the rows read = the rows written
                moved *= 2
            seen[name].append(moved + sum(t.nbytes for t in ins))
            return out
        return call

    try:
        for name, fn in saved.items():
            setattr(backend, name, recorder(name, fn))
        yield seen
    finally:
        for name, fn in saved.items():
            setattr(backend, name, fn)


def run_train(torch, dev, cfg, mesh_shape, agg, *, steps: int, label: str,
              n_slots: int = 2, profile_steps: int = 0, local_steps: int = 1,
              elastic: bool = False, debug_metrics: bool = False,
              seq: int = TRAIN_SEQ, remat=False):
    """Warm-up + `steps` timed train steps (+ a profiler window); prints
    the run and returns its numbers: "launches", "peak" (bytes), "s_step"
    and "profile" (`profile_train`'s, None without a window)."""
    from repro_torch.core.api import tree_leaves
    from repro_torch.kernels import LAUNCHES
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import (
        configure_agg,
        init_train_state,
        make_train_step,
    )

    axes = ("pod", "data", "model")[-len(mesh_shape):]
    mesh = make_mesh(mesh_shape, axes)
    torch.cuda.reset_peak_memory_stats()
    before = dict(LAUNCHES)
    t0 = time.perf_counter()
    state = init_train_state(0, cfg, agg, TRAIN_CLIENTS, mesh=mesh,
                             local_steps=local_steps, device=dev)
    step = make_train_step(cfg, mesh, agg=agg, lr=0.05,
                           eta=0.1 if local_steps > 1 else None,
                           local_steps=local_steps, remat=remat,
                           elastic=elastic, debug_metrics=debug_metrics)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    slotted = agg.method == "diana_rr"
    weights = (torch.tensor(ELASTIC_WEIGHTS, device=dev) if elastic
               else None)
    batches = [(_model_batch(torch, dev, cfg, torch.from_numpy(rows).to(dev),
                             i), sl if slotted else None)
               for i, (rows, sl) in enumerate(_train_batches(
                   cfg, 1 + steps + profile_steps, n_slots, local_steps,
                   seq))]
    gen = torch.Generator(device=dev).manual_seed(0)
    losses = []
    times = []
    for i, (batch, slots) in enumerate(batches[:1 + steps]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i == 0:  # the warm-up step, untimed: the wire calls' bytes
            with call_bytes(torch) as moved:
                state, metrics = step(state, batch, gen, slots, weights)
        else:
            state, metrics = step(state, batch, gen, slots, weights)
        losses.append(float(metrics["loss"]))  # synchronises
        if i:
            times.append(time.perf_counter() - t0)
    check(all(math.isfinite(x) for x in losses),
          f"{label}: a loss is not finite ({losses})")
    if debug_metrics:
        debug = {k: float(v) for k, v in metrics.items()
                 if k not in ("loss", "grad_norm")}
        print(f"train {label}: debug metrics {debug}", flush=True)
        check(all(math.isfinite(v) for v in debug.values()),
              f"{label}: a debug metric is not finite ({debug})")
    peak = torch.cuda.max_memory_allocated()
    wired = configure_agg(agg, mesh, local_steps, params=state.params)
    wire_bytes = wired.wire_bytes_per_round(state.params)
    n_leaves = len(tree_leaves(state.params))
    got = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
    want = _wire_launches(wired, n_leaves, 1 + steps, local_steps)
    print(f"train {label}: losses={losses} s/step={statistics.mean(times):.4f} "
          f"(steps {[round(t, 4) for t in times]}) init={init_s:.1f} s "
          f"wire_bytes_per_round={wire_bytes} "
          f"max_memory_allocated={peak} ({peak / 2**30:.2f} GiB)", flush=True)
    print(f"train {label}: launches {got} (expected {want})", flush=True)
    for k, v in want.items():
        check(got[k] == v, f"{label}: {k} launched {got[k]} times, the "
                           f"wire implies {v}")
    prof = None
    if profile_steps:
        prof = profile_train(torch, step, state, batches[1 + steps:], gen,
                             label, weights, moved)
    return {"launches": got, "peak": peak, "s_step": statistics.mean(times),
            "profile": prof}


def profile_train(torch, step, state, batches, gen, label, weights, moved):
    """Device idle share and device time per kernel per step over a window
    of train steps under torch.profiler; beside each wire kernel's time per
    launch, its bound per launch from `moved` (call_bytes of a step).
    Returns {"device_ms", "kernels", "idle", "wall_ms"} a step, or None
    where it saw no kernel."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for batch, slots in batches:
            state, metrics = step(state, batch, gen, slots, weights)
        torch.cuda.synchronize()
        t_stop = time.perf_counter()
        wall_us = (t_stop - t0) * 1e6
    n = len(batches)
    t0 = time.perf_counter()
    rows = _device_rows(torch, prof)
    busy, kernels = _device_us(torch, rows, None)
    if busy is None:
        print(f"profile train {label}: device busy share not measured (the "
              "profiler saw no kernels)", flush=True)
        return None
    print(f"profile train {label} ({n} steps, profiler on): "
          f"{wall_us / n / 1e3:.2f} ms/step wall, {busy / n / 1e3:.2f} "
          f"ms/step device busy ({kernels / n:.1f} kernels/step), device "
          f"idle share {1 - busy / wall_us:.3f}", flush=True)
    for name in WIRE_KERNELS + ("diana_shift_update",):
        us, count = _device_us(torch, rows, [KERNEL_KEYS[name]])
        if us is not None:
            calls = moved[name]
            b_us = (statistics.mean(calls) / HBM_BYTES_PER_S * 1e6 if calls
                    else float("nan"))
            print(f"  {name}: {us / n / 1e3:.3f} ms/step device, "
                  f"{count / n:.1f} launches/step, {us / count:.2f} us/launch"
                  f", bound {b_us:.2f} us/launch (mean bytes of {len(calls)} "
                  f"calls in a step: {statistics.mean(calls) if calls else 0:.0f})"
                  f", {us / count / b_us:.2f}x", flush=True)
    for r in rows[:12]:
        print(f"  {r.self_device_time_total / n / 1e3:9.3f} ms/step "
              f"{r.count / n:7.1f}/step  {r.key[:90]}", flush=True)
    print(f"  (the profiler's stop took {t0 - t_stop:.1f} s, the aggregation "
          f"{time.perf_counter() - t0:.1f} s)", flush=True)
    counts = {name: _device_us(torch, rows, [KERNEL_KEYS[name]])[1] / n
              for name in WIRE_KERNELS + ("diana_shift_update",)}
    return {"device_ms": busy / n / 1e3, "kernels": kernels / n,
            "idle": 1 - busy / wall_us, "wall_ms": wall_us / n / 1e3,
            "counts": counts}


def shard_layouts(torch, dev, cfg):
    """The two layouts of a split leaf's shards on the wire, at stablelm-
    1.6b's embedding (4 ranks, (100352, 2048) split in two on its rows,
    packed8 at k/d = 0.02, one shared window): (a) the kept one, one
    exchange a shard on the shard's rows (a copy of each shard's rows,
    freed before the next); (b) the shards folded into the rank dimension,
    one exchange over (2 * 4, 50176, 2048) with twice the groups (one copy
    of the whole leaf to make the shards contiguous, then one to put the
    result back). Both give the same bits; prints each one's time (CUDA
    events, median of 5 after a warm-up), launches and peak memory above
    the inputs."""
    from repro_torch.compression.backend import BLOCK_ROWS, get_backend
    from repro_torch.kernels import LAUNCHES, reset_launches

    be = get_backend("cuda")
    r, n, d, t = TRAIN_CLIENTS, cfg.vocab, cfg.d_model, 2
    g = torch.Generator(device=dev).manual_seed(7)
    leaf = torch.randn(r, n, d, generator=g, device=dev)
    nb = n // t // BLOCK_ROWS
    kb = max(1, int(0.02 * nb))
    start = torch.tensor(nb - kb // 2, dtype=torch.int32, device=dev)
    u = torch.rand(kb * BLOCK_ROWS, d, generator=g, device=dev)

    def exchange(rows, groups):
        own, mean = be.wire_exchange(rows, start, k_blocks=kb,
                                     block_rows=BLOCK_ROWS, groups=groups,
                                     wire_dtype="packed8", levels=127,
                                     quant_u=u)
        return (be.wire_decompress(own, start, n_rows=rows.shape[1],
                                   block_rows=BLOCK_ROWS),
                be.wire_decompress(mean, start, n_rows=rows.shape[1],
                                   block_rows=BLOCK_ROWS))

    def per_shard():
        own = torch.empty_like(leaf)
        means = []
        for b in range(t):
            rows = leaf.narrow(1, b * (n // t), n // t).contiguous()
            o, m = exchange(rows, 1)
            own.narrow(1, b * (n // t), n // t).copy_(o)
            means.append(m)
            del rows, o
        return own, torch.cat(means, dim=1)

    def folded():
        rows = leaf.view(r, t, n // t, d).transpose(0, 1).reshape(
            t * r, n // t, d)
        o, m = exchange(rows, t)
        del rows
        own = o.view(t, r, n // t, d).transpose(0, 1).reshape(r, n, d)
        return own, m.view(t, n // t, d).reshape(1, n, d)

    results = {}
    for name, fn in (("per shard", per_shard), ("folded", folded)):
        out = fn()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        del out
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        out = fn()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        launches = {k: v for k, v in LAUNCHES.items() if v}
        ms = time_ms(torch, fn, 1, 5)
        results[name] = out
        print(f"shard layout {name}: {ms:.3f} ms a leaf, launches {launches},"
              f" peak above the inputs {peak / 2**30:.3f} GiB "
              f"(leaf {leaf.nbytes / 2**30:.3f} GiB)", flush=True)
    same = all(torch.equal(a, b) for a, b in zip(results["per shard"],
                                                 results["folded"]))
    print(f"shard layouts give the same bits (tolerance: bitwise): {same}",
          flush=True)
    check(same, "the per-shard and the folded layouts differ")


def phase7_first_run(torch, dev, cfg, agg) -> int:
    """Phase 7's first step (stablelm-1.6b, packed8 DIANA-RR on (4, 1),
    full depth, one profiler window); keeps its numbers for phase 15 and
    returns its peak."""
    run = run_train(torch, dev, cfg, (TRAIN_CLIENTS, 1), agg, steps=2,
                    label=f"diana_rr packed8 {cfg.num_layers} layers",
                    profile_steps=1)
    MEASURED["7"] = {"cfg": cfg, "agg": agg, "peak": run["peak"],
                     "profile": run["profile"]}
    return run["peak"]


def phase_train(torch, dev):
    """The train path (see the module docstring); returns its launches."""
    from repro_torch.configs import get_config
    from repro_torch.core.dist import CompressedAggregation
    from repro_torch.kernels import LAUNCHES, reset_launches

    cfg = get_config("stablelm-1.6b")
    print(f"train path: {cfg.name} d_model={cfg.d_model} heads={cfg.num_heads}"
          f" d_ff={cfg.d_ff} vocab={cfg.vocab} dtype={cfg.dtype}; "
          f"{TRAIN_CLIENTS} clients x {TRAIN_BATCH} x {TRAIN_SEQ} tokens",
          flush=True)
    reset_launches()
    full = CompressedAggregation(method="diana_rr", fraction=0.02, n_slots=2,
                                 wire_dtype="packed8")
    # one step a profiler window: at 24 layers the profiler's aggregation
    # takes about 17 s a DIANA-RR step and 32 s a NASTYA step (3 timed
    # steps until long_500k needed the time, here and in NASTYA's run)
    peak1 = phase7_first_run(torch, dev, cfg, full)
    torch.cuda.empty_cache()
    # the model axis: the reference's (4, 2) mesh, each split leaf
    # exchanged shard by shard (two launches of each wire kernel where
    # (4, 1) makes one), beside the (4, 1) step above
    peak2 = run_train(torch, dev, cfg, (TRAIN_CLIENTS, 2), full, steps=2,
                      label=f"diana_rr packed8 mesh (4, 2) "
                            f"{cfg.num_layers} layers",
                      profile_steps=1)["peak"]
    print(f"train path: peak memory (4, 1) {peak1 / 2**30:.2f} GiB, (4, 2) "
          f"{peak2 / 2**30:.2f} GiB", flush=True)
    torch.cuda.empty_cache()
    shard_layouts(torch, dev, cfg)
    torch.cuda.empty_cache()
    # (no profiler window since PR 22: its analysis took 32 s)
    nastya = CompressedAggregation(method="diana", fraction=0.02)
    run_train(torch, dev, cfg, (TRAIN_CLIENTS, 1), nastya, steps=2,
              local_steps=2,
              label=f"diana NASTYA local_steps=2 {cfg.num_layers} layers")
    torch.cuda.empty_cache()
    cut = dataclasses.replace(cfg, num_layers=CUT_LAYERS)
    # (method, mesh, CompressedAggregation options, run_train options)
    sweep = [("q", (4, 1), {}, {}), ("diana", (4, 1), {}, {}),
             ("ef", (4, 1), {}, {}), ("diana_rr", (4, 1), {}, {}),
             ("diana", (4, 1), {"wire_levels": 127}, {"profile_steps": 2}),
             ("diana", (4, 1), {"wire_dtype": "packed4"}, {}),
             ("diana", (4, 1), {"wire_dtype": "bf16"}, {}),
             ("diana", (4, 1), {"wire": "independent"}, {}),
             ("diana", (2, 2, 1), {}, {}),
             ("diana_rr", (2, 2, 1), {"wire_dtype": "packed8"}, {}),
             ("diana_rr", (2, 2, 1), {}, {"local_steps": 2}),
             ("diana", (4, 1), {}, {"elastic": True}),
             ("diana", (4, 1), {}, {"debug_metrics": True})]
    for method, mesh_shape, extra, opts in sweep:
        agg = CompressedAggregation(method=method, fraction=0.02, n_slots=2,
                                    **extra)
        what = " ".join(f"{k}={v}" for k, v in {**extra, **opts}.items()
                        if k != "profile_steps")
        run_train(torch, dev, cut, mesh_shape, agg, steps=2, **opts,
                  label=f"{method}{' ' + what if what else ''} mesh "
                        f"{mesh_shape} {CUT_LAYERS} layers")
        torch.cuda.empty_cache()
    launches = dict(LAUNCHES)
    print(f"train path launches: {launches}", flush=True)
    for name in WIRE_KERNELS + ("diana_shift_update",):
        check(launches[name] > 0, f"kernel {name} was not launched on the "
                                  "train path")
    return launches


def _step_leaves(torch, dev, cfg, mesh_shape, agg, batch, *,
                 local_steps=1, slots=None, weights=None, remat=False):
    """The state's leaves after one step from the seed-0 state."""
    from repro_torch.core.api import tree_leaves
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import init_train_state, make_train_step

    mesh = make_mesh(mesh_shape, ("pod", "data", "model")[-len(mesh_shape):])
    state = init_train_state(0, cfg, agg, TRAIN_CLIENTS, mesh=mesh,
                             local_steps=local_steps, device=dev)
    step = make_train_step(cfg, mesh, agg=agg, lr=0.05,
                           eta=0.1 if local_steps > 1 else None,
                           local_steps=local_steps, remat=remat,
                           elastic=weights is not None)
    state, _ = step(state, batch, torch.Generator(device=dev).manual_seed(5),
                    slots, weights)
    return tree_leaves(state)


def phase_train_cuda_vs_reference(torch, dev):
    """Steps at the cut depth on the kernels and on the plain versions
    (backend= argument), bitwise; and packed8 against the f32 wire at 127
    levels on the kernels, bitwise."""
    from repro_torch.configs import get_config
    from repro_torch.core.dist import CompressedAggregation

    cfg = dataclasses.replace(get_config("stablelm-1.6b"),
                              num_layers=CUT_LAYERS)

    def tokens(local_steps):
        rows, slots = _train_batches(cfg, 1, 2, local_steps)[0]
        return {"tokens": torch.from_numpy(rows).to(dev)}, slots

    weights = torch.tensor(ELASTIC_WEIGHTS, device=dev)
    # (label, method, mesh, CompressedAggregation options, step options)
    cases = [("diana", "diana", (4, 1), {}, {}),
             ("diana wire_levels=127", "diana", (4, 1),
              {"wire_levels": 127}, {}),
             ("diana packed8", "diana", (4, 1), {"wire_dtype": "packed8"}, {}),
             ("diana packed4", "diana", (4, 1), {"wire_dtype": "packed4"}, {}),
             ("diana bf16", "diana", (4, 1), {"wire_dtype": "bf16"}, {}),
             ("diana elastic packed8", "diana", (4, 1),
              {"wire_dtype": "packed8"}, {"weights": weights}),
             ("diana_rr NASTYA 2 pods packed8", "diana_rr", (2, 2, 1),
              {"wire_dtype": "packed8"}, {"local_steps": 2}),
             # the model axis: each split leaf exchanged shard by shard
             ("diana_rr packed8 T=2", "diana_rr", (4, 2),
              {"wire_dtype": "packed8"}, {}),
             ("diana T=2 2 pods", "diana", (2, 2, 2), {}, {})]
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for label, method, mesh_shape, extra, opts in cases:
            toks, slots = tokens(opts.get("local_steps", 1))
            outs = [_step_leaves(
                torch, dev, cfg, mesh_shape, CompressedAggregation(
                    method=method, fraction=0.02, n_slots=2, backend=backend,
                    **extra), toks,
                slots=slots if method == "diana_rr" else None, **opts)
                for backend in ("cuda", "reference")]
            diff = max(float((a.float() - b.float()).abs().max())
                       for a, b in zip(*outs))
            same = all(torch.equal(a, b) for a, b in zip(*outs))
            print(f"train step {label} mesh {mesh_shape} {CUT_LAYERS} layers,"
                  f" cuda vs reference backend (tolerance: bitwise): "
                  f"equal={same} max_abs_diff={diff}", flush=True)
            check(same, f"{label}: cuda and reference train steps differ by "
                        f"{diff}")
            del outs
            torch.cuda.empty_cache()
        toks, _ = tokens(1)
        outs = [_step_leaves(torch, dev, cfg, (4, 1), CompressedAggregation(
            method="diana", fraction=0.02, **extra), toks)
            for extra in ({"wire_levels": 127}, {"wire_dtype": "packed8"})]
        diff = max(float((a.float() - b.float()).abs().max())
                   for a, b in zip(*outs))
        same = all(torch.equal(a, b) for a, b in zip(*outs))
        print(f"train step diana {CUT_LAYERS} layers on the kernels, packed8 "
              f"vs f32 wire at 127 levels (tolerance: bitwise): equal={same} "
              f"max_abs_diff={diff}", flush=True)
        check(same, f"packed8 and the f32 wire at 127 levels differ by {diff}")
        del outs
        torch.cuda.empty_cache()
    finally:
        torch.use_deterministic_algorithms(False)


def phase_families(torch, dev, steps: int = 2, profile_steps: int = 0,
                   tp_steps: int = 1):
    """The model families at full width (see the module docstring), each
    with `steps` timed steps and `profile_steps` under the profiler after
    them (none in the whole run: the windows took two thirds of the
    phase); the families of FAMILY_TP with `tp_steps` timed steps and a
    one-step window on (4, 1), then the same on
    the trainer's (4, 2) mesh, the layers by shard on one process, each
    printed beside the other. Returns the path's launches."""
    from repro_torch.configs import get_config
    from repro_torch.core.dist import CompressedAggregation
    from repro_torch.kernels import LAUNCHES, reset_launches

    agg = CompressedAggregation(method="diana_rr", fraction=0.02, n_slots=2,
                                wire_dtype="packed8")
    reset_launches()
    for name, layers, seq, remat in FAMILY_RUNS:
        full = get_config(name)
        cfg = dataclasses.replace(full, num_layers=layers)
        if cfg.is_encdec:
            cfg = dataclasses.replace(cfg, encoder_layers=layers)
        print(f"family {name} ({cfg.family}): d_model={cfg.d_model} heads="
              f"{cfg.num_heads}/{cfg.num_kv_heads} d_ff={cfg.d_ff} vocab="
              f"{cfg.vocab} dtype={cfg.dtype}, {layers} of {full.num_layers}"
              f" layers{f' + {cfg.encoder_layers} encoder layers' if cfg.is_encdec else ''}"
              f", remat={remat}; {TRAIN_CLIENTS} clients x {TRAIN_BATCH} x "
              f"{seq} tokens", flush=True)
        if name not in FAMILY_TP:
            run_train(torch, dev, cfg, (TRAIN_CLIENTS, 1), agg, steps=steps,
                      seq=seq, remat=remat, profile_steps=profile_steps,
                      label=f"{name} diana_rr packed8 {layers} layers")
            torch.cuda.empty_cache()
            continue
        runs = {}
        for t in (1, 2):
            runs[t] = run_train(
                torch, dev, cfg, (TRAIN_CLIENTS, t), agg, steps=tp_steps,
                seq=seq, remat=remat, profile_steps=1,
                label=f"{name} diana_rr packed8 mesh (4, {t}) {layers} "
                      "layers")
            torch.cuda.empty_cache()

        def summary(r):
            p = r["profile"] or {}
            return (f"{r['s_step']:.4f} s/step, "
                    f"{p.get('device_ms', float('nan')):.2f} device ms and "
                    f"{p.get('kernels', float('nan')):.0f} kernels a step, "
                    f"idle {p.get('idle', float('nan')):.3f}, peak "
                    f"{r['peak'] / 2**30:.2f} GiB")

        print(f"family {name} by shard: (4, 2) {summary(runs[2])}; (4, 1) "
              f"{summary(runs[1])}", flush=True)
    launches = dict(LAUNCHES)
    print(f"families path launches: {launches}", flush=True)
    for name in WIRE_KERNELS + ("diana_shift_update",):
        check(launches[name] > 0, f"kernel {name} was not launched on the "
                                  "families path")
    return launches


def phase_families_cuda_vs_reference(torch, dev):
    """Each family at FAMILY_CUT layers: a packed8 DIANA-RR step on the
    kernels against the same step on the plain versions, bitwise (a
    digest of each state leaf, `_digest`, computed on the card: two
    full-width qwen2-moe states would not fit it together, and a host
    copy of one took most of the phase), on (4, 1) and, for the families
    of FAMILY_TP, on (4, 2) with the layers by shard. Every floating leaf
    must be finite on both backends; where digests differ, both steps run
    again and the differing leaves' max abs diff is printed."""
    from repro_torch.configs import get_config
    from repro_torch.core.dist import CompressedAggregation

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for name, _, seq, remat in FAMILY_RUNS:
            full = get_config(name)
            cut = {"num_layers": FAMILY_CUT}
            if full.is_encdec:
                cut["encoder_layers"] = FAMILY_CUT
            cfg = dataclasses.replace(full, **cut)
            rows, slots = _train_batches(cfg, 1, 2, 1, seq)[0]
            batch = _model_batch(torch, dev, cfg,
                                 torch.from_numpy(rows).to(dev), 0)
            for t in (1, 2) if name in FAMILY_TP else (1,):

                def leaves_of(backend):
                    return _step_leaves(
                        torch, dev, cfg, (TRAIN_CLIENTS, t),
                        CompressedAggregation(
                            method="diana_rr", fraction=0.02, n_slots=2,
                            wire_dtype="packed8", backend=backend),
                        batch, slots=slots, remat=remat)

                digests, bad = [], []
                for backend in ("cuda", "reference"):
                    leaves = leaves_of(backend)
                    # -0.0 and 0.0 compare equal, as torch.equal has them
                    digests.append([_digest(torch, x.masked_fill(x == 0, 0)
                                            if x.is_floating_point() else x)
                                    for x in leaves])
                    bad.append([i for i, x in enumerate(leaves)
                                if x.is_floating_point()
                                and not bool(torch.isfinite(x).all())])
                    del leaves
                    torch.cuda.empty_cache()
                differ = [i for i, (a, b) in enumerate(zip(*digests))
                          if a != b]
                same = not differ and len(digests[0]) == len(digests[1])
                diffs = {}
                if differ:
                    # both steps again, the cuda one's differing leaves
                    # waiting on the host, for the size of the difference
                    kept = leaves_of("cuda")
                    kept = {i: kept[i].cpu() for i in differ}
                    torch.cuda.empty_cache()
                    ref = leaves_of("reference")
                    diffs = {i: float((kept[i].to(dev).float()
                                       - ref[i].float()).abs().max())
                             if ref[i].numel() else 0.0 for i in differ}
                    del kept, ref
                    torch.cuda.empty_cache()
                print(f"family {name} train step diana_rr packed8 "
                      f"{FAMILY_CUT} layers mesh (4, {t}), cuda vs reference "
                      f"backend (tolerance: bitwise, {len(digests[0])} leaf "
                      f"digests): equal={same} non_finite_leaves={bad} "
                      f"max_abs_diff={diffs}", flush=True)
                check(not bad[0] and not bad[1],
                      f"{name} (4, {t}): non-finite leaves (cuda, reference) "
                      f"{bad}")
                check(same, f"{name} (4, {t}): cuda and reference train "
                            f"steps differ at leaves {differ} by {diffs}")
    finally:
        torch.use_deterministic_algorithms(False)


@contextlib.contextmanager
def _routes(torch, force=None):
    """While the block runs, each MoE routing call's own top-k experts of
    every token, sorted, (B, S, K), and its routing margin, the gap between
    the k-th and (k+1)-th probability, (B, S): one pair per call, in order.
    With `force`, one (B, S, K) sorted choice per call in the same order,
    a token whose own choice differs takes the forced experts instead,
    weighted by their probabilities renormalised, as `_route` weights its
    own."""
    from repro_torch.models import moe

    seen = []
    route = moe._route

    def recording(p, x, cfg):
        probs, top_w, top_e = route(p, x, cfg)
        top = torch.sort(probs, dim=-1, descending=True).values
        k = cfg.experts_per_token
        own = torch.sort(top_e, dim=-1).values
        if force is not None:
            want = force[len(seen)]
            differ = (own != want).any(-1, keepdim=True)
            w = torch.gather(probs, -1, want)
            w = w / torch.clamp(torch.sum(w, -1, keepdim=True), min=1e-9)
            top_e = torch.where(differ, want, top_e)
            top_w = torch.where(differ, w, top_w)
        seen.append((own, top[..., k - 1] - top[..., k]))
        return probs, top_w, top_e

    moe._route = recording
    try:
        yield seen
    finally:
        moe._route = route


def _cell_bytes(cache, mesh) -> int:
    """One (client, model shard) cell's bytes of a cache laid out by
    `launch.sharding.cache_specs` on `mesh`."""
    from repro_torch.core.api import tree_leaves
    from repro_torch.launch.mesh import model_size, num_clients
    from repro_torch.launch.sharding import cache_specs

    m, t = num_clients(mesh), model_size(mesh)
    specs = cache_specs(cache, mesh=mesh, n_clients=m)
    return sum(x.nbytes // (m if sp.batch else 1)
               // (t if sp.axis is not None else 1)
               for x, sp in zip(tree_leaves(cache), specs))


def serve_config(torch, dev, name: str, batch: int, text: int,
                 want_bytes: int, mesh_shape=None,
                 want_cell: int | None = None, tokens: int = SERVE_TIMED,
                 profiled: int = SERVE_PROFILE) -> None:
    """One configuration at full width and depth: seeded bf16 weights on the
    card, a prefill (cold, then timed warm), one warm-up decode token,
    `tokens` timed greedy tokens (host clock, synchronised on each
    token's logits) and a profiler window of SERVE_PROFILE tokens. With
    `mesh_shape`, on that (data, model) mesh by shard in this process: the
    cache is then also held to `want_cell` bytes a (client, shard) cell."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.core.api import tree_leaves
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models.transformer import init_params

    t_phase = time.perf_counter()
    cfg = get_config(name)
    prompt = cfg.vision_patches + text
    cache_len = prompt + SERVE_TOKENS + 8
    torch.cuda.reset_peak_memory_stats()
    params = init_params(0, cfg, dev)
    n_params = sum(t.numel() for t in tree_leaves(params))
    gen = torch.Generator(device=dev).manual_seed(1)
    rows = torch.randint(0, cfg.vocab, (batch, prompt), generator=gen,
                         device=dev)
    inputs = _model_batch(torch, dev, cfg, rows, 0)
    mesh = None if mesh_shape is None else make_mesh(mesh_shape)
    prefill = make_prefill_step(cfg, mesh, cache_len=cache_len)
    serve = make_serve_step(cfg, mesh, cache_len=cache_len)
    if mesh is not None:
        name = f"{name} on {mesh_shape} by shard"
    print(f"serve {name} ({cfg.family}): {cfg.num_layers} of "
          f"{cfg.num_layers} layers"
          f"{f' + {cfg.encoder_layers} encoder layers' if cfg.is_encdec else ''}"
          f", d_model={cfg.d_model}, {n_params} params "
          f"({n_params * 2 / 1e9:.2f} GB bf16); batch {batch} x prompt "
          f"{prompt}{f' ({cfg.vision_patches} patches + {text})' if cfg.vision_patches else ''}"
          f", cache_len {cache_len}", flush=True)
    prefill_ms = []
    for _ in range(2):  # cold, then warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill(params, inputs)
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t0) * 1e3)
    cache_bytes = sum(t.nbytes for t in tree_leaves(cache))
    check(bool(torch.isfinite(logits[..., :cfg.vocab]).all()),
          f"{name}: the prefill's logits are not finite")
    check(cache_bytes == want_bytes,
          f"{name}: the cache holds {cache_bytes} bytes, not {want_bytes}")
    if mesh is not None:
        cell = _cell_bytes(cache, mesh)
        print(f"serve {name}: a (client, shard) cell's cache slice "
              f"{cell} bytes (expected {want_cell}); cache axes "
              f"{serve.shards.cache_axes}", flush=True)
        check(cell == want_cell, f"{name}: a cell holds {cell} bytes of the "
                                 f"cache, not {want_cell}")
    pos = prompt

    def next_token(logits):
        return torch.argmax(logits[:, -1, :cfg.vocab], dim=-1, keepdim=True)

    tok = next_token(logits)
    logits, out = serve(params, cache, tok, pos)  # the warm-up token
    check(out is cache, f"{name}: the serve step did not return its cache")
    tok = next_token(logits)
    torch.cuda.synchronize()
    times = []
    for _ in range(tokens):
        pos += 1
        t0 = time.perf_counter()
        logits, cache = serve(params, cache, tok, pos)
        tok = next_token(logits)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    check(bool(torch.isfinite(logits[..., :cfg.vocab]).all()),
          f"{name}: a decode step's logits are not finite")
    ms = statistics.mean(times) * 1e3
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(profiled):
            pos += 1
            logits, cache = serve(params, cache, tok, pos)
            tok = next_token(logits)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    check(pos < cache_len, f"{name}: decoded past cache_len")
    rows_ = _device_rows(torch, prof)
    busy, kernels = _device_us(torch, rows_, None)
    peak = torch.cuda.max_memory_allocated()
    print(f"serve {name}: prefill {prefill_ms[1]:.2f} ms (cold "
          f"{prefill_ms[0]:.2f}); decode {ms:.3f} ms/token (median "
          f"{statistics.median(times) * 1e3:.3f}, min {min(times) * 1e3:.3f},"
          f" max {max(times) * 1e3:.3f}), {batch / (ms / 1e3):.1f} tokens/s; "
          f"cache {cache_bytes} bytes (expected {want_bytes}); "
          f"max_memory_allocated={peak} ({peak / 2**30:.2f} GiB)", flush=True)
    if busy is None:
        print(f"profile serve {name}: device time not measured (the profiler"
              " saw no kernels)", flush=True)
    else:
        n = profiled
        print(f"profile serve {name} ({n} tokens, profiler on): "
              f"{wall_us / n / 1e3:.3f} ms/token wall, {busy / n / 1e3:.3f} "
              f"ms/token device busy ({kernels / n:.1f} kernels/token), "
              f"device idle share {1 - busy / wall_us:.3f}", flush=True)
        for r in rows_[:6]:
            print(f"  {r.self_device_time_total / n / 1e3:9.3f} ms/token "
                  f"{r.count / n:7.1f}/token  {r.key[:90]}", flush=True)
    print(f"serve {name}: wall {time.perf_counter() - t_phase:.1f} s",
          flush=True)


def serve_teacher_forced(torch, dev, name: str,
                         mesh_shape=SERVE_MESH) -> None:
    """A SERVE_CUT-layer copy of the config at full width (whisper: as many
    encoder layers too) through the serve steps on `mesh_shape` (by shard;
    whole layers at (1, 1)): prefill the patches and half the text, decode
    the rest teacher-forced, and hold every row's logits at every position to
    the port's own forward within the reference's bound 0.1 + 0.05
    |forward logit| (its test_prefill_decode_matches_forward). For MoE the
    forward takes the served pass's experts wherever its own differ (a
    near-tie that the bf16 residual tips: the decode rounds q and k to
    bf16, the forward does not), so every (row, position) is held to the
    bound; the flips are printed with their routing margins and stay
    within the reference's allowance of a quarter of the pairs."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models.transformer import forward, init_params

    full = get_config(name)
    cut = {"num_layers": SERVE_CUT}
    if full.is_encdec:
        cut["encoder_layers"] = SERVE_CUT
    cfg = dataclasses.replace(full, **cut)
    params = init_params(0, cfg, dev)
    p = cfg.vision_patches
    s, half = p + SERVE_TEXT, p + SERVE_TEXT // 2
    gen = torch.Generator(device=dev).manual_seed(2)
    rows = torch.randint(0, cfg.vocab, (SERVE_TF_ROWS, s), generator=gen,
                         device=dev)
    inputs = _model_batch(torch, dev, cfg, rows, 1)
    v = cfg.vocab
    mesh = make_mesh(mesh_shape)
    clients = mesh_shape[0]

    def by_layer(seen):
        """The step's routing calls, client by client, as one call a layer
        over every request (the forward's order)."""
        n = len(seen) // clients
        return [tuple(torch.cat([seen[c * n + j][k] for c in range(clients)])
                      for k in range(2)) for j in range(n)]

    with torch.inference_mode():
        with _routes(torch) as seen:
            logits, cache = make_prefill_step(cfg, mesh, cache_len=s + 4)(
                params, {**inputs, "tokens": rows[:, :half]})
            calls = [by_layer(seen)]
            got = [logits[:, 0, :v].float()]
            serve = make_serve_step(cfg, mesh, cache_len=s + 4)
            for i in range(half, s):
                seen.clear()
                logits, cache = serve(params, cache, rows[:, i:i + 1], i)
                calls.append(by_layer(seen))
                got.append(logits[:, 0, :v].float())
        served = [torch.cat([c[j][0] for c in calls], dim=1)
                  for j in range(len(calls[0]))]
        margins = [torch.cat([c[j][1] for c in calls], dim=1)
                   for j in range(len(calls[0]))]
        with _routes(torch, force=served or None) as fwd:
            want = forward(params, {**inputs,
                                    "tokens": torch.nn.functional.pad(
                                        rows, (0, 1))},
                           cfg, remat=False)[:, half - 1:, :v].float()
    got = torch.stack(got, dim=1)
    check(got.shape == want.shape, f"{name}: {got.shape} != {want.shape}")
    ratio = ((got - want).abs() / (0.1 + 0.05 * want.abs())).amax(-1)
    bad = torch.nonzero(ratio > 1.0).tolist()
    check(not bad, f"{name}: decode is off the forward logits by "
                   f"{float(ratio.max()):.3f} of the bound at (row, "
                   f"position) {[(b, i + half - 1) for b, i in bad]}")
    flipped = []
    if served:
        differ = torch.stack([(e != f).any(-1) for e, (f, _) in
                              zip(served, fwd)]).any(0)
        margin = torch.stack([torch.minimum(m, fm) for m, (_, fm) in
                              zip(margins, fwd)]).amin(0)
        flipped = [(i, b, f"{float(margin[b, i]):.1e}")
                   for b, i in torch.nonzero(differ).tolist()]
    n = ratio.numel()
    how = (f"on {mesh_shape} by shard" if mesh_shape[1] > 1
           else "whole layers")
    print(f"serve {name} teacher-forced ({SERVE_CUT} layers, full width, "
          f"{SERVE_TF_ROWS} requests {how}): "
          f"{n} of {n} (row, position) pairs within 0.1 + 0.05|forward| "
          f"(worst {float(ratio.max()):.3f} of the bound)"
          + (f"; the forward took the served experts at (position, row, "
             f"routing margin) {flipped}" if cfg.num_experts else ""),
          flush=True)
    check(len(flipped) <= n // 4,
          f"{name}: experts flip at {len(flipped)} of {n} pairs")


def phase_serving(torch, dev):
    """Serving at full width and depth for each of SERVE_RUNS, each with its
    teacher-forced check; the model is freed before the next one. The
    serving path launches none of the eight kernels (it has no TPU kernel
    in the reference either): every count must stay 0."""
    import gc

    from repro_torch.kernels import LAUNCHES, reset_launches

    reset_launches()
    for name, batch, text, want_bytes in SERVE_RUNS:
        serve_config(torch, dev, name, batch, text, want_bytes)
        gc.collect()
        torch.cuda.empty_cache()
        if name == SERVE_TP_RUN[0]:
            serve_config(torch, dev, *SERVE_TP_RUN[:4], SERVE_MESH,
                         SERVE_TP_RUN[4], SERVE_TP_TOKENS, SERVE_TP_PROFILE)
            gc.collect()
            torch.cuda.empty_cache()
            # the timed runs' whole layers, held to the forward at full
            # width too
            serve_teacher_forced(torch, dev, name, (1, 1))
        serve_teacher_forced(torch, dev, name)
        gc.collect()
        torch.cuda.empty_cache()
    print(f"serving path launches: {dict(LAUNCHES)}", flush=True)
    check(not any(LAUNCHES.values()),
          f"the serving path launched a wire kernel: {dict(LAUNCHES)}")


@contextlib.contextmanager
def _step_clock():
    """While the block runs, the host clock after each of the trainer's
    reports (with --log-every 1 each report reads the step's loss, which
    waits for the step): [seconds]."""
    from repro_torch.telemetry import sink

    marks = []
    report = sink.ConsoleReporter.report

    def timed(self, *args, **kwargs):
        report(self, *args, **kwargs)
        marks.append(time.perf_counter())

    sink.ConsoleReporter.report = timed
    try:
        yield marks
    finally:
        sink.ConsoleReporter.report = report


def _trainer_run(torch, cfg, argv, label: str):
    """One `train.main` run of phase 12 at `cfg` with TRAINER_ARGV + argv;
    prints s/step (after the first step; host clock, synchronised by the
    loss), the peak device memory and the kernels' launches; returns (the
    final state, its numbers)."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import train

    reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with _step_clock() as marks:
        state = train.main(list(TRAINER_ARGV) + argv, cfg=cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    gaps = [b - a for a, b in zip(marks, marks[1:])]
    info = {"s_step": statistics.mean(gaps) if gaps else float("nan"),
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "launches": launches, "wall": wall}
    print(f"trainer {label}: s/step={info['s_step']:.4f} (steps after the "
          f"first: {[round(g, 4) for g in gaps]}) peak "
          f"{info['peak_gib']:.2f} GiB wall {wall:.1f} s launches "
          f"{launches}", flush=True)
    for name in WIRE_KERNELS + ("diana_shift_update",):
        check(launches[name] > 0, f"trainer {label}: {name} was not "
                                  "launched")
    return state, info


def _same_state(torch, a, b) -> tuple[bool, float]:
    """(bitwise equal, max |a - b|) over every leaf of two TrainStates."""
    from repro_torch.core.api import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    same, diff = len(la) == len(lb), 0.0
    for x, y in zip(la, lb):
        if x.shape != y.shape:
            return False, float("inf")
        if not torch.equal(x, y):
            same = False
            diff = max(diff, float((x.float() - y.float()).abs().max()))
    return same, diff


def _span_seconds(path: str, name: str) -> list[float]:
    from repro_torch.telemetry import read_events

    return [ev["dur"] for ev in read_events(path)
            if ev.get("kind") == "span" and ev.get("name") == name]


def _runtime_counts(prof) -> dict:
    """From the profiler's CUDA runtime and device events: the
    device-to-host copies the device ran, and each host thread's
    synchronise calls and kernel launches."""
    per = collections.defaultdict(collections.Counter)
    d2h = 0
    for e in prof.events():
        name = e.name
        if "DtoH" in name or "Device -> P" in name:
            d2h += 1
        if name.startswith(("cudaLaunchKernel", "cuLaunchKernel")):
            per[e.thread]["launches"] += 1
        elif name in ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                      "cudaEventSynchronize"):
            per[e.thread]["syncs"] += 1
    return {"d2h_copies": d2h,
            "syncs": sum(c["syncs"] for c in per.values()),
            "threads": {t: dict(c) for t, c in sorted(per.items())}}


def phase_trainer(torch, dev):
    """The production trainer (see the module docstring); returns its
    kernels' launches over the phase."""
    import shutil
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.fleet import AsyncPlanner, ChaosConfig, CohortSampler
    from repro_torch.telemetry import __main__ as telemetry_cli
    from repro_torch.telemetry import read_events

    cfg = dataclasses.replace(get_config("stablelm-1.6b"),
                              num_layers=TRAINER_LAYERS)
    print(f"trainer: {cfg.name} d_model={cfg.d_model} d_ff={cfg.d_ff} vocab="
          f"{cfg.vocab} {cfg.num_layers} of 24 layers, flags "
          f"{' '.join(TRAINER_ARGV)}; card {card_line()}", flush=True)
    tmp = Path(tempfile.mkdtemp(prefix="chip-smoke-trainer-"))
    total = collections.Counter()
    try:
        n = str(TRAINER_STEPS)
        # (a) telemetry and trace on, prefetch on
        tel, trace = str(tmp / "a.telemetry.jsonl"), str(tmp / "a.trace.json")
        ref, a = _trainer_run(torch, cfg, ["--steps", n, "--telemetry", tel,
                                           "--trace", trace], "(a) telemetry")
        total.update(a["launches"])
        rc = telemetry_cli.main([tel, "--validate", "--summary",
                                 "--to-trace", str(tmp / "a.cli.json")])
        check(rc == 0, f"(a): the telemetry CLI exited {rc}")
        # (a0) telemetry off, prefetch on; (b) telemetry off, prefetch off
        for label, argv in (("(a0) telemetry off", []),
                            ("(b) telemetry off, prefetch off",
                             ["--no-prefetch"])):
            state, info = _trainer_run(torch, cfg, ["--steps", n] + argv,
                                       label)
            total.update(info["launches"])
            same, diff = _same_state(torch, state, ref)
            print(f"trainer {label} == (a) (tolerance: bitwise): {same} "
                  f"max_abs_diff={diff}", flush=True)
            check(same, f"trainer {label} differs from (a) by {diff}")
            del state
        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        counts = {}
        for label, argv in (("on", ["--telemetry",
                                    str(tmp / "p.telemetry.jsonl")]),
                            ("off", [])):
            with profile(activities=acts) as prof:
                state, info = _trainer_run(
                    torch, cfg, ["--steps", "3", "--no-prefetch"] + argv,
                    f"(b) profiled, telemetry {label}")
            del state
            counts[label] = _runtime_counts(prof)
            del prof
            print(f"trainer (b) profiler, telemetry {label}: {counts[label]}",
                  flush=True)
        # the sink's writer thread polls its events and copies nothing, so
        # every thread's counts agree. Compared over all threads: this
        # profiler has attributed the writer thread's synchronise calls to
        # the dispatch thread's id
        for k in ("d2h_copies", "syncs", "threads"):
            check(counts["on"][k] == counts["off"][k],
                  f"(b): {k} differ with telemetry on ({counts['on'][k]}) "
                  f"and off ({counts['off'][k]})")
        # (c) a step short of TRAINER_STEPS, a checkpoint, then --resume
        # to TRAINER_STEPS
        ckpt, tel = str(tmp / "c.ckpt"), str(tmp / "c.telemetry.jsonl")
        short = str(TRAINER_STEPS - 1)
        _, info = _trainer_run(torch, cfg, ["--steps", short, "--checkpoint",
                                            ckpt, "--telemetry", tel],
                               f"(c) {short} steps + checkpoint")
        save_s = _span_seconds(tel, "checkpoint")
        nbytes = os.path.getsize(ckpt)
        state, info = _trainer_run(torch, cfg, ["--steps", n, "--resume",
                                                ckpt, "--telemetry", tel],
                                   f"(c) --resume to step {n}")
        load_s = _span_seconds(tel, "checkpoint")
        same, diff = _same_state(torch, state, ref)
        print(f"trainer (c) checkpoint {nbytes} bytes ({nbytes / 1e9:.2f} "
              f"GB), save {save_s[0]:.2f} s, load {load_s[0]:.2f} s; resumed"
              f" == (a) (tolerance: bitwise): {same} max_abs_diff={diff}",
              flush=True)
        check(same, f"trainer (c): the resumed run differs from (a) by {diff}")
        del state
        os.unlink(ckpt)
        # (d) the fleet at --clients 4 (cohort == population)
        tel = str(tmp / "d.telemetry.jsonl")
        state, info = _trainer_run(torch, cfg, ["--steps", n, "--clients",
                                                "4", "--telemetry", tel],
                                   "(d) fleet --clients 4")
        total.update(info["launches"])
        same, diff = _same_state(torch, state, ref)
        gather, scatter = _span_seconds(tel, "gather"), _span_seconds(
            tel, "scatter")
        print(f"trainer (d) gather {statistics.mean(gather):.3f} s/round "
              f"({[round(x, 3) for x in gather]}), scatter "
              f"{statistics.mean(scatter):.3f} s/round "
              f"({[round(x, 3) for x in scatter]}); == (a) (tolerance: "
              f"bitwise): {same} max_abs_diff={diff}", flush=True)
        check(same, f"trainer (d): the fleet at cohort == population differs "
                    f"from (a) by {diff}")
        del state, ref
        torch.cuda.empty_cache()
        # (e) the buffered-async fleet under chaos, paged data,
        # TRAINER_STEPS rounds
        tel = str(tmp / "e.telemetry.jsonl")
        chaos = {"dropout": 0.2, "straggler": 0.3, "store_fail": 0.2}
        state, info = _trainer_run(torch, cfg, [
            "--steps", n, *ASYNC_ARGV, "--data-store", str(tmp / "data"),
            "--telemetry", tel], "(e) async fleet under chaos")
        total.update(info["launches"])
        if TRAINER_STEPS == PROC_STEPS:  # phase 13 (m)'s one-process run
            ASYNC_ONE_PROCESS["digests"] = _rank_digests(
                torch, cfg, state, 8, ["--steps", n, *ASYNC_ARGV])
        del state
        _drop_pinned(torch)
        events = read_events(tel)
        got = [{k: ev["metrics"][k] for k in ("completed", "on_time",
                                              "dropped")}
               for ev in events if ev.get("kind") == "round_metrics"]
        planner = AsyncPlanner(TRAIN_CLIENTS, buffer_k=3, late="drop",
                               chaos=ChaosConfig(**chaos))
        cohorts = CohortSampler(8, TRAIN_CLIENTS, seed=2)
        want = []
        for t in range(TRAINER_STEPS):
            plan = planner(t, cohorts.cohort_for_round(t))
            want.append({"completed": int(plan.completes.sum()),
                         "on_time": int(plan.on_time.sum()),
                         "dropped": int(plan.on_time.size
                                        - plan.reported.sum())})
        gather, scatter = _span_seconds(tel, "gather"), _span_seconds(
            tel, "scatter")
        retries = sum(1 for ev in events if ev.get("name")
                      == "fleet.store_retry")
        print(f"trainer (e) participation {got} (planner replay {want}); "
              f"store retries {retries}; gather "
              f"{statistics.mean(gather):.3f} s/round, scatter "
              f"{statistics.mean(scatter):.3f} s/round", flush=True)
        check(got == want, f"trainer (e): counters {got} != the planner's "
                           f"replay {want}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"trainer launches (runs a, a0, b, d, e): {dict(total)}",
          flush=True)
    return dict(total)


# -- phase 13: the trainer's client ranks spread over processes --------------

def _digest(torch, x) -> int:
    """A leaf's bits as one integer: its elements' bit patterns (as
    integers of the element's width) weighted by a hash of their flat
    index, summed in int64 (wrapping), chunk by chunk on the leaf's
    device: two leaves with a different element give different digests
    but for a 2^-64 chance. Computed where the leaf lives, so a 29 GB
    state is never moved to the host to be compared."""
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    flat = x.contiguous().view(-1).view(ints[x.element_size()])
    total = torch.zeros((), dtype=torch.int64, device=x.device)
    chunk = 1 << 24
    for lo in range(0, flat.numel(), chunk):
        part = flat[lo:lo + chunk].to(torch.int64)
        idx = torch.arange(lo, lo + part.numel(), dtype=torch.int64,
                           device=x.device)
        weight = (idx * 2654435761 + 97) % 4294967291 + 1
        total += torch.sum(part * weight)
    return int(total)


def _proc_child(rank, world, backend, jobs, out, done):
    """One process of spread trainer runs, started as torchrun starts it
    (its environment, a store the parent hosts for each run): for each
    job (the run's store port, argv, arch, cut, digests) in turn,
    `train.main` at `arch` cut in depth by `cut` (the config's fields to
    replace; by default TRAINER_LAYERS layers) with phase 12's flags and
    `argv`, its output captured; hands the parent its state's leaves on
    the card (CUDA IPC) and its numbers, then waits until the parent has
    compared them (`done`, an event a job), or with `digests` only each
    leaf's digest (`_digest`), and goes on to the next job."""
    import io

    os.environ.update({
        "RANK": str(rank), "WORLD_SIZE": str(world), "LOCAL_RANK": str(rank),
        "MASTER_ADDR": "localhost", "TORCHELASTIC_USE_AGENT_STORE": "True"})
    try:
        import torch

        from repro_torch.configs import get_config
        from repro_torch.core.api import tree_leaves
        from repro_torch.launch import train

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        for i, (port, argv, arch, cut, digests) in enumerate(jobs):
            os.environ["MASTER_PORT"] = str(port)
            cfg = dataclasses.replace(get_config(arch), **(
                cut if cut is not None else {"num_layers": TRAINER_LAYERS}))
            text = io.StringIO()
            with contextlib.redirect_stdout(text), _step_clock() as marks, \
                    _stash_meter(torch) as stash:
                from repro_torch.kernels import LAUNCHES, reset_launches

                reset_launches()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                state = train.main(list(TRAINER_ARGV) + argv
                                   + ["--dist-backend", backend], cfg=cfg)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            wire = [json.loads(line[len("wire: "):])
                    for line in text.getvalue().splitlines()
                    if line.startswith("wire: ")]
            gaps = [b - a for a, b in zip(marks, marks[1:])]
            info = {"s_step": statistics.mean(gaps) if gaps else None,
                    "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                    "launches": dict(LAUNCHES), "wall": wall,
                    "bytes_sent": wire[0]["bytes_sent"] if wire else None,
                    "stash": stash}
            if digests:
                info["digests"] = [_digest(torch, x)
                                   for x in tree_leaves(state)]
                del state
                out.put((rank, i, info, None))
            else:  # the leaves stay alive until the parent has read them
                out.put((rank, i, info, tree_leaves(state)))
                done[i].wait(300)
                del state
            _drop_pinned(torch)
        done[-1].wait(300)
    except BaseException:
        import traceback

        out.put((rank, None, traceback.format_exc(), None))
        raise


@contextlib.contextmanager
def _stash_meter(torch):
    """While the block runs, what the remat stash keeps: the calls of
    `transformer._stashed` (a decoder block's or the final norm's forward
    that keeps only its rows of its input's sequence), and the bytes
    autograd's saved-tensor hooks see saved over the first one: one
    block's stash, {"calls", "block" (each saved tensor's bytes)}."""
    from repro_torch.models import transformer

    seen = {"calls": 0, "block": None}
    stashed = transformer._stashed

    def metered(body, bp, x, ms):
        seen["calls"] += 1
        if seen["block"] is not None:
            return stashed(body, bp, x, ms)
        sizes = []
        with torch.autograd.graph.saved_tensors_hooks(
                lambda t: sizes.append(t.numel() * t.element_size()) or t,
                lambda t: t):
            y = stashed(body, bp, x, ms)
        seen["block"] = sizes
        return y

    transformer._stashed = metered
    try:
        yield seen
    finally:
        transformer._stashed = stashed


def _host_peak_gib() -> float:
    """This script's peak resident host memory, GiB (Linux reports
    ru_maxrss in KiB). Not for a spawned process: its count starts from
    the pages of the parent it was forked from."""
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def _expected_bytes(agg, params, lay, local_steps: int, steps: int,
                    cfg=None, rows: int = 0, seq: int = 0) -> dict:
    """The bytes a process of layout `lay` sends in `steps` train steps:
    each level's per-rank message for every rank (inner level, each local
    step) or pod (outer level) it speaks for, each split leaf's once for
    each model shard the process holds (`wire_bytes_per_round` of the
    shard's shape), each replicated leaf's once; and, where the model axis
    spreads over processes, to its model group what each forward and
    backward of `cfg` over `rows` sequences of `seq` tokens a client sends
    (`launch.sharding.model_bytes`)."""
    import torch

    from repro_torch.core.api import tree_leaves
    from repro_torch.launch.sharding import model_bytes

    shards = lay.local_shards.stop - lay.local_shards.start
    axes = agg.model_axes or (None,) * len(tree_leaves(params))
    wire = collections.Counter()
    for x, ax in zip(tree_leaves(params), axes):
        n, shape = 1, list(x.shape)
        if ax is not None and agg.model_size > 1:
            n, shape[ax] = shards, shape[ax] // agg.model_size
        wire.update({k: n * v for k, v in agg.wire_bytes_per_round(
            [torch.empty(shape, dtype=x.dtype, device="meta")]).items()})
    out = {}
    if agg.client_axes:
        out["intra_pod"] = steps * local_steps * lay.local * wire[
            "intra_pod"]
    if agg.pod_axes and agg.pod_size > 1:
        pods = len(range(agg.num_pods())[lay.local_pods])
        out["inter_pod"] = steps * pods * wire["inter_pod"]
    if lay.model_procs > 1:
        out["model"] = (steps * local_steps * lay.local
                        * model_bytes(cfg, rows, seq, agg.model_size,
                                      shards))
    return out


def _spread_run(torch, cfg, label, backend, world, argv, ref=None,
                timeout=240.0, digests=False):
    """`_spread_runs` of one run: its process's numbers, by rank."""
    return _spread_runs(torch, backend, world, [
        {"cfg": cfg, "label": label, "argv": argv, "ref": ref,
         "digests": digests}], timeout)[0]


def _spread_runs(torch, backend, world, runs, timeout=240.0):
    """Each run of `runs` (`cfg`: its name's config cut in depth, `label`,
    `argv`, `ref`, `digests`): `train.main` at `cfg` with TRAINER_ARGV +
    argv spread over `world` processes on the one card over `backend`,
    the runs in turn in one start of the processes (each its own store).
    Each process's state must equal `ref` (a stacked run's state; its own
    rows of the per-rank and per-pod tables and its own model shards of
    the split leaves), bitwise, and each must launch the five wire
    kernels and diana_shift_update and send the bytes the wire's
    accounting implies (a --resume run's steps: those after the
    checkpoint). A failed or silent process fails the phase. With
    `digests` the processes hand over their leaves' digests only
    (compared by the caller). Returns, for each run, each process's
    numbers, by rank, with its layout ("layout")."""
    import torch.distributed as dist

    from repro_torch.configs import get_config

    stores = [dist.TCPStore("localhost", 0, world, is_master=True,
                            wait_for_workers=False) for _ in runs]
    jobs = []
    for run, store in zip(runs, stores):
        cfg = run["cfg"]
        full = get_config(cfg.name)
        cut = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
               if getattr(cfg, f.name) != getattr(full, f.name)}
        jobs.append((store.port, run["argv"], cfg.name, cut,
                     run.get("digests", False)))
    ctx = torch.multiprocessing.get_context("spawn")
    out = ctx.Queue()
    done = [ctx.Event() for _ in runs]
    # a process's CUDA tensors cross to this one by IPC, which expandable
    # segments do not allow on this machine's kernel
    conf = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:False"
    procs = [ctx.Process(target=_proc_child, args=(
        r, world, backend, jobs, out, done)) for r in range(world)]
    try:
        for p in procs:
            p.start()
    finally:
        if conf is None:
            os.environ.pop("PYTORCH_CUDA_ALLOC_CONF")
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = conf
    results, early = [], []
    try:
        for i, run in enumerate(runs):
            results.append(_spread_check(
                torch, run, backend, world, out, early, i, timeout))
            done[i].set()  # the processes let go of this run's tensors
        return results
    finally:
        early.clear()
        for event in done:
            event.set()
        for p in procs:
            p.join(60)
            if p.is_alive():
                p.terminate()
                p.join(10)
        bad = {r: p.exitcode for r, p in enumerate(procs) if p.exitcode != 0}
        if bad and sys.exc_info()[0] is None:
            raise SmokeFailure(f"{runs[0]['label']}: processes exited {bad}")
        del stores


def _spread_check(torch, run, backend, world, out, early, i, timeout):
    """Run i of `_spread_runs`: its processes' results (from `out`, or
    kept in `early` where they came with another run's) checked."""
    from repro_torch.checkpoint import load_meta
    from repro_torch.core.dist import CompressedAggregation
    from repro_torch.launch import distributed, steps, train
    from repro_torch.launch.mesh import num_clients
    from repro_torch.launch.sharding import leaf_model_axes, leaf_units
    from repro_torch.models import transformer

    cfg, label, argv, ref = run["cfg"], run["label"], run["argv"], run.get(
        "ref")
    args = train.build_parser().parse_args(list(TRAINER_ARGV) + argv)
    mesh = train.train_mesh(args)
    m = num_clients(mesh)
    rows = max(1, args.batch // m)
    whole = transformer.init_params(0, cfg, "meta")
    agg = steps.configure_agg(CompressedAggregation(
        method=args.agg, fraction=args.fraction, wire_dtype=args.wire_dtype,
        n_slots=8 if args.agg == "diana_rr" else 1,
        shift_dtype=torch.float32), mesh, args.local_steps, params=whole)
    abstract = steps.init_train_state(0, cfg, agg, m, mesh=mesh,
                                      local_steps=args.local_steps,
                                      device="meta")
    units = leaf_units(abstract, agg)
    axes = leaf_model_axes(abstract, agg)
    n_steps = int(args.steps)
    if args.resume:
        n_steps -= load_meta(args.resume)["step"]
    rounds = _fleet_rounds(args) if args.clients else None
    if rounds is not None:  # the rounds whose step ran (someone completed)
        n_steps = sum(1 for _, done in rounds if done is None or done.any())
    got = {rank: (info, leaves) for rank, j, info, leaves in early
           if j == i}
    early[:] = [e for e in early if e[1] != i]
    deadline = time.perf_counter() + timeout
    try:
        while len(got) < world:
            try:
                rank, j, info, leaves = out.get(
                    timeout=max(1.0, deadline - time.perf_counter()))
            except queue.Empty:
                raise SmokeFailure(f"{label}: {world - len(got)} process(es) "
                                   f"gave no result in {timeout:.0f} s")
            check(not isinstance(info, str),
                  f"{label}: process {rank} failed:\n{info}")
            if j != i:
                early.append((rank, j, info, leaves))
                continue
            got[rank] = (info, leaves)
            del leaves
        for rank in sorted(got):
            info = got[rank][0]
            lay = distributed.RankLayout(world, rank, m, agg.num_pods(),
                                         agg.model_size)
            info["layout"] = lay
            if ref is not None:
                same, diff = _same_rows(torch, got[rank][1], ref, units,
                                        axes, lay)
                print(f"processes {label} process {rank} == stacked "
                      f"(tolerance: bitwise): {same} max_abs_diff={diff}",
                      flush=True)
                check(same, f"{label}: process {rank} differs from the "
                            f"stacked run by {diff}")
            for name in WIRE_KERNELS + ("diana_shift_update",):
                check(info["launches"][name] > 0,
                      f"{label}: process {rank} did not launch {name}")
            want_bytes = _expected_bytes(agg, whole, lay, args.local_steps,
                                         n_steps, cfg, rows, args.seq)
            if rounds is not None:  # a counter that never moved is absent
                fleet = _fleet_expect(agg, whole, lay, rounds)
                if fleet:
                    want_bytes["fleet"] = fleet
            check(info["bytes_sent"] == want_bytes,
                  f"{label}: process {rank} sent {info['bytes_sent']}, the "
                  f"wire's accounting says {want_bytes}")
            if run.get("stash"):
                _stash_check(info["stash"], cfg, lay, agg, n_steps, rows,
                             args, label, rank)
            per_step = {k: v // n_steps for k, v in info["bytes_sent"].items()}
            s_step = ("not reported" if info["s_step"] is None
                      else f"{info['s_step']:.4f}")
            formula = ("" if "model" not in want_bytes else
                       f" (model group: {want_bytes['model'] // n_steps} B a "
                       "step by `model_bytes`)")
            print(f"processes {label} process {rank}: s/step={s_step} peak "
                  f"{info['peak_gib']:.2f} GiB wall {info['wall']:.1f} s "
                  f"bytes sent per step {per_step}{formula} launches "
                  f"{info['launches']}", flush=True)
        return {rank: got[rank][0] for rank in sorted(got)}
    finally:
        got.clear()  # this process lets go of the run's tensors


def _fleet_rounds(args) -> list:
    """A fleet run's rounds as its processes walk them: (the cohort, the
    completers' mask or None for a synchronous round), from the round
    its --resume file reached (the cohort walk's and the planner's
    closed forms)."""
    from repro_torch.checkpoint import load_meta
    from repro_torch.fleet import AsyncPlanner, CohortSampler
    from repro_torch.launch import train

    start = 0
    if args.resume:
        start = load_meta(args.resume)["meta"]["fleet"]["round"]
    cohorts = CohortSampler(args.clients, TRAIN_CLIENTS,
                            mode=args.cohort_mode, seed=2)
    planner = (AsyncPlanner(TRAIN_CLIENTS, buffer_k=args.buffer_k,
                            late=args.late, discount=args.discount,
                            chaos=train.chaos_from_args(args))
               if train.fleet_is_async(args) else None)
    out = []
    for t in range(start, int(args.steps)):
        cohort = cohorts.cohort_for_round(t)
        out.append((cohort, None if planner is None
                    else planner(t, cohort).completes))
    return out


def _fleet_expect(agg, params, lay, rounds) -> int:
    """What a process of layout `lay` sends at the "fleet" level over a
    fleet run's `rounds` (`launch.sharding.fleet_bytes`): one client's
    row on it is its model shards' slice of every parameter leaf's f32
    shift (its slots'), the population's rows owned c mod P."""
    from repro_torch.core.api import tree_leaves
    from repro_torch.launch.sharding import fleet_bytes

    shards = lay.local_shards.stop - lay.local_shards.start
    axes = agg.model_axes or (None,) * len(tree_leaves(params))
    slots = agg.n_slots if agg.rule.slotted else 1
    row = 0
    for x, ax in zip(tree_leaves(params), axes):
        n = x.numel()
        if ax is not None and lay.model_procs > 1:
            n = n // agg.model_size * shards
        row += n * slots * 4
    return sum(fleet_bytes(row, cohort, lay, done=done)
               for cohort, done in rounds)


def _stash_check(stash, cfg, lay, agg, n_steps, rows, args, label, rank):
    """A process's stash (`_stash_meter`): the hooks saw one tensor over
    one block, its rows of the block's input; the blocks and the final
    norm of each client's forward each kept one (L + 1 a forward), and
    L + 1 of them are `launch.train.stash_bytes`, the `activation_bytes`
    term, exactly."""
    from repro_torch.launch.train import stash_bytes

    shards = lay.local_shards
    n = shards.stop - shards.start
    want = stash_bytes(cfg, rows, args.seq, agg.model_size, n,
                       start=shards.start)
    whole = stash_bytes(cfg, rows, args.seq, agg.model_size, n,
                        seq_shard=False)
    block = stash["block"] or []
    calls = n_steps * lay.local * args.local_steps * (cfg.num_layers + 1)
    print(f"processes {label} process {rank} stash: one block's saved "
          f"tensors {block} B (saved-tensor hooks), {stash['calls']} blocks "
          f"and final norms kept; (L + 1) x {block[:1]} = "
          f"{(cfg.num_layers + 1) * sum(block)} B a client's forward, "
          f"`stash_bytes` {want} B (whole: {whole} B)", flush=True)
    check(len(block) == 1 and (cfg.num_layers + 1) * block[0] == want,
          f"{label}: process {rank}'s stash {block} x {cfg.num_layers + 1} "
          f"is not `stash_bytes` {want}")
    check(stash["calls"] == calls,
          f"{label}: process {rank} kept {stash['calls']} stashes, "
          f"expected {calls}")


def _same_rows(torch, leaves, ref, units, axes, lay) -> tuple[bool, float]:
    """(bitwise equal, max |diff|): a process's state leaves against the
    stacked state's, its own rows of the per-rank and per-pod tables and
    its own model shards of the split leaves."""
    same, diff = len(leaves) == len(ref), 0.0
    for x, w, unit, ax in zip(leaves, ref, units, axes):
        if unit is not None:
            w = w[lay.local_ranks if unit == "rank" else lay.local_pods]
        if ax is not None and lay.model_procs > 1:
            n = w.shape[ax] // lay.model
            w = w.narrow(ax, lay.local_shards.start * n,
                         (lay.local_shards.stop - lay.local_shards.start) * n)
        w = w.to(x.device)
        if x.shape != w.shape:
            return False, float("inf")
        if not torch.equal(x, w):
            same = False
            diff = max(diff, float((x.float() - w.float()).abs().max()))
    return same, diff


def _round_metrics(path: str) -> list:
    """[(round, loss, grad_norm)] of a telemetry file, as recorded (the f32
    metrics as Python floats: their exact values)."""
    from repro_torch.telemetry import read_events

    return [(ev["round"], ev["metrics"]["loss"], ev["metrics"]["grad_norm"])
            for ev in read_events(path) if ev.get("kind") == "round_metrics"]


def spread_against_one_process(torch, tmp: Path, runs, mesh_arg: str,
                               steps: int, tag: str, timeout: float,
                               before=()) -> None:
    """For each (cfg, what) of `runs`: `train.main` at `cfg` with phase
    12's flags for `steps` steps on the flat mesh `mesh_arg` spread over
    its cells' count of gloo processes on the one card (one (client, model
    shard) a process: the layers compute by shard; one start of the
    processes for all the runs), then the same mesh on one process; the
    two must agree bitwise in every step's loss and gradient norm and in a
    digest of each state leaf, each process's over its rows and shards
    against the one-process state's over the same. Each process's bytes
    are held to the wire's accounting and `model_bytes` (`_spread_runs`);
    prints s/step and peak memory a process beside the one-process run's.
    The reckoning of a process (`launch.train.reckon`) is printed first
    and held to the card. `before`: runs of `_spread_runs` on as many
    processes, made first in the same start."""
    import gc

    from repro_torch.core.api import tree_leaves
    from repro_torch.core.dist import CompressedAggregation
    from repro_torch.launch import sharding, steps as train_steps, train
    from repro_torch.launch.mesh import make_mesh

    card = torch.cuda.get_device_properties(0).total_memory
    clients, shards = (int(v) for v in mesh_arg.split("x"))
    world = clients * shards
    jobs = []
    for cfg, what in runs:
        args = train.build_parser().parse_args(
            list(TRAINER_ARGV) + ["--mesh", mesh_arg, "--arch", cfg.name])
        need = train.reckon(cfg, train.train_mesh(args), args)
        need["a process"] = sum(need.values())
        # a CUDA context, outside the allocator (eight processes on the
        # card held about 5 GiB beyond their allocators')
        context = int(0.6 * 2**30)
        n_params = sum(x.numel() for x in tree_leaves(
            train.transformer.init_params(0, cfg, "meta")))
        print(f"processes {tag}: {cfg.name} at full width{what}, "
              f"{n_params / 1e9:.3f} G parameters; mesh {mesh_arg} over "
              f"{world} gloo processes; {sharding.model_layout(cfg, shards)}"
              f"; reckoned a process (bytes): {need}; {world} processes with"
              f" their CUDA contexts (~{context} B each): "
              f"{world * (need['a process'] + context)} of the card's "
              f"{card}; this process's host peak so far "
              f"{_host_peak_gib():.2f} GiB", flush=True)
        check(world * (need["a process"] + context) <= card,
              f"{tag}: {world} processes of {mesh_arg} are reckoned at more "
              "than the card")
        argv = ["--steps", str(steps), "--mesh", mesh_arg, "--arch",
                cfg.name]
        name = cfg.name.replace(".", "_")
        jobs.append({"cfg": cfg, "label": f"{tag} {cfg.name} gloo W={world}",
                     "argv": argv, "digests": True, "stash": True,
                     "logs": (str(tmp / f"{name}_spread.jsonl"),
                              str(tmp / f"{name}_stacked.jsonl"))})
    for job in jobs:
        job["argv"] = job["argv"] + ["--telemetry", job["logs"][0]]
    all_infos = _spread_runs(torch, "gloo", world, list(before) + jobs,
                             timeout)
    before_infos, all_infos = all_infos[:len(before)], all_infos[len(before):]
    gc.collect()
    torch.cuda.empty_cache()
    for job, infos in zip(jobs, all_infos):
        cfg = job["cfg"]
        spread_log, stacked_log = job["logs"]
        argv = job["argv"][:-2] + ["--telemetry", stacked_log]
        state, info = _trainer_run(torch, cfg, argv,
                                   f"{tag} {cfg.name} (stacked) 1 process")
        spread_m, stacked_m = _round_metrics(spread_log), _round_metrics(
            stacked_log)
        print(f"processes {tag} loss and gradient norm a step: spread "
              f"{spread_m}, stacked {stacked_m} (tolerance: bitwise)",
              flush=True)
        check(len(spread_m) == steps and spread_m == stacked_m,
              f"{tag}: the spread run's metrics {spread_m} differ from the "
              f"stacked run's {stacked_m}")
        agg = train_steps.configure_agg(CompressedAggregation(
            method="diana", fraction=0.02, wire_dtype="packed8",
            shift_dtype=torch.float32), make_mesh((clients, shards)),
            params=train.transformer.init_params(0, cfg, "meta"))
        units = sharding.leaf_units(state, agg)
        axes = sharding.leaf_model_axes(state, agg)
        leaves = tree_leaves(state)
        for rank, pinfo in infos.items():
            lay = pinfo["layout"]
            want = []
            for x, unit, ax in zip(leaves, units, axes):
                if unit is not None:
                    x = x[lay.local_ranks if unit == "rank"
                          else lay.local_pods]
                if ax is not None and lay.model_procs > 1:
                    n = x.shape[ax] // lay.model
                    x = x.narrow(ax, lay.local_shards.start * n,
                                 (lay.local_shards.stop
                                  - lay.local_shards.start) * n)
                want.append(_digest(torch, x))
            same = want == pinfo["digests"]
            print(f"processes {tag} process {rank}: {len(want)} leaf digests"
                  f" == the stacked state's over its rows and shards "
                  f"(tolerance: bitwise): {same}", flush=True)
            check(same, f"{tag}: process {rank}'s state digests differ from "
                        "the stacked state's")
        s_step = infos[0]["s_step"]  # process 0 reports the steps
        peaks = [p["peak_gib"] for p in infos.values()]
        print(f"processes {tag} {cfg.name}: spread over {world} processes "
              f"{float('nan') if s_step is None else s_step:.4f} s/step, "
              f"peak {max(peaks):.2f} GiB a process; stacked "
              f"{info['s_step']:.4f} s/step, peak {info['peak_gib']:.2f} "
              "GiB", flush=True)
        del state, leaves
        gc.collect()
        torch.cuda.empty_cache()
    return before_infos


def _rank_digests(torch, cfg, state, world: int, argv) -> dict:
    """{rank: each state leaf's digest over that process's rows and
    shards} of a one-process state of `argv`'s run, for `world`
    processes of its mesh: what each must hand over to equal it."""
    from repro_torch.core.api import tree_leaves
    from repro_torch.core.dist import CompressedAggregation
    from repro_torch.launch import distributed, sharding, steps, train
    from repro_torch.launch.mesh import num_clients

    args = train.build_parser().parse_args(list(TRAINER_ARGV) + argv)
    mesh = train.train_mesh(args)
    agg = steps.configure_agg(CompressedAggregation(
        method=args.agg, fraction=args.fraction, wire_dtype=args.wire_dtype,
        shift_dtype=torch.float32), mesh, args.local_steps,
        params=train.transformer.init_params(0, cfg, "meta"))
    units = sharding.leaf_units(state, agg)
    axes = sharding.leaf_model_axes(state, agg)
    leaves = tree_leaves(state)
    out = {}
    for rank in range(world):
        lay = distributed.RankLayout(world, rank, num_clients(mesh),
                                     agg.num_pods(), agg.model_size)
        want = []
        for x, unit, ax in zip(leaves, units, axes):
            if unit is not None:
                x = x[lay.local_ranks if unit == "rank" else lay.local_pods]
            if ax is not None and lay.model_procs > 1:
                k = x.shape[ax] // lay.model
                x = x.narrow(ax, lay.local_shards.start * k,
                             (lay.local_shards.stop
                              - lay.local_shards.start) * k)
            want.append(_digest(torch, x))
        out[rank] = want
    return out


def _same_files(a: str, b: str) -> bool:
    """Whether two files hold the same bytes (read 64 MiB at a time)."""
    if os.path.getsize(a) != os.path.getsize(b):
        return False
    with open(a, "rb") as fa, open(b, "rb") as fb:
        while True:
            x, y = fa.read(1 << 26), fb.read(1 << 26)
            if x != y:
                return False
            if not x:
                return True


def _fleet_participation(path: str) -> list:
    """Each round's participation counters of a fleet run's telemetry."""
    from repro_torch.telemetry import read_events

    return [{k: ev["metrics"][k] for k in ("completed", "on_time",
                                           "dropped")}
            for ev in read_events(path) if ev.get("kind") == "round_metrics"]


def _planner_replay(argv, rounds: int) -> list:
    """The planner's closed-form replay of an async fleet's counters."""
    from repro_torch.fleet import AsyncPlanner, CohortSampler
    from repro_torch.launch import train

    args = train.build_parser().parse_args(list(TRAINER_ARGV) + argv)
    planner = AsyncPlanner(TRAIN_CLIENTS, buffer_k=args.buffer_k,
                           late=args.late, discount=args.discount,
                           chaos=train.chaos_from_args(args))
    cohorts = CohortSampler(args.clients, TRAIN_CLIENTS, seed=2)
    out = []
    for t in range(rounds):
        plan = planner(t, cohorts.cohort_for_round(t))
        out.append({"completed": int(plan.completes.sum()),
                    "on_time": int(plan.on_time.sum()),
                    "dropped": int(plan.on_time.size - plan.reported.sum())})
    return out


# phase 12 (e)'s one-process async fleet: each W = 8 process's digests of
# its rows and shards of the final state, for phase 13 (m)
ASYNC_ONE_PROCESS: dict = {}


def _drop_pinned(torch) -> None:
    """Hand the host's cached pinned buffers back (a one-process fleet's
    gathered and scattered rows: 8 GB and more at full width), so that
    the processes that follow find the host's memory."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    for name in ("_accelerator_emptyHostCache", "_host_emptyCache"):
        if hasattr(torch._C, name):
            getattr(torch._C, name)()
            return


def fleet_over_processes(torch, cfg, small, tmp: Path, infos, fleet_file,
                         async_tel) -> None:
    """Phase 13 (l) and (m), after their runs over the 8 processes: the
    same runs on this process (the async one phase 12 (e)'s where that
    ran), each process's state digests equal to the one-process state's
    over its rows and shards (bitwise); (l)'s checkpoint at the reduced
    config `small` the one-process file byte for byte, which this
    process resumes for a round into the uninterrupted one-process run's
    state; (m)'s participation counters the planner's replay."""
    sync = ["--steps", str(PROC_STEPS), "--clients", "8"]
    state, _ = _trainer_run(torch, cfg, sync,
                            "(l) fleet --clients 8, 1 process")
    sync_digests = _rank_digests(torch, cfg, state, 8, sync)
    del state
    _drop_pinned(torch)
    if "digests" not in ASYNC_ONE_PROCESS:  # phase 12 (e) did not run
        argv = ["--steps", str(PROC_STEPS), *ASYNC_ARGV, "--data-store",
                str(tmp / "m_data")]
        state, _ = _trainer_run(torch, cfg, argv,
                                "(m) async fleet, 1 process")
        ASYNC_ONE_PROCESS["digests"] = _rank_digests(torch, cfg, state, 8,
                                                     argv)
        del state
        _drop_pinned(torch)
    for label, want, got in (("(l)", sync_digests, infos[0]),
                             ("(m)", ASYNC_ONE_PROCESS["digests"], infos[2])):
        for rank, info in got.items():
            same = info["digests"] == want[rank]
            print(f"processes {label} process {rank}: {len(want[rank])} leaf "
                  "digests == the one-process fleet's over its rows and "
                  f"shards (tolerance: bitwise): {same}", flush=True)
            check(same, f"{label}: process {rank}'s state differs from the "
                        "one-process fleet's")
    one_file = str(tmp / "fleet_one.ckpt")
    _trainer_run(torch, small, sync + ["--checkpoint", one_file],
                 "(l) reduced fleet --clients 8, 1 process, checkpoint")
    same = _same_files(one_file, fleet_file)
    print(f"processes (l) the reduced W=8 fleet checkpoint "
          f"({os.path.getsize(fleet_file)} bytes) == the one-process file "
          f"byte for byte: {same}", flush=True)
    check(same, "(l): the W=8 fleet checkpoint is not the one-process file")
    more = ["--steps", str(PROC_STEPS + 1), "--clients", "8"]
    resumed, _ = _trainer_run(torch, small, more + ["--resume", fleet_file],
                              "(l) reduced, 1 process --resume of the W=8 "
                              "file for a round")
    longer, _ = _trainer_run(torch, small, more,
                             "(l) reduced, 1 process, uninterrupted")
    same, diff = _same_state(torch, resumed, longer)
    print(f"processes (l) the one-process --resume of the W=8 file == the "
          f"uninterrupted one-process fleet (tolerance: bitwise): {same} "
          f"max_abs_diff={diff}", flush=True)
    check(same, f"(l): the one-process resume differs by {diff}")
    seen = _fleet_participation(async_tel)
    want = _planner_replay(["--steps", str(PROC_STEPS), *ASYNC_ARGV],
                           PROC_STEPS)
    print(f"processes (m) participation over 8 processes {seen} (planner "
          f"replay {want})", flush=True)
    check(seen == want, f"(m): counters {seen} != the planner's {want}")


def qwen_full_width(torch, dev, tmp: Path, before=()) -> list:
    """Phase 13 (g): qwen2.5-32b at full width, cut to QWEN_LAYERS of its 64
    layers, on QWEN_MESH over 8 gloo processes against the same mesh on
    one process (`spread_against_one_process`), after the runs `before`
    in the same start of the processes."""
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config("qwen2.5-32b"),
                              num_layers=QWEN_LAYERS)
    return spread_against_one_process(
        torch, tmp, [(cfg, f" (d_model {cfg.d_model}, {cfg.num_heads} heads"
                           f" / {cfg.num_kv_heads} kv, d_ff {cfg.d_ff}, "
                           f"vocab {cfg.vocab}, untied head), {QWEN_LAYERS} "
                           "of 64 layers")],
        QWEN_MESH, QWEN_STEPS, "(g)", 600.0, before)


def families_over_processes(torch, dev, tmp: Path) -> None:
    """Phase 13 (h): each family of FAMILY_TP at full width and
    FAMILY_CUT layers (whisper: FAMILY_CUT encoder and decoder layers
    over 1500 frames) on FAMILY_MESH over 4 gloo processes, one (client,
    model shard) each, the three in one start of the processes (three
    starts until long_500k needed the time), each against the same mesh
    on one process (`spread_against_one_process`)."""
    from repro_torch.configs import get_config

    runs = []
    for name in FAMILY_TP:
        full = get_config(name)
        cut = {"num_layers": FAMILY_CUT}
        if full.is_encdec:
            cut["encoder_layers"] = FAMILY_CUT
        cfg = dataclasses.replace(full, **cut)
        enc = (f" + {cfg.encoder_layers} encoder layers over "
               f"{cfg.encoder_seq} frames" if cfg.is_encdec else "")
        runs.append((cfg, f" (d_model {cfg.d_model}, {cfg.num_heads} heads "
                          f"/ {cfg.num_kv_heads} kv), {FAMILY_CUT} of "
                          f"{full.num_layers} layers{enc}"))
    spread_against_one_process(torch, tmp, runs, FAMILY_MESH, FAMILY_STEPS,
                               "(h)", 600.0)


def _serve_run(torch, dev, cfg, mesh_shape, batch: int, text: int,
               tokens: int, cache_len: int, comm, profiled: int = 0,
               params=None) -> dict:
    """Serving at `cfg` on `mesh_shape` (None: whole layers) over `comm`'s
    cells (this process's clients' rows, or every row where the clients
    do not share the batch; its model shards): seeded weights (drawn whole
    in turn over processes, each keeping its shards:
    `launch.serve._params`), a prefill of `batch` x `text` seeded tokens
    into a cache of `cache_len` and `tokens` greedy tokens, the last
    `profiled` of them under the profiler. Returns the logits after each
    call (the process's rows), the ids, the cache (its slice), the bytes
    sent to the model and joint groups at the prefill and at each token,
    the ms a token (host clock, over the tokens before the profiled
    ones), the prefill's ms, the profiler window's (device busy us,
    kernels, wall us, tokens) and the peak memory. `params`: the seeded
    weights already drawn, where one process holds every cell."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import serve as front
    from repro_torch.launch.mesh import make_mesh, num_clients, num_pods
    from repro_torch.launch.sharding import batch_shared
    from repro_torch.launch.steps import make_prefill_step, make_serve_step

    mesh = None if mesh_shape is None else make_mesh(mesh_shape)
    torch.cuda.reset_peak_memory_stats()
    if params is None:
        gen = torch.Generator(device=dev).manual_seed(0)
        params = front._params(gen, cfg, dev, mesh, comm)
    rows = torch.randint(
        0, cfg.vocab, (batch, text),
        generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    if mesh is not None and batch_shared(batch, num_clients(mesh)):
        m = num_clients(mesh)
        clients = range(m)[comm.local("rank", num_pods(mesh))]
        per = batch // m
        rows = rows[clients.start * per:clients.stop * per]
    prefill = make_prefill_step(cfg, mesh, cache_len=cache_len,
                                collective=comm, batch=batch)
    serve = make_serve_step(cfg, mesh, cache_len=cache_len, collective=comm,
                            batch=batch)
    comm.bytes_sent.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill(params, {"tokens": rows})
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    sent = [dict(comm.bytes_sent)]
    out = [logits]
    tok = torch.argmax(logits[:, -1, :cfg.vocab], -1, keepdim=True)
    ids = [tok]

    def decode(i):
        nonlocal tok, logits, cache
        logits, cache = serve(params, cache, tok, text + i)
        tok = torch.argmax(logits[:, -1, :cfg.vocab], -1, keepdim=True)
        sent.append(dict(comm.bytes_sent))
        out.append(logits)
        ids.append(tok)

    timed = tokens - profiled
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(timed):
        decode(i)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / max(timed, 1) * 1e3
    window = None
    if profiled:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(timed, tokens):
                decode(i)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        busy, kernels = _device_us(torch, _device_rows(torch, prof), None)
        window = (busy, kernels, wall_us, profiled)
    del params
    per_token = {k: [x.get(k, 0) - (sent[i - 1].get(k, 0) if i else 0)
                     for i, x in enumerate(sent)] for k in ("model", "joint")}
    return {"logits": out, "ids": torch.cat(ids, 1).tolist(),
            "cache": cache, "sent": per_token["model"],
            "joint_sent": per_token["joint"], "ms": ms,
            "prefill_ms": prefill_ms, "profile": window,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


def _serve_cases():
    """Phase 13's serving cases: (tag, config, mesh, batch, text tokens,
    tokens, cache_len, a process's cache bytes): (i) and (j) with the
    batch, prompt and cache of SERVE_TP_RUN; (k), phase 14 (c): LONG_SPREAD
    at long_500k, its one request served whole by every client."""
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import INPUT_SHAPES

    name, batch, text, _, cell = SERVE_TP_RUN
    cache_len = text + SERVE_TOKENS + 8
    long = INPUT_SHAPES["long_500k"]
    _, long_text, _, long_cell = next(r for r in LONG_RUNS
                                      if r[0] == LONG_SPREAD)
    return (("(i)", get_config(name), SERVE_MESH, batch, text,
             PROC_SERVE_TOKENS, cache_len, cell),
            ("(j)", dataclasses.replace(get_config("qwen2.5-32b"),
                                        num_layers=QWEN_SERVE_LAYERS),
             QWEN_SERVE_MESH, batch, text, QWEN_SERVE_TOKENS, cache_len,
             QWEN_SERVE_CELL),
            ("(k)", get_config(LONG_SPREAD), LONG_MESH, long.global_batch,
             long_text, LONG_TOKENS, long.seq_len, long_cell))


def _serve_child(rank, world, port, out, done):
    """One process of phase 13's spread serving runs, joined as torchrun
    joins (its environment, the store the parent hosts), over gloo:
    `_serve_run` on its cells for each of `_serve_cases` in turn; hands
    the parent digests of its logits and cache slice, its ids, bytes,
    cache bytes, ms a token and peak, by case."""
    os.environ.update({
        "RANK": str(rank), "WORLD_SIZE": str(world), "LOCAL_RANK": str(rank),
        "MASTER_ADDR": "localhost", "MASTER_PORT": str(port),
        "TORCHELASTIC_USE_AGENT_STORE": "True"})
    try:
        import torch

        from repro_torch.core.api import tree_leaves
        from repro_torch.launch import distributed

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        distributed.init_process_group("gloo")
        dev = distributed.process_device("cuda", rank)
        got = {}
        for (tag, cfg, mesh_shape, batch, text, tokens, cache_len,
             _) in _serve_cases():
            t0 = time.perf_counter()
            comm = distributed.ProcessGroupCollective(*mesh_shape)
            res = _serve_run(torch, dev, cfg, mesh_shape, batch, text,
                             tokens, cache_len, comm)
            leaves = tree_leaves(res.pop("cache"))
            res["cache_bytes"] = sum(x.nbytes for x in leaves)
            res["cache"] = [_digest(torch, x) for x in leaves]
            res["logits"] = [_digest(torch, x) for x in res["logits"]]
            del leaves
            torch.cuda.empty_cache()
            res["wall"] = time.perf_counter() - t0
            got[tag] = res
        distributed.destroy_process_group()
        out.put((rank, got))
        done.wait(120)
    except BaseException:
        import traceback

        out.put((rank, traceback.format_exc()))
        raise


def _process_digests(torch, one: dict, cfg, mesh_shape, batch: int,
                     cache_len: int) -> dict:
    """What each process of a spread over one (client, shard) cell a
    process must hand over, by rank: the one-process run's ids and logits
    over its rows (every row where the clients do not share the batch)
    and digests of its slice of the cache (`transformer.cache_slice`)."""
    from repro_torch.core.api import tree_leaves
    from repro_torch.launch import distributed
    from repro_torch.launch.mesh import make_mesh, num_pods
    from repro_torch.launch.sharding import batch_shared
    from repro_torch.launch.steps import serve_shards
    from repro_torch.models.transformer import cache_slice

    mesh = make_mesh(mesh_shape)
    m, t = mesh_shape
    world = m * t
    shared = batch_shared(batch, m)
    want = {}
    for rank in range(world):
        comm = distributed.ProcessGroupCollective(m, t, world=world,
                                                  rank=rank)
        lay = comm.layout(num_pods(mesh))
        per = batch // m
        rows = (slice(lay.local_ranks.start * per, lay.local_ranks.stop * per)
                if shared else slice(None))
        ms = serve_shards(cfg, mesh, cache_len, comm,
                          None if shared else batch)
        cache = tree_leaves(cache_slice(_rows_of(one["cache"], rows), ms))
        want[rank] = {"ids": one["ids"][rows],
                      "logits": [_digest(torch, x[rows])
                                 for x in one["logits"]],
                      "cache": [_digest(torch, x) for x in cache]}
        del cache
    return want


def _rows_of(cache, rows: slice):
    from repro_torch.core.api import tree_map

    return tree_map(lambda x: x[:, rows], cache)


def _one_process_digests(torch, dev, cfg, mesh_shape, batch, text, tokens,
                         cache_len, tag) -> dict:
    """`_serve_run` in this process on every cell of `mesh_shape`; the
    digests each process of the spread must give, by rank."""
    import gc

    from repro_torch.core.api import tree_leaves
    from repro_torch.launch import distributed

    t0 = time.perf_counter()
    one = _serve_run(torch, dev, cfg, mesh_shape, batch, text, tokens,
                     cache_len, distributed.StackedCollective())
    want = _process_digests(torch, one, cfg, mesh_shape, batch, cache_len)
    print(f"processes {tag} one process: {one['ms']:.3f} ms/token, peak "
          f"{one['peak_gib']:.2f} GiB, cache "
          f"{sum(x.nbytes for x in tree_leaves(one['cache']))} bytes, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    del one
    gc.collect()
    torch.cuda.empty_cache()
    return want


# phase 14 (b)'s LONG_SPREAD run on LONG_MESH, as each process of 13 (k)
# must hand it over (`_process_digests`), kept for phase 13
LONG_DIGESTS: dict = {}


def serving_over_processes(torch, dev) -> None:
    """Phase 13 (i), (j) and (k): each of `_serve_cases` served on its mesh
    in this process (one (client, shard) cell after another; (k)'s is
    phase 14 (b)'s run where that phase ran), then over one gloo process a
    cell on the one card (8 processes, started once for all three). Every
    process's ids, every token's logits and its cache slice must equal
    the one-process run's over its rows and parts, bitwise (digests on
    the card); its cache slice must be the case's bytes, its bytes to its
    model group `launch.sharding.serve_model_bytes` at the prefill and at
    each token, and (k)'s to the joint group `serve_joint_bytes` a
    token."""
    import gc

    import torch.distributed as dist

    from repro_torch.core.api import tree_leaves
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.sharding import (
        batch_shared,
        serve_joint_bytes,
        serve_model_bytes,
    )
    from repro_torch.models.transformer import init_params

    cases = _serve_cases()
    world = 8
    want = {}
    for (tag, cfg, mesh_shape, batch, text, tokens, cache_len,
         _) in cases:
        assert mesh_shape[0] * mesh_shape[1] == world
        n_params = sum(x.numel() for x in tree_leaves(
            init_params(0, cfg, "meta")))
        print(f"processes {tag}: serving {cfg.name} at full width (d_model "
              f"{cfg.d_model}, {cfg.num_heads} heads / {cfg.num_kv_heads} "
              f"kv), {cfg.num_layers} layers, {n_params / 1e9:.3f} G "
              f"parameters ({n_params * 2 / 1e9:.2f} GB bf16); mesh "
              f"{mesh_shape}, {batch} x {text} prompt tokens, cache "
              f"{cache_len}, {tokens} greedy tokens; one process, then "
              f"{world} gloo processes", flush=True)
        if tag == "(k)" and LONG_DIGESTS:
            print(f"processes {tag} one process: phase 14 (b)'s run",
                  flush=True)
            want[tag] = LONG_DIGESTS
            continue
        want[tag] = _one_process_digests(torch, dev, cfg, mesh_shape, batch,
                                         text, tokens, cache_len, tag)
    store = dist.TCPStore("localhost", 0, world, is_master=True,
                          wait_for_workers=False)
    ctx = torch.multiprocessing.get_context("spawn")
    out, done = ctx.Queue(), ctx.Event()
    procs = [ctx.Process(target=_serve_child, args=(
        r, world, store.port, out, done)) for r in range(world)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    got = {}
    deadline = time.perf_counter() + 600.0
    try:
        while len(got) < world:
            try:
                rank, res = out.get(
                    timeout=max(1.0, deadline - time.perf_counter()))
            except queue.Empty:
                raise SmokeFailure(f"(i)-(k): {world - len(got)} process(es)"
                                   " gave no result in 600 s")
            check(not isinstance(res, str),
                  f"(i)-(k): process {rank} failed:\n{res}")
            got[rank] = res
        print(f"processes (i)-(k): {world} processes started, served all "
              f"three and reported in {time.perf_counter() - t0:.1f} s",
              flush=True)
        for (tag, cfg, mesh_shape, batch, text, tokens, cache_len,
             cell) in cases:
            m, t = mesh_shape
            mesh = make_mesh(mesh_shape)
            if batch_shared(batch, m):
                per = batch // m
                pre = serve_model_bytes(cfg, per, cache_len, t, 1,
                                        prompt=text)
                tok = serve_model_bytes(cfg, per, cache_len, t, 1)
                joint = 0
            else:
                pre = serve_model_bytes(cfg, batch, cache_len, t, 1,
                                        prompt=text, mesh=mesh)
                tok = serve_model_bytes(cfg, batch, cache_len, t, 1,
                                        mesh=mesh)
                joint = serve_joint_bytes(cfg, batch, cache_len, mesh, 1)
            for rank in sorted(got):
                res, w = got[rank][tag], want[tag][rank]
                same = (res["ids"] == w["ids"]
                        and res["logits"] == w["logits"]
                        and res["cache"] == w["cache"])
                print(f"processes {tag} process {rank} == one process "
                      f"(tolerance: bitwise): ids {res['ids'] == w['ids']}, "
                      f"{len(w['logits'])} logits digests "
                      f"{res['logits'] == w['logits']}, {len(w['cache'])} "
                      f"cache leaf digests {res['cache'] == w['cache']}",
                      flush=True)
                check(same, f"{tag}: process {rank} differs from the "
                            "one-process run")
                check(res["cache_bytes"] == cell,
                      f"{tag}: process {rank} holds {res['cache_bytes']} "
                      f"bytes of the cache, not {cell}")
                check(res["sent"] == [pre] + [tok] * tokens,
                      f"{tag}: process {rank} sent its model group "
                      f"{res['sent'][:2]}..., serve_model_bytes says {pre} "
                      f"at the prefill and {tok} a token")
                check(res["joint_sent"] == [0] + [joint] * tokens,
                      f"{tag}: process {rank} sent the joint group "
                      f"{res['joint_sent'][:2]}..., serve_joint_bytes says "
                      f"{joint} a token")
            first = got[0][tag]
            peaks = [r[tag]["peak_gib"] for r in got.values()]
            print(f"processes {tag} {cfg.name}: {world} processes "
                  f"{first['ms']:.3f} ms/token (process 0), peak "
                  f"{max(peaks):.2f} GiB a process, cache slice {cell} bytes"
                  f" a process, model group {pre} bytes at the prefill and "
                  f"{tok} a token a process (serve_model_bytes), joint group"
                  f" {joint} a token a process (serve_joint_bytes); "
                  f"{first['wall']:.1f} s in process 0", flush=True)
    finally:
        done.set()
        for p in procs:
            p.join(60)
            if p.is_alive():
                p.terminate()
                p.join(10)
        bad = {r: p.exitcode for r, p in enumerate(procs) if p.exitcode != 0}
        if bad and sys.exc_info()[0] is None:
            raise SmokeFailure(f"(i)-(k): processes exited {bad}")
        del store
        gc.collect()
        torch.cuda.empty_cache()


def _long_hold(torch, b: dict, a: dict, cfg, what: str) -> str:
    """(b)'s logits against (a)'s, each token's while the ids before it
    agree, within tests/test_torch_serving.py's f32 bound (1e-2 of (a)'s
    largest entry); where an id differs, (a)'s logits of both ids within
    that bound (a near tie). Returns what it found."""
    worst, ties = 0.0, []
    for i, (x, y) in enumerate(zip(b["logits"], a["logits"])):
        if i and b["ids"][0][:i] != a["ids"][0][:i]:
            break  # the inputs differ from here on
        x, y = x[0, -1, :cfg.vocab].float(), y[0, -1, :cfg.vocab].float()
        scale = float(y.abs().max())
        err = float((x - y).abs().max())
        check(err <= 1e-2 * scale, f"{what} token {i}: {err:.3e} against "
                                   f"1e-2 x {scale:.3e}")
        worst = max(worst, err / scale)
        ia, ib = a["ids"][0][i], b["ids"][0][i]
        if ia != ib:
            gap = float((y[ia] - y[ib]).abs())
            check(gap <= 1e-2 * scale, f"{what} token {i}: id {ib} against "
                                       f"{ia}, (a)'s logits {gap:.3e} apart")
            ties.append((i, ia, ib, gap))
    return (f"worst {worst:.2e} of (a)'s largest logit (bound 1e-2); ids "
            f"(a) {a['ids'][0]}, (b) {b['ids'][0]}"
            + (f"; near ties {ties}" if ties else ""))


def _long_print(label: str, res: dict, card: str) -> None:
    busy, kernels, wall_us, n = res["profile"]
    device = ("device time not measured (the profiler saw no kernels)"
              if busy is None else
              f"{busy / n / 1e3:.3f} device ms/token, {kernels / n:.1f} "
              f"kernels/token, device idle share {1 - busy / wall_us:.3f} "
              f"({n} tokens under the profiler, {wall_us / n / 1e3:.3f} "
              "ms/token wall)")
    print(f"long_500k {label}: prefill {res['prefill_ms']:.1f} ms, decode "
          f"{res['ms']:.3f} ms/token; {device}; peak {res['peak_gib']:.2f} "
          f"GiB [{card}]", flush=True)


def phase_long(torch, dev):
    """Phase 14: long_500k (see the module docstring)."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import INPUT_SHAPES, shape_supported
    from repro_torch.core.api import tree_leaves
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import distributed
    from repro_torch.models.transformer import init_params

    card = card_line()
    long = INPUT_SHAPES["long_500k"]
    batch, cache_len = long.global_batch, long.seq_len
    reset_launches()

    def run(cfg, label, mesh_shape, profiled, params):
        t0 = time.perf_counter()
        res = _serve_run(torch, dev, cfg, mesh_shape, batch, text,
                         LONG_TOKENS, cache_len,
                         distributed.StackedCollective(), profiled, params)
        nbytes = sum(x.nbytes for x in tree_leaves(res["cache"]))
        how = ("whole layers" if mesh_shape is None
               else f"on {mesh_shape} by shard in this process")
        dtype = str(cfg.dtype).split(".")[-1]
        print(f"long_500k {label} {name} ({dtype}): {cfg.num_layers} "
              f"layers, 1 x {text} prompt tokens, cache_len {cache_len}, "
              f"{LONG_TOKENS} greedy tokens, {how}: cache {nbytes} bytes; "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        check(all(bool(torch.isfinite(x[..., :cfg.vocab]).all())
                  for x in res["logits"]),
              f"{name} {label}: logits not finite")
        return res, nbytes

    for name, text, want_bytes, want_cell in LONG_RUNS:
        cfg = get_config(name)
        check(shape_supported(cfg, long)[0], f"{name}: long_500k unsupported")
        # (a) and (b) as served (bf16): times, bytes and (c)'s bits, from
        # the weights `_serve_run` draws (one draw for both)
        runs = {}
        params = init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                             dev)
        for label, mesh_shape in (("(a)", None), ("(b)", LONG_MESH)):
            res, nbytes = run(cfg, label, mesh_shape, LONG_PROFILE, params)
            check(nbytes == want_bytes, f"{name} {label}: the cache holds "
                                        f"{nbytes} bytes, not {want_bytes}")
            _long_print(f"{label} {name}", res, card)
            runs[label] = res
        b = runs["(b)"]
        cells = [sum(x.nbytes for x in tree_leaves(
            _long_cell(torch, b, cfg, cache_len, r)))
            for r in range(LONG_MESH[0] * LONG_MESH[1])]
        print(f"long_500k (b) {name}: each (client, shard) cell's slice "
              f"{sorted(set(cells))} bytes (expected {want_cell})",
              flush=True)
        check(set(cells) == {want_cell},
              f"{name}: a cell's slice is {cells}, not {want_cell} bytes")
        if name == LONG_SPREAD:
            LONG_DIGESTS.clear()
            LONG_DIGESTS.update(_process_digests(torch, b, cfg, LONG_MESH,
                                                 batch, cache_len))
        del runs, b, params
        gc.collect()
        torch.cuda.empty_cache()
        # (b) held to (a) at f32, where the two paths' roundings stay far
        # below the bound (at bf16 they compound over the full depth)
        f32 = dataclasses.replace(cfg, dtype=torch.float32)
        params = init_params(torch.Generator(device=dev).manual_seed(0), f32,
                             dev)
        a32, _ = run(f32, "(a)", None, 0, params)
        b32, _ = run(f32, "(b)", LONG_MESH, 0, params)
        del params
        found = _long_hold(torch, b32, a32, cfg, f"{name} (b) at f32")
        print(f"long_500k (b) {name} == (a) at f32 (tests/test_torch_"
              f"serving.py's bound): {found}", flush=True)
        del a32, b32
        gc.collect()
        torch.cuda.empty_cache()
    print(f"long_500k path launches: {dict(LAUNCHES)}", flush=True)
    check(not any(LAUNCHES.values()),
          f"the serving path launched a wire kernel: {dict(LAUNCHES)}")


def _long_cell(torch, res, cfg, cache_len, rank):
    """Process `rank`'s slice of (b)'s cache over LONG_MESH's 8 cells."""
    from repro_torch.launch import distributed
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import serve_shards
    from repro_torch.models.transformer import cache_slice

    m, t = LONG_MESH
    comm = distributed.ProcessGroupCollective(m, t, world=m * t, rank=rank)
    ms = serve_shards(cfg, make_mesh(LONG_MESH), cache_len, comm, 1)
    return cache_slice(res["cache"], ms)


def phase_processes(torch, dev):
    """Phase 13 (see the module docstring)."""
    import gc
    import shutil
    import tempfile

    from repro_torch import experiments
    from repro_torch.checkpoint import restore_train_state
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.api import tree_leaves
    from repro_torch.core.dist import CompressedAggregation
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh

    cfg = dataclasses.replace(get_config("stablelm-1.6b"),
                              num_layers=TRAINER_LAYERS)
    print(f"processes: {cfg.name} {cfg.num_layers} of 24 layers, flags "
          f"{' '.join(TRAINER_ARGV)}, the (4, 2) mesh's cells over 1 and 8 "
          f"processes on one card; card {card_line()}; this process's host "
          f"peak so far {_host_peak_gib():.2f} GiB", flush=True)
    tmp = Path(tempfile.mkdtemp(prefix="chip-smoke-processes-"))
    n = str(PROC_STEPS)
    half = str(PROC_STEPS // 2)

    def stacked_on_host(argv, label):
        """A stacked run's state leaves, moved to the host: the card is
        the processes' while they run."""
        state, _ = _trainer_run(torch, cfg, argv, label)
        leaves = [x.cpu() for x in tree_leaves(state)]
        del state
        gc.collect()
        torch.cuda.empty_cache()
        return leaves

    try:
        whole = stacked_on_host(["--steps", n], "(stacked) 1 process")
        stacked_half = str(tmp / "stacked_half.ckpt")
        stacked_on_host(["--steps", half, "--checkpoint", stacked_half],
                        f"(stacked) 1 process, {half} steps, checkpoint")
        _spread_run(torch, cfg, "(a) nccl W=1", "nccl", 1, ["--steps", n],
                    whole, timeout=360.0)
        # (l) and (m), the fleet over the 8 processes, each held to the
        # same run on this process after the processes end (the card and
        # the host's memory are theirs while they run); (l)'s checkpoints
        # at the reduced width (a full-width fleet file is 27.7 GB, and a
        # call may write 45 GiB in all)
        sync = ["--steps", n, "--clients", "8"]
        small = reduced(get_config("stablelm-1.6b"), seq=TRAIN_SEQ)
        # (f) puts the model axis over processes, one (client, model
        # shard) each: it resumes from the stacked run's checkpoint and
        # writes its own, the stacked file put together from the shards;
        # then (l), (m) and (g) in the same start of the 8 processes (two
        # starts until long_500k needed the time)
        ckpt8 = str(tmp / "w8.ckpt")
        fleet_file = str(tmp / "fleet_w8.ckpt")
        async_tel = str(tmp / "m.telemetry.jsonl")
        infos = qwen_full_width(torch, dev, tmp, before=[{
            "cfg": cfg, "label": "(f) gloo W=8, one (client, shard) a process",
            "argv": ["--steps", n, "--resume", stacked_half, "--checkpoint",
                     ckpt8], "ref": whole, "stash": True}, {
            "cfg": cfg, "label": "(l) fleet --clients 8, gloo W=8",
            "argv": sync, "digests": True, "stash": True}, {
            "cfg": small, "label": "(l) reduced fleet, gloo W=8, checkpoint",
            "argv": sync + ["--checkpoint", fleet_file], "digests": True}, {
            "cfg": cfg, "label": "(m) async fleet, gloo W=8",
            "argv": ["--steps", n, *ASYNC_ARGV, "--data-store",
                     str(tmp / "m_data_w8"), "--telemetry", async_tel],
            "digests": True, "stash": True}])
        # (f)'s processes, for phase 15; (f) resumed at step `half`
        MEASURED["13f"] = {"infos": infos[0], "steps": int(n) - int(half)}
        fleet_over_processes(torch, cfg, small, tmp, infos[1:], fleet_file,
                             async_tel)
        # (e) the W = 8 checkpoint's leaves are the stacked run's, and the
        # stacked run resumed from it for half as many steps again equals
        # the stacked run of that length
        agg = CompressedAggregation(method="diana", fraction=0.02,
                                    wire_dtype="packed8",
                                    shift_dtype=torch.float32)
        like = steps.init_train_state(0, cfg, agg, 4, mesh=make_mesh((4, 2)),
                                      device="meta")
        t0 = time.perf_counter()
        loaded = restore_train_state(ckpt8, like, dev)
        load_s = time.perf_counter() - t0
        same, diff = _same_state(torch, tree_leaves(loaded),
                                 [x.to(dev) for x in whole])
        print(f"processes (e) the W=8 checkpoint ({os.path.getsize(ckpt8)} "
              f"bytes, loaded in {load_s:.2f} s) == the stacked state after "
              f"{n} steps (tolerance: bitwise): {same} max_abs_diff={diff}",
              flush=True)
        check(same, f"(e): the W=8 checkpoint differs from the stacked state "
                    f"by {diff}")
        del loaded, whole
        more = str(PROC_STEPS + PROC_STEPS // 2)
        longer, _ = _trainer_run(torch, cfg, ["--steps", more],
                                 f"(stacked) {more} steps")
        resumed, _ = _trainer_run(torch, cfg, ["--steps", more, "--resume",
                                               ckpt8], "(e) stacked --resume")
        same, diff = _same_state(torch, resumed, longer)
        print(f"processes (e) stacked --resume of the W=8 checkpoint to step "
              f"{more} == the stacked run (tolerance: bitwise): {same} "
              f"max_abs_diff={diff}", flush=True)
        check(same, f"(e): the stacked resume differs by {diff}")
        del resumed, longer
        gc.collect()
        torch.cuda.empty_cache()
        # (d) two pods of two clients of two shards, packed8 DIANA-NASTYA
        # (2 local steps; DIANA-RR's 8 slot tables would take 99 GB at
        # this width): each process one pod, its layers on both shards
        nastya = ["--pods", "2", "--local-steps", "2", "--eta", "0.2"]
        ref = stacked_on_host(["--steps", n] + nastya,
                              "(stacked) 2 pods, NASTYA")
        _spread_run(torch, cfg, "(d) gloo W=2, 2 pods, NASTYA", "gloo", 2,
                    ["--steps", n] + nastya, ref)
        del ref
        families_over_processes(torch, dev, tmp)
        serving_over_processes(torch, dev)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # experiment3 at EXP3_EPOCHS epochs, its other defaults: the simulator
    # on a neural network
    reset_launches()
    t0 = time.perf_counter()
    rows = experiments.experiment3(epochs=EXP3_EPOCHS, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for row in rows:
        print("experiment3 " + ",".join(str(x) for x in row), flush=True)
    print(f"experiment3: {wall:.1f} s, launches {dict(LAUNCHES)}", flush=True)
    check(all(math.isfinite(r[1]) and math.isfinite(r[2]) for r in rows),
          f"experiment3: a row is not finite: {rows}")
    for name in ("randk_mask", "diana_shift_update"):
        check(LAUNCHES[name] > 0, f"experiment3: {name} was not launched")


def loss_jump(torch, dev) -> None:
    """ROADMAP C5, the packed8 two-pod DIANA-RR loss jump: DIANA-RR as
    phase 7's sweep runs it (CUT_LAYERS layers, 4 clients, 2 shift slots,
    k/d = 0.02, lr 0.05, seq 128 x 2 a client, the config's bf16 params,
    seed 0) for 3 steps, at each width of JUMP_WIDTHS (d_model, with
    d_model / 64 heads of 64 and d_ff = 2.75 d_model, and vocab) on each
    transport of JUMP_WIRES and both meshes. A run jumps where its last
    loss is more than one nat above its first (phase 7's full-width sweep
    ended at 10.36-11.49 on the f32 wire and 19.17 on packed8 two pods,
    from about 11.5). Prints each run's losses, then one JSON line."""
    from repro_torch.configs import get_config
    from repro_torch.core.dist import CompressedAggregation
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import init_train_state, make_train_step

    full = get_config("stablelm-1.6b")
    rows = []
    for d_model, vocab in JUMP_WIDTHS:
        heads = d_model // full.head_dim
        cfg = dataclasses.replace(full, num_layers=CUT_LAYERS,
                                  d_model=d_model, num_heads=heads,
                                  num_kv_heads=heads, d_ff=d_model * 11 // 4,
                                  vocab=vocab)
        batches = _train_batches(cfg, 3, 2)
        for wire, extra in JUMP_WIRES:
            for mesh_shape in ((4, 1), (2, 2, 1)):
                agg = CompressedAggregation(method="diana_rr", fraction=0.02,
                                            n_slots=2, **extra)
                mesh = make_mesh(mesh_shape,
                                 ("pod", "data", "model")[-len(mesh_shape):])
                state = init_train_state(0, cfg, agg, TRAIN_CLIENTS,
                                         mesh=mesh, device=dev)
                step = make_train_step(cfg, mesh, agg=agg, lr=0.05)
                gen = torch.Generator(device=dev).manual_seed(0)
                losses = []
                for rows_np, slots in batches:
                    batch = {"tokens": torch.from_numpy(rows_np).to(dev)}
                    state, metrics = step(state, batch, gen, slots, None)
                    losses.append(float(metrics["loss"]))
                jump = losses[-1] > losses[0] + 1.0
                print(f"loss jump d_model={d_model} vocab={vocab} {wire} "
                      f"mesh {mesh_shape}: losses {losses} jump={jump}",
                      flush=True)
                rows.append({"d_model": d_model, "vocab": vocab,
                             "wire": wire, "mesh": list(mesh_shape),
                             "losses": losses, "jump": jump})
                del state, step
                torch.cuda.empty_cache()
    print(json.dumps({"loss_jump": rows}), flush=True)


def kernel_times(torch, dev, src: Path) -> None:
    """Device time per launch of the kernels in COMPARED at their path,
    large and family shapes, each after its bitwise check, beside the bound
    and the nearest composite's time (CUDA events): run once for each of
    two checkouts' `src/` in one call to compare their kernels on one
    card."""
    rows = []
    cases = [c for c in kernel_cases(torch, dev) + wire_cases(torch, dev)
             if c.name in COMPARED + ALSO_TIMED and c.kind != "edge"]
    while cases:
        case = cases.pop(0)  # frees the inputs of the cases before it
        parity(torch, case)
        us = device_us(torch, case)
        b_ms, b_by = bound_ms(case.nbytes, case.ops)
        inner = 200 if case.nbytes < 2**24 else 10
        comp_us = (None if case.composite is None
                   else time_ms(torch, case.composite, inner) * 1e3)
        floor_us = (None if case.floor is None
                    else plain_device_us(torch, case.floor))
        print(f"kernel time {case.name} [{case.label}] ({case.kind}): device "
              f"{'not measured' if us is None else f'{us:.2f} us'} per launch,"
              f" bound {b_ms * 1e3:.3f} us ({b_by}), composite "
              f"{'none' if comp_us is None else f'{comp_us:.2f} us'}, "
              f"same-bytes PyTorch call "
              f"{'none' if floor_us is None else f'{floor_us:.2f} us'}",
              flush=True)
        if case.name == "qsgd_quantize" and case.kind == "path":
            print(f"kernel time {launch_floor(torch, case.nbytes)}",
                  flush=True)
        rows.append({"name": case.name, "label": case.label,
                     "kind": case.kind, "device_us": us,
                     "bound_us": b_ms * 1e3, "composite_us": comp_us,
                     "same_bytes_us": floor_us})
    print(json.dumps({"kernel_times": rows, "src": str(src)}), flush=True)
    print(f"card after the turn (SM clock, temperature, power): "
          f"{card_state()}", flush=True)


def phase_dry_run(torch, dev):
    """Phase 15 (see the module docstring): the dry run's census on this
    host against phase 7's and phase 13 (f)'s measurements on the card."""
    from repro_torch.configs import get_config
    from repro_torch.launch import cost_analysis as ca
    from repro_torch.launch import dryrun, train
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.sharding import model_bytes
    from repro_torch.models import transformer

    card = card_line()
    tol = DRY_RUN_PEAK_TOLERANCE

    def held(label, traced, measured):
        ratio = traced / measured
        print(f"dry run {label}: traced peak {traced} B "
              f"({traced / 2**30:.2f} GiB) / measured max_memory_allocated "
              f"{measured} B ({measured / 2**30:.2f} GiB) = {ratio:.4f} "
              f"(budget 1 +- {tol}); {card}", flush=True)
        check(abs(ratio - 1) <= tol, f"dry run {label}: the traced peak is "
                                     f"{ratio:.4f} of the measured one")

    # (a) phase 7's first step, one process holding the 4 client ranks
    a = MEASURED["7"]
    cfg, agg = a["cfg"], a["agg"]
    check(a["profile"] is not None, "dry run (a): phase 7's profiler window "
                                    "saw no kernels")
    coll = ca.CensusCollective(TRAIN_CLIENTS, 1, world=1, rank=0)
    t0 = time.perf_counter()
    ops, wired, state = dryrun.trace_train(
        cfg, make_mesh((TRAIN_CLIENTS, 1)),
        dataclasses.replace(agg, collective=coll),
        rows=TRAIN_CLIENTS * TRAIN_BATCH, seq=TRAIN_SEQ, remat=False)[:3]
    print(f"dry run (a): {cfg.name} {cfg.num_layers} layers, (4, 1), "
          f"packed8 DIANA-RR: traced {len(ops.sequence)} ops on fake "
          f"{ca.census_device()} tensors in {time.perf_counter() - t0:.1f} s;"
          f" {ops.flops} FLOPs, {ops.op_bytes} op bytes, state {state} B",
          flush=True)
    kern = ops.kern.summary()
    for name in WIRE_KERNELS + ("diana_shift_update",):
        got = kern.get(name, {}).get("launches", 0)
        want = a["profile"]["counts"][name]
        print(f"dry run (a) {name}: census launches {got}, the profiler's "
              f"{want:g} in one step; {card}", flush=True)
        check(got == want, f"dry run (a): {name} census launches {got}, "
                           f"profiled {want}")
    wire = wired.wire_bytes_per_round(transformer.init_params(0, cfg, "meta"))
    got = coll.bytes_sent["intra_pod"]
    print(f"dry run (a) wire: census intra_pod {got} B a step (the 4 ranks' "
          f"stacked message) == 4 x wire_bytes_per_round "
          f"{wire['intra_pod']} B: {got == TRAIN_CLIENTS * wire['intra_pod']}"
          f"; {card}", flush=True)
    check(got == TRAIN_CLIENTS * wire["intra_pod"],
          f"dry run (a): census wire bytes {got}")
    held("(a)", ops.peak, a["peak"])
    del ops
    # (b) phase 13 (f)'s process 0: one (client, shard) of (4, 2)
    info = MEASURED["13f"]["infos"][0]
    measured = info["bytes_sent"]["model"] // MEASURED["13f"]["steps"]
    cfg = dataclasses.replace(get_config("stablelm-1.6b"),
                              num_layers=TRAINER_LAYERS)
    args = train.build_parser().parse_args(list(TRAINER_ARGV))
    coll = ca.CensusCollective(4, 2, world=8, rank=0)
    t0 = time.perf_counter()
    with _stash_meter(torch) as stash:
        ops, wired, state = dryrun.trace_train(
            cfg, make_mesh((4, 2)),
            train._aggregation(args, 4, train.N_BATCHES, coll),
            rows=args.batch // 4, seq=args.seq, remat=train._remat(args))[:3]
    print(f"dry run (b): {cfg.name} {cfg.num_layers} layers, process 0 of "
          f"(4, 2) over 8: traced {len(ops.sequence)} ops in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    got, want = coll.bytes_sent["model"], model_bytes(cfg, 2, args.seq, 2, 1)
    print(f"dry run (b) model: census {got} B a step, `model_bytes` {want} "
          f"B, 13 (f) measured {measured} B a step; {card}", flush=True)
    check(got == want == measured == 14_158_848,
          f"dry run (b): model bytes {got}, measured {measured}")
    block = stash["block"] or []
    got = (cfg.num_layers + 1) * sum(block)
    want = train.stash_bytes(cfg, 2, args.seq, 2, 1)
    print(f"dry run (b) stash: census (L + 1) x {block} = {got} B, "
          f"`stash_bytes` {want} B; {card}", flush=True)
    check(got == want == 1_572_864, f"dry run (b): stash {got}")
    held("(b)", ops.peak, int(info["peak_gib"] * 2**30))
    del ops
    # (c) the linter
    src = Path(sys.modules["repro_torch"].__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                          "--lint"], capture_output=True, text=True,
                         timeout=120, env={**os.environ, "PYTHONPATH": str(src)})
    print(f"dry run (c): python -m repro_torch.analysis --lint exit "
          f"{out.returncode}: {out.stdout.strip()[-200:]}", flush=True)
    check(out.returncode == 0, f"dry run (c): lint findings:\n{out.stdout}"
                               f"{out.stderr[-2000:]}")


def dry_run_alone(torch, dev):
    """--dry-run: phase 7's first step and 13 (f)'s W = 8 trainer (from a
    fresh state), then phase 15."""
    from repro_torch.configs import get_config
    from repro_torch.core.dist import CompressedAggregation

    cfg = get_config("stablelm-1.6b")
    phase7_first_run(torch, dev, cfg, CompressedAggregation(
        method="diana_rr", fraction=0.02, n_slots=2, wire_dtype="packed8"))
    torch.cuda.empty_cache()
    small = dataclasses.replace(cfg, num_layers=TRAINER_LAYERS)
    MEASURED["13f"] = {"infos": _spread_runs(torch, "gloo", 8, [{
        "cfg": small, "label": "(f) gloo W=8 from a fresh state",
        "argv": ["--steps", str(PROC_STEPS)], "stash": True}])[0],
        "steps": PROC_STEPS}
    with phase_clock("15"):
        phase_dry_run(torch, dev)


def parse_args(argv):
    import argparse

    ap = argparse.ArgumentParser(
        description="Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.")
    ap.add_argument("--kernel-times", action="store_true",
                    help="only the device time per launch of "
                         f"{' and '.join(COMPARED)} at their path, large and "
                         "family shapes (after a bitwise check), then exit")
    ap.add_argument("--step-times", action="store_true",
                    help="only the model families' train steps of phase 9, "
                         "5 timed steps each, then one under the profiler, "
                         "then exit")
    ap.add_argument("--serving", action="store_true",
                    help="only phases 11 and 14, the serving "
                         "configurations and long_500k, then exit")
    ap.add_argument("--trainer", action="store_true",
                    help="only phase 12, the production trainer, then exit")
    ap.add_argument("--processes", action="store_true",
                    help="only phase 13, the trainer's client ranks spread "
                         "over processes, and experiment3, then exit")
    ap.add_argument("--loss-jump", action="store_true",
                    help="only ROADMAP C5's bisection: DIANA-RR at 2 layers "
                         "for 3 steps over widths, transports and meshes, "
                         "then exit")
    ap.add_argument("--dry-run", action="store_true",
                    help="only phase 15, after phase 7's first step and 13 "
                         "(f)'s W = 8 trainer, then exit")
    ap.add_argument("--src", type=Path, default=ROOT / "src",
                    help="the port's source tree to import and build (another"
                         " checkout's src/, to time its kernels on the same "
                         "card); default: the src/ next to this script")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    # cuBLAS picks deterministic algorithms only with a fixed workspace; the
    # cuda-vs-reference train steps need them (set before CUDA starts)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    # the full-width train step peaks near 70 GB in leaf-sized blocks of
    # different sizes: growable segments keep the cache from fragmenting
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    try:
        import torch
    except ImportError:
        print("chip_smoke: FAIL: PyTorch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: FAIL: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(args.src.resolve()))
    try:
        from repro_torch.kernels import _build
    except ImportError as exc:
        print(f"chip_smoke: FAIL: the port is not next to this script "
              f"({exc})", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    try:
        card = card_line()
        print(card, flush=True)
        print(f"torch {torch.__version__} cuda {torch.version.cuda} "
              f"python {sys.version.split()[0]}", flush=True)

        t0 = time.perf_counter()
        _build.build(verbose=True)
        _build.library()
        print(f"build: {time.perf_counter() - t0:.1f} s -> {_build.library_path()}",
              flush=True)
        if args.kernel_times:
            kernel_times(torch, dev, args.src)
            return 0
        if args.step_times:
            phase_families(torch, dev, steps=5, profile_steps=1, tp_steps=5)
            return 0
        if args.loss_jump:
            loss_jump(torch, dev)
            return 0
        if args.serving:
            with phase_clock("11"):
                phase_serving(torch, dev)
            with phase_clock("14"):
                phase_long(torch, dev)
            return 0
        if args.trainer:
            with phase_clock("12"):
                phase_trainer(torch, dev)
            return 0
        if args.processes:
            with phase_clock("13"):
                phase_processes(torch, dev)
            return 0
        if args.dry_run:
            dry_run_alone(torch, dev)
            return 0

        with phase_clock("3"):
            records = phase_kernels(torch, dev)
        with phase_clock("4"):
            launches, problem = phase_main_path(torch, dev)
        with phase_clock("5"):
            phase_profile(torch, dev, problem)
        del problem
        torch.cuda.empty_cache()
        with phase_clock("6"):
            records.update(phase_wire_kernels(torch, dev))
        with phase_clock("7"):
            train_launches = phase_train(torch, dev)
        with phase_clock("8"):
            phase_train_cuda_vs_reference(torch, dev)
        with phase_clock("9"):
            phase_families(torch, dev)
        with phase_clock("10"):
            phase_families_cuda_vs_reference(torch, dev)
        with phase_clock("11"):
            phase_serving(torch, dev)
        with phase_clock("12"):
            phase_trainer(torch, dev)
        torch.cuda.empty_cache()
        with phase_clock("14"):  # before 13, whose (k) is its part (c)
            phase_long(torch, dev)
        torch.cuda.empty_cache()
        with phase_clock("13"):
            phase_processes(torch, dev)
        torch.cuda.empty_cache()
        with phase_clock("15"):
            phase_dry_run(torch, dev)
    except (SmokeFailure, RuntimeError, ValueError, OSError,
            subprocess.SubprocessError) as exc:
        print(f"chip_smoke: FAIL: {type(exc).__name__}: {exc}", file=sys.stderr)
        return 1

    sources = {"randk_mask": ("src/repro_torch/kernels/csrc/randk_mask.cu",
                              "src/repro/kernels/randk.py:158"),
               "diana_shift_update": ("src/repro_torch/kernels/csrc/diana_shift.cu",
                                      "src/repro/kernels/diana_shift.py:58"),
               "qsgd_quantize": ("src/repro_torch/kernels/csrc/qsgd.cu",
                                 "src/repro/kernels/qsgd.py:50"),
               "randk_compress": ("src/repro_torch/kernels/csrc/randk_rows.cu",
                                  "src/repro/kernels/randk.py:56"),
               "randk_decompress": ("src/repro_torch/kernels/csrc/randk_rows.cu",
                                    "src/repro/kernels/randk.py:94"),
               "pack_slab": ("src/repro_torch/kernels/csrc/pack.cu",
                             "src/repro/kernels/pack.py:142"),
               "unpack_slab": ("src/repro_torch/kernels/csrc/pack.cu",
                               "src/repro/kernels/pack.py:174"),
               "unpack_reduce": ("src/repro_torch/kernels/csrc/pack.cu",
                                 "src/repro/kernels/pack.py:199")}
    # each kernel's launches from the path it was ported for: the simulator
    # round's three, the train path's five wire kernels
    path_launches = {**launches, **{k: train_launches[k] for k in WIRE_KERNELS}}
    kernels = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
                "launches": path_launches[name],
                "max_abs_err": records[name]["max_abs_err"],
                "ms": records[name]["ms"], "plain_ms": records[name]["plain_ms"],
                "bound_ms": records[name]["bound_ms"],
                "bound_by": records[name]["bound_by"], "library_ms": None}
               for name, (src, rep) in sources.items()]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
