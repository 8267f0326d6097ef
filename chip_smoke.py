#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU (built for H100,
sm_90a). Run from the repository root:

  python3 chip_smoke.py

Every phase runs in strict f32 (`device.strict_f32`: TF32 off for cuBLAS
and cuDNN, cuDNN's deterministic algorithms), set once at the start.
Phases, each printing one JSON line; any failure raises and exits non-zero:
  build        compile every CUDA source of the port from src/repro_torch/csrc
               with nvcc (sm_90a), all at once, with ptxas's report (each
               kernel instance's name, registers and spills)
  check        hold K1 against its plain PyTorch version on the card, at the
               serving shapes (head_dim 64 GQA; head_dim 256 MQA, window
               2048) and a sweep (dtypes, ragged lengths, head dims, window,
               q shorter than kv, kv longer than the window, non-causal,
               one key): every case within 2e-2 (bf16) / 2e-5 (f32) of the
               plain version, and each bf16 output row within 8 bf16 ulps
               of its largest value in the f32 reference
               (`ref.attention_row_ratio`, printed per case)
  comm_check   hold K2 to K6 against their plain versions, bit-exact, at
               ragged sizes, on misaligned views, on bf16 edge values and (K5,
               K6) on 1 and 4 rows, blocks 64 / 128 / 256, int8 edge blocks
               and stochastic bits 0, 0xFFFFFFFF and random; K2 to K4 also
               on Eq. (1) edge pairs (subnormals, overflow, +-inf, NaN,
               signed zeros; NaN compared as NaN; K2 also at the
               fractional P_eff 12.0 and 40 / 3 of elastic membership), at
               the stream ring's boundaries (one chunk - 1 and + 1, one
               turn of the ring + 1),
               on views whose misalignment x, y and out share (the ring's
               scalar head) and on views where they do not
  scan_check   hold K7 against its plain version within 1e-4 for f32 and
               bf16 x / Bm / Cm alike (both upcast the same bf16 values
               exactly and compute in f32): zero and random h0, S = 1, S =
               1000 (ring wraps and a ragged last tile), Di = 1, Di = 100 in
               bf16 (200-byte rows: plain loads of x), Di = 8200 (ragged
               edge), N = 1, 12 and 32, Bm / Cm as column views at dt_rank
               256 and at an odd dt_rank (7: plain loads off a 16-byte
               boundary), and the serving prefill's (4, 1024, 8192, 16)
  rglru_check  hold K8 against its plain version, bit for bit: f32 and bf16
               a / gx, zero and random h0, S = 1, W = 4100 (ragged edge),
               and the serving prefill's (4, 1024, 4096)
  scan_bwd_check
               hold K7-bwd (through its binding) against its plain backward
               run in f64 on the same inputs and random cotangents of y and
               h_final: each of dx, ddt, dA, dBm, dCm, dh0 within 1e-4 of its
               largest magnitude (f32 outputs) or one bf16 ulp of it (2^-7,
               the bf16 gradients of bf16 x / Bm / Cm), and two launches the
               same bits; scan_check's sweep, then falcon-mamba-7b's train
               shape (2, 256, 8192, 16) f32 with and without a cotangent of
               h_final
  rglru_bwd_check
               hold K8-bwd against its plain backward bit for bit, with and
               without a cotangent of h_final: rglru_check's sweep and
               recurrentgemma-9b's train shape (2, 256, 4096)
  serve        Engine.generate on llama3.2-1b at full size (16 layers, bf16,
               seeded random weights): batch 4, prompt 1024, 32 new greedy
               tokens. K1 launches per prefill are counted; the prefill's
               last logits are held against a teacher-forced plain forward
               (bf16), and prefill + decode against it in f32 with 2 layers
  serve_mamba  Engine.generate on falcon-mamba-7b at full size (64 layers,
               bf16, seeded random weights): batch 4, prompt 1024, 32 new
               greedy tokens. K7 launches are counted per prefill (64) and
               in decode (0); the prefill's last logits are held against a
               teacher-forced forward whose scan is the plain version (bf16),
               and prefill + decode against it in f32 with 2 layers
  serve_rgemma Engine.generate on recurrentgemma-9b at full size (38 layers,
               bf16, seeded random weights): batch 4, prompt 1024, 32 new
               greedy tokens. K8 (26) and K1 at head_dim 256 (12) launches
               are counted per prefill, and 0 of each in decode; the
               prefill's last logits are held against a teacher-forced
               forward through plain attention and the plain scan (bf16),
               and prefill + decode against it in f32 with 5 layers (one
               repeat and the two-layer remainder). Then, on the same
               weights, a generate past the local-attention window (batch 1,
               prompt 3072 > 2048, 8 new tokens): prefill rolls the ring,
               decode wraps it, and every step's logits are held against
               the plain teacher-forced forward
  serve_moe    Engine.generate on granite-moe-3b-a800m at full size (32
               layers, 40 experts top 8, bf16, seeded random weights): batch
               4, prompt 1024, 32 new greedy tokens; K1 launches per prefill
               (32) and in decode (0); every reference forward pinned to
               the kernel path's expert indices (each layer's top-k per
               token, recorded by patching `moe.top_k_lowest_index_first`):
               K1 and plain attention differ by ulps, and each can move a
               token's top-k set, so unpinned the layers carry whole expert
               swaps (the unpinned error and its routing flips are printed,
               unheld). The held logits are the timed prefill's, bit for bit
               the recording prefill's. They are held to the plain forward
               in f32: no farther from it than the plain bf16 forward, plus
               8 ulps of its largest, that distance itself under a ceiling
               of 4 + layers / 2 ulps (on an H100, over 32 layers the two
               bf16 paths are 14 ulps apart, each 13 to 17 from f32; see
               `pinned_hold`); the same at the first 2, 4, 8 and 16 layers,
               and at 2 and 4 the two bf16 paths within 8 ulps of each
               other. The prefill's drop fraction;
               prefill + decode against a teacher-forced forward in f32
               with 2 layers at capacity factor E / K (the reference tests'
               `_no_drop`: a decode step drops nothing, a teacher-forced
               group of 256 tokens may)
  serve_moe_variants
               moonshot-v1-16b-a3b (64 experts top 6 and a shared branch, MHA
               16 / 16) and mixtral-8x22b (8 experts top 2, GQA 48 / 8,
               window 4096, which covers the prompt) at full width, 2 layers
               each (at full depth 57.8 and 281 GB in bf16), bf16: prefill
               only at batch 4, prompt 1024; K1 at head_dim 128 twice per
               prefill; the last logits held as serve_moe holds them, and
               the two bf16 paths within 8 ulps of each other
  train_moe    run_training with DASO on granite-moe-3b-a800m at full width,
               4 of its 32 layers, f32, with the train cell's settings (R =
               4, P = 16, b_max 4, sgd(0.9, 1e-4), lr 0.005, 2 x 256 tokens
               per replica), macro executor: K2 per receive and K3 per
               blocking step, the loss falls, every step's mean load-balance
               and z losses finite and non-zero; ms per step by cycle shape,
               peak, wire bytes per exchange, the drop fraction per layer
  serve_dense128
               qwen3-8b (qk-norm, GQA 32 / 8) and minitron-8b (GQA 32 / 8,
               vocab 256000) at their published size (36 and 32 layers,
               head_dim 128, bf16, seeded random weights): batch 4, prompt
               1024, a warm-up, 3 timed prefills and 32 new greedy tokens
               through Engine.generate; K1 launches n_layers per prefill and
               none in decode; the timed prefill's last logits held as
               serve_moe holds them, without a routing to pin (`dense_hold`:
               no farther from the plain f32 forward than the plain bf16
               forward plus 8 ulps, that distance under 4 + layers / 2 ulps,
               and at 4 layers the two bf16 paths within 8 ulps of each
               other); the f32 forward at full depth where its weights fit
               beside the bf16 ones (`f32_depth`), else at the deepest depth
               that fits, with the cut in `reduced`; prefill + decode
               against a teacher-forced forward in f32 with 2 layers
  serve_prefix qwen2-vl-2b (M-RoPE, GQA 12 / 2, tied, a 256-row stub prefix)
               and musicgen-large (MHA 32 / 32 at head_dim 64, sinusoidal
               positions, a 64-row stub prefix) at their published size (28
               and 48 layers, bf16): as serve_dense128 with seeded stub
               prefixes 0.1 x N(0, 1) in bf16 through
               Engine.generate(..., prefix_embeds=), K1 at Sq = Sk = 1280 and
               1088 (ragged against the D = 64 kernel's 128-row tile); for
               qwen2-vl also one prefill on explicit (B, S, 3) positions whose
               streams differ (the stub's 16 x 16 grid, t = 0, h = row, w =
               col, then the text on all three), held by the same rules
               (equal streams make M-RoPE plain RoPE, so the Engine's own
               positions never exercise the sections); the f32 2-layer
               check with the prefix
  train_vlm    run_training with DASO on qwen2-vl-2b at full width, 4 of its
               28 layers, f32, with the train cell's settings and 24 steps on
               the macro executor, each replica's batch 2 x 256 tokens after
               a seeded 256-row stub prefix (labels -1 over the prefix): K2
               per receive and K3 per blocking step, the loss falls, the carry
               finite; ms per step by cycle shape, peak, wire bytes per
               exchange
  recurrent_grad_hold
               at the recurrent train cells' widths (1 layer, f32), one
               replica's loss gradient through K7 / K7-bwd and K8 / K8-bwd
               against the same gradient with ops.ssm_scan / ops.rglru_scan
               swapped for their plain versions (autograd through
               kernels/ref.py): every leaf within 1e-3 of its largest
               magnitude, each kernel launched once on the kernel path and
               never on the plain one
  train_mamba  run_training with DASO on falcon-mamba-7b at its published
               widths (d_model 4096, d_inner 8192, N 16, dt_rank 256, vocab
               65,024), 1 of its 64 layers, f32, the train cell's settings (R
               = 4, P = 16, b_max 4, sgd(0.9, 1e-4), lr 0.005, 2 x 256 tokens
               per replica) and 16 steps on the macro executor: the loss
               falls, the carry finite, K2 per receive and K3 per blocking
               step (each at least once), K7 and K7-bwd once per layer,
               replica and step, K1 never; ms per step by cycle shape, peak,
               wire bytes per exchange
  train_rgemma the same on recurrentgemma-9b at its published widths
               (lru_width 4096, d_ff 12,288, vocab 256,000), 1 of its 38
               layers (an RG-LRU block and its MLP) at R = 2 (P = 8): K8 and
               K8-bwd once per replica and step
  train_check  at full width (1 layer, f32, R = 4): a receive and a blocking
               step, an int8 send and an int8 blocking step, and an ov_sync
               step with extra staleness 1 (int8), each through the kernels,
               give the same carry as the same step with the exchange
               computed by the plain versions
  train_resume run_training at full width (1 layer, f32, R = 4) with the
               int8 wire and the one_cycle overlap on the macro executor (a
               4-slot carry, the exchange on its own stream): 16 steps with
               one TrainState written mid-run into a temporary directory
               (after checking the disk's free space against the carry's
               bytes), then run_training resumed from it: the final carry
               (params, momentum, in-flight and pending of every replica)
               and the loss trace bit for bit the uninterrupted run's (the
               carry's tree too, empty lists included), the
               resumed run's K2 / K5 / K6 launches what its modes imply, its
               peak no higher; the checkpoint's bytes, save and load
               seconds (and GB/s), both runs' peaks. The first run is
               traced (obs/trace.py): one checkpoint_save span, at least the
               save's seconds and at most 0.5 s more
  train_int8_overlap
               run_training on the per-step executor at the train phase's
               size with the int8 wire tier and the one-cycle overlap
               schedule: K5 = K6 launches held to the ov_sync + blocking
               steps, K2 to the ov_sync steps, step time by mode, peak
               memory, wire bytes per exchange at each tier
  train_macro_int8_overlap, train_macro_int8_overlap_serial
               the same cell through the macro-cycle executor, each overlap
               cycle's exchange on the executor's own CUDA stream while the
               cycle's local steps run; then again with serial_exchange (the
               exchange waited for before the local steps). Both runs give
               the per-step run's final params bit for bit, the same K2, K5
               and K6 launches; each overlap cycle's K5 runs on a stream
               other than the main one, each blocking step's on the main
               one; the timing legs partition the overlap wall. Dispatches
               per step, programs built, ms per step by cycle shape beside
               the per-step medians, the legs, the hidden fraction 1 -
               visible / blocking, peak memory
  train_trace  the train_macro_int8_overlap cell with a tracer
               (run_training(..., tracer=...), one stream in a temporary
               directory, merged at the end): the carry bit for bit the
               per-step run's and the losses bit for bit the untraced
               macro run's, the same launches; every event valid and the
               merged file sorted; the cycle spans' steps add to 32 and
               their per-level syncs to level_sync_counts; one compile
               instant per program built; one span of each overlap leg per
               overlap cycle; each cycle span at least its cycle's seconds;
               the tracer's own cost below 1 % of the run's wall. Prints the
               span count, total and median ms by name, the events, the
               overhead and the steady overlap cycle walls beside the
               untraced run's
  launch_trace repro_torch.launch.train.main --tiny --steps 12 --trace-out
               T --metrics-out M on the card: T is the merged trace, with
               one run_metadata event and one comm_meters counter, and holds
               what train_trace's trace holds; M's comm_meters rows equal
               level_bytes_report computed here; K2 / K3 launch as the
               modes imply
  train_topo, train_macro_topo
               the train cell on the 3-level topology chip:4 x host:2@50e9 x
               pod:2@25e9 (R = 4, P = 16; the host pairs {0, 1} and {2, 3}
               average their params every B_host = 2 steps between the pod
               level's exchanges), per-step and through the macro-cycle
               executor: K2 / K3 launches held to the pod level's receive
               and blocking steps (the inner syncs launch neither), the host
               syncs counted once per token that carries the host level,
               the host pairs' rows bit for bit after every host step (per
               step, checked outside the timed steps), the two executors'
               history and final carry (params and momentum of every
               replica) bit for bit; the macro run is traced, and its cycle
               spans' host syncs add to the host level's count (with what
               train_trace's trace holds); step ms by mode token and the inner
               sync's cost (local+host less local), ms per cycle shape,
               dispatches per step, peak memory
  train_topo_int8_overlap, train_macro_topo_int8_overlap
               the same topology with the int8 wire and the one_cycle
               overlap, per-step and macro (each overlap cycle's inner
               syncs run in its local steps on the current stream while
               its exchange runs on the executor's stream): the whole carry
               (params, momentum, in-flight and pending of every replica)
               and the history bit for bit between the two, K2 / K5 / K6
               launches as the pod level's modes imply
  train_macro_overlap_fused, train_macro_overlap_per_leaf
               16 steps of the train cell under one_cycle on the paper's wires
               (f32 cycling, bf16 blocking), macro, fused and then per-leaf:
               the per-leaf run's losses and every row of its final carry
               (all four slots) bit for bit the fused run's, K2 / K3 as the
               modes imply (x 11 leaves per-leaf); steady cycle ms, legs, the
               contiguous copies
  train_baselines_gossip, train_baselines_gossip_per_step,
  train_baselines_easgd, train_baselines_downpour
               run_training with the baselines at the train cell's size,
               macro: gossip on the int8 wire (K5 = K6 = exchanges + blocking
               steps; also per-step, its losses and carry bit for bit the
               macro run's), EASGD (f32 elastic mean, bf16 blocking: K3 =
               blocking steps) and DOWNPOUR (bf16 wire: K3 = pushes +
               blocking steps; lr / 16, see BASELINES). Each: a falling loss,
               every replica's params one value after the cool-down, EASGD's
               center and DOWNPOUR's anchor the params; ms per step by cycle
               shape, a local and an exchange step's ms on the final carry,
               peak and allocator retries, wire bytes per exchange
  train_faults_daso, train_faults_gossip
               resilience.run_with_faults through FAULT_EVENTS (a straggler,
               a crash and rejoin, a degraded network) on the DASO train
               cell (traced) and the gossip int8 cell: replica 2's params
               and momentum rows frozen at every cycle boundary from the
               crash to the rejoin, its rows the donors' mean right after the
               rejoin, two membership and two dcn_scale controller events, B
               = 8 while the network is degraded, two invalidations (those
               of the executor and, traced, of the invalidate instants), the
               membership timeline and simulated clock of a CPU rehearsal of
               the plan, K2 at P_eff = 12.0 during the crash (DASO), one
               fault_event span per event and what trace_faults lists
  train_autotune, train_autotune_int8_overlap, train_autotune_empty
               the train_macro_topo cell through run_with_faults with a probe
               round every cycle on the simulated clock (sim_exchange_s):
               replicas 1 and 3 straggle x3 at step 4 and the network between
               the pods falls to 0.25 at step 8 (AUTOTUNE_EVENTS; the
               controller learns of it only from the probe). Held: a
               schedule-changing retune within 3 cycles of the degradation, B
               stretched past b_max, a regrouping that pairs 1 and 3, an
               invalidation, and the retunes, reshuffles, controller events
               and history, membership timeline and simulated clock of a CPU
               rehearsal of the plan; the int8 + one_cycle variant likewise
               (K5 / K6 on this path); the same cell with an empty plan and a
               probe every cycle gives train_macro_topo's losses and final
               carry rows bit for bit
  launch_faults
               repro_torch.launch.train.main --tiny --steps 12 --fault-plan
               --metrics-out on the card: the "resilience" record's keys and
               events, K2 / K3 as the modes imply
  launch_autotune
               repro_torch.launch.train.main --tiny --topology ... --autotune
               on the card prints the startup probe's us per level, retuned,
               b and the periods; then with --fault-plan AUTOTUNE_EVENTS
               --autotune-every 2 one line per retune, one of them changing
               the schedule and one regrouping; K2 / K3 as the modes imply
  train_procs, train_procs_int8_overlap
               the multi-process runtime: python -m repro_torch.launch.procs
               runs the launcher's train cell at full width, 1 of 16 layers,
               f32, on chip:4 x host:2@50e9 x pod:2@25e9 (the host syncs stay
               in a process, the pod exchange crosses processes over gloo),
               10 steps, --ckpt at the end, once with 1 process and once with
               2 sharing the card; the second phase on the int8 wire with
               --overlap one_cycle --dispatch overlap (each ov_sync's gather
               on a helper thread beside the cycle's local steps). The losses,
               the final params and every replica row of the final carry
               (each process's --proc-report digests) bit for bit; each
               process's K2 / K3 / K5 / K6 launches the one-process run's,
               as the modes imply. Prints the peak per process, gathers and
               bytes per exchange by dtype, ms per gather (D2H, gloo, H2D)
               and GB/s, ms per step by cycle shape beside the one-process
               run's, and (overlap) the gather's ms beside the local steps
               against the wait after them
  train_procs_per_leaf
               train_procs's configuration over 2 processes with
               --exchange-impl per_leaf: losses, final params and every carry
               row bit for bit the fused 2-process run's; gathers per process
               the fused run's x 11 (one per leaf) with the same bytes; K2 / K3
               x 11. Prints ms per gather (D2H, gloo, H2D) and GB/s beside the
               fused gather's
  live_kill    python -m repro_torch.launch.procs --procs 2 --kill 1:6 at
               --tiny on the same topology, --ckpt-every 1: the survivor
               regroups onto one process over every replica, resumes from
               the newest intact TrainState and replays the death; its
               losses and final params equal a one-process run of the same
               crash as a fault plan (resilience.run_with_faults) bit for
               bit; prints the supervisor's detect / regroup / resume s
  resnet_data  SyntheticImages(1000, 224) and 4 steps' batches of 4 x 32
               images, drawn on the host and copied to the card once;
               prints the host seconds (prototypes, batches, copy)
  resnet_check resnet50 at its published size (25,557,032 params, 161
               leaves): one forward and backward of make_resnet_loss on 4
               images on the card and on the CPU path, same params and
               batch, TF32 off: in f32 the loss within 1e-4 relative and the
               logits within 1e-3 of their largest magnitude; in f64 also
               each gradient leaf within 1e-3 of its largest magnitude; each
               f32 gradient leaf's error against the CPU's f64 within
               max(1e-3, 2 x the CPU's f32 error on that leaf), with every
               ReLU pinned to the f64 forward's mask (an f32 forward can flip
               a ReLU whose input is within rounding of zero), and unpinned
               where the card and the CPU flip the same ReLUs; each flipped
               ReLU input within 1e-3 of its layer's largest
  train_resnet, train_resnet_macro, train_resnet_sync
               run_training on resnet50 at its published size (f32, TF32
               off, deterministic cuDNN): DASO (R = 4 of local_world 4,
               b_max 4, 32 images per replica, lr 0.02, 24 steps cycling
               over the 4 data steps: 512 images, each seen 6 times) on the
               per-step executor, then the macro executor, then sync on the
               same 128 images a step. Held: the two DASO carries (params,
               momentum, in-flight of every replica), losses and history bit
               for bit; the mean loss of the last 4 steps below ln 1000
               (fitting those 512 images, not learning the classes); send,
               receive and local in the history; K2 per receive step, K3
               per blocking step, K4 none, and no launch under sync, whose
               loss falls; DASO's last-4 mean loss within 10 % of sync's on
               the same images (benchmarks/figures.py's fig7 comparison).
               Prints ms per step by mode and by cycle shape, peaks, wire
               bytes per exchange
  resnet_arena the per-step run's parameter arena (4 x 25,557,032 f32): a
               wire_roundtrip launches K3 and K4 once each; K2 to K4 bit
               for bit their plain versions there, with ms and bounds
  launch_ablation
               python -m repro_torch.launch.ablation --steps 12 on the card
               (the CNN's entry point): exits 0, prints every run, and the
               macro and per-step loss traces are equal
  train        run_training with DASO on llama3.2-1b at full width, 4 of its
               16 layers, f32, R = 4 replicas: 32 steps on the per-step
               executor, K2 and K3 launches held to the schedule's receive
               and blocking steps, step time by mode, peak memory
  train_macro  the train cell through the macro-cycle executor (the
               launcher's default): the final carry (params and momentum of
               every replica) bit for bit the train phase's, the same K2 and
               K3 launches; dispatches per step, programs built, fallback
               steps, ms per step by cycle shape, peak memory
  train_macro_per_leaf
               the train_macro cell with exchange_impl="per_leaf": its losses
               and every row of its final carry (params, momentum, in-flight;
               row digests) bit for bit train_macro's, K2 once per receive
               step and floating leaf and K3 once per blocking step and
               floating leaf (11 leaves); ms per step by cycle shape beside
               train_macro's, the contiguous copies the launches needed (count,
               bytes), the peaks
  train_faults_empty
               run_with_faults with an empty plan on the train cell:
               train_macro's losses and final carry bit for bit
  train_topo_2level
               the train cell on the 2-level spec chip:4 x pod:4 through the
               macro-cycle executor: the stock strategy and controller, and
               train_macro's final carry and losses bit for bit
  arena        K2 to K6 held bit-exact against their plain versions on the
               final carry's parameter and momentum arenas (4 x N f32; K2
               also at P_eff 12.0 and 40 / 3); a
               wire_roundtrip of the parameters launches K3 and K4
  timing       each kernel, its plain version and the library call, at the
               serving shapes (K1 at head_dim 64, 256 and, at moonshot's and
               mixtral's prefills, 128; K7, K8) and the training arena (K2 to
               K6); K1's rows also give the bf16 kernel's tiles, ptxas's
               registers and spills for the instance, and the wrapper's
               host time per call; K2 to K4's the stream ring's choice,
               ptxas's registers and spills, and the achieved TB/s; K7's
               the design's choice (lanes, channels per CTA, tile, stages,
               resident CTAs per SM), ptxas's registers and spills, the
               inner loop's SASS instructions per exp (cuobjdump) and the
               issue floor they give (fp32_issue_ms), TB/s, exps/s and host
               time per call; K6's library call is the broadcast product
               through views; K7-bwd and K8-bwd at the train cells' shapes
               (with the plain backward's time) and at the serving
               prefill's, each beside its bound
Every phase line carries "wall_seconds", its share of the run (the seconds
since the previous phase line). Then a "timing" phase line, the `kernels`
line, the total line (the whole run's seconds and each phase's), the card's
name and power limit, and as the last line {"ok": true, "device": {...}}.

Exits non-zero without printing a result when no CUDA device is present.
"""
import ast
import collections
import ctypes
import dataclasses
import gc
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import ExitStack, contextmanager

SCRIPT_T0 = time.perf_counter()
SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
sys.path.insert(0, SRC)
# The train phases come close to the card's memory and allocate whole
# arenas at once; growable segments keep the caching allocator's free memory
# usable for them after the serving phases (fixed-size segments left it in
# pieces too small for an arena).
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import compression, daso, flatbuf  # noqa: E402
from repro_torch.core.executor import (DasoStrategy, MacroCycleExecutor,  # noqa: E402
                                       shape_sync_counts)
from repro_torch.core.schedule import split_mode, split_ov  # noqa: E402
from repro_torch.data.synthetic import SyntheticImages, SyntheticLM  # noqa: E402
from repro_torch.device import strict_f32  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.comm_kernels import (bf16_pack_fwd, bf16_unpack_fwd,  # noqa: E402
                                              dequantize_int8_fwd, eq1_merge_fwd,
                                              launch_cast, launch_eq1_merge,
                                              quantize_int8_fwd, ring_config)
from repro_torch.kernels.flash_attention import flash_attention_fwd  # noqa: E402
from repro_torch.launch.distributed import row_digests  # noqa: E402
from repro_torch.kernels.ref import attention_ref, attention_row_ratio  # noqa: E402
from repro_torch.kernels.rglru_scan import rglru_scan_bwd, rglru_scan_fwd  # noqa: E402
from repro_torch.kernels.ssm_scan import (scan_config, ssm_scan_bwd,  # noqa: E402
                                          ssm_scan_bwd_scratch, ssm_scan_fwd)
from repro_torch.models.cnn import init_resnet, resnet_apply  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.lm import forward, init_params, layer_views  # noqa: E402
from repro_torch.obs import meters  # noqa: E402
from repro_torch.obs.trace import (Tracer, load_events, merge_streams,  # noqa: E402
                                   stream_path, validate_event)
from repro_torch.optim.optimizers import sgd  # noqa: E402
from repro_torch.optim.schedules import constant_lr  # noqa: E402
from repro_torch.resilience import FaultPlan, membership, run_with_faults  # noqa: E402
from repro_torch.resilience import supervisor  # noqa: E402
from repro_torch.serve.engine import Engine, make_decode_fn, make_prefill_fn  # noqa: E402
from repro_torch.topo import probe as topo_probe  # noqa: E402
from repro_torch.topo.lower import daso_config_from, make_controller  # noqa: E402
from repro_torch.topo.spec import TopologySpec  # noqa: E402
from repro_torch.tree import leaves, tree_map  # noqa: E402
from repro_torch.train.loop import TrainLoopConfig, build_strategy, run_training  # noqa: E402
from repro_torch.train.step import make_lm_loss, make_resnet_loss  # noqa: E402

ARCH = "llama3.2-1b"
MAMBA_ARCH = "falcon-mamba-7b"
RGEMMA_ARCH = "recurrentgemma-9b"
MOE_ARCH = "granite-moe-3b-a800m"
# full width, 2 layers each: at full depth 57.8 GB and 281 GB in bf16
MOE_VARIANTS, MOE_VARIANT_LAYERS = ("moonshot-v1-16b-a3b", "mixtral-8x22b"), 2
# the MoE holds (`pinned_hold`), all on the kernel path's routing, in bf16
# ulps of the f32 forward's largest last logit: the kernel path within the
# plain bf16 forward's distance from the plain f32 forward plus
# MOE_SLACK_ULPS; that distance, which grows with depth on both bf16 paths
# alike, within `plain_bf16_ceiling_ulps`; and up to MOE_PAIR_LAYERS layers
# the dense cells' rule between the two bf16 paths, MOE_SLACK_ULPS. serve_moe
# also holds granite's first MOE_SWEEP_DEPTHS layers by the same rules.
MOE_SLACK_ULPS, MOE_PAIR_LAYERS, MOE_SWEEP_DEPTHS = 8, 4, (2, 4, 8, 16)
# the dense head_dim 128 cells and the prefix cells, at their published size
DENSE128_ARCHS = ("qwen3-8b", "minitron-8b")
PREFIX_ARCHS = ("qwen2-vl-2b", "musicgen-large")
VLM_ARCH, VLM_STEPS = "qwen2-vl-2b", 24
# what an f32 plain forward needs beside its weights at batch 4, prompt
# 1024 (f32 logits over a 256000-token vocabulary take 4.2 GB): `f32_depth`
# keeps this much of the card free
F32_WORK_BYTES = 12e9
RING_PROMPT, RING_NEW = 3072, 8  # past recurrentgemma-9b's 2048-slot window
BATCH, PROMPT, NEW = 4, 1024, 32
# H100 SXM published dense peaks (NVIDIA data sheet)
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}  # tests/test_kernels.py

# train phase: llama3.2-1b at its published widths, depth cut for memory.
# lr: the quickstart's 0.05 (tuned at d_model 128) diverges at this width
# with sgd(0.9, 1e-4) (NaN by step 34), 0.02 oscillates, 0.01 trains
# noisily, 0.005 trains smoothly (PERF.md, Findings). Steps: 32 (40 until the
# dense and prefix cells joined the script; the wall's budget, PERF.md §7)
# still give warm-up, cycling and cool-down phases (3 + 26 + 3 steps)
TRAIN_LAYERS, TRAIN_R, TRAIN_LOCAL_WORLD, TRAIN_B_MAX = 4, 4, 4, 4
TRAIN_STEPS, TRAIN_SEQ, TRAIN_PER, TRAIN_LR = 32, 256, 2, 0.005

KERNELS = [{
    "name": "flash_attention_fwd",
    "route": "cuda",
    "source": "src/repro_torch/csrc/flash_attention_fwd.cu",
    "replaces": "src/repro/kernels/flash_attention.py:26",
    "counter": flash_attention_fwd,
}, {
    "name": "eq1_merge",
    "route": "cuda",
    "source": "src/repro_torch/csrc/comm_kernels.cu",
    "replaces": "src/repro/kernels/comm_kernels.py:47",
    "counter": eq1_merge_fwd,
}, {
    "name": "bf16_pack",
    "route": "cuda",
    "source": "src/repro_torch/csrc/comm_kernels.cu",
    "replaces": "src/repro/kernels/comm_kernels.py:82",
    "counter": bf16_pack_fwd,
}, {
    "name": "bf16_unpack",
    "route": "cuda",
    "source": "src/repro_torch/csrc/comm_kernels.cu",
    "replaces": "src/repro/kernels/comm_kernels.py:96",
    "counter": bf16_unpack_fwd,
}, {
    "name": "quantize_int8",
    "route": "cuda",
    "source": "src/repro_torch/csrc/comm_kernels.cu",
    "replaces": "src/repro/kernels/comm_kernels.py:113",
    "counter": quantize_int8_fwd,
}, {
    "name": "dequantize_int8",
    "route": "cuda",
    "source": "src/repro_torch/csrc/comm_kernels.cu",
    "replaces": "src/repro/kernels/comm_kernels.py:149",
    "counter": dequantize_int8_fwd,
}, {
    "name": "ssm_scan",
    "route": "cuda",
    "source": "src/repro_torch/csrc/ssm_scan.cu",
    "replaces": "src/repro/kernels/ssm_scan.py:19",
    "counter": ssm_scan_fwd,
}, {
    "name": "rglru_scan",
    "route": "cuda",
    "source": "src/repro_torch/csrc/rglru_scan.cu",
    "replaces": "src/repro/kernels/rglru_scan.py:16",
    "counter": rglru_scan_fwd,
}, {
    # the backwards have no Pallas kernel: the JAX package differentiates
    # the two scans with jax.grad; "replaces" names the function it
    # differentiates
    "name": "ssm_scan_bwd",
    "route": "cuda",
    "source": "src/repro_torch/csrc/ssm_scan_bwd.cu",
    "replaces": "src/repro/models/mamba.py:62",
    "counter": ssm_scan_bwd,
}, {
    "name": "rglru_scan_bwd",
    "route": "cuda",
    "source": "src/repro_torch/csrc/rglru_scan_bwd.cu",
    "replaces": "src/repro/models/mamba.py:101",
    "counter": rglru_scan_bwd,
}]
SOURCES = sorted({os.path.basename(k["source"])[:-3] for k in KERNELS})
COMM_KERNELS = [k for k in KERNELS if k["source"].endswith("comm_kernels.cu")]

# f32 values where a bf16 cast can go wrong: ties to even, values above the
# largest bf16 (round to inf), infinities, signed zeros, f32 subnormals
BF16_EDGES = [1 + 2 ** -8, 1 + 3 * 2 ** -8, -(1 + 2 ** -8), 3.3961e38, 3.3962e38,
              3.4e38, -3.4e38, float("inf"), float("-inf"), 0.0, -0.0, 1e-40, -1e-40,
              1.4e-45, 1.17e-38, 9e-39, 1.0, -2.5]

# Eq. (1) edges, taken pairwise (x from the first list, y from the second):
# subnormal inputs and results, s2 * x or p * y past the largest f32 (inf),
# infinities, NaN, signed zeros
EQ1_X = [0.0, -0.0, 1e-40, -1e-40, 1.4e-45, 9e-39, 1.2e-38, 1e-36, 1.17e-38, 3e38,
         -3e38, 3.4e38, float("inf"), float("-inf"), float("nan"), 1.0, -2.5, 2e37]
EQ1_Y = [0.0, -0.0, -9e-39, 1e-40, 1.4e-45, 1e-38, 3e38, -3e38, 2.2e37, -2.2e37,
         float("inf"), float("-inf"), float("nan"), 1.0, -1.0, 1e-30]

# Eq. (1)'s (S, P, E) on the card's paths: P = 16 (R = 4 nodes of 4), the
# overlap schedule's extra staleness, and the fractional P_eff = P n_active / R
# of elastic membership (12.0: one of 4 replicas down; 40 / 3 = 16 * 5 / 6)
EQ1_WEIGHTS = ((1, 16, 0), (3, 16, 1), (1, 12.0, 0), (2, 40 / 3, 0))

# the stream ring's instance of each of K2 to K4 at the training arena's
# dtypes, as ptxas names it (f32 Eq. (1), f32 -> bf16, bf16 -> f32)
RING_INSTANCES = {"eq1_merge": "stream_ring_kernelINS_8Eq1MergeIfEE",
                  "bf16_pack": "stream_ring_kernelINS_4CastIf13__nv_bfloat16EE",
                  "bf16_unpack": "stream_ring_kernelINS_4CastI13__nv_bfloat16fEE"}
# (entry, input dtype, output dtype) of the casts K3 and K4
CASTS = [("bf16_pack", torch.float32, torch.bfloat16),
         ("bf16_pack", torch.bfloat16, torch.bfloat16),
         ("bf16_unpack", torch.bfloat16, torch.float32),
         ("bf16_unpack", torch.bfloat16, torch.bfloat16)]

# (name, B, Hq, Hk, Sq, Sk, D, dtype, window, causal)
CHECKS = [
    ("serve_shape_bf16", 4, 32, 8, 1024, 1024, 64, torch.bfloat16, 0, True),
    ("serve_shape_f32", 4, 32, 8, 1024, 1024, 64, torch.float32, 0, True),
    ("ragged_500_bf16", 4, 32, 8, 500, 500, 64, torch.bfloat16, 0, True),
    ("ragged_500_f32", 2, 8, 2, 500, 500, 64, torch.float32, 0, True),
    ("d32_f32", 2, 8, 2, 384, 384, 32, torch.float32, 0, True),
    ("d128_f32", 2, 8, 2, 384, 384, 128, torch.float32, 0, True),
    ("d128_bf16", 2, 8, 2, 384, 384, 128, torch.bfloat16, 0, True),
    ("window64_f32", 2, 8, 2, 700, 700, 64, torch.float32, 64, True),
    ("window64_bf16", 4, 32, 8, 1024, 1024, 64, torch.bfloat16, 64, True),
    ("q_suffix_f32", 2, 8, 2, 256, 1024, 64, torch.float32, 0, True),
    ("q_suffix_ragged_f32", 2, 8, 2, 100, 777, 128, torch.float32, 0, True),
    ("q_suffix_ragged_bf16", 2, 8, 4, 37, 555, 32, torch.bfloat16, 0, True),
    # head_dim 256, MQA: recurrentgemma-9b's local attention (window 2048)
    ("d256_serve_shape_bf16", 4, 16, 1, 1024, 1024, 256, torch.bfloat16, 2048, True),
    ("d256_serve_shape_f32", 4, 16, 1, 1024, 1024, 256, torch.float32, 2048, True),
    ("d256_past_window_bf16", 1, 16, 1, 3072, 3072, 256, torch.bfloat16, 2048, True),
    ("d256_past_window_f32", 1, 16, 1, 3072, 3072, 256, torch.float32, 2048, True),
    ("d256_q_suffix_bf16", 2, 16, 1, 256, 1024, 256, torch.bfloat16, 2048, True),
    ("d256_q_suffix_window_f32", 2, 16, 1, 256, 1024, 256, torch.float32, 300, True),
    ("d256_ragged_bf16", 2, 16, 1, 333, 777, 256, torch.bfloat16, 300, True),
    ("d256_ragged_f32", 1, 8, 1, 500, 500, 256, torch.float32, 0, True),
    # non-causal, D 32 at the serving GQA ratio, a windowed q suffix, one key
    ("noncausal_bf16", 4, 32, 8, 1024, 1024, 64, torch.bfloat16, 0, False),
    ("noncausal_d256_bf16", 4, 16, 1, 1024, 1024, 256, torch.bfloat16, 0, False),
    ("noncausal_window64_bf16", 2, 8, 2, 700, 700, 64, torch.bfloat16, 64, False),
    ("d32_ragged_500_bf16", 4, 32, 8, 500, 500, 32, torch.bfloat16, 0, True),
    ("d128_q_suffix_window_bf16", 2, 8, 2, 300, 1000, 128, torch.bfloat16, 200, True),
    # head_dim 128 at the MoE variants' prefills: moonshot-v1-16b-a3b (MHA
    # 16 / 16) and mixtral-8x22b (GQA 48 / 8, window 4096)
    ("d128_moonshot_shape_bf16", 4, 16, 16, 1024, 1024, 128, torch.bfloat16, 0, True),
    ("d128_mixtral_shape_bf16", 4, 48, 8, 1024, 1024, 128, torch.bfloat16, 4096, True),
    # granite-moe-3b-a800m's prefill: GQA 24 / 8 (ratio 3) at head_dim 64
    ("granite_shape_bf16", 4, 24, 8, 1024, 1024, 64, torch.bfloat16, 0, True),
    ("granite_shape_f32", 4, 24, 8, 1024, 1024, 64, torch.float32, 0, True),
    ("sk1_bf16", 2, 8, 2, 1, 1, 64, torch.bfloat16, 0, True),
    # the prefills of serve_dense128 and serve_prefix: qwen3-8b and
    # minitron-8b (GQA 32 / 8, head_dim 128), qwen2-vl-2b (GQA 12 / 2, a
    # group of 6, prefix 256 + prompt 1024) and musicgen-large (MHA at
    # head_dim 64, prefix 64 + prompt 1024: ragged against the 128-row tile)
    ("qwen3_shape_bf16", 4, 32, 8, 1024, 1024, 128, torch.bfloat16, 0, True),
    ("minitron_shape_bf16", 4, 32, 8, 1024, 1024, 128, torch.bfloat16, 0, True),
    ("qwen2vl_prefix_shape_bf16", 4, 12, 2, 1280, 1280, 128, torch.bfloat16, 0, True),
    ("musicgen_prefix_shape_bf16", 4, 32, 32, 1088, 1088, 64, torch.bfloat16, 0, True),
]


# each phase line carries "wall_seconds", the seconds since the previous
# phase line (the first: since the script started), so the phase lines
# partition the run; the total line sums them
PHASE_SECONDS = {"_last": SCRIPT_T0, "by_phase": {}}


def emit(obj):
    if "phase" in obj:
        now = time.perf_counter()
        obj = {**obj, "wall_seconds": now - PHASE_SECONDS["_last"]}
        PHASE_SECONDS["_last"] = now
        by_phase = PHASE_SECONDS["by_phase"]
        by_phase[obj["phase"]] = by_phase.get(obj["phase"], 0.0) + obj["wall_seconds"]
    print(json.dumps(obj), flush=True)


def emit_total():
    """The whole run's seconds and each phase's (phases that print several
    lines summed), before the card line."""
    by_phase = PHASE_SECONDS["by_phase"]
    print(json.dumps({"total_wall_seconds": time.perf_counter() - SCRIPT_T0,
                      "phase_seconds_sum": sum(by_phase.values()),
                      "wall_seconds_by_phase": by_phase}), flush=True)


def sync():
    torch.cuda.synchronize()


def qkv(B, Hq, Hk, Sq, Sk, D, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randn(s, generator=g, device="cuda").to(dtype)
                 for s in ((B, Hq, Sq, D), (B, Hk, Sk, D), (B, Hk, Sk, D)))


def cuda_ms(fn, iters, warmup=3):
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / iters


def host_us(fn, iters=100):
    """Host time per call (the launch is queued, not waited for)."""
    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    us = 1e6 * (time.perf_counter() - t0) / iters
    sync()
    return us


def ptxas_instances(report):
    """{kernel instance: {"registers": n, "spill_stores": b, "spill_loads": b}}
    from nvcc's -Xptxas -v report."""
    out, name = {}, None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            out[name] = {}
        elif name and "spill stores" in line:
            words = line.replace(",", "").split()
            out[name]["spill_stores"] = int(words[words.index("spill") - 2])
            out[name]["spill_loads"] = int(words[-4])
        elif name and "Used" in line and "registers" in line:
            words = line.replace(",", "").split()
            out[name]["registers"] = int(words[words.index("registers") - 1])
    return out


def bf16_tiles(lib, D):
    """The bf16 kernel's {block_q, block_kv, stages, smem_bytes} at head dim D,
    or None for a build without the query."""
    fn = getattr(lib, "flash_attention_bf16_tiles", None)
    if fn is None:
        return None
    out = (ctypes.c_int * 4)()
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
    if fn(D, out):
        return None
    return dict(zip(("block_q", "block_kv", "stages", "smem_bytes"), out))


def stream_extras(report, kernel, ring, nbytes, ms):
    """K2 to K4's row additions: ptxas's report of the kernel's stream-ring
    instance at the training arena's dtypes (registers, spills), the ring's
    choice (`comm_kernels.ring_config`) and the achieved TB/s."""
    name, regs = next((n, r) for n, r in ptxas_instances(report).items()
                      if RING_INSTANCES[kernel] in n)
    return {"ptxas": {"instance": name, **regs}, "ring": ring,
            "tb_per_s": nbytes / ms / 1e9}


def attended_pairs(Sq, Sk, causal, window):
    """(query, key) pairs the mask keeps: the work this input needs."""
    n = 0
    for r in range(Sk - Sq, Sk):
        hi = r + 1 if causal else Sk
        lo = max(0, r - window + 1) if window else 0
        n += max(0, hi - lo)
    return n


def attention_bound_ms(q, k, v, window):
    B, Hq, Sq, D = q.shape
    Sk = k.shape[2]
    flops = 4 * D * B * Hq * attended_pairs(Sq, Sk, True, window)  # QK^T + PV
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()  # q, k, v, o
    t_ops, t_bytes = flops / PEAK_FLOPS[q.dtype], nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def k1_extras(reports, q, k, v, window):
    """K1's row additions at these inputs: the bf16 kernel's tiles, ptxas's
    report of its instance (registers, spills) and the wrapper's host time
    per call, the tensor-map encoding included."""
    D = q.shape[-1]
    name, report = next((n, r) for n, r in ptxas_instances(
        reports["flash_attention_fwd"]).items() if f"fwd_kernel_bf16ILi{D}E" in n)
    return {"tiles": bf16_tiles(ops.kernel_library("flash_attention_fwd"), D),
            "ptxas": {"instance": name, **report},
            "host_us": host_us(lambda: ops.flash_attention(q, k, v, window=window))}


def phase_build():
    """One nvcc per source, all started together."""
    def one(name):
        t0 = time.perf_counter()
        report = ops.build(name)
        return {"source": name, "seconds": time.perf_counter() - t0, "report": report,
                "ptxas": [ln.strip() for ln in report.splitlines()
                          if "entry function" in ln or "registers" in ln
                          or "spill" in ln]}

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        out = list(pool.map(one, SOURCES))
    emit({"phase": "build", "nvcc_wall_seconds": time.perf_counter() - t0,
          "sources": [{k: v for k, v in o.items() if k != "report"} for o in out]})
    return {o["source"]: o["report"] for o in out}


def phase_check():
    """Every case of CHECKS through `ops.flash_attention`: within 2e-2 (bf16)
    / 2e-5 (f32) of the plain version in the inputs' dtype, and for bf16
    also the per-row rule (`ref.attention_row_ratio` <= 1 against the f32
    reference)."""
    rows = []
    for i, (name, B, Hq, Hk, Sq, Sk, D, dtype, window, causal) in enumerate(CHECKS):
        q, k, v = qkv(B, Hq, Hk, Sq, Sk, D, dtype, seed=100 + i)
        out = ops.flash_attention(q, k, v, causal=causal, window=window)
        sync()
        ref = attention_ref(q, k, v, causal=causal, window=window)
        err = (out.float() - ref.float()).abs().max().item()
        rows.append({"case": name, "shape": [B, Hq, Hk, Sq, Sk, D],
                     "dtype": str(dtype), "window": window, "causal": causal,
                     "max_abs_err": err, "tolerance": TOL[dtype]})
        ok = math.isfinite(err) and err <= TOL[dtype]
        if dtype == torch.bfloat16:
            ref32 = attention_ref(q.float(), k.float(), v.float(), causal=causal,
                                  window=window)
            rows[-1]["row_ratio"] = attention_row_ratio(out, ref32)
            ok = ok and rows[-1]["row_ratio"] <= 1.0
        if not ok:
            emit({"phase": "check", "failed": rows[-1]})
            raise AssertionError(f"kernel check {rows[-1]}")
    emit({"phase": "check", "cases": rows,
          "worst_row_ratio": max(r["row_ratio"] for r in rows if "row_ratio" in r)})
    return rows


def tensor_bytes(tree):
    if isinstance(tree, dict):
        return sum(tensor_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tensor_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def bf16_ulp(x):
    return 2.0 ** (math.floor(math.log2(abs(x))) - 7)


def phase_serve():
    cfg = get_config(ARCH)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(cfg, gen, "cuda")
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=gen,
                            device="cuda")
    eng = Engine(cfg, params, max_len=PROMPT + NEW, device="cuda")
    eng.generate(prompts, 2)  # warm-up: kernel load, cuBLAS handles
    sync()

    for kern in KERNELS:
        kern["counter"].launches = 0
    t0 = time.perf_counter()
    tokens = eng.generate(prompts, NEW)
    sync()
    gen_s = time.perf_counter() - t0
    launches = {kern["name"]: kern["counter"].launches for kern in KERNELS}
    if launches["flash_attention_fwd"] != cfg.n_layers:
        raise AssertionError(f"flash_attention_fwd launched {launches} times in one "
                             f"prefill, expected {cfg.n_layers}")
    if tuple(tokens.shape) != (BATCH, NEW) or not (
            0 <= int(tokens.min()) and int(tokens.max()) < cfg.vocab_size):
        raise AssertionError(f"bad tokens {tokens.shape}")

    with torch.inference_mode():
        prefill = make_prefill_fn(cfg, cache_len=PROMPT + NEW)
        decode = make_decode_fn(cfg)
        sync()
        t0 = time.perf_counter()
        st = prefill(params, prompts)
        sync()
        prefill_ms = 1e3 * (time.perf_counter() - t0)
        cache, nxt = st["cache"], st["logits_last"].argmax(-1, keepdim=True)
        t0 = time.perf_counter()
        for i in range(NEW - 1):
            nxt = decode(params, cache, nxt, PROMPT + i)["logits"].argmax(-1, keepdim=True)
        sync()
        decode_ms = 1e3 * (time.perf_counter() - t0) / (NEW - 1)
        # a decode step reads every weight and the whole KV cache once
        decode_bytes = tensor_bytes(params) + tensor_bytes(cache)

        # bf16: the kernel path against the plain teacher-forced forward
        got = st["logits_last"].float()
        want = forward(params, prompts, cfg, attn_impl="plain")["logits"][:, -1].float()
        peak = want.abs().max().item()
        err = (got - want).abs().max().item()
        # both sides round logits to bf16 (1 ulp) and 16 layers round the
        # attention output and residual to bf16 at different points: 8 ulps
        # of the largest logit
        tol = 8 * bf16_ulp(peak)
        finite = bool(torch.isfinite(got).all())
    del params, eng, cache, st
    torch.cuda.empty_cache()
    if not (finite and err <= tol):
        raise AssertionError(f"bf16 prefill logits: max err {err} > {tol} (finite={finite})")

    f32 = serve_f32_check(cfg, 2, 1, {"flash_attention_fwd": 2})
    emit({"phase": "serve", "arch": ARCH, "layers": cfg.n_layers, "dtype": "bfloat16",
          "batch": BATCH, "prompt": PROMPT, "new_tokens": NEW,
          "launches_per_prefill": launches,
          "generate_s": gen_s, "tokens_per_s": BATCH * NEW / gen_s,
          "prefill_ms": prefill_ms, "decode_ms_per_token": decode_ms,
          "decode_bytes": decode_bytes,
          "decode_bound_ms": 1e3 * decode_bytes / PEAK_BYTES,
          "bf16_last_logits_max_abs_err": err, "bf16_tolerance": tol,
          "max_abs_logit": peak, "f32_2layer": f32})
    return launches


def serve_f32_check(cfg, n_layers, seed, want):
    """Prefill through the kernels + 6 decode steps against a teacher-forced
    forward through plain attention and the plain scans, f32 (TF32 off),
    full width, `n_layers` layers, at tests/test_serve.py's 2e-3. `want`:
    the launches of the prefill (decode launches none). A config with a
    stub prefix (`prefix_embed_len`) takes a seeded one, 0.1 x N(0, 1),
    before the tokens, as tests/test_serve.py does."""
    cfg = cfg.replace(n_layers=n_layers, param_dtype=torch.float32,
                      compute_dtype=torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = init_params(cfg, gen, "cuda")
    B, S, S0, P = 2, 256, 250, cfg.prefix_embed_len
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device="cuda")
    pe = stub_prefix(cfg, B, gen, torch.float32)
    with torch.inference_mode():
        with plain_scan():
            full = forward(params, toks, cfg, attn_impl="plain", prefix_embeds=pe)["logits"]
        zero_counts()
        st = make_prefill_fn(cfg, cache_len=P + S)(params, toks[:, :S0], prefix_embeds=pe)
        per_prefill = counts()
        zero_counts()
        decode = make_decode_fn(cfg)
        cache, logits = st["cache"], [st["logits_last"]]
        for i in range(S - S0):
            out = decode(params, cache, toks[:, S0 + i:S0 + i + 1], P + S0 + i)
            logits.append(out["logits"])
            cache = out["cache"]
        in_decode = counts()
        errs = [(full[:, P + S0 - 1 + i] - lg).abs().max().item()
                for i, lg in enumerate(logits)]
    del params, full, cache, st
    torch.cuda.empty_cache()
    none = no_launches()
    if per_prefill != {**none, **want} or in_decode != none:
        raise AssertionError(f"f32 {n_layers}-layer launches: prefill {per_prefill}, "
                             f"decode {in_decode}, expected prefill {want}")
    if not max(errs) < 2e-3:
        raise AssertionError(f"f32 prefill/decode vs teacher forcing: {errs}")
    return {"max_abs_err": max(errs), "tolerance": 2e-3, "steps": len(errs),
            "layers": n_layers, "prefix": P, "launches_per_prefill": want}


def stub_prefix(cfg, batch, gen, dtype):
    """The vlm / audio frontend's stub: 0.1 x N(0, 1) embeddings (batch,
    prefix_embed_len, d_model) from `gen`, as the reference's tests make
    them; None for a config without a prefix."""
    if not cfg.prefix_embed_len:
        return None
    return (0.1 * torch.randn((batch, cfg.prefix_embed_len, cfg.d_model), generator=gen,
                              device="cuda")).to(dtype)


# K7 checks: (name, B, S, Di, N, dtype, random h0, dt_rank: Bm / Cm as column
# views of one (B, S, dt_rank + 2N) tensor, or 0 for contiguous Bm / Cm).
# One rule for both dtypes: the kernel and its plain version upcast the same
# bf16 inputs exactly and then compute in f32 (tests/test_kernels.py's 5e-2
# is the tolerance between two frameworks, and would pass a kernel that
# dropped precision inside)
SCAN_TOL = 1e-4
SCAN_CHECKS = [
    ("small_f32", 2, 64, 128, 16, torch.float32, False, 0),
    ("small_bf16", 1, 128, 64, 8, torch.bfloat16, False, 0),
    ("random_h0_f32", 3, 37, 100, 4, torch.float32, True, 0),
    ("di100_bf16", 3, 37, 100, 4, torch.bfloat16, True, 0),
    ("random_h0_bf16", 2, 200, 512, 16, torch.bfloat16, True, 0),
    ("s1_f32", 4, 1, 8192, 16, torch.float32, True, 0),
    ("s1_bf16", 4, 1, 8192, 16, torch.bfloat16, True, 256),
    ("s1000_bf16", 2, 1000, 1024, 16, torch.bfloat16, True, 256),
    ("di1_f32", 3, 77, 1, 16, torch.float32, True, 0),
    ("di1_bf16", 2, 40, 1, 16, torch.bfloat16, True, 256),
    ("n12_bf16", 2, 300, 1024, 12, torch.bfloat16, True, 256),
    ("n12_f32", 1, 70, 200, 12, torch.float32, True, 0),
    ("n1_f32", 2, 100, 200, 1, torch.float32, True, 0),
    ("n1_bf16", 2, 65, 1000, 1, torch.bfloat16, True, 256),
    ("odd_rank_bf16", 2, 129, 1024, 16, torch.bfloat16, True, 7),
    ("odd_rank_n12_bf16", 1, 50, 300, 12, torch.bfloat16, False, 7),
    ("di8200_f32", 2, 300, 8200, 16, torch.float32, True, 0),
    ("di8200_bf16_strided", 2, 300, 8200, 16, torch.bfloat16, False, 256),
    ("strided_f32", 2, 129, 1024, 16, torch.float32, True, 256),
    ("n32_f32", 1, 70, 256, 32, torch.float32, True, 256),
    ("serve_shape_f32", 4, 1024, 8192, 16, torch.float32, False, 256),
    ("serve_shape_bf16", 4, 1024, 8192, 16, torch.bfloat16, False, 256),
]


def scan_inputs(B, S, Di, N, dtype, random_h0, dt_rank, seed):
    """K7's inputs on the card, as the mamba mixer makes them: dt from a
    softplus (f32), A = -exp(.) (f32), Bm / Cm column slices of one
    (B, S, dt_rank + 2N) projection, or contiguous for dt_rank 0."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    x = randn(B, S, Di).to(dtype)
    dt = F.softplus(randn(B, S, Di))  # as tests/test_kernels.py:77 draws it
    A = -torch.exp(0.5 * randn(Di, N))
    if dt_rank:
        _, Bm, Cm = randn(B, S, dt_rank + 2 * N).to(dtype).split([dt_rank, N, N], dim=-1)
    else:
        Bm, Cm = randn(B, S, N).to(dtype), randn(B, S, N).to(dtype)
    h0 = randn(B, Di, N) if random_h0 else torch.zeros((B, Di, N), device="cuda")
    return x, dt, A, Bm, Cm, h0


def phase_scan_check():
    """K7 against its plain version: y and the final h, within SCAN_TOL."""
    rows = []
    for i, (name, B, S, Di, N, dtype, random_h0, dt_rank) in enumerate(SCAN_CHECKS):
        args = scan_inputs(B, S, Di, N, dtype, random_h0, dt_rank, seed=200 + i)
        y, h = ops.ssm_scan(*args)
        sync()
        yr, hr = ref.ssm_scan_ref(*args)
        err = max((y - yr).abs().max().item(), (h - hr).abs().max().item())
        rows.append({"case": name, "shape": [B, S, Di, N], "dtype": str(dtype),
                     "random_h0": random_h0, "dt_rank": dt_rank,
                     "max_abs_err": err, "tolerance": SCAN_TOL})
        del args, y, h, yr, hr
        if not (math.isfinite(err) and err <= SCAN_TOL):
            emit({"phase": "scan_check", "failed": rows[-1]})
            raise AssertionError(f"ssm_scan check {name}: {err} > {SCAN_TOL}")
    torch.cuda.empty_cache()
    emit({"phase": "scan_check", "cases": rows})
    return rows


@contextmanager
def plain_scan():
    """The recurrent mixers' scans through the plain versions of K7 and
    K8, so the same forward is the teacher-forced reference."""
    saved = ops.ssm_scan, ops.rglru_scan
    ops.ssm_scan, ops.rglru_scan = ref.ssm_scan_ref, ref.rglru_scan_ref
    try:
        yield
    finally:
        ops.ssm_scan, ops.rglru_scan = saved


def mamba_decode_bytes(params, cache):
    """What one decode step must move: every weight once, but of the
    embedding table only the batch's rows, and the recurrent cache (conv
    window and state) read and written."""
    tok = params["embed"]["tok"]
    return (tensor_bytes(params) - tensor_bytes(tok) + BATCH * tok[0].numel()
            * tok.element_size() + 2 * tensor_bytes(cache))


def plain_hold(cfg, params, prompts, prefill, st):
    """The prefill's bf16 last logits against a teacher-forced forward's
    through plain attention and the plain scans: within 8 ulps of the
    largest. Returns (the prefill's last logits, max abs error, tolerance,
    row additions)."""
    with plain_scan():
        want = forward(params, prompts, cfg, attn_impl="plain")["logits"][:, -1].float()
    got = st["logits_last"].float()
    peak = want.abs().max().item()
    return got, (got - want).abs().max().item(), 8 * bf16_ulp(peak), {"max_abs_logit": peak}


def serve_cell(cfg, seed, want_prefill, decode_bytes, hold=plain_hold):
    """Engine.generate at full size from seeded weights: batch BATCH, prompt
    PROMPT, NEW greedy tokens after a 2-token warm-up; a config with a stub
    prefix (`prefix_embed_len`) takes a seeded one in bf16 (`stub_prefix`)
    before every prompt, and `hold` gets it as `prefix`. Launches are
    counted per generate, per prefill (`want_prefill`, the other kernels
    none) and in decode (none); three prefills are timed (the median
    reported), then the decode steps. The
    prefill's bf16 last logits are held by `hold`: by default against a
    teacher-forced forward through plain attention and the plain scans
    (`plain_hold`; `pinned_hold` for MoE): both round the mixers' outputs,
    the residual and the logits to bf16 at different points, and the scans
    sum in other orders, so a bf16 rounding flips now and then and the
    layers carry it: 8 ulps of the largest logit. Returns (the phase's row,
    params, the generator)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = init_params(cfg, gen, "cuda")
    n_params = sum(x.numel() for x in leaves(params))
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=gen,
                            device="cuda")
    pe, P = stub_prefix(cfg, BATCH, gen, cfg.compute_dtype), cfg.prefix_embed_len
    eng = Engine(cfg, params, max_len=P + PROMPT + NEW, device="cuda")
    eng.generate(prompts, 2, prefix_embeds=pe)  # warm-up: kernel load, cuBLAS handles
    sync()
    torch.cuda.reset_peak_memory_stats()

    zero_counts()
    t0 = time.perf_counter()
    tokens = eng.generate(prompts, NEW, prefix_embeds=pe)
    sync()
    gen_s = time.perf_counter() - t0
    per_generate = counts()
    if tuple(tokens.shape) != (BATCH, NEW) or tokens.dtype != torch.int32 or not (
            0 <= int(tokens.min()) and int(tokens.max()) < cfg.vocab_size):
        raise AssertionError(f"bad tokens {tokens.shape} {tokens.dtype}")

    with torch.inference_mode():
        prefill = make_prefill_fn(cfg, cache_len=P + PROMPT + NEW)
        decode = make_decode_fn(cfg)
        sync()
        times = []
        for _ in range(3):
            st = None
            zero_counts()
            t0 = time.perf_counter()
            st = prefill(params, prompts, prefix_embeds=pe)
            sync()
            times.append(1e3 * (time.perf_counter() - t0))
            per_prefill = counts()
        prefill_ms = statistics.median(times)
        zero_counts()
        cache, nxt = st["cache"], st["logits_last"].argmax(-1, keepdim=True)
        t0 = time.perf_counter()
        for i in range(NEW - 1):
            nxt = decode(params, cache, nxt, P + PROMPT + i)["logits"].argmax(-1, keepdim=True)
        sync()
        decode_ms = 1e3 * (time.perf_counter() - t0) / (NEW - 1)
        in_decode = counts()
        peak = torch.cuda.max_memory_allocated()
        n_bytes = decode_bytes(params, cache)

        got, err, tol, held = hold(cfg, params, prompts, prefill, st,
                                   **({} if pe is None else {"prefix": pe}))
        del prefill, decode
        finite = bool(torch.isfinite(got).all())
        # random weights: the logits must still depend on the prompt (with
        # sinusoidal positions, amplitude 1 against token embeddings of std
        # 0.02, greedy tokens may agree across rows)
        row_spread = (got - got[:1]).abs().max().item()
    del eng, cache, st
    torch.cuda.empty_cache()
    if not row_spread > 0:
        raise AssertionError(f"{cfg.name} last logits do not depend on the prompt")
    none = no_launches()
    if per_prefill != {**none, **want_prefill} or in_decode != none \
            or per_generate != per_prefill:
        raise AssertionError(f"{cfg.name} launches: prefill {per_prefill}, decode "
                             f"{in_decode}, generate {per_generate}")
    if not (finite and err <= tol):
        raise AssertionError(f"bf16 prefill logits: max err {err} > {tol} (finite={finite})")
    row = {"arch": cfg.name, "layers": cfg.n_layers, "dtype": "bfloat16",
           "params": n_params, "batch": BATCH, "prompt": PROMPT, "new_tokens": NEW,
           "prefix": P, "prefill_ms_all": times,
           "launches_per_generate": per_generate, "launches_per_prefill": per_prefill,
           "launches_in_decode": in_decode,
           "generate_s": gen_s, "tokens_per_s": BATCH * NEW / gen_s,
           "prefill_ms": prefill_ms, "decode_ms_per_token": decode_ms,
           "decode_bytes": n_bytes, "decode_bound_ms": 1e3 * n_bytes / PEAK_BYTES,
           "max_memory_allocated": peak,
           "bf16_last_logits_max_abs_err": err, "bf16_tolerance": tol,
           "last_logits_row_spread": row_spread,
           "greedy_rows_distinct": len({tuple(r) for r in tokens.tolist()}), **held}
    return row, params, gen


def mamba_widths(cfg):
    return {"d_model": cfg.d_model, "d_inner": cfg.d_inner, "d_state": cfg.ssm.d_state,
            "d_conv": cfg.ssm.d_conv, "dt_rank": cfg.dt_rank, "vocab": cfg.vocab_size,
            "tie_embeddings": cfg.tie_embeddings}


def phase_serve_mamba():
    cfg = get_config(MAMBA_ARCH)
    row, params, _ = serve_cell(cfg, 3, {"ssm_scan": cfg.n_layers}, mamba_decode_bytes)
    del params
    torch.cuda.empty_cache()
    row["widths"] = mamba_widths(cfg)
    row["f32_2layer"] = serve_f32_check(cfg, 2, 4, {"ssm_scan": 2})
    emit({"phase": "serve_mamba", **row})
    return row["launches_per_generate"]


# K8 checks, bit for bit: (name, B, S, W, dtype of a / gx, random h0)
RGLRU_CHECKS = [
    ("small_f32", 2, 64, 128, torch.float32, False),
    ("small_bf16", 2, 64, 128, torch.bfloat16, True),
    ("s1_f32", 4, 1, 4096, torch.float32, True),
    ("s1_bf16", 4, 1, 4096, torch.bfloat16, False),
    ("w4100_f32", 2, 300, 4100, torch.float32, True),
    ("w4100_bf16", 3, 37, 4100, torch.bfloat16, True),
    ("serve_shape_f32", 4, 1024, 4096, torch.float32, False),
    ("serve_shape_f32_h0", 4, 1024, 4096, torch.float32, True),
    ("serve_shape_bf16", 4, 1024, 4096, torch.bfloat16, True),
]


def rglru_inputs(B, S, W, dtype, random_h0, seed):
    """K8's inputs on the card as the mixer makes them: a in (0, 1) (a
    sigmoid here, exp(log_a) there), gx of either sign, h0 f32."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    a = torch.sigmoid(torch.randn((B, S, W), generator=g, device="cuda")).to(dtype)
    gx = torch.randn((B, S, W), generator=g, device="cuda").to(dtype)
    h0 = (torch.randn((B, W), generator=g, device="cuda") if random_h0
          else torch.zeros((B, W), device="cuda"))
    return a, gx, h0


def phase_rglru_check():
    """K8 against its plain version: hs and the final h, bit for bit (both
    round a * h and then + gx)."""
    rows = []
    for i, (name, B, S, W, dtype, random_h0) in enumerate(RGLRU_CHECKS):
        args = rglru_inputs(B, S, W, dtype, random_h0, seed=300 + i)
        hs, h = ops.rglru_scan(*args)
        sync()
        hsr, hr = ref.rglru_scan_ref(*args)
        exact = same_bits(hs, hsr) and same_bits(h, hr)
        err = max((hs - hsr).abs().max().item(), (h - hr).abs().max().item())
        rows.append({"case": name, "shape": [B, S, W], "dtype": str(dtype),
                     "random_h0": random_h0, "bit_exact": exact, "max_abs_err": err})
        del args, hs, h, hsr, hr
        if not exact:
            emit({"phase": "rglru_check", "failed": rows[-1]})
            raise AssertionError(f"rglru_scan check {name}: not bit-exact ({err})")
    torch.cuda.empty_cache()
    emit({"phase": "rglru_check", "cases": rows})
    return rows


# K7-bwd against the plain backward run in f64 (`ref.ssm_scan_bwd_ref` on f64
# upcasts of the same inputs and cotangents), each output's largest error
# scaled to its largest magnitude: 1e-4 for the f32 outputs (the f32 plain
# backward sits near 1e-6 of it at the train shape's sizes; the kernel sums
# dBm / dCm over the channels and dA over the batch in other orders), one
# bf16 ulp at the top (2^-7) for the bf16 gradients of bf16 x / Bm / Cm.
SCAN_BWD_RTOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -7}
SCAN_BWD_OUTS = ("dx", "ddt", "dA", "dBm", "dCm", "dh0")
MAMBA_TRAIN_SHAPE = (2, 256, 8192, 16)  # (TRAIN_PER, TRAIN_SEQ, d_inner, d_state)
RGEMMA_TRAIN_SHAPE = (2, 256, 4096)     # (TRAIN_PER, TRAIN_SEQ, lru_width)
# every K7 case with a random cotangent of h_final, then the train shape (f32,
# Bm / Cm as views at dt_rank 256) with one and without (training's)
SCAN_BWD_CHECKS = [case + (True,) for case in SCAN_CHECKS] + [
    ("train_shape_f32", *MAMBA_TRAIN_SHAPE, torch.float32, False, 256, True),
    ("train_shape_f32_no_dh", *MAMBA_TRAIN_SHAPE, torch.float32, False, 256, False)]
RGLRU_BWD_CHECKS = RGLRU_CHECKS + [("train_shape_f32", *RGEMMA_TRAIN_SHAPE, torch.float32,
                                    False)]


def scaled_err(got, want):
    """max |got - want| over max |want| (0 where both are 0), in want's dtype."""
    err = (got.to(want.dtype) - want).abs().max()
    return (err / want.abs().max().clamp_min(torch.finfo(want.dtype).tiny)).item()


def cotangents(shapes, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(s, generator=g, device="cuda") for s in shapes]


def phase_scan_bwd_check():
    """K7-bwd through its binding against the f64 plain backward, each of its
    six outputs within SCAN_BWD_RTOL of its largest magnitude, and two
    launches on the same inputs the same bits."""
    lib, rows = ops.kernel_library("ssm_scan_bwd"), []
    for i, (name, B, S, Di, N, dtype, random_h0, dt_rank, with_dh) in enumerate(
            SCAN_BWD_CHECKS):
        args = scan_inputs(B, S, Di, N, dtype, random_h0, dt_rank, seed=400 + i)
        dy, dh = cotangents(((B, S, Di), (B, Di, N)), seed=500 + i)
        dh = dh if with_dh else None
        got = ssm_scan_bwd(lib, *args, dy, dh)
        again = ssm_scan_bwd(lib, *args, dy, dh)
        sync()
        deterministic = all(same_bits(a, b) for a, b in zip(got, again, strict=True))
        del again
        want = ref.ssm_scan_bwd_ref(*(t.double() for t in args), dy.double(),
                                    None if dh is None else dh.double())
        errs = {o: scaled_err(a, w) for o, a, w in zip(SCAN_BWD_OUTS, got, want, strict=True)}
        tols = {o: SCAN_BWD_RTOL[a.dtype] for o, a in zip(SCAN_BWD_OUTS, got)}
        rows.append({"case": name, "shape": [B, S, Di, N], "dtype": str(dtype),
                     "random_h0": random_h0, "dt_rank": dt_rank, "dh": with_dh,
                     "scaled_err": errs, "tolerance": tols,
                     "max_abs_err": max((a.double() - w).abs().max().item()
                                        for a, w in zip(got, want)),
                     "two_launches_identical": deterministic})
        del args, dy, dh, got, want
        if not (deterministic and all(math.isfinite(e) and e <= tols[o]
                                      for o, e in errs.items())):
            emit({"phase": "scan_bwd_check", "failed": rows[-1]})
            raise AssertionError(f"ssm_scan_bwd check {name}: {rows[-1]}")
    torch.cuda.empty_cache()
    emit({"phase": "scan_bwd_check", "cases": rows,
          "worst_scaled_err": {o: max(r["scaled_err"][o] for r in rows)
                               for o in SCAN_BWD_OUTS}})
    return rows


def phase_rglru_bwd_check():
    """K8-bwd through its binding against the plain backward, bit for bit,
    with a random cotangent of h_final and without one; the states hs are
    K8's."""
    lib, rows = ops.kernel_library("rglru_scan_bwd"), []
    for i, (name, B, S, W, dtype, random_h0) in enumerate(RGLRU_BWD_CHECKS):
        a, gx, h0 = rglru_inputs(B, S, W, dtype, random_h0, seed=600 + i)
        hs, _ = ops.rglru_scan(a, gx, h0)
        dhs, dh = cotangents(((B, S, W), (B, W)), seed=700 + i)
        for cot in (dh, None):
            got = rglru_scan_bwd(lib, a, h0, hs, dhs, cot)
            sync()
            want = ref.rglru_scan_bwd_ref(a, gx, h0, hs, dhs, cot)
            exact = all(same_bits(x, w) for x, w in zip(got, want, strict=True))
            err = max((x.float() - w.float()).abs().max().item()
                      for x, w in zip(got, want))
            rows.append({"case": name, "shape": [B, S, W], "dtype": str(dtype),
                         "random_h0": random_h0, "dh": cot is not None,
                         "bit_exact": exact, "max_abs_err": err})
            del got, want
            if not exact:
                emit({"phase": "rglru_bwd_check", "failed": rows[-1]})
                raise AssertionError(f"rglru_scan_bwd check {name}: not bit-exact ({err})")
        del a, gx, h0, hs, dhs, dh
    torch.cuda.empty_cache()
    emit({"phase": "rglru_bwd_check", "cases": rows})
    return rows


def rgemma_decode_bytes(params, cache):
    """What one decode step must move: every weight once (the tied
    embedding table is read whole by the unembedding), the KV caches read,
    and the recurrent state and conv window read and written."""
    recurrent = sum(tensor_bytes(c) for c in cache["groups"] + cache["rem"]
                    if "h" in c)
    return tensor_bytes(params) + tensor_bytes(cache) + recurrent


def rgemma_widths(cfg):
    return {"d_model": cfg.d_model, "lru_width": cfg.lru_width,
            "conv_width": cfg.rglru.conv_width, "c_exponent": cfg.rglru.c_exponent,
            "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads, "head_dim": cfg.head_dim,
            "window": cfg.sliding_window, "d_ff": cfg.d_ff, "vocab": cfg.vocab_size,
            "tie_embeddings": cfg.tie_embeddings}


def phase_serve_rgemma():
    cfg = get_config(RGEMMA_ARCH)
    # layer i has the kind of pattern slot i mod len(pattern): repeats, remainder
    kinds = [cfg.layer_pattern[i % len(cfg.layer_pattern)] for i in range(cfg.n_layers)]
    want = {"rglru_scan": kinds.count("rglru"), "flash_attention_fwd": kinds.count("attn_local")}
    if want != {"rglru_scan": 26, "flash_attention_fwd": 12}:
        raise AssertionError(f"recurrentgemma-9b layer kinds: {want}")
    row, params, gen = serve_cell(cfg, 5, want, rgemma_decode_bytes)
    ring = serve_rgemma_ring(cfg, params, gen, row["launches_per_prefill"])
    del params
    torch.cuda.empty_cache()
    row["widths"] = rgemma_widths(cfg)
    row["f32_5layer"] = serve_f32_check(
        cfg, 5, 6, {"rglru_scan": 4, "flash_attention_fwd": 1})
    emit({"phase": "serve_rgemma", **row})
    emit(ring)
    return row["launches_per_prefill"]


def serve_rgemma_ring(cfg, params, gen, want_prefill):
    """Engine.generate past the local-attention window: batch 1, prompt
    RING_PROMPT > window, RING_NEW new greedy tokens. The attn_local caches
    hold `window` slots, so prefill takes the roll branch and decode
    overwrites the oldest slots. Then the same tokens teacher-forced: the
    prefill's and every decode step's logits against the plain forward of
    the whole sequence, 8 bf16 ulps of the step's largest logit."""
    prompt = torch.randint(0, cfg.vocab_size, (1, RING_PROMPT), generator=gen,
                           device="cuda")
    eng = Engine(cfg, params, max_len=RING_PROMPT + RING_NEW, device="cuda")
    zero_counts()
    t0 = time.perf_counter()
    tokens = eng.generate(prompt, RING_NEW)
    sync()
    gen_s = time.perf_counter() - t0
    per_generate = counts()
    with torch.inference_mode():
        zero_counts()
        st = make_prefill_fn(cfg, cache_len=RING_PROMPT + RING_NEW)(params, prompt)
        per_prefill = counts()
        cache = st["cache"]
        slots = {c["k"].shape[-3] for c in cache["groups"] + cache["rem"] if "k" in c}
        decode = make_decode_fn(cfg)
        zero_counts()
        logits = [st["logits_last"]]
        for i in range(RING_NEW - 1):
            out = decode(params, cache, tokens[:, i:i + 1].long(), RING_PROMPT + i)
            logits.append(out["logits"])
        sync()
        in_decode = counts()
        seq = torch.cat([prompt, tokens[:, :-1].long()], dim=1)
        with plain_scan():
            full = forward(params, seq, cfg, attn_impl="plain")["logits"]
        errs, tols = [], []
        for i, lg in enumerate(logits):
            want = full[:, RING_PROMPT - 1 + i].float()
            errs.append((lg.float() - want).abs().max().item())
            tols.append(8 * bf16_ulp(want.abs().max().item()))
        finite = all(bool(torch.isfinite(lg).all()) for lg in logits)
    del eng, cache, st, full, logits
    torch.cuda.empty_cache()
    none = no_launches()
    if slots != {cfg.sliding_window} or not RING_PROMPT > cfg.sliding_window:
        raise AssertionError(f"ring caches hold {slots} slots, window {cfg.sliding_window}")
    if per_prefill != want_prefill or per_generate != want_prefill or in_decode != none:
        raise AssertionError(f"ring launches: prefill {per_prefill}, decode {in_decode}, "
                             f"generate {per_generate}")
    if not (finite and all(e <= t for e, t in zip(errs, tols))):
        raise AssertionError(f"ring logits vs teacher forcing: {errs} > {tols}")
    return {"phase": "serve_rgemma_ring", "arch": RGEMMA_ARCH, "dtype": "bfloat16",
            "batch": 1, "prompt": RING_PROMPT, "new_tokens": RING_NEW,
            "window": cfg.sliding_window, "ring_slots": sorted(slots),
            "decode_positions": [RING_PROMPT, RING_PROMPT + RING_NEW - 2],
            "launches_per_generate": per_generate, "launches_per_prefill": per_prefill,
            "launches_in_decode": in_decode, "generate_s": gen_s,
            "bf16_step_logits_max_abs_err": errs, "bf16_tolerances": tols}


@contextmanager
def routing(record=None, replay=None):
    """The MoE layers' top-k seen from outside, through
    `moe.top_k_lowest_index_first`: each call's expert indices appended to
    `record` (the layer runs on them as it would alone), or taken in order
    from `replay`, the gates then this path's probabilities at those
    indices. So a reference forward can run on the kernel path's routing.
    A replay must use every recorded call."""
    real, calls = moe.top_k_lowest_index_first, None if replay is None else iter(replay)

    def seen(probs, k):
        if calls is not None:
            idx = next(calls)
            return probs.gather(-1, idx), idx
        vals, idx = real(probs, k)
        record.append(idx)
        return vals, idx

    moe.top_k_lowest_index_first = seen
    try:
        yield
    finally:
        moe.top_k_lowest_index_first = real
    if calls is not None and next(calls, None) is not None:
        raise AssertionError("the replayed routing has more layers than the forward")


def routing_flips(a, b):
    """Per layer, the tokens whose top-k expert set differs between two
    recorded routings."""
    return [int((x.sort(-1).values != y.sort(-1).values).any(-1).sum()) for x, y in zip(a, b)]


def plain_bf16_ceiling_ulps(n_layers):
    """How far the plain bf16 forward may lie from the plain f32 forward on
    one routing, in bf16 ulps of the largest logit, at `n_layers` layers:
    4 + n / 2. Set above the readings on an H100 (granite-moe-3b-a800m at
    2, 4, 8, 16 and 32 layers 2.1, 3.4, 5.5, 8.6 and 16.5; moonshot and
    mixtral at 2 layers 2.0 and 1.4), so that a fault in the MoE or bf16
    code, which both bf16 paths share, cannot widen the kernel path's limit
    without bound."""
    return 4 + n_layers / 2


def pinned_distances(cfg, params, params_f32, prompts, kernel_last, kernel_idx, n_layers,
                     **fwd):
    """The first `n_layers` layers' plain forwards in bf16 and in f32 (the
    same weights upcast; `params_f32` may hold only those layers), both on
    the kernel path's routing `kernel_idx` (empty for a model without MoE),
    against the kernel path's bf16 last logits `kernel_last`. `fwd`: the
    forwards' prefix_embeds / positions. Returns (the distances in ulps of
    the f32 forward's largest last logit, the kernel path's error against
    f32, the plain bf16 forward's aux)."""
    f32 = cfg.replace(n_layers=n_layers, param_dtype=torch.float32,
                      compute_dtype=torch.float32)
    with routing(replay=kernel_idx):
        out = forward(params, prompts, cfg, attn_impl="plain",
                      layers=layer_views(cfg, params)[:n_layers], **fwd)
    plain = out["logits"][:, -1].float()
    aux = {k: v.item() for k, v in out["aux"].items()}
    del out
    with routing(replay=kernel_idx):
        want = forward(params_f32, prompts, f32, attn_impl="plain",
                       layers=layer_views(f32, params_f32)[:n_layers], **fwd)["logits"][:, -1]
    peak = want.abs().max().item()
    ulp = bf16_ulp(peak)
    err = (kernel_last - want).abs().max().item()
    dist = {"layers": n_layers, "max_abs_logit": peak, "ulp": ulp,
            "kernel_vs_f32_ulps": err / ulp,
            "plain_vs_f32_ulps": (plain - want).abs().max().item() / ulp,
            "kernel_vs_plain_ulps": (kernel_last - plain).abs().max().item() / ulp}
    return dist, err, aux


def pinned_faults(dist):
    """The MoE holds' failures at one depth (see MOE_SLACK_ULPS): the
    kernel path no farther from f32 than the plain bf16 path plus the
    slack, the plain bf16 path within its ceiling, and to MOE_PAIR_LAYERS
    layers the two bf16 paths within the slack of each other."""
    n, faults = dist["layers"], []
    if not dist["kernel_vs_f32_ulps"] <= dist["plain_vs_f32_ulps"] + MOE_SLACK_ULPS:
        faults.append("kernel path farther from f32 than plain bf16 + slack")
    if not dist["plain_vs_f32_ulps"] <= plain_bf16_ceiling_ulps(n):
        faults.append(f"plain bf16 past its ceiling {plain_bf16_ceiling_ulps(n)}")
    if n <= MOE_PAIR_LAYERS and not dist["kernel_vs_plain_ulps"] <= MOE_SLACK_ULPS:
        faults.append("kernel path farther from plain bf16 than the slack")
    return faults


def pinned_hold(cfg, params, prompts, prefill, st, sweep=()):
    """The MoE hold, on one routing. The prefill runs again with its expert
    indices recorded, its last logits bit for bit the timed prefill's `st`;
    every reference forward then runs on that routing (K1 and plain
    attention differ by bf16 ulps, and each such difference can move a
    token's top-k set, which no ulp rule survives over the layers). The
    reference is the plain forward in f32; `pinned_faults` holds the
    kernel path to it, the plain bf16 path to its ceiling and, to
    MOE_PAIR_LAYERS layers, the two bf16 paths to each other. The dense
    cells' rule between the two bf16 paths alone does not hold at depth: on an
    H100, over granite's 32 layers they are 14.4 ulps apart. Each depth of
    `sweep` is held by the same rules on the kernel forward of the first
    that many layers. The unpinned plain forward's error and routing flips
    are printed unheld. The drop fraction (mean per layer) and the summed
    lb / z losses are the pinned bf16 forward's. Returns (the prefill's last
    logits, max abs error against the f32 forward, its tolerance, row
    additions)."""
    kernel_idx, plain_idx = [], []
    with routing(record=kernel_idx):
        again = prefill(params, prompts)["logits_last"]
    if not same_bits(again, st["logits_last"]):
        raise AssertionError(f"{cfg.name}: a second prefill's last logits differ from "
                             "the timed prefill's")
    if len(kernel_idx) != cfg.n_layers:
        raise AssertionError(f"{cfg.name}: {len(kernel_idx)} routed layers")
    got = st["logits_last"].float()
    params_f32 = tree_map(lambda x: x.float(), params)
    dist, err, aux = pinned_distances(cfg, params, params_f32, prompts, got, kernel_idx,
                                      cfg.n_layers)
    depths, faults = [], {}
    for n in sweep:
        idx = []
        with routing(record=idx):
            last = forward(params, prompts, cfg, layers=layer_views(cfg, params)[:n])[
                "logits"][:, -1].float()
        depths.append(pinned_distances(cfg, params, params_f32, prompts, last, idx, n)[0])
    del params_f32
    torch.cuda.empty_cache()
    with routing(record=plain_idx):
        unpinned = forward(params, prompts, cfg, attn_impl="plain")["logits"][:, -1].float()
    flips = routing_flips(kernel_idx, plain_idx)
    for d in depths + [dist]:
        if found := pinned_faults(d):
            faults[d["layers"]] = found
    held = {"routing": "every reference pinned to the kernel path's expert indices",
            "reference": "the plain forward in f32 (weights upcast)",
            "prefill_replay_bit_exact": True,
            "max_abs_logit": dist["max_abs_logit"], "ulp": dist["ulp"],
            "bf16_kernel_vs_f32_ulps": dist["kernel_vs_f32_ulps"],
            "bf16_plain_vs_f32_ulps": dist["plain_vs_f32_ulps"],
            "bf16_kernel_vs_plain_ulps": dist["kernel_vs_plain_ulps"],
            "plain_bf16_ceiling_ulps": plain_bf16_ceiling_ulps(cfg.n_layers),
            "pair_rule_held": cfg.n_layers <= MOE_PAIR_LAYERS,
            "depth_sweep": depths, "pinned_faults": faults,
            "moe_drop_frac": aux["moe_drop_frac"] / cfg.n_layers,
            "moe_lb_loss_sum": aux["moe_lb_loss"], "moe_z_loss_sum": aux["moe_z_loss"],
            "routed_tokens_per_layer": kernel_idx[0].shape[0] * kernel_idx[0].shape[1],
            "unpinned_max_abs_err": (got - unpinned).abs().max().item(),
            "unpinned_routing_flips": sum(flips), "unpinned_flips_by_layer": flips}
    if faults:
        emit({"phase": "pinned_hold", "arch": cfg.name, "failed": held})
        raise AssertionError(f"{cfg.name} pinned hold: {faults}")
    tol = dist["plain_vs_f32_ulps"] * dist["ulp"] + MOE_SLACK_ULPS * dist["ulp"]
    return got, err, tol, held


def moe_widths(cfg):
    m = cfg.moe
    return {"d_model": cfg.d_model, "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
            "head_dim": cfg.head_dim, "window": cfg.sliding_window, "vocab": cfg.vocab_size,
            "tie_embeddings": cfg.tie_embeddings, "n_experts": m.n_experts, "top_k": m.top_k,
            "expert_d_ff": m.d_ff, "n_shared_experts": m.n_shared_experts,
            "capacity_factor": m.capacity_factor, "group_size": m.group_size}


def no_drop(cfg):
    """Capacity factor E / K (the reference's `tests/test_serve.py::_no_drop`):
    capacity depends on the group's length, so a decode step (S = 1, C = 1)
    drops nothing while a teacher-forced forward over 256 tokens may drop the
    same token; at E / K no group drops any."""
    return cfg.replace(moe=dataclasses.replace(
        cfg.moe, capacity_factor=float(cfg.moe.n_experts) / cfg.moe.top_k))


def phase_serve_moe():
    """granite-moe-3b-a800m at its published size through serve_cell, the
    routing pinned for the bf16 hold; the f32 2-layer decode check at
    capacity E / K."""
    cfg = get_config(MOE_ARCH)
    row, params, _ = serve_cell(
        cfg, 11, {"flash_attention_fwd": cfg.n_layers},
        lambda p, c: tensor_bytes(p) + tensor_bytes(c),
        hold=lambda *a: pinned_hold(*a, sweep=MOE_SWEEP_DEPTHS))
    del params
    torch.cuda.empty_cache()
    row["widths"] = moe_widths(cfg)
    row["f32_2layer"] = {**serve_f32_check(no_drop(cfg), 2, 12, {"flash_attention_fwd": 2}),
                         "capacity_factor": "E / K (no drops; see no_drop)"}
    emit({"phase": "serve_moe", **row})
    return row["launches_per_prefill"]


def phase_serve_moe_variants():
    """moonshot-v1-16b-a3b (64 experts top 6, a shared branch, MHA at head_dim
    128) and mixtral-8x22b (8 experts top 2, GQA 48 / 8, window 4096: at
    prompt 1024 the window covers the whole prompt) at full width, 2 layers
    each, bf16: a warm-up prefill, three timed, K1 launches per prefill, and
    the bf16 last logits held as serve_moe holds them. Returns
    {arch: launches per prefill}."""
    cells, launches = [], {}
    none = no_launches()
    for i, arch in enumerate(MOE_VARIANTS):
        full = get_config(arch)
        cfg = full.replace(n_layers=MOE_VARIANT_LAYERS)
        gen = torch.Generator(device="cuda").manual_seed(20 + i)
        params = init_params(cfg, gen, "cuda")
        n_params = sum(x.numel() for x in leaves(params))
        prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=gen,
                                device="cuda")
        prefill = make_prefill_fn(cfg, cache_len=PROMPT)
        with torch.inference_mode():
            prefill(params, prompts)
            sync()
            torch.cuda.reset_peak_memory_stats()
            times = []
            for _ in range(3):
                zero_counts()
                t0 = time.perf_counter()
                st = prefill(params, prompts)
                sync()
                times.append(1e3 * (time.perf_counter() - t0))
                per_prefill = counts()
            peak = torch.cuda.max_memory_allocated()
            got, err, tol, held = pinned_hold(cfg, params, prompts, prefill, st)
            finite = bool(torch.isfinite(got).all())
        del params, got, prefill, st
        torch.cuda.empty_cache()
        cell = {"arch": arch, "layers": cfg.n_layers, "dtype": "bfloat16", "params": n_params,
                "reduced": {"n_layers": [full.n_layers, cfg.n_layers],
                            "why": "memory: at full depth the bf16 weights alone take "
                                   f"{2 * full_param_count(full) / 1e9:.1f} GB"},
                "widths": moe_widths(cfg), "batch": BATCH, "prompt": PROMPT,
                "launches_per_prefill": per_prefill, "prefill_ms": statistics.median(times),
                "prefill_ms_all": times, "max_memory_allocated": peak,
                "bf16_last_logits_max_abs_err": err, "bf16_tolerance": tol, **held}
        cells.append(cell)
        launches[arch] = per_prefill
        if per_prefill != {**none, "flash_attention_fwd": cfg.n_layers}:
            emit({"phase": "serve_moe_variants", "failed": cell})
            raise AssertionError(f"{arch} launches per prefill {per_prefill}")
        if not (finite and err <= tol):
            emit({"phase": "serve_moe_variants", "failed": cell})
            raise AssertionError(f"{arch} bf16 prefill logits: max err {err} > {tol}")
    emit({"phase": "serve_moe_variants", "cells": cells})
    return launches


def f32_depth(cfg, params):
    """The deepest first-layers cut whose weights, upcast to f32, fit in the
    card's free memory beside what is there (the bf16 weights, the Engine's
    cache) with F32_WORK_BYTES to spare: `cfg.n_layers` where all fit. The
    layers are one stacked pattern slot (a dense or prefix config)."""
    if len(params["blocks"]) != 1 or params["rem"]:
        raise AssertionError(f"{cfg.name}: f32_depth takes one stacked pattern slot")
    per_layer = sum(x[0].numel() for x in leaves(params["blocks"])) * 4
    rest = sum(x.numel() for k, v in params.items() if k not in ("blocks", "rem")
               for x in leaves(v)) * 4
    free = torch.cuda.mem_get_info()[0]
    return max(0, min(cfg.n_layers, int((free - F32_WORK_BYTES - rest) // per_layer)))


def f32_first_layers(params, n):
    """The weights of the first `n` layers (one stacked slot) and the rest,
    upcast to f32."""
    out = {k: tree_map(lambda x: x.float(), v) for k, v in params.items()
           if k not in ("blocks", "rem")}
    out["blocks"] = [tree_map(lambda x: x[:n].float(), b) for b in params["blocks"]]
    out["rem"] = []
    return out


def dense_hold(cfg, params, prompts, prefill, st, prefix=None, positions=None):
    """serve_moe's hold without a routing to pin (`pinned_faults` on the
    distances of `pinned_distances`): the kernel path's bf16 last logits no
    farther from the plain f32 forward than the plain bf16 forward plus
    MOE_SLACK_ULPS, that distance within `plain_bf16_ceiling_ulps`, and at
    MOE_PAIR_LAYERS layers the two bf16 paths within MOE_SLACK_ULPS of each
    other. The f32 forward runs at `f32_depth`: at full depth where the
    upcast weights fit, else on the first that many layers, held against
    the kernel forward of those layers (the cut is in the row's "reduced").
    `prefix` / `positions` go to every forward, as the prefill took them.
    Returns (the prefill's last logits, max abs error against the f32
    forward, its tolerance, row additions)."""
    fwd = {"prefix_embeds": prefix, "positions": positions}
    got = st["logits_last"].float()
    n = f32_depth(cfg, params)
    if n < MOE_PAIR_LAYERS:
        raise AssertionError(f"{cfg.name}: {n} f32 layers fit beside the bf16 weights")

    def kernel_last(depth):
        if depth == cfg.n_layers:
            return got
        return forward(params, prompts, cfg, layers=layer_views(cfg, params)[:depth],
                       **fwd)["logits"][:, -1].float()

    params_f32 = f32_first_layers(params, n)
    dist, err, _ = pinned_distances(cfg, params, params_f32, prompts, kernel_last(n), [],
                                    n, **fwd)
    pair = pinned_distances(cfg, params, params_f32, prompts, kernel_last(MOE_PAIR_LAYERS),
                            [], MOE_PAIR_LAYERS, **fwd)[0]
    del params_f32
    torch.cuda.empty_cache()
    faults = {d["layers"]: f for d in (pair, dist) if (f := pinned_faults(d))}
    held = {"reference": "the plain forward in f32 (weights upcast)",
            "f32_layers": n, "max_abs_logit": dist["max_abs_logit"], "ulp": dist["ulp"],
            "bf16_kernel_vs_f32_ulps": dist["kernel_vs_f32_ulps"],
            "bf16_plain_vs_f32_ulps": dist["plain_vs_f32_ulps"],
            "bf16_kernel_vs_plain_ulps": dist["kernel_vs_plain_ulps"],
            "plain_bf16_ceiling_ulps": plain_bf16_ceiling_ulps(n),
            "pair_rule_depth": pair, "dense_faults": faults}
    if n < cfg.n_layers:
        held["reduced"] = {"f32_reference_layers": [cfg.n_layers, n],
                           "why": "memory: the f32 weights of every layer do not fit "
                                  "beside the bf16 ones"}
    if faults:
        emit({"phase": "dense_hold", "arch": cfg.name, "failed": held})
        raise AssertionError(f"{cfg.name} dense hold: {faults}")
    tol = (dist["plain_vs_f32_ulps"] + MOE_SLACK_ULPS) * dist["ulp"]
    return got, err, tol, held


def lm_decode_bytes(params, cache):
    """What one decode step of an attention LM must move: every weight once
    (of a separate token embedding table only the batch's rows) and the KV
    cache."""
    tok = params["embed"]["tok"]
    unread = 0 if "unembed" not in params else (
        tensor_bytes(tok) - BATCH * tok[0].numel() * tok.element_size())
    return tensor_bytes(params) - unread + tensor_bytes(cache)


def dense_widths(cfg):
    return {"d_model": cfg.d_model, "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
            "head_dim": cfg.head_dim, "d_ff": cfg.d_ff, "vocab": cfg.vocab_size,
            "tie_embeddings": cfg.tie_embeddings, "qk_norm": cfg.qk_norm,
            "rope_type": cfg.rope_type, "rope_theta": cfg.rope_theta,
            "prefix_embed_len": cfg.prefix_embed_len}


def dense_cell(arch, seed):
    """One config at its published size through serve_cell (`dense_hold`)
    and the f32 2-layer prefill + decode check.
    Returns (the row, params, the generator)."""
    cfg = get_config(arch)
    row, params, gen = serve_cell(cfg, seed, {"flash_attention_fwd": cfg.n_layers},
                                  lm_decode_bytes, hold=dense_hold)
    row["widths"] = dense_widths(cfg)
    row["f32_2layer"] = serve_f32_check(cfg, 2, seed + 1, {"flash_attention_fwd": 2})
    return row, params, gen


def phase_serve_dense128():
    """qwen3-8b and minitron-8b at their published size (`dense_cell`).
    Returns {arch: launches per prefill}."""
    cells, launches = [], {}
    for i, arch in enumerate(DENSE128_ARCHS):
        row, params, _ = dense_cell(arch, 40 + 2 * i)
        del params
        torch.cuda.empty_cache()
        cells.append(row)
        launches[arch] = row["launches_per_prefill"]
    emit({"phase": "serve_dense128", "cells": cells})
    return launches


def mrope_grid_positions(batch, prefix, prompt, gen):
    """(B, S, 3) positions whose streams differ: the stub prefix as a
    square grid (t = 0, h = row, w = col), then the text counting on from
    the grid's largest on all three streams, each row offset by a seeded
    0..3 (so rows differ too)."""
    side = math.isqrt(prefix)
    if side * side != prefix:
        raise AssertionError(f"a {prefix}-row prefix is not a square grid")
    i = torch.arange(prefix, device="cuda")
    grid = torch.stack([torch.zeros_like(i), i // side, i % side], -1)
    text = side + torch.arange(prompt, device="cuda")[:, None].expand(prompt, 3)
    pos = torch.cat([grid, text])[None] + torch.randint(
        0, 4, (batch, 1, 1), generator=gen, device="cuda")
    return pos.to(torch.int32)


def mrope_streams_check(cfg, params, gen):
    """One kernel-path prefill of `cfg` (M-RoPE) on `mrope_grid_positions`,
    held by `dense_hold` against the plain forwards on the same positions;
    K1 launches n_layers times."""
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=gen,
                            device="cuda")
    pe = stub_prefix(cfg, BATCH, gen, cfg.compute_dtype)
    pos = mrope_grid_positions(BATCH, cfg.prefix_embed_len, PROMPT, gen)
    prefill = make_prefill_fn(cfg, cache_len=cfg.prefix_embed_len + PROMPT)
    with torch.inference_mode():
        zero_counts()
        st = prefill(params, prompts, prefix_embeds=pe, positions=pos)
        launches = counts()
        got, err, tol, held = dense_hold(cfg, params, prompts, prefill, st, prefix=pe,
                                         positions=pos)
        finite = bool(torch.isfinite(got).all())
        # the sections matter: the same prefill on the Engine's tiled positions
        tiled = prefill(params, prompts, prefix_embeds=pe)["logits_last"].float()
        moved = (tiled - got).abs().max().item()
    none = no_launches()
    row = {"positions": "stub as a 16 x 16 grid (t = 0, h = row, w = col), then text "
                        "on all three streams, rows offset by a seeded 0..3",
           "distinct_streams": [bool((pos[..., 0] != pos[..., 1]).any()),
                                bool((pos[..., 1] != pos[..., 2]).any())],
           "launches_per_prefill": launches, "bf16_last_logits_max_abs_err": err,
           "bf16_tolerance": tol, "vs_tiled_positions_max_abs_diff": moved, **held}
    if launches != {**none, "flash_attention_fwd": cfg.n_layers} or not (
            finite and err <= tol and moved > 0 and all(row["distinct_streams"])):
        emit({"phase": "serve_prefix", "failed": {"mrope_streams": row}})
        raise AssertionError(f"{cfg.name} M-RoPE streams prefill: {row}")
    return row


def phase_serve_prefix():
    """qwen2-vl-2b and musicgen-large at their published size with their
    stub prefixes (`dense_cell`), and qwen2-vl's prefill on distinct M-RoPE
    streams (`mrope_streams_check`). Returns {arch: launches per prefill}."""
    cells, launches = [], {}
    for i, arch in enumerate(PREFIX_ARCHS):
        row, params, gen = dense_cell(arch, 50 + 2 * i)
        if get_config(arch).rope_type == "mrope":
            row["mrope_streams"] = mrope_streams_check(get_config(arch), params, gen)
        del params
        torch.cuda.empty_cache()
        cells.append(row)
        launches[arch] = row["launches_per_prefill"]
    emit({"phase": "serve_prefix", "cells": cells})
    return launches


def dense_timing(check_rows, launches, reports):
    """K1's lines at the prefills of serve_dense128 and serve_prefix: GQA 32 /
    8 at head_dim 128 (qwen3-8b, minitron-8b), GQA 12 / 2 at head_dim 128
    over prefix 256 + prompt 1024 (qwen2-vl-2b) and MHA 32 / 32 at head_dim
    64 over prefix 64 + prompt 1024 (musicgen-large). SDPA's causal mask is
    the kernel's at Sq = Sk."""
    fa, lines = KERNELS[0], []
    for i, (arch, case) in enumerate((
            ("qwen3-8b", "qwen3_shape_bf16"), ("minitron-8b", "minitron_shape_bf16"),
            ("qwen2-vl-2b", "qwen2vl_prefix_shape_bf16"),
            ("musicgen-large", "musicgen_prefix_shape_bf16"))):
        cfg = get_config(arch)
        Hq, Hk, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        S = cfg.prefix_embed_len + PROMPT
        q, k, v = qkv(BATCH, Hq, Hk, S, S, D, torch.bfloat16, seed=60 + i)
        bound, by = attention_bound_ms(q, k, v, 0)
        row = next(r for r in check_rows if r["case"] == case)
        if row["shape"] != [BATCH, Hq, Hk, S, S, D]:
            raise AssertionError(f"check case {case} is not {arch}'s prefill shape")
        lines.append({
            "name": f"flash_attention_fwd_{arch.replace('-', '_').replace('.', '_')}",
            "route": fa["route"], "source": fa["source"], "replaces": fa["replaces"],
            "launches": launches[arch][fa["name"]],
            "max_abs_err": row["max_abs_err"], "tolerance": row["tolerance"],
            "row_ratio": row["row_ratio"],
            "ms": cuda_ms(lambda: ops.flash_attention(q, k, v), 50),
            "plain_ms": cuda_ms(lambda: attention_ref(q, k, v), 10),
            "bound_ms": bound, "bound_by": by,
            "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=Hq != Hk), 50),
            "shape": [BATCH, Hq, Hk, S, S, D], "dtype": "bfloat16", "window": 0,
            "path": f"{'serve_prefix' if cfg.prefix_embed_len else 'serve_dense128'} "
                    f"{arch} prefill (per prefill)",
            **k1_extras(reports, q, k, v, 0)})
        del q, k, v
    torch.cuda.empty_cache()
    return lines


def full_param_count(cfg):
    """The parameters of `cfg` from its shapes, without allocating them."""
    return sum(x.numel() for x in leaves(init_params(cfg, torch.Generator(), "meta")))


def same_bits(a, b):
    """Bit-exact equality (so -0.0 differs from 0.0)."""
    as_int = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(a.view(as_int[a.dtype]), b.view(as_int[b.dtype])))


def card_arena(n, seed, dtype=torch.float32, offset=0, edges=False):
    """n values on the card; offset > 0 gives a contiguous view that starts
    `offset` elements into its buffer (not 16-byte aligned)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = 40 * torch.randn(n + offset, generator=g, device="cuda")
    if edges:
        x[offset:offset + len(BF16_EDGES)] = torch.tensor(BF16_EDGES, device="cuda")
    return x.to(dtype)[offset:]


def counts():
    return {k["name"]: k["counter"].launches for k in KERNELS}


def no_launches():
    """Every kernel's count at 0: the base of each path's expected counts."""
    return dict.fromkeys((k["name"] for k in KERNELS), 0)


def zero_counts():
    for k in KERNELS:
        k["counter"].launches = 0


def same_bits_or_nan(a, b):
    """Bit-exact equality, where NaN equals NaN whatever its payload (an
    int8 block holding NaN has a NaN scale, and its dequantized values)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if not a.is_floating_point():
        return torch.equal(a, b)
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and same_bits(
        torch.where(nan, 0.0, a), torch.where(nan, 0.0, b))


def eq1_edge_arenas(n, dtype, offset=0):
    """x, y: n values on the card (n >= every EQ1_X x EQ1_Y pair), the
    pairs first, then 40 * randn; offset as `card_arena`."""
    pairs = [torch.tensor(EQ1_X).repeat_interleave(len(EQ1_Y)),
             torch.tensor(EQ1_Y).repeat(len(EQ1_X))]
    out = []
    for seed, edges in zip((6, 7), pairs):
        g = torch.Generator(device="cuda").manual_seed(seed)
        v = 40 * torch.randn(n + offset, generator=g, device="cuda")
        v[offset:offset + edges.numel()] = edges.to("cuda")
        out.append(v.to(dtype)[offset:])
    return out


def ring_edge_sizes(ring):
    """Sizes at the stream ring's boundaries, from its `ring_config`: one
    chunk - 1 and + 1, and one full turn of the ring over the persistent
    grid (every CTA through each of its stages once) + 1."""
    chunk = ring["chunk_elements"]
    return [chunk - 1, chunk + 1, ring["grid"] * ring["stages"] * chunk + 1]


def shared_offset(x_offset, in_size, out_size):
    """The offset (elements) of an output view that reaches 16-byte
    alignment at the same element as an input view `x_offset` elements
    into an aligned buffer: the ring's head path."""
    head = -x_offset % (16 // in_size)
    return -head % (16 // out_size)


def offset_out(n, dtype, offset):
    """(buffer, view): n elements `offset` into a buffer of 7.0s that
    reaches 16 past the view, so a write outside the view shows."""
    buf = torch.full((n + offset + 16,), 7.0, dtype=dtype, device="cuda")
    return buf, buf[offset:offset + n]


def untouched(buf, view):
    start = view.data_ptr() - buf.data_ptr()
    lo, hi = start // buf.element_size(), start // buf.element_size() + view.numel()
    return bool((buf[:lo] == 7).all()) and bool((buf[hi:] == 7).all())


def check_streams(record):
    """K2 to K4 on the stream ring's edges, bit for bit (NaN as NaN): Eq. (1)
    on edge pairs (f32 and bf16 arenas), sizes at the ring's boundaries,
    views whose 16-byte misalignment x, y and out share (the ring's scalar
    head; the output through the entry point, checked for writes outside
    the view) and views where they do not (the scalar loop)."""
    lib = ops.kernel_library("comm_kernels")
    f32, bf16 = torch.float32, torch.bfloat16
    for dtype in (f32, bf16):
        for n, offset in ((999, 0), (4099, 1)):
            x, y = eq1_edge_arenas(n, dtype, offset)
            for S, P, E in EQ1_WEIGHTS + ((1, 1, 0),):
                kw = dict(staleness=S, global_world=P, extra_staleness=E)
                record("eq1_merge", same_bits_or_nan(ops.eq1_merge(x, y, **kw),
                                                     ref.eq1_merge_ref(x, y, **kw)),
                       case="edge pairs", n=n, offset=offset, dtype=str(dtype), S=S, P=P,
                       E=E)
    kw = dict(staleness=1, global_world=16)
    for dtype in (f32, bf16):
        for n in ring_edge_sizes(ring_config(lib, "eq1_merge", dtype, 2 ** 40)):
            x, y = card_arena(n, 8, dtype), card_arena(n, 9, dtype)
            record("eq1_merge", same_bits(ops.eq1_merge(x, y, **kw),
                                          ref.eq1_merge_ref(x, y, **kw)),
                   case="ring size", n=n, dtype=str(dtype))
    for entry, din, dout in CASTS:
        kernel = ops.bf16_pack if entry == "bf16_pack" else (
            lambda x, dout=dout: ops.bf16_unpack(x, dout))
        plain = ref.bf16_pack_ref if entry == "bf16_pack" else (
            lambda x, dout=dout: ref.bf16_unpack_ref(x, dout))
        ring = ring_config(lib, entry, din if entry == "bf16_pack" else dout, 2 ** 40)
        for n in ring_edge_sizes(ring):
            x = card_arena(n, 10, din, edges=True)
            x[n // 2] = x[-1] = float("nan")  # in the ring's body and in the tail
            record(entry, same_bits_or_nan(kernel(x), plain(x)), case="ring size", n=n,
                   dtype=f"{din} -> {dout}")
    # the head path: x, y and out misaligned alike
    for dtype in (f32, bf16):
        for n in (2, 999, 2 ** 20 + 3):
            for offset in ((1, 3) if dtype == f32 else (1, 5)):
                x, y = eq1_edge_arenas(n, dtype, offset) if n >= 288 else (
                    card_arena(n, 11, dtype, offset), card_arena(n, 12, dtype, offset))
                buf, out = offset_out(n, dtype, offset)
                launch_eq1_merge(lib, x, y, out, **kw)
                record("eq1_merge", same_bits_or_nan(out, ref.eq1_merge_ref(x, y, **kw))
                       and untouched(buf, out), case="shared misalignment", n=n,
                       offset=offset, dtype=str(dtype))
    for entry, din, dout in CASTS:
        for n in (2, 999, 2 ** 20 + 3):
            for offset in (1, 3):
                x = card_arena(n, 13, din, offset, edges=n >= len(BF16_EDGES))
                buf, out = offset_out(n, dout, shared_offset(offset, din.itemsize,
                                                             dout.itemsize))
                launch_cast(lib, entry, x, out)
                record(entry, same_bits(out, x.to(dout)) and untouched(buf, out),
                       case="shared misalignment", n=n, offset=offset,
                       dtype=f"{din} -> {dout}")
    # the scalar loop: y misaligned unlike x, an output view unlike x
    for dtype in (f32, bf16):
        x, y = card_arena(4099, 14, dtype, 1), card_arena(4099, 15, dtype, 2)
        record("eq1_merge", same_bits(ops.eq1_merge(x, y, **kw), ref.eq1_merge_ref(x, y, **kw)),
               case="unshared misalignment", n=4099, offset=[1, 2], dtype=str(dtype))
    for entry, din, dout in CASTS:
        x = card_arena(4099, 16, din, edges=True)
        buf, out = offset_out(4099, dout, 1)
        launch_cast(lib, entry, x, out)
        record(entry, same_bits(out, x.to(dout)) and untouched(buf, out),
               case="unshared misalignment", n=4099, offset=[0, 1],
               dtype=f"{din} -> {dout}")


def int8_edges(x, block):
    """Edge blocks at the start of x's first row (x is (rows, N), N >= 8
    blocks), zero but for the values listed: all zeros (scale 1e-12 / 127),
    exact ties after scaling (absmax 127 gives scale 1.0), +-absmax (->
    +-127), f32 subnormals only (the scale floor), 3e38, +inf, -inf and NaN
    (a NaN scale, values 0)."""
    groups = [
        [0.0] * block,
        [127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 126.5, -126.5, -127.0, 3.5, -3.5],
        [-5.0, 5.0, 2.0, -1.0],
        [1e-40, -1e-40, 1.4e-45, -9e-39, 1.17e-38],
        [3e38, -3e38, 1.0, -2.5e37],
        [float("inf"), 1.0, -2.0],
        [float("-inf"), 3.0],
        [float("nan"), 1.0, -4.0],
    ]
    for i, g in enumerate(groups):
        x[0, i * block:(i + 1) * block] = 0.0
        x[0, i * block:i * block + len(g)] = torch.tensor(g, device=x.device)
    return x


def int8_cases():
    """(rows, N, block, offset, bits, edges) of the K5 / K6 checks."""
    cases = []
    for rows in (1, 4):
        for n in (999, 2 ** 20 + 3, 256 * 4099):
            for block in (64, 128, 256):
                cases.append((rows, n, block, 0, "none", False))
            cases.append((rows, n, 256, 0, "random", False))
    for block in (64, 128, 256):
        for bits in ("none", "zeros", "ones", "random"):
            cases.append((4, 256 * 4099, block, 0, bits, True))
            cases.append((4, 4099, block, 1, bits, True))
    cases.append((1, 2 ** 20 + 3, 256, 1, "random", False))
    return cases


def card_bits(shape, kind, seed, offset=0):
    if kind == "none":
        return None
    if kind == "random":
        b = flatbuf.random_bits((math.prod(shape) + offset,),
                                torch.Generator(device="cuda").manual_seed(seed))
    else:
        fill = 0 if kind == "zeros" else -1  # 0 or 0xFFFFFFFF
        b = torch.full((math.prod(shape) + offset,), fill, dtype=torch.int32,
                       device="cuda").view(torch.uint32)
    return b[offset:].view(shape)


def check_int8(record):
    """K5 and K6 against their plain versions: values, scales and the
    dequantized arena bit for bit (NaN compared as NaN)."""
    for i, (rows, n, block, offset, bits_kind, edges) in enumerate(int8_cases()):
        x = card_arena(rows * n, 10 + i, offset=offset).view(rows, n)
        if edges:
            x = int8_edges(x, block)
        bits = card_bits((rows, n), bits_kind, 20 + i, offset)
        case = dict(rows=rows, n=n, block=block, offset=offset, bits=bits_kind,
                    edges=edges)
        v, sc = ops.quantize_int8(x, bits, block=block)
        vr, scr = ref.quantize_int8_block_ref(x, block=block, bits=bits)
        record("quantize_int8", torch.equal(v, vr) and same_bits_or_nan(sc, scr), **case)
        record("dequantize_int8", same_bits_or_nan(
            ops.dequantize_int8(v, sc, block=block),
            ref.dequantize_int8_block_ref(v, sc, block=block)), **case)
        if edges:  # the stated values of the edge blocks
            # (block, element): value; with bits only what floor(v + u)
            # gives for every u in [0, 1)
            want = {(1, 0): 127, (1, 3): 2, (1, 4): 0, (2, 0): -127, (2, 1): 127,
                    (4, 0): 127, (5, 1): 0, (7, 1): 0} if bits_kind == "none" else {
                (2, 1): 127, (5, 1): 0, (7, 1): 0}
            got = {k: int(v[0, k[0] * block + k[1]]) for k in want}
            floor_scale = torch.tensor(1e-12) / torch.tensor(127.0)
            stated = (got == want and float(sc[0, 0]) == float(floor_scale)
                      and float(sc[0, 1]) == 1.0 and bool(torch.isnan(sc[0, 7])))
            record("quantize_int8 edge values", stated,
                   got={f"{b}/{e}": q for (b, e), q in got.items()}, **case)


def phase_comm_check():
    """K2 to K6 bit-exact against their plain versions at ragged sizes,
    misaligned views and edge values, K2 to K4 also on the stream ring's
    edges (`check_streams`); and what PyTorch's CUDA division by a Python
    scalar does to the plain Eq. (1)."""
    rows = []

    def record(kernel, ok, **case):
        rows.append({"kernel": kernel, **case, "bit_exact": ok})
        if not ok:
            emit({"phase": "comm_check", "failed": rows[-1]})
            raise AssertionError(f"{kernel} differs from its plain version: {rows[-1]}")

    for n, offset in ((999, 0), (2 ** 20 + 3, 0), (2 ** 20 + 3, 1), (4099, 3)):
        for dtype in (torch.float32, torch.bfloat16):
            case = dict(n=n, offset=offset, dtype=str(dtype))
            x = card_arena(n, 1, dtype, offset)
            y = card_arena(n, 2, dtype, offset)
            for S, P, E in EQ1_WEIGHTS:
                kw = dict(staleness=S, global_world=P, extra_staleness=E)
                record("eq1_merge", same_bits(ops.eq1_merge(x, y, **kw),
                                              ref.eq1_merge_ref(x, y, **kw)), **case, S=S,
                       P=P, E=E)
            e = card_arena(n, 3, dtype, offset, edges=True)
            record("bf16_pack", same_bits(ops.bf16_pack(e), ref.bf16_pack_ref(e)), **case)
            w = e.to(torch.bfloat16)
            record("bf16_unpack", same_bits(ops.bf16_unpack(w, dtype),
                                            ref.bf16_unpack_ref(w, dtype)), **case)
    nan = ops.bf16_pack(torch.tensor([float("nan"), 1.0], device="cuda"))
    if not (bool(torch.isnan(nan[0])) and nan[1].item() == 1.0):
        raise AssertionError(f"bf16_pack of NaN: {nan}")
    check_streams(record)
    check_int8(record)

    # the plain Eq. (1) divides by a device tensor; a Python-scalar divisor
    # on CUDA is multiplied as a reciprocal instead
    x, y = card_arena(2 ** 24, 4), card_arena(2 ** 24, 5)
    s2, p = 2.0, 16.0
    want = ref.eq1_merge_ref(x, y, staleness=1, global_world=16)
    scalar = (s2 * x + p * y) / (s2 + p)
    ulps = (scalar.view(torch.int32).long() - want.view(torch.int32).long()).abs()
    divisor = {"elements": ulps.numel(), "differ": int((ulps > 0).sum()),
               "max_ulp": int(ulps.max()), "divisor": s2 + p}
    sync()
    per_kernel = {}
    for r in rows:
        per_kernel[r["kernel"]] = per_kernel.get(r["kernel"], 0) + 1
    emit({"phase": "comm_check", "cases": len(rows), "cases_by_kernel": per_kernel,
          "all_bit_exact": True, "python_scalar_divisor": divisor})
    return divisor


@contextmanager
def plain_exchange():
    """Swap the exchange kernels' wrappers for their plain versions, so the
    same step functions compute the exchange with kernels/ref.py."""
    names = ("eq1_merge", "bf16_pack", "bf16_unpack", "quantize_int8", "dequantize_int8")
    saved = [getattr(ops, n) for n in names]
    plain = (ref.eq1_merge_ref, ref.bf16_pack_ref, ref.bf16_unpack_ref,
             lambda x, bits=None, *, block=256: ref.quantize_int8_block_ref(
                 x, block=block, bits=bits),
             ref.dequantize_int8_block_ref)
    for n, f in zip(names, plain):
        setattr(ops, n, f)
    try:
        yield
    finally:
        for n, f in zip(names, saved):
            setattr(ops, n, f)


def train_config(n_layers, arch=ARCH):
    return get_config(arch).replace(n_layers=n_layers, param_dtype=torch.float32,
                                    compute_dtype=torch.float32)


def replica_data(src, replicas=TRAIN_R):
    def data(step):
        b = src.batch(replicas * TRAIN_PER, step, device="cuda")
        return {k: v.reshape((replicas, TRAIN_PER) + v.shape[1:]) for k, v in b.items()}
    return data


INT8_EXCHANGE = {"quantize_int8": 1, "dequantize_int8": 1}
# (DasoConfig options, warm-up modes, checked (mode, staleness, launches))
TRAIN_CHECKS = [
    ({}, ("send", "local"),
     (("receive", 2, {"eq1_merge": 1}), ("blocking", 1, {"bf16_pack": 1}))),
    ({"wire_format": "int8"}, ("send", "local"),
     (("send", 1, INT8_EXCHANGE), ("blocking", 1, INT8_EXCHANGE))),
    ({"wire_format": "int8", "overlap": "one_cycle"}, ("ov_start", "local"),
     (("ov_sync~1", 1, {"eq1_merge": 1, **INT8_EXCHANGE}),)),
]


def pinned_copies(tensors):
    """Host copies of card tensors in pinned memory (the caching host
    allocator keeps the blocks for the next call), so the copies both ways
    run at the link's rate and the comparison stays on the card."""
    out = [torch.empty(x.shape, dtype=x.dtype, pin_memory=True) for x in tensors]
    for o, x in zip(out, tensors):
        o.copy_(x, non_blocking=True)
    sync()
    return out


def phase_train_check():
    """Steps at full width (1 layer, f32, R = 4), each from one carry:
    through the kernels, and with the exchange computed by the plain
    versions. The carries must be identical. Receive and blocking (bf16) as
    slice 2 checked them; an int8 send and an int8 blocking step; an ov_sync
    step with extra staleness 1 on the int8 tier."""
    cfg = train_config(1)
    params0 = init_params(cfg, torch.Generator(device="cuda").manual_seed(2), "cuda")
    data = replica_data(SyntheticLM(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ, seed=2))
    rows = []
    for options, warmup, checks in TRAIN_CHECKS:
        strategy = DasoStrategy(make_lm_loss(cfg), sgd(0.9, 1e-4), daso.DasoConfig(
            n_replicas=TRAIN_R, global_world=TRAIN_R * TRAIN_LOCAL_WORLD,
            b_max=TRAIN_B_MAX, **options))
        carry = strategy.init_carry(params0)
        for step, mode in enumerate(warmup):
            carry, _ = strategy.step_fn(mode, 1)(carry, data(step), TRAIN_LR)
        for mode, stale, kernels in checks:
            batch = data(len(warmup))
            step = strategy.step_fn(mode, stale)
            before = counts()
            got = step(carry, batch, TRAIN_LR)
            sync()
            launched = {k: v - before[k] for k, v in counts().items() if v != before[k]}
            got = pinned_copies(leaves(got))  # room on the card for the second step
            with plain_exchange():
                want = step(carry, batch, TRAIN_LR)
            identical = all(same_bits(a.to("cuda", non_blocking=True), b)
                            for a, b in zip(got, leaves(want), strict=True))
            del want
            row = {"mode": mode, "staleness": stale, "options": options,
                   "kernel_launches": launched, "carry_identical_to_plain": identical}
            if not identical:  # tell a nondeterministic local step from the exchange
                again = step(carry, batch, TRAIN_LR)
                row["kernel_path_repeat_identical"] = all(
                    same_bits(a.to("cuda", non_blocking=True), b)
                    for a, b in zip(got, leaves(again), strict=True))
                del again
            rows.append(row)
            del got
            if launched != kernels or not identical:
                emit({"phase": "train_check", "failed": row})
                raise AssertionError(f"train_check {mode}: {row}")
        del carry, strategy
    del params0
    torch.cuda.empty_cache()
    emit({"phase": "train_check", "arch": ARCH, "layers": 1, "dtype": "float32",
          "replicas": TRAIN_R, "steps": rows})


def shape_name(shape):
    return ",".join(m if s == 1 else f"{m}@{s}" for m, s in shape)


def outer_mode(token):
    """The outermost level's base action of a mode token: "receive+host" ->
    "receive", "ov_sync~3+host" -> "ov_sync"."""
    return split_ov(split_mode(token)[0])[0]


def cycle_rows(res):
    """The macro path's host ms per step of each cycle (its wall over its
    length), by cycle shape, with the shape's outer syncs."""
    by_shape = {}
    for shape, sec in res.cycles:
        by_shape.setdefault(shape, []).append(1e3 * sec / len(shape))
    rows = {}
    for shape, v in by_shape.items():
        syncs = shape_sync_counts(shape)
        rows[shape_name(shape)] = {
            "cycles": len(v), "outer_syncs": syncs.pop("_outer"), "inner_syncs": syncs,
            "ms_per_step_median": statistics.median(v), "ms_per_step_all": v}
    return rows


def prefix_data(data, cfg, seed):
    """`data` with the config's stub prefix in every replica batch: seeded
    0.1 x N(0, 1) embeddings (R, PER, prefix_embed_len, d_model) in the
    compute dtype, drawn per step on the card, and labels -1 over them
    (the labels cover the spliced length)."""
    P = cfg.prefix_embed_len

    def with_prefix(step):
        b = data(step)
        g = torch.Generator(device="cuda").manual_seed(seed * 1_000_003 + step)
        b["prefix_embeds"] = (0.1 * torch.randn((TRAIN_R, TRAIN_PER, P, cfg.d_model),
                                                generator=g, device="cuda")
                              ).to(cfg.compute_dtype)
        ignore = torch.full((TRAIN_R, TRAIN_PER, P), -1, dtype=b["labels"].dtype,
                            device="cuda")
        b["labels"] = torch.cat([ignore, b["labels"]], -1)
        return b
    return with_prefix


def run_train_phase(name, loop_options, why_reduced, on_batch=None, tracer=None,
                    strategy="daso", plan=None, supervise=None, lr=TRAIN_LR,
                    steps=TRAIN_STEPS, arch=ARCH, layers=TRAIN_LAYERS, replicas=TRAIN_R):
    """run_training with `strategy` (DASO by default) at `arch`'s (llama3.2-1b
    by default) published widths, `layers` layers (4), f32, R = `replicas`
    (4); the counts are set to 0 just before and read just after. Returns
    (result, its row, launch counts, the outermost level's base modes,
    params0). The per-step executor's row has
    the step ms by mode token, the macro executor's its ExecutorStats and
    the ms per step by cycle shape. `on_batch(step)` runs as each step's
    batch is made, before the step's clock starts; `tracer` goes to
    run_training. With a fault `plan` the run goes through
    `resilience.run_with_faults` on the macro executor instead (the strategy
    as run_training builds it, `supervise` its extra keyword arguments), and
    the result is the ResilienceReport. `steps` cuts the run short. A
    config with a stub prefix takes one in every batch (`prefix_data`)."""
    cfg = train_config(layers, arch)
    params0 = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    n_params = sum(x.numel() for x in leaves(params0))
    data = replica_data(SyntheticLM(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ, seed=0),
                        replicas)
    if cfg.prefix_embed_len:
        data = prefix_data(data, cfg, 0)
    if on_batch is not None:
        make_batch = data

        def data(step):
            on_batch(step)
            return make_batch(step)
    loop_cfg = TrainLoopConfig(strategy=strategy, n_steps=steps, n_replicas=replicas,
                               local_world=TRAIN_LOCAL_WORLD, b_max=TRAIN_B_MAX,
                               lr=lr, device="cuda", **loop_options)
    sync()
    torch.cuda.reset_peak_memory_stats()
    start, retries = torch.cuda.memory_allocated(), torch.cuda.memory_stats()["num_alloc_retries"]
    zero_counts()
    t0 = time.perf_counter()
    report = None
    if plan is None:
        res = run_training(make_lm_loss(cfg), params0, data, loop_cfg,
                           optimizer=sgd(momentum=0.9, weight_decay=1e-4), log=None,
                           tracer=tracer)
    else:
        strat = build_strategy(make_lm_loss(cfg), loop_cfg, sgd(momentum=0.9, weight_decay=1e-4))
        report = run_with_faults(strat, params0, data, constant_lr(lr), steps,
                                 plan, executor=MacroCycleExecutor(strat), tracer=tracer,
                                 **(supervise or {}))
        res = report.result
        del strat
    sync()
    wall = time.perf_counter() - t0
    launches = counts()
    peak = torch.cuda.max_memory_allocated()
    memory = {"allocated_at_start": start, "peak_above_start": peak - start,
              "max_memory_reserved": torch.cuda.max_memory_reserved(),
              # the caching allocator's retries after freeing its cache
              # (each waits for the card)
              "alloc_retries": torch.cuda.memory_stats()["num_alloc_retries"] - retries}
    modes = [h[1] for h in res.controller.history]
    losses = res.losses
    row = {"phase": name, "arch": arch, "strategy": strategy,
           "entry": "run_training" if plan is None else "resilience.run_with_faults",
           **loop_options,
           "widths": {"d_model": cfg.d_model, "n_heads": cfg.n_heads,
                      "n_kv_heads": cfg.n_kv_heads, "head_dim": cfg.head_dim,
                      "d_ff": cfg.d_ff, "vocab": cfg.vocab_size,
                      "tie_embeddings": cfg.tie_embeddings},
           "reduced": {"n_layers": [get_config(arch).n_layers, layers],
                       "why": why_reduced},
           "dtype": "float32", "params_per_replica": n_params,
           "replicas": replicas, "local_world": TRAIN_LOCAL_WORLD, "b_max": TRAIN_B_MAX,
           "lr": lr, "optimizer": "sgd(0.9, 1e-4)", "seq_len": TRAIN_SEQ,
           "prefix_rows": cfg.prefix_embed_len,
           "seqs_per_replica": TRAIN_PER, "steps": steps,
           "mode_counts": {m: modes.count(m) for m in sorted(set(modes))},
           "controller": type(res.controller).__name__,
           "level_sync_counts": res.controller.level_sync_counts(),
           "launches": launches,
           "sync_fraction": res.sync_fraction,
           "first_loss": losses[0], "last_loss": losses[-1], "losses": losses,
           "wall_s": wall, "max_memory_allocated": peak, "memory": memory}
    stats = res.executor_stats
    if stats is None:
        by_mode = {}
        for m, sec in zip(modes, res.step_seconds):
            by_mode.setdefault(m, []).append(1e3 * sec)
        row.update(step_ms_median={m: statistics.median(v) for m, v in by_mode.items()},
                   step_ms_all=by_mode)
    else:
        row.update(executor_stats=dataclasses.asdict(stats),
                   dispatches_per_step=stats.dispatches_per_step(),
                   programs_built=stats.compiles, fallback_steps=stats.fallback_steps,
                   cycle_ms=cycle_rows(res))
    if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]):
        emit({**row, "failed": "loss"})
        raise AssertionError(f"{name} losses {losses[0]} -> {losses[-1]}")
    return (res if report is None else report), row, launches, \
        [outer_mode(m) for m in modes], params0


def check_launches(row, launches, want):
    row["launches_expected"] = want
    if launches != want:
        emit({**row, "failed": "launch counts"})
        raise AssertionError(f"{row['phase']} launches {launches} != {want}")


INT8_OVERLAP = {"wire_format": "int8", "overlap": "one_cycle"}
INT8_OVERLAP_WHY = ("memory: the carry holds params, momentum, the in-flight buffer and "
                    "the pending snapshot for 4 replicas in f32")


def int8_overlap_launches(modes):
    """One f32 arena: K5 and K6 once per ov_sync and once per blocking
    step, K2 once per ov_sync step, K3 and K4 never."""
    n_sync, n_blocking = modes.count("ov_sync"), modes.count("blocking")
    return {**no_launches(), "eq1_merge": n_sync, "quantize_int8": n_sync + n_blocking,
            "dequantize_int8": n_sync + n_blocking}


def phase_train_int8_overlap():
    """The int8 wire tier and the one-cycle overlap schedule through
    run_training on the per-step executor. Returns its launches, step ms
    medians and final params (copied to the host)."""
    res, row, launches, modes, params0 = run_train_phase(
        "train_int8_overlap", {"executor": "per_step", **INT8_OVERLAP}, INT8_OVERLAP_WHY)
    check_launches(row, launches, int8_overlap_launches(modes))
    row["wire_bytes_per_exchange"] = {
        t: compression.transfer_bytes(params0, wire_format=t) for t in ("f32", "bf16", "int8")}
    emit(row)
    params_r, opt_r = res.carry[:2]
    carry = [x.cpu() for x in leaves((params_r, opt_r))]
    del res, params0, params_r, opt_r
    torch.cuda.empty_cache()
    return {"launches": launches, "step_ms_median": row["step_ms_median"], "carry": carry}


@contextmanager
def exchange_streams():
    """Record, for each call of K5's wrapper, whether it ran on a stream
    other than the current one (the executor's exchange stream); the
    wrapper itself still launches and counts."""
    main, calls, quantize = torch.cuda.current_stream(), [], ops.quantize_int8

    def spy(*args, **kw):
        calls.append(torch.cuda.current_stream() != main)
        return quantize(*args, **kw)

    ops.quantize_int8 = spy
    try:
        yield calls
    finally:
        ops.quantize_int8 = quantize


OVERLAP_LEGS = ("overlap_compute_s", "overlap_exchange_visible_s",
                "overlap_exchange_blocking_s", "overlap_merge_s")


def steady_overlap_cycles(res):
    """Walls (ms, staged batches to metrics on the host, so the card has
    finished) of the run's (local x 3, ov_sync) cycles, the first left out
    (it carries the exchange stream's and the allocator's warm-up)."""
    walls = [1e3 * sec for shape, sec in res.cycles
             if len(shape) > 1 and shape[-1][0].startswith("ov_sync")]
    return walls[1:]


def carry_matches(carry, host_leaves):
    """Params and momentum of every replica bit for bit the host copies,
    one leaf at a time on the card."""
    params_r, opt_r = carry[:2]
    return all(same_bits(a, b.to(a.device))
               for a, b in zip(leaves((params_r, opt_r)), host_leaves, strict=True))


def phase_train_macro_int8_overlap(per_step):
    """The train_int8_overlap cell through the macro-cycle executor: with
    each overlap exchange on the executor's stream while the cycle's local
    steps run, then with serial_exchange. Both give the per-step run's final
    carry (params and momentum of every replica) bit for bit, and so each
    other's, and its launches; each overlap cycle runs K5 once on the
    exchange stream, each blocking step once on the main one; the legs
    partition the overlap wall.

    What the stream hides on the card is the serial run's steady cycle
    wall less the overlap run's, cycle by cycle (`saved_ms_per_cycle`):
    the walls end on the cycle's metrics reaching the host, so each is the
    card's time for the cycle. `host_wait_hidden_fraction`, 1 - visible /
    blocking over the two runs, is a host number: the host waits for the
    exchange only after it has waited for the local steps, so it reads
    near 1 whether or not the card ran the two streams at once.
    `profile_train.py` gives the device trace of one cycle (the exchange
    stream's kernel time, and how much of it ran beside the local steps'
    kernels). Returns the first run's launches, losses and steady cycle
    walls."""
    out, visible, walls = None, None, None
    for serial in (False, True):
        name = "train_macro_int8_overlap" + ("_serial" if serial else "")
        with exchange_streams() as on_side:
            res, row, launches, modes, params0 = run_train_phase(
                name, {"executor": "macro", **INT8_OVERLAP,
                       "overlap_serial_exchange": serial}, INT8_OVERLAP_WHY)
        check_launches(row, launches, int8_overlap_launches(modes))
        st = res.executor_stats
        n_sync, n_side = modes.count("ov_sync"), sum(on_side)
        legs = sum(getattr(st, k) for k in OVERLAP_LEGS)
        steady = steady_overlap_cycles(res)
        row.update(
            k5_calls={"exchange_stream": n_side, "main_stream": len(on_side) - n_side},
            legs_sum_s=legs,
            steady_cycle_ms=steady, steady_cycle_ms_median=statistics.median(steady),
            per_step_ms_median=per_step["step_ms_median"],
            carry_identical_to_per_step=carry_matches(res.carry, per_step["carry"]))
        if serial:
            saved = [b - a for a, b in zip(walls, steady, strict=True)]
            row.update(saved_ms_per_cycle=saved,
                       saved_ms_per_cycle_median=statistics.median(saved),
                       exchange_blocking_ms_per_cycle_host=(
                           1e3 * st.overlap_exchange_blocking_s / st.overlap_cycles),
                       host_wait_hidden_fraction=(
                           1.0 - visible / st.overlap_exchange_blocking_s))
        else:
            visible, walls = st.overlap_exchange_visible_s, steady
            out = {"launches": launches, "losses": res.losses, "steady_cycle_ms": steady}
        faults = [what for what, bad in (
            ("overlap cycles", not st.overlap_cycles == n_side == n_sync > 0),
            ("blocking K5 off the main stream", len(on_side) - n_side != modes.count("blocking")),
            ("legs", abs(legs - st.overlap_wall_s) > 1e-9 * st.overlap_wall_s),
            ("carry", not row["carry_identical_to_per_step"])) if bad]
        if faults:
            emit({**row, "failed": faults})
            raise AssertionError(f"{name}: {faults}")
        emit(row)
        del res, params0
        torch.cuda.empty_cache()
    return out


@contextmanager
def run_trace(name):
    """A Tracer writing one stream into a fresh temporary directory, for one
    run_training. Yields (tracer, events); after the block the tracer is
    closed, its stream merged into one file (`merge_streams`) and that
    file's events put in `events`. The directory is removed."""
    tmp = tempfile.mkdtemp(prefix=f"chip_smoke_{name}_")
    base = os.path.join(tmp, "trace.jsonl")
    tracer, events = Tracer(stream_path(base, 0), proc_id=0), []
    try:
        yield tracer, events
        tracer.close()
        if merge_streams(base) != base:
            raise AssertionError(f"{name}: no trace stream to merge")
        events.extend(load_events(base))
    finally:
        tracer.close()
        shutil.rmtree(tmp, ignore_errors=True)


def span_summary(events):
    """Count, total ms and median ms of each span name."""
    durs = {}
    for ev in events:
        if ev["ph"] == "X":
            durs.setdefault(ev["name"], []).append(ev["dur"] / 1e3)
    return {n: {"count": len(v), "total_ms": sum(v), "median_ms": statistics.median(v)}
            for n, v in sorted(durs.items())}


def trace_faults(events, res):
    """What every traced macro run's trace holds: each event valid and the
    file sorted by time; the cycle spans' steps covering the run and their
    per-level syncs adding to `level_sync_counts`; one compile instant per
    program built and one fresh_compile cycle per compile; one span of
    each overlap leg per overlap cycle; each cycle span at least its
    SimResult.cycles seconds (to the microsecond)."""
    st = res.executor_stats
    cycles = [ev for ev in events if ev["name"] == "cycle"]
    names = [ev["name"] for ev in events]
    counts_ = res.controller.level_sync_counts()
    legs = ("ov_compute", "ov_merge") + (("ov_exchange_visible",)
                                         if st.overlap_exchange_blocking_s == 0 else
                                         ("ov_exchange_blocking",))
    return [what for what, bad in (
        ("invalid events", any(validate_event(ev) is not None for ev in events)),
        ("not sorted", [ev["ts"] for ev in events] != sorted(ev["ts"] for ev in events)),
        ("cycle steps", sum(ev["args"]["steps"] for ev in cycles) != len(res.losses)),
        ("cycle syncs", any(sum(ev["args"]["syncs"].get(k, 0) for ev in cycles) != n
                            for k, n in counts_.items())),
        ("compiles", names.count("compile") != st.compiles
         or sum(ev["args"]["fresh_compile"] for ev in cycles) != st.compiles),
        ("overlap legs", any(names.count(n) != st.overlap_cycles for n in legs)),
        ("cycle walls", len(cycles) != len(res.cycles) or any(
            ev["dur"] < int(sec * 1e6) for ev, (_, sec) in zip(cycles, res.cycles))))
        if bad]


def phase_train_trace(per_step, untraced):
    """The train_macro_int8_overlap cell (macro, int8 wire, one_cycle) with
    a tracer: the carry (params and momentum of every replica) bit for bit
    the per-step run's in `per_step`, the losses bit for bit the untraced
    macro run's in `untraced`, the same launches; the trace holds what
    `trace_faults` lists, and the tracer's own cost is below 1 % of the
    run's wall. Prints the span totals by name, the event count, the
    overhead, and the steady overlap cycle walls beside the untraced
    run's, and what the phase cost the script (`phase_wall_s`). Returns
    its launches."""
    t0 = time.perf_counter()
    with run_trace("train_trace") as (tracer, events):
        res, row, launches, modes, params0 = run_train_phase(
            "train_trace", {"executor": "macro", **INT8_OVERLAP}, INT8_OVERLAP_WHY,
            tracer=tracer)
    check_launches(row, launches, int8_overlap_launches(modes))
    steady = steady_overlap_cycles(res)
    row.update(
        events=len(events), event_names=dict(collections.Counter(ev["name"] for ev in events)),
        tracer_overhead_ms=1e3 * tracer.overhead_s,
        tracer_overhead_fraction=tracer.overhead_s / row["wall_s"],
        spans=span_summary(events),
        steady_cycle_ms=steady, steady_cycle_ms_median=statistics.median(steady),
        untraced_steady_cycle_ms=untraced["steady_cycle_ms"],
        untraced_steady_cycle_ms_median=statistics.median(untraced["steady_cycle_ms"]),
        # what a cycle span holds beyond the cycle's seconds: its batches'
        # staging (data generation, torch.stack, the lrs)
        cycle_span_less_seconds_ms=[
            ev["dur"] / 1e3 - 1e3 * sec for ev, (_, sec) in
            zip((ev for ev in events if ev["name"] == "cycle"), res.cycles)],
        losses_identical_to_untraced=res.losses == untraced["losses"],
        carry_identical_to_per_step=carry_matches(res.carry, per_step["carry"]))
    faults = trace_faults(events, res) + [what for what, bad in (
        ("losses", not row["losses_identical_to_untraced"]),
        ("carry", not row["carry_identical_to_per_step"]),
        ("overhead", row["tracer_overhead_fraction"] >= 0.01),
        ("no overlap cycle", res.executor_stats.overlap_cycles == 0)) if bad]
    if faults:
        emit({**row, "failed": faults})
        raise AssertionError(f"train_trace: {faults}")
    del res, params0
    torch.cuda.empty_cache()
    emit({**row, "phase_wall_s": time.perf_counter() - t0})
    return launches


LAUNCH_STEPS = 12


def phase_launch_trace():
    """The launcher on the card: repro_torch.launch.train.main with --tiny,
    --trace-out and --metrics-out, 12 steps (DASO, macro, the paper's
    wires). The merged trace holds one run_metadata event and one
    comm_meters counter, and what `trace_faults` lists; the comm_meters
    rows in the metrics file equal `level_bytes_report` computed here;
    K2 / K3 launch as the modes imply. Returns its launches."""
    from repro_torch.launch import train as launch_train

    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_launch_trace_")
    trace_path, metrics_path = os.path.join(tmp, "t.jsonl"), os.path.join(tmp, "m.json")
    try:
        sync()
        zero_counts()
        res = launch_train.main(["--tiny", "--steps", str(LAUNCH_STEPS), "--trace-out",
                                 trace_path, "--metrics-out", metrics_path])
        sync()
        launches = counts()
        events = load_events(trace_path)
        with open(metrics_path) as f:
            metrics = json.load(f)
        with open(trace_path) as f:
            merged_lines = sum(1 for line in f if line.strip())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    ctrl = res.controller
    rows = meters.level_bytes_report(res.params, ctrl.level_sync_counts(), ctrl.cfg,
                                     outer_split=meters.outer_sync_split(ctrl.history))
    names = [ev["name"] for ev in events]
    meta = next((ev["args"] for ev in events if ev["name"] == "run_metadata"), {})
    comm = next((ev["args"] for ev in events if ev["name"] == "comm_meters"), None)
    modes = [outer_mode(h[1]) for h in ctrl.history]
    row = {"phase": "launch_trace", "entry": "repro_torch.launch.train.main",
           "argv": ["--tiny", "--steps", LAUNCH_STEPS, "--trace-out", "T", "--metrics-out", "M"],
           "device": metrics["device"], "events": len(events), "merged_lines": merged_lines,
           "event_names": dict(collections.Counter(names)), "run_metadata": meta,
           "comm_meters": metrics.get("comm_meters"), "launches": launches,
           "spans": span_summary(events), "final_loss": res.final_loss}
    faults = trace_faults(events, res) + [what for what, bad in (
        ("not the merged trace", merged_lines != len(events) or not events),
        ("run_metadata", names.count("run_metadata") != 1 or meta.get("procs") != 1),
        ("comm_meters counter", names.count("comm_meters") != 1
         or comm != meters.rows_as_counter(rows)),
        ("comm_meters rows", metrics.get("comm_meters") != [
            {**dataclasses.asdict(r), "total_bytes": r.total_bytes} for r in rows]),
        ("device", not metrics["device"].startswith("cuda")),
        ("launches", launches != train_launches(modes))) if bad]
    if faults:
        emit({**row, "failed": faults})
        raise AssertionError(f"launch_trace: {faults}")
    del res
    torch.cuda.empty_cache()
    emit({**row, "phase_wall_s": time.perf_counter() - t0})
    return launches


# train_resume: one TrainState lands at the first cycle boundary at or past
# step RESUME_EVERY of RESUME_STEPS (none at the end: 2 x 9 > 16)
RESUME_STEPS, RESUME_EVERY = 16, 9


@contextmanager
def timed_calls(module, name):
    """Host seconds of each call of `module.name` (the train loop's
    save_train_state / load_train_state), appended to the yielded list."""
    fn, seconds = getattr(module, name), []

    def spy(*args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        seconds.append(time.perf_counter() - t0)
        return out

    setattr(module, name, spy)
    try:
        yield seconds
    finally:
        setattr(module, name, fn)


def host_carry(carry):
    """Every leaf of an f32 carry on the host, in `leaves` order: a leaf
    that appears twice copied once, an expanded one as its first row."""
    copies = {}
    for x in leaves(carry):
        if id(x) not in copies:
            copies[id(x)] = (x[:1].cpu().expand(x.shape) if x.dim() and x.stride(0) == 0
                             else x.cpu())
    return [copies[id(x)] for x in leaves(carry)]


def tree_structure(tree):
    """The containers of a tree, its leaves as None (empty lists kept)."""
    if isinstance(tree, dict):
        return {k: tree_structure(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_structure(v) for v in tree)
    return None


def carry_identical(carry, host):
    """Bit for bit, leaf by leaf on the card."""
    for a, b in zip(leaves(carry), host, strict=True):
        if a.shape != b.shape or a.dtype != b.dtype:
            return False
        b = (b[:1].to(a.device).expand(b.shape) if b.dim() and b.stride(0) == 0
             else b.to(a.device))
        if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
            return False
    return True


def phase_train_resume():
    """Checkpoints and resume on the card: llama3.2-1b at full width, 1
    layer, f32, R = 4, the int8 wire and the one_cycle overlap on the macro
    executor (4-slot carry, each exchange on the executor's stream).
    run_training uninterrupted with one TrainState mid-run, then
    run_training resumed from it for the remaining steps: the final carry
    (params, momentum, in-flight and pending of every replica) and the loss
    trace bit for bit the uninterrupted run's, the resumed run's K2 / K5 /
    K6 launches what its modes imply, and its peak no higher. The
    TrainState is written into a fresh temporary directory, removed after;
    a disk too small for the carry fails the phase."""
    from repro_torch.checkpoint.io import list_train_state_dirs
    from repro_torch.train import loop

    cfg = train_config(1)
    params0 = init_params(cfg, torch.Generator(device="cuda").manual_seed(3), "cuda")
    n_params = sum(x.numel() for x in leaves(params0))
    data = replica_data(SyntheticLM(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ, seed=3))
    carry_bytes = 4 * TRAIN_R * n_params * 4  # four slots of R f32 rows
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_resume_")
    row = {"phase": "train_resume", "arch": ARCH, "layers": 1, "dtype": "float32",
           "replicas": TRAIN_R, "executor": "macro", **INT8_OVERLAP,
           "steps": RESUME_STEPS, "ckpt_every": RESUME_EVERY,
           "params_per_replica": n_params, "carry_bytes": carry_bytes}
    try:
        free = shutil.disk_usage(tmp).free
        row["disk_free_bytes"] = free
        if free < carry_bytes:
            emit({**row, "failed": "disk"})
            raise RuntimeError(f"train_resume: {free} bytes free in {tmp}, the "
                               f"checkpoint takes {carry_bytes}")

        def run(tracer=None, **options):
            loop_cfg = TrainLoopConfig(
                strategy="daso", n_steps=RESUME_STEPS, n_replicas=TRAIN_R,
                local_world=TRAIN_LOCAL_WORLD, b_max=TRAIN_B_MAX, lr=TRAIN_LR,
                device="cuda", executor="macro", **INT8_OVERLAP, **options)
            sync()
            torch.cuda.reset_peak_memory_stats()
            zero_counts()
            t0 = time.perf_counter()
            res = run_training(make_lm_loss(cfg), params0, data, loop_cfg,
                               optimizer=sgd(momentum=0.9, weight_decay=1e-4), log=None,
                               tracer=tracer)
            sync()
            return res, counts(), torch.cuda.max_memory_allocated(), time.perf_counter() - t0

        with (timed_calls(loop, "save_train_state") as save_s,
              run_trace("train_resume") as (tracer, events)):
            full, full_launches, full_peak, full_s = run(ckpt_every=RESUME_EVERY,
                                                         ckpt_dir=tmp, tracer=tracer)
        saves = [ev for ev in events if ev["name"] == "checkpoint_save"]
        row.update(checkpoint_save_spans=[{"step": ev["args"]["step"], "ms": ev["dur"] / 1e3}
                                          for ev in saves],
                   trace_events=len(events), tracer_overhead_ms=1e3 * tracer.overhead_s)
        span_faults = trace_faults(events, full)
        if len(saves) != 1 or not (int(save_s[0] * 1e6) <= saves[0]["dur"]
                                   <= (save_s[0] + 0.5) * 1e6):
            span_faults.append("checkpoint_save span")
        if span_faults:
            emit({**row, "save_s": save_s, "failed": span_faults})
            raise AssertionError(f"train_resume: {span_faults}")
        dirs = list_train_state_dirs(tmp)
        if len(dirs) != 1 or len(save_s) != 1:
            emit({**row, "failed": "one TrainState", "dirs": dirs})
            raise AssertionError(f"train_resume: TrainStates {dirs}")
        ckpt_bytes = sum(os.path.getsize(os.path.join(dirs[0], f))
                         for f in os.listdir(dirs[0]))
        want_carry, want_losses = host_carry(full.carry), full.losses
        want_tree = tree_structure(full.carry)
        modes = [split_ov(h[1])[0] for h in full.controller.history]
        del full
        torch.cuda.empty_cache()
        with timed_calls(loop, "load_train_state") as load_s:
            resumed, launches, peak, resumed_s = run(resume_from=dirs[0])
        k = int(os.path.basename(dirs[0]).removeprefix("step_"))
        resumed_modes = [split_ov(h[1])[0] for h in resumed.controller.history if h[0] >= k]
        row.update(
            resumed_from_step=k, checkpoint_dir_name=os.path.basename(dirs[0]),
            checkpoint_bytes=ckpt_bytes, save_s=save_s[0], load_s=load_s[0],
            save_gb_per_s=ckpt_bytes / save_s[0] / 1e9,
            load_gb_per_s=ckpt_bytes / load_s[0] / 1e9,
            uninterrupted_s=full_s, resumed_s=resumed_s,
            uninterrupted_peak=full_peak, resumed_peak=peak,
            uninterrupted_launches=full_launches, launches=launches,
            launches_expected=int8_overlap_launches(resumed_modes),
            mode_counts_resumed={m: resumed_modes.count(m) for m in sorted(set(resumed_modes))},
            losses_identical=resumed.losses == want_losses,
            carry_identical=carry_identical(resumed.carry, want_carry),
            carry_tree_identical=tree_structure(resumed.carry) == want_tree,
            first_loss=want_losses[0], last_loss=want_losses[-1])
        faults = [what for what, bad in (
            ("uninterrupted launches", full_launches != int8_overlap_launches(modes)),
            ("launches", launches != row["launches_expected"]),
            ("losses", not row["losses_identical"]),
            ("carry", not row["carry_identical"]),
            ("carry tree", not row["carry_tree_identical"]),
            ("resume step", not 0 < k < RESUME_STEPS or len(resumed_modes) != RESUME_STEPS - k),
            ("peak", peak > full_peak)) if bad]
        del resumed, want_carry
        if faults:
            emit({**row, "failed": faults})
            raise AssertionError(f"train_resume: {faults}")
        emit(row)
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        del params0
        torch.cuda.empty_cache()


TRAIN_WHY = ("memory: the carry holds params, momentum and the in-flight buffer for "
             "4 replicas in f32")


def train_launches(modes):
    """One floating arena (all params f32): one K2 launch per receive step,
    one K3 launch per blocking step."""
    return {**no_launches(), "eq1_merge": sum(m in ("receive", "send_receive") for m in modes),
            "bf16_pack": modes.count("blocking")}


def phase_train():
    """run_training with DASO at llama3.2-1b's published widths on the
    per-step executor, the paper's exchange: f32 in the cycling phase, bf16
    in the blocking one."""
    res, row, launches, modes, params0 = run_train_phase(
        "train", {"executor": "per_step"}, TRAIN_WHY)
    check_launches(row, launches, train_launches(modes))
    emit(row)
    params_r, opt_r, _ = res.carry
    del res, params0
    torch.cuda.empty_cache()
    return {"carry": (params_r, opt_r), "launches": launches}


def phase_train_macro(trained):
    """The train cell through the macro-cycle executor: its final carry
    (params and momentum of every replica) bit for bit the per-step carry
    in `trained`, which stays on the card for the arena phase. Returns its
    launches, losses, the digest of every row of its final carry (all three
    slots), its ms per step by cycle shape, its peak and wall."""
    res, row, launches, modes, params0 = run_train_phase(
        "train_macro", {"executor": "macro"}, TRAIN_WHY)
    check_launches(row, launches, train_launches(modes))
    params_r, opt_r, _ = res.carry
    row["carry_identical_to_per_step"] = all(
        same_bits(a, b) for a, b in zip(leaves((params_r, opt_r)), leaves(trained["carry"]),
                                        strict=True))
    if not row["carry_identical_to_per_step"]:
        emit({**row, "failed": "carry"})
        raise AssertionError("train_macro: the carry differs from the per-step carry")
    emit(row)
    out = {"launches": launches, "losses": res.losses, "digests": row_digests(res.carry),
           "cycle_ms": row["cycle_ms"], "max_memory_allocated": row["max_memory_allocated"],
           "wall_s": row["wall_s"]}
    del res, params0, params_r, opt_r
    torch.cuda.empty_cache()
    return out


def phase_train_moe():
    """run_training with DASO on granite-moe-3b-a800m at full width, 4 of its
    32 layers, f32, R = 4, the train cell's settings, on the macro executor:
    K2 / K3 launches as the modes imply, the loss falls, every step's mean
    load-balance and z losses finite and non-zero. Prints ms per step by
    cycle shape, the peak, wire bytes per exchange and the drop fraction per
    layer, averaged over the steps."""
    res, row, launches, modes, params0 = run_train_phase(
        "train_moe", {"executor": "macro"}, TRAIN_WHY, arch=MOE_ARCH)
    cfg = train_config(TRAIN_LAYERS, MOE_ARCH)
    row["widths"].update(moe_widths(cfg))
    check_launches(row, launches, train_launches(modes))
    # each step's means over the replicas of the sums over the layers
    aux = {k: [float(m[k]) for m in res.metrics]
           for k in ("moe_lb_loss", "moe_z_loss", "moe_drop_frac")}
    row.update(wire_bytes_per_exchange={
        t: compression.transfer_bytes(params0, wire_format=t) for t in ("f32", "bf16")},
        moe_aux_by_step=aux,
        moe_drop_frac_per_layer_mean=statistics.mean(aux["moe_drop_frac"]) / TRAIN_LAYERS)
    bad = [k for k in ("moe_lb_loss", "moe_z_loss")
           if len(aux[k]) != row["steps"] or not all(math.isfinite(v) and v != 0 for v in aux[k])]
    del res, params0
    torch.cuda.empty_cache()
    if bad:
        emit({**row, "failed": f"aux losses {bad} not finite and non-zero at every step"})
        raise AssertionError(f"train_moe aux {bad}")
    emit(row)
    return launches


VLM_WHY = ("memory: at its 28 layers qwen2-vl-2b holds 1.54 B params a replica, 24.7 GB "
           "per f32 copy of the 4 replicas, and the carry holds three (params, momentum, "
           "in-flight); 4 layers hold 420.6 M a replica")


def phase_train_vlm():
    """run_training with DASO on qwen2-vl-2b at full width, 4 of its 28
    layers, f32, R = 4, the train cell's settings and VLM_STEPS steps, on
    the macro executor, every replica batch with a stub prefix
    (`prefix_data`): K2 / K3 launches as the modes imply, the loss falls,
    the final carry finite. Prints ms per step by cycle shape, the peak and
    wire bytes per exchange."""
    res, row, launches, modes, params0 = run_train_phase(
        "train_vlm", {"executor": "macro"}, VLM_WHY, arch=VLM_ARCH, steps=VLM_STEPS)
    row["widths"].update(dense_widths(train_config(TRAIN_LAYERS, VLM_ARCH)))
    check_launches(row, launches, train_launches(modes))
    row["carry_finite"] = all(bool(torch.isfinite(x).all()) for x in leaves(res.carry)
                              if x.is_floating_point())
    row["wire_bytes_per_exchange"] = {
        t: compression.transfer_bytes(params0, wire_format=t) for t in ("f32", "bf16")}
    del res, params0
    torch.cuda.empty_cache()
    if not row["carry_finite"]:
        emit({**row, "failed": "carry not finite"})
        raise AssertionError("train_vlm: the final carry is not finite")
    emit(row)
    return launches


# The recurrent train cells: the train cell's settings at the published
# widths of falcon-mamba-7b and recurrentgemma-9b, 1 layer each, RECURRENT_STEPS
# steps (warm-up, cycling with receive steps and a blocking cool-down)
RECURRENT_STEPS = 16
# What a step's peak holds, as the allocator's history of these cells shows
# it (the memory.traced_run rows): 4 (5R + 5) bytes a param
PEAK_COPIES = ("the carry's params and momentum and the step's new ones (4R f32 copies), "
               "the receive merge's params (R), one replica's gradient and its update's "
               "params and momentum (3), the in-flight mean and params0 (2)")
RECURRENT_CELLS = {
    "train_mamba": (MAMBA_ARCH, TRAIN_R, ("ssm_scan", "ssm_scan_bwd"), (
        "memory: a step peaks at 4 (5R + 5) bytes a param, 100 at R = 4: "
        f"{PEAK_COPIES}; 1 of falcon-mamba-7b's 64 layers holds 637,992,960 params a "
        "replica, 63.8 GB, and 2 layers (743,305,216) would take 74.3 GB, within 10 GB "
        "of the 84.2 GB the allocator may hold on the card")),
    "train_rgemma": (RGEMMA_ARCH, 2, ("rglru_scan", "rglru_scan_bwd"), (
        "memory: a step peaks at 4 (5R + 5) bytes a param: "
        f"{PEAK_COPIES}; 1 of recurrentgemma-9b's 38 layers (one RG-LRU block and its "
        "MLP) holds 1,283,502,080 params a replica, most of them the tied 1.05 B-param "
        "embedding: 128 GB at R = 4, and at R = 2 (P = 8) 77.0 GB, 7.1 GB below the "
        "84.2 GB the allocator may hold on the card")),
}
# recurrent_grad_hold: each leaf of one replica's loss gradient through the
# kernels within this share of the leaf's largest magnitude of the same
# gradient with the scans' plain versions (f32 sums in other orders, carried
# through one layer; a wiring fault, such as a dropped Bm / Cm gradient,
# moves a leaf by its own size)
GRAD_HOLD_RTOL = 1e-3


# the caching allocator's history of a traced run: events kept at most
MEMORY_EVENTS = 2_000_000


def frame_key(frames):
    """"file:line function" of the innermost frame of the port (or of this
    script) among an allocation's Python frames, innermost first; blocks
    asked for where no Python frame runs (autograd's backward thread)
    count as "autograd backward"."""
    for f in frames:
        path = f["filename"]
        if "repro_torch/" in path:
            return f"{path.split('repro_torch/')[-1]}:{f['line']} {f['name']}"
        if path.endswith("chip_smoke.py"):
            return f"chip_smoke.py:{f['line']} {f['name']}"
    return "autograd backward" if not frames else f"{frames[0]['filename']}:{frames[0]['line']}"


def peak_composition(fn):
    """fn() under the caching allocator's history. Returns (fn's result, a
    row): the largest net bytes allocated while fn ran (the blocks live
    before it excluded, as `peak_above_start` counts them), the bytes of
    the blocks live at that moment by `frame_key`, largest first, and the
    event count."""
    torch.cuda.memory._record_memory_history(max_entries=MEMORY_EVENTS, context="alloc",
                                             stacks="python")
    try:
        out = fn()
        sync()
        trace = torch.cuda.memory._snapshot()["device_traces"][torch.cuda.current_device()]
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
    events = [e for e in trace if e["action"] in ("alloc", "free_completed")]
    net = best = 0
    at = -1
    for i, e in enumerate(events):
        net += e["size"] if e["action"] == "alloc" else -e["size"]
        if net > best:
            best, at = net, i
    live = {}
    for e in events[:at + 1]:
        if e["action"] == "alloc":
            live[e["addr"]] = e
        else:
            live.pop(e["addr"], None)
    by_frame = collections.Counter()
    for e in live.values():
        by_frame[frame_key(e.get("frames", []))] += e["size"]
    return out, {"traced_peak_above_start": best, "live_at_peak": dict(by_frame.most_common()),
                 "events": len(trace), "events_capped": len(trace) >= MEMORY_EVENTS}


def recurrent_layers(cfg):
    """The mamba and RG-LRU layers of `cfg` (layer i has pattern slot i mod
    the pattern's length)."""
    kinds = [cfg.layer_pattern[i % len(cfg.layer_pattern)] for i in range(cfg.n_layers)]
    return sum(k in ("mamba", "rglru") for k in kinds)


def phase_recurrent_grad_hold():
    """At the train cells' widths (1 layer, f32), one replica's loss gradient
    (`daso.value_and_grad` of `make_lm_loss`, 2 x 256 tokens) through K7 /
    K7-bwd and K8 / K8-bwd, against the same gradient with `ops.ssm_scan` /
    `ops.rglru_scan` swapped for their plain versions (autograd through
    kernels/ref.py, as `plain_scan` swaps them): every leaf within
    GRAD_HOLD_RTOL of its largest magnitude, the kernels launched once each
    on the kernel path and never on the plain one. Returns the kernel path's
    launches by arch."""
    rows, out = [], {}
    for name, (arch, _, kernels, _) in RECURRENT_CELLS.items():
        cfg = train_config(1, arch)
        params = init_params(cfg, torch.Generator(device="cuda").manual_seed(7), "cuda")
        src = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ, seed=7)
        batch = {k: v[0] for k, v in replica_data(src, 1)(0).items()}
        vg = daso.value_and_grad(make_lm_loss(cfg))
        zero_counts()
        (loss, _), grads = vg(params, batch)
        sync()
        launched = counts()
        with plain_scan():
            zero_counts()
            (plain_loss, _), plain = vg(params, batch)
            sync()
            plain_launched = counts()
        errs = [scaled_err(a, b) for a, b in zip(leaves(grads), leaves(plain), strict=True)]
        want = {**no_launches(), kernels[0]: 1, kernels[1]: 1}
        row = {"arch": arch, "layers": 1, "params": sum(x.numel() for x in leaves(params)),
               "loss": loss.item(), "plain_loss": plain_loss.item(),
               "worst_leaf_scaled_err": max(errs), "leaf_scaled_errs": errs,
               "tolerance": GRAD_HOLD_RTOL, "launches": launched,
               "plain_launches": plain_launched}
        rows.append(row)
        out[arch] = launched
        del params, grads, plain, loss, plain_loss
        torch.cuda.empty_cache()
        faults = [what for what, bad in (
            ("leaf", not all(math.isfinite(e) and e <= GRAD_HOLD_RTOL for e in errs)),
            ("launches", launched != want), ("plain launches", plain_launched != no_launches()))
            if bad]
        if faults:
            emit({"phase": "recurrent_grad_hold", "failed": faults, **row})
            raise AssertionError(f"recurrent_grad_hold {arch}: {faults}")
    emit({"phase": "recurrent_grad_hold", "archs": rows})
    return out


def phase_train_recurrent(name):
    """run_training with DASO at the published widths of the cell's arch, 1
    layer, f32, the train cell's settings at the cell's R, RECURRENT_STEPS
    steps on the macro executor: the loss falls, the final carry is finite,
    K2 / K3 launch as the modes imply (each at least once), the scan and its
    backward once per recurrent layer, replica and step, K1 never (attention
    trains plain). Prints ms per step by cycle shape, the peak and the wire
    bytes per exchange. Then runs the cell again under the allocator's
    history (`peak_composition`, untimed): what is live at the peak, and
    the room the card had left there."""
    arch, replicas, kernels, why = RECURRENT_CELLS[name]
    torch.cuda.empty_cache()
    free, card = torch.cuda.mem_get_info()
    room = free + torch.cuda.memory_reserved()  # what the allocator may hold
    res, row, launches, modes, params0 = run_train_phase(
        name, {"executor": "macro"}, why, arch=arch, layers=1, replicas=replicas,
        steps=RECURRENT_STEPS)
    cfg = train_config(1, arch)
    row["widths"].update(mamba_widths(cfg) if arch == MAMBA_ARCH else rgemma_widths(cfg))
    per_step = recurrent_layers(cfg) * replicas
    want = {**train_launches(modes), kernels[0]: per_step * RECURRENT_STEPS,
            kernels[1]: per_step * RECURRENT_STEPS}
    check_launches(row, launches, want)
    row["carry_finite"] = all(bool(torch.isfinite(x).all()) for x in leaves(res.carry)
                              if x.is_floating_point())
    row["wire_bytes_per_exchange"] = {
        t: compression.transfer_bytes(params0, wire_format=t) for t in ("f32", "bf16")}
    del res, params0
    torch.cuda.empty_cache()
    start = torch.cuda.memory_allocated()
    traced_peak, composition = peak_composition(lambda: run_train_phase(
        name, {"executor": "macro"}, why, arch=arch, layers=1, replicas=replicas,
        steps=RECURRENT_STEPS)[1]["max_memory_allocated"])
    torch.cuda.empty_cache()
    row["memory"].update(card_bytes=card, room_at_start=room,
                         room_left_at_peak=room - row["max_memory_allocated"],
                         traced_run={"allocated_before": start,
                                     "max_memory_allocated": traced_peak, **composition})
    faults = [what for what, bad in (
        ("carry not finite", not row["carry_finite"]),
        ("no receive step", want["eq1_merge"] < 1),
        ("no blocking step", want["bf16_pack"] < 1)) if bad]
    if faults:
        emit({**row, "failed": faults})
        raise AssertionError(f"{name}: {faults}")
    emit(row)
    return launches


# The topology cells: 4 replicas in 2 pods of 2 hosts (R = 4, P = 16, the
# train cell's sizes). The host links run at twice the pod links' rate, so
# the lowering gives the host level B_host = round(4 * 25 / 50) = 2: the
# pairs {0, 1} and {2, 3} average their params every second step, between
# the pod level's DASO exchanges.
TOPO_SPEC = "chip:4 x host:2@50e9 x pod:2@25e9"
TOPO_2LEVEL = "chip:4 x pod:4"
HOST_GROUPS = ((0, 1), (2, 3))


def host_rows_identical(params_r):
    """Replicas {0, 1} and {2, 3} hold bit-identical rows in every leaf."""
    return all(same_bits(x[a], x[b]) for x in leaves(params_r) for a, b in HOST_GROUPS)


@contextmanager
def host_sync_checks():
    """Hold, after every step whose token carries the host level, the host
    groups' rows bit for bit (`host_rows_identical`). Each step variant's
    output params are kept (no copy) and checked when the next step's batch
    is made, before that step's clock starts, so no check lands in a timed
    step; call it once more after the last step. Yields (check, results),
    results one (step, identical) pair per host step."""
    step_fn, last, results = DasoStrategy.step_fn, [], []

    def spy(self, mode, staleness):
        fn = step_fn(self, mode, staleness)

        def run(carry, batch, lr):
            out = fn(carry, batch, lr)
            last[:] = [(mode, out[0][0])]
            return out
        return run

    def check(step):
        if last and "host" in split_mode(last[0][0])[1]:
            results.append((step, host_rows_identical(last[0][1])))
        last.clear()

    DasoStrategy.step_fn = spy
    try:
        yield check, results
    finally:
        DasoStrategy.step_fn = step_fn
        last.clear()


def topo_holds(res, row, launches, want_launches):
    """What every topology cell holds: the launches its outer modes imply
    (inner syncs launch no kernel), and host syncs counted once per token
    that carries the host level, at least one."""
    tokens = [h[1] for h in res.controller.history]
    n_host = sum("host" in split_mode(m)[1] for m in tokens)
    row.update(host_tokens=n_host, launches_expected=want_launches)
    return [what for what, bad in (
        ("launches", launches != want_launches),
        ("level_sync_counts", res.controller.level_sync_counts().get("host") != n_host
         or n_host == 0)) if bad]


def inner_sync_ms(row):
    """Per-step medians: each token carrying the host level less the same
    outer action without it (the inner sync's cost per step)."""
    med = row["step_ms_median"]
    return {m: med[m] - med[split_mode(m)[0]] for m in med
            if split_mode(m)[1] and split_mode(m)[0] in med}


def phase_train_topo():
    """The 3-level topology through run_training on the per-step executor:
    K2 / K3 launches as the pod level's modes imply, host syncs counted per
    token, and after every host step the host groups' rows bit for bit.
    Returns its history, launches and final carry (params and momentum of
    every replica, copied to the host)."""
    with host_sync_checks() as (check, checked):
        res, row, launches, modes, params0 = run_train_phase(
            "train_topo", {"executor": "per_step", "topology": TOPO_SPEC}, TRAIN_WHY,
            on_batch=check)
        check(TRAIN_STEPS)
    faults = topo_holds(res, row, launches, train_launches(modes))
    row.update(inner_sync_ms=inner_sync_ms(row), host_steps_checked=len(checked),
               host_rows_identical=all(ok for _, ok in checked))
    if len(checked) != row["host_tokens"] or not row["host_rows_identical"]:
        faults.append(f"host rows after steps {[t for t, ok in checked if not ok]}")
    if faults:
        emit({**row, "failed": faults})
        raise AssertionError(f"train_topo: {faults}")
    emit(row)
    params_r, opt_r, _ = res.carry
    carry = [x.cpu() for x in leaves((params_r, opt_r))]
    history = [h[1] for h in res.controller.history]
    del res, params0, params_r, opt_r
    torch.cuda.empty_cache()
    return {"launches": launches, "carry": carry, "history": history,
            "step_ms_median": row["step_ms_median"]}


def phase_train_macro_topo(per_step):
    """The 3-level topology through the macro-cycle executor, traced: the
    per-step run's history tokens, its final carry (params and momentum of
    every replica) bit for bit, the same launches; the cycle spans' host
    syncs add to `level_sync_counts()["host"]` (`trace_faults`). Returns its
    launches, losses and the digest of every row of its final carry."""
    with run_trace("train_macro_topo") as (tracer, events):
        res, row, launches, modes, params0 = run_train_phase(
            "train_macro_topo", {"executor": "macro", "topology": TOPO_SPEC}, TRAIN_WHY,
            tracer=tracer)
    faults = topo_holds(res, row, launches, train_launches(modes)) + trace_faults(events, res)
    row.update(spans=span_summary(events), trace_events=len(events),
               tracer_overhead_ms=1e3 * tracer.overhead_s,
               cycle_span_host_syncs=sum(ev["args"]["syncs"].get("host", 0)
                                         for ev in events if ev["name"] == "cycle"))
    row.update(per_step_ms_median=per_step["step_ms_median"],
               history_identical_to_per_step=[h[1] for h in res.controller.history]
               == per_step["history"],
               carry_identical_to_per_step=carry_matches(res.carry, per_step["carry"]))
    faults += [what for what in ("history", "carry")
               if not row[f"{what}_identical_to_per_step"]]
    if launches != per_step["launches"]:
        faults.append("launches differ from the per-step run's")
    if faults:
        emit({**row, "failed": faults})
        raise AssertionError(f"train_macro_topo: {faults}")
    emit(row)
    out = {"launches": launches, "losses": res.losses, "digests": row_digests(res.carry)}
    del res, params0
    torch.cuda.empty_cache()
    return out


def phase_train_topo_2level(trained, macro):
    """The 2-level spec chip:4 x pod:4 through the macro-cycle executor: it
    lowers to the stock strategy and controller, so its final carry and
    losses are train_macro's bit for bit (the carry held against the
    per-step carry in `trained`, which train_macro matched)."""
    res, row, launches, modes, params0 = run_train_phase(
        "train_topo_2level", {"executor": "macro", "topology": TOPO_2LEVEL}, TRAIN_WHY)
    check_launches(row, launches, train_launches(modes))
    params_r, opt_r, _ = res.carry
    row.update(
        losses_identical_to_train_macro=res.losses == macro["losses"],
        carry_identical_to_train_macro=all(
            same_bits(a, b) for a, b in zip(leaves((params_r, opt_r)),
                                            leaves(trained["carry"]), strict=True)))
    faults = [what for what in ("losses", "carry")
              if not row[f"{what}_identical_to_train_macro"]]
    if row["controller"] != "DasoController" or launches != macro["launches"]:
        faults.append("not the legacy path")
    if faults:
        emit({**row, "failed": faults})
        raise AssertionError(f"train_topo_2level: {faults}")
    emit(row)
    del res, params0, params_r, opt_r
    torch.cuda.empty_cache()
    return launches


def phase_train_topo_int8_overlap():
    """The 3-level topology with the int8 wire and the one_cycle overlap,
    per-step and then through the macro-cycle executor, where each overlap
    cycle's inner syncs run in its local steps on the current stream while
    the exchange runs on the executor's stream: the whole carry (params,
    momentum, in-flight and pending of every replica) bit for bit between
    the two, the same history, K2 / K5 / K6 launches as the pod level's
    modes imply. Returns both runs' launches."""
    out, want = {}, None
    for name, executor in (("train_topo_int8_overlap", "per_step"),
                           ("train_macro_topo_int8_overlap", "macro")):
        res, row, launches, modes, params0 = run_train_phase(
            name, {"executor": executor, "topology": TOPO_SPEC, **INT8_OVERLAP},
            INT8_OVERLAP_WHY)
        faults = topo_holds(res, row, launches, int8_overlap_launches(modes))
        history = [h[1] for h in res.controller.history]
        if want is None:
            row["inner_sync_ms"] = inner_sync_ms(row)
            want = (history, host_carry(res.carry), row["step_ms_median"])
        else:
            st = res.executor_stats
            row.update(per_step_ms_median=want[2],
                       history_identical_to_per_step=history == want[0],
                       carry_identical_to_per_step=carry_identical(res.carry, want[1]),
                       steady_cycle_ms=steady_overlap_cycles(res),
                       legs_ms={k: 1e3 * getattr(st, k) for k in OVERLAP_LEGS})
            faults += [what for what in ("history", "carry")
                       if not row[f"{what}_identical_to_per_step"]]
            if st.overlap_cycles == 0:
                faults.append("no overlap cycle")
            if launches != out["train_topo_int8_overlap"]:
                faults.append("launches differ from the per-step run's")
        if faults:
            emit({**row, "failed": faults})
            raise AssertionError(f"{name}: {faults}")
        emit(row)
        out[name] = launches
        del res, params0
        torch.cuda.empty_cache()
    return out


# -- the baselines and the fault supervisor ---------------------------------------

# (strategy, TrainLoopConfig options, lr): each baseline on a wire that puts
# a kernel on its exchange; EASGD's elastic mean is f32 (its default), so only
# its blocking steps launch one. DOWNPOUR's push adds the sum of the R
# replicas' deltas to the server copy (push_scale 1, the launcher's), and each
# replica keeps its own momentum across pushes: at the train cell's lr the
# loss went 12.07 -> 52.67 in 40 steps, at lr / 4 it fell to 5.74 by step 17
# and rose to 13.13 (PERF.md §6); the cell takes lr / 16
BASELINES = (("gossip", {"wire_format": "int8"}, TRAIN_LR), ("easgd", {}, TRAIN_LR),
             ("downpour", {"wire_format": "bf16"}, TRAIN_LR / 16))
BASELINE_WHY = ("memory: the carry holds params and momentum (and EASGD's center or "
                "DOWNPOUR's anchor) for 4 replicas in f32, beside the exchange's arenas")
EXCHANGE_MODES = ("gossip", "elastic", "push")


def baseline_launches(name, modes):
    """One f32 arena. gossip on the int8 wire: K5 and K6 once per exchange
    (the partner copy) and per blocking step; easgd: K3 once per blocking
    step (its elastic mean is f32); downpour on the bf16 wire: K3 once per
    push and per blocking step."""
    n_ex = sum(m in EXCHANGE_MODES for m in modes)
    n_blk = modes.count("blocking")
    out = no_launches()
    if name == "gossip":
        out.update(quantize_int8=n_ex + n_blk, dequantize_int8=n_ex + n_blk)
    elif name == "easgd":
        out.update(bf16_pack=n_blk)
    else:
        out.update(bf16_pack=n_ex + n_blk)
    return out


def step_ms(name, options, lr, carry, tokens, reps=3):
    """Median host ms (each ending in a synchronize) of one step of each
    mode token on `carry`, the train cell's strategy and batch of step 0;
    each output carry is dropped before the next step."""
    cfg = train_config(TRAIN_LAYERS)
    strat = build_strategy(make_lm_loss(cfg), TrainLoopConfig(
        strategy=name, n_steps=TRAIN_STEPS, n_replicas=TRAIN_R, local_world=TRAIN_LOCAL_WORLD,
        b_max=TRAIN_B_MAX, lr=lr, device="cuda", **options),
        sgd(momentum=0.9, weight_decay=1e-4))
    batch = replica_data(SyntheticLM(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                                     seed=0))(0)
    lr = torch.tensor(lr, dtype=torch.float32, device="cuda")
    out = {}
    for token in tokens:
        fn, times = strat.step_fn(token, 1), []
        for i in range(reps + 1):
            sync()
            t0 = time.perf_counter()
            done = fn(carry, batch, lr)
            sync()
            del done
            if i:  # the first call is the warm-up
                times.append(1e3 * (time.perf_counter() - t0))
        out[token] = statistics.median(times)
    return out


def wire_rows(res, params0):
    """The run's outer meter rows (obs/meters.py): bytes per exchange at each
    wire tier and the exchanges priced at it."""
    ctrl = res.controller
    rows = meters.level_bytes_report(params0, ctrl.level_sync_counts(), ctrl.cfg,
                                     outer_split=meters.outer_sync_split(ctrl.history))
    return [{**dataclasses.asdict(r), "total_bytes": r.total_bytes} for r in rows]


def rows_identical(tree):
    """Every replica's row of every leaf bit for bit replica 0's."""
    return all(same_bits(x[i], x[0]) for x in leaves(tree) for i in range(1, x.shape[0]))


def phase_train_baselines():
    """gossip (int8 wire), EASGD and DOWNPOUR (bf16 wire) through
    run_training at the train cell's size on the macro executor, and gossip
    once more on the per-step executor. Each: the launches its modes imply,
    a falling loss, and after the final cool-down blocking step every
    replica's params bit for bit equal (EASGD's center and DOWNPOUR's anchor
    bit for bit the params); the per-step gossip run's losses and carry bit
    for bit the macro run's. Prints ms per step by cycle shape, one local and
    one exchange step's ms on the final carry and their difference, the
    peak memory and allocator retries, and the wire bytes per exchange.
    Returns the launches of each run, by phase name."""
    t0 = time.perf_counter()
    out = {}
    for name, options, lr in BASELINES:
        phase = f"train_baselines_{name}"
        res, row, launches, modes, params0 = run_train_phase(
            phase, {"executor": "macro", **options}, BASELINE_WHY, strategy=name, lr=lr)
        check_launches(row, launches, baseline_launches(name, modes))
        carry = res.carry
        token = next(h[1] for h in res.controller.history
                     if outer_mode(h[1]) in EXCHANGE_MODES)
        row.update(carry_slots=len(carry), wire_bytes=wire_rows(res, params0),
                   exchange_token=token, replicas_identical=rows_identical(carry[0]))
        if name != "gossip":
            row["third_slot_is_params"] = all(
                same_bits(a, b) for a, b in zip(leaves(carry[2]), leaves(carry[0]),
                                                strict=True))
        ms = step_ms(name, options, lr, carry, ("local", token))
        row.update(step_ms_on_final_carry=ms,
                   exchange_ms_over_local=ms[token] - ms["local"])
        faults = [what for what, bad in (
            ("replicas differ after the cool-down", not row["replicas_identical"]),
            ("center / anchor", not row.get("third_slot_is_params", True))) if bad]
        if name == "gossip":
            host = [x.cpu() for x in leaves(carry)]
            losses = res.losses
            res = carry = None  # the card's room for the per-step run
            torch.cuda.empty_cache()
            pres, prow, plaunches, pmodes, pparams0 = run_train_phase(
                "train_baselines_gossip_per_step", {"executor": "per_step", **options},
                BASELINE_WHY, strategy=name, lr=lr)
            check_launches(prow, plaunches, baseline_launches(name, pmodes))
            row.update(per_step_step_ms_median=prow["step_ms_median"],
                       per_step_losses_identical=pres.losses == losses,
                       per_step_carry_identical=all(
                           same_bits(a, b.to(a.device))
                           for a, b in zip(leaves(pres.carry), host, strict=True)))
            out["train_baselines_gossip_per_step"] = plaunches
            faults += [what for what, bad in (
                ("per-step losses", not row["per_step_losses_identical"]),
                ("per-step carry", not row["per_step_carry_identical"])) if bad]
            del pres, host, pparams0
        if faults:
            emit({**row, "failed": faults})
            raise AssertionError(f"{phase}: {faults}")
        emit(row)
        out[phase] = launches
        res = carry = params0 = None
        torch.cuda.empty_cache()
    emit({"phase": "train_baselines", "phase_wall_s": time.perf_counter() - t0})
    return out


# replica 1 straggles x1.5 from step 8 to 20, replica 2 is down from step 10
# to 22, and the network between the nodes runs at half its bandwidth from
# step 14 to 28: all inside the cycling phase (steps 3 to 28)
FAULT_EVENTS = [{"step": 8, "kind": "straggle", "replica": 1, "factor": 1.5},
                {"step": 10, "kind": "crash", "replica": 2},
                {"step": 14, "kind": "degrade_dcn", "factor": 0.5},
                {"step": 20, "kind": "recover", "replica": 1},
                {"step": 22, "kind": "rejoin", "replica": 2},
                {"step": 28, "kind": "restore_dcn"}]
CRASH, REJOIN, DOWN = 10, 22, 2
# the simulated clock: a compute step's seconds and one exchange's cost (a
# model of the network, not a measurement)
SIM_T_COMPUTE = 0.25


def sim_exchange_s(n_active, dcn_scale):
    return 0.02 * n_active / dcn_scale


@contextmanager
def eq1_worlds():
    """Yields the global_world of each Eq. (1) merge through ops.eq1_merge,
    in call order."""
    fn, seen = ops.eq1_merge, []

    def spy(local, stale, **kw):
        seen.append(kw["global_world"])
        return fn(local, stale, **kw)

    ops.eq1_merge = spy
    try:
        yield seen
    finally:
        ops.eq1_merge = fn


@contextmanager
def reseed_checks():
    """Yields one record per rejoin: whether the supervisor's reseed put the
    donors' mean (`membership.donor_mean_rows`) in the joiner's rows of every
    carry leaf and left every other row as it was."""
    fn, records = supervisor.reseed_carry, []

    def spy(carry, donor_mask, joining):
        want = membership.donor_mean_rows(carry, donor_mask)
        out = fn(carry, donor_mask, joining)
        ok = all(same_bits(o[j], m[0]) for o, m in zip(leaves(out), leaves(want), strict=True)
                 for j in joining) and all(
            same_bits(o[i], c[i]) for o, c in zip(leaves(out), leaves(carry))
            for i in range(o.shape[0]) if i not in joining)
        records.append({"joining": list(joining), "donors": list(donor_mask),
                        "rows_are_donor_mean": ok})
        del want
        return out

    supervisor.reseed_carry = spy
    try:
        yield records
    finally:
        supervisor.reseed_carry = fn


def frozen_row_checks(n_slots):
    """(ckpt_cb, results): at the cycle boundary of the crash step the
    callback keeps replica DOWN's rows of the first `n_slots` carry slots, and
    at each later boundary up to the rejoin holds them bit for bit."""
    kept, results = [], []

    def cb(step, carry, losses):
        rows = [x[DOWN] for x in leaves(carry[:n_slots])]
        if step == CRASH:
            kept[:] = [x.clone() for x in rows]
        elif CRASH < step <= REJOIN:
            results.append((step, all(same_bits(a, b) for a, b in zip(rows, kept,
                                                                     strict=True))))
    return cb, results


def cpu_rehearsal(strategy, options, events=FAULT_EVENTS, **supervise):
    """The same plan (`events`, FAULT_EVENTS by default) through
    run_with_faults on the CPU at the launcher's --tiny size (2 layers,
    d_model 128), with the card run's extra keyword arguments `supervise`:
    the membership timeline, the simulated clock and the autotune records,
    which depend on the schedule only."""
    cfg = get_config(ARCH).replace(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                                   head_dim=32, d_ff=256, vocab_size=256)
    params0 = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    src = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=16, seed=0)

    def data(step):
        b = src.batch(TRAIN_R * 2, step, device="cpu")
        return {k: v.reshape((TRAIN_R, 2) + v.shape[1:]) for k, v in b.items()}

    strat = build_strategy(make_lm_loss(cfg), TrainLoopConfig(
        strategy=strategy, n_steps=TRAIN_STEPS, n_replicas=TRAIN_R,
        local_world=TRAIN_LOCAL_WORLD, b_max=TRAIN_B_MAX, lr=TRAIN_LR, device="cpu",
        **options), sgd(momentum=0.9, weight_decay=1e-4))
    rep = run_with_faults(strat, params0, data, constant_lr(TRAIN_LR), TRAIN_STEPS,
                          FaultPlan.from_dicts(events), t_compute_s=SIM_T_COMPUTE,
                          exchange_cost_fn=sim_exchange_s, **supervise)
    return rep


def phase_train_faults():
    """run_with_faults through the plan FAULT_EVENTS on the DASO train cell
    (the paper's wires, overlap off, macro; traced) and on the gossip int8
    cell. Each holds: replica 2's params and momentum rows bit for bit
    frozen at every cycle boundary from the crash to the rejoin (the DASO
    in-flight buffer is the active replicas' mean on every row, as in the
    reference), and right after the rejoin the donors' mean in every carry
    leaf; two membership and two dcn_scale controller events, B = 8 = min(4
    b_max, ceil(b_max / 0.5)) while the network is degraded and at most
    b_max after; the report's invalidations those of the executor (and of
    the trace's invalidate instants); the membership timeline and the
    simulated clock those of a CPU rehearsal of the plan; the launches the
    modes imply. DASO's Eq. (1) merges run at P_eff = 12.0 during the crash
    and P = 16 otherwise, and its trace holds one fault_event span per
    event, the membership_change / dcn_scale instants, and what
    `trace_faults` lists. Returns the launches by phase name."""
    t0 = time.perf_counter()
    plan = FaultPlan.from_dicts(FAULT_EVENTS)
    cost = {"t_compute_s": SIM_T_COMPUTE, "exchange_cost_fn": sim_exchange_s}
    out = {}
    for name, options, slots in (("daso", {}, 2), ("gossip", {"wire_format": "int8"}, 2)):
        phase = f"train_faults_{name}"
        cb, frozen = frozen_row_checks(slots)
        supervise = dict(cost, ckpt_every=1, ckpt_cb=cb)
        with ExitStack() as stack:
            tracer, events = (stack.enter_context(run_trace(phase)) if name == "daso"
                              else (None, []))
            worlds = stack.enter_context(eq1_worlds())
            reseeds = stack.enter_context(reseed_checks())
            report, row, launches, modes, params0 = run_train_phase(
                phase, {"executor": "macro", **options}, TRAIN_WHY if name == "daso"
                else BASELINE_WHY, strategy=name, plan=plan, supervise=supervise,
                tracer=tracer)
        res = report.result
        check_launches(row, launches, train_launches(modes) if name == "daso"
                       else baseline_launches(name, modes))
        hist = res.controller.history
        names = [ev["name"] for ev in events]
        rehearsal = cpu_rehearsal(name, options)
        want_worlds = [12.0 if CRASH <= t < REJOIN else TRAIN_R * TRAIN_LOCAL_WORLD
                       for t, m, _, _ in hist if outer_mode(m) in ("receive", "send_receive")]
        row.update(
            fault_events=FAULT_EVENTS, applied=report.applied,
            recovery_s=report.recovery_s(), membership_timeline=report.membership_timeline,
            simulated_time_s=report.simulated_time_s, wasted_wait_s=report.wasted_wait_s,
            invalidations=report.invalidations, controller_events=res.controller.events,
            b_by_step=[h[2] for h in hist], frozen_rows=frozen, reseeds=reseeds,
            eq1_worlds=worlds, rehearsal_timeline=rehearsal.membership_timeline,
            rehearsal_simulated_time_s=rehearsal.simulated_time_s)
        if name == "daso":
            row.update(events=len(events), event_names=dict(collections.Counter(names)),
                       spans=span_summary(events))
        kinds = [e[1] for e in res.controller.events]
        faults = [what for what, bad in (
            ("frozen rows", not frozen or frozen[-1][0] != REJOIN
             or not all(ok for _, ok in frozen)),
            ("reseed", len(reseeds) != 1 or not reseeds[0]["rows_are_donor_mean"]),
            ("controller events", kinds.count("membership") != 2
             or kinds.count("dcn_scale") != 2),
            ("B under degradation", any(b != 8 for t, _, b, _ in hist if 14 <= t < 28)
             or any(b > TRAIN_B_MAX for t, _, b, _ in hist if t < 14 or t >= 28)),
            ("invalidations", report.invalidations != res.executor_stats.invalidations
             or report.invalidations != 2),
            ("timeline", report.membership_timeline != rehearsal.membership_timeline),
            ("simulated clock", report.simulated_time_s != rehearsal.simulated_time_s),
            ("Eq. (1) worlds", worlds != want_worlds
             or (name == "daso" and 12.0 not in worlds)),
            ("trace", name == "daso" and (
                trace_faults(events, res)
                or names.count("fault_event") != len(FAULT_EVENTS)
                or names.count("membership_change") != 2 or names.count("dcn_scale") != 2
                or names.count("invalidate") != report.invalidations))) if bad]
        if faults:
            emit({**row, "failed": faults})
            raise AssertionError(f"{phase}: {faults}")
        emit(row)
        out[phase] = launches
        del report, res, params0
        torch.cuda.empty_cache()
    emit({"phase": "train_faults", "phase_wall_s": time.perf_counter() - t0})
    return out


def phase_train_faults_empty(trained, macro):
    """run_with_faults with an empty plan on the train cell: train_macro's
    losses and final carry (params and momentum of every replica, in
    `trained`) bit for bit. Returns its launches."""
    report, row, launches, modes, params0 = run_train_phase(
        "train_faults_empty", {"executor": "macro"}, TRAIN_WHY, plan=FaultPlan())
    check_launches(row, launches, train_launches(modes))
    params_r, opt_r, _ = report.result.carry
    row.update(losses_identical_to_train_macro=report.result.losses == macro["losses"],
               carry_identical_to_train_macro=all(
                   same_bits(a, b) for a, b in zip(leaves((params_r, opt_r)),
                                                   leaves(trained["carry"]), strict=True)),
               invalidations=report.invalidations)
    if not (row["losses_identical_to_train_macro"] and row["carry_identical_to_train_macro"]):
        emit({**row, "failed": "not train_macro's numbers"})
        raise AssertionError("train_faults_empty differs from train_macro")
    emit(row)
    del report, params0, params_r, opt_r
    torch.cuda.empty_cache()
    return launches


LAUNCH_FAULTS = {"events": [{"step": 4, "kind": "crash", "replica": 1},
                            {"step": 8, "kind": "rejoin", "replica": 1}]}
RESILIENCE_KEYS = ["events", "invalidations", "reshuffles", "retunes", "simulated_time_s",
                   "wasted_wait_s"]


def phase_launch_faults():
    """repro_torch.launch.train.main --tiny --steps 12 --fault-plan PLAN
    --metrics-out M on the card (replica 1 down from step 4 to 8): M holds
    the "resilience" record with the reference launcher's keys and both
    events, two invalidations, and K2 / K3 launch as the modes imply.
    Returns its launches."""
    from repro_torch.launch import train as launch_train

    tmp = tempfile.mkdtemp(prefix="chip_smoke_launch_faults_")
    metrics_path = os.path.join(tmp, "m.json")
    try:
        sync()
        zero_counts()
        res = launch_train.main(["--tiny", "--steps", str(LAUNCH_STEPS), "--fault-plan",
                                 json.dumps(LAUNCH_FAULTS), "--metrics-out", metrics_path])
        sync()
        launches = counts()
        with open(metrics_path) as f:
            metrics = json.load(f)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    res_rec = metrics.get("resilience", {})
    modes = [outer_mode(h[1]) for h in res.controller.history]
    row = {"phase": "launch_faults", "entry": "repro_torch.launch.train.main",
           "argv": ["--tiny", "--steps", LAUNCH_STEPS, "--fault-plan", LAUNCH_FAULTS,
                    "--metrics-out", "M"],
           "device": metrics["device"], "resilience": res_rec, "launches": launches,
           "final_loss": res.final_loss}
    faults = [what for what, bad in (
        ("keys", sorted(res_rec) != RESILIENCE_KEYS),
        ("events", [(e["step"], e["kind"]) for e in res_rec.get("events", [])]
         != [(4, "crash"), (8, "rejoin")]),
        ("invalidations", res_rec.get("invalidations") != 2),
        ("device", not metrics["device"].startswith("cuda")),
        ("launches", launches != train_launches(modes))) if bad]
    if faults:
        emit({**row, "failed": faults})
        raise AssertionError(f"launch_faults: {faults}")
    emit(row)
    del res
    torch.cuda.empty_cache()
    return launches


# -- the multi-process runtime ------------------------------------------------------

# train_procs: the 3-level train cell at 1 of 16 layers (PROCS_WHY), once in
# one process and once in two (one pod each), both through the process
# launcher; live_kill: a supervised two-process run at --tiny size. 10 steps
# (16 until the dense and prefix cells joined the script; the wall's budget)
# keep every mode: blocking, send, receive and local (int8 + one_cycle:
# ov_start, one ov_sync, blocking), 4 gathers an exchange run where 16 took 6
PROCS_LAYERS, PROCS_STEPS, PROCS_TIMEOUT = 1, 10, 420
PROCS_ARGS = ["--full", "--layers", str(PROCS_LAYERS), "--dtype", "float32",
              "--topology", TOPO_SPEC, "--steps", str(PROCS_STEPS),
              "--per-node-batch", str(TRAIN_PER), "--seq-len", str(TRAIN_SEQ),
              "--lr", str(TRAIN_LR), "--seed", "0"]
PROCS_WHY = ("memory: two processes share the one card, each holding params0, its 2 "
             "replicas' params and momentum, the in-flight mean and the gathered wire "
             "arena of all 4 replicas; at 4 layers the one-process train cell alone "
             "peaks at 51.7 GB (PERF.md). Time: every exchange gathers the arena over "
             "gloo at 0.5 to 1 GB/s; 1 layer, not 2, keeps the script's wall in its "
             "budget (PERF.md)")
PROCS_COMM = ("eq1_merge", "bf16_pack", "bf16_unpack", "quantize_int8", "dequantize_int8")
# 40 steps: at --tiny size a step takes milliseconds on the card, so the
# survivor has passed the kill's step by the time the supervisor reads the
# heartbeat (written every 0.25 s); the regrouped epoch replays the rest
LIVE_STEPS, LIVE_KILL, LIVE_WATCHDOG_S = 40, "1:6", 120
LIVE_ARGS = ["--tiny", "--topology", TOPO_SPEC, "--steps", str(LIVE_STEPS),
             "--per-node-batch", "2", "--seq-len", "16", "--b-max", "4", "--seed", "0"]


def launch_procs(argv, timeout):
    """`python -m repro_torch.launch.procs ARGV` from this checkout; returns
    (exit code, output, seconds)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.procs"] + argv,
                       capture_output=True, text=True, timeout=timeout + 60, env=env)
    return r.returncode, r.stdout + r.stderr, time.perf_counter() - t0


def procs_run(tmp, name, procs, extra):
    """One launch of the train cell over `procs` processes; returns the
    metrics, the per-process reports and the launcher's seconds."""
    out = os.path.join(tmp, name)
    code, log, wall = launch_procs(
        ["--procs", str(procs), "--timeout", str(PROCS_TIMEOUT), "--"] + PROCS_ARGS + extra
        + ["--ckpt", os.path.join(out, "ck"), "--metrics-out", os.path.join(out, "m.json"),
           "--proc-report", os.path.join(out, "rep")], PROCS_TIMEOUT)
    if code:
        emit({"phase": name, "failed": f"the {procs}-process group exited {code}",
              "output_tail": log[-4000:]})
        raise AssertionError(f"{name}: exit {code}")
    with open(os.path.join(out, "m.json")) as f:
        metrics = json.load(f)
    reports = []
    for p in range(procs):
        with open(os.path.join(out, f"rep.p{p}.json")) as f:
            reports.append(json.load(f))
    ckpt = os.path.isfile(os.path.join(out, "ck", "arrays.npz"))
    return metrics, reports, wall, ckpt


def gather_row(rep):
    """A process's gathers: calls, bytes per exchange by dtype, ms per gather
    split into D2H, gloo and H2D, the rate in GB/s of the bytes moved
    (sent + received) over the gather's time, and the part beside the
    local steps."""
    ex = rep["placement"]["exchange"]
    n = max(1, ex["calls"])
    moved = ex["payload_bytes"] + ex["received_bytes"]
    return {"calls": ex["calls"], "payload_bytes_per_exchange": ex["payload_bytes"] / n,
            "received_bytes_per_exchange": ex["received_bytes"] / n,
            "payload_bytes_by_dtype": ex["by_dtype"],
            "ms_per_gather": 1e3 * ex["seconds"] / n, "d2h_ms": 1e3 * ex["d2h_s"] / n,
            "gloo_ms": 1e3 * ex["comm_s"] / n, "h2d_ms": 1e3 * ex["h2d_s"] / n,
            "gb_per_s": moved / ex["seconds"] / 1e9 if ex["seconds"] else None,
            "beside_compute_calls": ex["beside_compute_calls"],
            "beside_compute_ms": 1e3 * ex["beside_compute_s"],
            "fetch": rep["placement"]["fetch"]}


def report_cycle_ms(rep):
    """ms per step by cycle shape, as `cycle_rows` gives them."""
    by_shape = {}
    for shape, sec in rep["cycles"]:
        shape = tuple((m, s) for m, s in shape)
        by_shape.setdefault(shape_name(shape), []).append(1e3 * sec / len(shape))
    return {k: {"cycles": len(v), "ms_per_step_median": statistics.median(v)}
            for k, v in by_shape.items()}


def phase_train_procs(name, extra, want_launches):
    """The train cell at PROCS_LAYERS layers over two processes and over
    one, both through `python -m repro_torch.launch.procs`: the losses, the final
    params (process 0's checkpoint; each run's params digest) and every
    replica row of the final carry (the processes' digests of their own
    rows) bit for bit; each process's comm kernel launches those of the
    one-process run, as the modes imply. Prints the peaks per process, the
    gathers (bytes per exchange by dtype, ms per gather, GB/s), ms per step
    by cycle shape beside the oracle's and the launches per process.
    Returns ({path: launches}, the two-process run: its losses, final
    params digest, carry row digests and each process's gathers)."""
    gc.collect()
    torch.cuda.empty_cache()
    sync()
    parent_allocated = torch.cuda.memory_allocated()
    tmp = tempfile.mkdtemp(prefix=f"chip_smoke_{name}_")
    try:
        m1, reps1, wall1, ck1 = procs_run(tmp, f"{name}_1proc", 1, extra)
        m2, reps2, wall2, ck2 = procs_run(tmp, f"{name}_2proc", 2, extra)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    modes = [outer_mode(m) for m in reps1[0]["modes"]]
    digests1, digests2 = reps1[0]["carry_digest"], {}
    for rep in reps2:
        digests2.update(rep["carry_digest"])
    losses = m1["losses"]
    row = {"phase": name, "arch": ARCH, "entry": "python -m repro_torch.launch.procs",
           "argv": PROCS_ARGS + extra, "transport": "gloo", "procs": 2,
           "parent_allocated_at_spawn": parent_allocated,
           "reduced": {"n_layers": [get_config(ARCH).n_layers, PROCS_LAYERS],
                       "why": PROCS_WHY},
           "mode_counts": {m: modes.count(m) for m in sorted(set(modes))},
           "first_loss": losses[0], "last_loss": losses[-1],
           "wall_s": {"1proc": wall1, "2proc": wall2},
           "child_wall_s": {"1proc": [r["wall_s"] for r in reps1],
                            "2proc": [r["wall_s"] for r in reps2]},
           "max_memory_allocated": {"1proc": [r["max_memory_allocated"] for r in reps1],
                                    "2proc": [r["max_memory_allocated"] for r in reps2]},
           "gathers": [gather_row(r) for r in reps2],
           "cycle_ms": {"1proc": report_cycle_ms(reps1[0]),
                        "2proc": [report_cycle_ms(r) for r in reps2]},
           "launches": {"1proc": reps1[0]["launches"],
                        **{f"2proc.p{r['proc']}": r["launches"] for r in reps2}},
           "launches_expected": want_launches(modes),
           "executor_stats": {"1proc": reps1[0]["executor_stats"],
                              "2proc": [r["executor_stats"] for r in reps2]},
           "rows_digested": len(digests2)}
    if "--dispatch" in extra:
        st = [r["executor_stats"] for r in reps2]
        row["overlap"] = [{
            "gather_beside_local_steps_ms": g["beside_compute_ms"],
            "exchange_visible_ms": 1e3 * s["overlap_exchange_visible_s"],
            "gather_hidden_fraction": (1 - s["overlap_exchange_visible_s"]
                                       / (g["beside_compute_ms"] / 1e3)
                                       if g["beside_compute_ms"] else None)}
            for g, s in zip(row["gathers"], st)]
    want = want_launches(modes)
    faults = [what for what, bad in (
        ("losses", m1["losses"] != m2["losses"]),
        ("loss not falling", not (all(map(math.isfinite, losses)) and losses[-1] < losses[0])),
        ("final params", reps1[0]["params_digest"] != reps2[0]["params_digest"]),
        ("carry rows", not digests1 or digests1 != digests2),
        ("checkpoint", not (ck1 and ck2)),
        ("no gather", any(r["placement"]["exchange"]["calls"] == 0 for r in reps2)),
        ("launches", any({k: r["launches"][k] for k in PROCS_COMM}
                         != {k: want[k] for k in PROCS_COMM} for r in reps1 + reps2)))
        if bad]
    if faults:
        emit({**row, "failed": faults})
        raise AssertionError(f"{name}: {faults}")
    emit(row)
    return ({f"{name}.p{r['proc']}": r["launches"] for r in reps2},
            {"losses": m2["losses"], "params_digest": reps2[0]["params_digest"],
             "carry_digest": digests2, "gathers": row["gathers"]})


def phase_live_kill():
    """`python -m repro_torch.launch.procs --procs 2 --kill 1:6` at --tiny
    size on the 3-level topology, --ckpt-every 1: process 1 is SIGKILLed once
    its heartbeat reaches step 6, the survivor regroups onto one process
    over every replica, resumes from the newest intact TrainState and
    replays the death; its losses and final params are then held bit for
    bit to a one-process run of the same crash as a fault plan
    (resilience.run_with_faults). Prints the supervisor's --report timings.
    Returns the oracle run's launches."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_live_kill_")
    try:
        live = os.path.join(tmp, "live")
        code, log, wall = launch_procs(
            ["--procs", "2", "--timeout", "300", "--watchdog", str(LIVE_WATCHDOG_S),
             "--run-dir", os.path.join(live, "run"), "--report",
             os.path.join(live, "report.json"), "--kill", LIVE_KILL, "--"] + LIVE_ARGS
            + ["--ckpt", os.path.join(live, "ck"), "--ckpt-every", "1",
               "--metrics-out", os.path.join(live, "m.json")], 300)
        if code:
            emit({"phase": "live_kill", "failed": f"supervised run exited {code}",
                  "output_tail": log[-4000:]})
            raise AssertionError(f"live_kill: exit {code}")
        with open(os.path.join(live, "report.json")) as f:
            report = json.load(f)
        with open(os.path.join(live, "m.json")) as f:
            metrics = json.load(f)
        meta = metrics["resilience"]["live"]
        plan = {"events": [{"step": meta["crash_step"], "kind": "crash", "replica": r}
                           for r in meta["dead_replicas"]]}
        orc = os.path.join(tmp, "oracle")
        code, log, oracle_wall = launch_procs(
            ["--procs", "1", "--timeout", "300", "--"] + LIVE_ARGS
            + ["--fault-plan", json.dumps(plan), "--ckpt", os.path.join(orc, "ck"),
               "--ckpt-every", "1", "--metrics-out", os.path.join(orc, "m.json"),
               "--proc-report", os.path.join(orc, "rep")], 300)
        if code:
            emit({"phase": "live_kill", "failed": f"oracle exited {code}",
                  "output_tail": log[-4000:]})
            raise AssertionError(f"live_kill oracle: exit {code}")
        with open(os.path.join(orc, "m.json")) as f:
            oracle = json.load(f)
        with open(os.path.join(orc, "rep.p0.json")) as f:
            launches = json.load(f)["launches"]
        import numpy as np
        a = np.load(os.path.join(live, "ck", "arrays.npz"))
        b = np.load(os.path.join(orc, "ck", "arrays.npz"))
        params_same = sorted(a.files) == sorted(b.files) and all(
            np.array_equal(a[k], b[k]) for k in a.files if k != "__save_id__")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    row = {"phase": "live_kill", "entry": "python -m repro_torch.launch.procs --kill",
           "argv": LIVE_ARGS, "kill": LIVE_KILL, "watchdog_s": LIVE_WATCHDOG_S,
           "epochs": [{k: e.get(k) for k in ("epoch", "procs", "codes", "outcome",
                                            "detect", "regroup_s", "resume_s")}
                      for e in report["epochs"]],
           "dead_replicas": report["dead_replicas"], "timings": report["timings"],
           "crash_step": meta["crash_step"], "resumed_from": os.path.basename(
               meta["resumed_from"]), "wall_s": wall, "oracle_wall_s": oracle_wall,
           "oracle": "resilience.run_with_faults (one process, --fault-plan)",
           "losses_identical": metrics["losses"] == oracle["losses"],
           "final_params_identical": params_same, "oracle_launches": launches}
    faults = [what for what, bad in (
        ("epochs", [(e["outcome"], e["procs"]) for e in report["epochs"]]
         != [("failed", 2), ("ok", 1)]),
        ("dead replicas", report["dead_replicas"] != [2, 3]),
        ("losses", not row["losses_identical"]),
        ("final params", not params_same)) if bad]
    if faults:
        emit({**row, "failed": faults})
        raise AssertionError(f"live_kill: {faults}")
    emit(row)
    return launches

# -- the CNN: ResNet-50, the paper's own workload -----------------------------------

# resnet50 at its published size (stage sizes (3, 4, 6, 3), width 64,
# bottleneck, 1,000 classes, 224 x 224, f32, 25,557,032 params in 161
# leaves), trained as benchmarks/figures.py::fig7_accuracy_parity trains it:
# DASO with R = 4 nodes of local_world 4, b_max 4, loss_window 10, the
# default sgd(0.9, 1e-4); 32 images per replica, so 128 a step; sync on the
# same 128 images a step. The batches are drawn before any timed run.
# Two cuts, both from lr sweeps of this cell on the card (PERF.md): fig7's lr
# 0.05 diverges for DASO (the loss passes 9 by step 5), so lr 0.02; and the
# 24 steps cycle over RESNET_DATA_STEPS steps' batches (512 images, 6
# epochs), since on a fresh batch every step the loss stays above ln 1000
# at every lr from 0.001 to 0.05 (1,000 classes, each seen ~3 times in 24
# steps)
RESNET_ARCH, RESNET_R, RESNET_PER, RESNET_STEPS, RESNET_LR = "resnet50", 4, 32, 24, 0.02
RESNET_DATA_STEPS = 4
# DASO's mean loss over the last 4 steps within 10 % of sync's on the same
# images (the fig7 comparison of benchmarks/figures.py, on the loss)
RESNET_PARITY_BAND = 0.1
RESNET_PARAMS, RESNET_LEAVES, RESNET_CHECK_IMAGES = 25_557_032, 161, 4
RESNET_LOOP = dict(n_steps=RESNET_STEPS, n_replicas=RESNET_R, local_world=4, b_max=4,
                   lr=RESNET_LR, loss_window=10, device="cuda")
# resnet_check, card against the CPU path: the loss within 1e-4 relative,
# the logits (and, in f64, each gradient leaf) within 1e-3 of their largest
# magnitude; each f32 gradient leaf's error against the CPU's f64 within
# max(1e-3, 2 x the CPU's f32 error on that leaf), with every ReLU pinned to
# the f64 forward's mask (and without, where the card and the CPU flip the
# same ReLUs); each ReLU the f32 forward flips within 1e-3 of its layer's
# largest input
RESNET_LOSS_RTOL, RESNET_REL_TOL = 1e-4, 1e-3
# 12 steps (24 until the dense and prefix cells joined the script): every run
# still prints its line and the executors' traces stay equal
ABLATION_STEPS, ABLATION_TIMEOUT = 12, 600


def resnet_data(cfg):
    """SyntheticImages(1000, 224) and RESNET_DATA_STEPS steps' DASO batches,
    drawn on the host (replica r of data step t draws step t * R + r, as
    figures.py) and moved to the card in one copy: images (data steps, R,
    32, 224, 224, 3), labels (data steps, R, 32); step t trains on data
    step t % RESNET_DATA_STEPS. Prints the host seconds of the prototypes,
    of the batches and of the copy."""
    t0 = time.perf_counter()
    src = SyntheticImages(cfg.n_classes, cfg.image_size, seed=0)
    t1 = time.perf_counter()
    # each (step, replica) draws from its own generator: threads give the
    # serial loop's batches
    with ThreadPoolExecutor(8) as pool:
        flat = list(pool.map(lambda i: src.batch(RESNET_PER, i),
                             range(RESNET_DATA_STEPS * RESNET_R)))
    steps = [flat[t * RESNET_R:(t + 1) * RESNET_R] for t in range(RESNET_DATA_STEPS)]
    del flat
    images = torch.stack([torch.stack([b["images"] for b in s]) for s in steps])
    labels = torch.stack([torch.stack([b["labels"] for b in s]) for s in steps])
    t2 = time.perf_counter()
    del steps
    data = {"src": src, "images": images.to("cuda"), "labels": labels.to("cuda")}
    sync()
    emit({"phase": "resnet_data", "n_classes": cfg.n_classes, "image_size": cfg.image_size,
          "data_steps": RESNET_DATA_STEPS, "images_per_step": RESNET_R * RESNET_PER,
          "host_seconds": {"prototypes": t1 - t0, "batches": t2 - t1,
                           "to_card": time.perf_counter() - t2},
          "bytes_on_card": images.numel() * 4 + labels.numel() * 4})
    return data


def rel_err(got, want):
    """max |got - want| over max |want| (0 when both are zero)."""
    scale = want.abs().max().item()
    diff = (got - want).abs().max().item()
    return diff / scale if scale else diff


@contextmanager
def relu_as(fn):
    """torch.relu replaced by fn(x, relu) while the block runs: models/cnn.py
    calls torch.relu at each of its ReLUs, in the same order on every pass."""
    relu = torch.relu
    torch.relu = lambda x: fn(x, relu)
    try:
        yield
    finally:
        torch.relu = relu


def leaf_paths(tree, prefix=""):
    """The leaves' paths in flatten order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [q for k in sorted(tree) for q in leaf_paths(tree[k], f"{prefix}.{k}")]
    if isinstance(tree, (list, tuple)):
        return [q for i, v in enumerate(tree) for q in leaf_paths(v, f"{prefix}[{i}]")]
    return [prefix]


def resnet_pass(cfg, params, batch, device, dtype, masks=None):
    """One forward (logits) and one forward and backward of make_resnet_loss
    on `device` in `dtype`: (logits, loss, gradient leaves, ReLU inputs of
    the backward's forward), on the host (logits and gradients in f64).
    With `masks`, each ReLU is x * its mask (the gradient of a ReLU whose
    input has that sign)."""
    p, b = tree_map(lambda x: x.to(device, dtype) if x.is_floating_point() else x.to(device),
                    (params, batch))
    with torch.no_grad():
        logits, _ = resnet_apply(p, b["bn_state"], b["images"], cfg, train=True)
    seen, pinned = [], iter(masks or ())

    def on_relu(x, relu):
        seen.append(x.detach().cpu())
        return x * next(pinned).to(x.device, x.dtype) if masks else relu(x)

    with relu_as(on_relu):
        (loss, _), grads = daso.value_and_grad(make_resnet_loss(cfg))({"net": p}, b)
    return (logits.double().cpu(), loss.item(), [g.double().cpu() for g in leaves(grads)], seen)


def relu_flips(pre, truth):
    """ReLU inputs `pre` against the f64 run's `truth`: the flipped
    positions of each ReLU, and the largest flipped |input| over its layer's
    largest |input| in f64."""
    where = [(x > 0) != (t > 0) for x, t in zip(pre, truth, strict=True)]
    worst = max([(t[w].abs().max() / t.abs().max()).item()
                 for w, t in zip(where, truth) if w.any()], default=0.0)
    return where, worst


def phase_resnet_check(data):
    """One forward and backward of make_resnet_loss at resnet50's published
    size on RESNET_CHECK_IMAGES images, on the card and on the CPU path with
    the same params and batch. In f32 (TF32 off): the loss within 1e-4
    relative and the logits within 1e-3 of their largest magnitude. In f64:
    the loss, the logits and each gradient leaf within those tolerances.
    The f32 gradients are held against the CPU's f64 ones leaf for leaf,
    each card leaf within max(1e-3, 2 x the CPU's f32 error on that leaf).
    An f32 forward can move a ReLU input within rounding of zero across the
    kink, and a leaf's gradient, a small sum of large terms, moves with it
    (by 7 % at a narrow width on the CPU, tests/test_torch_cnn.py); so that
    rule is held with every ReLU pinned to the CPU's f64 forward's mask, and
    also without where the card and the CPU flip the same ReLUs. Each
    flipped ReLU input must lie within 1e-3 of its layer's largest. The
    params and head are drawn on the CPU, as that test draws them at a
    narrow width; the init's zero head makes every logit equal and every
    gradient below it zero, so the head is random."""
    cfg = get_config(RESNET_ARCH)
    params, state = init_resnet(cfg, torch.Generator().manual_seed(1), "cpu")
    g = torch.Generator().manual_seed(2)
    params["head"] = {k: 0.01 * torch.randn(v.shape, generator=g)
                      for k, v in params["head"].items()}
    batch = {**data["src"].batch(RESNET_CHECK_IMAGES, 10 ** 6), "bn_state": state}
    paths = leaf_paths(params)
    n_params, n_leaves = sum(x.numel() for x in leaves(params)), len(paths)
    seconds, runs = {}, {}
    for device, who in (("cpu", "cpu"), ("cuda", "card")):
        for dtype in (torch.float64, torch.float32):
            t0 = time.perf_counter()
            runs[who, dtype] = resnet_pass(cfg, params, batch, device, dtype)
            seconds[f"{who}/{str(dtype)[6:]}"] = time.perf_counter() - t0
    truth_pre = runs["cpu", torch.float64][3]
    masks = [x > 0 for x in truth_pre]
    pinned = {who: resnet_pass(cfg, params, batch, device, torch.float32, masks)[2]
              for device, who in (("cpu", "cpu"), ("cuda", "card"))}
    del params, state, batch
    torch.cuda.empty_cache()
    row = {"phase": "resnet_check", "arch": RESNET_ARCH, "tf32": False,
           "images": RESNET_CHECK_IMAGES, "image_size": cfg.image_size,
           "n_classes": cfg.n_classes, "params": n_params, "leaves": n_leaves,
           "seconds": seconds,
           "tolerance": {"loss_rtol": RESNET_LOSS_RTOL, "logits": RESNET_REL_TOL,
                         "grads": RESNET_REL_TOL, "relu_flip": RESNET_REL_TOL,
                         "f32_grads": "card <= max(1e-3, 2 x cpu) on each leaf"}}
    faults = []
    for dtype in (torch.float32, torch.float64):
        (lc, sc, gc, _), (lh, sh, gh, _) = runs["card", dtype], runs["cpu", dtype]
        name = str(dtype)[6:]
        r = {"loss_card": sc, "loss_cpu": sh, "loss_rel_err": abs(sc - sh) / abs(sh),
             "logits_rel_err": rel_err(lc, lh)}
        if dtype == torch.float64:
            errs = [rel_err(a, b) for a, b in zip(gc, gh, strict=True)]
            r.update(grad_rel_err_max=max(errs), grad_worst_leaf=paths[errs.index(max(errs))])
            faults += [f"{name} grads"] * (not r["grad_rel_err_max"] <= RESNET_REL_TOL)
        faults += [f"{name} {k}" for k, tol in (("loss_rel_err", RESNET_LOSS_RTOL),
                                                 ("logits_rel_err", RESNET_REL_TOL))
                   if not r[k] <= tol]
        row[name] = r
    truth = runs["cpu", torch.float64][2]
    flips = {who: relu_flips(runs[who, torch.float32][3], truth_pre) for who in ("card", "cpu")}
    same_flips = all(torch.equal(a, b) for a, b in zip(flips["card"][0], flips["cpu"][0]))
    f32 = row["float32"]
    f32["relu_flips"] = {who: {"inputs": sum(int(w.sum()) for w in where),
                               "layers": sum(bool(w.any()) for w in where),
                               "largest_over_layer_max": worst}
                         for who, (where, worst) in flips.items()}
    f32["relu_flips_same_on_card_and_cpu"] = same_flips
    faults += [f"float32 {who} relu flip far from zero" for who, (_, worst) in flips.items()
               if not worst <= RESNET_REL_TOL]
    for how, card, cpu, held in (("unpinned", runs["card", torch.float32][2],
                                  runs["cpu", torch.float32][2], same_flips),
                                 ("pinned", pinned["card"], pinned["cpu"], True)):
        e_card = [rel_err(a, t) for a, t in zip(card, truth, strict=True)]
        e_cpu = [rel_err(a, t) for a, t in zip(cpu, truth, strict=True)]
        over = [paths[i] for i, (a, c) in enumerate(zip(e_card, e_cpu))
                if not a <= max(RESNET_REL_TOL, 2 * c)]
        f32[how] = {"grad_rel_err_vs_f64_card": max(e_card),
                    "grad_worst_leaf_card": paths[e_card.index(max(e_card))],
                    "grad_rel_err_vs_f64_cpu": max(e_cpu),
                    "grad_worst_leaf_cpu": paths[e_cpu.index(max(e_cpu))],
                    "cpu_leaves_above_tol": {paths[i]: e for i, e in enumerate(e_cpu)
                                             if e > RESNET_REL_TOL},
                    "card_leaves_above_max_tol_2x_cpu": over, "held": held}
        faults += [f"float32 {how} grads: {over}"] * bool(held and over)
    faults += ["params"] * ((n_params, n_leaves) != (RESNET_PARAMS, RESNET_LEAVES))
    if faults:
        emit({**row, "failed": faults})
        raise AssertionError(f"resnet_check: {faults}")
    emit(row)


def run_resnet_phase(name, data, params0, state, **loop):
    """run_training on resnet50 at its published size, the counts set to 0
    just before and read just after. DASO batches (R, 32, ...) with the
    initial batch-norm state broadcast over the replicas (a stride-0
    expand); sync batches the same 128 images flat. Returns (result, row,
    launches, modes)."""
    cfg = get_config(RESNET_ARCH)
    strategy = loop.get("strategy", "daso")
    if strategy == "sync":
        def batch(step):
            t = step % RESNET_DATA_STEPS
            return {"images": data["images"][t].flatten(0, 1),
                    "labels": data["labels"][t].flatten(), "bn_state": state}
    else:
        bn_r = tree_map(lambda x: x.expand((RESNET_R,) + x.shape), state)

        def batch(step):
            t = step % RESNET_DATA_STEPS
            return {"images": data["images"][t], "labels": data["labels"][t],
                    "bn_state": bn_r}
    sync()
    torch.cuda.reset_peak_memory_stats()
    start, retries = torch.cuda.memory_allocated(), torch.cuda.memory_stats()["num_alloc_retries"]
    zero_counts()
    t0 = time.perf_counter()
    loop_cfg = TrainLoopConfig(**{**RESNET_LOOP, **loop})
    res = run_training(make_resnet_loss(cfg), {"net": params0}, batch, loop_cfg, log=None)
    sync()
    wall = time.perf_counter() - t0
    launches = counts()
    peak = torch.cuda.max_memory_allocated()
    n = sum(x.numel() for x in leaves(params0))
    modes = [h[1] for h in res.controller.history] if res.controller else ["sync"] * RESNET_STEPS
    losses = res.losses
    row = {"phase": name, "arch": RESNET_ARCH, "entry": "run_training", **loop,
           "config": dataclasses.asdict(cfg), "dtype": "float32", "tf32": False,
           "cudnn_deterministic": torch.backends.cudnn.deterministic,
           "params_per_replica": n, "leaves": len(leaves(params0)),
           "replicas": 1 if strategy == "sync" else RESNET_R,
           "images_per_step": RESNET_R * RESNET_PER, "lr": loop_cfg.lr,
           "optimizer": "sgd(0.9, 1e-4)", "steps": RESNET_STEPS,
           "data_steps": RESNET_DATA_STEPS,
           "mode_counts": {m: modes.count(m) for m in sorted(set(modes))},
           "launches": launches, "sync_fraction": res.sync_fraction,
           "wire_bytes_per_exchange": {"f32": 4 * n, "bf16": 2 * n},
           "first_loss": losses[0], "last_loss": losses[-1],
           "last4_mean_loss": statistics.mean(losses[-4:]), "losses": losses,
           "acc_last4": [m["acc"] for m in res.metrics[-4:]],
           "wall_s": wall, "max_memory_allocated": peak,
           "memory": {"allocated_at_start": start, "peak_above_start": peak - start,
                      "max_memory_reserved": torch.cuda.max_memory_reserved(),
                      "alloc_retries": torch.cuda.memory_stats()["num_alloc_retries"] - retries}}
    stats = res.executor_stats
    if stats is None:
        by_mode = {}
        for m, sec in zip(modes, res.step_seconds):
            by_mode.setdefault(m, []).append(1e3 * sec)
        row.update(step_ms_median={m: statistics.median(v) for m, v in by_mode.items()},
                   step_ms_all=by_mode)
    else:
        row.update(executor_stats=dataclasses.asdict(stats),
                   dispatches_per_step=stats.dispatches_per_step(),
                   programs_built=stats.compiles, cycle_ms=cycle_rows(res))
    if not all(math.isfinite(x) for x in losses):
        emit({**row, "failed": "loss"})
        raise AssertionError(f"{name}: losses {losses}")
    return res, row, launches, [outer_mode(m) for m in modes]


def phase_train_resnet(data):
    """DASO on resnet50 at its published size through run_training on the
    per-step executor, then the macro executor (the default), then sync.
    Held: the two DASO carries (params, momentum and in-flight of every
    replica) and losses bit for bit; the mean loss of the last 4 steps below
    ln 1000; send, receive and local in the controller's history; K2 / K3 /
    K4 launches as the modes imply (K2 per receive step, K3 per blocking
    step, K4 none: the bf16 mean is cast back by torch) and none under sync,
    whose loss falls. Then the arena phase on the per-step carry's
    parameters (R, 25,557,032): a wire_roundtrip (K3 then K4, counted) and
    K2 to K4 bit for bit their plain versions, timed there. Returns each
    path's launches and the arena's kernel rows."""
    cfg = get_config(RESNET_ARCH)
    params0, state = init_resnet(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    out = {}
    per_step, row, launches, modes = run_resnet_phase(
        "train_resnet", data, params0, state, strategy="daso", executor="per_step")
    want = train_launches(modes)
    check_launches(row, launches, want)
    row["loss_threshold_measures"] = (f"fitting {RESNET_DATA_STEPS * RESNET_R * RESNET_PER} "
                                      f"images, each seen {RESNET_STEPS // RESNET_DATA_STEPS} "
                                      "times")
    faults = [what for what, bad in (
        ("loss above ln 1000", not row["last4_mean_loss"] < math.log(cfg.n_classes)),
        ("modes", not {"send", "receive", "local"} <= set(modes))) if bad]
    if faults:
        emit({**row, "failed": faults})
        raise AssertionError(f"train_resnet: {faults}")
    emit(row)
    daso_last4 = row["last4_mean_loss"]
    out["train_resnet"] = launches
    macro, row, launches, modes_m = run_resnet_phase(
        "train_resnet_macro", data, params0, state, strategy="daso", executor="macro")
    check_launches(row, launches, want)
    row["carry_identical_to_per_step"] = all(
        same_bits(a, b) for a, b in zip(leaves(macro.carry), leaves(per_step.carry),
                                        strict=True))
    row["losses_identical_to_per_step"] = macro.losses == per_step.losses
    row["history_identical_to_per_step"] = (macro.controller.history
                                            == per_step.controller.history)
    faults = [k for k in ("carry_identical_to_per_step", "losses_identical_to_per_step",
                          "history_identical_to_per_step") if not row[k]]
    if faults:
        emit({**row, "failed": faults})
        raise AssertionError(f"train_resnet_macro: {faults}")
    emit(row)
    out["train_resnet_macro"] = launches
    del macro
    sync_res, row, launches, _ = run_resnet_phase(
        "train_resnet_sync", data, params0, state, strategy="sync")
    check_launches(row, launches, train_launches([]))
    row["daso_last4_over_sync"] = daso_last4 / row["last4_mean_loss"]
    faults = [what for what, bad in (
        ("the loss did not fall", not row["last4_mean_loss"] < row["first_loss"]),
        ("DASO's last-4 loss outside 10 % of sync's",
         not abs(row["daso_last4_over_sync"] - 1) <= RESNET_PARITY_BAND)) if bad]
    if faults:
        emit({**row, "failed": faults})
        raise AssertionError(f"train_resnet_sync: {faults}")
    emit(row)
    out["train_resnet_sync"] = launches
    del sync_res
    params_r = per_step.carry[0]
    del per_step
    arena = flatbuf.pack(params_r, flatbuf.build_layout(params_r, batch_dims=1))["float32"]
    del params_r
    launches, rows = resnet_arena(arena)
    out["resnet_arena"] = launches
    del arena, params0, state
    torch.cuda.empty_cache()
    return out, rows


def resnet_arena(arena):
    """K2 to K4 on the ResNet run's parameter arena: a counted
    wire_roundtrip, each kernel bit for bit its plain version, and its ms,
    plain ms, bound and library ms (the calls phase_timing times) there."""
    sync()
    zero_counts()
    stale = flatbuf.wire_roundtrip(arena, "bf16")
    sync()
    launches = counts()
    kw = dict(staleness=1, global_world=RESNET_R * RESNET_LOOP["local_world"])
    wire = ops.bf16_pack(arena)
    n = arena.numel()
    p = float(kw["global_world"])
    timed = {"eq1_merge": (lambda: ops.eq1_merge(arena, stale, **kw),
                           lambda: ref.eq1_merge_ref(arena, stale, **kw),
                           lambda: torch.lerp(arena, stale, p / (2.0 + p)), n * 12),
             "bf16_pack": (lambda: ops.bf16_pack(arena), lambda: ref.bf16_pack_ref(arena),
                           lambda: arena.to(torch.bfloat16), n * 6),
             "bf16_unpack": (lambda: ops.bf16_unpack(wire), lambda: ref.bf16_unpack_ref(wire),
                             lambda: wire.to(torch.float32), n * 6)}
    rows = {}
    for name, (kernel_fn, plain_fn, library_fn, nbytes) in timed.items():
        bound, by = bytes_bound(nbytes)
        rows[name] = {"shape": list(arena.shape), "bit_exact": same_bits(kernel_fn(), plain_fn()),
                      "ms": cuda_ms(kernel_fn, 20, warmup=3),
                      "plain_ms": cuda_ms(plain_fn, 10, warmup=2), "bound_ms": bound,
                      "bound_by": by, "bytes": nbytes,
                      "library_ms": cuda_ms(library_fn, 20, warmup=3)}
    row = {"phase": "resnet_arena", "shape": list(arena.shape),
           "wire_roundtrip_launches": launches, "kernels": rows}
    if (launches["bf16_pack"], launches["bf16_unpack"]) != (1, 1) or not all(
            r["bit_exact"] for r in rows.values()):
        emit({**row, "failed": "launches or bits"})
        raise AssertionError(f"resnet_arena: {row}")
    emit(row)
    return launches, rows


DRIFT_LINE = re.compile(r"max \|loss trace drift\|\s+(\S+)")


def phase_launch_ablation():
    """`python -m repro_torch.launch.ablation --steps 12` on the card, the
    user's entry point for the CNN: exits 0, every run's line printed, and
    the macro and per-step loss traces equal (drift 0)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.ablation", "--steps",
                        str(ABLATION_STEPS)], capture_output=True, text=True,
                       timeout=ABLATION_TIMEOUT, env=env)
    lines = [ln for ln in r.stdout.splitlines() if "final_loss=" in ln or "drift" in ln]
    m = DRIFT_LINE.search(r.stdout)
    row = {"phase": "launch_ablation", "argv": ["--steps", ABLATION_STEPS],
           "exit_code": r.returncode, "wall_s": time.perf_counter() - t0, "lines": lines,
           "drift": float(m.group(1)) if m else None}
    faults = [what for what, bad in (
        ("exit", r.returncode != 0), ("runs", len(lines) != 11),
        ("drift", row["drift"] != 0.0)) if bad]
    if faults:
        emit({**row, "failed": faults, "output_tail": (r.stdout + r.stderr)[-4000:]})
        raise AssertionError(f"launch_ablation: {faults}")
    emit(row)


# -- the per-leaf exchange and the autotune plane -------------------------------------

# the short one_cycle pair on the paper's wires (f32 cycling, bf16 blocking):
# 16 steps (warm-up 1, cool-down 1) hold per-leaf against fused through ov_start,
# three overlap cycles and the blocking phases at a quarter of the cell's wall
OV_PER_LEAF_STEPS = 16


def per_leaf_launches(want, n_leaves):
    """The launches of a fused path's `want` with K2 and K3 once per
    floating leaf instead of once per arena (the per-leaf exchange)."""
    return {**want, "eq1_merge": want["eq1_merge"] * n_leaves,
            "bf16_pack": want["bf16_pack"] * n_leaves}


def overlap_launches(modes):
    """One f32 arena on the paper's wires under one_cycle: K2 once per
    ov_sync (the merge), K3 once per blocking step; the cycling exchange
    is f32 and launches nothing."""
    return {**no_launches(), "eq1_merge": modes.count("ov_sync"),
            "bf16_pack": modes.count("blocking")}


def n_floating_leaves(params0):
    return sum(x.is_floating_point() for x in leaves(params0))


def phase_train_macro_per_leaf(trained, macro):
    """The train_macro cell with exchange_impl="per_leaf": its losses and
    every row of its final carry (params, momentum and in-flight of every
    replica; row digests) bit for bit train_macro's, its params and
    momentum bit for bit the per-step carry in `trained`; K2 once per
    receive step and floating leaf, K3 once per blocking step and floating
    leaf. Prints ms per step by cycle shape beside train_macro's, the
    contiguous copies the per-leaf launches needed (count and bytes) and
    the peaks. Returns its launches."""
    t0 = time.perf_counter()
    ops.CONTIGUOUS_COPIES.reset()
    res, row, launches, modes, params0 = run_train_phase(
        "train_macro_per_leaf", {"executor": "macro", "exchange_impl": "per_leaf"}, TRAIN_WHY)
    n_leaves = n_floating_leaves(params0)
    params_r, opt_r, _ = res.carry
    row.update(
        floating_leaves=n_leaves, contiguous_copies=ops.CONTIGUOUS_COPIES.copies,
        contiguous_copy_bytes=ops.CONTIGUOUS_COPIES.bytes,
        fused_cycle_ms=macro["cycle_ms"], fused_wall_s=macro["wall_s"],
        fused_max_memory_allocated=macro["max_memory_allocated"],
        losses_identical_to_train_macro=res.losses == macro["losses"],
        carry_rows_identical_to_train_macro=row_digests(res.carry) == macro["digests"],
        carry_identical_to_per_step=all(
            same_bits(a, b) for a, b in zip(leaves((params_r, opt_r)),
                                            leaves(trained["carry"]), strict=True)))
    check_launches(row, launches, per_leaf_launches(train_launches(modes), n_leaves))
    faults = [what for what in ("losses_identical_to_train_macro",
                                "carry_rows_identical_to_train_macro",
                                "carry_identical_to_per_step") if not row[what]]
    if faults:
        emit({**row, "failed": faults})
        raise AssertionError(f"train_macro_per_leaf: {faults}")
    del res, params0, params_r, opt_r
    torch.cuda.empty_cache()
    emit({**row, "phase_wall_s": time.perf_counter() - t0})
    return launches


def phase_train_overlap_per_leaf():
    """A short one_cycle run (OV_PER_LEAF_STEPS steps) of the train cell on
    the paper's wires, fused and then per-leaf, through the macro executor
    (each overlap cycle's exchange on the executor's stream): the per-leaf
    run's losses and every row of its final carry (all four slots) bit for
    bit the fused run's; K2 / K3 as the modes imply, once per floating leaf
    per-leaf. Returns both runs' launches."""
    t0 = time.perf_counter()
    out, want = {}, None
    for impl in ("fused", "per_leaf"):
        name = f"train_macro_overlap_{impl}"
        ops.CONTIGUOUS_COPIES.reset()
        res, row, launches, modes, params0 = run_train_phase(
            name, {"executor": "macro", "overlap": "one_cycle", "exchange_impl": impl},
            INT8_OVERLAP_WHY, steps=OV_PER_LEAF_STEPS)
        n_leaves = n_floating_leaves(params0)
        st = res.executor_stats
        row.update(steady_cycle_ms=steady_overlap_cycles(res),
                   legs_ms={k: 1e3 * getattr(st, k) for k in OVERLAP_LEGS},
                   contiguous_copies=ops.CONTIGUOUS_COPIES.copies,
                   contiguous_copy_bytes=ops.CONTIGUOUS_COPIES.bytes)
        expected = overlap_launches(modes)
        if impl == "per_leaf":
            expected = per_leaf_launches(expected, n_leaves)
        row["launches_expected"] = expected
        faults = [] if launches == expected else ["launches"]
        if st.overlap_cycles == 0:
            faults.append("no overlap cycle")
        if want is None:
            want = (res.losses, row_digests(res.carry), row["cycle_ms"],
                    row["max_memory_allocated"])
        else:
            row.update(fused_cycle_ms=want[2], fused_max_memory_allocated=want[3],
                       losses_identical_to_fused=res.losses == want[0],
                       carry_rows_identical_to_fused=row_digests(res.carry) == want[1])
            faults += [what for what in ("losses_identical_to_fused",
                                         "carry_rows_identical_to_fused") if not row[what]]
        if faults:
            emit({**row, "failed": faults})
            raise AssertionError(f"{name}: {faults}")
        out[name] = launches
        del res, params0
        torch.cuda.empty_cache()
        if impl == "per_leaf":  # the pair's wall on the second row
            row["phase_wall_s"] = time.perf_counter() - t0
        emit(row)
    return out


def phase_train_procs_per_leaf(fused):
    """train_procs's configuration over two processes with --exchange-impl
    per_leaf: the losses, the final params and every carry row bit for bit
    the fused two-process run of train_procs (`fused`); one gather per leaf
    (gathers = the fused run's x the leaves) and the fused run's bytes;
    each process's K2 / K3 once per floating leaf. Prints the gathers per
    exchange, bytes, ms per gather (D2H, gloo, H2D) and GB/s beside the
    fused run's. Returns {path: launches}."""
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    sync()
    name, extra = "train_procs_per_leaf", ["--exchange-impl", "per_leaf"]
    tmp = tempfile.mkdtemp(prefix=f"chip_smoke_{name}_")
    try:
        m, reps, wall, ck = procs_run(tmp, name, 2, extra)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    n_leaves = len(reps[0]["params_digest"])
    modes = [outer_mode(x) for x in reps[0]["modes"]]
    digests = {}
    for rep in reps:
        digests.update(rep["carry_digest"])
    gathers = [gather_row(r) for r in reps]
    want = per_leaf_launches(train_launches(modes), n_leaves)
    row = {"phase": name, "arch": ARCH, "entry": "python -m repro_torch.launch.procs",
           "argv": PROCS_ARGS + extra, "transport": "gloo", "procs": 2,
           "reduced": {"n_layers": [get_config(ARCH).n_layers, PROCS_LAYERS],
                       "why": PROCS_WHY},
           "floating_leaves": n_leaves, "wall_s": wall,
           "child_wall_s": [r["wall_s"] for r in reps],
           "max_memory_allocated": [r["max_memory_allocated"] for r in reps],
           "gathers": gathers, "fused_gathers": fused["gathers"],
           # the fused run gathers once per exchange
           "gathers_per_exchange": [g["calls"] / f["calls"]
                                    for g, f in zip(gathers, fused["gathers"])],
           "payload_bytes_per_exchange": [
               [g["payload_bytes_per_exchange"] * g["calls"] / f["calls"],
                f["payload_bytes_per_exchange"]] for g, f in zip(gathers, fused["gathers"])],
           "ms_per_exchange": [[g["ms_per_gather"] * g["calls"] / f["calls"],
                                f["ms_per_gather"]]
                               for g, f in zip(gathers, fused["gathers"])],
           "cycle_ms": [report_cycle_ms(r) for r in reps],
           "launches": {f"p{r['proc']}": r["launches"] for r in reps},
           "launches_expected": want,
           "losses_identical_to_fused": m["losses"] == fused["losses"],
           "params_identical_to_fused": reps[0]["params_digest"] == fused["params_digest"],
           "carry_rows_identical_to_fused": digests == fused["carry_digest"]}
    faults = [what for what, bad in (
        ("losses", not row["losses_identical_to_fused"]),
        ("final params", not row["params_identical_to_fused"]),
        ("carry rows", not digests or not row["carry_rows_identical_to_fused"]),
        ("checkpoint", not ck),
        ("gathers", any(g["calls"] != f["calls"] * n_leaves
                        for g, f in zip(gathers, fused["gathers"]))),
        # the runs' payload bytes by dtype, exact integers (a per-exchange
        # mean times the calls rounds: 44 gathers of 10 steps gave
        # 1940951039.9999998 against 1940951040.0)
        ("bytes", any(g["payload_bytes_by_dtype"] != f["payload_bytes_by_dtype"]
                      for g, f in zip(gathers, fused["gathers"]))),
        ("launches", any({k: r["launches"][k] for k in PROCS_COMM}
                         != {k: want[k] for k in PROCS_COMM} for r in reps))) if bad]
    if faults:
        emit({**row, "failed": faults})
        raise AssertionError(f"{name}: {faults}")
    emit({**row, "phase_wall_s": time.perf_counter() - t0})
    return {f"{name}.p{r['proc']}": r["launches"] for r in reps}


# train_autotune: the topology cell through the supervisor with a probe round
# every cycle; replicas 1 and 3 (one in each host pair) straggle x3 from step
# 4, so the probe regroups them together, and the network between the pods
# falls to a quarter of its bandwidth at step 8, which only the probe tells
# the controller (oracle_notify is off under autotune)
AUTOTUNE_EVENTS = [{"step": 4, "kind": "straggle", "replica": 1, "factor": 3.0},
                   {"step": 4, "kind": "straggle", "replica": 3, "factor": 3.0},
                   {"step": 8, "kind": "degrade_dcn", "factor": 0.25}]
AUTOTUNE_DEGRADE, AUTOTUNE_WITHIN = 8, 3
AUTOTUNE_SUPERVISE = {"autotune_every": 1, "t_compute_s": SIM_T_COMPUTE,
                      "exchange_cost_fn": sim_exchange_s}


@contextmanager
def group_perms():
    """Yields each permutation the supervisor sets
    (`DasoStrategy.set_group_permutation`), in call order."""
    fn, perms = DasoStrategy.set_group_permutation, []

    def spy(self, perm):
        perms.append(None if perm is None else list(perm))
        return fn(self, perm)

    DasoStrategy.set_group_permutation = spy
    try:
        yield perms
    finally:
        DasoStrategy.set_group_permutation = fn


def autotune_record(report):
    """What a CPU rehearsal of the plan must give too: the autotune records,
    the membership timeline, the simulated clock, the controller's events
    and history (the schedule alone decides them)."""
    ctl = report.result.controller
    return {"retunes": [{k: r[k] for k in ("step", "cycle", "measured_s", "nominal_s",
                                           "schedule_changed", "reshuffled")}
                        for r in report.retunes],
            "reshuffles": report.reshuffles,
            "membership_timeline": report.membership_timeline,
            "simulated_time_s": report.simulated_time_s,
            "events": [list(e) for e in ctl.events],
            "history": [list(h) for h in ctl.history],
            "inner_periods": getattr(ctl, "inner_periods", {})}


def degradation_cycle(report):
    """The index of the first cycle that starts at or after step
    AUTOTUNE_DEGRADE (the run starts at step 0; the plan's events cut the
    cycles), or None when no cycle does."""
    start = 0
    for i, (shape, _) in enumerate(report.result.cycles):
        if start >= AUTOTUNE_DEGRADE:
            return i
        start += len(shape)
    return None


def autotune_faults(report, perms):
    """The autotune path's holds: a schedule-changing retune within
    AUTOTUNE_WITHIN cycles of the degradation's cycle (`degradation_cycle`,
    whether or not a retune is recorded there), with B stretched past b_max;
    a regrouping that puts replicas 1 and 3 in one host pair; at least one
    invalidation."""
    sched = [r for r in report.retunes if r["schedule_changed"]]
    degrade_cycle = degradation_cycle(report)
    hist = report.result.controller.history
    return [what for what, bad in (
        ("no retune after the degradation", not sched or sched[0]["step"] < AUTOTUNE_DEGRADE),
        ("retune late", not sched or degrade_cycle is None
         or sched[0]["cycle"] - degrade_cycle > AUTOTUNE_WITHIN),
        ("b not stretched", not any(b > TRAIN_B_MAX for t, _, b, _ in hist
                                    if t >= AUTOTUNE_DEGRADE)),
        ("no regrouping of {1, 3}", report.reshuffles < 1 or not perms or perms[-1] is None
         or {1, 3} not in [set(perms[-1][i:i + 2]) for i in (0, 2)]),
        ("no invalidation", report.invalidations < 1)) if bad]


def phase_train_autotune(topo_macro):
    """The train_macro_topo cell through run_with_faults with a probe round
    every cycle (exchange_cost_fn = sim_exchange_s) on AUTOTUNE_EVENTS: a
    schedule-changing retune within 3 cycles of the degradation with B
    stretched, a regrouping of {1, 3}, an invalidation, and the retunes,
    reshuffles, controller events and history, membership timeline and
    simulated clock of a CPU rehearsal of the plan; the loss falls. Then the
    same cell with an empty plan and autotune every cycle: the untuned
    train_macro_topo run's losses and final carry rows (`topo_macro`) bit
    for bit. Then the int8 + one_cycle variant of the plan (K5 / K6 on this
    path), held as the first and to its own rehearsal. Returns the three
    runs' launches."""
    t0 = time.perf_counter()
    plan = FaultPlan.from_dicts(AUTOTUNE_EVENTS)
    out = {}
    for name, options, why in (("train_autotune", {}, TRAIN_WHY),
                               ("train_autotune_int8_overlap", INT8_OVERLAP,
                                INT8_OVERLAP_WHY)):
        with group_perms() as perms:
            report, row, launches, modes, params0 = run_train_phase(
                name, {"executor": "macro", "topology": TOPO_SPEC, **options}, why,
                plan=plan, supervise=AUTOTUNE_SUPERVISE)
        want_launches = (int8_overlap_launches(modes) if options
                         else train_launches(modes))
        got = autotune_record(report)
        rehearsal = autotune_record(cpu_rehearsal(
            "daso", {"topology": TOPO_SPEC, **options}, AUTOTUNE_EVENTS, autotune_every=1))
        row.update(fault_events=AUTOTUNE_EVENTS, group_perms=perms,
                   degradation_cycle=degradation_cycle(report),
                   invalidations=report.invalidations, wasted_wait_s=report.wasted_wait_s,
                   b_by_step=[h[2] for h in report.result.controller.history],
                   launches_expected=want_launches,
                   **{k: v for k, v in got.items() if k != "history"},
                   rehearsal_identical={k: got[k] == rehearsal[k] for k in got})
        faults = autotune_faults(report, perms) + [
            f"{k} differs from the CPU rehearsal" for k, ok in
            row["rehearsal_identical"].items() if not ok]
        if launches != want_launches:
            faults.append("launches")
        if faults:
            emit({**row, "failed": faults, "rehearsal": rehearsal})
            raise AssertionError(f"{name}: {faults}")
        emit(row)
        out[name] = launches
        del report, params0
        torch.cuda.empty_cache()
    report, row, launches, modes, params0 = run_train_phase(
        "train_autotune_empty", {"executor": "macro", "topology": TOPO_SPEC}, TRAIN_WHY,
        plan=FaultPlan(), supervise=AUTOTUNE_SUPERVISE)
    row.update(retunes=report.retunes, reshuffles=report.reshuffles,
               invalidations=report.invalidations,
               losses_identical_to_train_macro_topo=report.result.losses
               == topo_macro["losses"],
               carry_rows_identical_to_train_macro_topo=row_digests(report.result.carry)
               == topo_macro["digests"])
    faults = [what for what, bad in (
        ("retuned on a healthy plan", report.retunes or report.reshuffles
         or report.invalidations),
        ("losses", not row["losses_identical_to_train_macro_topo"]),
        ("carry rows", not row["carry_rows_identical_to_train_macro_topo"]),
        ("launches", launches != topo_macro["launches"])) if bad]
    if faults:
        emit({**row, "failed": faults})
        raise AssertionError(f"train_autotune_empty: {faults}")
    out["train_autotune_empty"] = launches
    del report, params0
    torch.cuda.empty_cache()
    emit({**row, "phase_wall_s": time.perf_counter() - t0})  # the three runs' wall
    return out


PROBE_LINE = re.compile(r"\[train\] autotune probe: measured (\{.*\}) us/sync -> "
                        r"retuned=(\w+) b=(\d+) inner_periods=(\{.*\})")
RETUNE_LINE = re.compile(r"\[train\]\s+step\s+(\d+) retune\s+cycle=(\d+) changed=(\w+) "
                         r"reshuffled=(\w+)")
LAUNCH_AUTOTUNE_STEPS = 16


def launch_main(argv):
    """`repro_torch.launch.train.main(argv)` on the card with its standard
    output captured (and echoed). Returns (result, output, launches)."""
    import io
    from contextlib import redirect_stdout

    from repro_torch.launch import train as launch_train

    buf = io.StringIO()
    sync()
    zero_counts()
    with redirect_stdout(buf):
        res = launch_train.main(argv)
    sync()
    launches = counts()
    text = buf.getvalue()
    print(text, end="", flush=True)
    return res, text, launches


@contextmanager
def probe_results():
    """Yields each ProbeResult `topo_probe.active_probe` returns, in call
    order (the launcher's startup probe calls it through the module)."""
    fn, results = topo_probe.active_probe, []

    def spy(*args, **kwargs):
        results.append(fn(*args, **kwargs))
        return results[-1]

    topo_probe.active_probe = spy
    try:
        yield results
    finally:
        topo_probe.active_probe = fn


def probe_line_faults(probe, results):
    """The startup probe's printed line against its ProbeResult: the us per
    level are the probe's costs rounded as printed, and retuned, b and
    inner_periods are what `retune` of those costs gives on a fresh
    controller of TOPO_SPEC at the launcher's b_max, so the run's schedule
    follows from the costs it printed."""
    if probe is None or len(results) != 1:
        return ["probe line or result missing"], None
    pr = results[0]
    spec = TopologySpec.parse(TOPO_SPEC)
    fresh = make_controller(spec, daso_config_from(spec, b_max=TRAIN_B_MAX))
    changed = fresh.retune(pr.costs, annotated=topo_probe.annotated_level_costs(
        spec, pr.param_bytes))
    want = {"probe_us_per_sync": {k: round(v * 1e6, 1) for k, v in pr.costs.items()},
            "retuned": str(changed), "b": fresh.b, "inner_periods": str(fresh.inner_periods)}
    got = {"probe_us_per_sync": ast.literal_eval(probe.group(1)), "retuned": probe.group(2),
           "b": int(probe.group(3)), "inner_periods": probe.group(4)}
    return [f"printed {k} is not the retune of the probed costs"
            for k in want if got[k] != want[k]], want


def phase_launch_autotune():
    """The launcher's --autotune on the card: `main(--tiny --topology
    TOPO_SPEC --autotune)` prints the startup probe's us per level, retuned,
    b and inner_periods (the probe times `level_group_mean` on the card),
    and those are what `retune` of the probed costs gives on a fresh
    controller (`probe_line_faults`);
    then `--fault-plan AUTOTUNE_EVENTS --autotune --autotune-every 2` prints
    one line per retune, with one that changed the schedule and one that
    regrouped. K2 / K3 as the modes imply in both. Returns the launches."""
    t0 = time.perf_counter()
    base = ["--tiny", "--steps", str(LAUNCH_AUTOTUNE_STEPS), "--topology", TOPO_SPEC,
            "--b-max", str(TRAIN_B_MAX)]
    with probe_results() as results:
        res, text, launches = launch_main(base + ["--autotune"])
    probe = PROBE_LINE.search(text)
    line_faults, retune_of_costs = probe_line_faults(probe, results)
    modes = [outer_mode(h[1]) for h in res.controller.history]
    row = {"phase": "launch_autotune", "entry": "repro_torch.launch.train.main",
           "argv": base + ["--autotune"], "device": str(leaves(res.params)[0].device),
           "probe_line": probe.group(0) if probe else None,
           "probe_us_per_sync": ast.literal_eval(probe.group(1)) if probe else None,
           "retuned": probe.group(2) if probe else None,
           "b": int(probe.group(3)) if probe else None,
           "inner_periods": probe.group(4) if probe else None,
           "retune_of_probed_costs": retune_of_costs,
           "launches": launches, "final_loss": res.final_loss}
    faults = line_faults + [what for what, bad in (
        ("no probe line", probe is None),
        ("device", not row["device"].startswith("cuda")),
        ("launches", launches != train_launches(modes))) if bad]
    plan_argv = base + ["--fault-plan", json.dumps({"events": AUTOTUNE_EVENTS}),
                        "--autotune", "--autotune-every", "2"]
    res2, text2, launches2 = launch_main(plan_argv)
    lines = RETUNE_LINE.findall(text2)
    modes2 = [outer_mode(h[1]) for h in res2.controller.history]
    row.update(plan_argv=plan_argv, retune_lines=[list(x) for x in lines],
               plan_launches=launches2, plan_final_loss=res2.final_loss)
    faults += [what for what, bad in (
        ("no schedule-changing retune line", not any(x[2] == "True" for x in lines)),
        ("no regrouping line", not any(x[3] == "True" for x in lines)),
        ("plan launches", launches2 != train_launches(modes2))) if bad]
    if faults:
        emit({**row, "failed": faults})
        raise AssertionError(f"launch_autotune: {faults}")
    emit({**row, "phase_wall_s": time.perf_counter() - t0})
    del res, res2
    torch.cuda.empty_cache()
    return {"launch_autotune": launches, "launch_autotune_plan": launches2}


def max_abs_err(a, b, chunk=1 << 27):
    """Largest |a - b| in f32 (0 where the values are equal, infinities
    included), in chunks so that a full arena needs no f32 copy."""
    a, b = a.reshape(-1), b.reshape(-1)
    worst = 0.0
    for i in range(0, a.numel(), chunk):
        x, y = a[i:i + chunk].float(), b[i:i + chunk].float()
        d = torch.where(x == y, 0.0, (x - y).abs())
        worst = max(worst, float(d.max()))
    return worst


def phase_arena(trained):
    """The final carry's parameters and momentum as training arenas (R, N)
    f32, every replica's row as the carry holds it. The cool-down's
    blocking syncs leave the parameter rows equal, while each replica's
    momentum row is its own. A wire_roundtrip of the parameter arena (K3 then
    K4, counted), and K2 to K6 held bit-exact against their plain versions
    on both arenas (K5: values and scales, at the training path's block
    256, rounding to nearest), with the largest |kernel - plain|. The carry
    is popped from `trained`, so its memory goes once it is packed."""
    arenas = {}
    for name, tree in zip(("params", "momentum"), trained.pop("carry")):
        arenas[name] = flatbuf.pack(tree, flatbuf.build_layout(tree, batch_dims=1))["float32"]
    del tree
    torch.cuda.empty_cache()
    rows_differ = {name: bool((a[1:] != a[:1]).any()) for name, a in arenas.items()}
    sync()
    zero_counts()
    stale = flatbuf.wire_roundtrip(arenas["params"], "bf16")
    sync()
    launches = counts()
    if launches["bf16_pack"] != 1 or launches["bf16_unpack"] != 1:
        raise AssertionError(f"wire_roundtrip launches {launches}")
    kw = dict(staleness=1, global_world=TRAIN_R * TRAIN_LOCAL_WORLD)
    checks, errs = {}, {k["name"]: 0.0 for k in COMM_KERNELS}

    def check(kernel, arena_name, got, want):
        """got, want: a tensor, or K5's (values, scales)."""
        pairs = list(zip(got, want)) if isinstance(got, tuple) else [(got, want)]
        checks[f"{kernel}/{arena_name}"] = all(
            torch.equal(a, b) if a.dtype == torch.int8 else same_bits(a, b)
            for a, b in pairs)
        errs[kernel] = max([errs[kernel]] + [max_abs_err(a, b) for a, b in pairs])

    for name, arena in arenas.items():
        old = stale if name == "params" else flatbuf.wire_roundtrip(arena, "bf16")
        check("eq1_merge", name, ops.eq1_merge(arena, old, **kw),
              ref.eq1_merge_ref(arena, old, **kw))
        for p_eff in (12.0, 40 / 3):  # elastic membership's fractional P_eff
            kw_eff = dict(staleness=1, global_world=p_eff)
            check("eq1_merge", f"{name}@P={p_eff:g}", ops.eq1_merge(arena, old, **kw_eff),
                  ref.eq1_merge_ref(arena, old, **kw_eff))
        del old
        wire = ops.bf16_pack(arena)
        check("bf16_pack", name, wire, ref.bf16_pack_ref(arena))
        check("bf16_unpack", name, ops.bf16_unpack(wire), ref.bf16_unpack_ref(wire))
        del wire
        q = ops.quantize_int8(arena)
        check("quantize_int8", name, q, ref.quantize_int8_block_ref(arena))
        check("dequantize_int8", name, ops.dequantize_int8(*q),
              ref.dequantize_int8_block_ref(*q))
        del q
    arena = arenas.pop("params")
    del arenas
    wire = ops.bf16_pack(arena)
    sync()
    emit({"phase": "arena", "shape": list(arena.shape), "dtype": "float32",
          "rows_differ": rows_differ, "wire_roundtrip_launches": launches,
          "bit_exact": checks, "max_abs_err": errs})
    if not all(checks.values()):
        raise AssertionError(f"training-arena checks {checks}")
    return arena, stale, wire, launches, checks, errs


def bytes_bound(nbytes):
    return 1e3 * nbytes / PEAK_BYTES, "bytes"


def mufu_exps_per_s():
    """The card's peak rate of f32 exps: 16 MUFU ex2 per SM per clock (sm_90)
    at the largest SM clock nvidia-smi reports."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                       capture_output=True, text=True, check=True, timeout=60)
    mhz = float(r.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return 16 * sms * mhz * 1e6, {"sms": sms, "max_sm_clock_mhz": mhz}


def sass_hot_loop(so_path, instance):
    """The SASS of `instance` (a substring of its mangled name) in the built
    library, from cuobjdump: its innermost backward-branch loop with the most
    MUFU.EX2, with its instruction count, its exps and the instructions per
    exp (each exp is one (t, d, n) element of the scan)."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    out = subprocess.run([tool, "-sass", str(so_path)], capture_output=True, text=True,
                         check=True, timeout=300).stdout
    instrs, name = [], None
    for line in out.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
        elif name and instance in name:
            m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
            if m:
                instrs.append((int(m.group(1), 16), m.group(2)))
    if not instrs:
        raise AssertionError(f"no SASS for {instance} in {so_path}")

    def opcode(text):
        words = text.split()
        return words[1] if words[0].startswith("@") else words[0]

    loops = []
    for addr, text in instrs:
        m = re.search(r"0x([0-9a-f]+)", text)
        if opcode(text).startswith("BRA") and m and int(m.group(1), 16) <= addr:
            loops.append((int(m.group(1), 16), addr))
    inner = [lp for lp in loops if not any(
        lp[0] <= o[0] and o[1] <= lp[1] and o != lp for o in loops)]
    best = None
    for lo, hi in inner:
        body = [opcode(x) for a, x in instrs if lo <= a <= hi]
        exps = body.count("MUFU.EX2")
        if exps and (best is None or exps > best["exps"]):
            best = {"instance": name, "instructions": len(body), "exps": exps,
                    "per_exp": len(body) / exps,
                    "opcodes": dict(collections.Counter(body).most_common())}
    if best is None:
        raise AssertionError(f"no loop with MUFU.EX2 in {instance}")
    return best


def scan_timing(scan_rows, mamba_launches, reports):
    """K7's line at the serving prefill's shape: bf16 x, strided bf16 Bm / Cm
    as the mixer hands them over, f32 dt, A and h0. Beside the bound: the
    design's choice (lanes, channels per CTA, tile, stages, resident CTAs per
    SM), ptxas's registers and spills of the instance, the achieved TB/s and
    exps/s, fp32_issue_ms (the inner loop's SASS instructions per exp x
    B S Di N over the SMs' 128 lanes per clock at the clock the row reads)
    and the wrapper's host time per call, the tensor-map encoding included."""
    cfg = get_config(MAMBA_ARCH)
    B, S, Di, N = BATCH, PROMPT, cfg.d_inner, cfg.ssm.d_state
    args = scan_inputs(B, S, Di, N, torch.bfloat16, False, cfg.dt_rank, seed=9)
    x, dt, A, Bm, Cm, h0 = args
    # each input read once (Bm, Cm: the N columns of each row), y and h written
    nbytes = (x.numel() * x.element_size() + dt.numel() * 4 + A.numel() * 4
              + 2 * B * S * N * Bm.element_size() + h0.numel() * 4
              + B * S * Di * 4 + B * Di * N * 4)
    exps = B * S * Di * N
    rate, clock = mufu_exps_per_s()
    bytes_ms, exp_ms = 1e3 * nbytes / PEAK_BYTES, 1e3 * exps / rate
    row = next(r for r in scan_rows if r["case"] == "serve_shape_bf16")
    kern = next(k for k in KERNELS if k["name"] == "ssm_scan")
    ms = cuda_ms(lambda: ops.ssm_scan(*args), 20)
    instance = f"ssm_scan_kernelI13__nv_bfloat16Li{N}ELb0E"  # N == NMAX: unmasked
    name, regs = next((n, r) for n, r in ptxas_instances(reports["ssm_scan"]).items()
                      if instance in n)
    sass = sass_hot_loop(ops.BUILD_DIR / "libssm_scan.so", instance)
    issue_ms = 1e3 * sass["per_exp"] * exps / (
        clock["sms"] * 128 * clock["max_sm_clock_mhz"] * 1e6)
    line = {
        "name": kern["name"], "route": kern["route"], "source": kern["source"],
        "replaces": kern["replaces"], "launches": mamba_launches["ssm_scan"],
        "max_abs_err": row["max_abs_err"], "tolerance": row["tolerance"],
        "ms": ms, "plain_ms": cuda_ms(lambda: ref.ssm_scan_ref(*args), 2, warmup=1),
        "bound_ms": max(bytes_ms, exp_ms),
        "bound_by": "operations" if exp_ms >= bytes_ms else "bytes",
        "bytes": nbytes, "bytes_ms": bytes_ms, "exps": exps, "exp_ms": exp_ms,
        "exp_rate": rate, **clock, "library_ms": None,
        "library": "none: no single PyTorch call computes a selective-scan recurrence",
        "design": scan_config(ops.kernel_library("ssm_scan"), torch.bfloat16, N),
        "ptxas": {"instance": name, **regs},
        "sass_inner_loop": sass, "fp32_issue_ms": issue_ms,
        "tb_per_s": nbytes / ms / 1e9, "exps_per_s": exps / ms * 1e3,
        "host_us": host_us(lambda: ops.ssm_scan(*args)),
        "shape": [B, S, Di, N], "dtype": "bf16 x / Bm / Cm, f32 dt / A / h0",
        "path": "serve_mamba prefill (per generate)"}
    del args, x, dt, A, Bm, Cm, h0
    torch.cuda.empty_cache()
    return line


def rgemma_timing(check_rows, rglru_rows, rgemma_launches, reports):
    """K8's line at the recurrentgemma-9b prefill's shape (a, gx f32 as the
    mixer makes them, zero h0), and K1's at its local attention's (MQA,
    head_dim 256, window 2048)."""
    cfg = get_config(RGEMMA_ARCH)
    B, S, W = BATCH, PROMPT, cfg.lru_width
    a, gx, h0 = rglru_inputs(B, S, W, torch.float32, False, seed=10)
    # a and gx read once, h0 read once, hs and h written once
    nbytes = (a.numel() + gx.numel() + h0.numel() + B * S * W + B * W) * 4
    row = next(r for r in rglru_rows if r["case"] == "serve_shape_f32")
    k8 = next(k for k in KERNELS if k["name"] == "rglru_scan")
    bound, by = bytes_bound(nbytes)
    lines = [{
        "name": k8["name"], "route": k8["route"], "source": k8["source"],
        "replaces": k8["replaces"], "launches": rgemma_launches["rglru_scan"],
        "max_abs_err": row["max_abs_err"], "bit_exact": row["bit_exact"],
        "ms": cuda_ms(lambda: ops.rglru_scan(a, gx, h0), 20),
        "plain_ms": cuda_ms(lambda: ref.rglru_scan_ref(a, gx, h0), 2, warmup=1),
        "bound_ms": bound, "bound_by": by, "bytes": nbytes, "library_ms": None,
        "library": "none: no single PyTorch call computes a first-order linear "
                   "recurrence",
        "shape": [B, S, W], "dtype": "float32",
        "path": "serve_rgemma prefill (per prefill)"}]
    del a, gx, h0

    Hq, Hk, D, window = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.sliding_window
    q, k, v = qkv(BATCH, Hq, Hk, PROMPT, PROMPT, D, torch.bfloat16, seed=8)
    bound, by = attention_bound_ms(q, k, v, window)
    row = next(r for r in check_rows if r["case"] == "d256_serve_shape_bf16")
    fa = KERNELS[0]
    lines.append({
        "name": "flash_attention_fwd_d256", "route": fa["route"], "source": fa["source"],
        "replaces": fa["replaces"], "launches": rgemma_launches[fa["name"]],
        "max_abs_err": row["max_abs_err"], "tolerance": row["tolerance"],
        "ms": cuda_ms(lambda: ops.flash_attention(q, k, v, window=window), 50),
        "plain_ms": cuda_ms(lambda: attention_ref(q, k, v, window=window), 10),
        "bound_ms": bound, "bound_by": by,
        # window 2048 >= the prompt's 1024: causal attention is the same function
        "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), 50),
        "shape": [BATCH, Hq, Hk, PROMPT, PROMPT, D], "dtype": "bfloat16",
        "window": window, "path": "serve_rgemma prefill (per prefill)",
        **k1_extras(reports, q, k, v, window)})
    del q, k, v
    torch.cuda.empty_cache()
    return lines


def scan_bwd_bound(x, Bm, dx, n_states, exp_rate):
    """K7-bwd's least time: the larger of its exps (2 B S Di N: the states
    recomputed once, then the reverse sweep) at the card's exp rate and its
    bytes (x, dt, dy, Bm, Cm, A and h0 read, dx, ddt, dBm, dCm, dA and dh0
    written, each once) at the memory rate. Returns (ms, by, bytes, exps)."""
    B, S, Di = x.shape
    bc = 2 * B * S * n_states * Bm.element_size()
    state = B * Di * n_states * 4
    nbytes = (x.numel() * x.element_size() + 2 * B * S * Di * 4 + bc + Di * n_states * 4
              + state + dx.numel() * dx.element_size() + B * S * Di * 4 + bc
              + Di * n_states * 4 + state)
    exps = 2 * B * S * Di * n_states
    bytes_ms, exp_ms = 1e3 * nbytes / PEAK_BYTES, 1e3 * exps / exp_rate
    return max(bytes_ms, exp_ms), "operations" if exp_ms >= bytes_ms else "bytes", \
        nbytes, exps


def bwd_timing(scan_bwd_rows, rglru_bwd_rows, train_paths, grad_hold, reports):
    """The backward kernels' lines: K7-bwd and K8-bwd at the train cells'
    shapes (f32, as training hands them over: Bm / Cm as views at dt_rank
    256, no cotangent of h_final) with the plain backward's time beside
    them, and at the serving prefill's shapes (K7-bwd with bf16 x / Bm / Cm),
    each beside its bound. Launches are the train phases'."""
    rate, clock = mufu_exps_per_s()
    lines = []
    # K7-bwd
    kern = next(k for k in KERNELS if k["name"] == "ssm_scan_bwd")
    lib = ops.kernel_library("ssm_scan_bwd")
    cfg = get_config(MAMBA_ARCH)
    shapes = {}
    for which, (B, S, dtype) in (("train", (TRAIN_PER, TRAIN_SEQ, torch.float32)),
                                 ("serve", (BATCH, PROMPT, torch.bfloat16))):
        Di, N = cfg.d_inner, cfg.ssm.d_state
        args = scan_inputs(B, S, Di, N, dtype, False, cfg.dt_rank, seed=11)
        (dy,) = cotangents(((B, S, Di),), seed=12)
        ms = cuda_ms(lambda: ssm_scan_bwd(lib, *args, dy), 10)
        bound, by, nbytes, exps = scan_bwd_bound(args[0], args[3], args[0], N, rate)
        shapes[which] = {"shape": [B, S, Di, N], "dtype": str(dtype), "ms": ms,
                         "bound_ms": bound, "bound_by": by, "bytes": nbytes, "exps": exps,
                         "bound_share": bound / ms,
                         "scratch_bytes": 4 * ssm_scan_bwd_scratch(lib, B, S, Di, N)}
        if which == "train":
            shapes[which]["plain_ms"] = cuda_ms(
                lambda: ref.ssm_scan_bwd_ref(*args, dy, None), 2, warmup=1)
        del args, dy
    row = next(r for r in scan_bwd_rows if r["case"] == "train_shape_f32_no_dh")
    train = shapes["train"]
    name, regs = next((n, r) for n, r in ptxas_instances(reports["ssm_scan_bwd"]).items()
                      if "ssm_scan_bwd_kernelIfLi16EE" in n)
    lines.append({
        "name": kern["name"], "route": kern["route"], "source": kern["source"],
        "replaces": kern["replaces"],
        "replaces_note": "no Pallas kernel: the JAX package differentiates "
                         "mamba.selective_scan (a chunked associative scan) with jax.grad",
        "launches": train_paths["train_mamba"][kern["name"]],
        "launches_by_path": {"train_mamba": train_paths["train_mamba"][kern["name"]],
                             "recurrent_grad_hold": grad_hold[MAMBA_ARCH][kern["name"]]},
        "max_abs_err": row["max_abs_err"], "scaled_err": row["scaled_err"],
        "tolerance": row["tolerance"],
        "ms": train["ms"], "plain_ms": train["plain_ms"], "bound_ms": train["bound_ms"],
        "bound_by": train["bound_by"], "library_ms": None,
        "library": "none: no single PyTorch call computes a selective scan's backward",
        "exp_rate": rate, **clock, "ptxas": {"instance": name, **regs},
        "path": "train_mamba (one per layer, replica and step)", "shapes": shapes})
    torch.cuda.empty_cache()

    # K8-bwd
    k8 = next(k for k in KERNELS if k["name"] == "rglru_scan_bwd")
    lib = ops.kernel_library("rglru_scan_bwd")
    W = get_config(RGEMMA_ARCH).lru_width
    shapes = {}
    for which, B, S in (("train", TRAIN_PER, TRAIN_SEQ), ("serve", BATCH, PROMPT)):
        a, gx, h0 = rglru_inputs(B, S, W, torch.float32, False, seed=13)
        hs, _ = ops.rglru_scan(a, gx, h0)
        (dhs,) = cotangents(((B, S, W),), seed=14)
        # a, hs and dhs read, da and dgx written; h0 read and dh0 written
        nbytes = (5 * B * S * W + 2 * B * W) * 4
        bound, by = bytes_bound(nbytes)
        ms = cuda_ms(lambda: rglru_scan_bwd(lib, a, h0, hs, dhs), 20)
        shapes[which] = {"shape": [B, S, W], "dtype": "float32", "ms": ms, "bound_ms": bound,
                         "bound_by": by, "bytes": nbytes, "bound_share": bound / ms}
        if which == "train":
            shapes[which]["plain_ms"] = cuda_ms(
                lambda: ref.rglru_scan_bwd_ref(a, gx, h0, hs, dhs, None), 2, warmup=1)
        del a, gx, h0, hs, dhs
    row = next(r for r in rglru_bwd_rows if r["case"] == "train_shape_f32" and not r["dh"])
    train = shapes["train"]
    lines.append({
        "name": k8["name"], "route": k8["route"], "source": k8["source"],
        "replaces": k8["replaces"],
        "replaces_note": "no Pallas kernel: the JAX package differentiates "
                         "mamba.linear_recurrence (a chunked associative scan) with jax.grad",
        "launches": train_paths["train_rgemma"][k8["name"]],
        "launches_by_path": {"train_rgemma": train_paths["train_rgemma"][k8["name"]],
                             "recurrent_grad_hold": grad_hold[RGEMMA_ARCH][k8["name"]]},
        "max_abs_err": row["max_abs_err"], "bit_exact": row["bit_exact"],
        "ms": train["ms"], "plain_ms": train["plain_ms"], "bound_ms": train["bound_ms"],
        "bound_by": train["bound_by"], "library_ms": None,
        "library": "none: no single PyTorch call computes a linear recurrence's backward",
        "path": "train_rgemma (one per RG-LRU layer, replica and step)", "shapes": shapes})
    torch.cuda.empty_cache()
    return lines


def moe_timing(check_rows, variant_launches, reports):
    """K1's lines at head_dim 128: at moonshot-v1-16b-a3b's prefill (MHA 16 /
    16) and at mixtral-8x22b's (GQA 48 / 8, window 4096, which covers the
    1024-token prompt, so SDPA's causal attention is the same function)."""
    fa, lines = KERNELS[0], []
    for i, (arch, case, name) in enumerate((
            (MOE_VARIANTS[0], "d128_moonshot_shape_bf16", "flash_attention_fwd_d128"),
            (MOE_VARIANTS[1], "d128_mixtral_shape_bf16", "flash_attention_fwd_d128_gqa"))):
        cfg = get_config(arch)
        Hq, Hk, D, window = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.sliding_window
        q, k, v = qkv(BATCH, Hq, Hk, PROMPT, PROMPT, D, torch.bfloat16, seed=30 + i)
        bound, by = attention_bound_ms(q, k, v, window)
        row = next(r for r in check_rows if r["case"] == case)
        lines.append({
            "name": name, "route": fa["route"], "source": fa["source"],
            "replaces": fa["replaces"], "launches": variant_launches[arch][fa["name"]],
            "max_abs_err": row["max_abs_err"], "tolerance": row["tolerance"],
            "row_ratio": row["row_ratio"],
            "ms": cuda_ms(lambda: ops.flash_attention(q, k, v, window=window), 50),
            "plain_ms": cuda_ms(lambda: attention_ref(q, k, v, window=window), 10),
            "bound_ms": bound, "bound_by": by,
            "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True), 50),
            "shape": [BATCH, Hq, Hk, PROMPT, PROMPT, D], "dtype": "bfloat16",
            "window": window, "path": f"serve_moe_variants {arch} prefill (per prefill)",
            **k1_extras(reports, q, k, v, window)})
        del q, k, v
    torch.cuda.empty_cache()
    return lines


def phase_timing(check_rows, serve_paths, path_launches, arena_parts, model_lines,
                 reports, resnet_rows):
    """Times of each kernel, its plain version and the library call (K1 at
    the llama serving shape, K2 to K6 at the training arena; `model_lines`
    holds the lines of K7, K8, K1 at head_dim 256, K1 at head_dim 128 and
    K1 at the dense and prefix configs' prefills from `scan_timing`,
    `rgemma_timing`, `moe_timing` and `dense_timing`), and the kernels
    line. `serve_paths`: each head_dim 64 serving path's launches per
    prefill (llama's "serve", granite's "serve_moe"). `path_launches` holds each
    training path's launch counts: K2 and K3 report the train_macro phase's
    (the launcher's default executor), K5 and K6 the
    train_macro_int8_overlap phase's, and every comm kernel lists every
    path's. K2 to K4 also carry their rows at the ResNet run's parameter
    arena (`resnet_rows`, from resnet_arena)."""
    q, k, v = qkv(4, 32, 8, PROMPT, PROMPT, 64, torch.bfloat16, seed=7)
    ms = cuda_ms(lambda: ops.flash_attention(q, k, v), 50)
    plain_ms = cuda_ms(lambda: attention_ref(q, k, v), 10)
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), 50)
    bound_ms, bound_by = attention_bound_ms(q, k, v, 0)
    extras = k1_extras(reports, q, k, v, 0)
    del q, k, v
    serve_row = next(r for r in check_rows if r["case"] == "serve_shape_bf16")
    fa = KERNELS[0]
    lines = [{
        "name": fa["name"], "route": fa["route"], "source": fa["source"],
        "replaces": fa["replaces"], "launches": serve_paths["serve"][fa["name"]],
        "launches_by_path": {path: n[fa["name"]] for path, n in serve_paths.items()},
        "max_abs_err": serve_row["max_abs_err"], "tolerance": serve_row["tolerance"],
        "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": library_ms,
        "shape": [4, 32, 8, PROMPT, PROMPT, 64], "dtype": "bfloat16",
        "path": "serve prefill", **extras}]

    arena, stale, wire, roundtrip_launches, checks, errs = arena_parts
    n = arena.numel()
    s2, p = 2.0, float(TRAIN_R * TRAIN_LOCAL_WORLD)
    kw = dict(staleness=1, global_world=TRAIN_R * TRAIN_LOCAL_WORLD)
    train_launches = path_launches["train_macro"]
    int8_launches = path_launches["train_macro_int8_overlap"]
    values, scales = ops.quantize_int8(arena)
    # K5 reads 4 B and writes 1 B per element and 4 B per scale; K6 the reverse
    int8_bytes = n * 5 + scales.numel() * 4
    no_library = "none: no single PyTorch call computes a block-absmax int8 quantization"
    rows = values.shape[0]
    timed = {
        "eq1_merge": (lambda: ops.eq1_merge(arena, stale, **kw),
                      lambda: ref.eq1_merge_ref(arena, stale, **kw),
                      lambda: torch.lerp(arena, stale, p / (s2 + p)),
                      n * 12, train_launches["eq1_merge"], "train_macro (receive steps)"),
        "bf16_pack": (lambda: ops.bf16_pack(arena), lambda: ref.bf16_pack_ref(arena),
                      lambda: arena.to(torch.bfloat16),
                      n * 6, train_launches["bf16_pack"], "train_macro (blocking steps)"),
        "bf16_unpack": (lambda: ops.bf16_unpack(wire), lambda: ref.bf16_unpack_ref(wire),
                        lambda: wire.to(torch.float32),
                        n * 6, roundtrip_launches["bf16_unpack"],
                        "flatbuf.wire_roundtrip of the training arena"),
        "quantize_int8": (lambda: ops.quantize_int8(arena),
                          lambda: ref.quantize_int8_block_ref(arena), None, int8_bytes,
                          int8_launches["quantize_int8"],
                          "train_macro_int8_overlap (ov_sync and blocking steps)"),
        # every block of the arena is full (N = 256 x 1,976,392): one
        # broadcast product through views, exact as K6 (one rounding)
        "dequantize_int8": (lambda: ops.dequantize_int8(values, scales),
                            lambda: ref.dequantize_int8_block_ref(values, scales),
                            lambda: torch.mul(values.view(rows, -1, 256), scales.unsqueeze(-1)),
                            int8_bytes, int8_launches["dequantize_int8"],
                            "train_macro_int8_overlap (ov_sync and blocking steps)"),
    }
    lib = ops.kernel_library("comm_kernels")
    for kern in COMM_KERNELS:
        kernel_fn, plain_fn, library_fn, nbytes, launches, path = timed[kern["name"]]
        bound, by = bytes_bound(nbytes)
        ms = cuda_ms(kernel_fn, 10, warmup=2)
        lines.append({
            "name": kern["name"], "route": kern["route"], "source": kern["source"],
            "replaces": kern["replaces"], "launches": launches,
            "launches_by_path": {k: v[kern["name"]] for k, v in path_launches.items()},
            "max_abs_err": errs[kern["name"]],
            "bit_exact": all(v for k, v in checks.items()
                             if k.startswith(kern["name"] + "/")),
            "ms": ms, "plain_ms": cuda_ms(plain_fn, 5, warmup=1), "bound_ms": bound,
            "bound_by": by,
            "library_ms": None if library_fn is None else cuda_ms(library_fn, 10, warmup=2),
            "bytes": nbytes, "shape": list(arena.shape), "path": path})
        if library_fn is None:
            lines[-1]["library"] = no_library
        if kern["name"] in resnet_rows:
            lines[-1]["resnet_arena"] = resnet_rows[kern["name"]]
        if kern["name"] in RING_INSTANCES:  # the training arena is f32
            lines[-1].update(stream_extras(
                reports["comm_kernels"], kern["name"],
                ring_config(lib, kern["name"], torch.float32, n), nbytes, ms))
    k6 = next(line for line in lines if line["name"] == "dequantize_int8")
    k6.update(library="torch.mul(values.view(rows, -1, 256), scales.unsqueeze(-1))",
              library_bit_exact=same_bits(timed["dequantize_int8"][2]().view(values.shape),
                                          ops.dequantize_int8(values, scales)))
    # the stochastic K5 (not on the training path) reads the bits as well
    bits = flatbuf.random_bits(arena.shape, torch.Generator(device="cuda").manual_seed(9))
    next(line for line in lines if line["name"] == "quantize_int8").update(
        stochastic_ms=cuda_ms(lambda: ops.quantize_int8(arena, bits), 10, warmup=2),
        stochastic_bound_ms=bytes_bound(int8_bytes + n * 4)[0])
    emit({"phase": "timing", "kernel_lines": len(lines + model_lines)})
    emit({"kernels": lines + model_lines})


def card_line():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True, text=True,
                       check=True, timeout=60)
    return r.stdout.strip().splitlines()[0]


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 1
    strict_f32("cuda")
    reports = phase_build()
    rows = phase_check()
    phase_comm_check()
    scan_rows = phase_scan_check()
    rglru_rows = phase_rglru_check()
    scan_bwd_rows = phase_scan_bwd_check()
    rglru_bwd_rows = phase_rglru_bwd_check()
    serve_launches = phase_serve()
    mamba_launches = phase_serve_mamba()
    scan_line = scan_timing(scan_rows, mamba_launches, reports)
    rgemma_launches = phase_serve_rgemma()
    rgemma_lines = rgemma_timing(rows, rglru_rows, rgemma_launches, reports)
    serve_moe_launches = phase_serve_moe()
    moe_lines = moe_timing(rows, phase_serve_moe_variants(), reports)
    dense_lines = dense_timing(rows, {**phase_serve_dense128(), **phase_serve_prefix()},
                               reports)
    moe_train_launches = phase_train_moe()
    vlm_train_launches = phase_train_vlm()
    grad_hold = phase_recurrent_grad_hold()
    recurrent_train = {name: phase_train_recurrent(name) for name in RECURRENT_CELLS}
    bwd_lines = bwd_timing(scan_bwd_rows, rglru_bwd_rows, recurrent_train, grad_hold, reports)
    for line, kern, serve_path, train_path in (
            (scan_line, "ssm_scan", ("serve_mamba", mamba_launches), "train_mamba"),
            (rgemma_lines[0], "rglru_scan", ("serve_rgemma", rgemma_launches), "train_rgemma")):
        line["launches_by_path"] = {serve_path[0]: serve_path[1][kern],
                                    train_path: recurrent_train[train_path][kern]}
    phase_train_check()
    resume_launches = phase_train_resume()
    int8_per_step = phase_train_int8_overlap()
    int8_macro = phase_train_macro_int8_overlap(int8_per_step)
    trace_launches = phase_train_trace(int8_per_step, int8_macro)
    del int8_per_step["carry"]
    launch_trace_launches = phase_launch_trace()
    topo = phase_train_topo()
    topo_macro = phase_train_macro_topo(topo)
    del topo["carry"]
    topo_int8_launches = phase_train_topo_int8_overlap()
    overlap_per_leaf_launches = phase_train_overlap_per_leaf()
    baselines_launches = phase_train_baselines()
    faults_launches = phase_train_faults()
    autotune_launches = phase_train_autotune(topo_macro)
    launch_faults_launches = phase_launch_faults()
    launch_autotune_launches = phase_launch_autotune()
    procs_launches, procs_fused = phase_train_procs("train_procs", [], train_launches)
    procs_launches.update(phase_train_procs_per_leaf(procs_fused))
    procs_launches.update(phase_train_procs(
        "train_procs_int8_overlap", ["--wire-format", "int8", "--overlap", "one_cycle",
                                     "--dispatch", "overlap"], int8_overlap_launches)[0])
    live_kill_launches = phase_live_kill()
    resnet = resnet_data(get_config(RESNET_ARCH))
    phase_resnet_check(resnet)
    resnet_launches, resnet_rows = phase_train_resnet(resnet)
    del resnet
    phase_launch_ablation()
    trained = phase_train()
    macro = phase_train_macro(trained)
    macro_per_leaf_launches = phase_train_macro_per_leaf(trained, macro)
    empty_launches = phase_train_faults_empty(trained, macro)
    topo_2level_launches = phase_train_topo_2level(trained, macro)
    arena_parts = phase_arena(trained)
    phase_timing(rows, {"serve": serve_launches, "serve_moe": serve_moe_launches}, {
        "train": trained["launches"], "train_macro": macro["launches"],
        "train_int8_overlap": int8_per_step["launches"],
        "train_macro_int8_overlap": int8_macro["launches"],
        "train_trace": trace_launches, "launch_trace": launch_trace_launches,
        "train_resume": resume_launches, "train_topo": topo["launches"],
        "train_macro_topo": topo_macro["launches"], "train_topo_2level": topo_2level_launches,
        **topo_int8_launches, **baselines_launches, **faults_launches,
        "launch_faults": launch_faults_launches, "train_faults_empty": empty_launches,
        **procs_launches, "live_kill": live_kill_launches,
        "train_macro_per_leaf": macro_per_leaf_launches, **overlap_per_leaf_launches,
        **autotune_launches, **launch_autotune_launches, **resnet_launches,
        "train_moe": moe_train_launches, "train_vlm": vlm_train_launches, **recurrent_train},
        arena_parts,
        [scan_line] + rgemma_lines + bwd_lines + moe_lines + dense_lines, reports, resnet_rows)
    emit_total()
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
