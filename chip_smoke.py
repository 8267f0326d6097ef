#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU (built for H100,
sm_90a). Run from the repository root:

  python3 chip_smoke.py

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
               merged file sorted; the cycle spans' steps add to 40 and
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
  launch_faults
               repro_torch.launch.train.main --tiny --steps 12 --fault-plan
               --metrics-out on the card: the "resilience" record's keys and
               events, K2 / K3 as the modes imply
  train_procs, train_procs_int8_overlap
               the multi-process runtime: python -m repro_torch.launch.procs
               runs the launcher's train cell at full width, 2 of 16 layers,
               f32, on chip:4 x host:2@50e9 x pod:2@25e9 (the host syncs stay
               in a process, the pod exchange crosses processes over gloo),
               16 steps, --ckpt at the end, once with 1 process and once with
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
  live_kill    python -m repro_torch.launch.procs --procs 2 --kill 1:6 at
               --tiny on the same topology, --ckpt-every 1: the survivor
               regroups onto one process over every replica, resumes from
               the newest intact TrainState and replays the death; its
               losses and final params equal a one-process run of the same
               crash as a fault plan (resilience.run_with_faults) bit for
               bit; prints the supervisor's detect / regroup / resume s
  train        run_training with DASO on llama3.2-1b at full width, 4 of its
               16 layers, f32, R = 4 replicas: 40 steps on the per-step
               executor, K2 and K3 launches held to the schedule's receive
               and blocking steps, step time by mode, peak memory
  train_macro  the train cell through the macro-cycle executor (the
               launcher's default): the final carry (params and momentum of
               every replica) bit for bit the train phase's, the same K2 and
               K3 launches; dispatches per step, programs built, fallback
               steps, ms per step by cycle shape, peak memory
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
               serving shapes (K1, K7, K8) and the training arena (K2 to K6);
               K1's rows also give the bf16 kernel's tiles, ptxas's
               registers and spills for the instance, and the wrapper's
               host time per call; K2 to K4's the stream ring's choice,
               ptxas's registers and spills, and the achieved TB/s; K7's
               the design's choice (lanes, channels per CTA, tile, stages,
               resident CTAs per SM), ptxas's registers and spills, the
               inner loop's SASS instructions per exp (cuobjdump) and the
               issue floor they give (fp32_issue_ms), TB/s, exps/s and host
               time per call; K6's library call is the broadcast product
               through views
then the `kernels` line, the card's name and power limit, and as the last
line {"ok": true, "device": {...}}.

Exits non-zero without printing a result when no CUDA device is present.
"""
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
from repro_torch.data.synthetic import SyntheticLM  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.comm_kernels import (bf16_pack_fwd, bf16_unpack_fwd,  # noqa: E402
                                              dequantize_int8_fwd, eq1_merge_fwd,
                                              launch_cast, launch_eq1_merge,
                                              quantize_int8_fwd, ring_config)
from repro_torch.kernels.flash_attention import flash_attention_fwd  # noqa: E402
from repro_torch.kernels.ref import attention_ref, attention_row_ratio  # noqa: E402
from repro_torch.kernels.rglru_scan import rglru_scan_fwd  # noqa: E402
from repro_torch.kernels.ssm_scan import scan_config, ssm_scan_fwd  # noqa: E402
from repro_torch.models.lm import forward, init_params  # noqa: E402
from repro_torch.obs import meters  # noqa: E402
from repro_torch.obs.trace import (Tracer, load_events, merge_streams,  # noqa: E402
                                   stream_path, validate_event)
from repro_torch.optim.optimizers import sgd  # noqa: E402
from repro_torch.optim.schedules import constant_lr  # noqa: E402
from repro_torch.resilience import FaultPlan, membership, run_with_faults  # noqa: E402
from repro_torch.resilience import supervisor  # noqa: E402
from repro_torch.serve.engine import Engine, make_decode_fn, make_prefill_fn  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402
from repro_torch.train.loop import TrainLoopConfig, build_strategy, run_training  # noqa: E402
from repro_torch.train.step import make_lm_loss  # noqa: E402

ARCH = "llama3.2-1b"
MAMBA_ARCH = "falcon-mamba-7b"
RGEMMA_ARCH = "recurrentgemma-9b"
RING_PROMPT, RING_NEW = 3072, 8  # past recurrentgemma-9b's 2048-slot window
BATCH, PROMPT, NEW = 4, 1024, 32
# H100 SXM published dense peaks (NVIDIA data sheet)
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}  # tests/test_kernels.py

# train phase: llama3.2-1b at its published widths, depth cut for memory.
# lr: the quickstart's 0.05 (tuned at d_model 128) diverges at this width
# with sgd(0.9, 1e-4) (NaN by step 34), 0.02 oscillates, 0.01 trains
# noisily, 0.005 trains smoothly (PERF.md, Findings)
TRAIN_LAYERS, TRAIN_R, TRAIN_LOCAL_WORLD, TRAIN_B_MAX = 4, 4, 4, 4
TRAIN_STEPS, TRAIN_SEQ, TRAIN_PER, TRAIN_LR = 40, 256, 2, 0.005

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
    ("sk1_bf16", 2, 8, 2, 1, 1, 64, torch.bfloat16, 0, True),
]


def emit(obj):
    print(json.dumps(obj), flush=True)


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
    emit({"phase": "build", "wall_seconds": time.perf_counter() - t0,
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
    the launches of the prefill (decode launches none)."""
    cfg = cfg.replace(n_layers=n_layers, param_dtype=torch.float32,
                      compute_dtype=torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = init_params(cfg, gen, "cuda")
    B, S, S0 = 2, 256, 250
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device="cuda")
    with torch.inference_mode():
        with plain_scan():
            full = forward(params, toks, cfg, attn_impl="plain")["logits"]
        zero_counts()
        st = make_prefill_fn(cfg, cache_len=S)(params, toks[:, :S0])
        per_prefill = counts()
        zero_counts()
        decode = make_decode_fn(cfg)
        cache, logits = st["cache"], [st["logits_last"]]
        for i in range(S - S0):
            out = decode(params, cache, toks[:, S0 + i:S0 + i + 1], S0 + i)
            logits.append(out["logits"])
            cache = out["cache"]
        in_decode = counts()
        errs = [(full[:, S0 - 1 + i] - lg).abs().max().item()
                for i, lg in enumerate(logits)]
    del params, full, cache, st
    torch.cuda.empty_cache()
    none = {k["name"]: 0 for k in KERNELS}
    if per_prefill != {**none, **want} or in_decode != none:
        raise AssertionError(f"f32 {n_layers}-layer launches: prefill {per_prefill}, "
                             f"decode {in_decode}, expected prefill {want}")
    if not max(errs) < 2e-3:
        raise AssertionError(f"f32 prefill/decode vs teacher forcing: {errs}")
    return {"max_abs_err": max(errs), "tolerance": 2e-3, "steps": len(errs),
            "layers": n_layers, "launches_per_prefill": want}


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


def serve_cell(cfg, seed, want_prefill, decode_bytes):
    """Engine.generate at full size from seeded weights: batch BATCH, prompt
    PROMPT, NEW greedy tokens after a 2-token warm-up. Launches are counted
    per generate, per prefill (`want_prefill`, the other kernels none) and
    in decode (none); the prefill and the decode steps are timed apart. The
    prefill's bf16 last logits are held against a teacher-forced forward
    through plain attention and the plain scans: both round the mixers'
    outputs, the residual and the logits to bf16 at different points, and
    the scans sum in other orders, so a bf16 rounding flips now and then and
    the layers carry it: 8 ulps of the largest logit. Returns (the phase's
    row, params, the generator)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = init_params(cfg, gen, "cuda")
    n_params = sum(x.numel() for x in leaves(params))
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=gen,
                            device="cuda")
    eng = Engine(cfg, params, max_len=PROMPT + NEW, device="cuda")
    eng.generate(prompts, 2)  # warm-up: kernel load, cuBLAS handles
    sync()
    torch.cuda.reset_peak_memory_stats()

    zero_counts()
    t0 = time.perf_counter()
    tokens = eng.generate(prompts, NEW)
    sync()
    gen_s = time.perf_counter() - t0
    per_generate = counts()
    if tuple(tokens.shape) != (BATCH, NEW) or tokens.dtype != torch.int32 or not (
            0 <= int(tokens.min()) and int(tokens.max()) < cfg.vocab_size):
        raise AssertionError(f"bad tokens {tokens.shape} {tokens.dtype}")

    with torch.inference_mode():
        prefill = make_prefill_fn(cfg, cache_len=PROMPT + NEW)
        decode = make_decode_fn(cfg)
        sync()
        zero_counts()
        t0 = time.perf_counter()
        st = prefill(params, prompts)
        sync()
        prefill_ms = 1e3 * (time.perf_counter() - t0)
        per_prefill = counts()
        zero_counts()
        cache, nxt = st["cache"], st["logits_last"].argmax(-1, keepdim=True)
        t0 = time.perf_counter()
        for i in range(NEW - 1):
            nxt = decode(params, cache, nxt, PROMPT + i)["logits"].argmax(-1, keepdim=True)
        sync()
        decode_ms = 1e3 * (time.perf_counter() - t0) / (NEW - 1)
        in_decode = counts()
        peak = torch.cuda.max_memory_allocated()
        n_bytes = decode_bytes(params, cache)

        got = st["logits_last"].float()
        with plain_scan():
            want = forward(params, prompts, cfg, attn_impl="plain")["logits"][:, -1].float()
        peak_logit = want.abs().max().item()
        err = (got - want).abs().max().item()
        del prefill, decode, want
        tol = 8 * bf16_ulp(peak_logit)
        finite = bool(torch.isfinite(got).all())
        # random weights: the logits must still depend on the prompt (with
        # sinusoidal positions, amplitude 1 against token embeddings of std
        # 0.02, greedy tokens may agree across rows)
        row_spread = (got - got[:1]).abs().max().item()
    del eng, cache, st
    torch.cuda.empty_cache()
    if not row_spread > 0:
        raise AssertionError(f"{cfg.name} last logits do not depend on the prompt")
    none = {k["name"]: 0 for k in KERNELS}
    if per_prefill != {**none, **want_prefill} or in_decode != none \
            or per_generate != per_prefill:
        raise AssertionError(f"{cfg.name} launches: prefill {per_prefill}, decode "
                             f"{in_decode}, generate {per_generate}")
    if not (finite and err <= tol):
        raise AssertionError(f"bf16 prefill logits: max err {err} > {tol} (finite={finite})")
    row = {"arch": cfg.name, "layers": cfg.n_layers, "dtype": "bfloat16",
           "params": n_params, "batch": BATCH, "prompt": PROMPT, "new_tokens": NEW,
           "launches_per_generate": per_generate, "launches_per_prefill": per_prefill,
           "launches_in_decode": in_decode,
           "generate_s": gen_s, "tokens_per_s": BATCH * NEW / gen_s,
           "prefill_ms": prefill_ms, "decode_ms_per_token": decode_ms,
           "decode_bytes": n_bytes, "decode_bound_ms": 1e3 * n_bytes / PEAK_BYTES,
           "max_memory_allocated": peak,
           "bf16_last_logits_max_abs_err": err, "bf16_tolerance": tol,
           "max_abs_logit": peak_logit, "last_logits_row_spread": row_spread,
           "greedy_rows_distinct": len({tuple(r) for r in tokens.tolist()})}
    return row, params, gen


def phase_serve_mamba():
    cfg = get_config(MAMBA_ARCH)
    row, params, _ = serve_cell(cfg, 3, {"ssm_scan": cfg.n_layers}, mamba_decode_bytes)
    del params
    torch.cuda.empty_cache()
    row["widths"] = {"d_model": cfg.d_model, "d_inner": cfg.d_inner,
                     "d_state": cfg.ssm.d_state, "d_conv": cfg.ssm.d_conv,
                     "dt_rank": cfg.dt_rank, "vocab": cfg.vocab_size,
                     "tie_embeddings": cfg.tie_embeddings}
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


def rgemma_decode_bytes(params, cache):
    """What one decode step must move: every weight once (the tied
    embedding table is read whole by the unembedding), the KV caches read,
    and the recurrent state and conv window read and written."""
    recurrent = sum(tensor_bytes(c) for c in cache["groups"] + cache["rem"]
                    if "h" in c)
    return tensor_bytes(params) + tensor_bytes(cache) + recurrent


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
    row["widths"] = {"d_model": cfg.d_model, "lru_width": cfg.lru_width,
                     "conv_width": cfg.rglru.conv_width,
                     "c_exponent": cfg.rglru.c_exponent, "n_heads": cfg.n_heads,
                     "n_kv_heads": cfg.n_kv_heads, "head_dim": cfg.head_dim,
                     "window": cfg.sliding_window, "d_ff": cfg.d_ff,
                     "vocab": cfg.vocab_size, "tie_embeddings": cfg.tie_embeddings}
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
    none = {k["name"]: 0 for k in KERNELS}
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


def train_config(n_layers):
    return get_config(ARCH).replace(n_layers=n_layers, param_dtype=torch.float32,
                                    compute_dtype=torch.float32)


def replica_data(src):
    def data(step):
        b = src.batch(TRAIN_R * TRAIN_PER, step, device="cuda")
        return {k: v.reshape((TRAIN_R, TRAIN_PER) + v.shape[1:]) for k, v in b.items()}
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
            got = [x.cpu() for x in leaves(got)]  # room on the card for the second step
            with plain_exchange():
                want = step(carry, batch, TRAIN_LR)
            identical = all(same_bits(a, b.cpu()) for a, b in zip(got, leaves(want)))
            del want
            row = {"mode": mode, "staleness": stale, "options": options,
                   "kernel_launches": launched, "carry_identical_to_plain": identical}
            if not identical:  # tell a nondeterministic local step from the exchange
                again = step(carry, batch, TRAIN_LR)
                row["kernel_path_repeat_identical"] = all(
                    same_bits(a, b.cpu()) for a, b in zip(got, leaves(again)))
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


def run_train_phase(name, loop_options, why_reduced, on_batch=None, tracer=None,
                    strategy="daso", plan=None, supervise=None, lr=TRAIN_LR):
    """run_training with `strategy` (DASO by default) at llama3.2-1b's
    published widths, 4 layers, f32, R = 4; the counts are set to 0 just
    before and read just after. Returns (result, its row, launch counts, the
    outermost level's base modes, params0). The per-step executor's row has
    the step ms by mode token, the macro executor's its ExecutorStats and
    the ms per step by cycle shape. `on_batch(step)` runs as each step's
    batch is made, before the step's clock starts; `tracer` goes to
    run_training. With a fault `plan` the run goes through
    `resilience.run_with_faults` on the macro executor instead (the strategy
    as run_training builds it, `supervise` its extra keyword arguments), and
    the result is the ResilienceReport."""
    cfg = train_config(TRAIN_LAYERS)
    params0 = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    n_params = sum(x.numel() for x in leaves(params0))
    data = replica_data(SyntheticLM(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ, seed=0))
    if on_batch is not None:
        make_batch = data

        def data(step):
            on_batch(step)
            return make_batch(step)
    loop_cfg = TrainLoopConfig(strategy=strategy, n_steps=TRAIN_STEPS, n_replicas=TRAIN_R,
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
        report = run_with_faults(strat, params0, data, constant_lr(lr), TRAIN_STEPS,
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
    row = {"phase": name, "arch": ARCH, "strategy": strategy,
           "entry": "run_training" if plan is None else "resilience.run_with_faults",
           **loop_options,
           "widths": {"d_model": cfg.d_model, "n_heads": cfg.n_heads,
                      "n_kv_heads": cfg.n_kv_heads, "head_dim": cfg.head_dim,
                      "d_ff": cfg.d_ff, "vocab": cfg.vocab_size,
                      "tie_embeddings": cfg.tie_embeddings},
           "reduced": {"n_layers": [get_config(ARCH).n_layers, TRAIN_LAYERS],
                       "why": why_reduced},
           "dtype": "float32", "params_per_replica": n_params,
           "replicas": TRAIN_R, "local_world": TRAIN_LOCAL_WORLD, "b_max": TRAIN_B_MAX,
           "lr": lr, "optimizer": "sgd(0.9, 1e-4)", "seq_len": TRAIN_SEQ,
           "seqs_per_replica": TRAIN_PER, "steps": TRAIN_STEPS,
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
    return {"flash_attention_fwd": 0, "eq1_merge": n_sync, "bf16_pack": 0,
            "bf16_unpack": 0, "quantize_int8": n_sync + n_blocking,
            "dequantize_int8": n_sync + n_blocking, "ssm_scan": 0, "rglru_scan": 0}


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
    return {"flash_attention_fwd": 0,
            "eq1_merge": sum(m in ("receive", "send_receive") for m in modes),
            "bf16_pack": modes.count("blocking"), "bf16_unpack": 0, "quantize_int8": 0,
            "dequantize_int8": 0, "ssm_scan": 0, "rglru_scan": 0}


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
    launches and losses."""
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
    losses = res.losses
    del res, params0, params_r, opt_r
    torch.cuda.empty_cache()
    return {"launches": launches, "losses": losses}


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
    syncs add to `level_sync_counts()["host"]` (`trace_faults`)."""
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
    del res, params0
    torch.cuda.empty_cache()
    return launches


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
    out = dict.fromkeys((k["name"] for k in KERNELS), 0)
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
# step 14 to 28: all inside the cycling phase (steps 4 to 35)
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


def cpu_rehearsal(strategy, options):
    """The same plan through run_with_faults on the CPU at the launcher's
    --tiny size (2 layers, d_model 128): the membership timeline and the
    simulated clock, which depend on the schedule only."""
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
                          FaultPlan.from_dicts(FAULT_EVENTS), t_compute_s=SIM_T_COMPUTE,
                          exchange_cost_fn=sim_exchange_s)
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

# train_procs: the 3-level train cell at 2 of 16 layers (PROCS_WHY), once in
# one process and once in two (one pod each), both through the process
# launcher; live_kill: a supervised two-process run at --tiny size
PROCS_LAYERS, PROCS_STEPS, PROCS_TIMEOUT = 2, 16, 420
PROCS_ARGS = ["--full", "--layers", str(PROCS_LAYERS), "--dtype", "float32",
              "--topology", TOPO_SPEC, "--steps", str(PROCS_STEPS),
              "--per-node-batch", str(TRAIN_PER), "--seq-len", str(TRAIN_SEQ),
              "--lr", str(TRAIN_LR), "--seed", "0"]
PROCS_WHY = ("memory: two processes share the one card, each holding params0, its 2 "
             "replicas' params and momentum, the in-flight mean and the gathered wire "
             "arena of all 4 replicas; at 4 layers the one-process train cell alone "
             "peaks at 51.7 GB (PERF.md)")
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
    """The train cell at 2 layers over two processes and over one, both
    through `python -m repro_torch.launch.procs`: the losses, the final
    params (process 0's checkpoint; each run's params digest) and every
    replica row of the final carry (the processes' digests of their own
    rows) bit for bit; each process's comm kernel launches those of the
    one-process run, as the modes imply. Prints the peaks per process, the
    gathers (bytes per exchange by dtype, ms per gather, GB/s), ms per step
    by cycle shape beside the oracle's and the launches per process.
    Returns {path: launches}."""
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
    return {f"{name}.p{r['proc']}": r["launches"] for r in reps2}


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


def phase_timing(check_rows, serve_launches, path_launches, arena_parts, model_lines,
                 reports):
    """Times of each kernel, its plain version and the library call (K1 at
    the llama serving shape, K2 to K6 at the training arena; `model_lines`
    holds the lines of K7, K8 and K1 at head_dim 256 from `scan_timing` and
    `rgemma_timing`), and the kernels line. `path_launches` holds each
    training path's launch counts: K2 and K3 report the train_macro phase's
    (the launcher's default executor), K5 and K6 the
    train_macro_int8_overlap phase's, and every comm kernel lists every
    path's."""
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
        "replaces": fa["replaces"], "launches": serve_launches[fa["name"]],
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
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    reports = phase_build()
    rows = phase_check()
    phase_comm_check()
    scan_rows = phase_scan_check()
    rglru_rows = phase_rglru_check()
    serve_launches = phase_serve()
    mamba_launches = phase_serve_mamba()
    scan_line = scan_timing(scan_rows, mamba_launches, reports)
    rgemma_launches = phase_serve_rgemma()
    rgemma_lines = rgemma_timing(rows, rglru_rows, rgemma_launches, reports)
    phase_train_check()
    resume_launches = phase_train_resume()
    int8_per_step = phase_train_int8_overlap()
    int8_macro = phase_train_macro_int8_overlap(int8_per_step)
    trace_launches = phase_train_trace(int8_per_step, int8_macro)
    del int8_per_step["carry"]
    launch_trace_launches = phase_launch_trace()
    topo = phase_train_topo()
    topo_macro_launches = phase_train_macro_topo(topo)
    del topo["carry"]
    topo_int8_launches = phase_train_topo_int8_overlap()
    baselines_launches = phase_train_baselines()
    faults_launches = phase_train_faults()
    launch_faults_launches = phase_launch_faults()
    procs_launches = phase_train_procs("train_procs", [], train_launches)
    procs_launches.update(phase_train_procs(
        "train_procs_int8_overlap", ["--wire-format", "int8", "--overlap", "one_cycle",
                                     "--dispatch", "overlap"], int8_overlap_launches))
    live_kill_launches = phase_live_kill()
    trained = phase_train()
    macro = phase_train_macro(trained)
    empty_launches = phase_train_faults_empty(trained, macro)
    topo_2level_launches = phase_train_topo_2level(trained, macro)
    arena_parts = phase_arena(trained)
    phase_timing(rows, serve_launches, {
        "train": trained["launches"], "train_macro": macro["launches"],
        "train_int8_overlap": int8_per_step["launches"],
        "train_macro_int8_overlap": int8_macro["launches"],
        "train_trace": trace_launches, "launch_trace": launch_trace_launches,
        "train_resume": resume_launches, "train_topo": topo["launches"],
        "train_macro_topo": topo_macro_launches, "train_topo_2level": topo_2level_launches,
        **topo_int8_launches, **baselines_launches, **faults_launches,
        "launch_faults": launch_faults_launches, "train_faults_empty": empty_launches,
        **procs_launches, "live_kill": live_kill_launches},
        arena_parts,
        [scan_line] + rgemma_lines, reports)
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
