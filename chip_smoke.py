#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):

1. build       — compile every CUDA source of the port with nvcc, all at
                 once; print each kernel's registers and spills (ptxas),
                 the window_attention bf16 body's shared memory and
                 blocks an SM at phase 8's head widths, and the
                 als_normal_eq geometry (warps a row, rows a block, mask
                 window) at phase 5's widths;
2. kernels     — ``ell_spmv`` against its plain PyTorch version on the
                 card, at the PageRank path's full-size shapes: every
                 degree bucket of the 2,097,152-vertex Zipf graph at F=1
                 as a launch of its own, then the whole sweep as one
                 launch (``ell_spmv_bucketed``, BSP's phase); each color
                 phase of the chromatic engine's color-major plan as one
                 launch over its (color, width) blocks; shapes that
                 stress the mapping (an empty bucket, widths 3, 667, 1,024 and
                 5,000, an all-masked bucket, masked rows reading inf),
                 each alone and all in one launch; the sweep cut into
                 20 buckets, more than one launch takes (two launches);
                 one ``ell_fold`` shape, F=32, bf16: float32 bitwise,
                 bf16 within 2e-2;
                 with CUDA-event times beside the plain version, one
                 library call (``torch.sparse.mm`` on the same matrix in
                 CSR: a bucket's, or the whole sweep's) and the least
                 time the card could take (the bound);
3. parity      — PageRank on the 2,000-vertex Zipf graph through
                 ``api.run``, on the GPU and on the CPU: ranks, counts and
                 syncs bitwise equal; kernel arm == dense arm on the GPU;
4. main        — PageRank to convergence (eps=1e-4) on the full-size graph
                 through ``api.run``, with the launch counts set to 0 just
                 before and read just after; the fixed point, the top-2
                 and total-rank syncs checked against float64 on the host;
5. als kernels — ``als_normal_eq`` against its plain version, float32
                 bitwise, at the ALS path's full-size shapes (the folds
                 of each color phase, one a (color, width) group of the
                 engine's color-major plan, with their real slots,
                 every degree bucket with x = w, ``als_normal_eq_bucketed``
                 over them all as one launch beside the per-bucket sum,
                 and d = 5 and d = 64 at the widest bucket's shape), timed
                 beside the plain version, one library call
                 (``torch.bmm``) and the bound (d(d+1)/2 + d outputs a
                 real slot, with the d(d+1) count beside it);
6. als parity  — ALS on 2,000 users x 500 movies (d = 20) through
                 ``api.run`` on the GPU and on the CPU: the normal
                 equations bitwise, factors and sync RMSE within 1e-4 /
                 1e-5 (the LU solves are cuSOLVER's and LAPACK's);
7. als main    — ALS at the paper's Netflix width (17,770 movies, d = 20,
                 Netflix's density) over a tenth of its users (48,019),
                 10 alternating sweeps at lam = 0.01, launch counts set
                 to 0 just before and read just after; the sync RMSE, the
                 factors and 1,000 movies' normal equations checked in
                 float64 on the host;
8. attention   — ``window_attention`` against its plain version, within
                 1e-5, at the serving path's full-size shapes (qwen3-4b's
                 32 query and 8 KV heads, dh = 128: decode_32k's 4 x
                 32,768 cache with kv_len ragged and full, long_500k's
                 ring-wrapped 8,192-row window, each with a bf16 and an
                 f32 cache; the reference's signature at [128, 32768,
                 128] and at W = 513; deepseek-coder-33b's 56/8 heads
                 and gemma-7b's 16/16 heads of 256, bf16, batch 1 over a
                 full 8,192-row ring), timed beside the plain version,
                 one library call (``scaled_dot_product_attention`` with
                 ``enable_gqa`` and a boolean mask) and the bound;
9. serve parity — qwen3-4b at full width with 2 layers, float32 parameters,
                 TF32 off: 4 decode steps on the GPU and on the CPU from
                 the same parameters and random cache, logits within
                 1e-4; then 128 teacher-forced decode steps on the GPU
                 from an empty cache against ``prefill``'s last-token
                 logits within the reference's rtol = atol = 3e-2 (its
                 own invariant) and within 1e-4 absolute (float32);
10. serve main — all of qwen3-4b (36 layers, bf16, parameters drawn on the
                 card from a seed) decodes 16 greedy tokens for 4
                 requests at 32,768 context (decode_32k) and for 1
                 request at 524,288 (long_500k, an 8,192-row ring),
                 launch counts set to 0 just before and read just after;
                 ms per step, tokens/s, peak memory, one step's layer
                 breakdown and the device's idle share (a step launches
                 one window_attention kernel a layer by the wrapper's
                 count, the merge inside it, and the profile shows no
                 more); the last step's
                 attention in layers 0 and 35 checked in float64 on the
                 host for sampled (request, head) pairs, and for every
                 request the whole of layers 0 and 35 (the inserted K/V
                 rows and the layer's output) and the logits against a
                 float64 numpy decode on the host; the logits finite;
11. schedulers kernels — ``ell_spmv`` at the window engines' launch
                 shapes against its plain version, float32 bitwise: the
                 ``[32768, W]`` window (``ell_spmv_batched``) of every
                 scope width of the Zipf graph at F = 1 and of the CoEM
                 graph at F = 32, and the CoEM sweep as one launch
                 (F = 32), timed beside the plain version, one
                 ``torch.sparse.mm`` and the bound; the two row gathers
                 of ``SlicedEll`` (flat, per bucket) at window and sweep
                 batches of both graphs, equal and timed;
12. schedulers parity — the 2k Zipf graph under chromatic, BSP,
                 priority (k = 64, and FIFO) and locking (64 pending):
                 CC (and locking under FULL) GPU == CPU bitwise and equal
                 to union-find; PageRank GPU == CPU bitwise under
                 {bucket, batch} x {kernel, dense} for 10 supersteps;
                 CoEM on a
                 2,000-phrase corpus (F = 32): kernel == dense arm and
                 bucket == batch shape bitwise on the GPU, within 1e-6 of
                 the CPU, for 10 supersteps;
13. schedulers main — full size, the ell_spmv count set to 0 just before
                 each run and read just after: CC on the 2,097,152-vertex
                 Zipf graph under chromatic, BSP, priority (k = 32,768)
                 and locking (32,768 pending), each drained and equal to
                 union-find on the host; CoEM on a 2,000,000-phrase x
                 500,000-context, 32-type corpus: chromatic to
                 convergence at eps = 1e-3, priority and locking (window
                 32,768) for 120 supersteps, the last superstep's rows and
                 the entropy sync against float64, accuracy above the
                 seeds' alone, the dense arm bitwise the kernel arm at the
                 window's size (a comparison: its launches are not
                 counted); CoSeg LBP on 16 x 240 x 320 super-pixels,
                 K = 4: locking (32,768 pending, 20 supersteps) from
                 priority 1 everywhere and from priorities drawn from
                 the seed, and chromatic (4 sweeps), the updates of each
                 superstep, the last superstep's unary terms, messages
                 and beliefs against float64, accuracy no worse than the
                 unary terms', the GMM sync against float64; each run's
                 supersteps, updates, ms per superstep, peak memory and
                 one fresh superstep's layers and idle share;
14. split kernels — ``segment_combine`` (B2) against its plain version,
                 bitwise, at the split path's full-size shapes: the
                 owner combine of the Zipf graph split at the default
                 w_cap (64) and at 16, F = 1 and 32; the window chunk
                 combine at ``[32768 * s, F]``; MapReduce ALS's reduce
                 of phase 7's 10,047,239 ratings (``[Ne, 400]`` and
                 ``[Ne, 20]`` into 17,770 and 48,019 segments); stress
                 cases (empty segments, segments of 5,000 and 2^20
                 rows, one longer than a stage at F = 400, sentinel
                 rows, -0.0, F = 7, bf16, spans and arrays off 16
                 bytes, rows across stages, ragged and empty tiles,
                 int32 and int64 offsets; the long ones timed), timed
                 beside the plain version, ``index_add_`` and the
                 bound; B1's split sweep
                 and its windows at W <= w_cap beside phase 11's;
15. split and app parity — the 2k Zipf graph split at w_cap = 8:
                 PageRank GPU == CPU in every engine x {bucket, batch} x
                 {kernel, dense}, CC split == unsplit == union-find, an
                 integer aggregator split == unsplit; Gibbs keys and
                 uniforms GPU == CPU == a numpy threefry, bitwise, and
                 the 4-cycle's exact marginals within 0.05 (128 copies
                 of it, 300 sweeps, samples pooled); BPTF and the
                 MapReduce baselines GPU against CPU;
16. split and apps main path — full size, the launch counts set to 0
                 just before each run and read just after: split
                 PageRank (w_cap 64 and 16) to convergence with phase
                 4's float64 checks; split CC under chromatic and
                 locking, equal to union-find; Gibbs on the CoSeg grid
                 (50 sweeps), the last sweep's keys and uniforms against
                 a numpy threefry bitwise and its spins against float64
                 p where ``|u - p| > 1e-6``; BPTF on phase 7's ratings
                 (T = 64, 10 supersteps), its RMSE gate, time table and
                 1,000 movies' normal equations against float64;
                 MapReduce ALS (10 iterations) against chromatic ALS
                 (movies first) and MapReduce CoEM against phase 13's
                 chromatic CoEM; ms per superstep or iteration, peak
                 memory and one superstep's layers and idle share each;
17. facade and cost model — at full size, the launch counts set to 0
                 just before each run and read just after: (a) the
                 calibration (``repro_torch.profile.calibrate``) on phase
                 4's graph, every bucket width at B = 512, 4,096, 32,768
                 and 262,144, the bucket sweep and the sync slope, its
                 model and trace round-tripping through JSON, each
                 width's fit printed against its points and the sweep
                 against ``predict_launches``; (b) CC under priority and
                 locking and CoEM under priority (window 32,768, 20
                 supersteps) with each arm forced and with
                 ``dispatch="auto"`` under the model, which must equal the
                 arm it chose bitwise; (c) ``api.run(profile=True)`` on
                 CC priority (drained) and CC locking (200 supersteps):
                 one step record a superstep, cold flags, bitwise a plain
                 run; (d) ``trace=True`` and ``until=`` on phase 4's
                 PageRank against the stepped engine and a
                 ``num_supersteps`` run; (e) ``width_policy="measured"``
                 under the model on phase 4's edges, every candidate's
                 predicted sweep beside the measured sweeps, PageRank to
                 convergence on it with phase 4's checks; (f) the
                 sequential oracle on the 2k Zipf graph GPU == CPU ==
                 ``run_sequential``, CC locking under
                 ``consistency="full"`` and ``"vertex"`` == union-find;
18. distributed — eight shards on the card (``LocalMesh``, M = 8), each
                 run's launch counts set to 0 just before and read just
                 after: (a) PageRank on phase 4's graph, partitioned by
                 ``two_phase_partition(seed=0)``, bitwise phase 4's run
                 (ranks, updates, supersteps), with the host times of
                 the partition and ``ShardPlan.build``, the plan's
                 shapes, the exchange bytes a superstep, ms a
                 superstep, peak memory, one superstep's layers and
                 idle share; (c) CC on the same plan under distributed
                 chromatic, equal to union-find, and locking (4,096
                 pending a shard, 256 supersteps), each label a vertex
                 of its component no smaller than union-find's; (b)
                 split PageRank (w_cap 64), 8 supersteps, bitwise the
                 single-shard split engine's; (d) ALS on phase 7's problem through
                 ``api.run(n_shards=8)`` (random partition) against phase
                 7's run, equal counts, factors within 1e-5 (bitwise
                 reported); (e) ``als_mpi`` for 10 iterations against
                 phase 16's MapReduce ALS (rtol = atol = 1e-3), its
                 all-gather bytes and ms an iteration; (f) CoSeg LBP,
                 frame partition, cut-edge exchange, under chromatic (4
                 sweeps) and locking (saturating window, 20
                 supersteps) against the single-shard runs within 1e-4
                 with equal counts; (g) ``ProcessGroupMesh`` over NCCL
                 at world size 1 on the 2k Zipf PageRank, bitwise the
                 ``LocalMesh`` and single-shard runs (and at world size
                 ``device_count`` where there are more cards); B1, B2 and
                 B3 at the shard shapes against their plain versions,
                 timed beside the library call and the bound;
19. fault tolerance — on phase 18's graph, assignment and plan, the
                 launch counts set to 0 just before each run and read
                 just after: (a) PageRank on 8 ``LocalMesh`` shards, 8
                 supersteps, ``checkpoint_every=2``, a checkpoint-write
                 failure at 4, a kill of shard 3 at 5 and a transient
                 fault at 7, bitwise the uninterrupted run (ranks,
                 updates, supersteps, globals) with the restart log and
                 restored supersteps; a checkpointed run without faults
                 for checkpointing's share of a run; (b) CC under
                 distributed locking (4,096 pending a shard, 16
                 supersteps, a kill at 9), labels, counts and ghost
                 traffic bitwise; (c) ``resume_from=`` (a)'s snapshot at
                 4 with no ``partition=``, the plan rebuilt from the
                 stored assignment, bitwise (a); (d) one device: phase
                 4's PageRank with ``checkpoint_every=4`` and a kill at
                 13, bitwise phase 4's run; snapshot write ms and bytes,
                 validate and load ms, the restart's wall time (the
                 exception to the end of the first superstep after the
                 restore), peak device memory before and after it;
20. online serving — CC through ``api.serve`` (locking, 32,768 pending)
                 on phase 4's edges stored with ``slack=4``: (g) the
                 slack storage with no mutation runs bitwise the frozen
                 storage; (e) 4 ``edge_stream`` batches (1,024 edges
                 each, seed 0) inserted and recomputed incrementally,
                 the last labels bitwise a from-scratch build's run to
                 convergence and equal to union-find; (f) a snapshot
                 pinned before batch 1 reads the same after batch 4; ms
                 a batch (insert, recompute, publish), dirty rows and
                 supersteps, a full rebuild's host and device seconds,
                 the slack's extra slots and bytes; (h) 8 shards on a
                 2^17-vertex Zipf graph, two rounds, incremental ==
                 rebuild == union-find;
21. model families — first, at each architecture's reduced config in
                 float32 with TF32 off: 4 decode steps on the GPU against
                 the CPU for all 10 architectures (each step from the same
                 state), logits within 1e-4; teacher-forced decode against
                 ``prefill`` on the GPU for phi3.5-moe, qwen3-moe (capacity
                 factor E / k: no drops), falcon-mamba, jamba, llava (text
                 only) and seamless (decoding against ``mem_kv`` of its
                 encoder), within 3e-2 * (1 + |prefill|); the Mamba block's
                 decode against its chunked scan within 5e-2 (bf16).  Then
                 on the card in bf16, one model at a time: (a) all of
                 falcon-mamba-7b, prefill of 4,096 tokens and decode_32k at
                 batch 128; (b) phi3.5-moe at full width, 8 of 32 layers;
                 (c) one period of jamba-1.5-large (8 layers) at full
                 width with 8 of its 16 experts; (d) llava-next-34b at full
                 width, 8 of 60 layers, prefill of 2,880 patches + 192
                 tokens; (e) all of seamless-m4t-medium, its encoder over
                 8,192 frames of one request, repeated to 32,768 rows,
                 and ``mem_kv`` into the state of all 4; each
                 decodes 16 greedy tokens at decode_32k (batch 4 unless
                 said), window_attention's launches set to 0 just before
                 and read just after (0, 8, 1, 8 and 24 a step), each
                 step's MoE drops counted; ms a step, tokens/s, the step's
                 bytes over the HBM rate, peak memory, one step's layers
                 and idle share; for (b), (c), (e) one more step's first
                 attention, cross-attention, Mamba and MoE layers against
                 float64 on the host, normwise, and the MoE's experts,
                 positions and kept flags against the host's dispatch
                 from the card's router logits, exactly;
22. training   — first, at each architecture's reduced config in float32
                 with TF32 off: the loss and every parameter's gradient
                 on the GPU against the CPU (loss within 1e-5 relative,
                 each gradient normwise within 1e-4), remat on against
                 off on the GPU (the largest difference), and three
                 ``make_train_step`` steps GPU against CPU (losses within
                 1e-5, each parameter's update normwise within 1e-3).
                 Then in bf16 with float32 moments through
                 ``trainer.train``: (b) qwen3-4b at full width, 4 of 36
                 layers, batch 2 x 4,096 (the flash path), 8 steps with a
                 checkpoint; (c) phi3.5-moe at 2 of 32 layers and
                 falcon-mamba-7b at 2 of 64, 1 x 4,096, 4 steps, MoE
                 drops counted: ms a step (the median of steps 2 on),
                 tokens/s, peak memory, one step split by CUDA events
                 into forward, loss, backward and optimizer, one step's
                 idle share under the profiler, the losses, gradient
                 norms and lrs, the model FLOPs (6 N T + 12 L S^2 H dh
                 B) and their share of the dense bf16 peak; every loss
                 and norm finite and the last loss below the first.
                 Then (b)'s checkpoint (the reference's keys and
                 shapes) restored into a fresh model: 192 tokens
                 teacher-forced through decode at decode_32k against
                 ``prefill`` within 3e-2 * (1 + |prefill|), and 16
                 greedy tokens, window_attention's launches set to 0
                 just before and read just after (4 a step);
23. tooling    — (a) phase 22's (b) and (c) training steps, phase 10's
                 decode_32k step and phase 21's (a)-(e) decode steps, each
                 dry-run on meta at the one-card mesh
                 (``launch.dryrun.dry_run``), then run on the card: its
                 peak (arguments + ``max_memory_allocated`` above them)
                 within 10 % of the dry run's, the op walker's FLOPs of the
                 real step equal to the dry run's, the bytes beside them,
                 the roofline's t_compute and t_memory beside the measured
                 ms; (b) ``launch.graph_dryrun`` (16,384 vertices, 256
                 shards of a ``LocalMesh``, 2 of its default 4 supersteps),
                 ell_spmv's launches set to 0 just before and read just
                 after, against the same supersteps on one shard: ranks
                 and updates bitwise, total_rank within 1e-6 (the sync
                 merges 256 partial sums in shard order), host set-up
                 seconds and ms a superstep; (c) B4 over 16 row shards of
                 qwen3-4b's decode_32k cache, each shard's partial from
                 B4's partial entry, merged (``merge_partials``), against
                 B4 whole and the plain version within B4's 1e-5, its 16
                 launches counted and timed beside the whole launch; (d)
                 one qwen3-4b decode_32k step as DTensors on a (1, 1)
                 mesh over the card: logits bitwise the plain step's, 36
                 launches, no collective recorded by the op walker;
24. report     — a ``{"kernels": [...]}`` line, then the contract line
                 ``{"ok": true, "device": {...}}`` last.

Needs one CUDA GPU and the repository's ``src/`` beside this file.
"""
import json
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path
from typing import NamedTuple

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3, NVIDIA data sheet
H100_BF16_FLOPS = 989e12       # H100 SXM dense bf16 tensor cores, data sheet
F32_FLOPS = 67e12              # H100 SXM float32 outside the tensor cores
FULL_N = 2 ** 21
EPS = 1e-4
L2_FLUSH_BYTES = 128 << 20     # > the 50 MB L2: launches are timed cold
# ALS: the paper's Netflix shape (all 17,770 movies, Netflix's density,
# d = 20) over a tenth of its 480,189 users
NETFLIX_USERS, NETFLIX_MOVIES, NETFLIX_RATINGS = 480_189, 17_770, 100_480_507
ALS_USERS = 48_019
ALS_DENSITY = NETFLIX_RATINGS / (NETFLIX_USERS * NETFLIX_MOVIES)
ALS_D, ALS_NOISE, ALS_SUPERSTEPS = 20, 0.1, 10
# ridge lam * n_obs: synthetic_netflix draws factors with variance 1/d a
# component, and the alternating sweeps then shrink the factors' scale s
# to s^2 = 1 - lam * d; lam = 0.05 at d = 20 is the collapse point (the
# factors go to 0 and the RMSE stays at the zero predictor's), 0.01
# keeps s^2 = 0.8
ALS_LAM = 0.01
ALS_CHECKED_MOVIES = 1000
# a movie's float32 factor against the float64 solve of its normal
# equations: A and b sum ~565 products in order (relative rounding
# ~sqrt(565) * 6e-8 = 1.4e-6 typical), A is well conditioned (the ridge
# and d << ratings; its condition number is printed), and the float32 LU
# adds ~d * 6e-8; 1e-4 leaves an order of magnitude above that
ALS_FACTOR_RTOL = 1e-4
# serving: qwen3-4b's attention shapes (32 query heads, 8 KV heads,
# dh = 128) and the two decode input shapes, cut to one card's batch
SERVE_ARCH = "qwen3-4b"
SERVE_CASES = (("decode_32k", 4, 32_768), ("long_500k", 1, 524_288))
SERVE_TOKENS = 16
REF_SIG_BATCH = 128            # the reference signature's [BH, W, dh]
# phase 8's other widths: deepseek-coder-33b's 56/8 heads (a group of 7)
# and gemma-7b's 16/16 heads of 256, batch 1 over a full 8,192-row ring
WIDE_ARCHS = ("deepseek-coder-33b", "gemma-7b")
WIDE_RING = 8192
# the kernel against its plain version: both float32, summed in other
# orders (the kernel's online softmax over splits)
ATTN_TOL = 1e-5
# the last step's attention against float64 on the host: float32 sums
# of up to 32,768 products of values of size ~1
ATTN_HOST_TOL = 5e-5
# teacher-forced decode against prefill in float32 with TF32 off: the two
# sum the same products in other orders, ~1e-5 apart at full width; 1e-4
# beside the reference's bf16 limit 3e-2 * (1 + |prefill|)
DECODE_F32_TOL = 1e-4
# a bf16 decode layer and the logits on the card against float64 on the
# host, normwise (|gpu - host| / |host| over a request's vector): bf16
# stores each intermediate (the norms' outputs, q/k/v, the attention
# output, the MLP's product, each residual sum) to 2^-9 relative, and
# float32 rope angles at positions up to 2^19 carry the powf rounding of
# the frequencies; a few of those 4e-3 roundings add up well under 2e-2
LAYER_HOST_TOL = 2e-2
# phases 11-13: the window of the priority and locking engines, chosen so
# that dispatch="auto" resolves to the window launch on the Zipf graph
# (32,768 x 256 = 8.4M slots < its 12.5M sliced slots)
WINDOW = 32_768
# CoEM: the paper's NER shape (§5.3) cut to a smoke run's time
NER_PHRASES, NER_CONTEXTS, NER_TYPES = 2_000_000, 500_000, 32
COEM_EPS = 1e-3
COEM_SWEEPS = 100              # chromatic's limit; it must converge first
# priority / locking: a fixed budget; a window of 32,768 needs 77
# supersteps to reach every vertex once (phrases first: lower ids)
COEM_WINDOW_STEPS = 120
COEM_DENSE_STEPS = 3           # the dense arm at the window's size
CHECKED_ROWS = 16_384          # of each phase of the last superstep
# a row of the last superstep against float64: a float32 mix of ~6-50
# products and two divisions, values in [0, 1]
COEM_HOST_TOL = 1e-5
# CoSeg LBP (paper §5.2): 16 frames of 240 x 320 super-pixels
COSEG_SHAPE = (16, 240, 320)
COSEG_LABELS, COSEG_FEAT, COSEG_NOISE = 4, 3, 0.55
COSEG_BETA, COSEG_GAMMA, COSEG_EPS = 0.6, 2.0, 5e-3
COSEG_LOCKING_STEPS, COSEG_SWEEPS = 20, 4
# the GMM sync (float32 halving-tree sums of 1.2M soft counts) against
# float64 on the host
GMM_HOST_TOL = 1e-4
# a row of the last superstep against float64, relative to the size of
# the inputs each value was computed from (at least 1): unary terms and
# beliefs reach ~150, where a float32 ulp is 1.5e-5, and a message is a
# difference of logsumexps of cavities of that size
LBP_HOST_TOL = 1e-5
PARITY_STEPS = 10              # phase 12's PageRank and CoEM budget
CC_MAX_SUPERSTEPS = 4000       # CC runs until drained, within this


def cuda_device(torch):
    return torch.device("cuda", torch.cuda.current_device())


def log(msg=""):
    print(msg, flush=True)


def _event_ms(torch, fn, reps, flush, sleep_cycles):
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        if sleep_cycles:
            torch.cuda._sleep(sleep_cycles)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def time_cuda(torch, fn, reps, flush):
    """``(device_ms, call_ms)`` of ``fn``: CUDA-event times, each launch
    after an L2 flush (so it starts cold, as a bucket launch does in a
    superstep), averaged over ``reps`` after two untimed calls.
    ``call_ms`` includes the host's time to enqueue the call (the
    wrapper's checks and the launch); for ``device_ms`` the stream first
    spins long enough for the host to enqueue the whole call, so the
    events bracket only the device's execution."""
    fn()
    fn()
    torch.cuda.synchronize()
    call = _event_ms(torch, fn, reps, flush, 0)
    # ~2 GHz: spin for twice the host-inclusive time, at least 0.1 ms
    device = _event_ms(torch, fn, reps, flush,
                       int(4e6 * max(call, 0.1)))
    return device, call


def touched_rows(torch, nbrs, real=None):
    """Distinct rows of x that the real slots of ``nbrs`` read: the
    part of x this call's data needs."""
    return int(torch.unique(nbrs if real is None else nbrs[real]).numel())


def bound_ms(nv, slots, rows, feat, elt, mask_bytes):
    """Least time for one ell_spmv launch over ``nv`` rows of ``slots``
    slots in all: the larger of the bytes it must move (nbrs, w, the
    ``rows`` rows of x it reads and the row mask read once, y written
    once) over the HBM rate and its flops (one mul for the mask gate,
    one mul and one add per slot and feature) over the float32 rate."""
    nbytes = (slots * (4 + elt) + rows * feat * elt + mask_bytes
              + nv * feat * elt)
    flops = slots * (1 + 2 * feat)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def gathered_bound_ms(nv, width, feat):
    """The bound counting every gathered row of x as read from HBM:
    (Nv*W*(4+4) + Nv*W*4*F + Nv*F*4) / 3.35 TB/s."""
    return 1e3 * (nv * width * 8 + nv * width * 4 * feat
                  + nv * feat * 4) / HBM_BYTES_PER_S


def csr_of(torch, blocks, n_cols):
    """The matrix of ``blocks`` (``(nbrs, w, real, row_mask)`` each, their
    rows one after another) in CSR, real slots only, columns sorted: the
    input of the library yardstick."""
    rows, cols, vals, counts, base = [], [], [], [], 0
    for nbrs, w, real, row_mask in blocks:
        nv, width = nbrs.shape
        r = torch.arange(nv, device=nbrs.device)[:, None].expand(nv, width)
        rows.append(base + r[real])
        cols.append(nbrs[real].long())
        vals.append((w * row_mask.to(w.dtype)[:, None])[real])
        counts.append(real.sum(dim=1))
        base += nv
    rows, cols, vals, counts = (torch.cat(t) for t in (rows, cols, vals,
                                                        counts))
    order = torch.argsort(rows * n_cols + cols)
    crow = torch.zeros(base + 1, dtype=torch.int64, device=cols.device)
    crow[1:] = torch.cumsum(counts, 0)
    return torch.sparse_csr_tensor(crow, cols[order], vals[order],
                                   size=(base, n_cols))


def bits_differ(torch, a, b):
    """Elements of two float tensors whose bits differ, a NaN against a
    NaN counting as equal (the payload is the card's)."""
    view = torch.int32 if a.dtype == torch.float32 else torch.int16
    return int(((a.view(view) != b.view(view))
                & ~(torch.isnan(a) & torch.isnan(b))).sum())


def stress_buckets(torch, gen, dev, n_src):
    """``(label, nbrs, w, row_mask)`` buckets that stress the kernel's
    mapping over an x of ``n_src + 1`` rows whose last row is inf: an
    empty bucket, odd widths, rows wider than the 2,048 slots a block
    gathers in one pass (taken in chunks), an all-masked bucket, and
    masked rows that read the inf row through out-of-range indices."""
    def bucket(nv, width, p_on):
        nbrs = torch.randint(-3, n_src, (nv, width), generator=gen,
                             device=dev, dtype=torch.int32)
        w = (torch.rand((nv, width), generator=gen, device=dev)
             * (torch.rand((nv, width), generator=gen, device=dev) < 0.7))
        mask = torch.rand(nv, generator=gen, device=dev) < p_on
        return nbrs, w, mask
    out = [(f"{label} [{nv}, {width}]", *bucket(nv, width, p_on))
           for label, nv, width, p_on in (
               ("empty", 0, 8, 0.8), ("W=3", 4097, 3, 0.8),
               ("W=667", 300, 667, 0.8), ("W=1024", 200, 1024, 0.8),
               ("W=5000 in chunks", 20, 5000, 0.8),
               ("all masked", 500, 16, 0.0))]
    nbrs, w, mask = bucket(64, 4, 0.8)
    nbrs[:32] = n_src + 5            # clamps to the inf row
    mask[:16] = False
    out.append(("masked rows read inf [64, 4]", nbrs, w, mask))
    return out


def plan_phase_cases(torch, ctx, x, gen, flush):
    """B1 at the chromatic engine's launch shapes: each color phase of
    its color-major plan (``ChromaticEngine(...).plan``) as the main
    path launches it, the phase's (color, width) blocks in one
    ``ell_spmv_bucketed`` call, bitwise the plain version block by
    block, timed beside it with the bound of those blocks."""
    from repro_torch.core.engine_chromatic import ChromaticEngine
    from repro_torch.kernels.ell_spmv import (MAX_BUCKETS, ell_spmv,
                                              ell_spmv_bucketed,
                                              ell_spmv_plain)
    graph = ctx["graph"]
    w_edge = graph.edge_data["w"]
    plan = ChromaticEngine(graph, ctx["update"]).plan
    tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, launches=0, groups=0)
    for c, (ids, _, blocks) in enumerate(plan.phases):
        nbrs = [r.nbrs for r in blocks.rows]
        w = [torch.where(r.nbr_mask, w_edge[r.edge_ids.long()], 0.0)
             .contiguous() for r in blocks.rows]
        masks = [torch.rand(nb.shape[0], generator=gen, device=x.device)
                 < 0.8 for nb in nbrs]
        before = ell_spmv.launches
        y = ell_spmv_bucketed(nbrs, w, x, masks)
        launched = ell_spmv.launches - before
        yp = torch.cat([ell_spmv_plain(*a, x, m)
                        for *a, m in zip(nbrs, w, masks)])
        torch.cuda.synchronize()
        mism = bits_differ(torch, y, yp)
        if mism or launched != -(-len(nbrs) // MAX_BUCKETS):
            raise AssertionError(f"plan phase {c}: {mism} f32 elements "
                                 f"differ, {launched} launches")
        ms, _ = time_cuda(torch, lambda: ell_spmv_bucketed(nbrs, w, x,
                                                           masks), 20, flush)
        plain_ms, _ = time_cuda(torch, lambda: [
            ell_spmv_plain(*a, x, m) for *a, m in zip(nbrs, w, masks)], 3,
            flush)
        nv = ids.shape[0]
        touched = int(torch.unique(torch.cat(
            [r.nbrs[r.nbr_mask] for r in blocks.rows])).numel())
        bms, by = bound_ms(nv, sum(nb.numel() for nb in nbrs), touched, 1,
                           4, nv)
        log(f"plan phase {c:>2} [{nv} rows, widths "
            f"{[nb.shape[1] for nb in nbrs]}]: {launched} launch, "
            f"{ms:.4f} ms, plain {plain_ms:.4f}, bound {bms:.4f} ({by}), "
            f"mismatches 0")
        for k, v in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", bms),
                     ("launches", launched), ("groups", len(nbrs))):
            tot[k] += v
    log(f"a chromatic superstep on the plan ({len(plan.phases)} phases, "
        f"{tot['groups']} groups, {plan.store.padded_slots} slots): "
        f"{tot['launches']} launches, kernel {tot['ms']:.4f} ms, plain "
        f"{tot['plain_ms']:.4f} ms, bound {tot['bound_ms']:.4f} ms")
    ctx["kernel_plan_superstep"] = tot


def phase_kernels(torch, ctx):
    """Kernel vs plain version at the main path's shapes: every bucket as
    a launch of its own, the whole sweep as one launch, shapes that
    stress the mapping, a fold, F = 32 and bf16."""
    from repro_torch.kernels.ell_spmv import (MAX_BUCKETS, ell_fold,
                                              ell_spmv, ell_spmv_bucketed,
                                              ell_spmv_plain)
    dev = ctx["dev"]
    graph = ctx["graph"]
    ell = graph.ell
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    n = graph.n_vertices
    x = torch.rand((n, 1), generator=gen, device=dev) + 0.5
    w_edge = graph.edge_data["w"]
    rows_out, errs, blocks, plains = [], [], [], []
    tot = dict(ms=0.0, call_ms=0.0, plain_ms=0.0, library_ms=0.0)
    log("times: device ms (call ms with the host's enqueue), L2 flushed")
    log(f"{'bucket':>6} {'Nv_b':>9} {'W_b':>4} {'ms':>9} {'call':>8} "
        f"{'plain_ms':>9} {'lib_ms':>9} {'lib_call':>8} {'bound_ms':>9} "
        f"{'gath_bound':>10} {'mismatch':>8}")
    for b, (width, nv) in enumerate(ell.bucket_launches):
        nbrs = ell.nbrs[b]
        real = ell.nbr_mask[b]
        w = torch.where(real, w_edge[ell.edge_ids[b].long()], 0.0).contiguous()
        mask = torch.rand(nv, generator=gen, device=dev) < 0.8
        args = (nbrs, w, x, mask)
        y = ell_spmv(*args)
        yp = ell_spmv_plain(*args)
        torch.cuda.synchronize()
        mism = bits_differ(torch, y, yp)
        err = float((y - yp).abs().max()) if nv else 0.0
        errs.append(err)
        if mism:
            raise AssertionError(f"bucket {b}: {mism} f32 elements differ "
                                 f"from the plain version (max {err})")
        blocks.append((nbrs, w, real, mask))
        plains.append(yp)
        csr = csr_of(torch, [blocks[-1]], n)
        ylib = torch.sparse.mm(csr, x)
        lib_err = float((ylib - y).abs().max())
        ms, call_ms = time_cuda(torch, lambda: ell_spmv(*args), 20, flush)
        plain_ms, _ = time_cuda(torch, lambda: ell_spmv_plain(*args), 3,
                                flush)
        lib_ms, lib_call = time_cuda(torch, lambda: torch.sparse.mm(csr, x),
                                     20, flush)
        bms, _ = bound_ms(nv, nv * width, touched_rows(torch, nbrs, real),
                          1, 4, nv)
        gms = gathered_bound_ms(nv, width, 1)
        log(f"{b:>6} {nv:>9} {width:>4} {ms:>9.4f} {call_ms:>8.4f} "
            f"{plain_ms:>9.4f} {lib_ms:>9.4f} {lib_call:>8.4f} {bms:>9.4f} "
            f"{gms:>10.4f} {mism:>8}   (library max |diff| {lib_err:.2e})")
        rows_out.append(dict(bucket=b, nv=nv, width=width, ms=ms,
                             call_ms=call_ms, plain_ms=plain_ms,
                             library_ms=lib_ms,
                             bound_ms=bms, gathered_bound_ms=gms,
                             mismatches=mism))
        for k, v in (("ms", ms), ("call_ms", call_ms),
                     ("plain_ms", plain_ms), ("library_ms", lib_ms)):
            tot[k] += v
    log(f"the buckets one launch each (sums): kernel {tot['ms']:.4f} ms "
        f"({tot['call_ms']:.4f} ms with the host), plain "
        f"{tot['plain_ms']:.4f} ms, library {tot['library_ms']:.4f} ms")

    # the whole sweep: one launch, against one library call on its matrix
    nbrs_l, w_l, m_l = ([blk[i] for blk in blocks] for i in (0, 1, 3))
    before = ell_spmv.launches
    ys = ell_spmv_bucketed(nbrs_l, w_l, x, m_l)
    launched = ell_spmv.launches - before
    torch.cuda.synchronize()
    mism = bits_differ(torch, ys, torch.cat(plains))
    if mism or launched != 1:
        raise AssertionError(f"one-launch sweep: {mism} f32 elements differ "
                             f"from the plain version, {launched} launches")
    csr = csr_of(torch, blocks, n)
    lib_err = float((torch.sparse.mm(csr, x) - ys).abs().max())
    ms, call_ms = time_cuda(
        torch, lambda: ell_spmv_bucketed(nbrs_l, w_l, x, m_l), 20, flush)
    plain_ms, _ = time_cuda(
        torch, lambda: [ell_spmv_plain(nb, w, x, m)
                        for nb, w, _, m in blocks], 3, flush)
    lib_ms, lib_call = time_cuda(torch, lambda: torch.sparse.mm(csr, x), 20,
                                 flush)
    nv_all = sum(nb.shape[0] for nb in nbrs_l)
    touched = int(torch.unique(torch.cat(
        [nb[real] for nb, _, real, _ in blocks])).numel())
    bms, by = bound_ms(nv_all, sum(nb.numel() for nb in nbrs_l), touched, 1,
                       4, nv_all)
    log(f"one-launch sweep [{nv_all} rows, {ell.padded_slots} slots, "
        f"{touched} rows of x]: kernel {ms:.4f} ms ({call_ms:.4f} with the "
        f"host), plain {plain_ms:.4f}, library one call {lib_ms:.4f} "
        f"({lib_call:.4f}; max |diff| {lib_err:.2e}), per-bucket library "
        f"sum {tot['library_ms']:.4f}, bound {bms:.4f} ms ({by}; kernel / "
        f"bound {ms / bms:.2f}), mismatches 0, launches 1")
    ctx["kernel_sweep"] = dict(ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                               library_ms=lib_ms, bound_ms=bms, bound_by=by,
                               bucket_library_ms=tot["library_ms"],
                               bucket_ms=tot["ms"])

    # more buckets than one launch takes: the sweep's 8 buckets cut into
    # 20 row ranges, two launches, bitwise the plain version's
    parts = [p for blk, k in zip(blocks, (3, 3, 3, 3, 2, 2, 2, 2))
             for p in zip(*(t.tensor_split(k) for t in (blk[0], blk[1],
                                                         blk[3])))]
    parts = [tuple(t.contiguous() for t in p) for p in parts]
    n_parts = sum(p[0].shape[0] > 0 for p in parts)
    before = ell_spmv.launches
    y20 = ell_spmv_bucketed([p[0] for p in parts], [p[1] for p in parts], x,
                            [p[2] for p in parts])
    launched = ell_spmv.launches - before
    torch.cuda.synchronize()
    mism = bits_differ(torch, y20, torch.cat(plains))
    want = -(-n_parts // MAX_BUCKETS)
    ms20, _ = time_cuda(torch, lambda: ell_spmv_bucketed(
        [p[0] for p in parts], [p[1] for p in parts], x,
        [p[2] for p in parts]), 20, flush)
    log(f"the sweep as {len(parts)} buckets ({n_parts} non-empty): "
        f"{launched} launches (expected {want}), {ms20:.4f} ms, mismatches "
        f"{mism}")
    if mism or launched != want:
        raise AssertionError(f"{len(parts)}-bucket sweep: {mism} f32 "
                             f"elements differ, {launched} launches")
    del csr, ys, plains, y20, parts
    plan_phase_cases(torch, ctx, x, gen, flush)

    # shapes that stress the mapping: each alone, then all in one launch
    n_src = 100_000
    xs = torch.randn((n_src + 1, 1), generator=gen, device=dev)
    xs[n_src] = float("inf")
    cases = stress_buckets(torch, gen, dev, n_src)
    for label, nbrs, w, mask in cases:
        y = ell_spmv(nbrs, w, xs, mask)
        yp = ell_spmv_plain(nbrs, w, xs, mask)
        torch.cuda.synchronize()
        mism = bits_differ(torch, y, yp)
        log(f"stress {label}: mismatches {mism}, NaN rows "
            f"{int(torch.isnan(y).sum())}")
        if mism:
            raise AssertionError(f"stress {label}: {mism} f32 elements differ")
        if label.startswith("masked rows") and not torch.isnan(y[:16]).all():
            raise AssertionError("a masked row that reads inf is not NaN")
    y = ell_spmv_bucketed([c[1] for c in cases], [c[2] for c in cases], xs,
                          [c[3] for c in cases])
    yp = torch.cat([ell_spmv_plain(nb, w, xs, m) for _, nb, w, m in cases])
    torch.cuda.synchronize()
    mism = bits_differ(torch, y, yp)
    log(f"stress buckets in one launch: mismatches {mism}")
    if mism:
        raise AssertionError(f"stress launch: {mism} f32 elements differ")

    # ell_fold at the dense arm's shape for the bucket with most slots
    b = max(range(ell.n_buckets), key=lambda i: ell.bucket_launches[i][0]
            * ell.bucket_launches[i][1])
    width, nv = ell.bucket_launches[b]
    wf = torch.rand((nv, width), generator=gen, device=dev)
    vals = torch.rand((nv, width, 1), generator=gen, device=dev)
    mask = torch.rand(nv, generator=gen, device=dev) < 0.8
    idx = (torch.arange(nv, dtype=torch.int32, device=dev)[:, None] * width
           + torch.arange(width, dtype=torch.int32, device=dev))
    yk = ell_fold(wf, vals, mask)
    yp = ell_spmv_plain(idx, wf, vals.reshape(-1, 1), mask)
    torch.cuda.synchronize()
    mism = bits_differ(torch, yk, yp)
    if mism:
        raise AssertionError(f"ell_fold: {mism} elements differ")
    fold_ms, _ = time_cuda(torch, lambda: ell_fold(wf, vals, mask), 20,
                           flush)
    log(f"ell_fold [{nv}, {width}, 1]: {fold_ms:.4f} ms, mismatches 0, "
        f"bound {bound_ms(nv, nv * width, nv * width, 1, 4, nv)[0]:.4f} ms")

    # wide features, float32 and bfloat16
    for dtype, feat in ((torch.float32, 32), (torch.bfloat16, 1),
                        (torch.bfloat16, 32)):
        nv, width, rows = 1 << 20, 8, 1 << 20
        nbrs = torch.randint(0, rows, (nv, width), generator=gen, device=dev,
                             dtype=torch.int32)
        w = torch.rand((nv, width), generator=gen, device=dev).to(dtype)
        xs = torch.randn((rows, feat), generator=gen, device=dev).to(dtype)
        mask = torch.rand(nv, generator=gen, device=dev) < 0.8
        y = ell_spmv(nbrs, w, xs, mask)
        yp = ell_spmv_plain(nbrs, w, xs, mask)
        torch.cuda.synchronize()
        mism = bits_differ(torch, y, yp)
        err = float((y.float() - yp.float()).abs().max())
        if dtype == torch.float32 and mism:
            raise AssertionError(f"F={feat} f32: {mism} elements differ")
        if dtype == torch.bfloat16:
            torch.testing.assert_close(y.float(), yp.float(), rtol=2e-2,
                                       atol=2e-2)
        ms, _ = time_cuda(torch, lambda: ell_spmv(nbrs, w, xs, mask), 20,
                          flush)
        elt = 2 if dtype == torch.bfloat16 else 4
        bms = bound_ms(nv, nv * width, touched_rows(torch, nbrs), feat, elt,
                       nv)[0]
        log(f"ell_spmv [{nv}, {width}] F={feat} {str(dtype)[6:]}: {ms:.4f} "
            f"ms, bound {bms:.4f} ms, mismatches {mism}, max |diff| "
            f"{err:.2e}")
    ctx["kernel_rows"] = rows_out
    ctx["kernel_max_err"] = max(errs)


def phase_parity(torch, ctx):
    """The 2k Zipf PageRank: GPU == CPU and kernel == dense, bitwise."""
    from repro_torch import api
    from repro_torch.apps import pagerank
    from repro_torch.core.graph import zipf_edges
    from repro_torch.kernels.ell_spmv import ell_spmv
    edges = zipf_edges(2000, alpha=2.0, max_deg=64, seed=1)
    g, upd, syncs = pagerank.build(edges, 2000, eps=EPS, device="cpu")
    cpu = api.run(g, upd, syncs=syncs, device="cpu")
    before = ell_spmv.launches
    gpu = api.run(g, upd, syncs=syncs, device=ctx["dev"])
    launched = ell_spmv.launches - before
    dense = api.run(g, upd, syncs=syncs, device=ctx["dev"], use_kernel=False)

    def same(a, b):
        ra, rb = a.vertex_data["rank"].cpu(), b.vertex_data["rank"].cpu()
        glob = all(torch.equal(x.cpu(), y.cpu())
                   for k in a.globals
                   for x, y in zip(*(v if isinstance(v, tuple) else (v,)
                                     for v in (a.globals[k], b.globals[k]))))
        return (torch.equal(ra, rb) and glob and
                (a.superstep, a.n_updates) == (b.superstep, b.n_updates))

    log(f"2k Zipf: cpu {cpu.superstep} supersteps / {cpu.n_updates} updates,"
        f" gpu {gpu.superstep} / {gpu.n_updates}, dense {dense.superstep} /"
        f" {dense.n_updates}; kernel launches {launched}")
    if not same(gpu, cpu):
        diff = int((gpu.vertex_data["rank"].cpu()
                    != cpu.vertex_data["rank"]).sum())
        raise AssertionError(f"GPU run != CPU run ({diff} ranks differ)")
    if not same(gpu, dense):
        raise AssertionError("kernel arm != dense arm on the GPU")
    if launched <= 0:
        raise AssertionError("the kernel arm never launched ell_spmv")
    log("2k Zipf: GPU == CPU bitwise, kernel == dense bitwise")


def pagerank_layers():
    """``(owner, attribute, label)`` of each layer PageRank's superstep
    is split into."""
    import repro_torch.core.exec as ex
    from repro_torch.core.graph import SlicedEll
    names = ["gather_scopes", "route_batch_to_buckets", "ell_spmv_bucketed",
             "_owner_rows", "scatter_result", "consume_and_reschedule",
             "refresh_syncs"]
    return ([(ex, k, k) for k in names]
            + [(SlicedEll, "row_activation", "row_activation")])


def layer_breakdown(torch, layers, run, prepare=lambda: None,
                    other="other (update body, select, host)"):
    """Seconds per layer of one ``run(prepare())``, each layer (an
    ``(owner, attribute, label)`` triple) bracketed by synchronizes (so
    layers do not overlap; the sum is a little more than an unbracketed
    run).  A layer called inside another is counted in the outer one;
    layers may share a label.  ``prepare`` runs outside the timing."""
    acc, depth = {}, [0]

    def timed(label, fn):
        def inner(*a, **k):
            if depth[0]:           # inside another layer: counted there
                return fn(*a, **k)
            depth[0] += 1
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*a, **k)
                torch.cuda.synchronize()
                acc[label] = acc.get(label, 0.0) + time.perf_counter() - t0
            finally:
                depth[0] -= 1
            return out
        return inner

    saved = [(owner, attr, getattr(owner, attr)) for owner, attr, _ in layers]
    try:
        for (owner, attr, label), (_, _, fn) in zip(layers, saved):
            setattr(owner, attr, timed(label, fn))
        arg = prepare()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(arg)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)
    acc[other] = total - sum(acc.values())
    return total, acc


def device_busy(torch, run, prepare=lambda: None):
    """Wall time, summed device time (None where the profiler shows no
    device time), every kernel as ``(device us, name, launches)`` from the
    costliest down, and the number of kernels launched, of one
    ``run(prepare())`` under torch.profiler.  The device events are read
    from the profiler's raw results: ``key_averages()`` first builds an
    event tree of every host op, which took up to 25 s for one step of
    36,000 kernels."""
    from torch.profiler import ProfilerActivity, profile
    arg = prepare()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(arg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side events only (kernels, copies, fills); an operator's
    # host event would repeat its kernels' time
    cuda = torch.autograd.DeviceType.CUDA
    acc = {}
    for e in prof.profiler.kineto_results.events():
        if (e.device_type() != cuda or e.is_user_annotation()
                or getattr(e, "is_hidden_event", lambda: False)()):
            continue
        t, n = acc.get(e.name(), (0.0, 0))
        acc[e.name()] = (t + e.duration_ns() / 1e3, n + 1)
    per = sorted(((t, name, n) for name, (t, n) in acc.items()),
                 reverse=True)
    busy_us = sum(t for t, _, _ in per)
    n_kernels = sum(n for _, _, n in per)
    return (wall, (busy_us * 1e-6 if busy_us > 0 else None), per,
            n_kernels)


def phase_main(torch, ctx):
    """The full-size PageRank through api.run, counted and checked."""
    import numpy as np

    from repro_torch import api
    from repro_torch.kernels.ell_spmv import ell_spmv
    g, upd, syncs = ctx["graph"], ctx["update"], ctx["syncs"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ell_spmv.launches = 0
    t0 = time.perf_counter()
    res = api.run(g, upd, syncs=syncs, device=ctx["dev"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ell_spmv.launches
    peak = torch.cuda.max_memory_allocated()
    ctx.setdefault("launches", {})["ell_spmv"] = launches
    log(f"full size: converged={not res.active_any} in {res.superstep} "
        f"supersteps, {res.n_updates} updates, {wall:.3f} s "
        f"({1e3 * wall / max(res.superstep, 1):.2f} ms/superstep), "
        f"ell_spmv launches {launches} "
        f"({launches / max(res.superstep, 1):.0f}/superstep), "
        f"peak device memory {peak / 2**30:.2f} GiB")
    if launches <= 0:
        raise AssertionError("the main path never launched ell_spmv")
    check_pagerank(np, res, ctx["edges"], "full size")
    ctx["pr_single"] = single_run(res, "rank")
    ctx["pr_graph_host"] = g.to("cpu")   # phase 18 shards it again

    top = report_superstep(torch, res.engine, pagerank_layers())
    spmv = [(t, c) for t, name, c in top if "ell_spmv" in name]
    if top:
        log(f"ell_spmv in the profiled superstep: "
            f"{sum(t for t, _ in spmv) / 1e3:.3f} ms device time, "
            f"{sum(c for _, c in spmv)} launches")


def single_run(res, key):
    """A run's ``key`` data on the host and its counts, kept for phase
    18's comparison of the distributed engines with it."""
    return dict(data=res.vertex_data[key].cpu(), n_updates=res.n_updates,
                superstep=res.superstep)


def check_pagerank(np, res, edges, label):
    """A converged PageRank run against float64 on the host: the fixed
    point's residual, the top-2 sync against the host's second-largest
    rank, the total-rank sync against the float64 sum."""
    from repro_torch.apps import pagerank
    if res.active_any:
        raise AssertionError(f"{label}: PageRank did not converge within "
                             "100 supersteps")
    r = res.vertex_data["rank"].cpu().numpy().astype(np.float64)
    n = len(r)
    wr = pagerank.sparse_matvec(edges, n, r)
    resid = float(np.abs(r - (pagerank.ALPHA
                              + (1 - pagerank.ALPHA) * wr)).max())
    top2 = float(res.globals["top2"][0])
    second = float(np.partition(r, -2)[-2])
    total = float(res.globals["total_rank"])
    rel = abs(total - r.sum()) / r.sum()
    log(f"{label}: fixed-point residual {resid:.3e} (limit {100 * EPS:.0e})"
        f", top2 {top2} vs host {second}, total_rank {total} vs float64 "
        f"{r.sum():.6f} (rel {rel:.2e})")
    if not np.isfinite(r).all() or r.ndim != 1:
        raise AssertionError("ranks are not finite or have the wrong shape")
    if resid >= 100 * EPS:
        raise AssertionError(f"fixed-point residual {resid} >= {100 * EPS}")
    if top2 != second:
        raise AssertionError(f"top2 sync {top2} != host {second}")
    if rel >= 1e-4:
        raise AssertionError(f"total_rank off by {rel} relative")


def report_superstep(torch, engine, layers, priority=None):
    """Log one fresh superstep's layer breakdown (from the task set
    seeded at ``priority``) and, under torch.profiler, the device's idle
    share; return the profile's kernels (``report_run``)."""
    return report_run(torch, "superstep", layers, engine._superstep,
                      lambda: engine.init_state(priority=priority))


def report_run(torch, what, layers, run, prepare=lambda: None, **kw):
    """Log the layer breakdown of one ``run(prepare())`` and, under
    torch.profiler, the device's idle share; return the profile's
    kernels (``device_busy``), empty where it shows no device time."""
    total_s, acc = layer_breakdown(torch, layers, run, prepare, **kw)
    log(f"one fresh {what}, layers bracketed by synchronize: "
        f"{1e3 * total_s:.2f} ms")
    for k, v in sorted(acc.items(), key=lambda kv: -kv[1]):
        log(f"  {k:<34} {1e3 * v:9.2f} ms  {100 * v / total_s:5.1f}%")
    try:
        wall_s, busy_s, top, n_kernels = device_busy(torch, run, prepare)
    except Exception:            # the profiler is optional here
        traceback.print_exc()
        wall_s, busy_s, top, n_kernels = None, None, [], 0
    if busy_s is None:
        log("device idle share: not measured (no device time in the trace)")
        return []
    log(f"one fresh {what} under torch.profiler: wall "
        f"{1e3 * wall_s:.2f} ms, device busy {1e3 * busy_s:.2f} ms, "
        f"idle share {max(0.0, 1 - busy_s / wall_s):.3f}, {n_kernels} "
        f"device kernels")
    for t, name, _ in top[:10]:
        log(f"  {t / 1e3:9.2f} ms  {name[:70]}")
    return top


def als_bound(nv, slots, real, rows, d, fold=False, full=False):
    """Least time for one als_normal_eq call over ``nv`` rows of
    ``slots`` slots in all: the larger of the bytes it
    must move (the mask byte of every slot, the rating and, unless the
    call is a fold, which reads its scope without an index, the index of
    every real slot, the ``rows`` distinct rows of x its real slots
    read, A and b written once) over the HBM rate and its flops (a
    multiply and an add for each output the function needs from every
    real slot: A is symmetric, so d(d+1)/2 of A and d of b; ``full``
    counts all d(d+1), as if A were not symmetric) over the float32 rate."""
    nbytes = (slots + real * (4 if fold else 8) + rows * d * 4
              + nv * d * (d + 1) * 4)
    outputs = d * (d + 1) if full else d * (d + 1) // 2 + d
    flops = real * 2 * outputs
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def plan_scopes(torch, graph, plan, color):
    """The dense scopes one chromatic phase of ALS gathers on the
    engine's color-major plan (``plan``, a ``ChromaticEngine``'s): one a
    (color, stored width) group, each ``[n_g, W_g]``."""
    from repro_torch.core.update import gather_scopes
    ids, _, blocks = plan.phases[color]
    return [gather_scopes(graph, graph.vertex_data, graph.edge_data,
                          ids[a:b], {}, rows=rows)
            for a, b, rows in zip(blocks.offsets, blocks.offsets[1:],
                                  blocks.rows)]


def als_plan(graph):
    """The color-major plan ALS's chromatic engine runs ``graph`` on."""
    from repro_torch.apps import als
    from repro_torch.core.engine_chromatic import ChromaticEngine
    d = graph.vertex_data["w"].shape[1]
    return ChromaticEngine(graph, als.make_update(d)).plan


def als_case(torch, label, nbrs, mask, r, x, flush):
    """``als_normal_eq`` at one shape against its plain version (float32
    bitwise), timed beside the plain version, the library call and the
    bound.  With ``nbrs=None``, ``x`` is the gathered scope ``[B*D, d]``
    and the kernel runs through ``als_normal_eq_fold``, as the ALS update
    calls it, reading the scope without an index."""
    from repro_torch.kernels.als_normal_eq import (als_normal_eq,
                                                   als_normal_eq_fold,
                                                   als_normal_eq_plain)
    nv, width = mask.shape
    d = x.shape[1]
    fold = nbrs is None
    if fold:
        X = x.view(nv, width, d)
        kern = lambda: als_normal_eq_fold(mask, r, X)
    else:
        kern = lambda: als_normal_eq(nbrs, mask, r, x)
    plain = lambda: als_normal_eq_plain(nbrs, mask, r, x)
    a, b = kern()
    ap, bp = plain()
    torch.cuda.synchronize()
    mism = int((a != ap).sum()) + int((b != bp).sum())
    err = max(float((a - ap).abs().max()), float((b - bp).abs().max()))
    if mism:
        raise AssertionError(f"als_normal_eq {label}: {mism} elements "
                             f"differ from the plain version (max {err})")
    # the library yardstick: two batched products of the gathered,
    # masked rows (formed outside the timing), which the port never calls
    xm = (X if fold else x[nbrs.long()]) * mask[..., None]
    rm = (r * mask)[..., None]
    xt = xm.transpose(1, 2)
    lib = lambda: (torch.bmm(xt, xm), torch.bmm(xt, rm))
    la, lb = lib()
    lib_err = max(float((la - a).abs().max()), float((lb[..., 0] - b).abs()
                                                     .max()))
    del la, lb
    ms, call_ms = time_cuda(torch, kern, 10, flush)
    plain_ms, _ = time_cuda(torch, plain, 1, flush)
    lib_ms, _ = time_cuda(torch, lib, 10, flush)
    del xm, rm, xt
    real = int(mask.sum())
    empty = int((~mask.any(dim=1)).sum())
    # a fold reads each real slot's own row of the scope
    rows = real if fold else touched_rows(torch, nbrs, mask)
    bms, by = als_bound(nv, nv * width, real, rows, d, fold)
    full_ms, full_by = als_bound(nv, nv * width, real, rows, d, fold,
                                 full=True)
    log(f"{label:<22} [{nv:>6}, {width:>4}] d={d:<3} real {real:>9}, empty "
        f"rows {empty:>6}: {ms:9.4f} ms ({call_ms:.4f} with the host), "
        f"plain {plain_ms:9.4f}, library {lib_ms:8.4f} (max |diff| "
        f"{lib_err:.1e}), bound {bms:.4f} ({by}; kernel / bound "
        f"{ms / bms:.2f}; counting d(d+1) outputs {full_ms:.4f}, "
        f"{full_by}), mismatches {mism}")
    return dict(label=label, nv=nv, width=width, d=d, real=real, empty=empty,
                ms=ms, call_ms=call_ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bms, bound_by=by, full_bound_ms=full_ms,
                max_abs_err=err)


def phase_als_kernels(torch, ctx):
    """als_normal_eq vs plain version at the ALS path's shapes."""
    from repro_torch.kernels.als_normal_eq import (MAX_BUCKETS,
                                                   als_normal_eq,
                                                   als_normal_eq_bucketed,
                                                   als_normal_eq_plain)
    prob = ctx["als_problem"]
    graph, ell, d = prob.graph, prob.graph.ell, prob.d
    dev = ctx["dev"]
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    log("times: device ms (call ms with the host's enqueue), L2 flushed")
    folds = []
    plan = als_plan(graph)
    for c in range(graph.n_colors):
        for scope in plan_scopes(torch, graph, plan, c):
            X = scope.nbr_data["w"]
            mask, r = scope.nbr_mask, scope.edge_data["rating"]
            nv, width = mask.shape
            folds.append(als_case(torch, f"fold, color {c} W={width}", None,
                                  mask, r, X.reshape(nv * width, d), flush))
            del scope, X, mask, r
    del plan
    ratings = graph.edge_data["rating"]
    r_blocks = [ratings[e.long()].contiguous() for e in ell.edge_ids]
    w = graph.vertex_data["w"]
    buckets = [als_case(torch, f"bucket {b} (x = w)", ell.nbrs[b],
                        ell.nbr_mask[b], r_blocks[b], w, flush)
               for b in range(ell.n_buckets)]
    # the bucketed entry point: every bucket in one launch
    before = als_normal_eq.launches
    got = als_normal_eq_bucketed(ell.nbrs, ell.nbr_mask, r_blocks, w)
    launched = als_normal_eq.launches - before
    plain = [als_normal_eq_plain(*blk, w)
             for blk in zip(ell.nbrs, ell.nbr_mask, r_blocks)]
    for g, p in zip(got, map(torch.cat, zip(*plain))):
        if not torch.equal(g, p):
            raise AssertionError("als_normal_eq_bucketed differs from the "
                                 "plain version")
    n_full = sum(nb.shape[0] > 0 for nb in ell.nbrs)
    if launched != -(-n_full // MAX_BUCKETS):
        raise AssertionError(f"als_normal_eq_bucketed made {launched} "
                             f"launches for {n_full} buckets")
    del got, plain
    one_ms, one_call = time_cuda(torch, lambda: als_normal_eq_bucketed(
        ell.nbrs, ell.nbr_mask, r_blocks, w), 10, flush)
    nv_all = sum(nb.shape[0] for nb in ell.nbrs)
    real = int(sum(int(m.sum()) for m in ell.nbr_mask))
    rows = int(torch.unique(torch.cat(
        [nb[m] for nb, m in zip(ell.nbrs, ell.nbr_mask)])).numel())
    one_bound, one_by = als_bound(nv_all, ell.padded_slots, real, rows, d)
    log(f"als_normal_eq_bucketed over all {ell.n_buckets} buckets "
        f"({nv_all} rows, {real} real slots): {launched} launch, bitwise "
        f"equal to the plain version; {one_ms:.4f} ms ({one_call:.4f} with "
        f"the host), bound {one_bound:.4f} ({one_by})")
    log(f"the same buckets one launch each (sums): kernel "
        f"{sum(c['ms'] for c in buckets):.4f} ms, plain "
        f"{sum(c['plain_ms'] for c in buckets):.4f} ms, library "
        f"{sum(c['library_ms'] for c in buckets):.4f} ms, bound "
        f"{sum(c['bound_ms'] for c in buckets):.4f} ms")
    b = max(range(ell.n_buckets), key=lambda i: ell.bucket_launches[i][0]
            * ell.bucket_launches[i][1])
    gen = torch.Generator(device=dev).manual_seed(0)
    others = []
    for dd in (5, 64):
        x = torch.randn((graph.n_vertices, dd), generator=gen, device=dev)
        others.append(als_case(torch, f"bucket {b}, d={dd}", ell.nbrs[b],
                               ell.nbr_mask[b], r_blocks[b], x, flush))
    ctx["als_cases"] = folds + buckets + others
    ctx["als_folds"] = folds


def normal_equations(torch, graph, plan, color):
    """``(A, b)`` of one ALS color phase on ``graph``'s current factors,
    one fold a group of the phase's plan, as the update folds them."""
    from repro_torch.kernels.als_normal_eq import als_normal_eq_fold
    ab = [als_normal_eq_fold(sc.nbr_mask, sc.edge_data["rating"],
                             sc.nbr_data["w"])
          for sc in plan_scopes(torch, graph, plan, color)]
    return torch.cat([a for a, _ in ab]), torch.cat([b for _, b in ab])


def phase_als_parity(torch, ctx):
    """ALS on 2,000 x 500: GPU vs CPU, normal equations bitwise."""
    import dataclasses

    from repro_torch import api
    from repro_torch.apps import als
    from repro_torch.kernels.als_normal_eq import als_normal_eq
    dev = ctx["dev"]
    prob = als.synthetic_netflix(2000, 500, d=ALS_D, density=0.02,
                                 noise=ALS_NOISE, seed=0, device="cpu")
    g, upd, syncs = als.build(prob, lam=ALS_LAM, eps=0.0)
    cpu = api.run(g, upd, syncs=syncs, device="cpu", num_supersteps=5)
    before = als_normal_eq.launches
    gpu = api.run(g, upd, syncs=syncs, device=dev, num_supersteps=5)
    launched = als_normal_eq.launches - before
    # the same factors (initial, then the GPU run's final ones) on both
    # devices: the kernel's normal equations equal the plain version's
    n_cmp = 0
    plan_c, plan_g = als_plan(g), als_plan(g.to(dev))
    for vdata in (g.vertex_data, gpu.vertex_data):
        gv = dataclasses.replace(g, vertex_data={
            k: v.cpu() for k, v in vdata.items()})
        for c in range(g.n_colors):
            a_c, b_c = normal_equations(torch, gv, plan_c, c)
            a_g, b_g = normal_equations(torch, gv.to(dev), plan_g, c)
            if not (torch.equal(a_g.cpu(), a_c)
                    and torch.equal(b_g.cpu(), b_c)):
                raise AssertionError(f"normal equations of color {c} differ"
                                     " between the GPU and the CPU")
            n_cmp += 1
    wc, wg = cpu.vertex_data["w"], gpu.vertex_data["w"].cpu()
    werr = float((wc - wg).abs().max())
    rc, rg = float(cpu.globals["rmse"]), float(gpu.globals["rmse"])
    log(f"2,000 x 500 ALS ({g.n_edges} ratings, d={ALS_D}): cpu "
        f"{cpu.superstep} supersteps / {cpu.n_updates} updates, gpu "
        f"{gpu.superstep} / {gpu.n_updates}; als_normal_eq launches "
        f"{launched}; normal equations bitwise in {n_cmp} phases; factors "
        f"max |diff| {werr:.2e}; sync RMSE cpu {rc} gpu {rg}")
    if (cpu.superstep, cpu.n_updates) != (gpu.superstep, gpu.n_updates):
        raise AssertionError("GPU and CPU ALS counts differ")
    if launched <= 0:
        raise AssertionError("the GPU ALS run never launched als_normal_eq")
    torch.testing.assert_close(wg, wc, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(rg, rc, rtol=1e-5, atol=0.0)


def rmse64(pairs, ratings, w, n_users, chunk=1 << 22):
    """Float64 RMSE of factors ``w`` over every rating."""
    import numpy as np
    se = 0.0
    for s in range(0, len(pairs), chunk):
        p = pairs[s:s + chunk]
        pred = np.einsum("ed,ed->e", w[p[:, 0]], w[p[:, 1] + n_users])
        se += float(np.sum((pred - ratings[s:s + chunk]) ** 2))
    return (se / max(len(pairs), 1)) ** 0.5


def phase_als_main(torch, ctx):
    """ALS at Netflix width through api.run, counted and checked."""
    import numpy as np

    import repro_torch.apps.als as als_mod
    import repro_torch.core.exec as ex
    from repro_torch import api
    from repro_torch.apps import als
    from repro_torch.kernels.als_normal_eq import als_normal_eq
    from repro_torch.kernels.ell_spmv import ell_spmv
    prob = ctx["als_problem"]
    g, upd, syncs = als.build(prob, lam=ALS_LAM, eps=0.0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ell_spmv.launches = 0
    als_normal_eq.launches = 0
    t0 = time.perf_counter()
    res = api.run(g, upd, syncs=syncs, device=ctx["dev"],
                  num_supersteps=ALS_SUPERSTEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = als_normal_eq.launches
    ctx.setdefault("launches", {})["als_normal_eq"] = launches
    peak = torch.cuda.max_memory_allocated()
    groups = sum(len(blocks.rows) for _, _, blocks in res.engine.plan.phases)
    log(f"full-width ALS: {res.superstep} supersteps, {res.n_updates} "
        f"updates ({g.n_vertices} vertices), {wall:.3f} s "
        f"({1e3 * wall / max(res.superstep, 1):.2f} ms/superstep), "
        f"als_normal_eq launches {launches} (expected "
        f"{groups * ALS_SUPERSTEPS}: one a group of the 2 colors' phase "
        f"plan, {groups} a superstep), ell_spmv launches "
        f"{ell_spmv.launches}, peak device memory {peak / 2**30:.2f} GiB")
    if launches <= 0:
        raise AssertionError("the ALS path never launched als_normal_eq")
    ctx["als_single"] = single_run(res, "w")

    n_users, d = prob.n_users, prob.d
    w = res.vertex_data["w"].cpu().numpy()
    if w.shape != (g.n_vertices, d) or not np.isfinite(w).all():
        raise AssertionError("factors are not finite or have the wrong "
                             "shape")
    w64 = w.astype(np.float64)
    r64 = prob.ratings.astype(np.float64)
    exact = rmse64(prob.pairs, r64, w64, n_users)
    w_init = g.vertex_data["w"].cpu().numpy()
    initial = rmse64(prob.pairs, r64, w_init.astype(np.float64), n_users)
    sync = float(res.globals["rmse"])
    rel = abs(sync - exact) / exact
    log(f"full-width ALS: sync RMSE {sync} vs float64 {exact:.7f} (rel "
        f"{rel:.2e}, limit 1e-3); float32 dataset_rmse "
        f"{als.dataset_rmse(prob, res.vertex_data):.7f}; initial factors' "
        f"RMSE {initial:.7f}")
    if rel > 1e-3:
        raise AssertionError(f"sync RMSE off the float64 RMSE by {rel}")
    # r = <u, v> + noise with var <u, v> = 1/d = 0.05 and noise 0.1: a fit
    # reaches ~0.1, about 0.41 of the zero predictor's RMSE
    zero = float(np.sqrt(np.mean(r64 ** 2)))
    log(f"full-width ALS: the zero predictor's RMSE {zero:.7f}; ALS's is "
        f"{exact / zero:.3f} of it (limit 0.5)")
    if not exact < initial or not exact < 0.5 * zero:
        raise AssertionError("ALS did not learn the low-rank ratings")

    # 1,000 movies: factor == float64 solve of its normal equations
    # against the final user factors
    order = np.argsort(prob.pairs[:, 1], kind="stable")
    starts = np.searchsorted(prob.pairs[order, 1],
                             np.arange(prob.n_movies + 1))
    sample = np.random.default_rng(0).choice(
        prob.n_movies, min(ALS_CHECKED_MOVIES, prob.n_movies), replace=False)
    worst, conds = 0.0, []
    for m in sample:
        e = order[starts[m]:starts[m + 1]]
        if len(e) == 0:          # an unrated movie keeps its factor
            if not np.array_equal(w[n_users + m], w_init[n_users + m]):
                raise AssertionError(f"unrated movie {m} changed its factor")
            continue
        users = w64[prob.pairs[e, 0]]
        a = users.T @ users + ALS_LAM * len(e) * np.eye(d)
        want = np.linalg.solve(a, users.T @ r64[e])
        got = w64[n_users + m]
        worst = max(worst, float(np.linalg.norm(got - want)
                                 / np.linalg.norm(want)))
        conds.append(float(np.linalg.cond(a)))
    log(f"full-width ALS: {len(sample)} movies against float64 solves: "
        f"max relative error {worst:.3e} (limit {ALS_FACTOR_RTOL:.0e}); "
        f"condition numbers {min(conds, default=0):.1f}.."
        f"{max(conds, default=0):.1f}")
    if worst > ALS_FACTOR_RTOL:
        raise AssertionError(f"movie factors off their float64 solves by "
                             f"{worst} relative")
    report_superstep(torch, res.engine, [
        (ex, "gather_scopes", "gather_scopes"),
        (als_mod, "als_normal_eq_fold", "als_normal_eq_fold (the kernel)"),
        (torch.linalg, "solve_ex", "solve_ex (LU solve)"),
        (ex, "scatter_result", "scatter_result (write-back)"),
        (ex, "consume_and_reschedule", "consume_and_reschedule"),
        (ex, "refresh_syncs", "refresh_syncs")])


def setup_als(torch, ctx):
    """The full-width ALS problem, built on the host from its seed."""
    from repro_torch.apps import als
    t0 = time.perf_counter()
    prob = als.synthetic_netflix(ALS_USERS, NETFLIX_MOVIES, d=ALS_D,
                                 density=ALS_DENSITY, noise=ALS_NOISE,
                                 seed=0, device=ctx["dev"])
    torch.cuda.synchronize()
    g = prob.graph
    log(f"full-width ALS problem: {prob.n_users} users x {prob.n_movies} "
        f"movies (density {ALS_DENSITY:.6f}), {g.n_edges} ratings, "
        f"{g.n_vertices} vertices, d={prob.d}, max degree {g.max_deg}, "
        f"buckets {g.ell.bucket_launches}; host set-up "
        f"{time.perf_counter() - t0:.1f} s")
    ctx["als_problem"] = prob


def release(torch, ctx, *keys):
    """Drop the named set-ups of earlier phases and their device memory."""
    import gc
    for k in keys:
        ctx.pop(k, None)
    gc.collect()
    torch.cuda.empty_cache()


def log_attention_bodies(torch):
    """The bf16 tensor-core body's compiled attributes at the head widths
    phase 8 launches (the ptxas lines above hold every instantiation)."""
    from repro_torch import configs
    from repro_torch.kernels import window_attention as wa
    for arch in (SERVE_ARCH, *WIDE_ARCHS):
        dh = configs.get(arch).dh
        i = wa.body_info(cuda_device(torch), dh)
        log(f"  window_attention bf16 body at dh {dh} ({arch}): "
            f"{i['registers']} registers, {i['spill_bytes']} bytes spilled, "
            f"{i['static_smem']} bytes static + {i['dynamic_smem']} dynamic "
            f"shared memory, {i['stages']} stages, {i['blocks_per_sm']} "
            f"blocks of 128 threads an SM")


def attention_bound(kv_len, h, hkv, dh, kv_bytes):
    """Least time for one window_attention call on this data: the larger
    of its bytes over the HBM rate and its flops over the float32 rate,
    both from ``window_attention.attention_work`` (the op walker's count
    of the kernel) at the call's valid rows."""
    from repro_torch.kernels.window_attention import attention_work
    nbytes, flops = attention_work(int(kv_len.sum()), kv_len.numel(), h,
                                   hkv, dh, kv_bytes)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def attention_case(torch, label, b, h, hkv, w, dh, dtype, lens, flush, gen,
                   reference_signature=False):
    """``window_attention`` at one shape against its plain version
    (within ATTN_TOL), timed beside the plain version, the library call
    and the bound.  ``lens``: "full" (every request at kv_len = W, the
    ring-wrapped cache of the main path) or "ragged" (uniform in [1, W],
    with 1 and W among them)."""
    import torch.nn.functional as F

    from repro_torch.kernels.ref import decode_window_attention_ref
    from repro_torch.kernels.window_attention import (decode_window_attention,
                                                      window_attention)
    dev = flush.device
    q = torch.randn((b, h, dh), generator=gen, device=dev)
    k = torch.randn((b, w, hkv, dh), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, w, hkv, dh), generator=gen, device=dev).to(dtype)
    if lens == "full":
        kvl = torch.full((b,), w, dtype=torch.int32, device=dev)
    else:
        kvl = torch.randint(1, w + 1, (b,), generator=gen, device=dev,
                            dtype=torch.int32)
        kvl[0], kvl[-1] = 1, w
    if reference_signature:
        kern = lambda: decode_window_attention(q[:, 0], k[:, :, 0],
                                               v[:, :, 0], kvl)[:, None]
    else:
        kern = lambda: window_attention(q, k, v, kvl)
    plain = lambda: decode_window_attention_ref(q, k, v, kvl)
    got, want = kern(), plain()
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not err <= ATTN_TOL or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"window_attention {label}: max |diff| {err} "
                             f"from the plain version (limit {ATTN_TOL})")
    # the library yardstick, never on the path: SDPA over the cache's
    # [B, Hkv, W, dh] view with a boolean mask, at the cache's dtype
    qs = q.to(dtype)[:, :, None, :]
    ks, vs = k.transpose(1, 2), v.transpose(1, 2)
    mask = (torch.arange(w, device=dev)[None, :] < kvl[:, None])[:, None,
                                                                 None, :]
    lib = lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                                 enable_gqa=True)
    lib_err = float((lib()[:, :, 0].float() - want).abs().max())
    ms, call_ms = time_cuda(torch, kern, 20, flush)
    plain_ms, _ = time_cuda(torch, plain, 3, flush)
    lib_ms, _ = time_cuda(torch, lib, 20, flush)
    bms, by = attention_bound(kvl, h, hkv, dh, k.element_size())
    log(f"{label:<34} [{b}, {h}, {hkv}, {w}, {dh}] rows {int(kvl.sum()):>7}: "
        f"{ms:8.4f} ms ({call_ms:.4f} with the host), plain {plain_ms:8.4f}, "
        f"library {lib_ms:8.4f} (max |diff| {lib_err:.1e}), bound "
        f"{bms:.4f} ({by}), max |diff| {err:.2e}")
    return dict(label=label, shape=[b, h, hkv, w, dh], dtype=str(dtype)[6:],
                ms=ms, call_ms=call_ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bms, bound_by=by, max_abs_err=err)


def phase_attention(torch, ctx):
    """window_attention vs its plain version at the serving shapes."""
    import dataclasses

    from repro_torch import configs
    # phase 7's problem waits on the host for phases 14-16
    prob = ctx["als_problem"]
    ctx["als_host"] = dataclasses.replace(prob, graph=prob.graph.to("cpu"))
    release(torch, ctx, "graph", "update", "syncs", "edges", "als_problem")
    cfg = configs.get(SERVE_ARCH)
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.dh
    dev = ctx["dev"]
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    bf16, f32 = torch.bfloat16, torch.float32
    log("times: device ms (call ms with the host's enqueue), L2 flushed")
    from repro_torch.serve.engine import cache_width
    (_, b32, s32), (_, b500, s500) = SERVE_CASES
    w32, w500 = cache_width(cfg, s32), cache_width(cfg, s500)
    cases = []
    for label, b, w, dtype, lens in (
            ("decode_32k, bf16, full (a step's)", b32, w32, bf16, "full"),
            ("decode_32k, bf16, ragged", b32, w32, bf16, "ragged"),
            ("long_500k, bf16, ring wrapped", b500, w500, bf16, "full"),
            ("decode_32k, f32, ragged", b32, w32, f32, "ragged"),
            ("long_500k, f32, ring wrapped", b500, w500, f32, "full")):
        cases.append(attention_case(torch, label, b, h, hkv, w, dh, dtype,
                                    lens, flush, gen))
    for w in (w32, 513):
        cases.append(attention_case(torch, f"reference signature, W={w}",
                                    REF_SIG_BATCH, 1, 1, w, dh, f32, "ragged",
                                    flush, gen, reference_signature=True))
    # other group sizes and head widths of the repository's dense configs
    for arch in WIDE_ARCHS:
        c = configs.get(arch)
        cases.append(attention_case(
            torch, f"{arch}, bf16, {WIDE_RING}-row ring", 1, c.n_heads,
            c.n_kv_heads, WIDE_RING, c.dh, bf16, "full", flush, gen))
    ctx["attn_cases"] = cases
    ctx["serve_n_layers"] = cfg.n_layers


def phase_serve_parity(torch, ctx):
    """qwen3-4b, full width, 2 layers, float32: GPU vs CPU decode, and
    teacher-forced decode vs prefill on the GPU."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import model
    from repro_torch.serve import engine
    dev = ctx["dev"]
    cfg = dataclasses.replace(configs.get(SERVE_ARCH), n_layers=2)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cpu_params = model.init_params(cfg, seed=0, dtype=torch.float32,
                                       device="cpu")
        gpu_params = model.Model(cfg, dtype=torch.float32, device=dev)
        gpu_params.load_state_dict(cpu_params.state_dict())
        b, seq = 2, 1024
        gen = torch.Generator(device="cpu").manual_seed(1)
        states = []
        for d in ("cpu", dev):
            st = engine.init_cache(cfg, b, seq, dtype=torch.float32, device=d)
            gen.manual_seed(1)
            st.cache_k.copy_(torch.randn(st.cache_k.shape, generator=gen))
            st.cache_v.copy_(torch.randn(st.cache_v.shape, generator=gen))
            st.cache_len.copy_(torch.tensor([seq, 300], dtype=torch.int32))
            states.append(st)
        cst, gst = states
        tok = torch.tensor([[11], [cfg.vocab - 1]], dtype=torch.int32)
        worst = 0.0
        for _ in range(4):
            cl, cst = engine.decode_step(cpu_params, cfg, tok, cst)
            gl, gst = engine.decode_step(gpu_params, cfg, tok.to(dev), gst)
            diff = float((gl.cpu() - cl)[:, :cfg.vocab].abs().max())
            worst = max(worst, diff)
            tok = torch.argmax(cl[:, :cfg.vocab], dim=-1)[:, None].int()
        log(f"{SERVE_ARCH} full width, 2 layers, float32: 4 decode steps "
            f"GPU vs CPU, logits max |diff| {worst:.2e} (limit 1e-4; "
            f"|logits| up to {float(cl.abs()[:, :cfg.vocab].max()):.2f})")
        if not worst <= 1e-4:
            raise AssertionError(f"GPU decode off the CPU's by {worst}")
        del cpu_params, states, cst, gst

        # the reference's invariant (test_decode_matches_forward_logits) at
        # full width: teacher-forced decode from an empty cache reproduces
        # prefill's last-token logits, within its rtol = atol = 3e-2
        s = 128
        toks = torch.randint(0, cfg.vocab, (2, s), generator=torch.Generator(
            device=dev).manual_seed(2), device=dev, dtype=torch.int32)
        want = model.prefill(gpu_params, cfg, {"tokens": toks})
        st = engine.init_cache(cfg, 2, s, dtype=torch.float32, device=dev)
        st.cache_len.zero_()
        for i in range(s):
            logits, st = engine.decode_step(gpu_params, cfg, toks[:, i:i + 1],
                                            st)
        d, ref = logits[:, :cfg.vocab], want[:, :cfg.vocab]
        diff = float((d - ref).abs().max())
        excess = float(((d - ref).abs() - 3e-2 * (1 + ref.abs())).max())
        log(f"{SERVE_ARCH} full width, 2 layers, float32: {s} teacher-forced "
            f"decode steps from an empty cache vs prefill, last logits max "
            f"|diff| {diff:.2e} (limits {DECODE_F32_TOL} and 3e-2 * (1 + "
            f"|prefill|), worst margin to the latter {-excess:.2e})")
        if not (excess <= 0 and diff <= DECODE_F32_TOL):
            raise AssertionError(f"decode off prefill by {diff}")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def serve_layers():
    """``(owner, attribute, label)`` of each layer a decode step is split
    into."""
    from repro_torch.models import attention
    from repro_torch.models import model
    from repro_torch.serve import engine
    return [(model, "_embed_tokens", "embed"),
            (engine, "rmsnorm", "norms (norm1, norm2, final)"),
            (attention, "_qkv", "QKV projections, qk_norm, rope"),
            (attention, "_ring_insert", "ring insert"),
            (attention, "window_attention", "window_attention (the kernel)"),
            (attention, "_out_proj", "wo"),
            (model, "_mlp_apply", "MLP"),
            (model, "_logits", "logits")]


def check_attention_on_host(torch, captured, n_rep, pairs, rng):
    """The captured attention of sampled (request, head) pairs against
    float64 on the host; returns the largest |diff|."""
    import numpy as np
    worst = 0.0
    for layer, (q, kvl, out, k, v) in sorted(captured.items()):
        b, h, dh = q.shape
        for bi, hi in zip(rng.integers(0, b, pairs), rng.integers(0, h, pairs)):
            n = int(kvl[bi])
            g = hi // n_rep
            kk = k[bi, :n, g].double().cpu().numpy()
            vv = v[bi, :n, g].double().cpu().numpy()
            qq = q[bi, hi].double().cpu().numpy()
            sc = kk @ qq / np.sqrt(dh)
            p = np.exp(sc - sc.max())
            o = (p / p.sum()) @ vv
            worst = max(worst, float(np.abs(out[bi, hi].double().cpu()
                                            .numpy() - o).max()))
    return worst


def host_norm(np, t, scale, eps):
    return t / np.sqrt((t * t).mean(-1, keepdims=True) + eps) * scale


def host_attention(np, cfg, p, h, ck, cv, pos):
    """Decode attention for one request in float64 numpy, from the
    reference's equations: ``p`` the attention's parameters by name
    (``wq`` ...); h [d], the normed input; ck / cv [W, Hkv, dh], the
    layer's cache rows, get the new token's K/V at ring slot ``pos % W``
    and the query attends to the first ``min(pos + 1, W)``; rope's angles
    are float32, as the reference defines them.  Returns (out, k, v),
    ``out`` after ``wo``."""
    dh, half, eps = cfg.dh, cfg.dh // 2, cfg.norm_eps
    freqs = np.float32(1) / np.float32(cfg.rope_theta) ** (
        np.arange(half, dtype=np.float32) / np.float32(half))
    ang = (np.float32(pos) * freqs).astype(np.float64)
    cos, sin = np.cos(ang), np.sin(ang)
    rope = lambda t: np.concatenate([t[:, :half] * cos - t[:, half:] * sin,
                                     t[:, half:] * cos + t[:, :half] * sin], -1)
    q = (h @ p["wq"]).reshape(cfg.n_heads, dh)
    k = (h @ p["wk"]).reshape(cfg.n_kv_heads, dh)
    v = (h @ p["wv"]).reshape(cfg.n_kv_heads, dh)
    if cfg.qk_norm:
        q = host_norm(np, q, p["q_norm"], eps)
        k = host_norm(np, k, p["k_norm"], eps)
    q, k = rope(q), rope(k)
    w = ck.shape[0]
    ck[pos % w], cv[pos % w] = k, v
    return host_softmax_attend(np, cfg, q, ck[:min(pos + 1, w)],
                               cv[:min(pos + 1, w)]) @ p["wo"], k, v


def host_softmax_attend(np, cfg, q, k, v):
    """q [H, dh] over rows k / v [n, Hkv, dh]: [H * dh] in float64."""
    n_rep = cfg.n_heads // cfg.n_kv_heads
    o = np.empty_like(q)
    for hi in range(cfg.n_heads):
        sc = k[:, hi // n_rep] @ q[hi] / np.sqrt(cfg.dh)
        pr = np.exp(sc - sc.max())
        o[hi] = (pr / pr.sum()) @ v[:, hi // n_rep]
    return o.reshape(-1)


def host_decode_layer(np, cfg, p, x, ck, cv, pos):
    """One dense decode layer for one request in float64 numpy: ``p`` the
    layer's parameters by name; x [d]; ck / cv as ``host_attention``.
    Returns (x, k, v)."""
    assert cfg.act == "silu", cfg.act
    norm = lambda t, s: host_norm(np, t, s, cfg.norm_eps)
    mix = {k[4:]: v for k, v in p.items() if k.startswith("mix.")}
    out, k, v = host_attention(np, cfg, mix, norm(x, p["norm1"]), ck, cv, pos)
    x = x + out
    h = norm(x, p["norm2"])
    g = h @ p["ffn.w_gate"]
    x = x + (g / (1 + np.exp(-g)) * (h @ p["ffn.w_up"])) @ p["ffn.w_down"]
    return x, k, v


def check_layers_on_host(cfg, params, layers, logits):
    """The captured decode layers (``{layer: (x in, x out, cache_len,
    cache K, cache V)}`` of one step) and that step's logits against
    float64 on the host, for every request; returns the largest normwise
    error of each quantity."""
    import numpy as np
    rel = lambda a, b: float(np.linalg.norm(a - b) / np.linalg.norm(b))
    f = lambda t: t.detach().double().cpu().numpy()
    worst = {"k": 0.0, "v": 0.0, "layer": 0.0, "logits": 0.0}
    last = cfg.n_layers - 1
    out_w = f(params.out if params.out is not None else params.embed)
    for layer, (xi, xo, clen, ck, cv) in sorted(layers.items()):
        p = {n: f(t) for n, t in params.layers[layer].named_parameters()}
        for r in range(xi.shape[0]):
            pos = int(clen[r])
            slot = pos % ck.shape[1]
            x, k, v = host_decode_layer(np, cfg, p, f(xi[r, 0]), f(ck[r]),
                                        f(cv[r]), pos)
            worst["k"] = max(worst["k"], rel(f(ck[r, slot]), k))
            worst["v"] = max(worst["v"], rel(f(cv[r, slot]), v))
            worst["layer"] = max(worst["layer"], rel(f(xo[r, 0]), x))
            if layer == last:
                h = f(xo[r, 0])
                h = h / np.sqrt((h * h).mean() + cfg.norm_eps) * f(
                    params.final_norm)
                want = out_w[:cfg.vocab] @ h
                worst["logits"] = max(worst["logits"], rel(
                    f(logits[r, :cfg.vocab]), want))
    return worst


def phase_serve_main(torch, ctx):
    """All of qwen3-4b decoding 16 greedy tokens at decode_32k and
    long_500k, through launch/serve's loop, counted and checked."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.kernels.window_attention import window_attention
    from repro_torch.launch import serve
    from repro_torch.models import attention
    from repro_torch.models import model
    from repro_torch.serve import engine
    dev = ctx["dev"]
    cfg = configs.get(SERVE_ARCH)
    n_rep = cfg.n_heads // cfg.n_kv_heads
    t0 = time.perf_counter()
    params = model.init_params(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    log(f"{SERVE_ARCH}: {cfg.n_layers} layers, d {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.dh}, vocab "
        f"{cfg.vocab} (padded {model.vocab_padded(cfg)}); {n_params:,} bf16 "
        f"parameters ({n_params * 2 / 1e9:.2f} GB) drawn on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device=dev).manual_seed(0)
    rng = np.random.default_rng(0)
    launches = 0
    for case, batch, seq_len in SERVE_CASES:
        state = engine.init_cache(cfg, batch, seq_len, device=dev)
        state.cache_k.normal_(generator=gen)
        state.cache_v.normal_(generator=gen)
        w = state.cache_k.shape[2]
        tok = torch.randint(0, cfg.vocab, (batch, 1), generator=gen,
                            device=dev, dtype=torch.int32)
        captured, calls = {}, [0]
        layers, layer_calls = {}, [0]
        real = attention.window_attention
        real_layer = engine._decode_layer

        def capture(q, k, v, kv_len):
            # the last step's inputs and output in the first and last layer
            out = real(q, k, v, kv_len)
            i = calls[0]
            calls[0] += 1
            layer = i % cfg.n_layers
            if (i >= (SERVE_TOKENS - 1) * cfg.n_layers
                    and layer in (0, cfg.n_layers - 1)):
                captured[layer] = (q.clone(), kv_len.clone(), out.clone(), k,
                                   v)
            return out

        def capture_layer(lp, cfg_, x, ck, cv, clen):
            # the last step's first and last layer: input, output, caches
            out = real_layer(lp, cfg_, x, ck, cv, clen)
            i = layer_calls[0]
            layer_calls[0] += 1
            layer = i % cfg.n_layers
            if (i >= (SERVE_TOKENS - 1) * cfg.n_layers
                    and layer in (0, cfg.n_layers - 1)):
                layers[layer] = (x.clone(), out.clone(), clen.clone(), ck, cv)
            return out
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        attention.window_attention = capture
        engine._decode_layer = capture_layer
        try:
            window_attention.launches = 0
            seqs, logits, state, seconds = serve.generate(
                params, cfg, tok, state, SERVE_TOKENS)
            n_launch = window_attention.launches
        finally:
            attention.window_attention = real
            engine._decode_layer = real_layer
        launches += n_launch
        peak = torch.cuda.max_memory_allocated()
        step_ms = 1e3 * sum(seconds[1:]) / (len(seconds) - 1)
        cache_gb = 2 * state.cache_k.numel() * 2 / 1e9
        log(f"{case}: batch {batch}, context {seq_len}, ring W {w}, "
            f"cache {cache_gb:.2f} GB; {SERVE_TOKENS} greedy tokens: first "
            f"step {1e3 * seconds[0]:.2f} ms, then {step_ms:.2f} ms a step "
            f"(min {1e3 * min(seconds[1:]):.2f}, max "
            f"{1e3 * max(seconds[1:]):.2f}), {1e3 * batch / step_ms:.1f} "
            f"tokens/s; window_attention launches {n_launch} (expected "
            f"{SERVE_TOKENS * cfg.n_layers}); peak device memory "
            f"{peak / 2**30:.2f} GiB")
        log(f"{case}: tokens of request 0: {seqs[0].tolist()}")
        if n_launch != SERVE_TOKENS * cfg.n_layers:
            raise AssertionError(f"{case}: {n_launch} window_attention "
                                 "launches")
        if not bool(torch.isfinite(logits[:, :cfg.vocab]).all()):
            raise AssertionError(f"{case}: logits are not finite")
        if tuple(seqs.shape) != (batch, SERVE_TOKENS):
            raise AssertionError(f"{case}: tokens of shape {seqs.shape}")
        lens = captured[0][1].tolist()
        if lens != [min(seq_len + SERVE_TOKENS, w)] * batch:
            raise AssertionError(f"{case}: the last step's kv_len {lens}")
        worst = check_attention_on_host(torch, captured, n_rep, 8, rng)
        log(f"{case}: last step's attention in layers "
            f"{sorted(captured)} for 16 (request, head) pairs vs float64 "
            f"on the host: max |diff| {worst:.2e} (limit {ATTN_HOST_TOL})")
        if not worst <= ATTN_HOST_TOL:
            raise AssertionError(f"{case}: attention off float64 by {worst}")
        del captured
        t1 = time.perf_counter()
        errs = check_layers_on_host(cfg, params, layers, logits)
        log(f"{case}: last step's layers {sorted(layers)} and logits for all "
            f"{batch} requests vs a float64 decode on the host, normwise: "
            f"inserted K {errs['k']:.2e}, V {errs['v']:.2e}, layer output "
            f"{errs['layer']:.2e}, logits {errs['logits']:.2e} (limit "
            f"{LAYER_HOST_TOL}; {time.perf_counter() - t1:.1f} s)")
        if not max(errs.values()) <= LAYER_HOST_TOL:
            raise AssertionError(f"{case}: bf16 decode off float64: {errs}")
        del layers

        nxt = [torch.argmax(logits[:, :cfg.vocab], dim=-1)[:, None].int()]

        def one_step(_):
            lg, st = engine.decode_step(params, cfg, nxt[0], nxt[1])
            nxt[:] = [torch.argmax(lg[:, :cfg.vocab], dim=-1)[:, None].int(),
                      st]
        nxt.append(state)
        before = window_attention.launches
        kernels = report_run(torch, f"{case} decode step", serve_layers(),
                             one_step,
                             other="other (residual adds, casts, host)")
        # two steps: the bracketed one and the profiled one
        wrapped = window_attention.launches - before
        attn = [(t, name, n) for t, name, n in kernels
                if "window_attention" in name]
        if kernels:
            seen = sum(n for _, _, n in attn)
            log(f"{case}: window_attention in the profiled step: {seen} "
                f"kernels in the profile, {wrapped // 2} launches a step by "
                f"the wrapper's count, "
                f"{sum(t for t, _, _ in attn) / 1e3:.2f} ms of device time "
                f"({', '.join(name[:40] for _, name, _ in attn)})")
            # one kernel a layer: the merge runs inside the launch.  The
            # profiler can drop a ctypes-launched kernel's event from a
            # session (phase 21's (e) has shown 23 of its 24 launches),
            # so the launches are the wrapper's count and the profile may
            # show no more than they
            if (wrapped != 2 * cfg.n_layers or seen > cfg.n_layers
                    or any("combine" in name for _, name, _ in kernels)):
                raise AssertionError(f"{case}: the step's window_attention "
                                     f"kernels: {attn}, {wrapped} launches "
                                     f"in two steps")
        del state, nxt, logits
        torch.cuda.empty_cache()
    ctx.setdefault("launches", {})["window_attention"] = launches


# ----------------------------------------------------------------------
# Phases 11-13: the schedulers slice
# ----------------------------------------------------------------------

def synthetic_ner_bulk(np, n_phrases, n_contexts, n_types, mean_deg=6,
                       p_same=0.85, seed_frac=0.05, seed=0):
    """The planted-type model of ``coem.synthetic_ner`` drawn in bulk with
    numpy (the copy there loops in Python per phrase): Poisson(6)
    contexts a phrase (at least 1), each a uniform context of the
    phrase's type with probability 0.85, else a uniform one; counts
    uniform in 1..4; pairs deduplicated; 5 % of phrases seeds.  Returns
    ``(pairs, counts, phrase_types, context_types, seeds)``."""
    rng = np.random.default_rng(seed)
    pt = rng.integers(0, n_types, n_phrases)
    ct = rng.integers(0, n_types, n_contexts)
    k = np.maximum(1, rng.poisson(mean_deg, n_phrases))
    phrase = np.repeat(np.arange(n_phrases, dtype=np.int64), k)
    by_type = np.argsort(ct, kind="stable")
    per_type = np.bincount(ct, minlength=n_types)
    first = np.concatenate([[0], np.cumsum(per_type)[:-1]])
    t = pt[phrase]
    same = (rng.random(len(phrase)) < p_same) & (per_type[t] > 0)
    pick = first[t] + (rng.random(len(phrase)) * per_type[t]).astype(np.int64)
    context = np.where(same, by_type[np.minimum(pick, n_contexts - 1)],
                       rng.integers(0, n_contexts, len(phrase)))
    counts = rng.integers(1, 5, len(phrase)).astype(np.float32)
    _, keep = np.unique(phrase * n_contexts + context, return_index=True)
    pairs = np.stack([phrase[keep], context[keep]], axis=1)
    seeds = rng.choice(n_phrases, size=max(n_types, int(seed_frac
                                                         * n_phrases)),
                       replace=False)
    return pairs, counts[keep], pt, ct, seeds


def setup_schedulers(torch, ctx):
    """Phases 11-13's full-size problems, built on the host: CC on phase
    4's Zipf edges (with phase 4's colors), the bulk NER corpus, and
    CoSeg from ``lbp.synthetic_coseg``."""
    import numpy as np

    from repro_torch.apps import cc, coem, lbp
    release(torch, ctx)
    dev = ctx["dev"]
    t0 = time.perf_counter()
    g, _, _ = cc.build(ctx["zipf_edges"], FULL_N, colors=ctx["zipf_colors"],
                       device=dev)
    t1 = time.perf_counter()
    pairs, counts, pt, ct, seeds = synthetic_ner_bulk(
        np, NER_PHRASES, NER_CONTEXTS, NER_TYPES, seed=0)
    ner = coem.problem_from_pairs(pairs, counts, pt, ct, NER_TYPES, seeds,
                                  device=dev)
    t2 = time.perf_counter()
    coseg = lbp.synthetic_coseg(*COSEG_SHAPE, n_labels=COSEG_LABELS,
                                n_feat=COSEG_FEAT, noise=COSEG_NOISE, seed=0,
                                device=dev)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    cg = ner.graph
    log(f"CC graph: {g.n_vertices} vertices, {g.n_edges} edges, "
        f"{g.n_colors} colors (phase 4's), widths {g.ell.widths}, "
        f"{g.ell.padded_slots} sliced slots; host set-up {t1 - t0:.1f} s")
    log(f"CoEM corpus: {NER_PHRASES} phrases x {NER_CONTEXTS} contexts, "
        f"{NER_TYPES} types, {cg.n_edges} edges, {len(seeds)} seeds, max "
        f"degree {cg.max_deg}, buckets {cg.ell.bucket_launches}; host "
        f"set-up {t2 - t1:.1f} s")
    log(f"CoSeg: {COSEG_SHAPE} super-pixels = {coseg.graph.n_vertices}, "
        f"{coseg.graph.n_edges} edges, {coseg.graph.n_colors} colors, K = "
        f"{COSEG_LABELS}; host set-up {t3 - t2:.1f} s")
    ctx.update(cc_graph=g, ner=ner, coseg=coseg)


def window_case(torch, label, ell, width, w_edge, x, gen, flush, ids=None,
                timed=True):
    """``ell_spmv_batched`` on a ``[WINDOW, W]`` window gathered at scope
    width ``W`` from rows drawn uniformly among the buckets up to W (as a
    priority window snapped to W holds them; on a split graph, among the
    owners of one virtual row), or on the window ``ids`` when given,
    against its plain version (bitwise); when ``timed``, also one
    ``torch.sparse.mm`` on its CSR and its bound."""
    from repro_torch.kernels.ell_spmv import ell_spmv_batched, ell_spmv_plain
    dev = x.device
    b = ell.widths.index(width)
    if ids is None:
        pos = torch.arange(ell.starts[b + 1], device=dev)   # bucketed rows
        pool = ell.perm[pos].long()
        if ell.is_split:
            pool = ell.owner_of_vrow[pool].long()
            off = ell.vrow_offset
            single = (off[pool + 1] - off[pool]) == 1
            pos, pool = pos[single], pool[single]
        pick = torch.randperm(pos.numel(), generator=gen, device=dev)[:WINDOW]
        if not bool((pos[pick] >= ell.starts[b]).any()):
            # a row of width W's own bucket
            pick[0] = int(torch.nonzero(pos >= ell.starts[b])[0])
        ids = pool[pick].to(torch.int32)
    every = torch.ones(ids.numel(), dtype=torch.bool, device=dev)
    if ell.window_bucket(ids, every) != b:
        raise AssertionError(f"{label}: the window does not need width "
                             f"{width}")
    r = ell.rows(ids, width=width)
    w = torch.where(r.nbr_mask, w_edge[r.edge_ids.long()], 0.0).contiguous()
    mask = torch.rand(ids.numel(), generator=gen, device=dev) < 0.8
    args = (r.nbrs, w, x, mask)
    y = ell_spmv_batched(*args)
    yp = ell_spmv_plain(*args)
    torch.cuda.synchronize()
    mism = bits_differ(torch, y, yp)
    err = float((y - yp).abs().max())
    if mism:
        raise AssertionError(f"{label}: {mism} f32 elements differ from "
                             f"the plain version (max {err})")
    if not timed:
        return dict(label=label, rows=ids.numel(), width=width,
                    max_abs_err=err)
    csr = csr_of(torch, [(r.nbrs, w, r.nbr_mask, mask)], x.shape[0])
    lib_err = float((torch.sparse.mm(csr, x) - y).abs().max())
    ms, call_ms = time_cuda(torch, lambda: ell_spmv_batched(*args), 20, flush)
    plain_ms, _ = time_cuda(torch, lambda: ell_spmv_plain(*args), 3, flush)
    lib_ms, _ = time_cuda(torch, lambda: torch.sparse.mm(csr, x), 20, flush)
    nb, feat = ids.numel(), x.shape[1]
    real = int(r.nbr_mask.sum())
    bms, by = bound_ms(nb, nb * width, touched_rows(torch, r.nbrs,
                                                    r.nbr_mask), feat, 4, nb)
    log(f"{label} [{nb}, {width}] ({real} real slots): kernel {ms:.4f} ms "
        f"({call_ms:.4f} with the host), plain {plain_ms:.4f}, library "
        f"{lib_ms:.4f} (max |diff| {lib_err:.2e}), bound {bms:.4f} ({by}; "
        f"kernel / bound {ms / bms:.2f}), mismatches 0")
    return dict(label=label, rows=nb, width=width, feat=feat,
                real_slots=real, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=bms, bound_by=by, max_abs_err=err)


def sweep_case(torch, label, ell, w_edge, x, gen, flush):
    """``ell_spmv_bucketed`` over every bucket of ``ell`` as one launch
    (weights ``w_edge`` by edge id, 80 % of rows unmasked) against its
    plain version (bitwise), one ``torch.sparse.mm`` on its CSR and its
    bound."""
    from repro_torch.kernels.ell_spmv import (ell_spmv, ell_spmv_bucketed,
                                              ell_spmv_plain)
    dev, feat = x.device, x.shape[1]
    w_blocks = [torch.where(ell.nbr_mask[b], w_edge[ell.edge_ids[b].long()],
                            0.0).contiguous() for b in range(ell.n_buckets)]
    masks = [torch.rand(nb.shape[0], generator=gen, device=dev) < 0.8
             for nb in ell.nbrs]
    before = ell_spmv.launches
    y = ell_spmv_bucketed(ell.nbrs, w_blocks, x, masks)
    launched = ell_spmv.launches - before
    yp = torch.cat([ell_spmv_plain(nb, w, x, m)
                    for nb, w, m in zip(ell.nbrs, w_blocks, masks)])
    torch.cuda.synchronize()
    mism = bits_differ(torch, y, yp)
    err = float((y - yp).abs().max())
    if mism or launched != 1:
        raise AssertionError(f"{label}: {mism} f32 elements differ, "
                             f"{launched} launches")
    blocks = list(zip(ell.nbrs, w_blocks, ell.nbr_mask, masks))
    csr = csr_of(torch, blocks, x.shape[0])
    lib_err = float((torch.sparse.mm(csr, x) - y).abs().max())
    ms, call_ms = time_cuda(
        torch, lambda: ell_spmv_bucketed(ell.nbrs, w_blocks, x, masks), 20,
        flush)
    plain_ms, _ = time_cuda(torch, lambda: [
        ell_spmv_plain(nb, w, x, m)
        for nb, w, m in zip(ell.nbrs, w_blocks, masks)], 2, flush)
    lib_ms, _ = time_cuda(torch, lambda: torch.sparse.mm(csr, x), 20, flush)
    touched = int(torch.unique(torch.cat(
        [nb[m] for nb, m in zip(ell.nbrs, ell.nbr_mask)])).numel())
    bms, by = bound_ms(ell.total_rows, ell.padded_slots, touched, feat, 4,
                       ell.total_rows)
    log(f"{label}, one launch [{ell.total_rows} rows, {ell.padded_slots} "
        f"slots, {touched} rows of x]: kernel {ms:.4f} ms ({call_ms:.4f} "
        f"with the host), plain {plain_ms:.4f}, library {lib_ms:.4f} (max "
        f"|diff| {lib_err:.2e}), bound {bms:.4f} ({by}; kernel / bound "
        f"{ms / bms:.2f}), mismatches 0, launches 1")
    return dict(label=label, rows=ell.total_rows, width=None, feat=feat,
                ms=ms, call_ms=call_ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bms, bound_by=by, max_abs_err=err)


def phase_sched_kernels(torch, ctx):
    """B1 at this slice's launch shapes: the ``[WINDOW, W]`` window of
    every scope width of the Zipf graph at F = 1 and of the CoEM graph at
    F = 32, and the CoEM sweep as one launch (F = 32)."""
    import numpy as np

    from repro_torch.apps import pagerank
    dev = ctx["dev"]
    gen = torch.Generator(device=dev).manual_seed(11)
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    cases = []
    g = ctx["cc_graph"]
    # PageRank's weights in the CC graph's stored edge order, pad row 0
    w_edge = torch.from_numpy(np.append(pagerank.edge_weights(
        g.edges_np, g.n_vertices), np.float32(0))).to(dev)
    x1 = torch.rand((g.n_vertices, 1), generator=gen, device=dev) + 0.5
    for width in g.ell.scope_widths:
        cases.append(window_case(torch, f"Zipf window F=1 W={width}", g.ell,
                                 width, w_edge, x1, gen, flush))
    cg = ctx["ner"].graph
    count = cg.edge_data["count"]
    x32 = torch.rand((cg.n_vertices, NER_TYPES), generator=gen, device=dev)
    for width in cg.ell.scope_widths:
        cases.append(window_case(torch, f"CoEM window F={NER_TYPES} "
                                 f"W={width}", cg.ell, width, count, x32, gen,
                                 flush))
    cases.append(sweep_case(torch, f"CoEM sweep F={NER_TYPES}", cg.ell,
                            count, x32, gen, flush))
    ctx["sched_kernel_cases"] = cases
    largest = int(torch.bincount(g.colors).max())
    for label, ell, sizes in (
            ("Zipf", g.ell, (WINDOW, 8 * WINDOW, largest, g.n_vertices)),
            ("CoEM", cg.ell, (WINDOW, 8 * WINDOW, NER_PHRASES))):
        for b_rows in sizes:
            gather_case(torch, label, ell, b_rows, gen)


def gather_case(torch, label, ell, b_rows, gen):
    """Both row gathers of ``SlicedEll`` on ``b_rows`` distinct random
    rows at ``max_deg``: the same rows, and each one's host wall time
    with the card synchronized around it (the per-bucket gather's syncs
    are part of its cost), the median of 5 after a warm-up.  These
    readings place ``graph.FLAT_GATHER_SLOTS``."""
    from repro_torch.core import graph
    ids = torch.randperm(ell.n_rows, generator=gen,
                         device=ell.device)[:b_rows]
    pos, d = ell.inv_perm[ids], ell.max_deg
    rows, ms = {}, {}
    for name, fn in (("flat", ell._flat_rows), ("bucket", ell._bucket_rows)):
        rows[name] = fn(pos, d)
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(pos, d)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        ms[name] = sorted(times)[2]
    same = all(torch.equal(a, b) for a, b in zip(rows["flat"],
                                                 rows["bucket"]))
    pick = "flat" if b_rows * d <= graph.FLAT_GATHER_SLOTS else "bucket"
    log(f"{label} row gather [{b_rows}, {d}] ({b_rows * d} slots): flat "
        f"{ms['flat']:.3f} ms, per bucket {ms['bucket']:.3f} ms (host "
        f"wall, synchronized; the engines take {pick}), same rows {same}")
    if not same:
        raise AssertionError(f"{label} row gather [{b_rows}, {d}]: the "
                             "flat and per-bucket gathers differ")


# (label, scheduler, options) of the engine runs of phases 12 and 13
def sched_cases(window):
    return (("chromatic", "chromatic", {}), ("bsp", "bsp", {}),
            ("priority", "priority", {"k_select": window}),
            ("priority fifo", "priority", {"k_select": window,
                                           "fifo": True}),
            ("locking", "locking", {"max_pending": window}))


def phase_sched_parity(torch, ctx):
    """The 2k Zipf graph and a 2,000-phrase NER corpus on the new
    engines: CC and PageRank GPU == CPU bitwise, PageRank's four launch
    shapes and arms bitwise on the GPU, CoEM's kernel arm == dense arm
    bitwise on the GPU and within 1e-6 of the CPU."""
    from repro_torch import api
    from repro_torch.apps import cc, coem, pagerank
    from repro_torch.core.graph import zipf_edges
    from repro_torch.core.update import Consistency, UpdateFn
    from repro_torch.kernels.ell_spmv import ell_spmv
    dev = ctx["dev"]
    n = 2000
    edges = zipf_edges(n, alpha=2.0, max_deg=64, seed=1)
    g, upd, _ = cc.build(edges, n, device="cpu")
    truth = cc.reference_components(edges, n)
    full = UpdateFn(upd.fn, Consistency.FULL, name="cc")
    for label, sched, opts in sched_cases(64) + (
            ("locking FULL", "locking", {"max_pending": 64}),):
        t0 = time.perf_counter()
        u = full if label.endswith("FULL") else upd
        cpu = api.run(g, u, scheduler=sched, device="cpu", **opts)
        gpu = api.run(g, u, scheduler=sched, device=dev, **opts)
        same = (torch.equal(gpu.vertex_data["label"].cpu(),
                            cpu.vertex_data["label"])
                and (gpu.superstep, gpu.n_updates)
                == (cpu.superstep, cpu.n_updates))
        log(f"2k CC {label}: {gpu.superstep} supersteps, {gpu.n_updates} "
            f"updates, GPU == CPU {same} ({time.perf_counter() - t0:.1f} s)")
        if not same or gpu.active_any or not (
                cpu.vertex_data["label"].numpy() == truth).all():
            raise AssertionError(f"2k CC {label}: GPU != CPU or not the "
                                 "union-find labels")
    g, upd, syncs = pagerank.build(edges, n, eps=EPS, device="cpu")
    budget = {"num_supersteps": PARITY_STEPS}
    for label, sched, opts in sched_cases(64):
        t0 = time.perf_counter()
        cpu = api.run(g, upd, syncs=syncs, scheduler=sched, device="cpu",
                      **opts, **budget)
        for dispatch in ("bucket", "batch"):
            for use_kernel in (True, False):
                before = ell_spmv.launches
                gpu = api.run(g, upd, syncs=syncs, scheduler=sched,
                              device=dev, dispatch=dispatch,
                              use_kernel=use_kernel, **opts, **budget)
                same = (torch.equal(gpu.vertex_data["rank"].cpu(),
                                    cpu.vertex_data["rank"])
                        and (gpu.superstep, gpu.n_updates)
                        == (cpu.superstep, cpu.n_updates)
                        and ell_spmv.launches > before)
                if not same:
                    raise AssertionError(
                        f"2k PageRank {label} {dispatch} use_kernel="
                        f"{use_kernel}: GPU != CPU (or no launch)")
        log(f"2k PageRank {label}: {cpu.superstep} supersteps, "
            f"{cpu.n_updates} updates; bucket/batch x kernel/dense on the "
            f"GPU == CPU bitwise ({time.perf_counter() - t0:.1f} s)")
    prob = coem.synthetic_ner(2000, 500, NER_TYPES, seed=3, device="cpu")
    g, upd, syncs = coem.build(prob, eps=COEM_EPS)
    for label, sched, opts in (("chromatic", "chromatic", {}),
                               ("priority", "priority", {"k_select": 64})):
        t0 = time.perf_counter()
        cpu = api.run(g, upd, syncs=syncs, scheduler=sched, device="cpu",
                      **opts, **budget)
        outs = [api.run(g, upd, syncs=syncs, scheduler=sched, device=dev,
                        dispatch=d, use_kernel=k, **opts, **budget)
                for d in ("bucket", "batch") for k in (True, False)]
        p0 = outs[0].vertex_data["p"]
        if not all(torch.equal(o.vertex_data["p"], p0)
                   and o.n_updates == outs[0].n_updates for o in outs):
            raise AssertionError(f"2k CoEM {label}: the GPU's arms or "
                                 "launch shapes differ")
        diff = float((p0.cpu() - cpu.vertex_data["p"]).abs().max())
        log(f"2k CoEM {label} (F={NER_TYPES}): {outs[0].superstep} "
            f"supersteps, {outs[0].n_updates} updates (CPU "
            f"{cpu.n_updates}); kernel == dense, bucket == batch bitwise on "
            f"the GPU; GPU vs CPU max |diff| {diff:.2e} (limit 1e-6; "
            f"{time.perf_counter() - t0:.1f} s)")
        if diff > 1e-6:
            raise AssertionError(f"2k CoEM {label}: GPU vs CPU {diff}")


def scheduler_layers():
    """``(owner, attribute, label)`` of the layers a superstep of any
    engine is split into (a layer called inside another counts there)."""
    import repro_torch.core.engine_locking as el
    import repro_torch.core.engine_priority as ep
    import repro_torch.core.exec as ex
    from repro_torch.core.graph import SlicedEll
    return [(ep, "stable_top_k", "selection (top-k sort)"),
            (el, "stable_top_k", "selection (top-k sort)"),
            (el, "conflict_winners", "claim pass"),
            (el, "conflict_winners_windowed", "claim pass"),
            (SlicedEll, "window_bucket", "window width (.item())"),
            (ex, "gather_scopes", "scope gather"),
            (SlicedEll, "rows", "scope gather"),
            (ex, "route_batch_to_buckets", "routing"),
            (SlicedEll, "row_activation", "routing"),
            (ex, "_owner_rows", "routing"),
            (ex, "ell_spmv_bucketed", "kernel"),
            (ex, "ell_spmv_batched", "kernel"),
            (ex, "scatter_result", "write-back"),
            (ex, "consume_and_reschedule", "reschedule"),
            (ex, "refresh_syncs", "syncs")]


def sched_run(torch, ctx, label, graph, upd, syncs, sched, opts,
              count=True, **kw):
    """One full-size run through ``api.run``: the ell_spmv count set to 0
    just before and read just after, wall time, peak memory, logged and
    kept for the report.  A main-path run (``count``) adds its launches
    to the report's; a run that only compares two arms does not."""
    from repro_torch import api
    from repro_torch.kernels.ell_spmv import ell_spmv
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ell_spmv.launches = 0
    t0 = time.perf_counter()
    res = api.run(graph, upd, syncs=syncs, scheduler=sched,
                  device=ctx["dev"], **opts, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ell_spmv.launches
    peak = torch.cuda.max_memory_allocated()
    if count:
        ctx["launches"]["ell_spmv"] += launches
    eng = res.engine
    shape = eng.resolve_dispatch(opts.get("k_select",
                                          opts.get("max_pending", 0))
                                 or graph.n_vertices)
    ms = 1e3 * wall / max(res.superstep, 1)
    log(f"{label}: {res.superstep} supersteps, {res.n_updates} updates, "
        f"drained {not res.active_any}, {wall:.3f} s ({ms:.2f} "
        f"ms/superstep), launch shape {shape}, ell_spmv launches "
        f"{launches}, peak device memory {peak / 2**30:.2f} GiB")
    ctx.setdefault("sched_runs", []).append(dict(
        label=label, supersteps=res.superstep, updates=res.n_updates,
        seconds=wall, ms_per_superstep=ms, launches=launches,
        peak_gib=peak / 2**30))
    return res, launches


class Phase(NamedTuple):
    """One phase as ``capture_phases`` saw it."""
    ids: object            # the executed ids
    globals: dict          # the sync values the phase read
    v_before: dict         # vertex and edge data before and after
    e_before: dict
    v_after: dict
    e_after: dict


def capture_phases(ex, keep):
    """Spy on ``apply_batch``: a ``Phase`` for each of the last ``keep``
    phases (tensors are replaced, never written in place, so references
    suffice), and the count of executed ids of every phase.  Returns the
    two lists it fills and a function that removes the spy."""
    phases, counts, real = [], [], ex.apply_batch

    def spy(struct, update_fn, carry, ids, valid, globals_, *a, **k):
        out = real(struct, update_fn, carry, ids, valid, globals_, *a, **k)
        done = ids[valid & carry[2][ids.long()]]
        counts.append(done.numel())
        phases.append(Phase(done, globals_, carry[0], carry[1], out[0],
                            out[1]))
        del phases[:-keep]
        return out
    ex.apply_batch = spy
    return phases, counts, lambda: setattr(ex, "apply_batch", real)


def sample_ids(torch, ids, rng):
    """At most ``CHECKED_ROWS`` of a phase's executed ids."""
    if ids.numel() <= CHECKED_ROWS:
        return ids
    pick = rng.choice(ids.numel(), CHECKED_ROWS, replace=False)
    return ids[torch.from_numpy(pick).to(ids.device)]


def check_coem_rows(np, torch, graph, phases, rng):
    """Rows of the last superstep recomputed in float64 on the host from
    the data before their phase (the weighted mix, the normalization,
    the seed clamp); up to CHECKED_ROWS of each phase.  Returns
    ``(rows checked, max |diff|)``."""
    count = graph.edge_data["count"]
    seed = graph.vertex_data["is_seed"]
    worst, checked = 0.0, 0
    for ph in phases:
        if ph.ids.numel() == 0:
            continue
        ids, before, after = sample_ids(torch, ph.ids, rng), ph.v_before, \
            ph.v_after
        r = graph.struct_rows(ids)
        w = torch.where(r.nbr_mask, count[r.edge_ids.long()], 0.0)
        w = w.cpu().numpy().astype(np.float64)
        pn = before["p"][r.nbrs.long()].cpu().numpy().astype(np.float64)
        mix = np.einsum("sd,sdt->st", w, pn)
        new = mix / np.maximum(w.sum(1), 1e-9)[:, None]
        new = new / np.maximum(new.sum(1), 1e-9)[:, None]
        own = before["p"][ids.long()].cpu().numpy().astype(np.float64)
        new = np.where(seed[ids.long()].cpu().numpy()[:, None] > 0, own, new)
        got = after["p"][ids.long()].cpu().numpy().astype(np.float64)
        worst = max(worst, float(np.abs(got - new).max()))
        checked += ids.numel()
    return checked, worst


def check_lbp_rows(np, torch, graph, phases, rng):
    """Rows of the last superstep recomputed in float64 on the host from
    the data and the GMM centroids before their phase: the unary terms,
    the outgoing messages (the cavity, the Potts logsumexp, the
    normalization) and the normalized belief; up to CHECKED_ROWS of each
    phase.  Returns ``(rows checked, max |diff| / scale)``, the scale
    being at least 1 and the largest input of each value (the unary term
    itself, a slot's cavity, a row's belief)."""
    psi = -COSEG_BETA * (1.0 - np.eye(COSEG_LABELS))
    host = lambda t: t.cpu().numpy().astype(np.float64)
    rel = lambda got, want, scale: np.abs(got - want) / np.maximum(1.0,
                                                                   scale)

    def lse(a, axis):
        top = a.max(axis, keepdims=True)
        return top + np.log(np.exp(a - top).sum(axis, keepdims=True))
    worst, checked = 0.0, 0
    for ph in phases:
        if ph.ids.numel() == 0:
            continue
        ids = sample_ids(torch, ph.ids, rng)
        v = ids.long()
        r = graph.struct_rows(ids)
        e = r.edge_ids.long()
        mask = r.nbr_mask.cpu().numpy()[..., None]
        src = r.is_src.cpu().numpy()[..., None]
        if "gmm" in ph.globals:
            feat, mu = host(ph.v_before["feat"][v]), host(ph.globals["gmm"])
            unary = -COSEG_GAMMA * ((feat[:, None] - mu[None]) ** 2).sum(-1)
        else:
            unary = host(ph.v_before["unary"][v])
        m01, m10 = (host(ph.e_before[k][e]) for k in ("msg01", "msg10"))
        inc = np.where(mask, np.where(src, m10, m01), 0.0)     # [B, D, K]
        belief = unary + inc.sum(1)
        cavity = belief[:, None, :] - inc
        out = lse(cavity[..., :, None] + psi, 2)[..., 0, :]    # [B, D, K]
        out = out - lse(out, -1)
        a01, a10 = (host(ph.e_after[k][e]) for k in ("msg01", "msg10"))
        d_msg = np.where(mask, rel(np.where(src, a01, a10), out, np.abs(
            cavity).max(-1, keepdims=True)), 0.0)
        d_bel = rel(host(ph.v_after["belief"][v]), belief - lse(belief, -1),
                    np.abs(belief).max(-1, keepdims=True))
        d_un = rel(host(ph.v_after["unary"][v]), unary, np.abs(unary))
        worst = max(worst, float(d_msg.max()), float(d_bel.max()),
                    float(d_un.max()))
        checked += ids.numel()
    return checked, worst


def phase_sched_main(torch, ctx):
    """The full-size runs of the new engines: CC on the Zipf graph under
    four engines, CoEM and CoSeg LBP, counted, checked and broken down."""
    import numpy as np

    import repro_torch.core.exec as ex
    from repro_torch.apps import cc, coem, lbp
    layers = scheduler_layers()
    rng = np.random.default_rng(0)

    g = ctx["cc_graph"]
    upd = cc.make_update()
    t0 = time.perf_counter()
    truth = cc.reference_components(ctx["zipf_edges"], FULL_N)
    log(f"union-find on the host: {len(np.unique(truth))} components, "
        f"{time.perf_counter() - t0:.1f} s")
    ctx["cc_truth"] = truth
    for label, sched, opts in sched_cases(WINDOW):
        if label == "priority fifo":
            continue
        res, _ = sched_run(torch, ctx, f"CC {label}", g, upd, (), sched,
                           opts, max_supersteps=CC_MAX_SUPERSTEPS)
        labels = res.vertex_data["label"].cpu().numpy()
        if res.active_any or not np.array_equal(labels, truth):
            raise AssertionError(f"CC {label}: not drained or "
                                 f"{int((labels != truth).sum())} labels "
                                 "differ from union-find")
        report_superstep(torch, res.engine, layers)

    ner = ctx["ner"]
    g, upd, syncs = coem.build(ner, eps=COEM_EPS)
    seeds_only = coem.label_accuracy(ner, g.vertex_data)
    for label, sched, opts, kw in (
            ("chromatic", "chromatic", {}, {"max_supersteps": COEM_SWEEPS}),
            ("priority", "priority", {"k_select": WINDOW},
             {"num_supersteps": COEM_WINDOW_STEPS}),
            ("locking", "locking", {"max_pending": WINDOW},
             {"num_supersteps": COEM_WINDOW_STEPS})):
        phases, _, unspy = capture_phases(ex, keep=2)
        try:
            res, launches = sched_run(torch, ctx, f"CoEM {label}", g, upd,
                                      syncs, sched, opts, **kw)
        finally:
            unspy()
        last = phases[-res.engine.n_phases:]
        checked, worst = check_coem_rows(np, torch, g, last, rng)
        p = res.vertex_data["p"].cpu().numpy().astype(np.float64)
        pc = np.clip(p, 1e-9, 1.0)
        h = float(-(pc * np.log(pc)).sum(1).mean())
        sync = float(res.globals["entropy"])
        acc = coem.label_accuracy(ner, res.vertex_data)
        log(f"CoEM {label}: {checked} rows of the last superstep against "
            f"float64: max |diff| {worst:.2e} (limit {COEM_HOST_TOL:.0e}); "
            f"entropy sync {sync:.7f} vs float64 {h:.7f} (|diff| "
            f"{abs(sync - h):.2e}); accuracy {acc:.4f} vs seeds alone "
            f"{seeds_only:.4f}")
        if launches <= 0:
            raise AssertionError(f"CoEM {label} never launched ell_spmv")
        if worst > COEM_HOST_TOL or abs(sync - h) > COEM_HOST_TOL:
            raise AssertionError(f"CoEM {label}: off float64")
        if not acc > seeds_only or not np.isfinite(p).all():
            raise AssertionError(f"CoEM {label}: accuracy {acc} does not "
                                 f"beat the seeds' {seeds_only}")
        if sched == "chromatic" and res.active_any:
            raise AssertionError("CoEM chromatic did not converge")
        if sched == "chromatic":       # phase 16's MapReduce CoEM runs as long
            ctx["coem_chromatic"] = dict(
                supersteps=res.superstep, accuracy=acc,
                ms_per_superstep=ctx["sched_runs"][-1]["ms_per_superstep"])
        report_superstep(torch, res.engine, layers)
        phases.clear()
    # the dense arm at the window's size: bitwise the kernel arm (a
    # comparison, so its launches are not the main path's)
    outs = [sched_run(torch, ctx, f"CoEM priority use_kernel={k}", g, upd,
                      syncs, "priority", {"k_select": WINDOW}, count=False,
                      num_supersteps=COEM_DENSE_STEPS, use_kernel=k)[0]
            for k in (True, False)]
    if not torch.equal(outs[0].vertex_data["p"], outs[1].vertex_data["p"]):
        raise AssertionError("CoEM priority: kernel arm != dense arm")
    log("CoEM priority: kernel arm == dense arm bitwise at full size")
    del outs

    prob = ctx["coseg"]
    g, upd, syncs = lbp.build(prob, beta=COSEG_BETA, gamma=COSEG_GAMMA,
                              eps=COSEG_EPS)
    unary = float((g.vertex_data["unary"].argmax(1).cpu().numpy()
                   == prob.true_labels).mean())
    # every vertex at priority 1 puts the lowest 32,768 ids in the window,
    # where the min-id rule lets few win; priorities drawn from the seed
    # scatter the first window over the frames
    drawn = rng.random(g.n_vertices).astype(np.float32)
    for label, sched, opts, steps, prio in (
            ("locking", "locking", {"max_pending": WINDOW},
             COSEG_LOCKING_STEPS, None),
            ("locking, drawn priorities", "locking",
             {"max_pending": WINDOW}, COSEG_LOCKING_STEPS, drawn),
            ("chromatic", "chromatic", {}, COSEG_SWEEPS, None)):
        phases, counts, unspy = capture_phases(ex, keep=2)
        try:
            res, _ = sched_run(torch, ctx, f"CoSeg LBP {label}", g, upd,
                               syncs, sched, opts, num_supersteps=steps,
                               priority=prio)
        finally:
            unspy()
        n_ph = res.engine.n_phases
        per_step = [sum(counts[i: i + n_ph])
                    for i in range(0, len(counts), n_ph)]
        checked, worst = check_lbp_rows(np, torch, g, phases[-n_ph:],
                                        rng)
        b = res.vertex_data["belief"].cpu().numpy().astype(np.float64)
        feat = res.vertex_data["feat"].cpu().numpy().astype(np.float64)
        pr = np.exp(b - b.max(1, keepdims=True))
        pr /= pr.sum(1, keepdims=True)
        gmm = (pr.T @ feat) / np.maximum(pr.sum(0), 1e-6)[:, None]
        err = float(np.abs(res.globals["gmm"].cpu().numpy() - gmm).max())
        acc = lbp.label_accuracy(prob, res.vertex_data)
        log(f"CoSeg LBP {label}: updates a superstep {per_step}")
        log(f"CoSeg LBP {label}: {checked} rows of the last superstep "
            f"against float64 (unary, messages, belief): max |diff| / "
            f"scale {worst:.2e} (limit {LBP_HOST_TOL:.0e}); "
            f"accuracy {acc:.4f} "
            f"vs unary only {unary:.4f}; GMM sync vs float64 max |diff| "
            f"{err:.2e} (limit {GMM_HOST_TOL:.0e})")
        if not checked or worst > LBP_HOST_TOL:
            raise AssertionError(f"CoSeg LBP {label}: {checked} rows "
                                 f"checked, off float64 by {worst}")
        if not np.isfinite(b).all() or acc < unary or err > GMM_HOST_TOL:
            raise AssertionError(f"CoSeg LBP {label}: accuracy {acc} < "
                                 f"{unary} or GMM off by {err}")
        report_superstep(torch, res.engine, layers, priority=prio)


# ----------------------------------------------------------------------
# Phases 14-16: hub splitting, Gibbs, BPTF and the MapReduce baselines
# ----------------------------------------------------------------------

# the split Zipf graphs: hub_split=True (default_w_cap: 64) and w_cap=16
SPLIT_CAPS = (None, 16)
SPLIT_PARITY_CAP = 8           # phase 15's 2k graph
# Gibbs: Ising on the CoSeg grid at the reference test's beta and field
GIBBS_BETA, GIBBS_FIELD = 0.35, 0.2
GIBBS_SWEEPS, GIBBS_BURN_IN = 50, 10
# the 4-cycle against its exact marginals: the reference test runs one
# chain 4,000 sweeps (3,900 samples a vertex after its burn-in of
# 100); here 128 disjoint copies run 300 sweeps each (25,600 samples
# a vertex of the cycle), in one graph: a sweep costs the same host
# time at 4 or 512 vertices, and 4,000 of them took 55 s
GIBBS_CHAINS, GIBBS_CHAIN_SWEEPS = 128, 300
# a draw is compared where the float32 sigmoid cannot flip it: jax's and
# torch's round a few inputs in a million one ulp (6e-8) apart
GIBBS_CLEAR = 1e-6
# BPTF at phase 7's ratings: T = 64 time bins (the paper gives none);
# noise 0.02 keeps the reference test's noise-to-signal ratio (0.05 at
# d = 4, where a rating's RMS is ~0.5, is 0.02 at d = 20's ~0.22); lam
# 0.002 keeps lam * d = 0.04 << 1 (see ALS_LAM)
BPTF_TIMES, BPTF_NOISE, BPTF_LAM = 64, 0.02, 0.002
BPTF_SUPERSTEPS = 10
BPTF_CHECKED_MOVIES = 1000
MR_ITERS = 10                  # MapReduce ALS: phase 7's 10 sweeps
MR_RMSE_TOL = 1e-4             # against chromatic ALS, movies first
MR_COEM_ACC_TOL = 0.05         # the reference test's gate


def np_threefry2x32(np, k1, k2, x1, x2):
    """Threefry-2x32 (20 rounds, Salmon et al. 2011) in numpy uint32,
    which wraps on overflow: the host's own copy of the hash JAX keys
    its random numbers with, to check the port's torch version."""
    rot = ((13, 15, 26, 6), (17, 29, 16, 24))
    u = np.uint32
    k1, k2, x1, x2 = (np.asarray(a, dtype=u) for a in (k1, k2, x1, x2))
    ks = (k1, k2, k1 ^ k2 ^ u(0x1BD11BDA))
    x1, x2 = x1 + ks[0], x2 + ks[1]
    for i in range(5):
        for r in rot[i % 2]:
            x1 = x1 + x2
            x2 = ((x2 << u(r)) | (x2 >> u(32 - r))) ^ x1
        x1 = x1 + ks[(i + 1) % 3]
        x2 = x2 + ks[(i + 2) % 3] + u(i + 1)
    return x1, x2


def np_split_uniform(np, keys):
    """``jax.random.split`` (partitionable: counters (0, 0) and (0, 1))
    of ``[n, 2]`` uint32 keys and the float32 ``uniform`` of the second
    key: ``(new keys, uniforms)``."""
    z = np.zeros(len(keys), np.uint32)
    a1, a2 = np_threefry2x32(np, keys[:, 0], keys[:, 1], z, z)
    b1, b2 = np_threefry2x32(np, keys[:, 0], keys[:, 1], z, z + 1)
    w1, w2 = np_threefry2x32(np, b1, b2, z, z)
    bits = ((w1 ^ w2) >> np.uint32(9)) | np.uint32(0x3F800000)
    return (np.stack([a1, a2], 1),
            bits.view(np.float32) - np.float32(1.0))


def segment_bound(y, offsets):
    """``(ms, "bytes" or "operations")``: the least time for
    ``segment_sum_csr(y, offsets)`` on the card, the larger of the bytes
    it must move (y's rows inside the segments, the offsets, the output)
    over the HBM rate and one add an input element over the float32
    rate."""
    n_rows = offsets.numel() - 1
    used = int(offsets[-1])
    feat = y[0].numel() if y.shape[0] else 0
    elt = y.element_size()
    nbytes = (used * feat * elt + offsets.numel() * offsets.element_size()
              + n_rows * feat * elt)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, used * feat / F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def segment_case(torch, label, y, offsets, flush, reps=20, plain_reps=2):
    """``segment_sum_csr`` on ``(y, offsets)`` against its plain version
    (bitwise), timed beside it, ``index_add_`` of the same rows (the
    library yardstick, timed only) and the bound: the bytes it must move
    (y's rows inside the segments, the offsets, the output) over the HBM
    rate, against one add an input element over the float32 rate."""
    from repro_torch.kernels.segment_combine import (segment_sum_csr,
                                                     segment_sum_csr_plain)
    out = segment_sum_csr(y, offsets)
    plain = segment_sum_csr_plain(y, offsets)
    torch.cuda.synchronize()
    mism = bits_differ(torch, out, plain)
    err = float((out.float() - plain.float()).abs().max()) if out.numel() \
        else 0.0
    if mism:
        raise AssertionError(f"{label}: {mism} elements differ from the "
                             f"plain version (max {err})")
    n_rows = offsets.numel() - 1
    counts = (offsets[1:] - offsets[:-1]).long()
    used = int(offsets[-1])
    seg = torch.repeat_interleave(torch.arange(n_rows, device=y.device),
                                  counts)
    head = y[:used]
    lib = lambda: torch.zeros(out.shape, dtype=y.dtype,
                              device=y.device).index_add_(0, seg, head)
    lib_err = float((lib().float() - out.float()).abs().max()) \
        if out.numel() else 0.0
    ms, call_ms = time_cuda(torch, lambda: segment_sum_csr(y, offsets), reps,
                            flush)
    plain_ms, _ = time_cuda(torch, lambda: segment_sum_csr_plain(y, offsets),
                            plain_reps, flush)
    lib_ms, _ = time_cuda(torch, lib, reps, flush)
    feat = out[0].numel() if out.numel() else 0
    bms, by = segment_bound(y, offsets)
    log(f"{label}: y [{y.shape[0]}, {feat}] into {n_rows} segments (longest "
        f"{int(counts.max()) if n_rows else 0}): kernel {ms:.4f} ms "
        f"({call_ms:.4f} with the host), plain {plain_ms:.4f}, index_add_ "
        f"{lib_ms:.4f} (max |diff| {lib_err:.2e}), bound {bms:.4f} ({by}; "
        f"kernel / bound {ms / bms:.2f}), mismatches 0")
    return dict(label=label, rows=n_rows, feat=feat, ms=ms, call_ms=call_ms,
                plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms,
                bound_by=by, max_abs_err=err)


def segment_stress(torch, dev, gen, flush):
    """The kernel's edge cases against its plain version, bitwise:
    empty segments, segments longer than a stage, sentinel rows past the
    last segment, -0.0 inputs (a segment of them sums to +0.0), feature
    counts that are not a multiple of 4, bf16 input, spans and arrays
    whose first byte is not 16-byte aligned, segments whose rows cross
    stage boundaries, a tile count that does not divide the segments,
    tiles with no rows, int32 and int64 offsets.  The case with a
    segment of 2^20 rows is held against the host's serial sum
    (``segment_sum_csr_serial``, the same adds; the plain version would
    loop over 2^20 positions).  It and the 5,000-row case are timed: a
    segment of L rows costs L dependent adds from shared memory."""
    from repro_torch.kernels.segment_combine import (segment_sum_csr,
                                                     segment_sum_csr_plain,
                                                     segment_sum_csr_serial)
    cases = []
    # (label, n_rows, feat, longest, tail, empty, dtype, offsets' dtype,
    #  first row, rows of x cut off its front, largest other segment)
    table = (
        ("empty segments", 4000, (4,), 5, 0, True, torch.float32,
         torch.int64, 0, 0, 5),
        ("a segment of 5,000 rows", 300, (4,), 5000, 0, False,
         torch.float32, torch.int64, 0, 0, 5),
        ("sentinel tail", 3000, (32,), 5, 1000, False, torch.float32,
         torch.int64, 0, 0, 5),
        ("-0.0 inputs", 3000, (5,), 5, 0, False, torch.float32, torch.int64,
         0, 0, 5),
        ("F = 7", 3000, (7,), 5, 0, False, torch.float32, torch.int64, 0, 0,
         5),
        ("F = 1", 100_000, (1,), 5, 0, False, torch.float32, torch.int64, 0,
         0, 5),
        ("bf16, F = 20", 3000, (20,), 5, 17, False, torch.bfloat16,
         torch.int64, 0, 0, 5),
        ("a segment of 2^20 rows, F = 1", 64, (1,), 1 << 20, 0, False,
         torch.float32, torch.int64, 0, 0, 5),
        ("a segment longer than a stage, F = 400", 16, (400,), 100, 0,
         False, torch.float32, torch.int64, 0, 0, 5),
        ("unaligned spans, F = 1, odd offsets", 50_001, (1,), 5, 3, False,
         torch.float32, torch.int32, 3, 1, 5),
        ("unaligned spans, F = 7, odd offsets", 5_001, (7,), 5, 3, False,
         torch.float32, torch.int64, 1, 3, 5),
        ("unaligned spans, bf16 F = 20, odd offsets", 3_001, (20,), 5, 1,
         False, torch.bfloat16, torch.int32, 5, 1, 5),
        ("segments across stages, F = 1", 20_000, (1,), 2000, 0, False,
         torch.float32, torch.int64, 0, 0, 300),
        ("segments across stages, F = 32", 2_000, (32,), 700, 0, False,
         torch.float32, torch.int32, 0, 0, 200),
        ("n_rows not a multiple of the tile, F = 1", 10_007, (1,), 5, 0,
         False, torch.float32, torch.int32, 0, 0, 5),
        ("all-empty tiles, F = 1", 10_000, (1,), 0, 0, True, torch.float32,
         torch.int64, 0, 0, 5),
        ("int32 offsets, F = 32", 4_000, (32,), 5, 0, False, torch.float32,
         torch.int32, 0, 0, 5),
        ("sentinel tail, unaligned end, F = 1", 3_001, (1,), 5, 3, False,
         torch.float32, torch.int32, 0, 0, 5),
    )
    for (label, n_rows, feat, longest, tail, empty, dtype, off_dtype, first,
         cut, most) in table:
        counts = torch.randint(0, most + 1, (n_rows,), generator=gen,
                               device=dev)
        if empty:
            counts[::2] = 0
        if label.startswith("all-empty"):
            counts[:-10] = 0
        counts[n_rows // 2] = longest
        offsets = torch.zeros(n_rows + 1, dtype=torch.int64, device=dev)
        offsets[1:] = torch.cumsum(counts, 0)
        offsets += first
        n_src = int(offsets[-1]) + tail
        base = torch.randn((n_src + cut,) + feat, generator=gen,
                           device=dev).to(dtype)
        y = base[cut:]             # x's first byte not 16-byte aligned
        if cut:
            assert y.data_ptr() % 16, label
        if label == "-0.0 inputs":
            y[torch.rand(y.shape, generator=gen, device=dev) < 0.5] = -0.0
            y[int(offsets[1]):int(offsets[2])] = -0.0
        offsets = offsets.to(off_dtype)
        got = segment_sum_csr(y, offsets)
        reference = (segment_sum_csr_serial if longest > 5000
                     else segment_sum_csr_plain)
        want = reference(y, offsets).to(dev)
        torch.cuda.synchronize()
        mism = bits_differ(torch, got, want)
        if mism:
            raise AssertionError(f"segment stress {label}: {mism} elements "
                                 "differ from the plain version")
        if label == "-0.0 inputs" and bool(torch.signbit(got[1]).any()):
            raise AssertionError("a segment of -0.0 did not sum to +0.0")
        if longest >= 5000:
            ms, _ = time_cuda(torch, lambda: segment_sum_csr(y, offsets), 3,
                              flush)
            log(f"segment stress {label}: {ms:.4f} ms, "
                f"{1e6 * ms / longest:.3f} ns a row of the long segment")
        cases.append(label)
    log(f"segment_combine stress cases, bitwise against plain: {cases}")


def setup_split(torch, ctx):
    """Phases 14-16's problems: phase 4's Zipf edges split twice (with
    phase 4's colors), Ising on the CoSeg grid, BPTF on phase 7's rating
    pairs, and phase 7's ALS problem back on the card."""
    import dataclasses

    import numpy as np

    from repro_torch.apps import bptf, gibbs, pagerank
    from repro_torch.core.graph import grid_edges_3d
    dev = ctx["dev"]
    split = {}
    for cap in SPLIT_CAPS:
        t0 = time.perf_counter()
        g, upd, syncs = pagerank.build(ctx["zipf_edges"], FULL_N, eps=EPS,
                                       hub_split=True, w_cap=cap,
                                       colors=ctx["zipf_colors"], device=dev)
        torch.cuda.synchronize()
        ell = g.ell
        nch = (ell.vrow_offset[1:] - ell.vrow_offset[:-1]).cpu().numpy()
        label = f"w_cap={ell.w_cap}" + (" (default)" if cap is None else "")
        log(f"split Zipf graph, {label}: {ell.n_virtual} virtual rows, "
            f"{int((nch > 1).sum())} hubs, at most {ell.n_chunks_max} "
            f"chunks, widths {ell.widths}, scope widths {ell.scope_widths}, "
            f"{ell.padded_slots} sliced slots; host set-up "
            f"{time.perf_counter() - t0:.1f} s")
        split[label] = (g, upd, syncs)
    ctx["split"] = split

    t0 = time.perf_counter()
    nx, ny, nz = COSEG_SHAPE
    n, edges = grid_edges_3d(nx, ny, nz)
    idx = np.arange(n)
    parity = ((idx // (ny * nz) + (idx // nz) % ny + idx % nz) % 2).astype(
        np.int32)
    ising = gibbs.ising_problem(edges, n, GIBBS_BETA, GIBBS_FIELD, seed=0,
                                colors=parity, device=dev)
    torch.cuda.synchronize()
    log(f"Ising on the CoSeg grid {COSEG_SHAPE}: {n} vertices, "
        f"{ising.graph.n_edges} edges, {ising.graph.n_colors} colors (the "
        f"grid's parity); host set-up {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    als_host = ctx["als_host"]
    pairs = als_host.pairs
    nu, nm, d = als_host.n_users, als_host.n_movies, als_host.d
    rng = np.random.default_rng(1)
    u = rng.normal(size=(nu, d)) / d ** 0.5
    v = rng.normal(size=(nm, d)) / d ** 0.5
    tt = 1.0 + 0.1 * rng.normal(size=(BPTF_TIMES, d))
    ti = rng.integers(0, BPTF_TIMES, len(pairs))
    ratings = np.empty(len(pairs), np.float32)
    for s in range(0, len(pairs), 1 << 22):
        p = pairs[s:s + (1 << 22)]
        ratings[s:s + len(p)] = (
            np.einsum("ed,ed->e", u[p[:, 0]] * tt[ti[s:s + len(p)]],
                      v[p[:, 1]])
            + BPTF_NOISE * rng.normal(size=len(p)))
    w0 = rng.normal(size=(nu + nm + BPTF_TIMES, d)).astype(np.float32) * 0.1
    prob = bptf.problem_from_triples(
        nu, nm, BPTF_TIMES, d, pairs[:, 0], pairs[:, 1], ti, ratings, w0,
        BPTF_NOISE, colors=bptf.tripartite_coloring(nu, nm, BPTF_TIMES),
        device=dev)
    torch.cuda.synchronize()
    log(f"BPTF: {nu} users x {nm} movies x {BPTF_TIMES} time bins, d={d}, "
        f"{prob.graph.n_edges} edges ({len(pairs)} ratings), max degree "
        f"{prob.graph.max_deg}, {prob.graph.n_colors} colors; host set-up "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    als_dev = dataclasses.replace(als_host, graph=als_host.graph.to(dev))
    torch.cuda.synchronize()
    log(f"phase 7's ALS problem back on the card: "
        f"{time.perf_counter() - t0:.1f} s")
    ctx.update(ising=ising, bptf=prob, als_dev=als_dev)


def phase_split_kernels(torch, ctx):
    """B2 against its plain version at the main path's shapes, and B1's
    split sweep and its windows at W <= w_cap."""
    import numpy as np

    from repro_torch.baselines import mapreduce as mr
    dev = ctx["dev"]
    gen = torch.Generator(device=dev).manual_seed(14)
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    seg_cases, b1_cases = [], []
    for label, (g, _, _) in ctx["split"].items():
        ell = g.ell
        for feat in (1, 32):
            y = torch.rand((ell.n_virtual, feat), generator=gen, device=dev)
            seg_cases.append(segment_case(
                torch, f"owner combine {label} F={feat}", y, ell.vrow_offset,
                flush))
            s = ell.scope_widths[-1] // ell.w_cap
            y = torch.rand((WINDOW * s, feat), generator=gen, device=dev)
            offsets = torch.arange(WINDOW + 1, device=dev) * s
            seg_cases.append(segment_case(
                torch, f"window chunk combine {label} s={s} F={feat}", y,
                offsets, flush))
        del y
        w_edge = g.edge_data["w"]
        x1 = torch.rand((g.n_vertices, 1), generator=gen, device=dev) + 0.5
        b1_cases.append(sweep_case(torch, f"split PageRank sweep {label} F=1",
                                   ell, w_edge, x1, gen, flush))
        for width in ell.widths:
            b1_cases.append(window_case(
                torch, f"split Zipf window {label} F=1 W={width}", ell, width,
                w_edge, x1, gen, flush))
    # MapReduce ALS's reduce over phase 7's ratings, from its initial
    # factors: the movie job's [Ne, d*d] outer products and [Ne, d]
    # rating-weighted factors, then the user job's
    prob = ctx["als_dev"]
    d = prob.d
    w = prob.graph.vertex_data["w"]
    w_users, w_movies = w[:prob.n_users], w[prob.n_users:]
    for (shuffle, r), w_src, side in zip(mr.als_jobs(prob, dev),
                                         (w_users, w_movies),
                                         ("movies", "users")):
        msg = w_src.index_select(0, shuffle.src)
        outer = (msg[:, :, None] * msg[:, None, :]).reshape(-1, d * d)
        seg_cases.append(segment_case(
            torch, f"MapReduce ALS reduce A to {side}", outer,
            shuffle.offsets, flush, reps=5))
        del outer
        seg_cases.append(segment_case(
            torch, f"MapReduce ALS reduce b to {side}",
            (msg * r[:, None]).contiguous(), shuffle.offsets, flush))
        del msg
    release(torch, ctx)
    segment_stress(torch, dev, gen, flush)
    ctx["split_seg_cases"] = seg_cases
    ctx["split_b1_cases"] = b1_cases
    unsplit = {c["label"]: c for c in ctx.get("sched_kernel_cases", [])}
    log("split B1 windows beside phase 11's unsplit ones (kernel ms): "
        + ", ".join(f"W={c['width']} {c['ms']:.4f}" for c in b1_cases
                    if c["width"]) + (f"; unsplit: " + ", ".join(
                        f"W={c['width']} {c['ms']:.4f}"
                        for c in unsplit.values()
                        if c["label"].startswith("Zipf window"))
                    if unsplit else ""))
    ctx["launches"].setdefault("segment_combine", 0)


def phase_split_parity(torch, ctx):
    """Small graphs, GPU against CPU: split PageRank in every arm, CC
    split == unsplit == union-find, an integer aggregator split ==
    unsplit, Gibbs keys and uniforms and the 4-cycle's exact marginals,
    BPTF and the MapReduce baselines."""
    import numpy as np

    from repro_torch import api
    from repro_torch.apps import als, bptf, cc, coem, gibbs, pagerank
    from repro_torch.baselines import mapreduce as mr
    from repro_torch.core.graph import DataGraph, grid_edges_3d, zipf_edges
    from repro_torch.core.update import (Consistency, UpdateResult,
                                         aggregator_update)
    from repro_torch.kernels.segment_combine import segment_sum_csr
    dev = ctx["dev"]
    n = 2000
    edges = zipf_edges(n, alpha=2.0, max_deg=64, seed=1)
    g, upd, syncs = pagerank.build(edges, n, eps=EPS, w_cap=SPLIT_PARITY_CAP,
                                   device="cpu")
    arms = [(d, k) for d in ("bucket", "batch") for k in (True, False)]
    before = segment_sum_csr.launches
    for label, sched, opts in sched_cases(64):
        if label == "priority fifo":
            continue
        cpu = api.run(g, upd, syncs=syncs, scheduler=sched, device="cpu",
                      num_supersteps=PARITY_STEPS, **opts)
        for dispatch, use_kernel in arms:
            gpu = api.run(g, upd, syncs=syncs, scheduler=sched, device=dev,
                          num_supersteps=PARITY_STEPS, dispatch=dispatch,
                          use_kernel=use_kernel, **opts)
            if not torch.equal(gpu.vertex_data["rank"].cpu(),
                               cpu.vertex_data["rank"]) or (
                    gpu.n_updates != cpu.n_updates):
                raise AssertionError(f"split PageRank {label} {dispatch} "
                                     f"use_kernel={use_kernel}: GPU != CPU")
    launched = segment_sum_csr.launches - before
    log(f"2k Zipf split at w_cap={SPLIT_PARITY_CAP} "
        f"({g.ell.n_virtual} virtual rows): PageRank GPU == CPU bitwise "
        f"on chromatic, bsp, priority, locking x {{bucket, batch}} x "
        f"{{kernel, dense}}; segment_combine launches {launched}")
    if launched <= 0:
        raise AssertionError("the split runs never launched segment_combine")

    labels = {"label": np.arange(n, dtype=np.int32)}
    colors = g.colors.cpu().numpy()
    cc_graphs = [DataGraph.from_edges(n, edges, labels, device="cpu",
                                      **kw).with_colors(colors)
                 for kw in ({}, {"w_cap": SPLIT_PARITY_CAP})]
    truth = cc.reference_components(edges, n)
    for sched, opts in (("chromatic", {}), ("locking", {"max_pending": 64})):
        outs = [api.run(cg, cc.make_update(), scheduler=sched, device=dv,
                        **opts)
                for cg in cc_graphs for dv in (dev, "cpu")]
        for o in outs:
            if not np.array_equal(o.vertex_data["label"].cpu().numpy(),
                                  truth):
                raise AssertionError(f"CC {sched}: a run differs from "
                                     "union-find")
        if (outs[2].superstep, outs[2].n_updates) != (outs[3].superstep,
                                                      outs[3].n_updates):
            raise AssertionError(f"CC {sched} split: GPU counts != CPU's")
    log("2k Zipf CC: split == unsplit == union-find, GPU and CPU, on "
        "chromatic and locking")

    vals = np.random.default_rng(1).integers(-50, 50, n).astype(np.float32)

    def combine(scope, y):
        return UpdateResult(v_data={"val": scope.v_data["val"],
                                    "out": y[:, 0]})
    intsum = aggregator_update(
        lambda vd: vd["val"][..., None],
        lambda scope: torch.ones_like(scope.nbr_mask, dtype=torch.float32),
        combine, Consistency.EDGE, name="intsum")
    vd = {"val": vals, "out": np.zeros(n, np.float32)}
    int_graphs = [DataGraph.from_edges(n, edges, vd, device="cpu",
                                       **kw).with_colors(colors)
                  for kw in ({}, {"w_cap": 4})]
    outs = [api.run(ig, intsum, scheduler=sched, device=dev, dispatch=dsp,
                    use_kernel=k, num_supersteps=2, **opts)
            for ig in int_graphs
            for sched, opts in (("chromatic", {}),
                                ("priority", {"k_select": 64}))
            for dsp, k in arms]
    half = len(outs) // 2
    for a, b in zip(outs[:half], outs[half:]):
        if not torch.equal(a.vertex_data["out"], b.vertex_data["out"]):
            raise AssertionError("integer aggregator: split != unsplit")
    log("2k Zipf integer aggregator: split (w_cap=4) == unsplit bitwise "
        "on chromatic and priority in every arm")

    rng = np.random.default_rng(0)
    keys = torch.from_numpy(rng.integers(0, 2 ** 32, (1 << 20, 2),
                                         dtype=np.int64))
    a, b = gibbs.split(keys)
    ga, gb = gibbs.split(keys.to(dev))
    if not (torch.equal(ga.cpu(), a) and torch.equal(gb.cpu(), b)
            and torch.equal(gibbs.uniform(gb).cpu(), gibbs.uniform(b))):
        raise AssertionError("Gibbs: keys or uniforms on the GPU != CPU")
    want_k, want_u = np_split_uniform(np, keys.numpy().astype(np.uint32))
    if not (np.array_equal(a.numpy().astype(np.uint32), want_k)
            and np.array_equal(gibbs.uniform(b).numpy().view(np.uint32),
                               want_u.view(np.uint32))):
        raise AssertionError("Gibbs: keys or uniforms != the host's numpy "
                             "threefry")
    gn, gedges = grid_edges_3d(8, 16, 16)
    ising = gibbs.ising_problem(gedges, gn, GIBBS_BETA, GIBBS_FIELD, seed=0,
                                device="cpu")
    gg, gupd, _ = gibbs.build(ising, burn_in=0)
    sw_cpu = api.run(gg, gupd, scheduler="chromatic", num_supersteps=3,
                     device="cpu")
    sw_gpu = api.run(gg, gupd, scheduler="chromatic", num_supersteps=3,
                     device=dev)
    same_spin = float((sw_gpu.vertex_data["spin"].cpu()
                       == sw_cpu.vertex_data["spin"]).float().mean())
    if not (torch.equal(sw_gpu.vertex_data["key"].cpu(),
                        sw_cpu.vertex_data["key"])
            and torch.equal(sw_gpu.vertex_data["sweep"].cpu(),
                            sw_cpu.vertex_data["sweep"])):
        raise AssertionError("Gibbs sweeps: keys or counters GPU != CPU")
    cycle = np.asarray([[0, 1], [1, 2], [2, 3], [3, 0]])
    chains = np.concatenate([cycle + 4 * c for c in range(GIBBS_CHAINS)])
    t0 = time.perf_counter()
    small = gibbs.ising_problem(chains, 4 * GIBBS_CHAINS, GIBBS_BETA,
                                GIBBS_FIELD, seed=1, device="cpu")
    st = api.run(*gibbs.build(small, burn_in=100)[:2], scheduler="chromatic",
                 max_supersteps=GIBBS_CHAIN_SWEEPS, device=dev)
    # each vertex of the cycle: its samples pooled over the copies
    ones, n = (st.vertex_data[k].cpu().numpy().reshape(GIBBS_CHAINS, 4)
               .sum(0) for k in ("ones", "n"))
    emp = ones / np.maximum(n, 1.0)
    exact = gibbs.exact_marginals(cycle, 4, GIBBS_BETA, GIBBS_FIELD)
    gap = float(np.abs(emp - exact).max())
    log(f"Gibbs: 2^20 keys' splits and uniforms GPU == CPU == numpy "
        f"bitwise; 3 sweeps of a {gn}-vertex grid: keys and counters GPU "
        f"== CPU, spins equal on {same_spin:.6f}; the 4-cycle, "
        f"{GIBBS_CHAINS} copies {st.superstep} sweeps on the GPU "
        f"({time.perf_counter() - t0:.1f} s, {int(n.min())} samples a "
        f"vertex of the cycle): marginals {np.round(emp, 4).tolist()} vs "
        f"exact {np.round(exact, 4).tolist()}, max gap {gap:.4f} (limit "
        f"0.05)")
    if gap >= 0.05:
        raise AssertionError(f"Gibbs marginals off the exact ones by {gap}")

    prob = bptf.synthetic_bptf(30, 25, 5, d=4, density=0.3, noise=0.05,
                               device="cpu")
    bg, bupd, bsyncs = bptf.build(prob, lam=0.02)
    outs = [api.run(bg, bupd, syncs=bsyncs, scheduler="chromatic",
                    num_supersteps=30, device=dv) for dv in ("cpu", dev)]
    diff = float((outs[1].vertex_data["w"].cpu()
                  - outs[0].vertex_data["w"]).abs().max())
    rmse = [bptf.dataset_rmse(prob, o.vertex_data, o.globals) for o in outs]
    base = float(np.sqrt(np.mean(prob.ratings ** 2)))
    log(f"BPTF 30 x 25 x 5, d=4: GPU vs CPU factors max |diff| {diff:.2e} "
        f"(limit 1e-4: cuSOLVER's LU against LAPACK's), RMSE {rmse[1]:.6f} "
        f"vs {rmse[0]:.6f}, {rmse[1] / base:.3f} of the ratings' RMS "
        f"(limit 0.25)")
    if diff > 1e-4 or abs(rmse[1] - rmse[0]) > 1e-5 or rmse[1] >= 0.25 * base:
        raise AssertionError("BPTF: GPU off the CPU or not converged")

    aprob = als.synthetic_netflix(25, 20, d=3, density=0.4, noise=0.05,
                                  seed=4, device="cpu")
    cpu_out, cpu_stats = mr.als_mapreduce(aprob, 6, lam=0.02)
    gpu_out, gpu_stats = mr.als_mapreduce(on_device(aprob, dev), 6,
                                          lam=0.02)
    als_diff = max(float((gpu_out[k].cpu() - cpu_out[k]).abs().max())
                   for k in cpu_out)
    cprob = coem.synthetic_ner(120, 80, 3, mean_deg=8, seed_frac=0.15,
                               seed=1, device="cpu")
    c_cpu, _ = mr.coem_mapreduce(cprob, 30)
    c_gpu, _ = mr.coem_mapreduce(on_device(cprob, dev), 30)
    coem_diff = float((c_gpu["p"].cpu() - c_cpu["p"]).abs().max())
    log(f"MapReduce: ALS 25 x 20 (d=3, 6 iterations) GPU vs CPU max |diff| "
        f"{als_diff:.2e} (limit 1e-5), stats equal "
        f"{gpu_stats == cpu_stats}; CoEM 120 x 80 (30 iterations) max "
        f"|diff| {coem_diff:.2e} (limit 1e-6)")
    if als_diff > 1e-5 or coem_diff > 1e-6 or gpu_stats != cpu_stats:
        raise AssertionError("MapReduce: GPU off the CPU")


def on_device(problem, device):
    """``problem`` with its graph on ``device``."""
    import dataclasses
    return dataclasses.replace(problem, graph=problem.graph.to(device))


def split_counts(torch, fn):
    """``fn()`` with the ell_spmv, segment_combine and als_normal_eq
    counts set to 0 just before and read just after: ``(result, wall s,
    peak GiB, {kernel: launches})``, the launches added to the report's."""
    from repro_torch.kernels.als_normal_eq import als_normal_eq
    from repro_torch.kernels.ell_spmv import ell_spmv
    from repro_torch.kernels.segment_combine import segment_sum_csr
    counters = {"ell_spmv": ell_spmv, "segment_combine": segment_sum_csr,
                "als_normal_eq": als_normal_eq}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: c.launches for k, c in counters.items()}
    return out, wall, torch.cuda.max_memory_allocated() / 2**30, counts


def phase_split_main(torch, ctx):
    """Full size, counted: split PageRank (twice), split CC, Gibbs on the
    CoSeg grid, BPTF on phase 7's ratings, MapReduce ALS and CoEM."""
    import dataclasses

    import numpy as np

    import repro_torch.baselines.mapreduce as mr
    import repro_torch.core.exec as ex
    from repro_torch import api
    from repro_torch.apps import als, bptf, cc, coem, gibbs
    dev = ctx["dev"]
    total = ctx["launches"]

    def count(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    layers = pagerank_layers()
    for label, (g, upd, syncs) in ctx["split"].items():
        res, wall, peak, counts = split_counts(
            torch, lambda: api.run(g, upd, syncs=syncs, device=dev))
        count(counts)
        log(f"split PageRank {label}: {res.superstep} supersteps, "
            f"{res.n_updates} updates, {wall:.3f} s "
            f"({1e3 * wall / max(res.superstep, 1):.2f} ms/superstep), "
            f"launches {counts}, peak device memory {peak:.2f} GiB")
        if counts["ell_spmv"] <= 0 or counts["segment_combine"] <= 0:
            raise AssertionError(f"split PageRank {label} did not launch "
                                 "both kernels")
        check_pagerank(np, res, ctx["zipf_edges"], f"split PageRank {label}")
        if label.endswith("(default)"):
            ctx["split_host"] = g.to("cpu")   # phase 18 shards it again
        report_superstep(torch, res.engine, layers)

    g = next(iter(ctx["split"].values()))[0]
    # CC on the split graph's storage and colors
    cc_g = dataclasses.replace(g, vertex_data={
        "label": torch.arange(FULL_N, dtype=torch.int32, device=dev)},
        edge_data={})
    truth = ctx["cc_truth"]
    for label, sched, opts in (("chromatic", "chromatic", {}),
                               ("locking", "locking",
                                {"max_pending": WINDOW})):
        res, _ = sched_run(torch, ctx, f"split CC {label}", cc_g,
                           cc.make_update(), (), sched, opts,
                           max_supersteps=CC_MAX_SUPERSTEPS)
        labels = res.vertex_data["label"].cpu().numpy()
        if res.active_any or not np.array_equal(labels, truth):
            raise AssertionError(f"split CC {label}: not drained or "
                                 f"{int((labels != truth).sum())} labels "
                                 "differ from union-find")
        report_superstep(torch, res.engine, scheduler_layers())
    log("split CC: chromatic and locking equal union-find")
    release(torch, ctx, "split")
    del g, cc_g

    gibbs_main(torch, ctx, np, ex, api, gibbs, count)
    bptf_main(torch, ctx, np, api, bptf, count)

    prob = ctx["als_dev"]
    d = prob.d
    (out, stats), wall, peak, counts = split_counts(
        torch, lambda: mr.als_mapreduce(prob, MR_ITERS, lam=ALS_LAM))
    count(counts)
    # the run's wall holds the shuffle's set-up (two argsorts of the
    # ratings on the host); time the iterations alone on its jobs
    jobs, setup_s, _, _ = split_counts(torch, lambda: mr.als_jobs(prob, dev))
    w = prob.graph.vertex_data["w"]
    wu, wm = w[:prob.n_users], w[prob.n_users:]

    def iterate():
        state = (wu, wm)
        for _ in range(MR_ITERS):
            state = mr.als_mapreduce_iteration(*state, jobs, d, ALS_LAM)
    _, it_wall, _, _ = split_counts(torch, iterate)
    mr_ms = 1e3 * it_wall / MR_ITERS
    g = prob.graph.with_colors(1 - prob.graph.colors.cpu().numpy())
    chrom, c_wall, _, _ = split_counts(torch, lambda: api.run(
        g, als.make_update(d, lam=ALS_LAM, eps=0.0), device=dev,
        num_supersteps=MR_ITERS))
    chrom_ms = 1e3 * c_wall / MR_ITERS
    w_mr = torch.cat([out["w_users"], out["w_movies"]]).cpu().numpy()
    w_ch = chrom.vertex_data["w"].cpu().numpy()
    r64 = prob.ratings.astype(np.float64)
    rm_mr = rmse64(prob.pairs, r64, w_mr.astype(np.float64), prob.n_users)
    rm_ch = rmse64(prob.pairs, r64, w_ch.astype(np.float64), prob.n_users)
    ne = len(prob.pairs)
    log(f"MapReduce ALS: {MR_ITERS} iterations, {wall:.3f} s with the "
        f"shuffle's set-up ({setup_s:.3f} s), {mr_ms:.2f} ms an iteration "
        f"without it, launches {counts}, peak device memory {peak:.2f} "
        f"GiB; RMSE {rm_mr:.7f} vs chromatic ALS (movies first, eps=0) "
        f"{rm_ch:.7f} (|diff| {abs(rm_mr - rm_ch):.2e}, limit "
        f"{MR_RMSE_TOL:.0e}); largest factor difference "
        f"{float(np.abs(w_mr - w_ch).max()):.3e}; shuffled "
        f"{stats.bytes_shuffled_per_iter} bytes an iteration (formula "
        f"{2 * ne * (d + 1) * 4}); MapReduce / chromatic time "
        f"{mr_ms / chrom_ms:.2f} ({chrom_ms:.2f} ms a chromatic superstep)")
    if counts["segment_combine"] != 4 * MR_ITERS:
        raise AssertionError(f"MapReduce ALS: {counts['segment_combine']} "
                             f"segment_combine launches, not {4 * MR_ITERS}")
    if abs(rm_mr - rm_ch) > MR_RMSE_TOL or not np.isfinite(w_mr).all():
        raise AssertionError("MapReduce ALS off the chromatic run")
    if stats.bytes_shuffled_per_iter != 2 * ne * (d + 1) * 4:
        raise AssertionError("MapReduce ALS: shuffled bytes off the formula")
    mr_layers = [(mr, "segment_sum_csr", "reduce (segment_combine)"),
                 (torch.linalg, "solve_ex", "solve_ex (LU)")]
    report_run(torch, "MapReduce ALS iteration", mr_layers,
               lambda _: mr.als_mapreduce_iteration(wu, wm, jobs, d,
                                                    ALS_LAM),
               other="map (messages), host")
    ctx["mr_als"] = w_mr          # phase 18 holds MPI-style ALS to it
    del jobs, chrom, g
    release(torch, ctx, "als_dev")

    ner = ctx["ner"]
    chrom = ctx["coem_chromatic"]
    iters = chrom["supersteps"]
    (out, stats), wall, peak, counts = split_counts(
        torch, lambda: mr.coem_mapreduce(ner, iters))
    count(counts)
    acc = coem.label_accuracy(ner, out)
    jobs, setup_s, _, _ = split_counts(torch, lambda: mr.coem_jobs(ner, dev))
    p0 = ner.graph.vertex_data["p"][:ner.n_phrases]
    seeds = ner.graph.vertex_data["is_seed"][:ner.n_phrases] > 0

    def iterate():
        p = p0
        for _ in range(iters):
            p, _ = mr.coem_mapreduce_iteration(p, jobs, seeds, p0)
    _, it_wall, _, _ = split_counts(torch, iterate)
    ms = 1e3 * it_wall / max(iters, 1)
    log(f"MapReduce CoEM: {iters} iterations (chromatic CoEM's), {wall:.3f} "
        f"s with the shuffle's set-up ({setup_s:.3f} s), {ms:.2f} ms an "
        f"iteration without it, launches {counts}, peak device memory "
        f"{peak:.2f} GiB; accuracy {acc:.4f} vs chromatic "
        f"{chrom['accuracy']:.4f} (limit {MR_COEM_ACC_TOL}); shuffled "
        f"{stats.bytes_shuffled_per_iter} bytes an iteration; MapReduce / "
        f"chromatic time {ms / chrom['ms_per_superstep']:.2f}")
    if abs(acc - chrom["accuracy"]) >= MR_COEM_ACC_TOL:
        raise AssertionError("MapReduce CoEM's accuracy off chromatic's")
    report_run(torch, "MapReduce CoEM iteration", mr_layers[:1],
               lambda _: mr.coem_mapreduce_iteration(p0, jobs, seeds, p0),
               other="map (messages), normalize, host")


def gibbs_main(torch, ctx, np, ex, api, gibbs, count):
    """Gibbs on the CoSeg grid for GIBBS_SWEEPS sweeps; the last sweep's
    phases recomputed on the host."""
    prob = ctx["ising"]
    g, upd, _ = gibbs.build(prob, burn_in=GIBBS_BURN_IN)
    phases, _, unspy = capture_phases(ex, keep=g.n_colors)
    try:
        res, wall, peak, counts = split_counts(torch, lambda: api.run(
            g, upd, scheduler="chromatic", num_supersteps=GIBBS_SWEEPS,
            device=ctx["dev"]))
    finally:
        unspy()
    count(counts)
    log(f"Gibbs on {COSEG_SHAPE}: {res.superstep} sweeps, {res.n_updates} "
        f"updates, {wall:.3f} s ({1e3 * wall / res.superstep:.2f} ms/sweep),"
        f" launches {counts}, peak device memory {peak:.2f} GiB")
    checked, unclear, worst_u = 0, 0, 0
    for ph in phases[-g.n_colors:]:
        v = ph.ids.long()
        key0 = ph.v_before["key"][v]
        k_np = key0.cpu().numpy().astype(np.uint32)
        want_k, want_u = np_split_uniform(np, k_np)
        got_u = gibbs.uniform(gibbs.split(key0)[1]).cpu().numpy()
        if not np.array_equal(ph.v_after["key"][v].cpu().numpy().astype(
                np.uint32), want_k):
            raise AssertionError("Gibbs: new keys != the host's threefry")
        worst_u = max(worst_u, int((got_u.view(np.uint32)
                                    != want_u.view(np.uint32)).sum()))
        rows = g.struct_rows(ph.ids)
        spin0 = ph.v_before["spin"]
        s = torch.where(rows.nbr_mask, 2.0 * spin0[rows.nbrs.long()] - 1.0,
                        0.0).sum(1).cpu().numpy().astype(np.float64)
        p = 1.0 / (1.0 + np.exp(-2.0 * (GIBBS_BETA * s + GIBBS_FIELD)))
        u = want_u.astype(np.float64)
        clear = np.abs(u - p) > GIBBS_CLEAR
        got = ph.v_after["spin"][v].cpu().numpy()
        bad = int((got[clear] != (u < p)[clear]).sum())
        if bad:
            raise AssertionError(f"Gibbs: {bad} clear draws differ from the "
                                 "host's")
        checked += len(u)
        unclear += int((~clear).sum())
    if worst_u:
        raise AssertionError(f"Gibbs: {worst_u} uniforms != the host's")
    n_col = res.vertex_data["n"].cpu().numpy()
    marg = gibbs.marginals(res.vertex_data)
    log(f"Gibbs last sweep: {checked} draws against the host's numpy "
        f"threefry and float64 p: keys and uniforms bitwise, spins equal "
        f"where |u - p| > {GIBBS_CLEAR:.0e}, {unclear} draws within it "
        f"(not compared); samples a vertex {int(n_col.min())}.."
        f"{int(n_col.max())}; mean marginal {float(marg.mean()):.4f}")
    if not (n_col == GIBBS_SWEEPS - GIBBS_BURN_IN).all() or not (
            (marg >= 0) & (marg <= 1)).all():
        raise AssertionError("Gibbs: sample counts or marginals wrong")
    report_superstep(torch, res.engine, scheduler_layers())
    release(torch, ctx, "ising")


def bptf_main(torch, ctx, np, api, bptf, count):
    """BPTF at phase 7's ratings for BPTF_SUPERSTEPS supersteps, the time
    table and 1,000 movies' normal equations checked in float64."""
    import repro_torch.apps.bptf as bptf_mod
    import repro_torch.core.exec as ex
    prob = ctx["bptf"]
    g, upd, syncs = bptf.build(prob, lam=BPTF_LAM, eps=0.0)
    res, wall, peak, counts = split_counts(torch, lambda: api.run(
        g, upd, syncs=syncs, device=ctx["dev"],
        num_supersteps=BPTF_SUPERSTEPS))
    count(counts)
    log(f"BPTF: {res.superstep} supersteps, {res.n_updates} updates, "
        f"{wall:.3f} s ({1e3 * wall / res.superstep:.2f} ms/superstep), "
        f"launches {counts}, peak device memory {peak:.2f} GiB")
    if counts["als_normal_eq"] <= 0:
        raise AssertionError("BPTF never launched als_normal_eq")
    nu, nm, d = prob.n_users, prob.n_movies, prob.d
    w = res.vertex_data["w"].cpu().numpy()
    if not np.isfinite(w).all():
        raise AssertionError("BPTF factors are not finite")
    w64 = w.astype(np.float64)
    # the time vertices hold slots 0..T-1 in order, one a slot; the
    # movies of the last superstep read the table of the one before, equal
    # to this one: the time factors start at 1 and smoothing keeps them 1
    table = res.globals["time_factors"].cpu().numpy().astype(np.float64)
    want_table = w64[nu + nm:]
    t_err = float(np.abs(table - want_table).max())
    tri = prob.triples
    r64 = prob.ratings.astype(np.float64)
    se = 0.0
    for s in range(0, len(tri), 1 << 22):
        t = tri[s:s + (1 << 22)]
        pred = np.einsum("ed,ed->e", w64[t[:, 0]] * table[t[:, 2]],
                         w64[t[:, 1] + nu])
        se += float(np.sum((pred - r64[s:s + len(t)]) ** 2))
    rmse = (se / len(tri)) ** 0.5
    base = float(np.sqrt(np.mean(r64 ** 2)))
    order = np.argsort(tri[:, 1], kind="stable")
    starts = np.searchsorted(tri[order, 1], np.arange(nm + 1))
    worst = 0.0
    for m in np.random.default_rng(0).choice(nm, BPTF_CHECKED_MOVIES,
                                             replace=False):
        e = order[starts[m]:starts[m + 1]]
        if not len(e):
            continue
        x = w64[tri[e, 0]] * table[tri[e, 2]]
        a = x.T @ x + BPTF_LAM * len(e) * np.eye(d)
        want = np.linalg.solve(a, x.T @ r64[e])
        worst = max(worst, float(np.linalg.norm(w64[nu + m] - want)
                                 / np.linalg.norm(want)))
    log(f"BPTF: RMSE {rmse:.7f} (float64), {rmse / base:.4f} of the "
        f"ratings' RMS {base:.7f} (limit 0.25); time table vs the time "
        f"vertices max |diff| {t_err:.2e}; {BPTF_CHECKED_MOVIES} movies "
        f"against float64 solves: max relative error {worst:.3e} (limit "
        f"{ALS_FACTOR_RTOL:.0e})")
    if rmse >= 0.25 * base or t_err > 1e-6 or worst > ALS_FACTOR_RTOL:
        raise AssertionError("BPTF off its gates")
    report_superstep(torch, res.engine, [
        (ex, "gather_scopes", "gather_scopes"),
        (bptf_mod, "als_normal_eq_fold", "als_normal_eq_fold (the kernel)"),
        (torch.linalg, "solve_ex", "solve_ex (LU solve)"),
        (ex, "scatter_result", "scatter_result (write-back)"),
        (ex, "consume_and_reschedule", "consume_and_reschedule"),
        (ex, "refresh_syncs", "refresh_syncs (time table)")])
    release(torch, ctx, "bptf")


# ----------------------------------------------------------------------
# Phase 17: the facade, profiling and the fitted cost model
# ----------------------------------------------------------------------

# calibration: B = 32,768 is the window engines' k (WINDOW)
CAL_BATCHES = (512, 4096, WINDOW, 262_144)
CAL_ITERS = 5
DISPATCH_STEPS = 20            # each arm of (b)'s window runs
LOCKING_PROFILE_STEPS = 200    # (c)'s profiled CC locking: fit points
TRACE_STEPS = 8                # (d)'s traced PageRank
UNTIL_AT = 5                   # (d) stops after this superstep's sync
SEQ_SUPERSTEPS = 3             # (f)'s oracle budget on the 2k graph


def same_run(torch, a, b):
    """Bitwise equal vertex data, updates and supersteps."""
    return (a.vertex_data.keys() == b.vertex_data.keys()
            and all(torch.equal(a.vertex_data[k], b.vertex_data[k])
                    for k in a.vertex_data)
            and (a.n_updates, a.superstep) == (b.n_updates, b.superstep))


def phase_facade(torch, ctx):
    """The facade and the cost model at full size: (a) calibration on
    phase 4's graph, (b) dispatch under the model, (c) profiled runs,
    (d) until= and trace=, (e) the measured width plan, (f) the oracle
    and consistency= on the card.  The model and trace go to a temporary
    directory through ``REPRO_TORCH_RESULTS_DIR``."""
    import os
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        os.environ["REPRO_TORCH_RESULTS_DIR"] = tmp
        try:
            facade_parts(torch, ctx)
        finally:
            os.environ.pop("REPRO_TORCH_RESULTS_DIR", None)


def facade_parts(torch, ctx):
    import numpy as np

    from repro_torch import api
    from repro_torch.apps import cc, coem, pagerank
    from repro_torch.core.engine_sequential import run_sequential
    from repro_torch.core.exec import choose_dispatch
    from repro_torch.core.graph import (DataGraph, candidate_width_plans,
                                        choose_width_plan, zipf_edges)
    from repro_torch.core.update import Consistency
    from repro_torch.profile import (CostModel, calibrate, fit_cost_model,
                                     load_cost_model, load_trace)
    dev = ctx["dev"]
    total = ctx["launches"]
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)

    def counted(fn, count=True):
        """``fn()`` counted; ``count=False`` keeps its launches out of the
        report (runs that only compare the arms)."""
        out, wall, _, counts = split_counts(torch, fn)
        for k, v in counts.items():
            total[k] = total.get(k, 0) + (v if count else 0)
        return out, wall, counts

    # (a) calibration on phase 4's graph
    t0 = time.perf_counter()
    edges = ctx["zipf_edges"]
    g, upd, syncs = pagerank.build(edges, FULL_N, eps=EPS,
                                   colors=ctx["zipf_colors"], device=dev)
    torch.cuda.synchronize()
    log(f"(a) PageRank graph rebuilt with phase 4's colors: "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    (rec, model), wall, counts = counted(lambda: calibrate.calibrate_graph(
        g, CAL_BATCHES, iters=CAL_ITERS, seed=0, emit=lambda *_: None))
    if counts["ell_spmv"] <= 0:
        raise AssertionError("calibration never launched ell_spmv")
    tpath, mpath = rec.save(), model.save()
    back, back_rec = CostModel.load(mpath), load_trace(tpath)
    if (back != model or back_rec.records != rec.records
            or fit_cost_model(back_rec.records, device=dev.type) != model
            or load_cost_model(dev.type) != model):
        raise AssertionError("the saved model or trace does not round-trip")
    log(f"(a) calibration: {len(rec.records)} records in {wall:.1f} s, "
        f"launches {counts}; {mpath.name} and {tpath.name} round-trip")
    for w, (a, b) in sorted(model.coef.items()):
        log(f"  W = {w:>3}: a_W = {a:10.2f} us, b_W = {1e3 * b:9.4f} ns "
            f"a slot")
    a, b = model.pooled
    log(f"  pooled: a = {a:.2f} us, b = {1e3 * b:.4f} ns a slot; sync "
        f"slope {1e3 * model.sync_cost_us:.4f} ns a row")
    for r in rec.records:
        if r["kind"] == "launch":
            fit = model.predict(r["width"], r["rows"])
            log(f"  W = {r['width']:>3}, B = {r['rows']:>7}: measured "
                f"{r['wall_us']:10.1f} us, fit {fit:10.1f} us "
                f"({r['wall_us'] / fit:.3f})")
        elif r["kind"] == "step":
            pred = model.predict_launches(g.ell.bucket_launches)
            log(f"  bucket sweep (apply_batch over all {FULL_N} ids): "
                f"measured {r['wall_us']:.1f} us, predict_launches "
                f"{pred:.1f} us ({r['wall_us'] / pred:.3f})")
        else:
            log(f"  sync, {r['rows']} rows: {r['wall_us']:.1f} us")
    # B1 at every calibration window, on the same ids, bitwise
    gen = torch.Generator(device=dev).manual_seed(17)
    x1 = torch.rand((FULL_N, 1), generator=gen, device=dev) + 0.5
    b1_cases = []
    for b, w in enumerate(g.ell.widths):
        for n_ids, ids in calibrate._bucket_windows(g.ell, b, CAL_BATCHES, 0):
            b1_cases.append(window_case(
                torch, f"calibration window W={w} B={n_ids}", g.ell, w,
                g.edge_data["w"], x1, gen, flush, ids=ids, timed=False))
    log(f"(a) B1 at the {len(b1_cases)} calibration windows [B, W] (up to "
        f"{max(c['rows'] * c['width'] for c in b1_cases)} slots): bitwise "
        "the plain version")

    # (b) dispatch under the model: static rule vs the model
    ner = ctx["ner"]
    cg, cupd, csyncs = coem.build(ner, eps=COEM_EPS)
    for label, gg, u, s, sched, opts in (
            ("CC priority", ctx["cc_graph"], cc.make_update(), (),
             "priority", {"k_select": WINDOW}),
            ("CC locking", ctx["cc_graph"], cc.make_update(), (),
             "locking", {"max_pending": WINDOW}),
            ("CoEM priority", cg, cupd, csyncs, "priority",
             {"k_select": WINDOW})):
        ell = gg.ell
        static = choose_dispatch("auto", WINDOW, ell.widths[-1],
                                 ell.padded_slots)
        chosen = choose_dispatch("auto", WINDOW, ell.widths[-1],
                                 ell.padded_slots, cost_model=model,
                                 bucket_launches=ell.bucket_launches)
        runs, ms = {}, {}
        for arm in ("bucket", "batch", "auto"):
            kw = ({"cost_model": model} if arm == "auto" else {})
            runs[arm], wall, _ = counted(lambda: api.run(
                gg, u, syncs=s, scheduler=sched, dispatch=arm,
                num_supersteps=DISPATCH_STEPS, device=dev, **opts, **kw),
                count=arm == "auto")
            ms[arm] = 1e3 * wall / DISPATCH_STEPS
        faster = min(("bucket", "batch"), key=ms.get)
        log(f"(b) {label} ({DISPATCH_STEPS} supersteps): static rule "
            f"{static}, model {chosen} (predicted batch "
            f"{model.predict(ell.widths[-1], WINDOW):.1f} us, bucket "
            f"{model.predict_launches(ell.bucket_launches):.1f} us a "
            f"phase); ms/superstep bucket {ms['bucket']:.2f}, batch "
            f"{ms['batch']:.2f}, auto with the model {ms['auto']:.2f}; "
            f"faster arm {faster}, the model "
            f"{'picked it' if chosen == faster else 'did not'}")
        if runs["auto"].engine.resolve_dispatch(WINDOW) != chosen:
            raise AssertionError(f"{label}: the engine did not take the "
                                 "model's choice")
        if not same_run(torch, runs["auto"], runs[chosen]):
            raise AssertionError(f"{label}: auto under the model != the "
                                 f"forced {chosen} arm")
        if not same_run(torch, runs["bucket"], runs["batch"]):
            raise AssertionError(f"{label}: the two arms differ")
    del runs, cg, cupd, csyncs

    # (c) profiled runs: CC priority to the drain, CC locking's fit points
    truth = ctx["cc_truth"]
    for label, sched, opts in (
            ("CC priority", "priority",
             {"k_select": WINDOW, "max_supersteps": CC_MAX_SUPERSTEPS}),
            ("CC locking", "locking",
             {"max_pending": WINDOW,
              "num_supersteps": LOCKING_PROFILE_STEPS})):
        prof, p_wall, _ = counted(lambda: api.run(
            ctx["cc_graph"], cc.make_update(), scheduler=sched,
            profile=True, device=dev, **opts))
        plain, wall, _ = counted(lambda: api.run(
            ctx["cc_graph"], cc.make_update(), scheduler=sched, device=dev,
            **opts))
        steps = [r for r in prof.profile.records if r["kind"] == "step"]
        seen, cold_ok = set(), True
        for r in steps:
            key = (r["mode"], r.get("width"), r.get("rows"))
            cold_ok &= r["cold"] == (key not in seen)
            seen.add(key)
        fit = fit_cost_model(prof.profile.records, device=dev.type)
        warm = [r["wall_us"] for r in steps if not r["cold"]]
        log(f"(c) {label} profiled: {len(steps)} step records for "
            f"{prof.superstep} supersteps, {len(seen)} shapes (cold "
            f"{sum(r['cold'] for r in steps)}), warm median "
            f"{np.median(warm) / 1e3:.3f} ms a step; wall {p_wall:.3f} s "
            f"profiled vs {wall:.3f} s plain ({p_wall / wall:.3f}x); "
            f"fit: {len(fit.coef)} widths from {fit.n_records} points "
            + ", ".join(f"W={w}: ({a:.1f} us, {1e3 * b:.3f} ns)"
                        for w, (a, b) in sorted(fit.coef.items())))
        if len(steps) != prof.superstep or not cold_ok:
            raise AssertionError(f"{label}: {len(steps)} step records for "
                                 f"{prof.superstep} supersteps, cold flags "
                                 f"right {cold_ok}")
        if not same_run(torch, prof, plain) or not isinstance(fit,
                                                              CostModel):
            raise AssertionError(f"{label}: profiled run != plain run")
        if sched == "priority" and (prof.active_any or not np.array_equal(
                prof.vertex_data["label"].cpu().numpy(), truth)):
            raise AssertionError("CC priority profiled: not union-find")
    del prof, plain

    # (d) until= and trace= on phase 4's PageRank
    tr, wall, _ = counted(lambda: api.run(
        g, upd, syncs=syncs, trace=True, num_supersteps=TRACE_STEPS,
        device=dev))
    eng = tr.engine
    state = eng.init_state()
    totals = [float(state.globals["total_rank"])]     # before superstep 1
    for r in tr.trace:
        state = eng._superstep(state)
        if (r["superstep"], r["n_updates"], r["active"]) != (
                state.superstep, int(state.n_updates),
                int(state.active.sum())):
            raise AssertionError(f"trace record {r['superstep']} != the "
                                 "engine's state")
    if (len(tr.trace) != TRACE_STEPS
            or not torch.equal(state.vertex_data["rank"],
                               tr.vertex_data["rank"])):
        raise AssertionError("trace=True changed the run")
    totals += [float(r["globals"]["total_rank"]) for r in tr.trace]
    # termination by sync on the value the trace saw after superstep
    # UNTIL_AT (the total is not monotone from all-ones ranks, so a
    # threshold could bind earlier): the run must stop there, bitwise
    target = totals[UNTIL_AT]
    expect = totals.index(target)
    pred = lambda gl: float(gl["total_rank"]) == target
    res_u, _, _ = counted(lambda: api.run(g, upd, syncs=syncs, until=pred,
                                          device=dev))
    res_e, _, _ = counted(lambda: api.run(
        g, upd, syncs=syncs, num_supersteps=res_u.superstep, device=dev))
    log(f"(d) trace=True: {len(tr.trace)} records, counts equal the "
        f"engine's stepped state; total_rank {totals[0]:.1f} ... "
        f"{totals[-1]:.1f}; until total_rank == {target!r} stopped after "
        f"superstep {res_u.superstep} (expected {expect}); bitwise the "
        f"num_supersteps={res_u.superstep} run: "
        f"{same_run(torch, res_u, res_e)}")
    if res_u.superstep != expect or not same_run(torch, res_u, res_e):
        raise AssertionError("until= did not stop where a num_supersteps "
                             "run of the same length ends")
    del tr, res_u, res_e, state

    # (e) the measured width plan on phase 4's edges
    deg = (np.bincount(edges[:, 0], minlength=FULL_N)
           + np.bincount(edges[:, 1], minlength=FULL_N))
    loops = np.bincount(edges[edges[:, 0] == edges[:, 1], 0],
                        minlength=FULL_N)
    cnt, md = deg - loops, int(deg.max())
    plan = choose_width_plan(cnt, md, model)
    for cand in candidate_width_plans(cnt, md):
        log(f"(e) candidate w_cap={cand['w_cap']}: predicted sweep "
            f"{model.predict_launches(cand['launches']):.1f} us, "
            f"{sum(w * r for w, r in cand['launches'])} slots"
            + ("  <- chosen" if cand == plan else ""))
    t0 = time.perf_counter()
    gm = DataGraph.from_edges(
        FULL_N, edges, vertex_data={"rank": np.ones(FULL_N, np.float32)},
        edge_data={"w": pagerank.edge_weights(edges, FULL_N)},
        edge_locality=False, width_policy="measured", cost_model=model,
        device=dev).with_colors(ctx["zipf_colors"])
    torch.cuda.synchronize()
    stored = tuple((w, r) for w, r in gm.ell.bucket_launches if r)
    log(f"(e) measured layout built in {time.perf_counter() - t0:.1f} s: "
        f"split {gm.ell.is_split}, w_cap {gm.ell.w_cap}, widths "
        f"{gm.ell.widths}; stored launches == the plan's "
        f"{stored == tuple(plan['launches'])}")
    if gm.ell.is_split != plan["hub_split"] or gm.ell.w_cap != plan["w_cap"]:
        raise AssertionError("from_edges did not build the chosen plan")
    for label, gg in (("unsplit", g), ("chosen", gm)):
        sweep = calibrate._batch_fn(gg, upd, torch.arange(
            FULL_N, dtype=torch.int32, device=dev), "bucket")
        wall_us = calibrate._time_us(sweep, gg.vertex_data, device=dev,
                                     iters=CAL_ITERS)
        case = sweep_case(torch, f"(e) {label} layout B1 sweep F=1", gg.ell,
                          gg.edge_data["w"], x1, gen, flush)
        b1_cases.append(case)
        log(f"(e) {label} layout: B1 sweep {case['ms']:.4f} ms (one "
            f"launch, bitwise the plain version), apply_batch bucket sweep "
            f"{wall_us:.1f} us, predicted "
            f"{model.predict_launches(gg.ell.bucket_launches):.1f} us")
    if gm.ell.is_split:
        # B2: the split sweep's owner combine at the chosen w_cap
        y = torch.rand((gm.ell.n_virtual, 1), generator=gen, device=dev)
        ctx["split_seg_cases"].append(segment_case(
            torch, f"(e) owner combine w_cap={gm.ell.w_cap} F=1", y,
            gm.ell.vrow_offset, flush))
        del y
    del x1
    ctx["facade_b1_cases"] = b1_cases
    res, wall, counts = counted(lambda: api.run(gm, upd, syncs=syncs,
                                                device=dev))
    log(f"(e) PageRank on the measured layout: {res.superstep} supersteps, "
        f"{res.n_updates} updates, {wall:.3f} s "
        f"({1e3 * wall / max(res.superstep, 1):.2f} ms/superstep), "
        f"launches {counts}")
    if counts["ell_spmv"] <= 0:
        raise AssertionError("PageRank on the measured layout never "
                             "launched ell_spmv")
    check_pagerank(np, res, edges, "measured layout")
    del res, gm, g, upd, syncs

    # (f) the oracle and consistency= on the 2k Zipf graph
    n = 2000
    edges2 = zipf_edges(n, alpha=2.0, max_deg=64, seed=1)
    g2, upd2, _ = cc.build(edges2, n, device="cpu")
    t0 = time.perf_counter()
    gpu = api.run(g2, upd2, scheduler="sequential",
                  max_supersteps=SEQ_SUPERSTEPS, device=dev)
    t1 = time.perf_counter()
    cpu = api.run(g2, upd2, scheduler="sequential",
                  max_supersteps=SEQ_SUPERSTEPS, device="cpu")
    vd, _, _, n_upd = run_sequential(g2, upd2,
                                     max_supersteps=SEQ_SUPERSTEPS)
    same = (torch.equal(gpu.vertex_data["label"].cpu(),
                        cpu.vertex_data["label"])
            and torch.equal(cpu.vertex_data["label"], vd["label"])
            and gpu.n_updates == cpu.n_updates == n_upd
            and gpu.superstep is None and gpu.active_any == cpu.active_any)
    log(f"(f) sequential oracle, 2k CC, {SEQ_SUPERSTEPS} supersteps: "
        f"{gpu.n_updates} updates, GPU == CPU == run_sequential {same} "
        f"({t1 - t0:.1f} s on the GPU)")
    if not same:
        raise AssertionError("the oracle on the GPU != on the CPU")
    truth2 = cc.reference_components(edges2, n)
    for cons in ("full", "vertex"):
        res = api.run(g2, upd2, scheduler="locking", max_pending=64,
                      consistency=cons, max_supersteps=CC_MAX_SUPERSTEPS,
                      device=dev)
        ok = (res.engine.update_fn.consistency == Consistency(cons)
              and not res.active_any
              and np.array_equal(res.vertex_data["label"].cpu().numpy(),
                                 truth2))
        log(f"(f) CC locking consistency={cons}: {res.superstep} "
            f"supersteps, {res.n_updates} updates, == union-find {ok}")
        if not ok:
            raise AssertionError(f"CC locking consistency={cons} != "
                                 "union-find")


# ----------------------------------------------------------------------
# Phase 18: the distributed engines, eight shards on one card
# ----------------------------------------------------------------------

N_SHARDS = 8
# distributed locking CC: pending rows a shard (phase 13's window over
# the shards); a saturating window needs thousands of supersteps on CC
DIST_CC_WINDOW = WINDOW // N_SHARDS
DIST_CC_SUPERSTEPS = 12_000    # drained well before (phase 13: 2,911)
# (c)'s distributed locking CC stops here: its drain took 2,036
# supersteps and 61 s, each superstep mostly host time; what it computes
# is held bitwise by the saturating window against the single-shard
# engine, which phase 13 drains to union-find
DIST_CC_LOCKING_STEPS = 256
# (b)'s split PageRank on 8 shards against the single-shard split engine,
# both stopped here (to convergence, 26 supersteps, it took 30 s; phase
# 16 runs the split engine to its fixed point, (a) the unsplit 8 shards)
DIST_SPLIT_STEPS = 8
# the saturating window (max_pending = R a shard), held bitwise against
# the single-shard engine with every vertex pending for this many
# supersteps: draining it takes thousands
DIST_SAT_SUPERSTEPS = 16
DIST_ALS_TOL = 1e-5            # distributed ALS factors vs phase 7's
MPI_ALS_TOL = 1e-3             # the reference test's rtol = atol
DIST_LBP_TOL = 1e-4            # the reference test's LBP tolerance


def dist_layers():
    """PageRank's layers plus the distributed engine's exchanges."""
    import repro_torch.core.distributed as dist
    return pagerank_layers() + [
        (dist, "push_rows", "ghost push (all_to_all)"),
        (dist, "task_backflow", "task backflow (all_to_all)"),
        (dist, "dist_refresh_syncs", "syncs (all_gather, merge)"),
        (dist, "active_total", "termination (psum)")]


def plan_report(np, plan, edges, label, t_part, t_plan):
    """Log a plan's shapes and the bytes a chromatic superstep moves
    (``launch.graph_dryrun.plan_summary``) with its host times."""
    from repro_torch.launch.graph_dryrun import plan_summary
    text, sizes = plan_summary(plan, edges)
    log(f"{label}: partition {t_part:.1f} s and ShardPlan.build {t_plan:.1f}"
        f" s on the host; {text}")
    return sizes


def same_as_single(torch, res, single, key, label):
    """A distributed run against its single-shard run: data bitwise,
    update and superstep counts equal."""
    got = res.vertex_data[key].cpu()
    diff = int((got != single["data"]).sum())
    log(f"{label}: {res.superstep} supersteps, {res.n_updates} updates; "
        f"single shard {single['superstep']} / {single['n_updates']}; "
        f"{diff} of {got.numel()} values differ")
    if diff or (res.superstep, res.n_updates) != (single["superstep"],
                                                  single["n_updates"]):
        raise AssertionError(f"{label}: not bitwise the single-shard run")


def phase_distributed(torch, ctx):
    """M = 8 shards on one card (``LocalMesh``), each run's launch counts
    set to 0 just before and read just after: (a) PageRank and (b) split
    PageRank bitwise their single-shard runs, (c) CC under distributed
    chromatic and locking equal to union-find, (d) ALS against phase 7,
    (e) MPI-style ALS against MapReduce ALS, (f) CoSeg LBP with cut-edge
    exchange, (g) the NCCL arm; then B1, B2 and B3 at the shard shapes."""
    import dataclasses

    import numpy as np

    from repro_torch import api
    from repro_torch.apps import cc, pagerank
    from repro_torch.core.distributed import ShardPlan
    from repro_torch.core.partition import two_phase_partition
    dev, edges = ctx["dev"], ctx["zipf_edges"]
    total = ctx["launches"]
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(18)
    b1, b2, b3 = [], [], []

    def counted(fn):
        out, wall, peak, counts = split_counts(torch, fn)
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        return out, wall, peak, counts

    def one_superstep(eng, what):
        report_run(torch, what, dist_layers(), eng._superstep,
                   eng.init_carry)

    # (a) PageRank on phase 4's graph and colors
    t0 = time.perf_counter()
    g = ctx["pr_graph_host"].to(dev)     # phase 19 takes it again
    upd = pagerank.make_update(EPS)
    syncs = (pagerank.second_most_popular_sync(),
             pagerank.total_rank_sync())
    t1 = time.perf_counter()
    asg = two_phase_partition(FULL_N, g.edges_np, N_SHARDS, seed=0)
    t2 = time.perf_counter()
    plan = ShardPlan.build(g, asg, N_SHARDS)
    t3 = time.perf_counter()
    log(f"(a) phase 4's PageRank graph back on the card in "
        f"{t1 - t0:.1f} s")
    moved = plan_report(np, plan, edges, "(a) PageRank plan", t2 - t1,
                        t3 - t2)
    res, wall, peak, counts = counted(lambda: api.run(
        g, upd, syncs=syncs, n_shards=N_SHARDS, partition=plan, device=dev))
    log(f"(a) distributed PageRank, M={N_SHARDS}: {wall:.3f} s "
        f"({1e3 * wall / max(res.superstep, 1):.2f} ms/superstep; phase 4 "
        f"on one shard: see above), launches {counts}, peak device memory "
        f"{peak:.2f} GiB, exchanges {moved['real_bytes']} bytes real / "
        f"{moved['buffer_bytes']} in buffers a superstep")
    if counts["ell_spmv"] <= 0:
        raise AssertionError("distributed PageRank never launched ell_spmv")
    same_as_single(torch, res, ctx["pr_single"], "rank",
                   "(a) distributed PageRank")
    check_pagerank(np, res, edges, "(a) distributed PageRank")
    eng = res.engine
    one_superstep(eng, "distributed PageRank superstep (M=8)")
    shard = plan.local_struct(0, dev)
    w0 = plan.shard_edge_data({"w": g.edge_data["w"][:-1]})["w"][0]
    x0 = torch.rand((plan.R, 1), generator=gen, device=dev) + 0.5
    b1.append(sweep_case(torch, "B1 shard 0's bucket sweep (M=8)",
                         shard.ell, w0, x0, gen, flush))
    for i in range(1, N_SHARDS):
        check_sweep_bitwise(torch, plan.local_ell(i, dev), gen,
                            f"B1 shard {i}'s bucket sweep")
    del res, eng, shard, w0, x0

    # (c) CC on the same storage and plan
    truth = ctx["cc_truth"]
    cc_g = dataclasses.replace(g, vertex_data={
        "label": torch.arange(FULL_N, dtype=torch.int32, device=dev)},
        edge_data={})
    for label, opts in (("chromatic", {}),
                        ("locking", {"scheduler": "locking",
                                     "max_pending": DIST_CC_WINDOW,
                                     "num_supersteps":
                                         DIST_CC_LOCKING_STEPS})):
        res, wall, peak, counts = counted(lambda: api.run(
            cc_g, cc.make_update(), n_shards=N_SHARDS, partition=plan,
            device=dev, **opts))
        labels = res.vertex_data["label"].cpu().numpy()
        extra = (f", ghost rows sent {res.stats['ghost_rows_sent']} of "
                 f"{res.stats['ghost_rows_full']}"
                 if "ghost_rows_sent" in res.stats else "")
        log(f"(c) distributed CC {label} (M={N_SHARDS}"
            f"{', ' + str(DIST_CC_WINDOW) + ' pending a shard' if opts else ''}"
            f"): {res.superstep} supersteps, {res.n_updates} updates, "
            f"{wall:.3f} s ({1e3 * wall / max(res.superstep, 1):.2f} "
            f"ms/superstep), peak {peak:.2f} GiB, {int((labels == truth).sum())}"
            f" of {FULL_N} labels final{extra}")
        if label == "chromatic":
            if res.active_any or not np.array_equal(labels, truth):
                raise AssertionError(f"(c) CC {label}: not drained or "
                                     f"{int((labels != truth).sum())} labels "
                                     "differ from union-find")
            continue
        # stopped before its drain: each label is a vertex of its own
        # component and no smaller than the component's least id
        bad = (labels < truth) | (truth[labels] != truth)
        if res.superstep != DIST_CC_LOCKING_STEPS or res.n_updates <= 0 \
                or bad.any():
            raise AssertionError(f"(c) CC locking: {res.superstep} "
                                 f"supersteps, {res.n_updates} updates, "
                                 f"{int(bad.sum())} labels outside their "
                                 "component")
        one_superstep(res.engine, "distributed CC locking superstep")
        del res
    log("(c) distributed CC: chromatic equals union-find; locking's labels "
        f"after {DIST_CC_LOCKING_STEPS} supersteps lie in their components")
    dist_cc_saturating(torch, api, cc, cc_g, plan, counted)
    ctx["pr_plan"] = plan                # phase 19 runs on it again
    del cc_g, g, upd, syncs, plan
    release(torch, ctx)

    # (b) split PageRank at the default w_cap (64), phase 4's assignment
    t0 = time.perf_counter()
    g = ctx.pop("split_host").to(dev)
    upd = pagerank.make_update(EPS)
    syncs = (pagerank.second_most_popular_sync(),
             pagerank.total_rank_sync())
    t1 = time.perf_counter()
    plan = ShardPlan.build(g, asg, N_SHARDS)
    t2 = time.perf_counter()
    moved = plan_report(np, plan, edges, f"(b) split plan, w_cap "
                        f"{plan.ell_w_cap} (phase 16's graph back on the "
                        f"card in {t1 - t0:.1f} s)", 0.0, t2 - t1)
    one = api.run(g, upd, syncs=syncs, device=dev,
                  num_supersteps=DIST_SPLIT_STEPS)
    single = single_run(one, "rank")
    del one
    res, wall, peak, counts = counted(lambda: api.run(
        g, upd, syncs=syncs, n_shards=N_SHARDS, partition=plan, device=dev,
        num_supersteps=DIST_SPLIT_STEPS))
    log(f"(b) distributed split PageRank, {DIST_SPLIT_STEPS} supersteps: "
        f"{wall:.3f} s ({1e3 * wall / max(res.superstep, 1):.2f} "
        f"ms/superstep), launches {counts}, peak {peak:.2f} GiB")
    if counts["ell_spmv"] <= 0 or counts["segment_combine"] <= 0:
        raise AssertionError("distributed split PageRank did not launch "
                             "both kernels")
    same_as_single(torch, res, single, "rank",
                   "(b) distributed split PageRank")
    ell0 = plan.local_ell(0, dev)
    y = torch.rand((ell0.n_virtual, 1), generator=gen, device=dev)
    b2.append(segment_case(torch, "B2 split shard 0's owner combine (M=8)",
                           y, ell0.vrow_offset, flush))
    del res, g, upd, syncs, plan, ell0, y
    release(torch, ctx)

    dist_als(torch, ctx, np, api, counted, flush, b3)
    dist_lbp(torch, ctx, np, api, counted)
    nccl_arm(torch, ctx, np, api)
    ctx["dist_cases"] = {"ell_spmv": b1, "segment_combine": b2,
                         "als_normal_eq": b3}


def dist_cc_saturating(torch, api, cc, cc_g, plan, counted):
    """(c) CC under distributed locking with the saturating window
    (``max_pending = plan.R``), stopped after ``DIST_SAT_SUPERSTEPS``:
    labels, updates and supersteps bitwise the single-shard locking
    engine's with every vertex pending, stopped at the same superstep."""
    runs = {}
    for label, opts in (
            ("single shard", {"max_pending": cc_g.n_vertices}),
            (f"M={N_SHARDS}", {"max_pending": plan.R, "n_shards": N_SHARDS,
                               "partition": plan})):
        res, wall, peak, counts = counted(lambda: api.run(
            cc_g, cc.make_update(), scheduler="locking",
            num_supersteps=DIST_SAT_SUPERSTEPS, device=cc_g.device, **opts))
        runs[label] = res
        log(f"(c) CC locking, saturating window, {label} "
            f"({opts['max_pending']} pending"
            f"{' a shard' if 'partition' in opts else ''}): {res.superstep} supersteps, {res.n_updates} updates, "
            f"{wall:.3f} s ({1e3 * wall / max(res.superstep, 1):.2f} "
            f"ms/superstep), launches {counts}, peak {peak:.2f} GiB")
    single = runs["single shard"]
    same_as_single(torch, runs[f"M={N_SHARDS}"], dict(
        data=single.vertex_data["label"].cpu(), superstep=single.superstep,
        n_updates=single.n_updates), "label",
        "(c) distributed CC locking, saturating window")


def check_sweep_bitwise(torch, ell, gen, label):
    """One shard's bucket sweep (one launch) against its plain version,
    bitwise, untimed."""
    from repro_torch.kernels.ell_spmv import ell_spmv_bucketed, ell_spmv_plain
    dev = ell.device
    x = torch.rand((ell.n_rows, 1), generator=gen, device=dev)
    w = [torch.where(m, torch.rand(m.shape, generator=gen, device=dev), 0.0)
         for m in ell.nbr_mask]
    masks = [torch.rand(nb.shape[0], generator=gen, device=dev) < 0.8
             for nb in ell.nbrs]
    y = ell_spmv_bucketed(ell.nbrs, w, x, masks)
    yp = torch.cat([ell_spmv_plain(nb, wb, x, m)
                    for nb, wb, m in zip(ell.nbrs, w, masks)])
    if bits_differ(torch, y, yp):
        raise AssertionError(f"{label}: differs from its plain version")


def dist_als(torch, ctx, np, api, counted, flush, b3):
    """(d) ALS at Netflix width on 8 shards through ``api.run`` against
    phase 7's run, and (e) MPI-style ALS against MapReduce ALS."""
    import dataclasses

    from repro_torch.apps import als
    from repro_torch.baselines.mpi_als import MPIBlocks, als_mpi
    from repro_torch.core.distributed import ShardPlan
    from repro_torch.core.mesh import LocalMesh
    from repro_torch.core.partition import random_partition
    from repro_torch.core.update import gather_scopes
    dev = ctx["dev"]
    prob = dataclasses.replace(ctx["als_host"],
                               graph=ctx["als_host"].graph.to(dev))
    g, upd, syncs = als.build(prob, lam=ALS_LAM, eps=0.0)
    t0 = time.perf_counter()
    # the paper's partition of the dense bipartite Netflix graph: random
    asg = random_partition(g.n_vertices, N_SHARDS, seed=0)
    plan = ShardPlan.build(g, asg, N_SHARDS)
    t1 = time.perf_counter()
    plan_report(np, plan, g.edges_np, "(d) ALS plan (random partition)",
                0.0, t1 - t0)
    res, wall, peak, counts = counted(lambda: api.run(
        g, upd, syncs=syncs, n_shards=N_SHARDS, partition=plan, device=dev,
        num_supersteps=ALS_SUPERSTEPS))
    single = ctx["als_single"]
    w = res.vertex_data["w"].cpu()
    diff = float((w - single["data"]).abs().max())
    bitwise = bool(torch.equal(w, single["data"]))
    log(f"(d) distributed ALS, M={N_SHARDS}: {res.superstep} supersteps, "
        f"{res.n_updates} updates (phase 7: {single['superstep']} / "
        f"{single['n_updates']}), {wall:.3f} s "
        f"({1e3 * wall / max(res.superstep, 1):.2f} ms/superstep), "
        f"launches {counts}, peak {peak:.2f} GiB; factors bitwise phase 7's:"
        f" {bitwise} (max |diff| {diff:.3e}, limit {DIST_ALS_TOL:.0e}); "
        f"sync RMSE {float(res.globals['rmse'])}")
    if counts["als_normal_eq"] <= 0:
        raise AssertionError("distributed ALS never launched als_normal_eq")
    if (res.superstep, res.n_updates) != (single["superstep"],
                                          single["n_updates"]) \
            or diff > DIST_ALS_TOL:
        raise AssertionError("(d) distributed ALS off phase 7's run")
    # B3 at a shard's fold shapes: each color's [Cmax, D] scope
    eng = res.engine
    s0 = eng._sa[0]
    carry = eng.init_carry()
    for c in range(plan.n_colors):
        scope = gather_scopes(s0.struct, carry["vertex_data"][0],
                              carry["edge_data"][0], s0.color_ids[c], {})
        X = scope.nbr_data["w"]
        b3.append(als_case(torch, f"B3 ALS shard 0 fold color {c} (M=8)",
                           None, scope.nbr_mask,
                           scope.edge_data["rating"],
                           X.reshape(-1, X.shape[-1]), flush))
        del scope, X
    del res, eng, carry, s0, plan
    release(torch, ctx)

    # (e) MPI-style ALS, 10 iterations, against phase 16's MapReduce ALS
    (wu, wv, info), wall, peak, counts = counted(lambda: als_mpi(
        prob, MR_ITERS, n_devices=N_SHARDS, lam=ALS_LAM))
    # its iterations alone, on blocks set up outside the timing
    blocks, setup_s, _, _ = split_counts(torch, lambda: MPIBlocks(
        prob, LocalMesh(N_SHARDS, [dev])))

    def iterate():
        for _ in range(MR_ITERS):
            blocks.iterate(ALS_LAM)
    _, it_wall, _, _ = split_counts(torch, iterate)
    del blocks
    w_mpi = torch.cat([wu, wv]).cpu().numpy()
    w_mr = ctx["mr_als"]
    err = np.abs(w_mpi - w_mr) - MPI_ALS_TOL * np.abs(w_mr)
    r64 = prob.ratings.astype(np.float64)
    rm = rmse64(prob.pairs, r64, w_mpi.astype(np.float64), prob.n_users)
    it_ms = 1e3 * it_wall / MR_ITERS
    log(f"(e) MPI-style ALS, M={N_SHARDS}: {MR_ITERS} iterations, "
        f"{wall:.3f} s with its set-up ({setup_s:.3f} s), {it_ms:.2f} ms an "
        f"iteration, {info['bytes_per_iter']} bytes all-gathered an "
        f"iteration, launches {counts}, peak {peak:.2f} GiB; against "
        f"MapReduce ALS max |diff| {float(np.abs(w_mpi - w_mr).max()):.3e} "
        f"(rtol = atol = {MPI_ALS_TOL:.0e}), RMSE {rm:.7f}")
    if counts["als_normal_eq"] <= 0:
        raise AssertionError("MPI-style ALS never launched als_normal_eq")
    if not np.isfinite(w_mpi).all() or err.max() > MPI_ALS_TOL:
        raise AssertionError("(e) MPI-style ALS off MapReduce ALS")
    del wu, wv, g, prob
    release(torch, ctx, "als_host", "mr_als")


def dist_lbp(torch, ctx, np, api, counted):
    """(f) CoSeg LBP on phase 13's grid, frame partition, cut-edge
    exchange: distributed chromatic (4 sweeps) and locking (saturating
    window, 20 supersteps) against the single-shard runs."""
    from repro_torch.apps import lbp
    from repro_torch.core.distributed import ShardPlan
    dev = ctx["dev"]
    prob = ctx["coseg"]
    g = prob.graph
    upd = lbp.make_update(COSEG_LABELS, beta=COSEG_BETA, gamma=COSEG_GAMMA,
                          eps=COSEG_EPS, use_gmm_sync=False)
    t0 = time.perf_counter()
    plan = ShardPlan.build(g, lbp.frame_partition(prob, N_SHARDS), N_SHARDS)
    log(f"(f) CoSeg frame plan: {time.perf_counter() - t0:.1f} s, R "
        f"{plan.R}, He {plan.He}, Hc {plan.Hc}, E_loc {plan.E_loc}")
    for label, single_opts, dist_opts, steps in (
            ("chromatic", {}, {}, COSEG_SWEEPS),
            ("locking", {"scheduler": "locking",
                         "max_pending": g.n_vertices},
             {"scheduler": "locking", "max_pending": plan.R},
             COSEG_LOCKING_STEPS)):
        single = api.run(g, upd, device=dev, num_supersteps=steps,
                         **single_opts)
        res, wall, peak, counts = counted(lambda: api.run(
            g, upd, n_shards=N_SHARDS, partition=plan, exchange_edges=True,
            device=dev, num_supersteps=steps, **dist_opts))
        diff = float((res.vertex_data["belief"]
                      - single.vertex_data["belief"]).abs().max())
        extra = (f", ghost rows sent {res.stats['ghost_rows_sent']} of "
                 f"{res.stats['ghost_rows_full']}"
                 if "ghost_rows_sent" in res.stats else "")
        log(f"(f) distributed CoSeg LBP {label}: {res.n_updates} updates in "
            f"{res.superstep} supersteps (one shard: {single.n_updates}), "
            f"{wall:.3f} s ({1e3 * wall / max(res.superstep, 1):.2f} "
            f"ms/superstep), peak {peak:.2f} GiB, beliefs max |diff| "
            f"{diff:.3e} (limit {DIST_LBP_TOL:.0e}){extra}")
        if res.n_updates != single.n_updates or not diff <= DIST_LBP_TOL:
            raise AssertionError(f"(f) distributed LBP {label} off the "
                                 "single-shard run")
        del res, single
    del plan
    release(torch, ctx)


def nccl_arm(torch, ctx, np, api):
    """(g) ``ProcessGroupMesh`` over NCCL at world size 1 (a TCP store on
    localhost, this process) on the 2k Zipf PageRank, bitwise the
    ``LocalMesh`` one-shard run and the single-shard engine; with more
    cards, also at world size ``device_count`` against a ``LocalMesh``."""
    import socket

    import torch.distributed as dist

    from repro_torch.apps import pagerank
    from repro_torch.core.graph import zipf_edges
    from repro_torch.core.mesh import ProcessGroupMesh
    dev = ctx["dev"]
    edges = zipf_edges(2000, alpha=2.0, max_deg=64, seed=1)
    g, upd, syncs = pagerank.build(edges, 2000, eps=EPS, device=dev)
    zeros = np.zeros(2000, np.int64)
    single = api.run(g, upd, syncs=syncs, device=dev)
    local = api.run(g, upd, syncs=syncs, n_shards=1, partition=zeros,
                    device=dev)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    store = dist.TCPStore("localhost", port, 1, True)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1)
    try:
        mesh = ProcessGroupMesh(device=dev)
        pg = api.run(g, upd, syncs=syncs, n_shards=1, partition=zeros,
                     mesh=mesh, device=dev)
    finally:
        dist.destroy_process_group()
    for label, r in (("LocalMesh M=1", local), ("NCCL world 1", pg)):
        same = (torch.equal(r.vertex_data["rank"], single.vertex_data["rank"])
                and (r.superstep, r.n_updates) == (single.superstep,
                                                   single.n_updates))
        log(f"(g) 2k Zipf PageRank, {label}: {r.superstep} supersteps, "
            f"{r.n_updates} updates; bitwise the single-shard engine: {same}")
        if not same:
            raise AssertionError(f"(g) {label} != the single-shard engine")
    n = torch.cuda.device_count()
    if n > 1:
        nccl_multi(torch, np, n, edges)
    else:
        log("(g) one card: the NCCL arm runs at world size 1 only")


def _nccl_worker(rank, world, port, edges, out):
    """One rank of the multi-card NCCL arm: the 2k PageRank over a
    ``ProcessGroupMesh`` on ``cuda:rank``; rank 0 saves the ranks."""
    import numpy as np
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import api
    from repro_torch.apps import pagerank
    from repro_torch.core.mesh import ProcessGroupMesh
    from repro_torch.core.partition import two_phase_partition
    dev = torch.device("cuda", rank)
    torch.cuda.set_device(dev)
    store = dist.TCPStore("localhost", port, world, rank == 0)
    dist.init_process_group("nccl", store=store, rank=rank, world_size=world)
    try:
        g, upd, syncs = pagerank.build(edges, 2000, eps=EPS, device=dev)
        res = api.run(g, upd, syncs=syncs, n_shards=world, device=dev,
                      partition=two_phase_partition(2000, g.edges_np, world,
                                                    seed=0),
                      mesh=ProcessGroupMesh(device=dev))
        if rank == 0:
            np.savez(out, rank=res.vertex_data["rank"].cpu().numpy(),
                     counts=[res.superstep, res.n_updates])
    finally:
        dist.destroy_process_group()


def nccl_multi(torch, np, n, edges):
    """The NCCL arm at world size ``n`` (one process a card) against a
    ``LocalMesh`` of ``n`` shards on ``cuda:0``, bitwise."""
    import socket
    import tempfile

    import torch.multiprocessing as mp

    from repro_torch import api
    from repro_torch.apps import pagerank
    from repro_torch.core.partition import two_phase_partition
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    with tempfile.TemporaryDirectory() as tmp:
        out = str(Path(tmp) / "nccl.npz")
        mp.spawn(_nccl_worker, args=(n, port, edges, out), nprocs=n)
        with np.load(out) as z:
            ranks, counts = z["rank"], z["counts"].tolist()
    dev = torch.device("cuda", 0)
    g, upd, syncs = pagerank.build(edges, 2000, eps=EPS, device=dev)
    local = api.run(g, upd, syncs=syncs, n_shards=n, device=dev,
                    partition=two_phase_partition(2000, g.edges_np, n,
                                                  seed=0))
    same = (np.array_equal(ranks, local.vertex_data["rank"].cpu().numpy())
            and counts == [local.superstep, local.n_updates])
    log(f"(g) NCCL world {n} (one card a rank) against LocalMesh M={n}: "
        f"bitwise {same}")
    if not same:
        raise AssertionError(f"(g) NCCL world {n} != LocalMesh")


# ----------------------------------------------------------------------
# Phase 19: fault tolerance (repro_torch.ft) on the card
# ----------------------------------------------------------------------

FT_STEPS = 8                   # (a)'s budget on 8 shards
FT_EVERY = 2
FT_FAULTS = (("checkpoint_fail", 4, 0), ("kill", 5, 3), ("transient", 7, 0))
FT_RESTORED = [2, 4, 6]
FT_CC_STEPS, FT_CC_EVERY, FT_CC_KILL = 16, 4, 9
FT_SINGLE_EVERY, FT_SINGLE_KILL = 4, 13


class FtProbe:
    """Times the snapshot layer while a run goes through it: every
    write, validation and load (ms, one list a kind), the bytes each
    write left on disk, and each restart's wall time, from the injected
    exception to the end of the first superstep after the restore, with
    the peak device memory before the exception and after it."""

    def __init__(self, torch):
        import repro_torch.ft.snapshot as snap
        import repro_torch.train.checkpoint as ckpt
        from repro_torch.core.distributed import DistributedChromaticEngine
        from repro_torch.core.engine_locking import DistributedLockingEngine
        from repro_torch.core.exec import ExecutorCore
        from repro_torch.ft.faults import FaultPlan
        self.torch = torch
        self.ms = {k: [] for k in ("write", "validate", "load")}
        self.bytes, self.restarts = [], []
        self._raised = None
        self._undo = []
        self._wrap(snap, "write_snapshot", "write", self._dir_bytes)
        self._wrap(snap, "validate_snapshot", "validate")
        self._wrap(snap, "load_carry", "load")
        self._wrap(ckpt, "snapshot_engine_state", "write",
                   lambda args, out: os.path.getsize(args[0]))
        self._wrap(ckpt, "restore_engine_state", "load")
        fire = FaultPlan.fire

        def fire_timed(plan, site, **kw):
            try:
                return fire(plan, site, **kw)
            except Exception:
                torch.cuda.synchronize()
                self._raised = (time.perf_counter(),
                                torch.cuda.max_memory_allocated())
                torch.cuda.reset_peak_memory_stats()
                raise
        self._set(FaultPlan, "fire", fire_timed)
        for cls in (ExecutorCore, DistributedChromaticEngine,
                    DistributedLockingEngine):
            self._step(cls)

    def _set(self, owner, name, fn):
        self._undo.append((owner, name, owner.__dict__[name]))
        setattr(owner, name, fn)

    def _dir_bytes(self, args, out):
        return sum(f.stat().st_size for f in Path(out).iterdir())

    def _wrap(self, mod, name, kind, size=None):
        fn = getattr(mod, name)

        def timed(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            self.ms[kind].append(1e3 * (time.perf_counter() - t0))
            if size is not None:
                self.bytes.append(size(args, out))
            return out
        self._set(mod, name, timed)

    def _step(self, cls):
        step = cls.__dict__["_superstep"]

        def stepped(eng, state):
            out = step(eng, state)
            if self._raised is not None:
                self.torch.cuda.synchronize()
                t_raise, peak = self._raised
                self.restarts.append(dict(
                    ms=1e3 * (time.perf_counter() - t_raise),
                    peak_before=peak / 2**30))
                self._raised = None
            return out
        self._set(cls, "_superstep", stepped)

    def close(self, peak_after_gib):
        for owner, name, fn in reversed(self._undo):
            setattr(owner, name, fn)
        for r in self.restarts:
            r["peak_after"] = peak_after_gib

    def report(self, label):
        fmt = lambda xs: ", ".join(f"{x:.1f}" for x in xs) or "none"
        log(f"{label}: snapshot writes {fmt(self.ms['write'])} ms, "
            f"{self.bytes[-1] if self.bytes else 0} bytes on disk each "
            f"(last); validations {fmt(self.ms['validate'])} ms; loads "
            f"{fmt(self.ms['load'])} ms; restarts (exception to the end "
            f"of the first superstep after the restore) "
            + "; ".join(f"{r['ms']:.1f} ms, peak {r['peak_before']:.2f} "
                        f"GiB before / {r['peak_after']:.2f} GiB after"
                        for r in self.restarts))


def ft_run(torch, counted, fn):
    """``counted(fn)`` under an ``FtProbe``: ``(result, wall, counts,
    probe)``."""
    probe = FtProbe(torch)
    try:
        res, wall, peak, counts = counted(fn)
    finally:
        probe.close(torch.cuda.max_memory_allocated() / 2**30)
    return res, wall, counts, probe


def same_result(torch, a, b, key):
    """Two results bitwise: data, counts, globals, ghost traffic."""
    from repro_torch.train.checkpoint import flat_items
    if not torch.equal(a.vertex_data[key], b.vertex_data[key]):
        return False
    if (a.superstep, a.n_updates) != (b.superstep, b.n_updates):
        return False
    ga, gb = flat_items(a.globals), flat_items(b.globals)
    if [k for k, _ in ga] != [k for k, _ in gb] or not all(
            torch.equal(x, y) for (_, x), (_, y) in zip(ga, gb)):
        return False
    return all(a.stats.get(k) == b.stats.get(k)
               for k in ("ghost_rows_sent", "ghost_rows_full"))


def phase_ft(torch, ctx):
    """Kill and resume on the card: (a) PageRank on 8 shards with a
    checkpoint-write failure, a kill and a transient fault; (b) CC under
    distributed locking killed at 9; (c) ``resume_from=`` without a
    partition; (d) one device's PageRank killed at 13."""
    import dataclasses
    import tempfile

    from repro_torch import api
    from repro_torch.apps import cc, pagerank
    from repro_torch.ft import FaultEvent, FaultPlan
    dev = ctx["dev"]
    total = ctx["launches"]

    def counted(fn):
        out, wall, peak, counts = split_counts(torch, fn)
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        return out, wall, peak, counts

    g = ctx["pr_graph_host"].to(dev)
    plan = ctx.pop("pr_plan")
    upd = pagerank.make_update(EPS)
    syncs = (pagerank.second_most_popular_sync(),
             pagerank.total_rank_sync())
    kw = dict(syncs=syncs, n_shards=N_SHARDS, num_supersteps=FT_STEPS,
              device=dev)
    with tempfile.TemporaryDirectory() as root:
        root = Path(root)
        # (a) the uninterrupted run, the checkpointed one, the faulted one
        base, wall, _, counts = counted(lambda: api.run(
            g, upd, partition=plan, **kw))
        step_ms = 1e3 * wall / FT_STEPS
        log(f"(a) PageRank, M={N_SHARDS}, {FT_STEPS} supersteps "
            f"uninterrupted: {wall:.3f} s ({step_ms:.2f} ms/superstep), "
            f"{base.n_updates} updates, launches {counts}")
        ck, ck_wall, _, probe = ft_run(torch, counted, lambda: api.run(
            g, upd, partition=plan, **kw, checkpoint_every=FT_EVERY,
            checkpoint_dir=str(root / "a_ckpt")))
        probe.report(f"(a) checkpointed every {FT_EVERY}, no faults")
        log(f"(a) checkpointing at K = {FT_EVERY}: {ck_wall:.3f} s against "
            f"{wall:.3f} s, {100 * (ck_wall - wall) / ck_wall:.1f} % of "
            f"the run; bitwise the uninterrupted run: "
            f"{same_result(torch, ck, base, 'rank')}")
        if not same_result(torch, ck, base, "rank"):
            raise AssertionError("(a) a checkpointed run is not bitwise the "
                                 "uninterrupted run")
        faults = FaultPlan([FaultEvent(k, s, shard=sh)
                            for k, s, sh in FT_FAULTS])
        res, f_wall, f_counts, probe = ft_run(torch, counted, lambda: api.run(
            g, upd, partition=plan, **kw, checkpoint_every=FT_EVERY,
            checkpoint_dir=str(root / "a_faults"), faults=faults))
        probe.report("(a) with faults")
        got = [(r.error_type, r.restored_superstep) for r in res.restarts]
        log(f"(a) restart log {got}, fault log {faults.log}; "
            f"{f_wall:.3f} s, launches {f_counts}; bitwise the "
            f"uninterrupted run: {same_result(torch, res, base, 'rank')}")
        if [e for e, _ in got] != ["CheckpointWriteFault", "InjectedKill",
                                   "TransientFault"] \
                or [s for _, s in got] != FT_RESTORED:
            raise AssertionError(f"(a) restart log {got}")
        if not same_result(torch, res, base, "rank") \
                or f_counts["ell_spmv"] <= 0:
            raise AssertionError("(a) the faulted run is not bitwise the "
                                 "uninterrupted run")
        del res, ck

        # (b) CC under distributed locking, killed at 9
        cc_g = dataclasses.replace(g, vertex_data={
            "label": torch.arange(FULL_N, dtype=torch.int32, device=dev)},
            edge_data={})
        ckw = dict(scheduler="locking", max_pending=DIST_CC_WINDOW,
                   n_shards=N_SHARDS, partition=plan,
                   num_supersteps=FT_CC_STEPS, device=dev)
        cbase, c_wall, _, _ = counted(lambda: api.run(
            cc_g, cc.make_update(), **ckw))
        cres, _, _, probe = ft_run(torch, counted, lambda: api.run(
            cc_g, cc.make_update(), **ckw, checkpoint_every=FT_CC_EVERY,
            checkpoint_dir=str(root / "b"),
            faults=FaultPlan([FaultEvent("kill", FT_CC_KILL)])))
        probe.report("(b) CC locking")
        ok = same_result(torch, cres, cbase, "label")
        log(f"(b) CC locking, {DIST_CC_WINDOW} pending a shard, "
            f"{FT_CC_STEPS} supersteps ({1e3 * c_wall / FT_CC_STEPS:.2f} "
            f"ms/superstep), kill at {FT_CC_KILL}: restart log "
            f"{[(r.error_type, r.restored_superstep) for r in cres.restarts]}"
            f", ghost rows {cres.stats['ghost_rows_sent']} of "
            f"{cres.stats['ghost_rows_full']} (uninterrupted "
            f"{cbase.stats['ghost_rows_sent']} of "
            f"{cbase.stats['ghost_rows_full']}); bitwise: {ok}")
        if not ok or [r.restored_superstep for r in cres.restarts] != [8]:
            raise AssertionError("(b) CC locking: not bitwise the "
                                 "uninterrupted run")
        del cres, cbase, cc_g

        # (c) resume_from (a)'s snapshot at 4: the plan is rebuilt from
        # the assignment the snapshot stores
        snap4 = root / "a_faults" / "step_00000004"
        rres, r_wall, _, probe = ft_run(torch, counted, lambda: api.run(
            g, upd, **kw, resume_from=str(snap4)))
        probe.report("(c) resume_from")
        ok = same_result(torch, rres, base, "rank")
        log(f"(c) resume_from step 4 without partition=: {r_wall:.3f} s "
            f"(ShardPlan.build from the stored assignment included), "
            f"{rres.superstep} supersteps; bitwise (a): {ok}")
        if not ok:
            raise AssertionError("(c) resume_from is not bitwise (a)")
        del rres, base
    del plan
    release(torch, ctx)

    # (d) one device: phase 4's PageRank, killed at 13
    with tempfile.TemporaryDirectory() as root:
        res, wall, counts, probe = ft_run(torch, counted, lambda: api.run(
            g, upd, syncs=syncs, device=dev,
            checkpoint_every=FT_SINGLE_EVERY, checkpoint_dir=root,
            faults=FaultPlan([FaultEvent("kill", FT_SINGLE_KILL)])))
    probe.report("(d) one device")
    single = ctx["pr_single"]
    diff = int((res.vertex_data["rank"].cpu() != single["data"]).sum())
    log(f"(d) one device, checkpoint every {FT_SINGLE_EVERY}, kill at "
        f"{FT_SINGLE_KILL}: {res.superstep} supersteps, {res.n_updates} "
        f"updates, {wall:.3f} s, launches {counts}, restart log "
        f"{[(r.error_type, r.restored_superstep) for r in res.restarts]}; "
        f"phase 4: {single['superstep']} / {single['n_updates']}; {diff} "
        "ranks differ")
    if diff or (res.superstep, res.n_updates) != (single["superstep"],
                                                  single["n_updates"]):
        raise AssertionError("(d) the killed run is not bitwise phase 4's")
    if [r.restored_superstep for r in res.restarts] != [12]:
        raise AssertionError("(d) restored from the wrong snapshot")
    del res, g
    release(torch, ctx)


# ----------------------------------------------------------------------
# Phase 20: online graph serving (repro_torch.serve.graph_engine)
# ----------------------------------------------------------------------

SERVE_SLACK = 4
# 4 batches: the first two end in a compaction rebuild, the next two fit
# in slack slots (batches 4-7 added three more rebuilds of ~5.5 s each)
SERVE_BATCHES, SERVE_RATE = 4, 1024
SHARDED_SERVE_N = 2 ** 17      # (h): the plan is built again each round
SHARDED_SERVE_ROUNDS = 2


def timed_sync(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def fresh_edges(np, serving, batch):
    return np.asarray([e for e in batch.edges.tolist()
                       if serving.find_edge(*e) is None],
                      np.int64).reshape(-1, 2)


def phase_serving(torch, ctx):
    """CC served on phase 4's edges with slack 4: (g) slack == frozen,
    (e) 4 edge_stream batches incremental == rebuild == union-find, (f)
    a pinned snapshot, (h) the sharded arm on 2^17 vertices."""
    import dataclasses

    import numpy as np

    from repro_torch import api
    from repro_torch.apps import cc
    from repro_torch.data.pipeline import edge_stream
    dev, edges = ctx["dev"], ctx["zipf_edges"]
    colors = ctx["zipf_colors"]

    # (g) the slack storage, unmutated, runs bitwise the frozen storage
    (g, upd, _), build_s = timed_sync(torch, lambda: cc.build(
        edges, FULL_N, colors=colors, slack=SERVE_SLACK, device=dev))
    frozen = ctx["pr_graph_host"].to(dev)
    frozen = dataclasses.replace(frozen, vertex_data={
        "label": torch.arange(FULL_N, dtype=torch.int32, device=dev)},
        edge_data={})
    runs = {}
    for label, graph in (("frozen", frozen), ("slack", g)):
        runs[label], wall = timed_sync(torch, lambda: api.run(
            graph, upd, scheduler="chromatic", device=dev))
        log(f"(g) CC chromatic on the {label} storage: "
            f"{runs[label].superstep} supersteps, {runs[label].n_updates} "
            f"updates, {wall:.3f} s")
    extra = g.ell.padded_slots - frozen.ell.padded_slots
    log(f"(g) slack storage built in {build_s:.1f} s: "
        f"{g.ell.padded_slots} slots against {frozen.ell.padded_slots} "
        f"({extra} more, {extra * 10} bytes of nbrs, mask, edge ids and "
        f"is_src), widths {g.ell.widths}, edge capacity {g.edge_capacity} "
        f"for {g.n_edges} edges (CC has no edge data)")
    if not same_result(torch, runs["slack"], runs["frozen"], "label"):
        raise AssertionError("(g) the slack storage is not bitwise the "
                             "frozen storage")
    truth = ctx["cc_truth"]
    del runs, frozen
    release(torch, ctx)

    # (e), (f) the served run
    serving = api.serve(g, upd, scheduler="locking", max_pending=WINDOW,
                        max_supersteps=DIST_CC_SUPERSTEPS, device=dev)
    r, wall = timed_sync(torch, serving.recompute)
    log(f"(e) initial converge (every vertex dirty): {r['supersteps']} "
        f"supersteps, {r['updates']} updates, {wall:.3f} s")
    if not np.array_equal(serving.graph.vertex_data["label"].cpu().numpy(),
                          truth):
        raise AssertionError("(e) the initial converge is not union-find")
    pinned = serving.snapshot()
    before = pinned.vertex_data["label"].clone()
    publish, publish_s = serving._publish, []

    def publish_timed(**kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        publish(**kw)
        torch.cuda.synchronize()
        publish_s.append(time.perf_counter() - t0)
    serving._publish = publish_timed
    added = []

    def replay():
        for batch in edge_stream(FULL_N, rate=SERVE_RATE, seed=0,
                                 n_batches=SERVE_BATCHES):
            new = fresh_edges(np, serving, batch)
            n_comp = serving.stats["compactions"]
            _, ins_s = timed_sync(torch, lambda: serving.add_edges(new))
            added.extend(new.tolist())
            n_pub = len(publish_s)
            r, rec_s = timed_sync(torch, serving.recompute)
            pub_s = sum(publish_s[n_pub:])
            how = ("a compaction rebuild: a row's slack ran out"
                   if serving.stats["compactions"] > n_comp
                   else "slack slots")
            log(f"(e) batch {batch.t}: {len(new)} edges inserted in "
                f"{1e3 * ins_s:.1f} ms ({how}); recompute "
                f"{1e3 * (rec_s - pub_s):.1f} ms ({r['dirty']} dirty rows, "
                f"{r['supersteps']} supersteps, {r['updates']} updates); "
                f"publish {1e3 * pub_s:.3f} ms")
    _, wall, _, counts = split_counts(torch, replay)
    log(f"(e) {SERVE_BATCHES} batches in {wall:.3f} s, launches {counts} "
        "(CC's update has no aggregator: no kernel is on its path)")
    log(f"(e) serving stats {serving.stats}; _publish keeps the tensors it "
        "is handed (no clone, 0 bytes copied): every mutation writes new "
        "tensors")
    ok_pin = torch.equal(pinned.vertex_data["label"], before)
    log(f"(f) the snapshot pinned before batch 0 reads the same after "
        f"batch {SERVE_BATCHES - 1}: {ok_pin} (round {pinned.round}, "
        f"{pinned.n_edges} edges; now {serving.snapshot().n_edges})")
    if not ok_pin:
        raise AssertionError("(f) a pinned snapshot changed")
    inc = serving.graph.vertex_data["label"]
    all_edges = np.vstack([edges, np.asarray(added, np.int64)])
    del serving, pinned, before, g
    release(torch, ctx)
    (g2, u2, _), host_s = timed_sync(torch, lambda: cc.build(
        all_edges, FULL_N, device=dev))
    rb, dev_s = timed_sync(torch, lambda: api.run(
        g2, u2, scheduler="chromatic", device=dev))
    want = cc.reference_components(all_edges, FULL_N)
    ok = (torch.equal(inc, rb.vertex_data["label"])
          and np.array_equal(inc.cpu().numpy(), want))
    log(f"(e) a full rebuild of {len(all_edges)} edges: build (host, with "
        f"greedy coloring) {host_s:.2f} s, run to convergence on the card "
        f"{dev_s:.3f} s ({rb.superstep} supersteps); incremental == "
        f"rebuild == union-find: {ok}")
    if not ok:
        raise AssertionError("(e) incremental labels differ from the "
                             "rebuild's")
    del g2, rb, inc
    release(torch, ctx)
    serving_sharded(torch, np, api, cc, edge_stream, dev)


def serving_sharded(torch, np, api, cc, edge_stream, dev):
    """(h) 8 LocalMesh shards on a 2^17-vertex Zipf graph: two rounds of
    1,024 edges, each recomputed incrementally (the plan built again),
    equal to a rebuild and to union-find."""
    from repro_torch.core.graph import zipf_edges
    from repro_torch.core.partition import two_phase_partition
    n = SHARDED_SERVE_N
    edges = zipf_edges(n, alpha=2.0, max_deg=256, seed=1)
    g, upd, _ = cc.build(edges, n, slack=SERVE_SLACK, device=dev)
    asg = two_phase_partition(n, edges, N_SHARDS, seed=0)
    serving = api.serve(g, upd, scheduler="chromatic", n_shards=N_SHARDS,
                        partition=asg, device=dev)
    r, wall = timed_sync(torch, serving.recompute)
    log(f"(h) {n} vertices, {len(edges)} edges on {N_SHARDS} shards: "
        f"initial converge {r['supersteps']} supersteps, {wall:.3f} s")
    added = []
    for batch in edge_stream(n, rate=SERVE_RATE, seed=1,
                             n_batches=SHARDED_SERVE_ROUNDS):
        new = fresh_edges(np, serving, batch)
        serving.add_edges(new)
        added.extend(new.tolist())
        r, wall = timed_sync(torch, serving.recompute)
        log(f"(h) round {batch.t}: {len(new)} edges, {r['dirty']} dirty "
            f"rows, {r['supersteps']} supersteps, {wall:.3f} s (the plan "
            "built again included)")
    all_edges = np.vstack([edges, np.asarray(added, np.int64)])
    g2, u2, _ = cc.build(all_edges, n, device=dev)
    rb = api.run(g2, u2, scheduler="chromatic", n_shards=N_SHARDS,
                 partition=two_phase_partition(n, all_edges, N_SHARDS,
                                               seed=0), device=dev)
    inc = serving.graph.vertex_data["label"]
    ok = (torch.equal(inc, rb.vertex_data["label"])
          and np.array_equal(inc.cpu().numpy(),
                             cc.reference_components(all_edges, n)))
    log(f"(h) incremental == rebuild == union-find: {ok}")
    if not ok:
        raise AssertionError("(h) sharded serving differs from the rebuild")


# ----------------------------------------------------------------------
# Phase 21: the other model families (moe, ssm, hybrid, vlm, audio)
# ----------------------------------------------------------------------

FAMILY_CTX = 32_768            # decode_32k's context
FAMILY_TOKENS = 16
# (label, arch, config changes, batch, B4 launches a step, what else runs):
# whole where the card holds the model, else at full width with fewer
# layers (and the hybrid with half its experts)
FAMILY_RUNS = (
    ("a", "falcon-mamba-7b", {}, 128, 0, {"prefill_tokens": 4096}),
    ("b", "phi3.5-moe-42b-a6.6b", {"n_layers": 8}, 4, 8, {}),
    ("c", "jamba-1.5-large-398b", {"n_layers": 8, "n_experts": 8}, 4, 1, {}),
    ("d", "llava-next-34b", {"n_layers": 8}, 4, 8, {"prefill_tokens": 192}),
    ("e", "seamless-m4t-medium", {}, 4, 24, {"frames": 8_192}),
)
# the GPU-vs-CPU and decode-vs-prefill gates' reduced runs
FAMILY_PARITY_STEPS = 4
FAMILY_TF_TOKENS = 16
# the reference's own tolerances: test_decode_matches_forward_logits and
# test_mamba_decode_matches_train_scan
DECODE_PREFILL_TOL = 3e-2
MAMBA_SCAN_TOL = 5e-2


def family_cfg(arch, changes):
    import dataclasses

    from repro_torch import configs
    cfg = configs.get(arch)
    changes = dict(changes)
    if "n_experts" in changes:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, n_experts=changes.pop("n_experts")))
    return dataclasses.replace(cfg, **changes)


def state_to(state, device):
    """A copy of a serving state on ``device``."""
    import dataclasses
    up = lambda t: None if t is None else t.to(device, copy=True)
    return dataclasses.replace(
        state, cache_k=up(state.cache_k), cache_v=up(state.cache_v),
        cache_len=up(state.cache_len), mem_k=up(state.mem_k),
        mem_v=up(state.mem_v),
        mamba_state=(None if state.mamba_state is None else
                     {k: up(v) for k, v in state.mamba_state.items()}))


def fill_state(torch, state, gen, mem=True):
    """Random caches, Mamba states (h at 0.1) and, with ``mem``, memory."""
    for t in (state.cache_k, state.cache_v) + ((state.mem_k, state.mem_v)
                                              if mem else ()):
        if t is not None:
            t.copy_(torch.randn(t.shape, generator=gen, device=gen.device))
    if state.mamba_state is not None:
        for k, t in state.mamba_state.items():
            t.copy_(torch.randn(t.shape, generator=gen, device=gen.device)
                    * (0.1 if k == "h" else 1.0))


def phase_family_parity(torch, ctx):
    """The reduced configs: GPU vs CPU decode for all 10 architectures,
    teacher-forced decode vs prefill on the GPU for every family, and the
    Mamba block's decode vs its chunked scan."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import attention, mamba, model
    from repro_torch.serve import engine
    dev = ctx["dev"]
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        worst_all = 0.0
        for arch in configs.ARCHS:
            cfg = configs.get(arch).reduced()
            cpu = model.init_params(cfg, seed=0, dtype=torch.float32,
                                    device="cpu")
            gpu = model.Model(cfg, dtype=torch.float32, device=dev)
            gpu.load_state_dict(cpu.state_dict())
            cst = engine.init_cache(cfg, 3, 96, dtype=torch.float32,
                                    device="cpu")
            fill_state(torch, cst, torch.Generator().manual_seed(1))
            if not cfg.enc_dec:
                cst.cache_len.copy_(torch.tensor([96, 5, 400],
                                                 dtype=torch.int32))
            tok = torch.tensor([[3], [77], [cfg.vocab - 1]],
                               dtype=torch.int32)
            worst = 0.0
            for _ in range(FAMILY_PARITY_STEPS):
                # each step starts both from the CPU's state: the bf16 conv
                # tail can round a float32 ulp apart to neighbouring values
                gst = state_to(cst, dev)
                cl, cst = engine.decode_step(cpu, cfg, tok, cst)
                gl, _ = engine.decode_step(gpu, cfg, tok.to(dev), gst)
                worst = max(worst, float((gl.cpu() - cl)[:, :cfg.vocab]
                                         .abs().max()))
                tok = torch.argmax(cl[:, :cfg.vocab], dim=-1)[:, None].int()
            log(f"  {arch} reduced ({cfg.arch_type}), float32: "
                f"{FAMILY_PARITY_STEPS} decode steps GPU vs CPU, logits max "
                f"|diff| {worst:.2e}")
            worst_all = max(worst_all, worst)
            if not worst <= DECODE_F32_TOL:
                raise AssertionError(f"{arch}: GPU decode off the CPU's by "
                                     f"{worst}")
        log(f"GPU vs CPU, 10 architectures: worst {worst_all:.2e} (limit "
            f"{DECODE_F32_TOL})")

        gen = torch.Generator(device=dev).manual_seed(2)
        b, s = 2, FAMILY_TF_TOKENS
        for arch in ("phi3.5-moe-42b-a6.6b", "qwen3-moe-235b-a22b",
                     "falcon-mamba-7b", "jamba-1.5-large-398b",
                     "llava-next-34b", "seamless-m4t-medium"):
            cfg = configs.get(arch).reduced()
            if cfg.moe is not None:
                # capacity factor E / k: cap = S, so neither grouping (a
                # row in prefill, the batch in decode) drops a token
                cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                    cfg.moe, capacity_factor=cfg.moe.n_experts
                    / cfg.moe.top_k))
            params = model.init_params(cfg, seed=3, dtype=torch.float32,
                                       device=dev)
            toks = torch.randint(0, cfg.vocab, (b, s), generator=gen,
                                 device=dev, dtype=torch.int32)
            batch = {"tokens": toks}
            st = engine.init_cache(cfg, b, s, dtype=torch.float32,
                                   device=dev)
            st.cache_len.zero_()
            if cfg.arch_type == "vlm":
                # decode takes no patches: the text-only prefill
                batch["patches"] = torch.zeros((b, 0, cfg.d_model),
                                               device=dev)
            if cfg.arch_type == "audio":
                frames = torch.randn((b, s, cfg.d_model), generator=gen,
                                     device=dev).to(torch.bfloat16)
                batch["frames"] = frames
                mem = model._encode(params, cfg, frames)
                for i, lp in enumerate(params.layers):
                    k, v = attention.mem_kv(lp.cross, cfg, mem)
                    st.mem_k[i].copy_(k)
                    st.mem_v[i].copy_(v)
            want = model.prefill(params, cfg, batch)
            for i in range(s):
                logits, st = engine.decode_step(params, cfg,
                                                toks[:, i:i + 1], st)
            d, ref = logits[:, :cfg.vocab], want[:, :cfg.vocab]
            diff = float((d - ref).abs().max())
            excess = float(((d - ref).abs() - DECODE_PREFILL_TOL
                            * (1 + ref.abs())).max())
            log(f"  {arch} reduced, float32: {s} teacher-forced decode steps "
                f"vs prefill, last logits max |diff| {diff:.2e} (limit "
                f"{DECODE_PREFILL_TOL} * (1 + |prefill|))")
            if not excess <= 0:
                raise AssertionError(f"{arch}: decode off prefill by {diff}")

        cfg = configs.get("falcon-mamba-7b").reduced()
        layer = mamba.Mamba(cfg, torch.Generator(device=dev).manual_seed(4))
        x = torch.randn((2, 9, cfg.d_model), generator=gen,
                        device=dev).to(torch.bfloat16)
        y_train = mamba.apply_train(layer, cfg, x)
        mst = mamba.init_decode_state(cfg, 2, dev)
        y_dec = torch.cat([mamba.apply_decode(layer, cfg, x[:, i:i + 1], mst)
                           for i in range(9)], dim=1)
        diff = float((y_train.float() - y_dec.float()).abs().max())
        log(f"  Mamba block (falcon-mamba reduced, bf16): decode vs chunked "
            f"scan max |diff| {diff:.2e} (limit {MAMBA_SCAN_TOL})")
        if not diff <= MAMBA_SCAN_TOL:
            raise AssertionError(f"Mamba decode off its scan by {diff}")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    family_attention_cases(torch, ctx)


def family_attention_cases(torch, ctx):
    """B4 against its plain version at the new families' head groups,
    bf16, decode_32k's full 32,768-row cache at batch 4: qwen3-moe's 64/4
    heads (n_rep 16: two blocks of 8 a KV head), jamba's 64/8 (n_rep 8),
    phi3.5-moe's and llava's 32/8 and 56/8, and seamless's
    cross-attention (16/16 heads of 64 over its whole memory, kv_len =
    T)."""
    from repro_torch import configs
    dev = ctx["dev"]
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    cases = []
    for arch, what in (("qwen3-moe-235b-a22b", "self"),
                       ("jamba-1.5-large-398b", "self"),
                       ("phi3.5-moe-42b-a6.6b", "self"),
                       ("llava-next-34b", "self"),
                       ("seamless-m4t-medium", "cross, kv_len = T")):
        c = configs.get(arch)
        cases.append(attention_case(
            torch, f"{arch} {what}, bf16", 4, c.n_heads, c.n_kv_heads,
            FAMILY_CTX, c.dh, torch.bfloat16, "full", flush, gen))
    ctx["attn_cases"] = ctx.get("attn_cases", []) + cases


def family_layers():
    """``(owner, attribute, label)`` of each layer a family's decode step
    is split into."""
    from repro_torch.models import attention, mamba, model, moe
    from repro_torch.serve import engine
    return [(model, "_embed_tokens", "embed"),
            (engine, "rmsnorm", "norms"),
            (attention, "decode_attention",
             "attention (QKV, rope, insert, B4, wo)"),
            (attention, "cross_attention_decode", "cross-attention (B4)"),
            (mamba, "apply_decode", "Mamba step"),
            (moe, "route", "MoE router"),
            (moe, "dispatch", "MoE dispatch"),
            (moe, "expert_ffn", "expert FFN"),
            (moe, "combine", "MoE combine"),
            (model, "_mlp_apply", "MLP"),
            (model, "_logits", "logits")]


class StepCapture:
    """Installed around one decode step: keeps the inputs and outputs of
    the first attention, cross-attention, Mamba and MoE layer it runs
    (the MoE's router logits, experts, gates, positions and kept flags
    with them)."""

    def __init__(self):
        from repro_torch.models import attention, mamba, moe
        self.got, self.saved, self.inner = {}, [], {}

        def wrap(owner, name, fn):
            real = getattr(owner, name)
            self.saved.append((owner, name, real))
            setattr(owner, name, fn(real))

        def attn(real):
            def run(p, cfg, x, ck, cv, clen, slot=None):
                out = real(p, cfg, x, ck, cv, clen, slot)
                self.got.setdefault("attention", (p, x.clone(), ck, cv,
                                                  clen.clone(), out.clone()))
                return out
            return run

        def cross(real):
            def run(p, cfg, x, mk, mv):
                out = real(p, cfg, x, mk, mv)
                self.got.setdefault("cross", (p, x.clone(), mk, mv,
                                              out.clone()))
                return out
            return run

        def ssm(real):
            def run(p, cfg, x, state):
                before = {k: v.clone() for k, v in state.items()}
                y = real(p, cfg, x, state)
                self.got.setdefault("mamba", (p, x.clone(), before,
                                              {k: v.clone() for k, v in
                                               state.items()}, y.clone()))
                return y
            return run

        def keep_inner(key):
            def make(real):
                def run(*a):
                    out = real(*a)
                    self.inner[key] = out
                    return out
                return run
            return make

        def moe_apply(real):
            def run(p, cfg, x):
                y, aux = real(p, cfg, x)
                if "moe" not in self.got:
                    logits, gate, eidx, _ = self.inner["route"]
                    _, pos, keep = self.inner["dispatch"]
                    self.got["moe"] = (p, x.clone(), y.clone(), logits.clone(),
                                       gate.clone(), eidx.clone(), pos.clone(),
                                       keep.clone())
                return y, aux
            return run
        wrap(attention, "decode_attention", attn)
        wrap(attention, "cross_attention_decode", cross)
        wrap(mamba, "apply_decode", ssm)
        wrap(moe, "route", keep_inner("route"))
        wrap(moe, "dispatch", keep_inner("dispatch"))
        wrap(moe, "apply", moe_apply)

    def remove(self):
        for owner, name, real in reversed(self.saved):
            setattr(owner, name, real)


def host64(torch, t):
    """A float64 numpy copy of a card tensor (converted on the card:
    exact from bf16 and float32)."""
    return t.detach().double().cpu().numpy()


def host_mamba_step(np, cfg, p, x, h, conv):
    """The O(1) Mamba step for one request in float64: x [d] (the normed
    input), h [di, ds], conv [d_conv - 1, di].  Returns (y, h, conv)."""
    from repro_torch.models.mamba import dt_rank
    di, ds, dtr = cfg.d_inner, cfg.ssm.d_state, dt_rank(cfg)
    silu = lambda t: t / (1 + np.exp(-t))
    xz = x @ p("in_proj")
    hist = np.concatenate([conv, xz[None, :di]], axis=0)
    xc = silu((hist * p("conv_w")).sum(0) + p("conv_b"))
    proj = xc @ p("x_proj")
    dt = np.logaddexp(0.0, proj[:dtr] @ p("dt_proj") + p("dt_bias"))
    bm, cm = proj[dtr:dtr + ds], proj[dtr + ds:]
    h = h * np.exp(dt[:, None] * -np.exp(p("A_log"))) \
        + (dt * xc)[:, None] * bm[None, :]
    y = (h @ cm + xc * p("D")) * silu(xz[di:])
    return y @ p("out_proj"), h, hist[1:]


def host_dispatch(np, logits, k, cap):
    """The dispatch from the card's float32 router logits [G, S, E]:
    top-k experts (stable, the lower index first on a tie), each
    assignment's place among its expert's in token order, and whether it
    is below ``cap``.  Returns (eidx [G,S,k], pos [G,S*k], keep)."""
    eidx = np.argsort(-logits, axis=-1, kind="stable")[..., :k]
    g = eidx.shape[0]
    flat = eidx.reshape(g, -1)
    pos = np.zeros_like(flat)
    for gi in range(g):
        seen = {}
        for i, e in enumerate(flat[gi]):
            pos[gi, i] = seen.get(int(e), 0)
            seen[int(e)] = pos[gi, i] + 1
    return eidx, pos, pos < cap


def check_family_step(torch, np, cfg, got):
    """The captured layers of one step against float64 (on the host, a
    MoE layer's expert products on the card), normwise over each
    request's vector; for a MoE layer, the routing
    recomputed on the host from the card's router logits, exactly.
    Returns ``{quantity: largest normwise error}`` and the drop counts."""
    from repro_torch.models import moe
    f = lambda t: host64(torch, t)
    rel = lambda a, b: float(np.linalg.norm(a - b) / max(np.linalg.norm(b),
                                                         1e-30))
    worst, notes = {}, {}

    def put(key, err):
        worst[key] = max(worst.get(key, 0.0), err)

    def params_of(module):
        cache = {}

        def get(name):
            if name not in cache:
                cache[name] = f(getattr(module, name))
            return cache[name]
        return get
    if "attention" in got:
        p, x, ck, cv, clen, out = got["attention"]
        get = params_of(p)
        names = ["wq", "wk", "wv", "wo"] + (["q_norm", "k_norm"]
                                            if cfg.qk_norm else [])
        pd = {n: get(n) for n in names}
        for r in range(x.shape[0]):
            pos = int(clen[r])
            slot = pos % ck.shape[1]
            o, k, v = host_attention(np, cfg, pd, f(x[r, 0]), f(ck[r]),
                                     f(cv[r]), pos)
            put("attention out", rel(f(out[r, 0]), o))
            put("inserted K", rel(f(ck[r, slot]), k))
            put("inserted V", rel(f(cv[r, slot]), v))
    if "cross" in got:
        p, x, mk, mv, out = got["cross"]
        get = params_of(p)
        for r in range(x.shape[0]):
            q = (f(x[r, 0]) @ get("wq")).reshape(cfg.n_heads, cfg.dh)
            if cfg.qk_norm:
                q = host_norm(np, q, get("q_norm"), cfg.norm_eps)
            o = host_softmax_attend(np, cfg, q, f(mk[r]), f(mv[r])) \
                @ get("wo")
            put("cross-attention out", rel(f(out[r, 0]), o))
    if "mamba" in got:
        p, x, before, after, y = got["mamba"]
        get = params_of(p)
        for r in range(x.shape[0]):
            yh, h, conv = host_mamba_step(np, cfg, get, f(x[r, 0]),
                                          f(before["h"][r]),
                                          f(before["conv"][r]))
            put("Mamba out", rel(f(y[r, 0]), yh))
            put("Mamba h", rel(f(after["h"][r]), h))
            put("Mamba conv tail", rel(f(after["conv"][r]), conv))
    if "moe" in got:
        p, x, y, logits, gate, eidx, pos, keep = got["moe"]
        k, n_exp = cfg.moe.top_k, cfg.moe.n_experts
        g_logits = logits.cpu().numpy()
        cap = moe.capacity(cfg, g_logits.shape[1])
        he, hp, hk = host_dispatch(np, g_logits, k, cap)
        same = (np.array_equal(he, eidx.cpu().numpy())
                and np.array_equal(hp, pos.cpu().numpy())
                and np.array_equal(hk, keep.cpu().numpy()))
        notes.update(cap=cap, dropped=int((~hk).sum()),
                     assignments=int(hk.size), routing_equal=same)
        if not same:
            raise AssertionError("the MoE dispatch differs from the host's "
                                 "recomputation from the router logits")
        xs = f(x.reshape(-1, x.shape[-1]))                 # token rows
        lg = xs @ f(p.router)
        put("router logits", max(rel(g_logits.reshape(lg.shape)[t], lg[t])
                                 for t in range(len(lg))))
        pr = np.exp(lg - lg.max(-1, keepdims=True))
        pr /= pr.sum(-1, keepdims=True)
        flat_e = he.reshape(len(xs), k)
        gates = np.take_along_axis(pr, flat_e, -1)
        gates /= gates.sum(-1, keepdims=True)
        kept = hk.reshape(len(xs), k)
        yh = np.zeros_like(xs)
        act = {"silu": lambda t: t / (1 + torch.exp(-t)),
               "gelu": lambda t: 0.5 * t * (1 + torch.tanh(
                   (2 / np.pi) ** 0.5 * (t + 0.044715 * t ** 3)))}[cfg.act]
        # the experts' products in float64 on the card: jamba's d-8192
        # experts are 4.8 GB each in float64, and on the host took ~20 s
        xd = torch.from_numpy(xs).to(x.device)
        for e in sorted({int(e) for e in flat_e[kept]}):
            wg, wu, wd = (getattr(p, n)[e].double() for n in ("w_gate", "w_up",
                                                              "w_down"))
            for t, j in zip(*np.nonzero((flat_e == e) & kept)):
                yh[t] += gates[t, j] * ((act(xd[t] @ wg) * (xd[t] @ wu))
                                        @ wd).cpu().numpy()
            del wg, wu, wd
        yc = f(y.reshape(-1, y.shape[-1]))
        put("MoE out", max(rel(yc[t], yh[t]) for t in range(len(xs))))
    return worst, notes


def step_bytes(cfg, params, state, kv_rows):
    """Bytes one decode step must move: every weight it reads once (all
    but the input embedding's gathered rows; every expert, since the
    capacity buffer runs each), the valid K/V rows of each attention
    layer, the cross-attention memory, and the Mamba states read and
    written."""
    n = sum(t.numel() * t.element_size() for name, t in
            params.named_parameters()
            if not (name == "embed" and params.out is not None))
    if state.cache_k is not None:
        n += 2 * kv_rows * state.cache_k.shape[0] * state.cache_k[0, 0, 0] \
            .numel() * state.cache_k.element_size()
    if state.mem_k is not None:
        n += 2 * state.mem_k.numel() * state.mem_k.element_size()
    if state.mamba_state is not None:
        n += 2 * sum(t.numel() * t.element_size()
                     for t in state.mamba_state.values())
    return n


def phase_families(torch, ctx):
    """Runs (a)-(e) on the card in bf16, one at a time; B4's launches
    on their decode paths add to the main path's count."""
    counts = ctx.setdefault("launches", {})
    release(torch, ctx)
    for run in FAMILY_RUNS:
        counts["window_attention"] = (counts.get("window_attention", 0)
                                      + family_run(torch, ctx, *run))
        release(torch, ctx)


def family_run(torch, ctx, label, arch, changes, batch, b4_per_step, extra):
    """One run of phase 21; returns its window_attention launches."""
    import numpy as np

    from repro_torch.kernels.window_attention import window_attention
    from repro_torch.launch import serve
    from repro_torch.models import attention, model, moe
    from repro_torch.serve import engine
    dev = ctx["dev"]
    cfg = family_cfg(arch, changes)
    reduced = ", ".join(f"{k} {v}" for k, v in changes.items()) or "whole"
    t0 = time.perf_counter()
    params = model.init_params(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    log(f"({label}) {arch} ({cfg.arch_type}; {reduced}): {cfg.n_layers} "
        f"layers, d {cfg.d_model}, {n_params:,} bf16 parameters "
        f"({n_params * 2 / 1e9:.2f} GB) drawn on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device=dev).manual_seed(0)

    if "prefill_tokens" in extra:
        s = extra["prefill_tokens"]
        pb = {"tokens": torch.randint(0, cfg.vocab, (1, s), generator=gen,
                                      device=dev, dtype=torch.int32)}
        if cfg.arch_type == "vlm":
            pb["patches"] = torch.randn((1, cfg.n_frontend_tokens,
                                         cfg.d_model), generator=gen,
                                        device=dev).to(torch.bfloat16)
        for rep in range(2):            # the first call warms up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t1 = time.perf_counter()
            lg = model.prefill(params, cfg, pb)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t1
        positions = s + (cfg.n_frontend_tokens if cfg.arch_type == "vlm"
                         else 0)
        log(f"({label}) prefill of {positions} positions, batch 1: "
            f"{secs:.3f} s ({positions / secs:,.0f} tokens/s), peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        if not (lg.shape == (1, model.vocab_padded(cfg))
                and bool(torch.isfinite(lg[:, :cfg.vocab]).all())):
            raise AssertionError(f"({label}) prefill logits {lg.shape}")
        del lg, pb

    state = engine.init_cache(cfg, batch, FAMILY_CTX, device=dev)
    fill_state(torch, state, gen, mem=False)
    if "frames" in extra:
        # one request's frames, the encoder's output repeated to the
        # memory's FAMILY_CTX rows and given to every request: the eager
        # flash loop's host time made the encoder over 4 requests' 32,768
        # frames take 29 s, over one request's 19.8 s
        frames = torch.randn((1, extra["frames"], cfg.d_model),
                             generator=gen, device=dev).to(torch.bfloat16)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        mem = model._encode(params, cfg, frames)
        mem = mem.repeat(1, FAMILY_CTX // mem.shape[1], 1)
        for i, lp in enumerate(params.layers):
            k, v = attention.mem_kv(lp.cross, cfg, mem)
            state.mem_k[i].copy_(k)
            state.mem_v[i].copy_(v)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t1
        log(f"({label}) encoder over {frames.shape[1]} frames of 1 request, "
            f"repeated to {mem.shape[1]} rows, then mem_kv into mem_k / "
            f"mem_v of all {batch} ({state.mem_k.numel() * 2 / 1e9:.2f} GB "
            f"each): {secs:.3f} s")
        if not bool(torch.isfinite(mem).all()):
            raise AssertionError(f"({label}) the encoder output is not finite")
        del frames, mem, k, v
    w = state.cache_k.shape[2] if state.cache_k is not None else 0
    kv_rows = batch * min(int(state.cache_len[0]) + 1, w) if w else 0
    nbytes = step_bytes(cfg, params, state, kv_rows)
    bound_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    tok = torch.randint(0, cfg.vocab, (batch, 1), generator=gen, device=dev,
                        dtype=torch.int32)
    drops = []
    real_dispatch = moe.dispatch

    def counted(x, eidx, n_experts, cap):
        buf, pos, keep = real_dispatch(x, eidx, n_experts, cap)
        drops.append((~keep).sum())
        return buf, pos, keep
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    moe.dispatch = counted
    try:
        window_attention.launches = 0
        seqs, logits, state, seconds = serve.generate(params, cfg, tok, state,
                                                      FAMILY_TOKENS)
        n_launch = window_attention.launches
    finally:
        moe.dispatch = real_dispatch
    peak = torch.cuda.max_memory_allocated()
    step_ms = 1e3 * sum(seconds[1:]) / (len(seconds) - 1)
    per_step = (torch.stack(drops).view(FAMILY_TOKENS, -1).sum(1).tolist()
                if drops else [])
    log(f"({label}) decode_32k: batch {batch}, {FAMILY_TOKENS} greedy tokens: "
        f"first step {1e3 * seconds[0]:.2f} ms, then {step_ms:.2f} ms a step "
        f"(min {1e3 * min(seconds[1:]):.2f}, max {1e3 * max(seconds[1:]):.2f})"
        f", {1e3 * batch / step_ms:.1f} tokens/s; a step must move "
        f"{nbytes / 1e9:.2f} GB: bound {bound_ms:.2f} ms "
        f"({bound_ms / step_ms:.2f} of the step); window_attention "
        f"launches {n_launch} (expected {b4_per_step} a step); peak device "
        f"memory {peak / 2**30:.2f} GiB")
    if per_step:
        log(f"({label}) MoE assignments dropped each step (cap "
            f"{moe.capacity(cfg, batch)}, {cfg.moe.n_experts} experts, top-"
            f"{cfg.moe.top_k}, {batch} tokens a layer): {per_step}")
    log(f"({label}) tokens of request 0: {seqs[0].tolist()}")
    if n_launch != b4_per_step * FAMILY_TOKENS:
        raise AssertionError(f"({label}) {n_launch} window_attention "
                             f"launches, not {b4_per_step} a step")
    if tuple(seqs.shape) != (batch, FAMILY_TOKENS) or not (
            logits.shape == (batch, model.vocab_padded(cfg))
            and bool(torch.isfinite(logits[:, :cfg.vocab]).all())):
        raise AssertionError(f"({label}) tokens {tuple(seqs.shape)} or "
                             f"logits {tuple(logits.shape)} wrong or not "
                             f"finite")

    nxt = torch.argmax(logits[:, :cfg.vocab], dim=-1)[:, None].int()
    if label in ("b", "c", "e"):
        cap = StepCapture()
        try:
            logits, state = engine.decode_step(params, cfg, nxt, state)
        finally:
            cap.remove()
        t1 = time.perf_counter()
        worst, notes = check_family_step(torch, np, cfg, cap.got)
        log(f"({label}) one more step's layers ({', '.join(sorted(cap.got))})"
            f" vs float64 on the host, normwise: " + ", ".join(
                f"{k} {v:.2e}" for k, v in sorted(worst.items()))
            + f" (limit {LAYER_HOST_TOL}; {time.perf_counter() - t1:.1f} s)")
        if notes:
            log(f"({label}) its MoE layer: cap {notes['cap']}, "
                f"{notes['dropped']} of {notes['assignments']} assignments "
                f"dropped; experts, positions and kept flags equal the "
                f"host's dispatch from the router logits")
        if not max(worst.values()) <= LAYER_HOST_TOL:
            raise AssertionError(f"({label}) off float64: {worst}")
        del cap
        nxt = torch.argmax(logits[:, :cfg.vocab], dim=-1)[:, None].int()

    box = [nxt, state]

    def one_step(_):
        lg, st = engine.decode_step(params, cfg, box[0], box[1])
        box[:] = [torch.argmax(lg[:, :cfg.vocab], dim=-1)[:, None].int(), st]
    kernels = report_run(torch, f"({label}) decode step", family_layers(),
                         one_step, other="other (residual adds, casts, host)")
    attn = [(t, n) for t, name, n in kernels if "window_attention" in name]
    if kernels:
        log(f"({label}) window_attention in the profiled step: "
            f"{sum(n for _, n in attn)} launches, "
            f"{sum(t for t, _ in attn) / 1e3:.2f} ms of device time")
    del params, state, box, logits
    return n_launch


# ----------------------------------------------------------------------
# Phase 22: training (the forward and its loss, AdamW, the trainer)
# ----------------------------------------------------------------------

TRAIN_LOSS_TOL = 1e-5          # GPU vs CPU, float32, TF32 off: relative
TRAIN_GRAD_TOL = 1e-4          # each gradient, normwise
TRAIN_UPDATE_TOL = 1e-3        # each parameter's update, normwise
TRAIN_GATE_STEPS = 3
# (label, arch, config changes, batch, sequence, trainer steps): full
# width at a cut depth, bf16 parameters and float32 moments
TRAIN_RUNS = (
    ("b", "qwen3-4b", {"n_layers": 4}, 2, 4096, 8),
    ("c1", "phi3.5-moe-42b-a6.6b", {"n_layers": 2}, 1, 4096, 4),
    ("c2", "falcon-mamba-7b", {"n_layers": 2}, 1, 4096, 4),
)
SERVE_PROMPT = 192             # (b)'s trained model: teacher-forced tokens
SERVE_BATCH = 2


def train_opt(steps):
    """The launcher's optimizer for a run of ``steps``."""
    from repro_torch.optim import adamw
    return adamw.AdamWConfig(lr=1e-3, warmup_steps=max(steps // 10, 1),
                             total_steps=steps)


def loss_and_grads(torch, model, cfg, params, batch, remat=True):
    """The loss and every parameter's gradient (by name) of
    ``model.forward``."""
    named = list(params.named_parameters())
    with model.trainable(params):
        loss, _ = model.forward(params, cfg, batch, remat=remat)
        grads = torch.autograd.grad(loss, [p for _, p in named],
                                    allow_unused=True, materialize_grads=True)
    return loss.detach(), {n: g for (n, _), g in zip(named, grads)}


def normwise(torch, got, want):
    """``|got - want| / |want|`` in float64 on the host."""
    got, want = got.double().cpu(), want.double().cpu()
    n = float(want.norm())
    return float((got - want).norm() / n) if n > 0 else float(got.norm())


def phase_train_parity(torch, ctx):
    """(a) Every architecture's reduced config in float32, TF32 off: the
    loss and each gradient on the GPU against the CPU, ``remat`` on
    against off on the GPU, and three train steps GPU against CPU."""
    from repro_torch import configs
    from repro_torch.data import pipeline
    from repro_torch.models import model
    from repro_torch.optim import adamw
    from repro_torch.train.steps import make_train_step, param_dict
    dev = ctx["dev"]
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        worst = {"loss": 0.0, "grad": 0.0, "remat": 0.0, "step loss": 0.0,
                 "update": 0.0}
        for arch in configs.ARCHS:
            cfg = configs.get(arch).reduced()
            seq = 16 + (cfg.n_frontend_tokens if cfg.arch_type == "vlm"
                        else 0)
            cpu = model.init_params(cfg, seed=0, dtype=torch.float32,
                                    device="cpu")
            gpu = model.Model(cfg, dtype=torch.float32, device=dev)
            gpu.load_state_dict(cpu.state_dict())
            cb = pipeline.make_batch(cfg, 2, seq, seed=0, device="cpu")
            gb = {k: v.to(dev) for k, v in cb.items()}
            cl, cg = loss_and_grads(torch, model, cfg, cpu, cb)
            gl, gg = loss_and_grads(torch, model, cfg, gpu, gb)
            dl = abs(float(gl) - float(cl)) / abs(float(cl))
            dg = max((normwise(torch, gg[k], cg[k]), k) for k in cg)
            ol, og = loss_and_grads(torch, model, cfg, gpu, gb, remat=False)
            same = bool(ol == gl) and all(torch.equal(og[k], gg[k])
                                          for k in gg)
            dr = max([abs(float(ol) - float(gl))]
                     + [float((og[k] - gg[k]).abs().max()) for k in gg])
            del cg, gg, og
            opt = train_opt(TRAIN_GATE_STEPS)
            steps = [make_train_step(cfg, opt) for _ in range(2)]
            states = [adamw.init(param_dict(m)) for m in (cpu, gpu)]
            ds, du = 0.0, (0.0, "")
            for i in range(TRAIN_GATE_STEPS):
                b = pipeline.make_batch(cfg, 2, seq, seed=100003 + i,
                                        device="cpu")
                before = [{n: p.detach().clone() for n, p in
                           m.named_parameters()} for m in (cpu, gpu)]
                _, states[0], cm = steps[0](cpu, states[0], b)
                _, states[1], gm = steps[1](
                    gpu, states[1], {k: v.to(dev) for k, v in b.items()})
                ds = max(ds, abs(float(gm["loss"]) - float(cm["loss"]))
                         / abs(float(cm["loss"])))
                gp = dict(gpu.named_parameters())
                for n, p in cpu.named_parameters():
                    du = max(du, (normwise(torch, gp[n].detach()
                                           - before[1][n],
                                           p.detach() - before[0][n]), n))
            log(f"  {arch} reduced ({cfg.arch_type}), float32: loss "
                f"{float(gl):.6f} GPU vs CPU {dl:.1e}, worst gradient "
                f"{dg[1]} {dg[0]:.2e}; remat on vs off "
                + ("bitwise" if same else f"max |diff| {dr:.2e}")
                + f"; {TRAIN_GATE_STEPS} train steps: loss {ds:.1e}, worst "
                f"update {du[1]} {du[0]:.2e}")
            for key, v in (("loss", dl), ("grad", dg[0]), ("remat", dr),
                           ("step loss", ds), ("update", du[0])):
                worst[key] = max(worst[key], v)
            if not (dl <= TRAIN_LOSS_TOL and dg[0] <= TRAIN_GRAD_TOL
                    and ds <= TRAIN_LOSS_TOL and du[0] <= TRAIN_UPDATE_TOL):
                raise AssertionError(f"{arch}: training on the GPU off the "
                                     f"CPU's: loss {dl}, {dg}, steps {ds}, "
                                     f"{du}")
        log(f"training GPU vs CPU, 10 architectures: worst loss {worst['loss']:.1e}"
            f", gradient {worst['grad']:.2e} (limits {TRAIN_LOSS_TOL}, "
            f"{TRAIN_GRAD_TOL} normwise); remat on vs off max |diff| "
            f"{worst['remat']:.2e}; steps: loss {worst['step loss']:.1e}, "
            f"update {worst['update']:.2e} (limit {TRAIN_UPDATE_TOL})")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def matmul_params(params, cfg):
    """Parameters a token's forward multiplies by: every weight matrix
    but the input embedding's gathered rows (unless tied: it is the
    output too), the Mamba block's elementwise ``A_log`` and ``conv_w``
    left out, and only ``top_k`` of a MoE layer's ``n_experts``."""
    n = 0.0
    for name, p in params.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if p.dim() < 2 or leaf in ("A_log", "conv_w") or (
                name == "embed" and params.out is not None):
            continue
        if cfg.moe is not None and ".ffn.w_" in name:
            n += p.numel() * cfg.moe.top_k / cfg.moe.n_experts
        else:
            n += p.numel()
    return n


def model_flops(params, cfg, batch, seq):
    """Model FLOPs of one training step: ``6 N T`` over T = B S tokens
    (forward 2, backward 4; the recomputation under remat not counted)
    plus the attention's ``12 L S^2 H dh B`` (QK^T and PV over the full
    S^2, as the eager loop computes every tile)."""
    n_attn = sum(1 for i in range(cfg.n_layers) if cfg.is_attn_layer(i))
    return (6 * matmul_params(params, cfg) * batch * seq
            + 12 * n_attn * seq * seq * cfg.n_heads * cfg.dh * batch)


def phase_train(torch, ctx):
    """(b) qwen3-4b and (c) phi3.5-moe and falcon-mamba-7b trained at full
    width through ``trainer.train``; then (b)'s checkpoint restored and
    served through B4."""
    import tempfile
    counts = ctx.setdefault("launches", {})
    log(f"card: {ctx.get('smi', 'not read')}")
    release(torch, ctx)
    with tempfile.TemporaryDirectory() as tmp:
        for run in TRAIN_RUNS:
            ckpt = os.path.join(tmp, f"{run[0]}.npz") if run[0] == "b" \
                else ""
            params, cfg = train_run(torch, ctx, *run, ckpt)
            del params
            release(torch, ctx)
            if ckpt:
                counts["window_attention"] = (
                    counts.get("window_attention", 0)
                    + serve_trained(torch, ctx, cfg, ckpt))
                release(torch, ctx)


def train_run(torch, ctx, label, arch, changes, batch, seq, steps, ckpt):
    """One run of phase 22 (b) / (c) through ``trainer.train``, then one
    step split into its parts and one under the profiler."""
    import numpy as np

    from repro_torch.data import pipeline
    from repro_torch.models import model, moe
    from repro_torch.optim import adamw
    from repro_torch.train import trainer
    from repro_torch.train.steps import param_dict
    dev = ctx["dev"]
    cfg = family_cfg(arch, changes)
    tcfg = trainer.TrainerConfig(steps=steps, batch=batch, seq_len=seq,
                                 log_every=1, ckpt_path=ckpt, seed=0,
                                 opt=train_opt(steps))
    times, mets, drops = [], [], []
    real_make, real_dispatch = trainer.make_train_step, moe.dispatch

    def timed_make(cfg_, opt_):
        step = real_make(cfg_, opt_)

        def run(params, opt_state, b):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            calls.clear()
            out = step(params, opt_state, b)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            mets.append({k: float(v) for k, v in out[2].items()})
            # a step dispatches each MoE layer twice, in the forward and
            # in backward's recomputation (the same inputs): keep the first
            drops.append([int(d) for d in calls[:len(calls) // 2]])
            return out
        return run

    def counted(x, eidx, n_experts, cap):
        buf, pos, keep = real_dispatch(x, eidx, n_experts, cap)
        calls.append((~keep).sum())
        shape.update(cap=cap, assignments=keep.numel())
        return buf, pos, keep
    calls, shape = [], {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer.make_train_step, moe.dispatch = timed_make, counted
    try:
        params, opt_state, history = trainer.train(cfg, tcfg, device=dev)
    finally:
        trainer.make_train_step, moe.dispatch = real_make, real_dispatch
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    n_params = sum(p.numel() for p in params.parameters())
    step_s = float(np.median(times[1:]))
    flops = model_flops(params, cfg, batch, seq)
    reduced = ", ".join(f"{k} {v}" for k, v in changes.items())
    log(f"({label}) {arch} ({cfg.arch_type}; {reduced}): {n_params:,} bf16 "
        f"parameters ({n_params * 2 / 1e9:.2f} GB, float32 moments "
        f"{n_params * 8 / 1e9:.2f} GB), batch {batch} x {seq}, {steps} "
        f"steps through trainer.train in {wall:.1f} s (checkpoint "
        f"included{'' if ckpt else ': none'})")
    log(f"({label}) ms a step (median of steps 2-{steps}): "
        f"{1e3 * step_s:.1f} (first {1e3 * times[0]:.1f}; "
        + ", ".join(f"{1e3 * t:.1f}" for t in times[1:]) + f"), "
        f"{batch * seq / step_s:,.0f} tokens/s, peak device memory "
        f"{peak / 2**30:.2f} GiB")
    log(f"({label}) loss " + ", ".join(f"{m['loss']:.4f}" for m in mets)
        + "; gnorm " + ", ".join(f"{m['grad_norm']:.3f}" for m in mets)
        + "; lr " + ", ".join(f"{m['lr']:.2e}" for m in mets))
    log(f"({label}) model FLOPs a step: 6 N T + 12 L S^2 H dh B = "
        f"{flops / 1e12:.1f} TFLOP (N {matmul_params(params, cfg) / 1e9:.3f}"
        f" B multiplied a token, T {batch * seq}); "
        f"{flops / step_s / 1e12:.1f} TFLOP/s, "
        f"{flops / step_s / H100_BF16_FLOPS:.3f} of the dense bf16 peak "
        f"({H100_BF16_FLOPS / 1e12:.0f} TFLOP/s)")
    if shape:
        log(f"({label}) MoE assignments dropped, each step's layers (cap "
            f"{shape['cap']} an expert, {shape['assignments']} assignments "
            f"a layer, {cfg.moe.n_experts} experts, top-{cfg.moe.top_k}): "
            f"{drops}")
    losses = [m["loss"] for m in mets]
    if not all(np.isfinite([m["loss"] for m in mets]
                           + [m["grad_norm"] for m in mets])):
        raise AssertionError(f"({label}) a loss or gnorm is not finite")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"({label}) the loss did not fall: {losses}")
    if [s for s, _ in history] != list(range(steps)):
        raise AssertionError(f"({label}) history {history}")

    # one more step, split into its parts by CUDA events
    b = pipeline.make_batch(cfg, batch, seq, seed=777, device=dev)
    named = list(params.named_parameters())
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    torch.cuda.synchronize()
    with model.trainable(params):
        ev[0].record()
        x, aux = model.hidden(params, cfg, b)
        ev[1].record()
        loss = model.token_nll(params, cfg, x, b["labels"]) \
            + (0.01 if cfg.moe is not None else 0.0) * aux
        ev[2].record()
        grads = torch.autograd.grad(loss, [p for _, p in named])
        ev[3].record()
    del x
    with torch.no_grad():
        opt_state, _ = adamw.update_(
            tcfg.opt, {n: g for (n, _), g in zip(named, grads)}, opt_state,
            param_dict(params))
    ev[4].record()
    torch.cuda.synchronize()
    del grads
    parts = [ev[i].elapsed_time(ev[i + 1]) for i in range(4)]
    total = sum(parts)
    log(f"({label}) one step split by CUDA events: " + ", ".join(
        f"{k} {v:.1f} ms ({100 * v / total:.1f}%)" for k, v in zip(
            ("forward (trunk, remat)", "loss (logits, logsumexp)",
             "backward (recompute + grads)", "optimizer (AdamW, in place)"),
            parts)) + f"; {total:.1f} ms")
    box = [params, opt_state]
    step = trainer.make_train_step(cfg, tcfg.opt)

    def one_step(_):
        box[0], box[1], _m = step(box[0], box[1], b)
    try:
        wall_s, busy_s, top, n_k = device_busy(torch, one_step)
    except Exception:
        traceback.print_exc()
        busy_s = None
    if busy_s is None:
        log(f"({label}) device idle share: not measured (no device time)")
    else:
        log(f"({label}) one step under torch.profiler: wall "
            f"{1e3 * wall_s:.1f} ms, device busy {1e3 * busy_s:.1f} ms, "
            f"idle share {max(0.0, 1 - busy_s / wall_s):.3f}, {n_k} device "
            "kernels")
        for t, name, _ in top[:8]:
            log(f"  {t / 1e3:9.2f} ms  {name[:70]}")
    del box, opt_state, b
    return params, cfg


def npz_shapes(np, path):
    """Each array's shape in an ``.npz``, from the headers alone (reading
    the arrays of a 4.7 GB checkpoint to learn their shapes took ~10 s)."""
    import zipfile
    fmt = np.lib.format
    shapes = {}
    with zipfile.ZipFile(path) as z:
        for name in z.namelist():
            with z.open(name) as f:
                major, _ = fmt.read_magic(f)
                read = (fmt.read_array_header_1_0 if major == 1
                        else fmt.read_array_header_2_0)
                shapes[name.removesuffix(".npy")] = tuple(read(f)[0])
    return shapes


def serve_trained(torch, ctx, cfg, ckpt):
    """(b)'s checkpoint into a fresh ``Model`` (the reference's keys and
    shapes), then a prompt teacher-forced through decode at decode_32k
    against ``prefill``, and 16 greedy tokens through B4, counted.
    Returns window_attention's launches."""
    import numpy as np

    from repro_torch import interop
    from repro_torch.data import pipeline
    from repro_torch.kernels.window_attention import window_attention
    from repro_torch.launch import serve
    from repro_torch.models import model
    from repro_torch.serve import engine
    from repro_torch.train import trainer
    dev = ctx["dev"]
    t0 = time.perf_counter()
    params, step = trainer.restore_params(ckpt, cfg, device=dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    want = {k.replace(".", "::"): tuple(v.shape) for k, v in
            interop.params_to_arrays(params, cfg).items()}
    got = {k: v for k, v in npz_shapes(np, ckpt).items() if k != "__step__"}
    log(f"(b) checkpoint: {os.path.getsize(ckpt) / 1e9:.2f} GB, "
        f"{len(got)} keys (stacked [L, ...], '::' paths), step {step}; "
        f"restored into a fresh Model in {secs:.1f} s")
    if got != want or step != TRAIN_RUNS[0][5]:
        raise AssertionError(f"(b) checkpoint keys or shapes differ from "
                             f"the reference layout, or step {step}")
    toks = pipeline.make_batch(cfg, SERVE_BATCH, SERVE_PROMPT, seed=4321,
                               device=dev)["tokens"]
    want_logits = model.prefill(params, cfg, {"tokens": toks})
    state = engine.init_cache(cfg, SERVE_BATCH, FAMILY_CTX, device=dev)
    state.cache_len.zero_()
    window_attention.launches = 0
    for i in range(SERVE_PROMPT):
        logits, state = engine.decode_step(params, cfg, toks[:, i:i + 1],
                                           state)
    forced = window_attention.launches
    d, ref = logits[:, :cfg.vocab], want_logits[:, :cfg.vocab]
    diff = float((d - ref).abs().max())
    excess = float(((d - ref).abs() - DECODE_PREFILL_TOL
                    * (1 + ref.abs())).max())
    ratio = float(((d - ref).abs() / (1 + ref.abs())).max())
    log(f"(b) trained model, bf16: {SERVE_PROMPT} teacher-forced decode steps "
        f"vs prefill, last logits max |diff| {diff:.2e}, max |diff| / (1 + "
        f"|prefill|) {ratio:.2e} (limit {DECODE_PREFILL_TOL}); "
        f"window_attention launches {forced}")
    if not excess <= 0:
        raise AssertionError(f"(b) decode off prefill by {diff}")
    tok = torch.argmax(logits[:, :cfg.vocab], dim=-1)[:, None].int()
    window_attention.launches = 0
    seqs, logits, state, seconds = serve.generate(params, cfg, tok, state,
                                                  FAMILY_TOKENS)
    n_launch = window_attention.launches
    step_ms = 1e3 * sum(seconds[1:]) / (len(seconds) - 1)
    log(f"(b) {FAMILY_TOKENS} greedy tokens at decode_32k (batch "
        f"{SERVE_BATCH}, {SERVE_PROMPT} rows of {FAMILY_CTX} filled): "
        f"{step_ms:.2f} ms a step; window_attention launches {n_launch} "
        f"(expected {cfg.n_layers} a step); tokens of request 0: "
        f"{seqs[0].tolist()}")
    if n_launch != cfg.n_layers * FAMILY_TOKENS or forced != \
            cfg.n_layers * SERVE_PROMPT:
        raise AssertionError(f"(b) {forced} + {n_launch} window_attention "
                             f"launches, not {cfg.n_layers} a step")
    if not bool(torch.isfinite(logits[:, :cfg.vocab]).all()):
        raise AssertionError("(b) decode logits not finite")
    del params, state
    return forced + n_launch


# ----------------------------------------------------------------------
# Phase 23: the tooling (the dry run against the card, the graph dry run)
# ----------------------------------------------------------------------

TOOL_PEAK_TOL = 0.10           # the dry run's peak vs the card's, relative
ROW_SHARDS = 16                # (c): the 16x16 mesh's "model" axis
ROW_SHARD_TOL = ATTN_TOL       # (c): merged row shards vs B4 whole and the
                               # plain version, max |diff|: B4's own limit
# graph_dryrun's default vertices and shards, 2 of its 4 supersteps (a
# 256-shard superstep takes 5 s on the card, nearly all of it host time)
GRAPH_DRY = (16_384, 256, 2)
GRAPH_TOTAL_RTOL = 1e-6        # a float32 sum's partials merged in order


def tool_runs():
    """The real steps of phases 22 (b, c), 10 (decode_32k) and 21 (a-e):
    ``(label, arch, config changes, kind, batch, sequence)``."""
    runs = [(f"22{label}", arch, changes, "train", batch, seq)
            for label, arch, changes, batch, seq, _ in TRAIN_RUNS]
    shape, batch, ctx_len = SERVE_CASES[0]
    runs.append((f"10 {shape}", SERVE_ARCH, {}, "decode", batch, ctx_len))
    runs += [(f"21{label}", arch, changes, "decode", batch, FAMILY_CTX)
             for label, arch, changes, batch, _, _ in FAMILY_RUNS]
    return runs


def phase_tooling(torch, ctx):
    """(a) Each of ``tool_runs``' steps dry-run on meta at the one-card
    mesh, then run on the card: its peak against the dry run's, and the
    op walker's count of the real step against the dry run's; (b) the
    256-shard graph dry run against one shard; (c) B4 over row shards,
    merged; (d) a decode step as DTensors on a one-rank mesh."""
    counts = ctx.setdefault("launches", {})
    release(torch, ctx)
    rows = []
    for run in tool_runs():
        row, n_launch = tool_run(torch, ctx, *run)
        rows.append(row)
        counts["window_attention"] = (counts.get("window_attention", 0)
                                      + n_launch)
        release(torch, ctx)
    ctx["tool_rows"] = rows
    counts["ell_spmv"] = counts.get("ell_spmv", 0) + graph_dry_run(torch,
                                                                   ctx)
    release(torch, ctx)
    counts["window_attention"] += row_shard_case(torch, ctx)
    release(torch, ctx)
    counts["window_attention"] += dtensor_decode(torch, ctx)
    release(torch, ctx)


def row_shard_case(torch, ctx):
    """Phase 23 (c): qwen3-4b's decode_32k attention (bf16, batch 4,
    32,768 rows, 32 / 8 heads of 128) split into ``ROW_SHARDS`` row
    shards, as a 16x16 mesh's ``"model"`` axis holds the cache: each
    shard's partial from B4's partial entry at its own lengths, merged
    by ``merge_partials``, against B4 on the whole cache and the plain
    version (within ``ROW_SHARD_TOL``, the limit B4 itself is held to:
    its bf16 body is ~2e-6 from float32, and other split boundaries sum
    in another order); one request ends inside a shard
    and one covers less than one, so shards are empty.  B4's launches
    are set to 0 just before the sharded call and read just after.
    Returns them."""
    from repro_torch.kernels.ref import decode_window_attention_ref
    from repro_torch.kernels.window_attention import (
        window_attention, window_attention_partial)
    from repro_torch.kernels.window_attention_spmd import merge_partials
    dev = ctx["dev"]
    gen = torch.Generator(device=dev).manual_seed(23)
    b, h, hkv, w, dh = 4, 32, 8, 32_768, 128
    rows = w // ROW_SHARDS
    q = torch.randn((b, h, dh), generator=gen, device=dev)
    k = torch.randn((b, w, hkv, dh), generator=gen,
                    device=dev).to(torch.bfloat16)
    v = torch.randn((b, w, hkv, dh), generator=gen,
                    device=dev).to(torch.bfloat16)
    kvl = torch.tensor([w, 20_000, rows // 2, w - 7], dtype=torch.int32,
                       device=dev)
    lens = [torch.clamp(kvl - s * rows, 0, rows).to(torch.int32)
            for s in range(ROW_SHARDS)]
    empty = sum(int((x == 0).sum()) for x in lens)

    def partials():
        return [window_attention_partial(q, k[:, s * rows:(s + 1) * rows],
                                         v[:, s * rows:(s + 1) * rows],
                                         lens[s])
                for s in range(ROW_SHARDS)]

    def merge(parts):
        o, m, l = (torch.stack(t) for t in zip(*parts))
        return merge_partials(o, m, l)

    torch.cuda.synchronize()
    window_attention.launches = 0
    got = merge(partials())
    torch.cuda.synchronize()
    n_launch = window_attention.launches
    whole = window_attention(q, k, v, kvl)
    plain = decode_window_attention_ref(q, k, v, kvl)
    torch.cuda.synchronize()
    err_whole = float((got - whole).abs().max())
    err_plain = float((got - plain).abs().max())
    err_b4 = float((whole - plain).abs().max())
    top = float(plain.abs().max())
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    parts = partials()
    part_ms, _ = time_cuda(torch, partials, 20, flush)
    merge_ms, _ = time_cuda(torch, lambda: merge(parts), 20, flush)
    whole_ms, _ = time_cuda(torch, lambda: window_attention(q, k, v, kvl),
                            20, flush)
    bms, by = attention_bound(kvl, h, hkv, dh, k.element_size())
    log(f"(c) B4 over {ROW_SHARDS} row shards of {rows} rows, [{b}, {h}, "
        f"{hkv}, {w}, {dh}] bf16, kv_len {kvl.tolist()} ({empty} empty "
        f"(request, shard) pairs): {ROW_SHARDS} partial launches "
        f"{part_ms:.4f} ms + merge {merge_ms:.4f} ms against the whole "
        f"launch {whole_ms:.4f} ms (bound {bms:.4f}, {by}); max |diff| "
        f"{err_whole:.2e} from B4 whole, {err_plain:.2e} from the plain "
        f"version (B4 whole from it: {err_b4:.2e}; limit {ROW_SHARD_TOL}; "
        f"max |plain| {top:.3e}); window_attention launches {n_launch}; "
        f"{ctx['smi']}")
    if n_launch != ROW_SHARDS or not empty:
        raise AssertionError(f"(c) {n_launch} launches, {empty} empty shards")
    if not bool(torch.isfinite(got).all()) or not (
            err_whole <= ROW_SHARD_TOL and err_plain <= ROW_SHARD_TOL):
        raise AssertionError(f"(c) merged row shards off B4 whole by "
                             f"{err_whole}, the plain version by {err_plain}")
    ctx.setdefault("attn_cases", []).append(
        dict(label="row shards", max_abs_err=err_plain,
             ms=part_ms + merge_ms, plain_ms=None, bound_ms=bms))
    return n_launch


def dtensor_decode(torch, ctx):
    """Phase 23 (d): one qwen3-4b decode_32k step (36 layers, batch 4)
    plain, then as DTensors on a one-rank ``(1, 1)`` mesh over the card
    (a fake group: one rank issues no collective) under the op walker:
    the logits bitwise the plain step's, B4's 36 launches (set to 0 just
    before, read just after), no collective recorded.  Returns the
    launches."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch import configs
    from repro_torch.configs.base import InputShape
    from repro_torch.kernels.window_attention import window_attention
    from repro_torch.launch import dryrun, shardctx
    from repro_torch.launch.mesh import DeviceMesh, torch_mesh
    from repro_torch.models import model
    from repro_torch.roofline import op_walk
    from repro_torch.serve import engine
    from repro_torch.train.steps import make_serve_step
    dev = ctx["dev"]
    cfg = configs.get(SERVE_ARCH)
    shape_name, batch, ctx_len = SERVE_CASES[0]
    shape = InputShape(shape_name, ctx_len, batch, "decode")
    params = model.init_params(cfg, seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(4)
    tok = torch.randint(0, cfg.vocab, (batch, 1), generator=gen, device=dev,
                        dtype=torch.int32)
    step = make_serve_step(cfg)
    want, _ = step(params, tok, engine.init_cache(cfg, batch, ctx_len,
                                                  device=dev))
    torch.cuda.synchronize()
    mesh = DeviceMesh(("data", "model"), (1, 1))
    t0 = time.perf_counter()
    with torch_mesh(mesh, "cuda") as tm, shardctx.use_mesh(mesh), \
            implicit_replication():
        args = dryrun.distribute_args(
            cfg, shape, tm, {"params": params, "token": tok,
                             "state": engine.init_cache(cfg, batch, ctx_len,
                                                        device=dev)},
            fsdp=True)
        window_attention.launches = 0
        with op_walk.OpWalk() as walk:
            got, _ = step(args["params"], args["token"], args["state"])
        torch.cuda.synchronize()
        n_launch = window_attention.launches
        got = got.full_tensor()
    secs = time.perf_counter() - t0
    colls = sum(n for rec, n in walk.trace() if rec[0].startswith("c10d."))
    same = bool(torch.equal(got, want))
    log(f"(d) {SERVE_ARCH} {shape_name} step (batch {batch}) as DTensors on "
        f"a (1, 1) cuda mesh: logits bitwise the plain step's: {same}; "
        f"window_attention launches {n_launch} (expected {cfg.n_layers}); "
        f"collectives recorded {colls}; {secs:.1f} s with DTensor's first "
        f"sharding decisions")
    if not same or n_launch != cfg.n_layers or colls:
        raise AssertionError(f"(d) bitwise {same}, {n_launch} launches, "
                             f"{colls} collectives")
    del params, args, got, want
    return n_launch


def _storage_bytes(tensors):
    seen = {}
    for t in tensors:
        st = t.untyped_storage()
        seen[st.data_ptr()] = st.nbytes()
    return sum(seen.values())


def tool_run(torch, ctx, label, arch, changes, kind, batch, seq):
    """One run of phase 23 (a); returns its row and window_attention
    launches."""
    from repro_torch.configs.base import InputShape
    from repro_torch.data import pipeline
    from repro_torch.kernels.window_attention import window_attention
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import one_card_mesh
    from repro_torch.models import model
    from repro_torch.optim import adamw
    from repro_torch.roofline import op_walk
    from repro_torch.serve import engine
    from repro_torch.train.steps import (make_serve_step, make_train_step,
                                         param_dict)
    dev = ctx["dev"]
    cfg = family_cfg(arch, changes)
    shape = InputShape(f"{kind} {batch}x{seq}", seq, batch, kind)
    opt = adamw.AdamWConfig()
    t0 = time.perf_counter()
    row = dryrun.dry_run(cfg, shape, one_card_mesh(),
                         name=f"{label} {arch}", verbose=False, opt_cfg=opt)
    t_dry = time.perf_counter() - t0

    params = model.init_params(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    if kind == "train":
        args = (params, adamw.init(param_dict(params)),
                pipeline.make_batch(cfg, batch, seq, device=dev))
        step = make_train_step(cfg, opt)
    else:
        tok = torch.randint(0, cfg.vocab, (batch, 1), generator=gen,
                            device=dev, dtype=torch.int32)
        args = (params, tok, engine.init_cache(cfg, batch, seq, device=dev))
        step = make_serve_step(cfg)
    out = step(*args)                   # warms up
    torch.cuda.synchronize()
    del out
    arg_bytes = _storage_bytes(dryrun._tensors(args))
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    window_attention.launches = 0
    t1 = time.perf_counter()
    out = step(*args)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t1)
    n_launch = window_attention.launches
    measured = arg_bytes + torch.cuda.max_memory_allocated() - base
    del out
    walked = dryrun.walk(lambda: step(*args), args)
    torch.cuda.synchronize()
    cost = op_walk.cost_from_records(walked.trace)
    mem = row["memory"]
    predicted = mem["peak_gb"] * 1e9
    err = abs(predicted - measured) / measured
    log(f"({label}) {arch} ({', '.join(f'{k} {v}' for k, v in changes.items()) or 'whole'}) "
        f"{kind}, batch {batch} x {seq}: dry run on meta {t_dry:.1f} s, "
        f"{row['ops']} ops; peak: dry run {predicted / 2**30:.3f} GiB "
        f"(arguments {mem['argument_gb'] * 1e9 / 2**30:.3f} + temp "
        f"{mem['temp_gb'] * 1e9 / 2**30:.3f}), card {measured / 2**30:.3f} "
        f"GiB (arguments {arg_bytes / 2**30:.3f} + max_memory_allocated "
        f"above them {(measured - arg_bytes) / 2**30:.3f}), off by "
        f"{100 * err:.4f} % ({predicted - measured:+.0f} bytes); flops: dry "
        f"run {row['hlo_flops']:.6e}, the "
        f"walker on the card {cost.flops:.6e}; bytes: dry run "
        f"{row['hlo']['hbm_bytes']:.6e}, card {cost.bytes:.6e}; walker's "
        f"peak on the card {walked.peak_bytes / 2**30:.3f} GiB temp; "
        f"roofline t_compute {1e3 * row['t_compute_s']:.3f} ms, t_memory "
        f"{1e3 * row['t_memory_s']:.3f} ms ({row['bottleneck']}), measured "
        f"{ms:.2f} ms a step ({row['t_memory_s'] * 1e3 / ms:.3f} of it the "
        f"memory term); model flops {row['model_flops']:.4e} (usefulness "
        f"{row['usefulness']:.3f}); window_attention launches {n_launch}")
    if cost.flops != row["hlo_flops"]:
        raise AssertionError(f"({label}) the dry run counts "
                             f"{row['hlo_flops']} flops, the real step "
                             f"{cost.flops}")
    if not err <= TOOL_PEAK_TOL:
        raise AssertionError(f"({label}) dry-run peak {predicted} vs card "
                             f"{measured}: {100 * err:.1f} % apart")
    if kind == "decode" and cfg.arch_type != "ssm" and n_launch == 0:
        raise AssertionError(f"({label}) no window_attention launch")
    row.update(label=label, card_peak_bytes=measured, card_ms=ms,
               card_flops=cost.flops, card_bytes=cost.bytes)
    del params, args, walked
    return row, n_launch


def graph_dry_run(torch, ctx):
    """Phase 23 (b): ``graph_dryrun`` at ``GRAPH_DRY`` on the card, B1's
    launches set to 0 just before the supersteps and read just after,
    against the same supersteps on one shard: ranks and updates bitwise,
    ``total_rank`` within ``GRAPH_TOTAL_RTOL`` (the sync adds the
    shards' partial sums in shard order, one float32 rounding a shard,
    where one shard sums its rows at once); returns the launches."""
    from repro_torch.kernels.ell_spmv import ell_spmv
    from repro_torch.launch import graph_dryrun
    from repro_torch.launch.graph_dryrun import plan_summary
    dev = ctx["dev"]
    nv, shards, steps = GRAPH_DRY
    runs = {}
    for m in (shards, 1):
        eng, edges, t_host = graph_dryrun.build(nv, m, steps, dev)
        torch.cuda.synchronize()
        ell_spmv.launches = 0
        t0 = time.perf_counter()
        res, updates, ms = graph_dryrun.run_supersteps(eng, steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs[m] = (res, updates, ell_spmv.launches)
        if m > 1:
            log(f"(b) graph dry run: {nv} vertices, {len(edges)} edges, "
                f"{m} shards, R {eng.plan.R}, Hv {eng.plan.Hv}, colors "
                f"{eng.plan.n_colors}; host set-up (graph, partition, plan, "
                f"engine) {t_host:.1f} s; {plan_summary(eng.plan, edges)[0]}")
        log(f"(b) {m} shard(s): {steps} supersteps in {wall:.2f} s, ms a "
            f"superstep {[round(t, 1) for t in ms]}, updates {updates}, "
            f"ell_spmv launches {ell_spmv.launches}, total_rank "
            f"{float(res['globals']['total_rank'])!r}; host set-up "
            f"{t_host:.1f} s")
        del eng
    (r_m, u_m, n_m), (r_1, u_1, _) = runs[shards], runs[1]
    diff = int((r_m["vertex_data"]["rank"] != r_1["vertex_data"]["rank"])
               .sum())
    t_m = float(r_m["globals"]["total_rank"])
    t_1 = float(r_1["globals"]["total_rank"])
    log(f"(b) {shards} shards vs one: {diff} ranks differ; n_updates "
        f"{r_m['n_updates']} / {r_1['n_updates']}; total_rank {t_m!r} / "
        f"{t_1!r} (relative {abs(t_m - t_1) / abs(t_1):.2e}, limit "
        f"{GRAPH_TOTAL_RTOL}), the sum of the {shards}-shard ranks in "
        f"float64 {float(r_m['vertex_data']['rank'].double().sum())!r}")
    if n_m == 0:
        raise AssertionError("(b) the graph dry run launched no ell_spmv")
    if diff or r_m["n_updates"] != r_1["n_updates"] or u_m != u_1:
        raise AssertionError("(b) the 256-shard graph dry run's ranks or "
                             "updates are not bitwise the one-shard run's")
    if not abs(t_m - t_1) <= GRAPH_TOTAL_RTOL * abs(t_1):
        raise AssertionError(f"(b) total_rank {t_m} vs one shard's {t_1}")
    return n_m


def main() -> int:
    started = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        log("FAIL: no CUDA device (torch.cuda.is_available() is False)")
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        log(f"FAIL: no src/repro_torch beside {Path(__file__).name}: run it "
            "from a checkout of the repository")
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as exc:
        smi = f"nvidia-smi failed: {exc}"
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    from repro_torch.kernels import _build
    dev = cuda_device(torch)
    ctx = {"dev": dev, "smi": smi}
    failed = []

    t0 = time.perf_counter()
    try:
        logs = _build.build(["ell_spmv", "als_normal_eq", "window_attention",
                             "segment_combine"])
        log(f"phase 1 build: {time.perf_counter() - t0:.1f} s")
        for name, text in logs.items():
            for line in text.splitlines():
                if ("registers" in line or "spill" in line
                        or "Compiling entry" in line):
                    log(f"  {name}: {line.strip()}")
        log_attention_bodies(torch)
        from repro_torch.kernels.als_normal_eq import geometry
        log("  als_normal_eq (warps a row, rows a block, mask window): "
            + ", ".join(f"d={d} {geometry(d)}" for d in (5, ALS_D, 64)))
    except Exception:
        traceback.print_exc()
        log("FAIL: phase 1 build")
        return 1

    from repro_torch.apps import pagerank
    from repro_torch.core.graph import zipf_edges
    t0 = time.perf_counter()
    edges = zipf_edges(FULL_N, alpha=2.0, max_deg=256, seed=0)
    t1 = time.perf_counter()
    graph, update, syncs = pagerank.build(edges, FULL_N, eps=EPS, device=dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    sizes = [int((graph.colors == c).sum()) for c in range(graph.n_colors)]
    log(f"full-size graph: {FULL_N} vertices, {len(edges)} edges, "
        f"{graph.n_colors} colors (largest {max(sizes)}), "
        f"{graph.ell.padded_slots} sliced slots, widths {graph.ell.widths}; "
        f"host set-up: edges {t1 - t0:.1f} s, build + coloring "
        f"{t2 - t1:.1f} s")
    ctx.update(graph=graph, update=update, syncs=syncs, edges=edges,
               zipf_edges=edges, zipf_colors=graph.colors.cpu().numpy())
    del graph, update, syncs, edges      # ctx holds them until phase 8

    for name, fn in (("phase 2 kernels", phase_kernels),
                     ("phase 3 parity", phase_parity),
                     ("phase 4 main path", phase_main),
                     ("als set-up", setup_als),
                     ("phase 5 als kernels", phase_als_kernels),
                     ("phase 6 als parity", phase_als_parity),
                     ("phase 7 als main path", phase_als_main),
                     ("phase 8 attention kernels", phase_attention),
                     ("phase 9 serve parity", phase_serve_parity),
                     ("phase 10 serve main path", phase_serve_main),
                     ("schedulers set-up", setup_schedulers),
                     ("phase 11 schedulers kernels", phase_sched_kernels),
                     ("phase 12 schedulers parity", phase_sched_parity),
                     ("phase 13 schedulers main path", phase_sched_main),
                     ("split set-up", setup_split),
                     ("phase 14 split kernels", phase_split_kernels),
                     ("phase 15 split and app parity", phase_split_parity),
                     ("phase 16 split and apps main path",
                      phase_split_main),
                     ("phase 17 facade and cost model", phase_facade),
                     ("phase 18 distributed", phase_distributed),
                     ("phase 19 fault tolerance", phase_ft),
                     ("phase 20 online serving", phase_serving),
                     ("phase 21 model families, reduced gates",
                      phase_family_parity),
                     ("phase 21 model families on the card",
                      phase_families),
                     ("phase 22 training, reduced gates",
                      phase_train_parity),
                     ("phase 22 training on the card", phase_train),
                     ("phase 23 tooling", phase_tooling)):
        log(f"--- {name}")
        t0 = time.perf_counter()
        try:
            fn(torch, ctx)
            log(f"{name}: ok ({time.perf_counter() - t0:.1f} s)")
        except Exception:
            traceback.print_exc()
            log(f"FAIL: {name}")
            failed.append(name)
    if failed:
        log(f"FAILED: {failed}")
        return 1
    log(f"all phases: {time.perf_counter() - started:.1f} s")

    sweep = ctx["kernel_sweep"]       # a PageRank sweep, one launch
    kernels = [{
        "name": "ell_spmv", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ell_spmv.cu",
        "replaces": "src/repro/kernels/ell_spmv.py:48",
        "launches": ctx["launches"]["ell_spmv"],
        "max_abs_err": max([ctx["kernel_max_err"]] + [
            c["max_abs_err"] for key in ("sched_kernel_cases",
                                         "split_b1_cases", "facade_b1_cases")
            for c in ctx[key]] + [c["max_abs_err"] for c in
                                  ctx["dist_cases"]["ell_spmv"]]),
        **{k: sweep[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                 "library_ms")},
    }]
    folds = ctx["als_folds"]
    kernels.append({
        "name": "als_normal_eq", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/als_normal_eq.cu",
        "replaces": "src/repro/kernels/als_normal_eq.py:26",
        "launches": ctx["launches"]["als_normal_eq"],
        "max_abs_err": max(c["max_abs_err"] for c in ctx["als_cases"]
                           + ctx["dist_cases"]["als_normal_eq"]),
        # the main path's launches of one superstep: one fold a group of
        # the color-major plan
        **{k: sum(c[k] for c in folds)
           for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
        "bound_by": "/".join(sorted({c["bound_by"] for c in folds})),
    })
    step = ctx["attn_cases"][0]       # decode_32k with the cache full
    n_layers = ctx["serve_n_layers"]
    kernels.append({
        "name": "window_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/window_attention.cu",
        "replaces": "src/repro/kernels/window_attention.py:25",
        "launches": ctx["launches"]["window_attention"],
        "max_abs_err": max(c["max_abs_err"] for c in ctx["attn_cases"]),
        # one decode_32k step's launches: one a layer
        **{k: n_layers * step[k]
           for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
        "bound_by": step["bound_by"],
    })
    owner = ctx["split_seg_cases"][0]   # a split PageRank phase's combine
    kernels.append({
        "name": "segment_combine", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/segment_combine.cu",
        "replaces": "src/repro/kernels/ell_spmv.py:185",
        "launches": ctx["launches"]["segment_combine"],
        "max_abs_err": max(c["max_abs_err"] for c in ctx["split_seg_cases"]
                           + ctx["dist_cases"]["segment_combine"]),
        **{k: owner[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                 "library_ms")},
    })
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
