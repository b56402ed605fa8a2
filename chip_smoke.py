#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Drives the port's main path on one CUDA card — spiral points ->
``make_normalized_adjacency`` -> ``eigsh`` (single-vector and block) ->
``spectral_clustering`` at n = 100,000 — after building the hand-written
kernels from ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per source, all
at once) and holding each one against its plain PyTorch version at the
paths' shapes (the window kernels also on geometries that stress their
tile plan: uniform, unsorted, the SSL path's d = 2, 16 channels, and
windows over the box budget, d = 3 with m = 9 and 16, cut into slabs;
``kernel_matvec`` also at the guard and KRR paths' small shapes, which
split the sources).  Then
the paths of the exact direct sum (``kernel_matvec``): the accuracy
guard's direct floor under ``eigsh`` (spiral n = 8,000), kernel SSL on
crescent-fullmoon at n = 100,000 (paper Section 6.2.3), kernel ridge
regression at n = 10,000 with fast and direct prediction (Section 6.3), and
one direct matvec at n = 10^5.  Gradients follow KRR ([grad], float64):
d<w, W x>/d sigma and d/dx through ``with_kernel`` and the fused
pipeline's transpose at the main path's n = 10^5 (SETUP_2 and SETUP_3)
against a central difference of the card's own forward and the forward
matvec of w, KRR's rectangular operator against the one with sources and
targets swapped, sigma-bar at n = 10^4 against a central difference of
the direct sum (``kernel_matvec``), a broadcast bank of four, and the KRR
validation loss's (log sigma, log beta) gradients (implicit-diff CG)
against Richardson differences, with a poisoned training vector and
four steps of ``krr_fit_grad``; every pass one spread and one gather
launch each way.  Then the paper's Section 5 and 6.2.1
paths: the fused matvec against the two-NFFT reference (flat geometry,
no hand-written kernel) at n = 10^5; traditional and hybrid Nyström at
n = 4000 against dense eigvalsh (tests/test_nystrom.py's tiers) and at
n = 10^5, where the hybrid's probe blocks run the window kernels at
C = L = 20 and 50 (checked kernel vs plain too); and image segmentation
of a 533 x 800 synthetic image (426,400 pixels).  Then operator banks
(four Gaussians at n = 100,000 against the single operators), the
(sigma, beta) sweep of benchmarks/sweep_scaling.py at n = 50,000 against
sequential fits, multilayer SSL at n = 100,000, and the graph-predict
serving tier at benchmarks/serve_scaling.py's full size (plus the sweep's
16 cells as tenants) against per-request replans and the direct oracle,
with its guards and one tick taken apart.  Then durability
([durable]): cuFFT's and cuBLAS's products repeated bit for bit; the
window spread's deterministic mode (the switch
torch.use_deterministic_algorithms) five times bitwise equal and within
the spread's tolerance of plain, at the main path's shapes (C = 1 and
16), the sweep's d = 1 and 2 geometries and the d = 3, m = 9 pieces;
resumable_eigsh on the main path's spiral (n = 10^5, SETUP_2 and
SETUP_3, 80 steps) killed at step 37, in process and across processes,
and resumable_solve on [krr]'s Gram (n = 10^4, tol 1e-10) and on
[bank]'s four lockstep Gaussians, killed twice each: every result bitwise
equal to the uninterrupted run and to the plain solver under the same
switch (and, for information only, the drift of a resumed run with the
switch off); the registry journal of [graph_serve]'s two uniform tenants
recovered into a registry that serves the same bits with no replan; two
dropped ticks counted and every output against the oracle; the fault
schedule against the JAX package's.  Then the distributed matvec
([dist]): four ranks spawned on the one card over gloo (NCCL refuses two
ranks on one device; gloo stages CUDA tensors through the host), each
spreading and gathering its block of the Morton-sorted rows: psum and
pencil modes at n = 10^5 (SETUP_2, SETUP_3) on meshes (4,) and (2, 2)
(also the row x col split), n = 10^6, [bank]'s four Gaussians broadcast
and lockstep, eigsh (k = 10, 80 steps) and compress_psum on (4, 10^6)
float32 gradients, each against the single-device result on the card,
y bitwise equal on every rank, the shard kernels against their plain
versions on every rank's geometry, each rank's collective payload a
matvec; then one NCCL rank (world size 1, psum).  Then the LM serving
path: the flash attention kernels against their plain version (float32
on the TF32 tensor cores in three products, bf16 and f16 on wgmma: the JAX kernel
tests' shapes in float32 and bf16, granite-3-2b's heads in all three up
to one bf16 layer at its 32,768-token prefill length, decode
alignment), and granite-3-2b at full
width and depth (40 layers, bf16, seeded random weights) served by
``ServeEngine``: every prefill must launch the flash kernel once per
layer, every logit must be finite, and in float32 the engine's tokens must
equal a manual prefill+decode loop's.  Then granite-3-2b-nfft, the
paper's NFFT kernel attention in every layer, the same way
([nfft_serve]): no kernel of the package may launch (its transforms are
cuBLAS phase matmuls), its constant-size (S, z) cache is printed beside
granite-3-2b's KV cache, one 32,768-token prefill and eight decode steps
run on one slot, and one mixer layer is held against the exact Gaussian
attention in float64.  ``kernel_matvec``'s x-gradient (a second launch
on the swapped point sets) is held against the plain version's autograd
in [kernels].  Each path starts with every launch
count at 0 and must launch its kernels.  Then it times the kernels beside
their roofline bounds (and flash attention beside PyTorch's SDPA), the
window kernels' tile plan, the fused matvec at n = 10^5 and 10^6, the
Nyström methods and the segmentation's eigsh, prefill and decode.  Last,
LM training ([train]): granite-3-2b at full width and depth (bf16,
AdamW) takes eight steps of 2 x 4,096 tokens through the port's train
step, ``run_resilient`` and the Prefetcher (every parameter must move, the
loss on step 0's batch must fall; median step time, tokens/s, the
model-FLOPs share and peak memory are printed); at full width with 2
layers a kill-and-resume under the deterministic switch must equal the
uninterrupted run bit for bit, a compressed step's outputs must lie on
their blocks' int8 grids and its residuals within half a quantization
step, and granite-3-2b-nfft's learn_sigma step
must move log_sigma; no kernel of the package may launch on these paths
(the einsum attention and cuBLAS); the run without a checkpoint directory
keeps a host copy of the initial state (its bytes and seconds printed).
Then the same single-card step trains the other families at full width
([train_families], four steps each): olmoe-1b-7b (4 of 16 layers; the
router, 64 experts at top-8 and the aux loss), mamba2-1.3b (all 48
layers; the chunked SSD scan's backward) and deepseek-v3-671b (its 3
dense MLA layers and its MTP depth, under Adafactor as the uncut config
picks): every parameter must move, the loss on step 0's batch must fall,
the aux and MTP losses must be finite and positive, no kernel may launch;
step time, tokens/s, model-FLOPs share and peak memory are printed.
Then the sharded train step ([shard_train]): four gloo ranks sharing the
card hold their blocks of granite-3-2b's state at full width (2 layers,
float32) on meshes (4, 1), (2, 2) and (1, 4), and of olmoe-1b-7b's (2
layers) at (1, 4), gather weights on use and reduce-scatter gradients, the
ranks of "model" computing their block of the heads, hidden units, experts
and vocabulary; losses against the single-device step, unsplit leaves
bitwise equal on the ranks, each rank's bytes of state, each step's
collective bytes and each rank's forward matmul FLOPs against the
predictions from the sharding rules; a sharded checkpoint restored onto
(2, 2) and onto one device; then one NCCL rank at (1, 1) at full width and
depth beside [train]'s step; no kernel may launch.  [shard_serve] runs
the sharded prefill and decode steps on four gloo ranks sharing the card
(granite-3-2b, 2 of 40 layers, at (2, 2) and (1, 4); olmoe-1b-7b, 2 of
16, at (1, 4); float32, full width): every rank's whole logits against the
single-device steps and bitwise equal on the ranks, flash once a layer on
every rank's heads.  [dryrun] then runs the dry run (the port's steps
traced on meta as one rank of a described mesh) on four CPU ranks and
holds it against the live runs: every rank's collective bytes, FLOPs and
state bytes of [shard_train] and [shard_serve] to the byte, peak live
bytes within 25 %, [dist]'s payloads, and the roofline terms (data-sheet
peaks) of [train]'s step, [times]' prefill and tick and the fused matvec
as shares of their measured times; it prints granite-3-2b's production
cells and the graph cells at 8 to 512 ranks, and holds the attention
FLOPs of qwen1.5-32b's and paligemma-3b's train_4k cells on the 16 x 16
mesh, rank by rank, to each rank's ceil block of the heads.  Then the other mixers and the
frontends, each path with its launch counts from 0: olmoe-1b-7b (MoE, 64
experts, top-8) at full width and depth through ``ServeEngine``
([moe_serve]: the flash kernel once per layer and prefill, head dim 128;
in float32 the engine against a manual loop); mamba2-1.3b (Mamba2 SSD) at
full width and depth ([ssm_serve]: no kernel launches; its constant state
a slot beside granite-3-2b's KV cache; in float32 with 4 layers,
teacher-forced recurrent decode steps against the chunked forward);
deepseek-v3-671b (MLA, 256 experts) at full width with the depth cut 61 ->
4 and MTP cut 1 -> 0 ([mla_serve]: no kernel launches; the MLA cache a
token beside the expanded K/V; in float32 with 1 layer, absorbed decode
steps against the expanded forward); jamba-1.5-large at its reduced config
([hybrid_serve]: card against the same weights on the CPU); then the three
architectures no earlier phase runs at full width, every width kept and
the depth cut as one card forces (WIDE_SERVE; each cut's memory plan from
the meta device held against the card's peaks): llama3-405b with 4 of 126
layers ([llama_serve]: GQA 16:1, 128 q heads on 8 at head dim 128,
rope_theta 5e5, an untied 128,256-row head) and qwen1.5-32b with 32 of 64
([qwen_serve]: 40 MHA heads, QKV biases drawn nonzero), each prefill
launching flash once per layer and nothing else, flash against the einsum
in bf16 and float32, and in float32 at 2 and 8 layers the engine against a
manual loop; jamba-1.5-large with 2 of 72 layers ([jamba_serve]: Mamba +
the 16-expert top-2 MoE, then Mamba + dense; no launch; the Mamba state a
slot as its closed form; in float32 the engine against a manual loop and
teacher-forced decode steps against the chunked forward); and
[frontends]: hubert-xlarge at full width and depth prefilling 4,096 frames
through the flash kernel at head dim 80 (non-causal, 48 launches),
paligemma-3b at full width and depth (image prefix + tokens through the
einsum, then decode steps), and gemma-7b at full width with 2 layers
prefilling 2,048 tokens through the flash kernel at head dim 256, each
flash prefill against the einsum prefill in bf16 and float32.  Any failed
check raises, so the run exits non-zero and prints no result line.

    python3 chip_smoke.py [--json PATH]

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``;
the line before it is the kernels' JSON record (the window kernels once
per path of WINDOW_RECORDS and once per shape of the gradient, bank,
sweep, multilayer, graph-serve and [dist] paths (the last on rank 0's
shard, with the launches of every rank), the deterministic spread once per
[durable] path, ``kernel_matvec`` once per path that launches it, flash
attention once for [serve] and once per FAMILY_FLASH path, each with
that path's launches and shape, and in float32 once per FAMILY_FLASH_F32
path).  Before those two lines, [walls] gives every phase's wall.  Needs
one card and the repository checkout around this file; imports nothing of
JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
CU_SOURCE = "src/repro_torch/kernels/csrc/nfft_window.cu"
KM_SOURCE = "src/repro_torch/kernels/csrc/kernel_matvec.cu"
FA_SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"

# NVIDIA H100 SXM data sheet: HBM3 rate and the peaks outside the tensor
# cores (the window kernels issue plain FP64/FP32 FMAs).
HBM_BYTES_PER_S = 3.35e12
# shared memory a block can use on the H100 (227 KB)
SMEM_PER_BLOCK = 232448
PEAK_FLOPS = {"float64": 34e12, "float32": 67e12}
# ... and the bf16 dense tensor-core peak: the bound of training's matmuls
# (flash attention's bounds by dtype: roofline.TENSOR_PEAK_FLOPS)
PEAK_BF16_TENSOR = 989e12

N_MAIN = 100_000
N_BIG = 1_000_000
N_ANCHOR = 4000
SIGMA = 3.5
K_EIG = 10
K_CLUSTERS = 5
# kernel vs plain, relative to the plain output's largest entry.  Spread:
# a tile's windows are summed in row order in registers, and the tiles'
# boxes land on the grid with atomics in a varying order; gather: each
# node's window is summed in a fixed order that differs from the plain
# version's
TOL = {("spread", "float64"): 1e-12, ("spread", "float32"): 1e-4,
       ("gather", "float64"): 1e-13, ("gather", "float32"): 1e-5}
ADJOINT_TOL = 1e-10
TIERS = {"SETUP_1": 5e-3, "SETUP_2": 5e-8, "SETUP_3": 1e-13}
# Krylov dimension per block size; None is eigsh's default (40 at k=10).
# Ten blocks of 4 do not converge the 10th Ritz value to the SETUP_2
# tier, so the block run takes the 80 of tests/test_fastsum_exec.py (20
# block matvecs).
BLOCK_ITERS = {1: None, 4: 80}
# Window geometries beyond the main path's spirals that stress the tile
# plan, checked kernel vs plain and by the adjoint identity at n = 10^5:
# (kind, setup, d, channels).  "uniform": uniform random nodes (boxes ~2x
# a window); "unsorted": the spiral without the Morton sort (tiles split
# down to single rows); "ssl": the SSL path's crescent-fullmoon at N=128,
# m=3, d=2; C = 16: two channel chunks.
WINDOW_STRESS = (("uniform", "SETUP_3", 3, (1, 4)),
                 ("unsorted", "SETUP_3", 3, (1, 4)),
                 ("ssl", "SSL", 2, (1, 4)),
                 ("spiral", "SETUP_3", 3, (16,)))
# Windows over the box budget (6,144 cells): SETUP_2's N = 32 with m = 9
# and m = 16 (taps 19 and 33), d = 3, each window cut into slabs along its
# first axis; checked like the geometries above, and once more with seeded
# standard normal weights ("random"), whose outer taps are not ~0 as the
# Kaiser-Bessel window's are at m = 16, so every slab counts.
WIDE_WINDOWS = {"WIDE_M9": 9, "WIDE_M16": 16}

# The window kernels at C = L columns, the hybrid Nyström's probe blocks
# (L = 20 and 50): spiral SETUP_2, d = 3, kernel vs plain with the
# geometry's own weights and with seeded random ones
NYS_COLUMNS = (20, 50)

# [oracle]: the fused matvec (window kernels) against the two-NFFT path
# (flat geometry, index_add_, cuFFT), relative to the reference's largest
# entry: tests/test_fastsum_exec.py's limit
ORACLE_TOL = 1e-12
ORACLE_COLUMNS = (1, 4)
# [nystrom], paper Section 5, Gaussian sigma = SIGMA, float64.  Tiers at the
# anchor n = 4000 (tests/test_nystrom.py's): (method, L, rank, generator
# seed, largest eigenvalue error; None: reported, not tiered).  There the
# traditional method at L = n/10 = 400 is already within ~6e-7 (the JAX
# package: 5.7e-7), so the hybrid L=50 is held against the traditional at
# the same L = 50; "hybrid L=50 beats traditional L=n/10" is checked on
# the problem tests/test_nystrom.py states it for, spiral n = 800 (seed 4)
NYS_ANCHOR_RUNS = (("hybrid", 20, 10, 4, 5e-2), ("hybrid", 50, 10, 1, 1e-2),
                   ("hybrid", 50, 50, 1, None),
                   ("traditional", N_ANCHOR // 4, None, 0, 0.5),
                   ("traditional", N_ANCHOR // 10, None, 2, None),
                   ("traditional", 50, None, 2, None))
NYS_SMALL_N, NYS_SMALL_SEED = 800, 4
NYS_MAX_ABS_EIG = 1.01  # A's spectrum lies in [-1, 1]
# n = 10^5: the hybrid at each L (rank K_EIG) on the SETUP_2 operator, the
# traditional method at L = n/20 (fig6's rule; n/10 would hold ~40 GB of
# n x L matrices)
NYS_TRAD_L = N_MAIN // 20
# [segment], paper Section 6.2.1: synthetic_image at the photograph's
# 533 x 800 = 426,400 pixels, RGB nodes, sigma = 90, N=16, m=2, p=2,
# eps_B=1/8
SEG_H, SEG_W = 533, 800
N_SEG = SEG_H * SEG_W
SEG_SIGMA = 90.0
SEG_K = (2, 4)
# the JAX package's |lambda_1 - 1| from spectral_clustering on the 100 x 150
# example image (same parameters, key 0, k = 2 and 4, x64, CPU); the smoke's
# limit is 10x
JAX_SEG_LAMBDA1_ERR = 1.5543122344752192e-15
# the kernels' JSON record per path: (path, geometry kind, setup, d, C,
# dtype, n); the window kernels' launches of that path, times at its shape
WINDOW_RECORDS = (("main", "spiral", "SETUP_3", 3, 1, "float64", N_MAIN),
                  ("nystrom", "spiral", "SETUP_2", 3, NYS_COLUMNS[-1],
                   "float64", N_MAIN),
                  ("segment", "segment", "SEG", 3, 1, "float64", N_SEG))

# kernel_matvec vs plain, relative to the plain output's largest entry: the
# sums run in another order than the plain matrix product, and float32
# exp/sqrt differ by an ulp or two
KM_TOL = {"float64": 1e-12, "float32": 1e-4}
KM_PROFILES = (("gaussian", SIGMA), ("laplacian_rbf", SIGMA),
               ("multiquadric", 2.0), ("inverse_multiquadric", 2.0))
KM_SQUARE_N = (8000, N_MAIN)
KM_RECT = (400, 10_000)  # the KRR path's test x training points
# guard floor: spiral n=8000, SETUP_1 and a policy that can only end on the
# direct floor (tests/test_runtime_guards.py:143-150)
N_GUARD = 8000
GUARD_EIG_TOL = 1e-10
# kernel SSL, paper Section 6.2.3 at benchmarks/fig7_kernel_ssl.py's setting
N_SSL = 100_000
SSL_SIGMA, SSL_BETA, SSL_TOL, SSL_MAXITER, SSL_SAMPLES = 0.75, 1e3, 1e-4, 1000, 5
# kernel ridge regression, Section 6.3 at benchmarks/fig9_krr.py's setting
N_KRR, N_KRR_TEST = 10_000, 400
KRR_BETA, KRR_TOL, KRR_MAXITER = 1e-2, 1e-8, 2000
# [grad]: gradients through the fused pipeline, float64.  sigma-bar against
# a central difference of the card's own forward (step 1e-5 sigma) within
# tests/test_differentiable.py's 1e-6; x-bar against a forward matvec of
# w (the transposed operator's) within 1e-12 of max |x-bar|; the fused W's
# sigma-bar at n = 10^4 against a central difference (step 1e-4) of the
# direct sum within 1e-4; the KRR validation loss's (log sigma, log beta)
# gradients against a Richardson-extrapolated central difference (steps
# h and h/2) within 1e-5, its CG at GRAD_KRR_TOL; GRAD_FIT_STEPS Adam steps
# of krr_fit_grad.  BENCH_grad.json's value-and-grad / forward target (a
# CPU figure) is printed beside the card's ratio.
GRAD_FD_TOL, GRAD_X_TOL = 1e-6, 1e-12
GRAD_ORACLE_N, GRAD_ORACLE_TOL = 10_000, 1e-4
GRAD_KRR_TOL, GRAD_KRR_FD_TOL, GRAD_KRR_H = 1e-10, 1e-5, 1e-3
GRAD_FIT_STEPS = 4  # 8 until the three wide serving phases came
BENCH_GRAD_RATIO = 3.5
# The JAX package's values at the same settings, taken on the CPU (x64):
# max|fast - exact| / max|exact| of the SSL operator's degrees and of the
# KRR test predictions.  The smoke's limit is 10x each.
JAX_SSL_DEGREE_REL = 6.449000181882818e-05
JAX_KRR_PREDICT_REL = {"gaussian": 1.899438831679044e-07,
                       "inverse_multiquadric": 6.9855183886505294e-06}
# ... and of the fused matvec against the direct sum at n = 10^5 (spiral,
# x ~ N(0, 1) from np.random.default_rng(0))
JAX_DIRECT_REL = {"SETUP_2": 1.7666062474585884e-07,
                  "SETUP_3": 1.7613001593982948e-13}
# kernel_matvec on each path that launches it, at that path's own inputs
# (float64, C = 1): (path, points, n_out, n_in, d, profile, param,
# zero_diagonal).  "spiral": spiral nodes as both point sets; "krr": the
# KRR path's crescent-fullmoon test x training points; "ssl": the SSL
# path's crescent-fullmoon nodes.  One JSON record each.
KM_PATHS = (("guard", "spiral", N_GUARD, N_GUARD, 3, "gaussian", SIGMA, True),
            ("ssl", "ssl", N_SSL, N_SSL, 2, "gaussian", SSL_SIGMA, True),
            ("direct", "spiral", N_MAIN, N_MAIN, 3, "gaussian", SIGMA, True),
            ("krr_gaussian", "krr", N_KRR_TEST, N_KRR, 2, "gaussian", 2.0,
             False),
            ("krr_inverse_multiquadric", "krr", N_KRR_TEST, N_KRR, 2,
             "inverse_multiquadric", 2.0, False),
            ("grad_oracle", "spiral", GRAD_ORACLE_N, GRAD_ORACLE_N, 3,
             "gaussian", SIGMA, True))

# flash attention vs plain, (atol, rtol): elementwise |k - p| <= atol +
# rtol |p|.  float32: the JAX kernel tests' 2e-5 absolute
# (tests/test_kernels_pallas.py).  bfloat16 and float16: both sides sum in
# float32 and round once, so they differ by about one ulp of the dtype
# (2^-7 |p| in bf16, 2^-10 |p| in f16); the limit allows two.  The
# tensor-core kernel splits P into hi + lo in the input dtype to stay
# there: one rounding of P misses it by up to ~30x near zero
# (tests/test_torch_flash.py).  (The JAX tests' bf16 limit, 5e-2 absolute,
# is about the size of an output row that sees ~1000 random keys.)
FLASH_TOL = {"float32": (2e-5, 0.0), "bfloat16": (2e-5, 2.0 ** -6),
             "float16": (2e-5, 2.0 ** -9)}
# the JAX sweep (b, hq, hkv, sq, sk, dh), causal and not, float32 and bf16
FLASH_SWEEP = ((2, 4, 2, 128, 128, 64), (1, 8, 1, 100, 100, 64),
               (1, 2, 2, 64, 192, 32), (1, 16, 8, 96, 96, 128))
# prompt lengths of the serve path (1000 is a ragged 64-row tile), the
# decode cache length, and the config's own prefill length (PREFILL_32K,
# its batch of 32 cut to 1)
FLASH_LENGTHS = (512, 1000, 2048)
FLASH_DECODE_SK = 4096
FLASH_LAYER_S = 32768
# the served model and the engine (the record's flash timing is at 2048)
SERVE_ARCH = "granite-3-2b"
SERVE_SEED = 0
SERVE_SLOTS, SERVE_MAX_SEQ, SERVE_REQUESTS, SERVE_NEW = 4, 4096, 8, 32
# float32 engine-vs-manual check: stop a request's comparison at the first
# step whose top-2 margin is under this share of the top logit (a near tie)
SERVE_MARGIN = 1e-3
# prefill, flash vs einsum attention, relative to the largest |logit|.
# bf16: the einsum path rounds logits and probabilities to bf16, the kernel
# keeps them in float32, over 40 layers.  float32 (TF32 off): only the
# order of the sums differs.
SERVE_FLASH_VS_EINSUM = {"bfloat16": 5e-2, "float32": 1e-4}
TICKS_TIMED = 16  # 32 until the three wide serving phases came
# [nfft_serve]: granite-3-2b-nfft (the paper's NFFT kernel attention in
# every layer, (S, z) as the whole cache) at full width and depth through
# the same engine; prompts are whole 128-token chunks in 512..2048 (one of
# exactly 2048), since the chunked forward pads nothing
NFFT_ARCH = "granite-3-2b-nfft"
NFFT_CHUNK = 128
NFFT_LONG = 32768  # PREFILL_32K's length, one slot
NFFT_LONG_DECODE = 8
NFFT_EXACT_S = 2048
# one mixer layer against the exact row-normalized Gaussian attention in
# float64: tests/jax_nfft_attention_reference.py prints the JAX package's
# error at the reduced width (largest of three seeds, s = 2048); the card
# is held to NFFT_EXACT_FACTOR times it
JAX_NFFT_EXACT_REL = 1.730278e-07
NFFT_EXACT_FACTOR = 10
# [moe_serve], [ssm_serve], [mla_serve], [hybrid_serve]: the same engine
# (SERVE_SLOTS, SERVE_MAX_SEQ, SERVE_REQUESTS x SERVE_NEW) over prompts of
# FAMILY_MIN_PROMPT..FAMILY_MAX_PROMPT tokens (whole chunks for a Mamba
# layer, and one
# shorter than a chunk): olmoe-1b-7b at full width and depth (bf16; float32
# engine vs manual); mamba2-1.3b at full width and depth (bf16; float32
# with SSM_F32_LAYERS layers: a prefill and teacher-forced recurrent decode
# steps vs one chunked forward, within SSM_F32_TOL of max |logit|);
# deepseek-v3-671b at full width, depth cut 61 -> MLA_LAYERS (3 dense + 1
# MoE) and mtp_depth 1 -> 0 (bf16; float32 with 1 layer: absorbed decode
# steps vs the expanded forward within MLA_F32_TOL); jamba-1.5-large at its
# reduced config (one full-width MoE layer's experts are 19.3 GB in bf16,
# four a period), card vs the same weights on the CPU within HYBRID_TOL.
# The float32 limits: both sides float32 with TF32 off, the sums in another
# order (chunked scan vs recurrence; absorbed vs expanded products; card vs
# CPU), ~1e-6 measured on the CPU's reduced configs, 100x room.
FAMILY_MIN_PROMPT, FAMILY_MAX_PROMPT = 512, 2048
MOE_ARCH = "olmoe-1b-7b"
SSM_ARCH = "mamba2-1.3b"
SSM_F32_LAYERS, SSM_F32_PREFILL, SSM_F32_DECODE = 4, 256, 128
SSM_F32_TOL = 1e-4
MLA_ARCH = "deepseek-v3-671b"
MLA_LAYERS = 4
MLA_F32_PREFILL, MLA_F32_DECODE = 512, 64
MLA_F32_TOL = 1e-4
HYBRID_ARCH = "jamba-1.5-large-398b"
HYBRID_PROMPT_CAP = 256
HYBRID_TOL = 1e-4
# [llama_serve], [qwen_serve], [jamba_serve]: the three architectures that
# no other phase runs at full width, through the same engine, every width
# kept and only the depth cut, as far as one card forces: phase ->
# (arch, bf16 depth, float32 depth).  llama3-405b (GQA 16:1, rope_theta
# 5e5, an untied 128,256-row head) keeps 4 of its 126 layers in bf16 (33.9
# GB of weights) and 2 in float32 (42.3 GB); qwen1.5-32b (40 MHA heads, QKV
# biases) 32 of 64 in bf16 (36.8 GB, and a 10.7-GB KV cache at 4 x 4,096)
# and 8 in float32 (23.0 GB); jamba-1.5-large 2 of 72 in both (layer 0
# Mamba + MoE, layer 1 Mamba + dense: 24.3 / 48.6 GB; its attention layer
# is the 8th of a period, and one period is 90 GB in bf16).  Each phase
# checks the plan of `serve_memory_plan` against the card's peaks.
WIDE_SERVE = {"llama_serve": ("llama3-405b", 4, 2),
              "qwen_serve": ("qwen1.5-32b", 32, 8),
              "jamba_serve": (HYBRID_ARCH, 2, 2)}
# qwen's QKV biases are zeros at init; both dtypes draw them
# WIDE_BIAS_SCALE N(0, 1) from a generator seeded WIDE_BIAS_SEED on the
# card, as tests/test_torch_lm.py does on the CPU, so the add is not of
# zeros
WIDE_BIAS_SCALE, WIDE_BIAS_SEED = 0.1, 7
# jamba's float32 decode vs the chunked forward: WIDE_F32_PREFILL tokens
# (two 128-token chunks) and WIDE_F32_DECODE teacher-forced steps, within
# SSM_F32_TOL, at capacity factor e / k (no choice dropped: the token
# groups of a prefill, a decode step and the whole forward differ)
WIDE_F32_PREFILL, WIDE_F32_DECODE = 256, 128
# the card's memory that a phase's plan must stay under (of its 80 GB)
WIDE_PLAN_LIMIT_GB = 70.0
# [frontends]: hubert-xlarge (48 layers, head dim 80, non-causal) over one
# sequence of HUBERT_FRAMES frame embeddings; paligemma-3b (head dim 256,
# MQA) over its 256 image embeddings + VLM_TEXT tokens, then VLM_DECODE
# steps; gemma-7b with the depth cut 28 -> GEMMA_LAYERS over GEMMA_TOKENS
# tokens (head dim 256).  Flash vs einsum limits: SERVE_FLASH_VS_EINSUM
HUBERT_ARCH, HUBERT_FRAMES = "hubert-xlarge", 4096
VLM_ARCH, VLM_TEXT, VLM_DECODE = "paligemma-3b", 32, 8
GEMMA_ARCH, GEMMA_LAYERS, GEMMA_TOKENS = "gemma-7b", 2, 2048
# the flash kernel on each new path that launches it: (path, label, (b,
# hq, hkv, sq, sk, dh), causal, dtype), checked against its plain version
# in [flash] (float32 and bf16; f16 too at dh 80 and 256) and timed in
# [times] at the path's shape
FAMILY_FLASH = (
    ("moe_serve", "olmoe", (1, 16, 16, 2048, 2048, 128), True, "bfloat16"),
    ("hybrid_serve", "jamba", (1, 4, 1, 256, 256, 16), True, "float32"),
    ("frontends_hubert", "hubert", (1, 16, 16, 4096, 4096, 80), False,
     "bfloat16"),
    ("frontends_gemma", "gemma", (1, 16, 16, 2048, 2048, 256), True,
     "bfloat16"),
    ("llama_serve", "llama", (1, 128, 8, 2048, 2048, 128), True, "bfloat16"),
    ("qwen_serve", "qwen", (1, 40, 40, 2048, 2048, 128), True, "bfloat16"))
# ... and the float32 engines among them: (path, label of a FAMILY_FLASH
# row), timed in [times] at that row's shape in float32 too
FAMILY_FLASH_F32 = (("llama_serve_f32", "llama"), ("qwen_serve_f32", "qwen"))
# the x-gradient of kernel_matvec on the card (a second launch, point sets
# swapped) against autograd through the plain version
KM_GRAD_SHAPE = (3000, 7000, 2)
# [train]: granite-3-2b at full width and depth through the port's train
# step (AdamW, TrainConfig.for_arch) at TRAIN_4K's 4,096-token sequences,
# the global batch cut from 256 to 2 sequences (2 microbatches of 1), at
# launch/train.py's defaults (peak lr 3e-4, warmup max(steps // 20, 5)).
# Kill-and-resume, the compressed step and the NFFT learn_sigma step run
# at full width with 2 layers (a 40-layer train state is ~35 GB on disk).
TRAIN_ARCH = "granite-3-2b"
TRAIN_SEED = 0
TRAIN_STEPS = 8
TRAIN_BATCH, TRAIN_MICRO = 2, 2
TRAIN_LR = 3e-4
TRAIN_SHORT_LAYERS = 2
TRAIN_RESUME_STEPS, TRAIN_RESUME_EVERY, TRAIN_FAULT_STEP = 6, 2, 4
# [train_families]: [train]'s single-card step (bf16, TRAIN_BATCH x 4,096
# tokens in TRAIN_MICRO microbatches, launch/train.py's schedule through
# run_resilient and the Prefetcher) on the families that no other phase
# trains on the card, FAMILY_TRAIN_STEPS steps each, at full width:
# (arch, depth; None keeps the full depth).  olmoe-1b-7b's 16 layers are
# cut to 4 (~1.89e9 parameters x 18 B of bf16 weight, f32 master, moments
# and gradient: ~34 GB before activations), deepseek-v3-671b's 61 to its 3
# dense MLA layers (its MTP depth of 1 stays, a dense block too: ~4.29e9
# parameters, one MoE layer's experts alone would be 11.3e9); mamba2-1.3b
# keeps its 48.  The optimizer is TrainConfig.for_arch's of the uncut
# config: AdamW, and Adafactor for deepseek-v3-671b (671e9 >= 100e9).
FAMILY_TRAIN = (("olmoe-1b-7b", 4), ("mamba2-1.3b", None),
                ("deepseek-v3-671b", 3))
FAMILY_TRAIN_STEPS = 4
# [shard_train]: the sharded train step (ZeRO-3 over torch.distributed)
# on granite-3-2b at full width: SHARD_WORLD gloo ranks time-sharing the
# card, float32, AdamW, depth cut 40 -> SHARD_LAYERS (gloo stages every
# collective through the host, and the ranks share 80 GB), global batch
# cut 256 -> SHARD_BATCH sequences of 4,096 tokens, SHARD_STEPS steps on
# each mesh against the single-device step (loss within SHARD_TOL, the
# reference's elastic-restore bound); a checkpoint after SHARD_SAVE_AT
# steps at (4, 1) restored onto (2, 2) and onto one device; then one NCCL
# rank at (1, 1) at full width and depth, bf16, [train]'s 2 x 4,096
# tokens, SHARD_FULL_STEPS steps.  Each mesh runs SHARD_MICRO microbatches,
# and so does the single-device step it is held against.  On meshes whose
# "model" axis has more than one rank, each rank computes its block of the
# heads, hidden units, experts and vocabulary; olmoe-1b-7b (full width,
# depth 16 -> SHARD_MOE_LAYERS, float32) runs at SHARD_MOE_MESH against the
# single-device step with one token group (the mesh's FSDP extent).
SHARD_WORLD = 4
SHARD_LAYERS = 2
SHARD_BATCH = 4
SHARD_STEPS = 2
SHARD_MESHES = ((4, 1), (2, 2), (1, 4))
# microbatches a step on each mesh: at (4, 1) and (2, 2) one 4,096-token
# row a rank and microbatch (two rows on each of four ranks sharing 80 GB
# run out of it); at (1, 4) every rank holds the 4 rows and a quarter of
# the heads, as many attention logits as (4, 1)'s one row of all of them
SHARD_MICRO = {(4, 1): 1, (2, 2): 2, (1, 4): 1}
SHARD_MOE_ARCH = "olmoe-1b-7b"
SHARD_MOE_LAYERS = 2
SHARD_MOE_MESH = (1, 4)
SHARD_SAVE_AT = 2
SHARD_TOL = 1e-4
SHARD_FULL_STEPS = 3
# (4, 1)'s operand bytes a step a rank at SHARD_LAYERS = 2, from the
# storage rules alone (shard_prediction((4, 1), 1); at 4 layers the same
# count equalled the storage-only step's reading): no collective may run
# over "model" there
SHARD_TRAFFIC_4x1 = {"all_gather": 243269632, "reduce_scatter": 486539264,
                     "all_reduce": 402718760, "wire": 1698791484}
# peak GB a rank predicted before the first run at SHARD_LAYERS = 2: the
# 4-layer readings less two layers' blocks of state (~0.5 GB a rank; the
# one layer's attention activations that set the peak stay)
SHARD_PEAK_PRED = {(4, 1): 12.4, (2, 2): 8.0, (1, 4): 12.9,
                   SHARD_MOE_ARCH: 15.0}
# [shard_serve]: the sharded prefill and decode steps (launch.steps.
# ShardedServeStep) on SHARD_WORLD gloo ranks sharing cuda:0, float32, full
# width: (arch, layers, mesh); granite-3-2b's depth cut 40 -> 2, olmoe's 16
# -> 2 (one token group, as [shard_train]'s).  A prefill of SERVE_SHARD_ROWS
# x SERVE_SHARD_PROMPT tokens (PREFILL_32K's 32 x 32,768 cut) and
# SERVE_SHARD_DECODES teacher-forced decode steps, every rank's whole
# logits within SERVE_SHARD_TOL of the largest single-device logit (the
# port's single-device steps on the card), bitwise equal on the ranks.
SERVE_SHARD_CASES = ((TRAIN_ARCH, SHARD_LAYERS, (2, 2)),
                     (TRAIN_ARCH, SHARD_LAYERS, (1, 4)),
                     (SHARD_MOE_ARCH, SHARD_MOE_LAYERS, (1, 4)))
SERVE_SHARD_ROWS = 4
SERVE_SHARD_PROMPT = 2048
SERVE_SHARD_DECODES = 8
SERVE_SHARD_TOL = 1e-4
# [dryrun]: the dry run's peak live bytes a rank within DRY_PEAK_TOL of
# [shard_train]'s measured peak; no roofline term over DRY_SHARE_MAX of the
# measured time it bounds; the production graph cells' rank counts (8 and
# 32 on described (2, 4) and (8, 4) meshes, 256 and 512 the production
# meshes), n = DRY_GRAPH_N, SETUP_2, d = 3, S = 1 and DRY_GRAPH_BANK
DRY_PEAK_TOL = 0.25
DRY_SHARE_MAX = 1.05
DRY_GRAPH_MESHES = ((2, 4), (8, 4), (16, 16), (2, 16, 16))
DRY_GRAPH_N = 2 ** 27
DRY_GRAPH_BANK = 8
DRY_LM_SHAPES = ("train_4k", "prefill_32k", "decode_32k")
# production train_4k cells on the 16 x 16 mesh whose heads the 16-way
# "model" axis does not divide, traced at these ranks: each counts its ceil
# block of the heads (qwen1.5-32b's 40: 3 on ranks 0-12, 1 on rank 13, none
# on 14-15; paligemma-3b's 8: 1 on ranks 0-7, none on 8-15); the last rank
# named has none
DRY_CEIL_CELLS = (("qwen1.5-32b", (0, 13, 15)), ("paligemma-3b", (0, 8)))
# a residual's bound max|block|/254, plus the rounding of q * scale (a few
# ulps of the block's largest value, under 2^-16 of the bound)
EF_BOUND_SLACK = 2.0 ** -16
# out / (max|block| / 127) is an integer q with |q| <= 127 up to the
# rounding of q * scale and of the division (~2 ulps of 127, 1.5e-5)
EF_GRID_SLACK = 1e-3

# [bank]: the main path's spiral at n = 10^5, d = 3, SETUP_2, four Gaussian
# members; bank vs the S single operators, relative to the largest output
# entry (the same kernels, one bank spread/gather against S of them)
BANK_SIGMAS = (2.5, 3.0, 3.5, 4.0)
BANK_C = 4
BANK_TOL = 1e-13
# [sweep]: benchmarks/sweep_scaling.py's configurations (CONFIGS, _dataset
# and its seeds) at n = 50,000: d -> (N, m, sigma scale, betas), 8 sigmas
# geomspace(0.8, 1.25) x scale, eps_B = p/N; tol 1e-8, maxiter 600, and
# its bank-vs-sequential alpha limit (two CG runs agree to ~residual/beta)
SWEEP_N = 50_000
SWEEP_SIGMAS = 8
SWEEP_CONFIGS = {1: (64, 4, 1.0, (0.02, 0.08)),
                 2: (32, 4, 1.0, (10.0, 40.0)),
                 3: (32, 4, 3.0, (100.0, 400.0))}
SWEEP_TOL, SWEEP_MAXITER = 1e-8, 600
SWEEP_ALPHA_REL = 1e-5
# [multilayer]: the [ssl] crescent with two Gaussian layers
ML_SIGMAS, ML_WEIGHTS = (0.75, 1.5), (0.5, 0.5)
# [graph_serve]: benchmarks/serve_scaling.py's full mode (uniform d = 2
# training set in (-3, 3), seed 3, +-1 labels, N = 64, m = 4, REG, two
# Gaussian tenants; 64 requests x 256 query points in (-2.5, 2.5)), and a
# second group: the [sweep] phase's d = 2 cells as 16 tenants, 4 requests
# each from inside their training box
GS_N_TRAIN, GS_REQUESTS, GS_M_QUERY = 20_000, 64, 256
GS_SIGMAS, GS_REG, GS_SEED = (1.0, 1.5), 1e-2, 3
GS_N_BANDWIDTH, GS_M = 64, 4
GS_SLOTS, GS_CHUNK = 8, 256
GS_SWEEP_D, GS_SWEEP_PER_CELL = 2, 4
# just past the first group's serving domain (tests/test_chaos.py's points)
GS_OUT_OF_DOMAIN = np.array([[4.5, -4.0], [5.0, 5.0], [4.2, 0.0]])
# The JAX engine's max|served - direct| / max|direct| over each group's
# burst at these settings; the same against the exact trigonometric sum
# the served NFFT approximates (an NDFT of the frozen frame's nodes with
# the kernel's Fourier coefficients: "ndft_*"); the sequential path's
# (krr_predict, a joint replan per request) against direct; and of
# GS_OUT_OF_DOMAIN served by the replan; on the CPU (x64), from
# tests/jax_graph_serve_reference.py.  The smoke's limit is 10x each.
# The sweep cells' N = 32 grid cannot resolve their sigma (~0.02 in the
# frozen frame, a grid step of ~0.03): the JAX engine misses the direct
# sum by ~98% there, so that group's served-vs-direct limit cannot fail
# and the NDFT limit is the one that holds it.  Each served output is
# also held against the same plan's unpacked fast prediction, to the
# spread's 1e-12 relative to the same prediction over |alpha| (the size
# of the sums the rounding acts on: KRR's dual vectors cancel ~100x in
# the output)
JAX_GRAPH_SERVE_REL = {"uniform": 0.020869642148381773,
                       "sweep": 0.9773518649335858,
                       "ndft_uniform": 0.0008468992237145356,
                       "ndft_sweep": 8.953635540698428e-07,
                       "sequential_uniform": 0.001604635277893625,
                       "sequential_sweep": 1.0038908950635221,
                       "replan": 0.00024284251027812897}
GS_UNPACKED_TOL = 1e-12
# timed traffic: GS_ROUNDS fresh bursts through the engine and the first
# GS_SEQ_ROUNDS of them through the sequential path, per traffic mix
GS_ROUNDS, GS_SEQ_ROUNDS = 8, 2
GS_TRAFFIC = ("uniform", "sweep", "mixed")
# [durable]: the deterministic spread (five repeats bitwise, TOL of plain)
# at the main path's shapes, the sweep's d = 1 and 2 geometries and the
# d = 3, m = 9 pieces; resumable_eigsh on the main path's spiral (k =
# K_EIG, 80 single-vector steps, snapshots every 20, killed at 37);
# resumable_solve on [krr]'s Gaussian Gram (tol 1e-10) and on [bank]'s
# four lockstep Gaussians (shift I + W~_s / n); the journal of [graph_serve]'s
# two uniform tenants; dropped ticks
DET_REPEATS = 5
DUR_ITERS, DUR_EVERY, DUR_KILL, DUR_SEED = 80, 20, 37, 4
DUR_KRR_TOL, DUR_KRR_EVERY, DUR_KRR_KILLS = 1e-10, 100, (250, 700)
DUR_BANK_TOL, DUR_BANK_MAXITER, DUR_BANK_EVERY = 1e-10, 400, 5
DUR_BANK_SHIFT = 1e-2
DUR_BANK_KILLS = (7, 18)
# BENCH_resume.json (CPU, n = 3000): durable vs plain, in percent
BENCH_RESUME_OVERHEAD = {"cg": -19.278562135627958,
                         "eigsh": -17.37640087225767}
# repro.runtime.chaos_schedule(5, ticks=200, p_drop=0.1, p_slow=0.1), from
# a CPU run of the JAX package
JAX_CHAOS_DROPS = (4, 7, 8, 19, 23, 29, 31, 48, 50, 88, 99, 111, 112, 129,
                   130, 134, 155, 156, 160, 179, 180, 186)
JAX_CHAOS_SLOWS = (38, 64, 69, 79, 95, 97, 102, 107, 113, 131, 172, 183, 187,
                   198)

# [dist]: the distributed matvec (node dimension sharded) on DIST_WORLD
# ranks that share the one card over gloo (NCCL refuses two ranks on one
# device), then one NCCL rank.  Every distributed result against the
# single-device one on the card: matvecs DIST_TOL relative to the largest
# entry, eigsh's eigenvalues DIST_EIG_TOL.  Runs: (mode, mesh, pencil_axes).
DIST_WORLD = 4
DIST_TOL = 1e-12
DIST_EIG_TOL = 1e-10
DIST_COLUMNS = (1, 4)
DIST_RUNS = (("psum", (4,), None), ("psum", (2, 2), None),
             ("pencil", (4,), None), ("pencil", (2, 2), None),
             ("pencil", (2, 2), (("data",), ("model",))))
DIST_BIG_RUNS = (("psum", (4,), None), ("pencil", (4,), None))
DIST_BANK_C = 4
DIST_EIG_RUNS = (("psum", (4,), None), ("pencil", (2, 2), None))
DIST_EIG_SEED = 7
DIST_COMPRESS_SHAPE = (DIST_WORLD, 1_000_000)


def sweep_sigmas(d: int) -> tuple:
    return tuple(float(s) for s in SWEEP_CONFIGS[d][2]
                 * np.geomspace(0.8, 1.25, SWEEP_SIGMAS))


# the oracle of [graph_serve] (krr_predict_direct), one row per training
# size: a request of the first group (256 queries x the 20,000 uniform
# points) and of the sweep group (x the 50,000 crescent points; the
# smallest of its sigmas)
KM_PATHS += (("graph_serve_oracle_uniform", "serve", GS_M_QUERY, GS_N_TRAIN,
              2, "gaussian", GS_SIGMAS[0], False),
             ("graph_serve_oracle_sweep", "serve_sweep", GS_M_QUERY, SWEEP_N,
              2, "gaussian", sweep_sigmas(GS_SWEEP_D)[0], False))


def sweep_dataset(d: int, n: int, crescent_fullmoon, spiral):
    """benchmarks/sweep_scaling.py's _dataset: (points (n, d), f (n,))."""
    rng = np.random.default_rng(7)
    if d == 1:
        x = np.sort(rng.normal(size=(n, 1)) * 2.0, axis=0)
    elif d == 2:
        x, _ = crescent_fullmoon(n, seed=2)
    else:
        x, _ = spiral(n, seed=2)
    x = np.asarray(x)
    f = np.sin(3.0 * x[:, 0]) + 0.1 * rng.standard_normal(n)
    return x, f


def graph_serve_data(rng):
    """serve_scaling.py's training set: (points, labels) from ``rng``."""
    xtr = rng.uniform(-3, 3, (GS_N_TRAIN, 2))
    return xtr, np.sign(rng.standard_normal(GS_N_TRAIN))


def graph_serve_group(model_id: str) -> str:
    return "uniform" if model_id.startswith("tenant") else "sweep"


def graph_serve_burst(rng, sweep_points, kind="mixed"):
    """One burst: [(model id, queries)].  "uniform": serve_scaling.py's
    requests (tenants round-robin); "sweep": GS_SWEEP_PER_CELL per sweep
    cell, drawn inside the sweep's training box; "mixed": both, in that
    order."""
    burst = []
    if kind != "sweep":
        burst += [(f"tenant{i % len(GS_SIGMAS)}",
                   rng.uniform(-2.5, 2.5, (GS_M_QUERY, 2)))
                  for i in range(GS_REQUESTS)]
    if kind != "uniform":
        lo, hi = sweep_points.min(axis=0), sweep_points.max(axis=0)
        n_cells = SWEEP_SIGMAS * len(SWEEP_CONFIGS[GS_SWEEP_D][3])
        burst += [(f"cell{i % n_cells}",
                   rng.uniform(lo, hi, (GS_M_QUERY, 2)))
                  for i in range(n_cells * GS_SWEEP_PER_CELL)]
    return burst


# ---------------------------------------------------------------------------
# [dist]'s rank side: module-level functions that
# repro_torch.launch.ranks.RankPool runs on every rank (fn(ctx, *args)); a
# rank imports this file as its main module, which runs nothing at import.
# ---------------------------------------------------------------------------

DIST_AXES = {1: ("data",), 2: ("data", "model")}


def dist_mesh(ctx, shape):
    from repro_torch.launch.mesh import make_mesh
    key = ("mesh", tuple(shape))
    if key not in ctx.cache:
        ctx.cache[key] = make_mesh(shape, DIST_AXES[len(shape)])
    return ctx.cache[key]


def dist_operator(ctx, kind, n, setup_name):
    """This rank's operator on the main path's spiral, built once: "op"
    (the Gaussian, SIGMA), "bank" ([bank]'s four Gaussians) or
    "adjacency" (the normalized adjacency)."""
    key = (kind, n, setup_name)
    if key not in ctx.cache:
        import torch
        from repro_torch.core import fastsum as fs
        from repro_torch.core.kernels import make_kernel
        from repro_torch.data.synthetic import spiral
        pts = torch.as_tensor(spiral(n, seed=0)[0], device=ctx.device)
        params = getattr(fs, setup_name)
        if kind == "bank":
            ctx.cache[key] = fs.make_fastsum_bank(
                [make_kernel("gaussian", sigma=s) for s in BANK_SIGMAS], pts,
                params, device=ctx.device)
        elif kind == "adjacency":
            ctx.cache[key] = fs.make_normalized_adjacency(
                make_kernel("gaussian", sigma=SIGMA), pts, params,
                device=ctx.device)
        else:
            ctx.cache[key] = fs.make_fastsum(
                make_kernel("gaussian", sigma=SIGMA), pts, params,
                device=ctx.device)
    return ctx.cache[key]


def dist_matvec_fn(ctx, kind, n, setup_name, mode, mesh_shape, pencil_axes):
    """(distributed matvec, single-device matvec, plan), kept per run."""
    from repro_torch.dist import fastsum_dist
    key = ("mv", kind, n, setup_name, mode, mesh_shape, pencil_axes)
    if key not in ctx.cache:
        obj = dist_operator(ctx, kind, n, setup_name)
        m = dist_mesh(ctx, mesh_shape)
        make = (fastsum_dist.distributed_matvec_bank_fn if kind == "bank"
                else fastsum_dist.distributed_matvec_fn)
        fs_obj = obj.fastsum if kind == "adjacency" else obj
        ctx.cache[key] = (make(fs_obj, m, m.axis_names, spectral_mode=mode,
                               pencil_axes=pencil_axes), fs_obj.matvec,
                          fs_obj.plan)
    return ctx.cache[key]


def dist_launches():
    from repro_torch.kernels import nfft_window as win
    return {"window_spread": win.window_spread.launches,
            "window_gather": win.window_gather.launches}


def dist_reset_launches():
    from repro_torch.kernels import nfft_window as win
    win.window_spread.launches = 0
    win.window_spread_deterministic.launches = 0
    win.window_gather.launches = 0


def dist_digest(t) -> str:
    import hashlib
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()


def dist_alone_ms(ctx, fn, reps):
    """Host ms a call of ``fn`` on rank 0 alone (every other rank waits in
    a barrier), ending in a sync; None on the other ranks."""
    import torch
    import torch.distributed as dist
    dist.barrier()
    ms = None
    if ctx.rank == 0:
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / reps * 1e3
    dist.barrier()
    return ms


def dist_matvec_case(ctx, kind, n, setup_name, mode, mesh_shape,
                     pencil_axes, x_shape, reps):
    """One distributed matvec on every rank, against the single-device one
    on the card: launch counts of the distributed call alone (set to 0
    just before it), rel error, y's digest, this rank's collective traffic;
    then ms a call with every rank running (host clock, ends in a sync)
    and the single-device ms on rank 0 alone."""
    import torch
    import torch.distributed as dist
    mv, single, _ = dist_matvec_fn(ctx, kind, n, setup_name, mode,
                                   mesh_shape, pencil_axes)
    mesh = dist_mesh(ctx, mesh_shape)
    gen = torch.Generator(device=ctx.device).manual_seed(sum(x_shape))
    x = torch.randn(x_shape, generator=gen, dtype=torch.float64,
                    device=ctx.device)
    want = single(x)
    torch.cuda.synchronize()
    dist_reset_launches()
    mesh.traffic.clear()
    t0 = time.perf_counter()
    y = mv(x)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    launches = dist_launches()
    traffic = dict(mesh.traffic)
    rel = float((y - want).abs().max() / want.abs().max())
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(reps):
        mv(x)
    torch.cuda.synchronize()
    dist_ms = (time.perf_counter() - t0) / reps * 1e3
    return {"rank": ctx.rank, "rel": rel, "digest": dist_digest(y),
            "launches": launches, "traffic": traffic, "first_ms": first_ms,
            "ms": dist_ms, "single_ms": dist_alone_ms(
                ctx, lambda: single(x), reps),
            "spec": None if mv.spec is None else
            (mv.spec.row_axes, mv.spec.col_axes, mv.spec.extra_axes),
            "rows": mv.rows.rows, "pad": mv.rows.pad}


def dist_shard_kernels(ctx, kind, n, setup_name, mode, mesh_shape,
                       pencil_axes, columns):
    """The window kernels on this rank's shard geometry against their plain
    versions (each rank), at ``columns``; on rank 0 alone, their ms (CUDA
    events) and plain ms, and the ms of one fresh tile-plan build of the
    shard."""
    import torch
    from repro_torch.core.nfft import padded_grid_size
    from repro_torch.kernels import nfft_window as win
    mv, _, plan = dist_matvec_fn(ctx, kind, n, setup_name, mode, mesh_shape,
                                 pencil_axes)
    geom = mv.geometry()
    rows, d, taps = geom.weights.shape
    pad = padded_grid_size(plan)
    out = {"rank": ctx.rank, "rows": rows, "d": d, "taps": taps, "pad": pad,
           "tiles": geom.tiles.n_tiles, "c": {}}
    for c in columns:
        gen = torch.Generator(device=ctx.device).manual_seed(c)
        x = torch.randn((rows, c), generator=gen, dtype=torch.float64,
                        device=ctx.device)
        g = torch.randn((pad,) * d + (c,), generator=gen,
                        dtype=torch.float64, device=ctx.device)
        fns = {"spread": (lambda: win.window_spread(
                   x, geom.base, geom.weights, padded_size=pad,
                   tiles=geom.tiles),
                   lambda: win.window_spread_plain(
                       x, geom.base, geom.weights, padded_size=pad)),
               "gather": (lambda: win.window_gather(
                   g, geom.base, geom.weights, tiles=geom.tiles),
                   lambda: win.window_gather_plain(g, geom.base,
                                                   geom.weights))}
        row = {}
        for kname, (kfn, pfn) in fns.items():
            p_out = pfn()
            err = float((kfn() - p_out).abs().max())
            row[kname] = {"max_abs_err": err,
                          "rel": err / float(p_out.abs().max()),
                          "ms": dist_event_ms(ctx, kfn, 20),
                          "plain_ms": dist_event_ms(ctx, pfn, 2)}
        out["c"][c] = row
    out["tile_plan_ms"] = dist_alone_ms(
        ctx, lambda: win.build_tile_plan(geom.base, taps), 3)
    return out


def dist_event_ms(ctx, fn, reps):
    """CUDA-event ms a call of ``fn`` on rank 0 alone; None elsewhere."""
    import torch
    import torch.distributed as dist
    dist.barrier()
    ms = None
    if ctx.rank == 0:
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / reps
    dist.barrier()
    return ms


def dist_eigsh_case(ctx, n, setup_name, mode, mesh_shape, pencil_axes):
    """eigsh (k = K_EIG, DUR_ITERS steps) of the normalized adjacency
    through the distributed matvec on every rank, from a start vector
    seeded alike on every rank, against the single-device eigsh on the
    card with the same seed.  The degrees come from the distributed matvec
    too: a rank's own single-device degrees (an atomic spread) may differ
    from another rank's in the last bits, and the ranks' iterations with
    them."""
    import torch
    from repro_torch.core.lanczos import eigsh
    adj = dist_operator(ctx, "adjacency", n, setup_name)
    mv_w, _, _ = dist_matvec_fn(ctx, "adjacency", n, setup_name, mode,
                                mesh_shape, pencil_axes)

    def kw():
        return dict(num_iters=DUR_ITERS, device=ctx.device,
                    generator=torch.Generator(device=ctx.device).manual_seed(
                        DIST_EIG_SEED))

    single = eigsh(adj.matvec, adj.n, K_EIG, **kw())
    torch.cuda.synchronize()
    dist_reset_launches()
    t0 = time.perf_counter()
    deg = mv_w(torch.ones(adj.n, dtype=torch.float64, device=ctx.device))
    inv = 1.0 / torch.sqrt(torch.clamp(deg, min=torch.finfo(deg.dtype).tiny))
    res = eigsh(lambda v: inv * mv_w(inv * v), adj.n, K_EIG, **kw())
    torch.cuda.synchronize()
    took = time.perf_counter() - t0
    return {"rank": ctx.rank, "launches": dist_launches(), "s": took,
            "gap": float((res.eigenvalues - single.eigenvalues).abs().max()),
            "digest": dist_digest(res.eigenvalues),
            "top": res.eigenvalues[:3].tolist(),
            "single_s": dist_alone_ms(ctx, lambda: eigsh(
                adj.matvec, adj.n, K_EIG, **kw()), 1)}


def dist_compress_case(ctx):
    """compress_psum over every rank: rank r holds row r of seeded float32
    gradients DIST_COMPRESS_SHAPE; the mean against the exact mean, the
    residual against compress_decompress bit for bit."""
    import torch
    from repro_torch.dist import compression
    mesh = dist_mesh(ctx, (ctx.world,))
    gen = torch.Generator(device=ctx.device).manual_seed(5)
    g_all = torch.randn(DIST_COMPRESS_SHAPE, generator=gen,
                        dtype=torch.float32, device=ctx.device)
    g, zero = g_all[ctx.rank], torch.zeros_like(g_all[ctx.rank])
    mesh.traffic.clear()
    mean, resid = compression.compress_psum(g, "data", zero, mesh)
    _, want = compression.compress_decompress(g, zero)
    return {"rank": ctx.rank,
            "err": float((mean - g_all.mean(dim=0)).abs().max()),
            "bound": float(g_all.abs().max()) / 127.0 * 1.01,
            "resid_equal": bool(torch.equal(resid, want)),
            "digest": dist_digest(mean), "traffic": dict(mesh.traffic)}


# ---------------------------------------------------------------------------
# [shard_train]'s rank side (run by repro_torch.launch.ranks.RankPool, as
# [dist]'s): each rank builds its blocks of the same seeded state.
# ---------------------------------------------------------------------------

def shard_config(layers: int, dtype: str, arch: str = TRAIN_ARCH):
    """SHARD's architecture (granite-3-2b, or SHARD_MOE_ARCH with one token
    group) at full width, ``layers`` deep, parameters and activations in
    ``dtype``."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(arch), num_layers=layers,
                              param_dtype=dtype, activation_dtype=dtype)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, token_groups=1))
    return cfg


def shard_case_config(arch: str = TRAIN_ARCH):
    """[shard_train]'s float32 config of ``arch``."""
    layers = SHARD_MOE_LAYERS if arch == SHARD_MOE_ARCH else SHARD_LAYERS
    return shard_config(layers, "float32", arch)


def shard_train_config(micro: int):
    """launch/train.py's optimizer settings, as [train]'s (AdamW for
    granite-3-2b, peak lr TRAIN_LR, warmup max(steps // 20, 5)), over
    SHARD_STEPS + 1 steps."""
    from repro_torch.training.optimizer import OptimizerConfig
    from repro_torch.training.train_loop import TrainConfig
    steps = SHARD_STEPS + 1
    return TrainConfig(optimizer=OptimizerConfig(
        name="adamw", peak_lr=TRAIN_LR, total_steps=steps,
        warmup_steps=max(steps // 20, 5)), num_microbatches=micro)


def shard_seq(cfg) -> int:
    """The tokens a row of [shard_train]'s batches: train_4k's 4,096."""
    return next(s for s in cfg.shapes if s.name == "train_4k").seq_len


def shard_batch(cfg, rows: int, step: int, device):
    """The pipeline's batch ``step`` of ``rows`` 4,096-token sequences."""
    import torch
    from repro_torch.data import pipeline
    shape = dataclasses.replace(
        next(s for s in cfg.shapes if s.name == "train_4k"),
        global_batch=rows)
    return {k: torch.as_tensor(v).to(device) for k, v in
            pipeline.batch_for_step(cfg, shape, step, seed=TRAIN_SEED).items()}


def shard_launches(reset: bool = False) -> dict:
    """Every kernel wrapper's launch count in this process (set to 0 with
    ``reset``)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import kernel_matvec as km
    from repro_torch.kernels import nfft_window as win
    fns = {"window_spread": win.window_spread,
           "window_spread_deterministic": win.window_spread_deterministic,
           "window_gather": win.window_gather,
           "kernel_matvec": km.kernel_matvec,
           "flash_attention": fa.flash_attention}
    if reset:
        for fn in fns.values():
            fn.launches = 0
    return {k: fn.launches for k, fn in fns.items()}


def shard_state_bytes(state, step) -> dict:
    """This rank's bytes of train state, the rules' blocks of it
    (``_state_shardings`` over the meta state), the unsharded total."""
    import torch
    from repro_torch.training import train_loop as tl
    from repro_torch.tree import tree_leaves
    held = sum(t.numel() * t.element_size() for t in tree_leaves(state)
               if isinstance(t, torch.Tensor))
    pairs = list(zip(tree_leaves(tl.abstract_train_state(step.cfg, step.tc)),
                     tree_leaves(step.state_shardings)))
    return {"held": held,
            "rules": sum(s.block_numel() * t.element_size()
                         for t, s in pairs),
            "full": sum(t.numel() * t.element_size() for t, _ in pairs)}


def shard_unsplit_digests(state, step) -> dict:
    """sha256 of each leaf that no mesh axis splits (the replicated ones)."""
    import torch
    from repro_torch.tree import tree_flatten_with_path, tree_leaves
    return {path: dist_digest(t.detach()) for (path, t), s in zip(
        tree_flatten_with_path(state), tree_leaves(step.state_shardings))
        if isinstance(t, torch.Tensor) and not s.is_split}


def shard_release(ctx) -> None:
    import gc
    import torch
    gc.collect()
    torch.cuda.synchronize(ctx.device)
    torch.cuda.empty_cache()


def shard_train_case(ctx, mesh_shape, save_dir=None, arch=TRAIN_ARCH):
    """SHARD_STEPS (+ 1 with ``save_dir``) sharded steps of ``arch``
    (shard_case_config), float32, SHARD_BATCH x 4,096 tokens in SHARD_MICRO
    microbatches, on ``mesh_shape``,
    through run_resilient (no checkpoint directory: each rank keeps a host
    copy of its blocks); with ``save_dir``, a sharded checkpoint after
    SHARD_SAVE_AT steps and one more step.  Launch counts set to 0 just
    before the steps and read just after; metrics, host seconds a step
    (every rank starting together, ending in a sync), each step's
    collective traffic (by kind, and by kind and axes), bytes of state,
    digests of the unsplit leaves, peak GB of the steps (the ranks build
    their state one at a time, before the peak's reset); then the matmul
    FLOPs of one microbatch's forward (FlopCounterMode, no gradient)."""
    import torch
    import torch.distributed as dist
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training import fault_tolerance as ft
    from repro_torch.training import train_loop as tl
    mesh = dist_mesh(ctx, mesh_shape)
    cfg = shard_case_config(arch)
    tc = shard_train_config(SHARD_MICRO[mesh_shape])
    t0 = time.perf_counter()
    # one rank at a time: a rank builds the whole seeded state on the card
    # before it keeps its blocks (olmoe's 2 layers: ~19 GB)
    for r in range(ctx.world):
        if r == ctx.rank:
            state = tl.init_train_state(cfg, tc, TRAIN_SEED,
                                        device=ctx.device, mesh=mesh)
            shard_release(ctx)
        dist.barrier()
    step = tl.make_train_step(cfg, tc, mesh=mesh)
    torch.cuda.synchronize(ctx.device)
    init_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(ctx.device)
    steps = SHARD_STEPS + (1 if save_dir else 0)
    batches = [shard_batch(cfg, SHARD_BATCH, s, ctx.device)
               for s in range(steps)]
    metrics, traffic, by_axes, times, save_s = [], [], [], [], None

    def timed(st, batch):
        mesh.traffic.clear()
        mesh.traffic_axes.clear()
        dist.barrier()
        torch.cuda.synchronize(ctx.device)
        t = time.perf_counter()
        st, m = step(st, batch)
        torch.cuda.synchronize(ctx.device)
        times.append(time.perf_counter() - t)
        traffic.append(dict(mesh.traffic))
        by_axes.append({f"{k}@{'+'.join(a)}": v
                        for (k, a), v in mesh.traffic_axes.items()})
        metrics.append({k: float(v) for k, v in m.items()})
        return st, m

    shard_launches(reset=True)
    if save_dir is None:
        state, info = ft.run_resilient(
            timed, state, lambda s: batches[s], total_steps=steps,
            ckpt_dir=None, state_shardings=step.state_shardings,
            log_every=10 ** 9)
        copy = info["initial_copy"]
    else:
        copy = None
        for s in range(steps):
            state, _ = timed(state, batches[s])
            if s + 1 == SHARD_SAVE_AT:
                t = time.perf_counter()
                ckpt.save_checkpoint(save_dir, s + 1, state,
                                     shardings=step.state_shardings)
                dist.barrier()
                save_s = time.perf_counter() - t
    launches = shard_launches()
    peak = torch.cuda.max_memory_allocated(ctx.device) / 1e9
    micro = tl._split_microbatches(batches[0], tc.num_microbatches)[0]
    with torch.no_grad(), FlopCounterMode(display=False) as flops:
        step.forward(state.params, micro)
    out = {"rank": ctx.rank, "metrics": metrics, "step_s": times,
           "traffic": traffic, "traffic_axes": by_axes, "init_s": init_s,
           "save_s": save_s, "host_copy": copy, "launches": launches,
           "bytes": shard_state_bytes(state, step),
           "digests": shard_unsplit_digests(state, step),
           "peak_gb": peak, "flops": flops.get_total_flops(),
           "model_index": mesh.coords()["model"]}
    del state, step, batches, micro
    shard_release(ctx)
    return out


def shard_resume_case(ctx, mesh_shape, save_dir):
    """SHARD_SAVE_AT's checkpoint restored onto ``mesh_shape`` (each rank
    reads its blocks of every leaf), then the next step (in SHARD_MICRO
    microbatches: the loss, taken before the update, is the batch's mean
    either way): its metrics."""
    import torch
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training import train_loop as tl
    mesh = dist_mesh(ctx, mesh_shape)
    cfg = shard_case_config()
    tc = shard_train_config(SHARD_MICRO[mesh_shape])
    step = tl.make_train_step(cfg, tc, mesh=mesh)
    like = tl.init_train_state(cfg, tc, TRAIN_SEED + 1, device=ctx.device,
                               mesh=mesh)
    t0 = time.perf_counter()
    state = ckpt.restore_checkpoint(save_dir, SHARD_SAVE_AT, like,
                                    shardings=step.state_shardings)
    torch.cuda.synchronize(ctx.device)
    restore_s = time.perf_counter() - t0
    at = int(state.step)
    state, m = step(state, shard_batch(cfg, SHARD_BATCH, at, ctx.device))
    out = {"rank": ctx.rank, "step": at, "restore_s": restore_s,
           "metrics": {k: float(v) for k, v in m.items()}}
    del state, like, step
    shard_release(ctx)
    return out


def shard_full_case(ctx):
    """One rank at (1, 1): granite-3-2b at full width and depth, bf16,
    [train]'s TRAIN_BATCH x 4,096 tokens in TRAIN_MICRO microbatches,
    SHARD_FULL_STEPS sharded steps (every gather and reduction trivial:
    the sharded path's own cost); launches from 0 just before the steps."""
    import torch
    from repro_torch.training import train_loop as tl
    from repro_torch.configs import get_config
    mesh = dist_mesh(ctx, (1, 1))
    cfg = get_config(TRAIN_ARCH)  # uncut: 40 layers, bf16
    tc = shard_train_config(TRAIN_MICRO)
    torch.cuda.reset_peak_memory_stats(ctx.device)
    t0 = time.perf_counter()
    state = tl.init_train_state(cfg, tc, TRAIN_SEED, device=ctx.device,
                                mesh=mesh)
    step = tl.make_train_step(cfg, tc, mesh=mesh)
    torch.cuda.synchronize(ctx.device)
    init_s = time.perf_counter() - t0
    state_gb = torch.cuda.memory_allocated(ctx.device) / 1e9
    batches = [shard_batch(cfg, TRAIN_BATCH, s, ctx.device)
               for s in range(SHARD_FULL_STEPS)]
    shard_launches(reset=True)
    times, metrics = [], []
    for b in batches:
        torch.cuda.synchronize(ctx.device)
        t = time.perf_counter()
        state, m = step(state, b)
        torch.cuda.synchronize(ctx.device)
        times.append(time.perf_counter() - t)
        metrics.append({k: float(v) for k, v in m.items()})
    out = {"layers": cfg.num_layers, "init_s": init_s, "state_gb": state_gb,
           "step_s": times, "metrics": metrics, "launches": shard_launches(),
           "traffic": dict(mesh.traffic),
           "peak_gb": torch.cuda.max_memory_allocated(ctx.device) / 1e9}
    del state, step, batches
    shard_release(ctx)
    return out


def shard_prediction(mesh_shape, micro: int, arch: str = TRAIN_ARCH) -> dict:
    """What one sharded step of ``arch`` (shard_case_config) should hand the
    collectives on ``mesh_shape`` (bytes of operands by kind, this rank's;
    "wire" the ring model's bytes sent), and each rank's bytes of state,
    counted from the storage rules and the compute layout
    (``compute_uses``) on the meta state, and from the activations' shapes:

    * weights, each gathered once in the forward and again in its block's
      remat recompute: over the FSDP axes, and over "model" unless the rank
      keeps its stored block; a row-parallel weight's or an expert
      matrix's all_to_all each way; a ceil block's all_gather backward;
      the gradient sliced ("full"), reduce-scattered ("sum") or kept over
      "model", reduce-scattered over the FSDP axes that split it and
      all-reduced over the others;
    * with a "model" axis of M > 1 ranks, each block's activations of T
      tokens: an attention, MLP or MoE output's all-reduce of (T, d)
      forward and in the recompute (the block's last output forward only:
      the recompute stops before it), its input's all-reduce backward (the
      MoE's gates (T, k) too), Mamba's squares (T,) both ways; the logits'
      input (T, d) backward, the cross entropy's max, sum of exponentials
      and target logit (T,) forward, the tied embedding's vocabulary block
      all_gathered backward;
    * the loss's sum and count psummed forward (and the sum backward) when
      the batch rows are split, and the MoE's load-balancing sums; one
      psum of squared norms per group of axes."""
    import collections
    from repro_torch.dist.sharding import (
        FSDP_AXES, MODEL_AXIS, P, compute_uses, named)
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.steps import _state_shardings
    from repro_torch.models.model import layer_signature
    from repro_torch.training import train_loop as tl
    from repro_torch.tree import tree_leaves
    mesh = Mesh(dict(zip(("data", "model"), mesh_shape)))
    m = mesh.shape[MODEL_AXIS]
    cfg = shard_case_config(arch)
    tc = shard_train_config(micro)
    abstract = tl.abstract_train_state(cfg, tc)
    sh = _state_shardings(abstract, mesh)
    params = dict(abstract.params.named_parameters())
    uses = compute_uses(abstract.params, sh.params, cfg)
    out = collections.Counter()
    ring = {"all_reduce": lambda g: 2 * (g - 1) / g,
            "all_reduce_max": lambda g: 2 * (g - 1) / g,
            "reduce_scatter": lambda g: (g - 1) / g,
            "all_to_all": lambda g: (g - 1) / g,
            "all_gather": lambda g: g - 1}

    def add(kind, nbytes, g):
        out[kind] += int(nbytes)
        out["wire"] += int(round(ring[kind](g) * nbytes))

    for name, s in sh.params.items():
        u = uses[name]
        p = params[name]
        elt = p.element_size()
        gathers = micro * (2 if tc.remat and tl._in_block(name) else 1)
        split = s.dim_axes()
        numel = s.block_numel()
        for _, axes in split:
            g = mesh.group_size(axes)
            if u.gather == "keep" and MODEL_AXIS in axes:
                continue
            add("all_gather", gathers * numel * elt, g)
            numel *= g
        if u.post and u.post[0] == "swap":
            add("all_to_all", (gathers + micro) * numel * elt, m)
        if u.post and u.post[0] == "block":
            n, unit = p.shape[u.post[1]], u.post[2]
            add("all_gather", micro * -(-(n // unit) // m) * unit
                * (numel // n) * elt, m)
        grad = numel
        used = set()
        for _, axes in split:
            used.update(axes)
            if MODEL_AXIS in axes and u.gather != "keep":
                if u.gather == "sum":
                    add("reduce_scatter", micro * grad * elt, m)
                grad //= m
        for _, axes in split:
            if MODEL_AXIS not in axes:
                g = mesh.group_size(axes)
                add("reduce_scatter", micro * grad * elt, g)
                grad //= g
        summed = set(FSDP_AXES) | ({MODEL_AXIS} if u.gather == "sum"
                                   else set())
        rest = [a for a in mesh.axis_names if a in summed
                and mesh.shape[a] > 1 and a not in used]
        if rest:
            add("all_reduce", micro * grad * elt, mesh.group_size(rest))
    rows = named(mesh, P(FSDP_AXES), (SHARD_BATCH // micro,))
    local = SHARD_BATCH // micro // (mesh.group_size(rows.axes)
                                     if rows.is_split else 1)
    t = local * shard_seq(cfg)
    act = cfg.dtype.itemsize
    d = cfg.d_model
    passes = 2 if tc.remat else 1  # a block's forward and its recompute
    sigs = [layer_signature(cfg, i) for i in range(cfg.num_layers)]
    if m > 1:
        for sig in sigs:
            for part in (sig.mixer, sig.ffn):
                # the block's last output needs no recompute: the backward
                # needs nothing after it, and a non-reentrant checkpoint
                # stops recomputing there
                last = part == (sig.ffn or sig.mixer)
                if part in ("attn", "mamba", "dense", "moe"):
                    add("all_reduce", micro * ((1 if last else passes) + 1)
                        * t * d * act, m)
            if sig.mixer == "mamba":
                add("all_reduce", micro * (passes + 1) * t * 4, m)
            if sig.ffn == "moe":
                add("all_reduce", micro * t * cfg.moe.top_k * 4, m)
        add("all_reduce", micro * t * d * act, m)
        add("all_reduce", micro * 2 * t * 4, m)
        add("all_reduce_max", micro * t * 4, m)
        if "lm_head" not in params:
            add("all_gather",
                micro * -(-cfg.vocab_size // m) * d * params["embed"]
                .element_size(), m)
    if rows.is_split:
        g = mesh.group_size(rows.axes)
        add("all_reduce", micro * 3 * 4, g)
        moe = sum(sig.ffn == "moe" for sig in sigs)
        if moe:
            add("all_reduce", micro * moe * (2 * passes + 1)
                * cfg.moe.num_experts * 4, g)
    leaf_sh = tree_leaves(tl.ShardedTrainStep(cfg, tc, mesh).leaf_shardings)
    if any(s.is_split for s in leaf_sh):
        groups = collections.Counter(s.axes for s in leaf_sh)
        for axes, n in groups.items():
            if axes:
                add("all_reduce", 4 * n, mesh.group_size(axes))
    pairs = list(zip(tree_leaves(abstract), tree_leaves(sh)))
    return {"traffic": dict(out),
            "bytes": sum(s.block_numel() * t.element_size()
                         for t, s in pairs),
            "full_bytes": sum(t.numel() * t.element_size()
                              for t, _ in pairs)}


def shard_flops(cfg, rows: int, m: int, j: int) -> int:
    """Matmul FLOPs of one forward of ``rows`` rows of ``shard_seq`` tokens
    on block ``j`` of a "model" split of ``m`` (m = 1: single-device),
    as FlopCounterMode counts them: per GQA layer the rank's ceil block of
    the q heads and the kv heads they read, their QK and PV products over
    the whole causal square, ``wo``'s rows of them; per dense FFN its ceil
    block of the hidden units; per MoE layer the router and the combine
    (every rank weighs every choice) whole, and its ceil block of the
    experts on their capacity slots (one token group); then the rank's
    ceil block of the vocabulary."""
    from repro_torch.launch.mesh import block_range
    from repro_torch.models.model import layer_signature
    seq = shard_seq(cfg)
    t = rows * seq
    d = cfg.d_model

    def ceil(n):
        lo, hi = block_range(n, m, j)
        return hi - lo

    total = 0
    for i in range(cfg.num_layers):
        sig = layer_signature(cfg, i)
        if sig.mixer != "attn":
            raise ValueError(f"shard_flops: no formula for {sig.mixer}")
        h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_eff
        lo, hi = block_range(h, m, j)
        hl, group = hi - lo, h // hkv
        kv = (hkv // m if hkv % m == 0 else
              (hi - 1) // group + 1 - lo // group if hl else 0)
        total += (2 * t * d * hl * hd + 2 * 2 * t * d * kv * hd
                  + 2 * 2 * rows * hl * seq * seq * hd + 2 * t * hl * hd * d)
        mats = 3 if cfg.activation in ("silu", "geglu") else 2
        if sig.ffn == "dense":
            total += mats * 2 * t * d * ceil(cfg.d_ff)
        elif sig.ffn == "moe":
            moe = cfg.moe
            e, k, f = moe.num_experts, moe.top_k, moe.d_ff_expert
            capacity = max(1, int(moe.capacity_factor * t * k / e))
            total += (2 * t * d * e + 2 * t * k * d
                      + ceil(e) * capacity * mats * 2 * d * f)
    return total + 2 * t * d * ceil(cfg.vocab_size)


def shard_single_flops(cfg, rows: int) -> int:
    """FlopCounterMode's matmul FLOPs of the single-device forward of
    ``rows`` rows of ``shard_seq`` tokens, on the meta device (no
    storage)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.models import model as lm
    with torch.device("meta"):
        model = lm.Model(cfg, generator=None, device="meta")
    zeros = torch.zeros((rows, shard_seq(cfg)), dtype=torch.long,
                        device="meta")
    with torch.no_grad(), FlopCounterMode(display=False) as flops:
        model.forward_train({"tokens": zeros, "labels": zeros}, remat=False)
    return flops.get_total_flops()


# ---------------------------------------------------------------------------
# [shard_serve]'s and [dryrun]'s rank sides (RankPool, as [dist]'s)
# ---------------------------------------------------------------------------

def shard_serve_config(arch: str):
    layers = SHARD_MOE_LAYERS if arch == SHARD_MOE_ARCH else SHARD_LAYERS
    return shard_config(layers, "float32", arch)


def shard_serve_tokens(cfg):
    """(prompt (rows, SERVE_SHARD_PROMPT), decode tokens (rows,
    SERVE_SHARD_DECODES)), seeded."""
    rng = np.random.default_rng(SERVE_SEED)
    return (rng.integers(0, cfg.vocab_size,
                         (SERVE_SHARD_ROWS, SERVE_SHARD_PROMPT)),
            rng.integers(0, cfg.vocab_size,
                         (SERVE_SHARD_ROWS, SERVE_SHARD_DECODES)))


def shard_serve_counts(mesh, flops) -> dict:
    return {"traffic": dict(mesh.traffic),
            "traffic_axes": {f"{k}@{'+'.join(a)}": v
                             for (k, a), v in mesh.traffic_axes.items()},
            "flops": flops}


def shard_serve_case(ctx, arch, mesh_shape):
    """The sharded prefill and SERVE_SHARD_DECODES decode steps of
    ``arch`` (shard_serve_config) on ``mesh_shape``: each rank builds the
    seeded model on the card one at a time and keeps its blocks.  The
    first prefill is counted (launches from 0, the collectives' traffic,
    FlopCounterMode), the second timed; each decode step counted and timed
    (host clock, every rank starting together, ending in a sync).  The
    whole logits of every step, as numpy."""
    import torch
    import torch.distributed as dist
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.launch import steps
    from repro_torch.models import model as lm
    mesh = dist_mesh(ctx, mesh_shape)
    cfg = shard_serve_config(arch)
    prefill = steps.make_step_fn(cfg, "prefill", None, mesh=mesh)
    decode = steps.make_step_fn(cfg, "decode", None, mesh=mesh)
    serve = prefill.serve
    for r in range(ctx.world):
        if r == ctx.rank:
            model = serve.shard(lm.init_params(cfg, SERVE_SEED,
                                               device=ctx.device))
            shard_release(ctx)
        dist.barrier()
    max_seq = SERVE_SHARD_PROMPT + SERVE_SHARD_DECODES
    caches = serve.shard_caches(lm.init_caches(cfg, SERVE_SHARD_ROWS,
                                               max_seq, device=ctx.device))
    prompt, tokens = shard_serve_tokens(cfg)
    batch = {"tokens": torch.as_tensor(prompt, device=ctx.device)}
    torch.cuda.reset_peak_memory_stats(ctx.device)

    def run(fn, count):
        mesh.traffic.clear()
        mesh.traffic_axes.clear()
        dist.barrier()
        torch.cuda.synchronize(ctx.device)
        t = time.perf_counter()
        if count:
            with FlopCounterMode(display=False) as flops:
                out = fn()
        else:
            out = fn()
        torch.cuda.synchronize(ctx.device)
        took = time.perf_counter() - t
        return out, took, shard_serve_counts(
            mesh, flops.get_total_flops() if count else None)

    shard_launches(reset=True)
    (logits, caches), _, pre = run(
        lambda: prefill(model, batch, caches), True)
    launches = shard_launches()
    out = [logits.cpu().numpy()]
    (logits, caches), prefill_s, _ = run(
        lambda: prefill(model, batch, caches), False)
    check(np.array_equal(logits.cpu().numpy(), out[0]),
          f"shard_serve {arch} {mesh_shape}: a second prefill differs")
    shard_launches(reset=True)
    dec, decode_s = [], []
    for i in range(SERVE_SHARD_DECODES):
        pos = torch.full((SERVE_SHARD_ROWS,), SERVE_SHARD_PROMPT + i,
                         dtype=torch.int32, device=ctx.device)
        tok = torch.as_tensor(tokens[:, i:i + 1], device=ctx.device)
        (logits, caches), took, counts = run(
            lambda: decode(model, tok, pos, caches), True)
        out.append(logits.cpu().numpy())
        dec.append(counts)
        decode_s.append(took)
    res = {"rank": ctx.rank, "logits": np.stack(out), "prefill": pre,
           "decode": dec, "prefill_s": prefill_s, "decode_s": decode_s,
           "launches_prefill": launches,
           "launches_decode": shard_launches(),
           "replicated": serve.replicated,
           "peak_gb": torch.cuda.max_memory_allocated(ctx.device) / 1e9,
           "model_index": mesh.coords()["model"]}
    del model, caches, logits
    shard_release(ctx)
    return res


def dry_mesh(mesh_shape):
    from repro_torch.launch.mesh import Mesh
    return Mesh(dict(zip(DIST_AXES[len(mesh_shape)], mesh_shape)))


def dry_counts(out) -> dict:
    """A trace's counters as the card's records hold them."""
    st = out["stats"]
    return dict(shard_serve_counts(out["mesh"], st.matmul_flops),
                kernels=st.kernels, memory=out["memory"],
                stats=st.to_json())


def dryrun_train_case(ctx, arch, mesh_shape):
    """[shard_train]'s step of ``arch`` on ``mesh_shape``, traced as this
    rank of the described mesh on meta: its counters, this rank's bytes of
    state, and one microbatch forward's matmul FLOPs (the card's
    FlopCounterMode reading)."""
    import torch
    from repro_torch.launch import specs, steps
    from repro_torch.launch.mesh import Mesh
    from repro_torch.training import train_loop as tl
    cfg = shard_case_config(arch)
    micro = SHARD_MICRO[mesh_shape]
    tc = shard_train_config(micro)
    shape = dataclasses.replace(
        next(s for s in cfg.shapes if s.name == "train_4k"),
        global_batch=SHARD_BATCH)
    mesh = dry_mesh(mesh_shape)
    out = dry_counts(steps.trace_cell(cfg, shape, mesh, rank=ctx.rank,
                                      tc=tc))
    rank_mesh = Mesh(mesh.shape, rank=ctx.rank, described=True)
    step = tl.make_train_step(cfg, tc, mesh=rank_mesh)
    state = tl.shard_train_state(specs.abstract_train_state(cfg, tc),
                                 rank_mesh)
    mb = tl._split_microbatches(specs.train_input_specs(cfg, shape),
                                micro)[0]
    with torch.no_grad():
        fwd = steps.trace_call(rank_mesh, step.forward, state.params, mb)
    out.update(forward_flops=fwd["stats"].matmul_flops,
               state_bytes=steps._storage_bytes(state))
    return out


def dryrun_serve_case(ctx, arch, mesh_shape):
    """[shard_serve]'s prefill and decode steps traced as this rank of the
    described mesh on meta (the flash kernel counted by its work, as the
    card launches it): their counters."""
    import torch
    from repro_torch.launch import specs, steps
    from repro_torch.launch.mesh import Mesh
    cfg = shard_serve_config(arch)
    out = {}
    for kind in ("prefill", "decode"):
        rank_mesh = Mesh(dry_mesh(mesh_shape).shape, rank=ctx.rank,
                         described=True)
        step = steps.make_step_fn(cfg, kind, None, mesh=rank_mesh)
        caches = specs.abstract_caches(cfg, SERVE_SHARD_ROWS,
                                       SERVE_SHARD_PROMPT
                                       + SERVE_SHARD_DECODES)
        if kind == "prefill":
            args = (specs.abstract_params(cfg), {"tokens": torch.empty(
                (SERVE_SHARD_ROWS, SERVE_SHARD_PROMPT), dtype=torch.long,
                device="meta")}, caches)
        else:
            args = (specs.abstract_params(cfg), torch.empty(
                (SERVE_SHARD_ROWS, 1), dtype=torch.long, device="meta"),
                torch.empty((SERVE_SHARD_ROWS,), dtype=torch.int32,
                            device="meta"), caches)
        args = steps.rank_args(kind, args, rank_mesh, step)
        out[kind] = dry_counts(steps.trace_call(rank_mesh, step, *args))
    return out


def dryrun_job(job):
    """One single-card or production dry-run job of [dryrun]: (name,
    record)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun, roofline, specs, steps
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import model as lm
    from repro_torch.training import train_loop as tl
    kind, args = job[0], job[1:]
    one = Mesh({"data": 1}, rank=0, described=True)
    if kind == "lm":
        arch, shape, multi = args
        rec = dryrun.run_cell(arch, shape, multi)
    elif kind == "ceil":
        arch, rank = args
        rec = dryrun.run_cell(arch, "train_4k", False, rank=rank)
    elif kind == "graph":
        mesh_shape, mode, bank = args
        mesh = Mesh(dict(zip(("pod", "data", "model")[-len(mesh_shape):],
                             mesh_shape)))
        rec = dryrun.run_graph_cell(DRY_GRAPH_N, 3, False,
                                    setup_name="setup2", spectral_mode=mode,
                                    bank_size=bank, mesh=mesh)
    elif kind == "train":
        # [train]'s step: granite-3-2b full, bf16, TRAIN_BATCH x 4,096
        # tokens in TRAIN_MICRO microbatches, the single-device step
        cfg = get_config(TRAIN_ARCH)
        tc = tl.TrainConfig(optimizer=tl.TrainConfig.for_arch(cfg).optimizer,
                            num_microbatches=TRAIN_MICRO)
        shape = dataclasses.replace(
            next(s for s in cfg.shapes if s.name == "train_4k"),
            global_batch=TRAIN_BATCH)
        out = steps.trace_call(one, tl.make_train_step(cfg, tc),
                               specs.abstract_train_state(cfg, tc),
                               specs.train_input_specs(cfg, shape))
        rec = {"stats": out["stats"], "kind": "train",
               "active": cfg.active_param_count(), "batch": TRAIN_BATCH,
               "seq": shape.seq_len, "dtype": cfg.activation_dtype}
    elif kind in ("prefill", "tick"):
        # [times]' granite-3-2b bf16 prefill of 2,048 tokens (one row, the
        # flash kernel) and its engine's decode of SERVE_SLOTS rows
        cfg = get_config(SERVE_ARCH)
        model = specs.abstract_params(cfg)
        if kind == "prefill":
            s = max(FLASH_LENGTHS)
            caches = lm.init_caches(cfg, 1, s, device="meta")
            toks = torch.empty((1, s), dtype=torch.long, device="meta")
            with torch.no_grad():
                out = steps.trace_call(one, model.forward_prefill,
                                       {"tokens": toks}, caches,
                                       use_flash=True)
            rows, seq = 1, s
        else:
            caches = lm.init_caches(cfg, SERVE_SLOTS, SERVE_MAX_SEQ,
                                    device="meta")
            tok = torch.empty((SERVE_SLOTS, 1), dtype=torch.long,
                              device="meta")
            pos = torch.empty((SERVE_SLOTS,), dtype=torch.long,
                              device="meta")
            with torch.no_grad():
                out = steps.trace_call(one, model.forward_decode, tok, pos,
                                       caches)
            rows, seq = SERVE_SLOTS, 1
        rec = {"stats": out["stats"], "kind": "prefill" if seq > 1
               else "decode", "active": cfg.active_param_count(),
               "batch": rows, "seq": seq, "dtype": cfg.activation_dtype}
    else:  # the main path's fused matvec at n = N_MAIN, C = 1
        setup_name = args[0]
        op = dryrun.meta_fastsum(setup_name.lower().replace("_", ""),
                                 N_MAIN, 3)
        out = dryrun.trace_matvec(op, (N_MAIN,))
        rec = {"stats": out["stats"], "kind": "prefill",
               "active": float(N_MAIN), "batch": 1, "seq": 1,
               "dtype": "float64"}
    if "stats" in rec and not isinstance(rec["stats"], dict):
        roof = roofline.roofline_from_stats(
            rec["stats"], kind=rec["kind"], active_params=rec["active"],
            batch=rec["batch"], seq=rec["seq"], chips=1, dtype=rec["dtype"])
        rec = {"stats": rec["stats"].to_json(), "roofline": roof.to_json()}
    return "/".join(str(a) for a in job), rec


def dryrun_jobs(ctx, jobs_by_rank):
    """This rank's share of [dryrun]'s jobs (``dryrun_job``), each with its
    host seconds."""
    out = []
    for job in jobs_by_rank[ctx.rank]:
        t = time.perf_counter()
        name, rec = dryrun_job(job)
        out.append((name, rec, time.perf_counter() - t))
    return out


def wide_config(phase: str, dtype: str):
    """[phase]'s cut of its architecture (WIDE_SERVE) in ``dtype``."""
    import repro_torch.configs as configs
    arch, bf16_layers, f32_layers = WIDE_SERVE[phase]
    return dataclasses.replace(
        configs.get_config(arch), param_dtype=dtype, activation_dtype=dtype,
        num_layers=bf16_layers if dtype == "bfloat16" else f32_layers)


def serve_memory_plan(cfg, slots: int = SERVE_SLOTS,
                      max_seq: int = SERVE_MAX_SEQ) -> dict:
    """The bytes a serving phase holds on the card, from ``cfg``'s model
    built on meta, its parameters taken in ``init_params``' order: the
    weights; the caches of a ``slots`` x ``max_seq`` engine; and the peak
    while the weights are drawn, where each matrix is drawn in float32
    and scaled (``dense_init``, ``embed_init``): 8 bytes an element live at
    once, beside the weights drawn before it.  The serving peak is at
    least the weights and caches together."""
    import torch
    from repro_torch.models import model as lm
    with torch.device("meta"):
        model = lm.Model(cfg, generator=None, device="meta")
    # the Model's own parameters are listed before its blocks; it draws
    # embed and frontend_proj first, final_norm and lm_head after them
    order = [getattr(model, n) for n in ("embed", "frontend_proj")
             if getattr(model, n, None) is not None]
    order += list(model.blocks.parameters()) + [model.final_norm]
    order += [model.lm_head] if model.lm_head is not None else []
    order += list(model.mtp.parameters())
    held = init_peak = 0
    for p in order:
        if p.ndim >= 2:
            init_peak = max(init_peak, held + 8 * p.numel())
        held += p.numel() * p.element_size()
    caches = lm.init_caches(cfg, slots, max_seq, device="meta")
    cache_bytes = sum(t.numel() * t.element_size() for c in caches
                      for t in c)
    return {"params": sum(p.numel() for p in order), "weight_bytes": held,
            "cache_bytes": cache_bytes, "init_peak_bytes": init_peak,
            "peak_bytes": max(init_peak, held + cache_bytes)}


def richardson(f, x0: float, h: float) -> float:
    """Central differences at steps h and h/2, extrapolated: O(h^4)."""
    d1 = (f(x0 + h) - f(x0 - h)) / (2 * h)
    d2 = (f(x0 + h / 2) - f(x0 - h / 2)) / h
    return (4 * d2 - d1) / 3


# the phases in the order they run (Smoke.phase_<name>)
PHASES = ("device", "build", "kernels", "kernel_matvec", "flash", "anchor",
          "main_path", "guard", "ssl", "krr", "grad", "direct", "oracle",
          "nystrom", "segment", "bank", "sweep", "multilayer", "graph_serve",
          "durable", "dist", "serve", "nfft_serve", "times", "train",
          "train_families", "shard_train", "shard_serve", "dryrun",
          "moe_serve", "ssm_serve", "mla_serve", "hybrid_serve",
          "llama_serve", "qwen_serve", "jamba_serve", "frontends")


def log(msg: str = "") -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def gc_collect(torch) -> None:
    """Drop the phase's tensors from the allocator's cache."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", type=Path, default=None,
                    help="also write every measurement to this file")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs a CUDA card", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} is missing; run from a "
              "checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    smoke = Smoke(torch)
    smoke.run()
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(smoke.record, indent=1))
    log(json.dumps({"kernels": smoke.kernel_records()}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


class Smoke:
    def __init__(self, torch):
        from repro_torch.core import fastsum, fastsum_exec, solvers
        # the module: repro_torch.core re-exports the function under its name
        lanczos = importlib.import_module("repro_torch.core.lanczos")
        from repro_torch.core.kernels import (
            KERNEL_PARAM_NAME, kernel_from_param, make_kernel,
        )
        from repro_torch.core.nfft import (
            build_window_geometry, ndft_adjoint, ndft_forward,
            padded_grid_size,
        )
        from repro_torch import image_segmentation
        from repro_torch.core import nystrom
        from repro_torch.data.synthetic import (
            crescent_fullmoon, spiral, synthetic_image,
        )
        from repro_torch.graph import krr, spectral, ssl
        from repro_torch.kernels import _build, kernel_matvec, nfft_window
        from repro_torch.configs import get_config
        from repro_torch.kernels import flash_attention
        from repro_torch.launch import roofline
        from repro_torch.models import model as lm
        from repro_torch.runtime import durable, faultinject, guards
        from repro_torch.serving import graph as graph_serving
        from repro_torch.serving import journal
        from repro_torch.serving.engine import Request, ServeEngine

        self.torch = torch
        from repro_torch.launch import time_flash
        self.fa, self.lm, self.get_config = flash_attention, lm, get_config
        self.tfl = time_flash  # flash's SDPA yardstick
        self.rl = roofline
        self.Request, self.ServeEngine = Request, ServeEngine
        self.fs, self.lan, self.spec = fastsum, lanczos, spectral
        self.solvers = solvers
        self.exec = fastsum_exec
        self.spiral = spiral
        self.build_window_geometry = build_window_geometry
        self.ndft_adjoint, self.ndft_forward = ndft_adjoint, ndft_forward
        self.padded_grid_size = padded_grid_size
        self.build, self.win = _build, nfft_window
        self.km, self.guards, self.ssl, self.krr = (kernel_matvec, guards,
                                                    ssl, krr)
        self.crescent = crescent_fullmoon
        self.synthetic_image = synthetic_image
        self.seg_params = image_segmentation.PARAMS
        self.nys = nystrom
        self.make_kernel, self.kernel_from_param = (make_kernel,
                                                    kernel_from_param)
        self.param_name = KERNEL_PARAM_NAME
        self.graph = graph_serving
        self.durable, self.faults, self.journal = durable, faultinject, journal
        self.det_records = []  # the deterministic spread on [durable]'s paths
        self.path_launches = {}
        self.slice_records = []  # window kernels on the slice-8/9 paths
        self.shard_serve_rows = []  # flash at [shard_serve]'s rank shapes
        self.alpha_hat = {}  # [graph_serve]'s NDFT of each model's alpha
        self.dev = torch.device("cuda", 0)
        self.kernel = make_kernel("gaussian", sigma=SIGMA)
        self.record = {"checks": [], "times": []}
        self.geometries = {}

    # -- helpers -----------------------------------------------------------
    def sync(self):
        self.torch.cuda.synchronize(self.dev)

    def time_ms(self, fn, reps: int, warmup: int = 2) -> float:
        """Mean ms per call over ``reps`` back-to-back calls (CUDA events)."""
        torch = self.torch
        for _ in range(warmup):
            fn()
        self.sync()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    def host_ms(self, fn, reps: int, warmup: int = 1) -> float:
        """Mean ms per call over ``reps`` calls, host clock ending in
        ``synchronize()``."""
        for _ in range(warmup):
            fn()
        self.sync()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        self.sync()
        return (time.perf_counter() - t0) / reps * 1e3

    def setup(self, name):
        if name == "SEG":
            return self.seg_params
        if name in WIDE_WINDOWS:
            return self.fs.FastsumParams(n_bandwidth=32, m=WIDE_WINDOWS[name],
                                         eps_b=0.0)
        return getattr(self.fs, name)

    def reset_launches(self):
        self.win.window_spread.launches = 0
        self.win.window_spread_deterministic.launches = 0
        self.win.window_gather.launches = 0
        self.km.kernel_matvec.launches = 0
        self.fa.flash_attention.launches = 0

    def read_launches(self, path: str) -> dict:
        counts = {"window_spread": self.win.window_spread.launches,
                  "window_spread_deterministic":
                      self.win.window_spread_deterministic.launches,
                  "window_gather": self.win.window_gather.launches,
                  "kernel_matvec": self.km.kernel_matvec.launches,
                  "flash_attention": self.fa.flash_attention.launches}
        self.path_launches[path] = counts
        return counts

    def km_bound(self, n_out, n_in, d, c, profile, dtype_name,
                 zero_diagonal):
        """(ms, bound_by, flops, bytes) of the card's least time for one
        direct sum, its work counted by ``kernel_matvec.work``."""
        flops, nbytes = self.km.work(n_out, n_in, d, c, profile, dtype_name,
                                     zero_diagonal)
        ms, by = self.rl.bound_ms(flops, nbytes, PEAK_FLOPS[dtype_name])
        return ms, by, flops, nbytes

    def km_inputs(self, n_out, n_in, d, c, dtype, points=None):
        """(a, b, x).  "spiral" (the default when square): spiral nodes
        (first d coordinates) as both point sets; "ssl": the SSL path's
        crescent-fullmoon nodes as both; "krr" (the default when
        rectangular): the KRR path's crescent-fullmoon test and training
        points; "serve" / "serve_sweep": [graph_serve]'s two training sets
        and queries.  x is standard normal."""
        torch = self.torch
        points = points or ("spiral" if n_out == n_in else "krr")
        if points == "serve":  # [graph_serve]'s training set and queries
            rng = np.random.default_rng(GS_SEED)
            b = torch.as_tensor(graph_serve_data(rng)[0][:n_in], dtype=dtype,
                                device=self.dev)
            a = torch.as_tensor(rng.uniform(-2.5, 2.5, (n_out, d)),
                                dtype=dtype, device=self.dev)
        elif points == "serve_sweep":  # the sweep group's, in its box
            pts, _ = sweep_dataset(GS_SWEEP_D, n_in, self.crescent,
                                   self.spiral)
            b = torch.as_tensor(pts, dtype=dtype, device=self.dev)
            a = torch.as_tensor(np.random.default_rng(GS_SEED).uniform(
                pts.min(axis=0), pts.max(axis=0), (n_out, d)), dtype=dtype,
                device=self.dev)
        elif points != "krr":
            pts, _ = (self.crescent(n_in, seed=0) if points == "ssl"
                      else self.spiral(n_in, seed=0))
            b = a = torch.as_tensor(pts[:, :d], dtype=dtype, device=self.dev)
        else:
            pts, _ = self.crescent(n_in + n_out, seed=5)
            b = torch.as_tensor(pts[:n_in], dtype=dtype, device=self.dev)
            a = torch.as_tensor(pts[n_in:], dtype=dtype, device=self.dev)
        gen = torch.Generator(device=self.dev).manual_seed(c)
        x = torch.randn((n_in, c), generator=gen, dtype=dtype,
                        device=self.dev)
        return a, b, x

    def km_shapes(self):
        """(n_out, n_in, d, c, zero_diagonal) of every kernel_matvec check."""
        for n in KM_SQUARE_N:
            for d in (2, 3):
                for c in (1, 4):
                    yield n, n, d, c, True
        yield KM_RECT[0], KM_RECT[1], 2, 1, False
        yield KM_RECT[0], KM_RECT[1], 2, 1, True

    def flash_bound(self, b, hq, hkv, sq, sk, dh, causal, dname):
        """(ms, bound_by, flops, bytes) of the card's least time for one
        attention forward in dtype ``dname``, its work counted by
        ``flash_attention.work``, over the dense tensor-core peak of that
        dtype (``roofline.TENSOR_PEAK_FLOPS``: float32 runs as TF32)."""
        itemsize = 4 if dname == "float32" else 2
        flops, nbytes = self.fa.work(b, hq, hkv, sq, sk, dh, causal,
                                     itemsize)
        ms, by = self.rl.bound_ms(flops, nbytes,
                                  self.rl.TENSOR_PEAK_FLOPS[dname])
        return ms, by, flops, nbytes

    def flash_inputs(self, b, hq, hkv, sq, sk, dh, dtype, seed):
        torch = self.torch
        gen = torch.Generator(device=self.dev).manual_seed(seed)
        return [torch.randn(shape, generator=gen, device=self.dev).to(dtype)
                for shape in ((b, hq, sq, dh), (b, hkv, sk, dh),
                              (b, hkv, sk, dh))]

    def flash_shapes(self):
        """(label, (b, hq, hkv, sq, sk, dh), causal, dtype name) of every
        flash attention check."""
        for shape in FLASH_SWEEP:
            for causal in (False, True):
                for dname in ("float32", "bfloat16"):
                    yield "sweep", shape, causal, dname
        for s in FLASH_LENGTHS:
            for dname in ("float32", "bfloat16", "float16"):
                yield "granite", (1, 32, 8, s, s, 64), True, dname
        for dname in ("float32", "bfloat16"):
            yield "decode", (1, 32, 8, 1, FLASH_DECODE_SK, 64), True, dname
        yield ("layer", (1, 32, 8, FLASH_LAYER_S, FLASH_LAYER_S, 64), True,
               "bfloat16")
        for _, label, shape, causal, _ in FAMILY_FLASH:
            for dname in ("float32", "bfloat16"):
                yield label, shape, causal, dname
            if shape[5] in (80, 256):  # hubert's and gemma's heads
                yield label, shape, causal, "float16"

    def window_geometry(self, setup_name, d, n, kind="spiral"):
        """(NFFT plan, window geometry), built once per argument set.

        "spiral": the main path's nodes (first d coordinates), Morton-sorted;
        "unsorted": the same without the sort; "uniform": uniform random
        nodes; "ssl": crescent-fullmoon under the SSL path's parameters;
        "segment": the [segment] path's pixels (n is theirs)."""
        key = (setup_name, d, n, kind)
        if key in self.geometries:
            return self.geometries[key]
        torch = self.torch
        if kind == "ssl":
            pts, _ = self.crescent(n, seed=0)
            params = self.fs.FastsumParams(n_bandwidth=128, m=3, eps_b=0.0)
        elif kind == "segment":
            pts = self.segment_pixels()
            params = self.setup("SEG")
        else:
            if kind == "uniform":
                pts = np.random.default_rng(0).uniform(-1, 1, (n, d))
            else:
                pts, _ = self.spiral(n, seed=0)
            params = self.setup(setup_name)
        pts = torch.as_tensor(pts[:, :d], device=self.dev)
        scaled, _, _ = self.fs.scale_nodes(pts, params.eps_b_eff)
        plan = params.nfft_plan(d)
        geom = self.build_window_geometry(plan, scaled,
                                          sort=kind != "unsorted")
        self.geometries[key] = plan, geom
        return plan, geom

    def segment_pixels(self):
        """(N_SEG, 3) RGB nodes of synthetic_image(SEG_H, SEG_W); the
        truth labels are in ``self.segment_truth``."""
        img, truth = self.synthetic_image(SEG_H, SEG_W)
        self.segment_truth = truth.reshape(-1)
        return img.reshape(-1, 3)

    def geometry(self, setup_name, d, n, dtype, kind="spiral"):
        """(plan, base, weights in ``dtype``, tile plan) of a geometry;
        "random": the spiral's, with seeded standard normal weights."""
        plan, geom = self.window_geometry(
            setup_name, d, n, "spiral" if kind == "random" else kind)
        w = geom.weights
        if kind == "random":
            gen = self.torch.Generator(device=self.dev).manual_seed(plan.taps)
            w = self.torch.randn(w.shape, generator=gen, dtype=w.dtype,
                                 device=self.dev)
        return plan, geom.base, w.to(dtype), geom.tiles

    def bound(self, n, d, taps, c, pad, dtype_name):
        """(ms, bound_by, flops, bytes) of the card's least time for one
        spread or gather, its work counted by ``nfft_window.work``."""
        flops, nbytes = self.win.work(n, d, taps, c, pad, dtype_name)
        ms, by = self.rl.bound_ms(flops, nbytes, PEAK_FLOPS[dtype_name])
        return ms, by, flops, nbytes

    # -- phases ------------------------------------------------------------
    def run(self):
        """Every phase of PHASES in order; each one's wall printed at the
        end ([walls])."""
        walls = self.record["phase_walls"] = {}
        for name in PHASES:
            t0 = time.perf_counter()
            getattr(self, f"phase_{name}")()
            walls[name] = time.perf_counter() - t0
        log("[walls] " + ", ".join(f"{k} {v:.1f}s" for k, v in walls.items())
            + f"; total {sum(walls.values()):.1f}s")

    def phase_device(self):
        torch = self.torch
        name = torch.cuda.get_device_name(0)
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
        card = smi.stdout.strip().splitlines()[0]
        self.record["device"] = {"name": name,
                                 "count": torch.cuda.device_count(),
                                 "nvidia_smi": card,
                                 "torch": torch.__version__,
                                 "cuda": torch.version.cuda}
        log(f"[device] {name} x{torch.cuda.device_count()}  torch "
            f"{torch.__version__} cuda {torch.version.cuda}")
        log(f"[device] nvidia-smi name,power.limit: {card}")

    def phase_build(self):
        t0 = time.perf_counter()
        info = self.build.build()
        for source in info:
            self.build.load_library(source)
        took = time.perf_counter() - t0
        self.record["build_s"] = took
        log(f"[build] {len(info)} nvcc sm_90a builds, all at once: "
            f"{took:.1f}s wall")
        for source, one in info.items():
            log(f"[build] {source}: {one['seconds']:.1f}s "
                f"({'built' if one['seconds'] else 'cached'})")
            regs, spills, fn = {}, [], None
            for line in one["log"].splitlines():
                m = re.search(r"Compiling entry function '(\w+)'", line)
                if m:
                    fn = m.group(1)
                m = re.search(r"Used (\d+) registers", line)
                if m and fn:
                    regs[fn] = int(m.group(1))
                if "spill" in line and fn and not re.search(
                        r"\b0 bytes spill stores, 0 bytes spill loads",
                        line):
                    spills.append(f"{fn}: {line.strip()}")
            if len(regs) <= 8:
                for fn, r in regs.items():
                    log(f"[build]   {fn}: {r} registers")
            elif regs:
                log(f"[build]   {len(regs)} entry functions, "
                    f"{min(regs.values())}-{max(regs.values())} registers")
            for line in spills:
                log(f"[build]   {line}")
            if source == "flash_attention.cu":
                self.flash_build_report(one["log"])
            if source == "kernel_matvec.cu":
                self.km_build_report(one["log"])

    def km_build_report(self, text):
        """Registers and spills of kernel_matvec's first pass, by type,
        channel chunk CH and rows per thread R (over d and the profile),
        from nvcc's -Xptxas -v report."""
        rows, key = {}, None
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '\w*kernel_matvec_kernel"
                          r"I([df])Li(\d+)ELi(\d+)ELi(\d+)ELi(\d+)E", line)
            if m:
                key = ("float64" if m.group(1) == "d" else "float32",
                       int(m.group(4)), int(m.group(5)))
                rows.setdefault(key, {"registers": [], "spill_bytes": 0,
                                      "instances": 0})
                rows[key]["instances"] += 1
                continue
            if "Compiling entry function" in line:
                key = None
            if key is None:
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m:
                rows[key]["spill_bytes"] += int(m.group(1)) + int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                rows[key]["registers"].append(int(m.group(1)))
        check(sum(r["instances"] for r in rows.values()) == 72,
              "kernel_matvec: expected 72 first-pass instances (2 types x "
              "3 d paths x 4 profiles x 3 channel chunks) in the ptxas "
              "report")
        self.record["km_build"] = []
        for (dname, ch, r_rows), r in sorted(rows.items()):
            regs = r["registers"]
            self.record["km_build"].append(
                {"dtype": dname, "channel_chunk": ch,
                 "rows_per_thread": r_rows, "registers_min": min(regs),
                 "registers_max": max(regs),
                 "spill_bytes": r["spill_bytes"]})
            log(f"[build]   kernel_matvec_kernel {dname} CH={ch} R={r_rows}: "
                f"{min(regs)}-{max(regs)} registers over "
                f"{r['instances']} instances (d, profile), "
                f"{r['spill_bytes']} bytes spilled")

    def flash_build_report(self, text):
        """Registers, shared memory and spills of each instance of the
        flash kernels (wgmma for bf16 / f16, TF32 mma.sync for float32),
        from nvcc's -Xptxas -v report."""
        rows, name = {}, None
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '\w*flash_fwd_wgmmaI\d*"
                          r"(__nv_bfloat16|__half)Li(\d+)E", line)
            m32 = re.search(r"Compiling entry function '\w*flash_fwd_tf32I"
                            r"Li(\d+)E", line)
            if m:
                name = ("bfloat16" if "bf" in m.group(1) else "float16",
                        int(m.group(2)))
                rows[name] = {"smem": 0}
                continue
            if m32:
                name = ("float32", int(m32.group(1)))
                rows[name] = {"smem": 0}
                continue
            if "Compiling entry function" in line:
                name = None
            if name is None:
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m:
                rows[name]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                rows[name]["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            if m:
                rows[name]["smem"] = int(m.group(1))
        want = {(dname, dh) for dname in ("bfloat16", "float16")
                for dh in self.fa.WGMMA_HEAD_DIMS}
        want |= {("float32", dh) for dh in self.fa.HEAD_DIMS}
        check(set(rows) == want, f"flash: tensor-core kernel instances "
              f"{sorted(rows)} in the ptxas report, expected {sorted(want)}")
        self.record["flash_build"] = []
        for (dname, dh), r in sorted(rows.items()):
            if dname == "float32":
                # dynamic (F32Tile::kSmem): two stages of a K tile (rows of
                # dh + 8 floats) and a V tile (dh + 4) of 64 keys (32 at
                # dh = 128 and 256), and at dh = 256 q's 64 rows
                keys = 64 if dh <= 80 else 32
                dyn = 4 * (2 * keys * (2 * dh + 12)
                           + (64 * (dh + 8) if dh == 256 else 0))
                kernel = "flash_fwd_tf32"
            else:
                # dynamic (TcTile::kSmem): two stages of K and V tiles
                # (64 x dh), q's tile and its barrier where q is staged
                # (dh = 256), 1024 bytes of alignment slack, three
                # barriers per stage
                tile = 64 * dh * 2
                dyn = (2 * 2 * tile + (tile + 8 if dh == 256 else 0) + 1024
                       + 48)
                kernel = "flash_fwd_wgmma"
            self.record["flash_build"].append(
                {"dtype": dname, "dh": dh, "kernel": kernel, **r,
                 "dynamic_smem": dyn})
            log(f"[build]   {kernel} {dname} dh={dh}: "
                f"{r.get('registers')} registers, {r['smem'] + dyn} bytes "
                f"shared memory per block ({dyn} dynamic), "
                f"{r.get('spill_bytes')} bytes spilled")
            check(r.get("spill_bytes") == 0,
                  f"{kernel} {dname} dh={dh} spills: {r}")
            check(r["smem"] + dyn <= SMEM_PER_BLOCK,
                  f"{kernel} {dname} dh={dh}: {r['smem'] + dyn} "
                  f"bytes of shared memory, over {SMEM_PER_BLOCK}")

    def window_cases(self):
        """(kind, setup, d, channels, dtypes) of every window check."""
        torch = self.torch
        both = (torch.float64, torch.float32)
        for setup_name in ("SETUP_2", "SETUP_3"):
            for d in (1, 2, 3):
                yield "spiral", setup_name, d, (1, 4), both
        for kind, setup_name, d, chans in WINDOW_STRESS:
            yield kind, setup_name, d, chans, both
        for setup_name in WIDE_WINDOWS:
            yield "spiral", setup_name, 3, (1, 4), both
            yield "random", setup_name, 3, (1,), both
        # the hybrid Nyström's C = L probe blocks, and the segmentation's
        # pixel geometry
        yield "spiral", "SETUP_2", 3, NYS_COLUMNS, both
        yield "random", "SETUP_2", 3, NYS_COLUMNS, both
        yield "segment", "SEG", 3, (1, 4), both

    def phase_kernels(self):
        torch, win = self.torch, self.win
        log(f"[kernels] kernel vs plain at n={N_MAIN} (segment: n={N_SEG}), "
            "rel = max|k-p| / max|p|; each geometry's tile plan built once")
        for kind, setup_name, d, chans, dtypes in self.window_cases():
            n = N_SEG if kind == "segment" else N_MAIN
            for dtype in dtypes:
                dname = str(dtype).split(".")[1]
                plan, base, w, tiles = self.geometry(setup_name, d, n, dtype,
                                                     kind)
                pad = self.padded_grid_size(plan)
                for c in chans:
                    gen = torch.Generator(device=self.dev).manual_seed(c)
                    x = torch.randn((n, c), generator=gen, dtype=dtype,
                                    device=self.dev)
                    g = torch.randn((pad,) * d + (c,), generator=gen,
                                    dtype=dtype, device=self.dev)
                    for kname, k_out, p_out in (
                            ("spread",
                             win.window_spread(x, base, w, padded_size=pad,
                                               tiles=tiles),
                             win.window_spread_plain(x, base, w,
                                                     padded_size=pad)),
                            ("gather", win.window_gather(g, base, w,
                                                         tiles=tiles),
                             win.window_gather_plain(g, base, w))):
                        self.sync()
                        err = float((k_out - p_out).abs().max())
                        rel = err / float(p_out.abs().max())
                        tol = TOL[(kname, dname)]
                        ok = rel <= tol
                        self.record["checks"].append({
                            "kernel": kname, "geometry": kind,
                            "setup": setup_name, "d": d, "c": c,
                            "dtype": dname, "n": n,
                            "tiles": tiles.n_tiles,
                            "max_box_cells": tiles.max_cells,
                            "max_abs_err": err, "rel_err": rel, "tol": tol,
                            "ok": ok})
                        log(f"[kernels] {kname:6s} {kind} {setup_name} d={d} "
                            f"C={c} {dname}: max_abs_err={err:.3e} "
                            f"rel={rel:.3e} (tol {tol:g}, {rel / tol:.3g} of "
                            f"it) {'ok' if ok else 'FAIL'}")
                        check(ok, f"{kname} {kind} {setup_name} d={d} C={c} "
                              f"{dname}: rel {rel:.3e}")
            # adjoint identity, float64, at the case's widest C
            plan, base, w, tiles = self.geometry(setup_name, d, n,
                                                 torch.float64, kind)
            pad = self.padded_grid_size(plan)
            gen = torch.Generator(device=self.dev).manual_seed(7)
            c = max(chans)
            x = torch.randn((n, c), generator=gen, dtype=torch.float64,
                            device=self.dev)
            g = torch.randn((pad,) * d + (c,), generator=gen,
                            dtype=torch.float64, device=self.dev)
            lhs = float((win.window_gather(g, base, w, tiles=tiles)
                         * x).sum())
            rhs = float((g * win.window_spread(
                x, base, w, padded_size=pad, tiles=tiles)).sum())
            rel = abs(lhs - rhs) / abs(lhs)
            log(f"[kernels] adjoint {kind} {setup_name} d={d} C={c} "
                f"float64: rel={rel:.3e} (tol {ADJOINT_TOL:g}); "
                f"{tiles.n_tiles} tiles, largest box {tiles.max_cells} "
                "cells")
            check(rel <= ADJOINT_TOL,
                  f"adjoint {kind} {setup_name} d={d}: {rel:.3e}")

    def phase_kernel_matvec(self):
        torch, km = self.torch, self.km
        log("[kernels] kernel_matvec vs plain, rel = max|k-p| / max|p|")
        for n_out, n_in, d, c, zd in self.km_shapes():
            for dtype in (torch.float64, torch.float32):
                dname = str(dtype).split(".")[1]
                a, b, x = self.km_inputs(n_out, n_in, d, c, dtype)
                for kname, param in KM_PROFILES:
                    kw = dict(kernel_name=kname, param=param,
                              zero_diagonal=zd)
                    k_out = km.kernel_matvec(a, b, x, **kw)
                    p_out = km.kernel_matvec_plain(a, b, x, **kw)
                    self.sync()
                    err = float((k_out - p_out).abs().max())
                    rel = err / float(p_out.abs().max())
                    ok = rel <= KM_TOL[dname]
                    self.record["checks"].append({
                        "kernel": "kernel_matvec", "profile": kname,
                        "n_out": n_out, "n_in": n_in, "d": d, "c": c,
                        "dtype": dname, "zero_diagonal": zd,
                        "max_abs_err": err, "rel_err": rel,
                        "tol": KM_TOL[dname], "ok": ok})
                    log(f"[kernels] kernel_matvec {kname:20s} {n_out}x"
                        f"{n_in} d={d} C={c} {dname} zero_diag={zd}: "
                        f"max_abs_err={err:.3e} rel={rel:.3e} (tol "
                        f"{KM_TOL[dname]:g}) {'ok' if ok else 'FAIL'}")
                    check(ok, f"kernel_matvec {kname} {n_out}x{n_in} d={d} "
                          f"C={c} {dname}: rel {rel:.3e}")
        self.check_kernel_matvec_x_grad()

    def check_kernel_matvec_x_grad(self):
        """d<w, K x>/dx of the CUDA direct sum (its backward is a second
        launch with the point sets swapped) against autograd through the
        plain version, on a rectangular pair, float64."""
        torch, km = self.torch, self.km
        n_out, n_in, d = KM_GRAD_SHAPE
        a, b, x = self.km_inputs(n_out, n_in, d, 1, torch.float64)
        w = torch.randn((n_out, 1), dtype=torch.float64, device=self.dev,
                        generator=torch.Generator(device=self.dev)
                        .manual_seed(1))
        for kname, param in KM_PROFILES:
            for zd in (True, False):
                kw = dict(kernel_name=kname, param=param, zero_diagonal=zd)
                grads = []
                for fn in (km.kernel_matvec, km.kernel_matvec_plain):
                    xg = x.clone().requires_grad_(True)
                    (g,) = torch.autograd.grad((fn(a, b, xg, **kw) * w).sum(),
                                               xg)
                    grads.append(g)
                self.sync()
                err = float((grads[0] - grads[1]).abs().max())
                rel = err / float(grads[1].abs().max())
                ok = rel <= KM_TOL["float64"]
                self.record["checks"].append({
                    "kernel": "kernel_matvec_x_grad", "profile": kname,
                    "n_out": n_out, "n_in": n_in, "d": d, "c": 1,
                    "dtype": "float64", "zero_diagonal": zd,
                    "max_abs_err": err, "rel_err": rel,
                    "tol": KM_TOL["float64"], "ok": ok})
                log(f"[kernels] kernel_matvec x-gradient {kname:20s} "
                    f"{n_out}x{n_in} d={d} float64 zero_diag={zd} (backward "
                    f"= launch on the swapped point sets) vs the plain "
                    f"version's autograd: rel {rel:.3e} (tol "
                    f"{KM_TOL['float64']:g}) {'ok' if ok else 'FAIL'}")
                check(ok, f"kernel_matvec x-gradient {kname}: rel {rel:.3e}")

    def flash_reading(self, shape, causal, dname, seed):
        """(max |k - p|, largest |k - p| / (atol + rtol |p|), all finite)
        of the kernel against its plain version on seeded inputs."""
        torch, fa = self.torch, self.fa
        q, k, v = self.flash_inputs(*shape, getattr(torch, dname), seed)
        k_out = fa.flash_attention(q, k, v, causal=causal).float()
        p_out = fa.flash_attention_plain(q, k, v, causal=causal).float()
        self.sync()
        atol, rtol = FLASH_TOL[dname]
        diff = (k_out - p_out).abs()
        share = float((diff / (atol + rtol * p_out.abs())).max())
        return float(diff.max()), share, bool(torch.isfinite(k_out).all())

    def phase_flash(self):
        log("[flash] flash_attention kernel vs plain: max |k - p|, and the "
            "largest share of the limit atol + rtol |p| (at most 1)")
        for i, (label, shape, causal, dname) in enumerate(self.flash_shapes()):
            err, share, finite = self.flash_reading(shape, causal, dname, i)
            ok = share <= 1.0 and finite
            atol, rtol = FLASH_TOL[dname]
            b, hq, hkv, sq, sk, dh = shape
            self.record["checks"].append({
                "kernel": "flash_attention", "label": label, "b": b,
                "hq": hq, "hkv": hkv, "sq": sq, "sk": sk, "dh": dh,
                "causal": causal, "dtype": dname, "max_abs_err": err,
                "limit_share": share, "atol": atol, "rtol": rtol, "ok": ok})
            log(f"[flash] {label:7s} b={b} hq={hq} hkv={hkv} sq={sq} sk={sk} "
                f"dh={dh} causal={causal} {dname}: max_abs_err={err:.3e}, "
                f"{share:.3f} of the limit (atol {atol:g}, rtol {rtol:g}) "
                f"{'ok' if ok else 'FAIL'}")
            check(ok, f"flash {label} {shape} causal={causal} {dname}: "
                  f"{err:.3e}, {share:.3f} of the limit")

    def phase_anchor(self):
        torch = self.torch
        pts, _ = self.spiral(N_ANCHOR, seed=0)
        pts = torch.as_tensor(pts, device=self.dev)
        lam_ref = torch.linalg.eigvalsh(
            self.fs.dense_normalized_adjacency(self.kernel, pts)).flip(0)[:K_EIG]
        self.anchor_points, self.anchor_lam = pts, lam_ref
        for name, tol in TIERS.items():
            op = self.fs.make_normalized_adjacency(self.kernel, pts,
                                                   self.setup(name),
                                                   device=self.dev)
            res = self.lan.eigsh(op.matvec, op.n, K_EIG, device=self.dev)
            err = float((res.eigenvalues - lam_ref).abs().max())
            self.record[f"anchor_{name}"] = err
            log(f"[anchor] n={N_ANCHOR} {name}: max eigenvalue error vs dense "
                f"eigvalsh = {err:.3e} (tier {tol:g})")
            check(err < tol, f"anchor {name}: {err:.3e} >= {tol:g}")

    def phase_main_path(self):
        torch, win = self.torch, self.win
        pts, labels = self.spiral(N_MAIN, seed=0)
        pts = torch.as_tensor(pts, device=self.dev)
        self.sync()
        self.reset_launches()
        t_start = time.perf_counter()
        for name in ("SETUP_2", "SETUP_3"):
            t0 = time.perf_counter()
            op = self.fs.make_normalized_adjacency(self.kernel, pts,
                                                   self.setup(name),
                                                   device=self.dev)
            self.sync()
            t_plan = time.perf_counter() - t0
            runs = {}
            for block in (1, 4):
                t0 = time.perf_counter()
                res = self.lan.eigsh(op.matvec, op.n, K_EIG, block_size=block,
                                     num_iters=BLOCK_ITERS.get(block),
                                     device=self.dev)
                self.sync()
                runs[block] = (res, time.perf_counter() - t0)
                check(bool(torch.isfinite(res.residual_bounds).all()),
                      f"{name} block={block}: non-finite residual bounds")
                log(f"[main] n={N_MAIN} {name} eigsh block={block}: "
                    f"{runs[block][1]:.3f}s, {res.num_matvecs} matvecs, "
                    f"max residual bound "
                    f"{float(res.residual_bounds.max()):.2e}, top "
                    f"{[round(v, 6) for v in res.eigenvalues[:3].tolist()]}")
            if name == "SETUP_3":  # [nystrom]'s reference at n = 10^5
                self.main_lam = runs[1][0].eigenvalues
            gap = float((runs[1][0].eigenvalues
                         - runs[4][0].eigenvalues).abs().max())
            self.record[f"main_{name}"] = {
                "plan_s": t_plan, "eigsh_s": runs[1][1],
                "eigsh_block4_s": runs[4][1],
                "matvecs": runs[1][0].num_matvecs,
                "matvecs_block4": runs[4][0].num_matvecs,
                "block_vs_single": gap}
            log(f"[main] n={N_MAIN} {name}: plan {t_plan:.3f}s, "
                f"|block - single| eigenvalues = {gap:.3e} "
                f"(tier {TIERS[name]:g})")
            check(gap <= TIERS[name], f"{name} block vs single: {gap:.3e}")
        t0 = time.perf_counter()
        op_sc = self.fs.make_normalized_adjacency(self.kernel, pts,
                                                  self.fs.SETUP_2,
                                                  device=self.dev)
        res = self.spec.spectral_clustering(
            op_sc, K_CLUSTERS,
            generator=torch.Generator(device=self.dev).manual_seed(1))
        self.sync()
        t_sc = time.perf_counter() - t0
        wall = time.perf_counter() - t_start
        self.launches = self.read_launches("main")
        agree = self.spec.clustering_agreement(
            labels, res.assignments.cpu().numpy(), K_CLUSTERS)
        check(res.assignments.shape == (op_sc.n,), "clustering shape")
        self.record["main_path"] = {"wall_s": wall, "clustering_s": t_sc,
                                    "agreement": agree,
                                    "launches": self.launches}
        log(f"[main] spectral_clustering k={K_CLUSTERS} SETUP_2: {t_sc:.3f}s, "
            f"agreement with true arms {agree:.3f}")
        log(f"[main] wall {wall:.3f}s (ends in synchronize); launches "
            f"{self.launches}")
        for kname in ("window_spread", "window_gather"):
            check(self.launches[kname] > 0,
                  f"{kname} never launched on the main path")

    def phase_guard(self):
        """Accuracy guard forced onto its direct floor, then eigsh on it."""
        torch, g = self.torch, self.guards
        pts, _ = self.spiral(N_GUARD, seed=0)
        pts = torch.as_tensor(pts, device=self.dev)
        policy = g.GuardPolicy(bound_tol=0.0, max_bandwidth=16,
                               direct_threshold=N_GUARD)
        self.sync()
        self.reset_launches()
        t0 = time.perf_counter()
        adj, report = g.guarded_normalized_adjacency(
            self.kernel, pts, self.fs.SETUP_1, policy=policy, device=self.dev)
        res = self.lan.eigsh(adj.matvec, adj.n, K_EIG, device=self.dev)
        self.sync()
        wall = time.perf_counter() - t0
        launches = self.read_launches("guard")
        check(report.fallback == "direct" and report.ok,
              f"guard did not settle on the direct floor: {report}")
        lam_ref = torch.linalg.eigvalsh(
            self.fs.dense_normalized_adjacency(self.kernel, pts)).flip(0)[:K_EIG]
        err = float((res.eigenvalues - lam_ref).abs().max())
        self.record["guard"] = {
            "n": N_GUARD, "wall_s": wall, "matvecs": res.num_matvecs,
            "attempts": [a.n_bandwidth for a in report.attempts],
            "bounds": [a.bound for a in report.attempts],
            "eig_err": err, "launches": launches}
        log(f"[guard] spiral n={N_GUARD}: attempts N="
            f"{[a.n_bandwidth for a in report.attempts]} (bounds "
            f"{[f'{a.bound:.3g}' for a in report.attempts]}) -> "
            f"{report.fallback}; eigsh k={K_EIG} {res.num_matvecs} matvecs, "
            f"{wall:.3f}s wall (guard + eigsh, ends in synchronize)")
        log(f"[guard] max eigenvalue error vs dense eigvalsh = {err:.3e} "
            f"(tol {GUARD_EIG_TOL:g}); launches {launches}")
        check(err <= GUARD_EIG_TOL, f"guard floor eigenvalues: {err:.3e}")
        check(launches["kernel_matvec"] >= res.num_matvecs + 1,
              f"guard floor: {launches['kernel_matvec']} kernel_matvec "
              f"launches for {res.num_matvecs} matvecs + 1 degree matvec")

    def phase_ssl(self):
        """Kernel SSL (I + beta L_s) u = f by CG at n = 10^5, and the fast
        operator's degrees against the exact direct sum."""
        torch, ssl = self.torch, self.ssl
        pts, labels = self.crescent(N_SSL, seed=0)
        pts = torch.as_tensor(pts, device=self.dev)
        kernel = self.make_kernel("gaussian", sigma=SSL_SIGMA)
        params = self.fs.FastsumParams(n_bandwidth=128, m=3, eps_b=0.0)
        self.sync()
        self.reset_launches()
        t0 = time.perf_counter()
        op = self.fs.make_normalized_adjacency(kernel, pts, params,
                                               device=self.dev)
        f, _ = ssl.make_training_vector(
            labels, SSL_SAMPLES, 2,
            generator=torch.Generator(device=self.dev).manual_seed(0),
            positive_class=1)
        res = ssl.kernel_ssl_cg(op, f, SSL_BETA, tol=SSL_TOL,
                                maxiter=SSL_MAXITER)
        self.sync()
        t_ssl = time.perf_counter() - t0
        exact = self.fs.direct_matvec_tiled(
            kernel, pts, torch.ones(N_SSL, dtype=pts.dtype, device=self.dev))
        self.sync()
        launches = self.read_launches("ssl")
        resid = float(torch.linalg.vector_norm(
            f - (res.u + SSL_BETA * op.laplacian_matvec(res.u))))
        tol_abs = SSL_TOL * max(float(torch.linalg.vector_norm(f)), 1.0)
        deg_rel = float((op.degrees - exact).abs().max() / exact.abs().max())
        mis = float(((res.u > 0).cpu().numpy().astype("int32")
                     != labels).mean())
        # one operator application of CG, beside CG's time per iteration
        matvec_ms = self.time_ms(lambda: op.laplacian_matvec(res.u), reps=20)
        self.record["ssl"] = {
            "n": N_SSL, "wall_s": t_ssl, "cg_iters": int(res.num_iters),
            "converged": bool(res.converged), "residual": resid,
            "tol_abs": tol_abs, "misclassification": mis,
            "degree_rel_err": deg_rel, "matvec_ms": matvec_ms,
            "launches": launches}
        log(f"[ssl] crescent-fullmoon n={N_SSL} gaussian sigma={SSL_SIGMA} "
            f"N=128 m=3, {SSL_SAMPLES}/class, beta={SSL_BETA:g}: "
            f"{t_ssl:.3f}s (plan + CG, ends in synchronize), CG "
            f"{int(res.num_iters)} iters, converged={bool(res.converged)}, "
            f"true residual {resid:.3e} (tol {tol_abs:.3e}), "
            f"misclassification {mis * 100:.2f}%; one Laplacian matvec "
            f"{matvec_ms:.3f} ms (CUDA events)")
        log(f"[ssl] fast vs exact degrees: rel {deg_rel:.3e} (JAX package "
            f"{JAX_SSL_DEGREE_REL:.3e}, limit {10 * JAX_SSL_DEGREE_REL:.3e}); "
            f"launches {launches}")
        check(bool(res.converged) and resid <= tol_abs,
              f"SSL CG: converged={bool(res.converged)} residual {resid:.3e}")
        check(deg_rel <= 10 * JAX_SSL_DEGREE_REL,
              f"SSL degrees vs exact: {deg_rel:.3e}")
        check(launches["kernel_matvec"] > 0, "SSL: kernel_matvec not launched")

    def phase_krr(self):
        """KRR fit by CG at n = 10^4, fast prediction against the direct
        kernel on 400 test points, for both of fig9's kernels."""
        torch, krr = self.torch, self.krr
        points, labels = self.crescent(N_KRR + N_KRR_TEST, seed=5)
        xtr = torch.as_tensor(points[:N_KRR], device=self.dev)
        ytr = torch.as_tensor(2.0 * labels[:N_KRR] - 1.0, device=self.dev)
        xte = torch.as_tensor(points[N_KRR:], device=self.dev)
        params = self.fs.FastsumParams(n_bandwidth=256, m=5, eps_b=None)
        self.record["krr"] = {}
        for kname, kern in (
                ("gaussian", self.make_kernel("gaussian", sigma=2.0)),
                ("inverse_multiquadric",
                 self.make_kernel("inverse_multiquadric", c=2.0))):
            self.sync()
            self.reset_launches()
            t0 = time.perf_counter()
            model = krr.krr_fit(kern, xtr, ytr, KRR_BETA, params,
                                tol=KRR_TOL, maxiter=KRR_MAXITER,
                                device=self.dev)
            self.sync()
            t_fit = time.perf_counter() - t0
            t0 = time.perf_counter()
            pred = krr.krr_predict(model, xte)
            self.sync()
            t_pred = time.perf_counter() - t0
            many = krr.krr_predict_many(model, [xte[:100], xte[100:]])
            t0 = time.perf_counter()
            direct = krr.krr_predict_direct(model, xte)
            self.sync()
            t_direct = time.perf_counter() - t0
            launches = self.read_launches(f"krr_{kname}")
            gram = self.fs.make_fastsum(kern, xtr, params, device=self.dev)
            resid = float(torch.linalg.vector_norm(
                ytr - (gram.matvec_tilde(model.alpha)
                       + KRR_BETA * model.alpha)))
            tol_abs = KRR_TOL * max(float(torch.linalg.vector_norm(ytr)), 1.0)
            rel = float((pred - direct).abs().max() / direct.abs().max())
            many_gap = float((torch.cat(many) - pred).abs().max())
            acc = float(((pred > 0).cpu().numpy() == (labels[N_KRR:] == 1))
                        .mean())
            # one Gram application of CG, beside CG's time per iteration
            matvec_ms = self.time_ms(lambda: gram.matvec_tilde(model.alpha),
                                     reps=20)
            limit = 10 * JAX_KRR_PREDICT_REL[kname]
            self.record["krr"][kname] = {
                "n": N_KRR, "n_test": N_KRR_TEST, "fit_s": t_fit,
                "predict_s": t_pred, "direct_s": t_direct,
                "cg_iters": int(model.num_iters),
                "converged": bool(model.converged), "residual": resid,
                "tol_abs": tol_abs, "predict_rel_err": rel,
                "jax_predict_rel_err": JAX_KRR_PREDICT_REL[kname],
                "accuracy": acc, "matvec_ms": matvec_ms,
                "launches": launches}
            log(f"[krr] {kname} n={N_KRR} N=256 m=5 beta={KRR_BETA:g}: fit "
                f"{t_fit:.3f}s, CG {int(model.num_iters)} iters, converged="
                f"{bool(model.converged)}, true residual {resid:.3e} (tol "
                f"{tol_abs:.3e}); predict {N_KRR_TEST} pts {t_pred:.4f}s, "
                f"direct {t_direct:.4f}s; test accuracy {acc:.4f}; one Gram "
                f"matvec {matvec_ms:.3f} ms (CUDA events)")
            log(f"[krr] {kname} fast vs direct prediction: rel {rel:.3e} "
                f"(JAX package {JAX_KRR_PREDICT_REL[kname]:.3e}, limit "
                f"{limit:.3e}); predict_many gap {many_gap:.1e}; launches "
                f"{launches}")
            check(bool(model.converged) and resid <= tol_abs,
                  f"KRR {kname} CG: converged={bool(model.converged)} "
                  f"residual {resid:.3e}")
            check(rel <= limit, f"KRR {kname} fast vs direct: {rel:.3e}")
            check(many_gap <= 1e-12 * float(pred.abs().max()),
                  f"KRR {kname} predict_many vs predict: {many_gap:.3e}")
            check(launches["kernel_matvec"] > 0,
                  f"KRR {kname}: kernel_matvec not launched")

    # -- [grad] -------------------------------------------------------------
    def grad_pass(self, path, loss_fn, leaves):
        """One value-and-grad on the card: the forward's launches counted as
        ``path``, the backward's as ``path + "_backward"``.  Returns (loss,
        grads, forward launches, backward launches)."""
        torch = self.torch
        self.sync()
        self.reset_launches()
        loss = loss_fn()
        self.sync()
        fwd = self.read_launches(path)
        self.reset_launches()
        grads = torch.autograd.grad(loss, leaves)
        self.sync()
        return loss, grads, fwd, self.read_launches(f"{path}_backward")

    def grad_one_each(self, fwd, bwd, what):
        """Exactly one spread and one gather launch in each direction."""
        for direction, got in (("forward", fwd), ("backward", bwd)):
            pair = (got["window_spread"], got["window_gather"])
            check(pair == (1, 1), f"{what} {direction}: {pair} spread/gather "
                  "launches, not 1/1")

    def grad_records(self, path, label, plan, src, tgt, c_out, c_in=1):
        """The window kernels of one [grad] pass at their shapes: the
        forward's spread (sources, ``c_in`` columns) and gather (targets,
        ``c_out``), the backward's spread (targets, ``c_out``) and gather
        (sources, ``c_in``)."""
        self.window_path_record(path, f"{label}, sources", plan, src, c_in,
                                ("spread",))
        self.window_path_record(path, f"{label}, targets", plan, tgt, c_out,
                                ("gather",))
        back = f"{path}_backward"
        self.window_path_record(back, f"{label}, targets", plan, tgt, c_out,
                                ("spread",))
        self.window_path_record(back, f"{label}, sources", plan, src, c_in,
                                ("gather",))

    def grad_param(self, value):
        return self.torch.tensor(float(value), dtype=self.torch.float64,
                                 device=self.dev, requires_grad=True)

    def grad_loss(self, op, kname, p, x, w):
        """<w, W x> (square) or <w, W~ x> (rectangular) of ``op`` re-spectralized
        for the kernel ``kname`` with parameter ``p``."""
        o = op.with_kernel(self.kernel_from_param(kname, p))
        out = o.matvec(x) if o.scaled_tgt is None else o.matvec_tilde(x)
        return self.torch.dot(w, out)

    def grad_operator(self, path, what, op, kname, p0, n_out=None,
                      dense=None):
        """The parameter's gradient against a central difference, one
        spread and one gather launch each way, and the forward loss and
        value-and-grad times.  The difference is of the card's own forward
        (step 1e-5 p0, GRAD_FD_TOL), or ``dense(x, w)``'s, computed within
        the counted forward pass (GRAD_ORACLE_TOL).  Returns (x, w, x-bar,
        row)."""
        torch = self.torch
        n = op.n_source
        gen = torch.Generator(device=self.dev).manual_seed(n)
        x = torch.randn(n, generator=gen, dtype=torch.float64, device=self.dev)
        w = torch.randn(n_out or n, generator=gen, dtype=torch.float64,
                        device=self.dev)
        p, xl = self.grad_param(p0), x.clone().requires_grad_(True)
        fd = []

        def forward():
            if dense is not None:
                fd.append(dense(x, w))
            return self.grad_loss(op, kname, p, xl, w)

        _, (g_p, g_x), fwd, bwd = self.grad_pass(path, forward, (p, xl))
        self.grad_one_each(fwd, bwd, what)
        if dense is None:
            eps = 1e-5 * p0
            with torch.no_grad():
                fd.append((float(self.grad_loss(op, kname, p0 + eps, x, w))
                           - float(self.grad_loss(op, kname, p0 - eps, x,
                                                  w))) / (2 * eps))
        fd, tol = fd[0], GRAD_FD_TOL if dense is None else GRAD_ORACLE_TOL
        rel_p = abs(float(g_p) - fd) / abs(fd)
        fwd_ms = self.host_ms(lambda: self.grad_no_grad(op, kname, p, x, w),
                              reps=10)
        vag_ms = self.host_ms(lambda: torch.autograd.grad(
            self.grad_loss(op, kname, p, xl, w), (p, xl)), reps=10)
        with torch.no_grad():  # the forward's re-spectralization alone
            spec_ms = self.host_ms(lambda: op.with_kernel(
                self.kernel_from_param(kname, p)), reps=10)
        row = {"n": n, "n_out": n_out or n, "what": what,
               "param_grad": float(g_p), "fd": fd, "param_rel": rel_p,
               "forward_ms": fwd_ms, "with_kernel_ms": spec_ms,
               "value_and_grad_ms": vag_ms, "ratio": vag_ms / fwd_ms,
               "launches": {"forward": fwd, "backward": bwd}}
        log(f"[grad] {what}: d loss / d {self.param_name[kname]} "
            f"{float(g_p):.10e}, central difference"
            f"{' of the direct sum (kernel_matvec)' if dense else ''} "
            f"{fd:.10e}, rel {rel_p:.3e} (tol {tol:g}); forward loss "
            f"{fwd_ms:.3f} ms (with_kernel {spec_ms:.3f} of it), "
            f"value-and-grad {vag_ms:.3f} ms "
            f"({vag_ms / fwd_ms:.2f}x; BENCH_grad.json's CPU target "
            f"{BENCH_GRAD_RATIO}x; host clock ending in synchronize); one "
            "spread + one gather each way")
        check(rel_p <= tol, f"{what} parameter gradient vs central "
              f"difference: rel {rel_p:.3e}")
        return x, w, g_x, row

    def grad_no_grad(self, op, kname, p, x, w):
        with self.torch.no_grad():
            return self.grad_loss(op, kname, p, x, w)

    def grad_x_check(self, g_x, ref, what, ref_name):
        rel = float((g_x - ref).abs().max() / g_x.abs().max())
        log(f"[grad] {what}: x-bar vs {ref_name} rel {rel:.3e} "
            f"(tol {GRAD_X_TOL:g}, of max |x-bar|)")
        check(rel <= GRAD_X_TOL, f"{what} x-bar: rel {rel:.3e}")
        return rel

    def phase_grad(self):
        """Gradients on the card through the public entry points, float64:
        the main path's operator at n = 10^5 (SETUP_2, SETUP_3), [krr]'s
        rectangular operator, the dense oracle at n = 10^4, a broadcast
        bank of four, and KRR model selection."""
        torch, fs = self.torch, self.fs
        self.record["grad"] = {}
        pts, _ = self.spiral(N_MAIN, seed=0)
        pts = torch.as_tensor(pts, device=self.dev)
        for name in ("SETUP_2", "SETUP_3"):
            op = fs.make_fastsum(self.kernel, pts, self.setup(name),
                                 device=self.dev)
            path = f"grad_{name}"
            x, w, g_x, row = self.grad_operator(
                path, f"spiral n={N_MAIN} {name}", op, "gaussian", SIGMA)
            row["x_rel"] = self.grad_x_check(g_x, op.matvec(w),
                                             f"spiral n={N_MAIN} {name}",
                                             "the forward matvec of w")
            self.record["grad"][path] = row
            self.grad_records(path, f"spiral {name}", op.plan, op.src_window,
                              op.src_window, 1)
        self.grad_rectangular()
        self.grad_oracle()
        self.grad_bank(pts)
        self.grad_krr()

    def krr_data(self):
        """[krr]'s crescent-fullmoon: training points and +-1 labels, test
        points and labels, its FastsumParams."""
        torch = self.torch
        points, labels = self.crescent(N_KRR + N_KRR_TEST, seed=5)
        y = torch.as_tensor(2.0 * labels - 1.0, device=self.dev)
        pts = torch.as_tensor(points, device=self.dev)
        return (pts[:N_KRR], y[:N_KRR], pts[N_KRR:], y[N_KRR:],
                self.fs.FastsumParams(n_bandwidth=256, m=5, eps_b=None))

    def grad_rectangular(self):
        """[krr]'s train -> test operator: x-bar against the operator with
        sources and targets swapped (the backward's spread runs on the
        400-row target geometry)."""
        fs = self.fs
        xtr, _, xte, _, params = self.krr_data()
        kern = self.make_kernel("gaussian", sigma=2.0)
        op = fs.make_fastsum(kern, xtr, params, target_points=xte,
                             device=self.dev)
        swapped = fs.make_fastsum(kern, xte, params, target_points=xtr,
                                  device=self.dev)
        check(swapped.rho == op.rho, "swapped operator: another rho")
        what = f"crescent {N_KRR} -> {N_KRR_TEST} N=256 m=5"
        op.tgt_window.tiles  # the target's tile plan, outside the timing
        x, w, g_x, row = self.grad_operator("grad_rect", what, op,
                                            "gaussian", 2.0,
                                            n_out=N_KRR_TEST)
        row["x_rel"] = self.grad_x_check(
            g_x, swapped.matvec_tilde(w), what,
            "the operator with sources and targets swapped")
        self.record["grad"]["grad_rect"] = row
        self.grad_records("grad_rect", "crescent N=256 m=5", op.plan,
                          op.src_window, op.tgt_window, 1)

    def grad_oracle(self):
        """The fused W's sigma-gradient at n = 10^4 against a central
        difference of the direct sum (kernel_matvec, two launches)."""
        torch, fs = self.torch, self.fs
        n = GRAD_ORACLE_N
        pts, _ = self.spiral(n, seed=0)
        pts = torch.as_tensor(pts, device=self.dev)
        op = fs.make_fastsum(self.kernel, pts, fs.SETUP_2, device=self.dev)
        what = f"spiral n={n} SETUP_2"
        eps = 1e-4

        def dense(x, w):
            at = [float(torch.dot(w, fs.direct_matvec_tiled(
                self.make_kernel("gaussian", sigma=s), pts, x)))
                for s in (SIGMA + eps, SIGMA - eps)]
            return (at[0] - at[1]) / (2 * eps)

        x, w, g_x, row = self.grad_operator("grad_oracle", what, op,
                                            "gaussian", SIGMA, dense=dense)
        got = row["launches"]["forward"]["kernel_matvec"]
        check(got == 2, f"oracle: {got} kernel_matvec launches, not 2")
        row["x_rel"] = self.grad_x_check(g_x, op.matvec(w), what,
                                         "the forward matvec of w")
        self.record["grad"]["grad_oracle"] = row
        self.grad_records("grad_oracle", what, op.plan, op.src_window,
                          op.src_window, 1)

    def grad_bank(self, pts):
        """A broadcast bank of [bank]'s four Gaussians at n = 10^5 (SETUP_2):
        each member's sigma-bar against a central difference of the bank's
        own loss, x-bar against the members' matvecs of their w."""
        torch, fs = self.torch, self.fs
        s_n, n = len(BANK_SIGMAS), N_MAIN
        gen = torch.Generator(device=self.dev).manual_seed(12)
        x = torch.randn(n, generator=gen, dtype=torch.float64, device=self.dev)
        w = torch.randn((s_n, n), generator=gen, dtype=torch.float64,
                        device=self.dev)

        def bank_of(sigmas):
            return fs.make_fastsum_bank(
                [self.make_kernel("gaussian", sigma=s) for s in sigmas], pts,
                fs.SETUP_2, device=self.dev)

        ps = [self.grad_param(s) for s in BANK_SIGMAS]
        xl = x.clone().requires_grad_(True)
        bank = bank_of(ps)
        _, grads, fwd, bwd = self.grad_pass(
            "grad_bank", lambda: (w * bank.matvec(xl)).sum(), ps + [xl])
        self.grad_one_each(fwd, bwd, "bank")
        eps = 1e-5 * SIGMA
        rels = []
        with torch.no_grad():
            for i, s in enumerate(BANK_SIGMAS):
                loss = [float((w * bank_of(
                    [v + (sign * eps if j == i else 0.0)
                     for j, v in enumerate(BANK_SIGMAS)]).matvec(x)).sum())
                        for sign in (1, -1)]
                fd = (loss[0] - loss[1]) / (2 * eps)
                rels.append(abs(float(grads[i]) - fd) / abs(fd))
            ref = bank_of(BANK_SIGMAS).matvec(w[:, :, None])[..., 0].sum(0)
        what = f"bank S={s_n} broadcast, spiral n={n} SETUP_2"
        x_rel = self.grad_x_check(grads[-1], ref, what,
                                  "the sum of the members' matvecs of w")
        self.record["grad"]["grad_bank"] = {
            "n": n, "S": s_n, "sigmas": BANK_SIGMAS,
            "param_grads": [float(g) for g in grads[:-1]], "param_rel": rels,
            "x_rel": x_rel, "launches": {"forward": fwd, "backward": bwd}}
        log(f"[grad] {what}: each member's d loss / d sigma vs a central "
            f"difference of the bank's loss, rel "
            f"{[f'{r:.2e}' for r in rels]} (tol {GRAD_FD_TOL:g}); one spread "
            "+ one gather each way")
        check(max(rels) <= GRAD_FD_TOL, f"bank sigma-bar: rel {max(rels):.3e}")
        self.grad_records("grad_bank", "spiral SETUP_2", bank.plan,
                          bank.src_window, bank.src_window, s_n)

    def grad_krr(self):
        """KRR model selection at [krr]'s data (Gaussian and inverse
        multiquadric, parameter 2, beta KRR_BETA): krr_validation_loss's
        (log sigma, log beta) gradients against Richardson central
        differences and their cost beside the loss's; then, on the inverse
        multiquadric, a poisoned training vector and krr_fit_grad."""
        data = self.krr_data()
        for kname in ("gaussian", "inverse_multiquadric"):
            ops = self.krr_grad_check(kname, *data)
        self.krr_grad_poisoned(kname, ops, *data)
        self.krr_grad_fit(kname, *data)

    def krr_loss(self, kname, ops, y_train, y_val, ls, lb):
        gram, pred = ops
        return self.krr.krr_validation_loss(
            kname, gram, pred, y_train, y_val, ls, lb, tol=GRAD_KRR_TOL,
            maxiter=KRR_MAXITER)

    def krr_grad_check(self, kname, xtr, ytr, xte, yte, params):
        """Returns the (Gram, prediction) operators of ``kname``."""
        torch, fs = self.torch, self.fs
        kern = self.kernel_from_param(kname, 2.0)
        ops = (fs.make_fastsum(kern, xtr, params, device=self.dev),
               fs.make_fastsum(kern, xtr, params, target_points=xte,
                               device=self.dev))
        ls0, lb0 = float(np.log(2.0)), float(np.log(KRR_BETA))
        a, b = self.grad_param(ls0), self.grad_param(lb0)
        path = f"grad_krr_{kname}"
        self.sync()
        self.reset_launches()
        t0 = time.perf_counter()
        g_ls, g_lb = torch.autograd.grad(
            self.krr_loss(kname, ops, ytr, yte, a, b), (a, b))
        self.sync()
        vag_s = time.perf_counter() - t0
        launches = self.read_launches(path)

        def loss(ls, lb):
            with torch.no_grad():
                return float(self.krr_loss(kname, ops, ytr, yte, ls, lb))

        t0 = time.perf_counter()
        val = loss(ls0, lb0)
        loss_s = time.perf_counter() - t0
        h = GRAD_KRR_H
        rels = [abs(float(g) - fd) / max(abs(fd), 1e-30) for g, fd in (
            (g_ls, richardson(lambda v: loss(v, lb0), ls0, h)),
            (g_lb, richardson(lambda v: loss(ls0, v), lb0, h)))]
        self.record["grad"][path] = {
            "n": N_KRR, "n_val": N_KRR_TEST, "loss": val,
            "grads": [float(g_ls), float(g_lb)], "rel": rels,
            "loss_s": loss_s, "value_and_grad_s": vag_s,
            "ratio": vag_s / loss_s, "launches": launches}
        log(f"[grad] krr_validation_loss {kname} n={N_KRR} val={N_KRR_TEST}: "
            f"loss {val:.6e}, d/d log {self.param_name[kname]} "
            f"{float(g_ls):.8e}, d/d log beta {float(g_lb):.8e}; vs "
            f"Richardson central differences (h={h:g}) rel {rels[0]:.2e} / "
            f"{rels[1]:.2e} (tol {GRAD_KRR_FD_TOL:g}); loss {loss_s:.3f}s, "
            f"value-and-grad {vag_s:.3f}s ({vag_s / loss_s:.2f}x; host clock "
            f"ending in synchronize); launches {launches}")
        check(max(rels) <= GRAD_KRR_FD_TOL,
              f"KRR {kname} gradients vs Richardson: {rels}")
        self.window_path_record(
            path, f"crescent N=256 m=5, {N_KRR} training rows (one launch "
            f"each on the {N_KRR_TEST} validation rows)", ops[0].plan,
            ops[0].src_window, 1, ("spread", "gather"))
        return ops

    def krr_grad_poisoned(self, kname, ops, xtr, ytr, xte, yte, params):
        """A NaN in the training vector quarantines the solve: the
        gradients are finite and exactly zero."""
        torch = self.torch
        bad = ytr.clone()
        bad[5] = float("nan")
        a = self.grad_param(np.log(2.0))
        b = self.grad_param(np.log(KRR_BETA))
        self.sync()
        self.reset_launches()
        g = torch.autograd.grad(self.krr_loss(kname, ops, bad, yte, a, b),
                                (a, b))
        self.sync()
        self.read_launches("grad_krr_poisoned")
        g = [float(v) for v in g]
        log(f"[grad] poisoned training vector ({kname}): gradients {g}")
        check(all(v == 0.0 for v in g), f"poisoned KRR gradients: {g}")
        self.window_path_record(
            "grad_krr_poisoned", f"crescent N=256 m=5, {N_KRR} training "
            "rows", ops[0].plan, ops[0].src_window, 1, ("spread", "gather"))

    def krr_grad_fit(self, kname, xtr, ytr, xte, yte, params):
        """GRAD_FIT_STEPS Adam steps of krr_fit_grad (lr 0.1, CG tol
        KRR_TOL): the best validation loss must not exceed the first."""
        fs = self.fs
        self.sync()
        self.reset_launches()
        t0 = time.perf_counter()
        res = self.krr.krr_fit_grad(
            kname, xtr, ytr, xte, yte, params, init_sigma=2.0,
            init_beta=KRR_BETA, steps=GRAD_FIT_STEPS, lr=0.1, tol=KRR_TOL,
            maxiter=KRR_MAXITER, device=self.dev)
        self.sync()
        fit_s = time.perf_counter() - t0
        launches = self.read_launches("grad_krr_fit")
        path = [float(v) for v in res.loss_path]
        self.record["grad"]["grad_krr_fit"] = {
            "kernel": kname, "steps": GRAD_FIT_STEPS, "loss_path": path,
            "param": res.sigma, "beta": res.beta, "s": fit_s,
            "launches": launches}
        log(f"[grad] krr_fit_grad {kname} {GRAD_FIT_STEPS} steps: loss "
            f"{path[0]:.6e} -> best {res.val_loss:.6e} at "
            f"{self.param_name[kname]}={res.sigma:.4g}, beta={res.beta:.3g}; "
            f"{fit_s:.2f}s (host clock, the refit included); launches "
            f"{launches}")
        check(all(np.isfinite(path)) and res.val_loss <= path[0],
              f"krr_fit_grad: best {res.val_loss} vs start {path[0]}")
        gram = fs.make_fastsum(self.kernel_from_param(kname, 2.0), xtr,
                               params, device=self.dev)
        self.window_path_record(
            "grad_krr_fit", f"crescent N=256 m=5, {N_KRR} training rows "
            f"(one launch each on the {N_KRR_TEST} validation rows a step)",
            gram.plan, gram.src_window, 1, ("spread", "gather"))

    def phase_direct(self):
        """The paper's direct baseline at the main path's n = 10^5, d = 3,
        against the fused matvec of both setups."""
        torch = self.torch
        pts, _ = self.spiral(N_MAIN, seed=0)
        pts = torch.as_tensor(pts, device=self.dev)
        x = torch.as_tensor(np.random.default_rng(0).normal(size=N_MAIN),
                            device=self.dev)
        self.sync()
        self.reset_launches()
        t0 = time.perf_counter()
        exact = self.fs.direct_matvec_tiled(self.kernel, pts, x)
        self.sync()
        wall = time.perf_counter() - t0
        launches = self.read_launches("direct")
        row = {"n": N_MAIN, "wall_s": wall, "launches": launches}
        for name in ("SETUP_2", "SETUP_3"):
            op = self.fs.make_fastsum(self.kernel, pts, self.setup(name),
                                      device=self.dev)
            row[f"fused_rel_err_{name}"] = float(
                (op.matvec(x) - exact).abs().max() / exact.abs().max())
        self.record["direct"] = row
        log(f"[direct] direct_matvec_tiled n={N_MAIN} d=3 float64: {wall:.4f}s "
            f"(one call, ends in synchronize); launches {launches}")
        check(bool(torch.isfinite(exact).all()), "direct: non-finite output")
        for name, want in JAX_DIRECT_REL.items():
            got = row[f"fused_rel_err_{name}"]
            log(f"[direct] fused matvec {name} vs exact: rel {got:.3e} (JAX "
                f"package {want:.3e}, limit {10 * want:.3e})")
            check(got <= 10 * want, f"fused {name} vs exact: {got:.3e}")
        check(launches["kernel_matvec"] == 1, "direct: kernel_matvec launches")

    def phase_oracle(self):
        """The fused matvec (the window kernels) against the two-NFFT
        reference (flat geometry, index_add_, cuFFT; no hand-written
        kernel) at n = 10^5, spiral, SETUP_2."""
        torch = self.torch
        pts, _ = self.spiral(N_MAIN, seed=0)
        pts = torch.as_tensor(pts, device=self.dev)
        op = self.fs.make_fastsum(self.kernel, pts, self.fs.SETUP_2,
                                  device=self.dev)
        taps = op.plan.taps
        # flat geometry: int64 indices + float64 weights, n x taps^3 each
        geom_gb = N_MAIN * taps ** 3 * 16 / 1e9
        self.sync()
        torch.cuda.reset_peak_memory_stats(self.dev)
        t0 = time.perf_counter()
        geom = op.src_geometry
        self.sync()
        t_geom = time.perf_counter() - t0
        self.record["oracle"] = {"n": N_MAIN, "setup": "SETUP_2",
                                 "taps_cubed": taps ** 3,
                                 "flat_geometry_gb": geom_gb,
                                 "geometry_s": t_geom, "runs": []}
        log(f"[oracle] n={N_MAIN} spiral SETUP_2: flat geometry "
            f"({N_MAIN} x {taps ** 3} int64 indices + float64 weights, "
            f"{geom_gb:.2f} GB reckoned, {geom.indices.numel() * 16 / 1e9:.2f}"
            f" GB held) built in {t_geom:.3f}s")
        for c in ORACLE_COLUMNS:
            gen = torch.Generator(device=self.dev).manual_seed(c)
            x = torch.randn((N_MAIN, c), generator=gen, dtype=torch.float64,
                            device=self.dev)
            self.sync()
            self.reset_launches()
            fused = op.matvec_tilde(x)
            self.sync()
            launches = self.read_launches(f"oracle_c{c}")
            t0 = time.perf_counter()
            ref = op.matvec_tilde_reference(x)
            self.sync()
            t_ref = time.perf_counter() - t0
            check(self.win.window_spread.launches == launches["window_spread"],
                  "the two-NFFT reference launched a window kernel")
            rel = float((fused - ref).abs().max() / ref.abs().max())
            peak = torch.cuda.max_memory_allocated(self.dev) / 1e9
            self.record["oracle"]["runs"].append({
                "c": c, "rel_err": rel, "tol": ORACLE_TOL,
                "reference_s": t_ref, "peak_memory_gb": peak,
                "launches": launches})
            log(f"[oracle] C={c}: fused matvec_tilde vs two-NFFT reference "
                f"rel {rel:.3e} of max|ref| (tol {ORACLE_TOL:g}); reference "
                f"{t_ref:.3f}s; peak memory {peak:.2f} GB; fused launches "
                f"{launches}")
            check(launches["window_spread"] == 1
                  and launches["window_gather"] == 1,
                  f"oracle C={c}: fused matvec launches {launches}")
            check(rel <= ORACLE_TOL, f"oracle C={c}: rel {rel:.3e}")
            del fused, ref
        del op, geom

    def nystrom_run(self, method, adj, points, l_size, rank, seed):
        """One Nyström run; (result, seconds, spread launches, gather
        launches, GB the run allocated at its peak above what was held
        before it).  Launch counts are read as differences, so the path's
        totals keep running."""
        torch = self.torch
        gen = torch.Generator(device=self.dev).manual_seed(seed)
        spread0 = self.win.window_spread.launches
        gather0 = self.win.window_gather.launches
        self.sync()
        torch.cuda.reset_peak_memory_stats(self.dev)
        held = torch.cuda.memory_allocated(self.dev)
        t0 = time.perf_counter()
        if method == "hybrid":
            res = self.nys.nystrom_gaussian_nfft(adj, K_EIG,
                                                 num_columns=l_size,
                                                 rank=rank, generator=gen)
        else:
            res = self.nys.nystrom_traditional(self.kernel, points, K_EIG,
                                               l_size, generator=gen)
        self.sync()
        took = time.perf_counter() - t0
        return (res, took, self.win.window_spread.launches - spread0,
                self.win.window_gather.launches - gather0,
                (torch.cuda.max_memory_allocated(self.dev) - held) / 1e9)

    def phase_nystrom(self):
        """Traditional and hybrid Nyström (paper Section 5), float64: the
        tiers of tests/test_nystrom.py at n = 4000 against dense eigvalsh,
        then n = 10^5 against [main]'s SETUP_3 eigsh."""
        torch = self.torch
        self.record["nystrom"] = []
        pts = self.anchor_points
        adj = self.fs.make_normalized_adjacency(self.kernel, pts,
                                                self.fs.SETUP_2,
                                                device=self.dev)
        self.reset_launches()
        errs = {}
        for method, l_size, rank, seed, tier in NYS_ANCHOR_RUNS:
            res, took, n_spread, n_gather, peak = self.nystrom_run(
                method, adj, pts, l_size, rank, seed)
            err = float((res.eigenvalues - self.anchor_lam).abs().max())
            top = float(res.eigenvalues.abs().max())
            errs[(method, l_size, rank)] = err
            self.record["nystrom"].append({
                "n": N_ANCHOR, "method": method, "L": l_size, "rank": rank,
                "seed": seed, "eig_err": err, "max_abs_eig": top,
                "tier": tier, "s": took, "run_peak_memory_gb": peak,
                "window_launches": [n_spread, n_gather]})
            log(f"[nystrom] n={N_ANCHOR} {method} L={l_size} rank={rank} "
                f"seed {seed}: max eigenvalue error vs dense eigvalsh "
                f"{err:.3e} (tier {tier}), max|lambda| {top:.6f}, "
                f"{took:.3f}s, "
                f"run's peak {peak:.3f} GB, spread/gather launches "
                f"{n_spread}/{n_gather}")
            if tier is not None:
                check(err < tier, f"nystrom n={N_ANCHOR} {method} "
                      f"L={l_size}: {err:.3e} >= {tier:g}")
            if method == "hybrid":
                check(top <= NYS_MAX_ABS_EIG, f"nystrom n={N_ANCHOR} hybrid "
                      f"L={l_size} rank={rank}: max|lambda| {top}")
        hybrid = errs[("hybrid", 50, 10)]
        log(f"[nystrom] n={N_ANCHOR}: hybrid L=50 {hybrid:.3e} against "
            f"traditional L=50 {errs[('traditional', 50, None)]:.3e} and "
            f"L=n/10 {errs[('traditional', N_ANCHOR // 10, None)]:.3e}")
        check(hybrid < errs[("traditional", 50, None)],
              "hybrid L=50 does not beat traditional L=50")
        self.read_launches("nystrom_anchor")

        # tests/test_nystrom.py's own problem for hybrid vs traditional
        small, _ = self.spiral(NYS_SMALL_N, seed=NYS_SMALL_SEED)
        small = torch.as_tensor(small, device=self.dev)
        lam_small = torch.linalg.eigvalsh(
            self.fs.dense_normalized_adjacency(self.kernel, small)
        ).flip(0)[:K_EIG]
        adj_small = self.fs.make_normalized_adjacency(
            self.kernel, small, self.fs.SETUP_2, device=self.dev)
        err_h = float((self.nystrom_run("hybrid", adj_small, small, 50, K_EIG,
                                        1)[0].eigenvalues
                       - lam_small).abs().max())
        err_t = float((self.nystrom_run("traditional", None, small,
                                        NYS_SMALL_N // 10, None, 2)[0]
                       .eigenvalues - lam_small).abs().max())
        self.record["nystrom_small"] = {"n": NYS_SMALL_N, "hybrid_L50": err_h,
                                        "traditional_L_n10": err_t}
        log(f"[nystrom] n={NYS_SMALL_N} (spiral seed {NYS_SMALL_SEED}): "
            f"hybrid L=50 {err_h:.3e} (tier 1e-2) against traditional "
            f"L=n/10 {err_t:.3e}")
        check(err_h < 1e-2 and err_h < err_t,
              f"n={NYS_SMALL_N}: hybrid L=50 {err_h:.3e}, traditional "
              f"L=n/10 {err_t:.3e}")

        pts, _ = self.spiral(N_MAIN, seed=0)
        pts = torch.as_tensor(pts, device=self.dev)
        adj = self.fs.make_normalized_adjacency(self.kernel, pts,
                                                self.fs.SETUP_2,
                                                device=self.dev)
        self.sync()
        self.reset_launches()
        for l_size in NYS_COLUMNS:
            res, took, n_spread, n_gather, peak = self.nystrom_run(
                "hybrid", adj, pts, l_size, K_EIG, l_size)
            self.nystrom_row(res, took, n_spread, n_gather, peak, "hybrid",
                             l_size)
            check(n_spread >= 2 and n_gather >= 2,
                  f"hybrid L={l_size}: {n_spread} spread, {n_gather} gather "
                  "launches")
            check(bool(torch.isfinite(res.eigenvalues).all())
                  and bool(torch.isfinite(res.eigenvectors).all()),
                  f"hybrid L={l_size}: non-finite result")
            check(float(res.eigenvalues.abs().max()) <= NYS_MAX_ABS_EIG,
                  f"hybrid L={l_size}: max|lambda| "
                  f"{float(res.eigenvalues.abs().max())}")
            check(res.eigenvectors.shape == (N_MAIN, K_EIG),
                  "hybrid eigenvector shape")
        self.read_launches("nystrom")
        del adj
        res, took, _, _, peak = self.nystrom_run(
            "traditional", None, pts, NYS_TRAD_L, None, 0)
        self.nystrom_row(res, took, 0, 0, peak, "traditional", NYS_TRAD_L)
        check(res.eigenvectors.shape == (N_MAIN, K_EIG),
              "traditional eigenvector shape")

    def nystrom_row(self, res, took, n_spread, n_gather, peak, method,
                    l_size):
        err = float((res.eigenvalues - self.main_lam).abs().max())
        self.record["nystrom"].append({
            "n": N_MAIN, "method": method, "L": l_size, "rank": K_EIG,
            "eig_err": err, "max_abs_eig": float(res.eigenvalues.abs().max()),
            "s": took, "run_peak_memory_gb": peak,
            "window_launches": [n_spread, n_gather],
            "device": self.record["device"]["nvidia_smi"]})
        log(f"[nystrom] n={N_MAIN} {method} L={l_size} rank={K_EIG}: max "
            f"eigenvalue error vs [main] SETUP_3 eigsh {err:.3e}, "
            f"{took:.3f}s (host clock, ends in synchronize), the run's peak "
            f"{peak:.2f} GB (max_memory_allocated above what it found held), "
            f"spread/gather launches "
            f"{n_spread}/{n_gather}; {self.record['device']['nvidia_smi']}")

    def phase_segment(self):
        """Image segmentation (paper Section 6.2.1) at the photograph's
        426,400 pixels: spectral_clustering at k = 2 and 4."""
        torch = self.torch
        pixels = torch.as_tensor(self.segment_pixels(), device=self.dev)
        kernel = self.make_kernel("gaussian", sigma=SEG_SIGMA)
        self.sync()
        self.reset_launches()
        t0 = time.perf_counter()
        op = self.fs.make_normalized_adjacency(kernel, pixels,
                                               self.setup("SEG"),
                                               device=self.dev)
        self.sync()
        t_plan = time.perf_counter() - t0
        row = {"n": N_SEG, "height": SEG_H, "width": SEG_W,
               "plan_s": t_plan, "runs": {}}
        limit = 10 * JAX_SEG_LAMBDA1_ERR
        for k in SEG_K:
            t0 = time.perf_counter()
            gen = torch.Generator(device=self.dev).manual_seed(0)
            res = self.spec.spectral_clustering(op, k, generator=gen)
            self.sync()
            took = time.perf_counter() - t0
            lam1 = abs(float(res.eigenvalues[0]) - 1.0)
            agree = self.spec.clustering_agreement(
                self.segment_truth, res.assignments.cpu().numpy(), k)
            row["runs"][k] = {"s": took, "lambda1_err": lam1,
                              "agreement": agree,
                              "eigenvalues": res.eigenvalues.tolist()}
            log(f"[segment] {SEG_H}x{SEG_W} = {N_SEG} pixels, sigma="
                f"{SEG_SIGMA:g}, N=16 m=2 p=2 eps_B=1/8, k={k}: "
                f"spectral_clustering {took:.3f}s (ends in synchronize), "
                f"agreement with the truth regions {agree:.4f}, "
                f"|lambda_1 - 1| = {lam1:.3e} (JAX package "
                f"{JAX_SEG_LAMBDA1_ERR:.3e} on 100x150, limit {limit:.3e}), "
                f"eigenvalues "
                f"{[round(v, 6) for v in res.eigenvalues.tolist()]}")
            check(res.assignments.shape == (N_SEG,), "segment: shape")
            check(bool(torch.isfinite(res.eigenvalues).all()),
                  f"segment k={k}: non-finite eigenvalues")
            check(lam1 <= limit, f"segment k={k}: |lambda_1 - 1| {lam1:.3e}")
        row["launches"] = self.read_launches("segment")
        self.record["segment"] = row
        log(f"[segment] plan {t_plan:.3f}s; launches {row['launches']}; "
            f"{self.record['device']['nvidia_smi']}")
        for kname in ("window_spread", "window_gather"):
            check(row["launches"][kname] > 0,
                  f"{kname} never launched on the segment path")
        self.segment_op = op

    # -- slice 8: banks, the sweep, multilayer SSL, graph serving -----------
    def window_path_record(self, path, geometry, plan, geom, c, kinds):
        """The window kernels at one shape of a path: kernel vs plain (TOL),
        kernel and plain ms (CUDA events), the bound, and that path's
        launches; one kernels-JSON record each."""
        torch, win = self.torch, self.win
        n, d, taps = geom.weights.shape
        pad = self.padded_grid_size(plan)
        gen = torch.Generator(device=self.dev).manual_seed(c)
        x = torch.randn((n, c), generator=gen, dtype=torch.float64,
                        device=self.dev)
        g = torch.randn((pad,) * d + (c,), generator=gen,
                        dtype=torch.float64, device=self.dev)
        tiles = geom.tiles
        fns = {"spread": (lambda: win.window_spread(
                   x, geom.base, geom.weights, padded_size=pad, tiles=tiles),
                   lambda: win.window_spread_plain(
                       x, geom.base, geom.weights, padded_size=pad)),
               "gather": (lambda: win.window_gather(g, geom.base,
                                                   geom.weights, tiles=tiles),
                          lambda: win.window_gather_plain(g, geom.base,
                                                          geom.weights))}
        for kname in kinds:
            kfn, pfn = fns[kname]
            p_out = pfn()
            err = float((kfn() - p_out).abs().max())
            rel = err / float(p_out.abs().max())
            tol = TOL[(kname, "float64")]
            check(rel <= tol, f"{kname} at the {path} path's shape: rel "
                  f"{rel:.3e}")
            ms = self.time_ms(kfn, reps=20)
            plain_ms = self.time_ms(pfn, reps=2, warmup=1)
            bound_ms, by, flops, nbytes = self.bound(n, d, taps, c, pad,
                                                     "float64")
            launches = self.path_launches[path][f"window_{kname}"]
            check(launches > 0, f"{path}: window_{kname} not launched")
            row = {"kernel": kname, "path": path, "geometry": geometry,
                   "n": n, "d": d, "taps": taps, "c": c, "dtype": "float64",
                   "padded": pad, "tiles": tiles.n_tiles,
                   "max_box_cells": tiles.max_cells, "max_abs_err": err,
                   "rel_err": rel, "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": bound_ms, "bound_by": by, "flops": flops,
                   "bytes": nbytes, "launches": launches,
                   "library_ms": None}
            self.record["times"].append(row)
            self.slice_records.append(row)
            log(f"[times] {kname:6s} {path} path ({geometry}) n={n} d={d} "
                f"C={c} float64: {ms:.4f} ms  bound {bound_ms:.4f} ms ({by}, "
                f"{100 * bound_ms / ms:.2f}% of bound)  plain {plain_ms:.3f} "
                f"ms (no yardstick)  library: none; rel err vs plain "
                f"{rel:.2e}; {launches} launches on the path")

    def one_launch_each(self, fn, what):
        """fn() with exactly one spread and one gather launch."""
        before = (self.win.window_spread.launches,
                  self.win.window_gather.launches)
        out = fn()
        got = (self.win.window_spread.launches - before[0],
               self.win.window_gather.launches - before[1])
        check(got == (1, 1), f"{what}: {got} spread/gather launches, not 1/1")
        return out

    def phase_bank(self):
        """[bank]: S = 4 Gaussian members on the main path's spiral at
        n = 10^5 (SETUP_2) against the S single operators, every flavour
        one spread and one gather launch."""
        torch, fs = self.torch, self.fs
        pts, _ = self.spiral(N_MAIN, seed=0)
        pts = torch.as_tensor(pts, device=self.dev)
        kernels = [self.make_kernel("gaussian", sigma=s) for s in BANK_SIGMAS]
        s_n, c, n = len(kernels), BANK_C, N_MAIN
        self.sync()
        t0 = time.perf_counter()
        bank = fs.make_fastsum_bank(kernels, pts, fs.SETUP_2, device=self.dev)
        self.sync()
        plan_s = time.perf_counter() - t0
        singles = [fs.make_fastsum(k, pts, fs.SETUP_2, device=self.dev)
                   for k in kernels]
        gen = torch.Generator(device=self.dev).manual_seed(11)
        x1 = torch.randn((n,), generator=gen, dtype=torch.float64,
                         device=self.dev)
        xc = torch.randn((n, c), generator=gen, dtype=torch.float64,
                         device=self.dev)
        xl = torch.randn((s_n, n, c), generator=gen, dtype=torch.float64,
                         device=self.dev)
        flat = xl.permute(1, 0, 2).reshape(n, s_n * c)
        # the S single operators' outputs first, so that each path's counts
        # hold the bank's own launches and nothing else.  One path per
        # (spread C, gather C) shape: {path: (spread C, gather C, {case:
        # (bank call, the singles' stacked outputs)})}
        lockstep = torch.stack([op.matvec_tilde(xl[s])
                                for s, op in enumerate(singles)])
        w = np.linspace(1.0, 0.25, s_n)
        paths = {
            "bank_broadcast_c1": (1, s_n, {"broadcast C=1": (
                lambda: bank.matvec_tilde(x1),
                torch.stack([op.matvec_tilde(x1) for op in singles]))}),
            "bank_broadcast": (c, s_n * c, {
                f"broadcast C={c}": (lambda: bank.matvec_tilde(xc),
                                     torch.stack([op.matvec_tilde(xc)
                                                  for op in singles])),
                f"matvec broadcast C={c}": (
                    lambda: bank.matvec(xc),
                    torch.stack([op.matvec(xc) for op in singles]))}),
            "bank_lockstep": (s_n * c, s_n * c, {
                f"lockstep S={s_n} C={c}": (lambda: bank.matvec_tilde(xl),
                                             lockstep),
                f"columns n x {s_n * c}": (
                    lambda: bank.matvec_tilde_columns(flat).reshape(
                        n, s_n, c).permute(1, 0, 2), lockstep)}),
            "bank_mixture": (c, c, {f"mixture(w={[float(v) for v in w]})": (
                lambda: bank.mixture(w).matvec(xc),
                sum(float(wi) * op.matvec(xc)
                    for wi, op in zip(w, singles)))})}
        row = {"n": n, "S": s_n, "C": c, "sigmas": BANK_SIGMAS,
               "plan_s": plan_s, "rel": {}, "launches": {}}
        for path, (_, _, cases) in paths.items():
            self.sync()
            self.reset_launches()
            got = {what: self.one_launch_each(fn, f"bank {what}")
                   for what, (fn, _) in cases.items()}
            self.sync()
            row["launches"][path] = self.read_launches(path)
            for what, (_, want) in cases.items():
                rel = float((got[what] - want).abs().max()
                            / want.abs().max())
                row["rel"][what] = rel
                log(f"[bank] {what}: bank vs "
                    + ("the weighted sum of the members' matvec"
                       if path == "bank_mixture"
                       else f"{s_n} single operators")
                    + f" rel {rel:.3e} (limit {BANK_TOL:g}); one spread + "
                    "one gather")
                check(rel <= BANK_TOL, f"bank {what}: rel {rel:.3e}")
        # times: the bank against S single matvecs of the same columns
        for what, bank_fn, single_fn in (
                ("broadcast C=1", lambda: bank.matvec_tilde(x1),
                 lambda: [op.matvec_tilde(x1) for op in singles]),
                (f"lockstep S={s_n} C={c}", lambda: bank.matvec_tilde(xl),
                 lambda: [op.matvec_tilde(xl[s])
                          for s, op in enumerate(singles)])):
            bank_ms = self.time_ms(bank_fn, reps=10)
            single_ms = self.time_ms(single_fn, reps=10)
            row[f"ms {what}"] = {"bank": bank_ms, "singles": single_ms}
            log(f"[bank] {what}: bank matvec {bank_ms:.3f} ms, {s_n} single "
                f"matvecs {single_ms:.3f} ms ({single_ms / bank_ms:.2f}x; "
                "CUDA events)")
        self.record["bank"] = row
        log(f"[bank] plan {plan_s:.3f}s; launches {row['launches']}")
        plan, geom = self.window_geometry("SETUP_2", 3, N_MAIN)
        for path, (c_spread, c_gather, _) in paths.items():
            self.window_path_record(path, "spiral SETUP_2", plan, geom,
                                    c_spread, ("spread",))
            self.window_path_record(path, "spiral SETUP_2", plan, geom,
                                    c_gather, ("gather",))

    def phase_sweep(self):
        """[sweep]: benchmarks/sweep_scaling.py's grids at n = 50,000, one
        krr_fit_sweep against 16 sequential krr_fit per d."""
        torch, fs, krr = self.torch, self.fs, self.krr
        self.record["sweep"] = {}
        for d in sorted(SWEEP_CONFIGS):
            n_bw, m, _, betas = SWEEP_CONFIGS[d]
            sigmas = sweep_sigmas(d)
            params = fs.FastsumParams(n_bandwidth=n_bw, m=m)
            x, f = sweep_dataset(d, SWEEP_N, self.crescent, self.spiral)
            pts = torch.as_tensor(x, device=self.dev)
            ft = torch.as_tensor(f, device=self.dev)
            # warm the card (the benchmark warms its shared jit caches)
            warm = fs.make_fastsum(
                self.make_kernel("gaussian", sigma=sigmas[0] * 1.01), pts,
                params, device=self.dev)
            warm.matvec_tilde(ft)
            self.sync()
            self.reset_launches()
            t0 = time.perf_counter()
            seq, seq_iters = {}, []
            for i, s in enumerate(sigmas):
                for j, b in enumerate(betas):
                    model = krr.krr_fit(self.make_kernel("gaussian", sigma=s),
                                        pts, ft, b, params, tol=SWEEP_TOL,
                                        maxiter=SWEEP_MAXITER,
                                        device=self.dev)
                    seq[i, j] = model.alpha
                    seq_iters.append(int(model.num_iters))
            self.sync()
            t_seq = time.perf_counter() - t0
            self.read_launches(f"sweep_sequential_d{d}")
            self.reset_launches()
            t0 = time.perf_counter()
            sweep = krr.krr_fit_sweep("gaussian", pts, ft, betas, sigmas,
                                      params, tol=SWEEP_TOL,
                                      maxiter=SWEEP_MAXITER, device=self.dev)
            self.sync()
            t_bank = time.perf_counter() - t0
            launches = self.read_launches(f"sweep_d{d}")
            iters = int(sweep.num_iters.max())
            alpha_rel = max(
                float((sweep.alphas[i, :, j] - a).abs().max()
                      / a.abs().max()) for (i, j), a in seq.items())
            # each system's true residual on its own single operator
            tol_abs = SWEEP_TOL * max(float(torch.linalg.vector_norm(ft)),
                                      1.0)
            beta_t = torch.tensor(betas, dtype=ft.dtype, device=self.dev)
            resid = 0.0
            for i, s in enumerate(sigmas):
                op = fs.make_fastsum(self.make_kernel("gaussian", sigma=s),
                                     pts, params, device=self.dev)
                a = sweep.alphas[i]
                r = ft[:, None] - (op.matvec_tilde(a) + beta_t * a)
                resid = max(resid, float(torch.linalg.vector_norm(
                    r, dim=0).max()))
            row = {"d": d, "n": SWEEP_N, "sigmas": sigmas, "betas": betas,
                   "n_bandwidth": n_bw, "m": m, "sequential_s": t_seq,
                   "bank_s": t_bank, "speedup": t_seq / t_bank,
                   "sequential_iters": sum(seq_iters), "bank_iters": iters,
                   "converged": bool(sweep.converged.all()),
                   "max_residual": resid, "tol_abs": tol_abs,
                   "alpha_rel": alpha_rel, "launches": launches}
            self.record["sweep"][d] = row
            log(f"[sweep] d={d} n={SWEEP_N} N={n_bw} m={m} {len(sigmas)} "
                f"sigmas x {len(betas)} betas: sequential {t_seq:.3f}s "
                f"({sum(seq_iters)} CG iterations), bank {t_bank:.3f}s "
                f"({iters} lockstep iterations), {t_seq / t_bank:.2f}x "
                "(host clock, ends in synchronize)")
            log(f"[sweep] d={d}: converged={row['converged']}, largest true "
                f"residual {resid:.3e} (tol {tol_abs:.3e}), bank vs "
                f"sequential alpha rel {alpha_rel:.3e} (limit "
                f"{SWEEP_ALPHA_REL:g}); launches {launches}")
            check(row["converged"], f"sweep d={d}: not converged")
            check(resid <= tol_abs, f"sweep d={d}: residual {resid:.3e}")
            check(alpha_rel <= SWEEP_ALPHA_REL,
                  f"sweep d={d}: alpha rel {alpha_rel:.3e}")
            check(launches["window_spread"] == iters + 1
                  and launches["window_gather"] == iters + 1,
                  f"sweep d={d}: {launches} for {iters} iterations (+1 for "
                  "the true residual)")
            if d == GS_SWEEP_D:
                self.sweep_cells = (x, sweep)
            if d == 3:
                scaled, _, _ = fs.scale_nodes(pts, params.eps_b_eff)
                plan = params.nfft_plan(d)
                geom = self.build_window_geometry(plan, scaled)
                self.window_path_record(
                    "sweep_d3", "spiral N=32 m=4", plan, geom,
                    SWEEP_SIGMAS * len(betas), ("spread", "gather"))

    def phase_multilayer(self):
        """[multilayer]: the [ssl] crescent with two Gaussian layers
        through kernel_ssl_cg_multilayer; its residual against (I + beta
        L_s) built from the two single-layer operators."""
        torch, fs, ssl = self.torch, self.fs, self.ssl
        pts, labels = self.crescent(N_SSL, seed=0)
        pts = torch.as_tensor(pts, device=self.dev)
        params = fs.FastsumParams(n_bandwidth=128, m=3, eps_b=0.0)
        kernels = [self.make_kernel("gaussian", sigma=s) for s in ML_SIGMAS]
        f, _ = ssl.make_training_vector(
            labels, SSL_SAMPLES, 2,
            generator=torch.Generator(device=self.dev).manual_seed(0),
            positive_class=1)
        self.sync()
        self.reset_launches()
        t0 = time.perf_counter()
        res = ssl.kernel_ssl_cg_multilayer(kernels, ML_WEIGHTS, pts, params,
                                           f, SSL_BETA, tol=SSL_TOL,
                                           maxiter=SSL_MAXITER,
                                           device=self.dev)
        self.sync()
        wall = time.perf_counter() - t0
        launches = self.read_launches("multilayer")
        layers = [fs.make_fastsum(k, pts, params, device=self.dev)
                  for k in kernels]

        def weights_matvec(v):  # W = sum_l w_l (W~_l - K_l(0) I)
            return sum(w * op.matvec(v) for w, op in zip(ML_WEIGHTS, layers))

        deg = weights_matvec(torch.ones_like(f))
        inv = 1.0 / torch.sqrt(torch.clamp(deg, min=torch.finfo(
            deg.dtype).tiny))
        u = res.u
        lap_u = u - inv * weights_matvec(inv * u)
        resid = float(torch.linalg.vector_norm(f - (u + SSL_BETA * lap_u)))
        tol_abs = SSL_TOL * max(float(torch.linalg.vector_norm(f)), 1.0)
        iters = int(res.num_iters)
        mis = float(((u > 0).cpu().numpy().astype("int32") != labels).mean())
        one = self.record["ssl"]
        self.record["multilayer"] = {
            "n": N_SSL, "sigmas": ML_SIGMAS, "weights": ML_WEIGHTS,
            "wall_s": wall, "cg_iters": iters,
            "converged": bool(res.converged), "residual": resid,
            "tol_abs": tol_abs, "misclassification": mis,
            "launches": launches}
        log(f"[multilayer] crescent-fullmoon n={N_SSL}, gaussian layers "
            f"sigma={ML_SIGMAS} weights={ML_WEIGHTS}, N=128 m=3, beta="
            f"{SSL_BETA:g}: {wall:.3f}s (plan + CG, ends in synchronize), "
            f"CG {iters} iters, converged={bool(res.converged)}; [ssl] "
            f"(one layer, sigma={SSL_SIGMA}): {one['wall_s']:.3f}s, "
            f"{one['cg_iters']} iters")
        log(f"[multilayer] true residual against (I + beta L_s) of the two "
            f"single-layer operators {resid:.3e} (tol {tol_abs:.3e}); "
            f"misclassification {mis * 100:.2f}%; launches {launches}")
        check(bool(res.converged) and resid <= tol_abs,
              f"multilayer: converged={bool(res.converged)} residual "
              f"{resid:.3e}")
        # one spread per CG iteration, plus the degrees and CG's final
        # true residual
        check(launches["window_spread"] == iters + 2
              and launches["window_gather"] == iters + 2,
              f"multilayer: {launches} for {iters} iterations")
        plan, geom = self.window_geometry("SSL", 2, N_SSL, "ssl")
        self.window_path_record("multilayer", "crescent N=128 m=3", plan,
                                geom, 1, ("spread", "gather"))

    def ndft_served(self, group, entry, scaled_q):
        """The exact trigonometric sum a served prediction approximates:
        out_scale * Re sum_k b_hat_k e^{2 pi i k.y} alpha_hat_k over the
        frozen frame's scaled queries y (plain torch NDFTs, no window
        kernel); alpha_hat is cached per model."""
        fs, pred, model = self.fs, group.pred, entry.model
        n_bw = model.params.n_bandwidth
        b_hat, _, out_scale, _ = fs._member_spectral(
            model.kernel, pred.rho, pred.plan, model.params, self.dev)
        if id(model) not in self.alpha_hat:
            self.alpha_hat[id(model)] = self.ndft_adjoint(
                n_bw, pred.scaled_src, model.alpha)
        return self.ndft_forward(n_bw, scaled_q, b_hat * self.alpha_hat[
            id(model)]).real * out_scale

    def graph_serve_check(self, reqs, models, registry, what):
        """Every served output, per group, against krr_predict_direct and
        against the exact trigonometric sum (NDFT), each within 10x the
        JAX engine's error, and against the same plan's unpacked fast
        prediction (one request, its own channel) within
        GS_UNPACKED_TOL."""
        torch = self.torch
        err, unpacked = {}, 0.0
        for r in reqs:
            check(r.done and r.error is None,
                  f"graph_serve {what}: request {r.uid}: {r.error}")
            q = torch.as_tensor(r.query_points, device=self.dev)
            g = graph_serve_group(r.model_id)
            group = registry.group_of(r.model_id)
            entry, pred = group.entries[r.model_id], group.pred
            scaled_q = pred.scale_targets(q)
            for key, ref in (
                    (g, self.krr.krr_predict_direct(models[r.model_id], q)),
                    ("ndft_" + g, self.ndft_served(group, entry, scaled_q))):
                ref = ref.cpu().numpy()
                e = err.setdefault(key, [0.0, 0.0])
                e[0] = max(e[0], float(np.abs(r.output - ref).max()))
                e[1] = max(e[1], float(np.abs(ref).max()))
            # the unpacked pipeline on alpha and on |alpha|: the latter's
            # size is the size of the sums the rounding acts on
            fast, size = (self.exec.fused_matvec_tilde(
                pred.plan, group.multipliers[entry.member], pred.src_window,
                pred.target_window(scaled_q), alpha).cpu().numpy()
                for alpha in (entry.model.alpha, entry.model.alpha.abs()))
            unpacked = max(unpacked, float(np.abs(r.output - fast).max()
                                           / np.abs(size).max()))
        rel = {k: v[0] / v[1] for k, v in err.items()}
        for k, v in sorted(rel.items()):
            limit = 10 * JAX_GRAPH_SERVE_REL[k]
            against = "the NDFT" if k.startswith("ndft") else "direct"
            log(f"[graph_serve] {what}, {k.removeprefix('ndft_')} group: "
                f"served vs {against} rel {v:.3e} (JAX engine "
                f"{JAX_GRAPH_SERVE_REL[k]:.3e}, limit {limit:.3e})")
            check(v <= limit, f"graph_serve {what} {k}: rel {v:.3e}")
        log(f"[graph_serve] {what}: served vs the plan's unpacked fast "
            f"prediction, relative to the largest sum over |alpha|: "
            f"{unpacked:.3e} (limit {GS_UNPACKED_TOL:g})")
        check(unpacked <= GS_UNPACKED_TOL,
              f"graph_serve {what} vs unpacked: {unpacked:.3e}")
        rel["unpacked"] = unpacked
        return rel

    def graph_serve_rounds(self, engine, registry, models, bursts, kind,
                           uid):
        """One traffic mix: the sequential path (one krr_predict, a full
        replan, per request) on the first GS_SEQ_ROUNDS bursts, then the
        engine on every burst, each fresh to it, all of a burst queued at
        t=0; the engine's launches are the path "graph_serve_<kind>".
        Returns (row, served requests, sequential (model id, queries,
        output))."""
        torch, krr, G = self.torch, self.krr, self.graph
        seq, seq_rps, seq_lat = [], [], []
        for burst in bursts[:GS_SEQ_ROUNDS]:
            t0 = time.perf_counter()
            for mid, q in burst:
                out = krr.krr_predict(models[mid], torch.as_tensor(
                    q, device=self.dev)).cpu().numpy()
                seq.append((mid, q, out))
                seq_lat.append(time.perf_counter() - t0)
            seq_rps.append(len(burst) / (time.perf_counter() - t0))
        before = registry.stats()
        ticks0, log0 = engine.counters["ticks"], len(engine.tick_log)
        geo0 = engine.counters["geometry_builds"]
        self.sync()
        self.reset_launches()
        served, eng_rps = [], []
        for burst in bursts:
            reqs = [G.PredictRequest(uid=uid + i, model_id=mid,
                                     query_points=q)
                    for i, (mid, q) in enumerate(burst)]
            uid += len(reqs)
            t0 = time.perf_counter()
            for r in reqs:
                engine.submit(r)
            engine.run_until_drained()
            eng_rps.append(len(reqs) / (time.perf_counter() - t0))
            served += reqs
        launches = self.read_launches(f"graph_serve_{kind}")
        after = registry.stats()
        ticks = engine.counters["ticks"] - ticks0
        geo = engine.counters["geometry_builds"] - geo0
        touched = sum(t.groups for t in engine.tick_log[log0:])
        check(after["plan_builds"] == before["plan_builds"]
              and after["grid_builds"] == before["grid_builds"],
              f"graph_serve {kind}: the timed rounds built plans or grids: "
              f"{after}")
        check(geo == touched and launches["window_gather"] == touched,
              f"graph_serve {kind}: {geo} geometries, "
              f"{launches['window_gather']} gathers for {touched} touched "
              f"groups in {ticks} ticks")
        check(launches["window_spread"] == 0,
              f"graph_serve {kind}: the timed rounds spread (a grid was "
              "built)")
        # engine vs sequential on the shared bursts, the first group only
        # (serve_scaling.py's 1e-2 parity is a quick-mode (n=4000) limit;
        # at full size the JAX engine alone misses direct by 2.1e-2)
        parity = max((float(np.abs(r.output - out).max()
                            / max(np.abs(out).max(), 1e-300))
                      for r, (mid, _, out) in zip(served, seq)
                      if graph_serve_group(mid) == "uniform"), default=None)

        def stats(rps, lats):
            return {"req_per_s": float(np.median(rps)),
                    "req_per_s_min": float(np.min(rps)),
                    "req_per_s_max": float(np.max(rps)),
                    "req_per_s_rounds": [float(v) for v in rps],
                    "p50_ms": float(np.percentile(lats, 50)) * 1e3,
                    "p99_ms": float(np.percentile(lats, 99)) * 1e3,
                    "requests": len(lats)}

        row = {"sequential": stats(seq_rps, seq_lat),
               "engine": stats(eng_rps, [r.latency for r in served]),
               "ticks": ticks, "group_gathers": touched, "parity": parity,
               "launches": launches}
        row["speedup"] = (row["engine"]["req_per_s"]
                          / row["sequential"]["req_per_s"])
        return row, served, seq

    def phase_graph_serve(self):
        """[graph_serve]: benchmarks/serve_scaling.py's full mode, plus the
        [sweep] d=2 grid's 16 cells as tenants of one plan, through the
        registry and the engine, against per-request krr_predict: each
        group alone and both mixed, GS_ROUNDS fresh bursts each."""
        torch, fs, krr, G = self.torch, self.fs, self.krr, self.graph
        card = self.record["device"]["nvidia_smi"]
        rng = np.random.default_rng(GS_SEED)
        xtr, ytr = graph_serve_data(rng)
        params = fs.FastsumParams(n_bandwidth=GS_N_BANDWIDTH, m=GS_M)
        spts, sweep = self.sweep_cells
        self.sync()
        self.reset_launches()
        models = {f"tenant{i}": krr.krr_fit(
            self.make_kernel("gaussian", sigma=s),
            torch.as_tensor(xtr, device=self.dev),
            torch.as_tensor(ytr, device=self.dev), GS_REG, params,
            device=self.dev) for i, s in enumerate(GS_SIGMAS)}
        self.sync()
        self.read_launches("graph_serve_fit")
        n_beta = len(sweep.betas)
        for i in range(len(sweep.sigmas)):
            for j in range(n_beta):
                models[f"cell{i * n_beta + j}"] = krr.krr_sweep_model(
                    sweep, i, j)
        registry = G.GraphModelRegistry()
        for mid, model in models.items():
            registry.register(mid, model)
        reg0 = registry.stats()
        check(reg0["plan_builds"] == 2
              and reg0["multiplier_builds"] == len(models),
              f"graph_serve registration: {reg0}")
        engine = G.GraphServeEngine(registry, slots=GS_SLOTS, chunk=GS_CHUNK)
        # warm-up, one group at a time: builds every tenant's grid
        burst1 = graph_serve_burst(rng, spts)
        served = {"uniform": [], "sweep": []}
        for g in served:
            reqs = [G.PredictRequest(uid=i, model_id=mid, query_points=q)
                    for i, (mid, q) in enumerate(burst1)
                    if graph_serve_group(mid) == g]
            before = registry.stats()["bank_transforms"]
            self.sync()
            self.reset_launches()
            for r in reqs:
                engine.submit(r)
            engine.run_until_drained()
            self.sync()
            launches = self.read_launches(f"graph_serve_warm_{g}")
            transforms = registry.stats()["bank_transforms"] - before
            check(launches["window_spread"] == transforms > 0,
                  f"graph_serve warm-up {g}: {launches} for {transforms} "
                  "transforms")
            served[g] += reqs
        warm = registry.stats()
        # timed: each group's traffic alone, then both mixed
        rows, seq = {}, {"uniform": [], "sweep": []}
        uid = len(burst1)
        for kind in GS_TRAFFIC:
            bursts = [graph_serve_burst(rng, spts, kind)
                      for _ in range(GS_ROUNDS)]
            rows[kind], reqs, outs = self.graph_serve_rounds(
                engine, registry, models, bursts, kind, uid)
            uid += sum(len(b) for b in bursts)
            for r in reqs:
                served[graph_serve_group(r.model_id)].append(r)
            for item in outs:
                seq[graph_serve_group(item[0])].append(item)
        steady = registry.stats()
        check(steady["plan_builds"] == warm["plan_builds"]
              and steady["grid_builds"] == warm["grid_builds"],
              f"graph_serve timed rounds built plans or grids: {steady}")
        # the oracle, one training size at a time: every served output
        # and every sequential one against the direct sum (kernel_matvec),
        # within 10x the JAX package's errors
        rel = {}
        for g in served:
            self.sync()
            self.reset_launches()
            rel[g] = self.graph_serve_check(served[g], models, registry,
                                            f"{len(served[g])} served")
            num = den = 0.0
            for mid, q, out in seq[g]:
                direct = krr.krr_predict_direct(models[mid], torch.as_tensor(
                    q, device=self.dev)).cpu().numpy()
                num = max(num, float(np.abs(out - direct).max()))
                den = max(den, float(np.abs(direct).max()))
            self.sync()
            self.read_launches(f"graph_serve_oracle_{g}")
            want = JAX_GRAPH_SERVE_REL[f"sequential_{g}"]
            rel[g]["sequential"] = num / den
            log(f"[graph_serve] {len(seq[g])} sequential, {g} group: "
                f"krr_predict vs direct rel {num / den:.3e} (JAX package "
                f"{want:.3e}, limit {10 * want:.3e})")
            check(num / den <= 10 * want,
                  f"graph_serve sequential {g}: rel {num / den:.3e}")
        log(f"[graph_serve] 256 points a request; uniform traffic: "
            f"serve_scaling.py's {GS_REQUESTS} requests over "
            f"{len(GS_SIGMAS)} tenants (n={GS_N_TRAIN}); sweep traffic: "
            f"{GS_SWEEP_PER_CELL} on each of the {len(models) - 2} sweep "
            f"cells (n={SWEEP_N}); mixed: both; slots={GS_SLOTS} "
            f"chunk={GS_CHUNK}; {GS_ROUNDS} fresh bursts through the "
            f"engine, the first {GS_SEQ_ROUNDS} also sequentially; host "
            f"clock, a burst queued at t=0, req/s the median burst (min-max)"
            f", p50/p99 over every request; {card}")
        for kind, row in rows.items():
            for path in ("sequential", "engine"):
                st = row[path]
                log(f"[graph_serve] {kind} {path}: {st['req_per_s']:.1f} "
                    f"req/s ({st['req_per_s_min']:.1f}-"
                    f"{st['req_per_s_max']:.1f}), p50 {st['p50_ms']:.1f} ms, "
                    f"p99 {st['p99_ms']:.1f} ms over {st['requests']} "
                    "requests")
            parity = ("" if row["parity"] is None else
                      f", engine vs sequential rel {row['parity']:.2e} "
                      "(uniform group)")
            log(f"[graph_serve] {kind}: engine {row['speedup']:.2f}x "
                f"sequential (BENCH_serve.json, CPU, uniform: 43x); "
                f"{row['ticks']} ticks, {row['group_gathers']} group "
                f"gathers{parity}; 0 plan and 0 grid builds; launches "
                f"{row['launches']}")
        self.record["graph_serve"] = {
            "traffic": rows, "rel": rel, "registry": steady,
            "engine": dict(engine.counters)}
        self.gs_tenants = {mid: m for mid, m in models.items()
                           if graph_serve_group(mid) == "uniform"}
        self.graph_serve_guards(registry, models)
        self.graph_serve_tick(registry, models)
        self.graph_serve_records(registry, xtr, params, spts)

    def graph_serve_records(self, registry, xtr, params, spts):
        """The window kernels at each [graph_serve] path's shapes: the
        fits (C=1 on the uniform training set), the cold transform's
        spread (C = pad_to = 8) and the tick's packed gather (width
        slots = 8, slots x chunk rows) of each group."""
        torch, fs = self.torch, self.fs
        scaled, _, _ = fs.scale_nodes(torch.as_tensor(xtr, device=self.dev),
                                      params.eps_b_eff)
        plan = params.nfft_plan(2)
        self.window_path_record(
            "graph_serve_fit", f"uniform n={GS_N_TRAIN} N=64 m=4", plan,
            self.build_window_geometry(plan, scaled), 1,
            ("spread", "gather"))
        rng = np.random.default_rng(13)
        for g, mid, lo, hi in (
                ("uniform", "tenant0", -2.5, 2.5),
                ("sweep", "cell0", spts.min(axis=0), spts.max(axis=0))):
            pred = registry.group_of(mid).pred
            n_bw = pred.plan.n_bandwidth
            q = torch.as_tensor(rng.uniform(lo, hi, (GS_SLOTS * GS_CHUNK, 2)),
                                device=self.dev)
            tick = pred.target_window(pred.scale_targets(q))
            what = f"{g} n={pred.n_source} N={n_bw}"
            self.window_path_record(f"graph_serve_warm_{g}",
                                    f"{what}, serving frame", pred.plan,
                                    pred.src_window, min(GS_SLOTS, 8),
                                    ("spread",))
            for path in (f"graph_serve_warm_{g}", f"graph_serve_{g}"):
                self.window_path_record(path, f"{what}, packed tick rows",
                                        pred.plan, tick, GS_SLOTS,
                                        ("gather",))

    def graph_serve_guards(self, registry, models):
        """Out-of-domain reject / replan, and a grid poisoned by hand that
        trips the breaker and recovers (tests/test_chaos.py's case)."""
        torch, G = self.torch, self.graph
        rej = G.GraphServeEngine(registry, slots=2, chunk=GS_CHUNK)
        r = G.PredictRequest(uid=0, model_id="tenant0",
                             query_points=GS_OUT_OF_DOMAIN)
        rej.submit(r)
        rej.step()
        check(r.done and r.error is not None and "domain" in r.error,
              f"graph_serve: out-of-domain not rejected ({r.error})")
        rep = G.GraphServeEngine(registry, slots=2, chunk=GS_CHUNK,
                                 out_of_domain="replan")
        r = G.PredictRequest(uid=1, model_id="tenant0",
                             query_points=GS_OUT_OF_DOMAIN)
        rep.submit(r)
        rep.step()
        direct = self.krr.krr_predict_direct(
            models["tenant0"], torch.as_tensor(
                GS_OUT_OF_DOMAIN, device=self.dev)).cpu().numpy()
        rel = float(np.abs(r.output - direct).max() / np.abs(direct).max())
        limit = 10 * JAX_GRAPH_SERVE_REL["replan"]
        log(f"[graph_serve] out-of-domain: rejected; replanned rel {rel:.3e} "
            f"(JAX engine {JAX_GRAPH_SERVE_REL['replan']:.3e}, limit "
            f"{limit:.3e})")
        check(r.error is None and rel <= limit,
              f"graph_serve replan: {r.error} rel {rel:.3e}")
        eng = G.GraphServeEngine(registry, slots=2, chunk=GS_CHUNK,
                                 breaker_threshold=2, breaker_cooldown=2)
        q = np.random.default_rng(5).uniform(-2, 2, (6, 8, 2))

        def submit(uid, mid, k):
            req = G.PredictRequest(uid=uid, model_id=mid, query_points=q[k])
            eng.submit(req)
            return req

        warm = submit(0, "tenant0", 0)
        eng.run_until_drained()
        group = registry.group_of("tenant0")
        key = ("tenant0", "alpha")
        with registry._lock:
            grid = group.grids[key]
            mask = torch.rand(grid.shape, generator=torch.Generator(
                device=self.dev).manual_seed(1), device=self.dev) < 0.5
            group.grids[key] = torch.where(mask, float("nan"), grid)
        bad = [submit(1, "tenant0", 1), submit(2, "tenant0", 2)]
        stats = eng.step()
        shed = submit(3, "tenant0", 3)
        eng.step()
        sibling = submit(4, "tenant1", 4)
        eng.run_until_drained()
        for _ in range(4):
            eng.step()
        back = submit(5, "tenant0", 5)
        eng.run_until_drained()
        ok = (warm.error is None and stats.nonfinite == 2
              and all("non-finite" in (r.error or "") for r in bad)
              and eng.counters["breaker_trips"] == 1
              and "circuit open" in (shed.error or "")
              and sibling.error is None and back.error is None)
        log(f"[graph_serve] poisoned grid: {stats.nonfinite} requests failed "
            f"non-finite, breaker trips {eng.counters['breaker_trips']}, "
            f"shed: {shed.error!r}, sibling served: {sibling.error is None}, "
            f"recovered: {back.error is None}")
        check(ok, "graph_serve breaker: poisoned grid not contained")
        self.graph_serve_check([sibling, back], models, registry,
                               "after the breaker")

    def graph_serve_tick(self, registry, models):
        """One full tick of the first group taken apart: host packing, the
        target geometry, its tile plan, the packed gather (CUDA events),
        the output's copy to the host; the host syncs of the geometry and
        the tile plan; the padding's cost."""
        import warnings
        torch, G, ex, win = self.torch, self.graph, self.exec, self.win
        rng = np.random.default_rng(9)
        eng = G.GraphServeEngine(registry, slots=GS_SLOTS, chunk=GS_CHUNK)
        for i in range(GS_SLOTS):
            eng.submit(G.PredictRequest(
                uid=i, model_id=f"tenant{i % len(GS_SIGMAS)}",
                query_points=rng.uniform(-2.5, 2.5, (GS_M_QUERY, 2))))
        eng._admit()
        slots = list(range(GS_SLOTS))
        group = eng._group[0]
        pred = group.pred
        columns, col_of_slot, rhs = eng._columns(slots)
        grids, _ = registry.ensure_grids(group, columns, rhs,
                                         pad_to=min(GS_SLOTS, 8))
        grid = torch.stack(list(grids) + [group.zero_grid()]
                           * (GS_SLOTS - len(grids)), dim=-1)
        reps = 20

        def host_ms(fn):
            fn()
            self.sync()
            t0 = time.perf_counter()
            for _ in range(reps):
                out = fn()
            self.sync()
            return (time.perf_counter() - t0) / reps * 1e3, out

        pack_ms, (packed, col_index, _) = host_ms(
            lambda: eng._pack(slots, col_of_slot, 2, np.float64))
        geom_ms, tgt = host_ms(lambda: pred.target_window(packed))
        tiles_ms, _ = host_ms(
            lambda: win.build_tile_plan(tgt.base, pred.plan.taps))
        col_t = torch.as_tensor(col_index, device=self.dev)
        tgt.tiles  # built once, as the tick's first gather does
        gather_ms = self.time_ms(
            lambda: ex.fused_gather_columns(pred.plan, tgt, grid, col_t),
            reps=reps)
        used = grid[..., :len(grids)].contiguous()
        gather_used_ms = self.time_ms(
            lambda: ex.fused_gather_columns(pred.plan, tgt, used, col_t),
            reps=reps)
        out = ex.fused_gather_columns(pred.plan, tgt, grid, col_t)
        copy_ms, _ = host_ms(lambda: out.cpu())
        # host syncs of the per-tick plan work
        syncs = {}
        for what, fn in (("target geometry",
                          lambda: pred.target_window(packed)),
                         ("tile plan", lambda: win.build_tile_plan(
                             tgt.base, pred.plan.taps))):
            torch.cuda.set_sync_debug_mode("warn")
            try:
                with warnings.catch_warnings(record=True) as seen:
                    warnings.simplefilter("always")
                    fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")
            syncs[what] = sum("synchroniz" in str(w.message).lower()
                              for w in seen)
        # the transform's padding: pad_to columns against the used ones
        src = pred.scaled_src
        cols = [m.alpha for m in (models["tenant0"], models["tenant1"])]
        members = torch.tensor([0, 1], device=self.dev)
        xb2 = torch.stack(cols, dim=1)
        xb8 = torch.cat([xb2, torch.zeros((src.shape[0], 6), dtype=src.dtype,
                                          device=self.dev)], dim=1)
        members8 = torch.tensor([0, 1] + [0] * 6, device=self.dev)
        tr8_ms = self.time_ms(lambda: ex.fused_transform_columns(
            pred.plan, group.mult_stack[members8], pred.src_window, xb8),
            reps=reps)
        tr2_ms = self.time_ms(lambda: ex.fused_transform_columns(
            pred.plan, group.mult_stack[members], pred.src_window, xb2),
            reps=reps)
        eng.run_until_drained()
        rows = packed.shape[0]
        row = {"pack_ms": pack_ms, "geometry_ms": geom_ms,
               "tile_plan_ms": tiles_ms, "gather_ms": gather_ms,
               "gather_used_columns_ms": gather_used_ms,
               "copy_to_host_ms": copy_ms, "syncs": syncs,
               "packed_rows": rows, "channels": GS_SLOTS,
               "used_columns": len(grids), "used_share": 1.0 / GS_SLOTS,
               "transform_ms": {"pad_to_8": tr8_ms, "2_columns": tr2_ms}}
        self.record["graph_serve"]["tick"] = row
        log(f"[graph_serve] one tick ({rows} packed rows, {GS_SLOTS} "
            f"channels, {len(grids)} used): host packing {pack_ms:.3f} ms, "
            f"target geometry {geom_ms:.3f} ms, tile plan {tiles_ms:.3f} ms "
            f"(host clock, ends in synchronize), packed gather "
            f"{gather_ms:.4f} ms (CUDA events; at the {len(grids)} used "
            f"channels {gather_used_ms:.4f} ms), output to host "
            f"{copy_ms:.3f} ms; host syncs: {syncs}")
        log(f"[graph_serve] the gather keeps 1 of {GS_SLOTS} channels a row "
            f"({100.0 / GS_SLOTS:.1f}% used); the cold transform at pad_to=8 "
            f"columns {tr8_ms:.3f} ms, at the 2 used {tr2_ms:.3f} ms")

    # -- [durable] ----------------------------------------------------------
    def phase_durable(self):
        """[durable]: the deterministic spread against plain and across
        repeats, then kill-and-resume on the card: resumable_eigsh on the
        main path, resumable_solve on KRR's Gram and on a bank, each
        bitwise equal to its uninterrupted run and to the plain solver
        under the same switch; the registry journal's warm restart, and
        dropped ticks."""
        import shutil
        import tempfile
        work = Path(tempfile.mkdtemp(prefix="durable_", dir=ROOT / "build"))
        t0 = time.perf_counter()
        try:
            self.durable_repeatable_libraries()
            self.durable_spread_checks()
            self.durable_eigsh()
            self.durable_krr()
            self.durable_bank()
            self.durable_journal_and_chaos(work)
        finally:
            shutil.rmtree(work, ignore_errors=True)
            for leftover in (ROOT / "build").glob("durable_*"):
                shutil.rmtree(leftover, ignore_errors=True)
        self.record["durable_s"] = time.perf_counter() - t0
        log(f"[durable] phase {self.record['durable_s']:.1f}s wall")

    def ckpt_dir(self, name):
        """A fresh snapshot directory under build/ (removed at the
        phase's end)."""
        import tempfile
        return tempfile.mkdtemp(prefix=f"durable_{name}_",
                                dir=ROOT / "build")

    def durable_repeatable_libraries(self):
        """cuFFT and the cuBLAS products the durable paths run (Lanczos's
        reorthogonalization gemv pair, block Lanczos's gemm, CG's column
        dots) must repeat bit for bit in one stream."""
        torch = self.torch
        gen = torch.Generator(device=self.dev).manual_seed(3)
        g = torch.randn((142,) * 3 + (1,), generator=gen, dtype=torch.float64,
                        device=self.dev)
        q = torch.randn((DUR_ITERS, N_MAIN), generator=gen,
                        dtype=torch.float64, device=self.dev)
        v = torch.randn((N_MAIN, 4), generator=gen, dtype=torch.float64,
                        device=self.dev)
        fns = {"cuFFT rfftn/irfftn 142^3": lambda: torch.fft.irfftn(
                   torch.fft.rfftn(g, dim=(0, 1, 2)) * 0.5, s=g.shape[:3],
                   dim=(0, 1, 2)),
               "cuBLAS Q^T (Q w), 80 x 10^5": lambda: q.T @ (q @ v[:, 0]),
               "cuBLAS block (Q^T W), 80 x 10^5 x 4": lambda: q @ v,
               "column dots (n, 4)": lambda: (v * v).sum(dim=0)}
        for what, fn in fns.items():
            outs = [fn() for _ in range(DET_REPEATS)]
            same = all(torch.equal(outs[0], o) for o in outs[1:])
            log(f"[durable] {what}: {DET_REPEATS} runs bitwise equal: {same}")
            check(same, f"{what} does not repeat bit for bit")

    def det_cases(self):
        """(label, plan, base, weights, tiles, channels) of every
        deterministic-spread check."""
        torch, fs = self.torch, self.fs
        for setup_name in ("SETUP_2", "SETUP_3"):
            for dtype in (torch.float64, torch.float32):
                plan, base, w, tiles = self.geometry(setup_name, 3, N_MAIN,
                                                     dtype)
                yield (f"spiral {setup_name} d=3 n={N_MAIN}", plan, base, w,
                       tiles, (1, 16))
        for d in (1, 2):
            n_bw, m, _, _ = SWEEP_CONFIGS[d]
            x, _ = sweep_dataset(d, SWEEP_N, self.crescent, self.spiral)
            params = fs.FastsumParams(n_bandwidth=n_bw, m=m)
            pts = torch.as_tensor(x, device=self.dev)
            scaled, _, _ = fs.scale_nodes(pts, params.eps_b_eff)
            plan = params.nfft_plan(d)
            geom = self.build_window_geometry(plan, scaled)
            yield (f"sweep d={d} N={n_bw} m={m} n={SWEEP_N}", plan, geom.base,
                   geom.weights, geom.tiles, (1, SWEEP_SIGMAS * 2))
        for dtype in (torch.float64, torch.float32):
            plan, base, w, tiles = self.geometry("WIDE_M9", 3, N_MAIN, dtype)
            yield (f"spiral N=32 m=9 d=3 n={N_MAIN} (pieces)", plan, base, w,
                   tiles, (1,))

    def det_reading(self, plan, base, w, tiles, c, reps):
        """The deterministic spread at one shape: repeats bitwise equal,
        error against plain, CUDA-event times of it, of the atomic mode and
        of plain, the bound, the scratch and partials, and its schedule
        (output-block index): build ms (host clock), bytes, waves,
        chunks."""
        torch, win = self.torch, self.win
        n, d, taps = w.shape
        pad = self.padded_grid_size(plan)
        dname = str(w.dtype).split(".")[1]
        gen = torch.Generator(device=self.dev).manual_seed(c)
        x = torch.randn((n, c), generator=gen, dtype=w.dtype,
                        device=self.dev)
        spread = lambda: win.window_spread(x, base, w, padded_size=pad,
                                           tiles=tiles)
        self.sync()
        t0 = time.perf_counter()
        index = win.spread_block_index(tiles, pad, c, w.element_size())
        self.sync()
        index_ms = (time.perf_counter() - t0) * 1e3
        with self.durable.deterministic():
            outs = [spread() for _ in range(DET_REPEATS)]
            det_ms = self.time_ms(spread, reps=reps, warmup=1)
        same = all(torch.equal(outs[0], o) for o in outs[1:])
        p_out = win.window_spread_plain(x, base, w, padded_size=pad)
        err = float((outs[0] - p_out).abs().max())
        rel = err / float(p_out.abs().max())
        atomic_ms = self.time_ms(spread, reps=reps, warmup=1)
        plain_ms = self.time_ms(
            lambda: win.window_spread_plain(x, base, w, padded_size=pad),
            reps=1, warmup=1)
        bound_ms, by, flops, nbytes = self.bound(n, d, taps, c, pad, dname)
        del outs, p_out
        return {"n": n, "d": d, "taps": taps, "c": c, "dtype": dname,
                "padded": pad, "tiles": tiles.n_tiles,
                "box_cells": int(tiles.table[:, 5:8].to(torch.long)
                                 .prod(dim=1).sum()),
                "block_side": index.side, "waves": index.n_waves,
                "chunks": index.chunks.shape[0],
                "index_mb": index.nbytes / 1e6,
                "scratch_bytes": win.window_spread_deterministic.scratch_bytes,
                "scratch_mb": win.window_spread_deterministic.scratch_bytes
                / 1e6,
                "partial_mb": win.window_spread_deterministic.partial_bytes
                / 1e6, "index_ms": index_ms, "repeats_equal": same,
                "max_abs_err": err, "rel_err": rel,
                "tol": TOL[("spread", dname)], "ms": det_ms,
                "atomic_ms": atomic_ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": by, "flops": flops,
                "bytes": nbytes, "library_ms": None}

    def durable_spread_checks(self):
        card = self.record["device"]["nvidia_smi"]
        log(f"[durable] deterministic window_spread (waves of boxes, then "
            f"output blocks by chunks) vs plain, {DET_REPEATS} repeats; "
            f"CUDA events; scratch cap "
            f"{self.win.DET_SCRATCH_BYTES / 1e6:.1f} MB; {card}")
        rows = []
        for label, plan, base, w, tiles, chans in self.det_cases():
            for c in chans:
                r = self.det_reading(plan, base, w, tiles, c,
                                     reps=3 if plan.taps > 16 else 10)
                r["geometry"] = label
                rows.append(r)
                log(f"[durable] spread_det {label} C={c} {r['dtype']}: "
                    f"{r['ms']:.4f} ms (atomic {r['atomic_ms']:.4f} ms, "
                    f"{r['ms'] / r['atomic_ms']:.2f}x)  bound "
                    f"{r['bound_ms']:.4f} ms ({r['bound_by']}, "
                    f"{100 * r['bound_ms'] / r['ms']:.2f}% of bound)  plain "
                    f"{r['plain_ms']:.3f} ms; scratch {r['scratch_mb']:.1f} "
                    f"MB, partials {r['partial_mb']:.1f} MB; index "
                    f"{r['index_mb']:.2f} MB built in {r['index_ms']:.1f} "
                    f"ms, {r['waves']} waves, {r['chunks']} chunks of "
                    f"{r['block_side']}^{r['d']}-cell blocks; rel "
                    f"{r['rel_err']:.3e} (tol {r['tol']:g}); repeats "
                    f"bitwise equal: {r['repeats_equal']}")
                check(r["repeats_equal"],
                      f"deterministic spread {label} C={c} {r['dtype']}: "
                      "repeats differ")
                check(r["rel_err"] <= r["tol"],
                      f"deterministic spread {label} C={c} {r['dtype']}: rel "
                      f"{r['rel_err']:.3e}")
                check(r["scratch_bytes"] <= self.win.DET_SCRATCH_BYTES,
                      f"deterministic spread {label} C={c} {r['dtype']}: "
                      f"scratch {r['scratch_mb']:.1f} MB over the cap")
        self.record["durable_spread"] = rows

    def det_path_record(self, path, geometry, plan, geom, c):
        """The deterministic spread at one path's shape (float64): a
        kernels-JSON record with that path's launches."""
        launches = self.path_launches[path]["window_spread_deterministic"]
        check(launches > 0, f"{path}: the deterministic spread never "
              "launched")
        r = self.det_reading(plan, geom.base, geom.weights, geom.tiles, c,
                             reps=10)
        check(r["repeats_equal"] and r["rel_err"] <= r["tol"]
              and r["scratch_bytes"] <= self.win.DET_SCRATCH_BYTES,
              f"deterministic spread at the {path} path's shape: "
              f"{r['rel_err']:.3e}, repeats equal {r['repeats_equal']}, "
              f"scratch {r['scratch_mb']:.1f} MB")
        r.update(path=path, geometry=geometry, launches=launches)
        self.det_records.append(r)
        self.record["times"].append(dict(r, kernel="spread_deterministic"))
        log(f"[times] spread_det {path} path ({geometry}) n={r['n']} "
            f"d={r['d']} C={c} float64: {r['ms']:.4f} ms (atomic "
            f"{r['atomic_ms']:.4f})  bound {r['bound_ms']:.4f} ms "
            f"({100 * r['bound_ms'] / r['ms']:.2f}% of bound)  plain "
            f"{r['plain_ms']:.3f} ms; scratch {r['scratch_mb']:.1f} MB; "
            f"index {r['index_mb']:.2f} MB built in {r['index_ms']:.1f} ms, "
            f"{r['waves']} waves, {r['chunks']} chunks; {launches} "
            f"launches on the path")

    def report_line(self, rep):
        hidden = max(rep.snapshot_write_s - rep.snapshot_wait_s, 0.0)
        return (f"{rep.snapshots} snapshots, {rep.segments} segments, "
                f"{rep.restarts} restarts, resumed from {rep.resumed_from}; "
                f"snapshot copies {rep.snapshot_copy_s * 1e3:.1f} ms on the "
                f"driver, writes {rep.snapshot_write_s * 1e3:.1f} ms in the "
                f"writer threads, of which the driver waited "
                f"{rep.snapshot_wait_s * 1e3:.1f} ms (hidden "
                f"{hidden * 1e3:.1f} ms)")

    def timed(self, fn):
        self.sync()
        t0 = time.perf_counter()
        out = fn()
        self.sync()
        return out, time.perf_counter() - t0

    def median_s(self, fn, reps=3):
        """Median host seconds of ``reps`` calls of ``fn`` (each ending
        in a sync), after one untimed call."""
        fn()
        return float(np.median([self.timed(fn)[1] for _ in range(reps)]))

    def durable_eigsh(self):
        """resumable_eigsh on the main path: the spiral at n = 10^5, k =
        K_EIG, DUR_ITERS single-vector steps, snapshots every DUR_EVERY,
        killed at DUR_KILL."""
        torch, D = self.torch, self.durable
        F = self.faults
        pts, _ = self.spiral(N_MAIN, seed=0)
        pts = torch.as_tensor(pts, device=self.dev)
        policy = D.DurablePolicy(snapshot_every=DUR_EVERY)
        row = {}
        for name in ("SETUP_2", "SETUP_3"):
            op = self.fs.make_normalized_adjacency(self.kernel, pts,
                                                   self.setup(name),
                                                   device=self.dev)

            def kw(**more):  # a freshly seeded generator for every call
                return dict(num_iters=DUR_ITERS, device=self.dev,
                            generator=self.torch.Generator(
                                device=self.dev).manual_seed(DUR_SEED),
                            **more)

            plain = self.lan.eigsh(op.matvec, op.n, K_EIG, **kw())
            with D.deterministic():
                ref = self.lan.eigsh(op.matvec, op.n, K_EIG, **kw())
            self.reset_launches()
            whole, rep_w = D.resumable_eigsh(
                op.matvec, op.n, K_EIG, ckpt_dir=self.ckpt_dir("eig"),
                policy=policy, **kw())
            launches = self.read_launches(f"durable_eigsh_{name}")
            t_plain = self.median_s(lambda: self.lan.eigsh(
                op.matvec, op.n, K_EIG, **kw()))
            with D.deterministic():
                t_det = self.median_s(lambda: self.lan.eigsh(
                    op.matvec, op.n, K_EIG, **kw()))
            t_dur = self.median_s(lambda: D.resumable_eigsh(
                op.matvec, op.n, K_EIG, ckpt_dir=self.ckpt_dir("eigt"),
                policy=policy, **kw()))
            check(launches["window_spread_deterministic"] == DUR_ITERS
                  and launches["window_spread"] == 0,
                  f"durable eigsh {name}: {launches} for {DUR_ITERS} steps")
            (killed, rep_k), _ = self.timed(lambda: D.resumable_eigsh(
                op.matvec, op.n, K_EIG, ckpt_dir=self.ckpt_dir("eigk"),
                policy=policy, fault_hook=F.KillPoint(DUR_KILL), **kw()))
            cross = self.ckpt_dir("eigx")
            died = False
            try:
                D.resumable_eigsh(
                    op.matvec, op.n, K_EIG, ckpt_dir=cross,
                    policy=D.DurablePolicy(snapshot_every=DUR_EVERY,
                                           max_restarts=0),
                    fault_hook=F.KillPoint(DUR_KILL), **kw())
            except F.Preemption:
                died = True
            again, rep_x = D.resumable_eigsh(op.matvec, op.n, K_EIG,
                                             ckpt_dir=cross, policy=policy,
                                             **kw())
            for what, res in (("killed at 37", killed),
                              ("cross-process", again),
                              ("plain eigsh under the switch", ref)):
                same = (torch.equal(res.eigenvalues, whole.eigenvalues)
                        and torch.equal(res.eigenvectors, whole.eigenvectors))
                log(f"[durable] eigsh {name} {what} vs uninterrupted "
                    f"durable: eigenvalues and eigenvectors bitwise equal: "
                    f"{same}")
                check(same, f"durable eigsh {name}: {what} differs")
            check(rep_k.restarts == 1 and rep_k.resumed_from is None
                  and died and rep_x.resumed_from == -(-DUR_KILL
                                                       // DUR_EVERY)
                  * DUR_EVERY,
                  f"durable eigsh {name}: killed {rep_k}, died {died}, "
                  f"cross-process {rep_x}")
            check(bool(torch.isfinite(whole.residual_bounds).all()),
                  f"durable eigsh {name}: non-finite residual bounds")
            gap = float((whole.eigenvalues - plain.eigenvalues).abs().max())
            check(gap <= TIERS[name], f"durable eigsh {name}: eigenvalues "
                  f"{gap:.3e} from the atomic run's")
            # informative: the same kill-and-resume with the switch off
            real = D.deterministic
            D.deterministic = __import__("contextlib").nullcontext
            try:
                off_w, _ = D.resumable_eigsh(
                    op.matvec, op.n, K_EIG, ckpt_dir=self.ckpt_dir("eigo"),
                    policy=policy, **kw())
                off_k, _ = D.resumable_eigsh(
                    op.matvec, op.n, K_EIG, ckpt_dir=self.ckpt_dir("eigok"),
                    policy=policy, fault_hook=F.KillPoint(DUR_KILL), **kw())
            finally:
                D.deterministic = real
            drift = float((off_k.eigenvalues - off_w.eigenvalues).abs().max())
            vdrift = float((off_k.eigenvectors.abs()
                            - off_w.eigenvectors.abs()).abs().max())
            row[name] = {"plain_s": t_plain, "plain_det_s": t_det,
                         "durable_s": t_dur, "ratio": t_dur / t_plain,
                         "report": dataclasses.asdict(rep_w),
                         "killed_report": dataclasses.asdict(rep_k),
                         "switch_off_eig_drift": drift,
                         "switch_off_vec_drift": vdrift,
                         "launches": launches}
            log(f"[durable] eigsh {name} n={N_MAIN} k={K_EIG} {DUR_ITERS} "
                f"steps: plain {t_plain:.4f}s (atomic), plain under the "
                f"switch {t_det:.4f}s, durable {t_dur:.4f}s = "
                f"{t_dur / t_plain:.2f}x plain (host clock, ends in "
                f"synchronize, median of 3; BENCH_resume.json, CPU n=3000: "
                f"{1 + BENCH_RESUME_OVERHEAD['eigsh'] / 100:.2f}x); "
                + self.report_line(rep_w))
            log(f"[durable] eigsh {name} killed at {DUR_KILL}: "
                + self.report_line(rep_k))
            log(f"[durable] informative, switch off: killed-and-resumed vs "
                f"uninterrupted max |d eigenvalue| {drift:.3e}, max "
                f"|d |eigenvector|| {vdrift:.3e}")
            geom = op.fastsum.src_window
            self.det_path_record(f"durable_eigsh_{name}", f"spiral {name}",
                                 op.fastsum.plan, geom, 1)
            del op
        self.record["durable_eigsh"] = row

    def durable_krr(self):
        """resumable_solve on [krr]'s Gaussian Gram (n = 10^4, N=256 m=5,
        K~ + beta I), tol DUR_KRR_TOL, killed at DUR_KRR_KILLS."""
        torch, D, F = self.torch, self.durable, self.faults
        points, labels = self.crescent(N_KRR + N_KRR_TEST, seed=5)
        xtr = torch.as_tensor(points[:N_KRR], device=self.dev)
        ytr = torch.as_tensor(2.0 * labels[:N_KRR] - 1.0, device=self.dev)
        params = self.fs.FastsumParams(n_bandwidth=256, m=5, eps_b=None)
        gram = self.fs.make_fastsum(self.make_kernel("gaussian", sigma=2.0),
                                    xtr, params, device=self.dev)
        mv = lambda x: gram.matvec_tilde(x) + KRR_BETA * x
        kw = dict(tol=DUR_KRR_TOL, maxiter=KRR_MAXITER)
        policy = D.DurablePolicy(snapshot_every=DUR_KRR_EVERY)
        plain, t_plain = self.timed(lambda: self.solvers.cg(mv, ytr, **kw))
        with D.deterministic():
            ref, t_det = self.timed(lambda: self.solvers.cg(mv, ytr, **kw))
        self.reset_launches()
        (whole, rep_w), t_dur = self.timed(lambda: D.resumable_solve(
            mv, ytr, ckpt_dir=self.ckpt_dir("krr"), policy=policy, **kw))
        launches = self.read_launches("durable_krr")
        killed, rep_k = D.resumable_solve(
            mv, ytr, ckpt_dir=self.ckpt_dir("krrk"), policy=policy,
            fault_hook=F.KillSchedule(DUR_KRR_KILLS), **kw)
        iters = int(whole.num_iters)
        for what, res in (("killed twice", killed),
                          ("plain cg under the switch", ref)):
            same = (torch.equal(res.x, whole.x)
                    and int(res.num_iters) == iters)
            log(f"[durable] krr CG {what} vs uninterrupted durable: x "
                f"bitwise equal, same iterations: {same}")
            check(same, f"durable krr CG: {what} differs")
        check(rep_k.restarts == len(DUR_KRR_KILLS),
              f"durable krr: {rep_k.restarts} restarts")
        check(bool(whole.converged) and int(plain.num_iters) > 0,
              f"durable krr: converged={bool(whole.converged)}")
        check(launches["window_spread_deterministic"] == iters + 1
              and launches["window_spread"] == 0,
              f"durable krr: {launches} for {iters} iterations (+1 for the "
              "true residual)")
        self.record["durable_krr"] = {
            "plain_s": t_plain, "plain_det_s": t_det, "durable_s": t_dur,
            "ratio": t_dur / t_plain, "iters": iters,
            "plain_iters": int(plain.num_iters),
            "report": dataclasses.asdict(rep_w),
            "killed_report": dataclasses.asdict(rep_k),
            "launches": launches}
        log(f"[durable] krr CG n={N_KRR} tol {DUR_KRR_TOL:g}: {iters} iters "
            f"(plain {int(plain.num_iters)}), plain {t_plain:.3f}s, plain "
            f"under the switch {t_det:.3f}s, durable {t_dur:.3f}s = "
            f"{t_dur / t_plain:.2f}x plain (host clock; "
            f"BENCH_resume.json, CPU n=3000: "
            f"{1 + BENCH_RESUME_OVERHEAD['cg'] / 100:.2f}x); "
            + self.report_line(rep_w))
        log(f"[durable] krr CG killed at {DUR_KRR_KILLS}: "
            + self.report_line(rep_k))
        self.det_path_record("durable_krr", "crescent N=256 m=5",
                             gram.plan, gram.src_window, 1)

    def durable_bank(self):
        """resumable_solve(bank=True) on [bank]'s four Gaussians at n =
        10^5 (SETUP_2), lockstep (S, n, BANK_C), DUR_BANK_SHIFT I +
        W~_s / n."""
        torch, D, F, fs = self.torch, self.durable, self.faults, self.fs
        pts, _ = self.spiral(N_MAIN, seed=0)
        pts = torch.as_tensor(pts, device=self.dev)
        kernels = [self.make_kernel("gaussian", sigma=s) for s in BANK_SIGMAS]
        bank = fs.make_fastsum_bank(kernels, pts, fs.SETUP_2, device=self.dev)
        mv = lambda xb: DUR_BANK_SHIFT * xb + bank.matvec_tilde(xb) / N_MAIN
        b = torch.randn((len(kernels), N_MAIN, BANK_C), dtype=torch.float64,
                        device=self.dev, generator=torch.Generator(
                            device=self.dev).manual_seed(12))
        kw = dict(tol=DUR_BANK_TOL, maxiter=DUR_BANK_MAXITER)
        policy = D.DurablePolicy(snapshot_every=DUR_BANK_EVERY)
        with D.deterministic():
            ref = self.solvers.cg_bank(mv, b, **kw)
        self.reset_launches()
        whole, rep_w = D.resumable_solve(mv, b, ckpt_dir=self.ckpt_dir("bank"),
                                         bank=True, policy=policy, **kw)
        launches = self.read_launches("durable_bank")
        killed, rep_k = D.resumable_solve(
            mv, b, ckpt_dir=self.ckpt_dir("bankk"), bank=True, policy=policy,
            fault_hook=F.KillSchedule(DUR_BANK_KILLS), **kw)
        for what, res in (("killed twice", killed),
                          ("plain cg_bank under the switch", ref)):
            same = (torch.equal(res.x, whole.x)
                    and torch.equal(res.num_iters, whole.num_iters))
            log(f"[durable] bank CG {what} vs uninterrupted durable: x "
                f"bitwise equal: {same}")
            check(same, f"durable bank CG: {what} differs")
        check(rep_k.restarts == len(DUR_BANK_KILLS)
              and bool(whole.converged.all()),
              f"durable bank: {rep_k.restarts} restarts, converged "
              f"{whole.converged.tolist()}")
        check(launches["window_spread_deterministic"] > 0
              and launches["window_spread"] == 0,
              f"durable bank: {launches}")
        self.record["durable_bank"] = {
            "iters": whole.num_iters.tolist(),
            "report": dataclasses.asdict(rep_w),
            "killed_report": dataclasses.asdict(rep_k), "launches": launches}
        log(f"[durable] bank CG S={len(kernels)} n={N_MAIN} C={BANK_C}: "
            f"{int(whole.num_iters.max())} iters; " + self.report_line(rep_w))
        self.det_path_record("durable_bank", "spiral SETUP_2, lockstep",
                             bank.plan, bank.src_window,
                             len(kernels) * BANK_C)

    # -- [dist] --------------------------------------------------------------
    def phase_dist(self):
        """[dist]: the distributed matvec on DIST_WORLD gloo ranks sharing
        the card (each rank spreads and gathers its block of the
        Morton-sorted rows), then on one NCCL rank: psum and pencil modes
        at n = 10^5 (SETUP_2, SETUP_3) on meshes (4,) and (2, 2), n = 10^6,
        [bank]'s four Gaussians, eigsh, compress_psum.  Each path's counts
        are set to 0 in every rank just before its distributed calls and
        read just after; the shard kernels are held against their plain
        versions on every rank's geometry."""
        from repro_torch.launch.ranks import RankPool
        card = self.record["device"]["nvidia_smi"]
        t0 = time.perf_counter()
        self.dist_rows, self.dist_kernel_rows = [], []
        self.record["dist"] = {"cases": self.dist_rows}
        with RankPool(DIST_WORLD, "gloo", "cuda:0") as pool:
            log(f"[dist] {DIST_WORLD} gloo ranks on cuda:0 ({card}): times "
                "below are four processes time-sharing one card, with the "
                "collectives staged through the host by gloo; not scaling "
                "numbers")
            for setup_name in ("SETUP_2", "SETUP_3"):
                path = f"dist_{setup_name}"
                for mode, mesh, axes in DIST_RUNS:
                    for c in DIST_COLUMNS:
                        shape = (N_MAIN,) if c == 1 else (N_MAIN, c)
                        self.dist_case(pool, path, "op", N_MAIN, setup_name,
                                       mode, mesh, axes, shape)
                self.dist_shards(pool, path, "op", N_MAIN, setup_name,
                                 DIST_COLUMNS)
            for mode, mesh, axes in DIST_BIG_RUNS:
                self.dist_case(pool, "dist_1e6", "op", N_BIG, "SETUP_2",
                               mode, mesh, axes, (N_BIG,), reps=3)
            self.dist_shards(pool, "dist_1e6", "op", N_BIG, "SETUP_2", (1,))
            s_n = len(BANK_SIGMAS)
            for mode, mesh, axes in DIST_BIG_RUNS:
                for shape in ((N_MAIN, DIST_BANK_C),
                              (s_n, N_MAIN, DIST_BANK_C)):
                    self.dist_case(pool, "dist_bank", "bank", N_MAIN,
                                   "SETUP_2", mode, mesh, axes, shape)
            self.dist_shards(pool, "dist_bank", "bank", N_MAIN, "SETUP_2",
                             (DIST_BANK_C, s_n * DIST_BANK_C))
            for mode, mesh, axes in DIST_EIG_RUNS:
                self.dist_eigsh(pool, mode, mesh, axes)
            self.dist_shards(pool, "dist_eigsh", "adjacency", N_MAIN,
                             "SETUP_3", (1,), mode="psum", mesh=(4,))
            self.dist_compress(pool)
        with RankPool(1, "nccl", "cuda:0") as pool:
            log("[dist] one NCCL rank on cuda:0: the psum path's collectives "
                "through NCCL (world size 1)")
            for c in DIST_COLUMNS:
                shape = (N_MAIN,) if c == 1 else (N_MAIN, c)
                self.dist_case(pool, "dist_nccl", "op", N_MAIN, "SETUP_2",
                               "psum", (1,), None, shape)
            self.dist_shards(pool, "dist_nccl", "op", N_MAIN, "SETUP_2", (1,),
                             mesh=(1,))
        self.record["dist"]["s"] = time.perf_counter() - t0
        log(f"[dist] phase {self.record['dist']['s']:.1f}s wall (two spawns "
            "of ranks included)")

    def dist_add_launches(self, path, outs):
        counts = self.path_launches.setdefault(path, {
            "window_spread": 0, "window_spread_deterministic": 0,
            "window_gather": 0, "kernel_matvec": 0, "flash_attention": 0,
            "per_rank": [0] * len(outs)})
        for o in outs:
            for kname, v in o["launches"].items():
                counts[kname] += v
            counts["per_rank"][o["rank"]] += o["launches"]["window_spread"]
        for kname in ("window_spread", "window_gather"):
            check(all(o["launches"][kname] > 0 for o in outs),
                  f"{path}: {kname} not launched on every rank")

    def dist_case(self, pool, path, kind, n, setup_name, mode, mesh, axes,
                  shape, reps=5):
        outs = pool.run(dist_matvec_case, kind, n, setup_name, mode, mesh,
                        axes, shape, reps if mode == "psum" else 3)
        self.dist_add_launches(path, outs)
        rel = max(o["rel"] for o in outs)
        same = len({o["digest"] for o in outs}) == 1
        o = outs[0]
        what = (f"{kind} n={n} {setup_name} {mode} mesh {mesh}"
                + (f" split {axes}" if axes else "") + f" x {shape}")
        check(rel <= DIST_TOL, f"[dist] {what}: rel {rel:.3e}")
        check(same, f"[dist] {what}: y differs between ranks")
        check((o["spec"] is not None) == (mode == "pencil"),
              f"[dist] {what}: ran spec {o['spec']}")
        traffic = {k: v for k, v in sorted(o["traffic"].items())}
        row = {"path": path, "kind": kind, "n": n, "setup": setup_name,
               "mode": mode, "mesh": list(mesh), "split": axes,
               "shape": list(shape), "rel": rel, "bitwise_equal": same,
               "spec": o["spec"], "traffic_rank0": traffic,
               "traffic_per_rank": [x["traffic"] for x in outs],
               "ms_per_rank": [x["ms"] for x in outs],
               "first_ms_per_rank": [x["first_ms"] for x in outs],
               "single_ms": o["single_ms"], "rows": o["rows"],
               "ghost_rows": o["pad"]}
        self.dist_rows.append(row)
        kinds = {k: v for k, v in traffic.items() if k != "wire"}
        log(f"[dist] {what}: rel {rel:.3e} (limit {DIST_TOL:g}), y bitwise "
            f"equal on {len(outs)} ranks; payload a rank a matvec "
            f"{sum(kinds.values()):,} B operands ("
            + ", ".join(f"{k} {v:,}" for k, v in kinds.items())
            + f"), {traffic.get('wire', 0):,} B sent (ring model); "
            f"{max(x['ms'] for x in outs):.2f} ms a matvec, slowest rank "
            f"(first call {max(x['first_ms'] for x in outs):.1f} ms) vs "
            f"single-device {o['single_ms']:.3f} ms (host clock, ends in a "
            "sync)")

    def dist_shards(self, pool, path, kind, n, setup_name, columns,
                    mode="psum", mesh=(DIST_WORLD,)):
        outs = pool.run(dist_shard_kernels, kind, n, setup_name, mode, mesh,
                        None, columns)
        o = outs[0]
        for c in columns:
            for kname in ("spread", "gather"):
                worst = max(x["c"][c][kname]["rel"] for x in outs)
                tol = TOL[(kname, "float64")]
                check(worst <= tol, f"[dist] {path}: shard {kname} C={c} "
                      f"rel {worst:.3e}")
                t = o["c"][c][kname]
                bound_ms, by, flops, nbytes = self.bound(
                    o["rows"], o["d"], o["taps"], c, o["pad"], "float64")
                launches = self.path_launches[path][f"window_{kname}"]
                row = {"kernel": kname, "path": path,
                       "geometry": f"spiral {setup_name}, shard 0 of "
                                   f"{len(outs)}",
                       "n": o["rows"], "d": o["d"], "taps": o["taps"],
                       "c": c, "dtype": "float64", "padded": o["pad"],
                       "tiles": o["tiles"], "max_abs_err": max(
                           x["c"][c][kname]["max_abs_err"] for x in outs),
                       "rel_err": worst, "ms": t["ms"],
                       "plain_ms": t["plain_ms"], "bound_ms": bound_ms,
                       "bound_by": by, "flops": flops, "bytes": nbytes,
                       "launches": launches,
                       "launches_per_rank": self.path_launches[path][
                           "per_rank"], "library_ms": None}
                self.record["times"].append(row)
                self.slice_records.append(row)
                log(f"[dist] {kname:6s} {path} shard 0 of {len(outs)} "
                    f"({o['rows']} rows, d={o['d']}, C={c}): {t['ms']:.4f} "
                    f"ms  bound {bound_ms:.4f} ms ({by}, "
                    f"{100 * bound_ms / t['ms']:.2f}% of bound)  plain "
                    f"{t['plain_ms']:.3f} ms; rel vs plain on every rank's "
                    f"shard <= {worst:.2e} (tol {tol:g}); {launches} "
                    f"launches on the path (all ranks)")
        self.record["dist"].setdefault("tile_plan_ms", {})[path] = \
            o["tile_plan_ms"]
        log(f"[dist] {path}: tile plan of shard 0 ({o['rows']} rows, "
            f"{o['tiles']} tiles) {o['tile_plan_ms']:.3f} ms (host clock, "
            "rank 0 alone)")

    def dist_eigsh(self, pool, mode, mesh, axes):
        outs = pool.run(dist_eigsh_case, N_MAIN, "SETUP_3", mode, mesh, axes)
        self.dist_add_launches("dist_eigsh", outs)
        gap = max(o["gap"] for o in outs)
        same = len({o["digest"] for o in outs}) == 1
        check(gap <= DIST_EIG_TOL, f"[dist] eigsh {mode} {mesh}: eigenvalues "
              f"{gap:.3e} from the single-device eigsh")
        check(same, f"[dist] eigsh {mode} {mesh}: ranks differ")
        self.record["dist"].setdefault("eigsh", []).append(
            {"mode": mode, "mesh": list(mesh), "gap": gap, "same": same,
             "s_per_rank": [o["s"] for o in outs],
             "single_s": outs[0]["single_s"] / 1e3})
        log(f"[dist] eigsh k={K_EIG} {DUR_ITERS} steps, n={N_MAIN} SETUP_3, "
            f"{mode} mesh {mesh}: max |eigenvalue - single-device| "
            f"{gap:.3e} (limit {DIST_EIG_TOL:g}), bitwise equal on "
            f"{len(outs)} ranks; {max(o['s'] for o in outs):.3f} s vs "
            f"single-device {outs[0]['single_s'] / 1e3:.3f} s; top "
            f"{[round(v, 6) for v in outs[0]['top']]}")

    def dist_compress(self, pool):
        outs = pool.run(dist_compress_case)
        worst = max(o["err"] / o["bound"] for o in outs)
        check(worst <= 1.0, f"[dist] compress_psum: {worst:.3f} of its bound")
        check(all(o["resid_equal"] for o in outs),
              "[dist] compress_psum: a residual differs from "
              "compress_decompress")
        check(len({o["digest"] for o in outs}) == 1,
              "[dist] compress_psum: the means differ between ranks")
        self.record["dist"]["compress"] = {"err_over_bound": worst,
                                           "traffic": outs[0]["traffic"]}
        log(f"[dist] compress_psum {DIST_COMPRESS_SHAPE} float32 over "
            f"{len(outs)} ranks: max |mean - exact| = {worst:.3f} of "
            "max|g|/127*1.01, residuals equal compress_decompress's, means "
            f"bitwise equal; payload {outs[0]['traffic']}")

    def serve_burst(self, registry, burst, chaos=None):
        G = self.graph
        engine = G.GraphServeEngine(registry, slots=GS_SLOTS, chunk=GS_CHUNK,
                                    chaos=chaos)
        reqs = [G.PredictRequest(uid=i, model_id=mid, query_points=q)
                for i, (mid, q) in enumerate(burst)]
        for r in reqs:
            engine.submit(r)
        engine.run_until_drained()
        self.sync()
        check(all(r.done and r.error is None for r in reqs),
              f"serve: {[r.error for r in reqs if r.error]}")
        return reqs, engine

    def durable_journal_and_chaos(self, work):
        """A journaled registry of [graph_serve]'s two uniform tenants,
        dropped and rebuilt by recover_registry; then dropped ticks."""
        torch, D, J, F = self.torch, self.durable, self.journal, self.faults
        models = self.gs_tenants
        jpath = str(work / "registry.journal")
        registry = self.graph.GraphModelRegistry(
            journal=J.RegistryJournal(jpath))
        for mid, model in models.items():
            registry.register(mid, model)
        registry._journal.close()
        burst = graph_serve_burst(np.random.default_rng(GS_SEED + 7), None,
                                  "uniform")
        with D.deterministic():
            before, _ = self.serve_burst(registry, burst)
        del registry
        self.sync()
        t0 = time.perf_counter()
        recovered, report = J.recover_registry(jpath)
        self.sync()
        t_rec = time.perf_counter() - t0
        check(report.clean and report.tenants == {
            mid: "recovered" for mid in models}, report.summary())
        self.reset_launches()
        with D.deterministic():
            after, engine = self.serve_burst(recovered, burst)
        launches = self.read_launches("durable_journal")
        gap = max(float(np.abs(a.output - b.output).max())
                  for a, b in zip(after, before))
        same = all(np.array_equal(a.output, b.output)
                   for a, b in zip(after, before))
        stats = recovered.stats()
        log(f"[durable] journal: {report.summary()} in {t_rec:.3f}s; "
            f"{len(after)} requests served again: max |after - before| "
            f"{gap:.3e} (limit 1e-12), bitwise equal under the switch: "
            f"{same}; replans {engine.counters['replans']}, plan builds "
            f"{stats['plan_builds']}; launches {launches}")
        check(same and gap <= 1e-12, f"journal warm restart: {gap:.3e}")
        check(engine.counters["replans"] == 0 and stats["plan_builds"] == 1,
              f"journal warm restart: {engine.counters}, {stats}")
        # dropped ticks on the recovered registry
        self.reset_launches()
        chaos = F.TickChaos(drop_ticks=frozenset({0, 2}))
        reqs, engine = self.serve_burst(recovered, burst, chaos)
        self.read_launches("durable_chaos")
        dropped = engine.counters["dropped_ticks"]
        log(f"[durable] chaos: drop_ticks {{0, 2}} -> dropped_ticks "
            f"{dropped}, {sum(t.dropped for t in engine.tick_log)} ticks "
            f"marked dropped, {engine.counters['ticks']} ticks")
        check(dropped == 2 and sum(t.dropped for t in engine.tick_log) == 2,
              f"chaos: {dropped} dropped ticks")
        self.graph_serve_check(reqs, models, recovered, "[durable] chaos")
        sched = F.chaos_schedule(5, ticks=200, p_drop=0.1, p_slow=0.1)
        same = (tuple(sorted(sched.drop_ticks)) == JAX_CHAOS_DROPS
                and tuple(sorted(sched.slow_ticks)) == JAX_CHAOS_SLOWS
                and set(sched.slow_ticks.values()) == {0.002})
        log(f"[durable] chaos_schedule(5, ticks=200, p_drop=0.1, p_slow=0.1)"
            f" equals the JAX package's: {same}")
        check(same, "chaos_schedule differs from the JAX package's")
        self.record["durable_journal"] = {
            "recover_s": t_rec, "gap": gap, "bitwise": same,
            "plan_builds": stats["plan_builds"],
            "replans": engine.counters["replans"],
            "dropped_ticks": dropped, "launches": launches}
        self.det_path_record(
            "durable_journal", f"uniform N={GS_N_BANDWIDTH} m={GS_M} n={GS_N_TRAIN}",
            recovered.group_of("tenant0").pred.plan,
            recovered.group_of("tenant0").pred.src_window, min(GS_SLOTS, 8))

    def serve_prompts(self, cfg):
        """SERVE_REQUESTS seeded prompts, lengths in 512..2048 with one of
        exactly 2048 and one of 1000."""
        rng = np.random.default_rng(SERVE_SEED)
        lengths = [2048, 1000] + rng.integers(
            512, 2049, SERVE_REQUESTS - 2).tolist()
        return [rng.integers(0, cfg.vocab_size, n).tolist() for n in lengths]

    def watch_logits(self, model):
        """Count, on the card, the non-finite logits the model's forwards
        return; returns the counters.  ``unwatch`` restores the model."""
        torch = self.torch
        seen = {"bad": torch.zeros((), dtype=torch.int64, device=self.dev),
                "n": 0}
        for name in ("forward_prefill", "forward_decode"):
            def wrapped(*a, _orig=getattr(model, name), **kw):
                logits, caches = _orig(*a, **kw)
                seen["bad"] += (~torch.isfinite(logits)).sum()
                seen["n"] += logits.numel()
                return logits, caches
            setattr(model, name, wrapped)
        return seen

    @staticmethod
    def unwatch(model):
        for name in ("forward_prefill", "forward_decode"):
            delattr(model, name)

    def serve(self, cfg, model, prompts):
        """The prompts through a fresh ServeEngine; (requests, wall s)."""
        engine = self.ServeEngine(cfg, model, slots=SERVE_SLOTS,
                                  max_seq=SERVE_MAX_SEQ, device=self.dev)
        reqs = [self.Request(uid=i, tokens=p, max_new_tokens=SERVE_NEW)
                for i, p in enumerate(prompts)]
        for r in reqs:
            check(engine.submit(r), f"request {r.uid} refused")
        t0 = time.perf_counter()
        engine.run_until_drained()
        self.sync()
        wall = time.perf_counter() - t0
        check(all(r.done and r.error is None
                  and len(r.output) == SERVE_NEW for r in reqs),
              "serve: a request did not finish with all its tokens")
        return reqs, wall

    def manual_greedy(self, cfg, model, prompt):
        """Unbatched prefill + decode; (tokens, top-2 margin / |top| per
        step)."""
        torch, lm = self.torch, self.lm
        caches = lm.init_caches(cfg, 1, SERVE_MAX_SEQ, device=self.dev)
        logits, caches = model.forward_prefill(
            {"tokens": torch.as_tensor([prompt], device=self.dev)}, caches)
        logits = logits[0, -1]
        out, margins, pos = [], [], len(prompt)
        for _ in range(SERVE_NEW):
            top = torch.topk(logits.float(), 2).values
            margins.append(float((top[0] - top[1]) / top[0].abs()))
            out.append(int(torch.argmax(logits)))
            if len(out) == SERVE_NEW:
                break
            logits, caches = model.forward_decode(
                torch.as_tensor([[out[-1]]], device=self.dev),
                torch.as_tensor([pos], device=self.dev), caches)
            logits = logits[0, 0]
            pos += 1
        return out, margins

    def flash_vs_einsum(self, cfg, model, prompt):
        """max |flash - einsum| / max |einsum| of one prefill's logits."""
        torch, lm = self.torch, self.lm
        toks = torch.as_tensor([prompt], device=self.dev)
        logits = {}
        for flag in (True, False):
            caches = lm.init_caches(cfg, 1, len(prompt), device=self.dev)
            logits[flag] = model.forward_prefill({"tokens": toks}, caches,
                                                 use_flash=flag)[0].float()
            del caches
        return float((logits[True] - logits[False]).abs().max()
                     / logits[False].abs().max())

    def check_flash_vs_einsum(self, cfg, model, prompt, phase="serve"):
        dname = cfg.activation_dtype
        rel = self.flash_vs_einsum(cfg, model, prompt)
        self.record[phase].setdefault("flash_vs_einsum_rel", {})[dname] = rel
        limit = SERVE_FLASH_VS_EINSUM[dname]
        log(f"[{phase}] {dname} prefill of {len(prompt)} tokens, flash vs "
            f"einsum attention: rel {rel:.3e} of max |logit| (limit "
            f"{limit:g})")
        check(rel <= limit, f"{dname} flash vs einsum prefill: {rel}")

    def phase_serve(self):
        """granite-3-2b at full width and depth (bf16) through ServeEngine:
        flash launches, finite logits; then in float32 the engine against a
        manual greedy loop; one prefill in each dtype, flash vs einsum."""
        torch, lm = self.torch, self.lm
        cfg = self.get_config(SERVE_ARCH)
        t0 = time.perf_counter()
        model = lm.init_params(cfg, SERVE_SEED, device=self.dev)
        self.sync()
        t_init = time.perf_counter() - t0
        n_params = sum(p.numel() for p in model.parameters())
        prompts = self.serve_prompts(cfg)
        seen = self.watch_logits(model)
        torch.cuda.reset_peak_memory_stats(self.dev)
        self.sync()
        self.reset_launches()
        reqs, wall = self.serve(cfg, model, prompts)
        launches = self.read_launches("serve")
        self.unwatch(model)
        bad = int(seen["bad"])
        peak_gb = torch.cuda.max_memory_allocated(self.dev) / 1e9
        new_tokens = sum(len(r.output) for r in reqs)
        self.serve_launches = launches["flash_attention"]
        self.record["serve"] = {
            "arch": cfg.name, "layers": cfg.num_layers,
            "dtype": cfg.activation_dtype, "params": n_params,
            "init_s": t_init, "prompt_lengths": [len(p) for p in prompts],
            "wall_s": wall, "new_tokens": new_tokens,
            "tokens_per_s": new_tokens / wall, "nonfinite_logits": bad,
            "logits_checked": seen["n"], "peak_memory_gb": peak_gb,
            "launches": launches}
        log(f"[serve] {cfg.name} {cfg.num_layers} layers d={cfg.d_model} "
            f"hq={cfg.num_heads} hkv={cfg.num_kv_heads} "
            f"hd={cfg.head_dim_eff} {cfg.activation_dtype}: "
            f"{n_params / 1e9:.3f}e9 params (seed {SERVE_SEED}, init "
            f"{t_init:.2f}s); ServeEngine slots={SERVE_SLOTS} "
            f"max_seq={SERVE_MAX_SEQ}, {len(prompts)} requests, prompts "
            f"{[len(p) for p in prompts]}, {SERVE_NEW} new tokens each")
        log(f"[serve] {cfg.activation_dtype}: {wall:.3f}s wall (ends in "
            "synchronize), "
            f"{new_tokens} tokens, {new_tokens / wall:.1f} tok/s; peak "
            f"memory {peak_gb:.2f} GB; {seen['n']} logits, {bad} "
            f"non-finite; launches {launches}")
        check(bad == 0, f"serve: {bad} non-finite logits")
        check(launches["flash_attention"] == cfg.num_layers * len(prompts),
              f"serve: {launches['flash_attention']} flash launches for "
              f"{len(prompts)} prefills of {cfg.num_layers} layers")

        self.check_flash_vs_einsum(cfg, model, prompts[0])
        self.serve_model, self.serve_cfg = model, cfg
        self.serve_prompt_list = prompts

        # float32: engine vs manual greedy, TF32 off
        with self.tf32_off():
            cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                        activation_dtype="float32")
            model32 = lm.init_params(cfg32, SERVE_SEED, device=self.dev)
            self.check_flash_vs_einsum(cfg32, model32, prompts[0])
            self.reset_launches()
            reqs32, wall32 = self.serve(cfg32, model32, prompts)
            launches32 = self.read_launches("serve_f32")
            compared, stops = 0, []
            for r in reqs32:
                want, margins = self.manual_greedy(cfg32, model32, r.tokens)
                n = next((i for i, m in enumerate(margins)
                          if m < SERVE_MARGIN), len(margins))
                stops.append(n)
                compared += n
                check(r.output[:n] == want[:n],
                      f"f32 engine vs manual, request {r.uid}: "
                      f"{r.output[:n]} != {want[:n]}")
            del model32
        self.record["serve"]["f32"] = {
            "wall_s": wall32, "steps_compared": stops,
            "launches": launches32}
        log(f"[serve] float32 (TF32 off): engine {wall32:.3f}s; engine vs "
            f"manual prefill+decode tokens equal on {compared} of "
            f"{SERVE_NEW * len(reqs32)} steps (per request {stops}; a "
            f"request's comparison stops at its first top-2 margin under "
            f"{SERVE_MARGIN:g} of the top logit); launches {launches32}")
        check(launches32["flash_attention"] == cfg.num_layers * len(prompts),
              "serve f32: flash launches")

    def nfft_prompts(self, cfg):
        """SERVE_REQUESTS seeded prompts whose lengths are whole chunks in
        512..2048, one of exactly 2048."""
        rng = np.random.default_rng(SERVE_SEED + 1)
        lengths = [2048] + (NFFT_CHUNK * rng.integers(
            512 // NFFT_CHUNK, 2048 // NFFT_CHUNK + 1,
            SERVE_REQUESTS - 1)).tolist()
        return [rng.integers(0, cfg.vocab_size, n).tolist() for n in lengths]

    @staticmethod
    def cache_bytes(caches) -> int:
        return sum(t.numel() * t.element_size() for c in caches for t in c)

    def check_no_kernel_launches(self, launches, what):
        check(not any(launches.values()),
              f"{what}: a kernel of the package launched {launches}")

    def phase_nfft_serve(self):
        """granite-3-2b-nfft at full width and depth (bf16) through
        ServeEngine: finite logits and no kernel of the package launched
        (its transforms are cuBLAS phase matmuls); the constant-size (S, z)
        cache against granite-3-2b's KV cache; in float32 (TF32 off) the
        engine against a manual greedy loop; one 32,768-token prefill and
        decode steps on one slot; one mixer layer against the exact
        Gaussian attention in float64."""
        torch, lm = self.torch, self.lm
        card = self.record["device"]["nvidia_smi"]
        cfg = self.get_config(NFFT_ARCH)
        nc = cfg.nfft_attention
        t0 = time.perf_counter()
        model = lm.init_params(cfg, SERVE_SEED, device=self.dev)
        self.sync()
        t_init = time.perf_counter() - t0
        n_params = sum(p.numel() for p in model.parameters())
        prompts = self.nfft_prompts(cfg)
        seen = self.watch_logits(model)
        torch.cuda.reset_peak_memory_stats(self.dev)
        self.sync()
        self.reset_launches()
        engine = self.ServeEngine(cfg, model, slots=SERVE_SLOTS,
                                  max_seq=SERVE_MAX_SEQ, device=self.dev)
        reqs = [self.Request(uid=i, tokens=p, max_new_tokens=SERVE_NEW)
                for i, p in enumerate(prompts)]
        for r in reqs:
            check(engine.submit(r), f"nfft request {r.uid} refused")
        t0 = time.perf_counter()
        engine.run_until_drained()
        self.sync()
        wall = time.perf_counter() - t0
        launches = self.read_launches("nfft_serve")
        self.unwatch(model)
        check(all(r.done and r.error is None and len(r.output) == SERVE_NEW
                  for r in reqs), "nfft serve: a request did not finish")
        bad = int(seen["bad"])
        peak_gb = torch.cuda.max_memory_allocated(self.dev) / 1e9
        new_tokens = sum(len(r.output) for r in reqs)
        slot_bytes = self.cache_bytes(engine.caches) / SERVE_SLOTS
        del engine
        # granite-3-2b's KV cache for one slot, as init_caches allocates it
        dense_cfg = self.get_config(SERVE_ARCH)
        kv = {}
        for seq in (SERVE_MAX_SEQ, NFFT_LONG):
            caches = lm.init_caches(dense_cfg, 1, seq, device=self.dev)
            kv[seq] = self.cache_bytes(caches)
            del caches
        per_token = kv[SERVE_MAX_SEQ] / SERVE_MAX_SEQ
        self.record["nfft_serve"] = {
            "arch": cfg.name, "layers": cfg.num_layers,
            "dtype": cfg.activation_dtype, "params": n_params,
            "feature_dim": nc.feature_dim, "bandwidth": nc.bandwidth,
            "sigma": nc.sigma, "init_s": t_init,
            "prompt_lengths": [len(p) for p in prompts], "wall_s": wall,
            "new_tokens": new_tokens, "tokens_per_s": new_tokens / wall,
            "nonfinite_logits": bad, "logits_checked": seen["n"],
            "peak_memory_gb": peak_gb, "launches": launches,
            "cache_bytes_per_slot": slot_bytes,
            "dense_kv_bytes_per_slot": {str(k): v for k, v in kv.items()},
            "dense_kv_bytes_per_token": per_token,
            "equal_size_tokens": slot_bytes / per_token, "card": card}
        log(f"[nfft_serve] {cfg.name} {cfg.num_layers} layers d={cfg.d_model}"
            f" heads={cfg.num_heads} hd={cfg.head_dim_eff} feature_dim="
            f"{nc.feature_dim} N={nc.bandwidth} (N^d = "
            f"{nc.bandwidth ** nc.feature_dim}) sigma={nc.sigma} "
            f"{cfg.activation_dtype}: {n_params / 1e9:.3f}e9 params (seed "
            f"{SERVE_SEED}, init {t_init:.2f}s); ServeEngine slots="
            f"{SERVE_SLOTS} max_seq={SERVE_MAX_SEQ}, {len(prompts)} requests,"
            f" prompts {[len(p) for p in prompts]}, {SERVE_NEW} new tokens "
            "each")
        log(f"[nfft_serve] {card}: {wall:.3f}s wall (ends in synchronize), "
            f"{new_tokens} tokens, {new_tokens / wall:.1f} tok/s; peak "
            f"memory {peak_gb:.2f} GB; {seen['n']} logits, {bad} non-finite;"
            f" launches {launches}")
        log(f"[nfft_serve] cache per slot (allocated tensors): NFFT (S, z) "
            f"{slot_bytes / 1e6:.1f} MB at any context length; "
            f"{dense_cfg.name}'s KV cache {kv[SERVE_MAX_SEQ] / 1e6:.1f} MB at "
            f"{SERVE_MAX_SEQ} tokens, {kv[NFFT_LONG] / 1e9:.3f} GB at "
            f"{NFFT_LONG} ({per_token / 1e3:.1f} KB a token): the same size "
            f"at {slot_bytes / per_token:,.0f} tokens")
        check(bad == 0, f"nfft serve: {bad} non-finite logits")
        self.check_no_kernel_launches(launches, "nfft serve")
        check(slot_bytes == cfg.num_layers * 2 * cfg.num_heads
              * nc.bandwidth ** nc.feature_dim * (cfg.head_dim_eff + 1) * 4,
              f"nfft cache bytes per slot {slot_bytes}")

        self.nfft_long_prefill(cfg, model)
        self.nfft_layer_vs_exact(cfg, model)
        del model
        self.nfft_f32_engine_vs_manual(cfg, prompts)

    def nfft_long_prefill(self, cfg, model):
        """One PREFILL_32K-length prefill on one slot, then decode steps:
        ms, peak memory, and the cache's bytes before and after."""
        torch, lm = self.torch, self.lm
        card = self.record["device"]["nvidia_smi"]
        rng = np.random.default_rng(SERVE_SEED + 2)
        toks = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                            (1, NFFT_LONG)), device=self.dev)
        caches = lm.init_caches(cfg, 1, NFFT_LONG + NFFT_LONG_DECODE,
                                device=self.dev)
        before = self.cache_bytes(caches)
        ptrs = [t.data_ptr() for c in caches for t in c]
        torch.cuda.reset_peak_memory_stats(self.dev)
        self.reset_launches()
        self.sync()
        t0 = time.perf_counter()
        logits, caches = model.forward_prefill({"tokens": toks}, caches)
        self.sync()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        finite = bool(torch.isfinite(logits).all())
        tok = torch.argmax(logits[:, -1], dim=-1, keepdim=True)
        decode_ms = []
        for step in range(NFFT_LONG_DECODE):
            t0 = time.perf_counter()
            logits, caches = model.forward_decode(
                tok, torch.as_tensor([NFFT_LONG + step], device=self.dev),
                caches)
            tok = torch.argmax(logits[:, -1], dim=-1, keepdim=True)
            self.sync()
            decode_ms.append((time.perf_counter() - t0) * 1e3)
            finite = finite and bool(torch.isfinite(logits).all())
        launches = self.read_launches("nfft_long_prefill")
        peak_gb = torch.cuda.max_memory_allocated(self.dev) / 1e9
        after = self.cache_bytes(caches)
        same_tensors = ptrs == [t.data_ptr() for c in caches for t in c]
        self.record["nfft_serve"]["long"] = {
            "tokens": NFFT_LONG, "prefill_ms": prefill_ms,
            "decode_ms": decode_ms, "peak_memory_gb": peak_gb,
            "cache_bytes_before": before, "cache_bytes_after": after,
            "launches": launches}
        log(f"[nfft_serve] {card}: one prefill of {NFFT_LONG} tokens (b=1, "
            f"host clock ending in synchronize) {prefill_ms:.1f} ms, then "
            f"{NFFT_LONG_DECODE} decode steps {np.median(decode_ms):.2f} ms "
            f"each (median); peak memory {peak_gb:.2f} GB; cache "
            f"{before / 1e6:.1f} MB before and {after / 1e6:.1f} MB after, "
            f"the same tensors: {same_tensors}; logits finite: {finite}; "
            f"launches {launches}")
        check(finite, "nfft long prefill: non-finite logits")
        check(before == after and same_tensors,
              "nfft long prefill: the cache changed size")
        self.check_no_kernel_launches(launches, "nfft long prefill")
        del caches

    def nfft_layer_vs_exact(self, cfg, model):
        """Layer 0's mixer on seeded inputs of NFFT_EXACT_S tokens against
        the exact row-normalized Gaussian attention in float64 on the same
        features (K_RF against K), with TF32 switched on around the call
        to show that the phase matmuls keep it off."""
        torch = self.torch
        card = self.record["device"]["nvidia_smi"]
        layer = model.blocks[0].nfft
        s, h = NFFT_EXACT_S, cfg.num_heads
        gen = torch.Generator(device=self.dev).manual_seed(SERVE_SEED + 3)
        x = torch.randn((1, s, cfg.d_model), generator=gen,
                        device=self.dev).to(cfg.dtype)
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            self.reset_launches()
            out = layer.attend(x)[0].double()  # (s, h, hd)
            launches = self.read_launches("nfft_layer")
            tf32_after = torch.backends.cuda.matmul.allow_tf32
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
        qf, kf, v = (t[0].double() for t in layer.features(x))
        mask = torch.ones((s, s), dtype=torch.bool,
                          device=self.dev).tril_()
        exact = torch.empty_like(out)
        for head in range(h):
            diff = qf[:, None, head] - kf[None, :, head]
            w = torch.exp(-(diff * diff).sum(-1) / cfg.nfft_attention.sigma
                          ** 2) * mask
            exact[:, head] = (w @ v[:, head]) / w.sum(dim=1, keepdim=True)
        rel = float((out - exact).abs().max() / exact.abs().max())
        limit = NFFT_EXACT_FACTOR * JAX_NFFT_EXACT_REL
        self.record["nfft_serve"]["layer_vs_exact"] = {
            "s": s, "rel": rel, "limit": limit, "launches": launches}
        log(f"[nfft_serve] {card}: layer 0's mixer, {s} tokens, {h} heads, "
            f"{cfg.activation_dtype} inputs, against the exact Gaussian "
            f"attention in float64 on the same features: max|out - exact| "
            f"/ max|exact| = {rel:.3e} (limit {NFFT_EXACT_FACTOR} x the JAX "
            f"package's {JAX_NFFT_EXACT_REL:.3e} at the reduced width); "
            f"allow_tf32 set around the call, restored after: "
            f"{tf32_after}; launches {launches}")
        check(rel <= limit, f"nfft layer vs exact: {rel:.3e} > {limit:.3e}")
        check(tf32_after, "nfft layer: the caller's TF32 setting was lost")
        self.check_no_kernel_launches(launches, "nfft layer")

    def nfft_f32_engine_vs_manual(self, cfg, prompts):
        """float32 (TF32 off): the engine's tokens against an unbatched
        prefill + decode loop; no kernel may launch."""
        launches32 = self.f32_engine_vs_manual("nfft_serve", cfg, prompts)
        self.check_no_kernel_launches(launches32, "nfft serve f32")

    # -- [train] -------------------------------------------------------------
    def phase_train(self):
        """[train]: granite-3-2b at full width and depth for TRAIN_STEPS
        steps through run_resilient; kill-and-resume, the compressed step
        and the NFFT learn_sigma step at full width with 2 layers.  No
        kernel of the package may launch: training runs the einsum
        attention (the flash kernel has no backward) and cuBLAS products."""
        from repro_torch.data import pipeline
        from repro_torch.dist import compression
        from repro_torch.launch.train import batch_on
        from repro_torch.training import fault_tolerance, train_loop
        from repro_torch.training.optimizer import OptimizerConfig
        from repro_torch import tree
        torch = self.torch
        self.pipe, self.comp, self.tl = pipeline, compression, train_loop
        self.ft, self.tree, self.batch_on = fault_tolerance, tree, batch_on
        self.OptimizerConfig = OptimizerConfig
        # [serve]'s model stayed for [times], the window geometries for
        # [times]' kernels; release them
        self.serve_model = None
        self.geometries.clear()
        gc_collect(torch)
        self.sync()
        log(f"[train] memory at the phase's start: "
            f"{torch.cuda.memory_allocated(self.dev) / 1e9:.2f} GB allocated,"
            f" {torch.cuda.memory_reserved(self.dev) / 1e9:.2f} GB reserved")
        t0 = time.perf_counter()
        self.record["train"] = {}
        self.train_full()
        self.train_resume()
        self.train_compressed()
        self.train_nfft_learn_sigma()
        self.record["train"]["phase_s"] = time.perf_counter() - t0
        log(f"[train] phase {self.record['train']['phase_s']:.1f}s wall")

    def phase_train_families(self):
        """[train_families]: olmoe-1b-7b (the router, 64 experts at top-8
        and the aux loss), mamba2-1.3b (the chunked SSD scan's backward)
        and deepseek-v3-671b (MLA's backward, the MTP loss and its
        combiner, Adafactor's factored update) through [train]'s
        single-card step at full width (FAMILY_TRAIN's cuts), each freed
        before the next.  Every parameter leaf must move, the loss on step
        0's batch must fall, the aux and MTP losses must be finite and
        positive, and no kernel of the package may launch (the einsum
        attention; the flash kernel has no backward)."""
        torch = self.torch
        gc_collect(torch)
        self.sync()
        log(f"[train_families] memory at the phase's start: "
            f"{torch.cuda.memory_allocated(self.dev) / 1e9:.2f} GB allocated,"
            f" {torch.cuda.memory_reserved(self.dev) / 1e9:.2f} GB reserved")
        t0 = time.perf_counter()
        self.record["train_families"] = {}
        # deepseek-v3's step frees and takes its 8-GiB float32 attention
        # logits (128 heads x 4,096^2) by turns: in fixed segments the
        # freed blocks do not fit the next (16 GB reserved but unallocated
        # at 55 GB allocated, then out of memory); expandable segments map
        # the pages anew
        torch.cuda.memory._set_allocator_settings("expandable_segments:True")
        try:
            for arch, layers in FAMILY_TRAIN:
                self.train_family(arch, layers)
                gc_collect(torch)
        finally:
            torch.cuda.memory._set_allocator_settings(
                "expandable_segments:False")
        took = self.record["train_families"]["phase_s"] = \
            time.perf_counter() - t0
        log(f"[train_families] phase {took:.1f}s wall")

    def family_flops(self, cfg, tokens, seq):
        """Model FLOPs of one step of ``cfg``: 6 per active parameter that
        multiplies a token (the top-k and shared experts of an MoE layer;
        not an untied input embedding, which is a lookup; the MTP depths'
        combiner, block and head again) plus the sequence mixers' own
        products, forward and backward: 6 h (qk + v) s a token and
        attention layer (the causal square counted whole, as the einsum
        computes it), 6 H (Q n + Q p + 2 n p) a token and Mamba layer (the
        chunked SSD's four products)."""
        d, v = cfg.d_model, cfg.vocab_size
        n = cfg.active_param_count()
        if not cfg.tie_embeddings:
            n -= v * d
        layer = dataclasses.replace(cfg, num_layers=1, mtp_depth=0)
        per_layer = layer.active_param_count() - v * d * (
            1 if layer.tie_embeddings else 2)
        n += cfg.mtp_depth * (per_layer + 2 * d * d + v * d)
        mix = 0
        for i in list(range(cfg.num_layers)) + [cfg.num_layers - 1] * \
                cfg.mtp_depth:
            if cfg.is_attention_layer(i):
                if cfg.mla is not None:
                    m = cfg.mla
                    width = (m.qk_nope_head_dim + m.qk_rope_head_dim
                             + m.v_head_dim)
                else:
                    width = 2 * cfg.head_dim_eff
                mix += 6 * cfg.num_heads * width * seq
            elif cfg.mamba is not None:
                mc = cfg.mamba
                q, heads = min(mc.chunk_size, seq), mc.expand * d // mc.head_dim
                mix += 6 * heads * (q * mc.d_state + q * mc.head_dim
                                    + 2 * mc.d_state * mc.head_dim)
        return (6 * n + mix) * tokens

    def train_family(self, arch, layers):
        """One FAMILY_TRAIN family: FAMILY_TRAIN_STEPS steps of TRAIN_BATCH
        x 4,096 tokens through run_resilient (no checkpoint) and the
        Prefetcher, and its checks."""
        torch = self.torch
        card = self.record["device"]["nvidia_smi"]
        uncut = self.get_config(arch)
        cfg = uncut if layers is None else dataclasses.replace(
            uncut, num_layers=layers)
        shape = self.train_shape(cfg, TRAIN_BATCH)
        tc = self.train_config(uncut, FAMILY_TRAIN_STEPS,
                               num_microbatches=TRAIN_MICRO)
        torch.cuda.reset_peak_memory_stats(self.dev)
        t0 = time.perf_counter()
        state = self.tl.init_train_state(cfg, tc, TRAIN_SEED,
                                         device=self.dev)
        self.sync()
        t_init = time.perf_counter() - t0
        model = state.params
        n_params = sum(p.numel() for p in model.parameters())
        state_gb = torch.cuda.memory_allocated(self.dev) / 1e9
        step_fn = self.tl.make_train_step(cfg, tc)
        batch0 = self.batch_on(self.pipe.batch_for_step(cfg, shape, 0,
                                                        seed=TRAIN_SEED),
                               self.dev)
        # the steps' metrics over two microbatches hold the loss alone: the
        # aux and MTP losses come from the forward on step 0's batch
        with torch.no_grad():
            loss_before, fwd = model.forward_train(batch0)
        fwd = [{k: float(v) for k, v in fwd.items()}]
        loss_before = float(loss_before)
        names = [n for n, _ in model.named_parameters()]
        before = [p.detach().to("cpu", copy=True)
                  for p in model.parameters()]
        times, metrics = [], []

        def timed_step(st, batch):
            self.sync()
            t = time.perf_counter()
            st, m = step_fn(st, batch)
            self.sync()
            times.append(time.perf_counter() - t)
            metrics.append({k: float(v) for k, v in m.items()})
            return st, m

        self.reset_launches()
        pf = self.pipe.Prefetcher(cfg, shape, seed=TRAIN_SEED)
        try:
            state, info = self.ft.run_resilient(
                timed_step, state,
                lambda s: self.batch_on(pf.get(s), self.dev),
                total_steps=FAMILY_TRAIN_STEPS, ckpt_dir=None,
                log_every=10 ** 9)
        finally:
            pf.close()
        launches = self.read_launches(f"train_families {arch}")
        still = [n for n, p, old in zip(names, model.parameters(), before)
                 if torch.equal(p.detach(), old.to(self.dev))]
        del before
        with torch.no_grad():
            loss_after, after = model.forward_train(batch0)
        fwd.append({k: float(v) for k, v in after.items()})
        loss_after = float(loss_after)
        peak_gb = torch.cuda.max_memory_allocated(self.dev) / 1e9
        median = float(np.median(times))
        tokens = TRAIN_BATCH * shape.seq_len
        flops = self.family_flops(cfg, tokens, shape.seq_len)
        share = flops / (median * PEAK_BF16_TENSOR)
        self.record["train_families"][arch] = {
            "layers": cfg.num_layers, "uncut_layers": uncut.num_layers,
            "mtp_depth": cfg.mtp_depth, "dtype": cfg.param_dtype,
            "params": n_params, "optimizer": tc.optimizer.name,
            "batch": TRAIN_BATCH, "microbatches": TRAIN_MICRO,
            "seq": shape.seq_len, "init_s": t_init, "state_gb": state_gb,
            "step_s": times, "median_step_s": median,
            "tokens_per_s": tokens / median, "model_flops_per_step": flops,
            "model_flops_share": share, "metrics": metrics,
            "loss_step0_batch": [loss_before, loss_after],
            "step0_batch_metrics": fwd,
            "peak_memory_gb": peak_gb, "launches": launches,
            "host_copy": info["initial_copy"], "card": card}
        cut = (f"depth {uncut.num_layers} -> {cfg.num_layers}"
               if layers is not None else f"full depth {cfg.num_layers}")
        log(f"[train_families] {arch} full width ({cut}"
            + (f", MTP {cfg.mtp_depth}" if cfg.mtp_depth else "")
            + f"), {cfg.param_dtype}: {n_params / 1e9:.3f}e9 params (seed "
            f"{TRAIN_SEED}), {tc.optimizer.name} (TrainConfig.for_arch of "
            f"the uncut config), state {state_gb:.2f} GB after init "
            f"({t_init:.2f}s); {FAMILY_TRAIN_STEPS} steps of {TRAIN_BATCH} x "
            f"{shape.seq_len} tokens ({TRAIN_MICRO} microbatches) through "
            "run_resilient + Prefetcher")
        for i, m in enumerate(metrics):
            log(f"[train_families] {arch} step {i}: loss {m['loss']:.5f} "
                f"grad_norm {m['grad_norm']:.5f} lr {m['lr']:.3e} "
                f"{times[i]:.3f}s")
        log(f"[train_families] {arch} ({card}): median step {median:.4f}s "
            f"(host clock, ends in synchronize; first {times[0]:.3f}s), "
            f"{tokens / median:.1f} tok/s; model FLOPs {flops / 1e12:.1f} "
            f"TFLOP a step (family_flops), {100 * share:.2f}% of the "
            f"{PEAK_BF16_TENSOR / 1e12:.0f} TFLOP/s bf16 dense peak; peak "
            f"memory {peak_gb:.2f} GB; launches {launches}")
        wanted = {"aux_loss": any(cfg.is_moe_layer(i)
                                  for i in range(cfg.num_layers)),
                  "mtp_loss": cfg.mtp_depth > 0}
        extra = "".join(
            f"; {k} {fwd[0][k]:.5f} before, {fwd[1][k]:.5f} after"
            for k in wanted if wanted[k])
        log(f"[train_families] {arch}: loss on step 0's batch "
            f"{loss_before:.5f} before, {loss_after:.5f} after "
            f"{FAMILY_TRAIN_STEPS} steps{extra}; parameters that moved "
            f"{len(names) - len(still)} of {len(names)}")
        check(all(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])
                  for m in metrics),
              f"train_families {arch}: a non-finite loss or grad_norm")
        check(info["steps"] == FAMILY_TRAIN_STEPS and info["restarts"] == 0,
              f"train_families {arch}: {info['steps']} steps, "
              f"{info['restarts']} restarts")
        check(not still, f"train_families {arch}: parameters that did not "
              f"move: {still[:8]}")
        check(loss_after < loss_before, f"train_families {arch}: loss on "
              f"step 0's batch {loss_before} -> {loss_after}")
        for key in wanted:
            if wanted[key]:
                vals = [m[key] for m in fwd]
                check(all(math.isfinite(x) and x > 0 for x in vals),
                      f"train_families {arch}: {key} {vals}")
        check(peak_gb < 80.0, f"train_families {arch}: peak {peak_gb} GB")
        self.check_no_kernel_launches(launches, f"train_families {arch}")
        del state, model, step_fn, batch0

    def phase_shard_train(self):
        """[shard_train]: the sharded train step over torch.distributed
        (ZeRO-3: each rank holds its blocks of the state, gathers a block's
        weights on use and reduce-scatters their gradients; the ranks of
        "model" each compute their block of the heads, hidden units,
        experts and vocabulary).  (a) SHARD_WORLD gloo ranks on cuda:0,
        granite-3-2b at full width with SHARD_LAYERS layers, float32, on
        meshes SHARD_MESHES, and olmoe-1b-7b at full width with
        SHARD_MOE_LAYERS layers at SHARD_MOE_MESH, against the
        single-device step on the card: losses within SHARD_TOL, grad_norm
        within SHARD_TOL relative, unsplit leaves bitwise equal on the
        ranks, each rank's bytes of state equal to the rules' blocks, each
        step's collective bytes beside shard_prediction's ((4, 1)'s equal
        to the storage-only step's, none over "model"), each rank's
        forward matmul FLOPs equal to shard_flops, peak GB beside
        SHARD_PEAK_PRED; (b) a checkpoint written at (4, 1) restored onto
        (2, 2) and onto one device, the next step's loss within SHARD_TOL
        of continuing at (4, 1); (c) one NCCL rank at (1, 1), full width
        and depth, bf16, beside [train]'s step.  No kernel of the package
        may launch on these paths."""
        import shutil
        import tempfile
        from repro_torch.launch.ranks import RankPool
        torch = self.torch
        card = self.record["device"]["nvidia_smi"]
        gc_collect(torch)
        t0 = time.perf_counter()
        rec = self.record["shard_train"] = {"card": card}
        cfg = shard_case_config()
        moe_cfg = shard_case_config(SHARD_MOE_ARCH)
        tc = shard_train_config(1)
        pred = {m: shard_prediction(m, SHARD_MICRO[m]) for m in SHARD_MESHES}
        pred[SHARD_MOE_ARCH] = shard_prediction(
            SHARD_MOE_MESH, SHARD_MICRO[SHARD_MOE_MESH], SHARD_MOE_ARCH)
        ref = {n: self.shard_single(cfg, shard_train_config(n))
               for n in sorted(set(SHARD_MICRO.values()))}
        ref_moe = self.shard_single(
            moe_cfg, shard_train_config(SHARD_MICRO[SHARD_MOE_MESH]))
        (ROOT / "build").mkdir(exist_ok=True)
        save_dir = tempfile.mkdtemp(prefix="shard_ckpt_", dir=ROOT / "build")
        try:
            with RankPool(SHARD_WORLD, "gloo", "cuda:0") as pool:
                log(f"[shard_train] {SHARD_WORLD} gloo ranks on cuda:0 "
                    f"({card}), {cfg.name} d={cfg.d_model} ff={cfg.d_ff} "
                    f"V={cfg.vocab_size}, depth cut 40 -> {SHARD_LAYERS}, "
                    f"float32, AdamW, {SHARD_BATCH} x 4,096 tokens (batch "
                    "256 cut): times are four processes time-sharing the "
                    "card with gloo staging every collective through the "
                    "host; not scaling numbers")
                runs = {}
                for m in SHARD_MESHES:
                    runs[m] = pool.run(shard_train_case, m,
                                       save_dir if m == (4, 1) else None)
                    self.shard_parity(m, runs[m], ref[SHARD_MICRO[m]],
                                      pred[m], cfg)
                moe = pool.run(shard_train_case, SHARD_MOE_MESH, None,
                               SHARD_MOE_ARCH)
                self.shard_parity(SHARD_MOE_MESH, moe, ref_moe,
                                  pred[SHARD_MOE_ARCH], moe_cfg,
                                  SHARD_MOE_ARCH)
                moved = pool.run(shard_resume_case, (2, 2), save_dir)
            one = self.shard_restore_single(cfg, tc, save_dir)
        finally:
            shutil.rmtree(save_dir, ignore_errors=True)
        self.shard_elastic(runs[(4, 1)], moved, one)
        with RankPool(1, "nccl", "cuda:0") as pool:
            full = pool.run(shard_full_case)[0]
        self.shard_full_report(full)
        rec["s"] = time.perf_counter() - t0
        log(f"[shard_train] phase {rec['s']:.1f}s wall ({card}; two spawns "
            "of ranks included)")

    def shard_single(self, cfg, tc):
        """The single-device step on the card from the same seeded state
        and batches, SHARD_STEPS steps; freed after."""
        torch = self.torch
        state = self.tl.init_train_state(cfg, tc, TRAIN_SEED, device=self.dev)
        step = self.tl.make_train_step(cfg, tc)
        metrics, times = [], []
        for s in range(SHARD_STEPS):
            batch = shard_batch(cfg, SHARD_BATCH, s, self.dev)
            self.sync()
            t = time.perf_counter()
            state, m = step(state, batch)
            self.sync()
            times.append(time.perf_counter() - t)
            metrics.append({k: float(v) for k, v in m.items()})
        del state, step
        gc_collect(torch)
        self.record["shard_train"][
            f"single_{cfg.name}_{tc.num_microbatches}"] = {
            "metrics": metrics, "step_s": times}
        log(f"[shard_train] single-device step on the card "
            f"({self.record['device']['nvidia_smi']}, {cfg.name} "
            f"{cfg.num_layers} layers, {tc.num_microbatches} "
            f"microbatches): loss "
            f"{[round(m['loss'], 6) for m in metrics]}, grad_norm "
            f"{[round(m['grad_norm'], 6) for m in metrics]}, "
            f"{[round(t, 3) for t in times]} s")
        return metrics

    def shard_parity(self, mesh, outs, ref, pred, cfg, arch=TRAIN_ARCH):
        card = self.record["device"]["nvidia_smi"]
        name = f"{arch} {mesh}"
        first = outs[0]
        for s in range(SHARD_STEPS):
            got, want = first["metrics"][s], ref[s]
            check(all(o["metrics"][s] == got for o in outs),
                  f"shard_train {name}: step {s}'s metrics differ by rank")
            check(abs(got["loss"] - want["loss"]) <= SHARD_TOL,
                  f"shard_train {name}: step {s} loss {got['loss']} vs "
                  f"single-device {want['loss']}")
            check(abs(got["grad_norm"] - want["grad_norm"])
                  <= SHARD_TOL * want["grad_norm"],
                  f"shard_train {name}: step {s} grad_norm "
                  f"{got['grad_norm']} vs {want['grad_norm']}")
        check(all(o["digests"] == first["digests"] for o in outs),
              f"shard_train {name}: unsplit leaves differ between ranks")
        check(all(o["bytes"]["held"] == o["bytes"]["rules"] == pred["bytes"]
                  for o in outs),
              f"shard_train {name}: bytes of state "
              f"{[o['bytes'] for o in outs]} vs the rules' {pred['bytes']}")
        check(all(t == first["traffic"][0] for o in outs
                  for t in o["traffic"]),
              f"shard_train {name}: traffic differs by step or rank")
        over_model = sorted(k for k in first["traffic_axes"][0]
                            if "model" in k.split("@")[1])
        if mesh[1] == 1:
            check(first["traffic"][0] == SHARD_TRAFFIC_4x1 and not over_model,
                  f"shard_train {name}: traffic {first['traffic'][0]} "
                  f"(over model: {over_model}) vs the storage rules' "
                  f"{SHARD_TRAFFIC_4x1}")
        else:
            check(bool(over_model), f"shard_train {name}: no collective "
                  "over model")
        check(first["traffic"][0] == pred["traffic"],
              f"shard_train {name}: traffic a step a rank "
              f"{first['traffic'][0]} vs shard_prediction's "
              f"{pred['traffic']}")
        for o in outs:
            self.check_no_kernel_launches(o["launches"], f"shard_train {name}")
        rows = SHARD_BATCH // SHARD_MICRO[mesh] // mesh[0]
        single = shard_single_flops(cfg, rows)
        check(single == shard_flops(cfg, rows, 1, 0),
              f"shard_train {name}: single-device forward {single} FLOPs vs "
              f"the formula's {shard_flops(cfg, rows, 1, 0)}")
        want = [shard_flops(cfg, rows, mesh[1], o["model_index"])
                for o in outs]
        check([o["flops"] for o in outs] == want,
              f"shard_train {name}: forward FLOPs a rank "
              f"{[o['flops'] for o in outs]} vs the formula's {want}")
        errs = [abs(first["metrics"][s]["loss"] - ref[s]["loss"])
                for s in range(SHARD_STEPS)]
        peak = max(o["peak_gb"] for o in outs)
        self.record["shard_train"][name] = {
            "metrics": first["metrics"], "loss_err": errs,
            "step_s": [o["step_s"] for o in outs],
            "init_s": [o["init_s"] for o in outs],
            "host_copy": first["host_copy"], "save_s": first["save_s"],
            "bytes": first["bytes"], "traffic": first["traffic"][0],
            "traffic_axes": first["traffic_axes"][0],
            "predicted": pred, "peak_gb": [o["peak_gb"] for o in outs],
            "peak_pred_gb": SHARD_PEAK_PRED[arch if arch != TRAIN_ARCH
                                            else mesh],
            "flops": [o["flops"] for o in outs], "flops_single": single,
            "traffic_per_rank": [o["traffic"][0] for o in outs],
            "traffic_axes_per_rank": [o["traffic_axes"][0] for o in outs],
            "launches": first["launches"]}
        log(f"[shard_train] {name} ({card}), {SHARD_MICRO[mesh]} "
            f"microbatches: loss "
            f"{[round(m['loss'], 6) for m in first['metrics']]} (single-"
            f"device within {max(errs):.2e}; bound {SHARD_TOL}), the same on "
            f"every rank; unsplit leaves bitwise equal on the ranks "
            f"({len(first['digests'])} leaves)")
        held, full = first["bytes"]["held"], first["bytes"]["full"]
        log(f"[shard_train] {name} ({card}): state a rank {held} B = "
            f"the rules' blocks {pred['bytes']} B; unsharded {full} B "
            f"({full / held:.2f}x)")
        log(f"[shard_train] {name} ({card}): traffic a step a rank "
            f"(operand bytes by kind) {first['traffic'][0]} = predicted "
            f"{pred['traffic']}; by kind@axes {first['traffic_axes'][0]}")
        log(f"[shard_train] {name} ({card}): forward matmul FLOPs of one "
            f"microbatch a rank {[o['flops'] for o in outs]} = shard_flops "
            f"{want}; single-device on the same {rows} rows {single} "
            f"({single / max(want):.3f}x a rank's)")
        times = [round(t, 3) for t in first["step_s"]]
        copy = first["host_copy"]
        log(f"[shard_train] {name} ({card}): step {times} s (rank 0, "
            f"every rank starting together, host clock ending in a sync), "
            f"init {first['init_s']:.1f}s, peak {peak:.2f} GB a rank "
            f"(predicted {self.record['shard_train'][name]['peak_pred_gb']}"
            f" GB)"
            + ("" if copy is None else
               f"; run_resilient's host copy {copy['bytes']} B a rank in "
               f"{copy['seconds']:.2f}s (MemAvailable "
               f"{copy['mem_available']} B)")
            + ("" if first["save_s"] is None else
               f"; sharded save after step {SHARD_SAVE_AT} "
               f"{first['save_s']:.1f}s"))

    def phase_shard_serve(self):
        """[shard_serve]: the sharded prefill and decode steps
        (launch.steps.ShardedServeStep) on SHARD_WORLD gloo ranks sharing
        cuda:0, SERVE_SHARD_CASES at full width, float32: each rank holds
        its blocks of the weights (``param_specs(serve_replicated=...)``,
        stored once in their compute layout over "model")
        and its rows' caches, and computes its block of the heads (prefill:
        the flash kernel on them; decode: its block of the cache
        positions), hidden units and experts.  Every rank's whole logits of
        the prefill and of SERVE_SHARD_DECODES decode steps within
        SERVE_SHARD_TOL of the largest logit of the port's single-device
        steps on the card, bitwise equal on the ranks; flash launched once a
        layer on every rank in the prefill; the counters and step times
        recorded for [dryrun].  The flash kernel is held against its plain
        version and timed at each case's per-rank shape."""
        from repro_torch.launch.ranks import RankPool
        torch = self.torch
        card = self.record["device"]["nvidia_smi"]
        gc_collect(torch)
        t0 = time.perf_counter()
        self.record["shard_serve"] = {"card": card}
        singles = {arch: self.shard_serve_single(arch)
                   for arch in dict.fromkeys(a for a, _, _ in
                                             SERVE_SHARD_CASES)}
        with RankPool(SHARD_WORLD, "gloo", "cuda:0") as pool:
            log(f"[shard_serve] {SHARD_WORLD} gloo ranks on cuda:0 ({card}), "
                f"float32, full width, {SERVE_SHARD_ROWS} x "
                f"{SERVE_SHARD_PROMPT}-token prefill (PREFILL_32K's 32 x "
                f"32,768 cut) + {SERVE_SHARD_DECODES} decode steps: times "
                "are four processes time-sharing the card with gloo staging "
                "every collective through the host; not scaling numbers")
            for arch, layers, mesh in SERVE_SHARD_CASES:
                outs = pool.run(shard_serve_case, arch, mesh)
                self.shard_serve_parity(arch, mesh, outs, singles[arch])
        for arch, layers, mesh in SERVE_SHARD_CASES:
            self.shard_serve_flash(arch, mesh)
        self.record["shard_serve"]["s"] = time.perf_counter() - t0
        log(f"[shard_serve] phase {self.record['shard_serve']['s']:.1f}s "
            f"wall ({card}; a spawn of ranks included)")

    def shard_serve_single(self, arch):
        """The port's single-device prefill and decode steps of
        shard_serve_config(arch) on the card, on [shard_serve]'s seeded
        weights and tokens: the logits of every step, and its times."""
        torch, lm = self.torch, self.lm
        cfg = shard_serve_config(arch)
        model = lm.init_params(cfg, SERVE_SEED, device=self.dev)
        caches = lm.init_caches(cfg, SERVE_SHARD_ROWS, SERVE_SHARD_PROMPT
                                + SERVE_SHARD_DECODES, device=self.dev)
        prompt, tokens = shard_serve_tokens(cfg)
        self.sync()
        t = time.perf_counter()
        logits, caches = model.forward_prefill(
            {"tokens": torch.as_tensor(prompt, device=self.dev)}, caches)
        self.sync()
        times = [time.perf_counter() - t]
        out = [logits.cpu().numpy()]
        for i in range(SERVE_SHARD_DECODES):
            pos = torch.full((SERVE_SHARD_ROWS,), SERVE_SHARD_PROMPT + i,
                             dtype=torch.int32, device=self.dev)
            t = time.perf_counter()
            logits, caches = model.forward_decode(
                torch.as_tensor(tokens[:, i:i + 1], device=self.dev), pos,
                caches)
            self.sync()
            times.append(time.perf_counter() - t)
            out.append(logits.cpu().numpy())
        del model, caches, logits
        gc_collect(torch)
        return {"logits": np.stack(out), "step_s": times}

    def shard_serve_parity(self, arch, mesh, outs, single):
        card = self.record["device"]["nvidia_smi"]
        cfg = shard_serve_config(arch)
        name = f"{arch} {mesh}"
        want = single["logits"]
        scale = float(np.abs(want).max())
        errs = [float(np.abs(o["logits"] - want).max()) / scale for o in outs]
        check(all(np.all(np.isfinite(o["logits"])) for o in outs),
              f"shard_serve {name}: non-finite logits")
        check(max(errs) <= SERVE_SHARD_TOL, f"shard_serve {name}: logits "
              f"{errs} of the largest from the single-device steps' (limit "
              f"{SERVE_SHARD_TOL:g})")
        check(all(np.array_equal(o["logits"], outs[0]["logits"])
                  for o in outs), f"shard_serve {name}: ranks differ")
        flash = [o["launches_prefill"]["flash_attention"] for o in outs]
        check(flash == [cfg.num_layers] * len(outs),
              f"shard_serve {name}: flash launches a rank {flash}, want "
              f"{cfg.num_layers} (one a layer, on the rank's heads)")
        others = [(k, v) for o in outs for k, v in
                  list(o["launches_prefill"].items())
                  + list(o["launches_decode"].items())
                  if v and k != "flash_attention"]
        check(not others and all(o["launches_decode"]["flash_attention"] == 0
                                 for o in outs),
              f"shard_serve {name}: other launches {others}")
        for o in outs:
            check(all(d["traffic"] == o["decode"][0]["traffic"]
                      for d in o["decode"]),
                  f"shard_serve {name}: decode traffic differs by step")
        if mesh[1] > 1:
            check(any(k.endswith("@model") for k in
                      outs[0]["prefill"]["traffic_axes"]),
                  f"shard_serve {name}: no collective over model")
        path = f"shard_serve {name}"
        self.path_launches[path] = {
            "window_spread": 0, "window_spread_deterministic": 0,
            "window_gather": 0, "kernel_matvec": 0,
            "flash_attention": sum(flash), "per_rank": flash}
        first = outs[0]
        self.record["shard_serve"][name] = {
            "layers": cfg.num_layers, "rel_err": errs,
            "replicated": first["replicated"],
            "prefill": [o["prefill"] for o in outs],
            "decode": [o["decode"][0] for o in outs],
            "prefill_s": [o["prefill_s"] for o in outs],
            "decode_s": [o["decode_s"] for o in outs],
            "single_s": single["step_s"], "launches_prefill": flash,
            "peak_gb": [o["peak_gb"] for o in outs],
            "model_index": [o["model_index"] for o in outs]}
        dec = [round(t, 4) for t in first["decode_s"]]
        split = "model only" if first["replicated"] else "FSDP and model"
        log(f"[shard_serve] {name} ({card}), {cfg.num_layers} layers, "
            f"weights split over {split}, in their compute layout: "
            f"logits within {max(errs):.2e} of the largest single-device "
            f"logit (limit {SERVE_SHARD_TOL:g}) on every rank, bitwise equal "
            f"on the {len(outs)} ranks; flash launches a rank {flash}")
        log(f"[shard_serve] {name} ({card}): prefill {first['prefill_s']:.3f}"
            f" s, decode {dec} s (rank 0, host clock, every rank starting "
            f"together, ending in a sync); single-device prefill "
            f"{single['step_s'][0]:.3f} s, decode "
            f"{[round(t, 4) for t in single['step_s'][1:]]} s; peak "
            f"{max(o['peak_gb'] for o in outs):.2f} GB a rank")
        log(f"[shard_serve] {name} ({card}): prefill traffic a rank "
            f"{first['prefill']['traffic']} by kind@axes "
            f"{first['prefill']['traffic_axes']}, matmul FLOPs a rank "
            f"{[o['prefill']['flops'] for o in outs]}; decode step traffic "
            f"{first['decode'][0]['traffic']}, matmul FLOPs "
            f"{[o['decode'][0]['flops'] for o in outs]}")

    def shard_serve_flash(self, arch, mesh):
        """The flash kernel at [shard_serve]'s per-rank prefill shape (its
        block of the heads, its rows), float32: against its plain version,
        its time, plain time, bound, ceiling and SDPA's time."""
        torch, fa = self.torch, self.fa
        cfg = shard_serve_config(arch)
        m = mesh[1]
        rows = SERVE_SHARD_ROWS // mesh[0]
        hq = cfg.num_heads // m  # and the kv heads they read
        hkv = cfg.num_kv_heads // m if cfg.num_kv_heads % m == 0 else max(
            1, hq * cfg.num_kv_heads // cfg.num_heads)
        shape = (rows, hq, hkv, SERVE_SHARD_PROMPT, SERVE_SHARD_PROMPT,
                 cfg.head_dim_eff)
        err, share, finite = self.flash_reading(shape, True, "float32",
                                                sum(shape))
        check(share <= 1.0 and finite, f"shard_serve flash {shape}: {err:.3e}"
              f", {share:.3f} of the limit")
        q, k, v = self.flash_inputs(*shape, torch.float32, sum(shape))
        ms = self.time_ms(lambda: fa.flash_attention(q, k, v, causal=True),
                          reps=10, warmup=1)
        plain_ms = self.time_ms(
            lambda: fa.flash_attention_plain(q, k, v, causal=True), reps=3,
            warmup=1)
        lib_ms = self.tfl.sdpa_ms(q, k, v, True, reps=10)
        bound_ms, by, flops, nbytes = self.flash_bound(*shape, True,
                                                       "float32")
        ceiling = self.rl.tf32_split_ceiling_ms(flops)
        path = f"shard_serve {arch} {mesh}"
        row = {"kernel": "flash_attention", "path": path, "b": rows,
               "hq": hq, "hkv": hkv, "sq": shape[3], "sk": shape[4],
               "dh": shape[5], "causal": True, "dtype": "float32",
               "design": fa.design(torch.float32, shape[5]),
               "max_abs_err": err, "limit_share": share, "ms": ms,
               "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": by,
               "ceiling_ms": ceiling, "flops": flops, "bytes": nbytes,
               "library_ms": lib_ms,
               "launches": self.path_launches[path]["flash_attention"]}
        self.record["times"].append(row)
        self.shard_serve_rows.append(row)
        log(f"[shard_serve] flash_attention {path} b={rows} hq={hq} "
            f"hkv={hkv} s={shape[3]} dh={shape[5]} causal float32 "
            f"({row['design']}; {self.record['device']['nvidia_smi']}): "
            f"max_abs_err {err:.3e} ({share:.3f} of the limit); "
            f"{ms:.4f} ms  bound {bound_ms:.4f} ms ({by}, "
            f"{100 * bound_ms / ms:.2f}% of bound; ceiling {ceiling:.4f} ms, "
            f"{100 * ceiling / ms:.1f}%)  plain {plain_ms:.3f} ms  "
            f"{self.sdpa_text(ms, lib_ms)}; "
            f"{row['launches']} launches on the path (all ranks)")
        del q, k, v

    def phase_dryrun(self):
        """[dryrun]: the dry run (launch.dryrun: the port's steps traced as
        one rank of a described mesh on meta, no card, no process group)
        against the counters and clocks of the live runs before it.  (a)
        every rank of [shard_train]'s cells: operand bytes by kind, by
        (kind, axes) and "wire" equal to the card's, forward matmul FLOPs
        equal to the card's FlopCounterMode reading and to shard_flops,
        bytes of state equal, peak live bytes within DRY_PEAK_TOL of the
        card's peak; (b) every [dist] case: rank 0's traffic equal, its
        payload by kind printed; (c) every rank of [shard_serve]'s cells:
        the prefill's and a decode step's traffic and matmul FLOPs equal,
        flash counted once a layer; (d) the roofline terms of the single-card
        paths ([train]'s step, [times]' prefill and tick, the main path's
        fused matvec) as shares of their measured times, none over
        DRY_SHARE_MAX; (e) granite-3-2b's production cells and the graph
        cells at 8 to 512 ranks, every one ok.  The traces run on
        SHARD_WORLD CPU ranks side by side."""
        from repro_torch.launch import dryrun
        from repro_torch.launch.ranks import RankPool
        card = self.record["device"]["nvidia_smi"]
        t0 = time.perf_counter()
        rec = self.record["dryrun"] = {"card": card}
        train_cells = [(TRAIN_ARCH, m) for m in SHARD_MESHES] + [
            (SHARD_MOE_ARCH, SHARD_MOE_MESH)]
        serve_cells = [(a, m) for a, _, m in SERVE_SHARD_CASES]
        jobs = ([("train",), ("prefill",), ("tick",), ("matvec", "SETUP_2"),
                 ("matvec", "SETUP_3")]
                + [("lm", TRAIN_ARCH, s, multi) for s in DRY_LM_SHAPES
                   for multi in (False, True)]
                + [("graph", m, mode, bank) for m in DRY_GRAPH_MESHES
                   for mode in ("psum", "pencil")
                   for bank in (1, DRY_GRAPH_BANK)]
                + [("ceil", arch, r) for arch, ranks in DRY_CEIL_CELLS
                   for r in ranks])
        # the slow traces (a full-depth train step) spread first
        cost = {"train": 12, "lm": 3, "prefill": 3, "tick": 3, "ceil": 8}
        by_rank = [[] for _ in range(SHARD_WORLD)]
        load = [0.0] * SHARD_WORLD
        for job in sorted(jobs, key=lambda j: -(
                12 if j[:3] == ("lm", TRAIN_ARCH, "train_4k")
                else cost.get(j[0], 0.5))):
            r = load.index(min(load))
            by_rank[r].append(job)
            load[r] += (12 if job[:3] == ("lm", TRAIN_ARCH, "train_4k")
                        else cost.get(job[0], 0.5))
        with RankPool(SHARD_WORLD, "gloo", "cpu", threads=1) as pool:
            train = {c: pool.run(dryrun_train_case, *c) for c in train_cells}
            serve = {c: pool.run(dryrun_serve_case, *c) for c in serve_cells}
            ran = pool.run(dryrun_jobs, by_rank)
        done = {name: (r, took) for outs in ran for name, r, took in outs}
        rank_s = [sum(took for _, _, took in outs) for outs in ran]
        self.dryrun_train(train)
        self.dryrun_dist(dryrun)
        self.dryrun_serve(serve)
        self.dryrun_shares(done)
        self.dryrun_production(done)
        self.dryrun_ceil(done)
        rec["s"] = time.perf_counter() - t0
        log(f"[dryrun] phase {rec['s']:.1f}s wall ({SHARD_WORLD} CPU ranks "
            f"tracing side by side, a spawn included; the ranks' jobs "
            f"{[round(t, 1) for t in rank_s]} s)")

    def dryrun_train(self, train):
        card = self.record["device"]["nvidia_smi"]
        rows_out = {}
        for (arch, mesh), outs in train.items():
            name = f"{arch} {mesh}"
            got = self.record["shard_train"][name]
            cfg = shard_case_config(arch)
            rows = SHARD_BATCH // SHARD_MICRO[mesh] // mesh[0]
            peaks = []
            for r, o in enumerate(outs):
                check(o["traffic"] == got["traffic_per_rank"][r],
                      f"dryrun {name} rank {r}: traffic {o['traffic']} vs "
                      f"the card's {got['traffic_per_rank'][r]}")
                check(o["traffic_axes"] == got["traffic_axes_per_rank"][r],
                      f"dryrun {name} rank {r}: traffic by axes "
                      f"{o['traffic_axes']} vs the card's "
                      f"{got['traffic_axes_per_rank'][r]}")
                want = shard_flops(cfg, rows, mesh[1], r % mesh[1])
                check(o["forward_flops"] == got["flops"][r] == want,
                      f"dryrun {name} rank {r}: forward FLOPs "
                      f"{o['forward_flops']} vs the card's {got['flops'][r]} "
                      f"and shard_flops {want}")
                check(o["state_bytes"] == got["bytes"]["held"],
                      f"dryrun {name} rank {r}: state {o['state_bytes']} B vs "
                      f"the card's {got['bytes']['held']} B")
                peak = o["memory"]["peak_bytes"] / 1e9
                peaks.append(peak)
                check(abs(peak - got["peak_gb"][r])
                      <= DRY_PEAK_TOL * got["peak_gb"][r],
                      f"dryrun {name} rank {r}: peak {peak:.2f} GB vs the "
                      f"card's {got['peak_gb'][r]:.2f} GB")
            rows_out[name] = {"peak_gb": peaks, "card_peak_gb": got["peak_gb"],
                              "stats": outs[0]["stats"],
                              "memory": outs[0]["memory"]}
            off = ", ".join(f"{100 * (p / c - 1):+.1f}%"
                            for p, c in zip(peaks, got["peak_gb"]))
            log(f"[dryrun] (a) {name}: every rank's traffic by kind, by "
                f"kind@axes and wire, forward matmul FLOPs "
                f"{[o['forward_flops'] for o in outs]} and state "
                f"{outs[0]['state_bytes']} B equal the card's ({card}) to the "
                f"byte; peak live bytes a rank "
                f"{[round(p, 2) for p in peaks]} GB vs measured "
                f"{[round(p, 2) for p in got['peak_gb']]} GB "
                f"({off}; "
                f"limit {DRY_PEAK_TOL:.0%}: meta storages hold no allocator "
                "slack, no cuBLAS or gloo workspace)")
        self.record["dryrun"]["train"] = rows_out

    def dryrun_dist(self, dryrun):
        card = self.record["device"]["nvidia_smi"]
        ops = {}
        rows = []
        for c in self.record["dist"]["cases"]:
            key = (c["kind"], c["n"], c["setup"])
            if key not in ops:
                ops[key] = dryrun.meta_fastsum(
                    c["setup"].lower().replace("_", ""), c["n"], 3,
                    bank_size=len(BANK_SIGMAS) if c["kind"] == "bank" else 1)
            split = None if c["split"] is None else tuple(
                tuple(a) for a in c["split"])
            out = dryrun.trace_matvec(ops[key], tuple(c["shape"]),
                                      dry_mesh(tuple(c["mesh"])), rank=0,
                                      spectral_mode=c["mode"],
                                      pencil_axes=split)
            got = dict(out["mesh"].traffic)
            what = (f"{c['kind']} n={c['n']} {c['setup']} {c['mode']} mesh "
                    f"{tuple(c['mesh'])}"
                    + (f" split {split}" if split else "")
                    + f" x {tuple(c['shape'])}")
            check(got == c["traffic_rank0"], f"dryrun (b) {what}: rank 0's "
                  f"traffic {got} vs the card's {c['traffic_rank0']}")
            by_kind = {}
            for kind, operand, axes, g, _ in out["collectives"]:
                by_kind[kind] = by_kind.get(kind, 0) + \
                    self.rl.payload_bytes(kind, operand, g)
            rows.append({"case": what, "traffic": got,
                         "payload_by_kind": by_kind,
                         "payload": out["stats"].collective_payload_bytes})
        self.record["dryrun"]["dist"] = rows
        log(f"[dryrun] (b) every one of [dist]'s {len(rows)} cases (n = 10^5 "
            f"and 10^6, the bank, float64): rank 0's operand bytes by kind "
            f"and wire equal the card's ({card}) to the byte; payload by "
            "kind: " + "; ".join(f"{r['case']} {r['payload_by_kind']}"
                                 for r in rows[:6]) + " ...")

    def dryrun_serve(self, serve):
        card = self.record["device"]["nvidia_smi"]
        for (arch, mesh), outs in serve.items():
            name = f"{arch} {mesh}"
            got = self.record["shard_serve"][name]
            cfg = shard_serve_config(arch)
            for r, o in enumerate(outs):
                for kind in ("prefill", "decode"):
                    want = got[kind][r]
                    for key in ("traffic", "traffic_axes", "flops"):
                        check(o[kind][key] == want[key],
                              f"dryrun (c) {name} rank {r} {kind}: {key} "
                              f"{o[kind][key]} vs the card's {want[key]}")
                fl = o["prefill"]["kernels"].get("flash_attention", {})
                check(fl.get("launches") == cfg.num_layers
                      == got["launches_prefill"][r],
                      f"dryrun (c) {name} rank {r}: flash {fl} vs the card's "
                      f"{got['launches_prefill'][r]} launches")
            self.record["dryrun"][f"serve {name}"] = {
                k: outs[0][k]["stats"] for k in ("prefill", "decode")}
            log(f"[dryrun] (c) {name}: every rank's prefill and decode-step "
                f"traffic by kind, by kind@axes and wire and matmul FLOPs "
                f"equal the card's ({card}); flash {cfg.num_layers} launches "
                f"a rank in both, its work {fl['flops']:.3e} FLOPs a rank "
                "(data-sheet bound, not measured)")

    def dryrun_shares(self, done):
        """(d): each single-card path's roofline terms (data-sheet peaks)
        as shares of its measured time."""
        card = self.record["device"]["nvidia_smi"]
        serve_row = next(r for r in self.record["times"] if "serve" in r
                         and "tick_ms" in r)
        measured = {
            "train": self.record["train"]["full"]["median_step_s"],
            "prefill": serve_row["prefill_ms"][max(FLASH_LENGTHS)] / 1e3,
            "tick": serve_row["tick_ms"] / 1e3}
        for setup_name in ("SETUP_2", "SETUP_3"):
            row = next(r for r in self.record["times"]
                       if r.get("setup") == setup_name
                       and r.get("n") == N_MAIN and "matvec_ms_c1" in r)
            measured[f"matvec/{setup_name}"] = row["matvec_ms_c1"] / 1e3
        shares = {}
        for name, t in measured.items():
            roof = done[name][0]["roofline"]
            sh = {term: roof[f"{term}_s"] / t
                  for term in ("compute", "memory", "collective")}
            shares[name] = {"measured_s": t, "roofline": roof, "shares": sh}
            log(f"[dryrun] (d) {name}: measured {t * 1e3:.3f} ms ({card}); "
                f"roofline (H100 SXM data-sheet peaks, not measured) compute "
                f"{roof['compute_s'] * 1e3:.3f} ms = {100 * sh['compute']:.1f}%"
                f", memory {roof['memory_s'] * 1e3:.3f} ms = "
                f"{100 * sh['memory']:.1f}%, collective "
                f"{roof['collective_s'] * 1e3:.3f} ms = "
                f"{100 * sh['collective']:.1f}% of the measured time; "
                f"{roof['flops']:.3e} FLOPs, {roof['bytes_accessed']:.3e} B")
            check(max(sh.values()) <= DRY_SHARE_MAX,
                  f"dryrun (d) {name}: a roofline term is "
                  f"{100 * max(sh.values()):.1f}% of the measured time")
        self.record["dryrun"]["shares"] = shares

    def dryrun_production(self, done):
        """(e): granite-3-2b's production cells and the graph cells."""
        cells = {n: r for n, (r, _) in done.items()
                 if n.startswith(("lm/", "graph/"))}
        for name, r in cells.items():
            check(r["status"] == "ok", f"dryrun (e) {name}: {r['status']} "
                  f"{r.get('error', '')}")
            st, roof = r["stats"], r["roofline"]
            log(f"[dryrun] (e) {r['arch']} x {r['shape']} @ {r['mesh']} "
                f"({r.get('spectral_mode_effective', r['kind'])}): a rank "
                f"{st['flops']:.3e} FLOPs, {st['hbm_bytes']:.3e} B HBM, "
                f"{st['collective_bytes']:.3e} B collective (payload "
                f"{st['collective_payload_bytes']:.3e} B, DCI "
                f"{st['dci_bytes']:.3e} B); roofline (data-sheet peaks) "
                f"compute {roof['compute_s']:.3e} s, memory "
                f"{roof['memory_s']:.3e} s, collective "
                f"{roof['collective_s']:.3e} s: {roof['dominant']}; peak "
                f"live {r['memory']['peak_bytes']:.3e} B a rank")
        self.record["dryrun"]["production"] = cells

    def dryrun_ceil(self, done):
        """(f): DRY_CEIL_CELLS, each rank's attention FLOPs of its ceil
        block of the heads.  The ranks of a cell differ only in attention
        (16 divides the hidden units and the vocabulary), so a rank's
        matmul FLOPs over those of the cell's last rank named (no heads)
        must be its heads' by the formula: per head and layer q, k, v and
        ``wo`` (one kv head a q head's block reads) and the causal-square
        attention, in the forward, the remat recompute and the backward."""
        from repro_torch.configs import get_config
        from repro_torch.launch.mesh import block_range
        from repro_torch.training.train_loop import TrainConfig
        rows = {}
        for arch, ranks in DRY_CEIL_CELLS:
            cfg = get_config(arch)
            shape = next(s for s in cfg.shapes if s.name == "train_4k")
            tc = TrainConfig.for_arch(cfg)
            t = shape.global_batch // 16 * shape.seq_len
            d, hd = cfg.d_model, cfg.head_dim_eff
            head = cfg.num_layers * (3 + tc.remat) * (
                4 * 2 * t * d * hd + 2 * 2 * t * shape.seq_len * hd)
            recs = {r: done[f"ceil/{arch}/{r}"][0] for r in ranks}
            empty = recs[ranks[-1]]["stats"]["matmul_flops"]
            for r, rec in recs.items():
                check(rec["status"] == "ok" and rec["whole_parts"] == [],
                      f"dryrun (f) {arch} rank {r}: {rec['status']} "
                      f"{rec.get('whole_parts')} {rec.get('error', '')}")
                lo, hi = block_range(cfg.num_heads, 16, r)
                got = rec["stats"]["matmul_flops"] - empty
                check(got == (hi - lo) * head,
                      f"dryrun (f) {arch} rank {r}: attention FLOPs {got} vs "
                      f"{hi - lo} heads' {(hi - lo) * head}")
                rows[f"{arch} rank {r}"] = {
                    "heads": hi - lo, "flops": rec["stats"]["flops"],
                    "matmul_flops": rec["stats"]["matmul_flops"],
                    "attention_flops": got,
                    "peak_bytes": rec["memory"]["peak_bytes"]}
                log(f"[dryrun] (f) {arch} x train_4k @ 16x16 rank {r}: "
                    f"{hi - lo} of {cfg.num_heads} heads (ceil blocks), "
                    f"{rec['stats']['flops']:.4e} FLOPs a rank, attention "
                    f"{got:.4e} = {hi - lo} x {head:.4e} a head; peak live "
                    f"{rec['memory']['peak_bytes']:.3e} B; computed whole: "
                    "none")
        self.record["dryrun"]["ceil"] = rows

    def shard_restore_single(self, cfg, tc, save_dir):
        """The sharded checkpoint restored into the single-device state,
        then the next step: its loss."""
        from repro_torch.training import checkpoint
        torch = self.torch
        like = self.tl.init_train_state(cfg, tc, TRAIN_SEED + 1,
                                        device=self.dev)
        state = checkpoint.restore_checkpoint(save_dir, SHARD_SAVE_AT, like)
        at = int(state.step)
        check(at == SHARD_SAVE_AT, f"shard_train: restored step {at}")
        _, m = self.tl.make_train_step(cfg, tc)(
            state, shard_batch(cfg, SHARD_BATCH, at, self.dev))
        loss = float(m["loss"])
        del state, like, m
        gc_collect(torch)
        return loss

    def shard_elastic(self, outs, moved, one):
        card = self.record["device"]["nvidia_smi"]
        cont = outs[0]["metrics"][SHARD_SAVE_AT]["loss"]
        got = [o["metrics"]["loss"] for o in moved]
        check(all(o["step"] == SHARD_SAVE_AT for o in moved),
              "shard_train: restored step")
        errs = [abs(g - cont) for g in got + [one]]
        check(max(errs) <= SHARD_TOL,
              f"shard_train: elastic restore losses {got} (2, 2), {one} one "
              f"device vs {cont} continuing at (4, 1)")
        self.record["shard_train"]["elastic"] = {
            "continue": cont, "mesh_2x2": got, "one_device": one,
            "restore_s": [o["restore_s"] for o in moved]}
        log(f"[shard_train] elastic restore ({card}): step "
            f"{SHARD_SAVE_AT + 1}'s loss {cont:.6f} continuing at (4, 1); "
            f"restored onto (2, 2) {got[0]:.6f}, onto one device {one:.6f}: "
            f"within {max(errs):.2e} (bound {SHARD_TOL}); each rank read its "
            f"blocks in {max(o['restore_s'] for o in moved):.1f}s")

    def shard_full_report(self, full):
        card = self.record["device"]["nvidia_smi"]
        self.check_no_kernel_launches(full["launches"], "shard_train (1, 1)")
        check(all(math.isfinite(m["loss"]) for m in full["metrics"]),
              "shard_train (1, 1): a non-finite loss")
        check(full["traffic"] == {}, f"shard_train (1, 1): traffic "
              f"{full['traffic']} on a mesh of one rank")
        median = float(np.median(full["step_s"]))
        tokens = TRAIN_BATCH * 4096
        train = self.record.get("train", {}).get("full", {})
        self.record["shard_train"]["full"] = dict(full, median_step_s=median,
                                                  tokens_per_s=tokens / median)
        log(f"[shard_train] (1, 1), one NCCL rank ({card}): {TRAIN_ARCH} "
            f"{full['layers']} layers bf16, {TRAIN_BATCH} x 4,096 tokens in "
            f"{TRAIN_MICRO} microbatches: steps {[round(t, 4) for t in full['step_s']]} s "
            f"(median {median:.4f}s, {tokens / median:.1f} tok/s; [train]'s "
            f"median {train.get('median_step_s', float('nan')):.4f}s), loss "
            f"{[round(m['loss'], 5) for m in full['metrics']]}, state "
            f"{full['state_gb']:.2f} GB after init ({full['init_s']:.1f}s), "
            f"peak {full['peak_gb']:.2f} GB; no collective; launches "
            f"{full['launches']}")

    def train_config(self, cfg, steps, **kw):
        """launch/train.py's settings: the optimizer TrainConfig.for_arch
        picks, peak lr TRAIN_LR, warmup max(steps // 20, 5)."""
        name = self.tl.TrainConfig.for_arch(cfg).optimizer.name
        opt = self.OptimizerConfig(name=name, peak_lr=TRAIN_LR,
                                   total_steps=steps,
                                   warmup_steps=max(steps // 20, 5))
        return self.tl.TrainConfig(optimizer=opt, **kw)

    def train_shape(self, cfg, batch):
        shape = next(s for s in cfg.shapes if s.name == "train_4k")
        return dataclasses.replace(shape, global_batch=batch)

    def train_flops(self, cfg, n_params, tokens, seq):
        """Model FLOPs of one step: 6 P per token (forward and backward
        of every parameter's multiply-add) plus the attention's 12 L h hd
        s per token (QK^T and PV, forward and backward; the causal square
        counted whole, as the einsum computes it)."""
        attn = 12 * cfg.num_layers * cfg.num_heads * cfg.head_dim_eff * seq
        return (6 * n_params + attn) * tokens

    def train_full(self):
        """(a) granite-3-2b, 40 layers, bf16, AdamW, TRAIN_STEPS steps of
        TRAIN_BATCH x 4,096 tokens through run_resilient (no checkpoint:
        the state is ~35 GB) and the Prefetcher."""
        torch, lm = self.torch, self.lm
        card = self.record["device"]["nvidia_smi"]
        cfg = self.get_config(TRAIN_ARCH)
        shape = self.train_shape(cfg, TRAIN_BATCH)
        tc = self.train_config(cfg, TRAIN_STEPS,
                               num_microbatches=TRAIN_MICRO)
        torch.cuda.reset_peak_memory_stats(self.dev)
        t0 = time.perf_counter()
        state = self.tl.init_train_state(cfg, tc, TRAIN_SEED,
                                         device=self.dev)
        self.sync()
        t_init = time.perf_counter() - t0
        model = state.params
        n_params = sum(p.numel() for p in model.parameters())
        state_gb = torch.cuda.memory_allocated(self.dev) / 1e9
        step_fn = self.tl.make_train_step(cfg, tc)
        batch0 = self.batch_on(self.pipe.batch_for_step(cfg, shape, 0,
                                                        seed=TRAIN_SEED),
                               self.dev)
        with torch.no_grad():
            loss_before = float(model.forward_train(batch0)[0])
        names = [n for n, _ in model.named_parameters()]
        before = [p.detach().to("cpu", copy=True)
                  for p in model.parameters()]
        times, metrics = [], []
        moved = {}

        def timed_step(st, batch):
            self.sync()
            t = time.perf_counter()
            st, m = step_fn(st, batch)
            self.sync()
            times.append(time.perf_counter() - t)
            metrics.append({k: float(v) for k, v in m.items()})
            if len(times) == 1:
                for name, p, old in zip(names, model.parameters(), before):
                    moved[name] = not torch.equal(p.detach(),
                                                  old.to(self.dev))
            return st, m

        self.reset_launches()
        pf = self.pipe.Prefetcher(cfg, shape, seed=TRAIN_SEED)
        try:
            t0 = time.perf_counter()
            state, info = self.ft.run_resilient(
                timed_step, state,
                lambda s: self.batch_on(pf.get(s), self.dev),
                total_steps=TRAIN_STEPS, ckpt_dir=None, log_every=10 ** 9)
            wall = time.perf_counter() - t0
        finally:
            pf.close()
        launches = self.read_launches("train")
        del before
        with torch.no_grad():
            loss_after = float(model.forward_train(batch0)[0])
        peak_gb = torch.cuda.max_memory_allocated(self.dev) / 1e9
        median = float(np.median(times))
        tokens = TRAIN_BATCH * shape.seq_len
        flops = self.train_flops(cfg, n_params, tokens, shape.seq_len)
        share = flops / (median * PEAK_BF16_TENSOR)
        self.record["train"]["full"] = {
            "arch": cfg.name, "layers": cfg.num_layers,
            "dtype": cfg.param_dtype, "params": n_params,
            "optimizer": tc.optimizer.name, "batch": TRAIN_BATCH,
            "microbatches": TRAIN_MICRO, "seq": shape.seq_len,
            "init_s": t_init, "state_gb": state_gb, "step_s": times,
            "median_step_s": median, "tokens_per_s": tokens / median,
            "model_flops_per_step": flops, "model_flops_share": share,
            "metrics": metrics, "loss_step0_batch": [loss_before,
                                                     loss_after],
            "peak_memory_gb": peak_gb, "launches": launches,
            "wall_s": wall, "card": card}
        log(f"[train] {cfg.name} {cfg.num_layers} layers d={cfg.d_model} "
            f"hq={cfg.num_heads} hkv={cfg.num_kv_heads} d_ff={cfg.d_ff} "
            f"V={cfg.vocab_size} {cfg.param_dtype}: {n_params / 1e9:.3f}e9 "
            f"params (seed {TRAIN_SEED}), {tc.optimizer.name}, state "
            f"{state_gb:.2f} GB after init ({t_init:.2f}s); "
            f"{TRAIN_STEPS} steps of {TRAIN_BATCH} x {shape.seq_len} tokens "
            f"({TRAIN_MICRO} microbatches; TRAIN_4K's batch 256 cut to "
            f"{TRAIN_BATCH}) through run_resilient + Prefetcher")
        for i, m in enumerate(metrics):
            log(f"[train] step {i}: loss {m['loss']:.5f} grad_norm "
                f"{m['grad_norm']:.5f} lr {m['lr']:.3e} {times[i]:.3f}s")
        log(f"[train] {card}: median step {median:.4f}s (host clock, ends in "
            f"synchronize; first {times[0]:.3f}s), {tokens / median:.1f} "
            f"tok/s; model FLOPs (6 P + 12 L h hd s) x tokens = "
            f"{flops / 1e12:.1f} TFLOP a step, {100 * share:.2f}% of the "
            f"{PEAK_BF16_TENSOR / 1e12:.0f} TFLOP/s bf16 dense peak; peak "
            f"memory {peak_gb:.2f} GB; launches {launches}")
        copy = info["initial_copy"]
        self.record["train"]["full"]["host_copy"] = copy
        log(f"[train] run_resilient's replay target (no checkpoint "
            f"directory): a host copy of the initial state, {copy['bytes']} B "
            f"in {copy['seconds']:.2f}s before the first step (outside the "
            f"step times), MemAvailable {copy['mem_available']} B before it")
        log(f"[train] loss on step 0's batch: {loss_before:.5f} before, "
            f"{loss_after:.5f} after {TRAIN_STEPS} steps; parameters moved "
            f"by step 1: {sum(moved.values())} of {len(moved)}")
        check(all(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])
                  for m in metrics), "train: a non-finite loss or grad_norm")
        check(info["steps"] == TRAIN_STEPS and info["restarts"] == 0,
              f"train: {info['steps']} steps, {info['restarts']} restarts")
        check(all(moved.values()), "train: parameters that did not move in "
              f"step 1: {[n for n, v in moved.items() if not v][:8]}")
        check(loss_after < loss_before,
              f"train: loss on step 0's batch {loss_before} -> {loss_after}")
        self.check_no_kernel_launches(launches, "train")
        del state, model, step_fn, batch0
        gc_collect(torch)

    def train_short_cfg(self, name, **nfft):
        cfg = dataclasses.replace(self.get_config(name),
                                  num_layers=TRAIN_SHORT_LAYERS)
        if nfft:
            cfg = dataclasses.replace(cfg, nfft_attention=dataclasses.replace(
                cfg.nfft_attention, **nfft))
        return cfg

    def train_resume(self):
        """(b) full width, 2 layers: TRAIN_RESUME_STEPS steps with a
        checkpoint every TRAIN_RESUME_EVERY and an InjectedFault at
        TRAIN_FAULT_STEP, under the deterministic switch; the final loss
        and every leaf of the state equal the uninterrupted run's, bit
        for bit."""
        import shutil
        torch = self.torch
        cfg = self.train_short_cfg(TRAIN_ARCH)
        shape = self.train_shape(cfg, TRAIN_BATCH)
        tc = self.train_config(cfg, TRAIN_RESUME_STEPS,
                               num_microbatches=TRAIN_MICRO)
        batch_fn = lambda s: self.batch_on(self.pipe.batch_for_step(
            cfg, shape, s, seed=TRAIN_SEED), self.dev)
        fired = {"done": False}

        def fault_hook(s):
            if s == TRAIN_FAULT_STEP and not fired["done"]:
                fired["done"] = True
                raise self.ft.InjectedFault("simulated node failure")

        runs, walls, ckpt_bytes = [], [], 0
        with self.durable.deterministic():
            for name, hook in (("ref", None), ("ft", fault_hook)):
                directory = self.ckpt_dir(f"train_{name}")
                try:
                    t0 = time.perf_counter()
                    runs.append(self.ft.run_resilient(
                        self.tl.make_train_step(cfg, tc),
                        self.tl.init_train_state(cfg, tc, TRAIN_SEED,
                                                 device=self.dev),
                        batch_fn, total_steps=TRAIN_RESUME_STEPS,
                        ckpt_dir=directory, ckpt_every=TRAIN_RESUME_EVERY,
                        fault_hook=hook, log_every=10 ** 9))
                    walls.append(time.perf_counter() - t0)
                    ckpt_bytes = sum(f.stat().st_size for f in
                                     Path(directory).glob("step_*/*.npy"))
                finally:
                    shutil.rmtree(directory, ignore_errors=True)
        (ref, ref_info), (got, info) = runs
        ref_leaves = self.tree.tree_leaves(ref)
        got_leaves = self.tree.tree_leaves(got)
        unequal = sum(not torch.equal(a, b)
                      for a, b in zip(got_leaves, ref_leaves))
        loss, ref_loss = (float(info["final_metrics"]["loss"]),
                          float(ref_info["final_metrics"]["loss"]))
        self.record["train"]["resume"] = {
            "layers": cfg.num_layers, "steps": TRAIN_RESUME_STEPS,
            "ckpt_every": TRAIN_RESUME_EVERY, "fault_step": TRAIN_FAULT_STEP,
            "restarts": info["restarts"], "wall_s": walls,
            "checkpoint_bytes_on_disk": ckpt_bytes, "leaves":
            len(ref_leaves), "unequal_leaves": unequal,
            "final_loss": [ref_loss, loss]}
        log(f"[train] kill-and-resume, {cfg.name} at full width with "
            f"{cfg.num_layers} layers, {TRAIN_RESUME_STEPS} steps, a "
            f"checkpoint every {TRAIN_RESUME_EVERY}, a fault at step "
            f"{TRAIN_FAULT_STEP}, deterministic switch on: uninterrupted "
            f"{walls[0]:.2f}s, resumed {walls[1]:.2f}s ({info['restarts']} "
            f"restart; {ckpt_bytes / 1e9:.2f} GB of checkpoints on disk); "
            f"final loss {ref_loss!r} / {loss!r}; {unequal} of "
            f"{len(ref_leaves)} state leaves differ")
        check(info["restarts"] == 1, "train resume: no restart")
        check(torch.equal(info["final_metrics"]["loss"],
                          ref_info["final_metrics"]["loss"]) and unequal == 0,
              f"train resume: {unequal} leaves differ, loss {loss} vs "
              f"{ref_loss}")
        del runs, ref, got, ref_leaves, got_leaves
        gc_collect(torch)

    def train_compressed(self):
        """(c) --compress-grads at full width, 2 layers, one step: the
        loss finite; each output on its block's int8 grid (an integer
        multiple q of max|block| / 127, |q| <= 127, so at most 255 values a
        block); each residual within half a quantization step of its block
        (max|block| / 254)."""
        torch, comp = self.torch, self.comp
        cfg = self.train_short_cfg(TRAIN_ARCH)
        shape = self.train_shape(cfg, TRAIN_BATCH)
        tc = self.train_config(cfg, 1, num_microbatches=TRAIN_MICRO,
                               compress_grads=True)
        state = self.tl.init_train_state(cfg, tc, TRAIN_SEED,
                                         device=self.dev)
        step = self.tl.make_train_step(cfg, tc)
        batch = self.batch_on(self.pipe.batch_for_step(
            cfg, shape, 0, seed=TRAIN_SEED), self.dev)
        self.reset_launches()
        _, _, grads = step.gradients(state.params, batch)
        totals = [g + r for g, r in zip(self.tree.tree_leaves(grads),
                                        self.tree.tree_leaves(
                                            state.ef_state.residuals))]
        out, ef = comp.apply_error_feedback(grads, state.ef_state)
        worst_bound, worst_grid, worst_q, n = 0.0, 0.0, 0.0, 0
        tiny = torch.finfo(torch.float32).tiny

        def blocked(x):
            pad = (-x.numel()) % comp.BLOCK
            return torch.nn.functional.pad(x.reshape(-1), (0, pad)).view(
                -1, comp.BLOCK)

        for o, r, t in zip(self.tree.tree_leaves(out),
                           self.tree.tree_leaves(ef.residuals), totals):
            top = blocked(t).abs().amax(dim=1, keepdim=True)
            q = blocked(o) / (top / 127.0).clamp(min=tiny)
            worst_grid = max(worst_grid, float((q - q.round()).abs().max()))
            worst_q = max(worst_q, float(q.round().abs().max()))
            ratio = blocked(r).abs() / (top / 254.0).clamp(min=tiny)
            worst_bound = max(worst_bound, float(ratio.max()))
            n += t.numel()
        del totals, out, grads
        state, metrics = step(state, batch)
        launches = self.read_launches("train_compressed")
        loss = float(metrics["loss"])
        self.record["train"]["compressed"] = {
            "layers": cfg.num_layers, "elements": n, "loss": loss,
            "grad_norm": float(metrics["grad_norm"]),
            "worst_residual_over_bound": worst_bound,
            "worst_off_grid": worst_grid, "largest_q": worst_q,
            "launches": launches}
        log(f"[train] --compress-grads, full width, {cfg.num_layers} layers,"
            f" one step: loss {loss:.5f}, grad_norm "
            f"{float(metrics['grad_norm']):.5f}; over {n} gradient elements "
            f"the largest |residual| is {worst_bound:.6f} of its block's "
            f"max|block|/254; out / (max|block|/127) is at most "
            f"{worst_grid:.3g} from an integer, the largest |q| "
            f"{worst_q:.0f}; launches {launches}")
        check(math.isfinite(loss), "train compressed: non-finite loss")
        check(worst_bound <= 1.0 + EF_BOUND_SLACK,
              f"train compressed: a residual {worst_bound} of its bound")
        check(worst_grid <= EF_GRID_SLACK and worst_q <= 127,
              f"train compressed: an output off its block's int8 grid "
              f"(by {worst_grid}, largest |q| {worst_q})")
        self.check_no_kernel_launches(launches, "train compressed")
        del state, step
        gc_collect(torch)

    def train_nfft_learn_sigma(self):
        """(d) granite-3-2b-nfft with learn_sigma at full width, 2 layers,
        one step of 1 x 4,096 tokens (32 whole 128-token chunks): every
        gradient finite, log_sigma's nonzero, log_sigma moved, no kernel
        launched."""
        torch = self.torch
        cfg = self.train_short_cfg(NFFT_ARCH, learn_sigma=True)
        shape = self.train_shape(cfg, 1)
        tc = self.train_config(cfg, 1)
        state = self.tl.init_train_state(cfg, tc, TRAIN_SEED,
                                         device=self.dev)
        step = self.tl.make_train_step(cfg, tc)
        batch = self.batch_on(self.pipe.batch_for_step(
            cfg, shape, 0, seed=TRAIN_SEED), self.dev)
        torch.cuda.reset_peak_memory_stats(self.dev)
        self.reset_launches()
        self.sync()
        t0 = time.perf_counter()
        _, _, grads = step.gradients(state.params, batch)
        self.sync()
        t_grad = time.perf_counter() - t0
        flat = self.tree.tree_flatten_with_path(grads)
        bad = [p for p, g in flat if not bool(torch.isfinite(g).all())]
        g_sigma = grads["stack"][0]["nfft"]["log_sigma"]
        leaf = state.params.leaf_tree["stack"][0]["nfft"]["log_sigma"]
        before = leaf.detach().clone()
        del grads, flat
        state, metrics = step(state, batch)
        self.sync()
        launches = self.read_launches("train_nfft")
        peak_gb = torch.cuda.max_memory_allocated(self.dev) / 1e9
        self.record["train"]["nfft_learn_sigma"] = {
            "arch": cfg.name, "layers": cfg.num_layers, "seq": shape.seq_len,
            "loss": float(metrics["loss"]),
            "grad_norm": float(metrics["grad_norm"]),
            "log_sigma_grad": g_sigma.tolist(),
            "log_sigma": [before.tolist(), leaf.tolist()],
            "gradients_s": t_grad, "peak_memory_gb": peak_gb,
            "nonfinite_leaves": bad, "launches": launches}
        log(f"[train] {cfg.name} learn_sigma, full width, {cfg.num_layers} "
            f"layers, 1 x {shape.seq_len} tokens: gradients {t_grad:.3f}s "
            f"(host clock, ends in synchronize), loss "
            f"{float(metrics['loss']):.5f}, d loss / d log_sigma "
            f"{g_sigma.tolist()}, log_sigma {before.tolist()} -> "
            f"{leaf.tolist()}; peak memory {peak_gb:.2f} GB; non-finite "
            f"gradient leaves {bad}; launches {launches}")
        check(not bad, f"train nfft: non-finite gradients in {bad}")
        check(bool((g_sigma != 0).all()), "train nfft: a zero log_sigma "
              "gradient")
        check(bool((leaf != before).all()), "train nfft: log_sigma did not "
              "move")
        check(math.isfinite(float(metrics["loss"])), "train nfft: loss")
        self.check_no_kernel_launches(launches, "train nfft")
        del state, step
        gc_collect(torch)

    def phase_times(self):
        torch, win = self.torch, self.win
        self.kernel_times = {}
        log("[times] CUDA events, back-to-back calls after warm-up; "
            f"bounds: {HBM_BYTES_PER_S / 1e12} TB/s, FP64 "
            f"{PEAK_FLOPS['float64'] / 1e12} / FP32 "
            f"{PEAK_FLOPS['float32'] / 1e12} TFLOP/s (H100 SXM data sheet)")
        shapes = [(N_MAIN, s, dt, (1, 4), "spiral")
                  for s in ("SETUP_2", "SETUP_3")
                  for dt in (torch.float64, torch.float32)]
        shapes.append((N_BIG, "SETUP_2", torch.float64, (1,), "spiral"))
        # the hybrid Nyström's probe blocks and the segmentation's pixels
        shapes.append((N_MAIN, "SETUP_2", torch.float64, NYS_COLUMNS,
                       "spiral"))
        shapes.append((N_SEG, "SEG", torch.float64, (1,), "segment"))
        for n, setup_name in ((N_MAIN, "SETUP_2"), (N_MAIN, "SETUP_3"),
                              (N_BIG, "SETUP_2")):
            plan, geom = self.window_geometry(setup_name, 3, n)
            self.sync()
            t0 = time.perf_counter()
            tiles = win.build_tile_plan(geom.base, plan.taps)
            self.sync()
            build_ms = (time.perf_counter() - t0) * 1e3
            self.record["times"].append({
                "tile_plan": setup_name, "n": n, "d": 3,
                "tiles": tiles.n_tiles, "max_box_cells": tiles.max_cells,
                "build_ms": build_ms})
            log(f"[times] tile plan n={n} {setup_name} d=3: {build_ms:.2f} ms "
                f"(host clock, ends in synchronize; once per geometry), "
                f"{tiles.n_tiles} tiles, largest box {tiles.max_cells} cells")
        for n, setup_name, dtype, chans, kind in shapes:
            dname = str(dtype).split(".")[1]
            plan, base, w, tiles = self.geometry(setup_name, 3, n, dtype,
                                                 kind)
            pad, taps = self.padded_grid_size(plan), plan.taps
            for c in chans:
                gen = torch.Generator(device=self.dev).manual_seed(c)
                x = torch.randn((n, c), generator=gen, dtype=dtype,
                                device=self.dev)
                g = torch.randn((pad,) * 3 + (c,), generator=gen,
                                dtype=dtype, device=self.dev)
                bound_ms, by, flops, nbytes = self.bound(
                    n, 3, taps, c, pad, dname)
                for kname, kfn, pfn in (
                        ("spread",
                         lambda: win.window_spread(x, base, w,
                                                   padded_size=pad,
                                                   tiles=tiles),
                         lambda: win.window_spread_plain(
                             x, base, w, padded_size=pad)),
                        ("gather",
                         lambda: win.window_gather(g, base, w,
                                                   tiles=tiles),
                         lambda: win.window_gather_plain(g, base, w))):
                    ms = self.time_ms(kfn, reps=20 if c <= 4 else 5)
                    plain_ms = self.time_ms(pfn, reps=3 if c <= 4 else 1,
                                            warmup=1)
                    row = {"kernel": kname, "setup": setup_name, "d": 3,
                           "c": c, "dtype": dname, "n": n,
                           "taps": taps, "padded": pad, "ms": ms,
                           "plain_ms": plain_ms, "bound_ms": bound_ms,
                           "bound_by": by, "flops": flops,
                           "bytes": nbytes, "library_ms": None}
                    self.record["times"].append(row)
                    self.kernel_times[(kname, setup_name, 3, c, dname,
                                       n)] = row
                    log(f"[times] {kname:6s} n={n} {setup_name} d=3 C={c} "
                        f"{dname}: {ms:.4f} ms  bound {bound_ms:.4f} ms "
                        f"({by}, {flops / 1e9:.3f} GFLOP, "
                        f"{nbytes / 1e6:.1f} MB, "
                        f"{100 * bound_ms / ms:.2f}% of bound)  plain "
                        f"{plain_ms:.3f} ms (no yardstick)  library: none")
        self.time_km_paths()
        self.time_kernel_matvec()
        for n, setup_name in ((N_MAIN, "SETUP_2"), (N_MAIN, "SETUP_3"),
                              (N_BIG, "SETUP_2")):
            self.time_matvec(n, setup_name)
        self.time_nystrom()
        self.time_flash()
        self.time_serve()

    def time_nystrom(self):
        """One hybrid (L=50) and one traditional (L=n/20) Nyström at
        n = 10^5 and the segmentation's eigsh (k=4, 426,400 pixels), host
        clock ending in synchronize, with peak memory."""
        torch = self.torch
        card = self.record["device"]["nvidia_smi"]
        pts, _ = self.spiral(N_MAIN, seed=0)
        pts = torch.as_tensor(pts, device=self.dev)
        adj = self.fs.make_normalized_adjacency(self.kernel, pts,
                                                self.fs.SETUP_2,
                                                device=self.dev)
        for method, l_size, a in (("hybrid", NYS_COLUMNS[-1], adj),
                                  ("traditional", NYS_TRAD_L, None)):
            res, took, n_spread, n_gather, peak = self.nystrom_run(
                method, a, pts, l_size, K_EIG, 5)
            err = float((res.eigenvalues - self.main_lam).abs().max())
            self.record["times"].append({
                "nystrom": method, "n": N_MAIN, "L": l_size, "rank": K_EIG,
                "s": took, "eig_err": err, "run_peak_memory_gb": peak,
                "window_launches": [n_spread, n_gather], "device": card})
            log(f"[times] nystrom {method} n={N_MAIN} L={l_size} rank={K_EIG}"
                f" (seed 5): {took:.3f}s (host clock, ends in synchronize), "
                f"eigenvalue error {err:.3e}, the run's peak {peak:.2f} GB; "
                f"{card}")
            del res
        del adj
        op = self.segment_op
        self.sync()
        t0 = time.perf_counter()
        res = self.lan.eigsh(op.matvec, op.n, SEG_K[-1], device=self.dev)
        self.sync()
        took = time.perf_counter() - t0
        self.record["times"].append({
            "segment_eigsh": SEG_K[-1], "n": N_SEG, "s": took,
            "matvecs": res.num_matvecs, "device": card})
        log(f"[times] segment eigsh k={SEG_K[-1]} n={N_SEG} N=16 m=2: "
            f"{took:.3f}s (host clock, ends in synchronize), "
            f"{res.num_matvecs} matvecs; {card}")

    def time_flash(self):
        """The flash kernel at the serve path's prompt lengths and at one
        layer of the config's prefill length, causal, bf16, b=1, granite
        heads; at the other paths' shapes (FAMILY_FLASH); and in float32 at
        granite's heads and the longest prompt (the float32 engine's
        kernel); beside the bound of the dtype (float32: also the ceiling
        of three TF32 products), its plain version and PyTorch's SDPA on
        its fused backends (the yardstick only: the port never calls
        it)."""
        torch, fa = self.torch, self.fa
        # SDPA on its fused backends only: the math fallback would hold the
        # whole (32, s, s) score matrix at s = 32768
        for s in FLASH_LENGTHS + (FLASH_LAYER_S,):
            shape = (1, 32, 8, s, s, 64)
            q, k, v = self.flash_inputs(*shape, torch.bfloat16, s)
            long = s == FLASH_LAYER_S
            ms = self.time_ms(lambda: fa.flash_attention(q, k, v, causal=True),
                              reps=2 if long else 20, warmup=1)
            plain_ms = self.time_ms(
                lambda: fa.flash_attention_plain(q, k, v, causal=True),
                reps=1 if long else 3, warmup=1)
            lib_ms = self.tfl.sdpa_ms(q, k, v, True, reps=3 if long else 20)
            self.flash_time_row("serve", s, shape, True, "bfloat16", ms,
                                plain_ms, lib_ms)
            del q, k, v
        # the shapes of the other paths that launch it (FAMILY_FLASH)
        for path, label, shape, causal, dname in FAMILY_FLASH:
            dtype = getattr(torch, dname)
            q, k, v = self.flash_inputs(*shape, dtype, shape[3])
            ms = self.time_ms(
                lambda: fa.flash_attention(q, k, v, causal=causal),
                reps=10, warmup=1)
            plain_ms = self.time_ms(
                lambda: fa.flash_attention_plain(q, k, v, causal=causal),
                reps=3, warmup=1)
            lib_ms = self.tfl.sdpa_ms(q, k, v, causal, reps=10)
            self.flash_time_row(path, label, shape, causal, dname, ms,
                                plain_ms, lib_ms)
            del q, k, v
        # ... in float32 too where a float32 engine launches it there
        for path, label in FAMILY_FLASH_F32:
            _, _, shape, causal, _ = next(r for r in FAMILY_FLASH
                                          if r[1] == label)
            q, k, v = self.flash_inputs(*shape, torch.float32, shape[3])
            ms = self.time_ms(
                lambda: fa.flash_attention(q, k, v, causal=causal),
                reps=10, warmup=1)
            plain_ms = self.time_ms(
                lambda: fa.flash_attention_plain(q, k, v, causal=causal),
                reps=3, warmup=1)
            lib_ms = self.tfl.sdpa_ms(q, k, v, causal, reps=10)
            self.flash_time_row(path, f"{label}_f32", shape, causal,
                                "float32", ms, plain_ms, lib_ms)
            del q, k, v
        # the float32 kernel at the longest serve prompt
        s = FLASH_LENGTHS[-1]
        shape = (1, 32, 8, s, s, 64)
        q, k, v = self.flash_inputs(*shape, torch.float32, s)
        ms = self.time_ms(lambda: fa.flash_attention(q, k, v, causal=True),
                          reps=10, warmup=1)
        plain_ms = self.time_ms(
            lambda: fa.flash_attention_plain(q, k, v, causal=True), reps=3,
            warmup=1)
        lib_ms = self.tfl.sdpa_ms(q, k, v, True, reps=10)
        self.flash_time_row("serve float32", "granite_f32", shape, True,
                            "float32", ms, plain_ms, lib_ms)
        del q, k, v

    @staticmethod
    def sdpa_text(ms, lib_ms):
        return f"SDPA {lib_ms:.4f} ms (kernel {ms / lib_ms:.2f}x SDPA)"

    def flash_time_row(self, path, label, shape, causal, dname, ms,
                       plain_ms, lib_ms):
        """Records and prints one [times] row of the flash kernel at a
        path's shape: its time beside the bound of its dtype, the float32
        ceiling, the plain version and SDPA."""
        bound_ms, by, flops, nbytes = self.flash_bound(*shape, causal, dname)
        ceiling = (self.rl.tf32_split_ceiling_ms(flops)
                   if dname == "float32" else None)
        b, hq, hkv, s, _, dh = shape
        design = self.fa.design(getattr(self.torch, dname), dh)
        row = {"kernel": "flash_attention", "path": path, "label": label,
               "b": b, "hq": hq, "hkv": hkv, "sq": s, "sk": s, "dh": dh,
               "causal": causal, "dtype": dname, "design": design,
               "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
               "bound_by": by, "ceiling_ms": ceiling, "flops": flops,
               "bytes": nbytes, "tflops": flops / ms / 1e9,
               "library_ms": lib_ms,
               "kernel_over_library": ms / lib_ms}
        self.record["times"].append(row)
        self.kernel_times[("flash_attention", label)] = row
        ceil = (f"; ceiling {ceiling:.4f} ms, {100 * ceiling / ms:.1f}%"
                if ceiling else "")
        log(f"[times] flash_attention {label} b={b} hq={hq} hkv={hkv} "
            f"s={s} dh={dh} causal={causal} {dname} ({design}; "
            f"{self.record['device']['nvidia_smi']}): {ms:.4f} ms, "
            f"{row['tflops']:.1f} TFLOP/s  bound {bound_ms:.4f} ms ({by}, "
            f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB, "
            f"{100 * bound_ms / ms:.2f}% of bound{ceil})  plain "
            f"{plain_ms:.3f} ms  {self.sdpa_text(ms, lib_ms)}")

    def time_serve(self):
        """Prefill at the serve path's lengths (CUDA events) and engine
        ticks with SERVE_SLOTS active slots (host clock; every tick ends in
        a host read of the sampled tokens)."""
        torch, lm = self.torch, self.lm
        cfg, model = self.serve_cfg, self.serve_model
        prefill_ms = {}
        for s in FLASH_LENGTHS:
            toks = torch.as_tensor([self.serve_prompt_list[0][:s]],
                                   device=self.dev)
            caches = lm.init_caches(cfg, 1, s, device=self.dev)
            prefill_ms[s] = self.time_ms(
                lambda: model.forward_prefill({"tokens": toks}, caches),
                reps=3, warmup=1)
        engine = self.ServeEngine(cfg, model, slots=SERVE_SLOTS,
                                  max_seq=SERVE_MAX_SEQ, device=self.dev)
        for i in range(SERVE_SLOTS):
            engine.submit(self.Request(
                uid=i, tokens=self.serve_prompt_list[i][:512],
                max_new_tokens=10 ** 6))
        engine.step()  # admits every slot, and one decode step
        engine.step()
        check(all(r is not None for r in engine.active), "tick: idle slot")
        self.sync()
        t0 = time.perf_counter()
        for _ in range(TICKS_TIMED):
            engine.step()
        tick_ms = (time.perf_counter() - t0) / TICKS_TIMED * 1e3
        row = {"serve": cfg.name, "dtype": cfg.activation_dtype,
               "prefill_ms": prefill_ms, "tick_ms": tick_ms,
               "active_slots": SERVE_SLOTS,
               "tokens_per_s": SERVE_SLOTS * 1e3 / tick_ms,
               "cache_len": SERVE_MAX_SEQ}
        self.record["times"].append(row)
        log(f"[times] {cfg.name} bf16 prefill (b=1, CUDA events): "
            + ", ".join(f"{s} tokens {ms:.2f} ms" for s, ms in
                        prefill_ms.items()))
        log(f"[times] {cfg.name} bf16 decode tick, {SERVE_SLOTS} active "
            f"slots, cache {SERVE_MAX_SEQ} (host clock over {TICKS_TIMED} "
            f"ticks): {tick_ms:.3f} ms per tick, "
            f"{row['tokens_per_s']:.1f} tok/s")
        del engine

    def time_km_paths(self):
        """kernel_matvec at each KM_PATHS row, on that path's inputs: time,
        plain time, bound, error against the plain version, and the source
        splits chosen on this card."""
        torch, km = self.torch, self.km
        sms = torch.cuda.get_device_properties(self.dev).multi_processor_count
        self.km_path_rows = {}
        for path, points, n_out, n_in, d, kname, param, zd in KM_PATHS:
            a, b, x = self.km_inputs(n_out, n_in, d, 1, torch.float64, points)
            kw = dict(kernel_name=kname, param=param, zero_diagonal=zd)
            p_out = km.kernel_matvec_plain(a, b, x, **kw)
            err = float((km.kernel_matvec(a, b, x, **kw) - p_out).abs().max())
            rel = err / float(p_out.abs().max())
            check(rel <= KM_TOL["float64"],
                  f"kernel_matvec at the {path} path's shape: rel {rel:.3e}")
            ms = self.time_ms(lambda: km.kernel_matvec(a, b, x, **kw),
                              reps=20 if n_in < N_MAIN else 5, warmup=1)
            plain_ms = self.time_ms(
                lambda: km.kernel_matvec_plain(a, b, x, **kw), reps=1,
                warmup=1)
            bound_ms, by, flops, nbytes = self.km_bound(
                n_out, n_in, d, 1, kname, "float64", zd)
            splits = km.choose_splits(n_out, n_in, d, 1, sms)
            row = {"kernel": "kernel_matvec", "path": path, "points": points,
                   "profile": kname, "param": param, "n_out": n_out,
                   "n_in": n_in, "d": d, "c": 1, "dtype": "float64",
                   "zero_diagonal": zd, "splits": splits,
                   "rows_per_thread": km.rows_per_thread(1, d), "ms": ms,
                   "plain_ms": plain_ms, "bound_ms": bound_ms,
                   "bound_by": by, "flops": flops, "bytes": nbytes,
                   "max_abs_err": err, "rel_err": rel, "library_ms": None}
            self.record["times"].append(row)
            self.km_path_rows[path] = row
            log(f"[times] kernel_matvec {path} path: {kname} {n_out}x{n_in} "
                f"d={d} C=1 float64 zero_diag={zd} (S={splits} source "
                f"splits, R={km.rows_per_thread(1, d)}): {ms:.4f} ms  bound "
                f"{bound_ms:.4f} ms ({by}, {100 * bound_ms / ms:.2f}% of "
                f"bound)  plain {plain_ms:.3f} ms (no yardstick)  library: "
                f"none; rel err vs plain {rel:.2e}")

    def time_kernel_matvec(self):
        """kernel_matvec at every checked shape but n = 8000 (the guard
        path's, which time_km_paths times)."""
        torch, km = self.torch, self.km
        for n_out, n_in, d, c, zd in self.km_shapes():
            if n_in == KM_SQUARE_N[0]:
                continue
            for dtype in (torch.float64, torch.float32):
                dname = str(dtype).split(".")[1]
                a, b, x = self.km_inputs(n_out, n_in, d, c, dtype)
                for kname, param in KM_PROFILES:
                    kw = dict(kernel_name=kname, param=param,
                              zero_diagonal=zd)
                    ms = self.time_ms(lambda: km.kernel_matvec(a, b, x, **kw),
                                      reps=5, warmup=1)
                    plain_ms = self.time_ms(
                        lambda: km.kernel_matvec_plain(a, b, x, **kw),
                        reps=1, warmup=1)
                    bound_ms, by, flops, nbytes = self.km_bound(
                        n_out, n_in, d, c, kname, dname, zd)
                    row = {"kernel": "kernel_matvec", "profile": kname,
                           "n_out": n_out, "n_in": n_in, "d": d, "c": c,
                           "dtype": dname, "zero_diagonal": zd, "ms": ms,
                           "plain_ms": plain_ms, "bound_ms": bound_ms,
                           "bound_by": by, "flops": flops, "bytes": nbytes,
                           "library_ms": None}
                    self.record["times"].append(row)
                    self.kernel_times[("kernel_matvec", n_out, n_in, d, c,
                                       dname, kname)] = row
                    log(f"[times] kernel_matvec {kname:20s} {n_out}x{n_in} "
                        f"d={d} C={c} {dname}: {ms:.4f} ms  bound "
                        f"{bound_ms:.4f} ms ({by}, {flops / 1e9:.2f} GFLOP, "
                        f"{nbytes / 1e6:.2f} MB, {100 * bound_ms / ms:.1f}% "
                        f"of bound)  plain {plain_ms:.3f} ms (no yardstick)  "
                        "library: none")

    def time_matvec(self, n, setup_name):
        """Fused matvec at C = 1 and 4, its stages at C = 1, and eigsh."""
        torch, ex = self.torch, self.exec
        pts, _ = self.spiral(n, seed=0)
        pts = torch.as_tensor(pts, device=self.dev)
        t0 = time.perf_counter()
        op = self.fs.make_normalized_adjacency(self.kernel, pts,
                                               self.setup(setup_name),
                                               device=self.dev)
        self.sync()
        row = {"n": n, "setup": setup_name,
               "plan_s": time.perf_counter() - t0}
        x = torch.randn((n, 4), dtype=torch.float64, device=self.dev,
                        generator=torch.Generator(device=self.dev).manual_seed(0))
        x1 = x[:, 0].contiguous()
        row["matvec_ms_c1"] = self.time_ms(lambda: op.fastsum.matvec(x1),
                                           reps=10)
        row["matvec_ms_c4"] = self.time_ms(lambda: op.fastsum.matvec(x),
                                           reps=10)
        # stages of one C = 1 matvec: perm take + spread kernel + fold/roll;
        # rfftn * multiplier -> irfftn; roll/wrap-pad + gather kernel +
        # inverse-perm take
        fs = op.fastsum
        xb = x1[:, None]
        g = ex.window_spread(fs.plan, fs.src_window, xb)
        y = ex._spectral_mid(fs.plan, fs.multiplier_half, g)
        row["stage_ms"] = {
            "spread": self.time_ms(
                lambda: ex.window_spread(fs.plan, fs.src_window, xb), reps=10),
            "fft_mid": self.time_ms(
                lambda: ex._spectral_mid(fs.plan, fs.multiplier_half, g),
                reps=10),
            "gather": self.time_ms(
                lambda: ex.window_gather(fs.plan, fs.src_window, y), reps=10)}
        t0 = time.perf_counter()
        res = self.lan.eigsh(op.matvec, op.n, K_EIG, device=self.dev)
        self.sync()
        row["eigsh_s"] = time.perf_counter() - t0
        row["eigsh_matvecs"] = res.num_matvecs
        self.record["times"].append(row)
        st = row["stage_ms"]
        log(f"[times] fused matvec n={n} {setup_name} float64: C=1 "
            f"{row['matvec_ms_c1']:.3f} ms (spread {st['spread']:.3f}, fft "
            f"{st['fft_mid']:.3f}, gather {st['gather']:.3f}), C=4 "
            f"{row['matvec_ms_c4']:.3f} ms; plan {row['plan_s']:.3f}s; eigsh "
            f"k={K_EIG} {row['eigsh_s']:.3f}s ({res.num_matvecs} matvecs)")

    # -- [moe_serve], [ssm_serve], [mla_serve], [hybrid_serve] ---------------
    def family_prompts(self, cfg, chunk=None):
        """SERVE_REQUESTS seeded prompts, lengths in FAMILY_MIN_PROMPT..
        FAMILY_MAX_PROMPT with one of exactly FAMILY_MAX_PROMPT; with
        ``chunk`` (a Mamba
        layer's chunked SSD pads nothing) whole chunks, and one prompt of
        fewer tokens than a chunk."""
        rng = np.random.default_rng(SERVE_SEED + 3)
        top = FAMILY_MAX_PROMPT
        if chunk is None:
            lengths = [top] + rng.integers(FAMILY_MIN_PROMPT, top + 1,
                                           SERVE_REQUESTS - 1).tolist()
        else:
            lengths = [top, chunk * 25 // 32] + (chunk * rng.integers(
                1, top // chunk + 1, SERVE_REQUESTS - 2)).tolist()
        return [rng.integers(0, cfg.vocab_size, n).tolist() for n in lengths]

    def family_init(self, phase, cfg):
        """Seeded random weights on the card; (model, params, init s)."""
        torch = self.torch
        gc_collect(torch)
        held = torch.cuda.memory_allocated(self.dev)
        torch.cuda.reset_peak_memory_stats(self.dev)
        t0 = time.perf_counter()
        model = self.lm.init_params(cfg, SERVE_SEED, device=self.dev)
        self.sync()
        took = time.perf_counter() - t0
        self.init_peak_gb = (torch.cuda.max_memory_allocated(self.dev)
                             - held) / 1e9
        n_params = sum(p.numel() for p in model.parameters())
        log(f"[{phase}] {self.record['device']['nvidia_smi']}: {cfg.name} "
            f"{cfg.num_layers} layers d={cfg.d_model} "
            f"{cfg.activation_dtype}: {n_params / 1e9:.3f}e9 params, "
            f"{sum(p.numel() * p.element_size() for p in model.parameters()) / 1e9:.2f} GB "
            f"(seed {SERVE_SEED}, init {took:.2f}s, peak "
            f"{self.init_peak_gb:.2f} GB over the {held / 1e9:.2f} GB held "
            "before)")
        return model, n_params, took

    def family_serve(self, phase, cfg, model, prompts):
        """The prompts through ServeEngine (launch counts from 0), then
        TICKS_TIMED engine ticks with SERVE_SLOTS active slots; the
        record's numbers, finite logits checked."""
        torch = self.torch
        card = self.record["device"]["nvidia_smi"]
        seen = self.watch_logits(model)
        torch.cuda.reset_peak_memory_stats(self.dev)
        self.sync()
        self.reset_launches()
        reqs, wall = self.serve(cfg, model, prompts)
        launches = self.read_launches(phase)
        self.unwatch(model)
        bad = int(seen["bad"])
        peak_gb = torch.cuda.max_memory_allocated(self.dev) / 1e9
        engine = self.ServeEngine(cfg, model, slots=SERVE_SLOTS,
                                  max_seq=SERVE_MAX_SEQ, device=self.dev)
        for i in range(SERVE_SLOTS):
            engine.submit(self.Request(uid=i, tokens=prompts[i],
                                       max_new_tokens=10 ** 6))
        engine.step()  # admits every slot, and one decode step
        engine.step()
        check(all(r is not None for r in engine.active),
              f"{phase} tick: idle slot")
        self.sync()
        t0 = time.perf_counter()
        for _ in range(TICKS_TIMED):
            engine.step()
        tick_ms = (time.perf_counter() - t0) / TICKS_TIMED * 1e3
        slot_bytes = self.cache_bytes(engine.caches) / SERVE_SLOTS
        del engine
        # a tick reads every weight (the experts' products run on every
        # expert) but an untied embedding's, and every cache row once
        read = sum(p.numel() * p.element_size() for p in model.parameters())
        if model.lm_head is not None and model.embed is not None:
            read -= model.embed.numel() * model.embed.element_size()
        tick_bound_ms = (read + SERVE_SLOTS * slot_bytes) / HBM_BYTES_PER_S \
            * 1e3
        new_tokens = sum(len(r.output) for r in reqs)
        rec = {"arch": cfg.name, "layers": cfg.num_layers,
               "d_model": cfg.d_model, "dtype": cfg.activation_dtype,
               "prompt_lengths": [len(p) for p in prompts], "wall_s": wall,
               "new_tokens": new_tokens, "tokens_per_s": new_tokens / wall,
               "tick_ms": tick_ms, "tick_tokens_per_s":
                   SERVE_SLOTS * 1e3 / tick_ms,
               "nonfinite_logits": bad, "logits_checked": seen["n"],
               "peak_memory_gb": peak_gb, "launches": launches,
               "cache_bytes_per_slot": slot_bytes, "card": card,
               "tick_bound_ms": tick_bound_ms}
        log(f"[{phase}] ServeEngine slots={SERVE_SLOTS} max_seq="
            f"{SERVE_MAX_SEQ}, {len(prompts)} requests, prompts "
            f"{[len(p) for p in prompts]}, {SERVE_NEW} new tokens each")
        log(f"[{phase}] {card}: {wall:.3f}s wall (ends in synchronize), "
            f"{new_tokens} tokens, {new_tokens / wall:.1f} tok/s; tick "
            f"{tick_ms:.3f} ms with {SERVE_SLOTS} active slots (host clock "
            f"over {TICKS_TIMED} ticks, {rec['tick_tokens_per_s']:.1f} "
            f"tok/s; bound {tick_bound_ms:.3f} ms, the weights a tick reads "
            f"and the caches at {HBM_BYTES_PER_S / 1e12:g} TB/s, "
            f"{100 * tick_bound_ms / tick_ms:.1f}% of the tick); peak "
            f"memory {peak_gb:.2f} GB; cache "
            f"{slot_bytes / 1e6:.1f} MB a slot; {seen['n']} logits, {bad} "
            f"non-finite; launches {launches}")
        check(bad == 0, f"{phase}: {bad} non-finite logits")
        return rec, reqs

    def f32_engine_vs_manual(self, phase, cfg, prompts, prepare=None,
                             einsum_prompt=None):
        """float32 (TF32 off): the engine's tokens against an unbatched
        prefill + decode loop, up to each request's first near tie.
        ``prepare(model)`` runs on the new model first; with
        ``einsum_prompt``, its prefill through flash against the einsum
        (before the engine, whose launches are counted from 0)."""
        with self.tf32_off():
            cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                        activation_dtype="float32")
            model32, _, _ = self.family_init(phase, cfg32)
            if prepare is not None:
                prepare(model32)
            if einsum_prompt is not None:
                self.check_flash_vs_einsum(cfg32, model32, einsum_prompt,
                                           phase)
            self.reset_launches()
            reqs32, wall32 = self.serve(cfg32, model32, prompts)
            launches32 = self.read_launches(f"{phase}_f32")
            compared, stops = 0, []
            for r in reqs32:
                want, margins = self.manual_greedy(cfg32, model32, r.tokens)
                n = next((i for i, m in enumerate(margins)
                          if m < SERVE_MARGIN), len(margins))
                stops.append(n)
                compared += n
                check(r.output[:n] == want[:n],
                      f"{phase} f32 engine vs manual, request {r.uid}: "
                      f"{r.output[:n]} != {want[:n]}")
            del model32
        self.record[phase]["f32"] = {"layers": cfg32.num_layers,
                                     "init_peak_gb": self.init_peak_gb,
                                     "wall_s": wall32,
                                     "steps_compared": stops,
                                     "launches": launches32}
        log(f"[{phase}] float32 (TF32 off): engine {wall32:.3f}s; engine vs "
            f"manual prefill+decode tokens equal on {compared} of "
            f"{SERVE_NEW * len(reqs32)} steps (per request {stops}; a "
            f"request's comparison stops at its first top-2 margin under "
            f"{SERVE_MARGIN:g} of the top logit); launches {launches32}")
        check(compared > 0, f"{phase} f32: no step compared")
        return launches32

    @contextlib.contextmanager
    def tf32_off(self):
        """TF32 off for matmuls and cuDNN; the caller's settings back
        after."""
        torch = self.torch
        prev = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev[0]
            torch.backends.cudnn.allow_tf32 = prev[1]

    def teacher_forced_vs_full(self, cfg, model, n_prefill, n_decode, seed):
        """max |decode - full| / max |full| over the logits of a prefill of
        n_prefill tokens and n_decode teacher-forced decode steps, against
        one whole-sequence forward of n_prefill + n_decode tokens at the
        same positions."""
        torch, lm = self.torch, self.lm
        s = n_prefill + n_decode
        toks = torch.as_tensor(np.random.default_rng(seed).integers(
            0, cfg.vocab_size, (1, s)), device=self.dev)
        with torch.no_grad():
            x, positions, _ = model.embed_inputs({"tokens": toks})
            full = model.lm_logits(model.run_backbone(
                x, positions, mode="train"))[0, n_prefill - 1:].float()
        caches = lm.init_caches(cfg, 1, s, device=self.dev)
        logits, _ = model.forward_prefill({"tokens": toks[:, :n_prefill]},
                                          caches)
        got = [logits[0, -1]]
        for p in range(n_prefill, s):
            logits, _ = model.forward_decode(
                toks[:, p:p + 1], torch.tensor([p], device=self.dev), caches)
            got.append(logits[0, 0])
        got = torch.stack(got).float()
        return float((got - full).abs().max() / full.abs().max())

    def phase_moe_serve(self):
        """[moe_serve]: olmoe-1b-7b at full width and depth (bf16; 64
        experts, top-8) through ServeEngine: every prefill launches the
        flash kernel once per layer (head dim 128), every logit finite;
        in float32 (TF32 off) the engine against a manual loop."""
        t0 = time.perf_counter()
        cfg = self.get_config(MOE_ARCH)
        model, n_params, t_init = self.family_init("moe_serve", cfg)
        prompts = self.family_prompts(cfg)
        rec, _ = self.family_serve("moe_serve", cfg, model, prompts)
        rec.update(params=n_params, init_s=t_init,
                   experts=cfg.moe.num_experts, top_k=cfg.moe.top_k)
        self.record["moe_serve"] = rec
        flash = rec["launches"]["flash_attention"]
        check(flash == cfg.num_layers * len(prompts),
              f"moe serve: {flash} flash launches for {len(prompts)} "
              f"prefills of {cfg.num_layers} layers")
        check(sum(rec["launches"].values()) == flash,
              f"moe serve: another kernel launched {rec['launches']}")
        del model
        launches32 = self.f32_engine_vs_manual("moe_serve", cfg, prompts)
        check(launches32["flash_attention"] == cfg.num_layers * len(prompts),
              "moe serve f32: flash launches")
        rec["phase_s"] = time.perf_counter() - t0
        log(f"[moe_serve] phase {rec['phase_s']:.1f}s wall")

    def phase_ssm_serve(self):
        """[ssm_serve]: mamba2-1.3b at full width and depth (bf16, 48 pure
        SSM blocks) through ServeEngine, prompts of whole 128-token chunks
        or shorter than one: no kernel of the package launches, every
        logit finite; the constant state a slot beside granite-3-2b's KV
        cache; in float32 with 4 layers, decode after a prefill against
        the whole sequence's chunked forward."""
        torch, lm = self.torch, self.lm
        t0 = time.perf_counter()
        cfg = self.get_config(SSM_ARCH)
        model, n_params, t_init = self.family_init("ssm_serve", cfg)
        prompts = self.family_prompts(cfg, chunk=cfg.mamba.chunk_size)
        rec, _ = self.family_serve("ssm_serve", cfg, model, prompts)
        rec.update(params=n_params, init_s=t_init)
        self.record["ssm_serve"] = rec
        self.check_no_kernel_launches(rec["launches"], "ssm serve")
        del model
        mc = cfg.mamba
        d_in = mc.expand * cfg.d_model
        want = cfg.num_layers * 4 * (
            d_in // mc.head_dim * mc.d_state * mc.head_dim
            + (mc.d_conv - 1) * (d_in + 2 * mc.n_groups * mc.d_state))
        caches = lm.init_caches(self.get_config(SERVE_ARCH), 1,
                                SERVE_MAX_SEQ, device=self.dev)
        kv = self.cache_bytes(caches)
        del caches
        rec["dense_kv_bytes_per_slot"] = kv
        log(f"[ssm_serve] state a slot (allocated tensors): "
            f"{rec['cache_bytes_per_slot'] / 1e6:.1f} MB float32 at any "
            f"length (48 x (h n p + 3 (d_in + 2 n)) x 4 B); {SERVE_ARCH}'s "
            f"KV cache {kv / 1e6:.1f} MB at {SERVE_MAX_SEQ} tokens")
        check(rec["cache_bytes_per_slot"] == want,
              f"ssm state bytes a slot {rec['cache_bytes_per_slot']} != "
              f"{want}")
        gc_collect(torch)
        with self.tf32_off():
            cfg32 = dataclasses.replace(cfg, num_layers=SSM_F32_LAYERS,
                                        param_dtype="float32",
                                        activation_dtype="float32")
            model32 = lm.init_params(cfg32, SERVE_SEED, device=self.dev)
            self.reset_launches()
            rel = self.teacher_forced_vs_full(
                cfg32, model32, SSM_F32_PREFILL, SSM_F32_DECODE, 11)
            launches = self.read_launches("ssm_serve_consistency")
            del model32
        rec["decode_vs_forward_rel"] = rel
        log(f"[ssm_serve] float32 (TF32 off), {SSM_F32_LAYERS} layers: "
            f"prefill of {SSM_F32_PREFILL} tokens and {SSM_F32_DECODE} "
            f"recurrent decode steps vs one chunked forward of "
            f"{SSM_F32_PREFILL + SSM_F32_DECODE} tokens: rel "
            f"{rel:.3e} of max |logit| (limit {SSM_F32_TOL:g})")
        check(rel <= SSM_F32_TOL, f"ssm decode vs forward: {rel}")
        self.check_no_kernel_launches(launches, "ssm consistency")
        rec["phase_s"] = time.perf_counter() - t0
        log(f"[ssm_serve] phase {rec['phase_s']:.1f}s wall")

    def phase_mla_serve(self):
        """[mla_serve]: deepseek-v3-671b at full width (bf16: d 7168, 128
        heads, 256 experts, top-8, a shared expert) with the depth cut
        61 -> 4 (3 dense + 1 MoE layer) and MTP cut 1 -> 0, through
        ServeEngine: no kernel of the package launches (MLA is an einsum),
        every logit finite; the MLA cache a token beside the expanded K/V;
        in float32 with 1 layer, the absorbed decode against the expanded
        forward."""
        torch, lm = self.torch, self.lm
        t0 = time.perf_counter()
        full = self.get_config(MLA_ARCH)
        cfg = dataclasses.replace(full, num_layers=MLA_LAYERS, mtp_depth=0)
        model, n_params, t_init = self.family_init("mla_serve", cfg)
        log(f"[mla_serve] cuts: depth {full.num_layers} -> {MLA_LAYERS} "
            f"({cfg.moe.first_dense_layers} dense + "
            f"{MLA_LAYERS - cfg.moe.first_dense_layers} MoE), mtp_depth "
            f"{full.mtp_depth} -> 0 (serving never reads it); every width "
            "kept")
        prompts = self.family_prompts(cfg)
        rec, _ = self.family_serve("mla_serve", cfg, model, prompts)
        m = cfg.mla
        size = torch.finfo(cfg.dtype).bits // 8
        latent = (m.kv_lora_rank + m.qk_rope_head_dim) * size
        expanded = cfg.num_heads * (m.qk_nope_head_dim + m.qk_rope_head_dim
                                    + m.v_head_dim) * size
        rec.update(params=n_params, init_s=t_init,
                   cuts={"num_layers": [full.num_layers, MLA_LAYERS],
                         "mtp_depth": [full.mtp_depth, 0]},
                   mla_bytes_per_token_layer=latent,
                   expanded_kv_bytes_per_token_layer=expanded)
        self.record["mla_serve"] = rec
        log(f"[mla_serve] MLA cache a token and layer: ({m.kv_lora_rank} + "
            f"{m.qk_rope_head_dim}) x {size} B = {latent} B; the expanded "
            f"K/V it replaces: {cfg.num_heads} x ({m.qk_nope_head_dim} + "
            f"{m.qk_rope_head_dim} + {m.v_head_dim}) x {size} B = "
            f"{expanded} B ({expanded / latent:.0f}x)")
        check(rec["cache_bytes_per_slot"]
              == cfg.num_layers * SERVE_MAX_SEQ * latent,
              f"mla cache bytes a slot {rec['cache_bytes_per_slot']}")
        self.check_no_kernel_launches(rec["launches"], "mla serve")
        del model
        gc_collect(torch)
        with self.tf32_off():
            cfg32 = dataclasses.replace(cfg, num_layers=1,
                                        param_dtype="float32",
                                        activation_dtype="float32")
            model32 = lm.init_params(cfg32, SERVE_SEED, device=self.dev)
            self.reset_launches()
            rel = self.teacher_forced_vs_full(
                cfg32, model32, MLA_F32_PREFILL, MLA_F32_DECODE, 12)
            launches = self.read_launches("mla_serve_consistency")
            del model32
        rec["absorbed_vs_expanded_rel"] = rel
        log(f"[mla_serve] float32 (TF32 off), 1 layer (MLA + dense): "
            f"prefill of {MLA_F32_PREFILL} tokens and {MLA_F32_DECODE} "
            f"absorbed decode steps vs one expanded forward: rel {rel:.3e} "
            f"of max |logit| (limit {MLA_F32_TOL:g})")
        check(rel <= MLA_F32_TOL, f"mla absorbed vs expanded: {rel}")
        self.check_no_kernel_launches(launches, "mla consistency")
        rec["phase_s"] = time.perf_counter() - t0
        log(f"[mla_serve] phase {rec['phase_s']:.1f}s wall")

    def phase_hybrid_serve(self):
        """[hybrid_serve]: jamba-1.5-large-398b at its reduced config (16
        layers, the 1:7 attention/Mamba pattern, MoE every other layer,
        d 64, float32) through ServeEngine on the card: the prefills
        launch flash once per attention layer; the tokens equal the same
        weights' engine run on the CPU, and one prefill + decode steps'
        logits agree with the CPU's."""
        from repro_torch.configs import reduced_config
        torch, lm = self.torch, self.lm
        t0 = time.perf_counter()
        full = self.get_config(HYBRID_ARCH)
        cfg = reduced_config(full)
        log(f"[hybrid_serve] cut: {full.name} at its reduced config "
            f"({cfg.num_layers} layers, d {full.d_model} -> {cfg.d_model}, "
            f"{cfg.moe.num_experts} experts top-{cfg.moe.top_k}); at full "
            f"width one MoE layer's experts are "
            f"{full.moe.num_experts * 3 * full.d_model * full.moe.d_ff_expert * 2 / 1e9:.1f} GB "
            "in bf16 and a period holds four: more than one card")
        model, n_params, t_init = self.family_init("hybrid_serve", cfg)
        on_cpu = lm.init_params(cfg, SERVE_SEED, device="cpu")
        on_cpu.load_state_dict({k: v.cpu()
                                for k, v in model.state_dict().items()})
        prompts = self.family_prompts(cfg, chunk=cfg.mamba.chunk_size)
        prompts = [p[:HYBRID_PROMPT_CAP] for p in prompts]
        with self.tf32_off():
            rec, card_reqs = self.family_serve("hybrid_serve", cfg, model,
                                               prompts)
            engine = self.ServeEngine(cfg, on_cpu, slots=SERVE_SLOTS,
                                      max_seq=SERVE_MAX_SEQ, device="cpu")
            reqs = [self.Request(uid=i, tokens=p, max_new_tokens=SERVE_NEW)
                    for i, p in enumerate(prompts)]
            for r in reqs:
                engine.submit(r)
            engine.run_until_drained()
            del engine
            same = [a.output == b.output for a, b in zip(card_reqs, reqs)]
            rels = []
            toks = prompts[0]
            for dev, mdl in ((self.dev, model), (torch.device("cpu"),
                                                 on_cpu)):
                caches = lm.init_caches(cfg, 1, len(toks) + 8, device=dev)
                logits, _ = mdl.forward_prefill(
                    {"tokens": torch.as_tensor([toks], device=dev)}, caches)
                seq = [logits[0, -1].cpu()]
                for i in range(8):
                    logits, _ = mdl.forward_decode(
                        torch.as_tensor([[toks[i]]], device=dev),
                        torch.as_tensor([len(toks) + i], device=dev), caches)
                    seq.append(logits[0, 0].cpu())
                rels.append(torch.stack(seq).float())
            rel = float((rels[0] - rels[1]).abs().max()
                        / rels[1].abs().max())
        n_attn = sum(lm.layer_signature(cfg, i).mixer == "attn"
                     for i in range(cfg.num_layers))
        rec.update(params=n_params, init_s=t_init, card_vs_cpu_rel=rel,
                   tokens_equal_cpu=same, attention_layers=n_attn,
                   cut={"d_model": [full.d_model, cfg.d_model],
                        "num_layers": [full.num_layers, cfg.num_layers]})
        self.record["hybrid_serve"] = rec
        log(f"[hybrid_serve] card vs CPU, same weights, float32 (TF32 off):"
            f" engine tokens equal on {sum(same)} of {len(same)} requests; "
            f"a prefill of {len(toks)} tokens + 8 decode steps: rel "
            f"{rel:.3e} of max |logit| (limit {HYBRID_TOL:g})")
        check(all(same), f"hybrid: card tokens != CPU tokens {same}")
        check(rel <= HYBRID_TOL, f"hybrid card vs cpu: {rel}")
        flash = rec["launches"]["flash_attention"]
        check(flash == n_attn * len(prompts),
              f"hybrid serve: {flash} flash launches for {len(prompts)} "
              f"prefills of {n_attn} attention layers")
        del model, on_cpu
        rec["phase_s"] = time.perf_counter() - t0
        log(f"[hybrid_serve] phase {rec['phase_s']:.1f}s wall")

    # -- [llama_serve], [qwen_serve], [jamba_serve] -------------------------
    def draw_qkv_biases(self, model, phase) -> float:
        """Every attention layer's bq, bk, bv drawn WIDE_BIAS_SCALE N(0, 1)
        in float32 from one generator seeded WIDE_BIAS_SEED on the card,
        layer by layer, and cast: both dtypes of a config get the same
        biases up to rounding.  Returns the least max |b| over them, which
        must not be 0."""
        torch = self.torch
        gen = torch.Generator(device=self.dev).manual_seed(WIDE_BIAS_SEED)
        biases = [getattr(block.attn, name) for block in model.blocks
                  if hasattr(block, "attn") for name in ("bq", "bk", "bv")]
        for b in biases:
            b.copy_(WIDE_BIAS_SCALE * torch.randn(
                b.shape, generator=gen, dtype=torch.float32, device=self.dev))
        least = min(float(b.abs().max()) for b in biases)
        log(f"[{phase}] {len(biases)} QKV biases drawn "
            f"{WIDE_BIAS_SCALE:g} N(0, 1) (seed {WIDE_BIAS_SEED}) on the "
            f"card in {model.cfg.param_dtype}: least max |b| {least:.4f}")
        check(biases and least > 0, "qkv biases: one is all zeros")
        return least

    def wide_plan(self, phase, cfg) -> dict:
        """``serve_memory_plan`` of [phase]'s cut, printed and held to
        WIDE_PLAN_LIMIT_GB."""
        plan = {k.replace("_bytes", "_gb"): v / 1e9 if k != "params" else v
                for k, v in serve_memory_plan(cfg).items()}
        log(f"[{phase}] memory plan ({cfg.activation_dtype}, "
            f"{cfg.num_layers} layers; meta, init_params' order): weights "
            f"{plan['weight_gb']:.2f} GB, caches {SERVE_SLOTS} x "
            f"{SERVE_MAX_SEQ} {plan['cache_gb']:.3f} GB, init peak "
            f"{plan['init_peak_gb']:.2f} GB, serving at least "
            f"{plan['peak_gb']:.2f} GB (limit {WIDE_PLAN_LIMIT_GB:g})")
        check(plan["peak_gb"] <= WIDE_PLAN_LIMIT_GB,
              f"{phase} memory plan {plan}")
        return plan

    def check_init_peak(self, phase, plan):
        """The card's peak while the weights were drawn (``family_init``)
        against the plan's: the plan counts every byte that init_params
        holds, so the card may exceed it by the allocator's rounding
        only."""
        got, want = self.init_peak_gb, plan["init_peak_gb"]
        log(f"[{phase}] {self.record['device']['nvidia_smi']}: init peak "
            f"{got:.3f} GB, plan {want:.3f} GB")
        check(got <= want + 0.1, f"{phase} init peak {got} GB > plan {want}")

    def phase_llama_serve(self):
        self.wide_attention_serve("llama_serve")

    def phase_qwen_serve(self):
        self.wide_attention_serve("qwen_serve")

    def wide_attention_serve(self, phase):
        """[llama_serve] / [qwen_serve]: llama3-405b or qwen1.5-32b at full
        width, depth cut as WIDE_SERVE says, bf16, through ServeEngine:
        every prefill launches the flash kernel once per layer (GQA 16:1;
        40 MHA heads) and nothing else, every logit finite, one prefill
        through flash against the einsum; qwen's QKV biases drawn nonzero;
        in float32 (TF32 off) at the float32 depth, flash against the
        einsum and the engine against a manual loop."""
        t0 = time.perf_counter()
        cfg = wide_config(phase, "bfloat16")
        cfg32 = wide_config(phase, "float32")
        full = self.get_config(cfg.name)
        log(f"[{phase}] cut: {full.name} depth {full.num_layers} -> "
            f"{cfg.num_layers} (bf16), {cfg32.num_layers} (float32); every "
            f"width kept: d {cfg.d_model}, {cfg.num_heads} q heads on "
            f"{cfg.num_kv_heads} kv heads at dh {cfg.head_dim_eff}, d_ff "
            f"{cfg.d_ff}, vocab {cfg.vocab_size} (head "
            f"{'tied' if cfg.tie_embeddings else 'untied'}), rope_theta "
            f"{cfg.rope_theta:g}, qkv_bias {cfg.qkv_bias}")
        plans = {c.activation_dtype: self.wide_plan(phase, c)
                 for c in (cfg, cfg32)}
        model, n_params, t_init = self.family_init(phase, cfg)
        self.check_init_peak(phase, plans["bfloat16"])
        init_peak = self.init_peak_gb
        prepare = ((lambda m: self.draw_qkv_biases(m, phase))
                   if cfg.qkv_bias else None)
        bias = prepare(model) if prepare else None
        prompts = self.family_prompts(cfg)
        rec, _ = self.family_serve(phase, cfg, model, prompts)
        rec.update(params=n_params, init_s=t_init, init_peak_gb=init_peak,
                   plan=plans, bias_least_max_abs=bias,
                   heads=[cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_eff],
                   cuts={"num_layers": [full.num_layers, cfg.num_layers,
                                        cfg32.num_layers]})
        self.record[phase] = rec
        flash = rec["launches"]["flash_attention"]
        check(flash == cfg.num_layers * len(prompts),
              f"{phase}: {flash} flash launches for {len(prompts)} prefills "
              f"of {cfg.num_layers} layers")
        check(sum(rec["launches"].values()) == flash,
              f"{phase}: another kernel launched {rec['launches']}")
        self.check_flash_vs_einsum(cfg, model, prompts[0], phase)
        del model
        launches32 = self.f32_engine_vs_manual(phase, cfg32, prompts,
                                               prepare=prepare,
                                               einsum_prompt=prompts[0])
        self.check_init_peak(phase, plans["float32"])
        check(launches32["flash_attention"] == cfg32.num_layers * len(prompts)
              and sum(launches32.values()) == launches32["flash_attention"],
              f"{phase} f32: launches {launches32}")
        rec["phase_s"] = time.perf_counter() - t0
        log(f"[{phase}] {rec['card']}: phase {rec['phase_s']:.1f}s wall")

    def phase_jamba_serve(self):
        """[jamba_serve]: jamba-1.5-large-398b at full width with the depth
        cut 72 -> 2 (layer 0 Mamba + the 16-expert top-2 MoE, layer 1
        Mamba + dense), bf16, through ServeEngine, prompts of whole
        128-token chunks or shorter than one: no kernel of the package
        launches, every logit finite, the Mamba state a slot as its closed
        form; in float32 (TF32 off) the engine against a manual loop, and
        teacher-forced decode steps against the chunked forward."""
        torch, lm = self.torch, self.lm
        phase = "jamba_serve"
        t0 = time.perf_counter()
        cfg = wide_config(phase, "bfloat16")
        cfg32 = wide_config(phase, "float32")
        full = self.get_config(cfg.name)
        mc, moe = cfg.mamba, cfg.moe
        d_in = mc.expand * cfg.d_model
        sigs = [tuple(lm.layer_signature(cfg, i))
                for i in range(cfg.num_layers)]
        log(f"[{phase}] cut: {full.name} depth {full.num_layers} -> "
            f"{cfg.num_layers} ({sigs}); every width kept: d "
            f"{cfg.d_model}, Mamba {d_in // mc.head_dim} heads x "
            f"{mc.head_dim}, d_state {mc.d_state}; {moe.num_experts} "
            f"experts top-{moe.top_k}, d_ff_expert {moe.d_ff_expert} (an "
            f"expert matrix of {moe.num_experts * cfg.d_model * moe.d_ff_expert:.3e} "
            f"elements); the attention layer is layer {cfg.attn_every - 1} "
            "of each period")
        check(sigs == [("mamba", "moe"), ("mamba", "dense")],
              f"{phase}: layer plan {sigs}")
        plans = {c.activation_dtype: self.wide_plan(phase, c)
                 for c in (cfg, cfg32)}
        model, n_params, t_init = self.family_init(phase, cfg)
        self.check_init_peak(phase, plans["bfloat16"])
        init_peak = self.init_peak_gb
        prompts = self.family_prompts(cfg, chunk=mc.chunk_size)
        rec, _ = self.family_serve(phase, cfg, model, prompts)
        want = cfg.num_layers * 4 * (
            d_in // mc.head_dim * mc.d_state * mc.head_dim
            + (mc.d_conv - 1) * (d_in + 2 * mc.n_groups * mc.d_state))
        rec.update(params=n_params, init_s=t_init, init_peak_gb=init_peak,
                   plan=plans, layers_plan=sigs,
                   cuts={"num_layers": [full.num_layers, cfg.num_layers]})
        self.record[phase] = rec
        self.check_no_kernel_launches(rec["launches"], f"{phase}")
        log(f"[{phase}] Mamba state a slot: "
            f"{rec['cache_bytes_per_slot'] / 1e6:.3f} MB float32, closed form "
            f"{cfg.num_layers} x 4 x (h n p + 3 (d_in + 2 n)) = "
            f"{want / 1e6:.3f} MB")
        check(rec["cache_bytes_per_slot"] == want,
              f"{phase} state bytes a slot {rec['cache_bytes_per_slot']} != "
              f"{want}")
        del model
        launches32 = self.f32_engine_vs_manual(phase, cfg32, prompts)
        self.check_init_peak(phase, plans["float32"])
        self.check_no_kernel_launches(launches32, f"{phase} f32")
        with self.tf32_off():
            whole = dataclasses.replace(cfg32, moe=dataclasses.replace(
                moe, capacity_factor=moe.num_experts / moe.top_k))
            model32, _, _ = self.family_init(phase, whole)
            self.reset_launches()
            rel = self.teacher_forced_vs_full(
                whole, model32, WIDE_F32_PREFILL, WIDE_F32_DECODE, 13)
            launches = self.read_launches(f"{phase}_consistency")
            del model32
        gc_collect(torch)
        rec["decode_vs_forward_rel"] = rel
        log(f"[{phase}] float32 (TF32 off), {whole.num_layers} layers, "
            f"capacity factor {whole.moe.capacity_factor:g} (e / k: no "
            f"choice dropped): prefill of {WIDE_F32_PREFILL} tokens and "
            f"{WIDE_F32_DECODE} recurrent decode steps vs one chunked "
            f"forward: rel {rel:.3e} of max |logit| (limit "
            f"{SSM_F32_TOL:g})")
        check(rel <= SSM_F32_TOL, f"{phase} decode vs forward: {rel}")
        self.check_no_kernel_launches(launches, f"{phase} consistency")
        rec["phase_s"] = time.perf_counter() - t0
        log(f"[{phase}] {rec['card']}: phase {rec['phase_s']:.1f}s wall")

    # -- [frontends] ---------------------------------------------------------
    def phase_frontends(self):
        """[frontends]: hubert-xlarge at full width and depth (48 layers,
        head dim 80, non-causal) prefills 1 x HUBERT_FRAMES frames through
        the flash kernel, 48 launches, against the einsum prefill;
        paligemma-3b at full width and depth (18 layers, head dim 256, MQA)
        prefills 256 image embeddings + 32 tokens (prefix-LM: the einsum,
        no launch) and decodes 8 steps; gemma-7b at full width with the
        depth cut 28 -> 2 prefills GEMMA_TOKENS tokens through the flash
        kernel at head dim 256, against the einsum prefill."""
        t0 = time.perf_counter()
        self.record["frontends"] = {}
        self.frontend_flash_vs_einsum(
            "hubert", self.get_config(HUBERT_ARCH), HUBERT_FRAMES,
            lambda cfg, rng: {"embeds": self.torch.as_tensor(
                rng.standard_normal((1, HUBERT_FRAMES, cfg.frontend_dim)),
                dtype=self.torch.float32, device=self.dev)})
        self.frontend_paligemma()
        gemma = self.get_config(GEMMA_ARCH)
        log(f"[frontends] cut: {gemma.name} depth {gemma.num_layers} -> "
            f"{GEMMA_LAYERS}, every width kept")
        self.frontend_flash_vs_einsum(
            "gemma", dataclasses.replace(gemma, num_layers=GEMMA_LAYERS),
            GEMMA_TOKENS,
            lambda cfg, rng: {"tokens": self.torch.as_tensor(
                rng.integers(0, cfg.vocab_size, (1, GEMMA_TOKENS)),
                device=self.dev)})
        self.record["frontends"]["phase_s"] = time.perf_counter() - t0
        log(f"[frontends] phase {self.record['frontends']['phase_s']:.1f}s "
            "wall")

    def frontend_flash_vs_einsum(self, label, cfg, s, make_batch):
        """bf16 and float32 (TF32 off): one prefill of ``s`` positions
        through flash (its launches counted: one per layer) and through
        the einsum; the last logits and the last layer's keys compared."""
        torch, lm = self.torch, self.lm
        card = self.record["device"]["nvidia_smi"]
        rec = {"arch": cfg.name, "layers": cfg.num_layers,
               "head_dim": cfg.head_dim_eff, "causal": cfg.causal,
               "positions": s}
        for dname in ("bfloat16", "float32"):
            gc_collect(torch)
            c = dataclasses.replace(cfg, param_dtype=dname,
                                    activation_dtype=dname)
            with self.tf32_off():
                model, n_params, t_init = self.family_init("frontends", c)
                batch = make_batch(c, np.random.default_rng(SERVE_SEED + 5))
                out = {}
                for flag in (True, False):
                    caches = lm.init_caches(c, 1, s, device=self.dev)
                    self.reset_launches()
                    self.sync()
                    t0 = time.perf_counter()
                    logits, _ = model.forward_prefill(batch, caches,
                                                      use_flash=flag)
                    self.sync()
                    ms = (time.perf_counter() - t0) * 1e3
                    launches = self.read_launches(
                        f"frontends_{label}"
                        + ("" if dname == "bfloat16" else "_f32")
                        + ("" if flag else "_einsum"))
                    out[flag] = (logits.float(), caches[-1].k.float(), ms,
                                 launches)
                    del caches
                del model
            rel = max(float((out[True][i] - out[False][i]).abs().max()
                            / out[False][i].abs().max()) for i in (0, 1))
            finite = bool(torch.isfinite(out[True][0]).all())
            limit = SERVE_FLASH_VS_EINSUM[dname]
            rec[dname] = {"params": n_params, "flash_ms": out[True][2],
                          "einsum_ms": out[False][2], "rel": rel,
                          "launches": out[True][3]}
            log(f"[frontends] {card}: {cfg.name} {cfg.num_layers} layers "
                f"d={cfg.d_model} hd={cfg.head_dim_eff} causal={cfg.causal}"
                f" {dname}: prefill of {s} positions, flash {out[True][2]:.1f}"
                f" ms (host clock, ends in synchronize), einsum "
                f"{out[False][2]:.1f} ms; flash vs einsum: rel {rel:.3e} of "
                f"the largest last logit / last layer key (limit {limit:g});"
                f" launches {out[True][3]}")
            check(finite, f"{label} {dname}: non-finite logits")
            check(rel <= limit, f"{label} {dname} flash vs einsum: {rel}")
            check(out[True][3]["flash_attention"] == cfg.num_layers,
                  f"{label} {dname}: {out[True][3]} flash launches for "
                  f"{cfg.num_layers} layers")
            check(not any(out[False][3].values()),
                  f"{label} {dname} einsum: a kernel launched")
        self.record["frontends"][label] = rec

    def frontend_paligemma(self):
        torch, lm = self.torch, self.lm
        card = self.record["device"]["nvidia_smi"]
        cfg = self.get_config(VLM_ARCH)
        model, n_params, t_init = self.family_init("frontends", cfg)
        rng = np.random.default_rng(SERVE_SEED + 6)
        batch = {"image_embeds": torch.as_tensor(
                     rng.standard_normal((1, cfg.num_prefix_embeds,
                                          cfg.frontend_dim)),
                     dtype=torch.float32, device=self.dev),
                 "tokens": torch.as_tensor(
                     rng.integers(0, cfg.vocab_size, (1, VLM_TEXT)),
                     device=self.dev)}
        n = cfg.num_prefix_embeds + VLM_TEXT
        caches = lm.init_caches(cfg, 1, n + VLM_DECODE, device=self.dev)
        self.reset_launches()
        self.sync()
        t0 = time.perf_counter()
        logits, _ = model.forward_prefill(batch, caches)
        seq = [logits]
        for i in range(VLM_DECODE):
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
            logits, _ = model.forward_decode(
                tok, torch.tensor([n + i], device=self.dev), caches)
            seq.append(logits)
        self.sync()
        wall = time.perf_counter() - t0
        launches = self.read_launches("frontends_paligemma")
        finite = all(bool(torch.isfinite(t).all()) for t in seq)
        self.record["frontends"]["paligemma"] = {
            "arch": cfg.name, "params": n_params, "init_s": t_init,
            "image_embeds": cfg.num_prefix_embeds, "text_tokens": VLM_TEXT,
            "decode_steps": VLM_DECODE, "wall_s": wall,
            "launches": launches, "finite": finite}
        log(f"[frontends] {card}: {cfg.name} {cfg.num_layers} layers "
            f"d={cfg.d_model} hq={cfg.num_heads} hkv={cfg.num_kv_heads} "
            f"hd={cfg.head_dim_eff} {cfg.activation_dtype}: "
            f"{cfg.num_prefix_embeds} image "
            f"embeds + {VLM_TEXT} tokens (prefix-LM: the einsum) and "
            f"{VLM_DECODE} greedy decode steps in {wall:.3f}s; every logit "
            f"finite: {finite}; launches {launches}")
        check(finite, "paligemma: non-finite logits")
        self.check_no_kernel_launches(launches, "paligemma")
        del model, caches

    def kernel_records(self):
        out = []
        # window kernels: one record per WINDOW_RECORDS path, with that
        # path's launches and the error and times at its shape
        for path, kind, setup_name, d, c, dname, n in WINDOW_RECORDS:
            for kname, line in (("spread", 51), ("gather", 108)):
                check_row = next(r for r in self.record["checks"]
                                 if r["kernel"] == kname
                                 and r.get("geometry") == kind
                                 and (r["setup"], r["d"], r["c"], r["dtype"],
                                      r["n"])
                                 == (setup_name, d, c, dname, n))
                t = self.kernel_times[(kname, setup_name, d, c, dname, n)]
                out.append({
                    "name": f"window_{kname}", "route": "cuda",
                    "source": CU_SOURCE,
                    "replaces": f"src/repro/kernels/nfft_window.py:{line}",
                    "path": path, "shape": {"geometry": kind,
                                            "setup": setup_name, "n": n,
                                            "d": d, "c": c, "dtype": dname},
                    "launches": self.path_launches[path][f"window_{kname}"],
                    "max_abs_err": check_row["max_abs_err"], "ms": t["ms"],
                    "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                    "bound_by": t["bound_by"], "library_ms": None})
        # kernel_matvec: one record per path that launches it, with that
        # path's launches and the times at its shape
        total = sum(v["kernel_matvec"] for v in self.path_launches.values())
        unrecorded = [p for p, v in self.path_launches.items()
                      if v["kernel_matvec"] and p not in self.km_path_rows]
        check(not unrecorded, f"kernel_matvec launched on {unrecorded}, "
              "which have no shape in KM_PATHS")
        recorded = 0
        for path, t in self.km_path_rows.items():
            launches = self.path_launches[path]["kernel_matvec"]
            recorded += launches
            out.append({
                "name": "kernel_matvec", "route": "cuda", "source": KM_SOURCE,
                "replaces": "src/repro/kernels/kernel_matvec.py:35",
                "path": path, "shape": {k: t[k] for k in (
                    "profile", "n_out", "n_in", "d", "c", "dtype",
                    "zero_diagonal", "splits")},
                "launches": launches, "max_abs_err": t["max_abs_err"],
                "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": None})
        check(recorded == total, f"kernel_matvec records hold {recorded} "
              f"launches, the paths made {total}")
        # window kernels on the paths of gradients, banks, the sweep,
        # multilayer SSL and graph serving: one record per path and shape
        for t in self.slice_records:
            out.append({
                "name": f"window_{t['kernel']}", "route": "cuda",
                "source": CU_SOURCE,
                "replaces": "src/repro/kernels/nfft_window.py:"
                            f"{51 if t['kernel'] == 'spread' else 108}",
                "path": t["path"], "shape": {k: t[k] for k in (
                    "geometry", "n", "d", "taps", "c", "dtype")},
                "launches": t["launches"], "max_abs_err": t["max_abs_err"],
                "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": None})
        # the deterministic spread: one record per [durable] path and shape
        for t in self.det_records:
            out.append({
                "name": "window_spread_deterministic", "route": "cuda",
                "source": CU_SOURCE,
                "replaces": "src/repro/kernels/nfft_window.py:51",
                "path": t["path"], "shape": {k: t[k] for k in (
                    "geometry", "n", "d", "taps", "c", "dtype")},
                "launches": t["launches"], "max_abs_err": t["max_abs_err"],
                "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": None, "atomic_ms": t["atomic_ms"],
                "scratch_mb": t["scratch_mb"]})
        # flash_attention: the serve path's launches; error and times at
        # the longest prompt (bf16, causal, granite heads, s = 2048)
        s = FLASH_LENGTHS[-1]
        check_row = next(r for r in self.record["checks"]
                         if r["kernel"] == "flash_attention"
                         and r["label"] == "granite" and r["sq"] == s
                         and r["dtype"] == "bfloat16")
        t = self.kernel_times[("flash_attention", s)]
        out.append({
            "name": "flash_attention", "route": "cuda", "source": FA_SOURCE,
            "design": t["design"],
            "replaces": "src/repro/kernels/flash_attention.py:34",
            "launches": self.serve_launches,
            "max_abs_err": check_row["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
        # ... the float32 kernel on [serve]'s float32 engine: error and
        # times at the same heads and length in float32
        check_row = next(r for r in self.record["checks"]
                         if r["kernel"] == "flash_attention"
                         and r["label"] == "granite" and r["sq"] == s
                         and r["dtype"] == "float32")
        t = self.kernel_times[("flash_attention", "granite_f32")]
        out.append({
            "name": "flash_attention", "route": "cuda", "source": FA_SOURCE,
            "design": t["design"],
            "replaces": "src/repro/kernels/flash_attention.py:34",
            "path": "serve_f32", "shape": {k: t[k] for k in (
                "b", "hq", "hkv", "sq", "sk", "dh", "causal", "dtype")},
            "launches": self.path_launches["serve_f32"]["flash_attention"],
            "max_abs_err": check_row["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "ceiling_ms": t["ceiling_ms"],
            "library_ms": t["library_ms"]})
        # ... on [shard_serve]'s paths, at each case's per-rank shape
        for t in self.shard_serve_rows:
            out.append({
                "name": "flash_attention", "route": "cuda",
                "source": FA_SOURCE, "design": t["design"],
                "replaces": "src/repro/kernels/flash_attention.py:34",
                "path": t["path"], "shape": {k: t[k] for k in (
                    "b", "hq", "hkv", "sq", "sk", "dh", "causal", "dtype")},
                "launches": t["launches"], "max_abs_err": t["max_abs_err"],
                "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "ceiling_ms": t["ceiling_ms"], "library_ms": t["library_ms"]})
        # ... and on the other paths that launch it, at each path's shape
        for path, label, shape, causal, dname in FAMILY_FLASH:
            check_row = next(r for r in self.record["checks"]
                             if r["kernel"] == "flash_attention"
                             and r["label"] == label and r["dtype"] == dname)
            t = self.kernel_times[("flash_attention", label)]
            b, hq, hkv, s, _, dh = shape
            out.append({
                "name": "flash_attention", "route": "cuda",
                "source": FA_SOURCE, "design": t["design"],
                "replaces": "src/repro/kernels/flash_attention.py:34",
                "path": path, "shape": {"b": b, "hq": hq, "hkv": hkv,
                                        "sq": s, "sk": s, "dh": dh,
                                        "causal": causal, "dtype": dname},
                "launches": self.path_launches[path]["flash_attention"],
                "max_abs_err": check_row["max_abs_err"], "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "ceiling_ms": t["ceiling_ms"],
                "library_ms": t["library_ms"]})
        # ... and on the float32 engines among them
        for path, label in FAMILY_FLASH_F32:
            check_row = next(r for r in self.record["checks"]
                             if r["kernel"] == "flash_attention"
                             and r["label"] == label
                             and r["dtype"] == "float32")
            t = self.kernel_times[("flash_attention", f"{label}_f32")]
            out.append({
                "name": "flash_attention", "route": "cuda",
                "source": FA_SOURCE, "design": t["design"],
                "replaces": "src/repro/kernels/flash_attention.py:34",
                "path": path, "shape": {k: t[k] for k in (
                    "b", "hq", "hkv", "sq", "sk", "dh", "causal", "dtype")},
                "launches": self.path_launches[path]["flash_attention"],
                "max_abs_err": check_row["max_abs_err"], "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "ceiling_ms": t["ceiling_ms"],
                "library_ms": t["library_ms"]})
        return out


if __name__ == "__main__":
    sys.exit(main())
