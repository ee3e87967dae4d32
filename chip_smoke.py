#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (mmvae_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:

1. device: the card's name and power limit (nvidia-smi). No CUDA, no run.
2. build: nvcc builds every kernel of the port from csrc/.
3. ar_solve: the Hopper kernels against their plain PyTorch versions at
   the main path's shape (N=128) and others, D=20, H=128, 3 hidden layers,
   real MADE masks, sign +-1, s_bound 0 and 8, TF32 off. The forward
   kernel against `unrolled_solve` at N=128 and 3840, and at evaluation's
   rows: 500 (a coherence batch) and 10,000 (one IS call, 100 datapoints x
   100 samples), there also through the Function under no_grad (one
   launch, no tape); the backward (its two launches: the reverse chain,
   which sums each block's weight and bias gradients, and the sum of the
   blocks' partial sums) against autograd through `unrolled_solve` at
   N=128, 37 and 3840, for x, every weight and every bias, on the forward
   kernel's hidden ReLU branches, three states each (`_check_backward`),
   and a second backward call bitwise equal to the first. Kernel times
   are device times (CUDA events around 20 back-to-back launches queued
   behind a device-side wait, median of 9 runs); the backward's time is the
   backward as the Function runs it, both launches, with the chain
   kernel's own device time beside it (torch.profiler). Plain times, and the kernels' call
   times with the wrapper's host work, are events around 10 back-to-back
   calls (median of 20 runs). At N=128 both kernels are timed at sign -1
   too (IAF's density direction). Then the bounds, and forward+backward
   through the autograd Function. Then both kernels at D=2, circles-
   squares' latent width (phase_ar_solve_latent2): the forward at N=128,
   37, 120, 1,000 and 10,000, the backward at N=128 and 37, both signs,
   s_bound 0 and 8, and their times and bounds. Then both at D=16
   (MedMNIST) and D=64 (CelebA; phase_ar_solve_latent64): the forward at
   N=128, 256, 7,680 (K*B of CelebA MMVAE-NF, whose solves run at B=256)
   and 10,000, the backward at N=128, 256 and 7,680, both signs, s_bound
   0 and 8, their times and bounds. Then
   ar_solve_ties: D=64, 7,680 rows at MADE's zero initial biases, at
   inputs where hidden units sit exactly at the ReLU's tie past step 0,
   so that the ties carry gradient (JAX's slope 1/2): the backward against
   its plain version, against that version at slope 0 at the ties (which
   it must miss), with the count of tied units past step 0.
4. slice: one full-width MMVAE-NF epoch on MNIST-SVHN through the port's
   CLI (`mmvae_tpu_torch.cli.train.main`, device cuda, with the config's
   analytics, phase 16): 68 train steps and
   7 val batches at B=128, latent 20, 2 MADE blocks of 3x128. Checks the
   launch counts (forward kernel 4 per train step and per val batch,
   backward kernel 4 per train step and none per val batch), the
   parameters' device and finite losses; then times steady-state steps and
   traces a few with torch.profiler.
5. parity: one float32 training step on cuda against the same step on the
   CPU in float64 on the cuda step's ReLU branches (the reference; the CPU
   float32 step, and the float64 step on its own branches, are reported
   beside it), same weights and noise, TF32 off.
6. mmvae_slice: one full-width epoch of the flagship MMVAE-DReG
   (`configs/mnist_svhn/mmvae_synth.json`: Laplace posteriors, DReG-looser,
   K=30, B=128, latent 20) through the same CLI, cut to the same data scale
   and one epoch. No ar_solve kernel is on this path: the script checks
   that neither launched, and that no step was skipped.
7. mmvae_slice_time: the flagship's steady train step (float32, TF32 off),
   then the same under its bf16 twin `mmvae_synth_bf16.json`: ms per step,
   pairs/s, eval batch ms, the step's flops counted from the layer shapes,
   and a torch.profiler trace.
8. mmvae_parity: one DReG-looser step on cuda (float32) against the same
   step on the CPU in float64 at B=32, K=30, same weights and uniform noise;
   then the bf16 step against the float32 step on cuda.
9. jnf_slice: JMVAE-NF (`configs/mnist_svhn/jmvae_nf.json`: joint encoder,
   2 MADE blocks of 3x128 per modality, no_recon false) through the CLI
   for 2 epochs at the same data scale, warmup 2: epoch 1 trains the joint
   encoder and decoders and launches no ar_solve kernel; epoch 2, after the
   optimizer reset, launches 4 forward kernels per train step and per val
   batch and 4 backward kernels per train step, and leaves every
   joint_encoder and decoder parameter bit-unchanged.
10. jnf_slice_time: the steady JNF train step in each phase: host ms,
   device time, launches, busy share, eval batch ms, peak memory, the top
   kernels and ar_solve's share of the post-warmup device time.
11. jnf_parity: one post-warmup JNF step (frozen joint, unimodal
   reconstructions on) on cuda in float32 against the CPU in float64.
12. dcca: DCCA pretraining through `mmvae_tpu_torch.cli.dcca_train` on cuda
   (the Cholesky loss, float32) for 3 epochs at batch 800, its artifact,
   the epoch time, and the cuda loss and its gradient against the float64
   CPU eigh loss on one batch at the same trunk weights.
13. jnf_dcca_slice: JMVAE-NF-DCCA (`jnf_dcca_synth.json`) for 2 epochs,
   warmup 2, grafting that artifact: the trunks equal the artifact's after
   both epochs, no ar_solve launch (no_recon: the flows run only their
   parallel direction), finite losses.
14. telbo_nf_slice: TELBO-NF (`configs/mnist_svhn/telbo_nf.json`: the
   JMVAE-NF model with 2 MAF blocks of 3x128 per modality, m_telbo_nf)
   through the CLI for 2 epochs at the same data scale, warmup 2: epoch 1
   trains the joint ELBO and launches no ar_solve kernel; epoch 2 adds the
   unimodal VAEs' ELBOs, whose forwards run both kernels under autograd: 4
   forward kernels per train step and per val batch, 4 backward kernels per
   train step. Every joint_encoder and decoder parameter bit-unchanged over
   epoch 2, the unimodal encoders and MADE blocks moved. Then its steady
   post-warmup step (host ms, device time, launches, busy share, ar_solve's
   share of the device time) and the step on cuda in float32 against the
   CPU in float64 (telbo_nf_parity).
15. mvae_slice, moepoe_slice: one epoch of `mvae_synth.json` and of
   `moepoe_synth.json` (beta_kl 20) through the CLI at the same scale
   (m_self_built, no flow): neither ar_solve kernel launched, finite
   losses, no skipped step; the steady step; the cuda float32 step against
   the float64 CPU step (mvae_parity, moepoe_parity).
16. analytics: the MMVAE-NF epoch of phase 4 ran with its config's own
   "no_analytics": false; its epoch-1 grids are valid PNGs, and their 4
   forward launches are counted apart from the epoch's.
17. eval_validate: `mmvae_tpu_torch.cli.validate` on cuda (--repeats 1,
   --fid-encoder classifier) over the full synthetic test set for the
   MMVAE-NF, flagship, JMVAE-NF, MVAE and MoE-PoE runs of phases 4, 6, 9
   and 15, the eval classifiers trained into the pool first: coherence in
   [0, 1], finite FIDs, 4 forward launches per conditional sampling call of
   a flow family (coherence and FID per test batch, the grids once), none
   backward, none at all for the families without a flow.
18. eval_likelihoods: `mmvae_tpu_torch.cli.compute_likelihoods --bis` on
   cuda at K=1000 in chunks of 100 over the first test batch of 500, cut
   from the full test set, one repeat, for the same runs: finite values, peak memory, seconds per
   batch, the forward launches (200 per batch for the conditional
   likelihoods, as many for JMVAE-NF's bis proposals), none backward;
   MVAE's and MoE-PoE's metric names; and the share of one JMVAE-NF
   batch's device time in the forward kernel, from torch.profiler.
19. eval_parity: the conditional likelihoods (MVAE's joint likelihood too)
   and coherence of the JMVAE-NF, MVAE and MoE-PoE runs on 16 test rows
   (K=200) on cuda in float32 against the CPU in float64, with the same
   weights, classifiers and noise.
20. eval_memory: where the likelihood run's peak memory goes (the SVHN
   decoder with cuDNN, with cudnn.benchmark and without cuDNN), what the
   rows of an IS call trade between memory and time, and ten small test
   batches in one likelihood call against one call each.
21. gen_slice: the ms_small augmentation experiment through the CLIs on
   cuda at full width and a quarter of the published data (synthetic_n
   5,000, len_train 2,500; published 20,000 and 10,000): `jnf_synth.json` (2
   epochs, warmup 2; published 200/100) publishes the joint-encoder pool;
   `generate_joint --n 2250` fits a 10-component mixture by EM on the
   2,176 train latents and decodes 2,250 samples; `jnf_gen_synth.json` (1
   epoch) appends them (use_gen); `validate --prd` on it; `plot_results`
   in its three modes; a `use_pretrain` resume (1 epoch). Checks the
   printed count, the train pairs (2,250, then 4,500), the joint encoder
   and decoders bit-unchanged,
   finite losses and no skipped step, PRD in [0, 1], valid PNGs, the
   resume's args and starting parameters, and each path's ar_solve launches
   as predicted (phase_gen_slice); then stage 2's steady step and the
   times of generate_joint's parts and of PRD (gen_slice_time).
22. gen_parity: k-means, EM, the mixture's density, PRD and the Bernoulli
   log-density on the card in float64 against the CPU in float64 from the
   same inputs and starts.
23. circles_slice: circles-squares through the CLIs on cuda at full width
   (one-channel 32x32 conv nets, latent 2): mmvae.json (MMVAE-DReG, K=10)
   for 1 epoch of its published 200,000 pairs and jmvae_nf_dcca.json
   (JMVAE-NF, no_recon) at its 10,000 pairs for 2 epochs with warmup 2
   (the MMVAE epoch at a tenth of its 200,000 pairs),
   each with its epoch-1 analytics (grids and the radius analytics); their
   steady steps; validate on both (neg_entropy; the HMC product-of-
   posteriors figure for JMVAE-NF); compute_likelihoods --bis on one test
   batch of JMVAE-NF; dcca_train --dataset circles_squares; each path's
   launches as predicted (phase_circles_slice).
24. circles_parity: a circles MMVAE-DReG step and a JMVAE-NF step on cuda
   against float64 on the CPU; one HMC step at the PoE figure's shape from
   the same noise; neg_entropy and rayon_corr_* from the same noise, each
   pixel within RADIUS_KINK_ATOL of the 0.5 threshold read on the card's
   side.
25. mnist1ch_slice: jnf_mnist_fashion and jnf_mnist_contour (2 epochs,
   warmup 2; MNIST-Fashion at an eighth of its default data) and
   mnist_fashion (1 epoch) through the CLIs from configs written in the
   run's directory, their launches as predicted, the fashion JMVAE-NF's
   steady post-warmup step, validate on each.
26. medmnist_slice: MedMNIST (ResNet nets, pneumonia <-> blood) and
   chest-SVHN through the CLIs at the loaders' default scale:
   jnf_sbound.json (latent 16, s_bound 8) 2 epochs with warmup 2 (0
   launches, then 4 forward per step and val batch and 4 backward per
   step), validate and one likelihood batch on it; mmvae.json and
   mvae.json for 6 steps; dcca_train --dataset medmnist and
   jmvae_nf_dcca.json on its artifact; chest_svhn/jmvae_exact_synth.json 1
   epoch; no launch on the paths without a flow.
27. celeba_slice: CelebA (64x64 ResNet image <-> 40 Bernoulli attributes):
   jmvae_nf.json (latent 64) 2 epochs with warmup 2, launches counted as
   above, validate with the attribute metrics and one likelihood batch of
   100 rows; mmvae_nf.json's steady step at K=30, B=256 (the solve at
   7,680 rows); mvae.json and moepoe.json 1 epoch each.
28. resnet_parity: a post-warmup JMVAE-NF step of MedMNIST and of CelebA at B=32
   on cuda in float32 against the float64 CPU step.
29. ar_solve_latent30: both kernels at D = 30, the trimodal JMVAE-NF-DCCA
   and TELBO-NF latent: the forward at N = 256, 500 and 10,000, the
   backward at N = 256, checked, timed and bounded as at D = 16 and 64
   (it runs after phase 3's kernel phases).
30. msf_slice: trimodal MNIST-SVHN-Fashion through the CLIs at a quarter
   of the loader's default scale (4,370 train triples): jmvae_nf.json 2 epochs
   with warmup 2 and its 3x3 analytics grids (6 forward launches per
   unimodal pass over the three flows: epoch 1 its grids' 6, epoch 2 6 per
   train step and val batch, 6 backward per train step), its steady step,
   validate --mcmc-steps 100 (HMC over each 2-subset's product of experts,
   whose start launches 12), one likelihood batch of 250 rows (720 launches,
   cond_lw_subset_m); dcca_train on the three views and jmvae_nf_dcca.json
   (latent 30) on its artifact, with validate and a likelihood batch;
   telbo_nf.json (latent 30) one epoch past warmup (both kernels at D = 30
   under autograd); mmvae.json and mvae.json 5 steps and validate, no
   launch (phase_msf_slice).
31. msf_parity: a post-warmup trimodal JMVAE-NF step on cuda in float32
   against the float64 CPU step on the card's ReLU branches.
32. iaf_slice: jmvae_nf.json with "flow": "iaf" through the CLI for 2
   epochs, warmup 2, with its analytics: IAF samples in parallel, so the
   grids, the warmup epoch, validate and a likelihood batch launch
   nothing; past warmup its density direction (compute_kld) runs the
   forward kernel at sign -1, 4 per train step and val batch, and the
   backward at sign -1, 4 per train step; its steady post-warmup step.
33. tail_slice: m_jmvae, m_vaevae_kl, m_vaevae_w2, m_svae, m_multi_elbos
   and m_telbo on jmvae_nf.json (MAF) past warmup, 7 Trainer steps each:
   0 launches a step for m_jmvae, 4 forward and 4 backward at sign +1 for
   the others (the VAEs' MAF sampling under autograd); the joint encoder
   unchanged under m_jmvae and m_vaevae_*.
34. linnf_slice: "flow": "lin_nf" on mmvae_nf_synth.json and jmvae_nf.json,
   7 Trainer steps each, no launch.
35. tail_parity: the post-warmup IAF JMVAE-NF step, an m_telbo and an
   m_vaevae_w2 step and a unimodal DReG step at K=30 (MAF) on cuda in
   float32 against the float64 CPU step on the card's ReLU branches.
36. ddp_parity: data-parallel steps, two ranks on the one card over gloo
   (torch.multiprocessing's spawn) against one process on the card: an
   MMVAE-NF step and a post-warmup JMVAE-NF step on jnf_mnist_fashion
   (BatchNorm over the global batch), each rank on 64 rows with its rows of
   the same noise; the ranks' all-reduced gradients equal, within 1e-4 of
   each leaf of the float64 CPU step on the ranks' ReLU branches, the
   summed objective against the one-process one, 4 forward and 4 backward
   launches a step on each rank, the parameters equal after 3 steps.
37. ddp_slice: the train CLI under `torchrun --standalone` (each rank
   through `chip_smoke.py ddp-rank`): one rank over NCCL, then two ranks on
   the card over gloo with mesh_data 2, one MMVAE-NF epoch each with its
   analytics: each rank's launches as predicted (rank 0's grids apart),
   rank 0 alone writes the run dir, each rank's train step and one
   all-reduce of the gradient's size timed. (Phase 12's DCCA CLI also
   writes embedding_{0,1}.png with the UMAP on the card, its layout timed,
   and prints its SVM probe's accuracies, the probe timed.)
38. fid_validate: `cli/validate.py` with its default FID flags (the
   InceptionV3 FID net at its seeded random init, --repeats 1) on the
   MMVAE-NF run over the full test set: an FID per direction, the net's
   seconds, images a second and peak memory, the forward launches as with
   the classifier encoder.
39. fid_parity: the InceptionV3 on the card in float32 against float64 on
   the CPU at the same weights (torch's default init, randomised
   BatchNorm statistics), 8 images at 299 x 299, rtol 1e-3 and atol 1e-4;
   then those weights as a pytorch-fid checkpoint through
   `make_inception_fn(weights_path)`: the same activations.
40. real_layout: `data/make_real_layout.py` writes a layout of 512 a split,
   its CelebA crops rewritten with rows under Average and Paeth (PIL's
   files are mostly Paeth; the layout's writer uses filter 0) and 4,096
   such crops decoded at once by `read_pngs`, timed and projected to
   CelebA's 202,599; with MMVAE_TPU_REQUIRE_REAL=1 the MNIST-SVHN and
   CelebA loaders read the layout through the port's own PNG reader, not
   PIL, and one mmvae_nf_synth.json epoch trains from it, its launches
   4 x (steps + val batches) and 4 x steps.
41. probes: dcca_train's SVM probe accuracies of phase 12, and
   `classify_latent` (the hinge SGD probe) on the MMVAE-NF run's joint
   latents on the host (its default) and on the card, each timed.
42. sweep: `cli/sweep.py` from a JSON spec, two random trials of a tiny
   circles config through the train CLI on cuda.
43. ksplit_parity: the flagship's step (MMVAE-DReG-looser, K=30, B=32)
   with the K split over 'k' (`parallel.split_k`, MMVAE.k_split), two gloo
   ranks on the card at mesh (1, 2) and four at (2, 2), against one
   process at the same global noise cut by K, then by rows: the ranks'
   summed objective within STEP_OBJ_RTOL of the one process's, their
   gradient within MMVAE_GRAD_TOL of each leaf of the float64 CPU step,
   the same on every rank; the gather of the log-weights timed.
44. The kernels line (with the launches at sign -1 of the IAF, tail and
   LinearNF paths, and each rank's of the data-parallel paths), and last
   the contract line
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import functools
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "configs", "mnist_svhn", "mmvae_nf_synth.json")
FLAGSHIP = os.path.join(ROOT, "configs", "mnist_svhn", "mmvae_synth.json")
FLAGSHIP_BF16 = os.path.join(ROOT, "configs", "mnist_svhn", "mmvae_synth_bf16.json")
JNF = os.path.join(ROOT, "configs", "mnist_svhn", "jmvae_nf.json")
JNF_DCCA = os.path.join(ROOT, "configs", "mnist_svhn", "jnf_dcca_synth.json")
TELBO_NF = os.path.join(ROOT, "configs", "mnist_svhn", "telbo_nf.json")
MVAE = os.path.join(ROOT, "configs", "mnist_svhn", "mvae_synth.json")
MOEPOE = os.path.join(ROOT, "configs", "mnist_svhn", "moepoe_synth.json")
# JMVAE-NF and TELBO-NF runs: 2 epochs, the second past warmup
JNF_RUN = dict(epochs=2, warmup=2, skip_warmup=False)
# the eval runs whose models have no flow, so launch no ar_solve kernel
NO_FLOW_RUNS = ("flagship", "mvae", "moepoe")
# rows of one IS model call at K=1000, batch_size_K=100: 100 datapoints x
# 100 samples (eval/likelihoods.py ROWS_PER_CALL)
EVAL_IS_ROWS = 10_000
# the eval phases: the likelihood protocol at K=1000 in chunks of 100 over
# the first test batch of 500, one repeat; the parity check's cut of one
# test batch (16 rows, K=200 in chunks of 100, so the float64 CPU run stays
# short)
EVAL_K, EVAL_BK, EVAL_MAX_BATCHES = 1000, 100, 1
# MVAE's and MoE-PoE's likelihood runs: one test batch of 500
POE_EVAL_BATCHES = 1
PARITY_ROWS, PARITY_K = 16, 200
# cuda float32 eval against the float64 CPU run with the same noise: the
# conditional likelihood (sums of 784 or 3,072 pixel log-densities through
# the 20-step flow solve) to rtol 1e-5; each coherence to one label of the
# 16 scored (a near-tie of two logits may fall either way in float32)
EVAL_LL_RTOL = 1e-5
# phase eval_memory: the rows of one IS call it sets against each other
# (ROWS_PER_CALL's choice), the decoder's rows without cuDNN (the native
# transposed conv loops over the rows), and the small test batches it groups
# ten to a call, as `compute_likelihoods --batch-size 50` does
MEMORY_ROWS, NATIVE_ROWS = (50_000, 10_000, 5_000), 5_000
GROUP_BATCH, GROUP_BATCHES = 50, 10

# Published peaks of an H100 SXM (dense, no sparsity) at 700 W: float32 on
# the CUDA cores and HBM3 bandwidth. A card set to a lower power limit may
# run below them; the limit is printed beside every number.
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12  # tensor cores, dense
PEAK_BYTES = 3.35e12

# Tolerances, TF32 off. Kernel vs plain version, both float32: the same
# arithmetic in another summation order, through a 20-step exp chain.
# CUDA float32 step vs the CPU float64 step: float32 round-off, accumulated
# over the batch sum of the objective (measured about 1.5e-6 of a gradient
# leaf's largest entry on an H100; the bound leaves a wide margin).
KERNEL_RTOL, KERNEL_ATOL = 1e-4, 1e-4
STEP_OBJ_RTOL = 1e-5
STEP_GRAD_TOL = 1e-4  # max |g_cuda - g_ref| / max |g_ref| per parameter
# The flagship's DReG step: its weights are softmaxes over log-weights near
# -6,000 per pair, so float32 round-off in a log-weight (an ulp there is
# 4.9e-4) moves a weight by a relative 1e-3 or so, and a gradient with it
# (tests/test_torch_mmvae.py holds float32 DReG gradients to JAX's at
# 5e-3). bf16 against float32: the rtol of the JAX package's own bf16
# tests.
# A ReLU whose float64 pre-activation lies within float32 round-off of 0
# may take the other branch in float32, and its derivative then jumps from 0
# to 1: one such element moved a gradient leaf of MVAE's SVHN encoder by
# 3.6e-3 of its largest entry on an H100 (a pre-activation of 1.3e-8, whose
# float32 round-off is 5e-7). Where `_step_parity` aligns the branches, the
# float64 reference takes each ReLU on the branch of the float32 run, and
# each element taken on the other branch must lie within RELU_KINK_ATOL of 0.
RELU_KINK_ATOL = 1e-5
MMVAE_PARITY_B = 32
MMVAE_GRAD_TOL = 2e-3
BF16_LOSS_RTOL = 0.05
# The DCCA loss on the card (Cholesky, float32) against the float64 CPU
# eigh loss: the JAX package's own tolerances (tests/test_dcca.py:36,45).
DCCA_VALUE_TOL = 2e-3
DCCA_GRAD_RTOL, DCCA_GRAD_ATOL = 5e-2, 1e-4
DCCA_EPOCHS, DCCA_BATCH = 3, 800


def emit(obj):
    print(json.dumps(obj), flush=True)


def cuda_time_ms(fn, reps=10, rounds=20, warmup=3):
    """Time of one call: CUDA events around `reps` back-to-back calls, over
    the count; the median of `rounds` such runs."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def device_time_ms(fn, reps=20, rounds=9, warmup=3):
    """Device time of one call: as `cuda_time_ms`, but the device first
    spins for a while (torch.cuda._sleep), so that the host has enqueued all
    `reps` calls before the first one starts and its own time per call is
    not in the reading."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        torch.cuda._sleep(100_000_000)  # about 50 ms at the H100's clock
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def phase_build():
    from mmvae_tpu_torch.ops import build

    sources = sorted(f for f in os.listdir(build.CSRC) if f.endswith(".cu"))
    t0 = time.perf_counter()
    for source in sources:
        build.load(source)
    wall = time.perf_counter() - t0
    ptxas = {s: [l.strip() for l in log.splitlines() if "Used" in l or "spill" in l]
             for s, (_, log) in build.build_log.items()}
    emit({"phase": "build", "sources": sources, "seconds": round(wall, 3), "ptxas": ptxas})


def solve_flops(n, d, h, n_hidden):
    """Flops of the forward solve. At step 0 no feature of y is known:
    MADE's masks leave head columns 0 and D (mu_0, s_0) their biases alone,
    so the step needs no product. Each of the other D-1 steps takes per row
    one rank-1 term of the first layer (y gained one feature), the other
    hidden layers and the two head columns (mu_i, s_i) that it uses:
    2*n*(d-1)*(h + (L-1)*h*h + 2*h). The reverse chain does the same
    products transposed: y's gradient at feature i is W0[i, :] . dsum, an
    O(h) term."""
    return 2 * n * (d - 1) * (h + (n_hidden - 1) * h * h + 2 * h)


def vjp_flops(n, d, h, n_hidden):
    """Flops of the whole backward: the reverse chain, then the weight
    gradients, sums over rows and steps of outer products of each step's
    layer inputs and deltas. Step 0's delta reaches the head's biases
    alone; each other step adds the hidden layers in full and the head's
    two nonzero delta columns; the first layer's gradient row i is the
    rank-1 form y_i * dsum (2*n*h a row i < D-1, where the outer products
    of its i nonzero inputs at step i take n*h*d*(d-1)). Then the bias sums: the
    hidden biases over the D-1 steps, the head's 2D over all."""
    weights = 2 * n * (d - 1) * ((n_hidden - 1) * h * h + 2 * h) + 2 * n * (d - 1) * h
    biases = n * ((d - 1) * n_hidden * h + 2 * d)
    return solve_flops(n, d, h, n_hidden) + weights + biases


def vjp_bytes(n, d, n_w, n_b):
    """Bytes of the whole VJP, as its plain version computes it: read once
    x, y, gy, gld, the weights and biases; written once gx and every weight
    and bias gradient. The tape and the blocks' partial sums are scratch of
    this design, not counted."""
    return 4 * (4 * n * d + n + 2 * (n_w + n_b))


def bound(flops, n_bytes):
    """(bound ms, what bounds it): the larger of the flops at the f32 peak
    and the bytes at the memory rate."""
    by = "operations" if flops / PEAK_F32_FLOPS >= n_bytes / PEAK_BYTES else "bytes"
    return max(flops / PEAK_F32_FLOPS, n_bytes / PEAK_BYTES) * 1e3, by


def _made_params(d, h, n_hidden, gen):
    import torch

    from mmvae_tpu_torch.flows import MADE
    from mmvae_tpu_torch.nets import init_parameters

    made = MADE(d, (h,) * n_hidden)
    init_parameters(made, gen)
    with torch.no_grad():
        for layer in [*made.hidden, made.out]:
            layer.bias.copy_(torch.empty(layer.bias.shape).uniform_(-0.1, 0.1, generator=gen))
        ws, bs = made.cuda().masked_layer_params()
    return [w.contiguous() for w in ws], [b.contiguous() for b in bs]


def _check_close(what, pairs):
    """Largest abs error over (got, want) pairs; raises past rtol/atol."""
    import torch

    err = max((a - b).abs().max().item() for a, b in pairs)
    ref = max(b.abs().max().item() for _, b in pairs)
    ok = all(torch.allclose(a, b, rtol=KERNEL_RTOL, atol=KERNEL_ATOL) for a, b in pairs)
    emit({"phase": "ar_solve_check", **what, "max_abs_err": err,
          "max_rel_err": err / max(ref, 1e-30), "rtol": KERNEL_RTOL, "atol": KERNEL_ATOL,
          "ok": ok})
    if not ok:
        raise AssertionError(f"ar_solve kernel disagrees at {what}: max abs err {err}")
    return err


def _plain_vjp(x, ws, bs, sign, s_bound, gy, gld):
    """Autograd through `unrolled_solve`: the backward kernel's plain version.
    Records the graph once and returns a function that runs its backward
    (gradients for x, every weight and every bias), as often as called."""
    import torch

    from mmvae_tpu_torch.ops import ar_flow

    inputs = [t.detach().clone().requires_grad_(True) for t in (x, *ws, *bs)]
    with torch.enable_grad():
        outs = ar_flow.unrolled_solve(inputs[0], inputs[1:1 + len(ws)], inputs[1 + len(ws):],
                                      sign, s_bound)
    return lambda: torch.autograd.grad(outs, inputs, (gy, gld), retain_graph=True)


def _check_backward(what, x, ws, bs, sign, s_bound, gy, gld, tie_control=False):
    """The backward (both launches) against autograd through
    `unrolled_solve`, for x, every weight and every bias; the
    reference takes the forward kernel's hidden ReLU branches
    (`_ReluBranches` replaying `_kernel_branches`), each one off its own
    branch within RELU_KINK_ATOL of 0: over thousands of rows the solve
    evaluates millions of hidden ReLUs, and one whose pre-activation lies
    within float32 round-off of 0 may take the other branch in either
    version, a jump in its row's gradient. Where no branch differs, that
    reference is autograd through `unrolled_solve` as it is; the error
    against it on its own branches stands beside, and the count of hidden
    units that the kernel's tape holds exactly at the tie past step 0 (at
    step 0 every unit at zero biases is tied, and no head column reads
    one). A second backward call must give bitwise equal gradients. With
    `tie_control`, the reference is replayed once more with slope 0 at the
    ties (torch.relu's), and the kernel must miss that one past
    KERNEL_RTOL/KERNEL_ATOL: the ties carry gradient, and the kernel takes
    them at 1/2. Returns the max abs error."""
    import torch

    from mmvae_tpu_torch.ops import ar_flow

    tape = ar_flow.new_tape(x, ws)
    y, _ = ar_flow.kernel_forward(x, ws, bs, sign, s_bound, tape=tape)
    gx, gws, gbs = ar_flow.kernel_backward(x, y, gy, gld, tape, ws, sign, s_bound)
    got = [gx, *gws, *gbs]
    again = ar_flow.kernel_backward(x, y, gy, gld, tape, ws, sign, s_bound)
    own = _plain_vjp(x, ws, bs, sign, s_bound, gy, gld)()
    with _ReluBranches(replay=_kernel_branches(tape)) as rb:
        want = _plain_vjp(x, ws, bs, sign, s_bound, gy, gld)()
    torch.cuda.synchronize()
    if rb.flip_max_abs > RELU_KINK_ATOL:
        raise AssertionError(f"ar_solve forward kernel at {what}: a hidden ReLU off its "
                             f"branch at |x| = {rb.flip_max_abs}")
    repeat = all(torch.equal(a, b) for a, b in zip(got, [again[0], *again[1], *again[2]]))
    if not repeat:
        raise AssertionError(f"ar_solve backward at {what}: two calls differ")
    control = {}
    if tie_control:
        with _ReluBranches(replay=[c.masked_fill(c == 1, 0) for c in _kernel_branches(tape)]):
            slope0 = _plain_vjp(x, ws, bs, sign, s_bound, gy, gld)()
        control = dict(max_abs_err_at_tie_slope_0=max(
            (a - b).abs().max().item() for a, b in zip(got, slope0)))
        if all(torch.allclose(a, b, rtol=KERNEL_RTOL, atol=KERNEL_ATOL)
               for a, b in zip(got, slope0)):
            raise AssertionError(f"ar_solve backward at {what}: slope 0 at the ties gives the "
                                 f"same gradients; no tie carries gradient")
    return _check_close(dict(kernel="backward", **what, relu_flips=rb.flips,
                             relu_flip_max_abs=rb.flip_max_abs,
                             ties_past_step_0=sum(int((z[1:] == 0).sum()) for z in tape.z),
                             bitwise_repeat=repeat, **control,
                             max_abs_err_own_branches=max(
                                 (a - b).abs().max().item() for a, b in zip(got, own))),
                        list(zip(got, want)))


def backward_kernel_ms(fn, reps=20):
    """The device time per call of each of the backward's two kernels, the
    reverse chain and the sum of the blocks' partial sums, from a
    torch.profiler trace of `reps` calls: {"chain": ms, "sum": ms}, None
    where the trace holds no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for key, name in (("chain", "ar_solve_backward_kernel"), ("sum", "ar_solve_sum_kernel")):
        us = sum(getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
                 for e in prof.key_averages() if name in e.key)
        out[key] = us / reps / 1e3 if us > 0 else None
    return out


def phase_ar_solve():
    import torch

    from mmvae_tpu_torch.eval.likelihoods import ROWS_PER_CALL
    from mmvae_tpu_torch.ops import ar_flow

    assert ROWS_PER_CALL == EVAL_IS_ROWS

    d, h, n_hidden = 20, 128, 3
    gen = torch.Generator().manual_seed(0)
    ws, bs = _made_params(d, h, n_hidden, gen)
    fwd_err = bwd_err = eval_fwd_err = 0.0

    # forward kernel against the plain version: the training path's rows,
    # a coherence batch (ns*B = 500) and one IS call (100 datapoints x 100)
    for n in (128, 500, 3840, EVAL_IS_ROWS):
        x = torch.randn(n, d, generator=gen).cuda()
        for sign in (1, -1):
            for s_bound in (0.0, 8.0):
                with torch.no_grad():
                    y_k, ld_k = ar_flow.kernel_forward(x, ws, bs, sign, s_bound)
                    y_p, ld_p = ar_flow.unrolled_solve(x, ws, bs, sign, s_bound)
                torch.cuda.synchronize()
                err = _check_close(dict(kernel="forward", n=n, sign=sign, s_bound=s_bound),
                                   [(y_k, y_p), (ld_k, ld_p)])
                if n == 128:
                    fwd_err = max(fwd_err, err)
                elif n in (500, EVAL_IS_ROWS):
                    eval_fwd_err = max(eval_fwd_err, err)

    # eval's call: the Function under no_grad, with parameters that require
    # grad as a model's do: one forward launch and no tape
    params = [t.clone().requires_grad_(True) for t in (*ws, *bs)]
    new_tape = ar_flow.new_tape

    def no_tape(*args, **kwargs):
        raise AssertionError("ar_solve allocated a tape under no_grad")

    ar_flow.new_tape = no_tape
    try:
        for n in (500, EVAL_IS_ROWS):
            x = torch.randn(n, d, generator=gen).cuda()
            before = (ar_flow.ar_solve.launches, ar_flow.ar_solve.backward_launches)
            with torch.no_grad():
                y, ld = ar_flow.ar_solve(x, params[:len(ws)], params[len(ws):], 1, 0.0)
                y_p, ld_p = ar_flow.unrolled_solve(x, ws, bs, 1, 0.0)
            torch.cuda.synchronize()
            launched = (ar_flow.ar_solve.launches - before[0],
                        ar_flow.ar_solve.backward_launches - before[1])
            if launched != (1, 0) or y.grad_fn is not None:
                raise AssertionError(f"ar_solve under no_grad at N={n}: launches {launched}, "
                                     f"output with a graph: {y.grad_fn is not None}")
            _check_close(dict(kernel="forward_no_grad", n=n, sign=1, s_bound=0.0),
                         [(y, y_p), (ld, ld_p)])
    finally:
        ar_flow.new_tape = new_tape

    # backward kernel and the wrapper's reduction against autograd through
    # the plain version on the forward kernel's ReLU branches
    for n in (128, 37, 3840):
        x = torch.randn(n, d, generator=gen).cuda()
        gy = torch.randn(n, d, generator=gen).cuda()
        gld = torch.randn(n, generator=gen).cuda()
        for sign in (1, -1):
            for s_bound in (0.0, 8.0):
                err = _check_backward(dict(n=n, sign=sign, s_bound=s_bound), x, ws, bs, sign,
                                      s_bound, gy, gld)
                if n == 128:
                    bwd_err = max(bwd_err, err)

    n_w = sum(w.numel() for w in ws)
    n_b = sum(b.numel() for b in bs)
    results = {}
    for n in (128, 500, 3840, EVAL_IS_ROWS):
        x = torch.randn(n, d, generator=gen).cuda()
        with torch.no_grad():
            k_ms = device_time_ms(lambda: ar_flow.kernel_forward(x, ws, bs, 1, 0.0))
            call_ms = cuda_time_ms(lambda: ar_flow.kernel_forward(x, ws, bs, 1, 0.0))
            p_ms = cuda_time_ms(lambda: ar_flow.unrolled_solve(x, ws, bs, 1, 0.0), rounds=5)
        flops = solve_flops(n, d, h, n_hidden)
        # each input read once (x, masked weights, biases), each output
        # written once (y, logdet)
        n_bytes = 4 * (2 * n * d + n + n_w + n_b)
        bound_ms, bound_by = bound(flops, n_bytes)
        results[n] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=bound_ms, bound_by=bound_by)
        emit({"phase": "ar_solve_time", "kernel": "forward", "n": n, "kernel_ms": k_ms,
              "call_ms": call_ms, "plain_ms": p_ms, "flops": flops,
              "bytes": n_bytes, "bound_ms": bound_ms,
              "bound_by": bound_by, "achieved_tflops": flops / (k_ms * 1e-3) / 1e12,
              "roofline_share": bound_ms / k_ms})

    # at N=128: the recording forward, the backward (both launches, with
    # the chain kernel's own time beside it), its plain version, and
    # forward+backward through the Function
    n = 128
    x = torch.randn(n, d, generator=gen).cuda()
    gy = torch.randn(n, d, generator=gen).cuda()
    gld = torch.randn(n, generator=gen).cuda()
    tape = ar_flow.new_tape(x, ws)
    rec_ms = device_time_ms(lambda: ar_flow.kernel_forward(x, ws, bs, 1, 0.0, tape=tape))
    y, _ = ar_flow.kernel_forward(x, ws, bs, 1, 0.0, tape=tape)

    def bwd():
        ar_flow.kernel_backward(x, y, gy, gld, tape, ws, 1, 0.0)

    b_ms = device_time_ms(bwd)
    b_call_ms = cuda_time_ms(bwd)
    split = backward_kernel_ms(bwd)
    pb_ms = cuda_time_ms(_plain_vjp(x, ws, bs, 1, 0.0, gy, gld), rounds=5)
    b_flops, b_bytes = vjp_flops(n, d, h, n_hidden), vjp_bytes(n, d, n_w, n_b)
    b_bound_ms, b_bound_by = bound(b_flops, b_bytes)
    results["backward"] = dict(ms=b_ms, kernel_ms=split["chain"], plain_ms=pb_ms,
                               bound_ms=b_bound_ms, bound_by=b_bound_by)
    emit({"phase": "ar_solve_time", "kernel": "backward", "n": n, "ms": b_ms,
          "kernel_ms": split["chain"], "sum_kernel_ms": split["sum"], "call_ms": b_call_ms,
          "plain_ms": pb_ms, "recording_forward_ms": rec_ms, "flops": b_flops,
          "bytes": b_bytes, "bound_ms": b_bound_ms, "bound_by": b_bound_by,
          "roofline_share": b_bound_ms / b_ms})

    # the same at sign -1, IAF's density direction
    y_m, _ = ar_flow.kernel_forward(x, ws, bs, -1, 0.0, tape=tape)

    def bwd_minus():
        ar_flow.kernel_backward(x, y_m, gy, gld, tape, ws, -1, 0.0)

    with torch.no_grad():
        minus = dict(ms=device_time_ms(lambda: ar_flow.kernel_forward(x, ws, bs, -1, 0.0)),
                     plain_ms=cuda_time_ms(lambda: ar_flow.unrolled_solve(x, ws, bs, -1, 0.0),
                                           rounds=5))
    minus_bwd = dict(ms=device_time_ms(bwd_minus), kernel_ms=backward_kernel_ms(bwd_minus)["chain"],
                     plain_ms=cuda_time_ms(_plain_vjp(x, ws, bs, -1, 0.0, gy, gld), rounds=5))
    results["sign_minus_n128"] = dict(forward=minus, backward=minus_bwd)
    emit({"phase": "ar_solve_time", "sign": -1, "n": n, "forward": minus, "backward": minus_bwd,
          "forward_bound_ms": results[128]["bound_ms"], "backward_bound_ms": b_bound_ms})

    xg = x.clone().requires_grad_(True)
    params = [p.detach().clone().requires_grad_(True) for p in (*ws, *bs)]

    def fwd_bwd():
        y, ld = ar_flow.ar_solve(xg, params[:len(ws)], params[len(ws):], 1, 0.0)
        (y.sum() + ld.sum()).backward()

    before = (ar_flow.ar_solve.launches, ar_flow.ar_solve.backward_launches)
    fwd_bwd()
    after = (ar_flow.ar_solve.launches, ar_flow.ar_solve.backward_launches)
    if (after[0] - before[0], after[1] - before[1]) != (1, 1):
        raise AssertionError(f"one forward+backward through the Function launched "
                             f"{after[0] - before[0]} forward and {after[1] - before[1]} "
                             f"backward kernels (expected 1 and 1)")
    fb_ms = cuda_time_ms(fwd_bwd)
    emit({"phase": "ar_solve_fwd_bwd", "n": 128, "ms": fb_ms})
    return dict(results=results, fwd_err=fwd_err, bwd_err=bwd_err, eval_fwd_err=eval_fwd_err,
                fwd_bwd_ms=fb_ms)


# circles-squares' latent width: at D = 2 every MADE degree is 0, so each
# hidden unit sees y_0 alone and only head columns 1 and 1 + D carry weights
LATENT2_FWD_ROWS = (128, 37, 120, 1_000, EVAL_IS_ROWS)
LATENT2_BWD_ROWS = (128, 37)
LATENT2_TIME_ROWS = (128, 120, 1_000, EVAL_IS_ROWS)


def phase_ar_solve_latent2():
    """Both kernels at D = 2, the width circles-squares runs them at (latent
    2, 3 hidden layers of 128): the forward against `unrolled_solve` at
    N = 128, 37 (a ragged tile), 120 (HMC's start and the PoE figure's
    samples, 4 rows x 30 chains), 1,000 (neg_entropy's 100 rows x 10
    samples) and 10,000 (an IS call); the backward (both launches)
    against autograd through `unrolled_solve` at N = 128 and 37; both
    signs, s_bound 0 and 8. Then their device times and bounds, as in
    phase ar_solve."""
    import torch

    from mmvae_tpu_torch.ops import ar_flow

    d, h, n_hidden = 2, 128, 3
    gen = torch.Generator().manual_seed(2)
    ws, bs = _made_params(d, h, n_hidden, gen)
    errs = {"forward": 0.0, "backward": 0.0}
    for n in LATENT2_FWD_ROWS:
        x = torch.randn(n, d, generator=gen).cuda()
        for sign in (1, -1):
            for s_bound in (0.0, 8.0):
                with torch.no_grad():
                    y_k, ld_k = ar_flow.kernel_forward(x, ws, bs, sign, s_bound)
                    y_p, ld_p = ar_flow.unrolled_solve(x, ws, bs, sign, s_bound)
                torch.cuda.synchronize()
                errs["forward"] = max(errs["forward"], _check_close(
                    dict(kernel="forward", d=d, n=n, sign=sign, s_bound=s_bound),
                    [(y_k, y_p), (ld_k, ld_p)]))
    for n in LATENT2_BWD_ROWS:
        x, gy = (torch.randn(n, d, generator=gen).cuda() for _ in range(2))
        gld = torch.randn(n, generator=gen).cuda()
        for sign in (1, -1):
            for s_bound in (0.0, 8.0):
                errs["backward"] = max(errs["backward"], _check_backward(
                    dict(d=d, n=n, sign=sign, s_bound=s_bound), x, ws, bs, sign, s_bound, gy,
                    gld))

    n_w = sum(w.numel() for w in ws)
    n_b = sum(b.numel() for b in bs)
    results = {}
    for n in LATENT2_TIME_ROWS:
        x = torch.randn(n, d, generator=gen).cuda()
        with torch.no_grad():
            k_ms = device_time_ms(lambda: ar_flow.kernel_forward(x, ws, bs, 1, 0.0))
            p_ms = cuda_time_ms(lambda: ar_flow.unrolled_solve(x, ws, bs, 1, 0.0), rounds=5)
        flops, n_bytes = solve_flops(n, d, h, n_hidden), 4 * (2 * n * d + n + n_w + n_b)
        bound_ms, bound_by = bound(flops, n_bytes)
        results[f"n{n}"] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=bound_ms, bound_by=bound_by)
        emit({"phase": "ar_solve_time", "kernel": "forward", "d": d, "n": n, "kernel_ms": k_ms,
              "plain_ms": p_ms, "flops": flops, "bytes": n_bytes, "bound_ms": bound_ms,
              "bound_by": bound_by, "roofline_share": bound_ms / k_ms})
    n = 128
    x, gy = (torch.randn(n, d, generator=gen).cuda() for _ in range(2))
    gld = torch.randn(n, generator=gen).cuda()
    tape = ar_flow.new_tape(x, ws)
    y, _ = ar_flow.kernel_forward(x, ws, bs, 1, 0.0, tape=tape)

    def bwd():
        ar_flow.kernel_backward(x, y, gy, gld, tape, ws, 1, 0.0)

    b_ms = device_time_ms(bwd)
    split = backward_kernel_ms(bwd)
    pb_ms = cuda_time_ms(_plain_vjp(x, ws, bs, 1, 0.0, gy, gld), rounds=5)
    b_flops, b_bytes = vjp_flops(n, d, h, n_hidden), vjp_bytes(n, d, n_w, n_b)
    b_bound_ms, b_bound_by = bound(b_flops, b_bytes)
    results["backward_n128"] = dict(ms=b_ms, kernel_ms=split["chain"], plain_ms=pb_ms,
                                    bound_ms=b_bound_ms, bound_by=b_bound_by)
    emit({"phase": "ar_solve_time", "kernel": "backward", "d": d, "n": n, "ms": b_ms,
          "kernel_ms": split["chain"], "sum_kernel_ms": split["sum"], "plain_ms": pb_ms,
          "flops": b_flops, "bytes": b_bytes, "bound_ms": b_bound_ms, "bound_by": b_bound_by,
          "roofline_share": b_bound_ms / b_ms})
    return dict(results=results, errs=errs)


def _slice_config(tmp, config=CONFIG, analytics=False, synthetic_n=2048, **overrides):
    """`config` cut to the smoke's data scale (`synthetic_n`; None keeps
    the config's own or the loader's default) and one epoch; its own
    "no_analytics" (false in every published config) where `analytics`,
    else no analytics."""
    with open(config) as f:
        raw = json.load(f)
    # an empty data directory of the run's own: the loaders take the
    # synthetic stand-in and read nothing outside the run
    data_dir = os.path.join(tmp, "data")
    os.makedirs(data_dir, exist_ok=True)
    if synthetic_n is not None:
        raw["synthetic_n"] = synthetic_n
    raw.update({"epochs": 1, "data_path": data_dir, **overrides})
    if not analytics:
        raw["no_analytics"] = True
    path = os.path.join(tmp, "smoke_" + os.path.basename(config))
    with open(path, "w") as f:
        json.dump(raw, f)
    return path, raw


def _data_loaders(cfg):
    """The (train, test, val) loaders that the train CLI builds for `cfg`:
    its model's dataset, with the config's keys that the dataset takes."""
    from mmvae_tpu_torch.cli.common import loader_kwargs
    from mmvae_tpu_torch.data.loaders import get_dataloaders
    from mmvae_tpu_torch.models import registry

    dataset = registry.build(cfg).dataset
    return get_dataloaders(dataset, batch_size=cfg.batch_size, **loader_kwargs(cfg, dataset))


def _reset_counts():
    """Set the ar_solve launch counts, those at sign -1 too, to 0."""
    from mmvae_tpu_torch.ops import ar_flow

    a = ar_flow.ar_solve
    a.launches = a.backward_launches = a.sign_minus_launches = a.sign_minus_backward_launches = 0


def _cli_epoch(tmp, config, analytics=False, **overrides):
    """`config`, cut as _slice_config cuts it (one epoch unless `overrides`
    say otherwise), through the port's CLI on cuda, with the ar_solve counts
    set to 0 just before and read just after. The counts and the trainable
    state are also read at the end of each epoch, by one more callback of
    the Trainer's fit, and the counts once more before the CLI's own
    callbacks, so that the analytics' launches are counted apart."""
    import torch

    from mmvae_tpu_torch.cli.train import main as train_main
    from mmvae_tpu_torch.core.config import ExperimentConfig
    from mmvae_tpu_torch.ops import ar_flow
    from mmvae_tpu_torch.train import Trainer

    cfg_path, raw = _slice_config(tmp, config, analytics, **overrides)
    cfg = ExperimentConfig.from_json(cfg_path)
    bsz = cfg.batch_size
    train_loader, _, val_loader = _data_loaders(cfg)
    # the device pipeline drops a ragged last batch, in validation too; a
    # val set smaller than a batch runs as one batch from the host
    n_val = val_loader.num_examples
    steps, val_batches = train_loader.num_examples // bsz, max(n_val // bsz, int(n_val > 0))

    epochs, before_callbacks = [], []

    def at_epoch_end(trainer, epoch, *args, **kwargs):
        torch.cuda.synchronize()
        epochs.append({"epoch": epoch, "launches": ar_flow.ar_solve.launches,
                       "backward_launches": ar_flow.ar_solve.backward_launches,
                       "sign_minus": (ar_flow.ar_solve.sign_minus_launches,
                                      ar_flow.ar_solve.sign_minus_backward_launches),
                       "params": {n: p.detach().clone()
                                  for n, p in trainer.model.named_parameters()}})

    def before_cli_callbacks(trainer, epoch, *args, **kwargs):
        before_callbacks.append(ar_flow.ar_solve.launches)

    fit = Trainer.fit

    def fit_with_probe(self, *args, callbacks=None, **kwargs):
        return fit(self, *args, callbacks=[before_cli_callbacks, *(callbacks or []), at_epoch_end],
                   **kwargs)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    Trainer.fit = fit_with_probe
    try:
        _reset_counts()
        t0 = time.perf_counter()
        run_path = train_main(["--config-path", cfg_path, "--experiments-dir",
                               os.path.join(tmp, "experiments"), "--device", "cuda"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ar_flow.ar_solve.launches
        bwd_launches = ar_flow.ar_solve.backward_launches
    finally:
        Trainer.fit = fit
    peak = torch.cuda.max_memory_allocated()

    state = torch.load(os.path.join(run_path, "model.pt"), weights_only=True)
    on_cuda = all(t.is_cuda for t in state.values())
    with open(os.path.join(run_path, "losses.json")) as f:
        losses = json.load(f)
    with open(os.path.join(run_path, "metrics.jsonl")) as f:
        metrics = [json.loads(line) for line in f]
    finite = all(math.isfinite(v) for v in losses["train_loss"] + losses["test_loss"])
    # the trainer normalizes nan_skipped by all pairs, as the JAX package does
    skipped_steps = sum(m.get("train_nan_skipped", 0.0) for m in metrics) * train_loader.num_examples
    info = {"run_path": run_path, "train_pairs": train_loader.num_examples,
            "val_pairs": val_loader.num_examples, "train_steps": steps,
            "val_batches": val_batches, "ar_solve_launches": launches,
            "ar_solve_backward_launches": bwd_launches, "params_on_cuda": on_cuda,
            "train_loss": losses["train_loss"], "val_loss": losses["test_loss"],
            "losses_finite": finite, "nan_skipped_fraction": skipped_steps / (steps * len(metrics)),
            "epoch_wall_s_incl_setup": wall, "peak_mem_bytes": peak,
            "launches_by_epoch": [(e["launches"], e["backward_launches"]) for e in epochs],
            "sign_minus_launches_by_epoch": [e["sign_minus"] for e in epochs],
            "callback_launches_by_epoch": [e["launches"] - b
                                           for e, b in zip(epochs, before_callbacks)]}
    return cfg, train_loader, info, epochs


def _trainer_batches(cfg, train_loader, epoch, n):
    """A Trainer of `cfg` on cuda with its initial weights and the
    optimizer it runs at `epoch` (Adam after a warmup's reset, AMSGrad
    before), and the first `n` train batches gathered on the card."""
    import torch

    from mmvae_tpu_torch.models import registry
    from mmvae_tpu_torch.train import Trainer

    bundle = registry.build(cfg)
    trainer = Trainer(bundle.model, bundle.spec, cfg, device="cuda")
    trainer.init_parameters()
    past = epoch >= cfg.warmup
    trainer.init_opt_state(past_warmup=past, amsgrad=not (past and cfg.warmup > 0))
    pipeline = trainer.make_device_pipeline(train_loader)
    return trainer, [pipeline.gather(torch.from_numpy(r).cuda())
                     for r in list(pipeline.epoch_index_batches())[:n]]


def _steady_steps(cfg, train_loader, n_warm=5, n_timed=10, epoch=1):
    """Steady-state train step and eval batch at the epoch's shapes,
    outside the counted run: host clock over `n_timed` steps after
    `n_warm`, then a torch.profiler trace of 3 steps. `epoch` selects the
    warmup phase (epoch < warmup) or the one after it, with the optimizer
    the Trainer resets to there."""
    import torch

    trainer, batches = _trainer_batches(cfg, train_loader, epoch, n_warm + n_timed)
    for xs in batches[:n_warm]:
        trainer.train_step(xs, cfg.learning_rate, epoch=epoch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for xs in batches[n_warm:]:
        trainer.train_step(xs, cfg.learning_rate, epoch=epoch)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / n_timed
    gen = torch.Generator(device="cuda").manual_seed(0)
    eval_ms = cuda_time_ms(lambda: trainer.eval_step(batches[0], epoch=epoch, generator=gen),
                           rounds=5)
    prof = profile_steps(trainer, batches[n_warm:n_warm + 3], cfg.learning_rate, epoch)
    if "device_us_per_step" in prof:
        # the profiler's own busy share is over a window its tracing slows;
        # this one is over the untraced step
        prof["device_share_of_timed_step"] = prof["device_us_per_step"] / (step_s * 1e6)
    return trainer, batches, step_s, eval_ms, prof


def phase_slice(tmp):
    """The MMVAE-NF epoch through the CLI with the config's own analytics:
    its epoch-1 grids' launches (phase analytics) are counted apart."""
    cfg, train_loader, info, _ = _cli_epoch(tmp, CONFIG, analytics=True)
    steps, val_batches = info["train_steps"], info["val_batches"]
    (analytics_launches,) = info["callback_launches_by_epoch"]
    launches = info["ar_solve_launches"] - analytics_launches
    bwd_launches = info["ar_solve_backward_launches"]
    expected, bwd_expected = 4 * (steps + val_batches), 4 * steps
    emit({"phase": "slice", **info, "epoch_launches": launches, "expected_launches": expected,
          "expected_backward_launches": bwd_expected})
    if (launches, bwd_launches) != (expected, bwd_expected) or (steps, val_batches) != (68, 7):
        raise AssertionError(f"ar_solve launched {launches} forward and {bwd_launches} backward "
                             f"kernels for {steps} train steps and {val_batches} val batches "
                             f"(expected {expected} and {bwd_expected}, 68+7)")
    if not info["params_on_cuda"] or not info["losses_finite"]:
        raise AssertionError(f"params on cuda: {info['params_on_cuda']}, "
                             f"finite losses: {info['losses_finite']}")

    _, _, step_s, eval_ms, prof = _steady_steps(cfg, train_loader)
    emit({"phase": "slice_time", "train_step_ms": step_s * 1e3, "steps_per_s": 1.0 / step_s,
          "eval_batch_ms": eval_ms, **prof})
    return dict(launches=launches, bwd_launches=bwd_launches, steps_per_s=1.0 / step_s,
                peak=info["peak_mem_bytes"], run_path=info["run_path"],
                analytics_launches=analytics_launches)


def phase_mmvae_slice(tmp):
    """The flagship's epoch: no ar_solve launch, no skipped step."""
    cfg, train_loader, info, _ = _cli_epoch(tmp, FLAGSHIP)
    emit({"phase": "mmvae_slice", "model": cfg.model, "objective": "m_dreg_looser", "K": cfg.K,
          **info})
    launches = (info["ar_solve_launches"], info["ar_solve_backward_launches"])
    if launches != (0, 0) or (info["train_steps"], info["val_batches"]) != (68, 7):
        raise AssertionError(f"flagship epoch: {info['train_steps']} train steps and "
                             f"{info['val_batches']} val batches (expected 68+7); ar_solve "
                             f"launched {launches} (expected none)")
    if not info["params_on_cuda"] or not info["losses_finite"] or info["nan_skipped_fraction"]:
        raise AssertionError(f"flagship epoch: params on cuda {info['params_on_cuda']}, finite "
                             f"losses {info['losses_finite']}, skipped "
                             f"{info['nan_skipped_fraction']:.1%} of steps")
    return train_loader, info["run_path"]


def step_flops(trainer, xs):
    """Flops of one train step and of one eval batch, counted from the
    shapes of every Linear, Conv2d and ConvTranspose2d call of the
    objective's forward: 2 * multiply-adds forward; the backward adds a
    weight gradient for every call and an input gradient where the input
    needs one (not for the data). Elementwise work is not counted."""
    import torch

    from mmvae_tpu_torch.core import precision
    from mmvae_tpu_torch.nets import Conv2d, ConvTranspose2d, Linear

    counts = {"forward": 0, "train": 0}

    def hook(m, inputs, out):
        x = inputs[0]
        if isinstance(m, Linear):
            f = 2 * x.numel() * m.weight.shape[0]
        elif isinstance(m, Conv2d):
            f = 2 * out.numel() * m.weight[0].numel()
        else:  # ConvTranspose2d: every input element meets out_ch * kh * kw weights
            f = 2 * x.numel() * m.weight[0].numel()
        counts["forward"] += f
        counts["train"] += f * (2 + x.requires_grad)

    layers = [m for m in trainer.model.modules() if isinstance(m, (Linear, Conv2d, ConvTranspose2d))]
    handles = [m.register_forward_hook(hook) for m in layers]
    try:
        with precision.use(trainer.compute_dtype, trainer.activation_dtype):
            trainer.obj_fn(trainer.model, xs, trainer.spec, K=trainer.cfg.K,
                           generator=torch.Generator(device=trainer.device).manual_seed(0))
    finally:
        for h in handles:
            h.remove()
    return counts["train"], counts["forward"]


def phase_mmvae_time(tmp, config, train_loader):
    """The flagship's steady train step at full width under `config`'s
    precision policy."""
    import torch

    from mmvae_tpu_torch.core.config import ExperimentConfig

    cfg = ExperimentConfig.from_json(_slice_config(tmp, config)[0])
    dtype = cfg.extra.get("compute_dtype") or "float32"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    trainer, batches, step_s, eval_ms, prof = _steady_steps(cfg, train_loader)
    train_flops, eval_flops = step_flops(trainer, batches[0])
    peak = PEAK_BF16_FLOPS if dtype == "bfloat16" else PEAK_F32_FLOPS
    achieved = train_flops / step_s
    emit({"phase": "mmvae_slice_time", "compute_dtype": dtype, "batch": cfg.batch_size,
          "K": cfg.K, "train_step_ms": step_s * 1e3, "steps_per_s": 1.0 / step_s,
          "pairs_per_s": cfg.batch_size / step_s, "eval_batch_ms": eval_ms,
          "train_step_flops": train_flops, "eval_batch_flops": eval_flops,
          "achieved_tflops": achieved / 1e12, "peak_tflops": peak / 1e12,
          "flops_share_of_peak": achieved / peak,
          "peak_mem_bytes": torch.cuda.max_memory_allocated(), **prof})
    return step_s


def profile_steps(trainer, batches, lr, epoch=1):
    """Device busy time and the top kernels over a few train steps, from
    torch.profiler; "not measured" when the tracer cannot start or the trace
    holds no device time. Errors of the steps themselves propagate."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    try:  # probe the tracer alone; the timings above stand without it
        with profile(activities=activities):
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()
    except RuntimeError as e:
        return {"profile": f"not measured ({e})"[:200]}

    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for xs in batches:
            trainer.train_step(xs, lr, epoch=epoch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    averages = prof.key_averages()

    def dev_us(e):
        # the attribute's name changed across torch versions
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    events = [e for e in averages
              if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    busy_us = sum(dev_us(e) for e in events)
    if busy_us <= 0:
        return {"profile": "not measured"}
    top = sorted(events, key=dev_us, reverse=True)[:10]

    def per_launch(name):  # None where the kernel did not run
        hits = [e for e in events if name in e.key]
        return sum(dev_us(e) for e in hits) / sum(e.count for e in hits) if hits else None

    ar_us = sum(dev_us(e) for e in events if "ar_solve" in e.key)
    return {"profiled_steps": len(batches), "device_busy_share": busy_us / wall_us,
            "device_us_per_step": busy_us / len(batches),
            "ar_solve_share_of_device_time": ar_us / busy_us,
            "ar_solve_forward_device_us_per_launch": per_launch("ar_solve_forward_kernel"),
            "ar_solve_backward_device_us_per_launch": per_launch("ar_solve_backward_kernel"),
            "kernel_launches_per_step": sum(e.count for e in events) / len(batches),
            "top_kernels": [[e.key[:80], dev_us(e) / len(batches), e.count] for e in top]}


def _step_errors(run, ref, names, scales=None):
    """`run` against `ref` (dicts with obj, loss and grads): the relative
    errors of the objective and the loss, and each gradient leaf's largest
    error over its largest entry (or over `scales`, one per leaf), the
    worst of them named."""
    scales = scales or [b.abs().max() for b in ref["grads"]]
    leaf = [((a - b).abs().max() / s.clamp_min(1e-30)).item()
            for a, b, s in zip(run["grads"], ref["grads"], scales)]
    worst = max(range(len(leaf)), key=leaf.__getitem__)
    return {"objective_rel_err": abs(run["obj"] - ref["obj"]) / abs(ref["obj"]),
            "loss_rel_err": abs(run["loss"] - ref["loss"]) / abs(ref["loss"]),
            "grad_max_rel_err": leaf[worst], "worst_leaf": names[worst]}


def _leaf_scales(grads, names):
    """Each gradient leaf's largest entry; for a bias whose gradient is 0
    but for round-off, that of a conv right before a BatchNorm (training
    mode cancels it), its weight's instead."""
    by = {n: g for n, g in zip(names, grads)}
    scales = []
    for n, g in zip(names, grads):
        scale = g.abs().max()
        w = by.get(n[: -len("bias")] + "weight") if n.endswith("bias") else None
        if w is not None and scale < 1e-6 * w.abs().max():
            scale = w.abs().max()
        scales.append(scale)
    return scales


def phase_parity(tmp):
    """One MMVAE-NF training step on cuda (float32) against the same step on
    the CPU in float64, from the same bridged weights and noise, on the
    cuda step's ReLU branches, the flow kernels' included (`_step_parity`
    with align_relu); the CPU float32 step, and the error against the
    float64 step on its own branches, beside."""
    _step_parity(tmp, CONFIG, 2, "parity", align_relu=True)


def phase_mmvae_parity(tmp):
    """One DReG-looser training step of the flagship on cuda (float32)
    against the same step on the CPU in float64 (the reference; the CPU
    float32 step beside it), at B=32 with K=30 kept, from the same bridged
    weights and uniform noise, TF32 off. Then the bf16 step on cuda
    against the float32 one: the loss within BF16_LOSS_RTOL, every
    gradient finite and float32, the parameters float32 after the step."""
    import numpy as np
    import torch

    from mmvae_tpu_torch.bridge import export_jax_params, load_jax_params
    from mmvae_tpu_torch.core import distributions as D
    from mmvae_tpu_torch.core import precision
    from mmvae_tpu_torch.core.config import ExperimentConfig
    from mmvae_tpu_torch.data import get_dataloaders
    from mmvae_tpu_torch.models import registry
    from mmvae_tpu_torch.train import Trainer

    cfg_path, raw = _slice_config(tmp, FLAGSHIP, batch_size=MMVAE_PARITY_B)
    cfg = ExperimentConfig.from_json(cfg_path)
    train_loader, _, _ = get_dataloaders("mnist_svhn", batch_size=cfg.batch_size,
                                         data_path=cfg.data_path,
                                         synthetic_n=raw["synthetic_n"])
    xs_np, _ = next(iter(train_loader))
    rng = np.random.default_rng(0)
    us_np = [rng.uniform(D.LAPLACE_U_MIN, D.LAPLACE_U_MAX,
                         (cfg.K, cfg.batch_size, cfg.latent_dim)).astype(np.float32)
             for _ in xs_np]

    out, weights, names = {}, None, None
    for run, dev, dtype, policy in (("cpu_f64", "cpu", torch.float64, None),
                                    ("cpu_f32", "cpu", torch.float32, None),
                                    ("cuda_f32", "cuda", torch.float32, None),
                                    ("cuda_bf16", "cuda", torch.float32, "bfloat16")):
        cfg.extra = {**cfg.extra, "compute_dtype": policy}
        bundle = registry.build(cfg)
        trainer = Trainer(bundle.model.to(dtype), bundle.spec, cfg, device=dev)
        if weights is None:
            trainer.init_parameters()
            weights = export_jax_params(trainer.model)
            names = [n for n, _ in trainer.model.named_parameters()]
        else:
            load_jax_params(trainer.model, weights)
        trainer.init_opt_state()
        xs = [torch.tensor(x).to(dev, dtype) for x in xs_np]
        us = [torch.tensor(u).to(dev, dtype) for u in us_np]
        t0 = time.perf_counter()
        with precision.use(policy):
            obj, _ = trainer.obj_fn(trainer.model, xs, trainer.spec, K=cfg.K, noise=us)
            grads = torch.autograd.grad(obj, list(trainer.model.parameters()))
        loss, details = trainer.train_step(xs, cfg.learning_rate, noise=us)
        if dev == "cuda":
            torch.cuda.synchronize()
        out[run] = dict(obj=obj.item(), grads=[g.double().cpu() for g in grads],
                        grads_f32=all(g.dtype == torch.float32 for g in grads),
                        grads_finite=all(bool(torch.isfinite(g).all()) for g in grads),
                        params_f32=all(p.dtype == torch.float32 for p in trainer.model.parameters()),
                        loss=loss.item(), skipped=details["nan_skipped"].item(),
                        stepped=trainer.opt.count.item(), seconds=time.perf_counter() - t0)

    cuda, cpu32, bf16 = (_step_errors(out[run], out[ref], names)
                         for run, ref in (("cuda_f32", "cpu_f64"), ("cpu_f32", "cpu_f64"),
                                          ("cuda_bf16", "cuda_f32")))
    bf = out["cuda_bf16"]
    ok_f32 = (cuda["objective_rel_err"] <= STEP_OBJ_RTOL and cuda["loss_rel_err"] <= STEP_OBJ_RTOL
              and cuda["grad_max_rel_err"] <= MMVAE_GRAD_TOL)
    ok_bf16 = (bf16["loss_rel_err"] <= BF16_LOSS_RTOL and bf["grads_f32"] and bf["grads_finite"]
               and bf["params_f32"] and bf["obj"] != out["cuda_f32"]["obj"])
    stepped = all(r["skipped"] == 0.0 and r["stepped"] == 1 for r in out.values())
    emit({"phase": "mmvae_parity", "objective": "m_dreg_looser", "batch": cfg.batch_size,
          "K": cfg.K, "reference": "cpu float64", "objective_ref": out["cpu_f64"]["obj"],
          "objective_cuda": out["cuda_f32"]["obj"], "objective_cuda_bf16": bf["obj"],
          "cuda_f32": cuda, "cpu_f32": cpu32, "cuda_bf16_vs_cuda_f32": bf16,
          "bf16_grads_f32_and_finite": bf["grads_f32"] and bf["grads_finite"],
          "bf16_params_f32": bf["params_f32"],
          "seconds": {k: r["seconds"] for k, r in out.items()},
          "objective_rtol": STEP_OBJ_RTOL, "grad_tol": MMVAE_GRAD_TOL,
          "bf16_loss_rtol": BF16_LOSS_RTOL, "ok": ok_f32 and ok_bf16 and stepped})
    if not ok_f32:
        raise AssertionError("the flagship's cuda step disagrees with the float64 cpu step")
    if not (ok_bf16 and stepped):
        raise AssertionError("the flagship's bf16 step is off the float32 step, or a step "
                             "was skipped")


def _moved(epochs, prefixes):
    """The parameters whose names contain one of `prefixes` and that moved
    between the last two epoch ends, and how many were compared."""
    import torch

    before, after = epochs[-2]["params"], epochs[-1]["params"]
    names = [n for n in after if any(p in n for p in prefixes)]
    return [n for n in names if not torch.equal(before[n], after[n])], len(names)


def _frozen_slice(tmp, config, phase, objective, analytics=False, sign=1, **overrides):
    """`config` (a JMVAE-NF model, fix_jencoder and fix_decoders; cut by
    `overrides`, with its own analytics if `analytics`) through the CLI for
    2 epochs, warmup 2: no ar_solve launch in the warmup epoch, its grids'
    included; past it 4 forward kernels per train step and per val batch
    and 4 backward kernels per train step, every one at `sign` (+1: MAF's
    sampling direction; -1: IAF's density direction); the joint encoder and
    decoders frozen bit for bit, the unimodal encoders and the MADE blocks
    moved."""
    cfg, train_loader, info, epochs = _cli_epoch(tmp, config, analytics,
                                                 **{**JNF_RUN, **overrides})
    steps, val_batches = info["train_steps"], info["val_batches"]
    (w_fwd, w_bwd), (fwd, bwd) = info["launches_by_epoch"]
    post = (fwd - w_fwd, bwd - w_bwd)
    expected = (4 * (steps + val_batches), 4 * steps)
    minus = info["sign_minus_launches_by_epoch"][-1]
    expected_minus = expected if sign < 0 else (0, 0)
    moved, n_frozen = _moved(epochs, ("joint_encoder", "decoder"))
    trained, _ = _moved(epochs, ("",))
    unimodal = {p: any(n.startswith(p) for n in trained)
                for p in ("vaes.0.encoder.", "vaes.1.encoder.", "vaes.0.flow.made.",
                          "vaes.1.flow.made.")}
    emit({"phase": phase, "model": cfg.model, "objective": objective,
          **{k: v for k, v in info.items() if k != "launches_by_epoch"},
          "warmup_epoch_launches": [w_fwd, w_bwd], "post_warmup_launches": list(post),
          "expected_post_warmup_launches": list(expected), "sign": sign,
          "launches_at_sign_minus": list(minus), "expected_at_sign_minus": list(expected_minus),
          "frozen_params_compared": n_frozen, "frozen_params_moved": moved,
          "params_moved_in_epoch_2": len(trained), "unimodal_moved": unimodal})
    if (w_fwd, w_bwd) != (0, 0) or post != expected or (steps, val_batches) != (68, 7) \
            or minus != expected_minus:
        raise AssertionError(f"{phase}: warmup epoch launched {(w_fwd, w_bwd)} ar_solve kernels "
                             f"(expected none); epoch 2 {post} for {steps}+{val_batches} batches "
                             f"(expected {expected}, 68+7), {minus} at sign -1 "
                             f"(expected {expected_minus})")
    if moved or not n_frozen or not all(unimodal.values()):
        raise AssertionError(f"{phase} epoch 2: frozen parameters moved: {moved[:5]}; "
                             f"unimodal encoders and MADE blocks moved: {unimodal}")
    if not info["params_on_cuda"] or not info["losses_finite"] or info["nan_skipped_fraction"]:
        raise AssertionError(f"{phase}: params on cuda {info['params_on_cuda']}, finite losses "
                             f"{info['losses_finite']}, skipped {info['nan_skipped_fraction']:.1%}")
    return train_loader, dict(launches=post[0], bwd_launches=post[1], run_path=info["run_path"],
                              sign_minus=minus)


def phase_jnf_slice(tmp):
    """JMVAE-NF through the CLI for 2 epochs, warmup 2 (`_frozen_slice`)."""
    return _frozen_slice(tmp, JNF, "jnf_slice", "m_jmvae_nf")


def optimizer_launches(trainer):
    """Device kernel launches of one optimizer update, nan_guard's flag
    included, from torch.profiler (None where it records no device event).
    The update runs on zero gradients at lr 0; the trainer is not used
    after."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    grads = [torch.zeros_like(p) for p in trainer.opt.params]
    finite = torch.ones((), dtype=torch.bool, device="cuda")
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            trainer.opt.step(grads, 0.0, finite)
            torch.cuda.synchronize()
    except RuntimeError:  # the tracer could not start; the step's readings stand
        return None
    n = sum(e.count for e in prof.key_averages()
            if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA)
    return n or None


def phase_jnf_time(tmp, train_loader):
    """The steady JNF train step in the warmup phase and past it, and how
    many of its launches are the optimizer's."""
    import torch

    from mmvae_tpu_torch.core.config import ExperimentConfig

    cfg = ExperimentConfig.from_json(_slice_config(tmp, JNF, **JNF_RUN)[0])
    out = {}
    for phase, epoch in (("warmup", 1), ("post_warmup", 2)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        trainer, _, step_s, eval_ms, prof = _steady_steps(cfg, train_loader, epoch=epoch)
        out[phase] = step_s
        emit({"phase": "jnf_slice_time", "jnf_phase": phase, "epoch": epoch,
              "train_step_ms": step_s * 1e3, "steps_per_s": 1.0 / step_s,
              "eval_batch_ms": eval_ms, "peak_mem_bytes": torch.cuda.max_memory_allocated(),
              "trainable_tensors": len(trainer.opt.params),
              "optimizer_launches_per_step": optimizer_launches(trainer), **prof})
    return out


def relu_branches(x, tie):
    """The branch of each element of a ReLU's input as a code, uint8: 2
    above 0, 0 below, and at an exact tie 1 where the ReLU's slope there is
    1/2 (`tie`: the solve's `hidden_relu`, JAX's jnp.maximum) and 0 where
    it is 0 (torch.relu). The slope is half the code."""
    import torch

    code = (x > 0).to(torch.uint8) * 2
    return code + (x == 0).to(torch.uint8) if tie else code


class _ReluBranches:
    """`torch.relu` and the solve's `ar_flow.hidden_relu` that record the
    branch of each call (`relu_branches`), or, given a recording, take each
    call's branch from it in call order: x times the recorded slope (1,
    1/2 or 0), whose derivative is that slope. A float64 run under a
    float32 run's recording differentiates the same piecewise-linear
    function as that run. `flips` counts the elements taken on another
    branch than their own, and `flip_max_abs` is the largest |x| among them."""

    def __init__(self, replay=None):
        self.replay, self.masks, self.flips, self.flip_max_abs = replay, [], 0, 0.0

    def __enter__(self):
        import torch

        from mmvae_tpu_torch.ops import ar_flow

        self._relu, torch.relu = torch.relu, functools.partial(self._call, tie=False)
        self._hidden = ar_flow.hidden_relu
        ar_flow.hidden_relu = functools.partial(self._call, tie=True)
        return self

    def __exit__(self, *exc):
        import torch

        from mmvae_tpu_torch.ops import ar_flow

        torch.relu, ar_flow.hidden_relu = self._relu, self._hidden

    def _call(self, x, tie):
        own = relu_branches(x, tie)
        if self.replay is None:
            self.masks.append(own.cpu())
            return (self._hidden if tie else self._relu)(x)
        code = self.replay[len(self.masks)].to(x.device)
        self.masks.append(code)
        other = own != code
        if other.any():
            self.flips += int(other.sum())
            self.flip_max_abs = max(self.flip_max_abs, x.detach()[other].abs().max().item())
        return x * (code.to(x.dtype) * 0.5)


class _SolveBranches:
    """Inside a `_ReluBranches` recording on the card: the ar_solve kernels'
    hidden ReLUs recorded as the plain solve (`unrolled_solve`) would call
    `hidden_relu` on the CPU: at each forward launch with a tape, the branch
    of every hidden unit at every step, step by step and layer by layer,
    read from the tape (each layer's pre-activation, three states); at each
    backward call the same again, since the CPU's backward re-runs the
    plain solve.
    A float64 CPU run replaying the recording then takes the kernels'
    branches as well."""

    def __init__(self, relu):
        self.relu = relu

    def __enter__(self):
        from mmvae_tpu_torch.ops import ar_flow

        self._fwd, self._bwd = ar_flow.kernel_forward, ar_flow._backward

        def forward(x, ws, bs, sign, s_bound=0.0, tape=None):
            if tape is None:
                raise AssertionError("a solve without a tape: its ReLUs cannot be recorded")
            out = self._fwd(x, ws, bs, sign, s_bound, tape=tape)
            self._record(tape)
            return out

        def backward(x, y, gy, gld, tape, *args):
            self._record(tape)
            return self._bwd(x, y, gy, gld, tape, *args)

        ar_flow.kernel_forward, ar_flow._backward = forward, backward
        return self

    def __exit__(self, *exc):
        from mmvae_tpu_torch.ops import ar_flow

        ar_flow.kernel_forward, ar_flow._backward = self._fwd, self._bwd

    def _record(self, tape):
        self.relu.masks.extend(code.cpu() for code in _kernel_branches(tape))


def _step_parity(tmp, config, n_noise, phase, overrides=None, align_relu=False,
                 grad_tol=STEP_GRAD_TOL, unimodal=None, **details):
    """One training step of `config` (cut by `overrides`) at epoch
    max(warmup, 1), past any warmup, on cuda in float32 against
    the same step on the CPU in float64 (the CPU float32 step beside it),
    the same weights and `n_noise` standard-normal draws of (B, latent), or
    draws of the shapes `n_noise` lists: the objective and
    every trainable parameter's gradient (those of the phase's freezing;
    0 for one the objective does not reach), the loss, and one optimizer
    step taken, none skipped. With `align_relu` the reference is the
    float64 step on the float32 cuda step's ReLU branches (`_ReluBranches`;
    the ar_solve kernels' hidden ReLUs read from their tapes,
    `_SolveBranches`), each element on another branch than its own within
    RELU_KINK_ATOL of 0; the errors against the float64 step on its own
    branches stand beside. `unimodal` m: the step of the built model's
    unimodal VAE m alone on its modality (a Trainer with multimodal False,
    the config's objective unimodal, one draw)."""
    import contextlib

    import numpy as np
    import torch

    from mmvae_tpu_torch.bridge import export_jax_params, load_jax_params
    from mmvae_tpu_torch.core.config import ExperimentConfig
    from mmvae_tpu_torch.models import registry
    from mmvae_tpu_torch.objectives import ModelSpec
    from mmvae_tpu_torch.train import Trainer, freezing

    cfg_path, raw = _slice_config(tmp, config, **(overrides or {}))
    cfg = ExperimentConfig.from_json(cfg_path)
    train_loader, _, _ = _data_loaders(cfg)
    xs_np, _ = next(iter(train_loader))

    def build(dtype, dev):
        bundle = registry.build(cfg)
        if unimodal is None:
            return Trainer(bundle.model.to(dtype), bundle.spec, cfg, device=dev)
        vae, spec = bundle.model.vaes[unimodal], bundle.spec
        spec = ModelSpec(latent_dim=spec.latent_dim, posterior=vae.posterior,
                         recon_dists=(spec.recon_dists[unimodal],))
        return Trainer(vae.to(dtype), spec, cfg, multimodal=False, device=dev)

    rng = np.random.default_rng(0)
    shapes = ([(cfg.batch_size, cfg.latent_dim)] * n_noise if isinstance(n_noise, int)
              else n_noise)
    eps_np = [rng.standard_normal(shape).astype(np.float32) for shape in shapes]
    epoch = max(cfg.warmup, 1)

    out, weights, trainable, branches = {}, None, None, {}
    runs = [("cuda_f32", "cuda", torch.float32), ("cpu_f32", "cpu", torch.float32),
            ("cpu_f64", "cpu", torch.float64)]
    for run, dev, dtype in runs + ([("cpu_f64_on_cuda_branches", "cpu", torch.float64)]
                                   if align_relu else []):
        trainer = build(dtype, dev)
        if weights is None:
            trainer.init_parameters()
            weights = export_jax_params(trainer.model)
        else:
            load_jax_params(trainer.model, weights)
        # the optimizer the Trainer runs there: reset to Adam at a warmup's end
        trainer.init_opt_state(past_warmup=True, amsgrad=cfg.warmup == 0)
        frozen = freezing.frozen_prefixes_for_phase(trainer.obj_name, True, cfg.fix_jencoder,
                                                    cfg.fix_decoders)
        trainable = list(freezing.trainable_parameters(trainer.model, frozen))
        named = dict(trainer.model.named_parameters())
        xs = [torch.tensor(x).to(dev, dtype) for x in xs_np]
        eps = [torch.tensor(e).to(dev, dtype) for e in eps_np]
        if unimodal is not None:
            xs, eps = xs[unimodal], eps[0]
        replay = branches["cuda_f32"].masks if run.endswith("branches") else None
        branches[run] = _ReluBranches(replay) if align_relu else contextlib.nullcontext()
        kernels = (_SolveBranches(branches[run]) if align_relu and run == "cuda_f32"
                   else contextlib.nullcontext())
        with branches[run], kernels:
            obj, _ = trainer.obj_fn(trainer.model, xs, trainer.spec, noise=eps,
                                    **trainer._obj_kwargs(1.0, epoch))
            params = [named[n] for n in trainable]
            grads = torch.autograd.grad(obj, params, allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        loss, step_details = trainer.train_step(xs, cfg.learning_rate, epoch=epoch, noise=eps)
        out[run] = dict(obj=obj.item(), grads=[g.double().cpu() for g in grads],
                        loss=loss.item(), skipped=step_details["nan_skipped"].item(),
                        stepped=trainer.opt.count.item())

    ref = out["cpu_f64_on_cuda_branches" if align_relu else "cpu_f64"]
    cuda, cpu32 = (_step_errors(out[run], ref, trainable) for run in ("cuda_f32", "cpu_f32"))
    ok = (cuda["objective_rel_err"] <= STEP_OBJ_RTOL and cuda["loss_rel_err"] <= STEP_OBJ_RTOL
          and cuda["grad_max_rel_err"] <= grad_tol
          and all(r["skipped"] == 0.0 and r["stepped"] == 1 for r in out.values()))
    aligned = {}
    if align_relu:
        rb = branches["cpu_f64_on_cuda_branches"]
        aligned = {"relu_calls": len(rb.masks), "relu_elements_on_other_branch": rb.flips,
                   "relu_other_branch_max_abs_preact": rb.flip_max_abs,
                   "relu_kink_atol": RELU_KINK_ATOL,
                   "cuda_f32_vs_cpu_f64_own_branches": _step_errors(out["cuda_f32"],
                                                                    out["cpu_f64"], trainable)}
        ok = ok and len(rb.masks) == len(branches["cuda_f32"].masks) and \
            rb.flip_max_abs <= RELU_KINK_ATOL
    emit({"phase": phase, "objective": trainer.obj_name, "epoch": epoch, **details,
          "trainable_leaves": len(trainable),
          "reference": "cpu float64" + (" on the cuda step's ReLU branches" if align_relu else ""),
          "objective_ref": ref["obj"], "objective_cuda": out["cuda_f32"]["obj"],
          "cuda_f32": cuda, "cpu_f32": cpu32, **aligned, "objective_rtol": STEP_OBJ_RTOL,
          "grad_tol": grad_tol, "ok": ok})
    if not ok:
        raise AssertionError(f"{phase}: the cuda step disagrees with the float64 cpu step")


def phase_jnf_parity(tmp):
    """One post-warmup JNF step (frozen joint forward, unimodal
    reconstructions on) against the float64 CPU step; the noise: the joint
    forward's, compute_kld's joint sample, each unimodal forward."""
    _step_parity(tmp, JNF, 4, "jnf_parity", JNF_RUN, frozen_joint=True, no_recon=False)


def phase_telbo_slice(tmp):
    """TELBO-NF (`configs/mnist_svhn/telbo_nf.json`: the JMVAE-NF model
    with MAF flows, m_telbo_nf) through the CLI for 2 epochs, warmup 2
    (`_frozen_slice`): past warmup each unimodal VAE's forward runs both
    ar_solve kernels under autograd. Then its steady post-warmup step, and
    the same step on cuda against the float64 CPU step (the noise: the joint
    forward's, then each unimodal forward's)."""
    import torch

    from mmvae_tpu_torch.core.config import ExperimentConfig

    loader, out = _frozen_slice(tmp, TELBO_NF, "telbo_nf_slice", "m_telbo_nf")
    cfg = ExperimentConfig.from_json(_slice_config(tmp, TELBO_NF, **JNF_RUN)[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _, _, step_s, eval_ms, prof = _steady_steps(cfg, loader, epoch=cfg.warmup)
    emit({"phase": "telbo_nf_slice_time", "epoch": cfg.warmup, "train_step_ms": step_s * 1e3,
          "steps_per_s": 1.0 / step_s, "eval_batch_ms": eval_ms,
          "peak_mem_bytes": torch.cuda.max_memory_allocated(), **prof})
    _step_parity(tmp, TELBO_NF, 3, "telbo_nf_parity", JNF_RUN)
    return out


def phase_poe_slice(tmp, config, name):
    """MVAE or MoE-PoE (m_self_built, no flow) through the CLI for one
    epoch: no ar_solve launch, finite losses, no skipped step; its steady
    step; then the step on cuda against the float64 CPU step (MVAE's noise
    z_0, z_1, z_joint; MoE-PoE's one mixture draw), the reference on the
    cuda step's ReLU branches (`_ReluBranches`)."""
    import torch

    cfg, train_loader, info, _ = _cli_epoch(tmp, config)
    launches = (info["ar_solve_launches"], info["ar_solve_backward_launches"])
    emit({"phase": f"{name}_slice", "model": cfg.model, "objective": "m_self_built",
          "beta_kl": cfg.beta_kl, **info})
    if launches != (0, 0) or (info["train_steps"], info["val_batches"]) != (68, 7):
        raise AssertionError(f"{name}: {info['train_steps']} train steps and "
                             f"{info['val_batches']} val batches (expected 68+7); ar_solve "
                             f"launched {launches} (expected none)")
    if not info["params_on_cuda"] or not info["losses_finite"] or info["nan_skipped_fraction"]:
        raise AssertionError(f"{name}: params on cuda {info['params_on_cuda']}, finite losses "
                             f"{info['losses_finite']}, skipped {info['nan_skipped_fraction']:.1%}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _, _, step_s, eval_ms, prof = _steady_steps(cfg, train_loader)
    emit({"phase": f"{name}_slice_time", "train_step_ms": step_s * 1e3,
          "steps_per_s": 1.0 / step_s, "pairs_per_s": cfg.batch_size / step_s,
          "eval_batch_ms": eval_ms, "peak_mem_bytes": torch.cuda.max_memory_allocated(), **prof})
    _step_parity(tmp, config, 3 if name == "mvae" else 1, f"{name}_parity", align_relu=True)
    return launches, info["run_path"]


def phase_dcca(tmp):
    """DCCA pretraining through the port's CLI on cuda (Cholesky loss,
    float32), then the epoch time of the Solver at the same size, and the
    cuda loss with its gradient against the float64 CPU eigh loss on one
    batch at the trained trunk weights."""
    import contextlib
    import io

    import numpy as np
    import torch

    from mmvae_tpu_torch.bridge import load_jax_params
    from mmvae_tpu_torch.cli import dcca_train
    from mmvae_tpu_torch.cli.dcca_train import main as dcca_main
    from mmvae_tpu_torch.data import get_dataloaders
    from mmvae_tpu_torch.dcca import objectives as O
    from mmvae_tpu_torch.dcca.nets import DeepCCA, dcca_encoders_mnist_svhn
    from mmvae_tpu_torch.dcca.train import Solver, load_trunk_params

    from mmvae_tpu_torch import embed

    data = os.path.join(tmp, "data")
    os.makedirs(data, exist_ok=True)
    log = io.StringIO()
    layout_s, layout = [], embed._optimize_layout

    def timed_layout(*args, **kwargs):  # the UMAP layout's epochs on the card
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = layout(*args, **kwargs)
        layout_s.append(time.perf_counter() - t)
        return out

    probe_s, probe = [], dcca_train.svm_probe

    def timed_probe(*args, **kwargs):  # the SVM probe's solves on the card
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = probe(*args, **kwargs)
        torch.cuda.synchronize()
        probe_s.append(time.perf_counter() - t)
        return out

    t0 = time.perf_counter()
    embed._optimize_layout, dcca_train.svm_probe = timed_layout, timed_probe
    try:
        with contextlib.redirect_stdout(log):
            path = dcca_main(["--device", "cuda", "--epochs", str(DCCA_EPOCHS), "--batch-size",
                              str(DCCA_BATCH), "--synthetic-n", "2048", "--data-path", data,
                              "--out", os.path.join(tmp, "dcca")])
    finally:
        embed._optimize_layout, dcca_train.svm_probe = layout, probe
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    figures = {}
    for v in (0, 1):
        png = os.path.join(os.path.dirname(path), f"embedding_{v}.png")
        with open(png + ".json") as f:
            spec = json.load(f)
        figures[f"embedding_{v}.png"] = {
            "size": _png_ok(png), "classes": spec["panels"][0][0]["legend"],
            "points": sum(len(x["points"]) for x in spec["panels"][0][0]["series"])}
    lines = log.getvalue().splitlines()
    epochs = [l.split() for l in lines if l.startswith("DCCA epoch")]
    losses = [(float(w[w.index("train") + 1]), float(w[w.index("val") + 1])) for w in epochs]
    with np.load(path) as npz:
        lcca = {k: npz[k] for k in ("m0", "m1", "w0", "w1", "D")}
    trunks = load_trunk_params(path)

    train_l, _, val_l = get_dataloaders("mnist_svhn", batch_size=DCCA_BATCH, synthetic_n=2048,
                                        data_path=data)
    fit_s = {}
    for n in (1, DCCA_EPOCHS):
        solver = Solver(dcca_encoders_mnist_svhn(16), 16, backend="chol", device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solver.fit(train_l, val_l, epochs=n, log=lambda s: None)
        torch.cuda.synchronize()
        fit_s[n] = time.perf_counter() - t0
    epoch_s = (fit_s[DCCA_EPOCHS] - fit_s[1]) / (DCCA_EPOCHS - 1)

    # one batch through the trained trunks, then the loss on each device
    xs, _ = next(iter(train_l))
    ref_model = DeepCCA(dcca_encoders_mnist_svhn(16)).double()
    load_jax_params(ref_model, trunks)
    with torch.no_grad():
        hs = ref_model([torch.tensor(x, dtype=torch.float64) for x in xs])
    h64 = [h.clone().requires_grad_(True) for h in hs]
    v64 = O.cca_loss(h64[0], h64[1], 16)
    g64 = torch.autograd.grad(v64, h64)
    h32 = [h.float().cuda().requires_grad_(True) for h in hs]
    v32 = O.cca_loss_chol(h32[0], h32[1], 16)
    g32 = torch.autograd.grad(v32, h32)
    torch.cuda.synchronize()
    value_ok = math.isclose(v32.item(), v64.item(), rel_tol=DCCA_VALUE_TOL,
                            abs_tol=DCCA_VALUE_TOL)
    grad_ok = all(torch.allclose(a.double().cpu(), b, rtol=DCCA_GRAD_RTOL, atol=DCCA_GRAD_ATOL)
                  for a, b in zip(g32, g64))
    grad_err = max((a.double().cpu() - b).abs().max().item() for a, b in zip(g32, g64))
    finite = bool(losses) and all(math.isfinite(v) for pair in losses for v in pair)
    fitted = all(np.isfinite(v).all() for v in lcca.values()) and lcca["w0"].shape == (16, 16)
    emit({"phase": "dcca", "epochs": len(losses), "batch": DCCA_BATCH,
          "train_pairs": train_l.num_examples, "losses_train_val": losses,
          "cli_wall_s_incl_setup": wall, "solver_fit_s": fit_s, "epoch_s": epoch_s,
          "embedding_figures": figures, "umap_layout_s": layout_s,
          "artifact": os.path.relpath(path, tmp), "lcca_correlations": lcca["D"][:9].tolist(),
          "loss_cuda_chol_f32": v32.item(), "loss_cpu_eigh_f64": v64.item(),
          "grad_max_abs_err": grad_err, "value_tol": DCCA_VALUE_TOL,
          "grad_rtol": DCCA_GRAD_RTOL, "grad_atol": DCCA_GRAD_ATOL,
          "ok": value_ok and grad_ok and finite and fitted and len(layout_s) == 2})
    if len(layout_s) != 2 or any(f["points"] != 300 for f in figures.values()):
        raise AssertionError(f"DCCA embedding figures: {figures}, layouts {layout_s}")
    if len(losses) != DCCA_EPOCHS or not (finite and fitted):
        raise AssertionError(f"DCCA: {len(losses)} epochs, finite losses {finite}, "
                             f"LCCA fitted {fitted}")
    if not (value_ok and grad_ok):
        raise AssertionError(f"DCCA: cuda chol loss {v32.item()} vs cpu eigh {v64.item()}, "
                             f"gradient max abs err {grad_err}")
    probe_lines = [l for l in lines if l.startswith("SVM probe view ")]
    return path, {"lines": probe_lines, "seconds": probe_s}


def phase_jnf_dcca_slice(tmp, dcca_path):
    """JMVAE-NF-DCCA through the CLI for 2 epochs, warmup 2, grafting the
    dcca phase's artifact: the trunks and their projection equal the
    artifact's after both epochs, no ar_solve launch, finite losses."""
    import torch

    from mmvae_tpu_torch.models import registry

    cfg, _, info, epochs = _cli_epoch(tmp, JNF_DCCA, dcca_path=dcca_path, **JNF_RUN)
    bundle = registry.build(cfg)
    bundle.model.load_state_dict(torch.load(os.path.join(info["run_path"], "model.pt"),
                                            weights_only=True))
    mismatched, compared = _trunks_off_artifact(bundle.model, dcca_path)
    launches = (info["ar_solve_launches"], info["ar_solve_backward_launches"])
    emit({"phase": "jnf_dcca_slice", "model": cfg.model, "dcca": cfg.dcca,
          "dim_dcca": cfg.dim_dcca, "no_recon": cfg.no_recon,
          **{k: v for k, v in info.items() if k != "launches_by_epoch"},
          "launches_by_epoch": info["launches_by_epoch"], "trunk_leaves_compared": compared,
          "trunk_leaves_off_artifact": mismatched})
    # 8 trunk leaves and the projection's m and w for each modality
    if mismatched or compared != 20:
        raise AssertionError(f"JNF-DCCA: trunks or projections off the artifact after "
                             f"training: {mismatched[:5]} ({compared} compared)")
    if launches != (0, 0) or len(epochs) != 2:
        raise AssertionError(f"JNF-DCCA: {len(epochs)} epochs, ar_solve launched {launches} "
                             f"(expected none)")
    if not info["params_on_cuda"] or not info["losses_finite"] or info["nan_skipped_fraction"]:
        raise AssertionError(f"JNF-DCCA: params on cuda {info['params_on_cuda']}, finite "
                             f"losses {info['losses_finite']}, skipped "
                             f"{info['nan_skipped_fraction']:.1%}")
    return launches


def _png_ok(path):
    """(width, height) of a PNG whose chunks' CRCs hold and whose image
    data inflates to its rows; raises otherwise."""
    import struct
    import zlib

    with open(path, "rb") as f:
        blob = f.read()
    if blob[:8] != b"\x89PNG\r\n\x1a\n":
        raise AssertionError(f"{path}: not a PNG")
    pos, chunks = 8, {}
    while pos < len(blob):
        (n,) = struct.unpack(">I", blob[pos: pos + 4])
        kind, data = blob[pos + 4: pos + 8], blob[pos + 8: pos + 8 + n]
        if struct.unpack(">I", blob[pos + 8 + n: pos + 12 + n])[0] != zlib.crc32(kind + data):
            raise AssertionError(f"{path}: bad CRC in {kind}")
        chunks[kind] = chunks.get(kind, b"") + data
        pos += 12 + n
    w, h, _, color = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    if len(zlib.decompress(chunks[b"IDAT"])) != h * (1 + w * (1 if color == 0 else 3)):
        raise AssertionError(f"{path}: image data of the wrong size")
    return w, h


def phase_analytics(sl):
    """The MMVAE-NF slice's epoch-1 grids (mmvae_nf_synth.json's own
    no_analytics: false): valid PNGs, and their launches, counted apart from
    the epoch's: 8 conditional samples of 8 val rows per modality, 2
    modalities x 2 MAF blocks = 4 forward launches, none backward."""
    names = [f"cond_samples_{r}x{o}_001.png" for r in (0, 1) for o in (0, 1)] + \
        ["generate_001.png"]
    sizes = {n: _png_ok(os.path.join(sl["run_path"], n)) for n in names}
    emit({"phase": "analytics", "config": os.path.basename(CONFIG), "grids": sizes,
          "launches": sl["analytics_launches"], "expected_launches": 4})
    if sl["analytics_launches"] != 4:
        raise AssertionError(f"the analytics launched {sl['analytics_launches']} forward kernels "
                             f"(expected 4)")
    return sl["analytics_launches"]


def _counted(fn, *args):
    """fn(*args), its standard output kept, with the ar_solve counts set to
    0 just before and read just after: (result, printed lines, (forward,
    backward) launches, seconds)."""
    import contextlib
    import io

    import torch

    from mmvae_tpu_torch.ops import ar_flow

    log = io.StringIO()
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        out = fn(*args)
    torch.cuda.synchronize()
    return (out, log.getvalue().splitlines(),
            (ar_flow.ar_solve.launches, ar_flow.ar_solve.backward_launches),
            time.perf_counter() - t0)


def phase_eval_validate(tmp, runs):
    """`cli/validate.py --repeats 1 --fid-encoder classifier` on cuda over
    the full synthetic test set, for each run: the eval classifiers trained
    into the pool first (timed), then coherence in [0, 1], finite FIDs, and
    the forward launches: 4 per conditional sampling call (2 modalities x
    2 MAF blocks) for the flow families, one call per test batch for the
    coherence and one for the FID, and one for the gen_from_cond grids; the
    flagship, MVAE and MoE-PoE none; no backward launch anywhere."""
    from mmvae_tpu_torch.cli import validate
    from mmvae_tpu_torch.cli.common import get_or_train_classifiers, reload_model

    exp = os.path.join(tmp, "experiments")
    cfg, bundle, loaders = reload_model(runs["mmvae_nf"], 500, "cuda")
    t0 = time.perf_counter()
    get_or_train_classifiers(bundle, loaders, exp, cfg.seed, cfg=cfg, device="cuda")
    classifier_s = time.perf_counter() - t0
    nb = len(loaders[1])
    out = {}
    for name, run in runs.items():
        summary, lines, launches, wall = _counted(validate.main, [
            "--run-path", run, "--experiments-dir", exp, "--repeats", "1",
            "--fid-encoder", "classifier", "--device", "cuda"])
        marks = {l.split("] ", 1)[1]: float(l[1:].split("s]")[0]) for l in lines
                 if l.startswith("[")}
        expected = (0 if name in NO_FLOW_RUNS else 4 * (2 * nb + 1), 0)
        values = {k: v["mean"] for k, v in summary.items()}
        ok = (launches == expected and all(0.0 <= values[k] <= 1.0 for k in
                                            ("acc_0_1", "acc_1_0", "joint_coherence"))
              and all(math.isfinite(values[k]) for k in ("fid_0", "fid_1")))
        emit({"phase": "eval_validate", "run": name, "test_pairs": len(loaders[1].dataset),
              "test_batches": nb, "metrics": values, "launches": list(launches),
              "expected_launches": list(expected), "validate_s": wall,
              "repeat_s": marks["repeat 0: fid done"] - marks["classifiers ready"],
              "coherence_s": marks["repeat 0: accuracies done"] - marks["classifiers ready"],
              "classifier_training_s": classifier_s, "ok": ok})
        if not ok:
            raise AssertionError(f"validate on {name}: launches {launches} (expected {expected}), "
                                 f"metrics {values}")
        out[name] = launches
    return out


def phase_eval_likelihoods(tmp, runs):
    """`cli/compute_likelihoods.py --bis` on cuda at K=1000 in chunks of 100
    over the first test batch of 500 (EVAL_MAX_BATCHES), one repeat, for
    each run: finite values, the peak memory, the seconds
    per test batch, and the forward
    launches: per test batch and conditioning modality one per MAF block,
    IS chunk and model call of ROWS_PER_CALL rows (2 x 2 x 10 x 5 = 200 for
    the conditional likelihoods, as many again for JMVAE-NF's bis
    proposals; MMVAE-NF has no bis estimator, the flagship, MVAE and
    MoE-PoE no flow); no backward launch. MVAE and MoE-PoE write
    `likelihood`, both `cond_likelihood_i_j` and both
    `conditional_likelihood_bis_i_j`. Then one JMVAE-NF batch of the
    protocol under torch.profiler: the ar_solve kernels' share of its
    device time."""
    import torch

    from mmvae_tpu_torch.cli import compute_likelihoods
    from mmvae_tpu_torch.cli.common import generator, reload_model
    from mmvae_tpu_torch.eval import likelihoods as L

    calls = -(-500 // (EVAL_IS_ROWS // EVAL_BK))  # model calls per IS chunk of a batch
    cond = 2 * 2 * (EVAL_K // EVAL_BK) * calls  # modalities x MAF blocks x IS chunks x calls
    per_batch = {"mmvae_nf": cond, "flagship": 0, "jnf": 2 * cond, "mvae": 0, "moepoe": 0}
    poe_keys = sorted(["likelihood", "cond_likelihood_0_1", "cond_likelihood_1_0",
                       "conditional_likelihood_bis_0_1", "conditional_likelihood_bis_1_0"])
    out = {}
    for name, run in runs.items():
        n_batches = POE_EVAL_BATCHES if name in ("mvae", "moepoe") else EVAL_MAX_BATCHES
        torch.cuda.reset_peak_memory_stats()
        summary, _, launches, wall = _counted(compute_likelihoods.main, [
            "--run-path", run, "--k", str(EVAL_K), "--batch-size-k", str(EVAL_BK),
            "--repeats", "1", "--max-batches", str(n_batches), "--bis", "--device", "cuda"])
        expected = (per_batch[name] * n_batches, 0)
        values = {k: v["mean"] for k, v in summary.items()}
        ok = launches == expected and all(math.isfinite(v) for v in values.values())
        if name in ("mvae", "moepoe"):
            ok = ok and sorted(values) == poe_keys
        emit({"phase": "eval_likelihoods", "run": name, "K": EVAL_K, "batch_size_K": EVAL_BK,
              "test_batches": n_batches, "batch": 500, "metrics": values,
              "launches": list(launches), "expected_launches": list(expected),
              "wall_s_incl_reload": wall, "s_per_test_batch": wall / n_batches,
              "peak_mem_bytes": torch.cuda.max_memory_allocated(), "ok": ok})
        if not ok:
            raise AssertionError(f"likelihoods on {name}: launches {launches} (expected "
                                 f"{expected}), values {values}")
        out[name] = launches

    # the device time of one JMVAE-NF test batch of the protocol
    from torch.profiler import ProfilerActivity, profile

    cfg, bundle, (_, test_l, _) = reload_model(runs["jnf"], 500, "cuda")
    xs = [torch.as_tensor(x).cuda() for x in next(iter(test_l))[0]]

    def protocol():
        return L.protocol_chunked(bundle.model, bundle.spec, [xs], [generator("cuda", 0)],
                                  EVAL_K, EVAL_BK, joint_fn=L.joint_likelihood_jmvae_nf, bis=True)

    # warm: the CLI's JMVAE-NF run above ran the same protocol
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    protocol()
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t0
    prof_out = {"profile": "not measured"}
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            protocol()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]

        def dev_us(e):
            return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

        busy = sum(dev_us(e) for e in events)
        if busy > 0:
            ar = [e for e in events if "ar_solve_forward_kernel" in e.key]
            top = sorted(events, key=dev_us, reverse=True)[:8]
            prof_out = {"device_ms": busy / 1e3, "device_busy_share": busy / 1e6 / batch_s,
                        "ar_solve_forward_share_of_device_time": sum(dev_us(e) for e in ar) / busy,
                        "ar_solve_forward_launches": sum(e.count for e in ar),
                        "ar_solve_forward_us_per_launch":
                            sum(dev_us(e) for e in ar) / max(1, sum(e.count for e in ar)),
                        "kernel_launches": sum(e.count for e in events),
                        "top_kernels": [[e.key[:80], dev_us(e) / 1e3, e.count] for e in top]}
    except RuntimeError as e:  # the tracer could not start; the timing stands
        prof_out = {"profile": f"not measured ({e})"[:200]}
    emit({"phase": "eval_likelihoods_profile", "run": "jnf", "batch": len(xs[0]),
          "K": EVAL_K, "batch_size_K": EVAL_BK, "host_s": batch_s, **prof_out})
    return out


def _peak(fn):
    """(peak bytes allocated during fn() above those allocated before it,
    seconds, result)."""
    import torch

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base, time.perf_counter() - t0, out


def phase_eval_memory(runs):
    """Where the likelihood run's peak memory goes, and what an IS call's
    rows and the grouping of small test batches trade, on the JMVAE-NF run
    under no_grad.

    1. The SVHN decoder alone, the largest tensors of an IS call: at one
       call's rows and at a tenth of them, with cuDNN as the port runs it
       and with cudnn.benchmark, and at the tenth without cuDNN (the native
       transposed conv, whose scratch is one row's columns). Beside each
       peak, the bytes of the decoder's largest live tensors (a layer's
       input, its conv output and their relu). The peak with cuDNN less
       the peak without, at the same rows, is what cuDNN takes besides.
    2. One test batch of 500's conditional likelihoods at K=1000 in chunks
       of 100 with ROWS_PER_CALL at each of MEMORY_ROWS: peak and seconds,
       and the values, equal to rtol 1e-5 (float32, other shapes per call).
    3. GROUP_BATCHES test batches of GROUP_BATCH through `protocol_chunked`
       (conditional likelihoods) in one call and in one call each: seconds,
       and the values, equal to rtol 1e-5."""
    import numpy as np
    import torch

    from mmvae_tpu_torch.cli.common import generator, reload_model
    from mmvae_tpu_torch.eval import likelihoods as L
    from mmvae_tpu_torch.nets import ConvTranspose2d

    _, bundle, (_, test_l, _) = reload_model(runs["jnf"], 500, "cuda")
    model, spec = bundle.model, bundle.spec
    decoder, latent = model.vaes[1].decoder, model.vaes[1].latent_dim
    shapes = []
    hooks = [m.register_forward_hook(lambda m, i, o: shapes.append((i[0].numel(), o.numel())))
             for m in decoder.modules() if isinstance(m, ConvTranspose2d)]
    decode = {}
    with torch.no_grad():
        for rows in (MEMORY_ROWS[0], MEMORY_ROWS[0] // 10):
            z = torch.randn(rows, latent, device="cuda",
                            generator=torch.Generator("cuda").manual_seed(rows))
            decoder(z)  # cuDNN picks its algorithms for these shapes
            shapes.clear()
            peak, s, _ = _peak(lambda: decoder(z))
            live = max(i + 2 * o for i, o in shapes) * 4
            entry = {"peak_bytes": peak, "s": s, "live_tensor_bytes": live,
                     "output_bytes": shapes[-1][1] * 4}
            with torch.backends.cudnn.flags(enabled=True, benchmark=True, deterministic=False,
                                            allow_tf32=False):
                decoder(z)  # the trials of every algorithm
                entry["benchmark_peak_bytes"], entry["benchmark_s"], _ = _peak(lambda: decoder(z))
            if rows == NATIVE_ROWS:
                with torch.backends.cudnn.flags(enabled=False):
                    entry["no_cudnn_peak_bytes"], entry["no_cudnn_s"], _ = _peak(
                        lambda: decoder(z))
                entry["cudnn_extra_bytes"] = peak - entry["no_cudnn_peak_bytes"]
            decode[rows] = entry
    for h in hooks:
        h.remove()

    xs = [torch.as_tensor(x).cuda() for x in next(iter(test_l))[0]]

    def cond_ll():
        return L.protocol_chunked(model, spec, [xs], [generator("cuda", 0)], EVAL_K, EVAL_BK)

    rows_per_call, values, default = {}, {}, L.ROWS_PER_CALL
    try:
        for rows in MEMORY_ROWS:
            L.ROWS_PER_CALL = rows
            cond_ll()
            peak, s, out = _peak(cond_ll)
            rows_per_call[rows] = {"peak_bytes": peak, "s": s}
            values[rows] = out
    finally:
        L.ROWS_PER_CALL = default

    _, _, (_, small_l, _) = reload_model(runs["jnf"], GROUP_BATCH, "cuda")
    batches = [[torch.as_tensor(x).cuda() for x in xs_]
               for (xs_, _), _ in zip(small_l, range(GROUP_BATCHES))]

    def gens():
        return [generator("cuda", 0, b) for b in range(len(batches))]

    def together():
        return L.protocol_chunked(model, spec, batches, gens(), EVAL_K, EVAL_BK)

    def alone():
        return [L.protocol_chunked(model, spec, [b], [g], EVAL_K, EVAL_BK)
                for b, g in zip(batches, gens())]

    together(), alone()
    _, together_s, grouped = _peak(together)
    _, alone_s, single = _peak(alone)

    def rel(a, b):
        return max(float(np.max(np.abs(np.subtract(a[k], b[k])) / np.abs(b[k]))) for k in b)

    rows_err = max(rel(values[r], values[default]) for r in MEMORY_ROWS)
    group_err = rel(grouped, {k: [v[k][0] for v in single] for k in grouped})
    ok = rows_err <= EVAL_LL_RTOL and group_err <= EVAL_LL_RTOL
    emit({"phase": "eval_memory", "run": "jnf", "K": EVAL_K, "batch_size_K": EVAL_BK,
          "decoder_svhn": {str(r): v for r, v in decode.items()},
          "cond_likelihood_batch500": {str(r): v for r, v in rows_per_call.items()},
          "rows_per_call_max_rel_diff": rows_err,
          "grouping": {"batch": GROUP_BATCH, "batches": len(batches), "together_s": together_s,
                       "alone_s": alone_s, "max_rel_diff": group_err},
          "rtol": EVAL_LL_RTOL, "ok": ok})
    if not ok:
        raise AssertionError(f"likelihoods moved with the rows per call ({rows_err}) or the "
                             f"grouping ({group_err})")


class _CastNoise:
    """A Noise whose draws, made on the CPU in float64, are cast to the
    device and dtype of the run: the same noise for the CPU float64 run and
    the cuda float32 one."""

    def __init__(self, seed, device, dtype):
        import torch

        from mmvae_tpu_torch.eval.generation import Noise

        self.noise = Noise([torch.Generator().manual_seed(seed)], dtype=torch.float64)
        self.device, self.dtype = device, dtype

    def draw(self, dist, shape):
        return self.noise.draw(dist, shape).to(self.device, self.dtype)


def phase_eval_parity(tmp, runs):
    """The conditional likelihoods (MVAE's joint likelihood too) and the
    coherence (ns=1) on the first 16 rows of test batch 0 on cuda in
    float32 against the CPU in float64, the same weights, classifiers and
    noise, K=200 in chunks of 100: for the JMVAE-NF, MVAE and MoE-PoE runs."""
    import numpy as np
    import torch

    from mmvae_tpu_torch.cli.common import get_or_train_classifiers, reload_model
    from mmvae_tpu_torch.eval import coherence as C
    from mmvae_tpu_torch.eval import likelihoods as L

    exp = os.path.join(tmp, "experiments")
    for name in ("jnf", "mvae", "moepoe"):
        res = {}
        for dev, dtype in (("cpu", torch.float64), ("cuda", torch.float32)):
            cfg, bundle, loaders = reload_model(runs[name], 500, dev)
            bundle.model.to(dtype)
            classifiers = get_or_train_classifiers(bundle, loaders, exp, cfg.seed, cfg=cfg,
                                                   device=dev)
            for c in classifiers:
                c.model.to(dtype)
            xs, labels = next(iter(loaders[1]))
            xs = [torch.as_tensor(x[:PARITY_ROWS]).to(dev, dtype) for x in xs]
            labels = [l[:PARITY_ROWS] for l in labels]
            with torch.no_grad():
                ll = L.compute_conditional_likelihoods(bundle.model, xs, bundle.spec,
                                                       _CastNoise(1, dev, dtype), PARITY_K,
                                                       EVAL_BK)
                if name == "mvae":
                    ll.update(L.joint_likelihood_mvae(bundle.model, xs, bundle.spec,
                                                      _CastNoise(3, dev, dtype), PARITY_K,
                                                      EVAL_BK))
                acc = C.compute_accuracies(bundle.model, classifiers, xs, labels,
                                           _CastNoise(2, dev, dtype), bundle.spec,
                                           n_data=PARITY_ROWS, ns=1)
            res[dtype] = ({k: v.double().cpu().numpy() for k, v in ll.items()}, acc)
        (ll64, acc64), (ll32, acc32) = res[torch.float64], res[torch.float32]
        errs = {k: float(np.max(np.abs(ll32[k] - ll64[k]) / np.abs(ll64[k]))) for k in ll64}
        ll_err = max(errs.values())
        acc_err = max(abs(acc32[k] - acc64[k]) for k in acc64)
        ok = ll_err <= EVAL_LL_RTOL and acc_err <= 1.0 / PARITY_ROWS + 1e-12
        emit({"phase": "eval_parity", "run": name, "rows": PARITY_ROWS, "K": PARITY_K,
              "batch_size_K": EVAL_BK, "reference": "cpu float64",
              "cond_likelihood_means_ref": {k: float(v.mean()) for k, v in ll64.items()},
              "cond_likelihood_max_rel_err": ll_err, "max_rel_err_by_metric": errs,
              "coherence_ref": acc64, "coherence_cuda": acc32,
              "coherence_max_abs_err": acc_err, "ll_rtol": EVAL_LL_RTOL,
              "coherence_tol": f"1/{PARITY_ROWS}", "ok": ok})
        if not ok:
            raise AssertionError(f"eval of {name} on cuda off the float64 cpu run: likelihood "
                                 f"rel err {errs}, coherence {acc32} vs {acc64}")


# ---------------------------------------------------------------------------
# the ms_small augmentation pipeline (configs/ms_small)
# ---------------------------------------------------------------------------

GEN_STAGE1 = os.path.join(ROOT, "configs", "ms_small", "jnf_synth.json")
GEN_STAGE2 = os.path.join(ROOT, "configs", "ms_small", "jnf_gen_synth.json")
# a quarter of the published data (synthetic_n 20,000, len_train 10,000), so
# that the smoke keeps its time budget beside the data-parallel phases
GEN_N = 2250
GEN_SYNTHETIC_N = 5_000
GEN_LEN_TRAIN = 2_500
GEN_TRAIN_PAIRS = 2250  # len_train 2,500 less the 250-pair val split
# published 200/100 epochs: cut to one warmup epoch and one after it
# (past_warmup is epoch >= warmup, so warmup 2 leaves epoch 1 in warmup)
GEN_RUN1 = dict(epochs=2, warmup=2)
# skip_warmup starts at epoch = warmup: one epoch, for stage 2 and the resume
GEN_RUN2 = dict(epochs=1, warmup=1)
GEN_PLOTS = (("prd_curves.png", ["--prd-curves", "--direction", "1"]),
             ("acc_0_1.png", ["--metric", "acc_0_1"]), ("losses.png", ["--losses"]))
GEN_PARITY_RTOL = 1e-9
GEN_PARITY_EXACT_RTOL = 1e-12


class _Timers:
    """Wraps module attributes so that each call's seconds, synchronized
    on the card, add up under the attribute's name; restores them on exit."""

    def __init__(self, *targets):
        self.targets, self.seconds, self.calls = targets, {}, {}

    def __enter__(self):
        import torch

        self.saved = []
        for owner, name in self.targets:
            fn = getattr(owner, name)
            self.saved.append((owner, name, fn))

            def timed(*args, _fn=fn, _name=name, **kwargs):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = _fn(*args, **kwargs)
                torch.cuda.synchronize()
                self.seconds[_name] = self.seconds.get(_name, 0.0) + time.perf_counter() - t0
                self.calls[_name] = self.calls.get(_name, 0) + 1
                return out

            setattr(owner, name, timed)
        return self

    def __exit__(self, *exc):
        for owner, name, fn in self.saved:
            setattr(owner, name, fn)


def _run_checks(run):
    """(losses finite, skipped steps, epochs run) of a train run dir."""
    with open(os.path.join(run, "losses.json")) as f:
        losses = json.load(f)
    with open(os.path.join(run, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    finite = all(math.isfinite(v) for v in losses["train_loss"] + losses["test_loss"])
    skipped = sum(r.get("train_nan_skipped", 0.0) for r in rows)
    return finite, skipped, len(losses["train_loss"])


def _train_count(lines):
    (line,) = [l for l in lines if l.startswith("Train: ")]
    return int(line.split()[1].rstrip(","))


def phase_gen_slice(tmp, jnf_run):
    """The ms_small augmentation experiment through the port's CLIs on cuda,
    at full width (B=128, latent 20, MLP 512, SVHN f_base 32, 2 MAF blocks
    of 3x128 per modality) and a quarter of the published data (synthetic_n
    5,000, len_train 2,500: 2,250 train pairs after the 250-pair val split):

    1. train `jnf_synth.json` (epochs 2, warmup 2), which publishes the
       joint-encoder pool (save_joint);
    2. `generate_joint --n 2250`: the joint encoder's means of the train
       batches (17 of 128: 2,176 latents), a 10-component mixture by EM,
       2,250 samples decoded, their joint coherence;
    3. train `jnf_gen_synth.json` (one epoch): skip_warmup reloads the pool,
       use_gen appends the 2,250 generated pairs;
    4. `validate --fid-encoder classifier --prd --repeats 1` on stage 2;
    5. `plot_results` in its three modes (its acc_0_1 figure beside the
       validated JMVAE-NF run `jnf_run`);
    6. a `use_pretrain` resume of stage 2 (one epoch).

    Launch counts predicted from the code, each path counted from 0: the
    configs set no_recon, so past warmup compute_kld runs only the flows'
    density direction (no sequential solve) and no train step or val batch
    launches a kernel in either stage; the grids of epoch 1 sample 8
    conditionals of 8 val rows per modality, 2 modalities x 2 MAF blocks =
    4 forward launches (stages 1 and 2; the resume's epoch 2 writes none,
    freq_analytics 5); generate_joint encodes jointly and decodes (none);
    validate 4 per conditional sampling call: coherence and FID per test
    batch and the gen_from_cond grids once, 4 * (2 * nb + 1); no backward
    launch anywhere."""
    import numpy as np
    import torch

    from mmvae_tpu_torch.cli import generate_joint, plot_results, train, validate
    from mmvae_tpu_torch.cli.common import reload_model
    from mmvae_tpu_torch.core.config import ExperimentConfig
    from mmvae_tpu_torch.data.loaders import ArrayLoader, PairedDataset
    from mmvae_tpu_torch.eval import cluster, coherence, generation, gmm
    from mmvae_tpu_torch.train import Trainer

    exp = os.path.join(tmp, "experiments")
    common = ["--experiments-dir", exp, "--device", "cuda"]
    data = dict(analytics=True, synthetic_n=GEN_SYNTHETIC_N, len_train=GEN_LEN_TRAIN)
    t_phase = time.perf_counter()

    cfg1_path, _ = _slice_config(tmp, GEN_STAGE1, **data, **GEN_RUN1)
    run1, lines1, n1, s1 = _counted(train.main, ["--config-path", cfg1_path, *common])

    pool = os.path.join(exp, "joint_encoders", "mnist_svhn_small_synth")
    with _Timers((gmm, "fit_sampler_on_train_latents"), (cluster, "kmeans"),
                 (cluster, "fit_gaussian_mixture"), (gmm.GaussianMixtureSampler, "sample"),
                 (generation, "generate"), (coherence, "compute_joint_accuracy")) as timers:
        joint_acc, lines_gen, n_gen, s_gen = _counted(
            generate_joint.main, ["--run-path", run1, "--n", str(GEN_N), *common])
    sec = timers.seconds
    em = next(l for l in lines_gen if l.startswith("GMM fitted on "))
    n_latents, n_iter = int(em.split()[3]), int(em.split("(")[1].split()[0])
    gen_parts = {"latent_pass_s": sec["fit_sampler_on_train_latents"]
                 - sec["fit_gaussian_mixture"],
                 "kmeans_s": sec["kmeans"], "em_s": sec["fit_gaussian_mixture"] - sec["kmeans"],
                 "em_iterations": n_iter, "sampling_s": sec["sample"],
                 "decode_s": sec["generate"] - sec["sample"],
                 "coherence_s": sec["compute_joint_accuracy"], "total_s": s_gen}
    generated = [np.load(os.path.join(pool, f"generated_modality_{i}.npy")) for i in (0, 1)]

    cfg2_path, _ = _slice_config(tmp, GEN_STAGE2, **data, **GEN_RUN2)
    state_pool = {f"joint_encoder.{k}": v for k, v in torch.load(
        os.path.join(pool, "model_joint_encoder.pt"), weights_only=True).items()}
    for i in (0, 1):
        state_pool.update({f"vaes.{i}.decoder.{k}": v for k, v in torch.load(
            os.path.join(pool, f"model_vaes_{i}_decoder.pt"), weights_only=True).items()})
    run2, lines2, n2, s2 = _counted(train.main, ["--config-path", cfg2_path, *common])
    state1 = torch.load(os.path.join(run1, "model.pt"), weights_only=True)
    state2 = torch.load(os.path.join(run2, "model.pt"), weights_only=True)
    frozen_moved = [n for n, v in state_pool.items() if not torch.equal(v, state2[n])]
    trained = [n for n in state2 if n not in state_pool and not torch.equal(state1[n], state2[n])]

    cfg2 = ExperimentConfig.from_json(cfg2_path)
    nb = len(reload_model(run2, 500, "cuda")[2][1])
    summary, lines_val, n_val, s_val = _counted(validate.main, [
        "--run-path", run2, "--repeats", "1", "--fid-encoder", "classifier", "--prd", *common])
    marks = {l.split("] ", 1)[1]: float(l.split("+")[1].split("s]")[0]) for l in lines_val
             if l.startswith("  [fid +")}
    prd_s = {d: marks[f"prd {d}"] - marks[f"frechet distance {d}"] for d in ("0", "1")}

    # the PRD curve of stage 2; acc_0_1 of the JMVAE-NF run (phase
    # eval_validate) beside stage 2's; the losses of both stages
    plot_runs = {"--prd-curves": [run2], "--metric": [jnf_run, run2], "--losses": [run1, run2]}
    plot_labels = {"--prd-curves": ["stage2"], "--metric": ["jmvae_nf", "stage2"],
                   "--losses": ["stage1", "stage2"]}
    plots = {}
    for name, mode in GEN_PLOTS:
        out = os.path.join(tmp, name)
        _, _, n_plot, _ = _counted(plot_results.main, [
            "--runs", *plot_runs[mode[0]], "--labels", *plot_labels[mode[0]], "--out", out,
            *mode])
        with open(out + ".json") as f:
            plots[name] = {"size": _png_ok(out), "legend": json.load(f)["legend"],
                           "launches": n_plot}

    starts = []
    init_opt_state = Trainer.init_opt_state

    def probe(self, *args, **kwargs):
        if not starts:
            starts.append({n: t.detach().clone() for n, t in self.model.state_dict().items()})
        return init_opt_state(self, *args, **kwargs)

    cfg3_path, _ = _slice_config(tmp, GEN_STAGE2, **data, **GEN_RUN2, use_pretrain=run2)
    Trainer.init_opt_state = probe
    try:
        run3, lines3, n3, s3 = _counted(train.main, ["--config-path", cfg3_path, *common])
    finally:
        Trainer.init_opt_state = init_opt_state
    with open(os.path.join(run3, "args.json")) as f:
        args3 = json.load(f)
    resumed_equal = sorted(starts[0]) == sorted(state2) and all(
        torch.equal(starts[0][n], v) for n, v in state2.items())

    grids = {}
    for run, tag in ((run1, "stage1"), (run2, "stage2")):
        for n in [f"cond_samples_{r}x{o}_001.png" for r in (0, 1) for o in (0, 1)] + \
                ["generate_001.png"]:
            grids[f"{tag}/{n}"] = _png_ok(os.path.join(run, n))
    for n in ("generate_val.png", "gen_from_cond_0.png", "gen_from_cond_1.png",
              "prd_curve_0.png", "prd_curve_1.png"):
        grids[f"validate/{n}"] = _png_ok(os.path.join(run2, n))

    checks = {run: _run_checks(path) for run, path in
              (("stage1", run1), ("stage2", run2), ("resume", run3))}
    launches = {"stage1": n1, "generate_joint": n_gen, "stage2": n2, "validate_prd": n_val,
                "plot_results": tuple(map(sum, zip(*(p["launches"] for p in plots.values())))),
                "resume": n3}
    expected = {"stage1": (4, 0), "generate_joint": (0, 0), "stage2": (4, 0),
                "validate_prd": (4 * (2 * nb + 1), 0), "plot_results": (0, 0), "resume": (0, 0)}
    train1, train2 = _train_count(lines1), _train_count(lines2)
    prd = {k: summary[k]["mean"] for k in ("prd_f8_0", "prd_f8_1", "prd_f1_8_0", "prd_f1_8_1")}
    appended = f"use_gen: appended {GEN_N} generated pairs"
    result = {
        "phase": "gen_slice", "configs": [os.path.basename(GEN_STAGE1),
                                          os.path.basename(GEN_STAGE2)],
        "train_pairs_stage1": train1, "train_pairs_stage2": train2,
        "gmm_latents": n_latents, "generated": [list(g.shape) for g in generated],
        "use_gen_printed": appended in lines2, "frozen_params_compared": len(state_pool),
        "frozen_params_moved": frozen_moved, "trained_params_moved": len(trained),
        "joint_coherence_gmm": joint_acc, "metrics": {k: v["mean"] for k, v in summary.items()},
        "prd": prd, "prd_seconds_by_direction": prd_s, "generate_joint": gen_parts,
        "plots": plots, "grids": grids, "losses_finite_skipped_epochs": checks,
        "resume_args": {k: args3[k] for k in ("epochs", "warmup", "use_pretrain")},
        "resume_starts_at_stage2": resumed_equal, "launches": launches,
        "expected_launches": expected, "test_batches": nb,
        "seconds": {"stage1": s1, "generate_joint": s_gen, "stage2": s2, "validate_prd": s_val,
                    "resume": s3, "phase": time.perf_counter() - t_phase}}
    emit(result)
    problems = []
    if launches != expected:
        problems.append(f"launches {launches}, expected {expected}")
    if not result["use_gen_printed"] or train2 != train1 + GEN_N or train1 != GEN_TRAIN_PAIRS:
        problems.append(f"train pairs {train1} -> {train2}; printed {appended!r}: "
                        f"{result['use_gen_printed']}")
    if generated[0].shape != (GEN_N, 1, 28, 28) or generated[1].shape != (GEN_N, 3, 32, 32):
        problems.append(f"generated {result['generated']}")
    if frozen_moved or not state_pool or not trained:
        problems.append(f"frozen moved {frozen_moved[:5]}; trained moved {len(trained)}")
    if any(not f or sk for f, sk, _ in checks.values()) or \
            [e for *_, e in checks.values()] != [2, 1, 1]:
        problems.append(f"losses finite / skipped / epochs: {checks}")
    if not all(0.0 <= v <= 1.0 for v in prd.values()) or not 0.0 <= joint_acc <= 1.0:
        problems.append(f"prd {prd}, joint coherence {joint_acc}")
    if (args3["epochs"], args3["warmup"]) != (2, 2) or not resumed_equal:
        problems.append(f"resume args {result['resume_args']}, starts at stage 2's "
                        f"parameters: {resumed_equal}")
    if problems:
        raise AssertionError("gen_slice: " + "; ".join(problems))

    # stage 2's steady step (past warmup, frozen joint, no_recon) on its own
    # train set: stage 1's pairs and the generated ones
    ds = reload_model(run2, device="cuda")[2][0].dataset
    merged = PairedDataset([np.concatenate([m, g]) for m, g in zip(ds.modalities, generated)],
                           [np.concatenate([l, np.zeros(GEN_N, l.dtype)]) for l in ds.labels])
    loader2 = ArrayLoader(merged, cfg2.batch_size, shuffle=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _, _, step_s, eval_ms, prof = _steady_steps(cfg2, loader2, epoch=cfg2.warmup)
    emit({"phase": "gen_slice_time", "train_step_ms": step_s * 1e3, "steps_per_s": 1.0 / step_s,
          "eval_batch_ms": eval_ms, "peak_mem_bytes": torch.cuda.max_memory_allocated(), **prof})
    return {k: tuple(v) for k, v in launches.items()}, run1


def phase_gen_parity(run1):
    """The port's k-means, mixture EM, mixture density, PRD and Bernoulli
    family on the card in float64 against the CPU in float64, from the same
    inputs and starts: the stage-1 train latents (the joint encoder's means
    on the card, as generate_joint takes them); k-means from k-means++
    centers drawn on the CPU; EM from that labelling's weights, means and
    precisions; the mixture's log-density with the CPU fit's parameters;
    PRD of 8,960 mixture samples against the latents, clustered from one
    start; the Bernoulli log-density of the MNIST decoder's output on a
    test batch."""
    import numpy as np
    import torch

    from mmvae_tpu_torch.cli.common import reload_model
    from mmvae_tpu_torch.cli.generate_joint import latent_fn
    from mmvae_tpu_torch.core import distributions as D
    from mmvae_tpu_torch.eval import cluster, prd
    from mmvae_tpu_torch.eval.gmm import GaussianMixtureSampler

    cfg, bundle, loaders = reload_model(run1, device="cuda")
    infer = latent_fn(bundle.model, torch.device("cuda"), torch.float32)
    lat = torch.cat([infer(xs) for xs, _ in loaders[0]]).double()
    x = {"cpu": lat.cpu(), "cuda": lat}
    out, errs, secs = {}, {}, {}

    def rel(a, b):
        """max |a - b| over max |b|"""
        a, b = (torch.as_tensor(v).double().cpu() for v in (a, b))
        return float((a - b).abs().max() / b.abs().max())

    init = cluster.kmeans_plusplus(x["cpu"], 10, torch.Generator().manual_seed(0))
    km, fits = {}, {}
    for dev in ("cpu", "cuda"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        km[dev] = cluster.kmeans(x[dev], 10, init=init.to(dev))
        torch.cuda.synchronize()
        secs[f"kmeans_{dev}"] = time.perf_counter() - t0
    start = cluster.init_from_labels(x["cpu"], km["cpu"].labels, 10)
    gmm_init = (start.weights, start.means, torch.linalg.inv(start.covariances))
    for dev in ("cpu", "cuda"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fits[dev] = GaussianMixtureSampler(10).fit(x[dev], init=tuple(a.to(dev) for a in gmm_init))
        torch.cuda.synchronize()
        secs[f"em_{dev}"] = time.perf_counter() - t0
    out["kmeans_labels_equal"] = bool(torch.equal(km["cpu"].labels, km["cuda"].labels.cpu()))
    out["kmeans_iterations"] = [km["cpu"].n_iter, km["cuda"].n_iter]
    errs["kmeans_inertia"] = rel(km["cuda"].inertia, km["cpu"].inertia)
    out["em_iterations"] = [fits["cpu"].fit_result.n_iter, fits["cuda"].fit_result.n_iter]
    for name, a, b in zip(("weights", "means", "covariances"), fits["cuda"].params[:3],
                          fits["cpu"].params[:3]):
        errs[f"em_{name}"] = rel(a, b)
    errs["em_lower_bound"] = rel(fits["cuda"].fit_result.lower_bound,
                                 fits["cpu"].fit_result.lower_bound)
    p = fits["cpu"].params
    on_card = GaussianMixtureSampler.from_params(p.weights, p.means, p.covariances, "cuda")
    errs["gmm_log_prob"] = rel(on_card.log_prob(x["cuda"]), fits["cpu"].log_prob(x["cpu"]))

    samples = fits["cpu"].sample(len(lat), torch.Generator().manual_seed(1), torch.float64)
    union = torch.cat([samples, x["cpu"]])
    start20 = cluster.kmeans_plusplus(union, 20, torch.Generator().manual_seed(2))
    bins, curves, pairs, labels = {}, {}, {}, {}
    for dev in ("cpu", "cuda"):
        labels[dev] = cluster.kmeans(union.to(dev), 20, init=start20.to(dev)).labels
        bins[dev] = prd._histogram_bins(labels[dev], len(samples), 20)
        curves[dev] = prd.compute_prd(*bins[dev])
        pairs[dev] = prd.prd_to_max_f_beta_pair(*curves[dev])
    out["prd_labels_equal"] = bool(torch.equal(labels["cpu"], labels["cuda"].cpu()))
    out["prd_bins_equal"] = all(torch.equal(a.cpu(), b) for a, b in zip(bins["cuda"], bins["cpu"]))
    errs["prd_precision"] = rel(curves["cuda"][0], curves["cpu"][0])
    errs["prd_recall"] = rel(curves["cuda"][1], curves["cpu"][1])
    errs["prd_f_beta_pair"] = rel(pairs["cuda"], pairs["cpu"])
    out["prd_f_beta_pair"] = pairs["cpu"]

    xs, _ = next(iter(loaders[1]))
    with torch.no_grad():
        probs = bundle.model.vaes[0].decode(lat[: len(xs[0])].float()).double()
    target = torch.as_tensor(np.asarray(xs[0])).double()
    lp = {dev: D.log_prob("bernoulli", D.LocScale(probs.to(dev), torch.ones_like(probs, device=dev)),
                          target.to(dev)) for dev in ("cpu", "cuda")}
    errs["bernoulli_log_prob"] = rel(lp["cuda"], lp["cpu"])
    out["bernoulli_log_prob_mean_per_image"] = float(lp["cpu"].reshape(len(target), -1).sum(1).mean())

    tol = {k: (GEN_PARITY_RTOL if k.startswith(("em_", "kmeans")) else GEN_PARITY_EXACT_RTOL)
           for k in errs}
    ok = (out["kmeans_labels_equal"] and out["prd_labels_equal"] and out["prd_bins_equal"]
          and out["em_iterations"][0] == out["em_iterations"][1]
          and all(errs[k] <= tol[k] for k in errs))
    emit({"phase": "gen_parity", "latents": list(lat.shape), "reference": "cpu float64",
          **out, "max_rel_err": errs, "rtol": tol, "seconds": secs, "ok": ok})
    if not ok:
        raise AssertionError(f"gen_parity: {out} {errs}")


# ---------------------------------------------------------------------------
# slice 8: circles-squares and the single-channel MNIST datasets
# ---------------------------------------------------------------------------

CIRCLES = {name: os.path.join(ROOT, "configs", "circles", f"{name}.json")
           for name in ("mmvae", "jmvae_nf", "jmvae_nf_dcca")}
# the JNF run: jmvae_nf_dcca.json at its published 10,000 pairs, 2 epochs
# (published 30), the first in warmup (published 15): past_warmup is epoch
# >= warmup, so warmup 1 would leave no warmup epoch
CIRCLES_JNF_RUN = dict(epochs=2, warmup=2)
# the circles step parities' batch, cut for time (a train batch is 128)
CIRCLES_PARITY_B = 32
CIRCLES_VALIDATE_KEYS = sorted(["acc_0_1", "acc_1_0", "fid_0", "fid_1", "joint_coherence",
                                "neg_entropy"])
MS_VALIDATE_KEYS = sorted(["acc_0_1", "acc_1_0", "fid_0", "fid_1", "joint_coherence"])
DCCA_CIRCLES_EPOCHS = 2
# mmvae.json's epoch at a tenth of its published 200,000 pairs (dataset_size
# 1,000 of 10,000); (train steps, val batches) of one epoch: its 14,000
# train and 3,000 val pairs, jmvae_nf_dcca.json's 7,000 and 1,500, at B=128
CIRCLES_MMVAE_RUN = dict(synthetic_n=None, dataset_size=1_000)
CIRCLES_MMVAE_BATCHES, CIRCLES_JNF_BATCHES = (109, 23), (54, 11)
# the single-channel MNIST runs: configs/mnist_svhn/jmvae_nf.json (MMVAE:
# mmvae.json) with their model swapped and no DCCA; JMVAE-NF 2 epochs with
# the first in warmup, MNIST-Contour at the loaders' default scale,
# MNIST-Fashion's JMVAE-NF and MMVAE (1 epoch) at an eighth of it
# (synthetic_n 512: 4,050 train pairs)
MNIST1CH_JNF_RUN = dict(synthetic_n=None, epochs=2, warmup=2, skip_warmup=False)
MNIST1CH = {"jnf_mnist_fashion": (JNF, dict(MNIST1CH_JNF_RUN, synthetic_n=512)),
            "jnf_mnist_contour": (JNF, MNIST1CH_JNF_RUN),
            "mnist_fashion": (os.path.join(ROOT, "configs", "mnist_svhn", "mmvae.json"),
                              dict(synthetic_n=512))}
# HMC on the card against float64 on the CPU: one step of 10 leapfrogs from
# the same start, momenta and accept-uniforms; the samples to this share of
# their largest entry (float32 round-off through the flows' density and
# its gradient, 10 leapfrogs of 0.01), the accept decisions equal
HMC_RTOL = 1e-4
# radius read-outs on the card against float64 on the CPU: a decoded pixel
# whose float64 value lies within this of the 0.5 threshold may be lit on
# one side only (a kink, as ReLU's in `_step_parity`); the float64 radii are
# read on the card's side of such pixels
RADIUS_KINK_ATOL = 1e-5


class _Tee:
    """A stdout that also keeps what was written."""

    def __init__(self, out):
        self.out, self.lines = out, []

    def write(self, s):
        self.lines.append(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()

    def text(self):
        return "".join(self.lines)


def _tee_call(fn, *args, **kwargs):
    """fn's result and what it printed, still printed."""
    import contextlib

    tee = _Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        out = fn(*args, **kwargs)
    return out, tee.text()


def _rayon_line(text, epoch=1):
    """The rayon metrics the train CLI's analytics printed at `epoch`."""
    import ast

    tag = f"[analytics] rayon metrics epoch {epoch}: "
    lines = [l.split(tag, 1)[1] for l in text.splitlines() if tag in l]
    if len(lines) != 1:
        raise AssertionError(f"expected one '{tag}' line, found {len(lines)}")
    return ast.literal_eval(lines[0])


def _check_rayon(name, rayon, run):
    """The analytics' rayon_corr_ij is there unless direction ij's radii
    are all equal (the JAX package's rule: a correlation needs spread),
    which its histogram's JSON shows."""
    constant = {}
    for ij in ("01", "10"):
        with open(os.path.join(run, f"hist_rayon_{ij}_001.png.json")) as f:
            h = json.load(f)
        constant[ij] = h["min"] == h["max"]
        if (f"rayon_corr_{ij}" in rayon) == constant[ij]:
            raise AssertionError(f"{name}: rayon metrics {rayon}, direction {ij}'s radii "
                                 f"from {h['min']} to {h['max']}")
    return constant


def _run_pngs(run, names):
    missing = [n for n in names if not os.path.exists(os.path.join(run, n))]
    if missing:
        raise AssertionError(f"{run}: missing {missing}")
    return {n: _png_ok(os.path.join(run, n)) for n in names if n.endswith(".png")}


def _validate_counted(run, exp, expected, keys, extra=()):
    """validate --repeats 1 --fid-encoder classifier on cuda (and `extra`
    arguments): its metrics, launches (checked against `expected`) and
    times."""
    from mmvae_tpu_torch.cli import validate

    summary, lines, launches, wall = _counted(validate.main, [
        "--run-path", run, "--experiments-dir", exp, "--repeats", "1",
        "--fid-encoder", "classifier", "--device", "cuda", *extra])
    marks = {l.split("] ", 1)[1]: float(l[1:].split("s]")[0]) for l in lines if l.startswith("[")}
    values = {k: v["mean"] for k, v in summary.items()}
    ok = (launches == expected and sorted(values) == keys
          and all(0.0 <= v <= 1.0 for k, v in values.items()
                  if k.startswith(("acc", "cond_acc", "hmc_acc")) or k == "joint_coherence")
          and all(math.isfinite(v) for v in values.values()))
    return ok, dict(metrics=values, launches=list(launches), expected_launches=list(expected),
                    validate_s=wall, marks=marks)


def phase_circles_slice(tmp):
    """circles-squares through the CLIs on cuda at full width (1x32x32
    one-channel SVHN nets, latent 2, B=128): mmvae.json (MMVAE, DReG at
    K=10) for 1 epoch of its published 200,000 pairs, and
    jmvae_nf_dcca.json (JMVAE-NF, no_recon) at its published 10,000 pairs
    for 2 epochs with warmup 2, each with its own epoch-1 analytics (grids,
    rayon_corr_01/_10 and their histograms); `validate --repeats 1` on both
    (neg_entropy, and for JMVAE-NF the HMC product-of-posteriors figure);
    `compute_likelihoods --bis` on the first test batch of JMVAE-NF; and
    `dcca_train --dataset circles_squares` for 2 epochs. Each path's
    ar_solve launches from 0, against the counts worked out from the code:
    MMVAE none anywhere; JMVAE-NF's training none (no_recon: the flows run
    their density direction only), its epoch-1 analytics 8 (2 modalities x
    2 MAF blocks for the grids, as many for the radii); validate 4 per
    conditional sampling call: coherence and FID per test batch, the grids,
    neg_entropy, and 8 for the PoE figure (the unimodal samples and HMC's
    start); the likelihoods 400; DCCA none; none backward anywhere."""
    import numpy as np

    from mmvae_tpu_torch.cli.dcca_train import main as dcca_main

    exp = os.path.join(tmp, "experiments")
    launches, runs = {}, {}

    # MMVAE-DReG at the published 200,000 pairs
    (cfg, train_loader, info, _), text = _tee_call(
        _cli_epoch, tmp, CIRCLES["mmvae"], analytics=True, **CIRCLES_MMVAE_RUN)
    rayon = _rayon_line(text)
    grids = [f"cond_samples_{r}x{o}_001.png" for r in (0, 1) for o in (0, 1)] + \
        ["generate_001.png"] + [f"hist_rayon_{ij}_001.png{e}" for ij in ("01", "10")
                                for e in ("", ".json")]
    pngs = _run_pngs(info["run_path"], grids)
    got = (info["ar_solve_launches"], info["ar_solve_backward_launches"])
    constant = _check_rayon("circles MMVAE", rayon, info["run_path"])
    emit({"phase": "circles_mmvae_slice", "objective": "m_dreg", "K": cfg.K,
          "latent_dim": cfg.latent_dim,
          "analytics": {"rayon": rayon, "constant_radii": constant, "pngs": pngs},
          "expected_launches": [0, 0], **info})
    if got != (0, 0) or (info["train_steps"], info["val_batches"]) != CIRCLES_MMVAE_BATCHES:
        raise AssertionError(f"circles MMVAE: {info['train_steps']}+{info['val_batches']} "
                             f"batches (expected {CIRCLES_MMVAE_BATCHES}), launches {got} "
                             f"(expected none)")
    if not info["losses_finite"] or info["nan_skipped_fraction"] or not info["params_on_cuda"]:
        raise AssertionError(f"circles MMVAE: finite {info['losses_finite']}, skipped "
                             f"{info['nan_skipped_fraction']}, on cuda {info['params_on_cuda']}")
    launches["circles_mmvae"], runs["mmvae"] = got, info["run_path"]
    _, _, step_s, eval_ms, prof = _steady_steps(cfg, train_loader)
    emit({"phase": "circles_mmvae_slice_time", "train_step_ms": step_s * 1e3,
          "pairs_per_s": cfg.batch_size / step_s, "eval_batch_ms": eval_ms, **prof})

    # JMVAE-NF at the published 10,000 pairs, over the warmup boundary
    (cfg, train_loader, info, _), text = _tee_call(
        _cli_epoch, tmp, CIRCLES["jmvae_nf_dcca"], analytics=True, synthetic_n=None,
        **CIRCLES_JNF_RUN)
    rayon = _rayon_line(text)
    pngs = _run_pngs(info["run_path"], grids)
    got = (info["ar_solve_launches"], info["ar_solve_backward_launches"])
    expected_by_epoch = [(8, 0), (8, 0)]
    constant = _check_rayon("circles JNF", rayon, info["run_path"])
    emit({"phase": "circles_jnf_slice", "config": "jmvae_nf_dcca.json", "dcca": cfg.dcca,
          "no_recon": cfg.no_recon,
          "analytics": {"rayon": rayon, "constant_radii": constant, "pngs": pngs},
          "expected_launches_by_epoch": expected_by_epoch,
          "expected_analytics_launches_by_epoch": [8, 0], **info})
    if (info["launches_by_epoch"] != expected_by_epoch
            or info["callback_launches_by_epoch"] != [8, 0]
            or (info["train_steps"], info["val_batches"]) != CIRCLES_JNF_BATCHES):
        raise AssertionError(f"circles JNF: launches by epoch {info['launches_by_epoch']} "
                             f"(analytics {info['callback_launches_by_epoch']}), batches "
                             f"{info['train_steps']}+{info['val_batches']}")
    if not info["losses_finite"] or info["nan_skipped_fraction"] or cfg.dcca:
        raise AssertionError(f"circles JNF: finite {info['losses_finite']}, "
                             f"skipped {info['nan_skipped_fraction']}, dcca {cfg.dcca}")
    launches["circles_jnf"], runs["jnf"] = got, info["run_path"]
    _, _, step_s, eval_ms, prof = _steady_steps(cfg, train_loader, epoch=2)
    emit({"phase": "circles_jnf_slice_time", "epoch": 2, "train_step_ms": step_s * 1e3,
          "eval_batch_ms": eval_ms, **prof})

    # validate on both: the classifier pool's empty/full net trains on first use
    from mmvae_tpu_torch.cli.common import reload_model

    nb = len(reload_model(runs["jnf"], 500, "cuda")[2][1])
    for name, run in runs.items():
        expected = (0 if name == "mmvae" else 4 * (2 * nb + 1) + 4 + 8, 0)
        ok, res = _validate_counted(run, exp, expected, CIRCLES_VALIDATE_KEYS)
        files = ["hist_000.png", "hist_000.png.json"] + (
            ["product_of_posteriors.png", "product_of_posteriors.png.json"] if name == "jnf" else [])
        res["pngs"] = _run_pngs(run, files)
        m = res.pop("marks")
        res["repeat_s"] = m["repeat 0: fid done"] - m["classifiers ready"]
        res["classifiers_s"] = m["classifiers ready"] - m["model reloaded"]
        if name == "jnf":
            res["poe_figure_s"] = m["product of posteriors done"] - m["repeat 0: fid done"]
        emit({"phase": "circles_validate", "run": name, "test_batches": nb, **res, "ok": ok})
        if not ok:
            raise AssertionError(f"circles validate on {name}: {res}")
        launches[f"validate_circles_{name}"] = tuple(res["launches"])

    # the likelihoods of JMVAE-NF on its first test batch
    launches["likelihoods_circles_jnf"] = _likelihood_batch(runs["jnf"], "circles")

    # DCCA pretraining on circles-squares
    path, lines, got, wall = _counted(dcca_main, [
        "--dataset", "circles_squares", "--device", "cuda", "--epochs", str(DCCA_CIRCLES_EPOCHS),
        "--batch-size", str(DCCA_BATCH), "--data-path", os.path.join(tmp, "data"),
        "--out", os.path.join(tmp, "dcca")])
    losses = [l.split() for l in lines if l.startswith("DCCA epoch")]
    losses = [(float(w[w.index("train") + 1]), float(w[w.index("val") + 1])) for w in losses]
    with np.load(path) as npz:
        shapes = {k: list(npz[k].shape) for k in ("m0", "m1", "w0", "w1")}
        finite = all(np.isfinite(npz[k]).all() for k in ("m0", "m1", "w0", "w1", "D"))
    ok = (got == (0, 0) and len(losses) == DCCA_CIRCLES_EPOCHS and finite
          and all(math.isfinite(v) for pair in losses for v in pair)
          and shapes == {"m0": [16], "m1": [16], "w0": [16, 16], "w1": [16, 16]})
    emit({"phase": "circles_dcca", "trunks": "dcca_encoders_circles", "outdim": 16,
          "losses_train_val": losses, "artifact_shapes": shapes, "launches": list(got),
          "cli_wall_s_incl_setup": wall, "ok": ok})
    if not ok:
        raise AssertionError(f"circles DCCA: launches {got}, losses {losses}, shapes {shapes}")
    launches["dcca_circles"] = got
    return launches, runs


class _GivenNoise:
    """A Noise that hands out the given numpy arrays in turn, broadcast to
    each draw's shape, on `device` in `dtype`."""

    def __init__(self, arrays, device, dtype):
        self.arrays, self.device, self.dtype, self.i = list(arrays), device, dtype, 0

    def draw(self, dist, shape):
        import numpy as np
        import torch

        a = np.broadcast_to(self.arrays[self.i], tuple(shape))
        self.i += 1
        return torch.tensor(a, device=self.device, dtype=self.dtype)


def _radius_parity(models, data_np, n, noise_np, true_radii=None):
    """Radii read off cross-modal samples (n per row, both directions) of
    the cuda float32 model and the CPU float64 one from the same noise:
    pixels lit on one side only must lie within RADIUS_KINK_ATOL of 0.5 in
    float64; with them taken on the card's side the float64 radii equal the
    card's. Returns (neg_entropy or rayon_corr metrics on the card, the
    float64 ones on their own side, pixels on the other side, the largest
    |x - 0.5| among them)."""
    import numpy as np
    import torch

    from mmvae_tpu_torch.eval.generation import sample_from_conditional
    from mmvae_tpu_torch.eval.latent_analysis import negative_entropy
    from mmvae_tpu_torch.vis import extract_rayon

    imgs = {}
    for key, (model, dev, dtype) in models.items():
        xs = [torch.tensor(x, device=dev, dtype=dtype) for x in data_np]
        with torch.no_grad():
            s = sample_from_conditional(model, xs, _GivenNoise(noise_np, dev, dtype), n=n)
        imgs[key] = [s[0][1].double().cpu().numpy(), s[1][0].double().cpu().numpy()]
    flips, kink = 0, 0.0
    radii = {key: [] for key in imgs}
    for d in range(2):
        a32, a64 = imgs["cuda_f32"][d], imgs["cpu_f64"][d]
        other = (a32[..., 0, :, :] > 0.5) != (a64[..., 0, :, :] > 0.5)
        flips += int(other.sum())
        if other.any():
            kink = max(kink, float(np.abs(a64[..., 0, :, :][other] - 0.5).max()))
        for key in imgs:
            radii[key].append(extract_rayon(imgs[key][d]))

    def metrics(r):
        if true_radii is None:  # (n, B) per direction -> rows = datapoints
            return {"neg_entropy": negative_entropy(np.concatenate([r[0].T, r[1].T]), (0, 1), 10)}
        out = {}
        for (i, j), r_est, r_true in zip(((0, 1), (1, 0)), r, true_radii):
            r_est = r_est[0]
            if np.std(r_est) > 0 and np.std(r_true) > 0:
                out[f"rayon_corr_{i}{j}"] = float(np.corrcoef(r_true, r_est)[0, 1])
        return out

    return metrics(radii["cuda_f32"]), metrics(radii["cpu_f64"]), flips, kink


def phase_circles_parity(tmp, jnf_run):
    """circles-squares on the card against float64 on the CPU: one
    MMVAE-DReG training step (K=10, B=32; its two modalities' (K, B, 2)
    noise), one post-warmup JMVAE-NF step (frozen joint, no_recon; B=32),
    both on the cuda step's ReLU branches (`_step_parity` with
    align_relu); on the trained JMVAE-NF run, one HMC step over the product of experts at the
    PoE figure's shape (4 test pairs x 30 chains) from the same modality
    choice, start noise, momenta and accept-uniforms, whose start runs the
    forward kernel on the card (4 launches); and the radius read-outs:
    neg_entropy at validate's shape (100 rows x 10 samples) and
    rayon_corr_01/_10 at the analytics' (64 val rows)."""
    import copy

    import numpy as np
    import torch

    from mmvae_tpu_torch.cli.common import reload_model
    from mmvae_tpu_torch.eval import hmc as H
    from mmvae_tpu_torch.ops import ar_flow

    # 10,000 pairs: one batch is needed
    cut = dict(synthetic_n=None, dataset_size=500, batch_size=CIRCLES_PARITY_B)
    _step_parity(tmp, CIRCLES["mmvae"], [(10, CIRCLES_PARITY_B, 2)] * 2,
                 "circles_mmvae_parity", cut, align_relu=True, grad_tol=MMVAE_GRAD_TOL)
    _step_parity(tmp, CIRCLES["jmvae_nf"], 2, "circles_jnf_parity", {**cut, **CIRCLES_JNF_RUN},
                 align_relu=True, frozen_joint=True, no_recon=True)

    cfg, bundle, (_, test_l, val_l) = reload_model(jnf_run, 500, "cuda")
    models = {"cuda_f32": (bundle.model, "cuda", torch.float32),
              "cpu_f64": (copy.deepcopy(bundle.model).to("cpu", torch.float64), "cpu",
                          torch.float64)}
    xs_np = [np.asarray(x) for x in next(iter(test_l))[0]]
    rng = np.random.default_rng(3)
    n_data, chains, latent = 4, 30, cfg.latent_dim
    n = n_data * chains
    choice = rng.integers(0, 2, n)
    eps = [rng.standard_normal((n, latent)) for _ in range(2)]
    rho, u = rng.standard_normal((1, n, latent)), rng.uniform(size=(1, n))
    hmc = {}
    for key, (model, dev, dtype) in models.items():
        t = lambda a: torch.tensor(a, device=dev, dtype=dtype)  # noqa: E731
        data = [t(x[:n_data]) for x in xs_np]
        torch.cuda.synchronize()
        ar_flow.ar_solve.launches = ar_flow.ar_solve.backward_launches = 0
        with torch.no_grad():
            z0 = H.sample_from_moe_subset(model, [0, 1], [torch.cat([d] * chains) for d in data],
                                          choice=torch.tensor(choice), eps=[t(e) for e in eps])
            z, acc = H.sample_from_poe_subset(model, [0, 1], data, mcmc_steps=1, n_lf=10,
                                              eps_lf=0.01, K=chains, divide_prior=False,
                                              return_acceptance=True, z0=z0, rho=t(rho), u=t(u))
        torch.cuda.synchronize()
        hmc[key] = dict(z0=z0.double().cpu(), z=z.reshape(n, -1).double().cpu(), acc=float(acc),
                        launches=(ar_flow.ar_solve.launches, ar_flow.ar_solve.backward_launches))
    ref, got = hmc["cpu_f64"], hmc["cuda_f32"]
    moved = {k: (v["z"] != v["z0"]).any(1) for k, v in hmc.items()}
    scale = ref["z"].abs().max().item()
    z0_err = (got["z0"] - ref["z0"]).abs().max().item() / scale
    z_err = (got["z"] - ref["z"]).abs().max().item() / scale
    same_moves = bool(torch.equal(moved["cuda_f32"], moved["cpu_f64"]))
    ok = (same_moves and z0_err <= HMC_RTOL and z_err <= HMC_RTOL
          and got["launches"] == (4, 0) and ref["launches"] == (0, 0))
    emit({"phase": "circles_hmc_parity", "chains": chains, "rows": n_data, "steps": 1,
          "leapfrogs": 10, "eps_lf": 0.01, "reference": "cpu float64",
          "acceptance_cuda": got["acc"], "acceptance_ref": ref["acc"],
          "accept_decisions_equal": same_moves, "z0_rel_err": z0_err, "z_rel_err": z_err,
          "rtol": HMC_RTOL, "launches_cuda": list(got["launches"]), "expected_launches": [4, 0],
          "ok": ok})
    if not ok:
        raise AssertionError(f"circles HMC: cuda vs float64 {z0_err}, {z_err}, moves equal "
                             f"{same_moves}, launches {got['launches']}")

    # neg_entropy at validate's shape, rayon_corr at the analytics'
    noise = [rng.standard_normal((10, 100, latent)) for _ in range(2)]
    ent = _radius_parity(models, [x[:100] for x in xs_np], 10, noise)
    val = val_l.dataset
    rows = [np.asarray(m[:64]) for m in val.modalities]
    true = (val.extras["r_circles"][:64], val.extras["r_squares"][:64])
    ray = _radius_parity(models, rows, 1, [rng.standard_normal((64, latent)) for _ in range(2)],
                         true_radii=true)
    out = {}
    for what, (cuda, own, flips, kink) in (("neg_entropy", ent), ("rayon_corr", ray)):
        out[what] = {"cuda": cuda, "cpu_f64_own_side": own, "pixels_on_other_side": flips,
                     "their_max_abs_from_threshold": kink}
    ok = all(v["their_max_abs_from_threshold"] <= RADIUS_KINK_ATOL for v in out.values()) \
        and sorted(ray[0]) == sorted(ray[1])
    emit({"phase": "circles_radius_parity", **out, "kink_atol": RADIUS_KINK_ATOL,
          "reference": "cpu float64, each pixel within kink_atol of 0.5 on the card's side",
          "ok": ok})
    if not ok:
        raise AssertionError(f"circles radius parity: {out}")


def phase_mnist1ch_slice(tmp):
    """The single-channel MNIST datasets through the CLIs on cuda at full
    width (conv MNIST nets with BatchNorm, latent 20, B=128), from
    configs/mnist_svhn/jmvae_nf.json with the model swapped (mmvae.json for
    MMVAE), no DCCA, at the loaders' default synthetic scale:
    jnf_mnist_fashion and jnf_mnist_contour for 2 epochs (warmup 2: the
    first trains the joint encoder, the second the unimodal encoders and
    flows with their reconstructions), mnist_fashion (MMVAE-DReG) for 1 at
    an eighth of the data;
    then `validate --repeats 1` on each. Launches from the code: epoch 1
    only its grids' 4 (2 modalities x 2 MAF blocks); epoch 2 4 forward per
    train step and val batch and 4 backward per train step (compute_kld's
    unimodal VAE forwards, under autograd); validate 4 x (2 x test batches
    + 1); MMVAE none."""
    from mmvae_tpu_torch.cli.common import reload_model

    exp = os.path.join(tmp, "experiments")
    launches = {}
    for model, (base, run) in MNIST1CH.items():
        with open(base) as f:
            raw = json.load(f)
        raw.update(model=model, dcca=False, experiment=f"smoke/{model}")
        path = os.path.join(tmp, f"{model}.json")
        with open(path, "w") as f:
            json.dump(raw, f)
        jnf = model.startswith("jnf")
        cfg, train_loader, info, epochs = _cli_epoch(tmp, path, analytics=True, **run)
        steps, val_b = info["train_steps"], info["val_batches"]
        expected = ([(4, 0), (4 + 4 * (steps + val_b), 4 * steps)] if jnf else [(0, 0)])
        got = info["launches_by_epoch"]
        emit({"phase": "mnist1ch_slice", "model": model, "latent_dim": cfg.latent_dim,
              "no_recon": cfg.no_recon, "expected_launches_by_epoch": expected, **info})
        if got != expected or not info["losses_finite"] or not info["params_on_cuda"]:
            raise AssertionError(f"{model}: launches by epoch {got} (expected {expected}), "
                                 f"finite {info['losses_finite']}")
        launches[model] = got[-1]
        if model == "jnf_mnist_fashion":
            _, _, step_s, eval_ms, prof = _steady_steps(cfg, train_loader, epoch=2)
            emit({"phase": "mnist1ch_slice_time", "model": model, "epoch": 2,
                  "train_step_ms": step_s * 1e3, "eval_batch_ms": eval_ms, **prof})
        run = info["run_path"]
        nb = len(reload_model(run, 500, "cuda")[2][1])
        ok, res = _validate_counted(run, exp, (4 * (2 * nb + 1) if jnf else 0, 0),
                                    MS_VALIDATE_KEYS)
        res.pop("marks")
        emit({"phase": "mnist1ch_validate", "model": model, "test_batches": nb, **res, "ok": ok})
        if not ok:
            raise AssertionError(f"validate on {model}: {res}")
        launches[f"validate_{model}"] = tuple(res["launches"])
    return launches


# the ResNet datasets (MedMNIST, chest-X-ray-SVHN, CelebA): their published
# configs at full width, at the loaders' default synthetic scale
# (synthetic_n 2,048) unless said otherwise
MEDMNIST = {name: os.path.join(ROOT, "configs", "medmnist", f"{name}.json")
            for name in ("jnf_sbound", "mmvae", "mvae", "jmvae_nf_dcca")}
CHEST = os.path.join(ROOT, "configs", "chest_svhn", "jmvae_exact_synth.json")
CELEBA = {name: os.path.join(ROOT, "configs", "celeba", f"{name}.json")
          for name in ("jmvae_nf", "mmvae_nf", "mvae", "moepoe")}
CELEBA_VALIDATE_KEYS = sorted(["accuracy1", "accuracy2", "fid_0", "fid_1", "joint_coherence"])
# MedMNIST's JMVAE-NF runs at half that scale (3,012 train pairs, 23
# steps), MMVAE and MVAE "a few steps" at an eighth (762 pairs, 5 steps)
MEDMNIST_JNF_RUN = dict(JNF_RUN, synthetic_n=1024)
MEDMNIST_FEW_STEPS = dict(synthetic_n=256)
# the ResNet parity steps at B=32, not the configs' 128: their float64 CPU
# steps, not the check, took the time
RESNET_PARITY_B = dict(batch_size=32)
# the later slices' spot likelihood batch (circles, MedMNIST, trimodal, IAF):
# 250 test rows at K=1000, for the smoke's time; the MNIST-SVHN evaluation
# phase keeps its test batch of 500
SLICE_LL_ROWS = 250
# CelebA's likelihood batch: 100 test rows at K=1000 (its 64x64 decoder
# makes 500 rows cost several times MNIST-SVHN's batch)
CELEBA_LL_ROWS = 100
# the kernels at MedMNIST's latent 16 and CelebA's 64: rows of a train step
# (B=128), of a ragged tile, MMVAE-NF's K*B = 30*256 on CelebA (forward and
# backward) and an importance-sampling call of the likelihoods (forward only)
LATENT64_BWD_ROWS = (128, 256, 7_680)
LATENT64_ROWS = LATENT64_BWD_ROWS + (EVAL_IS_ROWS,)
# the backward is timed at a train step's rows, at CelebA MMVAE-NF's (its
# solves run at B = 256 rows) and at K*B
LATENT64_BWD_TIME_ROWS = (128, 256, 7_680)
# the kernels at the trimodal latent 30: TELBO-NF's train step at B=256
# (forward and backward) and HMC's start (32 x 8 rows), a validate batch
# and an IS call (forward only)
LATENT30_BWD_ROWS = (256,)
LATENT30_ROWS = (256, 500, EVAL_IS_ROWS)


def _kernel_branches(tape):
    """The forward kernel's hidden ReLU branches (`relu_branches` of the
    solve's ReLU: above, at the tie, below), read from its tape of
    pre-activations, in the order the plain solve calls `hidden_relu`: step
    by step, layer by layer."""
    return [relu_branches(z[i], tie=True) for i in range(tape.s.shape[0]) for z in tape.z]


def phase_ar_solve_latent64():
    """Both kernels at D = 16 (MedMNIST's latent) and D = 64 (CelebA's), MADE
    widths [D, 128, 128, 128, 2D], where the first layer and the head are
    read per step from device memory (shared memory holds the two hidden
    128x128 layers only): the forward against `unrolled_solve` at N = 128,
    256, 7,680 and 10,000, the backward (both launches) against autograd
    through it at N = 128, 256 and 7,680, both signs, s_bound 0 and 8; then
    the forward's device time at each N and the backward's at N = 128, 256
    and 7,680, beside their plain versions and their bounds (`_ar_solve_at`)."""
    rows = (LATENT64_ROWS, LATENT64_BWD_ROWS, LATENT64_BWD_TIME_ROWS)
    return _ar_solve_at({16: rows, 64: rows})


# MADE's zero initial biases at CelebA's latent 64, at K*B = 30*256 rows,
# MMVAE-NF's K and B (its solves themselves run at B rows)
TIES_D, TIES_ROWS = 64, 7_680


def _tie_inputs(x, ws):
    """(x, ws) at which MADE's zero-bias ties carry gradient past step 0. At
    step 0 every hidden unit is tied, but no head column reads one. At zero
    biases y_0 = x_0 (the head's columns 0 and D read no unit); here
    y_0 = |x_0| > 0, and the first layer's degree-0 units, whose one input
    is y_0, take negative weights. From step 1 on they are off, and every
    degree-0 unit of the later hidden layers sits exactly at the tie, where
    the head's columns past 0 read it."""
    deg0 = (ws[0] != 0).sum(0) == 1
    w0 = ws[0].clone()
    w0[0, deg0] = -w0[0, deg0].abs()
    x = x.clone()
    x[:, 0] = x[:, 0].abs()
    return x, [w0, *ws[1:]]


def phase_ar_solve_ties():
    """The backward at MADE's zero initial biases, D = 64, 7,680 rows, both
    signs, at inputs where the ties carry gradient (`_tie_inputs`): the
    kernels take JAX's slope 1/2 there. The backward against its plain
    version on the kernel's branches, and against that version at slope 0
    at the ties, which it must miss (`_check_backward`); the count of units
    tied past step 0 in the tape, which must not be 0."""
    import torch

    from mmvae_tpu_torch.ops import ar_flow

    gen = torch.Generator().manual_seed(TIES_D + 1)
    ws, bs = _made_params(TIES_D, 128, 3, gen)
    bs = [torch.zeros_like(b) for b in bs]
    x, gy = (torch.randn(TIES_ROWS, TIES_D, generator=gen).cuda() for _ in range(2))
    gld = torch.randn(TIES_ROWS, generator=gen).cuda()
    x, ws = _tie_inputs(x, ws)
    err = 0.0
    for sign in (1, -1):
        err = max(err, _check_backward(dict(d=TIES_D, n=TIES_ROWS, sign=sign, s_bound=0.0,
                                            zero_biases=True), x, ws, bs, sign, 0.0, gy, gld,
                                       tie_control=True))
    tape = ar_flow.new_tape(x, ws)
    ar_flow.kernel_forward(x, ws, bs, 1, 0.0, tape=tape)
    ties = [int((z[1:] == 0).sum()) for z in tape.z]
    emit({"phase": "ar_solve_ties", "d": TIES_D, "n": TIES_ROWS,
          "tied_units_past_step_0_by_layer": ties, "units_by_layer": tape.z[0].numel(),
          "max_abs_err": err, "ok": sum(ties) > 0})
    if sum(ties) == 0:
        raise AssertionError("ar_solve_ties: no hidden unit tied past step 0")
    return err


def phase_ar_solve_latent30():
    """Both kernels at D = 30, the latent of the trimodal JMVAE-NF-DCCA and
    TELBO-NF configs (MADE widths [30, 128, 128, 128, 60]), at the rows the
    MNIST-SVHN-Fashion paths give them: the forward at N = 256 (a TELBO-NF
    train step at B = 256, and HMC's start, 32 test rows x 8 chains), 500
    (a validate batch) and 10,000 (an IS call), the backward at N = 256;
    checks, times and bounds as `_ar_solve_at`."""
    return _ar_solve_at({30: (LATENT30_ROWS, LATENT30_BWD_ROWS, LATENT30_BWD_ROWS)})


def _ar_solve_at(widths):
    """Both kernels at each D of `widths`, {D: (forward rows, backward rows,
    backward timed rows)}: the forward against `unrolled_solve` and the
    backward (both launches) against autograd through it, both signs,
    s_bound 0 and 8; then the forward's device time at each of its rows and
    the backward's at its timed rows, beside their plain versions and their
    bounds (D - 1 per-row passes, `solve_flops`, `vjp_flops`). The
    backward's reference takes the forward kernel's hidden ReLU branches
    (`_check_backward`)."""
    import torch

    from mmvae_tpu_torch.ops import ar_flow

    h, n_hidden = 128, 3
    out, errs = {}, {}
    for d, (fwd_rows, bwd_rows, bwd_time_rows) in widths.items():
        gen = torch.Generator().manual_seed(d)
        ws, bs = _made_params(d, h, n_hidden, gen)
        errs[d] = {"forward": 0.0, "backward": 0.0}
        smem = {k: ar_flow._check_smem(tuple([d] + [w.shape[1] for w in ws]), 0, k == "backward")
                for k in ("forward", "backward")}
        for n in sorted(set(fwd_rows) | set(bwd_rows)):
            x, gy = (torch.randn(n, d, generator=gen).cuda() for _ in range(2))
            gld = torch.randn(n, generator=gen).cuda()
            for sign in (1, -1):
                for s_bound in (0.0, 8.0):
                    what = dict(d=d, n=n, sign=sign, s_bound=s_bound)
                    with torch.no_grad():
                        y_k, ld_k = ar_flow.kernel_forward(x, ws, bs, sign, s_bound)
                        y_p, ld_p = ar_flow.unrolled_solve(x, ws, bs, sign, s_bound)
                    torch.cuda.synchronize()
                    errs[d]["forward"] = max(errs[d]["forward"], _check_close(
                        dict(kernel="forward", **what), [(y_k, y_p), (ld_k, ld_p)]))
                    if n in bwd_rows:
                        errs[d]["backward"] = max(errs[d]["backward"], _check_backward(
                            what, x, ws, bs, sign, s_bound, gy, gld))

        n_w = sum(w.numel() for w in ws)
        n_b = sum(b.numel() for b in bs)
        res = {}
        for n in fwd_rows:
            x = torch.randn(n, d, generator=gen).cuda()
            with torch.no_grad():
                k_ms = device_time_ms(lambda: ar_flow.kernel_forward(x, ws, bs, 1, 0.0))
                p_ms = cuda_time_ms(lambda: ar_flow.unrolled_solve(x, ws, bs, 1, 0.0), rounds=5)
            flops, n_bytes = solve_flops(n, d, h, n_hidden), 4 * (2 * n * d + n + n_w + n_b)
            bound_ms, bound_by = bound(flops, n_bytes)
            res[f"n{n}"] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=bound_ms, bound_by=bound_by)
            emit({"phase": "ar_solve_time", "kernel": "forward", "d": d, "n": n,
                  "kernel_ms": k_ms, "plain_ms": p_ms, "flops": flops, "bytes": n_bytes,
                  "bound_ms": bound_ms, "bound_by": bound_by, "roofline_share": bound_ms / k_ms,
                  "smem_bytes": smem["forward"]})
        for n in bwd_time_rows:
            x, gy = (torch.randn(n, d, generator=gen).cuda() for _ in range(2))
            gld = torch.randn(n, generator=gen).cuda()
            tape = ar_flow.new_tape(x, ws)
            y, _ = ar_flow.kernel_forward(x, ws, bs, 1, 0.0, tape=tape)

            def bwd():
                ar_flow.kernel_backward(x, y, gy, gld, tape, ws, 1, 0.0)

            b_ms = device_time_ms(bwd)
            split = backward_kernel_ms(bwd)
            pb_ms = cuda_time_ms(_plain_vjp(x, ws, bs, 1, 0.0, gy, gld), rounds=5)
            b_flops, b_bytes = vjp_flops(n, d, h, n_hidden), vjp_bytes(n, d, n_w, n_b)
            b_bound_ms, b_bound_by = bound(b_flops, b_bytes)
            res[f"backward_n{n}"] = dict(ms=b_ms, kernel_ms=split["chain"], plain_ms=pb_ms,
                                         bound_ms=b_bound_ms, bound_by=b_bound_by)
            emit({"phase": "ar_solve_time", "kernel": "backward", "d": d, "n": n, "ms": b_ms,
                  "kernel_ms": split["chain"], "sum_kernel_ms": split["sum"],
                  "plain_ms": pb_ms, "flops": b_flops, "bytes": b_bytes,
                  "bound_ms": b_bound_ms, "bound_by": b_bound_by,
                  "roofline_share": b_bound_ms / b_ms, "smem_bytes": smem["backward"]})
        out[d] = res
    return dict(results=out, errs=errs)


def _check_run(name, info, expected_by_epoch):
    """A CLI run's launches by epoch against the code's count, its finite
    losses, no skipped step, parameters on cuda."""
    got = info["launches_by_epoch"]
    if got != expected_by_epoch or not info["losses_finite"] or not info["params_on_cuda"] \
            or info["nan_skipped_fraction"]:
        raise AssertionError(f"{name}: launches by epoch {got} (expected {expected_by_epoch}), "
                             f"finite {info['losses_finite']}, on cuda {info['params_on_cuda']}, "
                             f"skipped {info['nan_skipped_fraction']}")
    return info["ar_solve_launches"], info["ar_solve_backward_launches"]


def _jnf_expected(info):
    """JMVAE-NF over the warmup boundary without analytics: epoch 1 no
    launch; epoch 2 4 forward per train step and val batch (compute_kld's
    unimodal VAE forwards: 2 modalities x 2 MAF blocks) and 4 backward per
    train step; counts read at each epoch's end, so cumulative."""
    steps, val_b = info["train_steps"], info["val_batches"]
    return [(0, 0), (4 * (steps + val_b), 4 * steps)]


def _likelihood_batch(run, name, rows=SLICE_LL_ROWS, n_mod=2, sequential_sampling=True):
    """compute_likelihoods --bis on cuda at EVAL_K on the first test batch
    of `rows`: finite values, JAX's names, the ordered pairs of the n_mod
    modalities x 2 MAF blocks x 2 estimators x the K-chunks x the IS calls
    of the batch forward launches, none backward; none at all where the
    flows sample in parallel (not `sequential_sampling`: IAF, whose
    sequential direction no estimator takes). The metrics: each ordered
    pair's conditional and bis likelihoods, the joint likelihood and, with
    three modalities, cond_lw_subset of each."""
    from mmvae_tpu_torch.cli import compute_likelihoods

    summary, _, got, wall = _counted(compute_likelihoods.main, [
        "--run-path", run, "--k", str(EVAL_K), "--batch-size-k", str(EVAL_BK), "--repeats", "1",
        "--batch-size", str(rows), "--max-batches", "1", "--bis", "--device", "cuda"])
    calls = -(-rows // (EVAL_IS_ROWS // EVAL_BK))
    pairs = n_mod * (n_mod - 1)
    expected = (pairs * 2 * 2 * (EVAL_K // EVAL_BK) * calls * sequential_sampling, 0)
    values = {k: v["mean"] for k, v in summary.items()}
    n_metrics = 2 * pairs + 1 + (n_mod if n_mod == 3 else 0)
    ok = (got == expected and all(math.isfinite(v) for v in values.values())
          and len(values) == n_metrics)
    emit({"phase": f"{name}_likelihoods", "K": EVAL_K, "rows": rows, "metrics": values,
          "launches": list(got), "expected_launches": list(expected),
          "wall_s_incl_reload": wall, "ok": ok})
    if not ok:
        raise AssertionError(f"{name} likelihoods: launches {got} (expected {expected}), {values}")
    return got


def _trunks_off_artifact(model, dcca_path):
    """Leaves of the TwoStepsEncoders' DCCA trunks and projections that
    differ from the artifact's (the identity projection where the model
    keeps it, the trimodal trunks'), and how many were compared."""
    import numpy as np

    from mmvae_tpu_torch.bridge import _flatten, export_jax_params
    from mmvae_tpu_torch.dcca.train import load_trunk_params

    trunks = load_trunk_params(dcca_path)
    off, compared = [], 0
    with np.load(dcca_path) as npz:
        for i, vae in enumerate(model.vaes):
            site = vae.encoder.first_encoder
            want = _flatten(trunks[f"encoders_{i}"])
            for k, a in _flatten(export_jax_params(site.encoder)).items():
                compared += 1
                if not np.array_equal(a, want[k]):
                    off.append(f"vaes.{i}/{'/'.join(k)}")
            d = site.m.shape[0]
            for b, ident in (("m", np.zeros(d)), ("w", np.eye(d))):
                compared += 1
                want_b = npz[f"{b}{i}"] if site.fitted_lcca else ident
                if not np.array_equal(getattr(site, b).cpu().numpy(),
                                      want_b.astype(np.float32)):
                    off.append(f"vaes.{i}/{b}")
    return off, compared


def phase_medmnist_slice(tmp):
    """MedMNIST (pneumonia <-> blood, ResNet nets) and chest-X-ray <-> SVHN
    through the CLIs on cuda at full width: jnf_sbound.json (latent 16, MAF
    with s_bound 8, gradient clipping at 40,000) for 2 epochs with warmup 2,
    its launches as `_jnf_expected` counts them; `validate --repeats 1`
    (pneumonia's and blood's classifiers trained into the pool first) and
    one `compute_likelihoods --bis` test batch of SLICE_LL_ROWS on it; mmvae.json
    (Laplace, DReG-looser, K=10) and mvae.json for a few steps, no launch;
    `dcca_train --dataset medmnist` (2 epochs) and jmvae_nf_dcca.json
    grafting its artifact (2 epochs, warmup 2, no_recon: no launch; trunks
    and projections equal to the artifact after training); chest-SVHN's
    jmvae_exact_synth.json for one epoch (linear warmup, no flow, nothing
    frozen in either phase: the joint trunk and decoders moved; no launch)."""
    import torch

    from mmvae_tpu_torch.cli.common import reload_model
    from mmvae_tpu_torch.cli.dcca_train import main as dcca_main
    from mmvae_tpu_torch.models import registry
    from mmvae_tpu_torch.train import Trainer, freezing

    exp = os.path.join(tmp, "experiments")
    launches = {}
    cfg, _, info, _ = _cli_epoch(tmp, MEDMNIST["jnf_sbound"], **MEDMNIST_JNF_RUN)
    expected = _jnf_expected(info)
    emit({"phase": "medmnist_jnf_slice", "config": "jnf_sbound.json", "latent_dim": cfg.latent_dim,
          "s_bound_flow": cfg.s_bound_flow, "clip_grad_norm": cfg.clip_grad_norm,
          "expected_launches_by_epoch": expected, **info})
    if cfg.s_bound_flow != 8.0 or cfg.latent_dim != 16:
        raise AssertionError(f"jnf_sbound.json: s_bound {cfg.s_bound_flow}, "
                             f"latent {cfg.latent_dim}")
    launches["medmnist_jnf"] = _check_run("medmnist JNF", info, expected)
    run = info["run_path"]
    nb = len(reload_model(run, 500, "cuda")[2][1])
    ok, res = _validate_counted(run, exp, (4 * (2 * nb + 1), 0), MS_VALIDATE_KEYS)
    res.pop("marks")
    emit({"phase": "medmnist_validate", "test_batches": nb, **res, "ok": ok})
    if not ok:
        raise AssertionError(f"medmnist validate: {res}")
    launches["validate_medmnist_jnf"] = tuple(res["launches"])
    launches["likelihoods_medmnist_jnf"] = _likelihood_batch(run, "medmnist")

    for name in ("mmvae", "mvae"):
        cfg, _, info, _ = _cli_epoch(tmp, MEDMNIST[name], **MEDMNIST_FEW_STEPS)
        emit({"phase": f"medmnist_{name}_slice", "model": cfg.model, "K": cfg.K,
              "posterior": cfg.dist, **info})
        launches[f"medmnist_{name}"] = _check_run(f"medmnist {name}", info, [(0, 0)])

    path, lines, got, wall = _counted(dcca_main, [
        "--dataset", "medmnist", "--device", "cuda", "--epochs", "2", "--batch-size",
        str(DCCA_BATCH), "--synthetic-n", str(MEDMNIST_JNF_RUN["synthetic_n"]), "--data-path",
        os.path.join(tmp, "data"), "--out", os.path.join(tmp, "dcca")])
    emit({"phase": "medmnist_dcca", "trunks": "dcca_encoders_medmnist", "launches": list(got),
          "epochs": [l for l in lines if l.startswith("DCCA epoch")], "cli_wall_s": wall})
    if got != (0, 0):
        raise AssertionError(f"medmnist DCCA launched {got}")
    launches["dcca_medmnist"] = got
    cfg, _, info, epochs = _cli_epoch(tmp, MEDMNIST["jmvae_nf_dcca"], dcca_path=path,
                                      **MEDMNIST_JNF_RUN)
    bundle = registry.build(cfg)
    bundle.model.load_state_dict(torch.load(os.path.join(info["run_path"], "model.pt"),
                                            weights_only=True))
    off, compared = _trunks_off_artifact(bundle.model, path)
    emit({"phase": "medmnist_jnf_dcca_slice", "dcca": cfg.dcca, "no_recon": cfg.no_recon,
          "trunk_leaves_compared": compared, "trunk_leaves_off_artifact": off, **info})
    if off or not compared or not cfg.dcca:
        raise AssertionError(f"medmnist JNF-DCCA: {off[:5]} of {compared} off the artifact")
    launches["medmnist_jnf_dcca"] = _check_run("medmnist JNF-DCCA", info, [(0, 0), (0, 0)])

    cfg, _, info, epochs = _cli_epoch(tmp, CHEST)
    bundle = registry.build(cfg)
    fresh = Trainer(bundle.model, bundle.spec, cfg, device="cuda")
    fresh.init_parameters()  # the run's start: the Trainer draws it from the config's seed
    start = dict(fresh.model.named_parameters())
    # nothing frozen in either phase; the epoch moves the joint encoder's
    # trunk and both decoders (the unimodal encoders' KL weight is 0 in the
    # linear warmup's first epoch)
    frozen = {freezing.frozen_prefixes_for_phase(fresh.obj_name, past, cfg.fix_jencoder,
                                                 cfg.fix_decoders) for past in (False, True)}
    trained = [n for n in start if n.startswith("joint_encoder.Linear") or ".decoder." in n]
    unmoved = [n for n in trained if torch.equal(epochs[-1]["params"][n], start[n].detach())]
    emit({"phase": "chest_svhn_slice", "linear_warmup": cfg.linear_warmup, "no_nf": cfg.no_nf,
          "frozen_prefixes": sorted(frozen), "trained_leaves": len(trained),
          "trained_leaves_unmoved": unmoved, **info})
    if unmoved or not trained or frozen != {("first_encoder",)} or not cfg.linear_warmup:
        raise AssertionError(f"chest-SVHN: unmoved {unmoved[:5]}, frozen {frozen}, "
                             f"linear_warmup {cfg.linear_warmup}")
    launches["chest_svhn_jnf"] = _check_run("chest-SVHN", info, [(0, 0)])
    return launches


def phase_celeba_slice(tmp):
    """CelebA (ResNet image at 64x64 <-> 40 Bernoulli attributes) through
    the CLIs on cuda at full width: jmvae_nf.json (latent 64, B=128, both
    kernels at D = 64) for 2 epochs with warmup 2, its launches as
    `_jnf_expected` counts them; `validate --repeats 1` with the attribute
    metrics (the per-batch loop, 4 forward launches per conditional
    sampling call) and one likelihood batch of CELEBA_LL_ROWS rows;
    mmvae_nf.json's steady step at K=30, B=256 (the forward kernel at
    7,680 rows; 4 forward and 4 backward launches a step); one epoch each of
    mvae.json and moepoe.json, no launch."""
    import torch

    from mmvae_tpu_torch.cli.common import reload_model
    from mmvae_tpu_torch.core.config import ExperimentConfig
    from mmvae_tpu_torch.models import registry
    from mmvae_tpu_torch.ops import ar_flow
    from mmvae_tpu_torch.train import Trainer

    exp = os.path.join(tmp, "experiments")
    launches = {}
    cfg, _, info, _ = _cli_epoch(tmp, CELEBA["jmvae_nf"], **JNF_RUN)
    expected = _jnf_expected(info)
    emit({"phase": "celeba_jnf_slice", "latent_dim": cfg.latent_dim,
          "recon_losses": cfg.recon_losses, "expected_launches_by_epoch": expected, **info})
    launches["celeba_jnf"] = _check_run("celeba JNF", info, expected)
    run = info["run_path"]
    nb = len(reload_model(run, 500, "cuda")[2][1])
    ok, res = _validate_counted(run, exp, (4 * (2 * nb + 1), 0), CELEBA_VALIDATE_KEYS)
    res.pop("marks")
    ok = ok and all(0.0 <= res["metrics"][k] <= 1.0 for k in ("accuracy1", "accuracy2"))
    emit({"phase": "celeba_validate", "test_batches": nb, **res, "ok": ok})
    if not ok:
        raise AssertionError(f"celeba validate: {res}")
    launches["validate_celeba_jnf"] = tuple(res["launches"])
    launches["likelihoods_celeba_jnf"] = _likelihood_batch(run, "celeba", CELEBA_LL_ROWS)

    # MMVAE-NF's steady step at its published K=30, B=256
    cfg_path, _ = _slice_config(tmp, CELEBA["mmvae_nf"])
    cfg = ExperimentConfig.from_json(cfg_path)
    train_loader = _data_loaders(cfg)[0]
    bundle = registry.build(cfg)
    trainer = Trainer(bundle.model, bundle.spec, cfg, device="cuda")
    trainer.init_parameters()
    trainer.init_opt_state(past_warmup=True, amsgrad=True)  # warmup 0: AMSGrad throughout
    pipeline = trainer.make_device_pipeline(train_loader)
    batches = [pipeline.gather(torch.from_numpy(r).cuda())
               for r in list(pipeline.epoch_index_batches())[:5]]
    for xs in batches[:2]:
        trainer.train_step(xs, cfg.learning_rate)
    torch.cuda.synchronize()
    ar_flow.ar_solve.launches = ar_flow.ar_solve.backward_launches = 0
    t0 = time.perf_counter()
    for xs in batches[2:]:
        loss, _ = trainer.train_step(xs, cfg.learning_rate)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / len(batches[2:])
    got = (ar_flow.ar_solve.launches, ar_flow.ar_solve.backward_launches)
    want = (4 * len(batches[2:]), 4 * len(batches[2:]))
    emit({"phase": "celeba_mmvae_nf_step", "K": cfg.K, "batch": cfg.batch_size,
          "solve_rows": cfg.K * cfg.batch_size, "train_step_ms": step_s * 1e3,
          "steps_timed": len(batches[2:]), "launches": list(got), "expected_launches": list(want),
          "loss": loss.item()})
    if got != want or not math.isfinite(loss.item()):
        raise AssertionError(f"celeba MMVAE-NF: launches {got} (expected {want}), loss {loss}")
    launches["celeba_mmvae_nf_steps"] = got

    for name in ("mvae", "moepoe"):
        cfg, _, info, _ = _cli_epoch(tmp, CELEBA[name])
        emit({"phase": f"celeba_{name}_slice", "model": cfg.model, "K": cfg.K,
              "lik_scaling": list(registry.build(cfg).spec.lik_scaling), **info})
        launches[f"celeba_{name}"] = _check_run(f"celeba {name}", info, [(0, 0)])
    return launches


def phase_resnet_parity(tmp):
    """A post-warmup JMVAE-NF step of MedMNIST (jnf_sbound.json: latent 16,
    s_bound 8) and of CelebA (jmvae_nf.json: latent 64) at B=32 on cuda in float32
    against the float64 CPU step (frozen joint forward, unimodal
    reconstructions on; noise: the joint forward's, compute_kld's joint
    sample, each unimodal forward), the reference on the cuda step's ReLU
    branches, the kernels' included: at D = 16 and 64 over 128 rows the
    solves evaluate millions of hidden ReLUs, and one whose pre-activation
    lies within float32 round-off of 0 flips (one moved a MADE kernel's
    gradient by 1.5e-4 of its largest entry on an H100)."""
    for name, config, run in (("medmnist", MEDMNIST["jnf_sbound"], MEDMNIST_JNF_RUN),
                              ("celeba", CELEBA["jmvae_nf"], JNF_RUN)):
        _step_parity(tmp, config, 4, f"{name}_jnf_parity", dict(run, **RESNET_PARITY_B),
                     align_relu=True, frozen_joint=True, no_recon=False)


# trimodal MNIST-SVHN-Fashion: its published configs at full width, at a
# quarter of the loader's default synthetic scale, cut for time (synthetic_n
# 1,024: 4,370 train triples, 1,070 test, 485 val; the default 4,096 gives
# 17,874, 4,690, 1,986)
MSF = {name: os.path.join(ROOT, "configs", "msf", f"{name}.json")
       for name in ("jmvae_nf", "jmvae_nf_dcca", "telbo_nf", "mmvae", "mvae")}
MSF_SCALE = dict(synthetic_n=1024)
MSF_JNF_RUN = dict(JNF_RUN, **MSF_SCALE)
# TELBO-NF: one epoch, past its warmup from the first (published 200, 100)
MSF_TELBO_RUN = dict(MSF_SCALE, epochs=1, warmup=1, skip_warmup=False)
# MMVAE and MVAE "a few steps": 707 train triples, 5 steps
MSF_FEW_STEPS = dict(synthetic_n=192)
MSF_MCMC_STEPS = 100
MSF_DCCA_EPOCHS = 2
# 3 modalities x 2 MAF blocks: the forward launches of one unimodal pass
# over the three flows (a train step's compute_kld, a val batch, a
# conditional sampling call)
MSF_LAUNCHES = 6
_MSF_PAIRS = [(i, j) for i in range(3) for j in range(3) if i != j]
MSF_VALIDATE_KEYS = sorted([f"acc_{i}_{j}" for i, j in _MSF_PAIRS] + ["joint_coherence"]
                           + [f"fid_{i}_{j}" for i, j in _MSF_PAIRS])
MSF_POE_KEYS = [f"cond_acc_{m}" for m in range(3)]
MSF_HMC_KEYS = [f"hmc_acc_rate_{m}" for m in range(3)]


def _msf_validate(run, exp, name, poe=None):
    """validate --mcmc-steps MSF_MCMC_STEPS on a trimodal run: the 6
    cross-coherences, the three-way joint coherence, the 6 FIDs, and for a
    model with a product of experts the PoE-subset accuracies (`poe`
    "analytic" for MVAE, "hmc" for JMVAE-NF, with HMC's acceptance rates).
    Launches: for a flow model 6 per conditional
    sampling call, one call per test batch for the coherence and one for
    the FID, and HMC's start over 3 subsets of 2 experts (2 x 2 each); no
    grids (they are two-modality)."""
    from mmvae_tpu_torch.cli.common import reload_model

    nb = len(reload_model(run, 500, "cuda")[2][1])
    hmc = poe == "hmc"
    keys = sorted(MSF_VALIDATE_KEYS + (MSF_POE_KEYS if poe else []) + (MSF_HMC_KEYS if hmc else []))
    expected = (MSF_LAUNCHES * 2 * nb + 3 * 2 * 2, 0) if hmc else (0, 0)
    ok, res = _validate_counted(run, exp, expected, keys,
                                ["--mcmc-steps", str(MSF_MCMC_STEPS)])
    marks = res.pop("marks")
    if hmc:
        res["poe_subsets_s"] = marks["repeat 0: accuracies done"] - \
            marks["repeat 0: coherence done"]
    emit({"phase": f"{name}_validate", "test_batches": nb, "mcmc_steps": MSF_MCMC_STEPS,
          **res, "ok": ok})
    if not ok:
        raise AssertionError(f"{name} validate: {res}")
    return tuple(res["launches"])


def phase_msf_slice(tmp):
    """Trimodal MNIST-SVHN-Fashion through the CLIs on cuda at full width
    (MLP MNIST and Fashion nets, the SVHN conv nets; B=128, latent 20) at
    a quarter of the loader's default scale (MSF_SCALE). jmvae_nf.json (a MultipleHeadJoint over
    three 20-wide heads, 2 MAF blocks of 3x128 per modality) for 2 epochs
    with warmup 2 and its epoch-1 analytics (the 3x3 cond_samples grids
    and generate_001.png): epoch 1 launches only its grids' 6; epoch 2 6
    forward per train step and val batch (compute_kld's three unimodal VAE
    forwards) and 6 backward per train step; its steady post-warmup step;
    `validate --mcmc-steps 100` (HMC over each 2-subset's product of flow
    posteriors) and one `compute_likelihoods --bis` test batch of SLICE_LL_ROWS
    (cond_lw_subset_m). `dcca_train --dataset mnist_svhn_fashion` (three
    views, pairwise mcca loss) and jmvae_nf_dcca.json (latent 30, B=256,
    no_recon: no launch in training) grafting its three trunks behind the
    identity projection; its validate and likelihood batch run the forward
    kernel at D = 30. telbo_nf.json (latent 30, B=256) one epoch past its
    warmup: the three unimodal VAE forwards under autograd, both kernels
    at D = 30. mmvae.json and mvae.json (subset subsampling) a few steps
    each and validate, no launch."""
    import torch

    from mmvae_tpu_torch.cli.dcca_train import main as dcca_main
    from mmvae_tpu_torch.models import registry

    exp = os.path.join(tmp, "experiments")
    launches = {}
    cfg, train_loader, info, _ = _cli_epoch(tmp, MSF["jmvae_nf"], analytics=True, **MSF_JNF_RUN)
    steps, val_b = info["train_steps"], info["val_batches"]
    expected = [(MSF_LAUNCHES, 0), (MSF_LAUNCHES * (1 + steps + val_b), MSF_LAUNCHES * steps)]
    grids = [f"cond_samples_{r}x{o}_001.png" for r in range(3) for o in range(3)] + \
        ["generate_001.png"]
    sizes = {g: _png_ok(os.path.join(info["run_path"], g)) for g in grids}
    emit({"phase": "msf_jnf_slice", "config": "msf/jmvae_nf.json", "latent_dim": cfg.latent_dim,
          "batch_size": cfg.batch_size, "expected_launches_by_epoch": expected,
          "analytics_grids": sizes, **info})
    if info["callback_launches_by_epoch"] != [MSF_LAUNCHES, 0]:
        raise AssertionError(f"msf JNF analytics: {info['callback_launches_by_epoch']}")
    launches["msf_jnf"] = _check_run("msf JNF", info, expected)
    _, _, step_s, eval_ms, prof = _steady_steps(cfg, train_loader, epoch=2)
    emit({"phase": "msf_jnf_slice_time", "epoch": 2, "train_step_ms": step_s * 1e3,
          "eval_batch_ms": eval_ms, **prof})
    run = info["run_path"]
    launches["validate_msf_jnf"] = _msf_validate(run, exp, "msf_jnf", "hmc")
    launches["likelihoods_msf_jnf"] = _likelihood_batch(run, "msf_jnf", n_mod=3)

    path, lines, got, wall = _counted(dcca_main, [
        "--dataset", "mnist_svhn_fashion", "--device", "cuda", "--epochs", str(MSF_DCCA_EPOCHS),
        "--batch-size", str(DCCA_BATCH), "--data-path", os.path.join(tmp, "data"),
        "--out", os.path.join(tmp, "dcca")])
    emit({"phase": "msf_dcca", "trunks": "dcca_encoders_msf", "launches": list(got),
          "epochs": [l for l in lines if l.startswith("DCCA epoch")], "cli_wall_s": wall})
    if got != (0, 0):
        raise AssertionError(f"msf DCCA launched {got}")
    launches["dcca_msf"] = got
    cfg, _, info, _ = _cli_epoch(tmp, MSF["jmvae_nf_dcca"], dcca_path=path, **MSF_JNF_RUN)
    bundle = registry.build(cfg)
    bundle.model.load_state_dict(torch.load(os.path.join(info["run_path"], "model.pt"),
                                            weights_only=True))
    off, compared = _trunks_off_artifact(bundle.model, path)
    emit({"phase": "msf_jnf_dcca_slice", "dcca": cfg.dcca, "no_recon": cfg.no_recon,
          "latent_dim": cfg.latent_dim, "batch_size": cfg.batch_size,
          "trunk_leaves_compared": compared, "trunk_leaves_off_artifact": off, **info})
    # the MLP trunks' 6 leaves, the conv trunk's 10, and each identity projection's m and w
    if off or compared != 6 + 10 + 6 + 3 * 2 or cfg.latent_dim != 30:
        raise AssertionError(f"msf JNF-DCCA: {off[:5]} of {compared} off the artifact")
    launches["msf_jnf_dcca"] = _check_run("msf JNF-DCCA", info, [(0, 0), (0, 0)])
    run = info["run_path"]
    launches["validate_msf_jnf_dcca"] = _msf_validate(run, exp, "msf_jnf_dcca", "hmc")
    launches["likelihoods_msf_jnf_dcca"] = _likelihood_batch(run, "msf_jnf_dcca", n_mod=3)

    cfg, _, info, _ = _cli_epoch(tmp, MSF["telbo_nf"], **MSF_TELBO_RUN)
    steps, val_b = info["train_steps"], info["val_batches"]
    expected = [(MSF_LAUNCHES * (steps + val_b), MSF_LAUNCHES * steps)]
    emit({"phase": "msf_telbo_nf_slice", "latent_dim": cfg.latent_dim,
          "batch_size": cfg.batch_size, "warmup": cfg.warmup,
          "expected_launches_by_epoch": expected, **info})
    if cfg.latent_dim != 30:
        raise AssertionError(f"msf TELBO-NF at latent {cfg.latent_dim}")
    launches["msf_telbo_nf"] = _check_run("msf TELBO-NF", info, expected)

    for name in ("mmvae", "mvae"):
        cfg, _, info, _ = _cli_epoch(tmp, MSF[name], **MSF_FEW_STEPS)
        emit({"phase": f"msf_{name}_slice", "model": cfg.model, "K": cfg.K,
              "posterior": cfg.dist, **info})
        launches[f"msf_{name}"] = _check_run(f"msf {name}", info, [(0, 0)])
        launches[f"validate_msf_{name}"] = _msf_validate(
            info["run_path"], exp, f"msf_{name}", "analytic" if name == "mvae" else None)
    return launches


def phase_msf_parity(tmp):
    """A post-warmup trimodal JMVAE-NF step (jmvae_nf.json: frozen joint
    forward, the three unimodal reconstructions on) on cuda in float32
    against the float64 CPU step, on the cuda step's ReLU branches, the
    flow kernels' included; noise: the joint forward's, compute_kld's joint
    sample, each unimodal forward."""
    _step_parity(tmp, MSF["jmvae_nf"], 5, "msf_parity", dict(JNF_RUN, synthetic_n=512),
                 align_relu=True, frozen_joint=True, no_recon=False)


# slice 11: the objectives and flows that no config selects, on
# configs/mnist_svhn/jmvae_nf.json at full width with one key changed (the
# MNIST-SVHN stand-in at synthetic_n 2,048, as the other MNIST-SVHN paths)
IAF_RUN = dict(JNF_RUN, flow="iaf", experiment="jmvae_nf_iaf/mnist_svhn")
TAIL_OBJECTIVES = ("jmvae", "vaevae_kl", "vaevae_w2", "svae", "multi_elbos", "telbo")
# forward (and as many backward) launches per train step: each VAE's
# forward samples through its 2 MAF blocks under autograd (2 modalities);
# m_jmvae runs the unimodal encoders alone
TAIL_LAUNCHES = {obj: 0 if obj == "jmvae" else 4 for obj in TAIL_OBJECTIVES}
TAIL_WARM, TAIL_TIMED = 2, 5
# the unimodal DReG step's draw: K=30 samples of B=128 rows at latent 20
DREG_PARITY_DRAW = (30, 128, 20)


def _counted_steps(cfg, train_loader, epoch=1):
    """TAIL_WARM + TAIL_TIMED train steps of `cfg` through the port's
    Trainer on cuda at `epoch` (with the optimizer the Trainer runs there),
    the ar_solve counts set to 0 just before the first and read just after
    the last: the host ms of a timed step, the launches and those at sign
    -1, finite losses, the skipped steps, and the joint encoder's
    parameters that moved (of how many)."""
    import torch

    from mmvae_tpu_torch.ops import ar_flow

    trainer, batches = _trainer_batches(cfg, train_loader, epoch, TAIL_WARM + TAIL_TIMED)
    joint = {n: p.detach().clone() for n, p in trainer.model.named_parameters()
             if n.startswith("joint_encoder")}
    losses, skipped = [], 0.0
    torch.cuda.synchronize()
    _reset_counts()
    for i, xs in enumerate(batches):
        if i == TAIL_WARM:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        loss, details = trainer.train_step(xs, cfg.learning_rate, epoch=epoch)
        losses.append(loss)
        skipped += float(details["nan_skipped"])
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / TAIL_TIMED
    a, named = ar_flow.ar_solve, dict(trainer.model.named_parameters())
    return dict(objective=trainer.obj_name, steps=len(batches), train_step_ms=step_s * 1e3,
                launches=(a.launches, a.backward_launches),
                sign_minus=(a.sign_minus_launches, a.sign_minus_backward_launches),
                losses_finite=all(bool(torch.isfinite(l)) for l in losses), skipped=skipped,
                joint_params=len(joint),
                joint_moved=[n for n, p in joint.items() if not torch.equal(p, named[n])])


def phase_iaf_slice(tmp):
    """jmvae_nf.json with "flow": "iaf" (latent 20, B=128, 2 IAF blocks of
    3x128 per modality) through the CLI for 2 epochs, warmup 2, with its
    epoch-1 analytics (`_frozen_slice` at sign -1): IAF samples in
    parallel, so its grids and the warmup epoch launch nothing; past warmup
    compute_kld's flow density (IAF.forward, the sequential solve at sign
    -1) launches 4 forward kernels per train step and val batch and 4
    backward per train step. Its steady post-warmup step; validate and one
    likelihood batch, which sample through IAF's parallel direction and
    launch nothing. Returns (launches by path, those at sign -1)."""
    from mmvae_tpu_torch.core.config import ExperimentConfig

    loader, out = _frozen_slice(tmp, JNF, "iaf_slice", "m_jmvae_nf", analytics=True, sign=-1,
                                flow="iaf", experiment=IAF_RUN["experiment"])
    cfg = ExperimentConfig.from_json(_slice_config(tmp, JNF, **IAF_RUN)[0])
    _, _, step_s, eval_ms, prof = _steady_steps(cfg, loader, epoch=cfg.warmup)
    emit({"phase": "iaf_slice_time", "epoch": cfg.warmup, "train_step_ms": step_s * 1e3,
          "steps_per_s": 1.0 / step_s, "eval_batch_ms": eval_ms, **prof})
    ok, info = _validate_counted(out["run_path"], os.path.join(tmp, "experiments"), (0, 0),
                                 MS_VALIDATE_KEYS)
    emit({"phase": "iaf_validate", **info, "ok": ok})
    if not ok:
        raise AssertionError(f"validate on the IAF run: {info}")
    lik = _likelihood_batch(out["run_path"], "iaf", sequential_sampling=False)
    return ({"iaf": (out["launches"], out["bwd_launches"]), "validate_iaf": (0, 0),
             "likelihoods_iaf": lik}, {"iaf": out["sign_minus"]})


def phase_tail_slice(tmp):
    """The six multimodal objectives that no config selects, each on
    jmvae_nf.json (2 MAF blocks of 3x128 per modality) with its "obj", past
    warmup (warmup 0: JAX's past_warmup is epoch >= warmup), for a few
    train steps through the Trainer on cuda (`_counted_steps`): per step
    TAIL_LAUNCHES forward and as many backward kernels, at sign +1; finite
    losses, no skipped step; the joint encoder bit-unchanged under m_jmvae
    (frozen past warmup) and m_vaevae_* (never reached: zero gradients),
    moved under the others. Returns (launches by path, those at sign -1,
    the train loader)."""
    from mmvae_tpu_torch.core.config import ExperimentConfig

    loader, out, minus = None, {}, {}
    for obj in TAIL_OBJECTIVES:
        cfg = ExperimentConfig.from_json(
            _slice_config(tmp, JNF, obj=obj, warmup=0, skip_warmup=False)[0])
        if loader is None:
            loader = _data_loaders(cfg)[0]
        r = _counted_steps(cfg, loader)
        expected = (TAIL_LAUNCHES[obj] * r["steps"],) * 2
        keeps_joint = obj == "jmvae" or obj.startswith("vaevae")
        ok = (r["launches"] == expected and r["sign_minus"] == (0, 0) and r["losses_finite"]
              and not r["skipped"] and r["joint_params"] > 0
              and (not r["joint_moved"]) == keeps_joint)
        emit({"phase": "tail_slice", **{k: v for k, v in r.items() if k != "joint_moved"},
              "expected_launches": list(expected), "joint_params_moved": len(r["joint_moved"]),
              "joint_kept": keeps_joint, "ok": ok})
        if not ok:
            raise AssertionError(f"tail_slice m_{obj}: {r}, expected launches {expected}")
        out[f"tail_{obj}"], minus[f"tail_{obj}"] = r["launches"], r["sign_minus"]
    return out, minus, loader


def phase_linnf_slice(tmp, loader):
    """"flow": "lin_nf" (a LinearNF of planar, radial, planar per VAE) on
    mmvae_nf_synth.json and on jmvae_nf.json past warmup (warmup 0:
    compute_kld takes its density stand-in, the same map), a few train
    steps each through the Trainer on cuda: no ar_solve launch, that 0
    checked; finite losses, no skipped step."""
    from mmvae_tpu_torch.core.config import ExperimentConfig
    from mmvae_tpu_torch.flows import LinearNF
    from mmvae_tpu_torch.models import registry

    out = {}
    for name, config in (("mmvae_nf", CONFIG), ("jnf", JNF)):
        cfg = ExperimentConfig.from_json(
            _slice_config(tmp, config, flow="lin_nf", warmup=0, skip_warmup=False)[0])
        flows = [type(v.flow) for v in registry.build(cfg).model.vaes]
        r = _counted_steps(cfg, loader)
        ok = (r["launches"] == (0, 0) and r["losses_finite"] and not r["skipped"]
              and flows == [LinearNF] * 2)
        emit({"phase": "linnf_slice", "config": os.path.basename(config),
              **{k: v for k, v in r.items() if k != "joint_moved"},
              "expected_launches": [0, 0], "flows": [f.__name__ for f in flows], "ok": ok})
        if not ok:
            raise AssertionError(f"linnf_slice {name}: {r}, flows {flows}")
        out[f"linnf_{name}"] = r["launches"]
    return out


def phase_tail_parity(tmp):
    """Four steps on cuda in float32 against the float64 CPU step on the
    cuda step's ReLU branches, the flow kernels' included (`_step_parity`
    with align_relu): the post-warmup IAF JMVAE-NF step (both kernels at
    sign -1 under autograd; noise: the joint forward's, compute_kld's joint
    sample, each unimodal forward's); m_telbo (the joint forward's, each
    VAE's in unimodal_cross_forward) and m_vaevae_w2 (each VAE's) on
    jmvae_nf.json with its MAF flows; and the unimodal DReG step at K=30 on
    MMVAE-NF's MNIST VAE (MLP nets, 2 MAF blocks of 3x128: 3,840 rows
    through both kernels at sign +1, under the hook; one (30, 128, 20)
    draw). All four at STEP_OBJ_RTOL and STEP_GRAD_TOL."""
    _step_parity(tmp, JNF, 4, "iaf_parity", IAF_RUN, align_relu=True, frozen_joint=True,
                 no_recon=False)
    _step_parity(tmp, JNF, 3, "telbo_parity", dict(JNF_RUN, obj="telbo"), align_relu=True)
    _step_parity(tmp, JNF, 2, "vaevae_w2_parity", dict(JNF_RUN, obj="vaevae_w2"),
                 align_relu=True)
    _step_parity(tmp, CONFIG, [DREG_PARITY_DRAW], "dreg_parity", dict(obj="dreg", K=30),
                 align_relu=True, unimodal=0)


# data-parallel training: two ranks that share the one card over
# gloo, and the train CLI under torchrun
DDP_PARITY = (("mmvae_nf", CONFIG, {}, 2),
              ("jnf_mnist_fashion", JNF, dict(JNF_RUN, model="jnf_mnist_fashion", dcca=False,
                                              synthetic_n=1024), 4))
DDP_TRAIN_STEPS = 3
# forward and backward launches a step of each parity case, on every rank:
# MMVAE-NF's 2 modalities x 2 MAF blocks sample under autograd; JMVAE-NF's
# compute_kld runs each modality's 2 blocks past warmup
DDP_STEP_LAUNCHES = {"mmvae_nf": (4, 4), "jnf_mnist_fashion": (4, 4)}
DDP_RANKS = 2
DDP_SLICE_TIMEOUT = 300
# a collective that waits longer for another rank raises; a spawn of ranks
# still running after its deadline is killed and fails the phase
RANK_TIMEOUT_S = 120
SPAWN_DEADLINE_S = 300
# the new phases of the port's last slice
FID_RTOL, FID_ATOL = 1e-3, 1e-4  # tests/test_fid_parity.py's
REAL_LAYOUT_N = 512
# the crops `real_layout` decodes at once (load_celeba's chunk), and the
# count of CelebA's aligned crops its projection reaches
PNG_READ_N = 4096
CELEBA_CROPS = 202_599
PROBE_ROWS = 500
KSPLIT_MESHES = ((1, 2), (2, 2))
KSPLIT_GATHERS = 20
# (ranks, backend) of phase_ddp_slice: one rank over NCCL, two on the card
# over gloo ("" lets the CLI take NCCL)
DDP_SLICE_RUNS = ((1, ""), (DDP_RANKS, "gloo"))
# the steady data-parallel step after the epoch: steps timed after a warm-up
DDP_STEADY_WARM, DDP_STEADY_STEPS = 3, 10


def _ddp_case(tmp, name, config, overrides, n_noise):
    """The parity case `name`: its config cut as the smoke cuts it, the
    first train batch, `n_noise` standard-normal draws of (B, latent), the
    initial weights (JAX layout) and the step's epoch, past any warmup."""
    import numpy as np

    from mmvae_tpu_torch.bridge import export_jax_params
    from mmvae_tpu_torch.core.config import ExperimentConfig
    from mmvae_tpu_torch.models import registry
    from mmvae_tpu_torch.train import Trainer

    cfg_path, _ = _slice_config(tmp, config, **{"experiment": f"smoke/ddp_{name}", **overrides})
    cfg = ExperimentConfig.from_json(cfg_path)
    xs, _ = next(iter(_data_loaders(cfg)[0]))
    rng = np.random.default_rng(0)
    eps = [rng.standard_normal((cfg.batch_size, cfg.latent_dim)).astype(np.float32)
           for _ in range(n_noise)]
    bundle = registry.build(cfg)
    trainer = Trainer(bundle.model, bundle.spec, cfg, device="cpu")
    trainer.init_parameters()
    return dict(name=name, cfg=cfg_path, xs=[np.asarray(x) for x in xs], eps=eps,
                weights=export_jax_params(trainer.model), epoch=max(cfg.warmup, 1))


def _ddp_trainer(case, device, dtype, mesh=None):
    import torch

    from mmvae_tpu_torch.bridge import load_jax_params
    from mmvae_tpu_torch.core.config import ExperimentConfig
    from mmvae_tpu_torch.models import registry
    from mmvae_tpu_torch.train import Trainer

    cfg = ExperimentConfig.from_json(case["cfg"])
    bundle = registry.build(cfg)
    trainer = Trainer(bundle.model.to(dtype), bundle.spec, cfg, device=device, mesh=mesh)
    load_jax_params(trainer.model, case["weights"])
    # the optimizer the Trainer runs there: reset to Adam at a warmup's end
    trainer.init_opt_state(past_warmup=True, amsgrad=cfg.warmup == 0)
    xs = [torch.tensor(x).to(device, dtype) for x in case["xs"]]
    eps = [torch.tensor(e).to(device, dtype) for e in case["eps"]]
    return cfg, trainer, xs, eps


def _ddp_parity_rank(rank, store, world, job_path, out_dir, backend):
    """One rank of `phase_ddp_parity` (torch.multiprocessing's spawn): over
    gloo on cuda:0 beside the other ranks, or over NCCL on its own card
    cuda:rank; for each case its block's step
    with its rows of the noise, its ReLU branches recorded (the kernels'
    from their tapes), then DDP_TRAIN_STEPS train steps on the same block
    with its own noise. Each rank's ar_solve counts start at 0."""
    import datetime

    import torch

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from mmvae_tpu_torch.ops import ar_flow
    from mmvae_tpu_torch.parallel import make_mesh, shard_batch

    mesh = make_mesh(world, 1, device="cuda", backend=backend, init_method=f"file://{store}",
                     timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
    out = {}
    for case in torch.load(job_path, weights_only=False):
        cfg, trainer, xs, eps = _ddp_trainer(case, mesh.device, torch.float32, mesh)
        xs, block = shard_batch(mesh, xs)
        eps = [e[block.start:block.stop] for e in eps]
        _reset_counts()
        relu = _ReluBranches()
        with relu, _SolveBranches(relu):
            loss, _, grads, finite = trainer.loss_and_grads(xs, epoch=case["epoch"], noise=eps,
                                                            block=block)
        torch.cuda.synchronize()
        step = (ar_flow.ar_solve.launches, ar_flow.ar_solve.backward_launches)
        for _ in range(DDP_TRAIN_STEPS):
            trainer.train_step(xs, cfg.learning_rate, epoch=case["epoch"], block=block)
        torch.cuda.synchronize()
        out[case["name"]] = dict(
            loss=loss.item(), finite=bool(finite), grads=[g.cpu() for g in grads],
            masks=relu.masks, step_launches=step, device=str(mesh.device),
            launches=(ar_flow.ar_solve.launches, ar_flow.ar_solve.backward_launches),
            params=[p.detach().cpu() for p in trainer.model.parameters()],
            skipped=trainer.opt.count.item() != DDP_TRAIN_STEPS)
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


def _start_ranks(fn, args, nprocs, store_dir):
    """torch.multiprocessing's spawn of `nprocs` ranks, fn(rank, store, *args),
    the ranks meeting at a new file store in `store_dir` (no TCP port to
    collide on), not joined: `_join_ranks`."""
    import torch.multiprocessing as mp

    store = os.path.join(store_dir, f"store_{time.monotonic_ns()}")
    return mp.spawn(fn, args=(store, *args), nprocs=nprocs, join=False)


def _join_ranks(context, deadline=SPAWN_DEADLINE_S):
    """Wait for `_start_ranks`' ranks: they are killed, and the phase fails
    with their exit codes, once `deadline` seconds pass. A rank that raises
    fails it at once (spawn then ends the others)."""
    nprocs = len(context.processes)
    end = time.monotonic() + deadline
    while not context.join(timeout=max(0.0, min(5.0, end - time.monotonic()))):
        if time.monotonic() >= end:
            for p in context.processes:
                if p.is_alive():
                    p.kill()
            for p in context.processes:
                p.join(10)
            raise AssertionError(f"{nprocs} ranks still running after {deadline} s; exit "
                                 f"codes {[p.exitcode for p in context.processes]}")


def phase_ddp_parity(tmp, specs=DDP_PARITY, ranks=DDP_RANKS, backend="gloo"):
    """Data-parallel steps on the card: two ranks on cuda:0 over gloo
    (`_ddp_parity_rank`; or `ranks` over NCCL, one card each) against one
    process, for an MMVAE-NF step
    (mmvae_nf_synth.json) and a post-warmup JMVAE-NF step on
    jnf_mnist_fashion (BatchNorm over the global batch), both kernels
    on every rank at 64 rows, the same noise cut by rows. Checks: the
    ranks' objectives summed against the one-process objective on the card
    (STEP_OBJ_RTOL); the ranks' all-reduced gradients bitwise equal, and
    within STEP_GRAD_TOL of each leaf's largest entry of the float64 CPU
    step on the ranks' ReLU branches (their masks concatenated by rows,
    each flipped element within RELU_KINK_ATOL of 0); each rank's launches
    as predicted; the parameters
    bitwise equal on both ranks after DDP_TRAIN_STEPS steps; the one-process
    step against the float64 step on its own branches, and the elements
    whose branch differs between the two card runs. `specs`: the
    cases, (name, config, overrides, draws). Returns the launches by path
    and rank."""
    import torch

    from mmvae_tpu_torch.ops import ar_flow

    cases = [_ddp_case(tmp, name, config, overrides, n) for name, config, overrides, n in specs]
    job = os.path.join(tmp, "ddp_parity_job.pt")
    torch.save(cases, job)
    out_dir = os.path.join(tmp, "ddp_parity")
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    _join_ranks(_start_ranks(_ddp_parity_rank, (ranks, job, out_dir, backend), ranks, out_dir))
    ranks_s = time.perf_counter() - t0
    n_ranks, ranks = ranks, [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
                             for r in range(ranks)]
    launches = {}
    for case in cases:
        name = case["name"]
        per_rank = [r[name] for r in ranks]
        # one process on the card, the same weights, batch and noise
        _, trainer, xs, eps = _ddp_trainer(case, "cuda", torch.float32)
        _reset_counts()
        relu1 = _ReluBranches()
        with relu1, _SolveBranches(relu1):
            loss1, _, grads1, _ = trainer.loss_and_grads(xs, epoch=case["epoch"], noise=eps)
        torch.cuda.synchronize()
        one_launches = (ar_flow.ar_solve.launches, ar_flow.ar_solve.backward_launches)
        # the float64 CPU step on the two ranks' ReLU branches (their masks
        # concatenated by rows), and on the one process's
        replay = [torch.cat(ms) for ms in zip(*(r["masks"] for r in per_rank))]
        refs, rbs = [], []
        for masks in (replay, relu1.masks):
            _, ref_trainer, xs64, eps64 = _ddp_trainer(case, "cpu", torch.float64)
            with _ReluBranches(masks) as rb:
                loss64, _, grads64, _ = ref_trainer.loss_and_grads(xs64, epoch=case["epoch"],
                                                                   noise=eps64)
            refs.append({"obj": -loss64.item(), "loss": loss64.item(), "grads": grads64})
            rbs.append(rb)
        names = [n for n, _ in ref_trainer.model.named_parameters()]
        ddp = {"obj": -sum(r["loss"] for r in per_rank), "loss": sum(r["loss"] for r in per_rank),
               "grads": [g.double() for g in per_rank[0]["grads"]]}
        one = {"obj": -loss1.item(), "loss": loss1.item(),
               "grads": [g.double().cpu() for g in grads1]}
        scales = _leaf_scales(refs[0]["grads"], names)
        ddp_err = _step_errors(ddp, refs[0], names, scales)
        one_err = _step_errors(one, refs[1], names, scales)
        ddp_vs_one = _step_errors(ddp, one, names, scales)
        branches_apart = sum(int((a != b).sum()) for a, b in zip(replay, relu1.masks))
        same_grads = all(torch.equal(a, b) for r in per_rank[1:]
                         for a, b in zip(per_rank[0]["grads"], r["grads"]))
        same_params = all(torch.equal(a, b) for r in per_rank[1:]
                          for a, b in zip(per_rank[0]["params"], r["params"]))
        f, b = DDP_STEP_LAUNCHES[name]
        expected_step = (f, b)
        expected = (f * (1 + DDP_TRAIN_STEPS), b * (1 + DDP_TRAIN_STEPS))
        got = [tuple(r["launches"]) for r in per_rank]
        ok = (ddp_vs_one["objective_rel_err"] <= STEP_OBJ_RTOL
              and max(ddp_err["grad_max_rel_err"], one_err["grad_max_rel_err"]) <= STEP_GRAD_TOL
              and same_grads and same_params and len(replay) == len(relu1.masks)
              and all(len(rb.masks) == len(replay) and rb.flip_max_abs <= RELU_KINK_ATOL
                      for rb in rbs)
              and all(r["finite"] and not r["skipped"] for r in per_rank)
              and [tuple(r["step_launches"]) for r in per_rank] == [expected_step] * n_ranks
              and got == [expected] * n_ranks and one_launches == expected_step
              and [r["device"] for r in per_rank] == [
                  f"cuda:{0 if backend == 'gloo' else i}" for i in range(n_ranks)])
        emit({"phase": "ddp_parity", "case": name, "ranks": n_ranks, "backend": backend,
              "devices": [r["device"] for r in per_rank],
              "rows_per_rank": len(xs[0]) // n_ranks, "epoch": case["epoch"],
              "reference": "cpu float64 on each card run's own ReLU branches",
              "ddp_vs_ref": ddp_err, "one_process_cuda_vs_ref": one_err,
              "ddp_vs_one_process_cuda": ddp_vs_one, "grads_equal_on_ranks": same_grads,
              "params_equal_after_steps": same_params, "train_steps": DDP_TRAIN_STEPS,
              "relu_calls": len(replay), "relu_elements_apart_ranks_vs_one_process": branches_apart,
              "relu_elements_on_other_branch": [rb.flips for rb in rbs],
              "relu_other_branch_max_abs_preact": [rb.flip_max_abs for rb in rbs],
              "step_launches_by_rank": [r["step_launches"] for r in per_rank],
              "launches_by_rank": got, "expected_launches_by_rank": [expected] * n_ranks,
              "one_process_step_launches": one_launches, "ranks_wall_s": ranks_s,
              "objective_rtol": STEP_OBJ_RTOL, "grad_tol": STEP_GRAD_TOL, "ok": ok})
        if not ok:
            raise AssertionError(f"ddp_parity {name}: ranks against one process failed")
        for r, counts in enumerate(got):
            launches[f"ddp_parity_{name}_{backend}_rank{r}"] = counts
    return launches


def _ddp_rank_cli(cfg_path, exp_dir, out_json, backend):
    """`chip_smoke.py ddp-rank ...` under torchrun: this rank's train CLI
    epoch on cuda, its ar_solve launches counted from 0 (those of the
    analytics apart, by a probe before the CLI's callbacks), the train
    epoch's time a step, then the steady step on this rank's blocks and one
    all-reduce of the gradient's size timed, and the files this rank
    opened for writing; written to <out_json>.rank<r>."""
    import builtins

    import torch

    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from mmvae_tpu_torch.cli.train import main as train_main
    from mmvae_tpu_torch.ops import ar_flow
    from mmvae_tpu_torch.train import Trainer

    rank = int(os.environ["RANK"])
    counts, epoch_s, val_batches, trainers, pipelines = {}, [], [], [], []
    fit, run_epoch = Trainer.fit, Trainer.run_epoch_device
    run_val = Trainer.run_epoch_device_eval

    def before_callbacks(trainer, epoch, *args, **kwargs):
        torch.cuda.synchronize()
        counts["epoch"] = (ar_flow.ar_solve.launches, ar_flow.ar_solve.backward_launches)

    def fit_with_probe(self, *args, callbacks=None, **kwargs):
        trainers.append(self)
        return fit(self, *args, callbacks=[before_callbacks, *(callbacks or [])], **kwargs)

    def timed_epoch(self, pipeline, *args, **kwargs):
        pipelines.append(pipeline)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run_epoch(self, pipeline, *args, **kwargs)
        torch.cuda.synchronize()
        epoch_s.append((time.perf_counter() - t0, len(pipeline)))
        return out

    def counted_val(self, pipeline, *args, **kwargs):
        val_batches.append(len(pipeline))
        return run_val(self, pipeline, *args, **kwargs)

    writes = []
    opened = builtins.open

    def open_(file, mode="r", *args, **kwargs):
        if any(c in mode for c in "wax+"):
            writes.append(str(file))
        return opened(file, mode, *args, **kwargs)

    # the group outlives the CLI's run, for the all-reduce's timing below
    import torch.distributed as dist

    import datetime

    torch.cuda.set_device(int(os.environ["LOCAL_RANK"]) % torch.cuda.device_count())
    dist.init_process_group(backend or "nccl", timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
    Trainer.fit, Trainer.run_epoch_device = fit_with_probe, timed_epoch
    Trainer.run_epoch_device_eval = counted_val
    builtins.open = open_
    try:
        _reset_counts()
        t0 = time.perf_counter()
        argv = ["--config-path", cfg_path, "--experiments-dir", exp_dir, "--device", "cuda"]
        run_path = train_main(argv + (["--dist-backend", backend] if backend else []))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        builtins.open = opened
        Trainer.fit, Trainer.run_epoch_device = fit, run_epoch
        Trainer.run_epoch_device_eval = run_val
    total = (ar_flow.ar_solve.launches, ar_flow.ar_solve.backward_launches)
    # the steady train step on this rank's blocks, after the epoch
    trainer, pipeline = trainers[0], pipelines[0]
    block = trainer.mesh.block(pipeline.batch_size)
    batches = [pipeline.gather(torch.from_numpy(r).cuda())
               for r in list(pipeline.epoch_index_batches())[:DDP_STEADY_WARM + DDP_STEADY_STEPS]]
    for i, xs in enumerate(batches):
        if i == DDP_STEADY_WARM:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        trainer.train_step(xs, 1e-4, block=block)
    torch.cuda.synchronize()
    steady_ms = (time.perf_counter() - t0) / DDP_STEADY_STEPS * 1e3
    # one all-reduce of the step's flat gradient, as the Trainer makes it
    n = sum(p.numel() for p in trainer.model.parameters()) + 1
    flat = torch.ones(n, device="cuda")
    for _ in range(3):
        dist.all_reduce(flat)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        dist.all_reduce(flat)
    torch.cuda.synchronize()
    allreduce_ms = (time.perf_counter() - t0) / 20 * 1e3
    dist.destroy_process_group()
    (train_s, steps), = epoch_s
    with open(f"{out_json}.rank{rank}", "w") as f:
        json.dump({"rank": rank, "run_path": run_path, "epoch_launches": counts["epoch"],
                   "launches": total, "analytics_launches": total[0] - counts["epoch"][0],
                   "train_steps": steps, "val_batches": val_batches[0],
                   "epoch_ms_per_step": train_s / steps * 1e3, "steady_step_ms": steady_ms,
                   "wall_s_incl_setup": wall, "allreduce_ms": allreduce_ms,
                   "allreduce_floats": n, "files_written": writes,
                   "device": str(trainer.device)}, f)


def phase_ddp_slice(tmp, runs=DDP_SLICE_RUNS):
    """The train CLI under `torchrun --standalone` on mmvae_nf_synth.json at
    the smoke's scale, 1 epoch with its analytics: one rank (NCCL, a world
    of 1, the flat all-reduce a no-op) and two ranks on cuda:0 with
    mesh_data 2 over gloo, each rank through `chip_smoke.py ddp-rank`.
    Launches from the code, each rank's: 4 x (68 + 7) forward and 4 x 68
    backward at 128 rows a launch for one rank and 64 for two (the val
    pipeline shards too); rank 0's epoch-1 grids 4 more, the other rank
    none. Rank 0 writes the run dir (args, metrics, losses, checkpoint,
    grids), the other ranks open no file for writing. Each rank's epoch
    time a step and steady step (DDP_STEADY_STEPS after the epoch, on its
    blocks of the next batches; their launches come after the counts),
    beside the one-rank ones, and one all-reduce of the gradient's size.
    Returns the launches by path and rank."""
    results = {}
    for ranks, backend in runs:
        cfg_path, _ = _slice_config(tmp, CONFIG, analytics=True, mesh_data=ranks,
                                    experiment=f"smoke/ddp_slice_{ranks}")
        exp = os.path.join(tmp, f"ddp_slice_{ranks}")
        out_json = os.path.join(tmp, f"ddp_slice_{ranks}.json")
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               f"--nproc_per_node={ranks}", os.path.join(ROOT, "chip_smoke.py"), "ddp-rank",
               cfg_path, exp, out_json, backend]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=DDP_SLICE_TIMEOUT)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"torchrun with {ranks} rank(s) exited {proc.returncode}:\n"
                                 f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        per_rank = []
        for r in range(ranks):
            with open(f"{out_json}.rank{r}") as f:
                per_rank.append(json.load(f))
        run = per_rank[0]["run_path"]
        files = sorted(os.listdir(run))
        runs_made = [d for d, _, fs in os.walk(exp) if "args.json" in fs]
        with open(os.path.join(run, "losses.json")) as f:
            losses = json.load(f)
        steps, val_b = per_rank[0]["train_steps"], per_rank[0]["val_batches"]
        devices = [p["device"] for p in per_rank]
        expected = [(4 * (steps + val_b) + (4 if r == 0 else 0), 4 * steps) for r in range(ranks)]
        got = [tuple(p["launches"]) for p in per_rank]
        ok = (got == expected and (steps, val_b) == (68, 7) and runs_made == [run]
              and all(p["run_path"] == run for p in per_rank)
              and {"args.json", "losses.json", "metrics.jsonl", "model.pt",
                   "generate_001.png"} <= set(files)
              and all(not p["files_written"] for p in per_rank[1:])
              and devices == [f"cuda:{0 if backend == 'gloo' else r}" for r in range(ranks)]
              and all(math.isfinite(v) for v in losses["train_loss"] + losses["test_loss"]))
        emit({"phase": "ddp_slice", "ranks": ranks, "backend": backend or "nccl",
              "mesh_data": ranks, "rows_per_launch": 128 // ranks, "torchrun_wall_s": wall,
              "expected_launches_by_rank": expected, "launches_by_rank": got,
              "run_files": files, "losses": losses,
              **{k: [p[k] for p in per_rank] for k in
                 ("analytics_launches", "epoch_ms_per_step", "steady_step_ms",
                  "wall_s_incl_setup", "allreduce_ms",
                  "allreduce_floats", "device")},
              "files_written_by_rank": [len(p["files_written"]) for p in per_rank], "ok": ok})
        if not ok:
            raise AssertionError(f"ddp_slice with {ranks} rank(s): launches {got} (expected "
                                 f"{expected}), run dirs {runs_made}, files {files}")
        for r, counts in enumerate(got):
            results[f"ddp_slice_{ranks}_{backend or 'nccl'}_rank{r}"] = counts
    return results


def _inception_timer(made):
    """A wrapper of eval.fid's `made` (make_inception_fn) whose activation
    functions add their images and their seconds (synchronised) to the
    returned dict."""
    import torch

    stats = {"images": 0, "seconds": 0.0, "calls": 0}

    def make(*args, **kwargs):
        fn = made(*args, **kwargs)

        def timed(images):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(images)
            torch.cuda.synchronize()
            stats["seconds"] += time.perf_counter() - t0
            stats["images"] += len(out)
            stats["calls"] += 1
            return out

        return timed

    return make, stats


def phase_fid_validate(tmp, run):
    """`cli/validate.py` with its default FID flags (--fid-encoder inception,
    no --fid-weights: the net at its seeded random init), --repeats 1, on
    the MMVAE-NF run over the full test set: the FID of each direction
    finite, the coherences in [0, 1], the forward launches those of the
    classifier-encoder validate, and the net's seconds, images a second
    and the run's peak memory. Returns the launches by path."""
    import torch

    from mmvae_tpu_torch.cli import validate
    from mmvae_tpu_torch.cli.common import reload_model
    from mmvae_tpu_torch.eval import fid

    exp = os.path.join(tmp, "experiments")
    _, _, loaders = reload_model(run, 500, "cuda")
    nb = len(loaders[1])
    made = fid.make_inception_fn
    fid.make_inception_fn, stats = _inception_timer(made)
    torch.cuda.reset_peak_memory_stats()
    try:
        summary, lines, launches, wall = _counted(validate.main, [
            "--run-path", run, "--experiments-dir", exp, "--repeats", "1", "--device", "cuda"])
    finally:
        fid.make_inception_fn = made
    peak = torch.cuda.max_memory_allocated()
    values = {k: v["mean"] for k, v in summary.items()}
    expected = (4 * (2 * nb + 1), 0)
    marks = {l.split("] ", 1)[1]: float(l[1:].split("s]")[0]) for l in lines if l.startswith("[")}
    ok = (launches == expected and all(math.isfinite(values[k]) for k in ("fid_0", "fid_1"))
          and all(0.0 <= values[k] <= 1.0 for k in ("acc_0_1", "acc_1_0", "joint_coherence"))
          and stats["images"] == 4 * len(loaders[1].dataset))
    emit({"phase": "fid_validate", "encoder": "inception (random init, seed 0)",
          "test_pairs": len(loaders[1].dataset), "test_batches": nb,
          "fid": {k: values[k] for k in ("fid_0", "fid_1")}, "metrics": values,
          "inception_images": stats["images"], "inception_calls": stats["calls"],
          "inception_s": stats["seconds"],
          "inception_images_per_s": stats["images"] / max(stats["seconds"], 1e-9),
          "fid_repeat_s": marks["repeat 0: fid done"] - marks["repeat 0: accuracies done"],
          "validate_s": wall, "peak_mem_gib": peak / 2 ** 30, "launches": list(launches),
          "expected_launches": list(expected), "ok": ok})
    if not ok:
        raise AssertionError(f"fid_validate: launches {launches} (expected {expected}), "
                             f"metrics {values}, inception images {stats['images']}")
    return {"validate_inception_mmvae_nf": launches}


def phase_fid_parity(tmp):
    """The InceptionV3 FID net on the card in float32 (TF32 off) against
    float64 on the CPU at the same weights (torch's default conv init from
    seed 0, the BatchNorm statistics and affine drawn as
    tests/test_fid_parity.py draws them), 8 images at 299 x 299, within
    FID_RTOL and FID_ATOL; then the weights written as a pytorch-fid
    checkpoint (with its fc.* head and a num_batches_tracked) and read by
    `make_inception_fn(path)`: the card's activations again."""
    import numpy as np
    import torch

    from mmvae_tpu_torch.eval import fid

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        net = fid.InceptionV3FID().eval()
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, fid.FrozenBatchNorm):
                n = m.weight.numel()
                m.running_mean.copy_(torch.rand(n, generator=gen) * 0.2 - 0.1)
                m.running_var.copy_(torch.rand(n, generator=gen) + 0.5)
                m.weight.copy_(torch.rand(n, generator=gen) + 0.5)
                m.bias.copy_(torch.rand(n, generator=gen) * 0.2 - 0.1)
    x = torch.rand(8, 3, 299, 299, generator=torch.Generator().manual_seed(1))
    sd = dict(net.state_dict())
    with torch.no_grad():
        cuda = net.cuda()(x.cuda())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cuda = net(x.cuda())
        torch.cuda.synchronize()
        cuda_s = time.perf_counter() - t0
        ref = net.cpu().double()(x.double())
    err = (cuda.double().cpu() - ref).abs()
    ok_f32 = bool(torch.allclose(cuda.double().cpu(), ref, rtol=FID_RTOL, atol=FID_ATOL))
    path = os.path.join(tmp, "inception_smoke.pth")
    sd["fc.weight"], sd["fc.bias"] = torch.zeros(1008, 2048), torch.zeros(1008)
    sd["Conv2d_1a_3x3.bn.num_batches_tracked"] = torch.tensor(0)
    torch.save(sd, path)
    loaded = fid.make_inception_fn(path, device="cuda")(x)
    load_err = float(np.abs(loaded - cuda.float().cpu().numpy()).max())
    ok = ok_f32 and load_err <= FID_ATOL and bool(np.isfinite(loaded).all())
    emit({"phase": "fid_parity", "images": 8, "size": 299, "reference": "cpu float64",
          "max_abs_err": err.max().item(), "max_rel_err": (err / ref.abs().clamp_min(1e-30))
          .max().item(), "act_max_abs": ref.abs().max().item(), "rtol": FID_RTOL,
          "atol": FID_ATOL, "cuda_f32_batch8_s": cuda_s,
          "pth_load_max_abs_diff": load_err, "ok": ok})
    if not ok:
        raise AssertionError(f"fid_parity: cuda float32 vs cpu float64 max abs err "
                             f"{err.max().item()}, checkpoint reload diff {load_err}")


def _filtered_png(img, kinds, path):
    """An (H, W, 3) uint8 image as a PNG whose row y is under filter
    kinds[y % len(kinds)] (PNG spec section 9.2)."""
    import struct
    import zlib

    import numpy as np

    h, stride = img.shape[0], img.shape[1] * 3
    rows, prior = [], np.zeros(stride, np.int64)
    for y in range(h):
        cur = img[y].reshape(-1).astype(np.int64)
        left = np.concatenate([np.zeros(3, np.int64), cur[:-3]])
        upleft = np.concatenate([np.zeros(3, np.int64), prior[:-3]])
        kind = kinds[y % len(kinds)]
        if kind == 3:
            pred = (left + prior) // 2
        else:
            p = left + prior - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prior), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prior, upleft))
        rows.append(bytes([kind]) + ((cur - pred) % 256).astype(np.uint8).tobytes())
        prior = cur

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", img.shape[1], h, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
                + chunk(b"IDAT", zlib.compress(b"".join(rows), 6)) + chunk(b"IEND", b""))


def _refilter_celeba(root, tmp):
    """CelebA's crops as real ones are stored: the layout's writer puts every
    row under filter 0, PIL's adaptive filtering mostly under Paeth, which
    the reader undoes pixel by pixel. Each crop of the layout is rewritten
    in place with its rows alternating Average and Paeth (the worst case),
    so the loaders below read those. Then PNG_READ_N such crops are decoded
    by `read_pngs`, as `load_celeba` decodes a chunk (and by PIL, where
    this machine has it): the seconds per crop and the projection to
    CelebA's 202,599. Returns what it measured."""
    import importlib.util

    import numpy as np

    from mmvae_tpu_torch.data.png import read_pngs

    crops = os.path.join(root, "celeba", "img_align_celeba", "celeba_64x64", "train")
    names = sorted(os.listdir(crops))
    paths = [os.path.join(crops, n) for n in names]
    imgs = read_pngs(paths)
    for j, (path, img) in enumerate(zip(paths, imgs)):
        _filtered_png(img, (3, 4) if j % 2 else (4, 3), path)
    bulk = os.path.join(tmp, "png_read")
    os.makedirs(bulk, exist_ok=True)
    many = []
    for j in range(PNG_READ_N):
        many.append(os.path.join(bulk, f"{j:06d}.png"))
        shutil.copyfile(paths[j % len(paths)], many[-1])
    t0 = time.perf_counter()
    got = read_pngs(many)
    read_s = time.perf_counter() - t0
    same = all(np.array_equal(g, imgs[j % len(imgs)]) for j, g in enumerate(got))
    out = {"crops": PNG_READ_N, "filters": "rows alternate Average and Paeth",
           "read_pngs_s": read_s, "ms_per_crop": 1e3 * read_s / PNG_READ_N,
           "projected_celeba_s": read_s / PNG_READ_N * CELEBA_CROPS, "same_pixels": same}
    if importlib.util.find_spec("PIL") is not None:
        from PIL import Image

        t0 = time.perf_counter()
        for path in many:
            with Image.open(path) as im:
                np.asarray(im)
        out["pil_s"] = time.perf_counter() - t0
    shutil.rmtree(bulk)
    return out


def phase_real_layout(tmp):
    """`make_real_layout.build_layout` of REAL_LAYOUT_N a split; with
    MMVAE_TPU_REQUIRE_REAL=1 the MNIST-SVHN and CelebA loaders read it on
    this machine (PIL absent or not, the port reads CelebA's PNGs itself),
    and one mmvae_nf_synth.json epoch trains from it through the CLI: its
    launches 4 x (train steps + val batches) forward and 4 x train steps
    backward, as the synthetic epoch's at its own size. Returns the
    launches by path."""
    import importlib.util

    import numpy as np

    from mmvae_tpu_torch.data import get_dataloaders
    from mmvae_tpu_torch.data.make_real_layout import build_layout

    root = os.path.join(tmp, "real_layout")
    t0 = time.perf_counter()
    build_layout(root, REAL_LAYOUT_N)
    write_s = time.perf_counter() - t0
    png_read = _refilter_celeba(root, tmp)
    prev = os.environ.get("MMVAE_TPU_REQUIRE_REAL")
    os.environ["MMVAE_TPU_REQUIRE_REAL"] = "1"
    try:
        sizes = {}
        t0 = time.perf_counter()
        for name in ("mnist_svhn", "celeba"):
            loaders = get_dataloaders(name, data_path=root, batch_size=16)
            xs, _ = next(iter(loaders[0]))
            sizes[name] = {"splits": [l.num_examples for l in loaders],
                           "shapes": [list(np.asarray(x).shape) for x in xs],
                           "finite_in_unit": all(float(np.min(x)) >= 0 and float(np.max(x)) <= 1
                                                 for x in xs)}
        read_s = time.perf_counter() - t0
        _, _, info, _ = _cli_epoch(tmp, CONFIG, synthetic_n=None, data_path=root,
                                   experiment="smoke/real_layout")
    finally:
        if prev is None:
            os.environ.pop("MMVAE_TPU_REQUIRE_REAL")
        else:
            os.environ["MMVAE_TPU_REQUIRE_REAL"] = prev
    steps, val_b = info["train_steps"], info["val_batches"]
    expected = (4 * (steps + val_b), 4 * steps)
    got = (info["ar_solve_launches"], info["ar_solve_backward_launches"])
    ok = (got == expected and steps > 0 and info["losses_finite"] and info["params_on_cuda"]
          and all(v["finite_in_unit"] for v in sizes.values()) and png_read["same_pixels"])
    emit({"phase": "real_layout", "n": REAL_LAYOUT_N,
          "pil_present": importlib.util.find_spec("PIL") is not None, "write_s": write_s,
          "read_s": read_s, "png_read": png_read, "datasets": sizes, "train_pairs": info["train_pairs"],
          "train_steps": steps, "val_batches": val_b, "launches": list(got),
          "expected_launches": list(expected), "train_loss": info["train_loss"],
          "epoch_wall_s_incl_setup": info["epoch_wall_s_incl_setup"], "ok": ok})
    if not ok:
        raise AssertionError(f"real_layout: launches {got} (expected {expected}), {sizes}")
    return {"real_layout_mmvae_nf": got}


def phase_probes(dcca_probe, run):
    """The linear probes: dcca_train's SVM probe of phase 12 on the card
    (its printed accuracies, the solves' seconds), and `classify_latent`,
    the hinge SGD probe, fitted on the MMVAE-NF run's flow-posterior
    latents of modality 0 (MNIST) for PROBE_ROWS train rows and scored on
    as many test rows, against the class labels: on the host, where it
    runs by default, and on the card, each timed."""
    import numpy as np
    import torch

    from mmvae_tpu_torch.cli.common import reload_model
    from mmvae_tpu_torch.eval.generation import Noise
    from mmvae_tpu_torch.eval.latent_analysis import analyse_uni_posterior, classify_latent

    accs = {l.split(":")[0]: float(l.split()[-1]) for l in dcca_probe["lines"]}
    _, bundle, (train_l, test_l, _) = reload_model(run, PROBE_ROWS, "cuda")
    noise = Noise([torch.Generator(device="cuda").manual_seed(0)])
    latents = []
    with torch.no_grad():
        for loader in (train_l, test_l):
            xs, labs = next(iter(loader))
            xs = [torch.as_tensor(x).cuda() for x in xs]
            z = analyse_uni_posterior(bundle.model, xs, noise, PROBE_ROWS)[0]
            latents += [z, np.asarray(labs[0])]
    torch.cuda.synchronize()
    acc, secs = {}, {}
    for device in ("cpu", "cuda"):  # the host, its default, then the card for comparison
        t0 = time.perf_counter()
        acc[device] = classify_latent(*latents, generator=torch.Generator().manual_seed(0),
                                      device=device)
        secs[device] = time.perf_counter() - t0
    latent_acc = acc["cpu"]
    ok = (len(accs) == 2 and all(0.0 <= a <= 1.0 for a in accs.values())
          and all(0.0 <= a <= 1.0 for a in acc.values()) and len(dcca_probe["seconds"]) == 1)
    emit({"phase": "probes", "dcca_svm_probe": accs, "dcca_svm_probe_s": dcca_probe["seconds"],
          "latent_rows": PROBE_ROWS, "classify_latent_acc": acc,
          "classify_latent_s": secs, "ok": ok})
    if not ok:
        raise AssertionError(f"probes: {accs}, latent accuracy {acc}")


def phase_sweep(tmp):
    """`cli/sweep.py` on cuda from a JSON spec (what a machine without
    PyYAML takes): two random trials of beta_kl over a tiny circles-squares
    config through the train CLI, ranked, sweep_results.json written."""
    from mmvae_tpu_torch.cli import sweep

    spec = {"method": "random", "metric": {"name": "", "goal": "maximize"},
            "parameters": {"beta-kl": {"min": 0.1, "max": 1.0},
                           "model": {"value": "circles_squares"}}}
    base = {"model": "circles_squares", "obj": "elbo", "K": 1, "latent_dim": 2, "epochs": 1,
            "dist": "normal", "recon_losses": ["normal", "normal"], "no_nf": True,
            "batch_size": 16, "learning_rate": 1e-3, "dataset_size": 40, "n_repeat": 2,
            "no_analytics": True, "seed": 1, "warmup": 0, "data_path": ""}
    paths = [os.path.join(tmp, n) for n in ("sweep_spec.json", "sweep_base.json")]
    for path, obj in zip(paths, (spec, base)):
        with open(path, "w") as f:
            json.dump(obj, f)
    exp = os.path.join(tmp, "sweep")
    out, _, launches, wall = _counted(sweep.main, [
        "--spec", paths[0], "--base-config", paths[1], "--trials", "2",
        "--experiments-dir", exp, "--device", "cuda"])
    scores = [t["score"] for t in out["trials"]]
    ok = (len(scores) == 2 and all(math.isfinite(v) for v in scores)
          and out["best"]["score"] == max(scores)
          and os.path.exists(os.path.join(exp, "sweep_results.json")))
    emit({"phase": "sweep", "trials": out["trials"], "best": out["best"], "seconds": wall,
          "launches": list(launches), "ok": ok})
    if not ok:
        raise AssertionError(f"sweep: {out}")


def _ksplit_rank(rank, store, n_data, n_k, job_path, out_dir):
    """One rank of `phase_ksplit_parity`: over gloo on cuda:0 beside the
    other ranks, the flagship's loss_and_grads on its rows and its K / n_k
    samples (MMVAE.k_split), then the gather of a log-weight tensor of its
    shape timed."""
    import datetime

    import torch

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(n_data * n_k), LOCAL_RANK=str(rank))
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from mmvae_tpu_torch.parallel import make_mesh, shard_batch, split_k

    mesh = split_k(make_mesh(n_data, n_k, device="cuda", backend="gloo",
                             init_method=f"file://{store}",
                             timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S)))
    case = torch.load(job_path, weights_only=False)
    cfg, trainer, xs, us = _ddp_trainer(case, mesh.device, torch.float32, mesh)
    xs, block = shard_batch(mesh, xs)
    rows = slice(None) if block is None else slice(block.start, block.stop)
    us = [u[mesh.k_samples(cfg.K), rows] for u in us]
    loss, _, grads, finite = trainer.loss_and_grads(xs, noise=us, block=block)
    torch.cuda.synchronize()
    lws = torch.randn(2, cfg.K // n_k, len(xs[0]), device=mesh.device)
    for _ in range(3):
        mesh.gather_k(lws, 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(KSPLIT_GATHERS):
        mesh.gather_k(lws, 1)
    torch.cuda.synchronize()
    gather_ms = (time.perf_counter() - t0) / KSPLIT_GATHERS * 1e3
    torch.save(dict(loss=loss.item(), finite=bool(finite), grads=[g.cpu() for g in grads],
                    applies=mesh.splits(cfg.K), gather_ms=gather_ms,
                    gathered_shape=[2, cfg.K, len(xs[0])]),
               os.path.join(out_dir, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


def phase_ksplit_parity(tmp):
    """The flagship's DReG-looser step with the K split over 'k' on the
    card (KSPLIT_MESHES, ranks over gloo sharing cuda:0, spawned together),
    against one process on the card at the same weights and the same
    global Laplace noise (cut by K, then by rows, on the ranks): the ranks'
    objectives summed within STEP_OBJ_RTOL of the one process's; their
    all-reduced gradient bitwise equal on every rank and within
    MMVAE_GRAD_TOL of each leaf of the float64 CPU step (the one process's
    beside it); the gather's milliseconds."""
    import numpy as np
    import torch

    from mmvae_tpu_torch.bridge import export_jax_params
    from mmvae_tpu_torch.core import distributions as D
    from mmvae_tpu_torch.core.config import ExperimentConfig
    from mmvae_tpu_torch.models import registry
    from mmvae_tpu_torch.train import Trainer

    cfg_path, _ = _slice_config(tmp, FLAGSHIP, batch_size=MMVAE_PARITY_B,
                                experiment="smoke/ksplit")
    cfg = ExperimentConfig.from_json(cfg_path)
    xs, _ = next(iter(_data_loaders(cfg)[0]))
    rng = np.random.default_rng(0)
    us = [rng.uniform(D.LAPLACE_U_MIN, D.LAPLACE_U_MAX,
                      (cfg.K, cfg.batch_size, cfg.latent_dim)).astype(np.float32) for _ in xs]
    bundle = registry.build(cfg)
    trainer = Trainer(bundle.model, bundle.spec, cfg, device="cpu")
    trainer.init_parameters()
    case = dict(name="flagship", cfg=cfg_path, xs=[np.asarray(x) for x in xs], eps=us,
                weights=export_jax_params(trainer.model), epoch=1)
    job = os.path.join(tmp, "ksplit_job.pt")
    torch.save(case, job)
    started = {}
    for n_data, n_k in KSPLIT_MESHES:
        out_dir = os.path.join(tmp, f"ksplit_{n_data}x{n_k}")
        os.makedirs(out_dir, exist_ok=True)
        started[n_data, n_k] = out_dir, _start_ranks(
            _ksplit_rank, (n_data, n_k, job, out_dir), n_data * n_k, out_dir)
    refs = {}
    for run, dev, dtype in (("cuda_f32", "cuda", torch.float32),
                            ("cpu_f64", "cpu", torch.float64)):
        _, one, xs_t, us_t = _ddp_trainer(case, dev, dtype)
        loss, _, grads, _ = one.loss_and_grads(xs_t, noise=us_t)
        refs[run] = {"obj": -loss.item(), "loss": loss.item(),
                     "grads": [g.double().cpu() for g in grads]}
    names = [n for n, _ in one.model.named_parameters()]
    scales = _leaf_scales(refs["cpu_f64"]["grads"], names)
    one_err = _step_errors(refs["cuda_f32"], refs["cpu_f64"], names, scales)
    results, ok_all = {}, True
    for (n_data, n_k), (out_dir, context) in started.items():
        _join_ranks(context)
        ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
                 for r in range(n_data * n_k)]
        loss = sum(r["loss"] for r in ranks)
        split = {"obj": -loss, "loss": loss, "grads": [g.double() for g in ranks[0]["grads"]]}
        vs_one = _step_errors(split, refs["cuda_f32"], names, scales)
        vs_f64 = _step_errors(split, refs["cpu_f64"], names, scales)
        same = all(torch.equal(a, b) for r in ranks[1:]
                   for a, b in zip(ranks[0]["grads"], r["grads"]))
        ok = (all(r["applies"] and r["finite"] for r in ranks) and same
              and vs_one["objective_rel_err"] <= STEP_OBJ_RTOL
              and vs_f64["grad_max_rel_err"] <= MMVAE_GRAD_TOL)
        ok_all = ok_all and ok
        results[f"{n_data}x{n_k}"] = ok
        emit({"phase": "ksplit_parity", "mesh": [n_data, n_k], "K": cfg.K,
              "batch": cfg.batch_size, "samples_per_rank": cfg.K // n_k,
              "rows_per_rank": cfg.batch_size // n_data, "objective_one_process": -refs[
                  "cuda_f32"]["loss"], "objective_ranks_summed": -loss,
              "vs_one_process_cuda": vs_one, "vs_cpu_f64": vs_f64,
              "one_process_cuda_vs_cpu_f64": one_err, "grads_equal_on_ranks": same,
              "gather_ms_by_rank": [r["gather_ms"] for r in ranks],
              "gathered_shape": ranks[0]["gathered_shape"], "objective_rtol": STEP_OBJ_RTOL,
              "grad_tol": MMVAE_GRAD_TOL, "ok": ok})
    if not ok_all:
        raise AssertionError(f"ksplit_parity: {results}")


def ddp_cards(n):
    """`chip_smoke.py ddp-cards N`, on a machine with N cards: the
    data-parallel phases over NCCL with one rank a card (ddp_parity's two
    steps, ddp_slice's epoch with mesh_data N), then the card line and the
    contract line. The smoke itself, run with no argument, needs one card
    and runs them over gloo on it."""
    import torch

    if torch.cuda.device_count() < n:
        print(f"chip_smoke ddp-cards {n}: {torch.cuda.device_count()} card(s)", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    # float32 parity, as main() runs it: no TF32 in matmuls or cuDNN convs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    phase_build()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        launches = phase_ddp_parity(tmp, ranks=n, backend="nccl")
        launches.update(phase_ddp_slice(tmp, runs=((n, ""),)))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "ddp_cards", "cards": n, "launches_by_path": launches,
          "seconds": time.perf_counter() - t0})
    print(smi.stdout.strip().replace("\n", "; "), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def main():
    import torch

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["ddp-rank"]:  # one rank of phase_ddp_slice, under torchrun
        _ddp_rank_cli(*sys.argv[2:6])
        return 0
    if sys.argv[1:2] == ["ddp-cards"]:
        return ddp_cards(int(sys.argv[2]))
    sys.path.insert(0, ROOT)
    import mmvae_tpu_torch  # noqa: F401  (fails where the checkout is missing)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "kind": kind, "nvidia_smi": card,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    walls = {}  # each phase's wall seconds

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        walls[name] = walls.get(name, 0.0) + time.perf_counter() - t0
        return out

    timed("build", phase_build)
    solve = timed("ar_solve", phase_ar_solve)
    solve2 = timed("ar_solve_latent2", phase_ar_solve_latent2)
    solve64 = timed("ar_solve_latent64", phase_ar_solve_latent64)
    solve30 = timed("ar_solve_latent30", phase_ar_solve_latent30)
    ties_err = timed("ar_solve_ties", phase_ar_solve_ties)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        sl = timed("slice", phase_slice, tmp)
        timed("parity", phase_parity, tmp)
        train_loader, flagship_run = timed("mmvae_slice", phase_mmvae_slice, tmp)
        for config in (FLAGSHIP, FLAGSHIP_BF16):
            timed("mmvae_slice_time", phase_mmvae_time, tmp, config, train_loader)
        timed("mmvae_parity", phase_mmvae_parity, tmp)
        jnf_loader, jnf = timed("jnf_slice", phase_jnf_slice, tmp)
        timed("jnf_slice_time", phase_jnf_time, tmp, jnf_loader)
        timed("jnf_parity", phase_jnf_parity, tmp)
        dcca_path, dcca_probe = timed("dcca", phase_dcca, tmp)
        jnf_dcca = timed("jnf_dcca_slice", phase_jnf_dcca_slice, tmp, dcca_path)
        telbo = timed("telbo_nf_slice", phase_telbo_slice, tmp)
        mvae, mvae_run = timed("mvae_slice", phase_poe_slice, tmp, MVAE, "mvae")
        moepoe, moepoe_run = timed("moepoe_slice", phase_poe_slice, tmp, MOEPOE, "moepoe")
        analytics = timed("analytics", phase_analytics, sl)
        runs = {"mmvae_nf": sl["run_path"], "flagship": flagship_run, "jnf": jnf["run_path"],
                "mvae": mvae_run, "moepoe": moepoe_run}
        validate = timed("eval_validate", phase_eval_validate, tmp, runs)
        likelihoods = timed("eval_likelihoods", phase_eval_likelihoods, tmp, runs)
        timed("eval_parity", phase_eval_parity, tmp, runs)
        timed("eval_memory", phase_eval_memory, runs)
        gen, gen_run1 = timed("gen_slice", phase_gen_slice, tmp, runs["jnf"])
        timed("gen_parity", phase_gen_parity, gen_run1)
        circles, circles_runs = timed("circles_slice", phase_circles_slice, tmp)
        timed("circles_parity", phase_circles_parity, tmp, circles_runs["jnf"])
        mnist1ch = timed("mnist1ch_slice", phase_mnist1ch_slice, tmp)
        medmnist = timed("medmnist_slice", phase_medmnist_slice, tmp)
        celeba = timed("celeba_slice", phase_celeba_slice, tmp)
        timed("resnet_parity", phase_resnet_parity, tmp)
        msf = timed("msf_slice", phase_msf_slice, tmp)
        timed("msf_parity", phase_msf_parity, tmp)
        iaf, iaf_minus = timed("iaf_slice", phase_iaf_slice, tmp)
        tail, tail_minus, loader = timed("tail_slice", phase_tail_slice, tmp)
        linnf = timed("linnf_slice", phase_linnf_slice, tmp, loader)
        timed("tail_parity", phase_tail_parity, tmp)
        ddp = timed("ddp_parity", phase_ddp_parity, tmp)
        ddp.update(timed("ddp_slice", phase_ddp_slice, tmp))
        fid = timed("fid_validate", phase_fid_validate, tmp, runs["mmvae_nf"])
        timed("fid_parity", phase_fid_parity, tmp)
        real = timed("real_layout", phase_real_layout, tmp)
        timed("probes", phase_probes, dcca_probe, runs["mmvae_nf"])
        timed("sweep", phase_sweep, tmp)
        timed("ksplit_parity", phase_ksplit_parity, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # each path's own launches, its counts set to 0 just before it; the
    # flagship's are checked to be none in its phase
    by_path = {"mmvae_nf": (sl["launches"], sl["bwd_launches"]), "flagship": (0, 0),
               "jnf": (jnf["launches"], jnf["bwd_launches"]), "jnf_dcca": jnf_dcca,
               "telbo_nf": (telbo["launches"], telbo["bwd_launches"]), "mvae": mvae,
               "moepoe": moepoe, "analytics_mmvae_nf": (analytics, 0),
               **{f"validate_{k}": v for k, v in validate.items()},
               **{f"likelihoods_{k}": v for k, v in likelihoods.items()},
               **{f"gen_{k}": v for k, v in gen.items()}, **circles, **mnist1ch, **medmnist,
               **celeba, **msf, **iaf, **tail, **linnf, **ddp, **fid, **real}
    # the slice-11 paths' launches at sign -1 (IAF's density direction);
    # every other path's solve is MAF's sampling direction, at sign +1
    by_sign = {**iaf_minus, **tail_minus, **{path: (0, 0) for path in linnf}}

    def entry(name, key, replaces, which, err, **extra):
        r = solve["results"][key]
        launches = {path: counts[which] for path, counts in by_path.items()}
        return {"name": name, "route": "cuda", "source": "mmvae_tpu_torch/csrc/ar_flow.cu",
                "replaces": replaces, "launches": sum(launches.values()),
                "launches_by_path": launches,
                "launches_at_sign_minus_by_path": {path: counts[which]
                                                   for path, counts in by_sign.items()},
                "max_abs_err": err, "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None,
                **extra}

    # the TPU kernel's pallas_call, and its custom_vjp backward (jax.vjp of
    # the unrolled solve), which the backward kernel and the wrapper's
    # reduction replace: its `ms` is both, the kernel alone beside it. The
    # forward's times at eval's rows stand beside its main-path time.
    at_eval = {f"n{n}": solve["results"][n] for n in (500, EVAL_IS_ROWS)}
    emit({"phase": "smoke", "seconds": time.perf_counter() - t_start, "phase_seconds": walls})
    # and at circles-squares' latent 2, MedMNIST's 16, the trimodal 30 and
    # CelebA's 64, with their rows
    at2, at64, at30 = solve2["results"], solve64["results"], solve30["results"][30]

    def fwd_at(res):
        return {k: v for k, v in res.items() if not k.startswith("backward")}

    def bwd_at(res):
        return {k[len("backward_"):]: v for k, v in res.items() if k.startswith("backward")}

    emit({"kernels": [
        entry("ar_solve_forward", 128, "mmvae_tpu/ops/ar_flow.py:96", 0, solve["fwd_err"],
              at_sign_minus_n128=solve["results"]["sign_minus_n128"]["forward"],
              at_eval_rows=at_eval, max_abs_err_at_eval_rows=solve["eval_fwd_err"],
              at_latent_2=fwd_at(at2), max_abs_err_at_latent_2=solve2["errs"]["forward"],
              at_latent_16=fwd_at(at64[16]),
              max_abs_err_at_latent_16=solve64["errs"][16]["forward"],
              at_latent_30=fwd_at(at30), max_abs_err_at_latent_30=solve30["errs"][30]["forward"],
              at_latent_64=fwd_at(at64[64]),
              max_abs_err_at_latent_64=solve64["errs"][64]["forward"]),
        entry("ar_solve_backward", "backward", "mmvae_tpu/ops/ar_flow.py:156", 1,
              solve["bwd_err"],
              kernel_ms=solve["results"]["backward"]["kernel_ms"],
              at_sign_minus_n128=solve["results"]["sign_minus_n128"]["backward"],
              at_latent_2=at2["backward_n128"],
              max_abs_err_at_latent_2=solve2["errs"]["backward"],
              at_latent_16=bwd_at(at64[16]),
              max_abs_err_at_latent_16=solve64["errs"][16]["backward"],
              at_latent_30=bwd_at(at30),
              max_abs_err_at_latent_30=solve30["errs"][30]["backward"],
              at_latent_64=bwd_at(at64[64]),
              max_abs_err_at_latent_64=solve64["errs"][64]["backward"],
              max_abs_err_at_zero_biases_latent_64=ties_err)]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
