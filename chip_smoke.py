#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed N]

The main paths are the flagship inference, reference-guided PICNet at 256^2
(MaskDetector.predict_mask, then ReferenceFill at the bench.py flagship
widths), the path of ``PICNet_inference.py --use_att 1``, in two
configurations: the default one (kernels K1, K2, K3) and the packed-convt one
of ``FMI_PACKED_CONVT=1`` (``packed_convt=True``: decoders 3 and 4 run their
fused tail, kernels K4b and K4a, and K3 does not run); and the Stack A GAN
training step of ``train_reference_fill.py`` at BASELINE config 5 (kernels
K1, K5 and K2); pSp -> StyleGAN2 inference at BASELINE config 4 (K6, K7a);
and the pSp training step of ``train_psp.py`` at config 4 (K6 in both
directions, K7a, K7b); and the paths that run no TPU kernel: the UNet mask
detector's training of ``train_mask_detector.py``, the CLIs' reference
checkpoints and FID with ``test_evaluate.py``. Each path runs with the launch
counts set to 0 just before it and read just after. Phases:

1. build the CUDA kernels from the sources in the checkout (set-up time);
2. hold each kernel against its plain PyTorch version on the card, at the
   flagship shapes and ragged ones, in float32 (TF32 off) and bfloat16; time
   each at the flagship shape beside its bound (the larger of its bytes over
   the memory rate and its operations over the peak rate of the route that
   ran it: K1's, K4a's, K4b's and K5's f32 split-precision route as three
   TF32 products) and, for K1, K5, K4b and K4a, beside the PyTorch call that
   computes the same function (K1's and K5's in both types, with that call's
   error against the plain version, not gated; K4b's and K4a's cuDNN call in
   both types);
   K5, the flash-attention backward, at the config-5 shape (batch 16) and
   ragged ones, for dq and each dv; K1 also at L under and just over one
   128-row block and at C = 64, K4a also on one stream without a prologue,
   at odd H and Co of 3 and 80; check that K1 and K5 take their tensor-core
   routes at d = 64 and C <= 256 (the flagship, config 5, the ragged
   [200, 56] values, L = 100 and 130): in bfloat16 K1's warpgroup (wgmma)
   kernel and K5's tensor-core one, in float32 the split-precision (tf32x3)
   kernels; and their CUDA-core ones elsewhere (d = 48, d = 128, C > 256),
   that K2 takes its cluster route at every decoder norm and its two_pass
   route at [2, 3, 1024, 1024], with constant planes giving finite zeros,
   and K3 its tensor-core route (mma_sync) in bfloat16 at W % 8 == 0 and f
   a power of two up to 32 and its CUDA-core one elsewhere, with K2's
   nearest two-call PyTorch pair timed beside it (not gated);
   that K4b and K4a take their tensor-core routes in
   bfloat16 where W % 8 == 0 (the flagship's decoders 3 and 4 and W = 72
   among them) and their CUDA-core ones elsewhere, that K4b and K4a take
   their split-precision (tf32x3) routes in float32 where W % 4 == 0
   (decoders 3 and 4, W = 72, 48, 100 and 36) and their CUDA-core ones
   elsewhere, and print each one's route and K1's, K4a's, K4b's and K5's
   achieved TFLOP/s;
3. the flagship models at batch 4, float32, random weights from --seed:
   output shape, range and finiteness; the kernel path against the plain
   versions on the card; the launch counts of one forward (K1 once, K2 ten
   times, K3 once); a ``torch.profiler`` window of one forward, which must
   show K1's split-precision kernel and neither of its others;
3b. the packed-convt configuration on the same models and inputs: the
   launch counts of one forward (K1 once, K2 six times, K4b and K4a twice,
   K3 never), a ``torch.profiler`` window of one forward, which must show
   K4b's and K4a's split-precision kernels and none of their others, the
   kernel path
   against the plain versions and against the default configuration's
   output (both compute the same function);
4. the CLI's ``infer_batch`` (float32, as the CLI runs) over three seeded
   batches, with SSIM/MS-SSIM and the median wall time of the calls;
5. the flagship forward at batch 16 in bfloat16 (bench.py's configuration),
   timed with CUDA events, in the default configuration with the kernels
   and with the plain versions and in the packed-convt one with the
   kernels, in alternating order, and the peak device memory of each
   configuration's forward;
6. a profile of that forward: the time of each stage (CUDA events around
   each stage's module) with the kernels, with the dense Output head
   (K1 and K2 on, no K3) and in the packed-convt configuration; the spread
   of the forward over PROFILE_ROUNDS rounds of three forwards a side in
   alternating order (kernels, dense head, plain versions) with the host's
   enqueue time, and a ``torch.profiler`` window of three forwards in each
   configuration (device-busy share, kernels by device time, device
   kernels a forward beside the count before K2's one-launch route); that
   window must show K1's warpgroup kernel, and neither of its others, and
   K2's cluster kernel, and neither its two-pass kernels nor the Triton
   passes it replaced, in every configuration, K3's tensor-core kernel and
   not its CUDA-core ones in the default forward, and K4b's and K4a's
   tensor-core kernels, and not their CUDA-core ones, in the packed-convt
   forward;
7. the config-5 GAN training step (G, D and VGG built by the trainer CLI's
   ``get_args`` and ``Trainer`` with ``--device cuda --decoder_img_f 256``)
   at batch 16 in bfloat16 on seeded batches: finite losses, the launches
   of one step (K1 once, K5 once, K2 ten times, K3 and K4 never), the step
   time (CUDA events, median and quartiles of STEP_ROUNDS steps after two
   warm-up steps), its peak device memory and a ``torch.profiler`` top
   list, which must show K5's tensor-core kernel and neither CUDA-core one,
   and K1's warpgroup kernel;
   and at batch 2 in float32 with a seeded non-zero attention gamma,
   the kernel path's G and D gradients against the plain path's, and a
   ``torch.profiler`` window of that step, which must show K1's and K5's
   split-precision kernels and none of their others;
8. Stack B, pSp -> StyleGAN2 inference at BASELINE config 4 (the path of
   ``psp_inference.py --use_ref --use_attention 1``): K6 (upfirdn2d) and
   K7a (fused_leaky_relu) against their plain versions in float32 and
   bfloat16 at the shapes of one config-4 forward, ragged ones and ones of
   several of K6's tiles in both axes on 1025- and 513-wide rows, timed
   over the 16 K6 and 17 K7a calls of one batch-16 forward beside their
   bounds and a PyTorch yardstick; the pSp model of the CLI's
   ``build_models`` (output 1024, attention, random weights from --seed)
   with the UNet detector in front at batch 2 in float32: output shape and
   finiteness, the kernel path against the plain versions, the launches of
   one forward (K6 16 times, K7a 17 times, K1-K5 never); the CLI's
   ``infer_batch`` over three seeded batches with SSIM and one
   ``ModelInterface.infer``; then config 4 at batch 16 in bfloat16 (the
   model as bench.py builds it): the forward timed with CUDA events in
   turns against the plain versions (median and quartiles), its peak device
   memory and a ``torch.profiler`` window, which must show K6's fused
   kernel and not the two-pass one it replaced;
9. Stack B training at BASELINE config 4 (the path of ``train_psp.py``,
   the ``scripts/train_psp.sh`` recipe with ``--use_attention``: decoder
   trained, identity, LPIPS, L2, logged style and contextual terms, latent
   average, randomized noise, Adam): K7b (fused_leaky_relu_bwd) and K6's
   backward (upfirdn2d_bwd) against their plain versions in float32 and
   bfloat16 at the shapes of one batch-8 step and ragged ones, dbias against
   the plain f32 channel sum, both autograd Functions (grad-of-grad
   included) against autograd of their plain versions, float32 times over
   the 17 and 16 calls of one step beside their bounds and a PyTorch
   yardstick; then the trainer of the CLI's ``get_args`` and ``Trainer``
   (``--device cuda``): at batch 2 in float32 with the fixed noise and
   cuDNN's deterministic algorithms, the kernel path's encoder and decoder
   gradients against the plain path's; at
   batch 8, the launches of one step (K6 16 times forward and 16 backward,
   K7a and K7b 17 times each, K1-K5 never), finite losses with
   ``skipped_nonfinite`` 0, the step time (CUDA events, median and quartiles
   of STEP_ROUNDS steps after two warm-up), its peak device memory and a
   ``torch.profiler`` window (device-busy share), which must show K6's
   fused kernel and not the two-pass one it replaced;
10. Stack C training (the path of ``train_mask_detector.py``), no TPU
   kernel: MaskDetector(3, bilinear) at 256^2, batch 16, in float32 (TF32
   off) and with ``--amp`` (bf16 compute): finite losses, the step time
   (CUDA events, median and quartiles of STEP_ROUNDS steps after two
   warm-up) and peak memory; at batch 2 and 64^2 with cuDNN's
   deterministic algorithms, the card step's gradients, batch statistics
   and loss in float64 against the same step on the CPU, to phase 7's
   gate, and its float32 gradients no further from the float64 step than
   twice the CPU's float32 ones (this step's float32 gradients miss the
   gate against float64 on any device: PERF.md, PR 14); then
   ``cli/train_mask_detector.main`` for one epoch on a seeded synthetic
   tree, its ``--load`` a reference-layout ``.pth`` written from the seeded
   UNet through UNET_REFERENCE_KEYS, the loaded weights equal to the
   seeded ones bit for bit;
11. reference checkpoints and FID, no TPU kernel: the flagship CLI's
   ``build_models`` with that ``.pth`` as ``--mask_detector_path``
   (``infer_batch``'s mask equal to the seeded detector's); InceptionV3 at
   299^2, batch 8, float32, timed, two images' activations against the
   CPU; ``cli/test_evaluate.main`` on the card over a seeded folder of 16
   generated and ground-truth images, its ``metrics.csv`` with finite ssim,
   ms_ssim and fid. Phases 10 and 11 write their data under
   ``build/chip_smoke_data`` and remove it; K1-K7 launch no time in them
   (``infer_batch``, the flagship path, launches its own kernels once);
12. Stack A's other encoders: config 3 with two DRN-C-42 encoders
   (``--encoder_type drn``) and the old-model path (``--old_model 1``:
   218x178, no z, no fused pool) through the inference CLI's
   ``infer_batch``: the launches of one forward (DRN: K1 once, K2 ten
   times, K3 once; old model: K1 once, K2 ten times, K3 never), the
   float32 output (DRN at batch 4, the old model at batch 16) against the
   plain versions to phase 3's gate, bfloat16 at batch 16 timed (CUDA
   events, median and quartiles) with its peak memory, its first 4 images
   no further from the float32 plain path than BF16_VS_F32 times the
   bfloat16 plain path is; K1 at the old
   model's 108 x 88 = 9,504 tokens in both types at phase 2's gates;
   ``cli/picnet_inference.main --device cuda`` with each flag on a seeded
   CelebA-layout tree under ``build/chip_smoke_data`` (image sizes,
   finite ``metrics.csv``); the config-5 trainer with ``--encoder_type
   drn``: a bf16 batch-16 step (launches K1 once, K5 once, K2 ten times;
   finite losses; the DRN's running statistics moved; step time, peak
   memory), and at batch 2 in float32 the kernel path's D gradients to
   phase 7's gate and its G gradients within three times the plain path's
   own drift under a 1e-6 move of the source (the DRN's f32 gradients at
   init are ill-conditioned: PERF.md, section 6); AutoAttention's ``pre``
   branch at 128^2, C = 64 + 64 (K1's CUDA-core route) against its plain
   version, the flagship decoder fed ``f_e`` and ``mask`` (K1 once, K2
   twelve times) against its plain versions, and a CoordConv ResBlock, card
   against CPU;
13. data parallel (``tools/dp_check.py``): the config-5 GAN step (bf16 and
   f32, global batch 16), the config-4 pSp step (f32, global batch 8) and the
   Stack C UNet step (f32, 256^2, global batch 16), each built by its CLI's
   ``Trainer`` on two gloo ranks that share the card, one step after a
   warm-up: each rank's launches (config 5: K1 once, K5 once, K2 ten times;
   config 4: K6 16 + 16, K7a 17, K7b 17; the UNet none), the ranks'
   parameters equal, the metrics, the gradients and the parameter update
   against the one-process step on the same global batch (DP_TOL,
   DP_DRIFT), a negative control (the step with one sync cut misses the
   gradient gate), the step times side by side (two processes share one card: the times measure the
   collectives' cost through gloo, not scaling); one NCCL rank (a
   collective, the UNet step with its group against without); and
   ``cli/train_mask_detector`` under ``torch.distributed.run
   --nproc_per_node 2`` for one epoch on phase 10's tree, only rank 0
   writing its files;
14. the StyleGAN2 discriminator and the tools: the discriminator at size
   1024, channel multiplier 2, batch 4 (one stddev group), weights from
   --seed: its forward in float32 and bfloat16 against the plain versions
   (the output, and each of its K6 and K7a calls) with the launches of one
   forward (K6 16, K7a 19); the float32 gradient penalty ('mixed', alpha
   from --seed) with its d/dx and its double backward into the
   discriminator's parameters, the penalty, the gradient and every
   parameter gradient against the plain path's to phase 7's gate, the
   launches of each backward against ``disc_launches`` (d/dx K6's backward
   16, K7b 19; the double backward twice that); the forwards and the
   penalty step timed in turns with the plain versions, and the step's peak
   memory; ``tools/parity_report.py``'s recorded reference fixtures on the
   card at the CPU tests' tolerances (K6 and K7a launched) and its report
   on an empty assets directory; ``tools/validate_kernels.py`` (every kernel
   against its float64 reference, all ok); and ``tools/trace_top.py`` and
   ``tools/trace_sweep.py`` over a ``ProfileWindow`` trace of three bf16
   forwards (K6's and K7a's kernels with time, a cuDNN convolution with a
   flop count).

Prints a ``kernels`` JSON line, the card's name and power limit, and as its
last line ``{"ok": true, "device": {...}}``. Exits non-zero, printing no
result, when CUDA is unavailable or any phase fails. Imports torch, numpy,
triton and the port only.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

FLAGSHIP_ENC = dict(type="pluralistic", ngf=32, z_nc=128, img_f=128, L=6, layers=5,
                    norm="none", activation="LeakyReLU", init_type="orthogonal")
FLAGSHIP_DEC = dict(ngf=32, z_nc=128, img_f=256, L=0, layers=5, norm="instance",
                    activation="LeakyReLU", init_type="orthogonal")
HW = 256
# (C, H) of the ten decoder instance norms (five ResBlockDecoders, norm1 on the
# block input and norm2 on its hidden map) at the flagship widths
DECODER_NORMS = [(256, 32), (256, 32), (256, 64), (256, 64), (256, 128), (128, 128),
                 (128, 256), (64, 256), (64, 512), (32, 512)]
# |kernel - plain| <= ATOL + RTOL * |plain|: float32 differs only in the order
# of f32 sums; bfloat16 outputs are f32 results rounded once, so the two
# sides may land one bf16 ulp (2^-7 relative) apart
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-3, 2.0 ** -7)}
LSE_ATOL = 1e-3
# the flagship Output head: the last decoder's pair at 1024^2, pooled 4x
HEAD = dict(shape=(16, 32, 1024, 1024), co=3, pool=4)
# the flagship's decoders 3 and 4 as the fused tail runs them: input x
# [16, C, H, H] -> K4b h [16, Co, H, H] -> K4a (h, x) -> [16, Co, 2H, 2H]
DECODER_TAIL = [dict(name="decoder 3", c=128, co=64, h=256),
                dict(name="decoder 4", c=64, co=32, h=512)]
# |Σ kernel - Σ plain| <= rtol * (|Σ plain| + max |Σ plain|) for the f32 sums
# of y and y^2 of K4a and K4b: the same f32 values added in another order
STATS_RTOL = {"float32": 1e-4, "bfloat16": 1e-3}
# one H100 SXM: HBM bytes/s; dense bf16 tensor-core and f32 CUDA-core FLOP/s
MEM_RATE, BF16_RATE, F32_RATE = 3.35e12, 989e12, 67e12
# dense TF32 tensor-core FLOP/s: K1's, K4b's and K5's f32 split-precision
# route runs three TF32 products for each f32 multiply-add
TF32_RATE = 495e12

# rounds of the phase-6 spread: enough for quartiles of a host-bound forward
PROFILE_ROUNDS = 10
# timed steps of phase 7, after two warm-up steps
STEP_ROUNDS = 6
# launches of one flagship forward, default and packed-convt configuration,
# and of one config-5 training step
PER_FORWARD = {"flash_attention_fwd": 1, "flash_attention_bwd": 0, "instance_norm_act": 10,
               "output_head": 1, "conv3x3_stats": 0, "convt_pair": 0}
PACKED_PER_FORWARD = {"flash_attention_fwd": 1, "flash_attention_bwd": 0,
                      "instance_norm_act": 6, "output_head": 0, "conv3x3_stats": 2,
                      "convt_pair": 2}
PER_STEP = {"flash_attention_fwd": 1, "flash_attention_bwd": 1, "instance_norm_act": 10,
            "output_head": 0, "conv3x3_stats": 0, "convt_pair": 0}
# device kernels (copies and fills aside) of one default bf16 forward before
# K2 ran as one launch a call (two Triton passes and about a dozen eager
# finishing ops a call): tools/chip_ab.py on the parent tree, on the H100
KERNELS_PER_FORWARD_BEFORE = 1803
# Stack B's kernels run in none of the Stack A paths above
for _d in (PER_FORWARD, PACKED_PER_FORWARD, PER_STEP):
    _d.update(upfirdn2d=0, upfirdn2d_bwd=0, fused_leaky_relu=0, fused_leaky_relu_bwd=0)
# one config-4 pSp forward: a K6 blur after each of the 8 upsampling convTs
# and a K6 upsample of each of the 8 ToRGB skips; K7a for conv1 and the 16
# StyledConvs
PSP_PER_FORWARD = dict({k: 0 for k in PER_FORWARD}, upfirdn2d=16, fused_leaky_relu=17)
# one config-4 training step: each of those calls once forward and once
# backward (K6's backward, K7b), the decoder frozen or not
PSP_PER_STEP = dict(PSP_PER_FORWARD, upfirdn2d_bwd=16, fused_leaky_relu_bwd=17)
# the config-4 training recipe: scripts/train_psp.sh with --use_attention
# (BASELINE config 4's model), batch 8 on 256^2 inputs
PSP_TRAIN_ARGS = ["--use_ref", "--use_attention", "--output_size", "1024",
                  "--train_decoder", "1", "--lpips_lambda", "0.8", "--l2_lambda", "2",
                  "--id_lambda", "0.1", "--style_lambda", "1000", "--cx_lambda", "1",
                  "--w_norm_lambda", "0", "--start_from_latent_avg", "--randomize_noise",
                  "--optimizer", "adam", "--learning_rate", "1e-4", "--img_scale", "1"]
# pSp, kernel path against plain path: max |kernel - plain| <= tol * max |plain|
# (float32, batch 2; the two differ only in the order of f32 sums)
PSP_TOL = 1e-4
# timed rounds of the config-4 forward, kernels and plain versions in turns
PSP_ROUNDS = 5
# K5: max |kernel - plain| <= tol * max |plain| for dq and each dv. bf16
# rounds P and dS on both sides (the tensor-core route each dS[r, c] apart,
# the plain version their sum over both roles), from f32 values summed in
# another order, so single terms may sit one bf16 ulp apart in sums of
# thousands
BWD_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
# phase 7's f32 gradient check: max |kernel path - plain path| <= tol *
# max |plain| per tensor + floor * the network's largest gradient entry
GRAD_TOL, GRAD_FLOOR = 1e-3, 1e-5

# Stack C (phase 10): the mask detector's trainer at 256^2, batch 16, as the
# JAX CLI's checkpoints256_mask_detector data and the flagship detector's
# input; its gradients, batch statistics and loss on the card against the
# same step on the CPU at batch 2 and 64^2 (the UNet's widths are fixed, so
# 64^2 cuts only the CPU's time): f64 to phase 7's per-tensor gate, f32 no
# further from the f64 step than twice the CPU's f32
UNET_HW, UNET_BATCH = 256, 16
UNET_CHECK_HW, UNET_CHECK_BATCH = 64, 2
# the trainer CLI's epoch: 48 images, 10% for validation, batch 4: 11 steps,
# each followed by a validation round
UNET_CLI_IMAGES, UNET_CLI_BATCH = 48, 4
# phase 11: InceptionV3 at 299^2, batch 8, f32; two images' activations on the
# card against the CPU, max |card - cpu| <= tol * max |cpu|
INCEPTION_BATCH, INCEPTION_TOL = 8, 1e-4
# test_evaluate's folder: 16 generated 256^2 images and their 1024^2 ground
# truths (the CLI reads them at --gt_scale 0.25)
EVAL_IMAGES = 16
# where phases 10 and 11 write their data trees, inside the (ignored) build/
SMOKE_DATA = "build/chip_smoke_data"
# the reference layout of the UNet's keys (modules/unet/unet_parts.py):
# port -> reference, applied in order
UNET_REFERENCE_KEYS = [
    (r"^model\.(down\d)\.conv\.", r"model.\1.maxpool_conv.1.double_conv."),
    (r"^model\.(up\d)\.conv\.", r"model.\1.conv.double_conv."),
    (r"^model\.inc\.", "model.inc.double_conv."),
    (r"double_conv\.conv1\.", "double_conv.0."), (r"double_conv\.bn1\.", "double_conv.1."),
    (r"double_conv\.conv2\.", "double_conv.3."), (r"double_conv\.bn2\.", "double_conv.4."),
    (r"^model\.outc\.", "model.outc.conv."),
]

# phase 12, Stack A's other encoders: BASELINE config 3 with two DRN-C-42
# encoders (``--encoder_type drn``, a 1x1 head to img_f = 128) and the
# flagship decoder, which gets no z; and the old-model path
# (``--old_model 1``): the pluralistic flagship decoding without z from a
# 218x178 input (27x22 features, K1 at 108 x 88 = 9,504 tokens) to 864x704,
# resized to 218x178 with no fused pool, so no K3
DRN_ENC = dict(type="drn", img_f=128, init_type="orthogonal")
OLD_MODEL_HW = (218, 178)
OLD_MODEL_TOKENS = 108 * 88
DRN_PER_FORWARD = dict(PER_FORWARD)
OLD_MODEL_PER_FORWARD = dict(PER_FORWARD, output_head=0)
DRN_PER_STEP = dict(PER_STEP)
# timed forwards of phase 12, after one warm-up
DRN_ROUNDS = 5
# phase 12's CLI runs: a seeded CelebA-layout tree of 2 identities x 4 images
CLI_IDENTITIES, CLI_PER_IDENTITY = 2, 4
# phase 12's bf16 outputs (batch 16, the first 4 held): the bf16 kernel
# path's max and mean |difference| from the f32 plain path each at most this
# multiple of the bf16 plain path's, so a kernel fault that shows only in
# bf16 cannot pass unseen (the max alone sits on the pixels where bf16
# rounding is amplified most, on both paths alike)
BF16_VS_F32 = 2.0
# phase 13, data parallel: each trainer's step on two gloo ranks sharing the
# card (tools/dp_check.py), against the one-process step on the same global
# batch (config 5 in bf16 and in f32). Metrics within the JAX data-parallel
# tests' tolerance (rtol 2e-4, atol 1e-5) plus three times the step's own
# drift under a rounding-sized move of the source (1e-6 of itself in f32,
# 2^-8 in bf16); the two-rank
# parameter update within three times that drift's distance (L2) from the
# one-process update, as phase 12 holds the DRN's ill-conditioned f32
# gradients, and the gradients averaged over the ranks (before Adam, whose
# first step is about +-lr whatever a gradient's size, turns each sign flip
# near zero into a full step) within three times theirs; every rank's
# parameters equal to rank 0's. A negative control per trainer but the bf16
# GAN, the step with one sync cut (tools/dp_check.py's CUT), must miss the
# gradient gate.
# Launches per rank
DP_WORLD, DP_TOL, DP_DRIFT = 2, (2e-4, 1e-5), 3.0
DP_PER_STEP = {"gan": PER_STEP, "gan_f32": PER_STEP, "psp": PSP_PER_STEP,
               "unet": {k: 0 for k in PER_STEP}}
# bf16 rounds each rank's weight gradients before the ranks average them:
# the bf16 step's gradient gate takes the larger of the drift and bf16's
# resolution on them (2^-8 of their L2), and it has no control (a noise cut
# moves its gradients less than that; config 5's control runs in f32)
DP_GRAD_FLOOR = {"gan": 2.0 ** -8}
DP_TIMEOUT = 400

# phase 14: the StyleGAN2 discriminator at full width (size 1024, channel
# multiplier 2), batch 4 (one stddev group), weights from --seed
DISC_SIZE, DISC_BATCH = 1024, 4
# timed rounds of the D forward and of the penalty step, after one warm-up
DISC_ROUNDS = 5


def disc_launches(size: int) -> tuple[dict, dict, dict]:
    """The launches (only the kernels that launch) of one StyleGAN2
    discriminator forward at ``size``, of the gradient penalty's d/dx and of
    its double backward (``penalty.backward()``). A forward blurs twice in
    each of its log2(size) - 2 DResBlocks (K6) and activates conv_in, the
    blocks' conv1 and conv2, final_conv and final_linear1 (K7a). d/dx runs
    each call's backward once (K6 through upfirdn2d_bwd, K7b). The double
    backward runs them twice: once as the backward of the d/dx graph (K7b's
    Function applies its mask again, upfirdn2d_bwd's backward is K6 in the
    forward mode, counted as upfirdn2d_bwd) and once through the forward
    graph, which the minibatch stddev's backward reaches (it reads the
    features) and autograd runs for the two K7a calls after it too, on the
    zero gradients it fills in for them."""
    blocks = int(math.log2(size)) - 2
    n_blur, n_act = 2 * blocks, 1 + 2 * blocks + 2
    return ({"upfirdn2d": n_blur, "fused_leaky_relu": n_act},
            {"upfirdn2d_bwd": n_blur, "fused_leaky_relu_bwd": n_act},
            {"upfirdn2d_bwd": 2 * n_blur, "fused_leaky_relu_bwd": 2 * n_act})


KERNELS = {
    "flash_attention_fwd": dict(
        route="cuda", source="face_mask_inpaint_tpu_torch/csrc/flash_attention_fwd.cu",
        replaces="face_mask_inpaint_tpu/ops/pallas/flash_attention.py:93"),
    "flash_attention_bwd": dict(
        route="cuda", source="face_mask_inpaint_tpu_torch/csrc/flash_attention_bwd.cu",
        replaces="face_mask_inpaint_tpu/ops/pallas/flash_attention.py:579"),
    "instance_norm_act": dict(
        route="cuda", source="face_mask_inpaint_tpu_torch/csrc/norm_act.cu",
        replaces="face_mask_inpaint_tpu/ops/pallas/norm_act.py:84"),
    "output_head": dict(
        route="cuda", source="face_mask_inpaint_tpu_torch/csrc/output_head.cu",
        replaces="face_mask_inpaint_tpu/ops/pallas/packed_convt.py:658"),
    "conv3x3_stats": dict(
        route="cuda", source="face_mask_inpaint_tpu_torch/csrc/decoder_conv.cu",
        replaces="face_mask_inpaint_tpu/ops/pallas/packed_convt.py:444"),
    "convt_pair": dict(
        route="cuda", source="face_mask_inpaint_tpu_torch/csrc/decoder_conv.cu",
        replaces="face_mask_inpaint_tpu/ops/pallas/packed_convt.py:247"),
    "upfirdn2d": dict(
        route="cuda", source="face_mask_inpaint_tpu_torch/csrc/upfirdn2d.cu",
        replaces="face_mask_inpaint_tpu/ops/pallas/upfirdn2d_pallas.py:44"),
    "fused_leaky_relu": dict(
        route="triton", source="face_mask_inpaint_tpu_torch/kernels/fused_act.py",
        replaces="face_mask_inpaint_tpu/ops/pallas/fused_act_pallas.py:40"),
    "upfirdn2d_bwd": dict(
        route="cuda", source="face_mask_inpaint_tpu_torch/csrc/upfirdn2d.cu",
        replaces="face_mask_inpaint_tpu/ops/pallas/upfirdn2d_pallas.py:225",
        timed_dtype="float32"),
    "fused_leaky_relu_bwd": dict(
        route="triton", source="face_mask_inpaint_tpu_torch/kernels/fused_act.py",
        replaces="face_mask_inpaint_tpu/ops/pallas/fused_act_pallas.py:88",
        timed_dtype="float32"),
}
# each kernel's timings entry for the kernels line: bfloat16 unless its
# entry names another timed_dtype (the Stack B backward kernels are timed in
# float32, the trainer's precision, over the calls of one batch-8 step)


class Run:
    """Collects check results; any failed check fails the script."""

    def __init__(self):
        self.failures: list[str] = []
        self.err = {k: 0.0 for k in KERNELS}

    def check(self, ok: bool, what: str) -> None:
        print(("PASS " if ok else "FAIL ") + what, flush=True)
        if not ok:
            self.failures.append(what)


def _close(got, want, dtype_name):
    atol, rtol = TOL[dtype_name]
    got, want = got.float(), want.float()
    err = (got - want).abs()
    return bool((err <= atol + rtol * want.abs()).all()), float(err.max())


def _bound(nbytes: float, ops: float, rate: float) -> tuple[float, str]:
    """(bound in ms, what bounds it): the larger of the bytes over the memory
    rate and the operations over the peak rate of their type."""
    by_bytes, by_ops = nbytes / MEM_RATE * 1e3, ops / rate * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def _route_bound(nbytes: float, ops: float, dtype_name: str, route: str) -> tuple[float, str]:
    """K1's, K4a's, K4b's and K5's bound for the route that ran them: bf16 at the
    dense bf16 rate; f32 on the split-precision route as three TF32 products
    at the dense TF32 rate, on the CUDA cores at the f32 rate."""
    if dtype_name == "bfloat16":
        return _bound(nbytes, ops, BF16_RATE)
    if route == "tf32x3":
        return _bound(nbytes, 3 * ops, TF32_RATE)
    return _bound(nbytes, ops, F32_RATE)


def _time_ms(fn, reps: int):
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


@contextlib.contextmanager
def plain_versions():
    """Route the model's kernel calls to the plain versions (for the
    comparisons and the plain timing only; launches are not counted)."""
    from face_mask_inpaint_tpu_torch.kernels import decoder_conv as dc
    from face_mask_inpaint_tpu_torch.kernels import flash_attention as fa
    from face_mask_inpaint_tpu_torch.kernels import fused_act as act
    from face_mask_inpaint_tpu_torch.kernels import norm_act as na
    from face_mask_inpaint_tpu_torch.kernels import output_head as oh
    from face_mask_inpaint_tpu_torch.kernels import upfirdn2d as fir

    saved = (fa.flash_attention, fa.flash_attention_bwd, na.instance_norm_act,
             oh.output_head, dc.conv3x3_stats, dc.convt_pair, fir.upfirdn2d,
             act.fused_leaky_relu)
    fa.flash_attention = lambda q, values, with_lse=False: fa.flash_attention_plain(
        q, values, with_lse=with_lse)
    fa.flash_attention_bwd = fa.flash_attention_bwd_plain
    na.instance_norm_act = na.instance_norm_act_plain
    oh.output_head = oh.output_head_plain
    dc.conv3x3_stats = dc.conv3x3_stats_plain
    dc.convt_pair = dc.convt_pair_plain
    fir.upfirdn2d = fir.upfirdn2d_plain
    act.fused_leaky_relu = act.fused_leaky_relu_plain
    try:
        yield
    finally:
        (fa.flash_attention, fa.flash_attention_bwd, na.instance_norm_act, oh.output_head,
         dc.conv3x3_stats, dc.convt_pair, fir.upfirdn2d, act.fused_leaky_relu) = saved


def _kernel_name(ptxas_line: str) -> str:
    """The kernel in a ptxas "Compiling entry function" line with its integer
    template arguments, e.g. flash_bwd_tf32x3_kernel<64, 4>: the last
    <length><identifier> of the mangled name's nested name."""
    name = ptxas_line.split("'")[1] if "'" in ptxas_line else ""
    i, ident = (3 if name.startswith("_ZN") else 2), "?"
    while i < len(name) and name[i].isdigit():
        j = i
        while name[j].isdigit():
            j += 1
        ident, i = name[j:j + int(name[i:j])], j + int(name[i:j])
    args = re.match(r"I((?:Li\d+E)+)E", name[i:])
    if args is None:
        return ident
    return ident + "<" + ", ".join(re.findall(r"Li(\d+)E", args.group(1))) + ">"


def phase_build():
    from face_mask_inpaint_tpu_torch.kernels import build

    t0 = time.perf_counter()
    libs = build.build_all()
    print(f"[build] {len(libs)} CUDA source(s) in {time.perf_counter() - t0:.1f} s", flush=True)
    for name, path in libs.items():
        log = path.with_suffix(".log")
        if log.is_file():
            kernel = ""
            for line in log.read_text().splitlines():
                if "Compiling entry function" in line:
                    kernel = _kernel_name(line)
                if "registers" in line or "spill" in line:
                    print(f"[build] {name}: {kernel}: {line.strip()}")


def _library_attention(q, v, ref):
    """K1's yardstick: torch's scaled_dot_product_attention on the same
    inputs (q == k, scale 1), in their dtype. Timed here only; the port never
    calls it. Returns (ms, max |library - plain|), or (None, None) where no
    backend takes the shapes; the error says at what precision it ran and is
    not gated."""
    import torch
    import torch.nn.functional as F

    q4, v4 = q[:, None], v[:, None]
    try:
        err = float((F.scaled_dot_product_attention(q4, q4, v4, scale=1.0)[:, 0].float()
                     - ref.float()).abs().max())
        ms = _time_ms(lambda: F.scaled_dot_product_attention(q4, q4, v4, scale=1.0), 5)
    except RuntimeError as e:  # no backend for these shapes: no yardstick
        print(f"[time] K1 library call unavailable: {str(e).splitlines()[0]}")
        return None, None
    torch.cuda.empty_cache()
    return ms, err


def _library_attention_bwd(q, v, dout, dq_ref, dv_ref):
    """K5's yardstick: the backward of torch's scaled_dot_product_attention
    on the same inputs (q == k, scale 1), timed without its forward. Timed
    here only; the port never calls it. Returns (ms, max |library - plain|
    over dq and dv, each over its largest plain entry), or (None, None); the
    error is not gated."""
    import torch
    import torch.nn.functional as F

    q4 = q[:, None].detach().requires_grad_()
    v4 = v[:, None].detach().requires_grad_()
    try:
        out = F.scaled_dot_product_attention(q4, q4, v4, scale=1.0)
        grads = torch.autograd.grad(out, (q4, v4), dout[:, None], retain_graph=True)
        err = max(float((g[:, 0].float() - w.float()).abs().max()) / float(w.float().abs().max())
                  for g, w in zip(grads, (dq_ref, dv_ref)))
        del grads
        ms = _time_ms(lambda: torch.autograd.grad(out, (q4, v4), dout[:, None],
                                                  retain_graph=True), 5)
    except RuntimeError as e:  # no backend for these shapes: no yardstick
        print(f"[time] K5 library call unavailable: {str(e).splitlines()[0]}")
        return None, None
    del out
    torch.cuda.empty_cache()
    return ms, err


def _route_k1(dtype_name: str, d: int, c_all: int) -> str:
    """The K1 route a shape should take: d = 64 (bf16) or d in {32, 64}
    (f32) with C <= 256 and C % 8 == 0 on the tensor cores, the rest on the
    CUDA cores (the tensors here are 16-byte aligned)."""
    tc = c_all <= 256 and c_all % 8 == 0
    if dtype_name == "bfloat16":
        return "wgmma" if tc and d == 64 else "cuda_cores"
    return "tf32x3" if tc and d in (32, 64) else "cuda_cores"


def _route_k5(dtype_name: str, d: int, c_all: int) -> str:
    """The K5 route a shape should take: d in {32, 64}, C <= 256, C % 8 == 0
    on the tensor cores (bf16) or in split precision (f32)."""
    if d in (32, 64) and c_all <= 256 and c_all % 8 == 0:
        return "tensor_cores" if dtype_name == "bfloat16" else "tf32x3"
    return "cuda_cores"


def _phase_flash_backward(run: Run, gen, timings: dict):
    """K5 against flash_attention_bwd_plain: dq and each dv, from K1's lse,
    at the config-5 shape (N = 16, L = 16384, d = 64, C = 256) and ragged
    ones; d = 48 takes the CUDA-core path, d = 64 the tensor cores (bf16)
    and the split-precision route (f32)."""
    import torch

    from face_mask_inpaint_tpu_torch.kernels import flash_attention as fa

    cases = [("config 5", 16, 16384, 64, [256]), ("ragged", 2, 4100, 64, [200, 56]),
             ("ragged", 2, 4100, 48, [200, 56])]
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for label, n, l, d, widths in cases:
            q = (torch.randn(n, l, d, device="cuda", generator=gen) / d ** 0.5 * 2).to(dtype)
            vs = [torch.randn(n, l, c, device="cuda", generator=gen).to(dtype) for c in widths]
            outs, lse = fa.flash_attention(q, vs, with_lse=True)
            if label == "config 5":
                route, want = fa.flash_attention_route(q, vs), _route_k1(dname, d, sum(widths))
                run.check(route == want, f"K1 {label} N={n} L={l} {dname} takes the {want} "
                                         f"route (route {route}), its lse feeds K5")
            v_cat, o_cat = torch.cat(vs, -1), torch.cat(outs, -1)
            do_cat = torch.randn(v_cat.shape, device="cuda", generator=gen).to(dtype)
            dsum = (do_cat.float() * o_cat.float()).sum(-1)
            del outs, o_cat
            dq, dv = fa.flash_attention_bwd(q, v_cat, lse, do_cat, dsum)
            torch.cuda.synchronize()
            dq_ref, dv_ref = fa.flash_attention_bwd_plain(q, v_cat, lse, do_cat, dsum)
            ok, rel = True, 0.0
            for name, got, want in [("dq", dq, dq_ref)] + [
                    (f"dv{i}", a, b) for i, (a, b) in enumerate(zip(
                        torch.split(dv, widths, -1), torch.split(dv_ref, widths, -1)))]:
                err = float((got.float() - want.float()).abs().max())
                scale = float(want.float().abs().max())
                run.err["flash_attention_bwd"] = max(run.err["flash_attention_bwd"], err)
                ok = ok and err <= BWD_TOL[dname] * scale
                rel = max(rel, err / scale)
            run.check(ok, f"K5 {label} N={n} L={l} d={d} C={widths} {dname}: dq and each dv "
                          f"max_abs_err / max|ref| {rel:.3e} (tol {BWD_TOL[dname]})")
            route, want = fa.flash_attention_bwd_route(q, v_cat), _route_k5(dname, d, sum(widths))
            run.check(route == want, f"K5 {label} N={n} L={l} d={d} C={widths} {dname} takes "
                                     f"the {want} route (route {route})")
            if label == "config 5":
                reps = 5 if dtype == torch.bfloat16 else 2
                ms = _time_ms(lambda: fa.flash_attention_bwd(q, v_cat, lse, do_cat, dsum), reps)
                plain_ms = _time_ms(
                    lambda: fa.flash_attention_bwd_plain(q, v_cat, lse, do_cat, dsum), 2)
                c_all, es = sum(widths), q.element_size()
                # q, v, dO, lse, D read once; dq, dv written once. Operations:
                # the bound formula 2 N L^2 (1.5 d + 2 C)
                ops = 2.0 * n * l * l * (1.5 * d + 2 * c_all)
                bound = _route_bound(es * n * l * (2 * d + 3 * c_all) + 8 * n * l, ops, dname,
                                     route)
                lib_ms, lib_err = _library_attention_bwd(q, v_cat, do_cat, dq_ref, dv_ref)
                timings[("flash_attention_bwd", dname)] = (ms, plain_ms, *bound, lib_ms)
                # the function's operations (the bound's count) and the
                # tensor-core kernels' own (704 MACs an ordered pair)
                own = 2.0 * n * l * l * (3 * d + 2 * c_all) / ms / 1e9
                print(f"[time] K5 config 5 {dname} ({route}): kernel {ms:.3f} ms "
                      f"({ops / ms / 1e9:.1f} TFLOP/s of the function's work, {own:.1f} of the "
                      f"kernel's), plain {plain_ms:.3f} ms, bound {bound[0]:.3f} ms "
                      f"({bound[1]}), library "
                      f"{'none' if lib_ms is None else f'{lib_ms:.3f} ms'} (its max_abs_err / "
                      f"max|plain| {'none' if lib_err is None else f'{lib_err:.3e}'}, not gated)",
                      flush=True)
            del q, vs, v_cat, lse, do_cat, dsum, dq, dv, dq_ref, dv_ref
            torch.cuda.empty_cache()


def phase_kernels(run: Run, seed: int, timings: dict):
    import torch
    import torch.nn.functional as F

    from face_mask_inpaint_tpu_torch.kernels import flash_attention as fa
    from face_mask_inpaint_tpu_torch.kernels import norm_act as na
    from face_mask_inpaint_tpu_torch.kernels import output_head as oh

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    # q scaled so the maps are spread (the diagonal holds well under 1% of a
    # row at L = 16384), which exercises the whole online softmax. d = 64
    # with C <= 256 takes the warpgroup (wgmma) path in bf16 and the
    # split-precision (tf32x3) one in f32, here at L under and just over one
    # 128-row block and at C = 64 too; d = 48, d = 128 and C > 256 take the
    # CUDA-core path
    k1_cases = [("flagship", 16, 16384, 64, [256]), ("ragged", 2, 4100, 64, [200, 56]),
                ("ragged", 2, 4100, 48, [200, 56]), ("ragged", 2, 100, 64, [256]),
                ("ragged", 2, 130, 64, [256]), ("C=64", 2, 4100, 64, [64]),
                ("d=128", 2, 4100, 128, [264]), ("C=272", 2, 257, 64, [200, 72])]
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for label, n, l, d, widths in k1_cases:
            q = (torch.randn(n, l, d, device=dev, generator=gen) / d ** 0.5 * 2).to(dtype)
            vs = [torch.randn(n, l, c, device=dev, generator=gen).to(dtype) for c in widths]
            outs, lse = fa.flash_attention(q, vs, with_lse=True)
            torch.cuda.synchronize()
            refs, lse_ref = fa.flash_attention_plain(q, vs, with_lse=True)
            ok, err = True, 0.0
            for o, r in zip(outs, refs):
                o_ok, o_err = _close(o, r, dname)
                ok, err = ok and o_ok, max(err, o_err)
            lse_err = float((lse - lse_ref).abs().max())
            run.err["flash_attention_fwd"] = max(run.err["flash_attention_fwd"], err)
            run.check(ok and lse_err <= LSE_ATOL,
                      f"K1 {label} N={n} L={l} d={d} C={widths} {dname}: max_abs_err "
                      f"{err:.3e} lse_err {lse_err:.3e} (tol atol {TOL[dname][0]} + rtol "
                      f"{TOL[dname][1]:.3e}*|ref|, lse {LSE_ATOL})")
            route, want_route = fa.flash_attention_route(q, vs), _route_k1(dname, d, sum(widths))
            run.check(route == want_route, f"K1 {label} N={n} L={l} d={d} C={widths} {dname} "
                                           f"takes the {want_route} route (route {route})")
            if label == "flagship":
                ms = _time_ms(lambda: fa.flash_attention(q, vs), 5)
                plain_ms = _time_ms(lambda: fa.flash_attention_plain(q, vs), 5)
                c_all = sum(widths)
                ops = 2.0 * n * l * l * (d + c_all)
                bound = _route_bound(q.element_size() * n * l * (d + 2 * c_all), ops, dname,
                                     route)
                lib_ms, lib_err = _library_attention(q, vs[0], refs[0])
                timings[("flash_attention_fwd", dname)] = (ms, plain_ms, *bound, lib_ms)
                print(f"[time] K1 flagship {dname} ({route}): kernel {ms:.3f} ms "
                      f"({ops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.3f} ms, bound "
                      f"{bound[0]:.3f} ms ({bound[1]}), library "
                      f"{'none' if lib_ms is None else f'{lib_ms:.3f} ms'} (its max_abs_err "
                      f"{'none' if lib_err is None else f'{lib_err:.3e}'}, not gated)",
                      flush=True)
            del q, vs, outs, refs
    torch.cuda.empty_cache()
    _phase_flash_backward(run, gen, timings)

    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        total, total_plain, total_lib, nbytes, ops = 0.0, 0.0, 0.0, 0.0, 0.0
        cases = [(f"decoder N=16 C={c} H=W={h}", (16, c, h, h), "LeakyReLU", "cluster")
                 for c, h in DECODER_NORMS]
        cases += [("ragged", (3, 5, 37, 41), act, "cluster") for act in ("LeakyReLU", "ReLU",
                                                                         "none")]
        cases += [("two_pass", (2, 3, 1024, 1024), "LeakyReLU", "two_pass"),
                  ("two_pass", (2, 3, 1024, 1024), "ReLU", "two_pass")]
        for label, shape, act, want in cases:
            route = na.norm_act_route(shape, dtype)
            run.check(route == want, f"K2 {label} {dname} takes the {want} route (route {route})")
            x = (torch.randn(shape, device=dev, generator=gen) * 2 + 1).to(dtype)
            w = torch.randn(shape[1], device=dev, generator=gen)
            b = torch.randn(shape[1], device=dev, generator=gen)
            y = na.instance_norm_act(x, w, b, act)
            torch.cuda.synchronize()
            ok, err = _close(y, na.instance_norm_act_plain(x, w, b, act), dname)
            run.err["instance_norm_act"] = max(run.err["instance_norm_act"], err)
            run.check(ok, f"K2 {label} {act} {dname}: max_abs_err {err:.3e} "
                          f"(tol atol {TOL[dname][0]} + rtol {TOL[dname][1]:.3e}*|ref|)")
            if label.startswith("decoder"):
                total += _time_ms(lambda: na.instance_norm_act(x, w, b, act), 5)
                total_plain += _time_ms(lambda: na.instance_norm_act_plain(x, w, b, act), 5)
                wl, bl = w.to(dtype), b.to(dtype)
                total_lib += _time_ms(lambda: F.leaky_relu(
                    F.instance_norm(x, weight=wl, bias=bl, eps=1e-5), 0.1), 5)
                # one read of x, one write of y; about 5 flops an element
                # (sum, square-sum, then scale, shift and the activation)
                nbytes += 2 * x.numel() * x.element_size()
                ops += 5.0 * x.numel()
            del x, y
        # a constant plane: the variance is 0 (clamped, never negative), so
        # every route gives finite zeros
        for shape in ((16, 256, 32, 32), (2, 32, 512, 512), (2, 3, 1024, 1024)):
            x = torch.full(shape, 1.5, device=dev, dtype=dtype)
            y = na.instance_norm_act(x, None, None, "LeakyReLU")
            torch.cuda.synchronize()
            run.check(bool(torch.isfinite(y).all()) and bool((y == 0).all()),
                      f"K2 constant plane {list(shape)} {dname} "
                      f"({na.norm_act_route(shape, dtype)}): finite zeros")
            del x, y
        bound = _bound(nbytes, ops, F32_RATE)
        # no one PyTorch call computes K2: the yardstick is the nearest pair,
        # F.instance_norm then F.leaky_relu (two calls, not one)
        timings[("instance_norm_act", dname)] = (total, total_plain, *bound, None)
        print(f"[time] K2 ten decoder norms at N=16 {dname}: kernel {total:.3f} ms, "
              f"plain {total_plain:.3f} ms, bound {bound[0]:.3f} ms ({bound[1]}), yardstick "
              f"{total_lib:.3f} ms (instance_norm + leaky_relu, two calls, not gated)")

    head_cases = [("flagship", HEAD["shape"], HEAD["co"], HEAD["pool"], "LeakyReLU")]
    head_cases += [("ragged", (2, 5, 36, 44), 3, f, act)
                   for f, act in ((1, "LeakyReLU"), (2, "ReLU"), (4, "LeakyReLU"))]
    head_cases += [("ragged", (1, 7, 30, 42), 2, 3, "LeakyReLU"),
                   ("one cell a block", (1, 3, 128, 192), 4, 64, "ReLU")]
    # the tensor-core route (bf16) at ragged shapes: C off its 16-channel
    # chunk, H off its 16- and 32-row tiles, W of one 64-column tile and of
    # one and a bit (72: the right halo of the 8-column tile is column W
    # reflected), co 1, 2, 4, f 1, 2, 8, 32
    head_cases += [("ragged", (2, 20, 96 if f == 32 else 24, w), co, f, act)
                   for co, f, w, act in ((1, 1, 64, "LeakyReLU"), (2, 2, 72, "ReLU"),
                                         (4, 8, 72, "LeakyReLU"), (1, 32, 64, "ReLU"),
                                         (4, 1, 72, "ReLU"), (2, 8, 64, "LeakyReLU"),
                                         (4, 32, 64, "LeakyReLU"), (1, 2, 64, "ReLU"))]
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for label, shape, co, f, act in head_cases:
            c = shape[1]
            h = (torch.randn(shape, device=dev, generator=gen) * 2).to(dtype)
            s = torch.randn(shape, device=dev, generator=gen).to(dtype)
            w = torch.randn(co, c, 3, 3, device=dev, generator=gen) / (3 * c ** 0.5)
            b = torch.randn(co, device=dev, generator=gen) * 0.1
            route = oh.output_head_route(shape, dtype, f)
            want = ("mma_sync" if dtype == torch.bfloat16 and shape[3] % 8 == 0 and f <= 32
                    and f & (f - 1) == 0 else "cuda_cores")
            run.check(route == want, f"K3 {label} {list(shape)} f={f} {dname} takes the {want} "
                                     f"route (route {route})")
            y = oh.output_head(h, s, w, b, act, f)
            torch.cuda.synchronize()
            ok, err = _close(y, oh.output_head_plain(h, s, w, b, act, f), dname)
            run.err["output_head"] = max(run.err["output_head"], err)
            run.check(ok, f"K3 {label} {list(shape)} co={co} f={f} {act} {dname}: max_abs_err "
                          f"{err:.3e} (tol atol {TOL[dname][0]} + rtol {TOL[dname][1]:.3e}*|ref|)")
            if label == "flagship":
                ms = _time_ms(lambda: oh.output_head(h, s, w, b, act, f), 10)
                plain_ms = _time_ms(lambda: oh.output_head_plain(h, s, w, b, act, f), 5)
                # h and s read once, the pooled image written once; 9 C co
                # multiply-adds a pixel, on the tensor cores in bf16 (route
                # mma_sync) and on the CUDA cores in f32
                flops = 2.0 * shape[0] * shape[2] * shape[3] * co * c * 9
                bound = _bound(2 * h.numel() * h.element_size() + y.numel() * y.element_size(),
                               flops, BF16_RATE if route == "mma_sync" else F32_RATE)
                timings[("output_head", dname)] = (ms, plain_ms, *bound, None)
                print(f"[time] K3 flagship {dname} ({route}): kernel {ms:.3f} ms, plain "
                      f"{plain_ms:.3f} ms, bound {bound[0]:.3f} ms ({bound[1]})")
            del h, s, y
        torch.cuda.empty_cache()
    _phase_decoder_tail(run, gen, timings)


def _stats_close(got, want, dname):
    """(ok, error relative to the largest sum) of K4's (sum y, sum y^2)."""
    rtol = STATS_RTOL[dname]
    ok, err = True, 0.0
    for g, w in zip(got, want):
        scale = float(w.abs().max())
        e = (g - w).abs()
        ok = ok and bool((e <= rtol * (w.abs() + scale)).all())
        err = max(err, float(e.max()) / scale)
    return ok, err


def _tail_operands(gen, n, c, co, h, w, dtype):
    """One decoder block's operands: x, conv1 (weight, bias, prologue) and the
    convT pair's weights and biases, with norm-like prologue affines."""
    import torch

    def rnd(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    x = (rnd(n, c, h, w) * 1.5 + 0.2).to(dtype)
    pro1 = (0.5 + torch.rand(n, c, device="cuda", generator=gen), 0.3 * rnd(n, c), "LeakyReLU")
    pro2 = (0.5 + torch.rand(n, co, device="cuda", generator=gen), 0.3 * rnd(n, co),
            "LeakyReLU")
    return dict(x=x, w1=rnd(co, c, 3, 3) / (3 * c ** 0.5), b1=0.5 * rnd(co), pro1=pro1,
                w2=rnd(co, co, 3, 3) / (3 * co ** 0.5), b2=0.5 * rnd(co), pro2=pro2,
                wb=rnd(c, co, 3, 3) / (3 * c ** 0.5), bb=0.5 * rnd(co))


def _phase_decoder_tail(run: Run, gen, timings: dict):
    """K4b and K4a against their plain versions at the flagship's decoder 3
    and 4 shapes (chained as the block runs them: K4b's output feeds K4a)
    and at ragged ones; times summed over the two decoders."""
    import torch
    import torch.nn.functional as F

    from face_mask_inpaint_tpu_torch.kernels import decoder_conv as dc

    # W = 41 and 70 take K4b's and K4a's CUDA-core kernels in bf16; W = 72 and
    # 48 their tensor cores, with odd H, C and Co off their tiles (Co = 3 and
    # 80); each K4a also runs on the x stream alone, which has no prologue. In
    # f32, K4b and K4a take their split-precision kernels where W % 4 == 0
    # (72, 48, 100, 36: H and W off their tiles, C = 13 and 21 off their
    # 8-channel chunk, Co = 3, 16, 40 and 80 off their channel blocks, with and
    # without a prologue) and their CUDA-core ones at W = 41 and 70
    ragged = [dict(name="ragged", n=3, c=13, co=3, h=37, w=41, pro="ReLU", act="LeakyReLU"),
              dict(name="ragged", n=2, c=21, co=80, h=17, w=70, pro=None, act=None),
              dict(name="ragged", n=2, c=40, co=80, h=19, w=72, pro="LeakyReLU", act="ReLU"),
              dict(name="ragged", n=2, c=24, co=3, h=21, w=48, pro=None, act="LeakyReLU"),
              dict(name="ragged", n=2, c=13, co=16, h=23, w=100, pro="ReLU", act="LeakyReLU"),
              dict(name="ragged", n=1, c=21, co=40, h=10, w=36, pro=None, act="ReLU")]
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        acc = {k: dict(ms=0.0, plain=0.0, lib=0.0, flops=0.0, bounds=[])
               for k in ("conv3x3_stats", "convt_pair")}
        cases = [dict(d, n=16, w=d["h"], pro="LeakyReLU",
                      act="LeakyReLU" if d["name"] == "decoder 4" else None)
                 for d in DECODER_TAIL] + ragged
        for case in cases:
            n, c, co, h, w = (case[k] for k in ("n", "c", "co", "h", "w"))
            t = _tail_operands(gen, n, c, co, h, w, dtype)
            flagship = case["name"].startswith("decoder")
            pro1 = t["pro1"] if case["pro"] else None
            if pro1 is not None:
                pro1 = (pro1[0], pro1[1], case["pro"])
            k4b_args = (t["x"], t["w1"], t["b1"], pro1, case["act"] if not flagship else None)
            y, st = dc.conv3x3_stats(*k4b_args, with_stats=True)
            torch.cuda.synchronize()
            want, want_st = dc.conv3x3_stats_plain(*k4b_args, with_stats=True)
            ok, err = _close(y, want, dname)
            s_ok, s_err = _stats_close(st, want_st, dname)
            run.err["conv3x3_stats"] = max(run.err["conv3x3_stats"], err)
            run.check(ok and s_ok, f"K4b {case['name']} N={n} C={c} Co={co} H={h} W={w} "
                                   f"pro={case['pro']} {dname}: max_abs_err {err:.3e} (tol atol "
                                   f"{TOL[dname][0]} + rtol {TOL[dname][1]:.3e}*|ref|), stats "
                                   f"err {s_err:.3e} of the largest (rtol {STATS_RTOL[dname]})")
            del want, want_st
            # K4a on K4b's output, as the block chains them
            streams = [(y, t["w2"], t["b2"], t["pro2"]), (t["x"], t["wb"], t["bb"])]
            act, with_stats = case["act"], case["act"] is None
            out = dc.convt_pair(streams, act, with_stats)
            torch.cuda.synchronize()
            want = dc.convt_pair_plain(streams, act, with_stats)
            s_ok, s_note = True, "no stats"
            if with_stats:
                (out, st), (want, want_st) = out, want
                s_ok, s_err = _stats_close(st, want_st, dname)
                s_note = f"stats err {s_err:.3e} of the largest (rtol {STATS_RTOL[dname]})"
            ok, err = _close(out, want, dname)
            run.err["convt_pair"] = max(run.err["convt_pair"], err)
            run.check(ok and s_ok, f"K4a {case['name']} N={n} C_h={co} C_x={c} Co={co} H={h} "
                                   f"W={w} act={act} {dname}: max_abs_err {err:.3e} (tol atol "
                                   f"{TOL[dname][0]} + rtol {TOL[dname][1]:.3e}*|ref|), "
                                   f"{s_note}")
            del want
            if not flagship:  # one stream, no prologue
                one = [(t["x"], t["wb"], t["bb"])]
                got1 = dc.convt_pair(one, act, with_stats)
                torch.cuda.synchronize()
                want1 = dc.convt_pair_plain(one, act, with_stats)
                s_ok = True
                if with_stats:
                    (got1, st1), (want1, want_st1) = got1, want1
                    s_ok, _ = _stats_close(st1, want_st1, dname)
                ok, err = _close(got1, want1, dname)
                run.err["convt_pair"] = max(run.err["convt_pair"], err)
                run.check(ok and s_ok, f"K4a one stream without prologue N={n} C_x={c} Co={co} "
                                       f"H={h} W={w} act={act} {dname}: max_abs_err {err:.3e}"
                                       f"{', stats within rtol' if with_stats else ''}")
                del got1, want1
            if dtype == torch.bfloat16:
                want_route = "tensor_cores" if w % 8 == 0 else "cuda_cores"
            else:
                want_route = "tf32x3" if w % 4 == 0 else "cuda_cores"
            for kname, route in (("K4b", dc.conv3x3_route(t["x"])),
                                 ("K4a", dc.convt_pair_route(y))):
                run.check(route == want_route, f"{kname} {case['name']} W={w} {dname} takes "
                                               f"the {want_route} route (route {route})")
            if flagship:
                es = t["x"].element_size()
                w1, b1 = t["w1"].to(dtype), t["b1"].to(dtype)
                w2, b2, wb, bb = (t[k].to(dtype) for k in ("w2", "b2", "wb", "bb"))
                # the library yardsticks leave out the prologues and the stats;
                # each bound at the rate of the route that ran (K4b's and K4a's
                # f32 split-precision routes: three TF32 products a multiply-add)
                per = {"conv3x3_stats": (
                    lambda: dc.conv3x3_stats(*k4b_args, with_stats=True),
                    lambda: dc.conv3x3_stats_plain(*k4b_args, with_stats=True),
                    lambda: F.conv2d(t["x"], w1, b1, padding=1),
                    _route_bound((t["x"].numel() + y.numel() + w1.numel()) * es,
                                 2.0 * n * h * w * co * c * 9, dname,
                                 dc.conv3x3_route(t["x"]))),
                       "convt_pair": (
                    lambda: dc.convt_pair(streams, act, with_stats),
                    lambda: dc.convt_pair_plain(streams, act, with_stats),
                    lambda: (F.conv_transpose2d(y, w2, b2, 2, 1, 1)
                             + F.conv_transpose2d(t["x"], wb, bb, 2, 1, 1)),
                    _route_bound((y.numel() + t["x"].numel() + out.numel() + w2.numel()
                                  + wb.numel()) * es, 2.0 * n * h * w * 9 * (co * co + c * co),
                                 dname, dc.convt_pair_route(y)))}
                for name, (kernel, plain, library, bound) in per.items():
                    a = acc[name]
                    ms, plain_ms, lib_ms = (_time_ms(kernel, 5), _time_ms(plain, 3),
                                            _time_ms(library, 5))
                    flops = (2.0 * n * h * w * 9 * co * c if name == "conv3x3_stats"
                             else 2.0 * n * h * w * 9 * (co * co + c * co))
                    a["ms"] += ms
                    a["plain"] += plain_ms
                    a["lib"] += lib_ms
                    a["flops"] += flops
                    a["bounds"].append(bound)
                    route = (dc.conv3x3_route(t["x"]) if name == "conv3x3_stats"
                             else dc.convt_pair_route(y))
                    print(f"[time] {'K4b' if name == 'conv3x3_stats' else 'K4a'} "
                          f"{case['name']} {dname} ({route}): kernel {ms:.3f} ms "
                          f"({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.3f} ms, library "
                          f"(cuDNN) {lib_ms:.3f} ms, bound {bound[0]:.3f} ms ({bound[1]})")
            del t, y, out, streams
            torch.cuda.empty_cache()
        for name, a in acc.items():
            bound = sum(b for b, _ in a["bounds"])
            by = max(a["bounds"])[1]
            timings[(name, dname)] = (a["ms"], a["plain"], bound, by, a["lib"])
            print(f"[time] {'K4b' if name == 'conv3x3_stats' else 'K4a'} decoders 3 + 4 at "
                  f"N=16 {dname}: kernel {a['ms']:.3f} ms ({a['flops'] / a['ms'] / 1e9:.1f} "
                  f"TFLOP/s), plain {a['plain']:.3f} ms, bound {bound:.3f} ms ({by}), library "
                  f"{a['lib']:.3f} ms (no prologue, no stats)", flush=True)


def _models(seed: int, dtype, enc=None, out_size=None):
    """The detector and ReferenceFill on the card (the flagship's encoders
    unless ``enc`` names others) with the decoder attention's gamma at one."""
    import torch

    from face_mask_inpaint_tpu_torch.models.reference_fill import ReferenceFill
    from face_mask_inpaint_tpu_torch.models.unet import MaskDetector

    weights = torch.Generator().manual_seed(seed)
    detector = MaskDetector(dtype=dtype, generator=weights)
    model = ReferenceFill(enc or FLAGSHIP_ENC, FLAGSHIP_DEC, use_att=True,
                          out_size=out_size or (HW, HW), dtype=dtype, generator=weights)
    # gamma starts at zero; at one the attention term reaches the image
    with torch.no_grad():
        model.decoder.attn1.gamma.fill_(1.0)
    return detector.cuda(), model.cuda()


def _counts():
    from face_mask_inpaint_tpu_torch.kernels import launch_counts

    return launch_counts()


@contextlib.contextmanager
def packed_convt(model):
    """The packed-convt configuration (``FMI_PACKED_CONVT=1``) of the same
    model: decoders 3 and 4 run their fused tail, K4b and K4a."""
    model.decoder.packed_convt = True
    try:
        yield
    finally:
        model.decoder.packed_convt = False


def phase_flagship(run: Run, seed: int) -> tuple[dict, dict]:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from face_mask_inpaint_tpu_torch.kernels import reset_launch_counts

    detector, model = _models(seed, torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    src = torch.rand(4, HW, HW, 3, device="cuda", generator=gen)
    ref = torch.rand(4, HW, HW, 3, device="cuda", generator=gen)

    def forward():
        noise = torch.Generator(device="cuda").manual_seed(seed + 1)
        with torch.no_grad():
            mask = detector.predict_mask(src)
            return model(src, ref, mask, generator=noise), mask

    reset_launch_counts()
    out, mask = forward()
    torch.cuda.synchronize()
    launches = _counts()
    print(f"[flagship] launches in one forward: {launches}", flush=True)
    run.check(launches == PER_FORWARD,
              f"flagship forward launches K1 once, K2 ten times and K3 once: {launches}")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        forward()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    _check_launched(run, rows, "flash_fwd_tf32x3_kernel",
                    ("flash_fwd_kernel", "flash_fwd_wgmma_kernel"), "K1 in the f32 flagship forward")
    k1_ms = sum(e.self_device_time_total for e in rows if "flash_fwd" in e.key) / 1e3
    print(f"[flagship] f32 forward, batch 4: K1 {k1_ms:.3f} ms of "
          f"{sum(e.self_device_time_total for e in rows) / 1e3:.3f} ms device time", flush=True)
    del prof
    run.check(tuple(out.shape) == (4, HW, HW, 3), f"output shape {tuple(out.shape)}")
    run.check(bool(torch.isfinite(out).all()), "output finite")
    run.check(float(out.abs().max()) <= 1.0, f"output within [-1, 1]: max |y| {float(out.abs().max()):.4f}")
    print(f"[flagship] mask mean {float(mask.mean()):.4f}")
    with plain_versions():
        out_plain, mask_plain = forward()
    err = float((out - out_plain).abs().max())
    run.check(torch.equal(mask, mask_plain) and err <= 1e-3,
              f"flagship kernel path vs plain versions (float32, batch 4): max_abs_err "
              f"{err:.3e} (tol 1e-3)")
    del out_plain

    # 3b: the packed-convt configuration on the same weights and inputs
    with packed_convt(model):
        reset_launch_counts()
        out_p, _ = forward()
        torch.cuda.synchronize()
        packed_launches = _counts()
        print(f"[packed-convt] launches in one forward: {packed_launches}", flush=True)
        run.check(packed_launches == PACKED_PER_FORWARD,
                  f"packed-convt forward launches K1 once, K2 six times, K4b and K4a twice "
                  f"each and K3 never: {packed_launches}")
        run.check(tuple(out_p.shape) == (4, HW, HW, 3) and bool(torch.isfinite(out_p).all())
                  and float(out_p.abs().max()) <= 1.0,
                  f"packed-convt output shape {tuple(out_p.shape)}, finite, within [-1, 1]")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            forward()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
        _check_launched(run, rows, "conv3x3_tf32x3_kernel",
                        ("conv3x3_kernel", "conv3x3_mma_kernel"),
                        "K4b in the f32 packed-convt forward")
        _check_launched(run, rows, "convt_pair_tf32x3_kernel",
                        ("convt_pair_kernel", "convt_pair_mma_kernel"),
                        "K4a in the f32 packed-convt forward")
        k4b_ms = sum(e.self_device_time_total for e in rows if "conv3x3_" in e.key) / 1e3
        k4a_ms = sum(e.self_device_time_total for e in rows if "convt_pair_" in e.key) / 1e3
        print(f"[packed-convt] f32 forward, batch 4: K4b {k4b_ms:.3f} ms, K4a {k4a_ms:.3f} ms "
              f"of {sum(e.self_device_time_total for e in rows) / 1e3:.3f} ms device time",
              flush=True)
        del prof
        with plain_versions():
            out_pp, _ = forward()
    err = float((out_p - out_pp).abs().max())
    run.check(err <= 1e-3, f"packed-convt kernel path vs plain versions (float32, batch 4): "
                           f"max_abs_err {err:.3e} (tol 1e-3)")
    err = float((out_p - out).abs().max())
    run.check(err <= 1e-3, f"packed-convt vs default configuration (float32, batch 4): "
                           f"max_abs_err {err:.3e} (tol 1e-3)")
    del detector, model
    torch.cuda.empty_cache()
    return launches, packed_launches


def phase_cli(run: Run, seed: int, card: str):
    import torch

    from face_mask_inpaint_tpu_torch.cli import picnet_inference as cli
    from face_mask_inpaint_tpu_torch.evaluations.ssim import ms_ssim, ssim
    from face_mask_inpaint_tpu_torch.kernels import reset_launch_counts

    args = cli.get_args(["--device", "cuda", "--seed", str(seed), "--batch_size", "4",
                         "--decoder_img_f", "256", "--mask_detector_path", "",
                         "--pt_ckpt_path", "", "--out_size", str(HW)])
    detector, generator = cli.build_models(args, cli.resolve_device(args.device))
    infer_batch = cli.make_infer_batch(detector, generator)
    data = torch.Generator(device="cuda").manual_seed(seed + 2)
    noise = torch.Generator(device="cuda").manual_seed(seed)
    reset_launch_counts()
    walls = []
    for step in range(3):
        src = torch.rand(4, HW, HW, 3, device="cuda", generator=data)
        ref = torch.rand(4, HW, HW, 3, device="cuda", generator=data)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gen, mask = infer_batch(src, ref, noise)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        s, ms = float(ssim(ref, gen)), float(ms_ssim(ref, gen))
        run.check(tuple(gen.shape) == (4, HW, HW, 3) and tuple(mask.shape) == (4, HW, HW)
                  and bool(torch.isfinite(gen).all()) and s == s and ms == ms,
                  f"infer_batch step {step}: ssim {s:.4f} ms_ssim {ms:.4f}")
    launches = _counts()
    run.check(launches == {k: 3 * v for k, v in PER_FORWARD.items()},
              f"infer_batch x3 launches: {launches}")
    print(f"[cli] infer_batch, f32 batch 4 (the CLI's path): wall median "
          f"{statistics.median(walls):.2f} ms of {', '.join(f'{w:.2f}' for w in walls)} ms "
          f"(the first call warms up), on {card}", flush=True)
    del detector, generator
    torch.cuda.empty_cache()


def phase_timing(run: Run, seed: int, timings: dict, card: str):
    import torch

    from face_mask_inpaint_tpu_torch.kernels import reset_launch_counts

    batch = 16
    detector, model = _models(seed, torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    src = torch.rand(batch, HW, HW, 3, device="cuda", generator=gen)
    ref = torch.rand(batch, HW, HW, 3, device="cuda", generator=gen)
    noise = torch.Generator(device="cuda").manual_seed(seed + 1)

    def forward():
        with torch.no_grad():
            return model(src, ref, detector.predict_mask(src), generator=noise)

    peaks = {}
    for name, config, want in (("default", contextlib.nullcontext, PER_FORWARD),
                               ("packed-convt", lambda: packed_convt(model),
                                PACKED_PER_FORWARD)):
        with config():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()  # this forward's peak alone
            reset_launch_counts()
            out = forward()
            torch.cuda.synchronize()
            launches = _counts()
            peaks[name] = torch.cuda.max_memory_allocated() / 2 ** 30
        run.check(launches == want
                  and out.dtype == torch.bfloat16 and bool(torch.isfinite(out.float()).all()),
                  f"bf16 batch-16 forward, {name} configuration: {out.dtype}, launches "
                  f"{launches}")
        del out
    sides = {"kernels": contextlib.nullcontext, "packed-convt": lambda: packed_convt(model),
             "plain": plain_versions}
    times = {side: [] for side in sides}
    for r in range(3):  # alternate so drift hits all sides alike
        for side in (list(sides) if r % 2 == 0 else list(sides)[::-1]):
            with sides[side]():
                times[side].append(_time_ms(forward, 3))
    ms = {side: statistics.median(v) for side, v in times.items()}
    timings["flagship"] = (ms["kernels"], ms["plain"])
    timings["packed-convt"] = ms["packed-convt"]
    print(f"[time] flagship forward bf16 batch {batch}: kernels {ms['kernels']:.2f} ms "
          f"({batch / ms['kernels'] * 1e3:.2f} images/s), packed-convt configuration "
          f"{ms['packed-convt']:.2f} ms ({batch / ms['packed-convt'] * 1e3:.2f} images/s), "
          f"plain versions {ms['plain']:.2f} ms ({batch / ms['plain'] * 1e3:.2f} images/s) "
          f"on {card}", flush=True)
    print(f"[time] peak device memory of the bf16 batch-{batch} forward: default "
          f"configuration {peaks['default']:.2f} GiB, packed-convt configuration "
          f"{peaks['packed-convt']:.2f} GiB, on {card}")


def _stage_modules(detector, model) -> dict:
    """The forward's stages, each one module: name -> module."""
    dec = model.decoder
    stages = {"detector": detector.model, "src_encoder": model.src_encoder,
              "ref_encoder": model.ref_encoder, "attention": model.attention,
              "latent branch": dec.generator}
    for i in range(dec.layers):
        stages[f"decoder{i}"] = getattr(dec, f"decoder{i}")
        if i == 1 and dec.use_attn:
            stages["attn1 (K1)"] = dec.attn1
    stages["Output head"] = getattr(dec, f"out{dec.layers - 1}")
    return stages


@contextlib.contextmanager
def dense_head(model):
    """The forward with PR 2's dense tail: decoder 4 adds h + s and the Output
    head runs act, pad, conv and tanh at full size before the pool, with K1
    and K2 still on (the comparison for K3; no fused pool, so no K3)."""
    model._fuse_pool = lambda enc: None
    try:
        yield
    finally:
        del model._fuse_pool


def _check_launched(run: Run, rows, want: str, unwanted: tuple, what: str):
    """That a profiler window's device kernels include ``want`` and none of
    ``unwanted`` (substrings of the kernels' names): the route a wrapper
    took, read from what ran on the card."""
    names = [e.key for e in rows]
    hit = [k for k in names if want in k]
    wrong = [k[:80] for k in names if any(u in k for u in unwanted)]
    run.check(bool(hit) and not wrong, f"{what} ran {want} and none of {unwanted} "
                                       f"(ran: {[k[:80] for k in hit]}, wrong: {wrong})")


def phase_profile(run: Run, seed: int, rounds: int, card: str):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    batch = 16
    detector, model = _models(seed, torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    src = torch.rand(batch, HW, HW, 3, device="cuda", generator=gen)
    ref = torch.rand(batch, HW, HW, 3, device="cuda", generator=gen)
    noise = torch.Generator(device="cuda").manual_seed(seed + 1)

    def forward():
        with torch.no_grad():
            return model(src, ref, detector.predict_mask(src), generator=noise)

    sides = {"kernels": contextlib.nullcontext, "dense head": lambda: dense_head(model),
             "plain": plain_versions}
    configs = {"kernels": contextlib.nullcontext, "dense head": lambda: dense_head(model),
               "packed-convt": lambda: packed_convt(model)}
    for side in configs:
        with configs[side]():
            forward()
            torch.cuda.synchronize()
            events, hooks = {}, []
            for name, mod in _stage_modules(detector, model).items():
                def pre(_m, _a, name=name):
                    events[name] = [torch.cuda.Event(enable_timing=True),
                                    torch.cuda.Event(enable_timing=True)]
                    events[name][0].record()

                def post(_m, _a, _o, name=name):
                    events[name][1].record()

                hooks += [mod.register_forward_pre_hook(pre), mod.register_forward_hook(post)]
            per_stage = {}
            for _ in range(3):
                forward()
                done = torch.cuda.Event(enable_timing=True)
                done.record()
                torch.cuda.synchronize()
                for name, (a, b) in events.items():
                    per_stage.setdefault(name, []).append(a.elapsed_time(b))
                per_stage.setdefault("after the head (pool)", []).append(
                    events[list(events)[-1]][1].elapsed_time(done))
            for h in hooks:
                h.remove()
        stage_ms = {k: statistics.median(v) for k, v in per_stage.items()}
        print(f"[profile] {side}: per stage, median of 3 forwards (ms) on {card}: "
              + ", ".join(f"{k} {v:.3f}" for k, v in stage_ms.items())
              + f"; sum {sum(stage_ms.values()):.3f}", flush=True)

    times = {side: [] for side in sides}
    enqueue = {side: [] for side in sides}
    for r in range(rounds):
        order = list(sides) if r % 2 == 0 else list(sides)[::-1]
        for side in order:
            with sides[side]():
                times[side].append(_time_ms(forward, 3))
                t0 = time.perf_counter()
                forward()
                enqueue[side].append((time.perf_counter() - t0) * 1e3)
                torch.cuda.synchronize()
    for side, v in times.items():
        q = statistics.quantiles(v, n=4) if len(v) > 1 else [v[0]] * 3
        print(f"[profile] {side} forward over {rounds} rounds (ms): median "
              f"{statistics.median(v):.2f}, quartiles {q[0]:.2f}-{q[2]:.2f}, range "
              f"{min(v):.2f}-{max(v):.2f}; host enqueue {min(enqueue[side]):.2f}-"
              f"{max(enqueue[side]):.2f} on {card}", flush=True)

    for side in configs:
        with configs[side]():
            forward()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(3):
                    forward()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
        rows = [e for e in prof.key_averages()  # the device's own events: kernels, copies
                if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
        busy = sum(e.self_device_time_total for e in rows) / 1e3
        print(f"[profile] {side}, three forwards: wall {wall:.2f} ms, summed device time "
              f"{busy:.2f} ms, device busy {100 * busy / wall:.1f}% on {card}")
        _check_launched(run, rows, "flash_fwd_wgmma_kernel",
                        ("flash_fwd_tf32x3_kernel", "flash_fwd_kernel"),
                        f"K1 in the bf16 {side} forward")
        # K2 on its one-read cluster route (neither the two-pass kernels nor
        # the Triton passes it replaced); K3, where it runs, on the tensor
        # cores and not on the CUDA-core kernels
        _check_launched(run, rows, "norm_act_cluster_kernel",
                        ("stats_kernel", "apply_kernel", "norm_act_sums_kernel",
                         "norm_act_scale_kernel"), f"K2 in the bf16 {side} forward")
        if side == "kernels":
            _check_launched(run, rows, "output_head_mma_kernel",
                            ("output_head_tile_kernel", "output_head_cell_kernel"),
                            "K3 in the bf16 default forward")
        kernels = [e for e in rows if not e.key.startswith(("Memcpy", "Memset"))]
        k2 = sum(e.count for e in kernels if "norm_act_" in e.key)
        print(f"[profile] {side}: {sum(e.count for e in kernels) / 3:.0f} device kernels a "
              f"forward ({KERNELS_PER_FORWARD_BEFORE} in the default one before K2's one-launch "
              f"route), {k2 / 3:.0f} of them K2's on {card}")
        if side == "packed-convt":
            _check_launched(run, rows, "conv3x3_mma_kernel",
                            ("conv3x3_kernel", "conv3x3_tf32x3_kernel"),
                            "K4b in the bf16 packed-convt forward")
            _check_launched(run, rows, "convt_pair_mma_kernel",
                            ("convt_pair_kernel", "convt_pair_tf32x3_kernel"),
                            "K4a in the bf16 packed-convt forward")
        for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:15]:
            print(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms {e.count:5d}x  "
                  f"{e.key[:100]}")
    del detector, model
    torch.cuda.empty_cache()


def _train_batch(gen, n: int):
    """A seeded batch on the card: images in [0, 1], NHWC, and a mask of one
    random rectangle a sample, as the trainer's loader hands them over."""
    import torch

    batch = {k: torch.rand(n, HW, HW, 3, device="cuda", generator=gen)
             for k in ("src_img", "gt_img", "ref_img")}
    mask = torch.zeros(n, HW, HW, device="cuda")
    corner = torch.randint(0, HW // 2, (n, 2), device="cuda", generator=gen).tolist()
    for i, (y, x) in enumerate(corner):
        mask[i, y:y + HW // 2, x:x + HW // 2] = 1.0
    batch["mask"] = mask
    return batch


def _trainer(seed: int, dtype: str, batch: int, *flags: str):
    """The trainer CLI's own models, optimizers and step at BASELINE config 5
    (the flagship widths, define_d(ndf=32, img_f=128, layers=5), VGG16 with
    random weights, Adam at 1e-4, lsgan), with ``flags`` added, on the card;
    the decoder attention's gamma, zero at init, set from the seed so the
    attention's gradients are not zero."""
    import torch

    from face_mask_inpaint_tpu_torch.cli import train_reference_fill as cli

    args = cli.get_args(["--device", "cuda", "--seed", str(seed), "--batch_size", str(batch),
                         "--learning_rate", "1e-4", "--decoder_img_f", "256",
                         "--compute_dtype", dtype, "--out_size", str(HW), *flags])
    trainer = cli.Trainer(args, cli.resolve_device(args.device))
    gamma = torch.rand(1, generator=torch.Generator().manual_seed(seed)) + 0.5
    with torch.no_grad():
        trainer.generator.decoder.attn1.gamma.copy_(gamma)
    return trainer


def phase_train(run: Run, seed: int, card: str) -> dict:
    """Phase 7: the config-5 GAN step at batch 16 in bf16, then the f32
    gradient check at batch 2. Returns the launches of one bf16 step."""
    import copy

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from face_mask_inpaint_tpu_torch.kernels import reset_launch_counts

    batch = 16
    trainer = _trainer(seed, "bfloat16", batch)
    data = torch.Generator(device="cuda").manual_seed(seed + 3)
    batches = [_train_batch(data, batch) for _ in range(3)]
    n_params = sum(p.numel() for p in trainer.generator.parameters())
    print(f"[train] config 5: G {n_params} parameters, D "
          f"{sum(p.numel() for p in trainer.discriminator.parameters())}, batch {batch}, "
          f"bfloat16 compute, float32 parameters", flush=True)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    metrics = trainer.train_step(batches[0], noise=trainer.noise)
    torch.cuda.synchronize()
    launches = _counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = {k: float(v) for k, v in metrics.items()}
    print(f"[train] launches in one step: {launches}; losses {losses}", flush=True)
    run.check(launches == PER_STEP, f"config-5 step launches K1 once, K5 once, K2 ten "
                                    f"times, K3 and K4 never: {launches}")
    run.check(all(v == v and abs(v) != float("inf") for v in losses.values()),
              f"config-5 step losses finite: {losses}")
    run.check(all(p.dtype == torch.float32 for p in trainer.generator.parameters()),
              "bf16-mixed: the generator's parameters stay float32")

    times, walls = [], []
    for i in range(2 + STEP_ROUNDS):
        b = batches[i % len(batches)]
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        trainer.train_step(b, noise=trainer.noise)
        end.record()
        torch.cuda.synchronize()
        if i >= 2:
            times.append(start.elapsed_time(end))
            walls.append((time.perf_counter() - t0) * 1e3)
    q = statistics.quantiles(times, n=4)
    print(f"[train] config-5 step, bf16 batch {batch}, {STEP_ROUNDS} steps after 2 warm-up: "
          f"median {statistics.median(times):.2f} ms, quartiles {q[0]:.2f}-{q[2]:.2f}, range "
          f"{min(times):.2f}-{max(times):.2f} ({batch / statistics.median(times) * 1e3:.2f} "
          f"images/s); host wall median {statistics.median(walls):.2f} ms; peak device memory "
          f"of the first step {peak:.2f} GiB, on {card}", flush=True)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches[:2]:
            trainer.train_step(b, noise=trainer.noise)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in rows) / 1e3
    print(f"[train] profile, two steps: wall {wall:.2f} ms, summed device time {busy:.2f} ms, "
          f"device busy {100 * busy / wall:.1f}% on {card}")
    _check_launched(run, rows, "flash_bwd_col_kernel",
                    ("flash_bwd_dq_kernel", "flash_bwd_dv_kernel", "flash_bwd_tf32x3_kernel"),
                    "K5 in the config-5 step")
    _check_launched(run, rows, "flash_fwd_wgmma_kernel",
                    ("flash_fwd_tf32x3_kernel", "flash_fwd_kernel"), "K1 in the config-5 step")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:15]:
        print(f"[train]   {e.self_device_time_total / 1e3:9.3f} ms {e.count:5d}x  {e.key[:100]}")
    del trainer, batches, metrics, prof
    torch.cuda.empty_cache()

    # the kernel path's gradients against the plain path's, f32, batch 2
    trainer = _trainer(seed, "float32", 2)
    b = _train_batch(data, 2)
    eps = [torch.randn(2, HW // 8, HW // 8, 128, device="cuda", generator=data)
           for _ in range(2)]
    start = copy.deepcopy((trainer.generator.state_dict(), trainer.discriminator.state_dict()))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        got = trainer.train_step(b, eps_q=eps[0], eps_p=eps[1], return_grads=True)
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    _check_launched(run, rows, "flash_bwd_tf32x3_kernel",
                    ("flash_bwd_dq_kernel", "flash_bwd_dv_kernel", "flash_bwd_col_kernel"),
                    "K5 in the f32 config-5 step")
    _check_launched(run, rows, "flash_fwd_tf32x3_kernel",
                    ("flash_fwd_kernel", "flash_fwd_wgmma_kernel"), "K1 in the f32 config-5 step")
    del prof
    trainer.generator.load_state_dict(start[0])
    trainer.discriminator.load_state_dict(start[1])
    with plain_versions():
        want = trainer.train_step(b, eps_q=eps[0], eps_p=eps[1], return_grads=True)
    for net in ("g_grads", "d_grads"):
        floor = GRAD_FLOOR * max(float(w.abs().max()) for w in want[net].values())
        used, rel = 0.0, 0.0  # the largest share of its tolerance a tensor uses
        for k, w in want[net].items():
            err = float((got[net][k] - w).abs().max())
            scale = float(w.abs().max())
            used = max(used, err / (GRAD_TOL * scale + floor))
            rel = max(rel, err / scale if scale > floor else 0.0)
        run.check(used <= 1.0, f"config-5 f32 step, batch 2: kernel path vs plain path, {net} "
                               f"({len(want[net])} tensors): max_abs_err uses at most "
                               f"{used:.3f} of its tolerance ({GRAD_TOL} * max|plain| + "
                               f"{GRAD_FLOOR} * the network's largest entry); worst "
                               f"max_abs_err / max|plain| {rel:.3e} over tensors above the floor")
    loss_err = max(abs(float(got[k]) - float(want[k])) / max(abs(float(want[k])), 1e-12)
                   for k in ("G_loss", "D_loss"))
    run.check(loss_err <= 1e-4, f"config-5 f32 step, batch 2: G and D losses of the kernel "
                                f"path within {loss_err:.2e} of the plain path's (tol 1e-4)")
    del trainer, got, want
    torch.cuda.empty_cache()
    return launches


# -- Stack B: pSp -> StyleGAN2 inference at BASELINE config 4 ----------------

def _psp_kernel_shapes(batch: int = 16):
    """The K6 and K7a calls of one config-4 forward, in order: K6 (label,
    input shape, up, down, pad, gain) and K7a output shapes."""
    from face_mask_inpaint_tpu_torch.models.stylegan2 import channels_for

    ch = channels_for(1024)
    k6, k7 = [], [(batch, ch[4], 4, 4)]
    for r in (2 ** i for i in range(3, 11)):
        k6.append((f"blur {r}^2", (batch, ch[r], r + 1, r + 1), 1, 1, (1, 1), 4.0))
        k6.append((f"skip up {r}^2", (batch, 3, r // 2, r // 2), 2, 1, (2, 1), 4.0))
        k7 += [(batch, ch[r], r, r)] * 2
    return k6, k7


def _k6_library(x, taps, up, pad):
    """K6's yardstick: one depthwise cuDNN call on the same input, conv2d
    for the blur (symmetric pad), conv_transpose2d(stride 2, groups=C) for the
    upsample (pads (2, 1) of a 4-tap filter are padding 1 there). Timed
    here only; the port never calls it."""
    import torch
    import torch.nn.functional as F

    c = x.shape[1]
    k = torch.as_tensor(taps, dtype=x.dtype, device=x.device)
    w = (k[:, None] * k[None, :]).flip(0, 1).expand(c, 1, len(taps), len(taps)).contiguous()
    if up == 1:
        return F.conv2d(x, w, padding=pad[0], groups=c)
    return F.conv_transpose2d(x, w.flip(2, 3), stride=2, padding=1, groups=c)


def _k6_close(got, want, x, taps, up, down, pad, dname):
    """(ok, max_abs_err) for K6: |kernel - plain| <= atol + rtol (|plain| + M)
    with M = upfirdn2d(|x|, |taps|), the sum of the output's terms'
    magnitudes. Each side rounds the H pass and the output once; where the
    f32 sums of the two sides fall on either side of a rounding boundary, an
    intermediate moves by one ulp and the output by at most rtol * M."""
    from face_mask_inpaint_tpu_torch.kernels import upfirdn2d as fir

    atol, rtol = TOL[dname]
    m = fir.upfirdn2d_plain(x.float().abs(), [abs(t) for t in taps], up, down, pad)
    err = (got.float() - want.float()).abs()
    return bool((err <= atol + rtol * (want.float().abs() + m)).all()), float(err.max())


def phase_stackb_kernels(run: Run, seed: int, timings: dict):
    """K6 and K7a against their plain versions, float32 and bfloat16, at the
    config-4 shapes and ragged ones; bfloat16 times summed over the calls of
    one batch-16 forward."""
    import math

    import torch
    import torch.nn.functional as F

    from face_mask_inpaint_tpu_torch.kernels import fused_act as act
    from face_mask_inpaint_tpu_torch.kernels import upfirdn2d as fir
    from face_mask_inpaint_tpu_torch.ops.upfirdn2d import make_taps

    gen = torch.Generator(device="cuda").manual_seed(seed + 5)
    k6_shapes, k7_shapes = _psp_kernel_shapes()
    blur = [1, 3, 3, 1]
    k6_cases = [c for c in k6_shapes if c[0] in ("blur 1024^2", "blur 512^2", "skip up 512^2")]
    k6_cases += [("ragged", (2, 1, 37, 41), 1, 1, (1, 1), 4.0),
                 ("ragged", (3, 3, 19, 27), 2, 1, (2, 1), 4.0),
                 ("ragged", (2, 5, 33, 21), 1, 2, (1, 1), 1.0)]
    # several of the fused kernel's tiles in both axes, ragged at the edges,
    # on the blurs' unaligned 1025- and 513-wide rows and odd plane counts
    k6_cases += [("several tiles", (1, 3, 100, 1025), 1, 1, (1, 1), 4.0),
                 ("several tiles", (3, 1, 513, 513), 1, 1, (1, 1), 4.0),
                 ("several tiles", (2, 5, 70, 513), 2, 1, (2, 1), 4.0),
                 ("several tiles", (3, 1, 130, 1025), 1, 2, (1, 1), 1.0)]
    asym = [("asymmetric", (2, 3, 23, 17), up, down, pad, float(up * up))
            for up, down, pad in ((1, 1, (2, 1)), (2, 1, (1, 2)), (1, 2, (2, 2)))]
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for label, shape, up, down, pad, gain in k6_cases + asym:
            taps = [float(t) for t in make_taps([1, 2, 3, 4] if label == "asymmetric"
                                                else blur, gain)]
            x = torch.randn(shape, device="cuda", generator=gen).to(dtype)
            y = fir.upfirdn2d(x, taps, up, down, pad)
            torch.cuda.synchronize()
            ok, err = _k6_close(y, fir.upfirdn2d_plain(x, taps, up, down, pad), x, taps, up,
                                down, pad, dname)
            run.err["upfirdn2d"] = max(run.err["upfirdn2d"], err)
            run.check(ok, f"K6 {label} {list(shape)} up={up} down={down} pad={pad} taps="
                          f"{'1234' if label == 'asymmetric' else '1331'} {dname}: max_abs_err "
                          f"{err:.3e} (tol atol {TOL[dname][0]} + rtol {TOL[dname][1]:.3e}*"
                          f"(|ref| + upfirdn2d(|x|, |taps|)))")
            del x, y
        k7_cases = [("1024^2 StyledConv", k7_shapes[-1], True), ("ragged", (3, 5, 37, 41), True),
                    ("ragged rows", (7, 13), True), ("ragged, no bias", (2, 3, 9, 11), False)]
        for label, shape, with_bias in k7_cases:
            x = (torch.randn(shape, device="cuda", generator=gen) * 2).to(dtype)
            b = torch.randn(shape[1], device="cuda", generator=gen) if with_bias else None
            y = act.fused_leaky_relu(x, b)
            torch.cuda.synchronize()
            ok, err = _close(y, act.fused_leaky_relu_plain(x, b), dname)
            run.err["fused_leaky_relu"] = max(run.err["fused_leaky_relu"], err)
            run.check(ok, f"K7a {label} {list(shape)} {dname}: max_abs_err {err:.3e} (tol atol "
                          f"{TOL[dname][0]} + rtol {TOL[dname][1]:.3e}*|ref|)")
            del x, y
        torch.cuda.empty_cache()

    # bfloat16 times over one batch-16 forward's calls
    dtype = torch.bfloat16
    sums = {k: dict(ms=0.0, plain=0.0, lib=0.0, nbytes=0.0, ops=0.0) for k in ("k6", "k7")}
    for label, shape, up, down, pad, gain in k6_shapes:
        taps = [float(t) for t in make_taps(blur, gain)]
        x = torch.randn(shape, device="cuda", generator=gen).to(dtype)
        y = fir.upfirdn2d(x, taps, up, down, pad)
        lib = _k6_library(x, taps, up, pad)
        torch.cuda.synchronize()
        err = float((lib.float() - y.float()).abs().max()) / float(y.float().abs().max())
        run.check(err <= 2.0 ** -5, f"K6 yardstick {label}: the depthwise cuDNN call computes "
                                    f"the same function (max_abs_err {err:.3e} of max |y|, "
                                    f"tol 2^-5: a misplaced tap errs by O(1))")
        t = sums["k6"]
        t["ms"] += _time_ms(lambda: fir.upfirdn2d(x, taps, up, down, pad), 5)
        t["plain"] += _time_ms(lambda: fir.upfirdn2d_plain(x, taps, up, down, pad), 3)
        t["lib"] += _time_ms(lambda: _k6_library(x, taps, up, pad), 5)
        # x read once, y written once; two passes of len(taps) / up multiply-adds
        t["nbytes"] += (x.numel() + y.numel()) * x.element_size()
        t["ops"] += 2.0 * 2 * y.numel() * len(taps) / up
        del x, y, lib
    for shape in k7_shapes:
        x = torch.randn(shape, device="cuda", generator=gen).to(dtype)
        b = torch.randn(shape[1], device="cuda", generator=gen)
        t = sums["k7"]
        t["ms"] += _time_ms(lambda: act.fused_leaky_relu(x, b), 5)
        t["plain"] += _time_ms(lambda: act.fused_leaky_relu_plain(x, b), 5)
        t["lib"] += _time_ms(lambda: F.leaky_relu(x + b.to(dtype)[None, :, None, None], 0.2)
                             * math.sqrt(2.0), 5)
        t["nbytes"] += 2 * x.numel() * x.element_size() + b.numel() * 4
        t["ops"] += 4.0 * x.numel()
        del x
    torch.cuda.empty_cache()
    for key, name, what in (("k6", "upfirdn2d", "K6, 16 calls"),
                            ("k7", "fused_leaky_relu", "K7a, 17 calls")):
        t = sums[key]
        bound = _bound(t["nbytes"], t["ops"], F32_RATE)
        timings[(name, "bfloat16")] = (t["ms"], t["plain"], *bound, t["lib"])
        print(f"[time] {what} of one config-4 forward, bf16 batch 16: kernel {t['ms']:.3f} ms, "
              f"plain {t['plain']:.3f} ms, library {t['lib']:.3f} ms, bound {bound[0]:.3f} ms "
              f"({bound[1]}, {t['nbytes'] / 1e9:.3f} GB)", flush=True)


def phase_psp(run: Run, seed: int) -> dict:
    """The CLI's models at config-4 widths, batch 2, float32: one forward's
    launches, its output, the kernel path against the plain path; then
    infer_batch over seeded batches and one ModelInterface.infer. Returns
    the launches of one forward."""
    import numpy as np
    import torch
    from PIL import Image

    from face_mask_inpaint_tpu_torch.cli import gradio_serve
    from face_mask_inpaint_tpu_torch.cli import psp_inference as cli
    from face_mask_inpaint_tpu_torch.evaluations.ssim import ssim
    from face_mask_inpaint_tpu_torch.kernels import reset_launch_counts

    batch = 2
    args = cli.get_args(["--device", "cuda", "--seed", str(seed), "--batch_size", str(batch),
                         "--use_ref", "--use_attention", "1", "--mask_detector_path", "",
                         "--pt_ckpt_path", "", "--output_size", "1024"])
    detector, psp = cli.build_models(args, cli.resolve_device(args.device))
    infer_batch = cli.make_infer_batch(detector, psp, args.use_ref)
    print(f"[psp] config 4: {sum(p.numel() for p in psp.parameters())} parameters, "
          f"{psp.n_styles} styles, output {psp.output_size}^2 pooled to 256^2", flush=True)
    data = torch.Generator(device="cuda").manual_seed(seed + 6)
    src = torch.rand(batch, HW, HW, 3, device="cuda", generator=data) * 2 - 1
    ref = torch.rand(batch, HW, HW, 3, device="cuda", generator=data) * 2 - 1

    reset_launch_counts()
    out, mask = infer_batch(src, ref)
    torch.cuda.synchronize()
    launches = _counts()
    print(f"[psp] launches in one forward: {launches}", flush=True)
    run.check(launches == PSP_PER_FORWARD,
              f"pSp forward launches K6 16 times, K7a 17 times, K1-K5 never: {launches}")
    run.check(tuple(out.shape) == (batch, HW, HW, 3) and bool(torch.isfinite(out).all()),
              f"pSp output {tuple(out.shape)} finite, max |y| {float(out.abs().max()):.4f}")
    print(f"[psp] mask mean {float(mask.mean()):.4f}")
    with plain_versions():
        out_plain, mask_plain = infer_batch(src, ref)
    err = float((out - out_plain).abs().max())
    scale = float(out_plain.abs().max())
    run.check(torch.equal(mask, mask_plain) and err <= PSP_TOL * scale,
              f"pSp kernel path vs plain versions (float32, batch {batch}): max_abs_err "
              f"{err:.3e}, {err / scale:.3e} of max |plain| {scale:.3e} (tol {PSP_TOL})")
    del out_plain, mask_plain

    reset_launch_counts()
    for step in range(3):
        s = torch.rand(batch, HW, HW, 3, device="cuda", generator=data) * 2 - 1
        r = torch.rand(batch, HW, HW, 3, device="cuda", generator=data) * 2 - 1
        gen, m = infer_batch(s, r)
        score = float(ssim((r + 1) / 2, (gen.float() + 1) / 2))
        run.check(tuple(gen.shape) == (batch, HW, HW, 3) and tuple(m.shape) == (batch, HW, HW)
                  and bool(torch.isfinite(gen).all()) and score == score,
                  f"pSp infer_batch step {step}: ssim against the reference {score:.4f}")
    launches3 = _counts()
    run.check(launches3 == {k: 3 * v for k, v in PSP_PER_FORWARD.items()},
              f"pSp infer_batch x3 launches: {launches3}")
    del detector, psp, infer_batch
    torch.cuda.empty_cache()

    model = gradio_serve.ModelInterface(gradio_serve.get_args(
        ["--device", "cuda", "--seed", str(seed), "--use_attention", "1"]),
        torch.device("cuda"))
    rng = np.random.RandomState(seed)
    src_img = Image.fromarray(rng.randint(0, 255, (300, 260, 3), dtype=np.uint8))
    ref_img = Image.fromarray(rng.randint(0, 255, (300, 260, 3), dtype=np.uint8))
    reset_launch_counts()
    gen_img, mask_img = model.infer(src_img, ref_img)
    served = _counts()
    run.check(gen_img.shape == (300, 260, 3) and gen_img.dtype == np.uint8
              and mask_img.shape == (300, 260, 3) and served == PSP_PER_FORWARD,
              f"ModelInterface.infer on the card: {gen_img.shape} {gen_img.dtype}, launches "
              f"{served}")
    del model
    torch.cuda.empty_cache()
    return launches


def phase_psp_timing(run: Run, seed: int, rounds: int, card: str):
    """Config 4 at batch 16 in bfloat16, built as bench.py builds it: the
    forward in turns with the kernels and the plain versions, its peak
    device memory, and a torch.profiler window."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from face_mask_inpaint_tpu_torch.cli.psp_inference import make_infer_batch
    from face_mask_inpaint_tpu_torch.kernels import reset_launch_counts
    from face_mask_inpaint_tpu_torch.models.psp import PSP
    from face_mask_inpaint_tpu_torch.models.unet import MaskDetector

    batch, dtype = 16, torch.bfloat16
    weights = torch.Generator(device="cuda").manual_seed(seed)
    with torch.device("cuda"):
        detector = MaskDetector(dtype=dtype, generator=weights)
        psp = PSP(output_size=1024, use_attention=True, dtype=dtype, generator=weights).eval()
    forward = make_infer_batch(detector, psp, use_ref=True)
    data = torch.Generator(device="cuda").manual_seed(seed + 7)
    src = torch.rand(batch, HW, HW, 3, device="cuda", generator=data) * 2 - 1
    ref = torch.rand(batch, HW, HW, 3, device="cuda", generator=data) * 2 - 1

    forward(src, ref)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() / 2 ** 30
    reset_launch_counts()
    out, _ = forward(src, ref)
    torch.cuda.synchronize()
    launches = _counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    run.check(launches == PSP_PER_FORWARD and out.dtype == dtype
              and tuple(out.shape) == (batch, HW, HW, 3) and bool(torch.isfinite(out.float()).all()),
              f"config-4 forward, bf16 batch {batch}: {out.dtype} {tuple(out.shape)} finite, "
              f"launches {launches}")
    del out
    sides = {"kernels": contextlib.nullcontext, "plain": plain_versions}
    times = {side: [] for side in sides}
    enqueue = {side: [] for side in sides}
    for r in range(rounds):
        for side in (list(sides) if r % 2 == 0 else list(sides)[::-1]):
            with sides[side]():
                times[side].append(_time_ms(lambda: forward(src, ref), 3))
                t0 = time.perf_counter()
                forward(src, ref)
                enqueue[side].append((time.perf_counter() - t0) * 1e3)
                torch.cuda.synchronize()
    for side, v in times.items():
        q = statistics.quantiles(v, n=4)
        print(f"[psp] config-4 forward, bf16 batch {batch}, {side}, {rounds} rounds (ms): median "
              f"{statistics.median(v):.2f}, quartiles {q[0]:.2f}-{q[2]:.2f}, range "
              f"{min(v):.2f}-{max(v):.2f} ({batch / statistics.median(v) * 1e3:.2f} images/s); "
              f"host enqueue {min(enqueue[side]):.2f}-{max(enqueue[side]):.2f} ms on {card}",
              flush=True)
    print(f"[psp] peak device memory of the bf16 batch-{batch} forward {peak:.2f} GiB "
          f"({base:.2f} GiB of it weights and inputs) on {card}", flush=True)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            forward(src, ref)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in rows) / 1e3
    print(f"[psp] profile, three forwards: wall {wall:.2f} ms, summed device time {busy:.2f} ms, "
          f"device busy {100 * busy / wall:.1f}% on {card}")
    _check_launched(run, rows, "upfirdn2d_kernel", ("upfirdn1d_kernel",),
                    "K6 in the bf16 config-4 forward")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:20]:
        print(f"[psp]   {e.self_device_time_total / 1e3:9.3f} ms {e.count:5d}x  {e.key[:100]}")
    del detector, psp, forward, prof
    torch.cuda.empty_cache()


# -- Stack B training: the backward kernels and the config-4 trainer ---------

def _k6_bwd_library(g, taps, up, pad):
    """K6's backward yardstick: the gradient of ``_k6_library``'s call as one
    depthwise cuDNN call on the same output gradient, conv_transpose2d for
    the blur, conv2d(stride 2) for the upsample. Timed here only; the port
    never calls it."""
    import torch
    import torch.nn.functional as F

    c = g.shape[1]
    k = torch.as_tensor(taps, dtype=g.dtype, device=g.device)
    w = (k[:, None] * k[None, :]).flip(0, 1).expand(c, 1, len(taps), len(taps)).contiguous()
    if up == 1:
        return F.conv_transpose2d(g, w, padding=pad[0], groups=c)
    return F.conv2d(g, w.flip(2, 3), stride=2, padding=1, groups=c)


def _function_grads_check(run: Run, gen):
    """Both Functions against autograd of their plain versions (f32, one
    small shape each): the gradients, and grad-of-grad through them."""
    import torch

    from face_mask_inpaint_tpu_torch.kernels import fused_act as act
    from face_mask_inpaint_tpu_torch.kernels import upfirdn2d as fir
    from face_mask_inpaint_tpu_torch.ops.upfirdn2d import make_taps

    taps = [float(t) for t in make_taps([1, 2, 3, 4], 4.0)]
    for up, down, pad in ((1, 1, (1, 1)), (2, 1, (2, 1)), (1, 2, (1, 1))):
        x = torch.randn(2, 3, 18, 18, device="cuda", generator=gen, requires_grad=True)
        errs = []
        for fn in (fir.upfirdn2d, fir.upfirdn2d_plain):
            y = fn(x, taps, up, down, pad)
            g = torch.linspace(-1, 1, y.numel(), device="cuda").view_as(y).requires_grad_()
            (dx,) = torch.autograd.grad(y, x, g, create_graph=True)
            (dg,) = torch.autograd.grad((dx * dx).sum(), g)
            errs.append((dx, dg))
        err = max(float((a - b).abs().max()) / float(b.abs().max())
                  for a, b in zip(*errs))
        run.check(err <= 1e-5, f"K6 Function up={up} down={down}: dx and d(|dx|^2)/dg vs "
                               f"autograd of the plain version, {err:.3e} of max |plain| "
                               f"(tol 1e-5, f32)")
    x = torch.randn(2, 5, 9, 11, device="cuda", generator=gen, requires_grad=True)
    b = torch.randn(5, device="cuda", generator=gen, requires_grad=True)
    outs = []
    for fn in (act.fused_leaky_relu, act.fused_leaky_relu_plain):
        y = fn(x, b)
        g = torch.linspace(-1, 1, y.numel(), device="cuda").view_as(y).requires_grad_()
        dx, db = torch.autograd.grad(y, (x, b), g, create_graph=True)
        (dg,) = torch.autograd.grad((dx * dx).sum() + db.sum(), g)
        outs.append((dx, db, dg))
    err = max(float((a - b_).abs().max()) / float(b_.abs().max()) for a, b_ in zip(*outs))
    run.check(err <= 1e-6, f"K7a/K7b Function: dx, dbias and the grad-of-grad vs autograd of "
                           f"the plain version, {err:.3e} of max |plain| (tol 1e-6, f32)")


def phase_stackb_backward(run: Run, seed: int, timings: dict):
    """K7b and K6's backward against their plain versions, float32 and
    bfloat16, at the shapes of one config-4 training step (batch 8) and
    ragged ones; dbias against the plain f32 channel sum; the Functions
    against autograd of the plain versions; float32 times summed over the
    calls of one batch-8 step."""
    import torch

    from face_mask_inpaint_tpu_torch.kernels import fused_act as act
    from face_mask_inpaint_tpu_torch.kernels import upfirdn2d as fir
    from face_mask_inpaint_tpu_torch.ops.upfirdn2d import make_taps

    gen = torch.Generator(device="cuda").manual_seed(seed + 9)
    k6_shapes, k7_shapes = _psp_kernel_shapes(batch=8)
    blur = [1, 3, 3, 1]
    scale, slope = math.sqrt(2.0), 0.2
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        k7_cases = [(f"StyledConv {s[2]}^2", s) for s in k7_shapes[::2]] + [
            ("ragged C=1", (2, 1, 37, 41)), ("ragged C=3", (3, 3, 19, 27)),
            ("ragged C=5", (2, 5, 33, 21))]
        for label, shape in k7_cases:
            y = (torch.randn(shape, device="cuda", generator=gen) * 2).to(dtype)
            g = torch.randn(shape, device="cuda", generator=gen).to(dtype)
            dx = act.fused_leaky_relu_bwd(y, g)
            torch.cuda.synchronize()
            ok, err = _close(dx, act.fused_leaky_relu_bwd_plain(y, g), dname)
            run.err["fused_leaky_relu_bwd"] = max(run.err["fused_leaky_relu_bwd"], err)
            run.check(ok, f"K7b {label} {list(shape)} {dname}: max_abs_err {err:.3e} (tol atol "
                          f"{TOL[dname][0]} + rtol {TOL[dname][1]:.3e}*|ref|)")
            del y, g, dx
        # dbias: the channel sum of K7b's dx through the Function, in f32
        x = torch.randn(k7_shapes[-1], device="cuda", generator=gen).to(dtype)
        b = torch.randn(x.shape[1], device="cuda", generator=gen).to(dtype).requires_grad_()
        x.requires_grad_()
        y = act.fused_leaky_relu(x, b)
        g = torch.randn(y.shape, device="cuda", generator=gen).to(dtype)
        dx, db = torch.autograd.grad(y, (x, b), g)
        want = act.fused_leaky_relu_bwd_plain(y.detach(), g).float().sum(dim=(0, 2, 3))
        ok, err = _close(db, want.to(dtype), dname)
        run.check(ok and db.dtype == dtype, f"dbias {list(x.shape)} {dname}: max_abs_err "
                                            f"{err:.3e} against the plain f32 channel sum")
        del x, b, y, g, dx, db
        for label, shape, up, down, pad, gain in k6_shapes + [
                ("ragged blur", (2, 1, 38, 42), 1, 1, (1, 1), 4.0),
                ("ragged skip up", (3, 3, 19, 27), 2, 1, (2, 1), 4.0)]:
            taps = [float(t) for t in make_taps(blur, gain)]
            h, w = shape[2:]
            ho = fir.out_len(h, up, down, *pad, len(taps))
            wo = fir.out_len(w, up, down, *pad, len(taps))
            gpad = fir.transposed_pads(h, ho, len(taps), up, down, pad[0])
            g = torch.randn(shape[0], shape[1], ho, wo, device="cuda", generator=gen).to(dtype)
            dx = fir.upfirdn2d_bwd(g, taps, up, down, pad, (h, w))
            torch.cuda.synchronize()
            ok, err = _k6_close(dx, fir.upfirdn2d_plain(g, taps[::-1], down, up, gpad), g,
                                taps[::-1], down, up, gpad, dname)
            ok = ok and tuple(dx.shape) == tuple(shape) and min(gpad) >= 0
            run.err["upfirdn2d_bwd"] = max(run.err["upfirdn2d_bwd"], err)
            run.check(ok, f"K6 backward {label} grad {list(g.shape)} mode ({down}, {up}) pads "
                          f"{gpad} {dname}: max_abs_err {err:.3e} (K6's tolerance)")
            del g, dx
        torch.cuda.empty_cache()
    _function_grads_check(run, gen)

    # float32 times over one batch-8 training step's calls
    dtype = torch.float32
    sums = {k: dict(ms=0.0, plain=0.0, lib=0.0, nbytes=0.0, ops=0.0) for k in ("k6", "k7")}
    for label, shape, up, down, pad, gain in k6_shapes:
        taps = [float(t) for t in make_taps(blur, gain)]
        h, w = shape[2:]
        ho = fir.out_len(h, up, down, *pad, len(taps))
        wo = fir.out_len(w, up, down, *pad, len(taps))
        gpad = fir.transposed_pads(h, ho, len(taps), up, down, pad[0])
        g = torch.randn(shape[0], shape[1], ho, wo, device="cuda", generator=gen)
        dx = fir.upfirdn2d_bwd(g, taps, up, down, pad, (h, w))
        lib = _k6_bwd_library(g, taps, up, pad)
        torch.cuda.synchronize()
        err = float((lib - dx).abs().max()) / float(dx.abs().max())
        run.check(err <= 1e-5, f"K6 backward yardstick {label}: the depthwise cuDNN gradient "
                               f"computes the same function ({err:.3e} of max |dx|, tol 1e-5)")
        t = sums["k6"]
        t["ms"] += _time_ms(lambda: fir.upfirdn2d_bwd(g, taps, up, down, pad, (h, w)), 5)
        t["plain"] += _time_ms(lambda: fir.upfirdn2d_plain(g, taps[::-1], down, up, gpad), 3)
        t["lib"] += _time_ms(lambda: _k6_bwd_library(g, taps, up, pad), 5)
        # g read once, dx written once; two passes of len(taps) / up' multiply-adds
        t["nbytes"] += (g.numel() + dx.numel()) * g.element_size()
        t["ops"] += 2.0 * 2 * dx.numel() * len(taps) / down
        del g, dx, lib
    for shape in k7_shapes:
        y = torch.randn(shape, device="cuda", generator=gen)
        g = torch.randn(shape, device="cuda", generator=gen)
        t = sums["k7"]
        t["ms"] += _time_ms(lambda: act.fused_leaky_relu_bwd(y, g), 5)
        t["plain"] += _time_ms(lambda: act.fused_leaky_relu_bwd_plain(y, g), 5)
        t["lib"] += _time_ms(lambda: g * torch.where(y >= 0, scale, slope * scale), 5)
        # y and g read once, dx written once; a compare and a multiply each
        t["nbytes"] += 3 * y.numel() * y.element_size()
        t["ops"] += 2.0 * y.numel()
        del y, g
    torch.cuda.empty_cache()
    for key, name, what in (("k6", "upfirdn2d_bwd", "K6 backward, 16 calls"),
                            ("k7", "fused_leaky_relu_bwd", "K7b, 17 calls")):
        t = sums[key]
        bound = _bound(t["nbytes"], t["ops"], F32_RATE)
        timings[(name, "float32")] = (t["ms"], t["plain"], *bound, t["lib"])
        print(f"[time] {what} of one config-4 training step, f32 batch 8: kernel "
              f"{t['ms']:.3f} ms, plain {t['plain']:.3f} ms, library {t['lib']:.3f} ms, bound "
              f"{bound[0]:.3f} ms ({bound[1]}, {t['nbytes'] / 1e9:.3f} GB)", flush=True)


def _psp_train_batch(gen, n: int):
    """A seeded batch as the pSp trainer's loader hands it over: images
    normalized to [-1, 1], NHWC, and a mask of one random rectangle each."""
    batch = _train_batch(gen, n)
    for k in ("src_img", "gt_img", "ref_img"):
        batch[k] = batch[k] * 2 - 1
    return batch


def _psp_grads(trainer, batch, cfg):
    """The loss and the gradients of every trainable tensor for one batch
    with the fixed noise, without an update (zero for the style MLP, which
    a pSp forward from w+ codes does not run)."""
    import torch

    from face_mask_inpaint_tpu_torch.train.psp import _forward_loss

    named = [(n, p) for n, p in trainer.psp.named_parameters() if p.requires_grad]
    loss, _, _ = _forward_loss(trainer.psp, cfg, trainer.nets, batch, True, False, True, None)
    grads = torch.autograd.grad(loss, [p for _, p in named], allow_unused=True)
    return float(loss.detach()), {n: torch.zeros_like(p) if g is None else g
                                  for (n, p), g in zip(named, grads)}


def phase_psp_train(run: Run, seed: int, card: str) -> dict:
    """Stack B training at config 4 (the recipe of PSP_TRAIN_ARGS), built
    through the trainer CLI's ``get_args`` and ``Trainer``: at batch 2 in
    float32 with the fixed noise, the kernel path's gradients against the
    plain path's; at batch 8, the launches of one step, its losses, and the
    step time, peak memory and device-busy share. Returns the launches of
    one step."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from face_mask_inpaint_tpu_torch.cli import train_psp as cli
    from face_mask_inpaint_tpu_torch.kernels import reset_launch_counts

    batch = 8
    args = cli.get_args(["--device", "cuda", "--seed", str(seed), "--batch_size", str(batch),
                         *PSP_TRAIN_ARGS])
    t0 = time.perf_counter()
    trainer = cli.Trainer(args, cli.resolve_device(args.device))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in trainer.psp.parameters())
    n_train = sum(p.numel() for p in trainer.psp.parameters() if p.requires_grad)
    print(f"[psp-train] config 4: {n_params} parameters, {n_train} trained, loss nets "
          f"{sorted(trainer.nets)}, built in {time.perf_counter() - t0:.1f} s", flush=True)
    data = torch.Generator(device="cuda").manual_seed(seed + 11)

    # (a) kernel path vs plain path, f32, batch 2, fixed noise; cuDNN's
    # deterministic algorithms, so that the two runs differ only where the
    # kernels and their plain versions do
    b2 = _psp_train_batch(data, 2)
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        loss_k, got = _psp_grads(trainer, b2, trainer.cfg)
        with plain_versions():
            loss_p, want = _psp_grads(trainer, b2, trainer.cfg)
    finally:
        cudnn.deterministic, cudnn.benchmark = saved
    for part in ("encoder", "decoder"):
        keys = [k for k in want if k.startswith(part + ".")]
        floor = GRAD_FLOOR * max(float(want[k].abs().max()) for k in keys)
        used, rel = 0.0, 0.0
        for k in keys:
            err = float((got[k] - want[k]).abs().max())
            scale = float(want[k].abs().max())
            used = max(used, err / (GRAD_TOL * scale + floor))
            rel = max(rel, err / scale if scale > floor else 0.0)
        run.check(used <= 1.0, f"config-4 f32 step, batch 2: kernel path vs plain path, {part} "
                               f"({len(keys)} tensors): max_abs_err uses at most {used:.3f} of "
                               f"its tolerance ({GRAD_TOL} * max|plain| + {GRAD_FLOOR} * "
                               f"the part's largest entry); worst max_abs_err / max|plain| "
                               f"{rel:.3e} over tensors above the floor")
    run.check(abs(loss_k - loss_p) <= 1e-4 * abs(loss_p),
              f"config-4 f32 loss, batch 2: kernel path {loss_k:.6f}, plain path {loss_p:.6f}")
    del got, want, b2
    torch.cuda.empty_cache()

    # (b) one batch-8 step: launches, losses, the guard
    batches = [_psp_train_batch(data, batch) for _ in range(3)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    metrics = trainer.train_step(batches[0], noise=trainer.noise)
    torch.cuda.synchronize()
    launches = _counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = {k: float(v) for k, v in metrics.items()}
    print(f"[psp-train] launches in one step: {launches}; losses {losses}", flush=True)
    run.check(launches == PSP_PER_STEP, f"config-4 step launches K6 16 + 16, K7a 17, K7b 17, "
                                        f"K1-K5 never: {launches}")
    run.check(all(math.isfinite(v) for v in losses.values())
              and losses["skipped_nonfinite"] == 0.0,
              f"config-4 step losses finite, skipped_nonfinite 0: {losses}")

    # (c) step time after two warm-up steps
    times, walls = [], []
    for i in range(2 + STEP_ROUNDS):
        b = batches[i % len(batches)]
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        trainer.train_step(b, noise=trainer.noise)
        end.record()
        torch.cuda.synchronize()
        if i >= 2:
            times.append(start.elapsed_time(end))
            walls.append((time.perf_counter() - t0) * 1e3)
    q = statistics.quantiles(times, n=4)
    print(f"[psp-train] config-4 step, f32 (TF32 off) batch {batch}, {STEP_ROUNDS} steps after 2 "
          f"warm-up: median {statistics.median(times):.2f} ms, quartiles {q[0]:.2f}-{q[2]:.2f}, "
          f"range {min(times):.2f}-{max(times):.2f} ({batch / statistics.median(times) * 1e3:.2f} "
          f"images/s); host wall median {statistics.median(walls):.2f} ms; peak device memory of "
          f"the first step {peak:.2f} GiB, on {card}", flush=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches[:2]:
            trainer.train_step(b, noise=trainer.noise)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in rows) / 1e3
    print(f"[psp-train] profile, two steps: wall {wall:.2f} ms, summed device time {busy:.2f} ms, "
          f"device busy {100 * busy / wall:.1f}% on {card}")
    _check_launched(run, rows, "upfirdn2d_kernel", ("upfirdn1d_kernel",),
                    "K6 in the f32 config-4 step (its forward and backward calls)")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:20]:
        print(f"[psp-train]   {e.self_device_time_total / 1e3:9.3f} ms {e.count:5d}x  "
              f"{e.key[:100]}")
    del trainer, batches, metrics, prof
    torch.cuda.empty_cache()
    return launches


# -- Stack C training, reference checkpoints and FID: no TPU kernel ----------

def _no_launches(run: Run, what: str) -> None:
    launches = _counts()
    run.check(not any(launches.values()), f"{what} launches none of K1-K7: {launches}")


def unet_reference_state_dict(detector) -> dict:
    """The reference mask detector's layout (a ``model.``-prefixed UNet of
    unet_parts.py's Sequential indices) of the port detector's state dict,
    through UNET_REFERENCE_KEYS; torch's ``num_batches_tracked`` added."""
    import torch

    out = {}
    for key, value in detector.state_dict().items():
        name = key
        for pat, rep in UNET_REFERENCE_KEYS:
            name = re.sub(pat, rep, name)
        out[name] = value.detach().cpu().clone()
        if name.endswith("running_var"):
            out[name[:-len("running_var")] + "num_batches_tracked"] = torch.tensor(0)
    return out


def _unet_batch(gen, n: int, hw: int, device):
    """Seeded images in [0, 1] and labels of one random rectangle each."""
    import torch

    image = torch.rand(n, hw, hw, 3, device=device, generator=gen)
    mask = torch.zeros(n, hw, hw, dtype=torch.long, device=device)
    corner = torch.randint(0, hw // 2, (n, 2), device=device, generator=gen).tolist()
    for i, (y, x) in enumerate(corner):
        mask[i, y:y + hw // 2, x:x + hw // 4] = 1
    return {"image": image, "mask": mask}


def _write_unet_tree(root, n: int, hw: int, seed: int) -> tuple[str, str]:
    """``<id>_surgical.jpg`` images and ``<id>.npy`` masks, the layout of
    the JAX CLI's images_masked / binary_map folders."""
    import numpy as np
    from PIL import Image

    img_dir, mask_dir = root / "images_masked", root / "binary_map"
    img_dir.mkdir(parents=True)
    mask_dir.mkdir()
    rs = np.random.RandomState(seed)
    for i in range(n):
        img = rs.randint(0, 256, (hw, hw, 3)).astype(np.uint8)
        mask = np.zeros((hw, hw), np.uint8)
        y, x = rs.randint(0, hw // 2, 2)
        mask[y:y + hw // 2, x:x + hw // 4] = 1
        img[mask.astype(bool)] = (80, 120, 200)
        Image.fromarray(img).save(img_dir / f"{i:06d}_surgical.jpg")
        np.save(mask_dir / f"{i:06d}.npy", mask)
    return str(img_dir), str(mask_dir)


def phase_unet_train(run: Run, seed: int, card: str, workdir) -> tuple[str, dict]:
    """Stack C (the path of ``train_mask_detector.py``): MaskDetector(3,
    bilinear) at 256^2, batch 16, in f32 and with ``--amp``: finite losses,
    the step time and peak memory; at batch 2 and 64^2 the card step's
    gradients, batch statistics and loss against the CPU's (f64 to the
    gate, f32 no further from f64 than twice the CPU's f32); the
    trainer CLI for one epoch from a reference ``--load`` written from the
    seeded UNet. Returns that file and the seeded detector's state dict."""
    import torch

    from face_mask_inpaint_tpu_torch.cli import train_mask_detector as cli
    from face_mask_inpaint_tpu_torch.kernels import reset_launch_counts
    from face_mask_inpaint_tpu_torch.models.unet import MaskDetector
    from face_mask_inpaint_tpu_torch.train.optim import adam
    from face_mask_inpaint_tpu_torch.train.unet import make_unet_train_step

    t_phase = time.perf_counter()
    data = torch.Generator(device="cuda").manual_seed(seed + 21)
    # (a) full width, batch 16, f32 and bf16 compute (--amp)
    for amp in (False, True):
        dtype = torch.bfloat16 if amp else torch.float32
        model = MaskDetector(dtype=dtype, generator=torch.Generator().manual_seed(seed)).cuda()
        step = make_unet_train_step(model, adam(model.parameters(), 1e-5))
        batches = [_unet_batch(data, UNET_BATCH, UNET_HW, "cuda") for _ in range(3)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        losses, times = [], []
        for i in range(2 + STEP_ROUNDS):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            losses.append(float(step(batches[i % len(batches)])["loss"]))
            end.record()
            torch.cuda.synchronize()
            if i >= 2:
                times.append(start.elapsed_time(end))
        _no_launches(run, f"Stack C step ({'--amp' if amp else 'f32'})")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        q = statistics.quantiles(times, n=4)
        run.check(all(math.isfinite(x) for x in losses),
                  f"Stack C losses finite ({'--amp' if amp else 'f32'}): "
                  f"{', '.join(f'{x:.4f}' for x in losses)}")
        print(f"[unet] Stack C step, MaskDetector(3, bilinear) {UNET_HW}^2 batch {UNET_BATCH} "
              f"{'bf16 compute (--amp)' if amp else 'f32 (TF32 off)'}, {STEP_ROUNDS} steps after "
              f"2 warm-up: median {statistics.median(times):.2f} ms, quartiles {q[0]:.2f}-"
              f"{q[2]:.2f}, range {min(times):.2f}-{max(times):.2f} "
              f"({UNET_BATCH / statistics.median(times) * 1e3:.1f} images/s); peak device "
              f"memory {peak:.2f} GiB, on {card}", flush=True)
        del model, step, batches
        torch.cuda.empty_cache()

    # (b) the card's step against the same step on the CPU, batch 2 at 64^2,
    # cuDNN's deterministic algorithms. This step's f32 gradients are
    # ill-conditioned at init: the CPU's and the card's f32 steps miss phase
    # 7's gate against the f64 step by 17x and 5x here, 40x both at 256^2,
    # in some weight gradients (tools/unet_f32_drift.py). So the gate holds
    # the card's f64 step against the CPU's f64 step (the same function),
    # and the card's f32 step is held to be no further from the f64 step
    # than twice the CPU's f32 step is
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        batch = _unet_batch(torch.Generator().manual_seed(seed + 22), UNET_CHECK_BATCH,
                            UNET_CHECK_HW, "cpu")
        results = {}
        for device, dtype in (("cpu", torch.float64), ("cuda", torch.float64),
                              ("cpu", torch.float32), ("cuda", torch.float32)):
            model = MaskDetector(dtype=dtype, generator=torch.Generator().manual_seed(seed))
            model = model.to(device, dtype)
            loss = make_unet_train_step(model, adam(model.parameters(), 1e-5))(
                {k: v.to(device, dtype) if v.is_floating_point() else v.to(device)
                 for k, v in batch.items()})["loss"]
            results[(device, dtype)] = (
                float(loss), {n: p.grad.detach().cpu().double()
                              for n, p in model.named_parameters()},
                {n: b.detach().cpu().double() for n, b in model.named_buffers()})
    finally:
        cudnn.deterministic, cudnn.benchmark = saved

    def used(got, want):
        """The largest per-tensor share of phase 7's tolerance."""
        floor = GRAD_FLOOR * max(float(w.abs().max()) for w in want.values())
        return max(float((got[k] - w).abs().max()) / (GRAD_TOL * float(w.abs().max()) + floor)
                   for k, w in want.items())

    ref, card = results[("cpu", torch.float64)], results[("cuda", torch.float64)]
    for part, idx in (("gradients", 1), ("batch statistics", 2)):
        u = used(card[idx], ref[idx])
        run.check(u <= 1.0, f"Stack C f64 step, batch {UNET_CHECK_BATCH} at {UNET_CHECK_HW}^2: "
                            f"card vs CPU {part} ({len(ref[idx])} tensors): max_abs_err uses at "
                            f"most {u:.3f} of its tolerance ({GRAD_TOL} * max|cpu| + "
                            f"{GRAD_FLOOR} * the largest entry)")
    run.check(abs(card[0] - ref[0]) <= GRAD_TOL * abs(ref[0]),
              f"Stack C f64 loss, batch {UNET_CHECK_BATCH}: card {card[0]:.9f}, CPU {ref[0]:.9f}")
    card32 = used(results[("cuda", torch.float32)][1], ref[1])
    cpu32 = used(results[("cpu", torch.float32)][1], ref[1])
    run.check(card32 <= 2 * cpu32, f"Stack C f32 step: the card's gradients use {card32:.3f} "
                                   f"of the tolerance against the f64 step, the CPU's f32 "
                                   f"{cpu32:.3f} (at most twice that)")

    # (c) the trainer CLI: --load of a reference .pth, then one epoch
    seeded = MaskDetector(generator=torch.Generator().manual_seed(seed))
    ref_path = workdir / "mask_detector.pth"
    torch.save(unet_reference_state_dict(seeded), ref_path)
    img_dir, mask_dir = _write_unet_tree(workdir / "unet_tree", UNET_CLI_IMAGES, UNET_HW, seed)
    flags = ["--device", "cuda", "--seed", str(seed), "--dir_img", img_dir,
             "--dir_mask", mask_dir, "--batch-size", str(UNET_CLI_BATCH),
             "--load", str(ref_path)]
    reset_launch_counts()
    loaded = cli.main([*flags, "--epochs", "0", "--dir_checkpoint", str(workdir / "ckpt0")])
    same = all(torch.equal(v.cpu(), seeded.state_dict()[k])
               for k, v in loaded.model.state_dict().items())
    run.check(same, "train_mask_detector --load of the reference .pth gives the seeded UNet's "
                    "weights bit for bit")
    t0 = time.perf_counter()
    trainer = cli.main([*flags, "--epochs", "1", "--dir_checkpoint", str(workdir / "ckpt")])
    wall = time.perf_counter() - t0
    _no_launches(run, "train_mask_detector")
    recs = [json.loads(x) for x in (workdir / "ckpt" / "logs" / "metrics.jsonl")
            .read_text().splitlines()]
    losses = [r["train loss"] for r in recs if "train loss" in r]
    dice = [r["validation Dice"] for r in recs if "validation Dice" in r]
    n_train = UNET_CLI_IMAGES - UNET_CLI_IMAGES // 10
    run.check(trainer.step == n_train // UNET_CLI_BATCH and len(losses) == trainer.step
              and all(math.isfinite(x) for x in losses) and len(dice) == trainer.step
              and all(0.0 <= d <= 1.0 for d in dice)
              and (workdir / "ckpt" / "unet_checkpoint_epoch1").is_file(),
              f"train_mask_detector one epoch: {trainer.step} steps, losses "
              f"{losses[0]:.4f} -> {losses[-1]:.4f}, validation Dice {dice[-1]:.4f}, "
              f"checkpoint written")
    print(f"[unet] train_mask_detector.main, one epoch of {n_train} images at batch "
          f"{UNET_CLI_BATCH} with a validation round each step: {wall:.1f} s; phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    del loaded, trainer
    torch.cuda.empty_cache()
    return str(ref_path), seeded.state_dict()


def _inception_reference_state_dict(model) -> dict:
    """The torchvision ``inception_v3`` layout of the port model's state
    dict: the same module names, with the keys the port does not keep
    (``num_batches_tracked``, the ``fc`` head) added."""
    import torch

    out = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    for k in list(out):
        if k.endswith("running_var"):
            out[k[:-len("running_var")] + "num_batches_tracked"] = torch.tensor(0)
    out["fc.weight"] = torch.zeros(1000, 2048)
    out["fc.bias"] = torch.zeros(1000)
    return out


def phase_reference_fid(run: Run, seed: int, card: str, workdir, det_path: str,
                        det_state: dict):
    """Reference checkpoints and FID: the flagship CLI's build_models with a
    reference ``--mask_detector_path`` (its infer_batch mask against the
    seeded detector's); InceptionV3 at 299^2, batch 8, f32, timed, two
    images against the CPU; ``cli/test_evaluate.main`` on the card over a
    seeded folder of generated and ground-truth images."""
    import numpy as np
    import torch
    from PIL import Image

    from face_mask_inpaint_tpu_torch.cli import picnet_inference as picnet_cli
    from face_mask_inpaint_tpu_torch.cli import test_evaluate as eval_cli
    from face_mask_inpaint_tpu_torch.evaluations.fid import InceptionV3Features, get_activations
    from face_mask_inpaint_tpu_torch.kernels import reset_launch_counts
    from face_mask_inpaint_tpu_torch.models.unet import MaskDetector

    t_phase = time.perf_counter()
    # (a) the flagship CLI reads the reference mask detector
    reset_launch_counts()
    args = picnet_cli.get_args(["--device", "cuda", "--seed", str(seed), "--decoder_img_f",
                                "256", "--mask_detector_path", det_path, "--pt_ckpt_path", "",
                                "--out_size", str(HW)])
    detector, generator = picnet_cli.build_models(args, picnet_cli.resolve_device(args.device))
    _no_launches(run, "picnet_inference.build_models with a reference mask detector")
    loaded = all(torch.equal(v.cpu(), det_state[k]) for k, v in detector.state_dict().items())
    seeded = MaskDetector().cuda()
    seeded.load_state_dict(det_state, strict=True)
    data = torch.Generator(device="cuda").manual_seed(seed + 31)
    src = torch.rand(2, HW, HW, 3, device="cuda", generator=data)
    ref = torch.rand(2, HW, HW, 3, device="cuda", generator=data)
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        reset_launch_counts()
        _, mask = picnet_cli.make_infer_batch(detector, generator)(
            src, ref, torch.Generator(device="cuda").manual_seed(seed))
        flagship = _counts()
        with torch.no_grad():
            want = seeded.predict_mask(src)
    finally:
        cudnn.deterministic, cudnn.benchmark = saved
    run.check(loaded and torch.equal(mask, want) and 0 < float(want.mean()) < 1,
              f"picnet_inference.build_models: the reference .pth gives the seeded detector's "
              f"weights, and infer_batch's mask equals the seeded detector's (mask mean "
              f"{float(want.mean()):.4f}); infer_batch's own flagship launches {flagship}")
    run.check(flagship == PER_FORWARD, f"that infer_batch launches the flagship's kernels "
                                       f"once: {flagship}")
    del detector, generator, seeded
    torch.cuda.empty_cache()

    # (b) InceptionV3: batch 8 timed, two images against the CPU
    reset_launch_counts()
    cpu_net = InceptionV3Features(torch.Generator().manual_seed(seed))
    net = InceptionV3Features(torch.Generator().manual_seed(seed)).cuda()
    images = torch.rand(INCEPTION_BATCH, 299, 299, 3, device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(seed + 32))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        ms = _time_ms(lambda: net(images), 10)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    got = get_activations(images[:2], 2, net)
    want = get_activations(images[:2].cpu(), 2, cpu_net)
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    run.check(err <= INCEPTION_TOL * scale, f"InceptionV3 f32 (TF32 off), two images at "
                                            f"299^2: card vs CPU max_abs_err {err:.3e} <= "
                                            f"{INCEPTION_TOL} * {scale:.4f}")
    _no_launches(run, "InceptionV3")
    print(f"[fid] InceptionV3 forward, f32 (TF32 off) batch {INCEPTION_BATCH} at 299^2: "
          f"median {ms:.2f} ms ({INCEPTION_BATCH / ms * 1e3:.1f} images/s), peak device memory "
          f"{peak:.2f} GiB, on {card}", flush=True)
    inception_path = workdir / "inception_v3.pth"
    torch.save(_inception_reference_state_dict(cpu_net), inception_path)
    del net, cpu_net, images
    torch.cuda.empty_cache()

    # (c) test_evaluate over a seeded folder
    rs = np.random.RandomState(seed + 33)
    gt_dir, gen_dir = workdir / "eval" / "images", workdir / "eval" / "test_results" / "run"
    gt_dir.mkdir(parents=True)
    gen_dir.mkdir(parents=True)
    for i in range(EVAL_IMAGES):
        base = rs.randint(0, 256, (HW, HW, 3)).astype(np.uint8)
        Image.fromarray(base).resize((4 * HW, 4 * HW), Image.BICUBIC).save(
            gt_dir / f"{i:06d}.jpg")
        noisy = np.clip(base.astype(int) + rs.randint(-40, 40, base.shape), 0, 255)
        Image.fromarray(noisy.astype(np.uint8)).save(gen_dir / f"gen_{i:06d}.jpg")
    reset_launch_counts()
    t0 = time.perf_counter()
    results = eval_cli.main(["--device", "cuda", "--data_root", str(workdir / "eval"),
                             "--test_folder", str(gen_dir), "--inception_weights",
                             str(inception_path)])
    wall = time.perf_counter() - t0
    _no_launches(run, "test_evaluate")
    rows = (gen_dir / "metrics.csv").read_text().splitlines()
    names, values = rows[0].split(","), [float(v) for v in rows[1].split(",")]
    run.check(sorted(names) == ["fid", "ms_ssim", "ssim"] and all(map(math.isfinite, values))
              and values == [results[n][0] for n in names],
              f"test_evaluate metrics.csv: {dict(zip(names, values))}")
    print(f"[fid] test_evaluate.main over {EVAL_IMAGES} images (ssim, ms_ssim, fid; the "
          f"Fréchet distance of 2048-d statistics on the host): {wall:.1f} s; phase "
          f"{time.perf_counter() - t_phase:.1f} s, on {card}", flush=True)


# -- Stack A's other encoders: the DRN encoder and the old-model path --------

def _write_celeba_tree(root, seed: int) -> None:
    """A seeded tree in CelebA's layout at 256^2: ``<id>.jpg`` ground truths
    and references, ``<id>_surgical.jpg`` sources with the mask painted in,
    ``<id>.npy`` masks and the identity file (the ReferenceDataset layout)."""
    import numpy as np
    from PIL import Image

    src_dir, ref_dir = root / "img_align_celeba_masked1", root / "img_align_celeba"
    mask_dir = root / "binary_map"
    for d in (src_dir, ref_dir, mask_dir):
        d.mkdir(parents=True)
    rs = np.random.RandomState(seed)
    lines, n = [], 0
    for ident in range(1, CLI_IDENTITIES + 1):
        base = rs.randint(0, 200, (HW, HW, 3))
        for _ in range(CLI_PER_IDENTITY):
            n += 1
            gt = np.clip(base + rs.randint(-20, 20, (HW, HW, 3)), 0, 255).astype(np.uint8)
            mask = np.zeros((HW, HW), np.uint8)
            mask[HW // 2:HW // 2 + HW // 3, HW // 4:3 * HW // 4] = 1
            src = gt.copy()
            src[mask.astype(bool)] = (80, 120, 200)
            Image.fromarray(gt).save(ref_dir / f"{n:06d}.jpg")
            Image.fromarray(src).save(src_dir / f"{n:06d}_surgical.jpg")
            np.save(mask_dir / f"{n:06d}.npy", mask)
            lines.append(f"{n:06d}.jpg {ident}")
    (root / "identity_CelebA.txt").write_text("\n".join(lines) + "\n")


def _forward_check(run: Run, name: str, forward, want_launches: dict, shape, card: str,
                   gate: bool):
    """One forward with the counts reset (its launches against
    ``want_launches``), its output's shape, range and finiteness, then the
    same forward on the plain versions: max |kernel - plain| <= 1e-3 of
    the plain path's largest entry where ``gate`` (the flagship output gate
    of phase 3, in float32), printed otherwise. Returns the output and the
    plain versions' output."""
    import torch

    from face_mask_inpaint_tpu_torch.kernels import reset_launch_counts

    reset_launch_counts()
    out = forward()
    torch.cuda.synchronize()
    launches = _counts()
    print(f"[other encoders] {name}: launches in one forward: {launches}", flush=True)
    run.check(launches == want_launches, f"{name} launches {want_launches}: {launches}")
    run.check(tuple(out.shape) == shape and bool(torch.isfinite(out.float()).all())
              and float(out.abs().max()) <= 1.0,
              f"{name} output {tuple(out.shape)}, finite, within [-1, 1]")
    with plain_versions():
        want = forward()
    err, scale = float((out.float() - want.float()).abs().max()), float(want.abs().max())
    if gate:
        run.check(err <= 1e-3 * scale, f"{name}: kernel path vs plain versions max_abs_err "
                                       f"{err:.3e} (tol 1e-3 * {scale:.4f})")
    else:
        print(f"[other encoders] {name}: kernel path vs plain versions max_abs_err {err:.3e} "
              f"of {scale:.4f} (bf16 outputs are rounded to 2^-8 near 1: gated against the "
              f"float32 plain path below)", flush=True)
    return out, want


def _time_forward(name: str, forward, batch: int, card: str) -> None:
    """CUDA-event times of DRN_ROUNDS forwards after one warm-up (median,
    quartiles) and the peak device memory of one."""
    import torch

    forward()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(DRN_ROUNDS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        forward()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    q = statistics.quantiles(times, n=4)
    print(f"[time] {name}, batch {batch}: median {statistics.median(times):.2f} ms, quartiles "
          f"{q[0]:.2f}-{q[2]:.2f}, range {min(times):.2f}-{max(times):.2f} "
          f"({batch / statistics.median(times) * 1e3:.2f} images/s); peak device memory "
          f"{peak:.2f} GiB, on {card}", flush=True)


def _phase_other_inference(run: Run, seed: int, card: str) -> None:
    """Config 3 with the DRN encoders (f32 batch 4 gated against the plain
    versions, bf16 batch 16 timed) and the old-model path (batch 16, f32
    gated, bf16 timed), each through the CLI's ``infer_batch``; the bf16
    outputs' first 4 images held to the f32 plain path's, within
    BF16_VS_F32 times the bf16 plain path's own distance from it (neither
    path draws noise); K1 at the old model's 9,504 tokens in both types."""
    import torch

    from face_mask_inpaint_tpu_torch.cli import picnet_inference as cli
    from face_mask_inpaint_tpu_torch.kernels import flash_attention as fa

    data = torch.Generator(device="cuda").manual_seed(seed + 41)
    for dtype in (torch.float32, torch.bfloat16):
        dname, gate = str(dtype).split(".")[-1], dtype == torch.float32
        for old_model in (False, True):
            batch = 16 if old_model or not gate else 4
            src = torch.rand(batch, HW, HW, 3, device="cuda", generator=data)
            ref = torch.rand(batch, HW, HW, 3, device="cuda", generator=data)
            noise = torch.Generator(device="cuda").manual_seed(seed + 1)
            detector, model = (_models(seed, dtype, out_size=OLD_MODEL_HW) if old_model
                               else _models(seed, dtype, DRN_ENC))
            infer = cli.make_infer_batch(detector, model, old_model)
            forward = lambda: infer(src, ref, noise)[0]  # noqa: E731
            if old_model:
                name, want, shape = "old-model", OLD_MODEL_PER_FORWARD, (batch, *OLD_MODEL_HW, 3)
            else:
                name, want, shape = "DRN flagship", DRN_PER_FORWARD, (batch, HW, HW, 3)
            out, plain = _forward_check(run, f"{name} {dname} batch {batch}", forward, want,
                                        shape, card, gate)
            if not gate:
                with torch.no_grad():
                    mask = detector.predict_mask(src[:4]).float()
                _bf16_vs_f32(run, f"{name} bf16", seed, old_model, src[:4], ref[:4], mask,
                             out[:4], plain[:4])
                _time_forward(f"{name} forward (detector + ReferenceFill"
                              f"{', no_prior at 218x178' if old_model else ', DRN-C-42 encoders'}"
                              f") {dname}", forward, batch, card)
            del detector, model, infer, src, ref
            torch.cuda.empty_cache()

        batch = 16
        q = (torch.randn(batch, OLD_MODEL_TOKENS, 64, device="cuda", generator=data) / 4
             ).to(dtype)
        vs = [torch.randn(batch, OLD_MODEL_TOKENS, 256, device="cuda", generator=data).to(dtype)]
        outs, lse = fa.flash_attention(q, vs, with_lse=True)
        torch.cuda.synchronize()
        refs, lse_ref = fa.flash_attention_plain(q, vs, with_lse=True)
        ok, err = _close(outs[0], refs[0], dname)
        lse_err = float((lse - lse_ref).abs().max())
        route, want_route = fa.flash_attention_route(q, vs), _route_k1(dname, 64, 256)
        run.check(ok and lse_err <= LSE_ATOL and route == want_route,
                  f"K1 old-model N={batch} L={OLD_MODEL_TOKENS} d=64 C=[256] {dname} ({route}, "
                  f"want {want_route}): max_abs_err {err:.3e} lse_err {lse_err:.3e} (tol atol "
                  f"{TOL[dname][0]} + rtol {TOL[dname][1]:.3e}*|ref|, lse {LSE_ATOL})")
        ms = _time_ms(lambda: fa.flash_attention(q, vs), 5)
        print(f"[time] K1 at the old model's {OLD_MODEL_TOKENS} tokens, batch {batch} {dname} "
              f"({route}): {ms:.3f} ms, on {card}", flush=True)
        del q, vs, outs, refs
        torch.cuda.empty_cache()


class _FixedMask:
    """A detector that hands over a mask already predicted."""

    def __init__(self, mask):
        self.mask = mask

    def predict_mask(self, src):
        return self.mask


def _bf16_vs_f32(run: Run, name: str, seed: int, old_model: bool, src, ref, mask, out,
                 plain) -> None:
    """The bf16 kernel path's output against the f32 plain path's on the
    same 4 images and the bf16 detector's mask: at most BF16_VS_F32 times as
    far as the bf16 plain path's."""
    import torch

    from face_mask_inpaint_tpu_torch.cli import picnet_inference as cli

    detector, model = (_models(seed, torch.float32, out_size=OLD_MODEL_HW) if old_model
                       else _models(seed, torch.float32, DRN_ENC))
    with plain_versions():
        want = cli.make_infer_batch(_FixedMask(mask), model, old_model)(
            src, ref, torch.Generator(device="cuda").manual_seed(seed + 1))[0].float()
    dk, dp = (out.float() - want).abs(), (plain.float() - want).abs()
    err_k, err_p = float(dk.max()), float(dp.max())
    mean_k, mean_p = float(dk.mean()), float(dp.mean())
    run.check(err_k <= BF16_VS_F32 * err_p and mean_k <= BF16_VS_F32 * mean_p,
              f"{name}: |kernel path - f32 plain| max {err_k:.3e}, mean {mean_k:.3e}, within "
              f"{BF16_VS_F32} x the bf16 plain path's {err_p:.3e}, {mean_p:.3e} (ratios "
              f"{err_k / max(err_p, 1e-30):.3f}, {mean_k / max(mean_p, 1e-30):.3f})")
    del detector, model
    torch.cuda.empty_cache()


def _phase_other_cli(run: Run, seed: int, card: str, workdir) -> None:
    """``cli/picnet_inference.main --device cuda`` with ``--encoder_type drn``
    and with ``--old_model 1`` on a seeded CelebA-layout tree."""
    import os

    import numpy as np
    from PIL import Image

    from face_mask_inpaint_tpu_torch.cli import picnet_inference as cli

    workdir = workdir.resolve()  # the CLI runs from inside it
    root = workdir / "celeba"
    _write_celeba_tree(root, seed + 42)
    here = os.getcwd()
    os.chdir(workdir)  # the CLI writes test_results/<run> under the working directory
    try:
        for flags, size in ((["--encoder_type", "drn"], (HW, HW)),
                            (["--old_model", "1"], OLD_MODEL_HW)):
            run_name = flags[0].strip("-")
            t0 = time.perf_counter()
            cli.main(["--device", "cuda", "--seed", str(seed), "--data_root", str(root),
                      "--batch_size", "4", "--decoder_img_f", "256", "--mask_detector_path", "",
                      "--pt_ckpt_path", f"missing/{run_name}/model.pt", "--out_size", str(HW),
                      *flags])
            wall = time.perf_counter() - t0
            out_dir = workdir / "test_results" / run_name
            images = sorted(out_dir.glob("gen_*.jpg"))
            sizes = {Image.open(p).size for p in images}
            rows = (out_dir / "metrics.csv").read_text().splitlines()
            values = [float(v) if v else math.nan for v in rows[1].split(",")]
            run.check(len(images) == CLI_IDENTITIES * CLI_PER_IDENTITY
                      and sizes == {(size[1], size[0])} and all(np.isfinite(values)),
                      f"picnet_inference {' '.join(flags)} on the card: {len(images)} images of "
                      f"{sizes}, metrics {dict(zip(rows[0].split(','), values))}")
            print(f"[other encoders] picnet_inference {' '.join(flags)}: {wall:.1f} s, on "
                  f"{card}", flush=True)
    finally:
        os.chdir(here)


def _phase_other_train(run: Run, seed: int, card: str) -> None:
    """The config-5 GAN step with the DRN encoders: bf16 batch 16 (launches,
    finite losses, the running statistics moved, step time, peak memory);
    f32 batch 2, the kernel path's gradients against the plain path's."""
    import copy

    import torch

    from face_mask_inpaint_tpu_torch.kernels import reset_launch_counts

    batch = 16
    trainer = _trainer(seed, "bfloat16", batch, "--encoder_type", "drn")
    data = torch.Generator(device="cuda").manual_seed(seed + 43)
    batches = [_train_batch(data, batch) for _ in range(3)]
    bn = trainer.generator.src_encoder.layer8.block0.bn2
    before = (bn.running_mean.clone(), bn.running_var.clone())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    metrics = trainer.train_step(batches[0], noise=trainer.noise)
    torch.cuda.synchronize()
    launches = _counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = {k: float(v) for k, v in metrics.items()}
    moved = not (torch.equal(bn.running_mean, before[0]) or torch.equal(bn.running_var, before[1]))
    print(f"[other encoders] DRN config-5 step: launches {launches}; losses {losses}", flush=True)
    run.check(launches == DRN_PER_STEP, f"DRN config-5 step launches {DRN_PER_STEP}: {launches}")
    run.check(all(math.isfinite(v) for v in losses.values()) and moved,
              f"DRN config-5 step: losses finite, the DRN's running statistics moved: {moved}")
    times = []
    for i in range(2 + STEP_ROUNDS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        trainer.train_step(batches[i % len(batches)], noise=trainer.noise)
        end.record()
        torch.cuda.synchronize()
        if i >= 2:
            times.append(start.elapsed_time(end))
    q = statistics.quantiles(times, n=4)
    print(f"[time] DRN config-5 step, bf16 batch {batch}, {STEP_ROUNDS} steps after 2 warm-up: "
          f"median {statistics.median(times):.2f} ms, quartiles {q[0]:.2f}-{q[2]:.2f}, range "
          f"{min(times):.2f}-{max(times):.2f} ({batch / statistics.median(times) * 1e3:.2f} "
          f"images/s); peak device memory of the first step {peak:.2f} GiB, on {card}",
          flush=True)
    del trainer, batches, metrics
    torch.cuda.empty_cache()

    # f32 batch 2: the kernel path against the plain path, and the plain
    # path against itself with the source image moved by 1e-6 of itself
    # (the step's own f32 drift: its BatchNorm gradients are ill-conditioned)
    trainer = _trainer(seed, "float32", 2, "--encoder_type", "drn")
    b = _train_batch(data, 2)
    start = copy.deepcopy((trainer.generator.state_dict(), trainer.discriminator.state_dict()))
    got = trainer.train_step(b, return_grads=True)
    results = []
    for batch_in in (b, dict(b, src_img=b["src_img"] * (1.0 + 1e-6 * torch.randn(
            b["src_img"].shape, device="cuda", generator=data)))):
        trainer.generator.load_state_dict(start[0])
        trainer.discriminator.load_state_dict(start[1])
        with plain_versions():
            results.append(trainer.train_step(batch_in, return_grads=True))
    want, drift = results

    def used(a, ref):
        floor = GRAD_FLOOR * max(float(w.abs().max()) for w in ref.values())
        return {k: float((a[k] - w).abs().max()) / (GRAD_TOL * float(w.abs().max()) + floor)
                for k, w in ref.items()}

    d_used = max(used(got["d_grads"], want["d_grads"]).values())
    run.check(d_used <= 1.0, f"DRN config-5 f32 step, batch 2: kernel path vs plain path, "
                             f"d_grads: max_abs_err uses at most {d_used:.3f} of its tolerance "
                             f"({GRAD_TOL} * max|plain| + {GRAD_FLOOR} * the largest entry)")
    g_used, g_drift = used(got["g_grads"], want["g_grads"]), used(drift["g_grads"],
                                                                  want["g_grads"])
    within = sum(u <= 1.0 for u in g_used.values())
    err = math.sqrt(sum(float((got["g_grads"][k] - w).square().sum())
                        for k, w in want["g_grads"].items()))
    own = math.sqrt(sum(float((drift["g_grads"][k] - w).square().sum())
                        for k, w in want["g_grads"].items()))
    norm = math.sqrt(sum(float(w.square().sum()) for w in want["g_grads"].values()))
    print(f"[other encoders] DRN f32 step g_grads: {within} of {len(g_used)} tensors within "
          f"phase 7's per-tensor gate; worst share kernel vs plain {max(g_used.values()):.3f}, "
          f"plain vs plain with the source moved by 1e-6: {max(g_drift.values()):.3f} "
          f"({sum(u <= 1.0 for u in g_drift.values())} within)", flush=True)
    run.check(err <= 3 * own, f"DRN config-5 f32 step, batch 2: kernel path vs plain path, "
                              f"g_grads L2 {err / norm:.3e} of the gradient's, at most three "
                              f"times the plain path's own drift under a 1e-6 move of the "
                              f"source ({own / norm:.3e})")
    loss_err = max(abs(float(got[k]) - float(want[k])) / max(abs(float(want[k])), 1e-12)
                   for k in ("G_loss", "D_loss"))
    run.check(loss_err <= 1e-4, f"DRN config-5 f32 step, batch 2: G and D losses of the kernel "
                                f"path within {loss_err:.2e} of the plain path's (tol 1e-4)")
    del trainer, got, want, drift
    torch.cuda.empty_cache()


def _phase_pre_and_coord(run: Run, seed: int) -> None:
    """AutoAttention's long-term branch at 128^2, C = 64 (d = 16: K1's
    CUDA-core route, C + C_pre = 128 value channels in one call) against its
    plain version; the flagship decoder with ``f_e`` and ``mask`` feeding
    that branch, against its plain versions; a CoordConv ResBlock on the card
    against the CPU."""
    import torch

    from face_mask_inpaint_tpu_torch.kernels import flash_attention as fa
    from face_mask_inpaint_tpu_torch.kernels import reset_launch_counts
    from face_mask_inpaint_tpu_torch.models.picnet import define_g
    from face_mask_inpaint_tpu_torch.nn.blocks import AutoAttention, ResBlock
    from face_mask_inpaint_tpu_torch.nn.layers import init_weights

    data = torch.Generator(device="cuda").manual_seed(seed + 44)
    attn = init_weights(AutoAttention(64, 64, norm="instance"),
                        torch.Generator().manual_seed(seed)).cuda().eval()
    with torch.no_grad():
        attn.gamma.fill_(1.0)
        attn.alpha.fill_(1.0)
    x = torch.randn(2, 64, 128, 128, device="cuda", generator=data)
    pre = torch.randn(2, 64, 128, 128, device="cuda", generator=data)
    mask = torch.zeros(2, 1, 128, 128, device="cuda")
    mask[:, :, 40:100, 30:90] = 1.0
    q = torch.randn(2, 128 * 128, 16, device="cuda")
    route = fa.flash_attention_route(q, [torch.empty(2, 128 * 128, 64, device="cuda")] * 2)
    with torch.no_grad():
        reset_launch_counts()
        out = attn(x, pre, mask)
        torch.cuda.synchronize()
        launches = _counts()
        with plain_versions():
            want = attn(x, pre, mask)
    err, scale = float((out - want).abs().max()), float(want.abs().max())
    run.check(route == "cuda_cores" and launches["flash_attention_fwd"] == 1
              and launches["instance_norm_act"] == 2 and err <= 1e-3 * scale,
              f"AutoAttention with pre, 128^2, C = 64 + 64, f32: K1 on its {route} route "
              f"({launches['flash_attention_fwd']} launch), K2 x{launches['instance_norm_act']}; "
              f"vs plain versions max_abs_err {err:.3e} (tol 1e-3 * {scale:.4f})")
    # the flagship decoder (f32, batch 2, from 32^2 features with z) with
    # f_e [2, 64, 128^2] and a mask at the attention's 128^2: K1 once (C =
    # 256 + 64 value channels), K2 on the ten decoder norms and the pre
    # ResBlock's two
    gen = init_weights(define_g(**FLAGSHIP_DEC, input_nc=256, z_channels=256,
                                attn_pre_channels=64),
                       torch.Generator().manual_seed(seed)).cuda().eval()
    with torch.no_grad():
        gen.attn1.gamma.fill_(1.0)
        gen.attn1.alpha.fill_(1.0)
    enc = torch.randn(2, 256, 32, 32, device="cuda", generator=data)
    z = torch.randn(2, 256, 32, 32, device="cuda", generator=data)
    f_e = torch.randn(2, 64, 128, 128, device="cuda", generator=data)
    with torch.no_grad():
        reset_launch_counts()
        out = gen(enc, z=z, f_e=f_e, mask=mask)
        torch.cuda.synchronize()
        launches = _counts()
        with plain_versions():
            want = gen(enc, z=z, f_e=f_e, mask=mask)
    err, scale = float((out - want).abs().max()), float(want.abs().max())
    run.check(launches["flash_attention_fwd"] == 1 and launches["instance_norm_act"] == 12
              and tuple(out.shape) == (2, 3, 1024, 1024) and err <= 1e-3 * scale,
              f"ResGenerator with f_e and mask (flagship decoder, 128^2 attention, C = 256 + "
              f"64, f32): K1 x{launches['flash_attention_fwd']}, K2 "
              f"x{launches['instance_norm_act']}; vs plain versions max_abs_err {err:.3e} (tol "
              f"1e-3 * {scale:.4f})")
    del gen, enc, z, f_e, out, want
    torch.cuda.empty_cache()
    block = init_weights(ResBlock(64, 64, 64, norm="instance", use_spect=True, use_coord=True),
                         torch.Generator().manual_seed(seed)).eval()
    x_cpu = torch.randn(2, 64, 64, 64, generator=torch.Generator().manual_seed(seed + 45))
    with torch.no_grad():
        want = block(x_cpu)
        got = block.cuda()(x_cpu.cuda()).cpu()
    err, scale = float((got - want).abs().max()), float(want.abs().max())
    run.check(err <= 1e-4 * scale, f"CoordConv ResBlock (64 + 2 coordinate channels, 64^2, "
                                   f"f32): card vs CPU max_abs_err {err:.3e} (tol 1e-4 * "
                                   f"{scale:.4f})")


def phase_other_encoders(run: Run, seed: int, card: str, workdir) -> None:
    """Phase 12: Stack A's DRN encoder and old-model path (inference, the
    CLI, the GAN step), AutoAttention's pre branch and CoordConv."""
    t_phase = time.perf_counter()
    _phase_other_inference(run, seed, card)
    _phase_other_cli(run, seed, card, workdir)
    _phase_other_train(run, seed, card)
    _phase_pre_and_coord(run, seed)
    print(f"[other encoders] phase 12: {time.perf_counter() - t_phase:.1f} s, on {card}",
          flush=True)


def _dp_metrics_ok(got: dict, one: dict, drift: dict) -> tuple[bool, float]:
    """Every metric within DP_TOL plus DP_DRIFT times its own drift; and
    the largest share of that tolerance used."""
    rtol, atol = DP_TOL
    worst = 0.0
    for k, v in one.items():
        tol = atol + rtol * abs(v) + DP_DRIFT * abs(drift[k] - v)
        share = abs(got[k] - v) / tol
        worst = max(worst, share if math.isfinite(share) else math.inf)
    return set(got) == set(one) and worst <= 1.0, worst


def phase_data_parallel(run: Run, seed: int, card: str, workdir) -> None:
    """Phase 13: each trainer's step on two gloo ranks sharing the card
    against the one-process step (tools/dp_check.py), one NCCL rank, and
    ``cli/train_mask_detector`` under ``torch.distributed.run`` with two
    ranks on phase 10's tree, only rank 0 writing."""
    import os

    from face_mask_inpaint_tpu_torch.tools import dp_check

    t_phase = time.perf_counter()
    out = workdir / "dp_check"
    print(f"[dp] {DP_WORLD} ranks share the one card over gloo: the two-rank step times "
          f"measure the collectives' cost through gloo, not scaling; on {card}", flush=True)
    for name in DP_PER_STEP:
        t0 = time.perf_counter()
        r = dp_check.run(name, DP_WORLD, seed, str(out), DP_TIMEOUT)
        ranks = r["ranks"]
        launches = [x["launches"] for x in ranks]
        run.check(all(x == DP_PER_STEP[name] for x in launches),
                  f"{name} two-rank step: each rank launches {DP_PER_STEP[name]}: {launches}")
        run.check(all(x["backend"] == "gloo" and x["replica_gap"] == 0.0 for x in ranks),
                  f"{name} two-rank step: gloo, every rank's parameters and buffers equal rank "
                  f"0's after the step: gaps {[x['replica_gap'] for x in ranks]}")
        ok, worst = _dp_metrics_ok(r["metrics"], r["one_metrics"], r["drift_metrics"])
        run.check(ok, f"{name} two-rank step vs one-process step, metrics: at most {worst:.3f} "
                      f"of the tolerance (rtol {DP_TOL[0]}, atol {DP_TOL[1]} + {DP_DRIFT} x the "
                      f"drift): two-rank {r['metrics']}, one-process {r['one_metrics']}")
        run.check(r["update_norm"] > 0 and r["dp_distance"] <= DP_DRIFT * r["drift_distance"],
                  f"{name} two-rank step vs one-process step, parameter update ({r['n_params']} "
                  f"trained): L2 distance {r['dp_distance']:.4e} within {DP_DRIFT} x the drift's "
                  f"{r['drift_distance']:.4e} (the update's L2 {r['update_norm']:.4e})")
        floor = max(r["drift_grad_distance"], DP_GRAD_FLOOR.get(name, 0.0) * r["grad_norm"])
        run.check(r["grad_norm"] > 0 and r["dp_grad_distance"] <= DP_DRIFT * floor,
                  f"{name} two-rank step vs one-process step, gradients averaged over the ranks "
                  f"before the optimizers step: L2 distance {r['dp_grad_distance']:.4e} within "
                  f"{DP_DRIFT} x {floor:.4e} (the drift's {r['drift_grad_distance']:.4e}; the "
                  f"gradients' L2 {r['grad_norm']:.4e})")
        if r["cut"] is not None:
            _, cut_worst = _dp_metrics_ok(r["cut_metrics"], r["one_metrics"],
                                          r["drift_metrics"])
            run.check(r["cut_grad_distance"] > DP_DRIFT * floor,
                      f"{name} negative control, the two-rank step with its {r['cut']} sync "
                      f"cut misses the gradient gate: L2 distance {r['cut_grad_distance']:.4e} "
                      f"over {DP_DRIFT} x {floor:.4e} (its update {r['cut_distance']:.4e} "
                      f"against the drift's {r['drift_distance']:.4e}, its metrics at "
                      f"{cut_worst:.3f} of their tolerance)")
        rank_ms = ", ".join(f"{x['seconds'] * 1e3:.2f}" for x in ranks)
        print(f"[time] {name} step, global batch {dp_check.TRAINERS[name]}: two ranks sharing "
              f"the card over gloo {rank_ms} ms "
              f"(each rank's host wall to the end of its device work, after one warm-up), one "
              f"process {r['one_seconds'] * 1e3:.2f} ms; rank 0's peak device memory "
              f"{r['peak_gib']:.2f} GiB; {time.perf_counter() - t0:.1f} s with start-up, on "
              f"{card}", flush=True)

    r = dp_check.nccl_check(seed, str(out))
    run.check(r["all_reduce"] == [0.0, 1.0, 2.0, 3.0]
              and r["used"] <= 1.0 and abs(r["loss_group"] - r["loss_none"])
              <= DP_TOL[1] + DP_TOL[0] * abs(r["loss_none"]),
              f"one NCCL rank: all-reduce and broadcast {r['all_reduce']}; the UNet step with "
              f"its group vs without: loss {r['loss_group']:.6f} / {r['loss_none']:.6f}, state "
              f"at most {r['used']:.3f} of the tolerance")

    tree = (workdir / "unet_tree").resolve()
    ckpt_dir = (workdir / "dp_cli").resolve()
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           str(DP_WORLD), "-m", "face_mask_inpaint_tpu_torch.cli.train_mask_detector",
           "--device", "cuda", "--seed", str(seed), "--dir_img", str(tree / "images_masked"),
           "--dir_mask", str(tree / "binary_map"), "--batch-size", str(UNET_CLI_BATCH),
           "--epochs", "1", "--dir_checkpoint", str(ckpt_dir)]
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(Path.cwd().resolve()), *filter(None, [os.environ.get("PYTHONPATH")])]))
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=DP_TIMEOUT, env=env)
    wall = time.perf_counter() - t0
    files = sorted(str(p.relative_to(ckpt_dir)) for p in ckpt_dir.rglob("*") if p.is_file())
    recs = ([json.loads(x) for x in (ckpt_dir / "logs" / "metrics.jsonl").read_text()
             .splitlines()] if (ckpt_dir / "logs" / "metrics.jsonl").is_file() else [])
    steps = [x["step"] for x in recs if "train loss" in x]
    n_steps = (UNET_CLI_IMAGES - UNET_CLI_IMAGES // 10) // UNET_CLI_BATCH
    if proc.returncode != 0:
        print(proc.stdout[-3000:], proc.stderr[-3000:], sep="\n", file=sys.stderr)
    run.check(proc.returncode == 0 and files == ["logs/metrics.jsonl", "unet_checkpoint_epoch1"]
              and steps == list(range(1, n_steps + 1))
              and sum("_config" in x for x in recs) == 1
              and all(math.isfinite(x["train loss"]) for x in recs if "train loss" in x),
              f"train_mask_detector under torch.distributed.run, {DP_WORLD} ranks, global batch "
              f"{UNET_CLI_BATCH}: rc {proc.returncode}, files {files}, one record a step "
              f"({len(steps)} of {n_steps}) and one config record: only rank 0 wrote")
    print(f"[dp] torch.distributed.run of train_mask_detector, one epoch: {wall:.1f} s; phase "
          f"13 {time.perf_counter() - t_phase:.1f} s, on {card}", flush=True)


# -- phase 14: the StyleGAN2 discriminator, the gradient penalty, the tools ------

def _disc(seed: int):
    """The StyleGAN2 discriminator at DISC_SIZE on the card, weights from
    ``seed`` (the biases 0.1 N(0, 1), so that K7a's bias add is not of
    zeros)."""
    import torch

    from face_mask_inpaint_tpu_torch.models.stylegan2 import Discriminator
    from face_mask_inpaint_tpu_torch.nn.layers import init_weights

    gen = torch.Generator(device="cuda").manual_seed(seed + 14)
    with torch.device("cuda"):
        disc = init_weights(Discriminator(DISC_SIZE, channel_multiplier=2), gen)
    with torch.no_grad():
        for name, p in disc.named_parameters():
            if name.endswith("bias"):
                p.normal_(0.0, 0.1, generator=gen)
    return disc


@contextlib.contextmanager
def _checked_calls(run: Run, dname: str, what: str):
    """Hold every K6 and K7a call the model makes against the plain version
    on the same input (launches of these comparisons are not used)."""
    from face_mask_inpaint_tpu_torch.kernels import fused_act as act
    from face_mask_inpaint_tpu_torch.kernels import upfirdn2d as fir

    saved = fir.upfirdn2d, act.fused_leaky_relu
    seen = {"upfirdn2d": [], "fused_leaky_relu": []}

    def k6(x, taps, up=1, down=1, pad=(0, 0)):
        y = saved[0](x, taps, up, down, pad)
        ok, err = _k6_close(y, fir.upfirdn2d_plain(x, taps, up, down, pad), x, taps, up, down,
                            pad, dname)
        seen["upfirdn2d"].append((ok, err, tuple(x.shape), tuple(pad)))
        return y

    def k7a(x, bias=None, negative_slope=0.2, scale=act.SQRT2):
        y = saved[1](x, bias, negative_slope, scale)
        ok, err = _close(y, act.fused_leaky_relu_plain(x, bias, negative_slope, scale), dname)
        seen["fused_leaky_relu"].append((ok, err, tuple(x.shape), None))
        return y

    # the wrappers count their launches on the module attribute they are
    # called through, here these stand-ins: the comparisons' launches are
    # not the model's
    k6.launches = k7a.launches = 0
    fir.upfirdn2d, act.fused_leaky_relu = k6, k7a
    try:
        yield
    finally:
        fir.upfirdn2d, act.fused_leaky_relu = saved
    for name, calls in seen.items():
        err = max(c[1] for c in calls)
        run.err[name] = max(run.err[name], err)
        shapes = sorted({(c[2], c[3]) for c in calls}, key=lambda c: -math.prod(c[0]))
        run.check(bool(calls) and all(c[0] for c in calls),
                  f"{what}: each of its {len(calls)} {name} calls against the plain version, "
                  f"{dname}: max_abs_err {err:.3e} (shapes, pads: {shapes[:3]} ... {shapes[-1]})")


def _param_grads(disc) -> dict:
    import torch

    return {k: (p.grad.detach().clone() if p.grad is not None else torch.zeros_like(p))
            for k, p in disc.named_parameters()}


def _penalty_step(disc, real, fake, alpha):
    """The gradient penalty, its d/dx and its double backward into the
    discriminator's parameters: (penalty, grads, launches of the penalty
    call, launches of penalty.backward())."""
    import torch

    from face_mask_inpaint_tpu_torch.kernels import reset_launch_counts
    from face_mask_inpaint_tpu_torch.losses.gan import cal_gradient_penalty

    disc.zero_grad(set_to_none=True)
    reset_launch_counts()
    pen, grads = cal_gradient_penalty(disc, real, fake, "mixed", alpha=alpha)
    torch.cuda.synchronize()
    first = {k: v for k, v in _counts().items() if v}
    reset_launch_counts()
    pen.backward()
    torch.cuda.synchronize()
    second = {k: v for k, v in _counts().items() if v}
    return pen.detach(), grads.detach(), first, second


def _phase_disc(run: Run, seed: int, card: str) -> dict:
    """The discriminator's forward in f32 and bf16 and the f32 gradient
    penalty with its double backward, kernels against plain; their times."""
    import torch

    from face_mask_inpaint_tpu_torch.kernels import reset_launch_counts
    from face_mask_inpaint_tpu_torch.tools import trace_sweep, trace_top
    from face_mask_inpaint_tpu_torch.utils.profiling import ProfileWindow

    disc = _disc(seed)
    fwd, dx, double = disc_launches(DISC_SIZE)
    n_params = sum(p.numel() for p in disc.parameters())
    data = torch.Generator(device="cuda").manual_seed(seed + 15)
    shape = (DISC_BATCH, 3, DISC_SIZE, DISC_SIZE)
    real = torch.randn(shape, device="cuda", generator=data)
    fake = torch.randn(shape, device="cuda", generator=data)
    alpha = torch.rand((DISC_BATCH, 1, 1, 1), device="cuda", generator=data)
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            x = real.to(dtype)
            with torch.no_grad():
                disc(x)
                torch.cuda.synchronize()
                reset_launch_counts()
                out = disc(x)
                torch.cuda.synchronize()
                launches = {k: v for k, v in _counts().items() if v}
                with _checked_calls(run, dname, f"D forward {dname}"):
                    disc(x)
                with plain_versions():
                    want = disc(x)
            ok, err = _close(out, want, dname)
            run.check(launches == fwd, f"D forward {dname}, size {DISC_SIZE} batch {DISC_BATCH}: "
                                       f"launches {launches} (derived {fwd})")
            run.check(ok and out.dtype == dtype and tuple(out.shape) == (DISC_BATCH, 1)
                      and bool(torch.isfinite(out.float()).all()),
                      f"D forward {dname}: {out.dtype} {tuple(out.shape)} finite, kernels vs "
                      f"plain max_abs_err {err:.3e} (max |plain| "
                      f"{float(want.float().abs().max()):.3e})")
        print(f"[disc] StyleGAN2 D size {DISC_SIZE}, channel multiplier 2: {n_params} "
              f"parameters; f32 outputs {out.float().flatten().tolist()}", flush=True)

        pen_k, grads_k, first, second = _penalty_step(disc, real, fake, alpha)
        got = _param_grads(disc)
        with plain_versions():
            pen_p, grads_p, _, _ = _penalty_step(disc, real, fake, alpha)
            want = _param_grads(disc)
    finally:
        cudnn.deterministic, cudnn.benchmark = saved
    want_first = {k: fwd.get(k, 0) + dx.get(k, 0) for k in set(fwd) | set(dx)}
    run.check(first == want_first and all(first.values()),
              f"penalty f32, d/dx: launches {first} (derived: the forward {fwd} and d/dx {dx})")
    run.check(second == double and all(second.values()),
              f"penalty f32, double backward: launches {second} (derived {double})")
    run.check(abs(float(pen_k) - float(pen_p)) <= GRAD_TOL * abs(float(pen_p))
              and math.isfinite(float(pen_k)),
              f"penalty f32: kernels {float(pen_k):.6f}, plain {float(pen_p):.6f}")
    scale = float(grads_p.abs().max())
    err = float((grads_k - grads_p).abs().max())
    run.check(err <= (GRAD_TOL + GRAD_FLOOR) * scale,
              f"penalty f32 grads [{DISC_BATCH}, 3, {DISC_SIZE}, {DISC_SIZE}]: max_abs_err "
              f"{err:.3e} of max |plain| {scale:.3e} (tol {GRAD_TOL} + {GRAD_FLOOR})")
    floor = GRAD_FLOOR * max(float(w.abs().max()) for w in want.values())
    used, worst = 0.0, ""
    for k, w in want.items():
        e = float((got[k] - w).abs().max())
        u = e / (GRAD_TOL * float(w.abs().max()) + floor)
        if u >= used:
            used, worst = u, k
    run.check(used <= 1.0, f"penalty f32 double backward, {len(want)} parameter gradients: "
                           f"max_abs_err uses at most {used:.3f} of its tolerance ({GRAD_TOL} * "
                           f"max|plain| + {GRAD_FLOOR} * the largest entry; worst {worst})")
    del got, want, grads_k, grads_p

    sides = {"kernels": contextlib.nullcontext, "plain": plain_versions}
    times = {(what, side): [] for what in ("forward bf16", "forward f32", "penalty step f32")
             for side in sides}
    x16 = real.to(torch.bfloat16)
    for r in range(DISC_ROUNDS):
        for side in (list(sides) if r % 2 == 0 else list(sides)[::-1]):
            with sides[side](), torch.no_grad():
                times[("forward bf16", side)].append(_time_ms(lambda: disc(x16), 1))
                times[("forward f32", side)].append(_time_ms(lambda: disc(real), 1))
            with sides[side]():
                times[("penalty step f32", side)].append(
                    _time_ms(lambda: _penalty_step(disc, real, fake, alpha), 1))
    torch.cuda.reset_peak_memory_stats()
    _penalty_step(disc, real, fake, alpha)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for (what, side), v in times.items():
        q = statistics.quantiles(v, n=4)
        print(f"[disc] D {what}, batch {DISC_BATCH}, {side}, {DISC_ROUNDS} rounds (ms): median "
              f"{statistics.median(v):.3f}, quartiles {q[0]:.3f}-{q[2]:.3f}, range "
              f"{min(v):.3f}-{max(v):.3f} on {card}", flush=True)
    print(f"[disc] peak device memory of the f32 penalty step {peak:.2f} GiB on {card}",
          flush=True)
    trace_dir = Path("build/chip_smoke_trace_penalty")
    shutil.rmtree(trace_dir, ignore_errors=True)
    window = ProfileWindow(str(trace_dir), num_steps=1, start_step=1)
    for step in range(3):
        window.tick(step)
        _penalty_step(disc, real, fake, alpha)
    window.close()
    print(f"[disc] one f32 penalty step (trace_top, then trace_sweep) on {card}:", flush=True)
    trace_top.main([str(trace_dir), "15"])
    trace_sweep.main([str(trace_dir), "--top", "10"])
    shutil.rmtree(trace_dir, ignore_errors=True)
    del disc, real, fake, x16
    torch.cuda.empty_cache()
    return {"forward": fwd, "penalty_dx": first, "penalty_double": second}


def _phase_tools(run: Run, seed: int, card: str) -> None:
    """The port's tools on the card: the recorded reference fixtures and an
    empty-asset report (parity_report), every kernel against its float64
    reference (validate_kernels), and the trace readers over a
    ProfileWindow trace of a few D forwards."""
    import torch

    from face_mask_inpaint_tpu_torch.kernels import reset_launch_counts
    from face_mask_inpaint_tpu_torch.tools import parity_report, trace_sweep, trace_top
    from face_mask_inpaint_tpu_torch.tools import validate_kernels
    from face_mask_inpaint_tpu_torch.utils.profiling import ProfileWindow

    report = {}
    reset_launch_counts()
    parity_report.module_fixture_parity(parity_report.DEFAULT_FIXTURE_DIR, report, "cuda")
    launches = {k: v for k, v in _counts().items() if v}
    tol = {"styled_conv_up": 5e-4, "irse_bottleneck": 5e-4, "vgg_block1": 2e-4,
           "lpips_lin": 1e-5}
    for name, row in report["module_fixtures"].items():
        run.check(row.get("status") == "ok" and row["max_abs_diff"] < tol[name],
                  f"parity fixture {name} on the card, f32 (TF32 off): {row} (tol {tol[name]})")
    run.check(launches.get("upfirdn2d", 0) > 0 and launches.get("fused_leaky_relu", 0) > 0,
              f"parity fixtures launched K6 and K7a (styled_conv_up): {launches}")
    assets = Path("build/chip_smoke_assets")
    shutil.rmtree(assets, ignore_errors=True)
    assets.mkdir(parents=True)
    rc = parity_report.main(["--assets", str(assets), "--skip_inference", "--device", "cuda",
                             "--out", str(assets / "report.json")])
    rep = json.loads((assets / "report.json").read_text())
    run.check(rc == 0 and all(v["status"] == "asset missing" for v in rep["convert"].values()),
              f"parity_report on an empty assets directory: exit {rc}, "
              f"{len(rep['convert'])} assets missing")
    shutil.rmtree(assets, ignore_errors=True)

    out = Path("build/kernel_validation.json")
    rc = validate_kernels.main(["--out", str(out)])
    val = json.loads(out.read_text())
    for name, row in val["checks"].items():
        print(f"[validate] {name}: ok {row['ok']} max_abs_diff {row['max_abs_diff']:.3e} "
              f"rel_diff {row['rel_diff']:.3e} (f32 {row.get('float32', {}).get('rel_diff')}, "
              f"bf16 {row.get('bfloat16', {}).get('rel_diff')}) launches "
              f"{row.get('launches')} {row.get('error', '')}", flush=True)
    run.check(rc == 0 and val["all_ok"] and val["card"] == card,
              f"validate_kernels on the card: exit {rc}, all_ok {val['all_ok']} "
              f"({len(val['checks'])} checks) on {val.get('card')}")

    disc = _disc(seed)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((DISC_BATCH, 3, DISC_SIZE, DISC_SIZE), device="cuda", dtype=torch.bfloat16,
                    generator=gen)
    trace_dir = Path("build/chip_smoke_trace")
    shutil.rmtree(trace_dir, ignore_errors=True)
    window = ProfileWindow(str(trace_dir), num_steps=3, start_step=1)
    with torch.no_grad():
        for step in range(5):
            window.tick(step)
            disc(x)
    window.close()
    events, path = trace_top.load_trace_events(trace_dir)
    tot, cnt, kind = trace_top.op_totals(events)
    k6 = {n: us for n, us in tot.items() if "upfirdn2d_kernel" in n}
    k7 = {n: us for n, us in tot.items() if "fwd_kernel" in n and "flash" not in n}
    run.check(kind == trace_top.DEVICE_KIND and sum(k6.values()) > 0 and sum(k7.values()) > 0,
              f"trace_top over three bf16 D forwards reads {kind}: K6 {k6}, K7a {k7}")
    kernel = next(e for e in events if e.get("cat") == "kernel")
    launch = next((e for e in events if e.get("cat") == "cuda_runtime"), {})
    print(f"[trace] a kernel event's args {sorted(kernel.get('args', {}))}; a runtime event's "
          f"args {sorted(launch.get('args', {}))}", flush=True)
    trace_top.main([str(trace_dir), "12"])
    agg, _, kind = trace_sweep.sweep(str(trace_dir))
    convs = {n: r for n, r in agg.items() if r["flops"] > 0 and r["ms"] > 0 and "conv" in r["op"]}
    run.check(kind == trace_top.DEVICE_KIND and bool(convs),
              f"trace_sweep gives {len(convs)} cuDNN convolution shape(s) a flop count and "
              f"device time, e.g. "
              f"{[(n[:70], r['flops'], r['ms']) for n, r in list(convs.items())[:2]]}")
    trace_sweep.main([str(trace_dir), "--top", "12"])
    shutil.rmtree(trace_dir, ignore_errors=True)
    del disc, x
    torch.cuda.empty_cache()


def phase_disc_and_tools(run: Run, seed: int, card: str) -> dict:
    t0 = time.perf_counter()
    launches = _phase_disc(run, seed, card)
    _phase_tools(run, seed, card)
    print(f"[disc] phase 14 took {time.perf_counter() - t0:.1f} s", flush=True)
    return launches


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(f"[device] {torch.cuda.get_device_name(0)} | {smi} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    run = Run()
    timings: dict = {}
    t0 = time.perf_counter()
    phase_build()
    phase_kernels(run, args.seed, timings)
    launches, packed_launches = phase_flagship(run, args.seed)
    phase_cli(run, args.seed, smi)
    phase_timing(run, args.seed, timings, smi)
    phase_profile(run, args.seed, PROFILE_ROUNDS, smi)
    train_launches = phase_train(run, args.seed, smi)
    phase_stackb_kernels(run, args.seed, timings)
    psp_launches = phase_psp(run, args.seed)
    phase_psp_timing(run, args.seed, PSP_ROUNDS, smi)
    phase_stackb_backward(run, args.seed, timings)
    psp_train_launches = phase_psp_train(run, args.seed, smi)
    workdir = Path(SMOKE_DATA)
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    try:
        det_path, det_state = phase_unet_train(run, args.seed, smi, workdir)
        phase_reference_fid(run, args.seed, smi, workdir, det_path, det_state)
        phase_other_encoders(run, args.seed, smi, workdir)
        phase_data_parallel(run, args.seed, smi, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    phase_disc_and_tools(run, args.seed, smi)
    print(f"[done] {time.perf_counter() - t0:.1f} s", flush=True)
    if run.failures:
        print(f"chip_smoke: {len(run.failures)} check(s) failed:", file=sys.stderr)
        for f in run.failures:
            print("  " + f, file=sys.stderr)
        return 1

    kernels = []
    for name, meta in KERNELS.items():
        meta = dict(meta)
        timed_dtype = meta.pop("timed_dtype", "bfloat16")
        ms, plain_ms, bound_ms, bound_by, library_ms = timings[(name, timed_dtype)]
        # K4b and K4a count one forward of the configuration that runs them,
        # K5 one config-5 training step, K6 and K7a one pSp forward, K6's
        # backward and K7b one config-4 training step
        n = (packed_launches[name] if name in ("conv3x3_stats", "convt_pair")
             else train_launches[name] if name == "flash_attention_bwd"
             else psp_launches[name] if name in ("upfirdn2d", "fused_leaky_relu")
             else psp_train_launches[name] if name in ("upfirdn2d_bwd", "fused_leaky_relu_bwd")
             else launches[name])
        kernels.append({"name": name, **meta, "launches": n,
                        "max_abs_err": run.err[name], "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound_ms, "bound_by": bound_by,
                        "library_ms": library_ms})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
