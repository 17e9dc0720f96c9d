"""Smoke run of the PyTorch/CUDA port (vaeplay_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; each raises on failure and nothing is caught:

1. build   -- compile every CUDA source of the port with nvcc.
2. kernels -- hold each kernel (f32: csrc/flash_attention.cu; bf16:
              csrc/flash_attention_bf16.cu, chosen by the operands' dtype)
              against its plain PyTorch version on the card (TF32 off), at
              the shapes of the BP path, at ragged shapes and at Dk = 128,
              with q, k, v position-major (contiguous (B, N, C), which the
              wrapper copies into the TMA's form) and channel-major
              (transpose views of (B, C, N), the layout the model passes,
              with a channel-major result; read in place by the TMA engine
              or, where it cannot describe them, by the threads' direct
              loads), and time kernel, plain version and the PyTorch
              library call. Then the attention under autograd:
              the gradients of `SpatialAttention` (the forward kernel and the
              backward kernel, csrc/flash_attention_bwd.cu, each launched
              once) against autograd through the plain
              version; at the training batch of 8, the forward and the
              gradients against the plain version, then their times. And at
              RefineNet's shape (BC: B 8 and 32, N 258, Dk 32, Dv 256) both
              layouts and both dtypes against the plain version, the
              gradients, and at B = 32 the kernel, plain and library times.
              And at BCP's point-attention shape (B 16 and 4, N 2048, Dk 32,
              Dv 260) the same, the route of the model's layout (TMA, no
              copy), the times at both batches and the plain backward's at
              B = 16.
              And at BE_font's embedding-block shape (B 32 and 8, N 1, Dk
              32, Dv 256), in the model's layout (channel and position
              stride both 1) and position-major, both dtypes, against the
              plain version and against v (a softmax over one key is 1);
              the gradients with dq and dk exactly 0; the route (direct, no
              copy); the kernel's, the plain version's, the library call's
              and the plain backward's times. (At BC's N 258 too the f32
              kernel reads the model's k and v by the direct route, with no
              copy.) And with bf16 operands (the bf16 kernel, bf16 wgmma):
              at BP's training shape (B 8, N 2048, Dk 90, Dv 720, the
              model's layout, as bf16 autocast leaves them)
              SpatialAttention's bf16 forward and gradients against
              autograd of the plain version in f32; then at BP's, BCP's (N
              2048 and the 4096 cap), BC's (N 258) and BE_font's (N 1)
              shapes in the model's layout the kernel against the plain
              version of the same arithmetic (P rounded to bf16) and
              against the plain version in f32, its route (TMA at N 2048
              and 4096, direct at 258 and 1) and the bytes copied (0), and
              the times of the kernel, the plain version and the library
              call in bf16, with the backend it chose. Last the backward
              kernel at BP's (B 4 and 8, f32; B 8, bf16), BCP's (N 2048 and
              4096), BC's (N 258) and BE_font's (N 1) shapes in the
              model's layout: the log-sum-exp the forward kernel writes
              against the plain one, the gradients against the plain
              attention_backward, and the kernel's, the plain backward's
              and SDPA's backward's times beside the kernel's bound.
3. slice   -- BP inference through the port's test_bp CLI at 512 px, batch 4,
              the full emit-channel pyramid, seeded random weights with every
              attention gamma nonzero: one CLI run that must write a PNG,
              then a warm-up and three timed synthetic batches, at PyTorch's
              default precision and again in strict f32, and a profile of a
              few more forwards. Every forward must launch the attention
              kernel exactly 9 times.
4. parity  -- the same weights and image at batch 1: the card's forward
              (kernels) against the port's CPU forward (plain versions).
5. train   -- BP training through the port's train_bp CLI at 512 px, batch
              8, the full pyramid, synthetic data: one epoch of 4
              iterations, a resume of that run for a second epoch, and
              test_bp rendering the resumed run dir. Every iteration must
              launch the attention kernel exactly 18 times (9 per pass) and
              every logged loss be finite. Then a warm-up and three timed
              iterations at PyTorch's defaults, each launching the forward
              and the backward kernel 18 times, the peak device memory, and
              a profile of one iteration by kernel group.
6. train parity -- one two-pass iteration on the card and on the CPU from
              the same weights and batch (128 px, batch 2, a narrow
              pyramid, TF32 off): the seven losses and pass 1's gradients.
7. vae-train -- the circle VAE-GAN through the port's train_vae CLI at the
              JAX package's benchmark shape (bench.py: 256 px, batch 128,
              z 128, circles rendered on the card): bf16 for an epoch of 4
              steps, a resume of it for a second, f32 for an epoch of 2;
              every logged loss finite, a grid per epoch, a checkpoint per
              epoch. Then the step's FLOPs from the layer shapes and its
              bound at the bf16 and TF32 tensor rates, a warm-up and three
              timed steps in f32 and in bf16 at PyTorch's defaults with the
              peak device memory, and a profile of a bf16 step by kernel
              group. The attention kernel is on no path here, and its launch
              count must not move.
8. vae parity -- one f32 VAE-GAN step on the card and on the CPU from the
              same weights, circle batch and injected noise (64 px, batch
              4, z 32, TF32 off): the five losses, every gradient and the
              BatchNorm running buffers.
9. be-infer -- BE (ResNet50-FPN bubble mask and edge segmentation) inference
              through the port's test_be CLI at 512 px, batch 8, full width,
              seeded random weights with random FrozenBatchNorm constants:
              one CLI run that must write its two grids, then a warm-up and
              three timed batches (host clock around the copy, forward,
              sigmoid and synchronize), the peak device memory, the forward's
              FLOPs and bound, and a profile by kernel group.
10. be-train -- BE training through the port's train_be CLI at 512 px, batch
              32, full width, bubbles rendered and augmented on the card:
              bf16 for an epoch of 3 iterations, a resume of it for a second,
              f32 for an epoch of 2, and test_be on the resumed run dir.
              Then the step's FLOPs and bound, a warm-up and three timed
              steps in f32 and in bf16 with the peak device memory, and a
              profile of a step in each by kernel group.
11. be parity -- one BE training step at 128 px, batch 2, the full-width
              backbone, on the card and on the CPU from the same weights and
              noise images (TF32 off): in f32 both losses and every BatchNorm
              buffer, in f64 the losses, every gradient and every buffer.
12. be-serve -- BE's manga-page serving path: a synthetic chapter of 3
              pages (1200 x 1700 px, 6-12 drawn bubbles each, labelme files
              and coarse masks) through the port's test_be_manga CLI at 512
              px, full width, random FrozenBatchNorm constants: f32 on the
              annotation and the mask route, bf16 on the annotation route,
              every page writing its PNG; the bit-packed masks against the
              card's thresholded make_be_eval_step maps; per page in f32 and
              bf16 the median predict latency (uint8 upload, forward, packed
              copy back), bubbles/s, the paste, and the bytes copied each
              way; a profiled page.
13. be_gan-train -- BE_GAN through the port's train_be_gan CLI at 512 px,
              batch 16, full width, bubbles rendered on the card: bf16 for an
              epoch of 3 iterations, a resume of it, f32 for an epoch of 2;
              test_be_gan_manga on the resumed run dir over phase 12's
              chapter. Then the step's FLOPs and bound, a warm-up and three
              timed steps in f32 and bf16 with the D and G phases apart and
              the peak device memory, and a profile of a step in each.
14. be_gan parity -- one BE_GAN step at 128 px, batch 2, the full-width
              backbone, on the card and on the CPU (TF32 off): in f32 the
              seven losses and both nets' buffers, in f64 the losses, both
              nets' gradients and every buffer.
15. bc-infer -- BC (contour extraction and refinement) inference through the
              port's test_bc CLI at 256 px, batch 8, full width (ResNet50-FPN,
              RefineNet's six attention blocks, fc0 66048 -> 8256), seeded
              random weights with random FrozenBatchNorm constants and
              nonzero gammas: --debug (one synthetic batch) and --path over a
              synthetic BCDataset tree, each writing its grids; then a
              warm-up and three timed batches (host clock around the copy,
              the forward with its mid-forward mask copy, the host trace and
              the refine stage, and the synchronize; the trace apart), the
              peak device memory, the forward's FLOPs and bound (bc_flops),
              and a profile. Every forward launches the kernel 6 times.
16. bc-train -- BC training through the port's train_bc CLI at 256 px, batch
              32, full width, synthetic data: f32 for an epoch of 3
              iterations, a resume of it for a second, bf16 compute with bf16
              refine layers for an epoch of 2, then test_bc on the resumed
              run dir (each run dir deleted once checked; the checkpoints'
              size and write time printed). Then the step's FLOPs and bound,
              a warm-up and three timed steps in each dtype with the trace
              apart, the peak device memory, and a profile of a step in
              each. Every iteration launches the kernel 6 times.
17. bc parity -- one BC step at 128 px, batch 2, the full-width backbone, 32
              points, injected contours, on the card and on the CPU (TF32
              off): in f32 the three losses and every buffer, in f64 (the
              plain attention on both: the kernel takes no f64) the losses,
              every gradient and every buffer; then with contours traced, the
              binary masks agree except within 1e-6 of the threshold and every
              sample with equal masks traces the same points.
18. bcp-infer -- BCP (contour point classification and regression)
              inference through the port's test_bcp CLI at 512 px, batch 4,
              2048 points, full width (two 8-block towers, the class head to
              2048 channels), seeded random weights: --debug and --path over
              a synthetic class-2/3 tree, each writing its grids; then a
              warm-up and three timed batches (the host trace of channel 1
              apart from the copy and forward), the peak device memory, the
              forward's FLOPs and bound (bcp_flops), a profile; then the
              point-attention forward at batch 4, 3 launches each.
19. bcp-train -- BCP training through the port's train_bcp CLI at 512 px,
              batch 16, 2048 points, full width (D's first local layer 8192
              -> 8192): f32 for an epoch of 3 iterations, a resume of it for a
              second, bf16 for an epoch of 2, f32 with --point_attention for
              an epoch of 2 (3 launches an iteration), test_bcp on the resumed
              run dir (each run dir deleted once checked). Then G's and D's
              parameter counts, and in f32, bf16 and f32 with point attention
              the step's FLOPs and bound, a warm-up and three timed steps with
              the copy, G's forward, the D phase and the G phase apart, the
              peak device memory and a profile of a step.
20. bcp parity -- one BCP step at 128 px, batch 2, full width, 128 points,
              with and without point attention, on the card and on the CPU
              (TF32 off): in f32 the eight losses and both nets' weights after
              the step (plus Adam's first-step slope times the gradients'
              difference), in f64 (the plain attention on both) the losses and
              both nets' gradients.
21. be_font-infer -- BE_font (conditional kana-mask GAN) inference through
              the port's test_be_font CLI at 64 px, batch 8, full width
              (167.37 M parameters), seeded random weights with nonzero
              gammas: --debug (one synthetic batch through both conditioning
              paths, 6 launches) and --path over a synthetic kana folder (the
              self-encoded path, no launch), each writing its grids; then a
              warm-up and three timed batches on the label path (6 launches
              each) and on the self-encoded path (none) apart, the forwards'
              FLOPs and bound, a profile of each and the peak memory.
22. be_font-train -- BE_font training through the port's train_be_font CLI
              at 64 px, batch 32, full width, synthetic glyphs composited on
              the host: f32 for an epoch of 3 iterations, a resume of it for
              a second, bf16 for an epoch of 2 (54 launches an iteration),
              test_be_font on the resumed run dir (each run dir deleted once
              checked). Then G's and D's parameter counts, the step's FLOPs
              and bound, and in f32 and bf16 a warm-up and three timed steps
              with the host synthesis, the copy and the D, G and S phases
              apart, 54 launches each, the peak memory and a profile.
23. be_font parity -- one BE_font step at 64 px, batch 4, full width, on the
              card and on the CPU (TF32 off), each phase from the same state
              on both: in f32 each phase's losses and the weights its Adam
              stepped (plus Adam's first-step slope times the gradients'
              difference), in f64 (the plain attention on both) each phase's
              losses and gradients, dq and dk of every block exactly 0.
24. bp_bf16-train -- BP training in bf16 through train_bp --dtype bfloat16
              at 512 px, batch 8, the full pyramid: an epoch of 3 iterations
              (18 launches each), test_bp on the run dir; a warm-up and three
              timed bf16 iterations beside phase 5's f32 ones, the peak
              memory and a profile; one iteration in bf16 and one in f32 on
              the card from the same weights and batch, the seven losses
              within the JAX package's bf16 budget (5% + 0.05).
25. style_gan-train -- Style_GAN (the bubble-style VAE-GAN) through the
              port's train_style_gan CLI at 256 px, z 512, batch 32: f32 for
              an epoch of 2 iterations, a resume of it with --scan_steps 2,
              bf16 for an epoch (each run dir deleted once checked: a
              checkpoint is about 5.2 GB). Then E's, G's and D's parameter
              counts, the step's FLOPs and bound blended and at the (16, 16)
              split, and in f32 and bf16, blended and split, a warm-up and
              three timed steps with the E/G phase, the latent loss with G's
              step and the D phase apart, the peak memory, and a profile of
              the blended step in each dtype.
26. style_gan parity -- one Style_GAN step at 64 px, z 512, batch 4, full
              width, blended (f32 also at the (2, 2) split), on the card and
              on the CPU (TF32 off), phase by phase from the same state: in f32 the
              losses and the weights each Adam stepped (plus Adam's slope
              times the gradients' difference), in f64 the losses and the
              gradients of the net each phase steps.
27. bc-bridge -- BC's two-program bridge (train/steps_bc.py: the mask step,
              BridgeTracer; cli/train_bc.py:run_epoch) at 256 px, batch 32,
              256 points, full width: one sync step at stride 1 against one
              in-forward step from the same state and batch (TF32 off:
              identical contours, the losses, weights and BatchNorm buffers
              within phase 17's f32 bound), epochs of 4 steps in sync and
              overlap at stride 4 (finite losses, 6 launches a train step,
              none in a mask step), the host ms a step of the in-forward
              path, sync and overlap over epochs of 6, and the share of the
              stride-4 trace the caller did not wait for; then
              pipeline_bc_batches over 4 batches of 8 against the
              sequential loop (equal outputs) and both times.
28. mesh    -- train_vae (256 px, batch 128, bf16), train_bc (256 px, batch
              32) and train_bcp --point_attention (512 px, 2048 points,
              batch 16) with --mesh 1x1, 2 iterations each, over a world of
              one rank on nccl, each beside the run without --mesh from the
              same seed: the backend, the checkpoints' keys and shapes, the
              first logged losses and the kernel launches the same.
29. ring    -- the ring attention's block update and its backward
              (parallel/ring_attention.py) over 4 key/value blocks in one
              process at BCP's 4096-point cap (16, 4096, 32, 260), f32, TF32
              off, against the plain attention and the kernel, and their
              times; ring_self_attention at world 1 through autograd.
              (Phase 2 holds the kernel at that shape too: both layouts,
              gradients, the plain backward's peak memory, the kernel,
              plain and library times.)
The attention kernels are on no path of phases 7-14, 25 and 26: their
launch count must not move there. Phases 3, 5, 15-16, 18-19, 21-22, 24, 27
and 28 are driven with the counts set to 0 before them; each prints its
launches by kernel and route ("[routes]"), and none may copy k or v.

It prints the card's name and power limit, one JSON line describing the
two kernels (their launches on the main paths by route), and as its last
line {"ok": true, "device": {...}}. It exits
non-zero without a result when no CUDA device is present.

    python3 chip_smoke.py --profile-only

builds the kernels and runs only phase 3's profile (the device time of a BP
forward by kernel group); run from another checkout of the repo, it profiles
that checkout's package, so two versions compare with one script.
"""

import contextlib
import copy
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# NVIDIA's data-sheet peaks for one H100 SXM (dense): f32 outside the tensor
# cores, TF32 on the tensor cores, and HBM3 bandwidth. They assume the card's
# full 700 W power limit.
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES_PER_S = 3.35e12
# The f32 attention kernel's engine: TF32 tensor cores in three passes
# (big*big + big*small + small*big), wgmma for P.V and mma.sync for the
# scores, K and V loaded by the TMA engine or the threads. The bf16 kernel's:
# one pass of bf16 wgmma for both products.
ENGINE = "wgmma m64n120k8 + mma.sync m16n8k8, tf32x3"
ENGINE_BF16 = "wgmma m64n64k16 bf16, both products"
# The backward kernel's: TF32 tensor cores, three passes for f32 operands and
# the passes with a nonzero small part for bf16 ones (S, dP one; dV, dK, dQ
# two); wgmma for dV, dP, dK and the dV kernel's scores, mma.sync for the
# dK/dQ kernel's scores and dQ.
ENGINE_BWD = "wgmma m64nNk8 (N 32-256) + mma.sync m16n8k8, tf32x3 (bf16 operands: 1 or 2 passes)"
TF32_PASSES = 3

# (B, N, Dk, Dv) of the BP attention (models/bp.py: 2048 embedding dims as
# positions, 720 points as channels, q/k reduced 8x) and the ragged shapes.
BP_SHAPE = (4, 2048, 90, 720)
RAGGED = [(2, 64, 4, 32), (2, 100, 8, 16), (2, 256, 16, 128), (2, 333, 5, 7),
          (2, 2049, 90, 720), (2, 2049, 5, 7)]
DK_MAX = [(2, 300, 128, 200), (1, 2048, 128, 720)]  # the kernel's largest Dk
# f32: the kernel and the plain version both compute in f32 and differ only in
# summation order. bf16: both compute the scores and the sums in f32 from the
# bf16 operands and round P to bf16 before P.V (the kernel against its key
# tiles' running max, the plain version after normalising) and the output
# once, so they differ by up to one bf16 rounding of each (2^-8 relative)
# plus summation order.
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-2, 1e-2)}
# the Function's gradients against autograd of the plain version, both f32 on
# the card: 1e-4 of each gradient's largest magnitude (ds = (dp - sum(dp *
# attn)) * attn cancels, so an element's error follows its gradient's scale)
# plus 1e-4 relative; the forward inside is the kernel's, within TOL
GRAD_TOL = (1e-4, 1e-4)
PARITY_TOL = (1e-3, 1e-3)  # card forward vs CPU forward, see phase_parity
PER_FORWARD = 9  # attention launches: 3 ValueEncoder + 3 tower-a + 3 tower-b blocks
PER_ITERATION = 2 * PER_FORWARD  # a training iteration: the full model, then stage 2
IMG = 512  # the reference's image size (train_BP.py:131-145, test_BP.py)
TRAIN_BATCH, TRAIN_ITERATIONS = 8, 4  # the reference trainer's batch (train_BP.py:131-145)
# phase 6 on the CPU as well: 128 px, batch 2, the tests' narrow pyramid
TRAIN_PARITY = dict(img=128, batch=2,
                    channels=((16, 2), (32, 2), (64, 2), (64, 2), (64, 2), (64, 1), (64, 1)))
# losses and pass 1's gradients, card vs CPU: 1e-3 of each gradient's largest
# magnitude (or of each loss) plus 1e-3 relative, see phase_train_parity
TRAIN_PARITY_TOL = (1e-3, 1e-3)
# the circle VAE-GAN at the JAX package's benchmark shape (bench.py:35-45):
# VaeGan(img_size=256, z_size=128), batch 128; the CLI runs an epoch of
# VAE_ITERATIONS[dtype] steps, then VAE_TIMED steps are timed after a warm-up
VAE_IMG, VAE_BATCH, VAE_Z = 256, 128, 128
VAE_ITERATIONS = {"bfloat16": 4, "float32": 2}
VAE_TIMED = 3
PEAK_BF16_FLOPS = 989e12  # dense, NVIDIA's data sheet, at 700 W
# phase 8 on the CPU as well: 64 px, batch 4, z 32; losses, gradients and BN
# buffers within 1e-3 of each tensor's largest magnitude plus 1e-3 relative
VAE_PARITY = dict(img=64, batch=4, z=32)
VAE_PARITY_TOL = (1e-3, 1e-3)
# BE at the JAX CLIs' defaults: test_be batch 8, train_be batch 32, 512 px,
# ResNet50 (3, 4, 6, 3) x 64, FPN 256; the CLI runs an epoch of
# BE_ITERATIONS[dtype] iterations, then BE_TIMED steps are timed after a warm-up
BE_IMG, BE_INFER_BATCH, BE_TRAIN_BATCH = 512, 8, 32
BE_ITERATIONS = {"bfloat16": 3, "float32": 2}
BE_TIMED = 3
# phase 11 on the CPU as well: 128 px, batch 2, the full-width backbone; in
# f32 the losses and BN buffers within 1e-3 of each tensor's largest
# magnitude plus 1e-3 relative, in f64 the losses, gradients and BN buffers
# within 1e-9 (see phase_be_parity)
BE_PARITY = dict(img=128, batch=2)
BE_PARITY_TOL = {torch.float32: (1e-3, 1e-3), torch.float64: (1e-9, 1e-9)}
# fpn.layer_blocks.0's output meets aux_convs.0, a 1x1 convolution and then a
# train-mode BatchNorm, which takes out any per-channel constant: its bias's
# true gradient is 0 and both sides hold rounding, so it is held to the bound
# of its layer's weight gradient
BE_ZERO_GRADS = {"grad feature_net.backbone.fpn.layer_blocks.0.bias":
                 "grad feature_net.backbone.fpn.layer_blocks.0.weight"}
# phase 12: a synthetic manga chapter of SERVE_PAGES pages, (w, h) px, each
# page's crops predicted and pasted SERVE_ROUNDS times for its median; packed
# bits may differ from the thresholded maps only where |logit| < SERVE_NEAR_ZERO
SERVE_PAGES, SERVE_PAGE_SIZE, SERVE_ROUNDS = 3, (1200, 1700), 3
SERVE_NEAR_ZERO = 1e-5
# phase 13: BE_GAN at the JAX CLI's defaults (train_be_gan.py:39-43: 512 px,
# batch 16); the CLI runs an epoch of BE_GAN_ITERATIONS[dtype] iterations
BE_GAN_BATCH = 16
BE_GAN_ITERATIONS = {"bfloat16": 3, "float32": 2}
# phase 14 on the CPU as well: 128 px (the discriminator's smallest), batch
# 2, the full-width backbone, BE_PARITY_TOL's bounds
BE_GAN_PARITY = dict(img=128, batch=2)
BE_GAN_ZERO_GRADS = {"grad g backbone.fpn.layer_blocks.0.bias":
                     "grad g backbone.fpn.layer_blocks.0.weight"}
# BC at the JAX CLIs' defaults (train_bc.py:35-45, test_bc.py:28-30): 256 px,
# up to 256 contour points, test_bc batch 8, train_bc batch 32; ResNet50
# (3, 4, 6, 3) x 64 with FPN 256 and RefineNet's fc0 66048 -> 8256. The CLI
# runs an epoch of BC_ITERATIONS[dtype] iterations; BC_TIMED steps are timed
# after a warm-up
BC_IMG, BC_POINTS, BC_INFER_BATCH, BC_TRAIN_BATCH = 256, 256, 8, 32
BC_ITERATIONS = {"float32": 3, "bfloat16": 2}
BC_TIMED = 3
BC_PER_FORWARD = 6  # attention launches: RefineNet's six blocks
# (B, N, Dk, Dv) of RefineNet's attention: 258 feature positions, 256 points
# as channels, q/k reduced 8x; at test_bc's and train_bc's batch
BC_SHAPES = [(BC_INFER_BATCH, 258, 32, 256), (BC_TRAIN_BATCH, 258, 32, 256)]
# phase 17 on the CPU as well: 128 px, batch 2, the full-width backbone, 32
# points; BE_PARITY_TOL's bounds; traced masks may differ only where the
# CPU's probability is within BC_PROB_MARGIN of the 0.5 threshold
BC_PARITY = dict(img=128, batch=2, points=32)
BC_PROB_MARGIN = 1e-6
# BCP at the JAX CLIs' defaults (train_bcp.py:37-45, test_bcp.py:30-32): 512
# px, up to 2048 contour points, test_bcp batch 4, train_bcp batch 16; G's two
# 8-block towers of 64 channels, the class head widening to 2048 channels, D's
# local branch from 2048 x 4 = 8192 inputs. The CLI runs an epoch of
# BCP_ITERATIONS[run] iterations ("attention": f32 with --point_attention);
# BCP_TIMED steps are timed after a warm-up
BCP_IMG, BCP_POINTS, BCP_INFER_BATCH, BCP_TRAIN_BATCH = 512, 2048, 4, 16
BCP_ITERATIONS = {"float32": 3, "bfloat16": 2, "attention": 2}
BCP_TIMED = 3
BCP_PER_FORWARD = 3  # attention launches with --point_attention: the three point blocks
# (B, N, Dk, Dv) of the point attention: 2048 points as positions, 2 x 128 + 4
# point features as channels, q/k reduced 8x; at train_bcp's and test_bcp's batch
BCP_SHAPES = [(BCP_TRAIN_BATCH, BCP_POINTS, 32, 260), (BCP_INFER_BATCH, BCP_POINTS, 32, 260)]
# phase 20 on the CPU as well: 128 px, batch 2, full width, 128 points, with
# and without point attention; BE_PARITY_TOL's bounds, and in f32 the weights
# after the step also Adam's first-step slope lr / eps times the gradients'
# difference (a gradient of rounding size may take either sign)
BCP_PARITY = dict(img=128, batch=2, points=128, lr=1e-3)
# an attention block's k bias has a true gradient of 0 (the softmax takes out
# a per-row shift): it is held to its layer's weight gradient's bound
BCP_ZERO_GRADS = {f"grad g line_predictor.batch_attention.{i}.k.conv.0.bias":
                  f"grad g line_predictor.batch_attention.{i}.k.conv.0.weight" for i in range(3)}
# BE_font at the JAX CLIs' defaults (train_be_font.py:37-57, test_be_font.py:29):
# 64 px, train_be_font batch 32, test_be_font batch 8; G 64 -> 512 channels
# with the relay FCs 8704 -> 8192 -> 8192, D's two Classifiers to 1024
# channels. The CLI runs an epoch of FONT_ITERATIONS[dtype] iterations;
# FONT_TIMED steps are timed after a warm-up
FONT_IMG, FONT_INFER_BATCH, FONT_TRAIN_BATCH = 64, 8, 32
FONT_ITERATIONS = {"float32": 3, "bfloat16": 2}
FONT_TIMED = 3
# attention launches: G's EmbedPair (two EmbedingBlocks of three blocks) on
# the label path, none on the self-encoded one; D's two Classifiers' EmbedPairs
FONT_PER_G_FORWARD, FONT_PER_D_FORWARD = 6, 12
FONT_PER_STEP = 3 * FONT_PER_G_FORWARD + 3 * FONT_PER_D_FORWARD  # 54
# (B, N, Dk, Dv) of the embedding blocks' attention: a (B, 256, 1, 1) map,
# one position, q/k reduced 8x; at train_be_font's and test_be_font's batch
FONT_SHAPES = [(FONT_TRAIN_BATCH, 1, 32, 256), (FONT_INFER_BATCH, 1, 32, 256)]
# phase 23 on the CPU as well: 64 px, batch 4, full width; BE_PARITY_TOL's bounds
FONT_PARITY = dict(img=64, batch=4, lr=1e-4)
# BP training in bf16 (phase 24, and phase 2 at its attention shape): 512 px,
# batch 8, the full pyramid; the CLI runs an epoch of BP_BF16_ITERATIONS
BP_BF16_SHAPE = (TRAIN_BATCH,) + BP_SHAPE[1:]  # (8, 2048, 90, 720)
BP_BF16_ITERATIONS = 3
# the bf16 attention's output and gradients (the bf16 kernel, P and the
# output rounded to bf16; the recompute backward in f32, its gradients
# rounded to bf16) against autograd of the plain version in f32 on the same
# bf16 values: one bf16 rounding (2^-8 relative) of P and of each element,
# plus summation order, within 1e-2 of the largest magnitude + 1e-2 relative
BF16_ATTENTION_TOL = (1e-2, 1e-2)
# phase 2's bf16 kernel shapes in the model's layout, with the route each
# takes: BP's training shape, BCP's point attention at N 2048 and its 4096
# cap, BC's RefineNet at N 258, BE_font's embedding blocks at N 1
BF16_SHAPES = [("BP", (8, 2048, 90, 720), "tma"), ("BCP", (16, 2048, 32, 260), "tma"),
               ("BCP cap", (16, 4096, 32, 260), "tma"), ("BC", (32, 258, 32, 256), "direct"),
               ("BE_font", (32, 1, 32, 256), "direct")]
# phase 2's backward kernel shapes, (tag, (B, N, Dk, Dv), dtype), in the
# model's layout: BP at B 4 and 8, BCP's point attention and its cap, BC's
# RefineNet at N 258 and BE_font's embedding blocks at N 1 (both by the
# forward's direct route), in f32 and where a model trains in bf16 with
# attention, in bf16
BWD_SHAPES = [("BP B4", BP_SHAPE, torch.float32), ("BP", BP_BF16_SHAPE, torch.float32),
              ("BP bf16", BP_BF16_SHAPE, torch.bfloat16),
              ("BCP", (BCP_TRAIN_BATCH, BCP_POINTS, 32, 260), torch.float32),
              ("BCP cap", (BCP_TRAIN_BATCH, 4096, 32, 260), torch.float32),
              ("BC", (BC_TRAIN_BATCH, 258, 32, 256), torch.float32),
              ("BC bf16", (BC_TRAIN_BATCH, 258, 32, 256), torch.bfloat16),
              ("BE_font", (FONT_TRAIN_BATCH, 1, 32, 256), torch.float32),
              ("BE_font bf16", (FONT_TRAIN_BATCH, 1, 32, 256), torch.bfloat16)]
# bf16 losses against f32: the JAX package's budget (tests/test_bf16_families.py:
# 22-29), 5% relative + 0.05
BF16_BUDGET = (0.05, 0.05)
# Style_GAN at the JAX CLI's defaults (train_style_gan.py:32-69, the
# reference's train_Style_GAN.py:287-302): 256 px, z 512, batch 32, two
# classes; the CLI runs epochs of SG_ITERATIONS iterations, SG_TIMED steps
# are timed after a warm-up, blended and at the (B/2, B/2) split
SG_IMG, SG_Z, SG_BATCH = 256, 512, 32
SG_ITERATIONS = 2
SG_TIMED = 3
SG_SPLIT = (SG_BATCH // 2, SG_BATCH // 2)
# phase 26 on the CPU as well: 64 px, z 512, batch 4, full width;
# BE_PARITY_TOL's bounds
SG_PARITY = dict(img=64, batch=4, z=512, lr=1e-4)


# phase 2 at BCP's 4096-point cap (the model's, networks_BCP.py:71) at
# train_bcp's batch; phase 29 holds the ring's block update at the same shape
BCP_CAP = (BCP_TRAIN_BATCH, 4096, 32, 260)
# phase 27: BC's bridge at 256 px, batch 32, f32; epochs of BRIDGE_EPOCH steps
# in sync and overlap, and each host time a step the median of BRIDGE_TIMED
# epochs of BRIDGE_STEPS steps
BRIDGE_EPOCH, BRIDGE_TIMED, BRIDGE_STEPS = 4, 3, 6
# phase 28: --mesh 1x1 trainer runs of MESH_ITERATIONS iterations over a
# world of one rank; the first logged losses against the same run without
# --mesh (the same kernels on the same inputs) within MESH_LOSS_RTOL
MESH_ITERATIONS = 2
MESH_LOSS_RTOL = 1e-6
RING_BLOCKS = 4  # phase 29: key/value blocks of the ring, in one process


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over iters launches, by CUDA events."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


@contextlib.contextmanager
def strict_f32():
    """f32 matmuls and convolutions in full f32 (no TF32) inside the block;
    PyTorch's defaults (TF32 convolutions, f32 matmuls) are restored after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def phase_build() -> None:
    from vaeplay_torch.ops import _build

    t0 = time.perf_counter()
    report = _build.build()
    print(f"[build] {len(report)} libraries in {time.perf_counter() - t0:.1f} s")
    for name, r in report.items():
        print(f"[build] {name}: {r['seconds']:.1f} s")
        for line in r["log"].splitlines():
            if any(w in line for w in ("entry function", "registers", "spill", "error")):
                print(f"[build]   {line.strip()}")


def _qkv(shape, dtype, seed, q_scale=1.0, layout="nc"):
    """Seeded q, k, v of shape (B, N, C). layout is one letter per tensor:
    'n' position-major (contiguous (B, N, C)), 'c' channel-major (the
    transpose view of a contiguous (B, C, N); at N = 1 channel and position
    stride are both 1, as SelfAttentionBlock passes a (B, C, 1, 1) map);
    one letter stands for all three."""
    b, n, dk, dv = shape
    layout = layout * 3 if len(layout) == 1 else layout
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k = (torch.randn(b, n, dk, generator=g, device="cuda") for _ in range(2))
    v = torch.randn(b, n, dv, generator=g, device="cuda")
    out = []
    for t, form in zip(((q * q_scale), k, v), layout):
        t = t.to(dtype)
        if form == "c":  # (at N = 1 a .contiguous() would keep the (B, 1, C) strides)
            t = torch.empty_like(t.transpose(1, 2), memory_format=torch.contiguous_format).copy_(
                t.transpose(1, 2)).transpose(1, 2)
        out.append(t)
    return tuple(out)


def _check_case(shape, dtype, layout, q_scale, seed) -> float:
    """The kernel against the plain version on one case; returns the max abs
    error. Channel-major inputs go through spatial_self_attention, whose
    result must be channel-major too."""
    from vaeplay_torch.ops import attention

    q, k, v = _qkv(shape, dtype, seed, q_scale, layout)
    if shape == BP_SHAPE and layout == "c" and attention.kernel_operands(k, v)[2] != "tma":
        raise AssertionError("the model's layout at the BP shape does not take the TMA route")
    if layout == "c":
        got = attention.spatial_self_attention(q, k, v)
        if not got.transpose(1, 2).is_contiguous():
            raise AssertionError(f"channel-major inputs gave strides {got.stride()}")
    else:
        got = attention.flash_attention(q, k, v)
    torch.cuda.synchronize()
    ref = attention.reference_attention(q, k, v)
    atol, rtol = TOL[dtype]
    err = (got.float() - ref.float()).abs()
    bad = int((err > atol + rtol * ref.float().abs()).sum())
    max_err = float(err.max())
    rel = max_err / max(float(ref.float().abs().max()), 1e-30)
    # a softmax over one key is 1: at N = 1 the output is v
    against_v = (f", {float((got.float() - v.float()).abs().max()):.3e} against v"
                 if shape[1] == 1 else "")
    print(f"[kernels] flash_attention_fwd B,N,Dk,Dv={shape} {str(dtype)[6:]} layout {layout}: "
          f"max abs err {max_err:.3e}, max rel err {rel:.3e} "
          f"(atol {atol:g}, rtol {rtol:g}), {bad} outside{against_v}")
    if got.shape != ref.shape or bad or not torch.isfinite(got).all():
        raise AssertionError(f"flash_attention_fwd disagrees with the plain version at "
                             f"{shape} {dtype} layout {layout}")
    return max_err


def phase_kernels(gpu: str) -> dict:
    from vaeplay_torch.ops import attention

    # BP's shape with unit-variance inputs (a peaked softmax), the ragged
    # shapes with q scaled down: a flat softmax, where a padded key column
    # that escaped the mask would carry as much weight as a real one. Layout
    # 'n' is position-major, 'c' channel-major (the model's), 'ncn' and 'cnc'
    # mix the two (q, k, v in turn).
    cases = [(BP_SHAPE, torch.float32, 1.0, "n"), (BP_SHAPE, torch.bfloat16, 1.0, "n")]
    cases += [(s, torch.float32, 0.05, "n") for s in RAGGED]
    cases += [(BP_SHAPE, torch.float32, 1.0, "c"), (BP_SHAPE, torch.bfloat16, 1.0, "c")]
    cases += [(s, torch.float32, 0.05, "c") for s in RAGGED]
    cases += [(s, torch.bfloat16, 0.05, "c") for s in RAGGED[3:]]
    cases += [(s, torch.float32, 0.05, lay) for s in DK_MAX for lay in ("n", "c")]
    cases += [(RAGGED[3], torch.float32, 0.05, "ncn"), (RAGGED[4], torch.float32, 0.05, "cnc")]
    bp_err = None
    for i, (shape, dtype, q_scale, layout) in enumerate(cases):
        err = _check_case(shape, dtype, layout, q_scale, seed=i)
        if shape == BP_SHAPE and dtype == torch.float32 and layout == "c":
            bp_err = err

    # timed at the BP shape in f32, channel-major as the model passes them
    # (kernel, plain version and library call on the same views), and
    # position-major for comparison (there flash_attention copies k and v
    # into the kernel's layout first)
    ms, plain_ms, library_ms = _forward_times(BP_SHAPE, "c")
    bound_ms, bound_by, flops = _forward_bound(BP_SHAPE)
    print(f"[kernels] BP shape f32, channel-major, on {gpu}: kernel_ms {ms:.4f}, "
          f"plain_ms {plain_ms:.4f}, library_ms {library_ms:.4f}, bound_ms {bound_ms:.4f} "
          f"({TF32_PASSES} x {flops / 1e9:.2f} GFLOP at {PEAK_TF32_FLOPS / 1e12:.0f} TFLOP/s "
          f"TF32), bound_f32_cuda_core_ms {flops / PEAK_F32_FLOPS * 1e3:.4f}; "
          f"kernel at {flops / ms / 1e9:.1f} TFLOP/s counted once, "
          f"{bound_ms / ms:.1%} of its bound")
    times_n = _forward_times(BP_SHAPE, "n")
    print(f"[kernels] BP shape f32, position-major, on {gpu}: flash_attention_ms "
          f"(copies of k and v, then the kernel) {times_n[0]:.4f}, "
          f"plain_ms {times_n[1]:.4f}, library_ms {times_n[2]:.4f}")
    return {"name": "flash_attention_fwd", "route": "cuda",
            "source": "vaeplay_torch/ops/csrc/flash_attention.cu",
            "replaces": "vaeplay_tpu/ops/attention.py:37", "engine": ENGINE,
            "launches": None, "launches_by_route": None, "max_abs_err": bp_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def _model_route(shape, dtype, want: str, tag: str) -> None:
    """The route the model's layout (channel-major) takes at `shape`: `want`,
    with no byte copied, or a raise."""
    from vaeplay_torch.ops import attention

    q, k, v = _qkv(shape, dtype, seed=0, layout="c")
    before = attention.flash_attention.copied_bytes
    route = attention.kernel_operands(k, v)[2]
    copied = attention.flash_attention.copied_bytes - before
    print(f"[kernels] {tag} shape B,N,Dk,Dv={shape} {str(dtype)[6:]}, the model's layout: k and v "
          f"read by the {route} route, {copied} bytes copied (position stride {k.stride(1)}, "
          f"channel stride {k.stride(2) * k.element_size()} bytes)")
    if route != want or copied:
        raise AssertionError(f"{tag}: the model's layout took the {route} route, {copied} bytes "
                             f"copied; want {want}, none")


def _forward_times(shape, layout: str):
    """CUDA-event ms of the kernel, the plain version and the library call
    (scaled_dot_product_attention) on the same f32 q, k, v in `layout`."""
    from vaeplay_torch.ops import attention

    b, n, _, dv = shape
    q, k, v = _qkv(shape, torch.float32, seed=0, layout=layout)
    out = (torch.empty(b, dv, n, device="cuda").transpose(1, 2) if layout == "c"
           else torch.empty(b, n, dv, device="cuda"))
    q4, k4, v4 = q[:, None], k[:, None], v[:, None]
    return (cuda_ms(lambda: attention.flash_attention(q, k, v, out=out)),
            cuda_ms(lambda: attention.reference_attention(q, k, v)),
            cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                q4, k4, v4, scale=1.0)))


def _forward_bound(shape, dtype=torch.float32):
    """(bound_ms, bound_by, flops) of the attention forward on `dtype`
    operands: the larger of its products at the tensor-core rate for that
    type (f32: TF32, three passes each; bf16: one pass at the bf16 rate, the
    operands being exact there) and its bytes in that type (q, k, v read
    once, the output written once) at the memory rate."""
    b, n, dk, dv = shape
    flops = 2.0 * b * n * n * (dk + dv)
    passes, peak = (1, PEAK_BF16_FLOPS) if dtype == torch.bfloat16 else (TF32_PASSES,
                                                                         PEAK_TF32_FLOPS)
    t_ops = passes * flops / peak * 1e3
    itemsize = torch.empty((), dtype=dtype).element_size()
    t_bytes = itemsize * (2 * b * n * dk + 2 * b * n * dv) / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes", flops


def _backward_bound(shape, dtype=torch.float32):
    """(bound_ms, bound_by, flops) of the attention backward on `dtype`
    operands at benchmark.core.peaks' rates: the larger of its products,
    2 B N^2 (3 Dk + 2 Dv), in the passes that keep each f32-accurate (f32
    operands: three TF32 passes each; bf16 operands: S and dP, products of
    two bf16 operands, once at the bf16 rate, and dV, dK and dQ, whose P or
    dS stays f32-accurate, two TF32 passes) and its bytes in that type (q,
    k, v, out and g read once, dq, dk and dv written once) at the memory
    rate."""
    from benchmark.core import peaks

    b, n, dk, dv = shape
    flops = 2.0 * b * n * n * (3 * dk + 2 * dv)
    if dtype == torch.float32:
        t_ops = TF32_PASSES * flops / peaks.PEAK_FLOPS["float32"]
    else:
        t_ops = (2.0 * b * n * n * (dk + dv) / peaks.PEAK_FLOPS["bfloat16"]
                 + 2 * 2.0 * b * n * n * (dv + 2 * dk) / peaks.PEAK_FLOPS["float32"])
    itemsize = peaks.ITEMSIZE[str(dtype)[6:]]
    t_bytes = itemsize * b * n * (4 * dk + 4 * dv) / peaks.PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes", flops)


def phase_kernel_backward_times(gpu: str) -> dict:
    """Phase 2's backward kernel at each of BWD_SHAPES, in the model's layout:
    the log-sum-exp the forward kernel writes against reference_lse (TOL[f32])
    and its one-hot flags (differing in under 1e-3 of the rows),
    the kernel's gradients against attention_backward (f32: GRAD_TOL; bf16:
    BF16_ATTENTION_TOL, each side rounding once to bf16), and the times of
    the kernel, the plain attention_backward and the library's backward
    (scaled_dot_product_attention, scale 1, on position-major copies: a
    yardstick only) beside the kernel's bound. Returns the kernels line's
    entry for the backward kernel."""
    from vaeplay_torch.ops import attention

    sdpa = torch.nn.functional.scaled_dot_product_attention
    entry = {"name": "flash_attention_bwd", "route": "cuda",
             "source": "vaeplay_torch/ops/csrc/flash_attention_bwd.cu",
             "replaces": "vaeplay_tpu/ops/attention.py:_pallas_attention_bwd (an einsum VJP, no "
                         "Pallas kernel)", "engine": ENGINE_BWD, "launches": None}
    for i, (tag, shape, dtype) in enumerate(BWD_SHAPES):
        b, n, dk, dv = shape
        key = tag.lower().replace(" ", "_")
        q, k, v = _qkv(shape, dtype, seed=1200 + i, layout="c")
        g = _qkv(shape, dtype, seed=1300 + i, layout="c")[2]
        out = torch.empty(b, dv, n, dtype=dtype, device="cuda").transpose(1, 2)
        lse = torch.empty(2, b, n, device="cuda")
        attention.flash_attention(q, k, v, out=out, lse=lse)
        ref_lse = attention.reference_lse(q, k)
        held_lse = _worst(lse[0], ref_lse[0], TOL[torch.float32])
        # the one-hot flags may differ only where a row's sum lies within
        # rounding of 1 + ONE_HOT
        flags_differ = float((lse[1] != ref_lse[1]).float().mean())
        got = attention.flash_attention_backward(q, k, v, out, lse, g)
        ref = attention.attention_backward(q, k, v, g)
        torch.cuda.synchronize()
        tol = GRAD_TOL if dtype == torch.float32 else BF16_ATTENTION_TOL
        held = max(_worst(x.float(), r.float(), tol) for x, r in zip(got, ref))
        layouts = all(x.stride(1) == 1 for x in got) or n == 1
        if held_lse > 1 or flags_differ > 1e-3 or held > 1 or not layouts or not all(
                bool(torch.isfinite(x).all()) for x in got):
            raise AssertionError(f"the backward kernel disagrees with attention_backward at "
                                 f"{tag} {shape} {dtype} (lse {held_lse:.3f}, one-hot flags "
                                 f"{flags_differ:.2e} differing, gradients {held:.3f} of their "
                                 f"bounds, channel-major {layouts})")
        ms = cuda_ms(lambda: attention.flash_attention_backward(q, k, v, out, lse, g), iters=10)
        plain_ms = cuda_ms(lambda: attention.attention_backward(q, k, v, g), iters=5)
        q4, k4, v4 = (t.contiguous()[:, None].requires_grad_() for t in (q, k, v))
        g4, backend = g.contiguous()[:, None], "default"
        try:
            o4 = sdpa(q4, k4, v4, scale=1.0)
            torch.autograd.grad(o4, (q4, k4, v4), g4, retain_graph=True)
        except RuntimeError:  # no backward kernel of its default backends (N = 1)
            backend = "MATH"
            from torch.nn.attention import SDPBackend, sdpa_kernel

            with sdpa_kernel([SDPBackend.MATH]):
                o4 = sdpa(q4, k4, v4, scale=1.0)
        library_ms = cuda_ms(lambda: torch.autograd.grad(o4, (q4, k4, v4), g4,
                                                         retain_graph=True), iters=5)
        bound_ms, bound_by, flops = _backward_bound(shape, dtype)
        print(f"[kernels] flash_attention_bwd {tag} B,N,Dk,Dv={shape} {str(dtype)[6:]}, "
              f"channel-major, on {gpu}: lse at {held_lse:.3f} of TOL, one-hot rows "
              f"{int(lse[1].sum())} ({flags_differ:.2e} differing), dq, dk, dv at "
              f"{held:.3f} of their bound against attention_backward, channel-major; "
              f"kernel_ms {ms:.4f}, plain_ms {plain_ms:.4f}, library_ms {library_ms:.4f} "
              f"({backend} backend), bound_ms {bound_ms:.4f} ({bound_by}: {flops / 1e9:.2f} GFLOP, "
              f"{'3 TF32 passes' if dtype == torch.float32 else 'S and dP bf16, the rest 2 TF32 passes'}), "
              f"{bound_ms / ms:.1%} of its bound, {plain_ms / ms:.2f}x the plain version")
        entry.update({f"{key}_shape": list(shape), f"{key}_ms": ms, f"{key}_plain_ms": plain_ms,
                      f"{key}_library_ms": library_ms, f"{key}_bound_ms": bound_ms,
                      f"{key}_bound_by": bound_by})
    return entry


def _worst(got: torch.Tensor, ref: torch.Tensor, tol, scale: float = None) -> float:
    """Largest |got - ref| over atol x max |ref| (or x scale) + rtol x |ref|;
    above 1 fails."""
    atol, rtol = tol
    bound = atol * (float(ref.abs().max()) if scale is None else scale) + rtol * ref.abs()
    return float(((got - ref).abs() / bound.clamp(min=1e-30)).max())


def _hold_step(tag: str, label: str, ref: tuple, got: tuple, dtype, lr: float,
               scale_key=lambda k: k) -> None:
    """Holds a training step's (or one of its phases') results on the card
    against the CPU's: ref and got are (losses, tensors), the tensors keyed
    "grad <name>" and "weight <name>" after the step. Every loss within
    BE_PARITY_TOL[dtype]; in f64 every gradient, within the tolerance of the
    largest magnitude of the reference at scale_key(k) (a gradient whose
    true value is 0 is held to a neighbour's scale); in f32 every weight,
    within the bound plus Adam's first-step slope lr / eps times the
    gradients' difference. Prints both, and raises above 1 or on a value
    that is not finite."""
    (ref_m, ref_t), (got_m, got_t) = ref, got
    tol, f64 = BE_PARITY_TOL[dtype], dtype == torch.float64
    worst_loss, loss = max((_worst(got_m[k], ref_m[k], tol), k) for k in ref_m)
    held = {}
    for k in ref_t:
        if f64 and k.startswith("grad"):
            held[k] = _worst(got_t[k], ref_t[k], tol, float(ref_t[scale_key(k)].abs().max()))
        elif not f64 and k.startswith("weight"):
            gk = "grad" + k[len("weight"):]
            slack = 1.001 * lr / 1e-8 * (got_t[gk] - ref_t[gk]).abs()
            bound = tol[0] * float(ref_t[k].abs().max()) + tol[1] * ref_t[k].abs() + slack
            held[k] = float(((got_t[k] - ref_t[k]).abs() / bound.clamp(min=1e-30)).max())
    worst, name = max((v, k) for k, v in held.items())
    print(f"[{tag}] {label} losses card vs CPU: " + " ".join(
        f"{k}={float(got_m[k]):.6f}/{float(ref_m[k]):.6f}" for k in ref_m))
    print(f"[{tag}] {label}: worst loss at {worst_loss:.2e} of its bound ({loss}), worst of "
          f"{len(held)} {'gradients' if f64 else 'weights'} at {worst:.2e} ({name}); bound atol "
          f"{tol[0]:g} x max |ref| + rtol {tol[1]:g} x |ref|"
          f"{'' if f64 else ' + lr / eps x |grad difference|'}")
    if worst_loss > 1 or worst > 1 or not all(
            bool(torch.isfinite(t).all()) for t in list(got_t.values()) + list(got_m.values())):
        raise AssertionError(f"[{tag}] the card's {label} disagrees with the CPU's")


def _grad_check(shape, layout, q_scale, seed) -> None:
    """spatial_self_attention's gradients (the forward and backward kernels)
    against autograd through the plain version on the same inputs and output
    gradient."""
    from vaeplay_torch.ops import attention

    q, k, v = _qkv(shape, torch.float32, seed, q_scale, layout)
    g = _qkv(shape, torch.float32, seed + 1000, 1.0, layout)[2]
    before = attention.flash_attention.launches
    bwd_before = attention.flash_attention_backward.launches
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    attention.spatial_self_attention(qg, kg, vg).backward(g)
    qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))
    attention.reference_attention(qr, kr, vr).backward(g)
    torch.cuda.synchronize()
    if attention.flash_attention.launches != before + 1:
        raise AssertionError("the Function's forward did not launch the kernel once")
    if attention.flash_attention_backward.launches != bwd_before + 1:
        raise AssertionError("the Function's backward did not launch the kernel once")
    worst = max(_worst(got, ref, GRAD_TOL) for got, ref in (
        (qg.grad, qr.grad), (kg.grad, kr.grad), (vg.grad, vr.grad)))
    finite = all(bool(torch.isfinite(t.grad).all()) for t in (qg, kg, vg))
    exact = (" (dq and dk exactly 0 on both sides: a reference of 0 bounds at 0)"
             if shape[1] == 1 and not any(bool(t.any()) for t in (qr.grad, kr.grad)) else "")
    print(f"[kernels] backward B,N,Dk,Dv={shape} layout {layout}: dq, dk, dv at {worst:.3f} of "
          f"the bound (atol {GRAD_TOL[0]:g} x max |ref| + rtol {GRAD_TOL[1]:g} x |ref|){exact}")
    if worst > 1 or not finite:
        raise AssertionError(f"the Function's gradients disagree with autograd of the plain "
                             f"version at {shape} layout {layout}")


def phase_kernels_bc(gpu: str) -> dict:
    """Phase 2 at RefineNet's shape: the kernel against the plain version at
    BC_SHAPES in both layouts and both dtypes, the Function's gradients in
    both layouts, and at B = 32 (train_bc's batch) the times of the kernel,
    the plain version and the library call, channel-major as the model
    passes them (the direct route), and of the kernel on the same values
    with rows padded for the TMA route. Returns the kernel line's BC keys."""
    from vaeplay_torch.ops import attention

    err = None
    for i, shape in enumerate(BC_SHAPES):
        for dtype in (torch.float32, torch.bfloat16):
            for layout in ("n", "c"):
                e = _check_case(shape, dtype, layout, 1.0, seed=300 + i)
                if shape == BC_SHAPES[-1] and dtype == torch.float32 and layout == "c":
                    err = e
        for layout in ("c", "n"):
            _grad_check(shape, layout, 1.0, seed=310 + i)
    shape = BC_SHAPES[-1]
    _model_route(shape, torch.float32, "direct", "BC")
    ms, plain_ms, library_ms = _forward_times(shape, "c")
    bound_ms, bound_by, flops = _forward_bound(shape)
    # the same values with rows padded to 260 positions, which the TMA takes
    b, n, dk, dv = shape
    q, k, v = _qkv(shape, torch.float32, seed=0, layout="c")
    k, v = (torch.zeros(b, t.shape[2], n + 2, device="cuda")[:, :, :n].copy_(t.transpose(1, 2))
            .transpose(1, 2) for t in (k, v))
    res = torch.empty(b, dv, n, device="cuda").transpose(1, 2)
    if attention.kernel_operands(k, v)[2] != "tma":
        raise AssertionError("BC's padded k and v do not take the TMA route")
    tma_ms = cuda_ms(lambda: attention.flash_attention(q, k, v, out=res))
    backend = _sdpa_backend(*(t[:, None] for t in _qkv(shape, torch.float32, 0, layout="c")))
    print(f"[kernels] BC shape B,N,Dk,Dv={shape} f32, channel-major, on {gpu}: kernel_ms {ms:.4f} "
          f"(k and v read in place by the direct route, 0 bytes copied; by TMA, rows padded to "
          f"{n + 2}: {tma_ms:.4f}), plain_ms {plain_ms:.4f}, library_ms {library_ms:.4f} "
          f"(backend {backend}), bound_ms "
          f"{bound_ms:.5f} ({bound_by}: {TF32_PASSES} x {flops / 1e9:.3f} GFLOP at "
          f"{PEAK_TF32_FLOPS / 1e12:.0f} TFLOP/s TF32), {bound_ms / ms:.1%} of its bound")
    return {"bc_shape": list(shape), "bc_max_abs_err": err, "bc_ms": ms, "bc_tma_ms": tma_ms,
            "bc_plain_ms": plain_ms,
            "bc_bound_ms": bound_ms, "bc_bound_by": bound_by, "bc_library_ms": library_ms,
            "bc_launches": None}


def phase_kernels_bcp(gpu: str) -> dict:
    """Phase 2 at BCP's point-attention shape: the kernel against the plain
    version at BCP_SHAPES (B 16 and 4, N 2048, Dk 32, Dv 260: one block of
    264 value columns, the last 4 masked) in both layouts and both dtypes,
    the Function's gradients in both layouts, whether the model's
    channel-major k and v reach the kernel with no copy, then at each batch
    the times of the kernel, the plain version and the library call
    (channel-major), and at B = 16 the plain backward's. Returns the kernel
    line's BCP keys (bcp_* at B = 16, bcp_b4_* at B = 4)."""
    from vaeplay_torch.ops import attention

    out = {}
    for i, shape in enumerate(BCP_SHAPES):
        for dtype in (torch.float32, torch.bfloat16):
            for layout in ("n", "c"):
                e = _check_case(shape, dtype, layout, 1.0, seed=400 + i)
                if dtype == torch.float32 and layout == "c":
                    out["bcp_max_abs_err" if i == 0 else "bcp_b4_max_abs_err"] = e
        for layout in ("c", "n"):
            _grad_check(shape, layout, 1.0, seed=410 + i)
    _model_route(BCP_SHAPES[0], torch.float32, "tma", "BCP")
    q, k, v = _qkv(BCP_SHAPES[0], torch.float32, seed=0, layout="c")
    for key, shape in (("bcp", BCP_SHAPES[0]), ("bcp_b4", BCP_SHAPES[1])):
        ms, plain_ms, library_ms = _forward_times(shape, "c")
        bound_ms, bound_by, flops = _forward_bound(shape)
        print(f"[kernels] BCP shape B,N,Dk,Dv={shape} f32, channel-major, on {gpu}: kernel_ms "
              f"{ms:.4f}, plain_ms {plain_ms:.4f}, library_ms {library_ms:.4f}, bound_ms "
              f"{bound_ms:.4f} ({bound_by}: {TF32_PASSES} x {flops / 1e9:.2f} GFLOP at "
              f"{PEAK_TF32_FLOPS / 1e12:.0f} TFLOP/s TF32), {bound_ms / ms:.1%} of its bound")
        out.update({f"{key}_shape": list(shape), f"{key}_ms": ms, f"{key}_plain_ms": plain_ms,
                    f"{key}_bound_ms": bound_ms, f"{key}_bound_by": bound_by,
                    f"{key}_library_ms": library_ms})
    b, n, dk, dv = BCP_SHAPES[0]
    g = _qkv(BCP_SHAPES[0], torch.float32, seed=1000, layout="c")[2]
    bwd_ms = cuda_ms(lambda: attention.attention_backward(q, k, v, g), iters=10)
    bwd_flops = 2.0 * b * n * n * (3 * dk + 2 * dv)
    print(f"[kernels] BCP backward at B={b}, f32 (no TF32), channel-major, on {gpu}: "
          f"attention_backward_ms {bwd_ms:.4f} (recompute: 5 bmm + softmax over "
          f"{b * n * n * 4 / 2**20:.0f} MiB N x N buffers); {bwd_flops / 1e9:.2f} GFLOP, "
          f"{bwd_flops / PEAK_F32_FLOPS * 1e3:.4f} ms at {PEAK_F32_FLOPS / 1e12:.0f} TFLOP/s f32; "
          f"backward / forward kernel {bwd_ms / out['bcp_ms']:.2f}")
    out.update(bcp_backward_ms=bwd_ms, bcp_launches=None)
    return out


def phase_kernel_backward(gpu: str) -> None:
    """Phase 2's autograd half: the Function's gradients at the BP shape and
    the ragged shapes in both layouts; then, at the shape the training path
    gives the kernel (B = 8, channel-major), the forward and the gradients
    against the plain version on the inputs that are timed after."""
    from vaeplay_torch.ops import attention

    for i, shape in enumerate([BP_SHAPE] + RAGGED):
        for layout in ("c", "n"):
            _grad_check(shape, layout, 1.0 if shape == BP_SHAPE else 0.05, seed=100 + i)

    shape = (TRAIN_BATCH,) + BP_SHAPE[1:]
    _check_case(shape, torch.float32, "c", 1.0, seed=0)  # _forward_times' q, k, v
    _grad_check(shape, "c", 1.0, seed=0)
    b, n, dk, dv = shape
    fwd_ms, plain_ms, library_ms = _forward_times(shape, "c")
    bound_ms, _, flops = _forward_bound(shape)
    print(f"[kernels] forward at B={b} (the training batch), f32, channel-major, on {gpu}: "
          f"kernel_ms {fwd_ms:.4f}, plain_ms {plain_ms:.4f}, library_ms {library_ms:.4f}, "
          f"bound_ms {bound_ms:.4f} ({TF32_PASSES} x {flops / 1e9:.2f} GFLOP at "
          f"{PEAK_TF32_FLOPS / 1e12:.0f} TFLOP/s TF32), {bound_ms / fwd_ms:.1%} of its bound")

    q, k, v = _qkv(shape, torch.float32, seed=0, layout="c")
    g = _qkv(shape, torch.float32, seed=1000, layout="c")[2]  # _grad_check's g
    bwd_ms = cuda_ms(lambda: attention.attention_backward(q, k, v, g), iters=10)
    qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))
    ref_out = attention.reference_attention(qr, kr, vr)
    autograd_ms = cuda_ms(lambda: torch.autograd.grad(ref_out, (qr, kr, vr), g,
                                                      retain_graph=True), iters=10)
    bwd_flops = 2.0 * b * n * n * (3 * dk + 2 * dv)
    print(f"[kernels] backward at B={b}, f32 (no TF32), channel-major, on {gpu}: "
          f"attention_backward_ms {bwd_ms:.4f} (recompute: 5 bmm + softmax), plain autograd "
          f"backward_ms {autograd_ms:.4f} (saved softmax: 4 bmm); {bwd_flops / 1e9:.2f} GFLOP, "
          f"{bwd_flops / PEAK_F32_FLOPS * 1e3:.4f} ms at {PEAK_F32_FLOPS / 1e12:.0f} TFLOP/s f32; "
          f"backward / forward kernel {bwd_ms / fwd_ms:.2f}; per training iteration "
          f"({PER_ITERATION} of each) {PER_ITERATION * fwd_ms:.2f} ms forward, "
          f"{PER_ITERATION * bwd_ms:.2f} ms backward")


def _draw_gammas(model, g: torch.Generator) -> None:
    """Every attention gamma from +-[0.2, 0.6] (they start at 0, which would
    hide the attention output)."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".gamma"):
                sign = 1.0 if torch.rand(1, generator=g).item() < 0.5 else -1.0
                p.copy_(sign * (0.2 + 0.4 * torch.rand(1, generator=g)))


def random_model(seed: int = 0, image_size: int = IMG, emit_channels=None):
    """A seeded random ComposeNet (the full emit-channel pyramid unless
    emit_channels is given) with every attention gamma drawn (_draw_gammas)."""
    from vaeplay_torch.models.bp import ComposeNet

    model = ComposeNet(image_size=image_size, emit_channels=emit_channels,
                       generator=torch.Generator().manual_seed(seed))
    _draw_gammas(model, torch.Generator().manual_seed(seed + 1))
    return model


def random_weights(path: str, seed: int = 0) -> None:
    """random_model's weights at 512 px, saved as test_bp's --model_path reads
    them."""
    torch.save(random_model(seed).state_dict(), path)


def _check_outputs(preds, batch: int) -> None:
    shapes = {"ellipse_params": (batch, 5), "if_triggers": (batch, 720, 2),
              "line_params": (batch, 720, 4), "sample_infos": (batch, 720, 6)}
    for name, shape in shapes.items():
        t = preds[name]
        if tuple(t.shape) != shape or not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{name}: shape {tuple(t.shape)} (want {shape}) or not finite")


def _time_batches(model, batches, dev, precision: str, gpu: str) -> None:
    """A warm-up forward, then one timed forward per remaining batch, each
    checked and each launching the attention kernel exactly 9 times."""
    from vaeplay_torch.cli import test_bp
    from vaeplay_torch.ops import attention

    _check_outputs(test_bp.predict(model, batches[0], dev), 4)
    torch.cuda.synchronize()
    for i, imgs in enumerate(batches[1:], 1):
        before = attention.flash_attention.launches
        t = time.perf_counter()
        preds = test_bp.predict(model, imgs, dev)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        _check_outputs(preds, 4)
        if attention.flash_attention.launches - before != PER_FORWARD:
            raise AssertionError(f"a forward did not launch the kernel {PER_FORWARD} times")
        print(f"[slice] batch {i}: {ms:.2f} ms ({precision}; batch 4, 512 px, host clock "
              f"incl. host-to-device copy) on {gpu}")


def _vae_gan_group(g: str, ops) -> str:
    """`g`, a kernel's `benchmark.core.trace.group`, with two kinds of its
    elementwise kernels named apart, as the VAE-GAN's breakdown reads them:
    FrozenBatchNorm's addcmul and the upsampling layers."""
    if not g.startswith("elementwise and other"):
        return g
    tail = g[len("elementwise and other"):]  # ", backward" or nothing
    node = next((o.rsplit(": ", 1)[-1] for o in ops
                 if o.startswith("autograd::engine::evaluate_function")), "")
    if node.startswith("AddcmulBackward") or "aten::addcmul" in ops:
        return "FrozenBatchNorm (addcmul)" + tail
    if node.startswith("Upsample") or any(o.startswith("aten::upsample") for o in ops):
        return "upsampling (bilinear, nearest)" + tail
    return g


def _profile(run, label: str, runs: int = 3) -> None:
    """Device time by kernel group per call of run(), over `runs` calls
    (after one profiled call, which pays CUPTI's start-up), against their
    wall time. Each kernel is grouped by its name and by the ops that
    launched it (an autograd node, the optimizer; `benchmark.core.trace.group`,
    refined by `_vae_gan_group`); a backward node is tied to its forward op
    by the autograd sequence number both carry. Busy time is the union of the device's activities
    (`benchmark.core.trace.busy`): a sum would count overlapping ones twice."""
    from torch.profiler import ProfilerActivity, profile

    from benchmark.core.trace import busy as union_s, group

    for n in (1, runs):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(n):
                run()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t) * 1e3 / n
    events = [e for e in prof.key_averages()
              if e.device_type.name == "CUDA" and not getattr(e, "is_user_annotation", False)]
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    activities = [(e.time_range.start, e.time_range.end) for e in prof.events()
                  if e.device_type.name == "CUDA" and not getattr(e, "is_user_annotation", False)]
    busy = union_s(activities, -math.inf, math.inf) / 1e3 / runs  # microseconds -> ms
    total = sum(e.self_device_time_total for e in events) / 1e3 / runs
    print(f"[{label}] profiled (PyTorch defaults): {busy:.2f} ms device busy, "
          f"{wall:.2f} ms wall, idle share {max(0.0, 1 - busy / wall):.3f}, "
          f"{sum(e.count for e in events) // runs} device activities")
    transposed_seq = {e.sequence_nr for e in prof.events()
                      if e.name == "aten::conv_transpose2d" and e.sequence_nr >= 0}
    groups = {}
    for e in prof.events():
        # "Command Buffer Full" is the tracer's span for a launch that waited
        # on a full launch queue: its kernels are the launching op's as well
        if e.device_type.name != "CPU" or not e.kernels or e.name == "Command Buffer Full":
            continue
        ops, parent, transposed = [], e, False
        while parent is not None:
            ops.append(parent.name)
            if parent.name.startswith("autograd::engine::evaluate_function"):
                transposed = parent.sequence_nr in transposed_seq
            parent = parent.cpu_parent
        for k in e.kernels:
            if k.name != e.name:  # a user range's own span on the device
                g = _vae_gan_group(group(k.name, ops, transposed), ops)
                groups[g] = groups.get(g, 0.0) + k.duration / 1e3 / runs
    groups["(not attributed to a launching op)"] = total - sum(groups.values())
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"[{label}]   {ms:8.3f} ms  {g}")
    for e in events[:12]:
        print(f"[{label}]   {e.self_device_time_total / 1e3 / runs:8.3f} ms  "
              f"x{e.count // runs:<3d} {e.key[:90]}")


def phase_slice(tmp: str, weights: str, gpu: str) -> int:
    """The main path: BP inference through the CLI on cuda:0. Returns the
    attention kernel's launches over the whole phase."""
    from vaeplay_torch.cli import test_bp
    from vaeplay_torch.data.bp_data import SyntheticEmitDataset
    from vaeplay_torch.ops import attention

    dev = torch.device("cuda", 0)
    attention.reset_counts()
    t0 = time.perf_counter()
    written = test_bp.main(["--model_path", weights, "--gpu", "0", "--img_size", "512",
                            "--batchsize", "4", "--res_output", os.path.join(tmp, "bp_test")])
    print(f"[slice] CLI run (load, one batch of 4 at 512 px, render) "
          f"{time.perf_counter() - t0:.2f} s; wrote {written}")
    if attention.flash_attention.launches != PER_FORWARD:
        raise AssertionError(f"CLI forward launched the kernel "
                             f"{attention.flash_attention.launches} times, not {PER_FORWARD}")
    if not written or not all(p.endswith(".png") and os.path.getsize(p) > 0 for p in written):
        raise AssertionError(f"CLI wrote no PNG: {written}")

    model = test_bp.load_model(weights, 512, dev)
    ds = SyntheticEmitDataset(img_size=512, data_size=16)
    batches = [ds.sample_batch(4, batch_seed=s)[0] for s in range(4)]
    _time_batches(model, batches, dev, "PyTorch defaults: TF32 convolutions", gpu)
    with strict_f32():
        _time_batches(model, batches, dev, "strict f32, no TF32", gpu)
    _profile(lambda: test_bp.predict(model, batches[1], dev), "slice")
    return attention.flash_attention.launches


def phase_parity(weights: str) -> None:
    """The card's forward (kernels, TF32 off) against the port's CPU forward
    (plain versions) on one image. Both run f32; they differ in conv and
    reduction order, which the softmax and the two stages can amplify, hence
    PARITY_TOL rather than the kernel's own 1e-4."""
    from vaeplay_torch.cli import test_bp
    from vaeplay_torch.data.bp_data import SyntheticEmitDataset

    cpu, dev = torch.device("cpu"), torch.device("cuda", 0)
    ds = SyntheticEmitDataset(img_size=512)
    cpu_model = test_bp.load_model(weights, 512, cpu)
    for seed in range(100, 120):
        img = ds.sample_batch(1, batch_seed=seed)[0]
        ref = test_bp.predict(cpu_model, img, cpu)
        step = float(ref["ellipse_params"][0, 4])
        if abs(step % 1.0 - 0.5) > 0.01:  # round(step) must not flip
            break
    else:
        raise AssertionError("every candidate image puts step near x.5")
    got = test_bp.predict(test_bp.load_model(weights, 512, dev), img, dev)
    atol, rtol = PARITY_TOL
    for name, r in ref.items():
        g = got[name].cpu()
        err = (g - r).abs()
        bad = int((err > atol + rtol * r.abs()).sum())
        print(f"[parity] {name}: max abs err {float(err.max()):.3e}, max |ref| "
              f"{float(r.abs().max()):.3e} (atol {atol:g}, rtol {rtol:g}), {bad} outside")
        if bad or not bool(torch.isfinite(g).all()):
            raise AssertionError(f"card forward disagrees with the CPU forward on {name}")


def _check_run(run: str, epoch: int, launches: int, iterations: int = TRAIN_ITERATIONS,
               viz_freq: int = 2, label: str = "train") -> None:
    """A train_bp run dir of one epoch of `iterations`: its checkpoint, a
    finite log line every viz_freq iterations, and PER_ITERATION kernel
    launches for each iteration."""
    from vaeplay_torch.cli import train_bp

    if launches != PER_ITERATION * iterations:
        raise AssertionError(f"{iterations} iterations launched the kernel {launches} "
                             f"times, not {PER_ITERATION} each")
    if sorted(os.listdir(run)) != [f"{epoch}.ckpt", "metrics.jsonl", "record.txt"]:
        raise AssertionError(f"run dir {run} holds {sorted(os.listdir(run))}")
    with open(os.path.join(run, "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    if [r["epoch"] for r in lines] != [epoch] * (iterations // viz_freq) or not all(
            math.isfinite(r[k]) for r in lines for k in train_bp.AVG_KEYS):
        raise AssertionError(f"logged losses of epoch {epoch}: {lines}")
    print(f"[{label}] epoch {epoch}: " + "; ".join(
        " ".join(f"{k}={r[k]:.4f}" for k in train_bp.AVG_KEYS) for r in lines))


def _timed_iterations(gpu: str, dtype: str = "float32", label: str = "train") -> list:
    """A warm-up and three timed training iterations in `dtype` at PyTorch's
    defaults (host clock, each from host batch to synchronize), the peak
    device memory, and a profile of one iteration. Returns the timed ms."""
    from vaeplay_torch.cli import train_bp
    from vaeplay_torch.data.bp_data import SyntheticEmitDataset
    from vaeplay_torch.ops import attention
    from vaeplay_torch.train.state import TrainState, step_lr_every_two_epochs
    from vaeplay_torch.train.steps_bp import make_bp_train_step
    from vaeplay_torch.utils.amp import resolve_dtype

    dev = torch.device("cuda", 0)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = random_model().to(dev)
    state = TrainState.create(model, 1e-3, step_lr_every_two_epochs(500))
    step = make_bp_train_step(model, resolve_dtype(dtype))
    timed = []
    ds = SyntheticEmitDataset(img_size=IMG)
    batches = [ds.sample_batch(TRAIN_BATCH, batch_seed=s) for s in range(5)]
    for i, batch in enumerate(batches[:4]):
        before = attention.flash_attention.launches
        bwd_before = attention.flash_attention_backward.launches
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, metrics = step(state, *train_bp.to_device(batch, dev))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        if (attention.flash_attention.launches - before != PER_ITERATION
                or attention.flash_attention_backward.launches - bwd_before != PER_ITERATION):
            raise AssertionError(f"an iteration did not launch the forward and backward kernels "
                                 f"{PER_ITERATION} times each")
        if not all(bool(torch.isfinite(v)) for v in metrics.values()):
            raise AssertionError(f"non-finite losses: {metrics}")
        if i:
            timed.append(ms)
        print(f"[{label}] {dtype} iteration {i}{' (warm-up)' if i == 0 else ''}: {ms:.2f} ms "
              f"(PyTorch defaults: TF32 convolutions; batch {TRAIN_BATCH}, {IMG} px, two passes, "
              f"host clock incl. host-to-device copy) on {gpu}")
    print(f"[{label}] {dtype} peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
          f"GiB (torch.cuda.max_memory_allocated: weights, gradients, Adam moments, activations)")
    imgs, p1, p2 = train_bp.to_device(batches[4], dev)
    _profile(lambda: step(state, imgs, p1, p2), f"{label} {dtype}", runs=1)
    return timed


def phase_train(tmp: str, gpu: str, timed: list) -> int:
    """The training path: train_bp on cuda:0 for one epoch, a resume of it
    for a second, test_bp on the resumed run dir; then timed iterations,
    whose ms are appended to `timed`. Returns the attention kernel's
    launches over the whole phase."""
    from vaeplay_torch.cli import test_bp, train_bp
    from vaeplay_torch.ops import attention

    attention.reset_counts()
    common = ["--gpu", "0", "--img_size", str(IMG), "--batchsize", str(TRAIN_BATCH),
              "--iterations", str(TRAIN_ITERATIONS), "--viz_freq", "2",
              "--res_output", os.path.join(tmp, "train_results")]
    t0 = time.perf_counter()
    run = train_bp.main(common + ["--epoch", "1", "--model_output", os.path.join(tmp, "a")])
    print(f"[train] CLI run (init, {TRAIN_ITERATIONS} iterations, checkpoint) "
          f"{time.perf_counter() - t0:.2f} s: {run}")
    _check_run(run, 0, attention.flash_attention.launches)

    before = attention.flash_attention.launches
    t0 = time.perf_counter()
    resumed = train_bp.main(common + ["--epoch", "2", "--resume", run,
                                      "--model_output", os.path.join(tmp, "b")])
    print(f"[train] resumed CLI run (restore, {TRAIN_ITERATIONS} iterations, checkpoint) "
          f"{time.perf_counter() - t0:.2f} s: {resumed}")
    _check_run(resumed, 1, attention.flash_attention.launches - before)

    before = attention.flash_attention.launches
    written = test_bp.main(["--model_path", resumed, "--gpu", "0", "--img_size", str(IMG),
                            "--batchsize", "4", "--res_output", os.path.join(tmp, "bp_trained")])
    if attention.flash_attention.launches - before != PER_FORWARD or not written or not all(
            p.endswith(".png") and os.path.getsize(p) > 0 for p in written):
        raise AssertionError(f"test_bp on the trained run dir wrote {written}")
    print(f"[train] test_bp --model_path <run dir> wrote {written}")
    shutil.rmtree(os.path.join(tmp, "a"))  # two checkpoints of about 1.1 GB each
    shutil.rmtree(os.path.join(tmp, "b"))

    timed.extend(_timed_iterations(gpu))
    return attention.flash_attention.launches


def phase_train_parity() -> None:
    """One two-pass iteration on the card (kernel forward) and on the CPU
    (plain forward) from the same seeded weights (gammas nonzero) and batch,
    TF32 off: the seven losses, and pass 1's gradients before any update.
    Gradients, not weights: Adam's first update is about lr * sign(g), which
    turns a rounding-sized gradient near 0 into a full-sized step. The images
    are uniform noise: on a black patch the zero-bias convolutions give
    pre-activations of exactly 0, where leaky ReLU's gradient jumps, and the
    card and the CPU may round them to either side."""
    import numpy as np

    from vaeplay_torch.cli import train_bp
    from vaeplay_torch.data.bp_data import SyntheticEmitDataset
    from vaeplay_torch.train.state import TrainState
    from vaeplay_torch.train.steps_bp import loss_phase1, make_bp_train_step

    cfg = TRAIN_PARITY
    base = random_model(3, cfg["img"], cfg["channels"])
    _, p1, p2 = SyntheticEmitDataset(img_size=cfg["img"]).sample_batch(cfg["batch"], 7)
    for seed in range(20):
        imgs = np.random.default_rng(seed).uniform(
            size=(cfg["batch"], cfg["img"], cfg["img"], 3)).astype(np.float32)
        with torch.no_grad():
            step = base(torch.from_numpy(imgs))["ellipse_params"][:, 4]
        if float((step % 1.0 - 0.5).abs().min()) > 0.01:  # round(step) must not flip
            break
    else:
        raise AssertionError("every candidate batch puts step near x.5")

    results = []
    for dev in (torch.device("cpu"), torch.device("cuda", 0)):
        batch = train_bp.to_device((imgs, p1, p2), dev)
        model = copy.deepcopy(base).to(dev)
        loss_phase1(model, *batch)[0].backward()
        grads = {k: p.grad.cpu() for k, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
        _, metrics = make_bp_train_step(model)(TrainState.create(model, 1e-3), *batch)
        results.append((grads, {k: v.cpu() for k, v in metrics.items()}))
    (ref_g, ref_m), (got_g, got_m) = results
    worst_loss = max(_worst(got_m[k], ref_m[k], TRAIN_PARITY_TOL) for k in ref_m)
    worst_grad, name = max((_worst(got_g[k], ref_g[k], TRAIN_PARITY_TOL), k) for k in ref_g)
    print(f"[train parity] losses card vs CPU: " + " ".join(
        f"{k}={float(got_m[k]):.6f}/{float(ref_m[k]):.6f}" for k in ref_m))
    print(f"[train parity] worst loss at {worst_loss:.3f} of its bound, worst pass-1 gradient "
          f"at {worst_grad:.3f} of its bound ({name}); bound atol {TRAIN_PARITY_TOL[0]:g} x "
          f"max |ref| + rtol {TRAIN_PARITY_TOL[1]:g} x |ref|, {len(ref_g)} tensors")
    if worst_loss > 1 or worst_grad > 1 or not all(
            bool(torch.isfinite(t).all()) for t in list(got_g.values()) + list(got_m.values())):
        raise AssertionError("the card's training iteration disagrees with the CPU's")


def _check_vae_run(run: str, epoch: int, dtype: str) -> None:
    """A train_vae run dir of one epoch: its checkpoint and one log line of
    finite losses."""
    from vaeplay_torch.cli import train_vae
    from vaeplay_torch.train.steps_vae import METRIC_KEYS

    if sorted(os.listdir(run)) != [f"{epoch}.ckpt", "metrics.jsonl"]:
        raise AssertionError(f"run dir {run} holds {sorted(os.listdir(run))}")
    with open(os.path.join(run, "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    if [r["epoch"] for r in lines] != [epoch] or not all(
            math.isfinite(r[k]) for r in lines for k in METRIC_KEYS):
        raise AssertionError(f"logged losses of epoch {epoch}: {lines}")
    r = lines[0]
    print(f"[vae-train] {dtype} epoch {epoch}: " + " ".join(
        f"{k}={r[k]:.4f}" for k in train_vae.AVG_KEYS)
        + f" ({r['images_per_sec']:.1f} img/s over the epoch, CLI's host clock)")


def _vae_cli(tmp: str, name: str, dtype: str, *extra) -> str:
    from vaeplay_torch.cli import train_vae

    n = VAE_ITERATIONS[dtype]
    t0 = time.perf_counter()
    run = train_vae.main(["--gpu", "0", "--img_size", str(VAE_IMG), "--batchsize", str(VAE_BATCH),
                          "--zdim", str(VAE_Z), "--data_size", str(n * VAE_BATCH),
                          "--viz_freq", str(n), "--dtype", dtype,
                          "--res_output", os.path.join(tmp, "vae_results"),
                          "--model_output", os.path.join(tmp, name), *extra])
    print(f"[vae-train] CLI run {dtype} {' '.join(extra)} (init, {n} steps, grid, checkpoint) "
          f"{time.perf_counter() - t0:.2f} s: {run}")
    return run


def vae_flops(img: int, z: int) -> dict:
    """Forward multiply-adds x 2 of one image through the VAE-GAN's training
    forward, by sub-network, from the layer shapes: every Conv2d, transpose
    conv and Linear the forward calls (the decoder twice, on z and z_p; the
    discriminator twice, REC and GAN, over 3 images each), counted by hooks
    on a forward at batch 2 on the meta device."""
    from vaeplay_torch.models.vae_gan import VaeGan

    with torch.device("meta"):
        model = VaeGan(img_size=img, z_size=z).eval()
    flops = {}

    def count(name):
        def hook(m, inputs, out):
            x = inputs[0]
            if isinstance(m, torch.nn.ConvTranspose2d):  # each input pixel to k*k outputs
                f = 2 * x.numel() * m.out_channels * m.kernel_size[0] * m.kernel_size[1]
            elif isinstance(m, torch.nn.Conv2d):
                f = 2 * out.numel() * m.in_channels * m.kernel_size[0] * m.kernel_size[1]
            else:
                f = 2 * x.numel() * m.out_features
            flops[name] = flops.get(name, 0) + f / 2  # per image
        return hook

    for group, sub in model.named_children():
        for m in sub.modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d, torch.nn.Linear)):
                m.register_forward_hook(count(group))
    x = torch.zeros(2, 1, img, img, device="meta")
    model(x, noise=(torch.zeros(2, z, device="meta"), torch.zeros(2, z, device="meta")))
    return flops


def _vae_timed(dtype: str, gpu: str) -> tuple:
    """A warm-up and VAE_TIMED steps of make_circle_train_step at PyTorch's
    defaults, each from the (B, 3) params on the host to synchronize, and
    the peak device memory. Returns (state, step, a further batch of params
    on the card, generator) for a profile, and the median step ms."""
    from vaeplay_torch.cli.train_vae import build_state
    from vaeplay_torch.data.circles import CircleDataset
    from vaeplay_torch.train.steps_vae import make_circle_train_step
    from vaeplay_torch.utils.amp import resolve_dtype

    dev = torch.device("cuda", 0)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = build_state(VAE_IMG, VAE_Z, 1e-4, 0, dev)
    step = make_circle_train_step(state.model, VAE_IMG, resolve_dtype(dtype))
    gen = torch.Generator(device=dev).manual_seed(2)
    batches = list(CircleDataset(n=VAE_IMG, data_size=(VAE_TIMED + 2) * VAE_BATCH)
                   .epoch_batches(VAE_BATCH))
    times = []
    for i, pb in enumerate(batches[:VAE_TIMED + 1]):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, metrics = step(state, torch.from_numpy(pb).to(dev), gen)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        if not all(bool(torch.isfinite(v)) for v in metrics.values()):
            raise AssertionError(f"non-finite losses: {metrics}")
        if i:
            times.append(ms)
        print(f"[vae-train] {dtype} step {i}{' (warm-up)' if i == 0 else ''}: {ms:.2f} ms, "
              f"{VAE_BATCH / ms * 1e3:.1f} images/s (PyTorch defaults; batch {VAE_BATCH}, "
              f"{VAE_IMG} px, z {VAE_Z}, host clock incl. the params' copy) on {gpu}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[vae-train] {dtype} peak device memory {peak:.2f} GiB "
          f"(torch.cuda.max_memory_allocated: weights, gradients, RMSprop state, activations)")
    return (state, step, torch.from_numpy(batches[-1]).to(dev), gen), sorted(times)[len(times) // 2]


def phase_vae_train(tmp: str, gpu: str) -> None:
    """The circle VAE-GAN through the train_vae CLI at bench.py's shape (256
    px, batch 128, z 128, on-device circles): bf16 for one epoch, a resume
    for a second, f32 for one epoch; then timed steps in both, the step's
    FLOPs and bound, and a profile of a bf16 step by kernel group. The
    attention kernel is on no path here: its launch count must not move."""
    from vaeplay_torch.ops import attention

    before = attention.flash_attention.launches
    run = _vae_cli(tmp, "vae_a", "bfloat16", "--epoch", "1")
    _check_vae_run(run, 0, "bfloat16")
    resumed = _vae_cli(tmp, "vae_b", "bfloat16", "--epoch", "2", "--resume", run)
    _check_vae_run(resumed, 1, "bfloat16")
    _check_vae_run(_vae_cli(tmp, "vae_c", "float32", "--epoch", "1"), 0, "float32")
    pngs = sorted(os.listdir(os.path.join(tmp, "vae_results")))
    if pngs != ["0_1.png", "0_3.png", "1_3.png"] or not all(
            os.path.getsize(os.path.join(tmp, "vae_results", p)) > 0 for p in pngs):
        raise AssertionError(f"train_vae wrote the grids {pngs}")
    print(f"[vae-train] grids {pngs}")
    for name in ("vae_a", "vae_b", "vae_c"):  # checkpoints of about 1.5 GB each
        shutil.rmtree(os.path.join(tmp, name))

    from vaeplay_torch.models.vae_gan import VaeGan

    with torch.device("meta"):
        n_params = sum(p.numel() for p in VaeGan(img_size=VAE_IMG, z_size=VAE_Z).parameters())
    flops = vae_flops(VAE_IMG, VAE_Z)
    fwd = sum(flops.values())
    step_flops = 3 * fwd * VAE_BATCH  # forward, then dgrad and wgrad in the backward
    print(f"[vae-train] {n_params / 1e6:.2f} M parameters; forward GFLOP per image from the "
          f"layer shapes: " + ", ".join(
        f"{k} {v / 1e9:.2f}" for k, v in flops.items()) + f"; total {fwd / 1e9:.2f}; "
        f"step (3 x forward x {VAE_BATCH}) {step_flops / 1e12:.2f} TFLOP, bound "
        f"{step_flops / PEAK_BF16_FLOPS * 1e3:.2f} ms at {PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s "
        f"bf16, {step_flops / PEAK_TF32_FLOPS * 1e3:.2f} ms at "
        f"{PEAK_TF32_FLOPS / 1e12:.0f} TFLOP/s TF32 (dense tensor-core rates, 700 W)")
    for dtype, peak, rate in (("float32", PEAK_TF32_FLOPS, "TF32"),
                              ("bfloat16", PEAK_BF16_FLOPS, "bf16")):
        profiled = None  # the f32 state is freed before bf16's peak is taken
        profiled, ms = _vae_timed(dtype, gpu)
        print(f"[vae-train] {dtype} median step {ms:.2f} ms, {VAE_BATCH / ms * 1e3:.1f} images/s, "
              f"{step_flops / ms / 1e9:.1f} TFLOP/s, {step_flops / peak * 1e3 / ms:.1%} of the "
              f"{rate} bound on {gpu}")
    state, step, pb, gen = profiled
    _profile(lambda: step(state, pb, gen), "vae-train", runs=1)
    del state, step, profiled
    torch.cuda.empty_cache()
    if attention.flash_attention.launches != before:
        raise AssertionError("the VAE-GAN path launched the attention kernel")


def phase_vae_parity() -> None:
    """One f32 training step of the VAE-GAN on the card and on the CPU from
    the same seeded weights, circle batch and injected noise (TF32 off): the
    five losses, every gradient, and the BatchNorm running buffers after the
    step's forward. Gradients, not weights: RMSprop's first update is about
    10 x lr x sign(g), which turns a rounding-sized gradient into a full step."""
    from vaeplay_torch.data.circles import CircleDataset
    from vaeplay_torch.models.vae_gan import VaeGan
    from vaeplay_torch.train.state import GroupedTrainState, torch_rmsprop
    from vaeplay_torch.train.steps_vae import GROUPS, METRIC_KEYS, circle_batch, vae_gan_losses

    cfg = VAE_PARITY
    base = VaeGan(img_size=cfg["img"], z_size=cfg["z"], generator=torch.Generator().manual_seed(11))
    raw = torch.from_numpy(next(CircleDataset(n=cfg["img"], data_size=cfg["batch"], seed=3)
                                .epoch_batches(cfg["batch"])))
    noise = base.draw_noise(cfg["batch"], torch.Generator().manual_seed(12), torch.device("cpu"))
    results = []
    for dev in (torch.device("cpu"), torch.device("cuda", 0)):
        model = copy.deepcopy(base).to(dev).train()
        state = GroupedTrainState.create(model, {g: torch_rmsprop(1e-4) for g in GROUPS})
        imgs, targets = circle_batch(cfg["img"], raw.to(dev))
        m = vae_gan_losses(model(imgs, noise=tuple(t.to(dev) for t in noise)), imgs, targets)
        state.zero_grad()
        sum(m[k] for k in METRIC_KEYS[:5]).backward()
        got = {f"grad {k}": p.grad.cpu() for k, p in model.named_parameters()}
        got.update({f"buffer {k}": b.cpu() for k, b in model.named_buffers()
                    if b.is_floating_point()})
        state.apply_gradients()
        results.append((got, {k: v.detach().cpu() for k, v in m.items()}))
    (ref_t, ref_m), (got_t, got_m) = results
    worst_loss, loss = max((_worst(got_m[k], ref_m[k], VAE_PARITY_TOL), k) for k in METRIC_KEYS[:5])
    worst, name = max((_worst(got_t[k], ref_t[k], VAE_PARITY_TOL), k) for k in ref_t)
    print(f"[vae parity] losses card vs CPU: " + " ".join(
        f"{k}={float(got_m[k]):.6f}/{float(ref_m[k]):.6f}" for k in METRIC_KEYS[:5]))
    print(f"[vae parity] worst loss at {worst_loss:.3f} of its bound ({loss}), worst gradient or "
          f"BN buffer at {worst:.3f} ({name}); bound atol {VAE_PARITY_TOL[0]:g} x max |ref| + "
          f"rtol {VAE_PARITY_TOL[1]:g} x |ref|, {len(ref_t)} tensors")
    if worst_loss > 1 or worst > 1 or not all(
            bool(torch.isfinite(t).all()) for t in list(got_t.values()) + list(got_m.values())):
        raise AssertionError("the card's VAE-GAN step disagrees with the CPU's")


def _draw_frozen_bn(model, g: torch.Generator) -> None:
    """Every FrozenBatchNorm2d's four buffers drawn (they start at identity,
    which would leave the backbone's norms untested): weight in [0.3, 0.8],
    bias and running_mean in +-0.1, running_var in [0.5, 1.5]."""
    from vaeplay_torch.models.backbone import FrozenBatchNorm2d

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, FrozenBatchNorm2d):
                for name, (lo, hi) in (("weight", (0.3, 0.8)), ("bias", (-0.1, 0.1)),
                                       ("running_mean", (-0.1, 0.1)),
                                       ("running_var", (0.5, 1.5))):
                    t = getattr(m, name)
                    t.copy_(lo + (hi - lo) * torch.rand(t.shape, generator=g))


def random_be_model(seed: int = 0, layers=(3, 4, 6, 3), width: int = 64, family: str = "be"):
    """A seeded BE ComposeNet (the BE_GAN generator for family "be_gan") with
    every FrozenBatchNorm2d's buffers drawn (_draw_frozen_bn)."""
    from vaeplay_torch.models import be, be_gan

    net = {"be": be, "be_gan": be_gan}[family].ComposeNet
    model = net(layers, width, generator=torch.Generator().manual_seed(seed))
    _draw_frozen_bn(model, torch.Generator().manual_seed(seed + 1))
    return model


def be_flops(img: int) -> dict:
    """Multiply-adds x 2 of one image through BE's training forward and its
    backward, by part (body, fpn, aux, heads), from the layer shapes: every
    Conv2d the forward calls, counted by hooks on a train-mode forward at
    batch 2 on the meta device, with the stem and layer1 frozen. The
    backward of a convolution costs its forward once for the weight
    gradient, if the weight trains, and once for the input gradient, if its
    input needs one. Returns {"forward": {part: flops}, "backward": {...}}."""
    from vaeplay_torch.models.be import ComposeNet
    from vaeplay_torch.train.state import freeze_backbone_stem

    with torch.device("meta"):
        model = ComposeNet().train()
    freeze_backbone_stem(model)
    out = {"forward": {}, "backward": {}}

    def count(part):
        def hook(m, inputs, y):
            x = inputs[0]
            f = 2 * y.numel() // y.shape[0] * (m.in_channels // m.groups) * math.prod(m.kernel_size)
            out["forward"][part] = out["forward"].get(part, 0) + f
            out["backward"][part] = out["backward"].get(part, 0) + f * (
                int(m.weight.requires_grad) + int(x.requires_grad))
        return hook

    for name, m in model.named_modules():
        if isinstance(m, torch.nn.Conv2d):
            part = ("body" if ".body." in name else "fpn" if ".fpn." in name
                    else "aux" if "aux_convs" in name else "heads")
            m.register_forward_hook(count(part))
    model(torch.zeros(2, 3, img, img, device="meta"))
    return out


def _be_grids(root: str) -> list:
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files if f.endswith(".png"))


def phase_be_infer(tmp: str, gpu: str) -> float:
    """BE inference through the test_be CLI on cuda:0 at 512 px, batch 8;
    then timed batches, the peak memory, the bound and a profile. Returns
    the median batch ms."""
    from vaeplay_torch.cli import test_be
    from vaeplay_torch.data.be_data import SyntheticBubbleDataset

    dev = torch.device("cuda", 0)
    weights = os.path.join(tmp, "be_random.pt")
    torch.save(random_be_model(0).state_dict(), weights)
    t0 = time.perf_counter()
    written = test_be.main(["--model_path", weights, "--gpu", "0", "--img_size", str(BE_IMG),
                            "--batchsize", str(BE_INFER_BATCH),
                            "--res_output", os.path.join(tmp, "be_test")])
    print(f"[be-infer] CLI run (load, two batches of {BE_INFER_BATCH} at {BE_IMG} px, grids) "
          f"{time.perf_counter() - t0:.2f} s; wrote {written}")
    if len(written) != 2 or not all(os.path.getsize(p) > 0 for p in written):
        raise AssertionError(f"test_be wrote {written}")

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = test_be.load_model(weights, dev)
    ds = SyntheticBubbleDataset(img_size=BE_IMG, data_size=4 * BE_INFER_BATCH, seed=5)
    batches = [b["imgs"] for b in ds.epoch_batches(BE_INFER_BATCH)]
    times = []
    for i, imgs in enumerate(batches):
        torch.cuda.synchronize()
        t = time.perf_counter()
        preds = test_be.predict(model, imgs, dev)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        for k, p in preds.items():
            if tuple(p.shape) != (BE_INFER_BATCH, 1, BE_IMG, BE_IMG) or not bool(
                    ((p >= 0) & (p <= 1)).all()):
                raise AssertionError(f"{k}: shape {tuple(p.shape)} or values outside [0, 1]")
        if i:
            times.append(ms)
        print(f"[be-infer] batch {i}{' (warm-up)' if i == 0 else ''}: {ms:.2f} ms (PyTorch "
              f"defaults: TF32 convolutions; batch {BE_INFER_BATCH}, {BE_IMG} px, host clock incl. "
              f"host-to-device copy and sigmoid) on {gpu}")
    print(f"[be-infer] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          f"(torch.cuda.max_memory_allocated: weights and activations)")
    fwd = sum(be_flops(BE_IMG)["forward"].values()) * BE_INFER_BATCH
    median = sorted(times)[len(times) // 2]
    print(f"[be-infer] forward {fwd / 1e12:.3f} TFLOP a batch (convolutions), bound "
          f"{fwd / PEAK_TF32_FLOPS * 1e3:.3f} ms at {PEAK_TF32_FLOPS / 1e12:.0f} TFLOP/s TF32; "
          f"median batch {median:.2f} ms, {BE_INFER_BATCH / median * 1e3:.1f} images/s, "
          f"{fwd / PEAK_TF32_FLOPS * 1e3 / median:.1%} of the bound on {gpu}")
    _profile(lambda: test_be.predict(model, batches[1], dev), "be-infer")
    return median


def _check_be_run(run: str, epoch: int, dtype: str) -> None:
    """A train_be run dir of one epoch: its checkpoint and one log line of
    finite losses."""
    from vaeplay_torch.train.steps_be import METRIC_KEYS

    if sorted(os.listdir(run)) != [f"{epoch}.ckpt", "metrics.jsonl", "record.txt"]:
        raise AssertionError(f"run dir {run} holds {sorted(os.listdir(run))}")
    with open(os.path.join(run, "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    if [r["epoch"] for r in lines] != [epoch] or not all(
            math.isfinite(r[k]) for r in lines for k in METRIC_KEYS):
        raise AssertionError(f"logged losses of epoch {epoch}: {lines}")
    r = lines[0]
    print(f"[be-train] {dtype} epoch {epoch}: " + " ".join(f"{k}={r[k]:.4f}" for k in METRIC_KEYS)
          + f" ({r['images_per_sec']:.1f} img/s over the epoch, CLI's host clock)")


def _be_cli(tmp: str, name: str, dtype: str, *extra) -> str:
    from vaeplay_torch.cli import train_be

    n = BE_ITERATIONS[dtype]
    t0 = time.perf_counter()
    run = train_be.main(["--gpu", "0", "--img_size", str(BE_IMG), "--batchsize",
                         str(BE_TRAIN_BATCH), "--iterations", str(n), "--viz_freq", str(n),
                         "--dtype", dtype, "--res_output", os.path.join(tmp, "be_results"),
                         "--model_output", os.path.join(tmp, name), *extra])
    print(f"[be-train] CLI run {dtype} {' '.join(extra)} (init, {n} iterations, grid, "
          f"checkpoint) {time.perf_counter() - t0:.2f} s: {run}")
    return run


def _be_timed(dtype: str, gpu: str) -> tuple:
    """A warm-up and BE_TIMED steps of make_bubble_train_step at PyTorch's
    defaults, each from the (B, 5) table on the host to synchronize (render,
    augmentation, forward, backward, Adam), and the peak device memory.
    Returns (state, step, a further table on the card, generator) for a
    profile, and the median step ms."""
    from vaeplay_torch.cli.train_be import build_state
    from vaeplay_torch.data.be_data import SyntheticBubbleDataset
    from vaeplay_torch.train.steps_be import make_bubble_train_step
    from vaeplay_torch.utils.amp import resolve_dtype

    dev = torch.device("cuda", 0)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = build_state(1e-4, 0, dev)
    state.model.train()
    step = make_bubble_train_step(state.model, BE_IMG, resolve_dtype(dtype))
    gen = torch.Generator(device=dev).manual_seed(1)
    tables = [p for p, _ in SyntheticBubbleDataset(
        img_size=BE_IMG, data_size=(BE_TIMED + 2) * BE_TRAIN_BATCH).epoch_params(BE_TRAIN_BATCH)]
    times = []
    for i, table in enumerate(tables[:BE_TIMED + 1]):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, metrics = step(state, torch.from_numpy(table).to(dev), gen)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        if not all(bool(torch.isfinite(v)) for v in metrics.values()):
            raise AssertionError(f"non-finite losses: {metrics}")
        if i:
            times.append(ms)
        print(f"[be-train] {dtype} step {i}{' (warm-up)' if i == 0 else ''}: {ms:.2f} ms, "
              f"{BE_TRAIN_BATCH / ms * 1e3:.1f} images/s (PyTorch defaults; batch "
              f"{BE_TRAIN_BATCH}, {BE_IMG} px, host clock incl. the table's copy) on {gpu}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[be-train] {dtype} peak device memory {peak:.2f} GiB "
          f"(torch.cuda.max_memory_allocated: weights, gradients, Adam moments, activations)")
    return ((state, step, torch.from_numpy(tables[-1]).to(dev), gen),
            sorted(times)[len(times) // 2])


def phase_be_train(tmp: str, gpu: str) -> dict:
    """BE through the train_be CLI at 512 px, batch 32: bf16 for one epoch,
    a resume for a second, f32 for one epoch, test_be on the resumed run
    dir; then the step's FLOPs and bound, timed steps and a profile in each
    dtype. Returns the median step ms by dtype."""
    from vaeplay_torch.cli import test_be

    run = _be_cli(tmp, "be_a", "bfloat16", "--epoch", "1")
    _check_be_run(run, 0, "bfloat16")
    resumed = _be_cli(tmp, "be_b", "bfloat16", "--epoch", "2", "--resume", run)
    _check_be_run(resumed, 1, "bfloat16")
    _check_be_run(_be_cli(tmp, "be_c", "float32", "--epoch", "1"), 0, "float32")
    grids = _be_grids(os.path.join(tmp, "be_results"))
    if sorted(os.path.basename(g) for g in grids) != ["0_2.png", "0_3.png", "1_3.png"]:
        raise AssertionError(f"train_be wrote the grids {grids}")
    written = test_be.main(["--model_path", resumed, "--gpu", "0", "--img_size", str(BE_IMG),
                            "--batchsize", str(BE_INFER_BATCH),
                            "--res_output", os.path.join(tmp, "be_trained")])
    if len(written) != 2 or not all(os.path.getsize(p) > 0 for p in written):
        raise AssertionError(f"test_be on the trained run dir wrote {written}")
    print(f"[be-train] grids {grids}; test_be --model_path <run dir> wrote {written}")
    for name in ("be_a", "be_b", "be_c"):
        shutil.rmtree(os.path.join(tmp, name))

    from vaeplay_torch.models.be import ComposeNet
    from vaeplay_torch.train.state import is_frozen_backbone_param

    with torch.device("meta"):
        model = ComposeNet()
        n_params = sum(p.numel() for p in model.parameters())
        n_frozen = sum(p.numel() for n, p in model.named_parameters()
                       if is_frozen_backbone_param(n))
    flops = be_flops(BE_IMG)
    fwd, bwd = sum(flops["forward"].values()), sum(flops["backward"].values())
    step_flops = (fwd + bwd) * BE_TRAIN_BATCH
    print(f"[be-train] {n_params / 1e6:.2f} M parameters ({n_frozen / 1e6:.2f} M frozen); "
          f"GFLOP per image from the layer shapes, forward: " + ", ".join(
              f"{k} {v / 1e9:.2f}" for k, v in flops["forward"].items())
          + f" (total {fwd / 1e9:.2f}); backward: " + ", ".join(
              f"{k} {v / 1e9:.2f}" for k, v in flops["backward"].items())
          + f" (total {bwd / 1e9:.2f}); step ({BE_TRAIN_BATCH} images) "
          f"{step_flops / 1e12:.2f} TFLOP, bound {step_flops / PEAK_BF16_FLOPS * 1e3:.2f} ms at "
          f"{PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s bf16, {step_flops / PEAK_TF32_FLOPS * 1e3:.2f} ms "
          f"at {PEAK_TF32_FLOPS / 1e12:.0f} TFLOP/s TF32 (dense tensor-core rates, 700 W)")
    medians = {}
    for dtype, peak, rate in (("bfloat16", PEAK_BF16_FLOPS, "bf16"),
                              ("float32", PEAK_TF32_FLOPS, "TF32")):
        profiled = None  # the previous state is freed before this peak is taken
        profiled, ms = _be_timed(dtype, gpu)
        medians[dtype] = ms
        print(f"[be-train] {dtype} median step {ms:.2f} ms, {BE_TRAIN_BATCH / ms * 1e3:.1f} "
              f"images/s, {step_flops / ms / 1e9:.1f} TFLOP/s, {step_flops / peak * 1e3 / ms:.1%} "
              f"of the {rate} bound on {gpu}")
        state, step, table, gen = profiled
        _profile(lambda: step(state, table, gen), f"be-train {dtype}", runs=1)
        del state, step, table, gen
    del profiled
    torch.cuda.empty_cache()
    return medians


def phase_be_parity() -> None:
    """One BE training step on the card and on the CPU from the same seeded
    weights (random FrozenBatchNorm constants), noise images and bubble
    masks, TF32 off, in f32 and in f64. f32: both losses and every buffer
    after the step's forward (the BatchNorms' running statistics). f64: the
    losses, every gradient and every buffer. The f32 gradients are not held:
    they are ill-conditioned here (the aux chain's BatchNorm biases get sums
    that nearly cancel, behind a conv and a train-mode BatchNorm), so that
    the CPU's own f32 gradients differ from its f64 ones by up to 1.9e-2 of a
    tensor's largest magnitude, and two f32 backends cannot agree within
    1e-3. Gradients, not weights: Adam's first update is about lr x sign(g).
    The images are noise, so that no convolution output is exactly 0 at a
    ReLU; the max pool's ties sit before the frozen layer1, where no
    gradient flows."""
    import numpy as np

    from vaeplay_torch.data.be_data import render_bubble_batch, sample_bubble_params
    from vaeplay_torch.train.state import frozen_backbone_adam
    from vaeplay_torch.train.steps_be import METRIC_KEYS, make_be_train_step

    cfg = BE_PARITY
    base = random_be_model(7)
    imgs = torch.from_numpy(np.random.default_rng(3).uniform(
        size=(cfg["batch"], 3, cfg["img"], cfg["img"])))
    table = torch.from_numpy(sample_bubble_params(cfg["img"], cfg["batch"], seed=4)[0])
    masks = render_bubble_batch(cfg["img"], table)[1:]
    for dtype in (torch.float32, torch.float64):
        results = []
        for dev in (torch.device("cpu"), torch.device("cuda", 0)):
            model = copy.deepcopy(base).to(dev, dtype).train()
            state = frozen_backbone_adam(model, 1e-4)
            batch = [t.to(dev, dtype) for t in (imgs, *masks)]
            _, m = make_be_train_step(model)(state, *batch)
            got = {f"buffer {k}": b.cpu() for k, b in model.named_buffers()
                   if b.is_floating_point()}
            if dtype == torch.float64:
                got.update({f"grad {k}": p.grad.cpu() for k, p in model.named_parameters()
                            if p.grad is not None})
            results.append((got, {k: v.cpu() for k, v in m.items()}))
        (ref_t, ref_m), (got_t, got_m) = results
        if sorted(ref_t) != sorted(got_t):
            raise AssertionError("the card and the CPU computed gradients of different tensors")
        tol = BE_PARITY_TOL[dtype]
        worst_loss, loss = max((_worst(got_m[k], ref_m[k], tol), k) for k in METRIC_KEYS)
        worst, name = max((_worst(got_t[k], ref_t[k], tol,
                                  float(ref_t[BE_ZERO_GRADS[k]].abs().max())
                                  if k in BE_ZERO_GRADS else None), k) for k in ref_t)
        n_grads = sum(k.startswith("grad") for k in ref_t)
        label = str(dtype)[6:]
        print(f"[be parity] {label} losses card vs CPU: " + " ".join(
            f"{k}={float(got_m[k]):.6f}/{float(ref_m[k]):.6f}" for k in METRIC_KEYS))
        print(f"[be parity] {label}: worst loss at {worst_loss:.2e} of its bound ({loss}), worst "
              f"gradient or buffer at {worst:.2e} ({name}); bound atol {tol[0]:g} x max |ref| + "
              f"rtol {tol[1]:g} x |ref|; {n_grads} gradients, {len(ref_t) - n_grads} buffers")
        if worst_loss > 1 or worst > 1 or not all(
                bool(torch.isfinite(t).all()) for t in list(got_t.values()) + list(got_m.values())):
            raise AssertionError(f"the card's {label} BE step disagrees with the CPU's")


def write_manga_tree(root: str, seed: int = 0) -> tuple:
    """A synthetic manga chapter under root, drawn with PIL:
    manga/Smoke/ep1/ch1/OriginSizeManga/page{i}.png, SERVE_PAGES pages of
    SERVE_PAGE_SIZE with 6-12 bubbles each (a white ellipse with a black
    ring and dark text strokes, one per cell of a 3 x 4 grid, on a noisy
    gray page), each page's coarse mask in OriginSizeBubbles/ (bubble pixels
    (255, type, 0) on white, the mask route) and a labelme file under
    anno/Smoke/ep1/ch1/ (the annotation route). Returns (manga root,
    annotation root, bubbles per page)."""
    import numpy as np
    from PIL import Image, ImageDraw

    rng = np.random.default_rng(seed)
    w, h = SERVE_PAGE_SIZE
    chapter = os.path.join(root, "manga", "Smoke", "ep1", "ch1")
    anno_dir = os.path.join(root, "anno", "Smoke", "ep1", "ch1")
    for d in ("OriginSizeManga", "OriginSizeBubbles"):
        os.makedirs(os.path.join(chapter, d))
    os.makedirs(anno_dir)
    subs = ("Oval", "Explosion", "NoFrame", "Box")
    counts = []
    for p in range(SERVE_PAGES):
        page = Image.fromarray(rng.integers(150, 230, (h, w, 3), dtype=np.uint8))
        mask = Image.new("RGB", (w, h), (255, 255, 255))
        draw, mdraw, shapes = ImageDraw.Draw(page), ImageDraw.Draw(mask), []
        cells = rng.permutation(12)[:int(rng.integers(6, 13))]
        for cell in sorted(int(c) for c in cells):
            cx, cy = (cell % 3) * 400 + 200, (cell // 3) * 425 + 212
            rx, ry = int(rng.integers(70, 150)), int(rng.integers(70, 160))
            box = [cx - rx, cy - ry, cx + rx, cy + ry]
            draw.ellipse(box, fill=(255, 255, 255), outline=(0, 0, 0), width=5)
            for line in range(int(rng.integers(2, 5))):
                y = cy - ry // 2 + line * 22
                draw.line([cx - rx // 2, y, cx + int(rng.integers(0, rx // 2)), y],
                          fill=(20, 20, 20), width=6)
            sub = subs[int(rng.integers(0, 4))]
            mdraw.ellipse(box, fill=(255, {"Oval": 1, "Explosion": 2, "NoFrame": 3, "Box": 4}[sub], 0))
            shapes.append({"label": "Bubble-Boundary", "sub_label": sub,
                           "points": [box[:2], box[2:]]})
        page.save(os.path.join(chapter, "OriginSizeManga", f"page{p}.png"))
        mask.save(os.path.join(chapter, "OriginSizeBubbles", f"page{p}.png"))
        with open(os.path.join(anno_dir, f"page{p}.json"), "w") as f:
            json.dump({"imageWidth": w, "imageHeight": h, "shapes": shapes}, f)
        counts.append(len(shapes))
    return os.path.join(root, "manga"), os.path.join(root, "anno"), counts


def _serve_cli(cli, out: str, label: str, *args) -> None:
    """One run of a page-serving CLI on cuda:0 at BE_IMG, which must write
    every page's PNG."""
    t0 = time.perf_counter()
    stats = cli.main(["--gpu", "0", "--img_size", str(BE_IMG), "--res_output", out, *args])
    pngs = sorted(f for f in os.listdir(out) if f.endswith(".png"))
    print(f"[be-serve] {label}: {time.perf_counter() - t0:.2f} s (load, {SERVE_PAGES} pages "
          f"through serve_pages), {stats}; wrote {pngs}")
    if tuple(stats) != (SERVE_PAGES, 0, 0) or len(pngs) != SERVE_PAGES or not all(
            os.path.getsize(os.path.join(out, f)) > 0 for f in pngs):
        raise AssertionError(f"{label} served {stats} and wrote {pngs}")


def _check_packed_bits(model, crops, dev, compute_dtype) -> None:
    """The packed step's bits on the card against the card's own maps: in
    f32 the make_be_eval_step maps thresholded at 0.5, in bf16 the sign of
    the logits of the same forward under bf16 autocast (a bf16 sigmoid
    rounds values just below 0.5 up to it). Equal except at pixels whose
    logit lies within SERVE_NEAR_ZERO of 0. In bf16 the pixels that leave
    the f32 maps' side are counted too."""
    from vaeplay_torch.ops.bits import unpack_mask_bits
    from vaeplay_torch.train.steps_be import make_be_eval_step, make_be_eval_step_packed
    from vaeplay_torch.utils.amp import autocast

    label = str(compute_dtype)[6:]
    x = (torch.from_numpy(crops).to(dev).float() / 255.0).permute(0, 3, 1, 2).contiguous()
    packed = make_be_eval_step_packed(model, compute_dtype)(x)
    maps = make_be_eval_step(model)(x)
    with torch.no_grad(), autocast(dev, compute_dtype):
        logits = {k: v.float() for k, v in model.eval()(x).items()}
    for k in ("masks", "edges"):
        bits = unpack_mask_bits(packed[k].cpu().numpy(), BE_IMG)
        f32_side = (maps[k][:, 0] >= 0.5).cpu().numpy()
        want = f32_side if compute_dtype == torch.float32 else (logits[k][:, 0] >= 0).cpu().numpy()
        near = (logits[k][:, 0].abs() < SERVE_NEAR_ZERO).cpu().numpy()
        off = bits != want
        ref = ("thresholded make_be_eval_step maps" if compute_dtype == torch.float32
               else "the sign of the bf16-autocast logits")
        moved = ("" if compute_dtype == torch.float32 else
                 f"; {int((bits != f32_side).sum())} pixels on the other side of the f32 maps")
        print(f"[be-serve] packed {k} vs {ref} on the card ({label}): {int(off.sum())} of "
              f"{off.size} pixels differ, {int((off & ~near).sum())} of them with |logit| >= "
              f"{SERVE_NEAR_ZERO:g}; {int(near.sum())} pixels within {SERVE_NEAR_ZERO:g} of 0; "
              f"share set {float(bits.mean()):.3f}{moved}")
        if (off & ~near).any():
            raise AssertionError(f"packed {label} {k} bits disagree with {ref}")


def phase_be_serve(tmp: str, gpu: str) -> tuple:
    """BE's page-serving path: test_be_manga over a synthetic manga chapter
    at 512 px, full width (random FrozenBatchNorm constants), in f32 on the
    annotation and the mask route and in bf16 on the annotation route; the
    packed bits against the card's own maps, in f32 and bf16; per page the
    latency, bubbles/s and bytes copied each way, in f32 and bf16; a
    profiled page. Returns the tree (manga root, annotation root) for
    phase 13."""
    from vaeplay_torch.cli import test_be, test_be_manga
    from vaeplay_torch.eval.predictor import make_packed_be_predict
    from vaeplay_torch.eval.serve import load_page, paste_page

    manga, anno, counts = write_manga_tree(os.path.join(tmp, "serve_tree"))
    print(f"[be-serve] synthetic chapter: {SERVE_PAGES} pages of {SERVE_PAGE_SIZE[0]} x "
          f"{SERVE_PAGE_SIZE[1]} px, {counts} bubbles")
    weights = os.path.join(tmp, "be_serve.pt")
    torch.save(random_be_model(0).state_dict(), weights)
    common = ["--model_path", weights, "--path", manga]
    _serve_cli(test_be_manga, os.path.join(tmp, "serve_f32"), "test_be_manga f32, annotation "
               "route", *common, "--anno_path", anno)
    _serve_cli(test_be_manga, os.path.join(tmp, "serve_mask"), "test_be_manga f32, mask route",
               *common)
    _serve_cli(test_be_manga, os.path.join(tmp, "serve_bf16"), "test_be_manga bf16, annotation "
               "route", *common, "--anno_path", anno, "--dtype", "bfloat16")

    dev = torch.device("cuda", 0)
    model = test_be.load_model(weights, dev)
    jobs = test_be_manga.page_jobs(manga, anno)
    pages = [load_page(j, BE_IMG) for j in jobs]
    for dtype in (torch.float32, torch.bfloat16):
        _check_packed_bits(model, pages[0]["images"], dev, dtype)
    fwd = sum(be_flops(BE_IMG)["forward"].values())
    out = os.path.join(tmp, "serve_timed")
    for dtype in (torch.float32, torch.bfloat16):
        predict = make_packed_be_predict(model, BE_IMG, compute_dtype=dtype)
        predict(pages[0]["images"])  # warm-up
        for job, page in zip(jobs, pages):
            n, times, copied = page["images"].shape[0], [], []
            for _ in range(SERVE_ROUNDS):
                before = dict(predict.copied)
                t0 = time.perf_counter()
                preds = predict(page["images"])
                t1 = time.perf_counter()
                paste_page(job, page, preds, out)
                times.append(((t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3))
                copied.append({k: predict.copied[k] - before[k] for k in before})
            pred_ms = sorted(t[0] for t in times)[len(times) // 2]
            paste_ms = sorted(t[1] for t in times)[len(times) // 2]
            up, down = copied[-1]["to_device"], copied[-1]["from_device"]
            print(f"[be-serve] {str(dtype)[6:]} {job.name}: {n} bubbles, median predict "
                  f"{pred_ms:.2f} ms (uint8 upload, forward, packed copy back, unpack), "
                  f"{n / pred_ms * 1e3:.1f} bubbles/s, paste and PNG {paste_ms:.2f} ms; copied "
                  f"{up} B to the card, {down} B back ({down / (2 * n * BE_IMG * BE_IMG * 4):.5f} "
                  f"of the f32 maps); forward bound {n * fwd / PEAK_TF32_FLOPS * 1e3:.3f} ms at "
                  f"{PEAK_TF32_FLOPS / 1e12:.0f} TFLOP/s TF32 ({SERVE_ROUNDS} rounds) on {gpu}")
            if up != page["images"].nbytes or down * 32 != 2 * n * BE_IMG * BE_IMG * 4:
                raise AssertionError(f"copied {up} B up and {down} B back for {n} crops")
        if dtype == torch.float32:
            _profile(lambda: predict(pages[1]["images"]), "be-serve")
    os.remove(weights)
    return manga, anno


def be_gan_flops(img: int) -> dict:
    """Multiply-adds x 2 of one image through each phase of the BE_GAN step,
    {phase: (forward, backward)}, from the layer shapes: every Conv2d and
    Linear of G and D that the phase calls, counted by hooks on a batch of 2
    on the meta device, with G's stem and layer1 frozen. The D phase runs G
    with no gradient and D twice with its weight gradients; the G phase runs
    G with its gradients and D twice, the real call with no gradient and the
    fake one with input gradients only. A layer's backward costs its forward
    once for the weight gradient, if the phase takes it, and once for the
    input gradient, if its input needs one."""
    from vaeplay_torch.models.be_gan import ComposeNet, Discriminator
    from vaeplay_torch.train.state import freeze_backbone_stem

    with torch.device("meta"):
        g, d = ComposeNet().train(), Discriminator(in_size=img).train()
    freeze_backbone_stem(g)
    out, phase = {"d_phase": [0, 0], "g_phase": [0, 0]}, ["d_phase"]

    def hook(m, inputs, y):
        x = inputs[0]
        if isinstance(m, torch.nn.Conv2d):
            f = 2 * y.numel() // y.shape[0] * (m.in_channels // m.groups) * math.prod(m.kernel_size)
        else:
            f = 2 * m.in_features * m.out_features
        out[phase[0]][0] += f
        if torch.is_grad_enabled():
            out[phase[0]][1] += f * (int(m.weight.requires_grad) + int(x.requires_grad))

    for m in list(g.modules()) + list(d.modules()):
        if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)):
            m.register_forward_hook(hook)
    x = torch.zeros(2, 3, img, img, device="meta")
    m = torch.zeros(2, 1, img, img, device="meta")
    with torch.no_grad():
        p = g(x)
    d(x, m, m)
    d(x, p["masks"].sigmoid(), p["edges"].sigmoid())
    phase[0] = "g_phase"
    d.requires_grad_(False)
    p = g(x)
    with torch.no_grad():
        d(x, m, m)
    d(x, p["masks"].sigmoid(), p["edges"].sigmoid())
    return {k: tuple(v) for k, v in out.items()}


def _check_be_gan_run(run: str, epoch: int, dtype: str) -> None:
    """A train_be_gan run dir of one epoch: its checkpoint and one log line
    of the seven losses, finite."""
    from vaeplay_torch.train.steps_be_gan import METRIC_KEYS

    if sorted(os.listdir(run)) != [f"{epoch}.ckpt", "metrics.jsonl", "record.txt"]:
        raise AssertionError(f"run dir {run} holds {sorted(os.listdir(run))}")
    with open(os.path.join(run, "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    if [r["epoch"] for r in lines] != [epoch] or not all(
            math.isfinite(r[k]) for r in lines for k in METRIC_KEYS):
        raise AssertionError(f"logged losses of epoch {epoch}: {lines}")
    r = lines[0]
    print(f"[be_gan-train] {dtype} epoch {epoch}: " + " ".join(
        f"{k}={r[k]:.4f}" for k in METRIC_KEYS)
        + f" ({r['images_per_sec']:.1f} img/s over the epoch, CLI's host clock)")


def _be_gan_cli(tmp: str, name: str, dtype: str, *extra) -> str:
    from vaeplay_torch.cli import train_be_gan

    n = BE_GAN_ITERATIONS[dtype]
    t0 = time.perf_counter()
    run = train_be_gan.main(["--gpu", "0", "--img_size", str(BE_IMG), "--batchsize",
                             str(BE_GAN_BATCH), "--iterations", str(n), "--viz_freq", str(n),
                             "--dtype", dtype, "--res_output", os.path.join(tmp, "be_gan_results"),
                             "--model_output", os.path.join(tmp, name), *extra])
    print(f"[be_gan-train] CLI run {dtype} {' '.join(extra)} (init, {n} iterations, grid, "
          f"checkpoint) {time.perf_counter() - t0:.2f} s: {run}")
    return run


def _be_gan_timed(dtype: str, gpu: str) -> tuple:
    """A warm-up and BE_TIMED steps of the BE_GAN step at PyTorch's defaults,
    each batch rendered on the card from its (B, 5) table first, the D and G
    phases timed apart on the host clock (each ending in a synchronize); the
    peak device memory. Returns (step, state, a batch) for a profile, and the
    median (D, G, step) ms."""
    from vaeplay_torch.cli.train_be_gan import build_state, device_batches
    from vaeplay_torch.data.be_data import SyntheticBubbleDataset
    from vaeplay_torch.train.steps_be_gan import make_be_gan_train_step
    from vaeplay_torch.utils.amp import resolve_dtype

    dev = torch.device("cuda", 0)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gs = build_state(BE_IMG, 1e-4, 0, dev)
    gs.g.model.train()
    gs.d.model.train()
    step = make_be_gan_train_step(gs.g.model, gs.d.model, resolve_dtype(dtype))
    ds = SyntheticBubbleDataset(img_size=BE_IMG, data_size=(BE_TIMED + 2) * BE_GAN_BATCH)
    batches = list(device_batches(ds, BE_GAN_BATCH, 0, 0, dev))
    times = []
    for i, batch in enumerate(batches[:BE_TIMED + 1]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gs, dm = step.d_phase(gs, *batch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        gs, gm = step.g_phase(gs, *batch)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if not all(bool(torch.isfinite(v)) for v in {**dm, **gm}.values()):
            raise AssertionError(f"non-finite losses: {dm} {gm}")
        ms = ((t1 - t0) * 1e3, (t2 - t1) * 1e3, (t2 - t0) * 1e3)
        if i:
            times.append(ms)
        print(f"[be_gan-train] {dtype} step {i}{' (warm-up)' if i == 0 else ''}: D phase "
              f"{ms[0]:.2f} ms, G phase {ms[1]:.2f} ms, step {ms[2]:.2f} ms, "
              f"{BE_GAN_BATCH / ms[2] * 1e3:.1f} images/s (PyTorch defaults; batch {BE_GAN_BATCH}, "
              f"{BE_IMG} px, host clock) on {gpu}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[be_gan-train] {dtype} peak device memory {peak:.2f} GiB (torch.cuda."
          f"max_memory_allocated: both nets' weights, gradients, Adam moments, activations)")
    medians = tuple(sorted(t[j] for t in times)[len(times) // 2] for j in range(3))
    return (step, gs, batches[-1]), medians


def phase_be_gan_train(tmp: str, tree: tuple, gpu: str) -> dict:
    """BE_GAN through the train_be_gan CLI at 512 px, batch 16, full width,
    bubbles rendered on the card: bf16 for one epoch, a resume for a second,
    f32 for one epoch; test_be_gan_manga on the resumed run dir over phase
    12's chapter; then the step's FLOPs and bound, timed steps with the D and
    G phases apart and a profile of a step in each dtype. Returns the median
    (D, G, step) ms by dtype."""
    from vaeplay_torch.cli import test_be_gan_manga

    run = _be_gan_cli(tmp, "be_gan_a", "bfloat16", "--epochs", "1")
    _check_be_gan_run(run, 0, "bfloat16")
    resumed = _be_gan_cli(tmp, "be_gan_b", "bfloat16", "--epochs", "2", "--resume", run)
    _check_be_gan_run(resumed, 1, "bfloat16")
    _check_be_gan_run(_be_gan_cli(tmp, "be_gan_c", "float32", "--epochs", "1"), 0, "float32")
    grids = _be_grids(os.path.join(tmp, "be_gan_results"))
    if sorted(os.path.basename(g) for g in grids) != ["0_2_wgtm.png", "0_3_wgtm.png",
                                                     "1_3_wgtm.png"]:
        raise AssertionError(f"train_be_gan wrote the grids {grids}")
    manga, anno = tree
    _serve_cli(test_be_gan_manga, os.path.join(tmp, "serve_gan"), "test_be_gan_manga on the "
               "resumed run dir", "--model_path", resumed, "--path", manga, "--anno_path", anno)
    for name in ("be_gan_a", "be_gan_b", "be_gan_c"):
        shutil.rmtree(os.path.join(tmp, name))

    flops = be_gan_flops(BE_IMG)
    step_flops = sum(sum(v) for v in flops.values()) * BE_GAN_BATCH
    print(f"[be_gan-train] GFLOP per image from the layer shapes (forward, backward): " + "; ".join(
        f"{k} {v[0] / 1e9:.2f}, {v[1] / 1e9:.2f}" for k, v in flops.items())
        + f"; step ({BE_GAN_BATCH} images) {step_flops / 1e12:.2f} TFLOP, bound "
        f"{step_flops / PEAK_BF16_FLOPS * 1e3:.2f} ms at {PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s bf16, "
        f"{step_flops / PEAK_TF32_FLOPS * 1e3:.2f} ms at {PEAK_TF32_FLOPS / 1e12:.0f} TFLOP/s TF32 "
        f"(dense tensor-core rates, 700 W)")
    medians = {}
    for dtype, peak, rate in (("bfloat16", PEAK_BF16_FLOPS, "bf16"),
                              ("float32", PEAK_TF32_FLOPS, "TF32")):
        profiled = None  # the previous state is freed before this peak is taken
        profiled, ms = _be_gan_timed(dtype, gpu)
        medians[dtype] = ms
        print(f"[be_gan-train] {dtype} median D phase {ms[0]:.2f} ms, G phase {ms[1]:.2f} ms, "
              f"step {ms[2]:.2f} ms, {BE_GAN_BATCH / ms[2] * 1e3:.1f} images/s, "
              f"{step_flops / ms[2] / 1e9:.1f} TFLOP/s, {step_flops / peak * 1e3 / ms[2]:.1%} of "
              f"the {rate} bound on {gpu}")
        step, gs, batch = profiled
        _profile(lambda: step(gs, *batch), f"be_gan-train {dtype}", runs=1)
        del step, gs, batch
    del profiled
    torch.cuda.empty_cache()
    return medians


def phase_be_gan_parity() -> None:
    """One BE_GAN step (D phase, then G phase) on the card and on the CPU from
    the same seeded weights (the full-width backbone with random
    FrozenBatchNorm constants), noise images, bubble masks and labels, TF32
    off, in f32 and f64. f32: the seven losses and both nets' buffers. f64:
    the losses, both nets' gradients (G's from the G phase, D's from the D
    phase) and every buffer. f32 gradients are not held, as in phase 11."""
    import numpy as np

    from vaeplay_torch.cli.train_be_gan import BETAS
    from vaeplay_torch.data.be_data import render_bubble_batch, sample_bubble_params
    from vaeplay_torch.models.be_gan import Discriminator
    from vaeplay_torch.train.state import GanState, TrainState, frozen_backbone_adam
    from vaeplay_torch.train.steps_be_gan import METRIC_KEYS, make_be_gan_train_step

    cfg = BE_GAN_PARITY
    base_g = random_be_model(8, family="be_gan")
    base_d = Discriminator(in_size=cfg["img"], generator=torch.Generator().manual_seed(9))
    imgs = torch.from_numpy(np.random.default_rng(3).uniform(
        size=(cfg["batch"], 3, cfg["img"], cfg["img"])))
    table, labels = sample_bubble_params(cfg["img"], cfg["batch"], seed=4)
    masks = render_bubble_batch(cfg["img"], torch.from_numpy(table))[1:]
    for dtype in (torch.float32, torch.float64):
        results = []
        for dev in (torch.device("cpu"), torch.device("cuda", 0)):
            g = copy.deepcopy(base_g).to(dev, dtype).train()
            d = copy.deepcopy(base_d).to(dev, dtype).train()
            gs = GanState(frozen_backbone_adam(g, 1e-4, BETAS),
                          TrainState.create(d, 1e-5, betas=BETAS))
            batch = [t.to(dev, dtype) for t in (imgs, *masks)] + [torch.from_numpy(labels).to(dev)]
            _, m = make_be_gan_train_step(g, d)(gs, *batch)
            got = {}
            for net, model in (("g", g), ("d", d)):
                got.update({f"buffer {net} {k}": b.cpu() for k, b in model.named_buffers()
                            if b.is_floating_point()})
                if dtype == torch.float64:
                    got.update({f"grad {net} {k}": p.grad.cpu()
                                for k, p in model.named_parameters() if p.grad is not None})
            results.append((got, {k: v.cpu() for k, v in m.items()}))
        (ref_t, ref_m), (got_t, got_m) = results
        if sorted(ref_t) != sorted(got_t):
            raise AssertionError("the card and the CPU computed gradients of different tensors")
        tol = BE_PARITY_TOL[dtype]
        worst_loss, loss = max((_worst(got_m[k], ref_m[k], tol), k) for k in METRIC_KEYS)
        worst, name = max((_worst(got_t[k], ref_t[k], tol,
                                  float(ref_t[BE_GAN_ZERO_GRADS[k]].abs().max())
                                  if k in BE_GAN_ZERO_GRADS else None), k) for k in ref_t)
        n_grads = sum(k.startswith("grad") for k in ref_t)
        label = str(dtype)[6:]
        print(f"[be_gan parity] {label} losses card vs CPU: " + " ".join(
            f"{k}={float(got_m[k]):.6f}/{float(ref_m[k]):.6f}" for k in METRIC_KEYS))
        print(f"[be_gan parity] {label}: worst loss at {worst_loss:.2e} of its bound ({loss}), "
              f"worst gradient or buffer at {worst:.2e} ({name}); bound atol {tol[0]:g} x max "
              f"|ref| + rtol {tol[1]:g} x |ref|; {n_grads} gradients, {len(ref_t) - n_grads} "
              f"buffers")
        if worst_loss > 1 or worst > 1 or not all(
                bool(torch.isfinite(t).all()) for t in list(got_t.values()) + list(got_m.values())):
            raise AssertionError(f"the card's {label} BE_GAN step disagrees with the CPU's")


def random_bc_model(seed: int = 0, layers=(3, 4, 6, 3), width: int = 64, points: int = BC_POINTS):
    """A seeded BC ComposeNet with every FrozenBatchNorm2d's buffers and every
    attention gamma drawn (_draw_frozen_bn, _draw_gammas)."""
    from vaeplay_torch.models.bc import ComposeNet

    model = ComposeNet(points, backbone_layers=layers, backbone_width=width,
                       generator=torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    _draw_frozen_bn(model, g)
    _draw_gammas(model, g)
    return model


def bc_flops(img: int, points: int = BC_POINTS) -> dict:
    """Multiply-adds x 2 of one image through BC's training forward and its
    backward, by part (body, fpn, heads, refine convs, attention, fc), from
    the layer shapes: every Conv2d and Linear, counted by hooks on the meta
    device (the stem and layer1 frozen), RefineNet's q, k, v convolutions
    and linear layers called on meta inputs of their shapes, and the
    attention's two products counted from (N, Dk, Dv); its backward is the
    recompute VJP's five. A convolution's or linear layer's backward costs
    its forward once for the weight gradient, if the weight trains, and once
    for the input gradient, if its input needs one."""
    from vaeplay_torch.models.bc import FEAT_SIZE, ComposeNet
    from vaeplay_torch.train.state import freeze_backbone_stem

    with torch.device("meta"):
        model = ComposeNet(points).train()
    freeze_backbone_stem(model)
    out = {"forward": {}, "backward": {}}

    def add(part, fwd, bwd):
        out["forward"][part] = out["forward"].get(part, 0) + fwd
        out["backward"][part] = out["backward"].get(part, 0) + bwd

    def count(part):
        def hook(m, inputs, y):
            x = inputs[0]
            if isinstance(m, torch.nn.Linear):
                f = 2 * y.numel() // y.shape[0] * m.in_features
            else:
                f = 2 * y.numel() // y.shape[0] * (m.in_channels // m.groups) * math.prod(
                    m.kernel_size)
            add(part, f, f * (int(m.weight.requires_grad) + int(x.requires_grad)))
        return hook

    for name, m in model.named_modules():
        if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)):
            part = ("body" if ".body." in name else "fpn" if ".fpn." in name
                    else "refine convs" if "deform_blocks" in name
                    else "fc" if "fc_blocks" in name else "heads")
            m.register_forward_hook(count(part))
    model.edge_net(model.mask_net(model.feature_net(torch.zeros(2, 3, img, img, device="meta"))))
    y = torch.zeros(2, points, FEAT_SIZE, 1, device="meta", requires_grad=True)
    for block in model.refine_net.deform_blocks:
        block.q(y), block.k(y), block.v(y)
    n, dk, dv = FEAT_SIZE, points // 8, points
    add("attention", len(model.refine_net.deform_blocks) * 2 * n * n * (dk + dv),
        len(model.refine_net.deform_blocks) * 2 * n * n * (3 * dk + 2 * dv))
    model.refine_net.fc_blocks(torch.zeros(2, points * FEAT_SIZE, device="meta",
                                           requires_grad=True))
    return out


def _check_bc_preds(preds, batch: int, img: int, points: int) -> None:
    shapes = {"edges": (batch, 1, img, img), "masks": (batch, 1, img, img),
              "contours": (batch, points, 2), "contour_counts": (batch,),
              "contour_regressions": (batch, points, 2)}
    for name, shape in shapes.items():
        t = preds[name]
        if tuple(t.shape) != shape or (t.is_floating_point() and not bool(torch.isfinite(t).all())):
            raise AssertionError(f"{name}: shape {tuple(t.shape)} (want {shape}) or not finite")
    counts, pts = preds["contour_counts"], preds["contours"]
    if not (bool((counts >= 0).all()) and bool((counts <= points).all())
            and float(pts.min()) >= 0 and float(pts.max()) <= img + 1):
        raise AssertionError(f"traced contours out of range: counts {counts.tolist()}")


def write_bc_tree(root: str, n: int, img: int) -> str:
    """A BCDataset tree under root: class dir "1" with n samples, each an
    image, its `_edge` input (a synthetic bubble, render_bubble_batch), and
    its `_mask` and `_mask_edge` files (red on white, the reference's layer
    encoding)."""
    import numpy as np
    from PIL import Image

    from vaeplay_torch.data.be_data import render_bubble_batch, sample_bubble_params

    folder = os.path.join(root, "1")
    os.makedirs(folder)
    imgs, bimgs, eimgs = render_bubble_batch(
        img, torch.from_numpy(sample_bubble_params(img, n, seed=9)[0]))
    for i in range(n):
        rgb = (imgs[i].permute(1, 2, 0).numpy() * 255).astype(np.uint8)
        for suffix in ("", "_edge"):
            Image.fromarray(rgb).save(os.path.join(folder, f"s{i}{suffix}.png"))
        for suffix, m in (("_mask", bimgs[i, 0]), ("_mask_edge", eimgs[i, 0])):
            layer = np.full((img, img, 3), 255, np.uint8)
            layer[m.numpy() > 0] = (255, 0, 0)
            Image.fromarray(layer).save(os.path.join(folder, f"s{i}{suffix}.png"))
    return root


def _bc_trace_ms(run, *args):
    """run(*args) with the host clock around it and a synchronize after;
    returns (its result, total ms, the packed copy's wait ms, the trace ms)."""
    from vaeplay_torch.models.bc import trace_contours

    torch.cuda.synchronize()
    c0, t0 = trace_contours.copy_seconds, trace_contours.trace_seconds
    t = time.perf_counter()
    out = run(*args)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3
    return (out, ms, (trace_contours.copy_seconds - c0) * 1e3,
            (trace_contours.trace_seconds - t0) * 1e3)


def phase_bc_infer(tmp: str, gpu: str) -> None:
    """BC inference through the test_bc CLI on cuda:0 at 256 px, batch 8, full
    width: --debug with seeded random weights (nonzero gammas), then --path
    over a synthetic BCDataset tree; then timed batches with the trace apart,
    the peak memory, the forward's FLOPs and bound, and a profile. Every
    forward launches the attention kernel BC_PER_FORWARD times."""
    from vaeplay_torch.cli import test_bc
    from vaeplay_torch.data.bc_data import SyntheticBCDataset
    from vaeplay_torch.ops import attention

    dev = torch.device("cuda", 0)
    weights = os.path.join(tmp, "bc_random.pt")
    t0 = time.perf_counter()
    torch.save(random_bc_model(0, points=BC_POINTS).state_dict(), weights)
    print(f"[bc-infer] random weights {os.path.getsize(weights) / 2**30:.2f} GiB made and saved "
          f"in {time.perf_counter() - t0:.1f} s")
    data = write_bc_tree(os.path.join(tmp, "bc_data"), BC_INFER_BATCH + 2, BC_IMG)
    for label, extra, grids in (("--debug", ["--debug"], ["contours.png"]),
                                ("--path", ["--path", data], ["contours_0.png", "contours_1.png"])):
        before = attention.flash_attention.launches
        t0 = time.perf_counter()
        out = os.path.join(tmp, f"bc_test{len(grids)}")
        written = test_bc.main(["--model_path", weights, "--gpu", "0", "--img_size", str(BC_IMG),
                                "--max_points", str(BC_POINTS), "--batchsize",
                                str(BC_INFER_BATCH), "--res_output", out, *extra])
        launches = attention.flash_attention.launches - before
        print(f"[bc-infer] CLI run {label} (load, {len(grids)} batch(es) of up to "
              f"{BC_INFER_BATCH} at {BC_IMG} px, grids) {time.perf_counter() - t0:.2f} s, "
              f"{launches} kernel launches; wrote {written}")
        if ([os.path.basename(p) for p in written] != grids
                or not all(os.path.getsize(p) > 0 for p in written)
                or launches != BC_PER_FORWARD * len(grids)):
            raise AssertionError(f"test_bc {label} wrote {written} with {launches} launches")

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = test_bc.load_model(weights, BC_POINTS, dev)
    ds = SyntheticBCDataset(img_size=BC_IMG, max_points=BC_POINTS, data_size=4 * BC_INFER_BATCH,
                            seed=5)
    batches = [b["imgs"] for b in ds.epoch_batches(BC_INFER_BATCH)]
    times, traces = [], []
    for i, imgs in enumerate(batches):
        before = attention.flash_attention.launches
        preds, ms, copy_ms, trace_ms = _bc_trace_ms(test_bc.predict, model, imgs, dev)
        _check_bc_preds(preds, BC_INFER_BATCH, BC_IMG, BC_POINTS)
        if attention.flash_attention.launches - before != BC_PER_FORWARD:
            raise AssertionError(f"a BC forward did not launch the kernel {BC_PER_FORWARD} times")
        if i:
            times.append(ms)
            traces.append(trace_ms)
        print(f"[bc-infer] batch {i}{' (warm-up)' if i == 0 else ''}: {ms:.2f} ms (PyTorch "
              f"defaults: TF32 convolutions; batch {BC_INFER_BATCH}, {BC_IMG} px, host clock incl. "
              f"host-to-device copy), of which the packed mask's copy back {copy_ms:.2f} ms "
              f"(waits for the mask stage) and the host trace {trace_ms:.2f} ms "
              f"({trace_ms / ms:.1%}); counts {preds['contour_counts'].tolist()} on {gpu}")
    print(f"[bc-infer] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          f"(torch.cuda.max_memory_allocated: weights and activations)")
    flops = bc_flops(BC_IMG, BC_POINTS)
    fwd = sum(flops["forward"].values()) * BC_INFER_BATCH
    median, trace = sorted(times)[len(times) // 2], sorted(traces)[len(traces) // 2]
    print(f"[bc-infer] forward GFLOP per image: " + ", ".join(
        f"{k} {v / 1e9:.3f}" for k, v in flops["forward"].items())
        + f"; a batch {fwd / 1e12:.3f} TFLOP, bound {fwd / PEAK_TF32_FLOPS * 1e3:.3f} ms at "
        f"{PEAK_TF32_FLOPS / 1e12:.0f} TFLOP/s TF32; median batch {median:.2f} ms, "
        f"{BC_INFER_BATCH / median * 1e3:.1f} images/s, host trace {trace:.2f} ms "
        f"({trace / BC_INFER_BATCH:.3f} ms a mask, {trace / median:.1%} of the batch), "
        f"{fwd / PEAK_TF32_FLOPS * 1e3 / median:.1%} of the bound on {gpu}")
    _profile(lambda: test_bc.predict(model, batches[1], dev), "bc-infer")


def _check_bc_run(run: str, epoch: int, dtype: str) -> None:
    """A train_bc run dir of one epoch: its checkpoint and one log line of
    finite losses."""
    from vaeplay_torch.train.steps_bc import METRIC_KEYS

    if sorted(os.listdir(run)) != [f"{epoch}.ckpt", "metrics.jsonl", "record.txt"]:
        raise AssertionError(f"run dir {run} holds {sorted(os.listdir(run))}")
    with open(os.path.join(run, "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    if [r["epoch"] for r in lines] != [epoch] or not all(
            math.isfinite(r[k]) for r in lines for k in METRIC_KEYS):
        raise AssertionError(f"logged losses of epoch {epoch}: {lines}")
    r = lines[0]
    print(f"[bc-train] {dtype} epoch {epoch}: " + " ".join(f"{k}={r[k]:.4f}" for k in METRIC_KEYS)
          + f" ({r['images_per_sec']:.1f} img/s over the epoch, host trace "
          f"{r['trace_ms_per_iteration']:.2f} ms an iteration, CLI's host clock); checkpoint "
          f"{os.path.getsize(os.path.join(run, f'{epoch}.ckpt')) / 2**30:.2f} GiB")


def _bc_cli(tmp: str, name: str, dtype: str, *extra) -> str:
    from vaeplay_torch.cli import train_bc
    from vaeplay_torch.ops import attention

    n = BC_ITERATIONS[dtype]
    before = attention.flash_attention.launches
    t0 = time.perf_counter()
    run = train_bc.main(["--gpu", "0", "--img_size", str(BC_IMG), "--max_points", str(BC_POINTS),
                         "--batchsize",
                         str(BC_TRAIN_BATCH), "--iterations", str(n), "--viz_freq", str(n),
                         "--dtype", dtype, "--refine_dtype", dtype,
                         "--res_output", os.path.join(tmp, "bc_results"),
                         "--model_output", os.path.join(tmp, name), *extra])
    launches = attention.flash_attention.launches - before
    print(f"[bc-train] CLI run {dtype} {' '.join(extra)} (init, {n} iterations, checkpoint) "
          f"{time.perf_counter() - t0:.2f} s, {launches} kernel launches: {run}")
    if launches != BC_PER_FORWARD * n:
        raise AssertionError(f"train_bc launched the kernel {launches} times in {n} iterations")
    return run


def _bc_timed(dtype: str, gpu: str) -> tuple:
    """A warm-up and BC_TIMED steps of make_bc_train_step, the contours
    traced inside each forward, --dtype and --refine_dtype `dtype`, each
    from the host batch to synchronize (copy, forward with the mid-forward
    trace, backward, Adam), and the peak device memory. Returns (state,
    step, a further batch on the card) for a profile, and the median step
    and trace ms."""
    from vaeplay_torch.cli.train_bc import build_state, device_batch
    from vaeplay_torch.data.bc_data import SyntheticBCDataset
    from vaeplay_torch.ops import attention
    from vaeplay_torch.train.steps_bc import make_bc_train_step
    from vaeplay_torch.utils.amp import resolve_dtype

    dev = torch.device("cuda", 0)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = build_state(1e-4, 0, BC_POINTS, resolve_dtype(dtype), 1, dev)
    state.model.train()
    step = make_bc_train_step(state.model, resolve_dtype(dtype))
    ds = SyntheticBCDataset(img_size=BC_IMG, max_points=BC_POINTS,
                            data_size=(BC_TIMED + 2) * BC_TRAIN_BATCH)
    host = list(ds.epoch_batches(BC_TRAIN_BATCH))
    times, traces = [], []
    for i, b in enumerate(host[:BC_TIMED + 1]):
        before = attention.flash_attention.launches
        (state, metrics), ms, copy_ms, trace_ms = _bc_trace_ms(
            lambda: step(state, *device_batch(b, dev)))
        if not all(bool(torch.isfinite(v)) for v in metrics.values()):
            raise AssertionError(f"non-finite losses: {metrics}")
        if attention.flash_attention.launches - before != BC_PER_FORWARD:
            raise AssertionError(f"a BC step did not launch the kernel {BC_PER_FORWARD} times")
        if i:
            times.append(ms)
            traces.append(trace_ms)
        print(f"[bc-train] {dtype} step {i}{' (warm-up)' if i == 0 else ''}: {ms:.2f} ms, "
              f"{BC_TRAIN_BATCH / ms * 1e3:.1f} images/s (PyTorch defaults; batch "
              f"{BC_TRAIN_BATCH}, {BC_IMG} px, host clock incl. the batch's copy), of which the "
              f"packed mask's copy back {copy_ms:.2f} ms and the host trace {trace_ms:.2f} ms "
              f"({trace_ms / ms:.1%}) on {gpu}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[bc-train] {dtype} peak device memory {peak:.2f} GiB "
          f"(torch.cuda.max_memory_allocated: weights, gradients, Adam moments, activations)")
    return ((state, step, device_batch(host[-1], dev)),
            sorted(times)[len(times) // 2], sorted(traces)[len(traces) // 2])


def phase_bc_train(tmp: str, gpu: str) -> dict:
    """BC through the train_bc CLI at 256 px, batch 32, full width: f32 for
    one epoch, a resume for a second, bf16 compute with bf16 refine layers
    for one epoch, test_bc on the resumed run dir (each run dir deleted once
    checked); then the step's FLOPs and bound, timed steps and a profile in
    each dtype. Returns the median step ms by dtype."""
    from vaeplay_torch.cli import test_bc
    from vaeplay_torch.ops import attention

    run = _bc_cli(tmp, "bc_a", "float32", "--epoch", "1")
    _check_bc_run(run, 0, "float32")
    resumed = _bc_cli(tmp, "bc_b", "float32", "--epoch", "2", "--resume", run)
    _check_bc_run(resumed, 1, "float32")
    shutil.rmtree(os.path.join(tmp, "bc_a"))
    _check_bc_run(_bc_cli(tmp, "bc_c", "bfloat16", "--epoch", "1"), 0, "bfloat16")
    shutil.rmtree(os.path.join(tmp, "bc_c"))
    before = attention.flash_attention.launches
    written = test_bc.main(["--model_path", resumed, "--gpu", "0", "--img_size", str(BC_IMG),
                            "--max_points", str(BC_POINTS), "--batchsize", str(BC_INFER_BATCH),
                            "--res_output", os.path.join(tmp, "bc_trained")])
    if (len(written) != 1 or not os.path.getsize(written[0])
            or attention.flash_attention.launches - before != BC_PER_FORWARD):
        raise AssertionError(f"test_bc on the trained run dir wrote {written}")
    print(f"[bc-train] test_bc --model_path <run dir> wrote {written}")
    shutil.rmtree(os.path.join(tmp, "bc_b"))

    from vaeplay_torch.models.bc import ComposeNet
    from vaeplay_torch.train.state import is_frozen_backbone_param

    with torch.device("meta"):
        model = ComposeNet(BC_POINTS)
        n_params = sum(p.numel() for p in model.parameters())
        n_frozen = sum(p.numel() for n, p in model.named_parameters()
                       if is_frozen_backbone_param(n))
        n_fc0 = model.refine_net.fc_blocks[0].weight.numel()
    flops = bc_flops(BC_IMG, BC_POINTS)
    fwd, bwd = sum(flops["forward"].values()), sum(flops["backward"].values())
    step_flops = (fwd + bwd) * BC_TRAIN_BATCH
    print(f"[bc-train] {n_params / 1e6:.2f} M parameters ({n_fc0 / 1e6:.2f} M in fc0's weight, "
          f"{n_frozen / 1e6:.2f} M frozen); GFLOP per image from the layer shapes, forward: "
          + ", ".join(f"{k} {v / 1e9:.3f}" for k, v in flops["forward"].items())
          + f" (total {fwd / 1e9:.2f}); backward: " + ", ".join(
              f"{k} {v / 1e9:.3f}" for k, v in flops["backward"].items())
          + f" (total {bwd / 1e9:.2f}); step ({BC_TRAIN_BATCH} images) "
          f"{step_flops / 1e12:.3f} TFLOP, bound {step_flops / PEAK_BF16_FLOPS * 1e3:.2f} ms at "
          f"{PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s bf16, {step_flops / PEAK_TF32_FLOPS * 1e3:.2f} ms "
          f"at {PEAK_TF32_FLOPS / 1e12:.0f} TFLOP/s TF32 (dense tensor-core rates, 700 W)")
    medians = {}
    for dtype, peak, rate in (("float32", PEAK_TF32_FLOPS, "TF32"),
                              ("bfloat16", PEAK_BF16_FLOPS, "bf16")):
        profiled = None  # the previous state is freed before this peak is taken
        profiled, ms, trace = _bc_timed(dtype, gpu)
        medians[dtype] = ms
        print(f"[bc-train] {dtype} median step {ms:.2f} ms, {BC_TRAIN_BATCH / ms * 1e3:.1f} "
              f"images/s, {step_flops / ms / 1e9:.1f} TFLOP/s, {step_flops / peak * 1e3 / ms:.1%} "
              f"of the {rate} bound; host trace {trace:.2f} ms ({trace / BC_TRAIN_BATCH:.3f} ms a "
              f"mask, {trace / ms:.1%} of the step) on {gpu}")
        state, step, batch = profiled
        _profile(lambda: step(state, *batch), f"bc-train {dtype}", runs=1)
        del state, step, batch
    del profiled
    torch.cuda.empty_cache()
    return medians


@contextlib.contextmanager
def plain_attention():
    """SelfAttentionBlock on the plain version (autograd through
    reference_attention) on every device inside the block: for the f64
    card-vs-CPU check, since the kernel takes f32 and bf16 only."""
    from vaeplay_torch.core import layers
    from vaeplay_torch.ops import attention

    saved = layers.spatial_self_attention
    layers.spatial_self_attention = lambda q, k, v, ring=None: attention.reference_attention(
        q, k, v)
    try:
        yield
    finally:
        layers.spatial_self_attention = saved


def phase_bc_parity() -> None:
    """One BC training step on the card and on the CPU from the same seeded
    weights (the full-width backbone, random FrozenBatchNorm constants,
    nonzero gammas), noise images, bubble masks, their traced targets and
    injected contours, TF32 off. f32 (the kernel on the card): the three
    losses and every buffer. f64 (the plain attention on both, the kernel
    taking no f64): the losses, every gradient and every buffer. Then, with
    contours=None in eval mode, the two binary masks agree except where the
    CPU's probability is within BC_PROB_MARGIN of 0.5, and every sample
    whose masks agree traces the same points and count on both."""
    import numpy as np

    from vaeplay_torch.data.bc_data import contour_targets_from_mask
    from vaeplay_torch.data.be_data import render_bubble_batch, sample_bubble_params
    from vaeplay_torch.ops import attention
    from vaeplay_torch.train.state import frozen_backbone_adam
    from vaeplay_torch.train.steps_bc import METRIC_KEYS, make_bc_train_step

    cfg = BC_PARITY
    b, img, points = cfg["batch"], cfg["img"], cfg["points"]
    base = random_bc_model(7, points=points)
    rng = np.random.default_rng(3)
    imgs = torch.from_numpy(rng.uniform(size=(b, 3, img, img)))
    table = torch.from_numpy(sample_bubble_params(img, b, seed=4)[0])
    bimgs, eimgs = render_bubble_batch(img, table)[1:]
    targets = [contour_targets_from_mask(m[0].numpy(), 1, points) for m in bimgs]
    tgt_pts, ns, key_pts, ks = (np.stack(t) for t in zip(*targets))
    tgt_mask = (np.arange(points)[None] < ns[:, None]).astype(np.float32)
    key_mask = (np.arange(key_pts.shape[1])[None] < ks[:, None]).astype(np.float32)
    pts = rng.integers(0, img // 4 + 8, size=(b, points, 2)).astype(np.float32)
    counts = torch.tensor([points, points - 7], dtype=torch.int32)
    for dtype in (torch.float32, torch.float64):
        results = []
        for dev in (torch.device("cpu"), torch.device("cuda", 0)):
            model = copy.deepcopy(base).to(dev, dtype).train()
            state = frozen_backbone_adam(model, 1e-4)
            to = lambda a: torch.as_tensor(a).to(dev, dtype)
            batch = [to(imgs), to(bimgs), to(eimgs), to(tgt_pts), to(tgt_mask), to(key_pts),
                     to(key_mask)]
            before = attention.flash_attention.launches
            with plain_attention() if dtype == torch.float64 else contextlib.nullcontext():
                _, m = make_bc_train_step(model)(state, *batch,
                                                 contours=(to(pts), counts.to(dev)))
            launched = attention.flash_attention.launches - before
            want = BC_PER_FORWARD if dev.type == "cuda" and dtype == torch.float32 else 0
            if launched != want:
                raise AssertionError(f"the {dtype} step on {dev} launched the kernel {launched} "
                                     f"times, not {want}")
            got = {f"buffer {k}": t.cpu() for k, t in model.named_buffers()
                   if t.is_floating_point()}
            if dtype == torch.float64:
                got.update({f"grad {k}": p.grad.cpu() for k, p in model.named_parameters()
                            if p.grad is not None})
            results.append((got, {k: v.cpu() for k, v in m.items()}))
        (ref_t, ref_m), (got_t, got_m) = results
        if sorted(ref_t) != sorted(got_t):
            raise AssertionError("the card and the CPU computed gradients of different tensors")
        tol = BE_PARITY_TOL[dtype]
        worst_loss, loss = max((_worst(got_m[k], ref_m[k], tol), k) for k in METRIC_KEYS)
        worst, name = max((_worst(got_t[k], ref_t[k], tol), k) for k in ref_t)
        n_grads = sum(k.startswith("grad") for k in ref_t)
        label = str(dtype)[6:]
        print(f"[bc parity] {label} losses card vs CPU: " + " ".join(
            f"{k}={float(got_m[k]):.6f}/{float(ref_m[k]):.6f}" for k in METRIC_KEYS))
        print(f"[bc parity] {label}: worst loss at {worst_loss:.2e} of its bound ({loss}), worst "
              f"gradient or buffer at {worst:.2e} ({name}); bound atol {tol[0]:g} x max |ref| + "
              f"rtol {tol[1]:g} x |ref|; {n_grads} gradients, {len(ref_t) - n_grads} buffers")
        if worst_loss > 1 or worst > 1 or not all(
                bool(torch.isfinite(t).all()) for t in list(got_t.values()) + list(got_m.values())):
            raise AssertionError(f"the card's {label} BC step disagrees with the CPU's")

    traced = []
    for dev in (torch.device("cpu"), torch.device("cuda", 0)):
        model = copy.deepcopy(base).to(dev).eval()
        with torch.no_grad():
            x = imgs.to(dev, torch.float32)
            probs = model.mask_probs(x)[:, 0].cpu()
            preds = model(x)
        traced.append((probs, preds["contours"].cpu(), preds["contour_counts"].cpu()))
    (p_cpu, pts_cpu, n_cpu), (p_card, pts_card, n_card) = traced
    differ = (p_cpu >= 0.5) != (p_card >= 0.5)
    near = (p_cpu - 0.5).abs() < BC_PROB_MARGIN
    agree = [i for i in range(b) if not bool(differ[i].any())]
    print(f"[bc parity] traced contours: {int(differ.sum())} mask pixels differ, "
          f"{int(near.sum())} within {BC_PROB_MARGIN:g} of 0.5; samples with equal masks "
          f"{agree}, counts card {n_card.tolist()} CPU {n_cpu.tolist()}")
    if bool((differ & ~near).any()) or not agree or not all(
            torch.equal(pts_card[i], pts_cpu[i]) and int(n_card[i]) == int(n_cpu[i])
            for i in agree):
        raise AssertionError("the card's traced contours disagree with the CPU's")


def random_bcp_model(seed: int = 0, points: int = BCP_POINTS, point_attention: bool = False):
    """A seeded BCP ComposeNet, every attention gamma drawn (_draw_gammas)."""
    from vaeplay_torch.models.bcp import ComposeNet

    model = ComposeNet(points, point_attention, generator=torch.Generator().manual_seed(seed))
    _draw_gammas(model, torch.Generator().manual_seed(seed + 1))
    return model


def bcp_flops(img: int, points: int = BCP_POINTS, point_attention: bool = False) -> dict:
    """Multiply-adds x 2 of one image through each part of the BCP step,
    {part: (forward, backward)}, from the layer shapes: every Conv2d and
    Linear of G and D, counted by hooks on a batch of 2 on the meta device,
    and the attention's two products from (N, Dk, Dv) (its backward the
    recompute VJP's five). "g" is G's forward and the backward the G phase
    takes through it; "d_phase" D on the real and the fake points with its
    weight gradients; "g_phase" D on the fake points again, with input
    gradients only. A layer's backward costs its forward once for the
    weight gradient, if it is taken, and once for the input gradient, if
    its input needs one."""
    from vaeplay_torch.models.bcp import ComposeNet, Discriminator

    with torch.device("meta"):
        g = ComposeNet(points, point_attention).train()
        d = Discriminator(img, points).train()
    out, part = {"g": [0, 0], "d_phase": [0, 0], "g_phase": [0, 0]}, ["g"]

    def hook(m, inputs, y):
        x = inputs[0]
        if isinstance(m, torch.nn.Conv2d):
            f = 2 * y.numel() // y.shape[0] * (m.in_channels // m.groups) * math.prod(m.kernel_size)
        else:
            f = 2 * y.numel() // y.shape[0] * m.in_features
        out[part[0]][0] += f
        out[part[0]][1] += f * (int(m.weight.requires_grad) + int(x.requires_grad))

    for m in list(g.modules()) + list(d.modules()):
        if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)):
            m.register_forward_hook(hook)
    x = torch.zeros(2, 3, img, img, device="meta")
    with plain_attention():  # the kernel takes no meta tensor; its products are counted below
        preds = g(x, torch.zeros(2, points, 2, device="meta"),
                  torch.full((2,), points, dtype=torch.int32, device="meta"))
    if point_attention:
        n, dk, dv = points, 32, 260
        out["g"][0] += 3 * 2 * n * n * (dk + dv)
        out["g"][1] += 3 * 2 * n * n * (3 * dk + 2 * dv)
    fake = torch.cat([preds["contours"], preds["target_pts"]], dim=-1)
    part[0] = "d_phase"
    d(x, torch.zeros(2, points, 4, device="meta"))
    d(x, fake.detach())
    part[0] = "g_phase"
    d.requires_grad_(False)
    d(x, fake)
    return {k: tuple(v) for k, v in out.items()}


def _check_bcp_preds(preds, batch: int, points: int) -> None:
    shapes = {"classes": (batch, 2), "contours": (batch, points, 2), "contour_counts": (batch,),
              "target_pts": (batch, points, 2), "target_frequency": (batch, points)}
    for name, shape in shapes.items():
        t = preds[name]
        if tuple(t.shape) != shape or (t.is_floating_point() and not bool(torch.isfinite(t).all())):
            raise AssertionError(f"{name}: shape {tuple(t.shape)} (want {shape}) or not finite")
    freq = preds["target_frequency"]
    if float(freq.min()) < 0 or float(freq.max()) > 1:
        raise AssertionError("trigger probabilities outside [0, 1]")


def write_bcp_test_tree(root: str, n: int, img: int) -> str:
    """A BCPDatasetTEST tree under root: class dirs "2" and "3", n samples of
    synthetic emit bubbles (SyntheticBCPDataset), each an image, its `_mask2`
    (the bubble image, channel 0) and its `_layer` (the content mask red and
    its ring green, on white: the reference's layer encoding)."""
    import numpy as np
    from PIL import Image

    from vaeplay_torch.data.bcp_data import SyntheticBCPDataset

    imgs = SyntheticBCPDataset(img_size=img, max_points=16).sample_batch(n, 9)["imgs"]
    for i in range(n):
        folder = os.path.join(root, "2" if i % 2 else "3")
        os.makedirs(folder, exist_ok=True)
        gray = (imgs[i, :, :, 0] * 255).astype(np.uint8)
        for suffix in ("", "_mask2"):
            Image.fromarray(gray).save(os.path.join(folder, f"p{i}{suffix}.png"))
        layer = np.full((img, img, 3), 255, np.uint8)
        layer[imgs[i, :, :, 1] > 0] = (255, 0, 0)
        layer[imgs[i, :, :, 2] > 0] = (255, 255, 0)
        Image.fromarray(layer).save(os.path.join(folder, f"p{i}_layer.png"))
    return root


def phase_bcp_infer(tmp: str, gpu: str) -> None:
    """BCP inference through the test_bcp CLI on cuda:0 at 512 px, batch 4,
    2048 points, full width, seeded random weights: --debug (one synthetic
    batch) and --path over a synthetic class-2/3 tree; then timed batches
    with the host trace apart (eval_contours_from_masks on the host batch,
    then the copy and the forward), the peak memory, the forward's FLOPs and
    bound, a profile; then the point-attention forward at batch 4, which
    launches the kernel BCP_PER_FORWARD times (test_bcp's G has no
    attention, as the JAX CLI's)."""
    from vaeplay_torch.cli import test_bcp
    from vaeplay_torch.data.bcp_data import SyntheticBCPDataset
    from vaeplay_torch.models.bcp import eval_contours_from_masks
    from vaeplay_torch.ops import attention

    dev = torch.device("cuda", 0)
    weights = os.path.join(tmp, "bcp_random.pt")
    torch.save(random_bcp_model(0).state_dict(), weights)
    data = write_bcp_test_tree(os.path.join(tmp, "bcp_data"), BCP_INFER_BATCH + 2, BCP_IMG)
    for label, extra, grids in (("--debug", ["--debug"], ["points.png"]),
                                ("--path", ["--path", data], ["points_0.png", "points_1.png"])):
        before = attention.flash_attention.launches
        t0 = time.perf_counter()
        written = test_bcp.main(["--model_path", weights, "--gpu", "0", "--img_size",
                                 str(BCP_IMG), "--max_points", str(BCP_POINTS), "--batchsize",
                                 str(BCP_INFER_BATCH), "--res_output",
                                 os.path.join(tmp, f"bcp_test{len(grids)}"), *extra])
        launches = attention.flash_attention.launches - before
        print(f"[bcp-infer] CLI run {label} (load, {len(grids)} batch(es) of up to "
              f"{BCP_INFER_BATCH} at {BCP_IMG} px, grids) {time.perf_counter() - t0:.2f} s; "
              f"wrote {written}")
        if ([os.path.basename(p) for p in written] != grids or launches
                or not all(os.path.getsize(p) > 0 for p in written)):
            raise AssertionError(f"test_bcp {label} wrote {written} with {launches} launches")

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = test_bcp.load_model(weights, BCP_POINTS, dev)
    ds = SyntheticBCPDataset(img_size=BCP_IMG, max_points=BCP_POINTS,
                             data_size=(BCP_TIMED + 1) * BCP_INFER_BATCH, seed=5)
    batches = [b["imgs"] for b in ds.epoch_batches(BCP_INFER_BATCH)]
    times, traces = [], []
    for i, imgs in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pts, counts = eval_contours_from_masks(imgs, BCP_POINTS)
        t1 = time.perf_counter()
        preds = test_bcp.forward(model, imgs, pts, counts, dev)
        torch.cuda.synchronize()
        ms, trace_ms = (time.perf_counter() - t0) * 1e3, (t1 - t0) * 1e3
        _check_bcp_preds(preds, BCP_INFER_BATCH, BCP_POINTS)
        if i:
            times.append(ms)
            traces.append(trace_ms)
        print(f"[bcp-infer] batch {i}{' (warm-up)' if i == 0 else ''}: {ms:.2f} ms (PyTorch "
              f"defaults: TF32 convolutions; batch {BCP_INFER_BATCH}, {BCP_IMG} px, host clock), "
              f"of which the host trace {trace_ms:.2f} ms ({trace_ms / ms:.1%}) and the copy and "
              f"forward {ms - trace_ms:.2f} ms; counts {counts.tolist()} on {gpu}")
    print(f"[bcp-infer] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          f"(torch.cuda.max_memory_allocated: weights and activations)")
    fwd = bcp_flops(BCP_IMG)["g"][0] * BCP_INFER_BATCH
    median, trace = sorted(times)[len(times) // 2], sorted(traces)[len(traces) // 2]
    print(f"[bcp-infer] forward {fwd / 1e12:.3f} TFLOP a batch, bound "
          f"{fwd / PEAK_TF32_FLOPS * 1e3:.3f} ms at {PEAK_TF32_FLOPS / 1e12:.0f} TFLOP/s TF32; "
          f"median batch {median:.2f} ms, {BCP_INFER_BATCH / median * 1e3:.1f} images/s, host "
          f"trace {trace:.2f} ms ({trace / median:.1%}), {fwd / PEAK_TF32_FLOPS * 1e3 / median:.1%} "
          f"of the bound on {gpu}")
    _profile(lambda: test_bcp.predict(model, batches[1], dev), "bcp-infer", runs=1)

    model = random_bcp_model(1, point_attention=True).to(dev).eval()
    pts, counts = eval_contours_from_masks(batches[1], BCP_POINTS)
    times = []
    for i in range(BCP_TIMED + 1):
        before = attention.flash_attention.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        preds = test_bcp.forward(model, batches[1], pts, counts, dev)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        _check_bcp_preds(preds, BCP_INFER_BATCH, BCP_POINTS)
        if attention.flash_attention.launches - before != BCP_PER_FORWARD:
            raise AssertionError(f"a point-attention forward did not launch the kernel "
                                 f"{BCP_PER_FORWARD} times")
    print(f"[bcp-infer] point-attention forward (random gammas), batch {BCP_INFER_BATCH}: "
          f"copy and forward " + ", ".join(f"{t:.2f}" for t in times)
          + f" ms (the first a warm-up), {BCP_PER_FORWARD} kernel launches each, on {gpu}")
    del model
    torch.cuda.empty_cache()


def _check_bcp_run(run: str, epoch: int, label: str) -> None:
    """A train_bcp run dir of one epoch: its checkpoint and one log line of
    the eight losses, finite."""
    from vaeplay_torch.train.steps_bcp import METRIC_KEYS

    if sorted(os.listdir(run)) != [f"{epoch}.ckpt", "metrics.jsonl", "record.txt"]:
        raise AssertionError(f"run dir {run} holds {sorted(os.listdir(run))}")
    with open(os.path.join(run, "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    if [r["epoch"] for r in lines] != [epoch] or not all(
            math.isfinite(r[k]) for r in lines for k in METRIC_KEYS):
        raise AssertionError(f"logged losses of epoch {epoch}: {lines}")
    r = lines[0]
    print(f"[bcp-train] {label} epoch {epoch}: " + " ".join(f"{k}={r[k]:.4f}" for k in METRIC_KEYS)
          + f" ({r['images_per_sec']:.1f} img/s over the epoch, CLI's host clock); checkpoint "
          f"{os.path.getsize(os.path.join(run, f'{epoch}.ckpt')) / 2**30:.2f} GiB")


def _bcp_cli(tmp: str, name: str, label: str, *extra) -> str:
    """train_bcp at 512 px, batch 16, 2048 points: label "float32",
    "bfloat16" or "attention" (f32 with --point_attention)."""
    from vaeplay_torch.cli import train_bcp
    from vaeplay_torch.ops import attention

    n = BCP_ITERATIONS[label]
    flags = ["--point_attention"] if label == "attention" else []
    before = attention.flash_attention.launches
    t0 = time.perf_counter()
    run = train_bcp.main(["--gpu", "0", "--img_size", str(BCP_IMG), "--max_points",
                          str(BCP_POINTS), "--batchsize", str(BCP_TRAIN_BATCH), "--iterations",
                          str(n), "--viz_freq", str(n), "--dtype",
                          "bfloat16" if label == "bfloat16" else "float32", *flags,
                          "--res_output", os.path.join(tmp, "bcp_results"),
                          "--model_output", os.path.join(tmp, name), *extra])
    launches = attention.flash_attention.launches - before
    print(f"[bcp-train] CLI run {label} {' '.join(extra)} (init, {n} iterations, checkpoint) "
          f"{time.perf_counter() - t0:.2f} s, {launches} kernel launches: {run}")
    if launches != (BCP_PER_FORWARD * n if flags else 0):
        raise AssertionError(f"train_bcp {label} launched the kernel {launches} times in "
                             f"{n} iterations")
    return run


def _bcp_timed(label: str, gpu: str) -> tuple:
    """A warm-up and BCP_TIMED steps of make_bcp_train_step (label as
    _bcp_cli's) at PyTorch's defaults, the batch's copy, G's forward, the D
    phase and the G phase timed apart on the host clock (each ending in a
    synchronize); the peak device memory. Returns (step, state, a batch on
    the card) for a profile, and the median (copy, forward, D, G, step) ms."""
    from vaeplay_torch.cli.train_bcp import build_state, device_batch
    from vaeplay_torch.data.bcp_data import SyntheticBCPDataset
    from vaeplay_torch.ops import attention
    from vaeplay_torch.train.steps_bcp import make_bcp_train_step

    dev = torch.device("cuda", 0)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    pa = label == "attention"
    gs = build_state(BCP_IMG, BCP_POINTS, 1e-3, 1e-3, 0, dev, pa)
    gs.g.model.train()
    gs.d.model.train()
    step = make_bcp_train_step(gs.g.model, gs.d.model,
                               torch.bfloat16 if label == "bfloat16" else torch.float32)
    ds = SyntheticBCPDataset(img_size=BCP_IMG, max_points=BCP_POINTS,
                             data_size=(BCP_TIMED + 2) * BCP_TRAIN_BATCH)
    host = list(ds.epoch_batches(BCP_TRAIN_BATCH))
    times = []
    for i, b in enumerate(host[:BCP_TIMED + 1]):
        before = attention.flash_attention.launches
        torch.cuda.synchronize()
        t = [time.perf_counter()]
        batch = device_batch(b, dev)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        preds = step.forward(*batch)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        gs, dm = step.d_phase(gs, preds, *batch)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        gs, gm = step.g_phase(gs, preds, *batch)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        del preds
        if not all(bool(torch.isfinite(v)) for v in {**dm, **gm}.values()):
            raise AssertionError(f"non-finite losses: {dm} {gm}")
        if attention.flash_attention.launches - before != (BCP_PER_FORWARD if pa else 0):
            raise AssertionError(f"a {label} BCP step launched the kernel "
                                 f"{attention.flash_attention.launches - before} times")
        ms = tuple((t[j + 1] - t[j]) * 1e3 for j in range(4)) + ((t[4] - t[0]) * 1e3,)
        if i:
            times.append(ms)
        print(f"[bcp-train] {label} step {i}{' (warm-up)' if i == 0 else ''}: copy {ms[0]:.2f} "
              f"ms, G forward {ms[1]:.2f} ms, D phase {ms[2]:.2f} ms, G phase {ms[3]:.2f} ms, "
              f"step {ms[4]:.2f} ms, {BCP_TRAIN_BATCH / ms[4] * 1e3:.1f} images/s (PyTorch "
              f"defaults; batch {BCP_TRAIN_BATCH}, {BCP_IMG} px, host clock) on {gpu}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[bcp-train] {label} peak device memory {peak:.2f} GiB (torch.cuda."
          f"max_memory_allocated: both nets' weights, gradients, Adam moments, activations)")
    medians = tuple(sorted(t[j] for t in times)[len(times) // 2] for j in range(5))
    return (step, gs, device_batch(host[-1], dev)), medians


def phase_bcp_train(tmp: str, gpu: str) -> dict:
    """BCP through the train_bcp CLI at 512 px, batch 16, 2048 points, full
    width: f32 for one epoch, a resume for a second, bf16 for one epoch, f32
    with --point_attention for one epoch (3 launches an iteration), test_bcp
    on the resumed run dir (each run dir deleted once checked); then the
    parameter counts, the step's FLOPs and bound, and timed steps with the
    phases apart and a profile in each of f32, bf16 and f32 with point
    attention. Returns the median step ms by run."""
    from vaeplay_torch.cli import test_bcp
    from vaeplay_torch.models.bcp import ComposeNet, Discriminator

    run = _bcp_cli(tmp, "bcp_a", "float32", "--epoch", "1")
    _check_bcp_run(run, 0, "float32")
    resumed = _bcp_cli(tmp, "bcp_b", "float32", "--epoch", "2", "--resume", run)
    _check_bcp_run(resumed, 1, "float32")
    shutil.rmtree(os.path.join(tmp, "bcp_a"))
    for label in ("bfloat16", "attention"):
        _check_bcp_run(_bcp_cli(tmp, f"bcp_{label}", label, "--epoch", "1"), 0, label)
        shutil.rmtree(os.path.join(tmp, f"bcp_{label}"))
    written = test_bcp.main(["--model_path", resumed, "--gpu", "0", "--img_size", str(BCP_IMG),
                             "--max_points", str(BCP_POINTS), "--batchsize",
                             str(BCP_INFER_BATCH), "--res_output", os.path.join(tmp, "bcp_trained")])
    if len(written) != 1 or not os.path.getsize(written[0]):
        raise AssertionError(f"test_bcp on the trained run dir wrote {written}")
    print(f"[bcp-train] test_bcp --model_path <run dir> wrote {written}")
    shutil.rmtree(os.path.join(tmp, "bcp_b"))

    with torch.device("meta"):
        counts = {name: sum(p.numel() for p in m.parameters()) for name, m in (
            ("G", ComposeNet(BCP_POINTS)), ("G with point attention",
                                            ComposeNet(BCP_POINTS, True)),
            ("D", Discriminator(BCP_IMG, BCP_POINTS)))}
    print("[bcp-train] parameters: " + ", ".join(f"{k} {v / 1e6:.2f} M" for k, v in counts.items()))
    medians = {}
    for label, peak, rate in (("float32", PEAK_TF32_FLOPS, "TF32"),
                              ("bfloat16", PEAK_BF16_FLOPS, "bf16"),
                              ("attention", PEAK_TF32_FLOPS, "TF32")):
        flops = bcp_flops(BCP_IMG, BCP_POINTS, label == "attention")
        step_flops = sum(sum(v) for v in flops.values()) * BCP_TRAIN_BATCH
        print(f"[bcp-train] {label} GFLOP per image from the layer shapes (forward, backward): "
              + "; ".join(f"{k} {v[0] / 1e9:.2f}, {v[1] / 1e9:.2f}" for k, v in flops.items())
              + f"; step ({BCP_TRAIN_BATCH} images) {step_flops / 1e12:.3f} TFLOP, bound "
              f"{step_flops / peak * 1e3:.2f} ms at {peak / 1e12:.0f} TFLOP/s {rate} (dense "
              f"tensor-core rate, 700 W)")
        profiled = None  # the previous state is freed before this peak is taken
        profiled, ms = _bcp_timed(label, gpu)
        medians[label] = ms[4]
        print(f"[bcp-train] {label} median copy {ms[0]:.2f} ms, G forward {ms[1]:.2f} ms, D phase "
              f"{ms[2]:.2f} ms, G phase {ms[3]:.2f} ms, step {ms[4]:.2f} ms, "
              f"{BCP_TRAIN_BATCH / ms[4] * 1e3:.1f} images/s, {step_flops / ms[4] / 1e9:.1f} "
              f"TFLOP/s, {step_flops / peak * 1e3 / ms[4]:.1%} of the {rate} bound on {gpu}")
        step, gs, batch = profiled
        _profile(lambda: step(gs, *batch), f"bcp-train {label}", runs=1)
        del step, gs, batch
    del profiled
    torch.cuda.empty_cache()
    return medians


def phase_bcp_parity() -> None:
    """One BCP step (G forward, D phase, G phase) on the card and on the CPU
    from the same seeded weights (full width, gammas drawn), noise images
    and synthetic points (128 px, batch 2, 128 points), with and without
    point attention, TF32 off. f32 (the kernel on the card): the eight
    losses, and both nets' weights after the step within the bound plus
    Adam's first-step slope lr / eps times the gradients' difference. f64
    (the plain attention on both, the kernel taking no f64): the eight
    losses and both nets' gradients."""
    import numpy as np

    from vaeplay_torch.data.bcp_data import SyntheticBCPDataset
    from vaeplay_torch.models.bcp import Discriminator
    from vaeplay_torch.ops import attention
    from vaeplay_torch.train.state import GanState, TrainState
    from vaeplay_torch.train.steps_bcp import make_bcp_train_step

    cfg = BCP_PARITY
    b, img, points, lr = cfg["batch"], cfg["img"], cfg["points"], cfg["lr"]
    data = SyntheticBCPDataset(img_size=img, max_points=points).sample_batch(b, 3)
    data["pmask"][1, points - 9:] = 0
    imgs = np.random.default_rng(11).uniform(size=(b, 3, img, img))
    d_base = Discriminator(img, points, generator=torch.Generator().manual_seed(8))
    for pa in (False, True):
        g_base = random_bcp_model(7, points, pa)
        for dtype in (torch.float32, torch.float64):
            results = []
            for dev in (torch.device("cpu"), torch.device("cuda", 0)):
                g = copy.deepcopy(g_base).to(dev, dtype).train()
                d = copy.deepcopy(d_base).to(dev, dtype).train()
                gs = GanState(TrainState.create(g, lr), TrainState.create(d, lr))
                to = lambda a: torch.as_tensor(a).to(dev, dtype)
                batch = (to(imgs), torch.as_tensor(data["labels"]).to(dev), to(data["points"]),
                         to(data["pmask"]))
                before = attention.flash_attention.launches
                with plain_attention() if dtype == torch.float64 else contextlib.nullcontext():
                    _, m = make_bcp_train_step(g, d)(gs, *batch)
                launched = attention.flash_attention.launches - before
                want = BCP_PER_FORWARD if pa and dev.type == "cuda" and dtype == torch.float32 else 0
                if launched != want:
                    raise AssertionError(f"the {dtype} step on {dev} launched the kernel "
                                         f"{launched} times, not {want}")
                got = {f"{kind} {net} {k}": (p.grad if kind == "grad" else p).detach().cpu()
                       for net, model in (("g", g), ("d", d)) for k, p in model.named_parameters()
                       for kind in ("grad", "weight")}
                results.append(({k: v.cpu() for k, v in m.items()}, got))
            _hold_step("bcp parity", f"{str(dtype)[6:]}{' point attention' if pa else ''}",
                       *results, dtype, lr, lambda k: BCP_ZERO_GRADS.get(k, k))


# ---------------------------------------------------------------------------
# BE_font: phase 2's N = 1 kernel check and phases 21-23


def phase_kernels_be_font(gpu: str) -> dict:
    """Phase 2 at BE_font's embedding-block shape (B 32 and 8, N 1, Dk 32, Dv
    256): the kernel against the plain version (and, printed, against v) in
    the model's layout (channel and position stride both 1) and the
    position-major one, f32 and bf16; the Function's gradients in both
    layouts, dq and dk exactly 0; the route of the model's k and v (direct,
    no copy); then at each batch the times of the kernel (in the model's
    layout), the plain version, the library call and the plain backward.
    Returns the kernel line's be_font_* keys (B = 32) and be_font_b8_* keys
    (B = 8)."""
    from vaeplay_torch.ops import attention

    out = {}
    for i, shape in enumerate(FONT_SHAPES):
        key = "be_font" if i == 0 else "be_font_b8"
        for dtype in (torch.float32, torch.bfloat16):
            for layout in ("n", "c"):
                err = _check_case(shape, dtype, layout, 1.0, seed=500 + i)
                if dtype == torch.float32 and layout == "c":
                    out[f"{key}_max_abs_err"] = err
        for layout in ("c", "n"):
            _grad_check(shape, layout, 1.0, seed=510 + i)
        b, n, dk, dv = shape
        _model_route(shape, torch.float32, "direct", "BE_font")
        q, k, v = _qkv(shape, torch.float32, seed=0, layout="c")
        res = torch.empty(b, dv, n, device="cuda").transpose(1, 2)
        ms = cuda_ms(lambda: attention.flash_attention(q, k, v, out=res), iters=200)
        plain_ms = cuda_ms(lambda: attention.reference_attention(q, k, v), iters=200)
        # the library call on the same values, position-major: its kernels
        # refuse the model's strides (channel and position stride both 1)
        q4, k4, v4 = (t[:, None] for t in _qkv(shape, torch.float32, seed=0, layout="n"))
        backend = _sdpa_backend(q4, k4, v4)
        library_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q4, k4, v4, scale=1.0), iters=200)
        g = _qkv(shape, torch.float32, seed=1000, layout="c")[2]
        bwd_ms = cuda_ms(lambda: attention.attention_backward(q, k, v, g), iters=200)
        bound_ms, bound_by, flops = _forward_bound(shape)
        print(f"[kernels] BE_font shape B,N,Dk,Dv={shape} f32, the model's layout, on {gpu}: "
              f"kernel_ms {ms:.5f} (k and v read in place by the direct route, 0 bytes copied), "
              f"plain_ms {plain_ms:.5f}, library_ms {library_ms:.5f} (backend {backend}), "
              f"attention_backward_ms "
              f"{bwd_ms:.5f}, bound_ms {bound_ms:.7f} ({bound_by}: "
              f"{4 * b * n * (2 * dk + 2 * dv) / 1e3:.1f} kB at "
              f"{PEAK_BYTES_PER_S / 1e12:.2f} TB/s; {TF32_PASSES} x {flops / 1e3:.1f} kFLOP), "
              f"{bound_ms / ms:.2%} of its bound")
        out.update({f"{key}_shape": list(shape), f"{key}_ms": ms, f"{key}_plain_ms": plain_ms,
                    f"{key}_bound_ms": bound_ms, f"{key}_bound_by": bound_by,
                    f"{key}_library_ms": library_ms, f"{key}_backward_ms": bwd_ms})
    out["be_font_launches"] = None
    return out


def random_font_model(seed: int = 0, img: int = FONT_IMG):
    """A seeded BE_font ComposeNet, every attention gamma drawn (_draw_gammas)."""
    from vaeplay_torch.models.be_font import ComposeNet

    model = ComposeNet(img, generator=torch.Generator().manual_seed(seed))
    _draw_gammas(model, torch.Generator().manual_seed(seed + 1))
    return model


def font_flops(img: int) -> dict:
    """Multiply-adds x 2 of one image through each part of BE_font,
    {part: (forward, backward)}, from the layer shapes: every Conv2d and
    Linear of G and D, counted by hooks on a batch of 2 on the meta device
    (the attention's products at N = 1 are 2 (32 + 256) per block: left
    out). "g_label" and "g_self" are test_be_font's two forwards; the step
    is "d_phase" (G under no_grad, D on the real and the fake maps with its
    weight gradients), "g_phase" (G with its gradients, D frozen on the fake
    maps) and "s_phase" (G under no_grad with labels, then self-encoded with
    only the style encoder's weight gradients); "relay_fcs_in_step" is the
    part of the three phases that G's two relay FCs take. A layer's backward costs its
    forward once for the weight gradient, if it is taken, and once for the
    input gradient, if its input needs one."""
    from vaeplay_torch.models.be_font import ComposeNet, Discriminator

    with torch.device("meta"):
        g = ComposeNet(img).train()
        d = Discriminator(img).train()
    out = {k: [0, 0] for k in ("g_label", "g_self", "d_phase", "g_phase", "s_phase",
                               "relay_fcs_in_step")}
    part, relay = ["g_label"], set(g.relay_convs.modules())

    def hook(m, inputs, y):
        x = inputs[0]
        if isinstance(m, torch.nn.Conv2d):
            f = 2 * y.numel() // y.shape[0] * (m.in_channels // m.groups) * math.prod(m.kernel_size)
        else:
            f = 2 * y.numel() // y.shape[0] * m.in_features
        bwd = 0
        if torch.is_grad_enabled():
            bwd = f * (int(m.weight.requires_grad) + int(x.requires_grad))
        out[part[0]][0] += f
        out[part[0]][1] += bwd
        if m in relay and part[0].endswith("_phase"):
            out["relay_fcs_in_step"][0] += f
            out["relay_fcs_in_step"][1] += bwd

    for m in list(g.modules()) + list(d.modules()):
        if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)):
            m.register_forward_hook(hook)
    x = torch.zeros(2, 3, img, img, device="meta")
    y = {"cls": torch.zeros(2, 143, device="meta"), "cnt_style": torch.zeros(2, 5, device="meta")}
    maps = torch.zeros(2, 2, img, img, device="meta")
    with plain_attention():  # the kernel takes no meta tensor
        with torch.no_grad():
            g(x, y)
            part[0] = "g_self"
            g(x)
            part[0] = "d_phase"
            fake = g(x, y)
        d(maps, y)
        d(torch.cat([fake["masks"], fake["edges"]], 1), y)
        part[0] = "g_phase"
        fake = g(x, y)
        d.requires_grad_(False)
        d(torch.cat([fake["masks"], fake["edges"]], 1), y)
        part[0] = "s_phase"
        with torch.no_grad():
            g(x, y)
        for name, p in g.named_parameters():
            p.requires_grad_(name.startswith("style_encoder."))
        g(x)
    return {k: tuple(v) for k, v in out.items()}


def write_kana_folder(root: str, n: int) -> str:
    """n synthetic glyph images (SyntheticGlyphDataset.glyph) as a kana
    folder for test_be_font --path."""
    import numpy as np

    from vaeplay_torch.data.font_data import SyntheticGlyphDataset

    os.makedirs(root, exist_ok=True)
    ds, rng = SyntheticGlyphDataset(), np.random.default_rng(9)
    for i in range(n):
        ds.glyph(rng)[0].save(os.path.join(root, f"kana_{i:02d}.png"))
    return root


def _check_font_preds(preds, batch: int) -> None:
    for name in ("masks", "edges"):
        t = preds[name]
        if (tuple(t.shape) != (batch, 1, FONT_IMG, FONT_IMG) or not bool(torch.isfinite(t).all())
                or float(t.min()) < 0 or float(t.max()) > 1):
            raise AssertionError(f"{name}: shape {tuple(t.shape)}, or not finite probabilities")


def phase_be_font_infer(tmp: str, gpu: str) -> None:
    """BE_font inference through the test_be_font CLI on cuda:0 at 64 px,
    batch 8, full width, seeded random weights with nonzero gammas: --debug
    (one synthetic batch through both conditioning paths: 6 launches) and
    --path over a synthetic kana folder (the self-encoded path: none); then
    a warm-up and timed batches with the label path and the self-encoded
    path apart (host clock around the copy, forward, sigmoid and
    synchronize), 6 and 0 launches each, the peak memory, the forwards'
    FLOPs and bound, and a profile of each path."""
    from vaeplay_torch.cli import test_be_font
    from vaeplay_torch.data.font_data import SyntheticGlyphDataset
    from vaeplay_torch.ops import attention

    dev = torch.device("cuda", 0)
    weights = os.path.join(tmp, "font_random.pt")
    torch.save(random_font_model(0).state_dict(), weights)
    kana = write_kana_folder(os.path.join(tmp, "kana"), FONT_INFER_BATCH + 2)
    for label, extra, grids, want in (
            ("--debug", ["--debug"], ["font.png"], FONT_PER_G_FORWARD),
            ("--path", ["--path", kana], ["test_0.png", "test_1.png"], 0)):
        before = attention.flash_attention.launches
        t0 = time.perf_counter()
        written = test_be_font.main(["--model_path", weights, "--gpu", "0", "--img_size",
                                     str(FONT_IMG), "--batchsize", str(FONT_INFER_BATCH),
                                     "--res_output", os.path.join(tmp, f"font_test{len(grids)}"),
                                     *extra])
        launches = attention.flash_attention.launches - before
        print(f"[be_font-infer] CLI run {label} (load, {len(grids)} grid(s), batch "
              f"{FONT_INFER_BATCH} at {FONT_IMG} px) {time.perf_counter() - t0:.2f} s, "
              f"{launches} kernel launches; wrote {written}")
        if ([os.path.basename(p) for p in written] != grids or launches != want
                or not all(os.path.getsize(p) > 0 for p in written)):
            raise AssertionError(f"test_be_font {label} wrote {written} with {launches} launches")

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = test_be_font.load_model(weights, FONT_IMG, dev)
    ds = SyntheticGlyphDataset(data_size=(FONT_TIMED + 1) * FONT_INFER_BATCH, seed=5)
    batches = list(ds.batches(FONT_INFER_BATCH, FONT_IMG))
    flops = font_flops(FONT_IMG)
    for path, want in (("label", FONT_PER_G_FORWARD), ("self-encoded", 0)):
        times = []
        for i, b in enumerate(batches):
            cond = (b["labels"], b["styles"]) if path == "label" else ()
            before = attention.flash_attention.launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            preds = test_be_font.predict(model, b["imgs"], dev, *cond)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            _check_font_preds(preds, FONT_INFER_BATCH)
            if attention.flash_attention.launches - before != want:
                raise AssertionError(f"a {path} forward launched the kernel "
                                     f"{attention.flash_attention.launches - before} times")
            if i:
                times.append(ms)
            print(f"[be_font-infer] {path} path batch {i}{' (warm-up)' if i == 0 else ''}: "
                  f"{ms:.3f} ms (PyTorch defaults; batch {FONT_INFER_BATCH}, {FONT_IMG} px, host "
                  f"clock: copy, forward, sigmoid) on {gpu}")
        fwd = flops["g_label" if path == "label" else "g_self"][0] * FONT_INFER_BATCH
        median = sorted(times)[len(times) // 2]
        print(f"[be_font-infer] {path} path: median batch {median:.3f} ms, "
              f"{FONT_INFER_BATCH / median * 1e3:.1f} images/s; forward {fwd / 1e9:.2f} GFLOP a "
              f"batch, bound {fwd / PEAK_TF32_FLOPS * 1e3:.4f} ms at "
              f"{PEAK_TF32_FLOPS / 1e12:.0f} TFLOP/s TF32, {fwd / PEAK_TF32_FLOPS * 1e3 / median:.2%} "
              f"of it; {want} kernel launches a batch on {gpu}")
        b = batches[1]
        cond = (b["labels"], b["styles"]) if path == "label" else ()
        _profile(lambda: test_be_font.predict(model, b["imgs"], dev, *cond),
                 f"be_font-infer {path}", runs=3)
    print(f"[be_font-infer] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          f"(torch.cuda.max_memory_allocated: weights and activations)")
    del model
    torch.cuda.empty_cache()


def _check_font_run(run: str, epoch: int, label: str) -> None:
    """A train_be_font run dir of one epoch: its checkpoint and one log line
    of the eight averaged losses, finite."""
    from vaeplay_torch.train.steps_be_font import AVG_KEYS

    if sorted(os.listdir(run)) != [f"{epoch}.ckpt", "metrics.jsonl", "record.txt"]:
        raise AssertionError(f"run dir {run} holds {sorted(os.listdir(run))}")
    with open(os.path.join(run, "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    if [r["epoch"] for r in lines] != [epoch] or not all(
            math.isfinite(r[k]) for r in lines for k in AVG_KEYS):
        raise AssertionError(f"logged losses of epoch {epoch}: {lines}")
    r = lines[0]
    print(f"[be_font-train] {label} epoch {epoch}: " + " ".join(f"{k}={r[k]:.4f}" for k in AVG_KEYS)
          + f" ({r['images_per_sec']:.1f} img/s over the epoch, CLI's host clock, host synthesis "
          f"included); checkpoint {os.path.getsize(os.path.join(run, f'{epoch}.ckpt')) / 2**30:.2f} "
          f"GiB")


def _font_cli(tmp: str, name: str, dtype: str, *extra) -> str:
    """train_be_font at 64 px, batch 32, in `dtype`; every iteration must
    launch the kernel FONT_PER_STEP times."""
    from vaeplay_torch.cli import train_be_font
    from vaeplay_torch.ops import attention

    n = FONT_ITERATIONS[dtype]
    before = attention.flash_attention.launches
    t0 = time.perf_counter()
    run = train_be_font.main(["--gpu", "0", "--img_size", str(FONT_IMG), "--batchsize",
                              str(FONT_TRAIN_BATCH), "--iterations", str(n), "--viz_freq", str(n),
                              "--dtype", dtype, "--res_output", os.path.join(tmp, "font_results"),
                              "--model_output", os.path.join(tmp, name), *extra])
    launches = attention.flash_attention.launches - before
    print(f"[be_font-train] CLI run {dtype} {' '.join(extra)} (init, {n} iterations, checkpoint) "
          f"{time.perf_counter() - t0:.2f} s, {launches} kernel launches: {run}")
    if launches != FONT_PER_STEP * n:
        raise AssertionError(f"train_be_font {dtype} launched the kernel {launches} times in "
                             f"{n} iterations")
    return run


def _font_timed(dtype: str, gpu: str) -> tuple:
    """A warm-up and FONT_TIMED steps of make_be_font_train_step in `dtype`
    at PyTorch's defaults: the host's synthesis of the batch, its copy, and
    the D, G and S phases timed apart on the host clock (each ending in a
    synchronize), FONT_PER_STEP launches a step; the peak device memory.
    Returns (step, state, a batch on the card) for a profile, and the median
    (synthesis, copy, D, G, S, device step) ms."""
    from vaeplay_torch.cli.train_be_font import build_state, device_batch
    from vaeplay_torch.data.font_data import SyntheticGlyphDataset
    from vaeplay_torch.ops import attention
    from vaeplay_torch.train.steps_be_font import make_be_font_train_step
    from vaeplay_torch.utils.amp import resolve_dtype

    dev = torch.device("cuda", 0)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fs = build_state(FONT_IMG, 1e-4, 0, dev)
    fs.g.model.train()
    fs.d.model.train()
    step = make_be_font_train_step(fs.g.model, fs.d.model, resolve_dtype(dtype))
    host = SyntheticGlyphDataset(data_size=(FONT_TIMED + 1) * FONT_TRAIN_BATCH).batches(
        FONT_TRAIN_BATCH, FONT_IMG)
    times = []
    for i in range(FONT_TIMED + 1):
        before = attention.flash_attention.launches
        torch.cuda.synchronize()
        t = [time.perf_counter()]
        b = next(host)
        t.append(time.perf_counter())
        batch = device_batch(b, dev)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        metrics = {}
        for phase in (step.d_phase, step.g_phase, step.s_phase):
            fs, m = phase(fs, *batch)
            metrics.update(m)
            torch.cuda.synchronize()
            t.append(time.perf_counter())
        if not all(bool(torch.isfinite(v)) for v in metrics.values()):
            raise AssertionError(f"non-finite losses: {metrics}")
        if attention.flash_attention.launches - before != FONT_PER_STEP:
            raise AssertionError(f"a {dtype} BE_font step launched the kernel "
                                 f"{attention.flash_attention.launches - before} times")
        ms = tuple((t[j + 1] - t[j]) * 1e3 for j in range(5)) + ((t[5] - t[2]) * 1e3,)
        if i:
            times.append(ms)
        print(f"[be_font-train] {dtype} step {i}{' (warm-up)' if i == 0 else ''}: host synthesis "
              f"{ms[0]:.2f} ms, copy {ms[1]:.2f} ms, D phase {ms[2]:.2f} ms, G phase "
              f"{ms[3]:.2f} ms, S phase {ms[4]:.2f} ms, device step {ms[5]:.2f} ms, "
              f"{FONT_TRAIN_BATCH / ms[5] * 1e3:.1f} images/s (PyTorch defaults; batch "
              f"{FONT_TRAIN_BATCH}, {FONT_IMG} px, host clock) on {gpu}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[be_font-train] {dtype} peak device memory {peak:.2f} GiB (torch.cuda."
          f"max_memory_allocated: both nets' weights, gradients, three Adams' moments, "
          f"activations)")
    medians = tuple(sorted(t[j] for t in times)[len(times) // 2] for j in range(6))
    return (step, fs, batch), medians


def phase_be_font_train(tmp: str, gpu: str) -> dict:
    """BE_font through the train_be_font CLI at 64 px, batch 32, full width:
    f32 for an epoch of 3 iterations, a resume for a second, bf16 for an
    epoch of 2 (FONT_PER_STEP launches an iteration), test_be_font on the
    resumed run dir (each run dir deleted once checked); then G's and D's
    parameter counts, the step's FLOPs and bound, and in f32 and bf16 timed
    steps with the host synthesis, the copy and the three phases apart, the
    peak memory and a profile of a step. Returns the median device step ms
    by dtype."""
    from vaeplay_torch.cli import test_be_font
    from vaeplay_torch.models.be_font import ComposeNet, Discriminator
    from vaeplay_torch.ops import attention

    run = _font_cli(tmp, "font_a", "float32", "--epoch", "1")
    _check_font_run(run, 0, "float32")
    resumed = _font_cli(tmp, "font_b", "float32", "--epoch", "2", "--resume", run)
    _check_font_run(resumed, 1, "float32")
    shutil.rmtree(os.path.join(tmp, "font_a"))
    _check_font_run(_font_cli(tmp, "font_c", "bfloat16", "--epoch", "1"), 0, "bfloat16")
    shutil.rmtree(os.path.join(tmp, "font_c"))
    before = attention.flash_attention.launches
    written = test_be_font.main(["--model_path", resumed, "--gpu", "0", "--img_size",
                                 str(FONT_IMG), "--batchsize", str(FONT_INFER_BATCH),
                                 "--res_output", os.path.join(tmp, "font_trained")])
    if (len(written) != 1 or not os.path.getsize(written[0])
            or attention.flash_attention.launches - before != FONT_PER_G_FORWARD):
        raise AssertionError(f"test_be_font on the trained run dir wrote {written}")
    print(f"[be_font-train] test_be_font --model_path <run dir> wrote {written}")
    shutil.rmtree(os.path.join(tmp, "font_b"))

    with torch.device("meta"):
        g, d = ComposeNet(FONT_IMG), Discriminator(FONT_IMG)
        counts = {"G": sum(p.numel() for p in g.parameters()),
                  "G's relay FCs": sum(p.numel() for p in g.relay_convs.parameters()),
                  "G's style encoder": sum(p.numel() for p in g.style_encoder.parameters()),
                  "D": sum(p.numel() for p in d.parameters())}
    print("[be_font-train] parameters: " + ", ".join(f"{k} {v / 1e6:.2f} M"
                                                     for k, v in counts.items()))
    if (round(counts["G"] / 1e4), round(counts["D"] / 1e4)) != (16737, 3762):
        raise AssertionError(f"parameter counts {counts}, not G 167.37 M and D 37.62 M")
    flops = font_flops(FONT_IMG)
    step_flops = sum(sum(flops[k]) for k in ("d_phase", "g_phase", "s_phase")) * FONT_TRAIN_BATCH
    relay = sum(flops["relay_fcs_in_step"]) * FONT_TRAIN_BATCH
    print(f"[be_font-train] GFLOP per image from the layer shapes (forward, backward): "
          + "; ".join(f"{k} {v[0] / 1e9:.3f}, {v[1] / 1e9:.3f}" for k, v in flops.items())
          + f"; step ({FONT_TRAIN_BATCH} images) {step_flops / 1e12:.3f} TFLOP, "
          f"{step_flops / (flops['g_label'][0] * FONT_TRAIN_BATCH):.2f} G-forward equivalents; "
          f"bound {step_flops / PEAK_TF32_FLOPS * 1e3:.3f} ms at {PEAK_TF32_FLOPS / 1e12:.0f} "
          f"TFLOP/s TF32, {step_flops / PEAK_BF16_FLOPS * 1e3:.3f} ms at "
          f"{PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s bf16 (dense tensor-core rates, 700 W); the relay "
          f"FCs' share, forward and both backward products, about {relay / step_flops:.1%}")
    medians = {}
    for dtype, peak, rate in (("float32", PEAK_TF32_FLOPS, "TF32"),
                              ("bfloat16", PEAK_BF16_FLOPS, "bf16")):
        profiled = None  # the previous state is freed before this peak is taken
        profiled, ms = _font_timed(dtype, gpu)
        medians[dtype] = ms[5]
        print(f"[be_font-train] {dtype} median: host synthesis {ms[0]:.2f} ms, copy {ms[1]:.2f} "
              f"ms, D phase {ms[2]:.2f} ms, G phase {ms[3]:.2f} ms, S phase {ms[4]:.2f} ms, "
              f"device step {ms[5]:.2f} ms ({FONT_TRAIN_BATCH / ms[5] * 1e3:.1f} images/s, "
              f"{step_flops / ms[5] / 1e9:.1f} TFLOP/s, {step_flops / peak * 1e3 / ms[5]:.1%} of "
              f"the {rate} bound); host synthesis / device step {ms[0] / ms[5]:.2f} on {gpu}")
        step, fs, batch = profiled
        _profile(lambda: step(fs, *batch), f"be_font-train {dtype}", runs=1)
        del step, fs, batch
    del profiled
    torch.cuda.empty_cache()
    return medians


def phase_be_font_parity() -> None:
    """One BE_font step at 64 px, batch 4, full width, gammas drawn, on the
    card and on the CPU from the same weights and noise batch (TF32 off),
    phase by phase: before each phase the card's FontState is loaded from
    the CPU's, so each phase starts from the same state on both. f32 (the
    kernel on the card: 30, 18 and 6 launches): each phase's losses, and
    the weights its optimizer stepped, within the bound plus Adam's slope
    lr / eps times the gradients' difference. f64 (the plain attention on
    both, the kernel taking no f64; no launch): each phase's losses and
    gradients."""
    import numpy as np

    from vaeplay_torch.models.be_font import Discriminator
    from vaeplay_torch.ops import attention
    from vaeplay_torch.train.state import FontState
    from vaeplay_torch.train.steps_be_font import make_be_font_train_step

    cfg = FONT_PARITY
    b, img, lr = cfg["batch"], cfg["img"], cfg["lr"]
    rng = np.random.default_rng(13)
    arrays = (rng.uniform(size=(b, 3, img, img)), rng.uniform(size=(b, 1, img, img)),
              rng.uniform(size=(b, 1, img, img)), rng.integers(0, 143, b),
              rng.normal(size=(b, 5)))
    g_base = random_font_model(11, img)
    d_base = Discriminator(img, generator=torch.Generator().manual_seed(12))
    _draw_gammas(d_base, torch.Generator().manual_seed(13))
    for dtype in (torch.float32, torch.float64):
        states, steps, batches = {}, {}, {}
        for key, dev in (("cpu", torch.device("cpu")), ("cuda", torch.device("cuda", 0))):
            fs = FontState.create(copy.deepcopy(g_base).to(dev, dtype).train(),
                                  copy.deepcopy(d_base).to(dev, dtype).train(), lr)
            states[key], steps[key] = fs, make_be_font_train_step(fs.g.model, fs.d.model)
            batches[key] = tuple(torch.as_tensor(a).to(dev, dtype) if a.dtype != np.int64
                                 else torch.as_tensor(a).to(dev) for a in arrays)
        for phase, launches, stepped in (("d_phase", 30, "d"), ("g_phase", 18, "g"),
                                         ("s_phase", 6, "style")):
            states["cuda"].load_state_dict(states["cpu"].state_dict())
            results = {}
            for dev in ("cpu", "cuda"):
                before = attention.flash_attention.launches
                with plain_attention() if dtype == torch.float64 else contextlib.nullcontext():
                    states[dev], m = getattr(steps[dev], phase)(states[dev], *batches[dev])
                launched = attention.flash_attention.launches - before
                want = launches if dev == "cuda" and dtype == torch.float32 else 0
                if launched != want:
                    raise AssertionError(f"{phase} {dtype} on {dev} launched the kernel "
                                         f"{launched} times, not {want}")
                model = getattr(states[dev], stepped).model
                results[dev] = ({k: v.cpu() for k, v in m.items()},
                                {f"{kind} {k}": (p.grad if kind == "grad" else p).detach().cpu()
                                 for k, p in model.named_parameters() for kind in ("grad", "weight")
                                 if p.grad is not None})
            _hold_step("be_font parity", f"{str(dtype)[6:]} {phase} ({stepped})", results["cpu"],
                       results["cuda"], dtype, lr)


# ---------------------------------------------------------------------------
# BP in bf16: phase 2's bf16 check at the training shape and phase 24


def _sdpa_backend(q4, k4, v4) -> str:
    """The backend scaled_dot_product_attention picks for these inputs."""
    try:
        from torch.nn.attention import SDPBackend

        choice = int(torch._fused_sdp_choice(q4, k4, v4, scale=1.0))
        return next((m.name for m in SDPBackend.__members__.values() if int(m.value) == choice),
                    str(choice))
    except (AttributeError, RuntimeError, TypeError) as e:
        return f"unknown ({type(e).__name__})"


def phase_kernels_bp_bf16(gpu: str) -> dict:
    """Phase 2 with bf16 operands: the bf16 kernel. At BP's training shape
    (B 8, N 2048, Dk 90, Dv 720, channel-major, as the 1x1 convolutions
    leave q, k and v under bf16 autocast) SpatialAttention's forward and
    gradients (bf16 output, bf16 gradients of the f32 recompute backward)
    against autograd through the plain version in f32 on the same values,
    and the plain backward's time. Then at each of BF16_SHAPES, in the
    model's layout: the kernel against the plain version of the same
    arithmetic (TOL[bf16]) and against the plain version in f32 on the same
    values (BF16_ATTENTION_TOL), its route and the bytes copied (none), and
    the times of the kernel, the plain version and the library call in
    bf16 (on position-major copies, with the backend it chose) beside the
    bf16 bound. Returns the kernels line's entry for the bf16 kernel: BP's
    shape first, then the bp_, bcp_, bcp_cap_, bc_ and be_font_ keys."""
    from vaeplay_torch.ops import attention

    shape = BP_BF16_SHAPE
    b, n, dk, dv = shape
    q, k, v = _qkv(shape, torch.bfloat16, seed=600, layout="c")
    g = _qkv(shape, torch.bfloat16, seed=1600, layout="c")[2]
    before = attention.flash_attention.routes["bfloat16/tma"]
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    out = attention.spatial_self_attention(qg, kg, vg)
    out.backward(g)
    qr, kr, vr = (t.detach().float().requires_grad_() for t in (q, k, v))
    ref = attention.reference_attention(qr, kr, vr)
    ref.backward(g.float())
    torch.cuda.synchronize()
    if (attention.flash_attention.routes["bfloat16/tma"] != before + 1
            or out.dtype != torch.bfloat16):
        raise AssertionError("the bf16 forward did not launch the bf16 kernel by the TMA route "
                             "once with a bf16 result")
    held = {"output": _worst(out.detach().float(), ref.detach(), BF16_ATTENTION_TOL)}
    for name, got, want in (("dq", qg.grad, qr.grad), ("dk", kg.grad, kr.grad),
                            ("dv", vg.grad, vr.grad)):
        if got.dtype != torch.bfloat16 or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{name} is {got.dtype} or not finite")
        held[name] = _worst(got.float(), want, BF16_ATTENTION_TOL)
    err = float((out.detach().float() - ref.detach()).abs().max())
    print(f"[kernels] BP bf16 shape B,N,Dk,Dv={shape}, the model's layout: output and dq, dk, dv "
          f"(bf16) against autograd of the plain version in f32: " + ", ".join(
              f"{k} at {v:.3f}" for k, v in held.items())
          + f" of the bound (atol {BF16_ATTENTION_TOL[0]:g} x max |ref| + rtol "
          f"{BF16_ATTENTION_TOL[1]:g} x |ref|); output max abs err {err:.3e}")
    if max(held.values()) > 1:
        raise AssertionError("the bf16 attention disagrees with the plain version in f32")
    bwd_ms = cuda_ms(lambda: attention.attention_backward(q, k, v, g), iters=10)

    entry = {"name": "flash_attention_fwd_bf16", "route": "cuda",
             "source": "vaeplay_torch/ops/csrc/flash_attention_bf16.cu",
             "replaces": "vaeplay_tpu/ops/attention.py:37", "engine": ENGINE_BF16,
             "launches": None, "launches_by_route": None}
    for i, (tag, shape, want) in enumerate(BF16_SHAPES):
        b, n, dk, dv = shape
        key = tag.lower().replace(" ", "_")
        q, k, v = _qkv(shape, torch.bfloat16, seed=700 + i, layout="c")
        counts = attention.flash_attention
        routes, copied = dict(counts.routes), counts.copied_bytes
        got = attention.spatial_self_attention(q, k, v)
        torch.cuda.synchronize()
        routes = {r: c - routes[r] for r, c in counts.routes.items() if c != routes[r]}
        copied = counts.copied_bytes - copied
        if routes != {f"bfloat16/{want}": 1} or copied or got.dtype != torch.bfloat16 or not (
                got.transpose(1, 2).is_contiguous()):
            raise AssertionError(f"{tag} bf16: routes {routes}, {copied} bytes copied, "
                                 f"{got.dtype} {got.stride()}; want bfloat16/{want}, none")
        ref = attention.reference_attention(q, k, v).float()
        ref32 = attention.reference_attention(q.float(), k.float(), v.float())
        atol, rtol = TOL[torch.bfloat16]
        diff = (got.float() - ref).abs()
        bad = int((diff > atol + rtol * ref.abs()).sum())
        max_err = float(diff.max())
        held32 = _worst(got.float(), ref32, BF16_ATTENTION_TOL)
        against_v = (f", {float((got.float() - v.float()).abs().max()):.3e} against v"
                     if n == 1 else "")
        print(f"[kernels] flash_attention_fwd_bf16 {tag} B,N,Dk,Dv={shape}, the model's layout, "
              f"{want} route, 0 bytes copied: against the plain version in bf16 max abs err "
              f"{max_err:.3e} (atol {atol:g}, rtol {rtol:g}), {bad} outside; against the plain "
              f"version in f32 at {held32:.3f} of the bound (atol {BF16_ATTENTION_TOL[0]:g} x "
              f"max |ref| + rtol {BF16_ATTENTION_TOL[1]:g} x |ref|){against_v}")
        if bad or held32 > 1 or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"the bf16 kernel disagrees with the plain version at {shape}")
        res = torch.empty(b, dv, n, dtype=torch.bfloat16, device="cuda").transpose(1, 2)
        iters = 200 if n == 1 else 20
        ms = cuda_ms(lambda: attention.flash_attention(q, k, v, out=res), iters=iters)
        plain_ms = cuda_ms(lambda: attention.reference_attention(q, k, v), iters=iters)
        # the library call on position-major copies of the same values
        q4, k4, v4 = (torch.empty(t.shape, dtype=t.dtype, device=t.device).copy_(t)[:, None]
                      for t in (q, k, v))
        backend = _sdpa_backend(q4, k4, v4)
        library_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q4, k4, v4, scale=1.0), iters=iters)
        bound_ms, bound_by, flops = _forward_bound(shape, torch.bfloat16)
        print(f"[kernels] flash_attention_fwd_bf16 {tag} B,N,Dk,Dv={shape}, the model's layout, "
              f"on {gpu}: kernel_ms {ms:.5f} ({want} route, 0 bytes copied), plain_ms "
              f"{plain_ms:.5f}, library_ms {library_ms:.5f} (scaled_dot_product_attention bf16, "
              f"position-major, backend {backend}), bound_ms {bound_ms:.6f} ({bound_by}: "
              f"{flops / 1e9:.4f} GFLOP at {PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s bf16, "
              f"{2 * (2 * b * n * (dk + dv)) / 1e6:.3f} MB at {PEAK_BYTES_PER_S / 1e12:.2f} TB/s), "
              f"{bound_ms / ms:.1%} of its bound, {flops / ms / 1e9:.1f} TFLOP/s"
              + (f"; per bf16 training iteration ({PER_ITERATION} of each) "
                 f"{PER_ITERATION * ms:.2f} ms forward, {PER_ITERATION * bwd_ms:.2f} ms plain "
                 f"backward (attention_backward_ms {bwd_ms:.4f})" if i == 0 else ""))
        if i == 0:
            entry.update(max_abs_err=max_err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, library_ms=library_ms, backward_ms=bwd_ms)
        entry.update({f"{key}_shape": list(shape), f"{key}_route": want,
                      f"{key}_max_abs_err": max_err, f"{key}_ms": ms, f"{key}_plain_ms": plain_ms,
                      f"{key}_bound_ms": bound_ms, f"{key}_bound_by": bound_by,
                      f"{key}_library_ms": library_ms, f"{key}_sdpa_backend": backend})
    return entry


def phase_bp_bf16_train(tmp: str, gpu: str, f32_ms: list) -> tuple:
    """BP training in bf16 through the train_bp CLI at 512 px, batch 8, the
    full pyramid: an epoch of BP_BF16_ITERATIONS iterations (PER_ITERATION
    launches each), test_bp on the run dir; then a warm-up and three timed
    bf16 iterations beside phase 5's f32 ones (f32_ms), the peak memory and
    a profile; then one iteration in bf16 and one in f32 on the card from
    the same weights and batch, their seven losses within BF16_BUDGET and
    not all equal (a bf16 request that ran in f32 would match exactly).
    Returns the forward kernel's launches over the phase's bf16 runs, their
    counts by route and the backward kernel's launches over the same runs;
    the f32 comparison iteration's are not counted."""
    from vaeplay_torch.cli import test_bp, train_bp
    from vaeplay_torch.data.bp_data import SyntheticEmitDataset
    from vaeplay_torch.ops import attention
    from vaeplay_torch.train.state import TrainState
    from vaeplay_torch.train.steps_bp import make_bp_train_step

    attention.reset_counts()
    t0 = time.perf_counter()
    run = train_bp.main(["--gpu", "0", "--img_size", str(IMG), "--batchsize", str(TRAIN_BATCH),
                         "--iterations", str(BP_BF16_ITERATIONS), "--viz_freq",
                         str(BP_BF16_ITERATIONS), "--epoch", "1", "--dtype", "bfloat16",
                         "--res_output", os.path.join(tmp, "bf16_results"),
                         "--model_output", os.path.join(tmp, "bf16_run")])
    print(f"[bp_bf16-train] CLI run --dtype bfloat16 (init, {BP_BF16_ITERATIONS} iterations, "
          f"checkpoint) {time.perf_counter() - t0:.2f} s: {run}")
    _check_run(run, 0, attention.flash_attention.launches, BP_BF16_ITERATIONS,
               BP_BF16_ITERATIONS, "bp_bf16-train")
    before = attention.flash_attention.launches
    written = test_bp.main(["--model_path", run, "--gpu", "0", "--img_size", str(IMG),
                            "--batchsize", "4", "--res_output", os.path.join(tmp, "bf16_test")])
    if attention.flash_attention.launches - before != PER_FORWARD or not written or not all(
            p.endswith(".png") and os.path.getsize(p) > 0 for p in written):
        raise AssertionError(f"test_bp on the bf16 run dir wrote {written}")
    print(f"[bp_bf16-train] test_bp --model_path <bf16 run dir> wrote {written}")
    shutil.rmtree(os.path.join(tmp, "bf16_run"))

    bf16_ms = _timed_iterations(gpu, "bfloat16", "bp_bf16-train")
    med = lambda xs: sorted(xs)[len(xs) // 2]
    print(f"[bp_bf16-train] median iteration: bf16 {med(bf16_ms):.2f} ms, f32 (phase 5) "
          f"{med(f32_ms):.2f} ms, bf16 / f32 {med(bf16_ms) / med(f32_ms):.3f} on {gpu}")

    dev = torch.device("cuda", 0)
    batch = train_bp.to_device(SyntheticEmitDataset(img_size=IMG).sample_batch(
        TRAIN_BATCH, batch_seed=11), dev)
    losses, launches = {}, None
    for dtype in (torch.bfloat16, torch.float32):
        model = random_model(5).to(dev)
        _, m = make_bp_train_step(model, dtype)(TrainState.create(model, 1e-3), *batch)
        losses[dtype] = {k: float(v) for k, v in m.items()}
        del model
        if launches is None:  # the bf16 runs end here
            launches = (attention.flash_attention.launches, dict(attention.flash_attention.routes),
                        attention.flash_attention_backward.launches)
    rel, absolute = BF16_BUDGET
    worst, name = max((abs(losses[torch.bfloat16][k] - v) / (rel * abs(v) + absolute), k)
                      for k, v in losses[torch.float32].items())
    print(f"[bp_bf16-train] one iteration bf16 vs f32 from the same weights and batch: " + " ".join(
        f"{k}={losses[torch.bfloat16][k]:.5f}/{v:.5f}" for k, v in losses[torch.float32].items())
        + f"; worst {name} at {worst:.3f} of the budget ({rel:.0%} + {absolute:g})")
    if worst > 1 or not all(math.isfinite(v) for v in losses[torch.bfloat16].values()):
        raise AssertionError("the card's bf16 BP iteration is outside the bf16 budget")
    if losses[torch.bfloat16] == losses[torch.float32]:
        raise AssertionError("the bf16 BP iteration's losses equal the f32 one's: it ran in f32")
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# Style_GAN: phases 25-26


def style_gan_flops(img: int, z: int, batch: int, split=None) -> dict:
    """FLOPs (multiply-adds x 2) of one Style_GAN step at `batch`, by part,
    {part: (forward, backward)}, from the layer shapes: every Conv2d,
    ConvTranspose2d and Linear, counted by hooks on the meta device, blended
    or at `split` on a batch sorted half and half. "eg_phase" is the E/G
    phase (G's x_gen forward; E, G's x_rec forward and D twice with E's and
    G's gradients, D frozen), "latent_g" the latent loss (E forward, its
    input gradient) and the x_gen branch's backward, "d_phase" D twice with
    its gradients; "fc_out" is mlp.model.2's share of the step. A layer's
    backward costs its forward once for the weight gradient, if it is taken,
    and once for the input gradient, if its input needs one."""
    from vaeplay_torch.models.style_gan import Discriminator, Generator, StyleEncoder

    with torch.device("meta"):
        e, g, d = StyleEncoder(z, img), Generator(img, z), Discriminator(img)
    out = {k: [0, 0] for k in ("eg_phase", "latent_g", "d_phase", "fc_out")}
    part, fc_out = {"fwd": "eg_phase", "bwd": "eg_phase"}, g.mlp.model[2].fc[0]

    def hook(m, inputs, y):
        x = inputs[0]
        if isinstance(m, torch.nn.Linear):
            f = 2 * y.numel() * m.in_features
        else:
            f = 2 * y.numel() * (m.in_channels // m.groups) * math.prod(m.kernel_size)
            if isinstance(m, torch.nn.ConvTranspose2d):  # its products run over the input map
                f = 2 * x.numel() * m.out_channels * math.prod(m.kernel_size)
        bwd = f * (int(m.weight.requires_grad) + int(x.requires_grad)) if (
            torch.is_grad_enabled()) else 0
        out[part["fwd"]][0] += f
        out[part["bwd"]][1] += bwd
        if m is fc_out:
            out["fc_out"][0] += f
            out["fc_out"][1] += bwd

    for m in list(e.modules()) + list(g.modules()) + list(d.modules()):
        if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d, torch.nn.Linear)):
            m.register_forward_hook(hook)
    x = torch.zeros(batch, 3, img, img, device="meta")
    zs = torch.zeros(batch, z, device="meta")
    labels = torch.zeros(batch, dtype=torch.int64, device="meta")
    part["bwd"] = "latent_g"
    x_gen = g(x, zs, labels, split)
    part["bwd"] = "eg_phase"
    d.requires_grad_(False)
    mu, _ = e(x)
    x_rec = g(x, mu, labels, split)
    d(x_rec, x)
    d(x_gen.detach().requires_grad_(), x)
    part["fwd"] = part["bwd"] = "latent_g"
    e.requires_grad_(False)
    e(x_gen.detach().requires_grad_())
    part["fwd"] = part["bwd"] = "d_phase"
    d.requires_grad_(True)
    d(x, x)
    d(x_rec.detach(), x)
    return {k: tuple(v) for k, v in out.items()}


def _check_sg_run(run: str, epoch: int, label: str) -> None:
    """A train_style_gan run dir of one epoch: its checkpoint and one log
    line of the seven averaged losses, finite."""
    from vaeplay_torch.train.steps_style_gan import AVG_KEYS

    if sorted(os.listdir(run)) != [f"{epoch}.ckpt", "metrics.jsonl", "record.txt"]:
        raise AssertionError(f"run dir {run} holds {sorted(os.listdir(run))}")
    with open(os.path.join(run, "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    if [r["epoch"] for r in lines] != [epoch] or not all(
            math.isfinite(r[k]) for r in lines for k in AVG_KEYS):
        raise AssertionError(f"logged losses of epoch {epoch}: {lines}")
    r = lines[0]
    print(f"[style_gan-train] {label} epoch {epoch}: " + " ".join(f"{k}={r[k]:.4f}"
                                                              for k in AVG_KEYS)
          + f" ({r['images_per_sec']:.1f} img/s over the epoch, CLI's host clock); checkpoint "
          f"{os.path.getsize(os.path.join(run, f'{epoch}.ckpt')) / 2**30:.2f} GiB")


def _sg_cli(tmp: str, name: str, dtype: str, *extra) -> str:
    """train_style_gan at 256 px, z 512, batch 32, in `dtype`; it must not
    launch the attention kernel."""
    from vaeplay_torch.cli import train_style_gan
    from vaeplay_torch.ops import attention

    before = attention.flash_attention.launches
    t0 = time.perf_counter()
    run = train_style_gan.main(["--gpu", "0", "--img_size", str(SG_IMG), "--z_dim", str(SG_Z),
                                "--batchsize", str(SG_BATCH), "--iterations",
                                str(SG_ITERATIONS), "--viz_freq", str(SG_ITERATIONS),
                                "--dtype", dtype, "--res_output", os.path.join(tmp, "sg_results"),
                                "--model_output", os.path.join(tmp, name), *extra])
    launches = attention.flash_attention.launches - before
    print(f"[style_gan-train] CLI run {dtype} {' '.join(extra)} (init, {SG_ITERATIONS} "
          f"iterations, checkpoint) {time.perf_counter() - t0:.2f} s, {launches} kernel "
          f"launches: {run}")
    if launches:
        raise AssertionError(f"train_style_gan launched the attention kernel {launches} times")
    return run


def _sg_timed(ss, dtype: str, split, gpu: str) -> tuple:
    """A warm-up and SG_TIMED recorded-noise steps of
    make_style_gan_train_step on the StyleGanState `ss` in `dtype`, blended
    (split None) or at `split`, on bubble batches with SG_BATCH // 2 rows of
    each label, sorted: the E/G phase, the latent loss with G's step, and
    the D phase timed apart on the host clock (each ending in a
    synchronize); the peak device memory. Returns (step, batch) for a
    profile and the median (E/G, latent+G, D, step) ms."""
    import numpy as np

    from vaeplay_torch.cli.train_style_gan import Bucketing, render_batch
    from vaeplay_torch.data.be_data import sample_bubble_params
    from vaeplay_torch.train.steps_style_gan import make_style_gan_train_step
    from vaeplay_torch.utils.amp import resolve_dtype

    dev = torch.device("cuda", 0)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    step = make_style_gan_train_step(ss.e.model, ss.g.model, ss.d.model, SG_Z,
                                     resolve_dtype(dtype))
    labels = np.repeat([0, 1], SG_BATCH // 2)
    noise = torch.Generator(device=dev).manual_seed(3)
    label = f"{dtype} {'blended' if split is None else f'split {split}'}"
    times = []
    for i in range(SG_TIMED + 1):
        params, _ = sample_bubble_params(SG_IMG, SG_BATCH, batch_seed=i)
        xt, xc, lab, _ = render_batch(params, labels, Bucketing(False, 2, SG_BATCH), SG_IMG, dev)
        eps, z = (torch.randn((SG_BATCH, SG_Z), generator=noise, device=dev) for _ in range(2))
        torch.cuda.synchronize()
        t = [time.perf_counter()]
        ss, branch, m = step.eg_phase(ss, xt, xc, lab, eps, z, split)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        ss, lm = step.latent_g_phase(ss, branch, z)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        ss, dm = step.d_phase(ss, xt, xc, lab, branch[2])
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        del branch
        metrics = {**m, **lm, **dm}
        if not all(bool(torch.isfinite(v)) for v in metrics.values()):
            raise AssertionError(f"non-finite losses: {metrics}")
        ms = tuple((t[j + 1] - t[j]) * 1e3 for j in range(3)) + ((t[3] - t[0]) * 1e3,)
        if i:
            times.append(ms)
        print(f"[style_gan-train] {label} step {i}{' (warm-up)' if i == 0 else ''}: E/G phase "
              f"{ms[0]:.2f} ms, latent+G {ms[1]:.2f} ms, D phase {ms[2]:.2f} ms, step "
              f"{ms[3]:.2f} ms, {SG_BATCH / ms[3] * 1e3:.1f} images/s (PyTorch defaults; batch "
              f"{SG_BATCH}, {SG_IMG} px, z {SG_Z}, host clock) on {gpu}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[style_gan-train] {label} peak device memory {peak:.2f} GiB (torch.cuda."
          f"max_memory_allocated: three nets' weights, gradients, three Adams' moments, "
          f"activations)")
    medians = tuple(sorted(t[j] for t in times)[len(times) // 2] for j in range(4))
    return (step, (xt, xc, lab, eps, z)), medians


def _sg_parts(dtype: str, gpu: str) -> dict:
    """CUDA-event ms, forward and backward at batch 32 in `dtype`, of parts
    of G that the profile's kernel groups do not separate: its MLP (fc_out's
    1.48 GB weight read by the forward and both backward products, and
    under bf16 autocast cast once a forward), fc_out alone, and the
    full-resolution 32-channel convolutions (conv1 and conv2, blended, and
    the head's three ConvBlocks), each on inputs that need a gradient, as
    in the step. A G forward of the step runs each part once."""
    from vaeplay_torch.models.style_gan import Generator
    from vaeplay_torch.utils.amp import autocast, resolve_dtype

    dev, cdtype = torch.device("cuda", 0), resolve_dtype(dtype)
    g = Generator(SG_IMG, SG_Z, generator=torch.Generator().manual_seed(1)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    z = torch.randn(SG_BATCH, SG_Z, generator=gen, device=dev, requires_grad=True)
    h = torch.randn(SG_BATCH, g.mlp.model[2].fc[0].in_features, generator=gen, device=dev,
                    requires_grad=True)
    x = torch.randn(SG_BATCH, 4, SG_IMG, SG_IMG, generator=gen, device=dev, requires_grad=True)
    y = torch.randn(SG_BATCH, 32, SG_IMG, SG_IMG, generator=gen, device=dev, requires_grad=True)
    labels = torch.arange(SG_BATCH, device=dev) % 2

    def fwd_bwd(fn):
        def run():
            with autocast(dev, cdtype):
                out = fn()
            out.float().sum().backward()
        return run

    parts = {"G's MLP": fwd_bwd(lambda: g.mlp(z)),
             "fc_out": fwd_bwd(lambda: g.mlp.model[2](h)),
             "full-resolution convolutions": fwd_bwd(
                 lambda: g.conv2(g.conv1(x, labels), labels).sum() + g.final[1:](y).sum())}
    out = {k: cuda_ms(fn, iters=5) for k, fn in parts.items()}
    print(f"[style_gan-train] {dtype} parts of a G forward and backward at batch {SG_BATCH} "
          f"(CUDA events, on {gpu}): " + ", ".join(f"{k} {v:.2f} ms" for k, v in out.items()))
    del g
    torch.cuda.empty_cache()
    return out


def phase_style_gan_train(tmp: str, gpu: str) -> dict:
    """Style_GAN through the train_style_gan CLI at 256 px, z 512, batch 32:
    f32 for an epoch of SG_ITERATIONS iterations, a resume of it with
    --scan_steps 2 for a second, bf16 for an epoch (each run dir deleted
    once checked: a checkpoint is about 5.2 GB); no attention launch. Then
    E's, G's and D's parameter counts, the step's FLOPs and bound, and in f32
    and bf16, blended and at SG_SPLIT, timed steps with the E/G, latent+G
    and D phases apart, the peak memory, a profile of the blended step in
    each dtype, and G's MLP and full-resolution convolutions timed apart
    (_sg_parts). Returns the median step ms by (dtype, form)."""
    from vaeplay_torch.cli.train_style_gan import build_state
    from vaeplay_torch.models.style_gan import Discriminator, Generator, StyleEncoder

    run = _sg_cli(tmp, "sg_a", "float32", "--epochs", "1")
    _check_sg_run(run, 0, "float32")
    resumed = _sg_cli(tmp, "sg_b", "float32", "--epochs", "2", "--resume", run,
                      "--scan_steps", "2")
    shutil.rmtree(os.path.join(tmp, "sg_a"))
    _check_sg_run(resumed, 1, "float32 resumed, --scan_steps 2")
    shutil.rmtree(os.path.join(tmp, "sg_b"))
    _check_sg_run(_sg_cli(tmp, "sg_c", "bfloat16", "--epochs", "1"), 0, "bfloat16")
    shutil.rmtree(os.path.join(tmp, "sg_c"))

    with torch.device("meta"):  # the JAX init's counts are at 256 px, z 512
        nets = {"E": StyleEncoder(512, 256), "G": Generator(256, 512), "D": Discriminator(256)}
        counts = {k: sum(p.numel() for p in m.parameters()) for k, m in nets.items()}
        counts["G's mlp.model.2"] = sum(p.numel() for p in nets["G"].mlp.model[2].parameters())
    print("[style_gan-train] parameters: " + ", ".join(f"{k} {v / 1e6:.2f} M"
                                                       for k, v in counts.items()))
    if (round(counts["E"] / 1e4), round(counts["G"] / 1e4), round(counts["D"] / 1e4)) != (
            4507, 37998, 392):
        raise AssertionError(f"parameter counts {counts}, not E 45.07 M, G 379.98 M, D 3.92 M")
    step_flops = {}
    for split in (None, SG_SPLIT):
        flops = style_gan_flops(SG_IMG, SG_Z, SG_BATCH, split)
        total = sum(sum(flops[k]) for k in ("eg_phase", "latent_g", "d_phase"))
        step_flops[split] = total
        print(f"[style_gan-train] {'blended' if split is None else f'split {split}'} step "
              f"(batch {SG_BATCH}) TFLOP from the layer shapes (forward, backward): " + "; ".join(
                  f"{k} {v[0] / 1e12:.3f}, {v[1] / 1e12:.3f}" for k, v in flops.items())
              + f"; step {total / 1e12:.3f} TFLOP, bound {total / PEAK_TF32_FLOPS * 1e3:.2f} ms "
              f"at {PEAK_TF32_FLOPS / 1e12:.0f} TFLOP/s TF32, {total / PEAK_BF16_FLOPS * 1e3:.2f} "
              f"ms at {PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s bf16 (dense tensor-core rates, 700 W); "
              f"fc_out's share {sum(flops['fc_out']) / total:.2%}")
    weights, fc_out = counts["E"] + counts["G"] + counts["D"], counts["G's mlp.model.2"]
    print(f"[style_gan-train] bytes: {weights / 1e6:.1f} M f32 weights; the three Adams read "
          f"and write weights, gradients and two moments, {weights * 4 * 7 / 1e9:.2f} GB a step, "
          f"{weights * 4 * 7 / PEAK_BYTES_PER_S * 1e3:.2f} ms at "
          f"{PEAK_BYTES_PER_S / 1e12:.2f} TB/s; fc_out's f32 weight {fc_out * 4 / 1e9:.2f} GB, "
          f"cast to bf16 at every G forward under autocast")
    medians = {}
    # one seeded state (three nets and their Adams) goes on training through
    # the four timed configurations
    ss = build_state(SG_IMG, SG_Z, 2, 1e-4, 0, torch.device("cuda", 0))
    for dtype, peak, rate in (("float32", PEAK_TF32_FLOPS, "TF32"),
                              ("bfloat16", PEAK_BF16_FLOPS, "bf16")):
        for split in (None, SG_SPLIT):
            profiled, ms = _sg_timed(ss, dtype, split, gpu)
            form = "blended" if split is None else f"split {split}"
            medians[(dtype, form)] = ms[3]
            print(f"[style_gan-train] {dtype} {form} median: E/G phase {ms[0]:.2f} ms, latent+G "
                  f"{ms[1]:.2f} ms, D phase {ms[2]:.2f} ms, step {ms[3]:.2f} ms "
                  f"({SG_BATCH / ms[3] * 1e3:.1f} images/s, {step_flops[split] / ms[3] / 1e9:.1f} "
                  f"TFLOP/s, {step_flops[split] / peak * 1e3 / ms[3]:.1%} of the {rate} bound) "
                  f"on {gpu}")
            if split is None:
                step, batch = profiled
                _profile(lambda: step.recorded(ss, *batch), f"style_gan-train {dtype}", runs=1)
            del profiled
    del ss
    torch.cuda.empty_cache()
    for dtype in ("float32", "bfloat16"):
        blended = medians[(dtype, "blended")]
        parts = _sg_parts(dtype, gpu)
        print(f"[style_gan-train] {dtype} split {SG_SPLIT} / blended step: "
              f"{medians[(dtype, f'split {SG_SPLIT}')] / blended:.3f}; two G forwards and "
              f"backwards of each part over the blended step: " + ", ".join(
                  f"{k} {2 * v / blended:.1%}" for k, v in parts.items()))
    return medians


def phase_style_gan_parity() -> None:
    """One Style_GAN step at 64 px, z 512, batch 4 (two rows of each label,
    sorted), full width, blended (and in f32 also at the (2, 2) split), on
    the card and on the CPU from the same seeded weights, noise batch and recorded noise
    (TF32 off), phase by phase: before the E/G phase both states are equal,
    before the latent+G phase the card's E is loaded from the CPU's (G's
    weights are in the x_gen branch's graph and stay), before the D phase
    the card's D. f32: each phase's losses, and the weights its Adam
    stepped, within the bound plus Adam's slope lr / eps times the
    gradients' difference. f64: each phase's losses and the gradients of
    the net it steps (G's: the E/G phase's plus the x_gen branch's);
    StyleUp's transposed-conv biases (a true gradient of 0 before the
    instance norm) to their layer's weight gradient's bound."""
    import numpy as np

    from vaeplay_torch.models.style_gan import Discriminator, Generator, StyleEncoder
    from vaeplay_torch.train.state import StyleGanState
    from vaeplay_torch.train.steps_style_gan import make_style_gan_train_step

    cfg = SG_PARITY
    b, img, z, lr = cfg["batch"], cfg["img"], cfg["z"], cfg["lr"]
    rng = np.random.default_rng(17)
    arrays = (rng.uniform(size=(b, 3, img, img)), rng.uniform(size=(b, 3, img, img)),
              np.repeat([0, 1], b // 2), rng.normal(size=(b, z)), rng.normal(size=(b, z)))
    base = (StyleEncoder(z, img, generator=torch.Generator().manual_seed(20)),
            Generator(img, z, generator=torch.Generator().manual_seed(21)),
            Discriminator(img, generator=torch.Generator().manual_seed(22)))
    with torch.no_grad():  # every bias drawn (they start at 0)
        gen = torch.Generator().manual_seed(23)
        for m in base:
            for name, p in m.named_parameters():
                if name.endswith(".bias"):
                    p.copy_((torch.rand(p.shape, generator=gen) - 0.5) * 0.4)
    for dtype, splits in ((torch.float32, (None, (b // 2, b // 2))), (torch.float64, (None,))):
        for split in splits:
            states, steps, batches, branches = {}, {}, {}, {}
            for key, dev in (("cpu", torch.device("cpu")), ("cuda", torch.device("cuda", 0))):
                nets = [copy.deepcopy(m).to(dev, dtype).train() for m in base]
                states[key] = StyleGanState.create(*nets, lr)
                steps[key] = make_style_gan_train_step(*nets, z)
                batches[key] = tuple(torch.as_tensor(a).to(dev) if a.dtype == np.int64
                                     else torch.as_tensor(a).to(dev, dtype) for a in arrays)
            for phase, stepped, reload in (("eg_phase", "e", None), ("latent_g_phase", "g", "e"),
                                           ("d_phase", "d", "d")):
                if reload:
                    getattr(states["cuda"], reload).load_state_dict(
                        getattr(states["cpu"], reload).state_dict())
                results = {}
                for dev in ("cpu", "cuda"):
                    xt, xc, lab, eps, zs = batches[dev]
                    fn = getattr(steps[dev], phase)
                    if phase == "eg_phase":
                        states[dev], branches[dev], m = fn(states[dev], xt, xc, lab, eps, zs, split)
                    elif phase == "latent_g_phase":
                        states[dev], m = fn(states[dev], branches[dev], zs)
                    else:
                        states[dev], m = fn(states[dev], xt, xc, lab, branches[dev][2])
                    model = getattr(states[dev], stepped).model
                    results[dev] = ({k: v.cpu() for k, v in m.items()},
                                    {f"{kind} {k}": (p.grad if kind == "grad" else p).detach().cpu()
                                     for k, p in model.named_parameters()
                                     for kind in ("grad", "weight")})
                form = "blended" if split is None else f"split {split}"
                _hold_step("style_gan parity", f"{str(dtype)[6:]} {form} {phase} ({stepped})",
                           results["cpu"], results["cuda"], dtype, lr,
                           lambda k: (k.replace(".bias", ".weight")
                                      if k.endswith("up_convs.0.bias") else k))


def phase_kernels_bcp_cap(gpu: str) -> dict:
    """Phase 2 at BCP's 4096-point cap (B 16, N 4096, Dk 32, Dv 260): the
    kernel against the plain version in both layouts, f32; the Function's
    gradients in both layouts; the plain backward's time and its peak memory
    above its inputs (its N x N f32 buffers are 1 GiB each); the kernel,
    plain and library times. Returns the kernel line's bcp4096_* keys. Phase
    29's ring is held at the same shape."""
    from vaeplay_torch.ops import attention

    out = {}
    for layout in ("n", "c"):
        e = _check_case(BCP_CAP, torch.float32, layout, 1.0, seed=450)
        if layout == "c":
            out["bcp4096_max_abs_err"] = e
    for layout in ("c", "n"):
        _grad_check(BCP_CAP, layout, 1.0, seed=460)
    ms, plain_ms, library_ms = _forward_times(BCP_CAP, "c")
    bound_ms, bound_by, flops = _forward_bound(BCP_CAP)
    q, k, v = _qkv(BCP_CAP, torch.float32, seed=0, layout="c")
    g = _qkv(BCP_CAP, torch.float32, seed=1000, layout="c")[2]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    attention.attention_backward(q, k, v, g)
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    bwd_ms = cuda_ms(lambda: attention.attention_backward(q, k, v, g), iters=5)
    print(f"[kernels] BCP cap B,N,Dk,Dv={BCP_CAP} f32, channel-major, on {gpu}: kernel_ms "
          f"{ms:.4f}, plain_ms {plain_ms:.4f}, library_ms {library_ms:.4f}, bound_ms "
          f"{bound_ms:.4f} ({bound_by}: {TF32_PASSES} x {flops / 1e9:.2f} GFLOP at "
          f"{PEAK_TF32_FLOPS / 1e12:.0f} TFLOP/s TF32), {bound_ms / ms:.1%} of its bound; "
          f"attention_backward_ms {bwd_ms:.4f}, its peak memory {peak:.2f} GiB above its inputs")
    out.update(bcp4096_shape=list(BCP_CAP), bcp4096_ms=ms, bcp4096_plain_ms=plain_ms,
               bcp4096_bound_ms=bound_ms, bcp4096_bound_by=bound_by,
               bcp4096_library_ms=library_ms, bcp4096_backward_ms=bwd_ms,
               bcp4096_backward_peak_gib=peak)
    return out


def _bc_bridge_batches(n: int, batch: int, seed: int, dev) -> list:
    from vaeplay_torch.cli.train_bc import device_batch
    from vaeplay_torch.data.bc_data import SyntheticBCDataset

    ds = SyntheticBCDataset(img_size=BC_IMG, max_points=BC_POINTS, data_size=n * batch,
                            seed=seed)
    return [device_batch(b, dev) for b in ds.epoch_batches(batch)]


def _bc_bridge_epoch_ms(state, astep, batches, bridge, overlap) -> float:
    """Host ms a step of one run_epoch over `batches` (bridge None: the
    in-forward trace), from dispatch to the last step's synchronize."""
    from vaeplay_torch.cli.train_bc import run_epoch

    torch.cuda.synchronize()
    t = time.perf_counter()
    state, acc, cnt = run_epoch(astep, state, batches, bridge, overlap)
    torch.cuda.synchronize()
    if cnt != len(batches) or not all(math.isfinite(float(v)) for v in acc.values()):
        raise AssertionError(f"an epoch of {len(batches)} steps logged {cnt}: {acc}")
    return (time.perf_counter() - t) * 1e3 / len(batches)


def phase_bc_bridge(gpu: str) -> int:
    """BC's two-program bridge at 256 px, batch 32, 256 points, full width,
    f32 (TF32 off for the first part): one sync step at stride 1 and one
    in-forward step from the same state and batch (identical contours; the
    losses and every buffer and updated weight within BE_PARITY_TOL's f32
    bound, Adam's slope on the weights); then epochs of BRIDGE_EPOCH steps
    in sync and overlap at stride 4 (finite losses, no launch in a mask
    step, BC_PER_FORWARD in each train step) and the host ms a step (median
    of BRIDGE_TIMED epochs of BRIDGE_STEPS after a warm-up) of the
    in-forward path, sync and overlap, with the share of the trace the
    caller does not wait for; then
    pipeline_bc_batches over 4 batches of 8 in eval mode against the
    sequential loop of the same three stages (equal outputs) and both
    times. Returns the kernel launches of the epochs and steps."""
    import numpy as np

    from vaeplay_torch.eval.serve import pipeline_bc_batches
    from vaeplay_torch.ops import attention
    from vaeplay_torch.train.metrics import accumulating
    from vaeplay_torch.train.state import frozen_backbone_adam, running_stats_untouched
    from vaeplay_torch.train.steps_bc import (METRIC_KEYS, BridgeTracer, make_bc_mask_step,
                                              make_bc_train_step)

    dev = torch.device("cuda", 0)
    torch.cuda.empty_cache()
    launches = attention.flash_attention.launches
    base = random_bc_model(11).to(dev).train()
    batch = _bc_bridge_batches(1, BC_TRAIN_BATCH, 5, dev)[0]
    with strict_f32():
        twin = copy.deepcopy(base)
        s_fwd = frozen_backbone_adam(base, 1e-4)
        with torch.no_grad(), running_stats_untouched(base):
            traced = base(batch[0])
        _, m_fwd = make_bc_train_step(base)(s_fwd, *batch)
        s_br = frozen_backbone_adam(twin, 1e-4)
        tracer = BridgeTracer(BC_IMG, 1, BC_POINTS)
        before = attention.flash_attention.launches
        packed = make_bc_mask_step(twin, 1)(s_br, batch[0])
        pts, counts = tracer.submit(packed).result()
        if attention.flash_attention.launches != before:
            raise AssertionError("the mask step launched the attention kernel")
        _, m_br = make_bc_train_step(twin)(s_br, *batch, (torch.from_numpy(pts).to(dev),
                                                          torch.from_numpy(counts).to(dev)))
        same = (np.array_equal(pts, traced["contours"].cpu().numpy())
                and np.array_equal(counts, traced["contour_counts"].cpu().numpy()))
        print(f"[bc-bridge] sync stride 1 vs in-forward, f32: contours "
              f"{'identical' if same else 'DIFFER'} (counts {counts.tolist()[:8]}...)")
        if not same:
            raise AssertionError("the bridge's contours differ from the in-forward trace's")
        ref_t = {f"weight {k}": p.detach() for k, p in base.named_parameters()}
        ref_t.update({f"grad {k}": p.grad for k, p in base.named_parameters()
                      if p.grad is not None})
        got_t = {f"weight {k}": p.detach() for k, p in twin.named_parameters()}
        got_t.update({f"grad {k}": p.grad for k, p in twin.named_parameters()
                      if p.grad is not None})
        ref_t = {k: v for k, v in ref_t.items() if k.startswith("grad") or
                 "grad" + k[len("weight"):] in ref_t}
        got_t = {k: got_t[k] for k in ref_t}
        for k, t in base.named_buffers():
            if t.is_floating_point():
                ref_t[f"buffer {k}"], got_t[f"buffer {k}"] = t, dict(twin.named_buffers())[k]
        _hold_step("bc-bridge", "sync stride-1 step vs the in-forward step", (m_fwd, ref_t),
                   (m_br, got_t), torch.float32, 1e-4)
        worst_buf = max(_worst(got_t[k], ref_t[k], BE_PARITY_TOL[torch.float32])
                        for k in ref_t if k.startswith("buffer"))
        if worst_buf > 1:
            raise AssertionError(f"the bridge step's BatchNorm buffers differ ({worst_buf:.2e})")
        del twin, s_br, s_fwd, traced, ref_t, got_t
    state = frozen_backbone_adam(base, 1e-4)
    astep = accumulating(make_bc_train_step(base))
    bridge = (make_bc_mask_step(base, 4), BridgeTracer(BC_IMG, 4, BC_POINTS))
    for mode in ("sync", "overlap"):
        before = attention.flash_attention.launches
        ms = _bc_bridge_epoch_ms(state, astep, _bc_bridge_batches(BRIDGE_EPOCH, BC_TRAIN_BATCH,
                                                                  6, dev),
                                 bridge, mode == "overlap")
        n = attention.flash_attention.launches - before
        print(f"[bc-bridge] {mode} epoch of {BRIDGE_EPOCH} at stride 4: finite losses, {n} kernel "
              f"launches, {ms:.2f} ms a step (host clock, first epoch)")
        if n != BC_PER_FORWARD * BRIDGE_EPOCH:
            raise AssertionError(f"{mode}: {n} launches in {BRIDGE_EPOCH} steps")
    host = _bc_bridge_batches(BRIDGE_STEPS + 1, BC_TRAIN_BATCH, 7, dev)
    waits = []

    class Waited:  # the tracer, the caller's wait on each trace's result timed
        def submit(self, packed):
            fut = bridge[1].submit(packed)
            result = fut.result

            def timed():
                t = time.perf_counter()
                out = result()
                waits.append(time.perf_counter() - t)
                return out

            fut.result = timed
            return fut

    times, hidden = {}, {}
    for mode, br, overlap in (("in-forward", None, False), ("sync", bridge, False),
                              ("overlap", bridge, True)):
        timed_br = None if br is None else (br[0], Waited())
        _bc_bridge_epoch_ms(state, astep, host[:2], timed_br, overlap)  # warm-up
        runs = []
        for _ in range(BRIDGE_TIMED):
            waits.clear()
            traced = bridge[1].trace_seconds
            runs.append(_bc_bridge_epoch_ms(state, astep, host[1:], timed_br, overlap))
            if br is not None:  # the share of the trace the caller did not wait for
                hidden.setdefault(mode, []).append(
                    1 - sum(waits) / (bridge[1].trace_seconds - traced))
        times[mode] = sorted(runs)[len(runs) // 2]
    packed = bridge[0](state, host[0][0])
    trace_ms = []
    for _ in range(BRIDGE_TIMED):
        t = time.perf_counter()
        bridge[1].trace(packed)
        trace_ms.append((time.perf_counter() - t) * 1e3)
    tr = sorted(trace_ms)[len(trace_ms) // 2]
    med = {m: sorted(v)[len(v) // 2] for m, v in hidden.items()}
    print(f"[bc-bridge] host ms a step, median of {BRIDGE_TIMED} epochs of {BRIDGE_STEPS} steps "
          f"after a warm-up (batch {BC_TRAIN_BATCH}, {BC_IMG} px, f32 at PyTorch's defaults, on "
          f"{gpu}): in-forward {times['in-forward']:.2f}, bridge sync {times['sync']:.2f}, "
          f"bridge overlap {times['overlap']:.2f}; the stride-4 packed copy and trace "
          f"{tr:.2f} ms a batch; of the trace, the caller did not wait for {med['sync']:.0%} "
          f"in sync and {med['overlap']:.0%} in overlap (1 - its waits on the traces over the "
          f"traces' host time, median of {BRIDGE_TIMED}); (sync - overlap) / trace "
          f"{(times['sync'] - times['overlap']) / tr:.0%}")
    base.eval()
    xs = [b[0][:8] for b in host[:4]]
    tracer1 = BridgeTracer(BC_IMG, 1, BC_POINTS)

    def refine(x, pts, counts):
        return base(x, contours=(torch.from_numpy(pts).to(dev), torch.from_numpy(counts).to(dev)))

    def sequential():
        return [(x, refine(x, *tracer1.trace(base.mask_bits(x)))) for x in xs]

    def pipelined():
        return list(pipeline_bc_batches(base.mask_bits, tracer1.submit, refine, xs))

    with torch.no_grad():
        seq, pipe = sequential(), pipelined()
        for (xa, a), (xb, b) in zip(seq, pipe):
            if xa is not xb or sorted(a) != sorted(b) or not all(
                    torch.equal(a[k], b[k]) for k in a):
                raise AssertionError("pipeline_bc_batches' outputs differ from the sequential "
                                     "loop's")
        serve = {}
        for name, run in (("sequential", sequential), ("pipelined", pipelined)):
            runs = []
            for _ in range(BRIDGE_TIMED):
                torch.cuda.synchronize()
                t = time.perf_counter()
                run()
                torch.cuda.synchronize()
                runs.append((time.perf_counter() - t) * 1e3)
            serve[name] = sorted(runs)[len(runs) // 2]
    print(f"[bc-bridge] pipeline_bc_batches over 4 batches of 8 (eval, stride 1): outputs equal "
          f"to the sequential loop's; sequential {serve['sequential']:.2f} ms, pipelined "
          f"{serve['pipelined']:.2f} ms (median of {BRIDGE_TIMED}, host clock, on {gpu})")
    bridge[1].close()
    tracer1.close()
    tracer.close()
    del base, state, astep
    torch.cuda.empty_cache()
    return attention.flash_attention.launches - launches


def _first_line(run: str) -> dict:
    with open(os.path.join(run, "metrics.jsonl")) as f:
        return json.loads(f.readline())


def _same_layout(a: str, b: str) -> None:
    """Two checkpoints of the same keys, shapes and dtypes (nested)."""
    def layout(sd):
        if isinstance(sd, dict):
            return {k: layout(v) for k, v in sd.items()}
        if isinstance(sd, list):
            return [layout(v) for v in sd]
        return (tuple(sd.shape), sd.dtype) if torch.is_tensor(sd) else type(sd).__name__

    la, lb = (layout(torch.load(p, map_location="cpu", mmap=True, weights_only=True))
              for p in (a, b))
    if la != lb:
        raise AssertionError(f"{b}'s keys or shapes differ from {a}'s")


def phase_mesh(tmp: str, gpu: str) -> tuple:
    """--mesh 1x1 through train_vae (256 px, batch 128, bf16), train_bc (256
    px, batch 32) and train_bcp --point_attention (512 px, 2048 points, batch
    16), MESH_ITERATIONS iterations each, over a world of one rank on nccl,
    each beside the same run without --mesh from the same seed: the
    backend, the checkpoint's keys and shapes, the first logged losses and
    the kernel launches must be the same. Returns the mesh runs' forward
    launches, their counts by route and their backward launches."""
    import torch.distributed as dist

    from vaeplay_torch.cli import train_bc, train_bcp, train_vae
    from vaeplay_torch.ops import attention
    from vaeplay_torch.parallel import mesh as M

    seen = []
    real_session = M.mesh_session

    @contextlib.contextmanager
    def watched(spec, device):
        with real_session(spec, device) as (mesh, dev):
            if mesh is not None:
                seen.append((dist.get_backend(), dist.get_world_size(), str(dev)))
            yield mesh, dev

    n = MESH_ITERATIONS
    runs = {
        "train_vae": (train_vae, train_vae.AVG_KEYS, [
            "--img_size", str(VAE_IMG), "--batchsize", str(VAE_BATCH), "--zdim", str(VAE_Z),
            "--data_size", str(n * VAE_BATCH), "--dtype", "bfloat16"], 0),
        "train_bc": (train_bc, ("loss_edge", "loss_mask", "loss_regress"), [
            "--img_size", str(BC_IMG), "--max_points", str(BC_POINTS), "--batchsize",
            str(BC_TRAIN_BATCH), "--iterations", str(n)], BC_PER_FORWARD),
        "train_bcp": (train_bcp, ("loss_class", "loss_total_regress", "d_adv_real",
                                  "g_adv_loss"), [
            "--img_size", str(BCP_IMG), "--max_points", str(BCP_POINTS), "--batchsize",
            str(BCP_TRAIN_BATCH), "--iterations", str(n), "--point_attention"],
            BCP_PER_FORWARD),
    }
    mesh_launches, mesh_routes, mesh_backward = 0, dict.fromkeys(attention.ROUTES, 0), 0
    for name, (cli, keys, args, per_step) in runs.items():
        out = {}
        for label, extra in (("plain", []), ("mesh", ["--mesh", "1x1"])):
            before = attention.flash_attention.launches
            bwd_before = attention.flash_attention_backward.launches
            routes = dict(attention.flash_attention.routes)
            t = time.perf_counter()
            cli.mesh_session = watched
            try:
                run = cli.main(["--gpu", "0", "--epoch", "1", "--viz_freq", "1",
                                "--res_output", os.path.join(tmp, f"{name}_{label}_res"),
                                "--model_output", os.path.join(tmp, f"{name}_{label}"),
                                *args, *extra])
            finally:
                cli.mesh_session = real_session
            launched = attention.flash_attention.launches - before
            if label == "mesh":
                for r, c in attention.flash_attention.routes.items():
                    mesh_routes[r] += c - routes[r]
                mesh_backward += attention.flash_attention_backward.launches - bwd_before
            out[label] = (run, _first_line(run), launched)
            print(f"[mesh] {name} {' '.join(extra) or '(no --mesh)'}: {n} iterations in "
                  f"{time.perf_counter() - t:.1f} s, {launched} kernel launches")
            if launched != per_step * n:
                raise AssertionError(f"{name} {label}: {launched} launches in {n} iterations")
        if dist.is_initialized():
            raise AssertionError(f"{name} --mesh 1x1 left its process group up")
        (run_p, line_p, _), (run_m, line_m, launched) = out["plain"], out["mesh"]
        mesh_launches += launched
        _same_layout(os.path.join(run_p, "0.ckpt"), os.path.join(run_m, "0.ckpt"))
        diff = max(abs(line_m[k] - line_p[k]) / max(abs(line_p[k]), 1e-30) for k in keys)
        print(f"[mesh] {name} --mesh 1x1 over {seen[-1][0]} (world {seen[-1][1]}, "
              f"{seen[-1][2]}): checkpoint keys and shapes as without --mesh; first logged "
              + " ".join(f"{k}={line_m[k]:.6f}/{line_p[k]:.6f}" for k in keys)
              + f" (mesh/plain), largest relative difference {diff:.2e}")
        if seen[-1][:2] != ("nccl", 1) or diff > MESH_LOSS_RTOL:
            raise AssertionError(f"{name} --mesh 1x1 differs from the run without --mesh")
        for run in (run_p, run_m):
            shutil.rmtree(run)
    print(f"[mesh] three --mesh 1x1 trainers over nccl on {gpu}")
    return mesh_launches, mesh_routes, mesh_backward


def phase_ring(gpu: str) -> None:
    """The ring's block update (parallel/ring_attention.py:_ring_step) over
    RING_BLOCKS key/value blocks in one process at BCP's cap (16, 4096, 32,
    260), f32, TF32 off: the output against the plain attention and the
    kernel (TOL), and the ring backward's block gradients (_ring_grad_step)
    against attention_backward (GRAD_TOL); their times. Then
    ring_self_attention in a world of one rank (nccl) through autograd
    against the plain version, and RingRouting inactive on it."""
    from vaeplay_torch.ops import attention
    from vaeplay_torch.ops.attention import RingRouting
    from vaeplay_torch.parallel import mesh as M
    from vaeplay_torch.parallel import ring_attention as R

    b, n, dk, dv = BCP_CAP
    q, k, v = _qkv(BCP_CAP, torch.float32, seed=900, layout="c")
    g = _qkv(BCP_CAP, torch.float32, seed=901, layout="c")[2]
    qc, kb, vb = q.contiguous(), k.chunk(RING_BLOCKS, 1), v.chunk(RING_BLOCKS, 1)
    kb, vb = [t.contiguous() for t in kb], [t.contiguous() for t in vb]

    def forward():
        m = torch.full((b, n), R._NEG_INF, device="cuda")
        l, acc = torch.zeros(b, n, device="cuda"), torch.zeros(b, n, dv, device="cuda")
        for kk, vv in zip(kb, vb):
            m, l, acc = R._ring_step(qc, kk, vv, m, l, acc)
        return acc / l[..., None], m + torch.log(l)

    out, lse = forward()
    delta = (g * out).sum(-1)
    gc = g.contiguous()

    def backward():
        parts = [R._ring_grad_step(qc, kk, vv, gc, lse, delta) for kk, vv in zip(kb, vb)]
        return (sum(p[0] for p in parts), torch.cat([p[1] for p in parts], 1),
                torch.cat([p[2] for p in parts], 1))

    ref = attention.reference_attention(q, k, v)
    kern = attention.spatial_self_attention(q, k, v)
    e_ref, e_kern = _worst(out, ref, TOL[torch.float32]), _worst(out, kern, TOL[torch.float32])
    grads = backward()
    e_grad = max(_worst(a, w, GRAD_TOL) for a, w in zip(grads, attention.attention_backward(
        q, k, v, g)))
    fwd_ms, bwd_ms = cuda_ms(forward, iters=5), cuda_ms(backward, iters=5)
    print(f"[ring] _ring_step over {RING_BLOCKS} blocks at B,N,Dk,Dv={BCP_CAP} f32 (TF32 off), "
          f"one process, on {gpu}: output at {e_ref:.3f} of TOL against the plain version and "
          f"{e_kern:.3f} against the kernel; gradients at {e_grad:.3f} of GRAD_TOL against "
          f"attention_backward; forward {fwd_ms:.3f} ms, backward {bwd_ms:.3f} ms "
          f"(torch.bmm, no hand-written kernel)")
    if max(e_ref, e_kern, e_grad) > 1:
        raise AssertionError("the ring's block update disagrees with the plain attention")
    with M.mesh_session("1x1", torch.device("cuda", 0)) as (mesh, _):
        qs, ks, vs = (t[:2, :1024].detach().requires_grad_() for t in (q, k, v))
        got = R.ring_self_attention(qs, ks, vs, mesh)
        got.backward(g[:2, :1024])
        qr, kr, vr = (t[:2, :1024].detach().requires_grad_() for t in (q, k, v))
        attention.reference_attention(qr, kr, vr).backward(g[:2, :1024])
        e = max([_worst(got.detach(), attention.reference_attention(qr, kr, vr).detach(),
                        TOL[torch.float32])]
                + [_worst(a.grad, w.grad, GRAD_TOL) for a, w in ((qs, qr), (ks, kr), (vs, vr))])
        active = RingRouting(mesh, min_n=1024).active(4096)
        print(f"[ring] ring_self_attention at world 1 ({mesh.size(1)} model rank, nccl) at "
              f"(2, 1024, {dk}, {dv}): output and gradients at {e:.3f} of their bounds; "
              f"RingRouting active at N 4096: {active}")
        if e > 1 or active:
            raise AssertionError("ring_self_attention at world 1 disagrees with the plain version")


def profile_only(gpu: str) -> None:
    """Phase 3's profile alone, at the same weights and batch."""
    from vaeplay_torch.cli import test_bp
    from vaeplay_torch.data.bp_data import SyntheticEmitDataset

    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory(prefix=".smoke-", dir=ROOT) as tmp:
        weights = os.path.join(tmp, "bp_random.pt")
        random_weights(weights)
        model = test_bp.load_model(weights, 512, dev)
    imgs = SyntheticEmitDataset(img_size=512, data_size=16).sample_batch(4, batch_seed=1)[0]
    test_bp.predict(model, imgs, dev)
    _profile(lambda: test_bp.predict(model, imgs, dev), "slice")
    print(gpu)


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    gpu = gpu_line()
    start = time.perf_counter()

    def stamp(what: str) -> None:  # the script's elapsed time, to budget its phases
        print(f"[time] {what} done at {time.perf_counter() - start:.1f} s", flush=True)

    phase_build()
    if argv == ["--profile-only"]:
        profile_only(gpu)
        return 0
    if argv:
        print(f"chip_smoke: unknown arguments {argv}", file=sys.stderr)
        return 2
    from vaeplay_torch.ops import attention

    with strict_f32():
        kernel = phase_kernels(gpu)
        phase_kernel_backward(gpu)
        kernel.update(phase_kernels_bc(gpu))
        kernel.update(phase_kernels_bcp(gpu))
        kernel.update(phase_kernels_be_font(gpu))
        kernel_bf16 = phase_kernels_bp_bf16(gpu)
        kernel.update(phase_kernels_bcp_cap(gpu))
        kernel_bwd = phase_kernel_backward_times(gpu)
    stamp("phases 1-2")
    # launches on the main paths by kernel and route; each path is driven
    # with the counts set to 0 just before it and read just after
    path_routes = dict.fromkeys(attention.ROUTES, 0)
    path_backward = {}

    def path(label: str, launches: int, routes: dict = None, backward: int = None) -> int:
        routes = dict(attention.flash_attention.routes) if routes is None else routes
        backward = attention.flash_attention_backward.launches if backward is None else backward
        if sum(routes.values()) != launches or attention.flash_attention.copied_bytes:
            raise AssertionError(f"{label}: {launches} launches, routes {routes}, "
                                 f"{attention.flash_attention.copied_bytes} bytes of k and v "
                                 f"copied")
        # inference (phase 3) takes no gradient; every other path trains
        if (backward > 0) is ("phase 3" in label):
            raise AssertionError(f"{label}: {backward} backward kernel launches")
        for r, c in routes.items():
            path_routes[r] += c
        path_backward[label] = backward
        print(f"[routes] {label}: " + (", ".join(f"{r} {c}" for r, c in routes.items() if c)
                                       or "no launch") + f"; no copy of k or v; backward "
                                                         f"kernel {backward}")
        return launches

    with tempfile.TemporaryDirectory(prefix=".smoke-", dir=ROOT) as tmp:
        weights = os.path.join(tmp, "bp_random.pt")
        random_weights(weights)
        path("BP inference f32 (phase 3)", phase_slice(tmp, weights, gpu))
        with strict_f32():
            phase_parity(weights)
        f32_ms = []
        path("BP training f32 (phase 5)", phase_train(tmp, gpu, f32_ms))
        stamp("phases 3-5")
        phase_vae_train(tmp, gpu)
        stamp("phase 7")
        before = attention.flash_attention.launches
        phase_be_infer(tmp, gpu)
        phase_be_train(tmp, gpu)
        tree = phase_be_serve(tmp, gpu)
        phase_be_gan_train(tmp, tree, gpu)
        stamp("phases 9-10, 12-13")
        if attention.flash_attention.launches != before:
            raise AssertionError("a BE or BE_GAN phase launched the attention kernel")
        attention.reset_counts()
        phase_bc_infer(tmp, gpu)
        phase_bc_train(tmp, gpu)
        kernel["bc_launches"] = path("BC f32 and bf16 (phases 15-16)",
                                     attention.flash_attention.launches)
        stamp("phases 15-16")
        attention.reset_counts()
        phase_bcp_infer(tmp, gpu)
        phase_bcp_train(tmp, gpu)
        kernel["bcp_launches"] = path("BCP f32, bf16, --point_attention (phases 18-19)",
                                      attention.flash_attention.launches)
        stamp("phases 18-19")
        attention.reset_counts()
        phase_be_font_infer(tmp, gpu)
        phase_be_font_train(tmp, gpu)
        kernel["be_font_launches"] = path("BE_font f32 and bf16 (phases 21-22)",
                                          attention.flash_attention.launches)
        stamp("phases 21-22")
        kernel_bf16["bp_launches"] = path("BP training bf16 (phase 24)",
                                          *phase_bp_bf16_train(tmp, gpu, f32_ms))
        stamp("phase 24")
        before = attention.flash_attention.launches
        phase_style_gan_train(tmp, gpu)
        if attention.flash_attention.launches != before:
            raise AssertionError("a Style_GAN phase launched the attention kernel")
        stamp("phase 25")
        attention.reset_counts()
        kernel["bridge_launches"] = path("BC's bridge (phase 27)", phase_bc_bridge(gpu))
        stamp("phase 27")
        attention.reset_counts()
        kernel["mesh_launches"] = path("--mesh 1x1 trainers (phase 28)", *phase_mesh(tmp, gpu))
        stamp("phase 28")
    # each kernel's launches on the main paths, by route
    for entry, dtype in ((kernel, "float32"), (kernel_bf16, "bfloat16")):
        entry["launches_by_route"] = {r: path_routes[f"{dtype}/{r}"] for r in ("tma", "direct")}
        entry["launches"] = sum(entry["launches_by_route"].values())
        if not entry["launches"]:
            raise AssertionError(f"{entry['name']} was launched no time on the main paths")
    kernel_bwd["launches_by_path"] = path_backward
    kernel_bwd["launches"] = sum(path_backward.values())
    print(f"[routes] the main paths in all: " + ", ".join(f"{r} {c}"
                                                         for r, c in path_routes.items()))
    with strict_f32():
        phase_train_parity()
        phase_vae_parity()
        before = attention.flash_attention.launches
        phase_be_parity()
        phase_be_gan_parity()
        if attention.flash_attention.launches != before:
            raise AssertionError("a BE or BE_GAN parity step launched the attention kernel")
        stamp("phases 6, 8, 11, 14")
        phase_bc_parity()
        phase_bcp_parity()
        phase_be_font_parity()
        stamp("phases 17, 20, 23")
        before = attention.flash_attention.launches
        phase_style_gan_parity()
        if attention.flash_attention.launches != before:
            raise AssertionError("the Style_GAN parity step launched the attention kernel")
        stamp("phase 26")
        phase_ring(gpu)
        stamp("phase 29")
    print(gpu)
    print(json.dumps({"kernels": [kernel, kernel_bf16, kernel_bwd]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
