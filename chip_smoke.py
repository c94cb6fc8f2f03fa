#!/usr/bin/env python3
"""Smoke run of the PyTorch port (nerfies_tpu_torch) on one CUDA card.

Phases, each printed with its elapsed seconds; the run stops with a
non-zero exit at the first phase that fails:

  device   require CUDA; print the card's name and power limit.
  build    build the kernels from nerfies_tpu_torch/csrc, one nvcc per
           source, started together; print ptxas's registers and spills
           and require none for the forwards (NO_SPILL_KERNELS).
  kernels  hold each kernel against its plain PyTorch version at the full
           width of the bench model and at the row counts serving and
           training give it (atol = rtol = 0.05, the bf16 tolerance of
           tests/test_fused_mlp.py), and time kernel, plain version and a
           bf16 torch.matmul chain of the same function, under autograd
           for a backward (a yardstick only; median of 5, CUDA events);
           the two serving forwards at the coarse and the fine level's rows.
           The training kernels (NeRF MLP backward, warp forward with 3
           tangents, warp backward) run at the bench step's row counts and
           are compared the same way: per-row outputs at atol = rtol =
           0.05 on all but MAX_FLIPPED_ROWS_FRAC of the rows (ReLU mask
           flips, see below), each dW leaf by max|kernel - plain| <=
           DW_MAX_REL * max|plain|; each backward runs twice and must give
           bit-identical dW (the reduction is deterministic). Each
           backward's row pass and weight-gradient pass are also timed on
           their own, and the warp forward and backward are checked and
           timed at the fine level's rows too (no tangents).
  widths   hold the NeRF forward and backward against their plain versions,
           as above, at the other widths the kernels are built for
           (OTHER_NERF_WIDTHS), OTHER_WIDTH_ROWS rows.
  serve    build the bench render model from a seed and serve 3 requests
           of 128x128 rays through evaluation.make_render_fn and
           render_image (chunk 8192, warp alpha 6.0); check the outputs and
           that every kernel of the path was launched, with the launch
           counts set to 0 just before and read just after.
  parity   render 256 rays on the card through the kernels and on the CPU
           through the plain versions, from the same params; compare at
           atol 0.02 and rtol 0.05 (tests/test_fast_render.py).
  train    build the bench training workload from the seed (bench.py:57-107:
           batch 6144, stratified sampling, elastic log_svals / weight,
           background loss on 16,384 points, warp alpha 6.0, lr 1e-3,
           elastic weight 1e-3, background weight 1.0) and take 1 warm-up
           and 3 timed steps through training.make_train_step; require
           finite losses, changed params and the launch counts the path
           implies per step (NeRF forward 2, NeRF backward 2, warp forward
           3, warp backward 3), with the counts set to 0 just before the
           timed steps and read just after; then profile one more step.
  train_parity  one step of the full-width model on 128 rays with
           deterministic sampling, on the card (kernels) and on the CPU
           (plain versions), from the same params and the same background
           ids and noise; stats at rtol 0.05, atol 5e-4 and each param's
           gradient (the first Adam moment, 0.1 x gradient) at cosine >
           0.95 and norm ratio in (0.7, 1.4), as tests/test_fused_train.py.
  model    the plain forward (NerfModel.forward, JAX's model.apply) at the
           architecture of configs/gpu_vrig_paper.gin (NeRF 8x256 skip 4,
           rgb branch 128; SE(3) warp 6x128, 6 frequencies, 8 GLO
           features; 2 camera dims; float32, no TF32), random weights from
           the seed: 256 rays with deterministic sampling on the card
           against the CPU (rgb, depth, acc at atol 1e-4, rtol 1e-3; the
           coarse warp Jacobian at atol 1e-3), with no kernel launched;
           in bf16 against the serving kernels on the card (atol 0.02,
           rtol 0.05); one bench-workload step with use_fused_warp=False
           after a warm-up, requiring finite stats and per step NeRF
           forward 2, NeRF backward 2 and no warp kernel (the counts set to
           0 just before it and read just after); a 128x128 request
           through make_render_fn(fast='off'), launching nothing, against
           fast='auto' at the parity limits, with the rays/s of each.
  cli      write a synthetic capture with nerfies_tpu_torch.datasets.synthetic
           (16 train and 2 val frames of 480x272 at scale 1: 2,088,960
           rays in the pool; 16,384 background points) and train it with
           the training CLI, nerfies_tpu_torch.train.main, on
           configs/tpu_vrig_paper.gin at full width (image scale 1): 7
           steps, then a second run to step 10 that resumes from the
           checkpoint of step 7. Require finite stats, the restored state
           equal bit for bit to the saved one, 2 checkpoints kept and the
           launch counts of the train phase per step, with the counts set
           to 0 just before the first run and read just after the second;
           print the CLI's median train_step and data times, its rays/s,
           the gap to the train phase's median step, one frame's PNG
           decode, the ray pool's build (and the same pool built in one
           thread) and checkpoint save and restore. The capture and the
           experiment stay for the eval phase.
  cli_plain  train configs/gpu_vrig_paper.gin at full width (image scale
           1) with the training CLI on the cli phase's capture: 5 steps,
           then resumed to 7; require finite stats, the restored state
           equal bit for bit and no launch of any kernel over both runs
           (the plain route runs none; counts set to 0 just before the
           first run and read after the median run below); print the median
           train_step, rays/s, max_memory_allocated and the gap to the
           train phase's step; profile one plain step (device busy, idle
           share, matmul kernels against the rest); then 2 steps with
           elastic_reduce_method 'median' in a fresh experiment (the
           gathered median), requiring a finite loss/elastic.
  eval     evaluate the cli phase's step-10 checkpoint with the eval CLI,
           nerfies_tpu_torch.eval.main (eval_once; 2 val, 2 train and 2
           test cameras; chunk 8192; renders rotated to 1 checkpoint), once
           unculled and once with --fast_preview (32 + 64 samples culled to
           16 + 32 through a 128^3 occupancy bake). Require finite PSNR,
           MS-SSIM and lpips_uncal, the PNGs written, a stale render
           directory rotated away, and launches of nerf_mlp_forward and
           warp_trunk_forward that match frames x chunks x 2 levels (+ the
           bake's chunks) and none of a training kernel, with the counts set
           to 0 just before each run and read just after. Print each frame's
           render_time and rays/s, the bake's seconds and occupied share and
           the val metrics. Render the capture's orbit-mild path with
           the render-video CLI (6 PNG frames). Then, at the full-width
           model: render_camera against render_image of host-built rays
           for one val camera
           (atol 0.02, rtol 0.05); an all-occupied grid keeping every sample
           against the unculled render (atol 1e-5); MS-SSIM of the smooth
           pair of tests/test_evaluation.py:198 at or below 1 and within
           1e-4 of the CPU's; LPIPS of a val render within 1e-3 (relative)
           of the CPU's; and the two serving kernels against their plain
           versions and timed at the eval path's rows (the culled levels'
           131,072 and 262,144, the bake's 262,144 without an rgb row bias,
           the culled path's warp at 262,144 and 655,360). A frame is
           profiled unculled and culled, and culled at 8 times the chunk:
           wall and device-busy ms, idle share, device ops, largest ops.
  capture  render 12 frames of 480x272 of the synthetic sphere on an orbit,
           save them as PNGs and write their COLMAP binary model (4,096
           points, each seen by 2 frames) with the port's SceneManager;
           run nerfies_tpu_torch.process_capture.main on them with the JAX
           CLI's defaults (blur keep 95, scales 1/2/4/8, val 0.2) and 6
           orbit frames; train the dataset with the training CLI on
           configs/tpu_vrig_paper.gin at full width (image scale 1) for 3
           steps; render its orbit-mild path with render_video. Require
           fewer frames kept than written, every pyramid level written,
           finite stats, the launches of the train phase per step, 6 PNG
           frames and the serving launches of 6 unculled frames (counts
           set to 0 just before each run and read just after). Print the
           processing seconds and the blur keep count.
  quality  nerfies_tpu_torch.quality_bench.main at the bench width (batch
           6144, 128 + 128 samples, fused) on its textured scene with 8
           train frames of 384x288: 20 steps, an eval every 10, the params
           saved. Require 2 finite curve rows, render_delta > 0 on the
           second, and per step NeRF forward 2, NeRF backward 2, warp
           forward 3 and warp backward 3 plus the serving launches of the
           4 eval renders (counts set to 0 just before the run, read just
           after). Print the median step ms and rays/s and the curve.
  serve_bench  nerfies_tpu_torch.serve_bench.main on those params with
           --measure_1080p (a 128^3 bake over the points' box and margin;
           full, preset 32 + 64, and both culled modes, each on the val
           view and a 1920x1080 orbit frame). Require 4 rows of finite
           numbers, launches of both serving kernels and none of a
           training kernel, and the full mode's val PSNR within
           SERVE_PSNR_ATOL dB of the quality curve's last (the same
           model, saved and loaded). Record every row count the run gave
           each serving kernel (each mode's two levels at the val chunk
           and the 1080p chunk, the bake; a last chunk is padded to the
           chunk's size) and hold both kernels at each against their
           plain versions, timed, on the npz's model. Print each mode's rays/s, its 1080p seconds and the
           occupied share; the PSNR of a 20-step fit is never held to a
           floor.
  ddp      the CLIs under `python -m torch.distributed.run --standalone
           --nproc_per_node=<torch.cuda.device_count()>` (NCCL, one process
           per card, each on cuda:{LOCAL_RANK}; world size 1 on a machine of
           one card), each rank running `chip_smoke.py --ddp_child`, which
           writes its launch counts, the cards its launches were given,
           numbers and loaded JAX modules (none may be) to a report; rank r
           must launch on card r only. The training CLI on the cli phase's
           capture with configs/tpu_vrig_paper.gin for 3 steps, resumed to 5,
           held against the same runs in this process: at world size 1 params
           and stats bit-identical, at N > 1 stats at rtol 0.05, atol 5e-4.
           configs/gpu_quarterhd_4gpu.gin (made for 4 devices, the plain
           route) for 3 steps: step ms, rays/s, peak memory a rank, the
           all-reduce's calls, bytes and ms a step. The eval CLI on step 5's
           checkpoint, one val frame: at world size 1 equal bit for bit to the
           frame rendered in this process, at N > 1 within atol 0.02, rtol
           0.05. Every kernel must launch in the children (their counts are
           the kernels line's `ddp` launches).
  profile  `nerfies_tpu_torch.profiling step` on the bench workload (fused
           route, 5 unprofiled steps, one profiled): device ms by op for
           every op, the idle share against the unprofiled median; its
           trace summarised by `profiling trace`; then `profiling
           dispatch`.

The line before the last is a JSON object {"kernels": [...]}; the last is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Usage: python3 chip_smoke.py [--seed 0]

`python3 chip_smoke.py --ddp_only` runs the device, build and ddp phases
alone, on a machine of several cards (world size torch.cuda.device_count()),
and prints no result line.
"""

import argparse
import contextlib
import dataclasses
import gc
import json
import os
import pathlib
import shutil
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from nerfies_tpu_torch import capture
from nerfies_tpu_torch import checkpoints
from nerfies_tpu_torch import configs
from nerfies_tpu_torch import datasets
from nerfies_tpu_torch import eval as eval_cli
from nerfies_tpu_torch import evaluation
from nerfies_tpu_torch import fast_render
from nerfies_tpu_torch import image_utils
from nerfies_tpu_torch import interop
from nerfies_tpu_torch import lpips
from nerfies_tpu_torch import occupancy
from nerfies_tpu_torch import process_capture
from nerfies_tpu_torch import profiling
from nerfies_tpu_torch import quality_bench
from nerfies_tpu_torch import render_video
from nerfies_tpu_torch import resolve_device
from nerfies_tpu_torch import schedules
from nerfies_tpu_torch import serve_bench
from nerfies_tpu_torch import train as train_cli
from nerfies_tpu_torch import training
from nerfies_tpu_torch import utils
from nerfies_tpu_torch.colmap import ColmapCamera
from nerfies_tpu_torch.colmap import Image
from nerfies_tpu_torch.colmap import Quaternion
from nerfies_tpu_torch.colmap import SceneManager
from nerfies_tpu_torch.datasets import core
from nerfies_tpu_torch.datasets import synthetic
from nerfies_tpu_torch.models import modules
from nerfies_tpu_torch.models import nerf
from nerfies_tpu_torch.ops import _build
from nerfies_tpu_torch.ops import encoding
from nerfies_tpu_torch.ops import fused_mlp
from nerfies_tpu_torch.ops import fused_warp
from nerfies_tpu_torch.ops import ssim
from nerfies_tpu_torch.parallel import mesh

KERNEL_ATOL = KERNEL_RTOL = 0.05
RENDER_ATOL, RENDER_RTOL = 0.02, 0.05
IMAGE_SIZE = 128
NUM_REQUESTS = 3
CHUNK = 8192
WARP_ALPHA = 6.0
PARITY_RAYS = 256
TRAIN_BATCH = 6144
SERVE_KERNELS = ('nerf_mlp_forward', 'warp_trunk_forward')
# Kernels whose ptxas report must show no spills at any width.
NO_SPILL_KERNELS = ('nerf_mlp_kernel', 'warp_trunk_kernel', 'warp_fwd_kernel')
TRAIN_BACKGROUND_POINTS = 16384
# A pre-activation within rounding of zero can fall on either side of the
# ReLU in the kernel and in the plain version (their f32 sums run in
# different orders); a backward then passes that cotangent element in
# one and stops it in the other, and so does a tangent chain, which takes
# the primal's mask. Such flips touch few, isolated rows; a wrong kernel
# disagrees on most. Per-row backward and tangent outputs may differ
# beyond atol = rtol = 0.05 on at most this share of rows.
MAX_FLIPPED_ROWS_FRAC = 0.01
DW_MAX_REL = 0.05  # max|kernel - plain| <= DW_MAX_REL * max|plain| per dW
TRAIN_STEPS = 3
# (trunk width, rgb branch width) of the NeRF kernels besides the bench
# model's (256, 128), and the rows they are checked at.
OTHER_NERF_WIDTHS = ((128, 128), (32, 128))
OTHER_WIDTH_ROWS = 131072 + 37
PARITY_TRAIN_RAYS = 128
# The cli phase: a capture of 16 + 2 frames of 480x272, trained with
# configs/tpu_vrig_paper.gin for CLI_FIRST_STEPS steps, then resumed to
# CLI_LAST_STEP, a checkpoint every CLI_SAVE_EVERY steps.
CLI_GIN = 'configs/tpu_vrig_paper.gin'
CLI_FRAMES = (16, 2)
CLI_IMAGE_SIZE = (480, 272)
CLI_POINTS = 16384
CLI_FIRST_STEPS, CLI_LAST_STEP, CLI_SAVE_EVERY = 7, 10, 4
TRAIN_STEP_LAUNCHES = {'nerf_mlp_forward': 2, 'nerf_mlp_backward': 2,
                       'warp_mlp_forward': 3, 'warp_mlp_backward': 3,
                       'warp_trunk_forward': 0}
# The eval phase: nerfies_tpu_torch.eval on the cli phase's experiment,
# once unculled and once with --fast_preview (32 + 64 samples culled to
# 16 + 32, a 128^3 bake in chunks of 262,144 voxels).
EVAL_BINDINGS = ('ExperimentConfig.image_scale = 1',
                 'EvalConfig.eval_once = True', 'EvalConfig.num_val_eval = 2',
                 'EvalConfig.num_train_eval = 2',
                 'EvalConfig.num_test_eval = 2', f'EvalConfig.chunk = {CHUNK}',
                 'EvalConfig.max_render_checkpoints = 1')
EVAL_BAKE_CHUNK = 262144  # occupancy.build_grid's chunk
PREVIEW_SAMPLES, CULLED_KEEP = (32, 64), (16, 32)
CULL_NOOP_ATOL = 1e-5
# A culled frame is also profiled at 8 times the chunk: 2 chunks a frame.
PROFILE_BIG_CHUNK = 8 * CHUNK
MSSSIM_CPU_ATOL = 1e-4
LPIPS_CPU_RTOL = 1e-3
PARITY_BACKGROUND_POINTS = 2048
STATS_RTOL, STATS_ATOL = 0.05, 5e-4
GRAD_COSINE, GRAD_NORM_RATIO = 0.95, (0.7, 1.4)
# The model and cli_plain phases: the plain forward (NerfModel.forward,
# JAX's model.apply) at the architecture of PLAIN_GIN, in float32 with no
# TF32; the card against the CPU on MODEL_RAYS rays.
PLAIN_GIN = 'configs/gpu_vrig_paper.gin'
MODEL_RAYS = 256
MODEL_ATOL, MODEL_RTOL, MODEL_JACOBIAN_ATOL = 1e-4, 1e-3, 1e-3
WARP_EXTRA = {'alpha': WARP_ALPHA, 'time_alpha': 0.0}
# A fused step with use_fused_warp=False: the NeRF kernels, no warp kernel.
PLAIN_WARP_STEP_LAUNCHES = {'nerf_mlp_forward': 2, 'nerf_mlp_backward': 2,
                            'warp_mlp_forward': 0, 'warp_mlp_backward': 0,
                            'warp_trunk_forward': 0}
CLI_PLAIN_FIRST, CLI_PLAIN_LAST, CLI_MEDIAN_STEPS = 5, 7, 2
# Device kernels of a matmul (cuBLAS's names), for the profile's split.
MATMUL_MARKS = ('gemm', 'xmma', 'cutlass', 'cublas')
# Each kernel's wrapper: its source and the TPU kernel it replaces.
KERNEL_SOURCES = {
    'nerf_mlp_forward': ('nerfies_tpu_torch/csrc/fused_mlp.cu',
                         'nerfies_tpu/ops/fused_mlp.py:78'),
    'warp_trunk_forward': ('nerfies_tpu_torch/csrc/fused_mlp.cu',
                           'nerfies_tpu/ops/fused_mlp.py:645'),
    'nerf_mlp_backward': ('nerfies_tpu_torch/csrc/fused_mlp_bwd.cu',
                          'nerfies_tpu/ops/fused_mlp.py:432'),
    'warp_mlp_forward': ('nerfies_tpu_torch/csrc/fused_warp.cu',
                         'nerfies_tpu/ops/fused_warp.py:147'),
    'warp_mlp_backward': ('nerfies_tpu_torch/csrc/fused_warp_bwd.cu',
                          'nerfies_tpu/ops/fused_warp.py:207'),
}
# The capture phase: CAPTURE_FRAMES synthetic frames of CLI_IMAGE_SIZE on
# an orbit and their COLMAP model (CAPTURE_POINTS points, each seen by 2
# frames) through process_capture with the JAX CLI's defaults and
# CAPTURE_ORBIT_FRAMES orbit frames; CAPTURE_STEPS steps of the training
# CLI on CLI_GIN; the orbit-mild path rendered.
CAPTURE_FRAMES = 12
CAPTURE_POINTS = 4096
CAPTURE_ORBIT_FRAMES = 6
CAPTURE_STEPS = 3
# The quality phase: quality_bench at the bench width on its textured
# scene (8 train frames of 384x288), QUALITY_STEPS steps, an eval every
# QUALITY_EVAL_EVERY; the serve_bench phase serves the params it saves.
QUALITY_STEPS, QUALITY_EVAL_EVERY = 20, 10
QUALITY_ARGV = ('--num_train', '8', '--image_size', '384', '288')
# The curve rounds PSNR to 5 places, serve_bench to 3.
SERVE_PSNR_ATOL = 2e-3
# The ddp phase: the CLIs under torchrun, one process per card of the
# machine, NCCL. The training CLI on CLI_GIN for DDP_FIRST_STEPS steps,
# resumed to DDP_LAST_STEP, against the same runs without torchrun;
# DDP_PLAIN_GIN (made for 4 devices, the plain route) for DDP_PLAIN_STEPS
# steps; the eval CLI on one val frame.
DDP_FIRST_STEPS, DDP_LAST_STEP = 3, 5
DDP_PLAIN_GIN = 'configs/gpu_quarterhd_4gpu.gin'
DDP_PLAIN_STEPS = 3
DDP_EVAL_BINDINGS = ('ExperimentConfig.image_scale = 1',
                     'EvalConfig.eval_once = True',
                     'EvalConfig.num_val_eval = 1',
                     'EvalConfig.num_train_eval = 0',
                     'EvalConfig.num_test_eval = 0',
                     f'EvalConfig.chunk = {CHUNK}',
                     'EvalConfig.save_output = False')
DDP_EVAL_ATOL, DDP_EVAL_RTOL = 0.02, 0.05
DDP_TIMEOUT_S = 300
# The profile phase: nerfies_tpu_torch.profiling step on the bench
# workload (fused route), PROFILE_STEPS unprofiled steps, then dispatch.
PROFILE_STEPS = 5
# Top-level modules that a ddp child must not load.
FORBIDDEN_MODULES = ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'nerfies_tpu')

# Dense peaks of the card at its full power limit, from NVIDIA's data
# sheets (SXM parts): bf16 tensor FLOP/s and device-memory bytes/s.
PEAKS = {'H200': (989e12, 4.8e12), 'H100': (989e12, 3.35e12)}


class PhaseError(RuntimeError):
  pass


def check(condition, message):
  if not condition:
    raise PhaseError(message)


def peaks(device_name):
  for key, value in PEAKS.items():
    if key in device_name:
      return value
  raise PhaseError(f'no peak rates known for {device_name!r}')


def time_ms(fn, reps):
  """Median milliseconds of `fn` over `reps` runs, after one warm-up."""
  fn()
  times = []
  for _ in range(reps):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    times.append(start.elapsed_time(end))
  return float(np.median(times))


def nbytes(*tensors):
  return sum(t.numel() * t.element_size() for t in tensors if t is not None)


# ------------------------------------------------------------- yardsticks

def library_nerf(x, rgb_row_bias, ops, trunk_depth):
  """The NeRF MLP as a chain of bf16 torch.matmul calls (cuBLAS)."""
  xb = x.to(torch.bfloat16)
  h = None
  for i in range(trunk_depth):
    acc = torch.addmm(ops.trunk_b[i], xb if h is None else h, ops.trunk_w[i])
    if i in ops.trunk_wx:
      acc = acc + xb @ ops.trunk_wx[i]
    h = torch.relu(acc)
  bt = torch.addmm(ops.bottleneck[1], h, ops.bottleneck[0])
  alpha = torch.addmm(ops.alpha_b, bt if ops.alpha_from_bt else h, ops.alpha_w)
  y = torch.addmm(ops.rgb_hidden[1], bt if ops.rgb_from_bt else h,
                  ops.rgb_hidden[0])
  if rgb_row_bias is not None:
    y = y + rgb_row_bias
  rgb = torch.addmm(ops.rgb_b, torch.relu(y), ops.rgb_w)
  return alpha.float(), rgb.float()


def library_warp(x, row_biases, ops, trunk_depth):
  """The warp trunk and head as a chain of bf16 torch.matmul calls."""
  xb = x.to(torch.bfloat16)
  biases = dict(row_biases)
  h = None
  for i in range(trunk_depth):
    acc = torch.addmm(ops.trunk_b[i], xb if h is None else h, ops.trunk_w[i])
    if i in ops.trunk_wx:
      acc = acc + xb @ ops.trunk_wx[i]
    if i in biases:
      acc = acc + biases[i]
    h = torch.relu(acc)
  return torch.addmm(ops.head_b, h, ops.head_w).float()


def _leaf(t):
  return None if t is None else t.detach().clone().requires_grad_(True)


def library_nerf_backward(x, rgb_row_bias, ops, trunk_depth, g_alpha, g_rgb):
  """Autograd through library_nerf: returns the timed backward call."""
  ops = dataclasses.replace(
      ops, trunk_w=[_leaf(t) for t in ops.trunk_w],
      trunk_wx={k: _leaf(v) for k, v in ops.trunk_wx.items()},
      trunk_b=[_leaf(t) for t in ops.trunk_b],
      bottleneck=tuple(_leaf(t) for t in ops.bottleneck),
      alpha_w=_leaf(ops.alpha_w), alpha_b=_leaf(ops.alpha_b),
      rgb_hidden=tuple(_leaf(t) for t in ops.rgb_hidden),
      rgb_w=_leaf(ops.rgb_w), rgb_b=_leaf(ops.rgb_b))
  xl = _leaf(x.to(torch.bfloat16))
  rbl = _leaf(rgb_row_bias)
  leaves = [xl, rbl] + [t for t in (
      ops.trunk_w + list(ops.trunk_wx.values()) + ops.trunk_b
      + list(ops.bottleneck) + list(ops.rgb_hidden)
      + [ops.alpha_w, ops.alpha_b, ops.rgb_w, ops.rgb_b])]
  with torch.enable_grad():
    outs = library_nerf(xl, rbl, ops, trunk_depth)
  return lambda: torch.autograd.grad(outs, leaves, (g_alpha, g_rgb),
                                     retain_graph=True)


def library_warp_train(x, e, tangents, ops, trunk_depth, skips):
  """The warp trunk's primal and tangent chains as bf16 torch.matmul calls.

  `ops` is fused_warp.pack's dict; returns (out, [jout]) as f32.
  """
  xb, eb = x.to(torch.bfloat16), e.to(torch.bfloat16)
  tb = [t.to(torch.bfloat16) for t in tangents]
  h, ths = None, []
  for i in range(trunk_depth):
    if i == 0:
      acc = torch.addmm(ops['b0'], xb, ops['w0']) + eb @ ops['we0']
      taccs = [t @ ops['w0'] for t in tb]
    elif i in skips:
      acc = (torch.addmm(ops[f'b{i}'], h, ops[f'w{i}']) + xb @ ops[f'wx{i}']
             + eb @ ops[f'we{i}'])
      taccs = [th @ ops[f'w{i}'] + t @ ops[f'wx{i}'] for th, t in zip(ths, tb)]
    else:
      acc = torch.addmm(ops[f'b{i}'], h, ops[f'w{i}'])
      taccs = [th @ ops[f'w{i}'] for th in ths]
    mask = acc > 0
    h = torch.relu(acc)
    ths = [ta * mask for ta in taccs]
  out = torch.addmm(ops['bh'], h, ops['wh']).float()
  return out, [(th @ ops['wh']).float() for th in ths]


def library_warp_backward(x, e, tangents, ops, trunk_depth, skips, g_out,
                          g_jouts):
  """Autograd through library_warp_train: returns the timed backward."""
  ops = {k: _leaf(v) for k, v in ops.items()}
  el = _leaf(e.to(torch.bfloat16))
  with torch.enable_grad():
    out, jouts = library_warp_train(x, el, tangents, ops, trunk_depth, skips)
  leaves = [el] + list(ops.values())
  return lambda: torch.autograd.grad([out] + jouts, leaves,
                                     [g_out] + list(g_jouts),
                                     retain_graph=True)


# ----------------------------------------------------------------- phases

def phase_device():
  check(torch.cuda.is_available(), 'torch.cuda.is_available() is false')
  smi = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
      capture_output=True, text=True, timeout=60, check=False)
  check(smi.returncode == 0, f'nvidia-smi failed: {smi.stderr.strip()}')
  print(smi.stdout.strip().splitlines()[0])
  name = torch.cuda.get_device_name(0)
  print(f'device: {name}, count {torch.cuda.device_count()}, torch '
        f'{torch.__version__}, CUDA {torch.version.cuda}')
  # The plain versions are the f32 references: keep TF32 off.
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  return name


def phase_build():
  start = time.perf_counter()
  path = _build.build()
  _build.load()
  seconds = time.perf_counter() - start
  print(f'build: {seconds:.2f} s, {path}')
  entry = ''
  for line in _build.build_log().splitlines():
    if ('registers' in line or 'spill' in line or ' s, exit' in line
        or 'Compiling entry' in line):
      print(f'  {line.strip()}')
    if 'Compiling entry' in line:
      entry = line
    elif 'spill stores' in line and any(k in entry for k in NO_SPILL_KERNELS):
      spilled = [int(w) for w in line.replace(',', ' ').split() if w.isdigit()]
      check(spilled[1:] == [0, 0], f'ptxas spills in {entry.strip()}: {line}')
  return seconds


def operand_bytes(ops):
  """Bytes of a packed operand set (tensors, lists, dicts, pairs)."""
  total = 0
  for value in vars(ops).values():
    if isinstance(value, torch.Tensor):
      total += nbytes(value)
    elif isinstance(value, (list, tuple)):
      total += nbytes(*[t for t in value if isinstance(t, torch.Tensor)])
    elif isinstance(value, dict):
      total += nbytes(*value.values())
  return total


def _kernel_cases(model, device, generator, nerf_rows=None, warp_rows=None):
  """Yields each kernel case at the model's widths.

  `nerf_rows` [(rows, with an rgb row bias)] and `warp_rows` [rows]
  default to the serving rows: a chunk's rays times 128 coarse samples or
  256 fine ones, and a ragged count.
  """
  params = model.params
  mlp = params['nerf_mlps_coarse']
  nerf_ops = fused_mlp.pack_nerf_mlp(
      mlp, encoding.posenc_output_dim(3, model.num_nerf_point_freqs),
      model.nerf_trunk_depth, model.nerf_skips)
  # Useful multiply-adds per row, from the unpadded operands.
  width = nerf_ops.width
  nerf_macs = (sum(t.numel() for t in nerf_ops.trunk_w)
               + sum(t.numel() for t in nerf_ops.trunk_wx.values())
               + nerf_ops.bottleneck[0].numel()
               + width * mlp['alpha_logit']['kernel'].shape[1]
               + nerf_ops.rgb_hidden[0].numel()
               + mlp['rgb_logit']['kernel'].numel())
  warp = params['warp_field']
  warp_depth = int(model.warp_kwargs.get('trunk_depth', 6))
  warp_skips = tuple(model.warp_kwargs.get('skips', (4,)))
  # The head at its 1e-4 init scale would hide any error of the trunk; a
  # Glorot-uniform head shows it at the scale of a trained one.
  warp_width = warp['trunk']['hidden_0']['kernel'].shape[1]
  head = modules.mlp([warp_width], 0, warp_width, output_channels=6,
                     generator=torch.Generator().manual_seed(1))
  warp_params = {'trunk': warp['trunk'], 'branches_wv': _tree_to(head, device)}
  warp_ops = fused_mlp.pack_warp_trunk(
      warp_params, encoding.posenc_output_dim(3, model.num_warp_freqs),
      warp_depth, warp_skips)
  warp_macs = (sum(t.numel() for t in warp_ops.trunk_w)
               + sum(t.numel() for t in warp_ops.trunk_wx.values())
               + warp_params['branches_wv']['logit']['kernel'].numel())

  c_pe = encoding.posenc_output_dim(3, model.num_nerf_point_freqs)
  c_warp = encoding.posenc_output_dim(3, model.num_warp_freqs)
  rgb_width = nerf_ops.rgb_width

  def randn(*shape):
    return torch.randn(*shape, generator=generator, device=device)

  coarse = CHUNK * model.num_coarse_samples
  fine = CHUNK * (model.num_coarse_samples + model.num_fine_samples)
  if nerf_rows is None:
    nerf_rows = ((coarse, False), (coarse, True), (coarse + 37, True),
                 (fine, True))
  if warp_rows is None:
    warp_rows = (coarse, coarse + 37, fine)
  for n, with_bias in nerf_rows:
    x = encoding.posenc(randn(n, 3), model.num_nerf_point_freqs)
    rb = randn(n, rgb_width).to(torch.bfloat16) if with_bias else None
    check(x.shape[1] == c_pe, 'encoding width')
    yield dict(
        name='nerf_mlp_forward', rows=n, with_bias=with_bias,
        kernel=lambda x=x, rb=rb: fused_mlp.nerf_mlp_forward(
            x, rb, mlp, trunk_depth=model.nerf_trunk_depth,
            skips=model.nerf_skips),
        plain=lambda x=x, rb=rb: fused_mlp.nerf_mlp_reference(
            x, rb, mlp, trunk_depth=model.nerf_trunk_depth,
            skips=model.nerf_skips),
        library=lambda x=x, rb=rb: library_nerf(
            x, rb, nerf_ops, model.nerf_trunk_depth),
        bytes=nbytes(x, rb) + operand_bytes(nerf_ops) + 2 * n * 8 * 4,
        flops=2 * nerf_macs * n)
  for n in warp_rows:
    x = encoding.posenc(randn(n, 3), model.num_warp_freqs, alpha=WARP_ALPHA)
    check(x.shape[1] == c_warp, 'warp encoding width')
    biases = [(i, randn(n, warp_ops.width).to(torch.bfloat16))
              for i in (0,) + warp_skips]
    yield dict(
        name='warp_trunk_forward', rows=n, with_bias=True,
        kernel=lambda x=x, b=biases: (fused_mlp.warp_trunk_forward(
            x, b, warp_params, trunk_depth=warp_depth, skips=warp_skips),),
        plain=lambda x=x, b=biases: (fused_mlp.warp_trunk_reference(
            x, b, warp_params, trunk_depth=warp_depth, skips=warp_skips),),
        library=lambda x=x, b=biases: (library_warp(
            x, b, warp_ops, warp_depth),),
        bytes=nbytes(x, *[b for _, b in biases]) + operand_bytes(warp_ops)
        + n * 8 * 4,
        flops=2 * warp_macs * n)


def _run_case(case, device_name):
  """Holds a kernel case against its plain version and times all three.

  Returns its max_abs_err, ms, plain_ms, library_ms, bound_ms, bound_by.
  """
  peak_flops, peak_bytes = peaks(device_name)
  got = case['kernel']()
  torch.cuda.synchronize()
  want = case['plain']()
  err = max(float((g - w).abs().max()) for g, w in zip(got, want))
  ok = all(torch.allclose(g, w, atol=KERNEL_ATOL, rtol=KERNEL_RTOL)
           for g, w in zip(got, want))
  lib_err = max(float((g - w).abs().max())
                for g, w in zip(case['library'](), want))
  del got, want
  ms = time_ms(case['kernel'], reps=5)
  plain_ms = time_ms(case['plain'], reps=3)
  library_ms = time_ms(case['library'], reps=5)
  flop_ms = case['flops'] / peak_flops * 1e3
  byte_ms = case['bytes'] / peak_bytes * 1e3
  bound_ms = max(flop_ms, byte_ms)
  print(f"  {case['name']} rows={case['rows']} bias={case['with_bias']}: "
        f'max_abs_err {err:.3g} (library {lib_err:.3g}), within '
        f'atol=rtol={KERNEL_ATOL}: {ok}; {ms:.3f} ms kernel, '
        f'{plain_ms:.3f} ms plain, {library_ms:.3f} ms library, bound '
        f'{bound_ms:.3f} ms ({flop_ms:.3f} ms ops, {byte_ms:.3f} ms bytes),'
        f' {case["flops"] / ms / 1e9:.1f} TFLOP/s')
  check(ok, f"{case['name']} rows={case['rows']} disagrees with its plain "
        f'version: max_abs_err {err}')
  return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
              library_ms=library_ms, bound_ms=bound_ms,
              bound_by='operations' if flop_ms >= byte_ms else 'bytes')


@torch.no_grad()
def phase_kernels(model, device, generator, device_name):
  peak_flops, peak_bytes = peaks(device_name)
  print(f'peaks used for bounds: {peak_flops / 1e12:.0f} TFLOP/s bf16, '
        f'{peak_bytes / 1e12:.2f} TB/s')
  results = {}
  fine_rows = CHUNK * (model.num_coarse_samples + model.num_fine_samples)
  for case in _kernel_cases(model, device, generator):
    numbers = _run_case(case, device_name)
    entry = results.setdefault(case['name'], {'max_abs_err': 0.0})
    entry['max_abs_err'] = max(entry['max_abs_err'], numbers['max_abs_err'])
    if case['rows'] == CHUNK * model.num_coarse_samples and case['with_bias']:
      # The coarse level's launch: the numbers the kernel line reports.
      entry.update(rows=case['rows'],
                   **{k: numbers[k] for k in ('ms', 'plain_ms', 'library_ms',
                                              'bound_ms', 'bound_by')})
    elif case['rows'] == fine_rows:
      entry.update(fine_rows=case['rows'], fine_ms=numbers['ms'],
                   fine_library_ms=numbers['library_ms'],
                   fine_bound_ms=numbers['bound_ms'])
  return results


def _compare_rows(got, want):
  """(max_abs_err, rows beyond atol = rtol = KERNEL_ATOL, rows allowed)."""
  bad = (~torch.isclose(got, want, atol=KERNEL_ATOL, rtol=KERNEL_RTOL)).any(1)
  allowed = max(1, int(MAX_FLIPPED_ROWS_FRAC * got.shape[0]))
  return float((got - want).abs().max()), int(bad.sum()), allowed


def _flat_tree(tree):
  """[('a/b', tensor)] of a nested dict of tensors."""
  return [('/'.join(path), t) for path, t in fused_mlp.flatten_tree(tree)]


def _check_backward(name, rows_got, rows_want, dw_got, dw_want):
  """Per-row outputs and dW leaves of a backward kernel vs its plain one."""
  worst = 0.0
  for i, (g, w) in enumerate(zip(rows_got, rows_want)):
    err, bad, allowed = _compare_rows(g, w)
    worst = max(worst, err)
    print(f'    {name} output {i}: max_abs_err {err:.3g}, {bad} of '
          f'{g.shape[0]} rows beyond atol=rtol={KERNEL_ATOL} (allowed '
          f'{allowed})')
    check(bad <= allowed, f'{name}: output {i} differs on {bad} rows')
  dw_want = dict(_flat_tree(dw_want))
  ratios = []
  for leaf, g in _flat_tree(dw_got):
    w = dw_want[leaf]
    err = float((g - w).abs().max())
    scale = float(w.abs().max())
    ratios.append((err / scale if scale else 0.0, leaf))
    check(err <= DW_MAX_REL * scale + 1e-6,
          f'{name}: dW {leaf} max_abs_err {err} > {DW_MAX_REL} x {scale}')
  ratio, leaf = max(ratios)
  print(f'    {name} dW: worst max|kernel - plain| / max|plain| = '
        f'{ratio:.3g} ({leaf}), bound {DW_MAX_REL}')
  return worst


def _same_bits(name, first, second):
  for (leaf, a), (_, b) in zip(_flat_tree(first), _flat_tree(second)):
    check(torch.equal(a, b), f'{name}: dW {leaf} differs between two runs')


@torch.no_grad()
def phase_train_kernels(model, device, generator, device_name):
  """The three training kernels at the bench step's row counts."""
  peak_flops, peak_bytes = peaks(device_name)
  params = model.params
  mlp = params['nerf_mlps_coarse']
  depth, skips = model.nerf_trunk_depth, model.nerf_skips
  nerf_ops = fused_mlp.pack_nerf_mlp(
      mlp, encoding.posenc_output_dim(3, model.num_nerf_point_freqs), depth,
      skips)
  nerf_macs = (sum(t.numel() for t in nerf_ops.trunk_w)
               + sum(t.numel() for t in nerf_ops.trunk_wx.values())
               + nerf_ops.bottleneck[0].numel()
               + nerf_ops.width * mlp['alpha_logit']['kernel'].shape[1]
               + nerf_ops.rgb_hidden[0].numel()
               + mlp['rgb_logit']['kernel'].numel())
  nerf_param_bytes = 4 * sum(t.numel() for _, t in _flat_tree(mlp))
  warp = params['warp_field']
  warp_depth = int(model.warp_kwargs.get('trunk_depth', 6))
  warp_skips = tuple(model.warp_kwargs.get('skips', (4,)))
  width = warp['trunk']['hidden_0']['kernel'].shape[1]
  # A Glorot head, as in the serving case: the 1e-4 init would hide errors.
  head = modules.mlp([width], 0, width, output_channels=6,
                     generator=torch.Generator().manual_seed(1))
  warp_params = {'trunk': warp['trunk'],
                 'head': {'logit': _tree_to(head, device)['logit']}}
  warp_param_bytes = 4 * sum(t.numel() for _, t in _flat_tree(warp_params))
  c_warp = encoding.posenc_output_dim(3, model.num_warp_freqs)
  f_embed = model.num_warp_features
  wops = fused_warp.pack(warp_params, c_warp, f_embed, warp_depth,
                         warp_skips)
  chain_macs = (sum(v.numel() for k, v in wops.items()
                    if k[0] == 'w' and k[1] != 'e' and k != 'wh')
                + warp_params['head']['logit']['kernel'].numel())
  embed_macs = sum(v.numel() for k, v in wops.items() if k.startswith('we'))
  # The backward's input cotangents without dx: the head and layers 1..
  data_macs = (warp_params['head']['logit']['kernel'].numel()
               + sum(wops[f'w{i}'].numel() for i in range(1, warp_depth)))
  nt = 3
  warp_fwd_macs = (1 + nt) * chain_macs + embed_macs
  warp_bwd_macs = 2 * warp_fwd_macs + (1 + nt) * data_macs + embed_macs

  def randn(*shape):
    return torch.randn(*shape, generator=generator, device=device)

  def bound(flops, nbytes_):
    flop_ms = flops / peak_flops * 1e3
    byte_ms = nbytes_ / peak_bytes * 1e3
    return max(flop_ms, byte_ms), ('operations' if flop_ms >= byte_ms
                                   else 'bytes')

  def report(name, rows, err, ms, plain_ms, library_ms, flops, nbytes_):
    bound_ms, bound_by = bound(flops, nbytes_)
    print(f'  {name} rows={rows}: {ms:.3f} ms kernel, {plain_ms:.3f} ms '
          f'plain, {library_ms:.3f} ms library, bound {bound_ms:.3f} ms '
          f'({bound_by}), {flops / ms / 1e9:.1f} TFLOP/s')
    return dict(max_abs_err=err, rows=rows, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)

  results = {}
  coarse = TRAIN_BATCH * model.num_coarse_samples
  fine = TRAIN_BATCH * (model.num_coarse_samples + model.num_fine_samples)
  c_pe = encoding.posenc_output_dim(3, model.num_nerf_point_freqs)
  for n in (coarse, fine):
    x = encoding.posenc(randn(n, 3), model.num_nerf_point_freqs).to(
        torch.bfloat16)
    rb = randn(n, nerf_ops.rgb_width).to(torch.bfloat16)
    ga, gr = randn(n, 8), randn(n, 8)
    kernel = lambda: fused_mlp.nerf_mlp_backward(
        x, rb, mlp, ga, gr, trunk_depth=depth, skips=skips)
    plain = lambda: fused_mlp.nerf_mlp_backward_reference(
        x, rb, mlp, ga, gr, trunk_depth=depth, skips=skips)
    got, again = kernel(), kernel()
    torch.cuda.synchronize()
    _same_bits('nerf_mlp_backward', got[2], again[2])
    del again
    want = plain()
    err = _check_backward(f'nerf_mlp_backward rows={n}', got[:2], want[:2],
                          got[2], want[2])
    del got, want
    ms = time_ms(kernel, reps=5)
    if n == coarse:
      plain_ms = time_ms(plain, reps=3)
      library_ms = time_ms(library_nerf_backward(x, rb, nerf_ops, depth, ga,
                                                 gr), reps=5)
      io_bytes = (nbytes(x, rb, ga, gr) + operand_bytes(nerf_ops)
                  + n * (c_pe + nerf_ops.rgb_width) * 4)
      results['nerf_mlp_backward'] = entry = report(
          'nerf_mlp_backward', n, err, ms, plain_ms, library_ms,
          2 * 3 * nerf_macs * n, io_bytes + nerf_param_bytes)
      # The two passes alone: the row pass writes the workspace that the
      # weight-gradient pass reads.
      passes, _ = fused_mlp._nerf_bwd_passes(x, rb, nerf_ops, depth, ga, gr)
      ws_bytes = n * 2 * (64 + 2 * (depth + 1) * nerf_ops.width
                          + 2 * nerf_ops.rgb_width + 32)
      for part, index, flops, part_bytes in (
          ('row_pass', 0, 2 * 2 * nerf_macs * n, io_bytes + ws_bytes),
          ('weight_pass', 1, 2 * nerf_macs * n, ws_bytes + nerf_param_bytes)):
        part_ms = time_ms(lambda: [p[index]() for p in passes], reps=5)
        part_bound, part_by = bound(flops, part_bytes)
        print(f'    {part}: {part_ms:.3f} ms, bound {part_bound:.3f} ms '
              f'({part_by}), {flops / part_ms / 1e9:.1f} TFLOP/s')
        entry.update({f'{part}_ms': part_ms, f'{part}_bound_ms': part_bound})
      del passes
    else:
      library_ms = time_ms(library_nerf_backward(x, rb, nerf_ops, depth, ga,
                                                 gr), reps=5)
      io_bytes = (nbytes(x, rb, ga, gr) + operand_bytes(nerf_ops)
                  + n * (c_pe + nerf_ops.rgb_width) * 4)
      bound_ms, bound_by = bound(2 * 3 * nerf_macs * n,
                                 io_bytes + nerf_param_bytes)
      print(f'  nerf_mlp_backward rows={n}: {ms:.3f} ms kernel, '
            f'{library_ms:.3f} ms library, bound {bound_ms:.3f} ms '
            f'({bound_by}), {2 * 3 * nerf_macs * n / ms / 1e9:.1f} TFLOP/s')
      entry = results['nerf_mlp_backward']
      entry['max_abs_err'] = max(err, entry['max_abs_err'])
      entry.update(fine_rows=n, fine_rows_ms=ms, fine_library_ms=library_ms,
                   fine_bound_ms=bound_ms)
    del x, rb, ga, gr, kernel, plain

  n = coarse
  pts = randn(n, 3)
  x, ts = encoding.posenc_with_tangents(pts, model.num_warp_freqs,
                                        alpha=WARP_ALPHA)
  e = 0.05 * torch.rand(n, f_embed, generator=generator, device=device)
  kernel = lambda: fused_warp.warp_mlp_forward(
      x, e, ts, warp_params, trunk_depth=warp_depth, skips=warp_skips)
  plain = lambda: fused_warp.warp_mlp_reference(
      x, e, ts, warp_params, trunk_depth=warp_depth, skips=warp_skips)
  got = kernel()
  torch.cuda.synchronize()
  want = plain()
  # The tangent chains pass through the primal's ReLU mask, so a flipped
  # mask shows in jouts as it does in a backward's rows.
  err = 0.0
  for i, (g, w) in enumerate(zip([got[0]] + list(got[1]),
                                 [want[0]] + list(want[1]))):
    e_i, bad, allowed = _compare_rows(g, w)
    err = max(err, e_i)
    print(f'    warp_mlp_forward rows={n} output {i}: max_abs_err {e_i:.3g}, '
          f'{bad} rows beyond atol=rtol={KERNEL_ATOL} (allowed {allowed})')
    check(bad <= allowed, f'warp_mlp_forward: output {i} differs on {bad} '
          'rows')
  del got, want
  weight_bytes = 2 * sum(v.numel() for v in wops.values())
  results['warp_mlp_forward'] = fwd_entry = report(
      'warp_mlp_forward', n, err, time_ms(kernel, reps=5),
      time_ms(plain, reps=3),
      time_ms(lambda: library_warp_train(x, e, ts, wops, warp_depth,
                                         warp_skips), reps=5),
      2 * warp_fwd_macs * n,
      nbytes(x, e, *ts) + 4 * n * 8 * 4 + weight_bytes)

  go = randn(n, 8)
  gjs = [randn(n, 8) for _ in range(nt)]
  kw = dict(trunk_depth=warp_depth, skips=warp_skips)

  def check_warp_backward(args):
    """Compared with dx and d_tangents (need_dx); dW twice, same bits."""
    rows = args[0].shape[0]
    got = fused_warp.warp_mlp_backward(*args, **kw, need_dx=True)
    again = fused_warp.warp_mlp_backward(*args, **kw, need_dx=True)
    torch.cuda.synchronize()
    want = fused_warp.warp_mlp_backward_reference(*args, **kw, need_dx=True)
    err = _check_backward(
        f'warp_mlp_backward rows={rows} tangents={len(args[2])}',
        [got[0], got[1]] + got[2], [want[0], want[1]] + want[2], got[3],
        want[3])
    _same_bits('warp_mlp_backward', got[3], again[3])
    return err

  # Timed as the path runs it (no dx). Bytes: the inputs and cotangents
  # read, d_embed written, the weights read and dW written.
  args = (x, e, ts, warp_params, go, gjs)
  err = check_warp_backward(args)
  io_bytes = nbytes(x, e, *ts, go, *gjs) + weight_bytes + n * f_embed * 4
  results['warp_mlp_backward'] = entry = report(
      'warp_mlp_backward', n, err,
      time_ms(lambda: fused_warp.warp_mlp_backward(*args, **kw,
                                                   need_dx=False), reps=5),
      time_ms(lambda: fused_warp.warp_mlp_backward_reference(
          *args, **kw, need_dx=False), reps=3),
      time_ms(library_warp_backward(x, e, ts, wops, warp_depth, warp_skips,
                                    go, gjs), reps=5),
      2 * warp_bwd_macs * n, io_bytes + warp_param_bytes)
  # The two passes alone: the row pass (recompute and input cotangents)
  # writes the workspace that the weight-gradient pass (dW) reads.
  passes, _ = fused_warp._bwd_passes(x, e, ts, go, gjs, wops, warp_depth,
                                     warp_skips, False)
  ws_bytes = n * fused_warp.bwd_workspace_row_bytes(nt, width, warp_depth)
  for part, index, flops, part_bytes in (
      ('row_pass', 0, 2 * (warp_bwd_macs - warp_fwd_macs) * n,
       io_bytes + ws_bytes),
      ('weight_pass', 1, 2 * warp_fwd_macs * n,
       ws_bytes + warp_param_bytes)):
    part_ms = time_ms(lambda: [p[index]() for p in passes], reps=5)
    part_bound, part_by = bound(flops, part_bytes)
    print(f'    {part}: {part_ms:.3f} ms, bound {part_bound:.3f} ms '
          f'({part_by}), {flops / part_ms / 1e9:.1f} TFLOP/s, '
          f'{len(passes)} chunks')
    entry.update({f'{part}_ms': part_ms, f'{part}_bound_ms': part_bound})
  del passes, args, x, e, ts, go, gjs, pts

  # The fine level's launches: no tangents, twice the rows.
  n = fine
  x = encoding.posenc(randn(n, 3), model.num_warp_freqs, alpha=WARP_ALPHA)
  e = 0.05 * torch.rand(n, f_embed, generator=generator, device=device)
  fine_fwd_macs = chain_macs + embed_macs
  kernel = lambda: fused_warp.warp_mlp_forward(x, e, [], warp_params, **kw)
  got = kernel()
  torch.cuda.synchronize()
  want = fused_warp.warp_mlp_reference(x, e, [], warp_params, **kw)
  e_fine, bad, allowed = _compare_rows(got[0], want[0])
  print(f'    warp_mlp_forward rows={n} output 0: max_abs_err {e_fine:.3g}, '
        f'{bad} rows beyond atol=rtol={KERNEL_ATOL} (allowed {allowed})')
  check(bad <= allowed, f'warp_mlp_forward rows={n}: differs on {bad} rows')
  del got, want
  fine_fwd = report(
      'warp_mlp_forward', n, e_fine, time_ms(kernel, reps=5),
      time_ms(lambda: fused_warp.warp_mlp_reference(x, e, [], warp_params,
                                                    **kw), reps=3),
      time_ms(lambda: library_warp_train(x, e, [], wops, warp_depth,
                                         warp_skips), reps=5),
      2 * fine_fwd_macs * n, nbytes(x, e) + n * 8 * 4 + weight_bytes)
  fwd_entry['max_abs_err'] = max(e_fine, fwd_entry['max_abs_err'])
  fwd_entry.update(fine_rows=n, fine_ms=fine_fwd['ms'],
                   fine_library_ms=fine_fwd['library_ms'],
                   fine_bound_ms=fine_fwd['bound_ms'])
  go = randn(n, 8)
  args = (x, e, [], warp_params, go, [])
  err = check_warp_backward(args)
  entry['max_abs_err'] = max(err, entry['max_abs_err'])
  fine_entry = report(
      'warp_mlp_backward', n, err,
      time_ms(lambda: fused_warp.warp_mlp_backward(*args, **kw,
                                                   need_dx=False), reps=5),
      time_ms(lambda: fused_warp.warp_mlp_backward_reference(
          *args, **kw, need_dx=False), reps=3),
      time_ms(library_warp_backward(x, e, [], wops, warp_depth, warp_skips,
                                    go, []), reps=5),
      2 * (2 * fine_fwd_macs + data_macs + embed_macs) * n,
      nbytes(x, e, go) + weight_bytes + n * f_embed * 4 + warp_param_bytes)
  entry.update(fine_rows=n, fine_rows_ms=fine_entry['ms'],
               fine_library_ms=fine_entry['library_ms'],
               fine_bound_ms=fine_entry['bound_ms'])
  return results


@torch.no_grad()
def phase_other_widths(model, device, generator):
  """The NeRF forward and backward at OTHER_NERF_WIDTHS vs plain."""
  mlp = model.params['nerf_mlps_coarse']
  depth, skips = model.nerf_trunk_depth, model.nerf_skips
  c_pe = encoding.posenc_output_dim(3, model.num_nerf_point_freqs)
  bench_width = mlp['trunk_hidden_0']['kernel'].shape[1]
  rgb_cond = mlp['rgb_hidden_0']['kernel'].shape[0] - bench_width
  alpha_cond = mlp['alpha_logit']['kernel'].shape[0] - bench_width
  n = OTHER_WIDTH_ROWS

  def randn(*shape):
    return torch.randn(*shape, generator=generator, device=device)

  worst = {}
  for width, rgb_width in OTHER_NERF_WIDTHS:
    params = _tree_to(modules.nerf_mlp(
        point_dims=c_pe, alpha_condition_dims=alpha_cond,
        rgb_condition_dims=rgb_cond, trunk_depth=depth, trunk_width=width,
        rgb_branch_width=rgb_width, skips=skips,
        generator=torch.Generator().manual_seed(width)), device)
    x = encoding.posenc(randn(n, 3), model.num_nerf_point_freqs)
    rb = randn(n, rgb_width).to(torch.bfloat16)
    kw = dict(trunk_depth=depth, skips=skips)
    got = fused_mlp.nerf_mlp_forward(x, rb, params, **kw)
    torch.cuda.synchronize()
    want = fused_mlp.nerf_mlp_reference(x, rb, params, **kw)
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    ok = all(torch.allclose(g, w, atol=KERNEL_ATOL, rtol=KERNEL_RTOL)
             for g, w in zip(got, want))
    print(f'  nerf_mlp_forward widths=({width}, {rgb_width}) rows={n}: '
          f'max_abs_err {err:.3g}, within atol=rtol={KERNEL_ATOL}: {ok}')
    check(ok, f'nerf_mlp_forward at ({width}, {rgb_width}) disagrees with '
          f'its plain version: max_abs_err {err}')
    worst['nerf_mlp_forward'] = max(err, worst.get('nerf_mlp_forward', 0.0))
    ga, gr = randn(n, 8), randn(n, 8)
    got = fused_mlp.nerf_mlp_backward(x, rb, params, ga, gr, **kw)
    again = fused_mlp.nerf_mlp_backward(x, rb, params, ga, gr, **kw)
    torch.cuda.synchronize()
    _same_bits('nerf_mlp_backward', got[2], again[2])
    want = fused_mlp.nerf_mlp_backward_reference(x, rb, params, ga, gr, **kw)
    err = _check_backward(
        f'nerf_mlp_backward widths=({width}, {rgb_width}) rows={n}', got[:2],
        want[:2], got[2], want[2])
    worst['nerf_mlp_backward'] = max(err, worst.get('nerf_mlp_backward', 0.0))
    del got, again, want
  return worst


def _request_rays(index, rng):
  h = w = IMAGE_SIZE
  d = rng.randn(h, w, 3).astype(np.float32)
  d /= np.linalg.norm(d, axis=-1, keepdims=True)
  ids = lambda value: np.full((h, w, 1), value, np.uint32)
  return {
      'origins': np.zeros((h, w, 3), np.float32),
      'directions': d,
      'metadata': {'warp': ids(3 * index + 1), 'camera': ids(index % 2),
                   'appearance': ids(index), 'time': np.zeros((h, w, 1),
                                                              np.float32)},
  }


def phase_serve(model, state, rng):
  render_fn = evaluation.make_render_fn(model)
  requests = [_request_rays(i, rng) for i in range(NUM_REQUESTS)]
  fused_mlp.reset_launch_counts()
  outs = [evaluation.render_image(state, rays, render_fn, chunk=CHUNK)
          for rays in requests]
  counts = fused_mlp.launch_counts()
  chunks = -(-IMAGE_SIZE * IMAGE_SIZE // CHUNK)
  levels = 2 if model.num_fine_samples > 0 else 1
  expected = NUM_REQUESTS * chunks * levels
  for i, out in enumerate(outs):
    print(f"  request {i}: {out['rays_per_sec']:.1f} rays/s, "
          f"{out['render_time'] * 1e3:.1f} ms")
    check(out['rgb'].shape == (IMAGE_SIZE, IMAGE_SIZE, 3), 'rgb shape')
    for key in ('rgb', 'depth', 'med_depth', 'acc'):
      check(out[key].shape[:2] == (IMAGE_SIZE, IMAGE_SIZE), f'{key} shape')
      check(np.isfinite(out[key]).all(), f'request {i}: {key} not finite')
    check((out['rgb'] >= 0).all() and (out['rgb'] <= 1).all(), 'rgb range')
    check((out['acc'] >= 0).all() and (out['acc'] <= 1 + 1e-4).all(),
          'acc range')
  print(f'  launches in serve: {counts} (expected {expected} of each '
        'serving kernel)')
  for name, count in counts.items():
    want = expected if name in SERVE_KERNELS else 0
    check(count == want, f'{name}: {count} launches, expected {want}')
  return counts, requests[0]


def phase_parity(model, state, rays):
  flat = {k: ({kk: vv.reshape(-1, vv.shape[-1])[:PARITY_RAYS]
               for kk, vv in v.items()} if isinstance(v, dict)
              else v.reshape(-1, v.shape[-1])[:PARITY_RAYS])
          for k, v in rays.items()}
  got = evaluation.make_render_fn(model)(state.params, flat,
                                         state.warp_extra)
  cpu_params = _tree_to(state.params, 'cpu')
  want = evaluation.make_render_fn(model, device='cpu')(
      cpu_params, flat, state.warp_extra)
  for level in want:
    for key in ('rgb', 'depth', 'med_depth', 'acc'):
      g = got[level][key].cpu().numpy()
      w = want[level][key].numpy()
      err = float(np.abs(g - w).max())
      ok = np.allclose(g, w, atol=RENDER_ATOL, rtol=RENDER_RTOL)
      print(f'  {level}/{key}: max_abs_err {err:.3g}, within atol '
            f'{RENDER_ATOL} rtol {RENDER_RTOL}: {ok}')
      check(ok, f'{level}/{key} differs from the CPU plain render')


def _train_model(config, seed, device):
  return nerf.construct_nerf(
      config, **configs.BENCH_RENDER_IDS,
      generator=torch.Generator().manual_seed(seed), device=device,
      use_warp_jacobian=True, use_weights=True)


TRAIN_KERNELS = ('nerf_mlp_forward', 'nerf_mlp_backward', 'warp_mlp_forward',
                 'warp_mlp_backward')
def phase_train(seed, device=torch.device('cuda', 0)):
  config, train_config = configs.bench_train_config()
  model, params = _train_model(config, seed, device)
  state = training.create_train_state(params,
                                      warp_alpha=configs.BENCH_WARP_ALPHA)
  step = training.make_train_step(model, train_config, device)
  batch = profiling.fake_batch(train_config.batch_size,
                               train_config.background_points_batch_size,
                               seed)
  scalars = training.ScalarParams(**configs.BENCH_TRAIN_SCALARS)
  generator = torch.Generator(device).manual_seed(seed)

  start = time.perf_counter()
  new_state, _ = step(generator, state, batch, scalars)
  torch.cuda.synchronize()
  print(f'  warm-up step: {(time.perf_counter() - start) * 1e3:.1f} ms')
  torch.cuda.reset_peak_memory_stats()
  fused_mlp.reset_launch_counts()
  times = []
  for _ in range(TRAIN_STEPS):
    start = time.perf_counter()
    new_state, stats = step(generator, new_state, batch, scalars)
    torch.cuda.synchronize()
    times.append((time.perf_counter() - start) * 1e3)
  counts = fused_mlp.launch_counts()
  peak_gb = torch.cuda.max_memory_allocated() / 2**30
  print(f'  launches in {TRAIN_STEPS} steps: {counts}')
  for name, want in TRAIN_STEP_LAUNCHES.items():
    check(counts[name] == want * TRAIN_STEPS,
          f'{name}: {counts[name]} launches in {TRAIN_STEPS} steps, expected '
          f'{want * TRAIN_STEPS}')
  flat_stats = dict(_flat_tree(stats))
  for key, value in flat_stats.items():
    check(bool(torch.isfinite(value)), f'train stat {key} is not finite')
  print('  stats of the last step: ' + ', '.join(
      f'{k} {float(v):.5g}' for k, v in flat_stats.items()))
  before = dict(_flat_tree(state.params))
  changed = [k for k, v in _flat_tree(new_state.params)
             if not torch.equal(v, before[k])]
  unchanged = sorted(set(before) - set(changed))
  print(f'  params changed: {len(changed)} of {len(before)} leaves; '
        f'unchanged: {unchanged}')
  check(all(k.startswith('appearance_encoder') for k in unchanged),
        f'params that should train did not change: {unchanged}')
  step_ms = float(np.median(times))
  print(f'  step times: {[round(t, 2) for t in times]} ms; median '
        f'{step_ms:.2f} ms, {train_config.batch_size / step_ms * 1e3:.1f} '
        f'rays/s; max_memory_allocated {peak_gb:.2f} GiB')
  try:
    prof = profiling.profile(
        lambda: step(generator, new_state, batch, scalars), device)
    print(f'  profiled step: {prof.wall_ms:.2f} ms wall, {prof.busy_ms:.2f} '
          f'ms device busy ({profiling.idle_share(prof.busy_ms, step_ms):.3f}'
          f' idle share against the median step); kernels of the port '
          f'{sum(prof.ours.values()):.2f} ms: '
          + ', '.join(f'{k} {v:.2f}' for k, v in prof.ours.items()))
  except Exception as e:  # the breakdown is a reading, not a check
    print(f'  profiled step: not measured ({type(e).__name__}: {e})')
  return counts, dict(step_ms=step_ms, peak_gb=peak_gb)


def _grad_check(got, want, tag):
  """Per-leaf cosine and norm ratio, as tests/test_fused_train.py:166-182."""
  got, want = dict(_flat_tree(got)), dict(_flat_tree(want))
  ref = max(float(w.double().norm()) for w in want.values())
  worst = (1.0, 1.0, '')
  for leaf, w in want.items():
    a, b = got[leaf].double().ravel(), w.double().ravel()
    na, nb = float(a.norm()), float(b.norm())
    if max(na, nb) < 1e-4 * ref:
      continue
    cos = float(a @ b) / (na * nb)
    ratio = (na + 1e-12) / (nb + 1e-12)
    worst = min(worst, (cos, ratio, leaf))
    check(cos > GRAD_COSINE, f'{tag} {leaf}: cosine {cos}')
    check(GRAD_NORM_RATIO[0] < ratio < GRAD_NORM_RATIO[1],
          f'{tag} {leaf}: norm ratio {ratio}')
  print(f'  {tag}: lowest cosine {worst[0]:.5f} ({worst[2]}, norm ratio '
        f'{worst[1]:.4f})')


def phase_train_parity(seed, device=torch.device('cuda', 0)):
  config, train_config = configs.bench_train_config()
  config = dataclasses.replace(config, use_stratified_sampling=False)
  model, params = _train_model(config, seed, device)
  batch = profiling.fake_batch(PARITY_TRAIN_RAYS, PARITY_BACKGROUND_POINTS,
                               seed + 1)
  rng = np.random.RandomState(seed + 2)
  ids = np.asarray(model.warp_ids)[rng.randint(
      0, len(model.warp_ids), (PARITY_BACKGROUND_POINTS, 1))]
  noise = rng.randn(PARITY_BACKGROUND_POINTS, 3).astype(np.float32)
  scalars = training.ScalarParams(**configs.BENCH_TRAIN_SCALARS)
  out = {}
  for name, dev in (('card', device), ('cpu', torch.device('cpu'))):
    state = training.create_train_state(
        _tree_to(params, dev), warp_alpha=configs.BENCH_WARP_ALPHA)
    step = training.make_train_step(model, train_config, device=dev)
    draws = (torch.from_numpy(ids).to(dev), torch.from_numpy(noise).to(dev))
    start = time.perf_counter()
    new_state, stats = step(None, state, batch, scalars, draws)
    print(f'  {name} step: {(time.perf_counter() - start):.2f} s')
    out[name] = (dict(_flat_tree(stats)), new_state.opt_state.mu)
  stats_card, stats_cpu = out['card'][0], out['cpu'][0]
  for key, want in stats_cpu.items():
    got = float(stats_card[key])
    want = float(want)
    ok = abs(got - want) <= STATS_ATOL + STATS_RTOL * abs(want)
    print(f'  {key}: card {got:.6g}, cpu {want:.6g}')
    check(ok, f'train stat {key}: card {got} vs cpu {want}')
  # The first Adam moment of a step from zero moments is 0.1 x gradient.
  _grad_check(_tree_to(out['card'][1], 'cpu'), out['cpu'][1],
              'gradients (card vs cpu)')


def _plain_config(**overrides):
  """The ModelConfig and TrainConfig of PLAIN_GIN, with `overrides`."""
  _, model_config, train_config = train_cli.parse_configs([PLAIN_GIN])
  return dataclasses.replace(model_config, **overrides), train_config


def _flat_rays(rays, count):
  """The first `count` rays of an (H, W, ...) request, flat."""
  return {k: (_flat_rays(v, count) if isinstance(v, dict)
              else v.reshape(-1, v.shape[-1])[:count])
          for k, v in rays.items()}


def _compare(tag, got, want, keys, atol, rtol):
  for level in want:
    for key in keys:
      g = got[level][key].float().cpu().numpy()
      w = want[level][key].float().cpu().numpy()
      err = float(np.abs(g - w).max())
      ok = np.allclose(g, w, atol=atol, rtol=rtol)
      print(f'  {tag} {level}/{key}: max_abs_err {err:.3g}, within atol '
            f'{atol} rtol {rtol}: {ok}')
      check(ok, f'{tag}: {level}/{key} differs')


def _check_no_launches(tag, counts):
  check(not any(counts.values()), f'{tag} launched kernels: {counts}')


def phase_model(seed, rays, device=torch.device('cuda', 0)):
  """The plain forward against the CPU and the serving kernels, a fused
  step with the plain warp, and a render through either route."""
  check(not torch.backends.cuda.matmul.allow_tf32,
        'TF32 matmuls are on: the plain route is float32')
  config, _ = _plain_config(use_stratified_sampling=False)
  check(not (config.use_fused_mlp or config.use_bfloat16),
        f'{PLAIN_GIN} is not the float32 plain route')
  model, params = nerf.construct_nerf(
      config, **configs.BENCH_RENDER_IDS,
      generator=torch.Generator().manual_seed(seed), device=device,
      use_warp_jacobian=True)
  check(not model.fused_route, 'the model takes the fused route')
  flat = _flat_rays(rays, MODEL_RAYS)
  fused_mlp.reset_launch_counts()
  with torch.no_grad():
    got = model(params, utils.to_device(flat, device), WARP_EXTRA)
    torch.cuda.synchronize()
    _check_no_launches('the plain forward', fused_mlp.launch_counts())
    want = model(_tree_to(params, 'cpu'),
                 utils.to_device(flat, torch.device('cpu')),
                 WARP_EXTRA)
  _compare('f32 card vs cpu', got, want, ('rgb', 'depth', 'acc'),
           MODEL_ATOL, MODEL_RTOL)
  jac_err = float((got['coarse']['warp_jacobian'].cpu()
                   - want['coarse']['warp_jacobian']).abs().max())
  print(f'  f32 card vs cpu coarse/warp_jacobian: max_abs_err {jac_err:.3g} '
        f'(atol {MODEL_JACOBIAN_ATOL})')
  check(jac_err <= MODEL_JACOBIAN_ATOL, 'the warp Jacobian differs')
  del got, want

  model16, params16 = nerf.construct_nerf(
      dataclasses.replace(config, use_bfloat16=True),
      **configs.BENCH_RENDER_IDS,
      generator=torch.Generator().manual_seed(seed), device=device)
  rays_dev = utils.to_device(flat, device)
  with torch.no_grad():
    plain = model16(params16, rays_dev, WARP_EXTRA)
  fused = fast_render.render_rays(params16, rays_dev, WARP_EXTRA, model16)
  _compare('bf16 plain vs serving kernels', plain, fused,
           ('rgb', 'depth', 'acc'), RENDER_ATOL, RENDER_RTOL)
  del model16, params16, plain, fused

  counts = _plain_warp_step(seed, device)

  state = evaluation.RenderState(params, warp_alpha=WARP_ALPHA)
  off = evaluation.make_render_fn(model, device=device, fast='off')
  auto = evaluation.make_render_fn(model, device=device)
  check(auto.fast and not off.fast, 'render routes')
  fused_mlp.reset_launch_counts()
  plain_out = evaluation.render_image(state, rays, off, chunk=CHUNK)
  _check_no_launches("render_image with fast='off'",
                     fused_mlp.launch_counts())
  fast_out = evaluation.render_image(state, rays, auto, chunk=CHUNK)
  print(f"  [{card_label()}] {IMAGE_SIZE}x{IMAGE_SIZE} request, chunk "
        f"{CHUNK}: fast='off' {plain_out['rays_per_sec']:.1f} rays/s, "
        f"fast='auto' {fast_out['rays_per_sec']:.1f} rays/s")
  _compare("render fast='off' vs 'auto'",
           {'fine': {k: torch.from_numpy(v) for k, v in plain_out.items()
                     if k in ('rgb', 'depth', 'acc')}},
           {'fine': {k: torch.from_numpy(v) for k, v in fast_out.items()
                     if k in ('rgb', 'depth', 'acc')}},
           ('rgb', 'depth', 'acc'), RENDER_ATOL, RENDER_RTOL)
  return counts


def _plain_warp_step(seed, device):
  """One bench-workload step with use_fused_warp=False (after a warm-up),
  with the counts set to 0 just before it and read just after."""
  config, train_config = configs.bench_train_config()
  model, params = _train_model(
      dataclasses.replace(config, use_fused_warp=False), seed, device)
  check(model.fused_route and not model.use_fused_warp, 'route')
  step = training.make_train_step(model, train_config, device)
  batch = profiling.fake_batch(train_config.batch_size,
                               train_config.background_points_batch_size,
                               seed)
  scalars = training.ScalarParams(**configs.BENCH_TRAIN_SCALARS)
  generator = torch.Generator(device).manual_seed(seed)
  state = training.create_train_state(params,
                                      warp_alpha=configs.BENCH_WARP_ALPHA)
  state, _ = step(generator, state, batch, scalars)
  torch.cuda.synchronize()
  fused_mlp.reset_launch_counts()
  start = time.perf_counter()
  state, stats = step(generator, state, batch, scalars)
  torch.cuda.synchronize()
  step_ms = (time.perf_counter() - start) * 1e3
  counts = fused_mlp.launch_counts()
  print(f'  fused step with the plain warp: {step_ms:.2f} ms; launches '
        f'{counts}')
  for name, want in PLAIN_WARP_STEP_LAUNCHES.items():
    check(counts[name] == want, f'{name}: {counts[name]} launches, '
          f'expected {want}')
  for key, value in _flat_tree(stats):
    check(bool(torch.isfinite(value)), f'stat {key} is not finite')
  return counts


def _matmul_split(ops):
  """(ms in matmul kernels, ms in the rest) of profiled device ops."""
  matmul = sum(ms for name, ms in ops
               if any(mark in name.lower() for mark in MATMUL_MARKS))
  return matmul, sum(ms for _, ms in ops) - matmul


def phase_cli_plain(train_step_ms, work, device=torch.device('cuda', 0)):
  """PLAIN_GIN through the training CLI at full width on the cli phase's
  capture: run, resumed; then the gathered median in a fresh run."""
  card = card_label()

  def run(exp, max_steps, *bindings):
    argv = ['--base_folder', str(exp), '--data_dir', str(work / 'scene'),
            '--gin_configs', PLAIN_GIN, '--device', str(device)]
    for binding in ('ExperimentConfig.image_scale = 1',
                    f'TrainConfig.max_steps = {max_steps}',
                    f'TrainConfig.save_every = {CLI_PLAIN_FIRST}',
                    'TrainConfig.print_every = 1',
                    'TrainConfig.log_every = 1000000',
                    'TrainConfig.histogram_every = 1000000') + bindings:
      argv += ['--gin_bindings', binding]
    return train_cli.main(argv)

  exp = work / 'exp_plain'
  fused_mlp.reset_launch_counts()
  torch.cuda.reset_peak_memory_stats()
  first = run(exp, CLI_PLAIN_FIRST)
  check(not first.setup.model.fused_route, f'{PLAIN_GIN} took the fused '
        'route')
  second = run(exp, CLI_PLAIN_LAST)
  peak_gb = torch.cuda.max_memory_allocated() / 2**30
  check(second.setup.init_step == CLI_PLAIN_FIRST + 1,
        f'the second run starts at {second.setup.init_step}')
  check(_same_state(second.setup.state, first.state),
        'the restored state differs from the saved one')
  print(f'  resumed at step {second.setup.init_step}; the restored state '
        'equals the saved one bit for bit')
  for result in (first, second):
    for key, value in _flat_tree(result.stats):
      check(np.isfinite(value), f'cli_plain stat {key} is {value}')
  print('  stats of the last step: ' + ', '.join(
      f'{k} {v:.5g}' for k, v in _flat_tree(second.stats)))
  batch = first.setup.train_config.batch_size
  step_s = [v for r in (first, second)
            for v in r.time_tracker.values('train_step')]
  step_ms = float(np.median(step_s)) * 1e3
  print(f'  [{card}] plain CLI train_step median {step_ms:.2f} ms over '
        f'{len(step_s)} steps ({[round(v * 1e3, 2) for v in step_s]}), '
        f'{batch / step_ms * 1e3:.1f} rays/s; max_memory_allocated '
        f'{peak_gb:.2f} GiB; against the fused train phase: '
        f'{step_ms - train_step_ms:+.2f} ms ({step_ms / train_step_ms:.2f}x)')

  model = second.setup.model
  step = training.make_train_step(model, second.setup.train_config, device)
  id_counts = tuple(max(ids, default=0) + 1 for ids in (
      model.warp_ids, model.camera_ids, model.appearance_ids))
  fake = profiling.fake_batch(batch, CLI_POINTS, 0, id_counts)
  scalars = second.setup.scalar_params
  try:
    prof = profiling.profile(
        lambda: step(training.step_generator(0, 1, device), second.state,
                     fake, scalars), device)
    ops = prof.top_kernels()
    matmul_ms, rest_ms = _matmul_split(ops)
    print(f'  [{card}] profiled plain step: {prof.wall_ms:.2f} ms wall, '
          f'{prof.busy_ms:.2f} ms device busy '
          f'({profiling.idle_share(prof.busy_ms, step_ms):.3f} idle share '
          f'against the median step), {prof.device_ops} device ops; matmul '
          f'kernels {matmul_ms:.2f} ms, the rest {rest_ms:.2f} ms; largest: '
          + ', '.join(f'{name[:60]} {ms:.2f}' for name, ms in ops[:6]))
    print(f'  [{card}] profiled plain step by op (device ms of its own '
          'launches): ' + ', '.join(f'{name} {ms:.2f}'
                                    for name, ms, _ in prof.top_ops(12)))
  except Exception as e:  # the breakdown is a reading, not a check
    print(f'  profiled plain step: not measured ({type(e).__name__}: {e})')

  median = run(work / 'exp_median', CLI_MEDIAN_STEPS,
               "TrainConfig.elastic_reduce_method = 'median'")
  counts = fused_mlp.launch_counts()
  check(not median.setup.model.use_warp_jacobian,
        'the median run computes dense Jacobians')
  elastic = float(median.stats['coarse']['loss/elastic'])
  print(f'  gathered median, {CLI_MEDIAN_STEPS} steps: loss/elastic '
        f'{elastic:.6g}, median train_step '
        f'{np.median(median.time_tracker.values("train_step")) * 1e3:.2f} ms')
  check(np.isfinite(elastic), f'loss/elastic is {elastic}')
  print(f'  launches in the plain CLI runs: {counts}')
  _check_no_launches('the plain route', counts)
  return counts


def card_label():
  """The card's name and power limit, as nvidia-smi reads them."""
  smi = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
      capture_output=True, text=True, timeout=60, check=True)
  return smi.stdout.strip().splitlines()[0]


def _same_state(got, want):
  """Whether two TrainStates are equal bit for bit."""
  def leaves(state):
    return dict(_flat_tree({'params': state.params, 'mu': state.opt_state.mu,
                            'nu': state.opt_state.nu}))
  a, b = leaves(got), leaves(want)
  return ((got.step, got.opt_state.count, got.warp_alpha, got.time_alpha)
          == (want.step, want.opt_state.count, want.warp_alpha,
              want.time_alpha)
          and a.keys() == b.keys()
          and all(torch.equal(a[k], b[k]) for k in b))


def write_capture(scene):
  """The synthetic capture that the cli, eval and ddp phases read."""
  start = time.perf_counter()
  synthetic.write_synthetic_dataset(
      scene, num_train=CLI_FRAMES[0], num_val=CLI_FRAMES[1],
      image_size=CLI_IMAGE_SIZE, num_points=CLI_POINTS,
      motion_amplitude=0.05, texture_frequency=8.0, env_background=True)
  print(f'  wrote the capture in {time.perf_counter() - start:.2f} s')


def phase_cli(train_step_ms, work):
  """The training CLI on a synthetic capture, run, saved and resumed.

  The capture and the experiment stay in `work` for the eval phase.
  """
  card = card_label()
  scene, exp = work / 'scene', work / 'exp'
  write_capture(scene)
  frame = scene / 'rgb' / '1x' / '0000.png'
  decode = []
  for _ in range(3):
    start = time.perf_counter()
    image_utils.load_image(frame)
    decode.append(time.perf_counter() - start)

  def run(max_steps):
    argv = ['--base_folder', str(exp), '--data_dir', str(scene),
            '--gin_configs', CLI_GIN]
    for binding in ('ExperimentConfig.image_scale = 1',
                    f'TrainConfig.max_steps = {max_steps}',
                    f'TrainConfig.save_every = {CLI_SAVE_EVERY}',
                    'TrainConfig.print_every = 1',
                    'TrainConfig.log_every = 1000000',
                    'TrainConfig.histogram_every = 1000000'):
      argv += ['--gin_bindings', binding]
    return train_cli.main(argv)

  def kept():
    return sorted(int(p.name) for p in (exp / 'checkpoints').iterdir())

  fused_mlp.reset_launch_counts()
  first = run(CLI_FIRST_STEPS)
  check(first.setup.init_step == 1 and first.state.step == CLI_FIRST_STEPS,
        f'first run: steps {first.setup.init_step}..{first.state.step}')
  check(kept() == [CLI_SAVE_EVERY, CLI_FIRST_STEPS],
        f'checkpoints after the first run: {kept()}')
  second = run(CLI_LAST_STEP)
  counts = fused_mlp.launch_counts()
  check(second.setup.init_step == CLI_FIRST_STEPS + 1,
        f'the second run starts at {second.setup.init_step}, not at '
        f'{CLI_FIRST_STEPS + 1}')
  check(_same_state(second.setup.state, first.state),
        'the restored state differs from the saved one')
  print(f'  resumed at step {second.setup.init_step}; the restored state '
        'equals the saved one bit for bit')
  # Saved at 8 (save_every) and 10 (the end); the 2 newest are kept.
  check(kept() == [8, CLI_LAST_STEP],
        f'checkpoints after the second run: {kept()}')
  print(f'  checkpoints kept: {kept()}')
  for result in (first, second):
    for key, value in _flat_tree(result.stats):
      check(np.isfinite(value), f'cli stat {key} is {value}')
  print('  stats of the last step: ' + ', '.join(
      f'{k} {v:.5g}' for k, v in _flat_tree(second.stats)))
  print(f'  launches in {CLI_LAST_STEP} CLI steps: {counts}')
  for name, want in TRAIN_STEP_LAUNCHES.items():
    check(counts[name] == want * CLI_LAST_STEP,
          f'{name}: {counts[name]} launches in {CLI_LAST_STEP} CLI steps, '
          f'expected {want * CLI_LAST_STEP}')

  batch = first.setup.train_config.batch_size
  step_s = [v for r in (first, second)
            for v in r.time_tracker.values('train_step')]
  data_s = [v for r in (first, second) for v in r.time_tracker.values('data')]
  step_ms = float(np.median(step_s)) * 1e3
  print(f'  [{card}] CLI train_step median {step_ms:.2f} ms over '
        f'{len(step_s)} steps ({[round(v * 1e3, 2) for v in step_s]}), '
        f'{batch / step_ms * 1e3:.1f} rays/s; data median '
        f'{float(np.median(data_s)) * 1e3:.2f} ms '
        f'({[round(v * 1e3, 2) for v in data_s]})')
  print(f'  [{card}] gap to the train phase: {step_ms - train_step_ms:.2f} '
        f'ms a step ({step_ms:.2f} against {train_step_ms:.2f} ms)')
  # The same pool built in one thread, beside the CLI's thread pool.
  source = first.setup.datasource
  start = time.perf_counter()
  core.RayPool.from_items([source.get_item(i) for i in source.train_ids])
  one_thread_s = time.perf_counter() - start
  print(f'  [{card}] PNG decode of one {CLI_IMAGE_SIZE[0]}x'
        f'{CLI_IMAGE_SIZE[1]} frame: {min(decode) * 1e3:.2f} ms (best of '
        f'3); ray pool of {CLI_FRAMES[0]} frames built in '
        f'{first.setup.timings["ray_pool"]:.2f} s by the CLI\'s thread '
        f'pool, {one_thread_s:.2f} s in one thread')
  saves_ms = [v * 1e3 for r in (first, second) for v in r.save_seconds]
  print(f'  [{card}] checkpoint save {[round(v, 1) for v in saves_ms]} ms, '
        f'restore {second.setup.timings["restore"] * 1e3:.1f} ms')
  return counts


def _eval_model(scene, exp, device, fast_preview=False):
  """The eval CLI's model at the newest checkpoint of `exp`, the capture's
  datasource, the render state and the EvalConfig (the set-up of
  nerfies_tpu_torch.eval)."""
  exp_config, model_config, train_config, eval_config = (
      eval_cli.parse_configs([CLI_GIN], ['ExperimentConfig.image_scale = 1'],
                             fast_preview))
  if fast_preview:
    model_config.num_coarse_samples = eval_config.num_coarse_samples
    model_config.num_fine_samples = eval_config.num_fine_samples
  source = datasets.from_config(
      {'type': 'nerfies', 'data_dir': str(scene)}, image_scale=1,
      use_appearance_id=model_config.use_appearance_metadata,
      use_camera_id=model_config.use_camera_metadata,
      use_warp_id=model_config.use_warp, use_time=False,
      random_seed=exp_config.random_seed)
  model, params = nerf.construct_nerf(
      model_config, appearance_ids=source.appearance_ids,
      camera_ids=source.camera_ids, warp_ids=source.warp_ids,
      near=source.near, far=source.far,
      generator=torch.Generator().manual_seed(exp_config.random_seed),
      device=device)
  state = checkpoints.restore_checkpoint(
      exp / 'checkpoints', training.create_train_state(params))
  alpha = schedules.from_config(train_config.warp_alpha_schedule)(state.step)
  return (model, source,
          evaluation.RenderState(state.params, warp_alpha=float(alpha)),
          eval_config)


def _smooth_pair():
  """The smooth, low-variance pair of tests/test_evaluation.py:198."""
  yy, xx = np.mgrid[0:192, 0:192].astype(np.float32) / 192.0
  img0 = np.stack([0.6 + 0.01 * xx, 0.6 + 0.01 * yy,
                   np.full_like(xx, 0.6)], axis=-1)
  img1 = np.clip(img0 + 1e-3 * np.random.RandomState(4).randn(192, 192, 3),
                 0, 1).astype(np.float32)
  return img0, img1


def _compare_maps(tag, got, want, atol, rtol):
  for key in ('rgb', 'depth', 'med_depth', 'acc'):
    err = float(np.abs(got[key] - want[key]).max())
    ok = np.allclose(got[key], want[key], atol=atol, rtol=rtol)
    print(f'  {tag} {key}: max_abs_err {err:.3g}, within atol {atol} rtol '
          f'{rtol}: {ok}')
    check(ok, f'{tag}: {key} differs')


@torch.no_grad()
def phase_eval(work, device_name, device=torch.device('cuda', 0)):
  """The eval CLI twice on the cli phase's experiment, then the checks of
  its path on the card. Returns the launches of both runs and the kernel
  cases at the eval path's rows."""
  card = card_label()
  scene, exp = work / 'scene', work / 'exp'
  renders = exp / 'renders'
  # A stale render directory: max_render_checkpoints = 1 rotates it away.
  (renders / '4').mkdir(parents=True)
  num_rays = CLI_IMAGE_SIZE[0] * CLI_IMAGE_SIZE[1]
  chunks = -(-num_rays // CHUNK)
  counts, results = {}, {}
  for run, extra in (('unculled', []), ('culled', ['--fast_preview'])):
    argv = ['--base_folder', str(exp), '--data_dir', str(scene),
            '--gin_configs', CLI_GIN, *extra]
    for binding in EVAL_BINDINGS:
      argv += ['--gin_bindings', binding]
    fused_mlp.reset_launch_counts()
    result = eval_cli.main(argv)
    got = fused_mlp.launch_counts()
    results[run] = result
    check(list(result.metrics) == [CLI_LAST_STEP],
          f'{run}: evaluated steps {list(result.metrics)}')
    tags = [tag for _, tag, _, _ in result.frames]
    check(tags == ['val'] * 2 + ['train'] * 2 + ['test'] * 2,
          f'{run}: frames {tags}')
    bake_chunks = 0
    if extra:
      check(len(result.bakes) == 1, f'{run}: {len(result.bakes)} bakes')
      bake_chunks = -(-result.bakes[0]['resolution'] ** 3 // EVAL_BAKE_CHUNK)
    per_frame = chunks * 2  # coarse and fine
    want = {name: 0 for name in got}
    want['warp_trunk_forward'] = len(result.frames) * per_frame
    want['nerf_mlp_forward'] = len(result.frames) * per_frame + bake_chunks
    print(f'  {run}: launches {got}, expected {want}')
    check(got == want, f'{run}: launches {got}, expected {want}')
    for name, count in got.items():
      counts[name] = counts.get(name, 0) + count
    for tag in ('val', 'train'):
      metrics = result.metrics[CLI_LAST_STEP][tag]
      for key in ('psnr', 'ms_ssim', 'lpips_uncal'):
        check(np.isfinite(metrics.get(key, np.nan)),
              f'{run} {tag}: {key} = {metrics.get(key)}')
    check(sorted(p.name for p in renders.iterdir()) == [str(CLI_LAST_STEP)],
          f'{run}: render dirs {sorted(p.name for p in renders.iterdir())}')
    for _, tag, item, _ in result.frames:
      for name in ('rgb.png', 'depth_median.png', 'depth_median_raw.png',
                   'acc.png'):
        path = renders / str(CLI_LAST_STEP) / tag / item / name
        check(path.is_file(), f'{run}: {path} not written')
    for _, tag, item, stats in result.frames:
      print(f"  [{card}] {run} {tag}/{item}: render_time "
            f"{stats['render_time'] * 1e3:.1f} ms, "
            f"{stats['rays_per_sec']:.1f} rays/s")
    for bake in result.bakes:
      print(f"  [{card}] {run} occupancy bake at {bake['resolution']}^3: "
            f"{bake['seconds']:.3f} s, {bake['occupied']:.4f} occupied")
    print(f'  [{card}] {run} val: ' + ', '.join(
        f'{k} {v:.5g}' for k, v in result.metrics[CLI_LAST_STEP]['val'].items()))

  # The render-video CLI on the same checkpoint (outside the counts).
  start = time.perf_counter()
  frames = render_video.main(
      ['--base_folder', str(exp), '--data_dir', str(scene), '--gin_configs',
       CLI_GIN, '--gin_bindings', 'ExperimentConfig.image_scale = 1',
       '--camera_path', 'orbit-mild', '--chunk', str(CHUNK), '--output_dir',
       str(work / 'video')])
  check(len(frames) == 6, f'render_video wrote {len(frames)} frames, not 6')
  for path in frames:
    shape = image_utils.load_image(path).shape
    check(shape == (CLI_IMAGE_SIZE[1], CLI_IMAGE_SIZE[0], 3),
          f'{path.name}: shape {shape}')
  print(f'  [{card}] render_video: {len(frames)} PNG frames in '
        f'{time.perf_counter() - start:.2f} s')

  model, source, state, _ = _eval_model(scene, exp, device)
  item_id = source.val_ids[0]
  item = source.get_item(item_id)
  camera = source.load_camera(item_id)
  h, w = camera.image_shape
  render_fn = evaluation.make_render_fn(model, device=device)
  on_card = evaluation.render_camera(state, camera, item['metadata'],
                                     render_fn, chunk=CHUNK)
  rays = core.camera_to_rays(camera)
  rays.pop('pixels')
  rays['metadata'] = {k: np.full((h, w, 1), v, np.uint32)
                      for k, v in item['metadata'].items()}
  on_host = evaluation.render_image(state, rays, render_fn, chunk=CHUNK)
  print(f"  [{card}] one frame: render_camera {on_card['render_time'] * 1e3:.1f}"
        f" ms, render_image of host rays {on_host['render_time'] * 1e3:.1f} ms")
  _compare_maps('render_camera vs render_image', on_card, on_host,
                RENDER_ATOL, RENDER_RTOL)
  grid = occupancy.OccupancyGrid(
      occupied=torch.ones((8, 8, 8), dtype=torch.bool, device=device),
      bbox_min=torch.full((3,), -1e3, device=device),
      bbox_max=torch.full((3,), 1e3, device=device))
  every = (model.num_coarse_samples,
           model.num_coarse_samples + model.num_fine_samples)
  culled = evaluation.render_camera(
      state, camera, item['metadata'],
      evaluation.make_render_fn(model, device=device, occupancy=grid,
                                keep_samples=every),
      chunk=CHUNK)
  _compare_maps(f'all-occupied grid, keep {every}', culled, on_card,
                CULL_NOOP_ATOL, 0.0)

  img0, img1 = _smooth_pair()
  cpu_ms = float(ssim.multiscale_ssim(img0, img1))
  card_ms = float(ssim.multiscale_ssim(torch.from_numpy(img0).to(device),
                                       torch.from_numpy(img1).to(device)))
  print(f'  MS-SSIM of the smooth pair: card {card_ms:.8f}, cpu {cpu_ms:.8f}')
  check(card_ms <= 1.0 + 1e-6, f'MS-SSIM {card_ms} above 1 on the card')
  check(abs(card_ms - cpu_ms) <= MSSSIM_CPU_ATOL,
        f'MS-SSIM card {card_ms} vs cpu {cpu_ms}')
  target = image_utils.image_to_float32(item['rgb'][..., :3])
  card_lpips = lpips.LPIPS(device=device)(target, on_card['rgb'])
  cpu_lpips = lpips.LPIPS(device='cpu')(target, on_card['rgb'])
  print(f'  LPIPS (uncalibrated) of a val render: card {card_lpips:.8f}, '
        f'cpu {cpu_lpips:.8f}')
  check(abs(card_lpips - cpu_lpips) <= LPIPS_CPU_RTOL * abs(cpu_lpips),
        f'LPIPS card {card_lpips} vs cpu {cpu_lpips}')

  # Where a frame's time goes: one unculled and one culled frame (a grid
  # baked as --fast_preview bakes it), profiled.
  fast_model, _, fast_state, fast_config = _eval_model(scene, exp, device,
                                                       fast_preview=True)
  grid, _ = eval_cli.bake_occupancy(fast_state.params, fast_model, source,
                                    fast_config, device)
  culled_fn = evaluation.make_render_fn(fast_model, device=device,
                                        occupancy=grid,
                                        keep_samples=CULLED_KEEP)
  for run, frame_state, fn, chunk in (
      ('unculled', state, render_fn, CHUNK),
      ('culled', fast_state, culled_fn, CHUNK),
      (f'culled chunk {PROFILE_BIG_CHUNK}', fast_state, culled_fn,
       PROFILE_BIG_CHUNK)):
    try:
      prof = profiling.profile(
          lambda: evaluation.render_camera(frame_state, camera,
                                           item['metadata'], fn, chunk=chunk),
          device)
      print(f'  [{card}] profiled {run} frame: {prof.wall_ms:.2f} ms wall, '
            f'{prof.busy_ms:.2f} ms device busy '
            f'({1 - prof.busy_ms / prof.wall_ms:.3f} idle share of the '
            f'profiled frame), {prof.device_ops} device ops; kernels of the '
            f'port {sum(prof.ours.values()):.2f} ms; largest: ' + ', '.join(
                f'{name[:60]} {ms:.2f}' for name, ms in prof.top_kernels(6)))
    except Exception as e:  # the breakdown is a reading, not a check
      print(f'  profiled {run} frame: not measured ({type(e).__name__}: {e})')

  # The serving kernels at the rows the eval path gives them: the culled
  # levels (16 and 32 kept samples a ray), the bake (no rgb row bias) and
  # the warp over the culled path's candidates (32, and 16 kept + 64).
  keep_c, keep_f = CULLED_KEEP
  coarse_c, fine_c = PREVIEW_SAMPLES
  cases = {}
  for case in _kernel_cases(
      model, device, torch.Generator(device).manual_seed(3),
      nerf_rows=((CHUNK * keep_c, True), (CHUNK * keep_f, True),
                 (EVAL_BAKE_CHUNK, False)),
      warp_rows=(CHUNK * coarse_c, CHUNK * (keep_c + fine_c))):
    numbers = _run_case(case, device_name)
    cases.setdefault(case['name'], []).append(
        dict(rows=case['rows'], with_bias=case['with_bias'], **numbers))
  return counts, cases


def _render_launches(frames, num_rays, chunk=CHUNK):
  """Launches of each serving kernel for `frames` unculled renders of
  `num_rays` rays: one a chunk at each of the two levels."""
  return frames * 2 * -(-num_rays // chunk)


def write_colmap_capture(frames_dir, model_dir, count, image_size):
  """`count` frames of the synthetic sphere on an orbit, as PNGs, and
  their COLMAP model (binary), written with the port's SceneManager."""
  frames_dir.mkdir(parents=True)
  scene = SceneManager(model_dir)
  width, height = image_size
  focal = 60.0 / 64.0 * width  # synthetic.make_orbit_camera's
  scene.cameras[1] = ColmapCamera(
      1, 'OPENCV', width, height,
      [focal, focal, width / 2, height / 2, 0, 0, 0, 0])
  rng = np.random.RandomState(0)
  for i in range(count):
    cam = synthetic.make_orbit_camera(2 * np.pi * i / count,
                                      image_size=image_size)
    name = f'{i:04d}'
    image_utils.save_image(
        frames_dir / f'{name}.png',
        image_utils.image_to_uint8(synthetic.render_sphere_image(cam)))
    # A COLMAP pose is world-to-camera: R = orientation, t = -R position.
    scene.images[i + 1] = Image(
        i + 1, f'{name}.png', 1,
        Quaternion.from_rotation_matrix(cam.orientation).q,
        -cam.orientation @ cam.position,
        points2D=rng.uniform(0, height, (4, 2)),
        point3D_ids=np.arange(1, 5, dtype=np.int64))
  scene.name_to_image_id = {im.name: i for i, im in scene.images.items()}
  ids = list(range(1, CAPTURE_POINTS + 1))
  tracks = [[(1 + j % count, 0), (1 + (j + 1) % count, 1)]
            for j in range(CAPTURE_POINTS)]
  scene._set_points(ids, rng.uniform(-0.6, 0.6, (CAPTURE_POINTS, 3)),
                    rng.randint(0, 255, (CAPTURE_POINTS, 3)),
                    rng.uniform(0, 1, CAPTURE_POINTS), tracks)
  scene.save(model_dir)


def phase_capture(work, device=torch.device('cuda', 0)):
  """A capture through the port's ingestion, then trained and rendered:
  frames and a COLMAP model -> process_capture -> the training CLI ->
  render_video. Returns the launches of the training and the render."""
  card = card_label()
  base = work / 'capture'
  frames_dir, model_dir, dataset = (base / 'frames', base / 'model',
                                    base / 'dataset')
  write_colmap_capture(frames_dir, model_dir, CAPTURE_FRAMES,
                       CLI_IMAGE_SIZE)
  start = time.perf_counter()
  process_capture.main(['--colmap_dir', str(model_dir), '--images_dir',
                        str(frames_dir), '--output_dir', str(dataset),
                        '--orbit_frames', str(CAPTURE_ORBIT_FRAMES)])
  process_s = time.perf_counter() - start
  ids = json.loads((dataset / 'dataset.json').read_text())
  kept = len(ids['ids'])
  check(kept < CAPTURE_FRAMES, f'blur keep 95 kept {kept} of '
        f'{CAPTURE_FRAMES} frames')
  for scale in (1, 2, 4, 8):
    check(len(list((dataset / 'rgb' / f'{scale}x').glob('*.png'))) == kept,
          f'rgb/{scale}x does not hold {kept} frames')
  paths = sorted((dataset / 'camera-paths' / 'orbit-mild').glob('*.json'))
  check(len(paths) == CAPTURE_ORBIT_FRAMES,
        f'{len(paths)} orbit-mild cameras, not {CAPTURE_ORBIT_FRAMES}')
  print(f'  [{card}] process_capture: {process_s:.2f} s for '
        f'{CAPTURE_FRAMES} frames of {CLI_IMAGE_SIZE[0]}x{CLI_IMAGE_SIZE[1]}'
        f', blur keep 95 kept {kept} ({len(ids["train_ids"])} train, '
        f'{len(ids["val_ids"])} val), scales 1/2/4/8')

  exp = base / 'exp'
  argv = ['--base_folder', str(exp), '--data_dir', str(dataset),
          '--gin_configs', CLI_GIN, '--device', str(device)]
  for binding in ('ExperimentConfig.image_scale = 1',
                  f'TrainConfig.max_steps = {CAPTURE_STEPS}',
                  f'TrainConfig.save_every = {CAPTURE_STEPS}',
                  'TrainConfig.print_every = 1',
                  'TrainConfig.log_every = 1000000',
                  'TrainConfig.histogram_every = 1000000'):
    argv += ['--gin_bindings', binding]
  fused_mlp.reset_launch_counts()
  result = train_cli.main(argv)
  train_counts = fused_mlp.launch_counts()
  check(result.state.step == CAPTURE_STEPS,
        f'trained to step {result.state.step}')
  for key, value in _flat_tree(result.stats):
    check(np.isfinite(value), f'capture stat {key} is {value}')
  for name, want in TRAIN_STEP_LAUNCHES.items():
    check(train_counts[name] == want * CAPTURE_STEPS,
          f'{name}: {train_counts[name]} launches in {CAPTURE_STEPS} steps, '
          f'expected {want * CAPTURE_STEPS}')
  step_s = result.time_tracker.values('train_step')
  print(f'  [{card}] trained {CAPTURE_STEPS} steps: train_step '
        f'{[round(v * 1e3, 2) for v in step_s]} ms; stats of the last: '
        + ', '.join(f'{k} {v:.5g}' for k, v in _flat_tree(result.stats)))

  fused_mlp.reset_launch_counts()
  start = time.perf_counter()
  frames = render_video.main(
      ['--base_folder', str(exp), '--data_dir', str(dataset),
       '--gin_configs', CLI_GIN, '--gin_bindings',
       'ExperimentConfig.image_scale = 1', '--camera_path', 'orbit-mild',
       '--chunk', str(CHUNK), '--output_dir', str(base / 'video'),
       '--device', str(device)])
  render_s = time.perf_counter() - start
  render_counts = fused_mlp.launch_counts()
  check(len(frames) == CAPTURE_ORBIT_FRAMES,
        f'render_video wrote {len(frames)} frames, not '
        f'{CAPTURE_ORBIT_FRAMES}')
  for path in frames:
    image = image_utils.load_image(path)
    check(image.shape == (CLI_IMAGE_SIZE[1], CLI_IMAGE_SIZE[0], 3),
          f'{path.name}: shape {image.shape}')
  per_kernel = _render_launches(len(frames),
                                CLI_IMAGE_SIZE[0] * CLI_IMAGE_SIZE[1])
  want = {name: 0 for name in render_counts}
  want.update(nerf_mlp_forward=per_kernel, warp_trunk_forward=per_kernel)
  check(render_counts == want,
        f'render_video launches {render_counts}, expected {want}')
  print(f'  [{card}] render_video orbit-mild: {len(frames)} PNG frames in '
        f'{render_s:.2f} s; launches {render_counts}')
  return {name: train_counts[name] + render_counts[name]
          for name in train_counts}


def phase_quality(work, device=torch.device('cuda', 0)):
  """quality_bench at the bench width on its scene; saves the params for
  the serve_bench phase. Returns the launches of the run."""
  card = card_label()
  base = work / 'quality'
  argv = ['--steps', str(QUALITY_STEPS), '--eval_every',
          str(QUALITY_EVAL_EVERY), *QUALITY_ARGV,
          '--scene_dir', str(base / 'scene'), '--work_dir',
          str(base / 'work'), '--out', str(base / 'curve.json'),
          '--save_params', str(base / 'params.npz'), '--device', str(device)]
  args = quality_bench.parse_args(argv)
  quality_bench.write_scene(args)  # outside the counts and the times
  fused_mlp.reset_launch_counts()
  run = quality_bench.main(argv)
  counts = fused_mlp.launch_counts()
  curve = run.result['curve']
  check([row['step'] for row in curve]
        == list(range(QUALITY_EVAL_EVERY, QUALITY_STEPS + 1,
                      QUALITY_EVAL_EVERY)),
        f'curve steps {[row["step"] for row in curve]}')
  for row in curve:
    for key, value in row.items():
      if key == 'render_delta' and row is curve[0]:
        check(value is None, f'render_delta {value} on the first eval')
      else:
        check(value is not None and np.isfinite(value),
              f'curve step {row["step"]}: {key} {value}')
  check(curve[-1]['render_delta'] > 0,
        f'render_delta {curve[-1]["render_delta"]} on the last eval')
  check((base / 'params.npz').is_file(), 'no params.npz saved')
  width, height = args.image_size
  renders = _render_launches(2 * len(curve), width * height)
  want = {name: QUALITY_STEPS * per_step
          for name, per_step in TRAIN_STEP_LAUNCHES.items()}
  want['nerf_mlp_forward'] += renders
  want['warp_trunk_forward'] += renders
  print(f'  launches in {QUALITY_STEPS} steps and {len(curve)} evals: '
        f'{counts}, expected {want}')
  check(counts == want, f'launches {counts}, expected {want}')
  step_ms = float(np.median(run.step_seconds[1:])) * 1e3
  batch = args.batch_size
  print(f'  [{card}] quality_bench step median {step_ms:.2f} ms over '
        f'{len(run.step_seconds) - 1} steps after the first '
        f'({run.step_seconds[0] * 1e3:.1f} ms), {batch / step_ms * 1e3:.1f} '
        'rays/s')
  for row in curve:
    print(f'  [{card}] curve: {json.dumps(row)}')
  return counts


@contextlib.contextmanager
def _recording_rows(seen):
  """Adds (rows, with a row bias) of each call of a serving wrapper to
  seen[name] while the block runs.

  A stand-in takes each wrapper's name in fused_mlp. A wrapper counts a
  launch on the function its module name holds, so the stand-in carries
  the count while it is in place and hands it back after.
  """
  originals = {name: getattr(fused_mlp, name) for name in SERVE_KERNELS}

  def recorder(name, fn):
    def call(x, row_bias, *args, **kwargs):
      seen.setdefault(name, set()).add((x.shape[0], bool(row_bias is not None
                                                         and len(row_bias))))
      return fn(x, row_bias, *args, **kwargs)
    call.launches = fn.launches
    return call

  for name, fn in originals.items():
    setattr(fused_mlp, name, recorder(name, fn))
  try:
    yield seen
  finally:
    for name, fn in originals.items():
      fn.launches = getattr(fused_mlp, name).launches
      setattr(fused_mlp, name, fn)


def phase_serve_bench(work, device_name, device=torch.device('cuda', 0)):
  """serve_bench on the quality phase's params, 1080p frames measured.
  Returns the launches of the run and the serving kernels' cases at every
  row count the run gave them."""
  card = card_label()
  base = work / 'quality'
  seen = {}
  fused_mlp.reset_launch_counts()
  with _recording_rows(seen):
    run = serve_bench.main(['--params', str(base / 'params.npz'),
                            '--scene_dir', str(base / 'scene'), '--out',
                            str(base / 'serve.json'), '--device',
                            str(device)])
  counts = fused_mlp.launch_counts()
  modes = run.result['modes']
  check([row['mode'] for row in modes] == [m[0] for m in serve_bench.MODES],
        f'modes {[row["mode"] for row in modes]}')
  for row in modes:
    for key in ('rays_per_sec', 'psnr', 'ms_ssim', 'measured_1080p_s',
                'hd_rays_per_sec'):
      check(row.get(key) is not None and np.isfinite(row[key]),
            f'{row["mode"]}: {key} = {row.get(key)}')
  print(f'  launches: {counts}')
  for name in SERVE_KERNELS:
    check(counts[name] > 0, f'{name} was not launched')
  for name in set(TRAIN_KERNELS) - set(SERVE_KERNELS):
    check(counts[name] == 0, f'{name} launched {counts[name]} times')
  grid = run.result['grid']
  print(f'  [{card}] occupancy bake at {grid["resolution"]}^3: '
        f'{run.bake_seconds:.3f} s, {grid["occupied_fraction"]:.4f} '
        'occupied')
  for row in modes:
    print(f"  [{card}] {row['mode']}: {row['rays_per_sec']:.1f} rays/s, "
          f"1080p {row['measured_1080p_s']:.3f} s "
          f"({row['hd_rays_per_sec']:.1f} rays/s); PSNR {row['psnr']:.3f}, "
          f"MS-SSIM {row['ms_ssim']:.4f} (a {QUALITY_STEPS}-step fit)")
  # The full mode renders the quality phase's last eval view with the
  # saved and loaded params: the same PSNR.
  curve = json.loads((base / 'curve.json').read_text())['curve']
  full_psnr, trained_psnr = modes[0]['psnr'], curve[-1]['val_psnr']
  print(f'  full mode val PSNR {full_psnr} against the quality curve\'s '
        f'{trained_psnr}')
  check(abs(full_psnr - trained_psnr) <= SERVE_PSNR_ATOL,
        f'full mode PSNR {full_psnr}, quality curve {trained_psnr}')

  # Both serving kernels at every row count of the run, on its model.
  tree, _, _ = serve_bench.load_params(base / 'params.npz')
  source = datasets.from_config(
      {'type': 'nerfies', 'data_dir': str(base / 'scene')}, image_scale=1,
      use_appearance_id=True, use_camera_id=True, use_warp_id=True)
  model = nerf.NerfModel(
      quality_bench.model_config(), interop.params_from_jax(tree, device),
      source.near, source.far, source.appearance_ids, source.camera_ids,
      source.warp_ids)
  nerf_rows = sorted(seen['nerf_mlp_forward'])
  warp_rows = sorted(n for n, _ in seen['warp_trunk_forward'])
  print(f'  row counts of the run: nerf_mlp_forward {nerf_rows}, '
        f'warp_trunk_forward {warp_rows}')
  cases = {}
  with torch.no_grad():
    for case in _kernel_cases(
        model, device, torch.Generator(device).manual_seed(4),
        nerf_rows=nerf_rows, warp_rows=warp_rows):
      numbers = _run_case(case, device_name)
      cases.setdefault(case['name'], []).append(
          dict(rows=case['rows'], with_bias=case['with_bias'], **numbers))
  return counts, cases


def _forbidden_loaded():
  return sorted({name.split('.')[0] for name in sys.modules}
                & set(FORBIDDEN_MODULES))


@contextlib.contextmanager
def _kept_frames():
  """Keeps the rgb, depth and acc of each evaluation.render_camera call
  in the list it yields."""
  render_camera, frames = evaluation.render_camera, []

  def keep(*args, **kwargs):
    maps = render_camera(*args, **kwargs)
    frames.append({k: maps[k] for k in ('rgb', 'depth', 'acc')})
    return maps

  evaluation.render_camera = keep
  try:
    yield frames
  finally:
    evaluation.render_camera = render_camera


def ddp_child(argv):
  """One rank of a ddp run (started by torchrun): `--ddp_child MODE REPORT
  -- CLI ARGS`. MODE 'train' runs nerfies_tpu_torch.train.main, 'eval'
  nerfies_tpu_torch.eval.main, with the launch counts set to 0 just
  before; REPORT.rank<r>.json gets the counts, the cards the launches
  were given (_build.launch_cards) and the card current after the run,
  the run's numbers and the JAX modules loaded (none may be); 'eval' also
  keeps rank 0's frames (rgb, depth, acc) in REPORT.frames.npz."""
  mode, report = argv[0], argv[1]
  cli_argv = argv[argv.index('--') + 1:]
  # Read before the run: a TensorBoard writer may import TensorFlow, and
  # with it JAX where both are installed; the port's modules are all
  # imported by now.
  forbidden = _forbidden_loaded()
  fused_mlp.reset_launch_counts()
  frames = []
  if mode == 'train':
    result = train_cli.main(cli_argv)
    device = result.setup.device
    out = {'stats': {k: float(v) for k, v in _flat_tree(result.stats)},
           'train_step_s': result.time_tracker.values('train_step'),
           'collectives': result.collectives,
           'init_step': result.setup.init_step,
           'batch_size': result.setup.train_config.batch_size,
           'fused_route': result.setup.model.fused_route}
  else:
    with _kept_frames() as frames:
      result = eval_cli.main(cli_argv)
    device = resolve_device(cli_argv[cli_argv.index('--device') + 1]
                            if '--device' in cli_argv else 'cuda')
    out = {'frames': len(frames),
           'render_time': [stats['render_time']
                           for _, _, _, stats in result.frames]}
  out.update(rank=mesh.rank(),
             world_size=mesh.world_size(), device=str(device),
             launches=fused_mlp.launch_counts(),
             launch_cards=_build.launch_cards(),
             current_card=(torch.cuda.current_device()
                           if device.type == 'cuda' else None),
             peak_gb=(torch.cuda.max_memory_allocated(device) / 2**30
                      if device.type == 'cuda' else 0.0),
             forbidden_modules=forbidden)
  if frames and mesh.is_main():
    np.savez(f'{report}.frames.npz', **{
        f'{i}_{k}': v for i, frame in enumerate(frames)
        for k, v in frame.items()})
  with open(f'{report}.rank{mesh.rank()}.json', 'w') as f:
    json.dump(out, f)
  mesh.shutdown()


def torchrun(work, tag, mode, cli_argv, world, device_type='cuda'):
  """`python -m torch.distributed.run --standalone --nproc_per_node=world
  chip_smoke.py --ddp_child mode ...` from the repo's root; returns each
  rank's report and the seconds the command took. Fails with the log's
  end if it fails; stops the whole process group if it overruns. On the
  card, rank r must have launched on card r only and left it current;
  `device_type` 'cpu' (gloo ranks, each CLI's `--device cpu`) launches
  on no card."""
  repo = pathlib.Path(__file__).resolve().parent
  report = work / f'ddp_{tag}'
  cmd = [sys.executable, '-m', 'torch.distributed.run', '--standalone',
         f'--nproc_per_node={world}', str(repo / 'chip_smoke.py'),
         '--ddp_child', mode, str(report), '--', *cli_argv]
  log_path = work / f'ddp_{tag}.log'
  start = time.perf_counter()
  with open(log_path, 'w') as log:
    proc = subprocess.Popen(cmd, cwd=repo, stdout=log,
                            stderr=subprocess.STDOUT,
                            start_new_session=True)
    try:
      proc.wait(timeout=DDP_TIMEOUT_S)
    except subprocess.TimeoutExpired:
      os.killpg(proc.pid, signal.SIGKILL)
      proc.wait()
  seconds = time.perf_counter() - start
  tail = log_path.read_text()[-3000:]
  check(proc.returncode == 0,
        f'{tag}: torchrun exited {proc.returncode}:\n{tail}')
  reports = []
  for r in range(world):
    with open(f'{report}.rank{r}.json') as f:
      reports.append(json.load(f))
  for rep in reports:
    r = rep['rank']
    want = f'cuda:{r}' if device_type == 'cuda' else device_type
    check(rep['world_size'] == world and rep['device'] == want,
          f'{tag}: rank {r} of {rep["world_size"]} ran on {rep["device"]}')
    launched = any(rep['launches'].values())
    cards = [r] if launched and device_type == 'cuda' else []
    check(rep['launch_cards'] == cards,
          f'{tag}: rank {r} launched on cards {rep["launch_cards"]}')
    check(rep['current_card'] == (r if device_type == 'cuda' else None),
          f'{tag}: rank {r} left card {rep["current_card"]} current')
    check(not rep['forbidden_modules'],
          f'{tag}: a ddp child loaded {rep["forbidden_modules"]}')
  return reports, seconds


def _add_counts(total, counts):
  for name, count in counts.items():
    total[name] = total.get(name, 0) + count


def phase_ddp(work):
  """The training and eval CLIs under torchrun over every card (NCCL,
  each rank on its card, cuda:{LOCAL_RANK}), held against the same runs
  in this process, and the 4-device config."""
  card = card_label()
  world = torch.cuda.device_count()
  print(f'  world size {world} (torch.cuda.device_count()), NCCL')
  scene = work / 'scene'
  bindings = (f'TrainConfig.save_every = {DDP_FIRST_STEPS}',)

  def train_argv(exp, gin_file, max_steps, *extra):
    argv = ['--base_folder', str(exp), '--data_dir', str(scene),
            '--gin_configs', gin_file]
    for binding in ('ExperimentConfig.image_scale = 1',
                    f'TrainConfig.max_steps = {max_steps}',
                    'TrainConfig.print_every = 1',
                    'TrainConfig.log_every = 1000000',
                    'TrainConfig.histogram_every = 1000000') + extra:
      argv += ['--gin_bindings', binding]
    return argv

  # The reference: the same runs without torchrun, in this process.
  ref_exp = work / 'exp_ddp_ref'
  for steps in (DDP_FIRST_STEPS, DDP_LAST_STEP):
    ref_stats = train_cli.main(train_argv(ref_exp, CLI_GIN, steps,
                                          *bindings)).stats
  eval_argv = ['--base_folder', str(ref_exp), '--data_dir', str(scene),
               '--gin_configs', CLI_GIN]
  for binding in DDP_EVAL_BINDINGS:
    eval_argv += ['--gin_bindings', binding]
  with _kept_frames() as ref_frames:
    eval_cli.main(eval_argv)
  # Nothing of this process may hold the card's memory for the children.
  gc.collect()
  torch.cuda.empty_cache()

  counts = {}
  exp = work / 'exp_ddp'
  runs = []
  for steps in (DDP_FIRST_STEPS, DDP_LAST_STEP):
    reports, seconds = torchrun(
        work, f'train{steps}', 'train',
        train_argv(exp, CLI_GIN, steps, *bindings), world)
    runs.append(reports)
    for rep in reports:
      _add_counts(counts, rep['launches'])
      check(rep['fused_route'], f'{CLI_GIN} took the plain route')
    print(f'  torchrun train to step {steps}: {seconds:.1f} s; rank 0 '
          f'from step {reports[0]["init_step"]}, train_step '
          f'{[round(v * 1e3, 2) for v in reports[0]["train_step_s"]]} ms; '
          f'launches per rank {[rep["launches"] for rep in reports]} on '
          f'cards {[rep["launch_cards"] for rep in reports]}; peak '
          f'{[round(rep["peak_gb"], 2) for rep in reports]} GiB')
  check(runs[1][0]['init_step'] == DDP_FIRST_STEPS + 1,
        f'the resumed ddp run starts at {runs[1][0]["init_step"]}')
  got = torch.load(exp / 'checkpoints' / str(DDP_LAST_STEP) / 'state.pt',
                   weights_only=True)
  want = torch.load(ref_exp / 'checkpoints' / str(DDP_LAST_STEP) /
                    'state.pt', weights_only=True)
  got_params, want_params = (dict(_flat_tree(got['params'])),
                             dict(_flat_tree(want['params'])))
  check(got_params.keys() == want_params.keys(), 'ddp params differ in names')
  err = max(float((got_params[k] - want_params[k]).abs().max())
            for k in want_params)
  if world == 1:
    same = all(torch.equal(got_params[k], want_params[k])
               for k in want_params)
    print(f'  params at step {DDP_LAST_STEP} under torchrun against without: '
          f'max_abs_err {err:.3g}, bit-identical {same}')
    check(same, 'world size 1 under torchrun trains other params')
  else:
    print(f'  params at step {DDP_LAST_STEP}: max_abs_err {err:.3g} against '
          'one process')
  for key, value in _flat_tree(ref_stats):
    other = runs[1][0]['stats'][key]
    ok = np.isclose(other, value, rtol=STATS_RTOL, atol=STATS_ATOL)
    check(ok and (world > 1 or other == value),
          f'ddp stat {key}: {other} against {value} in one process')
  print('  the last step\'s stats equal the run without torchrun'
        + (' bit for bit' if world == 1 else
           f' within rtol {STATS_RTOL}, atol {STATS_ATOL}'))

  # The config made for four devices, on the plain route.
  reports, seconds = torchrun(
      work, 'plain', 'train',
      train_argv(work / 'exp_ddp_plain', DDP_PLAIN_GIN, DDP_PLAIN_STEPS,
                 f'TrainConfig.save_every = {DDP_PLAIN_STEPS}'), world)
  for rep in reports:
    _add_counts(counts, rep['launches'])
    check(not rep['fused_route'], f'{DDP_PLAIN_GIN} took the fused route')
    check(not any(rep['launches'].values()),
          f'the plain route launched {rep["launches"]}')
  main = reports[0]
  step_ms = float(np.median(main['train_step_s'])) * 1e3
  coll = main['collectives']
  calls = max(coll.get('calls', 0), 1)
  print(f'  [{card}] {DDP_PLAIN_GIN} on {world} card(s), batch '
        f'{main["batch_size"]}: train_step median {step_ms:.2f} ms '
        f'({[round(v * 1e3, 2) for v in main["train_step_s"]]}), '
        f'{main["batch_size"] / step_ms * 1e3:.1f} rays/s; peak '
        f'{[round(rep["peak_gb"], 2) for rep in reports]} GiB a rank; '
        f'all-reduce {coll.get("calls", 0)} calls, '
        f'{coll.get("bytes", 0) // calls} bytes and '
        f'{coll.get("ms", 0.0) / calls:.3f} ms a step'
        + (' (world size 1: nothing reduced)' if world == 1 else '')
        + f'; command {seconds:.1f} s')

  # The eval CLI under torchrun on step DDP_LAST_STEP's checkpoint.
  eval_argv[1] = str(exp)
  reports, seconds = torchrun(work, 'eval', 'eval', eval_argv, world)
  for rep in reports:
    _add_counts(counts, rep['launches'])
  frames = np.load(work / 'ddp_eval.frames.npz')
  check(reports[0]['frames'] == len(ref_frames) == 1,
        f'eval frames: {reports[0]["frames"]} under torchrun, '
        f'{len(ref_frames)} without')
  for key in ('rgb', 'depth', 'acc'):
    a, b = frames[f'0_{key}'], ref_frames[0][key]
    err = float(np.abs(a - b).max())
    ok = (np.array_equal(a, b) if world == 1 else
          np.allclose(a, b, atol=DDP_EVAL_ATOL, rtol=DDP_EVAL_RTOL))
    print(f'  eval frame {key} under torchrun against without: max_abs_err '
          f'{err:.3g}, ' + ('bit-identical' if world == 1 else
                            f'within atol {DDP_EVAL_ATOL} rtol '
                            f'{DDP_EVAL_RTOL}') + f': {ok}')
    check(ok, f'ddp eval frame {key} differs')
  print(f'  [{card}] torchrun eval: render_time '
        f'{[round(t * 1e3, 1) for t in reports[0]["render_time"]]} ms; '
        f'command {seconds:.1f} s')
  print(f'  launches in the ddp children, all ranks: {counts}')
  for name in KERNEL_SOURCES:
    check(counts.get(name, 0) > 0, f'{name}: no launch on the ddp path')
  return counts


def phase_profile(device):
  """nerfies_tpu_torch.profiling step on the bench workload and dispatch:
  device ms by op, the idle share against the unprofiled median."""
  card = card_label()
  print(f'  [{card}]')
  trace_dir = tempfile.mkdtemp(prefix='chip_smoke_trace_')
  try:
    result = profiling.main(['step', '--steps', str(PROFILE_STEPS),
                             '--trace_dir', trace_dir])
    prof = result['profile']
    for name in ('nerf_mlp_kernel', 'nerf_bwd_rows_kernel',
                 'warp_fwd_kernel', 'warp_bwd_rows_kernel',
                 'dw_partial_kernel'):
      check(prof.ours.get(name, 0.0) > 0,
            f'the profiled step shows no {name}')
    plain = sum(ms for name, ms, _ in prof.top_ops()
                if name not in profiling.OUR_KERNEL_NAMES)
    print(f'  [{card}] step median {result["median_ms"]:.2f} ms, device busy '
          f'{prof.busy_ms:.2f} ms, idle share {result["idle_share"]:.3f} '
          f'(against the profiled wall {prof.wall_ms:.2f} ms: '
          f'{1 - prof.busy_ms / prof.wall_ms:.3f}); kernels of the port '
          f'{sum(prof.ours.values()):.2f} ms, other ops {plain:.2f} ms')
    summary = profiling.main(['trace', os.path.join(trace_dir,
                                                    'step_rank0.json'),
                              '--top', '8'])
    check(abs(summary['device_ms'] - prof.busy_ms) <= 0.01 * prof.busy_ms,
          f'the trace holds {summary["device_ms"]} device ms, the profile '
          f'{prof.busy_ms}')
  finally:
    shutil.rmtree(trace_dir, ignore_errors=True)
  profiling.main(['dispatch'])
  del device
  return result


def _tree_to(tree, device):
  return {k: (_tree_to(v, device) if isinstance(v, dict) else v.to(device))
          for k, v in tree.items()}


def run_phase(name, fn, *args):
  start = time.perf_counter()
  print(f'[{name}] start', flush=True)
  result = fn(*args)
  print(f'[{name}] ok in {time.perf_counter() - start:.2f} s', flush=True)
  return result


def main(argv=None):
  argv = sys.argv[1:] if argv is None else argv
  if argv[:1] == ['--ddp_child']:
    ddp_child(argv[1:])
    return 0
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument('--seed', type=int, default=0)
  parser.add_argument('--ddp_only', action='store_true',
                      help='the device, build and ddp phases alone, over '
                      'every card of the machine; no result line')
  args = parser.parse_args(argv)
  total = time.perf_counter()
  work = pathlib.Path(tempfile.mkdtemp(prefix='chip_smoke_cli_'))
  if args.ddp_only:
    try:
      run_phase('device', phase_device)
      run_phase('build', phase_build)
      write_capture(work / 'scene')
      run_phase('ddp', phase_ddp, work)
    finally:
      shutil.rmtree(work, ignore_errors=True)
    print(f'total: {time.perf_counter() - total:.2f} s')
    return 0
  try:
    device_name = run_phase('device', phase_device)
    device = torch.device('cuda', 0)
    build_seconds = run_phase('build', phase_build)
    generator = torch.Generator().manual_seed(args.seed)
    model, params = nerf.construct_nerf(
        configs.bench_render_config(), **configs.BENCH_RENDER_IDS,
        generator=generator, device=device)
    state = evaluation.RenderState(params, warp_alpha=WARP_ALPHA)
    kernels = run_phase('kernels', lambda: {
        **phase_kernels(model, device,
                        torch.Generator(device).manual_seed(args.seed),
                        device_name),
        **phase_train_kernels(
            model, device, torch.Generator(device).manual_seed(args.seed + 1),
            device_name)})
    other = run_phase('widths', phase_other_widths, model, device,
                      torch.Generator(device).manual_seed(args.seed + 2))
    for name, err in other.items():
      kernels[name]['max_abs_err'] = max(kernels[name]['max_abs_err'], err)
    serve_counts, first_request = run_phase(
        'serve', phase_serve, model, state, np.random.RandomState(args.seed))
    run_phase('parity', phase_parity, model, state, first_request)
    train_counts, train_numbers = run_phase('train', phase_train, args.seed)
    run_phase('train_parity', phase_train_parity, args.seed)
    model_counts = run_phase('model', phase_model, args.seed, first_request)
    cli_counts = run_phase('cli', phase_cli, train_numbers['step_ms'], work)
    cli_plain_counts = run_phase('cli_plain', phase_cli_plain,
                                 train_numbers['step_ms'], work)
    eval_counts, eval_cases = run_phase('eval', phase_eval, work,
                                        device_name)
    capture_counts = run_phase('capture', phase_capture, work)
    quality_counts = run_phase('quality', phase_quality, work)
    serve_bench_counts, serve_bench_cases = run_phase(
        'serve_bench', phase_serve_bench, work, device_name)
    ddp_counts = run_phase('ddp', phase_ddp, work)
    run_phase('profile', phase_profile, device)
  except Exception as e:  # report the failing phase, then fail the run
    print(f'FAILED: {type(e).__name__}: {e}', file=sys.stderr, flush=True)
    raise
  finally:
    shutil.rmtree(work, ignore_errors=True)
  lines = []
  for name, (source, replaces) in KERNEL_SOURCES.items():
    k = kernels[name]
    by_path = {'serve': serve_counts.get(name, 0),
               'train': train_counts.get(name, 0),
               'model': model_counts.get(name, 0),
               'cli': cli_counts.get(name, 0),
               'cli_plain': cli_plain_counts.get(name, 0),
               'eval': eval_counts.get(name, 0),
               'capture': capture_counts.get(name, 0),
               'quality': quality_counts.get(name, 0),
               'serve_bench': serve_bench_counts.get(name, 0),
               'ddp': ddp_counts.get(name, 0)}
    for case in eval_cases.get(name, []) + serve_bench_cases.get(name, []):
      k['max_abs_err'] = max(k['max_abs_err'], case['max_abs_err'])
    lines.append({
        'name': name, 'route': 'cuda', 'source': source, 'replaces': replaces,
        'launches': sum(by_path.values()), 'launches_by_path': by_path,
        'max_abs_err': k['max_abs_err'], 'ms': k['ms'],
        'plain_ms': k['plain_ms'], 'bound_ms': k['bound_ms'],
        'bound_by': k['bound_by'], 'library_ms': k['library_ms'],
        'rows': k['rows'],
        **{key: k[key] for key in ('row_pass_ms', 'row_pass_bound_ms',
                                   'weight_pass_ms', 'weight_pass_bound_ms',
                                   'fine_rows', 'fine_ms', 'fine_rows_ms',
                                   'fine_library_ms', 'fine_bound_ms')
           if key in k},
        **{f'{path}_cases': [{key: case[key] for key in (
            'rows', 'with_bias', 'ms', 'plain_ms', 'library_ms', 'bound_ms',
            'bound_by')} for case in path_cases.get(name, [])]
           for path, path_cases in (('eval', eval_cases),
                                    ('serve_bench', serve_bench_cases))}})
  print(f'total: {time.perf_counter() - total:.2f} s '
        f'(build {build_seconds:.2f} s)')
  print(json.dumps({'kernels': lines}))
  print(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
      'count': torch.cuda.device_count()}}))
  return 0


if __name__ == '__main__':
  sys.exit(main())
