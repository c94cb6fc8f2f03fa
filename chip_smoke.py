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

The line before the last is a JSON object {"kernels": [...]}; the last is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Usage: python3 chip_smoke.py [--seed 0]
"""

import argparse
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

from nerfies_tpu_torch import configs
from nerfies_tpu_torch import evaluation
from nerfies_tpu_torch.models import modules
from nerfies_tpu_torch.models import nerf
from nerfies_tpu_torch.ops import _build
from nerfies_tpu_torch import training
from nerfies_tpu_torch.ops import encoding
from nerfies_tpu_torch.ops import fused_mlp
from nerfies_tpu_torch.ops import fused_warp

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
PARITY_BACKGROUND_POINTS = 2048
STATS_RTOL, STATS_ATOL = 0.05, 5e-4
GRAD_COSINE, GRAD_NORM_RATIO = 0.95, (0.7, 1.4)

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


def _kernel_cases(model, device, generator):
  """Yields each kernel case at the model's widths and the serving rows."""
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

  # Rows per launch while serving: a chunk's rays times 128 coarse samples
  # or 256 fine ones; and a ragged count.
  coarse = CHUNK * model.num_coarse_samples
  fine = CHUNK * (model.num_coarse_samples + model.num_fine_samples)
  for n, with_bias in ((coarse, False), (coarse, True), (coarse + 37, True),
                       (fine, True)):
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
  for n in (coarse, coarse + 37, fine):
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


@torch.no_grad()
def phase_kernels(model, device, generator, device_name):
  peak_flops, peak_bytes = peaks(device_name)
  print(f'peaks used for bounds: {peak_flops / 1e12:.0f} TFLOP/s bf16, '
        f'{peak_bytes / 1e12:.2f} TB/s')
  results = {}
  fine_rows = CHUNK * (model.num_coarse_samples + model.num_fine_samples)
  for case in _kernel_cases(model, device, generator):
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
    entry = results.setdefault(case['name'], {'max_abs_err': 0.0})
    entry['max_abs_err'] = max(entry['max_abs_err'], err)
    if case['rows'] == CHUNK * model.num_coarse_samples and case['with_bias']:
      # The coarse level's launch: the numbers the kernel line reports.
      entry.update(rows=case['rows'], ms=ms, plain_ms=plain_ms,
                   library_ms=library_ms, bound_ms=bound_ms,
                   bound_by='operations' if flop_ms >= byte_ms else 'bytes')
    elif case['rows'] == fine_rows:
      entry.update(fine_rows=case['rows'], fine_ms=ms,
                   fine_library_ms=library_ms, fine_bound_ms=bound_ms)
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
      print(f'  nerf_mlp_backward rows={n}: {ms:.3f} ms kernel')
      entry = results['nerf_mlp_backward']
      entry['max_abs_err'] = max(err, entry['max_abs_err'])
      entry['fine_rows_ms'] = ms
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


def _train_batch(batch_size, background_points, seed):
  """bench.py's fake_batch: unit directions, random colours and ids."""
  rng = np.random.RandomState(seed)
  directions = rng.randn(batch_size, 3).astype(np.float32)
  directions /= np.linalg.norm(directions, axis=-1, keepdims=True)
  ids = lambda high: rng.randint(0, high, (batch_size, 1))
  return {
      'origins': np.zeros((batch_size, 3), np.float32),
      'directions': directions,
      'rgb': rng.uniform(size=(batch_size, 3)).astype(np.float32),
      'metadata': {'warp': ids(16), 'camera': ids(2), 'appearance': ids(16)},
      'background_points': rng.randn(background_points, 3).astype(
          np.float32),
  }


def _train_model(config, seed, device):
  return nerf.construct_nerf(
      config, **configs.BENCH_RENDER_IDS,
      generator=torch.Generator().manual_seed(seed), device=device,
      use_warp_jacobian=True, use_weights=True)


TRAIN_KERNELS = ('nerf_mlp_forward', 'nerf_mlp_backward', 'warp_mlp_forward',
                 'warp_mlp_backward')
OUR_KERNEL_NAMES = ('nerf_mlp_kernel', 'nerf_bwd_rows_kernel',
                    'warp_fwd_kernel', 'warp_bwd_rows_kernel',
                    'dw_partial_kernel', 'dw_reduce_kernel')


def _profile_step(step, state, batch, scalars, generator):
  """Device time of one step by kernel, from torch.profiler."""
  from torch.profiler import ProfilerActivity, profile
  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    start = time.perf_counter()
    step(generator, state, batch, scalars)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - start) * 1e3
  ours, total = {}, 0.0
  for event in prof.key_averages():
    if event.device_type != torch.autograd.DeviceType.CUDA:
      continue
    us = getattr(event, 'self_device_time_total', None)
    if us is None:
      us = event.self_cuda_time_total
    total += us
    for name in OUR_KERNEL_NAMES:
      if name in event.key:
        ours[name] = ours.get(name, 0.0) + us
  return wall_ms, total / 1e3, {k: v / 1e3 for k, v in ours.items()}


def phase_train(seed, device=torch.device('cuda', 0)):
  config, train_config = configs.bench_train_config()
  model, params = _train_model(config, seed, device)
  state = training.create_train_state(params,
                                      warp_alpha=configs.BENCH_WARP_ALPHA)
  step = training.make_train_step(model, train_config, device)
  batch = _train_batch(train_config.batch_size,
                       train_config.background_points_batch_size, seed)
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
  per_step = {'nerf_mlp_forward': 2, 'nerf_mlp_backward': 2,
              'warp_mlp_forward': 3, 'warp_mlp_backward': 3,
              'warp_trunk_forward': 0}
  print(f'  launches in {TRAIN_STEPS} steps: {counts}')
  for name, want in per_step.items():
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
    wall_ms, busy_ms, ours = _profile_step(step, new_state, batch, scalars,
                                           generator)
    print(f'  profiled step: {wall_ms:.2f} ms wall, {busy_ms:.2f} ms device '
          f'busy ({1 - busy_ms / wall_ms:.3f} idle share); kernels of the '
          f'port {sum(ours.values()):.2f} ms: '
          + ', '.join(f'{k} {v:.2f}' for k, v in ours.items()))
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
  batch = _train_batch(PARITY_TRAIN_RAYS, PARITY_BACKGROUND_POINTS, seed + 1)
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
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument('--seed', type=int, default=0)
  args = parser.parse_args(argv)
  total = time.perf_counter()
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
    train_counts, _ = run_phase('train', phase_train, args.seed)
    run_phase('train_parity', phase_train_parity, args.seed)
  except Exception as e:  # report the failing phase, then fail the run
    print(f'FAILED: {type(e).__name__}: {e}', file=sys.stderr, flush=True)
    raise
  sources = {
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
  lines = []
  for name, (source, replaces) in sources.items():
    k = kernels[name]
    by_path = {'serve': serve_counts.get(name, 0),
               'train': train_counts.get(name, 0)}
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
           if key in k}})
  print(f'total: {time.perf_counter() - total:.2f} s '
        f'(build {build_seconds:.2f} s)')
  print(json.dumps({'kernels': lines}))
  print(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
      'count': torch.cuda.device_count()}}))
  return 0


if __name__ == '__main__':
  sys.exit(main())
