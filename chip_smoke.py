#!/usr/bin/env python3
"""Smoke run of the PyTorch port (nerfies_tpu_torch) on one CUDA card.

Phases, each printed with its elapsed seconds; the run stops with a
non-zero exit at the first phase that fails:

  device   require CUDA; print the card's name and power limit.
  build    build the kernels from nerfies_tpu_torch/csrc with one nvcc call.
  kernels  hold each kernel against its plain PyTorch version at the full
           width of the bench render model and at the row counts serving
           gives it (atol = rtol = 0.05, the bf16 tolerance of
           tests/test_fused_mlp.py), and time kernel, plain version and a
           bf16 torch.matmul chain of the same function (a yardstick only).
  serve    build the bench render model from a seed and serve 3 requests
           of 128x128 rays through evaluation.make_render_fn and
           render_image (chunk 8192, warp alpha 6.0); check the outputs and
           that every kernel of the path was launched, with the launch
           counts set to 0 just before and read just after.
  parity   render 256 rays on the card through the kernels and on the CPU
           through the plain versions, from the same params; compare at
           atol 0.02 and rtol 0.05 (tests/test_fast_render.py).

The line before the last is a JSON object {"kernels": [...]}; the last is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Usage: python3 chip_smoke.py [--seed 0]
"""

import argparse
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
from nerfies_tpu_torch.ops import encoding
from nerfies_tpu_torch.ops import fused_mlp

KERNEL_ATOL = KERNEL_RTOL = 0.05
RENDER_ATOL, RENDER_RTOL = 0.02, 0.05
IMAGE_SIZE = 128
NUM_REQUESTS = 3
CHUNK = 8192
WARP_ALPHA = 6.0
PARITY_RAYS = 256

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
  for line in _build.build_log().splitlines():
    if 'registers' in line or 'spill' in line or ' s, exit' in line:
      print(f'  {line.strip()}')
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


def phase_kernels(model, device, generator, device_name):
  peak_flops, peak_bytes = peaks(device_name)
  print(f'peaks used for bounds: {peak_flops / 1e12:.0f} TFLOP/s bf16, '
        f'{peak_bytes / 1e12:.2f} TB/s')
  results = {}
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
  return results


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
  print(f'  launches in serve: {counts} (expected {expected} each)')
  for name, count in counts.items():
    check(count > 0, f'{name} was not launched while serving')
    check(count == expected, f'{name}: {count} launches, expected {expected}')
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
    kernels = run_phase('kernels', phase_kernels, model, device,
                        torch.Generator(device).manual_seed(args.seed),
                        device_name)
    counts, first_request = run_phase(
        'serve', phase_serve, model, state, np.random.RandomState(args.seed))
    run_phase('parity', phase_parity, model, state, first_request)
  except Exception as e:  # report the failing phase, then fail the run
    print(f'FAILED: {type(e).__name__}: {e}', file=sys.stderr, flush=True)
    raise
  sources = {'nerf_mlp_forward': 'nerfies_tpu/ops/fused_mlp.py:78',
             'warp_trunk_forward': 'nerfies_tpu/ops/fused_mlp.py:645'}
  lines = []
  for name, replaces in sources.items():
    k = kernels[name]
    lines.append({
        'name': name, 'route': 'cuda',
        'source': 'nerfies_tpu_torch/csrc/fused_mlp.cu', 'replaces': replaces,
        'launches': counts[name], 'max_abs_err': k['max_abs_err'],
        'ms': k['ms'], 'plain_ms': k['plain_ms'], 'bound_ms': k['bound_ms'],
        'bound_by': k['bound_by'], 'library_ms': k['library_ms'],
        'rows': k['rows']})
  print(f'total: {time.perf_counter() - total:.2f} s '
        f'(build {build_seconds:.2f} s)')
  print(json.dumps({'kernels': lines}))
  print(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
      'count': torch.cuda.device_count()}}))
  return 0


if __name__ == '__main__':
  sys.exit(main())
