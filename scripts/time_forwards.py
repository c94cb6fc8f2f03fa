#!/usr/bin/env python3
"""Times the three forward kernels on one CUDA card.

`fused_mlp.nerf_mlp_forward` (with the rgb row bias) and
`fused_mlp.warp_trunk_forward` (row biases at layer 0 and the skip) at the
row counts one serving chunk of 8192 rays gives them: 1,048,576 (128
coarse samples a ray) and 2,097,152 (128 + 128 fine). Then
`fused_warp.warp_mlp_forward`, the training warp, at the three launches of
a bench train step (6144 rays): 786,432 rows with 3 tangents (coarse),
1,572,864 and 16,384 rows with none (fine, background points). Bench
model widths (NeRF 8 x 256, skip 4, rgb branch 128; warp trunk 6 x 128,
skip 4, 8 embedding features), random weights and inputs from the seed.
Median milliseconds of --reps runs after one warm-up, CUDA events.

It imports the nerfies_tpu_torch package of the checkout that holds this
script, so a copy of it placed in another checkout's scripts/ times that
checkout's kernels: run the two in turns in one call (A, B, B, A) to
compare them on one card. Prints the card's name and power limit, then one
JSON line.

Usage: python3 scripts/time_forwards.py [--seed 0] [--reps 5]
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from nerfies_tpu_torch import configs  # pylint: disable=g-import-not-at-top
from nerfies_tpu_torch.models import modules
from nerfies_tpu_torch.models import nerf
from nerfies_tpu_torch.ops import encoding
from nerfies_tpu_torch.ops import fused_mlp
from nerfies_tpu_torch.ops import fused_warp

CHUNK = 8192
TRAIN_BATCH = 6144
TRAIN_BACKGROUND_POINTS = 16384
WARP_ALPHA = 6.0


def time_ms(fn, reps):
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


@torch.no_grad()
def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument('--seed', type=int, default=0)
  parser.add_argument('--reps', type=int, default=5)
  args = parser.parse_args(argv)
  if not torch.cuda.is_available():
    print('needs a CUDA card', file=sys.stderr)
    return 1
  smi = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
      capture_output=True, text=True, timeout=60, check=True)
  print(smi.stdout.strip().splitlines()[0])
  torch.backends.cuda.matmul.allow_tf32 = False
  device = torch.device('cuda', 0)
  model, params = nerf.construct_nerf(
      configs.bench_render_config(), **configs.BENCH_RENDER_IDS,
      generator=torch.Generator().manual_seed(args.seed), device=device)
  mlp = params['nerf_mlps_coarse']
  rgb_width = mlp['rgb_logit']['kernel'].shape[0]
  warp = params['warp_field']
  warp_depth = int(model.warp_kwargs.get('trunk_depth', 6))
  warp_skips = tuple(model.warp_kwargs.get('skips', (4,)))
  warp_width = warp['trunk']['hidden_0']['kernel'].shape[1]
  # A Glorot head, as chip_smoke.py uses: the 1e-4 init would hide errors.
  head = modules.mlp([warp_width], 0, warp_width, output_channels=6,
                     generator=torch.Generator().manual_seed(1))
  warp_params = {'trunk': warp['trunk'],
                 'branches_wv': {'logit': {k: v.to(device) for k, v in
                                           head['logit'].items()}}}
  generator = torch.Generator(device).manual_seed(args.seed + 1)

  def randn(*shape):
    return torch.randn(*shape, generator=generator, device=device)

  cases = []
  for samples in (model.num_coarse_samples,
                  model.num_coarse_samples + model.num_fine_samples):
    n = CHUNK * samples
    pts = randn(n, 3)
    x = encoding.posenc(pts, model.num_nerf_point_freqs)
    rb = randn(n, rgb_width).to(torch.bfloat16)
    ms = time_ms(lambda: fused_mlp.nerf_mlp_forward(
        x, rb, mlp, trunk_depth=model.nerf_trunk_depth,
        skips=model.nerf_skips), args.reps)
    print(f'nerf_mlp_forward rows={n}: {ms:.3f} ms')
    cases.append({'kernel': 'nerf_mlp_forward', 'rows': n, 'ms': ms})
    del x, rb
    x = encoding.posenc(pts, model.num_warp_freqs, alpha=WARP_ALPHA)
    biases = [(i, randn(n, warp_width).to(torch.bfloat16))
              for i in (0,) + warp_skips]
    ms = time_ms(lambda: fused_mlp.warp_trunk_forward(
        x, biases, warp_params, trunk_depth=warp_depth, skips=warp_skips),
                 args.reps)
    print(f'warp_trunk_forward rows={n}: {ms:.3f} ms')
    cases.append({'kernel': 'warp_trunk_forward', 'rows': n, 'ms': ms})
    del x, biases, pts
  # The training warp: a Glorot head under 'head', as chip_smoke.py.
  train_params = {'trunk': warp['trunk'],
                  'head': warp_params['branches_wv']}
  coarse = TRAIN_BATCH * model.num_coarse_samples
  fine = TRAIN_BATCH * (model.num_coarse_samples + model.num_fine_samples)
  for n, nt in ((coarse, 3), (fine, 0), (TRAIN_BACKGROUND_POINTS, 0)):
    pts = randn(n, 3)
    if nt:
      x, ts = encoding.posenc_with_tangents(pts, model.num_warp_freqs,
                                            alpha=WARP_ALPHA)
    else:
      x, ts = encoding.posenc(pts, model.num_warp_freqs, alpha=WARP_ALPHA), []
    e = 0.05 * torch.rand(n, model.num_warp_features, generator=generator,
                          device=device)
    ms = time_ms(lambda: fused_warp.warp_mlp_forward(
        x, e, ts, train_params, trunk_depth=warp_depth, skips=warp_skips),
                 args.reps)
    print(f'warp_mlp_forward rows={n} tangents={nt}: {ms:.3f} ms')
    cases.append({'kernel': 'warp_mlp_forward', 'rows': n, 'tangents': nt,
                  'ms': ms})
    del x, ts, e, pts
  print(json.dumps({'device': torch.cuda.get_device_name(0),
                    'cases': cases}))
  return 0


if __name__ == '__main__':
  sys.exit(main())
