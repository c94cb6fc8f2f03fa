#!/usr/bin/env python3
"""Times the warp trunk's backward kernel on one CUDA card.

`fused_warp.warp_mlp_backward` without dx, as training calls it, at the
bench train step's two warp launches of rows (6144 rays): the coarse
level's 786,432 points with 3 tangents and the fine level's 1,572,864
with none; bench model widths (warp trunk 6 x 128, skip 4, 6 warp
frequencies, 8 embedding features), random weights and inputs from the
seed. Median milliseconds of --reps runs after one warm-up, CUDA events.

It imports the nerfies_tpu_torch package of the checkout that holds this
script, so a copy of it placed in another checkout's scripts/ times that
checkout's kernels: run the two in turns in one call (A, B, B, A) to
compare them on one card. Prints the card's name and power limit, then one
JSON line.

Usage: python3 scripts/time_warp_backward.py [--seed 0] [--reps 5]
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
from nerfies_tpu_torch.ops import fused_warp

TRAIN_BATCH = 6144
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
  warp = params['warp_field']
  depth = int(model.warp_kwargs.get('trunk_depth', 6))
  skips = tuple(model.warp_kwargs.get('skips', (4,)))
  width = warp['trunk']['hidden_0']['kernel'].shape[1]
  # A Glorot head, as chip_smoke.py uses: the 1e-4 init would hide errors.
  head = modules.mlp([width], 0, width, output_channels=6,
                     generator=torch.Generator().manual_seed(1))
  warp_params = {'trunk': warp['trunk'],
                 'head': {'logit': {k: v.to(device)
                                    for k, v in head['logit'].items()}}}
  generator = torch.Generator(device).manual_seed(args.seed + 1)
  cases = []
  for samples, nt in ((model.num_coarse_samples, 3),
                      (model.num_coarse_samples + model.num_fine_samples, 0)):
    n = TRAIN_BATCH * samples
    pts = torch.randn(n, 3, generator=generator, device=device)
    x, ts = encoding.posenc_with_tangents(pts, model.num_warp_freqs,
                                          alpha=WARP_ALPHA)
    ts = list(ts)[:nt]
    e = 0.05 * torch.rand(n, model.num_warp_features, generator=generator,
                          device=device)
    go = torch.randn(n, 8, generator=generator, device=device)
    gjs = [torch.randn(n, 8, generator=generator, device=device)
           for _ in range(nt)]
    ms = time_ms(lambda: fused_warp.warp_mlp_backward(
        x, e, ts, warp_params, go, gjs, trunk_depth=depth, skips=skips,
        need_dx=False), args.reps)
    print(f'warp_mlp_backward rows={n} tangents={nt}: {ms:.3f} ms')
    cases.append({'rows': n, 'tangents': nt, 'ms': ms})
    del x, ts, e, go, gjs, pts
  print(json.dumps({'kernel': 'warp_mlp_backward', 'need_dx': False,
                    'device': torch.cuda.get_device_name(0),
                    'cases': cases}))
  return 0


if __name__ == '__main__':
  sys.exit(main())
