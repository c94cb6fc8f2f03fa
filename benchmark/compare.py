"""The numbers that decide `correct`: the program's outputs against the
reference's, each a gap that its limit (limits/<workload>.json) bounds.

Training (the first checked steps of a run):
  loss_gap    the largest |program - reference| / |reference| of a step's
              total loss;
  grad_gap    the first gradient as Adam got it, by the worst leaf:
              | |g_program| - |g_reference| | over the larger of the
              reference leaf's norm and the median leaf's;
  update_gap  the same of each leaf's change over the checked steps;
  rows_off    rows of the checked steps' batches that are no pixel of the
              capture (made again from the seed): a row's direction, rgb,
              origin and metadata ids have to be one pixel's, bit for bit,
              and no pixel comes twice; each background point has to be
              a distinct point of the capture's. Exact: its limit is 0.
Leaves whose reference gradient is under a thousandth of the median
leaf's (nought but for rounding, as a table no row of the batch reads)
take no part in either norm gap: under Adam they move by round-off alone.

Rendering (frames drawn from the seed among the window's):
  rgb_gap          the largest mean |program - reference| of a frame's rgb;
  rgb_max_gap      the largest |program - reference| of one pixel's channel;
  depth_noise_gap  the largest standard deviation over a frame's pixels of
                   program - reference expected depth, over the reference
                   frame's mean depth;
  acc_noise_gap    the same of the opacity, unscaled.
Depth and opacity are held by the spread of their gap over the pixels, not
by its mean: the mean is nearly one offset a frame, set by how the seed's
weights happen to round, and swings severalfold from seed to seed, in the
program and in the control alike.
A number that is not finite reads as infinite.
"""

import math
from typing import Dict, List, Sequence

import numpy as np
import torch

NEGLIGIBLE_GRAD = 1e-3


def _finite(x: float) -> float:
  return x if math.isfinite(x) else math.inf


def _norms(tree: Dict[str, torch.Tensor]) -> Dict[str, float]:
  return {k: float(torch.linalg.norm(v.detach().float())) for k, v in
          tree.items()}


def leaf_gaps(program: Dict[str, float], ref: Dict[str, float],
              keys: Sequence[str]) -> Dict[str, float]:
  """| |program| - |reference| | of each leaf over the larger of the
  reference leaf's norm and the median leaf's."""
  median = float(np.median([ref[k] for k in keys]))
  return {k: _finite(abs(program[k] - ref[k]) / max(ref[k], median))
          for k in keys}


def moving_leaves(ref_grads: Dict[str, torch.Tensor]) -> List[str]:
  norms = _norms(ref_grads)
  median = float(np.median(list(norms.values())))
  return sorted(k for k, n in norms.items() if n >= NEGLIGIBLE_GRAD * median)


def train_numbers(program, ref, params0: Dict[str, torch.Tensor]
                  ) -> Dict[str, float]:
  """program, ref: (losses a step, first gradients, params after the
  checked steps), the trees flat {'a/b/kernel': tensor}."""
  losses_p, grads_p, params_p = program
  losses_r, grads_r, params_r = ref
  loss_gap = max(_finite(abs(p - r) / abs(r)) for p, r in
                 zip(losses_p, losses_r))
  if len(losses_p) != len(losses_r):
    loss_gap = math.inf
  keys = moving_leaves(grads_r)
  delta = lambda params: {k: params[k].float() - params0[k].float()
                          for k in keys}
  grad = leaf_gaps(_norms(grads_p), _norms(grads_r), keys)
  update = leaf_gaps(_norms(delta(params_p)), _norms(delta(params_r)), keys)
  return {'loss_gap': loss_gap, 'grad_gap': max(grad.values()),
          'update_gap': max(update.values())}


def render_numbers(program: List[Dict[str, np.ndarray]],
                   ref: List[Dict[str, np.ndarray]]) -> Dict[str, float]:
  out = {'rgb_gap': 0.0, 'rgb_max_gap': 0.0, 'depth_noise_gap': 0.0,
         'acc_noise_gap': 0.0}
  if not program or len(program) != len(ref):
    return {k: math.inf for k in out}
  for p, r in zip(program, ref):
    gap = {k: p[k].astype(np.float64) - r[k] for k in ('rgb', 'depth', 'acc')}
    rgb = np.abs(gap['rgb'])
    values = {'rgb_gap': rgb.mean(), 'rgb_max_gap': rgb.max(),
              'depth_noise_gap': gap['depth'].std() / np.abs(
                  r['depth']).mean(),
              'acc_noise_gap': gap['acc'].std()}
    for k, v in values.items():
      out[k] = max(out[k], _finite(float(v)))
  return out


def _row_keys(rows: np.ndarray) -> np.ndarray:
  """A 64-bit key of each row of 32-bit numbers, from their bits."""
  bits = np.ascontiguousarray(rows, np.float32).view(np.uint32)
  key = np.zeros(len(rows), np.uint64)
  for column in bits.T.astype(np.uint64):
    key = (key * np.uint64(0x100000001B3)) ^ column
  return key


class _RowIndex:
  """Finds rows of float32 `table` by their bits."""

  def __init__(self, table: np.ndarray):
    self.table = table
    keys = _row_keys(table)
    self.order = np.argsort(keys, kind='stable')
    self.keys = keys[self.order]

  def find(self, rows: np.ndarray):
    """(index into the table of each row, whether it is that row)."""
    rows = np.asarray(rows, np.float32)
    keys = _row_keys(rows)
    pos = np.minimum(np.searchsorted(self.keys, keys), len(self.keys) - 1)
    index = self.order[pos]
    found = (self.keys[pos] == keys) & (self.table[index] == rows).all(1)
    return index, found


def _off(found: np.ndarray, index: np.ndarray) -> int:
  """Rows not found, and found rows that repeat an earlier one."""
  kept = index[found]
  return int((~found).sum()) + len(kept) - len(np.unique(kept))


def rows_off(batches: List[Dict], capture) -> int:
  """Rows of `batches` (the program's host batches) that are no pixel of
  `capture` (scene.Capture), and background points that are none of its."""
  rays, points = _RowIndex(capture.directions), _RowIndex(capture.points)
  pixels, found, point_rows, point_found = [], [], [], []
  for batch in batches:
    index, ok = rays.find(batch['directions'])
    rgb = capture.rgb[index].astype(np.float32) / 255.0
    ok &= (rgb == np.asarray(batch['rgb'])).all(1)
    frame = capture.image_idx[index]
    ok &= (capture.origins[frame] == np.asarray(batch['origins'])).all(1)
    for name, table in capture.metadata.items():
      ok &= (table[frame] == np.asarray(batch['metadata'][name])).all(1)
    pixels.append(index)
    found.append(ok)
    index, ok = points.find(batch['background_points'])
    point_rows.append(index)
    point_found.append(ok)
  if not batches:
    return 0
  return (_off(np.concatenate(found), np.concatenate(pixels))
          + _off(np.concatenate(point_found), np.concatenate(point_rows)))


def judge(numbers: Dict[str, float], limits: Dict[str, float]):
  """(correct, [(name, value, limit)]) over the numbers that have limits."""
  rows = [(name, numbers.get(name, math.inf), limit)
          for name, limit in sorted(limits.items())]
  return all(value <= limit for _, value, limit in rows), rows
