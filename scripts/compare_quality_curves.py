#!/usr/bin/env python3
"""Compares a quality curve with a reference curve, step by step.

Both files are quality bench curves (`python -m
nerfies_tpu_torch.quality_bench --out ...` or scripts/quality_bench.py):

  python3 scripts/compare_quality_curves.py docs/quality_curve.json \\
      nerfies_tpu_torch/curves/quality_curve_h100.json --steps 2000 4000 6000

For each step that both curves reached it prints the candidate's val
PSNR, train-view PSNR and val MS-SSIM less the reference's, and its train
loss over the reference's. The bar, at each such step: neither PSNR more
than 1.0 dB below the reference's, MS-SSIM no more than 0.005 below, train
loss no more than 1.5 times the reference's. A metric that either curve
lacks (null) misses the bar. With --steps, each step named must be in
both curves. Exits 0 when every compared row meets the bar, 1 otherwise
(a row outside it, a step missing, or no step shared). Imports no JAX.
"""

import argparse
import json
import pathlib
import sys
from typing import List, Optional, Sequence

PSNR_DROP_DB = 1.0
MS_SSIM_DROP = 0.005
LOSS_RATIO = 1.5


def load_curve(path) -> dict:
  """The curve's rows by step."""
  rows = json.loads(pathlib.Path(path).read_text())['curve']
  return {row['step']: row for row in rows}


def _difference(candidate, reference):
  if candidate is None or reference is None:
    return None
  return candidate - reference


def compare_row(reference: dict, candidate: dict) -> dict:
  """The differences of one step and the metrics that miss the bar."""
  row = {
      'step': reference['step'],
      'd_val_psnr': _difference(candidate.get('val_psnr'),
                                reference.get('val_psnr')),
      'd_train_view_psnr': _difference(candidate.get('train_view_psnr'),
                                       reference.get('train_view_psnr')),
      'd_val_ms_ssim': _difference(candidate.get('val_ms_ssim'),
                                   reference.get('val_ms_ssim')),
      'loss_ratio': (candidate['train_loss'] / reference['train_loss']
                     if candidate.get('train_loss') is not None
                     and reference.get('train_loss') else None),
  }
  misses = [key for key, floor in (('d_val_psnr', -PSNR_DROP_DB),
                                   ('d_train_view_psnr', -PSNR_DROP_DB),
                                   ('d_val_ms_ssim', -MS_SSIM_DROP))
            if row[key] is None or row[key] < floor]
  if row['loss_ratio'] is None or row['loss_ratio'] > LOSS_RATIO:
    misses.append('loss_ratio')
  row['misses'] = misses
  return row


def compare(reference: dict, candidate: dict,
            steps: Sequence[int] = ()) -> List[dict]:
  """One row a shared step, and a row with `missing` for each of `steps`
  that a curve lacks."""
  rows = [compare_row(reference[step], candidate[step])
          for step in sorted(set(reference) & set(candidate))]
  for step in steps:
    if step not in reference or step not in candidate:
      rows.append({'step': step, 'missing': [
          name for name, curve in (('reference', reference),
                                   ('candidate', candidate))
          if step not in curve]})
  return sorted(rows, key=lambda row: row['step'])


def _format(value: Optional[float], spec: str) -> str:
  return 'n/a' if value is None else format(value, spec)


def main(argv: Optional[Sequence[str]] = None) -> int:
  parser = argparse.ArgumentParser(
      description='Compares a quality curve with a reference curve.')
  parser.add_argument('reference', help='the reference curve (JSON)')
  parser.add_argument('candidate', help='the curve held to it (JSON)')
  parser.add_argument('--steps', type=int, nargs='*', default=(),
                      help='steps that both curves must hold')
  args = parser.parse_args(argv)
  rows = compare(load_curve(args.reference), load_curve(args.candidate),
                 args.steps)
  print(f'bar: PSNR >= -{PSNR_DROP_DB} dB, MS-SSIM >= -{MS_SSIM_DROP}, '
        f'train loss <= {LOSS_RATIO}x the reference')
  print('step | d val PSNR dB | d train-view PSNR dB | d val MS-SSIM | '
        'train loss ratio | verdict')
  failed = not rows
  for row in rows:
    if 'missing' in row:
      failed = True
      print(f"{row['step']} | missing from the "
            f"{' and '.join(row['missing'])}")
      continue
    failed = failed or bool(row['misses'])
    verdict = ('meets the bar' if not row['misses']
               else 'misses: ' + ', '.join(row['misses']))
    print(f"{row['step']} | {_format(row['d_val_psnr'], '+.5f')} | "
          f"{_format(row['d_train_view_psnr'], '+.5f')} | "
          f"{_format(row['d_val_ms_ssim'], '+.6f')} | "
          f"{_format(row['loss_ratio'], '.4f')} | {verdict}")
  if not rows:
    print('no step in both curves')
  print('FAIL' if failed else 'OK')
  return 1 if failed else 0


if __name__ == '__main__':
  sys.exit(main())
