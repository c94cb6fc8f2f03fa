"""The readings that the limits in limits/<workload>.json are set from.

  python3 benchmark/calibrate.py --workload vrig_paper.train \
      --seeds 1 2 3 4 5 6 7 8 9 10 11 12 --control_seeds 1 2 3

For each seed, the cell's set-up (a render cell also renders a short
window) and the comparison that decides `correct`, with the reference in
float32 ('program'). For each control seed also the control, the reference
in fp8 (reference.Reference(precision='fp8')) put in the program's place,
and each fault its kind plants (`readings` of benchmark/kinds/<kind>.py).
A state left unchanged reads 1 on update_gap by its measure and needs no
run. One JSON line a reading on standard output. Not run by the
benchmark's own runs.
"""

import argparse
import json
import pathlib
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
  sys.path.insert(0, str(ROOT))

from benchmark import cells  # noqa: E402
from benchmark import manifest  # noqa: E402


def readings(cell, seed: int, control: bool, device, window_s: float):
  """[(mode, numbers)] of one seed."""
  place = cells.Place(torch.device(device))
  return cells.kind(cell.traffic['kind'], cell).readings(
      cell, seed, control, place, window_s)


def main(argv=None) -> int:
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument('--workload', required=True)
  parser.add_argument('--seeds', type=int, nargs='+', required=True)
  parser.add_argument('--control_seeds', type=int, nargs='*', default=[])
  parser.add_argument('--window', type=float, default=1.5,
                      help='seconds of frames a render cell renders')
  args = parser.parse_args(argv)
  cell = manifest.load_cell(args.workload)
  if not torch.cuda.is_available():
    print('calibrate.py reads the cells on the card; none found',
          file=sys.stderr)
    return 2
  for seed in args.seeds:
    start = time.perf_counter()
    for mode, numbers in readings(cell, seed, seed in args.control_seeds,
                                  'cuda', args.window):
      print(json.dumps({'workload': cell.name, 'seed': seed, 'mode': mode,
                        **numbers}), flush=True)
    print(f'# seed {seed}: {time.perf_counter() - start:.1f} s',
          file=sys.stderr, flush=True)
  return 0


if __name__ == '__main__':
  sys.exit(main())
