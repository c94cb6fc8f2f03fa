"""A cell of BENCHMARK.json cut to a size the CPU runs in seconds.

The widths stay as published; the rays, samples, frames and points shrink,
to a size at which the sound program still reads inside the cells' limits
(which were set at the cells' own sizes on the card). Only the CPU tests
use it: the benchmark itself never runs a cut cell.
"""

import copy
import dataclasses

from benchmark import manifest


def tiny_cell(name: str):
  cell = manifest.load_cell(name)
  config = copy.deepcopy(cell.config)
  config['model'].update(num_coarse_samples=16, num_fine_samples=16)
  config['train'].update(batch_size=128, background_points_batch_size=64)
  config['scene'].update(image_width=32, image_height=24)
  config['eval']['chunk'] = 256
  traffic = dict(cell.traffic)
  if traffic['kind'] == 'train':
    traffic['background_points'] = 256
  return dataclasses.replace(cell, config=config, traffic=traffic)
