"""Host-side helpers of the training loop: a thread-pool map and meters.

Port of the parts of nerfies_tpu/utils.py that the training and eval CLIs
use: `parallel_map`, `strided_subset`, `ValueMeter` and `TimeTracker`;
and `fold_in`, the port's `random.fold_in`.
"""

import collections
import contextlib
import time
from concurrent import futures

import numpy as np
import torch


def fold_in(seed: int, index: int, device) -> torch.Generator:
  """A generator on `device` seeded from (seed, index), the counterpart of
  `random.fold_in(rng, index)`: a step's or a render chunk's stream."""
  mixed = (int(seed) * 0x9E3779B97F4A7C15 + int(index)) % (1 << 63)
  return torch.Generator(device).manual_seed(mixed)


def parallel_map(f, iterable, max_threads=None, show_pbar=False, **kwargs):
  """Thread-pool version of map()."""
  with futures.ThreadPoolExecutor(max_threads) as executor:
    results = executor.map(f, iterable, **kwargs)
    if show_pbar:
      try:
        import tqdm
        results = tqdm.tqdm(results, total=len(iterable))
      except ImportError:
        pass
    return list(results)


def strided_subset(sequence, count):
  """Every k-th element so that ~count remain.

  count=None keeps everything (reference eval.py semantics); count=0
  selects nothing.
  """
  if count is None:
    return sequence
  if count == 0:
    return type(sequence)()
  stride = max(1, len(sequence) // count)
  return sequence[::stride]


class ValueMeter:
  """Tracks running statistics of a scalar stream."""

  def __init__(self):
    self._values = []

  def reset(self):
    self._values.clear()

  def update(self, value):
    self._values.append(value)

  def reduce(self, reduction='mean'):
    if reduction == 'mean':
      return np.mean(self._values)
    if reduction == 'std':
      return np.std(self._values)
    if reduction == 'last':
      return self._values[-1]
    raise ValueError(f'Unknown reduction {reduction}')


class TimeTracker:
  """tic/toc wall-clock buckets with steps/sec summaries."""

  def __init__(self):
    self._meters = collections.defaultdict(ValueMeter)
    self._marked_time = collections.defaultdict(float)

  @contextlib.contextmanager
  def record_time(self, key: str):
    start = time.time()
    yield
    self.update(key, time.time() - start)

  def update(self, key, value):
    self._meters[key].update(value)

  def tic(self, *args):
    for key in args:
      self._marked_time[key] = time.time()

  def toc(self, *args):
    for key in args:
      self.update(key, time.time() - self._marked_time[key])
      del self._marked_time[key]

  def reset(self):
    for meter in self._meters.values():
      meter.reset()

  def values(self, key):
    """The times recorded under `key` since the last reset."""
    return list(self._meters[key]._values)

  def summary(self, reduction='mean'):
    time_dict = {k: v.reduce(reduction) for k, v in self._meters.items()}
    if 'total' not in time_dict:
      time_dict['total'] = sum(time_dict.values())
    time_dict['steps_per_sec'] = 1.0 / max(time_dict['total'], 1e-12)
    return time_dict

  def summary_str(self, reduction='mean'):
    return ', '.join(
        f'{k}={v:.04f}' for k, v in self.summary(reduction).items())
