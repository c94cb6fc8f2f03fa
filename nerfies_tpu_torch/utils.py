"""Host-side utilities: meters, interpolation, batching helpers.

Port of nerfies_tpu/utils.py: `parallel_map`, `strided_subset`,
`ValueMeter` and `TimeTracker` of the training loop; the camera-path and
latent-code interpolation (numpy and scipy, as in JAX); `robust_whiten`,
`learning_rate_decay`, `normalize`, `broadcast_feature_to`,
`metadata_like`, `tree_collate` and `print_time`; `to_device`, an
explicit move onto a device (JAX's moves onto its default one);
`fold_in`, the port's `random.fold_in`; and `span` / `spanned`, the named
program ranges that torch.profiler records. The differentiable helpers
that JAX's module re-exports live in `ops/mathutils.py`.
"""

import collections
import contextlib
import functools
import time
from concurrent import futures
from typing import List, Union

import numpy as np
from scipy import interpolate
from scipy.spatial import transform as scipy_transform
import torch

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
  """A range named `name` in torch.profiler's trace while a profiler is on,
  else a shared no-op context.

  The range is `torch.profiler.record_function(name)`: the profiler keeps
  it and writes it with its trace, as a `user_annotation` event on the
  thread that opened it, on the clock of the device ops' events. It keeps
  no clock or buffer here and launches no device op.
  """
  if torch.autograd._profiler_enabled():
    return torch.profiler.record_function(name)
  return _NO_SPAN


def spanned(name: str):
  """Runs each call of the decorated function inside `span(name)`."""
  def decorate(fn):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
      with span(name):
        return fn(*args, **kwargs)
    return wrapper
  return decorate


def fold_in(seed: int, index: int, device) -> torch.Generator:
  """A generator on `device` seeded from (seed, index), the counterpart of
  `random.fold_in(rng, index)`: a step's or a render chunk's stream."""
  mixed = (int(seed) * 0x9E3779B97F4A7C15 + int(index)) % (1 << 63)
  return torch.Generator(device).manual_seed(mixed)


def robust_whiten(x: torch.Tensor) -> torch.Tensor:
  """(x - median) / mean absolute deviation, ignoring NaNs (the median of
  an even count is the mean of the middle two, as jnp.nanmedian's)."""
  median = torch.nanquantile(x.reshape(-1), 0.5)
  mad = torch.nanmean(torch.abs(x - median))
  return (x - median) / mad


def learning_rate_decay(step, init_lr=5e-4, decay_steps=100000,
                        decay_rate=0.1):
  """lr = init_lr * decay_rate**(step / decay_steps)."""
  power = step / decay_steps
  return init_lr * (decay_rate ** power)


def interpolate_codes(codes: Union[np.ndarray, List[np.ndarray]],
                      num_samples: int, method: str = 'spline') -> np.ndarray:
  """Interpolates latent codes along the exemplar axis."""
  if isinstance(codes, list):
    codes = np.array(codes)
  t = np.arange(len(codes))
  xs = np.linspace(0, len(codes) - 1, num_samples)
  if method == 'spline':
    cs = interpolate.CubicSpline(t, codes, bc_type='natural')
    return cs(xs).astype(np.float32)
  if method == 'linear':
    interp = interpolate.interp1d(t, codes, axis=0)
    return interp(xs).astype(np.float32)
  raise ValueError(f'Unknown method {method!r}')


def interpolate_cameras(cameras, num_samples: int):
  """Slerp orientations + cubic-spline positions along a camera path."""
  rotations = [camera.orientation for camera in cameras]
  positions = [camera.position for camera in cameras]

  in_times = np.linspace(0, 1, len(rotations))
  slerp = scipy_transform.Slerp(
      in_times, scipy_transform.Rotation.from_matrix(rotations))
  spline = interpolate.CubicSpline(in_times, positions)

  out_times = np.linspace(0, 1, num_samples)
  out_rots = slerp(out_times).as_matrix()
  out_positions = spline(out_times)

  ref_camera = cameras[0]
  out_cameras = []
  for out_rot, out_pos in zip(out_rots, out_positions):
    out_camera = ref_camera.copy()
    out_camera.orientation = out_rot
    out_camera.position = out_pos
    out_cameras.append(out_camera)
  return out_cameras


def normalize(x):
  return x / np.linalg.norm(x)


def to_device(xs, device):
  """A nested dict of arrays (numpy, lists or tensors) -> the same dict of
  tensors on `device`, integers as int64 and the rest as float32."""
  if isinstance(xs, dict):
    return {k: to_device(v, device) for k, v in xs.items()}
  if not isinstance(xs, torch.Tensor):
    array = np.asarray(xs)
    xs = torch.from_numpy(np.ascontiguousarray(array).astype(
        np.int64 if np.issubdtype(array.dtype, np.integer) else np.float32))
  return xs.to(device, non_blocking=True)


def broadcast_feature_to(array: torch.Tensor, shape) -> torch.Tensor:
  """Broadcasts batch dims, keeping the array's own channel count."""
  return torch.broadcast_to(array, (*shape[:-1], array.shape[-1]))


def metadata_like(rays: torch.Tensor, metadata_id) -> torch.Tensor:
  """A metadata column shaped like a ray batch (int64, the port's id
  dtype; JAX's is uint32)."""
  return torch.full_like(rays[..., :1], metadata_id, dtype=torch.int64)


def tree_collate(list_of_trees):
  """Stacks a list of identical nested dicts leaf-wise (numpy)."""
  first = list_of_trees[0]
  if isinstance(first, dict):
    return {k: tree_collate([t[k] for t in list_of_trees]) for k in first}
  return np.stack(list_of_trees)


@contextlib.contextmanager
def print_time(name):
  start = time.time()
  yield
  print(f'[{name}] time elapsed: {time.time() - start:.04f}')


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
