"""What every kind of traffic shares, and the lookup of a kind by name.

A traffic file's `kind` names a module benchmark/kinds/<kind>.py, found by
name as a metric's reader is. The module holds

  Runner(cell, seed, place)   the program under test, driven as its users
                              drive it: setup(), window(seconds) -> Window,
                              stretch() -> units, release(), check() ->
                              {number: value}, and `phases` after setup;
  readings(cell, seed, control, place, window_s)
                              [(mode, numbers)] for calibrate.py: the sound
                              program's and, with `control`, the control's
                              and each fault's.

A cell on several chips runs one Runner a chip, each in a process of its
own (run.py); `place` tells a runner its device, rank, world size and the
address at which the ranks meet.
"""

import dataclasses
import importlib.util
import time
from types import ModuleType
from typing import Dict, Optional

import numpy as np
import torch


@dataclasses.dataclass
class Place:
  """Where one runner runs: its device, and its rank among `world_size`
  processes that meet at `init_method` (None on one chip)."""
  device: torch.device
  rank: int = 0
  world_size: int = 1
  init_method: Optional[str] = None


def kind(name: str, cell) -> ModuleType:
  """benchmark/kinds/<name>.py of the checkout `cell` was loaded from."""
  path = cell.root / 'benchmark' / 'kinds' / f'{name}.py'
  if not path.is_file():
    raise KeyError(f'no traffic kind {name!r} ({path} does not exist)')
  spec = importlib.util.spec_from_file_location(f'benchmark_kind_{name}',
                                                path)
  module = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(module)
  return module


def runner(cell, seed: int, place: Place):
  return kind(cell.traffic['kind'], cell).Runner(cell, seed, place)


def step_generator(seed: int, step: int, device) -> torch.Generator:
  """The random stream handed to step `step` (1-based) of a run."""
  mixed = (int(seed) * 0x9E3779B97F4A7C15 + int(step)) % (1 << 63)
  return torch.Generator(device=device).manual_seed(mixed)


def sync(device) -> None:
  if torch.device(device).type == 'cuda':
    torch.cuda.synchronize(device)


def free(device) -> None:
  """Returns the freed blocks of the card's caching allocator."""
  if torch.device(device).type == 'cuda':
    torch.cuda.empty_cache()


class Phases:
  """Host seconds of each set-up phase, in order."""

  def __init__(self):
    self.seconds: Dict[str, float] = {}
    self._last = time.perf_counter()

  def mark(self, name: str, device=None) -> None:
    if device is not None:
      sync(device)
    now = time.perf_counter()
    self.seconds[name] = now - self._last
    self._last = now


@dataclasses.dataclass
class Window:
  """What the measured window did: each rank counts its own share of the
  units and rays."""
  units: int  # steps or frames
  rays: int
  seconds: float
  data_wait_s: float = 0.0
  failed: int = 0


def num_ids(cell) -> Dict[str, int]:
  model = cell.config['model']
  ids = cell.traffic['ids']
  out = {}
  if model['use_warp']:
    out['warp'] = ids['warp']
  if model['use_camera_metadata']:
    out['camera'] = ids['camera']
  if model['use_appearance_metadata']:
    out['appearance'] = ids['appearance']
  return out


def model_config(cell, **changes):
  from nerfies_tpu_torch import configs
  fields = dict(cell.config['model'], **changes)
  fields['nerf_skips'] = tuple(fields['nerf_skips'])
  return configs.ModelConfig(**fields)


def build_model(cell, params, use_elastic: bool, **changes):
  from nerfies_tpu_torch.models import nerf
  ids = cell.traffic['ids']
  return nerf.NerfModel(
      model_config(cell, **changes), params, cell.traffic['near'],
      cell.traffic['far'], appearance_ids=tuple(range(ids['appearance'])),
      camera_ids=tuple(range(ids['camera'])),
      warp_ids=tuple(range(ids['warp'])), use_warp_jacobian=use_elastic,
      use_weights=use_elastic)


def tensors(batch, device):
  """A host batch as float32 / int64 tensors on `device`."""
  out = {}
  for key, value in batch.items():
    if isinstance(value, dict):
      out[key] = tensors(value, device)
    else:
      array = np.asarray(value)
      dtype = np.int64 if np.issubdtype(array.dtype, np.integer) else np.float32
      out[key] = torch.from_numpy(array.astype(dtype)).to(device)
  return out
