"""Checkpoints of a training.TrainState on torch.save.

The counterpart of nerfies_tpu/checkpoints.py (orbax): step-numbered
directories under the checkpoint directory, the newest `keep` kept, each
written under a temporary name and moved into place with os.replace, and
restore-latest-or-initial. A checkpoint is `<step>/state.pt`, a dict with
the JAX state's names: `step`, `params`, `opt_state` (`count`, `mu`,
`nu`), `warp_alpha` and `time_alpha`, tensors as detached CPU copies.

The port cannot read an orbax checkpoint of the JAX package: restoring
from a directory whose newest step the port did not write raises.

Under a data-parallel run (parallel/mesh.py) a save is collective, as
orbax's is: rank 0 writes, then every rank passes a barrier; every rank
restores, onto its own device.
"""

import os
import shutil
from pathlib import Path
from typing import List, Optional, Tuple

import torch

from nerfies_tpu_torch import training
from nerfies_tpu_torch.ops import fused_mlp
from nerfies_tpu_torch.parallel import mesh

STATE_FILE = 'state.pt'
FORMAT = 'nerfies_tpu_torch.TrainState'


def _cpu(t: torch.Tensor) -> torch.Tensor:
  return t.detach().to('cpu', copy=True)


def _step_dirs(ckpt_dir: Path) -> List[Tuple[int, Path]]:
  """(step, path) of the step-numbered entries, oldest first."""
  if not ckpt_dir.is_dir():
    return []
  return sorted((int(p.name), p) for p in ckpt_dir.iterdir()
                if p.name.isdigit())


def save_checkpoint(ckpt_dir, state: training.TrainState,
                    step: Optional[int] = None, keep: int = 2) -> str:
  """Saves `state` at `step` (defaults to state.step), keeping `keep` newest.

  Collective under a process group: rank 0 writes, every rank waits.

  Returns:
    The checkpoint's directory.
  """
  ckpt_dir = Path(ckpt_dir)
  step = int(state.step if step is None else step)
  if mesh.is_main():
    _write(ckpt_dir, state, step, keep)
  mesh.barrier()
  return str(ckpt_dir / str(step))


def _write(ckpt_dir: Path, state: training.TrainState, step: int,
           keep: int) -> None:
  ckpt_dir.mkdir(parents=True, exist_ok=True)
  payload = {
      'format': FORMAT,
      'step': int(state.step),
      'params': training._map(_cpu, state.params),
      'opt_state': {'count': int(state.opt_state.count),
                    'mu': training._map(_cpu, state.opt_state.mu),
                    'nu': training._map(_cpu, state.opt_state.nu)},
      'warp_alpha': float(state.warp_alpha),
      'time_alpha': float(state.time_alpha),
  }
  tmp = ckpt_dir / f'.tmp-{step}-{os.getpid()}'
  shutil.rmtree(tmp, ignore_errors=True)
  tmp.mkdir()
  torch.save(payload, tmp / STATE_FILE)
  final = ckpt_dir / str(step)
  if final.exists():
    shutil.rmtree(final)
  os.replace(tmp, final)
  for _, old in _step_dirs(ckpt_dir)[:-keep]:
    shutil.rmtree(old)


def latest_checkpoint_step(ckpt_dir) -> Optional[int]:
  steps = _step_dirs(Path(ckpt_dir))
  return steps[-1][0] if steps else None


def _check_structure(got, want, where):
  if isinstance(want, dict):
    if not isinstance(got, dict) or set(got) != set(want):
      raise ValueError(f'checkpoint {where}: keys {sorted(got)} differ from '
                       f'the state\'s {sorted(want)}')
    for k in want:
      _check_structure(got[k], want[k], f'{where}/{k}')
  elif tuple(got.shape) != tuple(want.shape):
    raise ValueError(f'checkpoint {where}: shape {tuple(got.shape)}, the '
                     f'state\'s {tuple(want.shape)}')


def restore_checkpoint(ckpt_dir, state: training.TrainState
                       ) -> training.TrainState:
  """Restores the newest checkpoint into the structure of `state`.

  Returns `state` unchanged when there is no checkpoint. The tensors go to
  the device of the state's params; the params require grad.

  Raises:
    ValueError: the newest step directory is not the port's (an orbax
      checkpoint of the JAX package, for one), or its tree differs from
      the state's.
  """
  steps = _step_dirs(Path(ckpt_dir))
  if not steps:
    return state
  path = steps[-1][1] / STATE_FILE
  payload = None
  if path.is_file():
    payload = torch.load(path, map_location='cpu', weights_only=True)
  if not isinstance(payload, dict) or payload.get('format') != FORMAT:
    raise ValueError(
        f'{steps[-1][1]} is not a checkpoint of nerfies_tpu_torch (no '
        f'{STATE_FILE} of its format): the port cannot read orbax '
        'checkpoints of the JAX package')
  _check_structure(payload['params'], state.params, 'params')
  _check_structure(payload['opt_state']['mu'], state.opt_state.mu, 'mu')
  _check_structure(payload['opt_state']['nu'], state.opt_state.nu, 'nu')
  device = fused_mlp.flatten_tree(state.params)[0][1].device
  to_device = lambda t: t.to(device)
  return training.TrainState(
      step=int(payload['step']),
      params=training._map(lambda t: t.to(device).requires_grad_(True),
                           payload['params']),
      opt_state=training.AdamState(
          int(payload['opt_state']['count']),
          training._map(to_device, payload['opt_state']['mu']),
          training._map(to_device, payload['opt_state']['nu'])),
      warp_alpha=float(payload['warp_alpha']),
      time_alpha=float(payload['time_alpha']))

