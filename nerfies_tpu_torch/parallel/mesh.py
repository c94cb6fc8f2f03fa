"""Data parallelism over the cards of one machine, one process per card.

The counterpart of nerfies_tpu/parallel/mesh.py. JAX shards the global
ray batch over a 1-D mesh of every device, replicates the params, and
XLA inserts the gradient all-reduce. Here each process (started by
`torchrun`, one per card) holds the params, takes its contiguous slice
of the global batch (`local_batch_slice`, as JAX's process-contiguous
mesh gives each process its rows), and the step averages the gradients
and stats once, through one flat buffer (`all_reduce_mean`).

Random draws follow JAX's partitionable threefry: a draw is made at the
global row count and each rank keeps its rows (`shard_generator`,
`draw`), so a rank's numbers do not depend on the world size.

Without a process group every function acts as world size 1: rank 0,
nothing reduced, gathered or waited for.
"""

import os
import time
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from nerfies_tpu_torch import resolve_device


def initialized() -> bool:
  return dist.is_available() and dist.is_initialized()


def rank() -> int:
  return dist.get_rank() if initialized() else 0


def world_size() -> int:
  return dist.get_world_size() if initialized() else 1


def local_rank() -> int:
  """This process's index among those of its machine (torchrun's
  LOCAL_RANK); the rank where torchrun did not start the process."""
  return int(os.environ.get('LOCAL_RANK', rank()))


def is_main() -> bool:
  """Whether this process writes: directories, logs, summaries, files."""
  return rank() == 0


def init(device='cuda', init_method: Optional[str] = None,
         rank: Optional[int] = None,
         world_size: Optional[int] = None) -> torch.device:
  """Joins the data-parallel run, if there is one; returns the device.

  Under `torchrun` (WORLD_SIZE, RANK and LOCAL_RANK in the environment)
  or with an explicit `rank` and `world_size` (and an `init_method`, e.g.
  'file:///tmp/store'), starts the process group once: NCCL for a CUDA
  device, gloo for the CPU. A CUDA device is this process's card,
  cuda:{LOCAL_RANK} (resolve_device), made current. Otherwise no group
  is started: world size 1.

  Raises:
    RuntimeError: for a CUDA device without a card (resolve_device), or
      when the group cannot start; there is no fallback.
  """
  device = resolve_device(device)
  if rank is None and 'WORLD_SIZE' not in os.environ:
    return device
  if device.type == 'cuda':
    torch.cuda.set_device(device)
  if initialized():
    return device
  if rank is None:
    rank = int(os.environ['RANK'])
  if world_size is None:
    world_size = int(os.environ['WORLD_SIZE'])
  backend = 'nccl' if device.type == 'cuda' else 'gloo'
  dist.init_process_group(
      backend, init_method=init_method or 'env://', rank=rank,
      world_size=world_size,
      **({'device_id': device} if device.type == 'cuda' else {}))
  return device


def shutdown() -> None:
  """Leaves the process group, if one was started."""
  if initialized():
    dist.destroy_process_group()


def barrier() -> None:
  if initialized():
    dist.barrier()


def pad_to_multiple(n: int, multiple: int) -> int:
  """Rows needed to pad `n` up to a multiple of `multiple`."""
  return (multiple - n % multiple) % multiple


def local_batch_slice(global_batch_size: int) -> slice:
  """This rank's contiguous slice of a globally indexed batch."""
  per_rank = global_batch_size // world_size()
  start = rank() * per_rank
  return slice(start, start + per_rank)


def rank_rows(tree):
  """This rank's contiguous rows (`local_batch_slice`) of each array of a
  globally indexed batch, a nested dict of arrays."""
  if isinstance(tree, dict):
    return {k: rank_rows(v) for k, v in tree.items()}
  return tree[local_batch_slice(len(tree))]


# Calls, bytes and milliseconds of `all_reduce_mean` since the last
# reset: host time on the CPU; on a card, CUDA event pairs, each folded
# into 'ms' once it has completed, so that only the pairs still in flight
# are kept however long the run.
_COLLECTIVES = {'calls': 0, 'bytes': 0, 'ms': 0.0, 'pending': []}


def _fold_events(wait: bool) -> None:
  """Adds the time of each completed event pair to 'ms' and drops it;
  with `wait`, waits for every pair first."""
  pending = []
  for start, end in _COLLECTIVES['pending']:
    if wait:
      end.synchronize()
    if wait or end.query():
      _COLLECTIVES['ms'] += start.elapsed_time(end)
    else:
      pending.append((start, end))
  _COLLECTIVES['pending'] = pending


def all_reduce_mean(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
  """The mean over ranks of each tensor, through one flat buffer and one
  collective. Returns the tensors themselves at world size 1.

  The tensors share one dtype and device; each result has its tensor's
  shape.
  """
  world = world_size()
  if world == 1:
    return list(tensors)
  flat = torch.cat([t.detach().reshape(-1) for t in tensors])
  _COLLECTIVES['calls'] += 1
  _COLLECTIVES['bytes'] += flat.numel() * flat.element_size()
  if flat.is_cuda:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    dist.all_reduce(flat)
    end.record()
    _fold_events(wait=False)
    _COLLECTIVES['pending'].append((start, end))
  else:
    began = time.perf_counter()
    dist.all_reduce(flat)
    _COLLECTIVES['ms'] += (time.perf_counter() - began) * 1e3
  flat = flat / world
  out, offset = [], 0
  for t in tensors:
    out.append(flat[offset:offset + t.numel()].view(t.shape))
    offset += t.numel()
  return out


def collective_stats(reset: bool = False) -> dict:
  """{'calls', 'bytes', 'ms'} of `all_reduce_mean` since the last reset;
  'ms' waits for the card's events to complete."""
  _fold_events(wait=True)
  out = {key: _COLLECTIVES[key] for key in ('calls', 'bytes', 'ms')}
  if reset:
    _COLLECTIVES.update(calls=0, bytes=0, ms=0.0, pending=[])
  return out


def all_gather_rows(t: torch.Tensor) -> torch.Tensor:
  """Every rank's `t` (equal shapes) stacked along rows in rank order."""
  world = world_size()
  if world == 1:
    return t
  t = t.contiguous()
  parts = [torch.empty_like(t) for _ in range(world)]
  dist.all_gather(parts, t)
  return torch.cat(parts)


def broadcast(t: torch.Tensor, src: int = 0) -> torch.Tensor:
  """Rank `src`'s `t` into every rank's `t` (equal shapes), in place."""
  if world_size() > 1:
    dist.broadcast(t, src=src)
  return t


def broadcast_object(obj, src: int = 0):
  """Rank `src`'s picklable `obj` on every rank."""
  if world_size() == 1:
    return obj
  box = [obj]
  dist.broadcast_object_list(box, src=src)
  return box[0]


class RankRows:
  """A random stream shared by every rank, of which this rank keeps its
  rows: each draw through `draw` is made at the global row count (this
  rank's rows times the world size) and cut to this rank's contiguous
  rows, so rank r of N draws what one process drawing the whole batch
  draws for those rows."""

  def __init__(self, generator: torch.Generator, rank: int, world: int):
    self.generator = generator
    self.rank = rank
    self.world = world


def shard_generator(generator: Optional[torch.Generator]):
  """`generator` as a RankRows stream under a group of more than one
  rank; itself (None too) otherwise."""
  world = world_size()
  if generator is None or world == 1 or isinstance(generator, RankRows):
    return generator
  return RankRows(generator, rank(), world)


def draw(fn, shape, generator, **kwargs) -> torch.Tensor:
  """fn(shape, generator=..., **kwargs) (torch.rand, torch.randn, a
  torch.randint with its bound bound), drawn at the global rows when the
  generator is a RankRows stream and cut to this rank's rows."""
  if not isinstance(generator, RankRows):
    return fn(shape, generator=generator, **kwargs)
  rows = shape[0]
  full = fn((rows * generator.world, *shape[1:]),
            generator=generator.generator, **kwargs)
  return full[generator.rank * rows:(generator.rank + 1) * rows]
