"""Builds the CUDA sources into one shared library at first use.

One `nvcc -c` per csrc/*.cu file, all started together, then one link into
a plain C shared library, which is loaded with ctypes: no PyTorch headers
and no torch.utils.cpp_extension, so a fresh build takes seconds, not
minutes. The library lands in _build/<hash>/, where <hash> covers the
sources (the .cuh headers too) and the flags, so an edit rebuilds and an
unchanged tree reuses the library. _build/ is listed in .gitignore.
Nothing here runs at import time.

Under a data-parallel run (parallel/mesh.py) the processes of a machine
load the library together: local rank 0 builds it while the others wait
at a barrier, then every rank loads it. Each launch names its card and
stream (`launch_target`).
"""

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import List, Optional, Tuple

import torch

from nerfies_tpu_torch.parallel import mesh

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE_DIR = os.path.join(_PKG_DIR, 'csrc')
BUILD_DIR = os.path.join(_PKG_DIR, '_build')
LIB_NAME = 'libnerfies_kernels.so'
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-Xcompiler', '-fPIC', '-Xptxas', '-v']

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# The cards that `launch_target` gave a launch since the last reset.
_launch_cards = set()


def sources() -> List[str]:
  return sorted(glob.glob(os.path.join(SOURCE_DIR, '*.cu'))
                + glob.glob(os.path.join(SOURCE_DIR, '*.cuh')))


def source_hash() -> str:
  digest = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
  for path in sources():
    digest.update(os.path.basename(path).encode())
    with open(path, 'rb') as f:
      digest.update(f.read())
  return digest.hexdigest()[:16]


def find_nvcc() -> str:
  candidates = [os.path.join(os.environ[var], 'bin', 'nvcc')
                for var in ('CUDA_HOME', 'CUDA_PATH') if os.environ.get(var)]
  candidates += [shutil.which('nvcc') or '', '/usr/local/cuda/bin/nvcc']
  for path in candidates:
    if path and os.access(path, os.X_OK):
      return path
  raise RuntimeError('nvcc not found: set CUDA_HOME or put nvcc on PATH')


def library_path() -> str:
  return os.path.join(BUILD_DIR, source_hash(), LIB_NAME)


def build() -> str:
  """Compiles the sources unless a library for their hash exists.

  Returns the library's path. The compiler's output, with ptxas's
  register and spill report, is kept beside it in build.log.

  Raises:
    RuntimeError: with nvcc's stderr when the compile fails.
  """
  path = library_path()
  if os.path.exists(path):
    return path
  out_dir = os.path.dirname(path)
  os.makedirs(out_dir, exist_ok=True)
  nvcc = find_nvcc()
  tag = f'{os.getpid()}.tmp'
  start = time.perf_counter()
  compiles = []
  for src in [s for s in sources() if s.endswith('.cu')]:
    obj = os.path.join(out_dir, f'{os.path.basename(src)}.{tag}.o')
    cmd = [nvcc, *NVCC_FLAGS, '-c', '-o', obj, src]
    compiles.append((cmd, obj, subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
  log, failed = [], []
  for cmd, _, proc in compiles:
    output, _ = proc.communicate()
    log.append(f'{" ".join(cmd)}\nexit {proc.returncode}\n{output}')
    if proc.returncode != 0:
      failed.append(output)
  tmp = f'{path}.{tag}'
  if not failed:
    cmd = [nvcc, '-shared', '-o', tmp] + [obj for _, obj, _ in compiles]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    log.append(f'{" ".join(cmd)}\nexit {proc.returncode}\n'
               f'{proc.stdout}{proc.stderr}')
    if proc.returncode != 0:
      failed.append(proc.stderr)
  seconds = time.perf_counter() - start
  for _, obj, _ in compiles:
    if os.path.exists(obj):
      os.remove(obj)
  with open(os.path.join(out_dir, 'build.log'), 'w') as f:
    f.write(f'{seconds:.2f} s, exit {1 if failed else 0}\n' + '\n'.join(log))
  if failed:
    if os.path.exists(tmp):
      os.remove(tmp)
    raise RuntimeError('nvcc failed:\n' + '\n'.join(failed))
  os.replace(tmp, path)
  return path


def build_log() -> str:
  path = os.path.join(os.path.dirname(library_path()), 'build.log')
  with open(path) as f:
    return f.read()


def _build_once_per_machine() -> str:
  """`build()`, run by local rank 0 alone while the other ranks of a
  process group wait, so that N ranks do not each run nvcc."""
  if mesh.world_size() > 1:
    error = None
    if mesh.local_rank() == 0:
      try:
        build()
      except RuntimeError as e:  # raised after the others pass the barrier
        error = e
    mesh.barrier()
    if error is not None:
      raise error
  return build()


def load() -> ctypes.CDLL:
  """The kernels' library, built if needed, with its argument types set.

  Collective at its first call under a process group (see the module
  docstring): every rank's first launch is at the same point of the step.
  """
  global _lib
  with _lock:
    if _lib is None:
      lib = ctypes.CDLL(_build_once_per_machine())
      ptr, i32 = ctypes.c_void_p, ctypes.c_int
      lib.nerf_mlp_forward.argtypes = [ptr] + [i32] * 8 + [ptr]
      lib.nerf_mlp_forward.restype = i32
      lib.warp_trunk_forward.argtypes = [ptr] + [i32] * 6 + [ptr]
      lib.warp_trunk_forward.restype = i32
      lib.nerf_mlp_backward_rows.argtypes = [ptr] + [i32] * 9 + [ptr]
      lib.nerf_mlp_backward_rows.restype = i32
      lib.warp_train_forward.argtypes = [ptr] + [i32] * 8 + [ptr]
      lib.warp_train_forward.restype = i32
      lib.warp_train_backward_rows.argtypes = [ptr] + [i32] * 12 + [ptr]
      lib.warp_train_backward_rows.restype = i32
      lib.weight_grad.argtypes = [ptr, ptr, i32, i32, i32, ptr,
                                  ctypes.c_longlong, ptr, i32, i32, ptr]
      lib.weight_grad.restype = i32
      lib.fused_mlp_error_string.argtypes = [i32]
      lib.fused_mlp_error_string.restype = ctypes.c_char_p
      _lib = lib
    return _lib


def launch_target(device: torch.device) -> Tuple[int, int]:
  """(card index, stream handle) of a launch on `device`: the tensor's own
  card, not card 0 by default, and that card's current stream. The
  library's entry points make the card current before they launch."""
  index = (device.index if device.index is not None
           else torch.cuda.current_device())
  _launch_cards.add(index)
  return index, torch.cuda.current_stream(index).cuda_stream


def launch_cards(reset: bool = False) -> List[int]:
  """The card indices that launches were given (`launch_target`) since
  the last reset, in order."""
  cards = sorted(_launch_cards)
  if reset:
    _launch_cards.clear()
  return cards
