"""The port stands alone: no JAX, Flax or nerfies_tpu, and no silent CPU runs."""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from nerfies_tpu_torch import configs
from nerfies_tpu_torch import evaluation
from nerfies_tpu_torch import interop
from nerfies_tpu_torch.models import nerf

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / 'nerfies_tpu_torch').rglob('*.py')) + [
    REPO / 'chip_smoke.py', REPO / 'scripts' / 'time_warp_backward.py',
    REPO / 'scripts' / 'time_forwards.py']
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'nerfies_tpu')


def _imported_roots(path):
  tree = ast.parse(path.read_text(), filename=str(path))
  for node in ast.walk(tree):
    if isinstance(node, ast.Import):
      for alias in node.names:
        yield alias.name.split('.')[0]
    elif isinstance(node, ast.ImportFrom) and node.level == 0:
      yield node.module.split('.')[0]


@pytest.mark.parametrize('path', PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_imports(path):
  bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
  assert not bad, f'{path} imports {bad}'


def _python(code_or_args, cwd, extra_env=None):
  env = dict(os.environ, PYTHONPATH='', **(extra_env or {}))
  args = (['-c', code_or_args] if isinstance(code_or_args, str)
          else code_or_args)
  return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                        capture_output=True, text=True, timeout=300,
                        check=False)


def test_every_module_imports_without_jax():
  code = '\n'.join([
      'import sys',
      f'for name in {FORBIDDEN!r}:',
      '  sys.modules[name] = None',
      'import importlib, pkgutil',
      'import nerfies_tpu_torch',
      'names = [m.name for m in pkgutil.walk_packages(',
      '    nerfies_tpu_torch.__path__, "nerfies_tpu_torch.")]',
      'for name in names:',
      '  importlib.import_module(name)',
      'import chip_smoke',
      'print(len(names))',
  ])
  proc = _python(code, cwd=REPO)
  assert proc.returncode == 0, proc.stderr
  assert int(proc.stdout.split()[-1]) >= 14


def _small_config():
  return configs.ModelConfig(nerf_trunk_depth=2, nerf_trunk_width=16,
                             num_coarse_samples=4, num_fine_samples=0,
                             use_stratified_sampling=False)


def test_entry_points_need_a_card_unless_told_cpu():
  if torch.cuda.is_available():
    pytest.skip('a card is present: the default device is valid')
  ids = dict(appearance_ids=(0,), camera_ids=(0,), warp_ids=(0,), near=0.5,
             far=2.0)
  with pytest.raises(RuntimeError, match='device="cpu"'):
    nerf.construct_nerf(_small_config(), **ids)
  model, _ = nerf.construct_nerf(_small_config(), **ids, device='cpu')
  with pytest.raises(RuntimeError, match='device="cpu"'):
    evaluation.make_render_fn(model)
  with pytest.raises(RuntimeError, match='device="cpu"'):
    interop.params_from_jax({'w': np.zeros(2)})
  evaluation.make_render_fn(model, device='cpu')


def test_chip_smoke_fails_without_a_card():
  if torch.cuda.is_available():
    pytest.skip('a card is present')
  proc = _python(['chip_smoke.py'], cwd=REPO)
  assert proc.returncode != 0
  assert '"ok"' not in proc.stdout


def test_chip_smoke_fails_outside_the_repo(tmp_path):
  shutil.copy(REPO / 'chip_smoke.py', tmp_path / 'chip_smoke.py')
  proc = _python(['chip_smoke.py'], cwd=tmp_path)
  assert proc.returncode != 0
  assert '"ok"' not in proc.stdout
