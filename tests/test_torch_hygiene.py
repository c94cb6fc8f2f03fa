"""The port stands alone: no JAX, Flax, nerfies_tpu, absl, TensorFlow, cv2,
PIL or matplotlib, and no silent CPU runs."""

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
    REPO / 'scripts' / 'time_forwards.py',
    # The module the spawned ranks of tests/test_torch_parallel.py import.
    REPO / 'tests' / 'torch_parallel_workers.py']
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'nerfies_tpu', 'absl',
             'tensorflow', 'cv2', 'PIL', 'matplotlib')
# Absent at import time too: fsspec is imported only for a cloud path.
BLOCKED_AT_IMPORT = FORBIDDEN + ('fsspec',)


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
      f'for name in {BLOCKED_AT_IMPORT!r}:',
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
  assert int(proc.stdout.split()[-1]) >= 26


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


def test_data_parallel_modules_are_port_files():
  for path in ('parallel/__init__.py', 'parallel/mesh.py', 'profiling.py'):
    assert REPO / 'nerfies_tpu_torch' / path in PORT_FILES, path


def test_chip_smoke_ddp_children_import_no_jax(tmp_path):
  """The ddp phase's children (chip_smoke.py --ddp_child under
  torch.distributed.run), run here as 2 gloo ranks on a tiny scene: each
  reports the JAX modules that chip_smoke.py and the port loaded (none),
  its device and its rank."""
  import chip_smoke
  from nerfies_tpu_torch.datasets import synthetic
  scene = tmp_path / 'scene'
  synthetic.write_synthetic_dataset(scene, num_train=2, num_val=1,
                                    image_size=(12, 8), num_points=16,
                                    motion_amplitude=0.05)
  argv = ['--base_folder', str(tmp_path / 'exp'), '--data_dir', str(scene),
          '--device', 'cpu', '--gin_configs',
          str(REPO / 'configs' / 'test_local.gin')]
  for binding in ('ExperimentConfig.image_scale = 1',
                  'TrainConfig.batch_size = 8', 'TrainConfig.max_steps = 1',
                  'ModelConfig.num_coarse_samples = 4',
                  'ModelConfig.num_fine_samples = 4',
                  'ModelConfig.nerf_trunk_depth = 1',
                  'ModelConfig.nerf_trunk_width = 8',
                  'ModelConfig.nerf_skips = ()',
                  "ModelConfig.warp_kwargs = {'trunk_depth': 1, "
                  "'skips': ()}"):
    argv += ['--gin_bindings', binding]
  reports, _ = chip_smoke.torchrun(tmp_path, 'hygiene', 'train', argv, 2,
                                   device_type='cpu')
  assert [r['rank'] for r in reports] == [0, 1]
  for report in reports:
    assert report['forbidden_modules'] == []
    assert report['device'] == 'cpu' and report['world_size'] == 2
