"""The committed JAX init of the quality bench's model, on the CPU.

nerfies_tpu_torch/curves/init/quality_init_jax_key0.npz is JAX's
PRNGKey(0) param tree of scripts/quality_bench.py, written by
scripts/quality_init_jax.py; `quality_bench --init_npz` trains the port
from it on the card, where there is no JAX. These tests rebuild that tree
with JAX and hold the file to it bit for bit, and check that
`interop.params_from_jax` of the file is a param tree of the port: the
names, shapes and float32 values of the port's own `construct_nerf` tree
for the bench model and the quality scene's ids.
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from nerfies_tpu_torch import interop
from nerfies_tpu_torch import quality_bench
from nerfies_tpu_torch.models import nerf
from nerfies_tpu_torch.ops import fused_mlp
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = pathlib.Path(__file__).resolve().parent.parent
INIT = REPO / 'nerfies_tpu_torch' / 'curves' / 'init' / \
    'quality_init_jax_key0.npz'


def _writer():
  """scripts/quality_init_jax.py as a module."""
  path = REPO / 'scripts' / 'quality_init_jax.py'
  spec = importlib.util.spec_from_file_location('quality_init_jax', path)
  module = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(module)
  return module


@pytest.fixture(scope='module')
def ids(tmp_path_factory):
  """The quality scene's ids and bounds, from JAX's writer and reader."""
  return _writer().scene_ids(tmp_path_factory.mktemp('quality') / 'scene')


def test_committed_init_is_jax_key0_tree_bit_for_bit(ids):
  writer = _writer()
  want = writer.init_params(ids)
  with np.load(INIT) as data:
    got = {name: data[name] for name in data.files}
  assert writer.trees_equal(got, want)
  assert writer.DEFAULT_OUT == str(INIT.relative_to(REPO))
  assert len(got) == 65
  assert sum(v.size for v in got.values()) == 1275600


def test_init_is_a_param_tree_of_the_port(ids):
  _, own = nerf.construct_nerf(
      quality_bench.model_config(), device='cpu', use_warp_jacobian=True,
      use_weights=True, **ids)
  params = interop.params_from_jax(interop.load_npz_tree(INIT), 'cpu')
  want = dict(fused_mlp.flatten_tree(own))
  got = dict(fused_mlp.flatten_tree(params))
  assert got.keys() == want.keys()
  with np.load(INIT) as data:
    for path, t in got.items():
      assert t.shape == want[path].shape and t.dtype == torch.float32, path
      assert torch.equal(t, torch.from_numpy(data['/'.join(path)])), path
  # The bench loads it into the same tree.
  loaded = quality_bench.load_init(INIT, own, 'cpu')
  for path, t in fused_mlp.flatten_tree(loaded):
    assert torch.equal(t, got[path]), path
