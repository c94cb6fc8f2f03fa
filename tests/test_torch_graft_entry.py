"""graft_entry of the port against __graft_entry__.py.

`entry()` on the CPU, run on the JAX entry's own params (carried across
by name) and rays, against the JAX entry's forward: rgb at atol 1e-4,
rtol 1e-3. `dryrun_multichip(2)` on two gloo ranks.
"""

import jax
import numpy as np
import pytest

import __graft_entry__ as jax_graft
from nerfies_tpu_torch import graft_entry
from nerfies_tpu_torch import interop
from nerfies_tpu_torch.ops import fused_mlp
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)


def test_entry_matches_jax_entry():
  jax_fn, (jax_params, jax_rays) = jax_graft.entry()
  want = jax.jit(jax_fn)(jax_params, jax_rays)
  fn, (params, rays) = graft_entry.entry(device='cpu')
  for key, value in graft_entry._fake_rays(512).items():
    if key != 'metadata':
      np.testing.assert_array_equal(rays[key].numpy(), np.asarray(
          jax_rays[key]))
  # The port's own params are a tree of JAX's names and shapes.
  own = {'/'.join(str(k.key) for k in p): v.shape for p, v in
         jax.tree_util.tree_flatten_with_path(jax.device_get(jax_params))[0]}
  assert {'/'.join(p): tuple(t.shape) for p, t in
          fused_mlp.flatten_tree(params)} == own
  got = fn(interop.params_from_jax(jax.device_get(jax_params), 'cpu'), rays)
  for level in ('coarse', 'fine'):
    assert got[level]['rgb'].shape == (512, 3)
    np.testing.assert_allclose(got[level]['rgb'].numpy(),
                               np.asarray(want[level]['rgb']),
                               atol=1e-4, rtol=1e-3, err_msg=level)
  assert np.isfinite(fn(params, rays)['fine']['rgb'].numpy()).all()


def test_dryrun_multichip_2_gloo():
  graft_entry.dryrun_multichip(2, device='cpu')


def test_entry_refuses_a_missing_card(monkeypatch):
  monkeypatch.setattr('torch.cuda.is_available', lambda: False)
  with pytest.raises(RuntimeError, match='CUDA'):
    graft_entry.entry()
  with pytest.raises(RuntimeError, match='CUDA'):
    graft_entry.dryrun_multichip(2)
