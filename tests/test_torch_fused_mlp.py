"""The port's fused-MLP wrappers against the JAX Pallas kernels.

On the CPU the wrappers run their plain versions; the JAX kernels run in
the Pallas interpreter. tests/test_torch_kernels_cuda.py holds the CUDA
kernels against the plain versions on a card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfies_tpu.models import modules as jax_modules
from nerfies_tpu.ops import fused_mlp as jax_fused_mlp
from nerfies_tpu_torch import interop
from nerfies_tpu_torch.ops import fused_mlp
from tests.torch_parity import grad_check

# bf16 operands and storage between layers: the tolerance of
# tests/test_fused_mlp.py for the same outputs.
ATOL = RTOL = 0.05

# (alpha condition dims, rgb condition dims): both, neither, and the mixed
# cases where only one branch reads the bottleneck.
_COND_COMBOS = [(0, 0), (5, 7), (0, 7), (5, 0)]


def _jax_nerf_params(alpha_dims, rgb_dims, depth=4, width=64, rgb_width=32,
                     skips=(2,), c=27, b=5):
  mlp = jax_modules.NerfMLP(trunk_depth=depth, trunk_width=width,
                            rgb_branch_depth=1, rgb_branch_width=rgb_width,
                            skips=skips, dtype=jnp.bfloat16)
  key = jax.random.PRNGKey(0)
  x = jnp.zeros((b, 3, c), jnp.float32)
  alpha_cond = jnp.zeros((b, alpha_dims)) if alpha_dims else None
  rgb_cond = jnp.zeros((b, rgb_dims)) if rgb_dims else None
  params = mlp.init(key, x, None, alpha_cond, rgb_cond)['params']
  # Trained-scale weights, so that a routing error cannot hide.
  return jax.tree.map(lambda p: 3.0 * p + 0.1, params)


# (trunk width, rgb branch width) of the port's CUDA kernels other than
# the bench model's (256, 128): ops/fused_mlp.py _NERF_WIDTHS.
_KERNEL_WIDTHS = [(128, 128), (32, 128)]


@pytest.mark.parametrize('alpha_dims,rgb_dims', _COND_COMBOS)
def test_nerf_mlp_forward_matches_pallas(alpha_dims, rgb_dims):
  _check_forward(alpha_dims, rgb_dims, width=64, rgb_width=32)


@pytest.mark.parametrize('width,rgb_width', _KERNEL_WIDTHS)
def test_nerf_mlp_forward_matches_pallas_at_kernel_widths(width, rgb_width):
  _check_forward(5, 7, width=width, rgb_width=rgb_width)


def _check_forward(alpha_dims, rgb_dims, width, rgb_width):
  n, c, depth, skips = 67, 27, 4, (2,)  # ragged against any row tile
  params = _jax_nerf_params(alpha_dims, rgb_dims, depth=depth, width=width,
                            rgb_width=rgb_width, skips=skips, c=c)
  rng = np.random.RandomState(0)
  x = rng.normal(size=(n, c)).astype(np.float32)
  rgb_row_bias = None
  if rgb_dims:
    rgb_row_bias = np.array(jnp.asarray(
        rng.normal(size=(n, rgb_width)), jnp.bfloat16).astype(jnp.float32))
  want_alpha, want_rgb = jax_fused_mlp.nerf_mlp_forward(
      jnp.asarray(x), None if rgb_row_bias is None
      else jnp.asarray(rgb_row_bias), params, trunk_depth=depth,
      skips=skips, interpret=True)
  tparams = interop.params_from_jax(params, device='cpu')
  got_alpha, got_rgb = fused_mlp.nerf_mlp_forward(
      torch.from_numpy(x), None if rgb_row_bias is None
      else torch.from_numpy(rgb_row_bias), tparams, trunk_depth=depth,
      skips=skips)
  assert got_alpha.shape == (n, 8) and got_rgb.shape == (n, 8)
  assert got_alpha.dtype == torch.float32
  np.testing.assert_allclose(got_alpha.numpy(), np.asarray(want_alpha),
                             atol=ATOL, rtol=RTOL)
  np.testing.assert_allclose(got_rgb.numpy(), np.asarray(want_rgb),
                             atol=ATOL, rtol=RTOL)


def test_packing_keeps_the_branch_routing():
  for (alpha_dims, rgb_dims), want in zip(
      _COND_COMBOS, [(False, False), (True, True), (False, True),
                     (True, False)]):
    params = interop.params_from_jax(
        _jax_nerf_params(alpha_dims, rgb_dims), device='cpu')
    ops = fused_mlp.pack_nerf_mlp(params, 27, 4, (2,))
    assert (ops.alpha_from_bt, ops.rgb_from_bt) == want
    assert (ops.bottleneck is not None) == bool(alpha_dims or rgb_dims)
    assert tuple(ops.trunk_wx[2].shape) == (27, 64)
    assert tuple(ops.rgb_hidden[0].shape) == (64, 32)


def _jax_warp_params(depth=4, width=32, skips=(2,), c_pe=21, feats=8):
  trunk = jax_modules.MLP(depth=depth, width=width, skips=skips,
                          dtype=jnp.bfloat16)
  key = jax.random.PRNGKey(3)
  x = [jnp.zeros((4, 3, c_pe)), jnp.zeros((4, 1, feats))]
  trunk_params = trunk.init(key, x)['params']
  head = jax.random.normal(jax.random.fold_in(key, 1), (width, 6)) * 0.1
  return {'trunk': trunk_params,
          'branches_wv': {'logit': {'kernel': head,
                                    'bias': jnp.full((6,), 0.01)}}}


def test_warp_trunk_forward_matches_pallas():
  n, c_pe, feats, width, depth, skips = 61, 21, 8, 32, 4, (2,)
  params = _jax_warp_params(depth, width, skips, c_pe, feats)
  rng = np.random.RandomState(1)
  x = rng.normal(size=(n, c_pe)).astype(np.float32)
  biases = [(0, rng.normal(size=(n, width)).astype(np.float32)),
            (2, rng.normal(size=(n, width)).astype(np.float32))]
  want = jax_fused_mlp.warp_trunk_forward(
      jnp.asarray(x), [(i, jnp.asarray(b)) for i, b in biases], params,
      trunk_depth=depth, skips=skips, interpret=True)
  got = fused_mlp.warp_trunk_forward(
      torch.from_numpy(x), [(i, torch.from_numpy(b)) for i, b in biases],
      interop.params_from_jax(params, device='cpu'), trunk_depth=depth,
      skips=skips)
  assert got.shape == (n, 8)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                             rtol=RTOL)


def test_cpu_tensors_take_the_plain_version():
  fused_mlp.reset_launch_counts()
  params = interop.params_from_jax(_jax_nerf_params(0, 7), device='cpu')
  x = torch.randn(10, 27)
  rb = torch.randn(10, 32)
  got = fused_mlp.nerf_mlp_forward(x, rb, params, trunk_depth=4, skips=(2,))
  want = fused_mlp.nerf_mlp_reference(x, rb, params, trunk_depth=4,
                                      skips=(2,))
  for g, w in zip(got, want):
    assert torch.equal(g, w)
  wparams = interop.params_from_jax(_jax_warp_params(), device='cpu')
  fused_mlp.warp_trunk_forward(torch.randn(10, 21), [], wparams,
                               trunk_depth=4, skips=(2,))
  counts = fused_mlp.launch_counts()
  assert counts['nerf_mlp_forward'] == counts['warp_trunk_forward'] == 0
  assert not any(counts.values()), counts


def test_no_kernel_for_other_devices():
  params = interop.params_from_jax(_jax_nerf_params(0, 0), device='cpu')
  x = torch.empty(10, 27, device='meta')
  with pytest.raises(ValueError, match='no kernel'):
    fused_mlp.nerf_mlp_forward(x, None, params, trunk_depth=4, skips=(2,))


# ---------------------------------------------------- nerf_mlp_train's VJP

@pytest.mark.parametrize('alpha_dims,rgb_dims', _COND_COMBOS)
def test_nerf_mlp_train_matches_pallas_vjp(alpha_dims, rgb_dims):
  """Forward at 0.05; dx, drb and every dW leaf by cosine and norm ratio
  against the Pallas kernels' custom VJP (interpret mode)."""
  _check_vjp(alpha_dims, rgb_dims, width=64, rgb_width=32)


@pytest.mark.parametrize('width,rgb_width', _KERNEL_WIDTHS)
def test_nerf_mlp_train_matches_pallas_vjp_at_kernel_widths(width,
                                                            rgb_width):
  _check_vjp(5, 7, width=width, rgb_width=rgb_width)


def _check_vjp(alpha_dims, rgb_dims, width, rgb_width):
  n, c, depth, skips = 67, 27, 4, (2,)
  params = _jax_nerf_params(alpha_dims, rgb_dims, depth=depth, width=width,
                            rgb_width=rgb_width, skips=skips, c=c)
  rng = np.random.RandomState(1)
  x = np.array(jnp.asarray(rng.normal(size=(n, c)), jnp.bfloat16).astype(
      jnp.float32))
  rb = (np.array(jnp.asarray(rng.normal(size=(n, rgb_width)),
                             jnp.bfloat16).astype(jnp.float32))
        if rgb_dims else None)
  g_alpha = rng.normal(size=(n, 8)).astype(np.float32)
  g_rgb = rng.normal(size=(n, 8)).astype(np.float32)

  def jax_loss(x, rb, params):
    alpha, rgb = jax_fused_mlp.nerf_mlp_train(x, rb, params, depth, skips,
                                              True)
    return jnp.sum(alpha * g_alpha) + jnp.sum(rgb * g_rgb), (alpha, rgb)

  jrb = None if rb is None else jnp.asarray(rb)
  (_, (want_alpha, want_rgb)), want = jax.value_and_grad(
      jax_loss, argnums=(0, 1, 2), has_aux=True)(jnp.asarray(x), jrb, params)

  tparams = interop.params_from_jax(params, device='cpu')
  leaves = [t.requires_grad_(True) for _, t in fused_mlp.flatten_tree(tparams)]
  tx = torch.from_numpy(x).requires_grad_(True)
  trb = None if rb is None else torch.from_numpy(rb).requires_grad_(True)
  alpha, rgb = fused_mlp.nerf_mlp_train(tx, trb, tparams, depth, skips)
  np.testing.assert_allclose(alpha.detach().numpy(), np.asarray(want_alpha),
                             atol=ATOL, rtol=RTOL)
  np.testing.assert_allclose(rgb.detach().numpy(), np.asarray(want_rgb),
                             atol=ATOL, rtol=RTOL)
  loss = ((alpha * torch.from_numpy(g_alpha)).sum()
          + (rgb * torch.from_numpy(g_rgb)).sum())
  inputs = [tx] + ([trb] if trb is not None else []) + leaves
  grads = torch.autograd.grad(loss, inputs)
  grad_check({'x': grads[0]}, {'x': want[0]}, 'dx')
  if trb is not None:
    grad_check({'rb': grads[1]}, {'rb': want[1]}, 'drb')
  got = fused_mlp.unflatten_tree(
      [p for p, _ in fused_mlp.flatten_tree(tparams)], grads[-len(leaves):])
  grad_check(got, want[2], 'dW')


def test_backward_wrapper_equals_its_plain_version_on_cpu():
  params = interop.params_from_jax(_jax_nerf_params(5, 7), device='cpu')
  g = torch.Generator().manual_seed(3)
  x = torch.randn(10, 27, generator=g)
  rb = torch.randn(10, 32, generator=g)
  ga, gr = torch.randn(10, 8, generator=g), torch.randn(10, 8, generator=g)
  before = fused_mlp.nerf_mlp_backward.launches
  got = fused_mlp.nerf_mlp_backward(x, rb, params, ga, gr, trunk_depth=4,
                                    skips=(2,))
  want = fused_mlp.nerf_mlp_backward_reference(x, rb, params, ga, gr,
                                               trunk_depth=4, skips=(2,))
  assert fused_mlp.nerf_mlp_backward.launches == before
  assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
  for (pa, a), (pb, b) in zip(fused_mlp.flatten_tree(got[2]),
                              fused_mlp.flatten_tree(want[2])):
    assert pa == pb and torch.equal(a, b)
    assert a.shape == fused_mlp.tree_leaf(params, pa).shape


@pytest.mark.parametrize('width,rgb_width',
                         [(256, 128), (128, 128), (32, 128)])
def test_nerf_shape_check_accepts_the_kernel_widths(width, rgb_width):
  fused_mlp.check_nerf_shape('f', width, rgb_width, trunk_depth=8, c_in=63)


@pytest.mark.parametrize('width,rgb_width,depth,c_in', [
    (64, 32, 8, 63), (256, 256, 8, 63), (32, 64, 8, 63), (256, 128, 0, 63),
    (256, 128, 17, 63), (256, 128, 8, 65), (256, 128, 8, 0)])
def test_nerf_shape_check_raises_elsewhere(width, rgb_width, depth, c_in):
  with pytest.raises(ValueError, match='nerf_mlp_backward'):
    fused_mlp.check_nerf_shape('nerf_mlp_backward', width, rgb_width,
                               trunk_depth=depth, c_in=c_in)


def test_nerf_shape_check_names_the_supported_widths():
  with pytest.raises(ValueError, match=r'\(256, 128\), \(128, 128\), '
                                       r'\(32, 128\)'):
    fused_mlp.check_nerf_shape('f', 64, 32, trunk_depth=4, c_in=27)
