"""The port's fused warp trunk against the JAX package's, on the CPU.

The JAX side runs its Pallas kernels in interpret mode, as its own tests
do; the port runs its plain versions (CPU tensors). Shapes are those of
tests/test_fused_train.py: warp trunk 3 x 128 with a skip at 2, two
warp frequencies, 8 embedding features. Tolerances are the JAX tests':
warped points atol 2e-3 / rtol 1e-2, Jacobians and jouts 5e-3 / 5e-2
(tests/test_fused_warp.py), gradients by cosine and norm ratio
(tests/test_fused_train.py:166-182).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfies_tpu import fused_train as jax_fused_train
from nerfies_tpu.ops import fused_warp as jax_fused_warp
from nerfies_tpu_torch import fused_train
from nerfies_tpu_torch import interop
from nerfies_tpu_torch.ops import fused_mlp
from nerfies_tpu_torch.ops import fused_warp
from tests.test_fused_train import _build
from tests.torch_parity import grad_check
from tests.torch_parity import port_model

_WARP_EXTRA = {'alpha': 1.5, 'time_alpha': 0.0}
_SKIPS = (2,)


def _points(b=4, s=6, seed=0):
  rng = np.random.RandomState(seed)
  points = rng.uniform(-1, 1, (b, s, 3)).astype(np.float32)
  meta = rng.randint(0, 2, (b, 1)).astype(np.uint32)
  return points, meta


def _torch_tree(tree):
  return interop.params_from_jax(tree, device='cpu')


def _kernel_inputs(n=50, c=15, f=8, nt=3, seed=0):
  rng = np.random.RandomState(seed)
  x = rng.normal(size=(n, c)).astype(np.float32)
  e = rng.uniform(0, 0.5, (n, f)).astype(np.float32)
  ts = tuple(rng.normal(size=(n, c)).astype(np.float32) for _ in range(nt))
  return x, e, ts


def _kernel_params(seed=0):
  """A warp trunk (3 x 128, skip 2) and a trained-scale 6-wide head."""
  model, params = _build()
  wf = params['warp_field']
  head = wf['branches_wv']['logit']
  rng = np.random.RandomState(seed)
  head = {'kernel': jnp.asarray(rng.normal(size=head['kernel'].shape) * 0.1,
                                jnp.float32),
          'bias': jnp.full(head['bias'].shape, 0.01, jnp.float32)}
  return {'trunk': wf['trunk'], 'head': {'logit': head}}


@pytest.mark.parametrize('nt', [0, 3])
def test_warp_forward_matches_pallas(nt):
  jparams = _kernel_params()
  x, e, ts = _kernel_inputs(nt=nt)
  want_out, want_jouts = jax_fused_warp.warp_mlp_train(
      jnp.asarray(x), jnp.asarray(e), tuple(jnp.asarray(t) for t in ts),
      jparams, 3, _SKIPS, True, True)
  got_out, got_jouts = fused_warp.warp_mlp_train(
      torch.from_numpy(x), torch.from_numpy(e),
      tuple(torch.from_numpy(t) for t in ts), _torch_tree(jparams), 3, _SKIPS)
  assert got_out.shape == (x.shape[0], 8) and len(got_jouts) == nt
  np.testing.assert_allclose(got_out.detach().numpy(), np.asarray(want_out),
                             atol=2e-3, rtol=1e-2)
  for g, w in zip(got_jouts, want_jouts):
    np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), atol=5e-3,
                               rtol=5e-2)


@pytest.mark.parametrize('need_dx', [False, True])
def test_warp_backward_matches_pallas(need_dx):
  """Input cotangents and every dW leaf against the Pallas VJP."""
  jparams = _kernel_params(1)
  x, e, ts = _kernel_inputs(seed=1)
  rng = np.random.RandomState(2)
  g_out = rng.normal(size=(x.shape[0], 8)).astype(np.float32)
  g_jouts = [rng.normal(size=(x.shape[0], 8)).astype(np.float32)
             for _ in ts]

  def jax_loss(x, e, ts, params):
    out, jouts = jax_fused_warp.warp_mlp_train(x, e, ts, params, 3, _SKIPS,
                                               need_dx, True)
    return jnp.sum(out * g_out) + sum(jnp.sum(j * g) for j, g in
                                      zip(jouts, g_jouts))

  jx, je, jts = jnp.asarray(x), jnp.asarray(e), tuple(map(jnp.asarray, ts))
  want = jax.grad(jax_loss, argnums=(0, 1, 2, 3))(jx, je, jts, jparams)

  tx = torch.from_numpy(x).requires_grad_(need_dx)
  te = torch.from_numpy(e).requires_grad_(True)
  tts = tuple(torch.from_numpy(t).requires_grad_(need_dx) for t in ts)
  tparams = _torch_tree(jparams)
  leaves = [t.requires_grad_(True) for _, t in fused_mlp.flatten_tree(tparams)]
  out, jouts = fused_warp.warp_mlp_train(tx, te, tts, tparams, 3, _SKIPS)
  loss = (out * torch.from_numpy(g_out)).sum() + sum(
      (j * torch.from_numpy(g)).sum() for j, g in zip(jouts, g_jouts))
  inputs = [te] + ([tx, *tts] if need_dx else []) + leaves
  grads = torch.autograd.grad(loss, inputs)
  got_params = fused_mlp.unflatten_tree(
      [p for p, _ in fused_mlp.flatten_tree(tparams)], grads[-len(leaves):])
  grad_check({'embed': grads[0]}, {'embed': want[1]}, 'd_embed')
  if need_dx:
    grad_check({'x': grads[1]}, {'x': want[0]}, 'dx')
    for j in range(len(ts)):
      grad_check({'t': grads[2 + j]}, {'t': want[2][j]}, f'd_tangent{j}')
  grad_check(got_params, want[3], 'dW')


def test_need_dx_modes_agree_on_param_grads():
  params = _torch_tree(_kernel_params(3))
  x, e, ts = _kernel_inputs(seed=3)
  outs = []
  for need_dx in (False, True):
    tparams = {k: v for k, v in params.items()}
    leaves = [t.detach().requires_grad_(True)
              for _, t in fused_mlp.flatten_tree(tparams)]
    tree = fused_mlp.unflatten_tree(
        [p for p, _ in fused_mlp.flatten_tree(tparams)], leaves)
    tx = torch.from_numpy(x).requires_grad_(need_dx)
    out, jouts = fused_warp.warp_mlp_train(
        tx, torch.from_numpy(e), tuple(map(torch.from_numpy, ts)), tree, 3,
        _SKIPS)
    loss = (out ** 2).sum() + sum((j ** 2).sum() for j in jouts)
    outs.append(torch.autograd.grad(loss, leaves))
  for a, b in zip(*outs):
    assert torch.equal(a, b)


@pytest.mark.parametrize('field', ['se3', 'translation'])
def test_apply_warp_and_jacobian_match_jax(field):
  warp_kwargs = ({'trunk_depth': 3, 'skips': (2,)} if field == 'se3'
                 else {'depth': 3, 'skips': (2,), 'hidden_channels': 32})
  jmodel, jparams = _build(warp_field_type=field, warp_kwargs=warp_kwargs)
  model = port_model(field, warp_kwargs)
  points, meta = _points()
  want = jax_fused_train._apply_warp_kernel(
      jmodel, jparams, jnp.asarray(points), jnp.asarray(meta), _WARP_EXTRA,
      return_jacobian=True, points_depend_on_params=True, interpret=True)
  got = fused_train.apply_warp(model, _torch_tree(jparams),
                               torch.from_numpy(points),
                               torch.from_numpy(meta.astype(np.int64)),
                               _WARP_EXTRA, return_jacobian=True)
  np.testing.assert_allclose(got['warped_points'].detach().numpy(),
                             np.asarray(want['warped_points']), atol=2e-3,
                             rtol=1e-2)
  assert got['jacobian'].shape == (3, 3) + points.shape[:2]
  np.testing.assert_allclose(got['jacobian'].detach().numpy(),
                             np.asarray(want['jacobian']), atol=5e-3,
                             rtol=5e-2)


def test_second_order_grads_match_jax():
  """A loss on the Jacobian (the tangent chains' jouts through the SE(3)
  linearization) and the warped points, differentiated to the params."""
  jmodel, jparams = _build()
  model = port_model()
  points, meta = _points(seed=5)
  eye = np.eye(3, dtype=np.float32)[..., None, None]

  def jax_loss(params):
    out = jax_fused_train._apply_warp_kernel(
        jmodel, params, jnp.asarray(points), jnp.asarray(meta), _WARP_EXTRA,
        return_jacobian=True, points_depend_on_params=False, interpret=True)
    return (((out['jacobian'] - eye) ** 2).mean()
            + (out['warped_points'] ** 2).mean())

  want_value, want_grads = jax.value_and_grad(jax_loss)(jparams)
  tparams = _torch_tree(jparams)
  leaves = [t.requires_grad_(True) for _, t in fused_mlp.flatten_tree(tparams)]
  out = fused_train.apply_warp(model, tparams, torch.from_numpy(points),
                               torch.from_numpy(meta.astype(np.int64)),
                               _WARP_EXTRA, return_jacobian=True)
  loss = (((out['jacobian'] - torch.from_numpy(eye)) ** 2).mean()
          + (out['warped_points'] ** 2).mean())
  grads = torch.autograd.grad(loss, leaves, allow_unused=True)
  np.testing.assert_allclose(float(loss), float(want_value), rtol=0.03)
  got = fused_mlp.unflatten_tree(
      [p for p, _ in fused_mlp.flatten_tree(tparams)],
      [torch.zeros_like(t) if g is None else g
       for t, g in zip(leaves, grads)])
  grad_check(got['warp_field'], want_grads['warp_field'], 'warp-2nd-order',
              cos_floor=0.97)


def test_dx_matches_jax_through_points():
  """d(loss)/d(points) through the warp (the kernel's dx path)."""
  jmodel, jparams = _build()
  model = port_model()
  points, meta = _points(seed=7)

  def jax_loss(p):
    out = jax_fused_train._apply_warp_kernel(
        jmodel, jparams, p, jnp.asarray(meta), _WARP_EXTRA,
        return_jacobian=False, points_depend_on_params=True, interpret=True)
    return (out['warped_points'] ** 2).mean()

  want = jax.grad(jax_loss)(jnp.asarray(points))
  tp = torch.from_numpy(points).requires_grad_(True)
  out = fused_train.apply_warp(model, _torch_tree(jparams), tp,
                               torch.from_numpy(meta.astype(np.int64)),
                               _WARP_EXTRA)
  got, = torch.autograd.grad((out['warped_points'] ** 2).mean(), tp)
  grad_check({'p': got}, {'p': want}, 'd_points', cos_floor=0.99)


# The backward's chunks (ops/fused_warp.py bwd_chunk_rows, bwd_chunks): the
# kernel's workspace is sized by bytes, so a chunk holds ~4x the rows
# without tangents that it holds with 3; the row splits must not change
# the result.
@pytest.mark.parametrize('nt', [0, 3])
@pytest.mark.parametrize('depth', [6, 3])  # the bench trunk, this file's
def test_bwd_chunk_rows_fill_the_byte_budget(nt, depth):
  budget = fused_warp._WARP_BWD_BUDGET
  tile = fused_warp.bwd_tile_rows(nt)
  rows = fused_warp.bwd_chunk_rows(nt, 128, depth)
  row_bytes = fused_warp.bwd_workspace_row_bytes(nt, 128, depth)
  assert rows % tile == 0
  assert rows * row_bytes <= budget < (rows + tile) * row_bytes
  with_3 = fused_warp.bwd_chunk_rows(3, 128, depth)
  if depth == 6:
    assert (fused_warp.bwd_workspace_row_bytes(3, 128, 6), with_3) == (
        12960, 131072)
  if nt == 0:
    assert rows > 3.5 * with_3


@pytest.mark.parametrize('n, nt, chunks', [
    (786432, 3, 6),     # the bench step's coarse level: 131,072 rows each
    (1572864, 0, 4),    # its fine level: 12 chunks by rows, 4 by bytes
    (16384, 0, 1),      # its background points
    (1, 3, 1)])
def test_bwd_chunks_cover_the_rows_once(n, nt, chunks):
  most = fused_warp.bwd_chunk_rows(nt, 128, 6)
  plan = fused_warp.bwd_chunks(n, most)
  assert len(plan) == chunks
  assert [r0 for r0, _ in plan] == list(
      np.cumsum([0] + [r for _, r in plan[:-1]]))
  assert sum(r for _, r in plan) == n
  assert all(0 < r <= most for _, r in plan)
  assert max(r for _, r in plan) - min(r for _, r in plan) <= 1 or chunks == 1


@pytest.mark.parametrize('nt', [0, 3])
@pytest.mark.parametrize('need_dx', [False, True])
def test_plain_backward_over_chunks_equals_whole(nt, need_dx):
  """The plain backward over a chunk plan of the kernel's (chunks of 100
  rows, so that seams fall inside the row pass's blocks) equals it
  unchunked: per-row outputs row for row, dW as the sum of the chunks'."""
  params = _torch_tree(_kernel_params(4))
  x, e, ts = _kernel_inputs(n=300, nt=nt, seed=4)
  rng = np.random.RandomState(5)
  g_out = rng.normal(size=(300, 8)).astype(np.float32)
  g_jouts = [rng.normal(size=(300, 8)).astype(np.float32) for _ in ts]
  ops = fused_warp.pack(params, x.shape[1], e.shape[1], 3, _SKIPS)
  plan = fused_warp.bwd_chunks(300, 100)
  assert len(plan) == 3

  def run(rows):
    part = lambda a: torch.from_numpy(a[rows])
    return fused_warp._plain_bwd(
        part(x), part(e), [part(t) for t in ts], part(g_out),
        [part(g) for g in g_jouts], ops, 3, _SKIPS, need_dx)

  whole = run(slice(None))
  parts = [run(slice(r0, r0 + r)) for r0, r in plan]
  torch.testing.assert_close(torch.cat([p[0] for p in parts]), whole[0],
                             atol=1e-6, rtol=1e-5)
  if need_dx:
    torch.testing.assert_close(torch.cat([p[1] for p in parts]), whole[1],
                               atol=1e-6, rtol=1e-5)
    for j in range(nt):
      torch.testing.assert_close(torch.cat([p[2][j] for p in parts]),
                                 whole[2][j], atol=1e-6, rtol=1e-5)
  else:
    assert all(p[1] is None and p[2] is None for p in parts)
  for name, want in whole[3].items():
    got = sum(p[3][name] for p in parts)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
