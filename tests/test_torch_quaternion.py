"""ops/quaternion.py of the port against nerfies_tpu.ops.quaternion.

Every function on the same float32 inputs, drawn with numpy from a seed:
random quaternions, near-identity ones (the eps paths of log and exp) and
matrices that take each branch of from_rotation_matrix; atol 1e-6, rtol
1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
from scipy.spatial.transform import Rotation
import torch

from nerfies_tpu.ops import quaternion as jax_quaternion
from nerfies_tpu_torch.ops import quaternion
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

ATOL, RTOL = 1e-6, 1e-5


def _unit(n, seed):
  q = np.random.RandomState(seed).randn(n, 4)
  return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)


def _near_identity(n, seed):
  rng = np.random.RandomState(seed)
  q = np.concatenate([rng.uniform(-1e-9, 1e-9, (n, 3)), np.ones((n, 1))],
                     axis=-1)
  q[0, :3] = 0.0  # exactly the identity
  return q.astype(np.float32)


def _inputs(kind, seed):
  if kind == 'random':
    return _unit(32, seed)
  if kind == 'near_identity':
    return _near_identity(8, seed)
  # Unnormalised quaternions: log's magnitude and inverse's norm.
  return (2.5 * np.random.RandomState(seed).randn(16, 4)).astype(np.float32)


def _check(got, want):
  np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                             rtol=RTOL)


KINDS = ('random', 'near_identity', 'unnormalised')


@pytest.mark.parametrize('kind', KINDS)
@pytest.mark.parametrize('name', ['im', 're', 'conjugate', 'norm',
                                  'normalize', 'inverse', 'log', 'exp',
                                  'to_rotation_matrix'])
def test_unary_matches_jax(name, kind):
  q = _inputs(kind, seed=1)
  if name == 'exp':  # exp takes pure (and near-zero) quaternions too
    q = q.copy()
    q[..., 3] *= 0.1
  _check(getattr(quaternion, name)(torch.from_numpy(q)),
         getattr(jax_quaternion, name)(jnp.asarray(q)))


@pytest.mark.parametrize('kind', KINDS)
def test_multiply_and_rotate_match_jax(kind):
  q1, q2 = _inputs(kind, seed=2), _inputs(kind, seed=3)
  _check(quaternion.multiply(torch.from_numpy(q1), torch.from_numpy(q2)),
         jax_quaternion.multiply(jnp.asarray(q1), jnp.asarray(q2)))
  v = np.random.RandomState(4).randn(len(q1), 3).astype(np.float32)
  _check(quaternion.rotate(torch.from_numpy(q1), torch.from_numpy(v)),
         jax_quaternion.rotate(jnp.asarray(q1), jnp.asarray(v)))
  # Broadcast: one quaternion against a batch of vectors.
  _check(quaternion.rotate(torch.from_numpy(q1[:1]), torch.from_numpy(v)),
         jax_quaternion.rotate(jnp.asarray(q1[:1]), jnp.asarray(v)))


def test_safe_acos_and_identity_match_jax():
  t = np.linspace(-1.2, 1.2, 41).astype(np.float32)
  _check(quaternion.safe_acos(torch.from_numpy(t)),
         jax_quaternion.safe_acos(jnp.asarray(t)))
  _check(quaternion.identity(), jax_quaternion.identity())


def _branch_matrices():
  """Rotations that take each of from_rotation_matrix's four branches:
  a positive trace, and near-pi turns about x, y and z."""
  small = Rotation.from_rotvec([[0.1, -0.2, 0.3], [0.0, 0.0, 0.0]])
  turns = Rotation.from_rotvec(np.pi * 0.97 * np.eye(3)
                               + 0.01 * np.random.RandomState(5).randn(3, 3))
  random = Rotation.from_quat(_unit(16, 6).astype(np.float64))
  return np.concatenate([small.as_matrix(), turns.as_matrix(),
                         random.as_matrix()]).astype(np.float32)


def test_from_rotation_matrix_matches_jax_on_every_branch():
  m = _branch_matrices()
  tr = np.trace(m, axis1=-2, axis2=-1)
  diag = np.diagonal(m, axis1=-2, axis2=-1)
  assert (tr > 0).any()
  assert set(np.argmax(diag[tr <= 0], axis=-1)) == {0, 1, 2}
  _check(quaternion.from_rotation_matrix(torch.from_numpy(m)),
         jax_quaternion.from_rotation_matrix(jnp.asarray(m)))


def test_log_exp_roundtrip():
  q = _unit(16, 7)
  q = np.where(q[:, 3:4] < 0, -q, q)
  back = quaternion.exp(quaternion.log(torch.from_numpy(q)))
  np.testing.assert_allclose(back.numpy(), q, atol=1e-5)
