"""The CUDA kernels against their plain versions, on a card.

The NeRF MLP 8 deep (skip 4) at each (trunk, rgb branch) width the
kernels are built for: the bench model's (256, 128), configs/
test_vrig.gin's (128, 128) and the verification model's (32, 128). The
warp trunk 6 x 128 (skip 4) with 8 embedding features, the only warp
width of the configs.

Marked `cuda`: they skip without a card, since a CUDA kernel has no CPU
mode. This file imports no JAX, so it also runs on a machine without it:

  python3 -m pytest --noconftest -p no:cacheprovider -m cuda \
      tests/test_torch_kernels_cuda.py
"""

import pytest
import torch

from nerfies_tpu_torch.models import modules
from nerfies_tpu_torch.ops import fused_mlp
from nerfies_tpu_torch.ops import fused_warp

# bf16 operands and storage between layers: the tolerance of
# tests/test_fused_mlp.py for the same outputs.
ATOL = RTOL = 0.05


@pytest.fixture
def cuda_device():
  if not torch.cuda.is_available():
    pytest.skip('needs a CUDA card: the kernels have no CPU mode')
  return torch.device('cuda')


# (trunk width, rgb branch width): ops/fused_mlp.py _NERF_WIDTHS.
NERF_WIDTHS = [(256, 128), (128, 128), (32, 128)]


def _nerf(generator, widths=(256, 128), alpha_dims=0, rgb_dims=29):
  """A NerfMLP with an rgb condition (and an alpha one if alpha_dims)."""
  width, rgb_width = widths
  return modules.nerf_mlp(point_dims=51, alpha_condition_dims=alpha_dims,
                          rgb_condition_dims=rgb_dims, trunk_width=width,
                          rgb_branch_width=rgb_width, generator=generator)


# A block owns 128 rows: 127, 128, 129 and 257 sit at its edges.
FORWARD_ROWS = [1, 64, 127, 128, 129, 257, 1000, 4099]


@pytest.mark.cuda
@pytest.mark.parametrize('widths', NERF_WIDTHS)
@pytest.mark.parametrize('n', FORWARD_ROWS)
@pytest.mark.parametrize('with_bias', [False, True])
def test_nerf_kernel_matches_plain_on_card(cuda_device, n, with_bias,
                                           widths):
  g = torch.Generator().manual_seed(n)
  params = _tree_to(_nerf(g, widths), cuda_device)
  x = torch.randn(n, 51, generator=g).to(cuda_device)
  rb = (torch.randn(n, widths[1], generator=g).to(cuda_device)
        if with_bias else None)
  before = fused_mlp.nerf_mlp_forward.launches
  got = fused_mlp.nerf_mlp_forward(x, rb, params, trunk_depth=8, skips=(4,))
  torch.cuda.synchronize()
  assert fused_mlp.nerf_mlp_forward.launches == before + 1
  want = fused_mlp.nerf_mlp_reference(x, rb, params, trunk_depth=8,
                                      skips=(4,))
  for g_, w_ in zip(got, want):
    torch.testing.assert_close(g_, w_, atol=ATOL, rtol=RTOL)


# The kernel's flags: a condition on a head gives the MLP a bottleneck and
# makes that head read it; with none, both heads read the trunk.
@pytest.mark.cuda
@pytest.mark.parametrize('widths', NERF_WIDTHS)
@pytest.mark.parametrize('alpha_dims', [0, 8])
@pytest.mark.parametrize('rgb_dims', [0, 29])
@pytest.mark.parametrize('with_bias', [False, True])
def test_nerf_kernel_flags_match_plain_on_card(cuda_device, alpha_dims,
                                               rgb_dims, with_bias, widths):
  """Each head read from the trunk or the bottleneck, with or without rb."""
  g = torch.Generator().manual_seed(17 + alpha_dims + rgb_dims)
  params = _tree_to(_nerf(g, widths, alpha_dims, rgb_dims), cuda_device)
  ops = fused_mlp.pack_nerf_mlp(params, 51, 8, (4,))
  assert (ops.bottleneck is not None) == (alpha_dims + rgb_dims > 0)
  assert ops.alpha_from_bt == (alpha_dims > 0)
  assert ops.rgb_from_bt == (rgb_dims > 0)
  n = 1000
  x = torch.randn(n, 51, generator=g).to(cuda_device)
  rb = (torch.randn(n, widths[1], generator=g).to(cuda_device)
        if with_bias else None)
  got = fused_mlp.nerf_mlp_forward(x, rb, params, trunk_depth=8, skips=(4,))
  torch.cuda.synchronize()
  want = fused_mlp.nerf_mlp_reference(x, rb, params, trunk_depth=8,
                                      skips=(4,))
  for g_, w_ in zip(got, want):
    torch.testing.assert_close(g_, w_, atol=ATOL, rtol=RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize('widths', NERF_WIDTHS)
def test_nerf_kernel_is_deterministic_on_card(cuda_device, widths):
  g = torch.Generator().manual_seed(5)
  params = _tree_to(_nerf(g, widths), cuda_device)
  x = torch.randn(4099, 51, generator=g).to(cuda_device)
  rb = torch.randn(4099, widths[1], generator=g).to(cuda_device)
  runs = [fused_mlp.nerf_mlp_forward(x, rb, params, trunk_depth=8,
                                     skips=(4,)) for _ in range(2)]
  torch.cuda.synchronize()
  for first, second in zip(*runs):
    assert torch.equal(first, second)


def _warp_trunk(generator, device):
  trunk = modules.mlp([39, 8], 6, 128, (4,), generator=generator)
  head = modules.mlp([128], 0, 128, output_channels=6, generator=generator)
  return _tree_to({'trunk': trunk, 'branches_wv': head}, device)


@pytest.mark.cuda
@pytest.mark.parametrize('n', FORWARD_ROWS)
def test_warp_kernel_matches_plain_on_card(cuda_device, n):
  g = torch.Generator().manual_seed(n)
  params = _warp_trunk(g, cuda_device)
  x = torch.randn(n, 39, generator=g).to(cuda_device)
  biases = [(i, torch.randn(n, 128, generator=g).to(cuda_device))
            for i in (0, 4)]
  before = fused_mlp.warp_trunk_forward.launches
  got = fused_mlp.warp_trunk_forward(x, biases, params, trunk_depth=6,
                                     skips=(4,))
  torch.cuda.synchronize()
  assert fused_mlp.warp_trunk_forward.launches == before + 1
  want = fused_mlp.warp_trunk_reference(x, biases, params, trunk_depth=6,
                                        skips=(4,))
  torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.cuda
def test_warp_kernel_is_deterministic_on_card(cuda_device):
  g = torch.Generator().manual_seed(6)
  params = _warp_trunk(g, cuda_device)
  x = torch.randn(4099, 39, generator=g).to(cuda_device)
  biases = [(i, torch.randn(4099, 128, generator=g).to(cuda_device))
            for i in (0, 4)]
  runs = [fused_mlp.warp_trunk_forward(x, biases, params, trunk_depth=6,
                                       skips=(4,)) for _ in range(2)]
  torch.cuda.synchronize()
  assert torch.equal(runs[0], runs[1])


def _tree_to(tree, device):
  return {k: (_tree_to(v, device) if isinstance(v, dict)
              else v.to(device)) for k, v in tree.items()}


# ------------------------------------------------------ training kernels
#
# Backward outputs. A pre-activation within rounding of zero can fall on
# either side of the ReLU in the kernel and in the plain version (their
# f32 sums run in different orders); the cotangent element then passes
# in one and stops in the other. Such mask flips touch few, isolated rows,
# while a wrong kernel disagrees on most of them. So per-row cotangents
# must agree at atol = rtol = 0.05 on all rows but at most
# MAX_FLIPPED_ROWS_FRAC of them (at least one row), and each dW leaf, a
# sum over rows that one flip shifts by one row's product, must keep
# cosine > DW_COSINE and a norm ratio within 1 +- DW_NORM with the plain
# one.
MAX_FLIPPED_ROWS_FRAC = 0.01
DW_COSINE = 0.99
DW_NORM = 0.05


def _assert_rows_close(got, want):
  assert got.shape == want.shape
  bad = (~torch.isclose(got, want, atol=ATOL, rtol=RTOL)).any(dim=1)
  allowed = max(1, int(MAX_FLIPPED_ROWS_FRAC * got.shape[0]))
  assert int(bad.sum()) <= allowed, f'{int(bad.sum())} of {got.shape[0]} rows'


def _bench_warp(generator, device):
  trunk = modules.mlp([39, 8], 6, 128, (4,), generator=generator)
  # A Glorot head: at its 1e-4 init scale the head would hide trunk errors.
  head = modules.mlp([128], 0, 128, output_channels=6, generator=generator)
  return _tree_to({'trunk': trunk, 'head': {'logit': head['logit']}},
                  device)


def _assert_dw_close(got, want):
  got = dict(fused_mlp.flatten_tree(got))
  want = dict(fused_mlp.flatten_tree(want))
  assert got.keys() == want.keys()
  for name in want:
    assert got[name].shape == want[name].shape, name
    a, b = got[name].double().ravel(), want[name].double().ravel()
    na, nb = float(a.norm()), float(b.norm())
    if nb == 0.0:
      assert na == 0.0, name
      continue
    cos = float(a @ b) / (na * nb)
    assert cos > DW_COSINE, f'{name}: cosine {cos}'
    assert abs(na / nb - 1.0) < DW_NORM, f'{name}: norms {na} / {nb}'


@pytest.mark.cuda
@pytest.mark.parametrize('widths', NERF_WIDTHS)
@pytest.mark.parametrize('alpha_dims', [0, 8])
@pytest.mark.parametrize('n', [1, 64, 1000, 4099])
@pytest.mark.parametrize('with_bias', [False, True])
def test_nerf_backward_kernel_matches_plain_on_card(cuda_device, n,
                                                    with_bias, alpha_dims,
                                                    widths):
  g = torch.Generator().manual_seed(n)
  params = _tree_to(_nerf(g, widths, alpha_dims), cuda_device)
  x = torch.randn(n, 51, generator=g).to(cuda_device)
  rb = (torch.randn(n, widths[1], generator=g).to(cuda_device)
        if with_bias else None)
  ga = torch.randn(n, 8, generator=g).to(cuda_device)
  gr = torch.randn(n, 8, generator=g).to(cuda_device)
  before = fused_mlp.nerf_mlp_backward.launches
  got = fused_mlp.nerf_mlp_backward(x, rb, params, ga, gr, trunk_depth=8,
                                    skips=(4,))
  torch.cuda.synchronize()
  assert fused_mlp.nerf_mlp_backward.launches == before + 1
  want = fused_mlp.nerf_mlp_backward_reference(x, rb, params, ga, gr,
                                               trunk_depth=8, skips=(4,))
  _assert_rows_close(got[0], want[0])
  assert (got[1] is None) == (not with_bias)
  if with_bias:
    _assert_rows_close(got[1], want[1])
  _assert_dw_close(got[2], want[2])


@pytest.mark.cuda
@pytest.mark.parametrize('widths', NERF_WIDTHS)
def test_nerf_backward_chunks_are_deterministic_on_card(cuda_device, widths):
  g = torch.Generator().manual_seed(7)
  params = _tree_to(_nerf(g, widths), cuda_device)
  n = 5000
  x = torch.randn(n, 51, generator=g).to(cuda_device)
  rb = torch.randn(n, widths[1], generator=g).to(cuda_device)
  ga = torch.randn(n, 8, generator=g).to(cuda_device)
  gr = torch.randn(n, 8, generator=g).to(cuda_device)
  ops = fused_mlp.pack_nerf_mlp(params, 51, 8, (4,))
  runs = [fused_mlp._launch_nerf_bwd(x, rb, ops, 8, ga, gr, chunk=1024)
          for _ in range(2)]
  torch.cuda.synchronize()
  for name in runs[0][2]:
    assert torch.equal(runs[0][2][name], runs[1][2][name]), name
  whole = fused_mlp._launch_nerf_bwd(x, rb, ops, 8, ga, gr)
  torch.testing.assert_close(runs[0][0], whole[0], atol=0, rtol=0)
  for name in whole[2]:
    torch.testing.assert_close(runs[0][2][name], whole[2][name], atol=1e-3,
                               rtol=1e-3)


def _warp_inputs(generator, device, n, nt):
  x = torch.randn(n, 39, generator=generator).to(device)
  e = torch.rand(n, 8, generator=generator).to(device)
  ts = [torch.randn(n, 39, generator=generator).to(device) for _ in range(nt)]
  go = torch.randn(n, 8, generator=generator).to(device)
  gjs = [torch.randn(n, 8, generator=generator).to(device) for _ in range(nt)]
  return x, e, ts, go, gjs


def _assert_warp_forward_close(got, x, e, ts, params):
  out, jouts = got
  want_out, want_jouts = fused_warp.warp_mlp_reference(
      x, e, ts, params, trunk_depth=6, skips=(4,))
  torch.testing.assert_close(out, want_out, atol=ATOL, rtol=RTOL)
  assert len(jouts) == len(ts)
  for got_j, want_j in zip(jouts, want_jouts):
    # The tangent chains take the primal's ReLU mask: flips show here too.
    _assert_rows_close(got_j, want_j)


# A block owns 128 rows with no tangents and 32 of each chain with 3: 31,
# 32, 33, 127, 128, 129 and 257 sit at its edges.
@pytest.mark.cuda
@pytest.mark.parametrize('n', [1, 31, 32, 33, 64, 100, 127, 128, 129, 257,
                               4099])
@pytest.mark.parametrize('nt', [0, 3])
def test_warp_forward_kernel_matches_plain_on_card(cuda_device, n, nt):
  g = torch.Generator().manual_seed(n + nt)
  params = _bench_warp(g, cuda_device)
  x, e, ts = _warp_inputs(g, cuda_device, n, nt)[:3]
  before = fused_warp.warp_mlp_forward.launches
  got = fused_warp.warp_mlp_forward(x, e, ts, params, trunk_depth=6,
                                    skips=(4,))
  torch.cuda.synchronize()
  assert fused_warp.warp_mlp_forward.launches == before + 1
  _assert_warp_forward_close(got, x, e, ts, params)


@pytest.mark.cuda
@pytest.mark.parametrize('nt', [0, 3])
def test_warp_forward_kernel_is_deterministic_on_card(cuda_device, nt):
  g = torch.Generator().manual_seed(8 + nt)
  params = _bench_warp(g, cuda_device)
  x, e, ts = _warp_inputs(g, cuda_device, 4099, nt)[:3]
  runs = [fused_warp.warp_mlp_forward(x, e, ts, params, trunk_depth=6,
                                      skips=(4,)) for _ in range(2)]
  torch.cuda.synchronize()
  assert torch.equal(runs[0][0], runs[1][0])
  for first, second in zip(runs[0][1], runs[1][1]):
    assert torch.equal(first, second)


@pytest.mark.cuda
def test_warp_forward_head_bias_reaches_the_primal_only_on_card(cuda_device):
  g = torch.Generator().manual_seed(9)
  params = _bench_warp(g, cuda_device)
  x, e, ts = _warp_inputs(g, cuda_device, 1000, 3)[:3]
  bias = torch.randn(6, generator=g).to(cuda_device)
  with_bias = {'trunk': params['trunk'], 'head': {'logit': {
      'kernel': params['head']['logit']['kernel'], 'bias': bias}}}
  without = {'trunk': params['trunk'], 'head': {'logit': {
      'kernel': params['head']['logit']['kernel'],
      'bias': torch.zeros_like(bias)}}}
  kw = dict(trunk_depth=6, skips=(4,))
  got = fused_warp.warp_mlp_forward(x, e, ts, with_bias, **kw)
  base = fused_warp.warp_mlp_forward(x, e, ts, without, **kw)
  torch.cuda.synchronize()
  _assert_warp_forward_close(got, x, e, ts, with_bias)
  # The same sums in the same order: the bias is all that differs.
  want = bias.to(torch.bfloat16).float()
  torch.testing.assert_close(got[0][:, :6] - base[0][:, :6],
                             want.expand(1000, 6), atol=1e-5, rtol=0)
  for got_j, base_j in zip(got[1], base[1]):
    assert torch.equal(got_j, base_j)


def _assert_warp_backward_close(got, want, need_dx):
  _assert_rows_close(got[0], want[0])
  if need_dx:
    _assert_rows_close(got[1], want[1])
    for got_t, want_t in zip(got[2], want[2]):
      _assert_rows_close(got_t, want_t)
  else:
    assert got[1] is None and got[2] is None
  _assert_dw_close(got[3], want[3])


# The row pass's block owns 128 rows with no tangents and 32 of each chain
# with 3: 31, 100 and 129 fall inside a block, 31 and 100 below one.
@pytest.mark.cuda
@pytest.mark.parametrize('n', [1, 31, 64, 100, 129, 4099])
@pytest.mark.parametrize('nt', [0, 3])
@pytest.mark.parametrize('need_dx', [False, True])
def test_warp_backward_kernel_matches_plain_on_card(cuda_device, n, nt,
                                                    need_dx):
  g = torch.Generator().manual_seed(n + nt)
  params = _bench_warp(g, cuda_device)
  x, e, ts, go, gjs = _warp_inputs(g, cuda_device, n, nt)
  before = fused_warp.warp_mlp_backward.launches
  got = fused_warp.warp_mlp_backward(x, e, ts, params, go, gjs,
                                     trunk_depth=6, skips=(4,),
                                     need_dx=need_dx)
  torch.cuda.synchronize()
  assert fused_warp.warp_mlp_backward.launches == before + 1
  want = fused_warp.warp_mlp_backward_reference(
      x, e, ts, params, go, gjs, trunk_depth=6, skips=(4,), need_dx=need_dx)
  _assert_warp_backward_close(got, want, need_dx)


@pytest.mark.cuda
@pytest.mark.parametrize('nt', [0, 3])
@pytest.mark.parametrize('need_dx', [False, True])
def test_warp_backward_chunk_boundary_inside_a_block_on_card(cuda_device, nt,
                                                             need_dx):
  """Chunks of 1000 rows: each boundary falls inside a block of rows."""
  g = torch.Generator().manual_seed(13 + nt)
  params = _bench_warp(g, cuda_device)
  n = 2900
  x, e, ts, go, gjs = _warp_inputs(g, cuda_device, n, nt)
  ops = fused_warp.pack(params, 39, 8, 6, (4,))
  assert [r for _, r in fused_warp.bwd_chunks(n, 1000)] == [967, 967, 966]
  got = fused_warp._launch_bwd(x, e, ts, go, gjs, ops, 6, (4,), need_dx,
                               chunk=1000)
  whole = fused_warp._launch_bwd(x, e, ts, go, gjs, ops, 6, (4,), need_dx)
  torch.cuda.synchronize()
  # The rows' outputs do not depend on the chunks; dW sums in other order.
  torch.testing.assert_close(got[0], whole[0], atol=0, rtol=0)
  if need_dx:
    torch.testing.assert_close(got[1], whole[1], atol=0, rtol=0)
    for got_t, whole_t in zip(got[2], whole[2]):
      torch.testing.assert_close(got_t, whole_t, atol=0, rtol=0)
  for name in whole[3]:
    torch.testing.assert_close(got[3][name], whole[3][name], atol=1e-3,
                               rtol=1e-3)
  want = fused_warp.warp_mlp_backward_reference(
      x, e, ts, params, go, gjs, trunk_depth=6, skips=(4,), need_dx=need_dx)
  _assert_warp_backward_close(
      got[:3] + (fused_warp.grads_to_tree(got[3], params, 6, (4,)),), want,
      need_dx)


@pytest.mark.cuda
def test_warp_backward_chunks_are_deterministic_on_card(cuda_device):
  g = torch.Generator().manual_seed(11)
  params = _bench_warp(g, cuda_device)
  n = 3000
  x = torch.randn(n, 39, generator=g).to(cuda_device)
  e = torch.rand(n, 8, generator=g).to(cuda_device)
  ts = [torch.randn(n, 39, generator=g).to(cuda_device) for _ in range(3)]
  go = torch.randn(n, 8, generator=g).to(cuda_device)
  gjs = [torch.randn(n, 8, generator=g).to(cuda_device) for _ in range(3)]
  ops = fused_warp.pack(params, 39, 8, 6, (4,))
  runs = [fused_warp._launch_bwd(x, e, ts, go, gjs, ops, 6, (4,), True,
                                 chunk=1024) for _ in range(2)]
  torch.cuda.synchronize()
  for name in runs[0][3]:
    assert torch.equal(runs[0][3][name], runs[1][3][name]), name
  whole = fused_warp._launch_bwd(x, e, ts, go, gjs, ops, 6, (4,), True)
  torch.testing.assert_close(runs[0][0], whole[0], atol=0, rtol=0)
  for name in whole[3]:
    torch.testing.assert_close(runs[0][3][name], whole[3][name], atol=1e-3,
                               rtol=1e-3)
