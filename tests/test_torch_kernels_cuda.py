"""The CUDA kernels against their plain versions, on a card.

Marked `cuda`: they skip without a card, since a CUDA kernel has no CPU
mode. This file imports no JAX, so it also runs on a machine without it:

  python3 -m pytest --noconftest -p no:cacheprovider -m cuda \
      tests/test_torch_kernels_cuda.py
"""

import pytest
import torch

from nerfies_tpu_torch.models import modules
from nerfies_tpu_torch.ops import fused_mlp

# bf16 operands and storage between layers: the tolerance of
# tests/test_fused_mlp.py for the same outputs.
ATOL = RTOL = 0.05


@pytest.fixture
def cuda_device():
  if not torch.cuda.is_available():
    pytest.skip('needs a CUDA card: the kernels have no CPU mode')
  return torch.device('cuda')


def _bench_width_nerf(generator):
  return modules.nerf_mlp(point_dims=51, rgb_condition_dims=29,
                          generator=generator)


@pytest.mark.cuda
@pytest.mark.parametrize('n', [1, 64, 1000, 4099])
@pytest.mark.parametrize('with_bias', [False, True])
def test_nerf_kernel_matches_plain_on_card(cuda_device, n, with_bias):
  g = torch.Generator().manual_seed(n)
  params = _tree_to(_bench_width_nerf(g), cuda_device)
  x = torch.randn(n, 51, generator=g).to(cuda_device)
  rb = torch.randn(n, 128, generator=g).to(cuda_device) if with_bias else None
  before = fused_mlp.nerf_mlp_forward.launches
  got = fused_mlp.nerf_mlp_forward(x, rb, params, trunk_depth=8, skips=(4,))
  torch.cuda.synchronize()
  assert fused_mlp.nerf_mlp_forward.launches == before + 1
  want = fused_mlp.nerf_mlp_reference(x, rb, params, trunk_depth=8,
                                      skips=(4,))
  for g_, w_ in zip(got, want):
    torch.testing.assert_close(g_, w_, atol=ATOL, rtol=RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize('n', [1, 64, 4099])
def test_warp_kernel_matches_plain_on_card(cuda_device, n):
  g = torch.Generator().manual_seed(n)
  trunk = modules.mlp([39, 8], 6, 128, (4,), generator=g)
  head = modules.mlp([128], 0, 128, output_channels=6, generator=g)
  params = _tree_to({'trunk': trunk, 'branches_wv': head}, cuda_device)
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


def _tree_to(tree, device):
  return {k: (_tree_to(v, device) if isinstance(v, dict)
              else v.to(device)) for k, v in tree.items()}
