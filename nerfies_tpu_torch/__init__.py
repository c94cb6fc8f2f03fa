"""nerfies_tpu_torch: the PyTorch and CUDA port of nerfies_tpu.

The JAX package `nerfies_tpu` stays the reference; this package imports
`torch` and numpy only, never JAX, Flax or anything of `nerfies_tpu`.

The ported slice is serving: `evaluation.make_render_fn` and
`evaluation.render_image` drive `fast_render.render_rays`, whose two MLP
stacks run as hand-written CUDA kernels (`ops/fused_mlp.py`,
`csrc/fused_mlp.cu`) on a CUDA tensor and as their plain PyTorch versions
on a CPU tensor.

Entry points take `device=` and default to 'cuda'. Without a card they
raise unless the caller passes device='cpu'; they never move to the CPU
on their own.
"""

import torch


def resolve_device(device='cuda') -> torch.device:
  """The torch.device an entry point runs on; raises if CUDA is missing."""
  device = torch.device(device)
  if device.type == 'cuda' and not torch.cuda.is_available():
    raise RuntimeError(
        'nerfies_tpu_torch runs on a CUDA card by default and none is '
        'available; pass device="cpu" to run the plain PyTorch path.')
  return device
