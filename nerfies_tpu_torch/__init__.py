"""nerfies_tpu_torch: the PyTorch and CUDA port of nerfies_tpu.

The JAX package `nerfies_tpu` stays the reference; this package imports
`torch` and numpy only, never JAX, Flax or anything of `nerfies_tpu`.

Two paths are ported, each through hand-written CUDA kernels on a CUDA
tensor and through their plain PyTorch versions on a CPU tensor:
- serving: `evaluation.make_render_fn` and `evaluation.render_image` drive
  `fast_render.render_rays`, whose two MLP stacks run as the kernels of
  `csrc/fused_mlp.cu` (`ops/fused_mlp.py`);
- training: `training.make_train_step` runs `fused_train.model_forward`,
  whose NeRF MLP and warp trunk are autograd Functions over the forward
  and backward kernels of `csrc/fused_mlp.cu`, `csrc/fused_mlp_bwd.cu`,
  `csrc/fused_warp.cu` and `csrc/weight_grad.cu` (`ops/fused_mlp.py`,
  `ops/fused_warp.py`).

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
