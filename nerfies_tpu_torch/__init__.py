"""nerfies_tpu_torch: the PyTorch and CUDA port of nerfies_tpu.

The JAX package `nerfies_tpu` stays the reference; this package imports
`torch` and numpy only, never JAX, Flax or anything of `nerfies_tpu`.

Two paths are ported, each through hand-written CUDA kernels on a CUDA
tensor and through their plain PyTorch versions on a CPU tensor:
- serving: `evaluation.make_render_fn` with `evaluation.render_camera`
  (rays made on the device) or `evaluation.render_image` drives
  `fast_render.render_rays`, whose two MLP stacks run as the kernels of
  `csrc/fused_mlp.cu` (`ops/fused_mlp.py`), optionally culled through an
  occupancy grid (`occupancy.py`). The eval CLI,
  `python -m nerfies_tpu_torch.eval` (`eval.py`), evaluates the trainer's
  checkpoints with PSNR, MS-SSIM (`ops/ssim.py`) and LPIPS (`lpips.py`)
  and writes colorized maps (`visualization.py`);
  `python -m nerfies_tpu_torch.render_video` renders a camera path;
- training: `training.make_train_step` runs `fused_train.model_forward`,
  whose NeRF MLP and warp trunk are autograd Functions over the forward
  and backward kernels of `csrc/fused_mlp.cu`, `csrc/fused_mlp_bwd.cu`,
  `csrc/fused_warp.cu`, `csrc/fused_warp_bwd.cu` and `csrc/weight_grad.cu`
  (`ops/fused_mlp.py`, `ops/fused_warp.py`). The training CLI,
  `python -m nerfies_tpu_torch.train` (`train.py`), drives it over a
  Nerfies capture with gin configs (`minigin.py`, `configs.py`),
  schedules, the data pipeline (`datasets/`) and checkpoints.

Where JAX runs the Flax forward, `model.apply` (a train step without
`use_fused_mlp`, as in every configs/gpu_*.gin; a render of a stratified
model or of an architecture the serving path does not cover), the port
runs `models.nerf.NerfModel.forward`: plain PyTorch whose products are
`torch.matmul`, as JAX's are XLA dots outside any Pallas kernel. Each
entry point picks its route by JAX's rule, never because a kernel failed.

Entry points take `device=` (the CLI `--device`) and default to 'cuda'.
Without a card they raise unless the caller passes device='cpu'; they
never move to the CPU on their own. Under `torchrun` the CLIs train,
evaluate and render data-parallel over the machine's cards, one process
per card (`parallel/mesh.py`).
"""

import os

import torch


def resolve_device(device='cuda') -> torch.device:
  """The torch.device an entry point runs on; raises if CUDA is missing.

  Under `torchrun` (LOCAL_RANK set), 'cuda' is this process's card,
  cuda:{LOCAL_RANK}.
  """
  device = torch.device(device)
  if (device.type == 'cuda' and device.index is None
      and 'LOCAL_RANK' in os.environ):
    device = torch.device('cuda', int(os.environ['LOCAL_RANK']))
  if device.type == 'cuda' and not torch.cuda.is_available():
    raise RuntimeError(
        'nerfies_tpu_torch runs on a CUDA card by default and none is '
        'available; pass device="cpu" to run the plain PyTorch path.')
  return device
