"""Model and training configuration for the port, without gin.

Plain dataclasses with the fields of nerfies_tpu/configs.py that the
ported paths read, under the same names and defaults. The sigma activation
is named by string ('relu', 'softplus', ...) instead of a Flax function.
The port always runs the MLPs through the fused kernels in bf16 with
ReLU, as the JAX fused path does, so `activation`, `use_bfloat16`,
`use_fused_mlp` and `use_fused_warp` are left out. Parsing the
configs/*.gin zoo waits for the port of minigin.
"""

import dataclasses
from typing import Any, Mapping, Optional, Tuple

import torch.nn.functional as F

ACTIVATIONS = {
    'relu': F.relu,
    'softplus': F.softplus,
    'sigmoid': F.sigmoid,
    'elu': F.elu,
    'tanh': F.tanh,
    'leaky_relu': F.leaky_relu,
}


@dataclasses.dataclass
class ModelConfig:
  """Parameters of the NeRF model (see nerfies_tpu.configs.ModelConfig)."""
  use_linear_disparity: bool = False
  use_white_background: bool = False
  use_stratified_sampling: bool = True
  use_sample_at_infinity: bool = True
  noise_std: Optional[float] = None
  rgb_padding: float = 0.0

  nerf_trunk_depth: int = 8
  nerf_trunk_width: int = 256
  nerf_rgb_branch_depth: int = 1
  nerf_rgb_branch_width: int = 128
  sigma_activation: str = 'relu'
  nerf_skips: Tuple[int, ...] = (4,)
  alpha_channels: int = 1
  rgb_channels: int = 3
  num_nerf_point_freqs: int = 10
  num_nerf_viewdir_freqs: int = 4
  num_coarse_samples: int = 64
  num_fine_samples: int = 128
  use_viewdirs: bool = True
  use_trunk_condition: bool = False
  use_alpha_condition: bool = False
  use_rgb_condition: bool = False

  use_appearance_metadata: bool = False
  appearance_metadata_dims: int = 8
  use_camera_metadata: bool = False
  camera_metadata_dims: int = 2

  use_warp: bool = False
  num_warp_freqs: int = 8
  num_warp_features: int = 8
  warp_field_type: str = 'translation'  # 'translation' | 'se3'
  warp_metadata_encoder_type: str = 'glo'
  warp_kwargs: Mapping[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class TrainConfig:
  """The fields of nerfies_tpu.configs.TrainConfig that train_step reads."""
  batch_size: int
  use_elastic_loss: bool = False
  elastic_reduce_method: str = 'weight'  # 'weight' | 'median'
  elastic_loss_type: str = 'log_svals'
  use_background_loss: bool = False
  background_points_batch_size: int = 16384
  use_warp_reg_loss: bool = False


def bench_render_config() -> ModelConfig:
  """The render model that bench.py serves (bench.py:57-87, 268-272).

  NeRF trunk 8x256 with a skip at 4 and an rgb branch of 128; SE(3) warp
  with a 6x128 trunk, 6 warp frequencies and 8 GLO features; viewdir and
  camera conditions; 128 coarse and 128 fine samples, deterministic.
  """
  return ModelConfig(
      num_coarse_samples=128,
      num_fine_samples=128,
      nerf_trunk_depth=8,
      nerf_trunk_width=256,
      nerf_rgb_branch_depth=1,
      nerf_rgb_branch_width=128,
      num_nerf_point_freqs=8,
      num_nerf_viewdir_freqs=4,
      use_warp=True,
      warp_field_type='se3',
      num_warp_freqs=6,
      num_warp_features=8,
      use_appearance_metadata=True,
      use_camera_metadata=True,
      camera_metadata_dims=2,
      sigma_activation='softplus',
      use_stratified_sampling=False,
      use_sample_at_infinity=True,
  )


# The ids and clip range bench.py builds the render model with.
BENCH_RENDER_IDS = dict(appearance_ids=tuple(range(16)), camera_ids=(0, 1),
                        warp_ids=tuple(range(16)), near=0.1, far=2.0)


def bench_train_config() -> Tuple[ModelConfig, TrainConfig]:
  """The training workload of bench.py (bench.py:57-107).

  The render model of `bench_render_config` with stratified sampling on,
  and the train config of bench.py's build_workload: batch 6144 rays,
  elastic loss 'log_svals' reduced by 'weight' over the dense coarse
  Jacobians, background loss over 16,384 points. Build the model with
  BENCH_RENDER_IDS and use_warp_jacobian=True, use_weights=True, and step
  it with BENCH_TRAIN_SCALARS at warp alpha BENCH_WARP_ALPHA
  (bench.py:243-246).
  """
  model = dataclasses.replace(bench_render_config(),
                              use_stratified_sampling=True)
  train = TrainConfig(batch_size=6144, use_elastic_loss=True,
                      elastic_reduce_method='weight',
                      elastic_loss_type='log_svals',
                      use_background_loss=True,
                      background_points_batch_size=16384)
  return model, train


BENCH_TRAIN_SCALARS = dict(learning_rate=1e-3, elastic_loss_weight=1e-3,
                           background_loss_weight=1.0)
BENCH_WARP_ALPHA = 6.0
