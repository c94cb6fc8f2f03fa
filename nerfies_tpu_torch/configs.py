"""Experiment, model, train and eval configuration, gin-configurable.

Port of nerfies_tpu/configs.py: the same four dataclasses with the same
fields and defaults, configurable through the port's `minigin`, so the
configs/*.gin zoo parses unchanged. The activations that gin files name
as `@nn.relu`, `@nn.softplus`, ... resolve to the port's activation
names ('relu', 'softplus', ...), the keys of ACTIVATIONS.

The train step takes JAX's route: the fused path (fused_train.model_forward,
bf16 kernels with ReLU between layers) when `use_fused_mlp` is set and
fast_render.supported holds, whatever `use_bfloat16` says, and the plain
forward (NerfModel.forward, JAX's `model.apply`) otherwise. The plain
forward reads `use_bfloat16` (bf16 products, as the Flax modules),
`activation`, and `use_remat` / `remat_policy` (torch.utils.checkpoint
per NeRF MLP level and per warp field call; 'dots' keeps the products'
outputs), which trade memory for time and leave the results as they are.
"""

import dataclasses
from typing import Any, Mapping, Optional, Tuple

import torch.nn.functional as F

from nerfies_tpu_torch import minigin as gin

ScheduleDef = Any

ACTIVATIONS = {
    'relu': F.relu,
    'softplus': F.softplus,
    'sigmoid': F.sigmoid,
    'elu': F.elu,
    'tanh': F.tanh,
    'leaky_relu': F.leaky_relu,
}

# Activations reachable from config files as @nn.<name> and
# @flax.nn.<name>, as nerfies_tpu/configs.py registers them; each resolves
# to its name.
for _act_name in ('elu', 'relu', 'leaky_relu', 'tanh', 'sigmoid', 'softplus'):
  gin.register_external(f'flax.nn.{_act_name}', _act_name)
  gin.register_external(f'nn.{_act_name}', _act_name)


@gin.configurable
@dataclasses.dataclass
class ModelConfig:
  """Parameters of the NeRF model (see nerfies_tpu.configs.ModelConfig)."""
  # Sample linearly in disparity rather than depth.
  use_linear_disparity: bool = False
  # Use white as the default background.
  use_white_background: bool = False
  # Use stratified sampling.
  use_stratified_sampling: bool = True
  # Use the sample at infinity.
  use_sample_at_infinity: bool = True
  # The standard deviation of the alpha noise.
  noise_std: Optional[float] = None
  # Widened-sigmoid rgb padding: rgb = sigmoid(x) * (1 + 2p) - p.
  rgb_padding: float = 0.0

  # Trunk depth/width of the NeRF MLP.
  nerf_trunk_depth: int = 8
  nerf_trunk_width: int = 256
  # Conditional (rgb) branch depth/width.
  nerf_rgb_branch_depth: int = 1
  nerf_rgb_branch_width: int = 128
  # Intermediate / sigma activations, by name (keys of ACTIVATIONS).
  activation: str = 'relu'
  sigma_activation: str = 'relu'
  # Skip connection layers.
  nerf_skips: Tuple[int, ...] = (4,)
  # Output channel counts.
  alpha_channels: int = 1
  rgb_channels: int = 3
  # Positional encoding octaves.
  num_nerf_point_freqs: int = 10
  num_nerf_viewdir_freqs: int = 4
  # Samples per ray.
  num_coarse_samples: int = 64
  num_fine_samples: int = 128
  # Conditioning switches.
  use_viewdirs: bool = True
  use_trunk_condition: bool = False
  use_alpha_condition: bool = False
  use_rgb_condition: bool = False

  # Appearance / camera GLO metadata.
  use_appearance_metadata: bool = False
  appearance_metadata_dims: int = 8
  use_camera_metadata: bool = False
  camera_metadata_dims: int = 2

  # Warp field.
  use_warp: bool = False
  num_warp_freqs: int = 8
  num_warp_features: int = 8
  warp_field_type: str = 'translation'  # 'translation' | 'se3'
  warp_metadata_encoder_type: str = 'glo'
  warp_kwargs: Mapping[str, Any] = dataclasses.field(default_factory=dict)

  # Execution switches of the JAX package (see the module docstring).
  use_bfloat16: bool = False
  use_remat: bool = True
  remat_policy: str = 'dots'
  # The fused train path (the kernels); False trains through the plain
  # forward, as JAX's model.apply.
  use_fused_mlp: bool = False
  use_fused_warp: bool = True


@gin.configurable
@dataclasses.dataclass
class ExperimentConfig:
  """Experiment configuration (see nerfies_tpu.configs.ExperimentConfig)."""
  subname: Optional[str] = None
  # Image scale; should be a power of 2.
  image_scale: int = 4
  # Random seed for all experiment RNGs.
  random_seed: int = 12345
  # Datasource type; 'nerfies' is the on-disk capture format.
  datasource_type: str = 'nerfies'
  datasource_spec: Optional[Mapping[str, Any]] = None
  # Extra DataSource kwargs, e.g. {'preload': False} for the streaming pool.
  datasource_kwargs: Mapping[str, Any] = dataclasses.field(
      default_factory=dict)


@gin.configurable
@dataclasses.dataclass
class TrainConfig:
  """Training parameters (see nerfies_tpu.configs.TrainConfig)."""
  batch_size: Any = gin.REQUIRED

  lr_schedule: ScheduleDef = dataclasses.field(default_factory=lambda: {
      'type': 'exponential',
      'initial_value': 0.001,
      'final_value': 0.0001,
      'num_steps': 1000000,
  })
  max_steps: int = 1000000

  warp_alpha_schedule: ScheduleDef = dataclasses.field(default_factory=lambda: {
      'type': 'linear',
      'initial_value': 0.0,
      'final_value': 8.0,
      'num_steps': 80000,
  })
  time_alpha_schedule: ScheduleDef = ('constant', 0.0)

  # Elastic regularization.
  use_elastic_loss: bool = False
  elastic_loss_weight_schedule: ScheduleDef = ('constant', 0.0)
  elastic_reduce_method: str = 'weight'  # 'weight' | 'median'
  elastic_loss_type: str = 'log_svals'
  # Background regularization.
  use_background_loss: bool = False
  background_loss_weight: float = 0.0
  background_points_batch_size: int = 16384
  # Warp regularization.
  use_warp_reg_loss: bool = False
  warp_reg_loss_weight: float = 0.0
  warp_reg_loss_alpha: float = -2.0
  warp_reg_loss_scale: float = 0.001

  # Kept for the config zoo; the ray pool shuffles by permutation.
  shuffle_buffer_size: int = 5000000
  # Logging cadence.
  save_every: int = 10000
  log_every: int = 500
  histogram_every: int = 5000
  print_every: int = 25


@gin.configurable
@dataclasses.dataclass
class EvalConfig:
  """Evaluation parameters (see nerfies_tpu.configs.EvalConfig), read by
  the eval CLI (`python -m nerfies_tpu_torch.eval`)."""
  eval_once: bool = False
  save_output: bool = True
  # Rays per render dispatch.
  chunk: int = 8192
  # Renders rotate after this many checkpoints.
  max_render_checkpoints: int = 3

  num_val_eval: Optional[int] = 10
  num_train_eval: Optional[int] = 10
  num_test_eval: Optional[int] = 10

  # LPIPS perceptual metric.
  compute_lpips: bool = True
  lpips_weights: Optional[str] = None

  # Per-ray sample counts at eval time (None: the training counts).
  num_coarse_samples: Optional[int] = None
  num_fine_samples: Optional[int] = None

  # Occupancy-grid empty-space skipping.
  use_occupancy_culling: bool = False
  occupancy_resolution: int = 128
  occupancy_sigma_threshold: float = 0.05
  occupancy_bbox_margin: float = 0.2
  occupancy_keep_coarse: Optional[int] = None
  occupancy_keep_fine: Optional[int] = None

  # One-flag serving preset.
  fast_preview: bool = False


def bench_render_config() -> ModelConfig:
  """The render model that bench.py serves (bench.py:57-87, 268-272).

  NeRF trunk 8x256 with a skip at 4 and an rgb branch of 128; SE(3) warp
  with a 6x128 trunk, 6 warp frequencies and 8 GLO features; viewdir and
  camera conditions; 128 coarse and 128 fine samples, deterministic; bf16
  through the fused path.
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
      use_bfloat16=True,
      use_fused_mlp=True,
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
