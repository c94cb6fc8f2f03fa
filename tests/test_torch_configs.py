"""The port's schedules, minigin and configs against the JAX package's.

Every schedule type and `from_config` form gives exactly the JAX value at
steps 0 to 300,000; every file of configs/ parses in both minigins to
equal configs (activations compared by name); the port's operative config
parses back in the JAX minigin to the same bindings. Every config takes
the JAX train step's route, fused or through `model.apply`; the one
refusal left (another activation on the fused route) fires before any
data is read.
"""

import argparse
import dataclasses
import pathlib
import types

from flax import linen as nn
import numpy as np
import pytest

from nerfies_tpu import configs as jax_configs
from nerfies_tpu import fused_train as jax_fused_train
from nerfies_tpu import minigin as jax_gin
from nerfies_tpu import schedules as jax_schedules
from nerfies_tpu_torch import configs
from nerfies_tpu_torch import fused_train
from nerfies_tpu_torch import minigin as gin
from nerfies_tpu_torch import schedules
from nerfies_tpu_torch import train

ZOO = pathlib.Path(__file__).resolve().parents[1] / 'configs'
ALL_GIN = sorted(p.stem for p in ZOO.glob('*.gin'))
# Base files: they use macros that only the leaf files define.
BASE_GIN = ('defaults', 'warp_defaults')
LEAF_GIN = [n for n in ALL_GIN if n not in BASE_GIN]
APPLY_GIN = [n for n in LEAF_GIN if n.startswith(('gpu_', 'test_'))]
CONFIG_CLASSES = ('ExperimentConfig', 'ModelConfig', 'TrainConfig',
                  'EvalConfig')


@pytest.fixture(autouse=True)
def _clear_gin():
  gin.clear_config()
  jax_gin.clear_config()
  yield
  gin.clear_config()
  jax_gin.clear_config()


# ---------------------------------------------------------------- schedules

SCHEDULES = {
    'constant': ('constant', 0.5),
    'linear': ('linear', 0.0, 8.0, 80000),
    'linear_zero_steps': ('linear', 1.0, 2.0, 0),
    'exponential': {'type': 'exponential', 'initial_value': 1e-3,
                    'final_value': 1e-4, 'num_steps': 250000},
    'exponential_to_zero': ('exponential', 1e-3, 0.0, 1000),
    'cosine_easing': ('cosine_easing', 0.01, 1e-8, 100000),
    'step': ('step', 1.0, 1000, 0.5, 10),
    'step_final': {'type': 'step', 'initial_value': 1.0,
                   'decay_interval': 30000, 'decay_factor': 0.3,
                   'max_decays': 4, 'final_value': 0.05},
    'piecewise': {'type': 'piecewise', 'schedules': [
        (50000, ('constant', 0.01)),
        (100000, ('cosine_easing', 0.01, 1e-8, 100000))]},
    'delayed': {'type': 'delayed', 'delay_steps': 2500, 'delay_mult': 0.01,
                'base_schedule': {'type': 'exponential',
                                  'initial_value': 1e-3, 'final_value': 1e-5,
                                  'num_steps': 300000}},
}
STEPS = sorted(set(np.linspace(0, 300000, 301).astype(int).tolist()) | {
    1, 2, 999, 1000, 1001, 2499, 2500, 2501, 49999, 50000, 50001, 79999,
    80000, 80001, 149999, 150000, 249999, 250000, 299999})


@pytest.mark.parametrize('name', sorted(SCHEDULES))
@pytest.mark.parametrize('form', ['spec', 'schedule'])
def test_schedules_equal_jax(name, form):
  spec = SCHEDULES[name]
  if form == 'schedule':  # from_config of a Schedule passes it through
    got = schedules.from_config(schedules.from_config(spec))
    want = jax_schedules.from_config(jax_schedules.from_config(spec))
  else:
    got, want = schedules.from_config(spec), jax_schedules.from_config(spec)
  assert type(got).__name__ == type(want).__name__
  assert [got(s) for s in STEPS] == [want(s) for s in STEPS]


def test_schedule_errors_equal_jax():
  for module in (schedules, jax_schedules):
    with pytest.raises(ValueError, match='Final value'):
      module.from_config(('exponential', 1e-4, 1e-3, 10))
    with pytest.raises(ValueError, match='Unknown schedule'):
      module.from_config(0.5)


# ------------------------------------------------------------------ configs

def _parse_both(name, bindings=()):
  for module in (gin, jax_gin):
    module.clear_config()
    module.parse_config_files_and_bindings(
        config_files=[ZOO / f'{name}.gin'], bindings=list(bindings))


def _as_comparable(value):
  """A JAX activation is compared by its name, the port's is that name."""
  return getattr(value, '__name__', value) if callable(value) else value


def _assert_configs_equal(tag):
  for cls_name in CONFIG_CLASSES:
    got = getattr(configs, cls_name)()
    want = getattr(jax_configs, cls_name)()
    got_fields = {f.name for f in dataclasses.fields(got)}
    want_fields = {f.name for f in dataclasses.fields(want)}
    assert got_fields == want_fields, (tag, cls_name)
    for field in sorted(want_fields):
      assert (_as_comparable(getattr(got, field))
              == _as_comparable(getattr(want, field))), (tag, cls_name, field)


@pytest.mark.parametrize('name', LEAF_GIN)
def test_zoo_parses_to_the_jax_configs(name):
  _parse_both(name)
  _assert_configs_equal(name)


@pytest.mark.parametrize('name', BASE_GIN)
def test_base_files_parse_and_need_their_leaf_macros(name):
  _parse_both(name)
  for module, cfg in ((gin, configs), (jax_gin, jax_configs)):
    with pytest.raises(module.ParseError, match='Undefined macro'):
      cfg.TrainConfig()


def test_defaults_match_jax():
  for module in (gin, jax_gin):
    module.parse_config('TrainConfig.batch_size = 8')  # REQUIRED
  _assert_configs_equal('defaults')


@pytest.mark.parametrize('name', ['nn.relu', 'nn.softplus', 'nn.elu',
                                  'nn.leaky_relu', 'nn.tanh',
                                  'flax.nn.sigmoid'])
def test_activation_references_resolve_to_names(name):
  binding = f'ModelConfig.sigma_activation = @{name}'
  for module in (gin, jax_gin):
    module.parse_config(binding)
  got = configs.ModelConfig().sigma_activation
  assert got == jax_configs.ModelConfig().sigma_activation.__name__
  assert got in configs.ACTIVATIONS


@pytest.mark.parametrize('name', LEAF_GIN)
def test_operative_config_parses_back_in_jax(name):
  _parse_both(name, ['TrainConfig.max_steps = 7',
                     "ExperimentConfig.datasource_kwargs = {'preload': False}"])
  text = gin.operative_config_str()
  assert text == jax_gin.operative_config_str()
  jax_gin.clear_config()
  jax_gin.parse_config(text)
  assert jax_gin.operative_config_str() == text
  _assert_configs_equal(name)


# ------------------------------------------------------- the route and guard

def _ids_source(model_config):
  ids = tuple(range(3))
  return types.SimpleNamespace(
      appearance_ids=ids if model_config.use_appearance_metadata else (),
      camera_ids=ids if model_config.use_camera_metadata else (),
      warp_ids=ids if model_config.use_warp else (), near=0.5, far=3.0)


def _jax_takes_the_fused_path(model_config):
  """nerfies_tpu/training.py:277 on the JAX ModelConfig."""
  model = types.SimpleNamespace(**dataclasses.asdict(model_config),
                                metadata_encoded=False)
  return bool(model.use_fused_mlp and jax_fused_train.supported(model))


def _port_route(model):
  """(fused, fused warp) of the port's model."""
  return model.fused_route, model.fused_route and model.use_fused_warp


def _jax_route(model_config):
  fused = _jax_takes_the_fused_path(model_config)
  return fused, fused and model_config.use_fused_warp


@pytest.mark.parametrize('name', APPLY_GIN)
def test_configs_that_jax_trains_through_apply_take_the_plain_route(name):
  """Every configs/gpu_*.gin and test_*.gin builds and trains through
  NerfModel.forward, as JAX trains it through model.apply; the elastic
  loss's dense Jacobians unless its reduction is 'median'."""
  _, model_config, train_config = train.parse_configs([str(ZOO / f'{name}.gin')])
  jax_gin.parse_config_files_and_bindings(config_files=[ZOO / f'{name}.gin'])
  assert not _jax_takes_the_fused_path(jax_configs.ModelConfig())
  model, params = train.construct_model(model_config, train_config,
                                        _ids_source(model_config), 0, 'cpu')
  assert not model.fused_route and 'nerf_mlps_coarse' in params
  assert model.use_warp_jacobian == (
      train_config.use_elastic_loss
      and train_config.elastic_reduce_method != 'median')


_OVERRIDES = {
    'no_fused_mlp': dict(use_fused_mlp=False),
    'trunk_condition': dict(use_fused_mlp=True, use_trunk_condition=True),
    'se3_pivot': dict(use_fused_mlp=True, use_warp=True,
                      warp_field_type='se3', warp_kwargs={'use_pivot': True}),
    'flax_warp': dict(use_fused_mlp=True, use_warp=True,
                      use_fused_warp=False),
    'time_encoder': dict(use_fused_mlp=True, use_warp=True,
                         warp_metadata_encoder_type='time'),
    'f32_fused': dict(use_fused_mlp=True, use_warp=True,
                      use_bfloat16=False),
}


@pytest.mark.parametrize('case', [f'gin:{n}' for n in LEAF_GIN]
                         + sorted(_OVERRIDES))
def test_route_matches_jax(case):
  """The port's route (fused, and the warp kernel inside it) equals
  nerfies_tpu/training.py:277 and fused_train.py:215 for every leaf
  config of configs/ and every override."""
  if case.startswith('gin:'):
    files = [ZOO / f'{case[4:]}.gin']
    _, config, train_config = train.parse_configs([str(f) for f in files])
    jax_gin.parse_config_files_and_bindings(config_files=files)
    jax_config = jax_configs.ModelConfig()
  else:
    config = configs.ModelConfig(**_OVERRIDES[case])
    train_config = configs.TrainConfig(batch_size=8)
    jax_config = jax_configs.ModelConfig(**_OVERRIDES[case])
  config = dataclasses.replace(config, nerf_trunk_width=32,
                               nerf_rgb_branch_width=32)
  model, _ = train.construct_model(config, train_config, _ids_source(config),
                                   0, 'cpu')
  assert _port_route(model) == _jax_route(jax_config)


@pytest.mark.parametrize('name', LEAF_GIN)
def test_configs_on_the_fused_path_build(name):
  bindings = ['ModelConfig.use_fused_mlp = True']
  _, model_config, train_config = train.parse_configs(
      [str(ZOO / f'{name}.gin')], bindings)
  jax_gin.parse_config_files_and_bindings(config_files=[ZOO / f'{name}.gin'],
                                          bindings=bindings)
  assert _jax_takes_the_fused_path(jax_configs.ModelConfig())
  model, params = train.construct_model(model_config, train_config,
                                        _ids_source(model_config), 0, 'cpu')
  assert model.use_fused_mlp and 'nerf_mlps_coarse' in params
  assert model.use_warp_jacobian == train_config.use_elastic_loss


def test_f32_config_on_the_fused_path_is_trainable():
  """use_bfloat16 = False does not leave JAX's fused path, nor the port's."""
  config = configs.ModelConfig(use_fused_mlp=True, use_bfloat16=False)
  fused_train.check_trainable(config)
  jax_config = jax_configs.ModelConfig(use_fused_mlp=True,
                                       use_bfloat16=False)
  assert _jax_takes_the_fused_path(jax_config)


def test_activation_other_than_relu_raises():
  """JAX's fused path ignores `activation`: it trains such a config with
  ReLU between layers (fused_train.supported does not read the field).
  The port refuses it instead."""
  jax_config = jax_configs.ModelConfig(use_fused_mlp=True, activation=nn.elu)
  assert _jax_takes_the_fused_path(jax_config)
  with pytest.raises(NotImplementedError, match='activation'):
    fused_train.check_trainable(configs.ModelConfig(use_fused_mlp=True,
                                                    activation='elu'))


@pytest.mark.parametrize('case', ['gpu_quarterhd', 'elu_on_the_fused_route'])
def test_only_the_activation_guard_fires_before_the_data_is_read(case,
                                                                 tmp_path):
  """configs/gpu_quarterhd.gin goes on to read the (missing) data; the
  one refusal left, another activation on the fused route, fires first."""
  bindings = None
  if case == 'elu_on_the_fused_route':
    bindings = ['ModelConfig.use_fused_mlp = True',
                'ModelConfig.activation = @nn.elu']
  args = argparse.Namespace(
      base_folder=str(tmp_path / 'exp'), data_dir=str(tmp_path / 'missing'),
      gin_configs=[str(ZOO / 'gpu_quarterhd.gin')], gin_bindings=bindings,
      profile_dir=None, device='cpu')
  if bindings:
    with pytest.raises(NotImplementedError, match="activation 'elu'"):
      train.setup(args)
    assert not (tmp_path / 'exp').exists()
  else:
    with pytest.raises(FileNotFoundError):
      train.setup(args)


def test_bench_configs_take_the_fused_path():
  model, _ = configs.bench_train_config()
  fused_train.check_trainable(model)
  fused_train.check_trainable(configs.bench_render_config())
  assert model.use_bfloat16
