#!/usr/bin/env python3
"""Writes JAX's init of the quality bench's model for the port.

It builds, on the CPU, exactly the param tree that
scripts/quality_bench.py builds (its `construct_nerf` call): the bench
model (`bench.model_config` with bf16 and the fused MLP and warp) with
rgb padding 0.001, `jax.random.PRNGKey(0)`, `use_warp_jacobian` and
`use_weights`, and the appearance, camera and warp ids of the quality
scene, read from the scene that JAX's synthetic writer writes with the
bench's defaults. The params go into an npz of '/'-joined names, which
`nerfies_tpu_torch.interop.load_npz_tree` reads and
`nerfies_tpu_torch.quality_bench --init_npz` trains from:

  JAX_PLATFORMS=cpu python3 scripts/quality_init_jax.py \\
      --out nerfies_tpu_torch/curves/init/quality_init_jax_key0.npz

`construct_nerf`'s `batch_size` does not change the params: it inits at
`min(batch_size, 64)` rays, and trees built at 8 and at 16 rays are equal
bit for bit (--check_batch_size repeats that check). So the tree is
built at INIT_BATCH_SIZE rays, not at the bench's 6144.
"""

import argparse
import pathlib
import sys
import tempfile

import jax
import numpy as np

REPO = pathlib.Path(__file__).resolve().parent.parent
# Run as a script, its own folder leads sys.path, and scripts/profile.py
# there would shadow the standard library's `profile`.
sys.path[:] = [str(REPO)] + [
    p for p in sys.path if pathlib.Path(p or '.').resolve() != REPO / 'scripts']

# scripts/quality_bench.py's scene defaults.
SCENE = dict(num_train=24, num_val=2, image_size=(384, 288),
             motion_amplitude=0.15, texture_frequency=20.0,
             cameras_per_state=2, env_background=True, num_points=16384)
INIT_BATCH_SIZE = 8
DEFAULT_OUT = 'nerfies_tpu_torch/curves/init/quality_init_jax_key0.npz'


def scene_ids(scene_dir):
  """The quality scene's ids and bounds, as scripts/quality_bench.py reads
  them (the scene is written first if `scene_dir` holds none)."""
  from nerfies_tpu import datasets
  from nerfies_tpu.datasets import synthetic
  scene = pathlib.Path(scene_dir)
  if not (scene / 'dataset.json').exists():
    synthetic.write_synthetic_dataset(scene, **SCENE)
  datasource = datasets.from_config(
      {'type': 'nerfies', 'data_dir': str(scene)},
      image_scale=1, use_appearance_id=True, use_camera_id=True,
      use_warp_id=True, random_seed=0)
  return dict(appearance_ids=datasource.appearance_ids,
              camera_ids=datasource.camera_ids,
              warp_ids=datasource.warp_ids,
              near=datasource.near, far=datasource.far)


def init_params(ids, batch_size=INIT_BATCH_SIZE):
  """The bench's PRNGKey(0) tree as '/'-joined names -> numpy arrays."""
  from flax import traverse_util
  import bench as B
  from nerfies_tpu.models import nerf
  model_config = B.model_config(use_bfloat16=True, use_fused_mlp=True,
                                use_fused_warp=True)
  model_config.rgb_padding = 0.001  # as scripts/quality_bench.py
  _, params = nerf.construct_nerf(
      jax.random.PRNGKey(0), model_config, batch_size=batch_size,
      use_warp_jacobian=True, use_weights=True, **ids)
  flat = traverse_util.flatten_dict(jax.device_get(params), sep='/')
  return {name: np.asarray(value) for name, value in flat.items()}


def trees_equal(a, b) -> bool:
  """Same names, shapes, dtypes and bits."""
  return a.keys() == b.keys() and all(
      a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
      and a[k].tobytes() == b[k].tobytes() for k in a)


def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  parser.add_argument('--out', default=DEFAULT_OUT)
  parser.add_argument('--scene_dir', default='',
                      help='the quality scene (written here if missing; '
                      'a temporary folder by default)')
  parser.add_argument('--check_batch_size', action='store_true',
                      help='also build at 16 rays and require the same '
                      'bits')
  args = parser.parse_args(argv)
  jax.config.update('jax_platforms', 'cpu')
  with tempfile.TemporaryDirectory() as tmp:
    ids = scene_ids(args.scene_dir or pathlib.Path(tmp) / 'scene')
  params = init_params(ids)
  if args.check_batch_size and not trees_equal(params, init_params(ids, 16)):
    raise SystemExit('construct_nerf\'s batch_size changes the params')
  out = pathlib.Path(args.out)
  out.parent.mkdir(parents=True, exist_ok=True)
  np.savez(out, **params)
  print(f'wrote {out}: {len(params)} leaves, '
        f'{sum(v.size for v in params.values())} params', flush=True)


if __name__ == '__main__':
  main()
