"""CLI: render a novel-view video along a saved camera path, on one card.

The counterpart of scripts/render_video.py: loads the newest checkpoint of
the port's trainer, walks a camera-paths/<trajectory> directory of the
capture, renders each frame with fixed metadata ids through
`evaluation.render_camera` (the rays made on the device), and writes PNG
frames, plus an mp4 where imageio can write one:

  python -m nerfies_tpu_torch.render_video \\
      --base_folder EXP --data_dir SCENE \\
      --gin_configs configs/tpu_vrig_paper.gin --camera_path orbit-mild

`--device cpu` runs the plain PyTorch path; without it the CLI needs a
card. Under `torchrun` every rank renders its slice of every chunk and
rank 0 writes the frames. `main` returns the paths of the frames it
wrote (none on the other ranks).
"""

import argparse
import logging
from pathlib import Path
from typing import List, Optional, Sequence

import torch

from nerfies_tpu_torch import checkpoints
from nerfies_tpu_torch import configs
from nerfies_tpu_torch import datasets
from nerfies_tpu_torch import evaluation
from nerfies_tpu_torch import image_utils
from nerfies_tpu_torch import minigin as gin
from nerfies_tpu_torch import schedules
from nerfies_tpu_torch import training
from nerfies_tpu_torch.models import nerf as models
from nerfies_tpu_torch.parallel import mesh

log = logging.getLogger('nerfies_tpu_torch.render_video')


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
  parser = argparse.ArgumentParser(
      description='Renders a camera path of a trained Nerfies model with '
      'the PyTorch port.')
  parser.add_argument('--base_folder', required=True,
                      help='experiment directory')
  parser.add_argument('--data_dir', required=True, help='dataset directory')
  parser.add_argument('--gin_configs', action='append', default=[],
                      help='Gin config files.')
  parser.add_argument('--gin_bindings', action='append', default=None,
                      help='Gin parameter bindings.')
  parser.add_argument('--camera_path', default='orbit-mild',
                      help='camera-paths subdir name')
  parser.add_argument('--warp_id', type=int, default=0,
                      help='fixed warp metadata id')
  parser.add_argument('--appearance_id', type=int, default=0,
                      help='fixed appearance metadata id')
  parser.add_argument('--camera_id', type=int, default=0,
                      help='fixed camera metadata id')
  parser.add_argument('--chunk', type=int, default=8192,
                      help='rays per render call')
  parser.add_argument('--output_dir', default=None,
                      help='output dir (default <base_folder>/video)')
  parser.add_argument('--device', default='cuda',
                      help="torch device; 'cpu' runs the plain versions.")
  return parser.parse_args(argv)


def render(args: argparse.Namespace) -> List[Path]:
  device = mesh.init(args.device)
  if not mesh.is_main():
    log.setLevel(logging.WARNING)
  gin.clear_config()
  gin.add_search_path('configs')
  gin.parse_config_files_and_bindings(config_files=args.gin_configs,
                                      bindings=args.gin_bindings)
  exp_config = configs.ExperimentConfig()
  model_config = configs.ModelConfig(use_stratified_sampling=False)
  train_config = configs.TrainConfig()

  datasource = datasets.from_config(
      {'type': exp_config.datasource_type, 'data_dir': args.data_dir},
      image_scale=exp_config.image_scale,
      use_appearance_id=model_config.use_appearance_metadata,
      use_camera_id=model_config.use_camera_metadata,
      use_warp_id=model_config.use_warp,
      use_time=model_config.warp_metadata_encoder_type == 'time',
      random_seed=exp_config.random_seed,
      test_camera_trajectory=args.camera_path)

  model, params = models.construct_nerf(
      model_config,
      appearance_ids=datasource.appearance_ids or (0,),
      camera_ids=datasource.camera_ids or (0,),
      warp_ids=datasource.warp_ids or (0,),
      near=datasource.near, far=datasource.far,
      generator=torch.Generator().manual_seed(exp_config.random_seed),
      device=device)
  render_fn = evaluation.make_render_fn(model, device=device)

  checkpoint_dir = Path(args.base_folder) / 'checkpoints'
  state = checkpoints.restore_checkpoint(checkpoint_dir,
                                         training.create_train_state(params))
  warp_alpha = schedules.from_config(train_config.warp_alpha_schedule)(
      state.step)
  log.info('Restored checkpoint at step %d', state.step)
  state = evaluation.RenderState(state.params, warp_alpha=float(warp_alpha),
                                 time_alpha=float(state.time_alpha))

  cameras = datasource.load_test_cameras()
  if not cameras:
    raise ValueError(f'No cameras found for path {args.camera_path!r}')
  log.info('Rendering %d frames', len(cameras))
  out_dir = Path(args.output_dir or Path(args.base_folder) / 'video')
  if mesh.is_main():
    out_dir.mkdir(parents=True, exist_ok=True)

  metadata_ids = {
      'warp': args.warp_id,
      'appearance': args.appearance_id,
      'camera': args.camera_id,
      'time': 0.0,
  }
  frames, paths = [], []
  for i, camera in enumerate(cameras):
    out = evaluation.render_camera(state, camera, metadata_ids, render_fn,
                                   chunk=args.chunk)
    if not mesh.is_main():
      continue
    frame = image_utils.image_to_uint8(out['rgb'])
    path = out_dir / f'{i:06d}.png'
    image_utils.save_image(path, frame)
    frames.append(frame)
    paths.append(path)
    log.info('frame %d: %.0f rays/s', i, out['rays_per_sec'])

  if not mesh.is_main():
    return paths
  try:
    import imageio.v2 as imageio
    imageio.mimwrite(out_dir / 'video.mp4', frames, fps=20)
    log.info('Wrote %s', out_dir / 'video.mp4')
  except Exception as e:  # the mp4 writer is optional
    log.info('Skipping mp4 (%s); PNG frames are in %s', e, out_dir)
  return paths


def main(argv: Optional[Sequence[str]] = None) -> List[Path]:
  args = parse_args(argv)
  if not logging.getLogger().handlers:
    logging.basicConfig(level=logging.INFO,
                        format='%(asctime)s %(levelname)s %(message)s')
  return render(args)


if __name__ == '__main__':
  main()
  mesh.shutdown()
