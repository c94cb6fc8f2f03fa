"""COLMAP structure-from-motion driver.

Runs the `colmap` binary through the three stages that the upstream
Nerfies capture notebook scripts by hand (feature extraction, matching,
mapping), with the notebook's nerfies-tuned flags as defaults, as
nerfies_tpu/colmap/runner.py does. Pure subprocess
orchestration; pair with `SceneManager` to read the resulting model.
"""

import subprocess
from pathlib import Path
from typing import List, Optional, Sequence


def feature_extractor_args(database_path,
                           image_dir,
                           share_intrinsics: bool = True,
                           assume_upright_cameras: bool = True,
                           camera_model: str = 'OPENCV',
                           use_gpu: bool = False) -> List[str]:
  """Arguments for `colmap feature_extractor` (notebook cell 13)."""
  return [
      'feature_extractor',
      '--SiftExtraction.use_gpu', str(int(use_gpu)),
      '--SiftExtraction.upright', str(int(assume_upright_cameras)),
      '--ImageReader.camera_model', camera_model,
      '--ImageReader.single_camera', str(int(share_intrinsics)),
      '--database_path', str(database_path),
      '--image_path', str(image_dir),
  ]


def matcher_args(database_path,
                 match_method: str = 'exhaustive',
                 vocab_tree_path=None,
                 use_gpu: bool = False) -> List[str]:
  """Arguments for the matcher stage (notebook cell 14).

  `exhaustive` for short captures; `vocab_tree` (requires a downloaded
  vocabulary tree) for long ones.
  """
  if match_method == 'exhaustive':
    return [
        'exhaustive_matcher',
        '--SiftMatching.use_gpu', str(int(use_gpu)),
        '--database_path', str(database_path),
    ]
  if match_method == 'vocab_tree':
    if vocab_tree_path is None:
      raise ValueError('vocab_tree matching requires vocab_tree_path.')
    return [
        'vocab_tree_matcher',
        '--VocabTreeMatching.vocab_tree_path', str(vocab_tree_path),
        '--SiftMatching.use_gpu', str(int(use_gpu)),
        '--database_path', str(database_path),
    ]
  raise ValueError(f'Unknown match_method {match_method!r}')


def mapper_args(database_path,
                image_dir,
                output_dir,
                refine_principal_point: bool = True,
                min_num_matches: int = 32,
                filter_max_reproj_error: float = 2.0,
                tri_complete_max_reproj_error: float = 2.0) -> List[str]:
  """Arguments for `colmap mapper` (notebook cell 15)."""
  return [
      'mapper',
      '--Mapper.ba_refine_principal_point',
      str(int(refine_principal_point)),
      '--Mapper.filter_max_reproj_error', str(filter_max_reproj_error),
      '--Mapper.tri_complete_max_reproj_error',
      str(tri_complete_max_reproj_error),
      '--Mapper.min_num_matches', str(min_num_matches),
      '--database_path', str(database_path),
      '--image_path', str(image_dir),
      '--output_path', str(output_dir),
  ]


def run_colmap(args: Sequence[str], colmap_binary: str = 'colmap') -> None:
  """Invokes one COLMAP stage, surfacing its log on failure."""
  result = subprocess.run([colmap_binary, *args],
                          capture_output=True, text=True)
  if result.returncode != 0:
    raise RuntimeError(
        f'colmap {args[0]} failed (exit {result.returncode}):\n'
        f'{result.stdout[-2000:]}\n{result.stderr[-2000:]}')


def largest_model_dir(sparse_dir) -> Path:
  """COLMAP may split the capture into several models (sparse/0, 1, ...);
  picks the one registering the most images."""
  sparse_dir = Path(sparse_dir)
  candidates = [d for d in sorted(sparse_dir.iterdir()) if d.is_dir()
                and ((d / 'images.bin').exists()
                     or (d / 'images.txt').exists())]
  if not candidates:
    raise FileNotFoundError(f'No COLMAP models under {sparse_dir}')
  if len(candidates) == 1:
    return candidates[0]

  from nerfies_tpu_torch.colmap import SceneManager
  def num_images(d):
    return len(SceneManager(d).load().images)
  return max(candidates, key=num_images)


def run_sfm(image_dir,
            workspace_dir,
            colmap_binary: str = 'colmap',
            share_intrinsics: bool = True,
            assume_upright_cameras: bool = True,
            match_method: str = 'exhaustive',
            vocab_tree_path=None,
            refine_principal_point: bool = True,
            min_num_matches: int = 32,
            filter_max_reproj_error: float = 2.0,
            tri_complete_max_reproj_error: float = 2.0) -> Path:
  """Full SfM: features -> matches -> mapping. Returns the model dir.

  `workspace_dir` receives `database.db` and `sparse/<i>/`; the returned
  path is the largest reconstructed model, ready for `SceneManager`.
  """
  workspace_dir = Path(workspace_dir)
  workspace_dir.mkdir(parents=True, exist_ok=True)
  database_path = workspace_dir / 'database.db'
  sparse_dir = workspace_dir / 'sparse'
  sparse_dir.mkdir(exist_ok=True)

  run_colmap(
      feature_extractor_args(database_path, image_dir,
                             share_intrinsics=share_intrinsics,
                             assume_upright_cameras=assume_upright_cameras),
      colmap_binary)
  run_colmap(
      matcher_args(database_path, match_method=match_method,
                   vocab_tree_path=vocab_tree_path),
      colmap_binary)
  run_colmap(
      mapper_args(database_path, image_dir, sparse_dir,
                  refine_principal_point=refine_principal_point,
                  min_num_matches=min_num_matches,
                  filter_max_reproj_error=filter_max_reproj_error,
                  tri_complete_max_reproj_error=(
                      tri_complete_max_reproj_error)),
      colmap_binary)
  return largest_model_dir(sparse_dir)
