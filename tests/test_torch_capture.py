"""The port's capture ingestion against the JAX package's.

capture.py, video.py, process_capture and process_video on the same
seeded inputs as nerfies_tpu's: blur scores exactly equal (the grey
conversion and Laplacian are cv2's integer arithmetic, checked against cv2
itself), PNG bytes equal to cv2's, and the dataset directories that
process_capture writes equal file by file. ffmpeg, ffprobe and colmap are
fake executables, as in tests/test_video.py and tests/test_colmap.py.
"""

import json
import stat
import sys

import cv2
import numpy as np
import pytest

from nerfies_tpu import capture as jax_capture
from nerfies_tpu import colmap as jax_colmap
from nerfies_tpu import image_utils as jax_image_utils
from nerfies_tpu import video as jax_video
from nerfies_tpu.datasets import synthetic as jax_synthetic
from nerfies_tpu_torch import capture
from nerfies_tpu_torch import colmap
from nerfies_tpu_torch import datasets
from nerfies_tpu_torch import image_utils
from nerfies_tpu_torch import process_capture
from nerfies_tpu_torch import process_video
from nerfies_tpu_torch import video
from nerfies_tpu_torch.datasets import synthetic
from tests.test_capture import _face_landmark_points
from tests.test_torch_colmap import make_colmap_scene

# --------------------------------------------------------- cv2 arithmetic


def test_rgb_to_gray_equals_cv2_on_every_colour():
  values = np.arange(256, dtype=np.uint8)
  for red in range(0, 256, 16):  # 2^20 colours at a time
    colours = np.empty((16, 256, 256, 3), np.uint8)
    colours[..., 0] = values[red:red + 16, None, None]
    colours[..., 1] = values[:, None]
    colours[..., 2] = values
    colours = colours.reshape(1024, 1024, 3)
    np.testing.assert_array_equal(
        capture.rgb_to_gray(colours),
        cv2.cvtColor(colours, cv2.COLOR_RGB2GRAY))


@pytest.mark.parametrize('shape', [(48, 64, 3), (1, 1, 3), (5, 1, 3),
                                   (1, 5, 3), (2, 3), (5, 7, 4), (17, 9, 3),
                                   (272, 480, 3), (2000, 3, 3), (100, 100)])
@pytest.mark.parametrize('dtype', [np.uint8, np.uint16])
def test_png_bytes_equal_cv2(shape, dtype):
  rng = np.random.RandomState(len(shape) + shape[0])
  noise = (rng.uniform(size=shape) * np.iinfo(dtype).max).astype(dtype)
  for image in (noise, np.zeros_like(noise)):
    bgr = image.copy()
    if image.ndim == 3:
      bgr[..., :3] = image[..., 2::-1]
    ok, want = cv2.imencode('.png', bgr)
    assert ok
    assert image_utils.encode_png(image) == want.tobytes()
    np.testing.assert_array_equal(
        image_utils.decode_png(image_utils.encode_png(image)), image)


def _frames():
  rng = np.random.RandomState(4)
  sharp = rng.uniform(size=(48, 64, 3)).astype(np.float32)
  blurry = cv2.GaussianBlur(sharp, (11, 11), 5.0)
  slight = cv2.GaussianBlur(sharp, (3, 3), 0.8)
  frames = [sharp, blurry, slight]
  return frames + [jax_image_utils.image_to_uint8(f) for f in frames]


def test_blur_scores_equal_jax():
  frames = _frames()
  got = capture.compute_blur_scores(frames)
  want = jax_capture.compute_blur_scores(frames)
  np.testing.assert_array_equal(got, want)
  assert got[0] > got[2] > got[1]
  for keep in (50.0, 95.0, 100.0):
    np.testing.assert_array_equal(
        capture.select_sharp_frames(got, keep),
        jax_capture.select_sharp_frames(want, keep))


# ----------------------------------------------------- the geometry helpers

def _orbit(cameras_mod, n=6, size=(64, 48)):
  return [cameras_mod.make_orbit_camera(t, image_size=size)
          for t in np.linspace(0, 2 * np.pi, n, endpoint=False)]


def _assert_cameras_equal(got, want):
  assert len(got) == len(want)
  for a, b in zip(got, want):
    assert a.to_json() == b.to_json()


def test_geometry_helpers_equal_jax():
  rng = np.random.RandomState(1)
  points = rng.uniform(-0.5, 0.5, (500, 3))
  points[0] = [100.0, 0.0, 0.0]
  np.testing.assert_array_equal(
      capture.filter_outlier_points(points, 0.95),
      jax_capture.filter_outlier_points(points, 0.95))
  port_cams, jax_cams = _orbit(synthetic), _orbit(jax_synthetic)
  assert (capture.estimate_near_far(port_cams, points)
          == jax_capture.estimate_near_far(jax_cams, points))
  positions = np.stack([c.position for c in port_cams])
  for got, want in zip(capture.compute_scene_center_scale(points, positions),
                       jax_capture.compute_scene_center_scale(points,
                                                              positions)):
    np.testing.assert_array_equal(got, want)
  origins, directions = rng.randn(8, 3), rng.randn(8, 3)
  np.testing.assert_array_equal(
      capture.triangulate_rays(origins, directions),
      jax_capture.triangulate_rays(origins, directions))
  for z in (-0.1, -0.3):
    _assert_cameras_equal(
        capture.generate_orbit_cameras(port_cams, num_frames=5, z_offset=z),
        jax_capture.generate_orbit_cameras(jax_cams, num_frames=5,
                                           z_offset=z))


def test_landmark_normalization_equals_jax():
  pts = _face_landmark_points(np.random.RandomState(4))
  port_cams = [synthetic.make_orbit_camera(t, image_size=(128, 96))
               for t in (0.2, 0.9, 1.6, 2.4)]
  jax_cams = [jax_synthetic.make_orbit_camera(t, image_size=(128, 96))
              for t in (0.2, 0.9, 1.6, 2.4)]
  landmarks = [np.asarray(c.project(pts)) for c in jax_cams]
  got = capture.landmark_scene_normalization(landmarks, port_cams)
  want = jax_capture.landmark_scene_normalization(landmarks, jax_cams)
  for a, b in zip(got, want):
    np.testing.assert_allclose(a, b, rtol=1e-12, atol=0)
  basis, origin, scale = got
  assert (capture.transform_camera(port_cams[0], basis, origin,
                                   scale).to_json()
          == jax_capture.transform_camera(jax_cams[0], basis, origin,
                                          scale).to_json())
  np.testing.assert_array_equal(
      capture.transform_points(pts, basis, origin, scale),
      jax_capture.transform_points(pts, basis, origin, scale))


def test_face_landmarks_without_mediapipe_raise(monkeypatch):
  monkeypatch.setitem(sys.modules, 'mediapipe', None)
  with pytest.raises(ImportError, match='mediapipe'):
    capture.compute_face_landmarks(np.zeros((8, 8, 3), np.uint8))


# ------------------------------------------------------ process_capture


def _assert_datasets_equal(got_dir, want_dir):
  """Two dataset directories, file by file: the same files; PNG bytes
  equal; points.npy equal; JSON equal to rtol 1e-12."""
  files = sorted(p.relative_to(want_dir) for p in want_dir.rglob('*')
                 if p.is_file())
  assert files == sorted(p.relative_to(got_dir) for p in got_dir.rglob('*')
                         if p.is_file())
  assert any(f.parts[0] == 'camera-paths' for f in files)
  for rel in files:
    got, want = got_dir / rel, want_dir / rel
    if rel.suffix == '.png':
      assert got.read_bytes() == want.read_bytes(), rel
    elif rel.suffix == '.npy':
      np.testing.assert_array_equal(np.load(got), np.load(want))
    else:
      _assert_json_close(json.loads(got.read_text()),
                         json.loads(want.read_text()), str(rel))


def _assert_json_close(got, want, where):
  if isinstance(want, dict):
    assert set(got) == set(want), where
    for key in want:
      _assert_json_close(got[key], want[key], f'{where}/{key}')
  elif isinstance(want, list):
    assert len(got) == len(want), where
    for a, b in zip(got, want):
      _assert_json_close(a, b, where)
  elif isinstance(want, float):
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0,
                               err_msg=where)
  else:
    assert got == want, where


def _capture_inputs(tmp_path, builder):
  """The COLMAP fixture (built with `builder`'s colmap) and its frames."""
  colmap_dir = tmp_path / f'colmap_{builder}'
  colmap_dir.mkdir()
  if builder == 'port':
    mgr, _ = make_colmap_scene(colmap_dir, colmap, synthetic)
  else:
    mgr, _ = make_colmap_scene(colmap_dir, jax_colmap, jax_synthetic)
  cameras = jax_capture.load_colmap_cameras(
      jax_colmap.SceneManager(colmap_dir).load())
  images = {name: jax_synthetic.render_sphere_image(cam)
            for name, cam in cameras.items()}
  return colmap_dir, images, cameras


@pytest.mark.parametrize('builder', ['port', 'jax'])
@pytest.mark.parametrize('keep', [100.0, 95.0])
@pytest.mark.parametrize('face', [False, True])
def test_process_capture_writes_the_jax_dataset(tmp_path, builder, keep,
                                                face):
  colmap_dir, images, cameras = _capture_inputs(tmp_path, builder)
  landmarks = None
  if face:
    pts = _face_landmark_points(np.random.RandomState(6))
    landmarks = {name: np.asarray(cam.project(pts))
                 for name, cam in cameras.items()}
  kwargs = dict(val_fraction=0.34, blur_keep_percentile=keep,
                image_scales=(1, 2), min_track_len=2, orbit_frames=4,
                face_landmarks=landmarks)
  want = jax_capture.process_capture(colmap_dir, images, tmp_path / 'jax',
                                     **kwargs)
  got = capture.process_capture(colmap_dir, images, tmp_path / 'port',
                                **kwargs)
  _assert_datasets_equal(got, want)
  source = datasets.from_config({'type': 'nerfies', 'data_dir': str(got)},
                                image_scale=1, use_warp_id=True)
  assert len(source.train_ids) + len(source.val_ids) == (6 if keep == 100.0
                                                         else 5)
  assert source.get_item(source.train_ids[0])['rgb'].shape == (48, 64, 3)
  assert len(source.load_test_cameras()) == 4
  assert 0 < source.near < source.far


def test_process_capture_cli_writes_the_jax_dataset(tmp_path):
  colmap_dir, images, _ = _capture_inputs(tmp_path, 'port')
  frames = tmp_path / 'frames'
  frames.mkdir()
  for name, image in images.items():
    image_utils.save_image(frames / f'{name}.png',
                           image_utils.image_to_uint8(image))
  got = process_capture.main(['--colmap_dir', str(colmap_dir),
                              '--images_dir', str(frames),
                              '--output_dir', str(tmp_path / 'port'),
                              '--orbit_frames', '5'])
  # The JAX CLI's defaults: val 0.2, blur keep 95, scales 1/2/4/8.
  jax_frames = {p.stem: jax_image_utils.load_image(p)
                for p in sorted(frames.iterdir())}
  want = jax_capture.process_capture(colmap_dir, jax_frames,
                                     tmp_path / 'jax', val_fraction=0.2,
                                     blur_keep_percentile=95.0,
                                     orbit_frames=5)
  _assert_datasets_equal(got, want)
  assert (got / 'rgb' / '8x').is_dir()


# ------------------------------------------------------------ video


def _fake_ffmpeg(tmp_path, frames_dir=None, num_frames=3):
  """An executable that logs its argv and writes PNG frames: copies of
  the PNGs in `frames_dir` in order, or `num_frames` tiny ones."""
  if frames_dir is None:
    frames_dir = tmp_path / 'pixel'
    frames_dir.mkdir()
    for i in range(num_frames):
      image_utils.save_image(frames_dir / f'{i:04d}.png',
                             np.zeros((4, 4, 3), np.uint8))
  script = tmp_path / 'ffmpeg'
  script.write_text(
      '#!/bin/bash\n'
      f'echo "$@" > {tmp_path}/ffmpeg_args.txt\n'
      'out="${@: -1}"\n'
      'i=1\n'
      f'for f in {frames_dir}/*.png; do\n'
      '  cp "$f" "$(printf "$out" $i)"; i=$((i+1))\n'
      'done\n')
  script.chmod(script.stat().st_mode | stat.S_IEXEC)
  return script


def _fake_ffprobe(tmp_path, stream):
  script = tmp_path / 'ffprobe'
  script.write_text('#!/bin/bash\n'
                    f'echo "$@" > {tmp_path}/ffprobe_args.txt\n'
                    f"echo '{json.dumps({'streams': [stream]})}'\n")
  script.chmod(script.stat().st_mode | stat.S_IEXEC)
  return script


def test_fps_and_filters_equal_jax():
  for args in ((30.0, 300, 100), (30.0, 1000, 10), (29.97, 451, 100)):
    assert (video.compute_extraction_fps(*args)
            == jax_video.compute_extraction_fps(*args))
  with pytest.raises(ValueError):
    video.compute_extraction_fps(30.0, 50, 100)
  for scale in (1.0, 0.5):
    assert (video.extraction_filters(scale)
            == jax_video.extraction_filters(scale))


def test_extract_frames_with_fake_ffmpeg(tmp_path):
  ffmpeg = _fake_ffmpeg(tmp_path)
  out_dir = tmp_path / 'frames'
  frames = video.extract_frames('capture.mp4', out_dir, fps=5,
                                ffmpeg_binary=str(ffmpeg))
  assert [f.name for f in frames] == ['000001.png', '000002.png',
                                      '000003.png']
  args = (tmp_path / 'ffmpeg_args.txt').read_text().split()
  assert args[args.index('-r') + 1] == '5'
  assert 'mpdecimate' in args[args.index('-vf') + 1]
  with pytest.raises(FileExistsError):
    video.extract_frames('capture.mp4', out_dir, fps=5,
                         ffmpeg_binary=str(ffmpeg))
  assert len(video.extract_frames('capture.mp4', out_dir, fps=5,
                                  ffmpeg_binary=str(ffmpeg),
                                  overwrite=True)) == 3


@pytest.mark.parametrize('stream, frames', [
    ({'avg_frame_rate': '30000/1001', 'nb_frames': '451', 'width': 1920,
      'height': 1080}, 451),
    ({'avg_frame_rate': '30/1', 'duration': '10.0', 'width': 640,
      'height': 480}, 300)])
def test_probe_and_auto_fps_with_fake_ffprobe(tmp_path, stream, frames):
  ffprobe = _fake_ffprobe(tmp_path, stream)
  info = video.probe_video('clip.mp4', ffprobe_binary=str(ffprobe))
  assert info.num_frames == frames
  assert (info.width, info.height) == (stream['width'], stream['height'])
  np.testing.assert_allclose(info.fps, eval(stream['avg_frame_rate']))
  video.extract_frames('clip.mp4', tmp_path / 'frames', fps=-1,
                       target_num_frames=100,
                       ffmpeg_binary=str(_fake_ffmpeg(tmp_path)),
                       ffprobe_binary=str(ffprobe))
  args = (tmp_path / 'ffmpeg_args.txt').read_text().split()
  assert args[args.index('-r') + 1] == str(
      jax_video.compute_extraction_fps(info.fps, frames, 100))


def _fake_colmap(tmp_path, model_dir):
  """An executable that logs each stage and, as the mapper, copies a
  prepared model into <output_path>/0."""
  script = tmp_path / 'colmap'
  script.write_text(
      '#!/bin/bash\n'
      f'echo "$1" >> {tmp_path}/stages.txt\n'
      'if [ "$1" = mapper ]; then\n'
      '  while [ $# -gt 1 ]; do\n'
      '    if [ "$1" = --output_path ]; then out="$2"; fi; shift\n'
      '  done\n'
      f'  mkdir -p "$out/0" && cp {model_dir}/* "$out/0/"\n'
      'fi\n')
  script.chmod(script.stat().st_mode | stat.S_IEXEC)
  return script


def test_process_video_with_fake_binaries(tmp_path, monkeypatch):
  """Video -> frames -> COLMAP -> dataset with fake ffmpeg and colmap,
  against JAX's process_capture on the same frames and model."""
  colmap_dir = tmp_path / 'model'
  colmap_dir.mkdir()
  mgr, _ = make_colmap_scene(colmap_dir, colmap, synthetic)
  # The frames ffmpeg writes are named 000001.png..., so is the model's.
  for image in mgr.images.values():
    image.name = f'{image.image_id:06d}.png'
  mgr.save(colmap_dir)
  rendered = tmp_path / 'rendered'
  rendered.mkdir()
  for name, cam in capture.load_colmap_cameras(mgr).items():
    image_utils.save_image(rendered / f'{name}.png', image_utils.image_to_uint8(
        synthetic.render_sphere_image(cam)))
  binaries = ['--fps', '5',
              '--ffmpeg_binary', str(_fake_ffmpeg(tmp_path, rendered)),
              '--colmap_binary', str(_fake_colmap(tmp_path, colmap_dir))]
  got = process_video.main(['--video', 'capture.mp4', '--workspace',
                            str(tmp_path / 'work'), '--output_dir',
                            str(tmp_path / 'port'), *binaries])
  assert (tmp_path / 'stages.txt').read_text().split() == [
      'feature_extractor', 'exhaustive_matcher', 'mapper']
  frames = sorted((tmp_path / 'work' / 'rgb-raw').glob('*.png'))
  assert len(frames) == 6
  want = jax_capture.process_capture(
      tmp_path / 'work' / 'colmap' / 'sparse' / '0',
      {p.stem: jax_image_utils.load_image(p) for p in frames},
      tmp_path / 'jax', val_fraction=0.2, blur_keep_percentile=95.0)
  _assert_datasets_equal(got, want)
  monkeypatch.setitem(sys.modules, 'mediapipe', None)
  with pytest.raises(ImportError, match='mediapipe'):
    process_video.main(['--video', 'capture.mp4', '--workspace',
                        str(tmp_path / 'face'), '--output_dir',
                        str(tmp_path / 'face_out'), *binaries, '--use_face'])
