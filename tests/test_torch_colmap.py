"""The port's colmap/ against the JAX package's.

The cases of tests/test_colmap.py, run through nerfies_tpu_torch.colmap;
then a model written by either package's SceneManager.save (binary and
text) loads in the other and saves to the same bytes, the database's
tables hold the same rows, and the runner builds the same argument lists.
"""

import numpy as np
import pytest

from nerfies_tpu import colmap as jax_colmap
from nerfies_tpu.colmap import runner as jax_runner
from nerfies_tpu.datasets import synthetic as jax_synthetic
from nerfies_tpu_torch import colmap
from nerfies_tpu_torch.colmap import camera as colmap_camera
from nerfies_tpu_torch.colmap import COLMAPDatabase
from nerfies_tpu_torch.colmap import ColmapCamera
from nerfies_tpu_torch.colmap import Image
from nerfies_tpu_torch.colmap import Quaternion
from nerfies_tpu_torch.colmap import SceneManager
from nerfies_tpu_torch.colmap import runner as port_runner
from nerfies_tpu_torch.colmap.rotation import DualQuaternion
from nerfies_tpu_torch.datasets import synthetic


def make_colmap_scene(path, colmap_pkg, synthetic_mod, num_frames=6,
                      image_size=(64, 48)):
  """tests/test_capture.py's COLMAP reconstruction of cameras orbiting the
  origin, built with `colmap_pkg` (either package's colmap) and saved in
  binary under `path`."""
  mgr = colmap_pkg.SceneManager(path)
  mgr.cameras[1] = colmap_pkg.ColmapCamera(
      1, 'OPENCV', image_size[0], image_size[1],
      [60.0, 60.0, image_size[0] / 2, image_size[1] / 2, 0, 0, 0, 0])
  rng = np.random.RandomState(0)
  points = rng.uniform(-0.5, 0.5, (200, 3))
  for i in range(num_frames):
    theta = 2 * np.pi * i / num_frames
    cam = synthetic_mod.make_orbit_camera(theta, image_size=image_size)
    q = colmap_pkg.Quaternion.from_rotation_matrix(cam.orientation)
    t = -cam.orientation @ cam.position
    mgr.images[i + 1] = colmap_pkg.Image(
        i + 1, f'{i:04d}.png', 1, q.q, t,
        points2D=rng.uniform(0, 64, (4, 2)),
        point3D_ids=np.asarray([1, 2, 3, 4], np.int64))
  mgr.name_to_image_id = {im.name: i for i, im in mgr.images.items()}
  ids = list(range(1, 201))
  tracks = [[(1 + (j % num_frames), 0), (1 + ((j + 1) % num_frames), 1)]
            for j in range(200)]
  mgr._set_points(ids, points, rng.randint(0, 255, (200, 3)),
                  rng.uniform(0, 1, 200), tracks)
  mgr.save(path)
  return mgr, points


def _build_scene():
  mgr = SceneManager('/nonexistent')
  mgr.cameras[1] = ColmapCamera(
      1, 'OPENCV', 640, 480,
      [520.0, 525.0, 320.0, 240.0, 0.02, -0.005, 0.001, -0.0005])
  mgr.cameras[2] = ColmapCamera(2, 'SIMPLE_PINHOLE', 320, 240,
                                [260.0, 160.0, 120.0])
  rng = np.random.RandomState(0)
  for image_id in (1, 2, 3):
    q = rng.randn(4)
    q /= np.linalg.norm(q)
    points2D = rng.uniform(0, 640, (5, 2))
    point_ids = np.asarray([1, 2, -1, 3, -1], np.int64)
    mgr.images[image_id] = Image(
        image_id, f'frame_{image_id:04d}.png', 1 + image_id % 2, q,
        rng.randn(3), points2D, point_ids)
  mgr.name_to_image_id = {im.name: i for i, im in mgr.images.items()}
  ids = [1, 2, 3]
  mgr._set_points(
      ids, rng.randn(3, 3), rng.randint(0, 255, (3, 3)),
      rng.uniform(0, 2, 3),
      [[(1, 0), (2, 1)], [(1, 1)], [(1, 3), (2, 0), (3, 2)]])
  mgr.point3D_id_to_point3D_idx = {pid: i for i, pid in enumerate(ids)}
  return mgr


def _assert_scenes_equal(a, b):
  assert set(a.cameras) == set(b.cameras)
  for cid in a.cameras:
    np.testing.assert_allclose(a.cameras[cid].params, b.cameras[cid].params)
    assert a.cameras[cid].model_name == b.cameras[cid].model_name
    assert (a.cameras[cid].width, a.cameras[cid].height) == \
        (b.cameras[cid].width, b.cameras[cid].height)
  assert set(a.images) == set(b.images)
  for iid in a.images:
    np.testing.assert_allclose(a.images[iid].qvec, b.images[iid].qvec,
                               atol=1e-12)
    np.testing.assert_allclose(a.images[iid].tvec, b.images[iid].tvec,
                               atol=1e-12)
    np.testing.assert_allclose(a.images[iid].points2D,
                               b.images[iid].points2D, atol=1e-9)
    np.testing.assert_array_equal(a.images[iid].point3D_ids,
                                  b.images[iid].point3D_ids)
    assert a.images[iid].name == b.images[iid].name
  np.testing.assert_allclose(a.points3D, b.points3D, atol=1e-12)
  np.testing.assert_array_equal(a.point3D_colors, b.point3D_colors)
  assert a.point3D_tracks == b.point3D_tracks


@pytest.mark.parametrize('binary', [True, False])
def test_scene_roundtrip(tmp_path, binary):
  scene = _build_scene()
  scene.save(tmp_path, binary=binary)
  loaded = SceneManager(tmp_path).load()
  _assert_scenes_equal(scene, loaded)


def test_point_filtering():
  scene = _build_scene()
  pts = scene.get_filtered_points3D(min_track_len=2)
  assert pts.shape == (2, 3)
  scene.filter_points3D(min_track_len=3)
  assert scene.points3D.shape == (1, 3)
  assert len(scene.point3D_tracks) == 1


def test_camera_model_projection_roundtrip():
  cam = ColmapCamera(
      1, 'OPENCV', 640, 480,
      [520.0, 525.0, 320.0, 240.0, 0.02, -0.005, 0.001, -0.0005])
  rng = np.random.RandomState(1)
  points = np.concatenate(
      [rng.uniform(-0.5, 0.5, (32, 2)), rng.uniform(1.0, 3.0, (32, 1))], -1)
  pixels = cam.world_to_image(points)
  xy = cam.image_to_normalized(pixels)
  np.testing.assert_allclose(xy, points[:, :2] / points[:, 2:], atol=1e-6)


def test_camera_model_params_validation():
  with pytest.raises(ValueError):
    ColmapCamera(1, 'OPENCV', 640, 480, [1.0, 2.0])
  cam = ColmapCamera(1, 'SIMPLE_RADIAL', 64, 48, [50.0, 32.0, 24.0, 0.1])
  assert cam.focal == (50.0, 50.0)
  assert cam.principal_point == (32.0, 24.0)


def test_image_pose():
  q = Quaternion.from_axis_angle([0, 0, 1], np.pi / 2)
  image = Image(1, 'a.png', 1, q.q, [1.0, 0.0, 0.0])
  R = image.R()
  np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-12)
  # C = -R^T t
  np.testing.assert_allclose(image.C(), -R.T @ [1.0, 0.0, 0.0], atol=1e-12)


def test_quaternion_rotation_matrix_roundtrip():
  rng = np.random.RandomState(2)
  for _ in range(10):
    q = rng.randn(4)
    q /= np.linalg.norm(q)
    quat = Quaternion(q)
    R = quat.to_rotation_matrix()
    q_back = Quaternion.from_rotation_matrix(R).q
    sign = np.sign(q_back @ q)
    np.testing.assert_allclose(sign * q_back, q, atol=1e-10)


def test_dual_quaternion_transform():
  q = Quaternion.from_axis_angle([0, 1, 0], 0.7)
  t = np.asarray([0.5, -1.0, 2.0])
  dq = DualQuaternion.from_rt(q, t)
  v = np.asarray([1.0, 2.0, 3.0])
  np.testing.assert_allclose(dq.transform(v), q.rotate(v) + t, atol=1e-10)
  r_back, t_back = dq.to_rt()
  np.testing.assert_allclose(t_back, t, atol=1e-10)


def test_colmap_database(tmp_path):
  db = COLMAPDatabase.connect(tmp_path / 'database.db')
  db.create_tables()
  cam_id = db.add_camera(model=4, width=640, height=480,
                         params=[520, 525, 320, 240, 0, 0, 0, 0])
  img1 = db.add_image('a.png', cam_id)
  img2 = db.add_image('b.png', cam_id)
  img3 = db.add_image('c.png', cam_id)
  rng = np.random.RandomState(3)
  kps = rng.uniform(0, 640, (100, 2)).astype(np.float32)
  db.add_keypoints(img1, kps)
  db.add_descriptors(img1, rng.randint(0, 255, (100, 128)).astype(np.uint8))
  matches = rng.randint(0, 100, (40, 2)).astype(np.uint32)
  db.add_matches(img1, img2, matches)
  db.add_two_view_geometry(img1, img2, matches)
  db.commit()

  model, width, height, params = db.get_camera(cam_id)
  assert model == 4 and width == 640 and height == 480
  np.testing.assert_allclose(params[:2], [520, 525])
  np.testing.assert_allclose(db.get_keypoints(img1), kps)
  np.testing.assert_array_equal(db.get_matches(img1, img2), matches)
  # Reversed query flips match columns.
  np.testing.assert_array_equal(db.get_matches(img2, img1),
                                matches[:, ::-1])
  db.close()


def test_runner_arg_builders():
  from nerfies_tpu_torch.colmap import runner
  feat = runner.feature_extractor_args('db.db', 'imgs')
  assert feat[0] == 'feature_extractor'
  assert feat[feat.index('--ImageReader.camera_model') + 1] == 'OPENCV'
  assert feat[feat.index('--ImageReader.single_camera') + 1] == '1'
  assert feat[feat.index('--SiftExtraction.upright') + 1] == '1'

  match = runner.matcher_args('db.db')
  assert match[0] == 'exhaustive_matcher'
  vt = runner.matcher_args('db.db', match_method='vocab_tree',
                           vocab_tree_path='tree.bin')
  assert vt[0] == 'vocab_tree_matcher'
  with pytest.raises(ValueError):
    runner.matcher_args('db.db', match_method='vocab_tree')

  mapper = runner.mapper_args('db.db', 'imgs', 'out')
  assert mapper[0] == 'mapper'
  assert mapper[mapper.index('--Mapper.min_num_matches') + 1] == '32'
  assert mapper[
      mapper.index('--Mapper.ba_refine_principal_point') + 1] == '1'


def test_run_sfm_with_fake_colmap(tmp_path):
  """The three stages run in order and the model dir is returned."""
  import stat
  from nerfies_tpu_torch.colmap import runner

  fake = tmp_path / 'colmap'
  fake.write_text(
      '#!/bin/bash\n'
      f'echo "$1" >> {tmp_path}/stages.txt\n'
      'if [ "$1" = mapper ]; then\n'
      '  while [ $# -gt 1 ]; do\n'
      '    if [ "$1" = --output_path ]; then out="$2"; fi; shift\n'
      '  done\n'
      '  mkdir -p "$out/0" && touch "$out/0/images.bin"\n'
      'fi\n')
  fake.chmod(fake.stat().st_mode | stat.S_IEXEC)

  model_dir = runner.run_sfm(tmp_path / 'imgs', tmp_path / 'work',
                             colmap_binary=str(fake))
  stages = (tmp_path / 'stages.txt').read_text().split()
  assert stages == ['feature_extractor', 'exhaustive_matcher', 'mapper']
  assert model_dir == tmp_path / 'work' / 'sparse' / '0'


def test_run_colmap_surfaces_failure(tmp_path):
  import stat
  from nerfies_tpu_torch.colmap import runner
  fake = tmp_path / 'colmap'
  fake.write_text('#!/bin/bash\necho boom >&2\nexit 3\n')
  fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
  with pytest.raises(RuntimeError, match='boom'):
    runner.run_colmap(['feature_extractor'], colmap_binary=str(fake))


def test_scene_queries(tmp_path):
  """get_points3D / shared / viewed / delete / scene graph round-trip."""
  mgr, points = make_colmap_scene(tmp_path, colmap, synthetic)
  # Every image's observed points come back with their 2D pixels.
  pts, px = mgr.get_points3D(1, return_points2D=True)
  assert pts.shape[1] == 3 and px.shape[1] == 2 and len(pts) == len(px)
  assert mgr.point3D_valid(1) and not mgr.point3D_valid(10**9)
  shared = mgr.get_shared_points3D(1, 2)
  assert shared.shape[1] == 3
  viewed = mgr.get_viewed_points(1)
  assert viewed.shape[1] == 3 and (viewed[:, 2] > 0).all()

  graph = mgr.build_scene_graph()
  # The synthetic tracks link image i with image i+1.
  assert graph[1][2] > 0 and graph[2][1] == graph[1][2]

  num_images = len(mgr.images)
  mgr.delete_images([1])
  assert len(mgr.images) == num_images - 1
  assert all(1 != iid for track in mgr.point3D_tracks
             for iid, _ in track)


def test_project_file_image_path(tmp_path):
  from nerfies_tpu_torch.colmap import SceneManager
  (tmp_path / 'project.ini').write_text(
      '[General]\nimage_path=/data/frames\n')
  mgr = SceneManager(tmp_path)
  assert mgr.load_colmap_project_file() == '/data/frames'


def test_camera_distort_roundtrip_and_grid():
  from nerfies_tpu_torch.colmap import ColmapCamera
  cam = ColmapCamera(1, 'OPENCV', 16, 12,
                     [60, 60, 8, 6, 0.05, -0.01, 0.001, 0.002])
  pixels = np.array([[4.0, 3.0], [12.0, 9.0], [8.0, 6.0]])
  np.testing.assert_allclose(
      cam.undistort_points(cam.distort_points(pixels)), pixels, atol=1e-6)
  grid = cam.get_image_grid()
  assert grid.shape == (12, 16, 2)
  np.testing.assert_allclose(
      cam.get_inverse_camera_matrix() @ cam.get_camera_matrix(),
      np.eye(3), atol=1e-12)
  assert cam.num_params == 8


def test_axis_angle_and_euler():
  from nerfies_tpu_torch.colmap import rotation as rot
  axis = np.array([1.0, 2.0, -1.0]) / np.sqrt(6.0)
  R = rot.axis_angle_to_rotation_matrix(axis, 1.1)
  axis2, angle2 = rot.rotation_matrix_to_axis_angle(R)
  np.testing.assert_allclose(axis2, axis, atol=1e-9)
  assert abs(angle2 - 1.1) < 1e-9
  K = rot.cross_prod_matrix([1.0, 2.0, 3.0])
  np.testing.assert_allclose(K @ np.array([0.5, -1.0, 2.0]),
                             np.cross([1.0, 2.0, 3.0], [0.5, -1.0, 2.0]))
  q = rot.Quaternion.from_rotation_matrix(R)
  roll, pitch, yaw = q.to_euler_angles()
  Rz = rot.axis_angle_to_rotation_matrix([0, 0, 1], yaw)
  Ry = rot.axis_angle_to_rotation_matrix([0, 1, 0], pitch)
  Rx = rot.axis_angle_to_rotation_matrix([1, 0, 0], roll)
  np.testing.assert_allclose(Rz @ Ry @ Rx, R, atol=1e-9)
  pts = np.random.RandomState(0).randn(4, 3)
  np.testing.assert_allclose(q.rotate_points(pts), pts @ R.T, atol=1e-9)


def test_add_inlier_matches(tmp_path):
  from nerfies_tpu_torch.colmap import COLMAPDatabase
  db = COLMAPDatabase.connect(tmp_path / 'db.db')
  db.create_tables()
  db.add_camera('OPENCV', 64, 48, [60, 60, 32, 24, 0, 0, 0, 0],
                camera_id=1)
  db.add_image('a.png', 1, image_id=1)
  db.add_image('b.png', 1, image_id=2)
  matches = np.array([[0, 1], [2, 3]], np.uint32)
  db.add_inlier_matches(1, 2, matches)
  db.commit()
  rows = db.execute('SELECT pair_id, config FROM two_view_geometries')
  (pair_id, config), = rows.fetchall()
  assert config == 2
  db.close()


def test_largest_model_dir_multi_model(tmp_path):
  """COLMAP fragmenting into sparse/0, sparse/1: pick the biggest model."""
  from nerfies_tpu_torch.colmap import runner
  big = _build_scene()  # 3 images
  small = _build_scene().delete_images([2, 3])  # 1 image
  sparse = tmp_path / 'sparse'
  small.save(sparse / '0', binary=True)
  big.save(sparse / '1', binary=True)
  assert runner.largest_model_dir(sparse) == sparse / '1'
  # Single model: returned without loading.
  single = tmp_path / 'single'
  big.save(single / '0', binary=True)
  assert runner.largest_model_dir(single) == single / '0'


# ------------------------------------------------- the two packages' files

def _files(path):
  return {p.name: p.read_bytes() for p in sorted(path.iterdir())}


@pytest.mark.parametrize('binary', [True, False])
@pytest.mark.parametrize('writer', ['jax', 'port'])
def test_models_cross_load_and_resave_to_the_same_bytes(tmp_path, binary,
                                                        writer):
  packages = {'jax': jax_colmap, 'port': colmap}
  reader = 'port' if writer == 'jax' else 'jax'
  scene = _build_scene()
  if writer == 'jax':  # the same scene, built from the JAX classes
    scene = _as_package(scene, jax_colmap)
  scene.save(tmp_path / 'a', binary=binary)
  loaded = packages[reader].SceneManager(tmp_path / 'a').load()
  _assert_scenes_equal(loaded, scene)
  loaded.save(tmp_path / 'b', binary=binary)
  assert _files(tmp_path / 'a') == _files(tmp_path / 'b')


def _as_package(scene, pkg):
  """`scene` rebuilt from the classes of `pkg`."""
  out = pkg.SceneManager(scene.colmap_dir)
  for cid, cam in scene.cameras.items():
    out.cameras[cid] = pkg.ColmapCamera(cid, cam.model_name, cam.width,
                                        cam.height, cam.params)
  for iid, im in scene.images.items():
    out.images[iid] = pkg.Image(iid, im.name, im.camera_id, im.qvec, im.tvec,
                                im.points2D, im.point3D_ids)
  out.name_to_image_id = dict(scene.name_to_image_id)
  out._set_points([int(i) for i in scene.point3D_ids], scene.points3D,
                  scene.point3D_colors, scene.point3D_errors,
                  scene.point3D_tracks)
  return out


def test_capture_fixture_files_equal(tmp_path):
  make_colmap_scene(tmp_path / 'jax', jax_colmap, jax_synthetic)
  make_colmap_scene(tmp_path / 'port', colmap, synthetic)
  assert _files(tmp_path / 'jax') == _files(tmp_path / 'port')


def _fill_database(pkg, path):
  db = pkg.COLMAPDatabase.connect(path)
  db.create_tables()
  cam_id = db.add_camera(model=4, width=640, height=480,
                         params=[520, 525, 320, 240, 0.01, 0, 0, 0])
  img1 = db.add_image('a.png', cam_id, prior_q=(0.5, 0.5, 0.5, 0.5),
                      prior_t=(1.0, 2.0, 3.0))
  img2 = db.add_image('b.png', cam_id)
  img3 = db.add_image('c.png', cam_id)
  rng = np.random.RandomState(3)
  db.add_keypoints(img1, rng.uniform(0, 640, (100, 2)).astype(np.float32))
  db.add_descriptors(img1, rng.randint(0, 255, (100, 128)).astype(np.uint8))
  matches = rng.randint(0, 100, (40, 2)).astype(np.uint32)
  db.add_matches(img2, img1, matches)
  db.add_two_view_geometry(img1, img2, matches, F=rng.randn(3, 3))
  db.add_inlier_matches(img3, img1, matches[:5], config=3)
  db.commit()
  return db


def test_database_tables_equal(tmp_path):
  want = _fill_database(jax_colmap, tmp_path / 'jax.db')
  got = _fill_database(colmap, tmp_path / 'port.db')
  tables = [r[0] for r in want.execute(
      "SELECT name FROM sqlite_master WHERE type IN ('table', 'index') "
      "ORDER BY name")]
  assert tables == [r[0] for r in got.execute(
      "SELECT name FROM sqlite_master WHERE type IN ('table', 'index') "
      "ORDER BY name")]
  for table in ('cameras', 'images', 'keypoints', 'descriptors', 'matches',
                'two_view_geometries'):
    query = f'SELECT * FROM {table} ORDER BY 1'
    assert got.execute(query).fetchall() == want.execute(query).fetchall()
  np.testing.assert_array_equal(got.get_matches(1, 2),
                                want.get_matches(1, 2))
  # Each package reads the other's file.
  other = colmap.COLMAPDatabase.connect(tmp_path / 'jax.db')
  np.testing.assert_array_equal(other.get_keypoints(1), want.get_keypoints(1))
  for db in (want, got, other):
    db.close()


def test_runner_argument_lists_equal():
  for kwargs in ({}, {'share_intrinsics': False, 'camera_model': 'PINHOLE',
                      'use_gpu': True}):
    assert (port_runner.feature_extractor_args('db', 'imgs', **kwargs)
            == jax_runner.feature_extractor_args('db', 'imgs', **kwargs))
  for kwargs in ({}, {'match_method': 'vocab_tree',
                      'vocab_tree_path': 'tree.bin', 'use_gpu': True}):
    assert (port_runner.matcher_args('db', **kwargs)
            == jax_runner.matcher_args('db', **kwargs))
  for kwargs in ({}, {'refine_principal_point': False, 'min_num_matches': 8,
                      'filter_max_reproj_error': 4.0}):
    assert (port_runner.mapper_args('db', 'imgs', 'out', **kwargs)
            == jax_runner.mapper_args('db', 'imgs', 'out', **kwargs))
