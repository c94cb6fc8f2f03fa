"""COLMAP sqlite database: schema + array blob codecs.

Implements the public COLMAP database schema
(colmap/src/colmap/scene/database.cc); the port's copy of
nerfies_tpu/colmap/database.py.
"""

import sqlite3

import numpy as np

MAX_IMAGE_ID = 2 ** 31 - 1

CREATE_CAMERAS_TABLE = """CREATE TABLE IF NOT EXISTS cameras (
    camera_id INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,
    model INTEGER NOT NULL,
    width INTEGER NOT NULL,
    height INTEGER NOT NULL,
    params BLOB,
    prior_focal_length INTEGER NOT NULL)"""

CREATE_IMAGES_TABLE = f"""CREATE TABLE IF NOT EXISTS images (
    image_id INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,
    name TEXT NOT NULL UNIQUE,
    camera_id INTEGER NOT NULL,
    prior_qw REAL, prior_qx REAL, prior_qy REAL, prior_qz REAL,
    prior_tx REAL, prior_ty REAL, prior_tz REAL,
    CONSTRAINT image_id_check CHECK(image_id >= 0 and
                                    image_id < {MAX_IMAGE_ID}),
    FOREIGN KEY(camera_id) REFERENCES cameras(camera_id))"""

CREATE_KEYPOINTS_TABLE = """CREATE TABLE IF NOT EXISTS keypoints (
    image_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL,
    cols INTEGER NOT NULL,
    data BLOB,
    FOREIGN KEY(image_id) REFERENCES images(image_id) ON DELETE CASCADE)"""

CREATE_DESCRIPTORS_TABLE = """CREATE TABLE IF NOT EXISTS descriptors (
    image_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL,
    cols INTEGER NOT NULL,
    data BLOB,
    FOREIGN KEY(image_id) REFERENCES images(image_id) ON DELETE CASCADE)"""

CREATE_MATCHES_TABLE = """CREATE TABLE IF NOT EXISTS matches (
    pair_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL,
    cols INTEGER NOT NULL,
    data BLOB)"""

CREATE_TWO_VIEW_GEOMETRIES_TABLE = """CREATE TABLE IF NOT EXISTS
two_view_geometries (
    pair_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL,
    cols INTEGER NOT NULL,
    data BLOB,
    config INTEGER NOT NULL,
    F BLOB, E BLOB, H BLOB)"""

CREATE_NAME_INDEX = (
    'CREATE UNIQUE INDEX IF NOT EXISTS index_name ON images(name)')

CREATE_ALL = '; '.join([
    CREATE_CAMERAS_TABLE, CREATE_IMAGES_TABLE, CREATE_KEYPOINTS_TABLE,
    CREATE_DESCRIPTORS_TABLE, CREATE_MATCHES_TABLE,
    CREATE_TWO_VIEW_GEOMETRIES_TABLE, CREATE_NAME_INDEX,
])


def image_ids_to_pair_id(image_id1: int, image_id2: int) -> int:
  if image_id1 > image_id2:
    image_id1, image_id2 = image_id2, image_id1
  return image_id1 * MAX_IMAGE_ID + image_id2


def pair_id_to_image_ids(pair_id: int):
  image_id2 = pair_id % MAX_IMAGE_ID
  image_id1 = (pair_id - image_id2) // MAX_IMAGE_ID
  return image_id1, image_id2


def array_to_blob(array: np.ndarray) -> bytes:
  return np.ascontiguousarray(array).tobytes()


def blob_to_array(blob, dtype, shape=(-1,)) -> np.ndarray:
  if blob is None:
    return np.zeros(shape, dtype)
  return np.frombuffer(blob, dtype).reshape(*shape)


class COLMAPDatabase(sqlite3.Connection):
  """sqlite3 connection with COLMAP schema helpers."""

  @staticmethod
  def connect(database_path) -> 'COLMAPDatabase':
    return sqlite3.connect(str(database_path), factory=COLMAPDatabase)

  def __init__(self, *args, **kwargs):
    super().__init__(*args, **kwargs)
    self.create_tables = lambda: self.executescript(CREATE_ALL)

  def add_camera(self, model, width, height, params,
                 prior_focal_length=False, camera_id=None) -> int:
    params = np.asarray(params, np.float64)
    cursor = self.execute(
        'INSERT INTO cameras VALUES (?, ?, ?, ?, ?, ?)',
        (camera_id, model, width, height, array_to_blob(params),
         prior_focal_length))
    return cursor.lastrowid

  def add_image(self, name, camera_id, prior_q=(1, 0, 0, 0),
                prior_t=(0, 0, 0), image_id=None) -> int:
    cursor = self.execute(
        'INSERT INTO images VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?, ?)',
        (image_id, name, camera_id, *prior_q, *prior_t))
    return cursor.lastrowid

  def add_keypoints(self, image_id, keypoints: np.ndarray):
    assert len(keypoints.shape) == 2
    assert keypoints.shape[1] in (2, 4, 6)
    keypoints = np.asarray(keypoints, np.float32)
    self.execute('INSERT INTO keypoints VALUES (?, ?, ?, ?)',
                 (image_id,) + keypoints.shape + (array_to_blob(keypoints),))

  def add_descriptors(self, image_id, descriptors: np.ndarray):
    descriptors = np.ascontiguousarray(descriptors, np.uint8)
    self.execute(
        'INSERT INTO descriptors VALUES (?, ?, ?, ?)',
        (image_id,) + descriptors.shape + (array_to_blob(descriptors),))

  def add_matches(self, image_id1, image_id2, matches: np.ndarray):
    assert len(matches.shape) == 2 and matches.shape[1] == 2
    if image_id1 > image_id2:
      matches = matches[:, ::-1]
    pair_id = image_ids_to_pair_id(image_id1, image_id2)
    matches = np.asarray(matches, np.uint32)
    self.execute('INSERT INTO matches VALUES (?, ?, ?, ?)',
                 (pair_id,) + matches.shape + (array_to_blob(matches),))

  def add_two_view_geometry(self, image_id1, image_id2, matches: np.ndarray,
                            F=np.eye(3), E=np.eye(3), H=np.eye(3),
                            config=2):
    assert len(matches.shape) == 2 and matches.shape[1] == 2
    if image_id1 > image_id2:
      matches = matches[:, ::-1]
    pair_id = image_ids_to_pair_id(image_id1, image_id2)
    matches = np.asarray(matches, np.uint32)
    F = np.asarray(F, np.float64)
    E = np.asarray(E, np.float64)
    H = np.asarray(H, np.float64)
    self.execute(
        'INSERT INTO two_view_geometries VALUES (?, ?, ?, ?, ?, ?, ?, ?)',
        (pair_id,) + matches.shape + (array_to_blob(matches), config,
                                      array_to_blob(F), array_to_blob(E),
                                      array_to_blob(H)))

  # --- readers ---

  def add_inlier_matches(self, image_id1, image_id2, matches,
                         config: int = 2, F=None, E=None, H=None):
    """Verified (inlier) matches: two-view geometry + config code."""
    kwargs = {k: v for k, v in (('F', F), ('E', E), ('H', H))
              if v is not None}
    return self.add_two_view_geometry(image_id1, image_id2, matches,
                                      config=config, **kwargs)

  def get_camera(self, camera_id):
    row = self.execute(
        'SELECT model, width, height, params FROM cameras '
        'WHERE camera_id = ?', (camera_id,)).fetchone()
    model, width, height, params = row
    return model, width, height, blob_to_array(params, np.float64)

  def get_keypoints(self, image_id) -> np.ndarray:
    row = self.execute(
        'SELECT rows, cols, data FROM keypoints WHERE image_id = ?',
        (image_id,)).fetchone()
    rows, cols, data = row
    return blob_to_array(data, np.float32, (rows, cols))

  def get_matches(self, image_id1, image_id2) -> np.ndarray:
    pair_id = image_ids_to_pair_id(image_id1, image_id2)
    row = self.execute(
        'SELECT rows, cols, data FROM matches WHERE pair_id = ?',
        (pair_id,)).fetchone()
    if row is None:
      return np.zeros((0, 2), np.uint32)
    rows, cols, data = row
    matches = blob_to_array(data, np.uint32, (rows, cols))
    if image_id1 > image_id2:
      matches = matches[:, ::-1]
    return matches
