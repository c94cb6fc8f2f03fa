"""Core data pipeline: preloaded ray pools and host-side batch iterators.

Port of nerfies_tpu/datasets/core.py, numpy on the host; the batches stay
numpy and the train step moves them to the device.

  - Images and cameras load in a thread pool; rays are generated once with
    the vectorized numpy camera and stored FLAT, but deduplicated: per-ray
    arrays hold only directions, pixels and rgb; per-image constants
    (origin, metadata ids, time) live in small per-image tables indexed by
    a per-ray `image_idx` and are gathered at batch assembly. RGB is
    stored as uint8 and converted per batch.
  - Batches are drawn by a per-epoch permutation of the whole pool,
    seeded, so a run that starts again from the seed draws the same
    batches; the streaming pool shuffles within windows of images.
  - A background thread keeps a small queue of assembled batches, so
    batch assembly overlaps the device step.

The process index and count are 0 and 1: the port runs on one card.
"""

import abc
import functools
import itertools
import queue as queue_lib
import shutil
import tempfile
import threading
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from nerfies_tpu_torch import camera as cam
from nerfies_tpu_torch import image_utils
from nerfies_tpu_torch import utils
from nerfies_tpu_torch.parallel import mesh


def _tree_leaves(tree) -> List[Any]:
  """The array leaves of nested dicts, in key order."""
  if isinstance(tree, dict):
    return [leaf for k in sorted(tree) for leaf in _tree_leaves(tree[k])]
  return [tree]


def _tree_map(fn, tree):
  """fn over the array leaves of nested dicts."""
  if isinstance(tree, dict):
    return {k: _tree_map(fn, v) for k, v in tree.items()}
  return fn(tree)


def camera_to_rays(camera: cam.Camera) -> Dict[str, np.ndarray]:
  """Generates the full ray bundle for a camera.

  Returns:
    {'origins' (H,W,3), 'directions' (H,W,3), 'pixels' (H,W,2)} float32.
  """
  image_shape = camera.image_shape
  pixels = camera.get_pixel_centers()
  directions = camera.pixels_to_rays(pixels)
  origins = np.broadcast_to(camera.position[None, None, :],
                            image_shape + (3,))
  return {
      'origins': origins.astype(np.float32),
      'directions': directions.astype(np.float32),
      'pixels': pixels.astype(np.float32),
  }


def load_camera(camera_path, scale_factor=1.0, scene_center=None,
                scene_scale=None) -> cam.Camera:
  """Loads a camera JSON, rescaled and re-centered into scene coordinates."""
  if str(camera_path).endswith('.json'):
    camera = cam.Camera.from_json(camera_path)
  else:
    raise ValueError('File must have extension .json.')
  if scale_factor != 1.0:
    camera = camera.scale(scale_factor)
  if scene_center is not None:
    camera.position = camera.position - scene_center
  if scene_scale is not None:
    camera.position = camera.position * scene_scale
  return camera


class RayPool:
  """A flat, deduplicated pool of training rays in host memory.

  Per-ray arrays:
    directions: (N, 3) float32
    pixels:     (N, 2) float32 (optional)
    rgb:        (N, 3) uint8
    image_idx:  (N,)   int32
  Per-image tables:
    origins:    (M, 3) float32
    metadata:   {key: (M, 1)} uint32 / float32
  """

  def __init__(self, directions, rgb, image_idx, origins, metadata,
               pixels=None):
    self.directions = directions
    self.rgb = rgb
    self.image_idx = image_idx
    self.origins = origins
    self.metadata = metadata
    self.pixels = pixels

  @classmethod
  def from_items(cls, items: List[Dict[str, Any]],
                 include_pixels: bool = False) -> 'RayPool':
    """Builds a pool from per-image item dicts (see DataSource.get_item)."""
    directions_list, rgb_list, pixels_list = [], [], []
    origins = np.zeros((len(items), 3), np.float32)
    metadata_keys = sorted(items[0].get('metadata', {}).keys())
    metadata = {
        k: np.zeros(
            (len(items), 1),
            np.float32 if k == 'time' else np.uint32)
        for k in metadata_keys
    }
    image_idx_list = []
    for i, item in enumerate(items):
      camera = cam.Camera(**item['camera_params'])
      rays = camera_to_rays(camera)
      directions_list.append(rays['directions'].reshape(-1, 3))
      if include_pixels:
        pixels_list.append(rays['pixels'].reshape(-1, 2))
      rgb = item['rgb']
      if rgb.dtype != np.uint8:
        rgb = image_utils.image_to_uint8(rgb[..., :3])
      rgb_list.append(rgb.reshape(-1, 3))
      origins[i] = camera.position
      for k in metadata_keys:
        metadata[k][i, 0] = item['metadata'][k]
      n = directions_list[-1].shape[0]
      image_idx_list.append(np.full((n,), i, np.int32))

    return cls(
        directions=np.concatenate(directions_list, axis=0),
        rgb=np.concatenate(rgb_list, axis=0),
        image_idx=np.concatenate(image_idx_list, axis=0),
        origins=origins,
        metadata=metadata,
        pixels=(np.concatenate(pixels_list, axis=0)
                if include_pixels else None),
    )

  @property
  def num_rays(self) -> int:
    return self.directions.shape[0]

  def assemble(self, indices: np.ndarray) -> Dict[str, Any]:
    """Gathers a batch dict for the given ray indices."""
    image_idx = self.image_idx[indices]
    batch = {
        'origins': self.origins[image_idx],
        'directions': self.directions[indices],
        'rgb': self.rgb[indices].astype(np.float32) / 255.0,
        'metadata': {k: v[image_idx] for k, v in self.metadata.items()},
    }
    if self.pixels is not None:
      batch['pixels'] = self.pixels[indices]
    return batch


class StreamingRayPool:
  """A disk-backed ray pool: per-ray arrays are memory-mapped files.

  Rays are generated once (streamed one image at a time, bounded host
  RAM) into flat binary shards which the OS pages in on demand at batch
  assembly, so a full-HD capture never needs the whole ray pool
  resident.

  Shares RayPool's deduplicated layout: memmapped per-ray
  directions/rgb[/pixels]; tiny in-RAM per-image tables (origins,
  metadata, row offsets). `image_idx` is derived from the offsets by
  binary search rather than stored.
  """

  def __init__(self, cache_dir, directions, rgb, offsets, origins, metadata,
               pixels=None, shuffle_window_images: int = 16,
               _owns_cache: bool = False):
    self.cache_dir = Path(cache_dir)
    self.directions = directions
    self.rgb = rgb
    self.offsets = offsets  # (M + 1,) int64 cumulative ray counts
    self.origins = origins
    self.metadata = metadata
    self.pixels = pixels
    self.shuffle_window_images = shuffle_window_images
    self._owns_cache = _owns_cache

  @classmethod
  def build(cls, datasource, item_ids, scale_factor=1.0,
            include_pixels: bool = False, cache_dir=None,
            shuffle_window_images: int = 16) -> 'StreamingRayPool':
    """Streams items one at a time into memmap shards."""
    owns_cache = cache_dir is None
    cache_dir = Path(cache_dir) if cache_dir else Path(
        tempfile.mkdtemp(prefix='nerfies_raypool_'))
    cache_dir.mkdir(parents=True, exist_ok=True)

    item_ids = list(item_ids)
    offsets = np.zeros(len(item_ids) + 1, np.int64)
    origins = np.zeros((len(item_ids), 3), np.float32)
    metadata = None
    with open(cache_dir / 'directions.f32', 'wb') as dir_f, \
         open(cache_dir / 'rgb.u8', 'wb') as rgb_f, \
         open(cache_dir / 'pixels.f32', 'wb') as pix_f:
      for i, item_id in enumerate(item_ids):
        item = datasource.get_item(item_id, scale_factor=scale_factor)
        camera = cam.Camera(**item['camera_params'])
        rays = camera_to_rays(camera)
        directions = rays['directions'].reshape(-1, 3).astype(np.float32)
        rgb = item['rgb']
        if rgb.dtype != np.uint8:
          rgb = image_utils.image_to_uint8(rgb[..., :3])
        dir_f.write(directions.tobytes())
        rgb_f.write(np.ascontiguousarray(rgb.reshape(-1, 3)[:, :3]).tobytes())
        if include_pixels:
          pix_f.write(
              rays['pixels'].reshape(-1, 2).astype(np.float32).tobytes())
        offsets[i + 1] = offsets[i] + directions.shape[0]
        origins[i] = camera.position
        if metadata is None:
          keys = sorted(item.get('metadata', {}).keys())
          metadata = {
              k: np.zeros((len(item_ids), 1),
                          np.float32 if k == 'time' else np.uint32)
              for k in keys
          }
        for k in metadata:
          metadata[k][i, 0] = item['metadata'][k]

    directions = np.memmap(cache_dir / 'directions.f32', np.float32,
                           mode='r').reshape(-1, 3)
    rgb = np.memmap(cache_dir / 'rgb.u8', np.uint8, mode='r').reshape(-1, 3)
    pixels = None
    if include_pixels:
      pixels = np.memmap(cache_dir / 'pixels.f32', np.float32,
                         mode='r').reshape(-1, 2)
    return cls(cache_dir, directions, rgb, offsets, origins, metadata,
               pixels=pixels, shuffle_window_images=shuffle_window_images,
               _owns_cache=owns_cache)

  @property
  def num_rays(self) -> int:
    return int(self.offsets[-1])

  @property
  def num_images(self) -> int:
    return len(self.offsets) - 1

  def assemble(self, indices: np.ndarray) -> Dict[str, Any]:
    """Gathers a batch dict for the given ray indices (same as RayPool)."""
    image_idx = np.searchsorted(self.offsets, indices, side='right') - 1
    batch = {
        'origins': self.origins[image_idx],
        'directions': np.asarray(self.directions[indices]),
        'rgb': np.asarray(self.rgb[indices]).astype(np.float32) / 255.0,
        'metadata': {k: v[image_idx] for k, v in self.metadata.items()},
    }
    if self.pixels is not None:
      batch['pixels'] = np.asarray(self.pixels[indices])
    return batch

  def close(self, delete: Optional[bool] = None):
    """Drops the memmaps and (if this pool created it) the cache dir."""
    self.directions = self.rgb = self.pixels = None
    if delete if delete is not None else self._owns_cache:
      shutil.rmtree(self.cache_dir, ignore_errors=True)


def permutation_index_batches(rng, num_rays: int, batch_size: int,
                              shuffle: bool):
  """One epoch of global batch indices via a full-pool permutation."""
  perm = rng.permutation(num_rays) if shuffle else np.arange(num_rays)
  for start in range(0, num_rays - batch_size + 1, batch_size):
    yield perm[start:start + batch_size]


def windowed_index_batches(rng, offsets: np.ndarray, batch_size: int,
                           window_images: int):
  """One epoch of global batch indices with a windowed shuffle.

  A shuffle buffer in bounded memory: image order is permuted, then rays
  are permuted within a sliding window of `window_images` images, so peak
  index memory is O(window rays) instead of O(pool rays). Remainder rays carry over
  between windows; the final partial batch of the epoch is dropped
  (epoch-boundary parity with the preloaded iterator).
  """
  num_images = len(offsets) - 1
  image_order = rng.permutation(num_images)
  leftover = np.empty((0,), np.int64)
  for start in range(0, num_images, window_images):
    window = image_order[start:start + window_images]
    idx = np.concatenate(
        [leftover] +
        [np.arange(offsets[i], offsets[i + 1], dtype=np.int64)
         for i in window])
    idx = rng.permutation(idx)
    usable = (idx.shape[0] // batch_size) * batch_size
    for s in range(0, usable, batch_size):
      yield idx[s:s + batch_size]
    leftover = idx[usable:]


def iterator_from_pool(pool,
                       batch_size: int,
                       seed: int = 0,
                       repeat: bool = True,
                       shuffle: bool = True,
                       prefetch_size: int = 3,
                       process_index: Optional[int] = None,
                       process_count: Optional[int] = None):
  """Batch iterator over a (preloaded or streaming) ray pool.

  `batch_size` is the GLOBAL batch; each host draws the identical global
  index sequence (seeded) and yields its `batch_size // process_count`
  slice. Streaming pools shuffle with image-windowed permutations instead
  of one O(num_rays) permutation.
  """
  if process_index is None:
    process_index = mesh.rank()
  if process_count is None:
    process_count = mesh.world_size()
  if batch_size % process_count != 0:
    raise ValueError(f'batch_size {batch_size} not divisible by process '
                     f'count {process_count}')
  per_host = batch_size // process_count
  host_slice = slice(process_index * per_host, (process_index + 1) * per_host)
  windowed = shuffle and isinstance(pool, StreamingRayPool)

  def generate():
    rng = np.random.default_rng(seed)
    while True:
      if windowed:
        epoch = windowed_index_batches(rng, pool.offsets, batch_size,
                                       pool.shuffle_window_images)
      else:
        epoch = permutation_index_batches(rng, pool.num_rays, batch_size,
                                          shuffle)
      for indices in epoch:
        yield pool.assemble(indices[host_slice])
      if not repeat:
        return

  if prefetch_size > 0:
    return _prefetch(generate(), prefetch_size)
  return generate()


def iterator_from_arrays(arrays: Dict[str, Any],
                         batch_size: int,
                         seed: int = 0,
                         repeat: bool = True,
                         shuffle: bool = True,
                         prefetch_size: int = 3):
  """Batch iterator over a pytree of equally-long numpy arrays.

  Used for auxiliary pools such as the background points
  (the training CLI's background points).
  """
  leaves = _tree_leaves(arrays)
  n = leaves[0].shape[0]

  def generate():
    rng = np.random.default_rng(seed)
    while True:
      perm = rng.permutation(n) if shuffle else np.arange(n)
      for start in range(0, n - batch_size + 1, batch_size):
        idx = perm[start:start + batch_size]
        yield _tree_map(lambda x: x[idx], arrays)
      if not repeat:
        return

  if prefetch_size > 0:
    return _prefetch(generate(), prefetch_size)
  return generate()


def _prefetch(iterator, size: int):
  """Runs `iterator` in a daemon thread with a bounded queue; the
  consumer's wait for an item is the span `data.wait`."""
  q = queue_lib.Queue(maxsize=size)
  sentinel = object()

  def producer():
    try:
      for item in iterator:
        q.put(item)
    finally:
      q.put(sentinel)

  thread = threading.Thread(target=producer, daemon=True)
  thread.start()

  def consumer():
    while True:
      with utils.span('data.wait'):
        item = q.get()
      if item is sentinel:
        return
      yield item

  return consumer()


class DataSource(abc.ABC):
  """Abstract datasource: ids, metadata, per-item loading, iterators.

  The API of nerfies_tpu.datasets.core.DataSource.
  """

  def __init__(self,
               train_ids,
               val_ids,
               use_appearance_id=False,
               use_camera_id=False,
               use_warp_id=False,
               use_depth=False,
               use_relative_depth=False,
               use_time=False,
               random_seed=0,
               train_stride=1,
               val_stride=1,
               preload=True,
               ray_cache_dir=None,
               shuffle_window_images=16,
               **_):
    self._train_ids = train_ids
    self._val_ids = val_ids
    self.train_stride = train_stride
    self.val_stride = val_stride
    self.use_appearance_id = use_appearance_id
    self.use_camera_id = use_camera_id
    self.use_warp_id = use_warp_id
    self.use_depth = use_depth
    self.use_relative_depth = use_relative_depth
    self.use_time = use_time
    self.random_seed = random_seed
    self.rng = np.random.RandomState(random_seed)
    self.preload = preload
    self.ray_cache_dir = ray_cache_dir
    self.shuffle_window_images = shuffle_window_images

  @property
  def all_ids(self):
    return sorted(itertools.chain(self.train_ids, self.val_ids))

  @property
  def train_ids(self):
    return self._train_ids[::self.train_stride]

  @property
  def val_ids(self):
    return self._val_ids[::self.val_stride]

  @abc.abstractmethod
  def load_rgb(self, item_id):
    raise NotImplementedError()

  def load_depth(self, item_id):
    raise NotImplementedError()

  def load_relative_depth(self, item_id):
    """Optional up-to-scale depth hook (parity: ref core.py:246)."""
    raise NotImplementedError()

  @abc.abstractmethod
  def load_camera(self, item_id, scale_factor=1.0):
    raise NotImplementedError()

  def load_points(self, shuffle=False):
    raise NotImplementedError()

  @abc.abstractmethod
  def get_appearance_id(self, item_id):
    raise NotImplementedError()

  @abc.abstractmethod
  def get_camera_id(self, item_id):
    raise NotImplementedError()

  @abc.abstractmethod
  def get_warp_id(self, item_id):
    raise NotImplementedError()

  @abc.abstractmethod
  def get_time_id(self, item_id):
    raise NotImplementedError()

  def get_time(self, item_id):
    max_time = max(self.time_ids)
    return (self.get_time_id(item_id) / max_time) * 2.0 - 1.0

  @property
  @functools.lru_cache(maxsize=None)
  def appearance_ids(self):
    if not self.use_appearance_id:
      return tuple()
    return tuple(
        sorted(set(self.get_appearance_id(i) for i in self.train_ids)))

  @property
  @functools.lru_cache(maxsize=None)
  def camera_ids(self):
    if not self.use_camera_id:
      return tuple()
    return tuple(sorted(set(self.get_camera_id(i) for i in self.train_ids)))

  @property
  @functools.lru_cache(maxsize=None)
  def warp_ids(self):
    if not self.use_warp_id:
      return tuple()
    return tuple(sorted(set(self.get_warp_id(i) for i in self.train_ids)))

  @property
  @functools.lru_cache(maxsize=None)
  def time_ids(self):
    if not self.use_time:
      return tuple()
    return tuple(sorted(set(self.get_time_id(i) for i in self.train_ids)))

  @property
  def near(self) -> float:
    raise NotImplementedError()

  @property
  def far(self) -> float:
    raise NotImplementedError()

  @property
  def has_metadata(self):
    return self.use_appearance_id or self.use_warp_id or self.use_camera_id

  @abc.abstractmethod
  def load_test_cameras(self, count=None):
    raise NotImplementedError()

  def get_item(self, item_id, scale_factor=1.0) -> Dict[str, Any]:
    """Loads one example: camera params, rgb, metadata ids."""
    rgb = self.load_rgb(item_id)
    if scale_factor != 1.0:
      rgb = image_utils.rescale_image(rgb, scale_factor)
    camera = self.load_camera(item_id, scale_factor)
    data = {
        'camera_params': camera.get_parameters(),
        'rgb': rgb,
        'metadata': {},
    }
    if self.use_appearance_id:
      data['metadata']['appearance'] = (
          self.appearance_ids.index(self.get_appearance_id(item_id)))
    if self.use_camera_id:
      data['metadata']['camera'] = (
          self.camera_ids.index(self.get_camera_id(item_id)))
    if self.use_warp_id:
      data['metadata']['warp'] = self.warp_ids.index(
          self.get_warp_id(item_id))
    if self.use_time:
      data['metadata']['time'] = self.get_time(item_id)
    if self.use_depth:
      depth = self.load_depth(item_id)
      if depth is not None:
        if scale_factor != 1.0:
          # Nearest, not bilinear: interpolating across the invalid-depth
          # (0) boundary manufactures small positive depths that defeat
          # eval's `depth > 0` validity mask.
          depth = image_utils.rescale_depth_image(depth, scale_factor)
        data['depth'] = depth[..., np.newaxis]
    return data

  def parallel_get_items(self, item_ids, scale_factor=1.0):
    """Loads many items concurrently."""
    load_fn = functools.partial(self.get_item, scale_factor=scale_factor)
    return utils.parallel_map(load_fn, item_ids)

  def create_ray_pool(self, item_ids, include_pixels=False,
                      preload: Optional[bool] = None):
    """Builds the training ray pool.

    preload=True (default): all rays in host RAM (RayPool). False: rays
    stream to memory-mapped shards (StreamingRayPool) so the resident set
    stays O(one image) during the build and O(page cache) during training
    — the lazy path for captures larger than host memory.
    """
    if preload is None:
      preload = self.preload
    if preload:
      items = self.parallel_get_items(item_ids)
      return RayPool.from_items(items, include_pixels=include_pixels)
    return StreamingRayPool.build(
        self, item_ids, include_pixels=include_pixels,
        cache_dir=self.ray_cache_dir,
        shuffle_window_images=self.shuffle_window_images)

  def create_iterator(self,
                      item_ids,
                      batch_size: int,
                      repeat: bool = True,
                      flatten: bool = False,
                      shuffle: bool = False,
                      prefetch_size: int = 3,
                      devices: Optional[Sequence[Any]] = None,
                      **_):
    """Creates a batch (or whole-image) iterator.

    With batch_size > 0 and flatten=True: yields flat ray batches (the
    training path). With batch_size == 0: yields whole-image example dicts
    (the eval path).
    """
    del devices  # the train step moves each batch to its device
    if batch_size and flatten:
      pool = self.create_ray_pool(item_ids)
      return iterator_from_pool(
          pool, batch_size, seed=self.random_seed, repeat=repeat,
          shuffle=shuffle, prefetch_size=prefetch_size)
    return self._image_iterator(item_ids, repeat=repeat, shuffle=shuffle)

  def _image_iterator(self, item_ids, repeat=True, shuffle=False):
    def generate():
      rng = np.random.default_rng(self.random_seed)
      while True:
        ids = list(item_ids)
        if shuffle:
          rng.shuffle(ids)
        for item_id in ids:
          item = self.get_item(item_id)
          camera = cam.Camera(**item['camera_params'])
          rays = camera_to_rays(camera)
          h, w = rays['directions'].shape[:2]
          out = {
              'rgb': image_utils.image_to_float32(item['rgb'][..., :3]),
              'origins': rays['origins'],
              'directions': rays['directions'],
              'pixels': rays['pixels'],
              'metadata': {
                  k: np.full((h, w, 1), v,
                             np.float32 if k == 'time' else np.uint32)
                  for k, v in item['metadata'].items()
              },
          }
          if 'depth' in item:
            out['depth'] = item['depth']
          yield out
        if not repeat:
          return

    return generate()
