"""Filesystem paths, local or in an object store.

Port of nerfies_tpu/gpath.py: local paths are pathlib paths; a URL with a
scheme (`gs://`, `s3://`, ...) goes through fsspec, imported only when
such a path is built.
"""

import pathlib
import shutil


def GPath(*parts):  # noqa: N802  (name kept for reference-API parity)
  """Builds a path object; returns a cloud path wrapper for URL schemes."""
  joined = str(pathlib.PurePosixPath(*[str(p) for p in parts])) if parts else ''
  if '://' in str(parts[0] if parts else ''):
    return _CloudPath('/'.join(str(p) for p in parts))
  return _LocalPath(joined)


class _LocalPath(pathlib.PosixPath):
  """pathlib path plus the couple of gfile-isms the reference API exposes."""

  def rmtree(self):
    shutil.rmtree(self)


class _CloudPath:
  """Minimal fsspec-backed path for object stores (gs://, s3://, ...)."""

  def __init__(self, url: str):
    self._url = url.rstrip('/')
    import fsspec  # deferred: only needed for cloud paths
    self._fs, self._path = fsspec.core.url_to_fs(self._url)

  def __truediv__(self, other):
    return _CloudPath(f'{self._url}/{other}')

  def __str__(self):
    return self._url

  @property
  def name(self):
    return self._url.rsplit('/', 1)[-1]

  @property
  def suffix(self):
    name = self.name
    return name[name.rfind('.'):] if '.' in name else ''

  @property
  def stem(self):
    name = self.name
    return name[:name.rfind('.')] if '.' in name else name

  @property
  def parent(self):
    return _CloudPath(self._url.rsplit('/', 1)[0])

  def open(self, mode='r', **kwargs):
    return self._fs.open(self._path, mode, **kwargs)

  def exists(self):
    return self._fs.exists(self._path)

  def is_dir(self):
    return self._fs.isdir(self._path)

  def mkdir(self, mode=0o777, parents=False, exist_ok=False):
    del mode, parents
    if not exist_ok and self.exists():
      raise FileExistsError(self._url)
    self._fs.makedirs(self._path, exist_ok=True)

  def glob(self, pattern):
    scheme = self._url.split('://', 1)[0]
    return [_CloudPath(f'{scheme}://{p}')
            for p in self._fs.glob(f'{self._path}/{pattern}')]

  def iterdir(self):
    scheme = self._url.split('://', 1)[0]
    return [_CloudPath(f'{scheme}://{p}') for p in self._fs.ls(self._path)]

  def rmtree(self):
    self._fs.rm(self._path, recursive=True)
