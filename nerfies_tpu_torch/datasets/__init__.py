"""Dataset registry: `from_config` and the pipeline's entry points."""

from nerfies_tpu_torch.datasets.core import camera_to_rays
from nerfies_tpu_torch.datasets.core import DataSource
from nerfies_tpu_torch.datasets.core import iterator_from_arrays
from nerfies_tpu_torch.datasets.core import load_camera
from nerfies_tpu_torch.datasets.core import RayPool
from nerfies_tpu_torch.datasets.nerfies import NerfiesDataSource


def from_config(spec, **kwargs):
  """Creates a datasource from a {'type': ..., ...} spec dict."""
  spec = dict(spec)
  ds_type = spec.pop('type')
  if ds_type == 'nerfies':
    return NerfiesDataSource(**spec, **kwargs)
  raise ValueError(f'Unknown datasource type {ds_type!r}')
