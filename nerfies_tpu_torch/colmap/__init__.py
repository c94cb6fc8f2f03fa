"""COLMAP interop: scene parsing, camera models, pose algebra, databases.

The port's own copy of nerfies_tpu/colmap (numpy, sqlite3 and scipy; no
JAX), written against the public COLMAP file-format specification: a
model saved by either package loads in the other and saves to the same
bytes. Used by the capture processing (`capture.py`,
`python -m nerfies_tpu_torch.process_capture`); never imported by
train or eval.
"""

from nerfies_tpu_torch.colmap.camera import ColmapCamera
from nerfies_tpu_torch.colmap.database import COLMAPDatabase
from nerfies_tpu_torch.colmap.image import Image
from nerfies_tpu_torch.colmap.rotation import DualQuaternion
from nerfies_tpu_torch.colmap.rotation import Quaternion
from nerfies_tpu_torch.colmap.scene_manager import SceneManager
