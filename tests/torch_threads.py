"""One intra-op torch thread for a test module: import `one_torch_thread`
into the module (an autouse fixture). Imports no JAX."""

import pytest
import torch


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
  """One intra-op thread for the module that imports this fixture.

  On small tensors torch's thread pool costs more than it gives, and far
  more when the test workers share the cores: a module of small renders
  and steps ran about ten times slower with the default pool beside five
  busy processes than with one thread.
  """
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)

