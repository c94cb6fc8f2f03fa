"""Input pipeline: host milliseconds a step spent in `next()` on the ray
and background-point iterators (datasets/core.py), over the window."""


def read(ctx):
  if not ctx.window.units:
    return None
  return 1e3 * ctx.window.data_wait_s / ctx.window.units
