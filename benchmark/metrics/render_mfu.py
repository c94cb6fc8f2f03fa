"""Request: forward FLOPs of the window's rendered rays
(counts.render_ray_flops) over the window's time, as a share of the
card's dense bf16 peak."""

from benchmark import counts


def read(ctx):
  peak = counts.peak(ctx.device_name)
  if peak is None or not ctx.window.rays:
    return None
  flops = counts.render_ray_flops(ctx.model) * ctx.window.rays
  return 100.0 * flops / ctx.window.seconds / peak[0]
