"""Step: model FLOPs of the window's steps (counts.step_flops) over the
window's time, as a share of the card's dense bf16 peak."""

from benchmark import counts


def read(ctx):
  peak = counts.peak(ctx.device_name)
  if peak is None or not ctx.window.units:
    return None
  train = ctx.cell.config['train']
  flops = counts.step_flops(ctx.model, train['batch_size'],
                            train['background_points_batch_size'])
  return 100.0 * flops * ctx.window.units / ctx.window.seconds / peak[0]
