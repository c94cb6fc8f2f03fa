"""Request: the share of the measured window's time in which the card sat idle
while the host was in each chunk's model call (`render.model`, the weights'
packing inside it included): `idle_share.render` split by the program span
that launched the op ending each idle gap (benchmark/spans.py). None where
the two profiled stretches launched different numbers of ops, or where the
program opens no span."""

from benchmark import spans


def read(ctx):
  return spans.idle_share(ctx, 'render', ('render.model', 'kernel.pack'))
