"""The decode's share of the card's peak: model FLOPs of the decoder's
hyper-synthesis, shortcut and synthesis for the frames decoded, over
the window's decode seconds, over the configuration's peak."""

from harness.readers import flops_share


def read(ctx):
    return flops_share(ctx, "decode")
