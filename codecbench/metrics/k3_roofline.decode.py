"""K3's (motion warp) share of its roofline in the traced decode."""

from harness.readers import roofline_share


def read(ctx):
    return roofline_share(ctx, "k3", "decode")
