"""K1's (rANS encode) share of its roofline in the traced encode."""

from harness.readers import roofline_share


def read(ctx):
    return roofline_share(ctx, "k1", "encode")
