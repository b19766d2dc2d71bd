"""k1_roofline.encode in the cells whose convolutions run in FP32, where it
moves encode_fps.fp32."""

from harness.readers import roofline_share


def read(ctx):
    return roofline_share(ctx, "k1", "encode")
