"""k2_roofline.decode in the cells whose convolutions run in FP32, where it
moves decode_fps.fp32."""

from harness.readers import roofline_share


def read(ctx):
    return roofline_share(ctx, "k2", "decode")
