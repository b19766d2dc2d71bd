"""device_idle.encode in the cells whose convolutions run in FP32, where it
moves encode_fps.fp32."""

from harness.readers import idle_share


def read(ctx):
    return idle_share(ctx, "encode")
