"""device_idle.decode in the cells whose convolutions run in FP32, where it
moves decode_fps.fp32."""

from harness.readers import idle_share


def read(ctx):
    return idle_share(ctx, "decode")
