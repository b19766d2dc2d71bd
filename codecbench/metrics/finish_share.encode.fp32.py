"""finish_share.encode in the cells whose convolutions run in FP32, where
it moves encode_fps.fp32."""

from harness.readers import finish_share


def read(ctx):
    return finish_share(ctx)
