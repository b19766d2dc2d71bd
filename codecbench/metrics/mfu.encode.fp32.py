"""mfu.encode in the cells whose convolutions run in FP32, where it moves
encode_fps.fp32."""

from harness.readers import flops_share


def read(ctx):
    return flops_share(ctx, "encode")
