"""The encode's share of the card's peak: model FLOPs of the frames
encoded over the window's encode seconds, over the configuration's
peak (989 TFLOP/s bf16, 67 TFLOP/s FP32)."""

from harness.readers import flops_share


def read(ctx):
    return flops_share(ctx, "encode")
