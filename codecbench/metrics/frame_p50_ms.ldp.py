"""The median per-frame latency of the window (a frame's wave from its
launch to the end of its finish), beside the tail that frame_p95_ms
reports."""

from harness.readers import median_latency_ms


def read(ctx):
    return median_latency_ms(ctx)
