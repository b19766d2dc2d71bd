"""The share of the window's encode seconds inside
FrameCodec.encode_frames_finish (the K policy, K1, the pulls to the
host, packaging)."""

from harness.readers import finish_share


def read(ctx):
    return finish_share(ctx)
