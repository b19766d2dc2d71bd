from aivc_tpu_torch.io.yuv import (  # noqa: F401
    YuvReader,
    YuvWriter,
    frame_to_float,
    frame_to_uint8,
    parse_geometry,
)
