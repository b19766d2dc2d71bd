"""K3 (motion warp of the coding path, csrc/kernels.cu:
warp_packed_kernel): 24 bytes an output pixel, read once and written
once: the packed 8-bit YUV source (4 B), the two float flows (8 B) and
the three float output planes (12 B).  4 x 1088 x 1920 gives 0.0599 ms
at 3.35 TB/s."""

KERNELS = r"warp_packed"


def bytes_moved(calls) -> int:
    return sum(24 * b * h * w for _, (b, h, w) in calls.k3)
