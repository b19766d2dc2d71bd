"""K1 (rANS encode, csrc/kernels.cu: rans_encode_lanes_kernel, then the
count and place passes): bytes read once and written once per launch.
In: each padded symbol and its CDF row, int32 each.  Out: the stream's
16-bit words and each lane's 32-bit final state."""

KERNELS = r"rans_encode"


def bytes_moved(calls) -> int:
    total = 0
    for (b, n_pad), k, seg0 in calls.k1:
        words = int((n_pad - seg0.long()).sum())
        total += 8 * b * n_pad + 2 * words + 4 * b * k
    return total
