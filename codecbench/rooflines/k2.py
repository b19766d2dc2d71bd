"""K2 (rANS decode, csrc/kernels.cu: rans_decode_kernel): bytes read once
and written once per launch.  In: the 16-bit words the launch consumes,
each padded symbol's CDF row (int32) and the lanes' states.  Out: the
symbols (int32) and the lanes' states."""

KERNELS = r"rans_decode"


def bytes_moved(calls) -> int:
    total = 0
    for (b, n_pad), k, g0, g1 in calls.k2:
        words = int((g1.long() - g0.long()).sum())
        total += 8 * b * n_pad + 2 * words + 8 * b * k
    return total
