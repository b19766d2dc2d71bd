"""Device trace of a traced sub-window: ``torch.profiler`` over CPU and
CUDA, the kernels' spans and the benchmark's own host spans read back.
The busy time is the union of kernel spans (the arithmetic of
aivc_tpu_torch/profile_forward.py:busy_us, copied).  Kernel shapes for
the rooflines come from wrappers the benchmark sets around the entropy
coder's and the warp's entry points while the trace runs
(``KernelCalls``); they record shapes and change nothing."""

from __future__ import annotations

import re
import time
from typing import Dict, List, Tuple

import torch

SPAN_PREFIX = "codecbench."


def busy_us(spans: List[Tuple[float, float]]) -> float:
    """Length of the union of [start, end) spans."""
    if not spans:
        return 0.0
    spans = sorted(spans)
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for a, b in spans[1:]:
        if a > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    return busy + cur_e - cur_s


def short_name(name: str) -> str:
    """A kernel's name without return type, namespaces, template and
    parameter lists."""
    name = re.sub(r"^void |\(anonymous namespace\)::", "", name)
    base = re.split(r"[<(]", name, maxsplit=1)[0]
    return base.split("::")[-1][:80] or name[:80]


class KernelCalls:
    """Shapes of every K1, K2 and K3 launch while active: patched module
    functions of the program, restored on exit."""

    def __init__(self):
        self.k1: List = []
        self.k2: List = []
        self.k3: List = []

    def __enter__(self):
        from aivc_tpu_torch.coding import vrans
        from aivc_tpu_torch.ops import warp

        self._saved = [(vrans, "encode_cuda", vrans.encode_cuda),
                       (vrans, "decode_cuda", vrans.decode_cuda),
                       (warp, "warp_packed_cuda", warp.warp_packed_cuda)]

        def enc(sym, rows, table, k, segment_steps=()):
            buf, states, seg_g = self._saved[0][2](sym, rows, table, k,
                                                   segment_steps)
            self.k1.append((tuple(sym.shape), k, seg_g[:, 0].clone()))
            return buf, states, seg_g

        def dec(words, states, rows, table, k, g0=None):
            out = self._saved[1][2](words, states, rows, table, k, g0)
            start = (torch.zeros(rows.shape[0], dtype=torch.int32,
                                 device=rows.device) if g0 is None
                     else g0.clone())
            self.k2.append((tuple(rows.shape), k, start, out[2].clone()))
            return out

        def wp(packed, u, v, row0=0):
            self.k3.append((tuple(packed.shape), tuple(u.shape)))
            return self._saved[2][2](packed, u, v, row0)

        vrans.encode_cuda, vrans.decode_cuda = enc, dec
        warp.warp_packed_cuda = wp
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)
        return False


def profiled(fn) -> Dict:
    """Run ``fn()`` under the profiler, the card synchronised before and
    after.  -> {"window_s", "kernels": [(name, start_us, end_us)],
    "spans": [(name, start_us, end_us)] of the benchmark's host spans,
    "busy_s", "result"}."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                 ) as prof:
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    kernels, spans = [], []
    for e in prof.events():
        if e.name.startswith(SPAN_PREFIX):
            # The profiler mirrors a host span on the device's timeline
            # as an annotation; only the host's copy is a span.
            if e.device_type != torch.autograd.DeviceType.CUDA:
                spans.append((e.name[len(SPAN_PREFIX):], e.time_range.start,
                              e.time_range.end))
        elif e.device_type == torch.autograd.DeviceType.CUDA:
            kernels.append((e.name, e.time_range.start, e.time_range.end))
    busy = busy_us([(a, b) for _, a, b in kernels]) / 1e6
    return {"window_s": window_s, "kernels": kernels, "spans": spans,
            "busy_s": busy, "result": result}


def kernel_seconds(trace: Dict, pattern: str) -> float:
    """Device seconds of the kernels whose name matches ``pattern``."""
    rx = re.compile(pattern)
    return sum(b - a for n, a, b in trace["kernels"] if rx.search(n)) / 1e6


def top_ops(traces: List[Dict], top: int = 10) -> List:
    by: Dict[str, float] = {}
    for t in traces:
        for n, a, b in t["kernels"]:
            k = short_name(n)
            by[k] = by.get(k, 0.0) + (b - a) / 1e6
    return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:top]


def idle_gaps(traces: List[Dict], top: int = 10) -> List:
    """Idle device time between kernels, summed by the innermost
    benchmark span the host was in at the gap's middle."""
    by: Dict[str, float] = {}
    for t in traces:
        ks = sorted((a, b) for _, a, b in t["kernels"])
        spans = sorted(t["spans"], key=lambda s: s[2] - s[1])
        cur = ks[0][1] if ks else 0.0
        for a, b in ks[1:]:
            if a > cur:
                mid = 0.5 * (a + cur)
                name = next((n for n, s, e in spans if s <= mid <= e),
                            "outside the codec's calls")
                by[name] = by.get(name, 0.0) + (a - cur) / 1e6
            cur = max(cur, b)
    return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:top]
