"""Spans of the port's host code: what the host was doing, wave by wave,
while the card ran or waited.

``span(name, **attrs)`` marks a stretch of host code (a context
manager); ``recording()`` turns recording on for a block and yields the
``Recording`` that keeps every span ending inside it, from every thread:
the switch is the process's, since the spans sit deep inside the codec
and its collectives, where no recorder is passed.  Off, the default,
``span`` returns one shared no-op object (``NOOP``): no clock is read and
nothing is kept.

A recorded span has its name, an id, its parent's id (the innermost span
open on the same thread when it began; None at the top), its start and
end in ``time.perf_counter_ns()``, its attributes, and the wave id and
frame count ``k`` of the wave it belongs to: given as ``wave=`` and
``k=`` on a wave's ``launch``, ``finish`` or ``batch`` span, inherited by
every span opened inside it.  A wave's ``launch`` and ``finish`` carry
one id (``new_wave``; ``FrameCodec.encode_frames_launch`` hands it to
``encode_frames_finish`` in the wave's handles).  A span's self time is
its duration less what its children cover.

Every name has a class (``CLASS``): "dispatch" where the host enqueues
kernels, "host" where it does work of its own that the card may wait
for (uploads, pulls to the host, parsing, packing, collectives).  A
parent's class is that of its self time.

The clock is torch.profiler's: a profile's event times are microseconds
after ``prof.profiler.kineto_results.trace_start_ns()``, on the wall
clock, and a recording keeps ``time.time_ns() - time.perf_counter_ns()``
from its start (``Recording.offset_ns``), so ``Recording.on_trace``
places every span on a profile's timeline.  ``idle_by`` then sums the
card's idle time by the innermost span the host was in.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

# The spans of the port, by name, and the class of each one's self time.
CLASS = {
    # encode, one wave: FrameCodec.encode_frames_launch and its stages
    "launch": "dispatch",
    "launch.upload": "host",
    "launch.mofnet": "dispatch",
    "launch.warp": "dispatch",
    "launch.codecnet": "dispatch",
    "launch.planes": "dispatch",
    # a model without MOFNet and CodecNet (ELIC, pipeline/elic.py): its
    # transforms and hyperprior; each context step (group, pass)
    "launch.nets": "dispatch",
    "launch.ctx": "dispatch",
    # FrameCodec.encode_frames_finish
    "finish": "host",
    "finish.pull": "host",
    "finish.k1": "dispatch",
    "finish.pack": "host",
    # decode, one wave: FrameCodec.decode_frames_batch
    "batch": "host",
    "batch.parse": "host",
    "batch.upload": "host",
    "batch.k2": "dispatch",
    "batch.nets": "dispatch",
    # ELIC: a context step's nets (group, pass), its K2 launch inside
    "batch.ctx": "dispatch",
    # a wave's uint8 planes pulled to the host on first access
    "planes.pull": "host",
    # pipeline/video.py: a call, a GOP packed or unpacked
    "video.encode": "host",
    "video.decode": "host",
    "video.gop": "host",
    # the host backend's range coder threads (codec.py:_par_map)
    "pool": "host",
    # parallel/: every collective, a halo exchange, a gather of row bands
    "mesh.gather": "host",
    "halo.exchange": "host",
    "halo.gather": "host",
}

_now = time.perf_counter_ns
_local = threading.local()
_ids = itertools.count(1)
_waves = itertools.count(1)
_rec: Optional["Recording"] = None


class _NoSpan:
    """What ``span`` returns with recording off: one shared object."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def note(self, **attrs) -> None:
        pass


NOOP = _NoSpan()


class Span:
    __slots__ = ("name", "id", "parent", "wave", "k", "attrs", "start",
                 "end", "thread", "_rec")

    def __init__(self, rec: "Recording", name: str, attrs: Dict):
        if name not in CLASS:
            raise ValueError(f"no span {name!r} in tracing.CLASS")
        self.name = name
        self.id = next(_ids)
        self.wave = attrs.pop("wave", None)
        self.k = attrs.pop("k", None)
        self.attrs = attrs
        self.parent = self.start = self.end = None
        self._rec = rec

    def __enter__(self) -> "Span":
        stack = _stack()
        if stack:
            top = stack[-1]
            self.parent = top.id
            if self.wave is None:
                self.wave, self.k = top.wave, top.k
        self.thread = threading.get_ident()
        stack.append(self)
        self.start = _now()
        return self

    def __exit__(self, *exc) -> bool:
        self.end = _now()
        _stack().pop()
        self._rec.spans.append(self)
        return False

    def note(self, **attrs) -> None:
        """Attributes known only inside the span (K, steps)."""
        self.attrs.update(attrs)

    @property
    def cls(self) -> str:
        return CLASS[self.name]

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, "
                f"wave={self.wave}, k={self.k}, {self.attrs})")


def _stack() -> List[Span]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def span(name: str, **attrs):
    """A span named ``name`` (a key of ``CLASS``) around a ``with``
    block; ``wave=`` and ``k=`` name the wave it belongs to, other
    keywords are kept as its attributes.  The shared ``NOOP`` when
    nothing records."""
    rec = _rec
    if rec is None:
        return NOOP
    return Span(rec, name, attrs)


def new_wave() -> Optional[int]:
    """A fresh wave id while recording, else None."""
    return None if _rec is None else next(_waves)


class Recording:
    """The spans that ended while recording, in the order they ended."""

    def __init__(self):
        self.spans: List[Span] = []
        self.offset_ns = time.time_ns() - time.perf_counter_ns()

    def named(self, name: str) -> List[Span]:
        return [s for s in self.spans if s.name == name]

    def seconds(self, name: str) -> float:
        """Total seconds of the spans named ``name``."""
        return sum(s.end - s.start for s in self.spans
                   if s.name == name) / 1e9

    def children(self) -> Dict[Optional[int], List[Span]]:
        out: Dict[Optional[int], List[Span]] = {}
        for s in self.spans:
            out.setdefault(s.parent, []).append(s)
        return out

    def self_ns(self, s: Span, children=None) -> int:
        """``s``'s duration less the union of its children's spans."""
        kids = (children if children is not None
                else self.children()).get(s.id, [])
        covered = union_length((max(c.start, s.start), min(c.end, s.end))
                               for c in kids)
        return s.end - s.start - int(covered)

    def summary(self) -> Dict[str, Dict[str, float]]:
        """Per name: the number of spans, their seconds and self
        seconds."""
        kids = self.children()
        out: Dict[str, Dict[str, float]] = {}
        for s in self.spans:
            d = out.setdefault(s.name, {"n": 0, "seconds": 0.0,
                                        "self_seconds": 0.0})
            d["n"] += 1
            d["seconds"] += (s.end - s.start) / 1e9
            d["self_seconds"] += self.self_ns(s, kids) / 1e9
        return out

    def on_trace(self, trace_start_ns: int) -> List[Dict]:
        """Every span as a dict, its start and end in microseconds after
        ``trace_start_ns`` (a profile's ``kineto_results.
        trace_start_ns()``), on the profile's timeline."""
        return [{"name": s.name, "id": s.id, "parent": s.parent,
                 "wave": s.wave, "k": s.k, "attrs": dict(s.attrs),
                 "class": s.cls,
                 "start_us": self.to_trace_us(s.start, trace_start_ns),
                 "end_us": self.to_trace_us(s.end, trace_start_ns)}
                for s in self.spans]

    def to_trace_us(self, perf_ns: int, trace_start_ns: int) -> float:
        """A ``time.perf_counter_ns()`` reading on a profile's timeline."""
        return (perf_ns + self.offset_ns - trace_start_ns) / 1e3


@contextlib.contextmanager
def recording() -> Iterator[Recording]:
    """Record every span of every thread while the block runs."""
    global _rec
    if _rec is not None:
        raise RuntimeError("spans are already being recorded")
    rec = Recording()
    _rec = rec
    try:
        yield rec
    finally:
        _rec = None


def union_length(spans: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of [start, end) spans."""
    total, cur_s, cur_e = 0.0, None, None
    for a, b in sorted(spans):
        if cur_e is None or a > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    return total if cur_e is None else total + cur_e - cur_s


def _idle(busy: Iterable[Tuple[float, float]], t0: float,
          t1: float) -> List[Tuple[float, float]]:
    """The stretches of [t0, t1) outside every ``busy`` span."""
    out, cur = [], t0
    for a, b in sorted(busy):
        if a > cur:
            out.append((cur, min(a, t1)))
        cur = max(cur, b)
        if cur >= t1:
            break
    if cur < t1:
        out.append((cur, t1))
    return [(a, b) for a, b in out if b > a]


def _innermost(spans: List[Tuple[float, float, str]]
               ) -> List[Tuple[float, float, str]]:
    """The timeline of the innermost span: disjoint (start, end, key)
    stretches, the key of the latest-started span open there (of two
    started together, the one that ends first)."""
    cuts = sorted({t for a, b, _ in spans for t in (a, b)})
    by_start = sorted(range(len(spans)), key=lambda i: spans[i][0])
    out, open_, j = [], set(), 0
    for lo, hi in zip(cuts, cuts[1:]):
        while j < len(by_start) and spans[by_start[j]][0] <= lo:
            open_.add(by_start[j])
            j += 1
        open_ = {i for i in open_ if spans[i][1] > lo}
        if open_:
            i = max(open_, key=lambda i: (spans[i][0], -spans[i][1]))
            out.append((lo, hi, spans[i][2]))
    return out


def idle_by(kernels: Iterable[Tuple[float, float]],
            spans: List[Tuple[float, float, str]], t0: float,
            t1: float) -> Dict[Optional[str], float]:
    """The card's idle time in [t0, t1) (no kernel or copy of
    ``kernels`` running), summed by the key of the innermost of
    ``spans`` ((start, end, key), on the kernels' timeline) the host was
    in; None sums what lies outside every span."""
    idle = _idle(kernels, t0, t1)
    out: Dict[Optional[str], float] = {}
    segs = _innermost(spans)
    j = 0
    for a, b in idle:
        covered = 0.0
        while j < len(segs) and segs[j][1] <= a:
            j += 1
        i = j
        while i < len(segs) and segs[i][0] < b:
            lo, hi = max(a, segs[i][0]), min(b, segs[i][1])
            if hi > lo:
                out[segs[i][2]] = out.get(segs[i][2], 0.0) + hi - lo
                covered += hi - lo
            i += 1
        if b - a - covered > 0:
            out[None] = out.get(None, 0.0) + b - a - covered
    return out
