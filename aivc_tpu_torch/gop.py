"""GOP structure engine: explicit dependency DAG + batched coding schedule.

Reproduces the semantics of the reference generator
(reference: src/func_util/GOP_structure.py:27-137,199-221) — All-Intra,
Low-delay P, and hierarchical-B Random Access with chained GOPs — but as a
table-driven scheduler that also exposes *temporal waves*: groups of frames
whose references are all already decoded, which a TPU encoder can code as one
batch.  The reference walks frames strictly one-by-one in coding order
(reference: src/real_life/decode.py:119-121 "no parallel coding of frame at
the same temporal layer"); the wave schedule is the parallelism it leaves on
the table.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from aivc_tpu_torch.config import FRAME_B, FRAME_I, FRAME_P


@dataclass(frozen=True)
class FrameSpec:
    """One frame of a GOP, in display order."""

    idx: int                      # display index inside the GOP structure
    frame_type: int               # FRAME_I / FRAME_P / FRAME_B
    prev_ref: Optional[int]       # display index of the previous reference
    next_ref: Optional[int]       # display index of the next reference
    coding_order: int


@dataclass(frozen=True)
class GopStruct:
    """A full GOP structure: frames + derived schedules."""

    name: str
    frames: Tuple[FrameSpec, ...]          # sorted by display index

    def __len__(self) -> int:
        return len(self.frames)

    @property
    def by_idx(self) -> Dict[int, FrameSpec]:
        return {f.idx: f for f in self.frames}

    @property
    def coding_order(self) -> Tuple[FrameSpec, ...]:
        """Frames sorted by coding order (the bitstream layout order)."""
        return tuple(sorted(self.frames, key=lambda f: f.coding_order))

    @property
    def depth(self) -> int:
        """Maximum coding order (reference: GOP_structure.py:164-174)."""
        return max(f.coding_order for f in self.frames)

    def waves(self) -> List[List[FrameSpec]]:
        """Dependency-honouring batched schedule.

        Wave k contains every frame whose references were all decoded in
        waves < k.  Frames inside a wave are mutually independent given their
        references (hierarchical-B temporal layers), so they can be coded as
        one batch on a device mesh.  Within a wave, frames are sorted by
        coding order so the serialized bitstream layout stays well defined.
        """
        decoded: set = set()
        remaining = sorted(self.frames, key=lambda f: f.coding_order)
        waves: List[List[FrameSpec]] = []
        while remaining:
            ready = [
                f
                for f in remaining
                if (f.prev_ref is None or f.prev_ref in decoded)
                and (f.next_ref is None or f.next_ref in decoded)
            ]
            if not ready:
                raise ValueError(f"cyclic GOP structure {self.name!r}")
            waves.append(ready)
            decoded.update(f.idx for f in ready)
            ready_set = {f.idx for f in ready}
            remaining = [f for f in remaining if f.idx not in ready_set]
        return waves


# ---------------------------------------------------------------------------
# Generators
# ---------------------------------------------------------------------------

def _ra_frames(gop_size: int) -> Dict[int, Tuple[int, Optional[int], Optional[int], int]]:
    """Hierarchical-B GOP: I at 0, P at gop_size, B pyramid in between.

    Pre-order recursion identical to the reference's do_next_temp_layer
    (reference: src/func_util/GOP_structure.py:27-67) so coding orders match.
    Returns {idx: (type, prev_ref, next_ref, coding_order)}.
    """
    frames: Dict[int, Tuple[int, Optional[int], Optional[int], int]] = {
        0: (FRAME_I, None, None, 0),
        gop_size: (FRAME_P, 0, None, 1),
    }

    def descend(idx: int, half: int, order: int) -> int:
        frames[idx] = (FRAME_B, idx - half, idx + half, order)
        order += 1
        half //= 2
        if half:
            order = descend(idx - half, half, order)
            order = descend(idx + half, half, order)
        return order

    if gop_size >= 2:
        descend(gop_size // 2, gop_size // 2, 2)
    return frames


def _chained_ra_frames(gop_size: int, n_gops: int) -> Dict[int, Tuple]:
    """n chained RA GOPs sharing one I-frame.

    Each chained GOP drops its I-frame and shifts indices, references and
    coding orders by i * gop_size (reference: GOP_structure.py:70-112).
    """
    frames = dict(_ra_frames(gop_size))
    base = _ra_frames(gop_size)
    for i in range(1, n_gops):
        off = i * gop_size
        for idx, (ftype, prev_ref, next_ref, order) in base.items():
            if idx == 0:
                continue
            frames[idx + off] = (
                ftype,
                None if prev_ref is None else prev_ref + off,
                None if next_ref is None else next_ref + off,
                order + off,
            )
    return frames


def _ldp_frames(gop_size: int) -> Dict[int, Tuple]:
    """Low-delay P: I then a chain of P frames
    (reference: GOP_structure.py:115-137)."""
    frames: Dict[int, Tuple] = {0: (FRAME_I, None, None, 0)}
    for i in range(1, gop_size + 1):
        frames[i] = (FRAME_P, i - 1, None, i)
    return frames


def generate_gop_struct(name: str) -> GopStruct:
    """Build a GOP structure from its name.

    Names follow the reference convention (GOP_structure.py:199-221):
      '1_GOP_0'        All-Intra (a single I frame)
      'LDP_<n>'        I + n P-frames
      '<k>_GOP_<g>'    k chained hierarchical-B GOPs of size g
    """
    parts = name.split("_")
    if name == "1_GOP_0":
        frames = {0: (FRAME_I, None, None, 0)}
    elif "LDP" in parts:
        frames = _ldp_frames(int(parts[-1]))
    else:
        n_gops = int(parts[0])
        gop_size = int(parts[-1])
        frames = _chained_ra_frames(gop_size, n_gops)

    specs = tuple(
        FrameSpec(idx, *frames[idx]) for idx in sorted(frames)
    )
    # Sanity: coding orders must be a permutation of 0..n-1.
    orders = sorted(f.coding_order for f in specs)
    if orders != list(range(len(specs))):
        raise ValueError(f"non-contiguous coding orders in {name!r}: {orders}")
    return GopStruct(name=name, frames=specs)


def frame_at_coding_order(gop: GopStruct, order: int) -> FrameSpec:
    """The unique frame with the given coding order
    (reference: GOP_structure.py:148-161 returns a 1-element list)."""
    for f in gop.frames:
        if f.coding_order == order:
            return f
    raise KeyError(order)
