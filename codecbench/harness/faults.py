"""Faults planted under a run, to show that ``correct`` comes out false:
each breaks the program's timed path at run time, on the codec
instance, and edits no file.

* ``token``: one symbol of each frame's main latent altered by +3 where
  it is produced (the encoder's rounding), so the stream and the
  reconstruction carry it consistently;
* ``unchanged``: each frame's synthesis hands back its prediction
  unchanged (no residual; a black I-frame), in encoder and decoder;
* ``half_batch``: the second half of every wave of two or more frames
  left out, the first half's frames coded in its place.

The first two reach into the model's stages, so the architecture plants
them (``fault(name, system)`` of ``architectures/<name>.py``).  A cell
on one chip has no exchange between chips to leave out."""

from __future__ import annotations

FAULTS = ("token", "unchanged", "half_batch")


def plant(name: str):
    """-> a function that breaks a harness System of an architecture in
    place: ``break_system(system, arch)``."""
    if name not in FAULTS:
        raise KeyError(f"no fault {name!r}; known: {list(FAULTS)}")

    def half_batch(system, arch):
        codec = system.codec
        inner = codec.encode_frames_launch

        def launch(frames, prev, nxt, ftype, idx_rate):
            k = len(frames)
            if k >= 2:
                frames = list(frames[:k - k // 2]) + list(frames[:k // 2])
            return inner(frames, prev, nxt, ftype, idx_rate)
        codec.encode_frames_launch = launch

    if name == "half_batch":
        return half_batch
    return lambda system, arch: arch.fault(name, system)
