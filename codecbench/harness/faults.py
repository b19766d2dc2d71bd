"""Faults planted under a run, to show that ``correct`` comes out false:
each breaks the program's timed path at run time, on the codec
instance, and edits no file.

* ``token``: one symbol of each frame's CodecNet latent altered by +3
  where it is produced (the encoder's rounding), so the stream and the
  reconstruction carry it consistently;
* ``unchanged``: each frame's synthesis hands back its prediction
  unchanged (no residual; a black I-frame), in encoder and decoder;
* ``half_batch``: the second half of every wave of two or more frames
  left out, the first half's frames coded in its place.

A cell on one chip has no exchange between chips to leave out."""

from __future__ import annotations

import torch

FAULTS = ("token", "unchanged", "half_batch")


def plant(name: str):
    """-> a function that breaks a harness System in place."""
    def token(system):
        codec = system.codec
        inner = codec._quantize_y

        def altered(y, mu):
            q = inner(y, mu).clone()
            if q.shape[1] == system.codec.cfg.codecnet.nb_ft_y:
                q[:, 0, 0, 0] = torch.clamp(q[:, 0, 0, 0] + 3,
                                            max=codec.ac_max - 1)
            return q
        codec._quantize_y = altered

    def unchanged(system):
        model = system.codec.model
        model.codecnet_synth = (lambda y, mu, pred, skip, *a, **kw:
                                pred + skip)

    def half_batch(system):
        codec = system.codec
        inner = codec.encode_frames_launch

        def launch(frames, prev, nxt, ftype, idx_rate):
            k = len(frames)
            if k >= 2:
                frames = list(frames[:k - k // 2]) + list(frames[:k // 2])
            return inner(frames, prev, nxt, ftype, idx_rate)
        codec.encode_frames_launch = launch

    return {"token": token, "unchanged": unchanged,
            "half_batch": half_batch}[name]
