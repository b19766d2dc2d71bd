"""GOP round-robin over torch.distributed (counterpart of
aivc_tpu/parallel/multihost.py): the GOPs of a sequence spread over the
process group, their bytes exchanged with an all-gather, the stream
muxed on every rank.

Each GOP chunk is self-contained after the video header (it starts with
its own I-frame and decodes against its own reconstructions), so rank p
encodes the GOPs with ``index % world == p``, and the chunks come back in
GOP order on every rank.

Bytes: every rank must build the same FrameCodec (checkpoint, size, wave
batch).  The stream count K of a wave follows the payloads of the earlier
waves of its type that this codec coded (WaveCodec._pick_k), and a rank
that codes every n-th GOP has another history than a single process:
where K moves with the history (1080p), the bytes depend on the number
of ranks.  AIVC_VRANS_K pins K, and with it the bytes.  K travels in the
stream, so every GOP decodes bit-exactly either way.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from aivc_tpu_torch.coding import bitstream as bs
from aivc_tpu_torch.config import CodingConfig
from aivc_tpu_torch.gop import generate_gop_struct
from aivc_tpu_torch.parallel.mesh import comm_device
from aivc_tpu_torch.pipeline.codec import FrameCodec
from aivc_tpu_torch.pipeline.video import FrameResult, encode_gop
from aivc_tpu_torch.pipeline.wave import DecodedFrame


def _group_up() -> bool:
    return dist.is_available() and dist.is_initialized()


def _allgather_bytes(chunks: List[bytes], group=None) -> List[List[bytes]]:
    """All-gather a list of byte strings from every rank of ``group``
    (the default group): ``out[p]`` is the list rank p contributed, on
    every rank.  Length-prefixed uint8 payloads padded to the largest
    over the group, as tensors (two all_gathers: sizes, then payloads)."""
    payload = bytearray(len(chunks).to_bytes(4, "big"))
    for c in chunks:
        payload.extend(len(c).to_bytes(4, "big"))
        payload.extend(c)
    if not _group_up():
        gathered = [bytes(payload)]
    else:
        dev = comm_device(group)
        world = dist.get_world_size(group)
        local = torch.frombuffer(bytearray(payload), dtype=torch.uint8)
        n = torch.tensor([local.numel()], dtype=torch.int64, device=dev)
        sizes = [torch.zeros_like(n) for _ in range(world)]
        dist.all_gather(sizes, n, group=group)
        sizes = [int(s) for s in sizes]
        padded = torch.zeros(max(sizes), dtype=torch.uint8, device=dev)
        padded[:local.numel()] = local.to(dev)
        parts = [torch.empty_like(padded) for _ in range(world)]
        dist.all_gather(parts, padded, group=group)
        gathered = [p[:s].cpu().numpy().tobytes()
                    for p, s in zip(parts, sizes)]

    out: List[List[bytes]] = []
    for buf in gathered:
        cnt = int.from_bytes(buf[:4], "big")
        pos = 4
        lst = []
        for _ in range(cnt):
            ln = int.from_bytes(buf[pos:pos + 4], "big")
            pos += 4
            lst.append(buf[pos:pos + ln])
            pos += ln
        out.append(lst)
    return out


def encode_video_multihost(codec: FrameCodec,
                           frames: Sequence[Dict[str, np.ndarray]],
                           coding: CodingConfig, wave_batch: int = 1,
                           decoded: Optional[Dict[int, DecodedFrame]] = None
                           ) -> bytes:
    """Encode a sequence with its GOPs spread over the process group
    (one process and no group: all of them here).  Every rank sees the
    full ``frames`` (frames of other ranks' GOPs are never touched) and
    encodes the GOP indices congruent to its rank; the muxed bitstream is
    returned on every rank.  ``decoded``, where given, receives this
    rank's reconstructions by frame index."""
    n_proc = dist.get_world_size() if _group_up() else 1
    proc = dist.get_rank() if _group_up() else 0

    name = coding.gop_struct_name()
    gop = generate_gop_struct(name)
    gop_len = len(gop)
    n_frames = len(frames)
    nb_gop = -(-n_frames // gop_len)

    my_chunks: List[bytes] = []
    results: List[FrameResult] = []
    for g in range(proc, nb_gop, n_proc):
        start = g * gop_len
        gop_frames = [frames[min(start + i, n_frames - 1)]
                      for i in range(gop_len)]
        gop_bytes, dec = encode_gop(codec, gop, gop_frames, coding.idx_rate,
                                    start, results, wave_batch=wave_batch)
        my_chunks.append(gop_bytes)
        if decoded is not None:
            decoded.update({k: v for k, v in dec.items() if k < n_frames})

    per_proc = _allgather_bytes(my_chunks)
    ordered: List[bytes] = [b""] * nb_gop
    for p in range(n_proc):
        for j, chunk in enumerate(per_proc[p]):
            ordered[p + j * n_proc] = chunk
    if any(len(c) == 0 for c in ordered):
        raise RuntimeError("missing GOP chunk after all-gather")

    header = codec.video_header(nb_gop, 0, n_frames - 1,
                                wave_batch=wave_batch)
    return bs.pack_video(header, ordered)
