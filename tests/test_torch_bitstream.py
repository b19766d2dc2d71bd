"""The frame container's trailers on the host: a frame cut inside the DC
trailer or inside the debug-digest trailer raises ValueError naming the
trailer; whole frames round-trip through pack_frame / unpack_frame."""

import hashlib

import pytest
import torch

from aivc_tpu_torch.coding import bitstream as tbs

CHUNKS = {"codecnet_z": b"\x81\x01\x02abc", "mofnet_z": b"xyz",
          "codecnet_y": b"\x00" * 7}
DC = (3, -4, 127)
DIGESTS = {"codecnet_z": hashlib.md5(b"z").digest(),
           "codecnet_y": hashlib.md5(b"y").digest()}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Test workers share the host's cores: a small PyTorch pool keeps
    them from oversubscribing it (spinning OpenMP threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _expected(chunks, dc, digests):
    out = {name: chunks.get(name, b"") for name in tbs.CHUNK_ORDER}
    if dc is not None:
        out["__dc__"] = dc
    if digests:
        out["__digests__"] = dict(digests)
    return out


@pytest.mark.parametrize("dc,digests", [(None, None), (DC, None),
                                        (None, DIGESTS), (DC, DIGESTS)])
def test_whole_frames_round_trip(dc, digests):
    fb = tbs.pack_frame(CHUNKS, digests, dc=dc)
    assert tbs.unpack_frame(fb) == _expected(CHUNKS, dc, digests)


@pytest.mark.parametrize("cut", [1, 2, 3])
def test_cut_dc_trailer_raises(cut):
    fb = tbs.pack_frame(CHUNKS, None, dc=DC)
    with pytest.raises(ValueError, match="truncated DC trailer"):
        tbs.unpack_frame(fb[:-cut])


@pytest.mark.parametrize("cut", [1, 16, 17, 18, 33])
def test_cut_debug_trailer_raises(cut):
    # 2 + 2 * 17 = 36 trailer bytes: cuts inside the second digest, at
    # its index byte, inside the first digest, and down to the count.
    fb = tbs.pack_frame(CHUNKS, DIGESTS, dc=DC)
    with pytest.raises(ValueError, match="truncated debug trailer"):
        tbs.unpack_frame(fb[:-cut])


def test_cut_after_dc_before_digests_raises():
    """Magic of the debug trailer present, its count byte cut off."""
    fb = tbs.pack_frame(CHUNKS, None, dc=DC) + bytes([
        tbs.DEBUG_TRAILER_MAGIC])
    with pytest.raises(ValueError, match="truncated debug trailer"):
        tbs.unpack_frame(fb)
