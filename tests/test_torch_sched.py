"""The compute-schedule byte of the port (pipeline/codec.py) against
aivc_tpu's FrameCodec (codec.py:169-218, 1865-1891), on the host.

* For all 32 settings of AIVC_PACKED_HEAD, AIVC_GDN_LOWP, AIVC_MAPS_CM,
  AIVC_S2D and AIVC_DC_OFFSET, the port's ``sched_bits`` equals JAX's
  ``FrameCodec(...).sched_bits``, a stream the port writes carries it,
  and a codec built with the defaults refuses any other byte with JAX's
  message, word for word.

The two bits that change the values: test_torch_sched_values.py.
"""

import itertools

import pytest

import torch

from aivc_tpu_torch.coding import bitstream as tbs
from aivc_tpu_torch.pipeline import video as tvideo
from aivc_tpu_torch.pipeline.codec import SCHED_SWITCHES, FrameCodec
from test_torch_dense_v1 import (H, R5, TINY, W, _coding, _jax_codec, env,
                                 models)  # noqa: F401

SETTINGS = list(itertools.product("01", repeat=5))


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Test workers share the host's cores: a small PyTorch pool keeps
    them from oversubscribing it (spinning OpenMP threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def defaults(models):
    return FrameCodec(*models["tiny"], H, W, device="cpu"), _jax_codec(
        TINY, H, W)


@pytest.mark.parametrize("setting", SETTINGS,
                         ids=["".join(s) for s in SETTINGS])
def test_schedule_byte_equals_jax(models, defaults, setting):
    switches = dict(zip(SCHED_SWITCHES, setting))
    with env(**switches):
        ours = FrameCodec(*models["tiny"], H, W, device="cpu")
        ref = _jax_codec(TINY, H, W)
    assert ours.sched_bits == ref.sched_bits
    assert ours.sched_bits == sum(int(v) << i for i, v in enumerate(setting))
    frames = tvideo.synthetic_frames(1, H, W)
    enc = tvideo.encode_video(ours, frames, _coding(1, "AI"), wave_batch=1)
    header, _ = tbs.unpack_video(enc.bitstream)
    assert header.sched == ref.sched_bits
    port_default, jax_default = defaults
    if header.sched == port_default.sched_bits:
        tvideo.decode_video(port_default, enc.bitstream)
        return
    with pytest.raises(ValueError) as ours_err:
        port_default.check_sched(header)
    with pytest.raises(ValueError) as ref_err:
        jax_default.check_sched(header)
    assert str(ours_err.value) == str(ref_err.value)
    for i, name in enumerate(SCHED_SWITCHES):
        assert f"{name}={setting[i]}" in str(ours_err.value)
