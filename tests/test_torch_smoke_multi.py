"""Rehearsal of chip_smoke.py's multidevice phase on the host, with
tiny-toy at 64x64 (the card runs it with bf16-r5 at 1080p): two gloo
ranks against this process, through smoke.multidevice_runs's own checks
(the pinned round-robin stream equal to one process's, every stream
decoded bit-exactly against the ranks' reconstructions, the train step
with a whole microbatch a rank and with one microbatch split over the
ranks and with the rows split over 'spatial' within train-small's
float32 limits, the ranks' parameters equal, the mesh codec over
'spatial' decoded bit-exactly).
On the host every coding net is float32, so the unpinned round-robin
and the mesh codec (over 'data' and over 'spatial') also equal one
process's streams here."""

from pathlib import Path

import pytest
import torch

from aivc_tpu_torch import smoke
from aivc_tpu_torch.pipeline.codec import FrameCodec
from aivc_tpu_torch.pipeline.video import encode_video, synthetic_frames
from aivc_tpu_torch.utils.checkpoint import load_checkpoint

ROOT = Path(__file__).resolve().parents[1]
CKPT = str(ROOT / "models_ckpt" / "tiny-toy")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Test workers share the host's cores: a small PyTorch pool keeps
    them from oversubscribing it (spinning OpenMP threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_multidevice_rehearsed(tmp_path):
    dev = torch.device("cpu")
    mesh_frames = synthetic_frames(9, 64, 64)
    one = encode_video(FrameCodec(*load_checkpoint(CKPT, device=dev), 64, 64,
                                  device=dev), mesh_frames, smoke.ra_coding(8),
                       wave_batch=8).bitstream
    rr_frames = synthetic_frames(17, 64, 64)
    md = smoke.multidevice_runs(CKPT, dev, tmp_path, rr_frames, mesh_frames,
                                one, train_size=64, train_idx_rate=1)
    rr = md["rr"]
    assert rr["pinned"]["equal"] and rr["free"]["equal"]
    assert rr["pinned"]["ks"] == [smoke.MULTI_PIN_K] * 20
    assert rr["free"]["ks"] == rr["free"]["one_ks"]
    assert md["mesh"]["equal"] and md["mesh"]["one_decode_differs"] == 0
    assert md["mesh"]["psnr"] == md["mesh"]["one_psnr"]
    assert all(s > 0 for s in md["mesh"]["comm_s"])
    # parameters equal across the ranks: multidevice_runs raises if not.
    # Whole microbatches a rank: the one-process sums, other order;
    # the batch split: each rank's convolutions see a batch of one
    # (test_torch_parallel.py's limits for that layout).
    whole = md["train"]["microbatch_per_rank"]
    assert whole["worst_leaf_rel_l2"][1] <= 1e-5
    assert whole["diffs"]["loss"] == 0.0
    split = md["train"]["split_microbatch"]
    assert split["worst_leaf_rel_l2"][1] <= 1e-3
    assert split["diffs"]["loss"] <= 1e-5
    # Rows over 'spatial': the halo exchanges and the row gathers ran,
    # and the stream is one process's; the train step's shares sum to
    # the one-process step (measured: logs equal, worst leaf 2.7e-5).
    sp = md["spatial"]
    assert sp["equal"] and sp["one_decode_differs"] == 0
    assert all(s > 0 for s in sp["halo_s"] + sp["gather_s"])
    assert sp["band_warp"] is None
    rows = md["train"]["spatial"]
    assert rows["worst_leaf_rel_l2"][1] <= 1e-4
    assert rows["diffs"]["loss"] <= 1e-6
    # the plain versions run on the host: no kernel launches
    assert all(v == 0 for la in md["launches"] + sp["launches"]
               for v in la.values())
