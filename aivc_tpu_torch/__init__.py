"""aivc_tpu_torch — the PyTorch/CUDA port of aivc_tpu for one NVIDIA H100.

Entry points: the command line, ``python -m aivc_tpu_torch`` (``cli.py``,
``--cpu`` for the host), training, ``python -m aivc_tpu_torch.train``
(``train/run.py``, ``--cpu`` for the host), and the library:
``utils.checkpoint.load_checkpoint``, ``models.zoo``,
``pipeline.codec.FrameCodec``, ``pipeline.video.encode_video`` and
``decode_video``, ``train.trainer.make_train_step``; they run on the
card unless the caller passes ``device="cpu"``.  Kernels are
hand-written CUDA (``csrc/kernels.cu``), built at first use by
``kernels.py``; the host range coder (``native/range_coder.cpp``) by
``coding/range_coder.py``.  Nothing here imports JAX or the JAX
package.
"""

from aivc_tpu_torch.device import settle_host_math

settle_host_math()
