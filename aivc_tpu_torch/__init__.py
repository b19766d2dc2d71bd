"""aivc_tpu_torch — the PyTorch/CUDA port of aivc_tpu for one NVIDIA H100.

Entry points: ``utils.checkpoint.load_checkpoint``,
``pipeline.codec.FrameCodec``, ``pipeline.video.encode_video`` and
``decode_video``; they run on the card unless the caller passes
``device="cpu"``.  Kernels are hand-written CUDA (``csrc/kernels.cu``),
built at first use by ``kernels.py``.  Nothing here imports JAX or the
JAX package.
"""
