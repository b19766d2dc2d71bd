"""Evaluation: the committed photo pools (``photos``), the held-out
clips (``clips``) and the golden runner (``golden``, ``python -m
aivc_tpu_torch.eval.golden``); ``make_photo_pool`` rebuilds the pool
file on a host that has the asset packages."""
