"""Per-frame results table (the ``FrameResultLogger`` of
aivc_tpu/utils/logging.py; ``detailed.txt`` and ``detailed.jsonl`` are
the same bytes for the same frame results).

Parity with the reference's per-frame table (reference:
src/func_util/result_logging.py:22-61: rate split, alpha / beta columns),
also written as machine-readable JSON lines.
"""

from __future__ import annotations

import json
from dataclasses import asdict
from pathlib import Path
from typing import Optional


class FrameResultLogger:
    """Writes per-frame coding results as aligned text + JSONL."""

    # "type" is not a FrameResult field (it is "frame_type"), so that
    # column is blank, as in the JAX package's table.
    COLUMNS = ("idx", "type", "bytes", "bpp", "mode_bytes", "codec_bytes",
               "alpha_mean", "beta_mean")

    def __init__(self, log_dir: Optional[str | Path] = None):
        self.log_dir = Path(log_dir) if log_dir else None
        if self.log_dir:
            self.log_dir.mkdir(parents=True, exist_ok=True)
            self._txt = open(self.log_dir / "detailed.txt", "w")
            self._jsonl = open(self.log_dir / "detailed.jsonl", "w")
            header = " ".join(f"{c:>12}" for c in self.COLUMNS)
            self._txt.write(header + "\n")
        else:
            self._txt = self._jsonl = None

    def log(self, frame_result) -> None:
        d = asdict(frame_result)
        if self._txt:
            row = " ".join(
                f"{d.get(c, ''):>12.4f}" if isinstance(d.get(c), float)
                else f"{d.get(c, ''):>12}" for c in self.COLUMNS)
            self._txt.write(row + "\n")
            self._jsonl.write(json.dumps(d) + "\n")

    def close(self):
        for f in (self._txt, self._jsonl):
            if f:
                f.close()
