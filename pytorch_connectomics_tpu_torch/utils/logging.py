"""Scalar logging to an append-only ``metrics.jsonl`` in the run dir, the
port of ``MetricsLogger`` in ``pytorch_connectomics_tpu/utils/logging.py:28``.

Backends: ``jsonl`` (default) and ``none``. ``tensorboard`` and ``wandb``
are not ported; like the JAX logger when they are unavailable, they fall
back to jsonl with a warning, so training never fails on a logging backend.
"""

from __future__ import annotations

import json
import logging
import time
from pathlib import Path
from typing import Any, Dict, Optional

logger = logging.getLogger(__name__)


class MetricsLogger:
    def __init__(self, out_dir: Optional[str | Path] = None, backend: str = "jsonl", wandb_cfg=None, config=None):
        self.out_dir = Path(out_dir) if out_dir else None
        self._fh = None
        if backend in ("tensorboard", "wandb") or (wandb_cfg or {}).get("use_wandb"):
            logger.warning("logging backend '%s' is not ported; using jsonl only", backend)
        if self.out_dir and backend != "none":
            self.out_dir.mkdir(parents=True, exist_ok=True)
            self._fh = open(self.out_dir / "metrics.jsonl", "a")
        self._t0 = time.time()

    def log(self, step: int, scalars: Dict[str, Any], prefix: str = "") -> None:
        rec = {"step": int(step), "time": round(time.time() - self._t0, 3)}
        for k, v in scalars.items():
            try:
                rec[prefix + k] = float(v)
            except (TypeError, ValueError):
                rec[prefix + k] = str(v)
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None
