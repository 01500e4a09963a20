"""The crash-safe resume manifest of chunked inference, the port of
``pytorch_connectomics_tpu/chunked/manifest.py``: a JSON file of the
chunk keys written so far and the run's signature, replaced atomically
(temporary file, then rename) after each chunk. A manifest whose
signature differs from the run's is deleted, and every chunk recomputed."""

from __future__ import annotations

import json
import os
import tempfile
from pathlib import Path
from typing import Any, Dict, Optional, Set


class ResumeManifest:
    def __init__(self, path: str | Path, config_signature: Optional[Dict[str, Any]] = None):
        self.path = Path(path)
        self.signature = config_signature or {}
        self._done: Set[str] = set()
        if self.path.exists():
            data = json.loads(self.path.read_text())
            if config_signature and data.get("signature") != self.signature:
                self.path.unlink()
            else:
                self._done = set(data.get("done", []))

    def is_done(self, key: str) -> bool:
        return key in self._done

    @property
    def completed(self) -> Set[str]:
        return set(self._done)

    def mark_done(self, key: str) -> None:
        self._done.add(key)
        self._flush()

    def _flush(self) -> None:
        self.path.parent.mkdir(parents=True, exist_ok=True)
        payload = json.dumps({"signature": self.signature, "done": sorted(self._done)})
        fd, tmp = tempfile.mkstemp(dir=self.path.parent, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                f.write(payload)
            os.replace(tmp, self.path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
