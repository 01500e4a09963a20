"""An append-only JSON-lines log of decode and tuning runs (the port of
``pytorch_connectomics_tpu/decoding/experiment_log.py``): one record a run
with its time, kind, config hash, parameters, metrics and notes."""

from __future__ import annotations

import datetime
import json
from pathlib import Path
from typing import Any, Dict, List, Optional


class ExperimentLog:
    def __init__(self, path: str | Path = "experiments.jsonl"):
        self.path = Path(path)

    def append(self, kind: str, config_hash: str = "", params: Optional[Dict[str, Any]] = None,
               metrics: Optional[Dict[str, float]] = None, notes: str = "") -> None:
        record = {"time": datetime.datetime.now().isoformat(timespec="seconds"), "kind": kind,
                  "config_hash": config_hash, "params": params or {}, "metrics": metrics or {}, "notes": notes}
        self.path.parent.mkdir(parents=True, exist_ok=True)
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")

    def entries(self) -> List[Dict[str, Any]]:
        if not self.path.exists():
            return []
        return [json.loads(line) for line in self.path.read_text().splitlines() if line]

    def best(self, metric: str, minimize: bool = True) -> Optional[Dict[str, Any]]:
        """The first entry with the lowest (``minimize``) or highest ``metric``; None without one."""
        rows = [e for e in self.entries() if metric in e.get("metrics", {})]
        if not rows:
            return None
        return (min if minimize else max)(rows, key=lambda e: e["metrics"][metric])
