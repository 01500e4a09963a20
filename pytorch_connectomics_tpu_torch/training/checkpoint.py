"""Checkpoints as torch ``.pt`` files: top-k by a monitored metric plus
``last``, metadata with the config hash. The port of ``CheckpointManager``
and ``check_config_hash`` in
``pytorch_connectomics_tpu/training/checkpoint.py:25-183``.

Layout under ``<run_dir>/checkpoints/``, the JAX run dir's names with a
torch file in place of the Orbax ``state`` directory::

    last/state.pt, last/metadata.json
    epoch=001-train_loss_total_epoch=0.4321/state.pt, .../metadata.json
    index.json      top-k entries, best first

``state.pt`` holds ``{"model": state_dict, "optimizer": state_dict,
"step": int, "ema": {name: tensor} | None, "lr_scale": float, "balancer":
tensor | None, "log_vars": tensor | None, "accum": [tensor] | None}`` (the
GradNorm state, the uncertainty balancer's log-variances and the gradient
accumulation's running mean);
``metadata.json`` holds ``config_hash``, ``epoch``, ``step`` and the
metrics.
"""

from __future__ import annotations

import json
import logging
import shutil
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch

logger = logging.getLogger(__name__)

STATE_FILE = "state.pt"


def state_file(path: str | Path) -> Path:
    """The ``state.pt`` of a checkpoint directory (or the file itself)."""
    p = Path(path)
    return p / STATE_FILE if p.is_dir() else p


def is_checkpoint_dir(path: str | Path) -> bool:
    return (Path(path) / STATE_FILE).is_file()


class CheckpointManager:
    def __init__(
        self,
        directory: str | Path,
        save_top_k: int = 1,
        monitor: str = "train_loss_total_epoch",
        mode: str = "min",
        save_last: bool = True,
        filename_prefix: Optional[str] = None,
    ):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.save_top_k = save_top_k
        self.monitor = monitor
        self.mode = mode
        self.save_last = save_last
        self.filename_prefix = f"{filename_prefix}-" if filename_prefix else ""
        self._index_path = self.dir / "index.json"
        self._index: List[Dict[str, Any]] = []
        if self._index_path.exists():
            self._index = json.loads(self._index_path.read_text())

    # -- save --------------------------------------------------------------

    @staticmethod
    def state_dict(state) -> Dict[str, Any]:
        return {
            "model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "step": int(state.step),
            "ema": state.ema,
            "lr_scale": float(state.lr_scale),
            "balancer": state.balancer,
            "log_vars": state.log_vars.detach() if state.log_vars is not None else None,
            "accum": getattr(state, "accum", None),
        }

    def _save_tree(self, path: Path, payload: Dict[str, Any], metadata: Dict[str, Any]) -> None:
        tmp = path.with_name(path.name + ".tmp")
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        torch.save(payload, tmp / STATE_FILE)
        (tmp / "metadata.json").write_text(json.dumps(metadata, default=str))
        if path.exists():
            shutil.rmtree(path)
        tmp.rename(path)

    def save(self, state, epoch: int, metrics: Dict[str, float], metadata: Optional[Dict[str, Any]] = None) -> Optional[Path]:
        meta = dict(metadata or {})
        meta.update({"epoch": epoch, "metrics": metrics})
        payload = self.state_dict(state)
        score = metrics.get(self.monitor)
        saved = None
        if score is not None and self.save_top_k != 0 and self._is_topk(score):
            name = f"{self.filename_prefix}epoch={epoch:03d}-{self.monitor}={score:.4f}"
            self._save_tree(self.dir / name, payload, meta)
            self._index = [e for e in self._index if e["path"] != name]
            self._index.append({"path": name, "score": float(score), "epoch": epoch})
            self._prune()
            saved = self.dir / name
        if self.save_last:
            self._save_tree(self.dir / "last", payload, meta)
        self._index_path.write_text(json.dumps(self._index))
        return saved

    def _is_topk(self, score: float) -> bool:
        if self.save_top_k < 0 or len(self._index) < self.save_top_k:
            return True
        scores = [e["score"] for e in self._index]
        worst = max(scores) if self.mode == "min" else min(scores)
        return score < worst if self.mode == "min" else score > worst

    def _prune(self) -> None:
        self._index.sort(key=lambda e: e["score"], reverse=self.mode == "max")
        if self.save_top_k >= 0:
            for entry in self._index[self.save_top_k:]:
                p = self.dir / entry["path"]
                if p.exists():
                    shutil.rmtree(p)
            self._index = self._index[: self.save_top_k]

    # -- restore -----------------------------------------------------------

    def best_path(self) -> Optional[Path]:
        return self.dir / self._index[0]["path"] if self._index else None

    def last_path(self) -> Optional[Path]:
        p = self.dir / "last"
        return p if is_checkpoint_dir(p) else None

    @staticmethod
    def load(path: str | Path) -> Dict[str, Any]:
        return torch.load(state_file(path), map_location="cpu", weights_only=True)

    @classmethod
    def restore(cls, path: str | Path, state, reset_optimizer: bool = False, reset_epoch: bool = False) -> None:
        """Load a checkpoint into ``state`` in place; ``reset_optimizer``
        keeps the fresh optimizer state, ``reset_epoch`` the fresh step."""
        ck = cls.load(path)
        state.model.load_state_dict(ck["model"])
        if not reset_optimizer:
            state.optimizer.load_state_dict(ck["optimizer"])
        if not reset_epoch:
            state.step = int(ck["step"])
        state.lr_scale = float(ck.get("lr_scale", 1.0))
        if state.balancer is not None and ck.get("balancer") is not None:
            state.balancer = ck["balancer"].to(state.balancer.device)
        if state.log_vars is not None and ck.get("log_vars") is not None:
            with torch.no_grad():
                state.log_vars.copy_(ck["log_vars"])
        if not reset_optimizer and ck.get("accum") is not None:
            dev = next(state.model.parameters()).device
            state.accum = [a.to(dev) for a in ck["accum"]]
        if state.ema is not None:
            src = ck.get("ema") or ck["model"]
            for n, t in state.ema.items():
                t.copy_(src[n])

    @classmethod
    def restore_params_only(cls, path: str | Path, model: torch.nn.Module, use_ema: bool = False) -> int:
        """Load the model weights only (the EMA copy when ``use_ema`` and the
        checkpoint has one), independent of the optimizer the checkpoint was
        trained with. Returns the checkpoint's step."""
        ck = cls.load(path)
        model.load_state_dict(ck["ema"] if use_ema and ck.get("ema") else ck["model"])
        return int(ck["step"])

    @staticmethod
    def read_metadata(path: str | Path) -> Dict[str, Any]:
        p = Path(path)
        if p.is_file():
            p = p.parent
        mp = p / "metadata.json"
        return json.loads(mp.read_text()) if mp.exists() else {}


def check_config_hash(metadata: Dict[str, Any], expected_hash: str) -> bool:
    """False, with a warning, when the checkpoint was saved under another
    config; True when the hashes agree or the checkpoint has none."""
    got = metadata.get("config_hash")
    if got and got != expected_hash:
        logger.warning("checkpoint config hash %s != current config hash %s", got, expected_hash)
        return False
    return True
