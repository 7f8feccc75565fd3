"""Experiment tracking (port of the JAX package's `utils/tracking.py`).

The default tracker writes one JSON line of metrics per log call.
`tracker="wandb"` logs through wandb when the package is installed
(imported only then), and otherwise falls back to the JSONL tracker with
a warning, as the JAX package does.
"""

import json
import os
import time
from typing import Any, Dict, Optional

from trlx_tpu_torch.utils import logging

logger = logging.get_logger(__name__)


class Tracker:
    """No-op base tracker."""

    def __init__(self, config_dict: Dict, run_name: str, logging_dir: Optional[str] = None):
        self.run_name = run_name

    def log(self, stats: Dict[str, Any], step: int):
        pass

    def finish(self):
        pass


class JSONLTracker(Tracker):
    """Appends one JSON line of metrics per log call to
    `<logging_dir>/<run_name>.metrics.jsonl` (the config beside it)."""

    def __init__(self, config_dict: Dict, run_name: str, logging_dir: Optional[str] = None):
        super().__init__(config_dict, run_name, logging_dir)
        self.dir = logging_dir or "logs"
        os.makedirs(self.dir, exist_ok=True)
        safe_name = run_name.replace("/", "_")
        self.path = os.path.join(self.dir, f"{safe_name}.metrics.jsonl")
        with open(os.path.join(self.dir, f"{safe_name}.config.json"), "w") as f:
            json.dump(config_dict, f, indent=2, default=str)
        # one file per run: appending across reruns would interleave steps
        self._fh = open(self.path, "w")
        self._dropped: Dict[str, str] = {}
        self._meta_path = os.path.splitext(self.path)[0] + ".meta.json"

    def log(self, stats: Dict[str, Any], step: int):
        row = {"_step": step, "_time": time.time()}
        dropped = {}
        for k, v in stats.items():
            if isinstance(v, bool):
                row[k] = int(v)
                continue
            try:
                row[k] = float(v)
            except (TypeError, ValueError):
                dropped[k] = type(v).__name__
        if dropped:
            self._record_dropped(dropped)
        self._fh.write(json.dumps(row) + "\n")
        self._fh.flush()

    def _record_dropped(self, dropped: Dict[str, str]):
        """Non-numeric stats cannot go on a curve: record each dropped key
        (with its type) once in a `.meta.json` sidecar."""
        new = {k: t for k, t in dropped.items() if k not in self._dropped}
        if not new:
            return
        self._dropped.update(new)
        with open(self._meta_path, "w") as f:
            json.dump({"dropped_keys": self._dropped}, f, indent=2, sort_keys=True)

    def finish(self):
        self._fh.close()


class WandbTracker(Tracker):
    """Logs to a wandb run (`wandb.init` with the run's config)."""

    def __init__(self, config_dict: Dict, run_name: str, logging_dir: Optional[str] = None,
                 project: str = "trlx_tpu", entity: Optional[str] = None,
                 group: Optional[str] = None, tags=None):
        super().__init__(config_dict, run_name, logging_dir)
        import wandb

        self.run = wandb.init(
            project=project, name=run_name, entity=entity, group=group,
            tags=tags, config=config_dict, dir=logging_dir,
        )
        self.wandb = wandb

    def log(self, stats: Dict[str, Any], step: int):
        self.wandb.log(stats, step=step)

    def finish(self):
        self.run.finish()


def get_tracker(name: Optional[str], config_dict: Dict, run_name: str,
                logging_dir: Optional[str] = None, **kwargs) -> Tracker:
    if name in (None, "none", "jsonl"):
        return JSONLTracker(config_dict, run_name, logging_dir)
    if name == "wandb":
        try:
            return WandbTracker(config_dict, run_name, logging_dir, **kwargs)
        except ImportError:
            logger.warning("wandb not installed; falling back to JSONL tracker")
            return JSONLTracker(config_dict, run_name, logging_dir)
    if name == "tensorboard":
        logger.warning("tensorboard tracker not available in this build; using JSONL")
        return JSONLTracker(config_dict, run_name, logging_dir)
    raise ValueError(f"Unknown tracker: {name}")
