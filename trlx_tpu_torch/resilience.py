"""Preemption handling and checkpoint retention for the learn loop.

Port of two parts of the JAX package's `resilience.py`:

- `PreemptionGuard` turns SIGTERM/SIGINT into a flag that the trainer
  polls at step boundaries; the trainer then writes a manifest-complete
  `checkpoint_<step>_preempt` and exits with `PREEMPTION_EXIT_CODE`, so a
  scheduler can tell "preempted, resume me" from a crash;
- `list_checkpoints` and `gc_checkpoints` (`train.checkpoint_keep_n`):
  after each step checkpoint the trainer keeps the newest N and never
  deletes `best_checkpoint`, `last_good` or the latest.

`auto_resume` and the fault injector are not ported yet (ROADMAP queue
A, item 4).
"""

import json
import os
import shutil
import signal
from typing import List, Optional, Tuple

from trlx_tpu_torch.utils import logging

logger = logging.get_logger(__name__)

# EX_TEMPFAIL: "temporary failure, retry later", the scheduler contract
# for "this run checkpointed itself and wants to be restarted"
PREEMPTION_EXIT_CODE = 75

MANIFEST_NAME = "manifest.json"
# never removed by retention: the best evaluation's checkpoint and the
# sentinel's rewind target
PROTECTED_CHECKPOINT_NAMES = ("best_checkpoint", "last_good")


class PreemptionInterrupt(BaseException):
    """Raised at a step boundary after a preemption signal. A
    BaseException (like KeyboardInterrupt), so an `except Exception` in
    user reward or metric code cannot swallow it."""

    def __init__(self, signum: int):
        self.signum = signum
        super().__init__(f"preempted by signal {signum}")


class PreemptionGuard:
    """Convert SIGTERM/SIGINT into a pollable flag.

    Installed around `learn()`: the handler only records the signal (it
    must not touch the model or the card mid-step); the trainer polls
    `triggered` at step boundaries. A second SIGINT falls through to the
    previous handler, so a double ctrl-C still kills a hung run. Off the
    main thread no OS handler can be installed: the guard warns and stays
    pollable (a test sets it by calling its handler).
    """

    SIGNALS = (signal.SIGTERM, signal.SIGINT)

    def __init__(self):
        self.triggered = False
        self.signum: Optional[int] = None
        self._previous = {}

    def handler(self, signum, frame):
        if self.triggered and signum == signal.SIGINT:
            previous = self._previous.get(signum)
            if callable(previous):
                previous(signum, frame)
                return
            raise KeyboardInterrupt
        self.triggered = True
        self.signum = signum
        logger.warning(f"Received signal {signum}: requesting an emergency checkpoint at the next step boundary")

    def install(self) -> "PreemptionGuard":
        for signum in self.SIGNALS:
            try:
                self._previous[signum] = signal.signal(signum, self.handler)
            except ValueError:  # not the main thread
                logger.warning_once("PreemptionGuard installed off the main thread; OS signals will not be intercepted")
        return self

    def uninstall(self) -> None:
        for signum, previous in self._previous.items():
            signal.signal(signum, previous)
        self._previous = {}

    def __enter__(self) -> "PreemptionGuard":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()


def read_manifest(directory: str) -> Optional[dict]:
    try:
        with open(os.path.join(directory, MANIFEST_NAME)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def list_checkpoints(checkpoint_dir: str) -> List[Tuple[int, float, str]]:
    """Every manifest-complete checkpoint under `checkpoint_dir`, as
    (step, wall_time, path), oldest first."""
    if not os.path.isdir(checkpoint_dir):
        return []
    out = []
    for name in os.listdir(checkpoint_dir):
        if name.endswith((".tmp", ".old")):
            continue
        path = os.path.join(checkpoint_dir, name)
        if not os.path.isdir(path):
            continue
        manifest = read_manifest(path)
        if manifest is None or "step" not in manifest:
            continue
        out.append((int(manifest["step"]), float(manifest.get("wall_time", 0.0)), path))
    return sorted(out)


def gc_checkpoints(checkpoint_dir: str, keep_n: int) -> List[str]:
    """Keep the newest `keep_n` step checkpoints (the latest always), never
    deleting a protected one; keep_n <= 0 keeps everything. Returns the
    deleted paths."""
    if keep_n <= 0:
        return []
    candidates = [
        (step, wall, path)
        for step, wall, path in list_checkpoints(checkpoint_dir)
        if os.path.basename(path) not in PROTECTED_CHECKPOINT_NAMES
    ]
    deleted = []
    for _, _, path in candidates[:-keep_n]:
        shutil.rmtree(path, ignore_errors=True)
        deleted.append(path)
    if deleted:
        logger.info(f"Checkpoint GC: removed {len(deleted)} old checkpoint(s), keeping newest {keep_n} + protected")
    return deleted
