"""Preemption handling for the learn loop.

Port of the preemption part of the JAX package's `resilience.py`:
`PreemptionGuard` turns SIGTERM/SIGINT into a flag that the trainer polls
at step boundaries; the trainer then writes a manifest-complete
`checkpoint_<step>_preempt` and exits with `PREEMPTION_EXIT_CODE`, so a
scheduler can tell "preempted, resume me" from a crash. Checkpoint
retention, `auto_resume` and the fault injector are not ported yet
(ROADMAP queue A, item 4).
"""

import signal
from typing import Optional

from trlx_tpu_torch.utils import logging

logger = logging.get_logger(__name__)

# EX_TEMPFAIL: "temporary failure, retry later", the scheduler contract
# for "this run checkpointed itself and wants to be restarted"
PREEMPTION_EXIT_CODE = 75


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
