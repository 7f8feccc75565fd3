"""Preemption handling, checkpoint retention and serving-side fault
injection.

Port of the JAX package's `resilience.py`:

- `PreemptionGuard` turns SIGTERM/SIGINT into a flag that the trainer
  polls at step boundaries; the trainer then writes a manifest-complete
  `checkpoint_<step>_preempt` and exits with `PREEMPTION_EXIT_CODE`, so a
  scheduler can tell "preempted, resume me" from a crash;
- `list_checkpoints` and `gc_checkpoints` (`train.checkpoint_keep_n`):
  after each step checkpoint the trainer keeps the newest N and never
  deletes `best_checkpoint`, `last_good` or the latest;
- `is_valid_checkpoint` and `find_latest_valid_checkpoint`: the
  inference server's hot-reload loads only manifest-complete checkpoints;
- `retry`, `compute_backoff` and `CircuitBreaker` (with
  `TransientError` and `CircuitOpenError`): the retrying HTTP client
  (`utils/http.py`) under the inference client and the rollout fleet;
- `FaultInjector`, its serving side: the HTTP faults a server answers
  with, a stale checkpoint step, crash-looping and wedged replicas for
  the fleet supervisor, killing an in-process replica and truncating a
  checkpoint.

`auto_resume` and the injector's train-side faults (they feed the health
sentinel and the step watchdog) are not ported yet (ROADMAP queue A,
item 4).
"""

import json
import os
import random
import shutil
import signal
import threading
import time
from typing import Callable, Iterable, List, Optional, Tuple, Type

from trlx_tpu_torch.utils import logging

logger = logging.get_logger(__name__)

# EX_TEMPFAIL: "temporary failure, retry later", the scheduler contract
# for "this run checkpointed itself and wants to be restarted"
PREEMPTION_EXIT_CODE = 75

MANIFEST_NAME = "manifest.json"
# the policy's state dict alone, tensors only: what a server reloads
MODEL_FILE = "model.pt"
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


class CircuitOpenError(RuntimeError):
    """The circuit breaker is open: the dependency is considered down and
    calls fail fast without touching it."""


class TransientError(RuntimeError):
    """A retryable failure (connection drop, timeout, HTTP 5xx)."""


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


def is_valid_checkpoint(directory: str) -> bool:
    """A checkpoint is valid iff its manifest exists and parses."""
    manifest = read_manifest(directory)
    return manifest is not None and "step" in manifest


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


def find_latest_valid_checkpoint(checkpoint_dir: str) -> Optional[str]:
    """Newest manifest-complete checkpoint (highest step, then newest
    wall time); incomplete ones are skipped in favour of the previous
    valid one. `best_checkpoint` is left out: it tracks the best
    evaluation, not the training frontier."""
    candidates = [
        path for _, _, path in list_checkpoints(checkpoint_dir)
        if os.path.basename(path) != "best_checkpoint"
    ]
    return candidates[-1] if candidates else None


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


# ----------------------------------------------------------------------
# Retry and circuit breaker (the HTTP client's)
# ----------------------------------------------------------------------


def compute_backoff(
    attempt: int,
    base_delay: float,
    max_delay: float,
    jitter: float,
    rng: Optional[random.Random] = None,
) -> float:
    """Exponential backoff with multiplicative jitter: delay for retry
    `attempt` (0-based) is `base * 2**attempt`, capped at `max_delay`,
    scaled by a uniform factor in [1-jitter, 1+jitter]."""
    delay = min(max_delay, base_delay * (2.0 ** attempt))
    if jitter > 0:
        u = (rng or random).uniform(1.0 - jitter, 1.0 + jitter)
        delay *= max(0.0, u)
    return delay


def retry(
    retries: int = 5,
    base_delay: float = 0.25,
    max_delay: float = 30.0,
    jitter: float = 0.5,
    max_elapsed: Optional[float] = None,
    retry_on: Tuple[Type[BaseException], ...] = (TransientError,),
    on_retry: Optional[Callable[[int, BaseException, float], None]] = None,
    sleep: Callable[[float], None] = time.sleep,
    clock: Callable[[], float] = time.monotonic,
    rng: Optional[random.Random] = None,
):
    """Decorator: retry transient failures with exponential backoff.

    :param retries: retry attempts after the first call (0 = no retries).
    :param max_elapsed: total budget in seconds across all attempts; once
        spent, the last exception is raised even if retries remain.
    :param retry_on: exception types considered transient; anything else
        propagates at once.
    :param on_retry: callback(attempt, exception, delay) before each sleep.
    :param sleep/clock/rng: injectable for deterministic tests.
    """

    def decorate(fn):
        def wrapped(*args, **kwargs):
            start = clock()
            attempt = 0
            while True:
                try:
                    return fn(*args, **kwargs)
                except retry_on as e:
                    elapsed = clock() - start
                    if attempt >= retries or (max_elapsed is not None and elapsed >= max_elapsed):
                        raise
                    delay = compute_backoff(attempt, base_delay, max_delay, jitter, rng)
                    # the dependency's own backoff hint (a 503's Retry-After)
                    # overrides a shorter local schedule, capped at max_delay
                    hint = getattr(e, "retry_after", None)
                    if hint is not None:
                        delay = min(max(delay, float(hint)), max_delay)
                    if max_elapsed is not None:
                        delay = min(delay, max(0.0, max_elapsed - elapsed))
                    if on_retry is not None:
                        on_retry(attempt, e, delay)
                    else:
                        logger.warning(
                            f"Transient failure in {getattr(fn, '__name__', fn)} "
                            f"(attempt {attempt + 1}/{retries + 1}): {e}; retrying in {delay:.2f}s"
                        )
                    sleep(delay)
                    attempt += 1

        wrapped.__name__ = getattr(fn, "__name__", "retry_wrapped")
        wrapped.__doc__ = fn.__doc__
        return wrapped

    return decorate


class CircuitBreaker:
    """Consecutive-failure circuit breaker.

    Closed: calls flow. After `failure_threshold` consecutive failures the
    breaker opens and `check()` raises `CircuitOpenError` without touching
    the dependency. After `recovery_time` seconds it half-opens: one probe
    call is allowed; success closes it, failure re-opens it. Thread-safe:
    half-open admits exactly one probe under concurrent callers.
    """

    def __init__(
        self,
        failure_threshold: int = 5,
        recovery_time: float = 30.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.failure_threshold = failure_threshold
        self.recovery_time = recovery_time
        self._clock = clock
        self.failures = 0
        self.opened_at: Optional[float] = None
        self._half_open = False
        self._lock = threading.Lock()

    @property
    def state(self) -> str:
        if self.opened_at is None:
            return "closed"
        if self._clock() - self.opened_at >= self.recovery_time:
            return "half-open"
        return "open"

    def check(self) -> None:
        """Raise CircuitOpenError if calls must fail fast."""
        with self._lock:
            state = self.state
            if state == "closed":
                return
            if state == "half-open" and not self._half_open:
                self._half_open = True  # admit exactly one probe
                return
            raise CircuitOpenError(
                f"circuit open after {self.failures} consecutive failures; retrying dependency in "
                f"{max(0.0, self.recovery_time - (self._clock() - self.opened_at)):.1f}s"
            )

    def record_success(self) -> None:
        with self._lock:
            self.failures = 0
            self.opened_at = None
            self._half_open = False

    def record_failure(self) -> None:
        with self._lock:
            self.failures += 1
            self._half_open = False
            if self.failures >= self.failure_threshold:
                if self.opened_at is None:
                    logger.warning(f"Circuit breaker OPEN after {self.failures} consecutive failures")
                self.opened_at = self._clock()


# ----------------------------------------------------------------------
# Deterministic fault injection (tests and the chip smoke's chaos runs)
# ----------------------------------------------------------------------

# the JAX injector's train-side arguments: they feed the health sentinel
# and the step watchdog, which are not ported yet
_TRAIN_FAULT_ARGS = ("nan_grad_steps", "loss_spike_steps", "hang_steps", "spike_scale", "hang_step_s")


class FaultInjector:
    """Deterministic fault schedules for servers and fleets.

    Either an explicit `schedule` (list of truthy = inject) consumed in
    order (round-robin with `cycle`), or a seeded Bernoulli `rate`. `mode`
    picks the injected failure of an HTTP server: "http_500" answers a
    transient 503, "drop" closes the connection without a response,
    "hang" holds the socket for `hang_s` then drops it (a client escapes
    only through its own timeout or a hedge), "slow" delays the correct
    answer by `slow_s` (hedging, not failover), "mixed" alternates drop
    and http_500 by injection count.

    Replica-level faults: `stale_checkpoint_step` overrides the checkpoint
    step a server reports (a replica stuck behind the weight sync), and
    `kill_replica` takes an in-process server down mid-rollout.
    Supervisor-level faults: seats in `crash_loop_replicas` are killed
    `crash_loop_after_s` after every (re)spawn, and `healthz_hang_s > 0`
    wedges a server's /healthz (held socket, no answer).

    The JAX injector's train-side faults (`nan_grad_steps`,
    `loss_spike_steps`, `hang_steps` and their knobs) are refused: they
    wait for the sentinel and the watchdog.
    """

    def __init__(
        self,
        rate: float = 0.0,
        seed: int = 0,
        schedule: Optional[List[bool]] = None,
        mode: str = "http_500",
        cycle: bool = False,
        hang_s: float = 30.0,
        slow_s: float = 0.25,
        stale_checkpoint_step: Optional[int] = None,
        crash_loop_replicas: Iterable[int] = (),
        crash_loop_after_s: float = 0.25,
        healthz_hang_s: float = 0.0,
        **train_faults,
    ):
        for name in train_faults:
            if name not in _TRAIN_FAULT_ARGS:
                raise TypeError(f"FaultInjector got an unexpected argument {name!r}")
            raise NotImplementedError(
                f"FaultInjector({name}=...): train-side faults feed the health sentinel and the step "
                "watchdog, not ported yet (ROADMAP queue A, item 4, resilience)"
            )
        self.rate = rate
        self.mode = mode
        self.schedule = list(schedule) if schedule is not None else None
        self.cycle = cycle
        self.hang_s = float(hang_s)
        self.slow_s = float(slow_s)
        self.stale_checkpoint_step = stale_checkpoint_step
        self.crash_loop_replicas = set(int(s) for s in crash_loop_replicas)
        self.crash_loop_after_s = float(crash_loop_after_s)
        self.healthz_hang_s = float(healthz_hang_s)
        self._rng = random.Random(seed)
        self._calls = 0
        self.injected = 0

    def should_fail(self) -> bool:
        i = self._calls
        self._calls += 1
        if self.schedule is not None:
            if i >= len(self.schedule):
                if not self.cycle:
                    return False
                i %= len(self.schedule)
            fail = bool(self.schedule[i])
        else:
            fail = self._rng.random() < self.rate
        if fail:
            self.injected += 1
        return fail

    @staticmethod
    def kill_replica(server) -> None:
        """Take an in-process `InferenceServer` down as a preemption
        would: the listener closes (new connections are refused) and
        in-flight requests finish as "shutdown"."""
        server.shutdown()

    @staticmethod
    def truncate_checkpoint(directory: str) -> None:
        """A preemption mid-save: delete the manifest, turning a complete
        checkpoint back into an uncommitted one."""
        path = os.path.join(directory, MANIFEST_NAME)
        if os.path.exists(path):
            os.unlink(path)
