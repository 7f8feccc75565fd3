"""Training health sentinel: anomaly detection and automatic recovery.

Port of the JAX package's `sentinel.py` (plain Python and numpy, copied
so the port imports nothing of that package). The resilience layer
(`resilience.py`) makes a run survive its environment (preemptions,
flaky reward servers, dead replicas); this module makes it survive the
training itself: NaN gradients, loss and KL spikes, reward outliers,
degenerate rollouts and hangs. Four layers:

1. **Gradient guard** (in `trainer/base_trainer.py:optimizer_step`):
   the global gradient norm, in f32 over the trainable parameters'
   gradients, is read on the host once a step; a step whose norm is
   not finite (or above `train.grad_skip_threshold`) skips
   `optimizer.step()` and the scheduler's step, so the parameters, the
   optimizer state and the LR schedule stay as they were. Reported as
   `train/grad_global_norm` and `train/skipped_updates`.
2. **Rolling anomaly detection** (`HealthSentinel.observe_step`):
   median/MAD z-scores over a window of clean history for the loss, the
   gradient norm, approx_kl, the reward mean and the entropy, escalating
   `warn -> skip-chunk -> rewind -> abort`.
3. **Rewind-and-skip**: the sentinel pins a `last_good` checkpoint after
   N consecutive clean steps; on escalation the trainer restores it,
   moves its sampling generator off the pinned stream, damps the LR and
   boosts the KL coefficient for a cooldown window, and spends one of
   `train.max_rewinds` before it falls through to abort.
4. **Hang watchdog** (`StepWatchdog`): a heartbeat thread that, when no
   step boundary arrives within `train.step_timeout_s`, dumps every
   thread's stack through `faulthandler` and exits with code 75
   (EX_TEMPFAIL), so `train.auto_resume` takes over.

The sentinel's state (windows, streaks, budget, cooldown, the last-good
pointer) rides in the checkpoint's `state.pt` as plain dicts, lists and
numbers, so a resumed run continues the ladder where it left off.
"""

import faulthandler
import math
import os
import sys
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from trlx_tpu_torch.resilience import PREEMPTION_EXIT_CODE
from trlx_tpu_torch.utils import logging

logger = logging.get_logger(__name__)

# Basename of the pinned checkpoint under train.checkpoint_dir; carved
# out of gc_checkpoints retention (resilience.PROTECTED_CHECKPOINT_NAMES).
LAST_GOOD_NAME = "last_good"

# Escalation rungs, mildest first.
ACTIONS = ("ok", "warn", "skip", "rewind", "abort")


class SentinelRewind(BaseException):
    """Control-flow signal: unwind the learn loop to restore `last_good`.

    Derives from BaseException (like PreemptionInterrupt) so `except
    Exception` blocks in user reward/metric code cannot swallow it."""

    def __init__(self, step: int, reasons: Sequence[str]):
        self.step = step
        self.reasons = list(reasons)
        super().__init__(f"sentinel rewind at step {step}: {'; '.join(self.reasons)}")


class RollingStat:
    """Robust rolling statistics for one metric: a bounded window of clean
    history scored with median/MAD z-scores (outlier-proof, unlike
    mean/std — one spike cannot drag the baseline toward itself, because
    anomalous samples are never pushed into the window)."""

    def __init__(self, window: int, warmup: int):
        self.values: deque = deque(maxlen=max(int(window), 1))
        self.warmup = max(int(warmup), 1)

    def __len__(self) -> int:
        return len(self.values)

    @property
    def ready(self) -> bool:
        return len(self.values) >= self.warmup

    def zscore(self, value: float) -> float:
        """Robust z-score of `value` against the current window; 0.0
        until warmup, +inf for non-finite values."""
        if not math.isfinite(value):
            return float("inf")
        if not self.ready:
            return 0.0
        arr = np.asarray(self.values, dtype=np.float64)
        med = float(np.median(arr))
        # 1.4826 * MAD estimates sigma for a normal; the relative floor
        # keeps a tight window (a freshly-warmed 2-value window, or a
        # constant-valued one at toy scale) from turning ordinary run-to-
        # run float variation into enormous z-scores — the sentinel hunts
        # catastrophes (NaN, orders-of-magnitude spikes), not drift
        scale = 1.4826 * float(np.median(np.abs(arr - med))) + 0.05 * (1.0 + abs(med))
        return abs(value - med) / scale

    def push(self, value: float) -> None:
        if math.isfinite(value):
            self.values.append(float(value))

    def state_dict(self) -> Dict[str, Any]:
        return {"values": list(self.values)}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.values.clear()
        self.values.extend(float(v) for v in state.get("values", []))


class Verdict:
    """Outcome of one sentinel observation."""

    def __init__(self, action: str, reasons: Optional[List[str]] = None):
        assert action in ACTIONS, action
        self.action = action
        self.reasons = reasons or []

    def __repr__(self) -> str:
        return f"Verdict({self.action!r}, {self.reasons!r})"


class HealthSentinel:
    """The rolling-anomaly / escalation-ladder brain of the sentinel.

    Host-side: it consumes the per-step stats dict the
    trainer already fetches, plus per-collection rollout stats from the
    PPO trainer. The trainer performs the actions (pin, skip, rewind,
    abort); the sentinel only decides them and carries the state."""

    # Per-step metrics monitored when present in the flattened stats dict.
    # "loss" covers the SFT/ILQL flat key; losses/total_loss the PPO one.
    STEP_METRICS = (
        "loss",
        "losses/total_loss",
        "train/grad_global_norm",
        "policy/approx_kl",
    )
    # Per-rollout-collection metrics (PPO make_experience).
    ROLLOUT_METRICS = ("rollout_scores/mean", "rollout/entropy")
    # Window key for per-SAMPLE rewards (quarantine z-scores).
    REWARD_SAMPLES = "rollout/sample_score"

    def __init__(
        self,
        window: int = 32,
        zscore: float = 8.0,
        warmup: int = 8,
        skip_after: int = 2,
        rewind_after: int = 3,
        good_steps: int = 4,
        pin_interval: int = 10,
        max_rewinds: int = 2,
        cooldown_steps: int = 8,
        lr_damp: float = 0.5,
        kl_boost: float = 1.0,
        nan_guard: bool = True,
        nan_guard_patience: int = 3,
        quarantine_zscore: float = 0.0,
        min_response_tokens: int = 2,
        max_repetition_frac: float = 0.95,
    ):
        self.window = int(window)
        self.zscore_threshold = float(zscore)
        self.warmup = int(warmup)
        self.skip_after = int(skip_after)
        self.rewind_after = int(rewind_after)
        self.good_steps = int(good_steps)
        self.pin_interval = int(pin_interval)
        self.max_rewinds = int(max_rewinds)
        self.cooldown_steps = int(cooldown_steps)
        self.lr_damp = float(lr_damp)
        self.kl_boost = float(kl_boost)
        self.nan_guard = bool(nan_guard)
        self.nan_guard_patience = int(nan_guard_patience)
        self.quarantine_zscore = float(quarantine_zscore)
        self.min_response_tokens = int(min_response_tokens)
        self.max_repetition_frac = float(max_repetition_frac)

        self._windows: Dict[str, RollingStat] = {}
        self.anomaly_streak = 0
        self.nan_streak = 0
        self.clean_steps = 0
        self.rewinds_used = 0
        self.cooldown_until = -1
        self.skipped_updates = 0.0
        self.quarantined_rows = 0
        self.last_good: Optional[Dict[str, Any]] = None
        self.last_pin_step: Optional[int] = None
        # rollout-time anomalies fold into the NEXT step verdict (a
        # reward-hacking spike should climb the same ladder as a loss
        # spike rather than needing its own escalation machinery)
        self._pending_rollout_anomalies: List[str] = []

    @classmethod
    def from_train_config(cls, train_cfg) -> "HealthSentinel":
        return cls(
            window=train_cfg.sentinel_window,
            zscore=train_cfg.sentinel_zscore,
            warmup=train_cfg.sentinel_warmup,
            skip_after=train_cfg.sentinel_skip_after,
            rewind_after=train_cfg.sentinel_rewind_after,
            good_steps=train_cfg.sentinel_good_steps,
            pin_interval=train_cfg.sentinel_pin_interval,
            max_rewinds=train_cfg.max_rewinds,
            cooldown_steps=train_cfg.sentinel_cooldown_steps,
            lr_damp=train_cfg.sentinel_lr_damp,
            kl_boost=train_cfg.sentinel_kl_boost,
            nan_guard=train_cfg.nan_guard,
            nan_guard_patience=train_cfg.nan_guard_patience,
            quarantine_zscore=train_cfg.sentinel_quarantine_zscore,
            min_response_tokens=train_cfg.sentinel_min_response_tokens,
            max_repetition_frac=train_cfg.sentinel_max_repetition_frac,
        )

    # -- observation -------------------------------------------------------

    def _window(self, key: str) -> RollingStat:
        if key not in self._windows:
            self._windows[key] = RollingStat(self.window, self.warmup)
        return self._windows[key]

    def observe_step(self, stats: Dict[str, Any], step: int) -> Verdict:
        """Score one optimizer step's (flattened, host-side) stats and
        return the escalation verdict. Clean samples extend the windows;
        anomalous ones do not (the baseline must not chase the spike)."""
        reasons: List[str] = list(self._pending_rollout_anomalies)
        self._pending_rollout_anomalies = []

        loss_bad = any(
            "loss" in k and np.ndim(v) == 0 and not np.isfinite(v)
            for k, v in stats.items()
        )
        if self.nan_guard and loss_bad:
            self.nan_streak += 1
            reasons.append(f"non-finite loss ({self.nan_streak}/{self.nan_guard_patience})")
        elif not loss_bad:
            self.nan_streak = 0

        for key in self.STEP_METRICS:
            v = stats.get(key)
            if v is None or np.ndim(v) != 0:
                continue
            v = float(v)
            w = self._window(key)
            z = w.zscore(v)
            if z > self.zscore_threshold:
                reasons.append(f"{key}={v:.4g} is {z:.1f} MAD-z from its window")
            elif math.isfinite(v):
                w.push(v)

        if not reasons:
            self.anomaly_streak = 0
            self.clean_steps += 1
            return Verdict("ok")

        self.anomaly_streak += 1
        self.clean_steps = 0
        # the nan policy forces the top of the ladder at patience,
        # whatever the anomaly streak says
        nan_fatal = self.nan_guard and self.nan_streak >= self.nan_guard_patience
        if self.anomaly_streak >= self.rewind_after or nan_fatal:
            if self.last_good is not None and self.rewinds_used < self.max_rewinds:
                return Verdict("rewind", reasons)
            if self.last_good is None:
                reasons.append("no last_good checkpoint pinned yet")
            else:
                reasons.append(f"rewind budget exhausted ({self.rewinds_used}/{self.max_rewinds})")
            return Verdict("abort", reasons)
        if self.anomaly_streak >= self.skip_after:
            return Verdict("skip", reasons)
        return Verdict("warn", reasons)

    def observe_rollout(self, stats: Dict[str, Any]) -> List[str]:
        """Score one experience collection's stats (reward mean, entropy).
        Anomalies are remembered and folded into the next step verdict;
        returns them for logging."""
        anomalies: List[str] = []
        for key in self.ROLLOUT_METRICS:
            v = stats.get(key)
            if v is None or np.ndim(v) != 0:
                continue
            v = float(v)
            w = self._window(key)
            z = w.zscore(v)
            if z > self.zscore_threshold:
                anomalies.append(f"{key}={v:.4g} is {z:.1f} MAD-z from its window")
            elif math.isfinite(v):
                w.push(v)
        self._pending_rollout_anomalies.extend(anomalies)
        return anomalies

    # -- rollout quarantine ------------------------------------------------

    def quarantine_mask(
        self,
        sample_scores: np.ndarray,
        response_lengths: np.ndarray,
        repetition_fracs: np.ndarray,
    ) -> np.ndarray:
        """Boolean mask of rollout rows to DROP before they enter the PPO
        store: per-sample reward outliers (robust z against the rolling
        reward window) and degenerate responses (length collapse or
        single-token repetition). Clean rows feed the window. If more
        than half the chunk flags, the window can't be trusted — keep
        everything and warn instead of starving the store."""
        n = len(sample_scores)
        drop = np.zeros(n, dtype=bool)
        if self.quarantine_zscore <= 0 or n == 0:
            return drop
        w = self._window(self.REWARD_SAMPLES)
        reasons = []
        for i in range(n):
            score = float(sample_scores[i])
            if response_lengths[i] < self.min_response_tokens:
                drop[i] = True
                reasons.append(f"row {i}: response length {int(response_lengths[i])}")
            elif repetition_fracs[i] > self.max_repetition_frac:
                drop[i] = True
                reasons.append(f"row {i}: repetition {float(repetition_fracs[i]):.2f}")
            else:
                z = w.zscore(score)
                if z > self.quarantine_zscore:
                    drop[i] = True
                    reasons.append(f"row {i}: reward {score:.4g} at {z:.1f} MAD-z")
        if drop.sum() > n // 2:
            logger.warning(
                f"Sentinel quarantine flagged {int(drop.sum())}/{n} rows — more "
                "than half the chunk; keeping all (baseline not trustworthy)"
            )
            drop[:] = False
            reasons = []
        for i in range(n):
            if not drop[i]:
                w.push(float(sample_scores[i]))
        if reasons:
            logger.warning("Sentinel quarantined rollout rows: " + "; ".join(reasons))
            self.quarantined_rows += int(drop.sum())
        return drop

    # -- actions / bookkeeping ---------------------------------------------

    def record_skipped(self, n: float) -> None:
        self.skipped_updates += float(n)

    def should_pin(self, step: int) -> bool:
        """Pin (or re-pin) last_good: enough consecutive clean steps, and
        not more often than the pin interval."""
        if self.clean_steps < self.good_steps:
            return False
        if self.last_pin_step is not None and step - self.last_pin_step < self.pin_interval:
            return False
        return True

    def note_pinned(self, path: str, step: int) -> None:
        self.last_good = {"path": os.path.abspath(path), "step": int(step)}
        self.last_pin_step = int(step)

    def note_rewind(self, step: int) -> None:
        """Account one executed rewind: spend budget, open the cooldown
        window, reset the streaks (the restored state is clean by
        definition)."""
        self.rewinds_used += 1
        self.cooldown_until = int(step) + self.cooldown_steps
        self.anomaly_streak = 0
        self.nan_streak = 0
        self.clean_steps = 0
        self._pending_rollout_anomalies = []

    def lr_scale(self, step: int) -> float:
        return self.lr_damp if step < self.cooldown_until else 1.0

    def kl_scale(self, step: int) -> float:
        return self.kl_boost if step < self.cooldown_until else 1.0

    def stats(self) -> Dict[str, float]:
        """Cumulative counters merged into every step's tracker line."""
        return {
            "sentinel/skipped_updates": float(self.skipped_updates),
            "sentinel/rewinds": float(self.rewinds_used),
            "sentinel/quarantined_rows": float(self.quarantined_rows),
            "sentinel/anomaly_streak": float(self.anomaly_streak),
            "sentinel/rewind_budget_remaining": float(
                max(self.max_rewinds - self.rewinds_used, 0)
            ),
            "sentinel/cooldown": 1.0 if self.cooldown_until >= 0 else 0.0,
        }

    # -- persistence (rides in state.pt's extra) ----------------------------

    def state_dict(self) -> Dict[str, Any]:
        return {
            "windows": {k: w.state_dict() for k, w in self._windows.items()},
            "anomaly_streak": self.anomaly_streak,
            "nan_streak": self.nan_streak,
            "clean_steps": self.clean_steps,
            "rewinds_used": self.rewinds_used,
            "cooldown_until": self.cooldown_until,
            "skipped_updates": self.skipped_updates,
            "quarantined_rows": self.quarantined_rows,
            "last_good": dict(self.last_good) if self.last_good else None,
            "last_pin_step": self.last_pin_step,
        }

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self._windows = {}
        for k, w_state in state.get("windows", {}).items():
            self._window(k).load_state_dict(w_state)
        self.anomaly_streak = int(state.get("anomaly_streak", 0))
        self.nan_streak = int(state.get("nan_streak", 0))
        self.clean_steps = int(state.get("clean_steps", 0))
        self.rewinds_used = int(state.get("rewinds_used", 0))
        self.cooldown_until = int(state.get("cooldown_until", -1))
        self.skipped_updates = float(state.get("skipped_updates", 0.0))
        self.quarantined_rows = int(state.get("quarantined_rows", 0))
        self.last_good = state.get("last_good")
        self.last_pin_step = state.get("last_pin_step")
        self._pending_rollout_anomalies = []


def repetition_frac(tokens: Sequence[int]) -> float:
    """Fraction of the response taken by its single most common token —
    the cheap degeneracy detector (a collapsed sampler emits one token
    forever). Empty responses count as fully degenerate."""
    tokens = np.asarray(tokens)
    if tokens.size == 0:
        return 1.0
    _, counts = np.unique(tokens, return_counts=True)
    return float(counts.max()) / float(tokens.size)


class StepWatchdog:
    """Hang detector: a daemon thread that fires when no heartbeat
    arrives within `timeout_s`.

    The trainer calls `beat()` at every step boundary (and per rollout
    chunk); a wedged collective, a deadlocked host callback, or an
    infinite reward_fn therefore stops the beats, and the watchdog dumps
    every thread's stack via `faulthandler` (the post-mortem) and exits
    with code 75 (EX_TEMPFAIL) — the same contract as a preemption, so
    the scheduler restarts the run and `auto_resume` continues from the
    last checkpoint. `on_timeout` is injectable for tests (the default
    is `os._exit`, the only exit that works from a non-main thread with
    the main thread wedged)."""

    def __init__(
        self,
        timeout_s: float,
        on_timeout=None,
        poll_s: Optional[float] = None,
        on_fire=None,
    ):
        self.timeout_s = float(timeout_s)
        self.on_timeout = on_timeout
        # diagnostics hook invoked after the faulthandler dump but BEFORE
        # on_timeout/exit (the trainer wires the postmortem bundler here —
        # it must run while the wedged threads still exist). Best-effort:
        # a failing hook must never block the exit path.
        self.on_fire = on_fire
        self.poll_s = poll_s if poll_s is not None else max(min(self.timeout_s / 4.0, 1.0), 0.01)
        self.fired = False
        self._last_beat = time.monotonic()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "StepWatchdog":
        self._last_beat = time.monotonic()
        self._thread = threading.Thread(
            target=self._run, name="trlx-tpu-torch-step-watchdog", daemon=True
        )
        self._thread.start()
        return self

    def beat(self) -> None:
        self._last_beat = time.monotonic()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(self.poll_s):
            if time.monotonic() - self._last_beat > self.timeout_s:
                self._fire()
                return

    def _fire(self) -> None:
        self.fired = True
        logger.error(
            f"Step watchdog: no step boundary for {self.timeout_s:.1f}s — "
            f"dumping thread stacks and exiting {PREEMPTION_EXIT_CODE} "
            "(auto_resume will continue from the last checkpoint)"
        )
        try:
            faulthandler.dump_traceback(file=sys.stderr, all_threads=True)
            sys.stderr.flush()
        except Exception:
            pass
        if self.on_fire is not None:
            try:
                self.on_fire()
            except Exception:
                logger.exception("Step watchdog: on_fire hook failed")
        if self.on_timeout is not None:
            self.on_timeout()
        else:
            os._exit(PREEMPTION_EXIT_CODE)
