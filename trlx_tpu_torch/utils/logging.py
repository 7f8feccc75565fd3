"""Rank-aware library logging.

Parity: trlx/utils/logging.py in the reference (HF-style verbosity control
via the TRLX_VERBOSITY env var, a multi-process adapter that logs only on
chosen ranks, tqdm toggling). Rank is the torch.distributed rank when a
process group is up, else the RANK env var (0 for one process).

TRLX_LOG_FORMAT=json switches the default handler to one-JSON-object-per
line (`ts`, `level`, `logger`, `msg`, plus `trace_id`/`request_id` when a
trace context is active via set_trace_context) for log aggregators. The
default human-readable format is unchanged when the env var is unset.
"""

import contextvars
import json
import logging
import os
import sys
import threading
from logging import CRITICAL, DEBUG, ERROR, FATAL, INFO, NOTSET, WARNING  # noqa: F401
from typing import Optional

_lock = threading.Lock()
_default_handler: Optional[logging.Handler] = None

# Active trace context for log correlation. A contextvar (not a plain
# thread-local) so request handlers running in thread pools inherit the
# value from the context the work was submitted in.
_trace_ctx: "contextvars.ContextVar[Optional[dict]]" = contextvars.ContextVar(
    "trlx_trace_ctx", default=None
)


def set_trace_context(trace_id: Optional[str] = None,
                      request_id: Optional[str] = None):
    """Attach trace/request ids to subsequent log records in this context.
    Returns a token for reset_trace_context."""
    ctx = {}
    if trace_id:
        ctx["trace_id"] = trace_id
    if request_id:
        ctx["request_id"] = request_id
    return _trace_ctx.set(ctx or None)


def reset_trace_context(token) -> None:
    _trace_ctx.reset(token)


def get_trace_context() -> Optional[dict]:
    return _trace_ctx.get()


class JSONLogFormatter(logging.Formatter):
    """One JSON object per line: ts (unix seconds), level, logger, msg,
    and trace_id/request_id when a trace context is active."""

    def format(self, record: logging.LogRecord) -> str:
        obj = {
            "ts": round(record.created, 3),
            "level": record.levelname,
            "logger": record.name,
            "msg": record.getMessage(),
        }
        ctx = _trace_ctx.get()
        if ctx:
            obj.update(ctx)
        if record.exc_info:
            obj["exc"] = self.formatException(record.exc_info)
        return json.dumps(obj, default=str)

log_levels = {
    "debug": DEBUG,
    "info": INFO,
    "warning": WARNING,
    "error": ERROR,
    "critical": CRITICAL,
}

_default_log_level = INFO


def _get_default_logging_level() -> int:
    env_level_str = os.getenv("TRLX_VERBOSITY", None)
    if env_level_str:
        if env_level_str.lower() in log_levels:
            return log_levels[env_level_str.lower()]
        logging.getLogger().warning(
            f"Unknown TRLX_VERBOSITY={env_level_str}, "
            f"has to be one of: {', '.join(log_levels.keys())}"
        )
    return _default_log_level


def _get_library_name() -> str:
    return __name__.split(".")[0]


def _get_library_root_logger() -> logging.Logger:
    return logging.getLogger(_get_library_name())


def _configure_library_root_logger() -> None:
    global _default_handler
    with _lock:
        if _default_handler:
            return
        _default_handler = logging.StreamHandler()  # sys.stderr as stream
        _default_handler.flush = sys.stderr.flush
        if os.getenv("TRLX_LOG_FORMAT", "").lower() == "json":
            formatter: logging.Formatter = JSONLogFormatter()
        else:
            formatter = logging.Formatter(
                "[%(asctime)s] [%(levelname)s] [%(name)s] %(message)s",
                datefmt="%H:%M:%S",
            )
        _default_handler.setFormatter(formatter)
        library_root_logger = _get_library_root_logger()
        library_root_logger.addHandler(_default_handler)
        library_root_logger.setLevel(_get_default_logging_level())
        library_root_logger.propagate = False


def _process_index() -> int:
    try:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return dist.get_rank()
    except Exception:
        pass
    return int(os.environ.get("RANK", 0))


class MultiProcessAdapter(logging.LoggerAdapter):
    """Adapter that logs only on a chosen set of process ranks.

    Pass `ranks=[...]` to any log call to restrict output to those process
    indices (default: rank 0 only). Mirrors the reference's
    MultiProcessAdapter (trlx/utils/logging.py:105-142).
    """

    _once_seen = set()

    def warning_once(self, msg, *args, **kwargs):
        """Emit a warning only the first time this exact message is seen —
        for per-call paths (retries, fallbacks) that would otherwise flood
        the log with one line per rollout sample."""
        key = (self.logger.name, str(msg))
        if key in MultiProcessAdapter._once_seen:
            return
        MultiProcessAdapter._once_seen.add(key)
        self.log(WARNING, msg, *args, **kwargs)

    def log(self, level, msg, *args, **kwargs):
        ranks = kwargs.pop("ranks", [0])
        process_index = _process_index()
        if process_index in ranks or -1 in ranks:
            if self.isEnabledFor(level):
                msg, kwargs = self.process(msg, kwargs)
                self.logger.log(level, f"[RANK {process_index}] {msg}", *args, **kwargs)

    def process(self, msg, kwargs):
        # LoggerAdapter requires `extra`; we don't use it.
        kwargs.pop("extra", None)
        return msg, kwargs


def get_logger(name: Optional[str] = None) -> MultiProcessAdapter:
    """Return a rank-aware logger for `name` (defaults to the library root)."""
    if name is None:
        name = _get_library_name()
    _configure_library_root_logger()
    return MultiProcessAdapter(logging.getLogger(name), {})


def get_verbosity() -> int:
    _configure_library_root_logger()
    return _get_library_root_logger().getEffectiveLevel()


def set_verbosity(verbosity: int) -> None:
    _configure_library_root_logger()
    _get_library_root_logger().setLevel(verbosity)


def set_verbosity_debug():
    set_verbosity(DEBUG)


def set_verbosity_info():
    set_verbosity(INFO)


def set_verbosity_warning():
    set_verbosity(WARNING)


def set_verbosity_error():
    set_verbosity(ERROR)


def disable_default_handler() -> None:
    _configure_library_root_logger()
    _get_library_root_logger().removeHandler(_default_handler)


def enable_default_handler() -> None:
    _configure_library_root_logger()
    _get_library_root_logger().addHandler(_default_handler)


def enable_explicit_format() -> None:
    for handler in _get_library_root_logger().handlers:
        handler.setFormatter(
            logging.Formatter(
                "[%(levelname)s|%(filename)s:%(lineno)s] %(asctime)s >> %(message)s"
            )
        )


def reset_format() -> None:
    for handler in _get_library_root_logger().handlers:
        handler.setFormatter(None)
