"""General utilities: device resolution, seeding, timing, optimizer and
scheduler registries, dict helpers.

Port of the JAX package's `utils/__init__.py`. Its optax optimizers
become `torch.optim` optimizers over the trainable parameters only (lion
and rmsprop as this module's own, with optax's update rules), and
its optax schedules become plain functions of the step that a
`LambdaLR` applies (see `get_scheduler`).
"""

import math
import random
import time
from enum import Enum
from numbers import Number
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `cuda` unless the caller asks
    for another. Asking for `cuda` on a machine without it raises — the
    port never carries on on the CPU by itself."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path"
        )
    return dev


def significant(x: Number, ndigits: int = 2) -> Number:
    """Cut the number up to its `ndigits` after the most significant digit."""
    if isinstance(x, Number) and not isinstance(x, bool) and x != 0 and math.isfinite(x):
        return round(x, ndigits - int(math.floor(math.log10(abs(x)))))
    return x


def set_seed(seed: int) -> int:
    """Seed the host-side generators (python, numpy, torch's default).
    Device randomness in the port is drawn from explicit generators."""
    seed = int(seed)
    random.seed(seed)
    np.random.seed(seed % (2**32))
    torch.manual_seed(seed)
    return seed


class Clock:
    """Wall-clock throughput meter: tick() returns ms since the last tick and
    accumulates time/samples for get_stat()."""

    def __init__(self):
        self.start = time.time()
        self.total_time = 0
        self.total_samples = 0

    def tick(self, samples: int = 0) -> float:
        end = time.time()
        delta = end - self.start
        self.start = end
        if samples != 0:
            self.total_time += delta
            self.total_samples += samples
        return delta * 1000

    def get_stat(self, n_samp: int = 1000, reset: bool = False) -> float:
        """Average milliseconds per n_samp samples."""
        sec_per_samp = self.total_time / max(self.total_samples, 1)
        if reset:
            self.total_time = 0
            self.total_samples = 0
        return sec_per_samp * n_samp * 1000


def infinite_dataloader(dataloader: Iterable) -> Iterable:
    """Yield batches forever, restarting the loader at exhaustion."""
    while True:
        yield from dataloader


# ---------------------------------------------------------------------------
# Optimizers (torch.optim)
# ---------------------------------------------------------------------------


class OptimizerName(str, Enum):
    ADAM = "adam"
    ADAMW = "adamw"
    ADAM_8BIT_BNB = "adam_8bit_bnb"
    ADAMW_8BIT_BNB = "adamw_8bit_bnb"
    SGD = "sgd"
    LION = "lion"
    RMSPROP = "rmsprop"


class Lion(torch.optim.Optimizer):
    """optax's `lion` (`scale_by_lion`, `add_decayed_weights`,
    `scale_by_learning_rate`): u = sign((1 - b1) g + b1 mu), then
    mu = (1 - b2) g + b2 mu, and p += -lr (u + weight_decay p). The lr
    follows the port's convention (1.0 times the schedule)."""

    def __init__(self, params, lr: float = 1.0, betas: Tuple[float, float] = (0.9, 0.999),
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["exp_avg"] = torch.zeros_like(p)
                mu, g = state["exp_avg"], p.grad
                u = torch.sign((1.0 - b1) * g + b1 * mu)
                state["exp_avg"] = (1 - b2) * g + b2 * mu
                p.add_((u + group["weight_decay"] * p) * -group["lr"])
        return loss


class RMSprop(torch.optim.Optimizer):
    """optax's `rmsprop` (`scale_by_rms`, `scale_by_learning_rate`,
    `trace`): nu = (1 - decay) g^2 + decay nu from `initial_scale`,
    u = g / sqrt(nu + eps) (eps inside the root unless `eps_in_sqrt=False`,
    where torch's RMSprop puts it), scaled by -lr before the momentum
    trace, t = u + momentum t, p += t. The lr follows the port's
    convention (1.0 times the schedule). optax's `centered` and
    `nesterov` variants are not taken."""

    def __init__(self, params, lr: float = 1.0, decay: float = 0.9, eps: float = 1e-8,
                 initial_scale: float = 0.0, eps_in_sqrt: bool = True, momentum: Optional[float] = None):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps, initial_scale=initial_scale,
                                      eps_in_sqrt=eps_in_sqrt, momentum=momentum))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            decay, eps, momentum = group["decay"], group["eps"], group["momentum"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["nu"] = torch.full_like(p, group["initial_scale"])
                    if momentum is not None:
                        state["trace"] = torch.zeros_like(p)
                g = p.grad
                nu = state["nu"] = (1 - decay) * g ** 2 + decay * state["nu"]
                if group["eps_in_sqrt"]:
                    u = torch.rsqrt(nu + eps) * g
                else:
                    u = 1 / (torch.sqrt(nu) + eps) * g
                u = u * -group["lr"]
                if momentum is not None:
                    u = state["trace"] = u + momentum * state["trace"]
                p.add_(u)
        return loss


def get_optimizer(name: str, params, kwargs: Dict[str, Any] = None) -> torch.optim.Optimizer:
    """A torch optimizer over `params` (the trainable parameters only) from
    a torch-style kwargs dict (lr/betas/eps/weight_decay/momentum), with
    the JAX package's mapping onto optax. Its lr starts at 1.0: the
    trainer's `LambdaLR` sets it to the schedule's value at every step
    (`get_scheduler`), so kwargs['lr'] only seeds the schedule.

    torch's AdamW is optax's `adamw`: the decay is decoupled and applied to
    the old parameter (p -= lr * wd * p), and eps sits outside the square
    root of the bias-corrected second moment. Lion and rmsprop are this
    module's own, with optax's semantics (lion's betas from the config,
    default (0.9, 0.999), not optax's own default; rmsprop's momentum 0.9
    unless given); the 8-bit Adams are `ops/quantized_optim.Adam8bit`."""
    kwargs = dict(kwargs or {})
    kwargs.pop("lr", None)
    betas = tuple(kwargs.pop("betas", (0.9, 0.999)))
    eps = kwargs.pop("eps", 1e-8)
    weight_decay = kwargs.pop("weight_decay", 0.0)
    momentum = kwargs.pop("momentum", 0.9)
    params = list(params)
    name = OptimizerName(name.lower())
    if name == OptimizerName.ADAMW:
        return torch.optim.AdamW(params, lr=1.0, betas=betas, eps=eps, weight_decay=weight_decay, **kwargs)
    if name == OptimizerName.ADAM:
        return torch.optim.Adam(params, lr=1.0, betas=betas, eps=eps, **kwargs)
    if name in (OptimizerName.ADAMW_8BIT_BNB, OptimizerName.ADAM_8BIT_BNB):
        from trlx_tpu_torch.ops.quantized_optim import Adam8bit

        decay = weight_decay if name == OptimizerName.ADAMW_8BIT_BNB else 0.0
        return Adam8bit(params, lr=1.0, betas=betas, eps=eps, weight_decay=decay, **kwargs)
    if name == OptimizerName.SGD:
        return torch.optim.SGD(params, lr=1.0, momentum=momentum, **kwargs)
    if name == OptimizerName.LION:
        return Lion(params, lr=1.0, betas=betas, weight_decay=weight_decay)
    return RMSprop(params, lr=1.0, eps=eps, momentum=momentum, **kwargs)


# ---------------------------------------------------------------------------
# LR schedules: plain functions of the optimizer step
# ---------------------------------------------------------------------------


class SchedulerName(str, Enum):
    COSINE_ANNEALING = "cosine_annealing"
    LINEAR = "linear"
    CONSTANT = "constant"
    COSINE_WARMUP = "cosine_warmup"


def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    """optax.linear_schedule."""

    def schedule(step):
        if steps <= 0:
            return end
        frac = 1.0 - min(max(step, 0), steps) / steps
        return (init - end) * frac + end

    return schedule


def _cosine_decay(init: float, steps: int, alpha: float) -> Callable[[int], float]:
    """optax.cosine_decay_schedule."""

    def schedule(step):
        count = min(step, steps)
        cosine = 0.5 * (1 + math.cos(math.pi * count / steps))
        return init * ((1 - alpha) * cosine + alpha)

    return schedule


def get_scheduler(name: str, base_lr: float, kwargs: Dict[str, Any] = None) -> Callable[[int], float]:
    """The learning rate as a function of the optimizer step n (the n-th
    update uses schedule(n), step 0 included, as optax counts). The
    trainer wraps it in `torch.optim.lr_scheduler.LambdaLR` over an
    optimizer whose lr is 1.0 and steps the scheduler after each update.
    `cosine_annealing(T_max, eta_min)` follows torch CosineAnnealingLR's
    closed form, as the JAX package does."""
    kwargs = dict(kwargs or {})
    name = SchedulerName(name.lower())
    if name == SchedulerName.COSINE_ANNEALING:
        t_max = float(kwargs.get("T_max", 1e12))
        eta_min = float(kwargs.get("eta_min", 0.0))

        def schedule(step):
            frac = min(max(step / t_max, 0.0), 1.0)
            return eta_min + 0.5 * (base_lr - eta_min) * (1 + math.cos(math.pi * frac))

        return schedule
    if name == SchedulerName.LINEAR:
        total = int(kwargs.get("total_iters", kwargs.get("T_max", 10000)))
        return _linear(base_lr, float(kwargs.get("eta_min", 0.0)), total)
    if name == SchedulerName.CONSTANT:
        return lambda step: base_lr
    # cosine_warmup: optax.warmup_cosine_decay_schedule from 0 to base_lr
    warmup = int(kwargs.get("warmup_steps", 100))
    total = int(kwargs.get("T_max", 10000))
    eta_min = float(kwargs.get("eta_min", 0.0))
    rise = _linear(0.0, base_lr, warmup)
    fall = _cosine_decay(base_lr, total - warmup, 0.0 if base_lr == 0 else eta_min / base_lr)
    return lambda step: rise(step) if step < warmup else fall(step - warmup)


# ---------------------------------------------------------------------------
# Dict helpers
# ---------------------------------------------------------------------------


def flatten_dict(d: Dict, parent_key: str = "", sep: str = "/") -> Dict:
    """Flatten a nested dict into one level with `sep`-joined keys."""
    items = []
    for k, v in d.items():
        new_key = parent_key + sep + str(k) if parent_key else str(k)
        if isinstance(v, dict):
            items.extend(flatten_dict(v, new_key, sep=sep).items())
        else:
            items.append((new_key, v))
    return dict(items)
