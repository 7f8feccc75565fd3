"""Math and statistics helpers of the losses and trainers (port of the JAX
package's `utils/modeling.py`): `logprobs_of_labels`, the masked
statistics, `whiten`, `entropy_from_logits`, `get_tensor_stats` and the
host-side `RunningMoments`. On one device the global statistics are the
local ones. `swapped_params` runs a module on other tensors in place of
some of its parameters (the sampler's int8 decode view);
`apply_with_moe_aux` runs a forward and returns the MoE load-balancing
term of the losses beside its output, and `add_moe_aux` adds it to a
loss and its stats."""

from contextlib import contextmanager
from typing import Dict, Optional, Tuple

import numpy as np
import torch


def logprobs_of_labels(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Log-probabilities of `labels` under `logits` ([..., V] and [...]),
    in f32, through the fused op (`ops/fused_ce.py`: the CUDA kernel on
    the card, its plain version on the CPU)."""
    from trlx_tpu_torch.ops.fused_ce import fused_logprobs_of_labels

    return fused_logprobs_of_labels(logits, labels)


def apply_with_moe_aux(model_cfg, fn, *args, **kwargs):
    """`fn(*args, **kwargs)` and the MoE load-balancing LOSS TERM of that
    one call: `moe_aux_coef` times the sum of the terms of every MoE MLP
    that ran in it (the value branch's blocks included), 0.0 when the
    config has no experts. The terms are collected for this call alone
    (`collect_moe_aux`), so another forward between two steps (a
    reference or scoring pass, a decode step, a server thread) adds
    nothing."""
    if model_cfg.moe_experts == 0:
        return fn(*args, **kwargs), 0.0
    from trlx_tpu_torch.models.transformer import collect_moe_aux

    with collect_moe_aux() as terms:
        out = fn(*args, **kwargs)
    aux = sum(terms) if terms else torch.zeros((), dtype=torch.float32)
    return out, model_cfg.moe_aux_coef * aux


def add_moe_aux(model_cfg, loss, stats: Dict, aux, total_key: str):
    """Under MoE, (loss + aux, stats with `moe_aux_loss` and the optimised
    sum at `total_key`, a "/"-separated path into the nested stats, as JAX
    reports them); without experts (loss, stats) unchanged."""
    if model_cfg.moe_experts == 0:
        return loss, stats
    loss = loss + aux
    stats = {**stats, "moe_aux_loss": aux.detach()}
    node = stats
    *parents, leaf = total_key.split("/")
    for key in parents:
        node[key] = dict(node[key])
        node = node[key]
    node[leaf] = loss.detach()
    return loss, stats


@contextmanager
def swapped_params(module: torch.nn.Module, tensors: Optional[Dict[str, torch.Tensor]]):
    """Within the block, `module` reads `tensors[name]` in place of each
    named parameter (the JAX package passes a parameter tree per call; a
    torch module owns its parameters). The parameters themselves are not
    touched and come back on exit; `None` swaps nothing. The swap is
    visible to any other thread that runs the module meanwhile (a
    background server on the trainer's module would read the swapped
    tensors for the call's length)."""
    saved = []
    try:
        for name, t in (tensors or {}).items():
            path, _, leaf = name.rpartition(".")
            owner = module.get_submodule(path)
            saved.append((owner, leaf, owner._parameters[leaf]))
            owner._parameters[leaf] = t
        yield
    finally:
        for owner, leaf, p in reversed(saved):
            owner._parameters[leaf] = p


def masked_mean(x: torch.Tensor, mask: torch.Tensor, dim=None) -> torch.Tensor:
    mask = mask.to(x.dtype)
    if dim is None:
        return (x * mask).sum() / mask.sum().clamp(min=1.0)
    return (x * mask).sum(dim=dim) / mask.sum(dim=dim).clamp(min=1.0)


def masked_var(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    mean = masked_mean(x, mask)
    return masked_mean((x - mean) ** 2, mask)


def get_global_statistics(
    xs: torch.Tensor, mask: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(mean, var, count) of `xs` over `mask` (all of it without one)."""
    mask = torch.ones_like(xs) if mask is None else mask.to(xs.dtype)
    count = mask.sum()
    mean = (xs * mask).sum() / count.clamp(min=1.0)
    var = ((xs - mean) ** 2 * mask).sum() / count.clamp(min=1.0)
    return mean, var, count


def whiten(xs: torch.Tensor, shift_mean: bool = True, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Normalize to zero mean and unit variance."""
    mean, var, _ = get_global_statistics(xs, mask)
    whitened = (xs - mean) * torch.rsqrt(var + 1e-8)
    if not shift_mean:
        whitened = whitened + mean
    return whitened


def entropy_from_logits(logits: torch.Tensor) -> torch.Tensor:
    logits = logits.float()
    pd = torch.softmax(logits, dim=-1)
    return torch.logsumexp(logits, dim=-1) - (pd * logits).sum(-1)


def get_tensor_stats(xs: torch.Tensor, mask: torch.Tensor, n: torch.Tensor) -> Dict[str, torch.Tensor]:
    """mean/min/max/std over the masked entries; an all-zero mask gives
    min = max = 0 instead of +-inf."""
    mask = mask.to(xs.dtype)
    any_valid = mask.sum() > 0
    zero = torch.zeros((), dtype=xs.dtype, device=xs.device)
    mean = (xs * mask).sum() / n
    minimum = torch.where(any_valid, torch.where(mask > 0, xs, torch.inf).min(), zero)
    maximum = torch.where(any_valid, torch.where(mask > 0, xs, -torch.inf).max(), zero)
    std = torch.sqrt((((xs - mean) * mask) ** 2).sum() / n)
    return dict(mean=mean, min=minimum, max=maximum, std=std)


class RunningMoments:
    """Host-side running mean and std over batches of scores (parallel
    Welford merge), used to scale rollout rewards."""

    def __init__(self):
        self.mean = 0.0
        self.std = 1.0
        self.var = 1.0
        self.count = 1e-24

    def update(self, xs) -> Tuple[float, float]:
        """Update from a batch; returns the batch's (mean, std)."""
        xs = np.asarray(xs, dtype=np.float64)
        xs_count = xs.size
        xs_mean = xs.mean()
        xs_var = xs.var()

        delta = xs_mean - self.mean
        tot_count = self.count + xs_count

        new_sum = xs_var * xs_count
        old_sum = self.var * self.count + delta**2 * self.count * xs_count / tot_count
        tot_sum = old_sum + new_sum

        self.mean += delta * xs_count / tot_count
        self.var = tot_sum / tot_count
        self.std = float(np.sqrt(self.var * tot_count / max(tot_count - 1, 1)))
        self.count = tot_count

        return float(xs_mean), float(np.sqrt(xs_var * xs_count / max(xs_count - 1, 1)))
