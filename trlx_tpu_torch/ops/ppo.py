"""PPO and GRPO/RLOO math: the KL coefficient controllers, generalized
advantage estimation, the clipped PPO loss, the critic-free group-relative
advantages and the GRPO loss.

Port of the JAX package's `ops/ppo.py`. The loss math is the same
expression for expression: clipped value loss, clipped-ratio policy loss,
the k3 approximate KL as a diagnostic, clip fractions and per-tensor
stats; GRPO's loss keeps the clipped ratio, drops the value loss and adds
the k3 KL to the frozen reference. The JAX reversed `lax.scan` of GAE is
a reversed loop over the response columns.
"""

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from trlx_tpu_torch.utils.modeling import get_tensor_stats, whiten


class AdaptiveKLController:
    """Ziegler et al.'s adaptive KL controller; host state updated between
    rollout phases."""

    def __init__(self, init_kl_coef: float, target: float, horizon: int):
        self.value = init_kl_coef
        self.target = target
        self.horizon = horizon

    def update(self, current: float, n_steps: int):
        proportional_error = float(np.clip(current / self.target - 1, -0.2, 0.2))
        mult = 1 + proportional_error * n_steps / self.horizon
        self.value *= mult


class FixedKLController:
    """Constant KL coefficient."""

    def __init__(self, kl_coef: float):
        self.value = kl_coef

    def update(self, current: float, n_steps: int):
        pass


def get_advantages_and_returns(
    values: torch.Tensor,  # [b, response_size]
    rewards: torch.Tensor,  # [b, response_size]
    gamma: float,
    lam: float,
    use_whitening: bool = True,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Generalized advantage estimation, a reversed loop over the columns:

        delta_t = r_t + gamma * V_{t+1} - V_t
        A_t     = delta_t + gamma * lam * A_{t+1}

    Returns (advantages, returns), advantages whitened (over `mask` when
    given) and detached."""
    next_values = torch.cat([values[:, 1:], torch.zeros_like(values[:, :1])], dim=1)
    deltas = rewards + gamma * next_values - values
    lastgaelam = torch.zeros_like(deltas[:, 0])
    columns = []
    for t in reversed(range(deltas.shape[1])):
        lastgaelam = deltas[:, t] + gamma * lam * lastgaelam
        columns.append(lastgaelam)
    advantages = torch.stack(columns[::-1], dim=1)
    returns = advantages + values
    if use_whitening:
        advantages = whiten(advantages, mask=mask)
    return advantages.detach(), returns


def ppo_loss(
    logprobs: torch.Tensor,  # [b, response]
    values: torch.Tensor,
    old_logprobs: torch.Tensor,
    old_values: torch.Tensor,
    advantages: torch.Tensor,
    returns: torch.Tensor,
    mask: torch.Tensor,
    cliprange: float,
    cliprange_value: float,
    vf_coef: float,
) -> Tuple[torch.Tensor, Dict]:
    """The clipped PPO objective. Returns (loss, nested stats)."""
    mask = mask.to(torch.float32)
    values_clipped = torch.clamp(values, old_values - cliprange_value, old_values + cliprange_value)
    n = mask.sum().clamp(min=1.0)

    vf_loss1 = (values - returns) ** 2
    vf_loss2 = (values_clipped - returns) ** 2
    vf_loss = 0.5 * (torch.maximum(vf_loss1, vf_loss2) * mask).sum() / n
    vf_clipfrac = ((vf_loss2 > vf_loss1).to(torch.float32) * mask).sum() / n

    log_ratio = (logprobs - old_logprobs) * mask
    ratio = torch.exp(log_ratio)
    # k3 unbiased KL estimator, diagnostic only (http://joschu.net/blog/kl-approx.html)
    approx_kl = torch.mean((ratio - 1) - log_ratio).detach()

    pg_loss1 = -advantages * ratio
    pg_loss2 = -advantages * torch.clamp(ratio, 1.0 - cliprange, 1.0 + cliprange)
    pg_loss = (torch.maximum(pg_loss1, pg_loss2) * mask).sum() / n
    pg_clipfrac = ((pg_loss2 > pg_loss1).to(torch.float32) * mask).sum() / n

    loss = pg_loss + vf_coef * vf_loss

    stats = dict(
        losses=dict(total_loss=loss, policy_loss=pg_loss, value_loss=vf_loss),
        values=dict(
            **get_tensor_stats(values, mask, n),
            values_error=(((values - returns) * mask) ** 2).sum() / n,
            clipfrac=vf_clipfrac,
        ),
        old_values=get_tensor_stats(old_values, mask, n),
        returns=get_tensor_stats(returns, mask, n),
        policy=dict(approx_kl=approx_kl, clipfrac=pg_clipfrac),
        ratio=(ratio * mask).sum() / n,
        padding_percentage=1.0 - n / mask.numel(),
    )
    return loss, stats


def group_relative_advantages(rewards: torch.Tensor, mode: str = "grpo", eps: float = 1e-4) -> torch.Tensor:
    """Critic-free advantages over G completions per prompt, rewards
    [n_groups, G] -> [n_groups, G] f32, detached.

    "grpo" (Shao et al. 2024): A_i = (r_i - mean(r)) / (std(r) + eps), the
    population std; the eps keeps a degenerate group (all rewards equal) at
    exactly zero instead of 0/0.
    "rloo" (Ahmadian et al. 2024): A_i = r_i - mean(r_{j != i})
    = (G r_i - sum(r)) / (G - 1); G = 1 has no leave-one-out set, so the
    advantage is the raw reward."""
    rewards = rewards.to(torch.float32)
    if mode == "grpo":
        mean = rewards.mean(dim=-1, keepdim=True)
        std = rewards.std(dim=-1, keepdim=True, unbiased=False)
        adv = (rewards - mean) / (std + eps)
    elif mode == "rloo":
        g = rewards.shape[-1]
        if g <= 1:
            adv = rewards
        else:
            adv = (g * rewards - rewards.sum(dim=-1, keepdim=True)) / (g - 1)
    else:
        raise ValueError(f"unknown advantage_mode '{mode}' (grpo | rloo)")
    return adv.detach()


def grpo_loss(
    logprobs: torch.Tensor,  # [b, response]
    old_logprobs: torch.Tensor,
    ref_logprobs: torch.Tensor,
    advantages: torch.Tensor,
    mask: torch.Tensor,
    cliprange: float,
    kl_coef: float,
) -> Tuple[torch.Tensor, Dict]:
    """The critic-free clipped objective (GRPO eq. 3): PPO's clipped ratio
    against a group-relative advantage plus `kl_coef` times the
    differentiable k3 KL to the frozen reference,
    exp(ref - pi) - (ref - pi) - 1. RLOO uses it with its own advantages.
    Returns (loss, nested stats)."""
    mask = mask.to(torch.float32)
    n = mask.sum().clamp(min=1.0)

    log_ratio = (logprobs - old_logprobs) * mask
    ratio = torch.exp(log_ratio)
    # k3 unbiased KL estimator, diagnostic only
    approx_kl = torch.mean((ratio - 1) - log_ratio).detach()

    pg_loss1 = -advantages * ratio
    pg_loss2 = -advantages * torch.clamp(ratio, 1.0 - cliprange, 1.0 + cliprange)
    pg_loss = (torch.maximum(pg_loss1, pg_loss2) * mask).sum() / n
    pg_clipfrac = ((pg_loss2 > pg_loss1).to(torch.float32) * mask).sum() / n

    ref_log_ratio = (ref_logprobs - logprobs) * mask
    kl_to_ref = ((torch.exp(ref_log_ratio) - ref_log_ratio - 1.0) * mask).sum() / n

    loss = pg_loss + kl_coef * kl_to_ref

    stats = dict(
        losses=dict(total_loss=loss, policy_loss=pg_loss, kl_loss=kl_to_ref),
        policy=dict(approx_kl=approx_kl, clipfrac=pg_clipfrac),
        advantages=get_tensor_stats(advantages, mask, n),
        ref_kl=kl_to_ref,
        ratio=(ratio * mask).sum() / n,
        padding_percentage=1.0 - n / mask.numel(),
    )
    return loss, stats
