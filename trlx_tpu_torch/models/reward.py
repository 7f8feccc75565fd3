"""Reward model: an LM trunk and a scalar reward head, with the pairwise
preference loss (port of the JAX package's `models/reward.py`).

`CausalLMWithRewardHead` reads the final hidden state of each sequence's
last valid token (`clip(mask.sum(-1) - 1, 0)`, right padding) through
`MLPHead(1)`. Its parameters carry the JAX tree's names (`lm.*`,
`r_head.dense_in`, `r_head.dense_out`), so `convert.params_from_jax`
loads a JAX reward model as it loads a policy. The JAX module computes
the LM head's `[b, t, V]` logits and discards them; the port runs the
trunk and the final norm only. Scoring under `no_grad` runs the
forward-only flash kernel (K3), training the forward with lse and the
backward kernels (K4-K6).
"""

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from trlx_tpu_torch.models.heads import MLPHead
from trlx_tpu_torch.models.transformer import TransformerConfig, TransformerLM, position_ids


class CausalLMWithRewardHead(nn.Module):
    """Scalar per-sequence reward: the MLP head over the hidden state of
    the last valid (non-padded) token."""

    def __init__(self, cfg: TransformerConfig, device=None, generator=None):
        super().__init__()
        self.cfg = cfg
        self.lm = TransformerLM(cfg, device=device, generator=generator)
        self.r_head = MLPHead(cfg.d_model, 1, cfg.dtype, cfg.param_dtype, device, generator)

    def forward(self, tokens: torch.Tensor, attn_mask: torch.Tensor) -> torch.Tensor:
        """tokens, attn_mask [b, t] -> rewards [b] (f32)."""
        h = self.lm.forward_trunk(tokens, attn_mask, position_ids(attn_mask), self.cfg.n_layers)
        last = torch.clamp(attn_mask.sum(-1) - 1, min=0)
        # the final norm is per position: norm the gathered rows alone
        h_last = self.lm.ln_f(h[torch.arange(h.shape[0], device=h.device), last])
        return self.r_head(h_last)[..., 0]


def build_reward_model(cfg: TransformerConfig, seed: int = 0, device="cuda") -> CausalLMWithRewardHead:
    """A reward model on `device`, its weights drawn from `seed`."""
    device = torch.device(device)
    generator = torch.Generator(device=device)
    generator.manual_seed(int(seed))
    return CausalLMWithRewardHead(cfg, device=device, generator=generator).eval()


def pairwise_loss(r_chosen: torch.Tensor, r_rejected: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """-log sigmoid(r_chosen - r_rejected), the Bradley-Terry preference
    loss, with the pairs' accuracy and mean margin."""
    margin = r_chosen - r_rejected
    loss = -F.logsigmoid(margin).mean()
    stats = {
        "loss": loss.detach(),
        "accuracy": (margin > 0).float().mean().detach(),
        "margin": margin.mean().detach(),
    }
    return loss, stats


def make_reward_fn(model: CausalLMWithRewardHead, params: Optional[Dict[str, torch.Tensor]], tokenizer,
                   max_length: int, batch_size: int = 32, norm_offset: float = 0.0):
    """Wrap a trained reward model into the trlx `reward_fn` contract: the
    samples are tokenized in batches of `batch_size`, padded to
    `max_length`, scored under `no_grad`, and `norm_offset` is subtracted
    (the SFT baseline's score, as the summarize-RLHF recipe normalizes).
    `params`, when given, is a state dict loaded into `model` first."""
    if params is not None:
        model.load_state_dict(params)
    device = next(model.parameters()).device

    @torch.no_grad()
    def score(ids: np.ndarray, mask: np.ndarray) -> np.ndarray:
        tokens = torch.from_numpy(np.asarray(ids)).to(device).long()
        attn = torch.from_numpy(np.asarray(mask)).to(device).long()
        return model(tokens, attn).float().cpu().numpy()

    def reward_fn(samples, **kwargs):
        out = []
        for i in range(0, len(samples), batch_size):
            enc = tokenizer(list(samples[i:i + batch_size]), max_length=max_length, truncation=True,
                            padding="max_length")
            out.extend(score(enc["input_ids"], enc["attention_mask"]) - norm_offset)
        return [float(x) for x in out]

    return reward_fn
