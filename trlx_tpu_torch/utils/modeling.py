"""Math helpers used by the losses (port of the JAX package's
`utils/modeling.py`: `logprobs_of_labels`; the RL statistics come with
the PPO slice)."""

import torch


def logprobs_of_labels(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Log-probabilities of `labels` under `logits` ([..., V] and [...]),
    in f32, through the fused op (`ops/fused_ce.py`: the CUDA kernel on
    the card, its plain version on the CPU)."""
    from trlx_tpu_torch.ops.fused_ce import fused_logprobs_of_labels

    return fused_logprobs_of_labels(logits, labels)
