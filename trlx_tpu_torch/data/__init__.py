"""Config dataclasses (`configs`, `method_configs`, `default_configs`) and
the RL data containers (port of the JAX package's `data/__init__.py`:
`PPORLElement` and `PPORLBatch`, `ILQLElement` and `ILQLBatch`).

Elements and batches are plain dataclasses of numpy arrays on the host;
the trainer moves a batch's arrays to its device (`batch_to_device`). The
one exception is the trunk activation cache (`h_split`), a torch tensor
that stays on the device: it is bf16 by default, which numpy lacks.
"""

from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch


@dataclass
class PPORLElement:
    """One rollout: prompt tokens, response tokens, and the per-response
    logprobs, values and KL-penalized rewards."""

    query_tensor: np.ndarray  # [query_size]
    response_tensor: np.ndarray  # [response_size]
    logprobs: np.ndarray  # [response_size]
    values: np.ndarray  # [response_size]
    rewards: np.ndarray  # [response_size]
    # the frozen trunk's activation entering the hydra split over the
    # query and response tokens, [query_size + response_size, d] on the
    # device, when method.cache_trunk_activations is on
    h_split: Optional[torch.Tensor] = None
    # the GRPO prompt group the rollout belongs to (None under PPO)
    group_id: Optional[int] = None
    # the multi-turn loss mask: 1 on policy tokens, 0 on the environment's
    # (set by multi-turn rollouts; None on single-turn ones)
    loss_mask: Optional[np.ndarray] = None


@dataclass
class PPORLBatch:
    """Batched rollouts: left-padded queries, right-padded responses and
    per-token stats."""

    query_tensors: Any  # int32 [b, padded_query]
    response_tensors: Any  # int32 [b, padded_response]
    logprobs: Any  # f32 [b, padded_response]
    values: Any  # f32 [b, padded_response]
    rewards: Any  # f32 [b, padded_response]
    # the trunk cache aligned with concat(query_tensors, response_tensors):
    # [b, padded_query + padded_response, d] on the device, or None
    h_split: Any = None
    group_ids: Any = None
    loss_masks: Any = None


@dataclass
class ILQLElement:
    """One offline RL sample: its tokens and the index maps of its states
    and actions (positions of the shifted sequence: position p predicts
    token p + 1)."""

    input_ids: Any  # int32 [t]
    attention_mask: Any  # int32 [t]
    rewards: Any  # f32 [n_actions]: the normalized return on the last action
    states_ixs: Any  # int32 [n_actions + 1]
    actions_ixs: Any  # int32 [n_actions]
    dones: Any  # int32 [n_actions + 1]: 1, then 0 at the terminal state


# a batch has an element's fields with a leading batch axis, right padded
ILQLBatch = ILQLElement
