"""Config dataclasses (`configs`, `method_configs`, `default_configs`) and
the PPO data containers (port of the JAX package's `data/__init__.py`:
`PPORLElement` and `PPORLBatch`).

Elements and batches are plain dataclasses of numpy arrays on the host;
the trainer moves a batch's arrays to its device (`batch_to_device`).
"""

from dataclasses import dataclass
from typing import Any, Optional

import numpy as np


@dataclass
class PPORLElement:
    """One rollout: prompt tokens, response tokens, and the per-response
    logprobs, values and KL-penalized rewards."""

    query_tensor: np.ndarray  # [query_size]
    response_tensor: np.ndarray  # [response_size]
    logprobs: np.ndarray  # [response_size]
    values: np.ndarray  # [response_size]
    rewards: np.ndarray  # [response_size]
    # the trunk activation cache, GRPO group ids and multi-turn loss masks
    # of the JAX package; their features are not ported yet, so they stay
    # None here
    h_split: Optional[np.ndarray] = None
    group_id: Optional[int] = None
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
    h_split: Any = None
    group_ids: Any = None
    loss_masks: Any = None
