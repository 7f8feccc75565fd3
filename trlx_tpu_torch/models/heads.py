"""Value head (port of the JAX package's `models/heads.py:MLPHead`)."""

import torch
from torch import nn

from trlx_tpu_torch.models.transformer import Linear


class MLPHead(nn.Module):
    """Linear(d -> 2d) -> ReLU -> Linear(2d -> n_out), the second layer in
    f32 (value regression is sensitive), matching the reference's make_head."""

    def __init__(self, d: int, n_out: int, dtype=torch.bfloat16, param_dtype=torch.float32,
                 device=None, generator=None):
        super().__init__()
        self.dense_in = Linear(d, 2 * d, True, dtype, param_dtype, device, generator)
        self.dense_out = Linear(2 * d, n_out, True, torch.float32, param_dtype, device, generator)

    def forward(self, x):
        return self.dense_out(torch.relu(self.dense_in(x)))
