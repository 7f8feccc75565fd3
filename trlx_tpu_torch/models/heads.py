"""Value and Q heads (port of the JAX package's `models/heads.py`):
`MLPHead`, ILQL's `ILQLHeads` and the Polyak `sync_target_q_heads`."""

import torch
from torch import nn

from trlx_tpu_torch.models.transformer import Linear
from trlx_tpu_torch.ops.ilql import batched_index_select


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


class ILQLHeads(nn.Module):
    """ILQL's V head, one or two Q heads and their target heads, each an
    `MLPHead` over the final hidden state (Q heads: one output per
    vocabulary entry). The trainer keeps the target heads out of the
    optimizer (`target_q_mask`) and moves them only by
    `sync_target_q_heads`; their outputs take no gradient."""

    def __init__(self, d: int, vocab_size: int, two_qs: bool = True, dtype=torch.bfloat16,
                 param_dtype=torch.float32, device=None, generator=None):
        super().__init__()
        self.n_qs = 2 if two_qs else 1
        # the JAX module's setup order: the Q heads, the target heads, V
        for kind in ("q_head", "target_q_head"):
            for i in range(self.n_qs):
                self.add_module(f"{kind}_{i}", MLPHead(d, vocab_size, dtype, param_dtype, device, generator))
        self.v_head = MLPHead(d, 1, dtype, param_dtype, device, generator)

    def forward(self, hs, states_ixs=None, actions_ixs=None):
        """Returns (qs, target_qs, vs): with index arrays, the Q heads run
        on the action positions only and the V head on the state positions
        only."""
        actions_hs = hs if actions_ixs is None else batched_index_select(hs, actions_ixs)
        qs = tuple(getattr(self, f"q_head_{i}")(actions_hs) for i in range(self.n_qs))
        with torch.no_grad():
            target_qs = tuple(getattr(self, f"target_q_head_{i}")(actions_hs) for i in range(self.n_qs))
        states_hs = hs if states_ixs is None else batched_index_select(hs, states_ixs)
        return qs, target_qs, self.v_head(states_hs)


@torch.no_grad()
def sync_target_q_heads(heads: ILQLHeads, alpha: float) -> None:
    """Polyak update of every target head in place:
    target <- alpha * q + (1 - alpha) * target."""
    for i in range(heads.n_qs):
        q, target = getattr(heads, f"q_head_{i}"), getattr(heads, f"target_q_head_{i}")
        for qp, tp in zip(q.parameters(), target.parameters()):
            tp.copy_(alpha * qp + (1.0 - alpha) * tp)
