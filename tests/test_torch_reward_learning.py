"""The reward model learns separable preferences, the case of
`test_torch_reward_model.py` in a file of its own: that file then holds
seven tests, and the suite's `--dist loadfile`, which hands out the files
with the fewest tests last, starts both after the parallelism files of
few tests, in the workers those leave idle.
"""

import numpy as np
import torch

from trlx_tpu_torch.models import config_from_preset
from trlx_tpu_torch.models.reward import build_reward_model
from trlx_tpu_torch.models.reward import pairwise_loss
from test_torch_reward_model import (  # the cases' helpers, shared with test_torch_reward_model.py
    V,
)


def test_reward_model_learns_separable_preferences():
    """Pairwise training separates an easy preference (chosen sequences
    start with token 1, rejected ones with token 2)."""
    model = build_reward_model(config_from_preset("gpt2-tiny", vocab_size=V, dtype=torch.float32,
                                                  attn_impl="flash"), device="cpu")
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    rng = np.random.default_rng(0)

    def batch(lead):
        toks = rng.integers(3, 60, size=(16, 8)).astype(np.int64)
        toks[:, 0] = lead
        return torch.from_numpy(toks), torch.ones(16, 8, dtype=torch.long)

    for _ in range(40):
        opt.zero_grad()
        loss, stats = pairwise_loss(model(*batch(1)), model(*batch(2)))
        loss.backward()
        opt.step()
    assert float(stats["accuracy"]) > 0.9
