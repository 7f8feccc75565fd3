"""Two pipelined cycles end to end under each schedule against the JAX
trainer's cycle, the case of `test_torch_pipelined_cycle.py` in a file of
its own (the suite's `--dist loadfile` hands out the files with the
fewest tests last, so this heavy one fills a worker the parallelism
files leave idle). Tolerances are that file's.
"""

import jax
import numpy as np
import pytest
import torch

from trlx_tpu_torch.convert import params_from_jax
from test_torch_pipelined_cycle import (  # the cases' helpers, shared with test_torch_pipelined_cycle.py
    CYCLES,
    _pair,
)


@pytest.mark.parametrize("case", sorted(CYCLES))
def test_pipelined_cycle_matches_jax(tmp_path, case):
    """Two greedy cycles in both packages: every chunk's samples equal,
    the cycles' losses 1e-5, the KL state 1e-5, no fallback, and the
    trainable parameters after the cycles' steps 2e-5."""
    method = CYCLES[case]
    jt, tt = _pair(tmp_path, **method)
    assert tt._fast_rollout_available() == jt._fast_rollout_available() == ("fast" in case)
    assert tt._trunk_cache_available() == ("options" in case)
    before = {n: p.detach().clone() for n, p in tt.model.named_parameters() if p.requires_grad}
    pending, jpending, losses = None, None, []
    for _ in range(2):
        loss, pending = tt.pipelined_cycle(pending)
        jloss, jpending = jt.pipelined_cycle(jpending)
        losses.append((loss, jloss))
        for (_, o), (_, jo) in zip(pending[0], jpending[0]):
            np.testing.assert_array_equal(o["samples"].numpy(), np.asarray(jo["samples"]))
    assert losses[0] == (None, None)
    assert losses[1][0] == pytest.approx(losses[1][1], rel=1e-5, abs=1e-6)
    assert float(pending[2][0]) == pytest.approx(float(np.asarray(jpending[2][0])), rel=1e-5, abs=1e-6)
    # the KL of log-ratios near 0 is about their square: log-ratios 1e-5
    # apart give KL sums about 1e-7 apart
    assert tt.mean_kl == pytest.approx(jt.mean_kl, abs=1e-6)
    assert tt.kl_ctl.value == pytest.approx(jt.kl_ctl.value, rel=1e-6)
    assert tt.spec_fallbacks == getattr(jt, "spec_fallbacks", 0) == 0
    steps = 2 * 2 * method.get("num_rollouts", 8) // 8
    assert tt.iter_count == jt.iter_count == steps
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jt.params), tt.model_cfg)
    got = tt.model.state_dict()
    for name, p in tt.model.named_parameters():
        if not p.requires_grad:
            assert torch.equal(got[name], want[name]), f"frozen {name} moved"
        elif name.endswith("k_proj.bias"):
            # exact gradient 0: Adam turns rounding noise into steps of +-lr
            assert float((got[name] - want[name]).abs().max()) <= 2 * steps * 3e-5
        else:
            torch.testing.assert_close(got[name], want[name], rtol=2e-5, atol=2e-5)
    assert not torch.equal(got["lm.block_1.attn.q_proj.weight"], before["lm.block_1.attn.q_proj.weight"])
