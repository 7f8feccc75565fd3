"""PPO under MoE against the JAX PPO trainer, with and without the value
branch of MoE blocks, the cases of `test_torch_moe.py` in a file of their
own (the suite's `--dist loadfile` hands out the files with the fewest
tests last, so these heavy ones fill a worker the parallelism files leave
idle): greedy rollouts and the gates (speculative decode and the trunk
cache refuse MoE), then a few steps on the JAX loader's batches, on
moe-tiny at f32 with the same weights. Tolerances are `test_torch_moe.py`'s:
rollout tokens exactly, stats and losses 1e-5, parameters 2e-5 with
Adam's +-lr steps on near-zero gradients bounded.
"""

import numpy as np
import pytest

from trlx_tpu.data.default_configs import default_ppo_config as j_default_ppo_config
from trlx_tpu.pipeline.offline_pipeline import PromptPipeline as JPromptPipeline
from trlx_tpu.trainer.ppo_trainer import PPOTrainer as JPPOTrainer
from trlx_tpu_torch.data import PPORLBatch
from trlx_tpu_torch.data.default_configs import default_ppo_config
from trlx_tpu_torch.pipeline.offline_pipeline import PromptPipeline
from trlx_tpu_torch.trainer.ppo_trainer import PPOTrainer
from trlx_tpu_torch.utils import flatten_dict
from test_torch_moe import (  # the cases' helpers, shared with test_torch_moe.py
    STEPS,
    _check_params,
    _check_stats,
    _close,
    _np,
    _pair,
    _ppo_config,
    _prompts,
    reward_fn,
)


@pytest.fixture(scope="module", params=[0, 1])
def ppo_pair(request, tmp_path_factory):
    """Both PPO trainers with (1) and without (0) the value branch of MoE
    blocks, the speculative-decode and trunk-cache flags on (both gates
    refuse): a greedy collection of 8 rollouts, then STEPS steps on the JAX
    loader's batches, injected into both."""
    tmp = tmp_path_factory.mktemp(f"ppo{request.param}")
    jt, tt = _pair(JPPOTrainer, PPOTrainer, _ppo_config(j_default_ppo_config, tmp, "jax", request.param),
                   _ppo_config(default_ppo_config, tmp, "torch", request.param), reward_fn=reward_fn,
                   stop_sequences=["�"])
    prompts = _prompts(12, 0)
    jt.add_prompt_pipeline(JPromptPipeline(prompts, 40, jt.tokenizer))
    tt.add_prompt_pipeline(PromptPipeline(prompts, 40, tt.tokenizer))
    jt.make_experience(8)
    tt.make_experience(8)
    jbatches = [b for _ in range(2) for b in jt.create_train_dataloader()][:STEPS]
    fields = ("query_tensors", "response_tensors", "logprobs", "values", "rewards")
    injected = [PPORLBatch(**{f: np.asarray(getattr(b, f)) for f in fields}) for b in jbatches]
    j_stats, t_stats = [], []
    for jb, ib in zip(jbatches, injected):
        j_stats.append(flatten_dict(_np(jt.train_minibatch([jb]))))
        t_stats.append(tt.train_minibatch([ib]))
    return dict(jt=jt, tt=tt, j_stats=j_stats, t_stats=t_stats)


def test_ppo_rollouts_and_gates_match_jax(ppo_pair):
    """Greedy rollouts token for token through the MoE decode, their
    logprobs, values and rewards; both gates refuse MoE, and each refusal
    of the speculative one counts, as in JAX."""
    jt, tt = ppo_pair["jt"], ppo_pair["tt"]
    for e, je in zip(tt.store.history, jt.store.history):
        np.testing.assert_array_equal(e.response_tensor, np.asarray(je.response_tensor))
        for f in ("logprobs", "values", "rewards"):
            _close(getattr(e, f), getattr(je, f), 1e-5)
    assert not tt._trunk_cache_available() and not jt._trunk_cache_available()
    assert tt.split == jt.split == 1
    assert tt.spec_decode_fallbacks == jt.spec_decode_fallbacks > 0
    assert tt._spec_decode_available() is jt._spec_decode_available() is False
    assert tt.spec_decode_fallbacks == jt.spec_decode_fallbacks


def test_ppo_steps_and_params_match_jax(ppo_pair):
    """Each step's stats, `moe_aux_loss` and `losses/total_loss` (the
    optimised sum) among them, and the parameters after the steps."""
    for t, j in zip(ppo_pair["t_stats"], ppo_pair["j_stats"]):
        _check_stats(t, j)
        _close(t["losses/total_loss"], j["losses/total_loss"], 1e-5)
    _check_params(ppo_pair["jt"], ppo_pair["tt"], STEPS)
