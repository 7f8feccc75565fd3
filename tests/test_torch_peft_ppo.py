"""PPO under each adapter (LoRA, prompt tuning, prefix tuning) against
the JAX PPO trainer, the cases of `test_torch_peft_trainers.py` moved to a
file of their own (the suite's `--dist loadfile` hands out the files with
the fewest tests last, so this heavy one fills a worker the parallelism
files leave idle): greedy rollouts and the scoring pass with the
adapters-off reference, then a few steps on the same batches, at
gpt2-tiny, f32, on the same weights.

Tolerances: rollout tokens exactly equal; their logprobs, values and
rewards, the mean KL and every step's loss and stats 1e-5; the
parameters after the steps 2e-5; the base weights bitwise unchanged.
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
from test_torch_peft_trainers import (  # the cases' helpers, shared with test_torch_peft_trainers.py
    PEFT,
    STEPS,
    STOP,
    _base,
    _check_params,
    _close,
    _np,
    _pair,
    _ppo_config,
    _prompts,
    reward_fn,
)


@pytest.fixture(scope="module", params=list(PEFT))
def ppo_pair(request, tmp_path_factory):
    """Both PPO trainers under one adapter: a greedy collection of 8
    rollouts, then STEPS steps on the JAX loader's batches, injected into
    both."""
    kind = request.param
    tmp = tmp_path_factory.mktemp(kind)
    jt, tt = _pair(JPPOTrainer, PPOTrainer, _ppo_config(j_default_ppo_config, tmp, "jax", kind),
                   _ppo_config(default_ppo_config, tmp, "torch", kind), reward_fn=reward_fn, stop_sequences=STOP)
    base = _base(tt)
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
    return dict(kind=kind, jt=jt, tt=tt, base=base, j_stats=j_stats, t_stats=t_stats)


def test_ppo_greedy_rollouts_and_scoring_match_jax(ppo_pair):
    """Split 0 and the adapters-off reference, holding no parameters of
    its own; the rollouts token for token, their logprobs, values and
    KL-penalized rewards, and the mean KL (not 0: the adapters move the
    policy off the reference)."""
    jt, tt = ppo_pair["jt"], ppo_pair["tt"]
    assert tt.split == jt.split == 0 and not list(tt.ref_model.parameters())
    assert not tt._window_loss_ok() if ppo_pair["kind"] == "prompt" else tt._window_loss_ok()
    assert len(tt.store) == len(jt.store) == 8
    for e, je in zip(tt.store.history, jt.store.history):
        np.testing.assert_array_equal(e.query_tensor, np.asarray(je.query_tensor))
        np.testing.assert_array_equal(e.response_tensor, np.asarray(je.response_tensor))
        for f in ("logprobs", "values", "rewards"):
            _close(getattr(e, f), getattr(je, f), 1e-5)
    assert tt.mean_kl == pytest.approx(jt.mean_kl, rel=1e-5, abs=1e-9) and tt.mean_kl > 1e-6


def test_ppo_steps_and_params_match_jax(ppo_pair):
    for t, j in zip(ppo_pair["t_stats"], ppo_pair["j_stats"]):
        for k, v in j.items():
            _close(t[k], v, 1e-5)
    _check_params(ppo_pair["jt"], ppo_pair["tt"], ppo_pair["base"])
