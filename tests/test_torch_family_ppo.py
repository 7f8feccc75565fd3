"""One PPO step of each model family with a distinct block (GPT-NeoX's
parallel residual and partial rotary, GPT-J's shared norm, Bloom's ALiBi)
against the JAX trainer, the case of `test_torch_model_families.py` in a
file of its own (the suite's `--dist loadfile` hands out the files with
the fewest tests last, so this heavy one fills a worker the parallelism
files leave idle). Tolerances are that file's.
"""

import jax
import numpy as np
import pytest
import torch

from trlx_tpu.data.default_configs import default_ppo_config as j_default_ppo_config
from trlx_tpu.pipeline.offline_pipeline import PromptPipeline as JPromptPipeline
from trlx_tpu.trainer.ppo_trainer import PPOTrainer as JPPOTrainer
from trlx_tpu_torch.convert import params_from_jax
from trlx_tpu_torch.data import PPORLBatch
from trlx_tpu_torch.data.default_configs import default_ppo_config
from trlx_tpu_torch.models.policy import HydraReference
from trlx_tpu_torch.pipeline.offline_pipeline import PromptPipeline
from trlx_tpu_torch.trainer.ppo_trainer import PPOTrainer
from trlx_tpu_torch.utils import flatten_dict
from test_torch_model_families import (  # the cases' helpers, shared with test_torch_model_families.py
    FAMILIES,
    TOL,
    _ppo_config,
    _reward,
)


@pytest.mark.parametrize("name", ["neox", "gptj", "bloom"])
def test_one_ppo_step_matches_jax(name, tmp_path):
    preset = FAMILIES[name][0]
    jt = JPPOTrainer(_ppo_config(j_default_ppo_config, preset, tmp_path, "jax"), reward_fn=_reward,
                     devices=jax.devices()[:1])
    tt = PPOTrainer(_ppo_config(default_ppo_config, preset, tmp_path, "torch"), reward_fn=_reward, device="cpu")
    tt.model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, jt.params), tt.model_cfg))
    tt.ref_model = HydraReference(tt.model.lm, tt.split)
    prompts = ["abc de", "hello there", "q", "the quick fox"]
    jt.add_prompt_pipeline(JPromptPipeline(prompts, 16, jt.tokenizer))
    tt.add_prompt_pipeline(PromptPipeline(prompts, 16, tt.tokenizer))
    jt.make_experience(4)
    tt.make_experience(4)
    for e, je in zip(tt.store.history, jt.store.history):
        np.testing.assert_array_equal(e.response_tensor, np.asarray(je.response_tensor))
        np.testing.assert_allclose(e.logprobs, np.asarray(je.logprobs), **TOL)
    (jb,) = [b for b in jt.create_train_dataloader()][:1]
    fields = ("query_tensors", "response_tensors", "logprobs", "values", "rewards")
    batch = PPORLBatch(**{f: np.asarray(getattr(jb, f)) for f in fields})
    j_stats = flatten_dict(jax.tree_util.tree_map(np.asarray, jt.train_minibatch([jb])))
    t_stats = tt.train_minibatch([batch])
    np.testing.assert_allclose(t_stats["losses/total_loss"], j_stats["losses/total_loss"], **TOL)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jt.params), tt.model_cfg)
    got = tt.model.state_dict()
    assert got.keys() == want.keys()
    cfg = tt.model_cfg
    rotated = cfg.rotary_dim if cfg.pos_embed == "rope" else 0
    for key, w in want.items():
        if key.endswith("k_proj.bias"):
            # the unrotated dims' exact gradient is 0: Adam turns its
            # rounding noise into steps of +-lr (3e-5); the rotated dims
            # rotate with the position and carry a real gradient
            g, w = got[key].reshape(cfg.kv_heads, -1), w.reshape(cfg.kv_heads, -1)
            assert float((g[:, rotated:] - w[:, rotated:]).abs().max()) <= 2 * 3e-5
            torch.testing.assert_close(g[:, :rotated], w[:, :rotated], rtol=2e-5, atol=2e-5)
            continue
        torch.testing.assert_close(got[key], w, rtol=2e-5, atol=2e-5)
