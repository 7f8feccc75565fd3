"""GRPO and RLOO trainer pairs against the JAX package, the cases of
`test_torch_grpo.py` moved to a file of their own (the suite's
`--dist loadfile` hands out the files with the fewest tests last, so
these heavy ones fill a worker the parallelism files leave idle): the
injected chunks' elements, the first step's stats and the parameters
after three steps, for both advantage modes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trlx_tpu.data import PPORLElement as JPPORLElement
from trlx_tpu.data.default_configs import default_grpo_config as j_default_grpo_config
from trlx_tpu.ops import ppo as j_ppo
from trlx_tpu.pipeline.offline_pipeline import PromptPipeline as JPromptPipeline
from trlx_tpu.pipeline.ppo_pipeline import PPORolloutStorage as JPPORolloutStorage
from trlx_tpu.trainer.grpo_trainer import GRPOTrainer as JGRPOTrainer
from trlx_tpu_torch.convert import params_from_jax
from trlx_tpu_torch.data import PPORLBatch, PPORLElement
from trlx_tpu_torch.data.default_configs import default_grpo_config
from trlx_tpu_torch.models import build_model
from trlx_tpu_torch.models.policy import CausalLMPolicy, HydraReference
from trlx_tpu_torch.ops import ppo
from trlx_tpu_torch.pipeline.offline_pipeline import PromptPipeline
from trlx_tpu_torch.pipeline.ppo_pipeline import PPORolloutStorage
from trlx_tpu_torch.trainer.grpo_trainer import GRPOTrainer
from trlx_tpu_torch.utils import flatten_dict
from test_torch_grpo import (  # the cases' helpers, shared with test_torch_grpo.py
    G,
    STEPS,
    _chunk,
    _close,
    _pair,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module", params=["grpo", "rloo"])
def grpo_pair(request, tmp_path_factory):
    """Both trainers: two injected chunks through `_chunk_to_elements`
    (the second's group ids continue the first's), then STEPS optimizer
    steps on the JAX loader's batches, injected into both."""
    jt, tt = _pair(tmp_path_factory.mktemp(request.param), request.param)
    elements = []
    for seed in (0, 1):
        prompts, outputs, scores, (lp, vals, lr) = _chunk(seed)
        args = (prompts, outputs, None, scores, np.ones_like(scores, bool), lp, vals, lr)
        je, te = jt._chunk_to_elements(*args), tt._chunk_to_elements(*args)
        elements.append((je, te))
        jt.store.push(je)
        tt.store.push(te)
    jbatches = [b for _ in range(2) for b in jt.create_train_dataloader()][:STEPS]
    tbatches = [b for _ in range(2) for b in tt.create_train_dataloader()][:STEPS]
    fields = ("query_tensors", "response_tensors", "logprobs", "values", "rewards", "group_ids")
    injected = [PPORLBatch(**{f: np.asarray(getattr(b, f)) for f in fields}) for b in jbatches]
    j_stats, t_stats = [], []
    for jb, ib in zip(jbatches, injected):
        j_stats.append(flatten_dict(jax.tree_util.tree_map(np.asarray, jt.train_minibatch([jb]))))
        t_stats.append(tt.train_minibatch([ib]))
    return dict(jt=jt, tt=tt, elements=elements, tbatches=tbatches, injected=injected, j_stats=j_stats,
                t_stats=t_stats)


def test_chunk_elements_match_jax(grpo_pair):
    """Each row's broadcast group advantage plus the per-token KL penalty,
    the reference logprobs in `values`, group ids running on across
    chunks; the loaders' batches equal, group ids included."""
    for chunk, (je, te) in enumerate(grpo_pair["elements"]):
        assert [e.group_id for e in te] == [e.group_id for e in je] == [2 * chunk + i // G for i in range(2 * G)]
        for e, j in zip(te, je):
            np.testing.assert_array_equal(e.response_tensor, np.asarray(j.response_tensor))
            for f in ("logprobs", "values", "rewards"):
                _close(getattr(e, f), getattr(j, f), 1e-6)
    assert grpo_pair["tt"]._group_offset == grpo_pair["jt"]._group_offset == 4
    for b, ib in zip(grpo_pair["tbatches"], grpo_pair["injected"]):
        for f in ("query_tensors", "response_tensors", "group_ids"):
            np.testing.assert_array_equal(getattr(b, f), getattr(ib, f))
        for f in ("logprobs", "values", "rewards"):
            _close(getattr(b, f), getattr(ib, f), 1e-6)


def test_first_grpo_step_stats_match_jax(grpo_pair):
    t, j = grpo_pair["t_stats"][0], grpo_pair["j_stats"][0]
    assert "losses/kl_loss" in t and "losses/value_loss" not in t
    for k, v in j.items():
        _close(t[k], v, 1e-5)


def test_grpo_params_after_three_steps_match_jax(grpo_pair):
    jt, tt = grpo_pair["jt"], grpo_pair["tt"]
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jt.params), tt.model_cfg)
    got = tt.model.state_dict()
    assert got.keys() == want.keys()
    trainable = {n for n, p in tt.model.named_parameters() if p.requires_grad}
    assert "lm.block_1.attn.q_proj.weight" in trainable and "lm.block_0.attn.q_proj.weight" not in trainable
    for name, w in want.items():
        if name.endswith("k_proj.bias"):
            assert float((got[name] - w).abs().max()) <= 2 * STEPS * 3e-5
            continue
        torch.testing.assert_close(got[name], w, rtol=2e-5, atol=2e-5)
        if name not in trainable:
            assert torch.equal(got[name], w), f"frozen {name} moved"
