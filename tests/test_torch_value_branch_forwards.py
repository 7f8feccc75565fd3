"""The value branch's forwards and refusals against the JAX package, the
cases of `test_torch_value_branch.py` moved to a file of their own (the
suite's `--dist loadfile` hands out the files with the fewest tests
last, so these heavy ones fill a worker the parallelism files leave
idle)."""

import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trlx_tpu.data.configs import ModelConfig as JModelConfig
from trlx_tpu.data.default_configs import default_ppo_config as j_default_ppo_config
from trlx_tpu.models import build_model as j_build_model
from trlx_tpu.models.policy import CausalLMWithValueHead as JPolicy
from trlx_tpu.pipeline.offline_pipeline import PromptPipeline as JPromptPipeline
from trlx_tpu.trainer.ppo_trainer import PPOTrainer as JPPOTrainer
from trlx_tpu_torch.convert import params_from_jax
from trlx_tpu_torch.data import PPORLBatch
from trlx_tpu_torch.data.configs import ModelConfig
from trlx_tpu_torch.data.default_configs import default_ppo_config
from trlx_tpu_torch.models import build_model
from trlx_tpu_torch.models.policy import HydraReference
from trlx_tpu_torch.models.transformer import init_kv_cache, position_ids
from trlx_tpu_torch.pipeline.offline_pipeline import PromptPipeline
from trlx_tpu_torch.trainer.ppo_trainer import PPOTrainer
from trlx_tpu_torch.utils import flatten_dict
from test_torch_value_branch import (  # the cases' helpers, shared with test_torch_value_branch.py
    V,
    _close,
    _padded_tokens,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module", params=[("gpt2-tiny", 1), ("llama-tiny", 2)], ids=["gpt2-tiny", "llama-tiny"])
def branch_pair(request):
    """A JAX and a port policy with a value branch, at f32, same weights."""
    preset, depth = request.param
    extra = {"dtype": "float32", "attn_impl": "flash"}
    jmodel, jcfg, jparams = j_build_model(JModelConfig(model_path=f"random:{preset}", model_extra_configs=extra),
                                          vocab_size=V, rng=jax.random.PRNGKey(0), num_value_layers=depth)
    tmodel, tcfg, _ = build_model(ModelConfig(model_path=f"random:{preset}", model_extra_configs=extra),
                                  vocab_size=V, device="cpu", num_value_layers=depth)
    state = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), tcfg)
    assert state.keys() == tmodel.state_dict().keys()
    tmodel.load_state_dict(state)
    return SimpleNamespace(jmodel=jmodel, jparams=jparams, tmodel=tmodel, tcfg=tcfg, depth=depth)


def test_branch_forwards_match_jax(branch_pair):
    """forward (at split 1) and forward_from_cache (from the trunk entering
    the lower of the split and the branch's tap) on rows padded at both
    ends, logits, values and h_split within 1e-5 of JAX; the cache pair
    bitwise the port's own full forward."""
    tokens, mask = _padded_tokens()
    jm, jp, model = branch_pair.jmodel, branch_pair.jparams, branch_pair.tmodel
    start = min(1, branch_pair.tcfg.n_layers - branch_pair.depth)
    jt, jmask = jnp.asarray(tokens), jnp.asarray(mask)
    jl, jv, jh = jm.apply({"params": jp}, jt, jmask, None, 1)
    jtrunk = jm.apply({"params": jp}, jt, jmask, None, start, method=JPolicy.forward_trunk)
    jcl, jcv = jm.apply({"params": jp}, jtrunk, jmask, None, start, method=JPolicy.forward_from_cache)
    t, m = torch.from_numpy(tokens).long(), torch.from_numpy(mask).long()
    with torch.no_grad():
        logits, values, h_split = model(t, m, position_ids(m), 1)
        trunk = model.forward_trunk(t, m, position_ids(m), start)
        c_logits, c_values = model.forward_from_cache(trunk, m, position_ids(m), start)
    for got, want in ((logits, jl), (values, jv), (h_split, jh), (c_logits, jcl), (c_values, jcv)):
        _close(got, want, 1e-5)
    assert values.shape == (3, 12) and float(values.abs().max()) > 0
    assert torch.equal(c_logits, logits) and torch.equal(c_values, values)


def test_value_branch_refusals(branch_pair):
    """Per-step values and the windowed heads raise under a branch, as in
    JAX; so do a tap below the resume point and the branch with ILQL
    heads."""
    model, cfg = branch_pair.tmodel, branch_pair.tcfg
    tokens, mask = _padded_tokens()
    t, m = torch.from_numpy(tokens).long(), torch.from_numpy(mask).long()
    cache = init_kv_cache(cfg, 3, 16, device="cpu")
    with torch.no_grad():
        with pytest.raises(NotImplementedError, match="value branch"):
            model.decode_step(t, cache, m, is_prefill=True, with_value=True)
        logits, values, _, _ = model.decode_step(t, cache, m, is_prefill=True)  # no values asked: runs
        assert values is None and logits.shape == (3, 12, V)
        with pytest.raises(NotImplementedError, match="value branch"):
            model.spec_verify_rows(None, None, None, None, 1, with_value=True)
        with pytest.raises(NotImplementedError, match="value branch"):
            model.forward_window(t, m, None, 2, 3)
        with pytest.raises(NotImplementedError, match="value branch"):
            model.forward_from_cache_window(None, m, None, 1, 2, 3)
        if branch_pair.depth == 2:  # tap 0 lies below a resume at 1
            with pytest.raises(ValueError, match="not derivable"):
                model.forward_from_cache(torch.zeros(3, 12, cfg.d_model), m, None, 1)
    with pytest.raises(NotImplementedError, match="PPO-value-head"):
        build_model(ModelConfig(model_path="random:gpt2-tiny"), V, device="cpu", with_ilql_heads=True,
                    num_value_layers=1)
