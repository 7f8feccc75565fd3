"""PPO's deeper value branch (`method.num_value_layers_unfrozen > 0`) in the
port against the JAX package on the same numpy inputs and weights
(carried by `params_from_jax`): the branch's forwards, its clones, the
refusals under a branch, the trainer's gates, and PPOTrainer end to end
with the full-forward loss, the trunk cache and the pipelined cycle.

Models are gpt2-tiny (branch depth 1, tapping at the split) and
llama-tiny (depth 2, tapping at the embeddings) at f32 with
`attn_impl="flash"`; on the CPU the port's kernel wrappers run their
plain versions and the JAX package runs as its own CPU tests run it.

The trainer pair's cases are in `test_torch_value_branch_trainer.py`,
the forwards and refusals in `test_torch_value_branch_forwards.py`, so
that `--dist loadfile` hands them out after the large files.
"""

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

torch.set_num_threads(1)

V, PAD = 64, 62
STEPS = 3
STOP = ["�"]
SUPPRESS = [i for i in range(259) if not (32 <= i < 127 or i == 258)]


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# models: the branch's forwards, its clones, the refusals
# ---------------------------------------------------------------------------


def _padded_tokens():
    rng = np.random.RandomState(4)
    tokens = rng.randint(0, V - 2, (3, 12)).astype(np.int32)
    tokens[1, :4] = PAD
    tokens[2, 9:] = PAD
    return tokens, (tokens != PAD).astype(np.int32)


def test_value_branch_clones_the_top_blocks_at_build():
    """The branch's blocks and final norm are bitwise the trunk's top
    blocks and final norm at build, in storage of their own; the branch's
    MLP head keeps its own init; the JAX build clones the same leaves."""
    for preset, depth in (("gpt2-tiny", 1), ("llama-tiny", 2)):
        model, cfg, _ = build_model(ModelConfig(model_path=f"random:{preset}"), V, seed=3, device="cpu",
                                    num_value_layers=depth)
        top = cfg.n_layers - depth
        pairs = [(getattr(model.value_branch, f"block_{i}"), getattr(model.lm, f"block_{top + i}"))
                 for i in range(depth)] + [(model.value_branch.ln_f, model.lm.ln_f)]
        for clone, src in pairs:
            for a, b in zip(clone.parameters(), src.parameters()):
                assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()
        assert not hasattr(model, "v_head") and model.value_branch.v_head.dense_out.weight.shape == (1, 2 * cfg.d_model)
        _, _, jparams = j_build_model(JModelConfig(model_path=f"random:{preset}"), V, rng=jax.random.PRNGKey(3),
                                      num_value_layers=depth)
        for i in range(depth):
            jax.tree_util.tree_map(np.testing.assert_array_equal, jparams["value_branch"][f"block_{i}"],
                                   jparams["lm"][f"block_{top + i}"])


# ---------------------------------------------------------------------------
# The trainer's gates over a grid of splits and branch depths
# ---------------------------------------------------------------------------


def _gate_dummy(cls, split, depth, seq2seq=False):
    """A trainer shell with every option on, for the four gates alone."""
    t = object.__new__(cls)
    t.config = SimpleNamespace(method=SimpleNamespace(
        num_value_layers_unfrozen=depth, speculative_decode=True, cache_trunk_activations=True,
        capture_rollout_stats=True, spec_k=4))
    t.split, t.seq2seq, t.stop_sequences, t._spec_disabled_dense = split, seq2seq, [], False
    t.model_cfg = SimpleNamespace(moe_experts=0, prompt_tokens=0, prefix_tokens=0, n_layers=4)
    t.tokenizer = SimpleNamespace(_n_plain_ids=256)
    t.generate_experience_kwargs, t.generate_kwargs = None, {}
    t.spec_decode_fallbacks = 0
    return t


@pytest.mark.parametrize("depth", [0, 1, 2, 4])
@pytest.mark.parametrize("split", [0, 1, 2, 3, 4])
def test_gates_match_jax_over_splits_and_branch_depths(split, depth):
    """`_trunk_cache_available`, `_spec_decode_available`,
    `_spec_path_available` and `_fast_rollout_available` give JAX's
    answers on a 4-layer model with every option on."""
    port, jax_t = _gate_dummy(PPOTrainer, split, depth), _gate_dummy(JPPOTrainer, split, depth)
    gates = ("_trunk_cache_available", "_spec_decode_available", "_spec_path_available", "_fast_rollout_available")
    got = [getattr(port, g)() for g in gates]
    assert got == [getattr(jax_t, g)() for g in gates]
    assert got[0] == (split > 0 and 4 - depth >= split) and got[3] == (split > 0 and depth == 0)


@pytest.mark.parametrize("split", [0, 1, 2, 4])
def test_gates_match_jax_under_seq2seq(split):
    """The four gates of an encoder-decoder with every option on: all
    refuse at any split (the speculative one counting a fallback), as
    JAX's seq2seq conditions do."""
    port, jax_t = _gate_dummy(PPOTrainer, split, 0, True), _gate_dummy(JPPOTrainer, split, 0, True)
    gates = ("_trunk_cache_available", "_spec_decode_available", "_spec_path_available", "_fast_rollout_available")
    got = [getattr(port, g)() for g in gates]
    assert got == [getattr(jax_t, g)() for g in gates] == [False] * 4
    assert port.spec_decode_fallbacks == jax_t.spec_decode_fallbacks == 1


@pytest.mark.parametrize("virtual", ["prompt", "prefix"])
@pytest.mark.parametrize("depth", [0, 2])
@pytest.mark.parametrize("split", [0, 1, 3])
def test_gates_match_jax_under_prompt_and_prefix_tokens(split, depth, virtual):
    """The same four gates with 4 soft-prompt or prefix tokens: the
    speculative sampler refuses virtual tokens at any split (counted as a
    fallback), the rest follow the split as before; JAX's answers."""
    port, jax_t = _gate_dummy(PPOTrainer, split, depth), _gate_dummy(JPPOTrainer, split, depth)
    for t in (port, jax_t):
        t.model_cfg.prompt_tokens, t.model_cfg.prefix_tokens = (4, 0) if virtual == "prompt" else (0, 4)
    gates = ("_trunk_cache_available", "_spec_decode_available", "_spec_path_available", "_fast_rollout_available")
    got = [getattr(port, g)() for g in gates]
    assert got == [getattr(jax_t, g)() for g in gates]
    assert not got[1] and port.spec_decode_fallbacks == jax_t.spec_decode_fallbacks == 1


# ---------------------------------------------------------------------------
# PPOTrainer with a branch against the JAX trainer
# ---------------------------------------------------------------------------


def reward_fn(samples, prompts, outputs, **kw):
    """Deterministic: the share of lowercase letters and spaces in the
    output, plus a small prompt-length term."""
    return [sum(c.islower() or c == " " for c in o) / max(len(o), 1) + 0.01 * len(p)
            for p, o in zip(prompts, outputs)]


def _prompts(n, seed):
    rng = np.random.RandomState(seed)
    return ["".join(chr(97 + c) for c in rng.randint(0, 26, rng.randint(2, 14))) for _ in range(n)]


def _ppo_config(make, tmp, side, gen_kwargs=None, **method):
    return make().evolve(
        train=dict(seq_length=48, batch_size=4, epochs=2, total_steps=1000, eval_interval=1000,
                   checkpoint_interval=1000, seed=7, checkpoint_dir=str(tmp / side / "ckpts"),
                   logging_dir=str(tmp / side / "logs")),
        model=dict(model_path="random:gpt2-tiny", num_layers_unfrozen=1,
                   model_extra_configs={"attn_impl": "flash", "dtype": "float32"}),
        method=dict(num_rollouts=8, chunk_size=8, ppo_epochs=2, init_kl_coef=0.05, num_value_layers_unfrozen=1,
                    gen_kwargs=gen_kwargs or dict(max_new_tokens=8, do_sample=False), **method),
    )


def _pair(tmp, **kw):
    """A JAX and a port PPOTrainer with a branch, the same weights and
    reference."""
    jt = JPPOTrainer(_ppo_config(j_default_ppo_config, tmp, "jax", **kw), reward_fn=reward_fn,
                     stop_sequences=STOP, devices=jax.devices()[:1])
    tt = PPOTrainer(_ppo_config(default_ppo_config, tmp, "torch", **kw), reward_fn=reward_fn, stop_sequences=STOP,
                    device="cpu")
    tt.model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, jt.params), tt.model_cfg))
    tt.ref_model = HydraReference(tt.model.lm, tt.split)
    return jt, tt


def _train_run(tmp, side, **train):
    import trlx_tpu_torch

    cfg = _ppo_config(default_ppo_config, tmp, side, gen_kwargs=dict(max_new_tokens=8, do_sample=True),
                      cache_trunk_activations=True).evolve(train=dict(checkpoint_interval=1, **train))
    return trlx_tpu_torch.train(reward_fn=reward_fn, prompts=_prompts(12, 1), config=cfg, stop_sequences=STOP,
                                device="cpu")
