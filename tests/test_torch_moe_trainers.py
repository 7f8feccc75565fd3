"""The RFT and best-of-n losses under MoE and the `train()` entry point for
SFT and PPO against the JAX trainers' `learn()`, the cases of
`test_torch_moe.py` in a file of their own (the suite's `--dist
loadfile` hands out the files with the fewest tests last, so these heavy
ones fill a worker the parallelism files leave idle), on moe-tiny at f32
with the same weights. Tolerances are `test_torch_moe.py`'s: losses and
the term 1e-5, parameters 2e-5 with Adam's +-lr steps on near-zero
gradients bounded.
"""

import os

import jax
import jax.numpy as jnp
import pytest
import torch

from trlx_tpu.data.default_configs import default_bon_config as j_default_bon_config
from trlx_tpu.data.default_configs import default_ppo_config as j_default_ppo_config
from trlx_tpu.data.default_configs import default_rft_config as j_default_rft_config
from trlx_tpu.data.default_configs import default_sft_config as j_default_sft_config
from trlx_tpu.pipeline.offline_pipeline import PromptPipeline as JPromptPipeline
from trlx_tpu.trainer.bon_trainer import BestOfNTrainer as JBestOfNTrainer
from trlx_tpu.trainer.ppo_trainer import PPOTrainer as JPPOTrainer
from trlx_tpu.trainer.rft_trainer import RFTTrainer as JRFTTrainer
from trlx_tpu.trainer.sft_trainer import SFTTrainer as JSFTTrainer
from trlx_tpu_torch.convert import params_from_jax
from trlx_tpu_torch.data.default_configs import default_bon_config
from trlx_tpu_torch.data.default_configs import default_ppo_config
from trlx_tpu_torch.data.default_configs import default_rft_config
from trlx_tpu_torch.data.default_configs import default_sft_config
from trlx_tpu_torch.trainer.bon_trainer import BestOfNTrainer
from trlx_tpu_torch.trainer.ppo_trainer import PPOTrainer
from trlx_tpu_torch.trainer.rft_trainer import RFTTrainer
from trlx_tpu_torch.trainer.sft_trainer import SFTTrainer
from test_torch_moe import (  # the cases' helpers, shared with test_torch_moe.py
    STEPS,
    _check_params,
    _check_stats,
    _close,
    _common,
    _losses,
    _np,
    _pair,
    _ppo_config,
    _prompts,
    _rows,
    reward_fn,
)


@pytest.mark.parametrize("kind", ["rft", "bon"])
def test_rft_and_best_of_n_losses_match_jax(tmp_path, kind):
    """The CE loss with its term on one batch of rows, through each
    trainer's own `make_loss_fn`, then one step."""
    make = {"rft": (j_default_rft_config, default_rft_config, JRFTTrainer, RFTTrainer),
            "bon": (j_default_bon_config, default_bon_config, JBestOfNTrainer, BestOfNTrainer)}[kind]
    mk = lambda fn, side: fn().evolve(**_common(tmp_path, side, seq_length=16),
                                      method=dict(gen_kwargs=dict(max_new_tokens=6, do_sample=True)))
    jt, tt = _pair(make[2], make[3], mk(make[0], "jax"), mk(make[1], "torch"),
                   reward_fn=lambda samples, prompts, outputs, **kw: [0.0] * len(samples))
    ids, mask = _rows(b=4, t=12, seed=3)
    batch = {"input_ids": ids, "attention_mask": mask}
    j_loss, j_stats = jt.make_loss_fn()(jt.train_params, jt.frozen_params, {k: jnp.asarray(v) for k, v in batch.items()})
    t_loss, t_stats = tt.make_loss_fn()({k: torch.from_numpy(v).long() for k, v in batch.items()})
    _close(float(t_loss), float(j_loss), 1e-5)
    _check_stats({k: float(v) for k, v in t_stats.items()}, {k: float(v) for k, v in _np(j_stats).items()})
    j_step = _np(jt.train_minibatch([{k: jnp.asarray(v) for k, v in batch.items()}]))
    t_step = tt.train_minibatch([batch])
    _close(t_step["loss"], float(j_step["loss"]), 1e-5)
    _close(t_step["moe_aux_loss"], float(j_step["moe_aux_loss"]), 1e-5)
    _check_params(jt, tt, 1)


def test_train_entry_point_sft_matches_jax(tmp_path, monkeypatch):
    """`trlx_tpu_torch.train(samples=...)` on random:moe-tiny for 2 steps,
    every weight trained, against the JAX trainer's `learn()` from the same
    weights: the logged loss and term of each step, and the parameters.
    The export beside each checkpoint is the raw state dict (no HF layout
    for experts)."""
    import trlx_tpu_torch

    evolve = _common(tmp_path, "x", unfrozen=-1, total_steps=STEPS, eval_interval=10**6)
    evolve["method"] = dict(gen_kwargs=dict(max_new_tokens=4, do_sample=False))
    mk = lambda make, side: make().evolve(**{**evolve, "train": dict(
        evolve["train"], checkpoint_dir=str(tmp_path / side / "ckpts"), logging_dir=str(tmp_path / side / "logs"))})
    samples = [s * 3 for s in _prompts(12, 2)]
    jt = JSFTTrainer(mk(j_default_sft_config, "jax"), devices=jax.devices()[:1])
    start = params_from_jax(_np(jt.params))
    jt.make_experience(samples, 48)
    jt.add_eval_pipeline(JPromptPipeline(samples[:2], 42, jt.tokenizer))
    jt.learn()
    get_arch = SFTTrainer.get_arch

    def from_jax(self, config):
        model, cfg, state = get_arch(self, config)
        model.load_state_dict(start)
        return model, cfg, state

    monkeypatch.setattr(SFTTrainer, "get_arch", from_jax)
    tt = trlx_tpu_torch.train(samples=samples, eval_prompts=samples[:2], config=mk(default_sft_config, "torch"),
                              device="cpu")
    assert tt.iter_count == jt.iter_count == STEPS
    for key in ("loss", "moe_aux_loss"):
        t_vals, j_vals = _losses(str(tmp_path / "torch" / "logs"), key), _losses(str(tmp_path / "jax" / "logs"), key)
        assert len(t_vals) == len(j_vals) == STEPS
        _close(t_vals, j_vals, 1e-5)
    _check_params(jt, tt, STEPS)
    hf_dir = os.path.join(tt.config.train.checkpoint_dir, f"checkpoint_{STEPS}", "hf_model")
    assert "model_state.pt" in os.listdir(hf_dir) and "pytorch_model.bin" not in os.listdir(hf_dir)


def test_train_entry_point_ppo_matches_jax(tmp_path, monkeypatch):
    """`trlx_tpu_torch.train(reward_fn=...)` on random:moe-tiny at split 1:
    one greedy collection of 8 rollouts, then 2 steps over one minibatch of
    all 8 (so the two loaders' orders cannot differ), against the JAX
    trainer's `learn()` from the same weights: each step's logged
    `losses/total_loss` and `moe_aux_loss` (1e-5) and the parameters; the
    export beside the done checkpoint is the raw state dict."""
    import trlx_tpu_torch

    def config(make, side):
        return _ppo_config(make, tmp_path, side, 0).evolve(
            train=dict(batch_size=8, total_steps=STEPS, eval_interval=10**6),
            method=dict(speculative_decode=False, cache_trunk_activations=False))

    prompts = _prompts(12, 0)
    jt = JPPOTrainer(config(j_default_ppo_config, "jax"), devices=jax.devices()[:1], reward_fn=reward_fn,
                     stop_sequences=["�"])
    start = params_from_jax(_np(jt.params))
    jt.add_prompt_pipeline(JPromptPipeline(prompts, 40, jt.tokenizer))
    jt.add_eval_pipeline(JPromptPipeline(prompts[:2], 40, jt.tokenizer))
    jt.learn()
    get_arch = PPOTrainer.get_arch

    def from_jax(self, config):
        model, cfg, state = get_arch(self, config)
        model.load_state_dict(start)
        return model, cfg, state

    monkeypatch.setattr(PPOTrainer, "get_arch", from_jax)
    tt = trlx_tpu_torch.train(reward_fn=reward_fn, prompts=prompts, eval_prompts=prompts[:2],
                              config=config(default_ppo_config, "torch"), stop_sequences=["�"], device="cpu")
    assert tt.split == jt.split == 1 and tt.iter_count == jt.iter_count == STEPS
    for key in ("losses/total_loss", "moe_aux_loss"):
        t_vals, j_vals = _losses(str(tmp_path / "torch" / "logs"), key), _losses(str(tmp_path / "jax" / "logs"), key)
        assert len(t_vals) == len(j_vals) == STEPS
        _close(t_vals, j_vals, 1e-5)
    _check_params(jt, tt, STEPS)
    hf_dir = os.path.join(tt.config.train.checkpoint_dir, f"checkpoint_{STEPS}", "hf_model")
    assert "model_state.pt" in os.listdir(hf_dir) and "pytorch_model.bin" not in os.listdir(hf_dir)
