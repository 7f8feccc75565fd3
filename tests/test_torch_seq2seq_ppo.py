"""Seq2seq PPO in the port (trlx_tpu_torch/trainer/ppo_trainer.py's
seq2seq branches: `score_seq2seq`, the seq2seq loss, the decoder-relative
elements and in-graph rewards, the pipelined cycle, the refusals that
stay) against the JAX trainer, on t5-tiny over the byte tokenizer at f32.
On the CPU the port's label logprob wrapper (K7 and its backward on the
card) runs its plain version.

Tolerances: the trainers' logged losses 1e-5 and parameters as in
`test_torch_moe.py` (2e-5, Adam's +-lr steps on near-zero gradients
bounded); greedy rollouts token for token and their stats 1e-5; scoring,
the in-graph rewards, the loss and its stats 1e-5; gradients 1e-5
relative to the largest element of each tensor.
"""

import json
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from seq2seq_cases import close, np_tree, tensors
from trlx_tpu.data.default_configs import default_ppo_config as j_default_ppo_config
from trlx_tpu.pipeline.offline_pipeline import PromptPipeline as JPromptPipeline
from trlx_tpu.trainer.ppo_trainer import PPOTrainer as JPPOTrainer
from trlx_tpu_torch.convert import params_from_jax
from trlx_tpu_torch.data import PPORLBatch
from trlx_tpu_torch.data.default_configs import default_ppo_config
from trlx_tpu_torch.models import build_model
from trlx_tpu_torch.ops import sampling
from trlx_tpu_torch.pipeline.ppo_pipeline import ppo_collate
from trlx_tpu_torch.trainer.ppo_trainer import PPOTrainer
from trlx_tpu_torch.utils import flatten_dict

torch.set_num_threads(1)

STEPS = 4


def reward_fn(samples, prompts, outputs, **kw):
    return [sum(c.islower() for c in o) / max(len(o), 1) + 0.01 * len(p) for p, o in zip(prompts, outputs)]


def _prompts(n, seed):
    rng = np.random.RandomState(seed)
    return ["".join(chr(97 + c) for c in rng.randint(0, 26, rng.randint(2, 12))) for _ in range(n)]


def _ppo_config(make, tmp, side):
    return make().evolve(
        train=dict(seq_length=32, batch_size=4, epochs=100, total_steps=STEPS, eval_interval=10**6,
                   checkpoint_interval=10**6, seed=3, save_best=False, save_optimizer=False, checkpoint_dir=str(tmp / side / "ckpts"),
                   logging_dir=str(tmp / side / "logs")),
        model=dict(model_path="random:t5-tiny", model_arch_type="seq2seq", num_layers_unfrozen=1,
                   model_extra_configs={"dtype": "float32", "decoder_start_token_id": 256}),
        method=dict(num_rollouts=8, chunk_size=8, ppo_epochs=1, init_kl_coef=0.05,
                    gen_kwargs=dict(max_new_tokens=6, do_sample=False)),
    )


def _losses(logging_dir, key):
    (path,) = [os.path.join(logging_dir, f) for f in os.listdir(logging_dir) if f.endswith(".metrics.jsonl")]
    with open(path) as f:
        return [row[key] for row in map(json.loads, f) if key in row]


@pytest.fixture(scope="module")
def ppo_runs(tmp_path_factory):
    """`trlx_tpu_torch.train(reward_fn=...)` on seq2seq t5-tiny (split 1,
    greedy rollouts, 4 steps over two collections) against the JAX
    trainer's `learn()` from the same weights; the eval prompts are the
    rollout prompts, so the JAX sampler compiles once."""
    import trlx_tpu_torch

    tmp = tmp_path_factory.mktemp("s2s_ppo")
    prompts = _prompts(8, 0)
    jt = JPPOTrainer(_ppo_config(j_default_ppo_config, tmp, "jax"), devices=jax.devices()[:1], reward_fn=reward_fn)
    start = params_from_jax(np_tree(jt.params))
    jt.add_prompt_pipeline(JPromptPipeline(prompts, 26, jt.tokenizer, add_special_tokens=True))
    jt.add_eval_pipeline(JPromptPipeline(prompts, 26, jt.tokenizer, add_special_tokens=True))
    jt.learn()
    get_arch = PPOTrainer.get_arch

    def from_jax(self, config):
        model, cfg, state = get_arch(self, config)
        model.load_state_dict(start)
        return model, cfg, state

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(PPOTrainer, "get_arch", from_jax)
        tt = trlx_tpu_torch.train(reward_fn=reward_fn, prompts=prompts, eval_prompts=prompts,
                                  config=_ppo_config(default_ppo_config, tmp, "torch"), device="cpu")
    return SimpleNamespace(jt=jt, tt=tt, start=start, tmp=tmp)


def test_train_entry_point_matches_jax_learn(ppo_runs):
    """Each step's logged loss 1e-5, the last collection's store (tokens
    exactly, stats 1e-5), the parameters, and the frozen encoder."""
    jt, tt, tmp = ppo_runs.jt, ppo_runs.tt, ppo_runs.tmp
    assert tt.seq2seq and tt.split == jt.split == 1 and tt.iter_count == jt.iter_count == STEPS
    t_loss, j_loss = _losses(str(tmp / "torch" / "logs"), "losses/total_loss"), _losses(str(tmp / "jax" / "logs"),
                                                                                         "losses/total_loss")
    assert len(t_loss) == len(j_loss) == STEPS
    close(t_loss, j_loss, 1e-5)
    assert len(tt.store) == len(jt.store) == 8
    for e, je in zip(tt.store.history, jt.store.history):
        np.testing.assert_array_equal(e.query_tensor, np.asarray(je.query_tensor))
        np.testing.assert_array_equal(e.response_tensor, np.asarray(je.response_tensor))
        assert e.response_tensor[0] == 256 and len(e.logprobs) == len(e.response_tensor) - 1
        for f in ("logprobs", "values", "rewards"):
            close(getattr(e, f), getattr(je, f), 1e-5)
    lr = float(tt.config.optimizer.kwargs.get("lr", 1e-4))
    want = params_from_jax(np_tree(jt.params), tt.model_cfg)
    got = tt.model.state_dict()
    for name, w in want.items():
        off = (got[name] - w).abs() > 2e-5 + 2e-5 * w.abs()
        assert float((got[name] - w).abs().max()) <= 2 * STEPS * lr, name
        assert float(off.float().mean()) <= 1e-3, name
        if name.startswith(("lm.enc", "lm.embed", "lm.dec_block_0.")):
            assert torch.equal(got[name], ppo_runs.start[name]), f"frozen {name} moved"


def _sync(runs):
    """The port's policy on the JAX trainer's current weights, bitwise."""
    runs.tt.model.load_state_dict(params_from_jax(np_tree(runs.jt.params), runs.tt.model_cfg))
    for name, w in runs.tt.ref_model.state_dict().items():
        assert torch.equal(w, params_from_jax(np_tree(runs.jt.ref_params))[name]), name


def _chunk(dense):
    """Left-padded queries and decoder rows [start, output, pad...]; one
    empty response."""
    rng = np.random.RandomState(7)
    prompts = rng.randint(97, 123, (4, 6)).astype(np.int32)
    prompts[1, :2] = prompts[3, :4] = 256
    outputs = np.full((4, 7), 256, np.int32)
    outputs[:, 0] = 256
    for i, n in enumerate([6, 3, 0, 5]):
        outputs[i, 1:1 + n] = rng.randint(97, 123, n)
    scores = rng.randn(4, 6 if dense else 1).astype(np.float32)
    return prompts, outputs, scores


@pytest.mark.parametrize("dense", [False, True])
def test_score_and_in_graph_rewards_match_jax(ppo_runs, dense):
    """`score_seq2seq` against JAX's scorer, `_score_reward` against JAX's
    `score_reward_s2s`, and both against the port's classic elements."""
    _sync(ppo_runs)
    jt, tt = ppo_runs.jt, ppo_runs.tt
    prompts, outputs, scores = _chunk(dense)
    p_t, o_t = tensors(prompts, outputs)
    got = tt.score_seq2seq(p_t, o_t)
    jt._build_score_fn()
    want = jt._score_fn(jt.train_params, jt.frozen_params, jt.ref_params, jnp.asarray(prompts), jnp.asarray(outputs))
    for g, w in zip(got, want):
        close(g.numpy(), w, 1e-5)
    assert float(got[3]) > 0
    kl = float(tt.kl_ctl.value)
    chunk, mean_kl, _ = tt._score_reward(p_t, o_t, torch.from_numpy(scores), kl, not dense)
    jchunk, jmean_kl, _ = jt._build_score_reward_fn(not dense)(
        jt.train_params, jt.frozen_params, jt.ref_params, jnp.asarray(prompts), jnp.asarray(outputs),
        jnp.asarray(scores), jnp.float32(jt.kl_ctl.value))
    for f in ("query_tensors", "response_tensors"):
        np.testing.assert_array_equal(getattr(chunk, f).numpy(), np.asarray(getattr(jchunk, f)))
    for f in ("logprobs", "values", "rewards"):
        close(getattr(chunk, f).numpy(), getattr(jchunk, f), 1e-5)
    close(float(mean_kl), float(jmean_kl), 1e-5)
    if not dense:
        outputs_tok = [list(o[1:][o[1:] != 256]) for o in outputs]
        elements = tt._chunk_to_elements(prompts, outputs, outputs_tok, scores, np.ones_like(scores, bool),
                                         *(x.numpy() for x in got[:3]))
        collated = ppo_collate(elements, 6, 7, 6, 256, True)
        for f in ("logprobs", "values", "rewards"):
            close(getattr(chunk, f).numpy(), getattr(collated, f), 1e-6)


def test_loss_and_gradients_match_jax(ppo_runs):
    """`seq2seq_loss_fn` on a collated batch: the loss and every stat 1e-5,
    the gradient of every trainable tensor 1e-5 relative to its largest
    element; frozen tensors get none."""
    _sync(ppo_runs)
    jt, tt = ppo_runs.jt, ppo_runs.tt
    jb = jax.tree_util.tree_map(jnp.asarray, next(iter(jt.create_train_dataloader())))
    fields = ("query_tensors", "response_tensors", "logprobs", "values", "rewards")
    batch = tt.batch_to_device(PPORLBatch(**{f: np.asarray(getattr(jb, f)) for f in fields}))
    (j_loss, j_stats), j_grads = jax.jit(jax.value_and_grad(jt.make_loss_fn(), has_aux=True))(
        jt.train_params, jt.frozen_params, jb)
    tt.model.zero_grad(set_to_none=True)
    t_loss, t_stats = tt.make_loss_fn()(batch)
    t_loss.backward()
    close(t_loss.item(), float(j_loss), 1e-5)
    for k, v in flatten_dict(np_tree(j_stats)).items():
        close(t_stats[k], v, 1e-5)
    want = params_from_jax(traverse_util.unflatten_dict(np_tree(j_grads)))  # train_params are flat: path tuples
    named = dict(tt.model.named_parameters())
    assert want.keys() == {n for n, p in named.items() if p.requires_grad}
    for name, w in want.items():
        scale = max(float(w.abs().max()), 1e-6)
        assert float((named[name].grad - w).abs().max()) <= 1e-5 * scale + 1e-7, name
    assert all(p.grad is None for p in named.values() if not p.requires_grad)
    tt.model.zero_grad(set_to_none=True)


def test_pipelined_cycle_runs_seq2seq_with_the_classic_scorer(ppo_runs):
    """Two cycles on the trained port trainer: the gates keep the
    speculative scorer, the capture and the trunk cache off, and the loss
    comes back finite."""
    tt = ppo_runs.tt
    assert not (tt._spec_path_available() or tt._fast_rollout_available() or tt._trunk_cache_available())
    steps = tt.iter_count
    loss, pending = tt.pipelined_cycle()
    assert loss is None and tt.spec_fallbacks == 0
    loss, pending = tt.pipelined_cycle(pending)
    assert np.isfinite(loss) and np.isfinite(float(pending[2][0]))
    assert tt.iter_count == steps + 4


def test_refusals_that_stay_match_jax(tmp_path):
    """GRPO/RLOO, best-of-n, the inference engine and multi-turn refuse
    seq2seq as JAX's do (NotImplementedError); a causal preset under
    "seq2seq" and a seq2seq preset under "causal" raise ValueError."""
    from trlx_tpu.data.default_configs import default_bon_config as j_bon, default_grpo_config as j_grpo
    from trlx_tpu.trainer.bon_trainer import BestOfNTrainer as JBestOfNTrainer
    from trlx_tpu.trainer.grpo_trainer import GRPOTrainer as JGRPOTrainer
    from trlx_tpu_torch.data.default_configs import default_bon_config, default_grpo_config
    from trlx_tpu_torch.inference.engine import InferenceEngine
    from trlx_tpu_torch.trainer.bon_trainer import BestOfNTrainer
    from trlx_tpu_torch.trainer.grpo_trainer import GRPOTrainer

    s2s_model = dict(model_path="random:t5-tiny", model_arch_type="seq2seq")
    for jcls, tcls, jmake, tmake in ((JGRPOTrainer, GRPOTrainer, j_grpo, default_grpo_config),
                                     (JBestOfNTrainer, BestOfNTrainer, j_bon, default_bon_config)):
        with pytest.raises(NotImplementedError) as jerr:
            jcls(jmake().evolve(model=s2s_model), reward_fn=reward_fn)
        with pytest.raises(NotImplementedError) as terr:
            tcls(tmake().evolve(model=s2s_model), reward_fn=reward_fn, device="cpu")
        assert str(terr.value) == str(jerr.value)
    model, cfg, state = build_model(default_ppo_config().evolve(model=s2s_model).model, 259, device="cpu")
    with pytest.raises(NotImplementedError, match="causal LMs only"):
        InferenceEngine(model, cfg, state, sampling.GenerationConfig(max_new_tokens=4, eos_token_id=258,
                                                                     pad_token_id=256), num_slots=2)
    t = PPOTrainer(_ppo_config(default_ppo_config, tmp_path, "mt").evolve(
        method=dict(multiturn_env="calculator")), reward_fn=reward_fn, device="cpu")
    with pytest.raises(NotImplementedError, match="causal-only"):
        t.make_experience(8)
    for model in (dict(model_path="random:gpt2-tiny", model_arch_type="seq2seq"),
                  dict(model_path="random:t5-tiny", model_arch_type="causal")):
        with pytest.raises(ValueError):
            build_model(default_ppo_config().evolve(model=model).model, 259, device="cpu")
