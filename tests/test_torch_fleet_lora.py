"""LoRA PPO under the rollout fleet (`train.rollout_backend="fleet"`) in
the port against the JAX package, which runs it too: each package
collects through its own supervised fleet of 2 thread replicas of its
`serve()`, at gpt2-tiny, f32, greedy, on the same weights (carried by
`params_from_jax`, the LoRA factors perturbed as training would move
them) and the same prompts. The stored rollouts' response tokens must be
equal, their logprobs (the replicas' behaviour logprobs), values and
rewards within 1e-5; the replicas serve the trainer's adapter factors
and take the new ones after a step."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trlx_tpu.data.default_configs import default_ppo_config as j_default_ppo_config
from trlx_tpu.pipeline.offline_pipeline import PromptPipeline as JPromptPipeline
from trlx_tpu.trainer.base_trainer import partition_params
from trlx_tpu.trainer.ppo_trainer import PPOTrainer as JPPOTrainer
from trlx_tpu_torch.convert import params_from_jax
from trlx_tpu_torch.data.default_configs import default_ppo_config
from trlx_tpu_torch.pipeline.offline_pipeline import PromptPipeline
from trlx_tpu_torch.trainer.ppo_trainer import PPOTrainer

torch.set_num_threads(1)

MAX_NEW = 6
# printable bytes and eos: the decode -> encode round trip is exact, so
# every row takes the replicas' behaviour logprobs
SUPPRESS = [i for i in range(259) if not (32 <= i < 127 or i == 258)]
PEFT = {"peft_type": "LORA", "r": 4, "lora_alpha": 16}
FLEET = dict(
    rollout_backend="fleet", rollout_fleet_supervised=True, rollout_fleet_size=2,
    rollout_fleet_kwargs=dict(replica_retries=0, hedge=False, concurrency=8),
    rollout_fleet_supervisor_kwargs=dict(tick_s=0.02, probe_interval_s=0.1, respawn_backoff_s=0.1,
                                         sync_interval_s=3600.0, start_timeout_s=10.0),
)
TOL = 1e-5


def reward_fn(samples, prompts, outputs, **kw):
    return [sum(c.islower() or c == " " for c in o) / max(len(o), 1) + 0.01 * len(p)
            for p, o in zip(prompts, outputs)]


def _config(make, tmp, side):
    return make().evolve(
        train=dict(seq_length=32, batch_size=4, epochs=1, total_steps=1000, eval_interval=1000,
                   checkpoint_interval=1000, seed=7, checkpoint_dir=str(tmp / side / "ckpts"),
                   logging_dir=str(tmp / side / "logs"), **FLEET),
        model=dict(model_path="random:gpt2-tiny", peft_config=PEFT,
                   model_extra_configs={"attn_impl": "flash", "dtype": "float32"}),
        tokenizer=dict(tokenizer_path="byte"),
        method=dict(num_rollouts=8, chunk_size=8, ppo_epochs=1, init_kl_coef=0.05,
                    gen_kwargs=dict(max_new_tokens=MAX_NEW, do_sample=False, suppress_tokens=SUPPRESS)),
        inference=dict(num_slots=8, max_prompt_len=32, max_new_tokens=MAX_NEW, max_wait_s=0.0,
                       kv_paging=True, kv_block_size=8, prefix_cache=True),
    )


def _perturb(tree, seed=7):
    rng = np.random.RandomState(seed)

    def walk(t):
        return {k: walk(v) if isinstance(v, dict) else
                (v + 0.3 * rng.randn(*v.shape).astype(np.float32) if "_lora_" in k else v) for k, v in t.items()}

    return walk(tree)


@pytest.fixture(scope="module")
def lora_pair(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fleet_lora")
    jt = JPPOTrainer(_config(j_default_ppo_config, tmp, "jax"), reward_fn=reward_fn, devices=jax.devices()[:1])
    params = _perturb(jax.tree_util.tree_map(np.asarray, jt.params))
    tree = jax.tree_util.tree_map(jnp.asarray, params)
    jt.train_params, jt.frozen_params = partition_params(tree, jt.make_trainable_mask(tree))
    tt = PPOTrainer(_config(default_ppo_config, tmp, "torch"), reward_fn=reward_fn, device="cpu")
    tt.model.load_state_dict(params_from_jax(params, tt.model_cfg))
    rng = np.random.RandomState(0)
    prompts = ["".join(chr(97 + c) for c in rng.randint(0, 26, rng.randint(2, 14))) for _ in range(12)]
    jt.add_prompt_pipeline(JPromptPipeline(prompts, 24, jt.tokenizer))
    tt.add_prompt_pipeline(PromptPipeline(prompts, 24, tt.tokenizer))
    try:
        jt.make_experience(8)
        tt.make_experience(8)
        yield jt, tt
    finally:
        jt.shutdown_rollout_fleet()
        tt.shutdown_rollout_fleet()


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64), rtol=tol, atol=tol)


def test_lora_fleet_ppo_rollouts_match_jax(lora_pair):
    jt, tt = lora_pair
    assert len(tt.store) == len(jt.store) == 8
    for e, je in zip(tt.store.history, jt.store.history):
        np.testing.assert_array_equal(e.query_tensor, np.asarray(je.query_tensor))
        np.testing.assert_array_equal(e.response_tensor, np.asarray(je.response_tensor))
        for f in ("logprobs", "values", "rewards"):
            _close(getattr(e, f), getattr(je, f))


def test_lora_fleet_replicas_serve_the_adapter(lora_pair):
    """Each seat's engine holds the trainer's LoRA factors (nonzero), and
    after a trainer step the next push hands it the new factors, the base
    weights unchanged."""
    _, tt = lora_pair
    engines = [s.handle.server.engine for s in tt._rollout_supervisor.seats]
    name = "lm.block_0.attn.q_proj.lora_b"
    for e in engines:
        state = e.model.state_dict()
        assert float(state[name].abs().max()) > 0
        for k, v in tt.model.state_dict().items():
            assert torch.equal(state[k], v), k
    base = {k: v.clone() for k, v in tt.model.state_dict().items() if k.startswith("lm.") and "lora" not in k}
    tt.train_minibatch([next(iter(tt.create_train_dataloader()))])
    tt.iter_count += 1
    assert not torch.equal(engines[0].model.state_dict()[name], tt.model.state_dict()[name])
    tt._push_params_to_thread_replicas()
    for e in engines:
        state = e.model.state_dict()
        assert torch.equal(state[name], tt.model.state_dict()[name])
        for k, v in base.items():
            assert torch.equal(state[k], v), k
