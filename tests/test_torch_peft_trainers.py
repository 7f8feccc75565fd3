"""The port's trainers under adapters against the JAX package's trainers
(`tests/test_peft.py`'s trainer cases, taken further): PPO under LoRA,
prompt tuning and prefix tuning (greedy rollouts, the scoring pass with
the adapters-off reference, a few steps on the same batches), SFT under
LoRA through `learn()`, and one step each of GRPO, RFT and ILQL under
LoRA, at gpt2-tiny, f32, on the same weights (carried by
`params_from_jax`; the LoRA factors perturbed, as training would move
them). LoRA and prompt tuning run `attn_impl="flash"` (the kernels' plain
versions on the CPU); prefix tuning needs the dense-bias path ("xla").
The PPO cases are `test_torch_peft_ppo.py`, on this file's helpers.

Tolerances: rollout tokens exactly equal; their logprobs, values and
rewards, the mean KL and every step's loss and stats 1e-5 (f32, the same
sums in another order); the parameters after the steps 2e-5 (Adam
normalises a near-zero gradient element by its running RMS, as in
`test_torch_ppo.py`); the base weights bitwise unchanged.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trlx_tpu.data.default_configs import default_grpo_config as j_default_grpo_config
from trlx_tpu.data.default_configs import default_ppo_config as j_default_ppo_config
from trlx_tpu.data.default_configs import default_ilql_config as j_default_ilql_config
from trlx_tpu.data.default_configs import default_rft_config as j_default_rft_config
from trlx_tpu.data.default_configs import default_sft_config as j_default_sft_config
from trlx_tpu.pipeline.offline_pipeline import PromptPipeline as JPromptPipeline
from trlx_tpu.trainer.base_trainer import partition_params
from trlx_tpu.trainer.grpo_trainer import GRPOTrainer as JGRPOTrainer
from trlx_tpu.trainer.ilql_trainer import ILQLTrainer as JILQLTrainer
from trlx_tpu.trainer.rft_trainer import RFTTrainer as JRFTTrainer
from trlx_tpu.trainer.sft_trainer import SFTTrainer as JSFTTrainer
from trlx_tpu_torch.convert import params_from_jax
from trlx_tpu_torch.data import ILQLBatch, PPORLBatch
from trlx_tpu_torch.data.default_configs import (
    default_grpo_config,
    default_ilql_config,
    default_ppo_config,
    default_rft_config,
    default_sft_config,
)
from trlx_tpu_torch.models.lora import is_adapter_name
from trlx_tpu_torch.pipeline.offline_pipeline import PromptPipeline
from trlx_tpu_torch.trainer.grpo_trainer import GRPOTrainer
from trlx_tpu_torch.trainer.ilql_trainer import ILQLTrainer
from trlx_tpu_torch.trainer.ppo_trainer import PPOTrainer
from trlx_tpu_torch.trainer.rft_trainer import RFTTrainer
from trlx_tpu_torch.trainer.sft_trainer import SFTTrainer
from trlx_tpu_torch.utils import flatten_dict

torch.set_num_threads(1)

STEPS = 2
STOP = ["\ufffd"]
PEFT = {
    "lora": {"peft_type": "LORA", "r": 4, "lora_alpha": 16, "target_modules": ["q_proj", "v_proj", "up_proj"]},
    "prompt": {"peft_type": "PROMPT_TUNING", "num_virtual_tokens": 4},
    "prefix": {"peft_type": "PREFIX_TUNING", "num_virtual_tokens": 4},
}
ATTN = {"lora": "flash", "prompt": "flash", "prefix": "xla"}


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64), rtol=tol, atol=tol)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _perturb(np_params, scale=0.3, seed=7):
    rng = np.random.RandomState(seed)

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else
                (v + scale * rng.randn(*v.shape).astype(np.float32) if "_lora_" in k else v)
                for k, v in tree.items()}

    return walk(np_params)


def _common(tmp, side, kind, **train):
    return dict(
        train=dict(dict(seq_length=48, batch_size=4, epochs=2, total_steps=1000, eval_interval=1000,
                        checkpoint_interval=1000, seed=7, checkpoint_dir=str(tmp / side / "ckpts"),
                        logging_dir=str(tmp / side / "logs")), **train),
        model=dict(model_path="random:gpt2-tiny", peft_config=PEFT[kind], num_layers_unfrozen=1,
                   model_extra_configs={"attn_impl": ATTN[kind], "dtype": "float32"}),
    )


def _pair(jcls, tcls, jconfig, tconfig, **kw):
    """A JAX and a port trainer on the same weights, the JAX trainer's
    LoRA factors perturbed first."""
    jt = jcls(jconfig, devices=jax.devices()[:1], **kw)
    params = _perturb(_np(jt.params))
    tree = jax.tree_util.tree_map(jnp.asarray, params)
    jt.train_params, jt.frozen_params = partition_params(tree, jt.make_trainable_mask(tree))
    tt = tcls(tconfig, device="cpu", **kw)
    tt.model.load_state_dict(params_from_jax(params, tt.model_cfg))
    return jt, tt


def _check_params(jt, tt, base, steps=STEPS):
    """The parameters after the steps against JAX's; the trainable set is
    the adapters and the heads; the base weights bitwise unchanged. An
    element whose exact gradient is near 0 may take Adam's +-lr step on
    one side and another on the other (the first step divides g by |g| +
    eps): such elements stay within 2 lr a step and are one in a
    thousand at most; every other element is within 2e-5."""
    lr = float(tt.config.optimizer.kwargs.get("lr", 1e-4))
    want = params_from_jax(_np(jt.params), tt.model_cfg)
    got = tt.model.state_dict()
    trainable = {n for n, p in tt.model.named_parameters() if p.requires_grad}
    assert trainable and all(is_adapter_name(n) or not n.startswith("lm.") for n in trainable)
    assert got.keys() == want.keys()
    for name, w in want.items():
        off = (got[name] - w).abs() > 2e-5 + 2e-5 * w.abs()
        assert float((got[name] - w).abs().max()) <= 2 * steps * lr and float(off.float().mean()) <= 1e-3, name
    for name, w in base.items():
        assert torch.equal(got[name], w), f"base {name} moved"


def _base(tt):
    return {k: v.clone() for k, v in tt.model.state_dict().items() if k.startswith("lm.") and not is_adapter_name(k)}


# ---------------------------------------------------------------------------
# PPO under each adapter
# ---------------------------------------------------------------------------


def reward_fn(samples, prompts, outputs, **kw):
    return [sum(c.islower() or c == " " for c in o) / max(len(o), 1) + 0.01 * len(p)
            for p, o in zip(prompts, outputs)]


def _prompts(n, seed):
    rng = np.random.RandomState(seed)
    return ["".join(chr(97 + c) for c in rng.randint(0, 26, rng.randint(2, 14))) for _ in range(n)]


def _ppo_config(make, tmp, side, kind):
    return make().evolve(**_common(tmp, side, kind), method=dict(
        num_rollouts=8, chunk_size=8, ppo_epochs=2, init_kl_coef=0.05,
        gen_kwargs=dict(max_new_tokens=8, do_sample=False)))


def test_adapters_under_the_fleet_backend_are_refused(tmp_path):
    """Adapters under the fleet backend are ported: a LoRA PPO trainer
    builds (its replicas serve the LoRA policy; `test_torch_fleet_lora.py`
    runs it against JAX's), and prompt tuning fails where JAX's does, at
    a replica's engine build, with JAX's message."""
    fleet = dict(train=dict(rollout_backend="fleet"))
    PPOTrainer(_ppo_config(default_ppo_config, tmp_path, "torch", "lora").evolve(**fleet),
               reward_fn=reward_fn, device="cpu")
    from trlx_tpu.trainer.ppo_trainer import PPOTrainer as JPPOTrainer

    msg = "slot-pool decode under prompt/prefix tuning is unsupported"
    tt = PPOTrainer(_ppo_config(default_ppo_config, tmp_path, "torch", "prompt").evolve(**fleet),
                    reward_fn=reward_fn, device="cpu")
    jt = JPPOTrainer(_ppo_config(j_default_ppo_config, tmp_path, "jax", "prompt").evolve(**fleet),
                     reward_fn=reward_fn, devices=jax.devices()[:1])
    for trainer in (tt, jt):
        with pytest.raises(NotImplementedError, match=msg):
            trainer.serve(port=0, background=True)


# ---------------------------------------------------------------------------
# SFT, GRPO, RFT and ILQL under LoRA
# ---------------------------------------------------------------------------


def test_sft_under_lora_matches_jax(tmp_path):
    """learn() for STEPS steps on the same samples: the losses and the
    parameters; the value head frozen as in plain SFT."""
    evolve = _common(tmp_path, "x", "lora", total_steps=STEPS, eval_interval=10**6)
    evolve["method"] = dict(gen_kwargs=dict(max_new_tokens=4, do_sample=False))
    mk = lambda make, side: make().evolve(**{**evolve, "train": dict(
        evolve["train"], checkpoint_dir=str(tmp_path / side / "ckpts"), logging_dir=str(tmp_path / side / "logs"))})
    jt, tt = _pair(JSFTTrainer, SFTTrainer, mk(j_default_sft_config, "jax"), mk(default_sft_config, "torch"))
    base = _base(tt)
    samples = [s * 3 for s in _prompts(12, 2)]
    for tr, pipe in ((jt, JPromptPipeline), (tt, PromptPipeline)):
        tr.make_experience(samples, 48)
        tr.add_eval_pipeline(pipe(["ab", "hello"], 42, tr.tokenizer))
    jt.learn()
    tt.learn()
    assert tt.iter_count == jt.iter_count == STEPS
    _check_params(jt, tt, base)
    assert not any(p.requires_grad for n, p in tt.model.named_parameters() if n.startswith("v_head."))


G = 4


def _grpo_chunk(seed, q=6, r=5):
    rng = np.random.RandomState(seed)
    b = 2 * G
    prompts = rng.randint(1, 200, (b, q)).astype(np.int32)
    prompts[:, :2] = 256
    outputs = rng.randint(1, 200, (b, r)).astype(np.int32)
    for i, n in enumerate([5, 3, 0, 5, 1, 4, 5, 2]):
        outputs[i, n:] = 256
    scores = rng.randn(b, 1).astype(np.float32)
    stats = [rng.randn(b, q + r - 1).astype(np.float32) for _ in range(3)]
    return prompts, outputs, scores, stats


def test_one_grpo_step_under_lora_matches_jax(tmp_path):
    mk = lambda make, side: make().evolve(**_common(tmp_path, side, "lora"), method=dict(
        num_rollouts=8, chunk_size=8, ppo_epochs=1, group_size=G, init_kl_coef=0.05, grpo_kl_coef=0.1,
        gen_kwargs=dict(max_new_tokens=8, do_sample=False)))
    jt, tt = _pair(JGRPOTrainer, GRPOTrainer, mk(j_default_grpo_config, "jax"), mk(default_grpo_config, "torch"),
                   reward_fn=reward_fn)
    base = _base(tt)
    prompts, outputs, scores, (lp, vals, lr) = _grpo_chunk(0)
    args = (prompts, outputs, None, scores, np.ones_like(scores, bool), lp, vals, lr)
    jt.store.push(jt._chunk_to_elements(*args))
    tt.store.push(tt._chunk_to_elements(*args))
    jb = next(iter(jt.create_train_dataloader()))
    fields = ("query_tensors", "response_tensors", "logprobs", "values", "rewards", "group_ids")
    ib = PPORLBatch(**{f: np.asarray(getattr(jb, f)) for f in fields})
    j_stats = flatten_dict(_np(jt.train_minibatch([jb])))
    t_stats = tt.train_minibatch([ib])
    for k, v in j_stats.items():
        _close(t_stats[k], v, 1e-5)
    assert tt.split == 0 and not list(tt.ref_model.parameters())
    _check_params(jt, tt, base, 1)


def test_one_rft_step_under_lora_matches_jax(tmp_path):
    """One CE step over the same selected generations (injected: both
    trainers' `generate` return the same rows)."""
    alphabet = "abcdef"
    mk = lambda make, side: make().evolve(**_common(tmp_path, side, "lora", seq_length=16),
                                          tokenizer=dict(tokenizer_path=f"char:{alphabet}"),
                                          method=dict(n_generations_per_prompt=3,
                                                      gen_kwargs=dict(max_new_tokens=6, do_sample=True)))
    rft_reward = lambda samples, prompts, outputs, **kw: [float(sum(c in "ab" for c in o)) for o in outputs]
    jt, tt = _pair(JRFTTrainer, RFTTrainer, mk(j_default_rft_config, "jax"), mk(default_rft_config, "torch"),
                   reward_fn=rft_reward)
    base = _base(tt)
    prompts = ["a", "bc", "d", "ef", "fa"]
    jt.add_prompt_pipeline(JPromptPipeline(prompts, 8, jt.tokenizer))
    tt.add_prompt_pipeline(PromptPipeline(prompts, 8, tt.tokenizer))
    rng = np.random.RandomState(0)
    drawn = []

    def j_generate(input_ids, attention_mask, *a, **kw):
        out = rng.randint(0, len(alphabet) + 3, (len(input_ids), 6)).astype(np.int32)
        drawn.append(np.concatenate([np.asarray(input_ids), out], axis=1))
        return {"samples": drawn[-1]}

    jt.generate = j_generate
    tt.generate = lambda *a, **kw: {"samples": torch.from_numpy(drawn.pop(0))}
    jt.make_experience()
    tt.make_experience()
    jb = next(iter(jt.create_train_dataloader()))
    j_stats = _np(jt.train_minibatch([jb]))
    t_stats = tt.train_minibatch([{k: np.asarray(v) for k, v in jb.items()}])
    _close(t_stats["loss"], float(j_stats["loss"]), 1e-5)
    _check_params(jt, tt, base, 1)


def test_one_ilql_step_under_lora_matches_jax(tmp_path):
    """One step of the ILQL loss (Q, V, CQL and AWAC terms) on the same
    batch: the LoRA factors and the ILQL heads train, the target heads
    wait for their sync."""
    mk = lambda make, side: make().evolve(**_common(tmp_path, side, "lora", seq_length=24), method=dict(
        steps_for_target_q_sync=5, alpha=0.3, beta=1.0, gen_kwargs=dict(max_new_tokens=6, top_k=5, beta=1.0)))
    jt, tt = _pair(JILQLTrainer, ILQLTrainer, mk(j_default_ilql_config, "jax"), mk(default_ilql_config, "torch"))
    base = _base(tt)
    rng = np.random.RandomState(1)
    word = lambda k: "".join(chr(97 + c) for c in rng.randint(0, 26, k))
    samples = [[word(rng.randint(3, 9)), word(rng.randint(2, 12))] for _ in range(8)]
    rewards = list(rng.randn(len(samples)))
    jt.make_experience(samples, rewards, 24)
    tt.make_experience(samples, rewards, 24)
    jb = next(iter(jt.create_train_dataloader()))
    fields = ("input_ids", "attention_mask", "rewards", "states_ixs", "actions_ixs", "dones")
    ib = ILQLBatch(*(np.asarray(getattr(jb, f)) for f in fields))
    j_stats = flatten_dict(_np(jt.train_minibatch([jb])))
    t_stats = tt.train_minibatch([ib])
    for k, v in j_stats.items():
        _close(t_stats[k], v, 1e-5)
    trainable = {n for n, p in tt.model.named_parameters() if p.requires_grad}
    assert any(n.endswith("lora_a") for n in trainable) and not any("target_q_head" in n for n in trainable)
    _check_params(jt, tt, base, 1)
