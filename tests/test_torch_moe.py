"""The port's mixture-of-experts MLP (`MoEMLP`), its load-balancing term
(`collect_moe_aux`, `apply_with_moe_aux`) and every trainer's loss under
MoE, against the JAX package on the same numpy inputs and weights (carried
by `params_from_jax`), at f32 on the CPU.

Covered: the MLP alone over GLU or not and biases or not, its output and
term (1e-5) and the gradients of one scalar of both, the router's
included (1e-4); the LM over gpt2-, llama- (GQA) and neox-style
(parallel residual) blocks with left-padded rows, logits 1e-5 and the
term 1e-6 relative; one expert of top-1 equal to the dense MLP (1e-6);
cached decode against JAX's full forward (1e-4, JAX's own test); the
term under PPO's value branch of MoE blocks; the term scoped to one call
and one thread; SFT through `train(samples=...)`, PPO through
`train(reward_fn=...)`, PPO with and without the value branch, GRPO,
RFT, best-of-n and ILQL, each loss and its `moe_aux_loss` (1e-5) and the
parameters after the steps (2e-5, Adam's near-zero elements within 2 lr
a step, as in `test_torch_peft_trainers.py`); PPO's gates and the
speculative-decode refusals of the sampler and the engine; the int8
frozen-trunk view of the experts bitwise and its greedy collection token
for token; the engine's greedy streams token for token; the HF refusal.
PPO's rollouts and steps are `test_torch_moe_ppo.py`, the RFT and best-
of-n losses and the `train()` entry points `test_torch_moe_trainers.py`,
on this file's helpers. The MLP's, the LM's and decode's, the int8
view's, GRPO's and ILQL's, and the engine's cases are in
`test_torch_moe_mlp.py`, `test_torch_moe_lm.py`,
`test_torch_moe_steps.py` and `test_torch_moe_serving.py`, so that
`--dist loadfile` hands them out after the large files.
"""

import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trlx_tpu.data.default_configs import default_grpo_config as j_default_grpo_config
from trlx_tpu.data.default_configs import default_ilql_config as j_default_ilql_config
from trlx_tpu.data.default_configs import default_ppo_config as j_default_ppo_config
from trlx_tpu.data.default_configs import default_sft_config as j_default_sft_config
from trlx_tpu.inference import InferenceEngine as JEngine
from trlx_tpu.models import policy as j_policy
from trlx_tpu.models import transformer as jtf
from trlx_tpu.models.hf_interop import params_to_hf_state_dict as j_params_to_hf_state_dict
from trlx_tpu.ops import quant as j_quant
from trlx_tpu.ops import sampling as j_sampling
from trlx_tpu.pipeline.offline_pipeline import PromptPipeline as JPromptPipeline
from trlx_tpu.trainer.grpo_trainer import GRPOTrainer as JGRPOTrainer
from trlx_tpu.trainer.ilql_trainer import ILQLTrainer as JILQLTrainer
from trlx_tpu.trainer.ppo_trainer import PPOTrainer as JPPOTrainer
from trlx_tpu.trainer.sft_trainer import SFTTrainer as JSFTTrainer
from trlx_tpu_torch.convert import params_from_jax
from trlx_tpu_torch.data import ILQLBatch, PPORLBatch
from trlx_tpu_torch.data.default_configs import (
    default_grpo_config,
    default_ilql_config,
    default_ppo_config,
    default_sft_config,
)
from trlx_tpu_torch.inference import InferenceEngine
from trlx_tpu_torch.models import hf_interop, policy
from trlx_tpu_torch.models import transformer as tf
from trlx_tpu_torch.ops import quant, sampling
from trlx_tpu_torch.pipeline.offline_pipeline import PromptPipeline
from trlx_tpu_torch.trainer.grpo_trainer import GRPOTrainer
from trlx_tpu_torch.trainer.ilql_trainer import ILQLTrainer
from trlx_tpu_torch.trainer.ppo_trainer import PPOTrainer
from trlx_tpu_torch.trainer.sft_trainer import SFTTrainer
from trlx_tpu_torch.utils import flatten_dict
from trlx_tpu_torch.utils.modeling import apply_with_moe_aux

torch.set_num_threads(1)

V = 64
STEPS = 2
MOE = {"moe_experts": 4, "moe_top_k": 2}


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64), rtol=tol, atol=tol)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(x):
    return x.detach().float().numpy()


def _rows(b=3, t=10, seed=0):
    """Token rows with left padding on all but the first row."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, V, (b, t)).astype(np.int32)
    mask = np.ones((b, t), np.int32)
    for r in range(1, b):
        mask[r, :2 * r] = 0
    return ids, mask


# ---------------------------------------------------------------------------
# The MoE MLP, the LM and the term
# ---------------------------------------------------------------------------


def test_single_expert_top1_equals_the_dense_mlp():
    kw = dict(vocab_size=V, d_model=16, n_layers=1, n_heads=2, d_ff=32, use_bias=False, dtype=torch.float32)
    dense = tf.MLP(tf.TransformerConfig(**kw))
    moe = tf.MoEMLP(tf.TransformerConfig(moe_experts=1, moe_top_k=1, **kw))
    with torch.no_grad():
        moe.up_proj.copy_(dense.up_proj.weight.T[None])
        moe.down_proj.copy_(dense.down_proj.weight.T[None])
        h = torch.from_numpy(np.random.RandomState(0).randn(2, 6, 16).astype(np.float32))
        torch.testing.assert_close(moe(h), dense(h), atol=1e-6, rtol=1e-6)


def test_term_under_the_value_branch_matches_jax():
    """PPO's value branch of MoE blocks adds its own blocks' terms: 2 trunk
    blocks and 1 branch block."""
    jcfg = jtf.config_from_preset("moe-tiny", vocab_size=V, dtype=jnp.float32)
    tcfg = tf.config_from_preset("moe-tiny", vocab_size=V, dtype=torch.float32)
    jmodel = j_policy.CausalLMWithValueHead(jcfg, num_value_layers=1)
    ids, mask = _rows(seed=4)
    jparams = jmodel.init(jax.random.PRNGKey(1), jnp.asarray(ids), jnp.asarray(mask))["params"]
    (_, j_values, _), inter = jmodel.apply({"params": jparams}, jnp.asarray(ids), jnp.asarray(mask),
                                           mutable=["intermediates"])
    tmodel = policy.CausalLMWithValueHead(tcfg, num_value_layers=1)
    tmodel.load_state_dict(params_from_jax(_np(jparams), tcfg))
    with torch.no_grad(), tf.collect_moe_aux() as terms:
        _, t_values, _ = tmodel(torch.from_numpy(ids).long(), torch.from_numpy(mask))
    assert len(terms) == 3 == len(jax.tree_util.tree_leaves(inter))
    _close(_t(t_values), j_values, 1e-5)
    _close(float(sum(terms)), float(jtf.moe_aux_from_intermediates(inter)), 1e-6)


def test_term_is_scoped_to_one_call_and_one_thread():
    """Forwards outside the block, and a forward in another thread while
    the block is open, add nothing to the call's terms; without experts
    the term is 0.0 and nothing is collected."""
    tcfg = tf.config_from_preset("moe-tiny", vocab_size=V, dtype=torch.float32)
    lm = tf.TransformerLM(tcfg)
    ids, mask = (torch.from_numpy(x) for x in _rows())
    ids = ids.long()
    seen = []

    def fwd():
        with torch.no_grad():
            lm(ids, mask)
        seen.append(1)

    with torch.no_grad():
        lm(ids, mask)  # no block open: nothing to collect into
        with tf.collect_moe_aux() as terms:
            worker = threading.Thread(target=fwd)
            worker.start()
            worker.join()
            assert terms == [] and seen == [1]
            lm(ids, mask)
        assert len(terms) == 2
        lm(ids, mask)
        assert len(terms) == 2
    dense = tf.config_from_preset("gpt2-tiny", vocab_size=V, dtype=torch.float32)
    assert apply_with_moe_aux(dense, lambda: 7)[1] == 0.0


# ---------------------------------------------------------------------------
# The trainers' losses under MoE
# ---------------------------------------------------------------------------


def _common(tmp, side, unfrozen=1, **train):
    return dict(
        train=dict(dict(seq_length=48, batch_size=4, epochs=2, total_steps=1000, eval_interval=1000,
                        checkpoint_interval=1000, seed=7, checkpoint_dir=str(tmp / side / "ckpts"),
                        logging_dir=str(tmp / side / "logs")), **train),
        model=dict(model_path="random:moe-tiny", num_layers_unfrozen=unfrozen,
                   model_extra_configs={"attn_impl": "flash", "dtype": "float32", "moe_aux_coef": 0.05}),
    )


def _pair(jcls, tcls, jconfig, tconfig, **kw):
    jt = jcls(jconfig, devices=jax.devices()[:1], **kw)
    tt = tcls(tconfig, device="cpu", **kw)
    tt.model.load_state_dict(params_from_jax(_np(jt.params), tt.model_cfg))
    if isinstance(getattr(tt, "ref_model", None), policy.HydraReference):  # the copy follows the loaded weights
        tt.ref_model = policy.HydraReference(tt.model.lm, tt.split)
    return jt, tt


def _check_params(jt, tt, steps):
    """The parameters after the steps against JAX's; an element whose
    exact gradient is near 0 may take Adam's +-lr step on one side only:
    such elements stay within 2 lr a step and are one in a thousand at
    most; every other element is within 2e-5. The key bias, whose exact
    gradient is 0 (a row's softmax ignores a shift shared by every key),
    is held to the bound alone, as in `test_torch_sft.py`."""
    lr = float(tt.config.optimizer.kwargs.get("lr", 1e-4))
    want = params_from_jax(_np(jt.params), tt.model_cfg)
    got = tt.model.state_dict()
    assert got.keys() == want.keys()
    for name, w in want.items():
        off = (got[name] - w).abs() > 2e-5 + 2e-5 * w.abs()
        assert float((got[name] - w).abs().max()) <= 2 * steps * lr, name
        assert name.endswith("k_proj.bias") or float(off.float().mean()) <= 1e-3, name
    trainable = {n for n, p in tt.model.named_parameters() if p.requires_grad}
    assert any(".mlp.router." in n for n in trainable) and any(n.endswith(".mlp.up_proj") for n in trainable)


def _check_stats(t_stats, j_stats):
    assert "moe_aux_loss" in j_stats and "moe_aux_loss" in t_stats
    assert set(j_stats) <= set(t_stats)
    for k, v in j_stats.items():
        _close(t_stats[k], v, 1e-5)
    assert 0.0 < t_stats["moe_aux_loss"]


def reward_fn(samples, prompts, outputs, **kw):
    return [sum(c.islower() or c == " " for c in o) / max(len(o), 1) + 0.01 * len(p)
            for p, o in zip(prompts, outputs)]


def _prompts(n, seed):
    rng = np.random.RandomState(seed)
    return ["".join(chr(97 + c) for c in rng.randint(0, 26, rng.randint(2, 14))) for _ in range(n)]


def _ppo_config(make, tmp, side, value_layers):
    return make().evolve(**_common(tmp, side), method=dict(
        num_rollouts=8, chunk_size=8, ppo_epochs=2, init_kl_coef=0.05, num_value_layers_unfrozen=value_layers,
        speculative_decode=True, cache_trunk_activations=True,
        gen_kwargs=dict(max_new_tokens=8, do_sample=False)))


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


def _losses(logging_dir, key):
    (path,) = [os.path.join(logging_dir, f) for f in os.listdir(logging_dir) if f.endswith(".metrics.jsonl")]
    with open(path) as f:
        return [row[key] for row in map(json.loads, f) if key in row]


# ---------------------------------------------------------------------------
# Serving, the speculative-decode refusals and the HF refusal
# ---------------------------------------------------------------------------


MAX_NEW = 8
PROMPTS = [list(range(60, 60 + n)) for n in (7, 9, 16, 17)]


def _serve(engine, prompts):
    outs = []
    for p in prompts:
        engine.insert_requests([(np.asarray(p, np.int32), MAX_NEW)], [0])
        toks = []
        for _ in range(MAX_NEW):
            t, _, v, f = engine.step()
            if v[0]:
                toks.append(int(t[0]))
            if f[0]:
                break
        engine.reclaim_slots([0])
        outs.append(toks)
    return outs
