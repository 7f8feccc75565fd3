"""The port's mixture-of-experts MLP (`MoEMLP`), its load-balancing term
(`collect_moe_aux`, `apply_with_moe_aux`) and every trainer's loss under
MoE, against the JAX package on the same numpy inputs and weights (carried
by `params_from_jax`), at f32 on the CPU.

Covered: the MLP alone over GLU or not and biases or not, its output and
term (1e-5) and the gradients of one scalar of both, the router's
included (1e-4); the LM over gpt2-, llama- (GQA) and neox-style
(parallel residual) blocks with left-padded rows, logits 1e-5 and the
term 1e-6 relative; one expert of top-1 equal to the dense MLP (1e-6);
cached decode against JAX's full forward (1e-4, JAX's own test); the term
under PPO's value branch of MoE blocks; the term scoped to one call and
one thread; SFT through `train(samples=...)`, PPO through
`train(reward_fn=...)`, PPO with and without the value branch, GRPO, RFT,
best-of-n and ILQL, each loss and its `moe_aux_loss` (1e-5) and the
parameters after the steps (2e-5, Adam's near-zero elements within 2 lr a
step, as in `test_torch_peft_trainers.py`); PPO's gates and the
speculative-decode refusals of the sampler and the engine; the int8
frozen-trunk view of the experts bitwise and its greedy collection token
for token; the engine's greedy streams token for token; the HF refusal.
PPO's rollouts and steps are `test_torch_moe_ppo.py`, the RFT and
best-of-n losses and the `train()` entry points
`test_torch_moe_trainers.py`, on this file's helpers.
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


@pytest.mark.parametrize("glu,bias", [(False, True), (False, False), (True, True), (True, False)])
def test_moe_mlp_and_its_gradients_match_jax(glu, bias):
    kw = dict(vocab_size=V, d_model=16, n_layers=1, n_heads=2, d_ff=32, glu=glu, use_bias=bias,
              activation="silu" if glu else "gelu", **MOE)
    jcfg, tcfg = jtf.TransformerConfig(dtype=jnp.float32, **kw), tf.TransformerConfig(dtype=torch.float32, **kw)
    rng = np.random.RandomState(1)
    h = rng.randn(2, 6, 16).astype(np.float32)
    w = rng.randn(2, 6, 16).astype(np.float32)
    jmod = jtf.MoEMLP(jcfg)
    jparams = jmod.init(jax.random.PRNGKey(0), jnp.asarray(h))["params"]
    if bias:  # non-zero biases, as training would make them
        jparams = {**jparams, "up_bias": jnp.asarray(rng.randn(4, 32), jnp.float32) * 0.1,
                   "down_bias": jnp.asarray(rng.randn(4, 16), jnp.float32) * 0.1}
    tmod = tf.MoEMLP(tcfg)
    tmod.load_state_dict(params_from_jax(_np(jparams)))
    assert {n: tuple(p.shape) for n, p in tmod.named_parameters()} == {
        **{"router.weight": (4, 16), "up_proj": (4, 16, 32), "down_proj": (4, 32, 16)},
        **({"gate_proj": (4, 16, 32)} if glu else {}),
        **({"up_bias": (4, 32), "down_bias": (4, 16)} if bias else {})}

    def j_scalar(params, x):
        out, inter = jmod.apply({"params": params}, x, mutable=["intermediates"])
        aux = jtf.moe_aux_from_intermediates(inter)
        return jnp.sum(out * jnp.asarray(w)) + aux, (out, aux)

    (j_val, (j_out, j_aux)), (j_gp, j_gh) = jax.value_and_grad(j_scalar, argnums=(0, 1), has_aux=True)(
        jparams, jnp.asarray(h))
    th = torch.from_numpy(h).requires_grad_(True)
    with tf.collect_moe_aux() as terms:
        t_out = tmod(th)
    assert len(terms) == 1
    t_val = (t_out * torch.from_numpy(w)).sum() + terms[0]
    t_val.backward()
    _close(_t(t_out), j_out, 1e-5)
    _close(float(terms[0].detach()), float(j_aux), 1e-5)
    _close(float(t_val.detach()), float(j_val), 1e-5)
    _close(_t(th.grad), j_gh, 1e-4)
    want = params_from_jax(_np(j_gp))
    for name, p in tmod.named_parameters():
        _close(_t(p.grad), want[name].numpy(), 1e-4)
    assert float(tmod.router.weight.grad.abs().max()) > 0  # the term and the gates reach the router


@pytest.mark.parametrize("preset", ["moe-tiny", "llama-tiny", "neox-tiny"])
def test_moe_lm_and_term_match_jax_on_padded_rows(preset):
    """gpt2-style, llama-style (GLU, no biases, GQA) and neox-style
    (parallel residual) blocks with MoE MLPs: logits over left-padded rows
    and the term, whose means run over the padding too."""
    jcfg = jtf.config_from_preset(preset, vocab_size=V, dtype=jnp.float32, **MOE)
    tcfg = tf.config_from_preset(preset, vocab_size=V, dtype=torch.float32, **MOE)
    jlm = jtf.TransformerLM(jcfg)
    ids, mask = _rows()
    jparams = jlm.init(jax.random.PRNGKey(2), jnp.asarray(ids), jnp.asarray(mask))["params"]
    (j_logits, _, _), inter = jlm.apply({"params": jparams}, jnp.asarray(ids), jnp.asarray(mask),
                                        mutable=["intermediates"])
    tlm = tf.TransformerLM(tcfg)
    tlm.load_state_dict(params_from_jax(_np(jparams)))
    with torch.no_grad():
        (t_logits, _, _), t_aux = apply_with_moe_aux(tcfg, tlm, torch.from_numpy(ids).long(), torch.from_numpy(mask))
    _close(_t(t_logits), j_logits, 1e-5)
    _close(float(t_aux), jcfg.moe_aux_coef * float(jtf.moe_aux_from_intermediates(inter)), 1e-6)
    with torch.no_grad():  # padding rows count: dropping them moves the term
        _, t_aux_real = apply_with_moe_aux(tcfg, tlm, torch.from_numpy(ids[:1]).long(), torch.from_numpy(mask[:1]))
    assert abs(float(t_aux_real) - float(t_aux)) > 1e-6


def test_single_expert_top1_equals_the_dense_mlp():
    kw = dict(vocab_size=V, d_model=16, n_layers=1, n_heads=2, d_ff=32, use_bias=False, dtype=torch.float32)
    dense = tf.MLP(tf.TransformerConfig(**kw))
    moe = tf.MoEMLP(tf.TransformerConfig(moe_experts=1, moe_top_k=1, **kw))
    with torch.no_grad():
        moe.up_proj.copy_(dense.up_proj.weight.T[None])
        moe.down_proj.copy_(dense.down_proj.weight.T[None])
        h = torch.from_numpy(np.random.RandomState(0).randn(2, 6, 16).astype(np.float32))
        torch.testing.assert_close(moe(h), dense(h), atol=1e-6, rtol=1e-6)


def test_moe_decode_matches_jax_forward():
    """The cached prefill and decode steps against JAX's full forward (the
    JAX package's `test_moe_decode_matches_forward`, across packages)."""
    jcfg = jtf.config_from_preset("moe-tiny", vocab_size=V, dtype=jnp.float32)
    tcfg = tf.config_from_preset("moe-tiny", vocab_size=V, dtype=torch.float32)
    jlm = jtf.TransformerLM(jcfg)
    tokens = np.random.default_rng(0).integers(0, V, (2, 10)).astype(np.int32)
    mask = np.ones_like(tokens)
    jparams = jlm.init(jax.random.PRNGKey(0), jnp.asarray(tokens), jnp.asarray(mask))["params"]
    full = np.asarray(jlm.apply({"params": jparams}, jnp.asarray(tokens), jnp.asarray(mask))[0])
    tlm = tf.TransformerLM(tcfg)
    tlm.load_state_dict(params_from_jax(_np(jparams)))
    tt, tm = torch.from_numpy(tokens).long(), torch.from_numpy(mask)
    cache = tf.init_kv_cache(tcfg, 2, 10, dtype=torch.float32)
    with torch.no_grad():
        logits, _, cache = tlm.decode_step(tt[:, :5], cache, tm[:, :5], True)
        _close(_t(logits), full[:, :5], 1e-4)
        for i in range(5, 10):
            logits, _, cache = tlm.decode_step(tt[:, i:i + 1], cache, tm[:, i:i + 1], False)
            _close(_t(logits[:, 0]), full[:, i], 1e-4)


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


def test_int8_frozen_trunk_of_moe_matches_jax(tmp_path):
    """`quantize_frozen_trunk` at split 1: the port's int8 leaves are
    bitwise JAX's `quantize_frozen_flat` (codes, scales, the dequantized
    weights), one scale per index of the last axis of JAX's layout: the
    router's kernel is the port's weight transposed, the experts'
    [E, d, f] and [E, f, d] leaves are the same tensors. A greedy
    collection of 8 rollouts from that view equals JAX's token for token,
    its logprobs, values and rewards within 1e-5."""
    def config(make, side):
        return _ppo_config(make, tmp_path, side, 0).evolve(method=dict(
            quantize_frozen_trunk=True, speculative_decode=False, cache_trunk_activations=False))

    jt, tt = _pair(JPPOTrainer, PPOTrainer, config(j_default_ppo_config, "jax"), config(default_ppo_config, "torch"),
                   reward_fn=reward_fn, stop_sequences=["�"])
    assert tt.split == jt.split == 1
    jt._decode_params()
    want = {}
    for key, node in jt._quant_frozen_cache.items():
        if not j_quant.is_quant_leaf(node):
            continue
        *mods, leaf = [str(k) for k in key]
        q, dense = np.asarray(node["q"]), np.asarray(j_quant.dequantize_array(node))
        if leaf == "kernel":
            q, dense = q.T, dense.T
        want[".".join([*mods, {"kernel": "weight", "embedding": "weight"}.get(leaf, leaf)])] = (
            q, np.asarray(node["scale"]), dense)
    got = tt._decode_params()
    assert set(got) == set(want)
    assert {"lm.block_0.mlp.router.weight", "lm.block_0.mlp.up_proj", "lm.block_0.mlp.down_proj"} <= set(got) and "lm.block_1.mlp.up_proj" not in got
    dense = quant.dequantize_tree(got, torch.float32)
    for name, (q, scale, d) in want.items():
        np.testing.assert_array_equal(got[name][0].numpy(), q, err_msg=name)
        np.testing.assert_array_equal(got[name][1].numpy().reshape(-1), scale, err_msg=name)
        np.testing.assert_array_equal(dense[name].numpy(), d, err_msg=name)
    prompts = _prompts(12, 0)
    jt.add_prompt_pipeline(JPromptPipeline(prompts, 40, jt.tokenizer))
    tt.add_prompt_pipeline(PromptPipeline(prompts, 40, tt.tokenizer))
    jt.make_experience(8)
    tt.make_experience(8)
    assert len(tt.store.history) == len(jt.store.history) == 8
    for e, je in zip(tt.store.history, jt.store.history):
        np.testing.assert_array_equal(e.response_tensor, np.asarray(je.response_tensor))
        for f in ("logprobs", "values", "rewards"):
            _close(getattr(e, f), getattr(je, f), 1e-5)


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


def test_one_grpo_step_matches_jax(tmp_path):
    mk = lambda make, side: make().evolve(**_common(tmp_path, side), method=dict(
        num_rollouts=8, chunk_size=8, ppo_epochs=1, group_size=G, init_kl_coef=0.05, grpo_kl_coef=0.1,
        gen_kwargs=dict(max_new_tokens=8, do_sample=False)))
    jt, tt = _pair(JGRPOTrainer, GRPOTrainer, mk(j_default_grpo_config, "jax"), mk(default_grpo_config, "torch"),
                   reward_fn=reward_fn)
    prompts, outputs, scores, (lp, vals, lr) = _grpo_chunk(0)
    args = (prompts, outputs, None, scores, np.ones_like(scores, bool), lp, vals, lr)
    jt.store.push(jt._chunk_to_elements(*args))
    tt.store.push(tt._chunk_to_elements(*args))
    jb = next(iter(jt.create_train_dataloader()))
    fields = ("query_tensors", "response_tensors", "logprobs", "values", "rewards", "group_ids")
    ib = PPORLBatch(**{f: np.asarray(getattr(jb, f)) for f in fields})
    _check_stats(tt.train_minibatch([ib]), flatten_dict(_np(jt.train_minibatch([jb]))))
    _check_params(jt, tt, 1)


def test_one_ilql_step_matches_jax(tmp_path):
    """The ILQL loss (Q, V, CQL and AWAC terms) plus the MoE term, its
    `losses/loss` the optimised sum, then one step."""
    mk = lambda make, side: make().evolve(**_common(tmp_path, side, seq_length=24), method=dict(
        steps_for_target_q_sync=5, alpha=0.3, beta=1.0, gen_kwargs=dict(max_new_tokens=6, top_k=5, beta=1.0)))
    jt, tt = _pair(JILQLTrainer, ILQLTrainer, mk(j_default_ilql_config, "jax"), mk(default_ilql_config, "torch"))
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
    _check_stats(t_stats, j_stats)
    _close(t_stats["losses/loss"], j_stats["losses/loss"], 1e-5)
    _check_params(jt, tt, 1)


def _losses(logging_dir, key):
    (path,) = [os.path.join(logging_dir, f) for f in os.listdir(logging_dir) if f.endswith(".metrics.jsonl")]
    with open(path) as f:
        return [row[key] for row in map(json.loads, f) if key in row]


# ---------------------------------------------------------------------------
# Serving, the speculative-decode refusals and the HF refusal
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sft_pair():
    jcfg = j_default_sft_config().evolve(
        model=dict(model_path="random:moe-tiny", model_extra_configs={"dtype": "float32"}),
        tokenizer=dict(tokenizer_path="byte"), train=dict(seq_length=64, total_steps=0, tracker=None, batch_size=2))
    jt = JSFTTrainer(jcfg, devices=jax.devices()[:1])
    tt = SFTTrainer(default_sft_config().evolve(**{k: v for k, v in jcfg.to_dict().items()
                                                   if k in ("model", "tokenizer", "train")}), device="cpu")
    tt.model.load_state_dict(params_from_jax(_np(jt.params), tt.model_cfg))
    return jt, tt


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


@pytest.mark.parametrize("paging,kernel", [(True, "auto"), (True, "xla"), (False, "auto")])
def test_engine_serves_moe_greedy_as_jax(sft_pair, paging, kernel):
    """The paged arena (the decode kernel's plain version, and the gather
    path) and the fixed-slot pool serve the MoE policy's greedy streams
    token for token as JAX's engine does."""
    jt, tt = sft_pair
    kw = dict(num_slots=2, max_prompt_len=32, kv_paging=paging, kv_block_size=8)
    gen = dict(max_new_tokens=MAX_NEW, do_sample=False, eos_token_id=10_000, pad_token_id=tt.tokenizer.pad_token_id)
    jeng = JEngine(jt.model, jt.model_cfg, jt.params, j_sampling.GenerationConfig(**gen),
                   decode_kernel="xla" if kernel == "xla" else "pallas", **kw)
    teng = InferenceEngine(tt.model, tt.model_cfg, None, sampling.GenerationConfig(**gen), decode_kernel=kernel, **kw)
    assert _serve(teng, PROMPTS) == _serve(jeng, PROMPTS)


def test_speculative_decode_under_moe_is_refused_as_in_jax(sft_pair):
    jt, tt = sft_pair
    gen = dict(max_new_tokens=4, do_sample=False, eos_token_id=10_000, pad_token_id=0)
    spec = dict(spec_k=2, spec_split=1, spec_draft_head=(np.zeros((64, 2)), np.zeros((2, 257))))
    with pytest.raises(NotImplementedError) as jerr:
        j_sampling.make_generate_fn(jt.model, jt.model_cfg, j_sampling.GenerationConfig(**gen), **spec)
    with pytest.raises(NotImplementedError) as terr:
        sampling.make_generate_fn(tt.model, tt.model_cfg, sampling.GenerationConfig(**gen), **spec)
    assert str(terr.value) == str(jerr.value)
    kw = dict(num_slots=2, max_prompt_len=32, kv_paging=True, kv_block_size=8, spec_k=2, spec_split=1)
    with pytest.raises(NotImplementedError) as jerr:
        JEngine(jt.model, jt.model_cfg, jt.params, j_sampling.GenerationConfig(**gen), **kw)
    with pytest.raises(NotImplementedError) as terr:
        InferenceEngine(tt.model, tt.model_cfg, None, sampling.GenerationConfig(**gen), **kw)
    assert str(terr.value) == str(jerr.value)


def test_hf_load_and_export_of_moe_are_refused(sft_pair, tmp_path):
    """The JAX package has no HF layout for experts (its export fails on
    the expert tensors); the port refuses load and export up front with a
    message that says so, and `save_pretrained` writes the raw state dict
    instead, as JAX's writes its parameters instead."""
    jt, tt = sft_pair
    with pytest.raises(Exception):
        j_params_to_hf_state_dict(jt.params, jt.model_cfg)
    state = tt.model.state_dict()
    for call in (lambda: hf_interop.params_to_hf_state_dict(state, tt.model_cfg),
                 lambda: hf_interop.config_to_hf(tt.model_cfg),
                 lambda: hf_interop.load_params_from_hf(str(tmp_path), tt.model_cfg, state)):
        with pytest.raises(NotImplementedError, match="MoE blocks have no HF checkpoint layout"):
            call()
    tt.save_pretrained(str(tmp_path / "export"))
    assert "model_state.pt" in os.listdir(tmp_path / "export")
