"""PPO's deeper value branch (`method.num_value_layers_unfrozen > 0`) in the
port against the JAX package on the same numpy inputs and weights
(carried by `params_from_jax`): the branch's forwards, its clones, the
refusals under a branch, the trainer's gates, and PPOTrainer end to end
with the full-forward loss, the trunk cache and the pipelined cycle.

Models are gpt2-tiny (branch depth 1, tapping at the split) and
llama-tiny (depth 2, tapping at the embeddings) at f32 with
`attn_impl="flash"`; on the CPU the port's kernel wrappers run their
plain versions and the JAX package runs as its own CPU tests run it.

Tolerances (those of `test_torch_ppo.py` and `test_torch_ppo_options.py`):
the forwards 1e-5; the clones bitwise; greedy rollouts token for token,
their logprobs, values and rewards 1e-5; the first step's loss and stats
1e-5; the parameters after 3 AdamW steps 2e-5 (the key bias, whose exact
gradient is 0, within its bound); the f32 cached loss 1e-6 of the full
one; a resumed run bitwise the uninterrupted one; two pipelined cycles:
samples exactly, losses 1e-5.
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


def _padded_tokens():
    rng = np.random.RandomState(4)
    tokens = rng.randint(0, V - 2, (3, 12)).astype(np.int32)
    tokens[1, :4] = PAD
    tokens[2, 9:] = PAD
    return tokens, (tokens != PAD).astype(np.int32)


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


@pytest.fixture(scope="module")
def ppo_pair(tmp_path_factory):
    """Both trainers: one greedy collection of 8 rollouts, then STEPS
    optimizer steps on the JAX loader's batches, injected into both."""
    jt, tt = _pair(tmp_path_factory.mktemp("branch"))
    prompts = _prompts(12, 0)
    jt.add_prompt_pipeline(JPromptPipeline(prompts, 40, jt.tokenizer))
    tt.add_prompt_pipeline(PromptPipeline(prompts, 40, tt.tokenizer))
    jt.make_experience(8)
    tt.make_experience(8)
    jbatches = [b for _ in range(2) for b in jt.create_train_dataloader()][:STEPS]
    fields = ("query_tensors", "response_tensors", "logprobs", "values", "rewards")
    injected = [PPORLBatch(**{f: np.asarray(getattr(b, f)) for f in fields}) for b in jbatches]
    j_stats, t_stats = [], []
    for jb, ib in zip(jbatches, injected):
        j_stats.append(flatten_dict(jax.tree_util.tree_map(np.asarray, jt.train_minibatch([jb]))))
        t_stats.append(tt.train_minibatch([ib]))
    return dict(jt=jt, tt=tt, injected=injected, j_stats=j_stats, t_stats=t_stats)


def test_greedy_rollouts_scores_and_values_match_jax(ppo_pair):
    """Tokens exactly equal; the branch's values, the logprobs and the
    rewards 1e-5."""
    jt, tt = ppo_pair["jt"], ppo_pair["tt"]
    assert tt.model.num_value_layers == 1 and len(tt.store) == len(jt.store) == 8
    for e, je in zip(tt.store.history, jt.store.history):
        np.testing.assert_array_equal(e.query_tensor, np.asarray(je.query_tensor))
        np.testing.assert_array_equal(e.response_tensor, np.asarray(je.response_tensor))
        for f in ("logprobs", "values", "rewards"):
            _close(getattr(e, f), getattr(je, f), 1e-5)
    assert max(float(np.abs(e.values).max()) for e in tt.store.history) > 0


def test_first_step_loss_and_stats_match_jax(ppo_pair):
    assert not ppo_pair["tt"]._window_loss_ok()
    t, j = ppo_pair["t_stats"][0], ppo_pair["j_stats"][0]
    for k, v in j.items():
        _close(t[k], v, 1e-5)
    assert abs(t["losses/value_loss"]) > 0


def test_params_after_three_steps_match_jax_branch_included(ppo_pair):
    jt, tt = ppo_pair["jt"], ppo_pair["tt"]
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jt.params), tt.model_cfg)
    got = tt.model.state_dict()
    trainable = {n for n, p in tt.model.named_parameters() if p.requires_grad}
    assert "value_branch.block_0.attn.q_proj.weight" in trainable and "value_branch.v_head.dense_out.weight" in trainable
    for name, w in want.items():
        if name.endswith("k_proj.bias"):
            # exact gradient 0: Adam turns rounding noise into steps of +-lr (3e-5)
            assert float((got[name] - w).abs().max()) <= 2 * STEPS * 3e-5
            continue
        torch.testing.assert_close(got[name], w, rtol=2e-5, atol=2e-5)
        if name not in trainable:
            assert torch.equal(got[name], w), f"frozen {name} moved"
    # the branch trained apart from the trunk block it was cloned from
    assert not torch.equal(got["value_branch.block_0.mlp.up_proj.weight"], got["lm.block_1.mlp.up_proj.weight"])


def test_cached_loss_matches_the_full_forward(ppo_pair):
    """The trunk-cache step (forward_from_cache, the branch fed from the
    cache) against the full forward's loss, 1e-6, with f32 caches."""
    tt = ppo_pair["tt"]
    batch = tt.batch_to_device(ppo_pair["injected"][0])
    tokens = torch.cat([batch.query_tensors, batch.response_tensors], dim=1)
    mask = (tokens != tt.tokenizer.pad_token_id).long()
    loss_fn = tt.make_loss_fn()
    with torch.no_grad():
        cache = tt.model.forward_trunk(tokens, mask, position_ids(mask), tt.split)
        full, stats_f = loss_fn(batch)
        cached, stats_c = loss_fn(PPORLBatch(**{**batch.__dict__, "h_split": cache}))
    _close(cached, full, 1e-6)
    for k in stats_f:
        _close(stats_c[k], stats_f[k], 1e-6)


def _train_run(tmp, side, **train):
    import trlx_tpu_torch

    cfg = _ppo_config(default_ppo_config, tmp, side, gen_kwargs=dict(max_new_tokens=8, do_sample=True),
                      cache_trunk_activations=True).evolve(train=dict(checkpoint_interval=1, **train))
    return trlx_tpu_torch.train(reward_fn=reward_fn, prompts=_prompts(12, 1), config=cfg, stop_sequences=STOP,
                                device="cpu")


def test_train_with_a_branch_and_the_trunk_cache_resumes_exactly(tmp_path):
    """`trlx_tpu_torch.train(reward_fn=...)` with a branch and the trunk
    cache (its tap at the split, so the gate holds): two collections of
    2 inner epochs; a run resumed from step 3 ends bitwise equal to the
    uninterrupted one, the branch included."""
    full = _train_run(tmp_path, "full")
    assert full.iter_count == 8 and full._trunk_cache_available()
    assert all(e.h_split is not None for e in full.store.history)
    resumed = _train_run(tmp_path, "resumed",
                         resume_from_checkpoint=os.path.join(tmp_path, "full", "ckpts", "checkpoint_3"))
    assert resumed.iter_count == 8
    for a, b in ((full.model, resumed.model), (full.ref_model, resumed.ref_model)):
        for (name, x), y in zip(a.state_dict().items(), b.state_dict().values()):
            assert torch.equal(x, y), name
    assert full.kl_ctl.value == resumed.kl_ctl.value and full.mean_kl == resumed.mean_kl


def test_pipelined_cycle_under_a_branch_takes_the_speculative_scorer(tmp_path):
    """With `capture_rollout_stats` on, a branch turns the fast path off
    (no per-step values) and the cycle scores speculatively, with no
    fallback; two greedy cycles match the JAX trainer's: samples exactly,
    losses 1e-5."""
    kw = dict(gen_kwargs=dict(max_new_tokens=6, do_sample=False, suppress_tokens=SUPPRESS),
              capture_rollout_stats=True)
    jt, tt = _pair(tmp_path, **kw)
    tt.config = tt.config.evolve(train=dict(batch_size=8))
    jt.config = jt.config.evolve(train=dict(batch_size=8))
    prompts = ["hello world", "jax tpu", "ppo", "cycle", "fast path", "torch", "hopper", "scorer"]
    tt.add_prompt_pipeline(PromptPipeline(prompts, 8, tt.tokenizer))
    jt.add_prompt_pipeline(JPromptPipeline(prompts, 8, jt.tokenizer))
    tt.stop_sequences = jt.stop_sequences = []
    assert not tt._fast_rollout_available() and tt._spec_path_available()
    calls = []
    for name in ("_dispatch_spec_score", "_dispatch_fast_score", "_score_reward"):
        fn = getattr(tt, name)
        setattr(tt, name, lambda *a, _fn=fn, _name=name, **k: (calls.append(_name), _fn(*a, **k))[1])
    pending, jpending, losses = None, None, []
    for _ in range(2):
        loss, pending = tt.pipelined_cycle(pending)
        jloss, jpending = jt.pipelined_cycle(jpending)
        losses.append((loss, jloss))
        for (_, o), (_, jo) in zip(pending[0], jpending[0]):
            np.testing.assert_array_equal(o["samples"].numpy(), np.asarray(jo["samples"]))
    assert calls == ["_dispatch_spec_score"] * 3 and tt.spec_fallbacks == 0
    assert losses[1][0] == pytest.approx(losses[1][1], rel=1e-5, abs=1e-6)
    assert float(pending[2][0]) == pytest.approx(float(np.asarray(jpending[2][0])), rel=1e-5, abs=1e-6)
