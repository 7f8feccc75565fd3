"""GRPO and RLOO in the port (`ops/ppo.py` group advantages and loss, the
store's group ids, `CausalLMPolicy`, `GRPOTrainer` and
`default_grpo_config`) against the JAX package on the same numpy inputs
and the same weights (carried by `params_from_jax`).

The trainers run gpt2-tiny at f32 with `attn_impl="flash"`; on the CPU the
port's kernel wrappers run their plain versions and the JAX trainers run
as their own CPU tests run them.

Tolerances: the advantages, the loss and its stats 1e-6 (f32, the same
expressions), and tests/test_grpo.py's hand cases at its own tolerances;
collation exactly; the scorer's policy and reference logprobs 1e-5; the
elements of an injected chunk 1e-6, their group ids exactly; the first
step's stats 1e-5; the parameters after 3 AdamW steps 2e-5 (the key
bias, whose exact gradient is 0, within its bound); the gates exactly.
The trainer pair's cases are in `test_torch_grpo_steps.py`, so that
`--dist loadfile` hands them out after the large files.
"""

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

torch.set_num_threads(1)

STEPS = 3
G = 4


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# The math: group-relative advantages and the GRPO loss
# ---------------------------------------------------------------------------

REWARDS_2x3 = np.array([[1.0, 2.0, 3.0], [5.0, 5.0, 8.0]], dtype=np.float32)


@pytest.mark.parametrize("mode", ["grpo", "rloo"])
@pytest.mark.parametrize("g", [1, 3, 8])
def test_group_relative_advantages_match_jax(mode, g):
    rng = np.random.RandomState(g)
    rewards = rng.randn(5, g).astype(np.float32)
    rewards[1] = 7.0  # a degenerate group: exactly zero under both modes (g > 1)
    got = ppo.group_relative_advantages(_t(rewards), mode=mode)
    _close(got, j_ppo.group_relative_advantages(jnp.asarray(rewards), mode=mode), 1e-6)
    assert not got.requires_grad and got.dtype == torch.float32
    if g > 1:
        assert bool((got[1] == 0).all())


def test_group_relative_advantages_hand_cases():
    """tests/test_grpo.py's cases, on the port."""
    adv = ppo.group_relative_advantages(_t(REWARDS_2x3), mode="grpo").numpy()
    s0, s1, eps = np.sqrt(2.0 / 3.0), np.sqrt(2.0), 1e-4
    expected = np.array([[(1 - 2) / (s0 + eps), 0.0, (3 - 2) / (s0 + eps)],
                         [(5 - 6) / (s1 + eps), (5 - 6) / (s1 + eps), (8 - 6) / (s1 + eps)]], dtype=np.float32)
    np.testing.assert_allclose(adv, expected, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(adv.mean(axis=-1), 0.0, atol=1e-5)
    np.testing.assert_allclose(ppo.group_relative_advantages(_t(REWARDS_2x3), mode="rloo").numpy(),
                               [[-1.5, 0.0, 1.5], [-1.5, -1.5, 3.0]], rtol=1e-6)
    for mode in ("grpo", "rloo"):
        same = ppo.group_relative_advantages(torch.full((2, 4), 7.0), mode=mode).numpy()
        assert np.all(np.isfinite(same)) and np.allclose(same, 0.0, atol=1e-6)
    r = _t(np.array([[2.5], [-1.0]], np.float32))
    np.testing.assert_allclose(ppo.group_relative_advantages(r, mode="rloo").numpy(), r.numpy())
    with pytest.raises(ValueError, match="advantage_mode"):
        ppo.group_relative_advantages(torch.ones(1, 2), mode="vtrace")


def test_grpo_loss_and_every_stat_match_jax():
    rng = np.random.RandomState(3)
    logprobs = rng.randn(4, 8).astype(np.float32)
    old = logprobs + 0.3 * rng.randn(4, 8).astype(np.float32)  # some ratios clip, some do not
    ref = logprobs + 0.5 * rng.randn(4, 8).astype(np.float32)
    adv = rng.randn(4, 8).astype(np.float32)
    mask = (rng.rand(4, 8) > 0.3).astype(np.float32)
    mask[0] = 0.0
    kw = dict(cliprange=0.2, kl_coef=0.1)
    loss, stats = ppo.grpo_loss(_t(logprobs), _t(old), _t(ref), _t(adv), _t(mask), **kw)
    j_loss, j_stats = j_ppo.grpo_loss(*map(jnp.asarray, (logprobs, old, ref, adv, mask)), **kw)
    _close(loss, j_loss, 1e-6)
    got, want = flatten_dict(stats), flatten_dict(jax.tree_util.tree_map(np.asarray, j_stats))
    assert got.keys() == want.keys() and "losses/value_loss" not in got
    for k in got:
        _close(got[k], want[k], 1e-6)


def test_grpo_loss_hand_cases():
    """tests/test_grpo.py's value, clip and padding cases, on the port."""
    one = lambda x: _t(np.asarray(x, np.float32))
    loss, stats = ppo.grpo_loss(one([[-1.0, -2.0]]), one([[-1.0, -2.0]]), one([[-1.5, -2.5]]), one([[1.0, 0.5]]),
                                torch.ones(1, 2), cliprange=0.2, kl_coef=0.1)
    pg, k3 = -(1.0 + 0.5) / 2.0, np.exp(-0.5) + 0.5 - 1.0
    assert np.isclose(float(loss), pg + 0.1 * k3, rtol=1e-5)
    assert np.isclose(float(stats["losses"]["kl_loss"]), k3, rtol=1e-5)
    loss, stats = ppo.grpo_loss(one([[0.0]]), one([[-1.0]]), one([[0.0]]), one([[2.0]]), torch.ones(1, 1),
                                cliprange=0.2, kl_coef=0.0)
    assert np.isclose(float(loss), -2.4, rtol=1e-5) and float(stats["policy"]["clipfrac"]) == 1.0
    junk = 1e3
    loss_pad, stats = ppo.grpo_loss(one([[-1.0, -2.0], [-junk, -junk]]), one([[-1.0, -2.0], [junk, junk]]),
                                    one([[-1.5, -2.5], [junk, junk]]), one([[1.0, 0.5], [junk, junk]]),
                                    one([[1.0, 1.0], [0.0, 0.0]]), cliprange=0.2, kl_coef=0.1)
    assert np.isclose(float(loss_pad), pg + 0.1 * k3, rtol=1e-5)
    assert np.isclose(float(stats["padding_percentage"]), 0.5)


def _elements(group_ids):
    t = np.arange(4, dtype=np.int32)
    z = np.zeros(4, dtype=np.float32)
    return ([PPORLElement(query_tensor=t, response_tensor=t, logprobs=z, values=z, rewards=z, group_id=g)
             for g in group_ids],
            [JPPORLElement(query_tensor=t, response_tensor=t, logprobs=z, values=z, rewards=z, group_id=g)
             for g in group_ids])


@pytest.mark.parametrize("group_ids", [(0, 0, 1, 1), (None,) * 4, (0, None, 1, 1)])
def test_rollout_store_collates_group_ids_as_jax(group_ids):
    ours, theirs = _elements(group_ids)
    store, j_store = PPORolloutStorage(pad_token_id=0), JPPORolloutStorage(pad_token_id=0)
    store.push(ours)
    j_store.push(theirs)
    got = next(iter(store.create_loader(4, shuffle=False))).group_ids
    want = next(iter(j_store.create_loader(4, shuffle=False))).group_ids
    if want is None:
        assert got is None
    else:
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, np.asarray(want))


# ---------------------------------------------------------------------------
# The critic-free policy and the trainer's construction
# ---------------------------------------------------------------------------


def reward_fn(samples, prompts, outputs, **kw):
    return [sum(c.islower() for c in o) / max(len(o), 1) + 0.01 * len(p) for p, o in zip(prompts, outputs)]


def _grpo_config(make, tmp, side, mode="grpo", unfrozen=1, **method):
    return make().evolve(
        train=dict(seq_length=48, batch_size=4, epochs=2, total_steps=1000, eval_interval=1000,
                   checkpoint_interval=1000, seed=7, checkpoint_dir=str(tmp / side / "ckpts"),
                   logging_dir=str(tmp / side / "logs")),
        model=dict(model_path="random:gpt2-tiny", num_layers_unfrozen=unfrozen,
                   model_extra_configs={"attn_impl": "flash", "dtype": "float32"}),
        method=dict(dict(num_rollouts=8, chunk_size=8, ppo_epochs=2, group_size=G, advantage_mode=mode,
                         init_kl_coef=0.05, grpo_kl_coef=0.1, gen_kwargs=dict(max_new_tokens=8, do_sample=False)),
                    **method),
    )


def test_critic_free_policy_has_no_value_parameters():
    cfg = default_grpo_config().evolve(model=dict(model_path="random:gpt2-tiny"))
    model, mcfg, sd = build_model(cfg.model, 64, seed=0, device="cpu", value_head=False)
    assert isinstance(model, CausalLMPolicy)
    assert sd and all(k.startswith("lm.") for k in sd) and not any("v_head" in k or "value" in k for k in sd)
    tokens = torch.randint(0, 64, (2, 6))
    mask = torch.ones_like(tokens)
    logits, values, h = model(tokens, mask)
    assert values is None and logits.shape == (2, 6, 64) and h.shape == (2, 6, mcfg.d_model)
    assert model.forward_window(tokens, mask, None, 2, 3)[1] is None
    torch.testing.assert_close(model.forward_window(tokens, mask, None, 2, 3)[0], logits[:, 2:5], rtol=1e-6,
                               atol=1e-6)
    with pytest.raises(NotImplementedError, match="no value head"):
        model.decode_step(tokens, None, mask, with_value=True)
    with pytest.raises(NotImplementedError, match="no value head"):
        model.spec_verify_rows(None, None, 0, None, 1, with_value=True)
    for bad, match in ((dict(with_ilql_heads=True), "with_ilql_heads"), (dict(num_value_layers=1), "value branch")):
        with pytest.raises(ValueError, match=match):
            build_model(cfg.model, 64, device="cpu", value_head=False, **bad)


@pytest.mark.parametrize("method,match", [
    (dict(advantage_mode="gae"), "advantage_mode"),
    (dict(group_size=0), "group_size"),
    (dict(chunk_size=6, num_rollouts=6), "group_size"),
    ("unfrozen0", "num_layers_unfrozen"),
])
def test_config_refusals_match_jax(tmp_path, method, match):
    unfrozen = 0 if method == "unfrozen0" else 1
    kw = {} if method == "unfrozen0" else method
    with pytest.raises(ValueError, match=match):
        JGRPOTrainer(_grpo_config(j_default_grpo_config, tmp_path, "jax", unfrozen=unfrozen, **kw),
                     reward_fn=reward_fn, devices=jax.devices()[:1])
    with pytest.raises(ValueError, match=match):
        GRPOTrainer(_grpo_config(default_grpo_config, tmp_path, "torch", unfrozen=unfrozen, **kw),
                    reward_fn=reward_fn, device="cpu")


def test_default_grpo_config_is_a_full_method_swap():
    ours, theirs = default_grpo_config().to_dict(), j_default_grpo_config().to_dict()
    assert ours["method"] == theirs["method"]
    assert ours["train"]["trainer"] == "GRPOTrainer"
    assert not {"gamma", "lam", "vf_coef", "cliprange_value"} & set(ours["method"])


# ---------------------------------------------------------------------------
# The trainer against the JAX trainer
# ---------------------------------------------------------------------------


def _pair(tmp, mode="grpo", unfrozen=1, tokenizer="byte", **method):
    kw = dict(tokenizer=dict(tokenizer_path=tokenizer))
    jt = JGRPOTrainer(_grpo_config(j_default_grpo_config, tmp, "jax", mode, unfrozen, **method).evolve(**kw),
                      reward_fn=reward_fn, devices=jax.devices()[:1])
    tt = GRPOTrainer(_grpo_config(default_grpo_config, tmp, "torch", mode, unfrozen, **method).evolve(**kw),
                     reward_fn=reward_fn, device="cpu")
    tt.model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, jt.params), tt.model_cfg))
    tt.ref_model = HydraReference(tt.model.lm, tt.split)
    return jt, tt


def _chunk(seed, q=6, r=5, scores=None):
    """An injected rollout chunk of 2 groups of G: left-padded prompts,
    responses right-padded to different lengths (one empty), host scores
    and the scorer's [b, q + r - 1] stats."""
    rng = np.random.RandomState(seed)
    b = 2 * G
    prompts = rng.randint(1, 200, (b, q)).astype(np.int32)
    prompts[:, :2] = 256  # the byte tokenizer's pad
    outputs = rng.randint(1, 200, (b, r)).astype(np.int32)
    for i, n in enumerate([5, 3, 0, 5, 1, 4, 5, 2]):
        outputs[i, n:] = 256
    scores = rng.randn(b, 1).astype(np.float32) if scores is None else scores
    stats = [rng.randn(b, q + r - 1).astype(np.float32) for _ in range(3)]
    return prompts, outputs, scores, stats


@pytest.mark.parametrize("unfrozen", [-1, 1])
def test_scorer_returns_reference_logprobs_as_jax(tmp_path, unfrozen):
    """The values slot carries the frozen reference's logprobs (here after
    the reference moved away from the policy, alike on both sides), on
    rows padded at both ends."""
    jt, tt = _pair(tmp_path, unfrozen=unfrozen)
    jt.ref_params = jax.tree_util.tree_map(lambda x: x + 0.01, jt.ref_params)
    with torch.no_grad():
        for p in tt.ref_model.parameters():
            p.add_(0.01)
    prompts, outputs, _, _ = _chunk(2)
    all_tokens = np.concatenate([prompts, outputs], axis=1)
    if jt._score_fn is None:
        jt._build_score_fn()
    want = jt._score_fn(jt.train_params, jt.frozen_params, jt.ref_params, jnp.asarray(all_tokens))
    got = tt.score(_t(all_tokens).long())
    for g, w in zip(got, want):
        _close(g, w, 1e-5)
    mask = all_tokens[:, 1:] != 256
    assert np.abs((got[0].numpy() - got[1].numpy()) * mask).max() > 1e-4  # the reference moved off the policy


def test_greedy_make_experience_matches_jax(tmp_path):
    """A whole collection: the G-repeated prompts, greedy sampling (every
    completion of a group equal, so each advantage is exactly zero by the
    eps rule; init_kl_coef puts the per-token KL on top), scoring and the
    elements."""
    jt, tt = _pair(tmp_path)
    prompts = ["".join(chr(97 + c) for c in np.random.RandomState(i).randint(0, 26, 3 + i)) for i in range(4)]
    jt.add_prompt_pipeline(JPromptPipeline(prompts, 40, jt.tokenizer))
    tt.add_prompt_pipeline(PromptPipeline(prompts, 40, tt.tokenizer))
    jt.make_experience(8)
    tt.make_experience(8)
    assert len(tt.store) == len(jt.store) == 8
    for e, j in zip(tt.store.history, jt.store.history):
        assert e.group_id == j.group_id
        np.testing.assert_array_equal(e.query_tensor, np.asarray(j.query_tensor))
        np.testing.assert_array_equal(e.response_tensor, np.asarray(j.response_tensor))
        for f in ("logprobs", "values", "rewards"):
            _close(getattr(e, f), getattr(j, f), 1e-5)
    queries = [tuple(e.query_tensor) for e in tt.store.history]
    assert all(len(set(queries[g * G:(g + 1) * G])) == 1 for g in range(2))


# ---------------------------------------------------------------------------
# The PPO gates give GRPOTrainer what the JAX gates give it
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("unfrozen", [-1, 1, 2])
@pytest.mark.parametrize("tokenizer", ["byte", "char:abc"])
def test_gates_match_jax(tmp_path, unfrozen, tokenizer):
    """GRPOConfig carries none of PPO's option flags, so the trunk cache,
    speculative decode, the int8 decode view and the capture fast path are
    off on both sides at every split; the speculative scorer's gate
    follows the tokenizer and the stop sequences alike; the windowed loss
    is on."""
    jt, tt = _pair(tmp_path, unfrozen=unfrozen, tokenizer=tokenizer)
    for stop in ([], ["x"]):
        jt.stop_sequences = tt.stop_sequences = stop
        for gate in ("_trunk_cache_available", "_spec_decode_available", "_spec_path_available",
                     "_fast_rollout_available", "_window_loss_ok"):
            assert getattr(tt, gate)() == getattr(jt, gate)(), (gate, stop)
    assert tt._spec_k_effective() == jt._spec_k_effective() == 0
    assert tt._decode_params() is None and getattr(jt, "_quant_frozen_cache", None) is None
    assert tt.spec_decode_fallbacks == getattr(jt, "spec_decode_fallbacks", 0) == 0


def test_pipelined_cycle_is_refused_where_jax_fails(tmp_path):
    """The JAX cycle's in-graph scorer reads the values a critic-free
    policy does not have and fails; the port refuses it by name."""
    jt, tt = _pair(tmp_path)
    prompts = ["ab", "cd"]
    jt.add_prompt_pipeline(JPromptPipeline(prompts, 40, jt.tokenizer))
    tt.add_prompt_pipeline(PromptPipeline(prompts, 40, tt.tokenizer))
    with pytest.raises(TypeError, match="NoneType"):  # the values slot, None
        jt.pipelined_cycle()
    with pytest.raises(NotImplementedError, match="ROADMAP queue A, item 4"):
        tt.pipelined_cycle()
    # the fleet's same-seed multi-turn groups are G episodes, as in JAX
    assert tt._multiturn_group_size() == jt._multiturn_group_size() == tt.config.method.group_size


def test_train_entry_point_runs_grpo_and_rloo(tmp_path):
    """`trlx_tpu_torch.train(reward_fn=...)` with `default_grpo_config`
    (and RLOO) end to end on the CPU, with a resume of the group counter."""
    import trlx_tpu_torch

    for mode in ("grpo", "rloo"):
        cfg = _grpo_config(default_grpo_config, tmp_path, mode, mode).evolve(
            train=dict(epochs=2, total_steps=4),
            method=dict(num_rollouts=8, chunk_size=8, ppo_epochs=1,
                        gen_kwargs=dict(max_new_tokens=6, do_sample=True)))
        tr = trlx_tpu_torch.train(reward_fn=reward_fn, prompts=["ab", "cde", "f", "gh"], config=cfg, device="cpu")
        assert isinstance(tr, GRPOTrainer) and tr.iter_count == 4
        assert [e.group_id for e in tr.store.history] == [2 + i // G for i in range(8)]
        assert not any("v_head" in k for k in tr.model.state_dict())
        state = tr._extra_resume_state()
        tr._group_offset = 0
        tr._load_extra_resume_state(state)
        assert tr._group_offset == 4
