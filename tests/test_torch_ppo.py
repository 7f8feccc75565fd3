"""The port's PPO slice (trlx_tpu_torch: the RL statistics, ops/ppo.py,
the rollout store, the windowed head, the hydra reference, PPOTrainer and
the `reward_fn` branch of trlx_tpu_torch.train) against the JAX package's
on the same numpy inputs and the same weights (carried into the port by
`params_from_jax`).

The trainers run gpt2-tiny (llama-tiny for the scoring pass) at f32 with
`attn_impl="flash"`; on the CPU the port's kernel wrappers run their
plain versions, and the JAX trainers run as their own CPU tests run them.

Tolerances: the statistics and the loss math 1e-6 (f32, the same
expressions); collation exactly equal; the windowed head against the full
forward's slice 1e-6; scoring 1e-5 (logprobs over the vocabulary and the
two models' sums, f32) and mean_kl 1e-5 relative; greedy rollouts token
for token equal, their logprobs, values and rewards 1e-5; the first PPO
step's loss and stats 1e-5; parameters after 3 AdamW steps 2e-5 (the key
bias, whose exact gradient is 0, within its bound, as in
test_torch_sft.py); the reference bitwise unchanged.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trlx_tpu import resilience as j_resilience
from trlx_tpu.data import PPORLElement as JPPORLElement
from trlx_tpu.data.default_configs import default_ppo_config as j_default_ppo_config
from trlx_tpu.ops import ppo as j_ppo
from trlx_tpu.pipeline.offline_pipeline import PromptPipeline as JPromptPipeline
from trlx_tpu.pipeline.ppo_pipeline import PPORolloutStorage as JPPORolloutStorage
from trlx_tpu.trainer.ppo_trainer import PPOTrainer as JPPOTrainer
from trlx_tpu.utils import modeling as j_modeling
from trlx_tpu_torch import resilience
from trlx_tpu_torch.convert import params_from_jax
from trlx_tpu_torch.data import PPORLBatch, PPORLElement
from trlx_tpu_torch.data.default_configs import default_ppo_config
from trlx_tpu_torch.models.policy import HydraReference
from trlx_tpu_torch.models.transformer import position_ids
from trlx_tpu_torch.ops import ppo
from trlx_tpu_torch.pipeline.offline_pipeline import PromptPipeline
from trlx_tpu_torch.pipeline.ppo_pipeline import PPORolloutStorage
from trlx_tpu_torch.trainer.ppo_trainer import PPOTrainer, shifted_logprobs
from trlx_tpu_torch.utils import flatten_dict, modeling

torch.set_num_threads(1)

STEPS = 3
STOP = ["\ufffd"]


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# (a) the statistics and the PPO math against the JAX package's
# ---------------------------------------------------------------------------


def _stat_inputs(seed=0, b=5, t=7):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, t).astype(np.float32)
    mask = (rng.rand(b, t) > 0.3).astype(np.float32)
    mask[0] = 0.0  # a row with no valid entry
    return rng, x, mask


@pytest.mark.parametrize("masked", [False, True])
def test_statistics_match_jax(masked):
    _, x, mask = _stat_inputs()
    m = mask if masked else None
    _close(modeling.whiten(_t(x), mask=None if m is None else _t(m)),
           j_modeling.whiten(jnp.asarray(x), mask=None if m is None else jnp.asarray(m)), 1e-6)
    _close(modeling.whiten(_t(x), shift_mean=False, mask=None if m is None else _t(m)),
           j_modeling.whiten(jnp.asarray(x), shift_mean=False, mask=None if m is None else jnp.asarray(m)), 1e-6)
    for got, want in zip(modeling.get_global_statistics(_t(x), None if m is None else _t(m)),
                         j_modeling.get_global_statistics(jnp.asarray(x), None if m is None else jnp.asarray(m))):
        _close(got, want, 1e-6)
    _close(modeling.masked_var(_t(x), _t(mask)), j_modeling.masked_var(jnp.asarray(x), jnp.asarray(mask)), 1e-6)
    _close(modeling.masked_mean(_t(x), _t(mask), dim=1),
           j_modeling.masked_mean(jnp.asarray(x), jnp.asarray(mask), axis=1), 1e-6)
    for mk in (mask, np.zeros_like(mask)):
        n = max(float(mk.sum()), 1.0)
        got = modeling.get_tensor_stats(_t(x), _t(mk), torch.tensor(n))
        want = j_modeling.get_tensor_stats(jnp.asarray(x), jnp.asarray(mk), jnp.asarray(n))
        assert got.keys() == want.keys()
        for k in got:
            _close(got[k], want[k], 1e-6)
    logits = np.random.RandomState(1).randn(3, 4, 11).astype(np.float32) * 3
    _close(modeling.entropy_from_logits(_t(logits)), j_modeling.entropy_from_logits(jnp.asarray(logits)), 1e-6)


@pytest.mark.parametrize("whitening,masked", [(True, False), (True, True), (False, False)])
def test_gae_matches_jax(whitening, masked):
    rng, values, mask = _stat_inputs(2, b=4, t=9)
    rewards = rng.randn(4, 9).astype(np.float32)
    got = ppo.get_advantages_and_returns(_t(values), _t(rewards), 0.99, 0.95, use_whitening=whitening,
                                         mask=_t(mask) if masked else None)
    want = j_ppo.get_advantages_and_returns(jnp.asarray(values), jnp.asarray(rewards), 0.99, 0.95,
                                            use_whitening=whitening, mask=jnp.asarray(mask) if masked else None)
    for g, w in zip(got, want):
        _close(g, w, 1e-6)


def test_ppo_loss_and_every_stat_match_jax():
    rng, logprobs, mask = _stat_inputs(3, b=4, t=8)
    arrays = [logprobs] + [rng.randn(4, 8).astype(np.float32) * s for s in (1.0, 0.1, 1.0, 1.0, 1.0)]
    arrays[2] = logprobs + arrays[2]  # old logprobs near the new ones: some ratios clip, some do not
    kw = dict(cliprange=0.2, cliprange_value=0.2, vf_coef=0.7)
    loss, stats = ppo.ppo_loss(*map(_t, arrays), mask=_t(mask), **kw)
    j_loss, j_stats = j_ppo.ppo_loss(*map(jnp.asarray, arrays), mask=jnp.asarray(mask), **kw)
    _close(loss, j_loss, 1e-6)
    got, want = flatten_dict(stats), flatten_dict(jax.tree_util.tree_map(np.asarray, j_stats))
    assert got.keys() == want.keys() and len(got) == 21
    for k in got:
        _close(got[k], want[k], 1e-6)


def test_kl_controllers_and_running_moments_match_jax():
    kls = [0.5, 3.0, 9.0, 6.1, 0.0, 12.0]
    pairs = [(ppo.AdaptiveKLController(0.05, 6.0, 1000), j_ppo.AdaptiveKLController(0.05, 6.0, 1000)),
             (ppo.FixedKLController(0.05), j_ppo.FixedKLController(0.05))]
    for ours, theirs in pairs:
        for kl in kls:
            ours.update(kl, n_steps=32)
            theirs.update(kl, n_steps=32)
            assert ours.value == pytest.approx(theirs.value, rel=1e-12)
    rm, jrm = modeling.RunningMoments(), j_modeling.RunningMoments()
    rng = np.random.RandomState(4)
    for i in range(5):
        xs = rng.randn(3 + i).astype(np.float32) * (i + 1) + i
        _close(rm.update(xs), jrm.update(xs), 1e-6)
        _close([rm.mean, rm.std, rm.var, rm.count], [jrm.mean, jrm.std, jrm.var, jrm.count], 1e-6)


# ---------------------------------------------------------------------------
# (b) the rollout store: collation, bucket widths and export
# ---------------------------------------------------------------------------


def _elements(cls, seed=5, n=7):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        q, r = rng.randint(1, 9), rng.randint(1, 6)
        out.append(cls(query_tensor=rng.randint(0, 256, q).astype(np.int32),
                       response_tensor=rng.randint(0, 256, r).astype(np.int32),
                       logprobs=rng.randn(r).astype(np.float32), values=rng.randn(r).astype(np.float32),
                       rewards=rng.randn(r).astype(np.float32)))
    return out


@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("widths", [{}, dict(max_query_len=16, max_response_len=8, max_stat_len=8)])
def test_rollout_store_collation_matches_jax(side, widths, tmp_path):
    store, jstore = PPORolloutStorage(256, side), JPPORolloutStorage(256, side)
    store.push(_elements(PPORLElement))
    jstore.push(_elements(JPPORLElement))
    batches = [b for _ in range(2) for b in store.create_loader(3, shuffle=True, seed=9, **widths)]
    jbatches = [b for _ in range(2) for b in jstore.create_loader(3, shuffle=True, seed=9, **widths)]
    assert len(batches) == len(jbatches) == 6
    for b, jb in zip(batches, jbatches):
        for f in ("query_tensors", "response_tensors", "logprobs", "values", "rewards"):
            got, want = getattr(b, f), np.asarray(getattr(jb, f))
            assert got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_array_equal(got, want)
        assert b.h_split is None and b.group_ids is None and b.loss_masks is None
    if widths:
        assert batches[0].query_tensors.shape[1] == 16 and batches[0].logprobs.shape[1] == 8
    for only_text in (True, False):
        for s, d in ((store, tmp_path / f"t{only_text}"), (jstore, tmp_path / f"j{only_text}")):
            d.mkdir()
            s.export_history(str(d), only_text=only_text)
        (got,), (want,) = ([json.loads(p.read_text()) for p in (tmp_path / f"{k}{only_text}").iterdir()]
                           for k in "tj")
        assert got == want


# ---------------------------------------------------------------------------
# (j) checkpoint retention against the JAX package's
# ---------------------------------------------------------------------------


def _checkpoint_tree(root):
    for name, step, wall in [("checkpoint_1", 1, 10.0), ("checkpoint_2", 2, 20.0), ("checkpoint_10", 10, 30.0),
                             ("checkpoint_3", 3, 40.0), ("best_checkpoint", 2, 21.0), ("last_good", 1, 11.0),
                             ("checkpoint_4_preempt", 4, 50.0), ("checkpoint_5.tmp", 5, 60.0)]:
        os.makedirs(root / name)
        (root / name / "manifest.json").write_text(json.dumps({"step": step, "wall_time": wall}))
    os.makedirs(root / "checkpoint_6")  # no manifest: an interrupted save
    (root / "stray_file").write_text("x")


@pytest.mark.parametrize("keep_n", [0, 1, 2, 3, 10])
def test_gc_checkpoints_matches_jax(keep_n, tmp_path):
    ours, theirs = tmp_path / "ours", tmp_path / "theirs"
    _checkpoint_tree(ours)
    _checkpoint_tree(theirs)
    assert ([(s, w, os.path.basename(p)) for s, w, p in resilience.list_checkpoints(str(ours))]
            == [(s, w, os.path.basename(p)) for s, w, p in j_resilience.list_checkpoints(str(theirs))])
    deleted = resilience.gc_checkpoints(str(ours), keep_n)
    j_deleted = j_resilience.gc_checkpoints(str(theirs), keep_n)
    assert [os.path.basename(p) for p in deleted] == [os.path.basename(p) for p in j_deleted]
    assert sorted(os.listdir(ours)) == sorted(os.listdir(theirs))
    assert {"best_checkpoint", "last_good", "checkpoint_10", "checkpoint_6"} <= set(os.listdir(ours))


# ---------------------------------------------------------------------------
# (i) what the slice leaves out is refused, naming its ROADMAP item
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("section,key,value,item", [
    ("train", "fuse_inner_epoch", True, "item 4"),
    ("model", "peft_config", {"peft_type": "LORA", "r": 8}, "item 4"),
    ("train", "tracing", True, "item 4"),
    ("train", "profile_dir", "profiles", "item 4"),
    ("model", "model_arch_type", "seq2seq", "item 4"),
])
def test_unported_ppo_features_are_refused(section, key, value, item):
    overrides = {"model": dict(model_path="random:gpt2-tiny")}
    overrides.setdefault(section, {})[key] = value
    cfg = default_ppo_config().evolve(**overrides)
    with pytest.raises(NotImplementedError, match=f"ROADMAP queue A, {item}"):
        PPOTrainer(cfg, reward_fn=lambda **kw: [0.0], device="cpu")


# ---------------------------------------------------------------------------
# The slice as a whole: PPOTrainer against the JAX trainer
# ---------------------------------------------------------------------------


def reward_fn(samples, prompts, outputs, **kw):
    """Deterministic: the share of lowercase letters and spaces in the
    output, plus a small prompt-length term."""
    return [sum(c.islower() or c == " " for c in o) / max(len(o), 1) + 0.01 * len(p)
            for p, o in zip(prompts, outputs)]


def _prompts(n, seed):
    rng = np.random.RandomState(seed)
    return ["".join(chr(97 + c) for c in rng.randint(0, 26, rng.randint(2, 14))) for _ in range(n)]


def _ppo_config(make, preset, tmp, side, unfrozen=1, **train):
    return make().evolve(
        train=dict(seq_length=48, batch_size=4, epochs=2, total_steps=1000, eval_interval=1000,
                   checkpoint_interval=1000, seed=7, checkpoint_dir=str(tmp / side / "ckpts"),
                   logging_dir=str(tmp / side / "logs"), **train),
        model=dict(model_path=f"random:{preset}", num_layers_unfrozen=unfrozen,
                   model_extra_configs={"attn_impl": "flash", "dtype": "float32"}),
        method=dict(num_rollouts=8, chunk_size=8, ppo_epochs=2, init_kl_coef=0.05,
                    gen_kwargs=dict(max_new_tokens=8, do_sample=False)),
    )


def _pair(preset, tmp, unfrozen=1):
    """A JAX and a port PPOTrainer with the same weights and reference."""
    # outputs are cut at the first undecodable byte, so responses end
    # early and the scoring rows are padded at both ends
    jt = JPPOTrainer(_ppo_config(j_default_ppo_config, preset, tmp, "jax", unfrozen), reward_fn=reward_fn,
                     stop_sequences=STOP, devices=jax.devices()[:1])
    tt = PPOTrainer(_ppo_config(default_ppo_config, preset, tmp, "torch", unfrozen), reward_fn=reward_fn,
                    stop_sequences=STOP, device="cpu")
    tt.model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, jt.params), tt.model_cfg))
    tt.ref_model = HydraReference(tt.model.lm, tt.split)
    ref = params_from_jax(jax.tree_util.tree_map(np.asarray, jt.ref_params))
    assert ref.keys() == tt.ref_model.state_dict().keys()
    for name, w in tt.ref_model.state_dict().items():
        assert torch.equal(w, ref[name]), name
    return jt, tt


def _rows(logging_dir, key):
    (path,) = [os.path.join(logging_dir, f) for f in os.listdir(logging_dir) if f.endswith(".metrics.jsonl")]
    with open(path) as f:
        return [row for row in map(json.loads, f) if key in row]


@pytest.fixture(scope="module")
def ppo_pair(tmp_path_factory):
    """Both trainers on gpt2-tiny: one greedy collection of 8 rollouts,
    then STEPS optimizer steps on the same collated batches."""
    tmp = tmp_path_factory.mktemp("ppo")
    jt, tt = _pair("gpt2-tiny", tmp)
    prompts = _prompts(12, 0)
    jt.add_prompt_pipeline(JPromptPipeline(prompts, 40, jt.tokenizer))
    tt.add_prompt_pipeline(PromptPipeline(prompts, 40, tt.tokenizer))
    jt.make_experience(8)
    tt.make_experience(8)
    ref_before = {k: v.clone() for k, v in tt.ref_model.state_dict().items()}
    jbatches = [b for _ in range(2) for b in jt.create_train_dataloader()][:STEPS]
    tbatches = [b for _ in range(2) for b in tt.create_train_dataloader()][:STEPS]
    fields = ("query_tensors", "response_tensors", "logprobs", "values", "rewards")
    # the loaders' batches equal, then the JAX batches injected into both
    injected = [PPORLBatch(**{f: np.asarray(getattr(b, f)) for f in fields}) for b in jbatches]
    j_stats, t_stats = [], []
    for jb, ib in zip(jbatches, injected):
        j_stats.append(flatten_dict(jax.tree_util.tree_map(np.asarray, jt.train_minibatch([jb]))))
        t_stats.append(tt.train_minibatch([ib]))
    return dict(jt=jt, tt=tt, tbatches=tbatches, injected=injected, j_stats=j_stats, t_stats=t_stats,
                ref_before=ref_before)


def test_greedy_make_experience_matches_jax(ppo_pair):
    """(f) tokens exactly equal; logprobs, values and rewards 1e-5; the
    logged stats keys equal. (b) the train loaders' batches equal."""
    jt, tt = ppo_pair["jt"], ppo_pair["tt"]
    assert len(tt.store) == len(jt.store) == 8
    padded_both_ends = 0
    for e, je in zip(tt.store.history, jt.store.history):
        np.testing.assert_array_equal(e.query_tensor, np.asarray(je.query_tensor))
        np.testing.assert_array_equal(e.response_tensor, np.asarray(je.response_tensor))
        for f in ("logprobs", "values", "rewards"):
            _close(getattr(e, f), getattr(je, f), 1e-5)
        padded_both_ends += int(e.query_tensor[0] == 256) * int(len(e.response_tensor) < 8)
    assert padded_both_ends > 0  # some rows are padded at both ends in the scoring pass
    assert tt.mean_kl == pytest.approx(jt.mean_kl, rel=1e-5, abs=1e-9)
    keys = lambda tr: set(_rows(tr.config.train.logging_dir, "time/rollout_generate")[0])
    assert keys(tt) == keys(jt)
    for b, ib in zip(ppo_pair["tbatches"], ppo_pair["injected"]):
        for f in ("query_tensors", "response_tensors", "logprobs", "values", "rewards"):
            if f in ("query_tensors", "response_tensors"):
                np.testing.assert_array_equal(getattr(b, f), getattr(ib, f))
            else:
                _close(getattr(b, f), getattr(ib, f), 1e-5)


def test_first_ppo_step_loss_and_stats_match_jax(ppo_pair):
    """(e) the first step's loss and every stat of an injected batch, 1e-5."""
    t, j = ppo_pair["t_stats"][0], ppo_pair["j_stats"][0]
    for k, v in j.items():
        _close(t[k], v, 1e-5)
    assert "throughput/train_tokens_per_s" in t and abs(t["losses/total_loss"]) > 0


def test_ppo_params_after_three_steps_match_jax(ppo_pair):
    jt, tt = ppo_pair["jt"], ppo_pair["tt"]
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jt.params), tt.model_cfg)
    got = tt.model.state_dict()
    trainable = {n for n, p in tt.model.named_parameters() if p.requires_grad}
    assert "v_head.dense_out.weight" in trainable and "lm.block_1.attn.q_proj.weight" in trainable
    for name, w in want.items():
        if name.endswith("k_proj.bias"):
            # exact gradient 0: Adam turns rounding noise into steps of +-lr (3e-5)
            assert float((got[name] - w).abs().max()) <= 2 * STEPS * 3e-5
            continue
        torch.testing.assert_close(got[name], w, rtol=2e-5, atol=2e-5)
        if name not in trainable:
            assert torch.equal(got[name], w), f"frozen {name} moved"


def test_reference_is_unchanged_by_training(ppo_pair):
    """(g) bitwise, and its storage is its own."""
    tt = ppo_pair["tt"]
    for name, w in tt.ref_model.state_dict().items():
        assert torch.equal(w, ppo_pair["ref_before"][name]), name
        assert not w.requires_grad
    ptrs = {p.data_ptr() for p in tt.model.parameters()}
    assert not any(p.data_ptr() in ptrs for p in tt.ref_model.parameters())
    assert not torch.equal(tt.model.lm.block_1.attn.q_proj.weight, tt.ref_model.block_1.attn.q_proj.weight)


def test_windowed_head_and_loss_match_the_full_forward(ppo_pair):
    """(c) forward_window against the full forward's slice, and the loss
    (windowed head) against `ppo_loss` over the full forward's slice,
    1e-6."""
    tt = ppo_pair["tt"]
    method = tt.config.method
    batch = tt.batch_to_device(ppo_pair["injected"][0])
    tokens = torch.cat([batch.query_tensors, batch.response_tensors], dim=1)
    mask = (tokens != 256).long()
    start, length = batch.query_tensors.shape[1] - 1, batch.rewards.shape[1]
    end = start + length
    with torch.no_grad():
        logits, values, _ = tt.model(tokens, mask, position_ids(mask))
        logits_w, values_w = tt.model.forward_window(tokens, mask, position_ids(mask), start, length)
        torch.testing.assert_close(logits_w, logits[:, start:end], rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(values_w, values[:, start:end], rtol=1e-6, atol=1e-6)
        loss_w, stats_w = tt.make_loss_fn()(batch)
        advantages, returns = ppo.get_advantages_and_returns(batch.values, batch.rewards, method.gamma, method.lam)
        loss_f, stats_f = ppo.ppo_loss(
            logprobs=shifted_logprobs(logits, tokens)[:, start:end], values=values[:, :-1][:, start:end],
            old_logprobs=batch.logprobs, old_values=batch.values, advantages=advantages, returns=returns,
            mask=mask[:, start + 1:end + 1], cliprange=method.cliprange, cliprange_value=method.cliprange_value,
            vf_coef=method.vf_coef,
        )
        stats_f = flatten_dict(stats_f)
    _close(loss_w, loss_f, 1e-6)
    assert not method.whiten_with_mask and stats_w.keys() == stats_f.keys()
    for k in stats_w:
        _close(stats_w[k], stats_f[k], 1e-6)


def test_ppo_token_count_is_the_attention_mask(ppo_pair):
    tt = ppo_pair["tt"]
    b = ppo_pair["injected"][0]
    tokens = np.concatenate([b.query_tensors, b.response_tensors], axis=1)
    assert tt.count_tokens(b) == int((tokens != 256).sum()) < tokens.size


@pytest.mark.parametrize("unfrozen", [1, -1])
def test_scoring_matches_jax(unfrozen, tmp_path):
    """(d) llama-tiny (GQA, rope, untied head), hydra (split 1) and a full
    reference copy (split 0); rows padded at both ends and one with a
    hole; the reference perturbed on both sides so the KL is not 0."""
    jt, tt = _pair("llama-tiny", tmp_path, unfrozen)
    rng = np.random.RandomState(11)
    ref = jax.tree_util.tree_map(lambda x: np.asarray(x) + 0.05 * rng.randn(*np.shape(x)).astype(np.float32),
                                 jt.ref_params)
    jt.ref_params = jax.tree_util.tree_map(jnp.asarray, ref)
    tt.ref_model.load_state_dict(params_from_jax(ref))
    tokens = rng.randint(0, 256, (4, 20)).astype(np.int32)
    for row, (left, right) in enumerate([(0, 0), (5, 3), (9, 0), (0, 7)]):
        tokens[row, :left] = 256
        tokens[row, 20 - right:] = 256
    tokens[3, 6] = 256  # a hole
    jt._build_score_fn()
    want = jax.tree_util.tree_map(np.asarray, jt._score_fn(jt.train_params, jt.frozen_params, jt.ref_params,
                                                           jnp.asarray(tokens)))
    got = [x.numpy() for x in tt.score(torch.from_numpy(tokens).long())]
    for g, w in zip(got[:3], want[:3]):
        _close(g, w, 1e-5)
    assert np.abs(want[2]).max() > 1e-3
    for g, w in zip(got[3:], want[3:]):
        assert float(g) == pytest.approx(float(w), rel=1e-5)


# ---------------------------------------------------------------------------
# (h) trlx_tpu_torch.train(reward_fn=...) end to end, retention and resume
# ---------------------------------------------------------------------------


def _train_run(tmp, side, **train):
    import trlx_tpu_torch

    cfg = _ppo_config(default_ppo_config, "gpt2-tiny", tmp, side, **train).evolve(
        train=dict(checkpoint_interval=1), method=dict(gen_kwargs=dict(max_new_tokens=8, do_sample=True)))
    return trlx_tpu_torch.train(reward_fn=reward_fn, prompts=_prompts(12, 1), config=cfg, stop_sequences=STOP,
                                device="cpu")


def test_train_entry_point_runs_ppo_retention_and_exact_resume(tmp_path):
    """Two epochs of PPO (two collections, 2 inner epochs of 2 steps each,
    sampling on, the first collection exported); a run resumed from step 3,
    before the second collection, ends with the uninterrupted run's
    parameters, reference, store and KL state bit for bit, and its
    retention keeps the newest 2 checkpoints."""
    (tmp_path / "rollouts").mkdir()
    full = _train_run(tmp_path, "full", checkpoint_keep_n=0, rollout_logging_dir=str(tmp_path / "rollouts"))
    assert full.iter_count == full.total_steps == 8
    losses = [r["losses/total_loss"] for r in _rows(full.config.train.logging_dir, "losses/total_loss")]
    assert len(losses) == 8 and all(np.isfinite(losses))
    assert len(_rows(full.config.train.logging_dir, "time/rollout_generate")) == 2
    assert len(_rows(full.config.train.logging_dir, "reward/mean")) == 2  # before the first step, at the last
    ckpts = str(tmp_path / "full" / "ckpts")
    resumed = _train_run(tmp_path, "resumed", checkpoint_keep_n=2,
                         resume_from_checkpoint=os.path.join(ckpts, "checkpoint_3"))
    assert resumed.iter_count == 8
    for a, b in ((full.model, resumed.model), (full.ref_model, resumed.ref_model)):
        for (name, x), y in zip(a.state_dict().items(), b.state_dict().values()):
            assert torch.equal(x, y), name
    for e, f in zip(full.store.history, resumed.store.history):
        np.testing.assert_array_equal(e.response_tensor, f.response_tensor)
        np.testing.assert_array_equal(e.rewards, f.rewards)
    assert full.kl_ctl.value == resumed.kl_ctl.value and full.mean_kl == resumed.mean_kl
    assert full.running_moments.mean == resumed.running_moments.mean
    kept = sorted(n for n in os.listdir(tmp_path / "resumed" / "ckpts") if n.startswith("checkpoint_"))
    assert kept == ["checkpoint_7", "checkpoint_8"]
    assert len([n for n in os.listdir(ckpts) if n.startswith("checkpoint_")]) == 8
    # the first collection was exported before the second replaced it
    (run_dir,) = (tmp_path / "rollouts").iterdir()
    exported = sorted(p.name for p in run_dir.iterdir())
    assert exported[0] == "config.json" and len(exported) == 2
    assert len(json.loads((run_dir / exported[1]).read_text())) == 8


def test_train_entry_point_refuses_other_online_trainers(tmp_path):
    import trlx_tpu_torch

    # RFT, GRPO/RLOO and best-of-n are ported (tests/test_torch_rft.py,
    # test_torch_grpo.py, test_torch_bon.py); the pipelined PPO trainer is
    # not, and SFT and ILQL are not online trainers
    for trainer in ("PipelinedPPOTrainer", "SFTTrainer", "ILQLTrainer"):
        cfg = _ppo_config(default_ppo_config, "gpt2-tiny", tmp_path, "t").evolve(train=dict(trainer=trainer))
        with pytest.raises(NotImplementedError, match="ROADMAP queue A, item 4"):
            trlx_tpu_torch.train(reward_fn=reward_fn, prompts=["a"], config=cfg, device="cpu")
