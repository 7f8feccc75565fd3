"""The port's pipelined PPO cycle (`PPOTrainer.pipelined_cycle`) and what
only it runs, against the JAX package on the same numpy inputs and the
same weights (carried by `params_from_jax`): the device retokenize, the
capture decode of both samplers, the in-graph score and rewards, the
speculative and fast scorers with their arbitration, the trunk cache
attached from the capture, and the cycle end to end (the last in
`test_torch_pipelined_schedules.py`, on this file's helpers).

The trainers run gpt2-tiny at f32 with `num_layers_unfrozen=1` and
`attn_impl="flash"`, the byte tokenizer, and sampling held to printable
ASCII and eos (the JAX tests' suppression: such samples survive the host
round trip); on the CPU the port's kernel wrappers run their plain
versions, and the JAX trainers run as their own CPU tests run them.

Tolerances (those of `tests/test_pipelined_cycle.py`,
`tests/test_rollout_fastpath.py` and `tests/test_torch_ppo.py`): the
retokenize exactly; score and rewards 1e-5, mean_kl 1e-5 relative; the
speculative merge against the classic scorer 1e-6; captured stats and
activations against the batched forward 5e-4, and greedy capture against
JAX's 5e-4; the fast scorer against the speculative one 5e-4 (mean_kl
1e-3, against the speculative log-ratio's sum over the same window);
the cycle end to end: samples exactly, losses 1e-5, mean_kl 1e-6
absolute (the KL of log-ratios near 0 is about their square),
parameters after the cycles' steps 2e-5 (the key bias, whose exact
gradient is 0, within its bound).
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trlx_tpu.data.default_configs import default_ppo_config as j_default_ppo_config
from trlx_tpu.pipeline.offline_pipeline import PromptPipeline as JPromptPipeline
from trlx_tpu.tokenizers import ByteTokenizer as JByteTokenizer
from trlx_tpu.trainer.ppo_trainer import PPOTrainer as JPPOTrainer
from trlx_tpu_torch.convert import params_from_jax
from trlx_tpu_torch.data.default_configs import default_ppo_config
from trlx_tpu_torch.models.policy import HydraReference
from trlx_tpu_torch.models.transformer import position_ids
from trlx_tpu_torch.ops import quant
from trlx_tpu_torch.pipeline.offline_pipeline import PromptPipeline
from trlx_tpu_torch.pipeline.ppo_pipeline import ppo_collate
from trlx_tpu_torch.tokenizers import ByteTokenizer
from trlx_tpu_torch.trainer.ppo_trainer import PPOTrainer, shifted_logprobs
from trlx_tpu_torch.utils.modeling import swapped_params

torch.set_num_threads(1)

MAX_NEW = 6
SUPPRESS = [i for i in range(259) if not (32 <= i < 127 or i == 258)]
GREEDY = dict(max_new_tokens=MAX_NEW, do_sample=False, suppress_tokens=SUPPRESS)
GEN_KWARGS = {
    "greedy": GREEDY,
    "temperature": dict(max_new_tokens=MAX_NEW, do_sample=True, temperature=0.7, suppress_tokens=SUPPRESS),
    "top_k": dict(max_new_tokens=MAX_NEW, do_sample=True, top_k=5, suppress_tokens=SUPPRESS),
}
OPTIONS = dict(cache_trunk_activations=True, speculative_decode=True, quantize_frozen_trunk=True)
PROMPTS = ["hello world", "jax tpu", "ppo", "cycle", "fast path", "torch", "hopper", "scorer"]


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64), rtol=tol, atol=tol)


def _np(x):
    return x.detach().float().cpu().numpy() if torch.is_tensor(x) else np.asarray(x, np.float32)


def reward_fn(samples, prompts, outputs, **kw):
    """Deterministic: the share of lowercase letters and spaces in the
    output, plus a small prompt-length term."""
    return [sum(c.islower() or c == " " for c in o) / max(len(o), 1) + 0.01 * len(p)
            for p, o in zip(prompts, outputs)]


def _config(make, tmp, side, gen_kwargs=GREEDY, **method):
    method = {"num_rollouts": 8, "chunk_size": 8, "ppo_epochs": 2, "init_kl_coef": 0.05, "gen_kwargs": gen_kwargs,
              **method}
    return make().evolve(
        model=dict(model_path="random:gpt2-tiny", num_layers_unfrozen=1,
                   model_extra_configs={"attn_impl": "flash", "dtype": "float32"}),
        tokenizer=dict(tokenizer_path="byte"),
        train=dict(seq_length=32, batch_size=8, total_steps=1000, tracker=None, seed=7,
                   checkpoint_dir=str(tmp / side)),
        method=method,
    )


def _torch_trainer(tmp, **method):
    tt = PPOTrainer(_config(default_ppo_config, tmp, "torch", **method), reward_fn=reward_fn, device="cpu")
    tt.add_prompt_pipeline(PromptPipeline(PROMPTS, 8, tt.tokenizer))
    return tt


def _pair(tmp, **method):
    """A JAX and a port PPOTrainer with the same weights and reference, on
    the same prompts."""
    jt = JPPOTrainer(_config(j_default_ppo_config, tmp, "jax", **method), reward_fn=reward_fn,
                     devices=jax.devices()[:1])
    tt = _torch_trainer(tmp, **method)
    tt.model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, jt.params), tt.model_cfg))
    tt.ref_model = HydraReference(tt.model.lm, tt.split)
    jt.add_prompt_pipeline(JPromptPipeline(PROMPTS, 8, jt.tokenizer))
    return jt, tt


def _prompt_batch(n=8, q=8, seed=17):
    rng = np.random.default_rng(seed)
    ids = rng.integers(97, 123, size=(n, q)).astype(np.int32)
    mask = np.ones_like(ids)
    ids[0, :2], mask[0, :2] = 256, 0  # one left-padded row
    return ids, mask


# ---------------------------------------------------------------------------
# The device retokenize
# ---------------------------------------------------------------------------


def test_device_retokenize_matches_jax_and_the_host_round_trip(tmp_path):
    """Random responses with junk ids >= 256 (specials and vocab-padding
    ids) dropped and compacted, eos restored only on an early stop: the
    port equals JAX's device retokenize and the host decode -> encode."""
    tok = ByteTokenizer()
    pad, eos, bos = tok.pad_token_id, tok.eos_token_id, tok.bos_token_id
    rng = np.random.default_rng(3)
    raw = rng.integers(32, 127, size=(24, MAX_NEW)).astype(np.int32)
    junk = rng.random(raw.shape) < 0.25
    raw[junk] = rng.choice([pad, bos, 300, 50000], size=int(junk.sum()))
    for row in range(0, 24, 3):  # every third row stops early: eos, then pads
        stop = int(rng.integers(0, MAX_NEW))
        raw[row, stop] = eos
        raw[row, stop + 1:] = pad
    raw[1, -1] = pad  # pad-ended without an eos
    raw[2, -1] = eos  # eos as the last token
    got = tok.device_retokenize(torch.from_numpy(raw).long(), MAX_NEW).numpy()
    want = np.asarray(JByteTokenizer().device_retokenize(jnp.asarray(raw), MAX_NEW))
    np.testing.assert_array_equal(got, want)

    tt = _torch_trainer(tmp_path)
    prompts = np.full((raw.shape[0], 4), 104, np.int32)
    _, host, *_ = tt._host_process_chunk({"input_ids": prompts, "attention_mask": np.ones_like(prompts)},
                                         np.concatenate([prompts, raw], axis=1))
    np.testing.assert_array_equal(got, host)
    assert (got == eos).any() and (got == pad).any() and not (got == bos).any()

    del tok._n_plain_ids
    with pytest.raises(NotImplementedError, match="no in-graph retokenize"):
        tok.device_retokenize(torch.from_numpy(raw).long(), MAX_NEW)


# ---------------------------------------------------------------------------
# Score and rewards on the device, the speculative merge, the gates
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """JAX and port trainers (capture on) with the same weights; the
    reference perturbed the same way on both sides, so the KL is not 0."""
    jt, tt = _pair(tmp_path_factory.mktemp("pipelined"), capture_rollout_stats=True)
    rng = np.random.RandomState(11)
    ref = jax.tree_util.tree_map(lambda x: np.asarray(x) + 0.05 * rng.randn(*np.shape(x)).astype(np.float32),
                                 jt.ref_params)
    jt.ref_params = jax.tree_util.tree_map(jnp.asarray, ref)
    tt.ref_model.load_state_dict(params_from_jax(ref))
    return SimpleNamespace(jt=jt, tt=tt)


def _synthetic_chunk(n=8, q=6, r=MAX_NEW, dense=False):
    """(`test_pipelined_cycle.py:_synthetic_chunk`) a left-padded query,
    a short response, an empty one; ragged dense score rows."""
    rng = np.random.default_rng(3)
    prompts = rng.integers(97, 123, size=(n, q)).astype(np.int32)
    prompts[0, :2] = 256
    outputs = rng.integers(97, 123, size=(n, r)).astype(np.int32)
    outputs[1, 4:] = 256
    outputs[2, :] = 256
    scores = rng.normal(size=(n, 4 if dense else 1)).astype(np.float32)
    if dense:
        scores[3, 2:] = -np.inf
    scores_mask = scores != -np.inf
    return prompts, outputs, np.where(scores_mask, scores, 0.0).astype(np.float32), scores_mask


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("dense", [False, True])
def test_score_reward_matches_jax_and_the_classic_elements(pair, dense):
    """`_score_reward` against JAX's `_build_score_reward_fn` (1e-5,
    mean_kl 1e-5 relative), and against the port's own classic path
    (`score`, `_chunk_to_elements`, `ppo_collate`)."""
    jt, tt = pair.jt, pair.tt
    prompts, outputs, scores, scores_mask = _synthetic_chunk(dense=dense)
    n, r = outputs.shape
    if dense:
        scores_eff = np.zeros((n, r), np.float32)
        scores_eff[:, :scores.shape[1]] = scores
    else:
        scores_eff = scores
    kl = float(tt.kl_ctl.value)
    chunk, mean_kl, mean_kl_tok = tt._score_reward(_t(prompts).long(), _t(outputs).long(), _t(scores_eff), kl,
                                                   not dense)
    jchunk, jmean_kl, jmean_kl_tok = jt._build_score_reward_fn(not dense)(
        jt.train_params, jt.frozen_params, jt.ref_params, jnp.asarray(prompts), jnp.asarray(outputs),
        jnp.asarray(scores_eff), jnp.float32(jt.kl_ctl.value))
    for f in ("query_tensors", "response_tensors"):
        np.testing.assert_array_equal(getattr(chunk, f).numpy(), np.asarray(getattr(jchunk, f)))
    for f in ("logprobs", "values", "rewards"):
        _close(_np(getattr(chunk, f)), getattr(jchunk, f), 1e-5)
    assert np.abs(_np(chunk.rewards)).max() > 1e-3
    for got, want in ((mean_kl, jmean_kl), (mean_kl_tok, jmean_kl_tok)):
        assert float(got) > 0 and float(got) == pytest.approx(float(want), rel=1e-5)

    scored = [x.numpy() for x in tt.score(torch.cat([_t(prompts), _t(outputs)], 1).long())]
    elements = tt._chunk_to_elements(prompts, outputs, None, scores, scores_mask, *scored[:3])
    collated = ppo_collate(elements, prompts.shape[1], r, r, 256, True)
    for f in ("query_tensors", "response_tensors", "logprobs", "values", "rewards"):
        _close(_np(getattr(chunk, f)), getattr(collated, f), 1e-6)


def test_spec_merge_equals_the_classic_scorer(pair):
    """(`test_pipelined_cycle.py:test_spec_score_matches_classic`) the
    speculative scorer's chunk equals `_score_reward`'s on the device trim
    of raw samples with eos and padding, 1e-6."""
    tt = pair.tt
    rng = np.random.default_rng(9)
    prompts = rng.integers(97, 123, size=(8, 6)).astype(np.int32)
    raw = rng.integers(97, 123, size=(8, MAX_NEW)).astype(np.int32)
    raw[1, 3], raw[1, 4:] = 258, 256
    raw[2, 0], raw[2, 1:] = 258, 256
    samples = torch.from_numpy(np.concatenate([prompts, raw], 1)).long()
    scores = _t(rng.normal(size=(8, 1)).astype(np.float32))
    trimmed = tt.tokenizer.device_retokenize(samples[:, 6:], MAX_NEW)
    lp, v, lr, mean_kl_s = tt._spec_fwd(samples, trimmed, 6, MAX_NEW)
    merged = tt._spec_merge(samples[:, :6], trimmed, lp, v, lr, scores, tt.kl_ctl.value, True)
    classic, mean_kl_c, _ = tt._score_reward(samples[:, :6], trimmed, scores, tt.kl_ctl.value, True)
    for f in ("query_tensors", "response_tensors", "logprobs", "values", "rewards"):
        _close(_np(getattr(merged, f)), _np(getattr(classic, f)), 1e-6)
    assert float(mean_kl_s) == pytest.approx(float(mean_kl_c), rel=1e-5)


GATE_CELLS = {
    "on": lambda t: None,
    "flag off": lambda t: setattr(t, "config", t.config.evolve(method=dict(capture_rollout_stats=False))),
    "stop sequences": lambda t: setattr(t, "stop_sequences", ["zz"]),
    "no _n_plain_ids": lambda t: setattr(t.tokenizer, "_n_plain_ids", None),
    "int8 on": lambda t: setattr(t, "config", t.config.evolve(method=dict(quantize_frozen_trunk=True))),
    "split 0": lambda t: setattr(t, "split", 0),
    "dense rewards seen": lambda t: setattr(t, "_spec_disabled_dense", True),
}


@pytest.mark.parametrize("cell", sorted(GATE_CELLS))
def test_gates_match_jax(pair, cell):
    """`_spec_path_available` and `_fast_rollout_available` against JAX's
    over a grid of one change each from a trainer with the fast path on."""
    saved = []
    for t in (pair.jt, pair.tt):
        saved.append((t, t.config, t.stop_sequences, t.tokenizer._n_plain_ids, t.split))
        GATE_CELLS[cell](t)
    try:
        got = (pair.tt._spec_path_available(), pair.tt._fast_rollout_available())
        want = (pair.jt._spec_path_available(), pair.jt._fast_rollout_available())
        assert got == want
        assert got == {"on": (True, True), "flag off": (True, False), "int8 on": (True, True),
                       "split 0": (True, False)}.get(cell, (False, False))
    finally:
        for t, config, stops, n_plain, split in saved:
            t.config, t.stop_sequences, t.split, t._spec_disabled_dense = config, stops, split, False
            t.tokenizer._n_plain_ids = n_plain


# ---------------------------------------------------------------------------
# The capture decode and the fast scorer
# ---------------------------------------------------------------------------


def _batched_forward(tt, samples):
    """The batched scoring forward over query|response: (logprobs, values)
    of the response window, the activation entering the split, the
    attention mask."""
    mask = (samples != tt.tokenizer.pad_token_id).long()
    with torch.no_grad():
        logits, values, h_split = tt.model(samples, mask, position_ids(mask), tt.split)
    return shifted_logprobs(logits, samples), values[:, :-1], h_split, mask


def _check_capture(tt, out):
    """Captured logprobs and values on every real label, and captured
    activations on every real position but the last emitted token's,
    against the batched forward, 5e-4; the unwritten rows zero."""
    samples = out["samples"]
    q = samples.shape[1] - MAX_NEW
    lp, values, h_split, mask = _batched_forward(tt, samples)
    assert out["logprobs"].shape == out["values"].shape == (samples.shape[0], MAX_NEW)
    assert out["h_split"].shape == h_split.shape
    valid = (samples[:, q:] != 256).numpy()
    assert valid.any()
    _close(_np(out["logprobs"])[valid], _np(lp[:, q - 1:])[valid], 5e-4)
    _close(_np(out["values"])[valid], _np(values[:, q - 1:])[valid], 5e-4)
    written = mask.clone()
    n_resp = out["response_mask"].sum(1)
    written[torch.arange(len(n_resp)), q + n_resp - 1] = 0  # the last emitted token's row
    rows = written.bool().numpy()
    _close(_np(out["h_split"])[rows], _np(h_split)[rows], 5e-4)
    full = (n_resp == MAX_NEW).numpy()
    assert (_np(out["h_split"])[full, -1] == 0).all()
    assert np.isfinite(_np(out["h_split"])).all()


@pytest.fixture(scope="module")
def spec_trainer(tmp_path_factory):
    """A port trainer with speculative decode and the fast path (no int8
    view, so its capture is the batched forward's numbers)."""
    return _torch_trainer(tmp_path_factory.mktemp("spec"), capture_rollout_stats=True, speculative_decode=True)


@pytest.mark.parametrize("mode", sorted(GEN_KWARGS))
@pytest.mark.parametrize("sampler", ["plain", "speculative"])
def test_captured_stats_match_the_batched_forward(pair, spec_trainer, sampler, mode):
    tt = pair.tt if sampler == "plain" else spec_trainer
    spec_k = tt._spec_k_effective()
    assert spec_k == (4 if sampler == "speculative" else 0)
    out = tt.generate(*_prompt_batch(), GEN_KWARGS[mode], capture=True, spec_k=spec_k)
    if sampler == "speculative":
        assert int(out["spec_rounds"].sum()) > 0
    _check_capture(tt, out)


def test_greedy_capture_matches_jax(pair):
    """The greedy capture's samples exactly, and its logprobs, values and
    activations (every row, the unwritten ones zero), 5e-4 against the
    JAX sampler's; prompts bucketed to 32 columns and trimmed back."""
    jt, tt = pair.jt, pair.tt
    ids, mask = _prompt_batch()
    out = tt.generate(ids, mask, GREEDY, capture=True)
    jout = jt.generate(ids, mask, GREEDY, capture=True)
    np.testing.assert_array_equal(out["samples"].numpy(), np.asarray(jout["samples"]))
    assert out["h_split"].shape == (8, 8 + MAX_NEW, 64)
    for f in ("logprobs", "values", "h_split"):
        _close(_np(out[f]), jout[f], 5e-4)


def test_fast_scorer_matches_the_spec_scorer(pair):
    """(`test_rollout_fastpath.py:test_fast_score_matches_spec_score`,
    `test_fast_dispatch_contract_matches_spec`) on every real label, 5e-4,
    mean_kl 1e-3; both dispatches return the same 5-tuple."""
    tt = pair.tt
    assert tt._fast_rollout_available()
    out = tt.generate(*_prompt_batch(), GEN_KWARGS["temperature"], capture=True)
    samples = out["samples"]
    q = samples.shape[1] - MAX_NEW
    fast = tt._dispatch_fast_score(out)
    spec = tt._dispatch_spec_score(out)
    assert len(fast) == len(spec) == 5 and "trunk_cache" not in out  # the cache gate is off here
    np.testing.assert_array_equal(fast[0].numpy(), samples[:, q:].numpy())  # printable samples round-trip
    valid = (samples[:, q:] != 256).numpy()
    for a, b in zip(fast[1:4], spec[1:4]):
        assert a.shape == b.shape == (8, MAX_NEW)
        _close(_np(a)[valid], _np(b)[valid], 5e-4)
    assert np.abs(_np(fast[3])).max() > 1e-3
    # the documented divergence: the fast mean_kl sums over the window's
    # real labels only; the speculative scorer's own sum also counts the
    # prompt positions, where the perturbed reference differs too
    lr = _np(spec[3]) * valid
    assert float(fast[4]) == pytest.approx(float((np.exp(lr) - 1 - lr).sum(1).mean()), abs=1e-3)


def test_int8_view_feeds_the_capture_and_the_cache(tmp_path):
    """Under `quantize_frozen_trunk` the captured activations are the
    dequantized int8 trunk's, as in JAX, and the fast path's trunk cache
    is those rows, not a full-precision pass."""
    tt = _torch_trainer(tmp_path, capture_rollout_stats=True, **OPTIONS)
    batch, out = tt.dispatch_rollout_generation()
    assert "h_split" in out and int(out["spec_rounds"].sum()) > 0
    trimmed, lp, v, lr, _ = tt._dispatch_fast_score(out)
    assert out["trunk_cache"] is out["h_split"]
    samples = out["samples"]
    mask = (samples != 256).long()
    view = quant.dequantize_tree(tt._decode_params(), torch.float32)
    with torch.no_grad():
        with swapped_params(tt.model, view):
            h_int8 = tt.model.forward_trunk(samples, mask, position_ids(mask), tt.split)
        h_full = tt.model.forward_trunk(samples, mask, position_ids(mask), tt.split)
    rows = mask.bool().numpy()
    rows[:, -1] = False  # the last token's row is never written
    _close(_np(out["h_split"])[rows], _np(h_int8)[rows], 5e-4)
    assert np.abs(_np(out["h_split"])[rows] - _np(h_full)[rows]).max() > 1e-3
    q = samples.shape[1] - MAX_NEW
    chunk = tt._spec_merge(samples[:, :q], trimmed, lp, v, lr, torch.zeros(8, 1), 0.0, True)
    attached = tt._attach_trunk_cache(chunk, captured=out["trunk_cache"])
    assert attached.h_split.dtype == torch.bfloat16
    assert torch.equal(attached.h_split, out["h_split"].to(torch.bfloat16))


def test_forced_trim_mismatch_falls_back_and_counts(tmp_path):
    """A device trim that disagrees with the host's falls back to the
    classic scorer, once a chunk; the cycle goes on training."""
    tt = _torch_trainer(tmp_path)
    orig = tt.tokenizer.device_retokenize
    tt.tokenizer.device_retokenize = lambda ids, m: orig(ids, m) * 0 + 104
    loss0, pending = tt.pipelined_cycle()
    assert loss0 is None and tt.spec_fallbacks == 1
    loss1, pending = tt.pipelined_cycle(pending)
    assert tt.spec_fallbacks == 2 and np.isfinite(loss1) and np.isfinite(float(pending[2][0]))
    assert tt.cycle_stats["fetch_wait_ms"] >= 0 and tt.cycle_stats["host_ms"] > 0
    tt.config = tt.config.evolve(method=dict(num_rollouts=12))
    with pytest.raises(NotImplementedError, match="multiple of chunk_size"):
        tt.pipelined_cycle(pending)


# ---------------------------------------------------------------------------
# The cycle end to end against the JAX trainer's
# ---------------------------------------------------------------------------


CYCLES = {
    "spec schedule": dict(),
    "fast schedule, options on": dict(capture_rollout_stats=True, **OPTIONS),
    "fast schedule, k=2": dict(capture_rollout_stats=True, num_rollouts=16),
}


