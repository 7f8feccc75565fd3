"""The PPO method options of the JAX bench's headline run, in the port
against the JAX package on the same numpy inputs and weights (carried by
`params_from_jax`): the int8 frozen-trunk decode view
(`quantize_frozen_trunk`), self-speculative decode (`speculative_decode`)
and the trunk activation cache (`cache_trunk_activations`).

Models are gpt2-tiny and llama-tiny at f32 with split 1
(`num_layers_unfrozen=1`); on the CPU the port's kernel wrappers run their
plain versions and the JAX package runs as its own CPU tests run it.

Tolerances: int8 codes, scales and the dequantized view bitwise; the
draft head bitwise (the same numpy SVD on the same f32 matrix); greedy
sampling token for token, with the speculative counters equal; the
sampled speculative marginals within a total variation of 0.25 of the
plain sampler's over 384 rows; the trunk-cache forwards 1e-5 against
JAX; the f32 cached loss and every gradient bitwise equal to the port's
full path, the bf16 cache within 2e-3 relative (the LM's gradients 5e-2
of their largest element); the rollout store 1e-5 against JAX's (tokens
exactly), the first step's stats 1e-5 and the parameters after 3 steps
2e-5, as in `test_torch_ppo.py`. The trainer pair's cases are in
`test_torch_ppo_options_trainer.py`, so that `--dist loadfile` hands
them out after the large files.
"""

import json
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trlx_tpu.data import PPORLElement as JPPORLElement
from trlx_tpu.data.configs import ModelConfig as JModelConfig
from trlx_tpu.data.default_configs import default_ppo_config as j_default_ppo_config
from trlx_tpu.models import build_model as j_build_model
from trlx_tpu.models.policy import CausalLMWithValueHead as JPolicy
from trlx_tpu.ops import quant as j_quant
from trlx_tpu.ops import sampling as j_sampling
from trlx_tpu.pipeline.offline_pipeline import PromptPipeline as JPromptPipeline
from trlx_tpu.pipeline.ppo_pipeline import PPORolloutStorage as JPPORolloutStorage
from trlx_tpu.trainer.ppo_trainer import PPOTrainer as JPPOTrainer
from trlx_tpu_torch.convert import params_from_jax
from trlx_tpu_torch.data import PPORLBatch, PPORLElement
from trlx_tpu_torch.data.configs import ModelConfig
from trlx_tpu_torch.data.default_configs import default_ppo_config
from trlx_tpu_torch.models import build_model
from trlx_tpu_torch.models.policy import HydraReference
from trlx_tpu_torch.models.transformer import position_ids
from trlx_tpu_torch.ops import quant, sampling
from trlx_tpu_torch.pipeline.offline_pipeline import PromptPipeline
from trlx_tpu_torch.pipeline.ppo_pipeline import PPORolloutStorage
from trlx_tpu_torch.trainer.ppo_trainer import PPOTrainer
from trlx_tpu_torch.utils import flatten_dict

torch.set_num_threads(1)

V, EOS, PAD = 64, 63, 62
STEPS = 3
STOP = ["�"]
OPTIONS = dict(cache_trunk_activations=True, speculative_decode=True, quantize_frozen_trunk=True)
_LEAF = {"kernel": "weight", "embedding": "weight"}


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64), rtol=tol, atol=tol)


def _np(x):
    return np.asarray(x, np.float32) if not torch.is_tensor(x) else x.detach().float().cpu().numpy()


@pytest.fixture(scope="module", params=["gpt2-tiny", "llama-tiny"])
def lm_pair(request):
    """A JAX and a port policy of one preset at f32 with the same weights."""
    extra = {"dtype": "float32"}
    jmodel, jcfg, jparams = j_build_model(
        JModelConfig(model_path=f"random:{request.param}", model_extra_configs=extra),
        vocab_size=V, rng=jax.random.PRNGKey(0),
    )
    tmodel, tcfg, _ = build_model(ModelConfig(model_path=f"random:{request.param}", model_extra_configs=extra),
                                  vocab_size=V, device="cpu")
    tmodel.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), tcfg))
    return SimpleNamespace(jmodel=jmodel, jcfg=jcfg, jparams=jparams, tmodel=tmodel, tcfg=tcfg)


def _quant_leaves(tree, path=()):
    for k, v in tree.items():
        if j_quant.is_quant_leaf(v):
            yield path + (k,), v
        elif isinstance(v, dict):
            yield from _quant_leaves(v, path + (k,))


# ---------------------------------------------------------------------------
# ops/quant.py: the int8 frozen-trunk view
# ---------------------------------------------------------------------------


def test_int8_view_matches_jax_bitwise(lm_pair):
    """(`test_spec_decode.py:268,312`) The port quantizes exactly the
    leaves `quantize_decode_params` picks; codes, scales and the
    dequantized weights are bitwise JAX's (kernels transposed)."""
    jview = j_quant.quantize_decode_params(lm_pair.jparams, split=1)
    want = {}
    for path, node in _quant_leaves(jview):
        *mods, leaf = path
        q, scale = np.asarray(node["q"]), np.asarray(node["scale"])
        dense = np.asarray(j_quant.dequantize_array(node))
        if leaf == "kernel":
            q, dense = q.T, dense.T
        want[".".join([*mods, _LEAF[leaf]])] = (q, scale, dense)
    got = quant.quantize_frozen(lm_pair.tmodel, 1)
    assert set(got) == set(want) and "lm.block_0.attn.q_proj.weight" in got and "lm.block_1.mlp.up_proj.weight" not in got
    dense = quant.dequantize_tree(got, torch.float32)
    for name, (q, scale, d) in want.items():
        assert got[name][0].dtype == torch.int8
        np.testing.assert_array_equal(got[name][0].numpy(), q)
        np.testing.assert_array_equal(got[name][1].numpy().reshape(-1), scale)
        np.testing.assert_array_equal(dense[name].numpy(), d)
    assert quant.quantized_bytes(got) == sum(q.size + 4 * s.size for q, s, _ in want.values())


def test_draft_head_matches_jax(lm_pair):
    """The rank-r readout: the same factors as `spec_draft_head_from_params`."""
    for rank in (8, 64):
        a, b = sampling.spec_draft_head_from_params(lm_pair.tmodel.state_dict(), lm_pair.tcfg, rank)
        ja, jb = j_sampling.spec_draft_head_from_params(lm_pair.jparams, lm_pair.jcfg, rank)
        np.testing.assert_array_equal(a, ja)
        np.testing.assert_array_equal(b, jb)


# ---------------------------------------------------------------------------
# models: the trunk-cache forwards
# ---------------------------------------------------------------------------


def test_trunk_cache_forwards_match_jax(lm_pair):
    """forward_trunk, forward_from_cache and forward_from_cache_window on
    rows padded at both ends, 1e-5; the cache pair equals the full forward
    bitwise, the windowed pair its window within 1e-6 (the head's products
    run over fewer rows)."""
    rng = np.random.RandomState(4)
    tokens = rng.randint(0, V - 2, (3, 12)).astype(np.int32)
    tokens[1, :4] = PAD
    tokens[2, 9:] = PAD
    mask = (tokens != PAD).astype(np.int32)
    jm, jp = lm_pair.jmodel, lm_pair.jparams
    jh = jm.apply({"params": jp}, jnp.asarray(tokens), jnp.asarray(mask), None, 1, method=JPolicy.forward_trunk)
    jl, jv = jm.apply({"params": jp}, jh, jnp.asarray(mask), None, 1, method=JPolicy.forward_from_cache)
    jlw, jvw = jm.apply({"params": jp}, jh, jnp.asarray(mask), None, 1, 5, 6,
                        method=JPolicy.forward_from_cache_window)
    t, m = torch.from_numpy(tokens).long(), torch.from_numpy(mask).long()
    model = lm_pair.tmodel
    with torch.no_grad():
        h = model.forward_trunk(t, m, position_ids(m), 1)
        logits, values = model.forward_from_cache(h, m, position_ids(m), 1)
        logits_w, values_w = model.forward_from_cache_window(h, m, position_ids(m), 1, 5, 6)
        full_logits, full_values, h_split = model(t, m, position_ids(m), 1)
    for got, want in ((h, jh), (logits, jl), (values, jv), (logits_w, jlw), (values_w, jvw)):
        _close(got, want, 1e-5)
    assert torch.equal(h, h_split) and torch.equal(logits, full_logits) and torch.equal(values, full_values)
    torch.testing.assert_close(logits_w, logits[:, 5:11], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(values_w, values[:, 5:11], rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# ops/sampling.py: the speculative sampler
# ---------------------------------------------------------------------------


def _prompts():
    ids = np.asarray([[PAD] * 5 + [3, 1, 4, 1, 5, 9, 2, 6],
                      [PAD] * 1 + [2, 7, 1, 8, 2, 8, 1, 8, 2, 8, 4, 5],
                      [PAD] * 9 + [11, 13, 17, 19]], np.int32)
    return ids, (ids != PAD).astype(np.int32)


def _gen(pkg, **kw):
    kw = {"max_new_tokens": 12, "eos_token_id": EOS, "pad_token_id": PAD, **kw}
    return (j_sampling if pkg == "jax" else sampling).GenerationConfig(**kw)


@pytest.mark.parametrize("view", ["dense", "int8"])
@pytest.mark.parametrize("spec_k", [1, 3])
def test_greedy_spec_matches_jax_and_the_plain_sampler(lm_pair, spec_k, view):
    """(`test_spec_decode.py:72,278`) Greedy speculative decode, on the
    dense weights and on the int8 view: token for token the JAX speculative
    sampler's and the port's plain sampler's, with JAX's round and
    accepted-draft counts."""
    ids, mask = _prompts()
    jparams = lm_pair.jparams if view == "dense" else j_quant.quantize_decode_params(lm_pair.jparams, 1)
    jhead = j_sampling.spec_draft_head_from_params(lm_pair.jparams, lm_pair.jcfg, 64)
    jspec = jax.jit(j_sampling.make_generate_fn(lm_pair.jmodel, lm_pair.jcfg, _gen("jax", do_sample=False),
                                                spec_k=spec_k, spec_split=1, spec_draft_head=jhead))
    want = jax.tree_util.tree_map(np.asarray, jspec(jparams, jnp.asarray(ids), jnp.asarray(mask),
                                                    jax.random.PRNGKey(0)))
    tview = None if view == "dense" else quant.quantize_frozen(lm_pair.tmodel, 1)
    head = sampling.spec_draft_head_from_params(lm_pair.tmodel.state_dict(), lm_pair.tcfg, 64)
    spec = sampling.make_generate_fn(lm_pair.tmodel, lm_pair.tcfg, _gen("torch", do_sample=False),
                                     spec_k=spec_k, spec_split=1, spec_draft_head=head)
    plain = sampling.make_generate_fn(lm_pair.tmodel, lm_pair.tcfg, _gen("torch", do_sample=False))
    got, ref = spec(ids, mask, params=tview), plain(ids, mask, params=tview)
    for key in ("samples", "samples_mask", "response_tokens", "response_mask"):
        np.testing.assert_array_equal(got[key].numpy(), want[key])
        assert torch.equal(got[key], ref[key])
    np.testing.assert_array_equal(got["spec_rounds"].numpy(), want["spec_rounds"])
    np.testing.assert_array_equal(got["spec_accepted"].numpy(), want["spec_accepted"])
    assert int(got["spec_rounds"].sum()) > 0
    # the sampler ran on the view and gave the module its parameters back
    assert all(type(p) is torch.nn.Parameter for p in lm_pair.tmodel.parameters())


def test_sampled_spec_follows_the_plain_distribution(lm_pair):
    """(`test_spec_decode.py:188`) Sampled speculative decode with a rank-8
    draft head that disagrees with the model: each position's marginal
    over 384 rows within a total variation of 0.25 of the plain
    sampler's; seeded draws repeat; masks are contiguous."""
    B = 384
    ids = np.tile(np.asarray([[5, 6, 7]], np.int32), (B, 1))
    mask = np.ones_like(ids)
    g = _gen("torch", do_sample=True, temperature=0.8, top_k=8, max_new_tokens=3)
    head = sampling.spec_draft_head_from_params(lm_pair.tmodel.state_dict(), lm_pair.tcfg, 8)
    plain = sampling.make_generate_fn(lm_pair.tmodel, lm_pair.tcfg, g)
    spec = sampling.make_generate_fn(lm_pair.tmodel, lm_pair.tcfg, g, spec_k=2, spec_split=1, spec_draft_head=head)
    tp = plain(ids, mask, torch.Generator().manual_seed(11))["response_tokens"].numpy()
    out = spec(ids, mask, torch.Generator().manual_seed(12))
    ts = out["response_tokens"].numpy()
    assert 0 < int(out["spec_accepted"].sum()) < 2 * int(out["spec_rounds"].sum())
    for pos in range(3):
        hp = np.bincount(tp[:, pos], minlength=V) / B
        hs = np.bincount(ts[:, pos], minlength=V) / B
        assert 0.5 * np.abs(hp - hs).sum() < 0.25, pos
    again = spec(ids, mask, torch.Generator().manual_seed(12))
    assert torch.equal(again["response_tokens"], out["response_tokens"])
    m = out["response_mask"].numpy()
    n = m.sum(1)
    assert all((row[:k] == 1).all() and (row[k:] == 0).all() for row, k in zip(m, n))
    assert all((row[k:] == PAD).all() for row, k in zip(ts, n))


def test_spec_sampler_refusals(lm_pair):
    """(`test_spec_decode.py:338`) The sampler's own gate, as JAX's."""
    head = sampling.spec_draft_head_from_params(lm_pair.tmodel.state_dict(), lm_pair.tcfg, 8)
    make = lambda g, **kw: sampling.make_generate_fn(lm_pair.tmodel, lm_pair.tcfg, g, **kw)
    greedy = _gen("torch", do_sample=False)
    with pytest.raises(ValueError, match="split"):
        make(greedy, spec_k=3, spec_split=0, spec_draft_head=head)
    with pytest.raises(ValueError, match="draft head"):
        make(greedy, spec_k=3, spec_split=1)
    with pytest.raises(NotImplementedError, match="repetition_penalty"):
        make(_gen("torch", do_sample=False, repetition_penalty=1.2), spec_k=3, spec_split=1, spec_draft_head=head)
    with pytest.raises(NotImplementedError, match="beam"):
        make(_gen("torch", do_sample=False, num_beams=2), spec_k=3, spec_split=1, spec_draft_head=head)


# ---------------------------------------------------------------------------
# The trainer's gates
# ---------------------------------------------------------------------------


def _dummy(cls, method, split=1, gen_kwargs=None, seq2seq=False):
    t = object.__new__(cls)
    t.config = SimpleNamespace(method=SimpleNamespace(num_value_layers_unfrozen=0, spec_k=4, **method))
    t.split, t.seq2seq = split, seq2seq
    t.model_cfg = SimpleNamespace(moe_experts=0, prompt_tokens=0, prefix_tokens=0, n_layers=2)
    t.generate_experience_kwargs, t.generate_kwargs = None, gen_kwargs or {}
    t.spec_decode_fallbacks = 0
    return t


@pytest.mark.parametrize("case", [
    dict(method=dict(speculative_decode=False, cache_trunk_activations=False)),
    dict(method=dict(speculative_decode=True, cache_trunk_activations=True)),
    dict(method=dict(speculative_decode=True, cache_trunk_activations=True), split=0),
    dict(method=dict(speculative_decode=True, cache_trunk_activations=True), gen_kwargs={"num_beams": 2}),
    dict(method=dict(speculative_decode=True, cache_trunk_activations=False),
         gen_kwargs={"repetition_penalty": 1.2}),
    dict(method=dict(speculative_decode=True, cache_trunk_activations=True), seq2seq=True),
    dict(method=dict(speculative_decode=False, cache_trunk_activations=True), seq2seq=True, split=2),
])
def test_trainer_gates_and_fallback_counter_match_jax(case):
    """(`test_spec_decode.py:377`, `test_trunk_cache.py:166`) The speculative
    gate (a refusal while on counts one fallback, flag off counts none)
    and the trunk-cache gate give JAX's answers."""
    port, jax_t = _dummy(PPOTrainer, **case), _dummy(JPPOTrainer, **case)
    assert port._spec_k_effective() == jax_t._spec_k_effective()
    assert port.spec_decode_fallbacks == jax_t.spec_decode_fallbacks
    assert port._trunk_cache_available() == jax_t._trunk_cache_available()


@pytest.mark.parametrize("virtual", [dict(prompt_tokens=8), dict(prefix_tokens=8)])
@pytest.mark.parametrize("split", [0, 1])
def test_trainer_gates_refuse_virtual_tokens_as_jax(split, virtual):
    """With every option on, a soft prompt or prefixes turn speculative
    decode off (one fallback counted) at any split, as JAX's gate does;
    the trunk-cache gate follows the split."""
    case = dict(method=dict(speculative_decode=True, cache_trunk_activations=True), split=split)
    port, jax_t = _dummy(PPOTrainer, **case), _dummy(JPPOTrainer, **case)
    for t in (port, jax_t):
        for k, v in virtual.items():
            setattr(t.model_cfg, k, v)
    assert port._spec_k_effective() == jax_t._spec_k_effective() == 0
    assert port.spec_decode_fallbacks == jax_t.spec_decode_fallbacks == 1
    assert port._trunk_cache_available() == jax_t._trunk_cache_available() == (split > 0)


def test_decode_view_is_built_once_and_only_under_a_split(tmp_path):
    cfg = _ppo_config(default_ppo_config, tmp_path, "t", quantize_frozen_trunk=True)
    trainer = PPOTrainer(cfg, reward_fn=reward_fn, device="cpu")
    view = trainer._decode_params()
    assert view is trainer._decode_params() and set(view) == set(quant.frozen_decode_names(trainer.model, 1))
    trainer.split = 0
    assert trainer._decode_params() is None


# ---------------------------------------------------------------------------
# pipeline/ppo_pipeline.py: the trunk cache's collation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("side", ["left", "right"])
def test_h_split_collation_matches_jax(side):
    """Rows of uneven queries and responses re-padded into the batch
    layout, exactly as the JAX store does; zero rows on padding."""
    rng = np.random.RandomState(5)
    jstore, store = JPPORolloutStorage(PAD, side), PPORolloutStorage(PAD, side)
    for q, r in ((3, 4), (5, 1), (2, 6), (5, 6)):
        fields = dict(query_tensor=rng.randint(0, 60, q).astype(np.int32),
                      response_tensor=rng.randint(0, 60, r).astype(np.int32),
                      logprobs=rng.randn(r).astype(np.float32), values=rng.randn(r).astype(np.float32),
                      rewards=rng.randn(r).astype(np.float32))
        h = rng.randn(q + r, 8).astype(np.float32)
        jstore.push([JPPORLElement(**fields, h_split=h)])
        store.push([PPORLElement(**fields, h_split=torch.from_numpy(h))])
    want = next(iter(jstore.create_loader(4, max_query_len=6, max_response_len=7)))
    got = next(iter(store.create_loader(4, max_query_len=6, max_response_len=7)))
    assert got.h_split.shape == (4, 13, 8)
    np.testing.assert_array_equal(got.h_split.numpy(), want.h_split)
    np.testing.assert_array_equal(got.query_tensors, want.query_tensors)


# ---------------------------------------------------------------------------
# The slice as a whole: PPOTrainer with the options against the JAX trainer
# ---------------------------------------------------------------------------


def reward_fn(samples, prompts, outputs, **kw):
    """Deterministic: the share of lowercase letters and spaces in the
    output, plus a small prompt-length term."""
    return [sum(c.islower() or c == " " for c in o) / max(len(o), 1) + 0.01 * len(p)
            for p, o in zip(prompts, outputs)]


def _text_prompts(n, seed):
    rng = np.random.RandomState(seed)
    return ["".join(chr(97 + c) for c in rng.randint(0, 26, rng.randint(2, 14))) for _ in range(n)]


def _ppo_config(make, tmp, side, **method):
    return make().evolve(
        train=dict(seq_length=48, batch_size=4, epochs=2, total_steps=1000, eval_interval=1000,
                   checkpoint_interval=1000, seed=7, checkpoint_dir=str(tmp / side / "ckpts"),
                   logging_dir=str(tmp / side / "logs")),
        model=dict(model_path="random:gpt2-tiny", num_layers_unfrozen=1,
                   model_extra_configs={"attn_impl": "flash", "dtype": "float32"}),
        method=dict(num_rollouts=8, chunk_size=8, ppo_epochs=2, init_kl_coef=0.05,
                    gen_kwargs=dict(max_new_tokens=8, do_sample=False), **method),
    )


def _rows(logging_dir, key):
    (path,) = [os.path.join(logging_dir, f) for f in os.listdir(logging_dir) if f.endswith(".metrics.jsonl")]
    with open(path) as f:
        return [row for row in map(json.loads, f) if key in row]


def _to_port_batch(jb):
    fields = {f: np.asarray(getattr(jb, f)) for f in ("query_tensors", "response_tensors", "logprobs", "values",
                                                      "rewards")}
    return PPORLBatch(**fields, h_split=torch.from_numpy(np.asarray(jb.h_split, np.float32)))


def _loss_and_grads(trainer, batch):
    trainer.model.zero_grad(set_to_none=True)
    loss, _ = trainer.make_loss_fn()(batch)
    loss.backward()
    return loss.detach(), {n: p.grad.clone() for n, p in trainer.model.named_parameters() if p.requires_grad}
