"""ILQL in the port (`ops/ilql.py`, `ILQLHeads`, `CausalLMWithILQLHeads`,
the ILQL storage, `ILQLTrainer`, Q-guided sampling and the `rewards`
branch of `trlx_tpu_torch.train`) against the JAX package on the same
numpy inputs and weights (carried by `params_from_jax`).

Models are gpt2-tiny (and llama-tiny for the sampler) at f32 with
`attn_impl="flash"`; on the CPU the port's kernel wrappers run their
plain versions and the JAX package runs as its own CPU tests run it.

Tolerances: the loss, its stats and its gradients with respect to the
logits, Q and V 1e-5 (f32, the same expressions; log-softmax over the
vocabulary); the heads and the Polyak sync 1e-6; the experience arrays
and the collation exactly, the normalized returns 1e-6; greedy Q-guided
sampling token for token; a trainer pair's first-step loss and stats
1e-5, the parameters after 3 AdamW steps 2e-5 (the key bias, whose exact
gradient is 0, within its bound), the target heads 2e-5 and bitwise
unchanged between syncs; a resumed run bitwise the uninterrupted one.
The trainer pair's cases are in `test_torch_ilql_trainer.py`, so that
`--dist loadfile` hands them out after the large files.
"""

import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trlx_tpu.data.configs import ModelConfig as JModelConfig
from trlx_tpu.data.default_configs import default_ilql_config as j_default_ilql_config
from trlx_tpu.models import build_model as j_build_model
from trlx_tpu.models.heads import ILQLHeads as JILQLHeads
from trlx_tpu.models.heads import sync_target_q_heads as j_sync_target_q_heads
from trlx_tpu.ops import ilql as j_ilql
from trlx_tpu.ops import sampling as j_sampling
from trlx_tpu.pipeline.offline_pipeline import ILQLRolloutStorage as JILQLRolloutStorage
from trlx_tpu.tokenizers import ByteTokenizer as JByteTokenizer
from trlx_tpu.trainer.ilql_trainer import ILQLTrainer as JILQLTrainer
from trlx_tpu.trainer.base_trainer import partition_params
from trlx_tpu.trainer.ilql_trainer import make_experience as j_make_experience
from trlx_tpu_torch.convert import params_from_jax
from trlx_tpu_torch.data import ILQLBatch
from trlx_tpu_torch.data.configs import ModelConfig
from trlx_tpu_torch.data.default_configs import default_ilql_config
from trlx_tpu_torch.models import ILQLHeads, build_model, sync_target_q_heads, target_q_mask
from trlx_tpu_torch.ops import ilql, sampling
from trlx_tpu_torch.pipeline.offline_pipeline import ILQLRolloutStorage
from trlx_tpu_torch.tokenizers import ByteTokenizer
from trlx_tpu_torch.trainer.ilql_trainer import ILQLTrainer, make_experience
from trlx_tpu_torch.utils import flatten_dict

torch.set_num_threads(1)

V, EOS, PAD = 64, 63, 62
STEPS, SYNC = 3, 2
FIELDS = ("input_ids", "attention_mask", "rewards", "states_ixs", "actions_ixs", "dones")


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64), rtol=tol, atol=tol)


def _np(x):
    return x.detach().float().cpu().numpy() if torch.is_tensor(x) else np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# ops/ilql.py: the loss, its stats and its gradients
# ---------------------------------------------------------------------------


def _loss_inputs(two_qs, seed=0, b=3, t=10, n=5, v=11):
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)
    n_q = 2 if two_qs else 1
    actions_ixs = np.stack([np.sort(rng.choice(t - 1, n, replace=False)) for _ in range(b)]).astype(np.int32)
    dones = np.ones((b, n + 1), np.int32)
    dones[:, -1] = 0
    dones[1, 3:] = 0  # a sample whose last actions are padding
    return dict(logits=f(b, t, v), qs=[f(b, n, v) for _ in range(n_q)], target_qs=[f(b, n, v) for _ in range(n_q)],
                vs=f(b, n + 1, 1), input_ids=rng.randint(0, v, (b, t)).astype(np.int32), actions_ixs=actions_ixs,
                dones=dones, rewards=f(b, n) * dones[:, :-1])


@pytest.mark.parametrize("beta", [0.0, 1.0])
@pytest.mark.parametrize("two_qs", [True, False])
def test_ilql_loss_stats_and_gradients_match_jax(two_qs, beta):
    x = _loss_inputs(two_qs)
    hp = dict(tau=0.7, gamma=0.99, cql_scale=0.1, awac_scale=1.0, beta=beta)

    def j_loss(logits, qs, vs):
        return j_ilql.ilql_loss(logits, qs, [jnp.asarray(q) for q in x["target_qs"]], vs, jnp.asarray(x["input_ids"]),
                                jnp.asarray(x["actions_ixs"]), jnp.asarray(x["dones"]), jnp.asarray(x["rewards"]),
                                **hp)

    (jl, jstats), jgrads = jax.value_and_grad(j_loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(x["logits"]), [jnp.asarray(q) for q in x["qs"]], jnp.asarray(x["vs"]))
    logits = torch.tensor(x["logits"], requires_grad=True)
    qs = [torch.tensor(q, requires_grad=True) for q in x["qs"]]
    vs = torch.tensor(x["vs"], requires_grad=True)
    t = lambda a: torch.from_numpy(a)
    loss, stats = ilql.ilql_loss(logits, qs, [t(q) for q in x["target_qs"]], vs, t(x["input_ids"]),
                                 t(x["actions_ixs"]), t(x["dones"]), t(x["rewards"]), **hp)
    loss.backward()
    _close(loss.detach(), jl, 1e-5)
    got, want = flatten_dict(stats), flatten_dict(jax.tree_util.tree_map(np.asarray, jstats))
    assert got.keys() == want.keys() and "qvalues/0/mean" in got and "losses/loss_awac" in got
    for k in want:
        _close(_np(got[k]), want[k], 1e-5)
    _close(logits.grad, jgrads[0], 1e-5)
    for q, jg in zip(qs, jgrads[1]):
        _close(q.grad, jg, 1e-5)
    _close(vs.grad, jgrads[2], 1e-5)
    assert float(vs.grad.abs().max()) > 0 and float(logits.grad.abs().max()) > 0


def test_topk_mask_and_batched_index_select_match_jax():
    rng = np.random.RandomState(2)
    x = rng.randn(3, 7, 9).astype(np.float32)
    ixs = rng.randint(0, 7, (3, 4)).astype(np.int32)
    np.testing.assert_array_equal(ilql.batched_index_select(torch.from_numpy(x), torch.from_numpy(ixs)).numpy(),
                                  np.asarray(j_ilql.batched_index_select(jnp.asarray(x), jnp.asarray(ixs))))
    for k in (1, 3, 9):
        np.testing.assert_array_equal(ilql.topk_mask(torch.from_numpy(x), k).numpy(),
                                      np.asarray(j_ilql.topk_mask(jnp.asarray(x), k)))
    assert sampling.topk_mask is ilql.topk_mask  # one home


# ---------------------------------------------------------------------------
# models/heads.py: the heads with index selection, the Polyak sync
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("two_qs", [True, False])
def test_ilql_heads_and_polyak_sync_match_jax(two_qs):
    d, b, t = 16, 2, 7
    rng = np.random.RandomState(3)
    hs = rng.randn(b, t, d).astype(np.float32)
    states = np.asarray([[0, 2, 3, 6], [1, 4, 5, 6]], np.int32)
    actions = states[:, :-1]
    jheads = JILQLHeads(V, two_qs, jnp.float32)
    jp = jheads.init(jax.random.PRNGKey(1), jnp.asarray(hs))["params"]
    # the target heads apart from the Q heads, so the sync moves them
    jp = {k: (jax.tree_util.tree_map(lambda a: a + 0.1, v) if k.startswith("target") else v) for k, v in jp.items()}
    heads = ILQLHeads(d, V, two_qs, torch.float32)
    heads.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, jp)))
    jq, jtq, jv = jheads.apply({"params": jp}, jnp.asarray(hs), jnp.asarray(states), jnp.asarray(actions))
    with torch.no_grad():
        q, tq, v = heads(torch.from_numpy(hs), torch.from_numpy(states), torch.from_numpy(actions))
        full = heads(torch.from_numpy(hs))
    assert len(q) == len(tq) == (2 if two_qs else 1) and v.shape == (b, 4, 1) and q[0].shape == (b, 3, V)
    for got, want in zip((*q, *tq, v), (*jq, *jtq, jv)):
        _close(got, want, 1e-6)
    at_actions = full[0][0].gather(1, torch.from_numpy(actions).long()[..., None].expand(-1, -1, V))
    torch.testing.assert_close(q[0], at_actions, rtol=0, atol=0)
    sync_target_q_heads(heads, 0.3)
    jsynced = j_sync_target_q_heads(jp, 0.3)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jsynced))
    for name, w in heads.state_dict().items():
        _close(w, want[name], 1e-6)
    assert not torch.equal(heads.state_dict()["target_q_head_0.dense_in.weight"],
                           params_from_jax(jax.tree_util.tree_map(np.asarray, jp))["target_q_head_0.dense_in.weight"])


# ---------------------------------------------------------------------------
# make_experience and the storage
# ---------------------------------------------------------------------------


def _dialogues(n=6, seed=1):
    rng = np.random.RandomState(seed)
    word = lambda k: "".join(chr(97 + c) for c in rng.randint(0, 26, k))
    out = [[word(rng.randint(3, 9)), word(rng.randint(2, 12))] for _ in range(n)]
    out.append([word(30), "cut away"])  # the prompt fills max_length: skipped
    out.append(word(6))  # a bare string: one output after a bos
    return out, list(rng.randn(len(out)))


def test_make_experience_and_collation_match_jax():
    samples, rewards = _dialogues()
    store = make_experience(samples, rewards, ByteTokenizer(), max_length=24)
    jstore = j_make_experience(samples, rewards, JByteTokenizer(), max_length=24)
    assert len(store) == len(jstore) == len(samples) - 1
    for col, jcol, field in zip(store.columns, jstore.columns, FIELDS):
        for a, ja in zip(col, jcol):
            if field == "rewards":
                _close(a, ja, 1e-6)
            else:
                np.testing.assert_array_equal(a, np.asarray(ja))
    assert sum(float(r[-1]) for r in store.columns[2]) == pytest.approx(0.0, abs=1e-5)
    batch = next(iter(store.create_loader(4, shuffle=True, drop_last=False, seed=3)))
    jbatch = next(iter(jstore.create_loader(4, shuffle=True, drop_last=False, seed=3)))
    for field in FIELDS:
        got, want = getattr(batch, field), np.asarray(getattr(jbatch, field))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_ilql_storage_padding():
    """(`tests/test_pipelines.py:132`) each field right padded to its
    longest row."""
    columns = ([np.array([1, 2, 3]), np.array([4, 5])], [np.ones(3, dtype=int), np.ones(2, dtype=int)],
               [np.array([0.0, 1.0], dtype=np.float32), np.array([0.5], dtype=np.float32)],
               [np.array([0, 1, 2]), np.array([0, 1])], [np.array([0, 1]), np.array([0])],
               [np.array([1, 1, 0]), np.array([1, 0])])
    batch = next(iter(ILQLRolloutStorage(*columns).create_loader(2, shuffle=False, drop_last=False)))
    jbatch = next(iter(JILQLRolloutStorage(*columns).create_loader(2, shuffle=False, drop_last=False)))
    assert batch.input_ids.shape == (2, 3) and batch.rewards.shape == (2, 2)
    assert batch.dones[1].tolist() == [1, 0, 0]
    for field in FIELDS:
        np.testing.assert_array_equal(getattr(batch, field), np.asarray(getattr(jbatch, field)))


# ---------------------------------------------------------------------------
# Q-guided sampling
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=["gpt2-tiny", "llama-tiny"])
def ilql_pair(request):
    """JAX and port LMs with ILQL heads (two Q heads), f32, same weights;
    the target heads apart from the Q heads."""
    extra = {"dtype": "float32", "attn_impl": "flash"}
    jmodel, jcfg, jparams = j_build_model(JModelConfig(model_path=f"random:{request.param}", model_extra_configs=extra),
                                          vocab_size=V, rng=jax.random.PRNGKey(0), with_ilql_heads=True)
    rng = np.random.RandomState(5)
    heads = {k: (jax.tree_util.tree_map(lambda a: np.asarray(a) + 0.2 * rng.randn(*a.shape).astype(np.float32), v)
                 if k.startswith("target") else v) for k, v in jparams["ilql_heads"].items()}
    jparams = {**jparams, "ilql_heads": heads}
    tmodel, tcfg, _ = build_model(ModelConfig(model_path=f"random:{request.param}", model_extra_configs=extra),
                                  vocab_size=V, device="cpu", with_ilql_heads=True)
    state = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), tcfg)
    assert state.keys() == tmodel.state_dict().keys()
    tmodel.load_state_dict(state)
    return SimpleNamespace(jmodel=jmodel, jcfg=jcfg, jparams=jparams, tmodel=tmodel, tcfg=tcfg)


def _gen(pkg, **kw):
    kw = {"max_new_tokens": 10, "eos_token_id": EOS, "pad_token_id": PAD, "do_sample": False, "beta": 1.0, **kw}
    return (j_sampling if pkg == "jax" else sampling).GenerationConfig(**kw)


@pytest.mark.parametrize("case", ["two_qs", "one_q", "logit_mask", "top_k"])
def test_greedy_q_guided_sampling_matches_jax(ilql_pair, case):
    """Greedy sampling under the beta * (Q - V) shift, token for token the
    JAX sampler's (`make_generate_fn(mode="ilql")`), with the smaller of
    the two target heads or the first alone, with a transition mask, and
    with top-k; the shift changes what plain greedy sampling picks."""
    ids = np.asarray([[PAD] * 3 + [3, 1, 4, 1, 5], [2, 7, 1, 8, 2, 8, 1, 8], [PAD] * 6 + [11, 13]], np.int32)
    mask = (ids != PAD).astype(np.int32)
    two_qs = case != "one_q"
    kw = {"top_k": 5} if case == "top_k" else {}
    logit_mask = None
    if case == "logit_mask":
        logit_mask = np.zeros((V, V), bool)
        logit_mask[:, 0:V:3] = True  # every third token forbidden after any other
    jfn = jax.jit(j_sampling.make_generate_fn(ilql_pair.jmodel, ilql_pair.jcfg, _gen("jax", **kw), mode="ilql",
                                              logit_mask=logit_mask, two_qs=two_qs))
    want = jax.tree_util.tree_map(np.asarray, jfn(ilql_pair.jparams, jnp.asarray(ids), jnp.asarray(mask),
                                                  jax.random.PRNGKey(0)))
    fn = sampling.make_generate_fn(ilql_pair.tmodel, ilql_pair.tcfg, _gen("torch", **kw), mode="ilql",
                                   logit_mask=logit_mask, two_qs=two_qs)
    got = fn(ids, mask)
    for key in ("samples", "samples_mask", "response_tokens", "response_mask"):
        np.testing.assert_array_equal(got[key].numpy(), want[key])
    if case == "two_qs":
        plain = sampling.make_generate_fn(ilql_pair.tmodel, ilql_pair.tcfg, _gen("torch", beta=0.0), mode="ilql")
        assert not torch.equal(plain(ids, mask)["response_tokens"], got["response_tokens"])


def test_ilql_sampler_refusals(ilql_pair):
    with pytest.raises(NotImplementedError, match="mode='lm'"):
        sampling.make_generate_fn(ilql_pair.tmodel, ilql_pair.tcfg, _gen("torch"), mode="ilql", capture=True)
    with pytest.raises(ValueError, match="mode="):
        sampling.make_generate_fn(ilql_pair.tmodel, ilql_pair.tcfg, _gen("torch"), mode="beam")


# ---------------------------------------------------------------------------
# ILQLTrainer against the JAX trainer
# ---------------------------------------------------------------------------


def _config(make, tmp, side, **train):
    train = dict(dict(seq_length=24, batch_size=4, epochs=2, total_steps=1000, eval_interval=1000,
                      checkpoint_interval=1000, seed=7, checkpoint_dir=str(tmp / side / "ckpts"),
                      logging_dir=str(tmp / side / "logs")), **train)
    return make().evolve(
        train=train,
        model=dict(model_path="random:gpt2-tiny", model_extra_configs={"attn_impl": "flash", "dtype": "float32"}),
        method=dict(steps_for_target_q_sync=SYNC, alpha=0.3, beta=1.0,
                    gen_kwargs=dict(max_new_tokens=6, top_k=5, beta=1.0)),
    )


def _heads(model):
    return {k: v.clone() for k, v in model.state_dict().items() if "target_q_head" in k}


def test_train_entry_point_runs_ilql_checkpoints_and_resumes_exactly(tmp_path):
    """`trlx_tpu_torch.train(samples=..., rewards=...)` end to end: the
    length check; two epochs with a sync every 2 steps and Q-guided
    evaluation; the `done` checkpoint reloads into a fresh ILQLTrainer
    with equal parameters, target heads included; a run resumed from step
    3 ends bitwise equal to the uninterrupted one."""
    import trlx_tpu_torch

    samples, rewards = _dialogues(10, seed=4)
    cfg = lambda side, **train: _config(default_ilql_config, tmp_path, side, checkpoint_interval=1, **train)
    with pytest.raises(ValueError, match="should match"):
        trlx_tpu_torch.train(samples=samples, rewards=rewards[:-1], config=cfg("bad"), device="cpu")
    run = lambda side, **train: trlx_tpu_torch.train(samples=samples, rewards=rewards, eval_prompts=["ab", "xyz"],
                                                     config=cfg(side, **train), device="cpu")
    full = run("full")
    assert isinstance(full, ILQLTrainer) and full.iter_count == full.total_steps == 6
    fresh = ILQLTrainer(cfg("full"), device="cpu")
    fresh.load(os.path.join(tmp_path, "full", "ckpts", "checkpoint_6"))
    for (name, a), b in zip(full.model.state_dict().items(), fresh.model.state_dict().values()):
        assert torch.equal(a, b), name
    assert fresh.iter_count == 6
    resumed = run("resumed", resume_from_checkpoint=os.path.join(tmp_path, "full", "ckpts", "checkpoint_3"))
    assert resumed.iter_count == 6
    for (name, a), b in zip(full.model.state_dict().items(), resumed.model.state_dict().values()):
        assert torch.equal(a, b), name


def test_train_defaults_to_ilql_and_refuses_other_offline_trainers(tmp_path, monkeypatch):
    """Without a config, `rewards` pick `default_ilql_config` (read here
    before the trainer is built); another trainer with `rewards` is
    refused, naming its ROADMAP item, and a causal preset under seq2seq
    raises as JAX's build does."""
    import trlx_tpu_torch
    from trlx_tpu_torch import trlx as entry

    seen = {}

    class Stop(Exception):
        pass

    def capture(self, config, **kw):
        seen["config"] = config
        raise Stop

    monkeypatch.setattr(entry, "get_trainer", lambda name: type("T", (ILQLTrainer,), {"__init__": capture}))
    with pytest.warns(UserWarning, match="config"), pytest.raises(Stop):
        trlx_tpu_torch.train(samples=["a", "b"], rewards=[1.0, 0.0], device="cpu")
    assert seen["config"].train.trainer == "ILQLTrainer" and seen["config"].method.two_qs
    monkeypatch.undo()
    cfg = _config(default_ilql_config, tmp_path, "t").evolve(train=dict(trainer="SFTTrainer"))
    with pytest.raises(NotImplementedError, match="ROADMAP queue A, item 4"):
        trlx_tpu_torch.train(samples=["a", "b"], rewards=[1.0, 0.0], config=cfg, device="cpu")
    seq2seq = _config(default_ilql_config, tmp_path, "s").evolve(model=dict(model_arch_type="seq2seq"))
    with pytest.raises(ValueError, match="Unknown seq2seq preset"):
        ILQLTrainer(seq2seq, device="cpu")
