"""The port's SFT slice (trlx_tpu_torch: optimizer and schedules,
pipelines, SFTTrainer.learn, save/load, trlx_tpu_torch.train) against the
JAX package's on the same numpy inputs and the same weights (carried
into the port by `params_from_jax`).

The trainers run gpt2-tiny and llama-tiny at f32 with
`attn_impl="flash"` and `num_layers_unfrozen=1` (block 0 frozen: the
forward-only attention; block 1 trainable: the forward with lse and the
backward), 3 optimizer steps of AdamW under the cosine schedule, and a
greedy evaluation before the first step and after the last.

Tolerances: the first step's loss within 1e-5 (f32, summation order
only). The parameters after 3 AdamW steps within 2e-5 (the key bias,
whose exact gradient is 0, within its bound): Adam normalises
each gradient element by its running RMS, so an element whose gradient
is near zero can move by a few 1e-6 on one side and not the other;
lr is 1e-4, so no element moves by more than 3e-4 in all. The optimizer
on its own against optax: 1e-6.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from trlx_tpu.data.default_configs import default_sft_config as j_default_sft_config
from trlx_tpu.pipeline.offline_pipeline import DialogStore as JDialogStore
from trlx_tpu.pipeline.offline_pipeline import PromptPipeline as JPromptPipeline
from trlx_tpu.pipeline.offline_pipeline import tokenize_dialogue as j_tokenize_dialogue
from trlx_tpu.tokenizers import get_tokenizer as j_get_tokenizer
from trlx_tpu.trainer.sft_trainer import SFTTrainer as JSFTTrainer
from trlx_tpu.utils import get_optimizer as j_get_optimizer
from trlx_tpu.utils import get_scheduler as j_get_scheduler
from trlx_tpu_torch.convert import params_from_jax
from trlx_tpu_torch.data.configs import TokenizerConfig
from trlx_tpu_torch.data.default_configs import default_sft_config
from trlx_tpu_torch.pipeline import MiniBatchIterator
from trlx_tpu_torch.pipeline.offline_pipeline import DialogStore, PromptPipeline, tokenize_dialogue
from trlx_tpu_torch.tokenizers import get_tokenizer
from trlx_tpu_torch.trainer.sft_trainer import SFTTrainer
from trlx_tpu_torch.utils import get_optimizer, get_scheduler

# one intra-op thread: the tensors here are tiny, and the suite runs in
# several worker processes at once, which extra threads only slow down
torch.set_num_threads(1)

STEPS = 3


# ---------------------------------------------------------------------------
# Optimizer and schedules against optax
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("opt", ["adamw", "adam", "sgd"])
@pytest.mark.parametrize("sched,kw", [
    ("cosine_annealing", dict(T_max=4, eta_min=1e-3)),
    ("linear", dict(total_iters=3, eta_min=1e-3)),
    ("constant", {}),
    ("cosine_warmup", dict(warmup_steps=2, T_max=5, eta_min=1e-3)),
])
def test_optimizer_and_schedule_match_optax(opt, sched, kw):
    """Three updates with fixed gradients: the n-th update uses
    schedule(n), step 0 included; AdamW decays the old parameter and keeps
    eps outside the square root, as optax does."""
    rng = np.random.RandomState(0)
    p0 = rng.randn(5, 3).astype(np.float32)
    grads = [rng.randn(5, 3).astype(np.float32) for _ in range(STEPS)]
    okw = dict(lr=1e-2, betas=(0.9, 0.95), eps=1e-8, weight_decay=0.1)
    j_sched = j_get_scheduler(sched, 1e-2, kw)
    j_opt = j_get_optimizer(opt, j_sched, okw)
    jp = {"w": jnp.asarray(p0)}
    state = j_opt.init(jp)
    for g in grads:
        updates, state = j_opt.update({"w": jnp.asarray(g)}, state, jp)
        jp = optax.apply_updates(jp, updates)

    w = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    t_opt = get_optimizer(opt, [w], okw)
    t_sched = torch.optim.lr_scheduler.LambdaLR(t_opt, get_scheduler(sched, 1e-2, kw))
    for i, g in enumerate(grads):
        assert t_opt.param_groups[0]["lr"] == pytest.approx(float(j_sched(i)), rel=1e-6, abs=1e-9)
        w.grad = torch.from_numpy(g)
        t_opt.step()
        t_sched.step()
    np.testing.assert_allclose(w.detach().numpy(), np.asarray(jp["w"]), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("opt", ["lion", "rmsprop", "adamw_8bit_bnb"])
def test_unported_optimizers_raise(opt):
    """These optimizers are ported (ROADMAP queue A, item 4.6; their steps
    are held to JAX's in `test_torch_quantized_optim.py`): each builds with
    the config's arguments at the port's lr of 1.0, and an argument the
    JAX package's optimizer does not take raises as there."""
    from trlx_tpu_torch.ops.quantized_optim import Adam8bit
    from trlx_tpu_torch.utils import Lion, RMSprop

    p = [torch.nn.Parameter(torch.zeros(2))]
    opt_ = get_optimizer(opt, p, dict(lr=3e-4, betas=(0.8, 0.9), eps=1e-6, weight_decay=0.05))
    group = opt_.param_groups[0]
    want = {"lion": (Lion, dict(lr=1.0, betas=(0.8, 0.9), weight_decay=0.05)),
            "rmsprop": (RMSprop, dict(lr=1.0, eps=1e-6, momentum=0.9, decay=0.9)),
            "adamw_8bit_bnb": (Adam8bit, dict(lr=1.0, betas=(0.8, 0.9), eps=1e-6, weight_decay=0.05))}[opt]
    assert type(opt_) is want[0] and {k: group[k] for k in want[1]} == want[1]
    if opt != "lion":  # optax.lion takes no extra argument, and JAX's branch passes none
        with pytest.raises(TypeError):
            get_optimizer(opt, p, {"amsgrad": True})


# ---------------------------------------------------------------------------
# Pipelines: batches and shuffle order
# ---------------------------------------------------------------------------


def _texts(n, seed):
    rng = np.random.RandomState(seed)
    return ["".join(chr(97 + c) for c in rng.randint(0, 26, rng.randint(3, 30))) for _ in range(n)]


def _batches(loader, epochs=2):
    return [b for _ in range(epochs) for b in loader]


def _assert_same_batches(tb, jb):
    assert len(tb) == len(jb)
    for t, j in zip(tb, jb):
        assert set(t) == set(j)
        for k in t:
            np.testing.assert_array_equal(np.asarray(t[k]), np.asarray(j[k]))


@pytest.mark.parametrize("padding_side", ["left", "right"])
def test_prompt_pipeline_batches_and_shuffle_match_jax(padding_side):
    texts = _texts(11, 0)
    kw = dict(tokenizer_path="byte", padding_side=padding_side, truncation_side="left")
    tok, jtok = get_tokenizer(TokenizerConfig(**kw)), j_get_tokenizer(TokenizerConfig(**kw))
    tp, jp = PromptPipeline(texts, 20, tok), JPromptPipeline(texts, 20, jtok)
    assert tp.max_prompt_length == jp.max_prompt_length
    _assert_same_batches(_batches(tp.create_loader(3, shuffle=True, seed=7)),
                         _batches(jp.create_loader(3, shuffle=True, seed=7)))
    _assert_same_batches(_batches(tp.create_loader(4), 1), _batches(jp.create_loader(4), 1))


@pytest.mark.parametrize("truncation_side", ["left", "right"])
def test_dialog_store_batches_and_shuffle_match_jax(truncation_side):
    texts = _texts(12, 1)
    dialogs = [texts[i:i + 2] for i in range(0, 12, 2)] + ["a single sample string"]
    kw = dict(tokenizer_path="byte", truncation_side=truncation_side)
    tok, jtok = get_tokenizer(TokenizerConfig(**kw)), j_get_tokenizer(TokenizerConfig(**kw))
    td = [tokenize_dialogue(d, tok, 24) for d in dialogs]
    jd = [j_tokenize_dialogue(d, jtok, 24) for d in dialogs]
    assert [[(m.is_output, m.tokens) for m in d] for d in td] == [[(m.is_output, m.tokens) for m in d] for d in jd]
    ts, js = DialogStore(td, tok), JDialogStore(jd, jtok)
    tb = _batches(ts.create_loader(3, shuffle=True, seed=3))
    _assert_same_batches(tb, _batches(js.create_loader(3, shuffle=True, seed=3)))
    mbs = list(MiniBatchIterator(ts.create_loader(4, shuffle=False), 2, 2))
    assert [len(m) for m in mbs] == [2, 2] and mbs[0][1]["input_ids"].shape[0] == 2


# ---------------------------------------------------------------------------
# The slice as a whole: SFTTrainer.learn against the JAX trainer
# ---------------------------------------------------------------------------


def _configs(preset, tmp, side):
    evolve = dict(
        train=dict(seq_length=48, batch_size=4, total_steps=STEPS, eval_interval=STEPS,
                   checkpoint_interval=10000, seed=5,
                   checkpoint_dir=str(tmp / side / "ckpts"), logging_dir=str(tmp / side / "logs")),
        model=dict(model_path=f"random:{preset}", num_layers_unfrozen=1,
                   model_extra_configs={"attn_impl": "flash", "dtype": "float32"}),
        method=dict(gen_kwargs=dict(max_new_tokens=6, do_sample=False)),
    )
    make = j_default_sft_config if side == "jax" else default_sft_config
    return make().evolve(**evolve)


def _eval_recorder(store):
    def metric_fn(samples, prompts, outputs, **kw):
        store.append(list(samples))
        return {}

    return metric_fn


def _losses(logging_dir):
    (path,) = [os.path.join(logging_dir, f) for f in os.listdir(logging_dir) if f.endswith(".metrics.jsonl")]
    with open(path) as f:
        return [row["loss"] for row in map(json.loads, f) if "loss" in row]


@pytest.fixture(scope="module", params=["gpt2-tiny", "llama-tiny"])
def trained(request, tmp_path_factory):
    """Both trainers on the same samples and weights, through learn()."""
    tmp = tmp_path_factory.mktemp(request.param)
    samples = [s * 3 for s in _texts(12, 2)]  # 9 to 87 bytes: truncated at 48, left padded
    eval_prompts = ["ab", "hello", "xyz", "q"]
    j_evals, t_evals = [], []
    jt = JSFTTrainer(_configs(request.param, tmp, "jax"), metric_fn=_eval_recorder(j_evals),
                     devices=jax.devices()[:1])
    tt = SFTTrainer(_configs(request.param, tmp, "torch"), metric_fn=_eval_recorder(t_evals), device="cpu")
    np_params = jax.tree_util.tree_map(np.asarray, jt.params)
    tt.model.load_state_dict(params_from_jax(np_params, tt.model_cfg))
    for tr, pipe in ((jt, JPromptPipeline), (tt, PromptPipeline)):
        tr.make_experience(samples, 48)
        tr.add_eval_pipeline(pipe(eval_prompts, 42, tr.tokenizer))
    jt.learn()
    tt.learn()
    return dict(jt=jt, tt=tt, j_evals=j_evals, t_evals=t_evals, tmp=tmp)


def test_sft_first_step_loss_matches_jax(trained):
    t_losses = _losses(trained["tt"].config.train.logging_dir)
    j_losses = _losses(trained["jt"].config.train.logging_dir)
    assert len(t_losses) == len(j_losses) == STEPS
    assert abs(t_losses[0] - j_losses[0]) < 1e-5
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-5, atol=1e-5)


def test_sft_params_after_three_steps_match_jax(trained):
    jt, tt = trained["jt"], trained["tt"]
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jt.params), tt.model_cfg)
    got = tt.model.state_dict()
    trainable = {n for n, p in tt.model.named_parameters() if p.requires_grad}
    assert trainable and all(n.startswith("lm.block_1.") or n.startswith("lm.ln_f") or
                             n.startswith("lm.lm_head") for n in trainable)
    for name, w in want.items():
        if name.endswith("k_proj.bias"):
            # its gradient is exactly 0 in exact arithmetic (a row's softmax
            # ignores a shift shared by every key), so Adam turns rounding
            # noise into steps of +-lr on both sides: held to its bound
            assert float((got[name] - w).abs().max()) <= 2 * STEPS * 1e-4
            continue
        torch.testing.assert_close(got[name], w, rtol=2e-5, atol=2e-5)
        if name not in trainable:
            assert torch.equal(got[name], w), f"frozen {name} moved"


def test_sft_greedy_eval_samples_match_jax(trained):
    assert len(trained["t_evals"]) == len(trained["j_evals"]) == 2  # before the first step, after the last
    assert trained["t_evals"] == trained["j_evals"]


def test_sft_checkpoint_round_trip(trained):
    """The `done` checkpoint (manifest-complete, with the HF export) loads
    into a fresh trainer with equal parameters, optimizer state and step."""
    tt = trained["tt"]
    directory = os.path.join(tt.config.train.checkpoint_dir, f"checkpoint_{STEPS}")
    assert sorted(os.listdir(directory)) == ["hf_model", "manifest.json", "model.pt", "state.pt",
                                             "trainer_state.json"]
    assert os.path.exists(os.path.join(directory, "hf_model", "pytorch_model.bin"))
    fresh = SFTTrainer(tt.config, device="cpu")
    fresh.load(directory)
    assert fresh.iter_count == STEPS
    for (name, a), b in zip(tt.model.state_dict().items(), fresh.model.state_dict().values()):
        assert torch.equal(a, b), name
    sa, sb = tt.optimizer.state_dict()["state"], fresh.optimizer.state_dict()["state"]
    assert sa.keys() == sb.keys() and all(torch.equal(sa[k]["exp_avg"], sb[k]["exp_avg"]) for k in sa)
    assert fresh.scheduler.last_epoch == tt.scheduler.last_epoch == STEPS


def test_train_entry_point_runs_sft_on_cpu(tmp_path):
    """trlx_tpu_torch.train(samples=..., config=...) end to end on the CPU,
    dialogues included; online and offline RL are refused."""
    import trlx_tpu_torch

    cfg = _configs("gpt2-tiny", tmp_path, "torch").evolve(train=dict(total_steps=2, eval_interval=2))
    dialogs = [["prompt one ", "answer one"], ["two ", "answer two"]] * 4
    trainer = trlx_tpu_torch.train(samples=dialogs, config=cfg, device="cpu")
    assert trainer.iter_count == 2
    assert all(np.isfinite(_losses(cfg.train.logging_dir)))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        trlx_tpu_torch.train(reward_fn=lambda **kw: [0.0], prompts=["a"], config=cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        trlx_tpu_torch.train(samples=["a", "b"], rewards=[1.0, 0.0], config=cfg, device="cpu")


def test_resume_from_checkpoint_continues_exactly(tmp_path):
    """A run resumed from its step-1 checkpoint (`train.resume_from_checkpoint`)
    replays the loader's shuffle from the saved loop position and ends with
    the parameters of the uninterrupted run, bit for bit."""
    samples = [s * 3 for s in _texts(12, 2)]

    def run(side, **train):
        cfg = _configs("gpt2-tiny", tmp_path, side).evolve(
            train=dict(total_steps=2, eval_interval=100, checkpoint_interval=1, **train))
        trainer = SFTTrainer(cfg, device="cpu")
        trainer.make_experience(samples, 48)
        trainer.add_eval_pipeline(PromptPipeline(["ab"], 42, trainer.tokenizer))
        trainer.learn()
        return trainer

    full = run("full")
    resumed = run("resumed", resume_from_checkpoint=str(tmp_path / "full" / "ckpts" / "checkpoint_1"))
    assert resumed.iter_count == full.iter_count == 2
    for (name, a), b in zip(full.model.state_dict().items(), resumed.model.state_dict().values()):
        assert torch.equal(a, b), name


def test_sft_step_counts_the_attention_mask_tokens(tmp_path):
    """The token count behind `throughput/train_tokens_per_s` (the trainer's
    `count_tokens` hook) is each microbatch's attention-mask sum."""
    cfg = _configs("gpt2-tiny", tmp_path, "torch").evolve(train=dict(minibatch_size=2))
    trainer = SFTTrainer(cfg, device="cpu")
    trainer.make_experience([s * 3 for s in _texts(8, 3)], 48)
    (minibatch,) = list(MiniBatchIterator(trainer.store.create_loader(4), trainer.mb_size, trainer.num_mb))[:1]
    want = sum(int(mb["attention_mask"].sum()) for mb in minibatch)
    assert len(minibatch) == 2 and 0 < want < 2 * 2 * 48
    assert [trainer.count_tokens(mb) for mb in minibatch] == [int(mb["attention_mask"].sum()) for mb in minibatch]
    stats = trainer.train_minibatch(minibatch)
    assert round(stats["throughput/train_tokens_per_s"] * stats["time/train_step_s"]) == want
