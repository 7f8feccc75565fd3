"""RFT in the port (`trainer/rft_trainer.py`: the growth step's sampling
passes, the rising percentile with its clip, the sorted dedup, the CE step
over every token and `default_rft_config`) against the JAX package's
RFTTrainer on the same generations and the same weights (carried by
`params_from_jax`).

The generations are injected (the same token rows on both sides, in the
same order), so the selection is compared exactly; the trainers run
gpt2-tiny at f32 with `attn_impl="flash"` (the port's kernel wrappers run
their plain versions on the CPU).

Tolerances: the selected samples, the stores and the loaders' batches
exactly; the thresholds 1e-12 (the same numpy); the first CE step's loss
1e-5; the parameters after 3 AdamW steps 2e-5 (the key bias, whose exact
gradient is 0, within its bound) and the frozen value head bitwise.
"""

import jax
import numpy as np
import pytest
import torch

from trlx_tpu.data.default_configs import default_rft_config as j_default_rft_config
from trlx_tpu.pipeline.offline_pipeline import PromptPipeline as JPromptPipeline
from trlx_tpu.trainer.rft_trainer import RFTTrainer as JRFTTrainer
from trlx_tpu_torch.convert import params_from_jax
from trlx_tpu_torch.data.default_configs import default_rft_config
from trlx_tpu_torch.pipeline.offline_pipeline import PromptPipeline
from trlx_tpu_torch.trainer.rft_trainer import RFTTrainer, select_generations

torch.set_num_threads(1)

STEPS = 3
ALPHABET = "abcdef"
PROMPTS = ["a", "bc", "d", "ef", "fa"]
N_GEN = 3


def reward_fn(samples, prompts, outputs, **kw):
    """Quantized (ties at the thresholds): the count of 'a' and 'b'."""
    return [float(sum(c in "ab" for c in o)) for o in outputs]


def _config(make, tmp, side):
    return make().evolve(
        train=dict(seq_length=16, batch_size=4, epochs=2, total_steps=1000, eval_interval=1000,
                   checkpoint_interval=1000, seed=11, checkpoint_dir=str(tmp / side / "ckpts"),
                   logging_dir=str(tmp / side / "logs")),
        model=dict(model_path="random:gpt2-tiny", model_extra_configs={"attn_impl": "flash", "dtype": "float32"}),
        tokenizer=dict(tokenizer_path=f"char:{ALPHABET}"),
        method=dict(n_generations_per_prompt=N_GEN, gen_kwargs=dict(max_new_tokens=6, do_sample=True)),
    )


def _inject_generations(jt, tt, seed):
    """Both trainers' `generate` return the same rows: the prompt batch
    followed by random ids of the alphabet, eos and pad (so outputs stop
    early, repeat, and tie)."""
    rng = np.random.RandomState(seed)
    vocab = len(ALPHABET) + 3

    def rows(input_ids):
        out = rng.randint(0, vocab, (len(input_ids), 6)).astype(np.int32)
        out[:, 3:] = np.where(rng.rand(len(input_ids), 3) < 0.5, out[:, 3:], out[:, :1])
        return np.concatenate([np.asarray(input_ids), out], axis=1)

    drawn = []

    def j_generate(input_ids, attention_mask, *a, **kw):
        drawn.append(rows(input_ids))
        return {"samples": drawn[-1]}

    def t_generate(input_ids, attention_mask, *a, **kw):
        return {"samples": torch.from_numpy(drawn.pop(0))}

    jt.generate, tt.generate = j_generate, t_generate


@pytest.fixture(scope="module")
def rft_pair(tmp_path_factory):
    """A JAX and a port RFTTrainer with the same weights and injected
    generations, through two growth cycles (epochs 0-4: one sampling pass
    each at epochs 0 and 4, the percentile rising in between), then STEPS
    CE steps on the JAX loader's batches, injected into both."""
    tmp = tmp_path_factory.mktemp("rft")
    jt = JRFTTrainer(_config(j_default_rft_config, tmp, "jax"), reward_fn=reward_fn, devices=jax.devices()[:1])
    tt = RFTTrainer(_config(default_rft_config, tmp, "torch"), reward_fn=reward_fn, device="cpu")
    tt.model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, jt.params), tt.model_cfg))
    jt.add_prompt_pipeline(JPromptPipeline(PROMPTS, 8, jt.tokenizer))
    tt.add_prompt_pipeline(PromptPipeline(PROMPTS, 8, tt.tokenizer))
    stores = []
    for epoch in range(5):
        if epoch % 4 == 0:
            _inject_generations(jt, tt, epoch)
        jt.epoch_count = tt.epoch_count = epoch
        jt.make_experience()
        tt.make_experience()
        stores.append(([p["input_ids"] for p in jt.store.prompts], [p["input_ids"] for p in tt.store.prompts]))
    v_head = {k: v.clone() for k, v in tt.model.state_dict().items() if k.startswith("v_head.")}
    jbatches = [b for _ in range(3) for b in jt.create_train_dataloader()][:STEPS]
    tbatches = [b for _ in range(3) for b in tt.create_train_dataloader()][:STEPS]
    injected = [{k: np.asarray(v) for k, v in b.items()} for b in jbatches]
    j_stats = [jax.tree_util.tree_map(np.asarray, jt.train_minibatch([b])) for b in jbatches]
    t_stats = [tt.train_minibatch([b]) for b in injected]
    return dict(jt=jt, tt=tt, stores=stores, v_head=v_head, jbatches=jbatches, tbatches=tbatches, j_stats=j_stats,
                t_stats=t_stats)


def test_selection_matches_jax(rft_pair):
    """Every growth step's store (the selected, deduplicated, sorted
    prompt + output strings, tokenized) equals JAX's; the generations
    accumulate per prompt across sampling passes."""
    jt, tt = rft_pair["jt"], rft_pair["tt"]
    for epoch, (want, got) in enumerate(rft_pair["stores"]):
        assert [list(x) for x in got] == [list(map(int, x)) for x in want], epoch
    assert {p: len(v) for p, v in tt.generations_per_prompt.items()} == {
        p: len(v) for p, v in jt.generations_per_prompt.items()}
    assert all(len(v) == 2 * N_GEN for v in tt.generations_per_prompt.values())
    sizes = [len(got) for _, got in rft_pair["stores"]]
    assert sizes[3] <= sizes[0]  # the rising percentile keeps fewer


def test_select_generations_percentile_clip_and_dedup():
    """The threshold is the per-prompt quantile, clipped into [min + 1e-3,
    max - 1e-3] over the prompts: the highest threshold drops below its
    prompt's maxima (they stay); the lowest rises above its quantile (here
    p's quantile is its maximum, so p keeps nothing); a middle one is
    untouched; duplicates go."""
    gens = {
        "p": [{"output": o, "score": s} for o, s in (("x", 1.0), ("y", 2.0), ("y", 2.0), ("z", 0.0))],
        "q": [{"output": o, "score": s} for o, s in (("u", 5.0), ("v", 5.0), ("w", 3.0))],
        "r": [{"output": o, "score": s} for o, s in (("s", 4.0), ("s", 4.0), ("t", 3.0))],
    }
    selected, thresholds, scores = select_generations(gens, 0.7)
    np.testing.assert_allclose(thresholds, [2.0 + 1e-3, 5.0 - 1e-3, 4.0], rtol=1e-12)
    assert selected == [("q", "u"), ("q", "v"), ("r", "s")]
    assert scores == [[1.0, 2.0, 2.0, 0.0], [5.0, 5.0, 3.0], [4.0, 4.0, 3.0]]


def test_ce_step_and_params_match_jax(rft_pair):
    """The loaders' batches equal; the CE step over every real token
    (prompt included) equals JAX's, and so do the parameters after STEPS
    steps; the value head stays frozen."""
    jt, tt = rft_pair["jt"], rft_pair["tt"]
    for jb, tb in zip(rft_pair["jbatches"], rft_pair["tbatches"]):
        for k in ("input_ids", "attention_mask"):
            np.testing.assert_array_equal(np.asarray(tb[k]), np.asarray(jb[k]))
    np.testing.assert_allclose(rft_pair["t_stats"][0]["loss"], float(rft_pair["j_stats"][0]["loss"]), rtol=1e-5,
                               atol=1e-5)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jt.params), tt.model_cfg)
    got = tt.model.state_dict()
    for name, w in want.items():
        if name.endswith("k_proj.bias"):
            assert float((got[name] - w).abs().max()) <= 2 * STEPS * 1e-4
            continue
        torch.testing.assert_close(got[name], w, rtol=2e-5, atol=2e-5)
    for name, w in rft_pair["v_head"].items():
        assert torch.equal(got[name], w) and not dict(tt.model.named_parameters())[name].requires_grad


def test_train_entry_point_runs_rft(tmp_path):
    """`trlx_tpu_torch.train(reward_fn=..., config=default_rft_config())`
    end to end on the CPU: growth steps, CE steps, evaluations."""
    import trlx_tpu_torch

    cfg = _config(default_rft_config, tmp_path, "e2e").evolve(train=dict(epochs=3, eval_interval=2))
    seen = []

    def counting_reward(samples, prompts, outputs, **kw):
        seen.append(len(samples))
        return reward_fn(samples, prompts, outputs)

    tr = trlx_tpu_torch.train(reward_fn=counting_reward, prompts=PROMPTS, eval_prompts=PROMPTS, config=cfg,
                              device="cpu")
    assert isinstance(tr, RFTTrainer) and tr.epoch_count == 3 and tr.iter_count > 0
    assert seen[:2] == [len(PROMPTS) * N_GEN, len(PROMPTS)]  # the first growth step, then an evaluation
    assert len(tr.store) > 0
