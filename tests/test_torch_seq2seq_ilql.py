"""Seq2seq ILQL in the port (`ILQLSeq2SeqRolloutStorage`,
`make_experience_seq2seq`, the seq2seq loss, the `train(samples=...,
rewards=...)` entry point, Q-guided seq2seq sampling) against the JAX
package, over the t5 directories `seq2seq_cases.write_t5_dirs` writes
(t5 v1.0 and flan-t5 layouts) at f32.

Tolerances: the store and its collation exactly; the loss and its stats
1e-5, gradients 1e-5 relative to each tensor's largest element; the
logged losses of a `train()` run 1e-5 and its parameters 2e-5 (Adam's
+-lr steps on near-zero gradients bounded, as in `test_torch_moe.py`);
Q-guided greedy tokens exactly.
"""

import json
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seq2seq_cases import S2S, close, np_tree, write_t5_dirs
from trlx_tpu.data.default_configs import default_ilql_config as j_default_ilql_config
from trlx_tpu.trainer.ilql_trainer import ILQLTrainer as JILQLTrainer
from trlx_tpu.trainer.ilql_trainer import make_experience_seq2seq as j_make_experience_seq2seq
from trlx_tpu_torch.convert import params_from_jax
from trlx_tpu_torch.data import ILQLSeq2SeqBatch
from trlx_tpu_torch.data.default_configs import default_ilql_config
from trlx_tpu_torch.tokenizers import get_tokenizer
from trlx_tpu_torch.trainer.ilql_trainer import ILQLTrainer, make_experience_seq2seq
from trlx_tpu_torch.utils import flatten_dict

torch.set_num_threads(1)
dirs = pytest.fixture(scope="module")(write_t5_dirs)


def _samples(n=8, seed=3):
    rng = np.random.RandomState(seed)
    word = lambda k: "".join(chr(97 + c) for c in rng.randint(0, 26, k))
    return [(word(rng.randint(2, 9)), " " + word(rng.randint(1, 8))) for _ in range(n)], list(rng.randn(n))


def test_seq2seq_store_matches_jax():
    """`make_experience_seq2seq` (a long output keeps its eos) and the
    collation, field by field."""
    tok = get_tokenizer(SimpleNamespace(tokenizer_path="byte", padding_side="left", truncation_side="right",
                                        tokenizer_extra_configs={}))
    samples, rewards = _samples()
    samples[0] = (samples[0][0], "x" * 40)
    store = make_experience_seq2seq(samples, rewards, tok, 24, 256)
    jstore = j_make_experience_seq2seq(samples, rewards, tok, 24, decoder_start_token_id=256)
    assert len(store) == len(jstore) == 8
    assert store[0].decoder_input_ids[-1] == tok.eos_token_id and len(store[0].decoder_input_ids) == 24
    for b, jb in zip(store.create_loader(3, shuffle=True, seed=2), jstore.create_loader(3, shuffle=True, seed=2)):
        assert isinstance(b, ILQLSeq2SeqBatch)
        for f in store.fields:
            np.testing.assert_array_equal(getattr(b, f), np.asarray(getattr(jb, f)), err_msg=f)


def _ilql_config(make, path, tmp, side):
    return make().evolve(
        train=dict(seq_length=24, batch_size=4, epochs=100, total_steps=2, eval_interval=10**6,
                   checkpoint_interval=10**6, seed=5, save_best=False, save_optimizer=False, checkpoint_dir=str(tmp / side / "ckpts"),
                   logging_dir=str(tmp / side / "logs")),
        model=dict(model_path=path, **S2S),
        method=dict(steps_for_target_q_sync=1, alpha=0.3, beta=1.0,
                    gen_kwargs=dict(max_new_tokens=6, top_k=5, beta=1.0)))


def test_seq2seq_ilql_train_matches_jax_learn(dirs, tmp_path):
    """`trlx_tpu_torch.train(samples=..., rewards=...)` on the t5 v1.0
    checkpoint, 2 steps with a Polyak sync after each, against the JAX
    trainer's `learn()` from the same weights: each step's logged loss
    1e-5 and the parameters, target heads included; Q-guided greedy
    sampling of the trained model, token for token."""
    import trlx_tpu_torch

    samples, rewards = _samples()
    jt = JILQLTrainer(_ilql_config(j_default_ilql_config, dirs["t5-v1.0"], tmp_path, "jax"),
                      devices=jax.devices()[:1])
    start = params_from_jax(np_tree(jt.params))
    jt.make_experience(samples, rewards, 24)
    from trlx_tpu.pipeline.offline_pipeline import PromptPipeline as JPromptPipeline

    prompts = [p for p, _ in samples]
    jt.add_eval_pipeline(JPromptPipeline(prompts, 18, jt.tokenizer, add_special_tokens=True))
    jt.learn()
    get_arch = ILQLTrainer.get_arch

    def from_jax(self, config):
        model, cfg, state = get_arch(self, config)
        model.load_state_dict(start)
        return model, cfg, state

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ILQLTrainer, "get_arch", from_jax)
        tt = trlx_tpu_torch.train(samples=samples, rewards=rewards, eval_prompts=prompts,
                                  config=_ilql_config(default_ilql_config, dirs["t5-v1.0"], tmp_path, "torch"),
                                  device="cpu")
    assert tt.seq2seq and tt.iter_count == jt.iter_count == 2

    def losses(side):
        (path,) = [os.path.join(tmp_path / side / "logs", f) for f in os.listdir(tmp_path / side / "logs")
                   if f.endswith(".metrics.jsonl")]
        with open(path) as f:
            return [row["losses/loss"] for row in map(json.loads, f) if "losses/loss" in row]

    assert len(losses("torch")) == 2
    close(losses("torch"), losses("jax"), 1e-5)
    lr = float(tt.config.optimizer.kwargs.get("lr", 1e-4))
    got = tt.model.state_dict()
    for name, w in params_from_jax(np_tree(jt.params), tt.model_cfg).items():
        off = (got[name] - w).abs() > 2e-5 + 2e-5 * w.abs()
        assert float((got[name] - w).abs().max()) <= 4 * lr, name
        assert float(off.float().mean()) <= 1e-3, name
    assert not torch.equal(got["ilql_heads.target_q_head_0.dense_out.weight"],
                           start["ilql_heads.target_q_head_0.dense_out.weight"])
    # the trained weights, bitwise, then Q-guided greedy sampling on both
    tt.model.load_state_dict(params_from_jax(np_tree(jt.params), tt.model_cfg))
    batch = next(iter(tt.eval_pipeline.create_loader(8)))
    gen = dict(max_new_tokens=6, do_sample=False, beta=1.0)
    out = tt.generate(batch["input_ids"], batch["attention_mask"], gen)
    jout = jt.generate(batch["input_ids"], batch["attention_mask"], gen)
    np.testing.assert_array_equal(out["samples"].numpy(), np.asarray(jout["samples"]))
    assert (out["samples"][:, 0] == 256).all()
    with open(os.path.join(tt.config.train.checkpoint_dir, "checkpoint_2", "hf_model", "config.json")) as f:
        assert json.load(f)["model_type"] == "t5"


def test_seq2seq_ilql_loss_and_gradients_match_jax(dirs, tmp_path):
    """The seq2seq ILQL loss on one collated batch and its gradients, on
    the flan layout: loss and stats 1e-5, gradients 1e-5 relative to each
    tensor's largest element."""
    from flax import traverse_util

    samples, rewards = _samples(4, seed=4)
    jt = JILQLTrainer(_ilql_config(j_default_ilql_config, dirs["flan-t5"], tmp_path, "jax"),
                      devices=jax.devices()[:1])
    tt = ILQLTrainer(_ilql_config(default_ilql_config, dirs["flan-t5"], tmp_path, "torch"), device="cpu")
    tt.model.load_state_dict(params_from_jax(np_tree(jt.params), tt.model_cfg))
    jt.make_experience(samples, rewards, 24)
    tt.make_experience(samples, rewards, 24)
    jb = jax.tree_util.tree_map(jnp.asarray, next(iter(jt.create_train_dataloader())))
    batch = tt.batch_to_device(ILQLSeq2SeqBatch(*(np.asarray(getattr(jb, f)) for f in tt.store.fields)))
    (j_loss, j_stats), j_grads = jax.jit(jax.value_and_grad(jt.make_loss_fn(), has_aux=True))(
        jt.train_params, jt.frozen_params, jb)
    t_loss, t_stats = tt.make_loss_fn()(batch)
    t_loss.backward()
    close(t_loss.item(), float(j_loss), 1e-5)
    for k, v in flatten_dict(np_tree(j_stats)).items():
        close(t_stats[k], v, 1e-5)
    named = dict(tt.model.named_parameters())
    want = params_from_jax(traverse_util.unflatten_dict(np_tree(j_grads)))
    assert want.keys() == {n for n, p in named.items() if p.requires_grad}
    for name, w in want.items():
        scale = max(float(w.abs().max()), 1e-6)
        assert float((named[name].grad - w).abs().max()) <= 1e-5 * scale + 1e-7, name
