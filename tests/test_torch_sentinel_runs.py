"""The health sentinel's whole runs against the JAX trainer, the cases of
`test_torch_sentinel.py` moved to a file of their own (the suite's
`--dist loadfile` hands out the files with the fewest tests last, so
these heavy ones fill a worker the parallelism files leave idle): the
guard's global norm under gradient accumulation, and a chaos run (a NaN
step, loss spikes, the ladder's rewind) step for step."""

import json
import os
import time

import jax
import numpy as np
import pytest
import torch

from trlx_tpu import resilience as j_resilience
from trlx_tpu import sentinel as j_sentinel
from trlx_tpu.data.default_configs import default_ppo_config as j_default_ppo_config
from trlx_tpu.pipeline.offline_pipeline import PromptPipeline as JPromptPipeline
from trlx_tpu.trainer.ppo_trainer import PPOTrainer as JPPOTrainer
from trlx_tpu_torch import resilience, sentinel
from trlx_tpu_torch.convert import params_from_jax
from trlx_tpu_torch.data import PPORLElement
from trlx_tpu_torch.data.default_configs import default_ppo_config
from trlx_tpu_torch.models.policy import HydraReference
from trlx_tpu_torch.pipeline import MiniBatchIterator
from trlx_tpu_torch.pipeline.offline_pipeline import PromptPipeline
from trlx_tpu_torch.trainer.ppo_trainer import PPOTrainer
from test_torch_sentinel import (  # the cases' helpers, shared with test_torch_sentinel.py
    SENTINEL,
    STOP,
    _config,
    _prompts,
    _record_actions,
    _rows,
    _store_batches,
    _trainer,
    reward_fn,
)

torch.set_num_threads(1)


def test_grad_norm_under_accumulation_matches_jax(tmp_path):
    """The guard's norm is JAX's `optax.global_norm` of the averaged
    gradients, with one microbatch and with two."""
    for mb_size in (4, 2):
        side = f"mb{mb_size}"
        jt = JPPOTrainer(_config(j_default_ppo_config, tmp_path, "jax" + side, minibatch_size=mb_size,
                                 **SENTINEL), reward_fn=reward_fn, devices=jax.devices()[:1])
        t = _trainer(tmp_path, side, minibatch_size=mb_size, **SENTINEL)
        t.model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, jt.params), t.model_cfg))
        t.ref_model = HydraReference(t.model.lm, t.split)
        mbs = _store_batches(t)
        from trlx_tpu.data import PPORLElement as JPPORLElement

        rng = np.random.default_rng(3)
        for _ in range(16):
            jt.store.push([JPPORLElement(
                query_tensor=rng.integers(3, 8, size=4).astype(np.int32),
                response_tensor=rng.integers(3, 8, size=5).astype(np.int32),
                logprobs=rng.normal(size=5).astype(np.float32),
                values=rng.normal(size=5).astype(np.float32),
                rewards=rng.normal(size=5).astype(np.float32),
            )])
        from trlx_tpu.pipeline import MiniBatchIterator as JMiniBatchIterator

        j_mbs = list(JMiniBatchIterator(jt.store.create_loader(4, shuffle=False), jt.mb_size, jt.num_mb))
        ours = t.train_minibatch(mbs[0])["train/grad_global_norm"]
        theirs = float(jax.device_get(jt.train_minibatch(j_mbs[0]))["train"]["grad_global_norm"])
        np.testing.assert_allclose(ours, theirs, rtol=1e-5)


def test_chaos_run_matches_jax(tmp_path):
    train = dict(SENTINEL, epochs=6, total_steps=12, step_timeout_s=0.3)
    faults = dict(nan_grad_steps=[2], loss_spike_steps=[5, 6], hang_steps=[8], hang_step_s=0.6)
    jt = JPPOTrainer(_config(j_default_ppo_config, tmp_path, "jax", **train), reward_fn=reward_fn,
                     stop_sequences=STOP, devices=jax.devices()[:1])
    tt = _trainer(tmp_path, "torch", **train)
    tt.model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, jt.params), tt.model_cfg))
    tt.ref_model = HydraReference(tt.model.lm, tt.split)
    jt.add_prompt_pipeline(JPromptPipeline(_prompts(), 40, jt.tokenizer))
    jt.add_eval_pipeline(JPromptPipeline(_prompts()[:4], 40, jt.tokenizer))
    ref_before = {k: v.clone() for k, v in tt.ref_model.state_dict().items()}
    acts, j_acts, fired, j_fired = [], [], [], []
    for t, a, f, inj in ((tt, acts, fired, resilience), (jt, j_acts, j_fired, j_resilience)):
        t.fault_injector = inj.FaultInjector(**faults)
        t._watchdog_on_timeout = lambda f=f, t=t: f.append(t.iter_count)
        _record_actions(t, a)
    tt.learn()
    jt.learn()
    assert acts == j_acts
    assert [a for _, a in acts].count("rewind") == 1 and "warn" in [a for _, a in acts]
    assert tt.iter_count == jt.iter_count == 12
    assert fired and j_fired  # the hang wedged the step past step_timeout_s
    ours, theirs = tt._sentinel, jt._sentinel
    assert ours.skipped_updates == theirs.skipped_updates >= 3
    assert ours.quarantined_rows == theirs.quarantined_rows
    assert ours.rewinds_used == theirs.rewinds_used == 1
    assert ours.last_good["step"] == theirs.last_good["step"]
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jt.params), tt.model_cfg)
    for name, w in tt.model.state_dict().items():
        np.testing.assert_allclose(w.numpy(), want[name].numpy(), rtol=2e-4, atol=2e-4, err_msg=name)
    for name, w in tt.ref_model.state_dict().items():
        assert torch.equal(w, ref_before[name]), name  # the reference restored bitwise
    rows = _rows(tt.config.train.logging_dir)
    assert any(r.get("train/skipped_updates", 0.0) >= 1.0 for r in rows)
    assert max(r.get("sentinel/rewinds", 0.0) for r in rows) == 1.0
    assert all("sentinel/quarantined_rows" in r and "rollout/entropy" in r for r in rows if "kl_ctl_value" in r)
    assert resilience.is_valid_checkpoint(os.path.join(tt.config.train.checkpoint_dir, sentinel.LAST_GOOD_NAME))
