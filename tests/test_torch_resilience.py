"""The port's preemption handling (trlx_tpu_torch/resilience.py and the
learn loop) and its refusal of a `parallel` section that asks for more
than one device, on the CPU with the tiny preset of test_torch_sft.py.

A preempted `learn()` finishes its step, writes `checkpoint_<step>_preempt`
and exits with code 75, as the JAX trainer does; a run resumed from that
checkpoint ends with the parameters of an uninterrupted run, bit for bit.
Signals are delivered by calling the installed handler (or by
`signal.raise_signal` on the main thread), so the tests also pass in a
worker thread, where no OS handler can be installed.
"""

import json
import os
import signal
import threading

import numpy as np
import pytest
import torch

from trlx_tpu_torch import resilience
from trlx_tpu_torch.data.default_configs import default_sft_config
from trlx_tpu_torch.pipeline.offline_pipeline import PromptPipeline
from trlx_tpu_torch.trainer.base_trainer import MANIFEST_NAME, is_valid_checkpoint
from trlx_tpu_torch.trainer.sft_trainer import SFTTrainer

torch.set_num_threads(1)


def _on_main_thread():
    return threading.current_thread() is threading.main_thread()


def test_preemption_guard_flags_keeps_and_restores_handlers():
    before = signal.getsignal(signal.SIGTERM)
    with resilience.PreemptionGuard() as guard:
        assert not guard.triggered and guard.signum is None
        if _on_main_thread():
            assert signal.getsignal(signal.SIGTERM) == guard.handler
            assert guard._previous[signal.SIGTERM] is before
            signal.raise_signal(signal.SIGTERM)
        else:
            guard.handler(signal.SIGTERM, None)
        assert guard.triggered and guard.signum == signal.SIGTERM
    assert signal.getsignal(signal.SIGTERM) is before


def test_second_sigint_falls_through_to_the_previous_handler():
    calls = []
    guard = resilience.PreemptionGuard()
    if _on_main_thread():
        before = signal.signal(signal.SIGINT, lambda signum, frame: calls.append(signum))
        try:
            with guard:
                guard.handler(signal.SIGINT, None)
                assert guard.triggered and calls == []
                guard.handler(signal.SIGINT, None)
                assert calls == [signal.SIGINT]
        finally:
            signal.signal(signal.SIGINT, before)
    else:  # no previous handler could be recorded: a second ctrl-C interrupts
        with guard:
            guard.handler(signal.SIGINT, None)
            with pytest.raises(KeyboardInterrupt):
                guard.handler(signal.SIGINT, None)


def _samples():
    rng = np.random.RandomState(2)
    return ["".join(chr(97 + c) for c in rng.randint(0, 26, rng.randint(3, 30))) * 3 for _ in range(12)]


def _config(tmp_path, side, **overrides):
    train = dict(seq_length=48, batch_size=4, total_steps=2, eval_interval=100, checkpoint_interval=100,
                 seed=5, checkpoint_dir=str(tmp_path / side / "ckpts"),
                 logging_dir=str(tmp_path / side / "logs"))
    train.update(overrides)
    return default_sft_config().evolve(
        train=train,
        model=dict(model_path="random:gpt2-tiny", num_layers_unfrozen=1,
                   model_extra_configs={"attn_impl": "flash", "dtype": "float32"}),
        method=dict(gen_kwargs=dict(max_new_tokens=6, do_sample=False)),
    )


def _trainer(config):
    trainer = SFTTrainer(config, device="cpu")
    trainer.make_experience(_samples(), 48)
    trainer.add_eval_pipeline(PromptPipeline(["ab"], 42, trainer.tokenizer))
    return trainer


def test_preempted_learn_exits_75_with_a_checkpoint_that_resumes_exactly(tmp_path):
    before = signal.getsignal(signal.SIGTERM)
    preempted = _trainer(_config(tmp_path, "preempted"))
    real_step = preempted.train_minibatch

    def step_then_signal(minibatch):  # SIGTERM arrives during step 1
        stats = real_step(minibatch)
        if preempted.iter_count == 0:
            preempted._preemption_guard.handler(signal.SIGTERM, None)
        return stats

    preempted.train_minibatch = step_then_signal
    with pytest.raises(SystemExit) as exit_info:
        preempted.learn()
    assert exit_info.value.code == resilience.PREEMPTION_EXIT_CODE == 75
    assert preempted.iter_count == 1
    assert signal.getsignal(signal.SIGTERM) is before  # the guard is gone
    directory = tmp_path / "preempted" / "ckpts" / "checkpoint_1_preempt"
    assert is_valid_checkpoint(str(directory))
    assert json.loads((directory / MANIFEST_NAME).read_text())["step"] == 1
    assert sorted(os.listdir(directory.parent)) == ["checkpoint_1_preempt"]

    full = _trainer(_config(tmp_path, "full"))
    full.learn()
    resumed = _trainer(_config(tmp_path, "resumed", resume_from_checkpoint=str(directory)))
    resumed.learn()
    assert resumed.iter_count == full.iter_count == 2
    for (name, a), b in zip(full.model.state_dict().items(), resumed.model.state_dict().values()):
        assert torch.equal(a, b), name


def test_learn_without_handle_preemption_installs_no_guard(tmp_path):
    before = signal.getsignal(signal.SIGTERM)
    trainer = _trainer(_config(tmp_path, "off", handle_preemption=False, total_steps=1))
    seen = []
    real_step = trainer.train_minibatch
    trainer.train_minibatch = lambda mb: (seen.append(trainer._preemption_guard), real_step(mb))[1]
    trainer.learn()
    assert seen == [None] and signal.getsignal(signal.SIGTERM) is before


@pytest.mark.parametrize("axis", ["data", "fsdp", "tensor", "sequence", "pipeline", "dcn_data"])
def test_parallel_axis_above_one_device_is_refused(tmp_path, axis):
    config = _config(tmp_path, axis).evolve(parallel={axis: 2})
    with pytest.raises(NotImplementedError, match=rf"parallel\.{axis}=2.*ROADMAP queue A, item 4"):
        SFTTrainer(config, device="cpu")


def test_parallel_defaults_and_data_minus_one_are_accepted(tmp_path):
    assert default_sft_config().parallel.data == -1
    trainer = SFTTrainer(_config(tmp_path, "one").evolve(parallel=dict(data=-1, fsdp=1, tensor=1)), device="cpu")
    assert trainer.config.parallel.data == -1
