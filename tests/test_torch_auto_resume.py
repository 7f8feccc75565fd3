"""`train.auto_resume` and the policy server's SIGTERM drain in the port.

- `_resolve_resume_checkpoint` picks the same directory as the JAX
  trainer's over one checkpoint tree (an explicit path wins; otherwise
  the newest manifest-complete checkpoint, a truncated one giving way to
  the previous valid one, `best_checkpoint` left out);
- a sentinel-guarded PPO run preempted by `FaultInjector.deliver_signal`
  exits 75, and a new trainer with `auto_resume` and no explicit path
  continues from its `_preempt` checkpoint to the parameters, optimizer
  state and sentinel ladder of an uninterrupted run, bit for bit;
- a `serve_policy` process under SIGTERM answers its in-flight requests
  in full, answers new ones 503, and exits 0.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from trlx_tpu import resilience as j_resilience
from trlx_tpu.trainer.base_trainer import TPUTrainer
from trlx_tpu_torch import resilience
from trlx_tpu_torch.data.default_configs import default_ppo_config
from trlx_tpu_torch.pipeline.offline_pipeline import PromptPipeline
from trlx_tpu_torch.trainer.base_trainer import TorchTrainer
from trlx_tpu_torch.trainer.ppo_trainer import PPOTrainer

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# The choice of checkpoint, against the JAX trainer's
# ---------------------------------------------------------------------------


def _tree(root):
    """checkpoint_1 and _3 valid, checkpoint_5 truncated (no manifest), a
    `_preempt` one at step 4, a newer best_checkpoint at step 9."""
    for name, step in [("checkpoint_1", 1), ("checkpoint_3", 3), ("checkpoint_4_preempt", 4),
                       ("checkpoint_5", 5), ("best_checkpoint", 9)]:
        d = os.path.join(root, name)
        os.makedirs(d)
        with open(os.path.join(d, "state.pt"), "w") as f:
            f.write("x")
        j_resilience.write_manifest(d, step=step)
        time.sleep(0.002)  # distinct wall times
    j_resilience.FaultInjector.truncate_checkpoint(os.path.join(root, "checkpoint_5"))


@pytest.mark.parametrize("case", ["auto", "explicit", "missing_explicit", "off", "empty_dir"])
def test_resolve_resume_checkpoint_matches_jax(tmp_path, case):
    root = str(tmp_path / "ckpts")
    _tree(root)
    train = dict(checkpoint_dir=root, auto_resume=True, resume_from_checkpoint=None)
    if case == "explicit":
        train["resume_from_checkpoint"] = os.path.join(root, "checkpoint_1")
    elif case == "missing_explicit":
        train["resume_from_checkpoint"] = os.path.join(root, "nowhere")
    elif case == "off":
        train["auto_resume"] = False
    elif case == "empty_dir":
        train["checkpoint_dir"] = str(tmp_path / "empty")
    fake = types.SimpleNamespace(config=types.SimpleNamespace(train=types.SimpleNamespace(**train)))
    ours = TorchTrainer._resolve_resume_checkpoint(fake)
    theirs = TPUTrainer._resolve_resume_checkpoint(fake)
    assert ours == theirs
    want = {"auto": "checkpoint_4_preempt", "explicit": "checkpoint_1", "missing_explicit": "checkpoint_4_preempt",
            "off": None, "empty_dir": None}[case]
    assert (ours and os.path.basename(ours)) == want


# ---------------------------------------------------------------------------
# Preempted, then auto-resumed, against an uninterrupted run
# ---------------------------------------------------------------------------


def reward_fn(samples, prompts, outputs, **kw):
    return [sum(c.islower() or c == " " for c in o) / max(len(o), 1) + 0.01 * len(p)
            for p, o in zip(prompts, outputs)]


def _trainer(tmp, side, **train):
    base = dict(seq_length=48, batch_size=4, epochs=3, total_steps=10, eval_interval=1000,
                checkpoint_interval=1000, seed=7, checkpoint_dir=str(tmp / side / "ckpts"),
                logging_dir=str(tmp / side / "logs"), sentinel=True, sentinel_good_steps=2,
                sentinel_pin_interval=2, sentinel_warmup=2)
    base.update(train)
    cfg = default_ppo_config().evolve(
        train=base,
        model=dict(model_path="random:gpt2-tiny", num_layers_unfrozen=1,
                   model_extra_configs={"attn_impl": "flash", "dtype": "float32"}),
        method=dict(num_rollouts=8, chunk_size=8, ppo_epochs=2, init_kl_coef=0.05,
                    gen_kwargs=dict(max_new_tokens=8, do_sample=True)),
    )
    t = PPOTrainer(cfg, reward_fn=reward_fn, stop_sequences=["�"], device="cpu")
    rng = np.random.RandomState(1)
    prompts = ["".join(chr(97 + c) for c in rng.randint(0, 26, rng.randint(2, 14))) for _ in range(12)]
    t.add_prompt_pipeline(PromptPipeline(prompts, 40, t.tokenizer))
    t.add_eval_pipeline(PromptPipeline(prompts[:4], 40, t.tokenizer))
    return t


def test_preempted_run_exits_75_and_auto_resume_continues_bitwise(tmp_path):
    preempted = _trainer(tmp_path, "run")
    real_step = preempted.train_minibatch

    def step_then_signal(minibatch):  # SIGTERM arrives during step 6
        stats = real_step(minibatch)
        if preempted.iter_count == 5:
            if threading.current_thread() is threading.main_thread():
                resilience.FaultInjector.deliver_signal(signal.SIGTERM)
            else:  # no OS handler off the main thread: call the guard's
                preempted._preemption_guard.handler(signal.SIGTERM, None)
        return stats

    preempted.train_minibatch = step_then_signal
    with pytest.raises(SystemExit) as exit_info:
        preempted.learn()
    assert exit_info.value.code == resilience.PREEMPTION_EXIT_CODE == 75
    assert preempted.iter_count == 6

    resumed = _trainer(tmp_path, "run", auto_resume=True)  # the same checkpoint_dir, no explicit path
    loaded = []
    real_load = resumed.load
    resumed.load = lambda path: (loaded.append(os.path.basename(path)), real_load(path))[1]
    resumed.learn()
    assert loaded == ["checkpoint_06_preempt"]
    full = _trainer(tmp_path, "full")
    full.learn()
    assert resumed.iter_count == full.iter_count == 10
    for (name, a), b in zip(full.model.state_dict().items(), resumed.model.state_dict().values()):
        assert torch.equal(a, b), name
    for a, b in zip(full.optimizer.state_dict()["state"].values(), resumed.optimizer.state_dict()["state"].values()):
        assert all(torch.equal(a[k], b[k]) for k in a)
    # the ladder continues exactly; the pin may fall on other steps, since
    # a preemption leaves at its step boundary before that step's pin (as
    # the JAX trainer's does)
    pins = ("last_good", "last_pin_step")
    assert {k: v for k, v in full._sentinel.state_dict().items() if k not in pins} == \
        {k: v for k, v in resumed._sentinel.state_dict().items() if k not in pins}


# ---------------------------------------------------------------------------
# The policy server's drain under SIGTERM
# ---------------------------------------------------------------------------


def _free_port():
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _post(url, payload, timeout=60.0):
    req = urllib.request.Request(url + "/generate", data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def test_serve_policy_drains_in_flight_requests_on_sigterm_and_exits_0(tmp_path):
    port = _free_port()
    max_new = 160
    hparams = {"checkpoint": "random:gpt2-tiny", "device": "cpu", "port": port, "train.seed": 3,
               "inference.max_prompt_len": 32, "inference.max_new_tokens": max_new, "inference.num_slots": 8,
               "inference.gen_kwargs": {"max_new_tokens": max_new, "min_new_tokens": max_new}}
    log = open(tmp_path / "serve.log", "w")
    proc = subprocess.Popen([sys.executable, "-m", "trlx_tpu_torch.inference.serve_policy", json.dumps(hparams)],
                            cwd=REPO, stdout=log, stderr=subprocess.STDOUT)
    url = f"http://127.0.0.1:{port}"
    try:
        deadline = time.time() + 60
        while True:
            try:
                with urllib.request.urlopen(url + "/healthz", timeout=1.0) as r:
                    if json.loads(r.read()).get("ready"):
                        break
            except (urllib.error.URLError, ConnectionError, OSError):
                pass
            assert proc.poll() is None and time.time() < deadline, (tmp_path / "serve.log").read_text()
            time.sleep(0.1)
        replies = [None] * 8

        def one(i):
            replies[i] = _post(url, {"prompt_ids": [72, 105, 32 + i], "max_new_tokens": max_new})

        threads = [threading.Thread(target=one, args=(i,)) for i in range(8)]
        for th in threads:
            th.start()
        deadline = time.time() + 30
        while True:  # all 8 admitted and decoding
            with urllib.request.urlopen(url + "/healthz", timeout=5.0) as r:
                if json.loads(r.read()).get("slots_active", 0) >= 8:
                    break
            assert time.time() < deadline
            time.sleep(0.01)
        proc.send_signal(signal.SIGTERM)
        time.sleep(0.05)
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(url, {"prompt_ids": [72], "max_new_tokens": 4}, timeout=10.0)
        assert err.value.code == 503 and err.value.headers.get("Retry-After")
        for th in threads:
            th.join(timeout=60)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
        log.close()
    for status, body in replies:
        assert status == 200 and len(body["token_ids"]) == max_new and body["finish_reason"] != "shutdown"
