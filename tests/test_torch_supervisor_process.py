"""The policy server process as a supervised `SubprocessReplica`, the case
of `test_torch_supervisor.py` moved to a file of its own (the suite's
`--dist loadfile` hands out the files with the fewest tests last, so
this heavy one fills a worker the parallelism files leave idle): the
process serves, is killed, and is respawned by the supervisor."""

import json
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest
import torch

from trlx_tpu_torch import resilience
from trlx_tpu_torch.inference.supervisor import (
    QUARANTINED,
    SERVING,
    FleetSupervisor,
    ReplicaHandle,
    SubprocessReplica,
    ThreadReplica,
    serve_policy_command,
)
from test_torch_supervisor import (  # the cases' helpers, shared with test_torch_supervisor.py
    REPO,
    _make,
    _tick_until,
)

torch.set_num_threads(1)


def test_subprocess_replica_of_serve_policy_respawns(tmp_path):
    """`serve_policy_command` under the supervisor: the process answers
    /healthz and /generate on the CPU; killed, it is respawned."""
    from trlx_tpu_torch.inference import remote_generate

    cmd = serve_policy_command("random:gpt2-tiny", device="cpu", **{"inference.max_new_tokens": 4,
                                                                     "inference.max_prompt_len": 64,
                                                                     "train.seed": 3})
    factory = lambda i: SubprocessReplica(cmd, log_path=str(tmp_path / f"replica{i}.log"), cwd=str(REPO),
                                          stop_grace_s=5.0)
    sup = _make(n=1, factory=factory, probe_interval_s=0.1, start_timeout_s=10.0)
    try:
        _tick_until(sup, lambda: sup.healthy_active() == 1, timeout_s=10.0, msg="the process serving")
        first = remote_generate(sup.seats[0].url)([72, 105], max_new_tokens=4)["token_ids"]
        pid = sup.seats[0].handle.proc.pid
        sup.seats[0].handle.kill()
        _tick_until(sup, lambda: sup.counters["deaths"] == 1, msg="death detected")
        _tick_until(sup, lambda: sup.healthy_active() == 1, timeout_s=10.0, msg="respawned")
        assert sup.seats[0].handle.proc.pid != pid
        again = remote_generate(sup.seats[0].url)([72, 105], max_new_tokens=4)["token_ids"]
        assert again == first  # the same seed, the same weights
    finally:
        sup.stop()
    assert sup.seats[0].handle.proc.poll() is not None
