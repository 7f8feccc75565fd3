"""`SFTTrainer(config, device="cpu").serve()` of the port answers
/healthz and /metrics, and gives the same greedy /generate reply as the
JAX server on the same weights; asking the port for a cuda device where
there is none raises instead of running on the CPU."""

import json
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from trlx_tpu_torch.convert import params_from_jax

# one intra-op thread: the tensors here are tiny, and the suite runs in
# several worker processes at once, which extra threads only slow down
torch.set_num_threads(1)


def _config():
    from trlx_tpu.data.default_configs import default_sft_config

    return default_sft_config().evolve(
        model=dict(model_path="random:llama-tiny", model_extra_configs={"dtype": "float32"}),
        tokenizer=dict(tokenizer_path="byte"),
        train=dict(seq_length=64, total_steps=0, tracker=None, batch_size=2),
        inference=dict(
            kv_paging=True, kv_block_size=8, num_slots=2, max_prompt_len=32,
            max_new_tokens=12, gen_kwargs=dict(do_sample=False),
        ),
    )


def _post(url, payload):
    req = urllib.request.Request(url + "/generate", data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, json.loads(r.read())


def _get(url, path):
    with urllib.request.urlopen(url + path, timeout=60) as r:
        return r.status, r.read().decode()


@pytest.fixture(scope="module")
def servers():
    from trlx_tpu.trainer.sft_trainer import SFTTrainer as JSFTTrainer
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.trainer.sft_trainer import SFTTrainer

    jcfg = _config()
    jtr = JSFTTrainer(jcfg.evolve(inference=dict(decode_kernel="xla")))
    ttr = SFTTrainer(TRLConfig.from_dict(jcfg.to_dict()), device="cpu")
    ttr.model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, jtr.params), ttr.model_cfg))
    jsrv = jtr.serve(port=0, background=True)
    tsrv = ttr.serve(port=0, background=True)
    yield jsrv, tsrv
    tsrv.shutdown()
    jsrv.shutdown()


def test_healthz_and_metrics(servers):
    _, tsrv = servers
    code, body = _get(tsrv.url, "/healthz")
    health = json.loads(body)
    assert code == 200 and health["ready"] and health["slots_total"] == 2
    assert health["kv"]["kv_kernel_fallbacks"] == {}
    code, text = _get(tsrv.url, "/metrics")
    assert code == 200 and "trlx_tpu_inference_" in text


@pytest.mark.parametrize("prompt,max_new", [("Hello, paged world", 12), ("a" * 17, 5), ("x", 9)])
def test_greedy_generate_matches_jax_server(servers, prompt, max_new):
    jsrv, tsrv = servers
    payload = {"prompt": prompt, "max_new_tokens": max_new}
    jcode, jout = _post(jsrv.url, payload)
    tcode, tout = _post(tsrv.url, payload)
    assert jcode == tcode == 200
    assert tout["token_ids"] == jout["token_ids"]
    assert tout["text"] == jout["text"]
    assert tout["finish_reason"] == jout["finish_reason"]
    np.testing.assert_allclose(tout["token_logprobs"], jout["token_logprobs"], rtol=1e-4, atol=1e-4)


def test_not_ported_surface_answers_501(servers):
    """`/admin/adapters` is ported (multi-tenant serving): a single-tenant
    server answers it as the JAX server does, 400 with JAX's message, to
    a POST and a GET."""
    answers = []
    for srv in servers:
        for data in (json.dumps({"load": "a"}).encode(), None):
            req = urllib.request.Request(srv.url + "/admin/adapters", data=data,
                                         headers={"Content-Type": "application/json"})
            with pytest.raises(urllib.error.HTTPError) as err:
                urllib.request.urlopen(req, timeout=60)
            answers.append((err.value.code, json.loads(err.value.read())["error"]))
    assert answers[2:] == answers[:2]
    assert answers[2] == (400, "server is not multi-tenant (start with inference.multi_tenant and an adapter_dir)")


def test_kernel_failure_answers_500_and_stops_serving(monkeypatch):
    """A failing decode kernel (on a card: a sticky CUDA error) fails the
    request with HTTP 500 at once instead of hanging it, and the server
    refuses what comes after."""
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.ops import paged_attention
    from trlx_tpu_torch.trainer.sft_trainer import SFTTrainer

    def broken_kernel(*args, **kwargs):
        raise RuntimeError("paged_decode: CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(paged_attention, "paged_attention_decode", broken_kernel)
    cfg = TRLConfig.from_dict(_config().to_dict()).evolve(inference=dict(decode_kernel="auto"))
    srv = SFTTrainer(cfg, device="cpu").serve(port=0, background=True)
    try:
        for _ in range(2):
            with pytest.raises(urllib.error.HTTPError) as err:
                _post(srv.url, {"prompt": "hi", "max_new_tokens": 4})
            assert err.value.code == 500
            assert "illegal memory access" in err.value.read().decode()
        health = json.loads(_get(srv.url, "/healthz")[1])
        assert not health["ready"]
    finally:
        srv.shutdown()


def test_cuda_request_without_a_card_raises():
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.trainer.sft_trainer import SFTTrainer

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="cuda"):
        SFTTrainer(TRLConfig.from_dict(_config().to_dict()))
