"""Loading a local HF checkpoint directory in the port
(`models/hf_interop.py`: `config_from_hf`, `load_params_from_hf` and the
`model_path` dispatch of `build_model`) for the gpt2 and llama families,
against the JAX package: its trainers' `save_pretrained` exports load into
the port, the port's exports load into the JAX package, and the port's
own export round-trips.

Models are gpt2-tiny and llama-tiny (llama with its untied head and
grouped KV heads) at f32. Tolerances: logits across packages 1e-5 (f32,
the same expressions); the port's own round trip bitwise (parameters and
logits); the sharded and safetensors layouts bitwise the single file's.
"""

import json
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trlx_tpu.data.configs import ModelConfig as JModelConfig
from trlx_tpu.data.default_configs import default_sft_config as j_default_sft_config
from trlx_tpu.models import build_model as j_build_model
from trlx_tpu.trainer.sft_trainer import SFTTrainer as JSFTTrainer
from trlx_tpu_torch.data.configs import ModelConfig
from trlx_tpu_torch.data.default_configs import default_sft_config
from trlx_tpu_torch.models import build_model, resolve_transformer_config
from trlx_tpu_torch.models import hf_interop
from trlx_tpu_torch.trainer.sft_trainer import SFTTrainer

torch.set_num_threads(1)

F32 = {"dtype": "float32"}
TOL = dict(rtol=1e-5, atol=1e-5)


def _tokens():
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 256, (3, 10)).astype(np.int32)
    mask = (np.arange(10)[None, :] >= np.asarray([0, 4, 9])[:, None]).astype(np.int32)
    return ids, mask


def _port_logits(model, ids, mask):
    with torch.no_grad():
        return model(torch.from_numpy(ids).long(), torch.from_numpy(mask))[0]


def _jax_logits(model, params, ids, mask):
    return np.asarray(model.apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask))[0])


def _sft_config(make, preset, tmp):
    return make().evolve(model=dict(model_path=f"random:{preset}", model_extra_configs=F32),
                         train=dict(seq_length=32, batch_size=2, checkpoint_dir=str(tmp / "ckpts"),
                                    logging_dir=str(tmp / "logs"), tracker=None))


@pytest.fixture(scope="module", params=["gpt2-tiny", "llama-tiny"])
def exports(request, tmp_path_factory):
    """A JAX SFTTrainer's export and a port SFTTrainer's export of one
    preset (different random weights)."""
    tmp = tmp_path_factory.mktemp(request.param)
    jt = JSFTTrainer(_sft_config(j_default_sft_config, request.param, tmp / "jax"), devices=jax.devices()[:1])
    jt.save_pretrained(str(tmp / "jax_hf"))
    tt = SFTTrainer(_sft_config(default_sft_config, request.param, tmp / "torch"), device="cpu")
    tt.save_pretrained(str(tmp / "torch_hf"))
    return dict(preset=request.param, jt=jt, tt=tt, jax_dir=tmp / "jax_hf", torch_dir=tmp / "torch_hf", tmp=tmp)


def test_jax_export_loads_into_the_port(exports):
    jt = exports["jt"]
    model, cfg, sd = build_model(ModelConfig(model_path=str(exports["jax_dir"]), model_extra_configs=F32), 0,
                                 device="cpu")
    assert cfg.hf_family == exports["preset"].split("-")[0] and cfg.dtype == torch.float32
    assert cfg.vocab_size == jt.model_cfg.vocab_size and cfg.n_layers == jt.model_cfg.n_layers
    if cfg.hf_family == "llama":
        assert not cfg.tie_embeddings and cfg.kv_heads < cfg.n_heads and "lm.lm_head.weight" in sd
    ids, mask = _tokens()
    valid = mask.astype(bool)
    np.testing.assert_allclose(_port_logits(model, ids, mask).numpy()[valid],
                               _jax_logits(jt.model, jt.params, ids, mask)[valid], **TOL)


def test_port_export_round_trips_bitwise(exports):
    tt = exports["tt"]
    model, cfg, sd = build_model(ModelConfig(model_path=str(exports["torch_dir"]), model_extra_configs=F32), 0,
                                 seed=tt.config.train.seed, device="cpu")
    want = tt.model.state_dict()
    for name, w in sd.items():
        if name.startswith("lm."):
            assert torch.equal(w, want[name]), name
    # the value head is not in an HF export: it keeps the fresh init of the
    # trainer's seed
    assert torch.equal(sd["v_head.dense_out.weight"], want["v_head.dense_out.weight"])
    ids, mask = _tokens()
    assert torch.equal(_port_logits(model, ids, mask), _port_logits(tt.model, ids, mask))


def test_jax_package_loads_the_port_export(exports):
    tt = exports["tt"]
    jmodel, _, jparams = j_build_model(JModelConfig(model_path=str(exports["torch_dir"]), model_extra_configs=F32),
                                       vocab_size=0, rng=jax.random.PRNGKey(0))
    ids, mask = _tokens()
    valid = mask.astype(bool)
    np.testing.assert_allclose(_port_logits(tt.model, ids, mask).numpy()[valid],
                               _jax_logits(jmodel, jparams, ids, mask)[valid], **TOL)


def test_sharded_and_safetensors_layouts_load_bitwise(exports, tmp_path):
    """The sharded `pytorch_model.bin` index and `model.safetensors` hold
    the same tensors: both load to the single file's state dict."""
    src = exports["torch_dir"]
    full = torch.load(src / "pytorch_model.bin", weights_only=True)
    names = sorted(full)
    sharded = tmp_path / "sharded"
    sharded.mkdir()
    shutil.copy(src / "config.json", sharded)
    index = {}
    for i, part in enumerate((names[: len(names) // 2], names[len(names) // 2:])):
        fname = f"pytorch_model-0000{i + 1}-of-00002.bin"
        torch.save({k: full[k] for k in part}, sharded / fname)
        index.update({k: fname for k in part})
    (sharded / "pytorch_model.bin.index.json").write_text(json.dumps({"weight_map": index}))
    st = tmp_path / "st"
    st.mkdir()
    shutil.copy(src / "config.json", st)
    from safetensors.torch import save_file

    save_file({k: v.clone() for k, v in full.items()}, str(st / "model.safetensors"))
    want = build_model(ModelConfig(model_path=str(src), model_extra_configs=F32), 0, device="cpu")[2]
    for d in (sharded, st):
        got = build_model(ModelConfig(model_path=str(d), model_extra_configs=F32), 0, device="cpu")[2]
        for name, w in want.items():
            assert torch.equal(got[name], w), (d.name, name)


def test_train_starts_from_a_local_directory(exports):
    """`train(samples=...)` with `model_path=<dir>` starts from the
    directory's weights."""
    import trlx_tpu_torch

    tmp = exports["tmp"] / "train"
    cfg = _sft_config(default_sft_config, exports["preset"], tmp).evolve(
        model=dict(model_path=str(exports["torch_dir"])),
        train=dict(epochs=1, total_steps=1, eval_interval=1000, checkpoint_interval=1000),
        method=dict(gen_kwargs=dict(max_new_tokens=4, do_sample=False)))
    start = {}

    def record(self):
        start.update({k: v.clone() for k, v in self.model.state_dict().items()})
        return orig(self)

    orig = SFTTrainer.prepare_learning
    SFTTrainer.prepare_learning = record
    try:
        tr = trlx_tpu_torch.train(samples=["abc", "defg"], config=cfg, device="cpu")
    finally:
        SFTTrainer.prepare_learning = orig
    assert tr.iter_count == 1 and tr.model_cfg.hf_family == exports["preset"].split("-")[0]
    for name, w in exports["tt"].model.state_dict().items():
        if name.startswith("lm."):
            assert torch.equal(start[name], w), name


def _write_config(d, **hf):
    d.mkdir(parents=True, exist_ok=True)
    (d / "config.json").write_text(json.dumps(hf))
    return str(d)


def test_refusals(exports, tmp_path, monkeypatch):
    """A t5 directory under the causal arch type raises as JAX's does (t5
    loads under "seq2seq" since the encoder-decoder ported; gpt_neox and
    opt since the model families did); an unknown architecture, a
    directory without config.json or without weights, and safetensors
    where the package does not import each raise, naming the cause."""
    neox = dict(model_type="gpt_neox", vocab_size=64, hidden_size=32, num_hidden_layers=1, num_attention_heads=4,
                intermediate_size=64, max_position_embeddings=32)
    opt = dict(model_type="opt", vocab_size=64, hidden_size=32, num_hidden_layers=1, num_attention_heads=4,
               ffn_dim=64, max_position_embeddings=32)
    for mt, hf in (("gpt_neox", neox), ("opt", opt)):
        cfg = resolve_transformer_config(ModelConfig(model_path=_write_config(tmp_path / mt, **hf)), 0)
        assert cfg.hf_family == mt
    t5 = _write_config(tmp_path / "t5", model_type="t5", vocab_size=64, d_model=32, d_kv=8, d_ff=64, num_layers=1,
                       num_heads=4)
    with pytest.raises(ValueError, match="is a seq2seq model"):
        resolve_transformer_config(ModelConfig(model_path=t5), 0)
    assert resolve_transformer_config(ModelConfig(model_path=t5, model_arch_type="seq2seq"), 0).is_seq2seq
    with pytest.raises(ValueError, match="Unsupported HF architecture"):
        hf_interop.config_from_hf(_write_config(tmp_path / "x", model_type="mamba"))
    with pytest.raises(FileNotFoundError, match="config.json"):
        build_model(ModelConfig(model_path=str(tmp_path / "nothing")), 0, device="cpu")
    empty = tmp_path / "no_weights"
    empty.mkdir()
    shutil.copy(exports["torch_dir"] / "config.json", empty)
    with pytest.raises(FileNotFoundError, match="No model weights"):
        build_model(ModelConfig(model_path=str(empty)), 0, device="cpu")
    (empty / "model.safetensors").write_bytes(b"")
    monkeypatch.setitem(sys.modules, "safetensors.torch", None)
    with pytest.raises(NotImplementedError, match=os.path.join("no_weights", "model.safetensors")):
        build_model(ModelConfig(model_path=str(empty)), 0, device="cpu")
