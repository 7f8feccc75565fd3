"""HF load and export of the model families in the port
(`trlx_tpu_torch/models/hf_interop.py`) against the JAX package's
(`trlx_tpu/models/hf_interop.py`): gpt_neox, gptj, opt, bloom,
gpt_bigcode, and Mistral through the llama branch.

A JAX model's parameters (a tiny preset at f32) go through the JAX
package's `params_to_hf_state_dict` and `config_to_hf` into a local
directory (`torch.save` of the state dict). Loading: the port's
`config_from_hf` equals JAX's field by field, and the state it loads by
`model_path` equals `params_from_jax` of the same tree bitwise. Export:
the port's HF state dict equals JAX's bitwise, its `config_to_hf` dict
equals JAX's, and the directory the port writes loads back through JAX's
`load_params_from_hf` bitwise. `save_pretrained` and `model_path`
round-trip every family through a trainer. The refusals (OPT's two,
Bloom's d_ff, GPTBigCode's kv heads) raise as in JAX.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trlx_tpu.data.configs import ModelConfig as JModelConfig
from trlx_tpu.models import build_model as j_build_model
from trlx_tpu.models import hf_interop as j_hf
from trlx_tpu_torch.convert import params_from_jax
from trlx_tpu_torch.data.configs import ModelConfig
from trlx_tpu_torch.data.default_configs import default_sft_config
from trlx_tpu_torch.models import build_model
from trlx_tpu_torch.models import hf_interop
from trlx_tpu_torch.models import transformer as tf
from trlx_tpu_torch.trainer.sft_trainer import SFTTrainer

torch.set_num_threads(1)

V = 259
F32 = {"dtype": "float32"}
FAMILIES = {
    "gpt_neox": ("neox-tiny", {}),
    "gptj": ("gptj-tiny", {}),
    "opt": ("opt-tiny", {}),
    "bloom": ("bloom-tiny", {}),
    "gpt_bigcode": ("bigcode-tiny", {}),
    "mistral": ("llama-tiny", {"sliding_window": 8}),
}


def _write(path, sd, hf_cfg):
    path.mkdir(parents=True, exist_ok=True)
    torch.save({k: torch.from_numpy(np.array(v, np.float32)) for k, v in sd.items()}, path / "pytorch_model.bin")
    (path / "config.json").write_text(json.dumps(hf_cfg))
    return str(path)


@pytest.fixture(scope="module", params=list(FAMILIES))
def family(request, tmp_path_factory):
    """The JAX model's parameters, written to an HF directory by the JAX
    package's exporter."""
    preset, extra = FAMILIES[request.param]
    jmodel, jcfg, jparams = j_build_model(
        JModelConfig(model_path=f"random:{preset}", model_extra_configs=dict(extra, **F32)),
        vocab_size=V, rng=jax.random.PRNGKey(1))
    jparams = jax.tree_util.tree_map(np.asarray, jparams)
    tmp = tmp_path_factory.mktemp(request.param)
    j_sd = j_hf.params_to_hf_state_dict(jparams, jcfg)
    path = _write(tmp / "jax_export", j_sd, j_hf.config_to_hf(jcfg))
    return dict(name=request.param, jcfg=jcfg, jparams=jparams, j_sd=j_sd, path=path, tmp=tmp)


def _common_fields(tcfg):
    return [f.name for f in dataclasses.fields(tcfg) if f.name not in ("dtype", "param_dtype")]


def test_config_from_hf_matches_jax(family):
    tcfg = hf_interop.config_from_hf(family["path"])
    jcfg = j_hf.config_from_hf(family["path"])
    for name in _common_fields(tcfg):
        assert getattr(tcfg, name) == getattr(jcfg, name), name
    assert tcfg.hf_family == ("llama" if family["name"] == "mistral" else family["name"])
    if family["name"] == "mistral":
        assert tcfg.sliding_window == 8


def test_load_by_model_path_is_bitwise_params_from_jax(family):
    model, cfg, sd = build_model(ModelConfig(model_path=family["path"], model_extra_configs=F32), 0, device="cpu")
    want = params_from_jax(family["jparams"], cfg)
    lm = {k: v for k, v in sd.items() if k.startswith("lm.")}
    assert lm.keys() == {k for k in want if k.startswith("lm.")}
    for name, w in lm.items():
        assert torch.equal(w, want[name]), name


def test_export_matches_jax_and_loads_back_into_jax(family):
    jcfg, jparams = family["jcfg"], family["jparams"]
    tcfg = hf_interop.config_from_hf(family["path"], dtype=torch.float32)
    state = params_from_jax(jparams, tcfg)
    t_sd = hf_interop.params_to_hf_state_dict(state, tcfg)
    j_sd = j_hf.params_to_hf_state_dict(jparams, j_hf.config_from_hf(family["path"], dtype=jnp.float32))
    assert t_sd.keys() == j_sd.keys()
    for k in j_sd:
        np.testing.assert_array_equal(t_sd[k], j_sd[k], err_msg=k)
    assert hf_interop.config_to_hf(tcfg) == j_hf.config_to_hf(jcfg)
    path = _write(family["tmp"] / "port_export", t_sd, hf_interop.config_to_hf(tcfg))
    back = j_hf.load_params_from_hf(path, j_hf.config_from_hf(path, dtype=jnp.float32), jparams)
    for (kp, got), (_, want) in zip(jax.tree_util.tree_leaves_with_path(back),
                                    jax.tree_util.tree_leaves_with_path(jparams)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=jax.tree_util.keystr(kp))


def test_infer_family_matches_jax(family):
    preset, extra = FAMILIES[family["name"]]
    tcfg = tf.config_from_preset(preset, vocab_size=V, **extra)
    assert hf_interop.infer_family(tcfg) == j_hf.infer_family(family["jcfg"])
    assert hf_interop.config_to_hf(tcfg) == j_hf.config_to_hf(family["jcfg"])


def test_save_pretrained_round_trips_through_model_path(family):
    """A port trainer's `save_pretrained` export loads back by
    `model_path` to its parameters and logits, bitwise."""
    preset, extra = FAMILIES[family["name"]]
    tmp = family["tmp"]
    cfg = default_sft_config().evolve(
        model=dict(model_path=f"random:{preset}", model_extra_configs=dict(extra, **F32)),
        train=dict(seq_length=32, batch_size=2, checkpoint_dir=str(tmp / "ckpts"), logging_dir=str(tmp / "logs"),
                   tracker=None))
    tr = SFTTrainer(cfg, device="cpu")
    tr.save_pretrained(str(tmp / "port_hf"))
    assert (tmp / "port_hf" / "pytorch_model.bin").exists()
    model, mcfg, sd = build_model(ModelConfig(model_path=str(tmp / "port_hf"), model_extra_configs=F32), 0,
                                  seed=tr.config.train.seed, device="cpu")
    assert mcfg.sliding_window == tr.model_cfg.sliding_window and mcfg.alibi == tr.model_cfg.alibi
    for name, w in tr.model.state_dict().items():
        assert torch.equal(sd[name], w), name
    ids = torch.from_numpy(np.random.RandomState(0).randint(0, 256, (2, 12))).long()
    mask = torch.ones_like(ids, dtype=torch.int32)
    mask[1, :5] = 0
    with torch.no_grad():
        assert torch.equal(model(ids, mask)[0], tr.model(ids, mask)[0])


def test_refusals_match_jax(tmp_path):
    opt = dict(model_type="opt", architectures=["OPTForCausalLM"], vocab_size=V, hidden_size=64,
               num_hidden_layers=2, num_attention_heads=4, ffn_dim=256, max_position_embeddings=64)
    for bad, msg in ((dict(do_layer_norm_before=False), "do_layer_norm_before"),
                     (dict(word_embed_proj_dim=32), "word_embed_proj_dim")):
        d = tmp_path / msg
        d.mkdir()
        (d / "config.json").write_text(json.dumps(dict(opt, **bad)))
        for cfh in (hf_interop.config_from_hf, j_hf.config_from_hf):
            with pytest.raises(ValueError, match=msg):
                cfh(str(d))
    bloom = dict(tf.PRESETS["bloom-tiny"], d_ff=128)
    with pytest.raises(ValueError, match="d_ff == 4"):
        hf_interop.config_to_hf(tf.TransformerConfig(vocab_size=V, **bloom))
    with pytest.raises(ValueError, match="d_ff == 4"):
        j_hf.config_to_hf(j_hf.TransformerConfig(vocab_size=V, **bloom))
    bigcode = dict(tf.PRESETS["bigcode-tiny"], n_kv_heads=2)
    with pytest.raises(ValueError, match="n_kv_heads=2"):
        hf_interop.config_to_hf(tf.TransformerConfig(vocab_size=V, **bigcode), "gpt_bigcode")
    with pytest.raises(ValueError, match="n_kv_heads=2"):
        j_hf.config_to_hf(j_hf.TransformerConfig(vocab_size=V, **bigcode), "gpt_bigcode")
