"""The t5 family's HF interop (`models/hf_interop.py`: `config_from_hf`,
`load_params_from_hf`, the export and its config) against the JAX
package, on the directories `seq2seq_cases.write_t5_dirs` writes through
the JAX package's exporter: random weights of a t5 v1.0 layout (relu,
tied, logits scaled by d_model**-0.5) and a flan-t5 layout (gated gelu,
untied head, d_kv apart from d_model / heads). Seq2seq ILQL over them is
`test_torch_seq2seq_ilql.py`.

Tolerances: loads, exports and round trips bitwise; configs equal field
by field.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from seq2seq_cases import LAYOUTS, S2S, T5_V, np_tree, write_t5_dirs
from trlx_tpu.data.configs import ModelConfig as JModelConfig
from trlx_tpu.models import build_model as j_build_model
from trlx_tpu.models import hf_interop as j_hf
from trlx_tpu_torch.convert import params_from_jax
from trlx_tpu_torch.data.configs import ModelConfig
from trlx_tpu_torch.models import build_model, hf_interop

torch.set_num_threads(1)
dirs = pytest.fixture(scope="module")(write_t5_dirs)


def _builds(path, **kw):
    """The JAX package's and the port's value-head builds of `path`."""
    jm, jcfg, jparams = j_build_model(JModelConfig(model_path=path, **S2S), T5_V, **kw)
    tm, tcfg, tstate = build_model(ModelConfig(model_path=path, **S2S), T5_V, device="cpu", **kw)
    return jcfg, jparams, tm, tcfg, tstate


def _fields(cfg):
    return {k: v for k, v in dataclasses.asdict(cfg).items() if k not in ("dtype", "param_dtype")}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_t5_load_matches_jax_bitwise(dirs, layout):
    """The config field by field and every LM tensor bitwise; the value
    head keeps its fresh init on both sides."""
    jcfg, jparams, _, tcfg, tstate = _builds(dirs[layout])
    assert _fields(tcfg) == _fields(jcfg) and tcfg.is_seq2seq and tcfg.hf_family == "t5"
    assert tcfg.logit_scale == (32 ** -0.5 if layout == "t5-v1.0" else None)
    want = params_from_jax(np_tree(jparams), tcfg)
    assert want.keys() == tstate.keys()
    for k, w in want.items():
        if k.startswith("lm."):
            assert torch.equal(tstate[k], w), k


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_t5_export_round_trip(dirs, layout, tmp_path):
    """The port's export of the loaded weights equals the JAX package's
    export of them (tensors and config); written out, it loads back into
    the port and into the JAX package bitwise."""
    jcfg, jparams, tm, tcfg, tstate = _builds(dirs[layout])
    sd = hf_interop.params_to_hf_state_dict(tstate, tcfg)
    want = j_hf.params_to_hf_state_dict(np_tree(jparams), jcfg)
    assert sd.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_array_equal(sd[k], np.asarray(w), err_msg=k)
    assert hf_interop.config_to_hf(tcfg) == j_hf.config_to_hf(jcfg)
    out = tmp_path / "export"
    out.mkdir()
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}, out / "pytorch_model.bin")
    (out / "config.json").write_text(json.dumps(hf_interop.config_to_hf(tcfg)))
    _, jparams2, _, _, tstate2 = _builds(str(out))
    for k, w in params_from_jax(np_tree(jparams2), tcfg).items():
        if k.startswith("lm."):
            assert torch.equal(tstate2[k], tstate[k]) and torch.equal(w, tstate[k]), k


def test_t5_refusals_match_jax(dirs):
    """A t5 directory under the causal arch type, and a gated exact-erf
    GELU's export, raise as the JAX package's do."""
    for mc in (JModelConfig, ModelConfig):
        with pytest.raises(ValueError, match="is a seq2seq model"):
            (j_build_model if mc is JModelConfig else build_model)(mc(model_path=dirs["t5-v1.0"]), T5_V,
                                                                   **({} if mc is JModelConfig else {"device": "cpu"}))
    _, _, _, tcfg, _ = _builds(dirs["flan-t5"])
    bad = dataclasses.replace(tcfg, activation="gelu_exact")
    with pytest.raises(ValueError, match="gated exact-erf"):
        hf_interop.config_to_hf(bad)
