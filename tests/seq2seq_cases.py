"""Shared cases of the port's seq2seq tests (`tests/test_torch_seq2seq*.py`,
`tests/test_torch_t5_interop.py`): the JAX and port model pairs on one
set of numpy weights, the generation check, and the t5 HF directories
the JAX package's exporter writes. The suite runs with `--dist loadfile`,
which hands out the files with the fewest tests last: the seq2seq cases
sit in files of a few tests each, so they fill the workers that the
large parallelism files leave idle."""

import json
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import torch

from trlx_tpu.models import hf_interop as j_hf
from trlx_tpu.models import seq2seq as j_s2s
from trlx_tpu.ops import sampling as j_sampling
from trlx_tpu_torch.convert import params_from_jax
from trlx_tpu_torch.models import seq2seq as s2s
from trlx_tpu_torch.ops import sampling

V = 300
EOS, PAD = 1, 0
MODELS = {
    "t5-tiny": ("t5-tiny", {}),
    "flan-2+2": ("flan-t5-small", dict(n_encoder_layers=2, n_decoder_layers=2)),
    "t5-v1.0": ("t5-tiny", dict(attention_scale=False, logit_scale=64 ** -0.5)),
}


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64), rtol=tol, atol=tol)


def tensors(*xs):
    return [torch.from_numpy(np.asarray(x)).long() for x in xs]


def batch(seed=0, b=3, s=10, t=7):
    """Encoder rows left padded (row 1 by 3, row 2 by 6), decoder rows
    right padded (row 2 after 4 tokens)."""
    rng = np.random.RandomState(seed)
    enc = rng.randint(2, V, (b, s)).astype(np.int32)
    em = np.ones_like(enc)
    em[1, :3] = em[2, :6] = 0
    enc[em == 0] = PAD
    dec = rng.randint(2, V, (b, t)).astype(np.int32)
    dm = np.ones_like(dec)
    dm[2, 4:] = 0
    return enc, em, dec, dm


def random_params(jm, seed=1):
    """Parameters of the JAX module's tree drawn from a seed with numpy
    (the tree's shapes from `jax.eval_shape`, no init run): kernels and
    embeddings normal with std 1/sqrt(fan-in), norm scales 1 + 0.1 normal,
    biases 0.1 normal."""
    enc, em, dec, dm = batch()
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), enc, em, dec, dm)["params"]
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name = getattr(path[-1], "key", str(path[-1]))
        x = rng.randn(*leaf.shape).astype(np.float32)
        if name == "scale":
            return 1.0 + 0.1 * x
        if name == "bias":
            return 0.1 * x
        return x / np.float32(np.sqrt(leaf.shape[-1] if name == "embedding" else leaf.shape[0]))

    return jax.tree_util.tree_map_with_path(draw, shapes)


def build(name, cls=j_s2s.Seq2SeqLMWithValueHead, tcls=s2s.Seq2SeqLMWithValueHead, **kw):
    """A JAX module, its parameters (`_random_params`) and the port's
    module on them."""
    preset, extra = MODELS[name]
    jcfg = j_s2s.seq2seq_config_from_preset(preset, V, dtype=jnp.float32, **extra)
    tcfg = s2s.seq2seq_config_from_preset(preset, V, dtype=torch.float32, **extra)
    jm = cls(jcfg, **kw)
    params = random_params(jm)
    tm = tcls(tcfg, **kw)
    tm.load_state_dict(params_from_jax(params, tcfg))
    return SimpleNamespace(jm=jm, jcfg=jcfg, params=params, tm=tm.eval(), tcfg=tcfg)


def build_models():
    """Every model of MODELS, value-head wrappers."""
    return {name: build(name) for name in MODELS}


def gen_kwargs(**kw):
    return dict(max_new_tokens=12, eos_token_id=EOS, pad_token_id=PAD, **kw)


def check_generate(jm, params, tm, cfg_j, cfg_t, gen_kw, mode="lm", key=0):
    """The JAX sampler (jitted) and the port's on the same prompts: every
    output key token for token."""
    enc, em, _, _ = batch(6)
    jout = jax.jit(j_sampling.make_generate_fn(jm, cfg_j, j_sampling.GenerationConfig(**gen_kw), mode=mode))(
        params, jnp.asarray(enc), jnp.asarray(em), jax.random.PRNGKey(key))
    tout = sampling.make_generate_fn(tm, cfg_t, sampling.GenerationConfig(**gen_kw), mode=mode)(enc, em, None)
    for k in ("samples", "samples_mask", "response_tokens", "response_mask"):
        np.testing.assert_array_equal(tout[k].numpy(), np.asarray(jout[k]))
    assert (tout["samples"][:, 0] == cfg_t.decoder_start_token_id).all()
    return tout


T5_V = 259  # the byte tokenizer's
LAYOUTS = {
    "t5-v1.0": dict(d_model=32, n_encoder_layers=2, n_decoder_layers=2, n_heads=4, d_ff=64, activation="relu",
                    tie_embeddings=True, attention_scale=False, logit_scale=32 ** -0.5),
    "flan-t5": dict(d_model=32, n_encoder_layers=2, n_decoder_layers=1, n_heads=4, d_kv=16, d_ff=48,
                    activation="gelu", glu=True, tie_embeddings=False, attention_scale=False),
}
S2S = {"model_arch_type": "seq2seq", "model_extra_configs": {"dtype": "float32", "decoder_start_token_id": 256}}


def write_t5_dirs(tmp_path_factory):
    """{layout: directory} of HF t5 checkpoints written by the JAX
    exporter from random numpy weights (LAYOUTS: t5 v1.0 and flan-t5)."""
    tmp = tmp_path_factory.mktemp("t5")
    out = {}
    for i, (name, kw) in enumerate(LAYOUTS.items()):
        cfg = j_s2s.Seq2SeqConfig(vocab_size=T5_V, relative_attention_num_buckets=8,
                                  relative_attention_max_distance=20, hf_family="t5", **kw)
        model = j_s2s.Seq2SeqLM(cfg)
        ids = jnp.zeros((1, 4), jnp.int32)
        shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), ids, ids + 1, ids, ids + 1)["params"]
        rng = np.random.RandomState(10 + i)
        lm = jax.tree_util.tree_map(lambda s: (rng.randn(*s.shape) * 0.3).astype(np.float32), shapes)
        sd = j_hf.params_to_hf_state_dict({"lm": lm}, cfg)
        d = tmp / name
        d.mkdir()
        torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}, d / "pytorch_model.bin")
        (d / "config.json").write_text(json.dumps(j_hf.config_to_hf(cfg)))
        out[name] = str(d)
    return out


