"""The port's encoder-decoder (trlx_tpu_torch/models/seq2seq.py) against
the JAX package on the same numpy inputs and weights (`params_from_jax`):
the relative buckets, the forwards on left-padded encoder rows, the ILQL
heads, `params_from_jax` over both stacks. The models, f32 at vocabulary
300 (`seq2seq_cases.MODELS`): t5-tiny, flan-t5-small's widths cut to 2+2
blocks (gated gelu, an untied head, d_kv 64 over 6 heads) and t5-tiny
with T5 v1.0 numerics (no score scaling, tied logits scaled by
d_model**-0.5). The decode, the reference and the samplers are
`test_torch_seq2seq_decode.py` and `test_torch_seq2seq_generate.py`.

Tolerances: the buckets exactly; forwards and ILQL heads 1e-5 (5e-5 for
the gated-gelu model: the two libraries' f32 tanh-gelu differ in their
last bits, which its gate multiplies).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seq2seq_cases import MODELS, V, batch, build, build_models, close, tensors
from trlx_tpu.models import seq2seq as j_s2s
from trlx_tpu_torch.convert import params_from_jax
from trlx_tpu_torch.models import seq2seq as s2s

torch.set_num_threads(1)
models = pytest.fixture(scope="module")(build_models)


@pytest.mark.parametrize("bidirectional", [True, False])
def test_relative_position_buckets_match_jax_exactly(bidirectional):
    """Every relative position in [-600, 600], at T5's (32, 128) and at
    tables whose boundaries fall elsewhere, directly and through the
    device lookup table."""
    rel = np.arange(-600, 601, dtype=np.int32)
    for nb, md in [(32, 128), (32, 64), (64, 256), (16, 32), (128, 1024), (32, 200)]:
        want = np.asarray(j_s2s.relative_position_bucket(jnp.asarray(rel), bidirectional, nb, md))
        got = s2s.relative_position_bucket(torch.from_numpy(rel), bidirectional, nb, md).numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(s2s._bucket_table(601, bidirectional, nb, md, "cpu").numpy(), want)


@pytest.mark.parametrize("name", list(MODELS))
def test_forward_matches_jax(models, name):
    """Logits, values, the decoder's activation at split 1 and the
    encoder's output on left-padded encoder rows, 1e-5."""
    m = models[name]
    enc, em, dec, dm = batch(2)
    want = jax.jit(lambda p, *a: m.jm.apply({"params": p}, *a, 1))(m.params, enc, em, dec, dm)
    with torch.no_grad():
        got = m.tm(*tensors(enc, em, dec, dm), 1)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        close(g.numpy(), w, 5e-5 if m.tcfg.glu else 1e-5)


def test_ilql_heads_forward_matches_jax():
    m = build("t5-tiny", j_s2s.Seq2SeqLMWithILQLHeads, s2s.Seq2SeqLMWithILQLHeads, two_qs=True)
    enc, em, dec, dm = batch(3)
    states = np.asarray([[0, 1, 2, 3], [0, 2, 4, 5], [1, 2, 3, 3]], np.int32)
    actions = states[:, :3]
    want = jax.jit(lambda p, *a: m.jm.apply({"params": p}, *a))(m.params, enc, em, dec, dm, states, actions)
    with torch.no_grad():
        got = m.tm(*tensors(enc, em, dec, dm, states, actions))
    for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        close(g.numpy(), w, 1e-5)


def test_params_from_jax_checks_both_stacks(models):
    m = models["t5-tiny"]
    state = params_from_jax(m.params, m.tcfg)
    assert "lm.enc_rel_bias.embedding.weight" in state and "lm.dec_block_1.cross_attn.q_proj.weight" in state
    torch.testing.assert_close(state["lm.dec_block_0.cross_attn.k_proj.weight"],
                               torch.from_numpy(np.ascontiguousarray(
                                   m.params["lm"]["dec_block_0"]["cross_attn"]["k_proj"]["kernel"].T)))
    flan = models["flan-2+2"]
    assert "lm.lm_head.weight" in params_from_jax(flan.params, flan.tcfg)
    with pytest.raises(ValueError, match="dec_block"):
        params_from_jax(m.params, s2s.seq2seq_config_from_preset("t5-tiny", V, n_decoder_layers=3))
    with pytest.raises(ValueError, match="enc_block"):
        params_from_jax(m.params, s2s.seq2seq_config_from_preset("t5-tiny", V, n_encoder_layers=1))
