"""The port's seq2seq frozen reference, trainable mask and cached decode
against the JAX package (`seq2seq_cases.MODELS`, f32): the reference's
copy bitwise, its logits and the policy's 1e-5; JAX's trainable mask;
each cached decode step 1e-5 against JAX's and the forward's column; the
sampler's refusals and ILQL's Q-guided seq2seq sampling token for token.
"""

import jax
import numpy as np
import pytest
import torch

from seq2seq_cases import batch, build, build_models, check_generate, close, gen_kwargs, tensors
from trlx_tpu.models import seq2seq as j_s2s
from trlx_tpu.ops import sampling as j_sampling
from trlx_tpu_torch.convert import params_from_jax
from trlx_tpu_torch.models import seq2seq as s2s
from trlx_tpu_torch.ops import sampling

torch.set_num_threads(1)
models = pytest.fixture(scope="module")(build_models)


@pytest.mark.parametrize("unfrozen", [-1, 0, 1])
def test_hydra_reference_and_trainable_mask_match_jax(models, unfrozen):
    """The reference's copy equals JAX's `seq2seq_ref_param_subtree`
    bitwise, its logits and the policy's match JAX's and each other at
    init; the trainable set is JAX's mask."""
    m = models["flan-2+2"]
    split = {-1: 0, 0: 2, 1: 1}[unfrozen]
    ref = s2s.Seq2SeqHydraReference(m.tm.lm, split)
    want = params_from_jax(j_s2s.seq2seq_ref_param_subtree(m.params, m.jcfg, split))
    assert ref.state_dict().keys() == want.keys()
    for k, w in want.items():
        assert torch.equal(ref.state_dict()[k], w), k
    enc, em, dec, dm = batch(4)
    jref = j_s2s.seq2seq_ref_param_subtree(m.params, m.jcfg, split)
    j_out = jax.jit(lambda p, r, *a: j_s2s.forward_seq2seq_policy_and_ref(m.jm, p, r, *a, split))(
        m.params, jref, enc, em, dec, dm)
    with torch.no_grad():
        t_out = s2s.forward_seq2seq_policy_and_ref(m.tm, ref, *tensors(enc, em, dec, dm))
    for g, w in zip(t_out, j_out):
        close(g.numpy(), w, 1e-5)
    close(t_out[2].numpy(), t_out[0].numpy(), 1e-5)
    jmask = j_s2s.seq2seq_trainable_mask(m.params, m.jcfg, unfrozen)
    as_leaves = params_from_jax(jax.tree_util.tree_map(lambda k, p: np.full(np.shape(p), float(k)), jmask,
                                                       m.params))
    mask = s2s.seq2seq_trainable_mask(m.tm, m.tcfg, unfrozen)
    assert mask == {k: bool(v.reshape(-1)[0]) for k, v in as_leaves.items()}


def test_decode_step_matches_jax_and_the_forward(models):
    """The start token, then teacher-forced tokens one at a time through
    the cache: each step's logits against JAX's decode step and the
    forward's column, 1e-5."""
    m = models["flan-2+2"]
    enc, em, dec, _ = batch(5)
    dec[:, 0] = m.jcfg.decoder_start_token_id
    cls = j_s2s.Seq2SeqLMWithValueHead
    full = jax.jit(lambda p, *a: m.jm.apply({"params": p}, *a)[0])(m.params, enc, em, dec, np.ones_like(dec))
    jcache = jax.jit(lambda p, e, mk: m.jm.apply({"params": p}, m.jm.apply({"params": p}, e, mk, method=cls.encode),
                                                 mk, 8, method=cls.prepare_cache))(m.params, enc, em)
    jstep = jax.jit(lambda p, *a: m.jm.apply({"params": p}, *a, method=cls.decode_step))
    with torch.no_grad():
        tcache = m.tm.prepare_cache(m.tm.encode(*tensors(enc, em)), torch.from_numpy(em), 8)
        for i in range(dec.shape[1]):
            tok, ones = dec[:, i:i + 1], np.ones((3, 1), np.int32)
            jl, _, jcache = jstep(m.params, tok, jcache, ones)
            tok_t, ones_t = tensors(tok, ones)
            tl, _, tcache = m.tm.decode_step(tok_t, tcache, ones_t)
            close(tl.numpy(), jl, 1e-5)
            close(tl[:, 0].numpy(), full[:, i], 1e-5)


def test_q_guided_generate_matches_jax():
    """ILQL's beta * (Q - V) shift over the seq2seq heads, greedy, with the
    decoder-side repetition penalty."""
    m = build("t5-tiny", j_s2s.Seq2SeqLMWithILQLHeads, s2s.Seq2SeqLMWithILQLHeads, two_qs=True)
    check_generate(m.jm, m.params, m.tm, m.jcfg, m.tcfg, gen_kwargs(do_sample=False, beta=2.0, repetition_penalty=1.2),
                   mode="ilql")


def test_sampler_refusals_match_jax(models):
    """Capture and speculative decode sample a causal LM only."""
    m = models["t5-tiny"]
    tgen = sampling.GenerationConfig(**gen_kwargs(do_sample=False))
    jgen = j_sampling.GenerationConfig(**gen_kwargs(do_sample=False))
    for kw in (dict(capture=True), dict(spec_k=2, spec_split=1, spec_draft_head=(0, 0))):
        with pytest.raises(NotImplementedError) as jerr:
            j_sampling.make_generate_fn(m.jm, m.jcfg, jgen, **kw)
        with pytest.raises(NotImplementedError) as terr:
            sampling.make_generate_fn(m.tm, m.tcfg, tgen, **kw)
        assert str(terr.value) == str(jerr.value)
