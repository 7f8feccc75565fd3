"""The port's beam sampler (`trlx_tpu_torch/ops/beam_search.py`) against
the JAX package's `make_beam_generate_fn` on the same weights (carried by
`params_from_jax`) and the same left-padded prompts, at f32 on the CPU.

Deterministic beam search is held token for token (and mask for mask)
over beam widths 2 and 4, length penalties 1.0 and 0.6, `min_new_tokens`,
rows that hit EOS (the model's favourite token taken as EOS) and, under a
negative length penalty, winners from the finished store, gpt2-tiny and
llama-tiny (GQA). Beam-sample is held token for token too: the port's
one noise draw (`beam_search.beam_gumbel`) is replaced by JAX's own
`gumbel(fold_in(rng, step), shape)`. The `num_beams > 1` refusals raise
where JAX's do. No tolerance: every comparison is exact.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trlx_tpu.data.configs import ModelConfig as JModelConfig
from trlx_tpu.models import build_model as j_build_model
from trlx_tpu.ops import sampling as j_sampling
from trlx_tpu_torch.convert import params_from_jax
from trlx_tpu_torch.data.configs import ModelConfig
from trlx_tpu_torch.models import build_model
from trlx_tpu_torch.ops import beam_search, sampling

torch.set_num_threads(1)

V, EOS, PAD = 24, 23, 22


@pytest.fixture(scope="module", params=["gpt2-tiny", "llama-tiny"])
def pair(request):
    extra = {"dtype": "float32"}
    jmodel, jcfg, jparams = j_build_model(
        JModelConfig(model_path=f"random:{request.param}", model_extra_configs=extra),
        vocab_size=V, rng=jax.random.PRNGKey(3),
    )
    tmodel, tcfg, _ = build_model(ModelConfig(model_path=f"random:{request.param}", model_extra_configs=extra),
                                  vocab_size=V, device="cpu")
    tmodel.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), tcfg))
    return SimpleNamespace(jmodel=jmodel, jcfg=jcfg, jparams=jparams, tmodel=tmodel, tcfg=tcfg)


def _prompts(seed=0, b=3, p=6):
    """Left-padded prompt rows of lengths p, p - 2 and p - 4."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, EOS - 1, (b, p)).astype(np.int32)
    mask = np.ones((b, p), np.int32)
    for r in range(b):
        mask[r, :2 * r] = 0
        ids[r, :2 * r] = PAD
    return ids, mask


def _both(pair, seed=0, **gen):
    kw = dict(eos_token_id=EOS, pad_token_id=PAD, **gen)
    jfn = j_sampling.make_generate_fn(pair.jmodel, pair.jcfg, j_sampling.GenerationConfig(**kw))
    tfn = sampling.make_generate_fn(pair.tmodel, pair.tcfg, sampling.GenerationConfig(**kw))
    ids, mask = _prompts(seed)
    jout = jfn(pair.jparams, jnp.asarray(ids), jnp.asarray(mask), jax.random.PRNGKey(seed))
    tout = tfn(ids, mask, torch.Generator().manual_seed(seed))
    return jout, tout


def _equal(jout, tout):
    for key in ("samples", "samples_mask", "response_tokens", "response_mask"):
        np.testing.assert_array_equal(tout[key].numpy(), np.asarray(jout[key]), err_msg=key)


@pytest.mark.parametrize("beams,length_penalty,min_new,max_new", [
    (2, 1.0, 0, 10),
    (4, 1.0, 0, 12),
    (4, 0.6, 3, 12),
    (2, 0.6, 6, 8),
])
def test_beam_search_matches_jax(pair, beams, length_penalty, min_new, max_new):
    jout, tout = _both(pair, num_beams=beams, length_penalty=length_penalty, min_new_tokens=min_new,
                       max_new_tokens=max_new, do_sample=False)
    _equal(jout, tout)


@pytest.mark.parametrize("length_penalty", [1.0, -1.0])
def test_beams_hit_eos_and_bank_hypotheses(pair, length_penalty):
    """EOS is the token the model likes best after the prompts, so EOS
    candidates are banked from the first steps; at length penalty 1.0
    they compete with the live pool, and the negative one (favouring short
    hypotheses) makes the winners come from the finished store."""
    ids, mask = _prompts(1)
    with torch.no_grad():
        logits = pair.tmodel(torch.from_numpy(ids).long(), torch.from_numpy(mask))[0][:, -1]
    eos = int(torch.log_softmax(logits, -1).mean(0)[:PAD].argmax())
    kw = dict(eos_token_id=eos, pad_token_id=PAD, num_beams=4, max_new_tokens=16, length_penalty=length_penalty,
              do_sample=False)
    jfn = j_sampling.make_generate_fn(pair.jmodel, pair.jcfg, j_sampling.GenerationConfig(**kw))
    tfn = sampling.make_generate_fn(pair.tmodel, pair.tcfg, sampling.GenerationConfig(**kw))
    tout = tfn(ids, mask, None)
    _equal(jfn(pair.jparams, jnp.asarray(ids), jnp.asarray(mask), jax.random.PRNGKey(0)), tout)
    if length_penalty < 0:
        assert (tout["response_mask"].numpy().sum(1) < 16).all()


@pytest.mark.parametrize("warps", [dict(temperature=1.7), dict(temperature=2.0, top_k=10, top_p=0.9)])
def test_beam_sample_matches_jax_with_its_noise(pair, monkeypatch, warps):
    """Beam-sample with the port's noise draw replaced by JAX's own
    Gumbel draws at `fold_in(rng, step)`: the same hypotheses."""
    key = jax.random.PRNGKey(11)

    def jax_gumbel(generator, step, shape, device):
        g = jax.random.gumbel(jax.random.fold_in(key, step), tuple(shape))
        return torch.from_numpy(np.array(g, np.float32)).to(device)

    monkeypatch.setattr(beam_search, "beam_gumbel", jax_gumbel)
    kw = dict(eos_token_id=EOS, pad_token_id=PAD, num_beams=3, max_new_tokens=8, do_sample=True, **warps)
    jfn = j_sampling.make_generate_fn(pair.jmodel, pair.jcfg, j_sampling.GenerationConfig(**kw))
    tfn = sampling.make_generate_fn(pair.tmodel, pair.tcfg, sampling.GenerationConfig(**kw))
    ids, mask = _prompts(2)
    _equal(jfn(pair.jparams, jnp.asarray(ids), jnp.asarray(mask), key), tfn(ids, mask, None))


def test_beam_sample_is_repeatable_and_draws(pair):
    """The port's own draws: the same generator seed gives the same
    hypotheses, and other seeds move them at a hot temperature."""
    kw = dict(eos_token_id=EOS, pad_token_id=PAD, num_beams=3, max_new_tokens=8, do_sample=True, temperature=3.0)
    fn = sampling.make_generate_fn(pair.tmodel, pair.tcfg, sampling.GenerationConfig(**kw))
    ids, mask = _prompts(3)
    outs = [fn(ids, mask, torch.Generator().manual_seed(s))["response_tokens"] for s in (0, 0, 1, 2, 3)]
    assert torch.equal(outs[0], outs[1])
    assert any(not torch.equal(outs[0], o) for o in outs[2:])


REFUSED = [
    (dict(), dict(mode="ilql")),
    (dict(), dict(logit_mask=np.zeros((V, V), bool))),
    (dict(suppress_tokens=(5,)), dict()),
    (dict(repetition_penalty=1.2), dict()),
    (dict(do_sample=False, top_k=5), dict()),
    (dict(do_sample=False, temperature=0.7), dict()),
    (dict(do_sample=False, top_p=0.9), dict()),
    (dict(do_sample=False), dict(capture=True)),
]


@pytest.mark.parametrize("gen,call", REFUSED)
def test_beam_refusals_match_jax(pair, gen, call):
    kw = dict(eos_token_id=EOS, pad_token_id=PAD, num_beams=2, max_new_tokens=4, **gen)
    with pytest.raises(NotImplementedError) as jerr:
        j_sampling.make_generate_fn(pair.jmodel, pair.jcfg, j_sampling.GenerationConfig(**kw), **call)
    with pytest.raises(NotImplementedError) as terr:
        sampling.make_generate_fn(pair.tmodel, pair.tcfg, sampling.GenerationConfig(**kw), **call)
    assert str(terr.value) == str(jerr.value)


def test_speculative_beams_and_seq2seq_beams_are_refused(pair):
    gen = sampling.GenerationConfig(eos_token_id=EOS, pad_token_id=PAD, num_beams=2, max_new_tokens=4)
    with pytest.raises(NotImplementedError, match="single-beam"):
        sampling.make_generate_fn(pair.tmodel, pair.tcfg, gen, spec_k=2, spec_split=1, spec_draft_head=(0, 0))
    # seq2seq beams run (tests/test_torch_seq2seq.py); the capture stays
    # causal-only, as in the JAX sampler
    seq2seq = SimpleNamespace(is_seq2seq=True)
    with pytest.raises(NotImplementedError, match="single-beam causal LM"):
        sampling.make_generate_fn(pair.tmodel, seq2seq, gen, capture=True)
