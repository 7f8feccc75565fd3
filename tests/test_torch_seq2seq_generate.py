"""The port's `generate_seq2seq` (ops/sampling.py) and its beams
(ops/beam_search.py) against the JAX package's samplers
(`seq2seq_cases.MODELS`, f32): greedy with the decoder-side repetition
penalty, min_new_tokens and top-k; beam search over encoder rows
expanded per beam; beam-sample with the port's noise replaced by JAX's
Gumbel draws. Every output token for token.
"""

import jax
import numpy as np
import pytest
import torch

from seq2seq_cases import build_models, check_generate, gen_kwargs
from trlx_tpu_torch.ops import beam_search

torch.set_num_threads(1)
models = pytest.fixture(scope="module")(build_models)


@pytest.mark.parametrize("name,gen", [
    ("t5-tiny", dict(do_sample=False)),
    ("flan-2+2", dict(do_sample=False, repetition_penalty=1.3, min_new_tokens=3)),
    ("t5-v1.0", dict(do_sample=False, top_k=5)),
])
def test_greedy_generate_matches_jax(models, name, gen):
    m = models[name]
    check_generate(m.jm, m.params, m.tm, m.jcfg, m.tcfg, gen_kwargs(**gen))


@pytest.mark.parametrize("name,beams,lp", [("t5-tiny", 2, 1.0), ("flan-2+2", 4, 0.6)])
def test_beam_generate_matches_jax(models, name, beams, lp):
    """Beam search over encoder rows expanded per beam, row for row."""
    m = models[name]
    out = check_generate(m.jm, m.params, m.tm, m.jcfg, m.tcfg,
                         gen_kwargs(do_sample=False, num_beams=beams, length_penalty=lp))
    assert out["samples"].shape == (3, 13)


def test_beam_sample_matches_jax_with_its_noise(models, monkeypatch):
    """Beam-sample with the port's noise replaced by JAX's Gumbel draws."""
    key = jax.random.PRNGKey(5)

    def jax_gumbel(generator, step, shape, device):
        return torch.from_numpy(np.array(jax.random.gumbel(jax.random.fold_in(key, step), tuple(shape)), np.float32))

    monkeypatch.setattr(beam_search, "beam_gumbel", jax_gumbel)
    m = models["flan-2+2"]
    check_generate(m.jm, m.params, m.tm, m.jcfg, m.tcfg, gen_kwargs(do_sample=True, num_beams=3, temperature=1.5),
                   key=5)
