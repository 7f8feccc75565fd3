"""Every family's greedy sampler against the JAX trainer's, token for
token, the case of `test_torch_model_families.py` in a file of its own
(the suite's `--dist loadfile` hands out the files with the fewest tests
last, so this heavy one fills a worker the parallelism files leave idle),
on that file's trainers fixture and helpers.
"""

import numpy as np
import pytest
import torch


from test_torch_model_families import (  # the cases' helpers, shared with test_torch_model_families.py
    FAMILIES,
    trainers,
)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_greedy_sampler_matches_jax(trainers, name):
    jtr, ttr = trainers[name]
    rng = np.random.RandomState(1)
    ids = rng.randint(32, 127, (3, 12)).astype(np.int32)
    mask = (np.arange(12)[None, :] >= np.asarray([0, 5, 9])[:, None]).astype(np.int32)
    ids = np.where(mask > 0, ids, ttr.tokenizer.pad_token_id).astype(np.int32)
    kw = dict(max_new_tokens=10, do_sample=False)
    got = ttr.generate(ids, mask, kw)["samples"]
    want = jtr.generate(ids, mask, kw)["samples"]
    np.testing.assert_array_equal(np.asarray(got.cpu() if torch.is_tensor(got) else got), np.asarray(want))
