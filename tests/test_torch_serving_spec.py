"""The speculative engine against the JAX engine and the plain engine, the
cases of `test_torch_serving_pool.py` moved to a file of their own (the
suite's `--dist loadfile` hands out the files with the fewest tests
last, so these heavy ones fill a worker the parallelism files leave
idle): greedy streams at phase 17's split and with accepted drafts, K1
launches and the dispatch accounting."""

import jax
import numpy as np
import pytest
import torch

from trlx_tpu.inference import InferenceEngine as JEngine
from trlx_tpu.ops.sampling import GenerationConfig as JGenerationConfig
from trlx_tpu_torch.convert import params_from_jax
from trlx_tpu_torch.inference import InferenceEngine
from trlx_tpu_torch.ops import paged_attention
from trlx_tpu_torch.ops.sampling import GenerationConfig
from test_torch_serving_pool import (  # the cases' helpers, shared with test_torch_serving_pool.py
    LP_TOL,
    PAIRS,
    SPEC,
    SPEC_ACCEPT,
    _emitted_per_dispatch,
    drive,
    jax_engines,
    kernel_calls,
    models,
    port_engine,
)

torch.set_num_threads(1)


@pytest.mark.parametrize("paged", [False, True])
def test_spec_engine_matches_jax_and_plain(models, jax_engines, paged, kernel_calls):
    """Greedy emissions equal the JAX spec engine's and the port's plain
    engine's. Over the arena the JAX engine runs its kernel (interpret
    mode) and counts a kernel dispatch plus a spec_verify_rows fallback a
    round, as the port does, whose paged read runs (spec_k + 1) x split
    times a round."""
    jeng = jax_engines("gpt2-tiny", paged, "pallas" if paged else "xla", **SPEC)
    j0 = (jeng._kv_kernel_dispatches, dict(jeng._kv_kernel_fallbacks))
    ref = drive(jeng, PAIRS)
    plain = drive(port_engine(models, "gpt2-tiny", paged), PAIRS)
    del kernel_calls[:]
    teng = port_engine(models, "gpt2-tiny", paged, **SPEC)
    out = drive(teng, PAIRS)
    assert [t for t, _ in out] == [t for t, _ in ref] == [t for t, _ in plain]
    for (_, a), (_, b) in zip(out, ref):
        np.testing.assert_allclose(a, b, rtol=0, atol=LP_TOL)
    stats = teng.kv_stats()
    if paged:
        n = stats["kv_kernel_dispatches"]
        assert stats["kv_kernel_fallbacks"] == {"spec_verify_rows": n}
        assert jeng._kv_kernel_dispatches - j0[0] == n > 0
        assert jeng._kv_kernel_fallbacks["spec_verify_rows"] - j0[1].get("spec_verify_rows", 0) == n
        assert len(kernel_calls) == n * (SPEC["spec_k"] + 1) * SPEC["spec_split"]
    else:
        assert stats["kv_kernel_dispatches"] == 0 and kernel_calls == []
        assert set(stats["kv_kernel_fallbacks"]) == {"kv_paging_off"}


@pytest.mark.parametrize("paged", [False, True])
def test_spec_engine_accepts_drafts_and_matches_jax(models, jax_engines, paged, kernel_calls):
    """With drafts the target accepts, a dispatch emits the pending token
    plus the accepted drafts, rolls the rejected rows back and advances
    by the count it emitted: the emissions per dispatch and slot equal
    the JAX spec engine's, some of them 2 to spec_k + 1; the streams
    equal JAX's and the plain engine's, the logprobs (the accepted
    drafts' among them) JAX's within 1e-5."""
    jeng = jax_engines("gpt2-tiny", paged, "pallas" if paged else "xla", **SPEC_ACCEPT)
    j_counts = _emitted_per_dispatch(jeng)
    ref = drive(jeng, PAIRS)
    plain = drive(port_engine(models, "gpt2-tiny", paged), PAIRS)
    del kernel_calls[:]
    teng = port_engine(models, "gpt2-tiny", paged, **SPEC_ACCEPT)
    t_counts = _emitted_per_dispatch(teng)
    out = drive(teng, PAIRS)
    assert [t for t, _ in out] == [t for t, _ in ref] == [t for t, _ in plain]
    for (_, a), (_, b) in zip(out, ref):
        np.testing.assert_allclose(a, b, rtol=0, atol=LP_TOL)
    assert t_counts == j_counts
    emitted = {n for row in t_counts for n in row}
    assert max(emitted) > 1 and emitted & set(range(2, SPEC_ACCEPT["spec_k"] + 1))
    if paged:
        n = teng.kv_stats()["kv_kernel_dispatches"]
        assert len(kernel_calls) == n * (SPEC_ACCEPT["spec_k"] + 1) * SPEC_ACCEPT["spec_split"]
