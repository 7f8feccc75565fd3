"""Every family's paged engine against the JAX engine (greedy streams token
for token, the `alibi` / `sliding_window` fallback counts exactly) and
the paged kernel's refusal of ALiBi and windows, the cases of
`test_torch_model_families.py` in a file of their own (the suite's
`--dist loadfile` hands out the files with the fewest tests last, so
these heavy ones fill a worker the parallelism files leave idle), on
that file's trainers fixture and helpers.
"""

import pytest
import torch

from trlx_tpu_torch.models import transformer as tf
from test_torch_model_families import (  # the cases' helpers, shared with test_torch_model_families.py
    BOUNDARY_PROMPTS,
    FAMILIES,
    _engines,
    _serial,
    trainers,
)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_paged_engine_streams_and_fallbacks_match_jax(trainers, name):
    """The engine asked for the kernel: ALiBi and window models fall back
    to the gather path once a decode dispatch, counted as JAX counts."""
    jeng, teng = _engines(*trainers[name])
    steps = []
    assert _serial(teng, BOUNDARY_PROMPTS, steps) == _serial(jeng, BOUNDARY_PROMPTS)
    j_stats, t_stats = jeng.kv_stats(), teng.kv_stats()
    assert t_stats["kv_kernel_fallbacks"] == j_stats["kv_kernel_fallbacks"]
    assert t_stats["kv_kernel_dispatches"] == j_stats["kv_kernel_dispatches"]
    reason = {"bloom": "alibi", "mistral": "sliding_window"}.get(name)
    if reason:
        assert t_stats["kv_kernel_fallbacks"] == {reason: len(steps)} and \
            t_stats["kv_kernel_dispatches"] == 0
    else:
        assert t_stats["kv_kernel_fallbacks"] == {} and t_stats["kv_kernel_dispatches"] > 0


def test_paged_kernel_refuses_alibi_and_window(trainers):
    _, ttr = trainers["bloom"]
    cfg = ttr.model_cfg
    arena = tf.init_paged_kv_arena(cfg, 4, 8, torch.float32)
    cache = {"layers": [dict(l, table=torch.ones((1, 2), dtype=torch.int32)) for l in arena],
             "mask": torch.zeros((1, 16), dtype=torch.int32), "pos": torch.zeros((1,), dtype=torch.long),
             "row_index": torch.zeros((1,), dtype=torch.long)}
    with pytest.raises(ValueError, match="alibi/window"), torch.no_grad():
        ttr.model.decode_step_rows(torch.zeros((1, 1), dtype=torch.long), cache,
                                   torch.ones((1, 1), dtype=torch.int32), attn_kernel="kernel")
