"""The flash backward against the Pallas kernels in interpret mode, the
cases of `test_torch_flash_attention.py` moved to a file of their own
(the suite's `--dist loadfile` hands out the files with the fewest tests
last, so these heavy ones fill a worker the parallelism files leave
idle): f32 and bf16 over 4, 2 and 1 KV heads."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trlx_tpu.ops.attention import _flash_bwd_pallas, _flash_fwd_pallas, _flash_fwd_pallas_lse
from trlx_tpu_torch.ops import attention as A
from test_torch_flash_attention import (  # the cases' helpers, shared with test_torch_flash_attention.py
    BLK,
    BWD_TOL,
    _case,
    _np,
)

torch.set_num_threads(1)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("nkv", [4, 2, 1])
def test_flash_backward_matches_pallas(nkv, dtype):
    (jq, jk, jv, jg, jm), (tq, tk, tv, tg, tm) = _case(nkv, dtype, seed=1)
    j_out, j_lse = _flash_fwd_pallas_lse(jq, jk, jv, jm, True, BLK, BLK, interpret=True)
    j_grads = _flash_bwd_pallas(jq, jk, jv, jm, j_out, j_lse, jg, True, BLK, BLK, interpret=True)
    # the same residuals on both sides
    t_out = torch.from_numpy(np.array(_np(j_out))).to(tq.dtype)
    t_lse = torch.from_numpy(np.array(j_lse))
    t_grads = A.flash_backward(tq, tk, tv, tm, t_out, t_lse, tg, True)
    for t, j in zip(t_grads, j_grads):
        assert t.shape == tuple(j.shape)
        np.testing.assert_allclose(_np(t), _np(j), **BWD_TOL[dtype])
