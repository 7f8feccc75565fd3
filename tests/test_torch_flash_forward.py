"""The flash forward with and without the lse (K4, K3) against the JAX
package's Pallas kernels in interpret mode, for MHA, GQA and MQA at f32
and bf16, the case of `test_torch_flash_attention.py` in a file of its
own (the suite's `--dist loadfile` hands out the files with the fewest
tests last, so this heavy one fills a worker the parallelism files leave
idle). Tolerances are that file's.
"""

import numpy as np
import pytest

from trlx_tpu.ops.attention import _flash_fwd_pallas
from trlx_tpu.ops.attention import _flash_fwd_pallas_lse
from trlx_tpu_torch.ops import attention as A
from test_torch_flash_attention import (  # the cases' helpers, shared with test_torch_flash_attention.py
    BLK,
    TOL,
    _case,
    _np,
)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("nkv", [4, 2, 1])
def test_flash_forward_and_lse_match_pallas(nkv, dtype):
    (jq, jk, jv, _, jm), (tq, tk, tv, _, tm) = _case(nkv, dtype)
    j_out, j_lse = _flash_fwd_pallas_lse(jq, jk, jv, jm, True, BLK, BLK, interpret=True)
    j_out3 = _flash_fwd_pallas(jq, jk, jv, jm, True, BLK, BLK, interpret=True)
    t_out, t_lse = A.flash_fwd(tq, tk, tv, tm, True, with_lse=True)
    t_out3 = A.flash_fwd(tq, tk, tv, tm, True)
    assert t_out.dtype == tq.dtype
    np.testing.assert_allclose(_np(t_out), _np(j_out), **TOL[dtype])
    np.testing.assert_allclose(_np(t_out3), _np(j_out3), **TOL[dtype])
    np.testing.assert_allclose(t_lse.numpy(), np.asarray(j_lse), rtol=1e-5, atol=1e-5)
    # the row with no valid key: exactly 0 and the dead-row lse
    assert float(t_out[-1].abs().max()) == 0.0 and bool((t_lse[-1] == A.DEAD_LSE).all())
