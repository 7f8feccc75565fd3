"""The bf16 flash backward's arithmetic against the Pallas kernels in
interpret mode, the cases of `test_torch_flash_numerics.py` moved to a
file of their own (the suite's `--dist loadfile` hands out the files
with the fewest tests last, so these heavy ones fill a worker the
parallelism files leave idle): the emulated tensor-core backward at head
dims 32, 64 and 256, and the lo halves that keep it exact."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trlx_tpu.ops.attention import _flash_bwd_pallas, _flash_fwd_pallas_lse
from trlx_tpu_torch.ops import attention as A
from test_torch_flash_numerics import (  # the cases' helpers, shared with test_torch_flash_numerics.py
    BF16_TOL,
    DKV_TOL,
    NKV,
    _backward_case,
    _fold,
    emulate_backward,
)

torch.set_num_threads(1)


@pytest.mark.parametrize("hd", [32, 64, 256])
def test_bf16_backward_arithmetic_matches_pallas(hd):
    """dq within one bf16 ulp of the Pallas dq once both are rounded to
    bf16; the f32 dk/dv within phase 6's DKV_TOL; dq of rows with no
    allowed key and the per-head dk/dv of padding keys exactly 0."""
    (q, k, v, mask, g, lse, delta), (j_dq, j_dk, j_dv) = _backward_case(hd, seed=200 + hd)
    dq, dk, dv = emulate_backward(q, k, v, mask, g, lse, delta)
    np.testing.assert_allclose(dq.bfloat16().float().numpy(),
                               torch.from_numpy(j_dq).bfloat16().float().numpy(), **BF16_TOL)
    np.testing.assert_allclose(_fold(dk, NKV).numpy(), j_dk, **DKV_TOL)
    np.testing.assert_allclose(_fold(dv, NKV).numpy(), j_dv, **DKV_TOL)
    dead = mask.cumsum(-1) == 0  # [b, t] rows with no allowed key
    padding = mask == 0
    assert bool(dead.any()) and bool((dq[dead] == 0).all())
    assert bool((dk[padding] == 0).all()) and bool((dv[padding] == 0).all())


@pytest.mark.parametrize("hd", [32, 64, 256])
def test_lo_halves_are_what_keep_the_backward_exact(hd):
    """Against the Pallas backward in f32 on the same bf16-exact values,
    before any output rounding: with the hi/lo split of p and ds the
    largest error over dq, dk and dv is 1.05e-5 at hd 32, 1.53e-5 at hd
    64 and 1.63e-5 at hd 256 (measured on the CPU; the order of the sums
    and the exp2 form, on values up to about 10); with the hi halves alone
    it is 7.66e-3, 7.03e-3 and 9.16e-3, some 460 to 730 times more."""
    (q, k, v, mask, g, lse, delta), j_grads = _backward_case(hd, seed=300 + hd)

    def worst(split):
        dq, dk, dv = emulate_backward(q, k, v, mask, g, lse, delta, split=split)
        got = (dq, _fold(dk, NKV), _fold(dv, NKV))
        return max(float(np.abs(a.numpy() - j).max()) for a, j in zip(got, j_grads))

    err_split, err_hi = worst(True), worst(False)
    msg = f"hd {hd}: max abs error hi + lo {err_split:.3g}, hi alone {err_hi:.3g}"
    assert err_split < 2e-5, msg
    assert err_hi > 100 * err_split, msg
