"""The flash wrapper at head dim 256 against the Pallas kernels in
interpret mode, the cases of `test_torch_model_families.py` moved to a
file of their own (the suite's `--dist loadfile` hands out the files
with the fewest tests last, so these heavy ones fill a worker the
parallelism files leave idle)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trlx_tpu.data.configs import ModelConfig as JModelConfig
from trlx_tpu.data.default_configs import default_sft_config as j_default_sft_config
from trlx_tpu.inference.engine import InferenceEngine as JEngine
from trlx_tpu.models import build_model as j_build_model
from trlx_tpu.models import transformer as jtf
from trlx_tpu.ops.sampling import GenerationConfig as JGenerationConfig
from trlx_tpu.trainer.sft_trainer import SFTTrainer as JSFTTrainer
from trlx_tpu_torch.convert import params_from_jax
from trlx_tpu_torch.data.configs import ModelConfig, TRLConfig
from trlx_tpu_torch.inference.engine import InferenceEngine
from trlx_tpu_torch.models import build_model
from trlx_tpu_torch.models import transformer as tf
from trlx_tpu_torch.models.policy import HydraReference
from trlx_tpu_torch.ops.sampling import GenerationConfig
from trlx_tpu_torch.trainer.sft_trainer import SFTTrainer

torch.set_num_threads(1)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_wrapper_takes_head_dim_256_and_matches_pallas(dtype):
    """HEAD_DIMS holds 256 (the card launches the bf16 kernels on wgmma
    there, with two warpgroups a block, and the f32 kernels on the CUDA
    cores);
    the plain versions agree with the JAX package's Pallas kernels in
    interpret mode, forward and backward, with the tolerances of
    test_torch_flash_attention.py (f32 1e-5 / 2e-5, bf16 one ulp)."""
    from trlx_tpu.ops.attention import _flash_bwd_pallas, _flash_fwd_pallas_lse
    from trlx_tpu_torch.ops import attention as A

    assert 256 in A.HEAD_DIMS
    jdt, tdt = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    tol = {"f32": dict(rtol=1e-5, atol=1e-5), "bf16": dict(rtol=8e-3, atol=1e-3)}[dtype]
    bwd_tol = {"f32": dict(rtol=2e-5, atol=2e-5), "bf16": tol}[dtype]
    rng = np.random.RandomState(4)
    b, t, nh, nkv, hd = 2, 48, 2, 1, 256
    arrays = [rng.randn(b, t, n, hd).astype(np.float32) for n in (nh, nkv, nkv, nh)]
    mask = (np.arange(t)[None, :] >= np.asarray([0, 7])[:, None]).astype(np.int32)
    jq, jk, jv, jg = (jnp.asarray(a, jdt) for a in arrays)
    tq, tk, tv, tg = (torch.from_numpy(a).to(tdt) for a in arrays)
    tm = torch.from_numpy(mask)
    as_np = lambda x: x.float().numpy() if torch.is_tensor(x) else np.asarray(jnp.asarray(x, jnp.float32))
    j_out, j_lse = _flash_fwd_pallas_lse(jq, jk, jv, jnp.asarray(mask), True, 16, 16, interpret=True)
    t_out, t_lse = A.flash_fwd(tq, tk, tv, tm, True, with_lse=True)
    np.testing.assert_allclose(as_np(t_out), as_np(j_out), **tol)
    np.testing.assert_allclose(t_lse.numpy(), np.asarray(j_lse), rtol=1e-5, atol=1e-5)
    j_grads = _flash_bwd_pallas(jq, jk, jv, jnp.asarray(mask), j_out, j_lse, jg, True, 16, 16, interpret=True)
    t_grads = A.flash_backward(tq, tk, tv, tm, torch.from_numpy(np.array(as_np(j_out))).to(tdt),
                               torch.from_numpy(np.array(j_lse)), tg, True)
    for got, want in zip(t_grads, j_grads):
        np.testing.assert_allclose(as_np(got), as_np(want), **bwd_tol)
