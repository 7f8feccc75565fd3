"""Each adapter's leaves and the trainable set against the JAX package,
the case of `test_torch_peft.py` in a file of its own (the suite's
`--dist loadfile` hands out the files with the fewest tests last, so this
heavy one fills a worker the parallelism files leave idle). Tolerances
are that file's.
"""

import jax
import numpy as np
import pytest

from trlx_tpu.models import resolve_split as j_resolve_split
from trlx_tpu.models import trainable_mask as j_trainable_mask
from trlx_tpu_torch.convert import params_from_jax
from trlx_tpu_torch.models import resolve_split
from trlx_tpu_torch.models import trainable_mask
from trlx_tpu_torch.models.lora import is_adapter_name
from test_torch_peft import (  # the cases' helpers, shared with test_torch_peft.py
    PEFT,
    PRESETS,
    _models,
)


@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("kind", list(PEFT))
def test_adapter_leaves_and_trainable_set_match_jax(kind, preset):
    """Every JAX adapter leaf has its port parameter (`_models` checks the
    key sets), the split is 0 under any adapter, and the trainable set is
    JAX's: the adapters and the value head, whatever
    num_layers_unfrozen says."""
    _, jcfg, np_params, tmodel, tcfg = _models(kind, preset)
    adapters = {n for n in tmodel.state_dict() if is_adapter_name(n)}
    want = {"lora": 2 * 2 * 2, "prompt": 1, "prefix": 2 * 2}[kind]
    assert len(adapters) == want
    for unfrozen in (-1, 0, 1):
        assert resolve_split(tcfg, unfrozen) == j_resolve_split(jcfg, unfrozen) == 0
        jmask = j_trainable_mask(np_params, jcfg, unfrozen)
        as_leaves = jax.tree_util.tree_map(lambda m, p: np.full(np.shape(p), float(m), np.float32), jmask, np_params)
        jnames = {n for n, v in params_from_jax(as_leaves).items() if bool(v.flatten()[0])}
        tnames = {n for n, m in trainable_mask(tmodel, tcfg, unfrozen).items() if m}
        assert tnames == jnames == adapters | {n for n in tmodel.state_dict() if n.startswith("v_head.")}
