"""The multi-turn loss-mask collation bitwise against the JAX package,
the case of `test_torch_fleet_ppo.py` in a file of its own: that file
then holds seven tests, and the suite's `--dist loadfile`, which hands
out the files with the fewest tests last, starts both after the
parallelism files of few tests, in the workers those leave idle.
"""

import numpy as np

from trlx_tpu.data import PPORLElement as JPPORLElement
from trlx_tpu.pipeline.ppo_pipeline import PPORolloutStorage as JPPORolloutStorage
from trlx_tpu_torch.data import PPORLElement
from trlx_tpu_torch.pipeline.ppo_pipeline import PPORolloutStorage


def test_loss_mask_collation_is_bitwise_jax():
    rng = np.random.RandomState(3)
    t_elems, j_elems = [], []
    for i in range(5):
        q, r = int(rng.randint(2, 7)), int(rng.randint(1, 9))
        fields = dict(query_tensor=rng.randint(0, 250, q).astype(np.int32),
                      response_tensor=rng.randint(0, 250, r).astype(np.int32),
                      logprobs=rng.randn(r).astype(np.float32), values=rng.randn(r).astype(np.float32),
                      rewards=rng.randn(r).astype(np.float32),
                      loss_mask=(rng.rand(r) > 0.4).astype(np.float32))
        t_elems.append(PPORLElement(**fields))
        j_elems.append(JPPORLElement(**fields))
    ts, js = PPORolloutStorage(256, "left"), JPPORolloutStorage(256, "left")
    ts.push(t_elems)
    js.push(j_elems)
    tb = next(iter(ts.create_loader(5, max_query_len=8, max_response_len=10, max_stat_len=10)))
    jb = next(iter(js.create_loader(5, max_query_len=8, max_response_len=10, max_stat_len=10)))
    for f in ("query_tensors", "response_tensors", "logprobs", "values", "rewards", "loss_masks"):
        a, b = np.asarray(getattr(tb, f)), np.asarray(getattr(jb, f))
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), f
    # no loss mask on an element: the field stays None on both sides
    t_elems[0].loss_mask = j_elems[0].loss_mask = None
    assert next(iter(ts.create_loader(5))).loss_masks is None
    assert next(iter(js.create_loader(5))).loss_masks is None
