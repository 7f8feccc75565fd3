"""The port's multi-tenant engine (trlx_tpu_torch/inference/engine.py's
multi-tenant branches, `models/transformer.py:lora_rows`) against the JAX
package's (`tests/test_adapters.py`'s engine cases), at f32 on the same
weights and tenant factors (tests/multitenant_cases.py): a mixed batch
(base, a1, a2) token for token against JAX's mixed batch and against the
port's single-tenant engine serving each tenant's factors in its own
module, with and without paging; adapter-salted prefix isolation and
per-adapter flushes, hit for hit against JAX's; JAX's refusals; and the
per-thread scope of the row factors."""

import threading

import numpy as np
import pytest
import torch

import multitenant_cases as mc
from trlx_tpu_torch.inference import InferenceEngine, adapter_salt
from trlx_tpu_torch.models.transformer import lora_rows

PAGED = dict(kv_paging=True, kv_block_size=8, prefix_cache=True)


@pytest.mark.parametrize("paging", [False, True], ids=["dense", "paged"])
def test_mixed_adapter_batch_matches_jax(tmp_path, paging):
    adir = mc.adapter_root(tmp_path)
    kw = PAGED if paging else {}
    jeng, teng = mc.engines(adir, num_slots=4, **kw)
    ps = mc.prompts(0, (7, 13, 21, 9))
    rows = [(ps[0], 6, None), (ps[1], 6, "a1"), (ps[2], 6, "a2"), (ps[3], 6, "a1")]
    got = mc.run_engine(teng, rows)
    assert got == mc.run_engine(jeng, rows)
    for (ids, _, name), out in zip(rows, got):
        leaves = mc.lora_leaves({"a1": 10, "a2": 11}[name]) if name else None
        assert mc.run_engine(mc.single_tenant_engine(leaves, **kw), [(ids, 6)])[0] == out
    assert len({tuple(o) for o in got[:3]}) == 3, "tenants must decode differently"
    # the pins drop when the slots are reclaimed
    assert teng.adapter_store.refcount("a1") == 0 and teng.adapter_store.refcount("a2") == 0
    assert teng.adapter_stats()["resident"] == ["a1", "a2"]


def test_prefix_salt_isolation(tmp_path):
    """The same prompt under two tenants never shares prefix blocks;
    repeats under one tenant hit, and a per-adapter flush drops only that
    tenant's blocks: hit for hit as JAX's engine."""
    adir = mc.adapter_root(tmp_path)
    engines = mc.engines(adir, num_slots=2, max_new=4, prefix_cache_capacity=16, **PAGED)
    p = np.random.RandomState(1).randint(1, mc.V, size=33).astype(np.int32)
    seen = []
    for eng in engines:
        hits = []
        for name in ("a1", "a2", "a1"):
            mc.run_engine(eng, [(p, 4, name)])
            hits.append(eng.kv_stats()["prefix_cache_hits"])
        flushed = eng.flush_adapter_prefixes("a1")
        for name in ("a1", "a2"):
            mc.run_engine(eng, [(p, 4, name)])
            hits.append(eng.kv_stats()["prefix_cache_hits"])
        seen.append((hits, flushed))
    assert seen[1] == seen[0]
    assert seen[1][0] == [0, 0, 1, 1, 2] and seen[1][1] > 0
    assert adapter_salt("a1") != adapter_salt("a2")
    assert adapter_salt(None) == adapter_salt("") == adapter_salt("base") == b""


def test_base_flush_does_not_sweep_tenant_prefixes(tmp_path):
    adir = mc.adapter_root(tmp_path)
    engines = mc.engines(adir, num_slots=2, max_new=4, prefix_cache_capacity=16, **PAGED)
    p = np.random.RandomState(2).randint(1, mc.V, size=33).astype(np.int32)
    seen = []
    for eng in engines:
        mc.run_engine(eng, [(p, 4, None)])
        mc.run_engine(eng, [(p, 4, "a1")])
        flushed = eng.flush_adapter_prefixes(None)
        hits = []
        for name in ("a1", None):
            mc.run_engine(eng, [(p, 4, name)])
            hits.append(eng.kv_stats()["prefix_cache_hits"])
        seen.append((flushed, hits))
    assert seen[1] == seen[0] and seen[1][1] == [1, 1]


def test_multi_tenant_refusals_match_jax(tmp_path):
    adir = mc.adapter_root(tmp_path)
    jmodel, jcfg, params, tcfg = mc.policy()
    model = mc.port_model()
    _, tstore, _ = mc.stores(adir)
    with pytest.raises(ValueError, match="multi_tenant serving needs an AdapterStore"):
        InferenceEngine(model, tcfg, None, mc.gen(), multi_tenant=True)
    with pytest.raises(NotImplementedError, match="speculative decode under multi-tenant adapters"):
        InferenceEngine(model, tcfg, None, mc.gen(), multi_tenant=True, adapter_store=tstore,
                        spec_k=2, spec_split=1)
    from trlx_tpu_torch.models import CausalLMWithValueHead, config_from_preset

    plain_cfg = config_from_preset("gpt2-tiny", vocab_size=mc.V, dtype=torch.float32)
    with pytest.raises(ValueError, match="needs a LoRA-enabled policy"):
        InferenceEngine(CausalLMWithValueHead(plain_cfg), plain_cfg, None, mc.gen(), multi_tenant=True,
                        adapter_store=tstore)
    # a store without multi_tenant is ignored, as in JAX; a single-tenant
    # engine refuses a row that names an adapter
    eng = InferenceEngine(model, tcfg, None, mc.gen(), num_slots=1, max_prompt_len=64, adapter_store=tstore)
    assert eng.adapter_store is None and eng.adapter_stats() == {}
    with pytest.raises(ValueError, match="multi_tenant"):
        eng.insert_requests([(mc.prompts(0, (5,))[0], 4, "a1")], [0])
    # a capacity failure releases the pins already taken
    _, teng = mc.engines(adir, num_slots=2, max_new=4, max_resident=1)
    ps = mc.prompts(3, (5, 6))
    from trlx_tpu_torch.inference import AdapterCapacityError

    with pytest.raises(AdapterCapacityError):
        teng.insert_requests([(ps[0], 4, "a1"), (ps[1], 4, "a2")], [0, 1])
    assert teng.adapter_store.refcount("a1") == 0 and teng._slot_adapter == {}


def test_lora_rows_is_per_thread_and_zero_rows_are_the_base():
    """Row factors handed to a `lora_rows` block reach the forwards of
    that thread only: a forward on the same module in another thread
    meanwhile reads the module's own factors. A zero pair gives the base
    logits bitwise; a per-row pair equals the module holding that pair."""
    state = mc.port_model().state_dict()
    leaves = {mc.port_name(k): torch.from_numpy(v) for k, v in mc.lora_leaves(10).items()}
    tuned = mc.port_model({**state, **leaves})
    model = mc.port_model()
    lin = [(mod, n) for n, mod in model.named_modules() if getattr(mod, "lora_rank", 0) > 0]
    ids = torch.from_numpy(mc.prompts(4, (12, 12))[0][None].repeat(2, 0)).long()
    mask = torch.ones_like(ids)
    with torch.no_grad():
        base = model.lm(ids, mask)[0]
        want_tuned = tuned.lm(ids, mask)[0]
        zeros = {m: (torch.zeros(2, *m.lora_a.shape), torch.zeros(2, *m.lora_b.shape)) for m, _ in lin}
        mixed = {m: (torch.stack([torch.zeros_like(m.lora_a), leaves[n + ".lora_a"]]),
                     torch.stack([torch.zeros_like(m.lora_b), leaves[n + ".lora_b"]])) for m, n in lin}
        with lora_rows(zeros):
            assert torch.equal(model.lm(ids, mask)[0], base)
        with lora_rows(mixed):
            out = model.lm(ids, mask)[0]
        assert torch.equal(out[0], base[0])
        np.testing.assert_allclose(out[1].numpy(), want_tuned[1].numpy(), rtol=1e-5, atol=1e-5)
    entered, release, other = threading.Event(), threading.Event(), {}

    def hold():
        with torch.no_grad(), lora_rows(mixed):
            entered.set()
            release.wait(30)

    t = threading.Thread(target=hold)
    t.start()
    entered.wait(30)
    with torch.no_grad():
        other["out"] = model.lm(ids, mask)[0]
    release.set()
    t.join()
    assert torch.equal(other["out"], base)
