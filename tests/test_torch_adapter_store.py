"""The port's adapter store (trlx_tpu_torch/inference/adapters.py) against
the JAX package's (`tests/test_adapters.py`'s store cases): both stores
read the same tenant factors through `loader=` (tests/multitenant_cases.py)
and take the same calls, and every decision (slots, refcounts, LRU
victims, capacity refusals, reloads, prefix flushes, stats) must agree
exactly; the stacked factors bitwise. The port's own loader is held to
a checkpoint that `TorchTrainer.save` writes."""

import os

import numpy as np
import pytest
import torch

import multitenant_cases as mc
from trlx_tpu_torch.inference import AdapterNotFoundError, AdapterStore, load_adapter_leaves


def both(jstore, tstore, call):
    """`call` on both stores: the same value, or the same error class."""
    out = []
    for store in (jstore, tstore):
        try:
            out.append(("ok", call(store)))
        except Exception as e:  # the class name: the packages' classes differ
            out.append(("raise", type(e).__name__))
    assert out[0] == out[1], out
    return out[1]


def stats(store):
    return store.stats()


def assert_stacks_equal(jstore, tstore):
    jstack = {mc.port_name(k): np.asarray(v) for k, v in jstore._stack.items()}
    tstack = {k: v.numpy() for k, v in tstore.stacked().items()}
    assert jstack.keys() == tstack.keys()
    for k in jstack:
        np.testing.assert_array_equal(tstack[k], jstack[k])


def test_store_refcount_lru_and_capacity(tmp_path):
    adir = mc.adapter_root(tmp_path)
    jstore, tstore, _ = mc.stores(adir, max_resident=2)
    assert tstore.capacity == jstore.capacity == 2
    assert tstore.bytes_per_adapter == jstore.bytes_per_adapter
    assert tstore.scan() == jstore.scan() == ["a1", "a2", "a3"]
    for base in (None, "", "base"):
        assert both(jstore, tstore, lambda s: (s.acquire(base), s.known(base))) == ("ok", (0, True))
    calls = [
        lambda s: s.acquire("a1"), lambda s: s.acquire("a2"), lambda s: s.resident(),
        lambda s: s.acquire("a3"),  # both pinned: nothing evictable
        lambda s: s.acquire("a1"), lambda s: s.release("a1"), lambda s: s.acquire("a3"),
        lambda s: s.release("a1"),  # idle now: the LRU victim
        lambda s: s.acquire("a3"), lambda s: s.resident(), lambda s: s.refcount("a1"), stats,
        lambda s: s.release("a2"), lambda s: s.acquire("a1"), stats,
    ]
    outcomes = [both(jstore, tstore, c) for c in calls]
    assert outcomes[3] == ("raise", "AdapterCapacityError") == outcomes[6]
    assert outcomes[8] == outcomes[0], "a3 reuses the evicted adapter's slot"
    assert outcomes[11][1]["loads"] == 3 and outcomes[11][1]["evictions"] == 1
    assert outcomes[14][1]["loads"] == 4
    assert_stacks_equal(jstore, tstore)
    # slot 0 stays zeros: the base policy
    assert all(float(v[0].abs().max()) == 0.0 for v in tstore.stacked().values())


def test_store_hbm_budget_caps_capacity(tmp_path):
    adir = mc.adapter_root(tmp_path)
    per = mc.stores(adir)[1].bytes_per_adapter
    jstore, tstore, model = mc.stores(adir, max_resident=8, hbm_budget_bytes=per + per // 2)
    assert tstore.capacity == jstore.capacity == 1
    both(jstore, tstore, lambda s: s.acquire("a1"))
    assert both(jstore, tstore, lambda s: s.acquire("a2")) == ("raise", "AdapterCapacityError")
    with pytest.raises(ValueError, match="fits no adapter"):
        AdapterStore(model.state_dict(), adapter_dir=adir, hbm_budget_bytes=per - 1)
    with pytest.raises(ValueError, match="no \\*.lora_a"):
        AdapterStore({k: v for k, v in model.state_dict().items() if "lora" not in k})


def test_store_unknown_and_reload(tmp_path):
    adir = mc.adapter_root(tmp_path)
    jstore, tstore, _ = mc.stores(adir, max_resident=2)
    for call in (lambda s: s.known("nope"), lambda s: s.acquire("nope"), lambda s: s.reload("a1"),
                 lambda s: s.load("a1"), lambda s: (s.resident(), s.refcount("a1")),
                 lambda s: s.changed(), lambda s: s.reload("a1")):
        both(jstore, tstore, call)
    with pytest.raises(AdapterNotFoundError):
        tstore.acquire("nope")
    # a newer checkpoint on disk: stale, and a reload reads it
    mc.write_adapter(adir, "a1", seed=99, step=2)
    for call in (lambda s: s.changed(), lambda s: s.acquire("a1"), lambda s: s.reload("a1"),
                 lambda s: s.release("a1"), lambda s: s.reload("a1"), lambda s: s.changed(), stats):
        both(jstore, tstore, call)
    assert tstore.stats()["reloads"] == 1
    assert_stacks_equal(jstore, tstore)
    slot = tstore._slot_of["a1"]
    leaves = mc.t_loader(os.path.join(adir, "a1"))
    for k, v in leaves.items():
        assert torch.equal(tstore.stacked()[k][slot], v)
    for call in (lambda s: s.evict("a1"), lambda s: s.resident(), lambda s: s.evict("a1")):
        both(jstore, tstore, call)


def test_lru_evicted_adapter_flushes_stale_prefixes_on_reload(tmp_path):
    adir = mc.adapter_root(tmp_path)
    jstore, tstore, _ = mc.stores(adir, max_resident=1)
    flushed = {"jax": [], "port": []}
    jstore.flush_prefixes, tstore.flush_prefixes = flushed["jax"].append, flushed["port"].append
    for call in (lambda s: s.load("a1"), lambda s: s.load("a2"), lambda s: s.resident(),
                 lambda s: s.load("a1"), lambda s: s.load("a2")):
        both(jstore, tstore, call)
    assert flushed["port"] == flushed["jax"] == []  # unchanged while evicted: no flush
    mc.write_adapter(adir, "a1", seed=55, step=20)  # a1 moves on disk while out
    both(jstore, tstore, lambda s: s.load("a1"))
    assert flushed["port"] == flushed["jax"] == ["a1"]
    assert_stacks_equal(jstore, tstore)


def test_load_adapter_leaves_reads_the_trainer_checkpoint(tmp_path):
    """`load_adapter_leaves` keeps exactly the LoRA entries of the
    `model.pt` that `TorchTrainer.save` writes, and refuses a checkpoint
    without any; a store fed through it serves those factors."""
    from trlx_tpu_torch.data.default_configs import default_sft_config
    from trlx_tpu_torch.trainer.sft_trainer import SFTTrainer

    def trainer(peft):
        cfg = default_sft_config().evolve(
            model=dict(model_path="random:gpt2-tiny", peft_config=peft),
            tokenizer=dict(tokenizer_path="byte"),
            train=dict(seq_length=32, total_steps=0, tracker=None, batch_size=2,
                       checkpoint_dir=str(tmp_path / "ck"), logging_dir=str(tmp_path / "logs")),
        )
        return SFTTrainer(cfg, device="cpu")

    tr = trainer(mc.PEFT)
    with torch.no_grad():
        for k, v in tr.model.state_dict().items():
            if k.endswith(".lora_b"):
                v.copy_(torch.randn(v.shape, generator=torch.Generator().manual_seed(3)))
    tr.save(str(tmp_path / "adapters" / "t1"))
    leaves = load_adapter_leaves(str(tmp_path / "adapters" / "t1"))
    state = tr.model.state_dict()
    assert sorted(leaves) == sorted(k for k in state if k.endswith((".lora_a", ".lora_b")))
    for k, v in leaves.items():
        assert torch.equal(v, state[k])
    store = AdapterStore(state, adapter_dir=str(tmp_path / "adapters"), max_resident=2)
    slot = store.acquire("t1")
    for k, v in leaves.items():
        assert torch.equal(store.stacked()[k][slot], v)
    plain = trainer(None)
    plain.save(str(tmp_path / "plain"))
    with pytest.raises(AdapterNotFoundError, match="no LoRA leaves"):
        load_adapter_leaves(str(tmp_path / "plain"))
