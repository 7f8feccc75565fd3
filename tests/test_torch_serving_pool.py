"""The port's InferenceEngine beyond the paged pool it started with, on
the CPU against the JAX engine on the same weights (gpt2-tiny and
llama-tiny, f32):

- the fixed-slot pool (`kv_paging=False`, the default): greedy streams
  token for token and per-token logprobs within 1e-5 across slot reuse
  and shared steps, every decode dispatch counted as a `kv_paging_off`
  fallback and no paged-kernel call;
- `set_params` in the middle of two streams, on both pools;
- `set_params` refuses a state dict that does not fit before it changes
  anything, and never writes the module the engine was built on;
- the speculative engine (spec_k 3, split 1 of 2 layers, paged and
  fixed-slot): greedy emissions equal the JAX spec engine's and the
  port's plain engine's, the paged kernel read (spec_k + 1) x split
  times a dispatch, and the JAX engine's accounting; and drafting
  through both layers with a rank-16 readout, whose drafts the target
  accepts in part: the same tokens emitted a dispatch as the JAX
  engine, some dispatches emitting 2 to spec_k + 1 tokens a slot;
- the refusals that remain, each naming its ROADMAP item.

The speculative engine's cases are in `test_torch_serving_spec.py`, so
that `--dist loadfile` hands them out after the large files.
"""

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

# one intra-op thread: the tensors here are tiny, and the suite runs in
# several worker processes at once, which extra threads only slow down
torch.set_num_threads(1)

EOS_FREE = 10_000  # an id the byte model never emits -> length-capped runs
MAX_NEW = 8
PROMPTS = [list(range(60, 60 + n)) for n in (7, 9, 16, 17)]
LP_TOL = 1e-5
PRESETS = ("gpt2-tiny", "llama-tiny")
VOCAB, PAD = 259, 256  # the byte tokenizer's


def _config(preset):
    from trlx_tpu.data.default_configs import default_sft_config

    return default_sft_config().evolve(
        model=dict(model_path=f"random:{preset}", model_extra_configs={"dtype": "float32"}),
        tokenizer=dict(tokenizer_path="byte"),
    )


@pytest.fixture(scope="module")
def models():
    """(JAX (module, cfg, params), port (module, cfg)) per preset, on the
    same weights."""
    from trlx_tpu.models import build_model as j_build_model
    from trlx_tpu_torch.models import build_model

    out = {}
    for preset in PRESETS:
        cfg = _config(preset)
        jm, jc, jp = j_build_model(cfg.model, VOCAB)
        tm, tc, _ = build_model(cfg.model, VOCAB, device="cpu")
        tm.load_state_dict(params_from_jax(_np(jp), tc))
        out[preset] = ((jm, jc, jp), (tm, tc))
    return out


@pytest.fixture(scope="module")
def jax_engines(models):
    """JAX engines built once per configuration and shared by the tests
    (each compiles its programs on first use); every test leaves its
    engine's slots reclaimed and its weights as it found them."""
    cache = {}

    def get(preset, paged, decode_kernel="xla", **kw):
        key = (preset, paged, decode_kernel, tuple(sorted(kw.items())))
        if key not in cache:
            jm, jc, jp = models[preset][0]
            cache[key] = JEngine(jm, jc, jp, _gen(JGenerationConfig), decode_kernel=decode_kernel,
                                 **_kw(paged, **kw))
        return cache[key]

    return get


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _gen(cls):
    return cls(max_new_tokens=MAX_NEW, do_sample=False, eos_token_id=EOS_FREE, pad_token_id=PAD)


def _kw(paged, **kw):
    return dict(dict(num_slots=2, max_prompt_len=32, kv_paging=paged, kv_block_size=8), **kw)


def port_engine(models, preset, paged, **kw):
    tm, tc = models[preset][1]
    return InferenceEngine(tm, tc, None, _gen(GenerationConfig), **_kw(paged, **kw))


def drive(engine, batches, on_step=None):
    """Insert each batch of prompts into slots 0.. and step it to the end;
    returns every request's (tokens, logprobs). `on_step(i)` runs before
    decode step i of every batch. Emissions may be [P] (plain) or
    [P, spec_k + 1] (speculative)."""
    outs = []
    for batch in batches:
        slots = list(range(len(batch)))
        engine.insert_requests([(np.asarray(p, np.int32), MAX_NEW) for p in batch], slots)
        toks = {s: [] for s in slots}
        lps = {s: [] for s in slots}
        done = set()
        i = 0
        while len(done) < len(slots):
            if on_step is not None:
                on_step(i)
            t, lp, v, f = engine.step()
            t, lp, v = t.reshape(len(t), -1), lp.reshape(len(t), -1), v.reshape(len(t), -1)
            for s in slots:
                toks[s] += [int(x) for x in t[s][v[s]]]
                lps[s] += [float(x) for x in lp[s][v[s]]]
                if f[s]:
                    done.add(s)
            i += 1
        engine.reclaim_slots(slots)
        outs += [(toks[s], lps[s]) for s in slots]
    return outs


SERIAL = [[p] for p in PROMPTS]  # one slot, reused
PAIRS = [PROMPTS[:2], PROMPTS[2:]]  # two slots stepping together


def _assert_same(out, ref):
    assert [t for t, _ in out] == [t for t, _ in ref]
    for (_, a), (_, b) in zip(out, ref):
        np.testing.assert_allclose(a, b, rtol=0, atol=LP_TOL)


@pytest.fixture
def kernel_calls(monkeypatch):
    """Counts calls of the paged decode read (the kernel's wrapper; on the
    CPU it runs the plain version)."""
    calls = []
    real = paged_attention.paged_attention_decode

    def counting(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(paged_attention, "paged_attention_decode", counting)
    return calls


@pytest.mark.parametrize("preset", PRESETS)
def test_fixed_slot_pool_matches_jax(models, jax_engines, preset, kernel_calls):
    # "pallas" makes the JAX engine count its kv_paging_off fallbacks off
    # the TPU; its fixed-slot decode takes the gather path all the same
    jeng = jax_engines(preset, False, "pallas")
    j0 = dict(jeng._kv_kernel_fallbacks)
    teng = port_engine(models, preset, False)
    for batches in (SERIAL, PAIRS):
        _assert_same(drive(teng, batches), drive(jeng, batches))
    n = teng.kv_stats()["kv_kernel_fallbacks"]["kv_paging_off"]
    assert teng.kv_stats() == {"kv_kernel_dispatches": 0, "kv_kernel_fallbacks": {"kv_paging_off": n}}
    assert jeng._kv_kernel_fallbacks["kv_paging_off"] - j0.get("kv_paging_off", 0) == n > 0
    assert jeng._kv_kernel_dispatches == 0 and kernel_calls == []
    # the same streams as the port's own paged pool with the kernel
    paged = drive(port_engine(models, preset, True), SERIAL)
    assert [t for t, _ in paged] == [t for t, _ in drive(teng, SERIAL)]


@pytest.mark.parametrize("paged", [False, True])
def test_set_params_mid_stream_matches_jax(models, jax_engines, paged):
    (_, _, jp), (tm, tc) = models["gpt2-tiny"]
    rng = np.random.RandomState(3)
    new_j = jax.tree_util.tree_map(lambda x: x * (1 + 0.3 * rng.randn(*x.shape)).astype(np.float32), _np(jp))
    new_t = params_from_jax(new_j, tc)
    old_t = {k: v.clone() for k, v in tm.state_dict().items()}
    jeng = jax_engines("gpt2-tiny", paged, "pallas" if not paged else "xla")
    teng = port_engine(models, "gpt2-tiny", paged)
    v0 = jeng.param_version
    try:
        j_out = drive(jeng, PAIRS[:1], on_step=lambda i: i == 3 and jeng.set_params(new_j))
        t_out = drive(teng, PAIRS[:1], on_step=lambda i: i == 3 and teng.set_params(new_t))
        _assert_same(t_out, j_out)
        assert teng.param_version == jeng.param_version - v0 == 1
        # fresh requests after the swap decode on the new weights
        _assert_same(drive(teng, PAIRS[1:]), drive(jeng, PAIRS[1:]))
    finally:
        tm.load_state_dict(old_t)
        jeng.set_params(jp)


def test_set_params_refuses_a_misfit_and_leaves_the_module_alone(models):
    """A state dict with a missing, an unexpected or a reshaped tensor
    raises before the swap: the served weights, the version and a
    session's retained blocks stay. A swap that fits loads into the
    engine's own copy; the module the engine was built on keeps its
    weights."""
    tm, tc = models["gpt2-tiny"][1]
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    teng = port_engine(models, "gpt2-tiny", True, max_prompt_len=64)
    teng.enable_sessions()
    ref = drive(teng, PAIRS[:1])
    sess = teng.session_store.create()
    teng.session_store.end_turn(sess)
    first = sorted(before)[0]
    scaled = {k: v * 1.25 for k, v in before.items()}
    misfits = {
        "missing": {k: v for k, v in scaled.items() if k != first},
        "unexpected": dict(scaled, extra=torch.zeros(2)),
        "reshaped": dict(scaled, **{first: scaled[first][..., :1]}),
    }
    for what, params in misfits.items():
        with pytest.raises(ValueError, match=what):
            teng.set_params(params)
        assert teng.param_version == 0
        assert teng.session_store.begin_turn(sess.id) is sess  # not reset
        teng.session_store.end_turn(sess)
    _assert_same(drive(teng, PAIRS[:1]), ref)
    assert teng.set_params(scaled) == 1
    assert drive(teng, PAIRS[:1]) != ref
    assert teng.model is not tm
    for k, v in tm.state_dict().items():
        assert torch.equal(v, before[k]), k


SPEC = dict(spec_k=3, spec_split=1, spec_draft_rank=16)


# the trunk is both layers, so the draft differs from the target only by
# its rank-16 readout of the unembedding: some drafts are accepted
SPEC_ACCEPT = dict(spec_k=3, spec_split=2, spec_draft_rank=16)


def _emitted_per_dispatch(engine):
    """Wrap `engine.step` to record each dispatch's tokens emitted per
    slot; returns the list it fills."""
    counts, step = [], engine.step

    def recording():
        out = step()
        counts.append(out[2].reshape(len(out[2]), -1).sum(1).tolist())
        return out

    engine.step = recording
    return counts


def _chat_turns(engine, turns):
    """Drive `turns` (token lists) as one session at engine level, as the
    scheduler does: the full conversation goes in with the session, the
    finishing turn's blocks are retained before the slot is reclaimed.
    Returns (replies, [(last_reused_blocks, last_prefill_tokens)])."""
    store = engine.session_store
    sess = store.create()
    store.end_turn(sess)
    replies, stats = [], []
    for turn in turns:
        store.begin_turn(sess.id)
        full = np.concatenate([sess.tokens, np.asarray(turn, np.int32)])
        engine.insert_requests([(full, MAX_NEW)], [0], sessions=[sess])
        toks = []
        while True:
            t, _, v, f = engine.step()
            if v[0]:
                toks.append(int(t[0]))
            if f[0]:
                break
        engine.retain_session(0, sess, np.concatenate([full, np.asarray(toks, np.int32)]))
        engine.reclaim_slots([0])
        store.end_turn(sess)
        replies.append(toks)
        stats.append((sess.last_reused_blocks, sess.last_prefill_tokens))
    return replies, stats


def test_three_turn_chat_matches_jax(models, jax_engines):
    """Each turn resumes on the retained blocks and prefills only its
    delta; replies and retention equal the JAX engine's, and each reply
    equals a fresh request over the whole transcript."""
    turns = [list(range(40, 51)), list(range(70, 73)), list(range(90, 96))]
    jeng = jax_engines("gpt2-tiny", True, max_prompt_len=64)
    jeng.enable_sessions()
    teng = port_engine(models, "gpt2-tiny", True, max_prompt_len=64)
    teng.enable_sessions()
    t_replies, t_stats = _chat_turns(teng, turns)
    j_replies, j_stats = _chat_turns(jeng, turns)
    assert t_replies == j_replies and t_stats == j_stats
    assert all(reused > 0 for reused, _ in t_stats[1:])
    assert teng.session_stats()["session_retained_hits_total"] == 2
    history = []
    for turn, reply in zip(turns, t_replies):
        history += turn
        assert drive(port_engine(models, "gpt2-tiny", True, max_prompt_len=64), [[history]])[0][0] == reply
        history += reply


def test_remaining_refusals_name_their_roadmap_item(models):
    tm, tc = models["gpt2-tiny"][1]
    gen = _gen(GenerationConfig)
    # multi-tenant serving is ported (ROADMAP queue A, item 4.5): a policy
    # without LoRA cannot serve tenants, as in JAX
    from trlx_tpu_torch.inference import AdapterStore

    with pytest.raises(ValueError, match="needs an AdapterStore"):
        InferenceEngine(tm, tc, None, gen, multi_tenant=True)
    with pytest.raises(ValueError, match="AdapterStore needs a LoRA-enabled policy"):
        AdapterStore(tm.state_dict())
    with pytest.raises(NotImplementedError, match="ROADMAP queue A, item 4, observability"):
        InferenceEngine(tm, tc, None, gen, compile_ledger=object())
    # the JAX engine's own refusals of the fixed-slot pool
    with pytest.raises(NotImplementedError, match="int8 KV cache requires kv_paging"):
        InferenceEngine(tm, tc, None, gen, kv_cache_dtype="int8")
    with pytest.raises(ValueError, match="prefix_cache requires kv_paging"):
        InferenceEngine(tm, tc, None, gen, prefix_cache=True)
    with pytest.raises(ValueError, match="sessions require kv_paging"):
        InferenceEngine(tm, tc, None, gen, **_kw(False)).enable_sessions()
    with pytest.raises(ValueError, match="hydra split"):
        InferenceEngine(tm, tc, None, gen, spec_k=2)
