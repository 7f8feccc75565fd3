"""The port's session store (`trlx_tpu_torch/inference/sessions.py`)
against the JAX package's: the same sequence of create, begin, retain,
acquire, evict, sweep and invalidate operations over each package's own
`BlockPool` gives the same return values, errors, pins and stats. The
scenarios are the cases of `tests/test_sessions.py`, written once as
operation scripts and run on both packages."""

import numpy as np
import pytest

from trlx_tpu.inference import paging as j_paging
from trlx_tpu.inference import sessions as j_sessions
from trlx_tpu_torch.inference import paging, sessions

BS = 8  # block size
PACKAGES = {"jax": (j_paging, j_sessions), "torch": (paging, sessions)}


def ids(n, base=0):
    return np.arange(base, base + n, dtype=np.int32)


class Script:
    """One package's store plus a log of what each operation returned or
    raised (exception type and reason; session ids are random, so they
    are never logged)."""

    def __init__(self, pkg, num_blocks=16, **kw):
        pg, ss = PACKAGES[pkg]
        kw.setdefault("ttl_s", 600.0)
        kw.setdefault("max_sessions", 8)
        self.pool = pg.BlockPool(num_blocks, BS)
        self.store = ss.SessionStore(self.pool, BS, **kw)
        self.log = []

    def do(self, fn, *args, **kwargs):
        try:
            out = fn(*args, **kwargs)
        except Exception as e:  # noqa: BLE001 - the error is the observation
            self.log.append(("raised", type(e).__name__, getattr(e, "reason", None)))
            return None
        self.log.append(("returned", out if isinstance(out, (int, float, bool, list, type(None))) else "obj"))
        return out

    def note(self, *values):
        self.log.append(("note",) + values)

    def turn(self, sess, full_ids):
        """One finished turn as the scheduler sees it: the request holds
        ceil(len / BS) slot blocks, retention pins the leading full ones,
        then the slot's own references release."""
        slot_blocks = self.pool.alloc(-(-len(full_ids) // BS))
        kept = self.do(self.store.retain_turn, sess, slot_blocks, full_ids)
        self.pool.release(slot_blocks)
        return kept

    def snapshot(self, *sessions_):
        self.note(self.pool.available(), self.store.stats(),
                  [(len(s.blocks), int(s.tokens.size), s.busy, s.turns, s.reset_reason) for s in sessions_])


def lifecycle(sc):
    st = sc.store
    sess = sc.do(st.create)
    sc.do(st.begin_turn, sess.id)  # busy
    st.end_turn(sess)
    sc.note(sc.do(st.begin_turn, sess.id) is sess)
    st.end_turn(sess)
    sc.do(st.begin_turn, sess.id, adapter_id="other")  # adapter mismatch
    sc.do(st.begin_turn, "nope")  # unknown
    sc.snapshot(sess)


def retain_leading_full_blocks(sc):
    st = sc.store
    a = st.create()
    sc.turn(a, ids(2 * BS + 3))
    b = st.create()
    sc.turn(b, ids(2 * BS))  # on a block boundary: the last block is not kept
    st.end_turn(a)
    st.end_turn(b)
    sc.snapshot(a, b)


def acquire_prefix(sc):
    st = sc.store
    sess = st.create()
    history = ids(2 * BS + 3)
    sc.turn(sess, history)
    st.end_turn(sess)
    nxt = np.concatenate([history, ids(4, base=500)])
    got = sc.do(st.acquire_blocks, sess, nxt)
    sc.note(got == sess.blocks)
    sc.pool.release(got)
    bad = nxt.copy()
    bad[3] += 1
    sc.do(st.acquire_blocks, sess, bad)  # diverging history
    sc.do(st.acquire_blocks, sess, history[: BS - 1])  # shorter than coverage
    sc.snapshot(sess)


def ttl_sweep(sc):
    st = sc.store
    sess = st.create()
    sc.turn(sess, ids(2 * BS + 1))
    st.end_turn(sess)
    sess.last_used -= 11.0
    sc.do(st.sweep)
    sc.do(st.begin_turn, sess.id)
    sc.snapshot(sess)


def lru_churn(sc):
    st = sc.store
    a = st.create()
    st.end_turn(a)
    b = st.create()
    st.end_turn(b)
    a.last_used -= 5.0
    c = st.create()
    st.end_turn(c)
    sc.note(len(st), st.get(a.id) is None)
    sc.do(st.begin_turn, b.id)
    sc.do(st.begin_turn, c.id)
    sc.do(st.create)  # every session busy: refused, not evicted
    sc.snapshot(b, c)


def evict_for_blocks(sc):
    st = sc.store
    a = st.create()
    sc.turn(a, ids(3 * BS + 1))
    st.end_turn(a)
    b = st.create()
    sc.turn(b, ids(3 * BS + 1, base=100))
    st.end_turn(b)
    a.last_used -= 5.0
    sc.do(st.evictable_blocks)
    sc.do(st.evict_for_blocks, sc.pool.available() + 2)
    sc.do(st.acquire_blocks, a, np.concatenate([a.tokens, ids(2)]))
    sc.snapshot(a, b)


def invalidate_all(sc):
    st = sc.store
    sess = st.create()
    sc.turn(sess, ids(2 * BS + 1))
    st.end_turn(sess)
    sc.do(st.invalidate_all, "weights_updated")
    sc.do(st.begin_turn, sess.id)
    sc.note(st.get(sess.id) is None)
    sc.snapshot(sess)


def invalidate_adapter(sc):
    st = sc.store
    a = st.create(adapter_id="a")
    sc.turn(a, ids(BS + 1))
    st.end_turn(a)
    b = st.create(adapter_id="b")
    sc.turn(b, ids(BS + 1, base=50))
    st.end_turn(b)
    sc.do(st.invalidate_adapter, "a")
    sc.do(st.begin_turn, a.id, adapter_id="a")
    sc.note(sc.do(st.begin_turn, b.id, adapter_id="b") is b)
    sc.snapshot(a, b)


def retain_after_invalidate(sc):
    st = sc.store
    sess = st.create()
    slot_blocks = sc.pool.alloc(3)
    st.invalidate_all("weights_updated")
    sc.do(st.retain_turn, sess, slot_blocks, ids(2 * BS + 1))
    sc.pool.release(slot_blocks)
    sc.do(st.retained_blocks)
    sc.snapshot(sess)


def bytes_budget(sc):
    st = sc.store
    a = st.create()
    sc.turn(a, ids(2 * BS + 1))
    st.end_turn(a)
    a.last_used -= 5.0
    b = st.create()
    sc.turn(b, ids(2 * BS + 1, base=100))
    st.end_turn(b)
    sc.note(st.get(a.id) is not None)
    sc.snapshot(a, b)


SCENARIOS = [
    (lifecycle, {}),
    (retain_leading_full_blocks, {}),
    (acquire_prefix, {}),
    (ttl_sweep, dict(ttl_s=10.0)),
    (lru_churn, dict(max_sessions=2)),
    (evict_for_blocks, {}),
    (invalidate_all, {}),
    (invalidate_adapter, {}),
    (retain_after_invalidate, {}),
    (bytes_budget, dict(num_blocks=32, bytes_budget=3 * 1024, block_bytes=1024)),
]


@pytest.mark.parametrize("scenario,kw", SCENARIOS, ids=[f.__name__ for f, _ in SCENARIOS])
def test_session_store_matches_jax(scenario, kw):
    logs = {}
    for pkg in PACKAGES:
        sc = Script(pkg, **kw)
        scenario(sc)
        logs[pkg] = sc.log
    assert logs["torch"] == logs["jax"]
    # every scenario reaches at least one refusal or pin worth comparing
    assert any(entry[0] in ("raised", "note") for entry in logs["torch"])
