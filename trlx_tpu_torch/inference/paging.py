"""Host-side block accounting for the paged KV-cache pool.

The device side of paging is dumb on purpose: per-layer arenas of
`num_blocks` × `block_size` token columns plus a per-slot block table
(`Attention`'s paged branch gathers/scatters through it). Everything
stateful — which physical block backs which logical column, which blocks
hold a reusable prompt prefix, when a block can be recycled — lives here,
on the scheduler loop thread, where it is plain Python:

- **free-list allocation** — blocks are integers; block 0 is reserved as
  the permanent zero block backing padding table entries and is never
  handed out.
- **refcounted prefix store** — a prompt prefix is keyed by its raw
  token bytes per block boundary (`ids[: (j+1) * block_size].tobytes()`
  — exact-match chained keys, the vLLM hash-block scheme with the
  collision risk removed by keying on the tokens themselves). A stored
  block can back many slots at once; each holder takes a reference, and
  decode never writes inside a prompt block (completions start at column
  `prompt_len`), so shared blocks need no copy-on-write.
- **LRU idle pool** — when a CACHED block's refcount hits zero it is not
  freed but parked in an LRU ordered dict, still answering lookups; the
  allocator evicts idle blocks oldest-first only under allocation
  pressure (or beyond `idle_capacity`). Uncached blocks go straight back
  to the free list.

Thread safety: none. All callers are the single engine loop thread.
"""

from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np


#: every adapter salt starts with this marker (see
#: `adapters.adapter_salt`); the base policy keeps the UNSALTED key
#: space, so an empty salt must never startswith-match salted keys
ADAPTER_SALT_PREFIX = b"adapter\x00"


class KVPoolExhaustedError(RuntimeError):
    """The paged arena has no free or evictable block left. The scheduler
    prevents this by admitting on projected block budgets; direct engine
    callers see this when they over-commit the pool."""

    def __init__(self, needed: int, available: int):
        self.needed = needed
        self.available = available
        super().__init__(
            f"paged KV pool exhausted: need {needed} blocks, "
            f"{available} available"
        )


def prefix_keys(ids: np.ndarray, block_size: int, salt: bytes = b"") -> List[bytes]:
    """Chained prefix keys for a prompt: key j covers tokens
    [0, (j+1)*block_size). Only FULL blocks are keyed, and the last block
    is excluded when the prompt ends exactly on a boundary — at least one
    suffix token must always prefill, so the engine never has to store
    last-position logits alongside cached blocks.

    `salt` partitions the store: multi-tenant serving salts keys with the
    adapter identity so identical prompts under different adapters never
    share K/V (each adapter's K/V differs once a LoRA delta touches
    k_proj/v_proj, and cross-tenant sharing would leak prompt contents
    through cache timing regardless). Salts are self-delimiting (the
    adapter name is NUL-terminated), so one salt can never be a byte
    prefix of another and per-salt flushes can match on startswith."""
    ids = np.asarray(ids, np.int32).reshape(-1)
    limit = (ids.size - 1) // block_size
    return [salt + ids[: (j + 1) * block_size].tobytes() for j in range(limit)]


class BlockPool:
    """Free list + refcounts + prefix store over `num_blocks` physical
    blocks (block 0 excluded — the zero block)."""

    def __init__(
        self,
        num_blocks: int,
        block_size: int,
        prefix_cache: bool = False,
        idle_capacity: int = 0,
    ):
        if num_blocks < 2:
            raise ValueError("paged pool needs at least 2 blocks (one is the zero block)")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.prefix_cache = bool(prefix_cache)
        self.idle_capacity = int(idle_capacity)  # 0 = bounded by the pool only
        # LIFO free list: recently-freed blocks are re-used first (warm)
        self._free: List[int] = list(range(self.num_blocks - 1, 0, -1))
        self._ref: Dict[int, int] = {}
        self._store: Dict[bytes, int] = {}  # key -> block (live or idle)
        self._key_of: Dict[int, bytes] = {}
        self._idle: "OrderedDict[bytes, int]" = OrderedDict()  # LRU, oldest first
        self.hits = 0  # requests that reused >= 1 cached block
        self.misses = 0  # requests that could have shared but found nothing
        self.evictions = 0  # idle cached blocks reclaimed

    # ------------------------------------------------------------------

    @property
    def total(self) -> int:
        """Allocatable blocks (the zero block excluded)."""
        return self.num_blocks - 1

    def available(self) -> int:
        """Blocks a new request can claim: free + evictable idle."""
        return len(self._free) + len(self._idle)

    def in_use(self) -> int:
        return self.total - self.available()

    def cached_idle(self) -> int:
        return len(self._idle)

    def refcount(self, block: int) -> int:
        return self._ref.get(block, 0)

    def lookup_chain(self, ids: np.ndarray, salt: bytes = b"") -> int:
        """Read-only probe: how many leading blocks of this prompt the
        store could serve right now (admission projections)."""
        if not self.prefix_cache:
            return 0
        n = 0
        for key in prefix_keys(ids, self.block_size, salt):
            if key not in self._store:
                break
            n += 1
        return n

    # ------------------------------------------------------------------

    def acquire_cached(self, key: bytes) -> Optional[int]:
        """Take a reference on the cached block for `key`, resurrecting it
        from the idle pool if needed. None on miss."""
        block = self._store.get(key)
        if block is None:
            return None
        self._idle.pop(key, None)
        self._ref[block] = self._ref.get(block, 0) + 1
        return block

    def alloc(self, n: int) -> List[int]:
        """Claim `n` fresh blocks (refcount 1 each), evicting idle cached
        blocks oldest-first under pressure."""
        if n > self.available():
            raise KVPoolExhaustedError(n, self.available())
        out = []
        for _ in range(n):
            if self._free:
                block = self._free.pop()
            else:
                block = self._evict_oldest()
            self._ref[block] = 1
            out.append(block)
        return out

    def retain(self, blocks) -> None:
        """Take one extra reference per block on already-live blocks
        (session retention: a conversation pins its leading blocks between
        turns so they survive the owning request's release). Blocks must
        currently hold at least one reference — retaining a freed or idle
        block would resurrect recycled storage."""
        for block in blocks:
            ref = self._ref.get(block, 0)
            if ref <= 0:
                raise ValueError(
                    f"retain on block {block} with no live reference"
                )
            self._ref[block] = ref + 1

    def register(self, key: bytes, block: int) -> None:
        """Publish a block (just prefilled by its owner) under a prefix
        key. First writer wins — duplicate keys keep the original block so
        outstanding references stay valid."""
        if not self.prefix_cache or key in self._store:
            return
        self._store[key] = block
        self._key_of[block] = key

    def unregister(self, key: bytes) -> None:
        """Withdraw a published prefix key (insert rollback: the owning
        prefill never dispatched, so the block holds no data). Holders'
        references are untouched; the block recycles as uncached."""
        block = self._store.pop(key, None)
        if block is not None:
            self._key_of.pop(block, None)
            self._idle.pop(key, None)

    def release(self, blocks) -> None:
        """Drop one reference per block. Cached blocks with no holders
        park in the idle LRU (still serving lookups); uncached ones return
        to the free list."""
        for block in blocks:
            left = self._ref.get(block, 0) - 1
            if left > 0:
                self._ref[block] = left
                continue
            self._ref.pop(block, None)
            key = self._key_of.get(block)
            if key is not None:
                self._idle[key] = block
                self._idle.move_to_end(key)
            else:
                self._free.append(block)
        if self.idle_capacity:
            while len(self._idle) > self.idle_capacity:
                self._free.append(self._evict_oldest())

    def flush_cached(self) -> None:
        """Forget every stored prefix (checkpoint hot-swap: cached K/V was
        computed under the old weights). Idle blocks free immediately;
        blocks still referenced stay with their holders and free on
        release like ordinary uncached blocks."""
        for key, block in list(self._idle.items()):
            self._free.append(block)
        self._idle.clear()
        self._store.clear()
        self._key_of.clear()

    def flush_prefix(self, salt: bytes) -> int:
        """Forget every stored prefix under one salt (per-adapter
        hot-reload: only that adapter's cached K/V went stale). Same
        holder semantics as flush_cached, scoped to keys carrying the
        salt. The base policy's salt is empty — it owns the unsalted key
        space, so an empty salt flushes only unsalted keys instead of
        startswith-matching every tenant's. Returns the number of keys
        dropped."""
        if salt:
            doomed = [key for key in self._store if key.startswith(salt)]
        else:
            doomed = [
                key for key in self._store
                if not key.startswith(ADAPTER_SALT_PREFIX)
            ]
        for key in doomed:
            block = self._store.pop(key)
            self._key_of.pop(block, None)
            if self._idle.pop(key, None) is not None:
                self._free.append(block)
        return len(doomed)

    def _evict_oldest(self) -> int:
        key, block = self._idle.popitem(last=False)
        del self._store[key]
        del self._key_of[block]
        self.evictions += 1
        return block
