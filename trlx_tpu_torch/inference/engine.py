"""Continuous-batching inference engine over a paged KV-cache pool.

Port of the JAX package's `inference/engine.py`, paged path only. Slots
hold requests in flight; each slot's KV lives in blocks of a global
per-layer arena, named through the slot's block table. Per step:

- insert (`insert_requests`): allocate each request's blocks up front
  (prompt + max_new), probe the prefix store when it is on, and run one
  `prefill_rows` call per (rows, suffix-width) bucket that writes the
  RIGHT-padded prompt straight into the arena; the first token is drawn
  in the same call;
- decode (`step`): one `decode_step_rows` call over every slot; each
  active slot emits its pre-sampled token and draws the next one.

PyTorch runs eagerly, so there are no per-bucket compiled programs; the
buckets and padding rows are kept so the arithmetic (and the arena
traffic) matches the JAX engine's. The arena and the pool tensors are
updated in place where the JAX engine scattered functionally into a
donated pool. Writes the JAX scatters drop as out of bounds (padding
rows with `slot_id == num_slots` and all-out-of-range tables, right pad,
inactive slots) are masked out explicitly: padding rows are sliced off
before the pool writes and their arena writes land in the arena's spare
block (`models/transformer.py:init_paged_kv_arena`).

The `decode_kernel` knob keeps its values: "xla" selects the gather read
path; "auto" and "pallas" select the paged-attention kernel — the CUDA
kernel for a model on a cuda device, its plain PyTorch version on the
CPU (`ops/paged_attention.py` dispatches on the tensor's device).

Not ported yet (each raises `NotImplementedError`): the fixed-slot pool
(`kv_paging=False`), speculative decode, multi-tenant adapters, chat
sessions, the compile and HBM ledgers, and checkpoint hot-reload.

Thread safety: device-touching methods are called from ONE loop thread
(the scheduler loop); the block pool is guarded by `_kv_lock`.
"""

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from trlx_tpu_torch.inference.paging import BlockPool, KVPoolExhaustedError, prefix_keys
from trlx_tpu_torch.models.transformer import init_paged_kv_arena
from trlx_tpu_torch.ops.sampling import (
    GenerationConfig,
    process_logits,
    sampled_token_logprob,
    select_token,
)
from trlx_tpu_torch.utils import logging

logger = logging.get_logger(__name__)


def _round_up(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


def _pow2_bucket(n: int, cap: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return min(b, cap)


_KV_DTYPES = {
    "auto": None,
    "f32": torch.float32,
    "float32": torch.float32,
    "bf16": torch.bfloat16,
    "bfloat16": torch.bfloat16,
    "int8": torch.int8,
}


def kv_arena_bytes(n_layers: int, kv_heads: int, head_dim: int, n_blocks: int,
                   block_size: int, dtype) -> int:
    """K and V blocks of every layer plus the f32 scale planes of an int8
    arena (the JAX package's `observability/hbm.py:kv_arena_bytes`; the
    spare block that takes dropped writes is not counted)."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    n = 2 * n_layers * n_blocks * block_size * kv_heads * head_dim * itemsize
    if dtype == torch.int8:
        n += 2 * n_layers * n_blocks * block_size * kv_heads * 4
    return int(n)


class InferenceEngine:
    """Generation over a pool of `num_slots` KV-cache slots.

    :param model: a module exposing `prefill_rows` and `decode_step_rows`
        (`CausalLMWithValueHead`); it runs on the device its parameters
        are on.
    :param params: a state dict to load into `model`, or None to serve
        the weights it holds.
    :param gen_cfg: engine-wide sampling knobs; per-request overrides are
        limited to `max_new_tokens` (≤ the engine's, which sizes the
        cache).
    """

    def __init__(
        self,
        model,
        model_cfg,
        params,
        gen_cfg: GenerationConfig,
        num_slots: int = 8,
        max_prompt_len: int = 256,
        max_prefill_batch: int = 8,
        prompt_bucket: int = 32,
        seed: int = 0,
        spec_k: int = 0,
        kv_paging: bool = False,
        kv_block_size: int = 32,
        kv_pool_blocks: int = 0,
        kv_cache_dtype: str = "auto",
        prefix_cache: bool = False,
        prefix_cache_capacity: int = 0,
        multi_tenant: bool = False,
        adapter_store=None,
        decode_kernel: str = "auto",
        compile_ledger=None,
        hbm_ledger=None,
    ):
        if not kv_paging:
            raise NotImplementedError(
                "the fixed-slot KV pool is not ported yet; set inference.kv_paging=true "
                "(ROADMAP queue A, serving features)"
            )
        if spec_k > 0:
            raise NotImplementedError("speculative decode is not ported yet (ROADMAP queue A, serving features)")
        if multi_tenant or adapter_store is not None:
            raise NotImplementedError("multi-tenant adapters are not ported yet (ROADMAP queue A, serving features)")
        if compile_ledger is not None or hbm_ledger is not None:
            raise NotImplementedError("the compile and HBM ledgers are not ported yet (ROADMAP queue A, observability)")
        if gen_cfg.num_beams > 1:
            raise NotImplementedError("beam search is not servable slot-wise")
        if gen_cfg.repetition_penalty != 1.0:
            raise NotImplementedError(
                "repetition_penalty requires per-slot seen-token tracking; "
                "not supported by the inference engine yet"
            )
        if kv_cache_dtype not in _KV_DTYPES:
            raise ValueError(f"kv_cache_dtype {kv_cache_dtype!r} not in {sorted(_KV_DTYPES)}")
        if decode_kernel not in ("auto", "pallas", "xla"):
            raise ValueError(f"decode_kernel {decode_kernel!r} not in ('auto', 'pallas', 'xla')")
        if params is not None:
            model.load_state_dict(params)
        self.model = model.eval()
        self.model_cfg = model_cfg
        self.gen_cfg = gen_cfg
        self.device = next(model.parameters()).device
        self.num_slots = int(num_slots)
        self.prompt_bucket = int(prompt_bucket)
        self.max_prompt_len = _round_up(int(max_prompt_len), self.prompt_bucket)
        self.max_prefill_batch = int(max_prefill_batch)
        self.max_len = self.max_prompt_len + gen_cfg.max_new_tokens
        self.spec_k = 0
        self.kv_paging = True
        self.kv_block_size = int(kv_block_size)
        self.prefix_cache = bool(prefix_cache)
        self.multi_tenant = False
        self.adapter_store = None
        self.session_store = None
        self.kv_cache_dtype = _KV_DTYPES[kv_cache_dtype] or model_cfg.dtype
        if model_cfg.pos_embed == "learned" and self.max_len > model_cfg.max_seq_len:
            raise ValueError(
                f"max_prompt_len {self.max_prompt_len} + max_new_tokens "
                f"{gen_cfg.max_new_tokens} exceeds the learned-position table "
                f"({model_cfg.max_seq_len})"
            )
        if self.kv_block_size < 1:
            raise ValueError("kv_block_size must be >= 1")
        # every slot's logical view spans n_tbl blocks
        self._cache_len = _round_up(self.max_len, self.kv_block_size)
        self._n_tbl = self._cache_len // self.kv_block_size
        # auto-size so every slot can hold a worst-case request, plus the
        # reserved zero block
        self._n_blocks = int(kv_pool_blocks) or (self.num_slots * self._n_tbl + 1)
        self._block_pool = BlockPool(
            self._n_blocks, self.kv_block_size,
            prefix_cache=self.prefix_cache, idle_capacity=int(prefix_cache_capacity),
        )
        self._slot_blocks: Dict[int, List[int]] = {}
        self._kv_lock = threading.RLock()
        # scheduler-owned trace buffer (see Scheduler._insert_batch)
        self.trace_buf: Optional[List] = None
        self._param_version = 0

        V, P, dev = model_cfg.vocab_size, self.num_slots, self.device
        self._suppress = None
        if gen_cfg.suppress_tokens:
            m = torch.zeros((V,), dtype=torch.float32)
            m[torch.as_tensor(gen_cfg.suppress_tokens, dtype=torch.long)] = -float("inf")
            self._suppress = m.to(dev)
        self._generator = torch.Generator(device=dev)
        self._generator.manual_seed(int(seed))
        long = dict(dtype=torch.long, device=dev)
        self._pool: Dict[str, Any] = {
            "layers": init_paged_kv_arena(
                model_cfg, self._n_blocks, self.kv_block_size, dtype=self.kv_cache_dtype, device=dev
            ),
            "mask": torch.zeros((P, self._cache_len), dtype=torch.int32, device=dev),
            "pos": torch.zeros((P,), **long),
            "row_index": torch.zeros((P,), **long),
            "step": torch.zeros((P,), **long),
            "active": torch.zeros((P,), **long),
            "max_new": torch.full((P,), gen_cfg.max_new_tokens, **long),
            "next_token": torch.full((P,), gen_cfg.pad_token_id, **long),
            "next_logprob": torch.zeros((P,), dtype=torch.float32, device=dev),
            # table entries default to the zero block
            "table": torch.zeros((P, self._n_tbl), dtype=torch.int32, device=dev),
        }
        self.decode_kernel = decode_kernel
        self._attn_kernel = self._resolve_attn_kernel()
        self._kv_kernel_dispatches = 0
        # {reason: count}; stays empty: the configs the JAX engine sends to
        # the gather path (alibi, sliding window) are refused at model build
        # (models/transformer.py:check_supported) until their families port
        self._kv_kernel_fallbacks: Dict[str, int] = {}
        self._decode_fn = self._make_decode()

    def _resolve_attn_kernel(self) -> Optional[str]:
        """Map the decode_kernel knob onto the attn_kernel value threaded
        into decode_step_rows: None (gather path) or "kernel" (the paged
        kernel; which implementation runs follows the arena's device)."""
        return None if self.decode_kernel == "xla" else "kernel"

    # ------------------------------------------------------------------
    # Params
    # ------------------------------------------------------------------

    def set_params(self, params) -> int:
        raise NotImplementedError(
            "checkpoint hot-reload is not ported yet (ROADMAP queue A, serving features)"
        )

    @property
    def param_version(self) -> int:
        return self._param_version

    @property
    def has_params(self) -> bool:
        return True

    # ------------------------------------------------------------------
    # Fused sampling
    # ------------------------------------------------------------------

    def _sample_fused(self, raw_logits, step):
        """suppress -> process_logits -> select_token over the raw f32
        logits, returning (token, policy logprob of the raw logits)."""
        scores = raw_logits
        if self._suppress is not None:
            scores = scores + self._suppress
        scores = process_logits(scores, self.gen_cfg, step)
        token = select_token(scores, self._generator, self.gen_cfg)
        return token, sampled_token_logprob(raw_logits, token)

    # ------------------------------------------------------------------
    # Prefill + insert
    # ------------------------------------------------------------------

    def _get_paged_insert(self, pb: int, plen: int) -> Callable:
        """Paged prefill+insert for one (rows, suffix-width) bucket: one
        `prefill_rows` call writes each row's right-padded prompt suffix
        straight into the shared arena through its fresh block table,
        rows behind a cached prefix resume at column `shared_len`, and the
        first token is drawn from the last valid position's logits."""
        model, S = self.model, self._cache_len
        pool = self._pool

        def insert(n_real, ids, tmask, tables, slot_ids, max_new, shared_len):
            dev = ids.device
            seed_mask = (torch.arange(S, device=dev)[None, :] < shared_len[:, None]).to(torch.int32)
            cache = {
                "layers": [dict(al, table=tables) for al in pool["layers"]],
                "mask": seed_mask,
                "pos": shared_len,
                "row_index": shared_len,
            }
            logits, new_cache = model.prefill_rows(ids, cache, tmask)
            # per-row LAST-valid-position logits (right padding)
            lens = tmask.sum(-1)
            last_idx = torch.clamp(lens - 1, 0, plen - 1)
            last = logits[torch.arange(pb, device=dev), last_idx].float()
            token, lp = self._sample_fused(last, 0)
            # padding rows (the trailing pb - n_real, slot_id == num_slots)
            # are sliced off: the JAX engine's out-of-bounds scatters drop them
            sl = slot_ids[:n_real]
            pool["table"][sl] = tables[:n_real]
            pool["mask"][sl] = new_cache["mask"][:n_real]
            pool["pos"][sl] = new_cache["pos"][:n_real]
            pool["row_index"][sl] = new_cache["row_index"][:n_real]
            pool["step"][sl] = 0
            pool["active"][sl] = 1
            pool["max_new"][sl] = max_new[:n_real]
            pool["next_token"][sl] = token[:n_real]
            pool["next_logprob"][sl] = lp[:n_real]

        return insert

    def _insert_requests_impl(self, rows: Sequence[Tuple], slot_ids: Sequence[int],
                              sessions: Optional[Sequence] = None) -> None:
        """Prefill `rows` ((prompt ids, max_new) pairs) into the given free
        slots: block allocation + prefix-store probing + right-padded
        suffix prefill."""
        if len(rows) != len(slot_ids):
            raise ValueError(f"{len(rows)} rows for {len(slot_ids)} slots")
        if sessions is not None and any(s is not None for s in sessions):
            raise NotImplementedError("chat sessions are not ported yet (ROADMAP queue A, serving features)")
        norm = []
        for row in rows:
            if len(row) == 3 and row[2] is not None:
                raise NotImplementedError("adapter_id needs multi-tenant serving, not ported yet")
            norm.append((row[0], row[1], None))
        self._insert_paged(norm, slot_ids)

    def _check_row(self, ids, max_new: int) -> np.ndarray:
        ids = np.asarray(ids, np.int32).reshape(-1)
        if ids.size == 0 or ids.size > self.max_prompt_len:
            raise ValueError(f"prompt length {ids.size} outside (0, {self.max_prompt_len}]")
        if not 0 < max_new <= self.gen_cfg.max_new_tokens:
            raise ValueError(f"max_new_tokens {max_new} outside (0, {self.gen_cfg.max_new_tokens}]")
        return ids

    def _insert_paged(self, rows, slot_ids) -> None:
        """Allocate each request's blocks up front (prompt + max_new — no
        mid-decode OOM, no preemption), probing the prefix store for
        resident leading blocks first. Requests whose probe would hit keys
        registered earlier in this call are deferred one placement round
        (the registering prefill has not run yet). On pool exhaustion the
        whole call rolls back so the scheduler can requeue the batch."""
        bs, pool = self.kv_block_size, self._block_pool
        pending = [
            (self._check_row(ids, max_new), int(max_new), int(slot))
            for (ids, max_new, _name), slot in zip(rows, slot_ids)
        ]
        rounds: List[List] = []
        journal: List[Tuple[int, List[int], List[bytes]]] = []
        t_alloc0 = time.monotonic() if self.trace_buf is not None else 0.0
        with self._kv_lock:
            try:
                while pending:
                    placed, deferred = [], []
                    round_keys: set = set()
                    for ids, max_new, slot in pending:
                        keys = prefix_keys(ids, bs, b"") if self.prefix_cache else []
                        if any(k in round_keys for k in keys):
                            deferred.append((ids, max_new, slot))
                            continue
                        shared = []
                        for key in keys:
                            blk = pool.acquire_cached(key)
                            if blk is None:
                                break
                            shared.append(blk)
                        if keys:
                            if shared:
                                pool.hits += 1
                            else:
                                pool.misses += 1
                        n_cap = -(-(ids.size + max_new) // bs)
                        try:
                            owned = pool.alloc(n_cap - len(shared))
                        except KVPoolExhaustedError:
                            pool.release(shared)
                            raise
                        blocks = shared + owned
                        registered: List[bytes] = []
                        for j in range(len(shared), len(keys)):
                            pool.register(keys[j], blocks[j])
                            round_keys.add(keys[j])
                            registered.append(keys[j])
                        self._slot_blocks[slot] = blocks
                        journal.append((slot, blocks, registered))
                        T = len(shared) * bs
                        placed.append((ids[T:], T, blocks, max_new, slot))
                    rounds.append(placed)
                    pending = deferred
            except KVPoolExhaustedError:
                for slot, blocks, registered in journal:
                    for key in registered:
                        pool.unregister(key)
                    pool.release(blocks)
                    self._slot_blocks.pop(slot, None)
                raise
        if self.trace_buf is not None:
            self.trace_buf.append((
                "block_alloc", t_alloc0, time.monotonic(),
                {"rounds": len(rounds), "requests": len(slot_ids)},
            ))
        for placed in rounds:
            self._flush_paged(placed)

    def _flush_paged(self, placed) -> None:
        """Run one placement round's prefills, grouped by suffix-width
        bucket and chunked to `max_prefill_batch`."""
        pad_id = self.gen_cfg.pad_token_id
        groups: Dict[int, List] = {}
        for item in placed:
            plen = _round_up(len(item[0]), self.prompt_bucket)
            groups.setdefault(plen, []).append(item)
        for plen, members in groups.items():
            for i in range(0, len(members), self.max_prefill_batch):
                chunk = members[i : i + self.max_prefill_batch]
                pb = _pow2_bucket(len(chunk), self.max_prefill_batch)
                ids_arr = np.full((pb, plen), pad_id, np.int64)
                tmask = np.zeros((pb, plen), np.int32)
                tables = np.full((pb, self._n_tbl), self._n_blocks, np.int32)
                slots_arr = np.full((pb,), self.num_slots, np.int64)
                max_new_arr = np.full((pb,), self.gen_cfg.max_new_tokens, np.int64)
                shared_arr = np.zeros((pb,), np.int64)
                for j, (suffix, T, blocks, max_new, slot) in enumerate(chunk):
                    ids_arr[j, : len(suffix)] = suffix  # RIGHT-padded
                    tmask[j, : len(suffix)] = 1
                    tables[j, : len(blocks)] = blocks
                    tables[j, len(blocks):] = 0  # zero-block padding
                    slots_arr[j] = slot
                    max_new_arr[j] = max_new
                    shared_arr[j] = T
                # padding rows repeat row 0's tokens but keep all-out-of-range
                # tables and slot ids: every write they make is masked out
                ids_arr[len(chunk):] = ids_arr[0]
                tmask[len(chunk):] = tmask[0]
                dev = self.device
                t0 = time.monotonic() if self.trace_buf is not None else 0.0
                self._get_paged_insert(pb, plen)(
                    len(chunk),
                    torch.from_numpy(ids_arr).to(dev), torch.from_numpy(tmask).to(dev),
                    torch.from_numpy(tables).to(dev), torch.from_numpy(slots_arr).to(dev),
                    torch.from_numpy(max_new_arr).to(dev), torch.from_numpy(shared_arr).to(dev),
                )
                if self.trace_buf is not None:
                    self.trace_buf.append((
                        "prefill_bucket", t0, time.monotonic(),
                        {"bucket": plen, "rows": len(chunk)},
                    ))

    # ------------------------------------------------------------------
    # Decode
    # ------------------------------------------------------------------

    def _make_decode(self) -> Callable:
        model, gen_cfg, pool = self.model, self.gen_cfg, self._pool
        pad, eos = gen_cfg.pad_token_id, gen_cfg.eos_token_id
        ak = self._attn_kernel  # the fused paged read path, or None for the gather path

        def decode():
            active = pool["active"].bool()
            # emit the token the previous call (insert or decode) already sampled
            token = torch.where(active, pool["next_token"], torch.full_like(pool["next_token"], pad))
            logprob = pool["next_logprob"]
            finished = active & ((token == eos) | (pool["step"] + 1 >= pool["max_new"]))
            cache = {k: pool[k] for k in ("mask", "pos", "row_index")}
            # every layer reads through the slot block tables
            cache["layers"] = [dict(al, table=pool["table"]) for al in pool["layers"]]
            logits, new_cache = model.decode_step_rows(
                token[:, None], cache, active.to(torch.int32)[:, None], attn_kernel=ak
            )
            new_step = pool["step"] + active.long()
            nxt, nxt_lp = self._sample_fused(logits[:, -1].float(), new_step)
            pool.update(
                mask=new_cache["mask"], pos=new_cache["pos"], row_index=new_cache["row_index"],
                next_token=nxt, next_logprob=nxt_lp, step=new_step,
                active=pool["active"] * (1 - finished.long()),
            )
            return token, logprob, active, finished

        return decode

    def insert_requests(self, *args, **kwargs) -> None:
        """See `_insert_requests_impl`."""
        with torch.no_grad():
            self._insert_requests_impl(*args, **kwargs)

    def step(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """See `_step_impl`."""
        with torch.no_grad():
            return self._step_impl()

    def _step_impl(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Advance every active slot. Returns host arrays (tokens [P],
        logprobs [P] f32, emitted [P] bool, finished [P] bool); finished
        slots are already deactivated in the pool."""
        if self._attn_kernel is not None:
            self._kv_kernel_dispatches += 1
        token, logprob, valid, finished = self._decode_fn()
        ints = torch.stack([token, valid.long(), finished.long()]).cpu().numpy()
        return (
            ints[0].astype(np.int32),
            logprob.cpu().numpy().astype(np.float32),
            ints[1].astype(bool),
            ints[2].astype(bool),
        )

    def release_slots(self, slots: Sequence[int]) -> None:
        """Deactivate slots host-side (deadline cancel / shutdown)."""
        if not len(slots):
            return
        idx = torch.as_tensor(np.asarray(slots, np.int64), device=self.device)
        with torch.no_grad():
            self._pool["active"][idx] = 0
        self.reclaim_slots(slots)

    def reclaim_slots(self, slots: Sequence[int]) -> None:
        """Return a finished slot's blocks to the pool (host bookkeeping
        only; a freed slot's stale table is harmless because inactive
        rows' arena writes are masked out). Idempotent."""
        with self._kv_lock:
            for slot in slots:
                blocks = self._slot_blocks.pop(int(slot), None)
                if blocks:
                    self._block_pool.release(blocks)

    # ------------------------------------------------------------------
    # Paged-pool accounting (admission + metrics)
    # ------------------------------------------------------------------

    def projected_blocks(self, prompt_ids, max_new_tokens: int, ignore_cache: bool = False,
                         adapter_id: Optional[str] = None, session=None) -> int:
        """Blocks this request would claim if admitted now:
        ceil((prompt + max_new) / block_size) minus the leading blocks a
        read-only prefix-store probe says are resident."""
        ids = np.asarray(prompt_ids, np.int32).reshape(-1)
        n_cap = -(-(ids.size + int(max_new_tokens)) // self.kv_block_size)
        with self._kv_lock:
            shared = 0 if ignore_cache else self._block_pool.lookup_chain(ids, b"")
        return max(1, n_cap - shared)

    def blocks_available(self) -> int:
        """Blocks a new request can claim: free + evictable idle."""
        with self._kv_lock:
            return self._block_pool.available()

    @property
    def total_blocks(self) -> int:
        """Allocatable blocks (zero block excluded)."""
        return self._block_pool.total

    def kv_stats(self) -> Dict[str, Any]:
        """Host-side paged-pool counters for metrics/healthz.
        `kv_kernel_fallbacks` is a {reason: count} dict; everything else
        is an int."""
        cfg = self.model_cfg
        kv_bytes = kv_arena_bytes(
            cfg.n_layers, cfg.kv_heads, cfg.head_dim, self._n_blocks,
            self.kv_block_size, self.kv_cache_dtype,
        )
        with self._kv_lock:
            pool = self._block_pool
            return {
                "kv_blocks_total": pool.total,
                "kv_blocks_free": pool.available(),
                "kv_blocks_used": pool.in_use(),
                "kv_pool_bytes": int(kv_bytes),
                "prefix_cache_hits": pool.hits,
                "prefix_cache_misses": pool.misses,
                "prefix_cache_evictions": pool.evictions,
                "prefix_cache_idle_blocks": pool.cached_idle(),
                "kv_kernel_dispatches": self._kv_kernel_dispatches,
                "kv_kernel_fallbacks": dict(self._kv_kernel_fallbacks),
            }

    @property
    def active_slots(self) -> int:
        return int(self._pool["active"].sum().item())
