"""Continuous-batching inference engine over a slot-based KV-cache pool.

Port of the JAX package's `inference/engine.py`. Slots hold requests in
flight. The pool is one of two layouts:

- fixed-slot (`kv_paging=False`, the default): `num_slots` rows of the
  model's dense cache (`models/transformer.py:init_kv_cache`). A request
  prefills LEFT-padded into a cache of its own (`decode_step`, one call
  per (rows, prompt-width) bucket) whose rows are copied into its slot;
- paged (`kv_paging=True`): each slot's KV lives in blocks of a global
  per-layer arena, named through the slot's block table. A request's
  blocks are allocated up front (prompt + max_new + spec_k), the prefix
  store is probed when it is on, a chat session's retained blocks seed
  the shared prefix, and one `prefill_rows` call per (rows, suffix-width)
  bucket writes the RIGHT-padded prompt straight into the arena.

The first token is drawn in the insert call. Per decode dispatch
(`step`): one `decode_step_rows` call over every slot, each active slot
emitting its pre-sampled token and drawing the next; or, with `spec_k >
0`, one speculative round (spec_k + 1 trunk draft steps, one batched
suffix verify, the longest accepted prefix plus a correction token).

PyTorch runs eagerly, so there are no per-bucket compiled programs; the
buckets and padding rows are kept so the arithmetic (and the arena
traffic) matches the JAX engine's. The pool tensors are updated in place
where the JAX engine scattered functionally into a donated pool. Writes
the JAX scatters drop as out of bounds (padding rows with `slot_id ==
num_slots` and all-out-of-range tables, right pad, inactive slots, mask
columns past the cache) are masked out explicitly: padding rows are
sliced off before the pool writes and their arena writes land in the
arena's spare block (`models/transformer.py:init_paged_kv_arena`).

The `decode_kernel` knob keeps its values: "xla" selects the gather read
path; "auto" and "pallas" select the paged-attention kernel (the CUDA
kernel for a model on a cuda device, its plain PyTorch version on the
CPU; `ops/paged_attention.py` dispatches on the tensor's device). The
fixed-slot pool has no kernel, as in JAX: each of its decode dispatches
is counted as a `kv_paging_off` fallback, and so is each decode dispatch
of an ALiBi model (`alibi`) or one with a sliding window
(`sliding_window`), whose bias terms the kernel does not express: they
read through the gather path. Speculative dispatches over the
arena run the t = 1 draft steps through the kernel and count a
`spec_verify_rows` fallback for the batched verify, which takes the
gather path.

A LoRA policy is served as any other (merged or not); prompt and prefix
tuning are refused with the JAX engine's message, and so is an
encoder-decoder (the JAX engine serves causal LMs only).

Multi-tenant serving (`multi_tenant=True` with an `AdapterStore`,
`inference/adapters.py`): many tenants' LoRA adapters over the one trunk.
A row names its adapter as the third element of its insert row; the
engine pins it in the store for the request's life (released in
`reclaim_slots`), and every prefill and decode dispatch gathers each
row's factor pair from the store's stack by the row's slot there
(`pool["adapter"]`, 0 = the base policy's zeros) and runs the model
inside `models/transformer.py:lora_rows`. Paged prefix-cache keys are
salted by adapter, so K/V never crosses tenants. Speculative decode is
refused under it, as in JAX (the draft head is one policy's).

Not ported yet (raises `NotImplementedError`): the compile and HBM
ledgers (ROADMAP queue A, item 4.7, observability).

Thread safety: device-touching methods are called from ONE loop thread
(the scheduler loop). `set_params` may be called from any thread (the
checkpoint watcher): it loads the weights into a copy of the module and
swaps that in under `_param_lock`, which every insert and decode
dispatch holds. The block pool and the session store are guarded by
`_kv_lock`.
"""

import contextlib
import copy
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from trlx_tpu_torch.inference.adapters import adapter_salt
from trlx_tpu_torch.inference.paging import BlockPool, KVPoolExhaustedError, prefix_keys
from trlx_tpu_torch.models.lora import is_lora_name
from trlx_tpu_torch.models.transformer import init_kv_cache, init_paged_kv_arena, lora_rows
from trlx_tpu_torch.ops.sampling import (
    GenerationConfig,
    process_logits,
    sampled_token_logprob,
    select_token,
    spec_draft_head_from_params,
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

    :param model: a module exposing `prefill_rows`, `decode_step_rows` and
        an `lm` (`TransformerLM`: `decode_step`, `spec_draft_step`,
        `spec_verify_rows`), as `CausalLMWithValueHead` does; it runs on
        the device its parameters are on.
    :param params: a state dict to load into `model`, or None to serve
        the weights it holds.
    :param gen_cfg: engine-wide sampling knobs; per-request overrides are
        limited to `max_new_tokens` (<= the engine's, which sizes the
        cache).
    :param spec_k: drafted tokens per speculative round (0 = plain
        decode); the trunk below `spec_split` drafts through a rank
        `spec_draft_rank` readout of the unembedding.
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
        spec_split: int = 0,
        spec_draft_rank: int = 64,
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
        if compile_ledger is not None or hbm_ledger is not None:
            raise NotImplementedError(
                "the compile and HBM ledgers are not ported yet (ROADMAP queue A, item 4, observability)"
            )
        if getattr(model_cfg, "is_seq2seq", False):
            raise NotImplementedError("the continuous-batching engine serves causal LMs only")
        if multi_tenant:
            if adapter_store is None:
                raise ValueError("multi_tenant serving needs an AdapterStore")
            if spec_k > 0:
                raise NotImplementedError(
                    "speculative decode under multi-tenant adapters is unsupported (the draft head is per-policy)"
                )
            if model_cfg.lora_rank <= 0:
                raise ValueError("multi_tenant serving needs a LoRA-enabled policy (cfg.lora_rank > 0)")
        if spec_k > 0 and spec_split <= 0:
            raise ValueError("speculative decode needs a hydra split > 0 (the frozen trunk is the draft model)")
        if spec_k > 0 and model_cfg.moe_experts > 0:
            raise NotImplementedError("speculative decode under MoE routing is unsupported")
        if model_cfg.prompt_tokens > 0 or model_cfg.prefix_tokens > 0:
            raise NotImplementedError("slot-pool decode under prompt/prefix tuning is unsupported")
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
        self._lm = getattr(model, "lm", model)
        self.model_cfg = model_cfg
        self.gen_cfg = gen_cfg
        self.device = next(model.parameters()).device
        self.num_slots = int(num_slots)
        self.prompt_bucket = int(prompt_bucket)
        self.max_prompt_len = _round_up(int(max_prompt_len), self.prompt_bucket)
        self.max_prefill_batch = int(max_prefill_batch)
        self.max_len = self.max_prompt_len + gen_cfg.max_new_tokens
        self.spec_k = int(spec_k)
        self.spec_split = int(spec_split)
        self.spec_draft_rank = int(spec_draft_rank)
        self.kv_paging = bool(kv_paging)
        self.kv_block_size = int(kv_block_size)
        self.prefix_cache = bool(prefix_cache) and self.kv_paging
        self.multi_tenant = bool(multi_tenant)
        self.adapter_store = adapter_store if self.multi_tenant else None
        if self.adapter_store is not None:
            # store-internal LRU eviction can later re-load an adapter whose
            # checkpoint moved while it was out: the store calls back so
            # that adapter's salted prefix blocks flush on load
            self.adapter_store.flush_prefixes = self.flush_adapter_prefixes
        # slot -> adapter name for requests in flight (store pin held)
        self._slot_adapter: Dict[int, Optional[str]] = {}
        self._lora_modules = self._find_lora_modules(self.model) if self.multi_tenant else []
        self.kv_cache_dtype = _KV_DTYPES[kv_cache_dtype] or model_cfg.dtype
        if self.kv_cache_dtype == torch.int8 and not self.kv_paging:
            raise NotImplementedError("int8 KV cache requires kv_paging")
        if prefix_cache and not kv_paging:
            raise ValueError("prefix_cache requires kv_paging")
        if model_cfg.pos_embed == "learned" and self.max_len + self.spec_k > model_cfg.max_seq_len:
            raise ValueError(
                f"max_prompt_len {self.max_prompt_len} + max_new_tokens "
                f"{gen_cfg.max_new_tokens} + spec_k {self.spec_k} exceeds the "
                f"learned-position table ({model_cfg.max_seq_len})"
            )
        # a speculative round may write spec_k cache rows past a slot's
        # budget before the rollback clears them: the pool gets the slack
        self._cache_len = self.max_len + self.spec_k
        # the block pool and the session store share this re-entrant lock
        # (the insert path calls back into the store while holding it)
        self._kv_lock = threading.RLock()
        self._block_pool = None
        if self.kv_paging:
            if self.kv_block_size < 1:
                raise ValueError("kv_block_size must be >= 1")
            # every slot's logical view spans n_tbl blocks
            self._cache_len = _round_up(self._cache_len, self.kv_block_size)
            self._n_tbl = self._cache_len // self.kv_block_size
            # auto-size so every slot can hold a worst-case request, plus
            # the reserved zero block
            self._n_blocks = int(kv_pool_blocks) or (self.num_slots * self._n_tbl + 1)
            self._block_pool = BlockPool(
                self._n_blocks, self.kv_block_size,
                prefix_cache=self.prefix_cache, idle_capacity=int(prefix_cache_capacity),
            )
            self._slot_blocks: Dict[int, List[int]] = {}
        # multi-turn chat: retained-block registry (enable_sessions)
        self.session_store = None
        # scheduler-owned trace buffer (see Scheduler._insert_batch)
        self.trace_buf: Optional[List] = None
        self._param_lock = threading.Lock()
        self._param_version = 0
        self._spec_head = self._build_spec_head(model.state_dict()) if self.spec_k > 0 else None

        V, P, dev = model_cfg.vocab_size, self.num_slots, self.device
        self._suppress = None
        if gen_cfg.suppress_tokens:
            m = torch.zeros((V,), dtype=torch.float32)
            m[torch.as_tensor(gen_cfg.suppress_tokens, dtype=torch.long)] = -float("inf")
            self._suppress = m.to(dev)
        self._generator = torch.Generator(device=dev)
        self._generator.manual_seed(int(seed))
        long = dict(dtype=torch.long, device=dev)
        if self.kv_paging:
            layers = init_paged_kv_arena(
                model_cfg, self._n_blocks, self.kv_block_size, dtype=self.kv_cache_dtype, device=dev
            )
        else:
            # "auto" resolves to cfg.dtype; f32/bf16 re-type the fixed rows
            layers = init_kv_cache(model_cfg, P, self._cache_len, dtype=self.kv_cache_dtype, device=dev)["layers"]
        self._pool: Dict[str, Any] = {
            "layers": layers,
            "mask": torch.zeros((P, self._cache_len), dtype=torch.int32, device=dev),
            "pos": torch.zeros((P,), **long),
            "row_index": torch.zeros((P,), **long),
            "step": torch.zeros((P,), **long),
            "active": torch.zeros((P,), **long),
            "max_new": torch.full((P,), gen_cfg.max_new_tokens, **long),
            "next_token": torch.full((P,), gen_cfg.pad_token_id, **long),
            "next_logprob": torch.zeros((P,), dtype=torch.float32, device=dev),
        }
        if self.kv_paging:
            # table entries default to the zero block
            self._pool["table"] = torch.zeros((P, self._n_tbl), dtype=torch.int32, device=dev)
        if self.multi_tenant:
            # each slot's row in the adapter stack (0 = base), gathered by
            # every decode dispatch
            self._pool["adapter"] = torch.zeros((P,), **long)
        self.decode_kernel = decode_kernel
        self._attn_kernel = self._resolve_attn_kernel()
        # engine-static reason the paged kernel cannot serve this pool,
        # counted once per decode dispatch (the JAX engine's own fallback:
        # the kernel expresses no ALiBi or window term, as the Pallas
        # kernel does not)
        self._kernel_unsupported = self._kernel_unsupported_reason()
        self._kv_kernel_dispatches = 0
        self._kv_kernel_fallbacks: Dict[str, int] = {}
        self._decode_fn = self._make_spec_decode() if self.spec_k > 0 else self._make_decode()

    def _kernel_unsupported_reason(self) -> Optional[str]:
        """Engine-static reason the paged decode kernel cannot serve this
        config (counted once per decode dispatch), or None."""
        if not self.kv_paging:
            return "kv_paging_off"
        if self.model_cfg.alibi:
            return "alibi"
        if self.model_cfg.sliding_window is not None:
            return "sliding_window"
        return None

    def _resolve_attn_kernel(self) -> Optional[str]:
        """Map the decode_kernel knob onto the attn_kernel value threaded
        into decode_step_rows: None (gather path) or "kernel" (the paged
        kernel; which implementation runs follows the arena's device)."""
        return None if self.decode_kernel == "xla" else "kernel"

    # ------------------------------------------------------------------
    # Params (checkpoint hot-reload)
    # ------------------------------------------------------------------

    def check_params(self, params) -> None:
        """Raise ValueError unless `params` names exactly the served
        module's tensors, each at its shape."""
        want = {k: tuple(v.shape) for k, v in self.model.state_dict().items()}
        got = {k: tuple(getattr(v, "shape", ())) for k, v in params.items()}
        faults = {
            "missing": sorted(want.keys() - got.keys()),
            "unexpected": sorted(got.keys() - want.keys()),
            "reshaped": [f"{k} {got[k]} != {want[k]}" for k in sorted(want.keys() & got.keys()) if want[k] != got[k]],
        }
        if any(faults.values()):
            raise ValueError("params do not fit the served model: "
                             + "; ".join(f"{what} {keys[:4]}" for what, keys in faults.items() if keys))

    def set_params(self, params) -> int:
        """Swap the served weights (a state dict of `model`). The new
        weights load into a copy of the module, so a state dict that does
        not fit (`check_params`) changes nothing, and the module the
        engine was built on (a trainer's policy) is never written.
        In-flight requests continue on the new weights from their next
        dispatch; the KV cache keeps the old prefix's keys and values.
        Cached prefixes and every session's retained blocks were written
        under the old weights: they are flushed, and each session answers
        its next turn with a reset. Under speculative decode the draft
        head is rebuilt from the new unembedding. Returns the new param
        version."""
        self.check_params(params)
        staged = copy.deepcopy(self.model)
        with torch.no_grad():
            staged.load_state_dict(params)
        head = self._build_spec_head(params) if self.spec_k > 0 else None
        if self.prefix_cache:
            with self._kv_lock:
                self._block_pool.flush_cached()
        if self.session_store is not None:
            self.session_store.invalidate_all("weights_updated")
        lora_modules = self._find_lora_modules(staged) if self.multi_tenant else []
        with self._param_lock:
            self.model, self._lm = staged, getattr(staged, "lm", staged)
            self._lora_modules = lora_modules
            self._decode_fn = self._make_spec_decode() if self.spec_k > 0 else self._make_decode()
            self._spec_head = head
            self._param_version += 1
            return self._param_version

    def _build_spec_head(self, params):
        """The low-rank draft readout (A, B) on the device at cfg.dtype."""
        a, b = spec_draft_head_from_params(params, self.model_cfg, self.spec_draft_rank)
        dtype = self.model_cfg.dtype
        return (torch.as_tensor(a, device=self.device).to(dtype),
                torch.as_tensor(b, device=self.device).to(dtype))

    @property
    def param_version(self) -> int:
        return self._param_version

    @property
    def has_params(self) -> bool:
        """Whether the engine holds weights (readiness): until `release`."""
        return self.model is not None

    def release(self) -> None:
        """Drop the engine's device state: the KV pool, the module (its own
        copy after a `set_params`, else its reference to the module it was
        built on), the draft head and the suppression mask. Called once
        its scheduler has stopped; the engine serves nothing afterwards."""
        with self._param_lock:
            self._pool = None
            self.model = self._lm = None
            self._decode_fn = None
            self._spec_head = self._suppress = None

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

    def _dense_insert(self, n_real, ids, mask, slot_ids, max_new, aidx) -> None:
        """Fixed-slot prefill+insert for one (rows, prompt-width) bucket:
        `decode_step` prefills the LEFT-padded prompts into a cache of
        their own (at cfg.dtype, as the JAX engine's prefill program), the
        first token is drawn from the last column's logits, and the rows
        are copied into their slots (re-typed to the pool's dtype)."""
        pool, S = self._pool, self._cache_len
        cache = init_kv_cache(self.model_cfg, ids.shape[0], S, device=ids.device)
        # the prompt's K/V carry each row's own adapter
        with self._adapters(aidx):
            logits, _, new_cache = self._lm.decode_step(ids, cache, mask, is_prefill=True)
        token, lp = self._sample_fused(logits[:, -1].float(), 0)
        # padding rows (the trailing pb - n_real, slot_id == num_slots) are
        # sliced off: the JAX engine's out-of-bounds scatters drop them
        sl = slot_ids[:n_real]
        for pl, cl in zip(pool["layers"], new_cache["layers"]):
            pl["k"][sl] = cl["k"][:n_real].to(pl["k"].dtype)
            pl["v"][sl] = cl["v"][:n_real].to(pl["v"].dtype)
        pool["mask"][sl] = new_cache["mask"][:n_real]
        pool["pos"][sl] = new_cache["pos"][:n_real]
        pool["row_index"][sl] = new_cache["index"]
        pool["step"][sl] = 0
        pool["active"][sl] = 1
        pool["max_new"][sl] = max_new[:n_real]
        pool["next_token"][sl] = token[:n_real]
        pool["next_logprob"][sl] = lp[:n_real]
        if self.multi_tenant:
            pool["adapter"][sl] = aidx[:n_real]

    def _paged_insert(self, n_real, ids, tmask, tables, slot_ids, max_new, shared_len, aidx) -> None:
        """Paged prefill+insert for one (rows, suffix-width) bucket: one
        `prefill_rows` call writes each row's right-padded prompt suffix
        straight into the shared arena through its fresh block table,
        rows behind a cached prefix (or a session's retained blocks)
        resume at column `shared_len`, and the first token is drawn from
        the last valid position's logits."""
        pool, S = self._pool, self._cache_len
        pb, plen = ids.shape
        dev = ids.device
        seed_mask = (torch.arange(S, device=dev)[None, :] < shared_len[:, None]).to(torch.int32)
        cache = {
            "layers": [dict(al, table=tables) for al in pool["layers"]],
            "mask": seed_mask,
            "pos": shared_len,
            "row_index": shared_len,
        }
        with self._adapters(aidx):
            logits, new_cache = self.model.prefill_rows(ids, cache, tmask)
        # per-row LAST-valid-position logits (right padding)
        lens = tmask.sum(-1)
        last_idx = torch.clamp(lens - 1, 0, plen - 1)
        last = logits[torch.arange(pb, device=dev), last_idx].float()
        token, lp = self._sample_fused(last, 0)
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
        if self.multi_tenant:
            pool["adapter"][sl] = aidx[:n_real]

    def _insert_requests_impl(self, rows: Sequence[Tuple], slot_ids: Sequence[int],
                              sessions: Optional[Sequence] = None) -> None:
        """Prefill `rows` ((prompt ids, max_new[, adapter_id])) into the
        given free slots: length-bucketed left-padded prefills into the
        fixed-slot pool, or (paged) block allocation, prefix-store probing
        and right-padded suffix prefills. Under multi-tenant serving each
        row's adapter is pinned in the store for the request's life and
        its prefill applies that adapter's factors. `sessions` (paged
        only) attaches a row to a chat session: its retained blocks seed
        the shared prefix, so only the conversation's delta tokens
        prefill."""
        if len(rows) != len(slot_ids):
            raise ValueError(f"{len(rows)} rows for {len(slot_ids)} slots")
        if sessions is not None and any(s is not None for s in sessions):
            if not self.kv_paging:
                raise ValueError("sessions require kv_paging")
        else:
            sessions = None
        norm = [(row[0], row[1], row[2] if len(row) == 3 else None) for row in rows]
        if not self.multi_tenant and any(name is not None for _, _, name in norm):
            raise ValueError("adapter_id requires an engine built with inference.multi_tenant")
        aslots = self._acquire_adapters(norm, slot_ids) if self.multi_tenant else [0] * len(norm)
        try:
            with self._param_lock:
                if self.kv_paging:
                    self._insert_paged(norm, slot_ids, aslots, sessions)
                else:
                    self._insert_dense(norm, slot_ids, aslots)
        except Exception:
            if self.multi_tenant:
                self._release_adapters(slot_ids)
            raise

    def _acquire_adapters(self, norm, slot_ids) -> List[int]:
        """Pin every row's adapter (loading on demand) and return their
        stack slots. All or nothing: a capacity failure releases the pins
        already taken, so the scheduler can retry with a smaller batch (it
        sheds distinct-adapter groups until the rest fit)."""
        aslots: List[int] = []
        acquired: List[Tuple[int, Optional[str]]] = []
        try:
            for (_ids, _max_new, name), slot in zip(norm, slot_ids):
                t0 = time.monotonic() if self.trace_buf is not None else 0.0
                aslots.append(self.adapter_store.acquire(name))
                if self.trace_buf is not None:
                    self.trace_buf.append(("adapter_load", t0, time.monotonic(), {"adapter": name or "base"}))
                acquired.append((int(slot), name))
        except Exception:
            for _, name in acquired:
                self.adapter_store.release(name)
            raise
        for slot, name in acquired:
            self._slot_adapter[slot] = name
        return aslots

    def _release_adapters(self, slots) -> None:
        for slot in slots:
            if int(slot) in self._slot_adapter:
                self.adapter_store.release(self._slot_adapter.pop(int(slot)))

    @staticmethod
    def _find_lora_modules(model) -> List[Tuple[Any, str, str]]:
        """(module, its lora_a name, its lora_b name) for every LoRA
        `Linear` of `model`, named as in its state dict (the store's
        leaf names)."""
        out = []
        for name in model.state_dict():
            if is_lora_name(name) and name.endswith(".lora_a"):
                base = name[: -len(".lora_a")]
                out.append((model.get_submodule(base), name, base + ".lora_b"))
        return out

    def _adapters(self, aidx: Optional[torch.Tensor]):
        """A `lora_rows` block handing every LoRA `Linear` row i's factor
        pair, gathered from the store's stack at aidx[i]; a null block
        when single-tenant."""
        if not self.multi_tenant:
            return contextlib.nullcontext()
        stack = self.adapter_store.stacked()
        return lora_rows({mod: (stack[a][aidx], stack[b][aidx]) for mod, a, b in self._lora_modules})

    def _insert_dense(self, rows, slot_ids, aslots) -> None:
        pad_id = self.gen_cfg.pad_token_id
        groups: Dict[int, List[Tuple[np.ndarray, int, int, int]]] = {}
        for (ids, max_new, _name), slot, aslot in zip(rows, slot_ids, aslots):
            ids = self._check_row(ids, max_new)
            plen = _round_up(ids.size, self.prompt_bucket)
            groups.setdefault(plen, []).append((ids, int(max_new), int(slot), int(aslot)))
        dev = self.device
        for plen, members in groups.items():
            for i in range(0, len(members), self.max_prefill_batch):
                chunk = members[i : i + self.max_prefill_batch]
                pb = _pow2_bucket(len(chunk), self.max_prefill_batch)
                ids_arr = np.full((pb, plen), pad_id, np.int64)
                mask_arr = np.zeros((pb, plen), np.int32)
                slots_arr = np.full((pb,), self.num_slots, np.int64)
                max_new_arr = np.full((pb,), self.gen_cfg.max_new_tokens, np.int64)
                aidx_arr = np.zeros((pb,), np.int64)  # padding rows gather base
                for j, (ids, max_new, slot, aslot) in enumerate(chunk):
                    ids_arr[j, plen - ids.size :] = ids  # LEFT-padded (decode convention)
                    mask_arr[j, plen - ids.size :] = 1
                    slots_arr[j] = slot
                    max_new_arr[j] = max_new
                    aidx_arr[j] = aslot
                # padding rows repeat row 0 (a real prompt: no fully masked
                # row) and are sliced off before the pool writes
                ids_arr[len(chunk):] = ids_arr[0]
                mask_arr[len(chunk):] = mask_arr[0]
                t0 = time.monotonic() if self.trace_buf is not None else 0.0
                self._dense_insert(
                    len(chunk),
                    torch.from_numpy(ids_arr).to(dev), torch.from_numpy(mask_arr).to(dev),
                    torch.from_numpy(slots_arr).to(dev), torch.from_numpy(max_new_arr).to(dev),
                    torch.from_numpy(aidx_arr).to(dev),
                )
                if self.trace_buf is not None:
                    self.trace_buf.append((
                        "prefill_bucket", t0, time.monotonic(),
                        {"bucket": plen, "rows": len(chunk)},
                    ))

    def _check_row(self, ids, max_new: int) -> np.ndarray:
        ids = np.asarray(ids, np.int32).reshape(-1)
        if ids.size == 0 or ids.size > self.max_prompt_len:
            raise ValueError(f"prompt length {ids.size} outside (0, {self.max_prompt_len}]")
        if not 0 < max_new <= self.gen_cfg.max_new_tokens:
            raise ValueError(f"max_new_tokens {max_new} outside (0, {self.gen_cfg.max_new_tokens}]")
        return ids

    def _alloc_evicting_sessions(self, n: int) -> List[int]:
        """pool.alloc with one retry after un-pinning idle sessions'
        retained blocks LRU-first (block pressure evicts conversations'
        KV before refusing new work). Lock already held (re-entrant)."""
        try:
            return self._block_pool.alloc(n)
        except KVPoolExhaustedError:
            if self.session_store is None:
                raise
            self.session_store.evict_for_blocks(n)
            return self._block_pool.alloc(n)

    def _insert_paged(self, rows, slot_ids, aslots, sessions: Optional[Sequence] = None) -> None:
        """Allocate each request's blocks up front (prompt + max_new +
        spec_k: no mid-decode OOM, no preemption), probing the prefix
        store for resident leading blocks first; under multi-tenant
        serving the prefix keys are salted by the row's adapter, so
        prefix blocks never cross tenants. Requests whose probe would
        hit keys registered earlier in this call are deferred one placement
        round (the registering prefill has not run yet). On pool
        exhaustion the whole call rolls back so the scheduler can requeue
        the batch.

        Session rows bypass the prefix store: their shared prefix is the
        conversation's own retained block chain (taken through per-request
        references, so the slot reclaim releases them as usual), and their
        blocks are never published under keys."""
        bs, pool = self.kv_block_size, self._block_pool
        store = self.session_store
        mt = self.multi_tenant
        pending = [
            (self._check_row(ids, max_new), int(max_new), int(slot),
             adapter_salt(name) if mt else b"", int(aslots[i]),
             sessions[i] if sessions is not None else None)
            for i, ((ids, max_new, name), slot) in enumerate(zip(rows, slot_ids))
        ]
        rounds: List[List] = []
        journal: List[Tuple[int, List[int], List[bytes]]] = []
        t_alloc0 = time.monotonic() if self.trace_buf is not None else 0.0
        with self._kv_lock:
            try:
                while pending:
                    placed, deferred = [], []
                    round_keys: set = set()
                    for ids, max_new, slot, salt, aslot, sess in pending:
                        if sess is not None:
                            keys = []
                            shared = store.acquire_blocks(sess, ids)
                            sess.last_reused_blocks = len(shared)
                            sess.last_prefill_tokens = ids.size - len(shared) * bs
                            if shared:
                                store.retained_hits += 1
                                store.retained_blocks_reused += len(shared)
                        else:
                            keys = prefix_keys(ids, bs, salt) if self.prefix_cache else []
                            if any(k in round_keys for k in keys):
                                deferred.append((ids, max_new, slot, salt, aslot, sess))
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
                        n_cap = -(-(ids.size + max_new + self.spec_k) // bs)
                        try:
                            owned = self._alloc_evicting_sessions(n_cap - len(shared))
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
                        placed.append((ids[T:], T, blocks, max_new, slot, aslot))
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
        dev = self.device
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
                aidx_arr = np.zeros((pb,), np.int64)  # padding rows gather base
                for j, (suffix, T, blocks, max_new, slot, aslot) in enumerate(chunk):
                    ids_arr[j, : len(suffix)] = suffix  # RIGHT-padded
                    tmask[j, : len(suffix)] = 1
                    tables[j, : len(blocks)] = blocks
                    tables[j, len(blocks):] = 0  # zero-block padding
                    slots_arr[j] = slot
                    max_new_arr[j] = max_new
                    shared_arr[j] = T
                    aidx_arr[j] = aslot
                # padding rows repeat row 0's tokens but keep all-out-of-range
                # tables and slot ids: every write they make is masked out
                ids_arr[len(chunk):] = ids_arr[0]
                tmask[len(chunk):] = tmask[0]
                t0 = time.monotonic() if self.trace_buf is not None else 0.0
                self._paged_insert(
                    len(chunk),
                    torch.from_numpy(ids_arr).to(dev), torch.from_numpy(tmask).to(dev),
                    torch.from_numpy(tables).to(dev), torch.from_numpy(slots_arr).to(dev),
                    torch.from_numpy(max_new_arr).to(dev), torch.from_numpy(shared_arr).to(dev),
                    torch.from_numpy(aidx_arr).to(dev),
                )
                if self.trace_buf is not None:
                    self.trace_buf.append((
                        "prefill_bucket", t0, time.monotonic(),
                        {"bucket": plen, "rows": len(chunk)},
                    ))

    # ------------------------------------------------------------------
    # Decode
    # ------------------------------------------------------------------

    def _cache_view(self) -> Dict[str, Any]:
        """The pool as the model's per-row cache; over the arena every
        layer reads through the slot block tables (decode never remaps
        blocks, so the tables pass through)."""
        pool = self._pool
        cache = {k: pool[k] for k in ("mask", "pos", "row_index")}
        if self.kv_paging:
            cache["layers"] = [dict(al, table=pool["table"]) for al in pool["layers"]]
        else:
            cache["layers"] = pool["layers"]
        return cache

    def _make_decode(self) -> Callable:
        model, gen_cfg, pool = self.model, self.gen_cfg, self._pool
        pad, eos = gen_cfg.pad_token_id, gen_cfg.eos_token_id
        # the fused paged read path, or None for the gather path (and for
        # the fixed-slot pool, which has no kernel)
        ak = self._attn_kernel if self._kernel_unsupported is None else None

        def decode():
            active = pool["active"].bool()
            # emit the token the previous call (insert or decode) already sampled
            token = torch.where(active, pool["next_token"], torch.full_like(pool["next_token"], pad))
            logprob = pool["next_logprob"]
            finished = active & ((token == eos) | (pool["step"] + 1 >= pool["max_new"]))
            logits, new_cache = model.decode_step_rows(
                token[:, None], self._cache_view(), active.to(torch.int32)[:, None], attn_kernel=ak
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

    def _make_spec_decode(self) -> Callable:
        """Speculative slot decode: one call emits the slot's pending token
        plus every draft the full model accepts (up to spec_k + 1 tokens
        per slot per call). The trunk runs spec_k + 1 per-row cached steps
        (draft tokens from the low-rank readout between them), ONE batched
        suffix pass verifies all positions from the trunk's own h_split,
        and the longest matching prefix is accepted with rejection-sampling
        correction; the correction token becomes the slot's pending
        `next_token`. Greedy emissions equal the plain decode's (up to
        near-tie argmaxes between two orders of summation); rejected KV
        rows are rolled back by clearing mask bits."""
        lm, gen_cfg, pool = self._lm, self.gen_cfg, self._pool
        pad, eos = gen_cfg.pad_token_id, gen_cfg.eos_token_id
        k, split, P = self.spec_k, self.spec_split, self.num_slots
        greedy = (not gen_cfg.do_sample) or (gen_cfg.temperature == 0.0)
        gen = self._generator
        # trunk draft steps are decode-shaped (t == 1) and ride the paged
        # kernel; the batched multi-position verify takes the gather path
        ak = self._attn_kernel if self._kernel_unsupported is None else None

        def warp(raw_logits, step):
            scores = raw_logits
            if self._suppress is not None:
                scores = scores + self._suppress
            return process_logits(scores, gen_cfg, step)

        def decode():
            a_fac, b_fac = self._spec_head
            active = pool["active"].bool()
            act_i = active.long()
            step0 = pool["step"]
            cache = self._cache_view()
            row_start, pos_start = pool["row_index"], pool["pos"]
            f0 = torch.where(active, pool["next_token"], torch.full_like(pool["next_token"], pad))
            f = f0
            h_rows, q_scores, draft_toks = [], [], []
            for j in range(k + 1):
                h_j, hn_j, cache = lm.spec_draft_step(f[:, None], cache, act_i[:, None], split, attn_kernel=ak)
                h_rows.append(h_j)
                if j < k:
                    sq = warp(((hn_j[:, 0] @ a_fac) @ b_fac).float(), step0 + 1 + j)
                    f = select_token(sq, gen, gen_cfg)
                    q_scores.append(sq)
                    draft_toks.append(f)
            jidx = torch.arange(k + 1, device=f0.device)[None, :]
            positions = pos_start[:, None] + jidx
            # over the arena, gate the verify's writes on row liveness: a
            # freed slot's stale table may name blocks now owned by others
            token_mask = act_i[:, None].expand(P, k + 1) if self.kv_paging else None
            logits_v, _, _ = lm.spec_verify_rows(torch.cat(h_rows, dim=1), cache, row_start, positions, split,
                                                 token_mask)
            logits_v = logits_v.float()
            p_scores = [warp(logits_v[:, j], step0 + 1 + j) for j in range(k + 1)]
            if greedy:
                acc = [torch.argmax(p_scores[j], dim=-1) == draft_toks[j] for j in range(k)]
            else:
                acc = []
                for j in range(k):
                    u = torch.rand(P, generator=gen, device=f0.device)
                    tok = draft_toks[j][:, None]
                    lr = (torch.log_softmax(p_scores[j], -1).gather(1, tok)
                          - torch.log_softmax(q_scores[j], -1).gather(1, tok))[:, 0]
                    acc.append(u < torch.exp(torch.clamp(lr, max=0.0)))
            run = torch.ones(P, dtype=torch.bool, device=f0.device)
            m = torch.zeros(P, dtype=torch.long, device=f0.device)
            for j in range(k):
                run = run & acc[j]
                m = m + run.long()
            lsm_v = torch.log_softmax(logits_v, dim=-1)
            corr = []
            for j in range(k + 1):
                if greedy:
                    c = torch.argmax(p_scores[j], dim=-1)
                elif j < k:
                    p_w = torch.softmax(p_scores[j], -1)
                    res = torch.clamp(p_w - torch.softmax(q_scores[j], -1), min=0.0)
                    tot = res.sum(-1, keepdim=True)
                    res = torch.where(tot > 0, res / tot, p_w)
                    c = torch.multinomial(res, 1, generator=gen)[:, 0]
                else:
                    c = select_token(p_scores[j], gen, gen_cfg)
                corr.append(c)
            corr = torch.stack(corr, dim=1)  # [P, k + 1]
            corr_lp = lsm_v.gather(2, corr[..., None])[..., 0]
            corr_at_m = corr.gather(1, m[:, None])[:, 0]
            corr_lp_at_m = corr_lp.gather(1, m[:, None])[:, 0]
            # emissions this call: [f0, accepted drafts]; the correction
            # stays pending as the slot's new next_token
            if k > 0:
                draft_mat = torch.stack(draft_toks, dim=1)
                draft_lp = lsm_v[:, :k].gather(2, draft_mat[..., None])[..., 0]
            else:
                draft_mat = torch.zeros((P, 0), dtype=torch.long, device=f0.device)
                draft_lp = torch.zeros((P, 0), dtype=torch.float32, device=f0.device)
            emit_mat = torch.cat([f0[:, None], draft_mat], dim=1)
            lp_mat = torch.cat([pool["next_logprob"][:, None], draft_lp], dim=1)
            alive, valids = active, []
            for j in range(k + 1):
                v_j = alive & (j - 1 < m) & (step0 + j < pool["max_new"])
                valids.append(v_j)
                alive = v_j & (emit_mat[:, j] != eos)
            valid_mat = torch.stack(valids, dim=1)
            emit_mat = torch.where(valid_mat, emit_mat, torch.full_like(emit_mat, pad))
            e = valid_mat.long().sum(1)
            hit_eos = (valid_mat & (emit_mat == eos)).any(1)
            new_step = step0 + e
            finished = active & (hit_eos | (new_step >= pool["max_new"]))
            # roll back rejected KV rows: keep the mask bits of the e emitted
            # (and fed) tokens f_0..f_{e-1}. Columns past the cache are
            # dropped, as JAX's scatter drops them: the mask is padded by
            # k + 1 spare columns for the scatter and cut back
            mask = cache["mask"]
            S = mask.shape[1]
            padded = torch.cat([mask, torch.zeros((P, k + 1), dtype=mask.dtype, device=mask.device)], dim=1)
            padded.scatter_(1, row_start[:, None] + jidx, (jidx < e[:, None]).to(mask.dtype))
            pool.update(
                mask=padded[:, :S], pos=pos_start + e, row_index=row_start + e,
                next_token=corr_at_m, next_logprob=corr_lp_at_m, step=new_step,
                active=pool["active"] * (1 - finished.long()),
            )
            return emit_mat, lp_mat, valid_mat, finished

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
        """Advance every active slot. Plain mode returns host arrays
        (tokens [P], logprobs [P] f32, emitted [P] bool, finished [P]
        bool); speculative mode returns (tokens [P, spec_k+1], logprobs
        [P, spec_k+1], emitted [P, spec_k+1], finished [P]): each slot
        emits between 1 and spec_k+1 tokens a call, in order, flagged by
        the emitted mask. Finished slots are already deactivated in the
        pool."""
        # kernel dispatch accounting, as the JAX engine's: a dispatch rides
        # the kernel or falls back to the gather path for a counted reason;
        # a speculative dispatch counts both (its t = 1 draft steps run the
        # kernel, its multi-position verify cannot)
        if self._attn_kernel is not None:
            if self._kernel_unsupported is not None:
                r = self._kernel_unsupported
                self._kv_kernel_fallbacks[r] = self._kv_kernel_fallbacks.get(r, 0) + 1
            else:
                self._kv_kernel_dispatches += 1
                if self.spec_k > 0:
                    self._kv_kernel_fallbacks["spec_verify_rows"] = (
                        self._kv_kernel_fallbacks.get("spec_verify_rows", 0) + 1
                    )
        with self._param_lock:
            # one heterogeneous step: each row applies its own adapter's
            # factors, gathered by its slot's row in the stack
            with self._adapters(self._pool["adapter"] if self.multi_tenant else None):
                token, logprob, valid, finished = self._decode_fn()
            ints = torch.cat([token.reshape(-1), valid.long().reshape(-1), finished.long()]).cpu().numpy()
            logprob = logprob.cpu().numpy().astype(np.float32)
        n = token.numel()
        shape = tuple(token.shape)
        return (
            ints[:n].reshape(shape).astype(np.int32),
            logprob,
            ints[n:2 * n].reshape(shape).astype(bool),
            ints[2 * n:].astype(bool),
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
        """Return a finished slot's blocks to the pool and drop its
        adapter pin (host bookkeeping only; a freed slot's stale table is
        harmless because inactive rows' arena writes are masked out).
        Idempotent."""
        if self.multi_tenant:
            self._release_adapters(slots)
        if not self.kv_paging:
            return
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
        ceil((prompt + max_new + spec_k) / block_size) minus the leading
        blocks a read-only prefix-store probe says are resident (in the
        request's own adapter key space), or minus the session's retained
        blocks when the request rides one. 0 when paging is off."""
        if not self.kv_paging:
            return 0
        ids = np.asarray(prompt_ids, np.int32).reshape(-1)
        n_cap = -(-(ids.size + int(max_new_tokens) + self.spec_k) // self.kv_block_size)
        if session is not None:
            # session rows never touch the prefix store; their only reuse
            # is the conversation's own retained prefix
            if ignore_cache:
                return max(1, n_cap)
            with self._kv_lock:
                cov = session.covered_tokens(self.kv_block_size)
                shared = (
                    len(session.blocks)
                    if session.reset_reason is None
                    and ids.size > cov
                    and np.array_equal(ids[:cov], session.tokens[:cov])
                    else 0
                )
            return max(1, n_cap - shared)
        with self._kv_lock:
            salt = adapter_salt(adapter_id) if self.multi_tenant else b""
            shared = 0 if ignore_cache else self._block_pool.lookup_chain(ids, salt)
        return max(1, n_cap - shared)

    def blocks_available(self) -> int:
        """Blocks a new request can claim: free + evictable idle (prefix
        cache idle blocks, plus idle sessions' retained pins, which the
        insert path evicts under pressure)."""
        if not self.kv_paging:
            return 0
        with self._kv_lock:
            n = self._block_pool.available()
            if self.session_store is not None:
                n += self.session_store.evictable_blocks()
            return n

    @property
    def total_blocks(self) -> int:
        """Allocatable blocks (zero block excluded); 0 when paging is off."""
        return self._block_pool.total if self.kv_paging else 0

    def kv_stats(self) -> Dict[str, Any]:
        """Host-side counters for metrics/healthz. `kv_kernel_fallbacks`
        is a {reason: count} dict; everything else is an int. The
        fixed-slot pool reports the kernel accounting alone (the JAX
        engine keeps it in the engine and reports {} there)."""
        accounting = {
            "kv_kernel_dispatches": self._kv_kernel_dispatches,
            "kv_kernel_fallbacks": dict(self._kv_kernel_fallbacks),
        }
        if not self.kv_paging:
            return accounting
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
                **accounting,
            }

    # ------------------------------------------------------------------
    # Sessions (multi-turn chat: retained KV between requests)
    # ------------------------------------------------------------------

    def enable_sessions(self, ttl_s: float = 600.0, max_sessions: int = 256,
                        bytes_budget_mb: float = 0.0):
        """Attach a `SessionStore` sharing this engine's block pool and KV
        lock. Requires kv_paging (retention is block pinning). Returns the
        store (also kept as `self.session_store`)."""
        from trlx_tpu_torch.inference.sessions import SessionStore

        if not self.kv_paging:
            raise ValueError("sessions require kv_paging (retained KV blocks)")
        block_bytes = self.kv_stats()["kv_pool_bytes"] // self._n_blocks
        self.session_store = SessionStore(
            self._block_pool, self.kv_block_size, lock=self._kv_lock,
            ttl_s=ttl_s, max_sessions=max_sessions,
            bytes_budget=int(bytes_budget_mb * 1024 * 1024),
            block_bytes=block_bytes,
        )
        return self.session_store

    def retain_session(self, slot: int, session, full_ids) -> int:
        """Pin a finishing turn's leading blocks into its session. Loop
        thread only, BEFORE `reclaim_slots`: the slot's blocks must still
        hold the request's references. Returns the retained block count."""
        if not self.kv_paging or self.session_store is None:
            return 0
        with self._kv_lock:
            blocks = self._slot_blocks.get(int(slot))
            if not blocks:
                return 0
            return self.session_store.retain_turn(session, blocks, full_ids)

    def session_stats(self) -> Dict[str, float]:
        """Session-store counters for metrics/healthz; {} when off."""
        return self.session_store.stats() if self.session_store is not None else {}

    # ------------------------------------------------------------------
    # Multi-tenant adapter plumbing
    # ------------------------------------------------------------------

    def flush_adapter_prefixes(self, name: Optional[str]) -> int:
        """Drop one adapter's cached prefix blocks (per-adapter hot-reload:
        its K/V went stale, everyone else's is still good). Returns the
        number of keys flushed; 0 when prefix caching is off. The
        adapter's sessions reset for the same reason: their retained KV
        was written under the replaced factors."""
        if self.session_store is not None:
            self.session_store.invalidate_adapter(name)
        if not self.prefix_cache:
            return 0
        with self._kv_lock:
            return self._block_pool.flush_prefix(adapter_salt(name))

    def adapter_stats(self) -> Dict[str, Any]:
        """Store counters for metrics and healthz; {} when single-tenant."""
        return self.adapter_store.stats() if self.multi_tenant else {}

    @property
    def active_slots(self) -> int:
        return int(self._pool["active"].sum().item())
