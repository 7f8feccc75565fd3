"""Multi-tenant LoRA adapter store (the S-LoRA shape), the port's copy of
the JAX package's `inference/adapters.py`.

One frozen trunk sits on the device once; each tenant's LoRA delta is a
small `[d, r]` / `[r, feats]` factor pair. The store keeps one stacked
tensor `[capacity + 1, ...]` per LoRA leaf of the served policy (named as
in its state dict, `...q_proj.lora_a`), on the policy's device and in
its param dtype. The engine gathers each batch row's factors by the
row's slot in the stack and hands them to the model's `Linear`s through
`models/transformer.py:lora_rows` (Punica-style batched heterogeneous
decode: requests of different tenants share every decode step). Slot 0
is permanently zeros: gathering it reproduces the base policy exactly,
so "no adapter" is not a special case anywhere in the engine.

Adapters load on demand from `adapter_dir/<name>` trainer checkpoints
(`TorchTrainer.save`'s tensor-only `model.pt`, of which only the LoRA
leaves are kept), are refcounted while any request is in flight, and
idle residents evict LRU-oldest when slots run out. Capacity is the
tighter of `max_resident` and a device byte budget. A slot is written
in place under the store's lock, and only while no live row gathers it:
it is free, was just evicted, or (`reload`) its adapter has no request
in flight.

Thread safety: one RLock. Callers are the scheduler loop thread
(acquire/release around a slot's life) and HTTP admin threads
(list/load/evict/reload).
"""

import os
import threading
from collections import OrderedDict
from typing import Any, Dict, List, Optional

import torch

from trlx_tpu_torch import resilience
from trlx_tpu_torch.inference.paging import ADAPTER_SALT_PREFIX
from trlx_tpu_torch.models.lora import is_lora_name
from trlx_tpu_torch.utils import logging

logger = logging.get_logger(__name__)

#: names that all mean "the base policy" (stack slot 0, zero factors)
BASE_NAMES = (None, "", "base")


class AdapterError(RuntimeError):
    """Base class for adapter-store failures."""


class AdapterNotFoundError(AdapterError):
    """No manifest-complete checkpoint for the requested adapter."""


class AdapterCapacityError(AdapterError):
    """The request set needs more adapter slots than are free or
    evictable right now. The scheduler shrinks the admission batch to
    fewer distinct adapters on this (requeueing the rest), so a burst of
    more tenants than `capacity` degrades to smaller batches instead of
    livelocking; `/admin/adapters` answers 503 with Retry-After."""


def adapter_salt(name: Optional[str]) -> bytes:
    """Prefix-cache salt for one adapter. The base policy keeps the
    unsalted key space (existing caches stay valid when multi-tenancy
    turns on); adapter salts are NUL-terminated so no salt is ever a
    byte prefix of another and per-adapter flushes match exactly."""
    if name in BASE_NAMES:
        return b""
    return ADAPTER_SALT_PREFIX + str(name).encode("utf-8") + b"\x00"


def load_adapter_leaves(directory: str) -> Dict[str, torch.Tensor]:
    """The LoRA leaves of a checkpoint of the port's trainer: its
    tensor-only `model.pt` (read with `weights_only=True`, on the CPU),
    of which only the `...lora_a` / `...lora_b` entries are kept, so base
    weights, value heads and optimizer state never reach the store."""
    state = torch.load(os.path.join(directory, resilience.MODEL_FILE), map_location="cpu", weights_only=True)
    out = {k: v for k, v in state.items() if is_lora_name(k)}
    if not out:
        raise AdapterNotFoundError(f"checkpoint at {directory} holds no LoRA leaves in {resilience.MODEL_FILE}")
    return out


class AdapterStore:
    """Directory-backed LRU store of device-resident stacked LoRA factors.

    `params` is the served policy's state dict (a LoRA-enabled one): it
    supplies the leaf names, shapes, dtypes and the device the stack is
    built from. Its own factor values are never served: a multi-tenant
    engine reads factors from the stack alone (slot 0 is zeros).

    `loader(path) -> {name: tensor or array}` reads one adapter's leaves
    (default `load_adapter_leaves`)."""

    def __init__(
        self,
        params: Dict[str, torch.Tensor],
        adapter_dir: Optional[str] = None,
        max_resident: int = 8,
        hbm_budget_bytes: int = 0,
        loader=load_adapter_leaves,
    ):
        lora = {k: v for k, v in params.items() if is_lora_name(k)}
        if not lora:
            raise ValueError(
                "AdapterStore needs a LoRA-enabled policy (cfg.lora_rank > 0); "
                "the state dict holds no *.lora_a / *.lora_b leaves"
            )
        self.adapter_dir = adapter_dir
        self.loader = loader
        self._paths = sorted(lora)
        self.bytes_per_adapter = int(sum(lora[p].numel() * lora[p].element_size() for p in self._paths))
        self.hbm_budget_bytes = int(hbm_budget_bytes)
        capacity = int(max_resident)
        if self.hbm_budget_bytes:
            capacity = min(capacity, self.hbm_budget_bytes // self.bytes_per_adapter)
        if capacity < 1:
            raise ValueError(
                f"adapter HBM budget {hbm_budget_bytes}B fits no adapter "
                f"({self.bytes_per_adapter}B each)"
            )
        self.capacity = capacity
        # slot 0 = base (zeros, never evicted); slots 1..capacity = tenants
        self._stack: Dict[str, torch.Tensor] = {
            p: torch.zeros((capacity + 1,) + tuple(lora[p].shape), dtype=lora[p].dtype, device=lora[p].device)
            for p in self._paths
        }
        self._free_slots: List[int] = list(range(capacity, 0, -1))
        self._slot_of: Dict[str, int] = {}
        self._refs: Dict[str, int] = {}
        self._lru: "OrderedDict[str, None]" = OrderedDict()  # idle residents, oldest first
        # name -> manifest (step, wall_time) of the factors last served.
        # Survives eviction on purpose: when an evicted adapter re-loads
        # under a moved checkpoint, its salted prefix-cache blocks hold
        # K/V computed with the old factors and must flush (see
        # `flush_prefixes` below).
        self._versions: Dict[str, tuple] = {}
        # engine-wired callback (name -> None): flush one adapter's
        # salted prefix blocks; called on load when the on-disk version
        # moved since this adapter was last served
        self.flush_prefixes = None
        self.loads = 0
        self.evictions = 0
        self.reloads = 0
        self._lock = threading.RLock()

    # -- discovery ------------------------------------------------------

    def adapter_path(self, name: str) -> Optional[str]:
        if self.adapter_dir is None:
            return None
        return os.path.join(self.adapter_dir, str(name))

    def scan(self) -> List[str]:
        """Manifest-complete adapter checkpoints under `adapter_dir`
        (subdirectory name = adapter id). Half-written saves have no
        manifest yet and stay invisible, as to the CheckpointWatcher."""
        if not self.adapter_dir or not os.path.isdir(self.adapter_dir):
            return []
        names = []
        for entry in sorted(os.listdir(self.adapter_dir)):
            path = os.path.join(self.adapter_dir, entry)
            if os.path.isdir(path) and resilience.read_manifest(path) is not None:
                names.append(entry)
        return names

    def known(self, name: Optional[str]) -> bool:
        """Resident now, or loadable from disk."""
        if name in BASE_NAMES:
            return True
        with self._lock:
            if name in self._slot_of:
                return True
        path = self.adapter_path(name)
        return path is not None and resilience.read_manifest(path) is not None

    def resident(self) -> List[str]:
        with self._lock:
            return sorted(self._slot_of)

    # -- slot lifecycle -------------------------------------------------

    def acquire(self, name: Optional[str]) -> int:
        """Pin `name` resident and return its stack slot. Loads from disk
        on a miss, evicting the LRU-oldest idle resident under slot
        pressure; raises AdapterCapacityError when every slot is pinned."""
        if name in BASE_NAMES:
            return 0
        name = str(name)
        with self._lock:
            slot = self._slot_of.get(name)
            if slot is None:
                slot = self._load_locked(name)
            self._refs[name] = self._refs.get(name, 0) + 1
            self._lru.pop(name, None)
            return slot

    def release(self, name: Optional[str]) -> None:
        """Drop one pin. Idle residents stay in the stack (serving later
        acquires without a load) until slot pressure evicts them, LRU
        first."""
        if name in BASE_NAMES:
            return
        name = str(name)
        with self._lock:
            left = self._refs.get(name, 0) - 1
            if left > 0:
                self._refs[name] = left
                return
            self._refs.pop(name, None)
            if name in self._slot_of:
                self._lru[name] = None
                self._lru.move_to_end(name)

    def load(self, name: str) -> int:
        """Admin preload: make `name` resident without pinning it."""
        name = str(name)
        with self._lock:
            slot = self._slot_of.get(name)
            if slot is None:
                slot = self._load_locked(name)
                if self._refs.get(name, 0) == 0:
                    self._lru[name] = None
            return slot

    def evict(self, name: str) -> None:
        """Admin eviction. Refuses while requests are in flight."""
        name = str(name)
        with self._lock:
            if name not in self._slot_of:
                raise AdapterNotFoundError(f"adapter '{name}' is not resident")
            if self._refs.get(name, 0) > 0:
                raise AdapterError(f"adapter '{name}' has in-flight requests")
            self._evict_locked(name)

    def reload(self, name: str) -> bool:
        """Re-read `name`'s checkpoint into its slot (per-adapter
        hot-reload; the caller drains that adapter's requests first and
        the store refuses while it is pinned). Returns False when the
        on-disk version already matches the resident one."""
        name = str(name)
        with self._lock:
            slot = self._slot_of.get(name)
            if slot is None:
                raise AdapterNotFoundError(f"adapter '{name}' is not resident")
            if self._refs.get(name, 0) > 0:
                raise AdapterError(f"adapter '{name}' has in-flight requests")
            version = self._disk_version(name)
            if version is not None and version == self._versions.get(name):
                return False
            self._write_slot(name, slot)
            self.reloads += 1
            return True

    def changed(self) -> List[str]:
        """Resident adapters whose on-disk checkpoint is newer than the
        loaded one (the per-adapter analogue of CheckpointWatcher's poll)."""
        with self._lock:
            stale = []
            for name in self._slot_of:
                version = self._disk_version(name)
                if version is not None and version != self._versions.get(name):
                    stale.append(name)
            return stale

    # -- engine-facing views --------------------------------------------

    def stacked(self) -> Dict[str, torch.Tensor]:
        """The stacked factors by leaf name, each [capacity + 1, ...].
        Loads write slots in place, so the tensors (and a dict taken
        earlier) stay valid across swaps."""
        with self._lock:
            return dict(self._stack)

    def refcount(self, name: str) -> int:
        with self._lock:
            return self._refs.get(str(name), 0)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "resident": sorted(self._slot_of),
                "capacity": self.capacity,
                "bytes_per_adapter": self.bytes_per_adapter,
                "resident_bytes": self.bytes_per_adapter * len(self._slot_of),
                "hbm_budget_bytes": self.hbm_budget_bytes,
                "loads": self.loads,
                "evictions": self.evictions,
                "reloads": self.reloads,
            }

    # -- internals ------------------------------------------------------

    def _disk_version(self, name: str) -> Optional[tuple]:
        path = self.adapter_path(name)
        if path is None:
            return None
        manifest = resilience.read_manifest(path)
        if manifest is None:
            return None
        return (manifest.get("step"), manifest.get("wall_time"))

    def _load_locked(self, name: str) -> int:
        if self._free_slots:
            slot = self._free_slots.pop()
        elif self._lru:
            victim, _ = self._lru.popitem(last=False)
            slot = self._evict_locked(victim)
            self._free_slots.remove(slot)
        else:
            raise AdapterCapacityError(
                f"all {self.capacity} adapter slots are pinned by in-flight "
                f"requests; cannot load '{name}'"
            )
        prev = self._versions.get(name)
        try:
            self._write_slot(name, slot)
        except Exception:
            self._free_slots.append(slot)
            raise
        self.loads += 1
        if prev is not None and prev != self._versions.get(name) and self.flush_prefixes is not None:
            # the checkpoint moved while this adapter was out of the
            # stack: any cached prefix K/V under its salt is stale
            self.flush_prefixes(name)
        return slot

    def _evict_locked(self, name: str) -> int:
        slot = self._slot_of.pop(name)
        self._lru.pop(name, None)
        self._free_slots.append(slot)
        self.evictions += 1
        logger.info(f"adapter store: evicted '{name}' from slot {slot}")
        return slot

    def _write_slot(self, name: str, slot: int) -> None:
        path = self.adapter_path(name)
        if path is None or resilience.read_manifest(path) is None:
            raise AdapterNotFoundError(
                f"no manifest-complete checkpoint for adapter '{name}'"
                + (f" at {path}" if path else " (no adapter_dir configured)")
            )
        leaves = self.loader(path)
        if sorted(leaves) != self._paths:
            missing = [p for p in self._paths if p not in leaves]
            extra = [p for p in leaves if p not in self._stack]
            raise AdapterError(
                f"adapter '{name}' leaf names do not match the serving policy "
                f"(missing {missing[:3]}..., unexpected {extra[:3]}...)"
                if (missing or extra) else
                f"adapter '{name}' leaf names do not match the serving policy"
            )
        for p in self._paths:
            want = tuple(self._stack[p].shape[1:])
            if tuple(leaves[p].shape) != want:
                raise AdapterError(
                    f"adapter '{name}' leaf {p} has shape {tuple(leaves[p].shape)}, policy expects {want}"
                )
        with torch.no_grad():
            for p in self._paths:
                self._stack[p][slot].copy_(torch.as_tensor(leaves[p]).to(self._stack[p].dtype))
        self._slot_of[name] = slot
        self._versions[name] = self._disk_version(name)
        logger.info(f"adapter store: loaded '{name}' into slot {slot}")
