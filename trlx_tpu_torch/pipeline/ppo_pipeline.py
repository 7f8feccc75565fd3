"""PPO rollout storage (port of the JAX package's `pipeline/ppo_pipeline.py`):
an append-only `PPORLElement` history, its JSON export, and a loader
whose collation left-pads queries and right-pads responses and the
per-token stats, so the query|response seam sits at one fixed column.

The collation is the numpy branch of the JAX package's `native.ppo_collate`
(`pad_stack` per field), its trunk-cache collation (`collate_h_split`,
on the device), GRPO's group ids (int32) and multi-turn rollouts' loss
masks (f32, right-padded like the per-token stats with 0.0), each when
every element of the batch has one.
"""

import json
import os
import time
from typing import Iterable, List, Optional

import numpy as np
import torch

from trlx_tpu_torch.data import PPORLBatch, PPORLElement
from trlx_tpu_torch.pipeline import BaseRolloutStore, DataLoader


def pad_stack(seqs: List[np.ndarray], pad_value, max_len: int, dtype, left: bool = False) -> np.ndarray:
    """Pad and stack rows into [n, max_len], on the left or the right."""
    out = np.full((len(seqs), max_len), pad_value, dtype=dtype)
    for i, s in enumerate(seqs):
        s = np.asarray(s)[:max_len]
        if left:
            out[i, max_len - len(s):] = s
        else:
            out[i, : len(s)] = s
    return out


def collate_h_split(elems: List[PPORLElement], max_q: int, max_r: int,
                    left_queries: bool) -> Optional[torch.Tensor]:
    """The elements' trunk cache rows aligned with the padded
    concat(query, response) layout, [n, max_q + max_r, d], or None unless
    every element has them. The zero rows of padding are exact: padded
    columns are attention-masked, so their values are never read."""
    if not elems or any(e.h_split is None for e in elems):
        return None
    first = elems[0].h_split
    out = torch.zeros((len(elems), max_q + max_r, first.shape[-1]), dtype=first.dtype, device=first.device)
    for i, e in enumerate(elems):
        qi = len(e.query_tensor)
        w = min(e.h_split.shape[0] - qi, max_r)
        if left_queries:
            out[i, max_q - qi:max_q] = e.h_split[:qi]
        else:
            out[i, :qi] = e.h_split[:qi]
        out[i, max_q:max_q + w] = e.h_split[qi:qi + w]
    return out


def ppo_collate(elems: List[PPORLElement], max_q: int, max_r: int, max_p: int, pad_id: int,
                left_queries: bool) -> PPORLBatch:
    return PPORLBatch(
        query_tensors=pad_stack([e.query_tensor for e in elems], pad_id, max_q, np.int32, left=left_queries),
        response_tensors=pad_stack([e.response_tensor for e in elems], pad_id, max_r, np.int32),
        logprobs=pad_stack([e.logprobs for e in elems], 0.0, max_p, np.float32),
        values=pad_stack([e.values for e in elems], 0.0, max_p, np.float32),
        rewards=pad_stack([e.rewards for e in elems], 0.0, max_p, np.float32),
        h_split=collate_h_split(elems, max_q, max_r, left_queries),
        group_ids=(np.asarray([e.group_id for e in elems], dtype=np.int32)
                   if elems and all(e.group_id is not None for e in elems) else None),
        loss_masks=(pad_stack([e.loss_mask for e in elems], 0.0, max_p, np.float32)
                    if elems and all(e.loss_mask is not None for e in elems) else None),
    )


class PPORolloutStorage(BaseRolloutStore):
    def __init__(self, pad_token_id: int, padding_side: str = "left"):
        super().__init__()
        self.pad_token_id = pad_token_id
        self.padding_side = padding_side
        self.history: List[PPORLElement] = []

    def push(self, exps: Iterable[PPORLElement]):
        self.history += list(exps)

    def clear_history(self):
        self.history = []

    def export_history(self, location: str, only_text: bool = True):
        """Dump the rollouts as JSON into `location` (an existing
        directory), for offline analysis. The trunk cache rows are not
        exported."""
        if not os.path.isdir(location):
            raise FileNotFoundError(f"rollout export directory {location} does not exist")
        fpath = os.path.join(location, f"epoch-{str(time.time())}.json")

        def exp_to_dict(exp):
            return {k: np.asarray(v).tolist() for k, v in exp.__dict__.items()
                    if v is not None and k != "h_split"}

        data = [exp_to_dict(exp) for exp in self.history]
        if only_text:
            keys = ["query_tensor", "response_tensor"]
            data = [{k: d[k] for k in keys} for d in data]
        with open(fpath, "w") as f:
            f.write(json.dumps(data, indent=2))
        return fpath

    def __getitem__(self, index: int) -> PPORLElement:
        return self.history[index]

    def __len__(self) -> int:
        return len(self.history)

    def create_loader(
        self,
        batch_size: int,
        shuffle: bool = False,
        seed: int = 0,
        max_query_len: int = 0,
        max_response_len: int = 0,
        max_stat_len: int = 0,
        drop_last: bool = False,
    ) -> DataLoader:
        """Loader of padded `PPORLBatch`es. The max_*_len widths keep the
        batch shapes the same across rollout collections; a width is
        raised to the store's maximum when an element is longer."""
        max_q = max(max(len(e.query_tensor) for e in self.history), max_query_len)
        max_r = max(max(len(e.response_tensor) for e in self.history), max_response_len)
        max_p = max(max(len(e.logprobs) for e in self.history), max_stat_len)
        pad_id = self.pad_token_id
        left_queries = self.padding_side == "left"

        def collate(elems: List[PPORLElement]) -> PPORLBatch:
            return ppo_collate(elems, max_q, max_r, max_p, pad_id, left_queries)

        return DataLoader(self.history, batch_size, shuffle=shuffle, collate_fn=collate,
                          seed=seed, drop_last=drop_last)
