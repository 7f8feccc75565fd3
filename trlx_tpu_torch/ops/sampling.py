"""Token selection and the autoregressive sampler.

Port of the JAX package's `ops/sampling.py`: `GenerationConfig`,
`process_logits`, `select_token`, `sampled_token_logprob`, `topp_mask`
(and `topk_mask` from its `ops/ilql.py`), and the sampler
`make_generate_fn` / `generate` for a causal LM with one beam: prefill
the (left-padded) prompt batch into a fixed-slot KV cache, then decode
token by token with logit processing, a transition logit mask,
`suppress_tokens` and eos stop, until every row is finished or the
budget runs out. Sampling draws from an explicit `torch.Generator`;
JAX's PRNG streams cannot be reproduced in torch, so sampled tokens
agree with the JAX package only in distribution, while greedy decoding
is token-exact. ILQL, seq2seq and beams (ROADMAP queue A, item 4), stat
capture and speculative decode (item 1) raise.
"""

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Union

import numpy as np
import torch


@dataclass(frozen=True)
class GenerationConfig:
    """HF-compatible generation knobs."""

    max_new_tokens: int = 40
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    do_sample: bool = True
    eos_token_id: int = 0
    pad_token_id: int = 0
    min_new_tokens: int = 0
    repetition_penalty: float = 1.0
    num_beams: int = 1
    length_penalty: float = 1.0
    beta: float = 1.0
    suppress_tokens: tuple = ()

    @classmethod
    def from_gen_kwargs(cls, gen_kwargs: Dict, eos_token_id: int, pad_token_id: int):
        kw = dict(gen_kwargs or {})
        kw.pop("max_length", None)
        return cls(
            max_new_tokens=int(kw.get("max_new_tokens", 40)),
            temperature=float(kw.get("temperature", 1.0)),
            top_k=int(kw.get("top_k", 0) or 0),
            top_p=float(kw.get("top_p", 1.0)),
            do_sample=bool(kw.get("do_sample", True)),
            min_new_tokens=int(kw.get("min_new_tokens", 0) or 0),
            repetition_penalty=float(kw.get("repetition_penalty", 1.0) or 1.0),
            num_beams=int(kw.get("num_beams", 1) or 1),
            length_penalty=float(kw.get("length_penalty", 1.0) or 1.0),
            beta=float(kw.get("beta", 1.0)),
            suppress_tokens=tuple(kw.get("suppress_tokens") or ()),
            eos_token_id=eos_token_id,
            pad_token_id=pad_token_id,
        )


def topk_mask(xs: torch.Tensor, k: int) -> torch.Tensor:
    """Keep the top-k entries of the last axis, set the rest to -inf."""
    if k >= xs.shape[-1]:
        return xs
    mintop = torch.topk(xs, k, dim=-1).values[..., -1:]
    return torch.where(xs < mintop, torch.full_like(xs, -float("inf")), xs)


def topp_mask(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Nucleus mask: keep tokens until cumulative prob exceeds p (always
    keeping the top-1), set the rest to -inf."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    cutoff_mask = cum - probs >= p
    threshold = torch.where(cutoff_mask, torch.full_like(sorted_logits, float("inf")), sorted_logits)
    threshold = threshold.amin(dim=-1, keepdim=True)
    return torch.where(logits < threshold, torch.full_like(logits, -float("inf")), logits)


def process_logits(
    logits: torch.Tensor,  # [b, V]
    cfg: GenerationConfig,
    step: Union[int, torch.Tensor],  # scalar or per-row [b]
    seen: Optional[torch.Tensor] = None,  # [b, V] bool: token appeared so far
) -> torch.Tensor:
    """Repetition-penalty / min-new-tokens / temperature / top-k / top-p
    logit processing, in HF LogitsProcessor order."""
    logits = logits.float()
    if cfg.repetition_penalty != 1.0 and seen is not None:
        p = cfg.repetition_penalty
        penalized = torch.where(logits > 0, logits / p, logits * p)
        logits = torch.where(seen, penalized, logits)
    if cfg.min_new_tokens > 0:
        # forbid EOS before min_new_tokens
        step = torch.as_tensor(step, device=logits.device)
        penalty = torch.where(step < cfg.min_new_tokens, -float("inf"), 0.0).to(logits.dtype)
        logits = logits.clone()
        logits[:, cfg.eos_token_id] += penalty
    if cfg.do_sample and cfg.temperature not in (0.0, 1.0):
        logits = logits / cfg.temperature
    if cfg.top_k and cfg.top_k > 0:
        logits = topk_mask(logits, cfg.top_k)
    if cfg.do_sample and cfg.top_p < 1.0:
        logits = topp_mask(logits, cfg.top_p)
    return logits


def select_token(scores: torch.Tensor, generator: Optional[torch.Generator],
                 cfg: GenerationConfig) -> torch.Tensor:
    """Next tokens from processed scores [b, V]: a categorical draw under
    do_sample (temperature 0 degrades to greedy, like HF), argmax
    (first maximum) otherwise."""
    if cfg.do_sample and cfg.temperature != 0.0:
        probs = torch.softmax(scores.float(), dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]
    return torch.argmax(scores, dim=-1)


def sampled_token_logprob(raw_logits: torch.Tensor, token: torch.Tensor) -> torch.Tensor:
    """Policy logprob of the chosen token, read off the raw (pre-warp)
    f32 logits [b, V]."""
    lp = torch.log_softmax(raw_logits.float(), dim=-1)
    return torch.gather(lp, 1, token[:, None].long())[:, 0]


def make_generate_fn(
    model,
    model_cfg,
    gen_cfg: GenerationConfig,
    mode: str = "lm",
    logit_mask: Optional[np.ndarray] = None,  # [V, V] True = forbidden transition
    capture: bool = False,
    spec_k: int = 0,
) -> Callable:
    """Build generate(input_ids [b, p], attn_mask [b, p], generator) ->
    dict(samples, samples_mask, response_tokens, response_mask), with
    outputs [b, p + max_new_tokens] / [b, max_new_tokens] like the JAX
    sampler's. `model` is a `CausalLMWithValueHead` whose parameters live
    on the device the inputs are moved to."""
    from trlx_tpu_torch.models.transformer import init_kv_cache

    if mode != "lm":
        raise NotImplementedError(f"mode={mode!r} (ILQL sampling) is not ported yet (ROADMAP queue A, item 4)")
    if getattr(model_cfg, "is_seq2seq", False):
        raise NotImplementedError("seq2seq generation is not ported yet (ROADMAP queue A, item 4)")
    if gen_cfg.num_beams > 1:
        raise NotImplementedError("beam search is not ported yet (ROADMAP queue A, item 4)")
    if capture:
        raise NotImplementedError(
            "rollout stat capture (the capture_split decode) is not ported yet (ROADMAP queue A, item 1)"
        )
    if spec_k > 0:
        raise NotImplementedError(
            "self-speculative decode is not ported yet (ROADMAP queue A, item 1: its remainder)"
        )
    max_new = gen_cfg.max_new_tokens
    track_seen = gen_cfg.repetition_penalty != 1.0

    @torch.no_grad()
    def generate(input_ids, attn_mask, generator: Optional[torch.Generator] = None):
        device = next(model.parameters()).device
        input_ids = torch.as_tensor(np.asarray(input_ids), device=device).long()
        attn_mask = torch.as_tensor(np.asarray(attn_mask), device=device).to(torch.int32)
        b, plen = input_ids.shape
        V = model_cfg.vocab_size
        suppress = forbid = None
        if gen_cfg.suppress_tokens:
            suppress = torch.zeros(V, dtype=torch.float32, device=device)
            suppress[torch.as_tensor(gen_cfg.suppress_tokens, device=device).long()] = -float("inf")
        if logit_mask is not None:
            forbid = torch.as_tensor(np.asarray(logit_mask), device=device).bool()
        cache = init_kv_cache(model_cfg, b, plen + max_new, device=device)
        logits, cache = model.decode_step(input_ids, cache, attn_mask, is_prefill=True)
        logits = logits[:, -1].float()
        seen = None
        if track_seen:  # HF semantics: the penalty covers prompt tokens too
            counts = torch.zeros((b, V), dtype=torch.int32, device=device)
            rows = torch.arange(b, device=device)[:, None].expand(b, plen)
            counts.index_put_((rows, input_ids), attn_mask, accumulate=True)
            seen = counts > 0
        prev = input_ids[:, -1]
        finished = torch.zeros(b, dtype=torch.bool, device=device)
        out_tokens = torch.full((b, max_new), gen_cfg.pad_token_id, dtype=torch.long, device=device)
        out_mask = torch.zeros((b, max_new), dtype=torch.int32, device=device)
        for i in range(max_new):
            if i > 0:
                step_logits, cache = model.decode_step(prev[:, None], cache, out_mask[:, i - 1:i])
                logits = step_logits[:, -1].float()
            scores = logits
            if suppress is not None:
                scores = scores + suppress
            if forbid is not None:  # transitions from the previous token
                scores = torch.where(forbid[prev], -float("inf"), scores)
            scores = process_logits(scores, gen_cfg, i, seen)
            token = select_token(scores, generator, gen_cfg)
            token = torch.where(finished, torch.full_like(token, gen_cfg.pad_token_id), token)
            out_tokens[:, i] = token
            out_mask[:, i] = (~finished).to(torch.int32)
            finished = finished | (token == gen_cfg.eos_token_id)
            if track_seen:
                seen[torch.arange(b, device=device), token] = True
            prev = token
            if bool(finished.all()):  # early exit, like the JAX while_loop's condition
                break
        return {
            "samples": torch.cat([input_ids, out_tokens], dim=1),
            "samples_mask": torch.cat([attn_mask, out_mask], dim=1),
            "response_tokens": out_tokens,
            "response_mask": out_mask,
        }

    return generate


def generate(model, model_cfg, input_ids, attn_mask, gen_cfg: GenerationConfig,
             generator: Optional[torch.Generator] = None, mode: str = "lm", logit_mask=None):
    """One-shot convenience wrapper over `make_generate_fn`."""
    return make_generate_fn(model, model_cfg, gen_cfg, mode, logit_mask)(input_ids, attn_mask, generator)
