"""Token selection for the inference engine.

Port of `GenerationConfig`, `process_logits`, `select_token`,
`sampled_token_logprob` and `topp_mask` from the JAX package's
`ops/sampling.py` (and `topk_mask` from its `ops/ilql.py`). Sampling draws
from an explicit `torch.Generator`; JAX's PRNG streams cannot be
reproduced in torch, so sampled tokens agree with the JAX package only in
distribution, while greedy decoding is token-exact. The rollout sampler
(`make_generate_fn`) comes with the rollout slice.
"""

from dataclasses import dataclass
from typing import Dict, Optional, Union

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
