"""Token selection and the autoregressive sampler.

Port of the JAX package's `ops/sampling.py`: `GenerationConfig`,
`process_logits`, `select_token`, `sampled_token_logprob`, `topp_mask`
(`topk_mask` lives in `ops/ilql.py`, as in the JAX package), and the
sampler `make_generate_fn` / `generate` for a causal LM with one beam: prefill
the (left-padded) prompt batch into a fixed-slot KV cache, then decode
token by token with logit processing, a transition logit mask,
`suppress_tokens` and eos stop, until every row is finished or the
budget runs out. Sampling draws from an explicit `torch.Generator`;
JAX's PRNG streams cannot be reproduced in torch, so sampled tokens
agree with the JAX package only in distribution, while greedy decoding
is token-exact.

With `spec_k > 0` the sampler is self-speculative (`generate_spec`): the
frozen trunk below the hydra split and a low-rank readout of the
unembedding (`spec_draft_head_from_params`) draft `spec_k` tokens a
round, one suffix pass verifies them all, the longest agreeing prefix is
kept (greedy: argmax agreement; sampled: rejection sampling with the
residual correction), and the rejected K/V is rolled back by clearing
mask bits. Greedy output is the plain sampler's; sampled output follows
the same distribution. Either sampler may run on a decode view of the
parameters (`params`, the int8 frozen trunk of `ops/quant.py`).

With `capture` (the rollout fast path, `method.capture_rollout_stats`)
either sampler also returns what PPO's scoring pass would otherwise
recompute with a batched forward: each sampled token's policy logprob
from the raw logits, the value at its input position, and the
activations entering the hydra split over prompt and response.

With `mode="ilql"` (a `CausalLMWithILQLHeads`) the plain sampler shifts
each step's scores to `log_softmax(logits) + beta * (Q - V)` before the
warps, Q the target Q head (the smaller of the two under `two_qs`) and V
the value head at the new position: ILQL's Q-guided sampling.

With `num_beams > 1` it returns the beam sampler (`ops/beam_search.py`:
beam search, or beam-sample under `do_sample`), after the JAX sampler's
refusals: no ILQL shift, logit masks, `suppress_tokens`, repetition
penalty, capture or speculative decode, and no warpers without
`do_sample`. ILQL under `capture` or `spec_k` raises, as in the JAX
package.

For an encoder-decoder (`model_cfg.is_seq2seq`, the JAX
`generate_seq2seq`) the encoder runs once over the prompt, the cross K/V
are projected once into the cache, and the decoder samples from
`decoder_start_token_id` under the same loop (ILQL's Q-guided shift
over the seq2seq heads included; the repetition penalty sees
decoder-side tokens only, the start token among them). Its samples are
decoder-side only: [start, tokens], and the response keys hold the same
tensors. Capture and speculative decode sample a causal LM only.
"""

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from trlx_tpu_torch.ops.ilql import topk_mask


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
    capture_split: int = 0,  # the hydra split whose entering activation `capture` keeps
    spec_k: int = 0,  # > 0: self-speculative decode, spec_k drafts a round
    spec_split: int = 0,  # the hydra split: the draft trunk's depth
    spec_draft_head: Optional[Tuple[np.ndarray, np.ndarray]] = None,  # (A [d, r], B [r, V])
    two_qs: bool = True,  # ILQL: Q is the smaller of the two target heads
) -> Callable:
    """Build generate(input_ids [b, p], attn_mask [b, p], generator,
    params=None) -> dict(samples, samples_mask, response_tokens,
    response_mask), with outputs [b, p + max_new_tokens] / [b,
    max_new_tokens] like the JAX sampler's, plus `spec_rounds` and
    `spec_accepted` ([b]: rounds each row took part in, drafts it kept)
    under speculative decode. `model` is a `CausalLMWithValueHead` (a
    `CausalLMWithILQLHeads` under mode="ilql") whose parameters live on
    the device the inputs are moved to; `params`, a
    decode view `{name: tensor or (q, scale)}`, replaces those parameters
    for the call (`ops/quant.dequantize_tree`).

    With `capture` the dict also holds "logprobs" [b, max_new] f32 (each
    sampled token's logprob under the raw, unwarped logits, what
    `logprobs_of_labels` reads off the batched forward), "values" [b,
    max_new] f32 (the value head at each token's input position) and
    "h_split" [b, p + max_new, d] (the activation entering block
    `capture_split`; the last sampled token's row is never written and
    stays 0, since it is only ever a masked key or a padding query)."""
    from trlx_tpu_torch.models.transformer import init_kv_cache
    from trlx_tpu_torch.ops.quant import dequantize_tree
    from trlx_tpu_torch.utils.modeling import swapped_params

    if mode not in ("lm", "ilql"):
        raise ValueError(f"mode={mode!r}: expected 'lm' or 'ilql'")
    if mode == "ilql" and (capture or spec_k > 0):
        raise NotImplementedError("capture and speculative decode sample a plain LM (mode='lm') only")
    is_seq2seq = bool(getattr(model_cfg, "is_seq2seq", False))
    if capture and (is_seq2seq or gen_cfg.num_beams > 1):
        raise NotImplementedError("rollout stat capture supports single-beam causal LM generation only (no ILQL, "
                                  "seq2seq, or beam search)")
    if spec_k > 0:
        if is_seq2seq or gen_cfg.num_beams > 1:
            raise NotImplementedError("speculative decode supports single-beam causal LM generation only (no ILQL, "
                                      "seq2seq, or beam search)")
        # the JAX sampler's own refusals: a direct caller must not get a
        # sampler whose distribution differs from the plain one
        if gen_cfg.repetition_penalty != 1.0:
            raise NotImplementedError(
                "speculative decode with repetition_penalty != 1 is not supported (the seen-token mask "
                "would need per-draft rollback)"
            )
        if model_cfg.moe_experts > 0:
            raise NotImplementedError(
                "speculative decode with MoE blocks is not supported (expert routing differs between draft and "
                "verify widths)"
            )
        if spec_split <= 0:
            raise ValueError("speculative decode requires a hydra split > 0 (the frozen trunk is the draft model)")
        if spec_draft_head is None:
            raise ValueError("speculative decode requires a draft head (A, B); see spec_draft_head_from_params")
        if capture and capture_split != spec_split:
            raise ValueError("capture_split must equal spec_split under speculative decode (both are the hydra split)")
    if gen_cfg.num_beams > 1:
        if mode != "lm" or logit_mask is not None or gen_cfg.suppress_tokens:
            raise NotImplementedError("num_beams > 1 supports plain LM generation only (no ILQL advantage shift, "
                                      "transition logit masks, or suppress_tokens)")
        if gen_cfg.repetition_penalty != 1.0:
            raise NotImplementedError("repetition_penalty under num_beams > 1 is not supported")
        if not gen_cfg.do_sample and (gen_cfg.temperature not in (0.0, 1.0) or gen_cfg.top_k or gen_cfg.top_p < 1.0):
            # HF's deterministic beam search takes no warpers either
            raise NotImplementedError("temperature/top_k/top_p with num_beams > 1 require do_sample=True (beam "
                                      "sample); deterministic beam search takes no sampling knobs")
    max_new = gen_cfg.max_new_tokens
    track_seen = gen_cfg.repetition_penalty != 1.0
    greedy = not gen_cfg.do_sample or gen_cfg.temperature == 0.0

    def setup(input_ids, attn_mask):
        device = next(model.parameters()).device
        input_ids = torch.as_tensor(np.asarray(input_ids), device=device).long()
        attn_mask = torch.as_tensor(np.asarray(attn_mask), device=device).to(torch.int32)
        suppress = forbid = None
        if gen_cfg.suppress_tokens:
            suppress = torch.zeros(model_cfg.vocab_size, dtype=torch.float32, device=device)
            suppress[torch.as_tensor(gen_cfg.suppress_tokens, device=device).long()] = -float("inf")
        if logit_mask is not None:
            forbid = torch.as_tensor(np.asarray(logit_mask), device=device).bool()

        def shift(logits, prev, adv=None):
            """suppress_tokens, then the transitions from the previous token,
            then ILQL's advantage shift when `adv` ([b, V]) is given."""
            if suppress is not None:
                logits = logits + suppress
            if forbid is not None:
                logits = torch.where(forbid[prev], -float("inf"), logits)
            if adv is not None:
                logits = torch.log_softmax(logits, dim=-1) + gen_cfg.beta * adv
            return logits

        return device, input_ids, attn_mask, shift

    def step(tokens, cache, token_mask, is_prefill=False):
        """One cached model call: (logits, values, new_cache, h_cap), the
        last two None without capture; under ILQL the values slot holds the
        advantage Q - V [b, t, V]."""
        if mode == "ilql":
            logits, _, target_qs, vs, new_cache = model.decode_step(tokens, cache, token_mask, is_prefill)
            q = torch.minimum(target_qs[0], target_qs[1]) if two_qs else target_qs[0]
            return logits, q - vs, new_cache, None
        if is_seq2seq:
            logits, _, new_cache = model.decode_step(tokens, cache, token_mask, is_prefill)
            return logits, None, new_cache, None
        return model.decode_step(tokens, cache, token_mask, is_prefill, with_value=capture,
                                 capture_split=capture_split if capture else None)

    def capture_buffers(b, plen, width, h_cap):
        """The capture's logprob and value columns and the split
        activations, zeros, with the prefill's prompt rows written."""
        lp = torch.zeros((b, width), dtype=torch.float32, device=h_cap.device)
        hs = torch.zeros((b, plen + width, h_cap.shape[-1]), dtype=h_cap.dtype, device=h_cap.device)
        hs[:, :plen] = h_cap
        return lp, torch.zeros_like(lp), hs

    def decode_loop(shift, cache, logits, value, prev, seen, generator, plen=0, caps=None):
        """Token by token from the prefill's last logits [b, V] (and values)
        and the previous token [b], until every row is finished or the
        budget runs out. `caps` (the capture's buffers) take each token's
        logprob and value and the split activations at `plen + i - 1`.
        Returns (out_tokens [b, max_new], out_mask)."""
        b, device = prev.shape[0], prev.device
        finished = torch.zeros(b, dtype=torch.bool, device=device)
        out_tokens = torch.full((b, max_new), gen_cfg.pad_token_id, dtype=torch.long, device=device)
        out_mask = torch.zeros((b, max_new), dtype=torch.int32, device=device)
        for i in range(max_new):
            if i > 0:
                step_logits, value, cache, h_cap = step(prev[:, None], cache, out_mask[:, i - 1:i])
                logits = step_logits[:, -1].float()
                if caps is not None:  # the split activation at prev's position plen + i - 1
                    caps[2][:, plen + i - 1] = h_cap[:, 0]
            adv = value[:, -1] if mode == "ilql" else None
            scores = process_logits(shift(logits, prev, adv), gen_cfg, i, seen)
            token = select_token(scores, generator, gen_cfg)
            token = torch.where(finished, torch.full_like(token, gen_cfg.pad_token_id), token)
            out_tokens[:, i] = token
            out_mask[:, i] = (~finished).to(torch.int32)
            if caps is not None:
                caps[0][:, i] = sampled_token_logprob(logits, token)
                caps[1][:, i] = value[:, -1].float()
            finished = finished | (token == gen_cfg.eos_token_id)
            if seen is not None:
                seen[torch.arange(b, device=device), token] = True
            prev = token
            if bool(finished.all()):  # early exit, like the JAX while_loop's condition
                break
        return out_tokens, out_mask

    def generate_plain(input_ids, attn_mask, generator):
        device, input_ids, attn_mask, shift = setup(input_ids, attn_mask)
        b, plen = input_ids.shape
        V = model_cfg.vocab_size
        cache = init_kv_cache(model_cfg, b, plen + max_new, device=device)
        logits, value, cache, h_cap = step(input_ids, cache, attn_mask, is_prefill=True)
        logits = logits[:, -1].float()
        caps = capture_buffers(b, plen, max_new, h_cap) if capture else None
        seen = None
        if track_seen:  # HF semantics: the penalty covers prompt tokens too
            counts = torch.zeros((b, V), dtype=torch.int32, device=device)
            rows = torch.arange(b, device=device)[:, None].expand(b, plen)
            counts.index_put_((rows, input_ids), attn_mask, accumulate=True)
            seen = counts > 0
        out_tokens, out_mask = decode_loop(shift, cache, logits, value, input_ids[:, -1], seen, generator, plen,
                                           caps)
        out = {
            "samples": torch.cat([input_ids, out_tokens], dim=1),
            "samples_mask": torch.cat([attn_mask, out_mask], dim=1),
            "response_tokens": out_tokens,
            "response_mask": out_mask,
        }
        if capture:
            out.update(logprobs=caps[0], values=caps[1], h_split=caps[2])
        return out

    def generate_seq2seq(input_ids, attn_mask, generator):
        """The encoder runs once; the decoder starts from
        `decoder_start_token_id` with a cache of 1 + max_new columns."""
        device, input_ids, attn_mask, shift = setup(input_ids, attn_mask)
        b = input_ids.shape[0]
        start_id = int(getattr(model_cfg, "decoder_start_token_id", gen_cfg.pad_token_id))
        cache = model.prepare_cache(model.encode(input_ids, attn_mask), attn_mask, 1 + max_new)
        start = torch.full((b, 1), start_id, dtype=torch.long, device=device)
        ones = torch.ones((b, 1), dtype=torch.int32, device=device)
        logits, value, cache, _ = step(start, cache, ones, is_prefill=True)
        seen = None
        if track_seen:  # decoder-side tokens only (HF penalizes the decoder's input ids)
            seen = torch.zeros((b, model_cfg.vocab_size), dtype=torch.bool, device=device)
            seen[:, start_id] = True
        out_tokens, out_mask = decode_loop(shift, cache, logits[:, -1].float(), value, start[:, 0], seen, generator)
        samples = torch.cat([start, out_tokens], dim=1)
        samples_mask = torch.cat([ones, out_mask], dim=1)
        return {"samples": samples, "samples_mask": samples_mask, "response_tokens": samples,
                "response_mask": samples_mask}

    def generate_spec(input_ids, attn_mask, generator):
        """The draft/verify rounds. Each round feeds the pending token and k
        drafted ones through the trunk alone (k + 1 per-row steps, the
        low-rank readout between them), runs one suffix pass over all k + 1
        positions from the trunk's own rows, keeps the longest accepted
        draft prefix plus one corrected (or bonus) token, and rolls the
        rejected K/V back by clearing mask bits. One host sync a round (the
        loop's condition), as the plain loop's `finished.all()`."""
        k = spec_k
        device, input_ids, attn_mask, shift = setup(input_ids, attn_mask)
        b, plen = input_ids.shape
        pad, eos = gen_cfg.pad_token_id, gen_cfg.eos_token_id
        a_fac = torch.as_tensor(spec_draft_head[0], device=device).to(model_cfg.dtype)
        b_fac = torch.as_tensor(spec_draft_head[1], device=device).to(model_cfg.dtype)
        warp = lambda raw, prev, step: process_logits(shift(raw, prev), gen_cfg, step, None)
        # k spare columns: a round may write k positions past the budget
        # before the rollback clears them
        cache = init_kv_cache(model_cfg, b, plen + max_new + k, device=device)
        logits, value, cache, h_cap = step(input_ids, cache, attn_mask, is_prefill=True)
        logits = logits[:, -1].float()
        # token 0: the plain sampler's preamble (same prefill, same draw)
        token0 = select_token(warp(logits, input_ids[:, -1], 0), generator, gen_cfg)
        finished = (token0 == eos) | (max_new <= 1)
        # one spare output column takes the writes JAX drops (index max_new)
        out_tokens = torch.full((b, max_new + 1), pad, dtype=torch.long, device=device)
        out_mask = torch.zeros((b, max_new + 1), dtype=torch.int32, device=device)
        out_tokens[:, 0] = token0
        out_mask[:, 0] = 1
        if capture:
            # a spare column and row take the writes JAX drops, as above
            lp_buf, v_buf, hs_buf = capture_buffers(b, plen, max_new + 1, h_cap)
            lp_buf[:, 0] = sampled_token_logprob(logits, token0)
            v_buf[:, 0] = value[:, -1].float()
        # the prefill's scalar index becomes per-row offsets: rows diverge
        # once they keep different numbers of drafts
        cache = {"row_index": torch.full((b,), cache["index"], dtype=torch.long, device=device),
                 "mask": cache["mask"], "pos": cache["pos"], "layers": cache["layers"]}
        pending = token0
        out_i = torch.ones(b, dtype=torch.long, device=device)
        rounds = torch.zeros(b, dtype=torch.long, device=device)
        accepted = torch.zeros(b, dtype=torch.long, device=device)
        jidx = torch.arange(k + 1, device=device)[None, :]
        rows_b = torch.arange(b, device=device)[:, None]
        i = 0
        while i <= max_new and not bool(finished.all()):
            active = ~finished
            act_i = active.long()
            row_start, pos_start = cache["row_index"], cache["pos"]
            f = pending
            h_rows, q_scores, drafts, fed = [], [], [], [pending]
            for j in range(k + 1):
                h_j, hn_j, cache = model.spec_draft_step(f[:, None], cache, act_i[:, None], spec_split)
                h_rows.append(h_j)
                if j < k:
                    sq = warp(((hn_j[:, 0] @ a_fac) @ b_fac).float(), f, out_i + j)
                    f = select_token(sq, generator, gen_cfg)
                    q_scores.append(sq)
                    drafts.append(f)
                    fed.append(f)
            positions = pos_start[:, None] + jidx
            h_block = torch.cat(h_rows, dim=1)  # [b, k + 1, d]
            logits_v, values_v, _ = model.spec_verify_rows(h_block, cache, row_start, positions, spec_split,
                                                           with_value=capture)
            logits_v = logits_v.float()
            p_scores = [warp(logits_v[:, j], fed[j], out_i + j) for j in range(k + 1)]
            # the longest accepted draft prefix, m tokens
            if greedy:
                acc = [torch.argmax(p_scores[j], dim=-1) == drafts[j] for j in range(k)]
            else:
                acc = []
                for j in range(k):
                    u = torch.rand(b, generator=generator, device=device)
                    tok = drafts[j][:, None]
                    lr = (torch.log_softmax(p_scores[j], -1).gather(1, tok)
                          - torch.log_softmax(q_scores[j], -1).gather(1, tok))[:, 0]
                    acc.append(u < torch.exp(torch.clamp(lr, max=0.0)))
            run = torch.ones(b, dtype=torch.bool, device=device)
            m = torch.zeros(b, dtype=torch.long, device=device)
            for j in range(k):
                run = run & acc[j]
                m = m + run.long()
            # the token after the kept drafts, for each possible m: greedy,
            # the full model's argmax; sampled, a draw from the residual
            # normalize(clip(p - q, 0)) after a rejection at j, or from p
            # itself (the bonus token) when all k were kept
            corr = []
            for j in range(k + 1):
                if greedy:
                    corr.append(torch.argmax(p_scores[j], dim=-1))
                elif j < k:
                    p_w = torch.softmax(p_scores[j], -1)
                    res = torch.clamp(p_w - torch.softmax(q_scores[j], -1), min=0.0)
                    tot = res.sum(-1, keepdim=True)
                    res = torch.where(tot > 0, res / tot, p_w)
                    corr.append(torch.multinomial(res, 1, generator=generator)[:, 0])
                else:
                    corr.append(select_token(p_scores[j], generator, gen_cfg))
            corr = torch.stack(corr, dim=1)  # [b, k + 1]
            corr_at_m = corr.gather(1, m[:, None])[:, 0]
            draft_mat = torch.stack(drafts + [corr[:, k]], dim=1)
            emit = torch.where(jidx < m[:, None], draft_mat,
                               torch.where(jidx == m[:, None], corr_at_m[:, None], pad))
            # eos and budget truncation of this round's emissions
            alive, valids = active, []
            for j in range(k + 1):
                v_j = alive & (j <= m) & (out_i + j < max_new)
                valids.append(v_j)
                alive = v_j & (emit[:, j] != eos)
            valid = torch.stack(valids, dim=1)
            emit = torch.where(valid, emit, pad)
            e = valid.long().sum(1)
            hit_eos = (valid & (emit == eos)).any(1)
            new_out_i = out_i + e
            new_finished = finished | (active & (hit_eos | (new_out_i >= max_new)))
            pending = torch.where(active & ~new_finished, corr_at_m, pending)
            # roll back: keep the mask bits of the e fed-and-kept tokens,
            # clear the rest; the next round writes from the first cleared
            cache["mask"] = cache["mask"].scatter(1, row_start[:, None] + jidx,
                                                  (jidx < e[:, None]).to(cache["mask"].dtype))
            cache["row_index"], cache["pos"] = row_start + e, pos_start + e
            out_idx = torch.where(valid, out_i[:, None] + jidx, max_new)
            out_tokens[rows_b, out_idx] = emit
            out_mask[rows_b, out_idx] = valid.to(torch.int32)
            if capture:
                lp_emit = torch.log_softmax(logits_v, dim=-1).gather(2, emit[..., None])[..., 0]
                lp_buf[rows_b, out_idx] = lp_emit
                v_buf[rows_b, out_idx] = values_v.float()
                # the rows of the fed tokens f_0..f_{e-1} at their positions
                # plen + out_i - 1 + j; the last emitted token's row is never
                # written (as in the plain capture)
                h_idx = torch.where(jidx < e[:, None], plen + out_i[:, None] - 1 + jidx, plen + max_new)
                hs_buf[rows_b, h_idx] = h_block.to(hs_buf.dtype)
            rounds += act_i
            accepted += m * act_i
            out_i, finished = new_out_i, new_finished
            i += 1
        out_tokens, out_mask = out_tokens[:, :max_new], out_mask[:, :max_new]
        out = {
            "samples": torch.cat([input_ids, out_tokens], dim=1),
            "samples_mask": torch.cat([attn_mask, out_mask], dim=1),
            "response_tokens": out_tokens,
            "response_mask": out_mask,
            "spec_rounds": rounds,
            "spec_accepted": accepted,
        }
        if capture:
            out.update(logprobs=lp_buf[:, :max_new], values=v_buf[:, :max_new],
                       h_split=hs_buf[:, :plen + max_new])
        return out

    if gen_cfg.num_beams > 1:
        from trlx_tpu_torch.ops.beam_search import make_beam_generate_fn

        sample = make_beam_generate_fn(model, model_cfg, gen_cfg)
    elif is_seq2seq:
        sample = generate_seq2seq
    else:
        sample = generate_spec if spec_k > 0 else generate_plain

    @torch.no_grad()
    def generate(input_ids, attn_mask, generator: Optional[torch.Generator] = None, params: Optional[Dict] = None):
        view = dequantize_tree(params, model_cfg.dtype) if params else None
        with swapped_params(model, view):
            return sample(input_ids, attn_mask, generator)

    return generate


def spec_draft_head_from_params(state: Dict, model_cfg, rank: int) -> Tuple[np.ndarray, np.ndarray]:
    """The low-rank draft readout (A [d, r], B [r, V]) from the dense f32
    unembedding W_U [d, V] (the tied embedding transposed, or the untied
    head's JAX kernel), by a truncated SVD in numpy on the host, as the
    JAX package computes it, so both packages get the same factors. Draft
    logits = ln_f(h_split) @ A @ B. `state` is the policy's state dict
    (`lm.*` names)."""
    if model_cfg.tie_embeddings:
        w = state["lm.embed_tokens.weight"].T
    else:
        w = state["lm.lm_head.weight"].T  # the port's [V, d] Linear weight
    w = np.asarray(w.detach().cpu().float().numpy(), np.float32)
    r = int(min(rank, min(w.shape)))
    u, s, vt = np.linalg.svd(w, full_matrices=False)
    return (u[:, :r] * s[:r][None, :]).astype(np.float32), vt[:r].astype(np.float32)


def generate(model, model_cfg, input_ids, attn_mask, gen_cfg: GenerationConfig,
             generator: Optional[torch.Generator] = None, mode: str = "lm", logit_mask=None, two_qs: bool = True):
    """One-shot convenience wrapper over `make_generate_fn`."""
    return make_generate_fn(model, model_cfg, gen_cfg, mode, logit_mask, two_qs=two_qs)(input_ids, attn_mask,
                                                                                        generator)
