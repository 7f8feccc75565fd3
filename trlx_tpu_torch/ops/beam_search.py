"""Beam search (port of the JAX package's `ops/beam_search.py`: its causal
`generate` and its `generate_seq2seq`).

Two modes, as HF generate runs them:
- deterministic beam search (`do_sample=False`): the top 2B candidates
  by accumulated logprob;
- beam-sample (`do_sample=True`): HF's order, `log_softmax` first, then
  `min_new_tokens`, temperature, top-k and top-p on the log-probs with no
  renormalisation, then 2B candidates drawn without replacement from
  softmax of the accumulated [b, B*V] scores by the Gumbel-top-k trick
  (`beam_gumbel`, the one noise draw), their scores gathered from the
  un-noised values.

Each step's 2B candidates follow HF's BeamSearchScorer: those ending in
EOS are banked into a per-row store of the B best finished hypotheses by
`score / generated_len ** length_penalty` (generated_len counts the
tokens before the EOS; at the first step the score is -1e9), and the B
best non-EOS candidates continue as live beams, the dense KV cache's
rows reordered to follow them. At the end the live beams join the pool at
generated_len = max_new_tokens and the best normalised score wins.

Every selection is `top_k`, a stable descending sort: equal values keep
the lower index first, as `lax.top_k` does (ties are certain: the dead
beams of the first step and the finished store both start at -1e9), so
the reordered cache and the winner are the JAX sampler's. The JAX loop
runs one more model step after the last token, whose output it never
reads; this one does not.

An encoder-decoder encodes each prompt once, repeats the encoder's rows
(and the prompt mask) for its B beams, projects the cross K/V into the
cache and decodes from `decoder_start_token_id`; the reorder takes the
cross K/V and the encoder mask along, as the JAX `_gather_beams` takes
every leaf.

The output is the sampler's dict: `samples`, `samples_mask`,
`response_tokens` and `response_mask`, the winning hypothesis of each row
(for an encoder-decoder, [start, tokens] in every key).
"""

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from trlx_tpu_torch.ops.ilql import topk_mask
from trlx_tpu_torch.ops.sampling import topp_mask

NEG_INF = -1.0e9


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """`lax.top_k` over the last axis: the k largest values, descending,
    and their indices, the lower index first among equal values."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def beam_gumbel(generator: Optional[torch.Generator], step: int, shape, device) -> torch.Tensor:
    """Standard Gumbel noise [shape] f32 for beam-sample's step `step`
    (the JAX sampler draws `gumbel(fold_in(rng, step), shape)`; torch
    draws the steps in order from `generator`): -log(-log(u)), u uniform
    on [tiny, 1)."""
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    u = u.clamp(min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def make_beam_generate_fn(model, model_cfg, gen_cfg) -> Callable:
    """Build generate(input_ids [b, p], attn_mask [b, p], generator) ->
    the sampler's dict, for `model` a policy (or LM) whose `decode_step`
    runs the fixed-slot dense cache. `generator` drives beam-sample's
    draws and is unused by deterministic beam search."""
    from trlx_tpu_torch.models.transformer import init_kv_cache

    B = gen_cfg.num_beams
    max_new = gen_cfg.max_new_tokens
    lp = gen_cfg.length_penalty
    eos, pad = gen_cfg.eos_token_id, gen_cfg.pad_token_id

    def step_model(tokens, cache, token_mask, is_prefill):
        out = model.decode_step(tokens, cache, token_mask, is_prefill)
        return out[0][:, -1].float(), out[2]

    def reorder(cache, flat_idx):
        """Every per-row tensor of the cache (mask, pos, each layer's k and
        v; an encoder-decoder's encoder mask and cross k and v) follows the
        selected beams (the JAX `_gather_beams`)."""
        sel = lambda t: t.index_select(0, flat_idx)
        out = dict(cache, mask=sel(cache["mask"]), pos=sel(cache["pos"]),
                   layers=[{name: sel(t) for name, t in layer.items()} for layer in cache["layers"]])
        if "cross" in cache:
            out["enc_mask"] = sel(cache["enc_mask"])
            out["cross"] = [{name: sel(t) for name, t in c.items()} for c in cache["cross"]]
        return out

    def warp(logits, i):
        """HF's order: log_softmax, then the processors and (sampling) the
        warpers on the log-probs, with no renormalisation."""
        logprobs = torch.log_softmax(logits, dim=-1)
        if gen_cfg.min_new_tokens > 0 and i < gen_cfg.min_new_tokens:
            logprobs = logprobs.clone()
            logprobs[:, eos] += NEG_INF
        if gen_cfg.do_sample:
            if gen_cfg.temperature not in (0.0, 1.0):
                logprobs = logprobs / gen_cfg.temperature
            if gen_cfg.top_k and gen_cfg.top_k > 0:
                logprobs = topk_mask(logprobs, gen_cfg.top_k)
            if gen_cfg.top_p < 1.0:
                logprobs = topp_mask(logprobs, gen_cfg.top_p)
        return logprobs

    def decode(cache, logits, b, generator):
        device = logits.device
        V = logits.shape[-1]
        rows = torch.arange(b, device=device)[:, None]
        # beam 0 live, the others at -1e9, so the first step picks B distinct tokens
        scores = torch.full((b, B), NEG_INF, dtype=torch.float32, device=device)
        scores[:, 0] = 0.0
        live_toks = torch.full((b, B, max_new), pad, dtype=torch.long, device=device)
        fin_scores = torch.full((b, B), NEG_INF, dtype=torch.float32, device=device)
        fin_toks = torch.full((b, B, max_new), pad, dtype=torch.long, device=device)
        fin_masks = torch.zeros((b, B, max_new), dtype=torch.int32, device=device)
        step_ids = torch.arange(max_new, device=device)
        for i in range(max_new):
            total = scores[:, :, None] + warp(logits, i).reshape(b, B, V)
            flat = total.reshape(b, B * V)
            if gen_cfg.do_sample:
                _, c_idx = top_k(flat + beam_gumbel(generator, i, flat.shape, device), 2 * B)
                c_scores = torch.gather(flat, 1, c_idx)
            else:
                c_scores, c_idx = top_k(flat, 2 * B)
            c_beam = c_idx // V  # [b, 2B]
            c_tok = c_idx % V
            is_eos = c_tok == eos

            # bank the EOS candidates into the finished store
            gen_len = torch.tensor(float(max(i, 1)), dtype=torch.float32, device=device)
            cand_norm = torch.where(is_eos & (i > 0), c_scores / gen_len ** lp,
                                    torch.full_like(c_scores, NEG_INF))
            cand_toks = live_toks[rows, c_beam].clone()
            cand_toks[:, :, i] = eos
            cand_mask = (step_ids <= i).to(torch.int32).expand(b, 2 * B, max_new)
            all_scores = torch.cat([fin_scores, cand_norm], dim=1)  # [b, 3B]
            fin_scores, keep = top_k(all_scores, B)
            fin_toks = torch.cat([fin_toks, cand_toks], dim=1)[rows, keep]
            fin_masks = torch.cat([fin_masks, cand_mask], dim=1)[rows, keep]

            # the B best non-EOS candidates continue
            scores, pick = top_k(torch.where(is_eos, torch.full_like(c_scores, NEG_INF), c_scores), B)
            sel_beam = torch.gather(c_beam, 1, pick)
            sel_tok = torch.gather(c_tok, 1, pick)
            live_toks = live_toks[rows, sel_beam]
            live_toks[:, :, i] = sel_tok
            if i + 1 < max_new:
                cache = reorder(cache, (rows * B + sel_beam).reshape(-1))
                ones = torch.ones((b * B, 1), dtype=torch.int32, device=device)
                logits, cache = step_model(sel_tok.reshape(b * B, 1), cache, ones, False)
        # the live beams join the pool at generated_len == max_new
        live_norm = scores / float(max_new) ** lp
        all_scores = torch.cat([fin_scores, live_norm], dim=1)
        all_toks = torch.cat([fin_toks, live_toks], dim=1)
        all_masks = torch.cat([fin_masks, torch.ones_like(fin_masks)], dim=1)
        best = torch.argmax(all_scores, dim=1)  # the first maximum
        r = torch.arange(b, device=device)
        return all_toks[r, best], all_masks[r, best]

    def generate_seq2seq(input_ids, attn_mask, generator: Optional[torch.Generator] = None):
        device = next(model.parameters()).device
        input_ids = torch.as_tensor(np.asarray(input_ids), device=device).long()
        attn_mask = torch.as_tensor(np.asarray(attn_mask), device=device).to(torch.int32)
        b = input_ids.shape[0]
        start_id = int(getattr(model_cfg, "decoder_start_token_id", pad))
        enc_h = model.encode(input_ids, attn_mask).repeat_interleave(B, dim=0)
        cache = model.prepare_cache(enc_h, attn_mask.repeat_interleave(B, dim=0), 1 + max_new)
        start = torch.full((b * B, 1), start_id, dtype=torch.long, device=device)
        logits, cache = step_model(start, cache, torch.ones((b * B, 1), dtype=torch.int32, device=device), True)
        out_tokens, out_mask = decode(cache, logits, b, generator)
        samples = torch.cat([torch.full((b, 1), start_id, dtype=torch.long, device=device), out_tokens], dim=1)
        samples_mask = torch.cat([torch.ones((b, 1), dtype=torch.int32, device=device), out_mask], dim=1)
        return {"samples": samples, "samples_mask": samples_mask, "response_tokens": samples,
                "response_mask": samples_mask}

    def generate(input_ids, attn_mask, generator: Optional[torch.Generator] = None):
        device = next(model.parameters()).device
        input_ids = torch.as_tensor(np.asarray(input_ids), device=device).long()
        attn_mask = torch.as_tensor(np.asarray(attn_mask), device=device).to(torch.int32)
        b, plen = input_ids.shape
        cache = init_kv_cache(model_cfg, b * B, plen + max_new, device=device)
        logits, cache = step_model(input_ids.repeat_interleave(B, dim=0), cache,
                                   attn_mask.repeat_interleave(B, dim=0), True)
        out_tokens, out_mask = decode(cache, logits, b, generator)
        return {
            "samples": torch.cat([input_ids, out_tokens], dim=1),
            "samples_mask": torch.cat([attn_mask, out_mask], dim=1),
            "response_tokens": out_tokens,
            "response_mask": out_mask,
        }

    return generate_seq2seq if getattr(model_cfg, "is_seq2seq", False) else generate
