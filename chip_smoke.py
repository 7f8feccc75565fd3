#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`trlx_tpu_torch`) on one
NVIDIA GPU. Run from the root of a checkout with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and ignored):

1. the card: name and power limit (nvidia-smi), torch and CUDA versions;
2. build every kernel in trlx_tpu_torch/csrc/ from source (one nvcc per
   source, all started together);
3. each kernel against its plain PyTorch version on the card, at the
   shapes of gpt2-small (12/12/64), llama-7b (32/32/128), GQA (32/8/128)
   and MQA (16/1/64) with 32-token blocks, row lengths at block
   boundaries plus one inactive row (exactly 0), and at gqa-4k (Llama-3-8B's
   32/8/128 over rows of up to 4096 tokens, crossing split edges), KV in
   f32, bf16 and int8; two calls on the same inputs bitwise equal; with
   kernel, plain-version, library (scaled_dot_product_attention over the
   gathered KV, a yardstick the port never calls) and bound times (device
   time per call, from torch.profiler, or from CUDA events where two
   traces in a row hold no device event);
4. serving, the port's main path: `SFTTrainer(config).serve()` of
   random:gpt2-small at full width (vocab 50257, bf16 activations) with a
   paged KV pool answers 16 concurrent POST /generate requests, and the
   kernel's launch count equals decode dispatches x layers; then the same
   with an int8 KV pool;
5. greedy equality on the card: the engine with the kernel and with the
   gather path emit identical greedy token streams at f32 across slot
   reuse (int8 KV: at most one stream may differ);
6. the training kernels against their plain versions on the card: flash
   attention forward without and with lse (K3, K4), backward dq (K5) and
   dk/dv (K6) at gpt2-small training shapes (b 8, t 1024, 12/12/64, bf16,
   left-padded rows and one row with no valid key), llama-7b (32/32/128)
   and GQA (32/8/128) at t 2048, b 1, and at phase 9's shapes (t 104, rows
   padded at both ends, one with a hole, one with no valid key: b 128 for
   K3, b 32 for K4-K6); the label logprob (K7) at [8184, 50257] bf16 with
   out-of-range labels, at [128 x 104, 50257] on shifted labels, at
   [32 x 40, 50257], at [128 x 40, 50257] (phase 12's fast scorer) and at
   [32 x 104, 50257] on shifted labels (phase 13's full-forward step),
   and its backward kernel at [8184, 50257] (g = 0 on the masked rows,
   which must come out all zeros), [32 x 40, 50257] and [32 x 104, 50257]
   (g = 0 outside the response window); K4-K6 at phase 14's step (b 128,
   t 64, full rows);
   with kernel, plain-version, library (scaled_dot_product_attention
   forward / backward; logsumexp plus gather; the backward of
   cross_entropy) and bound times, and the share of causal tiles the bf16
   forward and backward skip as padding;
7. training, the port's second main path: `trlx_tpu_torch.train(samples=
   ..., config=cfg)` runs SFT on random:gpt2-small at full width (seq 1024,
   batch 8, bf16 activations, attn_impl="flash", num_layers_unfrozen=2):
   per-step loss (within 0.02 of the recorded losses), step time, training
   tokens/s and evaluation time; the launch counts equal K3 x10, K4 x2, K5
   x2, K6 x2, K7 x1 and K7's backward x1 per step; the `done` checkpoint
   loads into a fresh trainer with equal parameters;
8. one SFT step at f32 with the kernels and with their plain versions
   gives equal loss and trainable-parameter gradients;
9. PPO, the port's third main path: `trlx_tpu_torch.train(reward_fn=...,
   prompts=..., config=cfg)` on random:gpt2-small at full width
   (`default_ppo_config`: 128 rollouts a collection of 64-byte prompts and
   40 sampled tokens, batch 32, 4 PPO epochs, num_layers_unfrozen=2, bf16,
   attn_impl="flash", 2 collections and 32 optimizer steps; checkpoints and
   logs under `build/chip_smoke_ppo/`): per collection generate and score
   seconds and rollout tokens/s, per step time and training tokens/s,
   samples/s per cycle, the evaluations' reward; every loss finite; the
   launch counts exact (per step K3 x10, K4-K6 x2, K7 and its backward x1;
   per scoring chunk K3 x14, K7 x2); the `done` checkpoint loads into a
   fresh PPOTrainer with the same policy, reference, KL value, running
   moments and store;
10. one injected 32-row rollout batch at f32 (4 layers): the scoring pass
   (logprobs, values, log-ratio against a perturbed reference) and one PPO
   step with the kernels and with their plain versions agree (scoring
   within 1e-5, the loss and gradients within phase 8's tolerances);
11. PPO with the JAX bench's headline options: phase 9's run with
   `cache_trunk_activations`, `speculative_decode` (spec_k 4, draft rank
   64) and `quantize_frozen_trunk` on (`build/chip_smoke_ppo_options/`):
   the same per-collection and per-step numbers plus the speculative
   acceptance rate, tokens per round and the trunk fill's ms a chunk,
   printed beside phase 9's; launch counts exact (per step K3 x0, K4-K6
   x2, K7 and its backward x1; per chunk K3 x24, 10 for the trunk fill
   and 14 for scoring, and K7 x2); no speculative fallback, the trunk
   cache on for every rollout; the checkpoint (its store carrying the
   cache rows) loads back; the int8 decode view's build time and bytes;
   greedy speculative vs plain sampling of 128 prompts x 40 tokens on the
   int8 view at f32 (a row may differ only where the plain sampler's top
   two warped scores lie within 1e-4) and at bf16 (the share of equal
   rows); one f32 PPO step from an f32 trunk cache equals the full path
   (loss within 1e-6 relative, gradients within phase 8's tolerance under
   phase 10's ReLU gate, no K3), a bf16 cache within 2e-3 relative;
12. the pipelined cycle, the JAX bench's timed schedule: phase 9's
   configuration under `PPOTrainer.pipelined_cycle` (one warm-up and 3
   timed cycles) as (a) the speculative scorer, options off, (b) (a) with
   the capture fast path (`capture_rollout_stats`), (c) phase 11's options,
   (d) (c) with the fast path: samples/s per cycle beside phases 9 and 11,
   the blocking fetch's wait and the host stage's ms, then one cycle under
   synchronizing probes for the sampling, scoring (by scorer), trunk-cache
   attach and step ms; no speculative-scorer fallback, the fast scorer
   taken in (b) and (d), launch counts exact (a chunk K3 x14 / x2 / x24 /
   x2 and K7 x2 / x1 / x2 / x1; a step phase 9's or phase 11's), every
   loss finite; at f32 the fast scorer against the batched scoring forward
   within 5e-4 and the speculative merge against the classic in-graph
   scorer within 1e-5;
13. PPO's value branch: phase 9's configuration with
   `num_value_layers_unfrozen=2` (clones of the top 2 blocks and the final
   norm, tapping at the split), one collection and 16 steps, then the same
   with `cache_trunk_activations` (`build/chip_smoke_value_branch_*`):
   the numbers of phase 9 printed beside phase 9's; launch counts exact (a
   step K3 x10, K4-K6 x4, K7 and its backward x1 over the full logits; a
   chunk K3 x16, K7 x2; with the cache a step K3 x0, a chunk K3 x26); the
   checkpoint loads back; at f32 (4 layers) one scoring pass and step with
   the kernels vs the plain versions under the plain run's ReLU gates, and
   the cached step against the full one (loss within 1e-6 relative, no K3);
14. ILQL, the port's fourth main path: `trlx_tpu_torch.train(samples=...,
   rewards=..., config=cfg)` with `default_ilql_config` at gpt2-small
   full width (vocab 50257, bf16, flash, every block trainable, seq 64,
   batch 128, a target sync every 5 steps, 10 steps) on 1280 seeded
   dialogues of a 32-byte prompt and a 32-byte output with a host reward
   (`build/chip_smoke_ilql/`): per-step loss and terms, step time,
   training tokens/s and peak device memory; two Q-guided evaluations of
   128 prompts x 56 tokens (beta 1, top_k 20, printable ASCII), seconds
   and tokens/s; launches exact (a step K4-K6 x12, K3 and K7 x0); the
   target heads move at the syncs only, each exactly alpha * q + (1 -
   alpha) * target; the `done` checkpoint loads into a fresh ILQLTrainer
   with equal parameters, target heads included; one f32 step (4 layers,
   b 32) with the kernels vs the plain versions under the plain run's ReLU
   gates;
15. GRPO and RLOO, the port's fifth main path: `trlx_tpu_torch.train(
   reward_fn=..., config=...)` with `default_grpo_config` at phase 9's
   configuration (16 prompts x G 8 a 128-row chunk, 2 collections and 32
   steps, `build/chip_smoke_grpo/`), then one collection under
   `advantage_mode="rloo"`: phase 9's numbers beside phase 9's (samples/s
   per cycle, sampling and scoring s, step s), launches exact (a step and
   a chunk as phase 9's), no value-head key in the state dict, every
   group's advantages summing to 0 within 1e-5, the checkpoint reloaded;
   one f32 scoring pass and step (4 layers) kernels vs plain versions,
   every gradient element held (no MLP head);
16. loading by path and RFT, the sixth: a gpt2-small trainer's
   `save_pretrained` export loaded by `model_path` gives bitwise its
   parameters and logits; `default_rft_config` from that directory cut to
   4 generations per prompt, one batch of 8 prompts and 2 epochs
   (`build/chip_smoke_rft/`): the growth step's generation seconds, the
   samples selected, step time and training tokens/s, launches exact (a
   step K4-K6 x12, K7 and its backward, no K3); one f32 step (4 layers)
   kernels vs plain versions.
17. the single-replica serving surface at gpt2-small full width: (a) the
   default `inference` section (the fixed-slot pool) answers phase 4's 16
   requests, every decode dispatch a `kv_paging_off` fallback and no
   paged-kernel launch, its f32 greedy streams equal to the paged engine's
   with the kernel on phase 5's prompts, tokens/s and median TTFT beside
   phase 4's and beside the same burst on the paged pool run just after;
   (b) an SFT run through `trlx_tpu_torch.train` writes its
   checkpoint under the server's `watch_dir`, /healthz's checkpoint_step
   advances, a greedy reply afterwards equals a fresh engine's on the
   run's weights, `/admin/drain` answers 503 until `/admin/undrain`; (c) SSE
   token deltas concatenate to the non-streaming reply; (d) four-turn
   /chat over bf16 and int8 arenas, K1 (K2) launches = decode dispatches x
   12, retained blocks reused, a turn's TTFT beside a fresh prompt's of the
   same length, and at f32 every turn equal to /generate over the whole
   transcript; (e) the engine's speculative decode (spec_k 4, split 10) at
   f32: greedy equal to the plain engine under phase 11's tie rule, K1
   launches = (spec_k + 1) x split a dispatch, tokens/s beside the plain
   engine's.
18. the rollout fleet at phase 9's configuration (random:gpt2-small full
   width, bf16, flash), collecting through the trainer's own supervised
   fleet (`train.rollout_backend="fleet"`, `rollout_fleet_supervised`, 2
   thread replicas of 64 paged slots): (a) PPO through
   `trlx_tpu_torch.train`, 2 collections and 32 steps: 128 rows a
   collection, no degraded chunk, K1 = the replicas' decode dispatches x
   12, phase 9's launches a chunk and a step, every row with the
   replicas' behaviour logprobs, samples/s per cycle beside phase 9's, the
   checkpoint reloaded; then on one trainer the rollout seconds and the
   device's busy share of a fleet and a local collection, each seat's
   device memory and what a kill gives back (shutdown alone, release), and
   (b) seat 0 killed from inside the first chunk's reward_fn: 128 rows
   still, the death counted, capacity restored, device memory back within
   one replica's footprint; (c) at f32 (4 layers) greedy fleet rollouts
   equal the local sampler's under phase 11's tie rule and the behaviour
   logprobs are within 1e-4 of the scorer's; (f) every replica killed and
   supervision stopped: the chunk is collected locally, one degraded
   chunk; (g) `python -m trlx_tpu_torch.inference.serve_policy` as a
   SubprocessReplica on the card: /healthz, f32 greedy replies equal an
   in-process replica's, respawned after a kill; (d) GRPO's `n` fan-out
   at phase 15's configuration (1 collection): 16 requests for 128 rows,
   prefix blocks shared, K1 exact; (e) 32 CalculatorEnv episodes (up to
   4 turns of 8 tokens) over /chat, PPO and GRPO (same-seed groups of 4):
   retained-KV turns, K1 exact, one step with the loss masks; at f32
   every policy turn equals /generate over its transcript.
19. the reward model, reward serving and best-of-n, then the resilience
   of training (`build/chip_smoke_{bon,chaos,resume,drain}*`): (a) a
   reward model (`models/reward.py`) at gpt2-small full width (bf16, flash)
   trained pairwise for 40 steps on seeded separable pairs, held-out
   accuracy above 0.9, a scoring call K3 x12 and a step K4-K6 x12 exactly;
   at f32 (4 layers) its rewards and one step's gradients kernels vs plain
   versions; (b) it serves behind `serving.RewardModelServer` with a
   `mixed` fault injector (remote scores equal `make_reward_fn`'s), and
   best-of-n (`default_bon_config`, 8 prompts x n 4 x 40 tokens)
   runs through `trlx_tpu_torch.train(reward_fn=remote_reward_fn(url))`
   locally (3 rounds, 2 CE steps) and on two in-process replicas of the
   trainer with the `n` fan-out (K1 = the replicas' decode dispatches x
   12); a CE step RFT's launches, K3 = 12 x the reward model's calls; at
   f32 (4 layers, greedy) the fleet's candidates equal the local sampler's
   under phase 11's tie rule; (c) phase 9's configuration with the health
   sentinel, the step watchdog (`on_timeout` injected) and a FaultInjector
   (NaN at step 3, 1e4 spikes at 7 and 8, an 8 s hang at 12): the NaN and
   spike steps skipped with the trainable parameters, Adam state and
   schedule bitwise unchanged (the NaN and huge gradients reach the guard
   through K5, K6 and K7's backward), one rewind to last_good, the
   watchdog fired by the hang, 32 steps completed, launches exact a step
   and a chunk; (d) at 4 layers two uninterrupted PPO runs (the card's
   repeat spread), a run in its own process sent SIGTERM after step 6
   exits 75, and a new trainer with `auto_resume` continues from its
   `_preempt` checkpoint to the uninterrupted run's parameters (bitwise
   when the card repeats bitwise, else within the spread); (e) `python -m
   trlx_tpu_torch.inference.serve_policy` at gpt2-small under SIGTERM
   with 8 requests of 256 tokens in flight: 8 full replies, 503 with
   Retry-After for a new one, exit 0.
Phase 6 also holds K7 and its backward at the randomwalks curves' rows (a
24-token vocabulary, f32 and bf16, shifted labels, padded rows).

The line before the last is the card's name and power limit; the line
before that is the `kernels` JSON object (with `ppo_options`, phase 11's
checks and numbers, `pipelined`, phase 12's, `value_branch`, phase 13's,
`ilql`, phase 14's, `grpo` and `rft`, phases 15 and 16, `serving`, phase
17's, `fleet`, phase 18's, `phase19`, phase 19's); the last line is
`{"ok": true, "device": {...}}`. Exits non-zero without a CUDA device, and
outside a checkout of the repository.
"""

import json
import math
import statistics
import subprocess
import sys
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
F32_FLOPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores (data sheet)
BF16_FLOPS_PER_S = 989e12  # H100 SXM bf16 dense tensor cores (data sheet)
ROOT = Path(__file__).resolve().parent


def log(msg):
    print(msg, flush=True)


def release():
    """Free what a finished trainer left on the card. A trainer that has
    trained sits in a reference cycle (its loss closure holds it), which
    `del` leaves to Python's cyclic collector: collect it, then empty the
    allocator's cache, so a later phase's memory figures are its own."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def profiled_device_us(fn, iters):
    """Device microseconds of the CUDA kernels that torch.profiler traces
    over `iters` calls of `fn`; 0.0 when the trace holds no device event.

    A trace often loses a record (CUPTI drops them; most traces of phase 6
    hold 9 of 10 or 19 of 20 launches of a kernel), and a sum over what
    was kept would read low by as much. So each kernel is timed by its
    mean over the launches the trace kept, times its launches a call (its
    count over `iters`, rounded); events that come once a trace (the
    profiler's own) round to none."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = 0.0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.count:
            us = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)
            total_us += us / e.count * round(e.count / iters) * iters
    return total_us


def event_time_ms(fn, iters):
    """(ms per call, gapless) between two CUDA events around `iters`
    calls. A spin kernel (`torch.cuda._sleep`) holds the stream while the
    host queues the calls, so they run back to back, with no host gap
    between launches, when the host is done before the spin is
    (`gapless`); the spin is made 10x longer up to three times until it
    is."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for cycles in (10**7, 10**8, 10**9):
        torch.cuda.synchronize()
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        gapless = not start.query()
        end.synchronize()
        if gapless:
            break
    return start.elapsed_time(end) / iters, gapless


def device_time_ms(fn, iters, warmup=3, label=""):
    """Device time per call: the CUDA kernels that torch.profiler traces
    over `iters` calls, summed and divided by `iters`. Host time between
    launches (the wrappers' Python) is excluded, so a kernel shorter than
    its launch overhead is still timed as a kernel.

    Now and then a trace comes back without a single device event (the
    CUPTI records are lost, not the kernels). The call is then traced once
    more, and if that trace is empty too, timed by `event_time_ms`; the
    log line says so."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for attempt in range(2):
        total_us = profiled_device_us(fn, iters)
        if total_us > 0:
            return total_us / 1e3 / iters
        log(f"[timing] torch.profiler traced no device time for {label or 'a timed call'} (trace {attempt + 1} of 2)")
    ms, gapless = event_time_ms(fn, iters)
    log(f"[timing] {label or 'a timed call'}: {ms:.5f} ms per call by CUDA events"
        + ("" if gapless else ", host gaps included: the longest spin ended before every call was queued"))
    return ms


# ---------------------------------------------------------------------------
# Phase 3: kernel vs plain version
# ---------------------------------------------------------------------------

SLOTS, BLK, N_TBL, LAYERS = 8, 32, 10, 12
# row lengths at block boundaries, a full table, and one inactive row
LENS = [1, 31, 32, 33, 64, 200, N_TBL * BLK, 0]
# long rows across the split edges (8 pages a split at this shape), one inactive
LENS_4K = [4096, 4095, 4064, 3000, 2048, 1025, 33, 0]
SHAPES = {  # name: (nh, nkv, hd, row lengths, table entries, arena pairs rotated)
    "gpt2-small": (12, 12, 64, LENS, N_TBL, LAYERS),
    "llama-7b": (32, 32, 128, LENS, N_TBL, LAYERS),
    "gqa": (32, 8, 128, LENS, N_TBL, LAYERS),
    "mqa": (16, 1, 64, LENS, N_TBL, LAYERS),
    # Llama-3-8B's attention at 4096 tokens: an arena pair is 134 MB in bf16,
    # so 3 pairs (more than the 50 MB L2) stand in for the layers
    "gqa-4k": (32, 8, 128, LENS_4K, 128, 3),
}


def paged_case(nh, nkv, hd, kv, gen, device, lens=LENS, n_tbl=N_TBL, n_layers=LAYERS):
    """Random inputs shaped like the engine's: `n_layers` arena pairs (the
    timing walks them like a decode step walks its layers, so KV comes
    from device memory, not L2), each slot owning distinct blocks, table
    slack on the zero block."""
    import torch

    from trlx_tpu_torch.ops import quant

    n_blocks = SLOTS * n_tbl + 1
    q = torch.randn(SLOTS, nh, hd, generator=gen, device=device).to(torch.bfloat16)
    perm = torch.randperm(n_blocks - 1, generator=gen, device=device) + 1
    table = perm[: SLOTS * n_tbl].reshape(SLOTS, n_tbl).to(torch.int32)
    lens = torch.tensor(lens, device=device)
    mask = (torch.arange(n_tbl * BLK, device=device)[None, :] < lens[:, None]).to(torch.int32)
    used = (torch.arange(n_tbl, device=device)[None, :] * BLK) < lens[:, None]
    table = torch.where(used, table, torch.zeros_like(table))
    layers = []
    for _ in range(n_layers):
        k = torch.randn(n_blocks, BLK, nkv, hd, generator=gen, device=device)
        v = torch.randn(n_blocks, BLK, nkv, hd, generator=gen, device=device)
        if kv == "int8":
            kq, ks = quant.quantize_kv(k)
            vq, vs = quant.quantize_kv(v)
            layers.append((kq, vq, dict(k_scale=ks, v_scale=vs)))
        else:
            dt = torch.bfloat16 if kv == "bf16" else torch.float32
            layers.append((k.to(dt), v.to(dt), {}))
    return q, table, mask, layers


def bound_bytes(nh, nkv, hd, kv, q_bytes, lens=LENS, n_tbl=N_TBL):
    """Bytes the function must move for this run's data: q in and out
    once, the table and mask, and K and V (plus int8 scales) for every
    valid column once per kv head."""
    cols = sum(lens)
    kv_bytes = {"f32": 4, "bf16": 2, "int8": 1}[kv]
    n = 2 * SLOTS * nh * hd * q_bytes + SLOTS * n_tbl * 4 + SLOTS * n_tbl * BLK * 4
    n += 2 * cols * nkv * hd * kv_bytes
    if kv == "int8":
        n += 2 * cols * nkv * 4
    return n


def bound(nh, nkv, hd, kv, q_bytes, lens=LENS, n_tbl=N_TBL):
    """(ms, "bytes" | "operations"): the least time the card could take,
    the larger of the bytes over the memory rate and the f32 operations
    (q.k and p.v, 2 flops each per valid column, q head and dim) over the
    f32 rate."""
    bytes_ms = bound_bytes(nh, nkv, hd, kv, q_bytes, lens, n_tbl) / HBM_BYTES_PER_S * 1e3
    ops_ms = 4 * sum(lens) * nh * hd / F32_FLOPS_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def library_call(q, k, v, table, mask, extra, nh, nkv):
    """scaled_dot_product_attention over the gathered, dequantized,
    head-repeated dense KV (built outside the timed call)."""
    import torch
    import torch.nn.functional as F

    from trlx_tpu_torch.ops import quant

    b, n_tbl = table.shape
    idx = table.long()
    kd, vd = k[idx].reshape(b, n_tbl * BLK, nkv, -1), v[idx].reshape(b, n_tbl * BLK, nkv, -1)
    if extra:
        kd = quant.dequantize_kv(kd, extra["k_scale"][idx].reshape(b, -1, nkv), q.dtype)
        vd = quant.dequantize_kv(vd, extra["v_scale"][idx].reshape(b, -1, nkv), q.dtype)
    kd = kd.to(q.dtype).repeat_interleave(nh // nkv, dim=2).transpose(1, 2).contiguous()
    vd = vd.to(q.dtype).repeat_interleave(nh // nkv, dim=2).transpose(1, 2).contiguous()
    qd = q[:, :, None, :]
    am = mask.bool()[:, None, None, :]
    return lambda: F.scaled_dot_product_attention(qd, kd, vd, attn_mask=am)


def phase_kernels(device):
    import torch

    from trlx_tpu_torch import kernels
    from trlx_tpu_torch.ops.paged_attention import paged_attention_decode, paged_attention_plain, split_plan

    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    # tolerances: f32 q/out 1e-5 (only the summation order differs). bf16
    # q/out: both sides compute in f32 and round once to bf16, so they may
    # differ by one bf16 ulp, at most 2^-7 of the value: rtol 8e-3, plus
    # atol 1e-3 near zero
    f32_tol, bf16_tol = dict(rtol=1e-5, atol=1e-5), dict(rtol=8e-3, atol=1e-3)
    checks = [("f32", torch.float32, f32_tol), ("bf16", torch.bfloat16, bf16_tol),
              ("int8", torch.bfloat16, bf16_tol)]
    results = {}
    err = {"paged_decode": 0.0, "paged_decode_int8": 0.0}
    for name, (nh, nkv, hd, lens, n_tbl, n_layers) in SHAPES.items():
        pps, n_splits = split_plan(SLOTS, nkv, n_tbl)
        for kv, qt, tol in checks:
            q, table, mask, layers = paged_case(nh, nkv, hd, kv, gen, device, lens, n_tbl, n_layers)
            q = q.to(qt)
            k, v, extra = layers[0]
            out = paged_attention_decode(q, k, v, table, mask, **extra)
            again = paged_attention_decode(q, k, v, table, mask, **extra)
            torch.cuda.synchronize()
            if not torch.equal(out, again):
                raise AssertionError(f"{name}/{kv}: two calls on the same inputs differ")
            ref = paged_attention_plain(q, k, v, table, mask, **extra)
            torch.testing.assert_close(out.float(), ref.float(), **tol)
            if not bool((out[-1] == 0).all()):
                raise AssertionError(f"{name}/{kv}: inactive row is not exactly 0")
            key = "paged_decode_int8" if kv == "int8" else "paged_decode"
            e = float((out.float() - ref.float()).abs().max())
            err[key] = max(err[key], e)
            shape = f"{name} nh={nh} nkv={nkv} hd={hd} n_tbl={n_tbl} splits={n_splits}x{pps} kv={kv}"
            if kv == "f32":
                log(f"[kernels] {shape}: max_abs_err={e:.3g} (tol {tol}), repeat bitwise equal")
                del q, table, mask, layers, k, v, extra, out, again, ref
                torch.cuda.empty_cache()
                continue
            it = iter(range(10**9))

            def kernel_fn():
                kk, vv, ex = layers[next(it) % n_layers]
                paged_attention_decode(q, kk, vv, table, mask, **ex)

            def plain_fn():
                kk, vv, ex = layers[next(it) % n_layers]
                paged_attention_plain(q, kk, vv, table, mask, **ex)

            kernel_ms = device_time_ms(kernel_fn, 240, label=f"{name} {kv} kernel")
            plain_ms = device_time_ms(plain_fn, 24, label=f"{name} {kv} plain")
            library_ms = device_time_ms(library_call(q, k, v, table, mask, extra, nh, nkv), 240,
                                        label=f"{name} {kv} library")
            least_ms, bound_by = bound(nh, nkv, hd, kv, 2, lens, n_tbl)
            results[(name, kv)] = dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                                       bound_ms=least_ms, bound_by=bound_by)
            log(
                f"[kernels] {shape}: max_abs_err={e:.3g} (tol {tol}), repeat bitwise equal; "
                f"kernel_ms={kernel_ms:.5f} plain_ms={plain_ms:.5f} library_ms={library_ms:.5f} "
                f"bound_ms={least_ms:.5f} ({bound_by})"
            )
            del q, table, mask, layers, k, v, extra, out, again, ref
            torch.cuda.empty_cache()
    kernels.reset_launches()  # the comparison launches above do not count
    return results, err


# ---------------------------------------------------------------------------
# Phase 4: serving (the main path)
# ---------------------------------------------------------------------------

def serving_config(**inference):
    from trlx_tpu_torch.data.default_configs import default_sft_config

    return default_sft_config().evolve(
        model=dict(model_path="random:gpt2-small", model_extra_configs={"vocab_size": 50257}),
        tokenizer=dict(tokenizer_path="byte"),
        inference=dict(dict(
            kv_paging=True, kv_block_size=32, num_slots=8, max_new_tokens=64,
            decode_kernel="auto", gen_kwargs=dict(max_new_tokens=64)), **inference,
        ),
    )


def http(url, path, payload=None, timeout=300):
    """(status, JSON body) of a GET (no payload) or a POST; an HTTP error
    status is returned, not raised."""
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url + path, data=data, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


PAGED_KERNELS = ("paged_decode", "paged_decode_int8")


def serve_and_check(config, n_requests, counter, card):
    """Phase 4's burst of `n_requests` concurrent /generate requests
    against `SFTTrainer(config).serve()`; `counter` names the paged kernel
    the decode must launch once a layer a dispatch, or None for the
    fixed-slot pool, which launches none. Returns (its launches, the
    burst's numbers)."""
    import numpy as np
    import torch

    from trlx_tpu_torch import kernels
    from trlx_tpu_torch.trainer.sft_trainer import SFTTrainer

    trainer = SFTTrainer(config)  # device defaults to cuda
    n_layers = trainer.model_cfg.n_layers
    server = trainer.serve(port=0, background=True)
    try:
        rng = np.random.RandomState(1)
        plens = [31, 32, 33, 5, 64, 100, 200, 256, 17, 48, 96, 1, 128, 250, 63, 65]
        jobs = []
        for i in range(n_requests):
            plen = plens[i % len(plens)]
            max_new = int(16 + (i * 7) % 49)  # 16..64
            jobs.append({"prompt_ids": rng.randint(0, 256, plen).tolist(), "max_new_tokens": max_new})
        kernels.reset_launches()
        t0 = time.perf_counter()
        with ThreadPoolExecutor(n_requests) as pool:
            replies = list(pool.map(lambda j: http(server.url, "/generate", j), jobs))
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        stats = server.engine.kv_stats()
        # wall time of the scheduler's decode steps (this server's only ones)
        decode_s = server.metrics.histograms_snapshot()["decode_step_latency_seconds"][2]
    finally:
        server.shutdown()
    for job, (code, out) in zip(jobs, replies):
        if code != 200:
            raise AssertionError(f"/generate answered {code}: {out}")
        n = len(out["token_ids"])
        if out["finish_reason"] != "eos" and n != job["max_new_tokens"]:
            raise AssertionError(f"got {n} tokens for max_new_tokens={job['max_new_tokens']}: {out['finish_reason']}")
        if not all(math.isfinite(x) for x in out["token_logprobs"]):
            raise AssertionError("non-finite token logprob")
    dispatches = stats["kv_kernel_dispatches"]
    if counter is None:
        # the fixed-slot pool has no kernel, as in JAX: every decode
        # dispatch is a counted kv_paging_off fallback, no paged launch
        dispatches = stats["kv_kernel_fallbacks"].get("kv_paging_off", 0)
        want = {"kv_kernel_dispatches": 0, "kv_kernel_fallbacks": {"kv_paging_off": dispatches}}
        if dispatches <= 0 or stats != want or any(launches.get(k, 0) for k in PAGED_KERNELS):
            raise AssertionError(f"fixed-slot pool: {stats}, launches {launches}")
    else:
        if dispatches <= 0 or stats["kv_kernel_fallbacks"] != {}:
            raise AssertionError(f"kernel not on the decode path: {stats}")
        if launches.get(counter, 0) != dispatches * n_layers:
            raise AssertionError(f"{counter} launches {launches} != {dispatches} dispatches x {n_layers} layers")
    # every token is emitted by a decode step (the first one was sampled at
    # prefill): tokens_per_s is end to end over the burst's wall time,
    # decode_tok_per_s over the decode steps' time alone
    tokens = sum(len(o["token_ids"]) for _, o in replies)
    ttft = statistics.median(o["ttft_s"] for _, o in replies)
    pool = "paged" if config.inference.kv_paging else "fixed-slot"
    log(
        f"[serve] {pool} kv={config.inference.kv_cache_dtype} requests={n_requests} tokens={tokens} "
        f"wall_s={wall:.3f} tokens_per_s={tokens / wall:.1f} decode_s={decode_s:.3f} "
        f"decode_tok_per_s={tokens / decode_s:.1f} median_ttft_s={ttft:.4f} "
        f"dispatches={dispatches} launches={launches} ({card})"
    )
    del trainer, server
    release()
    numbers = dict(tokens=tokens, wall_s=wall, tokens_per_s=tokens / wall, decode_tok_per_s=tokens / decode_s,
                   median_ttft_s=ttft, dispatches=dispatches, launches=launches)
    return (launches.get(counter, 0) if counter else 0), numbers


# ---------------------------------------------------------------------------
# Phase 5: greedy equality kernel vs gather path
# ---------------------------------------------------------------------------

def run_serial(engine, prompts, max_new, slot=0):
    """Each prompt to its end in the same slot (slot reuse with block
    reclaim between requests). A speculative engine emits up to spec_k + 1
    tokens a step."""
    import numpy as np

    outs = []
    for p in prompts:
        engine.insert_requests([(np.asarray(p, np.int32), max_new)], [slot])
        toks = []
        for _ in range(max_new):
            t, _, v, f = engine.step()
            t, v = t.reshape(len(t), -1), v.reshape(len(t), -1)
            toks += [int(x) for x in t[slot][v[slot]]]
            if f[slot]:
                break
        engine.reclaim_slots([slot])
        outs.append(toks)
    return outs


def greedy_prompts():
    """Phase 5's prompts: lengths around the 32-token block edges."""
    import numpy as np

    rng = np.random.RandomState(2)
    return [rng.randint(0, 256, n).tolist() for n in (7, 31, 32, 33, 64, 100)]


def phase_greedy():
    import numpy as np
    import torch

    from trlx_tpu_torch.inference import InferenceEngine
    from trlx_tpu_torch.ops.sampling import GenerationConfig
    from trlx_tpu_torch.trainer.sft_trainer import SFTTrainer

    config = serving_config().evolve(
        model=dict(model_extra_configs={"vocab_size": 50257, "dtype": "float32"})
    )
    trainer = SFTTrainer(config)
    gen = GenerationConfig(max_new_tokens=16, do_sample=False, eos_token_id=10**6,
                           pad_token_id=trainer.tokenizer.pad_token_id)
    prompts = greedy_prompts()

    def engine(kernel, kv):
        return InferenceEngine(trainer.model, trainer.model_cfg, None, gen, num_slots=8,
                               max_prompt_len=256, kv_paging=True, kv_block_size=32,
                               kv_cache_dtype=kv, decode_kernel=kernel)

    for kv in ("auto", "int8"):
        kern = run_serial(engine("auto", kv), prompts, 16)
        gather = run_serial(engine("xla", kv), prompts, 16)
        same = sum(a == b for a, b in zip(kern, gather))
        log(f"[greedy] f32 model kv={kv}: {same}/{len(prompts)} streams equal kernel vs gather")
        need = len(prompts) if kv == "auto" else len(prompts) - 1
        if same < need:
            raise AssertionError(f"kv={kv}: kernel {kern} vs gather {gather}")
    del trainer
    release()


# ---------------------------------------------------------------------------
# Phase 6: the training kernels (K3-K7) vs their plain versions
# ---------------------------------------------------------------------------

# PPO rows (phase 9's shapes): a 64-token query bucket, left padded, and a
# 40-token response, right padded; row 1 holds a hole, row 2 no valid key
PPO_T, PPO_QUERY = 104, 64


def ppo_mask_rows(b):
    """[b, PPO_T] 0/1 rows padded at both ends, one with a hole, one dead."""
    import numpy as np

    mask = np.ones((b, PPO_T), np.int32)
    for r in range(b):
        left, right = (r * 7) % 48, (r * 11) % 40
        mask[r, :left] = 0
        mask[r, PPO_T - right:] = 0
    mask[1, 70:76] = 0
    mask[2] = 0
    return mask


def left_pad_rows(t, pads):
    import numpy as np

    return (np.arange(t)[None, :] >= np.asarray(pads)[:, None]).astype(np.int32)


# name: (b, t, nh, nkv, hd, key-validity rows [b, t] (a row of zeros has no
# valid key), the kernels timed there). The PPO shapes time the kernels
# phase 9 runs at them: K3 when scoring 128 rows, K4-K6 in a 32-row step;
# the ILQL shape those of phase 14's step: K4-K6 over 128 full rows of 64
# tokens (a 32-byte prompt and a 32-byte output).
ALL_FLASH = ("flash_fwd", "flash_fwd_lse", "flash_bwd_dq", "flash_bwd_dkv")
FLASH_SHAPES = {
    "gpt2-small": (8, 1024, 12, 12, 64, left_pad_rows(1024, [0, 0, 17, 100, 256, 511, 700, 1024]), ALL_FLASH),
    "llama-7b": (1, 2048, 32, 32, 128, left_pad_rows(2048, [0]), ALL_FLASH),
    "gqa": (1, 2048, 32, 8, 128, left_pad_rows(2048, [0]), ALL_FLASH),
    "ppo-score": (128, PPO_T, 12, 12, 64, ppo_mask_rows(128), ("flash_fwd",)),
    "ppo-train": (32, PPO_T, 12, 12, 64, ppo_mask_rows(32), ALL_FLASH[1:]),
    "ilql-train": (128, 64, 12, 12, 64, left_pad_rows(64, [0] * 128), ALL_FLASH[1:]),
}
CE_ROWS, CE_VOCAB = 8 * 1023, 50257
# K7 at phase 9's shapes: scoring reads the full [128, 104, V] logits with
# the labels shifted one column; a step reads the [32, 40, V] window
# the fast scorer (phase 12) reads the reference's [128, 40, V] window;
# a step under the value branch (phase 13) reads the full [32, 104, V]
# logits with shifted labels, its backward nonzero on the window's rows
CE_PPO = {"ppo-score": (128, PPO_T), "ppo-train": (32, 40), "ppo-fast-score": (128, 40),
          "ppo-branch-train": (32, PPO_T)}
CE_BWD_PPO = ("ppo-train", "ppo-branch-train")  # the shapes a step's backward runs at
# tolerances: bf16 outputs (out, dq): both sides round once to bf16 from
# f32 values that differ only in summation order, so one bf16 ulp apart at
# most: rtol 8e-3, atol 1e-3. That holds for the bf16 kernels on the
# tensor cores too: a product of two bf16 values is exact in f32, so their
# q.k^T and dO.v^T products equal the plain version's, and the products
# with an f32 operand (p.V in the forward; p^T.dO, ds.k and ds^T.q in the
# backward) split p and ds into bf16 hi and lo parts, which carry them to
# about 2^-17 relative error against V, dO, k and q exact in bf16: far
# below the 2^-8 of one output ulp, and below DKV_TOL's 1e-4 for the f32
# per-head dk/dv, whose sums over up to 2048 queries are the same f32
# arithmetic in another order (as lse over the keys, and the logprobs over
# 50257 vocabulary entries).
BF16_TOL = dict(rtol=8e-3, atol=1e-3)
LSE_TOL = dict(rtol=2e-5, atol=2e-5)
DKV_TOL = dict(rtol=1e-4, atol=1e-3)
CE_TOL = dict(rtol=1e-5, atol=1e-4)
# K7's backward at bf16: kernel and plain version round the same f32
# formula once (the kernel's exp2 is ex2.approx, about 2 f32 ulp), so one
# bf16 ulp apart at most: 2^-7 relative bounds an ulp (atol for denormals
# the kernel's exponential flushes to 0)
CE_BWD_TOL = dict(rtol=2**-7, atol=1e-20)
# at f32 both sides compute exp(x - lse) in f32 (ex2.approx on the card,
# about 2 ulp): 1e-5 relative, 1e-6 absolute where (1 - p) at the label
# cancels (tests/test_torch_kernels_cuda.py's bound)
CE_BWD_F32_TOL = dict(rtol=1e-5, atol=1e-6)
# K7 at the randomwalks curves' shapes (scripts/parity_randomwalks_torch.py):
# a 24-token vocabulary, rows of 48 bytes at bf16 and 96 at f32 (shorter
# than one tile, near the 16-byte peel), batch 100 of 10 positions read
# with the labels shifted one column; row 3 is all padding and the rows
# from 50 on are padded after 4 tokens (g = 0 there in the backward)
CE_WALK = (100, 10, 24)


def flash_case(b, t, nh, nkv, hd, rows, gen, device):
    import torch

    from trlx_tpu_torch.ops import attention

    bf = torch.bfloat16
    q = torch.randn(b, t, nh, hd, generator=gen, device=device).to(bf)
    k = torch.randn(b, t, nkv, hd, generator=gen, device=device).to(bf)
    v = torch.randn(b, t, nkv, hd, generator=gen, device=device).to(bf)
    g = torch.randn(b, t, nh, hd, generator=gen, device=device).to(bf)
    mask = torch.from_numpy(rows).to(device)
    out, lse = attention.flash_fwd_plain(q, k, v, mask, True)
    delta = (g.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    return q, k, v, mask, g, lse, delta


def allowed_pairs(rows):
    """(query, key) pairs the causal mask allows on this run's rows [b, t]:
    query i sees the valid keys at or before it (with p left pads only, a
    row's query i >= p sees i - p + 1 keys)."""
    return int(rows.cumsum(axis=1).sum())


def skipped_tiles(rows, tile=64):
    """(skipped, total) causal 64 x 64 (q, key) tiles of this run's rows
    that the bf16 kernels skip as padding: a tile on or below the diagonal
    whose 64 keys are all padding. The forward and dq (K3-K5) skip it in
    their loop over key tiles; dk/dv (K6) skips the key tile's whole loop
    over q tiles, which are the same tiles."""
    b, t = rows.shape
    n = (t + tile - 1) // tile
    total = b * n * (n + 1) // 2
    skipped = 0
    for row in rows:
        for kt in range(n):
            if not row[kt * tile:(kt + 1) * tile].any():
                skipped += n - kt  # q tiles kt..n-1 reach key tile kt
    return skipped, total


def flash_bound(b, t, nh, nkv, hd, rows, kind):
    """(ms, "bytes" | "operations"): causal products over the bf16
    tensor-core peak vs each operand read or written once over the memory
    rate. kind: fwd, fwd_lse, dq, dkv."""
    pairs = allowed_pairs(rows)
    products = {"fwd": 2, "fwd_lse": 2, "dq": 3, "dkv": 4}[kind]  # t x t x hd matmuls per head
    ops = 2 * products * nh * hd * pairs
    q_bytes, kv_bytes, rows = b * t * nh * hd * 2, b * t * nkv * hd * 2, b * nh * t * 4
    moved = q_bytes + 2 * kv_bytes + b * t * 4  # q, k, v, mask
    moved += {"fwd": q_bytes, "fwd_lse": q_bytes + rows,
              "dq": 2 * q_bytes + 2 * rows,  # dout, dq; lse, delta
              "dkv": q_bytes + 2 * rows + 2 * b * t * nh * hd * 4}[kind]  # dout; lse, delta; dk, dv f32
    ops_ms, bytes_ms = ops / BF16_FLOPS_PER_S * 1e3, moved / HBM_BYTES_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def sdpa_calls(q, k, v, g, nh, nkv):
    """scaled_dot_product_attention(is_causal=True) forward, and its
    backward (dq, dk, dv together) on a saved graph: the yardstick the
    port never calls. Layouts are prepared outside the timed calls."""
    import torch
    import torch.nn.functional as F

    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    gt = g.transpose(1, 2).contiguous()
    gqa = dict(enable_gqa=True) if nkv != nh else {}
    fwd = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, **gqa)
    qg, kg, vg = (x.detach().requires_grad_(True) for x in (qt, kt, vt))
    out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True, **gqa)
    bwd = lambda: torch.autograd.grad(out, (qg, kg, vg), gt, retain_graph=True)
    return fwd, bwd


def ce_times(logits, labels):
    """Kernel, plain-version, library (logsumexp plus gather) and bound
    times of K7 on [N, V] logits and in-range labels [N]."""
    import torch

    from trlx_tpu_torch.ops.fused_ce import label_logprobs, label_logprobs_plain

    rows, vocab = logits.shape
    lib = lambda: torch.gather(logits.float(), 1, labels.long()[:, None])[:, 0] - torch.logsumexp(logits.float(), -1)
    moved = rows * vocab * logits.element_size() + rows * 4 * 3  # logits, labels, logprobs and lse
    bytes_ms, ops_ms = moved / HBM_BYTES_PER_S * 1e3, 4 * rows * vocab / F32_FLOPS_PER_S * 1e3
    least_ms, bound_by = (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")
    r = dict(ms=device_time_ms(lambda: label_logprobs(logits, labels), 20, label=f"label_logprobs {rows} kernel"),
             plain_ms=device_time_ms(lambda: label_logprobs_plain(logits, labels), 5, label=f"label_logprobs {rows} plain"),
             library_ms=device_time_ms(lib, 5, label=f"label_logprobs {rows} library"),
             bound_ms=least_ms, bound_by=bound_by)
    log(f"[train-kernels] label_logprobs [{rows}, {vocab}]: kernel_ms={r['ms']:.5f} plain_ms={r['plain_ms']:.5f} "
        f"library_ms={r['library_ms']:.5f} bound_ms={least_ms:.5f} ({bound_by})")
    return r


def ce_bwd_times(logits, labels, lse, g):
    """Kernel, plain-version (the torch passes the port's backward ran
    before the kernel: the "before" figure), library (the backward alone of
    -cross_entropy(x, labels) with the same g, through autograd on a saved
    graph) and bound times of K7's backward. The bound reads only the rows
    whose g is not 0 (the kernel writes zeros for the others unread)."""
    import torch
    import torch.nn.functional as F

    from trlx_tpu_torch.ops.fused_ce import label_logprobs_bwd, label_logprobs_bwd_plain

    rows, vocab = logits.shape
    x = logits.detach().requires_grad_(True)
    ce = -F.cross_entropy(x, labels.long(), reduction="none")
    lib = lambda: torch.autograd.grad(ce, x, g, retain_graph=True)
    read_rows = int((g != 0).sum())
    moved = (rows + read_rows) * vocab * logits.element_size() + rows * 4 * 3  # dlogits; logits; labels, lse, g
    bytes_ms, ops_ms = moved / HBM_BYTES_PER_S * 1e3, 5 * read_rows * vocab / F32_FLOPS_PER_S * 1e3
    least_ms, bound_by = (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")
    r = dict(ms=device_time_ms(lambda: label_logprobs_bwd(logits, labels, lse, g), 10,
                               label=f"label_logprobs_bwd {rows} kernel"),
             plain_ms=device_time_ms(lambda: label_logprobs_bwd_plain(logits, labels, lse, g), 3,
                                     label=f"label_logprobs_bwd {rows} plain"),
             library_ms=device_time_ms(lib, 3, label=f"label_logprobs_bwd {rows} library"),
             bound_ms=least_ms, bound_by=bound_by)
    log(f"[train-kernels] label_logprobs_bwd [{rows}, {vocab}] ({rows - read_rows} rows with g = 0): "
        f"kernel_ms={r['ms']:.5f} plain_ms (the torch passes before the kernel)={r['plain_ms']:.5f} "
        f"library_ms={r['library_ms']:.5f} bound_ms={least_ms:.5f} ({bound_by})")
    del ce, x
    return r


def check_ce_bwd(note, logits, labels, g, shape, tol=CE_BWD_TOL):
    """K7's backward against its plain version on the kernel's own lse;
    returns (max abs err, lse)."""
    import torch

    from trlx_tpu_torch.ops.fused_ce import label_logprobs, label_logprobs_bwd, label_logprobs_bwd_plain

    _, lse = label_logprobs(logits, labels)
    got = label_logprobs_bwd(logits, labels, lse, g)
    torch.cuda.synchronize()
    if not bool((got[g == 0] == 0).all()):
        raise AssertionError(f"label_logprobs_bwd {shape}: a row with g = 0 is not all zeros")
    e = note("label_logprobs_bwd", got, label_logprobs_bwd_plain(logits, labels, lse, g), tol)
    log(f"[train-kernels] label_logprobs_bwd {shape} {list(logits.shape)} {str(logits.dtype)[6:]}: "
        f"max_abs_err dlogits = {e:.3g}")
    return lse


def phase_train_kernels(device):
    import torch

    from trlx_tpu_torch import kernels
    from trlx_tpu_torch.ops import attention as A
    from trlx_tpu_torch.ops.fused_ce import fused_logprobs_of_labels, label_logprobs, label_logprobs_plain

    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    err = {n: 0.0 for n in ("flash_fwd", "flash_fwd_lse", "flash_bwd_dq", "flash_bwd_dkv", "label_logprobs",
                            "label_logprobs_bwd")}
    results = {}

    def note(name, got, want, tol):
        torch.testing.assert_close(got.float(), want.float(), **tol)
        e = float((got.float() - want.float()).abs().max())
        err[name] = max(err[name], e)
        return e

    for shape, (b, t, nh, nkv, hd, rows, kinds) in FLASH_SHAPES.items():
        q, k, v, mask, g, lse_p, delta = flash_case(b, t, nh, nkv, hd, rows, gen, device)
        out3 = A.flash_fwd(q, k, v, mask, True)
        out4, lse = A.flash_fwd(q, k, v, mask, True, with_lse=True)
        dq = A.flash_bwd_dq(q, k, v, mask, g, lse_p, delta, True)
        dk, dv = A.flash_bwd_dkv(q, k, v, mask, g, lse_p, delta, True)
        torch.cuda.synchronize()
        out_p, _ = A.flash_fwd_plain(q, k, v, mask, True)
        dq_p = A.flash_bwd_dq_plain(q, k, v, mask, g, lse_p, delta, True)
        dk_p, dv_p = A.flash_bwd_dkv_plain(q, k, v, mask, g, lse_p, delta, True)
        errs = [note("flash_fwd", out3, out_p, BF16_TOL), note("flash_fwd_lse", out4, out_p, BF16_TOL),
                note("flash_fwd_lse", lse, lse_p, LSE_TOL), note("flash_bwd_dq", dq, dq_p, BF16_TOL),
                note("flash_bwd_dkv", dk, dk_p, DKV_TOL), note("flash_bwd_dkv", dv, dv_p, DKV_TOL)]
        dead = mask.sum(-1) == 0
        if bool(dead.any()) and not (bool((out3[dead] == 0).all()) and bool((lse[dead] == A.DEAD_LSE).all())):
            raise AssertionError(f"{shape}: a row with no valid key is not exactly 0 / DEAD_LSE")
        sdpa_fwd, sdpa_bwd = sdpa_calls(q, k, v, g, nh, nkv)
        lib_fwd = device_time_ms(sdpa_fwd, 20, label=f"{shape} SDPA forward")
        lib_bwd = device_time_ms(sdpa_bwd, 10, label=f"{shape} SDPA backward")
        timed = {
            "flash_fwd": (lambda: A.flash_fwd(q, k, v, mask, True),
                          lambda: A.flash_fwd_plain(q, k, v, mask, True), lib_fwd, "fwd"),
            "flash_fwd_lse": (lambda: A.flash_fwd(q, k, v, mask, True, with_lse=True),
                              lambda: A.flash_fwd_plain(q, k, v, mask, True), lib_fwd, "fwd_lse"),
            "flash_bwd_dq": (lambda: A.flash_bwd_dq(q, k, v, mask, g, lse_p, delta, True),
                             lambda: A.flash_bwd_dq_plain(q, k, v, mask, g, lse_p, delta, True), lib_bwd, "dq"),
            "flash_bwd_dkv": (lambda: A.flash_bwd_dkv(q, k, v, mask, g, lse_p, delta, True),
                              lambda: A.flash_bwd_dkv_plain(q, k, v, mask, g, lse_p, delta, True), lib_bwd, "dkv"),
        }
        for name, (kern, plain, lib, kind) in timed.items():
            if name not in kinds:
                continue
            least_ms, bound_by = flash_bound(b, t, nh, nkv, hd, rows, kind)
            results[(name, shape)] = dict(ms=device_time_ms(kern, 10, label=f"{name} {shape} kernel"),
                                          plain_ms=device_time_ms(plain, 3, label=f"{name} {shape} plain"),
                                          library_ms=lib, bound_ms=least_ms, bound_by=bound_by)
            r = results[(name, shape)]
            log(f"[train-kernels] {name} {shape} b={b} t={t} nh={nh} nkv={nkv} hd={hd}: "
                f"kernel_ms={r['ms']:.5f} plain_ms={r['plain_ms']:.5f} library_ms={lib:.5f} "
                f"bound_ms={least_ms:.5f} ({bound_by})")
        skipped, total = skipped_tiles(rows)
        log(f"[train-kernels] {shape}: max_abs_err out/out_lse/lse/dq/dk/dv = "
            + " ".join(f"{e:.3g}" for e in errs)
            + f"; causal tiles skipped as padding by the bf16 forward and backward (K3-K6): "
            f"{skipped}/{total} ({skipped / total:.3f})")
        del q, k, v, mask, g, lse_p, delta, out3, out4, lse, dq, dk, dv, out_p, dq_p, dk_p, dv_p
        torch.cuda.empty_cache()

    # K7: the CE loss's shape, through the entry point that clamps labels
    logits = torch.randn(CE_ROWS, CE_VOCAB, generator=gen, device=device).mul_(3).to(torch.bfloat16)
    labels = torch.randint(0, CE_VOCAB, (CE_ROWS,), generator=gen, device=device)
    labels[::97] = -100
    labels[1::89] = CE_VOCAB + 5
    with torch.no_grad():
        out = fused_logprobs_of_labels(logits, labels)
    clamped = labels.clamp(0, CE_VOCAB - 1).to(torch.int32)
    ref_out, ref_lse = label_logprobs_plain(logits, clamped)
    got_out, got_lse = label_logprobs(logits, clamped)
    torch.cuda.synchronize()
    errs = [note("label_logprobs", out, ref_out, CE_TOL), note("label_logprobs", got_lse, ref_lse, CE_TOL)]
    log(f"[train-kernels] label_logprobs [{CE_ROWS}, {CE_VOCAB}] bf16: max_abs_err logprob/lse = "
        + " ".join(f"{e:.3g}" for e in errs))
    results[("label_logprobs", "gpt2-small")] = ce_times(logits, clamped)
    # its backward, with g = 0 on the rows whose label the loss masks
    g = torch.randn(CE_ROWS, generator=gen, device=device)
    g[::97] = 0.0
    lse = check_ce_bwd(note, logits, clamped, g, "gpt2-small")
    results[("label_logprobs_bwd", "gpt2-small")] = ce_bwd_times(logits, clamped, lse, g)
    del logits, labels, clamped, g, lse, out, ref_out, ref_lse, got_out, got_lse
    torch.cuda.empty_cache()
    # K7 at the PPO shapes: scoring passes the full contiguous logits with
    # the labels shifted one column (`shifted_logprobs`)
    from trlx_tpu_torch.trainer.ppo_trainer import shifted_logprobs

    for shape, (b, t) in CE_PPO.items():
        n = b * t
        logits = torch.randn(b, t, CE_VOCAB, generator=gen, device=device).mul_(3).to(torch.bfloat16)
        tokens = torch.randint(0, CE_VOCAB, (b, t), generator=gen, device=device)
        if t == PPO_T:  # the full logits, labels shifted one column
            with torch.no_grad():
                got = shifted_logprobs(logits, tokens)
            want = label_logprobs_plain(logits[:, :-1].reshape(-1, CE_VOCAB), tokens[:, 1:].reshape(-1))[0]
            e = note("label_logprobs", got.reshape(-1), want, CE_TOL)
        else:
            got, _ = label_logprobs(logits.view(n, CE_VOCAB), tokens.view(n).to(torch.int32))
            e = note("label_logprobs", got, label_logprobs_plain(logits.view(n, CE_VOCAB), tokens.view(n))[0], CE_TOL)
        torch.cuda.synchronize()
        log(f"[train-kernels] label_logprobs {shape} [{n}, {CE_VOCAB}] bf16: max_abs_err logprob = {e:.3g}")
        results[("label_logprobs", shape)] = ce_times(logits.view(n, CE_VOCAB), tokens.view(n).to(torch.int32))
        if shape in CE_BWD_PPO:  # a step's backward
            x = logits.view(n, CE_VOCAB)
            if t == PPO_T:  # shifted labels; g is 0 outside the response window's rows
                lab = torch.cat([tokens[:, 1:], tokens[:, :1]], 1).reshape(n).to(torch.int32)
                g = torch.randn(b, t, generator=gen, device=device)
                g[:, :PPO_QUERY - 1] = 0.0
                g[:, PPO_T - 1:] = 0.0
                g = g.reshape(n)
            else:
                lab, g = tokens.view(n).to(torch.int32), torch.randn(n, generator=gen, device=device)
            lse = check_ce_bwd(note, x, lab, g, shape)
            results[("label_logprobs_bwd", shape)] = ce_bwd_times(x, lab, lse, g)
            del x, lab, g, lse
        del logits, tokens, got
        torch.cuda.empty_cache()
    # K7 and its backward at the randomwalks curves' 24-token rows, f32 and bf16
    b, t, v = CE_WALK
    for dtype in (torch.float32, torch.bfloat16):
        logits = torch.randn(b, t, v, generator=gen, device=device).mul_(3).to(dtype)
        tokens = torch.randint(0, v, (b, t), generator=gen, device=device)
        g = torch.randn(b, t, generator=gen, device=device)
        g[3], g[50:, 4:], g[:, -1] = 0.0, 0.0, 0.0
        with torch.no_grad():
            got = shifted_logprobs(logits, tokens)
        want = label_logprobs_plain(logits[:, :-1].reshape(-1, v), tokens[:, 1:].reshape(-1))[0]
        e = note("label_logprobs", got.reshape(-1), want, CE_TOL)
        lab = torch.cat([tokens[:, 1:], tokens[:, :1]], 1).reshape(-1).to(torch.int32)
        x = logits.view(b * t, v)
        lse = check_ce_bwd(note, x, lab, g.reshape(-1), "randomwalks",
                           CE_BWD_TOL if dtype == torch.bfloat16 else CE_BWD_F32_TOL)
        log(f"[train-kernels] label_logprobs randomwalks {[b, t, v]} {str(dtype)[6:]} shifted labels: "
            f"max_abs_err logprob = {e:.3g}")
        if dtype == torch.bfloat16:  # the curves' dtype
            results[("label_logprobs", "randomwalks")] = ce_times(x, lab)
            results[("label_logprobs_bwd", "randomwalks")] = ce_bwd_times(x, lab, lse, g.reshape(-1))
        del logits, tokens, g, got, want, lab, x, lse
    kernels.reset_launches()  # the comparison launches above do not count
    return results, err


# ---------------------------------------------------------------------------
# Phase 7: SFT training (the second main path)
# ---------------------------------------------------------------------------

TRAIN_STEPS = 6
TRAIN_KERNELS_PER_STEP = {"flash_fwd": 10, "flash_fwd_lse": 2, "flash_bwd_dq": 2, "flash_bwd_dkv": 2,
                          "label_logprobs": 1, "label_logprobs_bwd": 1}
# phase 7's losses with the CUDA-core forward and backward (NVIDIA H100
# 80GB HBM3, the same seed and data): a change of the kernels' arithmetic
# that keeps them within one bf16 ulp keeps the losses within LOSS_TOL
RECORDED_LOSSES = [11.3069, 10.4265, 9.5923, 8.8458, 8.2835, 8.0096]
LOSS_TOL = 0.02


def sft_samples(n=8, seed=0):
    """Text from a seed: words of a small vocabulary, 700 to 1300 bytes (the
    longer ones truncated at seq_length 1024, the shorter left padded)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    words = ["".join(chr(97 + c) for c in rng.randint(0, 26, rng.randint(2, 8))) for _ in range(64)]
    out = []
    for _ in range(n):
        text = ""
        target = rng.randint(700, 1300)
        while len(text) < target:
            text += words[rng.randint(0, len(words))] + " "
        out.append(text)
    return out


def training_config(work, **model_extra):
    from trlx_tpu_torch.data.default_configs import default_sft_config

    return default_sft_config().evolve(
        train=dict(seq_length=1024, batch_size=8, total_steps=TRAIN_STEPS, eval_interval=10000,
                   checkpoint_dir=str(work / "ckpts"), logging_dir=str(work / "logs")),
        model=dict(model_path="random:gpt2-small", num_layers_unfrozen=2,
                   model_extra_configs={"vocab_size": 50257, "attn_impl": "flash", **model_extra}),
        tokenizer=dict(tokenizer_path="byte"),
        method=dict(gen_kwargs=dict(max_new_tokens=40, do_sample=False)),
    )


def phase_train(card):
    import torch

    import trlx_tpu_torch
    from trlx_tpu_torch import kernels
    from trlx_tpu_torch.trainer.sft_trainer import SFTTrainer

    work = ROOT / "build" / "chip_smoke_sft"
    if work.exists():
        import shutil

        shutil.rmtree(work)
    config = training_config(work)
    kernels.reset_launches()
    t0 = time.perf_counter()
    trainer = trlx_tpu_torch.train(samples=sft_samples(), config=config)  # device defaults to cuda
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    metrics = next((work / "logs").glob("*.metrics.jsonl"))
    rows = [json.loads(line) for line in metrics.read_text().splitlines()]
    steps = [r for r in rows if "loss" in r]
    evals = [r["time/generate"] for r in rows if "time/generate" in r]
    losses = [r["loss"] for r in steps]
    for r in steps:
        log(f"[train] step {r['_step']}: loss={r['loss']:.6f} step_s={r['time/train_step_s']:.4f} "
            f"train_tokens_per_s={r['throughput/train_tokens_per_s']:.1f}")
    steady = steps[1:]  # step 1 pays the first-call warm-up (cuBLAS, allocator)
    step_s = statistics.median(r["time/train_step_s"] for r in steady)
    tok_s = statistics.median(r["throughput/train_tokens_per_s"] for r in steady)
    log(f"[train] gpt2-small SFT seq 1024 batch 8 bf16 flash, num_layers_unfrozen=2: {len(steps)} steps in "
        f"{wall:.2f}s wall (evaluations and the checkpoint included); median step_s={step_s:.4f} "
        f"train_tokens_per_s={tok_s:.1f}; eval generate ms={[round(e, 1) for e in evals]}; "
        f"launches={launches} ({card})")
    if len(steps) != TRAIN_STEPS or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"expected {TRAIN_STEPS} finite losses, got {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall on a repeated sample set: {losses}")
    diffs = [a - b for a, b in zip(losses, RECORDED_LOSSES)]
    log(f"[train] losses minus the recorded ones: {[round(d, 5) for d in diffs]} (tol {LOSS_TOL})")
    if len(diffs) != len(RECORDED_LOSSES) or max(abs(d) for d in diffs) > LOSS_TOL:
        raise AssertionError(f"losses {losses} differ from the recorded {RECORDED_LOSSES} by more than {LOSS_TOL}")
    if len(evals) != 2:
        raise AssertionError(f"expected the first and the last evaluation, got {len(evals)}")
    want = {n: c * TRAIN_STEPS for n, c in TRAIN_KERNELS_PER_STEP.items()}
    got = {n: launches.get(n, 0) for n in want}
    if got != want:
        raise AssertionError(f"training launches {got} != {want} (per step: {TRAIN_KERNELS_PER_STEP})")
    # the `done` checkpoint loads into a fresh trainer with equal parameters
    directory = work / "ckpts" / f"checkpoint_{TRAIN_STEPS}"
    fresh = SFTTrainer(config)
    fresh.load(str(directory))
    same = all(torch.equal(a, b) for a, b in zip(trainer.model.state_dict().values(),
                                                   fresh.model.state_dict().values()))
    if not same or fresh.iter_count != TRAIN_STEPS:
        raise AssertionError("the done checkpoint did not load back with equal parameters")
    log(f"[train] checkpoint {directory.name} loads into a fresh trainer: parameters equal, step {fresh.iter_count}")
    del trainer, fresh
    release()
    return got, dict(losses=losses, step_s=step_s, train_tokens_per_s=tok_s, eval_ms=evals, wall_s=wall)


# ---------------------------------------------------------------------------
# Phase 8: one f32 SFT step, kernels vs plain versions
# ---------------------------------------------------------------------------

# f32 throughout; the two runs differ only in the order of the sums inside
# attention and the CE reduction: loss within 1e-5 relative, each
# trainable gradient within 1e-3 of its largest element (atol) plus 1e-3
# relative. The key projection's bias has an exactly-zero gradient (a
# row's softmax ignores a shift shared by every key): on both sides it
# must be rounding noise, below 1e-5 of the largest gradient element.
GRAD_TOL = 1e-3
ZERO_GRAD_TOL = 1e-5


def sft_step_grads(trainer, batch):
    trainer.model.zero_grad(set_to_none=True)
    loss, _ = trainer.make_loss_fn()(trainer.batch_to_device(batch))
    loss.backward()
    return float(loss.detach()), {n: p.grad.detach().clone() for n, p in trainer.model.named_parameters() if p.requires_grad}


@contextmanager
def plain_versions():
    """The training kernels' wrappers (K3-K7, K7's backward) swapped for their plain
    versions on the same card; fails if a kernel launches inside."""
    from trlx_tpu_torch import kernels
    from trlx_tpu_torch.ops import attention as A
    from trlx_tpu_torch.ops import fused_ce

    swaps = {(A, "flash_fwd"): lambda q, k, v, m, c=True, with_lse=False: (
                 A.flash_fwd_plain(q, k, v, m, c) if with_lse else A.flash_fwd_plain(q, k, v, m, c)[0]),
             (A, "flash_bwd_dq"): A.flash_bwd_dq_plain, (A, "flash_bwd_dkv"): A.flash_bwd_dkv_plain,
             (fused_ce, "label_logprobs"): fused_ce.label_logprobs_plain,
             (fused_ce, "label_logprobs_bwd"): fused_ce.label_logprobs_bwd_plain}
    saved = {key: getattr(*key) for key in swaps}
    try:
        for (mod, name), fn in swaps.items():
            setattr(mod, name, fn)
        kernels.reset_launches()
        yield
        if any(kernels.LAUNCHES.values()):
            raise AssertionError(f"the plain run launched kernels: {kernels.LAUNCHES}")
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)


def check_grads(grads_k, grads_p):
    """Each trainable gradient kernels vs plain within GRAD_TOL of its
    largest element; the key bias's (exactly 0) rounding noise only.
    Returns the worst max|diff| / max|g|."""
    import torch

    worst = 0.0
    largest = max(float(g.abs().max()) for g in grads_p.values())
    for name, gk in grads_k.items():
        gp = grads_p[name]
        if name.endswith("attn.k_proj.bias"):
            noise = max(float(gk.abs().max()), float(gp.abs().max()))
            if noise > ZERO_GRAD_TOL * largest:
                raise AssertionError(f"{name}: gradient {noise} is not rounding noise")
            continue
        scale = float(gp.abs().max())
        torch.testing.assert_close(gk, gp, rtol=GRAD_TOL, atol=GRAD_TOL * max(scale, 1e-12))
        worst = max(worst, float((gk - gp).abs().max()) / max(scale, 1e-12))
    return worst


def phase_grad_check():
    import torch

    from trlx_tpu_torch import kernels
    from trlx_tpu_torch.trainer.sft_trainer import SFTTrainer

    work = ROOT / "build" / "chip_smoke_grad"
    config = training_config(work, dtype="float32", n_layers=4).evolve(train=dict(batch_size=4))
    trainer = SFTTrainer(config)
    trainer.make_experience(sft_samples(4, seed=1), config.train.seq_length)
    batch = next(iter(trainer.store.create_loader(4)))
    kernels.reset_launches()
    loss_k, grads_k = sft_step_grads(trainer, batch)
    launched = dict(kernels.LAUNCHES)
    # the same step with the wrappers' plain versions, on the same card
    with plain_versions():
        loss_p, grads_p = sft_step_grads(trainer, batch)
    worst = check_grads(grads_k, grads_p)
    if not abs(loss_k - loss_p) <= 1e-5 * abs(loss_p):
        raise AssertionError(f"f32 loss kernels {loss_k} vs plain {loss_p}")
    log(f"[grad] gpt2-small width, 4 layers, f32, b 4 t 1024: loss kernels={loss_k:.7f} plain={loss_p:.7f}; "
        f"{len(grads_k)} trainable grads, worst max|diff|/max|g| = {worst:.3g} (tol {GRAD_TOL}); "
        f"kernel launches {launched}")
    del trainer
    release()


# ---------------------------------------------------------------------------
# Phase 9: PPO (the third main path)
# ---------------------------------------------------------------------------

PPO_EPOCHS, PPO_ROLLOUTS, PPO_BATCH = 2, 128, 32
# per optimizer step: 10 frozen blocks K3, 2 trainable blocks K4-K6, the
# windowed head's K7 and its backward; per 128-row scoring chunk: 12 policy and 2 reference
# blocks K3, the policy's and the reference's K7
PPO_KERNELS_PER_STEP = {"flash_fwd": 10, "flash_fwd_lse": 2, "flash_bwd_dq": 2, "flash_bwd_dkv": 2,
                        "label_logprobs": 1, "label_logprobs_bwd": 1}
PPO_KERNELS_PER_CHUNK = {"flash_fwd": 14, "label_logprobs": 2}
PPO_NEW = 40
# The byte tokenizer decodes only ids below 256, and the rollout's text is
# tokenized again for the store: a random model's draws over 50257 ids would
# leave almost every response empty. As the JAX bench does, sampling is held
# to printable ASCII (suppress_tokens, the full 50257-way softmax still
# runs); eos is held back too, so every response is the 40 tokens of the
# workload.
PPO_SUPPRESS = [i for i in range(50257) if not 32 <= i < 127]


def ppo_prompts(n=256, seed=0):
    """Byte strings of exactly 64 bytes from a seed: words of lowercase
    letters and spaces."""
    import numpy as np

    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        text = ""
        while len(text) < PPO_QUERY:
            text += "".join(chr(97 + c) for c in rng.randint(0, 26, rng.randint(2, 9))) + " "
        out.append(text[:PPO_QUERY])
    return out


def ppo_reward(samples, prompts, outputs, **kwargs):
    """A deterministic host reward: the share of lowercase letters and
    spaces in the output."""
    return [sum(c.islower() or c == " " for c in o) / max(len(o), 1) for o in outputs]


def ppo_config(work, make=None, **model_extra):
    """Phase 9's configuration from `default_ppo_config` or another online
    default (`make`: `default_grpo_config` in phase 15)."""
    from trlx_tpu_torch.data.default_configs import default_ppo_config

    return (make or default_ppo_config)().evolve(
        train=dict(seq_length=1024, batch_size=PPO_BATCH, epochs=PPO_EPOCHS, eval_interval=16,
                   checkpoint_dir=str(work / "ckpts"), logging_dir=str(work / "logs")),
        model=dict(model_path="random:gpt2-small", num_layers_unfrozen=2,
                   model_extra_configs={"vocab_size": 50257, "attn_impl": "flash", **model_extra}),
        method=dict(num_rollouts=PPO_ROLLOUTS, chunk_size=PPO_ROLLOUTS, ppo_epochs=4,
                    gen_kwargs=dict(max_new_tokens=PPO_NEW, top_k=0, top_p=1.0, do_sample=True,
                                    suppress_tokens=PPO_SUPPRESS)),
    )


@contextmanager
def ppo_probes(record, cls=None, names=("make_experience", "score", "trunk_cache_fill", "evaluate",
                                        "train_minibatch")):
    """Wrap a trainer class's (PPOTrainer's, which GRPOTrainer inherits,
    unless `cls` names another) collection, scoring, trunk-cache fill,
    evaluation and optimizer step to record each call's wall time and its
    kernel launches, and after a collection the response lengths in the
    store: measurement of this script, the trainer is unchanged."""
    import torch

    from trlx_tpu_torch import kernels
    from trlx_tpu_torch.trainer.ppo_trainer import PPOTrainer

    cls = cls or PPOTrainer
    originals = {name: getattr(cls, name) for name in names}
    owned = {name for name in names if name in cls.__dict__}

    def probe(name):
        fn = originals[name]

        def wrapped(self, *args, **kwargs):
            torch.cuda.synchronize()
            before, t0 = dict(kernels.LAUNCHES), time.perf_counter()
            out = fn(self, *args, **kwargs)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            launched = {k: v - before.get(k, 0) for k, v in kernels.LAUNCHES.items() if v - before.get(k, 0)}
            history = getattr(self.store, "history", None)
            lengths = [len(e.response_tensor) for e in history] if name == "make_experience" and history else None
            record.append((name, t0, t1, launched, lengths))
            return out

        return wrapped

    try:
        for name in originals:
            setattr(cls, name, probe(name))
        yield
    finally:
        for name, fn in originals.items():
            if name in owned:
                setattr(cls, name, fn)
            else:
                delattr(cls, name)


def ppo_run(card, tag, work, config, per_step, per_chunk, collections=PPO_EPOCHS, elsewhere=(), rows_out=None):
    """Drive `trlx_tpu_torch.train(reward_fn=...)` once under the probes
    (`collections` collections, `config.train.epochs` of them); print each
    collection, step and evaluation; check every loss finite, every
    response 40 tokens and the launch counts exact (`per_chunk` is a
    collection's scoring pass and trunk fill together; the kernels named in
    `elsewhere`, the fleet replicas' K1 in phase 18, are counted by their
    caller); check that the `done` checkpoint loads back into a fresh
    trainer of the config's class (PPOTrainer, or GRPOTrainer in phase 15),
    whose tracker starts the run's metrics file anew (`rows_out`, a list,
    gets the run's rows first). Returns (trainer, launches, metrics)."""
    import shutil

    import torch

    import trlx_tpu_torch
    from trlx_tpu_torch import kernels
    from trlx_tpu_torch.utils.loading import get_trainer

    n_steps = collections * 4 * (PPO_ROLLOUTS // PPO_BATCH)  # ppo_epochs x loader length a collection
    if work.exists():
        shutil.rmtree(work)
    record = []
    kernels.reset_launches()
    t0 = time.perf_counter()
    with ppo_probes(record):
        trainer = trlx_tpu_torch.train(reward_fn=ppo_reward, prompts=ppo_prompts(), config=config)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    rows = [json.loads(line) for line in next((work / "logs").glob("*.metrics.jsonl")).read_text().splitlines()]
    if rows_out is not None:
        rows_out.extend(rows)
    rounds = [r for r in rows if "time/rollout_generate" in r]
    steps = [r for r in rows if "losses/total_loss" in r]
    evals = [r for r in rows if "reward/mean" in r]
    calls = lambda name: [c for c in record if c[0] == name]
    scores, fills, step_calls = calls("score"), calls("trunk_cache_fill"), calls("train_minibatch")
    lengths = [c[4] for c in calls("make_experience")]
    fill_ms = [(c[2] - c[1]) * 1e3 for c in fills]

    for i, (r, (_, s0, s1, *_), n) in enumerate(zip(rounds, scores, lengths)):
        spec = (f" spec_accept_rate={r['rollout/spec_accept_rate']:.4f} "
                f"spec_tokens_per_round={r['rollout/spec_tokens_per_round']:.4f}"
                if "rollout/spec_accept_rate" in r else "")
        fill = f" trunk_fill_ms={fill_ms[i]:.3f}" if fills else ""
        log(f"[{tag}] collection {i + 1}: generate_s={r['time/rollout_generate'] / 1e3:.4f} "
            f"rollout_tokens_per_s={r['throughput/rollout_tokens_per_s']:.1f} score_s={s1 - s0:.4f}{fill}{spec} "
            f"stored responses {len(n)}, tokens min/mean/max {min(n)}/{statistics.mean(n):.2f}/{max(n)} "
            f"reward_fn_s={r['time/rollout_score'] / 1e3:.4f} policy/sqrt_kl={r['policy/sqrt_kl']:.6f}")
    loss_keys = sorted(k for k in steps[0] if k.startswith("losses/"))
    for r in steps:
        log(f"[{tag}] step {r['_step']}: " + " ".join(f"{k[7:]}={r[k]:.6f}" for k in loss_keys)
            + f" approx_kl={r['policy/approx_kl']:.3g} step_s={r['time/train_step_s']:.4f} "
            f"train_tokens_per_s={r['throughput/train_tokens_per_s']:.1f}")
    for r in evals:
        log(f"[{tag}] eval at step {r['_step']}: reward/mean={r['reward/mean']:.5f} "
            f"generate_ms={r['time/generate']:.1f}")
    # a cycle: one collection and its optimizer steps (evaluations excluded)
    starts = [c[1] for c in calls("make_experience")]
    ends = starts[1:] + [float("inf")]
    samples_per_s = []
    for start, end in zip(starts, ends):
        cycle_end = [c for c in step_calls if start <= c[1] < end][-1][2]
        evals_in = sum(c[2] - c[1] for c in calls("evaluate") if start <= c[1] and c[2] <= cycle_end)
        cycle_s = cycle_end - start - evals_in
        samples_per_s.append(PPO_ROLLOUTS / cycle_s)
    steady = steps[1:]  # step 1 pays the first-call warm-up (cuBLAS, allocator)
    metrics = dict(
        wall_s=wall, samples_per_s=samples_per_s,
        step_s=statistics.median(r["time/train_step_s"] for r in steady),
        train_tokens_per_s=statistics.median(r["throughput/train_tokens_per_s"] for r in steady),
        sampling_s=[r["time/rollout_generate"] / 1e3 for r in rounds],
        scoring_s=[c[2] - c[1] for c in scores],
        rollout_tokens_per_s=[r["throughput/rollout_tokens_per_s"] for r in rounds],
        spec_accept_rate=[r.get("rollout/spec_accept_rate") for r in rounds],
        spec_tokens_per_round=[r.get("rollout/spec_tokens_per_round") for r in rounds],
        trunk_fill_ms=fill_ms,
    )
    log(f"[{tag}] gpt2-small {type(trainer).__name__}, {PPO_ROLLOUTS} rollouts x {len(rounds)} collections, batch {PPO_BATCH}, "
        f"ppo_epochs 4, {PPO_NEW} new tokens, bf16 flash, num_layers_unfrozen=2: {len(steps)} steps in {wall:.2f}s "
        f"wall; median step_s={metrics['step_s']:.4f} train_tokens_per_s={metrics['train_tokens_per_s']:.1f}; "
        f"samples_per_s per cycle={[round(x, 2) for x in samples_per_s]}; launches={launches} ({card})")

    losses = [r[k] for r in steps for k in loss_keys]
    if len(steps) != n_steps or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"expected {n_steps} steps of finite losses, got {len(steps)}: {losses}")
    if len(rounds) != collections or len(scores) != collections or len(evals) != collections + 1:
        raise AssertionError(f"expected {collections} collections and {collections + 1} evaluations, got "
                             f"{len(rounds)}, {len(scores)} scoring passes, {len(evals)}")
    if [len(n) for n in lengths] != [PPO_ROLLOUTS] * collections or any(set(n) != {PPO_NEW} for n in lengths):
        raise AssertionError(f"expected {PPO_ROLLOUTS} stored responses of {PPO_NEW} tokens a collection, got "
                             f"{[(len(n), min(n), max(n)) for n in lengths]}")
    chunks = [dict(c[3]) for c in scores]
    for chunk, fill in zip(chunks, fills):
        for k, v in fill[3].items():
            chunk[k] = chunk.get(k, 0) + v
    for name, got, want in [("step", c[3], per_step) for c in step_calls] + \
            [("chunk (scoring and trunk fill)", c, per_chunk) for c in chunks]:
        if got != want:
            raise AssertionError(f"{tag}: a {name} launched {got}, expected {want}")
    names = set(per_step) | set(per_chunk)
    want = {n: n_steps * per_step.get(n, 0) + collections * per_chunk.get(n, 0) for n in names}
    got = {n: launches.get(n, 0) for n in want}
    if got != want or any(v for k, v in launches.items() if k not in want and k not in elsewhere):
        raise AssertionError(f"{tag}: PPO launches {launches} != {want}")

    # the `done` checkpoint loads into a fresh trainer with the same state
    directory = work / "ckpts" / f"checkpoint_{n_steps}"
    fresh = get_trainer(config.train.trainer)(config, reward_fn=ppo_reward)
    fresh.load(str(directory))
    same = all(torch.equal(a, b) for m, f in ((trainer.model, fresh.model), (trainer.ref_model, fresh.ref_model))
               for a, b in zip(m.state_dict().values(), f.state_dict().values()))
    same = same and fresh.kl_ctl.value == trainer.kl_ctl.value and fresh.mean_kl == trainer.mean_kl
    same = same and all(getattr(fresh.running_moments, k) == getattr(trainer.running_moments, k)
                        for k in ("mean", "std", "var", "count"))
    same = same and len(fresh.store) == len(trainer.store) and all(
        (a.response_tensor == b.response_tensor).all() and (a.rewards == b.rewards).all()
        and (a.h_split is None) == (b.h_split is None) and (a.h_split is None or torch.equal(a.h_split, b.h_split))
        for a, b in zip(fresh.store.history, trainer.store.history))
    if not same or fresh.iter_count != n_steps:
        raise AssertionError(f"{tag}: the done checkpoint did not load back with the same state")
    kept = sorted(p.name for p in (work / "ckpts").iterdir())
    log(f"[{tag}] checkpoint {directory.name} loads into a fresh {type(fresh).__name__}: policy and reference parameters, "
        f"KL value, running moments and store{' (with its trunk cache rows)' if fills else ''} equal; "
        f"checkpoint dir holds {kept}")
    del fresh
    return trainer, launches, metrics


def phase_ppo(card):
    import torch

    work = ROOT / "build" / "chip_smoke_ppo"
    trainer, launches, metrics = ppo_run(card, "ppo", work, ppo_config(work), PPO_KERNELS_PER_STEP,
                                         PPO_KERNELS_PER_CHUNK)
    del trainer
    release()
    return launches, metrics


# ---------------------------------------------------------------------------
# Phase 10: one f32 PPO scoring pass and step, kernels vs plain versions
# ---------------------------------------------------------------------------

SCORE_TOL = dict(rtol=1e-5, atol=1e-5)


def ppo_injected_batch(n=PPO_BATCH, seed=2):
    """A rollout batch from a seed: left-padded 64-token queries, right-padded
    40-token responses of bytes, old logprobs, values and rewards."""
    import numpy as np

    from trlx_tpu_torch.data import PPORLBatch

    rng = np.random.RandomState(seed)
    mask = ppo_mask_rows(n)
    mask[2] = 1  # every row has a query here
    tokens = np.where(mask > 0, rng.randint(0, 256, mask.shape), 256).astype(np.int32)
    stat = lambda scale: (rng.randn(n, 40) * scale).astype(np.float32)
    return PPORLBatch(query_tensors=tokens[:, :PPO_QUERY], response_tensors=tokens[:, PPO_QUERY:],
                      logprobs=stat(1.0) - 11.0, values=stat(0.5), rewards=stat(0.1))


# The value head's hidden layer is a ReLU: a unit whose input sits within
# the runs' 1e-6 difference of 0 at some position would be on in one run
# and off in the other, and its row of the first layer's gradient would
# then differ by that position's whole share. So the kernel run takes the
# plain run's gates (each MLP head's ReLU on/off pattern: the value head,
# the value branch's, ILQL's Q and V heads) as fixed: relu(x) = x * gate
# in value and in gradient at the plain run's gate, and every element of
# every trainable gradient is held to GRAD_TOL.


def step_grads(trainer, batch, gates=None):
    """(loss, trainable gradients, {head: its ReLU gate}) of one training
    step's loss; with `gates` given, each MLP head applies its gate in
    place of its own ReLU's."""
    from trlx_tpu_torch.models.heads import MLPHead

    used, hooks = {}, []
    for name, head in trainer.model.named_modules():
        if not isinstance(head, MLPHead):
            continue

        def stash(mod, args, out, name=name):
            used[name] = (out, out > 0 if gates is None else gates[name])

        def gated(mod, args, name=name):
            pre, g = used[name]
            return (pre * g,)

        hooks += [head.dense_in.register_forward_hook(stash), head.dense_out.register_forward_pre_hook(gated)]
    try:
        trainer.model.zero_grad(set_to_none=True)
        loss, _ = trainer.make_loss_fn()(trainer.batch_to_device(batch))
        loss.backward()
    finally:
        for hook in hooks:
            hook.remove()
    grads = {n: p.grad.detach().clone() for n, p in trainer.model.named_parameters() if p.requires_grad}
    return float(loss.detach()), grads, {n: out.detach() > 0 for n, (out, _) in used.items()}


def gate_flips(gates_k, gates_p):
    """(gate entries the kernel run's own ReLUs set otherwise, all entries)."""
    return sum(int((gates_k[n] != gates_p[n]).sum()) for n in gates_p), sum(g.numel() for g in gates_p.values())


def ppo_f32_kernels_vs_plain(config):
    """A trainer of `config` (f32; PPOTrainer or GRPOTrainer, whose values
    slot holds the reference's logprobs) with its reference perturbed, so the
    KL is not 0; one scoring pass and one step on phase 10's injected batch
    with the plain versions, then with the kernels under the plain run's
    ReLU gates: scoring within SCORE_TOL, the loss within 1e-5 relative,
    every gradient within GRAD_TOL. Returns the trainer, the batch and its
    tokens, and a dict of the numbers."""
    import numpy as np
    import torch

    from trlx_tpu_torch import kernels
    from trlx_tpu_torch.utils.loading import get_trainer

    trainer = get_trainer(config.train.trainer)(config, reward_fn=ppo_reward)
    with torch.no_grad():
        gen = torch.Generator(device=trainer.device).manual_seed(3)
        for p in trainer.ref_model.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=gen, device=p.device))
    batch = ppo_injected_batch()
    tokens = torch.from_numpy(np.concatenate([batch.query_tensors, batch.response_tensors], 1)).to(trainer.device).long()
    with plain_versions():
        scored_p = trainer.score(tokens)
        loss_p, grads_p, gates_p = step_grads(trainer, batch)
    kernels.reset_launches()
    scored_k = trainer.score(tokens)
    loss_k, grads_k, gates_k = step_grads(trainer, batch, gates=gates_p)
    launched = dict(kernels.LAUNCHES)
    errs = {}
    for name, a, b in zip(("logprobs", "values", "log_ratio", "mean_kl", "mean_kl_per_token"), scored_k, scored_p):
        torch.testing.assert_close(a, b, **SCORE_TOL, msg=lambda m: f"scoring {name}: {m}")
        errs[name] = float((a - b).abs().max())
    if float(scored_k[3]) <= 0:
        raise AssertionError("the perturbed reference gave no KL")
    worst = check_grads(grads_k, grads_p)
    if not abs(loss_k - loss_p) <= 1e-5 * abs(loss_p):
        raise AssertionError(f"f32 PPO loss kernels {loss_k} vs plain {loss_p}")
    flips, entries = gate_flips(gates_k, gates_p)
    summary = (f"scoring max|diff| {', '.join(f'{k} {v:.3g}' for k, v in errs.items())} (tol {SCORE_TOL}); "
               f"loss kernels={loss_k:.7f} plain={loss_p:.7f}; {len(grads_k)} trainable grads, every element held, "
               f"worst max|diff|/max|g| = {worst:.3g} (tol {GRAD_TOL}); the heads ran the plain run's ReLU gates "
               f"({flips} of {entries} entries differ from the kernel run's own); kernel launches {launched}")
    numbers = dict(errs=errs, loss_k=loss_k, loss_p=loss_p, grads_k=grads_k, gates_p=gates_p, worst=worst,
                   summary=summary)
    return trainer, batch, tokens, numbers


def phase_ppo_grad_check():
    import torch

    config = ppo_config(ROOT / "build" / "chip_smoke_ppo_grad", dtype="float32", n_layers=4)
    trainer, _, _, n = ppo_f32_kernels_vs_plain(config)
    log(f"[ppo-grad] gpt2-small width, 4 layers, f32, split 2, 32 injected rows t {PPO_T}: {n['summary']}")
    del trainer
    release()


# ---------------------------------------------------------------------------
# Phase 11: PPO with the bench's headline options
# ---------------------------------------------------------------------------

# the three method options the JAX bench turns on (`bench.py:123-160`), at
# their defaults: spec_k 4, spec_draft_rank 64, a bf16 trunk cache
PPO_OPTIONS = dict(cache_trunk_activations=True, speculative_decode=True, quantize_frozen_trunk=True)
# per optimizer step: no K3 (the trunk cache stands in for the 10 frozen
# blocks), K4-K6 in the 2 trainable ones, K7 and its backward; per 128-row
# chunk: scoring's 14 K3 and 2 K7, and the trunk fill's 10 K3
PPO_OPT_KERNELS_PER_STEP = {"flash_fwd_lse": 2, "flash_bwd_dq": 2, "flash_bwd_dkv": 2,
                            "label_logprobs": 1, "label_logprobs_bwd": 1}
PPO_OPT_KERNELS_PER_CHUNK = {"flash_fwd": 24, "label_logprobs": 2}
# greedy speculative vs plain decode at f32: a row may differ only where
# the plain sampler's top two warped scores lie within TIE_GAP (the k+1-row
# verify GEMM and the 1-row decode GEMM round differently)
TIE_GAP = 1e-4
# the trunk cache against the full path: f32 cache, loss within 1e-6
# relative (gradients GRAD_TOL); bf16 cache, loss within 2e-3 relative
# (`tests/test_trunk_cache.py`'s bound)
CACHE_F32_LOSS_TOL, CACHE_BF16_LOSS_TOL = 1e-6, 2e-3


def greedy_spec_vs_plain(trainer, batch):
    """Greedy speculative and plain sampling of one prompt batch on the
    trainer's decode view (the int8 trunk). Returns (rows, equal rows,
    [(row, position, the plain sampler's top-two gap there)] for each row
    that differs, the speculative counters)."""
    import torch

    from trlx_tpu_torch.ops import sampling

    gen = dict(max_new_tokens=PPO_NEW, do_sample=False, suppress_tokens=PPO_SUPPRESS)
    gaps, process = [], sampling.process_logits

    def recording(logits, cfg, step, seen=None):
        out = process(logits, cfg, step, seen)
        top = torch.topk(out, 2, dim=-1).values
        gaps.append(top[:, 0] - top[:, 1])
        return out

    sampling.process_logits = recording  # the plain loop's warp, read at call time
    try:
        plain = trainer.generate(batch["input_ids"], batch["attention_mask"], gen)
    finally:
        sampling.process_logits = process
    spec = trainer.generate(batch["input_ids"], batch["attention_mask"], gen, spec_k=trainer._spec_k_effective())
    diff = plain["response_tokens"] != spec["response_tokens"]
    first = diff.int().argmax(dim=1)
    gap = torch.stack(gaps, dim=1)
    differ = [(r, int(first[r]), float(gap[r, first[r]])) for r in diff.any(dim=1).nonzero()[:, 0].tolist()]
    counters = (int(spec["spec_rounds"].sum()), int(spec["spec_accepted"].sum()))
    return diff.shape[0], diff.shape[0] - len(differ), differ, counters


def phase_ppo_options(card, base):
    """PPO through `trlx_tpu_torch.train(reward_fn=...)` with the three
    options on phase 9's configuration; then, on the card, greedy
    speculative vs plain sampling (f32 and bf16, the int8 view in both),
    the trunk cache against the full path (f32 and bf16 caches), and the
    decode view's build time and bytes. `base` holds phase 9's numbers."""
    import dataclasses

    import numpy as np
    import torch

    from trlx_tpu_torch import kernels
    from trlx_tpu_torch.ops import quant, sampling
    from trlx_tpu_torch.pipeline.offline_pipeline import PromptPipeline
    from trlx_tpu_torch.trainer.ppo_trainer import PPOTrainer

    work = ROOT / "build" / "chip_smoke_ppo_options"
    config = ppo_config(work).evolve(method=PPO_OPTIONS)
    trainer, launches, m = ppo_run(card, "ppo-options", work, config, PPO_OPT_KERNELS_PER_STEP,
                                   PPO_OPT_KERNELS_PER_CHUNK)
    if trainer.spec_decode_fallbacks != 0 or not trainer._trunk_cache_available():
        raise AssertionError(f"the options fell back: spec_decode_fallbacks={trainer.spec_decode_fallbacks}, "
                             f"trunk cache gate {trainer._trunk_cache_available()}")
    if None in m["spec_accept_rate"] or any(e.h_split is None for e in trainer.store.history):
        raise AssertionError("a collection ran without speculative decode or without the trunk cache")

    # the decode view: built once (the trainer's own was built at its first
    # sampling call), dequantized once per sampling call
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    view = quant.quantize_frozen(trainer.model, trainer.split)
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    dense = quant.dequantize_tree(view, torch.bfloat16)
    torch.cuda.synchronize()
    dequant_ms = (time.perf_counter() - t0) * 1e3
    int8_bytes = quant.quantized_bytes(view)
    bf16_bytes = sum(t.numel() * t.element_size() for t in dense.values())
    f32_bytes = 2 * bf16_bytes
    # the draft head: a host SVD, computed once inside the first sampling call
    t0 = time.perf_counter()
    sampling.spec_draft_head_from_params(trainer.model.state_dict(), trainer.model_cfg,
                                         config.method.spec_draft_rank)
    head_s = time.perf_counter() - t0
    log(f"[ppo-options] decode view: {len(view)} frozen matrices, built in {build_ms:.2f} ms, {int8_bytes:,} bytes "
        f"int8 and scales ({f32_bytes:,} bytes as f32 parameters); dequantized to bf16 per sampling call in "
        f"{dequant_ms:.2f} ms, {bf16_bytes:,} bytes; the rank-{config.method.spec_draft_rank} draft head's SVD "
        f"on the host {head_s:.2f} s, once ({card})")
    del view, dense

    # greedy speculative vs plain at bf16 (the run's trainer): a share only
    trainer.add_prompt_pipeline(PromptPipeline(ppo_prompts(), 984, trainer.tokenizer))
    n, equal, _, (rounds, accepted) = greedy_spec_vs_plain(trainer, trainer._next_prompts())
    log(f"[ppo-options] greedy speculative vs plain, bf16, int8 view: {equal} of {n} rows equal "
        f"(accepted {accepted} drafts in {rounds} row-rounds)")
    bf16_equal = equal / n
    del trainer
    release()

    # at f32: greedy speculative vs plain under the tie rule, and the trunk cache
    f32_config = ppo_config(ROOT / "build" / "chip_smoke_ppo_options_f32", dtype="float32").evolve(
        method=dict(PPO_OPTIONS, trunk_cache_dtype="float32"))
    trainer = PPOTrainer(f32_config, reward_fn=ppo_reward)
    trainer.add_prompt_pipeline(PromptPipeline(ppo_prompts(), 984, trainer.tokenizer))
    n, equal, differ, (rounds, accepted) = greedy_spec_vs_plain(trainer, trainer._next_prompts())
    ties = [d for d in differ if d[2] <= TIE_GAP]
    log(f"[ppo-options] greedy speculative vs plain, f32, int8 view, {n} rows x {PPO_NEW} tokens: {equal} equal; "
        f"{len(differ)} differ, each at a near tie (row, first position, plain top-two gap): {differ} "
        f"(tie rule: gap <= {TIE_GAP}); accepted {accepted} drafts in {rounds} row-rounds")
    if len(ties) != len(differ):
        raise AssertionError(f"greedy speculative decode left the plain sampler away from a tie: {differ}")

    batch = ppo_injected_batch()
    tokens = torch.from_numpy(np.concatenate([batch.query_tensors, batch.response_tensors], 1))
    h32 = trainer.trunk_cache_fill(tokens.to(trainer.device).long())
    loss_f, grads_f, gates = step_grads(trainer, batch)
    kernels.reset_launches()
    loss_c, grads_c, _ = step_grads(trainer, dataclasses.replace(batch, h_split=h32), gates=gates)
    cached_launches = dict(kernels.LAUNCHES)
    loss_b, _, _ = step_grads(trainer, dataclasses.replace(batch, h_split=h32.to(torch.bfloat16)), gates=gates)
    worst = check_grads(grads_c, grads_f)
    rel_f32, rel_bf16 = abs(loss_c - loss_f) / abs(loss_f), abs(loss_b - loss_f) / abs(loss_f)
    log(f"[ppo-options] trunk cache, f32, 32 injected rows t {PPO_T}: loss full={loss_f:.9f} f32 cache={loss_c:.9f} "
        f"(rel {rel_f32:.3g}, tol {CACHE_F32_LOSS_TOL}) bf16 cache={loss_b:.9f} (rel {rel_bf16:.3g}, tol "
        f"{CACHE_BF16_LOSS_TOL}); {len(grads_c)} trainable grads with the full path's ReLU gate, worst "
        f"max|diff|/max|g| = {worst:.3g} (tol {GRAD_TOL}); the cached step launched {cached_launches}")
    if rel_f32 > CACHE_F32_LOSS_TOL or rel_bf16 > CACHE_BF16_LOSS_TOL or cached_launches.get("flash_fwd", 0):
        raise AssertionError("the trunk cache's step disagrees with the full path or ran the trunk")
    del trainer
    release()

    pair = lambda key, fmt: f"{key} {fmt(m[key])} (phase 9: {fmt(base[key])})"
    rnd = lambda xs: [round(x, 4) for x in xs]
    log(f"[ppo-options] vs phase 9 in this call ({card}): " + "; ".join([
        pair("samples_per_s", rnd), pair("sampling_s", rnd), pair("rollout_tokens_per_s", rnd),
        pair("step_s", lambda x: f"{x:.4f}"), pair("train_tokens_per_s", lambda x: f"{x:.1f}"),
        f"spec_accept_rate {rnd(m['spec_accept_rate'])}", f"spec_tokens_per_round {rnd(m['spec_tokens_per_round'])}",
        f"trunk_fill_ms per chunk {rnd(m['trunk_fill_ms'])}"]))
    summary = dict(m, view_build_ms=build_ms, view_int8_bytes=int8_bytes, view_bf16_bytes=bf16_bytes,
                   view_dequant_ms=dequant_ms, draft_head_s=head_s, greedy_f32_equal_rows=equal, greedy_f32_rows=n,
                   greedy_f32_ties=differ, greedy_bf16_equal_share=bf16_equal, cache_f32_loss_rel=rel_f32,
                   cache_bf16_loss_rel=rel_bf16, cache_grad_worst=worst, spec_decode_fallbacks=0)
    return launches, summary


# ---------------------------------------------------------------------------
# Phase 12: the pipelined cycle (the JAX bench's timed schedule)
# ---------------------------------------------------------------------------

# phase 9's configuration under `pipelined_cycle`, four ways: (a) the
# speculative scorer, options off; (b) (a) with the capture fast path
# (`--fast-rollout` of the JAX bench); (c) the JAX bench's headline
# options, fast path off; (d) (c) with the fast path
PIPELINED = {
    "a": dict(),
    "b": dict(capture_rollout_stats=True),
    "c": dict(PPO_OPTIONS),
    "d": dict(PPO_OPTIONS, capture_rollout_stats=True),
}
PIPELINED_CYCLES = 3  # timed, after one warm-up cycle
# launches a 128-row chunk, by the scorer's dispatch and the trunk cache's
# attach: the speculative scorer is phase 9's scoring pass (12 policy and
# 2 reference blocks K3, two K7); the fast scorer runs the reference's 2
# suffix blocks (K3) and one K7 over the response window; the attach runs
# the trunk's 10 blocks (K3) under (c) and reuses the capture under (d)
PIPELINED_PER_CHUNK = {
    "a": {"flash_fwd": 14, "label_logprobs": 2},
    "b": {"flash_fwd": 2, "label_logprobs": 1},
    "c": {"flash_fwd": 24, "label_logprobs": 2},
    "d": {"flash_fwd": 2, "label_logprobs": 1},
}
PIPELINED_PER_STEP = {"a": PPO_KERNELS_PER_STEP, "b": PPO_KERNELS_PER_STEP,
                      "c": PPO_OPT_KERNELS_PER_STEP, "d": PPO_OPT_KERNELS_PER_STEP}
PIPELINED_STEPS = 4 * (PPO_ROLLOUTS // PPO_BATCH)  # ppo_epochs x steps an epoch
FAST_TOL, MERGE_TOL = 5e-4, 1e-5  # fast scorer vs the batched forward; merge vs the classic scorer


@contextmanager
def pipelined_probes(record, sync):
    """Wrap the pipelined cycle's parts (sampling, the scorers, the trunk
    cache's attach, the optimizer step, the blocking fetch) to record each
    call's kernel launches and, with `sync`, its wall time between two
    device synchronizations: measurement of this script, the trainer is
    unchanged."""
    import torch

    from trlx_tpu_torch import kernels
    from trlx_tpu_torch.trainer.ppo_trainer import PPOTrainer

    names = ("dispatch_rollout_generation", "_dispatch_spec_score", "_dispatch_fast_score", "_score_reward",
             "_attach_trunk_cache", "optimizer_step", "_fetch")
    originals = {name: getattr(PPOTrainer, name) for name in names}

    def probe(name):
        fn = originals[name]

        def wrapped(self, *args, **kwargs):
            if sync:
                torch.cuda.synchronize()
            before, t0 = dict(kernels.LAUNCHES), time.perf_counter()
            out = fn(self, *args, **kwargs)
            if sync:
                torch.cuda.synchronize()
            launched = {k: v - before.get(k, 0) for k, v in kernels.LAUNCHES.items() if v - before.get(k, 0)}
            record.append((name, (time.perf_counter() - t0) * 1e3, launched))
            return out

        return wrapped

    try:
        for name in names:
            setattr(PPOTrainer, name, probe(name))
        yield
    finally:
        for name, fn in originals.items():
            setattr(PPOTrainer, name, fn)


def pipelined_run(card, tag):
    """Configuration `tag`: one warm-up cycle, PIPELINED_CYCLES timed cycles
    (samples/s per cycle; the launches of every scorer, attach and step
    checked exact) and one cycle
    under synchronizing probes (scoring, attach, fetch and step ms).
    Returns its numbers and the timed cycles' launches."""
    import torch

    from trlx_tpu_torch import kernels
    from trlx_tpu_torch.pipeline.offline_pipeline import PromptPipeline
    from trlx_tpu_torch.trainer.ppo_trainer import PPOTrainer

    config = ppo_config(ROOT / "build" / f"chip_smoke_pipelined_{tag}").evolve(method=PIPELINED[tag])
    trainer = PPOTrainer(config, reward_fn=ppo_reward)
    trainer.add_prompt_pipeline(PromptPipeline(ppo_prompts(), 984, trainer.tokenizer))
    fast = tag in ("b", "d")
    if trainer._fast_rollout_available() != fast or trainer._trunk_cache_available() != (tag in ("c", "d")):
        raise AssertionError(f"[pipelined-{tag}] gates: fast {trainer._fast_rollout_available()}, "
                             f"trunk cache {trainer._trunk_cache_available()}")
    losses, fetch_ms, host_ms, record = [], [], [], []
    t0 = time.perf_counter()
    loss, pending = trainer.pipelined_cycle()  # warm-up: two chunks sampled, one trained on
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    kernels.reset_launches()
    with pipelined_probes(record, sync=False):
        # no synchronization between the cycles, so each cycle's fetch waits
        # for what the previous one left queued, as in a training loop; a
        # cycle's wall is the time between two returns (the last one ends in
        # a synchronization)
        ends = [time.perf_counter()]
        for i in range(PIPELINED_CYCLES):
            loss, pending = trainer.pipelined_cycle(pending)
            if i == PIPELINED_CYCLES - 1:
                torch.cuda.synchronize()
            ends.append(time.perf_counter())
            losses.append(loss)
            fetch_ms.append(trainer.cycle_stats["fetch_wait_ms"])
            host_ms.append(trainer.cycle_stats["host_ms"])
        cycle_s = [b - a for a, b in zip(ends, ends[1:])]
    launches = dict(kernels.LAUNCHES)
    timed = []
    with pipelined_probes(timed, sync=True):
        loss, pending = trainer.pipelined_cycle(pending)
    losses += [loss, float(pending[2][0])]

    scorer = "_dispatch_fast_score" if fast else "_dispatch_spec_score"
    calls = lambda rec, name: [c for c in rec if c[0] == name]
    per_step, per_chunk = PIPELINED_PER_STEP[tag], PIPELINED_PER_CHUNK[tag]
    checks = [("a sampling call", c[2], {}) for c in calls(record, "dispatch_rollout_generation")]
    checks += [("an optimizer step", c[2], per_step) for c in calls(record, "optimizer_step")]
    chunks = [dict(c[2]) for c in calls(record, scorer)]
    for chunk, attach in zip(chunks, calls(record, "_attach_trunk_cache")):
        for k, v in attach[2].items():
            chunk[k] = chunk.get(k, 0) + v
    checks += [("a chunk (scorer and attach)", c, per_chunk) for c in chunks]
    for what, got, want in checks:
        if got != want:
            raise AssertionError(f"[pipelined-{tag}] {what} launched {got}, expected {want}")
    counts = {name: len(calls(record, name)) for name in ("dispatch_rollout_generation", scorer, "optimizer_step",
                                                          "_attach_trunk_cache", "_score_reward")}
    want_counts = {"dispatch_rollout_generation": PIPELINED_CYCLES, scorer: PIPELINED_CYCLES,
                   "optimizer_step": PIPELINED_CYCLES * PIPELINED_STEPS, "_attach_trunk_cache": PIPELINED_CYCLES,
                   "_score_reward": 0}
    if counts != want_counts or trainer.spec_fallbacks != 0:
        raise AssertionError(f"[pipelined-{tag}] calls {counts} (expected {want_counts}), "
                             f"spec_fallbacks {trainer.spec_fallbacks}")
    names = set(per_step) | set(per_chunk)
    want = {n: PIPELINED_CYCLES * (PIPELINED_STEPS * per_step.get(n, 0) + per_chunk.get(n, 0)) for n in names}
    if {n: launches.get(n, 0) for n in want} != want or any(v for k, v in launches.items() if k not in want):
        raise AssertionError(f"[pipelined-{tag}] launches {launches} != {want}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"[pipelined-{tag}] non-finite loss: {losses}")

    ms = lambda name: [round(c[1], 3) for c in calls(timed, name)]
    step_ms = ms("optimizer_step")
    m = dict(samples_per_s=[PPO_ROLLOUTS / s for s in cycle_s], cycle_s=cycle_s, warmup_s=warm_s,
             fetch_wait_ms=fetch_ms, host_ms=host_ms, losses=losses, scorer=scorer.strip("_"),
             score_ms=ms(scorer), sampling_ms=ms("dispatch_rollout_generation"),
             trunk_fill_ms=ms("_attach_trunk_cache") if tag in ("c", "d") else [0.0],
             fetch_ms_synced=ms("_fetch"), step_ms_median=statistics.median(step_ms),
             spec_decode_rounds=trainer.spec_decode_rounds, spec_decode_accepted=trainer.spec_decode_accepted)
    log(f"[pipelined-{tag}] {PIPELINED[tag] or 'options off'}: samples/s per cycle "
        f"{[round(x, 2) for x in m['samples_per_s']]} (cycle s {[round(x, 4) for x in cycle_s]}, warm-up "
        f"{warm_s:.2f} s); blocking fetch wait ms {[round(x, 3) for x in fetch_ms]}; host decode/reward ms "
        f"{[round(x, 3) for x in host_ms]}; losses {[round(x, 6) for x in losses]}; spec_fallbacks 0; "
        f"launches {launches} ({card})")
    log(f"[pipelined-{tag}] synchronized cycle: sampling ms {m['sampling_ms']}, {m['scorer']} ms {m['score_ms']}, "
        f"trunk cache attach ms {m['trunk_fill_ms']}, fetch ms {m['fetch_ms_synced']}, step ms median "
        f"{m['step_ms_median']:.3f} ({len(step_ms)} steps)")
    del trainer, pending
    release()
    return m, launches


def pipelined_f32_check():
    """At f32 on the card (full width and depth, the reference perturbed so
    the KL is not 0): a captured rollout's fast scorer against the batched
    scoring forward (the speculative scorer on the same tokens) within
    FAST_TOL, and the speculative merge against the classic in-graph
    scorer within MERGE_TOL."""
    import torch

    from trlx_tpu_torch.pipeline.offline_pipeline import PromptPipeline
    from trlx_tpu_torch.trainer.ppo_trainer import PPOTrainer

    config = ppo_config(ROOT / "build" / "chip_smoke_pipelined_f32", dtype="float32").evolve(
        method=PIPELINED["b"])
    trainer = PPOTrainer(config, reward_fn=ppo_reward)
    with torch.no_grad():
        gen = torch.Generator(device=trainer.device).manual_seed(3)
        for p in trainer.ref_model.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=gen, device=p.device))
    trainer.add_prompt_pipeline(PromptPipeline(ppo_prompts(), 984, trainer.tokenizer))
    _, out = trainer.dispatch_rollout_generation()
    samples = out["samples"]
    q = samples.shape[1] - PPO_NEW
    fast = trainer._dispatch_fast_score(out)
    spec = trainer._dispatch_spec_score(out)
    if not torch.equal(fast[0], samples[:, q:]):
        raise AssertionError("the device trim of printable samples is not the raw response")
    errs = {}
    for name, a, b in zip(("logprobs", "values", "log_ratio"), fast[1:4], spec[1:4]):
        torch.testing.assert_close(a, b, rtol=0, atol=FAST_TOL, msg=lambda s: f"fast scorer {name}: {s}")
        errs[name] = float((a - b).abs().max())
    scores = torch.rand((samples.shape[0], 1), generator=torch.Generator(device=trainer.device).manual_seed(5),
                        device=trainer.device)
    kl = trainer.kl_ctl.value
    merged = trainer._spec_merge(samples[:, :q], spec[0], *spec[1:4], scores, kl, True)
    classic, mean_kl, _ = trainer._score_reward(samples[:, :q], spec[0], scores, kl, True)
    for f in ("logprobs", "values", "rewards"):
        a, b = getattr(merged, f), getattr(classic, f)
        torch.testing.assert_close(a, b, rtol=MERGE_TOL, atol=MERGE_TOL, msg=lambda s: f"merge {f}: {s}")
        errs[f"merge {f}"] = float((a - b).abs().max())
    if not float(spec[4]) > 0 or abs(float(spec[4]) - float(mean_kl)) > MERGE_TOL * float(mean_kl):
        raise AssertionError(f"mean_kl speculative {float(spec[4])} vs classic {float(mean_kl)}")
    log(f"[pipelined-f32] gpt2-small f32, {samples.shape[0]} captured rollouts x {PPO_NEW} tokens, perturbed "
        f"reference: fast scorer vs the batched forward and the speculative merge vs the classic scorer, max|diff| "
        f"{ {k: float(f'{v:.3g}') for k, v in errs.items()} } (tol {FAST_TOL}, {MERGE_TOL}); mean_kl "
        f"{float(mean_kl):.6f}, fast (window) {float(fast[4]):.6f}")
    del trainer
    release()
    return errs


def phase_pipelined(card, base, options):
    """Phase 12: configurations (a)-(d) under `pipelined_cycle`, then the
    f32 checks; samples/s per cycle printed beside phases 9 and 11."""
    results, launches = {}, {}
    for tag in PIPELINED:
        results[tag], launches[tag] = pipelined_run(card, tag)
    errs = pipelined_f32_check()
    rnd = lambda xs: [round(x, 2) for x in xs]
    log(f"[pipelined] samples/s per cycle in this call ({card}): phase 9 (make_experience + learn) "
        f"{rnd(base['samples_per_s'])}, phase 11 (options) {rnd(options['samples_per_s'])}; pipelined "
        + "; ".join(f"({t}) {rnd(r['samples_per_s'])}" for t, r in results.items()))
    return results, launches, errs


# ---------------------------------------------------------------------------
# Phase 13: PPO's value branch
# ---------------------------------------------------------------------------

# phase 9's configuration with the deeper value branch: clones of the top 2
# blocks and the final norm, tapping at block 10, the hydra split
VALUE_BRANCH = dict(num_value_layers_unfrozen=2)
# per optimizer step: phase 9's 10 frozen blocks K3, K4-K6 in the 2
# trainable blocks and the branch's 2, K7 and its backward over the full
# [32 x 104, V] logits (the branch's blocks attend over the full sequence,
# so the loss reads no windowed head); per 128-row chunk: phase 9's 14 K3
# and the branch's 2, the policy's and the reference's K7
BRANCH_KERNELS_PER_STEP = {"flash_fwd": 10, "flash_fwd_lse": 4, "flash_bwd_dq": 4, "flash_bwd_dkv": 4,
                           "label_logprobs": 1, "label_logprobs_bwd": 1}
BRANCH_KERNELS_PER_CHUNK = {"flash_fwd": 16, "label_logprobs": 2}
# with the trunk cache: no K3 a step (the branch is fed from the cache);
# a chunk adds the trunk fill's 10
BRANCH_CACHE_KERNELS_PER_STEP = {k: v for k, v in BRANCH_KERNELS_PER_STEP.items() if k != "flash_fwd"}
BRANCH_CACHE_KERNELS_PER_CHUNK = {"flash_fwd": 26, "label_logprobs": 2}


def phase_value_branch(card, base):
    """Phase 9's configuration with the value branch: one collection and
    16 steps, then the same with the trunk cache (exact launches, the
    cache on for every rollout); then at f32 (4 layers, split 2, the branch
    tapping at 2) one scoring pass and step with the kernels against the
    plain versions under the plain run's ReLU gates, and the cached step
    against the full one. `base` holds phase 9's numbers."""
    import dataclasses

    import torch

    from trlx_tpu_torch import kernels

    runs, launches = {}, {}
    for tag, method, per_step, per_chunk in (
            ("full", VALUE_BRANCH, BRANCH_KERNELS_PER_STEP, BRANCH_KERNELS_PER_CHUNK),
            ("cached", dict(VALUE_BRANCH, cache_trunk_activations=True), BRANCH_CACHE_KERNELS_PER_STEP,
             BRANCH_CACHE_KERNELS_PER_CHUNK)):
        work = ROOT / "build" / f"chip_smoke_value_branch_{tag}"
        config = ppo_config(work).evolve(train=dict(epochs=1), method=method)
        trainer, launches[tag], runs[tag] = ppo_run(card, f"value-branch-{tag}", work, config, per_step, per_chunk,
                                                    collections=1)
        cached = tag == "cached"
        if (trainer.model.num_value_layers != 2 or trainer._window_loss_ok()
                or trainer._trunk_cache_available() != cached
                or any((e.h_split is None) == cached for e in trainer.store.history)):
            raise AssertionError(f"[value-branch-{tag}] the branch or the trunk cache fell back")
        del trainer
        release()

    config = ppo_config(ROOT / "build" / "chip_smoke_value_branch_f32", dtype="float32", n_layers=4).evolve(
        method=dict(VALUE_BRANCH, trunk_cache_dtype="float32"))
    trainer, batch, tokens, n = ppo_f32_kernels_vs_plain(config)
    h32 = trainer.trunk_cache_fill(tokens)
    kernels.reset_launches()
    loss_c, grads_c, _ = step_grads(trainer, dataclasses.replace(batch, h_split=h32), gates=n["gates_p"])
    cached_launches = dict(kernels.LAUNCHES)
    worst_c = check_grads(grads_c, n["grads_k"])
    rel_c = abs(loss_c - n["loss_k"]) / abs(n["loss_k"])
    if rel_c > CACHE_F32_LOSS_TOL or cached_launches.get("flash_fwd", 0):
        raise AssertionError(f"the value branch's cached step {loss_c} vs full {n['loss_k']}, "
                             f"launches {cached_launches}")
    log(f"[value-branch-f32] gpt2-small width, 4 layers, f32, split 2, a 2-block branch tapping at 2, 32 injected "
        f"rows t {PPO_T}: {n['summary']}; the f32 trunk-cache step: loss {loss_c:.9f} vs full {n['loss_k']:.9f} "
        f"(rel {rel_c:.3g}, tol {CACHE_F32_LOSS_TOL}), grads worst {worst_c:.3g}, launches {cached_launches}")
    del trainer
    release()

    pair = lambda key, fmt: (f"{key} full {fmt(runs['full'][key])}, cached {fmt(runs['cached'][key])} "
                             f"(phase 9: {fmt(base[key])})")
    rnd = lambda xs: [round(x, 4) for x in xs]
    log(f"[value-branch] vs phase 9 in this call ({card}): " + "; ".join([
        pair("samples_per_s", rnd), pair("sampling_s", rnd), pair("step_s", lambda x: f"{x:.4f}"),
        pair("train_tokens_per_s", lambda x: f"{x:.1f}"), f"trunk_fill_ms a chunk {rnd(runs['cached']['trunk_fill_ms'])}"]))
    summary = dict(runs=runs, kernels_per_step={"full": BRANCH_KERNELS_PER_STEP, "cached": BRANCH_CACHE_KERNELS_PER_STEP},
                   kernels_per_chunk={"full": BRANCH_KERNELS_PER_CHUNK, "cached": BRANCH_CACHE_KERNELS_PER_CHUNK},
                   f32_scoring_max_abs_err=n["errs"], f32_loss=[n["loss_k"], n["loss_p"]], f32_grad_worst=n["worst"],
                   f32_cache_loss_rel=rel_c, f32_cache_grad_worst=worst_c)
    return launches, summary


# ---------------------------------------------------------------------------
# Phase 14: ILQL (the fourth main path)
# ---------------------------------------------------------------------------

ILQL_SAMPLES, ILQL_BATCH, ILQL_STEPS, ILQL_SYNC, ILQL_NEW = 1280, 128, 10, 5, 56
# per optimizer step: every block trainable (num_layers_unfrozen=-1), so
# K4-K6 in each of the 12; the ILQL loss's cross-entropies are plain
# log-softmax, as in the JAX package, and sampling runs no flash kernel
ILQL_KERNELS_PER_STEP = {"flash_fwd_lse": 12, "flash_bwd_dq": 12, "flash_bwd_dkv": 12}


def ilql_samples(n=ILQL_SAMPLES, seed=0):
    """Dialogues of a 32-byte prompt and a 32-byte output of printable
    ASCII from a seed, and each output's host reward (`ppo_reward`: its
    share of lowercase letters and spaces)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    text = lambda: "".join(chr(c) for c in rng.randint(32, 127, 32))
    samples = [[text(), text()] for _ in range(n)]
    return samples, ppo_reward(None, None, [o for _, o in samples])


def ilql_config(work, **model_extra):
    """`default_ilql_config` at random:gpt2-small full width (vocab 50257,
    bf16, flash), seq 64, batch 128, every block trainable, a target sync
    every 5 steps, 10 steps; Q-guided sampling held to printable ASCII."""
    from trlx_tpu_torch.data.default_configs import default_ilql_config

    return default_ilql_config().evolve(
        train=dict(seq_length=64, batch_size=ILQL_BATCH, epochs=1, total_steps=ILQL_STEPS, eval_interval=100,
                   checkpoint_interval=100, save_optimizer=False, checkpoint_dir=str(work / "ckpts"),
                   logging_dir=str(work / "logs")),
        model=dict(model_path="random:gpt2-small", num_layers_unfrozen=-1,
                   model_extra_configs={"vocab_size": 50257, "attn_impl": "flash", **model_extra}),
        method=dict(steps_for_target_q_sync=ILQL_SYNC,
                    gen_kwargs=dict(max_new_tokens=ILQL_NEW, top_k=20, beta=1, temperature=1.0,
                                    suppress_tokens=PPO_SUPPRESS)),
    )


@contextmanager
def ilql_probes(record):
    """Wrap ILQLTrainer's optimizer step (wall time, launches, peak device
    memory, the target heads before and after), evaluation and sampling,
    and the Polyak sync (held against alpha * q + (1 - alpha) * target of
    copies taken before it): measurement of this script, the trainer is
    unchanged."""
    import torch

    from trlx_tpu_torch import kernels
    from trlx_tpu_torch.trainer import ilql_trainer
    from trlx_tpu_torch.trainer.ilql_trainer import ILQLTrainer

    targets = lambda model: {n: p.detach().clone() for n, p in model.named_parameters() if "target_q_head" in n}
    step, evaluate, generate, sync = (ILQLTrainer.train_minibatch, ILQLTrainer.evaluate, ILQLTrainer.generate,
                                      ilql_trainer.sync_target_q_heads)

    def probed_step(self, minibatch):
        before_heads = targets(self.model)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        before, t0 = dict(kernels.LAUNCHES), time.perf_counter()
        out = step(self, minibatch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        peak = torch.cuda.max_memory_allocated()
        launched = {k: v - before.get(k, 0) for k, v in kernels.LAUNCHES.items() if v - before.get(k, 0)}
        moved = [n for n, p in targets(self.model).items() if not torch.equal(p, before_heads[n])]
        record.append(("step", t0, t1, launched, peak, moved, held))
        return out

    def probed_sync(heads, alpha):
        pairs = [(getattr(heads, f"q_head_{i}"), getattr(heads, f"target_q_head_{i}")) for i in range(heads.n_qs)]
        want = [[alpha * q + (1.0 - alpha) * t for q, t in zip(qh.parameters(), th.parameters())] for qh, th in pairs]
        sync(heads, alpha)
        exact = all(torch.equal(t, w) for (_, th), ws in zip(pairs, want) for t, w in zip(th.parameters(), ws))
        record.append(("sync", exact))

    def probed_evaluate(self):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = evaluate(self)
        record.append(("evaluate", t0, time.perf_counter()))
        return out

    def probed_generate(self, *args, **kwargs):
        out = generate(self, *args, **kwargs)
        record.append(("generate", int(out["response_mask"].sum()), kwargs.get("mode", "ilql")))
        return out

    try:
        ILQLTrainer.train_minibatch, ILQLTrainer.evaluate, ILQLTrainer.generate = (probed_step, probed_evaluate,
                                                                                    probed_generate)
        ilql_trainer.sync_target_q_heads = probed_sync
        yield
    finally:
        ILQLTrainer.train_minibatch, ILQLTrainer.evaluate, ILQLTrainer.generate = step, evaluate, generate
        ilql_trainer.sync_target_q_heads = sync


def phase_ilql(card):
    """`trlx_tpu_torch.train(samples=..., rewards=...)` with ILQL (the
    fourth main path) under the probes: per-step loss and terms, step time,
    training tokens/s, peak memory and exact launches; the target heads
    moved at every sync, exactly by the Polyak formula, and nowhere else;
    the evaluations' seconds and tokens/s; the `done` checkpoint loads into
    a fresh ILQLTrainer with equal parameters, target heads included. Then
    one f32 step (4 layers, b 32) with the kernels against the plain
    versions under the plain run's ReLU gates."""
    import shutil

    import torch

    import trlx_tpu_torch
    from trlx_tpu_torch import kernels
    from trlx_tpu_torch.trainer.ilql_trainer import ILQLTrainer

    work = ROOT / "build" / "chip_smoke_ilql"
    if work.exists():
        shutil.rmtree(work)
    config = ilql_config(work)
    samples, rewards = ilql_samples()
    eval_prompts = [p for p, _ in samples[:ILQL_BATCH]]
    record = []
    at_start = torch.cuda.memory_allocated()
    log(f"[ilql] {at_start / 1e9:.3f} GB allocated when the phase begins")
    kernels.reset_launches()
    t0 = time.perf_counter()
    with ilql_probes(record):
        trainer = trlx_tpu_torch.train(samples=samples, rewards=rewards, eval_prompts=eval_prompts, config=config)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    rows = [json.loads(line) for line in next((work / "logs").glob("*.metrics.jsonl")).read_text().splitlines()]
    steps = [r for r in rows if "losses/loss" in r]
    kinds = lambda k: [c for c in record if c[0] == k]
    step_calls, syncs, evals, gens = kinds("step"), kinds("sync"), kinds("evaluate"), kinds("generate")
    terms = ("loss", "loss_q", "loss_v", "loss_cql", "loss_awac")
    for r, c in zip(steps, step_calls):
        log(f"[ilql] step {r['_step']}: " + " ".join(f"{k}={r[f'losses/{k}']:.6f}" for k in terms)
            + f" step_s={r['time/train_step_s']:.4f} train_tokens_per_s={r['throughput/train_tokens_per_s']:.1f} "
            f"peak_mem_gb={c[4] / 1e9:.3f} (held before the step {c[6] / 1e9:.3f}) target heads moved: {bool(c[5])}")
    eval_tokens = [g[1] for g in gens]
    eval_s = [e[2] - e[1] for e in evals]
    for s_, n in zip(eval_s, eval_tokens):
        log(f"[ilql] evaluation: {ILQL_BATCH} prompts x {ILQL_NEW} Q-guided tokens (beta 1, top_k 20): {s_:.3f} s, "
            f"{n} tokens, {n / s_:.1f} tokens/s")
    steady = steps[1:]  # step 1 pays the first-call warm-up
    peak = max(c[4] for c in step_calls)
    step_peak = max(c[4] - c[6] for c in step_calls)  # above what was allocated when the step began
    metrics = dict(wall_s=wall, step_s=statistics.median(r["time/train_step_s"] for r in steady),
                   train_tokens_per_s=statistics.median(r["throughput/train_tokens_per_s"] for r in steady),
                   losses=[r["losses/loss"] for r in steps], eval_s=eval_s, eval_tokens=eval_tokens,
                   eval_tokens_per_s=[n / s_ for n, s_ in zip(eval_tokens, eval_s)], peak_step_memory_bytes=peak,
                   step_memory_above_held_bytes=step_peak, allocated_at_phase_start_bytes=at_start)
    log(f"[ilql] gpt2-small ILQL, {ILQL_SAMPLES} dialogues (32 + 32 bytes), seq 64, batch {ILQL_BATCH}, bf16 flash, "
        f"all 12 blocks trainable, target sync every {ILQL_SYNC} steps: {len(steps)} steps in {wall:.2f}s wall "
        f"(two evaluations and the checkpoint included); median step_s={metrics['step_s']:.4f} "
        f"train_tokens_per_s={metrics['train_tokens_per_s']:.1f}; peak device memory of a step "
        f"{peak / 1e9:.3f} GB, {step_peak / 1e9:.3f} GB above what was allocated when it began; "
        f"launches={launches} ({card})")

    losses = [r[f"losses/{k}"] for r in steps for k in terms]
    if len(steps) != ILQL_STEPS or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"expected {ILQL_STEPS} steps of finite losses, got {len(steps)}: {losses}")
    for c in step_calls:
        if c[3] != ILQL_KERNELS_PER_STEP:
            raise AssertionError(f"an ILQL step launched {c[3]}, expected {ILQL_KERNELS_PER_STEP}")
    want = {n: ILQL_STEPS * v for n, v in ILQL_KERNELS_PER_STEP.items()}
    if {n: launches.get(n, 0) for n in want} != want or any(v for k, v in launches.items() if k not in want):
        raise AssertionError(f"ILQL launches {launches} != {want}")
    synced = [bool(c[5]) for c in step_calls]
    if synced != [(i + 1) % ILQL_SYNC == 0 for i in range(ILQL_STEPS)] or not all(s[1] for s in syncs) \
            or len(syncs) != ILQL_STEPS // ILQL_SYNC:
        raise AssertionError(f"target heads moved at steps {synced}, syncs exact {[s[1] for s in syncs]}")
    if len(evals) != 2 or any(g[2] != "ilql" for g in gens) or min(eval_tokens) != ILQL_BATCH * ILQL_NEW:
        raise AssertionError(f"evaluations {len(evals)}, sampling {gens}")
    directory = work / "ckpts" / f"checkpoint_{ILQL_STEPS}"
    fresh = ILQLTrainer(config)
    fresh.load(str(directory))
    if fresh.iter_count != ILQL_STEPS or not all(
            torch.equal(a, b) for a, b in zip(trainer.model.state_dict().values(), fresh.model.state_dict().values())):
        raise AssertionError("the ILQL done checkpoint did not load back with the same parameters")
    log(f"[ilql] checkpoint {directory.name} loads into a fresh ILQLTrainer: parameters equal, target heads "
        f"included; the target heads moved at steps {[i + 1 for i, s in enumerate(synced) if s]} only, each "
        f"sync exactly alpha * q + (1 - alpha) * target")
    del trainer, fresh
    release()

    config = ilql_config(ROOT / "build" / "chip_smoke_ilql_f32", dtype="float32", n_layers=4)
    trainer = ILQLTrainer(config)
    trainer.make_experience(samples[:32], rewards[:32], 64)
    batch = next(iter(trainer.store.create_loader(32, shuffle=False)))
    with plain_versions():
        loss_p, grads_p, gates_p = step_grads(trainer, batch)
    kernels.reset_launches()
    loss_k, grads_k, gates_k = step_grads(trainer, batch, gates=gates_p)
    launched = dict(kernels.LAUNCHES)
    worst = check_grads(grads_k, grads_p)
    if not abs(loss_k - loss_p) <= 1e-5 * abs(loss_p):
        raise AssertionError(f"f32 ILQL loss kernels {loss_k} vs plain {loss_p}")
    flips, entries = gate_flips(gates_k, gates_p)
    log(f"[ilql-f32] gpt2-small width, 4 layers, f32, b 32 t 64: loss kernels={loss_k:.7f} plain={loss_p:.7f}; "
        f"{len(grads_k)} trainable grads, worst max|diff|/max|g| = {worst:.3g} (tol {GRAD_TOL}; the plain run's "
        f"ReLU gates, {flips} of {entries} entries differ from the kernel run's own); kernel launches {launched}")
    del trainer
    release()
    metrics.update(f32_loss=[loss_k, loss_p], f32_grad_worst=worst)
    return launches, metrics


# ---------------------------------------------------------------------------
# Phase 15: GRPO and RLOO (the fifth main path)
# ---------------------------------------------------------------------------

# `default_grpo_config` at phase 9's configuration: 16 prompts x G 8 a
# 128-row chunk. The critic-free policy drops only the value head's MLP, so
# a step and a scoring chunk launch phase 9's kernels: a step K3 x10,
# K4-K6 x2, K7 and its backward over the window; a chunk K3 x14 (12 policy
# blocks, the reference's 2), K7 x2 (the policy's and the reference's)
GRPO_GROUP = 8
GRPO_KERNELS_PER_STEP = PPO_KERNELS_PER_STEP
GRPO_KERNELS_PER_CHUNK = PPO_KERNELS_PER_CHUNK
GROUP_SUM_TOL = 1e-5


def check_groups(trainer, tag):
    """Every stored rollout is one of G adjacent rows of its prompt group,
    its rewards slot the group's advantage on every token (init_kl_coef
    0), and each group's advantages sum to 0 within GROUP_SUM_TOL. Returns
    the largest |sum| and the share of groups that are not degenerate."""
    import numpy as np

    history = trainer.store.history
    ids = [e.group_id for e in history]
    queries = [tuple(e.query_tensor) for e in history]
    adv = np.array([e.rewards[0] for e in history], np.float64)
    if any(not np.all(e.rewards == e.rewards[0]) for e in history):
        raise AssertionError(f"[{tag}] a rollout's advantage is not the same on every token")
    # the f32 mean's rounding, divided by a narrow group's std, is what is
    # left of the sum: about 1e-6 at these rewards' spread
    worst, live = 0.0, 0
    for g in range(0, len(history), GRPO_GROUP):
        if len(set(ids[g:g + GRPO_GROUP])) != 1 or len(set(queries[g:g + GRPO_GROUP])) != 1:
            raise AssertionError(f"[{tag}] rows {g}..{g + GRPO_GROUP - 1} are not one prompt group")
        worst = max(worst, abs(float(adv[g:g + GRPO_GROUP].sum())))
        live += int(np.abs(adv[g:g + GRPO_GROUP]).max() > 0)
    if worst > GROUP_SUM_TOL or not live:
        raise AssertionError(f"[{tag}] group advantages sum to {worst} (tol {GROUP_SUM_TOL}); {live} live groups")
    return worst, live / (len(history) // GRPO_GROUP)


def phase_grpo(card, base):
    """GRPO through `trlx_tpu_torch.train(reward_fn=...)` at phase 9's
    configuration with `default_grpo_config` (2 collections, 32 steps),
    then one collection under RLOO; exact launches, no value parameters,
    the groups' advantages; then one f32 scoring pass and step (4 layers)
    with the kernels against the plain versions (no MLP head, so every
    gradient element is held with no gate replay). `base` holds phase 9's
    numbers."""
    from trlx_tpu_torch.data.default_configs import default_grpo_config
    from trlx_tpu_torch.trainer.grpo_trainer import GRPOTrainer

    runs, launches, groups = {}, {}, {}
    for tag, mode, collections in (("grpo", "grpo", PPO_EPOCHS), ("rloo", "rloo", 1)):
        work = ROOT / "build" / f"chip_smoke_{tag}"
        config = ppo_config(work, default_grpo_config).evolve(train=dict(epochs=collections),
                                                              method=dict(advantage_mode=mode))
        trainer, launches[tag], runs[tag] = ppo_run(card, tag, work, config, GRPO_KERNELS_PER_STEP,
                                                    GRPO_KERNELS_PER_CHUNK, collections=collections)
        value_keys = [k for k in trainer.model.state_dict() if "v_head" in k or "value" in k]
        if not isinstance(trainer, GRPOTrainer) or value_keys or trainer.config.method.group_size != GRPO_GROUP:
            raise AssertionError(f"[{tag}] not a critic-free GRPOTrainer of G {GRPO_GROUP}: {value_keys}")
        groups[tag] = check_groups(trainer, tag)
        log(f"[{tag}] {len(trainer.store)} rollouts in {len(trainer.store) // GRPO_GROUP} groups of {GRPO_GROUP}: "
            f"max |sum of a group's advantages| {groups[tag][0]:.3g} (tol {GROUP_SUM_TOL}), share of groups with "
            f"a nonzero advantage {groups[tag][1]:.3f}; state dict holds no value-head key")
        del trainer
        release()

    config = ppo_config(ROOT / "build" / "chip_smoke_grpo_f32", default_grpo_config, dtype="float32", n_layers=4)
    trainer, _, _, n = ppo_f32_kernels_vs_plain(config)
    if n["gates_p"]:
        raise AssertionError(f"the critic-free policy ran MLP heads: {list(n['gates_p'])}")
    log(f"[grpo-f32] gpt2-small width, 4 layers, f32, split 2, 32 injected rows t {PPO_T} (values slot: the "
        f"reference's logprobs): {n['summary']}")
    del trainer
    release()

    pair = lambda key, fmt: (f"{key} grpo {fmt(runs['grpo'][key])}, rloo {fmt(runs['rloo'][key])} "
                             f"(phase 9: {fmt(base[key])})")
    rnd = lambda xs: [round(x, 4) for x in xs]
    log(f"[grpo] vs phase 9 in this call ({card}): " + "; ".join([
        pair("samples_per_s", rnd), pair("sampling_s", rnd), pair("scoring_s", rnd),
        pair("step_s", lambda x: f"{x:.4f}"), pair("train_tokens_per_s", lambda x: f"{x:.1f}")]))
    summary = dict(runs=runs, kernels_per_step=GRPO_KERNELS_PER_STEP, kernels_per_chunk=GRPO_KERNELS_PER_CHUNK,
                   group_size=GRPO_GROUP, group_sum_max={t: g[0] for t, g in groups.items()},
                   live_group_share={t: g[1] for t, g in groups.items()}, f32_scoring_max_abs_err=n["errs"],
                   f32_loss=[n["loss_k"], n["loss_p"]], f32_grad_worst=n["worst"])
    return launches, summary


# ---------------------------------------------------------------------------
# Phase 16: loading by path, then RFT (the sixth main path)
# ---------------------------------------------------------------------------

# `default_rft_config` cut to size: n_generations_per_prompt 32 -> 4, one
# prompt batch of 8 (64-byte prompts, 40 sampled printable tokens), 2
# epochs (the growth step's sampling, then two selections trained on). A
# step: every block trainable (num_layers_unfrozen=-1), so K4-K6 x12, no
# K3, and K7 and its backward over the rows of prompt and output
RFT_GENERATIONS, RFT_PROMPTS, RFT_EPOCHS = 4, 8, 2
RFT_KERNELS_PER_STEP = {"flash_fwd_lse": 12, "flash_bwd_dq": 12, "flash_bwd_dkv": 12, "label_logprobs": 1,
                        "label_logprobs_bwd": 1}
RFT_F32_PER_STEP = {"flash_fwd_lse": 4, "flash_bwd_dq": 4, "flash_bwd_dkv": 4, "label_logprobs": 1,
                    "label_logprobs_bwd": 1}


def rft_config(work, model_path, **model_extra):
    from trlx_tpu_torch.data.default_configs import default_rft_config

    return default_rft_config().evolve(
        train=dict(seq_length=1024, batch_size=RFT_PROMPTS, epochs=RFT_EPOCHS, eval_interval=10000,
                   checkpoint_dir=str(work / "ckpts"), logging_dir=str(work / "logs")),
        model=dict(model_path=model_path, model_extra_configs={"attn_impl": "flash", **model_extra}),
        method=dict(n_generations_per_prompt=RFT_GENERATIONS,
                    gen_kwargs=dict(max_new_tokens=PPO_NEW, top_k=0, top_p=1.0, do_sample=True,
                                    suppress_tokens=PPO_SUPPRESS)),
    )


def phase_rft(card):
    """A gpt2-small SFT trainer's `save_pretrained` export loaded back by
    `model_path`: its logits bitwise the exporter's on the card. Then
    `trlx_tpu_torch.train(reward_fn=..., config=default_rft_config())` from
    that directory (cut as RFT_* says): exact launches a step, the
    selection, generation seconds, step ms, training tokens/s. Then one f32
    step (4 layers, random weights) with the kernels vs the plain
    versions."""
    import shutil

    import numpy as np
    import torch

    import trlx_tpu_torch
    from trlx_tpu_torch import kernels
    from trlx_tpu_torch.data.configs import ModelConfig
    from trlx_tpu_torch.models import build_model
    from trlx_tpu_torch.trainer.rft_trainer import RFTTrainer
    from trlx_tpu_torch.trainer.sft_trainer import SFTTrainer

    work = ROOT / "build" / "chip_smoke_rft"
    if work.exists():
        shutil.rmtree(work)
    exporter = SFTTrainer(training_config(work / "exporter"))
    export = work / "hf_model"
    exporter.save_pretrained(str(export))
    loaded, cfg, _ = build_model(ModelConfig(model_path=str(export), model_extra_configs={"attn_impl": "flash"}),
                                 0, seed=exporter.config.train.seed, device=exporter.device)
    batch = ppo_injected_batch(RFT_PROMPTS)
    tokens = torch.from_numpy(np.concatenate([batch.query_tensors, batch.response_tensors], 1)).long()
    tokens = tokens.to(exporter.device)
    mask = (tokens != exporter.tokenizer.pad_token_id).long()
    with torch.no_grad():
        want, got = exporter.model(tokens, mask)[0], loaded(tokens, mask)[0]
    same_params = all(torch.equal(w, loaded.state_dict()[k]) for k, w in exporter.model.state_dict().items())
    if not (torch.equal(got, want) and same_params and cfg.hf_family == "gpt2" and cfg.vocab_size == 50257):
        raise AssertionError(f"the export at {export} did not load back bitwise (params equal: {same_params})")
    log(f"[rft] gpt2-small export ({sorted(p.name for p in export.iterdir())}) loaded by model_path: every "
        f"parameter and the bf16 logits [{RFT_PROMPTS}, {PPO_T}, 50257] bitwise equal to the exporter's")
    del exporter, loaded, want, got
    release()

    config = rft_config(work, str(export))
    record = []
    kernels.reset_launches()
    t0 = time.perf_counter()
    with ppo_probes(record, RFTTrainer, ("make_experience", "evaluate", "train_minibatch")):
        trainer = trlx_tpu_torch.train(reward_fn=ppo_reward, prompts=ppo_prompts(RFT_PROMPTS), config=config)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    rows = [json.loads(line) for line in next((work / "logs").glob("*.metrics.jsonl")).read_text().splitlines()]
    steps = [r for r in rows if "time/train_step_s" in r]
    selected = [int(r["rft/len_samples_selected"]) for r in rows if "rft/len_samples_selected" in r]
    growth = [c for c in record if c[0] == "make_experience"]
    step_calls = [c for c in record if c[0] == "train_minibatch"]
    for c in step_calls:
        if c[3] != RFT_KERNELS_PER_STEP:
            raise AssertionError(f"[rft] a step launched {c[3]}, expected {RFT_KERNELS_PER_STEP}")
    want_total = {k: v * len(step_calls) for k, v in RFT_KERNELS_PER_STEP.items()}
    if launches != want_total or not steps or len(steps) != len(step_calls):
        raise AssertionError(f"[rft] launches {launches} != {want_total} over {len(step_calls)} steps")
    if not isinstance(trainer, RFTTrainer) or len(growth) != RFT_EPOCHS + 1 or not all(selected):
        raise AssertionError(f"[rft] {len(growth)} growth steps, selected {selected}")
    lengths = sorted({len(p["input_ids"]) for p in trainer.store.prompts})
    losses = [r["loss"] for r in steps]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"[rft] losses {losses}")
    generations = len(trainer.generations_per_prompt) * RFT_GENERATIONS
    # step 1 pays the first-call warm-up; an epoch's last batch may hold
    # fewer rows, so the rate is the steady steps' tokens over their time
    steady = steps[1:] or steps
    step_s = [r["time/train_step_s"] for r in steady]
    steady_tokens = sum(r["throughput/train_tokens_per_s"] * r["time/train_step_s"] for r in steady)
    metrics = dict(wall_s=wall, generation_s=growth[0][2] - growth[0][1], samples_selected=selected,
                   steps=len(steps), row_tokens=lengths, step_s=statistics.median(step_s),
                   train_tokens_per_s=steady_tokens / sum(step_s))
    for r in steps:
        log(f"[rft] step {r['_step']}: loss={r['loss']:.6f} step_s={r['time/train_step_s']:.4f} "
            f"train_tokens_per_s={r['throughput/train_tokens_per_s']:.1f}")
    log(f"[rft] gpt2-small RFT from the export, {RFT_PROMPTS} prompts x {RFT_GENERATIONS} generations of {PPO_NEW} "
        f"tokens ({generations} scored), batch {RFT_PROMPTS}, bf16 flash, every block trainable: growth step's "
        f"generation_s={metrics['generation_s']:.4f}; samples selected by growth step {selected} (rows of "
        f"{lengths} tokens); {len(steps)} steps, median step_s={metrics['step_s']:.4f} "
        f"train_tokens_per_s={metrics['train_tokens_per_s']:.1f}; {wall:.2f}s wall; launches={launches} ({card})")
    del trainer
    release()

    f32 = rft_config(work / "f32", "random:gpt2-small", dtype="float32", n_layers=4, vocab_size=50257)
    trainer = RFTTrainer(f32, reward_fn=ppo_reward)
    ids = tokens.cpu().numpy()
    step_batch = {"input_ids": ids, "attention_mask": (ids != trainer.tokenizer.pad_token_id).astype(np.int32)}
    with plain_versions():
        loss_p, grads_p, _ = step_grads(trainer, step_batch)
    kernels.reset_launches()
    loss_k, grads_k, _ = step_grads(trainer, step_batch)
    f32_launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    worst = check_grads(grads_k, grads_p)
    if not abs(loss_k - loss_p) <= 1e-5 * abs(loss_p) or f32_launches != RFT_F32_PER_STEP:
        raise AssertionError(f"f32 RFT loss kernels {loss_k} vs plain {loss_p}; launches {f32_launches}")
    log(f"[rft-f32] gpt2-small width, 4 layers, f32, every block trainable, {RFT_PROMPTS} rows t {PPO_T}: loss "
        f"kernels={loss_k:.7f} plain={loss_p:.7f}; {len(grads_k)} trainable grads, every element held, worst "
        f"max|diff|/max|g| = {worst:.3g} (tol {GRAD_TOL}); launches {f32_launches}")
    del trainer
    release()
    return launches, dict(metrics, kernels_per_step=RFT_KERNELS_PER_STEP, f32_loss=[loss_k, loss_p],
                          f32_grad_worst=worst, cut=dict(n_generations_per_prompt=RFT_GENERATIONS,
                                                         prompts=RFT_PROMPTS, epochs=RFT_EPOCHS))


def build_report(ptxas_out):
    """One line per compiled kernel from `nvcc -Xptxas -v`: its name and
    template arguments (float, head dim, lse), registers and spills; and every
    warning (a wgmma serialized by ptxas says so in one)."""
    import re

    lines, kernel, spill = [], None, ""
    for line in ptxas_out.splitlines():
        entry = re.search(r"Compiling entry function '.*?([a-z_]+_kernel)I(\w*?)EEv", line)
        if entry:
            args = re.sub(r"L[ib]", "", entry.group(2)).replace("E", ",").rstrip(",")
            kernel = f"{entry.group(1)}<{args.replace('f', 'float,')}>"
        elif "spill" in line:
            spill = line.split(",", 1)[-1].strip()
        elif "registers" in line and kernel:
            lines.append(f"{kernel}: {line.split(':', 1)[-1].strip()}; {spill}")
            kernel = None
        elif "arning" in line:
            lines.append(line.strip())
    return lines


# ---------------------------------------------------------------------------
# Phase 17: the single-replica serving surface (the seventh main path)
# ---------------------------------------------------------------------------

SPEC_K, SPEC_SPLIT = 4, 10  # the engine's speculative decode: 4 drafts a round, trunk = 10 of 12 blocks
SPEC_RANK = 64
GREEDY_NEW = 16
# a four-turn conversation: each turn's new tokens, then a 16-token reply
CHAT_TURNS = (100, 20, 30, 40)
CHAT_NEW = 16
RELOAD_WAIT_S = 120.0


def greedy_serving_config(**inference):
    return serving_config(gen_kwargs=dict(max_new_tokens=64, do_sample=False), **inference)


def f32_serving_config(**inference):
    return greedy_serving_config(**inference).evolve(
        model=dict(model_extra_configs={"vocab_size": 50257, "dtype": "float32"}))


def engine_like(server_engine, trainer, **kw):
    """A fresh engine with the server engine's shapes and sampling on
    `trainer`'s weights."""
    from trlx_tpu_torch.inference import InferenceEngine

    e = server_engine
    return InferenceEngine(trainer.model, trainer.model_cfg, None, e.gen_cfg, num_slots=e.num_slots,
                           max_prompt_len=e.max_prompt_len, max_prefill_batch=e.max_prefill_batch,
                           prompt_bucket=e.prompt_bucket, kv_paging=e.kv_paging, kv_block_size=e.kv_block_size,
                           decode_kernel=e.decode_kernel, **kw)


def serial_with_gaps(engine, prompts, max_new):
    """`run_serial` of a plain engine, also returning for each request the
    top-two gap of the warped scores each of its tokens was drawn from
    (the insert's for token 0, the decode steps' after it)."""
    import torch

    import trlx_tpu_torch.inference.engine as engine_module

    process, calls = engine_module.process_logits, []

    def recording(scores, cfg, step, *args):
        out = process(scores, cfg, step, *args)
        top = torch.topk(out[:1], 2, dim=-1).values  # row 0: the one prompt row, or slot 0
        calls.append(float(top[0, 0] - top[0, 1]))
        return out

    engine_module.process_logits = recording  # read at call time by the engine's sampling
    try:
        outs = run_serial(engine, prompts, max_new)
    finally:
        engine_module.process_logits = process
    gaps, i = [], 0
    for toks in outs:
        gaps.append(calls[i:i + 1 + len(toks)])
        i += 1 + len(toks)
    return outs, gaps


def timed_batch(engine, prompts, max_new):
    """All prompts in their own slots at once, stepped to the end: (tokens
    emitted, seconds, decode dispatches)."""
    import numpy as np
    import torch

    slots = list(range(len(prompts)))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.insert_requests([(np.asarray(p, np.int32), max_new) for p in prompts], slots)
    tokens, steps, done = 0, 0, np.zeros(len(slots), bool)
    while not done.all():
        _, _, v, f = engine.step()
        tokens += int(v.reshape(len(v), -1)[slots].sum())
        done |= f[slots]
        steps += 1
    wall = time.perf_counter() - t0
    engine.reclaim_slots(slots)
    return tokens, wall, steps


def phase_fixed_slot_greedy(trainer):
    """(a) at f32: the fixed-slot pool's greedy streams against the paged
    engine's with the kernel, on phase 5's prompts."""
    from trlx_tpu_torch.inference import InferenceEngine
    from trlx_tpu_torch.ops.sampling import GenerationConfig

    gen = GenerationConfig(max_new_tokens=GREEDY_NEW, do_sample=False, eos_token_id=10**6,
                           pad_token_id=trainer.tokenizer.pad_token_id)

    def engine(paged):
        return InferenceEngine(trainer.model, trainer.model_cfg, None, gen, num_slots=8, max_prompt_len=256,
                               kv_paging=paged, kv_block_size=32, decode_kernel="auto")

    prompts = greedy_prompts()
    fixed, paged = run_serial(engine(False), prompts, GREEDY_NEW), run_serial(engine(True), prompts, GREEDY_NEW)
    same = sum(a == b for a, b in zip(fixed, paged))
    log(f"[serving] (a) f32 greedy: {same}/{len(prompts)} streams equal, fixed-slot pool vs paged kernel")
    if same != len(prompts):
        raise AssertionError(f"fixed-slot {fixed} vs paged {paged}")
    return same


def phase_spec_engine(trainer, card):
    """(e) the engine's speculative decode at f32 against the plain
    engine: greedy equal under the tie rule, K1 launches exact; once at
    phase 17's split, whose rank-64 draft the random weights reject, and
    once drafting through every block with the full-rank readout, whose
    drafts the target accepts (tokens a request a dispatch above 1); then
    tokens/s of the plain engine and phase 17's split on one batch of 8
    requests. Returns ({config: launches}, numbers)."""
    import numpy as np

    from trlx_tpu_torch import kernels
    from trlx_tpu_torch.inference import InferenceEngine
    from trlx_tpu_torch.ops.sampling import GenerationConfig

    gen = GenerationConfig(max_new_tokens=64, do_sample=False, eos_token_id=10**6,
                           pad_token_id=trainer.tokenizer.pad_token_id)
    cfg = trainer.model_cfg

    def engine(**kw):
        return InferenceEngine(trainer.model, cfg, None, gen, num_slots=8, max_prompt_len=256,
                               kv_paging=True, kv_block_size=32, decode_kernel="auto", **kw)

    prompts = greedy_prompts()
    plain, gaps = serial_with_gaps(engine(), prompts, GREEDY_NEW)
    launches, checks, spec_engine = {}, {}, None
    for name, split, rank in (("split", SPEC_SPLIT, SPEC_RANK), ("accepting", cfg.n_layers, cfg.d_model)):
        eng = engine(spec_k=SPEC_K, spec_split=split, spec_draft_rank=rank)
        kernels.reset_launches()
        spec = run_serial(eng, prompts, GREEDY_NEW)
        got = dict(kernels.LAUNCHES)
        stats = eng.kv_stats()
        dispatches = stats["kv_kernel_dispatches"]
        differ = []
        for r, (a, b) in enumerate(zip(plain, spec)):
            if a != b:
                d = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))
                differ.append((r, d, gaps[r][d] if d < len(gaps[r]) else None))
        per_dispatch = (SPEC_K + 1) * split
        # every token is emitted by a dispatch (the insert only samples the
        # first), and the requests run one at a time here
        per_request = sum(len(t) for t in spec) / dispatches
        log(f"[serving] (e) spec engine (spec_k {SPEC_K}, split {split} of {cfg.n_layers}, draft rank {rank}) vs "
            f"plain, f32 greedy, {len(prompts)} requests x {GREEDY_NEW} tokens: {len(prompts) - len(differ)} equal; "
            f"differ (request, first position, plain top-two gap) {differ} (tie rule: gap <= {TIE_GAP}); "
            f"{dispatches} dispatches, {per_request:.3f} tokens a request a dispatch, launches {got}, "
            f"fallbacks {stats['kv_kernel_fallbacks']}")
        if any(g is None or g > TIE_GAP for _, _, g in differ):
            raise AssertionError(f"greedy speculative engine left the plain engine away from a tie: {differ}")
        if dispatches <= 0 or stats["kv_kernel_fallbacks"] != {"spec_verify_rows": dispatches}:
            raise AssertionError(f"spec engine accounting {stats}")
        if got.get("paged_decode", 0) != dispatches * per_dispatch:
            raise AssertionError(f"paged_decode launches {got} != {dispatches} dispatches x {per_dispatch}")
        if name == "accepting" and per_request <= 1.5:
            raise AssertionError(f"full-depth drafts were not accepted: {per_request} tokens a dispatch")
        launches[name] = got
        checks[name] = dict(split=split, draft_rank=rank, equal=len(prompts) - len(differ), differ=differ,
                            dispatches=dispatches, launches_per_dispatch=per_dispatch,
                            tokens_per_dispatch_per_request=per_request)
        if name == "split":
            spec_engine = eng
    # tokens/s: one batch of 8 requests x 64 tokens, each engine warmed by one run first
    rng = np.random.RandomState(5)
    batch = [rng.randint(0, 256, n).tolist() for n in (17, 48, 96, 128, 63, 65, 200, 250)]
    rates = {}
    for name, eng in (("plain", engine()), ("spec", spec_engine)):
        timed_batch(eng, batch, 64)
        tokens, wall, steps = timed_batch(eng, batch, 64)
        rates[name] = dict(tokens=tokens, wall_s=wall, tokens_per_s=tokens / wall, dispatches=steps,
                           tokens_per_dispatch_per_request=tokens / steps / len(batch))
    log(f"[serving] (e) one batch of 8 requests x 64 tokens at f32: plain {rates['plain']['tokens_per_s']:.1f} "
        f"tokens/s ({rates['plain']['dispatches']} dispatches), speculative {rates['spec']['tokens_per_s']:.1f} "
        f"tokens/s ({rates['spec']['dispatches']} dispatches, "
        f"{rates['spec']['tokens_per_dispatch_per_request']:.3f} tokens a request a dispatch) ({card})")
    return launches, dict(checks, requests=len(prompts), rates=rates)


def phase_reload(card, work):
    """(b) hot-reload from a training run and /admin/*, (c) SSE, on a
    bf16 paged server watching the run's checkpoint directory."""
    import shutil

    import torch

    import trlx_tpu_torch
    from trlx_tpu_torch.inference import sse_stream
    from trlx_tpu_torch.trainer.sft_trainer import SFTTrainer

    watch = work / "watch"
    trainer = SFTTrainer(greedy_serving_config(reload_interval_s=0.5))
    server = trainer.serve(port=0, background=True, watch_dir=str(watch))
    out = {}
    try:
        code, health = http(server.url, "/healthz")
        if code != 200 or health["checkpoint_step"] is not None:
            raise AssertionError(f"/healthz before the run: {code} {health}")
        steps = 2
        sft_config = training_config(work).evolve(train=dict(
            seq_length=128, batch_size=4, total_steps=steps, checkpoint_dir=str(watch),
            logging_dir=str(work / "logs")))
        t0 = time.perf_counter()
        sft = trlx_tpu_torch.train(samples=sft_samples(), config=sft_config)
        torch.cuda.synchronize()
        t_trained = time.perf_counter()
        while time.perf_counter() - t_trained < RELOAD_WAIT_S:
            health = http(server.url, "/healthz")[1]
            if health["checkpoint_step"] == steps:
                break
            time.sleep(0.25)
        seen = time.perf_counter() - t_trained
        log(f"[serving] (b) SFT run of {steps} steps in {t_trained - t0:.2f}s; /healthz checkpoint_step "
            f"{health['checkpoint_step']} after {seen:.2f}s (watcher poll 0.5 s), reloads {health['reloads']}, "
            f"param_version {health['param_version']}")
        if health["checkpoint_step"] != steps or health["reloads"] != 1 or not health["ready"]:
            raise AssertionError(f"the watcher did not serve the run's checkpoint: {health}")
        prompt = greedy_prompts()[-1]
        code, reply = http(server.url, "/generate", {"prompt_ids": prompt, "max_new_tokens": 32})
        fresh = run_serial(engine_like(server.engine, sft), [prompt], 32)[0]
        log(f"[serving] (b) greedy reply after the reload equals a fresh engine's on the run's weights: "
            f"{reply['token_ids'] == fresh} (checkpoint_step {reply['checkpoint_step']})")
        if code != 200 or reply["token_ids"] != fresh or reply["checkpoint_step"] != steps:
            raise AssertionError(f"after the reload: {code} {reply} vs fresh {fresh}")
        del sft
        # /admin/drain answers 503 until /admin/undrain
        drained = http(server.url, "/admin/drain", {})
        refused = http(server.url, "/generate", {"prompt_ids": prompt, "max_new_tokens": 4})
        not_ready = not http(server.url, "/healthz")[1]["ready"]
        undrained = http(server.url, "/admin/undrain", {})
        again = http(server.url, "/generate", {"prompt_ids": prompt, "max_new_tokens": 4})
        log(f"[serving] (b) /admin/drain {drained[0]}, /generate while draining {refused[0]}, ready off "
            f"{not_ready}, /admin/undrain {undrained[0]}, /generate after {again[0]}")
        if (drained[0], refused[0], undrained[0], again[0]) != (200, 503, 200, 200) or not not_ready:
            raise AssertionError("drain/undrain")
        # (c) SSE deltas against the non-streaming reply
        payload = {"prompt_ids": greedy_prompts()[2], "max_new_tokens": 48}
        events = list(sse_stream(server.url + "/generate", payload, timeout=300))
        streamed = [t for e in events[:-1] for t in e["token_ids"]]
        plain = http(server.url, "/generate", payload)[1]["token_ids"]
        log(f"[serving] (c) SSE: {len(events) - 1} delta events, {len(streamed)} tokens, equal to the "
            f"non-streaming reply: {streamed == plain == events[-1]['token_ids']}")
        if not (streamed == plain == events[-1]["token_ids"]) or events[-1].get("event") != "done":
            raise AssertionError(f"SSE {streamed} vs {plain}")
        out = dict(reload_seen_s=seen, train_s=t_trained - t0, checkpoint_step=steps, sse_events=len(events) - 1)
    finally:
        server.shutdown()
        shutil.rmtree(watch, ignore_errors=True)
    del trainer, server
    release()
    return out


def chat(url, turns, rng):
    """Four /chat turns of fresh random tokens; returns the replies and
    the whole transcript before each turn's reply."""
    replies, transcripts, history, sid = [], [], [], None
    for n in turns:
        turn = rng.randint(0, 256, n).tolist()
        code, out = http(url, "/chat", {"prompt_ids": turn, "max_new_tokens": CHAT_NEW,
                                        **({"session_id": sid} if sid else {})})
        if code != 200:
            raise AssertionError(f"/chat answered {code}: {out}")
        sid = out["session_id"]
        history += turn
        transcripts.append(list(history))
        history += out["token_ids"]
        replies.append(out)
    return replies, transcripts


def phase_chat(card):
    """(d) four-turn /chat over bf16 and int8 arenas (launches, reuse,
    TTFT), then at f32 every turn against /generate over the transcript."""
    import numpy as np

    from trlx_tpu_torch import kernels
    from trlx_tpu_torch.trainer.sft_trainer import SFTTrainer

    launches, out = {}, {}
    for kv, counter in (("auto", "paged_decode"), ("int8", "paged_decode_int8")):
        trainer = SFTTrainer(greedy_serving_config(kv_cache_dtype=kv, sessions=True))
        n_layers = trainer.model_cfg.n_layers
        server = trainer.serve(port=0, background=True)
        try:
            http(server.url, "/chat", {"prompt_ids": [1, 2, 3], "max_new_tokens": 2})  # warm-up
            d0 = server.engine.kv_stats()["kv_kernel_dispatches"]
            kernels.reset_launches()
            replies, transcripts = chat(server.url, CHAT_TURNS, np.random.RandomState(7))
            got = dict(kernels.LAUNCHES)
            dispatches = server.engine.kv_stats()["kv_kernel_dispatches"] - d0
            fresh = http(server.url, "/generate", {
                "prompt_ids": np.random.RandomState(8).randint(0, 256, len(transcripts[-1])).tolist(),
                "max_new_tokens": CHAT_NEW})[1]
        finally:
            server.shutdown()
        reused = [r["retained_blocks"] for r in replies]
        prefill = [r["prefill_tokens"] for r in replies]
        ttft = [r["ttft_s"] for r in replies]
        log(f"[serving] (d) /chat kv={kv}: {len(replies)} turns, retained blocks reused {reused}, prefill tokens "
            f"{prefill} of transcripts {[len(t) for t in transcripts]}; TTFT by turn {[round(x, 4) for x in ttft]} "
            f"s, a fresh prompt of turn 4's length {fresh['ttft_s']:.4f} s; {dispatches} decode dispatches, "
            f"launches {got} ({card})")
        if got.get(counter, 0) != dispatches * n_layers or dispatches <= 0:
            raise AssertionError(f"{counter} launches {got} != {dispatches} dispatches x {n_layers}")
        if not all(r > 0 for r in reused[1:]) or not all(r["retained_hit"] for r in replies[1:]):
            raise AssertionError(f"retained blocks not reused: {reused}")
        launches[f"chat_{kv}"] = got
        out[kv] = dict(retained_blocks=reused, prefill_tokens=prefill, transcript_tokens=[len(t) for t in transcripts],
                       ttft_s=ttft, fresh_ttft_s=fresh["ttft_s"], dispatches=dispatches)
        del trainer, server
        release()
    return launches, out


def phase_chat_f32(trainer):
    """(d) at f32: every chat turn equals /generate over its transcript."""
    import numpy as np

    server = trainer.serve(port=0, background=True)
    try:
        replies, transcripts = chat(server.url, CHAT_TURNS, np.random.RandomState(9))
        fresh = [http(server.url, "/generate", {"prompt_ids": t, "max_new_tokens": CHAT_NEW})[1]["token_ids"]
                 for t in transcripts]
    finally:
        server.shutdown()
    same = sum(r["token_ids"] == f for r, f in zip(replies, fresh))
    log(f"[serving] (d) f32 /chat: {same}/{len(replies)} turns equal to /generate over the whole transcript "
        f"(retained blocks {[r['retained_blocks'] for r in replies]})")
    if same != len(replies):
        raise AssertionError(f"chat {[r['token_ids'] for r in replies]} vs generate {fresh}")
    return same


def phase_serving_features(card, paged4):
    """Phase 17. `paged4` holds phase 4's bf16 numbers. Returns ({part:
    launches}, numbers)."""
    import shutil

    from trlx_tpu_torch.trainer.sft_trainer import SFTTrainer

    work = ROOT / "build" / "chip_smoke_serving"
    shutil.rmtree(work, ignore_errors=True)
    _, fixed = serve_and_check(serving_config(kv_paging=False), 16, None, card)
    # phase 4's burst was the process's first: its prefills met each GEMM
    # shape cold. The same burst on the paged pool now, every shape warm
    _, paged = serve_and_check(serving_config(), 16, "paged_decode", card)
    for name, other in (("phase 4's paged pool (the first burst of the process)", paged4),
                        ("the paged pool just after, warm", paged)):
        log(f"[serving] (a) default inference section (fixed-slot pool) vs {name}, 16 requests: "
            f"tokens_per_s {fixed['tokens_per_s']:.1f} vs {other['tokens_per_s']:.1f} "
            f"({fixed['tokens_per_s'] / other['tokens_per_s']:.3f}x), median TTFT {fixed['median_ttft_s']:.4f} vs "
            f"{other['median_ttft_s']:.4f} s ({card})")
    reload = phase_reload(card, work)
    chat_launches, chats = phase_chat(card)
    f32 = SFTTrainer(f32_serving_config(sessions=True))
    fixed_equal = phase_fixed_slot_greedy(f32)
    chat_equal = phase_chat_f32(f32)
    spec_launches, spec = phase_spec_engine(f32, card)
    del f32
    release()
    launches = {"fixed_slot": fixed["launches"], **chat_launches,
                **{f"spec_{name}": n for name, n in spec_launches.items()}}
    return launches, dict(fixed_slot=dict(fixed, paged_phase4=paged4, paged_warm=paged, f32_streams_equal=fixed_equal),
                          reload=reload, chat=dict(chats, f32_turns_equal=chat_equal), spec=spec)


# ---------------------------------------------------------------------------
# Phase 18: the rollout fleet (the eighth main path)
# ---------------------------------------------------------------------------

# phase 9's configuration collecting through the trainer's own supervised
# fleet: 2 thread replicas of its serve() on the paged arena (K1), 64 slots
# each so a 128-row chunk spreads over both, sessions on for /chat, the
# prefix store on for GRPO's `n` fan-out; the router posts a whole chunk at
# once (concurrency 128) and does not hedge, so every decode is one the
# chunk asked for
FLEET_SIZE = 2
FLEET_INFERENCE = dict(kv_paging=True, kv_block_size=32, num_slots=64, max_queue_depth=256, max_prompt_len=64, sessions=True,
                       prefix_cache=True)
FLEET_TRAIN = dict(rollout_backend="fleet", rollout_fleet_supervised=True, rollout_fleet_size=FLEET_SIZE,
                   rollout_fleet_kwargs=dict(concurrency=128, hedge=False),
                   rollout_fleet_supervisor_kwargs=dict(start_timeout_s=300.0))
FLEET_KERNEL = "paged_decode"
# (e): CalculatorEnv episodes of up to 4 turns of 8 sampled tokens (a reply
# holds no digit, so the episode goes on, 41 % of the time at 10 of 95
# printable characters); a transcript stays under 160 tokens
MT_ENV = dict(multiturn_env="calculator", multiturn_max_turns=4, multiturn_env_kwargs=dict(max_turns=4))
MT_NEW, MT_EPISODES, MT_GROUP = 8, 32, 4
BEHAVIOR_TOL = 1e-4  # replica vs scorer logprobs at f32 (decode vs batched forward)
SUBPROCESS_DEVICE = "cuda"  # where the policy server process runs (g)
WAIT_S = 180.0  # a deadline for the supervisor's respawns (a subprocess replica imports torch)


def fleet_config(config, **inference):
    return config.evolve(train=FLEET_TRAIN, inference=dict(FLEET_INFERENCE, **inference))


@contextmanager
def recording_servers(servers):
    """Record every server a trainer's `serve()` starts (the fleet's
    replicas, respawns included), for their decode dispatches."""
    from trlx_tpu_torch.trainer.base_trainer import TorchTrainer

    serve = TorchTrainer.serve

    def wrapped(self, *args, **kwargs):
        server = serve(self, *args, **kwargs)
        servers.append(server)
        return server

    TorchTrainer.serve = wrapped
    try:
        yield
    finally:
        TorchTrainer.serve = serve


def check_k1(tag, launches, servers, n_layers=12):
    """The replicas' K1 launches equal their decode dispatches x layers
    (the trainer itself never launches K1). Returns the dispatches."""
    dispatches = sum(s.engine._kv_kernel_dispatches for s in servers)
    fallbacks = [s.engine._kv_kernel_fallbacks for s in servers if s.engine._kv_kernel_fallbacks]
    if dispatches <= 0 or fallbacks or launches.get(FLEET_KERNEL, 0) != dispatches * n_layers:
        raise AssertionError(f"[{tag}] K1 launches {launches.get(FLEET_KERNEL, 0)} != {dispatches} decode "
                             f"dispatches x {n_layers} (fallbacks {fallbacks})")
    return dispatches


def metric_rows(work, key):
    rows = [json.loads(line) for line in next((work / "logs").glob("*.metrics.jsonl")).read_text().splitlines()]
    return [r for r in rows if key in r]


def wait_for(predicate, what, timeout_s=WAIT_S):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if predicate():
            return time.monotonic() - (deadline - timeout_s)
        time.sleep(0.05)
    raise AssertionError(f"timed out after {timeout_s} s waiting for {what}")


def fleet_trainer(config, prompts=None):
    from trlx_tpu_torch.pipeline.offline_pipeline import PromptPipeline
    from trlx_tpu_torch.utils.loading import get_trainer

    trainer = get_trainer(config.train.trainer)(config, reward_fn=ppo_reward)
    max_prompt = config.train.seq_length - config.method.gen_kwargs.get("max_new_tokens", 40)
    trainer.add_prompt_pipeline(PromptPipeline(prompts or ppo_prompts(), max_prompt, trainer.tokenizer))
    return trainer


def phase_fleet_ppo(card, base):
    """(a) PPO through the supervised fleet via `trlx_tpu_torch.train`, phase
    9's run otherwise: 2 collections, 32 steps, launches exact (K1 =
    the replicas' decode dispatches x 12), no degraded chunk, every row
    with the replicas' behaviour logprobs, the checkpoint loads back."""
    work = ROOT / "build" / "chip_smoke_fleet_ppo"
    servers, rows = [], []
    with recording_servers(servers):
        trainer, launches, metrics = ppo_run(card, "fleet-ppo", work, fleet_config(ppo_config(work)),
                                             PPO_KERNELS_PER_STEP, PPO_KERNELS_PER_CHUNK, elsewhere=(FLEET_KERNEL,),
                                             rows_out=rows)
    dispatches = check_k1("fleet-ppo", launches, servers)
    rows = [r for r in rows if "fleet/degraded_chunks" in r]
    behavior = [r["fleet/behavior_logprob_rows"] for r in rows]
    degraded = [r["fleet/degraded_chunks"] for r in rows]
    requests = [r["fleet/requests"] for r in rows]
    if behavior != [float(PPO_ROLLOUTS)] * PPO_EPOCHS or any(degraded) or trainer._rollout_supervisor is not None:
        raise AssertionError(f"[fleet-ppo] behaviour logprob rows {behavior}, degraded {degraded}")
    rnd = lambda xs: [round(x, 4) for x in xs]
    log(f"[fleet-ppo] {FLEET_SIZE} thread replicas x {FLEET_INFERENCE['num_slots']} paged slots, {len(servers)} "
        f"started; {dispatches} decode dispatches, K1 {launches.get(FLEET_KERNEL, 0)} = {dispatches} x 12; router "
        f"requests {requests}; fleet/behavior_logprob_rows {behavior}, degraded chunks {degraded}; the fleet torn "
        f"down by learn()")
    log(f"[fleet-ppo] vs phase 9 in this call ({card}): samples_per_s {rnd(metrics['samples_per_s'])} (phase 9: "
        f"{rnd(base['samples_per_s'])}); sampling_s {rnd(metrics['sampling_s'])} (phase 9: "
        f"{rnd(base['sampling_s'])}); step_s {metrics['step_s']:.4f} (phase 9: {base['step_s']:.4f})")
    del trainer
    release()
    return launches, dict(metrics, dispatches=dispatches, behavior_logprob_rows=behavior, requests=requests,
                          replicas_started=len(servers))


def collection_busy(trainer):
    """One collection of 128 rollouts under torch.profiler (the card's
    kernels only): (wall s, device busy s, busy share)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.make_experience(PPO_ROLLOUTS, trainer.iter_count)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_us = sum(getattr(e, "self_device_time_total", 0.0) or getattr(e, "self_cuda_time_total", 0.0)
                  for e in prof.key_averages() if e.device_type == DeviceType.CUDA)
    return wall, busy_us / 1e6, busy_us / 1e6 / wall


def replica_host_times(servers):
    """Per series, (seconds, calls) summed over the replicas' scheduler
    histograms: the decode dispatches' and the prefill calls' wall time."""
    out = {}
    for name in ("decode_step_latency_seconds", "prefill_latency_seconds"):
        snaps = [s.metrics.histograms_snapshot().get(name) for s in servers]
        out[name] = (sum(h[2] for h in snaps if h), sum(h[3] for h in snaps if h))
    return out


def seat_bytes(server):
    """(the engine's module bytes, its KV arena bytes)."""
    module = sum(t.numel() * t.element_size() for t in server.engine.model.state_dict().values())
    return module, server.engine.kv_stats()["kv_pool_bytes"]


def allocated():
    import gc

    import torch

    gc.collect()
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated()


def phase_fleet_chaos(card):
    """A PPO trainer at phase 9's configuration with its supervised fleet:
    a warm collection, then the rollout seconds and the device's busy share
    of one fleet collection beside one local collection of the same
    trainer; each seat's device memory, and what a kill gives back with
    the server's shutdown alone and with its release; then (b) chaos: with
    4 chunks of 32, seat 0 is killed from inside the first chunk's
    reward_fn, the collection still holds 128 rows, the supervisor counts
    the death and respawns to capacity, and device memory comes back to
    within one replica's footprint."""
    from trlx_tpu_torch import resilience
    from trlx_tpu_torch.pipeline.offline_pipeline import PromptPipeline

    work = fresh_work("chaos")
    trainer = fleet_trainer(fleet_config(ppo_config(work)))
    out = {}
    try:
        trainer.make_experience(PPO_ROLLOUTS)  # starts the fleet; the replicas' first decode
        seats = [seat.handle.server for seat in trainer._rollout_supervisor.seats]
        before = replica_host_times(seats)
        busy = {"fleet": collection_busy(trainer)}
        host = {k: (v[0] - before[k][0], v[1] - before[k][1]) for k, v in replica_host_times(seats).items()}
        log(f"[fleet-chaos] the fleet collection's replicas: {host['decode_step_latency_seconds'][1]} decode "
            f"dispatches, {host['decode_step_latency_seconds'][0]:.4f} s in them (engine.step), "
            f"{host['prefill_latency_seconds'][1]} prefill calls, {host['prefill_latency_seconds'][0]:.4f} s")
        trainer.config.train.rollout_backend = "local"
        trainer.make_experience(PPO_ROLLOUTS)  # the local sampler's first call
        busy["local"] = collection_busy(trainer)
        trainer.config.train.rollout_backend = "fleet"
        for name, (wall, dev, share) in busy.items():
            log(f"[fleet-chaos] one {name} collection of {PPO_ROLLOUTS} after a warm one: {wall:.4f} s wall, "
                f"device busy {dev:.4f} s, busy share {share:.4f} ({card})")
        out["busy"] = {k: dict(wall_s=v[0], device_s=v[1], busy_share=v[2]) for k, v in busy.items()}
        out["busy"]["fleet"]["replica_host"] = host

        sup = trainer._rollout_supervisor
        seat = sup.seats[1]
        module, arena = seat_bytes(seat.handle.server)
        # the supervisor's lock holds its loop off this seat meanwhile
        deaths0 = sup.counters["deaths"]
        with sup._lock:
            m_a = allocated()
            seat.handle.server.shutdown()  # what killing a thread replica freed before the repair
            m_b = allocated()
            seat.handle.server.release()  # ThreadReplica.kill now
            m_c = allocated()
        wait_for(lambda: sup.counters["deaths"] > deaths0 and sup.healthy_active() == FLEET_SIZE, "seat 1's respawn")
        m_d = allocated()
        footprint = m_a - m_c
        log(f"[fleet-chaos] a seat's device memory: module copy {module} B + KV arena {arena} B = {module + arena} B; "
            f"a kill frees {m_a - m_b} B with the server's shutdown alone (before the repair), {footprint} B with its "
            f"release; after the respawn {m_d - m_a:+d} B against before the kill ({card})")
        if footprint < 0.95 * (module + arena) or m_a - m_b > 0.05 * footprint:
            raise AssertionError(f"a killed replica's memory: shutdown frees {m_a - m_b}, release {footprint}, "
                                 f"its module and arena {module + arena}")
        out["memory"] = dict(module_bytes=module, arena_bytes=arena, freed_by_shutdown=m_a - m_b,
                             freed_by_release=footprint, respawn_delta=m_d - m_a)

        # (b) the chaos collection: 4 chunks of 32, seat 0 killed in the first
        trainer.config.method.chunk_size = 32
        trainer.add_prompt_pipeline(PromptPipeline(ppo_prompts(), 64, trainer.tokenizer))
        killed, deaths0 = [], sup.counters["deaths"]
        victim = sup.seats[0].handle.server

        def killing_reward(samples, prompts, outputs, **kwargs):
            if not killed:
                killed.append(allocated())
                resilience.FaultInjector.kill_replica(victim)
            return ppo_reward(samples, prompts, outputs)

        trainer.reward_fn = killing_reward
        m0 = allocated()
        n0 = len(trainer.store)
        trainer.make_experience(PPO_ROLLOUTS, trainer.iter_count)
        n_rows = len(trainer.store) - n0
        trainer.reward_fn = ppo_reward
        respawn_s = wait_for(lambda: sup.counters["deaths"] > deaths0 and sup.healthy_active() == FLEET_SIZE,
                             "the killed seat's respawn")
        m1 = allocated()
        row = metric_rows(work, "fleet/degraded_chunks")[-1]
        log(f"[fleet-chaos] (b) seat 0 killed in chunk 1's reward_fn: {n_rows} rows collected in 4 chunks, "
            f"degraded chunks {row['fleet/degraded_chunks'] * 4:.0f}, failovers {row.get('fleet/failovers')}; deaths "
            f"{sup.counters['deaths'] - deaths0}, capacity {sup.healthy_active()} {respawn_s:.2f} s after the "
            f"collection; device memory {m1 - m0:+d} B against before the collection (footprint {footprint} B)")
        if not killed or n_rows != PPO_ROLLOUTS or row["fleet/degraded_chunks"] != 0.0:
            raise AssertionError(f"chaos: killed {bool(killed)}, rows {n_rows}, {row}")
        if abs(m1 - m0) > footprint:
            raise AssertionError(f"device memory after the respawn moved {m1 - m0} B, above one replica's {footprint}")
        out["chaos"] = dict(rows=n_rows, deaths=sup.counters["deaths"] - deaths0, respawn_s=respawn_s,
                            memory_delta=m1 - m0, failovers=row.get("fleet/failovers"))
    finally:
        trainer.shutdown_rollout_fleet()
    del trainer
    release()
    return out


def f32_fleet_config(work, make=None, **method):
    config = fleet_config(ppo_config(work, make, dtype="float32", n_layers=4))
    return config.evolve(method=dict(dict(num_rollouts=32, chunk_size=32, gen_kwargs=dict(
        max_new_tokens=PPO_NEW, do_sample=False, suppress_tokens=PPO_SUPPRESS)), **method))


def phase_fleet_f32(card):
    """(c) at f32 (gpt2-small width, 4 layers): the fleet's greedy rollouts
    of 32 prompts against the local sampler's token for token under phase
    11's tie rule, and the replicas' behaviour logprobs against the
    scorer's on the rows that round-trip; (f) then, with supervision
    stopped and every replica killed, a collection degrades to local
    generation; (g) one SubprocessReplica of `serve_policy_command` on the
    card against an in-process replica of the same export."""
    import numpy as np
    import torch

    from trlx_tpu_torch.ops import sampling

    work = fresh_work("f32")
    trainer = fleet_trainer(f32_fleet_config(work))
    out = {}
    try:
        batch = trainer._next_prompts()
        gen = trainer.generate_kwargs
        fleet = trainer._fleet_generate(batch, gen)
        gaps, process = [], sampling.process_logits

        def recording(logits, cfg, step, seen=None):
            res = process(logits, cfg, step, seen)
            top = torch.topk(res, 2, dim=-1).values
            gaps.append(top[:, 0] - top[:, 1])
            return res

        sampling.process_logits = recording
        try:
            local = trainer.generate(batch["input_ids"], batch["attention_mask"], gen)
        finally:
            sampling.process_logits = process
        local_tokens = local["response_tokens"].cpu().numpy()
        diff = local_tokens != fleet["response_tokens"]
        gap = torch.stack(gaps, dim=1).cpu().numpy()
        differ = [(r, int(diff[r].argmax()), float(gap[r, diff[r].argmax()])) for r in np.nonzero(diff.any(1))[0]]
        # the behaviour logprobs against the scorer's on the rows that round-trip
        prompts, outputs, _, _, _ = trainer._host_process_chunk(batch, fleet["samples"])
        all_tokens = torch.from_numpy(np.concatenate([prompts, outputs], axis=1)).to(trainer.device).long()
        scorer = trainer.score(all_tokens)[0].cpu().numpy()
        mine = scorer.copy()
        hits = trainer._apply_behavior_logprobs(mine, fleet, prompts, outputs)
        start = prompts.shape[1] - 1
        err = float(np.abs(mine[:, start:] - scorer[:, start:]).max())
        log(f"[fleet-f32] (c) 32 greedy rollouts x {PPO_NEW} tokens, fleet vs local sampler: {32 - len(differ)}/32 "
            f"rows equal, differing rows (row, position, local top-two gap) {differ}; behaviour logprobs on "
            f"{hits}/32 round-trip rows within {err:.3g} of the scorer's (tol {BEHAVIOR_TOL})")
        if any(g >= TIE_GAP for _, _, g in differ) or hits != 32 or err > BEHAVIOR_TOL:
            raise AssertionError(f"fleet vs local at f32: {differ}, {hits} rows, err {err}")
        out["c"] = dict(rows_equal=32 - len(differ), differ=differ, behavior_rows=hits, behavior_max_abs_err=err)

        # (f) the whole fleet down: supervision stopped, every replica killed
        sup = trainer._rollout_supervisor
        sup._stop.set()
        sup._thread.join(timeout=60)
        sup._thread = None
        for seat in sup.seats:
            seat.handle.kill()
        n0 = len(trainer.store)
        trainer.make_experience(32, trainer.iter_count)
        row = metric_rows(work, "fleet/degraded_chunks")[-1]
        log(f"[fleet-f32] (f) every replica killed, supervision stopped: {len(trainer.store) - n0} rows collected "
            f"locally, fleet/degraded_chunks {row['fleet/degraded_chunks']}, fleet/behavior_logprob_rows "
            f"{row['fleet/behavior_logprob_rows']}, router capacity {trainer._rollout_router.capacity()}")
        if len(trainer.store) - n0 != 32 or row["fleet/degraded_chunks"] != 1.0:
            raise AssertionError(f"whole fleet down: {row}")
        out["f"] = dict(rows=len(trainer.store) - n0, degraded_chunks=row["fleet/degraded_chunks"])
        trainer.shutdown_rollout_fleet()
        export = work / "export"
        trainer.save_pretrained(str(export))
    finally:
        trainer.shutdown_rollout_fleet()
    del trainer
    release()
    out["g"] = subprocess_replica(card, export, work)
    return out


def subprocess_replica(card, export, work):
    """(g) `python -m trlx_tpu_torch.inference.serve_policy` under a
    FleetSupervisor (a SubprocessReplica): it serves on the card, answers
    /healthz and /generate, its f32 greedy replies equal an in-process
    replica's of the same export, and killed it is respawned."""
    from trlx_tpu_torch.inference import serve_policy
    from trlx_tpu_torch.inference.supervisor import FleetSupervisor, SubprocessReplica, serve_policy_command

    hparams = {"device": SUBPROCESS_DEVICE, "model.model_extra_configs": {"dtype": "float32"},
               "inference.gen_kwargs": {"do_sample": False, "max_new_tokens": 16}, "inference.max_new_tokens": 16,
               "inference.max_prompt_len": 64, "inference.kv_paging": True}
    prompts = [list(p.encode()) for p in ppo_prompts(4, seed=5)]
    thread = serve_policy.main({"checkpoint": str(export), "port": 0, "background": True, **hparams})
    try:
        want = [http(thread.url, "/generate", {"prompt_ids": p, "max_new_tokens": 16})[1]["token_ids"]
                for p in prompts]
    finally:
        thread.shutdown()
    del thread
    release()
    log_path = work / "replica.log"  # every spawn appends its output here

    def factory(seat):
        return SubprocessReplica(serve_policy_command(str(export), **hparams), log_path=str(log_path),
                                 cwd=str(ROOT), stop_grace_s=10.0)

    t0 = time.perf_counter()
    sup = FleetSupervisor(factory, num_replicas=1, start_timeout_s=WAIT_S, probe_interval_s=0.5).start()
    try:
        if not sup.wait_ready(timeout_s=WAIT_S):
            raise AssertionError(f"the subprocess replica never became ready: {log_path.read_text()[-2000:]}")
        up_s = time.perf_counter() - t0
        url = sup.seats[0].url
        code, health = http(url, "/healthz")
        got = [http(url, "/generate", {"prompt_ids": p, "max_new_tokens": 16})[1]["token_ids"] for p in prompts]
        pid = sup.seats[0].handle.proc.pid
        sup.seats[0].handle.kill()
        respawn_s = wait_for(lambda: sup.counters["deaths"] >= 1 and sup.healthy_active() == 1, "the respawn")
        again = [http(sup.seats[0].url, "/generate", {"prompt_ids": p, "max_new_tokens": 16})[1]["token_ids"]
                 for p in prompts]
        new_pid = sup.seats[0].handle.proc.pid
    finally:
        sup.stop()
    on_card = log_path.read_text().count(f"serve_policy: policy on {SUBPROCESS_DEVICE}")
    log(f"[fleet-subprocess] (g) serve_policy as a SubprocessReplica: ready {up_s:.2f} s after the spawn, /healthz "
        f"{code} ready={health.get('ready')}, policy on the card in {on_card} process logs; f32 greedy replies equal "
        f"an in-process replica's: {sum(a == b for a, b in zip(got, want))}/{len(want)}; killed (pid {pid}), "
        f"respawned as pid {new_pid} within {respawn_s:.2f} s, replies equal again "
        f"{sum(a == b for a, b in zip(again, want))}/{len(want)} ({card})")
    if code != 200 or not health.get("ready") or got != want or again != want or new_pid == pid or on_card < 2:
        raise AssertionError(f"subprocess replica: {code} {health}, {got} vs {want}, again {again}, on card {on_card}")
    return dict(ready_s=up_s, respawn_s=respawn_s, replies_equal=len(want), processes_on_card=on_card)


def phase_fleet_grpo(card, grpo_base):
    """(d) GRPO's `n` fan-out at phase 15's configuration (16 prompts x G
    8, one collection and 16 steps): only the 16 unique prompts travel,
    K1 exact, the group's prefix blocks shared."""
    from trlx_tpu_torch.data.default_configs import default_grpo_config

    work = ROOT / "build" / "chip_smoke_fleet_grpo"
    config = fleet_config(ppo_config(work, default_grpo_config)).evolve(train=dict(epochs=1))
    servers, rows = [], []
    with recording_servers(servers):
        trainer, launches, metrics = ppo_run(card, "fleet-grpo", work, config, GRPO_KERNELS_PER_STEP,
                                             GRPO_KERNELS_PER_CHUNK, collections=1, elsewhere=(FLEET_KERNEL,),
                                             rows_out=rows)
    dispatches = check_k1("fleet-grpo", launches, servers)
    groups = check_groups(trainer, "fleet-grpo")
    row = [r for r in rows if "fleet/requests" in r][0]
    hits = sum(s.engine.kv_stats()["prefix_cache_hits"] for s in servers)
    prompts = PPO_ROLLOUTS // GRPO_GROUP
    rnd = lambda xs: [round(x, 4) for x in xs]
    log(f"[fleet-grpo] (d) {row['fleet/requests']:.0f} requests for {PPO_ROLLOUTS} rows ({prompts} prompts x n "
        f"{GRPO_GROUP}); prefix blocks shared {hits}; {dispatches} decode dispatches, K1 {launches.get(FLEET_KERNEL, 0)}; "
        f"group sums within {groups[0]:.3g}; samples_per_s {rnd(metrics['samples_per_s'])} (phase 15: "
        f"{rnd(grpo_base['samples_per_s'])}), sampling_s {rnd(metrics['sampling_s'])} (phase 15: "
        f"{rnd(grpo_base['sampling_s'])}) ({card})")
    if row["fleet/requests"] != prompts or hits < prompts * (GRPO_GROUP - 1) or row["fleet/degraded_chunks"]:
        raise AssertionError(f"GRPO fan-out: {row}, prefix hits {hits}")
    del trainer
    release()
    return launches, dict(metrics, requests=row["fleet/requests"], prefix_hits=hits, dispatches=dispatches)


def multiturn_config(work, make=None, f32=False, **method):
    base = f32_fleet_config(work, make) if f32 else fleet_config(ppo_config(work, make))
    gen = dict(max_new_tokens=MT_NEW, suppress_tokens=PPO_SUPPRESS, **(
        dict(do_sample=False) if f32 else dict(do_sample=True, top_k=0, top_p=1.0)))
    return base.evolve(method=dict(dict(num_rollouts=MT_EPISODES, chunk_size=MT_EPISODES, gen_kwargs=gen), **MT_ENV,
                                   **method),
                       inference=dict(max_prompt_len=160))


def fresh_work(tag):
    import shutil

    work = ROOT / "build" / f"chip_smoke_fleet_{tag}"
    shutil.rmtree(work, ignore_errors=True)
    return work


def multiturn_run(card, tag, make=None, **method):
    """One multi-turn collection of 32 episodes, then one PPO (GRPO) step
    on its first batch with the loss masks: K1 = the replicas' decode
    dispatches x 12, the scoring chunk's and the step's launches exact,
    retained turns > 0, the step's loss finite."""
    import numpy as np

    from trlx_tpu_torch import kernels

    work = fresh_work(tag)
    record, servers = [], []
    with recording_servers(servers), ppo_probes(record, names=("score", "train_minibatch")):
        trainer = fleet_trainer(multiturn_config(work, make, **method))
        try:
            kernels.reset_launches()
            t0 = time.perf_counter()
            trainer.make_experience(MT_EPISODES)
            collect_s = time.perf_counter() - t0
            launches = dict(kernels.LAUNCHES)
            batch = next(iter(trainer.create_train_dataloader()))
            stats = trainer.train_minibatch([batch])
        finally:
            trainer.shutdown_rollout_fleet()
    dispatches = check_k1(tag, launches, servers)
    row = metric_rows(work, "rollout/retained_hit_turns")[0]
    scores = [c[3] for c in record if c[0] == "score"]
    steps = [c[3] for c in record if c[0] == "train_minibatch"]
    masks = np.concatenate([e.loss_mask for e in trainer.store.history])
    G = int(getattr(trainer.config.method, "group_size", 1))
    seeds_ok = all(len({tuple(e.query_tensor) for e in trainer.store.history[g:g + G]}) == 1
                   for g in range(0, MT_EPISODES, G))
    log(f"[{tag}] (e) {MT_EPISODES} CalculatorEnv episodes over /chat in {collect_s:.3f} s: mean turns "
        f"{row['rollout/mean_turns']:.3f}, retained-KV turns {row['rollout/retained_hit_turns']:.0f}, mean env reward "
        f"{row['rollout/mean_env_reward']:.4f}, loss-masked share {1 - masks.mean():.4f}; {dispatches} decode "
        f"dispatches, K1 {launches.get(FLEET_KERNEL)}; scoring {scores}, step {steps}; loss "
        f"{stats['losses/total_loss']:.6f} with loss masks {batch.loss_masks is not None}; same-seed groups of "
        f"{G}: {seeds_ok} ({card})")
    if row["rollout/retained_hit_turns"] <= 0 or scores != [PPO_KERNELS_PER_CHUNK] or steps != [PPO_KERNELS_PER_STEP]:
        raise AssertionError(f"[{tag}] retained {row['rollout/retained_hit_turns']}, scoring {scores}, step {steps}")
    if batch.loss_masks is None or not math.isfinite(stats["losses/total_loss"]) or not seeds_ok:
        raise AssertionError(f"[{tag}] loss masks {batch.loss_masks is not None}, loss {stats['losses/total_loss']}")
    launches = {k: v + (steps[0].get(k, 0) if k != FLEET_KERNEL else 0) for k, v in launches.items()}
    del trainer
    release()
    return launches, dict(collect_s=collect_s, mean_turns=row["rollout/mean_turns"], dispatches=dispatches,
                          retained_hit_turns=row["rollout/retained_hit_turns"], loss=stats["losses/total_loss"])


def multiturn_f32(card, tag, make=None, **method):
    """(e) at f32 (4 layers, greedy): each recorded episode's policy turns
    equal /generate over the transcript before them, on a replica of the
    same fleet."""
    from trlx_tpu_torch.trainer.ppo_trainer import PPOTrainer

    work = fresh_work(tag)
    episodes, run = [], PPOTrainer._run_episode

    def recording(self, *args, **kwargs):
        episode = run(self, *args, **kwargs)
        episodes.append(episode)
        return episode

    PPOTrainer._run_episode = recording
    trainer = fleet_trainer(multiturn_config(work, make, f32=True, **method))
    try:
        trainer.make_experience(8)
        url = trainer._rollout_supervisor.seats[0].url
        turns = equal = 0
        for prompt_ids, segments, _ in episodes:
            transcript = list(prompt_ids)
            for kind, ids, _, _ in segments:
                if kind == "policy":
                    reply = http(url, "/generate", {"prompt_ids": transcript, "max_new_tokens": MT_NEW})[1]
                    turns += 1
                    equal += reply["token_ids"] == ids
                transcript += ids
    finally:
        PPOTrainer._run_episode = run
        trainer.shutdown_rollout_fleet()
    log(f"[{tag}] (e) f32: {equal}/{turns} policy turns of {len(episodes)} episodes equal /generate over the "
        f"transcript before them")
    if equal != turns or not turns:
        raise AssertionError(f"[{tag}] f32 turns {equal}/{turns}")
    del trainer
    release()
    return dict(turns=turns, equal=equal)


def phase_fleet(card, ppo_base, grpo_base):
    """Phase 18. Returns ({part: launches}, numbers)."""
    from trlx_tpu_torch.data.default_configs import default_grpo_config

    t0 = time.perf_counter()
    launches, out = {}, {}
    launches["ppo"], out["ppo"] = phase_fleet_ppo(card, ppo_base)
    out["chaos"] = phase_fleet_chaos(card)
    out["f32"] = phase_fleet_f32(card)
    launches["grpo_n"], out["grpo_n"] = phase_fleet_grpo(card, grpo_base)
    mt = {}
    for tag, make, method in (("multiturn", None, {}), ("multiturn_grpo", default_grpo_config,
                                                         dict(group_size=MT_GROUP))):
        launches[tag], mt[tag] = multiturn_run(card, tag, make, **method)
        mt[f"{tag}_f32"] = multiturn_f32(card, f"{tag}_f32", make, **method)
    out["multiturn"] = mt
    out["seconds"] = time.perf_counter() - t0
    log(f"[fleet] phase 18 took {out['seconds']:.1f} s")
    return launches, out


# ---------------------------------------------------------------------------
# Phase 19: the reward model, reward serving and best-of-n; the health
# sentinel's chaos run, auto_resume and the policy server's drain
# ---------------------------------------------------------------------------

RM_T, RM_PAIRS, RM_STEPS, RM_EVAL_PAIRS, RM_LR = 128, 32, 40, 128, 1e-4
RM_ACCURACY = 0.9
# a scoring call under no_grad: the forward-only kernel in every block; a
# training step over the pairs (one forward over chosen and rejected
# rows): the forward with lse and both backward kernels in every block;
# the reward model has no LM head, so no K7
RM_SCORE_KERNELS = {"flash_fwd": 12}
RM_STEP_KERNELS = {"flash_fwd_lse": 12, "flash_bwd_dq": 12, "flash_bwd_dkv": 12}
RM_F32_STEP_KERNELS = {"flash_fwd_lse": 4, "flash_bwd_dq": 4, "flash_bwd_dkv": 4}
BON_PROMPTS, BON_N, BON_EPOCHS = 8, 4, 2
BON_STEP_KERNELS = RFT_KERNELS_PER_STEP  # the SFT step's CE over every block
# the chaos run: the ladder takes only catastrophes (z 50), a skipped step
# is one whose norm is not finite or above 1e3; faults by iter_count
CHAOS_SENTINEL = dict(sentinel=True, grad_skip_threshold=1e3, sentinel_window=8, sentinel_warmup=2,
                      sentinel_zscore=50.0, sentinel_skip_after=2, sentinel_rewind_after=2, sentinel_good_steps=2,
                      sentinel_pin_interval=4, max_rewinds=2, sentinel_cooldown_steps=4)
CHAOS_TIMEOUT_S, CHAOS_HANG_S = 6.0, 8.0
CHAOS_FAULTS = dict(nan_grad_steps=[3], loss_spike_steps=[7, 8], hang_steps=[12], hang_step_s=CHAOS_HANG_S)
RESUME_ROLLOUTS, RESUME_BATCH, RESUME_PREEMPT_AT = 32, 8, 6
# the preempted run's process: imports this script and runs (d)'s child
RESUME_CHILD = "import sys; sys.path.insert(0, {root!r}); import chip_smoke; chip_smoke.auto_resume_child({run!r})"
DRAIN_REQUESTS, DRAIN_NEW = 8, 256
RM_DEVICE = "cuda"  # where the reward model lives


def rm_texts(n, rng, chosen):
    """Byte strings of 16-120 lowercase letters: a-m for a chosen text,
    n-z for a rejected one (separable pairs from a seed)."""
    base = 97 if chosen else 110
    return ["".join(chr(base + c) for c in rng.randint(0, 13, rng.randint(16, 121))) for _ in range(n)]


def rm_batch(tokenizer, texts, device):
    import torch

    enc = tokenizer(texts, max_length=RM_T, truncation=True, padding="max_length")
    return (torch.from_numpy(enc["input_ids"]).to(device).long(),
            torch.from_numpy(enc["attention_mask"]).to(device).long())


def rm_tokenizer():
    from trlx_tpu_torch.data.configs import TokenizerConfig
    from trlx_tpu_torch.tokenizers import get_tokenizer

    # the head reads the last valid token at mask.sum - 1: right padding
    return get_tokenizer(TokenizerConfig(tokenizer_path="byte", padding_side="right"))


def rm_model(seed=0, **extra):
    import torch

    from trlx_tpu_torch.models import config_from_preset
    from trlx_tpu_torch.models.reward import build_reward_model

    cfg = config_from_preset("gpt2-small", vocab_size=50257, attn_impl="flash", **extra)
    return build_reward_model(cfg, seed=seed, device=torch.device(RM_DEVICE))


def phase_reward_model(card):
    """(a) The reward model at gpt2-small full width (bf16, flash): pairwise
    training on seeded separable pairs, held-out accuracy above 0.9, the
    launches of a scoring call and of a step exact; at f32 (4 layers) the
    rewards and one step's gradients with the kernels vs the plain
    versions. Returns (model, tokenizer, launches, numbers)."""
    import numpy as np
    import torch

    from trlx_tpu_torch import kernels
    from trlx_tpu_torch.models.reward import pairwise_loss

    t0 = time.perf_counter()
    tokenizer, device = rm_tokenizer(), torch.device(RM_DEVICE)
    rm = rm_model()
    opt = torch.optim.AdamW([p for p in rm.parameters()], lr=RM_LR)
    rng = np.random.RandomState(19)
    launches, step_launches, step_s = {}, [], []
    for step in range(RM_STEPS):
        c_ids, c_mask = rm_batch(tokenizer, rm_texts(RM_PAIRS, rng, True), device)
        r_ids, r_mask = rm_batch(tokenizer, rm_texts(RM_PAIRS, rng, False), device)
        torch.cuda.synchronize()
        kernels.reset_launches()
        t1 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        rewards = rm(torch.cat([c_ids, r_ids]), torch.cat([c_mask, r_mask]))
        loss, stats = pairwise_loss(rewards[:RM_PAIRS], rewards[RM_PAIRS:])
        loss.backward()
        opt.step()
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t1)
        step_launches.append({k: v for k, v in kernels.LAUNCHES.items() if v})
        loss = loss.detach()
        if not math.isfinite(float(loss)):
            raise AssertionError(f"[rm] step {step}: loss {float(loss)}")
    for k in RM_STEP_KERNELS:
        launches[k] = sum(s.get(k, 0) for s in step_launches)
    eval_rng = np.random.RandomState(20)
    c_ids, c_mask = rm_batch(tokenizer, rm_texts(RM_EVAL_PAIRS, eval_rng, True), device)
    r_ids, r_mask = rm_batch(tokenizer, rm_texts(RM_EVAL_PAIRS, eval_rng, False), device)
    kernels.reset_launches()
    t1 = time.perf_counter()
    with torch.no_grad():
        r_c = rm(c_ids, c_mask)
        torch.cuda.synchronize()
        score_s = time.perf_counter() - t1
        score_launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
        r_r = rm(r_ids, r_mask)
    launches["flash_fwd"] = kernels.LAUNCHES.get("flash_fwd", 0)
    accuracy = float((r_c > r_r).float().mean())
    bad_steps = [s for s in step_launches if s != RM_STEP_KERNELS]
    log(f"[rm] gpt2-small reward model (vocab 50257, bf16, flash, every block trainable): {RM_STEPS} AdamW steps of "
        f"{RM_PAIRS} pairs x {RM_T} tokens (right-padded), last loss {float(loss):.5f} accuracy "
        f"{float(stats['accuracy']):.3f}; median step_s={statistics.median(step_s[1:]):.4f}; held-out accuracy "
        f"{accuracy:.4f} over {RM_EVAL_PAIRS} pairs, margin {float((r_c - r_r).mean()):.4f}; a scoring call of "
        f"{RM_EVAL_PAIRS} rows {score_s * 1e3:.2f} ms ({RM_EVAL_PAIRS / score_s:.1f} samples/s), launches "
        f"{score_launches}; a step launches {step_launches[-1]} ({card})")
    if accuracy <= RM_ACCURACY or bad_steps or score_launches != RM_SCORE_KERNELS or \
            launches["flash_fwd"] != 2 * RM_SCORE_KERNELS["flash_fwd"]:
        raise AssertionError(f"[rm] accuracy {accuracy}, steps launching otherwise {bad_steps[:2]}, scoring "
                             f"{score_launches}")
    numbers = dict(steps=RM_STEPS, pairs=RM_PAIRS, t=RM_T, accuracy=accuracy, last_loss=float(loss),
                   step_s=statistics.median(step_s[1:]), score_ms=score_s * 1e3,
                   score_samples_per_s=RM_EVAL_PAIRS / score_s, score_kernels=RM_SCORE_KERNELS,
                   step_kernels=RM_STEP_KERNELS)

    # at f32, 4 layers: the rewards and one step's gradients, kernels vs plain
    import types

    f32 = rm_model(seed=1, dtype=torch.float32, n_layers=4)
    ids, mask = torch.cat([c_ids[:16], r_ids[:16]]), torch.cat([c_mask[:16], r_mask[:16]])

    def loss_fn(batch):
        r = f32(*batch)
        return pairwise_loss(r[:16], r[16:])

    fake = types.SimpleNamespace(model=f32, make_loss_fn=lambda: loss_fn, batch_to_device=lambda b: b)
    with torch.no_grad():
        with plain_versions():
            r_plain = f32(ids, mask)
        kernels.reset_launches()
        r_kern = f32(ids, mask)
    err = float((r_kern - r_plain).abs().max())
    with plain_versions():
        loss_p, grads_p, gates = step_grads(fake, (ids, mask))
    kernels.reset_launches()
    loss_k, grads_k, gates_k = step_grads(fake, (ids, mask), gates)
    f32_launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    worst = check_grads(grads_k, grads_p)
    flips = gate_flips(gates_k, gates)
    log(f"[rm-f32] gpt2-small width, 4 layers, f32, 32 rows t {RM_T}: rewards kernels vs plain max|diff| {err:.3g} "
        f"(tol {SCORE_TOL['atol']}); loss kernels={loss_k:.7f} plain={loss_p:.7f}; {len(grads_k)} grads, worst "
        f"max|diff|/max|g| = {worst:.3g} (tol {GRAD_TOL}) under the plain run's head gate ({flips[0]}/{flips[1]} "
        f"entries its own ReLU sets otherwise); launches {f32_launches}")
    torch.testing.assert_close(r_kern, r_plain, **SCORE_TOL)
    if not abs(loss_k - loss_p) <= 1e-5 * abs(loss_p) or f32_launches != RM_F32_STEP_KERNELS:
        raise AssertionError(f"[rm-f32] loss {loss_k} vs {loss_p}, launches {f32_launches}")
    del f32, opt
    release()
    numbers.update(f32_reward_err=err, f32_loss=[loss_k, loss_p], f32_grad_worst=worst,
                   seconds=time.perf_counter() - t0)
    log(f"[rm] (a) took {numbers['seconds']:.1f} s")
    return rm, tokenizer, launches, numbers


def bon_config(work, **model_extra):
    from trlx_tpu_torch.data.default_configs import default_bon_config

    return default_bon_config().evolve(
        train=dict(seq_length=1024, batch_size=BON_PROMPTS, epochs=BON_EPOCHS, eval_interval=10000,
                   checkpoint_dir=str(work / "ckpts"), logging_dir=str(work / "logs")),
        model=dict(model_path="random:gpt2-small",
                   model_extra_configs={"vocab_size": 50257, "attn_impl": "flash", **model_extra}),
        method=dict(best_of_n=BON_N, gen_kwargs=dict(max_new_tokens=PPO_NEW, top_k=0, top_p=1.0, do_sample=True,
                                                     suppress_tokens=PPO_SUPPRESS)),
        inference=dict(FLEET_INFERENCE, sessions=False, prefix_cache=False, max_new_tokens=PPO_NEW),
    )


@contextmanager
def counting_calls(module, calls):
    """Count a module's forward calls (the reward model's, whose K3
    launches a best-of-n run adds to its own)."""
    hook = module.register_forward_hook(lambda *a: calls.append(1))
    try:
        yield
    finally:
        hook.remove()


def bon_run(card, tag, work, rm, config, fleet=False, reward_fn=None):
    """A best-of-n run: through `trlx_tpu_torch.train` (local), or (fleet)
    a trainer wired as `train` wires it, serving itself on two in-process
    replicas (the trainer's own `serve()`, on its live weights) and
    sampling through them with the `n` fan-out. Launches exact: a CE step
    RFT's, K3 = 12 x the reward model's forward calls, K1 (fleet) = the
    replicas' decode dispatches x 12, nothing else."""
    import shutil

    import torch

    import trlx_tpu_torch
    from trlx_tpu_torch import kernels
    from trlx_tpu_torch.pipeline.offline_pipeline import PromptPipeline
    from trlx_tpu_torch.trainer.bon_trainer import BestOfNTrainer

    if work.exists():
        shutil.rmtree(work)
    record, rm_calls, servers = [], [], []
    prompts = ppo_prompts(BON_PROMPTS, seed=7)
    kernels.reset_launches()
    t0 = time.perf_counter()
    with ppo_probes(record, BestOfNTrainer, ("make_experience", "_sample_candidates", "train_minibatch")), \
            counting_calls(rm, rm_calls), recording_servers(servers):
        if not fleet:
            trainer = trlx_tpu_torch.train(reward_fn=reward_fn, prompts=prompts, config=config)
        else:
            trainer = BestOfNTrainer(config, reward_fn=reward_fn)
            trainer.add_prompt_pipeline(PromptPipeline(prompts, config.train.seq_length - PPO_NEW, trainer.tokenizer))
            trainer.add_eval_pipeline(PromptPipeline(prompts, config.train.seq_length - PPO_NEW, trainer.tokenizer))
            for _ in range(FLEET_SIZE):
                trainer.serve(host="127.0.0.1", port=0, background=True)
            trainer.config.train.rollout_backend = "fleet"
            trainer.config.train.rollout_fleet_urls = [s.url for s in servers]
            trainer.config.train.rollout_fleet_kwargs = dict(concurrency=64, hedge=False)
            try:
                trainer.learn()
            finally:
                for s in servers:
                    s.shutdown()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    rows = metric_rows(work, "bon/n_winners")
    rounds = [c for c in record if c[0] == "make_experience"]
    sampled = [c for c in record if c[0] == "_sample_candidates"]
    steps = [c for c in record if c[0] == "train_minibatch"]
    step_rows = [r for r in metric_rows(work, "time/train_step_s")]
    for c in steps:
        if c[3] != BON_STEP_KERNELS:
            raise AssertionError(f"[{tag}] a CE step launched {c[3]}, expected {BON_STEP_KERNELS}")
    want = {k: v * len(steps) for k, v in BON_STEP_KERNELS.items()}
    want["flash_fwd"] = RM_SCORE_KERNELS["flash_fwd"] * len(rm_calls)
    dispatches = 0
    if fleet:
        dispatches = check_k1(tag, launches, servers)  # K1 = the replicas' decode dispatches x 12
        if FLEET_KERNEL in launches:
            want[FLEET_KERNEL] = launches[FLEET_KERNEL]
    round_s = [c[2] - c[1] for c in rounds]
    sample_s = [c[2] - c[1] for c in sampled]
    n_samples = BON_PROMPTS * BON_N
    numbers = dict(wall_s=wall, rounds=len(rounds), steps=len(steps), round_s=round_s,
                   samples_per_s=[n_samples / s for s in round_s], sampling_s=sample_s,
                   scores_mean=[r["bon/scores_mean"] for r in rows],
                   winner_scores_mean=[r["bon/winner_scores_mean"] for r in rows],
                   reward_model_calls=len(rm_calls), decode_dispatches=dispatches,
                   step_s=[r["time/train_step_s"] for r in step_rows])
    log(f"[{tag}] gpt2-small best-of-n ({'through 2 in-process replicas, n fan-out' if fleet else 'local sampler'}): "
        f"{BON_PROMPTS} prompts x n {BON_N} x {PPO_NEW} tokens a round, {len(rounds)} rounds in "
        f"{[round(s, 3) for s in round_s]} s (samples/s {[round(x, 1) for x in numbers['samples_per_s']]}; "
        f"sampling {[round(s, 3) for s in sample_s]} s), scores mean {[round(x, 4) for x in numbers['scores_mean']]} "
        f"winners {[round(x, 4) for x in numbers['winner_scores_mean']]}, {len(steps)} CE steps "
        f"({[round(x, 4) for x in numbers['step_s']]} s), {len(rm_calls)} reward-model calls through the server, "
        f"{wall:.2f} s wall; launches {launches} ({card})")
    if launches != want or len(rounds) != config.train.epochs + 1 or any(r["bon/n_winners"] != BON_PROMPTS
                                                                         for r in rows):
        raise AssertionError(f"[{tag}] launches {launches} != {want}; {len(rounds)} rounds; {rows}")
    if not isinstance(trainer, BestOfNTrainer) or not all(math.isfinite(r["loss"]) for r in step_rows):
        raise AssertionError(f"[{tag}] trainer {type(trainer)}, losses {[r['loss'] for r in step_rows]}")
    del trainer
    release()
    return launches, numbers


def bon_f32_fleet_vs_local(card):
    """At f32 (4 layers, greedy): one batch's candidates through two
    in-process replicas with the `n` fan-out against the local sampler's,
    token for token under phase 11's tie rule."""
    import numpy as np
    import torch

    from trlx_tpu_torch.ops import sampling
    from trlx_tpu_torch.pipeline.offline_pipeline import PromptPipeline
    from trlx_tpu_torch.trainer.bon_trainer import BestOfNTrainer

    work = ROOT / "build" / "chip_smoke_bon_f32"
    config = bon_config(work, dtype="float32", n_layers=4).evolve(method=dict(gen_kwargs=dict(
        max_new_tokens=PPO_NEW, do_sample=False, suppress_tokens=PPO_SUPPRESS)))
    trainer = BestOfNTrainer(config, reward_fn=ppo_reward)
    trainer.add_prompt_pipeline(PromptPipeline(ppo_prompts(BON_PROMPTS, seed=8), 984, trainer.tokenizer))
    batch = next(iter(trainer.prompt_dataloader))
    ids, mask = np.asarray(batch["input_ids"]), np.asarray(batch["attention_mask"])
    gaps, process, generate = [], sampling.process_logits, trainer.generate
    local_tokens = []

    def recording(logits, cfg, step, seen=None):
        res = process(logits, cfg, step, seen)
        top = torch.topk(res, 2, dim=-1).values
        gaps.append(top[:, 0] - top[:, 1])
        return res

    def generating(*args, **kwargs):
        out = generate(*args, **kwargs)
        local_tokens.append(out["response_tokens"].cpu().numpy())
        return out

    sampling.process_logits, trainer.generate = recording, generating
    try:
        local = trainer._sample_candidates(ids, mask, BON_N)
    finally:
        sampling.process_logits, trainer.generate = process, generate
    servers = [trainer.serve(host="127.0.0.1", port=0, background=True) for _ in range(FLEET_SIZE)]
    trainer.config.train.rollout_backend = "fleet"
    trainer.config.train.rollout_fleet_urls = [s.url for s in servers]
    trainer.config.train.rollout_fleet_kwargs = dict(concurrency=64, hedge=False)
    replies = []
    router = trainer._get_bon_router()
    route = router.generate
    router.generate = lambda prompts, **kw: replies.append(route(prompts, **kw)) or replies[-1]
    try:
        fleet = trainer._sample_candidates(ids, mask, BON_N)
    finally:
        trainer.shutdown_rollout_fleet()
        for s in servers:
            s.shutdown()
    steps = len(gaps) // BON_N
    gap = torch.stack(gaps[:steps], dim=1).cpu().numpy()
    differ = []
    for p, rep in enumerate(replies[0]):
        for seq in rep.get("sequences") or [rep]:
            got = np.asarray(seq["token_ids"][:PPO_NEW])
            want = local_tokens[0][p, :len(got)]
            if not np.array_equal(got, want):
                pos = int(np.argmax(got != want))
                differ.append((p, pos, float(gap[p, pos])))
    equal = sum(a == b for a, b in zip(local, fleet))
    log(f"[bon-f32] gpt2-small width, 4 layers, f32, greedy: {BON_PROMPTS} prompts x n {BON_N} through 2 replicas "
        f"(one request a prompt) vs the local sampler: {equal}/{BON_PROMPTS} prompts' candidates equal; differing "
        f"sequences (prompt, position, local top-two gap) {differ} (tie rule {TIE_GAP}) ({card})")
    if len(replies) != 1 or len(replies[0]) != BON_PROMPTS or any(g >= TIE_GAP for _, _, g in differ):
        raise AssertionError(f"[bon-f32] {len(replies)} fleet calls, differing {differ}")
    if not differ and equal != BON_PROMPTS:
        raise AssertionError(f"[bon-f32] tokens equal but {equal}/{BON_PROMPTS} candidate strings")
    del trainer
    release()
    return dict(prompts_equal=equal, differ=differ)


def phase_bon(card, rm, tokenizer):
    """(b) The reward model behind `RewardModelServer` with a `mixed`
    fault injector: `remote_reward_fn` scores equal in-process
    `make_reward_fn` scores; then best-of-n through
    `trlx_tpu_torch.train(reward_fn=remote_reward_fn(url))` locally, and
    on the trainer's two in-process replicas; at f32 the fleet's
    candidates against the local ones."""
    from trlx_tpu_torch.models.reward import make_reward_fn
    from trlx_tpu_torch.resilience import FaultInjector
    from trlx_tpu_torch.serving import RewardModelServer, remote_reward_fn

    t0 = time.perf_counter()
    rm.eval()
    local_fn = make_reward_fn(rm, None, tokenizer, max_length=RM_T, batch_size=64)
    # every other request fails, a 503 and a dropped connection in turn
    injector = FaultInjector(schedule=[True, False], cycle=True, mode="mixed")
    server = RewardModelServer(local_fn, host="127.0.0.1", port=0, fault_injector=injector)
    url = server.start_background()
    launches, out = {}, {}
    try:
        client = remote_reward_fn(url, retries=8, retry_base_delay=0.01, retry_max_delay=0.05)
        import numpy as np

        rng = np.random.RandomState(21)
        samples = rm_texts(48, rng, True) + rm_texts(48, rng, False)
        calls = 0
        for _ in range(4):
            got = client(samples)
            calls += 1
        want = local_fn(samples)
        log(f"[bon-serving] the reward model behind RewardModelServer (mixed faults, every other request): {calls} calls of "
            f"{len(samples)} samples, {injector.injected} injected faults (503 or dropped connection) retried; "
            f"remote scores equal the in-process make_reward_fn's: {got == want}")
        if got != want or not injector.injected:
            raise AssertionError(f"[bon-serving] remote {got[:4]} vs local {want[:4]}, injected {injector.injected}")
        out["serving"] = dict(calls=calls, samples=len(samples), injected=injector.injected, equal=True)
        server.fault_injector = None  # the runs below score through a healthy server
        reward_fn = remote_reward_fn(url)
        work = ROOT / "build" / "chip_smoke_bon"
        launches["local"], out["local"] = bon_run(card, "bon", work, rm, bon_config(work), reward_fn=reward_fn)
        work = ROOT / "build" / "chip_smoke_bon_fleet"
        config = bon_config(work).evolve(train=dict(epochs=1))
        launches["fleet"], out["fleet"] = bon_run(card, "bon-fleet", work, rm, config, fleet=True,
                                                  reward_fn=reward_fn)
    finally:
        server.shutdown()
    out["f32"] = bon_f32_fleet_vs_local(card)
    out["seconds"] = time.perf_counter() - t0
    log(f"[bon] (b) took {out['seconds']:.1f} s")
    return launches, out


def chaos_state(trainer):
    """Clones of what a skipped step must leave bitwise: the trainable
    parameters, the optimizer's state and the scheduler's."""
    params = [p.detach().clone() for p in trainer.trainable_params]
    opt = [{k: (v.clone() if hasattr(v, "clone") else v) for k, v in trainer.optimizer.state[p].items()}
           for p in trainer.trainable_params]
    return params, opt, dict(trainer.scheduler.state_dict())


def same_state(a, b):
    import torch

    return (all(torch.equal(x, y) for x, y in zip(a[0], b[0]))
            and all(x.keys() == y.keys() and all(torch.equal(x[k], y[k]) if hasattr(x[k], "shape") else x[k] == y[k]
                                                 for k in x) for x, y in zip(a[1], b[1]))
            and a[2] == b[2])


def phase_chaos(card):
    """(c) Phase 9's configuration with the health sentinel, the step
    watchdog (its `on_timeout` injected) and a FaultInjector: a NaN step,
    two 1e4 loss spikes and a wedged step. The NaN and spike steps are
    skipped with the parameters, Adam state and schedule bitwise as they
    were (the NaN and huge gradients reach the guard through K5, K6 and
    K7's backward), the spikes climb the ladder to one rewind to
    last_good, the hang fires the watchdog, and the run completes its 32
    steps; launches exact a step and a scoring chunk."""
    import shutil

    import torch

    from trlx_tpu_torch.pipeline.offline_pipeline import PromptPipeline
    from trlx_tpu_torch.resilience import FaultInjector
    from trlx_tpu_torch.trainer.ppo_trainer import PPOTrainer

    t0 = time.perf_counter()
    work = ROOT / "build" / "chip_smoke_chaos"
    if work.exists():
        shutil.rmtree(work)
    config = ppo_config(work).evolve(train=dict(step_timeout_s=CHAOS_TIMEOUT_S, **CHAOS_SENTINEL))
    record, guarded, actions, fired = [], [], [], []

    def guarded_step(self, minibatch):
        before = chaos_state(self)
        out = step(self, minibatch)
        if out["train/skipped_updates"]:
            guarded.append((self.iter_count, out["train/grad_global_norm"], same_state(before, chaos_state(self))))
        return out

    with ppo_probes(record, names=("make_experience", "score", "evaluate", "train_minibatch")):
        step = PPOTrainer.train_minibatch  # the probe's
        PPOTrainer.train_minibatch = guarded_step
        try:
            trainer = PPOTrainer(config, reward_fn=ppo_reward)
            max_prompt = config.train.seq_length - PPO_NEW
            trainer.add_prompt_pipeline(PromptPipeline(ppo_prompts(), max_prompt, trainer.tokenizer))
            trainer.add_eval_pipeline(PromptPipeline(ppo_prompts()[:PPO_BATCH], max_prompt, trainer.tokenizer))
            trainer.fault_injector = FaultInjector(**CHAOS_FAULTS)
            trainer._watchdog_on_timeout = lambda: fired.append((trainer.iter_count, time.perf_counter()))
            observe = trainer._sentinel.observe_step

            def observing(stats, s):
                verdict = observe(stats, s)
                actions.append((s, verdict.action))
                return verdict

            trainer._sentinel.observe_step = observing
            trainer.learn()
        finally:
            PPOTrainer.train_minibatch = step
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    sen = trainer._sentinel
    steps = [c for c in record if c[0] == "train_minibatch"]
    chunks = [c for c in record if c[0] == "score"]
    rows = metric_rows(work, "losses/total_loss")
    faulted = sorted(CHAOS_FAULTS["nan_grad_steps"] + CHAOS_FAULTS["loss_spike_steps"])
    log(f"[chaos] gpt2-small PPO (phase 9's configuration) with the sentinel: actions that were not ok "
        f"{[a for a in actions if a[1] != 'ok']}; skipped steps (iter_count before, global norm, state bitwise "
        f"unchanged) {guarded}; rewinds {sen.rewinds_used} to last_good {sen.last_good}; watchdog fired at "
        f"{[f[0] for f in fired]}; {len(steps)} optimizer steps ({trainer.iter_count} counted), {len(chunks)} "
        f"collections, quarantined rows {sen.quarantined_rows}, final loss {rows[-1]['losses/total_loss']:.6f}; "
        f"{wall:.1f} s ({card})")
    bad_launches = [c[3] for c in steps if c[3] != PPO_KERNELS_PER_STEP] + \
        [c[3] for c in chunks if c[3] != PPO_KERNELS_PER_CHUNK]
    nan_norms = [n for s, n, _ in guarded if s in CHAOS_FAULTS["nan_grad_steps"]]
    spike_norms = [n for s, n, _ in guarded if s in CHAOS_FAULTS["loss_spike_steps"]]
    if [s for s, _, _ in guarded] != faulted or not all(ok for _, _, ok in guarded):
        raise AssertionError(f"[chaos] skipped {guarded}, expected the faulted steps {faulted} with state unchanged")
    if any(math.isfinite(n) for n in nan_norms) or not all(math.isfinite(n) and n > 1e3 for n in spike_norms):
        raise AssertionError(f"[chaos] NaN step norms {nan_norms}, spike norms {spike_norms}")
    hang = CHAOS_FAULTS["hang_steps"]
    if sen.rewinds_used != 1 or trainer.iter_count != 2 * 4 * (PPO_ROLLOUTS // PPO_BATCH) or \
            [f[0] for f in fired] != hang:
        raise AssertionError(f"[chaos] rewinds {sen.rewinds_used}, steps {trainer.iter_count}, watchdog {fired}")
    if bad_launches or not math.isfinite(rows[-1]["losses/total_loss"]) or sen.skipped_updates != len(faulted):
        raise AssertionError(f"[chaos] launches {bad_launches[:2]}, final loss {rows[-1]['losses/total_loss']}, "
                             f"skipped {sen.skipped_updates}")
    launches = {k: v * len(steps) for k, v in PPO_KERNELS_PER_STEP.items()}
    for k, v in PPO_KERNELS_PER_CHUNK.items():
        launches[k] = launches.get(k, 0) + v * len(chunks)
    out = dict(actions=[a for a in actions if a[1] != "ok"], skipped=[(s, n) for s, n, _ in guarded],
               rewinds=sen.rewinds_used, last_good_step=sen.last_good["step"], watchdog_fired_at=[f[0] for f in fired],
               steps_run=len(steps), collections=len(chunks), wall_s=wall)
    del trainer
    shutil.rmtree(work, ignore_errors=True)  # the pins and checkpoints: gigabytes
    release()
    log(f"[chaos] (c) took {wall:.1f} s")
    return launches, out


def resume_config(work):
    from trlx_tpu_torch.data.default_configs import default_ppo_config

    return default_ppo_config().evolve(
        train=dict(seq_length=1024, batch_size=RESUME_BATCH, epochs=2, total_steps=1000, eval_interval=10000,
                   checkpoint_interval=10000, checkpoint_dir=str(work / "ckpts"), logging_dir=str(work / "logs"),
                   auto_resume=True, sentinel=True, sentinel_zscore=50.0),
        model=dict(model_path="random:gpt2-small", num_layers_unfrozen=2,
                   model_extra_configs={"vocab_size": 50257, "attn_impl": "flash", "n_layers": 4}),
        method=dict(num_rollouts=RESUME_ROLLOUTS, chunk_size=RESUME_ROLLOUTS, ppo_epochs=2,
                    gen_kwargs=dict(max_new_tokens=PPO_NEW, top_k=0, top_p=1.0, do_sample=True,
                                    suppress_tokens=PPO_SUPPRESS)),
    )


def resume_trainer(work):
    from trlx_tpu_torch.pipeline.offline_pipeline import PromptPipeline
    from trlx_tpu_torch.trainer.ppo_trainer import PPOTrainer

    config = resume_config(work)
    trainer = PPOTrainer(config, reward_fn=ppo_reward)
    max_prompt = config.train.seq_length - PPO_NEW
    trainer.add_prompt_pipeline(PromptPipeline(ppo_prompts(64), max_prompt, trainer.tokenizer))
    trainer.add_eval_pipeline(PromptPipeline(ppo_prompts(8), max_prompt, trainer.tokenizer))
    return trainer


def auto_resume_child(work):
    """The preempted run of (d), in its own process: after step
    RESUME_PREEMPT_AT it writes `ready` and waits for the SIGTERM that the
    parent sends, which ends the run at that step boundary (exit 75)."""
    work = Path(work)
    trainer = resume_trainer(work)
    step = trainer.train_minibatch

    def waiting(minibatch):
        out = step(minibatch)
        if trainer.iter_count + 1 == RESUME_PREEMPT_AT:
            (work / "ready").write_text(str(RESUME_PREEMPT_AT))
            deadline = time.monotonic() + 120
            while not trainer._preemption_guard.triggered and time.monotonic() < deadline:
                time.sleep(0.02)
        return out

    trainer.train_minibatch = waiting
    trainer.learn()


def phase_auto_resume(card):
    """(d) At 4 layers (gpt2-small width, bf16, sampled rollouts): two
    uninterrupted runs, to measure whether the card repeats a run
    bitwise; a run in its own process, sent SIGTERM after step 6, exits
    75; a new trainer with auto_resume and no explicit path continues from
    its `_preempt` checkpoint, and ends with the uninterrupted run's
    parameters, bitwise when the card repeats bitwise, else within the
    repeat spread."""
    import shutil
    import signal

    import torch

    t0 = time.perf_counter()
    base = ROOT / "build" / "chip_smoke_resume"
    if base.exists():
        shutil.rmtree(base)
    finals = []
    for tag in ("a", "b"):
        trainer = resume_trainer(base / tag)
        trainer.learn()
        finals.append({k: v.detach().clone() for k, v in trainer.model.state_dict().items()})
        steps = trainer.iter_count
        del trainer
        release()
    spread = max(float((finals[0][k].float() - finals[1][k].float()).abs().max()) for k in finals[0])
    run = base / "run"
    run.mkdir(parents=True)
    code = RESUME_CHILD.format(root=str(ROOT), run=str(run))
    log_path = run / "child.log"
    with open(log_path, "w") as log_file:
        child = subprocess.Popen([sys.executable, "-c", code], cwd=str(ROOT), stdout=log_file,
                                 stderr=subprocess.STDOUT)
        try:
            wait_for(lambda: (run / "ready").exists() or child.poll() is not None, "the child's step 6")
            child.send_signal(signal.SIGTERM)
            rc = child.wait(timeout=300)
        finally:
            if child.poll() is None:
                child.kill()
    preempt = sorted(p.name for p in (run / "ckpts").iterdir())
    if rc != 75 or not any(p.endswith("_preempt") for p in preempt):
        raise AssertionError(f"[resume] the child exited {rc}, checkpoints {preempt}: "
                             f"{log_path.read_text()[-3000:]}")
    trainer = resume_trainer(run)
    loaded, load = [], trainer.load
    trainer.load = lambda path: (loaded.append(Path(path).name), load(path))[1]
    trainer.learn()
    resumed = {k: v.detach() for k, v in trainer.model.state_dict().items()}
    diff = max(float((finals[0][k].float() - resumed[k].float()).abs().max()) for k in resumed)
    bitwise_repeat = spread == 0.0
    log(f"[resume] gpt2-small width, 4 layers, bf16, PPO {RESUME_ROLLOUTS} sampled rollouts x 2 collections, "
        f"{steps} steps: two uninterrupted runs {'bitwise equal' if bitwise_repeat else f'differ by {spread:.3g}'}; "
        f"the run in its own process exited {rc} on SIGTERM after step {RESUME_PREEMPT_AT} ({preempt}); a new "
        f"trainer with auto_resume loaded {loaded} and ended at step {trainer.iter_count} with parameters "
        f"{'bitwise equal to' if diff == 0 else f'within {diff:.3g} of'} the uninterrupted run's ({card})")
    if loaded != [f"checkpoint_{RESUME_PREEMPT_AT:0{len(str(steps))}d}_preempt"] or trainer.iter_count != steps:
        raise AssertionError(f"[resume] loaded {loaded}, ended at {trainer.iter_count}")
    if diff > spread:
        raise AssertionError(f"[resume] resumed run differs by {diff}, the repeat spread is {spread}")
    del trainer
    shutil.rmtree(base, ignore_errors=True)
    release()
    out = dict(bitwise_repeat=bitwise_repeat, repeat_spread=spread, resumed_diff=diff, child_exit=rc, steps=steps,
               seconds=time.perf_counter() - t0)
    log(f"[resume] (d) took {out['seconds']:.1f} s")
    return out


def phase_drain(card):
    """(e) `python -m trlx_tpu_torch.inference.serve_policy` serving
    random:gpt2-small on the card: SIGTERM with 8 requests of 256 tokens
    in flight; all 8 reply in full, a new request answers 503 with
    Retry-After, and the process exits 0."""
    import signal
    import socket

    t0 = time.perf_counter()
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    hparams = {"checkpoint": "random:gpt2-small", "port": port, "device": SUBPROCESS_DEVICE,
               "model.model_extra_configs": {"vocab_size": 50257},
               "inference.max_new_tokens": DRAIN_NEW, "inference.num_slots": DRAIN_REQUESTS,
               "inference.gen_kwargs": {"max_new_tokens": DRAIN_NEW, "min_new_tokens": DRAIN_NEW}}
    work = ROOT / "build" / "chip_smoke_drain"
    work.mkdir(parents=True, exist_ok=True)
    log_path = work / "serve.log"
    url = f"http://127.0.0.1:{port}"
    replies = [None] * DRAIN_REQUESTS
    with open(log_path, "w") as log_file:
        proc = subprocess.Popen([sys.executable, "-m", "trlx_tpu_torch.inference.serve_policy", json.dumps(hparams)],
                                cwd=str(ROOT), stdout=log_file, stderr=subprocess.STDOUT)
        try:
            def up():
                try:
                    return http(url, "/healthz", timeout=2)[1].get("ready")
                except (urllib.error.URLError, ConnectionError, OSError):
                    return proc.poll() is not None
            boot_s = wait_for(up, "the policy server")
            prompts = [list(p.encode()) for p in ppo_prompts(DRAIN_REQUESTS, seed=9)]
            with ThreadPoolExecutor(DRAIN_REQUESTS) as pool:
                futures = [pool.submit(http, url, "/generate", {"prompt_ids": p, "max_new_tokens": DRAIN_NEW})
                           for p in prompts]
                wait_for(lambda: http(url, "/healthz")[1].get("slots_active", 0) >= DRAIN_REQUESTS,
                         "8 requests in flight")
                proc.send_signal(signal.SIGTERM)
                t_term = time.perf_counter()
                time.sleep(0.1)
                req = urllib.request.Request(url + "/generate", headers={"Content-Type": "application/json"},
                                             data=json.dumps({"prompt_ids": prompts[0], "max_new_tokens": 4}).encode())
                try:
                    with urllib.request.urlopen(req, timeout=30) as r:
                        rejected = (r.status, dict(r.headers))
                except urllib.error.HTTPError as e:
                    rejected = (e.code, dict(e.headers))
                replies = [f.result() for f in futures]
            drained_s = time.perf_counter() - t_term
            rc = proc.wait(timeout=120)
            exit_s = time.perf_counter() - t_term
        finally:
            if proc.poll() is None:
                proc.kill()
    full = [code == 200 and len(body["token_ids"]) == DRAIN_NEW and body["finish_reason"] != "shutdown"
            for code, body in replies]
    log(f"[drain] serve_policy (gpt2-small, the card) up in {boot_s:.1f} s; SIGTERM with {DRAIN_REQUESTS} requests of "
        f"{DRAIN_NEW} tokens in flight: {sum(full)}/{DRAIN_REQUESTS} complete replies within {drained_s:.2f} s, a new "
        f"request answered {rejected[0]} (Retry-After {rejected[1].get('Retry-After')}), the process exited {rc} "
        f"{exit_s:.2f} s after the signal ({card})")
    if not all(full) or rejected[0] != 503 or not rejected[1].get("Retry-After") or rc != 0:
        raise AssertionError(f"[drain] replies {full}, new request {rejected}, exit {rc}: {log_path.read_text()[-2000:]}")
    out = dict(boot_s=boot_s, complete=sum(full), rejected=rejected[0], exit_code=rc, drained_s=drained_s,
               seconds=time.perf_counter() - t0)
    log(f"[drain] (e) took {out['seconds']:.1f} s")
    return out


def phase_resilience_methods(card):
    """Phase 19. Returns ({part: launches}, numbers)."""
    t0 = time.perf_counter()
    launches, out = {}, {}
    rm, tokenizer, launches["rm"], out["rm"] = phase_reward_model(card)
    bon_launches, out["bon"] = phase_bon(card, rm, tokenizer)
    launches.update({f"bon_{k}": v for k, v in bon_launches.items()})
    del rm
    release()
    launches["chaos"], out["chaos"] = phase_chaos(card)
    out["auto_resume"] = phase_auto_resume(card)
    out["drain"] = phase_drain(card)
    out["seconds"] = time.perf_counter() - t0
    log(f"[phase19] took {out['seconds']:.1f} s")
    return launches, out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from trlx_tpu_torch import kernels  # fails outside a checkout of the repository

    started = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    card = card_line()
    log(f"[card] {card} | torch {torch.__version__} cuda {torch.version.cuda} | {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    build_logs = kernels.build(kernels.all_sources())
    log(f"[build] {kernels.all_sources()} in {time.perf_counter() - t0:.1f}s")
    for name, out in build_logs.items():
        for line in build_report(out):
            log(f"[build] {name}: {line}")

    timings, errs = phase_kernels(device)
    launches_bf16, serve_bf16 = serve_and_check(serving_config(), 16, "paged_decode", card)
    launches_int8, _ = serve_and_check(serving_config(kv_cache_dtype="int8"), 8, "paged_decode_int8", card)
    phase_greedy()
    train_timings, train_errs = phase_train_kernels(device)
    train_launches, _ = phase_train(card)
    phase_grad_check()
    ppo_launches, ppo_metrics = phase_ppo(card)
    phase_ppo_grad_check()
    options_launches, options = phase_ppo_options(card, ppo_metrics)
    pipelined, pipelined_launches, pipelined_errs = phase_pipelined(card, ppo_metrics, options)
    branch_launches, branch = phase_value_branch(card, ppo_metrics)
    ilql_launches, ilql = phase_ilql(card)
    grpo_launches, grpo = phase_grpo(card, ppo_metrics)
    rft_launches, rft = phase_rft(card)
    serving_launches, serving = phase_serving_features(card, serve_bf16)
    fleet_launches, fleet = phase_fleet(card, ppo_metrics, grpo["runs"]["grpo"])
    p19_launches, p19 = phase_resilience_methods(card)

    main_bf16, main_int8 = timings[("gpt2-small", "bf16")], timings[("gpt2-small", "int8")]
    source = "trlx_tpu_torch/csrc/paged_attention.cu"
    held = "phase 3: kernel vs plain version on the card"
    report = {"kernels": [
        dict(name="paged_decode", route="cuda", source=source,
             replaces="trlx_tpu/ops/paged_attention.py:50", launches=launches_bf16,
             launches_ppo=ppo_launches.get("paged_decode", 0),
             launches_ppo_options=options_launches.get("paged_decode", 0),
             launches_pipelined={t: n.get("paged_decode", 0) for t, n in pipelined_launches.items()},
             launches_value_branch={t: n.get("paged_decode", 0) for t, n in branch_launches.items()},
             launches_ilql=ilql_launches.get("paged_decode", 0),
             launches_grpo={t: n.get("paged_decode", 0) for t, n in grpo_launches.items()},
             launches_rft=rft_launches.get("paged_decode", 0),
             launches_serving={t: n.get("paged_decode", 0) for t, n in serving_launches.items()},
             launches_fleet={t: n.get("paged_decode", 0) for t, n in fleet_launches.items()},
             launches_phase19={t: n.get("paged_decode", 0) for t, n in p19_launches.items()},
             max_abs_err=errs["paged_decode"], held_against_plain_in=held, **main_bf16),
        dict(name="paged_decode_int8", route="cuda", source=source,
             replaces="trlx_tpu/ops/paged_attention.py:110", launches=launches_int8,
             launches_ppo=ppo_launches.get("paged_decode_int8", 0),
             launches_ppo_options=options_launches.get("paged_decode_int8", 0),
             launches_pipelined={t: n.get("paged_decode_int8", 0) for t, n in pipelined_launches.items()},
             launches_value_branch={t: n.get("paged_decode_int8", 0) for t, n in branch_launches.items()},
             launches_ilql=ilql_launches.get("paged_decode_int8", 0),
             launches_grpo={t: n.get("paged_decode_int8", 0) for t, n in grpo_launches.items()},
             launches_rft=rft_launches.get("paged_decode_int8", 0),
             launches_serving={t: n.get("paged_decode_int8", 0) for t, n in serving_launches.items()},
             launches_fleet={t: n.get("paged_decode_int8", 0) for t, n in fleet_launches.items()},
             launches_phase19={t: n.get("paged_decode_int8", 0) for t, n in p19_launches.items()},
             max_abs_err=errs["paged_decode_int8"], held_against_plain_in=held, **main_int8),
    ]}
    train_rows = [
        ("flash_fwd", "trlx_tpu_torch/csrc/flash_attention.cu", "trlx_tpu/ops/attention.py:207"),
        ("flash_fwd_lse", "trlx_tpu_torch/csrc/flash_attention.cu", "trlx_tpu/ops/attention.py:361"),
        ("flash_bwd_dq", "trlx_tpu_torch/csrc/flash_attention.cu", "trlx_tpu/ops/attention.py:496"),
        ("flash_bwd_dkv", "trlx_tpu_torch/csrc/flash_attention.cu", "trlx_tpu/ops/attention.py:532"),
        ("label_logprobs", "trlx_tpu_torch/csrc/fused_ce.cu", "trlx_tpu/ops/fused_ce.py:50"),
        # the gradient the JAX package leaves to XLA (`_fused_bwd`, no Pallas kernel)
        ("label_logprobs_bwd", "trlx_tpu_torch/csrc/fused_ce.cu", "trlx_tpu/ops/fused_ce.py:197"),
    ]
    for name, src, replaces in train_rows:
        # the times at phase 9's shapes: K3 when scoring, K4-K6 in a step,
        # K7 at both, at phase 12's fast-scorer window and at phase 13's
        # full-forward step, its backward in a step; K4-K6 at phase 14's
        ppo_shapes = [s for s in CE_PPO if (name, s) in train_timings]
        report["kernels"].append(dict(
            name=name, route="cuda", source=src, replaces=replaces, launches=train_launches[name],
            launches_ppo=ppo_launches.get(name, 0), launches_ppo_options=options_launches.get(name, 0),
            launches_pipelined={t: n.get(name, 0) for t, n in pipelined_launches.items()},
            launches_value_branch={t: n.get(name, 0) for t, n in branch_launches.items()},
            launches_ilql=ilql_launches.get(name, 0),
            launches_grpo={t: n.get(name, 0) for t, n in grpo_launches.items()},
            launches_rft=rft_launches.get(name, 0),
            launches_fleet={t: n.get(name, 0) for t, n in fleet_launches.items()},
            launches_phase19={t: n.get(name, 0) for t, n in p19_launches.items()},
            max_abs_err=train_errs[name],
            held_against_plain_in="phase 6: kernel vs plain version on the card",
            **train_timings[(name, "gpt2-small")], ppo={s: train_timings[(name, s)] for s in ppo_shapes},
            ilql=train_timings.get((name, "ilql-train")), randomwalks=train_timings.get((name, "randomwalks"))))
    # phase 11's checks: the exact launch counts (K3 none a step, 24 a
    # chunk), no fallback, greedy speculative vs plain under the tie rule,
    # the trunk cache against the full path; and its numbers
    report["ppo_options"] = dict(
        kernels_per_step=PPO_OPT_KERNELS_PER_STEP, kernels_per_chunk=PPO_OPT_KERNELS_PER_CHUNK,
        tie_gap=TIE_GAP, cache_loss_tol={"f32": CACHE_F32_LOSS_TOL, "bf16": CACHE_BF16_LOSS_TOL},
        grad_tol=GRAD_TOL, **options)
    # phase 12's checks (exact launches a chunk and a step, no fallback, the
    # f32 agreement) and numbers, by configuration
    report["pipelined"] = dict(
        configs={t: PIPELINED[t] for t in PIPELINED}, kernels_per_chunk=PIPELINED_PER_CHUNK,
        kernels_per_step=PIPELINED_PER_STEP, timed_cycles=PIPELINED_CYCLES, f32_max_abs_err=pipelined_errs,
        f32_tol={"fast": FAST_TOL, "merge": MERGE_TOL}, **pipelined)
    # phase 13's and 14's checks and numbers
    report["value_branch"] = branch
    report["ilql"] = dict(kernels_per_step=ILQL_KERNELS_PER_STEP, steps=ILQL_STEPS, target_sync=ILQL_SYNC, **ilql)
    # phase 15's and 16's
    report["grpo"] = grpo
    report["rft"] = rft
    # phase 17's checks and numbers
    report["serving"] = serving
    # phase 18's
    report["fleet"] = fleet
    # phase 19's: the reward model, reward serving and best-of-n, the
    # sentinel's chaos run, auto_resume and the drain
    report["phase19"] = p19
    report["seconds"] = time.perf_counter() - started
    log(f"[smoke] every phase passed in {report['seconds']:.1f} s ({card})")
    print(json.dumps(report), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
