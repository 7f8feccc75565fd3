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
   out-of-range labels, at [128 x 104, 50257] on shifted labels and at
   [32 x 40, 50257], and its backward kernel at [8184, 50257] (g = 0 on
   the masked rows, which must come out all zeros) and [32 x 40, 50257];
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
   within 1e-5, the loss and gradients within phase 8's tolerances).

The line before the last is the card's name and power limit; the line
before that is the `kernels` JSON object; the last line is
`{"ok": true, "device": {...}}`. Exits non-zero without a CUDA device, and
outside a checkout of the repository.
"""

import json
import math
import statistics
import subprocess
import sys
import time
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
        inference=dict(
            kv_paging=True, kv_block_size=32, num_slots=8, max_new_tokens=64,
            decode_kernel="auto", gen_kwargs=dict(max_new_tokens=64), **inference,
        ),
    )


def post(url, payload):
    req = urllib.request.Request(url + "/generate", data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.status, json.loads(r.read())


def serve_and_check(config, n_requests, counter, card):
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
            replies = list(pool.map(lambda j: post(server.url, j), jobs))
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
    if dispatches <= 0 or stats["kv_kernel_fallbacks"] != {}:
        raise AssertionError(f"kernel not on the decode path: {stats}")
    if launches.get(counter, 0) != dispatches * n_layers:
        raise AssertionError(f"{counter} launches {launches} != {dispatches} dispatches x {n_layers} layers")
    # every token is emitted by a decode step (the first one was sampled at
    # prefill): tokens_per_s is end to end over the burst's wall time,
    # decode_tok_per_s over the decode steps' time alone
    tokens = sum(len(o["token_ids"]) for _, o in replies)
    ttft = statistics.median(o["ttft_s"] for _, o in replies)
    log(
        f"[serve] kv={config.inference.kv_cache_dtype} requests={n_requests} tokens={tokens} "
        f"wall_s={wall:.3f} tokens_per_s={tokens / wall:.1f} decode_s={decode_s:.3f} "
        f"decode_tok_per_s={tokens / decode_s:.1f} median_ttft_s={ttft:.4f} "
        f"dispatches={dispatches} launches={launches} ({card})"
    )
    del trainer, server
    torch.cuda.empty_cache()
    return launches.get(counter, 0)


# ---------------------------------------------------------------------------
# Phase 5: greedy equality kernel vs gather path
# ---------------------------------------------------------------------------

def run_serial(engine, prompts, max_new, slot=0):
    import numpy as np

    outs = []
    for p in prompts:
        engine.insert_requests([(np.asarray(p, np.int32), max_new)], [slot])
        toks = []
        for _ in range(max_new):
            t, _, v, f = engine.step()
            if v[slot]:
                toks.append(int(t[slot]))
            if f[slot]:
                break
        engine.reclaim_slots([slot])
        outs.append(toks)
    return outs


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
    rng = np.random.RandomState(2)
    prompts = [rng.randint(0, 256, n).tolist() for n in (7, 31, 32, 33, 64, 100)]

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
    torch.cuda.empty_cache()


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
# phase 9 runs at them: K3 when scoring 128 rows, K4-K6 in a 32-row step.
ALL_FLASH = ("flash_fwd", "flash_fwd_lse", "flash_bwd_dq", "flash_bwd_dkv")
FLASH_SHAPES = {
    "gpt2-small": (8, 1024, 12, 12, 64, left_pad_rows(1024, [0, 0, 17, 100, 256, 511, 700, 1024]), ALL_FLASH),
    "llama-7b": (1, 2048, 32, 32, 128, left_pad_rows(2048, [0]), ALL_FLASH),
    "gqa": (1, 2048, 32, 8, 128, left_pad_rows(2048, [0]), ALL_FLASH),
    "ppo-score": (128, PPO_T, 12, 12, 64, ppo_mask_rows(128), ("flash_fwd",)),
    "ppo-train": (32, PPO_T, 12, 12, 64, ppo_mask_rows(32), ALL_FLASH[1:]),
}
CE_ROWS, CE_VOCAB = 8 * 1023, 50257
# K7 at phase 9's shapes: scoring reads the full [128, 104, V] logits with
# the labels shifted one column; a step reads the [32, 40, V] window
CE_PPO = {"ppo-score": (128, PPO_T), "ppo-train": (32, 40)}
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


def check_ce_bwd(note, logits, labels, g, shape):
    """K7's backward against its plain version on the kernel's own lse;
    returns (max abs err, lse)."""
    import torch

    from trlx_tpu_torch.ops.fused_ce import label_logprobs, label_logprobs_bwd, label_logprobs_bwd_plain

    _, lse = label_logprobs(logits, labels)
    got = label_logprobs_bwd(logits, labels, lse, g)
    torch.cuda.synchronize()
    if not bool((got[g == 0] == 0).all()):
        raise AssertionError(f"label_logprobs_bwd {shape}: a row with g = 0 is not all zeros")
    e = note("label_logprobs_bwd", got, label_logprobs_bwd_plain(logits, labels, lse, g), CE_BWD_TOL)
    log(f"[train-kernels] label_logprobs_bwd {shape} {list(logits.shape)} bf16: max_abs_err dlogits = {e:.3g}")
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
        if shape == "ppo-score":
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
        if shape == "ppo-train":  # a step's backward over the window
            x, lab = logits.view(n, CE_VOCAB), tokens.view(n).to(torch.int32)
            g = torch.randn(n, generator=gen, device=device)
            lse = check_ce_bwd(note, x, lab, g, shape)
            results[("label_logprobs_bwd", shape)] = ce_bwd_times(x, lab, lse, g)
            del x, lab, g, lse
        del logits, tokens, got
        torch.cuda.empty_cache()
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
    torch.cuda.empty_cache()
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
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 9: PPO (the third main path)
# ---------------------------------------------------------------------------

PPO_EPOCHS, PPO_ROLLOUTS, PPO_BATCH = 2, 128, 32
PPO_STEPS = PPO_EPOCHS * 4 * (PPO_ROLLOUTS // PPO_BATCH)  # epochs x ppo_epochs x loader length
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


def ppo_config(work, **model_extra):
    from trlx_tpu_torch.data.default_configs import default_ppo_config

    return default_ppo_config().evolve(
        train=dict(seq_length=1024, batch_size=PPO_BATCH, epochs=PPO_EPOCHS, eval_interval=16,
                   checkpoint_dir=str(work / "ckpts"), logging_dir=str(work / "logs")),
        model=dict(model_path="random:gpt2-small", num_layers_unfrozen=2,
                   model_extra_configs={"vocab_size": 50257, "attn_impl": "flash", **model_extra}),
        method=dict(num_rollouts=PPO_ROLLOUTS, chunk_size=PPO_ROLLOUTS, ppo_epochs=4,
                    gen_kwargs=dict(max_new_tokens=PPO_NEW, top_k=0, top_p=1.0, do_sample=True,
                                    suppress_tokens=PPO_SUPPRESS)),
    )


@contextmanager
def ppo_probes(record):
    """Wrap PPOTrainer's collection, scoring, evaluation and optimizer step
    to record each call's wall time and its kernel launches, and after a
    collection the response lengths in the store: measurement of this
    script, the trainer is unchanged."""
    import torch

    from trlx_tpu_torch import kernels
    from trlx_tpu_torch.trainer.ppo_trainer import PPOTrainer

    originals = {name: getattr(PPOTrainer, name) for name in ("make_experience", "score", "evaluate",
                                                              "train_minibatch")}

    def probe(name):
        fn = originals[name]

        def wrapped(self, *args, **kwargs):
            torch.cuda.synchronize()
            before, t0 = dict(kernels.LAUNCHES), time.perf_counter()
            out = fn(self, *args, **kwargs)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            launched = {k: v - before.get(k, 0) for k, v in kernels.LAUNCHES.items() if v - before.get(k, 0)}
            lengths = [len(e.response_tensor) for e in self.store.history] if name == "make_experience" else None
            record.append((name, t0, t1, launched, lengths))
            return out

        return wrapped

    try:
        for name in originals:
            setattr(PPOTrainer, name, probe(name))
        yield
    finally:
        for name, fn in originals.items():
            setattr(PPOTrainer, name, fn)


def phase_ppo(card):
    import shutil

    import torch

    import trlx_tpu_torch
    from trlx_tpu_torch import kernels
    from trlx_tpu_torch.trainer.ppo_trainer import PPOTrainer

    work = ROOT / "build" / "chip_smoke_ppo"
    if work.exists():
        shutil.rmtree(work)
    config = ppo_config(work)
    record = []
    kernels.reset_launches()
    t0 = time.perf_counter()
    with ppo_probes(record):
        trainer = trlx_tpu_torch.train(reward_fn=ppo_reward, prompts=ppo_prompts(), config=config)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    rows = [json.loads(line) for line in next((work / "logs").glob("*.metrics.jsonl")).read_text().splitlines()]
    collections = [r for r in rows if "time/rollout_generate" in r]
    steps = [r for r in rows if "losses/total_loss" in r]
    evals = [r for r in rows if "reward/mean" in r]
    calls = lambda name: [c for c in record if c[0] == name]
    scores, step_calls = calls("score"), calls("train_minibatch")
    lengths = [c[4] for c in calls("make_experience")]

    for i, (r, (_, s0, s1, *_), n) in enumerate(zip(collections, scores, lengths)):
        log(f"[ppo] collection {i + 1}: generate_s={r['time/rollout_generate'] / 1e3:.4f} "
            f"rollout_tokens_per_s={r['throughput/rollout_tokens_per_s']:.1f} score_s={s1 - s0:.4f} "
            f"stored responses {len(n)}, tokens min/mean/max {min(n)}/{statistics.mean(n):.2f}/{max(n)} "
            f"reward_fn_s={r['time/rollout_score'] / 1e3:.4f} policy/sqrt_kl={r['policy/sqrt_kl']:.6f}")
    for r in steps:
        log(f"[ppo] step {r['_step']}: total_loss={r['losses/total_loss']:.6f} "
            f"policy_loss={r['losses/policy_loss']:.6f} value_loss={r['losses/value_loss']:.6f} "
            f"approx_kl={r['policy/approx_kl']:.3g} step_s={r['time/train_step_s']:.4f} "
            f"train_tokens_per_s={r['throughput/train_tokens_per_s']:.1f}")
    for r in evals:
        log(f"[ppo] eval at step {r['_step']}: reward/mean={r['reward/mean']:.5f} "
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
    step_s = statistics.median(r["time/train_step_s"] for r in steady)
    tok_s = statistics.median(r["throughput/train_tokens_per_s"] for r in steady)
    log(f"[ppo] gpt2-small PPO, {PPO_ROLLOUTS} rollouts x {len(collections)} collections, batch {PPO_BATCH}, "
        f"ppo_epochs 4, {PPO_NEW} new tokens, bf16 flash, num_layers_unfrozen=2: {len(steps)} steps in {wall:.2f}s wall; "
        f"median step_s={step_s:.4f} train_tokens_per_s={tok_s:.1f}; samples_per_s per cycle="
        f"{[round(x, 2) for x in samples_per_s]}; launches={launches} ({card})")

    losses = [r[k] for r in steps for k in ("losses/total_loss", "losses/policy_loss", "losses/value_loss")]
    if len(steps) != PPO_STEPS or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"expected {PPO_STEPS} steps of finite losses, got {len(steps)}: {losses}")
    if len(collections) != PPO_EPOCHS or len(scores) != PPO_EPOCHS or len(evals) != 3:
        raise AssertionError(f"expected {PPO_EPOCHS} collections and 3 evaluations, got {len(collections)}, "
                             f"{len(scores)} scoring passes, {len(evals)}")
    if [len(n) for n in lengths] != [PPO_ROLLOUTS] * PPO_EPOCHS or any(set(n) != {PPO_NEW} for n in lengths):
        raise AssertionError(f"expected {PPO_ROLLOUTS} stored responses of {PPO_NEW} tokens a collection, got "
                             f"{[(len(n), min(n), max(n)) for n in lengths]}")
    for name, got, want in [("step", c[3], PPO_KERNELS_PER_STEP) for c in step_calls] + \
            [("scoring chunk", c[3], PPO_KERNELS_PER_CHUNK) for c in scores]:
        if got != want:
            raise AssertionError(f"a {name} launched {got}, expected {want}")
    want = {n: PPO_STEPS * PPO_KERNELS_PER_STEP.get(n, 0) + PPO_EPOCHS * PPO_KERNELS_PER_CHUNK.get(n, 0)
            for n in PPO_KERNELS_PER_STEP}
    got = {n: launches.get(n, 0) for n in want}
    if got != want or any(v for k, v in launches.items() if k not in want):
        raise AssertionError(f"PPO launches {launches} != {want}")

    # the `done` checkpoint loads into a fresh trainer with the same state
    directory = work / "ckpts" / f"checkpoint_{PPO_STEPS}"
    fresh = PPOTrainer(config, reward_fn=ppo_reward)
    fresh.load(str(directory))
    same = all(torch.equal(a, b) for m, f in ((trainer.model, fresh.model), (trainer.ref_model, fresh.ref_model))
               for a, b in zip(m.state_dict().values(), f.state_dict().values()))
    same = same and fresh.kl_ctl.value == trainer.kl_ctl.value and fresh.mean_kl == trainer.mean_kl
    same = same and all(getattr(fresh.running_moments, k) == getattr(trainer.running_moments, k)
                        for k in ("mean", "std", "var", "count"))
    same = same and len(fresh.store) == len(trainer.store) and all(
        (a.response_tensor == b.response_tensor).all() and (a.rewards == b.rewards).all()
        for a, b in zip(fresh.store.history, trainer.store.history))
    if not same or fresh.iter_count != PPO_STEPS:
        raise AssertionError("the done checkpoint did not load back with the same state")
    kept = sorted(p.name for p in (work / "ckpts").iterdir())
    log(f"[ppo] checkpoint {directory.name} loads into a fresh PPOTrainer: policy and reference parameters, "
        f"KL value, running moments and store equal; checkpoint dir holds {kept}")
    del trainer, fresh
    torch.cuda.empty_cache()
    return launches, dict(step_s=step_s, train_tokens_per_s=tok_s, samples_per_s=samples_per_s, wall_s=wall)


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
# plain run's gate (the ReLU's on/off pattern) as fixed: relu(x) = x * gate
# in value and in gradient at the plain run's gate, and every element of
# every trainable gradient is held to GRAD_TOL.


def ppo_step_grads(trainer, batch, gate=None):
    """(loss, trainable gradients, the value head's ReLU gate) of one PPO
    step's loss; with `gate` given, the head applies it in place of its
    own ReLU's."""
    head, used = trainer.model.v_head, []

    def stash(mod, args, out):
        used.append((out, out > 0 if gate is None else gate))

    def gated(mod, args):
        pre, g = used[-1]
        return (pre * g,)

    hooks = [head.dense_in.register_forward_hook(stash), head.dense_out.register_forward_pre_hook(gated)]
    try:
        trainer.model.zero_grad(set_to_none=True)
        loss, _ = trainer.make_loss_fn()(trainer.batch_to_device(batch))
        loss.backward()
    finally:
        for hook in hooks:
            hook.remove()
    grads = {n: p.grad.detach().clone() for n, p in trainer.model.named_parameters() if p.requires_grad}
    return float(loss.detach()), grads, used[0][0].detach() > 0


def phase_ppo_grad_check():
    import numpy as np
    import torch

    from trlx_tpu_torch import kernels
    from trlx_tpu_torch.trainer.ppo_trainer import PPOTrainer

    config = ppo_config(ROOT / "build" / "chip_smoke_ppo_grad", dtype="float32", n_layers=4)
    trainer = PPOTrainer(config, reward_fn=ppo_reward)
    with torch.no_grad():  # a reference apart from the policy, so the KL is not 0
        gen = torch.Generator(device=trainer.device).manual_seed(3)
        for p in trainer.ref_model.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=gen, device=p.device))
    batch = ppo_injected_batch()
    tokens = torch.from_numpy(np.concatenate([batch.query_tensors, batch.response_tensors], 1)).to(trainer.device).long()
    with plain_versions():
        scored_p = trainer.score(tokens)
        loss_p, grads_p, gate_p = ppo_step_grads(trainer, batch)
    kernels.reset_launches()
    scored_k = trainer.score(tokens)
    loss_k, grads_k, gate_k = ppo_step_grads(trainer, batch, gate=gate_p)
    launched = dict(kernels.LAUNCHES)
    errs = []
    for name, a, b in zip(("logprobs", "values", "log_ratio", "mean_kl", "mean_kl_per_token"), scored_k, scored_p):
        torch.testing.assert_close(a, b, **SCORE_TOL, msg=lambda m: f"scoring {name}: {m}")
        errs.append(f"{name} {float((a - b).abs().max()):.3g}")
    if float(scored_k[3]) <= 0:
        raise AssertionError("the perturbed reference gave no KL")
    flips = int((gate_k != gate_p).sum())  # gate entries the kernel run's own ReLU would have set otherwise
    worst = check_grads(grads_k, grads_p)
    if not abs(loss_k - loss_p) <= 1e-5 * abs(loss_p):
        raise AssertionError(f"f32 PPO loss kernels {loss_k} vs plain {loss_p}")
    log(f"[ppo-grad] gpt2-small width, 4 layers, f32, split 2, 32 injected rows t {PPO_T}: scoring max|diff| "
        f"{', '.join(errs)} (tol {SCORE_TOL}); loss kernels={loss_k:.7f} plain={loss_p:.7f}; {len(grads_k)} "
        f"trainable grads, every element held, worst max|diff|/max|g| = {worst:.3g} (tol {GRAD_TOL}); the "
        f"value head ran the plain run's ReLU gate ({flips} of {gate_p.numel()} entries differ from the kernel "
        f"run's own); kernel launches {launched}")
    del trainer
    torch.cuda.empty_cache()


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from trlx_tpu_torch import kernels  # fails outside a checkout of the repository

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
    launches_bf16 = serve_and_check(serving_config(), 16, "paged_decode", card)
    launches_int8 = serve_and_check(serving_config(kv_cache_dtype="int8"), 8, "paged_decode_int8", card)
    phase_greedy()
    train_timings, train_errs = phase_train_kernels(device)
    train_launches, _ = phase_train(card)
    phase_grad_check()
    ppo_launches, _ = phase_ppo(card)
    phase_ppo_grad_check()

    main_bf16, main_int8 = timings[("gpt2-small", "bf16")], timings[("gpt2-small", "int8")]
    source = "trlx_tpu_torch/csrc/paged_attention.cu"
    held = "phase 3: kernel vs plain version on the card"
    report = {"kernels": [
        dict(name="paged_decode", route="cuda", source=source,
             replaces="trlx_tpu/ops/paged_attention.py:50", launches=launches_bf16,
             launches_ppo=ppo_launches.get("paged_decode", 0),
             max_abs_err=errs["paged_decode"], held_against_plain_in=held, **main_bf16),
        dict(name="paged_decode_int8", route="cuda", source=source,
             replaces="trlx_tpu/ops/paged_attention.py:110", launches=launches_int8,
             launches_ppo=ppo_launches.get("paged_decode_int8", 0),
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
        # K7 at both, its backward in a step
        ppo_shapes = [s for s in ("ppo-score", "ppo-train") if (name, s) in train_timings]
        report["kernels"].append(dict(
            name=name, route="cuda", source=src, replaces=replaces, launches=train_launches[name],
            launches_ppo=ppo_launches.get(name, 0), max_abs_err=train_errs[name],
            held_against_plain_in="phase 6: kernel vs plain version on the card",
            **train_timings[(name, "gpt2-small")], ppo={s: train_timings[(name, s)] for s in ppo_shapes}))
    print(json.dumps(report), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
