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
   boundaries plus one inactive row (exactly 0), KV in f32, bf16 and
   int8; with kernel, plain-version, library (scaled_dot_product_attention
   over the gathered KV, a yardstick the port never calls) and bound
   times (device time per call, from torch.profiler);
4. serving, the port's main path: `SFTTrainer(config).serve()` of
   random:gpt2-small at full width (vocab 50257, bf16 activations) with a
   paged KV pool answers 16 concurrent POST /generate requests, and the
   kernel's launch count equals decode dispatches x layers; then the same
   with an int8 KV pool;
5. greedy equality on the card: the engine with the kernel and with the
   gather path emit identical greedy token streams at f32 across slot
   reuse (int8 KV: at most one stream may differ).

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
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
F32_FLOPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores (data sheet)
ROOT = Path(__file__).resolve().parent


def log(msg):
    print(msg, flush=True)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def device_time_ms(fn, iters, warmup=3):
    """Device time per call: the CUDA kernels that torch.profiler traces
    over `iters` calls, summed and divided by `iters`. Host time between
    launches (the wrappers' Python) is excluded, so a kernel shorter than
    its launch overhead is still timed as a kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = 0.0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            total_us += getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)
    if total_us <= 0:
        raise RuntimeError("torch.profiler traced no device time")
    return total_us / 1e3 / iters


# ---------------------------------------------------------------------------
# Phase 3: kernel vs plain version
# ---------------------------------------------------------------------------

SHAPES = {  # name: (nh, nkv, hd)
    "gpt2-small": (12, 12, 64),
    "llama-7b": (32, 32, 128),
    "gqa": (32, 8, 128),
    "mqa": (16, 1, 64),
}
SLOTS, BLK, N_TBL, LAYERS = 8, 32, 10, 12
# row lengths at block boundaries, a full table, and one inactive row
LENS = [1, 31, 32, 33, 64, 200, N_TBL * BLK, 0]


def paged_case(nh, nkv, hd, kv, gen, device):
    """Random inputs shaped like the engine's: `LAYERS` arena pairs (the
    timing walks them like a decode step walks its layers, so KV comes
    from device memory, not L2), each slot owning distinct blocks, table
    slack on the zero block."""
    import torch

    from trlx_tpu_torch.ops import quant

    n_blocks = SLOTS * N_TBL + 1
    q = torch.randn(SLOTS, nh, hd, generator=gen, device=device).to(torch.bfloat16)
    perm = torch.randperm(n_blocks - 1, generator=gen, device=device) + 1
    table = perm[: SLOTS * N_TBL].reshape(SLOTS, N_TBL).to(torch.int32)
    lens = torch.tensor(LENS, device=device)
    mask = (torch.arange(N_TBL * BLK, device=device)[None, :] < lens[:, None]).to(torch.int32)
    used = (torch.arange(N_TBL, device=device)[None, :] * BLK) < lens[:, None]
    table = torch.where(used, table, torch.zeros_like(table))
    layers = []
    for _ in range(LAYERS):
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


def bound_bytes(nh, nkv, hd, kv, q_bytes):
    """Bytes the function must move for this run's data: q in and out
    once, the table and mask, and K and V (plus int8 scales) for every
    valid column once per kv head."""
    cols = sum(LENS)
    kv_bytes = {"f32": 4, "bf16": 2, "int8": 1}[kv]
    n = 2 * SLOTS * nh * hd * q_bytes + SLOTS * N_TBL * 4 + SLOTS * N_TBL * BLK * 4
    n += 2 * cols * nkv * hd * kv_bytes
    if kv == "int8":
        n += 2 * cols * nkv * 4
    return n


def bound(nh, nkv, hd, kv, q_bytes):
    """(ms, "bytes" | "operations"): the least time the card could take,
    the larger of the bytes over the memory rate and the f32 operations
    (q.k and p.v, 2 flops each per valid column, q head and dim) over the
    f32 rate."""
    bytes_ms = bound_bytes(nh, nkv, hd, kv, q_bytes) / HBM_BYTES_PER_S * 1e3
    ops_ms = 4 * sum(LENS) * nh * hd / F32_FLOPS_PER_S * 1e3
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
    from trlx_tpu_torch.ops.paged_attention import paged_attention_decode, paged_attention_plain

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
    for name, (nh, nkv, hd) in SHAPES.items():
        for kv, qt, tol in checks:
            q, table, mask, layers = paged_case(nh, nkv, hd, kv, gen, device)
            q = q.to(qt)
            k, v, extra = layers[0]
            out = paged_attention_decode(q, k, v, table, mask, **extra)
            torch.cuda.synchronize()
            ref = paged_attention_plain(q, k, v, table, mask, **extra)
            torch.testing.assert_close(out.float(), ref.float(), **tol)
            if not bool((out[-1] == 0).all()):
                raise AssertionError(f"{name}/{kv}: inactive row is not exactly 0")
            key = "paged_decode_int8" if kv == "int8" else "paged_decode"
            e = float((out.float() - ref.float()).abs().max())
            err[key] = max(err[key], e)
            if kv == "f32":
                log(f"[kernels] {name} nh={nh} nkv={nkv} hd={hd} kv={kv}: max_abs_err={e:.3g} (tol {tol})")
                continue
            it = iter(range(10**9))

            def kernel_fn():
                kk, vv, ex = layers[next(it) % LAYERS]
                paged_attention_decode(q, kk, vv, table, mask, **ex)

            def plain_fn():
                kk, vv, ex = layers[next(it) % LAYERS]
                paged_attention_plain(q, kk, vv, table, mask, **ex)

            kernel_ms = device_time_ms(kernel_fn, 240)
            plain_ms = device_time_ms(plain_fn, 24)
            library_ms = device_time_ms(library_call(q, k, v, table, mask, extra, nh, nkv), 240)
            least_ms, bound_by = bound(nh, nkv, hd, kv, 2)
            results[(name, kv)] = dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                                       bound_ms=least_ms, bound_by=bound_by)
            log(
                f"[kernels] {name} nh={nh} nkv={nkv} hd={hd} kv={kv}: max_abs_err={e:.3g} (tol {tol}) "
                f"kernel_ms={kernel_ms:.5f} plain_ms={plain_ms:.5f} library_ms={library_ms:.5f} "
                f"bound_ms={least_ms:.5f} ({bound_by})"
            )
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
        for line in out.splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    timings, errs = phase_kernels(device)
    launches_bf16 = serve_and_check(serving_config(), 16, "paged_decode", card)
    launches_int8 = serve_and_check(serving_config(kv_cache_dtype="int8"), 8, "paged_decode_int8", card)
    phase_greedy()

    main_bf16, main_int8 = timings[("gpt2-small", "bf16")], timings[("gpt2-small", "int8")]
    source = "trlx_tpu_torch/csrc/paged_attention.cu"
    held = "phase 3: kernel vs plain version on the card"
    report = {"kernels": [
        dict(name="paged_decode", route="cuda", source=source,
             replaces="trlx_tpu/ops/paged_attention.py:50", launches=launches_bf16,
             max_abs_err=errs["paged_decode"], held_against_plain_in=held, **main_bf16),
        dict(name="paged_decode_int8", route="cuda", source=source,
             replaces="trlx_tpu/ops/paged_attention.py:110", launches=launches_int8,
             max_abs_err=errs["paged_decode_int8"], held_against_plain_in=held, **main_int8),
    ]}
    print(json.dumps(report), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
