#!/usr/bin/env python3
"""Where a decode step of the PyTorch port's serving engine spends its
time, on one CUDA device.

Builds random:gpt2-small at full width (vocab 50257, bf16 activations),
fills the 8 slots of a paged engine (32-token blocks) with prompts of
200 tokens, then times `engine.step()` on the host clock and traces a
window of steps with `torch.profiler`: device time by kernel, the
device's busy share of the window, and the paged-attention kernel's
share. Prints one JSON line at the end.

    python3 scripts/profile_torch_decode.py [--kv bf16|int8]
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

STEPS = 32  # decode steps per timed window


def main() -> int:
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from trlx_tpu_torch.data.default_configs import default_sft_config
    from trlx_tpu_torch.inference import InferenceEngine
    from trlx_tpu_torch.ops.sampling import GenerationConfig
    from trlx_tpu_torch.trainer.sft_trainer import SFTTrainer

    ap = argparse.ArgumentParser()
    ap.add_argument("--kv", default="auto")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    config = default_sft_config().evolve(
        model=dict(model_path="random:gpt2-small", model_extra_configs={"vocab_size": 50257}),
    )
    trainer = SFTTrainer(config)
    gen = GenerationConfig(max_new_tokens=64, do_sample=False, eos_token_id=10**6,
                           pad_token_id=trainer.tokenizer.pad_token_id)
    engine = InferenceEngine(trainer.model, trainer.model_cfg, None, gen, num_slots=8,
                             max_prompt_len=256, kv_paging=True, kv_block_size=32,
                             kv_cache_dtype=args.kv, decode_kernel="auto")
    rng = np.random.RandomState(0)
    rows = [(rng.randint(0, 256, 200), 64) for _ in range(8)]
    engine.insert_requests(rows, list(range(8)))
    for _ in range(4):  # warm-up
        engine.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(STEPS):
        engine.step()
    step_ms = (time.perf_counter() - t0) / STEPS * 1e3

    engine.release_slots(list(range(8)))
    engine.insert_requests(rows, list(range(8)))
    for _ in range(2):
        engine.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
        t1 = time.perf_counter()
        for _ in range(STEPS):
            engine.step()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t1) * 1e3
    rows_by_dev = []  # device kernels only (CPU ops also carry their kernels' time)
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows_by_dev.append((e.key, dev_us / 1e3, e.count))
    rows_by_dev.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows_by_dev)
    attn_ms = sum(r[1] for r in rows_by_dev if "paged_decode_kernel" in r[0])
    print(f"card: {card}")
    print(f"host step: {step_ms:.3f} ms/step over {STEPS} steps (8 active slots)")
    print(f"profiled window: {window_ms:.3f} ms wall, {device_ms:.3f} ms device time "
          f"(busy share {device_ms / window_ms:.3f})")
    for name, ms, n in rows_by_dev[:15]:
        print(f"  {ms / STEPS:9.4f} ms/step  x{n // STEPS:<5d} {name[:100]}")
    print(json.dumps({
        "card": card, "kv": args.kv,
        "host_step_ms": step_ms, "window_ms": window_ms, "device_ms": device_ms,
        "device_busy_share": device_ms / window_ms,
        "paged_attention_ms_per_step": attn_ms / STEPS,
        "device_ms_per_step": device_ms / STEPS,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
