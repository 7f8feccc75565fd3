#!/usr/bin/env python3
"""Where an SFT training step of the PyTorch port spends its time, on one
CUDA device.

Builds the SFT trainer of `chip_smoke.py`'s training phase
(random:gpt2-small at full width, vocab 50257, bf16 activations, seq
1024, batch 8, attn_impl="flash", num_layers_unfrozen=2), times
`train_minibatch` on the host clock (each step ends in the stats fetch,
which waits for the device), and traces a window of steps with
`torch.profiler`: device time by kernel, the device's busy share of the
window, and the shares of the hand-written kernels. Prints one JSON line
at the end.

    python3 scripts/profile_torch_train.py
"""

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

STEPS = 4  # optimizer steps per timed window
OURS = {  # name fragments of the hand-written kernels in the trace
    "flash_fwd_wgmma_kernel": "flash forward, bf16 on the tensor cores (K3, K4)",
    "flash_fwd_kernel": "flash forward, f32 on the CUDA cores (K3, K4)",
    "flash_bwd_dq_wgmma_kernel": "flash dq, bf16 on the tensor cores (K5)",
    "flash_bwd_dq_kernel": "flash dq, f32 on the CUDA cores (K5)",
    "flash_bwd_dkv_wgmma_kernel": "flash dk/dv, bf16 on the tensor cores (K6)",
    "flash_bwd_dkv_kernel": "flash dk/dv, f32 on the CUDA cores (K6)",
    "label_logprob_kernel": "label logprob (K7)",
    "label_logprob_bwd_kernel": "label logprob backward (K7 bwd)",
}


def main() -> int:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import sft_samples, training_config
    from trlx_tpu_torch.trainer.sft_trainer import SFTTrainer

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    trainer = SFTTrainer(training_config(ROOT / "build" / "profile_torch_train"))
    trainer.make_experience(sft_samples(), 1024)
    batch = next(iter(trainer.store.create_loader(8)))
    tokens = int(batch["attention_mask"].sum())
    for _ in range(2):  # warm-up
        trainer.train_minibatch([batch])
    t0 = time.perf_counter()
    for _ in range(STEPS):
        trainer.train_minibatch([batch])
    step_ms = (time.perf_counter() - t0) / STEPS * 1e3

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
        t1 = time.perf_counter()
        for _ in range(STEPS):
            trainer.train_minibatch([batch])
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t1) * 1e3
    rows = []  # device kernels only (CPU ops also carry their kernels' time)
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append((e.key, dev_us / 1e3, e.count))
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    ours = {label: sum(ms for name, ms, _ in rows if frag in name) / STEPS for frag, label in OURS.items()}
    print(f"card: {card}")
    print(f"host step: {step_ms:.3f} ms/step over {STEPS} steps, {tokens} real tokens a step "
          f"({tokens / step_ms * 1e3:.1f} training tokens/s)")
    print(f"profiled window: {window_ms:.3f} ms wall, {device_ms:.3f} ms device time "
          f"(busy share {device_ms / window_ms:.3f})")
    for name, ms, n in rows[:20]:
        print(f"  {ms / STEPS:9.4f} ms/step  x{n // STEPS:<5d} {name[:100]}")
    for label, ms in ours.items():
        print(f"  {label}: {ms:.4f} ms/step ({ms * STEPS / device_ms:.3f} of device time)")
    print(json.dumps({
        "card": card, "host_step_ms": step_ms, "tokens_per_step": tokens,
        "train_tokens_per_s": tokens / step_ms * 1e3, "window_ms": window_ms,
        "device_ms_per_step": device_ms / STEPS, "device_busy_share": device_ms / window_ms,
        "kernel_ms_per_step": ours,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
