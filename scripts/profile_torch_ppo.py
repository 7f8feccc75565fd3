#!/usr/bin/env python3
"""Where a PPO cycle of the PyTorch port spends its time, on one CUDA
device, by phase and by kernel.

Builds the PPO trainer of `chip_smoke.py`'s phase 9 (random:gpt2-small at
full width, vocab 50257, bf16 activations, attn_impl="flash",
num_layers_unfrozen=2, 128 rollouts of 40 sampled tokens after 64-byte
prompts, batch 32, 4 PPO epochs), collects one chunk and trains once to
warm up, then times one cycle phase by phase: sampling the chunk, the host
stage (decode, reward_fn, retokenize), the no-grad hydra scoring pass,
and the 16 optimizer steps. Each device phase is traced with
`torch.profiler`: its wall time, device time by kernel, and the device's
busy share. Prints one JSON line at the end.

    python3 scripts/profile_torch_ppo.py
"""

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

OURS = {  # name fragments of the hand-written kernels in the trace
    "flash_fwd_wgmma_kernel": "flash forward, bf16 (K3, K4)",
    "flash_bwd_dq_wgmma_kernel": "flash dq, bf16 (K5)",
    "flash_bwd_dkv_wgmma_kernel": "flash dk/dv, bf16 (K6)",
    "label_logprob_kernel": "label logprob (K7)",
    "label_logprob_bwd_kernel": "label logprob backward (K7 bwd)",
}


def traced(fn):
    """(result, wall ms, [(kernel, device ms, launches)]) of one call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append((e.key, dev_us / 1e3, e.count))
    rows.sort(key=lambda r: -r[1])
    return out, wall_ms, rows


def main() -> int:
    import numpy as np
    import torch

    from chip_smoke import PPO_ROLLOUTS, ppo_config, ppo_prompts, ppo_reward
    from trlx_tpu_torch.pipeline import MiniBatchIterator
    from trlx_tpu_torch.pipeline.offline_pipeline import PromptPipeline
    from trlx_tpu_torch.trainer.ppo_trainer import PPOTrainer

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    config = ppo_config(ROOT / "build" / "profile_torch_ppo")
    trainer = PPOTrainer(config, reward_fn=ppo_reward)
    trainer.add_prompt_pipeline(PromptPipeline(ppo_prompts(), 984, trainer.tokenizer))
    method = config.method

    def train_cycle():
        steps = 0
        for _ in range(method.ppo_epochs):
            loader = trainer.create_train_dataloader()
            for minibatch in MiniBatchIterator(loader, trainer.mb_size, trainer.num_mb):
                trainer.train_minibatch(minibatch)
                trainer.iter_count += 1
                steps += 1
        return steps

    trainer.make_experience(PPO_ROLLOUTS)  # warm-up: one collection and one cycle of steps
    train_cycle()

    phases = {}
    batch = trainer._next_prompts()
    out, wall, rows = traced(lambda: trainer.generate(batch["input_ids"], batch["attention_mask"])["samples"].cpu())
    phases["rollout_generate"] = (wall, rows)
    t0 = time.perf_counter()
    prompts, outputs, *_ = trainer._host_process_chunk(batch, out.numpy())
    phases["host_decode_reward"] = ((time.perf_counter() - t0) * 1e3, [])
    tokens = torch.from_numpy(np.concatenate([prompts, outputs], axis=1)).to(trainer.device).long()
    _, wall, rows = traced(lambda: [x.cpu() for x in trainer.score(tokens)])
    phases["score"] = (wall, rows)
    n_steps, wall, rows = traced(train_cycle)
    phases["train_steps"] = (wall, rows)

    print(f"card: {card}")
    report = {"card": card, "rollouts": PPO_ROLLOUTS, "train_steps": n_steps, "phases": {}}
    cycle_ms = sum(w for w, _ in phases.values())
    for name, (wall, rows) in phases.items():
        device_ms = sum(r[1] for r in rows)
        ours = {label: sum(ms for k, ms, _ in rows if frag in k) for frag, label in OURS.items()}
        print(f"{name}: {wall:.3f} ms wall ({wall / cycle_ms:.3f} of the cycle), {device_ms:.3f} ms device "
              f"(busy share {device_ms / wall:.3f})")
        for k, ms, n in rows[:10]:
            print(f"  {ms:9.4f} ms  x{n:<6d} {k[:100]}")
        for label, ms in ours.items():
            if ms:
                print(f"  {label}: {ms:.4f} ms")
        report["phases"][name] = {"wall_ms": wall, "device_ms": device_ms,
                                  "busy_share": device_ms / wall if rows else 0.0,
                                  "kernel_ms": {label: ms for label, ms in ours.items() if ms},
                                  "top": [(k[:80], ms, n) for k, ms, n in rows[:8]]}
    report["cycle_ms"] = cycle_ms
    report["samples_per_s"] = PPO_ROLLOUTS / cycle_ms * 1e3
    print(f"cycle: {cycle_ms:.3f} ms over the four phases, {report['samples_per_s']:.2f} samples/s")
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
