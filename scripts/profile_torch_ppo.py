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

With `--options` the trainer runs phase 11's configuration, the JAX
bench's headline options (the int8 frozen-trunk decode view, speculative
decode, the trunk activation cache): sampling is speculative, and the
trunk cache's fill is a phase of its own after scoring.

With `--pipelined` it profiles `PPOTrainer.pipelined_cycle`, the JAX
bench's timed schedule (phase 12 of `chip_smoke.py`): two warm-up cycles,
then one cycle whose parts are each traced on their own (sampling the
next chunk, the speculative or fast scorer, the reward merge, the trunk
cache's attach, the host stage, the blocking fetch, the inner epochs);
each part ends in a device synchronization, so what eager torch overlaps
between them is not overlapped here. `--fast` adds the capture fast path
(`capture_rollout_stats`); `--options` the headline options either way.

With `--value-branch` the policy's value head is phase 13's deeper
branch (`num_value_layers_unfrozen=2`): scoring runs its 2 blocks, and
each step runs the full forward and K7 over the full logits.

With `--hh-6b` the trainer is phase 20 (b)'s HH "6B" configuration
(random:gptj-6b at full width, 16 heads of 256, batch 4, seq 512, 64
rollouts in chunks of 16, 32 new tokens, 2 trainable blocks): one chunk's
sampling and scoring and the cycle's 64 steps. Copied into another
checkout (a parent unpacked with `git archive`), it profiles that tree.

With `--lora-2p8b` the trainer is phase 21 (a)'s LoRA PPO at pythia-2.8b's
widths (32 blocks, 32 heads of 80, d_ff 10240; LoRA r 8 on q_proj and
v_proj; the HH "1B" settings): one chunk's sampling and scoring and the
cycle's 32 steps.

    python3 scripts/profile_torch_ppo.py [--options] [--pipelined [--fast]] [--value-branch] [--hh-6b]
    python3 scripts/profile_torch_ppo.py --lora-2p8b
"""

import argparse
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
    "flash_fwd_kernel": "flash forward, CUDA cores (K3, K4)",
    "flash_bwd_dq_kernel": "flash dq, CUDA cores (K5)",
    "flash_bwd_dkv_kernel": "flash dk/dv, CUDA cores (K6)",
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


# the pipelined cycle's parts, by the PPOTrainer method that runs each
PIPELINED_PHASES = {
    "dispatch_rollout_generation": "rollout_generate",
    "_dispatch_spec_score": "score_spec",
    "_dispatch_fast_score": "score_fast",
    "_score_reward": "score_classic",
    "_spec_merge": "reward_merge",
    "_attach_trunk_cache": "trunk_cache",
    "_host_process_chunk": "host_decode_reward",
    "_fetch": "fetch",
    "train_epochs_from_chunk": "train_epochs",
}


def traced_pipelined_cycle(trainer, pending):
    """One `pipelined_cycle` with each of its parts traced on its own
    (a part called inside another is traced with it). Returns (pending,
    the cycle's wall ms without the profiler's own time, {phase: (wall
    ms, rows)})."""
    import torch

    from trlx_tpu_torch.trainer.ppo_trainer import PPOTrainer

    phases, depth, overhead = {}, [0], [0.0]
    originals = {name: getattr(PPOTrainer, name) for name in PIPELINED_PHASES}

    def probe(name):
        fn = originals[name]

        def wrapped(self, *args, **kwargs):
            if depth[0]:
                return fn(self, *args, **kwargs)
            depth[0] += 1
            t0 = time.perf_counter()
            try:
                out, wall, rows = traced(lambda: fn(self, *args, **kwargs))
            finally:
                depth[0] -= 1
            # the profiler's own start, stop and post-processing
            overhead[0] += (time.perf_counter() - t0) * 1e3 - wall
            w, r = phases.get(PIPELINED_PHASES[name], (0.0, []))
            phases[PIPELINED_PHASES[name]] = (w + wall, r + rows)
            return out

        return wrapped

    try:
        for name in PIPELINED_PHASES:
            setattr(PPOTrainer, name, probe(name))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, pending = trainer.pipelined_cycle(pending)
        torch.cuda.synchronize()
        cycle_ms = (time.perf_counter() - t0) * 1e3 - overhead[0]
    finally:
        for name, fn in originals.items():
            setattr(PPOTrainer, name, fn)
    # a phase called more than once (the fast schedule's two fetches) sums
    # its kernels by name
    for name, (wall, rows) in phases.items():
        merged = {}
        for k, ms, n in rows:
            m0, n0 = merged.get(k, (0.0, 0))
            merged[k] = (m0 + ms, n0 + n)
        phases[name] = (wall, sorted(((k, ms, n) for k, (ms, n) in merged.items()), key=lambda r: -r[1]))
    return pending, cycle_ms, phases


def main() -> int:
    import numpy as np
    import torch

    from chip_smoke import (HH_NEW, HH_QUESTIONS, HH_ROLLOUTS, LORA_PEFT, PPO_OPTIONS, PPO_ROLLOUTS,
                            PYTHIA_2P8B, VALUE_BRANCH, hh_config, ppo_config, ppo_prompts, ppo_reward)
    from trlx_tpu_torch.pipeline import MiniBatchIterator
    from trlx_tpu_torch.pipeline.offline_pipeline import PromptPipeline
    from trlx_tpu_torch.trainer.ppo_trainer import PPOTrainer

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    parser = argparse.ArgumentParser()
    parser.add_argument("--options", action="store_true", help="phase 11's options on")
    parser.add_argument("--pipelined", action="store_true", help="profile pipelined_cycle (phase 12)")
    parser.add_argument("--fast", action="store_true", help="with --pipelined: the capture fast path on")
    parser.add_argument("--value-branch", action="store_true", help="phase 13's value branch")
    parser.add_argument("--hh-6b", action="store_true", help="phase 20 (b)'s HH \"6B\" trainer (gptj-6b)")
    parser.add_argument("--lora-2p8b", action="store_true", help="phase 21 (a)'s LoRA PPO at pythia-2.8b's widths")
    args = parser.parse_args()
    if args.fast and not args.pipelined:
        parser.error("--fast needs --pipelined")
    hh = args.hh_6b or args.lora_2p8b
    if hh and (args.options or args.pipelined or args.value_branch or (args.hh_6b and args.lora_2p8b)):
        parser.error("--hh-6b and --lora-2p8b take no other option")
    work = ROOT / "build" / "profile_torch_ppo"
    config = ppo_config(work)
    if args.hh_6b:
        config = hh_config(work, "6B")
    if args.lora_2p8b:
        config = hh_config(work, "1B", **PYTHIA_2P8B).evolve(model=dict(peft_config=LORA_PEFT))
    rollouts = HH_ROLLOUTS if hh else PPO_ROLLOUTS
    if args.options:
        config = config.evolve(method=PPO_OPTIONS)
    if args.fast:
        config = config.evolve(method=dict(capture_rollout_stats=True))
    if args.value_branch:
        config = config.evolve(method=VALUE_BRANCH)
    trainer = PPOTrainer(config, reward_fn=ppo_reward)
    if hh:
        trainer.add_prompt_pipeline(PromptPipeline(HH_QUESTIONS * 16, config.train.seq_length - HH_NEW,
                                                   trainer.tokenizer))
    else:
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

    if args.pipelined:
        _, pending = trainer.pipelined_cycle()  # warm-up: two cycles
        _, pending = trainer.pipelined_cycle(pending)
        pending, cycle_ms, phases = traced_pipelined_cycle(trainer, pending)
        if trainer.spec_fallbacks:
            raise AssertionError(f"the speculative scorer fell back {trainer.spec_fallbacks} times")
        return report(card, args, phases, cycle_ms, PPO_ROLLOUTS, 4 * PPO_ROLLOUTS // config.train.batch_size)

    trainer.make_experience(rollouts)  # warm-up: one collection and one cycle of steps
    train_cycle()

    phases = {}
    batch = trainer._next_prompts()
    spec_k = trainer._spec_k_effective()
    out, wall, rows = traced(lambda: trainer.generate(batch["input_ids"], batch["attention_mask"],
                                                      spec_k=spec_k)["samples"].cpu())
    phases["rollout_generate"] = (wall, rows)
    t0 = time.perf_counter()
    prompts, outputs, *_ = trainer._host_process_chunk(batch, out.numpy())
    phases["host_decode_reward"] = ((time.perf_counter() - t0) * 1e3, [])
    tokens = torch.from_numpy(np.concatenate([prompts, outputs], axis=1)).to(trainer.device).long()
    _, wall, rows = traced(lambda: [x.cpu() for x in trainer.score(tokens)])
    phases["score"] = (wall, rows)
    if trainer._trunk_cache_available():
        _, wall, rows = traced(lambda: trainer.trunk_cache_fill(tokens))
        phases["trunk_cache_fill"] = (wall, rows)
    n_steps, wall, rows = traced(train_cycle)
    phases["train_steps"] = (wall, rows)
    return report(card, args, phases, sum(w for w, _ in phases.values()), rollouts, n_steps)


def report(card, args, phases, cycle_ms, rollouts, n_steps) -> int:
    """Print each phase's wall and device time, busy share and top kernels,
    then the JSON line."""
    print(f"card: {card}")
    out = {"card": card, "options": args.options, "pipelined": args.pipelined, "fast": args.fast,
           "value_branch": args.value_branch, "hh_6b": args.hh_6b, "lora_2p8b": args.lora_2p8b,
           "rollouts": rollouts, "train_steps": n_steps,
           "phases": {}}
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
        out["phases"][name] = {"wall_ms": wall, "device_ms": device_ms,
                               "busy_share": device_ms / wall if rows else 0.0,
                               "kernel_ms": {label: ms for label, ms in ours.items() if ms},
                               "top": [(k[:80], ms, n) for k, ms, n in rows[:8]]}
    out["cycle_ms"] = cycle_ms
    out["samples_per_s"] = rollouts / cycle_ms * 1e3
    what = "the pipelined cycle's wall" if args.pipelined else "the four phases"
    print(f"cycle: {cycle_ms:.3f} ms over {what} ({sum(w for w, _ in phases.values()):.3f} in the traced "
          f"phases), {out['samples_per_s']:.2f} samples/s")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
