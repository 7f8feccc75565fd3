#!/usr/bin/env python3
"""How often a torch.profiler trace comes back without device events, and
whether the CUDA-event timing that `chip_smoke.device_time_ms` falls back
on agrees with the profiler, on one CUDA device.

At `chip_smoke.py` phase 6's gpt2-small shapes (b 8, t 1024, 12/12/64,
bf16, the same left pads), traces 10 calls of K5 (`flash_bwd_dq`), K3
(`flash_fwd`) and SDPA's backward `--rounds` times each, in turns, with
`chip_smoke.profiled_device_us`, and counts the traces that hold no
device event. Then times each function by the profiler, by CUDA events
with a spin kernel ahead of the calls (`chip_smoke.event_time_ms`) and by
bare CUDA events (host gaps included). Prints one JSON line at the end.

    python3 scripts/profiler_trace_check.py [--rounds 100]
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def bare_event_ms(fn, iters):
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    import torch

    from chip_smoke import (FLASH_SHAPES, card_line, device_time_ms, event_time_ms, flash_case, profiled_device_us,
                            sdpa_calls)
    from trlx_tpu_torch import kernels
    from trlx_tpu_torch.ops import attention as A

    parser = argparse.ArgumentParser()
    parser.add_argument("--rounds", type=int, default=100)
    rounds = parser.parse_args().rounds
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    kernels.build(kernels.all_sources())
    b, t, nh, nkv, hd, pads = FLASH_SHAPES["gpt2-small"]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    q, k, v, mask, g, lse, delta = flash_case(b, t, nh, nkv, hd, pads, gen, torch.device("cuda"))
    fns = {"K5 dq": lambda: A.flash_bwd_dq(q, k, v, mask, g, lse, delta, True),
           "K3 forward": lambda: A.flash_fwd(q, k, v, mask, True),
           "SDPA backward": sdpa_calls(q, k, v, g, nh, nkv)[1]}
    for fn in fns.values():
        for _ in range(3):
            fn()
    torch.cuda.synchronize()
    empty = {name: 0 for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            empty[name] += profiled_device_us(fn, 10) == 0.0
    ms = {}
    for name, fn in fns.items():
        spun, gapless = event_time_ms(fn, 10)
        ms[name] = {"profiler": device_time_ms(fn, 10, label=name), "events_after_spin": spun,
                    "gapless": gapless, "bare_events": bare_event_ms(fn, 10)}
    print(f"card: {card}")
    for name in fns:
        m = ms[name]
        print(f"  {name:13s} empty traces {empty[name]} of {rounds}; ms per call: profiler {m['profiler']:.5f}, "
              f"events after a spin {m['events_after_spin']:.5f} (gapless {m['gapless']}), "
              f"bare events {m['bare_events']:.5f}")
    print(json.dumps({"card": card, "rounds": rounds, "empty_traces": empty, "ms": ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
