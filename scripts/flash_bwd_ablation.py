#!/usr/bin/env python3
"""What holds the bf16 flash backward (K5 dq and K6 dk/dv on the tensor
cores) back, measured by ablation on one CUDA device.

Builds variants of `trlx_tpu_torch/csrc/flash_attention.cu`, each with one
part of the tile loops of `flash_bwd_dq_wgmma_kernel` and
`flash_bwd_dkv_wgmma_kernel` removed or serialised by a textual edit
inside those kernels, into `build/flash_bwd_ablation/`, and times K5 and
K6 of each at `chip_smoke.py` phase 6's gpt2-small shapes (b 8, t 1024,
12/12/64, bf16, the same left pads), device time per call from
torch.profiler. A variant's answers are wrong by construction: only its
time is read. What a variant saves is what the removed part costs where
nothing else hides it. SDPA's backward is timed beside them as the
yardstick. Prints one JSON line at the end.

    python3 scripts/flash_bwd_ablation.py
"""

import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

DQ, DKV = "flash_bwd_dq_wgmma_kernel", "flash_bwd_dkv_wgmma_kernel"
LO = [(DQ, "      wgmma_rs<HD>(acc, d_lo[kk], bk);\n", ""),
      (DKV, "      wgmma_rs<HD>(acc_v, p_lo[kk], bo);\n", ""),
      (DKV, "      wgmma_rs<HD>(acc_k, d_lo[kk], bq);\n", "")]
HI = [(DQ, "      wgmma_rs<HD>(acc, d_hi[kk], bk);\n", ""),
      (DKV, "      wgmma_rs<HD>(acc_v, p_hi[kk], bo);\n", ""),
      (DKV, "      wgmma_rs<HD>(acc_k, d_hi[kk], bq);\n", "")]
SS = [(DQ, "      wgmma_ss_n64(s, desc_kmajor<HD>(sQ, WG_ROWS, kk), desc_kmajor<HD>(kt, WG_KEYS, kk), kk > 0);\n", ""),
      (DQ, "      wgmma_ss_n64(dp, desc_kmajor<HD>(sO, WG_ROWS, kk), desc_kmajor<HD>(vt, WG_KEYS, kk), kk > 0);\n", ""),
      (DKV, "      wgmma_ss_n64(s, desc_kmajor<HD>(sK, WG_KEYS, kk), desc_kmajor<HD>(qt, WG_ROWS, kk), kk > 0);\n", ""),
      (DKV, "      wgmma_ss_n64(dp, desc_kmajor<HD>(sV, WG_KEYS, kk), desc_kmajor<HD>(ot, WG_ROWS, kk), kk > 0);\n", "")]
# name: (what it shows, [(kernel, text in its source, replacement)])
VARIANTS = {
    "full": ("the kernels as built for the port", []),
    "no_lo": ("without the lo-half products (ds_lo.k in K5; p_lo.dO and ds_lo.q in K6)", LO),
    "no_second": ("without the second-half products (and the bf16 packing they read)", LO + HI),
    "no_mma": ("without any wgmma: the loads, the mask, p, ds and the barriers", LO + HI + SS),
    "no_exp": ("the exps of p replaced by an addition (the special-function work)",
               [(DQ, "fast_exp2(fmaf(x, sl2, nl2[hh]))", "(x + nl2[hh])"),
                (DKV, "fast_exp2(fmaf(x, sl2, -(e ? l2.y : l2.x) * LOG2E))", "(x - (e ? l2.y : l2.x))")]),
    "serial_loads": ("each streamed tile waited for before it computes (no ring)",
                     [(DQ, "      cp_async_wait<1>();\n", "      cp_async_wait<0>();\n"),
                      (DKV, "      cp_async_wait<1>();\n", "      cp_async_wait<0>();\n")]),
    "more_blocks": ("registers capped so more blocks fit an SM (K5 at 128 a thread: four; K6 at 168: three)",
                    [(DQ, f"__launch_bounds__(WG_THREADS)\n    {DQ}", f"__launch_bounds__(WG_THREADS, 4)\n    {DQ}"),
                     (DKV, f"__launch_bounds__(WG_THREADS)\n    {DKV}", f"__launch_bounds__(WG_THREADS, 3)\n    {DKV}")]),
    "no_skip": ("every causal tile computed, padding included",
                [(DQ, "    while (j < n_tiles && (valid[2 * j] | valid[2 * j + 1]) == 0u) ++j;\n", ""),
                 (DKV, "if (bits == 0ull || i_begin >= n_q)", "if (i_begin >= n_q)")]),
}


def main() -> int:
    import torch

    from chip_smoke import FLASH_SHAPES, card_line, device_time_ms, flash_bound, flash_case, sdpa_calls
    from flash_fwd_ablation import build_variants, resources

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    libs, logs = build_variants(ROOT / "build" / "flash_bwd_ablation", VARIANTS)
    used = {name: {"dq": resources(log, "flash_bwd_dq_wgmma_kernelILi64E"),
                   "dkv": resources(log, "flash_bwd_dkv_wgmma_kernelILi64E")} for name, log in logs.items()}
    b, t, nh, nkv, hd, pads, _ = FLASH_SHAPES["gpt2-small"]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    q, k, v, mask, g, lse, delta = flash_case(b, t, nh, nkv, hd, pads, gen, torch.device("cuda"))
    dq = torch.empty_like(q)
    dk = torch.empty((b, t, nh, hd), dtype=torch.float32, device="cuda")
    dv = torch.empty_like(dk)
    stream = torch.cuda.current_stream().cuda_stream
    args = (1, b, t, t, nh, nkv, hd, 1, 1.0 / math.sqrt(hd), stream)

    def call_dq(lib):
        rc = lib.trlx_flash_bwd_dq(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), g.data_ptr(),
                                   lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), *args)
        if rc != 0:
            raise RuntimeError(f"launch failed: CUDA error {rc}")

    def call_dkv(lib):
        rc = lib.trlx_flash_bwd_dkv(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), g.data_ptr(),
                                    lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), *args)
        if rc != 0:
            raise RuntimeError(f"launch failed: CUDA error {rc}")

    print(f"card: {card}")
    times = {}
    for _ in range(2):  # two passes in turns; the second pass is reported
        for name, lib in libs.items():
            times[name] = {"dq": device_time_ms(lambda: call_dq(lib), 20),
                           "dkv": device_time_ms(lambda: call_dkv(lib), 20)}
    sdpa_ms = device_time_ms(sdpa_calls(q, k, v, g, nh, nkv)[1], 10)
    bounds = {kind: flash_bound(b, t, nh, nkv, hd, pads, kind) for kind in ("dq", "dkv")}
    full = times["full"]
    for name, (what, _) in VARIANTS.items():
        ms = times[name]
        print(f"  {name:13s} K5 {ms['dq']:.5f} ms ({ms['dq'] - full['dq']:+.5f}), "
              f"K6 {ms['dkv']:.5f} ms ({ms['dkv'] - full['dkv']:+.5f}): {what} "
              f"[K5 {used[name]['dq']}] [K6 {used[name]['dkv']}]")
    print(f"  SDPA backward {sdpa_ms:.5f} ms; bounds K5 {bounds['dq'][0]:.5f} ms, K6 {bounds['dkv'][0]:.5f} ms (bytes)")
    print(json.dumps({"card": card, "ms": times, "sdpa_bwd_ms": sdpa_ms,
                      "bound_ms": {kind: bd[0] for kind, bd in bounds.items()}, "resources": used}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
