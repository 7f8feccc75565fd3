#!/usr/bin/env python3
"""What holds the bf16 flash backward (K5 dq and K6 dk/dv on the tensor
cores) back, measured by ablation on one CUDA device.

Builds variants of `trlx_tpu_torch/csrc/flash_attention.cu`, each with one
part of the tile loops of `flash_bwd_dq_wgmma_kernel` and
`flash_bwd_dkv_wgmma_kernel` removed or serialised by a textual edit
inside those kernels, into `build/flash_bwd_ablation/`, and times K5 and
K6 of each at one or more of `chip_smoke.py` phase 6's shapes (`--shape`,
default gpt2-small: b 8, t 1024, 12/12/64, bf16, the same left pads),
device time per call from torch.profiler, in two passes in turns (the
second in reverse order; the mean is reported). A variant's answers are
wrong by construction: only its time is read. What a variant saves is
what the removed part costs where nothing else hides it. `--parent DIR`
adds the `csrc/` of another checkout (a parent commit unpacked with `git
archive`) as variant "parent", built and timed in the same turns, its
dq, dk and dv held against the full kernels' (bitwise equality reported;
within phase 6's tolerances required). SDPA's backward is timed beside
them as the yardstick; with `--parent`, whether each K5/K6 wgmma
instantiation compiled to the parent's SASS (`cuobjdump`). Prints
ptxas's registers and spills of each variant's kernels at the shape's
head dim and one JSON line at the end.

    python3 scripts/flash_bwd_ablation.py [--shape gptj-6b gpt2-small] [--parent build/parent] [--variants no_dup]
"""

import argparse
import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

DQ, DKV = "flash_bwd_dq_wgmma_kernel", "flash_bwd_dkv_wgmma_kernel"
LO = [(DQ, "      wgmma_rs<OHD>(acc, d_lo[kk], bk);\n", ""),
      (DKV, "      wgmma_rs<OHD>(acc_v, p_lo[kk], bo);\n", ""),
      (DKV, "      wgmma_rs<OHD>(acc_k, d_lo[kk], bq);\n", "")]
HI = [(DQ, "      wgmma_rs<OHD>(acc, d_hi[kk], bk);\n", ""),
      (DKV, "      wgmma_rs<OHD>(acc_v, p_hi[kk], bo);\n", ""),
      (DKV, "      wgmma_rs<OHD>(acc_k, d_hi[kk], bq);\n", "")]
S_DQ = "      wgmma_ss_n64(s, desc_kmajor<HD>(sQ, WG_ROWS, kk), desc_kmajor<HD>(kt, WG_KEYS, kk), kk > 0);\n"
DP_DQ = "      wgmma_ss_n64(dp, desc_kmajor<HD>(sO, WG_ROWS, kk), desc_kmajor<HD>(vt, WG_KEYS, kk), kk > 0);\n"
S_DKV = "      wgmma_ss_n64(s, desc_kmajor<HD>(sK, WG_KEYS, kk), desc_kmajor<HD>(qt, WG_ROWS, kk), kk > 0);\n"
DP_DKV = "      wgmma_ss_n64(dp, desc_kmajor<HD>(sV, WG_KEYS, kk), desc_kmajor<HD>(ot, WG_ROWS, kk), kk > 0);\n"
SS = [(kernel, text, "") for kernel, text in ((DQ, S_DQ), (DQ, DP_DQ), (DKV, S_DKV), (DKV, DP_DKV))]
LOOP = "#pragma unroll\n    for (int kk = 0; kk < HD / 16; ++kk)\n"
# the second warpgroup (hd 256) forms no S or dP: the duplicated tensor work
NO_DUP = [(kernel, LOOP + text, "    if (wg == 0) {\n" + LOOP + text + "    }\n")
          for kernel, text in ((DQ, S_DQ), (DQ, DP_DQ), (DKV, S_DKV), (DKV, DP_DKV))]
# name: (what it shows, [(kernel, text in its source, replacement)])
VARIANTS = {
    "full": ("the kernels as built for the port", []),
    "no_lo": ("without the lo-half products (ds_lo.k in K5; p_lo.dO and ds_lo.q in K6)", LO),
    "no_second": ("without the second-half products (and the bf16 packing they read)", LO + HI),
    "no_mma": ("without any wgmma: the loads, the mask, p, ds and the barriers", LO + HI + SS),
    "no_dup": ("the second warpgroup's S and dP not formed (hd 256: the price of the duplication)", NO_DUP),
    "no_exp": ("the exps of p replaced by an addition (the special-function work)",
               [(DQ, "fast_exp2(fmaf(x, sl2, nl2[hh]))", "(x + nl2[hh])"),
                (DKV, "fast_exp2(fmaf(x, sl2, -(e ? l2.y : l2.x) * LOG2E))", "(x - (e ? l2.y : l2.x))")]),
    "serial_loads": ("each streamed tile waited for before it computes (no ring)",
                     [(DQ, "      cp_async_wait<1>();\n", "      cp_async_wait<0>();\n"),
                      (DKV, "      cp_async_wait<1>();\n", "      cp_async_wait<0>();\n")]),
    "more_blocks": ("registers capped so more blocks fit an SM (up to hd 128: K5 at 128 a thread, four; "
                    "K6 at 168, three)",
                    [(DQ, f"__launch_bounds__(WG_THREADS * warpgroups(HD))\n    {DQ}",
                      f"__launch_bounds__(WG_THREADS * warpgroups(HD), 4 / warpgroups(HD))\n    {DQ}"),
                     (DKV, f"__launch_bounds__(WG_THREADS * warpgroups(HD))\n    {DKV}",
                      f"__launch_bounds__(WG_THREADS * warpgroups(HD), 3 / warpgroups(HD))\n    {DKV}")]),
    "no_skip": ("every causal tile computed, padding included",
                [(DQ, "    while (j < n_tiles && (valid[2 * j] | valid[2 * j + 1]) == 0u) ++j;\n", ""),
                 (DKV, "if (bits == 0ull || i_begin >= n_q)", "if (i_begin >= n_q)")]),
}


def kernel_resources(log, hd):
    """ptxas's figures for K5 and K6 at this head dim: the wgmma kernels,
    or (a parent that ran the bf16 backward at hd 256 on the CUDA cores)
    the CUDA-core kernels at bf16."""
    from flash_fwd_ablation import resources

    out = {}
    for kind, name in (("dq", "flash_bwd_dq"), ("dkv", "flash_bwd_dkv")):
        got = resources(log, f"{name}_wgmma_kernelILi{hd}E")
        if got == "not found":
            got = resources(log, f"{name}_kernelI13__nv_bfloat16Li{hd}E")
        out[kind] = got
    return out


def sass_by_kernel(lib):
    """{K5/K6 wgmma kernel name: its SASS} of a built library, read with
    cuobjdump; names without the anonymous namespace's per-file hash."""
    import re
    import subprocess

    from trlx_tpu_torch import kernels

    cuobjdump = str(Path(kernels.nvcc_path()).parent / "cuobjdump")
    out = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True, check=True).stdout
    parts = re.split(r"\n\s*Function : (\S+)\n", out)
    named = {re.sub(r"_GLOBAL__N__[0-9a-f]+_", "", parts[i]): parts[i + 1] for i in range(1, len(parts) - 1, 2)}
    return {re.search(r"flash_bwd_d(?:q|kv)_wgmma_kernelILi\d+E", n).group(0): text
            for n, text in named.items() if re.search(r"flash_bwd_d(?:q|kv)_wgmma_kernel", n)}


def main() -> int:
    import torch

    from chip_smoke import (BF16_TOL, DKV_TOL, FLASH_SHAPES, card_line, device_time_ms, flash_bound, flash_case,
                            sdpa_calls)
    from flash_fwd_ablation import build_variants

    bwd_shapes = sorted(name for name, row in FLASH_SHAPES.items() if "flash_bwd_dq" in row[-1])
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shape", nargs="+", default=["gpt2-small"], choices=bwd_shapes)
    ap.add_argument("--parent", default=None, help="root of another checkout, timed as variant 'parent'")
    ap.add_argument("--variants", nargs="+", default=[n for n in VARIANTS if n != "full"], choices=list(VARIANTS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    variants = {name: VARIANTS[name] for name in ["full", *args.variants]}  # "full" is what others are read against
    libs, logs = build_variants(ROOT / "build" / "flash_bwd_ablation", variants, parent=args.parent)
    stream = torch.cuda.current_stream().cuda_stream
    print(f"card: {card}")
    report = {"card": card, "shapes": {}}
    if "parent" in libs:  # which of the parent's K5/K6 instantiations compiled to the same SASS
        out_dir = ROOT / "build" / "flash_bwd_ablation"
        mine, theirs = sass_by_kernel(out_dir / "full" / "lib.so"), sass_by_kernel(out_dir / "parent" / "lib.so")
        report["sass_same_as_parent"] = {n: theirs.get(n) == text for n, text in sorted(mine.items())}
        print(f"SASS the same as the parent's: {report['sass_same_as_parent']}")
    for shape in args.shape:
        b, t, nh, nkv, hd, rows, _ = FLASH_SHAPES[shape]
        used = {name: kernel_resources(log, hd) for name, log in logs.items()}
        gen = torch.Generator(device="cuda")
        gen.manual_seed(1)
        q, k, v, mask, g, lse, delta = flash_case(b, t, nh, nkv, hd, rows, gen, torch.device("cuda"))
        kept = [n for n in ("full", "parent") if n in libs]  # their outputs are compared; the rest share buffers
        outs = {n: (torch.empty_like(q), torch.empty((b, t, nh, hd), dtype=torch.float32, device="cuda"),
                    torch.empty((b, t, nh, hd), dtype=torch.float32, device="cuda")) for n in kept + ["scratch"]}
        call_args = (1, b, t, t, nh, nkv, hd, 1, 1.0 / math.sqrt(hd), stream)

        def call_dq(name):
            dq = outs[name if name in outs else "scratch"][0]
            rc = libs[name].trlx_flash_bwd_dq(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
                                              g.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                                              *call_args)
            if rc != 0:
                raise RuntimeError(f"{name}: K5 launch failed: CUDA error {rc}")

        def call_dkv(name):
            _, dk, dv = outs[name if name in outs else "scratch"]
            rc = libs[name].trlx_flash_bwd_dkv(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
                                               g.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                                               dv.data_ptr(), *call_args)
            if rc != 0:
                raise RuntimeError(f"{name}: K6 launch failed: CUDA error {rc}")

        passes = []
        for order in (list(libs), list(libs)[::-1]):  # two passes in turns, the second reversed
            passes.append({name: {"dq": device_time_ms(lambda: call_dq(name), 20),
                                  "dkv": device_time_ms(lambda: call_dkv(name), 20)} for name in order})
        times = {name: {kind: (passes[0][name][kind] + passes[1][name][kind]) / 2 for kind in ("dq", "dkv")}
                 for name in libs}
        torch.cuda.synchronize()
        parent = None
        if "parent" in libs:  # the parent's outputs against the full kernels'
            got, want = outs["parent"], outs["full"]
            parent = {"bitwise_equal": {kind: bool(torch.equal(a, w)) for kind, a, w in zip(("dq", "dk", "dv"), got, want)},
                      "max_abs_diff": {kind: float((a.float() - w.float()).abs().max())
                                       for kind, a, w in zip(("dq", "dk", "dv"), got, want)}}
            torch.testing.assert_close(got[0].float(), want[0].float(), **BF16_TOL)
            torch.testing.assert_close(got[1], want[1], **DKV_TOL)
            torch.testing.assert_close(got[2], want[2], **DKV_TOL)
        sdpa_ms = device_time_ms(sdpa_calls(q, k, v, g, nh, nkv)[1], 10)
        bounds = {kind: flash_bound(b, t, nh, nkv, hd, rows, kind) for kind in ("dq", "dkv")}
        full = times["full"]
        print(f"shape {shape}: b {b}, t {t}, {nh}/{nkv} heads of {hd}")
        for name in libs:
            what = "the parent checkout's kernels" if name == "parent" else VARIANTS[name][0]
            ms = times[name]
            print(f"  {name:13s} K5 {ms['dq']:.5f} ms ({ms['dq'] - full['dq']:+.5f}), "
                  f"K6 {ms['dkv']:.5f} ms ({ms['dkv'] - full['dkv']:+.5f}): {what} "
                  f"[K5 {used[name]['dq']}] [K6 {used[name]['dkv']}]")
        if parent is not None:
            print(f"  parent vs full: bitwise equal {parent['bitwise_equal']}, max abs difference {parent['max_abs_diff']}")
        print(f"  SDPA backward {sdpa_ms:.5f} ms; bounds K5 {bounds['dq'][0]:.5f} ms ({bounds['dq'][1]}), "
              f"K6 {bounds['dkv'][0]:.5f} ms ({bounds['dkv'][1]})")
        report["shapes"][shape] = {"ms": times, "passes": passes, "sdpa_bwd_ms": sdpa_ms,
                                   "bound_ms": {kind: bd[0] for kind, bd in bounds.items()}, "ptxas": used,
                                   "parent": parent}
        del q, k, v, mask, g, lse, delta, outs
        torch.cuda.empty_cache()
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
