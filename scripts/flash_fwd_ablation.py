#!/usr/bin/env python3
"""What holds the bf16 flash forward (K3 on the tensor cores) back,
measured by ablation on one CUDA device.

Builds variants of `trlx_tpu_torch/csrc/flash_attention.cu`, each with one
part of `flash_fwd_wgmma_kernel`'s tile loop removed or serialised by a
textual edit inside that kernel, into `build/flash_fwd_ablation/`, and times
the forward without lse of each at one of `chip_smoke.py` phase 6's shapes
(`--shape`, default gpt2-small: b 8, t 1024, 12/12/64, bf16, the same left
pads), device time per call from torch.profiler, in two passes in turns.
A variant's answers are wrong by construction: only its time is read.
What a variant saves is what the removed part costs where nothing else
hides it. `--parent DIR` adds the `csrc/` of another checkout (a parent
commit unpacked with `git archive`) as variant "parent", built and timed
in the same turns, its answer held against the full kernel's. SDPA's
forward is timed beside them as the yardstick. Prints ptxas's registers
and spills of each variant's kernel and one JSON line at the end.

    python3 scripts/flash_fwd_ablation.py [--shape gptj-6b] [--parent build/parent] [--variants full no_pv]
"""

import argparse
import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# name: (what it shows, [(text in the source, replacement)])
VARIANTS = {
    "full": ("the kernel as built for the port", []),
    "no_p_lo": ("without the p_lo.V product (two products a pair instead of three)",
                [("      wgmma_rs<OHD>(o, a_lo[kk], dv);\n", "")]),
    "no_pv": ("without both p.V products (and the bf16 packing they read)",
              [("      wgmma_rs<OHD>(o, a_hi[kk], dv);\n      wgmma_rs<OHD>(o, a_lo[kk], dv);\n", "")]),
    "no_mma": ("without any wgmma: the loads, the mask, the softmax and the barriers",
               [("      wgmma_ss_n64(s, desc_kmajor<HD>(sQ, WG_ROWS, kk), desc_kmajor<HD>(kt, WG_KEYS, kk), kk > 0);\n", ""),
                ("      wgmma_rs<OHD>(o, a_hi[kk], dv);\n      wgmma_rs<OHD>(o, a_lo[kk], dv);\n", "")]),
    "no_exp": ("the exps of p replaced by an addition (the softmax's special-function work)",
               [("fast_exp2(fmaf(x, LOG2E, neg_shift2))", "(x + neg_shift2)")]),
    "serial_loads": ("each K/V tile waited for before the tile computes (no ring)",
                     [("      cp_async_wait<1>();\n", "      cp_async_wait<0>();\n")]),
    "four_blocks": ("registers capped at 128 a thread, so four blocks fit an SM (up to hd 128)",
                    [("__launch_bounds__(WG_THREADS * warpgroups(HD))\n    flash_fwd_wgmma_kernel",
                      "__launch_bounds__(WG_THREADS * warpgroups(HD), 4)\n    flash_fwd_wgmma_kernel")]),
    "no_skip": ("every causal tile computed, padding included",
                [("    while (j < n_tiles && (valid[2 * j] | valid[2 * j + 1]) == 0u) ++j;\n", "")]),
}


def edit_kernel(text, kernel, old, new):
    """`text` with `old` replaced by `new` inside the definition of
    `kernel` (from its `template` line to the first closing brace at
    column 0), where `old` must occur exactly once."""
    start = text.rindex("template", 0, text.index(f"    {kernel}("))
    end = text.index("\n}\n", start)
    body = text[start:end]
    if body.count(old) != 1:
        raise RuntimeError(f"the edited text is not in {kernel} once: {old!r}")
    return text[:start] + body.replace(old, new) + text[end:]


def build_variants(out_dir, variants=None, kernel="flash_fwd_wgmma_kernel", parent=None):
    """Compile every variant, and with `parent` (a checkout's root) that
    checkout's source as variant "parent" (all nvcc processes started
    together). Returns ({name: loaded library}, {name: ptxas output})."""
    from trlx_tpu_torch import kernels

    src = (kernels.CSRC / "flash_attention.cu").read_text()
    sources = {}
    for name, (_, edits) in (variants or VARIANTS).items():
        text = src
        for edit in edits:
            target, old, new = edit if len(edit) == 3 else (kernel, *edit)
            text = edit_kernel(text, target, old, new)
        sources[name] = (text, kernels.CSRC)
    if parent is not None:
        csrc = Path(parent) / "trlx_tpu_torch" / "csrc"
        sources["parent"] = ((csrc / "flash_attention.cu").read_text(), csrc)
    procs = {}
    for name, (text, headers) in sources.items():
        d = out_dir / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "flash_attention.cu").write_text(text)
        for h in headers.glob("*.cuh"):
            (d / h.name).write_text(h.read_text())
        cmd = [kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(d / "lib.so"),
               str(d / "flash_attention.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs, logs = {}, {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{out}")
        logs[name] = out
        lib = ctypes.CDLL(str(out_dir / name / "lib.so"))
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.trlx_flash_fwd.argtypes = [ptr] * 6 + [i32] * 8 + [f32, ptr]
        lib.trlx_flash_fwd.restype = i32
        lib.trlx_flash_bwd_dq.argtypes = [ptr] * 8 + [i32] * 8 + [f32, ptr]
        lib.trlx_flash_bwd_dq.restype = i32
        lib.trlx_flash_bwd_dkv.argtypes = [ptr] * 9 + [i32] * 8 + [f32, ptr]
        lib.trlx_flash_bwd_dkv.restype = i32
        libs[name] = lib
    return libs, logs


def resources(log, mangled):
    """ptxas's registers and spills of the kernel whose mangled name
    contains `mangled`."""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry" in line and mangled in line:
            return "; ".join(l.split(":", 1)[-1].strip() for l in lines[i + 1:i + 4] if "spill" in l or "Used" in l)
    return "not found"


def main() -> int:
    import torch

    from chip_smoke import FLASH_SHAPES, card_line, device_time_ms, flash_bound, flash_case, sdpa_calls

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shape", default="gpt2-small", choices=sorted(FLASH_SHAPES))
    ap.add_argument("--parent", default=None, help="root of another checkout, timed as variant 'parent'")
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS), choices=list(VARIANTS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    variants = {name: VARIANTS[name] for name in ["full", *args.variants]}  # "full" is what others are read against
    b, t, nh, nkv, hd, pads, _ = FLASH_SHAPES[args.shape]
    libs, logs = build_variants(ROOT / "build" / "flash_fwd_ablation", variants, parent=args.parent)
    # the parent's kernel at this head dim may be another template (the
    # CUDA-core forward at hd 256): report every entry it compiled
    used = {name: resources(log, f"flash_fwd_wgmma_kernelILi{hd}ELb0E") for name, log in logs.items()}
    if "parent" in logs and used["parent"] == "not found":
        used["parent"] = resources(logs["parent"], f"flash_fwd_kernelI13__nv_bfloat16Li{hd}ELb0E")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    q, k, v, mask, g, _, _ = flash_case(b, t, nh, nkv, hd, pads, gen, torch.device("cuda"))
    outs = {name: torch.empty_like(q) for name in libs}
    stream = torch.cuda.current_stream().cuda_stream

    def call(name):
        rc = libs[name].trlx_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
                                       outs[name].data_ptr(), None, 1, b, t, t, nh, nkv, hd, 1,
                                       1.0 / math.sqrt(hd), stream)
        if rc != 0:
            raise RuntimeError(f"{name}: launch failed: CUDA error {rc}")

    print(f"card: {card}; shape {args.shape}: b {b}, t {t}, {nh}/{nkv} heads of {hd}")
    times = {}
    for _ in range(2):  # two passes in turns; the second pass is reported
        for name in libs:
            times[name] = device_time_ms(lambda: call(name), 20)
    torch.cuda.synchronize()
    parent_err = None
    if "parent" in libs:  # both round once to bf16: one ulp apart at most
        parent_err = float((outs["parent"].float() - outs["full"].float()).abs().max())
        torch.testing.assert_close(outs["parent"].float(), outs["full"].float(), rtol=8e-3, atol=1e-3)
    sdpa_ms = device_time_ms(sdpa_calls(q, k, v, g, nh, nkv)[0], 20)
    bound_ms, bound_by = flash_bound(b, t, nh, nkv, hd, pads, "fwd")
    for name in libs:
        what = "the parent checkout's kernel" if name == "parent" else VARIANTS[name][0]
        print(f"  {name:13s} {times[name]:.5f} ms ({times[name] - times['full']:+.5f} vs full): {what} "
              f"[{used[name]}]")
    if parent_err is not None:
        print(f"  parent vs full: max abs difference of the outputs {parent_err:.3g}")
    print(f"  SDPA forward  {sdpa_ms:.5f} ms; bound {bound_ms:.5f} ms ({bound_by})")
    print(json.dumps({"card": card, "shape": args.shape, "ms": times, "sdpa_ms": sdpa_ms, "bound_ms": bound_ms,
                      "ptxas": used, "parent_max_abs_diff": parent_err}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
