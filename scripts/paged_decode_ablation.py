#!/usr/bin/env python3
"""What holds the split paged decode (K1 on bf16 KV) back, measured by
ablation on one CUDA device; and the wrapper of any checkout timed at
every phase-3 shape, to compare two trees in one call.

Default: builds variants of `trlx_tpu_torch/csrc/paged_attention.cu` into
`build/paged_decode_ablation/` (a textual edit each, or another split plan
passed to the same library) and times each at `chip_smoke.py` phase 3's
gpt2-small, MQA and gqa-4k cases with bf16 KV, device time per call from
torch.profiler, rotating the arena pairs as phase 3 does. A variant's
answers may be wrong by construction: only its time is read. SDPA over
the gathered KV is timed beside them as the yardstick, and each case's
bytes bound with the share of it the full kernel reaches. Prints one JSON
line at the end.

    python3 scripts/paged_decode_ablation.py [--variants full,no_ring,...]
    python3 scripts/paged_decode_ablation.py --package DIR

With `--package DIR`, imports `trlx_tpu_torch` from the checkout at DIR
(built into DIR/build/kernels) and times its `paged_attention_decode` at
every phase-3 shape, bf16 and int8 KV: run it on two trees in turns in one
call to compare them.
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

ATTEND = "    attend_page<KV, QUANT, R>(P, st, valid_s + live_s[i] * blk, group, q_s, p_s, acc_s, m_s, l_s, corr_s);\n"
STAGE_FIRST = "    if (t < n_live) stage_page<KV, QUANT, R>(P, kvh, entry_s[live_s[t]], tiles + t * L.stage);\n"
STAGE_NEXT = "    if (i + S < n_live) stage_page<KV, QUANT, R>(P, kvh, entry_s[live_s[i + S]], st);\n"
KERNEL = "template <typename T, typename KV, bool QUANT, int R>\n__global__"
SCORES = "  for (int c0 = warp * per_pass; c0 < blk; c0 += WARPS * per_pass) {\n"
SOFTMAX = "  for (int g0 = warp * 4; g0 < group; g0 += WARPS * 4) {\n"
PV = "  for (int base = warp * per_warp; base < items; base += WARPS * per_warp) {\n"
THREADS = "constexpr int THREADS = 128;\n"
STAGE_SIZE = "  L.stage = align16((size_t)2 * blk * hd * kv_bytes) + (quant ? align16((size_t)2 * blk * 4) : 0);\n"
# the f32_tiles variant: each stage also holds its K/V widened to f32 (and
# dequantized), written by a pass over the landed tile before the page's compute
WIDEN = """__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

template <typename KV, bool QUANT>
__device__ void widen_stage(const Params& P, char* st, size_t stage_bytes) {
  const int n = P.blk * P.hd;
  const KV* raw = reinterpret_cast<const KV*>(st);
  const float* sc = reinterpret_cast<const float*>(st + align16((size_t)2 * n * sizeof(KV)));
  float* w = reinterpret_cast<float*>(st + stage_bytes - (size_t)2 * n * 4);
  for (int i = threadIdx.x; i < 2 * n; i += THREADS) {
    float x = to_f32(raw[i]);
    if (QUANT) x *= sc[(i / n) * P.blk + (i % n) / P.hd];
    w[i] = x;
  }
}

"""
WIDENED_ATTEND = """    widen_stage<KV, QUANT>(P, st, L.stage);
    __syncthreads();
    attend_page<float, false, R>(P, st + L.stage - (size_t)2 * blk * hd * 4, valid_s + live_s[i] * blk, group,
                                 q_s, p_s, acc_s, m_s, l_s, corr_s);
"""

# name: (what it shows, [(text in the source, replacement)], split plan or None for the port's)
VARIANTS = {
    "full": ("the kernel and split plan as the port uses them", [], None),
    "one_split": ("one split a row, every page in one block (one block per kv head and slot, as before the split)", [],
                  lambda b, nkv, n_tbl: (n_tbl, 1)),
    "no_ring": ("one stage: each page's copy waited for before the next one is issued", [], "stages=1"),
    "three_stages": ("a ring of up to three stages instead of two", [], "stages=3"),
    "four_stages": ("a ring of up to four stages instead of two", [], "stages=4"),
    "two_pages": ("two pages a split", [], lambda b, nkv, n_tbl: (min(2, n_tbl), -(-n_tbl // 2))),
    "grid_512": ("a split plan held to 512 blocks instead of 1024", [], "grid=512"),
    "grid_640": ("a split plan held to 640 blocks (one wave at five blocks an SM)", [], "grid=640"),
    "grid_768": ("a split plan held to 768 blocks", [], "grid=768"),
    "grid_1320": ("a split plan held to 1320 blocks (ten an SM)", [], "grid=1320"),
    "grid_2048": ("a split plan held to 2048 blocks instead of 1024", [], "grid=2048"),
    "loads_only": ("pages staged and waited for, nothing attended", [(ATTEND, "")], None),
    "no_scores": ("without the scores (q.k and their shuffles)", [(SCORES, SCORES.replace("warp * per_pass;", "blk;"))],
                  None),
    "no_softmax": ("without the online softmax", [(SOFTMAX, SOFTMAX.replace("warp * 4;", "group;"))], None),
    "no_pv": ("without p.V", [(PV, PV.replace("warp * per_warp;", "items;"))], None),
    "threads_256": ("256 threads a block instead of 128", [(THREADS, THREADS.replace("128", "256"))], None),
    "kv_major": ("the grid ordered (kv head, split, slot): a page's kv heads, one run of the arena, read together",
                 [("  const int split = blockIdx.x, kvh = blockIdx.y, row = blockIdx.z;",
                   "  const int kvh = blockIdx.x, split = blockIdx.y, row = blockIdx.z;"),
                  ("dim3(P.n_splits, P.nkv, b)", "dim3(P.nkv, P.n_splits, b)")], None),
    "f32_tiles": ("tiles widened to f32 in shared memory (a widening pass; 2x the bytes of bf16)",
                  [(STAGE_SIZE, STAGE_SIZE.replace(";\n", " + (size_t)2 * blk * hd * 4;\n")),
                   (KERNEL, WIDEN + KERNEL), (ATTEND, WIDENED_ATTEND)], None),
    "merge_only": ("no page staged or attended (m = 0, l = 1 as if live): the table and mask reads, "
                   "the partial writes and the merge", [(STAGE_FIRST, ""), (STAGE_NEXT, ""),
                   (ATTEND, "    for (int g = tid; g < group; g += THREADS) { m_s[g] = 0.f; l_s[g] = 1.f; }\n")],
                   None),
}
CASES = ("gpt2-small", "mqa", "gqa-4k")


def build_variants(out_dir, names):
    """Compile every edited variant of `names` (all nvcc processes started
    together). Returns {name: loaded library} ("full" also stands for the
    variants that change only the plan)."""
    from trlx_tpu_torch import kernels

    src = (kernels.CSRC / "paged_attention.cu").read_text()
    procs = {}
    for name in names:
        edits = VARIANTS[name][1]
        if name != "full" and not edits:
            continue
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"the edited text is not in the source once: {old!r}")
            text = text.replace(old, new)
        d = out_dir / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "paged_attention.cu").write_text(text)
        for h in kernels.CSRC.glob("*.cuh"):
            (d / h.name).write_text(h.read_text())
        cmd = [kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-o", str(d / "lib.so"), str(d / "paged_attention.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{out}")
        lib = ctypes.CDLL(str(out_dir / name / "lib.so"))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.trlx_paged_attention_decode.argtypes = [ptr] * 10 + [i32] * 10 + [ctypes.c_float] + [i32] * 3 + [ptr]
        lib.trlx_paged_attention_decode.restype = i32
        lib.trlx_paged_attention_record_floats.argtypes = [i32, i32]
        lib.trlx_paged_attention_record_floats.restype = ctypes.c_size_t
        libs[name] = lib
    return libs


def variant_call(lib, plan, q, layers, table, mask, n_layers):
    """A callable that launches `lib`'s kernel on the next arena pair with
    the given (pages_per_split, n_splits, stages)."""
    import torch

    pps, n_splits, stages = plan
    b, nh, hd = q.shape
    n_blocks, blk, nkv, _ = layers[0][0].shape
    n_tbl = table.shape[1]
    records = b * nkv * n_splits * lib.trlx_paged_attention_record_floats(nh // nkv, hd)
    partial = torch.empty(records, dtype=torch.float32, device=q.device)
    counters = torch.zeros(b * nkv, dtype=torch.int32, device=q.device)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream().cuda_stream
    it = iter(range(10**9))

    def call():
        k, v, _ = layers[next(it) % n_layers]
        rc = lib.trlx_paged_attention_decode(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), None, None, table.data_ptr(), mask.data_ptr(),
            out.data_ptr(), partial.data_ptr(), counters.data_ptr(), b, nh, nkv, hd, n_blocks, blk, n_tbl,
            pps, n_splits, stages, 1.0 / math.sqrt(hd), 1, 1, 4, stream)
        if rc != 0:
            raise RuntimeError(f"launch failed: CUDA error {rc}")

    return call


def plan_of(name, b, nkv, n_tbl):
    """(pages_per_split, n_splits, stages) of a variant: the port's plan,
    or another given as a function or as "stages=N" / "grid=N"."""
    from trlx_tpu_torch.ops.paged_attention import GRID_CAP, MAX_STAGES, split_plan

    plan = VARIANTS[name][2]
    key, _, value = plan.partition("=") if isinstance(plan, str) else ("", "", "")
    if callable(plan):
        pps, n_splits = plan(b, nkv, n_tbl)
    else:
        pps, n_splits = split_plan(b, nkv, n_tbl, int(value) if key == "grid" else GRID_CAP)
    stages = int(value) if key == "stages" else MAX_STAGES
    return pps, n_splits, min(pps, stages)


def ablation(card, names):
    import torch

    from chip_smoke import SHAPES, SLOTS, bound, device_time_ms, library_call, paged_case

    libs = build_variants(ROOT / "build" / "paged_decode_ablation", names)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    times, sdpa, bounds = {}, {}, {}
    for case in CASES:
        nh, nkv, hd, lens, n_tbl, n_layers = SHAPES[case]
        q, table, mask, layers = paged_case(nh, nkv, hd, "bf16", gen, torch.device("cuda"), lens, n_tbl, n_layers)
        calls = {name: variant_call(libs.get(name, libs["full"]), plan_of(name, SLOTS, nkv, n_tbl),
                                    q, layers, table, mask, n_layers) for name in names}
        for _ in range(2):  # two passes in turns; the second is reported
            for name, call in calls.items():
                times[f"{case}/{name}"] = device_time_ms(call, 240, label=f"{case} {name}")
        k, v, extra = layers[0]
        sdpa[case] = device_time_ms(library_call(q, k, v, table, mask, extra, nh, nkv), 240, label=f"{case} SDPA")
        bounds[case] = bound(nh, nkv, hd, "bf16", 2, lens, n_tbl)[0]
        del q, table, mask, layers, calls, k, v
        torch.cuda.empty_cache()
    for case in CASES:
        full = times[f"{case}/full"]
        print(f"{case}: SDPA {sdpa[case]:.5f} ms; bound {bounds[case]:.5f} ms (bytes), "
              f"the full kernel at {bounds[case] / full:.3f} of it")
        for name in names:
            what, ms = VARIANTS[name][0], times[f"{case}/{name}"]
            print(f"  {name:11s} {ms:.5f} ms ({ms - full:+.5f} vs full): {what}")
    print(json.dumps({"card": card, "ms": times, "sdpa_ms": sdpa, "bound_ms": bounds}))


def package_times(card, package):
    import torch

    sys.path.insert(0, str(Path(package).resolve()))
    from chip_smoke import SHAPES, device_time_ms, paged_case
    from trlx_tpu_torch.ops.paged_attention import paged_attention_decode

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    times = {}
    for case, (nh, nkv, hd, lens, n_tbl, n_layers) in SHAPES.items():
        for kv in ("bf16", "int8"):
            q, table, mask, layers = paged_case(nh, nkv, hd, kv, gen, torch.device("cuda"), lens, n_tbl, n_layers)
            it = iter(range(10**9))

            def call():
                k, v, extra = layers[next(it) % n_layers]
                paged_attention_decode(q, k, v, table, mask, **extra)

            times[f"{case}/{kv}"] = device_time_ms(call, 240, label=f"{case} {kv}")
            print(f"  {case}/{kv}: {times[f'{case}/{kv}']:.5f} ms")
            del q, table, mask, layers
            torch.cuda.empty_cache()
    print(json.dumps({"card": card, "package": str(package), "ms": times}))


def main() -> int:
    import torch

    from chip_smoke import card_line

    ap = argparse.ArgumentParser()
    ap.add_argument("--package", help="a checkout whose paged_attention_decode is timed at every phase-3 shape")
    ap.add_argument("--variants", default=",".join(VARIANTS), help="comma-separated variants (full is always timed)")
    args = ap.parse_args()
    names = ["full"] + [n for n in args.variants.split(",") if n != "full"]
    unknown = set(names) - set(VARIANTS)
    if unknown:
        ap.error(f"unknown variants {sorted(unknown)}; known: {list(VARIANTS)}")
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    print(f"card: {card}")
    if args.package:
        package_times(card, args.package)
    else:
        ablation(card, names)
    return 0


if __name__ == "__main__":
    sys.exit(main())
