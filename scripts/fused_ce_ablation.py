#!/usr/bin/env python3
"""What the redesigned label logprob (K7) and its backward kernel gain,
measured on one CUDA device: the parent commit's kernel and the new one in
one call, the new kernels' levers one by one, the CE layer and the SFT
step and PPO cycle of both trees, and the SFT step's backward memory.

The parent is a checkout of the previous commit, unpacked beside the repo:

    python3 scripts/fused_ce_ablation.py --unpack REV   # here: git archive REV into build/parent
    python3 scripts/fused_ce_ablation.py                # on the card

On the card it
1. builds the parent's `trlx_tpu_torch/csrc/fused_ce.cu` and one library
   of the new kernels' template configurations (the package's source
   included into a file of this script's own, one `extern "C"` entry per
   lever: 4-byte loads instead of 16-byte vectors, the max taken after
   converting instead of over packed bf16, libm `expf` instead of
   `ex2.approx`, a quarter of the exponentials on the FMA units, 1, 2 or 8
   vectors a tile, and the split plan forced to 1, 2, 4 or 8 blocks a row)
   into `build/fused_ce_ablation/`;
2. times each at chip_smoke.py phase 6's three shapes ([8184, 50257] SFT,
   [128 x 104, 50257] PPO scoring, [32 x 40, 50257] a PPO step's window,
   bf16), the forward and, at the SFT and window shapes, the backward
   (its torch passes, the parent's backward, beside the new kernel and its
   levers), device time per call from torch.profiler, two passes in turns
   (the second reported), each beside its bytes bound;
3. with `--package DIR` in a process of its own for the parent and this
   tree in turns (parent, new, new, parent): the CE layer as the trainers
   call it (`causal_lm_ce_loss` forward and backward at SFT's [8, 1024,
   50257]; `shifted_logprobs` at the scoring shape; the window's
   `logprobs_of_labels` forward and backward), and the peak memory of one
   SFT step's backward (`torch.cuda.max_memory_allocated`);
4. runs each tree's `scripts/profile_torch_train.py` (an SFT step's device
   time by kernel) and `scripts/profile_torch_ppo.py` (a PPO cycle's).

Prints one JSON line at the end.
"""

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

VOCAB = 50257
SHAPES = {"sft": 8 * 1023, "ppo-score": 128 * 104, "ppo-train": 32 * 40}  # rows of [N, VOCAB] bf16
BWD_SHAPES = ("sft", "ppo-train")
# name: (what it shows, FwdCfg<BYTES, TILE, EXP, HMAX> or None, forced splits or None)
FWD = {
    "new": ("the kernel as the package builds it (16-byte vectors, 4 a tile, ex2.approx, packed max, planned "
            "split)", None, None),
    "words4": ("4-byte loads (one bf16 pair a load) instead of 16-byte vectors", "FwdCfg<4, 4, 1, true>", None),
    "no_hmax": ("the tile max taken after converting to f32, not over packed bf16", "FwdCfg<16, 4, 1, false>", None),
    "expf": ("libm expf of the difference (as the parent) instead of ex2.approx", "FwdCfg<16, 4, 0, true>", None),
    "soft_exp": ("a quarter of the exponentials on the FMA units (a degree-5 polynomial)",
                 "FwdCfg<16, 4, 2, true>", None),
    "tile1": ("one vector a tile: a rescale every 8 elements, 16 bytes in flight a thread",
              "FwdCfg<16, 1, 1, true>", None),
    "tile2": ("two vectors a tile", "FwdCfg<16, 2, 1, true>", None),
    "tile8": ("eight vectors a tile", "FwdCfg<16, 8, 1, true>", None),
    "split1": ("one block a row (no cluster)", None, 1),
    "split2": ("two blocks a row", None, 2),
    "split4": ("four blocks a row", None, 4),
    "split8": ("eight blocks a row", None, 8),
}
# name: (what it shows, BwdCfg<BYTES, TILE> or None, forced splits or None)
BWD = {
    "new": ("the backward kernel as the package builds it (16-byte vectors, 4 a tile, planned split)", None, None),
    "words4": ("4-byte loads and stores", "BwdCfg<4, 4>", None),
    "tile1": ("one vector in flight a thread", "BwdCfg<16, 1>", None),
    "tile8": ("eight vectors in flight a thread", "BwdCfg<16, 8>", None),
    "split1": ("one block a row", None, 1),
    "split2": ("two blocks a row", None, 2),
    "split4": ("four blocks a row", None, 4),
    "split8": ("eight blocks a row", None, 8),
}
OUT = ROOT / "build" / "fused_ce_ablation"


def unpack(rev, parent):
    """Unpack commit `rev` of this repository into `parent` (git archive)."""
    parent.mkdir(parents=True, exist_ok=True)
    archive = subprocess.run(["git", "-C", str(ROOT), "archive", rev], capture_output=True, check=True).stdout
    subprocess.run(["tar", "-x", "-C", str(parent)], input=archive, check=True)
    print(f"unpacked {rev} into {parent}")


def variant_source():
    """The package's fused_ce.cu included into a file with one entry per
    lever configuration."""
    from trlx_tpu_torch import kernels

    lines = [f'#include "{kernels.CSRC / "fused_ce.cu"}"', ""]
    sig = "(const void* x, const void* lab, void* a, void* b, int n, int v, int dt, int sp, void* st)"
    for name, (_, cfg, _) in FWD.items():
        if cfg:
            lines.append(f'extern "C" int abl_fwd_{name}{sig} {{ auto s = (cudaStream_t)st; return dt == 1 ? '
                         f"launch_fwd<__nv_bfloat16, {cfg}>(x, (const int32_t*)lab, (float*)a, (float*)b, n, v, sp, "
                         f"s) : launch_fwd<float, {cfg}>(x, (const int32_t*)lab, (float*)a, (float*)b, n, v, sp, s); }}")
    bsig = "(const void* x, const void* lab, const void* lse, const void* g, void* d, int n, int v, int dt, int sp, void* st)"
    for name, (_, cfg, _) in BWD.items():
        if cfg:
            lines.append(f'extern "C" int abl_bwd_{name}{bsig} {{ auto s = (cudaStream_t)st; return dt == 1 ? '
                         f"launch_bwd<__nv_bfloat16, {cfg}>(x, (const int32_t*)lab, (const float*)lse, "
                         f"(const float*)g, d, n, v, sp, s) : launch_bwd<float, {cfg}>(x, (const int32_t*)lab, "
                         f"(const float*)lse, (const float*)g, d, n, v, sp, s); }}")
    return "\n".join(lines) + "\n"


def build(parent):
    """Compile the parent's kernel and the lever library (both nvcc started
    together). Returns (parent library, lever library)."""
    from trlx_tpu_torch import kernels

    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "levers.cu").write_text(variant_source())
    jobs = {"parent": parent / "trlx_tpu_torch" / "csrc" / "fused_ce.cu", "levers": OUT / "levers.cu"}
    procs = {name: subprocess.Popen([kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-o",
                                     str(OUT / f"lib{name}.so"), str(src)],
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for name, src in jobs.items()}
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        for line in out.splitlines():
            if any(k in line for k in ("entry function", "registers", "spill", "arning")):
                print(f"[build {name}] {line.strip()}")
        libs[name] = ctypes.CDLL(str(OUT / f"lib{name}.so"))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    libs["parent"].trlx_label_logprobs.argtypes = [ptr] * 4 + [i32] * 3 + [ptr]
    libs["parent"].trlx_label_logprobs.restype = i32
    for name, (_, cfg, _) in FWD.items():
        if cfg:
            fn = getattr(libs["levers"], f"abl_fwd_{name}")
            fn.argtypes, fn.restype = [ptr] * 4 + [i32] * 4 + [ptr], i32
    for name, (_, cfg, _) in BWD.items():
        if cfg:
            fn = getattr(libs["levers"], f"abl_bwd_{name}")
            fn.argtypes, fn.restype = [ptr] * 5 + [i32] * 4 + [ptr], i32
    return libs["parent"], libs["levers"]


def checked(rc):
    if rc != 0:
        raise RuntimeError(f"launch failed: CUDA error {rc}")


def kernel_times(card, parent_dir):
    import torch

    from chip_smoke import HBM_BYTES_PER_S, device_time_ms
    from trlx_tpu_torch.ops import fused_ce as F

    parent, levers = build(parent_dir)
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = lambda: torch.cuda.current_stream().cuda_stream
    times, bounds, errs = {}, {}, {}
    for shape, n in SHAPES.items():
        x = torch.randn(n, VOCAB, generator=gen, device="cuda").mul_(3).to(torch.bfloat16)
        lab = torch.randint(0, VOCAB, (n,), generator=gen, device="cuda", dtype=torch.int32)
        g = torch.randn(n, generator=gen, device="cuda")
        out, lse = torch.empty(n, device="cuda"), torch.empty(n, device="cuda")
        d = torch.empty_like(x)
        plan, bwd_plan = F.split_plan(n, VOCAB, 2), F.bwd_split_plan(VOCAB, 2)
        ptrs = (x.data_ptr(), lab.data_ptr(), out.data_ptr(), lse.data_ptr())
        calls = {"fwd/parent": lambda: checked(parent.trlx_label_logprobs(*ptrs, n, VOCAB, 1, stream()))}
        for name, (_, cfg, splits) in FWD.items():
            if cfg:
                fn = getattr(levers, f"abl_fwd_{name}")
                calls[f"fwd/{name}"] = lambda fn=fn: checked(fn(*ptrs, n, VOCAB, 1, plan, stream()))
            elif splits:
                calls[f"fwd/{name}"] = lambda s=splits: checked(F._load().trlx_label_logprobs(*ptrs, n, VOCAB, 1, s,
                                                                                          stream()))
            else:
                calls[f"fwd/{name}"] = lambda: F.label_logprobs(x, lab)
        # every forward configuration against the plain version once (an
        # ablated lever changes the time, not the function)
        ref_out, ref_lse = F.label_logprobs_plain(x, lab)
        for name, call in calls.items():
            lse.fill_(float("nan"))
            got = call()
            torch.cuda.synchronize()
            errs[f"{shape}/{name}"] = float(((got[1] if got is not None else lse) - ref_lse).abs().max())
        if shape in BWD_SHAPES:
            bptrs = (x.data_ptr(), lab.data_ptr(), ref_lse.data_ptr(), g.data_ptr(), d.data_ptr())
            calls["bwd/torch_passes"] = lambda: F.label_logprobs_bwd_plain(x, lab, ref_lse, g)
            for name, (_, cfg, splits) in BWD.items():
                if cfg:
                    fn = getattr(levers, f"abl_bwd_{name}")
                    calls[f"bwd/{name}"] = lambda fn=fn: checked(fn(*bptrs, n, VOCAB, 1, bwd_plan, stream()))
                elif splits:
                    calls[f"bwd/{name}"] = lambda s=splits: checked(
                        F._load().trlx_label_logprobs_bwd(*bptrs, n, VOCAB, 1, s, stream()))
                else:
                    calls[f"bwd/{name}"] = lambda: F.label_logprobs_bwd(x, lab, ref_lse, g)
            want = F.label_logprobs_bwd_plain(x, lab, ref_lse, g).float()
            for name in [k for k in calls if k.startswith("bwd/") and k != "bwd/torch_passes"]:
                d.fill_(float("nan"))
                got = calls[name]()
                torch.cuda.synchronize()
                errs[f"{shape}/{name}"] = float(((got if got is not None else d).float() - want).abs().max())
            del want
        for _ in range(2):  # two passes in turns; the second is reported
            for name, call in calls.items():
                iters = 3 if name == "bwd/torch_passes" else 20
                times[f"{shape}/{name}"] = device_time_ms(call, iters, label=f"{shape} {name}")
        bounds[f"{shape}/fwd"] = (n * VOCAB * 2 + n * 12) / HBM_BYTES_PER_S * 1e3
        bounds[f"{shape}/bwd"] = (2 * n * VOCAB * 2 + n * 12) / HBM_BYTES_PER_S * 1e3
        del x, lab, g, out, lse, d, ref_out, ref_lse, calls
        torch.cuda.empty_cache()
    for shape, n in SHAPES.items():
        print(f"{shape} [{n}, {VOCAB}] bf16, split plans: forward {F.split_plan(n, VOCAB, 2)}, "
              f"backward {F.bwd_split_plan(VOCAB, 2)}:")
        for kind, table in (("fwd", FWD), ("bwd", BWD)):
            if f"{shape}/{kind}/new" not in times:
                continue
            bound, new = bounds[f"{shape}/{kind}"], times[f"{shape}/{kind}/new"]
            print(f"  {kind}: bound {bound:.5f} ms (bytes); new {new:.5f} ms = {bound / new:.3f} of the bound")
            before = "parent" if kind == "fwd" else "torch_passes"
            what = {before: "the parent's" if kind == "fwd" else "the torch passes (the parent's backward)"}
            for name in [before, *table]:
                ms = times[f"{shape}/{kind}/{name}"]
                err = errs.get(f"{shape}/{kind}/{name}")
                print(f"    {name:12s} {ms:.5f} ms ({ms - new:+.5f} vs new)"
                      + ("" if err is None else f" max err {err:.3g}") + f": {what.get(name) or table[name][0]}")
    return {"card": card, "ms": times, "bound_ms": bounds, "max_abs_err": errs}


def package_times(card, package):
    """The CE layer of the checkout at `package` as its trainers call it,
    and its SFT step's backward peak memory."""
    import torch

    from chip_smoke import device_time_ms, sft_samples, training_config
    from trlx_tpu_torch.trainer.ppo_trainer import shifted_logprobs
    from trlx_tpu_torch.trainer.sft_trainer import SFTTrainer, causal_lm_ce_loss
    from trlx_tpu_torch.utils.modeling import logprobs_of_labels

    gen = torch.Generator(device="cuda").manual_seed(0)
    res = {}
    logits = torch.randn(8, 1024, VOCAB, generator=gen, device="cuda").mul_(3).to(torch.bfloat16)
    ids = torch.randint(0, VOCAB, (8, 1024), generator=gen, device="cuda")
    mask = torch.ones(8, 1024, dtype=torch.long, device="cuda")
    x = logits.requires_grad_(True)

    def sft_loss():
        loss, _ = causal_lm_ce_loss(x, ids, mask)
        torch.autograd.grad(loss, x)

    res["sft_loss_fwd_bwd"] = device_time_ms(sft_loss, 5, label="sft loss")
    del logits, x
    scores = torch.randn(128, 104, VOCAB, generator=gen, device="cuda").mul_(3).to(torch.bfloat16)
    tokens = torch.randint(0, VOCAB, (128, 104), generator=gen, device="cuda")
    with torch.no_grad():
        res["ppo_score_fwd"] = device_time_ms(lambda: shifted_logprobs(scores, tokens), 10, label="scoring")
    del scores
    window = torch.randn(32, 40, VOCAB, generator=gen, device="cuda").mul_(3).to(torch.bfloat16).requires_grad_(True)
    labels = tokens[:32, 64:104]
    res["ppo_window_fwd_bwd"] = device_time_ms(
        lambda: torch.autograd.grad(logprobs_of_labels(window, labels).sum(), window), 10, label="window")
    del window
    torch.cuda.empty_cache()

    trainer = SFTTrainer(training_config(ROOT / "build" / "fused_ce_ablation" / "sft"))
    trainer.make_experience(sft_samples(), 1024)
    batch = trainer.batch_to_device(next(iter(trainer.store.create_loader(8))))
    for _ in range(2):  # the first builds the kernels and warms cuBLAS
        loss, _ = trainer.make_loss_fn()(batch)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        loss.backward()
        torch.cuda.synchronize()
        trainer.model.zero_grad(set_to_none=True)
    res["sft_backward_peak_bytes"] = torch.cuda.max_memory_allocated()
    res["sft_backward_peak_above_start_bytes"] = torch.cuda.max_memory_allocated() - base
    print(json.dumps({"card": card, "package": str(package), **res}))
    return res


def run_json(cmd):
    """Run a command; its last stdout line, parsed as JSON."""
    print("$ " + " ".join(str(c) for c in cmd), flush=True)
    proc = subprocess.run([str(c) for c in cmd], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{cmd} failed ({proc.returncode}):\n{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    lines = proc.stdout.strip().splitlines()
    for line in lines[:-1]:
        print("  " + line)
    return json.loads(lines[-1])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--unpack", metavar="REV", help="unpack commit REV into --parent (git archive), then exit")
    ap.add_argument("--parent", default=str(ROOT / "build" / "parent"), help="a checkout of the parent commit")
    ap.add_argument("--package", help="time the CE layer of the checkout at this path (a process of its own)")
    args = ap.parse_args()
    parent = Path(args.parent).resolve()
    if args.unpack:
        unpack(args.unpack, parent)
        return 0
    import torch

    from chip_smoke import card_line  # this tree's timing for both trees

    if args.package:  # that checkout's package
        sys.path.insert(0, str(Path(args.package).resolve()))

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    print(f"card: {card}", flush=True)
    if args.package:
        package_times(card, args.package)
        return 0
    if not (parent / "trlx_tpu_torch" / "csrc" / "fused_ce.cu").exists():
        print(f"no parent checkout at {parent}: run with --unpack REV first", file=sys.stderr)
        return 2
    report = {"kernels": kernel_times(card, parent)}
    me = Path(__file__).resolve()
    trees = {"parent": parent, "new": ROOT}
    layer = {}
    for tree in ("parent", "new", "new", "parent"):
        layer.setdefault(tree, []).append(run_json([sys.executable, me, "--package", trees[tree]]))
    report["layer"] = layer
    report["profile_train"] = {t: run_json([sys.executable, trees[t] / "scripts" / "profile_torch_train.py"])
                               for t in ("parent", "new")}
    report["profile_ppo"] = {t: run_json([sys.executable, trees[t] / "scripts" / "profile_torch_ppo.py"])
                             for t in ("new", "parent")}
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
