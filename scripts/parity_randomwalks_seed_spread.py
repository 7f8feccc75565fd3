"""The spread of randomwalks curve stages between training seeds, on the
CPU, for both packages: the JAX package's stages of
`scripts/parity_randomwalks.py` (its own warm start, as behind
PARITY_CURVES.json) and the port's of `scripts/parity_randomwalks_torch.py`
(the port's warm start), each method at each seed. A method whose port
curve misses the band is held to this spread: if the two packages spread
alike between seeds, the miss is seed noise; if not, it is a fault.

    JAX_PLATFORMS=cpu python scripts/parity_randomwalks_seed_spread.py \
        --methods grpo rft --seeds 1000 1001

Both packages take the task from `_generate_random_walks_local` (the JAX
stages fall back to it where the reference checkout is absent). The
warm starts keep seed 1000; `--seeds` sets the methods' training seed.
With `--cross` each package starts from the other's warm start instead
(both warm starts made first), which separates a difference of the
trainers from one of the warm starts. Writes <workdir>/spread.json: per
method, package (`jax`, `port`, or `jax_from_port`, `port_from_jax`) and
seed, the mean of the last quarter of the eval points, the final point
and the count.
"""

import argparse
import json
import os
import shutil
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

import parity_randomwalks_torch as P  # noqa: E402  (after the path)

J = P.J
JAX_STAGES = {"ppo": "cmd_ours_ppo", "ppo_dense": "cmd_ours_ppo_dense", "ilql": "cmd_ours_ilql",
              "sft": "cmd_ours_sft", "rft": "cmd_ours_rft", "grpo": "cmd_ours_grpo"}


def _summary(path):
    evals, _ = J._load_curve(path)
    return J._summary(evals)


def _warm_start(root, other):
    """Copy the other package's warm start into `root/ckpt`, once."""
    if not os.path.exists(os.path.join(root, "ckpt")):
        shutil.copytree(os.path.join(other, "ckpt"), os.path.join(root, "ckpt"))


def run_jax(method, seed, workdir, cross=False):
    """The JAX script's stage at `seed`, under `workdir/jax` (its warm
    start made once there, at the script's own seed), or from the port's
    warm start under `workdir/jax_from_port`."""
    root = os.path.join(workdir, "jax_from_port" if cross else "jax")
    if cross:
        _warm_start(root, os.path.join(workdir, "port"))
    J.WORKDIR, J.CKPT = root, os.path.join(root, "ckpt")
    if not os.path.exists(os.path.join(J.CKPT, "pytorch_model.bin")):
        J.SEED = 1000
        J.cmd_prepare(argparse.Namespace(warm_steps=100))
    J.SEED = seed
    getattr(J, JAX_STAGES[method])(None)
    out = os.path.join(root, f"ours_{method}.curve.jsonl")
    os.replace(out, os.path.join(root, f"{method}.seed{seed}.curve.jsonl"))
    return _summary(os.path.join(root, f"{method}.seed{seed}.curve.jsonl"))


def run_port(method, seed, workdir, cross=False):
    """The port script's stage at `seed` on the CPU, under `workdir/port`
    (its warm start made once there), or from the JAX package's warm start
    under `workdir/port_from_jax`."""
    root = os.path.join(workdir, "port_from_jax" if cross else "port")
    if cross:
        _warm_start(root, os.path.join(workdir, "jax"))
    args = argparse.Namespace(device="cpu", workdir=root, warm_steps=100, epochs=None, seed=seed, where="")
    os.makedirs(root, exist_ok=True)
    if not os.path.exists(os.path.join(root, "ckpt", "pytorch_model.bin")):
        P.cmd_prepare(args)
    P.STAGES[method.replace("_", "-")](args)
    os.replace(os.path.join(root, f"{method}.curve.jsonl"), os.path.join(root, f"{method}.seed{seed}.curve.jsonl"))
    return _summary(os.path.join(root, f"{method}.seed{seed}.curve.jsonl"))


def main():
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--methods", nargs="+", default=["grpo"], choices=sorted(JAX_STAGES))
    parser.add_argument("--seeds", nargs="+", type=int, default=[1000, 1001])
    parser.add_argument("--packages", nargs="+", default=["jax", "port"], choices=["jax", "port"])
    parser.add_argument("--workdir", default=os.path.join(REPO, "logs", "parity_randomwalks_spread"))
    parser.add_argument("--cross", action="store_true", help="start each package from the other's warm start")
    args = parser.parse_args()
    path = os.path.join(args.workdir, "spread.json")
    os.makedirs(args.workdir, exist_ok=True)
    spread = json.load(open(path)) if os.path.exists(path) else {}
    for method in args.methods:
        for package in args.packages:
            for seed in args.seeds:
                t0 = time.time()
                s = (run_jax if package == "jax" else run_port)(method, seed, args.workdir, args.cross)
                label = f"{package}_from_{'port' if package == 'jax' else 'jax'}" if args.cross else package
                spread.setdefault(method, {}).setdefault(label, {})[str(seed)] = {
                    k: round(v, 4) if isinstance(v, float) else v for k, v in s.items()}
                print(f"[spread] {method} {label} seed {seed}: last-q {s['mean_last_quarter']:.4f}, final "
                      f"{s['final']:.4f}, {s['n_points']} points ({time.time() - t0:.0f} s)", flush=True)
                with open(path, "w") as f:
                    json.dump(spread, f, indent=2)
    print(json.dumps(spread, indent=2))


if __name__ == "__main__":
    main()
