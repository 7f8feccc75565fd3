"""The randomwalks learning curves of the PyTorch port (`trlx_tpu_torch`),
held against the JAX package's curves in PARITY_CURVES.json.

The port's side of `scripts/parity_randomwalks.py`: the same task (the
seed-1002 randomwalks graph of `_generate_random_walks_local`, loaded from
that script by file path; it imports JAX only inside its stages), the same
warm start (100 SFT steps of gpt2-tiny widened to d_model 144, 6 layers,
12 heads, d_ff 576, on the `char:` tokenizer, seed 1000), made here by the
port and exported with its `save_pretrained`, and every method then
loaded from that directory by `model_path`, with the hyperparameters of
the JAX script's `_ours_*` configs, stage for stage, at the preset's own
attention (`xla`) and dtype (bf16). The curves are captured by the JAX
script's own probes (`CurveRecorder`, `DenseCurveRecorder`).

Stages:
  prepare    warm-start SFT, exported to <workdir>/ckpt
  ppo, ppo-dense, ilql, sft, rft, grpo
             one method each, its eval curve to <workdir>/<method>.curve.jsonl
  compare    PARITY_CURVES_TORCH.json at the repo root: per method the
             port's eval curve, final, best, mean of the last quarter and
             point count, the JAX package's `ours` entry read unchanged
             from PARITY_CURVES.json, and their deltas
  all        prepare, the six methods and compare, in one process

    python scripts/parity_randomwalks_torch.py all            # on the card
    python scripts/parity_randomwalks_torch.py all --device cpu

The work directory defaults to logs/parity_randomwalks_torch (gitignored).
`--epochs N` cuts every method to N outer epochs and `--warm-steps` the
warm start; a cut run is a smoke test, not a curve. `--seed` changes the
methods' training seed (the warm start keeps seed 1000), for the spread
of a stage between seeds.
"""

import argparse
import importlib.util
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
METHODS = ("ppo", "ppo_dense", "ilql", "sft", "rft", "grpo")
# the JAX test's band (tests/test_parity_curves.py): the port's mean over
# the last quarter of its eval points may trail JAX's by at most this
TOLERANCE = 0.05
GRPO_VS_PPO = 0.9


def _jax_script():
    """scripts/parity_randomwalks.py, loaded by file path: its module level
    imports only the standard library (JAX is imported inside its stages)."""
    spec = importlib.util.spec_from_file_location("parity_randomwalks_jax",
                                                  os.path.join(REPO, "scripts", "parity_randomwalks.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


J = _jax_script()


def _task():
    """(metric_fn, eval_prompts, walks) of the seed-1002 randomwalks task."""
    return J._generate_random_walks_local(seed=1002)


def _configs():
    from trlx_tpu_torch.data import configs as c

    return c


def _epochs(args, n):
    return n if args.epochs is None else args.epochs


def _trl(args, name, trainer, epochs, eval_interval, lr, t_max, method, seq_length=10):
    """The JAX script's `_ours_*` sections: batch 100, AdamW at `lr` under
    a flat cosine schedule, the warm start's checkpoint by `model_path`,
    the `char:` tokenizer, checkpoints and metrics under the work dir."""
    c = _configs()
    return c.TRLConfig(
        train=c.TrainConfig(
            seq_length=seq_length, epochs=_epochs(args, epochs), total_steps=100000, batch_size=100,
            checkpoint_interval=10**8, eval_interval=eval_interval, pipeline="PromptPipeline", trainer=trainer,
            checkpoint_dir=os.path.join(args.workdir, f"{name}_ckpt"), logging_dir=os.path.join(args.workdir, "logs"),
            tracker=None, seed=args.seed, save_best=False,
        ),
        model=c.ModelConfig(model_path=os.path.join(args.workdir, "ckpt"), num_layers_unfrozen=-1),
        tokenizer=c.TokenizerConfig(tokenizer_path=f"char:{J.ALPHABET}", truncation_side="right"),
        optimizer=c.OptimizerConfig(name="adamw",
                                    kwargs=dict(lr=lr, betas=(0.9, 0.95), eps=1.0e-8, weight_decay=1.0e-6)),
        scheduler=c.SchedulerConfig(name="cosine_annealing", kwargs=dict(T_max=t_max, eta_min=lr)),
        method=method,
        parallel=c.ParallelConfig(),
    )


def _recorder(args, method, cls=None):
    metric_fn, eval_prompts, walks = _task()
    rec = (cls or J.CurveRecorder)(os.path.join(args.workdir, f"{method}.curve.jsonl"), metric_fn)
    return rec, metric_fn, eval_prompts, walks


# ---------------------------------------------------------------- stages

def cmd_prepare(args):
    """Warm-start SFT in the port (the JAX script's `cmd_prepare`
    overrides), exported with `save_pretrained`."""
    import trlx_tpu_torch
    from trlx_tpu_torch.data.default_configs import default_sft_config

    _metric_fn, eval_prompts, walks = _task()
    config = default_sft_config().evolve(
        model=dict(model_path="random:gpt2-tiny", num_layers_unfrozen=-1,
                   model_extra_configs=dict(d_model=144, n_layers=6, n_heads=12, d_ff=576, max_seq_len=64)),
        tokenizer=dict(tokenizer_path=f"char:{J.ALPHABET}"),
        train=dict(seq_length=10, batch_size=100, total_steps=args.warm_steps, epochs=max(args.warm_steps, 1),
                   eval_interval=10**9, checkpoint_interval=10**9, tracker=None, seed=J.SEED,
                   checkpoint_dir=os.path.join(args.workdir, "warm_sft"),
                   logging_dir=os.path.join(args.workdir, "logs")),
        method=dict(gen_kwargs=dict(max_new_tokens=4, do_sample=True)),
    )
    trainer = trlx_tpu_torch.train(samples=list(walks), eval_prompts=sorted(eval_prompts)[:4], config=config,
                                   device=args.device)
    ckpt = os.path.join(args.workdir, "ckpt")
    trainer.save_pretrained(ckpt)
    print(f"[prepare] exported to {ckpt}: {sorted(os.listdir(ckpt))}")


def _ppo_method():
    from trlx_tpu_torch.trainer.ppo_trainer import PPOConfig

    return PPOConfig(
        name="PPOConfig", num_rollouts=128, chunk_size=128, ppo_epochs=4, init_kl_coef=0, target=None,
        horizon=10000, gamma=1, lam=0.95, cliprange=0.2, cliprange_value=0.2, vf_coef=1.2,
        scale_reward="ignored", ref_mean=None, ref_std=None, cliprange_reward=1,
        gen_kwargs=dict(max_new_tokens=9, top_k=0, top_p=1.0, do_sample=True),
    )


def _online(args, method, config, cls=None):
    import trlx_tpu_torch

    rec, _, eval_prompts, _ = _recorder(args, method, cls)
    trlx_tpu_torch.train(reward_fn=rec.reward_fn, prompts=sorted(eval_prompts),
                         eval_prompts=J.eval_prompt_list(eval_prompts), metric_fn=rec.metric_fn, config=config,
                         device=args.device)
    print(f"[{method}] wrote {rec.path}: {rec.n_eval_calls} evals, {rec.n_reward_calls} reward calls")


def cmd_ppo(args):
    _online(args, "ppo", _trl(args, "ppo", "PPOTrainer", J.PPO_EPOCHS_OUTER, J.PPO_EVAL_INTERVAL, 3.0e-4, 10000,
                              _ppo_method()))


def cmd_ppo_dense(args):
    _online(args, "ppo_dense", _trl(args, "ppo_dense", "PPOTrainer", J.PPO_DENSE_EPOCHS_OUTER,
                                    J.PPO_EVAL_INTERVAL, 3.0e-4, 10000, _ppo_method()), J.DenseCurveRecorder)


def cmd_grpo(args):
    from trlx_tpu_torch.trainer.grpo_trainer import GRPOConfig

    method = GRPOConfig(
        name="GRPOConfig", num_rollouts=128, chunk_size=128, ppo_epochs=4, group_size=J.GRPO_GROUP_SIZE,
        advantage_mode="grpo", grpo_kl_coef=0.001, init_kl_coef=0, target=None, horizon=10000, cliprange=0.2,
        scale_reward=None, ref_mean=None, ref_std=None, cliprange_reward=1,
        gen_kwargs=dict(max_new_tokens=9, top_k=0, top_p=1.0, do_sample=True),
    )
    _online(args, "grpo", _trl(args, "grpo", "GRPOTrainer", J.GRPO_EPOCHS_OUTER, J.PPO_EVAL_INTERVAL, 3.0e-4,
                               10000, method))


def cmd_rft(args):
    from trlx_tpu_torch.trainer.rft_trainer import RFTConfig

    _online(args, "rft", _trl(args, "rft", "RFTTrainer", J.RFT_EPOCHS, J.RFT_EVAL_INTERVAL, 1.0e-4, 1000,
                              RFTConfig(name="RFTConfig", **J._rft_method_kwargs())))


def cmd_sft(args):
    import trlx_tpu_torch
    from trlx_tpu_torch.trainer.sft_trainer import SFTConfig

    rec, _, eval_prompts, walks = _recorder(args, "sft")
    config = _trl(args, "sft", "SFTTrainer", J.SFT_EPOCHS, J.SFT_EVAL_INTERVAL, 1.0e-4, 1000,
                  SFTConfig(name="sftconfig", gen_kwargs=dict(max_new_tokens=9, top_k=0, top_p=1.0, do_sample=True)))
    trlx_tpu_torch.train(samples=list(walks), eval_prompts=J.eval_prompt_list(eval_prompts), metric_fn=rec.metric_fn,
                         config=config, device=args.device)
    print(f"[sft] wrote {rec.path}: {rec.n_eval_calls} evals")


def cmd_ilql(args):
    import trlx_tpu_torch
    from trlx_tpu_torch.trainer.ilql_trainer import ILQLConfig

    rec, metric_fn, eval_prompts, walks = _recorder(args, "ilql")
    method = ILQLConfig(name="ilqlconfig", tau=0.8, gamma=0.99, cql_scale=0.1, awac_scale=1, alpha=0.1, beta=0,
                        steps_for_target_q_sync=5, two_qs=True,
                        gen_kwargs=dict(max_new_tokens=9, top_k=10, beta=[1], temperature=1.0))
    config = _trl(args, "ilql", "ILQLTrainer", J.ILQL_EPOCHS, J.ILQL_EVAL_INTERVAL, 2e-4, 1000, method,
                  seq_length=11)
    trlx_tpu_torch.train(samples=[[w[:1], w[1:]] for w in walks], rewards=metric_fn(walks)["optimality"],
                         eval_prompts=J.eval_prompt_list(eval_prompts), metric_fn=rec.metric_fn, config=config,
                         device=args.device)
    print(f"[ilql] wrote {rec.path}: {rec.n_eval_calls} evals")


def cmd_compare(args):
    """PARITY_CURVES_TORCH.json: the port's curves beside the JAX
    package's (`ours` of PARITY_CURVES.json), with each delta, whether it
    lies in the JAX test's band and whether the point counts match.
    Returns 0 when every method passes both."""
    with open(os.path.join(REPO, "PARITY_CURVES.json")) as f:
        jax_doc = json.load(f)
    out = {
        "task": jax_doc["task"],
        "checkpoint": "warm-start SFT of the port (prepare stage), exported by save_pretrained and loaded by "
                      "model_path",
        "metric": jax_doc["metric"],
        "config": {m: f"the JAX script's `ours` hyperparameters: {jax_doc['config'][m]}" for m in METHODS},
        "band": f"port mean_last_quarter >= JAX mean_last_quarter - {TOLERANCE}; grpo also >= {GRPO_VS_PPO} x the "
                "port's ppo",
        "where": args.where,
        "methods": {},
    }
    ok = True
    for method in METHODS:
        path = os.path.join(args.workdir, f"{method}.curve.jsonl")
        if not os.path.exists(path):
            raise SystemExit(f"[compare] missing {path}: run the {method} stage first")
        evals, rewards = J._load_curve(path)
        port = {k: round(v, 4) if isinstance(v, float) else v for k, v in J._summary(evals).items()}
        jax = jax_doc["methods"][method]["ours"]
        entry = {
            "port": {"eval_curve": [round(v, 4) for v in evals],
                     "reward_curve": [[n, round(v, 4)] for n, v in rewards], **port},
            "jax": {k: jax[k] for k in ("trainer", "eval_curve", "final", "best", "mean_last_quarter", "n_points")},
            "delta_final": round(port["final"] - jax["final"], 4),
            "delta_mean_last_quarter": round(port["mean_last_quarter"] - jax["mean_last_quarter"], 4),
        }
        entry["in_band"] = entry["delta_mean_last_quarter"] >= -TOLERANCE
        entry["n_points_match"] = port["n_points"] == jax["n_points"]
        out["methods"][method] = entry
        print(f"[compare] {method}: port last-q {port['mean_last_quarter']:.4f} ({port['n_points']} points) | JAX "
              f"{jax['mean_last_quarter']:.4f} ({jax['n_points']}) | delta {entry['delta_mean_last_quarter']:+.4f}")
    grpo = out["methods"]["grpo"]
    grpo["ratio_last_quarter_vs_port_ppo"] = round(
        grpo["port"]["mean_last_quarter"] / max(out["methods"]["ppo"]["port"]["mean_last_quarter"], 1e-9), 4)
    grpo["in_band"] = grpo["in_band"] and grpo["ratio_last_quarter_vs_port_ppo"] >= GRPO_VS_PPO
    ok = all(e["in_band"] and e["n_points_match"] for e in out["methods"].values())
    dest = os.path.join(REPO, "PARITY_CURVES_TORCH.json")
    with open(dest, "w") as f:
        json.dump(out, f, indent=2)
    print(f"[compare] wrote {dest}; every method in band at JAX's point count: {ok}")
    return 0 if ok else 1


STAGES = {"prepare": cmd_prepare, "ppo": cmd_ppo, "ppo-dense": cmd_ppo_dense, "ilql": cmd_ilql, "sft": cmd_sft,
          "rft": cmd_rft, "grpo": cmd_grpo, "compare": cmd_compare}


def cmd_all(args):
    for stage in ("prepare", "ppo", "ppo-dense", "ilql", "sft", "rft", "grpo"):
        t0 = time.time()
        STAGES[stage](args)
        print(f"[all] stage {stage} took {time.time() - t0:.1f} s", flush=True)
    return cmd_compare(args)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("stage", choices=[*STAGES, "all"])
    parser.add_argument("--device", default=None, help="cuda unless given (the tests pass cpu)")
    parser.add_argument("--workdir", default=os.path.join(REPO, "logs", "parity_randomwalks_torch"))
    parser.add_argument("--warm-steps", type=int, default=100)
    parser.add_argument("--epochs", type=int, default=None, help="cut every method to this many outer epochs")
    parser.add_argument("--seed", type=int, default=J.SEED, help="the methods' training seed (the warm start keeps "
                        "the JAX script's)")
    parser.add_argument("--where", default="", help="compare: the hardware each stage ran on, for the record")
    args = parser.parse_args(argv)
    os.makedirs(args.workdir, exist_ok=True)
    rc = (cmd_all if args.stage == "all" else STAGES[args.stage])(args)
    return rc if isinstance(rc, int) else 0


if __name__ == "__main__":
    raise SystemExit(main())
