"""The port's randomwalks learning curves (PARITY_CURVES_TORCH.json, made
on the card by scripts/parity_randomwalks_torch.py) held against the JAX
package's (the `ours` entries of PARITY_CURVES.json) by the JAX test's own
band (tests/test_parity_curves.py: TOLERANCE 0.05 on the mean of the last
quarter of the eval points), at the JAX curves' point counts; GRPO also
within 90 % of the port's own PPO. The test reads the committed artifact;
it also runs the script's warm start and one PPO epoch on the CPU at a
cut size, so the script cannot rot.

A method that misses and whose cause this repository has not removed is
an expected failure that must keep failing (strict), its reason naming
the ROADMAP queue C entry that holds the evidence.
"""

import importlib.util
import json
import os

import pytest
import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOLERANCE = 0.05
JAX_POINTS = {"ppo": 33, "ppo_dense": 25, "ilql": 16, "sft": 9, "rft": 8, "grpo": 33}
GRPO_MISS = ("ROADMAP queue C, 'the GRPO curve on the card below the band': seed noise; from one warm start the "
             "two packages spread alike over two seeds (scripts/parity_randomwalks_seed_spread.py)")
RFT_POINTS = ("ROADMAP queue C, 'RFT's point count follows the warm start': the JAX trainer from the port's warm "
              "start also makes 12-14 points (scripts/parity_randomwalks_seed_spread.py --cross)")
XFAIL = {("band", "grpo"): GRPO_MISS, ("points", "rft"): RFT_POINTS}


def _case(kind, method):
    reason = XFAIL.get((kind, method))
    return pytest.param(method, marks=pytest.mark.xfail(strict=True, reason=reason)) if reason else method


@pytest.fixture(scope="module")
def curves():
    with open(os.path.join(REPO, "PARITY_CURVES_TORCH.json")) as f:
        port = json.load(f)
    with open(os.path.join(REPO, "PARITY_CURVES.json")) as f:
        jax = json.load(f)
    return port, jax


def test_every_method_present_and_the_jax_side_unchanged(curves):
    port, jax = curves
    assert set(port["methods"]) == set(JAX_POINTS)
    for method, entry in port["methods"].items():
        ours = jax["methods"][method]["ours"]
        assert entry["jax"] == {k: ours[k] for k in entry["jax"]}, method
        assert len(entry["port"]["eval_curve"]) == entry["port"]["n_points"]
        assert entry["jax"]["n_points"] == JAX_POINTS[method]
    assert "H100" in port["where"]


@pytest.mark.parametrize("method", [_case("points", m) for m in JAX_POINTS])
def test_point_count_matches_jax(curves, method):
    assert curves[0]["methods"][method]["port"]["n_points"] == JAX_POINTS[method]


@pytest.mark.parametrize("method", [_case("band", m) for m in JAX_POINTS])
def test_port_within_the_band_of_jax(curves, method):
    entry = curves[0]["methods"][method]
    port, jax = entry["port"]["mean_last_quarter"], entry["jax"]["mean_last_quarter"]
    assert port >= jax - TOLERANCE, f"{method}: the port's last-quarter mean {port} trails JAX's {jax}"


def test_grpo_within_90pct_of_the_port_ppo(curves):
    methods = curves[0]["methods"]
    ratio = methods["grpo"]["port"]["mean_last_quarter"] / methods["ppo"]["port"]["mean_last_quarter"]
    assert ratio >= 0.9


def test_port_ppo_learns_from_its_warm_start(curves):
    entry = curves[0]["methods"]["ppo"]["port"]
    assert entry["mean_last_quarter"] >= entry["eval_curve"][0]


def test_script_prepares_and_runs_a_ppo_epoch_on_the_cpu(tmp_path):
    """The warm start (cut to 4 steps) exported and loaded back by
    `model_path`, then one PPO epoch: a curve with its two evaluations."""
    spec = importlib.util.spec_from_file_location("parity_randomwalks_torch",
                                                  os.path.join(REPO, "scripts", "parity_randomwalks_torch.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    common = ["--device", "cpu", "--workdir", str(tmp_path)]
    assert script.main(["prepare", "--warm-steps", "4", *common]) == 0
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["config.json", "pytorch_model.bin", "trlx_tpu_config.json"]
    assert script.main(["ppo", "--epochs", "1", *common]) == 0
    evals, rewards = script.J._load_curve(str(tmp_path / "ppo.curve.jsonl"))
    assert len(evals) == 2 and all(0.0 <= v <= 1.2 for v in evals) and len(rewards) > 2
