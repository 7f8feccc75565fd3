"""The port's remaining optimizers and the wandb tracker against the JAX
package: `ops/quantized_optim.py` (`block_quantize` / `block_dequantize`
bitwise against JAX's, `tests/test_quantized_optim.py`'s cases), and
`utils.get_optimizer`'s `lion`, `rmsprop` (against optax's, through
the JAX package's `get_optimizer`), `adam_8bit_bnb` and
`adamw_8bit_bnb` (against the JAX package's 8-bit Adams): five steps
under a cosine schedule on a parameter under one block and one of
several blocks, then an exact resume from the optimizer's `state_dict`.

Tolerances: the parameters 1e-6 relative (plus 1e-7 absolute; f32, the
same arithmetic up to the last ulp of a pow or an rsqrt); the 8-bit
Adams' dequantized moments within one code step of their block (a last
ulp may round a code the other way); the resume bitwise."""

import sys
import types

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from trlx_tpu.ops.quantized_optim import block_dequantize as j_block_dequantize
from trlx_tpu.ops.quantized_optim import block_quantize as j_block_quantize
from trlx_tpu.utils import get_optimizer as j_get_optimizer
from trlx_tpu.utils import get_scheduler as j_get_scheduler
from trlx_tpu_torch.ops.quantized_optim import Adam8bit, block_dequantize, block_quantize, opt_state_bytes
from trlx_tpu_torch.utils import get_optimizer, get_scheduler
from trlx_tpu_torch.utils import tracking

STEPS, RESUME_AT = 5, 3
SHAPES = {"w": (24, 40), "b": (7,)}  # 960 elements (4 blocks, the last partial) and one under a block
SCHED = ("cosine_annealing", dict(T_max=6, eta_min=1e-4))
KWARGS = {
    "lion": dict(lr=3e-3, betas=(0.9, 0.99), weight_decay=0.1),
    "rmsprop": dict(lr=1e-2, eps=1e-8),
    "adam_8bit_bnb": dict(lr=1e-2, betas=(0.9, 0.95), eps=1e-8),
    "adamw_8bit_bnb": dict(lr=1e-2, betas=(0.9, 0.95), eps=1e-8, weight_decay=0.1),
}


def _close(got, want, rtol=1e-6, atol=1e-7):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64), rtol=rtol, atol=atol)


def test_block_quantize_matches_jax_bitwise():
    rng = np.random.RandomState(0)
    cases = [
        rng.randn(7).astype(np.float32),  # under one block: exact passthrough
        rng.randn(256).astype(np.float32),
        rng.randn(3, 300).astype(np.float32),  # a partial last block
        np.concatenate([np.zeros(256), rng.randn(100) * 1e-4, rng.randn(156) * 1e3]).astype(np.float32),
        (np.arange(512, dtype=np.float32) - 255.5) * 0.5,  # exact halves: rounding half to even
    ]
    for x in cases:
        q, s = block_quantize(torch.from_numpy(x))
        jq, js = j_block_quantize(jnp.asarray(x))
        assert q.dtype == (torch.int8 if x.size >= 256 else torch.float32)
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        back = block_dequantize(q, s, x.shape)
        np.testing.assert_array_equal(back.numpy(), np.asarray(j_block_dequantize(jq, js, x.shape)))
        assert back.shape == x.shape
    x = torch.from_numpy(cases[2])
    q, s = block_quantize(x)
    assert float((block_dequantize(q, s, x.shape) - x).abs().max()) <= float(s.max()) / 2 + 1e-7


def _jax_run(name, p0, grads):
    opt = j_get_optimizer(name, j_get_scheduler(SCHED[0], KWARGS[name]["lr"], SCHED[1]), dict(KWARGS[name]))
    params = {k: jnp.asarray(v) for k, v in p0.items()}
    state = opt.init(params)
    for g in grads:
        updates, state = opt.update({k: jnp.asarray(v) for k, v in g.items()}, state, params)
        params = optax.apply_updates(params, updates)
    return {k: np.asarray(v) for k, v in params.items()}, state


def _port(name, p0):
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    opt = get_optimizer(name, params.values(), dict(KWARGS[name]))
    sched = torch.optim.lr_scheduler.LambdaLR(opt, get_scheduler(SCHED[0], KWARGS[name]["lr"], SCHED[1]))
    return params, opt, sched


def _steps(params, opt, sched, grads):
    for g in grads:
        for k, p in params.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        sched.step()


@pytest.mark.parametrize("name", list(KWARGS))
def test_optimizer_steps_match_jax_and_resume_exactly(name):
    rng = np.random.RandomState(1)
    p0 = {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    # gradients spanning four decades inside a block (the 8-bit Adams'
    # sqrt-space code keeps the small ones)
    grads = [{k: (rng.randn(*s) * np.exp(rng.uniform(-4, 1, s))).astype(np.float32) for k, s in SHAPES.items()}
             for _ in range(STEPS)]
    want, jstate = _jax_run(name, p0, grads)
    params, opt, sched = _port(name, p0)
    _steps(params, opt, sched, grads)
    for k in SHAPES:
        _close(params[k].detach().numpy(), want[k])
    if name.endswith("8bit_bnb"):
        assert isinstance(opt, Adam8bit)
        jm, jv = jstate[0].m, jstate[0].v
        for k, p in params.items():
            st = opt.state[p]
            for moment, (q, s), jq in (("m", (st["m_q"], st["m_scale"]), jm[k]),
                                       ("v", (st["v_q"], st["v_scale"]), jv[k])):
                got = block_dequantize(q, s, p.shape).numpy()
                ref = np.asarray(j_block_dequantize(jq.q, jq.scale, p.shape))
                step = float(np.asarray(jq.scale).max())
                assert np.abs(got - ref).max() <= step + 1e-7 * max(1.0, np.abs(ref).max()), (moment, k)
        # int8 codes: about a quarter of AdamW's two f32 moments
        adamw = get_optimizer("adamw", [torch.nn.Parameter(torch.zeros(SHAPES["w"]))], {})
        w = torch.nn.Parameter(torch.zeros(SHAPES["w"]))
        small = get_optimizer(name, [w], {})
        w.grad = adamw.param_groups[0]["params"][0].grad = torch.ones(SHAPES["w"])
        adamw.step()
        small.step()
        assert opt_state_bytes(small) < 0.3 * opt_state_bytes(adamw)
    # resume: RESUME_AT steps, the state dicts into a fresh optimizer, the rest
    params2, opt2, sched2 = _port(name, p0)
    _steps(params2, opt2, sched2, grads[:RESUME_AT])
    saved = (opt2.state_dict(), sched2.state_dict(), {k: p.detach().clone() for k, p in params2.items()})
    params3, opt3, sched3 = _port(name, p0)
    with torch.no_grad():
        for k, p in params3.items():
            p.copy_(saved[2][k])
    opt3.load_state_dict(saved[0])
    sched3.load_state_dict(saved[1])
    _steps(params3, opt3, sched3, grads[RESUME_AT:])
    for k in SHAPES:
        assert torch.equal(params3[k], params[k]), k


def test_wandb_tracker_and_its_fallback(tmp_path, monkeypatch):
    """`tracker="wandb"` logs through wandb when it imports (a fake module
    here: nothing starts a real run) and falls back to the JSONL tracker
    with a warning when it does not, as the JAX package's; the optimizer
    names the config takes build the port's own optimizers."""
    calls = []

    class Run:
        def finish(self):
            calls.append("finish")

    fake = types.SimpleNamespace(init=lambda **kw: calls.append(("init", kw["name"], kw["config"])) or Run(),
                                 log=lambda stats, step: calls.append(("log", stats, step)))
    monkeypatch.setitem(sys.modules, "wandb", fake)
    tr = tracking.get_tracker("wandb", {"a": 1}, "run/x", str(tmp_path))
    assert isinstance(tr, tracking.WandbTracker)
    tr.log({"loss": 0.5}, 3)
    tr.finish()
    assert calls == [("init", "run/x", {"a": 1}), ("log", {"loss": 0.5}, 3), "finish"]
    monkeypatch.setitem(sys.modules, "wandb", None)  # import wandb raises ImportError
    warned = []
    monkeypatch.setattr(tracking.logger, "warning", warned.append)
    tr = tracking.get_tracker("wandb", {"a": 1}, "run/y", str(tmp_path))
    assert isinstance(tr, tracking.JSONLTracker) and "falling back to JSONL" in warned[0]
    tr.log({"loss": 0.25}, 1)
    tr.finish()
    assert (tmp_path / "run_y.metrics.jsonl").read_text().count("loss") == 1
    p = [torch.nn.Parameter(torch.zeros(3))]
    for name, cls in (("lion", "Lion"), ("rmsprop", "RMSprop"), ("adam_8bit_bnb", "Adam8bit"),
                      ("ADAMW_8BIT_BNB", "Adam8bit")):
        assert type(get_optimizer(name, p, {})).__name__ == cls
    with pytest.raises(ValueError):
        get_optimizer("adafactor", p, {})
