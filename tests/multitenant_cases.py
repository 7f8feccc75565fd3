"""Shared cases of the port's multi-tenant serving tests
(`tests/test_torch_adapter_store.py`, `test_torch_multitenant_*.py`): a
LoRA policy pair (the JAX package's and the port's on one set of numpy
weights), tenant adapters written under one directory that both
packages' `AdapterStore`s read through `loader=`, and engine builders
and drivers for both packages. Each file keeps to a few tests: the suite
runs with `--dist loadfile`, which hands out the files with the fewest
tests last, so these fill the workers that the large files leave idle."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from trlx_tpu import resilience as j_resilience
from trlx_tpu.inference.adapters import AdapterStore as JAdapterStore
from trlx_tpu.inference.engine import InferenceEngine as JInferenceEngine
from trlx_tpu.models import CausalLMWithValueHead as JCausalLMWithValueHead
from trlx_tpu.models import config_from_preset as j_config_from_preset
from trlx_tpu.models import lora as j_lora
from trlx_tpu.ops.sampling import GenerationConfig as JGenerationConfig
from trlx_tpu_torch.convert import params_from_jax
from trlx_tpu_torch.inference import AdapterStore, InferenceEngine
from trlx_tpu_torch.models import CausalLMWithValueHead, config_from_preset
from trlx_tpu_torch.models.lora import lora_overrides_from_peft_config
from trlx_tpu_torch.ops.sampling import GenerationConfig

torch.set_num_threads(1)

V = 64
EOS_FREE = 10_000  # an id no model emits: runs end on their length
PEFT = {"peft_type": "LORA", "r": 4, "lora_alpha": 16}
TENANTS = ("a1", "a2", "a3")


def port_name(path) -> str:
    """A JAX LoRA leaf path ('lm', 'block_0', 'attn', 'q_proj_lora_a') ->
    the port's state-dict name 'lm.block_0.attn.q_proj.lora_a'."""
    *mods, name = path
    return ".".join([*mods, name[: -len("_lora_a")], name[-len("lora_a"):]])


@functools.lru_cache(maxsize=None)
def policy(preset: str = "gpt2-tiny"):
    """(JAX module, JAX cfg, JAX params (numpy), port cfg): gpt2-tiny at
    V 64, f32, LoRA r 4 on q_proj and v_proj, every weight drawn from a
    seed with numpy over `jax.eval_shape`'s tree (no flax init run); the
    trunk's own LoRA factors are zero, so it is the base policy."""
    jcfg = j_config_from_preset(preset, vocab_size=V, dtype=jnp.float32,
                                **j_lora.lora_overrides_from_peft_config(PEFT))
    jmodel = JCausalLMWithValueHead(jcfg)
    toks = np.zeros((1, 8), np.int32)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), toks, np.ones_like(toks))["params"]
    rng = np.random.RandomState(1)

    def draw(path, leaf):
        name = getattr(path[-1], "key", str(path[-1]))
        x = rng.randn(*leaf.shape).astype(np.float32)
        if "_lora_" in name:
            return np.zeros(leaf.shape, np.float32)
        if name == "scale":
            return 1.0 + 0.1 * x
        if name == "bias":
            return 0.1 * x
        return x / np.float32(np.sqrt(leaf.shape[-1] if name == "embedding" else leaf.shape[0]))

    params = jax.tree_util.tree_map_with_path(draw, shapes)
    tcfg = config_from_preset(preset, vocab_size=V, dtype=torch.float32, **lora_overrides_from_peft_config(PEFT))
    return jmodel, jcfg, params, tcfg


def port_model(state=None):
    """The port's policy on the JAX weights (or on `state`)."""
    _, _, params, tcfg = policy()
    model = CausalLMWithValueHead(tcfg, generator=torch.Generator().manual_seed(0))
    model.load_state_dict(params_from_jax(params, tcfg) if state is None else state)
    return model.eval()


def lora_leaves(seed: int):
    """One tenant's factors, {JAX path: numpy}: nonzero A and B."""
    _, _, params, _ = policy()
    lora, _ = j_lora.split_lora(params)
    rng = np.random.RandomState(seed)
    return {k: (0.3 * rng.randn(*v.shape)).astype(np.float32) for k, v in sorted(lora.items())}


def write_adapter(root, name: str, seed: int, step: int = 1) -> str:
    """An adapter directory both stores read through their `loader`:
    `leaves.npz` (JAX paths joined by '/') and a manifest written last."""
    path = os.path.join(str(root), name)
    os.makedirs(path, exist_ok=True)
    np.savez(os.path.join(path, "leaves.npz"), **{"/".join(k): v for k, v in lora_leaves(seed).items()})
    j_resilience.write_manifest(path, step=step)
    return path


def adapter_root(tmp_path, seeds=None):
    """a1, a2, a3 under `tmp_path` (seeds 10, 11, 12 unless given)."""
    seeds = seeds or {n: 10 + i for i, n in enumerate(TENANTS)}
    for name, seed in seeds.items():
        write_adapter(tmp_path, name, seed)
    return str(tmp_path)


def j_loader(path):
    """The JAX store's loader: {JAX path: numpy}."""
    with np.load(os.path.join(path, "leaves.npz")) as z:
        return {tuple(k.split("/")): z[k] for k in z.files}


def t_loader(path):
    """The port store's loader: the same leaves by state-dict name."""
    return {port_name(k): torch.from_numpy(v) for k, v in j_loader(path).items()}


def stores(adapter_dir, **kw):
    """(JAX store, port store) over the same directory and leaves."""
    _, _, params, _ = policy()
    model = port_model()
    return (JAdapterStore(jax.tree_util.tree_map(jnp.asarray, params), adapter_dir=adapter_dir, loader=j_loader, **kw),
            AdapterStore(model.state_dict(), adapter_dir=adapter_dir, loader=t_loader, **kw), model)


def gen(max_new=6, jax_cfg=False):
    cls = JGenerationConfig if jax_cfg else GenerationConfig
    return cls(max_new_tokens=max_new, do_sample=False, eos_token_id=EOS_FREE, pad_token_id=0)


def engines(adapter_dir, num_slots=3, max_new=6, max_resident=4, **kw):
    """(JAX multi-tenant engine, port multi-tenant engine), each on its own
    store over `adapter_dir`."""
    jmodel, jcfg, params, tcfg = policy()
    jstore, tstore, model = stores(adapter_dir, max_resident=max_resident)
    common = dict(num_slots=num_slots, max_prompt_len=64, multi_tenant=True, **kw)
    jeng = JInferenceEngine(jmodel, jcfg, jax.tree_util.tree_map(jnp.asarray, params), gen(max_new, True),
                            adapter_store=jstore, **common)
    teng = InferenceEngine(model, tcfg, None, gen(max_new), adapter_store=tstore, **common)
    return jeng, teng


def single_tenant_engine(leaves=None, num_slots=1, max_new=6, **kw):
    """The port's single-tenant engine over the trunk with one tenant's
    factors loaded into its own `lora_a` / `lora_b` (or the base's zeros)."""
    _, _, params, tcfg = policy()
    state = params_from_jax(params, tcfg)
    for k, v in (leaves or {}).items():
        state[port_name(k)] = torch.from_numpy(v)
    return InferenceEngine(port_model(state), tcfg, None, gen(max_new), num_slots=num_slots, max_prompt_len=64, **kw)


def run_engine(engine, rows, max_steps=64):
    """Drive an engine directly (no scheduler): insert, step to the end,
    reclaim; returns the emitted token lists."""
    engine.insert_requests(rows, list(range(len(rows))))
    out = [[] for _ in rows]
    done = [False] * len(rows)
    for _ in range(max_steps):
        tok, _, valid, fin = engine.step()
        for i in range(len(rows)):
            if valid[i] and not done[i]:
                out[i].append(int(tok[i]))
            if fin[i] and not done[i]:
                done[i] = True
                engine.reclaim_slots([i])
        if all(done):
            break
    assert all(done), "engine did not finish"
    return out


def prompts(seed, lens):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, V, size=n).astype(np.int32) for n in lens]
