"""Base trainer: construction, the learn loop, evaluation, checkpoints and
serving.

Port of the JAX package's `trainer/base_trainer.py` on one device.
Frozen parameters (`model.num_layers_unfrozen`) get `requires_grad=False`
and stay out of the optimizer, so backprop stops at the freeze point and
the frozen blocks run the forward-only attention kernel. Gradient
accumulation over microbatches sums the microbatch gradients and divides
by their number before the update, as the JAX trainer's accumulate/apply
pair does. Checkpoints keep the JAX layout's atomic stage-and-promote:
everything goes into a sibling `.tmp` directory (the policy's state
dict alone in `model.pt`, which a server reloads with
`weights_only=True`; the rest of the state in `state.pt`;
`trainer_state.json`), `manifest.json` is written last and
one `os.replace` promotes the stage. With `train.checkpoint_keep_n` the
newest N step checkpoints are kept (`resilience.gc_checkpoints`).

With `train.handle_preemption` (the default) `learn` installs a
`PreemptionGuard`: after SIGTERM or SIGINT the loop finishes its step,
writes `checkpoint_<step>_preempt` and exits with code 75;
`train.auto_resume` then continues from the newest manifest-complete
checkpoint under `checkpoint_dir` when no explicit
`resume_from_checkpoint` is given.

With `train.sentinel` the health sentinel (`sentinel.py`) guards each
optimizer step (a step whose global gradient norm is not finite, or above
`train.grad_skip_threshold`, is skipped: read on the host, one sync a
step), watches the step and rollout statistics, pins `last_good` after
clean steps and rewinds to it, or aborts, on escalation;
`train.step_timeout_s` starts the step watchdog. `fault_injector`'s
train-side faults poison a step's host batch before it goes to the
device.

A trainer that collects through a rollout fleet (PPO and GRPO with
`train.rollout_backend="fleet"`) tears it down on the way out of `learn`,
so no replica outlives the trainer. `fault_injector` (a
`resilience.FaultInjector`, None by default) follows into the replicas
of a trainer-launched fleet.

Not ported yet, and refused when their flags are set: the fused-epoch
dispatch, tracing (timeline, goodput and the ledgers), profiler capture
(ROADMAP queue A, item 4.7) and parallelism (any `parallel` axis above
one device; item 4.8). With tracing refused, the JAX trainer's watchdog
and sentinel postmortem bundles have nothing to write here.
"""

import dataclasses
import hashlib
import json
import math
import os
import shutil
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from trlx_tpu_torch import resilience
from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.models import trainable_mask
from trlx_tpu_torch.models.policy import resolve_split
from trlx_tpu_torch.pipeline import MiniBatchIterator
from trlx_tpu_torch.resilience import MANIFEST_NAME, MODEL_FILE, is_valid_checkpoint
from trlx_tpu_torch.sentinel import LAST_GOOD_NAME, HealthSentinel, SentinelRewind, StepWatchdog
from trlx_tpu_torch.tokenizers import get_tokenizer
from trlx_tpu_torch.trainer import register_trainer
from trlx_tpu_torch.utils import Clock, get_optimizer, get_scheduler, logging, resolve_device, set_seed, significant
from trlx_tpu_torch.utils.tracking import get_tracker

logger = logging.get_logger(__name__)

MANIFEST_VERSION = 1


def atomic_write_json(path: str, obj: dict) -> None:
    """Write JSON through a same-directory temp file and `os.replace`, so
    an interrupted write never leaves a torn file."""
    directory = os.path.dirname(os.path.abspath(path))
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(obj, f, indent=2, default=str)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _dir_files_hash(directory: str) -> str:
    """sha256 over every (relative path, size) pair but the manifest's:
    detects truncated or missing files without reading the weights."""
    entries = []
    for root, _, files in os.walk(directory):
        for name in files:
            if name == MANIFEST_NAME:
                continue
            path = os.path.join(root, name)
            entries.append(f"{os.path.relpath(path, directory)}:{os.path.getsize(path)}")
    return hashlib.sha256("\n".join(sorted(entries)).encode()).hexdigest()


def write_manifest(directory: str, step: int) -> dict:
    """The commit record of a checkpoint, written after every other file."""
    manifest = {"version": MANIFEST_VERSION, "step": int(step), "wall_time": time.time(),
                "files_hash": _dir_files_hash(directory)}
    atomic_write_json(os.path.join(directory, MANIFEST_NAME), manifest)
    return manifest


# train-config flags of JAX trainer features the port does not run yet
_UNPORTED_TRAIN_FLAGS = {
    "fuse_inner_epoch": "the fused-epoch dispatch",
    "fuse_all_inner_epochs": "the fused-epoch dispatch",
    "tracing": "training tracing (timeline, goodput, compile/HBM ledgers)",
    "profile_dir": "profiler capture",
}
# parallel-config axes; the port runs on one device, so none may exceed 1
# (-1, "the remaining devices", is one device on one card)
_PARALLEL_AXES = ("data", "fsdp", "tensor", "sequence", "pipeline", "dcn_data")


def check_single_device(parallel) -> None:
    """Refuse a `parallel` section that asks for more than one device."""
    for axis in _PARALLEL_AXES:
        size = getattr(parallel, axis)
        if size > 1:
            raise NotImplementedError(
                f"parallel.{axis}={size}: the port runs on one device; parallelism is not ported yet "
                "(ROADMAP queue A, item 4)"
            )


@register_trainer
class TorchTrainer:
    """:param device: where the policy lives and runs; `cuda` unless the
    caller asks for another (the tests pass "cpu"). Asking for `cuda`
    where there is none raises."""

    def __init__(self, config: TRLConfig, reward_fn=None, metric_fn=None, logit_mask=None,
                 stop_sequences=None, device=None, **kwargs):
        self.config = config
        self.store = None
        self.reward_fn = reward_fn
        self.metric_fn = metric_fn
        self.logit_mask = logit_mask
        self.stop_sequences = stop_sequences
        self.device = resolve_device(device)
        for flag, what in _UNPORTED_TRAIN_FLAGS.items():
            if getattr(config.train, flag, None):
                raise NotImplementedError(
                    f"train.{flag} ({what}) is not ported yet (ROADMAP queue A, item 4.7)"
                )
        check_single_device(config.parallel)
        self.fault_injector: Optional[resilience.FaultInjector] = None
        # the health sentinel, built only when train.sentinel is on: with
        # it off, the step and the loop run as they did before it
        self._sentinel = HealthSentinel.from_train_config(config.train) if config.train.sentinel else None
        self._watchdog: Optional[StepWatchdog] = None
        # injectable for tests (the default on timeout is os._exit(75))
        self._watchdog_on_timeout = None
        self._sentinel_skip_chunk = False
        set_seed(config.train.seed)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(config.train.seed))
        self.tokenizer = get_tokenizer(config.tokenizer)
        self.max_length = config.train.seq_length

        self.model, self.model_cfg, _ = self.get_arch(config)
        P, cfg = self.model_cfg.prompt_tokens, self.model_cfg
        if P > 0 and cfg.pos_embed == "learned" and config.train.seq_length + P > cfg.max_seq_len:
            # the soft prompt shifts the tokens' positions by P; past the
            # learned-position table the lookup would fail (JAX's gather
            # would clamp silently), so refuse up front
            raise ValueError(
                f"prompt_tokens={P} + train.seq_length={config.train.seq_length} exceeds the learned-position "
                f"table ({cfg.max_seq_len}); lower seq_length by the prompt length"
            )
        self.split = resolve_split(self.model_cfg, config.model.num_layers_unfrozen)
        mask = self.make_trainable_mask()
        for name, p in self.model.named_parameters():
            p.requires_grad_(mask[name])
        self.trainable_params = [p for p in self.model.parameters() if p.requires_grad]
        n_train = sum(p.numel() for p in self.trainable_params)
        n_total = sum(p.numel() for p in self.model.parameters())
        logger.info(f"Trainable params: {n_train:,} / {n_total:,} on {self.device}")

        base_lr = float(config.optimizer.kwargs.get("lr", 1e-4))
        self.lr_schedule = get_scheduler(config.scheduler.name, base_lr, config.scheduler.kwargs)
        self.optimizer = get_optimizer(config.optimizer.name, self.trainable_params, config.optimizer.kwargs)
        # the optimizer's lr is 1.0, so the LambdaLR sets it to schedule(n)
        # for the n-th update (step 0 included, as optax counts)
        self.scheduler = torch.optim.lr_scheduler.LambdaLR(self.optimizer, self.lr_schedule)

        self.mb_size = config.train.minibatch_size or config.train.batch_size
        if config.train.batch_size % self.mb_size != 0:
            raise ValueError("Minibatch size must divide batch size")
        self.num_mb = config.train.batch_size // self.mb_size

        run_name = config.train.run_name or f"{config.train.trainer}/{config.model.model_path}"
        self.tracker = get_tracker(config.train.tracker, config.to_dict(), run_name, config.train.logging_dir)

        self.generate_kwargs = dict(getattr(config.method, "gen_kwargs", None) or {})
        # a single list-valued gen kwarg becomes an eval-time sweep: evaluate()
        # runs once per value and suffixes its metrics with @k=v; kwargs whose
        # value is itself a list are exempt
        list_typed = {"suppress_tokens", "begin_suppress_tokens", "bad_words_ids"}
        self.generate_sweep_kwarg = None
        for k, v in list(self.generate_kwargs.items()):
            if k in list_typed or not isinstance(v, list):
                continue
            if self.generate_sweep_kwarg is not None:
                logger.info(f"Only a single sweep is allowed, {k} is going to be set to {v[0]}")
            else:
                self.generate_sweep_kwarg = (k, v)
            self.generate_kwargs[k] = v[0]

        self._generate_cache: Dict[Any, Callable] = {}
        self.iter_count = 0
        self.nth_evaluation = 0
        self._nan_streak = 0
        self._loop_pos: Optional[Dict[str, int]] = None
        self._resume_pos: Optional[Dict[str, int]] = None
        self._best_reward = -float("inf")
        self._resumed = False
        self._preemption_guard: Optional[resilience.PreemptionGuard] = None

    # ------------------------------------------------------------------
    # Abstract surface
    # ------------------------------------------------------------------

    def get_arch(self, config: TRLConfig):
        """Returns (module, model config, state dict)."""
        raise NotImplementedError

    def make_loss_fn(self) -> Callable:
        """Returns fn(batch on the device) -> (loss, stats dict)."""
        raise NotImplementedError

    def prepare_learning(self):
        """Set self.train_dataloader, self.eval_dataloader,
        self.n_inner_epochs, self.total_steps."""
        raise NotImplementedError

    def create_train_dataloader(self, seed_offset: int = 0):
        """A fresh (re-shuffled) loader over the training store."""
        raise NotImplementedError

    def make_trainable_mask(self) -> Dict[str, bool]:
        return trainable_mask(self.model, self.model_cfg, self.config.model.num_layers_unfrozen)

    def post_backward_callback(self):
        pass

    def post_epoch_callback(self):
        pass

    def push_to_store(self, data):
        self.store.push(data)

    def count_tokens(self, minibatch) -> int:
        """The real tokens of one host microbatch, for the step's
        `throughput/train_tokens_per_s`: its attention mask's sum."""
        return int(np.asarray(minibatch["attention_mask"]).sum())

    def _extra_resume_state(self) -> Dict[str, Any]:
        """Trainer-specific host state that a checkpoint carries for an
        exact resume (picklable); saved in `state.pt` when not empty. The
        base carries the sentinel's state; subclasses extend super()'s."""
        return {"sentinel": self._sentinel.state_dict()} if self._sentinel is not None else {}

    def _load_extra_resume_state(self, state: Dict[str, Any]) -> None:
        """Inverse of `_extra_resume_state`."""
        if self._sentinel is not None and "sentinel" in state:
            self._sentinel.load_state_dict(state["sentinel"])

    def add_eval_pipeline(self, eval_pipeline):
        """Set the evaluation pipeline used during evaluate()."""
        self.eval_pipeline = eval_pipeline

    # ------------------------------------------------------------------
    # Generation / decode
    # ------------------------------------------------------------------

    def serving_params(self) -> Dict[str, torch.Tensor]:
        """Param state handed to a long-lived consumer (an inference
        engine). The live tensors are shared, not copied: an engine that
        serves while this trainer steps reads the updated weights."""
        return self.model.state_dict()

    def get_generate_fn(self, batch_size: int, prompt_len: int, gen_kwargs: Dict, mode: str = "lm",
                        capture: bool = False, spec_k: int = 0):
        """Sampler per (shape, kwargs) bucket; `capture` builds the rollout
        fast path's sampler, which also returns per-token logprobs and
        values and the hydra split's activations; spec_k > 0 builds the
        self-speculative sampler, drafting on the trunk below the split."""
        from trlx_tpu_torch.ops.sampling import GenerationConfig, make_generate_fn

        key = (batch_size, prompt_len, repr(sorted(gen_kwargs.items())), mode, bool(capture), int(spec_k))
        if key not in self._generate_cache:
            gen_cfg = GenerationConfig.from_gen_kwargs(
                gen_kwargs, self.tokenizer.eos_token_id, self.tokenizer.pad_token_id
            )
            self._generate_cache[key] = make_generate_fn(
                self.model, self.model_cfg, gen_cfg, mode=mode, logit_mask=self.logit_mask,
                capture=capture, capture_split=self.split if capture else 0,
                spec_k=spec_k, spec_split=self.split if spec_k > 0 else 0,
                spec_draft_head=self._spec_draft_head() if spec_k > 0 else None,
                **self._method_sampler_options(),
            )
        return self._generate_cache[key]

    def _method_sampler_options(self) -> Dict:
        """Method-specific `make_generate_fn` options; ILQL passes its
        `two_qs`."""
        return {}

    def _spec_draft_head(self):
        """The draft readout of speculative decode; trainers that run it
        (PPO) provide it."""
        raise NotImplementedError("speculative decode needs a trainer-provided draft head")

    def _decode_params(self) -> Optional[Dict]:
        """The parameter view the sampler reads, or None for the module's
        own parameters; PPO's int8 frozen-trunk view overrides it. Training
        and scoring never read it."""
        return None

    def _bucket_prompts(self, input_ids, attention_mask):
        """Round the generate batch up to a multiple of 8 rows and the
        prompt width up to a multiple of 32 columns, as the JAX trainer
        does (row padding repeats row 0; column padding adds masked pad
        tokens on the tokenizer's padding side). Returns (ids, mask,
        (true_rows, left_col_pad))."""
        b, t = input_ids.shape
        bb = -(-b // 8) * 8
        tb = -(-t // 32) * 32
        if (bb, tb) == (b, t):
            return input_ids, attention_mask, (b, 0)
        left = self.config.tokenizer.padding_side == "left"
        ids = np.full((bb, tb), self.tokenizer.pad_token_id, dtype=np.asarray(input_ids).dtype)
        mask = np.zeros((bb, tb), dtype=np.asarray(attention_mask).dtype)
        col = slice(tb - t, tb) if left else slice(0, t)
        ids[:b, col] = input_ids
        mask[:b, col] = attention_mask
        ids[b:] = ids[0]
        mask[b:] = mask[0]
        return ids, mask, (b, tb - t if left else 0)

    def _unbucket_output(self, out: Dict, orig) -> Dict:
        b, col_pad = orig
        trimmed = {}
        for k, v in out.items():
            if hasattr(v, "ndim") and v.ndim >= 1 and v.shape[0] >= b:
                v = v[:b]
                if col_pad and k in ("samples", "samples_mask", "h_split"):
                    v = v[:, col_pad:]
            trimmed[k] = v
        return trimmed

    def generate(self, input_ids, attention_mask, gen_kwargs: Optional[Dict] = None, mode: str = "lm",
                 capture: bool = False, spec_k: int = 0):
        """Sample continuations for a host prompt batch on the decode view
        (`_decode_params`); returns the sampler's dict of device tensors."""
        gen_kwargs = gen_kwargs if gen_kwargs is not None else self.generate_kwargs
        input_ids = np.asarray(input_ids)
        attention_mask = np.asarray(attention_mask)
        if getattr(self.config.train, "bucket_generation", True):
            input_ids, attention_mask, orig = self._bucket_prompts(input_ids, attention_mask)
            if self.config.model.model_arch_type == "seq2seq":
                # seq2seq samples are decoder-side only: the encoder's
                # column padding is not on them
                orig = (orig[0], 0)
        else:
            orig = (input_ids.shape[0], 0)
        fn = self.get_generate_fn(input_ids.shape[0], input_ids.shape[1], gen_kwargs, mode, capture, spec_k)
        out = fn(input_ids, attention_mask, self.generator, params=self._decode_params())
        return self._unbucket_output(out, orig)

    def decode(self, prompts, samples, prompt_sizes=None,
               append_eos_token: bool = False) -> Tuple[List[str], List[str], List[str]]:
        """Token -> string decode with stop-sequence trimming and eos
        restoration. Seq2seq samples are decoder-side only: the output is
        the whole sample, and a sample joins prompt and output with the
        tokenizer's `sep_token`."""
        prompts = np.asarray(prompts)
        samples = np.asarray(samples)
        seq2seq = self.config.model.model_arch_type == "seq2seq"
        if prompt_sizes is None:
            prompt_sizes = [prompts.shape[1]] * len(prompts)
        str_samples, str_prompts, str_outputs = [], [], []
        for prompt, sample, prompt_size in zip(prompts, samples, prompt_sizes):
            str_prompt = self.tokenizer.decode(prompt[:prompt_size], skip_special_tokens=True)
            str_output = self.tokenizer.decode(sample[0 if seq2seq else prompt_size:], skip_special_tokens=True)
            trimmed = False
            for stop in self.stop_sequences or []:
                stop_ix = str_output.find(stop)
                if stop_ix >= 0:
                    str_output = str_output[:stop_ix].rstrip()
                    trimmed = True
            # restore the trailing eos unless generation ran out of budget
            if append_eos_token and (
                trimmed or sample[-1] == self.tokenizer.eos_token_id or sample[-1] == self.tokenizer.pad_token_id
            ):
                str_output += self.tokenizer.eos_token
            str_prompts.append(str_prompt)
            str_outputs.append(str_output)
            sep = (getattr(self.tokenizer, "sep_token", "") or "") if seq2seq else ""
            str_samples.append(str_prompt + sep + str_output)
        return str_samples, str_prompts, str_outputs

    # ------------------------------------------------------------------
    # Train step with gradient accumulation
    # ------------------------------------------------------------------

    def batch_to_device(self, batch):
        """Numpy arrays -> tensors on the trainer's device (integer arrays
        as int64); other leaves pass through. Takes a dict or a dataclass
        batch (`PPORLBatch`) and returns the same kind."""
        if dataclasses.is_dataclass(batch):
            fields = {f.name: getattr(batch, f.name) for f in dataclasses.fields(batch)}
            return dataclasses.replace(batch, **self.batch_to_device(fields))
        out = {}
        for k, v in batch.items():
            if isinstance(v, np.ndarray):
                t = torch.from_numpy(v)
                out[k] = (t.long() if not t.is_floating_point() else t).to(self.device, non_blocking=True)
            else:
                out[k] = v
        return out

    def optimizer_step(self, microbatches: List[Any]) -> List[Dict[str, torch.Tensor]]:
        """One optimizer step over microbatches already on the device: one
        microbatch steps on its gradient; several sum their gradients and
        divide by `num_mb` first. The scheduler steps once. Returns each
        microbatch's stats as device tensors; nothing is fetched to the
        host, so the caller decides when to wait for the device."""
        if not hasattr(self, "_loss_fn"):
            self._loss_fn = self.make_loss_fn()
        self.optimizer.zero_grad(set_to_none=True)
        stats_list = []
        for mb in microbatches:
            loss, stats = self._loss_fn(mb)
            loss.backward()
            stats_list.append(stats)
        if len(microbatches) > 1:
            for p in self.trainable_params:
                if p.grad is not None:
                    p.grad.div_(self.num_mb)
        if self._sentinel is None:
            self.optimizer.step()
            self.scheduler.step()
            return stats_list
        guard = self._guarded_update()
        return [{**s, **guard} for s in stats_list]

    def _guarded_update(self) -> Dict[str, torch.Tensor]:
        """The sentinel's gradient guard: the global norm of the trainable
        parameters' gradients, in f32; a step whose norm is not finite, or
        above `train.grad_skip_threshold`, runs neither `optimizer.step()`
        nor the scheduler's step, so the parameters, the optimizer's
        moments and step counts and the LR schedule's position are left
        as they were. The cooldown's `lr_scale` scales the whole update,
        weight decay included (the update is linear in the lr); at 1.0 the
        step is the unguarded one, bit for bit. Returns the guard's stats
        as device tensors."""
        grads = [p.grad if p.grad.dtype == torch.float32 else p.grad.float()
                 for p in self.trainable_params if p.grad is not None]
        gnorm = torch.nn.utils.get_total_norm(grads) if grads else torch.zeros((), device=self.device)
        # the guard's one host sync a step: skipping on the host keeps
        # torch's optimizer and scheduler untouched, where masking on the
        # device would need a copy of every moment to select from
        norm = float(gnorm)
        threshold = self.config.train.grad_skip_threshold
        ok = math.isfinite(norm) and (threshold is None or norm <= threshold)
        if ok:
            scale = self._sentinel.lr_scale(self.iter_count)
            lrs = [g["lr"] for g in self.optimizer.param_groups]
            if scale != 1.0:
                for g in self.optimizer.param_groups:
                    g["lr"] = g["lr"] * scale
            self.optimizer.step()
            for g, lr in zip(self.optimizer.param_groups, lrs):
                g["lr"] = lr
            self.scheduler.step()
        return {"train/grad_global_norm": gnorm, "train/skipped_updates": gnorm.new_tensor(0.0 if ok else 1.0)}

    def train_minibatch(self, minibatch: List[Any]) -> Dict[str, float]:
        """`optimizer_step` over the host microbatches of `minibatch`.
        Returns the microbatch-mean stats, plus the step's wall time and
        real tokens per second."""
        t0 = time.perf_counter()
        minibatch = self._maybe_inject_train_fault(minibatch)
        tokens = sum(self.count_tokens(mb) for mb in minibatch)
        stats_list = self.optimizer_step([self.batch_to_device(mb) for mb in minibatch])
        # the host fetch of the stats also waits for the step on the device
        flat = [{k: float(v) for k, v in s.items()} for s in stats_list]
        stats = {k: sum(s[k] for s in flat) / len(flat) for k in flat[0]}
        step_s = time.perf_counter() - t0
        stats["time/train_step_s"] = step_s
        stats["throughput/train_tokens_per_s"] = tokens / step_s
        return stats

    def _maybe_inject_train_fault(self, minibatch: List[Any]) -> List[Any]:
        """Apply a scheduled train-side fault (`resilience.FaultInjector`)
        to this step's host microbatches; a no-op without an injector."""
        if self.fault_injector is None:
            return minibatch
        fault = self.fault_injector.train_fault(self.iter_count)
        if fault is None:
            return minibatch
        logger.warning(f"FaultInjector: injecting '{fault}' at step {self.iter_count}")
        self.fault_injector.maybe_hang(fault)
        if fault == "hang":
            return minibatch
        return [self.fault_injector.poison_batch(mb, fault) for mb in minibatch]

    # ------------------------------------------------------------------
    # Learn / evaluate / checkpoints
    # ------------------------------------------------------------------

    def _resolve_resume_checkpoint(self) -> Optional[str]:
        """An explicit `train.resume_from_checkpoint` wins; otherwise, with
        `train.auto_resume`, the newest manifest-complete checkpoint under
        `checkpoint_dir` (a truncated one gives way to the previous valid
        one)."""
        cfg = self.config.train
        if cfg.resume_from_checkpoint:
            if os.path.exists(cfg.resume_from_checkpoint):
                return os.path.abspath(cfg.resume_from_checkpoint)
            logger.warning(f"resume_from_checkpoint={cfg.resume_from_checkpoint} does not exist; starting fresh")
        if cfg.auto_resume:
            found = resilience.find_latest_valid_checkpoint(cfg.checkpoint_dir)
            if found:
                logger.info(f"auto_resume: continuing from {found}")
            else:
                logger.info(f"auto_resume: no valid checkpoint under '{cfg.checkpoint_dir}'; starting fresh")
            return found
        return None

    def learn(self):
        """Outer loop: initial evaluation, then optimizer steps over the
        train loader's minibatches with crossing-interval checkpoints and
        evaluations. The checkpoint `_resolve_resume_checkpoint` picks (an
        explicit `train.resume_from_checkpoint`, or under `auto_resume` the
        newest valid one) loads first and the loop continues at its saved
        position. A preemption signal ends the run at the next step
        boundary with a `_preempt` checkpoint and `SystemExit(75)`; a
        sentinel rewind restores `last_good` and goes on."""
        logger.info("Starting training")
        self.iter_count = 0
        self.nth_evaluation = 0
        self._loop_pos = None
        self._resume_pos = None
        self._best_reward = -float("inf")
        self._resumed = False
        resume = self._resolve_resume_checkpoint()
        if resume:
            # load() before prepare_learning, so the restored state
            # (generator, step, a rollout store) feeds the loaders
            self.load(resume)
            self._resumed = True
        self.prepare_learning()
        if not self._resumed:
            results = self.evaluate()
            self.tracker.log(results, step=self.iter_count)
        clock = Clock()
        if self.config.train.handle_preemption:
            self._preemption_guard = resilience.PreemptionGuard().install()
        if self.config.train.step_timeout_s:
            # beats arrive at step boundaries and at rollout chunks; a
            # wedged step dumps every thread's stack and exits 75
            self._watchdog = StepWatchdog(self.config.train.step_timeout_s,
                                          on_timeout=self._watchdog_on_timeout).start()
        try:
            while True:
                try:
                    return self._learn_loop(self._best_reward, clock)
                except SentinelRewind as e:
                    self._sentinel_rewind(e)
        except resilience.PreemptionInterrupt as e:
            logger.warning(
                f"Preempted (signal {e.signum}); emergency checkpoint at step {self.iter_count} under "
                f"'{self.config.train.checkpoint_dir}'. Exiting with code {resilience.PREEMPTION_EXIT_CODE}."
            )
            raise SystemExit(resilience.PREEMPTION_EXIT_CODE) from e
        finally:
            if self._preemption_guard is not None:
                self._preemption_guard.uninstall()
                self._preemption_guard = None
            if self._watchdog is not None:
                self._watchdog.stop()
                self._watchdog = None
            # a trainer-launched rollout fleet must not outlive learn()
            shutdown_fleet = getattr(self, "shutdown_rollout_fleet", None)
            if shutdown_fleet is not None:
                shutdown_fleet()

    def _learn_loop(self, best_reward, clock):
        results = {}
        # exact resume: pos carries (epoch, inner epoch, the iter_count the
        # interrupted inner epoch's loader was seeded at); minibatches
        # already consumed are skipped so the shuffle and order replay
        pos = self._resume_pos
        self._resume_pos = None
        start_epoch = pos["epoch"] if pos else 0
        for epoch_idx in range(start_epoch, self.config.train.epochs):
            inner_start = pos["inner"] if pos and epoch_idx == start_epoch else 0
            for inner_idx in range(inner_start, self.n_inner_epochs):
                if pos is not None and epoch_idx == start_epoch and inner_idx == inner_start:
                    epoch_start_iter = pos["epoch_start_iter"]
                    pos = None
                else:
                    epoch_start_iter = self.iter_count
                train_dataloader = self.create_train_dataloader(seed_offset=epoch_start_iter - self.iter_count)
                skip_steps = self.iter_count - epoch_start_iter
                self._loop_pos = {"epoch": epoch_idx, "inner": inner_idx, "epoch_start_iter": epoch_start_iter}
                for mb_idx, minibatch in enumerate(MiniBatchIterator(train_dataloader, self.mb_size, self.num_mb)):
                    if mb_idx < skip_steps:
                        continue
                    stats = self.train_minibatch(minibatch)
                    self.iter_count += 1
                    res, best_reward, done = self._post_step(stats, clock, best_reward)
                    results = res or results
                    if done:
                        return results
                    if self._sentinel_skip_chunk:
                        break
                self.post_backward_callback()
                if self._sentinel_skip_chunk:
                    # the sentinel's skip rung: leave the remaining inner
                    # epochs over this suspect batch and collect fresh
                    # experience through post_epoch_callback
                    self._sentinel_skip_chunk = False
                    logger.warning(f"Sentinel: skipping the rest of the current chunk at step {self.iter_count}; "
                                   "collecting fresh experience")
                    break
            self.post_epoch_callback()
        return results

    def _post_step(self, stats, clock, best_reward, n_steps: int = 1):
        """The watchdog's beat, the sentinel's verdict (or, with it off, the
        divergence check), crossing-interval checkpoint and evaluation, the
        sentinel's `last_good` pin, best checkpoint, logging. Returns (eval
        results, best_reward, done)."""
        results = {}
        done = self.iter_count >= self.total_steps
        self._best_reward = best_reward

        def crossed(interval: int) -> bool:
            return self.iter_count // interval > (self.iter_count - n_steps) // interval

        if self._watchdog is not None:
            self._watchdog.beat()
        # checked before any checkpoint write, so a NaN-poisoned state never
        # overwrites the last good checkpoint
        verdict = None
        if self._sentinel is not None:
            # the guard reports the share of skipped steps; a count for the
            # cumulative counter
            self._sentinel.record_skipped(stats.get("train/skipped_updates", 0.0) * n_steps)
            verdict = self._sentinel.observe_step(stats, self.iter_count)
            stats.update(self._sentinel.stats())
            if verdict.action != "ok":
                logger.warning(f"Sentinel {verdict.action} at step {self.iter_count}: " + "; ".join(verdict.reasons))
            if verdict.action == "skip":
                self._sentinel_skip_chunk = True
            elif verdict.action == "rewind":
                # this step's stats go out first, the anomaly among them
                self.tracker.log(stats, step=self.iter_count)
                raise SentinelRewind(self.iter_count, verdict.reasons)
            elif verdict.action == "abort":
                self.tracker.log(stats, step=self.iter_count)
                raise FloatingPointError(
                    f"Health sentinel abort at step {self.iter_count}: " + "; ".join(verdict.reasons)
                    + f". Resume from a checkpoint under '{self.config.train.checkpoint_dir}' with a lower "
                    "learning rate or tighter clipping (train.resume_from_checkpoint)."
                )
        else:
            self._check_divergence(stats)
        subfolder = f"checkpoint_{self.iter_count:0{len(str(self.total_steps))}d}"
        guard = self._preemption_guard
        if guard is not None and guard.triggered:
            # a preemption signal arrived during the step: save this step
            # boundary and leave; a resume from it continues bit for bit
            directory = os.path.join(self.config.train.checkpoint_dir, f"{subfolder}_preempt")
            logger.warning(f"Writing emergency checkpoint (signal {guard.signum}) to {directory}")
            self.save(directory)
            raise resilience.PreemptionInterrupt(guard.signum)
        if crossed(self.config.train.checkpoint_interval) or done:
            directory = os.path.join(self.config.train.checkpoint_dir, subfolder)
            self.save(directory)
            self.save_pretrained(os.path.join(directory, "hf_model"))
            if self.config.train.checkpoint_keep_n > 0:
                resilience.gc_checkpoints(self.config.train.checkpoint_dir, self.config.train.checkpoint_keep_n)
        if verdict is not None and verdict.action == "ok" and self._sentinel.should_pin(self.iter_count):
            # the rewind target, pinned after enough clean steps; noted
            # before the save so the pin's own state carries the pointer
            directory = os.path.join(self.config.train.checkpoint_dir, LAST_GOOD_NAME)
            self._sentinel.note_pinned(directory, self.iter_count)
            logger.info(f"Sentinel: pinning last_good checkpoint at step {self.iter_count}")
            self.save(directory)
        stats["time/step"] = clock.tick(self.config.train.batch_size * n_steps) / n_steps
        stats["learning_rate"] = float(self.lr_schedule(self.iter_count))

        if crossed(self.config.train.eval_interval) or done:
            results = self.evaluate()
            stats.update(results)
            if self.config.train.save_best:
                current = stats.get("reward/mean", stats.get("metrics/reward", -float("inf")))
                if current > best_reward:
                    best_reward = current
                    self._best_reward = current
                    directory = os.path.join(self.config.train.checkpoint_dir, "best_checkpoint")
                    logger.info(f"Saving best checkpoint into {directory}")
                    self.save(directory)
                    self.save_pretrained(os.path.join(directory, "hf_model"))

        self.tracker.log(stats, step=self.iter_count)
        loss_desc = " | ".join(
            f"{k.split('/')[-1]}: {significant(v)}" for k, v in stats.items() if "loss" in k and np.ndim(v) == 0
        )
        logger.info(f"[step {self.iter_count}/{self.total_steps}] {loss_desc}")
        return results, best_reward, done

    def _check_divergence(self, stats: Dict[str, Any]):
        """Count consecutive steps with a non-finite loss; abort once
        `train.nan_guard_patience` runs out (stats flushed first)."""
        if not self.config.train.nan_guard:
            return
        bad = any(np.ndim(v) == 0 and "loss" in k and not np.isfinite(v) for k, v in stats.items())
        if not bad:
            self._nan_streak = 0
            return
        self._nan_streak += 1
        logger.warning(f"Non-finite loss at step {self.iter_count} ({self._nan_streak}/{self.config.train.nan_guard_patience})")
        if self._nan_streak >= self.config.train.nan_guard_patience:
            self.tracker.log(stats, step=self.iter_count)
            raise FloatingPointError(
                f"Loss diverged (non-finite for {self._nan_streak} consecutive steps). Resume from "
                f"the last checkpoint under '{self.config.train.checkpoint_dir}' with a lower learning "
                "rate or tighter clipping (train.resume_from_checkpoint)."
            )

    def _sentinel_rewind(self, e: SentinelRewind):
        """Restore the pinned `last_good` checkpoint exactly, carry the
        sentinel's own ladder state across the load (its rewind budget
        must survive, or the run would rewind forever), move the sampling
        generator off the pinned stream so the chunk that bred the anomaly
        is not drawn again, and open the cooldown window."""
        sen = self._sentinel
        path = sen.last_good["path"]
        logger.warning(
            f"Sentinel rewind #{sen.rewinds_used + 1}/{sen.max_rewinds}: restoring last_good (step "
            f"{sen.last_good['step']}) from {path} after: " + "; ".join(e.reasons)
        )
        ladder_state = sen.state_dict()
        self.load(path)
        sen.load_state_dict(ladder_state)
        sen.note_rewind(self.iter_count)
        # the counterpart of JAX's fold_in(rng, step): a new seed drawn
        # deterministically from the restored generator's state and the
        # rewind's step (the two packages' streams differ anyway)
        digest = hashlib.sha256(self.generator.get_state().cpu().numpy().tobytes()
                                + int(e.step).to_bytes(8, "little")).digest()
        self.generator.manual_seed(int.from_bytes(digest[:8], "little") >> 1)
        self._sentinel_skip_chunk = False
        self._post_rewind()

    def _post_rewind(self):
        """Trainer-specific work after a sentinel rewind (PPO drops the
        restored rollout store and collects fresh experience)."""

    def evaluate(self) -> Dict[str, Any]:
        """Generate on the eval prompts and score with reward_fn/metric_fn.
        With a list-valued gen kwarg the pass repeats per value, metrics
        suffixed @k=v."""
        logger.info("Evaluating model")
        clock = Clock()
        stats: Dict[str, Any] = {}
        if self.generate_sweep_kwarg is not None:
            sweep_arg, sweep_values = self.generate_sweep_kwarg
        else:
            sweep_arg, sweep_values = None, [None]
        for sweep_value in sweep_values:
            if sweep_value is not None:
                gen_kwargs = {**self.generate_kwargs, sweep_arg: sweep_value}
                suffix = f"@{sweep_arg}={sweep_value}"
            else:
                gen_kwargs, suffix = self.generate_kwargs, ""
            all_samples, all_prompts, all_outputs, all_metadata = [], [], [], []
            clock.tick()
            for batch in self.eval_dataloader:
                out = self.generate(batch["input_ids"], batch["attention_mask"], gen_kwargs)
                samples = out["samples"].cpu().numpy()
                str_samples, str_prompts, str_outputs = self.decode(np.asarray(batch["input_ids"]), samples)
                all_samples += str_samples
                all_prompts += str_prompts
                all_outputs += str_outputs
                all_metadata.append({k: v for k, v in batch.items() if k not in ("input_ids", "attention_mask")})
            stats["time/generate"] = stats.get("time/generate", 0.0) + clock.tick()
            metadata = {}
            for md in all_metadata:
                for k, v in md.items():
                    metadata.setdefault(k, []).extend(v)
            rows = list(zip(all_prompts, all_outputs))
            if self.reward_fn:
                rewards = self.reward_fn(samples=all_samples, prompts=all_prompts, outputs=all_outputs,
                                         tokenizer=self.tokenizer, **metadata)
                rewards = [float(np.sum(np.asarray(r))) if np.ndim(r) > 0 else float(r) for r in rewards]
                rows = [r + (reward,) for r, reward in zip(rows, rewards)]
                stats[f"reward/mean{suffix}"] = float(np.mean(rewards))
                stats.setdefault("reward/mean", stats[f"reward/mean{suffix}"])
            if self.metric_fn:
                metrics = self.metric_fn(samples=all_samples, prompts=all_prompts, outputs=all_outputs, **metadata)
                for k, v in metrics.items():
                    if np.ndim(v) > 0 and len(v):
                        stats[f"metrics/{k}{suffix}"] = float(np.mean(np.asarray(v, dtype=np.float64)))
                    else:
                        stats[f"metrics/{k}{suffix}"] = float(v)
            for row in rows[:8]:
                logger.info(f"Evaluation #{self.nth_evaluation}{suffix}: " + " | ".join(str(x) for x in row))
        self.nth_evaluation += 1
        return stats

    def _resume_state_dict(self) -> Dict[str, Any]:
        best = self._best_reward
        return {
            "iter_count": self.iter_count,
            "nan_streak": self._nan_streak,
            "loop_pos": self._loop_pos,
            "best_reward": best if np.isfinite(best) else None,
            "has_optimizer": bool(self.config.train.save_optimizer),
        }

    def save(self, directory: Optional[str] = None):
        """Save the full trainer state atomically: staged in `<dir>.tmp`,
        `manifest.json` written last, promoted with one `os.replace`. The
        optimizer and scheduler state go in iff `train.save_optimizer`."""
        directory = os.path.abspath(directory or self.config.train.checkpoint_dir)
        tmp, old = directory + ".tmp", directory + ".old"
        for stale in (tmp, old):
            if os.path.isdir(stale):
                shutil.rmtree(stale, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(self.model.state_dict(), os.path.join(tmp, MODEL_FILE))
        state = {"generator": self.generator.get_state()}
        if self.config.train.save_optimizer:
            state["optimizer"] = self.optimizer.state_dict()
            state["scheduler"] = self.scheduler.state_dict()
        extra = self._extra_resume_state()
        if extra:
            state["extra"] = extra
        torch.save(state, os.path.join(tmp, "state.pt"))
        atomic_write_json(os.path.join(tmp, "trainer_state.json"), self._resume_state_dict())
        write_manifest(tmp, self.iter_count)
        if os.path.isdir(directory):
            # os.replace cannot overwrite a non-empty dir: swap the old one aside
            os.replace(directory, old)
        os.replace(tmp, directory)
        shutil.rmtree(old, ignore_errors=True)

    def load(self, directory: str):
        directory = os.path.abspath(directory)
        if not is_valid_checkpoint(directory):
            logger.warning(f"Checkpoint {directory} has no manifest (truncated save?); loading without "
                           "completeness guarantees")
        meta: Dict[str, Any] = {"iter_count": 0}
        path = os.path.join(directory, "trainer_state.json")
        if os.path.exists(path):
            with open(path) as f:
                meta = json.load(f)
        self.model.load_state_dict(torch.load(os.path.join(directory, MODEL_FILE), map_location=self.device,
                                              weights_only=True))
        state = torch.load(os.path.join(directory, "state.pt"), map_location=self.device, weights_only=False)
        if bool(meta.get("has_optimizer", True)) and "optimizer" in state:
            self.optimizer.load_state_dict(state["optimizer"])
            self.scheduler.load_state_dict(state["scheduler"])
        else:
            logger.warning("Checkpoint was saved with train.save_optimizer=False; optimizer state starts fresh")
        if "generator" in state:
            self.generator.set_state(state["generator"].cpu())
        if "extra" in state:
            self._load_extra_resume_state(state["extra"])
        self.iter_count = int(meta.get("iter_count", 0))
        self._nan_streak = int(meta.get("nan_streak", 0))
        self._resume_pos = meta.get("loop_pos")
        self._loop_pos = meta.get("loop_pos")
        if meta.get("best_reward") is not None:
            self._best_reward = float(meta["best_reward"])
        logger.info(f"Restored checkpoint from {directory} at step {self.iter_count}")

    def save_pretrained(self, directory: Optional[str] = None, **kwargs):
        """Portable export: an HF-layout `pytorch_model.bin` and
        `config.json` (every decoder family of `models/hf_interop.py`),
        else the raw state dict in `model_state.pt`; the run config beside
        it. LoRA is merged into the base weights first (peft's
        merge_and_unload); a soft prompt or prefixes, which an HF base
        checkpoint has no slot for, are written beside the unmodified
        base (`soft_prompt.npy`, `prefix_kv.npz`)."""
        from trlx_tpu_torch.models.hf_interop import config_to_hf, params_to_hf_state_dict
        from trlx_tpu_torch.models.lora import merge_lora_into_state_dict

        directory = directory or os.path.join(self.config.train.checkpoint_dir, "hf_model")
        os.makedirs(directory, exist_ok=True)
        cfg = self.model_cfg
        state = self.model.state_dict()
        if cfg.lora_rank > 0:
            state = merge_lora_into_state_dict(state, cfg)
        f32 = lambda t: t.detach().float().cpu().numpy()
        if cfg.prompt_tokens > 0:
            np.save(os.path.join(directory, "soft_prompt.npy"), f32(state["lm.soft_prompt"]))
            logger.warning("Prompt-tuning export: pytorch_model.bin holds the UNMODIFIED base weights; the trained "
                           "soft prompt is in soft_prompt.npy (prepend its embeddings to use it)")
        if cfg.prefix_tokens > 0:
            np.savez(os.path.join(directory, "prefix_kv.npz"),
                     **{f"block_{i}.attn.{kv}": f32(state[f"lm.block_{i}.attn.{kv}"])
                        for i in range(cfg.n_layers) for kv in ("prefix_k", "prefix_v")})
            logger.warning("Prefix-tuning export: pytorch_model.bin holds the UNMODIFIED base weights; the trained "
                           "K/V prefixes are in prefix_kv.npz")
        try:
            sd = params_to_hf_state_dict(state, cfg)
            hf_cfg = config_to_hf(self.model_cfg)
        except NotImplementedError as e:
            logger.warning(f"HF export unavailable ({e}); saving the state dict instead")
            torch.save(state, os.path.join(directory, "model_state.pt"))
        else:
            torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()},
                       os.path.join(directory, "pytorch_model.bin"))
            # the actual tokenizer's special ids, so generate() on the
            # reloaded export stops and pads on this run's tokens
            for key in ("pad_token_id", "eos_token_id", "bos_token_id"):
                v = getattr(self.tokenizer, key, None)
                if v is not None:
                    hf_cfg[key] = int(v)
            with open(os.path.join(directory, "config.json"), "w") as f:
                json.dump(hf_cfg, f, indent=2)
        with open(os.path.join(directory, "trlx_tpu_config.json"), "w") as f:
            json.dump(self.config.to_dict(), f, indent=2, default=str)

    # ------------------------------------------------------------------
    # Serving
    # ------------------------------------------------------------------

    def serve(self, host: Optional[str] = None, port: Optional[int] = None,
              watch_dir: Optional[str] = None, background: bool = False):
        """Serve the current policy through the continuous-batching
        inference server (config section: `inference`). Generation knobs
        come from the method's gen_kwargs overlaid with
        `inference.gen_kwargs`; `inference.max_new_tokens` caps the
        per-request budget and sizes the KV pool.

        With `watch_dir` (or `inference.watch_dir`) the server hot-reloads
        the newest manifest-complete checkpoint of a training run every
        `inference.reload_interval_s`; `inference.sessions` turns on
        `/chat` (paged pool only). `inference.multi_tenant` serves the
        LoRA adapters checkpointed under `inference.adapter_dir` over this
        policy's trunk (`inference/adapters.py`), with fair-share
        admission across tenants. `background=True` starts a daemon
        thread and returns the `InferenceServer` (its `.url` is the base
        endpoint); otherwise this blocks serving."""
        from trlx_tpu_torch.inference import AdapterStore, InferenceEngine, InferenceServer, Scheduler
        from trlx_tpu_torch.ops.sampling import GenerationConfig

        icfg = self.config.inference
        gen_kwargs = {**self.generate_kwargs, **(icfg.gen_kwargs or {})}
        gen_kwargs.setdefault("max_new_tokens", icfg.max_new_tokens)
        gen_kwargs["max_new_tokens"] = min(int(gen_kwargs["max_new_tokens"]), icfg.max_new_tokens)
        gen_cfg = GenerationConfig.from_gen_kwargs(
            gen_kwargs, self.tokenizer.eos_token_id, self.tokenizer.pad_token_id
        )
        adapter_store = None
        if icfg.multi_tenant:
            # the served state dict only gives the store its LoRA leaves'
            # names, shapes, dtype and device: a multi-tenant engine reads
            # factors from the stack alone (slot 0 = zeros = the base)
            adapter_store = AdapterStore(
                self.serving_params(),
                adapter_dir=icfg.adapter_dir,
                max_resident=icfg.max_resident_adapters,
                hbm_budget_bytes=int(icfg.adapter_hbm_budget_mb * 1024 * 1024),
            )
        engine = InferenceEngine(
            self.model, self.model_cfg, self.serving_params(), gen_cfg,
            num_slots=icfg.num_slots,
            max_prompt_len=icfg.max_prompt_len,
            max_prefill_batch=icfg.max_prefill_batch,
            prompt_bucket=icfg.prompt_bucket,
            seed=self.config.train.seed,
            kv_paging=icfg.kv_paging,
            kv_block_size=icfg.kv_block_size,
            kv_pool_blocks=icfg.kv_pool_blocks,
            kv_cache_dtype=icfg.kv_cache_dtype,
            prefix_cache=icfg.prefix_cache,
            prefix_cache_capacity=icfg.prefix_cache_capacity,
            multi_tenant=icfg.multi_tenant,
            adapter_store=adapter_store,
            decode_kernel=icfg.decode_kernel,
        )
        if icfg.sessions:
            engine.enable_sessions(
                ttl_s=icfg.session_ttl_s,
                max_sessions=icfg.session_max,
                bytes_budget_mb=icfg.session_bytes_budget_mb,
            )
        tracer = None
        if icfg.tracing:
            from trlx_tpu_torch.observability.tracing import Tracer

            tracer = Tracer(max_traces=icfg.trace_ring, sample_rate=icfg.trace_sample_rate)
        scheduler = Scheduler(
            engine,
            max_queue_depth=icfg.max_queue_depth,
            max_wait_s=icfg.max_wait_s,
            default_deadline_s=icfg.default_deadline_s,
            fair_share=icfg.fair_share and icfg.multi_tenant,
            tenant_weights=icfg.tenant_weights,
            tenant_queue_depth=icfg.tenant_queue_depth,
            tracer=tracer,
        )
        server = InferenceServer(
            scheduler,
            tokenizer=self.tokenizer,
            host=host if host is not None else icfg.host,
            port=port if port is not None else icfg.port,
            watch_dir=watch_dir if watch_dir is not None else icfg.watch_dir,
            reload_interval_s=icfg.reload_interval_s,
        )
        if background:
            server.start_background()
            return server
        server.serve()
        return server
