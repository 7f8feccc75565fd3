"""Fused log-probability of labels over a large vocabulary.

Port of the JAX package's `ops/fused_ce.py`. `logprobs_of_labels` (the
label's logit minus the row's log-sum-exp) runs over [N, V~50k] logits
in every CE loss and every PPO scoring pass; the fused form streams the
vocabulary once and never writes an [N, V] log-softmax.

- `fused_logprobs_of_labels`: the entry point. Labels are clamped into
  [0, V) first (as the JAX package does), the leading shape is flattened,
  and a `torch.autograd.Function` takes the 2-D call: its forward returns
  the logprobs and saves the lse; its backward is plain torch,
  `g * (onehot - exp(logits - lse))` cast to the logits' dtype, as in
  JAX's `_fused_bwd`.
- `label_logprobs`: the kernel's wrapper. On a cuda tensor it launches
  `csrc/fused_ce.cu` (CUDA, sm_90a) or raises; on a CPU tensor it runs
  `label_logprobs_plain`, the JAX package's `_logprobs_xla` in torch.
"""

import ctypes

import torch

from trlx_tpu_torch import kernels

KERNEL = "label_logprobs"  # launch-counter name (kernels.LAUNCHES)

_CODES = {torch.float32: 0, torch.bfloat16: 1}
_lib = None


def label_logprobs_plain(logits: torch.Tensor, labels: torch.Tensor):
    """[N, V] x [N] -> ([N] logprobs, [N] lse), both f32."""
    logits32 = logits.float()
    lse = torch.logsumexp(logits32, dim=-1)
    label_logit = torch.gather(logits32, 1, labels.long()[:, None])[:, 0]
    return label_logit - lse, lse


def _load():
    global _lib
    if _lib is None:
        lib = kernels.load("fused_ce")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.trlx_label_logprobs.argtypes = [ptr] * 4 + [i32] * 3 + [ptr]
        lib.trlx_label_logprobs.restype = i32
        _lib = lib
    return _lib


def label_logprobs(logits: torch.Tensor, labels: torch.Tensor):
    """Logprob of each row's label and each row's lse, ([N], [N]) f32.
    `labels` must lie in [0, V). Launches the CUDA kernel for cuda
    tensors, runs the plain version for CPU tensors."""
    if logits.dim() != 2 or labels.shape != logits.shape[:1]:
        raise ValueError(f"expected logits [N, V] and labels [N]; got {tuple(logits.shape)} / {tuple(labels.shape)}")
    if logits.device.type == "cpu":
        return label_logprobs_plain(logits, labels)
    if logits.device.type != "cuda":
        raise ValueError(f"label_logprobs runs on cuda or cpu, not {logits.device}")
    if logits.dtype not in _CODES:
        raise ValueError(f"logits dtype {logits.dtype} not in {list(_CODES)}")
    if labels.device != logits.device:
        raise ValueError(f"labels on {labels.device}, logits on {logits.device}")
    if not logits.is_contiguous():
        raise ValueError("logits must be contiguous")
    n, v = logits.shape
    labels = labels.to(torch.int32).contiguous()
    out = torch.empty(n, dtype=torch.float32, device=logits.device)
    lse = torch.empty(n, dtype=torch.float32, device=logits.device)
    if n == 0:
        return out, lse
    lib = _load()
    with torch.cuda.device(logits.device):
        stream = torch.cuda.current_stream(logits.device).cuda_stream
        rc = lib.trlx_label_logprobs(
            logits.data_ptr(), labels.data_ptr(), out.data_ptr(), lse.data_ptr(),
            n, v, _CODES[logits.dtype], stream,
        )
    if rc != 0:
        raise RuntimeError(f"label_logprobs kernel launch failed: CUDA error {rc}")
    kernels.count_launch(KERNEL)
    return out, lse


class _FusedLogprobs(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels):
        out, lse = label_logprobs(logits, labels)
        ctx.save_for_backward(logits, labels, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        logits, labels, lse = ctx.saved_tensors
        p = torch.exp(logits.float() - lse[:, None])
        onehot = torch.zeros_like(p).scatter_(1, labels.long()[:, None], 1.0)
        return (g[:, None] * (onehot - p)).to(logits.dtype), None


def fused_logprobs_of_labels(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Log-probabilities of `labels` under `logits` without an [.., V]
    log-softmax. logits [..., V], labels of the leading shape (int).
    Returns f32 of the leading shape. Out-of-range labels (an ignore
    index such as -100) are clamped into [0, V); callers mask those
    positions out of their loss."""
    lead = logits.shape[:-1]
    v = logits.shape[-1]
    labels = labels.reshape(-1).to(torch.int32).clamp(0, v - 1)
    out = _FusedLogprobs.apply(logits.reshape(-1, v).contiguous(), labels)
    return out.reshape(lead)
