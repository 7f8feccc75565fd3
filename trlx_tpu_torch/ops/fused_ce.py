"""Fused log-probability of labels over a large vocabulary.

Port of the JAX package's `ops/fused_ce.py`. `logprobs_of_labels` (the
label's logit minus the row's log-sum-exp) runs over [N, V~50k] logits
in every CE loss and every PPO scoring pass; the fused form streams the
vocabulary once and never writes an [N, V] log-softmax.

- `fused_logprobs_of_labels`: the entry point. Labels are clamped into
  [0, V) first (as the JAX package does), the leading shape is flattened,
  and a `torch.autograd.Function` takes the 2-D call: its forward returns
  the logprobs and saves the lse; its backward is
  `g * (onehot - exp(logits - lse))` cast to the logits' dtype, JAX's
  `_fused_bwd`.
- `label_logprobs` and `label_logprobs_bwd`: the kernels' wrappers. On a
  cuda tensor each launches its kernel in `csrc/fused_ce.cu` (CUDA,
  sm_90a) or raises; on a CPU tensor it runs its plain version:
  `label_logprobs_plain` (the JAX package's `_logprobs_xla` in torch) and
  `label_logprobs_bwd_plain` (`_fused_bwd` in torch).
- `split_plan`, `bwd_split_plan` and `row_peel`: how the kernels cut the
  work, from the shapes alone (the thread blocks a row is split into) and
  from a row's address (the elements before its first 16-byte boundary,
  the 16-byte vectors, the rest).
"""

import ctypes

import torch

from trlx_tpu_torch import kernels

KERNEL = "label_logprobs"  # launch-counter names (kernels.LAUNCHES)
KERNEL_BWD = "label_logprobs_bwd"

_CODES = {torch.float32: 0, torch.bfloat16: 1}
_lib = None

# mirrors of csrc/fused_ce.cu's constants
THREADS = 256  # threads a block
TILE = 4  # 16-byte vectors a thread reads at once in the forward
VECTOR_BYTES = 16
MAX_SPLITS = 8  # the portable thread-block cluster size
# the split plan: enough blocks for several waves over 132 SMs, and at
# least one tile of vectors a thread in each block
TARGET_BLOCKS = 4096
MIN_SPLIT_VECTORS = THREADS * TILE


def split_plan(n: int, vocab: int, itemsize: int) -> int:
    """Thread blocks the forward splits each row of [n, vocab] logits into
    (1, 2, 4 or 8, a cluster): the fewest that give the grid at least
    TARGET_BLOCKS blocks, while each block keeps MIN_SPLIT_VECTORS 16-byte
    vectors. SFT's 8,184 rows and PPO scoring's 13,312 take 1 block a row;
    a PPO step's 1,280 take 4."""
    vectors = vocab * itemsize // VECTOR_BYTES
    splits = 1
    while splits < MAX_SPLITS and n * splits < TARGET_BLOCKS and vectors // (2 * splits) >= MIN_SPLIT_VECTORS:
        splits *= 2
    return splits


def bwd_split_plan(vocab: int, itemsize: int) -> int:
    """Thread blocks the backward splits each row into (1, 2, 4 or 8): the
    most that keep a 16-byte vector for every thread of a block. Its
    blocks share nothing, and more of them measured faster at every shape
    the trainers run (8 at vocab 50257)."""
    vectors = vocab * itemsize // VECTOR_BYTES
    splits = 1
    while splits < MAX_SPLITS and vectors // (2 * splits) >= THREADS:
        splits *= 2
    return splits


def row_peel(address: int, vocab: int, itemsize: int):
    """(head, vectors, tail) of a row of `vocab` elements of `itemsize`
    bytes at `address`: the elements before its first 16-byte boundary,
    the whole 16-byte vectors from there, the elements after them; as the
    kernels' `row_span` cuts it."""
    misaligned = address % VECTOR_BYTES
    head = min((VECTOR_BYTES - misaligned) // itemsize if misaligned else 0, vocab)
    per = VECTOR_BYTES // itemsize
    vectors = (vocab - head) // per
    return head, vectors, vocab - head - vectors * per


def label_logprobs_plain(logits: torch.Tensor, labels: torch.Tensor):
    """[N, V] x [N] -> ([N] logprobs, [N] lse), both f32."""
    logits32 = logits.float()
    lse = torch.logsumexp(logits32, dim=-1)
    label_logit = torch.gather(logits32, 1, labels.long()[:, None])[:, 0]
    return label_logit - lse, lse


def label_logprobs_bwd_plain(logits: torch.Tensor, labels: torch.Tensor, lse: torch.Tensor, g: torch.Tensor):
    """dlogits [N, V] in the logits' dtype: g * (onehot(labels) - exp(logits
    - lse)) in f32, JAX's `_fused_bwd`."""
    p = torch.exp(logits.float() - lse[:, None])
    onehot = torch.zeros_like(p).scatter_(1, labels.long()[:, None], 1.0)
    return (g[:, None] * (onehot - p)).to(logits.dtype)


def _load():
    global _lib
    if _lib is None:
        lib = kernels.load("fused_ce")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.trlx_label_logprobs.argtypes = [ptr] * 4 + [i32] * 4 + [ptr]
        lib.trlx_label_logprobs.restype = i32
        lib.trlx_label_logprobs_bwd.argtypes = [ptr] * 5 + [i32] * 4 + [ptr]
        lib.trlx_label_logprobs_bwd.restype = i32
        _lib = lib
    return _lib


def _check(name: str, logits: torch.Tensor, labels: torch.Tensor, *rows: torch.Tensor) -> bool:
    """Validates the arguments; True when they lie on the CPU (the plain
    version runs), False for cuda tensors the kernel takes."""
    if logits.dim() != 2 or labels.shape != logits.shape[:1] or any(r.shape != logits.shape[:1] for r in rows):
        raise ValueError(f"{name}: expected logits [N, V] and [N] rows; got {tuple(logits.shape)} / "
                         f"{[tuple(t.shape) for t in (labels, *rows)]}")
    if logits.device.type == "cpu":
        return True
    if logits.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {logits.device}")
    if logits.dtype not in _CODES:
        raise ValueError(f"logits dtype {logits.dtype} not in {list(_CODES)}")
    if any(t.device != logits.device for t in (labels, *rows)):
        raise ValueError(f"{name}: every tensor must lie on {logits.device}")
    if not logits.is_contiguous():
        raise ValueError("logits must be contiguous")
    return False


def _launch(fn, name: str, device, *args):
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    kernels.count_launch(name)


def label_logprobs(logits: torch.Tensor, labels: torch.Tensor):
    """Logprob of each row's label and each row's lse, ([N], [N]) f32.
    `labels` must lie in [0, V). Launches the CUDA kernel for cuda
    tensors, runs the plain version for CPU tensors."""
    if _check("label_logprobs", logits, labels):
        return label_logprobs_plain(logits, labels)
    n, v = logits.shape
    labels = labels.to(torch.int32).contiguous()
    out = torch.empty(n, dtype=torch.float32, device=logits.device)
    lse = torch.empty(n, dtype=torch.float32, device=logits.device)
    if n == 0:
        return out, lse
    _launch(_load().trlx_label_logprobs, KERNEL, logits.device,
            logits.data_ptr(), labels.data_ptr(), out.data_ptr(), lse.data_ptr(),
            n, v, _CODES[logits.dtype], split_plan(n, v, logits.element_size()))
    return out, lse


def _empty_aligned_like(x: torch.Tensor) -> torch.Tensor:
    """An empty tensor of x's shape and dtype whose address is x's mod 16
    bytes, so both are walked with the same 16-byte vectors."""
    shift = (x.data_ptr() % VECTOR_BYTES) // x.element_size()
    if shift == 0:
        return torch.empty_like(x)
    return torch.empty(x.numel() + shift, dtype=x.dtype, device=x.device)[shift:].view(x.shape)


def label_logprobs_bwd(logits: torch.Tensor, labels: torch.Tensor, lse: torch.Tensor, g: torch.Tensor):
    """The gradient of `label_logprobs`' logprobs: dlogits [N, V] in the
    logits' dtype for the incoming f32 gradient `g` [N] and the forward's
    lse. `labels` must lie in [0, V). Launches the CUDA kernel for cuda
    tensors, runs the plain version for CPU tensors."""
    if _check("label_logprobs_bwd", logits, labels, lse, g):
        return label_logprobs_bwd_plain(logits, labels, lse, g)
    n, v = logits.shape
    labels = labels.to(torch.int32).contiguous()
    lse = lse.to(torch.float32).contiguous()
    g = g.to(torch.float32).contiguous()
    dlogits = _empty_aligned_like(logits)
    if n == 0:
        return dlogits
    _launch(_load().trlx_label_logprobs_bwd, KERNEL_BWD, logits.device,
            logits.data_ptr(), labels.data_ptr(), lse.data_ptr(), g.data_ptr(), dlogits.data_ptr(),
            n, v, _CODES[logits.dtype], bwd_split_plan(v, logits.element_size()))
    return dlogits


class _FusedLogprobs(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels):
        out, lse = label_logprobs(logits, labels)
        ctx.save_for_backward(logits, labels, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        logits, labels, lse = ctx.saved_tensors
        return label_logprobs_bwd(logits, labels, lse, g), None


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
