"""Causal flash attention for training and scoring, forward and backward.

Port of the JAX package's `ops/attention.py` (`flash_attention` and the
Pallas kernels under it). q, k, v are [b, t, nh|nkv, hd] (the model's
layout); `mask` is the [b, S] key-validity mask. Causal structure comes
from row and column indices inside the kernels, never from an O(t^2)
bias tensor; q head h reads kv head h // (nh // nkv).

- `flash_attention(q, k, v, mask, causal)`: the entry point. When grad
  is enabled and any of q, k, v requires grad it runs `_FlashAttention`:
  the forward kernel that also writes the per-row log-sum-exp (K4), with
  (q, k, v, mask, out, lse) saved, and the FlashAttention-2 backward
  (K5 for dq, K6 for dk/dv). Otherwise it runs the forward kernel
  without the lse (K3) and records no graph. That is the split JAX makes
  between a `custom_vjp`'s primal and its forward rule: frozen blocks
  (no input carries a tangent) run K3, trainable ones K4.
- `flash_fwd`, `flash_bwd_dq`, `flash_bwd_dkv`: the kernels' wrappers
  (`csrc/flash_attention.cu`, CUDA for sm_90a). At bf16 the forward and
  the backward run on the tensor cores: the products of two bf16 operands
  (q.k^T, dO.v^T) are exact, and the products with an f32 operand (p.V,
  p^T.dO, ds.k, ds^T.q) go through a bf16 hi/lo split of p and ds. Both
  do so at every head dim (at 256, GPT-J-6B's, a block is two warpgroups
  each holding half of the output's columns). At f32 every kernel runs
  on the CUDA cores in f32.
  The dtype and the head dim pick the route (`on_tensor_cores`).
  A head dim the kernels are not instantiated at (`HEAD_DIMS`), up to
  256, takes the padded route: q, k, v (and dO) are zero-padded on the
  last axis to the next instantiation (80 and 96 -> 128, 40 -> 64), the
  same kernel runs on them with the true scale 1/sqrt(hd), and out, dq,
  dk, dv are sliced back. Zero columns add nothing to q.k^T (so lse is
  unchanged) nor to delta = sum(g * out), and the padded columns'
  gradients are exactly 0; each call is still one launch of one kernel.
  `_FlashAttention` pads q, k, v once a call and keeps them padded for
  its backward; a direct call of a wrapper pads its own operands.
  On cuda tensors they launch the kernel or raise; on CPU tensors they
  run the plain versions `flash_fwd_plain` (blockwise online softmax with
  lse, the JAX package's `blockwise_attention_lse`), `flash_bwd_dq_plain` and
  `flash_bwd_dkv_plain` (its `_flash_bwd_xla`). The plain versions follow
  the Pallas kernels' arithmetic: everything in f32, p.V with p in f32
  (the XLA blockwise path casts p to v's dtype first; at bf16 the two
  differ).
- `delta = sum(g * out)` and the GQA group-sum of the per-q-head dk/dv
  stay in torch, as they stay in XLA around the TPU kernels.

A query row with no allowed key writes exactly 0 and lse = DEAD_LSE.
"""

import ctypes
import math
from typing import Optional, Tuple

import torch

from trlx_tpu_torch import kernels

NEG_INF = -1e30
DEAD_LSE = 1e9  # lse of a row with no allowed key: exp(s - 1e9) == 0
HEAD_DIMS = (16, 32, 64, 128, 256)  # the kernels' instantiations (bf16 at 256: two warpgroups a block)
BLOCK_K = 128  # key block of the plain versions

# launch-counter names (kernels.LAUNCHES)
KERNEL_FWD = "flash_fwd"          # K3
KERNEL_FWD_LSE = "flash_fwd_lse"  # K4
KERNEL_BWD_DQ = "flash_bwd_dq"    # K5
KERNEL_BWD_DKV = "flash_bwd_dkv"  # K6

_CODES = {torch.float32: 0, torch.bfloat16: 1}
_lib = None


def _shapes(q, k, v, mask):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"expected q [b, tq, nh, hd], k/v [b, tk, nkv, hd]; got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, tq, nh, hd = q.shape
    bk, tk, nkv, hdk = k.shape
    if bk != b or hdk != hd:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    if nh % nkv != 0:
        raise ValueError(f"n_heads {nh} not divisible by n_kv_heads {nkv}")
    if tuple(mask.shape) != (b, tk):
        raise ValueError(f"mask {tuple(mask.shape)} is not [b, tk] = {(b, tk)}")
    return b, tq, tk, nh, nkv, hd


def _default_mask(k, mask):
    if mask is None:
        return torch.ones(k.shape[:2], dtype=torch.int32, device=k.device)
    return mask


# ---------------------------------------------------------------------------
# Plain versions (CPU path; the card holds each kernel against its own)
# ---------------------------------------------------------------------------


def _allowed(mask, start, stop, tq, causal, device):
    """[b, 1, tq, stop - start] key validity and causal structure."""
    allowed = (mask[:, None, None, start:stop] > 0)
    if causal:
        rows = torch.arange(tq, device=device)[:, None]
        cols = torch.arange(start, stop, device=device)[None, :]
        allowed = allowed & (cols <= rows)
    return allowed


def _kv32(x, group):
    x = x.float()
    return x.repeat_interleave(group, dim=2) if group > 1 else x


def _scale(hd: int, scale: Optional[float]) -> float:
    return 1.0 / math.sqrt(hd) if scale is None else scale


def flash_fwd_plain(q, k, v, mask, causal: bool = True,
                    scale: Optional[float] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out [b, tq, nh, hd] in q's dtype, lse [b, nh, tq] f32); the scores
    are scaled by `scale`, 1/sqrt(hd) by default."""
    b, tq, tk, nh, nkv, hd = _shapes(q, k, v, mask)
    scale = _scale(hd, scale)
    q32, k32, v32 = q.float(), _kv32(k, nh // nkv), _kv32(v, nh // nkv)
    acc = torch.zeros_like(q32)
    m = torch.full((b, nh, tq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, nh, tq), dtype=torch.float32, device=q.device)
    for start in range(0, tk, BLOCK_K):
        stop = min(start + BLOCK_K, tk)
        s = torch.einsum("bqhd,bkhd->bhqk", q32, k32[:, start:stop]) * scale
        s = torch.where(_allowed(mask, start, stop, tq, causal, q.device), s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        shift = torch.where(m_new <= NEG_INF / 2, 0.0, m_new)
        p = torch.exp(s - shift[..., None])
        p = torch.where(s <= NEG_INF / 2, 0.0, p)
        corr = torch.where(m <= NEG_INF / 2, 0.0, torch.exp(m - m_new))
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr.transpose(1, 2)[..., None] + torch.einsum(
            "bhqk,bkhd->bqhd", p, v32[:, start:stop]
        )
        m = m_new
    denom = torch.where(l > 0, l, 1.0)
    out = acc / denom.transpose(1, 2)[..., None]
    lse = torch.where(l > 0, m + torch.log(denom), DEAD_LSE)
    return out.to(q.dtype), lse


def _bwd_blocks(q, k, v, mask, g, lse, delta, causal, scale):
    """Yield (start, stop, k32 block, p, ds) over key blocks, FA-2 math in
    f32 (`_bwd_block_terms` of the JAX package)."""
    b, tq, tk, nh, nkv, hd = _shapes(q, k, v, mask)
    scale = _scale(hd, scale)
    q32, do = q.float(), g.float()
    k32, v32 = _kv32(k, nh // nkv), _kv32(v, nh // nkv)
    for start in range(0, tk, BLOCK_K):
        stop = min(start + BLOCK_K, tk)
        kf = k32[:, start:stop]
        s = torch.einsum("bqhd,bkhd->bhqk", q32, kf) * scale
        allowed = _allowed(mask, start, stop, tq, causal, q.device)
        p = torch.where(allowed, torch.exp(s - lse[..., None]), 0.0)
        dp = torch.einsum("bqhd,bkhd->bhqk", do, v32[:, start:stop])
        ds = p * (dp - delta[..., None]) * scale
        yield start, stop, kf, p, ds


def flash_bwd_dq_plain(q, k, v, mask, g, lse, delta, causal: bool = True,
                       scale: Optional[float] = None) -> torch.Tensor:
    """dq [b, tq, nh, hd] in q's dtype."""
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for _, _, kf, _, ds in _bwd_blocks(q, k, v, mask, g, lse, delta, causal, scale):
        dq = dq + torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    return dq.to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, mask, g, lse, delta, causal: bool = True, scale: Optional[float] = None):
    """Per-q-head (dk, dv), each f32 [b, tk, nh, hd]."""
    b, tq, tk, nh, nkv, hd = _shapes(q, k, v, mask)
    q32, do = q.float(), g.float()
    dk = torch.empty((b, tk, nh, hd), dtype=torch.float32, device=q.device)
    dv = torch.empty_like(dk)
    for start, stop, _, p, ds in _bwd_blocks(q, k, v, mask, g, lse, delta, causal, scale):
        dv[:, start:stop] = torch.einsum("bhqk,bqhd->bkhd", p, do)
        dk[:, start:stop] = torch.einsum("bhqk,bqhd->bkhd", ds, q32)
    return dk, dv


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _load():
    global _lib
    if _lib is None:
        lib = kernels.load("flash_attention")
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.trlx_flash_fwd.argtypes = [ptr] * 6 + [i32] * 8 + [f32, ptr]
        lib.trlx_flash_fwd.restype = i32
        lib.trlx_flash_bwd_dq.argtypes = [ptr] * 8 + [i32] * 8 + [f32, ptr]
        lib.trlx_flash_bwd_dq.restype = i32
        lib.trlx_flash_bwd_dkv.argtypes = [ptr] * 9 + [i32] * 8 + [f32, ptr]
        lib.trlx_flash_bwd_dkv.restype = i32
        lib.trlx_flash_on_tensor_cores.argtypes = [i32] * 3
        lib.trlx_flash_on_tensor_cores.restype = i32
        _lib = lib
    return _lib


def on_tensor_cores(kernel: str, dtype: torch.dtype, hd: int) -> bool:
    """Whether the kernel named by its launch counter (`KERNEL_FWD`, ...)
    runs on the tensor cores (wgmma) at this dtype and head dim, as the
    built library dispatches it; False means the CUDA cores."""
    which = {KERNEL_FWD: 0, KERNEL_FWD_LSE: 0, KERNEL_BWD_DQ: 1, KERNEL_BWD_DKV: 2}[kernel]
    return bool(_load().trlx_flash_on_tensor_cores(which, _CODES[dtype], hd))


def padded_head_dim(hd: int) -> int:
    """The instantiation the kernels run a head dim at: hd itself when it
    is one of `HEAD_DIMS`, else the next larger one (the padded route)."""
    for inst in HEAD_DIMS:
        if hd <= inst:
            return inst
    raise ValueError(f"head_dim {hd} is above the flash kernels' largest instantiation {HEAD_DIMS[-1]} "
                     "(ROADMAP queue C: a head dim the kernels cannot reach)")


def pad_head_dim(x: torch.Tensor, hp: int) -> torch.Tensor:
    """x zero-padded on its last axis to `hp` columns: a fresh contiguous
    (so 16-byte aligned) tensor."""
    return torch.nn.functional.pad(x, (0, hp - x.shape[-1])).contiguous()


def pad_operands(hd: int, *xs):
    """The padded route's operands: each of xs (head dim `hd`) zero-padded
    to `padded_head_dim(hd)`. The kernel then runs at that width with the
    true scale, and its outputs are sliced back to hd."""
    hp = padded_head_dim(hd)
    return [pad_head_dim(x, hp) for x in xs]


def takes_padded_route(q: torch.Tensor) -> bool:
    """Whether attention on q runs at a padded head dim: a cuda tensor whose
    head dim the kernels are not instantiated at (the plain versions on the
    CPU take any head dim)."""
    return q.device.type != "cpu" and q.shape[-1] not in HEAD_DIMS


def _check_cuda(q, k, v, mask, *extra):
    """Device, dtype, layout and head-dim checks shared by the launches.
    Returns the shapes and the mask as contiguous int32."""
    dims = _shapes(q, k, v, mask)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention kernels run on cuda or cpu, not {q.device}")
    if q.dtype not in _CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q/k/v dtypes {q.dtype}/{k.dtype}/{v.dtype}: need one of {list(_CODES)}")
    if dims[-1] not in HEAD_DIMS:
        raise ValueError(f"head_dim {dims[-1]} not in {HEAD_DIMS}")
    for t in (q, k, v, mask) + extra:
        if t.device != q.device:
            raise ValueError(f"all operands must be on {q.device}; got one on {t.device}")
        if not t.is_contiguous():
            raise ValueError("flash attention operands must be contiguous")
    return dims, mask.to(torch.int32).contiguous()


def _check_aligned(what, *tensors):
    """The bf16 kernels copy their bf16 operands in 16-byte chunks."""
    if tensors[0].dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"the bf16 {what} copies q, k, v (and dout) in 16-byte chunks: "
                         "their data must be 16-byte aligned")


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _check_rc(rc, name):
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    kernels.count_launch(name)


def flash_fwd(q, k, v, mask, causal: bool = True, with_lse: bool = False, scale: Optional[float] = None):
    """Forward: out [b, tq, nh, hd] in q's dtype, and with `with_lse` also
    lse [b, nh, tq] f32. K4 with the lse, K3 without; a head dim outside
    `HEAD_DIMS` on padded operands (`pad_operands`)."""
    if q.device.type == "cpu":
        out, lse = flash_fwd_plain(q, k, v, mask, causal, scale)
        return (out, lse) if with_lse else out
    hd = q.shape[-1]
    if hd not in HEAD_DIMS:
        res = flash_fwd(*pad_operands(hd, q, k, v), mask, causal, with_lse, _scale(hd, scale))
        return (res[0][..., :hd].contiguous(), res[1]) if with_lse else res[..., :hd].contiguous()
    (b, tq, tk, nh, nkv, hd), mask = _check_cuda(q, k, v, mask)
    _check_aligned("forward", q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty((b, nh, tq), dtype=torch.float32, device=q.device) if with_lse else None
    with torch.cuda.device(q.device):
        rc = _load().trlx_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), out.data_ptr(),
            lse.data_ptr() if with_lse else None, _CODES[q.dtype],
            b, tq, tk, nh, nkv, hd, int(causal), _scale(hd, scale), _stream(q.device),
        )
    _check_rc(rc, KERNEL_FWD_LSE if with_lse else KERNEL_FWD)
    return (out, lse) if with_lse else out


def flash_bwd_dq(q, k, v, mask, g, lse, delta, causal: bool = True, scale: Optional[float] = None) -> torch.Tensor:
    """dq [b, tq, nh, hd] in q's dtype (K5)."""
    if q.device.type == "cpu":
        return flash_bwd_dq_plain(q, k, v, mask, g, lse, delta, causal, scale)
    hd = q.shape[-1]
    if hd not in HEAD_DIMS:
        qp, kp, vp, gp = pad_operands(hd, q, k, v, g)
        return flash_bwd_dq(qp, kp, vp, mask, gp, lse, delta, causal, _scale(hd, scale))[..., :hd].contiguous()
    (b, tq, tk, nh, nkv, hd), mask = _check_cuda(q, k, v, mask, g, lse, delta)
    _check_rows(q, g, lse, delta)
    _check_aligned("backward", q, k, v, g)
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = _load().trlx_flash_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), g.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), _CODES[q.dtype],
            b, tq, tk, nh, nkv, hd, int(causal), _scale(hd, scale), _stream(q.device),
        )
    _check_rc(rc, KERNEL_BWD_DQ)
    return dq


def flash_bwd_dkv(q, k, v, mask, g, lse, delta, causal: bool = True, scale: Optional[float] = None):
    """Per-q-head (dk, dv), each f32 [b, tk, nh, hd] (K6)."""
    if q.device.type == "cpu":
        return flash_bwd_dkv_plain(q, k, v, mask, g, lse, delta, causal, scale)
    hd = q.shape[-1]
    if hd not in HEAD_DIMS:
        qp, kp, vp, gp = pad_operands(hd, q, k, v, g)
        dk, dv = flash_bwd_dkv(qp, kp, vp, mask, gp, lse, delta, causal, _scale(hd, scale))
        return dk[..., :hd].contiguous(), dv[..., :hd].contiguous()
    (b, tq, tk, nh, nkv, hd), mask = _check_cuda(q, k, v, mask, g, lse, delta)
    _check_rows(q, g, lse, delta)
    _check_aligned("backward", q, k, v, g)
    dk = torch.empty((b, tk, nh, hd), dtype=torch.float32, device=q.device)
    dv = torch.empty_like(dk)
    with torch.cuda.device(q.device):
        rc = _load().trlx_flash_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), g.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), _CODES[q.dtype],
            b, tq, tk, nh, nkv, hd, int(causal), _scale(hd, scale), _stream(q.device),
        )
    _check_rc(rc, KERNEL_BWD_DKV)
    return dk, dv


def _check_rows(q, g, lse, delta):
    b, tq, nh, _ = q.shape
    if g.shape != q.shape or g.dtype != q.dtype:
        raise ValueError(f"g {tuple(g.shape)} {g.dtype} must match q {tuple(q.shape)} {q.dtype}")
    for name, t in (("lse", lse), ("delta", delta)):
        if tuple(t.shape) != (b, nh, tq) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be f32 [b, nh, tq] = {(b, nh, tq)}; got {tuple(t.shape)} {t.dtype}")


def flash_backward(q, k, v, mask, out, lse, g, causal: bool = True, scale: Optional[float] = None):
    """FlashAttention-2 backward from the (out, lse) residuals: delta in
    torch, dq (K5), per-q-head dk/dv (K6) summed over each kv head's
    group in torch. Returns (dq, dk, dv) in the inputs' dtypes."""
    b, tq, tk, nh, nkv, hd = _shapes(q, k, v, mask)
    g = g.to(q.dtype).contiguous()
    delta = (g.float() * out.float()).sum(dim=-1).transpose(1, 2).contiguous()  # [b, nh, tq]
    dq = flash_bwd_dq(q, k, v, mask, g, lse, delta, causal, scale)
    dk, dv = flash_bwd_dkv(q, k, v, mask, g, lse, delta, causal, scale)
    group = nh // nkv
    if group > 1:  # q head h's slice folds onto kv head h // group
        dk = dk.reshape(b, tk, nkv, group, hd).sum(dim=3)
        dv = dv.reshape(b, tk, nkv, group, hd).sum(dim=3)
    return dq, dk.to(k.dtype), dv.to(v.dtype)


class _FlashAttention(torch.autograd.Function):
    """On the padded route q, k, v are padded once here and saved padded
    (with the padded out, whose extra columns are exactly 0); the backward
    pads g once and slices dq, dk, dv once."""

    @staticmethod
    def forward(ctx, q, k, v, mask, causal):
        hd = q.shape[-1]
        ctx.causal, ctx.hd, ctx.scale = causal, hd, _scale(hd, None)
        if takes_padded_route(q):
            q, k, v = pad_operands(hd, q, k, v)
        out, lse = flash_fwd(q, k, v, mask, causal, with_lse=True, scale=ctx.scale)
        ctx.save_for_backward(q, k, v, mask, out, lse)
        return out if out.shape[-1] == hd else out[..., :hd].contiguous()

    @staticmethod
    def backward(ctx, g):
        q, k, v, mask, out, lse = ctx.saved_tensors
        hd = ctx.hd
        if q.shape[-1] != hd:
            g = pad_head_dim(g.to(q.dtype), q.shape[-1])
        grads = flash_backward(q, k, v, mask, out, lse, g, ctx.causal, ctx.scale)
        if q.shape[-1] != hd:
            grads = [x[..., :hd].contiguous() for x in grads]
        dq, dk, dv = grads
        return dq, dk, dv, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    causal: bool = True,
) -> torch.Tensor:
    """Fused attention. q [b, t, nh, hd], k/v [b, S, nkv, hd], mask [b, S]
    key validity (1 = real). Returns [b, t, nh, hd] in q's dtype."""
    mask = _default_mask(k, mask)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashAttention.apply(q.contiguous(), k.contiguous(), v.contiguous(), mask, causal)
    return flash_fwd(q.contiguous(), k.contiguous(), v.contiguous(), mask, causal)
