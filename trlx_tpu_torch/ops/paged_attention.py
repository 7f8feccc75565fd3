"""Paged-attention decode: the CUDA kernel's wrapper, its plain PyTorch
version, and the gather reference.

Port of the JAX package's `ops/paged_attention.py`. The decode read path
of the paged KV arena collapses into one kernel launch
(`csrc/paged_attention.cu`, hand-written CUDA for sm_90a, built at first
use by `kernels.py`): each slot's block table is split across thread
blocks (`split_plan`, from the shapes alone), each block fetches its
pages' K/V tiles once with cp.async, dequantizes int8 in registers and
runs an online softmax over them with the whole q-head group (GQA reads KV
once per group), and the last block of each (slot, kv head) merges the
splits in index order.

- `paged_attention_decode`: the wrapper. On a cuda tensor it launches
  the kernel or raises; on a CPU tensor it runs `paged_attention_plain`.
  There is no fallback from one to the other.
- `paged_attention_plain`: the same function in ordinary torch ops
  (gather the table, dequantize in f32, group the q heads, masked f32
  softmax with exact zeros). The CPU tests and `chip_smoke.py` hold the
  kernel against it.
- `paged_attention_reference`: the gather read path that
  `decode_kernel="xla"` selects (dequantize to the output type, repeat kv
  heads, dense softmax with the -1e9 additive bias).

Layouts are the JAX package's: q [b, nh, hd]; arenas [n_blocks, blk, nkv,
hd] (f32/bf16, or int8 with [n_blocks, blk, nkv] f32 scales); table
[b, n_tbl] int32; key_mask [b, n_tbl*blk] (the kernel reads int32 or one
byte: bool, uint8, int8). A row whose mask is all zero returns exact 0.0.
Table entries outside [0, n_blocks) count as masked columns in the kernel
and its plain version.
"""

import ctypes
import math
from typing import Optional

import torch

from trlx_tpu_torch import kernels
from trlx_tpu_torch.ops import quant

NEG_INF = -1e30
KERNEL = "paged_decode"  # launch-counter names (kernels.LAUNCHES)
KERNEL_INT8 = "paged_decode_int8"
MAX_SMEM_BYTES = 232448  # per-block dynamic shared memory on sm_90
GRID_CAP = 1024  # thread blocks a launch aims at: about 8 per SM of an H100's 132
MAX_SPLITS = 32  # splits of one table row at most: its last block reads them all
MAX_STAGES = 2  # K/V pages in flight per block

_Q_CODES = {torch.float32: 0, torch.bfloat16: 1}
_KV_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_lib = None
# device -> int32 counters of the kernel's merge, one per (slot, kv head);
# zero between launches (the merging block resets its own). Launches that
# share them run in stream order, as the port's decode does.
_counters = {}


def _check_args(q, k_arena, v_arena, table, key_mask, k_scale, v_scale):
    if q.dim() != 3 or k_arena.dim() != 4 or table.dim() != 2 or key_mask.dim() != 2:
        raise ValueError(
            "expected q [b, nh, hd], arenas [n_blocks, blk, nkv, hd], "
            "table [b, n_tbl], key_mask [b, n_tbl*blk]"
        )
    b, nh, hd = q.shape
    n_blocks, blk, nkv, hd_k = k_arena.shape
    if v_arena.shape != k_arena.shape or hd_k != hd:
        raise ValueError(f"arena shapes {tuple(k_arena.shape)}/{tuple(v_arena.shape)} do not fit q {tuple(q.shape)}")
    if nh % nkv != 0:
        raise ValueError(f"n_heads {nh} not divisible by n_kv_heads {nkv}")
    n_tbl = table.shape[1]
    if table.shape[0] != b or tuple(key_mask.shape) != (b, n_tbl * blk):
        raise ValueError(
            f"table {tuple(table.shape)} / key_mask {tuple(key_mask.shape)} "
            f"do not fit b={b}, block_size={blk}"
        )
    quantized = k_arena.dtype == torch.int8
    if quantized and (k_scale is None or v_scale is None):
        raise ValueError("int8 arenas require k_scale/v_scale planes")
    if quantized and (k_scale.shape != k_arena.shape[:3] or v_scale.shape != k_arena.shape[:3]):
        raise ValueError("k_scale/v_scale must be [n_blocks, blk, nkv]")
    return b, nh, hd, n_blocks, blk, nkv, n_tbl, quantized


def split_plan(b: int, nkv: int, n_tbl: int, grid_cap: int = GRID_CAP):
    """(pages_per_split, n_splits) of a launch, from the shapes alone:
    the fewest pages a split that keep the grid (b * nkv * n_splits
    blocks) within `grid_cap` and a row's splits within MAX_SPLITS. A
    serving table (b 8, 12 kv heads, 10 entries) gets one page a split; a
    long one (b 8, 8 kv heads, 128 entries) 8."""
    pairs = b * nkv
    pps = max(1, -(-pairs * n_tbl // grid_cap), -(-n_tbl // MAX_SPLITS))
    while pps < n_tbl and pairs * -(-n_tbl // pps) > grid_cap:
        pps += 1
    pps = min(pps, n_tbl)
    return pps, -(-n_tbl // pps)


def paged_attention_decode(
    q: torch.Tensor,         # [b, nh, hd]
    k_arena: torch.Tensor,   # [n_blocks, blk, nkv, hd]
    v_arena: torch.Tensor,
    table: torch.Tensor,     # [b, n_tbl] physical block ids
    key_mask: torch.Tensor,  # [b, n_tbl*blk] key validity (1 = attend)
    *,
    k_scale: Optional[torch.Tensor] = None,  # [n_blocks, blk, nkv] f32
    v_scale: Optional[torch.Tensor] = None,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Fused paged decode attention. Returns [b, nh, hd] in `out_dtype`
    (default: q's dtype). Launches the CUDA kernel for cuda tensors and
    runs the plain version for CPU tensors."""
    _check_args(q, k_arena, v_arena, table, key_mask, k_scale, v_scale)
    if q.device.type == "cpu":
        return paged_attention_plain(
            q, k_arena, v_arena, table, key_mask,
            k_scale=k_scale, v_scale=v_scale, out_dtype=out_dtype,
        )
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention_decode runs on cuda or cpu, not {q.device}")
    return _launch(q, k_arena, v_arena, table, key_mask, k_scale, v_scale, out_dtype)


def _load():
    global _lib
    if _lib is None:
        lib = kernels.load("paged_attention")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.trlx_paged_attention_decode.argtypes = [ptr] * 10 + [i32] * 10 + [ctypes.c_float] + [i32] * 3 + [ptr]
        lib.trlx_paged_attention_decode.restype = i32
        lib.trlx_paged_attention_smem_bytes.argtypes = [i32] * 7
        lib.trlx_paged_attention_smem_bytes.restype = ctypes.c_size_t
        lib.trlx_paged_attention_record_floats.argtypes = [i32, i32]
        lib.trlx_paged_attention_record_floats.restype = ctypes.c_size_t
        _lib = lib
    return _lib


def _launch(q, k_arena, v_arena, table, key_mask, k_scale, v_scale, out_dtype):
    b, nh, hd, n_blocks, blk, nkv, n_tbl, quantized = _check_args(
        q, k_arena, v_arena, table, key_mask, k_scale, v_scale
    )
    out_dtype = out_dtype or q.dtype
    if out_dtype != q.dtype:
        raise ValueError(f"the kernel writes q's dtype {q.dtype}, not {out_dtype}")
    if q.dtype not in _Q_CODES:
        raise ValueError(f"q dtype {q.dtype} not in {list(_Q_CODES)}")
    if k_arena.dtype not in _KV_CODES or v_arena.dtype != k_arena.dtype:
        raise ValueError(f"arena dtypes {k_arena.dtype}/{v_arena.dtype} not in {list(_KV_CODES)}")
    if hd % 8 != 0 or hd > 256:
        raise ValueError(f"head_dim {hd} must be a multiple of 8 and at most 256")
    operands = [q, k_arena, v_arena] + ([k_scale, v_scale] if quantized else [])
    for t in operands + [table, key_mask]:
        if t.device != q.device:
            raise ValueError(f"all operands must be on {q.device}; got one on {t.device}")
    for t in operands:
        if not t.is_contiguous():
            raise ValueError("q, arenas and scales must be contiguous")
    if k_arena.data_ptr() % 16 or v_arena.data_ptr() % 16:
        raise ValueError("arenas must start on a 16-byte boundary (the kernel's vector loads)")
    if quantized and (k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32):
        raise ValueError("k_scale/v_scale must be float32")
    lib = _load()
    group, kv_code = nh // nkv, _KV_CODES[k_arena.dtype]
    pps, n_splits = split_plan(b, nkv, n_tbl)
    stages = min(pps, MAX_STAGES)
    smem = lib.trlx_paged_attention_smem_bytes(group, hd, blk, kv_code, pps, n_splits, stages)
    # too large a block for shared memory: fewer pages in flight, then fewer
    # splits to merge (still a function of the shapes alone)
    while smem > MAX_SMEM_BYTES and (stages > 1 or n_splits > 1):
        if stages > 1:
            stages -= 1
        else:
            pps = -(-n_tbl // (n_splits - 1))
            n_splits = -(-n_tbl // pps)
        smem = lib.trlx_paged_attention_smem_bytes(group, hd, blk, kv_code, pps, n_splits, stages)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"group {group} x head_dim {hd} x block {blk} needs {smem} bytes "
            f"of shared memory, above {MAX_SMEM_BYTES}"
        )
    table = table.to(torch.int32).contiguous()
    if key_mask.dtype in (torch.bool, torch.uint8, torch.int8):
        mask_bytes = 1
    else:
        key_mask, mask_bytes = key_mask.to(torch.int32), 4
    key_mask = key_mask.contiguous()
    out = torch.empty((b, nh, hd), dtype=q.dtype, device=q.device)
    partial = counters = None
    if n_splits > 1:
        records = b * nkv * n_splits * lib.trlx_paged_attention_record_floats(group, hd)
        partial = torch.empty(records, dtype=torch.float32, device=q.device)
        counters = _counters.get(q.device)
        if counters is None or counters.numel() < b * nkv:
            counters = _counters[q.device] = torch.zeros(b * nkv, dtype=torch.int32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.trlx_paged_attention_decode(
            q.data_ptr(), k_arena.data_ptr(), v_arena.data_ptr(),
            k_scale.data_ptr() if quantized else None,
            v_scale.data_ptr() if quantized else None,
            table.data_ptr(), key_mask.data_ptr(), out.data_ptr(),
            partial.data_ptr() if partial is not None else None,
            counters.data_ptr() if counters is not None else None,
            b, nh, nkv, hd, n_blocks, blk, n_tbl, pps, n_splits, stages, 1.0 / math.sqrt(hd),
            _Q_CODES[q.dtype], kv_code, mask_bytes, stream,
        )
    if rc != 0:
        raise RuntimeError(f"paged_attention_decode kernel launch failed: CUDA error {rc}")
    kernels.count_launch(KERNEL_INT8 if quantized else KERNEL)
    return out


def _gather_kv(arena, table, n_blocks):
    """arena[table] as a dense [b, n_tbl*blk, ...] view (arenas and scale
    planes); out-of-range table entries are clamped (their columns are
    masked by the callers)."""
    b, n_tbl = table.shape
    blk = arena.shape[1]
    idx = table.long().clamp(0, n_blocks - 1)
    return arena[idx].reshape(b, n_tbl * blk, *arena.shape[2:])


def paged_attention_plain(
    q, k_arena, v_arena, table, key_mask, *,
    k_scale=None, v_scale=None, out_dtype=None,
) -> torch.Tensor:
    """The kernel's function in ordinary torch ops: same f32 dequant, same
    masking constants, exact 0.0 for rows with no valid column."""
    b, nh, hd, n_blocks, blk, nkv, n_tbl, quantized = _check_args(
        q, k_arena, v_arena, table, key_mask, k_scale, v_scale
    )
    out_dtype = out_dtype or q.dtype
    group = nh // nkv
    k = _gather_kv(k_arena, table, n_blocks).float()
    v = _gather_kv(v_arena, table, n_blocks).float()
    if quantized:
        k = k * _gather_kv(k_scale, table, n_blocks)[..., None]
        v = v * _gather_kv(v_scale, table, n_blocks)[..., None]
    in_range = ((table >= 0) & (table < n_blocks)).repeat_interleave(blk, dim=1)
    valid = key_mask.bool() & in_range  # [b, S]
    # q head h reads kv head h // group: [b, nh, hd] -> [b, nkv, group, hd]
    qg = q.float().reshape(b, nkv, group, hd)
    s = torch.einsum("bngd,bsnd->bngs", qg, k) * (1.0 / math.sqrt(hd))
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    shift = torch.where(m <= NEG_INF / 2, torch.zeros_like(m), m)
    p = torch.exp(s - shift)
    p = torch.where(s <= NEG_INF / 2, torch.zeros_like(p), p)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bngs,bsnd->bngd", p, v)
    out = acc / torch.where(l > 0, l, torch.ones_like(l))
    return out.reshape(b, nh, hd).to(out_dtype)


def paged_attention_reference(
    q, k_arena, v_arena, table, key_mask, *,
    k_scale=None, v_scale=None, out_dtype=None,
) -> torch.Tensor:
    """The gather read path (`decode_kernel="xla"`): gather the table to
    a dense view, dequantize int8 to the output type, repeat kv heads,
    dense softmax with the -1e9 additive bias."""
    b, nh, hd, n_blocks, blk, nkv, n_tbl, quantized = _check_args(
        q, k_arena, v_arena, table, key_mask, k_scale, v_scale
    )
    out_dtype = out_dtype or q.dtype
    k = _gather_kv(k_arena, table, n_blocks)
    v = _gather_kv(v_arena, table, n_blocks)
    if quantized:
        k = quant.dequantize_kv(k, _gather_kv(k_scale, table, n_blocks), out_dtype)
        v = quant.dequantize_kv(v, _gather_kv(v_scale, table, n_blocks), out_dtype)
    if nkv != nh:
        k = k.repeat_interleave(nh // nkv, dim=2)
        v = v.repeat_interleave(nh // nkv, dim=2)
    bias = torch.where(key_mask.bool(), 0.0, -1e9)[:, None, :].float()  # [b, 1, S]
    scores = torch.einsum("bhd,bshd->bhs", q.float(), k.float()) * (1.0 / math.sqrt(hd))
    probs = torch.softmax(scores + bias, dim=-1).to(out_dtype)
    ct = torch.promote_types(out_dtype, v.dtype)  # jnp.einsum's type promotion
    out = torch.einsum("bhs,bshd->bhd", probs.to(ct), v.to(ct))
    return out.to(out_dtype)
