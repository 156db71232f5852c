"""Flash attention, forward and backward — the counterpart of
``paddle_tpu/ops/pallas_ops/flash_attention.py``.

The JAX names are kept, so callers written against the JAX package (the
ring-attention chunks call the three ``_flash_*_bhsd`` entry points
directly) port one for one:

- :func:`_keep_mask` — the dropout keep bits, a pure uint32 hash of
  ``(seed, b·H + h, global row, global col)``, bit-exact with the JAX
  package's and with the CUDA kernels'.
- :func:`_flash_fwd_bhsd` (``o``, ``lse``), :func:`_flash_dkv_bhsd`
  (``dk``, ``dv``) and :func:`_flash_dq_bhsd` (``dq``) — on a CUDA tensor
  each launches its hand-written kernel (``csrc/flash_attention.cu``), on
  a CPU tensor it runs its plain PyTorch version
  (:func:`flash_fwd_ref`, :func:`flash_dkv_ref`, :func:`flash_dq_ref`).
  There is no other branch and no fallback on the card.  Each is a
  ``torch.library`` operator (``paddle_tpu_torch::flash_fwd``,
  ``flash_dkv``, ``flash_dq``) with a fake function: a tensor with no
  data (a static Program's placeholder, a ``torch.export`` trace, the
  meta device) gets its shapes and launches nothing, and an exported
  program keeps the op, which picks its route where the program runs.
- :func:`_flash_bwd_bhsd` — ``delta = rowsum(dO ⊙ O)`` as a torch
  expression outside the kernels (the JAX package leaves it to XLA), then
  the two backward kernels.
- :class:`FlashAttentionCore` — the ``torch.autograd.Function`` twin of
  the ``jax.custom_vjp`` ``_flash_attention_core``.
- :func:`flash_attention_bshd` — ``[B, S, H, D]`` in and out.

Semantics (those of the Pallas bodies): scores of the pre-scaled q
(``scale = 1/sqrt(D)`` of the unpadded D) against k; the causal mask is
``row >= col`` on global positions with no offset; masked scores take
the finite sentinel ``NEG_INF`` (never ``-inf``); dropout multiplies only
the p·v accumulation by ``keep / (1 - p)`` while the denominator keeps
the full mass, and ``lse = m + log(max(l, 1e-30))``.  The block sizes
``block_q``/``block_k`` of the JAX signatures are accepted and ignored:
the CUDA kernels size their tiles by D, and no output depends on them —
except a row that sees no key at all (a batch row whose ``kv_mask`` is
all 0), which is ill-defined in the reference.  Such a row is finite in
every route: the plain version returns the mean of ``v`` over all keys
(every score is ``NEG_INF``, so every ``p`` is 1), the kernel the mean
over the keys of the tiles it computed, as the Pallas kernel does over
its blocks.

``FLASH_ROUTE_STATS`` counts ``"fwd"``, ``"dkv"`` and ``"dq"`` kernel
launches (incremented by the kernel wrappers, once per launch, and
nowhere else) and ``"ref"`` plain-version calls (by the routing
entries).  ``FLASH_TC_STATS`` counts, besides, the launches of the
bf16 bodies, which run on the tensor cores: the forward, dK/dV and dQ
(``"fwd"``, ``"dkv"``, ``"dq"``).  In bf16 those round P and dS to bf16
before their second product, so they match the plain version (which
keeps them in f32) within the bf16 tolerance, not to f32 rounding.
``FLASH_FP16_STATS`` counts the launches of the fp16 bodies
(``"fwd"``, ``"dkv"``, ``"dq"``): the bf16 bodies' template instanced on
fp16, tensor cores with f32 accumulators, P and dS rounded to fp16
(11 significant bits, 5 exponent bits: a dS past 65504 becomes inf,
which a ``GradScaler`` sees as an overflow).
``FLASH_F32TC_STATS`` counts the launches of the f32 bodies
(``"fwd"``, ``"dkv"``, ``"dq"``), which run on the tensor cores in
3xTF32: each f32 operand is split into a TF32 part and a TF32 residual
and three TF32 products are summed in f32, about f32's accuracy.
All of them count through ``profiler.jit_cost.count_launch``, so inside
a CUDA graph (the hapi train step) every replay adds the launches it
runs.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from ..profiler.jit_cost import count_launch

__all__ = ["NEG_INF", "FLASH_ROUTE_STATS", "FLASH_TC_STATS",
           "FLASH_FP16_STATS", "FLASH_F32TC_STATS", "MAX_HEAD_DIM",
           "_keep_mask",
           "flash_fwd_ref", "flash_dkv_ref", "flash_dq_ref",
           "flash_fwd_cuda", "flash_dkv_cuda", "flash_dq_cuda",
           "_flash_fwd_bhsd", "_flash_dkv_bhsd", "_flash_dq_bhsd",
           "_flash_bwd_bhsd", "FlashAttentionCore", "flash_attention_bshd"]

NEG_INF = -1e30

FLASH_ROUTE_STATS = {"fwd": 0, "dkv": 0, "dq": 0, "ref": 0}
# launches of the tensor-core bodies (bf16 forward, dK/dV and dQ)
FLASH_TC_STATS = {"fwd": 0, "dkv": 0, "dq": 0}
# launches of the fp16 bodies (the same tensor-core template in fp16)
FLASH_FP16_STATS = {"fwd": 0, "dkv": 0, "dq": 0}
# launches of the f32 bodies (tensor cores, 3xTF32)
FLASH_F32TC_STATS = {"fwd": 0, "dkv": 0, "dq": 0}

# the kernels hold a tile of up to 256 head columns in shared memory (the
# route admits D <= 256, as the JAX package's does)
MAX_HEAD_DIM = 256

_U32 = 0xFFFFFFFF


def _keep_threshold(dropout_p: float) -> int:
    return min(int(dropout_p * 4294967296.0), 4294967295)


def _keep_mask(seed, bh, rows, cols, dropout_p):
    """Dropout keep bits: the xorshift-multiply hash of the JAX package,
    bit for bit.  uint32 arithmetic is done in int64 with the low 32 bits
    kept after every multiply and add (the low 32 bits of a product
    depend only on the operands' low 32 bits, so the int64 wrap-around
    cannot reach them).  ``seed``/``bh`` are ints or int tensors that
    broadcast against ``rows``/``cols``; a negative int32 seed wraps to
    its uint32 value, as ``astype(uint32)`` does."""
    def u32(x):
        if isinstance(x, torch.Tensor):
            return x.to(torch.int64) & _U32
        return torch.tensor(int(x) & _U32, dtype=torch.int64)

    r, c = u32(rows), u32(cols)
    x = ((r * 0x9E3779B1) & _U32) ^ ((c * 0x85EBCA77) & _U32)
    x = (x + ((u32(seed) * 0xC2B2AE3D) & _U32)) & _U32
    x = x ^ ((u32(bh) * 0x27D4EB2F) & _U32)
    x = x ^ (x >> 15)
    x = (x * 0x2C1B3C6D) & _U32
    x = x ^ (x >> 12)
    x = (x * 0x297A2D39) & _U32
    x = x ^ (x >> 15)
    return x >= _keep_threshold(dropout_p)


def _seed_int(seed) -> int:
    """The seed as a Python int (an int32 value): ``None`` is 0, a tensor
    gives its first element (read on the host: the plain versions'
    path; the kernels read a CUDA seed tensor on the card)."""
    if seed is None:
        return 0
    if isinstance(seed, torch.Tensor):
        return int(seed.reshape(-1)[0].item())
    return int(seed)


def _mask2d(mask, B, Sk, device):
    """The kv validity mask as ``[B, Sk]`` f32 (1.0 = attend); the JAX
    package carries it as ``[B, 1, Sk]``; ``None`` attends everywhere."""
    if mask is None:
        return torch.ones((B, Sk), dtype=torch.float32, device=device)
    return mask.reshape(B, Sk).to(device=device, dtype=torch.float32)


def _scores(q, k, mask, scale, causal):
    """Masked scores of the pre-scaled q against k, f32 [B, H, Sq, Sk],
    and the global (row, col) index grids."""
    B, H, Sq, _ = q.shape
    Sk = k.shape[2]
    s = torch.matmul(q.float() * scale, k.float().transpose(-1, -2))
    rows = torch.arange(Sq, device=q.device)[:, None]
    cols = torch.arange(Sk, device=q.device)[None, :]
    if causal:
        s = torch.where(rows >= cols, s, torch.full_like(s, NEG_INF))
    valid = _mask2d(mask, B, Sk, q.device)[:, None, None, :] > 0
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    return s, rows, cols


def _keep(seed, B, H, rows, cols, dropout_p, device):
    bh = torch.arange(B * H, device=device).reshape(B, H, 1, 1)
    return _keep_mask(_seed_int(seed), bh, rows, cols, dropout_p)


def flash_fwd_ref(q, k, v, mask, seed, scale, causal, dropout_p):
    """Plain version of ``_fwd_kernel``: the whole score matrix at once,
    f32.  q [B, H, Sq, D], k/v [B, H, Sk, D], mask [B, Sk] (or [B, 1, Sk]
    or None) -> (o [B, H, Sq, D] in q's dtype, lse [B·H, Sq, 1] f32)."""
    B, H, Sq, D = q.shape
    s, rows, cols = _scores(q, k, mask, scale, causal)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l_safe = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    if dropout_p > 0.0:
        keep = _keep(seed, B, H, rows, cols, dropout_p, q.device)
        p = torch.where(keep, p * (1.0 / (1.0 - dropout_p)),
                        torch.zeros_like(p))
    o = torch.matmul(p, v.float()) / l_safe
    lse = (m + torch.log(l_safe)).reshape(B * H, Sq, 1)
    return o.to(q.dtype), lse


def _probs_and_ds(q, k, v, g, lse, delta, mask, seed, scale, causal,
                  dropout_p):
    """What both backward bodies recompute: the normalized
    probabilities P (from the saved lse), the dropped probabilities for
    dV and dS = P ⊙ (dP' − delta)."""
    B, H, Sq, _ = q.shape
    s, rows, cols = _scores(q, k, mask, scale, causal)
    p = torch.exp(s - lse.reshape(B, H, Sq, 1))
    dp = torch.matmul(g.float(), v.float().transpose(-1, -2))
    if dropout_p > 0.0:
        keep = _keep(seed, B, H, rows, cols, dropout_p, q.device)
        inv = 1.0 / (1.0 - dropout_p)
        p_v = torch.where(keep, p * inv, torch.zeros_like(p))
        dp = torch.where(keep, dp * inv, torch.zeros_like(dp))
    else:
        p_v = p
    ds = p * (dp - delta.reshape(B, H, Sq, 1))
    return p_v, ds


def flash_dkv_ref(q, k, v, g, lse, delta, mask, seed, scale, causal,
                  dropout_p):
    """Plain version of ``_bwd_dkv_kernel``: dK = scale · dSᵀ·q and
    dV = P'ᵀ·dO for the given per-row ``lse`` and ``delta`` ([B·H, Sq] or
    [B·H, Sq, 1] f32).  Returns (dk, dv) [B, H, Sk, D] in k's and v's
    dtypes."""
    p_v, ds = _probs_and_ds(q, k, v, g, lse, delta, mask, seed, scale,
                            causal, dropout_p)
    dv = torch.matmul(p_v.transpose(-1, -2), g.float())
    dk = torch.matmul(ds.transpose(-1, -2), q.float() * scale)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_dq_ref(q, k, v, g, lse, delta, mask, seed, scale, causal,
                 dropout_p):
    """Plain version of ``_bwd_dq_kernel``: dQ = scale · dS·K.  Returns
    dq [B, H, Sq, D] in q's dtype."""
    _, ds = _probs_and_ds(q, k, v, g, lse, delta, mask, seed, scale,
                          causal, dropout_p)
    return (torch.matmul(ds, k.float()) * scale).to(q.dtype)


# --------------------------------------------------------------------------
# the CUDA kernels
# --------------------------------------------------------------------------
_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16",
           torch.float16: "f16"}
# the per-dtype launch counters besides FLASH_ROUTE_STATS
_DTYPE_STATS = {torch.float32: FLASH_F32TC_STATS,
                torch.bfloat16: FLASH_TC_STATS,
                torch.float16: FLASH_FP16_STATS}
_BOUND = {}


def _kernel(name, dtype):
    """The C entry point ``ptt_flash_<name>_<dtype>``, built and bound at
    first use."""
    key = (name, dtype)
    fn = _BOUND.get(key)
    if fn is None:
        from ._build import load_library

        fn = getattr(load_library("flash_attention"),
                     f"ptt_flash_{name}_{_DTYPES[dtype]}")
        n_ptr = {"fwd": 6, "dkv": 9, "dq": 8}[name]
        # pointers and the stream as c_void_p (a plain int argument would
        # be passed as a 32-bit C int and cut the address)
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_float, ctypes.c_uint, ctypes.c_uint,
                          ctypes.c_void_p, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _BOUND[key] = fn
    return fn


def _check(q, k, v, mask, g=None, lse=None, delta=None):
    """Device, dtype, shape and contiguity of a kernel call; raises on
    anything the kernels do not take.  Returns (B, H, Sq, Sk, D)."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4:
            raise ValueError(f"{name} must be [B, H, S, D], got "
                             f"{tuple(t.shape)}")
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    if tuple(k.shape) != (B, H, Sk, D) or v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash attention kernels take float32, bfloat16 "
                        f"or float16, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {D} is outside 1..{MAX_HEAD_DIM}")
    if tuple(mask.shape) not in ((B, Sk), (B, 1, Sk)) \
            or mask.dtype != torch.float32:
        raise ValueError(f"mask must be float32 [B={B}, Sk={Sk}] (or "
                         f"[B, 1, Sk]), got {mask.dtype} "
                         f"{tuple(mask.shape)}")
    named = [("q", q), ("k", k), ("v", v), ("mask", mask)]
    if g is not None:
        if g.shape != q.shape or g.dtype != q.dtype:
            raise ValueError(f"dO must match q: {g.dtype} {tuple(g.shape)}")
        for name, t in (("lse", lse), ("delta", delta)):
            if t.numel() != B * H * Sq or t.dtype != torch.float32:
                raise ValueError(f"{name} must be float32 [B·H={B * H}, "
                                 f"Sq={Sq}], got {t.dtype} "
                                 f"{tuple(t.shape)}")
        named += [("dO", g), ("lse", lse), ("delta", delta)]
    for name, t in named:
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not q.is_cuda:
        raise ValueError("the flash attention kernels need CUDA tensors")
    return B, H, Sq, Sk, D


def _seed_args(seed, dev):
    """(seed int, seed pointer) of a launch: a CUDA int tensor is read by
    the kernels on the card (its first element, low 32 bits), so a
    captured graph takes each replay's value; anything else is an int
    argument and a null pointer."""
    if isinstance(seed, torch.Tensor) and seed.is_cuda:
        if seed.device != dev or seed.dtype not in (torch.int32,
                                                    torch.int64) \
                or seed.numel() == 0:
            raise ValueError(f"a seed tensor must be int32 or int64 on "
                             f"{dev}, got {seed.dtype} on {seed.device}")
        return 0, seed.data_ptr()
    return _seed_int(seed) & _U32, None


def _launch(name, dtype, ptrs, dims, scale, causal, dropout_p, seed):
    fn = _kernel(name, dtype)
    B, H, Sq, Sk, D = dims
    dev = ptrs[0].device
    seed, seed_ptr = _seed_args(seed, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*(t.data_ptr() for t in ptrs), B * H, H, Sq, Sk, D,
                float(scale), int(bool(causal)), int(dropout_p > 0.0),
                float(1.0 / (1.0 - dropout_p)) if dropout_p > 0.0 else 1.0,
                _keep_threshold(dropout_p), seed, seed_ptr, stream)
    if rc != 0:
        raise RuntimeError(
            f"flash attention {name} kernel launch failed: CUDA error {rc} "
            f"(B={B}, H={H}, Sq={Sq}, Sk={Sk}, D={D}, {dtype})")
    count_launch(FLASH_ROUTE_STATS, name)
    count_launch(_DTYPE_STATS[dtype], name)


def flash_fwd_cuda(q, k, v, mask, seed, scale, causal, dropout_p):
    """Launch the forward kernel, which replaces
    ``paddle_tpu/ops/pallas_ops/flash_attention.py:_fwd_kernel``.  Same
    contract as :func:`flash_fwd_ref` (mask required, f32)."""
    dims = _check(q, k, v, mask)
    B, H, Sq, Sk, D = dims
    o = torch.empty_like(q)
    lse = torch.empty((B * H, Sq, 1), dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o, lse.fill_(NEG_INF)
    if Sk == 0:
        return o.zero_(), lse.fill_(NEG_INF)
    _launch("fwd", q.dtype, (q, k, v, mask, o, lse), dims, scale, causal,
            dropout_p, seed)
    return o, lse


def flash_dkv_cuda(q, k, v, g, lse, delta, mask, seed, scale, causal,
                   dropout_p):
    """Launch the dK/dV kernel, which replaces ``_bwd_dkv_kernel``."""
    dims = _check(q, k, v, mask, g, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if dk.numel() == 0:
        return dk, dv
    if dims[2] == 0:
        return dk.zero_(), dv.zero_()
    _launch("dkv", q.dtype, (q, k, v, g, lse, delta, mask, dk, dv), dims,
            scale, causal, dropout_p, seed)
    return dk, dv


def flash_dq_cuda(q, k, v, g, lse, delta, mask, seed, scale, causal,
                  dropout_p):
    """Launch the dQ kernel, which replaces ``_bwd_dq_kernel``."""
    dims = _check(q, k, v, mask, g, lse, delta)
    dq = torch.empty_like(q)
    if dq.numel() == 0:
        return dq
    if dims[3] == 0:
        return dq.zero_()
    _launch("dq", q.dtype, (q, k, v, g, lse, delta, mask, dq), dims, scale,
            causal, dropout_p, seed)
    return dq


# --------------------------------------------------------------------------
# the routing entries, under the JAX package's names
# --------------------------------------------------------------------------
# Each is a torch.library operator: the dispatcher picks the CUDA kernel or
# the plain version by the device of the tensors it gets, a tensor with no
# data (a fake tensor of a static Program being built or of a torch.export
# trace, a meta tensor) gets its shapes from the op's fake function and
# launches nothing, and an exported program carries the op, so its route is
# chosen where the program runs.  The seed travels as (tensor or None, int).
def _seed_schema(seed):
    if isinstance(seed, torch.Tensor):
        return seed, 0
    return None, _seed_int(seed)


@torch.library.custom_op("paddle_tpu_torch::flash_fwd", mutates_args=())
def _flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  mask: Optional[torch.Tensor], seed_t: Optional[torch.Tensor],
                  seed_i: int, scale: float, causal: bool,
                  dropout_p: float) -> Tuple[torch.Tensor, torch.Tensor]:
    seed = seed_i if seed_t is None else seed_t
    if q.is_cuda:
        m = _mask2d(mask, q.shape[0], k.shape[2], q.device).contiguous()
        return flash_fwd_cuda(q, k, v, m, seed, scale, causal, dropout_p)
    count_launch(FLASH_ROUTE_STATS, "ref")
    return flash_fwd_ref(q, k, v, mask, seed, scale, causal, dropout_p)


@_flash_fwd_op.register_fake
def _flash_fwd_fake(q, k, v, mask, seed_t, seed_i, scale, causal,
                    dropout_p):
    B, H, Sq, _ = q.shape
    return (q.new_empty((B, H, Sq, v.shape[-1])),
            q.new_empty((B * H, Sq, 1), dtype=torch.float32))


@torch.library.custom_op("paddle_tpu_torch::flash_dkv", mutates_args=())
def _flash_dkv_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  g: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                  mask: Optional[torch.Tensor], seed_t: Optional[torch.Tensor],
                  seed_i: int, scale: float, causal: bool,
                  dropout_p: float) -> Tuple[torch.Tensor, torch.Tensor]:
    seed = seed_i if seed_t is None else seed_t
    if q.is_cuda:
        m = _mask2d(mask, q.shape[0], k.shape[2], q.device).contiguous()
        return flash_dkv_cuda(q, k, v, g, lse, delta, m, seed, scale,
                              causal, dropout_p)
    count_launch(FLASH_ROUTE_STATS, "ref")
    return flash_dkv_ref(q, k, v, g, lse, delta, mask, seed, scale, causal,
                         dropout_p)


@_flash_dkv_op.register_fake
def _flash_dkv_fake(q, k, v, g, lse, delta, mask, seed_t, seed_i, scale,
                    causal, dropout_p):
    return k.new_empty(k.shape), v.new_empty(v.shape)


@torch.library.custom_op("paddle_tpu_torch::flash_dq", mutates_args=())
def _flash_dq_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 g: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                 mask: Optional[torch.Tensor], seed_t: Optional[torch.Tensor],
                 seed_i: int, scale: float, causal: bool,
                 dropout_p: float) -> torch.Tensor:
    seed = seed_i if seed_t is None else seed_t
    if q.is_cuda:
        m = _mask2d(mask, q.shape[0], k.shape[2], q.device).contiguous()
        return flash_dq_cuda(q, k, v, g, lse, delta, m, seed, scale, causal,
                             dropout_p)
    count_launch(FLASH_ROUTE_STATS, "ref")
    return flash_dq_ref(q, k, v, g, lse, delta, mask, seed, scale, causal,
                        dropout_p)


@_flash_dq_op.register_fake
def _flash_dq_fake(q, k, v, g, lse, delta, mask, seed_t, seed_i, scale,
                   causal, dropout_p):
    return q.new_empty(q.shape)


def _flash_fwd_bhsd(q, k, v, mask, seed, scale, causal, dropout_p,
                    block_q=None, block_k=None):
    """(o [B, H, Sq, D], lse [B·H, Sq, 1] f32).  A CUDA tensor launches
    the forward kernel; a CPU tensor runs the plain version.
    ``block_q``/``block_k`` are accepted for the JAX signature and
    ignored."""
    return _flash_fwd_op(q, k, v, mask, *_seed_schema(seed), float(scale),
                         bool(causal), float(dropout_p))


def _flash_dkv_bhsd(q, k, v, g, lse, delta, mask, seed, scale, causal,
                    dropout_p, block_q=None, block_k=None):
    """dK, dV of one (q set, kv chunk) pair for the given GLOBAL per-row
    ``lse`` and ``delta``: summed over every visiting q set they give the
    exact global gradients (``Sq`` and ``Sk`` may differ, as ring
    attention calls it with ``causal=False``)."""
    return _flash_dkv_op(q, k, v, g, lse, delta, mask, *_seed_schema(seed),
                         float(scale), bool(causal), float(dropout_p))


def _flash_dq_bhsd(q, k, v, g, lse, delta, mask, seed, scale, causal,
                   dropout_p, block_q=None, block_k=None):
    """dQ of the local queries against one kv chunk (global lse and
    delta)."""
    return _flash_dq_op(q, k, v, g, lse, delta, mask, *_seed_schema(seed),
                        float(scale), bool(causal), float(dropout_p))


def _flash_bwd_bhsd(q, k, v, o, lse, g, mask, seed, scale, causal,
                    dropout_p, block_q=None, block_k=None):
    """(dq, dk, dv): delta = rowsum(dO ⊙ O) in f32 (O already includes
    dropout), then the dK/dV and dQ bodies."""
    B, H, S, _ = q.shape
    g = g.contiguous()
    delta = torch.sum(g.float() * o.float(), dim=-1).reshape(B * H, S, 1)
    dk, dv = _flash_dkv_bhsd(q, k, v, g, lse, delta, mask, seed, scale,
                             causal, dropout_p)
    dq = _flash_dq_bhsd(q, k, v, g, lse, delta, mask, seed, scale, causal,
                        dropout_p)
    return dq, dk, dv


class FlashAttentionCore(torch.autograd.Function):
    """Twin of the ``jax.custom_vjp`` ``_flash_attention_core``: forward
    through the forward body, backward through the dK/dV and dQ bodies.
    Saves q, k, v, o, lse and the mask (tensors) and the seed (an int,
    or an int tensor); the mask and the seed get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, mask, seed, scale, causal, dropout_p):
        o, lse = _flash_fwd_bhsd(q, k, v, mask, seed, scale, causal,
                                 dropout_p)
        ctx.save_for_backward(q, k, v, o, lse, mask)
        ctx.seed, ctx.scale = seed, scale
        ctx.causal, ctx.dropout_p = causal, dropout_p
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse, mask = ctx.saved_tensors
        dq, dk, dv = _flash_bwd_bhsd(q, k, v, o, lse, g, mask, ctx.seed,
                                     ctx.scale, ctx.causal, ctx.dropout_p)
        return dq, dk, dv, None, None, None, None, None


def flash_attention_bshd(q, k, v, causal=False, kv_mask=None, dropout_p=0.0,
                         seed=None, block_q=None, block_k=None):
    """Flash attention on ``[B, S, H, D]`` tensors; returns BSHD in q's
    dtype.  ``kv_mask``: optional ``[B, S]`` validity mask (1/True =
    attend).  ``dropout_p`` drops attention probabilities with the
    counter-based bits of ``seed``: an int32 (None is 0), or an int
    tensor, which the kernels read on the card, so a CUDA graph takes
    the value it holds at each replay.  The scale is ``1/sqrt(D)``.
    Nothing is padded: the kernels mask ragged tiles themselves.
    ``block_q``/``block_k`` are ignored."""
    B, S, H, D = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash_attention_bshd takes self-attention "
                         f"shapes: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    scale = 1.0 / math.sqrt(D)
    mask = _mask2d(kv_mask, B, S, q.device)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    if not isinstance(seed, torch.Tensor):
        seed = _seed_int(seed)
    out = FlashAttentionCore.apply(qt, kt, vt, mask.contiguous(), seed,
                                   scale, bool(causal), float(dropout_p))
    return out.transpose(1, 2)
