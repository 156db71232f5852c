"""Ring attention — context/sequence parallelism over a mesh axis, twin
of ``paddle_tpu/distributed/ring_attention.py``.

The sequence dimension is sharded over the 'sp' mesh axis; each slot
holds a local Q/K/V shard, and the KV shards go round the ring while
each slot accumulates its queries' attention with online-softmax merging.

Use inside :func:`~.mesh.shard_map` (see :func:`sequence_parallel_attention`)
or through ``paddle_tpu_torch.nn.functional.ring_attention``.

Two routes, chosen as in the JAX package (``S_local >= 128`` and
``S_local % 128 == 0``: flash; else the plain ring):

- the plain ring: an einsum per ring step, the KV rotated by
  ``lax.ppermute``, differentiated by autograd;
- the flash ring: the flash kernels (#5–#7, ``ops/flash_attention.py``)
  once per (query shard, KV chunk) pair, forward partials merged in lse
  space with the ``1e-30`` floor, the scale from the real head width.
  Its backward is the counter-rotating ring of the JAX package's
  ``_ring_flash_bwd``: dQ over the visiting KV chunks, dK/dV of each
  chunk from the visiting queries, with the forward's global lse and
  ``delta = rowsum(dO·O)``.  The whole ring is ONE autograd node over
  every slot of the axis (the slots meet once, at the call): a backward
  that needed the other shards' tensors could not wait for them inside
  the autograd engine.  Under ``causal`` a chunk that lies wholly in a
  query shard's future is not computed (the JAX package computes it and
  drops it at the merge; the result is the same), so a ring of n slots
  launches each kernel n(n+1)/2 times, and n² times without ``causal``.
  Nothing is padded: the kernels take any head width up to 256.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from . import lax
from . import mesh as _mesh

__all__ = ["ring_attention", "sequence_parallel_attention",
           "ulysses_attention"]

NEG_INF = -1e30


def ring_attention(q, k, v, axis_name: str, causal: bool = False,
                   use_flash: Optional[bool] = None):
    """Blockwise ring attention inside a shard_map body over
    ``axis_name``: q, k, v are the local shards ``[B, S_local, H, D]``
    (BSHD); returns the local output shard."""
    B, S, H, D = q.shape
    if use_flash is None:
        use_flash = S >= 128 and S % 128 == 0
    if use_flash:
        return _ring_attention_flash(q, k, v, axis_name, causal)
    return _ring_attention_naive(q, k, v, axis_name, causal)


def _ring_attention_naive(q, k, v, axis_name: str, causal: bool = False):
    """The einsum ring (the full local score matrix per step — fine for
    short shards)."""
    n = lax.axis_size(axis_name)
    my = lax.axis_index(axis_name)
    B, S, H, D = q.shape
    scale = 1.0 / math.sqrt(D)
    qt = q.transpose(1, 2).float() * scale
    k_cur, v_cur = k.transpose(1, 2), v.transpose(1, 2)
    acc = torch.zeros_like(qt)
    m = torch.full(qt.shape[:-1], NEG_INF, device=q.device)
    l = torch.zeros(qt.shape[:-1], device=q.device)
    perm = [(i, (i + 1) % n) for i in range(n)]
    rows = torch.arange(S, device=q.device)[:, None]
    cols = torch.arange(S, device=q.device)[None, :]
    for i in range(n):
        src = (my - i) % n          # whose KV shard this step holds
        s = torch.einsum("bhqd,bhkd->bhqk", qt, k_cur.float())
        if causal:
            vis = (my * S + rows) >= (src * S + cols)
            s = torch.where(vis, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.max(dim=-1).values)
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bhkd->bhqd", p,
                                                    v_cur.float())
        m = m_new
        if i < n - 1:
            k_cur = lax.ppermute(k_cur, axis_name, perm)
            v_cur = lax.ppermute(v_cur, axis_name, perm)
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


# --- the flash ring ----------------------------------------------------------

def _bhsd(x):
    return x.transpose(1, 2).contiguous()


def _ones_mask(x):
    B, _, S, _ = x.shape
    return torch.ones((B, S), dtype=torch.float32, device=x.device)


def _chunk_fwd(qt, kt, vt, causal, scale):
    """One (query shard, KV chunk) flash forward: the chunk's normalized
    output (f32) and lse ``[B, H, S]``."""
    from ..ops.flash_attention import _flash_fwd_bhsd

    B, H, S, _ = qt.shape
    o, lse = _flash_fwd_bhsd(qt, kt, vt, _ones_mask(kt), 0, scale, causal,
                             0.0)
    return o.float(), lse.reshape(B, H, S)


def _merge(o, lse, o_i, lse_i):
    """Merge normalized partials in lse space (the kernel's online
    softmax lifted to ring steps)."""
    m = torch.maximum(lse, lse_i)
    w0 = torch.exp(lse - m)
    w1 = torch.exp(lse_i - m)
    den = torch.clamp_min(w0 + w1, 1e-30)
    o = (o * w0[..., None] + o_i * w1[..., None]) / den[..., None]
    return o, m + torch.log(den)


def _visible(causal, step, my, dq_side=True):
    """Under causal masking the chunk a ring step ``step >= 1`` brings is
    wholly visible or wholly hidden: to my queries iff ``step <= my``;
    my KV to the visiting queries iff ``step > my``."""
    if not causal:
        return True
    return step <= my if dq_side else step > my


class _RingFlash(torch.autograd.Function):
    """Every group's flash ring as one node: inputs are every slot's q,
    then k, then v (BSHD); outputs every slot's attention output."""

    @staticmethod
    def forward(ctx, meta, *tensors):
        groups, causal = meta
        N = len(tensors) // 3
        qs, ks, vs = tensors[:N], tensors[N:2 * N], tensors[2 * N:]
        D = qs[0].shape[-1]
        scale = 1.0 / math.sqrt(D)       # the real head width
        qt, kt, vt = ([_bhsd(x) for x in xs] for xs in (qs, ks, vs))
        outs, lses = [None] * N, [None] * N
        for g in groups:
            n = len(g)
            for my, i in enumerate(g):
                dev = qt[i].device
                o, lse = _chunk_fwd(qt[i], kt[i], vt[i], causal, scale)
                for step in range(1, n):
                    if not _visible(causal, step, my):
                        continue
                    src = g[(my - step) % n]
                    o_i, lse_i = _chunk_fwd(qt[i], kt[src].to(dev),
                                            vt[src].to(dev), False, scale)
                    o, lse = _merge(o, lse, o_i, lse_i)
                outs[i] = o.to(qs[i].dtype).transpose(1, 2)
                lses[i] = lse
        ctx.meta = (groups, causal, scale)
        ctx.save_for_backward(*qs, *ks, *vs, *outs, *lses)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gs):
        from ..ops.flash_attention import _flash_dkv_bhsd, _flash_dq_bhsd

        groups, causal, scale = ctx.meta
        saved = ctx.saved_tensors
        N = len(gs)
        qs, ks, vs = saved[:N], saved[N:2 * N], saved[2 * N:3 * N]
        outs, lses = saved[3 * N:4 * N], saved[4 * N:]
        qt, kt, vt, ot = ([_bhsd(x) for x in xs]
                          for xs in (qs, ks, vs, outs))
        dos, deltas, lse3 = [], [], []
        for i in range(N):
            B, H, S, _ = qt[i].shape
            g = gs[i] if gs[i] is not None else torch.zeros_like(outs[i])
            do = _bhsd(g.to(qt[i].dtype))
            dos.append(do)
            deltas.append(torch.sum(do.float() * ot[i].float(),
                                    dim=-1).reshape(B * H, S, 1))
            lse3.append(lses[i].reshape(B * H, S, 1))
        dq, dk, dv = [None] * N, [None] * N, [None] * N
        for g in groups:
            n = len(g)
            for my, i in enumerate(g):
                dev = qt[i].device
                mask = _ones_mask(kt[i])
                # step 0: the diagonal chunk, both directions locally
                acc_q = _flash_dq_bhsd(qt[i], kt[i], vt[i], dos[i], lse3[i],
                                       deltas[i], mask, 0, scale, causal,
                                       0.0).float()
                dk_i, dv_i = _flash_dkv_bhsd(qt[i], kt[i], vt[i], dos[i],
                                             lse3[i], deltas[i], mask, 0,
                                             scale, causal, 0.0)
                acc_k, acc_v = dk_i.float(), dv_i.float()
                for step in range(1, n):
                    # dq: my queries x the visiting KV chunk
                    if _visible(causal, step, my):
                        src = g[(my - step) % n]
                        acc_q = acc_q + _flash_dq_bhsd(
                            qt[i], kt[src].to(dev), vt[src].to(dev), dos[i],
                            lse3[i], deltas[i], mask, 0, scale, False,
                            0.0).float()
                    # dk/dv: the visiting queries x my KV chunk
                    if _visible(causal, step, my, dq_side=False):
                        qm = g[(my - step) % n]
                        dk_s, dv_s = _flash_dkv_bhsd(
                            qt[qm].to(dev), kt[i], vt[i], dos[qm].to(dev),
                            lse3[qm].to(dev), deltas[qm].to(dev), mask, 0,
                            scale, False, 0.0)
                        acc_k = acc_k + dk_s.float()
                        acc_v = acc_v + dv_s.float()
                dq[i] = acc_q.to(qs[i].dtype).transpose(1, 2)
                dk[i] = acc_k.to(ks[i].dtype).transpose(1, 2)
                dv[i] = acc_v.to(vs[i].dtype).transpose(1, 2)
        return (None, *dq, *dk, *dv)


def _ring_attention_flash(q, k, v, axis_name, causal):
    """The flash ring (module docstring): the slots meet once and the
    last to arrive runs every group's ring as one autograd node."""
    mesh = _mesh.current_slot().mesh
    groups = mesh.groups(axis_name)

    def compute(vals):
        qs, ks, vs = zip(*vals)
        return list(_RingFlash.apply((groups, bool(causal)), *qs, *ks,
                                     *vs))

    return _mesh.exchange(("ring_flash", bool(causal)), axis_name,
                          (q, k, v), compute)


def sequence_parallel_attention(q, k, v, mesh=None, axis_name: str = "sp",
                                causal: bool = False):
    """Whole-array entry: q/k/v are global ``[B, S, H, D]``; runs ring
    attention with S sharded over ``axis_name`` of the (global) mesh and
    returns the global output (on the mesh's first slot)."""
    mesh = mesh or _mesh.get_mesh()
    spec = _mesh.PartitionSpec(None, axis_name, None, None)
    fn = _mesh.shard_map(
        lambda a, b, c: ring_attention(a, b, c, axis_name=axis_name,
                                       causal=causal),
        mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec)
    return fn(q, k, v)


def ulysses_attention(q, k, v, axis_name: str = "sp", causal: bool = False,
                      local_attention=None):
    """DeepSpeed-Ulysses style SP: all-to-all scatters heads / gathers
    sequence so each slot runs FULL-sequence attention on H/n heads, then
    all-to-all back.  Inside a shard_map body with S sharded over
    ``axis_name``; q/k/v local ``[B, S_local, H, D]``."""
    def a2a(x, split_axis, concat_axis):
        return lax.all_to_all(x, axis_name, split_axis=split_axis,
                              concat_axis=concat_axis, tiled=True)

    # heads -> slots, gather sequence: [B, S_loc, H, D] -> [B, S, H/n, D]
    qh, kh, vh = a2a(q, 2, 1), a2a(k, 2, 1), a2a(v, 2, 1)
    if local_attention is None:
        from ..ops.attention import _sdpa_core

        o = _sdpa_core(qh.transpose(1, 2), kh.transpose(1, 2),
                       vh.transpose(1, 2), None, 0.0, causal)
        o = o.transpose(1, 2)
    else:
        o = local_attention(qh, kh, vh, causal)
    # sequence -> slots, gather heads back
    return a2a(o, 1, 2)
