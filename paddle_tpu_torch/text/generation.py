"""Incremental (KV-cache) decoding for GPT — twin of
``paddle_tpu/text/generation.py`` for the serving paths, ragged and
split, native and int8.

Two cores, both holding the JAX package's math step for step:

- the dense ring (:func:`make_gpt_decode_step`): one ``[B, max_len, H, D]``
  cache per layer and side, attention masked with ``-1e9`` past each
  lane's position.  :func:`prefill` and :func:`generate` run on
  it; it is the port's own oracle for the serving engine.
- the paged core (:func:`_make_gpt_paged_core`): per-layer page pools
  ``[N, P, H, D]``, every row's K/V scattered into
  ``(page_tables[row, pos // P], pos % P)`` BEFORE attention reads the
  pool.  Under the unified ragged step
  (:func:`make_gpt_paged_ragged_step`) attention goes through
  ``ops.paged_attention.ragged_paged_attention``; under the split
  programs (:func:`make_gpt_paged_decode_step`,
  :func:`make_gpt_paged_prefill_step`,
  :func:`make_gpt_paged_fused_decode_step`,
  :func:`make_gpt_paged_spec_verify_step`) through
  ``ops.paged_attention.paged_attention``, one table row per query row
  — each the CUDA kernel on the card.

Where the JAX package threads pools functionally (and the engine donates
them), the port updates them IN PLACE with ``index_put_`` — a step
mutates the ``kv`` dict it is given and returns the same object.

Quantization (the JAX package's "Quantized serving"):

- ``weight_quant`` maps a parameter name (``layers.0.attn.q_proj.weight``)
  to ``(int8 [K, N], f32 [N])`` as ``slim.export_serving_quant`` makes
  it; matmuls against a quantized name go through
  ``ops.quantized_matmul`` (the CUDA kernel on the card).  Biases,
  LayerNorm and the embeddings stay float.
- ``kv_cache_dtype="int8"`` stores pages (and the dense ring) as int8
  with f32 scales.  Static mode: calibrated per-layer-per-head
  ``kv_scales``; writes clip at ±127 and no scale changes.  Dynamic mode
  (paged core only): per-page ``[N, H]`` scales grow by scatter-max at
  write time and the page's earlier content is requantized under the new
  scale; the engine resets a page's scales when it is (re)allocated.

The mesh-sharded core (:func:`_make_gpt_paged_sharded_core`, reached
through ``mesh_layout=`` a :class:`ServingMeshLayout` of more than one
shard) spans one serving replica over a ``(tp, sp)`` grid of device slots
(``distributed/mesh.py``): q/k/v/fc1 weights split by column over tp,
each pool's heads over tp and its pages over sp.  One process drives
every shard in turn; the collectives are tensor operations over the
shards' outputs.  A sequence shard attends over the pages it owns through
the stats form of the ragged kernel, and the shards merge in lse space.
It serves the ragged layout only.

:func:`generate` decodes greedily or by beam search (``nn/decode.py``)
on the dense ring.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from ..framework.errors import InvalidArgumentError
from ..ops.paged_attention import (paged_attention, ragged_paged_attention,
                                   ragged_paged_attention_stats)
from ..ops.quantized_matmul import quantized_matmul

__all__ = ["make_gpt_decode_step", "make_gpt_paged_decode_step",
           "make_gpt_paged_prefill_step", "make_gpt_paged_fused_decode_step",
           "make_gpt_paged_spec_verify_step", "make_gpt_paged_ragged_step",
           "ServingMeshLayout", "RAGGED_NO_LIMIT", "prefill", "generate"]

# per-row KV-horizon sentinel for the unified ragged step: a decode row
# carries this instead of a real valid_len, making the core's padding
# clamps exact integer identities (min(pos+1, BIG) == pos+1, pos < BIG)
RAGGED_NO_LIMIT = 1 << 30


def _ln(x, w, b, eps=1e-5, dims=(-1,)):
    """LayerNorm over ``dims`` with f32 statistics and population
    variance."""
    xf = x.float()
    m = xf.mean(dim=dims, keepdim=True)
    v = xf.var(dim=dims, keepdim=True, unbiased=False)
    out = (xf - m) * torch.rsqrt(v + eps)
    return (out * w + b).to(x.dtype)


def _gelu(x):
    """Exact GELU, x * Phi(x), in the erfc form of jax.scipy's norm.cdf."""
    return x * (0.5 * torch.special.erfc(-x / math.sqrt(2.0)))


_KV_QMAX = 127.0


def _check_kv_dtype(kv_cache_dtype):
    if kv_cache_dtype not in (None, "int8"):
        raise ValueError(f"kv_cache_dtype must be None or 'int8', got "
                         f"{kv_cache_dtype!r}")
    return kv_cache_dtype == "int8"


def _make_mm(params, weight_quant, device):
    """``mm(x, name)`` computing the JAX package's ``x @ W`` — through
    the weight-only int8 kernel when ``name`` is quantized.  The int8
    weights move to the device here, in their ``[K, N]`` layout; weights
    already on the device (the engine converts them once for all its
    programs) are used as they are."""
    def on_device(t, dtype=None):
        if not isinstance(t, torch.Tensor):
            t = torch.as_tensor(np.asarray(t))
        return t.to(device, dtype)

    wq = {name: (on_device(q), on_device(s, torch.float32))
          for name, (q, s) in (weight_quant or {}).items()}

    def mm(x, name):
        ent = wq.get(name)
        if ent is None:
            return x @ params[name].t()      # nn.Linear stores [out, in]
        return quantized_matmul(x, ent[0], ent[1])

    return mm


def _quant_write_page(pages, scales, page_idx, slot, val, static_scale):
    """Scatter one new [N, H, D] K or V slab into int8 pages, in place.

    ``static_scale`` is the calibrated [H] scale (static mode) or None
    (dynamic mode: grow the written pages' [N, H] scales by abs-max and
    requantize their earlier content under the new scale).  The JAX
    package's operation order (``val / scale``, round half to even,
    clip) is kept, so the int8 bytes match it exactly.  The pages' old
    content and scales are gathered BEFORE any write; duplicate page
    indices (a prefill chunk writing several slots of one page) are safe
    because the scale update is a scatter-max that includes the old value
    and every duplicate writes identical rescaled content."""
    valf = val.float()
    if static_scale is not None:
        q = torch.clamp(torch.round(valf / static_scale[None, :, None]),
                        -_KV_QMAX, _KV_QMAX).to(torch.int8)
        pages[page_idx, slot] = q
        return pages, scales
    amax = valf.abs().amax(dim=-1)                           # [N, H]
    # the floor as a scalar operand: a tensor made from a Python float
    # would be a host-to-device copy (a sync, and not capturable)
    cand = torch.clamp_min(amax / _KV_QMAX, 1e-8)
    s_old = scales[page_idx]                                 # [N, H]
    old = pages[page_idx].float()                            # [N, P, H, D]
    scales.scatter_reduce_(0, page_idx[:, None].expand_as(cand), cand,
                           "amax", include_self=True)
    s_new = scales[page_idx]
    resc = torch.round(old * (s_old / s_new)[:, None, :, None])
    pages[page_idx] = resc.to(torch.int8)
    q = torch.clamp(torch.round(valf / s_new[:, :, None]),
                    -_KV_QMAX, _KV_QMAX).to(torch.int8)
    pages[page_idx, slot] = q
    return pages, scales


def _as_layer_scales(kv_scales, L, H, device):
    """Normalize a slim kv-scale export ({"k": [L x [H]], "v": ...}) to
    per-layer f32 tensors; None stays None (dynamic mode)."""
    if kv_scales is None:
        return None, None
    out = []
    for side in ("k", "v"):
        arrs = [np.asarray(kv_scales[side][i], np.float32) for i in range(L)]
        for arr in arrs:
            if arr.shape != (H,):
                raise ValueError(
                    f"kv_scales entries must be [{H}] per layer, got "
                    f"{arr.shape}")
        out.append([torch.as_tensor(a, device=device) for a in arrs])
    return out[0], out[1]


class _Weights:
    """Detached parameters plus the JAX package's ``x @ W`` product
    (``nn.Linear`` stores ``W`` as ``[out, in]``), through the int8
    kernel for the names in ``weight_quant``.

    ``params``/``heads`` (a shard of the mesh core): the shard's own
    parameters, its q/k/v/fc1 cut to ``heads`` of the model's heads."""

    def __init__(self, model, weight_quant=None, *, params=None, heads=None):
        self.p: Dict[str, torch.Tensor] = params if params is not None else {
            n: t.detach() for n, t in model.named_parameters()}
        self.L = len(model.layers)
        H = model.layers[0].attn.num_heads
        self.hidden = self.p["wte.weight"].shape[1]
        self.D = self.hidden // H
        self.H = heads or H
        self.wte = self.p["wte.weight"]
        self.wpe = self.p["wpe.weight"]
        self.mm = _make_mm(self.p, weight_quant, self.wte.device)

    def lp(self, i, name):
        return self.p[f"layers.{i}.{name}"]

    def attn_out(self, i, x, ctx):
        """Output projection and residual of layer ``i``."""
        return x + (self.mm(ctx, f"layers.{i}.attn.out_proj.weight")
                    + self.lp(i, "attn.out_proj.bias"))

    def ffn_in(self, i, x):
        """LayerNorm, fc1 and GELU of layer ``i``'s MLP."""
        h2 = _ln(x, self.lp(i, "ln2.weight"), self.lp(i, "ln2.bias"))
        return _gelu(self.mm(h2, f"layers.{i}.fc1.weight")
                     + self.lp(i, "fc1.bias"))

    def ffn_out(self, i, x, ff):
        """fc2 and residual of layer ``i``'s MLP."""
        return x + self.mm(ff, f"layers.{i}.fc2.weight") \
            + self.lp(i, "fc2.bias")

    def block_tail(self, i, x, ctx):
        """Output projection, residual and MLP of layer ``i`` (the JAX
        step's exact association order)."""
        x = self.attn_out(i, x, ctx)
        return self.ffn_out(i, x, self.ffn_in(i, x))

    def qkv(self, i, x, N):
        h = _ln(x, self.lp(i, "ln1.weight"), self.lp(i, "ln1.bias"))
        return tuple(
            (self.mm(h, f"layers.{i}.attn.{s}_proj.weight")
             + self.lp(i, f"attn.{s}_proj.bias")).reshape(N, self.H, self.D)
            for s in ("q", "k", "v"))

    def head(self, x):
        x = _ln(x, self.p["ln_f.weight"], self.p["ln_f.bias"])
        return x @ self.wte.t()                              # tied head


def make_gpt_decode_step(model, max_len: int, *, kv_cache_dtype=None,
                         kv_scales=None, weight_quant=None):
    """Build ``(step_fn, init_state)`` for a GPTModel.

    ``step_fn(tokens [N], state) -> (logits [N, vocab], state)`` — one
    decode position per call.  The state is ``{"k": [L x [N, max_len, H,
    D]], "v": [...], "pos": [N] int32}``; the caches are updated in
    place.

    ``kv_cache_dtype="int8"`` stores the ring as int8 with the calibrated
    per-layer-per-head ``kv_scales`` (required: the dense ring has no
    per-page scale state, so only the static mode applies) — the same
    write-time quantization as the paged serving path, so greedy tokens
    match the quantized engine's.  ``weight_quant`` routes the
    projection/MLP matmuls through the weight-only int8 kernel."""
    quant_kv = _check_kv_dtype(kv_cache_dtype)
    if quant_kv and kv_scales is None:
        raise ValueError("the dense decode cache supports int8 only with "
                         "calibrated kv_scales (slim.export_serving_quant)")
    w = _Weights(model, weight_quant)
    L, H, D = w.L, w.H, w.D
    scale = 1.0 / np.sqrt(D)
    device = w.wte.device
    k_sc, v_sc = _as_layer_scales(kv_scales, L, H, device)

    def init_state(batch: int):
        def z():
            return torch.zeros((batch, max_len, H, D),
                               dtype=torch.int8 if quant_kv else w.wte.dtype,
                               device=device)

        return {"k": [z() for _ in range(L)], "v": [z() for _ in range(L)],
                "pos": torch.zeros((batch,), dtype=torch.int32,
                                   device=device)}

    def _store(val, sc):
        """Cache-dtype conversion of one new [N, H, D] slab."""
        if not quant_kv:
            return val
        return torch.clamp(torch.round(val.float() / sc[None, :, None]),
                           -_KV_QMAX, _KV_QMAX).to(torch.int8)

    def _load(cache, sc):
        if not quant_kv:
            return cache
        return cache.float() * sc[None, None, :, None]

    @torch.no_grad()
    def step_fn(tokens, state):
        pos = state["pos"].long()                             # [N]
        N = tokens.shape[0]
        x = w.wte[tokens.long()] + w.wpe[pos]                 # [N, hidden]
        rows = torch.arange(N, device=device)
        valid = (torch.arange(max_len, device=device)[None, :]
                 <= pos[:, None])[:, None, :]                 # [N, 1, S]
        for i in range(L):
            q, k1, v1 = w.qkv(i, x, N)
            kc, vc = state["k"][i], state["v"][i]
            kc[rows, pos] = _store(k1, k_sc[i] if quant_kv else None)
            vc[rows, pos] = _store(v1, v_sc[i] if quant_kv else None)
            kc = _load(kc, k_sc[i] if quant_kv else None)
            vc = _load(vc, v_sc[i] if quant_kv else None)
            # attend over the cache's valid prefix (<= pos)
            logits = torch.einsum("nhd,nshd->nhs", q, kc) * scale
            logits = torch.where(valid, logits,
                                 torch.full_like(logits, -1e9))
            probs = torch.softmax(logits, dim=-1)
            ctx = torch.einsum("nhs,nshd->nhd", probs, vc).reshape(
                N, w.hidden)
            x = w.block_tail(i, x, ctx)
        return w.head(x), {"k": state["k"], "v": state["v"],
                           "pos": state["pos"] + 1}

    return step_fn, init_state


def _make_gpt_paged_core(model, page_size: int, pages_per_seq: int, *,
                         kv_cache_dtype=None, kv_scales=None,
                         weight_quant=None, mesh_layout=None):
    """Paged-KV transformer core behind the serving step builders (the
    single-device branch of the JAX package's core).

    Returns ``(core, init_pages)``; ``core(tokens [N], pos [N],
    page_tables, kv, valid_len=None, with_head=True, qgroup=None)`` runs
    one forward over N query rows.  Row n's new k/v is scattered into
    page ``table(n)[pos // P]`` slot ``pos % P`` of every layer's pool,
    then attention over positions ``< pos + 1`` of that table reads the
    pool — a prefill chunk therefore gets causal masking within itself.
    Two layouts of ``page_tables``:

    - ``qgroup=None`` (the split programs): ``[N, M]``, one table row per
      query row, attention through ``paged_attention`` (the per-row
      kernel).  A prefill chunk passes its sequence's row broadcast N
      times.
    - ``qgroup=Q`` (the ragged step): ``[G, M]`` with G = N // Q lanes of
      Q rows, each lane with ONE table row, attention through
      ``ragged_paged_attention`` (each lane's pages read once for all its
      rows).

    ``valid_len`` (a scalar, or one per row) masks padding: rows with
    ``pos >= valid_len`` write to the trash page 0 and attend to
    ``min(pos + 1, valid_len)`` positions.  ``with_head=False`` skips the
    logits product (prefill discards logits).

    ``kv_cache_dtype="int8"``: ``init_pages`` adds ``k_scale``/``v_scale``
    lists of ``[N, H]`` f32 per layer — the calibrated scale broadcast per
    page (static ``kv_scales``, never mutated) or ``KV_SCALE_EPS`` grown
    by the writes (dynamic).  ``weight_quant`` routes every projection and
    MLP matmul through the weight-only int8 kernel.

    ``mesh_layout`` (a :class:`ServingMeshLayout` of more than one shard)
    swaps in :func:`_make_gpt_paged_sharded_core`: the same contract over
    the layout's device slots."""
    if mesh_layout is not None and mesh_layout.size > 1:
        return _make_gpt_paged_sharded_core(
            model, page_size, pages_per_seq, mesh_layout,
            kv_cache_dtype=kv_cache_dtype, kv_scales=kv_scales,
            weight_quant=weight_quant)
    quant_kv = _check_kv_dtype(kv_cache_dtype)
    w = _Weights(model, weight_quant)
    L, H, D = w.L, w.H, w.D
    max_pos = w.wpe.shape[0]
    device = w.wte.device
    k_sc, v_sc = _as_layer_scales(kv_scales, L, H, device)

    def init_pages(num_pages: int):
        # one distinct buffer per layer and side (each is updated in
        # place by every step)
        def z():
            return torch.zeros((num_pages, page_size, H, D),
                               dtype=torch.int8 if quant_kv else w.wte.dtype,
                               device=device)

        kv = {"k": [z() for _ in range(L)], "v": [z() for _ in range(L)]}
        if quant_kv:
            from ..serving.kv_cache import KV_SCALE_EPS

            def sc(static):
                if static is None:
                    return torch.full((num_pages, H), KV_SCALE_EPS,
                                      dtype=torch.float32, device=device)
                return static[None, :].expand(num_pages, H).clone()

            kv["k_scale"] = [sc(k_sc[i] if k_sc else None) for i in range(L)]
            kv["v_scale"] = [sc(v_sc[i] if v_sc else None) for i in range(L)]
        return kv

    @torch.no_grad()
    def core(tokens, pos, page_tables, kv, valid_len=None, with_head=True,
             qgroup=None):
        N = tokens.shape[0]
        pos = pos.long()
        # the scatter addresses rows; ragged attention takes one table row
        # per lane (the kernel reads each lane's pages once for all its
        # rows)
        row_tables = page_tables.long()
        if qgroup is not None:
            row_tables = torch.repeat_interleave(row_tables, qgroup, dim=0)
        # clamp junk rows (bucket padding) instead of relying on gather
        # clipping: their output is discarded
        pos_c = torch.clamp(pos, max=max_pos - 1)
        x = w.wte[tokens.long()] + w.wpe[pos_c]
        page_of = torch.clamp(pos // page_size, max=pages_per_seq - 1)
        page_idx = torch.gather(row_tables, 1, page_of[:, None])[:, 0]
        slot = pos % page_size
        seq_lens = pos + 1
        if valid_len is not None:
            vl = torch.as_tensor(valid_len, device=device).long()
            # padded rows write to the trash page and attend to nothing
            # past the real prompt — live pages stay untouched
            page_idx = torch.where(pos < vl, page_idx,
                                   torch.zeros_like(page_idx))
            seq_lens = torch.minimum(seq_lens, vl)
        seq_lens = seq_lens.to(torch.int32)
        for i in range(L):
            q, k1, v1 = w.qkv(i, x, N)
            kc, vc = kv["k"][i], kv["v"][i]
            # scatter BEFORE the attention read.  Duplicate (page, slot)
            # pairs only ever come from padded rows and land on the trash
            # page 0; index_put_ on CUDA leaves their order unspecified,
            # which is harmless because page 0 is never read unmasked.
            if quant_kv:
                _quant_write_page(kc, kv["k_scale"][i], page_idx, slot, k1,
                                  k_sc[i] if k_sc else None)
                _quant_write_page(vc, kv["v_scale"][i], page_idx, slot, v1,
                                  v_sc[i] if v_sc else None)
                scales = (kv["k_scale"][i], kv["v_scale"][i])
            else:
                kc[page_idx, slot] = k1
                vc[page_idx, slot] = v1
                scales = ()
            if qgroup is None:
                ctx = paged_attention(q, kc, vc, page_tables, seq_lens,
                                      *scales).reshape(N, w.hidden)
            else:
                G = N // qgroup
                ctx = ragged_paged_attention(
                    q.reshape(G, qgroup, H, D), kc, vc, page_tables,
                    seq_lens.reshape(G, qgroup), *scales).reshape(N, w.hidden)
            x = w.block_tail(i, x, ctx)
        if not with_head:
            return None, kv
        return w.head(x), kv

    return core, init_pages


# ---------------------------------------------------------------------------
# the mesh-sharded serving replica
# ---------------------------------------------------------------------------

# parameter-name fragments whose weights split by column over tp (output
# dim = heads * head_dim for q/k/v, ffn for fc1); everything else is
# replicated
_TP_COLUMN_SHARDED = (".attn.q_proj.", ".attn.k_proj.", ".attn.v_proj.",
                      ".fc1.")


@dataclass(frozen=True)
class ServingMeshLayout:
    """Sharding layout of one mesh-sized serving replica: ``tp`` head
    shards times ``sp`` page shards, ``size == tp * sp`` device slots.

    In place of the JAX package's PartitionSpecs it cuts full tensors
    into a shard's part: :meth:`shard_param` and :meth:`shard_weight_quant`
    by parameter name, :meth:`shard_pool` a page pool ``[N, P, H, D]``
    (pages over sp, heads over tp: the shard holds ``[N/sp, P, H/tp, D]``)
    or its scale rows ``[N, H]`` (``[N/sp, H/tp]``)."""

    tp: int = 1
    sp: int = 1
    tp_axis: str = "tp"
    sp_axis: str = "sp"
    data_axis: str = "data"

    def __post_init__(self):
        if int(self.tp) < 1 or int(self.sp) < 1:
            raise ValueError(
                f"mesh degrees must be >= 1, got tp={self.tp} sp={self.sp}")

    @property
    def size(self) -> int:
        return int(self.tp) * int(self.sp)

    def axes(self):
        """Named axis sizes for ``distributed.mesh.init_mesh``."""
        return {self.tp_axis: int(self.tp), self.sp_axis: int(self.sp),
                self.data_axis: 1}

    def reserved_pages(self, num_pages: int):
        """Global page ids reserved as per-shard trash rows: shard s's
        local row 0 is global page ``s * (num_pages // sp)`` — non-owned
        and masked-lane scatters land there, so it never holds live KV.
        ``(0,)`` (the classic trash page) at sp == 1."""
        per = int(num_pages) // int(self.sp)
        return tuple(s * per for s in range(int(self.sp)))

    def column_sharded(self, name: str) -> bool:
        return any(frag in name for frag in _TP_COLUMN_SHARDED)

    def shard_param(self, name: str, value: torch.Tensor, t: int):
        """Tensor-shard ``t``'s part of parameter ``name`` in the port's
        layout: a column-sharded Linear weight ``[out, in]`` keeps its
        ``t``-th block of output rows (the JAX ``[in, out]`` weight's
        columns), its bias the same block; the rest is replicated."""
        if self.tp == 1 or not self.column_sharded(name):
            return value
        n = value.shape[0] // self.tp
        return value[t * n:(t + 1) * n]

    def shard_weight_quant(self, name: str, qweight, scale, t: int):
        """Tensor-shard ``t``'s part of an int8 weight ``[K, N]`` and its
        ``[N]`` scale (the export's layout): the scale is cut with its
        columns."""
        q = torch.as_tensor(np.asarray(qweight)) \
            if not isinstance(qweight, torch.Tensor) else qweight
        sc = torch.as_tensor(np.asarray(scale, np.float32)) \
            if not isinstance(scale, torch.Tensor) else scale
        if self.tp == 1 or not self.column_sharded(name):
            return q, sc
        n = q.shape[1] // self.tp
        return q[:, t * n:(t + 1) * n].contiguous(), sc[t * n:(t + 1) * n]

    def shard_pool(self, pool: torch.Tensor, t: int, s: int):
        """Shard ``(t, s)``'s part of a page pool ``[N, P, H, D]`` or of
        its scale rows ``[N, H]``."""
        per = pool.shape[0] // self.sp
        hd = 2 if pool.dim() == 4 else 1
        h = pool.shape[hd] // self.tp
        idx = [slice(s * per, (s + 1) * per)] + [slice(None)] * (hd - 1) \
            + [slice(t * h, (t + 1) * h)]
        return pool[tuple(idx)]

    def assemble_pool(self, shards):
        """The global pool from the shards' parts (shard ``t * sp + s``):
        pages concatenated over sp, then heads over tp."""
        hd = 2 if shards[0].dim() == 4 else 1
        dev = shards[0].device
        cols = [torch.cat([shards[t * self.sp + s].to(dev)
                           for s in range(self.sp)], dim=0)
                for t in range(self.tp)]
        return torch.cat(cols, dim=hd)


def _make_gpt_paged_sharded_core(model, page_size: int, pages_per_seq: int,
                                 layout: ServingMeshLayout, *,
                                 kv_cache_dtype=None, kv_scales=None,
                                 weight_quant=None):
    """Mesh-sharded twin of ``_make_gpt_paged_core``: the same ``(core,
    init_pages)`` contract over the layout's ``(tp, sp)`` device slots
    (``distributed.mesh.init_mesh(layout.axes())``).

    Shard ``(t, s)`` — index ``t * sp + s`` of the per-shard lists — holds
    tensor shard t of the weights (q/k/v/fc1 by column, int8 scales with
    their columns, the rest replicated) and the pools' part ``[N/sp, P,
    H/tp, D]``.  ``init_pages(num_pages)`` returns the list of per-shard
    pool dicts; ``core`` updates them in place and returns the same list.
    One call runs every shard in turn, layer by layer, in the JAX
    program's order:

    - every row's K/V scatters into its shard's pool before any read; a
      global page id maps to (owner s, local row ``id % (N/sp)``), and a
      row whose page another shard owns scatters into the shard's local
      row 0 (a reserved page, never read);
    - at sp == 1 the ragged kernel runs on the shard's heads; at sp > 1
      its stats form over the owned pages, then the lse merge across sp:
      ``M = pmax(lse); w = exp(lse - M); ctx = psum(o w) / max(psum(w),
      1e-30)``;
    - at tp > 1 a tiled all-gather of the context and of the fc1
      activations; out_proj and fc2 run on the full width.

    The replicated work (embedding, out_proj, fc2, the head) runs once
    per shard, as on each chip of a mesh.  Serves the ragged layout only
    (``qgroup`` required)."""
    from ..distributed import mesh as mesh_lib

    quant_kv = _check_kv_dtype(kv_cache_dtype)
    full = _Weights(model)
    L, H, D = full.L, full.H, full.D
    max_pos = full.wpe.shape[0]
    tp, sp = int(layout.tp), int(layout.sp)
    if H % tp:
        raise ValueError(f"num_heads ({H}) must be divisible by tp ({tp})")
    H_loc = H // tp
    device = full.wte.device
    k_sc, v_sc = _as_layer_scales(kv_scales, L, H, device)
    mesh = mesh_lib.init_mesh(layout.axes(), device_type=device.type)
    shards = [(t, s, mesh.slot(**{layout.tp_axis: t, layout.sp_axis: s}))
              for t in range(tp) for s in range(sp)]

    # one weight set per (tensor shard, device): the sp shards of a tensor
    # shard that share a device share its weights
    weights = {}
    for t, _s, dev in shards:
        if (t, dev) in weights:
            continue
        params = {n: layout.shard_param(n, p, t).to(dev)
                  for n, p in full.p.items()}
        wq = None
        if weight_quant:
            wq = {n: tuple(a.to(dev) for a in layout.shard_weight_quant(
                n, qv, sv, t)) for n, (qv, sv) in weight_quant.items()}
        weights[t, dev] = _Weights(model, wq, params=params, heads=H_loc)
    shard_w = [weights[t, dev] for t, _s, dev in shards]

    def static_rows(scales, t, dev):
        return [sc[t * H_loc:(t + 1) * H_loc].to(dev) for sc in scales]

    shard_ksc = shard_vsc = None
    if k_sc is not None:
        shard_ksc = [static_rows(k_sc, t, dev) for t, _s, dev in shards]
        shard_vsc = [static_rows(v_sc, t, dev) for t, _s, dev in shards]

    def init_pages(num_pages: int):
        if num_pages % sp:
            raise ValueError(
                f"num_pages ({num_pages}) must be divisible by sp ({sp})")
        per = num_pages // sp
        kvs = []
        for j, (t, _s, dev) in enumerate(shards):
            def z():
                return torch.zeros((per, page_size, H_loc, D),
                                   dtype=torch.int8 if quant_kv
                                   else full.wte.dtype, device=dev)

            kv = {"k": [z() for _ in range(L)], "v": [z() for _ in range(L)]}
            if quant_kv:
                from ..serving.kv_cache import KV_SCALE_EPS

                def sc(static):
                    if static is None:
                        return torch.full((per, H_loc), KV_SCALE_EPS,
                                          dtype=torch.float32, device=dev)
                    return static[None, :].expand(per, H_loc).clone()

                for side, rows in (("k", shard_ksc), ("v", shard_vsc)):
                    kv[f"{side}_scale"] = [
                        sc(rows[j][i] if rows else None) for i in range(L)]
            kvs.append(kv)
        return kvs

    @torch.no_grad()
    def core(tokens, pos, page_tables, kv, valid_len=None, with_head=True,
             qgroup=None):
        if qgroup is None:
            raise NotImplementedError(
                "the mesh-sharded paged core serves the unified ragged "
                "layout only (the mesh engine runs ragged=True)")
        Q = int(qgroup)
        N = tokens.shape[0]
        G = N // Q
        per = kv[0]["k"][0].shape[0]
        pos = pos.long()
        tables = page_tables.long()
        row_tables = torch.repeat_interleave(tables, Q, dim=0)
        pos_c = torch.clamp(pos, max=max_pos - 1)
        page_of = torch.clamp(pos // page_size, max=pages_per_seq - 1)
        page_idx = torch.gather(row_tables, 1, page_of[:, None])[:, 0]
        slot = pos % page_size
        seq_lens = pos + 1
        if valid_len is not None:
            vl = torch.as_tensor(valid_len, device=pos.device).long()
            page_idx = torch.where(pos < vl, page_idx,
                                   torch.zeros_like(page_idx))
            seq_lens = torch.minimum(seq_lens, vl)
        seq_lens = seq_lens.to(torch.int32).reshape(G, Q)
        # the replicated inputs, on every slot (one copy per device), and
        # each sequence shard's view of the pages: global ids -> local rows
        # of the shard that owns them, row 0 where another shard does
        inputs = {}
        for t, s, dev in shards:
            if (s, dev) in inputs:
                continue
            owner = (page_idx // per) == s
            pt_owner = (tables // per) == s
            inputs[s, dev] = dict(
                tok=tokens.long().to(dev), pos_c=pos_c.to(dev),
                slot=slot.to(dev), sl=seq_lens.to(dev),
                local=torch.where(owner, page_idx % per,
                                  torch.zeros_like(page_idx)).to(dev),
                pt_local=torch.where(pt_owner, tables % per,
                                     torch.zeros_like(tables)).to(dev),
                pt_owner=pt_owner.to(dev))
        ins = [inputs[s, dev] for _t, s, dev in shards]
        xs = [w.wte[a["tok"]] + w.wpe[a["pos_c"]]
              for w, a in zip(shard_w, ins)]
        for i in range(L):
            ctx, lse = [], []
            for j, (w, a, pools) in enumerate(zip(shard_w, ins, kv)):
                q, k1, v1 = w.qkv(i, xs[j], N)
                kc, vc = pools["k"][i], pools["v"][i]
                # scatter BEFORE the attention read (duplicate writes land
                # only on local row 0, which is never read)
                if quant_kv:
                    _quant_write_page(kc, pools["k_scale"][i], a["local"],
                                      a["slot"], k1,
                                      shard_ksc[j][i] if shard_ksc else None)
                    _quant_write_page(vc, pools["v_scale"][i], a["local"],
                                      a["slot"], v1,
                                      shard_vsc[j][i] if shard_vsc else None)
                    scales = (pools["k_scale"][i], pools["v_scale"][i])
                else:
                    kc[a["local"], a["slot"]] = k1
                    vc[a["local"], a["slot"]] = v1
                    scales = ()
                if sp > 1 and not kc.is_cuda:
                    _clear_trash_row(kc, vc, scales, shard_ksc, shard_vsc,
                                     j, i)
                qg = q.reshape(G, Q, H_loc, D)
                if sp == 1:
                    ctx.append(ragged_paged_attention(
                        qg, kc, vc, a["pt_local"], a["sl"], *scales))
                else:
                    o, l_ = ragged_paged_attention_stats(
                        qg, kc, vc, a["pt_local"], a["sl"], a["pt_owner"],
                        *scales)
                    ctx.append(o)
                    lse.append(l_)
            if sp > 1:
                # the partial-softmax exchange across the sequence shards
                # of each tensor shard, in lse space
                for t in range(tp):
                    grp = range(t * sp, (t + 1) * sp)
                    mx = mesh_lib.pmax([lse[j] for j in grp])
                    wts = [torch.exp(lse[j] - m) for j, m in zip(grp, mx)]
                    num = mesh_lib.psum([ctx[j] * wj[..., None]
                                         for j, wj in zip(grp, wts)])
                    den = mesh_lib.psum(wts)
                    for j, nu, de in zip(grp, num, den):
                        ctx[j] = nu / torch.clamp(de, min=1e-30)[..., None]
            ctx = [c.reshape(N, H_loc * D) for c in ctx]
            if tp > 1:
                ctx = _gather_tp(ctx, tp, sp)
            xs = [w.attn_out(i, x, c) for w, x, c in zip(shard_w, xs, ctx)]
            ff = [w.ffn_in(i, x) for w, x in zip(shard_w, xs)]
            if tp > 1:
                ff = _gather_tp(ff, tp, sp)
            xs = [w.ffn_out(i, x, f) for w, x, f in zip(shard_w, xs, ff)]
        if not with_head:
            return None, kv
        logits = [w.head(x) for w, x in zip(shard_w, xs)]
        return logits[0].to(device), kv

    return core, init_pages


def _clear_trash_row(kc, vc, scales, shard_ksc, shard_vsc, j: int, i: int):
    """Reset a shard's local row 0 after a layer's scatters, before its
    read.  Other shards' rows land there, and the plain stats version
    multiplies every non-owned table entry (all pointing at row 0) by a
    zero probability: a NaN K/V row written by one lane would otherwise
    turn every lane of the shard NaN.  The row is junk by definition, so
    no finite result changes.  Under int8 the row's scales go back to
    the calibrated row (static) or the eps floor (dynamic, as the
    engine's ``_reset_page_scales``).  The CUDA kernel never reads a
    page its shard does not own, so only the plain route needs this."""
    kc[0] = 0
    vc[0] = 0
    if scales:
        from ..serving.kv_cache import KV_SCALE_EPS

        for sc, static in zip(scales, (shard_ksc, shard_vsc)):
            if static is None:
                sc[0] = KV_SCALE_EPS
            else:
                sc[0] = static[j][i]


def _gather_tp(parts, tp: int, sp: int):
    """The tiled all-gather over tp of per-shard ``[N, n]`` activations
    (shard ``t * sp + s``), along the feature axis."""
    from ..distributed.mesh import all_gather

    out = list(parts)
    for s in range(sp):
        grp = [t * sp + s for t in range(tp)]
        for j, g in zip(grp, all_gather([parts[j] for j in grp], dim=1)):
            out[j] = g
    return out


def make_gpt_paged_decode_step(model, page_size: int, pages_per_seq: int, *,
                               kv_cache_dtype=None, kv_scales=None,
                               weight_quant=None):
    """The split decode step: ``step_fn(tokens [B], pos [B], page_tables
    [B, M], kv) -> (logits [B, V], kv)`` — one position per row, row b's
    k/v scattered into ``page_tables[b, pos // P]`` slot ``pos % P`` and
    attention over its pages masked to ``pos + 1``.  ``init_pages
    (num_pages)`` builds the pools.  Inactive rows (pos 0, all-trash
    table) scatter into the trash page and are never attended to.
    ``kv_cache_dtype``/``kv_scales``/``weight_quant`` as for the core."""
    core, init_pages = _make_gpt_paged_core(
        model, page_size, pages_per_seq, kv_cache_dtype=kv_cache_dtype,
        kv_scales=kv_scales, weight_quant=weight_quant)

    def step_fn(tokens, pos, page_tables, kv):
        return core(tokens, pos, page_tables, kv)

    return step_fn, init_pages


def make_gpt_paged_prefill_step(model, page_size: int, pages_per_seq: int, *,
                                kv_cache_dtype=None, kv_scales=None,
                                weight_quant=None):
    """Chunked parallel prefill: ``chunk_fn(tokens [C], positions [C],
    page_table_row [M], valid_len, kv) -> kv`` teacher-forces one chunk
    of a sequence.  All C k/v pairs are scattered first, then every
    position attends over the sequence's pages with ``seq_lens = pos +
    1`` (causal within the chunk and over earlier chunks) — the table row
    is broadcast to C rows, so the per-row kernel reads the sequence's
    pages once per row.  ``valid_len`` (a scalar) masks bucket padding:
    positions at or past it write the trash page.  No logits head."""
    core, init_pages = _make_gpt_paged_core(
        model, page_size, pages_per_seq, kv_cache_dtype=kv_cache_dtype,
        kv_scales=kv_scales, weight_quant=weight_quant)

    def chunk_fn(tokens, positions, page_table_row, valid_len, kv):
        C = tokens.shape[0]
        tables = page_table_row[None, :].expand(C, page_table_row.shape[0])
        _, kv = core(tokens, positions, tables, kv, valid_len=valid_len,
                     with_head=False)
        return kv

    return chunk_fn, init_pages


def _guard_pack(nxt, logits, with_guard: bool):
    """The numeric guard's in-band verdict: a row whose logits are not
    all finite comes back as ``-1 - tok``."""
    if not with_guard:
        return nxt
    return torch.where(torch.isfinite(logits).all(dim=-1), nxt, -1 - nxt)


def make_gpt_paged_fused_decode_step(model, page_size: int,
                                     pages_per_seq: int, num_steps: int, *,
                                     kv_cache_dtype=None, kv_scales=None,
                                     weight_quant=None,
                                     with_guard: bool = False):
    """Fused K-step greedy decode: ``fused_fn(tokens [B], pos [B],
    page_tables [B, M], kv) -> (out [K, B], tokens' [B], pos' [B], kv)``
    runs K = ``num_steps`` single-position core calls, the argmax fed
    back on the device, every row of ``out`` filled on the device (no
    host sync inside) — the stream equals K single steps.  The caller
    must have reserved pages covering ``pos + K`` for every live row.
    ``with_guard=True`` negative-packs a non-finite row (``-1 - tok``)
    in ``out``; the clean argmax still feeds back."""
    if num_steps < 1:
        raise ValueError("num_steps must be >= 1")
    core, init_pages = _make_gpt_paged_core(
        model, page_size, pages_per_seq, kv_cache_dtype=kv_cache_dtype,
        kv_scales=kv_scales, weight_quant=weight_quant)
    K = int(num_steps)

    @torch.no_grad()
    def fused_fn(tokens, pos, page_tables, kv):
        out = torch.empty((K, tokens.shape[0]), dtype=torch.int32,
                          device=tokens.device)
        tok, p = tokens, pos
        for j in range(K):
            logits, kv = core(tok, p, page_tables, kv)
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
            out[j] = _guard_pack(nxt, logits, with_guard)
            tok, p = nxt, p + 1
        return out, tok, p, kv

    return fused_fn, init_pages


def make_gpt_paged_spec_verify_step(model, page_size: int,
                                    pages_per_seq: int, num_steps: int, *,
                                    sequential: bool = False,
                                    kv_cache_dtype=None, kv_scales=None,
                                    weight_quant=None,
                                    with_guard: bool = False):
    """Speculative-decoding verifier: ``verify_fn(tokens [K, B], pos [B],
    page_tables [B, M], kv) -> (out [K, B], kv)`` teacher-forces
    ``tokens[j]`` at position ``pos + j`` of every row and returns the
    greedy argmax at each (``serving/spec_decode.py`` owns the accept
    rule).  K/V for all K positions is written into the rows' pages;
    positions past the accepted prefix hold junk that ``seq_lens`` masks
    until the next real write overwrites it.

    ``sequential=False`` runs ONE forward over B·K rows (tables repeated
    K times); ``sequential=True`` runs K single-position core calls, the
    schedule int8_dynamic KV needs (per-page scale growth must replay
    the plain decode loop's progressive quantization).
    ``with_guard=True`` negative-packs non-finite positions in ``out``."""
    if num_steps < 2:
        raise ValueError("num_steps must be >= 2 (1 is plain decode)")
    core, init_pages = _make_gpt_paged_core(
        model, page_size, pages_per_seq, kv_cache_dtype=kv_cache_dtype,
        kv_scales=kv_scales, weight_quant=weight_quant)
    K = int(num_steps)

    @torch.no_grad()
    def verify_fn(tokens, pos, page_tables, kv):
        B = pos.shape[0]
        if sequential:
            out = torch.empty((K, B), dtype=torch.int32, device=pos.device)
            for j in range(K):
                logits, kv = core(tokens[j], pos + j, page_tables, kv)
                nxt = torch.argmax(logits, dim=-1).to(torch.int32)
                out[j] = _guard_pack(nxt, logits, with_guard)
            return out, kv
        # row (b, j) consumes tokens[j, b] at position pos[b] + j against
        # row b's table; all K slabs scatter before any attention reads
        toks = tokens.t().reshape(-1)
        posf = (pos[:, None] + torch.arange(K, dtype=pos.dtype,
                                            device=pos.device)).reshape(-1)
        tables = torch.repeat_interleave(page_tables, K, dim=0)
        logits, kv = core(toks, posf, tables, kv)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        out = _guard_pack(nxt, logits, with_guard)
        return out.reshape(B, K).t().contiguous(), kv

    return verify_fn, init_pages


def make_gpt_paged_ragged_step(model, page_size: int, pages_per_seq: int, *,
                               kv_cache_dtype=None, kv_scales=None,
                               weight_quant=None, with_guard: bool = False,
                               mesh_layout=None):
    """Unified ragged step: ONE forward carries a mixed batch of
    steady-decode and chunked-prefill lanes, each lane a group of Q query
    rows against its single page-table row.

    ``ragged_fn(state_tok [B], state_pos [B], page_tables [B, M],
    rows_tok [B, Q], rows_pos [B, Q], row_valid [B, Q], advance [B], kv)
    -> (out_rows [B, Q], out_dec [B], state_tok' [B], state_pos' [B],
    kv)``.

    - ``advance[b] > 0`` — a DECODE lane: row 0's token/position come from
      the device-resident ``state_tok``/``state_pos`` and the lane's
      state advances to (argmax, pos + 1).
    - ``advance[b] == 0`` — a PREFILL-CHUNK lane: rows carry host-provided
      (token, position, valid_len) triples; device state is untouched.
    - junk rows carry ``row_valid == 0``: they scatter into the trash
      page and attend to nothing.

    ``with_guard=True`` packs a row whose logits are not all finite as
    ``-1 - tok``; the clean argmax still feeds the device state."""
    core, init_pages = _make_gpt_paged_core(
        model, page_size, pages_per_seq, kv_cache_dtype=kv_cache_dtype,
        kv_scales=kv_scales, weight_quant=weight_quant,
        mesh_layout=mesh_layout)

    @torch.no_grad()
    def ragged_fn(state_tok, state_pos, page_tables, rows_tok, rows_pos,
                  row_valid, advance, kv):
        B, Q = rows_tok.shape
        live = advance > 0
        eff_tok = rows_tok.clone()
        eff_tok[:, 0] = torch.where(live, state_tok, rows_tok[:, 0])
        eff_pos = rows_pos.clone()
        eff_pos[:, 0] = torch.where(live, state_pos, rows_pos[:, 0])
        logits, kv = core(eff_tok.reshape(-1), eff_pos.reshape(-1),
                          page_tables, kv, valid_len=row_valid.reshape(-1),
                          qgroup=Q)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        out = _guard_pack(nxt, logits, with_guard).reshape(B, Q)
        clean0 = nxt.reshape(B, Q)[:, 0]
        new_tok = torch.where(live, clean0, state_tok)
        new_pos = torch.where(live, state_pos + 1, state_pos)
        return out, out[:, 0], new_tok, new_pos, kv

    return ragged_fn, init_pages


@torch.no_grad()
def prefill(step_fn, state, prompt):
    """Feed the prompt [B, P] through the cache one position at a time
    (teacher forced); returns (state_after_prompt, logits_of_last
    position [B, V])."""
    logits = None
    for t in range(prompt.shape[1]):
        logits, state = step_fn(prompt[:, t], state)
    return state, logits


@torch.no_grad()
def generate(model, input_ids, max_new_tokens: int = 32, end_id: int = 0,
             decode_strategy: str = "greedy", num_beams: int = 4,
             length_penalty: float = 0.0, quant=None):
    """GPT generation on the model's device, greedy or by beam search.

    ``input_ids`` [B, P] (numpy or tensor).  Greedy returns ``(ids [B, T]
    int32, scores [B])``; ``decode_strategy="beam_search"`` returns
    ``(ids [B, K, T] int32, scores [B, K])`` for ``num_beams`` K, best
    first, ranked under ``length_penalty``.  T = max_new_tokens; a lane
    or beam that emits ``end_id`` keeps emitting it.  Beam search
    prefills each prompt once, then repeats its state to the K lanes.

    ``quant``: an export from ``slim.export_serving_quant`` (of either
    package) — decodes with the int8 KV cache and/or weight-only int8
    matmuls it describes; int8 KV here needs the export's calibrated
    ``kv_scales``.  This is the reference stream of the quantized
    serving engine.  Spans: ``text.generation`` with its
    ``text.generation/prefill`` and ``text.generation/decode``
    children."""
    from ..nn.decode import beam_search_decode, greedy_search_decode, tree_map
    from ..utils.profiler import RecordEvent

    if decode_strategy not in ("greedy", "beam_search"):
        raise ValueError(
            f"decode_strategy must be 'greedy' or 'beam_search', "
            f"got {decode_strategy!r}")
    device = model.device
    if isinstance(input_ids, torch.Tensor):
        ids = input_ids.to(device=device, dtype=torch.int32)
    else:
        ids = torch.as_tensor(np.asarray(input_ids, np.int32), device=device)
    B, P = ids.shape
    max_pos = model.wpe.weight.shape[0]
    if P + max_new_tokens > max_pos:
        # past the wpe table the gather would clamp positions — degraded
        # text with no error
        raise InvalidArgumentError(
            f"prompt ({P}) + max_new_tokens ({max_new_tokens}) exceeds "
            f"the model's max_seq_len ({max_pos})")
    qkw = {}
    if quant is not None:
        if quant.get("kv_cache_dtype") == "int8":
            qkw.update(kv_cache_dtype="int8",
                       kv_scales=quant.get("kv_scales"))
        if quant.get("weight_dtype") == "int8":
            qkw.update(weight_quant=quant.get("weights"))
    step_fn, init_state = make_gpt_decode_step(
        model, P + max_new_tokens + 1, **qkw)
    beam = decode_strategy == "beam_search"
    K = int(num_beams)
    span = dict(strategy=decode_strategy, batch=B, prompt_len=P)
    if beam:
        span["num_beams"] = K
    with RecordEvent("text.generation", **span):
        state = init_state(B)
        # prefill all but the last prompt token; the decode loop's first
        # step consumes the last one and emits new token #1
        if P > 1:
            with RecordEvent("text.generation/prefill"):
                state, _ = prefill(step_fn, state, ids[:, :-1])
        if not beam:
            with RecordEvent("text.generation/decode"):
                return greedy_search_decode(step_fn, state, batch_size=B,
                                            max_len=max_new_tokens,
                                            bos_id=ids[:, -1], end_id=end_id)
        # each lane its own copy of its prompt's caches: the step writes
        # them in place
        state = tree_map(lambda s: torch.repeat_interleave(s, K, dim=0),
                         state)
        with RecordEvent("text.generation/decode"):
            res = beam_search_decode(
                step_fn, state, batch_size=B, beam_size=K,
                max_len=max_new_tokens, bos_id=ids[:, -1:].expand(B, K),
                end_id=end_id, length_penalty=length_penalty)
        return res.ids, res.scores
