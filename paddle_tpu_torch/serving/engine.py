"""ServingEngine — continuous batching over a paged KV cache (twin of
``paddle_tpu/serving/engine.py``).

``add_request`` enqueues, ``step`` runs one scheduler iteration,
``drain`` steps until idle.  Two dispatch modes:

- **ragged** (the default): every step issues ONE mixed dispatch
  (``text.generation.make_gpt_paged_ragged_step``) — steady-decode rows
  of every running lane plus one prefill CHUNK per lane that is still
  working through its prompt, so decode ticks never stall behind a long
  prompt.  Attention runs the ragged kernel on the card.
- **split** (``ragged=False``, forced by ``fused_steps > 1``): admission
  teacher-forces the prompt through the prefill program in chunks
  (``make_gpt_paged_prefill_step``), then each step dispatches the decode
  program (``make_gpt_paged_decode_step``) — or, with ``fused_steps=K``,
  no admission waiting and K tokens of budget left on every lane, the
  fused program (``make_gpt_paged_fused_decode_step``) that advances
  every lane K positions in one dispatch.  Attention runs the per-row
  kernel on the card.

**Speculative decoding** (``spec_decode=K``): a host-side n-gram drafter
(``serving/spec_decode.py``) proposes up to K-1 tokens per lane, and one
dispatch teacher-forces them; the accept rule keeps the stream exactly
the greedy one.  A split engine verifies through the split verify
program (``make_gpt_paged_spec_verify_step``); a ragged engine folds the
verify rows into the ragged step — except under int8_dynamic KV, which
keeps the split SEQUENTIAL verifier and rolls rejected drafts back
(restore the touched pages, replay the accepted tokens one at a time).

Execution model
---------------
- **Device-resident state**: tokens, positions and page tables live on
  the device between steps and the decode programs advance them (argmax
  feedback, pos + 1).  Host events touch only deltas, written in place:
  an admission writes one lane (token, pos, table row),
  retirement/preemption zeroes one lane, page growth re-uploads one table
  row.  Steady decode uploads nothing.
- **KV pools** ``[N, P, H, D]`` per layer and side are updated IN PLACE
  by each dispatch (the JAX engine donates them to its jitted programs
  instead).  The engine writes them only in place too (page puts, scale
  resets, quarantine scrubs), never replacing a pool tensor.
- **Programs** (``profiler/jit_cost.py``): the ragged step, the split
  decode and the fused decode programs run through ``profiled_graph``
  under the JAX engine's names (``serving.ragged_step``,
  ``serving.decode``, ``serving.decode_fused``).  On the card each input
  signature — lane bucket, rows per lane — is captured into one CUDA
  graph at its first call (which runs eagerly) and replayed after that;
  the pools are donated, i.e. captured by address.  Every signature
  counts one compile in ``compile_ledger``, on the CPU too
  (``stats()["jit_costs"]``).  The lane state keeps its flow: the device
  tensors the engine holds (a replay's static outputs, or tensors a
  bucket change rebuilds) are copied into the graph's static inputs on
  the next call, and every read of a static output (the host copy of a
  dispatch's tokens) is enqueued on the stream before the next replay.
  The split prefill and verify programs run eagerly (they sync by
  design), and so does a mesh whose slots span several cards.
- **Dispatch-ahead**: one step stays in flight.  Each dispatch enqueues a
  non-blocking device-to-host copy of its tokens into pinned memory and
  records an event; ``step`` dispatches step N and only then waits on
  step N-1's event, so host scheduling overlaps device compute.  EOS and
  budget retirement lag one step (the lagged lane decodes junk into its
  still-allocated pages — dropped on the host).  ``sync_mode=True``
  consumes every dispatch immediately; the token streams are identical
  in every mode, and equal to ``text.generation.generate`` (greedy).
- The lane batch is padded to a pow2 bucket; inactive lanes carry pos 0
  and an all-trash page table, so no per-lane branching exists on the
  device.
- **Numeric guards**: a lane whose logits come back non-finite is packed
  ``-1 - tok`` in-band; the request is quarantined (failed, pages
  scrubbed and freed, surfaced through ``take_faulted``) within the
  step that consumed it.
- **Mesh-sharded replica** (``mesh_axes={"tp": T, "sp": S}``): one
  engine spans T x S device slots (``distributed/mesh.py``) — q/k/v/fc1
  weights and the pools' heads split over tp, the pools' pages over sp
  (the allocator reserves one trash page per sp shard).  The host side
  (scheduler, page tables, lane state) is unchanged: one logical
  replica.  Ragged dispatch only; ``tp = sp = 1`` is the single-device
  engine.
- **Prefix cache** (``prefix_cache=True``, ``serving/prefix_cache.py``):
  admission maps a prompt's longest resident full-page prefix into its
  page table, the chunked prefill starts at the first uncached token,
  and a full-prompt match copies its last page on the device before the
  first decode write (copy-on-write, in place in the pools).  Sealed
  pages that a prefill plan has not written yet are ``unwritten``: a
  lane reading one idles (``row_valid`` 0, ``advance`` 0) until the
  chunk that writes it was issued by an earlier dispatch.  int8_dynamic
  KV runs uncached (``stats()["prefix_cache"]["bypass_reason"]``).
- **Tiered KV** (``kv_tiering``, ``serving/kv_transport.py``): with the
  prefix cache on, an evicted cached page demotes to a host-RAM tier
  (spilling to a disk tier) and a later prompt with that prefix promotes
  it back into a free page, in place in the pools.  Both happen only at
  admission; an eviction during decode discards.
- **Spans**: ``serving/step`` with its ``serving/ragged_step`` (or the
  split ``serving/decode_step``, ``serving/prefill`` /
  ``serving/prefill_chunk``) and ``serving/spec_verify`` children, as
  ``utils.profiler.RecordEvent``s (host code; ``torch.profiler`` ranges
  only while it records).
- **Snapshots** (``snapshot`` / ``restore``, ``serving/resilience.py``):
  one running request's consumed tokens and KV pages, restored
  mid-stream on another engine of the same configuration (any mesh
  shape); int8_dynamic pages travel dequantized and are requantized.
- **Several engines, several threads** (the frontend's replicas, one
  pump thread each): an engine is driven by one thread at a time.
  ``step``, ``abort``, ``snapshot`` and ``restore`` hold
  ``profiler.jit_cost.capture_gate`` shared, and a graph capture holds
  it exclusively, so no engine touches the card while another captures.
- **Int8 serving** (``kv_cache_dtype="int8"``, ``weight_dtype="int8"``):
  int8 pages with ``[N, H]`` f32 scale rows per layer and side, and
  int8 projection/MLP weights.  ``quant_scales`` (an export of either
  package's ``slim.export_serving_quant``) supplies calibrated KV scales
  (static mode) and the int8 weights; without KV scales the pages run
  dynamic per-page scales, reset whenever a page is (re)allocated, and
  without weights they are quantized here, data-free.
"""
from __future__ import annotations

import functools
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..framework.errors import (AlreadyExistsError, InternalError,
                                InvalidArgumentError)
from ..ops.paged_attention import MAX_HEAD_DIM, PAGED_ROUTE_STATS
from ..ops.quantized_matmul import QMM_ROUTE_STATS
from ..profiler.jit_cost import capture_gate, cost_registry, profiled_graph
from ..profiler.flight_recorder import (EV_ADMITTED, EV_FIRST_TOKEN,
                                        EV_PREFILL_CHUNK, EV_PREFIX_HIT,
                                        EV_SPECULATED)
from ..profiler.flight_recorder import recorder as flight
from ..testing.chaos import chaos_site
from ..text.generation import (RAGGED_NO_LIMIT, ServingMeshLayout,
                               _guard_pack, make_gpt_paged_decode_step,
                               make_gpt_paged_fused_decode_step,
                               make_gpt_paged_prefill_step,
                               make_gpt_paged_ragged_step,
                               make_gpt_paged_spec_verify_step)
from ..utils.bucketing import chunk_schedule, smallest_bucket
from ..utils.profiler import RecordEvent
from .kv_cache import (KV_SCALE_EPS, PagedKVCache, dequantize_kv_page,
                       quantize_kv_page)
from .metrics import ServingMetrics
from .kv_transport import PageTransport
from .prefix_cache import PrefixCache
from .resilience import EngineSnapshot
from .scheduler import Request, Scheduler, Sequence
from .spec_decode import SpecDecoder

__all__ = ["ServingEngine", "create_serving_engine"]


def _split_decode(step_fn, numeric_guards: bool):
    """The split decode program over ``make_gpt_paged_decode_step``'s
    step: ``decode(tokens, pos, page_tables, kv) -> ((clean, packed),
    pos + 1, kv)``.  It advances its own state — the clean argmax feeds
    back as the next input token — and ``packed`` is the copy the host
    consumes, with the numeric guard's verdict in-band (a non-finite row
    comes back ``-1 - tok``)."""
    def decode(tokens, pos, page_tables, kv):
        logits, kv = step_fn(tokens, pos, page_tables, kv)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        return (nxt, _guard_pack(nxt, logits, numeric_guards)), pos + 1, kv

    return decode


def _gated(method):
    """Run an engine method that works on the device inside the
    process's ``capture_gate`` (shared): several engines step side by
    side, and all of them pause while any one captures a graph."""
    @functools.wraps(method)
    def run(self, *args, **kwargs):
        with capture_gate.shared():
            return method(self, *args, **kwargs)

    return run


class _Pending:
    """One in-flight dispatch: the host copy of its decode tokens, the
    event that marks the copy done (None on the CPU), the number of
    positions it advanced every lane (K for a fused dispatch) and the
    lane binding (seq, epoch) it was dispatched against — the epoch drops
    results a preemption has since invalidated."""

    __slots__ = ("tokens", "event", "steps", "lanes")

    def __init__(self, tokens, event, steps: int,
                 lanes: Tuple[Optional[Tuple[Sequence, int]], ...]):
        self.tokens = tokens        # [B] or [steps, B] int32 host tensor
        self.event = event
        self.steps = steps
        self.lanes = lanes


class ServingEngine:
    """Continuous-batching serving over a paged KV cache."""

    def __init__(self, model, *, page_size: int = 16,
                 num_pages: Optional[int] = None,
                 max_batch_size: int = 8,
                 max_seq_len: Optional[int] = None,
                 bucket_sizes: Optional[List[int]] = None,
                 eos_id: int = 0,
                 metrics: Optional[ServingMetrics] = None,
                 prefill_chunk: int = 64,
                 sync_mode: bool = False,
                 fused_steps: int = 1,
                 ragged: Optional[bool] = None,
                 mesh_axes: Optional[dict] = None,
                 kv_cache_dtype: Optional[str] = None,
                 weight_dtype: Optional[str] = None,
                 quant_scales: Optional[dict] = None,
                 prefix_cache: bool = False,
                 kv_tiering=False,
                 spec_decode=False,
                 spec_drafter=None,
                 numeric_guards: bool = True,
                 token_callback: Optional[Callable[[str, int, int],
                                                   None]] = None,
                 device=None):
        # --- knob validation --------------------------------------------
        for d, knob in ((kv_cache_dtype, "kv_cache_dtype"),
                        (weight_dtype, "weight_dtype")):
            if d not in (None, "int8"):
                # no silent degradation: the pools/weights stay in the
                # model's native dtype unless int8 is asked for
                raise InvalidArgumentError(
                    f"{knob} must be None or 'int8', got {d!r}")
        if quant_scales is not None and kv_cache_dtype is None \
                and weight_dtype is None:
            # an export without the knobs would silently run native
            raise InvalidArgumentError(
                "quant_scales was provided but kv_cache_dtype and "
                "weight_dtype are both unset — pass kv_cache_dtype='int8' "
                "and/or weight_dtype='int8' to activate the quantized path")
        if not isinstance(prefix_cache, bool):
            raise InvalidArgumentError(
                f"prefix_cache must be a bool, got {prefix_cache!r}")
        if not isinstance(kv_tiering, (bool, dict)):
            raise InvalidArgumentError(
                f"kv_tiering must be a bool or a dict of tier options "
                f"(host_pages/disk_dir/disk_pages), got {kv_tiering!r}")
        if kv_tiering and not prefix_cache:
            # a truthy option must not silently do nothing
            raise InvalidArgumentError(
                "kv_tiering was provided but prefix_cache is off — the "
                "tiers extend the radix index (pass prefix_cache=True)")
        if not isinstance(numeric_guards, bool):
            raise InvalidArgumentError(
                f"numeric_guards must be a bool, got {numeric_guards!r}")
        # ragged (one mixed dispatch per step) is the default; the fused
        # K-step loop is a split-program variant
        self.fused_steps = max(1, int(fused_steps))
        if ragged is None:
            ragged = self.fused_steps == 1
        if not isinstance(ragged, bool):
            raise InvalidArgumentError(
                f"ragged must be a bool, got {ragged!r}")
        if ragged and self.fused_steps > 1:
            raise InvalidArgumentError(
                "ragged=True is incompatible with fused_steps > 1 — the "
                "fused K-step loop is a split-program variant; pass "
                "ragged=False (or drop fused_steps)")
        # speculative decoding: True = the default horizon K of 4, an int
        # the K-token verify horizon
        if not isinstance(spec_decode, (bool, int)):
            raise InvalidArgumentError(
                f"spec_decode must be a bool or an int K-token verify "
                f"horizon, got {spec_decode!r}")
        if isinstance(spec_decode, bool):
            spec_k = 4 if spec_decode else 0
        else:
            spec_k = int(spec_decode)
            if spec_k < 2:
                raise InvalidArgumentError(
                    f"spec_decode={spec_k} — the int form is the "
                    "K-token verify horizon and must be >= 2 (K=1 is "
                    "plain decode; pass False to disable)")
        if spec_drafter is not None and not spec_k:
            raise InvalidArgumentError(
                "spec_drafter was provided but spec_decode is off — "
                "pass spec_decode=True (or an int horizon) to enable "
                "speculative decoding")

        self.device = resolve_device(device)
        if model.device != self.device:
            raise InvalidArgumentError(
                f"model weights are on {model.device} but the engine runs "
                f"on {self.device} — build the model with the same device")
        head_dim = int(model.wte.weight.shape[1]) // int(
            model.layers[0].attn.num_heads)
        if self.device.type == "cuda" and head_dim > MAX_HEAD_DIM:
            # the paged kernels' widest head; a CUDA tensor has no plain
            # fallback, so refuse here rather than on the first step
            raise InvalidArgumentError(
                f"head_dim {head_dim} > {MAX_HEAD_DIM} is not supported by "
                f"the paged attention kernels on the card")
        self._mesh_layout = self._check_mesh_axes(mesh_axes, model)
        self.model = model
        self.page_size = int(page_size)
        model_max = int(model.wpe.weight.shape[0])
        self.max_seq_len = int(max_seq_len) if max_seq_len else model_max
        if self.max_seq_len > model_max:
            raise InvalidArgumentError(
                f"max_seq_len ({self.max_seq_len}) exceeds the model's "
                f"position table ({model_max})")
        self.pages_per_seq = -(-self.max_seq_len // self.page_size)
        layout = self._mesh_layout
        if num_pages is None:
            # roomy default: every slot can hold a full-length sequence
            num_pages = max_batch_size * self.pages_per_seq + 1
            if layout is not None:
                # the pool must split evenly across sequence shards
                num_pages += (-num_pages) % layout.sp
        elif layout is not None and int(num_pages) % layout.sp:
            raise InvalidArgumentError(
                f"num_pages ({num_pages}) must be divisible by mesh sp "
                f"({layout.sp}) — the page pool splits evenly across "
                "sequence shards")
        num_pages = int(num_pages)
        self.cache = PagedKVCache(
            num_pages, self.page_size, self.pages_per_seq,
            reserved_pages=((0,) if layout is None
                            else layout.reserved_pages(num_pages)))
        self.scheduler = Scheduler(self.cache, max_batch_size,
                                   bucket_sizes=bucket_sizes)
        self.metrics = metrics or ServingMetrics()
        self.eos_id = int(eos_id)
        self.prefill_chunk = max(1, int(prefill_chunk))
        self.sync_mode = bool(sync_mode)
        self.ragged = ragged
        if layout is not None and not ragged:
            raise InvalidArgumentError(
                "mesh_axes requires the unified ragged dispatch — the "
                "sharded core serves only the ragged layout; drop "
                "ragged=False (and fused_steps)")
        self.numeric_guards = numeric_guards
        self.outputs: Dict[str, np.ndarray] = {}
        self._ttft_recorded = set()      # per REQUEST, preemption-proof
        # streaming hook: (request_id, index, token) for every consumed
        # token in emission order; after a recompute-preemption the replay
        # re-emits indices from 0 (consumers keep forward progress only)
        self.token_callback = token_callback
        self._expired: List[str] = []
        self._faulted: List[str] = []
        # sequences flagged mid-consume, quarantined at the end of the
        # step (after the pipeline is collapsed)
        self._quarantine_pending: List[Sequence] = []
        # chaos key for the "engine.step" site
        self.chaos_key: Optional[str] = None

        # --- int8 serving ---------------------------------------------
        self.kv_cache_dtype = kv_cache_dtype
        self.weight_dtype = weight_dtype
        qs = quant_scales or {}
        kv_scales = qs.get("kv_scales") if kv_cache_dtype == "int8" else None
        # calibrated static rows, kept for the quarantine scrub (a
        # poisoned static row is healed by restoring these values)
        self._static_kv_scales = kv_scales
        # dynamic per-page scales reset when pages are (re)allocated, so
        # results never depend on page-reuse history
        self._kv_dynamic = kv_cache_dtype == "int8" and kv_scales is None
        weight_quant = None
        if weight_dtype == "int8":
            weight_quant = qs.get("weights")
            if weight_quant is None:
                from ..slim.serving_export import quantize_gpt_weights

                weight_quant = quantize_gpt_weights(model)
            # ONE device copy shared by every program below
            weight_quant = {
                name: (torch.as_tensor(np.asarray(q), device=self.device),
                       torch.as_tensor(np.asarray(sc, np.float32),
                                       device=self.device))
                for name, (q, sc) in weight_quant.items()}
        self._weight_quant = weight_quant

        # --- speculative decoding ---------------------------------------
        if spec_k and layout is not None and self._kv_dynamic:
            # int8_dynamic speculation verifies through the split
            # sequential program, which the sharded core does not serve
            raise InvalidArgumentError(
                "mesh_axes with spec_decode requires native or int8_static "
                "KV — the int8_dynamic sequential verifier is a split "
                "program the mesh-sharded core does not serve")
        self.spec = None
        if spec_k:
            self.spec = SpecDecoder(spec_k, drafter=spec_drafter,
                                    metrics=self.metrics,
                                    sequential=self._kv_dynamic)

        # --- prefix cache -------------------------------------------------
        # int8_dynamic bypasses the index: a reader's per-page scale growth
        # would requantize shared content under every other reader
        self.prefix_cache: Optional[PrefixCache] = None
        self._prefix_bypass_reason: Optional[str] = None
        if prefix_cache:
            if self._kv_dynamic:
                self._prefix_bypass_reason = (
                    "int8_dynamic KV: per-page scales are device state "
                    "grown by the writer — shared pages require "
                    "int8_static or native KV (docs/SERVING.md)")
            else:
                self.prefix_cache = PrefixCache(self.cache,
                                                metrics=self.metrics)
                self.scheduler.prefix_cache = self.prefix_cache

        # --- tiered KV transport ------------------------------------------
        # evicted prefix pages demote to a host-RAM tier (spilling to a
        # CRC'd disk tier) instead of being discarded, and tier hits come
        # back with one in-place page write.  False | True (the host tier
        # at its default capacity) | dict(host_pages=, disk_dir=,
        # disk_pages=); int8_dynamic bypasses the index, and with it the
        # tiers
        self.kv_transport: Optional[PageTransport] = None
        if kv_tiering and self.prefix_cache is not None:
            opts = dict(kv_tiering) if isinstance(kv_tiering, dict) else {}
            unknown = set(opts) - {"host_pages", "disk_dir", "disk_pages"}
            if unknown:
                raise InvalidArgumentError(
                    f"unknown kv_tiering option(s) {sorted(unknown)}; "
                    "expected host_pages/disk_dir/disk_pages")
            disk_store = None
            if opts.get("disk_dir"):
                from ..io.checkpoint import CheckpointStore

                disk_store = CheckpointStore(str(opts["disk_dir"]))
            self.kv_transport = PageTransport(
                self._tier_gather, self._tier_restore,
                host_pages=int(opts.get("host_pages", 64)),
                disk_store=disk_store,
                disk_pages=int(opts.get("disk_pages", 0)),
                metrics=self.metrics)
            self.prefix_cache.attach_transport(self.kv_transport)

        # --- the programs over the shared weights ------------------------
        qkw = dict(kv_cache_dtype=kv_cache_dtype, kv_scales=kv_scales,
                   weight_quant=weight_quant)
        geometry = (model, self.page_size, self.pages_per_seq)
        # one CUDA graph per signature on the card, unless a mesh's slots
        # span several cards (one graph cannot span devices)
        self.cuda_graphs = (self.device.type == "cuda"
                            and len(set(self._slot_devices())) == 1)

        def program(name, fn, pools_at):
            return profiled_graph(name, fn, donate_argnums=(pools_at,),
                                  capture=self.cuda_graphs)

        ragged_fn, init_pages = make_gpt_paged_ragged_step(
            *geometry, with_guard=self.numeric_guards, mesh_layout=layout,
            **qkw)
        self._ragged_fn = program("serving.ragged_step", ragged_fn, 7)
        # the pools: one dict of per-layer tensors, or on a mesh one such
        # dict per shard (shard t * sp + s)
        self._kv = init_pages(num_pages)
        self._decode_fn = self._prefill_fn = self._fused_fn = None
        if layout is not None:
            self.metrics.on_shard_config(tp=layout.tp, sp=layout.sp,
                                         devices=layout.size)
        else:
            # the split decode and prefill programs (the prefill one also
            # replays accepted tokens after an int8_dynamic spec rollback,
            # and stays eager); a mesh engine runs the ragged step alone
            self._decode_fn = program("serving.decode", _split_decode(
                make_gpt_paged_decode_step(*geometry, **qkw)[0],
                self.numeric_guards), 3)
            self._prefill_fn, _ = make_gpt_paged_prefill_step(*geometry,
                                                              **qkw)
        if self.fused_steps > 1:
            self._fused_fn = program(
                "serving.decode_fused", make_gpt_paged_fused_decode_step(
                    *geometry, self.fused_steps,
                    with_guard=self.numeric_guards, **qkw)[0], 3)
        # a ragged engine folds spec verify into the ragged step (a verify
        # lane IS a ragged-query lane) — except int8_dynamic, which keeps
        # the split SEQUENTIAL verifier: its rollback replays progressive
        # per-page scale growth, which one ragged forward cannot
        self._spec_fn = None
        if self.spec is not None and not (self.ragged
                                          and not self._kv_dynamic):
            self._spec_fn, _ = make_gpt_paged_spec_verify_step(
                *geometry, spec_k, sequential=self._kv_dynamic,
                with_guard=self.numeric_guards, **qkw)
        # dispatches per program (one forward of the core each, K for the
        # fused and the sequential verify programs)
        self.program_calls = {"ragged_step": 0, "decode": 0,
                              "decode_fused": 0, "prefill": 0,
                              "spec_verify": 0}

        # device-resident lane state (grown/rebuilt lazily)
        self._tokens: Optional[torch.Tensor] = None    # [bucket] int32
        self._pos: Optional[torch.Tensor] = None       # [bucket] int32
        self._tables: Optional[torch.Tensor] = None    # [bucket, M] int32
        self._state_bucket = 0
        self._lanes: List[Optional[Sequence]] = []
        self._pending: Deque[_Pending] = deque()
        self._last_dispatch: Optional[float] = None
        # page count per seq_id as last uploaded to the device table —
        # growth must re-upload the row before the next dispatch, or
        # writes past the stale row land in the trash page
        self._uploaded_pages: Dict[str, int] = {}
        # per-request prefill plans: the chunk queue admission builds;
        # each step pops one chunk per planned lane into the dispatch
        self._prefill_plans: Dict[str, dict] = {}
        # per-bucket cached steady-decode row inputs (uploaded once)
        self._ragged_steady: Dict[int, tuple] = {}

    def _check_mesh_axes(self, mesh_axes, model) -> Optional[
            ServingMeshLayout]:
        """Validate ``mesh_axes``; the layout of a mesh of more than one
        slot, or None (``tp = sp = 1`` is the single-device engine)."""
        if mesh_axes is None:
            return None
        if not isinstance(mesh_axes, dict):
            raise InvalidArgumentError(
                f"mesh_axes must be a dict of axis degrees (tp=/sp=), got "
                f"{mesh_axes!r}")
        unknown = set(mesh_axes) - {"tp", "sp"}
        if unknown:
            raise InvalidArgumentError(
                f"unknown mesh_axes key(s) {sorted(unknown)}; expected tp "
                "(head sharding) / sp (sequence sharding)")
        try:
            tp = int(mesh_axes.get("tp", 1))
            sp = int(mesh_axes.get("sp", 1))
        except (TypeError, ValueError):
            raise InvalidArgumentError(
                f"mesh_axes degrees must be ints, got {mesh_axes!r}")
        if tp < 1 or sp < 1:
            raise InvalidArgumentError(
                f"mesh_axes degrees must be >= 1, got tp={tp} sp={sp}")
        if tp * sp == 1:
            return None
        heads = int(model.layers[0].attn.num_heads)
        if heads % tp:
            raise InvalidArgumentError(
                f"mesh_axes tp={tp} must divide the model's num_heads "
                f"({heads})")
        from ..distributed.mesh import devices

        n_dev = len(devices(self.device.type))
        if tp * sp > n_dev:
            raise InvalidArgumentError(
                f"mesh_axes needs tp*sp = {tp * sp} devices but only "
                f"{n_dev} are available")
        return ServingMeshLayout(tp=tp, sp=sp)

    def _slot_devices(self) -> List[torch.device]:
        """The devices the programs run on: the engine's, or on a mesh
        its slots (``distributed.mesh.devices``, as the sharded core
        places its shards)."""
        if self._mesh_layout is None:
            return [self.device]
        from ..distributed.mesh import devices

        return devices(self.device.type)[:self._mesh_layout.size]

    # --- host <-> device ----------------------------------------------------
    def _dput(self, x) -> torch.Tensor:
        """Host->device upload of engine state.  On the card it stages
        through pinned memory with a non-blocking copy, so an upload
        never waits for the dispatch in flight."""
        t = torch.from_numpy(np.ascontiguousarray(x))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.clone()

    def _to_host(self, t: torch.Tensor):
        """Start the device->host copy of a dispatch's tokens: (host
        tensor, event to wait on — None when already on the host)."""
        if self.device.type != "cuda":
            # a copy: the decode programs' outputs may alias the lane
            # state that later in-place lane writes change
            return t.clone(), None
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return host, event

    # --- request intake ---------------------------------------------------
    def check_request(self, prompt, max_new_tokens: int = 32) -> np.ndarray:
        """Validate a prospective request against this engine's static
        limits WITHOUT enqueuing it; returns the int32 prompt."""
        if isinstance(prompt, torch.Tensor):
            prompt = prompt.detach().cpu().numpy()
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            raise InvalidArgumentError("empty prompt")
        if max_new_tokens < 1:
            raise InvalidArgumentError("max_new_tokens must be >= 1")
        if prompt.size + max_new_tokens > self.max_seq_len:
            raise InvalidArgumentError(
                f"prompt ({prompt.size}) + max_new_tokens "
                f"({max_new_tokens}) exceeds max_seq_len "
                f"({self.max_seq_len})")
        # a request that could never fit even running alone would sit in
        # the queue forever (nothing to preempt) — reject loudly
        need = self.cache.pages_needed(prompt.size + max_new_tokens - 1)
        cap = min(self.cache.allocatable_pages, self.pages_per_seq)
        if need > cap:
            raise InvalidArgumentError(
                f"request needs {need} KV pages (prompt {prompt.size} + "
                f"{max_new_tokens} new tokens @ page_size "
                f"{self.page_size}) but the cache caps a sequence at "
                f"{cap} pages — raise num_pages or lower max_new_tokens")
        return prompt

    def add_request(self, prompt, max_new_tokens: int = 32,
                    request_id: Optional[str] = None,
                    deadline: Optional[float] = None,
                    prefix_cache: bool = True) -> str:
        """Enqueue a generation request; returns its id.  ``deadline`` is
        an ABSOLUTE ``time.monotonic()`` instant: once passed, the request
        is dropped from the queue or aborted mid-decode, and its id
        surfaces through ``take_expired()``.  ``prefix_cache=False`` opts
        this request out of the engine's prefix cache (no index lookup,
        its pages are never sealed); a no-op without a prefix cache."""
        prompt = self.check_request(prompt, max_new_tokens)
        if not isinstance(prefix_cache, bool):
            raise InvalidArgumentError(
                f"prefix_cache must be a bool, got {prefix_cache!r}")
        req = Request(prompt=prompt, max_new_tokens=int(max_new_tokens),
                      request_id=request_id or "", deadline=deadline,
                      use_prefix_cache=prefix_cache)
        self._check_not_live(req.request_id)
        self.scheduler.add(req)
        return req.request_id

    def _check_not_live(self, request_id: str):
        # a duplicate id would alias two live sequences onto one page
        # table — reject it
        live = (request_id in self.outputs
                or any(r.request_id == request_id
                       for r in self.scheduler.waiting)
                or any(s.seq_id == request_id
                       for s in self.scheduler.running))
        if live:
            raise AlreadyExistsError(
                f"request_id {request_id!r} is already in flight or "
                "has an unconsumed output")

    # --- abort ------------------------------------------------------------
    @_gated
    def abort(self, request_id: str) -> bool:
        """Retire a queued or in-flight sequence NOW: no output, pages and
        lane freed.  The pipeline is collapsed first so survivors' streams
        are unchanged.  Returns False when the id is unknown or already
        finished."""
        sched = self.scheduler
        for req in sched.waiting:
            if req.request_id == request_id:
                sched.waiting.remove(req)
                self._forget(request_id)
                self.metrics.on_abort()
                return True
        seq = next((s for s in sched.running if s.seq_id == request_id),
                   None)
        if seq is None:
            return False
        self._sync_pending()
        if seq.done or seq not in sched.running:
            return False
        page_ids = self.cache.seq_page_ids(seq.seq_id)
        sched.finish(seq)
        seq.done = True
        seq.epoch += 1
        self._reset_page_scales(page_ids)
        self._forget(request_id)
        self._release_lane(seq)
        self.metrics.on_abort()
        return True

    def _forget(self, request_id: str):
        """Drop per-request bookkeeping (abort, expiry, quarantine): a
        plan cut short un-publishes its never-written sealed pages and
        recomputes the sharers waiting on them."""
        self._ttft_recorded.discard(request_id)
        self._uploaded_pages.pop(request_id, None)
        stale = self._drop_plan(request_id)
        if stale:
            self._preempt_plan_sharers(stale)
        if self.spec is not None:
            self.spec.on_drop(request_id)

    def _release_lane(self, seq: Sequence):
        for i, lane_seq in enumerate(self._lanes):
            if lane_seq is seq:
                self._lanes[i] = None
                self._clear_lane(i)

    def take_expired(self) -> List[str]:
        """Request ids whose deadline expired since the last call."""
        out, self._expired = self._expired, []
        return out

    # --- numeric quarantine -----------------------------------------------
    def take_faulted(self) -> List[str]:
        """Request ids quarantined by the numeric guard since the last
        call (non-finite logits: failed, lane reset, pages scrubbed and
        freed).  Each id appears once, never in ``outputs``."""
        out, self._faulted = self._faulted, []
        return out

    # --- page maintenance over the pools (sharded or not) ------------------
    def _pool_dicts(self) -> List[dict]:
        """Every pool dict: the engine's, or each mesh shard's."""
        return self._kv if self._mesh_layout is not None else [self._kv]

    def _page_shards(self, page_ids):
        """Where global pages live: ``(pools, local rows, positions in
        page_ids, head slice)`` for each pool dict holding some of them —
        the engine's own (every id, every head), or on a mesh each shard
        (t, s) with the ids of sequence shard s as its local rows and
        tensor shard t's heads."""
        ids = np.asarray(page_ids, np.int64).reshape(-1)
        if self._mesh_layout is None:
            yield self._kv, self._dput(ids), np.arange(ids.size), slice(None)
            return
        lay = self._mesh_layout
        per = self.cache.num_pages // lay.sp
        h = self.model.layers[0].attn.num_heads // lay.tp
        for j, pools in enumerate(self._kv):
            t, s = divmod(j, lay.sp)
            at = np.nonzero(ids // per == s)[0]
            if at.size:
                rows = self._dput(ids[at] % per).to(pools["k"][0].device)
                yield pools, rows, at, slice(t * h, (t + 1) * h)

    @staticmethod
    def _heads(t: torch.Tensor, hs: slice) -> torch.Tensor:
        """Head slice ``hs`` of a page pool [n, P, H, D] or scale rows
        [n, H]."""
        return t[:, hs] if t.dim() == 2 else t[:, :, hs]

    def _global_zeros(self, pool: torch.Tensor, n: int) -> torch.Tensor:
        """Zeros shaped like ``n`` rows of ``pool`` with all the model's
        heads (a shard's pool holds H/tp), on the engine's device."""
        shape = list(pool.shape)
        shape[0] = n
        shape[1 if pool.dim() == 2 else 2] = \
            self.model.layers[0].attn.num_heads
        return torch.zeros(shape, dtype=pool.dtype, device=self.device)

    def _page_gather(self, page_ids) -> dict:
        """A device copy of pages ``page_ids`` of every pool (scale rows
        included), in the global layout — the pre-dispatch save of an
        int8_dynamic spec rollback.  On a mesh the copy assembles each
        page from its owning shards (``serving.shard.page_gathers``)."""
        out = {side: [self._global_zeros(pool, len(page_ids))
                      for pool in pools]
               for side, pools in self._pool_dicts()[0].items()}
        for pools, rows, at, hs in self._page_shards(page_ids):
            at_dev = self._dput(at)
            for side, saved in out.items():
                for dst, pool in zip(saved, pools[side]):
                    self._heads(dst, hs)[at_dev] = pool.index_select(
                        0, rows).to(self.device)
        if self._mesh_layout is not None:
            self.metrics.on_shard_page_gather()
        return out

    def _page_put(self, page_ids, payload: dict):
        """Write global-layout pages ``payload`` (a :meth:`_page_gather`
        copy, or any subset of its sides) into pages ``page_ids``.  On a
        mesh each shard takes its pages' rows and heads
        (``serving.shard.page_scatters``)."""
        for pools, rows, at, hs in self._page_shards(page_ids):
            at_dev = self._dput(at)
            for side, saved in payload.items():
                for pool, src in zip(pools[side], saved):
                    part = self._heads(src.index_select(0, at_dev), hs)
                    pool.index_copy_(0, rows, part.to(pool.device))
        if self._mesh_layout is not None:
            self.metrics.on_shard_page_scatter()

    # --- tiered KV transport closures ---------------------------------------
    # The PageTransport is device-free: these two closures are its only
    # window onto the pools.  Both run only at the admission boundary
    # (the demote window and promote_for), never in steady decode, and
    # inside ``step`` — behind the capture gate, like every device call
    # of the engine.
    def _tier_gather(self, page_ids: List[int]) -> List[dict]:
        """Device->host: one payload per page, in ``page_ids`` order —
        per-layer [P, H, D] k / v arrays, plus [H] scale rows in the int8
        modes, in the pool's own dtypes (a restore is bit-exact).  A
        bfloat16 pool's pages travel as their int16 bit pattern: numpy
        has no bfloat16.  One copy a side, every layer stacked (it waits
        for the device: demotions happen at admission only)."""
        got = self._page_gather(page_ids)
        out = [{} for _ in page_ids]
        for key, arrs in got.items():
            stacked = torch.stack(arrs)               # [L, R, ...]
            if stacked.dtype == torch.bfloat16:
                stacked = stacked.view(torch.int16)
            host = stacked.cpu().numpy()
            for i, payload in enumerate(out):
                payload[key] = [host[li, i].copy()
                                for li in range(host.shape[0])]
        return out

    def _tier_restore(self, page_ids: List[int], payloads: List[dict]):
        """Host->device: write promoted payloads into freshly taken pages
        in place (the inverse of ``_tier_gather``: the same keys, the
        pool's own dtypes — anything else is refused, and the promotion
        becomes a miss).  The upload is ``_dput``'s pinned, non-blocking
        copy, ordered before the write on the engine's stream; the pools
        keep their addresses, so no graph is captured again."""
        pools = self._pool_dicts()[0]
        dev = {}
        for key in payloads[0]:
            want = pools[key][0].dtype
            bits = torch.int16 if want == torch.bfloat16 else want
            host = np.stack([np.stack(p[key]) for p in payloads],
                            axis=1)                   # [L, R, ...]
            page = list(pools[key][0].shape[1:])
            page[0 if len(page) == 1 else 1] = \
                self.model.layers[0].attn.num_heads
            if torch.from_numpy(host[:0]).dtype != bits \
                    or list(host.shape[2:]) != page:
                raise InvalidArgumentError(
                    f"tier payload {key!r} {host.dtype} "
                    f"{tuple(host.shape[2:])} does not fit the pool "
                    f"({want})")
            t = self._dput(host)
            if want == torch.bfloat16:
                t = t.view(torch.bfloat16)
            dev[key] = list(t.unbind(0))
        self._page_put(page_ids, dev)

    def _scrub_pages(self, page_ids):
        """Zero the payload of pages a quarantine frees, so the NaN they
        carry never reaches a future owner.  Int8 static scale rows are
        restored to their calibrated values (a ``nan_logits`` poison
        writes NaN into the row, and static mode has no other reset);
        dynamic rows are reset by ``_reset_page_scales``."""
        if not page_ids:
            return
        n = len(page_ids)
        payload = {side: [self._global_zeros(pool, n)
                          for pool in self._pool_dicts()[0][side]]
                   for side in ("k", "v")}
        if self._static_kv_scales is not None:
            for side in ("k", "v"):
                payload[f"{side}_scale"] = [
                    torch.as_tensor(np.asarray(static, np.float32),
                                    device=self.device)[None, :].repeat(n, 1)
                    for static in self._static_kv_scales[side]]
        self._page_put(page_ids, payload)

    def _reset_page_scales(self, page_ids):
        """Dynamic int8 KV only: return (re)allocated pages' scales to
        the eps floor BEFORE anything is written through them, so their
        quantization depends only on the owning sequence's tokens — on a
        mesh, in the rows of the shards that own them."""
        if not self._kv_dynamic or not page_ids:
            return
        for pools, rows, _at, _hs in self._page_shards(page_ids):
            for side in ("k_scale", "v_scale"):
                for sc in pools[side]:
                    # the value as a kernel argument: ``sc[rows] = eps``
                    # would copy a host scalar to the card and sync
                    sc.index_fill_(0, rows, KV_SCALE_EPS)

    def _quarantine(self, seq: Sequence):
        """Fail one guard-flagged request NOW (pipeline collapsed)."""
        if seq.done or seq not in self.scheduler.running:
            return
        rid = seq.seq_id
        page_ids = self.cache.seq_page_ids(rid)
        self.scheduler.finish(seq)
        seq.done = True
        seq.epoch += 1
        # scrub only pages that returned to the free list
        freed = [p for p in page_ids if self.cache.is_free(p)]
        self._scrub_pages(freed)
        self._reset_page_scales(freed)
        self._forget(rid)
        self._release_lane(seq)
        self._faulted.append(rid)
        self.metrics.on_quarantine()
        flight.request_terminal(rid, "failed", replica=self.chaos_key,
                                reason="numerical_fault",
                                tokens=seq.num_generated)

    def _process_quarantines(self):
        """Collapse the pipeline, then quarantine every flagged lane
        (collapsing may flag more — loop until drained)."""
        while self._quarantine_pending:
            self._sync_pending()
            pending, self._quarantine_pending = \
                self._quarantine_pending, []
            for seq in pending:
                self._quarantine(seq)

    def _poison_lane(self, seq: Sequence):
        """Chaos ``serving.logits`` ``nan_logits``: drive the next
        dispatch's logits for exactly this lane non-finite on the device.
        Native KV gets NaN over the K page holding the lane's last
        written position, in every layer; int8 KV (whose payload cannot
        hold NaN) gets NaN in that page's K scale row, which makes every
        dequant of the page NaN."""
        table = self.cache.seq_page_ids(seq.seq_id)
        if not table:
            return
        pos = max(seq.pos - 1, 0)
        page = table[min(pos // self.page_size, len(table) - 1)]
        for pools, rows, _at, _hs in self._page_shards([page]):
            for pool in pools.get("k_scale", pools["k"]):
                pool[rows] = float("nan")

    # --- snapshot / warm failover ------------------------------------------
    def kv_mode(self) -> str:
        """The KV pools' mode — the snapshot contract's key: ``native``,
        ``int8_static`` or ``int8_dynamic``."""
        if self.kv_cache_dtype != "int8":
            return "native"
        return "int8_dynamic" if self._kv_dynamic else "int8_static"

    @_gated
    def snapshot(self, request_id: str) -> Optional[EngineSnapshot]:
        """Checkpoint one RUNNING request: its consumed tokens and the KV
        pages covering them, for ``restore()`` on another engine built
        from the same model and configuration (any mesh shape).  None
        when the id is not decoding (queued, preempted back to the queue,
        finished, or mid prefill plan — its pages are half written).

        ``generated`` is the consumed stream; the pages may also hold a
        still-in-flight dispatch's writes at positions >= ``pos``, which
        the resumed decode rewrites.  The page read waits for the device
        (a snapshot is not a steady-decode operation)."""
        seq = next((s for s in self.scheduler.running
                    if s.seq_id == request_id and not s.done), None)
        if seq is None or request_id in self._prefill_plans:
            return None
        g = len(seq.generated)
        pos = seq.request.prompt.size - 1 + g
        rows = self.cache.seq_page_ids(request_id)[
            :self.cache.pages_needed(pos)]
        pages: Dict[str, List[np.ndarray]] = {"k": [], "v": []}
        mode = self.kv_mode()
        if rows:
            # numpy has no bfloat16: such pages travel as exact f32
            got = {side: [(t.float() if t.dtype == torch.bfloat16 else t)
                          .cpu().numpy() for t in arrs]
                   for side, arrs in self._page_gather(rows).items()}
            if mode == "int8_dynamic":
                # dynamic scales are the donor pool's device state: store
                # dequantized pages (restore re-derives abs-max scales)
                for side in ("k", "v"):
                    for q, sc in zip(got[side], got[f"{side}_scale"]):
                        pages[side].append(np.stack(
                            [dequantize_kv_page(q[i], sc[i])
                             for i in range(len(rows))]))
            else:
                for side in ("k", "v"):
                    pages[side] = got[side]
        spec_state = None
        if self.spec is not None:
            spec_state = self.spec.drafter.export_lane(request_id) or None
        snap = EngineSnapshot(
            request_id=request_id, prompt=seq.request.prompt,
            max_new_tokens=seq.request.max_new_tokens,
            deadline=seq.request.deadline,
            generated=np.asarray(seq.generated, np.int32), pos=int(pos),
            kv_mode=mode, page_size=self.page_size, pages=pages,
            spec=spec_state)
        self.metrics.on_snapshot(snap.nbytes)
        return snap

    @_gated
    def restore(self, snap: EngineSnapshot) -> str:
        """Re-admit a snapshotted request MID-STREAM: a resume request
        whose admission uploads the snapshot's pages instead of
        prefilling; decode continues at ``snap.pos`` and token callbacks
        fire from index ``snap.num_generated`` on.  The deadline rides
        along unchanged.  Raises on a page-size or KV-mode mismatch and
        on a live duplicate id."""
        if snap.page_size != self.page_size:
            raise InvalidArgumentError(
                f"snapshot page_size {snap.page_size} != engine "
                f"page_size {self.page_size}")
        if snap.kv_mode != self.kv_mode():
            raise InvalidArgumentError(
                f"snapshot kv_mode {snap.kv_mode!r} != engine kv_mode "
                f"{self.kv_mode()!r} — snapshots are portable only "
                "between replicas of one serving configuration")
        prompt = self.check_request(snap.prompt, snap.max_new_tokens)
        self._check_not_live(snap.request_id)
        req = Request(prompt=prompt,
                      max_new_tokens=int(snap.max_new_tokens),
                      request_id=snap.request_id, deadline=snap.deadline,
                      resume=snap)
        self.scheduler.add(req)
        return req.request_id

    def _upload_snapshot(self, seq: Sequence):
        """Admission of a resume request: write the snapshot's pages into
        its freshly allocated pages, in place (replaces the prefill)."""
        snap = seq.request.resume
        rows = self.cache.seq_page_ids(seq.seq_id)
        if rows:
            R = len(rows)
            pool = self._pool_dicts()[0]["k"][0]
            payload = {}
            if snap.kv_mode == "int8_dynamic":
                # fresh abs-max scales from the dequantized pages: the
                # restored scales depend only on this sequence's content
                for side in ("k", "v"):
                    qs, ss = [], []
                    for page_fp in snap.pages[side]:      # [R, P, H, D]
                        pairs = [quantize_kv_page(page_fp[i])
                                 for i in range(R)]
                        qs.append(np.stack([q for q, _ in pairs]))
                        ss.append(np.stack([sc for _, sc in pairs]))
                    payload[side] = qs
                    payload[f"{side}_scale"] = ss
            else:
                for side in ("k", "v"):
                    payload[side] = [np.asarray(p)[:R]
                                     for p in snap.pages[side]]
            dtypes = {"k": pool.dtype, "v": pool.dtype,
                      "k_scale": torch.float32, "v_scale": torch.float32}
            self._page_put(rows, {
                key: [torch.tensor(a).to(self.device, dtypes[key])
                      for a in arrs]
                for key, arrs in payload.items()})
        if snap.num_generated:
            # the first token came out on the donor: no second TTFT
            self._ttft_recorded.add(seq.seq_id)
            seq.first_token_time = snap.created_at
        self.metrics.on_restore()

    # --- device-resident lane state ---------------------------------------
    def _grow_state(self, new_bucket: int):
        """Pad the device state up to ``new_bucket`` lanes on the device
        (no re-upload of live lanes).  Only with the pipeline drained."""
        if self._pending:
            raise InternalError("lane state grown with a dispatch in flight")
        M = self.pages_per_seq
        if self._state_bucket == 0:
            self._tokens = self._dput(np.zeros((new_bucket,), np.int32))
            self._pos = self._dput(np.zeros((new_bucket,), np.int32))
            self._tables = self._dput(np.zeros((new_bucket, M), np.int32))
        else:
            pad = new_bucket - self._state_bucket
            z = torch.zeros((pad,), dtype=torch.int32, device=self.device)
            self._tokens = torch.cat([self._tokens, z])
            self._pos = torch.cat([self._pos, z])
            self._tables = torch.cat([self._tables, torch.zeros(
                (pad, M), dtype=torch.int32, device=self.device)])
        self._lanes.extend([None] * (new_bucket - self._state_bucket))
        self._state_bucket = new_bucket

    def _bind_lane(self, seq: Sequence) -> int:
        """Bind an admitted sequence to the lowest free lane, growing the
        bucket when none is free; writes ONLY that lane."""
        lane = next((i for i, s in enumerate(self._lanes) if s is None), -1)
        if lane < 0:
            self._grow_state(smallest_bucket(len(self._lanes) + 1,
                                             self.scheduler.bucket_sizes))
            lane = self._lanes.index(None)
        self._lanes[lane] = seq
        self._tokens[lane] = seq.next_token
        self._pos[lane] = seq.pos
        self._tables[lane] = self._dput(
            self.cache.page_table_row(seq.seq_id))
        self._uploaded_pages[seq.seq_id] = self.cache.seq_pages(seq.seq_id)
        return lane

    def _clear_lane(self, lane: int):
        """Zero one lane on the device (pos 0 + all-trash page table)."""
        self._tokens[lane] = 0
        self._pos[lane] = 0
        self._tables[lane] = 0

    def _sync_rows(self, active: List[Tuple[int, Sequence]]):
        """Re-upload every device table row whose host allocation grew
        since its last upload — MUST run between any page allocation and
        the dispatch that writes into the new pages.  In dynamic int8
        mode the grown pages' scales are reset first (another sequence
        may have freed them with a larger scale)."""
        for lane, seq in active:
            table = self.cache.seq_page_ids(seq.seq_id)
            n = len(table)
            if n != self._uploaded_pages.get(seq.seq_id):
                self._reset_page_scales(
                    table[self._uploaded_pages.get(seq.seq_id, 0):])
                self._tables[lane] = self._dput(
                    self.cache.page_table_row(seq.seq_id))
                self._uploaded_pages[seq.seq_id] = n

    def _maybe_shrink(self):
        """With the pipeline drained, compact lanes down to the smallest
        covering bucket (rebuilt from the host mirror), or drop the state
        when no lane is live."""
        if self._pending or not self._state_bucket:
            return
        active = [s for s in self._lanes if s is not None]
        if not active:
            self._tokens = self._pos = self._tables = None
            self._state_bucket = 0
            self._lanes = []
            # idle boundary: the next burst's first dispatch must not
            # record the idle period as a dispatch gap
            self._last_dispatch = None
            return
        desired = smallest_bucket(len(active), self.scheduler.bucket_sizes)
        if desired >= self._state_bucket:
            return
        tokens = np.zeros((desired,), np.int32)
        pos = np.zeros((desired,), np.int32)
        tables = np.zeros((desired, self.pages_per_seq), np.int32)
        for i, s in enumerate(active):
            tokens[i] = s.next_token
            pos[i] = s.pos
            tables[i] = self.cache.page_table_row(s.seq_id)
        self._tokens = self._dput(tokens)
        self._pos = self._dput(pos)
        self._tables = self._dput(tables)
        self._lanes = active + [None] * (desired - len(active))
        self._state_bucket = desired

    # --- prefill ----------------------------------------------------------
    def _prefill_chunks(self, prompt, start: int = 0
                        ) -> List[Tuple[np.ndarray, np.ndarray]]:
        """prompt[start:-1] as (tokens, positions) chunks of up to
        ``prefill_chunk`` rows (``chunk_schedule``: full chunks + one pow2
        tail); padded tail rows sit past the prompt, where the valid
        length sends their writes to the trash page.  Positions are
        absolute, so a chunk starting past a cached prefix attends over
        the shared pages like any page written before."""
        n = prompt.size - 1
        chunks = []
        for off, size in chunk_schedule(n - start, self.prefill_chunk):
            s0 = start + off
            ctok = np.zeros((size,), np.int32)
            valid = min(s0 + size, n) - s0
            ctok[:valid] = prompt[s0:s0 + valid]
            chunks.append((ctok, (s0 + np.arange(size)).astype(np.int32)))
        return chunks

    def _prefill_seq(self, seq: Sequence):
        """Split-mode admission: teacher-force prompt[cached:-1] through
        the prefill program chunk by chunk (positions below
        ``seq.cached_tokens`` sit in shared index pages; a fully covered
        prompt dispatches nothing), then wait for the device once, inside
        the timed window — the decode that follows needs this KV
        anyway."""
        prompt = seq.request.prompt
        n = prompt.size - 1
        start = min(seq.cached_tokens, n)
        if n - start == 0:
            return
        chunks = self._prefill_chunks(prompt, start)
        row = self._dput(self.cache.page_table_row(seq.seq_id))
        n_dev = self._dput(np.int32(n))
        t0 = time.perf_counter()
        with RecordEvent("serving/prefill", chunks=len(chunks),
                         prompt_len=int(prompt.size)):
            for ctok, cpos in chunks:
                flight.request_event(seq.seq_id, EV_PREFILL_CHUNK,
                                     replica=self.chaos_key, size=ctok.size)
                with RecordEvent("serving/prefill_chunk", size=ctok.size):
                    self._kv = self._prefill_fn(
                        self._dput(ctok), self._dput(cpos), row, n_dev,
                        self._kv)
                self.program_calls["prefill"] += 1
            if self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()
        dt = time.perf_counter() - t0
        self.metrics.on_prefill(dt)
        self.metrics.on_prefill_chunks(len(chunks), n - start, dt)

    # --- unified ragged dispatch ------------------------------------------
    def _plan_prefill(self, seq: Sequence, awaits=()):
        """Ragged-mode admission: BUILD the chunk plan (host arrays only)
        — each following step pops one chunk into the mixed dispatch; the
        chunk rows carry valid_len n.  The plan starts at the first
        uncached token; a fully covered prompt plans nothing.

        Write visibility (prefix cache): admission sealed the prompt's
        full pages before this plan wrote them, so the plan registers
        them as ``unwritten`` and clears each one as the chunk covering
        it is issued.  ``awaits`` lists shared pages this sequence reads
        that another live plan has not written yet: the lane idles (no
        chunk, no decode, no copy-on-write) until every one of them was
        issued by an earlier dispatch; a fully covered prompt then gets a
        chunkless plan that only holds the lane."""
        prompt = seq.request.prompt
        n = prompt.size - 1
        start = min(seq.cached_tokens, n)
        awaits = set(awaits)
        if n - start == 0 and not awaits:
            return
        chunks: Deque[Tuple[np.ndarray, np.ndarray, int]] = deque(
            (ctok, cpos, n)
            for ctok, cpos in self._prefill_chunks(prompt, start))
        pend: List[Tuple[int, int]] = []
        pc = self.prefix_cache
        if chunks and pc is not None and seq.request.resume is None \
                and seq.request.use_prefix_cache:
            # page j is complete once positions through (j+1)*P - 1 have
            # been issued
            P = self.page_size
            ids = self.cache.seq_page_ids(seq.seq_id)
            for j in range(start // P, n // P):
                pc.unwritten.add(int(ids[j]))
                pend.append((int(ids[j]), (j + 1) * P - 1))
        self._prefill_plans[seq.seq_id] = {
            "chunks": chunks, "t0": time.perf_counter(),
            "count": len(chunks), "tokens": n - start, "await": awaits,
            "cow": seq.cow_pair is not None and bool(awaits),
            "pending": pend}

    def _drop_plan(self, seq_id: str) -> set:
        """Remove a sequence's prefill plan (preemption, abort, expiry or
        quarantine mid-plan).  The sealed pages it never wrote hold no
        KV: un-publish them and return them, so that their current
        sharers are recomputed too (``_preempt_plan_sharers``)."""
        plan = self._prefill_plans.pop(seq_id, None)
        if plan is None:
            return set()
        stale = {pid for pid, _ in plan["pending"]}
        if stale and self.prefix_cache is not None:
            self.prefix_cache.invalidate_pages(stale)
        return stale

    def _preempt_plan_sharers(self, stale: set):
        """Cascade recompute: every running sequence still barrier-held on
        a ``stale`` page would read KV that is now never written — preempt
        it back to the queue (a deterministic replay)."""
        for s in list(self.scheduler.running):
            plan = self._prefill_plans.get(s.seq_id)
            if plan is None or not (plan["await"] & stale):
                continue
            self.scheduler.preempt(s)
            self.metrics.on_preemption(1)
            self._uploaded_pages.pop(s.seq_id, None)
            sub = self._drop_plan(s.seq_id)
            if self.spec is not None:
                self.spec.on_drop(s.seq_id)
            self._release_lane(s)
            if sub:
                self._preempt_plan_sharers(sub)

    def _mark_dispatch(self):
        """Record the host gap since the previous dispatch (the
        inter-token latency in steady decode)."""
        t = time.perf_counter()
        if self._last_dispatch is not None:
            self.metrics.on_dispatch_gap(t - self._last_dispatch)
        self._last_dispatch = t

    def _steady_rows(self, bucket: int):
        """Steady-decode ragged inputs for one lane bucket (Q=1, every
        lane advancing, no KV horizon) — cached per bucket, so steady
        decode performs no host transfer."""
        ent = self._ragged_steady.get(bucket)
        if ent is None:
            ent = (self._dput(np.zeros((bucket, 1), np.int32)),
                   self._dput(np.zeros((bucket, 1), np.int32)),
                   self._dput(np.full((bucket, 1), RAGGED_NO_LIMIT,
                                      np.int32)),
                   self._dput(np.ones((bucket,), np.int32)))
            self._ragged_steady[bucket] = ent
        return ent

    def _dispatch_ragged(self, active: List[Tuple[int, Sequence]]):
        """Issue ONE mixed ragged dispatch: decode lanes advance one
        position on the device; lanes with a pending prefill plan carry
        their next chunk's rows (advance 0, device state untouched until
        the plan drains); barrier-held lanes ride with every row junk
        (``row_valid`` 0, advance 0)."""
        B = self._state_bucket
        chunks: Dict[int, Tuple[np.ndarray, np.ndarray, int]] = {}
        idle: set = set()
        done_plans: List[dict] = []
        # the barrier's view BEFORE this dispatch issues anything: a lane
        # may read a shared page only once an EARLIER dispatch issued the
        # chunk that writes it (stream order then commits the payload
        # ahead of the read)
        pc = self.prefix_cache
        pending_before = set(pc.unwritten) if pc is not None \
            and pc.unwritten else ()
        for lane, seq in active:
            plan = self._prefill_plans.get(seq.seq_id)
            if plan is None:
                continue
            aw = plan["await"]
            if aw:
                aw.intersection_update(pending_before)
            if aw:
                idle.add(lane)
                continue
            if plan["cow"]:
                # deferred copy-on-write: its source page is written now
                self._apply_cow(seq)
                plan["cow"] = False
            if plan["chunks"]:
                chunks[lane] = ctok, cpos, n = plan["chunks"].popleft()
                pend = plan["pending"]
                # sealed pages this chunk writes through are issued now:
                # their readers pass the barrier from the next step
                through = min(int(cpos[-1]), n - 1)
                while pend and pend[0][1] <= through:
                    pc.unwritten.discard(pend.pop(0)[0])
            if not plan["chunks"]:
                done_plans.append(self._prefill_plans.pop(seq.seq_id))
        self._sync_rows(active)
        self._mark_dispatch()
        prefill_rows = 0
        if not chunks and not idle:
            Q = 1
            rows_tok, rows_pos, row_valid, advance = self._steady_rows(B)
        else:
            # mixed step: fresh host rows for this step's chunk mix;
            # padding rows carry row_valid 0 (trash-page scatter, zero
            # attention span)
            Q = max((c[0].size for c in chunks.values()), default=1)
            rt = np.zeros((B, Q), np.int32)
            rp = np.zeros((B, Q), np.int32)
            rv = np.zeros((B, Q), np.int32)
            adv = np.ones((B,), np.int32)
            rv[:, 0] = RAGGED_NO_LIMIT
            for lane, (ctok, cpos, n) in chunks.items():
                sz = ctok.size
                rt[lane, :sz] = ctok
                rp[lane, :sz] = cpos
                rv[lane, :] = 0
                rv[lane, :sz] = n
                adv[lane] = 0
                prefill_rows += sz
                flight.request_event(self._lanes[lane].seq_id,
                                     EV_PREFILL_CHUNK,
                                     replica=self.chaos_key, size=int(sz))
            for lane in idle:
                rv[lane, :] = 0
                adv[lane] = 0
            rows_tok, rows_pos = self._dput(rt), self._dput(rp)
            row_valid, advance = self._dput(rv), self._dput(adv)
        with RecordEvent("serving/ragged_step", bucket=B, rows=Q):
            _out_rows, out_dec = self._run_ragged(rows_tok, rows_pos,
                                                  row_valid, advance)
        # chunk and barrier-held lanes did not decode this step: their
        # out_dec entry is junk and their host mirror must not advance
        held = chunks.keys() | idle
        snapshot = tuple(
            (s, s.epoch) if s is not None and i not in held else None
            for i, s in enumerate(self._lanes))
        for lane, s in active:
            if lane not in held:
                s.pos += 1
        host, event = self._to_host(out_dec)
        self._pending.append(_Pending(host, event, 1, snapshot))
        self.metrics.on_ragged(
            decode_rows=sum(1 for lane, _ in active if lane not in held),
            prefill_rows=prefill_rows, q_bucket=Q)
        for plan in done_plans:
            if not plan["count"]:
                # a barrier-only plan (fully covered prompt): no prefill
                continue
            # prefill accounting records wall time since admission (the
            # chunks ran interleaved across steps)
            dt = time.perf_counter() - plan["t0"]
            self.metrics.on_prefill(dt)
            self.metrics.on_prefill_chunks(plan["count"], plan["tokens"], dt)

    def _run_ragged(self, rows_tok, rows_pos, row_valid, advance):
        """One ragged dispatch against the device-resident lane state;
        returns ``(out_rows, out_dec)``.  On a mesh it is the chaos site
        ``serving.shard_sync`` (``delay``: a straggler shard holds the
        step's collectives back; ``raise``: a failed exchange, the step
        fails as a replica crash) and one ``serving.shard.steps``."""
        if self._mesh_layout is not None:
            chaos_site("serving.shard_sync", key=self.chaos_key)
            self.metrics.on_shard_step()
        (out_rows, out_dec, self._tokens, self._pos,
         self._kv) = self._ragged_fn(
            self._tokens, self._pos, self._tables, rows_tok, rows_pos,
            row_valid, advance, self._kv)
        self.program_calls["ragged_step"] += 1
        return out_rows, out_dec

    # --- split dispatch ---------------------------------------------------
    def _dispatch(self, active: List[Tuple[int, Sequence]]) -> int:
        """Issue one decode dispatch against the device-resident state —
        the ragged step, or the split decode program (the fused K-step
        one when no admission waits and every lane has K tokens of
        budget and page reservation left); returns the positions it
        advanced every lane."""
        if self.ragged:
            self._dispatch_ragged(active)
            return 1
        k = 1
        if (self._fused_fn is not None and not self.sync_mode
                and not self.scheduler.waiting
                and min(self._remaining(s) for _, s in active)
                >= self.fused_steps):
            # reserve pages covering pos+K for every lane WITHOUT
            # preemption; partial reservations are kept (they are used
            # within K steps)
            if all(self.scheduler.reserve(s, s.pos + self.fused_steps)
                   for _, s in active):
                k = self.fused_steps
        # the device rows must cover every position this program writes,
        # or the writes fall into the trash page
        self._sync_rows(active)
        self._mark_dispatch()
        with RecordEvent("serving/decode_step", bucket=self._state_bucket,
                         steps=k):
            if k == 1:
                (self._tokens, out), self._pos, self._kv = self._decode_fn(
                    self._tokens, self._pos, self._tables, self._kv)
                self.program_calls["decode"] += 1
            else:
                out, self._tokens, self._pos, self._kv = self._fused_fn(
                    self._tokens, self._pos, self._tables, self._kv)
                self.program_calls["decode_fused"] += 1
        snapshot = tuple((s, s.epoch) if s is not None else None
                         for s in self._lanes)
        for _, s in active:
            s.pos += k                   # host mirror: dispatch-advanced
        host, event = self._to_host(out)
        self._pending.append(_Pending(host, event, k, snapshot))
        return k

    # --- prefix cache -------------------------------------------------------
    def _apply_cow(self, seq: Sequence):
        """The device half of a copy-on-write admission: the scheduler
        already swapped the shared page for a fresh one in the host
        table; copy the payload (every layer, side and scale row) from
        ``src`` to ``dst`` IN PLACE, so the pools keep the addresses the
        captured graphs bind.  On a mesh each tensor shard copies its
        heads from the sequence shard owning ``src`` to the one owning
        ``dst``."""
        src, dst = (int(p) for p in seq.cow_pair)
        if self._mesh_layout is None:
            pairs = [(self._kv, src, self._kv, dst)]
        else:
            lay = self._mesh_layout
            per = self.cache.num_pages // lay.sp
            pairs = [(self._kv[t * lay.sp + src // per], src % per,
                      self._kv[t * lay.sp + dst // per], dst % per)
                     for t in range(lay.tp)]
        for src_pools, s_row, dst_pools, d_row in pairs:
            for side, pools in dst_pools.items():
                for dst_pool, src_pool in zip(pools, src_pools[side]):
                    dst_pool[d_row].copy_(src_pool[s_row])
        self.prefix_cache.on_cow()

    def _seal_prefix(self, seq: Sequence, upto_pos: int):
        """Publish ``seq``'s full pages covering positions ``[0,
        upto_pos)`` into the prefix index, keyed by the token ids that
        produced them (prompt + generated).  Callers pass the first
        position any future write of the sequence can touch.  Host work
        only."""
        pc = self.prefix_cache
        req = seq.request
        if pc is None or req.resume is not None \
                or not req.use_prefix_cache:
            return
        full = upto_pos // self.page_size
        if full <= 0:
            return
        tokens = req.prompt
        if full * self.page_size > tokens.size:
            tokens = np.concatenate(
                [tokens, np.asarray(seq.generated, np.int32)])
        pc.insert(tokens, self.cache.seq_page_ids(seq.seq_id), full)

    # --- pipelined consume ------------------------------------------------
    def _remaining(self, seq: Sequence) -> int:
        """Dispatch budget left (seq.pos advances at dispatch)."""
        return (seq.request.max_new_tokens
                - (seq.pos - (seq.request.prompt.size - 1)))

    def _consume_one(self) -> int:
        """Wait for the OLDEST in-flight dispatch's tokens, apply them to
        the host mirror, retire finished lanes; returns tokens emitted."""
        ent = self._pending.popleft()
        t0 = time.perf_counter()
        if ent.event is not None:
            ent.event.synchronize()
        toks = ent.tokens.numpy()
        self.metrics.on_decode(time.perf_counter() - t0)
        rows = toks if ent.steps > 1 else toks[None, :]
        now = time.monotonic()
        emitted = 0
        for krow in rows:
            for lane, binding in enumerate(ent.lanes):
                if binding is None:
                    continue
                seq, epoch = binding
                # retired (one-step lag), preempted since (epoch bump) or
                # already guard-flagged: the device token is junk
                if seq.done or seq.epoch != epoch or seq.numeric_fault:
                    continue
                tok = int(krow[lane])
                if tok < 0:
                    # the in-band guard verdict (-1 - tok): never
                    # emitted; the request is quarantined at the end of
                    # the step
                    self.metrics.on_nan_lane()
                    seq.numeric_fault = True
                    self._quarantine_pending.append(seq)
                    continue
                emitted += 1
                self._emit_token(seq, lane, tok, now)
        return emitted

    def _emit_token(self, seq: Sequence, lane: int, tok: int,
                    now: float) -> bool:
        """Apply ONE consumed token to a live sequence — the single
        emission path of the consume loop and the spec-decode accept
        loop: TTFT bookkeeping, drafter observation, stream callback,
        EOS/budget retirement.  Returns True when the token retired the
        sequence."""
        if seq.first_token_time is None:
            seq.first_token_time = now
            if seq.seq_id not in self._ttft_recorded:
                self._ttft_recorded.add(seq.seq_id)
                self.metrics.on_first_token(seq.request.arrival_time, now)
                flight.request_event(seq.seq_id, EV_FIRST_TOKEN,
                                     replica=self.chaos_key)
        seq.generated.append(tok)
        seq.next_token = tok
        if self.spec is not None:
            self.spec.on_token(seq.seq_id, tok)
        if self.token_callback is not None:
            self.token_callback(seq.seq_id, seq.num_generated - 1, tok)
        if (tok == self.eos_id
                or seq.num_generated >= seq.request.max_new_tokens):
            self._retire(seq, lane)
            return True
        return False

    def _retire(self, seq: Sequence, lane: int):
        """EOS / budget retirement: final — the id never reappears."""
        self.outputs[seq.seq_id] = np.asarray(seq.generated, np.int32)
        if self.spec is not None:
            # publish the finished stream into the drafter's shared
            # n-gram corpus and drop the lane state
            self.spec.on_retire(seq)
        # seal BEFORE finish: the full pages this request wrote (prompt
        # and generated tokens) stay resident in the index after its
        # references drop — the donor of the next shared-prefix arrival
        self._seal_prefix(seq, seq.request.prompt.size - 1
                          + seq.num_generated)
        self.scheduler.finish(seq)
        seq.done = True
        self._ttft_recorded.discard(seq.seq_id)
        self._uploaded_pages.pop(seq.seq_id, None)
        self.metrics.on_completion()
        flight.request_terminal(seq.seq_id, "completed",
                                replica=self.chaos_key,
                                tokens=seq.num_generated)
        if lane < len(self._lanes) and self._lanes[lane] is seq:
            self._lanes[lane] = None
            self._clear_lane(lane)

    def _sync_pending(self) -> int:
        """Collapse the pipeline: consume every in-flight step."""
        emitted = 0
        while self._pending:
            emitted += self._consume_one()
        return emitted

    # --- speculative decoding -----------------------------------------------
    def _spec_touched_pages(self, seq: Sequence) -> List[int]:
        """The allocated pages a spec dispatch can write for ``seq``:
        pages covering positions [pos, pos + K) that exist in its table
        (junk past the allocation lands in the trash page)."""
        P = self.page_size
        table = self.cache.seq_page_ids(seq.seq_id)
        p0 = seq.pos // P
        p1 = min((seq.pos + self.spec.k - 1) // P, len(table) - 1)
        return table[p0: p1 + 1] if p1 >= p0 else []

    def _spec_rollback(self, seq: Sequence, saved, inputs, pos0: int,
                       took: int):
        """int8_dynamic rollback: junk writes past the accepted prefix
        grew per-page scales and requantized page content — restore the
        dispatch's touched pages from the pre-dispatch copy, then replay
        the ``took`` emitted positions ONE AT A TIME through the prefill
        program, so per-page scale growth is progressive exactly like the
        plain decode loop's.  Native and int8_static KV never get here:
        their junk is inert until overwritten."""
        rows, payload = saved
        self._page_put(rows, payload)
        row = self._dput(self.cache.page_table_row(seq.seq_id))
        for j in range(took):
            self._kv = self._prefill_fn(
                self._dput(np.asarray([inputs[j]], np.int32)),
                self._dput(np.asarray([pos0 + j], np.int32)),
                row, self._dput(np.int32(pos0 + j + 1)), self._kv)
            self.program_calls["prefill"] += 1

    def _spec_step(self, active) -> Optional[dict]:
        """Attempt one drafter/verifier speculation step.  Returns None
        when nothing was touched (the caller runs the plain dispatch: no
        drafts plausible, chaos ``spec.draft`` denial, a prefill plan in
        flight, or a lane too close to its position ceiling); otherwise a
        ``{"emitted", "bucket", "lanes"}`` dict — including the degraded
        case where drafts evaporated after the pipeline collapse and a
        plain dispatch ran instead.

        Synchronous by design: the accept decision gates the NEXT
        dispatch's positions, so the pipeline is collapsed first and the
        verify dispatch is consumed immediately."""
        spec = self.spec
        K = spec.k
        if self._prefill_plans:
            # ragged mode: a lane mid-prefill-plan carries chunk rows
            # every step — speculation resumes once the plans drain
            return None
        # the verify writes K positions per lane; past max_seq_len the
        # core's clamps would fold junk into a live page — degrade
        if any(s.pos + K > self.max_seq_len for _, s in active):
            return None
        fault = chaos_site("spec.draft", key=self.chaos_key)
        if fault is not None and fault.action == "deny":
            spec.on_degraded()
            return None
        # cheap probe on the (possibly one-dispatch-stale) host mirror
        # BEFORE collapsing the pipeline: a draftless steady state keeps
        # dispatch-ahead.  The probe ticks the drafter's throttle clock
        if not any(len(d) for d in
                   spec.propose(active, tick=True).values()):
            return None
        emitted = self._sync_pending()
        active = [(i, s) for i, s in enumerate(self._lanes)
                  if s is not None]
        if not active:
            return {"emitted": emitted, "bucket": 0, "lanes": 0}
        # real proposals against the now-current history, then reserve
        # each drafted lane's K-token horizon WITHOUT preemption — denial
        # degrades that lane to a plain ride-along in the same dispatch
        drafts = spec.propose(active, tick=False)
        for lane, seq in active:
            d = drafts.get(lane)
            if d is not None and len(d) \
                    and not self.scheduler.reserve(seq, seq.pos + K):
                spec.on_degraded()
                drafts[lane] = d[:0]
        if not any(len(d) for d in drafts.values()):
            # the probe's candidates evaporated: plain dispatch, so the
            # step still makes progress
            self._dispatch(active)
            return {"emitted": emitted, "bucket": self._state_bucket,
                    "lanes": len(active)}
        bucket = self._state_bucket
        self._sync_rows(active)
        saved = {}
        if self._kv_dynamic:
            # pre-dispatch device copy of the write-span pages: junk
            # writes grow per-page scales irreversibly
            for lane, seq in active:
                rows = self._spec_touched_pages(seq)
                if rows:
                    saved[lane] = (rows, self._page_gather(rows))
        # [K, bucket] teacher-forcing inputs: row 0 every lane's real next
        # token, rows 1.. the draft (junk-padded to K; outputs past the
        # real draft are ignored here, their writes land in reserved
        # pages or the trash page)
        draft_mat = np.zeros((K, bucket), np.int32)
        for lane, seq in active:
            draft_mat[0, lane] = seq.next_token
            d = drafts.get(lane)
            if d is not None and len(d):
                draft_mat[1: 1 + len(d), lane] = d
        self._mark_dispatch()
        with RecordEvent("serving/spec_verify", bucket=bucket, steps=K):
            if self._spec_fn is not None:
                out, self._kv = self._spec_fn(self._dput(draft_mat),
                                              self._pos, self._tables,
                                              self._kv)
                self.program_calls["spec_verify"] += 1
                t0 = time.perf_counter()
                toks = out.cpu().numpy()                   # [K, bucket]
            else:
                # ragged fold-in: K teacher-forcing rows per lane, advance
                # 0 everywhere (the accept decision below uploads the
                # surviving state wholesale, as on the split path)
                rows_pos = np.zeros((bucket, K), np.int32)
                rows_val = np.zeros((bucket, K), np.int32)
                for lane, seq in active:
                    rows_pos[lane] = seq.pos + np.arange(K)
                    rows_val[lane] = RAGGED_NO_LIMIT
                out_rows, _dec = self._run_ragged(
                    self._dput(np.ascontiguousarray(draft_mat.T)),
                    self._dput(rows_pos), self._dput(rows_val),
                    self._dput(np.zeros((bucket,), np.int32)))
                self.metrics.on_ragged(spec_rows=K * len(active),
                                       q_bucket=K)
                t0 = time.perf_counter()
                toks = np.ascontiguousarray(out_rows.cpu().numpy().T)
            self.metrics.on_decode(time.perf_counter() - t0)
        now = time.monotonic()
        results = []
        for lane, seq in active:
            d = drafts.get(lane)
            dn = len(d) if d is not None else 0
            col = toks[:, lane]
            # prefix-match-then-take-the-verifier's-next-token: exact
            # greedy identity whatever the drafter proposed
            a = spec.accept_len(d if dn else col[:0], col)
            e = min(a, self._remaining(seq))
            pos0 = seq.pos
            took = 0
            done = False
            for i in range(e):
                if col[i] < 0:
                    # the guard's in-band verdict: non-finite logits at
                    # this position — quarantine, emit nothing at or past
                    # it (a packed token never equals a draft token)
                    self.metrics.on_nan_lane()
                    seq.numeric_fault = True
                    self._quarantine_pending.append(seq)
                    break
                seq.pos += 1
                took += 1
                emitted += 1
                done = self._emit_token(seq, lane, int(col[i]), now)
                if done:
                    break
            if dn:
                results.append((seq.seq_id, dn, a - 1))
                flight.request_event(seq.seq_id, EV_SPECULATED,
                                     replica=self.chaos_key,
                                     drafted=dn, accepted=a - 1)
            if self._kv_dynamic and not done and not seq.numeric_fault \
                    and lane in saved \
                    and min(pos0 + K, self.cache.allocated_tokens(
                        seq.seq_id)) > pos0 + took:
                self._spec_rollback(seq, saved[lane], draft_mat[:, lane],
                                    pos0, took)
        spec.on_verify(results)
        # one wholesale upload of the surviving lanes' (token, pos): the
        # verify advances nothing on the device, the accept decision
        # lives here on the host
        tokens = np.zeros((self._state_bucket,), np.int32)
        pos = np.zeros((self._state_bucket,), np.int32)
        for i, s in enumerate(self._lanes):
            if s is not None:
                tokens[i] = s.next_token
                pos[i] = s.pos
        self._tokens = self._dput(tokens)
        self._pos = self._dput(pos)
        return {"emitted": emitted, "bucket": bucket, "lanes": len(active)}

    # --- one scheduler iteration -----------------------------------------
    def _admit_prefill(self, seq: Sequence):
        """The device half of a fresh admission, in admission order: the
        copy-on-write page copy, then the suffix prefill (planned on the
        ragged engine, dispatched now on the split one).  Hit accounting
        and the sealing of the prompt pages already happened in
        ``Scheduler.admit``.  On the ragged engine, shared pages this
        sequence reads whose writer is itself mid-plan hold the lane (and
        its copy) until their writes are issued."""
        deps = set()
        pc = self.prefix_cache
        if self.ragged and seq.cached_tokens and pc is not None:
            ids = self.cache.seq_page_ids(seq.seq_id)
            deps = {int(p) for p in ids[:seq.cached_tokens // self.page_size]
                    if int(p) in pc.unwritten}
            if seq.cow_pair is not None and int(seq.cow_pair[0]) in \
                    pc.unwritten:
                # the copy's source left this table but is still unwritten
                deps.add(int(seq.cow_pair[0]))
        if seq.cow_pair is not None and not deps:
            self._apply_cow(seq)
        if self.ragged:
            # chunks ride the following mixed ragged steps
            self._plan_prefill(seq, awaits=deps)
        else:
            self._prefill_seq(seq)

    @_gated
    def step(self) -> dict:
        """Admit waiting requests (planning their prefill chunks, or
        prefilling them in split mode), then issue one dispatch — a
        speculative verify when drafts are plausible — and consume the
        previous one.  Returns the step's stats.

        Chaos site ``engine.step``: ``delay`` injects step latency,
        ``raise`` throws InternalError mid-step."""
        t_step = time.perf_counter()
        chaos_site("engine.step", key=self.chaos_key)
        with RecordEvent("serving/step"):
            return self._step_inner(t_step)

    def _step_inner(self, t_step: float) -> dict:
        sched = self.scheduler
        admitted: List[Sequence] = []
        emitted = 0
        # deadlines: expired-in-queue requests are dropped BEFORE
        # admission; expired running sequences are aborted
        now = time.monotonic()
        for req in sched.expire_queued(now):
            self._expired.append(req.request_id)
            self.metrics.on_deadline_miss()
            flight.request_terminal(req.request_id, "deadline_miss",
                                    replica=self.chaos_key)
        for seq in [s for s in sched.running if s.request.expired(now)]:
            if self.abort(seq.seq_id):
                self._expired.append(seq.seq_id)
                self.metrics.on_deadline_miss()
                flight.request_terminal(seq.seq_id, "deadline_miss",
                                        replica=self.chaos_key)
        # admission needs ground truth (free lanes/pages come from
        # retirements hiding in the pipeline), so it collapses the
        # pipeline first; a FULL batch skips the attempt and stays
        # pipelined under queue pressure
        if sched.waiting and len(sched.running) < sched.max_batch_size:
            emitted += self._sync_pending()
            if self.kv_transport is not None:
                # the admission boundary: promote tier hits for the
                # waiting prompts, and open the ONLY window in which
                # evictions demote (admission-pressure reclaims copy to
                # the host here; decode-time pressure keeps discarding,
                # so steady decode never copies a page)
                self.kv_transport.chaos_key = self.chaos_key
                self.kv_transport.demote_window = True
                try:
                    for req in sched.waiting:
                        if req.resume is None and req.use_prefix_cache:
                            self.prefix_cache.promote_for(req.prompt)
                    admitted = sched.admit()
                finally:
                    self.kv_transport.demote_window = False
            else:
                admitted = sched.admit()
            for seq in admitted:
                flight.request_event(seq.seq_id, EV_ADMITTED,
                                     replica=self.chaos_key,
                                     resume=seq.request.resume is not None)
                if seq.cached_tokens:
                    flight.request_event(seq.seq_id, EV_PREFIX_HIT,
                                         replica=self.chaos_key,
                                         tokens=int(seq.cached_tokens))
                # freshly allocated pages quantize from scratch (dynamic
                # int8, which bypasses the prefix cache: no shared page is
                # ever reset here), before anything is written through them
                self._reset_page_scales(self.cache.seq_page_ids(seq.seq_id))
                if seq.request.resume is not None:
                    # warm-failover resume: upload the checkpoint's pages
                    # instead of prefilling
                    self._upload_snapshot(seq)
                else:
                    self._admit_prefill(seq)
                self._bind_lane(seq)
                if self.spec is not None:
                    self.spec.on_admit(seq)
            self.metrics.on_admission(len(admitted))

        bucket = 0
        dispatched_lanes = 0
        active = [(i, s) for i, s in enumerate(self._lanes) if s is not None]
        if any(self._remaining(s) > 0 for _, s in active):
            # pages for the positions this dispatch writes; preemption may
            # strike lanes with results in flight (their epochs are
            # bumped, pending tokens become no-ops)
            preempted = sched.ensure_decode_pages(
                [s for _, s in active if self._remaining(s) > 0])
            if preempted:
                self.metrics.on_preemption(len(preempted))
                for victim in preempted:
                    self._uploaded_pages.pop(victim.seq_id, None)
                    stale = self._drop_plan(victim.seq_id)
                    if self.spec is not None:
                        self.spec.on_drop(victim.seq_id)
                    self._release_lane(victim)
                    if stale:
                        # a mid-plan victim: the sharers of its never-
                        # written sealed pages recompute too
                        self._preempt_plan_sharers(stale)
            active = [(i, s) for i, s in enumerate(self._lanes)
                      if s is not None]
            if any(self._remaining(s) > 0 for _, s in active):
                # chaos site ``serving.logits``: one visit per active
                # lane, keyed by its request id
                for _lane, s in active:
                    fault = chaos_site("serving.logits", key=s.seq_id)
                    if fault is not None and fault.action == "nan_logits":
                        self._poison_lane(s)
                spec_res = (self._spec_step(active)
                            if self.spec is not None else None)
                if spec_res is not None:
                    emitted += spec_res["emitted"]
                    bucket = spec_res["bucket"]
                    dispatched_lanes = spec_res["lanes"]
                else:
                    bucket = self._state_bucket
                    dispatched_lanes = len(active)
                    self._dispatch(active)

        # dispatch-ahead: keep ONE step in flight (none in sync_mode or
        # when nothing was dispatched — then drain fully so retirements
        # and the final outputs land)
        target_depth = 0 if (self.sync_mode or not bucket) else 1
        while len(self._pending) > target_depth:
            emitted += self._consume_one()
        if self._quarantine_pending:
            self._process_quarantines()
        self._maybe_shrink()

        step_seconds = time.perf_counter() - t_step
        self.metrics.on_step(
            queue_depth=sched.queue_depth(),
            running=dispatched_lanes if bucket else len(sched.running),
            bucket=bucket, pages_in_use=self.cache.pages_in_use,
            tokens_emitted=emitted, step_seconds=step_seconds,
            kv_cache_bytes=self.kv_cache_bytes())
        flight.on_step(self.chaos_key, bucket=bucket,
                       lanes=dispatched_lanes,
                       pages_in_use=self.cache.pages_in_use,
                       step_ms=step_seconds * 1e3)
        return {
            "admitted": len(admitted),
            "running": len(sched.running),
            "queue_depth": sched.queue_depth(),
            "bucket": bucket,
            "tokens_emitted": emitted,
            "pages_in_use": self.cache.pages_in_use,
            "in_flight": len(self._pending),
        }

    # --- run to completion ------------------------------------------------
    def drain(self, max_steps: int = 100_000) -> Dict[str, np.ndarray]:
        """Step until queue, batch and pipeline are empty; returns (and
        takes ownership of) all accumulated {request_id: tokens}."""
        steps = 0
        while self.scheduler.has_work() or self._pending:
            self.step()
            steps += 1
            if steps > max_steps:
                raise InternalError(
                    f"drain did not converge within {max_steps} steps")
        out, self.outputs = self.outputs, {}
        return out

    def take_output(self, request_id: str):
        """Pop one finished request's tokens (None if not finished)."""
        return self.outputs.pop(request_id, None)

    def kv_cache_bytes(self) -> int:
        """Device bytes of the KV page pools (every shard's on a mesh),
        int8 scale rows included."""
        return int(sum(t.numel() * t.element_size()
                       for pools in self._pool_dicts()
                       for side in pools.values() for t in side))

    def kv_bytes_per_token(self) -> float:
        """K+V bytes one cached token costs across all layers (scale rows
        amortized over their page)."""
        return self.kv_cache_bytes() / (self.cache.num_pages
                                        * self.page_size)

    def stats(self) -> dict:
        """Engine + cache + metrics snapshot.  The route counters
        (``attention_route``, ``quant.matmul_route``) are process-wide."""
        weight_bytes = None
        if self._weight_quant is not None:
            weight_bytes = int(sum(
                t.numel() * t.element_size()
                for pair in self._weight_quant.values() for t in pair))
        return {
            "metrics": self.metrics.snapshot(),
            "cache": self.cache.stats(self.scheduler.seq_lens()),
            "preemptions": self.scheduler.num_preemptions,
            "pipeline": {
                "sync_mode": self.sync_mode,
                "fused_steps": self.fused_steps,
                "ragged": self.ragged,
                "prefill_chunk": self.prefill_chunk,
                "in_flight": len(self._pending),
                "state_bucket": self._state_bucket,
                "numeric_guards": self.numeric_guards,
                "device": str(self.device),
                # the serving programs replay CUDA graphs (False on the
                # CPU and on a mesh spread over several cards)
                "cuda_graphs": self.cuda_graphs,
                "mesh": (None if self._mesh_layout is None else {
                    "tp": self._mesh_layout.tp,
                    "sp": self._mesh_layout.sp,
                    "devices": self._mesh_layout.size}),
            },
            "prefix_cache": (
                self.prefix_cache.stats()
                if self.prefix_cache is not None else
                {"enabled": False,
                 "bypass_reason": self._prefix_bypass_reason}),
            "spec": (self.spec.stats() if self.spec is not None
                     else {"enabled": False}),
            "programs": dict(self.program_calls),
            "kv_cache_bytes": self.kv_cache_bytes(),
            "attention_route": dict(PAGED_ROUTE_STATS),
            "quant": {
                "kv_cache_dtype": self.kv_cache_dtype or "native",
                "weight_dtype": self.weight_dtype or "native",
                "kv_scale_mode": ("dynamic" if self._kv_dynamic else
                                  "static" if self.kv_cache_dtype
                                  else None),
                "kv_cache_bytes": self.kv_cache_bytes(),
                "kv_bytes_per_token": self.kv_bytes_per_token(),
                "quant_weight_bytes": weight_bytes,
                "matmul_route": dict(QMM_ROUTE_STATS),
            },
            # process-wide, as the route counters: captures, calls and
            # replays of every serving program
            "jit_costs": {k: v for k, v in cost_registry.snapshot().items()
                          if k.startswith("serving.")},
        }


def create_serving_engine(model, config=None, **overrides) -> ServingEngine:
    """Build a ServingEngine from an ``inference.Config`` on which
    ``enable_serving()`` was called (its ``serving_config()``, the card
    it selected included); keyword arguments override config values."""
    kwargs = {}
    if config is not None:
        if not getattr(config, "serving_enabled", lambda: False)():
            raise InvalidArgumentError(
                "config has serving disabled — call "
                "Config.enable_serving(...) first")
        kwargs.update(config.serving_config())
    kwargs.update(overrides)
    return ServingEngine(model, **kwargs)
