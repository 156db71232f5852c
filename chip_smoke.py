"""On-card smoke run of the PyTorch/CUDA port (paddle_tpu_torch).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py [--out FILE.json]

Phases, one result line each (or more):

1. env: card name and power limit (nvidia-smi), torch / CUDA versions,
   and the seconds it took to build the CUDA kernels from
   ``paddle_tpu_torch/ops/csrc/*.cu`` (one ``nvcc`` per source, started
   together).
2. kernel: the ragged paged-attention kernel against its plain PyTorch
   version on the card, in f32 (and once in bf16), at the test shapes and
   at GPT-2-small shapes, with mixed row lengths (empty rows, rows
   shorter than their lane, lengths that are not page multiples), at
   head dims 128, 160 and 256 (f32 and bf16), and at its two forms'
   edges: 15, 16 and 17 rows a lane (the decode form below 16, the
   prefill form from 16) and a 4100-page table.  Timed (GPT-2-small and
   D 256 shapes) with CUDA events beside the plain version and the
   ``scaled_dot_product_attention`` yardstick over the gathered dense KV;
   every lane of a timed case launched alone bit-equal to the same lane
   in the batch (``lane_equal_alone``).
3. kernel_int8: the same kernel's int8 body (int8 pools, [N, H] f32
   scales) in both ``fused_dequant`` settings, f32 q (and once bf16 q),
   at the same shapes, plus a NaN in one K scale row (non-finite exactly
   on the rows that read it); timed beside its plain version and SDPA
   over the dequantized dense KV; lanes alone bit-equal as in phase 2.
4. kernel_qmm: the weight-only int8 matmul against its plain version at
   GPT-2-small's weight shapes (q/k/v/out 768x768, fc1 768x3072, fc2
   3072x768) and an odd edge shape, M in {1, 8, 16, 17, 37, 72, 512}
   (the decode form up to 16 rows, the prefill form above; the form each
   case took logged), f32 and bf16 x, a middle row bit-equal to the same
   row launched alone; timed at M 1, 8, 16 and 512 beside the plain
   version and ``torch.matmul`` on a pre-dequantized f32 weight.
5. e2e: GPT-2-small width (vocab 50304, hidden 768, 12 layers, 12 heads,
   ffn 3072, max_seq_len 1024, f32, seeded random weights) served by
   ``create_serving_engine`` on 8 requests; every attention call must go
   through the kernel, no page may leak, and every stream must equal the
   port's dense ``generate`` except at a reported near-tie.  Every
   serving arm below (5, 6, 7, 12, 15) is driven twice on the same
   prompts, by two engines: once under ``profiler.jit_cost.disable_jit()``
   (every program eager) and once with the serving programs captured as
   one CUDA graph per signature and replayed; the launch counts hold in
   both (a replay adds its captured launches), the two drives' streams
   are equal, and each phase prints both drives' step p50 / p95 and
   dispatch gaps with the captures, their seconds and the replays.  One
   steady graphed step of the native, int8_static and tp 2 x sp 2 mesh
   engines runs under ``torch.profiler``: the paged and matmul kernels'
   device launches by name must be L (#1), 4 L on the mesh (#3/#3q) and
   6 L (#4's decode form) under int8 weights.
6. e2e_int8_static: the same model and requests with
   ``kv_cache_dtype="int8"``, ``weight_dtype="int8"`` and an export
   calibrated on the card; every attention call on the int8 body, every
   projection and MLP matmul on the int8 matmul kernel, streams equal to
   ``generate(quant=export)`` except at a reported near-tie, no page
   leaked, KV bytes at most 0.26x the native engine's.
7. e2e_int8_dynamic: no KV calibration (dynamic per-page scales); 4 of
   the requests, synchronous and pipelined: streams byte-identical, no
   page leaked.
8. kernel_flash: the flash attention forward, dK/dV and dQ kernels
   against their plain versions in f32 and bf16 (all on the tensor cores,
   the f32 bodies in 3xTF32, their launches logged; f32 also in relative
   L2 against FLASH_REL_L2, lse within 1e-4) at the training
   shape (B 8, H 12, S 1024, D 64, causal), a BERT-base shape (S 512,
   non-causal, padded kv mask, dropout 0.1), ``bench.py``'s BERT-base
   shape (B 32, S 128, the same mask and dropout) and unaligned S 1000 with
   D 80, 100 and 256; the dropout bits of all three kernels in f32 and
   in bf16 read back and compared with ``_keep_mask`` bit for bit; each
   kernel timed at the training shape and at B 32 x S 128 beside its
   bound, its plain version and PyTorch's
   ``scaled_dot_product_attention`` on the same work (forward; its
   autograd backward for dK/dV and for dQ, beside the pair's time).
9. train: GPT-2-small widths, all 12 layers, f32 with TF32 off, seeded
   weights, ``AdamW(6e-4, weight_decay=0.1)`` on one seeded B 8 x S 1024
   batch: a warm-up step, then 5 steps of ``loss.backward(); opt.step();
   opt.clear_grad()``.  Every loss finite, the first within 0.5 of
   ln(vocab), the loss falling; every attention call on the flash
   kernels (12 x 5 launches of each, all three on the tensor cores in
   3xTF32, the plain and sdpa routes 0); one
   more step under ``torch.profiler`` gives the device time by kernel
   family and the device's busy share.
10. train_parity: 2 layers at the same widths, B 2 x S 1024: one step's
   loss and every gradient on the card against the same step on the CPU
   through the plain flash route, then the weights after one AdamW step.
11. kernel_decode: the per-row paged attention kernel (one table row and
   one length per query row) and its int8 body against their plain
   version, f32 (and once bf16), at the test shapes, GPT-2-small decode
   rows and a GPT-2-small prefill chunk (64 rows of one sequence sharing
   its table row), rows at head dims 128, 160 and 256 (f32 and bf16),
   both ``fused_dequant`` settings and a NaN scale row;
   timed beside its bound, the plain version, SDPA over the gathered
   dense KV and the ragged kernel at one row per lane on the same inputs;
   every row of a timed case launched alone bit-equal to the same row in
   the batch.  (It runs on the ragged kernel's decode form.)
12. e2e_split: the requests of phase 5 through the split programs —
   ``ragged=False`` pipelined and synchronous, ``fused_steps=4``, and
   ``ragged=False`` with int8 KV and weights and phase 6's export; every
   attention call on the per-row kernel, no page leaked, every stream
   equal to ``generate`` (``generate(quant=export)``) except at a
   reported near-tie.
13. e2e_spec: prompts with repeated spans, ``spec_decode=4`` on the
   default ragged engine (verify folded into the ragged kernel), on
   ``ragged=False`` (the split verify on the per-row kernel) and on the
   ragged engine with uncalibrated int8 KV (the sequential split verify
   and its rollback on the int8 per-row body); every stream equal to the
   same engine's with speculation off except at a reported near-tie,
   drafts proposed, launches counted per route.
14. kernel_stats: the stats form of the ragged kernel (a sequence shard's
   attention over the pages it owns, returning the context and its
   log-sum-exp) and its int8 body in both ``fused_dequant`` settings
   against their plain version, f32 and bf16, at GPT-2-small shard
   shapes (H 12 and 6, D 64, page 16, 64 pages a lane; 8 decode lanes,
   8 lanes of 64 prefill rows), every second page owned, a lane that
   owns nothing and an empty lane (zeros, lse -1e30), NaN K scales on an
   owned page (exactly its readers) and an unowned one (nobody); timed
   (decode and prefill at H 12, prefill at H 6) beside its bound over the
   owned pages, the plain version, the memory-efficient SDPA kernel with
   its log-sum-exp on the gathered owned KV, and the ragged kernel over
   all pages; then again with each lane owning the first half of its
   table (runs), beside the same yardstick on those pages; the same
   checks at head dims 128 and 160 (1, 8 and 64 rows a lane) and 256
   (timed, decode and prefill).  The env line carries the prefill form's
   registers and spills, those of the f32 flash bodies and those of the
   paged kernels' D 256 instances.
15. e2e_mesh: ``force_device_count(4)``, then ``mesh_axes={"tp": 2,
   "sp": 2}`` at GPT-2-small width on 4 long prompts (600-990 tokens, 32
   new tokens) in a 260-page pool, native and with int8 KV and weights
   (phase 6's export), and ``spec_decode=4`` at ``{"tp": 2}``; each
   against the single-device engine with the same knobs, at most one
   recorded near-tie; the stats kernel (the ragged one at sp 1) launched
   once per layer, shard and dispatch, one shard step per dispatch, a
   sequence on both page shards, no page leaked.  Its step times are 4
   (or 2) slots on one card: the replicated work runs once per slot.
16. kernel_scale_shift: row t, the custom-op API's worked kernel
   ``x * scale[0] + shift[0]``, against its plain version bit for bit in
   f32 and bf16 at [16, 8] (the custom-op net), [4, 8], 1,000,003 and
   [8192, 8192], no launch at numel 0; timed at [16, 8] and [8192, 8192]
   beside its bound, the plain version and ``torch.addcmul``.
17. custom_op: ``register_op("scale_shift", ..., vjp=...)`` in
   ``tests/test_custom_op.py``'s eager net (Linear 8-8, the scale-shift
   layer, Linear 8-1), 15 ``Adam(5e-2)`` steps on the card from the
   weights of the same net built on the CPU under ``seed(0)``: 30 kernel
   launches (forward and dx each step), no plain call, the loss halves,
   the losses equal the CPU's.
18. lenet: dygraph LeNet on the synthetic MNIST, ``Adam(1e-3)``, 30
   in-order batches of 64, f32: the loss falls, the first 5 losses equal
   the CPU's from the same weights; step p50 / p95 and images/s.
19. train_bf16: phase 9 with the forward under
   ``amp.auto_cast(dtype="bfloat16")``, as ``bench.py`` trains GPT (the
   loss in f32; master weights, gradients and AdamW state f32): 12 x 5
   launches of each flash kernel, all three on the tensor cores; the
   same loss checks, step times, peak memory and
   device time by kernel family.
20. train_parity_bf16: phase 10 under the same autocast (2 layers, B 2 x
   S 1024): the loss and every gradient against the CPU's plain route
   at bf16 tolerances, and the card's AdamW step against the same step
   replayed on the CPU from the card's gradients.
21. e2e_wide: a 2-layer GPT with head dim 256 (hidden 1024, 4 heads,
   vocab 1024, seeded random weights) served by the ragged engine on 4
   prompts, native and int8_static: every attention call on the D 256
   instances of #1 / #1q, streams equal to ``generate`` except at a
   reported near-tie, no page leaked.

22. sync_free: 32 steady ragged steps (4 lanes) of the native,
   int8_static, int8_dynamic and tp 2 x sp 2 mesh engines, graphed,
   under ``torch.cuda.set_sync_debug_mode("error")`` inside
   ``compile_budget(0, prefix="serving.")``: no host sync, no capture,
   one replay a step; of a ``prefix_cache=True`` engine whose 4
   lanes share prefixes (a full-prompt hit with its copy-on-write, a
   hit, and a lane held by the write barrier), taken after admission;
   and of a ``kv_tiering`` engine (a 64-page pool) after a demote /
   promote cycle (a donor's pages demoted by an opted-out 1000-token
   prompt's admission, promoted back by the lanes').
23. e2e_prefix (runs after e2e_mesh): ``prefix_cache=True`` at
   GPT-2-small width on two waves — 8 requests sharing a 512-token system
   prompt with suffixes of 16-200 tokens, then 2 exact repeats (528 and
   640 tokens: full-prompt hits, each a copy-on-write) and 1 request that
   opts out; native and int8_static on the ragged engine, native on
   ``ragged=False`` and native in a 100-page pool (eviction, reclaim,
   preemption).  Each arm with the cache off and on (graphed; native also
   eager): streams equal to the batched dense reference and to the
   cache-off drive except at a reported near-tie, launches per route,
   the leak invariant, no more captures than the cache-off drive, pool
   addresses unchanged; prefix stats, prefill rows with and without the
   cache, TTFT p50 of hits and misses (host clock) and step p50.
24. e2e_snapshot: the first 4 e2e requests, each snapshotted after 8
   consumed tokens on a graphed donor, restored in a fresh graphed
   engine and drained: spliced streams equal to the uninterrupted drive
   (and ``generate``) except at a reported near-tie, native,
   int8_static and int8_dynamic; then a tp 2 x sp 2 donor restored in a
   single-slot engine and the reverse; snapshot bytes, snapshot ms and
   restore ms (the pages' upload), pools written in place.
25. e2e_frontend (after sync_free): the serving front door at
   GPT-2-small width on the e2e requests — ``ServingFrontend`` over two
   graphed replicas driven by their pump threads (snapshots every 16
   tokens, replica-0 killed mid-decode by ``inject_failure``: its
   requests resume on replica-1 from their snapshots), the same fleet
   with snapshots off and no failure, a disaggregated int8_static fleet
   (one prefill and one decode replica: #1q and #4 through the front
   door, each ship an int8 snapshot), restart recovery (a
   ``snapshot_store`` in a temporary directory, the only replica killed,
   a new frontend's ``recover_pending()`` finishes 4 requests), the
   HTTP server (2 streamed ``POST /generate``, ``GET /healthz``, ``GET
   /metrics``), and 32 steady pump steps of one replica under
   ``set_sync_debug_mode("error")`` and ``compile_budget(0)`` with the
   main thread idle.  Every stream equal to the batched dense reference
   and to the bare engine's e2e streams (int8 per the export) except at
   a reported near-tie; route counters exact summed over the replicas;
   only the injected replica dead; the survivors' leak invariant;
   ``healthz()`` with its SLO, tier and fleet keys and ``/metrics``
   parsed with the ``serving.*`` families; TTFT and ITL p50 / p95 from
   the handles, each replica's step p50, captures and replays,
   snapshots and their ms, ships and wall seconds.  The first fleet runs
   with span retention on: its Chrome trace (written to a temporary
   file and loaded back) must show ``serving/step`` spans with
   ``serving/ragged_step`` children on both pump threads; it is read
   into each replica's step time and snapshots and each request's time
   from submission to admission, from admission to its first token and
   its prefill chunks.  The HTTP arm also fetches
   ``/debug/requests/<id>?format=chrome``; a last arm builds the
   two-replica fleet from ``inference.Config`` through
   ``create_serving_frontend(model, config)``: streams equal to the
   keyword-built fleet's.
26. e2e_tiers (after e2e_prefix): ``kv_tiering`` behind the prefix
   cache in the 100-page pool on three waves — e2e_prefix's first wave,
   8 requests over a second 512-token system prompt opted out of the
   cache (their admission evicts, and so demotes, the first wave's
   pages), the first wave again (its admission promotes them): native
   with a 64-page host tier, native with an 8-page host tier over a
   64-page disk tier (a temporary directory), int8_static with the host
   tier, each beside its tiers-off drive.  Streams equal to the batched
   dense reference and the tiers-off drive except at a reported
   near-tie, demotions and promotions (and disk hits), fewer wave-3
   prefill rows than without tiers, pool addresses unchanged, no
   signature captured twice, the leak invariant, launches per route;
   the host ms of a demotion and of a promotion per page, wave 3's TTFT
   p50 with and without tiers, the tiers' bytes.
27. e2e_profile (after e2e_frontend): the engine built from
   ``inference.Config`` serving 4 e2e prompts graphed, then again under
   ``utils.profiler.start_profiler`` / ``stop_profiler(timeline_path=)``:
   streams equal to the keyword-built engine's, and every launch of the
   paged kernel in the device trace inside a ``serving/step`` range.
28. e2e_beam (after e2e_profile): beam ``generate`` on the GPT-2-small
   model (12 layers) — 4 prompts of 64 tokens, 4 beams, 32 new tokens,
   ``end_id`` 0, f32 with TF32 off — with ``length_penalty`` 0 and 0.6
   and with a weight-only int8 export.  ``num_beams=1`` gives the greedy
   ids; every arm's scores are best-first and within 1e-3 of their
   beams' log-probs re-scored by one full-sequence ``GPTModel.forward``
   (the int8 arm's by the same model with its weights dequantized);
   ``beam_search_decode`` runs under ``set_sync_debug_mode("error")``
   after a warm-up, and its wall time, ms a step and tokens/s are
   logged.  The int8 arm launches #4 72 times a forward (6 matmuls x 12
   layers, 63 prefill and 32 decode forwards), the plain matmul never;
   its beams equal the same decode with the plain matmul except where
   that decode's top K + 1 candidates lie closer than
   INT8_NEAR_TIE_GAP (logged).
29. seq_layers (after e2e_wide): ``nn.Transformer()`` at its default
   width (d_model 512, 8 heads, 6 + 6 layers, ffn 2048) in eval mode,
   B 8, source 256 with a padding mask, target 64 with the causal mask:
   #5 launched once per encoder layer and forward (cross-attention and
   the masked decoder self-attention on the plain route), the output
   within 1e-4 relative L2 of the same model with every attention on the
   plain route, the target decoded step by step through
   ``TransformerDecoder.gen_cache`` against the full causal forward; one
   backward through a GELU ``TransformerEncoderLayer`` at S 256 (#5, #6,
   #7 once each), its gradients within the f32 flash limits of the plain
   route's (max-abs FLASH_TOL, and relative L2 FLASH_REL_L2 but for the
   K bias, whose exact gradient is 0); a
   ``dynamic_decode`` of a GRUCell + Embedding + Linear decoder (H 512,
   V 8000, B 8, K 4, 32 steps), sync-free after a warm-up.
30. fit (after lenet): ``hapi.Model.fit`` on GPT-2-small (12 layers,
   f32, TF32 off, seeded weights): 16 seeded sequences of 1025 tokens
   through ``TensorDataset`` -> ``DataLoader(batch 8, shuffle,
   drop_last)`` for 3 epochs (6 steps, staged by ``prefetch_to_device``),
   ``AdamW(LinearWarmup(CosineAnnealingDecay(6e-4, T_max=6), 2, 0.0,
   6e-4), weight_decay=0.1, grad_clip=ClipGradByGlobalNorm(1.0))``, the
   ``LRScheduler(by_step=True)`` callback and token ``Accuracy``; once
   with the train step one CUDA graph (``accelerate=True``: 1 capture
   of ``hapi/train_step`` and 5 replays while the LR changes every
   step) and once eager, from the same weights and data order: losses
   and final weights bit-equal, #5-#7 launched 12 x 6 times each in both
   runs (3xTF32 bodies, the plain route 0), the first loss within 0.5 of
   ln(vocab) and the loss falling, one ``eval_batch`` and one
   ``predict_batch`` equal to the network's forward, step p50 / p95
   (host clock), tokens/s, peak memory, and one graphed step under the
   profiler (device busy share, kernels by family); then at 2 layers a
   checkpointed fit (every 2 steps) killed at step 4 and resumed by a
   fresh Model, bit-equal to the uninterrupted run.
31. resnet (after fit): ResNet-50 at ``bench.py``'s settings — NHWC,
   every batch norm + ReLU one autograd op, bf16 autocast,
   ``Momentum(0.1, 0.9)``, ``CrossEntropyLoss``, B 128 x 224^2 x 3 from
   ``RandomState(0)`` — through the twin of ``bench.py``'s
   ``build_step`` (``functional_call``, ``fused_step``, the state
   donated to one CUDA graph) graphed and eager, and through
   ``Model.fit`` (``DataLoader`` over 4 batches of the same arrays) with
   ``accelerate`` True and False: losses finite and the graphed runs'
   within 1e-2 of the eager ones, every running mean moved, one capture
   of the fit step, the AMP cast of each op name as the JAX lists say
   (conv2d and linear bf16, the norms and pools none); step p50 / p95,
   images/s, peak memory of each run, and one graphed step under the
   profiler (busy share, kernels by family: conv, matmul, reductions,
   elementwise, pool, copies, every copy kernel named) and one eager
   step's device time by op (the batch norms, the convolutions, the
   casts, the pools).  Then VGG-16
   with batch norm and MobileNet V2 (NCHW, B 32, 3 graphed steps each),
   and a ResNet-18 (NHWC, f32, B 16) whose graphed step equals its eager
   one bit for bit under ``cudnn.deterministic`` (with it off, two eager
   runs' spread is reported).
32. bert (after resnet): ``BertForSequenceClassification()`` at
   bert-base width, ``AdamW(5e-5)``, bf16 autocast, B 32 x S 128 ids
   from ``RandomState(0)`` and a mask padding the last quarter of every
   second row, through the bench-form step and ``Model.fit`` (ids and
   mask packed ``[B, 2, S]``), each graphed and eager: #5, #6 and #7
   launched 12 times a step each in every run, all on the bf16
   tensor-core bodies, the plain route never; losses finite, graphed
   within 1e-3 of eager (bit-equality reported); step p50 / p95,
   tokens/s, peak memory, one graphed step under the profiler (busy
   share, kernels by family); then a 2-layer f32 classifier's loss and
   gradients on the flash route (3xTF32 bodies) against the plain
   attention route on the card.
33-35. anomaly, amp_fp16, o2: ResNet-50's guarded graphed fit (a skip and
   a rollback, each bit-equal to its clean run), BERT-base in fp16 with
   ``GradScaler``, GPT-2-small's fit under O2 against O1.
36. eager_api: ``import paddle_tpu_torch as paddle`` on the card.  The
   default place is the card (``paddle.zeros([2, 3]).place``,
   ``get_device() == "gpu:0"``); every op the top level exports runs
   once on the card and equals the same call under
   ``set_device("cpu")`` (exact, 1e-6, or 1e-5 / 1e-4 for the special
   functions and the linear algebra; the decompositions by their
   invariants; the random ops by their mean and spread), with the ops
   that synchronised the host listed (``set_sync_debug_mode("warn")``
   on a second call, the first having loaded their kernels);
   ``paddle.weight_only_matmul`` at GPT-2-small's fc1 (x [8, 768] f32 and
   bf16, int8 w [768, 3072]) launches #4 twice and its plain version
   never, within QMM_TOL of ``quantized_matmul_ref``; a 3-layer MLP
   regression written in the top-level API (``ParamAttr`` learning-rate
   scale and ``L2Decay``, ``ClipGradByGlobalNorm`` with one
   ``need_clip=False`` weight) runs 20 ``opt.minimize(loss)`` steps with
   and without ``clear_grad``, each arm's losses within 1e-5 relative of
   the CPU's, and its ``state_dict`` comes back from ``paddle.save`` /
   ``paddle.load`` bit-exact on the card; the host microseconds a call
   of ``paddle.add`` / ``paddle.matmul`` beside ``torch.add`` /
   ``torch.matmul`` (median of 1000).
37. eager_nn: the rest of the eager ``nn`` surface on the card.  The
   six comparisons give bool tensors on the card, the in-place version
   guard raises there, ``autograd.run_backward`` equals ``backward``.
   ``nn.Embedding(50257, 768, sparse=True)`` -> mean over S ->
   ``nn.Linear(768, 2)`` -> ``CrossEntropyLoss`` on B 8 x S 1024 ids from
   a seeded Zipf(1.1) clipped to the vocabulary, 10 steps of
   ``Adam(lazy_mode=True)``: the gradient an ``IndexedSlices`` of 8192
   rows whose ``get_tensor_from_selected_rows`` equals the dense arm's
   gradient within 1e-6 relative plus the rounding bound of a sum of an
   entry's n terms in another order (2 (n - 1) 2^-24 sum |terms|, up to
   n = 2300 duplicates of one id); step 1's touched rows within 1e-5
   relative (1e-7 absolute) of the dense arm's (``sparse=False``), the
   untouched rows bit-unchanged; the 10 losses and the final table
   within 1e-5 relative (the table also 1e-6 absolute, 1e-3 of the
   learning rate) of the same program under ``set_device("cpu")``;
   one step's peak device memory, sparse against dense (lower by at
   least the dense gradient's 154.4 MB), whether a sparse step syncs the
   host, each arm's step ms.  Then, forward and backward, each against
   its CPU call at the CPU tests' tolerances: ``interpolate`` bilinear
   x2 (``align_corners`` False and True) and nearest x2 on [8, 256, 64,
   64], bilinear 1/2 on [8, 3, 448, 448], bicubic x2 on [8, 3, 112,
   112]; ``pad`` reflect, replicate and circular by 1 on [8, 64, 112,
   112]; ``pixel_shuffle`` r 2 on [8, 256, 64, 64] and
   ``pixel_unshuffle`` back; ``affine_grid`` + ``grid_sample`` on [8,
   64, 64, 64] (theta's gradient, 262,144 products an entry, within
   1e-4); ``unfold`` 3x3 pad 1 on [8, 64, 56, 56] and ``fold`` back;
   ``one_hot`` of [8, 1024] ids into 1000 classes; the ops that
   synchronised the host listed.
38. declarative: the declarative half on the card.  (a)
   ``jit.to_static(BertForSequenceClassification())`` at bert-base
   widths, B 32 x S 128 with ``bert_inputs``' padding mask, bf16
   autocast, ``AdamW(5e-5)``, DECL_STEPS steps of the bare loop beside
   the same eager loop from the same seed and weights: #5/#6/#7 12 times
   each a step on the bf16 bodies in both, the losses within
   BERT_LOSS_RTOL (bit-equality reported), one signature, each loop's
   step p50.  (b) ``jit.save`` of a seeded bert-base classifier in eval
   mode at an ``InputSpec`` of batch 32 (ids, token types, mask), traced
   once on the CPU and once on the card, served by ``create_predictor``
   in a fresh process (no model class, no JAX): batch 32 and a padded
   batch 8 from each artifact, #5 12 times a call on the 3xTF32 body and
   no plain-route call, the logits within DECL_SERVE_TOL of the eager
   model on the card, latency p50 a batch; the card-saved artifact also
   on the CPU.  (c) static LeNet: a Program with ``Adam.minimize`` built
   on the card, DECL_LENET_STEPS steps through ``Executor`` on the
   synthetic MNIST, the first 5 losses within 1e-4 of the same Program
   on the CPU; hapi's static adapter (``enable_static``) ``fit`` over
   DECL_FIT_BATCHES batches and ``evaluate`` on the card against the
   CPU.  (d) ``decl_control_flow`` (a tensor ``if`` and ``while``)
   through ``to_static`` equal to the CPU's.  (e) the kernel entries as
   operators in saved programs: a layer that calls
   ``weight_only_matmul`` and a registered ``scale_shift`` op, saved by
   ``jit.save`` on the CPU and loaded on the card, launches #4 and t
   there (no plain-version call), its output against the eager layer;
   a static bert-base program of DECL_TRAIN_LAYERS layers (B 4 x S 128,
   no dropout, f32) saved by ``save_train`` and reloaded on the card
   trains through the attention operator: #5 twice a layer a step (the
   forward and the backward's recompute), #6 and #7 once, its losses
   within DECL_TRAIN_RTOL of the Executor's from the same state.
39. distributed: collective training on slots of cuda:0
   (``distributed/``), f32 with TF32 off unless named.  (a)
   ``make_sharded_train_step`` on bert-base (``bench.py:374-405``'s B 32
   x S 128, ``bert_inputs``' padding mask, ``AdamW(5e-5)``, dropout 0)
   at dp 2 x mp 2 on 4 slots (6 heads a slot) against the same step on
   one slot from the same weights, DIST_STEPS steps: losses within
   DIST_LOSS_RTOL, every parameter within DIST_PARAM_ATOL, #5/#6/#7 12 x
   4 each a step on the 3xTF32 bodies (12 on one slot), none plain; step
   p50 and each slot's bytes.  (b) ring attention (H 12, D 64, causal, B
   2 x S 2048) over sp 2 x dp 2 and sp 4 in f32 and bf16: output and
   dq/dk/dv against ``flash_attention_bshd`` over the whole sequence on
   one slot and against the plain ring, within FLASH_TOL and
   FLASH_REL_L2; #5/#6/#7 n(n+1)/2 per ring of n, none plain; then
   ``_dryrun_sequence_parallel``'s three steps at this width, the loss
   falling.  (c) ``make_hybrid_step`` on 8 slots (dp 2 x pp 2 x mp 2) at
   vocab 50304, d_model 768, d_ff 3072: DIST_HYBRID_STEPS losses within
   DIST_HYBRID_RTOL of ``hybrid_reference`` (f64), falling, the ZeRO
   state split over dp.  (d) ``pipeline_train_step`` (1F1B) at pp 4, d
   768, B 32, micro-batches of 4: the loss and every gradient within
   DIST_1F1B_RTOL of the stages in sequence.  (e) two trainers on
   cuda:0 started by ``python -m paddle_tpu_torch.distributed.launch``
   on this script's ``--localsgd-child``: the eager host backend,
   LocalSGD at k 1 within 2e-5 of full-batch SGD in each.
40. fleet_ps: fleet and the parameter server (``distributed/fleet``,
   ``distributed/ps``, ``io/multislot.py``, ``io/native_feed.py``).  (a)
   CTR at PaddleRec ``models/rank/dnn``'s widths on synthetic Criteo-
   layout records from a seed (13 dense features, 26 slots of one
   Zipf-skewed id hashed into 1,000,001, labels from a planted logistic
   rule): CTR_RECORDS records in CTR_FILES files written by
   ``write_multislot_file``, ``InMemoryDataset`` (load, local_shuffle),
   ``train_from_dataset`` with 2 hogwild workers over
   ``fleet.sparse_embedding(dim 9, adagrad, cache_rows=1 << 18)`` and a
   fc 512-256-128-32 tower of port ``nn.Linear``s at batch 512: the loss
   below the labels' base-rate entropy, the native feed built, the
   witness clean; the first CTR_PARITY_BATCHES batches in one sync
   thread on the card and on the CPU, the table zero-initialised on
   its sgd rule under a logistic head (CTR_PARITY_FC), leave tables
   no row of which is further apart than
   CTR_PARITY_REL of the table's largest element (the comment there
   says why); examples/s, step p50 /
   p95, the cache hit rate, host pull / push ms a step, host syncs a
   step (torch's sync debug count), host table rows, peak memory.  (b) 2 ``PSServer``
   processes on the host (no CUDA context) and 2 trainers on the card
   started by ``distributed.launch`` on this script's ``--ps-child``,
   geo k PS_K_STEPS at (a)'s widths, PS_STEPS steps each: both losses
   fall, rank 0 reads rank 1's rows; the wall seconds.  (c) bert-base B
   32 x S 128 under bf16 ``auto_cast`` through ``fleet.init
   (is_collective)``, ``distributed_model``, ``distributed_optimizer
   (AdamW)``: gradient merge k 2 over 4 micro-steps against plain AdamW
   on the gradients averaged by hand (losses within FLEET_GM_LOSS_RTOL,
   parameters within FLEET_GM_PARAM_ATOL), #5-#7 12 times a micro-step
   on the bf16 bodies and none plain; ``RecomputeSequential`` over the
   encoder layers against the plain backward (#5 twice a layer, the
   gradients within FLEET_RECOMPUTE_REL_L2); DGC at sparsity 0.999: kept
   plus residual equals the accumulated gradient exactly, the sparsify
   pass under ``set_sync_debug_mode("error")``.  (d)
   ``ShardingOptimizer`` over dp 4 on 4 slots of the card: bert-base's
   AdamW accumulators split 4 ways where dim 0 divides, replicated
   where not.  (e) ``Executor.train_from_dataset`` on a recorded Program
   fed by an ``InMemoryDataset``: its losses equal the eager loop's on
   the same batches within 1e-5.

Every failure raises (nonzero exit).  The last three lines of standard
output are the card's name and power limit, the kernel record (with each
paged kernel's forms: the decode form's cluster, warps and rows, and the
prefill form) and
``{"ok": true, "device": {...}}``.  Without a CUDA card the script exits
nonzero before printing a result.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import itertools
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
TF32_FLOPS_PER_S = 495e12

# kernel vs plain version: f32 sums over up to 1024 positions in another
# order (online softmax, tile-wise) — 1e-4 absolute on outputs of
# magnitude ~1; bf16 inputs are compared after the kernel rounds its
# output to bf16 (8 mantissa bits: ~4e-3 relative)
KERNEL_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# the weight-only int8 matmul vs its plain version: f32 sums over
# K <= 3072 in another order (outputs of magnitude ~1); bf16 x is compared
# after the kernel rounds its output to bf16
QMM_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# a greedy stream may leave the dense reference only where the
# reference's top-2 logit gap is below this: the engine and the dense
# ring sum the same f32 products in another order (chunked prefill,
# paged kernel), which moves logits by ~1e-5
NEAR_TIE_GAP = 1e-3
# int8 KV widens that: where the engine's and the dense ring's f32 K or V
# differ by an ulp across a quantization boundary, the stored int8
# differs by one quantum (the head's abs-max / 127) at that position,
# a far larger step than the f32 summation order — hence ten times the
# native limit
INT8_NEAR_TIE_GAP = 1e-2

# where the kernel phases place their tensors (a CPU rehearsal of the
# script's logic sets "cpu" and routes the wrappers to the plain versions)
DEVICE = "cuda"

GPT2_SMALL = dict(vocab_size=50304, hidden_size=768, num_layers=12,
                  num_heads=12, ffn_size=3072, max_seq_len=1024)
PROMPT_LENS = (16, 45, 77, 128, 190, 257, 333, 400)
NEW_TOKENS = 32


def free_cuda():
    """Collect the garbage, then hand the allocator's free blocks back to
    the card: a hapi ``Model`` and its train step's graph refer to each
    other, so only the collector frees the graph's memory pool."""
    gc.collect()
    torch.cuda.empty_cache()


def log(phase: str, **fields):
    print(f"[{phase}] " + json.dumps(fields, default=str), flush=True)


def entry_ptxas(lines, needle):
    """``-Xptxas -v`` lines of a build, per entry function whose mangled
    name holds ``needle``: its registers and spill line."""
    out, name = {}, None
    for ln in lines:
        if "Compiling entry function" in ln:
            name = ln.split("'")[1] if "'" in ln else ln
        elif name and needle in name and ("registers" in ln
                                          or "spill" in ln):
            out.setdefault(name, []).append(ln.split(":", 1)[-1].strip())
    return out


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------
# kernel phase
# --------------------------------------------------------------------------
def make_case(rng, *, G, Qb, H, D, P, M, lane_lens, row_gaps=None,
              dtype=torch.float32):
    """Random pools (trash page 0 included), distinct pages per lane and
    per-row lengths: row r of lane g sees lane_lens[g] - (Qb-1-r)
    positions (a prefill staircase); rows in row_gaps[g] are padding."""
    need = [-(-min(n, M * P) // P) for n in lane_lens]
    N = 1 + sum(need) + 3
    perm = rng.permutation(np.arange(1, N))
    pt = np.zeros((G, M), np.int32)
    at = 0
    for g in range(G):
        pt[g, :need[g]] = perm[at:at + need[g]]
        at += need[g]
    rl = np.zeros((G, Qb), np.int32)
    for g in range(G):
        for r in range(Qb):
            rl[g, r] = max(lane_lens[g] - (Qb - 1 - r), 0)
        for r in (row_gaps or {}).get(g, ()):
            rl[g, r] = 0
    q = torch.from_numpy(rng.randn(G, Qb, H, D).astype(np.float32))
    kp = torch.from_numpy(rng.randn(N, P, H, D).astype(np.float32))
    vp = torch.from_numpy(rng.randn(N, P, H, D).astype(np.float32))
    return (q.to(DEVICE, dtype), kp.to(DEVICE, dtype), vp.to(DEVICE, dtype),
            torch.from_numpy(pt).to(DEVICE), torch.from_numpy(rl).to(DEVICE))


def bound_ms(q, k_pages, page_tables, row_lens):
    """Least time for this call's work on an H100: the larger of the bytes
    it must move (q and out once, each lane's K and V positions below its
    horizon once — with int8 pools, also each used page's two [H] f32
    scale rows — the row lengths and the used table entries) over HBM
    bandwidth, and its f32 flops (q.k and p.v: 4*D per visible position,
    row and head) over the f32 CUDA-core peak."""
    G, Qb, H, D = q.shape
    P = k_pages.shape[1]
    M = page_tables.shape[1]
    item = q.element_size()
    rl = row_lens.clamp(max=M * P).cpu().numpy().astype(np.int64)
    horizon = rl.max(axis=1)
    pages = int(sum(-(-int(h) // P) for h in horizon))
    kv_bytes = int(horizon.sum()) * H * D * k_pages.element_size() * 2
    if k_pages.dtype == torch.int8:
        kv_bytes += pages * H * 4 * 2
    table_bytes = pages * 4
    io_bytes = 2 * q.numel() * item + row_lens.numel() * 4
    t_bytes = (kv_bytes + table_bytes + io_bytes) / HBM_BYTES_PER_S
    t_ops = int(rl.sum()) * H * D * 4 / F32_FLOPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def sdpa_inputs(q, k_pages, v_pages, page_tables, row_lens):
    """The yardstick's inputs: each lane's pages gathered into dense
    [G, H, S, D] K/V and a boolean [G, 1, Qb, S] visibility mask."""
    G, Qb, H, D = q.shape
    P = k_pages.shape[1]
    S = page_tables.shape[1] * P
    idx = page_tables.long()
    k = k_pages[idx].reshape(G, S, H, D).transpose(1, 2).contiguous()
    v = v_pages[idx].reshape(G, S, H, D).transpose(1, 2).contiguous()
    mask = (torch.arange(S, device=q.device)[None, None, None, :]
            < row_lens.long()[:, None, :, None])
    return q.transpose(1, 2).contiguous(), k, v, mask


def time_ms(fn, flush, reps=30, warmup=3):
    """Median device time of ``fn`` over ``reps`` runs (CUDA events), the
    L2 cache flushed before each run, as the serving step finds it (12
    layers' pools exceed the 50 MB L2).  A device-side sleep ahead of the
    start event keeps the card busy while the host enqueues ``fn``, so
    the events bracket device work only, not host launch latency."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


# the attention cases: the test width at three row counts, then
# GPT-2-small shapes — a decode batch and a prefill-chunk batch; then wide
# heads: D 128 and 160 at one, 8 and 64 rows a lane, and a decode batch
# and a prefill batch at D 256 with 8 heads (Gemma-2B's head width)
WIDE_LANES = dict(G=4, H=4, P=16, M=16, lane_lens=[0, 37, 130, 256],
                  row_gaps={3: [0]})
LONG_DECODE = [0, 1, 17, 100, 255, 512, 777, 1024]
LONG_PREFILL = dict(lane_lens=[0, 63, 130, 250, 401, 600, 900, 1024],
                    row_gaps={1: range(40, 64), 3: [5, 6, 7]})
# the forms' edges, from a generator of their own seed: GPT-2-small lanes at
# 15, 16 and 17 rows (the last decode-form row tile, the first prefill-form
# block, one row past it), and a page table wider than the stats kernel's
# 4096 pages (#1 has no such limit) at one row and at 16
EDGE_CASES = [
    (f"gpt2_qb{Qb}", dict(G=8, Qb=Qb, H=12, D=64, P=16, M=64,
                          lane_lens=LONG_PREFILL["lane_lens"],
                          row_gaps={3: [5, 6, 7]}))
    for Qb in (15, 16, 17)] + [
    (f"wide_table_qb{Qb}", dict(G=3, Qb=Qb, H=2, D=64, P=1, M=4100,
                                lane_lens=[0, 4100, 2501]))
    for Qb in (1, 16)]
EDGE_SEED = 12
ATTN_CASES = [("test", dict(G=3, Qb=Qb, H=2, D=16, P=4, M=5,
                            lane_lens=[0, 7, 19], row_gaps={2: [0]}))
              for Qb in (1, 3, 8)] + [
    ("gpt2_decode", dict(G=8, Qb=1, H=12, D=64, P=16, M=64,
                         lane_lens=LONG_DECODE)),
    ("gpt2_prefill", dict(G=8, Qb=64, H=12, D=64, P=16, M=64,
                          **LONG_PREFILL))] + [
    (f"d{D}", dict(WIDE_LANES, Qb=Qb, D=D))
    for D in (128, 160) for Qb in (1, 8, 64)] + [
    ("d256_decode", dict(G=8, Qb=1, H=8, D=256, P=16, M=64,
                         lane_lens=LONG_DECODE)),
    ("d256_prefill", dict(G=8, Qb=64, H=8, D=256, P=16, M=64,
                          **LONG_PREFILL))] + EDGE_CASES
TIMED = ("gpt2_decode", "gpt2_prefill", "d256_decode", "d256_prefill")
# cases from this head dim on run in bf16 too (the int8 phase: bf16 q),
# as gpt2_decode does, and draw from a generator of their own seed
WIDE_D, WIDE_SEED = 128, 11


def case_rngs(rng):
    """The generator each case of a phase draws its inputs from, by name
    and shape: ``rng``, or, from head dim WIDE_D on, one of WIDE_SEED, and
    for EDGE_CASES one of EDGE_SEED, so that the other cases and the
    phases after them see the draws they saw before those cases
    existed."""
    wide = np.random.RandomState(WIDE_SEED)
    edge = np.random.RandomState(EDGE_SEED)
    edges = {name for name, _ in EDGE_CASES}
    return lambda name, kw: (edge if name in edges
                             else wide if kw["D"] >= WIDE_D else rng)


def _tag(name, kw, dtype):
    return f"{name}/{str(dtype).split('.')[-1]}/Qb{kw['Qb']}"


def _check_close(phase, tag, out, ref, row_lens, tol, **extra):
    err = float((out.float() - ref).abs().max())
    zeros_exact = bool((out[row_lens == 0] == 0).all())
    ok = math.isfinite(err) and err <= tol and zeros_exact
    log(phase, case=tag, max_abs_err=err, tol=tol,
        empty_rows_exact_zero=zeros_exact, ok=ok, **extra)
    if not ok:
        raise AssertionError(f"{phase}: kernel disagrees with its plain "
                             f"version on {tag} {extra}: max_abs_err {err} "
                             f"(tol {tol}), empty rows exact zero: "
                             f"{zeros_exact}")
    return err


def lane_equal_alone(fn, args, **kw) -> bool:
    """Whether each lane (each row, for the per-row kernel) launched alone
    gives the bits it gives inside ``args``'s batch: q, the page table and
    the lengths (args 0, 3 and 4 of both layouts) cut to that lane, the
    pools and scales as they are."""
    full = fn(*args, **kw)
    for g in range(args[0].shape[0]):
        one = fn(*(a[g:g + 1] if i in (0, 3, 4) else a
                   for i, a in enumerate(args)), **kw)
        if not torch.equal(one[0], full[g]):
            return False
    return True


def _require_lane_equal(phase, tag, t):
    if not t["lane_equal_alone"]:
        raise AssertionError(f"{phase}: a lane of {tag} launched alone "
                             "differs from the same lane in the batch")


def kernel_phase(rng, flush) -> dict:
    from paddle_tpu_torch.ops import paged_attention as pa

    runs = [(name, kw, torch.float32) for name, kw in ATTN_CASES]
    runs += [(name, kw, torch.bfloat16) for name, kw in ATTN_CASES
             if name == "gpt2_decode" or kw["D"] >= WIDE_D]
    checked = {}
    rng_of = case_rngs(rng)
    for name, kw, dtype in runs:
        args = make_case(rng_of(name, kw), dtype=dtype, **kw)
        out = pa.ragged_paged_attention_cuda(*args)
        torch.cuda.synchronize()
        ref = pa.ragged_paged_attention_ref(
            *(a.float() if a.is_floating_point() else a for a in args))
        tag = _tag(name, kw, dtype)
        checked[tag] = (args, _check_close("kernel", tag, out, ref, args[4],
                                           KERNEL_TOL[dtype]))

    timings = {"bf16_max_abs_err": checked["gpt2_decode/bfloat16/Qb1"][1]}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for name in TIMED:
        tag = f"{name}/float32/Qb{dict(ATTN_CASES)[name]['Qb']}"
        args, err = checked[tag]
        q_d, k_d, v_d, mask = sdpa_inputs(*args)
        valid = args[4] > 0
        lib_out = sdpa(q_d, k_d, v_d, attn_mask=mask).transpose(1, 2)
        ref = pa.ragged_paged_attention_ref(*args)
        t = {"max_abs_err": err,
             "library_max_abs_err": float(
                 (lib_out[valid] - ref[valid]).abs().max()),
             "ms": time_ms(lambda: pa.ragged_paged_attention_cuda(*args),
                           flush),
             "plain_ms": time_ms(
                 lambda: pa.ragged_paged_attention_ref(*args), flush),
             "library_ms": time_ms(
                 lambda: sdpa(q_d, k_d, v_d, attn_mask=mask), flush),
             "lane_equal_alone": lane_equal_alone(
                 pa.ragged_paged_attention_cuda, args)}
        t["bound_ms"], t["bound_by"] = bound_ms(args[0], args[1], args[3],
                                                args[4])
        log("kernel_time", case=tag, **t)
        _require_lane_equal("kernel", tag, t)
        timings[tag] = t
    return timings


def quantize_pools(k_pages, v_pages):
    """Pools quantized per (page, head) as the dynamic write path leaves
    a full page: scale = abs-max / 127 (floored), int8 = round(x / s)."""
    def quant(pool):
        x = pool.float()
        sc = (x.abs().amax(dim=(1, 3)) / 127.0).clamp(min=1e-8)
        q = torch.round(x / sc[:, None, :, None]).clamp(-127, 127)
        return q.to(torch.int8).contiguous(), sc.contiguous()

    kq, ks = quant(k_pages)
    vq, vs = quant(v_pages)
    return kq, vq, ks, vs


def int8_kernel_phase(rng, flush) -> dict:
    """Body #1q against its plain version in both fused_dequant settings
    (f32 q; bf16 q once), the NaN-scale case, and the decode/prefill
    timings of both settings."""
    from paddle_tpu_torch.ops import paged_attention as pa

    runs = [(name, kw, torch.float32, fused) for name, kw in ATTN_CASES
            for fused in (1, 0)]
    runs += [(name, kw, torch.bfloat16, fused) for name, kw in ATTN_CASES
             if name == "gpt2_decode" or kw["D"] >= WIDE_D
             for fused in (1, 0)]
    checked = {}
    rng_of = case_rngs(rng)
    for name, kw, dtype, fused in runs:
        q, kp, vp, pt, rl = make_case(rng_of(name, kw), dtype=dtype, **kw)
        kq, vq, ks, vs = quantize_pools(kp, vp)
        args = (q, kq, vq, pt, rl, ks, vs)
        out = pa.ragged_paged_attention_cuda(*args, fused_dequant=fused)
        torch.cuda.synchronize()
        ref = pa.ragged_paged_attention_ref(q.float(), *args[1:])
        tag = f"{_tag(name, kw, dtype)}/fused_dequant={fused}"
        checked[tag] = (args, _check_close("kernel_int8", tag, out, ref, rl,
                                           KERNEL_TOL[dtype]))

    # a NaN in one K scale row: non-finite exactly on the rows that read
    # that page (lane 5, horizon 512, reads page 3 = positions 48..63)
    nan_ok = {}
    for fused in (1, 0):
        args = list(checked[f"gpt2_decode/float32/Qb1/fused_dequant="
                            f"{fused}"][0])
        ks = args[5].clone()
        lane, head = 5, 7
        ks[int(args[3][lane, 3]), head] = float("nan")
        args[5] = ks
        out = pa.ragged_paged_attention_cuda(*args, fused_dequant=fused)
        ref = pa.ragged_paged_attention_ref(*args)
        torch.cuda.synchronize()
        bad = ~torch.isfinite(out).all(dim=-1)
        want = torch.zeros_like(bad)
        want[lane, 0, head] = True
        fin = ~bad[..., None].expand_as(out)
        err = float((out[fin] - ref[fin]).abs().max())
        ok = (torch.equal(bad, want)
              and torch.equal(~torch.isfinite(ref).all(dim=-1), want)
              and err <= KERNEL_TOL[torch.float32])
        log("kernel_int8", case="gpt2_decode/nan_k_scale", fused_dequant=fused,
            non_finite_rows=int(bad.sum()), max_abs_err_elsewhere=err, ok=ok)
        if not ok:
            raise AssertionError(f"NaN k_scale (fused_dequant={fused}): "
                                 f"non-finite at {bad.nonzero().tolist()}, "
                                 f"expected only {want.nonzero().tolist()}; "
                                 f"error elsewhere {err}")
        nan_ok[fused] = ok

    sdpa = torch.nn.functional.scaled_dot_product_attention
    timings = {"nan_scale_ok": all(nan_ok.values()),
               "bf16_max_abs_err": max(
                   checked[f"gpt2_decode/bfloat16/Qb1/fused_dequant={f}"][1]
                   for f in (1, 0))}
    for name in TIMED:
        for fused in (1, 0):
            tag = (f"{name}/float32/Qb{dict(ATTN_CASES)[name]['Qb']}"
                   f"/fused_dequant={fused}")
            args, err = checked[tag]
            q, kq, vq, pt, rl, ks, vs = args
            kd = kq.float() * ks[:, None, :, None]
            vd = vq.float() * vs[:, None, :, None]
            q_d, k_d, v_d, mask = sdpa_inputs(q, kd, vd, pt, rl)
            t = {"max_abs_err": err,
                 "ms": time_ms(lambda: pa.ragged_paged_attention_cuda(
                     *args, fused_dequant=fused), flush),
                 "plain_ms": time_ms(
                     lambda: pa.ragged_paged_attention_ref(*args), flush),
                 "library_ms": time_ms(
                     lambda: sdpa(q_d, k_d, v_d, attn_mask=mask), flush),
                 "lane_equal_alone": lane_equal_alone(
                     pa.ragged_paged_attention_cuda, args,
                     fused_dequant=fused)}
            t["bound_ms"], t["bound_by"] = bound_ms(q, kq, pt, rl)
            log("kernel_int8_time", case=tag, **t)
            _require_lane_equal("kernel_int8", tag, t)
            timings[tag] = t
    return timings


# the per-row kernel's cases: the test width, GPT-2-small decode rows
# (one table row each) and a GPT-2-small prefill chunk: 64 rows of one
# sequence at positions 448..511 sharing its table row, the tail padded
# past the prompt's 500 positions; then wide heads, D 128 and 160 rows and
# D 256 decode rows with 8 heads
DECODE_CASES = [
    ("test", dict(H=2, D=16, P=4, M=5, lens=[0, 1, 7, 19, 20])),
    ("gpt2_decode", dict(H=12, D=64, P=16, M=64, lens=LONG_DECODE)),
    ("gpt2_chunk", dict(H=12, D=64, P=16, M=64, chunk=(448, 64, 500)))] + [
    (f"d{D}", dict(H=4, D=D, P=16, M=16, lens=[0, 1, 37, 130, 255, 256]))
    for D in (128, 160)] + [
    ("d256_decode", dict(H=8, D=256, P=16, M=64, lens=LONG_DECODE))]
DECODE_TIMED = ("gpt2_decode", "gpt2_chunk", "d256_decode")


def make_rows(rng, *, H, D, P, M, lens=None, chunk=None,
              dtype=torch.float32):
    """Per-row inputs: q [B, H, D], random pools (trash page 0 included),
    one table row and one length per row.  ``lens``: one sequence per
    row with distinct pages; ``chunk=(off, C, valid)``: C rows of one
    sequence sharing its table row, row r seeing min(off + r + 1, valid)
    positions."""
    if chunk is not None:
        off, C, valid = chunk
        seq_lens = np.minimum(off + np.arange(C) + 1, valid)
        seqs = [valid]
    else:
        seq_lens = np.asarray(lens)
        seqs = list(lens)
    need = [-(-min(n, M * P) // P) for n in seqs]
    N = 1 + sum(need) + 3
    perm = rng.permutation(np.arange(1, N))
    pt = np.zeros((len(seqs), M), np.int32)
    at = 0
    for b, n in enumerate(need):
        pt[b, :n] = perm[at:at + n]
        at += n
    if chunk is not None:
        pt = np.repeat(pt, len(seq_lens), axis=0)
    B = len(seq_lens)
    q = torch.from_numpy(rng.randn(B, H, D).astype(np.float32))
    kp = torch.from_numpy(rng.randn(N, P, H, D).astype(np.float32))
    vp = torch.from_numpy(rng.randn(N, P, H, D).astype(np.float32))
    return (q.to(DEVICE, dtype), kp.to(DEVICE, dtype), vp.to(DEVICE, dtype),
            torch.from_numpy(pt).to(DEVICE),
            torch.from_numpy(seq_lens.astype(np.int32)).to(DEVICE))


def rows_bound_ms(q, k_pages, page_tables, seq_lens):
    """Least time for a per-row call on an H100: the larger of its bytes
    (q and out once; each distinct (page, slot) some row reads below its
    length once, K and V — rows sharing a table row read the same
    positions — with int8 pools each distinct page's two [H] f32 scale
    rows; the lengths and the used table entries) over HBM bandwidth,
    and its f32 flops (4*D per visible position, row and head) over the
    f32 CUDA-core peak."""
    B, H, D = q.shape
    P = k_pages.shape[1]
    M = page_tables.shape[1]
    pt = page_tables.cpu().numpy()
    lens = seq_lens.clamp(max=M * P).cpu().numpy().astype(np.int64)
    slots, pages = set(), set()
    for b in range(B):
        for j in range(-(-int(lens[b]) // P)):
            n = min(P, int(lens[b]) - j * P)
            slots.update((int(pt[b, j]), s) for s in range(n))
            pages.add(int(pt[b, j]))
    kv_bytes = len(slots) * H * D * k_pages.element_size() * 2
    if k_pages.dtype == torch.int8:
        kv_bytes += len(pages) * H * 4 * 2
    table_bytes = int(sum(-(-int(n) // P) for n in lens)) * 4
    io_bytes = 2 * q.numel() * q.element_size() + B * 4
    t_bytes = (kv_bytes + table_bytes + io_bytes) / HBM_BYTES_PER_S
    t_ops = int(lens.sum()) * H * D * 4 / F32_FLOPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _decode_timings(pa, tag, args, kernel, plain, err, flush, fused=1):
    """One timed case of the per-row kernel: its time beside its bound,
    the plain version, SDPA over each row's gathered dense KV, and the
    ragged kernel on the same inputs at one row per lane (and, for a
    shared table row, as one lane of B rows); each row launched alone
    bit-equal to the same row in the batch."""
    q, kp, vp, pt, sl = args[:5]
    scales = args[5:]
    if scales:
        kd = kp.float() * scales[0][:, None, :, None]
        vd = vp.float() * scales[1][:, None, :, None]
    else:
        kd, vd = kp, vp
    q_d, k_d, v_d, mask = sdpa_inputs(q[:, None], kd, vd, pt, sl[:, None])
    sdpa = torch.nn.functional.scaled_dot_product_attention
    t = {"max_abs_err": err, "ms": time_ms(kernel, flush),
         "plain_ms": time_ms(plain, flush),
         "library_ms": time_ms(lambda: sdpa(q_d, k_d, v_d, attn_mask=mask),
                               flush),
         "ragged_qb1_ms": time_ms(
             lambda: pa.ragged_paged_attention_cuda(
                 q[:, None], kp, vp, pt, sl[:, None], *scales), flush)}
    if bool((pt == pt[:1]).all()):
        t["ragged_one_lane_ms"] = time_ms(
            lambda: pa.ragged_paged_attention_cuda(
                q[None], kp, vp, pt[:1], sl[None], *scales), flush)
    t["lane_equal_alone"] = lane_equal_alone(
        pa.paged_attention_cuda, args,
        **({"fused_dequant": fused} if scales else {}))
    t["bound_ms"], t["bound_by"] = rows_bound_ms(q, kp, pt, sl)
    log("kernel_decode_time", case=tag, **t)
    _require_lane_equal("kernel_decode", tag, t)
    return t


def decode_kernel_phase(rng, flush) -> dict:
    """Bodies #2 and #2q against their plain version: f32 at every case
    (#2q in both fused_dequant settings), bf16 once at decode, NaN scale
    rows at decode and in the chunk; then the timed cases."""
    from paddle_tpu_torch.ops import paged_attention as pa

    checked = {}
    rng_of = case_rngs(rng)
    for name, kw in DECODE_CASES:
        dtypes = ((torch.float32, torch.bfloat16)
                  if name == "gpt2_decode" or kw["D"] >= WIDE_D
                  else (torch.float32,))
        for dtype in dtypes:
            args = make_rows(rng_of(name, kw), dtype=dtype, **kw)
            dt = str(dtype).split(".")[-1]
            ref = pa.paged_attention_ref(
                *(a.float() if a.is_floating_point() else a for a in args))
            out = pa.paged_attention_cuda(*args)
            torch.cuda.synchronize()
            tag = f"{name}/{dt}"
            checked[tag] = (args, _check_close(
                "kernel_decode", tag, out, ref, args[4], KERNEL_TOL[dtype]))
            q, kq, vq, ks, vs = (args[0],) + quantize_pools(*args[1:3])
            iargs = (q, kq, vq, args[3], args[4], ks, vs)
            ref = pa.paged_attention_ref(q.float(), *iargs[1:])
            for fused in (1, 0):
                out = pa.paged_attention_cuda(*iargs, fused_dequant=fused)
                torch.cuda.synchronize()
                itag = f"{tag}/int8/fused_dequant={fused}"
                checked[itag] = (iargs, _check_close(
                    "kernel_decode", itag, out, ref, args[4],
                    KERNEL_TOL[dtype]))

    # a NaN in one K scale row: non-finite exactly on the rows that read
    # that page below their length — decode row 5 (length 512) reads its
    # page 3; chunk rows read page 30 (positions 480..495) from row 32 on
    nan_ok = {}
    for name, pick, readers in (
            ("gpt2_decode", lambda pt: int(pt[5, 3]), lambda sl: (
                torch.arange(len(sl), device=sl.device) == 5)),
            ("gpt2_chunk", lambda pt: int(pt[0, 30]), lambda sl: sl > 480)):
        for fused in (1, 0):
            args = list(checked[f"{name}/float32/int8/fused_dequant="
                                f"{fused}"][0])
            ks = args[5].clone()
            head = 7
            ks[pick(args[3]), head] = float("nan")
            args[5] = ks
            out = pa.paged_attention_cuda(*args, fused_dequant=fused)
            ref = pa.paged_attention_ref(*args)
            torch.cuda.synchronize()
            bad = ~torch.isfinite(out).all(dim=-1)             # [B, H]
            want = torch.zeros_like(bad)
            want[:, head] = readers(args[4])
            fin = ~bad[..., None].expand_as(out)
            err = float((out[fin] - ref[fin]).abs().max())
            ok = (bool(want.any()) and torch.equal(bad, want)
                  and torch.equal(~torch.isfinite(ref).all(dim=-1), want)
                  and err <= KERNEL_TOL[torch.float32])
            log("kernel_decode", case=f"{name}/nan_k_scale",
                fused_dequant=fused, non_finite_rows=int(bad.sum()),
                readers=int(want.sum()), max_abs_err_elsewhere=err, ok=ok)
            if not ok:
                raise AssertionError(
                    f"NaN k_scale ({name}, fused_dequant={fused}): "
                    f"non-finite at {bad.nonzero().tolist()}, expected "
                    f"{want.nonzero().tolist()}; error elsewhere {err}")
            nan_ok[f"{name}/fused_dequant={fused}"] = ok

    timings = {"nan_scale_ok": all(nan_ok.values()),
               "bf16_max_abs_err": checked["gpt2_decode/bfloat16"][1],
               "int8_bf16_max_abs_err": max(
                   checked[f"gpt2_decode/bfloat16/int8/fused_dequant={f}"][1]
                   for f in (1, 0))}
    for name in DECODE_TIMED:
        tag = f"{name}/float32"
        args, err = checked[tag]
        timings[tag] = _decode_timings(
            pa, tag, args, lambda: pa.paged_attention_cuda(*args),
            lambda: pa.paged_attention_ref(*args), err, flush)
        for fused in (1, 0):
            itag = f"{tag}/int8/fused_dequant={fused}"
            iargs, err = checked[itag]
            timings[itag] = _decode_timings(
                pa, itag, iargs,
                lambda: pa.paged_attention_cuda(*iargs,
                                                fused_dequant=fused),
                lambda: pa.paged_attention_ref(*iargs), err, flush, fused)
    return timings


# the stats form's cases (a sequence shard of the serving mesh): GPT-2-small
# shard shapes — H 6 (12 heads at tp 2) and 12 — decode 8 lanes x 1 row,
# prefill 8 lanes x 64 rows; every second table entry owned, lane 2 owns
# nothing, lane 0 is empty
STATS_LANES = {
    "decode": (1, [0, 1, 300, 100, 255, 512, 777, 1024], None),
    "prefill": (64, [0, 63, 400, 250, 401, 600, 900, 1024],
                {1: range(40, 64), 3: [5, 6, 7]})}
# wide heads over 16 pages a lane: the warp form at 1 and 8 rows, the
# prefill form at 64
WIDE_STATS_LANES = {
    "decode": (1, [0, 1, 75, 25, 63, 128, 194, 256], None),
    "rows8": (8, [0, 9, 75, 25, 63, 128, 194, 256], None),
    "prefill": (64, [0, 63, 100, 70, 100, 150, 225, 256],
                {1: range(40, 64), 3: [5, 6, 7]})}
STATS_CASES = [
    (f"{kind}_h{H}", dict(G=8, Qb=Qb, H=H, D=64, P=16, M=64,
                          lane_lens=lens, row_gaps=gaps))
    for H in (12, 6) for kind, (Qb, lens, gaps) in STATS_LANES.items()] + [
    (f"d{D}_{kind}", dict(G=8, Qb=Qb, H=4, D=D, P=16, M=16,
                          lane_lens=lens, row_gaps=gaps))
    for D in (128, 160)
    for kind, (Qb, lens, gaps) in WIDE_STATS_LANES.items()] + [
    (f"d256_{kind}", dict(G=8, Qb=Qb, H=8, D=256, P=16, M=64,
                          lane_lens=lens, row_gaps=gaps))
    for kind, (Qb, lens, gaps) in STATS_LANES.items()]
# prefill_h6 is the mesh drive's shard shape (12 heads at tp 2)
STATS_TIMED = ("decode_h12", "prefill_h12", "prefill_h6", "d256_decode",
               "d256_prefill")
# the stats kernel vs its plain version: o within 1e-6 in f32 (the same
# f32 products over at most 512 owned positions in another order; the
# int8 body scales after the dot where the plain version dequantizes
# before it) and 2e-2 in bf16 (the kernel rounds o to bf16), both times
# max(1, the largest reference value); lse within 1e-5
STATS_TOL = {torch.float32: 1e-6, torch.bfloat16: 2e-2}
LSE_TOL = 1e-5
STATS_NO_OWNER = 2


def stats_page_ok(page_tables):
    """Every second table entry owned; lane STATS_NO_OWNER owns none."""
    ok = (torch.arange(page_tables.shape[1], device=page_tables.device)
          % 2 == 0).to(torch.int32)[None, :].repeat(page_tables.shape[0], 1)
    ok[STATS_NO_OWNER] = 0
    return ok.contiguous()


def stats_bound_ms(q, k_pages, page_tables, row_lens, page_ok):
    """Least time for a stats call on an H100: the larger of its bytes (q
    and o once, lse, each lane's K and V positions below its horizon on
    OWNED pages once — with int8 pools each such page's two [H] f32
    scale rows — the row lengths, the table and ownership entries) over
    HBM bandwidth, and its f32 flops (4*D per visible position, row and
    head) over the f32 CUDA-core peak."""
    G, Qb, H, D = q.shape
    P = k_pages.shape[1]
    M = page_tables.shape[1]
    rl = row_lens.clamp(max=M * P).cpu().numpy().astype(np.int64)
    ok = page_ok.cpu().numpy() != 0
    pos_owned = np.repeat(ok, P, axis=1)                      # [G, M*P]
    horizon = rl.max(axis=1)
    below = np.arange(M * P)[None, :] < horizon[:, None]
    positions = int((pos_owned & below).sum())
    pages = int(sum(ok[g, :-(-int(h) // P)].sum() for g, h in
                    enumerate(horizon)))
    kv_bytes = positions * H * D * k_pages.element_size() * 2
    if k_pages.dtype == torch.int8:
        kv_bytes += pages * H * 4 * 2
    io_bytes = (2 * q.numel() * q.element_size() + G * Qb * H * 4
                + row_lens.numel() * 4 + 2 * int(sum(
                    -(-int(h) // P) for h in horizon)) * 4)
    visible = int(sum(((np.arange(M * P)[None, :] < rl[g][:, None])
                       & pos_owned[g][None, :]).sum() for g in range(G)))
    t_bytes = (kv_bytes + io_bytes) / HBM_BYTES_PER_S
    t_ops = visible * H * D * 4 / F32_FLOPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def stats_library_inputs(q, k_pages, v_pages, page_tables, row_lens,
                         page_ok):
    """The yardstick's inputs: each lane's owned table entries below its
    longest row, in table order, gathered into dense [G, H, S, D] K/V (S
    the most any lane owns; shorter lanes padded with page 0), and an
    additive [G, H, Qb, S] bias hiding the positions a row does not see
    and the padding."""
    G, Qb, H, D = q.shape
    P = k_pages.shape[1]
    M = page_tables.shape[1]
    horizon = row_lens.long().amax(dim=1)                       # [G]
    own = (page_ok != 0) & (torch.arange(M, device=q.device)[None, :] * P
                            < horizon[:, None])                 # [G, M]
    n = max(int(own.sum(dim=1).max()), 1)
    # owned entries first, in table order
    ent = torch.sort((~own).to(torch.int32), dim=1,
                     stable=True).indices[:, :n]                # [G, n]
    real = torch.gather(own, 1, ent)
    idx = torch.gather(page_tables.long(), 1, ent) * real
    S = n * P
    k = k_pages[idx].reshape(G, S, H, D).transpose(1, 2).contiguous()
    v = v_pages[idx].reshape(G, S, H, D).transpose(1, 2).contiguous()
    pos = (ent[:, :, None] * P + torch.arange(P, device=q.device)).reshape(
        G, S)
    see = (pos[:, None, :] < row_lens.long()[:, :, None]) \
        & real.repeat_interleave(P, dim=1)[:, None, :]          # [G, Qb, S]
    bias = torch.where(see, 0.0, -1e30).to(q.dtype)[:, None].expand(
        G, H, Qb, S).contiguous()
    return q.transpose(1, 2).contiguous(), k, v, bias


def _check_stats(tag, o, lse, ref_o, ref_lse, row_lens, page_ok, tol,
                 **extra):
    err = float((o.float() - ref_o.float()).abs().max())
    limit = tol * max(1.0, float(ref_o.abs().max()))
    lse_err = float((lse - ref_lse).abs().max())
    empty = (row_lens == 0) | ~(page_ok != 0).any(dim=1)[:, None]
    zeros_exact = bool((o[empty] == 0).all())
    neg_inf = bool((lse[empty] == -1e30).all())
    ok = (math.isfinite(err) and err <= limit and lse_err <= LSE_TOL
          and zeros_exact and neg_inf and bool(empty.any()))
    log("kernel_stats", case=tag, max_abs_err=err, lse_max_abs_err=lse_err,
        limit=limit, lse_tol=LSE_TOL, empty_rows=int(empty.sum()),
        empty_rows_exact_zero=zeros_exact, empty_rows_lse_neg_inf=neg_inf,
        ok=ok, **extra)
    if not ok:
        raise AssertionError(
            f"kernel_stats: the stats kernel disagrees with its plain "
            f"version on {tag} {extra}: o err {err} (limit {limit}), lse err "
            f"{lse_err} (tol {LSE_TOL}), empty rows zero {zeros_exact}, "
            f"lse -1e30 {neg_inf}")
    return err


def stats_kernel_phase(rng, flush) -> dict:
    """Bodies #3 and #3q against their plain version: f32 and bf16 at
    every case, #3q in both fused_dequant settings, NaN K scale rows on an
    owned and on an unowned page; then the timed cases beside their
    bound, the plain version and the memory-efficient SDPA kernel with
    its log-sum-exp on the gathered owned KV."""
    from paddle_tpu_torch.ops import paged_attention as pa

    checked = {}
    rng_of = case_rngs(rng)
    for name, kw in STATS_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            q, kp, vp, pt, rl = make_case(rng_of(name, kw), dtype=dtype, **kw)
            ok = stats_page_ok(pt)
            dt = str(dtype).split(".")[-1]
            args = (q, kp, vp, pt, rl, ok)
            o, lse = pa.ragged_paged_attention_stats_cuda(*args)
            torch.cuda.synchronize()
            ref_o, ref_lse = pa.ragged_paged_attention_stats_ref(
                *(a.float() if a.is_floating_point() else a for a in args))
            tag = f"{name}/{dt}"
            checked[tag] = (args, _check_stats(tag, o, lse, ref_o, ref_lse,
                                               rl, ok, STATS_TOL[dtype]))
            kq, vq, ks, vs = quantize_pools(kp, vp)
            iargs = (q, kq, vq, pt, rl, ok, ks, vs)
            ref_o, ref_lse = pa.ragged_paged_attention_stats_ref(
                q.float(), *iargs[1:])
            for fused in (1, 0):
                o, lse = pa.ragged_paged_attention_stats_cuda(
                    *iargs, fused_dequant=fused)
                torch.cuda.synchronize()
                itag = f"{tag}/int8/fused_dequant={fused}"
                checked[itag] = (iargs, _check_stats(
                    itag, o, lse, ref_o, ref_lse, rl, ok, STATS_TOL[dtype]))

    # NaN K scale rows: on lane 4's owned entry 2 (positions 32..47) the
    # NaN reaches exactly the rows that read it; on its unowned entry 3
    # nobody (the kernel never reads a page its shard does not own)
    nan_ok = {}
    for name in ("decode_h12", "prefill_h12"):
        for fused in (1, 0):
            args = list(checked[f"{name}/float32/int8/fused_dequant="
                                f"{fused}"][0])
            pt, rl = args[3], args[4]
            ks = args[6].clone()
            head = 7
            ks[int(pt[4, 2]), head] = float("nan")
            ks[int(pt[4, 3]), head + 1] = float("nan")
            args[6] = ks
            o, lse = pa.ragged_paged_attention_stats_cuda(
                *args, fused_dequant=fused)
            ref_o, ref_lse = pa.ragged_paged_attention_stats_ref(*args)
            torch.cuda.synchronize()
            bad = ~torch.isfinite(o).all(dim=-1)               # [G, Qb, H]
            want = torch.zeros_like(bad)
            want[4, :, head] = rl[4] > 32
            fin = ~bad[..., None].expand_as(o)
            err = float((o[fin] - ref_o[fin]).abs().max())
            limit = STATS_TOL[torch.float32] * max(
                1.0, float(ref_o[fin].abs().max()))
            good = (bool(want.any()) and torch.equal(bad, want)
                    and torch.equal(~torch.isfinite(ref_o).all(dim=-1), want)
                    and err <= limit)
            log("kernel_stats", case=f"{name}/nan_k_scale",
                fused_dequant=fused, non_finite_rows=int(bad.sum()),
                readers=int(want.sum()), max_abs_err_elsewhere=err, ok=good)
            if not good:
                raise AssertionError(
                    f"NaN k_scale ({name}, fused_dequant={fused}): "
                    f"non-finite at {bad.nonzero().tolist()}, expected "
                    f"{want.nonzero().tolist()}; error elsewhere {err}")
            nan_ok[f"{name}/fused_dequant={fused}"] = good

    efficient = torch.ops.aten._scaled_dot_product_efficient_attention
    timings = {"nan_scale_ok": all(nan_ok.values()),
               "bf16_max_abs_err": max(v[1] for k, v in checked.items()
                                       if "bfloat16" in k
                                       and "int8" not in k),
               "int8_bf16_max_abs_err": max(v[1] for k, v in checked.items()
                                            if "bfloat16/int8" in k),
               "max_abs_err_by_case": {k: v[1] for k, v in checked.items()}}
    for name in STATS_TIMED:
        for tag in (f"{name}/float32", f"{name}/float32/int8/fused_dequant=1",
                    f"{name}/float32/int8/fused_dequant=0"):
            args, err = checked[tag]
            fused = 0 if tag.endswith("=0") else 1
            q, kp, vp, pt, rl, ok = args[:6]
            scales = args[6:]
            if scales:
                kd = kp.float() * scales[0][:, None, :, None]
                vd = vp.float() * scales[1][:, None, :, None]
            else:
                kd, vd = kp, vp
            lq, lk, lv, bias = stats_library_inputs(q, kd, vd, pt, rl, ok)
            t = {"max_abs_err": err,
                 "ms": time_ms(lambda: pa.ragged_paged_attention_stats_cuda(
                     *args, fused_dequant=fused), flush),
                 "plain_ms": time_ms(
                     lambda: pa.ragged_paged_attention_stats_ref(*args),
                     flush),
                 "library_ms": time_ms(
                     lambda: efficient(lq, lk, lv, bias, True), flush),
                 "ragged_all_pages_ms": time_ms(
                     lambda: pa.ragged_paged_attention_cuda(
                         q, kp, vp, pt, rl, *scales), flush)}
            t["bound_ms"], t["bound_by"] = stats_bound_ms(q, kp, pt, rl, ok)
            # ownership in runs, as the allocator hands a shard its pages
            # (each lane owns the first half of its table), beside the
            # interleaved pattern above: the kernel walks owned pages, so
            # both should cost what their owned positions cost
            runs = (torch.arange(pt.shape[1], device=pt.device)[None, :]
                    < pt.shape[1] // 2).to(torch.int32).repeat(
                        pt.shape[0], 1).contiguous()
            rargs = (q, kp, vp, pt, rl, runs) + tuple(scales)
            t["owned_runs_ms"] = time_ms(
                lambda: pa.ragged_paged_attention_stats_cuda(
                    *rargs, fused_dequant=fused), flush)
            t["owned_runs_bound_ms"] = stats_bound_ms(q, kp, pt, rl,
                                                      runs)[0]
            lq, lk, lv, bias = stats_library_inputs(q, kd, vd, pt, rl, runs)
            t["owned_runs_library_ms"] = time_ms(
                lambda: efficient(lq, lk, lv, bias, True), flush)
            log("kernel_stats_time", case=tag, **t)
            timings[tag] = t

    # the prefill form's threshold: the mesh shard shape one row below it
    # (the warp form: two 8-row blocks a lane) and at it (one 16-row
    # block); own seed, so later phases see the same draws
    thr_rng = np.random.RandomState(9)
    thr = {}
    for Qb in (pa.STATS_PREFILL_ROWS - 1, pa.STATS_PREFILL_ROWS):
        kw = dict(dict(STATS_CASES)["prefill_h6"], Qb=Qb, row_gaps=None)
        targs = make_case(thr_rng, **kw)
        targs = targs + (stats_page_ok(targs[3]),)
        thr[f"Qb{Qb}_ms"] = time_ms(
            lambda: pa.ragged_paged_attention_stats_cuda(*targs), flush)
    log("kernel_stats_time", case="threshold_h6/float32", **thr)
    timings["threshold_h6/float32"] = thr
    return timings


# the serving path's weight shapes (q/k/v/out share 768x768) and an odd
# shape for the edges (N not a multiple of 4: byte-wise weight loads)
QMM_SHAPES = {"proj_768x768": (768, 768), "fc1_768x3072": (768, 3072),
              "fc2_3072x768": (3072, 768), "odd_45x70": (45, 70)}
# M: decode rows (1, 8, 16: the decode form), the boundary (17), a ragged
# step of 8 decode rows beside a 64-row prefill chunk (72) and prefill
# chunks (37, 512: the prefill form); QMM_TIMED in f32
QMM_M = (1, 8, 16, 17, 37, 72, 512)
QMM_TIMED = (1, 8, 16, 512)


def qmm_bound_ms(M, K, N, item):
    """Least time on an H100: x, the int8 weight, its scales and the
    output moved once over HBM bandwidth, or 2*M*K*N f32 operations over
    the f32 CUDA-core peak, whichever is larger."""
    t_bytes = (M * K * item + K * N + N * 4 + M * N * item) / HBM_BYTES_PER_S
    t_ops = 2 * M * K * N / F32_FLOPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def qmm_phase(rng, flush) -> dict:
    """Body #4 against its plain version at every shape, M and dtype, a
    middle row bit-equal to the same row launched alone (the canonical
    summation order); timings at QMM_TIMED in f32."""
    from paddle_tpu_torch.ops import quantized_matmul as qm

    timings = {}
    for sname, (K, N) in QMM_SHAPES.items():
        wq = torch.from_numpy(rng.randint(-127, 128, (K, N)).astype(
            np.int8)).to(DEVICE)
        ws = torch.from_numpy((rng.rand(N) * 0.04 / 127 + 1e-5).astype(
            np.float32)).to(DEVICE)
        w_deq = wq.float() * ws[None, :]
        for M in QMM_M:
            xf = torch.from_numpy(rng.randn(M, K).astype(np.float32)).to(
                DEVICE)
            for dtype in (torch.float32, torch.bfloat16):
                x = xf.to(dtype)
                out = qm.quantized_matmul_cuda(x, wq, ws)
                r = M // 2
                one = qm.quantized_matmul_cuda(x[r:r + 1].contiguous(), wq,
                                               ws)
                torch.cuda.synchronize()
                ref = qm.quantized_matmul_ref(x.float(), wq, ws)
                tol = QMM_TOL[dtype]
                err = float((out.float() - ref).abs().max())
                scale = float(ref.abs().max())
                row_equal = bool(torch.equal(one[0], out[r]))
                ok = (math.isfinite(err) and err <= tol * max(1.0, scale)
                      and row_equal)
                tag = f"{sname}/M{M}/{str(dtype).split('.')[-1]}"
                log("kernel_qmm", case=tag, form=qm.qmm_form(M),
                    max_abs_err=err, max_abs_ref=scale, tol=tol,
                    row_equal_alone=row_equal, ok=ok)
                if not ok:
                    raise AssertionError(
                        f"quantized matmul disagrees with its plain version "
                        f"on {tag}: max_abs_err {err} (tol {tol} x "
                        f"max(1, {scale})), row {r} equal to the row "
                        f"launched alone: {row_equal}")
                if dtype == torch.float32 and M in QMM_TIMED \
                        and not sname.startswith("odd"):
                    t = {"form": qm.qmm_form(M), "max_abs_err": err,
                         "ms": time_ms(lambda: qm.quantized_matmul_cuda(
                             x, wq, ws), flush),
                         "plain_ms": time_ms(
                             lambda: qm.quantized_matmul_ref(x, wq, ws),
                             flush),
                         "library_ms": time_ms(
                             lambda: torch.matmul(x, w_deq), flush)}
                    t["bound_ms"], t["bound_by"] = qmm_bound_ms(M, K, N, 4)
                    log("kernel_qmm_time", case=tag, **t)
                    timings[tag] = t
    return timings


def flash_keep_bits(kv_mask, H, S, D, seed, dropout_p,
                    dtype=torch.float32):
    """The dropout keep bits each flash kernel of ``dtype`` applied, read
    back exactly: ``{"fwd", "dkv", "dq"}`` -> bool ``[B·H, S, S]`` (row,
    col).

    With q = 0 every visible score is 0, so each probability is 1/n over
    a row's n visible keys (the backward kernels get lse = log n).  A
    one-hot operand then copies column ``c0 + d`` of the dropped
    probabilities into output column ``d``, which is > 0 exactly where
    the bit is kept: v for the forward (o = P'v), dO for dK/dV (dV =
    P'ᵀdO, read transposed) and k for dQ (with dO = v = e0 and delta 0,
    dQ = dS·k and dS = P'·1).  Masked keys read as dropped.  On the card,
    not causal.  In bf16 (all three on the tensor cores) a kept
    probability 1/(n (1 - p)) stays > 0 after its rounding to bf16,
    so the bits read back as exactly."""
    from paddle_tpu_torch.ops import flash_attention as fa

    B = kv_mask.shape[0]
    dev = kv_mask.device
    mask = kv_mask.float().contiguous()
    n = mask.sum(dim=-1)                                        # [B]
    lse = torch.log(n)[:, None, None].expand(B, H, S).reshape(
        B * H, S, 1).contiguous()
    zero_rows = torch.zeros(B * H, S, 1, device=dev)
    zeros = torch.zeros(B, H, S, D, device=dev, dtype=dtype)
    e0 = zeros.clone()
    e0[..., 0] = 1.0
    bits = {name: torch.zeros(B * H, S, S, dtype=torch.bool, device=dev)
            for name in ("fwd", "dkv", "dq")}
    for c0 in range(0, S, D):
        w = min(D, S - c0)
        onehot = zeros.clone()
        onehot[:, :, c0:c0 + w, :w] = torch.eye(w, device=dev, dtype=dtype)
        o, _ = fa.flash_fwd_cuda(zeros, zeros, onehot, mask, seed, 1.0,
                                 False, dropout_p)
        bits["fwd"][:, :, c0:c0 + w] = o.reshape(B * H, S, D)[..., :w] > 0
        _, dv = fa.flash_dkv_cuda(zeros, zeros, zeros, onehot, lse,
                                  zero_rows, mask, seed, 1.0, False,
                                  dropout_p)
        bits["dkv"][:, c0:c0 + w, :] = (
            dv.reshape(B * H, S, D)[..., :w] > 0).transpose(1, 2)
        dq = fa.flash_dq_cuda(zeros, onehot, e0, e0, lse, zero_rows, mask,
                              seed, 1.0, False, dropout_p)
        bits["dq"][:, :, c0:c0 + w] = dq.reshape(B * H, S, D)[..., :w] > 0
    return bits


def flash_keep_reference(kv_mask, H, S, seed, dropout_p):
    """``_keep_mask``'s bits for every (b·h, row, col), masked keys
    dropped: what :func:`flash_keep_bits` must read back."""
    from paddle_tpu_torch.ops.flash_attention import _keep_mask

    B = kv_mask.shape[0]
    dev = kv_mask.device
    bh = torch.arange(B * H, device=dev)[:, None, None]
    idx = torch.arange(S, device=dev)
    keep = _keep_mask(seed, bh, idx[:, None], idx[None, :], dropout_p)
    valid = (kv_mask > 0).repeat_interleave(H, dim=0)[:, None, :]
    return keep & valid


# flash kernels vs their plain versions: f32 sums over up to 1024 keys
# or queries in another order (1e-4); bf16 outputs rounded to 8 mantissa
# bits (2e-2); fp16 to 11 (4e-3, a fifth of bf16's: the bodies round P
# and dS to fp16 where the bf16 ones round them to bf16, 2^-12 against
# 2^-9 relative) — all times max(1, the largest reference value)
FLASH_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2,
             torch.float16: 4e-3}
# bf16 outputs also in relative L2 norm over the whole tensor
# (flash_rel_l2), where the long causal rows (small |o| under a max-abs
# limit set by row 0's |v|) cannot hide: the bf16 roundings of P, dS and
# the outputs, 2^-9 relative each, land at 1.8e-3 to 2.8e-3 in the CPU
# emulation of the tensor-core bodies against the Pallas kernels, where a
# body that drops one 64-key tile of the rows past 300 at S 1024 lands at
# 0.18 (tests/test_torch_flash_tc_numerics.py).  f32: all three bodies run
# in 3xTF32 on the tensor cores, which keeps about 2^-21 of a product; the
# CPU emulation of the bodies lands at most at 1.9e-6 against the Pallas
# kernels and a one-pass TF32 product at 3.6e-4 or more
# (tests/test_torch_flash_f32tc_numerics.py), so 2e-4 tells the two apart;
# it leaves 2.4 times the room the card needed at a single key (exact dK
# and dQ of 0, rounding noise against the floor below: at most 8.2e-5 at
# D 256) and 100 times that of every other case (at most 1.7e-6)
FLASH_REL_L2 = {torch.bfloat16: 1e-2, torch.float32: 2e-4,
                torch.float16: 2e-3}
# the rms that stands in for the reference's where that is smaller: a
# gradient whose exact value is 0 (dk and dq at a single key) is rounding
# noise in both versions; every other reference of the card tests has an
# rms of at least 0.05
FLASH_REL_L2_FLOOR = 1e-2
BF16_FLOPS_PER_S = 989e12
# (name, B, H, S, D, causal, kv mask with padded tails, dropout_p):
# (a) the training shape, (b) a BERT-base shape, (c) unaligned S and D
# (D 100: bf16 rows not a multiple of 16 bytes, loaded element by element)
FLASH_CASES = [("train", 8, 12, 1024, 64, True, False, 0.0),
               ("bert", 8, 12, 512, 64, False, True, 0.1),
               ("bert_base_s128", 32, 12, 128, 64, False, True, 0.1),
               ("unaligned_d80", 2, 4, 1000, 80, True, True, 0.1),
               ("unaligned_d100", 2, 4, 1000, 100, True, True, 0.1),
               ("unaligned_d256", 2, 4, 1000, 256, True, True, 0.1)]
FLASH_SEED = 20240611
# timed: the GPT training shape, and BERT-base's at bench.py's B 32 x S 128
FLASH_TIMED = ("train", "bert_base_s128")
# the bf16 bodies (namespace tc of flash_attention.cu)
_TC = ("mma.sync m16n8k16 bf16 with f32 accumulators; cp.async ring of 3 "
       "stages; ldmatrix (.trans) from XOR-swizzled tiles; ")
FLASH_TC_DESIGN = {
    "fwd": _TC + "P' rounded to bf16 in registers as the A operand of P'V",
    "dkv": _TC + "S^T = K Q^T per warp of 16 keys; P'^T and dS^T rounded "
                 "to bf16 in registers as the A operands of dV and dK",
    "dq": _TC + "a warp owns 16 query rows; Q and dO fragments in "
                "registers as the A operands of S and dP; dS rounded to "
                "bf16 in registers as the A operand of dS K, K by "
                "ldmatrix.trans"}
# the fp16 bodies: the same template in fp16
FLASH_FP16_DESIGN = {k: v.replace("bf16", "fp16")
                     for k, v in FLASH_TC_DESIGN.items()}
# the f32 bodies (namespace f32tc of flash_attention.cu)
_F32TC = ("3xTF32 on mma.sync m16n8k8 tf32 (each f32 operand split into a "
          "TF32 big part and a TF32 residual where its fragment is formed; "
          "small*big, big*small, big*big a chunk of 8, each tile's chunks "
          "in a partial sum folded in by f32 operations); cp.async ring of "
          "2 stages; tiles of DT + 8 floats a row, rows 4-7 of every 8 "
          "swapped in pairs, read without bank conflicts; ")
FLASH_F32TC_DESIGN = {
    "fwd": _F32TC + "a warp owns 16 query rows (Q's split fragments in "
                    "registers at D 64); the online softmax on the S "
                    "accumulators; P' goes from them to the A operand of "
                    "P'V in registers, unrounded; O = O alpha + the tile's "
                    "partial sum",
    "dkv": _F32TC + "S^T = K Q^T per warp of 16 keys; P'^T and dS^T go "
                    "from the accumulators to the A operands of dV and dK "
                    "in registers (k read through a permutation, no "
                    "shuffle), unrounded",
    "dq": _F32TC + "a warp owns 16 query rows; dS goes from the "
                   "accumulators to the A operand of dS K in registers"}


def flash_inputs(rng, B, H, S, D, masked, dtype):
    q, k, v, g = (torch.from_numpy(rng.randn(B, H, S, D).astype(
        np.float32)).to(DEVICE, dtype) for _ in range(4))
    mask = torch.ones(B, S)
    if masked:
        for b in range(B):
            mask[b, rng.randint(S // 2, S + 1):] = 0.0
    return q, k, v, g, mask.to(DEVICE)


def flash_bound_ms(kernel, B, H, S, D, causal, item, peak=None,
                   kv_frac=1.0):
    """Least time on an H100 for one kernel call: the larger of its bytes
    (each input read once, each output written once) over 3.35 TB/s and
    its operations over the peak of the input type (``peak`` if given):
    f32-accurate products at 165 TFLOP/s, the TF32 tensor cores' 495 in
    3xTF32 (three TF32 products for one f32 one; the CUDA cores' 67 is
    the slower way), bf16 at 989 TFLOP/s.  Operations, the standard
    accounting: the forward
    is 4·B·H·S²·D (its two products, 2·S²·D each), the backward pair
    2.5× the forward — its five products, of which dK/dV owns three
    (S = QKᵀ, dV, dK: 1.5× the forward) and dQ two (dP, dQ: 1.0×); the
    products each backward kernel recomputes for itself are not counted
    twice.  Causal halves every count; a kv mask scales the products by
    ``kv_frac``, the share of keys it lets through (a masked key needs
    no product)."""
    tensor = B * H * S * D * item
    rows = B * H * S * 4                         # lse or delta, f32
    mask = B * S * 4
    fwd_ops = 4.0 * B * H * S * S * D * (0.5 if causal else 1.0) * kv_frac
    nbytes, ops = {"fwd": (4 * tensor + rows + mask, fwd_ops),
                   "dkv": (6 * tensor + 2 * rows + mask, 1.5 * fwd_ops),
                   "dq": (5 * tensor + 2 * rows + mask, 1.0 * fwd_ops)}[
        kernel]
    if peak is None:
        peak = TF32_FLOPS_PER_S / 3 if item == 4 else BF16_FLOPS_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def flash_rel_l2(got, want) -> float:
    """‖got − want‖₂ / ‖want‖₂ over the whole tensor, with an rms of
    FLASH_REL_L2_FLOOR standing in for ``want``'s where that is
    smaller."""
    want = want.float()
    floor = FLASH_REL_L2_FLOOR * math.sqrt(want.numel())
    return float((got.float() - want).norm()) / max(float(want.norm()),
                                                    floor)


def _flash_check(tag, name, got, want, tol, rel_l2=None):
    want = want.float()
    err = float((got.float() - want).abs().max())
    limit = tol * max(1.0, float(want.abs().max()))
    rel = flash_rel_l2(got, want) if rel_l2 is not None else None
    ok = (math.isfinite(err) and err <= limit
          and (rel is None or rel <= rel_l2))
    log("kernel_flash", case=tag, output=name, max_abs_err=err, limit=limit,
        rel_l2=rel, rel_l2_limit=rel_l2, ok=ok)
    if not ok:
        raise AssertionError(f"flash {name} kernel disagrees with its plain "
                             f"version on {tag}: max_abs_err {err} (limit "
                             f"{limit}), relative L2 {rel} (limit {rel_l2})")
    return err


def flash_kernel_phase(rng, flush) -> dict:
    """Bodies #5, #6 and #7 against their plain versions on the card in
    f32 and bf16 at FLASH_CASES and in fp16 at the FLASH_TIMED shapes
    (the GPT and BERT training shapes), the dropout bits of all three
    read back exactly at the BERT shape, and each kernel timed at the
    FLASH_TIMED shapes beside its bound, its plain version and PyTorch's
    SDPA in the same dtype (forward; its autograd backward for the
    pair)."""
    from paddle_tpu_torch.ops import flash_attention as fa

    errs, timings = {}, {}
    reset_flash_counts()
    for name, B, H, S, D, causal, masked, p in FLASH_CASES:
        dtypes = (torch.float32, torch.bfloat16) + (
            (torch.float16,) if name in FLASH_TIMED else ())
        for dtype in dtypes:
            tag = f"{name}/{str(dtype).split('.')[-1]}"
            q, k, v, g, mask = flash_inputs(rng, B, H, S, D, masked, dtype)
            scale = 1.0 / math.sqrt(D)
            qf, kf, vf, gf = (t.float() for t in (q, k, v, g))
            common = (mask, FLASH_SEED, scale, causal, p)
            ref_o, ref_lse = fa.flash_fwd_ref(qf, kf, vf, *common)
            delta = (gf * ref_o).sum(-1).reshape(B * H, S, 1)
            o, lse = fa.flash_fwd_cuda(q, k, v, *common)
            bwd = (ref_lse, delta) + common
            dk, dv = fa.flash_dkv_cuda(q, k, v, g, *bwd)
            dq = fa.flash_dq_cuda(q, k, v, g, *bwd)
            torch.cuda.synchronize()
            rdk, rdv = fa.flash_dkv_ref(qf, kf, vf, gf, *bwd)
            rdq = fa.flash_dq_ref(qf, kf, vf, gf, *bwd)
            tol, rel = FLASH_TOL[dtype], FLASH_REL_L2.get(dtype)
            errs[tag] = {
                "fwd": max(_flash_check(tag, "o", o, ref_o, tol, rel),
                           _flash_check(tag, "lse", lse, ref_lse, 1e-4)),
                "dkv": max(_flash_check(tag, "dk", dk, rdk, tol, rel),
                           _flash_check(tag, "dv", dv, rdv, tol, rel)),
                "dq": _flash_check(tag, "dq", dq, rdq, tol, rel)}
            del ref_o, rdk, rdv, rdq
            if name not in FLASH_TIMED:
                continue
            item = q.element_size()
            sdpa = torch.nn.functional.scaled_dot_product_attention
            # the library call on the same work: the kv mask as a boolean
            # [B, 1, 1, S] mask and the same dropout rate (its own bits)
            lib_mask = (mask > 0)[:, None, None, :] if masked else None
            ql, kl, vl = (t.detach().clone().requires_grad_(True)
                          for t in (q, k, v))
            lib_out = sdpa(ql, kl, vl, attn_mask=lib_mask, dropout_p=p,
                           is_causal=causal)
            lib_err = (float((lib_out.detach().float() - o.float())
                             .abs().max()) if p == 0.0 else None)
            calls = {
                "fwd": (lambda: fa.flash_fwd_cuda(q, k, v, *common),
                        lambda: fa.flash_fwd_ref(q, k, v, *common),
                        lambda: sdpa(q, k, v, attn_mask=lib_mask,
                                     dropout_p=p, is_causal=causal)),
                "dkv": (lambda: fa.flash_dkv_cuda(q, k, v, g, *bwd),
                        lambda: fa.flash_dkv_ref(q, k, v, g, *bwd),
                        lambda: torch.autograd.grad(
                            lib_out, (ql, kl, vl), g, retain_graph=True)),
                "dq": (lambda: fa.flash_dq_cuda(q, k, v, g, *bwd),
                       lambda: fa.flash_dq_ref(q, k, v, g, *bwd),
                       lambda: torch.autograd.grad(
                           lib_out, (ql, kl, vl), g, retain_graph=True))}
            for kname, (kern, plain, lib) in calls.items():
                t = {"max_abs_err": errs[tag][kname],
                     "ms": time_ms(kern, flush),
                     "plain_ms": time_ms(plain, flush),
                     "library_ms": time_ms(lib, flush)}
                t["bound_ms"], t["bound_by"] = flash_bound_ms(
                    kname, B, H, S, D, causal, item,
                    kv_frac=float(mask.mean()))
                if dtype == torch.float32:
                    # the same work at the CUDA cores' f32 peak
                    t["bound_cuda_core_ms"] = flash_bound_ms(
                        kname, B, H, S, D, causal, item, F32_FLOPS_PER_S,
                        float(mask.mean()))[0]
                if kname == "fwd":
                    t["library_max_abs_err"] = lib_err
                else:
                    # SDPA's autograd backward computes dq, dk and dv in
                    # one call: the yardstick of the pair, timed beside it
                    t["library_is"] = "sdpa backward (dq, dk, dv)"
                if kname == "dq":
                    t["pair_ms"] = time_ms(lambda: (calls["dkv"][0](),
                                                    kern()), flush)
                    t["pair_is"] = "dK/dV (#6), then dQ (#7)"
                log("kernel_flash_time", case=tag, kernel=kname, **t)
                timings[f"{kname}/{tag}"] = t
            del ql, kl, vl, lib_out
            free_cuda()

    # the bf16 calls above ran on the tensor cores, and so did the f32
    # ones (one launch of each body per case's check, the rest timing
    # runs) and the fp16 ones (the FLASH_TIMED shapes)
    counts = read_flash_counts()
    log("kernel_flash_launches", **counts)
    if min(counts[f"flash_{body}_{k}"] for body in ("tc", "f32tc")
           for k in ("fwd", "dkv", "dq")) < len(FLASH_CASES) or min(
               counts[f"flash_fp16_{k}"] for k in ("fwd", "dkv", "dq")) \
            < len(FLASH_TIMED):
        raise AssertionError(f"kernel_flash: tensor-core launches {counts}, "
                             f"expected at least {len(FLASH_CASES)} of each "
                             f"(fp16: {len(FLASH_TIMED)})")

    # (b)'s dropout bits, exactly, from every kernel in f32 and bf16
    _, B, H, S, D, _, _, p = FLASH_CASES[1]
    _, _, _, _, mask = flash_inputs(rng, B, H, S, D, True, torch.float32)
    want = flash_keep_reference(mask, H, S, FLASH_SEED, p)
    exact = {}
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        bits = flash_keep_bits(mask, H, S, D, FLASH_SEED, p, dtype)
        exact[str(dtype).split(".")[-1]] = {
            name: bool(torch.equal(got, want)) for name, got in bits.items()}
    log("kernel_flash_bits", case="bert", bits=int(want.numel()),
        kept=int(want.sum()), exact=exact)
    if not all(all(e.values()) for e in exact.values()):
        raise AssertionError(f"flash dropout bits differ from _keep_mask: "
                             f"{exact}")
    return {"max_abs_err": errs, "bits_exact": exact["float32"],
            "bits_exact_bf16": exact["bfloat16"],
            "bits_exact_fp16": exact["float16"], "launches": counts,
            **timings}


# --------------------------------------------------------------------------
# training phases
# --------------------------------------------------------------------------
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 1024, 5
TRAIN_LR, TRAIN_WD = 6e-4, 0.1
# the 2-layer card step vs the same step on the CPU: gradients within
# 1e-4 of each parameter's largest |g| (plus 1e-6 of the model's, for
# parameters whose exact gradient is 0, like the key projection's bias):
# cuBLAS and the CPU's BLAS sum 2048 tokens' products in another order;
# the loss 1e-5 relative
GRAD_TOL, GRAD_FLOOR, LOSS_RTOL = 1e-4, 1e-6, 1e-5


def reset_flash_counts():
    from paddle_tpu_torch.ops.attention import ROUTE_STATS
    from paddle_tpu_torch.ops.flash_attention import (FLASH_F32TC_STATS,
                                                      FLASH_FP16_STATS,
                                                      FLASH_ROUTE_STATS,
                                                      FLASH_TC_STATS)

    for stats in (ROUTE_STATS, FLASH_ROUTE_STATS, FLASH_TC_STATS,
                  FLASH_FP16_STATS, FLASH_F32TC_STATS):
        for key in stats:
            stats[key] = 0


def read_flash_counts():
    from paddle_tpu_torch.ops.attention import ROUTE_STATS
    from paddle_tpu_torch.ops.flash_attention import (FLASH_F32TC_STATS,
                                                      FLASH_FP16_STATS,
                                                      FLASH_ROUTE_STATS,
                                                      FLASH_TC_STATS)

    return ({f"flash_{k}": v for k, v in FLASH_ROUTE_STATS.items()}
            | {f"flash_tc_{k}": v for k, v in FLASH_TC_STATS.items()}
            | {f"flash_fp16_{k}": v for k, v in FLASH_FP16_STATS.items()}
            | {f"flash_f32tc_{k}": v for k, v in FLASH_F32TC_STATS.items()}
            | {f"route_{k}": v for k, v in ROUTE_STATS.items()})


def amp_context(amp_dtype):
    """``amp.auto_cast(dtype=amp_dtype)``, or no cast for None."""
    from contextlib import nullcontext

    from paddle_tpu_torch import amp

    return (nullcontext() if amp_dtype is None
            else amp.auto_cast(dtype=amp_dtype))


def train_step(model, opt, x, y, amp_dtype=None):
    """One step of the paddle dygraph loop, the forward under
    ``auto_cast(dtype=amp_dtype)`` when given (the loss reads the logits
    in f32 either way); returns the loss."""
    from paddle_tpu_torch.nn import functional as F

    with amp_context(amp_dtype):
        logits = model(x)
    loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           y.reshape(-1))
    loss.backward()
    opt.step()
    opt.clear_grad()
    return float(loss.detach())


# kernel names of the matrix-product libraries (cuBLAS, cuBLASLt)
MATMUL_NAMES = ("gemm", "nvjet", "xmma", "cutlass")


def profile_step(model, opt, x, y, amp_dtype=None, step=None) -> dict:
    """One more training step under ``torch.profiler``: device time by
    kernel family (the three flash kernels, matrix products, the rest),
    the costliest other kernels, and the device's busy share of the
    step's wall time (one stream: kernel times add up).  ``step``, a
    callable returning the loss, replaces the dygraph loop's step."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        loss = (train_step(model, opt, x, y, amp_dtype) if step is None
                else step())
        wall_ms = (time.perf_counter() - t0) * 1e3
    fam = {"flash_fwd": 0.0, "flash_dkv": 0.0, "flash_dq": 0.0,
           "matmul": 0.0, "other": 0.0}
    other, n_kernels = [], 0
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = evt.self_device_time_total / 1e3
        n_kernels += evt.count
        name = evt.key
        key = next((f"flash_{k}" for k in ("dkv", "dq", "fwd")
                    if any(f"{k}_{body}kernel<" in name
                           for body in ("", "tc_", "f32tc_"))), None)
        if key is None and any(m in name.lower() for m in MATMUL_NAMES):
            key = "matmul"
        if key is None:
            key = "other"
            other.append((ms, evt.count, name[:90]))
        fam[key] += ms
    busy = sum(fam.values())
    other.sort(reverse=True)
    return {"loss": loss, "wall_ms": wall_ms, "device_ms": busy,
            "device_busy_share": busy / wall_ms if busy else None,
            "device_kernels": n_kernels, "device_ms_by_family": fam,
            "top_other_kernels": [
                {"ms": ms, "launches": c, "name": n} for ms, c, n in
                other[:8]]}


def train_phase(rng, amp_dtype=None, phase="train") -> dict:
    """GPT-2-small widths, all 12 layers, AdamW(6e-4, wd 0.1), one seeded
    B 8 x S 1024 batch repeated: one warm-up step, then TRAIN_STEPS steps
    with every count set to 0 just before and read just after, then one
    more step under the profiler.  f32, or the forward under
    ``auto_cast(dtype=amp_dtype)`` as ``bench.py`` trains (bf16: the
    three flash bodies on the tensor cores)."""
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text.models import GPTModel

    t0 = time.perf_counter()
    model = GPTModel(**GPT2_SMALL, device=DEVICE, seed=1234)
    opt = AdamW(TRAIN_LR, parameters=list(model.parameters()),
                weight_decay=TRAIN_WD)
    ids = torch.from_numpy(rng.randint(
        0, GPT2_SMALL["vocab_size"], (TRAIN_BATCH, TRAIN_SEQ + 1)).astype(
        np.int64)).to(DEVICE)
    x, y = ids[:, :-1], ids[:, 1:]
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses = [train_step(model, opt, x, y, amp_dtype)]
    warmup_s = time.perf_counter() - t0
    reset_counts()
    reset_flash_counts()
    step_s = []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        losses.append(train_step(model, opt, x, y, amp_dtype))  # syncs
        step_s.append(time.perf_counter() - t0)
    counts = read_flash_counts() | read_counts()
    n = len(model.layers) * TRAIN_STEPS
    n_tc = n if amp_dtype == "bfloat16" else 0
    want = {"flash_fwd": n, "flash_dkv": n, "flash_dq": n, "flash_ref": 0,
            "flash_tc_fwd": n_tc, "flash_tc_dkv": n_tc, "flash_tc_dq": n_tc,
            "flash_f32tc_fwd": n - n_tc, "flash_f32tc_dkv": n - n_tc,
            "flash_f32tc_dq": n - n_tc, "route_pallas": n, "route_xla": 0}
    expect_counts(phase, counts, want)
    prof = profile_step(model, opt, x, y, amp_dtype)
    ln_v = math.log(GPT2_SMALL["vocab_size"])
    result = {
        "amp_dtype": amp_dtype,
        "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": TRAIN_STEPS,
        "losses": losses, "ln_vocab": ln_v, "init_s": init_s,
        "warmup_step_s": warmup_s, "step_s": step_s,
        "step_ms_p50": float(np.percentile(step_s, 50) * 1e3),
        "step_ms_p95": float(np.percentile(step_s, 95) * 1e3),
        "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ * TRAIN_STEPS / sum(step_s),
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        **counts, "profile": prof}
    log(phase, **result)
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{phase}: non-finite loss {losses}")
    if abs(losses[0] - ln_v) > 0.5:
        raise AssertionError(f"{phase}: first loss {losses[0]} is not "
                             f"within 0.5 of ln(vocab) {ln_v}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{phase}: the loss did not fall on the "
                             f"repeated batch: {losses}")
    return result


def _off_noise(diff, g_ref, global_max, limit):
    """Entries off ``limit`` whose reference gradient is not at the noise
    floor (where Adam's normalized first step is ±1 either way)."""
    noise = (g_ref.abs() < 1e-4 * g_ref.abs().max()) | (
        g_ref.abs() < GRAD_FLOOR * global_max)
    off = diff > limit
    return off, off & ~noise


def _parity_runs(rng, cfg, batch, seq, amp_dtype):
    """One training step of the same 2-layer GPT (``cfg``) on the card
    and on the CPU's plain flash route (PADDLE_TPU_FORCE_FLASH=1), the
    forward under ``auto_cast(dtype=amp_dtype)`` when given: per device
    the loss, every gradient, the weights after one AdamW step, the
    launch counts and the seconds it took."""
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text.models import GPTModel

    card = GPTModel(**cfg, device=DEVICE, seed=1234)
    cpu = GPTModel(**cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    ids = rng.randint(0, cfg["vocab_size"], (batch, seq + 1)).astype(
        np.int64)
    runs = {}
    for name, model in (("card", card), ("cpu", cpu)):
        dev = model.device
        x = torch.from_numpy(ids[:, :-1]).to(dev)
        y = torch.from_numpy(ids[:, 1:]).to(dev)
        forced = os.environ.get("PADDLE_TPU_FORCE_FLASH")
        if name == "cpu":
            os.environ["PADDLE_TPU_FORCE_FLASH"] = "1"
        reset_flash_counts()
        t0 = time.perf_counter()
        try:
            with amp_context(amp_dtype):
                logits = model(x)
            loss = F.cross_entropy(logits.reshape(-1, cfg["vocab_size"]),
                                   y.reshape(-1))
            loss.backward()
        finally:
            if forced is None:
                os.environ.pop("PADDLE_TPU_FORCE_FLASH", None)
            else:
                os.environ["PADDLE_TPU_FORCE_FLASH"] = forced
        grads = {n: p.grad.detach().float().cpu()
                 for n, p in model.named_parameters()}
        weights0 = {n: p.detach().float().cpu().clone() for n, p in
                    model.named_parameters()}
        opt = AdamW(TRAIN_LR, parameters=list(model.parameters()),
                    weight_decay=TRAIN_WD)
        opt.step()
        opt.clear_grad()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        runs[name] = {"loss": float(loss.detach()), "grads": grads,
                      "weights0": weights0,
                      "weights": {n: p.detach().float().cpu() for n, p in
                                  model.named_parameters()},
                      "counts": read_flash_counts(),
                      "s": time.perf_counter() - t0}
    L = cfg["num_layers"]
    n_tc = L if amp_dtype == "bfloat16" else 0
    expect_counts("train_parity card", runs["card"]["counts"], {
        "flash_fwd": L, "flash_dkv": L, "flash_dq": L, "flash_ref": 0,
        "flash_tc_fwd": n_tc, "flash_tc_dkv": n_tc, "flash_tc_dq": n_tc,
        "flash_f32tc_fwd": L - n_tc, "flash_f32tc_dkv": L - n_tc,
        "flash_f32tc_dq": L - n_tc})
    expect_counts("train_parity cpu", runs["cpu"]["counts"], {
        "flash_fwd": 0, "flash_dkv": 0, "flash_dq": 0, "flash_ref": 3 * L,
        "flash_f32tc_fwd": 0, "flash_f32tc_dkv": 0, "flash_f32tc_dq": 0})
    return runs


def train_parity_phase(rng, cfg=None, batch=2, seq=None) -> dict:
    """2 layers at GPT-2-small widths (or ``cfg``), B 2 x S 1024, f32: one
    step's loss and every gradient through the kernels on the card
    against the same step on the CPU through the port's plain flash route
    (PADDLE_TPU_FORCE_FLASH=1), then the weights after one AdamW step."""
    cfg = cfg or dict(GPT2_SMALL, num_layers=2)
    seq = seq or TRAIN_SEQ
    runs = _parity_runs(rng, cfg, batch, seq, None)
    a, b = runs["card"], runs["cpu"]
    loss_err = abs(a["loss"] - b["loss"]) / abs(b["loss"])
    gmax = max(float(g.abs().max()) for g in b["grads"].values())
    grad_worst, w_worst, w_noise, n_w, bad = 0.0, 0.0, 0, 0, []
    for name, gb in b["grads"].items():
        err = float((a["grads"][name] - gb).abs().max())
        limit = GRAD_TOL * float(gb.abs().max()) + GRAD_FLOOR * gmax
        grad_worst = max(grad_worst, err / limit)
        if err > limit:
            bad.append(f"grad {name}: {err} > {limit}")
        diff = (a["weights"][name] - b["weights"][name]).abs()
        off, off_signal = _off_noise(diff, gb, gmax, 2e-3 * TRAIN_LR)
        w_noise += int(off.sum())
        n_w += diff.numel()
        w_worst = max(w_worst, float(diff[~off].max()) if (~off).any()
                      else 0.0)
        if off_signal.any() or bool((diff > 2 * TRAIN_LR).any()):
            bad.append(f"weight {name}: {int(off_signal.sum())} entries "
                       f"off {2e-3 * TRAIN_LR} with a gradient above the "
                       f"noise floor")
    result = {"layers": cfg["num_layers"], "batch": batch, "seq": seq,
              "loss_card": a["loss"], "loss_cpu": b["loss"],
              "loss_rel_err": loss_err,
              "grad_worst_err_over_limit": grad_worst,
              "weights_max_abs_err_off_noise": w_worst,
              "weights_noise_entries": w_noise, "weights": n_w,
              "card_s": a["s"], "cpu_s": b["s"],
              "card_counts": a["counts"], "cpu_counts": b["counts"]}
    log("train_parity", **result)
    if loss_err > LOSS_RTOL or bad or w_noise > 0.01 * n_w:
        raise AssertionError(f"train_parity: loss rel err {loss_err} (tol "
                             f"{LOSS_RTOL}), noise entries {w_noise} of "
                             f"{n_w}; {bad[:5]}")
    return result


# the 2-layer bf16-autocast card step vs the same step on the CPU: both
# round to bf16 after every linear, attention and GELU, but cuBLAS and the
# CPU's BLAS take the sums inside them in another order, and the card's
# flash bodies round P and dS to bf16 where the plain version keeps f32,
# so elements differ by a bf16 ulp (2^-8) here and there: the loss within
# 5e-3 relative and each parameter's gradient within 5e-2 of its norm
# (relative L2; two CPU routes differ by 1.3e-2).  The key projections'
# biases have an exact gradient of 0 (a softmax row ignores a constant
# added to all its scores), so theirs is rounding noise on both devices
# and is only held to be small.  Adam's first step moves a weight by lr
# times the sign of its gradient, so where a gradient near 0 changes sign
# the weights differ by 2 lr (1-6 % of a tensor's entries between two CPU
# routes); the card's AdamW step is held instead to the same step on the
# CPU from the card's own gradients, within 1e-3 lr (f32 elementwise ops)
GRAD_REL_BF16, LOSS_RTOL_BF16, NOISE_GRADS = 5e-2, 5e-3, ".attn.k_proj.bias"


def train_parity_bf16_phase(rng, cfg=None, batch=2, seq=None) -> dict:
    """The bf16-autocast twin of :func:`train_parity_phase`: 2 layers at
    GPT-2-small widths (or ``cfg``), B 2 x S 1024, the forward under
    ``auto_cast(dtype="bfloat16")`` on both devices (the card's three
    flash bodies on the tensor cores), held to the tolerances
    above."""
    from paddle_tpu_torch.optimizer import AdamW

    cfg = cfg or dict(GPT2_SMALL, num_layers=2)
    seq = seq or TRAIN_SEQ
    runs = _parity_runs(rng, cfg, batch, seq, "bfloat16")
    a, b = runs["card"], runs["cpu"]
    loss_err = abs(a["loss"] - b["loss"]) / abs(b["loss"])
    gmax = max(float(g.norm()) for g in b["grads"].values())
    # the CPU's AdamW step from the card's start and gradients
    replay = {n: torch.nn.Parameter(w.clone()) for n, w in
              a["weights0"].items()}
    for n, p in replay.items():
        p.grad = a["grads"][n].clone()
    AdamW(TRAIN_LR, parameters=list(replay.values()),
          weight_decay=TRAIN_WD).step()
    grad_rel, step_err, bad = {}, 0.0, []
    for name, gb in b["grads"].items():
        ga = a["grads"][name]
        if name.endswith(NOISE_GRADS):
            if float(ga.norm()) > 1e-2 * gmax:
                bad.append(f"grad {name}: norm {float(ga.norm())} is not "
                           f"rounding noise")
        else:
            grad_rel[name] = float((ga - gb).norm() / gb.norm())
            if grad_rel[name] > GRAD_REL_BF16:
                bad.append(f"grad {name}: relative L2 {grad_rel[name]}")
        step_err = max(step_err, float(
            (a["weights"][name] - replay[name].detach()).abs().max()))
    result = {"layers": cfg["num_layers"], "batch": batch, "seq": seq,
              "loss_card": a["loss"], "loss_cpu": b["loss"],
              "loss_rel_err": loss_err,
              "grad_rel_l2_worst": max(grad_rel.values()),
              "grad_rel_l2": grad_rel, "adamw_step_max_abs_err": step_err,
              "card_s": a["s"], "cpu_s": b["s"],
              "card_counts": a["counts"], "cpu_counts": b["counts"]}
    log("train_parity_bf16", **result)
    if loss_err > LOSS_RTOL_BF16 or bad or step_err > 1e-3 * TRAIN_LR:
        raise AssertionError(
            f"train_parity_bf16: loss rel err {loss_err} (tol "
            f"{LOSS_RTOL_BF16}), AdamW step off by {step_err} (tol "
            f"{1e-3 * TRAIN_LR}); {bad[:5]}")
    return result


# --------------------------------------------------------------------------
# end-to-end phases
# --------------------------------------------------------------------------
def logit_gap(model, prompt, stream, k, quant=None):
    """Top-2 logit gap of the dense reference at generated position k
    (teacher-forced through prompt + stream[:k]; int8 as ``quant`` says)."""
    from paddle_tpu_torch.text.generation import make_gpt_decode_step

    qkw = {}
    if quant is not None:
        qkw = dict(kv_cache_dtype=quant["kv_cache_dtype"],
                   kv_scales=quant["kv_scales"],
                   weight_quant=quant["weights"])
    ids = np.concatenate([prompt, stream[:k]]).astype(np.int32)
    step_fn, init_state = make_gpt_decode_step(model, ids.size + 1, **qkw)
    state = init_state(1)
    dev = model.device
    logits = None
    for tok in ids:
        logits, state = step_fn(torch.tensor([int(tok)], dtype=torch.int32,
                                             device=dev), state)
    top = torch.topk(logits[0].float(), 2).values
    return float(top[0] - top[1])


def logit_gap_int8_dynamic(model, prompt, stream, k, weights=None):
    """Top-2 logit gap at generated position k of the spec-off
    int8_dynamic engine's computation, teacher-forced through prompt +
    stream[:k] (``ENGINE``'s pages and chunks, ``weights`` as the
    engine's weight-only int8 export): the paged core with dynamic
    per-page scales, fed as the engine feeds a lane — prompt[:-1] in
    ``chunk_schedule`` prefill chunks, then one decode row a position —
    so each page's scale grows, and its content is requantized, in the
    engine's order.  The dense ring has no dynamic int8 mode, so
    ``logit_gap`` cannot stand for it."""
    from paddle_tpu_torch.text.generation import _make_gpt_paged_core
    from paddle_tpu_torch.utils.bucketing import chunk_schedule

    chunk, page = ENGINE["prefill_chunk"], ENGINE["page_size"]
    ids = np.concatenate([prompt, stream[:k]]).astype(np.int64)
    n = int(prompt.size)
    M = -(-ids.size // page)
    core, init_pages = _make_gpt_paged_core(
        model, page, M, kv_cache_dtype="int8", weight_quant=weights)
    kv = init_pages(M + 1)                          # page 0: the trash page
    dev = model.device
    table = torch.arange(1, M + 1, dtype=torch.int32, device=dev)[None]
    spans = [(off, min(off + size, n - 1))
             for off, size in chunk_schedule(n - 1, chunk)]
    spans += [(p, p + 1) for p in range(n - 1, ids.size)]
    logits = None
    for s0, e0 in spans:
        tok = torch.as_tensor(ids[s0:e0], device=dev)
        pos = torch.arange(s0, e0, device=dev)
        logits, kv = core(tok, pos, table, kv, qgroup=e0 - s0)
    top = torch.topk(logits[-1].float(), 2).values
    return float(top[0] - top[1])


def reset_counts():
    from paddle_tpu_torch.ops.paged_attention import PAGED_ROUTE_STATS
    from paddle_tpu_torch.ops.quantized_matmul import (QMM_FORM_STATS,
                                                       QMM_ROUTE_STATS)

    for stats in (PAGED_ROUTE_STATS, QMM_ROUTE_STATS, QMM_FORM_STATS):
        for key in stats:
            stats[key] = 0


def read_counts():
    from paddle_tpu_torch.ops.paged_attention import PAGED_ROUTE_STATS
    from paddle_tpu_torch.ops.quantized_matmul import (QMM_FORM_STATS,
                                                       QMM_ROUTE_STATS)

    return ({f"attention_{k}": v for k, v in PAGED_ROUTE_STATS.items()}
            | {f"qmm_{k}": v for k, v in QMM_ROUTE_STATS.items()}
            | {f"qmm_form_{k}": v for k, v in QMM_FORM_STATS.items()})


def drive(eng, prompts):
    """Serve ``prompts`` to completion with every launch count set to 0
    just before and read just after.  Returns (streams, counts, wall s,
    ragged dispatches)."""
    ids = [eng.add_request(p, max_new_tokens=NEW_TOKENS) for p in prompts]
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = eng.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    if eng.cache.pages_in_use != 0:
        raise AssertionError(f"{eng.cache.pages_in_use} KV pages leaked")
    streams = [outs[r] for r in ids]
    if [len(s) for s in streams] != [NEW_TOKENS] * len(ids):
        raise AssertionError(f"expected {NEW_TOKENS} tokens per request, "
                             f"got {[len(s) for s in streams]}")
    return streams, counts, wall, eng.stats()["metrics"]["ragged"]["steps"]


# the stats kernel's counts, 0 on every single-device drive
NO_STATS = {"attention_cuda_stats": 0, "attention_cuda_stats_int8": 0,
            "attention_ref_stats": 0}


def expect_counts(phase, counts, want):
    got = {k: counts[k] for k in want}
    if got != want or not any(v > 0 for v in want.values()):
        raise AssertionError(f"{phase}: launch counts {counts}, expected "
                             f"{want}: the path did not run on the kernels "
                             f"at every layer of every dispatch")


# --------------------------------------------------------------------------
# the serving programs as CUDA graphs (paddle_tpu_torch/profiler/jit_cost.py)
# --------------------------------------------------------------------------
def jit_delta(before) -> dict:
    """What each serving program did since ``before`` (a ``cost_registry``
    snapshot): captures and their seconds, calls and replays."""
    from paddle_tpu_torch.profiler.jit_cost import cost_registry

    out = {}
    for name, now in cost_registry.snapshot().items():
        was = before.get(name, {})
        d = {"captures": now["compile_count"] - was.get("compile_count", 0),
             "capture_s": now["compile_time_s"]
             - was.get("compile_time_s", 0.0),
             "calls": now["calls"] - was.get("calls", 0),
             "replays": now["replays"] - was.get("replays", 0)}
        if name.startswith("serving.") and d["calls"]:
            out[name] = d
    return out


def drive_modes(phase, make_engine, prompts, run_drive=None) -> dict:
    """Serve ``prompts`` through two engines from ``make_engine()``: the
    first under ``disable_jit()`` (every program eager), the second with
    its programs captured and replayed as CUDA graphs, each through
    ``run_drive`` (default ``drive``: counts set to 0 just before, read just
    after).  The eager drive must record no program, the graphed one
    must replay (where the engine captures), and their streams must be
    equal.  Returns {mode: (engine, ``run_drive``'s result, {"programs":
    what each program did, "stats": the engine's stats after the
    drive})}."""
    from paddle_tpu_torch.profiler.jit_cost import (cost_registry,
                                                    disable_jit)

    run_drive = run_drive or drive
    runs = {}
    for mode in ("eager", "graphed"):
        eng = make_engine()
        before = cost_registry.snapshot()
        if mode == "eager":
            with disable_jit():
                res = run_drive(eng, prompts)
        else:
            res = run_drive(eng, prompts)
        programs = jit_delta(before)
        replays = sum(p["replays"] for p in programs.values())
        if (programs if mode == "eager"
                else eng.cuda_graphs and not replays):
            raise AssertionError(f"{phase}: the {mode} drive ran the "
                                 f"programs {programs}")
        # the metrics histograms are process-wide (the next engine resets
        # them): read this drive's now
        runs[mode] = (eng, res, {"programs": programs,
                                 "stats": eng.stats()})
    eager, graphed = runs["eager"][1][0], runs["graphed"][1][0]
    if not all(np.array_equal(a, b) for a, b in zip(eager, graphed)):
        raise AssertionError(f"{phase}: the graphed streams differ from the "
                             f"eager ones: {graphed} vs {eager}")
    return runs


def modes_summary(runs) -> dict:
    """Per mode: wall time, step and dispatch-gap histograms (host clock)
    and what each program did (captures, capture seconds, replays)."""
    out = {}
    for mode, (_eng, res, seen) in runs.items():
        snap = seen["stats"]["metrics"]
        out[mode] = {"wall_s": res[2], "step_ms": snap["step_latency_ms"],
                     "dispatch_gap_ms": snap["dispatch_gap_ms"],
                     "programs": seen["programs"]}
    out["step_p50_graphed_over_eager"] = (
        out["graphed"]["step_ms"]["p50"] / out["eager"]["step_ms"]["p50"])
    return out


def to_steady(eng, prompts, budget):
    """Admit ``prompts`` (``budget`` new tokens each) and step until every
    lane decodes (no request waiting, no prefill chunk left), then two
    more steps: the steady signature's first call and its first replay.
    Returns the request ids."""
    ids = [eng.add_request(p, max_new_tokens=budget) for p in prompts]
    for _ in range(256):
        eng.step()
        if not eng.scheduler.waiting and not eng._prefill_plans:
            break
    else:
        raise AssertionError("the lanes never reached steady decode")
    eng.step()
    eng.step()
    return ids


# the paged and matmul kernels' names in a device trace
PAGED_KERNELS = ("ragged_decode_kernel", "ragged_prefill_kernel",
                 "stats_warp_kernel", "stats_prefill_kernel",
                 "qmm_chunk_kernel", "qmm_sum_kernel", "qmm_tile_kernel")
# the budget of the profiled step's requests (the mesh's longest prompt
# leaves room for 34 tokens)
PROFILE_BUDGET = 32


def profile_graphed_step(phase, eng, prompts, want) -> dict:
    """One steady step of a graphed engine under ``torch.profiler``: the
    paged and matmul kernels' device launches by name, read from the
    device trace.  Each kernel in ``want`` must have launched exactly that
    often, in a step that captured nothing and replayed the ragged step
    once."""
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.profiler.jit_cost import (compile_budget,
                                                    cost_registry)

    to_steady(eng, prompts, PROFILE_BUDGET)
    before = cost_registry.snapshot()
    torch.cuda.synchronize()
    with compile_budget(0, prefix="serving."), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    programs = jit_delta(before)
    launches = dict.fromkeys(PAGED_KERNELS, 0)
    n_kernels, device_ms = 0, 0.0
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        n_kernels += evt.count
        device_ms += evt.self_device_time_total / 1e3
        for name in PAGED_KERNELS:
            if f"{name}<" in evt.key:
                launches[name] += evt.count
    eng.drain()
    # the step's kernels on one stream, so their times add up; the wall
    # time covers the step's host work and the wait for its device work
    result = {"device_launches": launches, "device_kernels": n_kernels,
              "device_ms": device_ms, "wall_ms": wall_ms,
              "device_busy_share": device_ms / wall_ms,
              "expected": want, "programs": programs}
    log(f"{phase}_profiled_step", **result)
    bad = {k: (launches[k], n) for k, n in want.items() if launches[k] != n}
    if bad or programs.get("serving.ragged_step", {}).get("replays") != 1:
        raise AssertionError(f"{phase}: the profiled graphed step launched "
                             f"{launches} (expected {want}), programs "
                             f"{programs}")
    return result


_REFERENCES = {}


def reference_streams(model, prompts, quant=None):
    """The port's dense ``generate`` (int8 per ``quant``) for every
    prompt, computed once per (model, export, prompts) on the card."""
    from paddle_tpu_torch.text.generation import generate

    key = (id(model), id(quant), tuple(p.tobytes() for p in prompts))
    if key not in _REFERENCES:
        _REFERENCES[key] = [
            generate(model, p[None], max_new_tokens=NEW_TOKENS, end_id=-1,
                     quant=quant)[0][0].cpu().numpy() for p in prompts]
    return _REFERENCES[key]


def check_streams(phase, model, prompts, streams, quant=None, want=None,
                  int8=None, gap_fn=None):
    """Every stream against the port's dense generate (int8 per
    ``quant``) on the card, or against ``want``; a divergence is allowed
    only at a near tie of the reference's top-2 logits, teacher-forced
    through the prompt and the common prefix (the int8 limit when
    ``int8``, default: when ``quant`` is given).  The reference is the
    dense model (int8 per ``quant``), or ``gap_fn(prompt, stream, k)``
    where the streams' int8 kind has no dense form (int8_dynamic:
    ``logit_gap_int8_dynamic``)."""
    if want is None:
        want = reference_streams(model, prompts, quant)
    if int8 is None:
        int8 = quant is not None
    gap_limit = INT8_NEAR_TIE_GAP if int8 else NEAR_TIE_GAP
    near_ties = []
    for i, (p, got, ref) in enumerate(zip(prompts, streams, want)):
        if not np.isfinite(got).all() or got.shape != ref.shape:
            raise AssertionError(f"{phase} request {i}: bad output {got}")
        diff = np.nonzero(got != ref)[0]
        if diff.size:
            k = int(diff[0])
            gap = (gap_fn(p, ref, k) if gap_fn is not None
                   else logit_gap(model, p, ref, k, quant))
            case = {"request": i, "prompt_len": int(p.size), "position": k,
                    "engine": int(got[k]), "reference": int(ref[k]),
                    "top2_gap": gap, "gap_limit": gap_limit}
            log(f"{phase}_near_tie", **case)
            if gap >= gap_limit:
                raise AssertionError(
                    f"{phase} request {i} diverges from its reference at "
                    f"position {k} where the reference's top-2 gap {gap} "
                    f">= {gap_limit}")
            near_ties.append(case)
    return near_ties


def summary(eng, prompts, wall, dispatches, counts, near_ties):
    snap = eng.stats()["metrics"]
    n_tokens = NEW_TOKENS * len(prompts)
    return {"requests": len(prompts),
            "prompt_lens": [int(p.size) for p in prompts],
            "new_tokens": NEW_TOKENS, "engine_steps": snap["steps"],
            "ragged_dispatches": dispatches, "wall_s": wall,
            "output_tokens_per_s": n_tokens / wall, **counts,
            "pages_in_use_after_drain": eng.cache.pages_in_use,
            "streams_equal": len(prompts) - len(near_ties),
            "near_ties": len(near_ties),
            "kv_cache_bytes": eng.kv_cache_bytes(),
            "num_pages": eng.cache.num_pages,
            # the engine's own histograms (host clock): step latency,
            # the consume-side wait for a dispatch's tokens, and the
            # gap between consecutive dispatches
            "step_ms": snap["step_latency_ms"],
            "consume_wait_ms": snap["decode_latency_ms"],
            "dispatch_gap_ms": snap["dispatch_gap_ms"]}


ENGINE = dict(page_size=16, max_batch_size=8, prefill_chunk=64, eos_id=-1)


def e2e_phase(model, prompts, device="cuda") -> dict:
    """Native KV, f32 weights: attention on body #1 only; driven eager
    and graphed (``drive_modes``), then one steady graphed step
    profiled."""
    from paddle_tpu_torch.serving import create_serving_engine

    L = len(model.layers)
    runs = drive_modes("e2e", lambda: create_serving_engine(
        model, device=device, **ENGINE), prompts)
    t0 = time.perf_counter()
    for mode, (eng, (streams, counts, wall, dispatches), _) in runs.items():
        expect_counts(f"e2e/{mode}", counts, {
            "attention_cuda": L * dispatches, "attention_cuda_int8": 0,
            "attention_cuda_decode": 0, "attention_cuda_decode_int8": 0,
            "attention_ref": 0, "qmm_cuda": 0, "qmm_ref": 0, **NO_STATS})
        near = check_streams(f"e2e/{mode}", model, prompts, streams)
    eng, (streams, counts, wall, dispatches), _ = runs["graphed"]
    result = summary(eng, prompts, wall, dispatches, counts, near)
    result["reference_s"] = time.perf_counter() - t0
    result["modes"] = modes_summary(runs)
    result["profiled_step"] = profile_graphed_step(
        "e2e", eng, prompts, {"ragged_decode_kernel": L})
    log("e2e", **result)
    # the graphed drive's streams, a reference of the front door's phase
    result["streams"] = [s.tolist() for s in streams]
    return result


def e2e_int8_static_phase(model, prompts, rng, native, device="cuda"):
    """int8 KV with scales calibrated on the card, int8 weights: every
    attention call on body #1q, every projection/MLP matmul on body #4;
    driven eager and graphed, then one steady graphed step profiled.
    Returns (result, the export)."""
    from paddle_tpu_torch.serving import create_serving_engine
    from paddle_tpu_torch.slim import export_serving_quant

    t0 = time.perf_counter()
    calib = rng.randint(1, model.wte.weight.shape[0], (4, 64))
    export = export_serving_quant(model, calib_prompts=calib)
    t_export = time.perf_counter() - t0

    def make():
        eng = create_serving_engine(model, device=device,
                                    kv_cache_dtype="int8",
                                    weight_dtype="int8", quant_scales=export,
                                    **ENGINE)
        if eng.kv_mode() != "int8_static":
            raise AssertionError(f"engine runs {eng.kv_mode()}, not "
                                 "int8_static")
        return eng

    runs = drive_modes("e2e_int8_static", make, prompts)
    L = len(model.layers)
    t0 = time.perf_counter()
    for mode, (eng, (streams, counts, wall, dispatches), _) in runs.items():
        expect_counts(f"e2e_int8_static/{mode}", counts, {
            "attention_cuda": 0, "attention_cuda_int8": L * dispatches,
            "attention_cuda_decode": 0, "attention_cuda_decode_int8": 0,
            "attention_ref": 0, "qmm_cuda": 6 * L * dispatches,
            "qmm_ref": 0, **NO_STATS})
        # decode dispatches take the decode form, dispatches with a
        # prefill chunk the prefill form: both ran, each launch in one
        forms = (counts["qmm_form_decode"], counts["qmm_form_prefill"])
        if min(forms) == 0 or sum(forms) != counts["qmm_cuda"]:
            raise AssertionError(f"e2e_int8_static/{mode}: matmul forms "
                                 f"(decode, prefill) {forms} of "
                                 f"{counts['qmm_cuda']}")
        near = check_streams(f"e2e_int8_static/{mode}", model, prompts,
                             streams, export)
    eng, (streams, counts, wall, dispatches), _ = runs["graphed"]
    # the same page count as the native engine, a quarter of its bytes
    ratio = eng.kv_cache_bytes() / native["kv_cache_bytes"]
    if eng.cache.num_pages != native["num_pages"] or ratio > 0.26:
        raise AssertionError(
            f"int8 KV bytes {eng.kv_cache_bytes()} over "
            f"{eng.cache.num_pages} pages are {ratio:.4f}x the native "
            f"engine's {native['kv_cache_bytes']} over "
            f"{native['num_pages']} (limit 0.26)")
    result = summary(eng, prompts, wall, dispatches, counts, near)
    result.update(reference_s=time.perf_counter() - t0, export_s=t_export,
                  kv_bytes_vs_native=ratio,
                  kv_bytes_per_token=eng.kv_bytes_per_token(),
                  quant_weight_bytes=eng.stats()["quant"][
                      "quant_weight_bytes"],
                  modes=modes_summary(runs))
    result["profiled_step"] = profile_graphed_step(
        "e2e_int8_static", eng, prompts,
        {"ragged_decode_kernel": L, "qmm_chunk_kernel": 6 * L,
         "qmm_tile_kernel": 0})
    log("e2e_int8_static", **result)
    result["streams"] = [s.tolist() for s in streams]
    return result, export


def e2e_int8_dynamic_phase(model, prompts, device="cuda") -> dict:
    """No KV calibration: dynamic per-page scales; synchronous and
    pipelined drives, each eager and graphed, must stream byte-identical
    tokens."""
    from paddle_tpu_torch.serving import create_serving_engine

    runs = {}
    L = len(model.layers)
    for sync_mode in (True, False):
        def make():
            eng = create_serving_engine(model, device=device,
                                        kv_cache_dtype="int8",
                                        weight_dtype="int8",
                                        sync_mode=sync_mode, **ENGINE)
            if eng.kv_mode() != "int8_dynamic":
                raise AssertionError(f"engine runs {eng.kv_mode()}")
            return eng

        modes = drive_modes("e2e_int8_dynamic", make, prompts)
        for mode, (eng, (streams, counts, wall, dispatches), _) in \
                modes.items():
            expect_counts(f"e2e_int8_dynamic/{mode}", counts, {
                "attention_cuda": 0, "attention_cuda_int8": L * dispatches,
                "attention_cuda_decode": 0, "attention_cuda_decode_int8": 0,
                "attention_ref": 0, "qmm_cuda": 6 * L * dispatches,
                "qmm_ref": 0, **NO_STATS})
        eng, (streams, counts, wall, dispatches), _ = modes["graphed"]
        res = summary(eng, prompts, wall, dispatches, counts, [])
        res["modes"] = modes_summary(modes)
        runs[sync_mode] = (streams, res)
        del eng, modes
    same = all(np.array_equal(a, b) for a, b in zip(runs[True][0],
                                                    runs[False][0]))
    result = {"sync": runs[True][1], "pipelined": runs[False][1],
              "streams_byte_identical": same}
    log("e2e_int8_dynamic", **result)
    if not same:
        raise AssertionError("int8_dynamic: synchronous and pipelined "
                             "streams differ")
    return result


def split_forwards(eng) -> int:
    """Core forwards the engine ran through the split programs (each one
    attention launch per layer): decode and prefill dispatches, K per
    fused dispatch, 1 per one-forward verify and K per sequential one."""
    calls = eng.stats()["programs"]
    verify = eng.spec.k if eng.spec is not None and eng.spec.sequential \
        else 1
    return (calls["decode"] + calls["prefill"]
            + eng.fused_steps * calls["decode_fused"]
            + verify * calls["spec_verify"])


# the split drives: (name, engine knobs, int8 KV and weights)
SPLIT_DRIVES = (("split", dict(ragged=False), False),
                ("split_sync", dict(ragged=False, sync_mode=True), False),
                ("fused4", dict(fused_steps=4), False),
                ("split_int8", dict(ragged=False, kv_cache_dtype="int8",
                                    weight_dtype="int8"), True))


def e2e_split_phase(model, prompts, export, ragged_step_ms,
                    device="cuda") -> dict:
    """The split programs on the e2e requests, each drive eager and
    graphed: every attention call on the per-row kernel (#2, or #2q with
    int8 KV), every int8 projection on body #4; streams equal to
    ``generate`` (``generate(quant=export)``) except at a reported
    near-tie; step time beside the ragged engine's (``ragged_step_ms``,
    phase 5's graphed p50)."""
    from paddle_tpu_torch.serving import create_serving_engine

    L = len(model.layers)
    result = {}
    for name, knobs, int8 in SPLIT_DRIVES:
        qs = dict(quant_scales=export) if int8 else {}
        runs = drive_modes(
            f"e2e_split/{name}", lambda: create_serving_engine(
                model, device=device, **ENGINE, **knobs, **qs), prompts)
        for mode, (eng, (streams, counts, wall, _), _) in runs.items():
            fwd = split_forwards(eng)
            calls = eng.stats()["programs"]
            expect_counts(f"e2e_split/{name}/{mode}", counts, {
                "attention_cuda": 0, "attention_cuda_int8": 0,
                "attention_cuda_decode": 0 if int8 else L * fwd,
                "attention_cuda_decode_int8": L * fwd if int8 else 0,
                "attention_ref": 0, "qmm_cuda": 6 * L * fwd if int8 else 0,
                "qmm_ref": 0, **NO_STATS})
            if calls["ragged_step"] or (name == "fused4"
                                        and not calls["decode_fused"]):
                raise AssertionError(f"e2e_split/{name}: programs {calls}")
            near = check_streams(f"e2e_split/{name}/{mode}", model, prompts,
                                 streams, export if int8 else None)
        eng, (streams, counts, wall, _), _ = runs["graphed"]
        res = summary(eng, prompts, wall, 0, counts, near)
        res.update(programs=calls, split_forwards=fwd,
                   step_ms_p50_vs_ragged=(res["step_ms"]["p50"]
                                          / ragged_step_ms),
                   modes=modes_summary(runs))
        log("e2e_split", drive=name, **res)
        result[name] = res
        del eng, runs
        free_cuda()
    return result


def spec_prompts(rng, n=8):
    """Prompts made of a short random pattern repeated — the n-gram
    drafter proposes from the prompt's own repeats."""
    out = []
    for i in range(n):
        pat = rng.randint(1, GPT2_SMALL["vocab_size"], (3 + i,))
        out.append(np.tile(pat, 4 + 3 * i).astype(np.int32))
    return out


# the speculative drives: (name, engine knobs); each against the same
# engine with speculation off
SPEC_DRIVES = (("ragged", {}),
               ("split", dict(ragged=False)),
               ("ragged_int8_dynamic", dict(kv_cache_dtype="int8")))


def e2e_spec_phase(model, prompts, device="cuda") -> dict:
    """``spec_decode=4`` on the ragged engine (verify folded into body
    #1), on the split engine (verify on #2) and on the ragged engine with
    uncalibrated int8 KV (the sequential verify and its rollback on #2q,
    the rest on #1q); each drive's streams against the same engine with
    speculation off, a divergence allowed only at a reported near-tie."""
    from paddle_tpu_torch.serving import create_serving_engine

    L = len(model.layers)
    result = {}
    for name, knobs in SPEC_DRIVES:
        int8 = "kv_cache_dtype" in knobs
        off = create_serving_engine(model, device=device, **ENGINE, **knobs)
        want, _, wall_off, _ = drive(off, prompts)
        off_step = off.stats()["metrics"]["step_latency_ms"]["p50"]
        del off
        eng = create_serving_engine(model, device=device, spec_decode=4,
                                    **ENGINE, **knobs)
        streams, counts, wall, _ = drive(eng, prompts)
        calls = eng.stats()["programs"]
        ragged = L * calls["ragged_step"]
        split = L * split_forwards(eng)
        expect_counts(f"e2e_spec/{name}", counts, {
            "attention_cuda": 0 if int8 else ragged,
            "attention_cuda_int8": ragged if int8 else 0,
            "attention_cuda_decode": 0 if int8 else split,
            "attention_cuda_decode_int8": split if int8 else 0,
            "attention_ref": 0, "qmm_cuda": 0, "qmm_ref": 0, **NO_STATS})
        spec = eng.stats()["spec"]
        bad = [] if spec["drafted"] > 0 else ["no drafts"]
        if name == "ragged" and calls["spec_verify"]:
            bad.append("the ragged engine ran the split verifier")
        if name != "ragged" and not calls["spec_verify"]:
            bad.append("no split verify dispatch")
        if int8 and not spec["rollbacks"]:
            bad.append("no rollback")
        if bad:
            raise AssertionError(f"e2e_spec/{name}: {bad}; spec {spec}, "
                                 f"programs {calls}")
        # the uncalibrated int8 arm's gap on its own kind of reference:
        # the spec-off int8_dynamic computation
        near = check_streams(
            f"e2e_spec/{name}", model, prompts, streams, want=want, int8=int8,
            gap_fn=(lambda p, ref, k: logit_gap_int8_dynamic(
                model, p, ref, k)) if int8 else None)
        res = summary(eng, prompts, wall, calls["ragged_step"], counts,
                      near)
        res.update(programs=calls, spec={k: spec[k] for k in (
            "steps", "drafted", "accepted", "rejected", "rollbacks",
            "degraded", "accept_rate")}, spec_off_wall_s=wall_off,
            spec_off_step_ms_p50=off_step)
        log("e2e_spec", drive=name, **res)
        result[name] = res
        del eng
        free_cuda()
    return result


# the mesh drives: 4 long prompts at tp 2 x sp 2 in a pool of MESH_PAGES
# pages (130 per sequence shard, fewer than the ~208 the drive holds, so
# sequences span both page shards); int8 KV and weights on the same; then
# speculative decoding at tp 2 on repeated-pattern prompts
MESH_PROMPT_LENS = (600, 730, 860, 990)
MESH_PAGES = 260
MESH_SLOTS = 4
MESH_DRIVES = (("native", {"tp": 2, "sp": 2}, {}),
               ("int8_static", {"tp": 2, "sp": 2},
                dict(kv_cache_dtype="int8", weight_dtype="int8")),
               ("spec_tp2", {"tp": 2}, dict(spec_decode=4)))


def mesh_drive(eng, prompts):
    """Serve ``prompts`` with every count set to 0 just before; on a mesh
    engine, after the first step (every request admitted) record how many
    sequence shards each sequence's pages span.  Returns (streams,
    counts, wall s, spans)."""
    ids = [eng.add_request(p, max_new_tokens=NEW_TOKENS) for p in prompts]
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.step()
    spans = []
    mesh = eng.stats()["pipeline"]["mesh"]
    if mesh is not None:
        per = eng.cache.num_pages // mesh["sp"]
        spans = sorted(len({p // per for p in
                            eng.cache.seq_page_ids(s.seq_id)})
                       for s in eng.scheduler.running)
    outs = eng.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    if eng.cache.pages_in_use != 0:
        raise AssertionError(f"{eng.cache.pages_in_use} KV pages leaked")
    return [outs[r] for r in ids], counts, wall, spans


def e2e_mesh_phase(model, rng, export, device="cuda") -> dict:
    """The mesh-sharded replica at GPT-2-small width on MESH_SLOTS slots of
    the card: per drive, the single-device engine with the same knobs
    serves the same prompts first (the reference), then the mesh engine,
    eager and graphed (its slots share the card, so it captures); streams
    equal except at a recorded near-tie (at most one), every attention
    launch on the stats kernel at sp 2 (on the ragged kernel at sp 1)
    once per layer, shard and dispatch, one shard step per dispatch, no
    page leaked, sequences on both page shards at sp 2; one steady
    graphed step of the tp 2 x sp 2 drives profiled."""
    from paddle_tpu_torch.distributed import force_device_count, get_mesh
    from paddle_tpu_torch.serving import create_serving_engine

    L = len(model.layers)
    long_prompts = [rng.randint(1, GPT2_SMALL["vocab_size"], (n,)).astype(
        np.int32) for n in MESH_PROMPT_LENS]
    result = {}
    prev = force_device_count(MESH_SLOTS)
    try:
        for name, axes, knobs in MESH_DRIVES:
            prompts = spec_prompts(rng, 4) if "spec_decode" in knobs \
                else long_prompts
            int8 = "kv_cache_dtype" in knobs
            qs = dict(quant_scales=export) if int8 else {}
            kw = dict(ENGINE, num_pages=MESH_PAGES, device=device, **knobs,
                      **qs)
            single = create_serving_engine(model, **kw)
            want, _, single_wall, _ = mesh_drive(single, prompts)
            single_step = single.stats()["metrics"]["step_latency_ms"]
            del single
            free_cuda()
            runs = drive_modes(
                f"e2e_mesh/{name}", lambda: create_serving_engine(
                    model, mesh_axes=axes, **kw), prompts,
                run_drive=mesh_drive)
            slots = [str(d) for d in get_mesh().slots]
            log("e2e_mesh_slots", drive=name, mesh=dict(axes),
                slot_to_card=slots)
            for mode, (eng, (streams, counts, wall, spans), seen) in \
                    runs.items():
                st = seen["stats"]
                dispatches = st["programs"]["ragged_step"]
                sp = st["pipeline"]["mesh"]["sp"]
                shards = st["pipeline"]["mesh"]["devices"]
                on = L * shards * dispatches
                stats_key = "attention_cuda_stats_int8" if int8 \
                    else "attention_cuda_stats"
                ragged_key = "attention_cuda_int8" if int8 \
                    else "attention_cuda"
                want_counts = {"attention_cuda": 0, "attention_cuda_int8": 0,
                               "attention_cuda_decode": 0,
                               "attention_cuda_decode_int8": 0,
                               "attention_ref": 0, "qmm_ref": 0, **NO_STATS,
                               "qmm_cuda": 6 * L * shards * dispatches
                               if int8 else 0}
                want_counts[stats_key if sp > 1 else ragged_key] = on
                expect_counts(f"e2e_mesh/{name}/{mode}", counts, want_counts)
                shard_steps = st["metrics"]["shard"]["steps"]
                bad = []
                if shard_steps != dispatches:
                    bad.append(f"serving.shard.steps {shard_steps} != "
                               f"{dispatches} dispatches")
                if sp > 1 and sp not in spans:
                    bad.append(f"no sequence spans all {sp} page shards "
                               f"(spans {spans})")
                if "spec_decode" in knobs and not st["spec"]["drafted"]:
                    bad.append("no drafts")
                if st["pipeline"]["cuda_graphs"] != (device == "cuda"):
                    bad.append("the mesh on one card does not capture")
                if bad:
                    raise AssertionError(f"e2e_mesh/{name}/{mode}: {bad}")
                near = check_streams(f"e2e_mesh/{name}/{mode}", model,
                                     prompts, streams,
                                     quant=export if int8 else None,
                                     want=want)
                if len(near) > 1:
                    raise AssertionError(f"e2e_mesh/{name}: {len(near)} "
                                         f"near-ties, at most one allowed")
            eng, (streams, counts, wall, spans), _ = runs["graphed"]
            res = summary(eng, prompts, wall, dispatches, counts, near)
            res.update(mesh=st["pipeline"]["mesh"], slot_to_card=slots,
                       page_spans_after_admission=spans,
                       shard=st["metrics"]["shard"],
                       single_device_wall_s=single_wall,
                       single_device_step_ms=single_step,
                       step_ms_label=f"{shards} slots on one card",
                       modes=modes_summary(runs),
                       spec=({k: st["spec"][k] for k in (
                           "drafted", "accepted", "accept_rate")}
                             if "spec_decode" in knobs else None))
            if sp > 1:
                want_launches = {"stats_warp_kernel": L * shards}
                if int8:
                    want_launches["qmm_chunk_kernel"] = 6 * L * shards
                res["profiled_step"] = profile_graphed_step(
                    f"e2e_mesh/{name}", eng, prompts, want_launches)
            log("e2e_mesh", drive=name, **res)
            result[name] = res
            del eng, runs
            free_cuda()
    finally:
        force_device_count(prev)
    return result


SYNC_FREE_STEPS = 32
SYNC_FREE_BUDGET = 48


def sync_free_window(eng, prompts, steps=SYNC_FREE_STEPS,
                     budget=SYNC_FREE_BUDGET) -> dict:
    """Bring ``prompts`` to steady decode on a graphed engine, then run
    ``steps`` steps under ``torch.cuda.set_sync_debug_mode("error")``
    inside ``compile_budget(0, prefix="serving.")``: a host sync raises,
    and so does a capture.  The consume's wait on the oldest dispatch's
    event is the one wait the design allows; it does not trip the mode.
    Every step must keep the bucket and replay the ragged step once.
    Drains and returns the window's programs, buckets and step times."""
    from paddle_tpu_torch.profiler.jit_cost import (compile_budget,
                                                    cost_registry)

    to_steady(eng, prompts, budget)
    before = cost_registry.snapshot()
    buckets, step_ms = set(), []
    with compile_budget(0, prefix="serving."):
        torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(steps):
                t0 = time.perf_counter()
                buckets.add(eng.step()["bucket"])
                step_ms.append((time.perf_counter() - t0) * 1e3)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    programs = jit_delta(before)
    replays = programs.get("serving.ragged_step", {}).get("replays")
    if len(buckets) != 1 or replays != (steps if eng.cuda_graphs else 0):
        raise AssertionError(f"sync_free: buckets {buckets}, programs "
                             f"{programs} over {steps} steps")
    eng.drain()
    if eng.cache.pages_in_use:
        raise AssertionError(f"{eng.cache.pages_in_use} KV pages leaked")
    return {"steps": steps, "bucket": buckets.pop(), "programs": programs,
            "step_ms_p50": float(np.percentile(step_ms, 50)),
            "step_ms_p95": float(np.percentile(step_ms, 95))}


def prefix_window_prompts(rng, vocab, system_len=32, suffix_len=5):
    """The shared-prefix window's prompts: a donor that is ``system``
    itself (served and retired first, so its pages are sealed), then four
    lanes admitted together — ``system`` again (a full-prompt hit: a
    copy-on-write), ``system`` + a suffix (a hit), and two prompts sharing
    a new prefix, whose second lane waits on the write barrier for the
    first one's pages.  Returns (donor, lanes)."""
    system = rng.randint(1, vocab, (system_len,)).astype(np.int32)
    other = rng.randint(1, vocab, (system_len,)).astype(np.int32)
    sfx = [rng.randint(1, vocab, (suffix_len + i,)).astype(np.int32)
           for i in range(3)]
    return system, [system.copy(), np.concatenate([system, sfx[0]]),
                    np.concatenate([other, sfx[1]]),
                    np.concatenate([other, sfx[2]])]


def prefix_sync_free_window(eng, donor, lanes) -> dict:
    """``sync_free_window`` over lanes that share prefixes: the donor is
    served first (retirement seals its pages), then the lanes' admission
    runs the copy-on-write and the write barrier before the window; the
    index must show the hits and the copy."""
    eng.add_request(donor, max_new_tokens=4)
    eng.drain()
    res = sync_free_window(eng, lanes)
    st = eng.stats()["prefix_cache"]
    if st["hits"] < 3 or st["cow_copies"] < 1:
        raise AssertionError(f"sync_free/prefix_shared: prefix stats {st}")
    leak_invariant("sync_free/prefix_shared", eng)
    res["prefix_cache"] = st
    return res


# the tier window's pool, and its flood: one opted-out prompt whose
# admission needs all but one page of it
TIER_WINDOW_PAGES = 64
TIER_FLOOD_LEN = 1000


def tier_sync_free_window(eng, donor, lanes, floods) -> dict:
    """``sync_free_window`` after a demote / promote cycle of a tiered
    engine: the donor is served (its pages are sealed), then ``floods``,
    opted out of the cache, whose admission evicts them — demoted inside
    the admission window — and which free their own pages as they
    retire; the lanes' admission promotes the donor's pages back before
    the window."""
    eng.add_request(donor, max_new_tokens=4)
    eng.drain()
    for p in floods:
        eng.add_request(p, max_new_tokens=2, prefix_cache=False)
    eng.drain()
    res = sync_free_window(eng, lanes)
    st = eng.stats()["prefix_cache"]
    tiers = st["tiers"]
    if not (tiers["demotions"] and tiers["promotions"] and st["hits"]):
        raise AssertionError(f"sync_free/tiers: prefix stats {st}")
    leak_invariant("sync_free/tiers", eng)
    res["prefix_cache"] = st
    return res


def sync_free_phase(model, prompts, export, device="cuda") -> dict:
    """SYNC_FREE_STEPS steady ragged steps of the native, int8_static,
    int8_dynamic and tp 2 x sp 2 mesh engines, graphed, under the sync
    debug mode's "error" and a compile budget of 0 (``sync_free_window``),
    on the first four e2e prompts; and of a prefix-cache engine whose 4
    lanes share prefixes, taken after their admission's copy-on-write and
    write barrier passed (``prefix_sync_free_window``); and of a tiered
    engine after a demote / promote cycle (``tier_sync_free_window``).
    Every arm runs; any failure raises at the end."""
    from paddle_tpu_torch.distributed import force_device_count
    from paddle_tpu_torch.serving import create_serving_engine

    int8 = dict(kv_cache_dtype="int8", weight_dtype="int8")
    arms = (("native", {}), ("int8_static", dict(int8, quant_scales=export)),
            ("int8_dynamic", int8),
            ("mesh", dict(mesh_axes={"tp": 2, "sp": 2},
                          num_pages=MESH_PAGES)),
            ("prefix_shared", dict(prefix_cache=True)),
            ("tiers", dict(prefix_cache=True, kv_tiering={"host_pages": 64},
                           num_pages=TIER_WINDOW_PAGES)))
    donor, lanes = prefix_window_prompts(np.random.RandomState(9),
                                         GPT2_SMALL["vocab_size"])
    flood = np.random.RandomState(12).randint(
        1, GPT2_SMALL["vocab_size"], (TIER_FLOOD_LEN,)).astype(np.int32)
    result, failed = {}, {}
    for name, knobs in arms:
        prev = force_device_count(MESH_SLOTS if name == "mesh" else None)
        try:
            eng = create_serving_engine(model, device=device,
                                        **dict(ENGINE, **knobs))
        finally:
            force_device_count(prev)
        try:
            if name == "prefix_shared":
                result[name] = prefix_sync_free_window(eng, donor, lanes)
            elif name == "tiers":
                result[name] = tier_sync_free_window(eng, donor, lanes,
                                                     [flood])
            else:
                result[name] = sync_free_window(eng, prompts[:4])
        except Exception as exc:  # noqa: BLE001 — every arm reports
            failed[name] = repr(exc)
        del eng
        free_cuda()
    log("sync_free", arms=result, failed=failed)
    if failed:
        raise AssertionError(f"sync_free failed on {sorted(failed)}: "
                             f"{failed}")
    return result


# --------------------------------------------------------------------------
# the prefix cache and warm-failover snapshots (serving/prefix_cache.py,
# serving/resilience.py)
# --------------------------------------------------------------------------
def batched_reference(model, prompts, quant=None):
    """The port's dense greedy decode for prompts of different lengths in
    one batch: every lane steps in lock step through
    ``make_gpt_decode_step`` (the step ``generate`` runs), teacher-forced
    through its own prompt, then fed its own argmax; NEW_TOKENS tokens a
    lane.  The step and the choice of the next token run as one CUDA
    graph (``profiled_graph``, the dense caches donated), replayed once a
    position: one pass for all lanes instead of one ``generate`` per
    prompt, without a host launch a kernel."""
    from paddle_tpu_torch.profiler.jit_cost import profiled_graph
    from paddle_tpu_torch.text.generation import make_gpt_decode_step

    qkw = {}
    if quant is not None:
        qkw = dict(kv_cache_dtype=quant["kv_cache_dtype"],
                   kv_scales=quant["kv_scales"],
                   weight_quant=quant["weights"])
    dev = model.device
    lens = np.array([p.size for p in prompts])
    steps = int(lens.max()) - 1 + NEW_TOKENS
    forced = np.zeros((len(prompts), steps + 1), np.int32)
    for i, p in enumerate(prompts):
        forced[i, :p.size] = p
    forced_d = torch.as_tensor(forced, device=dev)
    is_forced_d = torch.as_tensor(np.arange(steps + 1)[None, :]
                                  < lens[:, None], device=dev)
    step_fn, init_state = make_gpt_decode_step(model, steps + 1, **qkw)
    state = init_state(len(prompts))

    def one(tok, pos, t, k, v):
        logits, new = step_fn(tok, {"k": k, "v": v, "pos": pos})
        nxt = torch.argmax(logits.float(), dim=-1).to(torch.int32)
        t1 = t + 1
        fed = torch.where(is_forced_d.index_select(1, t1)[:, 0],
                          forced_d.index_select(1, t1)[:, 0], nxt)
        return nxt, fed, new["pos"], t1

    run = profiled_graph("reference.dense_step", one, donate_argnums=(3, 4),
                         capture=dev.type == "cuda")
    tok, pos = forced_d[:, 0].contiguous(), state["pos"]
    t = torch.zeros((1,), dtype=torch.long, device=dev)
    outs = []
    with torch.no_grad():
        for _ in range(steps):
            nxt, tok, pos, t = run(tok, pos, t, state["k"], state["v"])
            outs.append(nxt.clone())
    out = torch.stack(outs, dim=1).cpu().numpy()
    return [out[i, n - 1:n - 1 + NEW_TOKENS] for i, n in enumerate(lens)]


def leak_invariant(phase, eng):
    """After a drain: no page in use, and ``pages_in_use + pages_cached +
    free_pages == allocatable_pages``."""
    c = eng.cache
    if c.pages_in_use or (c.pages_in_use + c.pages_cached + c.free_pages
                          != c.allocatable_pages):
        raise AssertionError(
            f"{phase}: pages in use {c.pages_in_use}, cached "
            f"{c.pages_cached}, free {c.free_pages} of "
            f"{c.allocatable_pages}")


def pool_ptrs(eng):
    """The data pointers of every pool tensor (scale rows included), on
    every shard."""
    return [t.data_ptr() for pools in eng._pool_dicts()
            for side in pools.values() for t in side]


# the prefix drive: 8 requests share a 512-token system prompt (32 full
# pages at page 16), each with its own suffix; then 2 requests repeat
# wave-1 prompts exactly (528 and 640 tokens: page multiples, so the match
# covers the whole prompt and the first decode write needs a copy) and 1
# request opts out
PREFIX_SYSTEM_LEN = 512
PREFIX_SUFFIXES = (16, 37, 64, 83, 128, 150, 177, 200)
PREFIX_REPEATS = (0, 4)
PREFIX_OPT_OUT_SUFFIX = 43
# the tight pool: eviction, reclaim and preemption all happen (the drive's
# schedule is host logic: at 160 pages nothing is evicted, at 100 about
# 40 cached pages are and 2 requests are preempted)
PREFIX_TIGHT_PAGES = 100
# (name, engine knobs, int8 KV and weights)
PREFIX_ARMS = (("native", {}, False),
               ("int8_static", {}, True),
               ("split", dict(ragged=False), False),
               ("tight_pool", dict(num_pages=PREFIX_TIGHT_PAGES), False))


def prefix_prompts(rng, vocab):
    """(wave 1, wave 2): lists of (prompt, prefix_cache opt-in)."""
    system = rng.randint(1, vocab, (PREFIX_SYSTEM_LEN,))
    wave1 = [(np.concatenate([system, rng.randint(1, vocab, (n,))]).astype(
        np.int32), True) for n in PREFIX_SUFFIXES]
    opt_out = np.concatenate([system, rng.randint(
        1, vocab, (PREFIX_OPT_OUT_SUFFIX,))]).astype(np.int32)
    wave2 = [(wave1[i][0].copy(), True) for i in PREFIX_REPEATS] + [
        (opt_out, False)]
    return wave1, wave2


def wave_drive(eng, waves):
    """Serve each wave (a list of (prompt, prefix_cache opt-in)) to
    completion in turn, every count set to 0 just before the first and
    read just after the last; a request's TTFT is the host time from its
    ``add_request`` to its first token.  Returns (streams, counts, wall
    s, per wave {"ids", "prefill_rows", "ttft_ms"})."""
    added, first = {}, {}

    def on_token(rid, index, _tok):
        if index == 0 and rid not in first:
            first[rid] = time.perf_counter()

    eng.token_callback = on_token
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs, per_wave = {}, []
    for wave in waves:
        rows0 = eng.metrics.snapshot()["ragged"]["prefill_rows"]
        ids = []
        for p, opt_in in wave:
            rid = eng.add_request(p, max_new_tokens=NEW_TOKENS,
                                  prefix_cache=opt_in)
            added[rid] = time.perf_counter()
            ids.append(rid)
        outs.update(eng.drain())
        per_wave.append({
            "ids": ids,
            "prefill_rows": eng.metrics.snapshot()["ragged"]["prefill_rows"]
            - rows0,
            "ttft_ms": [(first[r] - added[r]) * 1e3 for r in ids]})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    streams = [outs[r] for w in per_wave for r in w["ids"]]
    if [len(s) for s in streams] != [NEW_TOKENS] * len(streams):
        raise AssertionError(f"expected {NEW_TOKENS} tokens per request, "
                             f"got {[len(s) for s in streams]}")
    return streams, counts, wall, per_wave


def e2e_prefix_phase(model, export, device="cuda") -> dict:
    """``prefix_cache=True`` at GPT-2-small width on two waves of requests
    sharing a 512-token system prompt (``prefix_prompts``): native and
    int8_static on the ragged engine, native on the split programs, and
    native in a tight pool (eviction, reclaim and preemption).  Each arm
    is driven with the cache off and on, graphed (the native arm also
    eager with the cache on): streams equal to the batched dense
    reference (``batched_reference``, int8 per the export) and to the
    cache-off drive except at a reported near-tie, the launch counts per
    route, the leak invariant after the drain, no more captures than the
    roomy cache-off drive (the tight pool's own cache-off drive admits
    fewer lanes at a time and so meets fewer signatures: it is held
    against the native arm's), the pools' addresses unchanged, hits,
    copies (and evictions and preemptions in the tight pool)."""
    from paddle_tpu_torch.profiler.flight_recorder import recorder
    from paddle_tpu_torch.profiler.jit_cost import (cost_registry,
                                                    disable_jit)
    from paddle_tpu_torch.serving import create_serving_engine

    L = len(model.layers)
    waves = prefix_prompts(np.random.RandomState(10),
                           GPT2_SMALL["vocab_size"])
    prompts = [p for wave in waves for p, _ in wave]
    t0 = time.perf_counter()
    refs = {False: batched_reference(model, prompts),
            True: batched_reference(model, prompts, export)}
    reference_s = time.perf_counter() - t0
    result = {"reference_s": reference_s,
              "prompt_lens": [int(p.size) for p in prompts]}
    for name, knobs, int8 in PREFIX_ARMS:
        qs = dict(kv_cache_dtype="int8", weight_dtype="int8",
                  quant_scales=export) if int8 else {}
        runs = {}
        modes = [(False, "graphed"), (True, "graphed")]
        if name == "native":
            modes.append((True, "eager"))
        for pc, mode in modes:
            eng = create_serving_engine(model, device=device,
                                        prefix_cache=pc,
                                        **dict(ENGINE, **knobs, **qs))
            ptrs = pool_ptrs(eng)
            before = cost_registry.snapshot()
            if mode == "eager":
                with disable_jit():
                    res = wave_drive(eng, waves)
            else:
                res = wave_drive(eng, waves)
            programs = jit_delta(before)
            tag = f"e2e_prefix/{name}/{'on' if pc else 'off'}/{mode}"
            streams, counts, wall, per_wave = res
            ttft = {"hit": [], "miss": []}
            for w in per_wave:
                for rid, ms in zip(w["ids"], w["ttft_ms"]):
                    tr = recorder.trace(rid) or {"events": []}
                    hit = any(e["kind"] == "prefix_hit"
                              for e in tr["events"])
                    ttft["hit" if hit else "miss"].append(ms)
            st = eng.stats()
            calls = st["programs"]
            if eng.ragged:
                att = L * calls["ragged_step"]
                want_counts = {"attention_cuda": 0 if int8 else att,
                               "attention_cuda_int8": att if int8 else 0,
                               "attention_cuda_decode": 0,
                               "attention_cuda_decode_int8": 0,
                               "qmm_cuda": 6 * att if int8 else 0}
            else:
                fwd = split_forwards(eng)
                want_counts = {"attention_cuda": 0, "attention_cuda_int8": 0,
                               "attention_cuda_decode": L * fwd,
                               "attention_cuda_decode_int8": 0,
                               "qmm_cuda": 0}
            expect_counts(tag, counts, {**want_counts, "attention_ref": 0,
                                        "qmm_ref": 0, **NO_STATS})
            leak_invariant(tag, eng)
            if pool_ptrs(eng) != ptrs:
                raise AssertionError(f"{tag}: a pool tensor was replaced")
            near = check_streams(tag, model, prompts, streams,
                                 quant=export if int8 else None,
                                 want=refs[int8], int8=int8)
            metrics = st["metrics"]
            runs[pc, mode] = {
                "streams": streams, "near_ties": near,
                "wall_s": wall, "launches": counts,
                "captures": sum(p["captures"] for p in programs.values()),
                "programs": programs,
                "prefix": st["prefix_cache"],
                "preemptions": st["preemptions"],
                "prefill_rows": metrics["ragged"]["prefill_rows"],
                "prefill_tokens": metrics["prefill_tokens"],
                "dispatches": calls,
                "step_ms": metrics["step_latency_ms"],
                "ttft_ms_p50": {k: (float(np.percentile(v, 50)) if v
                                    else None) for k, v in ttft.items()},
                "ttft_ms": ttft}
            del eng
            free_cuda()
        on, off = runs[True, "graphed"], runs[False, "graphed"]
        near = check_streams(f"e2e_prefix/{name}/on_vs_off", model, prompts,
                             on["streams"], quant=export if int8 else None,
                             want=off["streams"], int8=int8)
        pst = on["prefix"]
        bad = []
        if pst["hits"] < len(PREFIX_SUFFIXES) - 1 + len(PREFIX_REPEATS) \
                or pst["cow_copies"] != len(PREFIX_REPEATS):
            bad.append(f"prefix stats {pst}")
        roomy_off = result["native"]["off"] if name == "tight_pool" \
            else off
        if on["captures"] > roomy_off["captures"]:
            bad.append(f"{on['captures']} captures with the cache, "
                       f"{roomy_off['captures']} without")
        if name == "tight_pool" and not (pst["evictions"]
                                         and on["preemptions"]):
            bad.append(f"no eviction or preemption: {pst}, "
                       f"{on['preemptions']} preemptions")
        rows = "prefill_rows" if name != "split" else "prefill_tokens"
        if on[rows] >= off[rows]:
            bad.append(f"{rows} {on[rows]} with the cache, {off[rows]} "
                       "without")
        if bad:
            raise AssertionError(f"e2e_prefix/{name}: {bad}")
        res = {"on": {k: v for k, v in on.items() if k != "streams"},
               "off": {k: v for k, v in off.items() if k != "streams"},
               "on_vs_off_near_ties": near}
        if (True, "eager") in runs:
            eager = runs[True, "eager"]
            if not all(np.array_equal(a, b) for a, b in
                       zip(eager["streams"], on["streams"])):
                raise AssertionError(f"e2e_prefix/{name}: eager and graphed "
                                     "streams differ")
            res["on_eager"] = {k: v for k, v in eager.items()
                               if k != "streams"}
            res["step_ms_p50"] = {"eager": eager["step_ms"]["p50"],
                                  "graphed": on["step_ms"]["p50"]}
        log("e2e_prefix", arm=name, **res)
        result[name] = res
    return result


# --------------------------------------------------------------------------
# the host and disk KV page tiers behind the prefix cache
# (serving/kv_transport.py)
# --------------------------------------------------------------------------
# (name, kv_tiering, int8 KV and weights); the disk arm's directory is a
# temporary one, made by the phase
TIER_ARMS = (("native_host", {"host_pages": 64}, False),
             ("native_disk", {"host_pages": 8, "disk_pages": 64}, False),
             ("int8_static_host", {"host_pages": 64}, True))


def tier_waves(vocab):
    """Three waves of 8 requests, lists of (prompt, prefix_cache opt-in):
    e2e_prefix's first wave (a 512-token system prompt, suffixes of
    16-200 tokens); the same suffix lengths over a second system prompt,
    opted out of the cache, whose first admission needs more pages than
    the pool holds, so it evicts every page the first wave left cached —
    inside the admission window, where evictions demote; then the first
    wave's prompts again, whose admission promotes its pages back.  The
    second wave opts out because a promotion only takes a FREE page (it
    never evicts, in either package): a second wave that filled the
    cache would leave none, and its opted-out pages return to the free
    list as each request retires."""
    wave1, _ = prefix_prompts(np.random.RandomState(10), vocab)
    rng = np.random.RandomState(11)
    system = rng.randint(1, vocab, (PREFIX_SYSTEM_LEN,))
    wave2 = [(np.concatenate([system, rng.randint(1, vocab, (n,))]).astype(
        np.int32), False) for n in PREFIX_SUFFIXES]
    return [wave1, wave2, [(p.copy(), True) for p, _ in wave1]]


def time_tier_calls(eng):
    """Host timers around the transport's gather (one page's demotion,
    device to host; it waits for the copy) and restore (one page's
    promotion; the upload and the write are queued, the host does not
    wait) closures.  Returns {"demote_ms": [...], "promote_ms": [...]}."""
    timers = {"demote_ms": [], "promote_ms": []}
    tr = eng.kv_transport
    if tr is None:
        return timers

    def timed(fn, out):
        def run(*args):
            t0 = time.perf_counter()
            try:
                return fn(*args)
            finally:
                out.append((time.perf_counter() - t0) * 1e3)
        return run

    tr._gather = timed(tr._gather, timers["demote_ms"])
    tr._restore = timed(tr._restore, timers["promote_ms"])
    return timers


def e2e_tiers_phase(model, export, device="cuda") -> dict:
    """``kv_tiering`` behind ``prefix_cache=True`` at GPT-2-small width in
    the 100-page pool, on three waves (``tier_waves``), each drained
    before the next: native with a 64-page host tier, native with an
    8-page host tier spilling to a 64-page disk tier (disk hits), and
    int8_static with the host tier, each beside its tiers-off drive
    (graphed).  Checks: streams equal to the batched dense reference and
    to the tiers-off drive except at a reported near-tie; demotions and
    promotions on every arm, disk hits on the disk arm; wave 3 prefills
    fewer rows than without tiers; the pools' addresses unchanged, no
    more captures than the tiers-off drive; the leak invariant; launches
    per route exact.  Reports the host-clock ms of a demotion and of a
    promotion (one page each), wave 3's TTFT p50 with and without tiers
    and the tiers' bytes."""
    import shutil
    import tempfile

    from paddle_tpu_torch.profiler.jit_cost import cost_registry
    from paddle_tpu_torch.serving import create_serving_engine

    L = len(model.layers)
    waves = tier_waves(GPT2_SMALL["vocab_size"])
    prompts = [p for wave in waves for p, _ in wave]
    t0 = time.perf_counter()
    refs = {}
    for int8 in (False, True):
        once = batched_reference(model, prompts[:2 * len(waves[0])],
                                 export if int8 else None)
        refs[int8] = once + once[:len(waves[0])]
    result = {"reference_s": time.perf_counter() - t0,
              "prompt_lens": [int(p.size) for p in prompts],
              "num_pages": PREFIX_TIGHT_PAGES}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tiers_")
    runs = {}
    try:
        arms = (("native_off", False, False),
                ("int8_static_off", False, True)) + TIER_ARMS
        for name, tiering, int8 in arms:
            qs = dict(kv_cache_dtype="int8", weight_dtype="int8",
                      quant_scales=export) if int8 else {}
            if tiering and "disk_pages" in tiering:
                tiering = dict(tiering, disk_dir=os.path.join(tmp, name))
            eng = create_serving_engine(
                model, device=device, prefix_cache=True, kv_tiering=tiering,
                **dict(ENGINE, num_pages=PREFIX_TIGHT_PAGES, **qs))
            ptrs = pool_ptrs(eng)
            before = cost_registry.snapshot()
            timers = time_tier_calls(eng)
            streams, counts, wall, per_wave = wave_drive(eng, waves)
            programs = jit_delta(before)
            tag = f"e2e_tiers/{name}"
            st = eng.stats()
            att = L * st["programs"]["ragged_step"]
            expect_counts(tag, counts, {
                "attention_cuda": 0 if int8 else att,
                "attention_cuda_int8": att if int8 else 0,
                "attention_cuda_decode": 0, "attention_cuda_decode_int8": 0,
                "attention_ref": 0, "qmm_cuda": 6 * att if int8 else 0,
                "qmm_ref": 0, **NO_STATS})
            leak_invariant(tag, eng)
            if pool_ptrs(eng) != ptrs:
                raise AssertionError(f"{tag}: a pool tensor was replaced")
            near = check_streams(tag, model, prompts, streams,
                                 quant=export if int8 else None,
                                 want=refs[int8], int8=int8)
            runs[name] = {
                "streams": streams, "near_ties": near, "wall_s": wall,
                "launches": counts,
                "captures": sum(p["captures"] for p in programs.values()),
                "signatures": set(eng._ragged_fn._sigs),
                "programs": programs, "prefix": st["prefix_cache"],
                "preemptions": st["preemptions"],
                "waves": [{"prefill_rows": w["prefill_rows"],
                           "ttft_ms_p50": float(np.percentile(
                               w["ttft_ms"], 50))} for w in per_wave],
                "demote_ms": _pcts(timers["demote_ms"]),
                "promote_ms": _pcts(timers["promote_ms"]),
                "step_ms": st["metrics"]["step_latency_ms"]}
            del eng
            free_cuda()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for name, _tiering, int8 in TIER_ARMS:
        on = runs[name]
        off = runs["int8_static_off" if int8 else "native_off"]
        near = check_streams(f"e2e_tiers/{name}/on_vs_off", model, prompts,
                             on["streams"], quant=export if int8 else None,
                             want=off["streams"], int8=int8)
        tiers = on["prefix"]["tiers"]
        bad = []
        if not (tiers["demotions"] and tiers["promotions"]):
            bad.append(f"tier stats {tiers}")
        if name == "native_disk" and not tiers["disk_hits"]:
            bad.append(f"no disk hit: {tiers}")
        if on["waves"][2]["prefill_rows"] >= off["waves"][2]["prefill_rows"]:
            bad.append(f"wave 3 prefilled {on['waves'][2]['prefill_rows']} "
                       f"rows with tiers, {off['waves'][2]['prefill_rows']} "
                       "without")
        # no signature captured twice, and no capture beyond the ragged
        # step's signatures that the tiers-off drive did not meet (a
        # promoted prefix moves the first uncached token, and with it the
        # size of a prefill chunk's pow2 tail)
        new_sigs = len(on["signatures"] - off["signatures"])
        if on["captures"] != len(on["signatures"]) \
                or on["captures"] > off["captures"] + new_sigs:
            bad.append(f"{on['captures']} captures of "
                       f"{len(on['signatures'])} signatures with tiers, "
                       f"{off['captures']} without; {new_sigs} signatures "
                       "the tiers-off drive did not meet")
        if bad:
            raise AssertionError(f"e2e_tiers/{name}: {bad}")
        res = {"on": {k: v for k, v in on.items()
                      if k not in ("streams", "signatures")},
               "off_waves": off["waves"], "off_captures": off["captures"],
               "new_signatures": new_sigs,
               "on_vs_off_near_ties": near,
               "demote_ms_per_page_p50": on["demote_ms"]["p50"],
               "promote_ms_per_page_p50": on["promote_ms"]["p50"],
               "wave3_ttft_ms_p50": {"tiers": on["waves"][2]["ttft_ms_p50"],
                                     "off": off["waves"][2]["ttft_ms_p50"]},
               "wave3_prefill_rows": {
                   "tiers": on["waves"][2]["prefill_rows"],
                   "off": off["waves"][2]["prefill_rows"]},
               "host_bytes": tiers["host_bytes"],
               "bytes_per_page": (tiers["host_bytes"] // tiers["host_pages"]
                                  if tiers["host_pages"] else None)}
        log("e2e_tiers", arm=name, **res)
        result[name] = res
    for name in ("native_off", "int8_static_off"):
        result[name] = {k: v for k, v in runs[name].items()
                        if k not in ("streams", "signatures")}
    return result


# the snapshot drive: 4 requests (the first four e2e prompts), each
# snapshotted once it has consumed SNAPSHOT_AT tokens
SNAPSHOT_AT = 8
SNAPSHOT_ARMS = ("native", "int8_static", "int8_dynamic")


def snapshot_run(make_donor, make_survivor, prompts):
    """Serve ``prompts`` on ``make_donor()`` until each request has
    consumed SNAPSHOT_AT tokens, snapshot every one (timed, each ending
    in a device synchronise), drop the donor; restore all snapshots in
    ``make_survivor()`` (the pages' upload timed, synchronised) and drain
    it with the counts set to 0 just before and read just after.
    Returns (spliced streams, counts, survivor, {bytes, snapshot_ms,
    restore_ms: each snapshot's page upload at its admission})."""
    donor = make_donor()
    ids = [donor.add_request(p, max_new_tokens=NEW_TOKENS) for p in prompts]
    snaps = {}
    snap_ms = []
    for _ in range(512):
        done = {s.seq_id for s in donor.scheduler.running
                if len(s.generated) >= SNAPSHOT_AT}
        for rid in sorted(done - snaps.keys()):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            snap = donor.snapshot(rid)
            torch.cuda.synchronize()
            if snap is not None:
                snap_ms.append((time.perf_counter() - t0) * 1e3)
                snaps[rid] = snap
        if len(snaps) == len(ids):
            break
        donor.step()
    else:
        raise AssertionError("the donor never reached the snapshot point")
    del donor
    free_cuda()
    surv = make_survivor()
    ptrs = pool_ptrs(surv)
    restore_ms = []
    upload = surv._upload_snapshot

    def timed_upload(seq):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        upload(seq)
        torch.cuda.synchronize()
        restore_ms.append((time.perf_counter() - t0) * 1e3)

    surv._upload_snapshot = timed_upload
    for rid in ids:
        surv.restore(snaps[rid])
    reset_counts()
    outs = surv.drain()
    torch.cuda.synchronize()
    counts = read_counts()
    leak_invariant("e2e_snapshot", surv)
    if pool_ptrs(surv) != ptrs:
        raise AssertionError("e2e_snapshot: a pool tensor was replaced")
    streams = [outs[r] for r in ids]
    for rid, got in zip(ids, streams):
        if not np.array_equal(got[:snaps[rid].num_generated],
                              snaps[rid].generated):
            raise AssertionError(f"e2e_snapshot: {rid} does not continue "
                                 "its snapshot")
    return streams, counts, surv, {
        "generated_at_snapshot": [int(snaps[r].num_generated) for r in ids],
        "snapshot_bytes": [int(snaps[r].nbytes) for r in ids],
        "snapshot_ms": snap_ms, "restore_ms": restore_ms}


def e2e_snapshot_phase(model, prompts, export, device="cuda") -> dict:
    """Warm failover at GPT-2-small width on the first four e2e prompts:
    per KV mode (native, int8_static, int8_dynamic) an uninterrupted
    graphed drive, then ``snapshot_run`` (a graphed donor, snapshots at
    SNAPSHOT_AT consumed tokens, a fresh graphed survivor): the spliced
    streams equal the uninterrupted ones (and ``generate``, int8 per the
    export, for native and int8_static) except at a reported near-tie;
    the survivor's launches on the kernels; the pools written in place.
    Then a tp 2 x sp 2 mesh donor restored in a single-slot engine and
    the reverse, both against the single-slot engine's uninterrupted
    streams and ``generate``."""
    from paddle_tpu_torch.distributed import force_device_count
    from paddle_tpu_torch.serving import create_serving_engine

    L = len(model.layers)
    # the e2e phases computed ``generate`` for all of them already
    all_prompts, prompts = prompts, prompts[:4]
    result = {}
    for name in SNAPSHOT_ARMS:
        kw = dict(ENGINE, device=device)
        if name != "native":
            kw.update(kv_cache_dtype="int8", weight_dtype="int8")
        if name == "int8_static":
            kw["quant_scales"] = export
        want, _, _, _ = drive(create_serving_engine(model, **kw), prompts)
        streams, counts, surv, res = snapshot_run(
            lambda: create_serving_engine(model, **kw),
            lambda: create_serving_engine(model, **kw), prompts)
        if surv.kv_mode() != name:
            raise AssertionError(f"e2e_snapshot: engine runs "
                                 f"{surv.kv_mode()}, not {name}")
        att = L * surv.stats()["programs"]["ragged_step"]
        int8 = name != "native"
        expect_counts(f"e2e_snapshot/{name}", counts, {
            "attention_cuda": 0 if int8 else att,
            "attention_cuda_int8": att if int8 else 0,
            "attention_cuda_decode": 0, "attention_cuda_decode_int8": 0,
            "attention_ref": 0, "qmm_cuda": 6 * att if int8 else 0,
            "qmm_ref": 0, **NO_STATS})
        q = export if name == "int8_static" else None
        gap_fn = None
        if name == "int8_dynamic":
            # read on the uninterrupted int8_dynamic computation (the
            # engine's own weight export), not on the f32 model
            from paddle_tpu_torch.slim import quantize_gpt_weights

            wq = quantize_gpt_weights(model)

            def gap_fn(p, ref, k):
                return logit_gap_int8_dynamic(model, p, ref, k, weights=wq)
        near = check_streams(f"e2e_snapshot/{name}", model, prompts,
                             streams, quant=q, want=want, int8=int8,
                             gap_fn=gap_fn)
        if name != "int8_dynamic":
            near += check_streams(
                f"e2e_snapshot/{name}/generate", model, prompts, streams,
                quant=q, want=reference_streams(model, all_prompts, q)[:4])
        res.update(near_ties=near, launches=counts,
                   restores=surv.stats()["metrics"]["restores"])
        log("e2e_snapshot", arm=name, **res)
        result[name] = res
        del surv
        free_cuda()
    kw = dict(ENGINE, device=device, num_pages=MESH_PAGES)
    want, _, _, _ = drive(create_serving_engine(model, **kw), prompts)

    def make(axes):
        prev = force_device_count(MESH_SLOTS if axes else None)
        try:
            return create_serving_engine(model, mesh_axes=axes, **kw)
        finally:
            force_device_count(prev)

    mesh = {"tp": 2, "sp": 2}
    for name, donor_axes, surv_axes in (("mesh_to_single", mesh, None),
                                        ("single_to_mesh", None, mesh)):
        streams, counts, surv, res = snapshot_run(
            lambda: make(donor_axes), lambda: make(surv_axes), prompts)
        sp = 2 if surv_axes else 1
        att = L * (4 if surv_axes else 1) * \
            surv.stats()["programs"]["ragged_step"]
        expect_counts(f"e2e_snapshot/{name}", counts, {
            "attention_cuda": 0 if sp > 1 else att,
            "attention_cuda_stats": att if sp > 1 else 0,
            "attention_cuda_int8": 0, "attention_cuda_decode": 0,
            "attention_cuda_decode_int8": 0, "attention_ref": 0,
            "attention_cuda_stats_int8": 0, "attention_ref_stats": 0,
            "qmm_cuda": 0, "qmm_ref": 0})
        near = check_streams(f"e2e_snapshot/{name}", model, prompts,
                             streams, want=want)
        near += check_streams(f"e2e_snapshot/{name}/generate", model,
                              prompts, streams,
                              want=reference_streams(model, all_prompts)[:4])
        res.update(near_ties=near, launches=counts,
                   survivor_mesh=surv.stats()["pipeline"]["mesh"])
        log("e2e_snapshot", arm=name, **res)
        result[name] = res
        del surv
        free_cuda()
    return result


# --------------------------------------------------------------------------
# the serving front door (serving/frontend.py, router.py, http.py,
# profiler/slo.py and exposition.py, io/checkpoint.py)
# --------------------------------------------------------------------------
# replica-0's engine step at which the fleet arm's injected failure fires:
# every request placed there has consumed its first snapshot's 16 tokens
# and none has finished its 32 (the schedule is host logic; the CPU
# rehearsal gives the same one)
FRONTEND_KILL_STEP = 30
# the restart arm's kill of its only replica (4 requests, 16-128 tokens)
RESTART_KILL_STEP = 24
FRONTEND_SNAPSHOT_INTERVAL = 16
# the sync-free arm's budget: the window (steps counted by polling from
# the main thread, which may lag the pump by a few steps) must end well
# before a lane retires
FRONTEND_SYNC_FREE_BUDGET = 96
# every healthz() of the port carries these keys (the fleet rollup is
# ``replicas`` and ``healthy_by_role``; its gauges are serving_fleet_*)
HEALTHZ_KEYS = ("status", "replicas", "healthy_by_role", "slo", "tiers",
                "window")
METRIC_FAMILIES = ("serving_steps", "serving_frontend_completed",
                   "serving_frontend_ttft_ms", "serving_fleet_state",
                   "serving_slo_attainment", "serving_kv_pages_in_use")


def prometheus_families(text) -> dict:
    """{family: type} of a Prometheus 0.0.4 text page; raises on a sample
    line outside its declared family or without a float value, and on a
    family declared twice."""
    types = {}
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            _, _, name, typ = line.split(" ", 3)
            if name in types:
                raise AssertionError(f"/metrics: TYPE {name} twice")
            types[name] = typ
        elif line and not line.startswith("#"):
            name = line.split("{", 1)[0].split(" ", 1)[0]
            if not any(name == f or name.startswith(f + "_")
                       for f in types):
                raise AssertionError(f"/metrics: undeclared sample {line}")
            float(line.rsplit(" ", 1)[1])
    return types


def check_ops_surface(phase, hz, metrics_text):
    """``healthz()`` (or ``GET /healthz``) carries the SLO, tier and fleet
    keys; the exposition parses and has the ``serving.*`` families."""
    missing = [k for k in HEALTHZ_KEYS if k not in hz]
    if missing or set(hz["slo"]["objectives"]) != {
            "availability", "deadline", "nan_quarantine", "ttft_p95"}:
        raise AssertionError(f"{phase}: healthz lacks {missing}: {hz}")
    fams = prometheus_families(metrics_text)
    absent = [f for f in METRIC_FAMILIES if f not in fams]
    if absent:
        raise AssertionError(f"{phase}: /metrics lacks {absent}")
    return {"healthz_keys": sorted(hz), "metric_families": len(fams)}


def time_replica_calls(fe):
    """Host timers around each replica engine's ``step`` and ``snapshot``
    (run by its pump thread; a snapshot is also a ``chip_smoke/snapshot``
    span); returns {replica id: {"step_ms": [...], "snapshot_ms": [...],
    "snapshots": [(kv_mode, page dtype)], "tid": the pump's thread
    ident}}."""
    import threading

    from paddle_tpu_torch.profiler import span

    timers = {}
    for rep in fe._replicas:
        eng = rep.engine
        t = timers[rep.id] = {"step_ms": [], "snapshot_ms": [],
                              "snapshots": [], "tid": None}

        def step(fn=eng.step, out=t["step_ms"], t=t):
            t["tid"] = threading.get_ident()
            t0 = time.perf_counter()
            try:
                return fn()
            finally:
                out.append((time.perf_counter() - t0) * 1e3)

        def snapshot(rid, fn=eng.snapshot, t=t):
            t0 = time.perf_counter()
            with span("chip_smoke/snapshot", request=rid):
                snap = fn(rid)
            t["snapshot_ms"].append((time.perf_counter() - t0) * 1e3)
            if snap is not None:
                t["snapshots"].append(
                    (snap.kv_mode, str(snap.pages["k"][0].dtype)))
            return snap

        eng.step, eng.snapshot = step, snapshot
    return timers


def start_consumers(handles):
    """Iterate every handle's events on a thread of its own (host work
    only: a handle never touches the device), stamping each token's
    arrival.  Returns (threads, {request id: [arrival s]})."""
    import threading

    stamps = {h.request_id: [] for h in handles}

    def run(h):
        for ev in h.events():
            if ev[0] == "token":
                stamps[h.request_id].append(time.perf_counter())

    threads = [threading.Thread(target=run, args=(h,), daemon=True)
               for h in handles]
    for th in threads:
        th.start()
    return threads, stamps


def join_consumers(threads):
    for th in threads:
        th.join(600)
    if any(th.is_alive() for th in threads):
        raise AssertionError("a handle never reached a terminal state")


def consume(handles):
    """``start_consumers`` and wait until every handle is terminal;
    returns the arrival stamps."""
    threads, stamps = start_consumers(handles)
    join_consumers(threads)
    return stamps


def _pcts(xs) -> dict:
    if not xs:
        return {"p50": None, "p95": None, "n": 0}
    return {"p50": float(np.percentile(xs, 50)),
            "p95": float(np.percentile(xs, 95)), "n": len(xs)}


def replica_programs(eng) -> dict:
    """One replica's ragged dispatches, graphs captured (signatures) and
    replays (every later call of a captured signature)."""
    calls = eng.program_calls["ragged_step"]
    sigs = eng._ragged_fn._sigs.values()
    captures = sum(1 for s in sigs if s.graph is not None)
    return {"dispatches": calls, "captures": captures,
            "replays": calls - len(sigs) if captures else 0}


def fleet_report(phase, fe, handles, stamps, timers, wall, killed):
    """The arm's latency and per-replica figures; checks that only the
    replicas in ``killed`` ({id: reason}) died, of exactly that.
    ``handles`` are ResponseHandles or the HTTP final lines (their
    ``ttft_ms``, ``retried``, ``resumed_from``)."""
    dead = {r.id: r.dead_reason for r in fe._replicas if r.state == "dead"}
    if dead != killed:
        raise AssertionError(f"{phase}: dead replicas {dead}, expected "
                             f"{killed}")
    itl = [(b - a) * 1e3 for s in stamps.values()
           for a, b in zip(s, s[1:])]
    snap_ms = [x for t in timers.values() for x in t["snapshot_ms"]]
    esnap = fe.engine_metrics.snapshot()
    def field(h, name):
        return h[name] if isinstance(h, dict) else getattr(h, name)

    return {
        "wall_s": wall,
        "ttft_ms": _pcts([field(h, "ttft_ms") for h in handles]),
        "itl_ms": _pcts(itl),
        "replicas": {
            r.id: dict(replica_programs(r.engine), state=r.state,
                       steps=r.steps,
                       step_ms=_pcts(timers[r.id]["step_ms"]))
            for r in fe._replicas},
        "snapshots": esnap["snapshots"], "snapshot_ms": _pcts(snap_ms),
        "restores": esnap["restores"],
        "ships": esnap["disagg"]["transfer_ms"]["count"],
        "shipped_pages": esnap["disagg"]["shipped_pages"],
        "retried": sum(field(h, "retried") for h in handles),
        "resumed_from": [field(h, "resumed_from") for h in handles],
        "dead": dead}


def frontend_counts(phase, model, counts, engines, int8):
    """The route counters summed over every replica that ran: each
    engine's ragged dispatches times the layers (times 6 for the int8
    matmul)."""
    att = len(model.layers) * sum(
        e.program_calls["ragged_step"] for e in engines)
    expect_counts(phase, counts, {
        "attention_cuda": 0 if int8 else att,
        "attention_cuda_int8": att if int8 else 0,
        "attention_cuda_decode": 0, "attention_cuda_decode_int8": 0,
        "attention_ref": 0, "qmm_cuda": 6 * att if int8 else 0,
        "qmm_ref": 0, **NO_STATS})
    return att


def check_frontend_streams(phase, model, prompts, handles, wants, quant,
                           budget=NEW_TOKENS):
    """Every handle completed, and its first ``budget`` tokens equal each
    reference in ``wants`` except at a reported near-tie of the dense
    reference (int8 per ``quant``, as the fleet served)."""
    bad = {h.request_id: h.status for h in handles
           if h.status != "completed"}
    if bad:
        raise AssertionError(f"{phase}: not completed: {bad}")
    streams = [h.tokens[:budget] for h in handles]
    near = []
    for name, want in wants.items():
        near += check_streams(f"{phase}/{name}", model, prompts, streams,
                              quant=quant, want=want)
    return near


def _ms(xs) -> dict:
    """p50 / p95 / total / count of a list of ms."""
    return dict(_pcts(xs), total=float(sum(xs)))


def _overlap_ms(lo, hi, spans) -> float:
    """ms of [lo, hi] (us) covered by ``spans`` ([(start, end)] in us,
    disjoint)."""
    return sum(max(0.0, min(hi, b) - max(lo, a)) for a, b in spans) / 1e3


def trace_attribution(phase, fe, handles, timers, doc) -> dict:
    """Read a Chrome trace of a fleet drive (``profiler.
    export_chrome_trace`` of the host spans): every replica's pump thread
    must show ``serving/step`` spans with ``serving/ragged_step``
    children.  Returns each replica's step time (spans on its pump
    thread), the share of it in the steps that captured a graph (its
    ``captures`` longest ragged steps), and its snapshots with the time
    each overlapped the other pump's steps and captures; and per request
    (the flight recorder's timeline, on the same monotonic clock) the
    time from submission to admission, from admission to the first
    token, the part of that spent in its replica's capturing steps, and
    its prefill chunks: where the TTFT goes."""
    from paddle_tpu_torch.profiler import aggregates

    names = {e["args"]["name"]: e["tid"] for e in doc["traceEvents"]
             if e["ph"] == "M" and e["name"] == "thread_name"}
    spans = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    # span ts are perf_counter us; the recorder's are monotonic ns
    shift_us = (time.monotonic_ns() - time.perf_counter_ns()) / 1e3
    out = {"replicas": {}, "requests": {}}
    per = {}
    for rep in fe._replicas:
        t = timers[rep.id]
        tid = next((i for n, i in names.items()
                    if n.endswith(f"({t['tid']})")), None)
        mine = [e for e in spans if e["tid"] == tid]
        steps = [e for e in mine if e["name"] == "serving/step"]
        step_ids = {e["args"]["span_id"] for e in steps}
        ragged = [e for e in mine if e["name"] == "serving/ragged_step"
                  and e["args"].get("parent_id") in step_ids]
        if not steps or not ragged:
            raise AssertionError(f"{phase}: the trace holds {len(steps)} "
                                 f"serving/step spans with {len(ragged)} "
                                 f"serving/ragged_step children on "
                                 f"{rep.id}'s pump thread")
        captures = replica_programs(rep.engine)["captures"]
        longest = sorted(ragged, key=lambda e: -e["dur"])[:captures]
        per[rep.id] = {
            "steps": [(e["ts"], e["ts"] + e["dur"]) for e in steps],
            "captures": [(e["ts"], e["ts"] + e["dur"]) for e in longest],
            "snapshots": [(e["ts"], e["ts"] + e["dur"]) for e in mine
                          if e["name"] == "chip_smoke/snapshot"]}
        out["replicas"][rep.id] = {
            "step_ms": _ms([e["dur"] / 1e3 for e in steps]),
            "ragged_step_ms": _ms([e["dur"] / 1e3 for e in ragged]),
            "capture_steps_ms": _ms([e["dur"] / 1e3 for e in longest]),
            "prefill_steps": sum(1 for e in ragged if e["args"]["rows"] > 1),
            "snapshot_ms": _ms([(b - a) / 1e3
                                for a, b in per[rep.id]["snapshots"]])}
    for rep_id, mine in per.items():
        others = [r for r in per if r != rep_id]
        steps = [x for r in others for x in per[r]["steps"]]
        caps = [x for r in others for x in per[r]["captures"]]
        out["replicas"][rep_id]["snapshot_overlap_ms"] = {
            "other_pump_steps": _pcts([_overlap_ms(a, b, steps)
                                       for a, b in mine["snapshots"]]),
            "other_pump_capture_steps": _pcts(
                [_overlap_ms(a, b, caps) for a, b in mine["snapshots"]])}
    waits, prefills, in_captures, chunks = [], [], [], []
    for h in handles:
        ev, n_chunks, where = {}, 0, None
        for e in fe.trace(h.request_id)["events"]:
            ev.setdefault(e["kind"], e["ts_ns"])
            n_chunks += e["kind"] == "prefill_chunk"
            if e["kind"] == "admitted" and where is None:
                where = e.get("replica")
        if "admitted" in ev and "first_token" in ev:
            waits.append((ev["admitted"] - ev["queued"]) / 1e6)
            prefills.append((ev["first_token"] - ev["admitted"]) / 1e6)
            lo = ev["admitted"] / 1e3 - shift_us
            hi = ev["first_token"] / 1e3 - shift_us
            in_captures.append(_overlap_ms(
                lo, hi, per.get(where, {}).get("captures", [])))
            chunks.append(n_chunks)
    out["requests"] = {"submit_to_admit_ms": _pcts(waits),
                       "admit_to_first_token_ms": _pcts(prefills),
                       "admit_to_first_token_in_captures_ms":
                           _pcts(in_captures),
                       "prefill_chunks": _pcts(chunks)}
    out["span_aggregates"] = {
        k: v for k, v in aggregates().items()
        if k.startswith(("serving/", "chip_smoke/"))}
    return out


def frontend_arm(phase, model, prompts, wants, device, *, quant=None,
                 kill=None, trace=False, config=None, **fe_kw):
    """Serve ``prompts`` through one ServingFrontend (built from
    ``config`` through ``create_serving_frontend`` when given), submitted
    together and consumed by iterating the handles, with the counts set
    to 0 just before the submissions and read after the last stream
    ended; ``kill`` = (replica id, step) arms an injected failure first.
    With ``trace`` the drive runs with span retention on, and its Chrome
    trace is written to a temporary file, loaded back and attributed
    (``trace_attribution``).  Checks streams, counters, deaths, leaks and
    the ops surface; returns the arm's report (``fleet_report``) with
    the streams under ``streams``."""
    import tempfile

    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.profiler import prometheus_text
    from paddle_tpu_torch.serving import (ServingFrontend,
                                          create_serving_frontend)

    if config is not None:
        fe = create_serving_frontend(model, config)
    else:
        fe = ServingFrontend(model, device=device, **fe_kw)
    try:
        timers = time_replica_calls(fe)
        killed = {}
        if kill is not None:
            fe.inject_failure(kill[0], at_step=kill[1])
            killed[kill[0]] = f"injected failure at step {kill[1]}"
        if trace:
            profiler.reset_aggregates()
            profiler.enable_tracing()
        reset_counts()
        t0 = time.perf_counter()
        try:
            handles = [fe.submit(p, max_new_tokens=NEW_TOKENS)
                       for p in prompts]
            stamps = consume(handles)
        finally:
            profiler.disable_tracing()
        wall = time.perf_counter() - t0
        counts = read_counts()
        res = fleet_report(phase, fe, handles, stamps, timers, wall, killed)
        if trace:
            with tempfile.TemporaryDirectory(prefix="chip_smoke_trace_") \
                    as d:
                path = profiler.export_chrome_trace(
                    os.path.join(d, "fleet.json"))
                res["trace_bytes"] = os.path.getsize(path)
                with open(path) as f:
                    doc = json.load(f)
            res["trace"] = trace_attribution(phase, fe, handles, timers,
                                             doc)
            res["trace_spans"] = len(profiler.get_spans())
            profiler.clear_spans()
        res["launches"] = counts
        frontend_counts(phase, model, counts,
                        [r.engine for r in fe._replicas], quant is not None)
        res["near_ties"] = check_frontend_streams(phase, model, prompts,
                                                  handles, wants, quant)
        for rep in fe._replicas:
            if rep.state != "dead":
                leak_invariant(f"{phase}/{rep.id}", rep.engine)
        res["ops"] = check_ops_surface(phase, fe.healthz(),
                                       prometheus_text())
        res["snapshot_kinds"] = sorted({k for t in timers.values()
                                        for k in t["snapshots"]})
        res["streams"] = [np.asarray(h.tokens[:NEW_TOKENS], np.int32)
                          for h in handles]
        return res
    finally:
        fe.close()


def restart_arm(model, prompts, wants, device) -> dict:
    """A frontend with a ``snapshot_store`` in a temporary directory loses
    its only replica mid-decode (every request ``failed``, the slots
    stay); a new frontend's ``recover_pending()`` finishes them from the
    slots."""
    import shutil
    import tempfile

    from paddle_tpu_torch.serving import ServingFrontend

    d = tempfile.mkdtemp(prefix="chip_smoke_slots_")
    try:
        kw = dict(replicas=1, engine_kwargs=dict(ENGINE), device=device,
                  snapshot_interval=FRONTEND_SNAPSHOT_INTERVAL,
                  snapshot_store=d)
        fe = ServingFrontend(model, **kw)
        try:
            fe.inject_failure("replica-0", at_step=RESTART_KILL_STEP)
            reset_counts()
            t0 = time.perf_counter()
            lost = [fe.submit(p, max_new_tokens=NEW_TOKENS) for p in prompts]
            if [h.wait(600) for h in lost] != ["failed"] * len(prompts):
                raise AssertionError(f"e2e_frontend/restart: "
                                     f"{[h.status for h in lost]}")
            dead = {r.id: r.dead_reason for r in fe._replicas}
            engines = [fe._replicas[0].engine]
        finally:
            fe.close()
        if dead != {"replica-0":
                    f"injected failure at step {RESTART_KILL_STEP}"}:
            raise AssertionError(f"e2e_frontend/restart: deaths {dead}")
        slots = sorted(os.listdir(d))
        fe2 = ServingFrontend(model, **kw)
        try:
            timers = time_replica_calls(fe2)
            handles = fe2.recover_pending()
            stamps = consume(handles)
            wall = time.perf_counter() - t0
            counts = read_counts()
            engines.append(fe2._replicas[0].engine)
            order = {h.request_id: h for h in handles}
            handles = [order[h.request_id] for h in lost]
            res = fleet_report("e2e_frontend/restart", fe2, handles, stamps,
                               timers, wall, {})
            res.update(launches=counts, slots=slots,
                       skipped=fe2._snapshot_store.last_skipped)
            frontend_counts("e2e_frontend/restart", model, counts, engines,
                            False)
            res["near_ties"] = check_frontend_streams(
                "e2e_frontend/restart", model, prompts, handles, wants,
                None)
            if len(slots) != len(prompts) or any(
                    (h.resumed_from or 0) < FRONTEND_SNAPSHOT_INTERVAL
                    for h in handles):
                raise AssertionError(
                    f"e2e_frontend/restart: slots {slots}, resumed from "
                    f"{[h.resumed_from for h in handles]}")
            leak_invariant("e2e_frontend/restart", fe2._replicas[0].engine)
            return res
        finally:
            fe2.close()
    finally:
        shutil.rmtree(d, ignore_errors=True)


def http_arm(model, prompts, wants, device) -> dict:
    """``start_http_server(frontend, port=0)`` on 127.0.0.1: two streamed
    ``POST /generate`` at once (chunked NDJSON, each on its own client
    thread), then ``GET /healthz`` and ``GET /metrics``."""
    import http.client
    import threading

    from paddle_tpu_torch.serving import ServingFrontend, start_http_server

    fe = ServingFrontend(model, replicas=1, engine_kwargs=dict(ENGINE),
                         device=device)
    timers = time_replica_calls(fe)
    srv = start_http_server(fe, port=0)
    try:
        out, stamps = {}, {}

        def post(i, p):
            conn = http.client.HTTPConnection(srv.host, srv.port,
                                              timeout=600)
            conn.request("POST", "/generate", json.dumps(
                {"prompt": p.tolist(), "max_new_tokens": NEW_TOKENS}),
                {"Content-Type": "application/json"})
            r = conn.getresponse()
            lines, stamps[i] = [], []
            for raw in iter(r.readline, b""):      # one NDJSON line a chunk
                lines.append(json.loads(raw))
                if "token" in lines[-1]:
                    stamps[i].append(time.perf_counter())
            out[i] = (r.status, r.getheader("Transfer-Encoding"), lines)
            conn.close()

        reset_counts()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=post, args=(i, p))
                   for i, p in enumerate(prompts)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(600)
        wall = time.perf_counter() - t0
        counts = read_counts()
        streams = []
        for i in range(len(prompts)):
            status, te, lines = out[i]
            final = lines[-1]
            if status != 200 or te != "chunked" or not final.get("done") \
                    or final["status"] != "completed":
                raise AssertionError(f"e2e_frontend/http: request {i}: "
                                     f"{status} {te} {final}")
            streams.append(np.asarray([ln["token"] for ln in lines
                                       if "token" in ln], np.int32))
        near = []
        for name, want in wants.items():
            near += check_streams(f"e2e_frontend/http/{name}", model,
                                  prompts, streams, want=want)
        conn = http.client.HTTPConnection(srv.host, srv.port, timeout=60)
        conn.request("GET", "/healthz")
        r = conn.getresponse()
        hz = json.loads(r.read())
        conn.request("GET", "/metrics")
        r2 = conn.getresponse()
        text = r2.read().decode()
        rid = out[0][2][-1]["request_id"]
        conn.request("GET", f"/debug/requests/{rid}?format=chrome")
        r3 = conn.getresponse()
        chrome = json.loads(r3.read())
        conn.close()
        if r.status != 200 or r2.status != 200 or r3.status != 200 \
                or not chrome.get("traceEvents"):
            raise AssertionError(f"e2e_frontend/http: /healthz {r.status}, "
                                 f"/metrics {r2.status}, ?format=chrome "
                                 f"{r3.status}")
        frontend_counts("e2e_frontend/http", model, counts,
                        [fe._replicas[0].engine], False)
        finals = [out[i][2][-1] for i in range(len(prompts))]
        # TTFT from the server's handles (the final lines), ITL from the
        # client's arrival stamps
        res = fleet_report("e2e_frontend/http", fe, finals, stamps, timers,
                           wall, {})
        res.update(near_ties=near, launches=counts, final_lines=finals,
                   ops=check_ops_surface("e2e_frontend/http", hz, text),
                   chrome_trace_events=len(chrome["traceEvents"]))
        return res
    finally:
        srv.stop()
        fe.close()
        leak_invariant("e2e_frontend/http", fe._replicas[0].engine)


def frontend_sync_free_arm(model, prompts, device) -> dict:
    """One replica without snapshots serves 4 requests; once every lane
    decodes, its pump runs at least SYNC_FREE_STEPS whole steps under
    ``set_sync_debug_mode("error")`` inside ``compile_budget(0,
    prefix="serving.")`` while the main thread only polls a host list.
    A sync in the pump would raise in its step and kill the replica; a
    capture would trip the budget.  The pump itself records, after each
    step, the engine's ragged dispatches and graph signatures, so the
    window's counts and its steps are read at the same points."""
    from paddle_tpu_torch.profiler.jit_cost import compile_budget
    from paddle_tpu_torch.serving import ServingFrontend

    fe = ServingFrontend(model, replicas=1, engine_kwargs=dict(ENGINE),
                         snapshot_interval=None, device=device)
    try:
        rep = fe._replicas[0]
        eng = rep.engine
        timers = time_replica_calls(fe)
        after_step = []          # (dispatches, signatures), pump-appended
        timed_step = eng.step

        def step():
            out = timed_step()
            after_step.append((eng.program_calls["ragged_step"],
                               len(eng._ragged_fn._sigs)))
            return out

        eng.step = step
        t0 = time.perf_counter()
        handles = [fe.submit(p, max_new_tokens=FRONTEND_SYNC_FREE_BUDGET)
                   for p in prompts]
        threads, stamps = start_consumers(handles)
        end = time.monotonic() + 600
        while (eng.scheduler.waiting or eng._prefill_plans
               or min(h.num_tokens for h in handles) < 2):
            if time.monotonic() > end or rep.state == "dead":
                raise AssertionError("e2e_frontend/sync_free: the lanes "
                                     "never reached steady decode")
            time.sleep(0.0005)
        # two more steps: the steady signature's first call and its
        # first replay (as ``to_steady``)
        i0 = len(after_step) + 2
        while len(after_step) < i0:
            time.sleep(0.0005)
        # the steps that end at indices i0 + 1 .. i1 - 1 ran wholly
        # inside the window
        with compile_budget(0, prefix="serving."):
            torch.cuda.set_sync_debug_mode("error")
            try:
                while len(after_step) < i0 + SYNC_FREE_STEPS + 2 \
                        and rep.state != "dead" \
                        and time.monotonic() < end:
                    time.sleep(0.0005)
                i1 = len(after_step)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        join_consumers(threads)
        wall = time.perf_counter() - t0
        steps = i1 - 1 - i0
        (d0, s0), (d1, s1) = after_step[i0], after_step[i1 - 1]
        if [h.status for h in handles] != ["completed"] * len(handles) \
                or rep.state == "dead" or steps < SYNC_FREE_STEPS \
                or d1 - d0 != steps or s1 != s0:
            raise AssertionError(
                f"e2e_frontend/sync_free: {steps} steps, {d1 - d0} "
                f"dispatches, {s1 - s0} new graphs; replica {rep.state} "
                f"({rep.dead_reason}), {[h.status for h in handles]}")
        res = fleet_report("e2e_frontend/sync_free", fe, handles, stamps,
                           timers, wall, {})
        # every dispatch of a signature captured before the window is a
        # replay on a graphed engine
        res.update(window_steps=steps, window_dispatches=d1 - d0,
                   window_replays=(d1 - d0) if eng.cuda_graphs else 0,
                   window_new_graphs=s1 - s0,
                   tokens=[h.num_tokens for h in handles])
        return res
    finally:
        fe.close()
        leak_invariant("e2e_frontend/sync_free", fe._replicas[0].engine)


def e2e_frontend_phase(model, prompts, export, e2e_streams, int8_streams,
                       device="cuda") -> dict:
    """The serving front door at GPT-2-small width, on the e2e prompts:
    ``ServingFrontend`` over two graphed replicas with warm-failover
    snapshots every 16 tokens and an injected mid-decode failure of
    replica-0 (its requests resume on replica-1 from their snapshots);
    the same fleet with snapshots off and no failure; a disaggregated
    int8_static fleet (one prefill, one decode replica: #1q and #4
    through the front door, each ship an int8 snapshot); restart
    recovery from a ``CheckpointStore``; the HTTP server (a request's
    timeline also as ``?format=chrome``); a sync-free window through the
    pump; and the two-replica fleet built from an ``inference.Config``
    (``create_serving_frontend(model, config)``), whose streams must
    equal the keyword-built fleet's.  The first fleet runs with span
    retention on: its Chrome trace shows both pumps' steps and attributes
    the TTFT (``trace_attribution``).  Every stream equals the batched
    dense reference and the bare engine's e2e streams (int8 per the
    export) except at a reported near-tie; every arm runs, any failure
    raises at the end."""
    from paddle_tpu_torch.inference import Config

    t_phase = time.perf_counter()
    want = {"batched_reference": batched_reference(model, prompts),
            "engine_e2e": e2e_streams}
    want8 = {"batched_reference": batched_reference(model, prompts,
                                                    quant=export),
             "engine_e2e_int8_static": int8_streams}
    int8_engine = dict(ENGINE, kv_cache_dtype="int8", weight_dtype="int8",
                       quant_scales=export)
    config = Config()
    if torch.device(device).type == "cpu":
        config.disable_gpu()
    config.enable_serving(replicas=2, snapshot_interval=None, **ENGINE)
    streams = {}
    arms = (
        ("fleet", lambda: frontend_arm(
            "e2e_frontend/fleet", model, prompts, want, device,
            kill=("replica-0", FRONTEND_KILL_STEP), replicas=2,
            snapshot_interval=FRONTEND_SNAPSHOT_INTERVAL,
            engine_kwargs=dict(ENGINE), trace=True)),
        ("interval_off", lambda: frontend_arm(
            "e2e_frontend/interval_off", model, prompts, want, device,
            replicas=2, snapshot_interval=None,
            engine_kwargs=dict(ENGINE))),
        ("config", lambda: frontend_arm(
            "e2e_frontend/config", model, prompts,
            dict(want, frontend_kwargs=streams["interval_off"]), device,
            config=config)),
        ("disaggregated_int8", lambda: frontend_arm(
            "e2e_frontend/disaggregated_int8", model, prompts, want8,
            device, quant=export, replicas=1, prefill_replicas=1,
            snapshot_interval=FRONTEND_SNAPSHOT_INTERVAL,
            engine_kwargs=int8_engine)),
        ("restart", lambda: restart_arm(
            model, prompts[:4], {k: v[:4] for k, v in want.items()},
            device)),
        ("http", lambda: http_arm(
            model, prompts[:2], {k: v[:2] for k, v in want.items()},
            device)),
        ("sync_free", lambda: frontend_sync_free_arm(model, prompts[:4],
                                                     device)))
    result, failed = {}, {}
    for name, run in arms:
        t0 = time.perf_counter()
        try:
            res = run()
            streams[name] = res.pop("streams", None)
            if name == "fleet" and not any(
                    r is not None for r in res["resumed_from"]):
                raise AssertionError("e2e_frontend/fleet: no request "
                                     "resumed from a snapshot")
            if name == "config" and (
                    len(res["replicas"]) != 2 or any(
                        r["dispatches"] == 0
                        for r in res["replicas"].values())):
                raise AssertionError(f"e2e_frontend/config: replicas "
                                     f"{res['replicas']}")
            if name == "disaggregated_int8" and (
                    res["shipped_pages"] == 0
                    or res["snapshot_kinds"] != [("int8_static", "int8")]):
                raise AssertionError(
                    f"e2e_frontend/disaggregated_int8: ships "
                    f"{res['ships']}, pages {res['shipped_pages']}, "
                    f"snapshots {res['snapshot_kinds']}")
            res["arm_s"] = time.perf_counter() - t0
            result[name] = res
            log("e2e_frontend", arm=name, **res)
        except Exception as exc:  # noqa: BLE001 — every arm reports
            failed[name] = repr(exc)
            log("e2e_frontend", arm=name, failed=repr(exc))
        free_cuda()
    log("e2e_frontend", phase_s=time.perf_counter() - t_phase,
        failed=failed)
    if failed:
        raise AssertionError(f"e2e_frontend failed on {sorted(failed)}: "
                             f"{failed}")
    return result


# --------------------------------------------------------------------------
# inference.Config and utils.profiler on the serving path
# --------------------------------------------------------------------------
# the paged kernel's two forms, as named in a device trace
STEP_KERNELS = ("ragged_decode_kernel", "ragged_prefill_kernel")


def kernels_in_steps(doc) -> dict:
    """In a ``torch.profiler`` Chrome trace: the paged kernel's device
    launches, and how many of them ran inside a ``serving/step`` range —
    the kernel inside the range on the device timeline
    (``gpu_user_annotation``), or the host call that launched it (its
    ``correlation``: a ``cudaGraphLaunch`` for a replay) inside the host
    range (``user_annotation``)."""
    evs = doc["traceEvents"]
    host = [(e["ts"], e["ts"] + e["dur"]) for e in evs
            if e.get("cat") == "user_annotation"
            and e.get("name") == "serving/step"]
    dev = [(e["ts"], e["ts"] + e["dur"]) for e in evs
           if e.get("cat") == "gpu_user_annotation"
           and e.get("name") == "serving/step"]
    calls = {e["args"]["correlation"]: e for e in evs
             if e.get("cat") in ("cuda_runtime", "cuda_driver")
             and "correlation" in e.get("args", {})}
    kernels = [e for e in evs if e.get("cat") == "kernel"
               and any(k in e.get("name", "") for k in STEP_KERNELS)]
    inside = 0
    for k in kernels:
        call = calls.get(k.get("args", {}).get("correlation"))
        inside += (any(a <= k["ts"] and k["ts"] + k["dur"] <= b
                       for a, b in dev)
                   or (call is not None
                       and any(a <= call["ts"] <= b for a, b in host)))
    return {"step_ranges_host": len(host), "step_ranges_device": len(dev),
            "paged_kernels": len(kernels), "inside_steps": inside,
            "events": len(evs)}


def e2e_profile_phase(model, prompts, e2e_streams, device="cuda") -> dict:
    """The engine built from an ``inference.Config``
    (``Config().enable_serving(**ENGINE)`` and
    ``create_serving_engine(model, config)``) on the first 4 e2e prompts,
    graphed: the first drive captures its signatures, the second runs
    under ``utils.profiler.start_profiler`` / ``stop_profiler(
    timeline_path=..., profile_path=...)``.  Both drives' streams equal
    the keyword-built e2e engine's except at a reported near-tie, the
    launches per route are exact, and the device trace holds every
    launch of the paged kernel inside a ``serving/step`` range."""
    import tempfile

    from paddle_tpu_torch.inference import Config
    from paddle_tpu_torch.profiler.jit_cost import cost_registry
    from paddle_tpu_torch.serving import create_serving_engine
    from paddle_tpu_torch.utils.profiler import start_profiler, stop_profiler

    config = Config()
    if torch.device(device).type == "cpu":
        config.disable_gpu()
    config.enable_serving(**ENGINE)
    eng = create_serving_engine(model, config)
    sub, want = prompts[:4], e2e_streams[:4]
    L = len(model.layers)
    result = {"device": str(eng.device)}
    for mode in ("capture", "profiled"):
        calls = eng.program_calls["ragged_step"]
        before = cost_registry.snapshot()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_prof_") as d:
            timeline = os.path.join(d, "timeline.json")
            table = os.path.join(d, "profile.txt")
            if mode == "profiled":
                start_profiler()
            try:
                streams, counts, wall, _ = drive(eng, sub)
            finally:
                if mode == "profiled":
                    stop_profiler(profile_path=table,
                                  timeline_path=timeline)
            if mode == "profiled":
                with open(timeline) as f:
                    doc = json.load(f)
                with open(table) as f:
                    spans = f.read()
                result["timeline_bytes"] = os.path.getsize(timeline)
        att = L * (eng.program_calls["ragged_step"] - calls)
        expect_counts(f"e2e_profile/{mode}", counts, {
            "attention_cuda": att, "attention_ref": 0, "qmm_cuda": 0,
            "qmm_ref": 0, **NO_STATS})
        near = check_streams(f"e2e_profile/{mode}", model, sub, streams,
                             want=want)
        result[mode] = {"wall_s": wall, "launches": counts,
                        "programs": jit_delta(before), "near_ties": near}
    trace = kernels_in_steps(doc)
    result["trace"] = trace
    if "serving/step" not in spans or not trace["step_ranges_host"] or (
            eng.device.type == "cuda"
            and not (trace["paged_kernels"]
                     == trace["inside_steps"]
                     == result["profiled"]["launches"]["attention_cuda"])):
        raise AssertionError(f"e2e_profile: trace {trace}, launches "
                             f"{result['profiled']['launches']}")
    leak_invariant("e2e_profile", eng)
    log("e2e_profile", **result)
    return result


# a GPT with a head dim of 256 (hidden 1024 over 4 heads, 2 layers): the
# paged kernels' widest instances on the serving path
WIDE_GPT = dict(vocab_size=1024, hidden_size=1024, num_layers=2,
                num_heads=4, ffn_size=4096, max_seq_len=512)
WIDE_PROMPT_LENS = (16, 77, 190, 333)


def e2e_wide_phase(rng, device="cuda") -> dict:
    """The WIDE_GPT model (seeded random weights) served by the ragged
    engine on WIDE_PROMPT_LENS prompts, native and int8_static (an export
    calibrated on the card): every attention call on body #1 or #1q at
    D 256, every int8 projection on body #4, streams equal to
    ``generate`` (``generate(quant=export)``) except at a reported
    near-tie, no page leaked."""
    from paddle_tpu_torch.serving import create_serving_engine
    from paddle_tpu_torch.slim import export_serving_quant
    from paddle_tpu_torch.text.models import GPTModel

    model = GPTModel(**WIDE_GPT, device=device, seed=4321)
    V, L = WIDE_GPT["vocab_size"], WIDE_GPT["num_layers"]
    prompts = [rng.randint(1, V, (n,)).astype(np.int32)
               for n in WIDE_PROMPT_LENS]
    result = {"head_dim": WIDE_GPT["hidden_size"] // WIDE_GPT["num_heads"]}
    for name in ("native", "int8_static"):
        export, knobs = None, {}
        if name == "int8_static":
            export = export_serving_quant(
                model, calib_prompts=rng.randint(1, V, (4, 64)))
            knobs = dict(kv_cache_dtype="int8", weight_dtype="int8",
                         quant_scales=export)
        eng = create_serving_engine(model, device=device, **ENGINE, **knobs)
        if eng.kv_mode() != name:
            raise AssertionError(f"e2e_wide: the engine runs "
                                 f"{eng.kv_mode()}, not {name}")
        streams, counts, wall, dispatches = drive(eng, prompts)
        on = L * dispatches
        expect_counts(f"e2e_wide/{name}", counts, {
            "attention_cuda": 0 if export else on,
            "attention_cuda_int8": on if export else 0,
            "attention_cuda_decode": 0, "attention_cuda_decode_int8": 0,
            "attention_ref": 0, "qmm_cuda": 6 * on if export else 0,
            "qmm_ref": 0, **NO_STATS})
        near = check_streams(f"e2e_wide/{name}", model, prompts, streams,
                             export)
        res = summary(eng, prompts, wall, dispatches, counts, near)
        log("e2e_wide", drive=name, **res)
        result[name] = res
        del eng
        free_cuda()
    return result


# beam search on GPT-2-small: B prompts of BEAM_PROMPT tokens, K beams,
# BEAM_NEW new tokens; end_id 0, a real token (paddle_tpu reads end_id -1
# as the last vocab entry: the port follows it, but the drive uses a
# real id)
BEAM_BATCH, BEAM_PROMPT, BEAM_K, BEAM_NEW, BEAM_END_ID = 4, 64, 4, 32, 0
BEAM_ALPHAS = (0.0, 0.6)
# a beam's score against the log-probs of its own tokens re-scored by one
# full-sequence forward: 32 f32 log-probs from another summation order
# (the full forward against the dense ring's cached steps), each off by
# ~1e-5 on logits of magnitude ~10
BEAM_SCORE_TOL = 1e-3


def beam_lengths(ids, end_id):
    """Position of each beam's first ``end_id`` plus one, or T."""
    is_end = (ids == end_id).to(torch.int32)
    T = ids.shape[-1]
    return torch.where(is_end.amax(-1) > 0, is_end.argmax(-1) + 1, T)


@torch.no_grad()
def beam_rescore(model, prompts, ids, end_id):
    """Each beam's summed log-prob of its own tokens (up to and including
    its first ``end_id``) under one full-sequence ``GPTModel.forward``."""
    B, K, T = ids.shape
    P = prompts.shape[1]
    seq = torch.cat([prompts.repeat_interleave(K, 0).long(),
                     ids.reshape(B * K, T).long()], dim=1)
    lp = torch.log_softmax(model(seq)[:, P - 1:P + T - 1].float(), dim=-1)
    tok = lp.gather(-1, seq[:, P:, None])[..., 0]             # [B*K, T]
    live = (torch.arange(T, device=ids.device)[None, :]
            < beam_lengths(ids, end_id).reshape(B * K, 1))
    return (tok * live).sum(-1).reshape(B, K)


def dequantized_model(model, export):
    """A copy of ``model`` whose quantized weights are ``w_q * scale``:
    the f32 forward of what the int8 arm multiplies by."""
    import copy

    from paddle_tpu_torch.text.models import load_numpy_state, numpy_state

    state = numpy_state(model)
    for name, (q, sc) in export["weights"].items():
        state[name] = np.asarray(q, np.float32) * np.asarray(sc)[None, :]
    return load_numpy_state(copy.deepcopy(model), state)


@torch.no_grad()
def beam_prefilled(model, prompts, quant=None):
    """``generate``'s beam set-up: the dense step, the prompts but their
    last token prefilled once per sequence."""
    from paddle_tpu_torch.text.generation import (make_gpt_decode_step,
                                                  prefill)

    qkw = {}
    if quant is not None:
        qkw = dict(weight_quant=quant["weights"])
    P = prompts.shape[1]
    step_fn, init_state = make_gpt_decode_step(model, P + BEAM_NEW + 1,
                                               **qkw)
    state, _ = prefill(step_fn, init_state(prompts.shape[0]),
                       prompts[:, :-1])
    return step_fn, state


def beam_lanes(state, K):
    from paddle_tpu_torch.nn.decode import tree_map

    return tree_map(lambda s: s.repeat_interleave(K, dim=0), state)


@torch.no_grad()
def beam_trace(step_fn, state, prompts, K, alpha):
    """``beam_search_decode``'s loop step by step: each step's tokens and
    parents, and the smallest gap between adjacent ranks of its top K + 1
    candidates in the units selection compares (``flat / lp``)."""
    from paddle_tpu_torch.nn.decode import (_NEG_INF, _length_penalty,
                                            beam_search_step, tree_map)

    B, dev = prompts.shape[0], prompts.device
    tokens = prompts[:, -1:].expand(B, K).to(torch.int32)
    scores = torch.full((B, K), _NEG_INF, device=dev)
    scores[:, 0] = 0.0
    finished = torch.zeros((B, K), dtype=torch.bool, device=dev)
    lane0 = torch.arange(B, device=dev)[:, None] * K
    steps = []
    for t in range(BEAM_NEW):
        logits, state = step_fn(tokens.reshape(-1), state)
        lp = torch.log_softmax(logits.reshape(B, K, -1), dim=-1)
        cont = torch.where(finished[..., None], _NEG_INF, lp)
        cont[..., BEAM_END_ID] = torch.where(finished, 0.0,
                                             cont[..., BEAM_END_ID])
        keys = (scores[..., None] + cont).reshape(B, -1)
        if alpha:
            keys = keys / _length_penalty(t + 1, alpha)
        top = torch.topk(keys, K + 1).values
        gap = float((top[:, :-1] - top[:, 1:]).min())
        scores, tokens, parent = beam_search_step(
            scores, lp, finished, K, BEAM_END_ID, length_penalty=alpha,
            step=t + 1)
        state = tree_map(lambda s: s[(parent + lane0).reshape(-1)], state)
        finished = (torch.gather(finished, 1, parent.long())
                    | (tokens == BEAM_END_ID))
        steps.append((tokens.cpu().numpy(), parent.cpu().numpy(), gap))
    return steps


class plain_qmm:
    """Within it the serving steps multiply by the int8 matmul's plain
    version (``quantized_matmul_ref``) on the card: the comparison arm
    of the int8 beam drive."""

    def __enter__(self):
        from paddle_tpu_torch.ops.quantized_matmul import \
            quantized_matmul_ref
        from paddle_tpu_torch.text import generation

        self._saved = generation.quantized_matmul
        generation.quantized_matmul = quantized_matmul_ref

    def __exit__(self, *exc):
        from paddle_tpu_torch.text import generation

        generation.quantized_matmul = self._saved


def check_beams(arm, model, prompts, ids, scores, rescorer):
    """Shapes, best-first scores, and each score against its beam's
    re-scored log-probs (``rescorer``: the f32 model the arm computes)."""
    want = (BEAM_BATCH, BEAM_K, BEAM_NEW)
    if tuple(ids.shape) != want or tuple(scores.shape) != want[:2]:
        raise AssertionError(f"e2e_beam/{arm}: ids {tuple(ids.shape)}, "
                             f"scores {tuple(scores.shape)}")
    if not torch.isfinite(scores).all():
        raise AssertionError(f"e2e_beam/{arm}: scores not finite")
    if (scores[:, 1:] > scores[:, :-1]).any():
        raise AssertionError(f"e2e_beam/{arm}: scores not best-first: "
                             f"{scores.tolist()}")
    err = float((beam_rescore(rescorer, prompts, ids, BEAM_END_ID)
                 - scores).abs().max())
    if not err <= BEAM_SCORE_TOL:
        raise AssertionError(f"e2e_beam/{arm}: a score is {err} from its "
                             f"beam's re-scored log-probs (limit "
                             f"{BEAM_SCORE_TOL})")
    return err


def e2e_beam_phase(model, rng, device="cuda") -> dict:
    """Beam ``generate`` at GPT-2-small width and depth: B 4 prompts of 64
    tokens, K 4, 32 new tokens, ``length_penalty`` 0 and 0.6, and a
    weight-only int8 export; ``num_beams=1`` equal to greedy; scores
    best-first and equal to their beams' re-scored log-probs; the int8
    arm's matmuls all on #4, its beams equal to the plain matmul's except
    at a logged near-tie; ``beam_search_decode`` sync-free after a
    warm-up."""
    from paddle_tpu_torch.nn.decode import (_gather_tree_impl,
                                            beam_search_decode)
    from paddle_tpu_torch.slim import export_serving_quant
    from paddle_tpu_torch.text.generation import generate

    V, L = model.wte.weight.shape[0], len(model.layers)
    card = card_line() if device == "cuda" else "cpu"
    prompts = torch.as_tensor(rng.randint(
        1, V, (BEAM_BATCH, BEAM_PROMPT)).astype(np.int32), device=device)
    result = {"shape": dict(batch=BEAM_BATCH, prompt=BEAM_PROMPT, K=BEAM_K,
                            new_tokens=BEAM_NEW, end_id=BEAM_END_ID)}
    greedy, _ = generate(model, prompts, max_new_tokens=BEAM_NEW,
                         end_id=BEAM_END_ID)
    one, _ = model.generate(prompts, max_new_tokens=BEAM_NEW,
                            end_id=BEAM_END_ID,
                            decode_strategy="beam_search", num_beams=1)
    if not torch.equal(one[:, 0], greedy):
        raise AssertionError("e2e_beam: num_beams=1 differs from greedy")
    for alpha in BEAM_ALPHAS:
        arm = f"native/lp{alpha}"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ids, scores = model.generate(
            prompts, max_new_tokens=BEAM_NEW, end_id=BEAM_END_ID,
            decode_strategy="beam_search", num_beams=BEAM_K,
            length_penalty=alpha)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        err = check_beams(arm, model, prompts, ids, scores, model)
        result[arm] = dict(card=card, wall_s=wall, rescore_max_abs_err=err,
                           scores=scores.tolist(),
                           lengths=beam_lengths(ids, BEAM_END_ID).tolist())
        log("e2e_beam", arm=arm, **result[arm])

    # the decode loop alone: timed, then sync-free after its warm-up
    step_fn, state = beam_prefilled(model, prompts)
    for alpha in BEAM_ALPHAS:
        lanes = beam_lanes(state, BEAM_K)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = beam_search_decode(
            step_fn, lanes, BEAM_BATCH, BEAM_K, BEAM_NEW,
            prompts[:, -1:].expand(BEAM_BATCH, BEAM_K), BEAM_END_ID,
            length_penalty=alpha)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if not torch.equal(res.ids, model.generate(
                prompts, max_new_tokens=BEAM_NEW, end_id=BEAM_END_ID,
                decode_strategy="beam_search", num_beams=BEAM_K,
                length_penalty=alpha)[0]):
            raise AssertionError("e2e_beam: beam_search_decode differs "
                                 "from generate")
        lanes = beam_lanes(state, BEAM_K)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            again = beam_search_decode(
                step_fn, lanes, BEAM_BATCH, BEAM_K, BEAM_NEW,
                prompts[:, -1:].expand(BEAM_BATCH, BEAM_K), BEAM_END_ID,
                length_penalty=alpha)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        if not torch.equal(again.ids, res.ids):
            raise AssertionError("e2e_beam: the sync-free decode differs")
        result[f"decode/lp{alpha}"] = dict(
            card=card, wall_s=dt, ms_per_step=1e3 * dt / BEAM_NEW,
            lane_tokens_per_s=BEAM_BATCH * BEAM_K * BEAM_NEW / dt,
            sequence_tokens_per_s=BEAM_BATCH * BEAM_NEW / dt,
            sync_free=True)
        log("e2e_beam", arm=f"decode/lp{alpha}",
            **result[f"decode/lp{alpha}"])

    export = export_serving_quant(model, kv_cache_dtype=None)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids, scores = generate(model, prompts, max_new_tokens=BEAM_NEW,
                           end_id=BEAM_END_ID, decode_strategy="beam_search",
                           num_beams=BEAM_K, quant=export)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    forwards = BEAM_NEW + BEAM_PROMPT - 1
    want = 6 * L * forwards
    if counts["qmm_cuda"] != want or counts["qmm_ref"] != 0:
        raise AssertionError(f"e2e_beam/int8: qmm counts {counts}, want "
                             f"qmm_cuda {want} = 6 x {L} x {forwards} "
                             "forwards and qmm_ref 0")
    err = check_beams("int8", model, prompts, ids, scores,
                      dequantized_model(model, export))
    free_cuda()
    # the same decode, traced, with the kernel and with its plain version
    traces = {}
    for name in ("kernel", "plain"):
        with (plain_qmm() if name == "plain" else contextlib.nullcontext()):
            step_fn, state = beam_prefilled(model, prompts, export)
            traces[name] = beam_trace(step_fn, beam_lanes(state, BEAM_K),
                                      prompts, BEAM_K, 0.0)
    traced = _gather_tree_impl(
        torch.as_tensor(np.stack([s[0] for s in traces["kernel"]])),
        torch.as_tensor(np.stack([s[1] for s in traces["kernel"]])))
    if not torch.equal(traced.permute(1, 2, 0), ids.cpu()):
        raise AssertionError("e2e_beam/int8: the traced decode differs from "
                             "generate's")
    diverged = None
    for t, (k_step, p_step) in enumerate(zip(traces["kernel"],
                                             traces["plain"])):
        if not (np.array_equal(k_step[0], p_step[0])
                and np.array_equal(k_step[1], p_step[1])):
            diverged = dict(step=t, gap=p_step[2])
            break
    if diverged is not None:
        log("e2e_beam", arm="int8", near_tie=diverged,
            limit=INT8_NEAR_TIE_GAP)
        if not diverged["gap"] < INT8_NEAR_TIE_GAP:
            raise AssertionError(f"e2e_beam/int8: the kernel's beams leave "
                                 f"the plain matmul's at step "
                                 f"{diverged['step']}, where the top-K "
                                 f"boundary gap is {diverged['gap']} (limit "
                                 f"{INT8_NEAR_TIE_GAP})")
    result["int8"] = dict(card=card, wall_s=wall, rescore_max_abs_err=err,
                          qmm_cuda=counts["qmm_cuda"],
                          qmm_form_decode=counts["qmm_form_decode"],
                          qmm_form_prefill=counts["qmm_form_prefill"],
                          qmm_ref=counts["qmm_ref"],
                          matmuls_per_forward=6 * L, forwards=forwards,
                          plain_divergence=diverged,
                          min_gap=min(s[2] for s in traces["plain"]))
    log("e2e_beam", arm="int8", **result["int8"])
    return result


# seq_layers: nn.Transformer() at its default width in eval mode
SEQ_BATCH, SEQ_SRC, SEQ_TGT = 8, 256, 64
SEQ_SRC_LENS = (256, 200, 129, 256, 64, 255, 128, 17)
# the flash route against the plain one on the same weights and card:
# f32 sums in another order (3xTF32 on the tensor cores), relative L2
# over the output
SEQ_REL_L2 = 1e-4
# the GRU decoder of the dynamic_decode drive
GRU_H, GRU_V, GRU_K, GRU_STEPS = 512, 8000, 4, 32


class plain_attention:
    """Within it ``ops.attention`` takes the plain route (``_sdpa_core``)
    on the card too: the comparison arm of the flash route."""

    def __enter__(self):
        from paddle_tpu_torch.ops import attention

        self._saved = attention._pallas_ok
        attention._pallas_ok = lambda q, k=None: False

    def __exit__(self, *exc):
        from paddle_tpu_torch.ops import attention

        attention._pallas_ok = self._saved


def _rel_l2(got, want) -> float:
    return float((got.float() - want.float()).norm() / want.float().norm())


def seq_layers_phase(device="cuda") -> dict:
    """``nn.Transformer()`` (d_model 512, 8 heads, 6 + 6 layers, ffn 2048)
    in eval mode at B 8, source 256 with a padding mask, target 64 with
    the causal mask: #5 launched once per encoder layer, the output
    against the same model on the plain attention route, the target
    decoded step by step through ``TransformerDecoder.gen_cache`` against
    the full causal forward; one backward through a
    ``TransformerEncoderLayer`` (#5, #6, #7 once each) against the plain
    route; and a ``dynamic_decode`` of a GRUCell + Embedding + Linear
    decoder, sync-free after a warm-up."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import nn

    rng = np.random.RandomState(11)
    result = {"card": card_line() if device == "cuda" else "cpu"}
    pt.set_device(device)
    pt.seed(11)
    model = nn.Transformer().eval()
    B, E, heads = SEQ_BATCH, model.d_model, model.nhead
    src = pt.to_tensor(rng.randn(B, SEQ_SRC, E).astype(np.float32))
    tgt = pt.to_tensor(rng.randn(B, SEQ_TGT, E).astype(np.float32))
    mask = pt.to_tensor((np.arange(SEQ_SRC)[None, :]
                         < np.asarray(SEQ_SRC_LENS)[:, None]).astype(
                             np.float32))
    # a [T, T] mask would read as a [B, S] validity mask (in paddle_tpu
    # too): the causal mask goes in as [1, 1, T, T]
    causal = nn.Transformer.generate_square_subsequent_mask(
        SEQ_TGT).reshape([1, 1, SEQ_TGT, SEQ_TGT])

    def forward():
        return model(src, tgt, src_mask=mask, tgt_mask=causal,
                     memory_mask=mask)

    with torch.no_grad():
        forward()
        torch.cuda.synchronize()
        reset_flash_counts()
        t0 = time.perf_counter()
        out = forward()
        torch.cuda.synchronize()
        fwd_s = time.perf_counter() - t0
        counts = read_flash_counts()
        layers = len(model.encoder.layers)
        if (counts["route_pallas"] != layers or counts["flash_fwd"] != layers
                or counts["flash_ref"] != 0):
            raise AssertionError(f"seq_layers: one forward launched {counts}"
                                 f", want {layers} flash forwards (one per "
                                 "encoder layer) and no plain flash call")
        with plain_attention():
            want = forward()
        rel = _rel_l2(out._value, want._value)
        if not (torch.isfinite(out._value).all() and rel <= SEQ_REL_L2):
            raise AssertionError(f"seq_layers: the flash route's output is "
                                 f"{rel} from the plain route's in relative "
                                 f"L2 (limit {SEQ_REL_L2})")
        # incremental decoding through the caches
        memory = model.encoder(src, src_mask=mask)
        full = model.decoder(tgt, memory, tgt_mask=causal,
                             memory_mask=mask)
        cache = model.decoder.gen_cache(memory)
        steps = []
        for t in range(SEQ_TGT):
            o, cache = model.decoder(tgt[:, t:t + 1], memory, None, mask,
                                     cache)
            steps.append(o._value)
        inc_rel = _rel_l2(torch.cat(steps, dim=1), full._value)
        if not inc_rel <= SEQ_REL_L2:
            raise AssertionError(f"seq_layers: cached decoding is {inc_rel} "
                                 f"from the full causal forward (limit "
                                 f"{SEQ_REL_L2})")
    result["transformer"] = dict(
        card=result["card"], forward_ms=1e3 * fwd_s, launches=counts,
        rel_l2_vs_plain_route=rel, cached_decode_rel_l2=inc_rel, batch=B,
        src=SEQ_SRC, tgt=SEQ_TGT, src_lens=list(SEQ_SRC_LENS))
    log("seq_layers", part="transformer", **result["transformer"])
    del model, out, want, memory, full, cache, steps
    free_cuda()

    # one backward through an encoder layer, flash route against plain;
    # GELU, not ReLU: an activation within an ulp of 0 may take the other
    # side of ReLU's kink on the other route, and its gradient then
    # differs by a whole column (0.025 in x's gradient, seen on the card)
    pt.seed(11)
    layer = nn.TransformerEncoderLayer(E, heads, 4 * E, dropout=0.0,
                                       activation="gelu").eval()
    x_np = rng.randn(B, SEQ_SRC, E).astype(np.float32)
    w = pt.to_tensor(rng.randn(B, SEQ_SRC, E).astype(np.float32))
    grads = {}
    for route in ("flash", "plain"):
        for p in layer.parameters():
            p.clear_grad()
        x = pt.to_tensor(x_np, stop_gradient=False)
        reset_flash_counts()
        with (plain_attention() if route == "plain"
              else contextlib.nullcontext()):
            (layer(x, src_mask=mask) * w).sum().backward()
        torch.cuda.synchronize()
        if route == "flash":
            bwd_counts = read_flash_counts()
        grads[route] = {"x": x.grad._value} | {
            k: p.grad._value for k, p in layer.state_dict().items()}
    if (bwd_counts["flash_fwd"], bwd_counts["flash_dkv"],
            bwd_counts["flash_dq"], bwd_counts["flash_ref"]) != (1, 1, 1, 0):
        raise AssertionError(f"seq_layers: the encoder layer's backward "
                             f"launched {bwd_counts}, want #5, #6, #7 once "
                             "each")
    # the flash limits: max-abs FLASH_TOL x max(1, |want|) on every
    # gradient, relative L2 FLASH_REL_L2 on all but the K projection's
    # bias, whose exact gradient is 0 (a bias on every key of a row
    # shifts its logits alike, and softmax ignores the shift): both
    # routes hold only rounding noise there, summed over B x S rows
    limit, tol = FLASH_REL_L2[torch.float32], FLASH_TOL[torch.float32]
    rel, abs_err = {}, {}
    for k, want in grads["plain"].items():
        got = grads["flash"][k]
        abs_err[k] = float((got - want).abs().max())
        if not abs_err[k] <= tol * max(1.0, float(want.abs().max())):
            raise AssertionError(f"seq_layers: gradient {k} on the flash "
                                 f"route is {abs_err[k]} from the plain "
                                 f"route's (limit {tol} x max(1, max "
                                 "|want|))")
        if k != "self_attn.k_proj.bias":
            rel[k] = flash_rel_l2(got, want)
    worst = max((v, k) for k, v in rel.items())
    if not worst[0] <= limit:
        raise AssertionError(f"seq_layers: gradient {worst[1]} on the flash "
                             f"route is {worst[0]} from the plain route's "
                             f"in relative L2 (limit {limit})")
    result["encoder_backward"] = dict(
        launches=bwd_counts, worst_grad_rel_l2=worst[0],
        worst_grad=worst[1], limit=limit,
        max_abs_err=max(abs_err.values()),
        k_bias_max_abs=abs_err["self_attn.k_proj.bias"])
    log("seq_layers", part="encoder_backward", **result["encoder_backward"])
    del layer, grads
    free_cuda()

    # dynamic_decode of a GRU decoder, sync-free after its warm-up
    pt.seed(12)
    cell, emb = nn.GRUCell(GRU_H, GRU_H), nn.Embedding(GRU_V, GRU_H)
    proj = nn.Linear(GRU_H, GRU_V)
    dec = nn.BeamSearchDecoder(cell, start_token=1, end_token=2,
                               beam_size=GRU_K, embedding_fn=emb,
                               output_fn=proj)
    h0 = nn.BeamSearchDecoder.tile_beam_merge_with_batch(
        pt.to_tensor(rng.randn(B, GRU_H).astype(np.float32)), GRU_K)
    ids, _ = nn.dynamic_decode(dec, inits=h0, max_step_num=GRU_STEPS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        again, scores = nn.dynamic_decode(dec, inits=h0,
                                          max_step_num=GRU_STEPS)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    s = scores._value
    if (not torch.equal(again._value, ids._value)
            or tuple(again.shape) != (B, GRU_K, GRU_STEPS)
            or not torch.isfinite(s).all() or (s[:, 1:] > s[:, :-1]).any()):
        raise AssertionError("seq_layers: the GRU dynamic_decode is not "
                             "repeatable, finite and best-first")
    result["gru_dynamic_decode"] = dict(
        card=result["card"], H=GRU_H, V=GRU_V, B=B, K=GRU_K,
        steps=GRU_STEPS, wall_s=dt, ms_per_step=1e3 * dt / GRU_STEPS,
        sync_free=True)
    log("seq_layers", part="gru_dynamic_decode",
        **result["gru_dynamic_decode"])
    return result


# row t: the custom-op API's worked kernel, x * scale[0] + shift[0]
SCALE_SHIFT_SHAPES = ((16, 8), (4, 8), (1_000_003,), (8192, 8192))
SCALE_SHIFT_TIMED = ((16, 8), (8192, 8192))
CUSTOM_OP_STEPS = 15
# the custom-op net and LeNet on the card vs the same steps on the CPU
# from the same weights: f32 products of width <= 400 summed in another
# order by cuBLAS/cuDNN (TF32 off), which Adam's normalized step carries
# into the next losses at the level of a few ulps of lr
TRAIN_CPU_RTOL = 1e-4
LENET_BATCH = 64
LENET_STEPS = 30
LENET_PARITY_STEPS = 5


def scale_shift_bound_ms(numel, item):
    """Least time on an H100: x read once and the output written once
    over HBM bandwidth (two flops an element are far below the f32
    peak)."""
    return 2 * numel * item / HBM_BYTES_PER_S * 1e3, "bytes"


def scale_shift_kernel_phase(rng, flush) -> dict:
    """Row t's kernel against its plain version at the custom-op net's
    shape [16, 8], the math test's [4, 8], an odd 1-D size and [8192,
    8192], f32 and bf16: bit for bit; an empty x launches nothing.
    Timed at [16, 8] and [8192, 8192] beside the bound, the plain
    version and ``torch.addcmul(shift, x, scale)``."""
    from paddle_tpu_torch.ops import scale_shift as ss

    scale = torch.tensor([1.37], device=DEVICE)
    shift = torch.tensor([-0.21], device=DEVICE)
    timings = {}
    for shape in SCALE_SHIFT_SHAPES:
        xf = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
            DEVICE)
        for dtype in (torch.float32, torch.bfloat16):
            x = xf.to(dtype)
            out = ss.scale_shift_cuda(x, scale, shift)
            torch.cuda.synchronize()
            ref = ss.scale_shift_ref(x, scale, shift)
            err = float((out.float() - ref.float()).abs().max())
            exact = bool(torch.equal(out, ref))
            tag = f"{'x'.join(map(str, shape))}/{str(dtype).split('.')[-1]}"
            log("kernel_scale_shift", case=tag, max_abs_err=err,
                bit_equal=exact)
            if not exact:
                raise AssertionError(f"scale_shift kernel differs from its "
                                     f"plain version on {tag}: max_abs_err "
                                     f"{err}")
            if shape in SCALE_SHIFT_TIMED:
                t = {"max_abs_err": err,
                     "ms": time_ms(lambda: ss.scale_shift_cuda(
                         x, scale, shift), flush),
                     "plain_ms": time_ms(
                         lambda: ss.scale_shift_ref(x, scale, shift), flush),
                     "library_ms": time_ms(
                         lambda: torch.addcmul(shift, x, scale), flush)}
                t["bound_ms"], t["bound_by"] = scale_shift_bound_ms(
                    x.numel(), x.element_size())
                log("kernel_scale_shift_time", case=tag, **t)
                timings[tag] = t
            del x, out, ref
        del xf
        free_cuda()
    before = ss.SCALE_SHIFT_ROUTE_STATS["cuda"]
    empty = ss.scale_shift_cuda(torch.empty((0, 8), device=DEVICE), scale,
                                shift)
    if ss.SCALE_SHIFT_ROUTE_STATS["cuda"] != before or empty.shape != (0, 8):
        raise AssertionError("scale_shift launched on an empty x")
    return timings


def _scale_shift_layer_cls():
    from paddle_tpu_torch import nn

    class ScaleShiftLayer(nn.Layer):
        """The port's twin of tests/test_custom_op.py's
        ``_PallasScaleLayer``: 1-element scale and shift, passed 0-d."""

        def __init__(self, op):
            super().__init__()
            self._op = op
            self.scale = self.create_parameter([1])
            self.shift = self.create_parameter([1], is_bias=True)

        def forward(self, x):
            return self._op(x, self.scale.reshape([]),
                            self.shift.reshape([]))

    return ScaleShiftLayer


def _on_device(device, build):
    """``build()`` with ``device`` as the default place, put back after."""
    from paddle_tpu_torch.framework import place

    prev = place._DEFAULT["device"]
    place.set_device(device)
    try:
        return build()
    finally:
        place._DEFAULT["device"] = prev


def custom_op_phase(device="cuda") -> dict:
    """tests/test_custom_op.py's eager drive through the port's
    ``register_op``: ``Sequential(Linear(8, 8), ScaleShiftLayer(op),
    Linear(8, 1))`` with the op registered as ``scale_shift`` with its
    vjp, 15 ``Adam(5e-2)`` steps on the card from the initial weights of
    the same net built on the CPU under ``seed(0)``, against the same
    steps on the CPU.  Every count set to 0 just before the card's drive:
    one forward and one dx launch a step, no plain call; the loss halves;
    the losses equal the CPU's within TRAIN_CPU_RTOL."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import nn, optimizer
    from paddle_tpu_torch.nn.layer import state_from_numpy
    from paddle_tpu_torch.ops import scale_shift as ss
    from paddle_tpu_torch.utils import register_op

    op = register_op("scale_shift", ss.scale_shift, vjp=ss.scale_shift_vjp,
                     exist_ok=True)
    layer_cls = _scale_shift_layer_cls()
    rng = np.random.RandomState(0)
    xa = rng.randn(16, 8).astype(np.float32)
    ya = (rng.randn(16, 1) * 0.1 + 1.0).astype(np.float32)

    def build():
        return nn.Sequential(nn.Linear(8, 8), layer_cls(op), nn.Linear(8, 1))

    def train(net):
        opt = optimizer.Adam(5e-2, parameters=net.parameters())
        x, y = pt.to_tensor(xa), pt.to_tensor(ya)
        losses = []
        for _ in range(CUSTOM_OP_STEPS):
            loss = ((net(x) - y) ** 2).mean()
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(float(loss))
        return losses

    def cpu_run():
        pt.seed(0)
        net = build()
        state = {k: v.numpy() for k, v in net.state_dict().items()}
        return state, train(net)

    def card_run():
        net = build()
        net.set_state_dict(state_from_numpy(state, device))
        for key in ss.SCALE_SHIFT_ROUTE_STATS:
            ss.SCALE_SHIFT_ROUTE_STATS[key] = 0
        losses = train(net)
        return losses, dict(ss.SCALE_SHIFT_ROUTE_STATS)

    state, cpu_losses = _on_device("cpu", cpu_run)
    losses, counts = _on_device(device, card_run)
    route = "cuda" if torch.device(device).type == "cuda" else "ref"
    want = {"cuda": 0, "ref": 0, route: 2 * CUSTOM_OP_STEPS}
    rel = float(np.max(np.abs(np.subtract(losses, cpu_losses))
                       / np.abs(cpu_losses)))
    res = {"losses": losses, "cpu_losses": cpu_losses,
           "max_rel_diff_vs_cpu": rel, "rtol": TRAIN_CPU_RTOL,
           "scale_shift_launches": counts}
    log("custom_op", **res)
    if counts != want:
        raise AssertionError(f"custom_op: launches {counts}, want {want}")
    if not losses[-1] < 0.5 * losses[0]:
        raise AssertionError(f"custom_op: the loss did not halve: {losses}")
    if not rel <= TRAIN_CPU_RTOL:
        raise AssertionError(f"custom_op: losses differ from the CPU's by "
                             f"{rel} relative (rtol {TRAIN_CPU_RTOL})")
    return res


def lenet_phase(device="cuda") -> dict:
    """Dygraph LeNet (BASELINE.json config 1) through the port's core:
    ``Adam(1e-3)`` on the synthetic MNIST, the first LENET_STEPS batches
    of LENET_BATCH in order, f32 (TF32 off).  The weights come from the
    port's LeNet built on the CPU under ``seed(0)``; the first
    LENET_PARITY_STEPS losses must equal the same steps on the CPU within
    TRAIN_CPU_RTOL and the mean of the last 5 losses must be below that
    of the first 5.  Step times on the host clock, each step ending in a
    sync (the first step, with cuDNN's set-up, reported apart)."""
    import paddle_tpu_torch as pt
    import paddle_tpu_torch.nn.functional as F
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.nn.layer import state_from_numpy
    from paddle_tpu_torch.vision.datasets import MNIST
    from paddle_tpu_torch.vision.models import LeNet

    ds = MNIST(mode="train")
    batches = [ds.batch(i * LENET_BATCH, LENET_BATCH)
               for i in range(LENET_STEPS)]

    def run(model, n, sync):
        opt = optimizer.Adam(1e-3, parameters=model.parameters())
        data = [(pt.to_tensor(x), pt.to_tensor(y)) for x, y in batches[:n]]
        losses, step_ms = [], []
        for x, y in data:
            sync()
            t0 = time.perf_counter()
            loss = F.cross_entropy(model(x), y)
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(float(loss))
            sync()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        return losses, step_ms

    def cpu_run():
        pt.seed(0)
        model = LeNet()
        state = {k: v.numpy() for k, v in model.state_dict().items()}
        return state, run(model, LENET_PARITY_STEPS, lambda: None)[0]

    def card_run():
        model = LeNet()
        model.set_state_dict(state_from_numpy(state, device))
        sync = (torch.cuda.synchronize if torch.device(device).type == "cuda"
                else (lambda: None))
        return run(model, LENET_STEPS, sync)

    state, cpu_losses = _on_device("cpu", cpu_run)
    losses, step_ms = _on_device(device, card_run)
    head = losses[:LENET_PARITY_STEPS]
    rel = float(np.max(np.abs(np.subtract(head, cpu_losses))
                       / np.abs(cpu_losses)))
    steady = step_ms[1:]
    p50 = float(np.percentile(steady, 50))
    res = {"batch": LENET_BATCH, "steps": LENET_STEPS, "losses": losses,
           "cpu_losses": cpu_losses, "max_rel_diff_vs_cpu": rel,
           "rtol": TRAIN_CPU_RTOL, "first_step_ms": step_ms[0],
           "step_ms_p50": p50,
           "step_ms_p95": float(np.percentile(steady, 95)),
           "images_per_s": LENET_BATCH / (p50 / 1e3)}
    log("lenet", **res)
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"lenet: non-finite loss {losses}")
    if not np.mean(losses[-5:]) < np.mean(losses[:5]):
        raise AssertionError(f"lenet: the loss did not fall: {losses}")
    if not rel <= TRAIN_CPU_RTOL:
        raise AssertionError(f"lenet: the first {LENET_PARITY_STEPS} losses "
                             f"differ from the CPU's by {rel} relative "
                             f"(rtol {TRAIN_CPU_RTOL})")
    return res


FIT_SEQS, FIT_EPOCHS, FIT_BATCH = 16, 3, 8
FIT_STEPS = FIT_SEQS // FIT_BATCH * FIT_EPOCHS
FIT_RESUME_LAYERS, FIT_KILL_AT, FIT_CKPT_INTERVAL = 2, 4, 2


def fit_run(ids, layers, accelerate, amp_level=None, **fit_kw):
    """``Model.fit`` of a seeded GPT-2-small-width GPT (``layers`` deep,
    f32) on ``ids`` [FIT_SEQS, S + 1]: ``TensorDataset`` -> ``DataLoader(
    batch 8, shuffle, drop_last)`` for FIT_EPOCHS epochs (staged by
    ``prefetch_to_device``), ``AdamW(LinearWarmup(CosineAnnealingDecay(
    6e-4, T_max=6), 2, 0.0, 6e-4), weight_decay=0.1,
    grad_clip=ClipGradByGlobalNorm(1.0))``, ``CrossEntropyLoss``, token
    ``Accuracy`` and the ``LRScheduler(by_step=True)`` callback.  With
    ``amp_level`` ("O1" or "O2") the fit runs under ``auto_cast(level=,
    dtype="bfloat16")``, and at O2 the GPT and the optimizer are first
    ``amp.decorate``d (bf16 weights).  Returns (model, net, per-step
    losses, per-step host ms, per-step LRs)."""
    from contextlib import nullcontext

    from paddle_tpu_torch import (Model, amp, callbacks, io, metric, nn,
                                  optimizer)
    from paddle_tpu_torch.optimizer import lr as sched
    from paddle_tpu_torch.text.models import GPTModel

    net = GPTModel(**dict(GPT2_SMALL, num_layers=layers), device=DEVICE,
                   seed=1234)
    opt = optimizer.AdamW(
        sched.LinearWarmup(sched.CosineAnnealingDecay(TRAIN_LR,
                                                      T_max=FIT_STEPS),
                           2, 0.0, TRAIN_LR),
        parameters=list(net.parameters()), weight_decay=TRAIN_WD,
        grad_clip=nn.ClipGradByGlobalNorm(1.0))
    if amp_level == "O2":
        amp.decorate(models=net, optimizers=opt, level="O2",
                     dtype="bfloat16")
    model = Model(net)
    model.prepare(opt, nn.CrossEntropyLoss(), metric.Accuracy(),
                  accelerate=accelerate)
    losses, step_ms, lrs = [], [], []

    class Record(callbacks.Callback):
        def on_train_batch_begin(self, step, logs=None):
            lrs.append(opt.get_lr())
            self.t0 = time.perf_counter()

        def on_train_batch_end(self, step, logs=None):
            # train_batch read the loss back: the step is done
            step_ms.append((time.perf_counter() - self.t0) * 1e3)
            losses.append(logs["loss"])

    np.random.seed(4)
    loader = io.DataLoader(io.TensorDataset([ids[:, :-1], ids[:, 1:]]),
                           batch_size=FIT_BATCH, shuffle=True,
                           drop_last=True)
    with (amp.auto_cast(level=amp_level, dtype="bfloat16") if amp_level
          else nullcontext()):
        model.fit(loader, epochs=FIT_EPOCHS, verbose=0,
                  callbacks=[Record(), callbacks.LRScheduler(by_step=True)],
                  **fit_kw)
    return model, net, losses, step_ms, lrs


FIT_DROPOUT, FIT_DROPOUT_STEPS = 0.1, 3


def fit_dropout_run(ids, accelerate, lr):
    """FIT_DROPOUT_STEPS ``train_batch`` steps on one batch of ``ids``
    (paddle-API layers at GPT-2-small width: an embedding, one
    ``TransformerEncoderLayer(768, 12, 3072, dropout=FIT_DROPOUT)``, whose
    attention takes the flash route with its dropout seed an int32 tensor
    on the card, and a head; ``AdamW(lr)``) from ``pt.seed(11)`` and
    seeded weights.  Returns (losses, {name: weight}, flash counts,
    captures)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import Model, nn, optimizer
    from paddle_tpu_torch.profiler.jit_cost import compile_budget

    class Net(nn.Layer):
        def __init__(self):
            super().__init__()
            width = GPT2_SMALL["hidden_size"]
            self.emb = nn.Embedding(GPT2_SMALL["vocab_size"], width)
            self.enc = nn.TransformerEncoderLayer(
                width, GPT2_SMALL["num_heads"], 4 * width,
                dropout=FIT_DROPOUT)
            self.head = nn.Linear(width, GPT2_SMALL["vocab_size"])

        def forward(self, x):
            return self.head(self.enc(self.emb(x)))

    pt.set_device(DEVICE)
    pt.seed(5)
    net = Net()
    opt = optimizer.AdamW(lr, parameters=net.parameters(),
                          weight_decay=TRAIN_WD)
    model = Model(net)
    model.prepare(opt, nn.CrossEntropyLoss(), accelerate=accelerate)
    x = torch.from_numpy(ids[:FIT_BATCH, :-1]).to(DEVICE)
    y = torch.from_numpy(ids[:FIT_BATCH, 1:]).to(DEVICE)
    reset_flash_counts()
    pt.seed(11)
    with compile_budget(None, names=("hapi/train_step",)) as cb:
        losses = [model.train_batch([x], [y])[0]
                  for _ in range(FIT_DROPOUT_STEPS)]
    torch.cuda.synchronize()
    weights = {k: v._value.detach().clone()
               for k, v in net.state_dict().items()}
    return (losses, weights, read_flash_counts(),
            cb.compiles().get("hapi/train_step", 0))


def fit_dropout_check(ids) -> dict:
    """Randomness inside the graphed step: ``fit_dropout_run`` graphed
    and eager from one seed must be bit-equal (the port's generator is
    registered with the graph, so each replay draws what the eager step
    draws), with one capture and the flash kernels launched once a step
    each on both paths; at LR 0 the graphed steps on one batch must give
    FIT_DROPOUT_STEPS different losses (a new mask at each replay)."""
    (gl, gw, gn, gc), (el, ew, en, _) = (
        fit_dropout_run(ids, acc, TRAIN_LR) for acc in (True, False))
    frozen = fit_dropout_run(ids, True, 0.0)[0]
    diff = next((k for k in gw if not torch.equal(gw[k], ew[k])), None)
    n = FIT_DROPOUT_STEPS
    flash = {k: gn[k] for k in ("flash_fwd", "flash_dkv", "flash_dq",
                                "flash_ref")}
    res = {"dropout": FIT_DROPOUT, "steps": n, "graphed_losses": gl,
           "eager_losses": el, "captures": gc, "first_difference": diff,
           "flash_graphed": flash, "lr0_graphed_losses": frozen}
    if gc != 1 or gl != el or diff is not None:
        raise AssertionError(f"fit: the graphed step with dropout differs "
                             f"from the eager one: {res}")
    if flash != {"flash_fwd": n, "flash_dkv": n, "flash_dq": n,
                 "flash_ref": 0} or any(
                     en[k] != v for k, v in flash.items()):
        raise AssertionError(f"fit: dropout flash launches {gn} / {en}")
    if len(set(frozen)) != n:
        raise AssertionError(f"fit: the graphed replays did not draw new "
                             f"dropout masks: {frozen}")
    return res


def _first_difference(net_a, net_b):
    """The first parameter whose bits differ, with its largest
    difference, or None."""
    for (name, a), b in zip(net_a.named_parameters(), net_b.parameters()):
        if not torch.equal(a, b):
            return {"param": name,
                    "max_abs_diff": float((a - b).abs().max())}
    return None


def fit_phase(rng) -> dict:
    """``hapi.Model.fit`` on GPT-2-small (12 layers, f32, TF32 off), its
    train step one CUDA graph (``accelerate=True``) and again eager
    (``accelerate=False``) from the same weights and data order: one
    capture of ``hapi/train_step`` and FIT_STEPS - 1 replays though the
    LR changes every step; losses and final weights bit-equal; #5-#7
    launched 12 times a step each in both runs (3xTF32 bodies, the plain
    route 0); the first loss within 0.5 of ln(vocab) and the loss
    falling; one ``eval_batch`` and one ``predict_batch`` equal to the
    network's own forward; step p50 / p95 (host clock), tokens/s and
    peak memory of both runs, and one more graphed step under the
    profiler.  Then, at FIT_RESUME_LAYERS layers, a checkpointed fit
    killed at step FIT_KILL_AT (chaos ``train.step``) and resumed by a
    fresh Model: bit-equal to the uninterrupted run.  Last, dropout in
    the graphed step (``fit_dropout_check``)."""
    import tempfile

    from paddle_tpu_torch.framework.errors import FatalError
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.profiler.jit_cost import (compile_budget,
                                                    cost_registry)
    from paddle_tpu_torch.testing import chaos

    ids = rng.randint(0, GPT2_SMALL["vocab_size"],
                      (FIT_SEQS, TRAIN_SEQ + 1)).astype(np.int64)
    tokens = FIT_BATCH * TRAIN_SEQ
    runs, nets, models = {}, {}, {}
    for mode, accelerate in (("graphed", True), ("eager", False)):
        free_cuda()
        torch.cuda.reset_peak_memory_stats()
        before = cost_registry.snapshot().get("hapi/train_step", {})
        reset_counts()
        reset_flash_counts()
        with compile_budget(None, names=("hapi/train_step",)) as cb:
            model, net, losses, step_ms, lrs = fit_run(ids, 12, accelerate)
        torch.cuda.synchronize()
        counts = read_flash_counts()
        now = cost_registry.snapshot().get("hapi/train_step", {})
        steady = step_ms[1:]
        runs[mode] = {
            "losses": losses, "lrs": lrs, "step_ms": step_ms,
            "step_ms_p50": float(np.percentile(steady, 50)),
            "step_ms_p95": float(np.percentile(steady, 95)),
            "tokens_per_s": tokens / (np.percentile(steady, 50) / 1e3),
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "captures": cb.compiles().get("hapi/train_step", 0),
            "replays": now.get("replays", 0) - before.get("replays", 0),
            **counts}
        nets[mode], models[mode] = net, model
        n = 12 * FIT_STEPS
        want = {"flash_fwd": n, "flash_dkv": n, "flash_dq": n,
                "flash_ref": 0, "flash_f32tc_fwd": n, "flash_f32tc_dkv": n,
                "flash_f32tc_dq": n, "flash_tc_fwd": 0, "flash_tc_dkv": 0,
                "flash_tc_dq": 0, "route_pallas": n, "route_xla": 0}
        expect_counts(f"fit_{mode}", counts, want)
    g, e = runs["graphed"], runs["eager"]
    diff = _first_difference(nets["graphed"], nets["eager"])
    x = torch.from_numpy(ids[:FIT_BATCH, :-1]).to(DEVICE)
    y = torch.from_numpy(ids[:FIT_BATCH, 1:]).to(DEVICE)
    net, model = nets["graphed"], models["graphed"]
    with torch.no_grad():
        net.eval()
        want_loss = float(F.cross_entropy(net(x), y))
        want_logits = net(x[:1]).cpu().numpy()
    eval_loss = model.eval_batch([x], [y])[0]
    predicted = model.predict_batch([x[:1]])[0]
    prof = profile_step(None, None, x, y,
                        step=lambda: model.train_batch([x], [y])[0])
    del nets, models, model, net
    free_cuda()

    with tempfile.TemporaryDirectory() as d:
        _, plain_net, plain_losses, _, _ = fit_run(ids, FIT_RESUME_LAYERS,
                                                   True)
        plan = chaos.ChaosPlan([chaos.Fault("train.step", FIT_KILL_AT,
                                            chaos.KILL)])
        killed = False
        with chaos.running(plan):
            try:
                fit_run(ids, FIT_RESUME_LAYERS, True, checkpoint_dir=d,
                        checkpoint_interval=FIT_CKPT_INTERVAL,
                        checkpoint_async=False)
            except FatalError:
                killed = True
        _, resumed_net, resumed_losses, _, _ = fit_run(
            ids, FIT_RESUME_LAYERS, True, checkpoint_dir=d,
            checkpoint_interval=FIT_CKPT_INTERVAL, resume=True)
        resume_diff = _first_difference(plain_net, resumed_net)
    del plain_net, resumed_net
    free_cuda()
    dropout = fit_dropout_check(ids)
    res = {
        "layers": 12, "seqs": FIT_SEQS, "batch": FIT_BATCH,
        "seq": TRAIN_SEQ, "epochs": FIT_EPOCHS, "steps": FIT_STEPS,
        "graphed": g, "eager": e, "bit_equal_weights": diff is None,
        "first_difference": diff, "bit_equal_losses": g["losses"] ==
        e["losses"], "ln_vocab": math.log(GPT2_SMALL["vocab_size"]),
        "eval_loss": eval_loss, "eval_loss_forward": want_loss,
        "predict_equal": bool(np.array_equal(predicted, want_logits)),
        "profile_graphed_step": prof,
        "resume": {"layers": FIT_RESUME_LAYERS, "killed": killed,
                   "kill_at_step": FIT_KILL_AT,
                   "checkpoint_interval": FIT_CKPT_INTERVAL,
                   "losses": plain_losses, "resumed_losses": resumed_losses,
                   "bit_equal_weights": resume_diff is None,
                   "first_difference": resume_diff},
        "dropout": dropout}
    log("fit", **res)
    if g["captures"] != 1 or g["replays"] != FIT_STEPS - 1:
        raise AssertionError(f"fit: {g['captures']} captures and "
                             f"{g['replays']} replays of hapi/train_step, "
                             f"expected 1 and {FIT_STEPS - 1}")
    if any(a == b for a, b in zip(g["lrs"], g["lrs"][1:])):
        raise AssertionError(f"fit: the LR did not change every step: "
                             f"{g['lrs']}")
    if not (res["bit_equal_losses"] and res["bit_equal_weights"]):
        raise AssertionError(
            f"fit: the graphed and eager runs differ: losses "
            f"{g['losses']} vs {e['losses']}, first weight difference "
            f"{diff}")
    losses = g["losses"]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"fit: non-finite loss {losses}")
    if abs(losses[0] - res["ln_vocab"]) > 0.5:
        raise AssertionError(f"fit: first loss {losses[0]} is not within "
                             f"0.5 of ln(vocab) {res['ln_vocab']}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"fit: the loss did not fall: {losses}")
    if eval_loss != want_loss or not res["predict_equal"]:
        raise AssertionError(f"fit: eval_batch loss {eval_loss} vs the "
                             f"forward's {want_loss}; predict equal: "
                             f"{res['predict_equal']}")
    if not (killed and resume_diff is None
            and resumed_losses == plain_losses[FIT_CKPT_INTERVAL:]):
        raise AssertionError(f"fit: the resumed run differs: {res['resume']}")
    return res


# --------------------------------------------------------------------------
# the JAX package's benchmark models: ResNet-50 and BERT-base
# --------------------------------------------------------------------------
def build_step(model, loss_fn, opt, amp_dtype="bfloat16", graphed=True):
    """The port's twin of ``bench.py:43-79`` ``build_step``: one train
    step ``step(state, *inputs, labels) -> loss`` of a port ``nn.Layer``
    and the state it updates, ``{"params", "buffers", "opt", "step",
    "lr"}`` (the model's own tensors, fresh accumulators, and the step
    count and the learning rate as 0-d float64 device tensors).

    The step runs ``jit.functional_call`` in training mode under
    ``amp.auto_cast(dtype=amp_dtype)`` (None: no cast), the loss outside
    it cast to f32, ``torch.autograd.grad``, and the optimizer's
    ``fused_step`` with the count advanced on the device; it writes the
    new parameters and accumulators back in place, and the batch norms
    update their running statistics in place.  With ``graphed`` the step
    is one ``profiled_graph("bench/train_step")`` with the state donated
    (``bench.py`` jits it with the state donated); else it runs eagerly.
    The learning rate is read once, as the JAX step bakes it.  It is
    this script's harness for measuring that form, not an API of the
    port: ``Model.fit`` is the port's training entry point."""
    from paddle_tpu_torch.jit.functional import functional_call, get_state
    from paddle_tpu_torch.profiler.jit_cost import profiled_graph
    from paddle_tpu_torch.tensor import Tensor

    params, buffers = get_state(model)
    names = [n for n, p in params.items() if p.requires_grad]
    dev = params[names[0]].device
    state = {"params": params, "buffers": buffers,
             "opt": opt.init_opt_state({n: params[n] for n in names}),
             "step": torch.zeros((), dtype=torch.float64, device=dev),
             "lr": torch.full((), opt.get_lr(), dtype=torch.float64,
                              device=dev)}

    def step_fn(state, *inputs):
        *xs, y = inputs
        with amp_context(amp_dtype):
            out, _ = functional_call(model, state["params"],
                                     state["buffers"], xs, training=True)
        loss = loss_fn(Tensor(out), Tensor(y))._value.float()
        grads = torch.autograd.grad(loss, [state["params"][n]
                                           for n in names],
                                    allow_unused=True)
        count = state["step"]
        count.add_(1)
        live = {n: state["params"][n] for n in names}
        new_params, new_opt = opt.fused_step(live, dict(zip(names, grads)),
                                             state["opt"], count,
                                             lr=state["lr"])
        with torch.no_grad():
            for n in names:
                live[n].copy_(new_params[n])
                for kind, accs in state["opt"].items():
                    accs[n].copy_(new_opt[kind][n])
        return loss.detach()

    if graphed:
        return profiled_graph("bench/train_step", step_fn,
                              donate_argnums=(0,)), state
    return step_fn, state


@contextlib.contextmanager
def amp_op_names():
    """``{(op name, dtype AMP casts its inputs to or "none"): calls}`` of
    every op the dispatcher runs in the region (``ops.dispatch.apply``
    casts through ``cast_inputs``; wrapped here, not in the port)."""
    from paddle_tpu_torch.amp.auto_cast import should_cast
    from paddle_tpu_torch.ops import dispatch

    seen = {}
    real = dispatch.cast_inputs

    def counting(name, *tensors):
        d = should_cast(name)
        key = (name, "none" if d is None else str(d).split(".")[-1])
        seen[key] = seen.get(key, 0) + 1
        return real(name, *tensors)

    dispatch.cast_inputs = counting
    try:
        yield seen
    finally:
        dispatch.cast_inputs = real


# the ops of the conv nets and where the JAX package's AMP lists put them
# (``paddle_tpu/amp/auto_cast.py:11-29``): conv2d and linear on the white
# list (bf16), the norms and pools on neither (their input's dtype)
AMP_EXPECTED = {"conv2d": "bfloat16", "linear": "bfloat16",
                "batch_norm": "none", "max_pool2d": "none",
                "adaptive_avg_pool2d": "none", "relu": "none"}


def check_amp_ops(phase, seen):
    cast = {}
    for (name, dtype), n in seen.items():
        cast.setdefault(name, set()).add(dtype)
    bad = {k: sorted(cast.get(k, ())) for k, want in AMP_EXPECTED.items()
           if k in cast and cast[k] != {want}}
    if bad or "conv2d" not in cast or "batch_norm" not in cast:
        raise AssertionError(f"{phase}: AMP casts {cast}, expected "
                             f"{AMP_EXPECTED}")
    return {f"{k}/{d}": n for (k, d), n in sorted(seen.items())}


def conv_family(name: str) -> str:
    """The family of a device kernel of a conv net's step, by name."""
    low = name.lower()
    if ("copy" in low or "nchwtonhwc" in low or "nhwctonchw" in low
            or "transpose" in low):
        return "copies"
    if any(k in low for k in ("conv", "fprop", "dgrad", "wgrad",
                              "implicit_gemm")):
        return "conv"
    if any(k in low for k in MATMUL_NAMES):
        return "matmul"
    if "pool" in low:
        return "pool"
    if "reduce" in low:
        return "reductions"
    if "elementwise" in low:
        return "elementwise"
    return "other"


def bert_family(name: str) -> str:
    """The family of a device kernel of a BERT step: the three flash
    kernels, else as ``conv_family``."""
    key = next((f"flash_{k}" for k in ("dkv", "dq", "fwd")
                if any(f"{k}_{body}kernel<" in name
                       for body in ("", "tc_", "f32tc_"))), None)
    return key or conv_family(name)


def profile_families(step, family) -> dict:
    """One more step (``step()`` returns the loss, read back) under
    ``torch.profiler``: device time and launches by ``family(name)``, the
    costliest kernels, every copy kernel, and the device's busy share of
    the step's wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        loss = step()
        wall_ms = (time.perf_counter() - t0) * 1e3
    fams, top, copies, n_kernels = {}, [], [], 0
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = evt.self_device_time_total / 1e3
        n_kernels += evt.count
        fam = family(evt.key)
        ms0, n0 = fams.get(fam, (0.0, 0))
        fams[fam] = (ms0 + ms, n0 + evt.count)
        top.append((ms, evt.count, fam, evt.key[:90]))
        if fam == "copies":
            copies.append({"launches": evt.count, "ms": ms,
                           "name": evt.key[:120]})
    busy = sum(ms for ms, _ in fams.values())
    top.sort(reverse=True)
    return {"loss": loss, "wall_ms": wall_ms, "device_ms": busy,
            "device_busy_share": busy / wall_ms if busy else None,
            "device_kernels": n_kernels,
            "by_family": {k: {"ms": ms, "launches": n}
                          for k, (ms, n) in sorted(fams.items())},
            "copies": copies,
            "top_kernels": [{"ms": ms, "launches": c, "family": f,
                             "name": n} for ms, c, f, n in top[:10]]}


# the ops of an eager conv-net step whose device time the profiler
# attributes to them (each name's kernels and its children's): the batch
# norm's autograd op (forward and backward), the convolutions, the dtype
# casts, the pools
CONV_NET_OPS = {
    "batch_norm": ("_BatchNormTrain", "_BatchNormTrainBackward"),
    "conv": ("aten::convolution", "ConvolutionBackward0"),
    "casts": ("aten::_to_copy", "ToCopyBackward0"),
    "pool": ("aten::max_pool2d", "MaxPool2DWithIndicesBackward0",
             "aten::adaptive_avg_pool2d", "MeanBackward1",
             "AdaptiveAvgPool2DBackward0"),
}


def profile_ops(step, groups) -> dict:
    """One more eager step (``step()`` returns the loss, read back) under
    ``torch.profiler``: the device time of the kernels each group of op
    names launched (an op's own and its children's), the step's device
    time and wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by = {k: 0.0 for k in groups}
    for evt in prof.events():
        for key, names in groups.items():
            if evt.name in names:
                by[key] += evt.device_time_total / 1e3
    total = sum(evt.self_device_time_total for evt in prof.key_averages()
                if evt.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    return {"wall_ms": wall_ms, "device_ms": total, "device_ms_by_op": by,
            "device_ms_rest": total - sum(by.values())}


def _steady(ms) -> dict:
    steady = ms[1:] if len(ms) > 1 else ms
    return {"step_ms": ms, "step_ms_p50": float(np.percentile(steady, 50)),
            "step_ms_p95": float(np.percentile(steady, 95))}


def bench_run(make_model, make_opt, inputs, steps, graphed,
              amp_dtype="bfloat16"):
    """``steps`` bench-form steps of a fresh seeded model on one batch
    (``inputs``: the model's inputs, then the labels), each ending in
    its loss read.  Returns (model, step, state, result)."""
    from paddle_tpu_torch import nn

    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    model = make_model()
    step, state = build_step(model, nn.CrossEntropyLoss(), make_opt(model),
                             amp_dtype, graphed)
    losses, ms = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(float(step(state, *inputs)))
        ms.append((time.perf_counter() - t0) * 1e3)
    return model, step, state, {
        "losses": losses, **_steady(ms),
        "max_memory_allocated": torch.cuda.max_memory_allocated()}


def fit_bench_run(make_model, make_opt, wrap, arrays, batch, accelerate,
                  plan=None, **fit_kw):
    """``Model.fit`` for one epoch over ``DataLoader(TensorDataset(
    arrays), batch, no shuffle)`` (staged by ``prefetch_to_device``) of a
    fresh seeded model wrapped by ``wrap``, under the chaos ``plan`` if
    given, ``fit_kw`` passed on (``anomaly=``, checkpoints); each step
    ends in its loss read.  Returns (model, result)."""
    from contextlib import nullcontext

    from paddle_tpu_torch import Model, callbacks, io, nn
    from paddle_tpu_torch.profiler.jit_cost import compile_budget
    from paddle_tpu_torch.testing import chaos

    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    net = wrap(make_model())
    model = Model(net)
    model.prepare(make_opt(net), nn.CrossEntropyLoss(),
                  accelerate=accelerate)
    losses, ms = [], []

    class Record(callbacks.Callback):
        def on_train_batch_begin(self, step, logs=None):
            self.t0 = time.perf_counter()

        def on_train_batch_end(self, step, logs=None):
            ms.append((time.perf_counter() - self.t0) * 1e3)
            losses.append(logs["loss"])

    loader = io.DataLoader(io.TensorDataset(arrays), batch_size=batch,
                           shuffle=False, drop_last=True)
    with compile_budget(None, names=("hapi/train_step",)) as cb, \
            (chaos.running(plan) if plan is not None else nullcontext()):
        model.fit(loader, epochs=1, verbose=0, callbacks=[Record()],
                  **fit_kw)
    torch.cuda.synchronize()
    return model, {"losses": losses, **_steady(ms),
                   "captures": cb.compiles().get("hapi/train_step", 0),
                   "max_memory_allocated": torch.cuda.max_memory_allocated()}


def autocast_wrapper(split_mask=False):
    """``wrap(net)``: a port ``nn.Layer`` running ``net`` under
    ``auto_cast(dtype="bfloat16")`` as ``bench.py``'s step does (hapi's
    ``amp_configs`` is ignored, as in the JAX package); with
    ``split_mask`` its input is ``[B, 2, S]``, token ids and the
    validity mask, for BERT."""
    from paddle_tpu_torch import amp, nn

    class AutoCast(nn.Layer):
        def __init__(self, net):
            super().__init__()
            self.net = net

        def forward(self, x):
            with amp.auto_cast(dtype="bfloat16"):
                if split_mask:
                    return self.net(x[:, 0], None, x[:, 1])
                return self.net(x)

    return AutoCast


def seeded(build, **kw):
    """A maker of ``build(**kw)`` from ``seed(0)``: every call the same
    weights."""
    def make():
        import paddle_tpu_torch as pt

        pt.seed(0)
        return build(**kw)

    return make


def close_losses(a, b, rtol):
    return all(abs(x - y) <= rtol * max(1.0, abs(y)) for x, y in zip(a, b))


def stats_moved(model) -> bool:
    """Whether every batch norm's running mean left zero."""
    means = [b._value for n, b in model.named_buffers()
             if n.endswith("._mean")]
    return bool(means) and all(float(m.abs().max()) > 0 for m in means)


def _first_buffer_difference(a, b):
    for (name, x), (_, y) in zip(list(a.named_parameters())
                                 + list(a.named_buffers()),
                                 list(b.named_parameters())
                                 + list(b.named_buffers())):
        if not torch.equal(x._value, y._value):
            return {"name": name, "max_abs_diff": float(
                (x._value.float() - y._value.float()).abs().max())}
    return None


def state_snapshot(model) -> dict:
    """Copies of a model's parameters and buffers, by name."""
    return {n: t._value.detach().clone()
            for n, t in list(model.named_parameters())
            + list(model.named_buffers())}


def state_difference(a, b) -> dict:
    """Two ``state_snapshot``s: the first tensor that differs at all
    (None: bit-equal) and the largest relative L2 difference, with its
    name."""
    first, worst, at = None, 0.0, None
    for name, x in a.items():
        y = b[name]
        if first is None and not torch.equal(x, y):
            first = name
        d = float((x.float() - y.float()).norm())
        rel = d / max(float(y.float().norm()), 1e-30) if d else 0.0
        if rel > worst:
            worst, at = rel, name
    return {"first_difference": first, "max_rel_l2": worst,
            "max_rel_l2_at": at}


RESNET_BATCH, RESNET_SIZE, RESNET_STEPS = 128, 224, 6
RESNET_FIT_BATCHES = 4
# graphed vs eager in bf16: cuDNN's algorithms may sum in another order
# from run to run (a cuDNN heuristic, not the port); a loss at ~7 moves
# by a few bf16 ulps of the logits at most
RESNET_LOSS_RTOL = 1e-2
# graphed vs eager parameters and running statistics after the same
# steps, per tensor: another cuDNN summation order moves a tensor by a
# few bf16 ulps, relative ~1e-3 at most; a replay that left a running
# statistic or a parameter unupdated is off by ~1
RESNET_STATE_REL_L2 = 1e-2
CONVNET_BATCH, CONVNET_STEPS = 32, 3
DETERMINISM_BATCH, DETERMINISM_SIZE, DETERMINISM_STEPS = 16, 224, 3


def resnet18_determinism(rng) -> dict:
    """A graphed bench-form ResNet-18 step (NHWC, f32, TF32 off, B 16 ×
    224²) against the eager one from the same weights, under
    ``cudnn.deterministic``: losses, parameters and running statistics
    bit-equal after DETERMINISM_STEPS steps.  Then two eager runs with
    ``cudnn.deterministic`` off: their spread, reported."""
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision.models import resnet18

    x = torch.from_numpy(rng.randn(
        DETERMINISM_BATCH, DETERMINISM_SIZE, DETERMINISM_SIZE, 3).astype(
            np.float32)).to(DEVICE)
    y = torch.from_numpy(rng.randint(0, 1000, (DETERMINISM_BATCH,)).astype(
        np.int64)).to(DEVICE)

    make = seeded(resnet18, data_format="NHWC")

    def opt(m):
        return Momentum(0.1, 0.9, parameters=m.parameters())

    prev = torch.backends.cudnn.deterministic
    runs = {}
    try:
        torch.backends.cudnn.deterministic = True
        for mode, graphed in (("graphed", True), ("eager", False)):
            runs[mode] = bench_run(make, opt, (x, y), DETERMINISM_STEPS,
                                   graphed, amp_dtype=None)
        torch.backends.cudnn.deterministic = False
        loose = [bench_run(make, opt, (x, y), DETERMINISM_STEPS, False,
                           amp_dtype=None) for _ in range(2)]
    finally:
        torch.backends.cudnn.deterministic = prev
    diff = _first_buffer_difference(runs["graphed"][0], runs["eager"][0])
    spread = _first_buffer_difference(loose[0][0], loose[1][0])
    res = {"batch": DETERMINISM_BATCH, "size": DETERMINISM_SIZE,
           "steps": DETERMINISM_STEPS,
           "graphed_losses": runs["graphed"][3]["losses"],
           "eager_losses": runs["eager"][3]["losses"],
           "first_difference": diff,
           "nondeterministic_eager_losses": [r[3]["losses"] for r in loose],
           "nondeterministic_first_difference": spread}
    if diff is not None or res["graphed_losses"] != res["eager_losses"]:
        raise AssertionError(f"resnet: under cudnn.deterministic the "
                             f"graphed ResNet-18 step differs from the "
                             f"eager one: {res}")
    return res


def convnet_path(name, make_model) -> dict:
    """CONVNET_STEPS graphed bench-form steps (bf16 autocast, Momentum)
    of a model at B 32 × 224², NCHW: losses finite, every running mean
    moved."""
    from paddle_tpu_torch.optimizer import Momentum

    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(CONVNET_BATCH, 3, RESNET_SIZE,
                                   RESNET_SIZE).astype(np.float32)).to(DEVICE)
    y = torch.from_numpy(rng.randint(0, 1000, (CONVNET_BATCH,)).astype(
        np.int64)).to(DEVICE)
    model, _, _, res = bench_run(
        make_model, lambda m: Momentum(0.1, 0.9, parameters=m.parameters()),
        (x, y), CONVNET_STEPS, True)
    res["stats_moved"] = stats_moved(model)
    res["images_per_s"] = CONVNET_BATCH / (res["step_ms_p50"] / 1e3)
    if not (all(math.isfinite(v) for v in res["losses"])
            and res["stats_moved"]):
        raise AssertionError(f"resnet: {name} {res}")
    return res


def resnet_phase() -> dict:
    """ResNet-50 at ``bench.py``'s settings (NHWC, bf16 autocast,
    ``Momentum(0.1, 0.9)``, ``CrossEntropyLoss``, B 128 × 224² × 3 and
    labels from ``RandomState(0)``): (a) the bench-form step graphed and
    eager, RESNET_STEPS steps each from the same weights; (b)
    ``Model.fit`` over RESNET_FIT_BATCHES batches of the same arrays with
    ``accelerate`` True and False.  Losses finite and graphed within
    RESNET_LOSS_RTOL of eager, every running mean moved, the AMP casts of
    every op name as the JAX lists say; step p50 / p95, images/s, peak
    memory; one more graphed bench step under the profiler (busy share,
    kernels by family, every copy kernel).  Then VGG-16 with batch norm
    and MobileNet V2 through ``convnet_path``, and
    ``resnet18_determinism``.  The graphed runs' parameters and running
    statistics, read right after their training steps, are held to the
    eager runs' within RESNET_STATE_REL_L2 (bit-equality reported), and
    one ``evaluate`` and one ``predict_batch`` of the graphed fit model
    (eval mode: the running statistics) to the eager fit model's."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import io
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision.models import mobilenet_v2, resnet50, vgg16

    pt.set_device(DEVICE)
    rng = np.random.RandomState(0)
    n = RESNET_BATCH * RESNET_FIT_BATCHES
    x_np = rng.randn(n, RESNET_SIZE, RESNET_SIZE, 3).astype(np.float32)
    y_np = rng.randint(0, 1000, (n,)).astype(np.int64)
    x = torch.from_numpy(x_np[:RESNET_BATCH]).to(DEVICE)
    y = torch.from_numpy(y_np[:RESNET_BATCH]).to(DEVICE)

    make = seeded(resnet50, num_classes=1000, data_format="NHWC")

    def opt(m):
        return Momentum(0.1, 0.9, parameters=m.parameters())

    bench, states = {}, {}
    for mode, graphed in (("graphed", True), ("eager", False)):
        model, step, state, res = bench_run(make, opt, (x, y), RESNET_STEPS,
                                            graphed)
        res["images_per_s"] = RESNET_BATCH / (res["step_ms_p50"] / 1e3)
        res["stats_moved"] = stats_moved(model)
        states["bench", mode] = state_snapshot(model)
        bench[mode] = res
        if graphed:
            prof = profile_families(lambda: float(step(state, x, y)),
                                    conv_family)
        else:
            with amp_op_names() as seen:
                step(state, x, y)
            amp_ops = check_amp_ops("resnet", seen)
            prof_ops = profile_ops(lambda: float(step(state, x, y)),
                                   CONV_NET_OPS)
        del model, step, state
    fits, evals = {}, {}
    eval_set = io.TensorDataset([x_np[:RESNET_BATCH], y_np[:RESNET_BATCH]])
    for mode, accelerate in (("graphed", True), ("eager", False)):
        model, res = fit_bench_run(make, opt, autocast_wrapper(),
                                   [x_np, y_np], RESNET_BATCH, accelerate)
        res["images_per_s"] = RESNET_BATCH / (res["step_ms_p50"] / 1e3)
        res["stats_moved"] = stats_moved(model.network)
        states["fit", mode] = state_snapshot(model.network)
        res["eval_loss"] = model.evaluate(eval_set, batch_size=RESNET_BATCH,
                                          verbose=0)["loss"]
        evals[mode] = model.predict_batch([x_np[:RESNET_BATCH]])[0]
        fits[mode] = res
        del model
    del x_np, y_np
    free_cuda()
    logits_rel_l2 = float(np.linalg.norm(evals["graphed"] - evals["eager"])
                          / np.linalg.norm(evals["eager"]))
    state_diff = {name: state_difference(states[name, "graphed"],
                                         states[name, "eager"])
                  for name in ("bench", "fit")}
    del states
    res = {"batch": RESNET_BATCH, "size": RESNET_SIZE, "layout": "NHWC",
           "steps": RESNET_STEPS, "bench": bench, "fit": fits,
           "graphed_vs_eager_state": state_diff,
           "fit_eval_logits_rel_l2": logits_rel_l2,
           "fit_eval_logits_bit_equal": bool(
               np.array_equal(evals["graphed"], evals["eager"])),
           "amp_ops": amp_ops, "profile_graphed_step": prof,
           "profile_eager_step_by_op": prof_ops}
    res["vgg16_bn"] = convnet_path("vgg16_bn",
                                   seeded(vgg16, batch_norm=True))
    res["mobilenet_v2"] = convnet_path("mobilenet_v2", seeded(mobilenet_v2))
    free_cuda()
    res["determinism"] = resnet18_determinism(np.random.RandomState(1))
    log("resnet", **res)
    for name, runs in (("bench", bench), ("fit", fits)):
        g, e = runs["graphed"], runs["eager"]
        if not all(math.isfinite(v) for r in (g, e) for v in r["losses"]):
            raise AssertionError(f"resnet: non-finite {name} losses {runs}")
        if not (g["stats_moved"] and e["stats_moved"]):
            raise AssertionError(f"resnet: {name} left a running mean at 0")
        if not close_losses(g["losses"], e["losses"], RESNET_LOSS_RTOL):
            raise AssertionError(f"resnet: {name} graphed losses "
                                 f"{g['losses']} vs eager {e['losses']}")
        if not state_diff[name]["max_rel_l2"] <= RESNET_STATE_REL_L2:
            raise AssertionError(f"resnet: {name} graphed state vs eager "
                                 f"{state_diff[name]}")
    if not (close_losses([fits["graphed"]["eval_loss"]],
                         [fits["eager"]["eval_loss"]], RESNET_LOSS_RTOL)
            and logits_rel_l2 <= RESNET_STATE_REL_L2):
        raise AssertionError(
            f"resnet: evaluate after the graphed fit: loss "
            f"{fits['graphed']['eval_loss']} vs eager "
            f"{fits['eager']['eval_loss']}, logits rel L2 {logits_rel_l2}")
    if fits["graphed"]["captures"] != 1:
        raise AssertionError(f"resnet: fit captured "
                             f"{fits['graphed']['captures']} times")
    return res


BERT_BATCH, BERT_SEQ, BERT_STEPS, BERT_FIT_BATCHES = 32, 128, 6, 4
# graphed vs eager: cuBLAS and the flash kernels run the same kernels in
# both, and every dropout draw comes from the port's generator, which
# each graph registers; so the losses are
# expected bit-equal and are held to 1e-3 relative, the bit-equality
# reported
BERT_LOSS_RTOL = 1e-3


def bert_inputs(rng, n):
    """Token ids ``[n, BERT_SEQ]`` and labels as ``bench.py:390-392``
    draws them, and a ``[n, BERT_SEQ]`` validity mask padding the last
    quarter of every second row."""
    ids = rng.randint(0, 30000, (n, BERT_SEQ)).astype(np.int64)
    y = rng.randint(0, 2, (n,)).astype(np.int64)
    mask = np.ones((n, BERT_SEQ), np.int64)
    mask[1::2, BERT_SEQ - BERT_SEQ // 4:] = 0
    return ids, mask, y


def bert_route_check() -> dict:
    """A 2-layer bert-base-width classifier, f32 (TF32 off), no dropout,
    B 4 × S 128 with the padding mask: one forward and backward on the
    flash route (#5-#7, 3xTF32 bodies: 2 launches of each) against the
    same on the plain attention route; the loss within 1e-5 relative and
    every gradient within FLASH_REL_L2 (f32) in relative L2."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.ops import attention
    from paddle_tpu_torch.text.models import BertForSequenceClassification

    ids, mask, y = bert_inputs(np.random.RandomState(3), 4)
    ids, mask, y = (torch.from_numpy(a).to(DEVICE) for a in (ids, mask, y))
    pt.seed(0)
    model = BertForSequenceClassification(
        num_hidden_layers=2, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0, dropout=0.0)

    def run():
        logits = model(pt.Tensor(ids), None, pt.Tensor(mask))
        loss = nn.CrossEntropyLoss()(logits, pt.Tensor(y))
        params = [p._value for p in model.parameters()]
        grads = torch.autograd.grad(loss._value, params)
        return float(loss), grads

    reset_flash_counts()
    loss, grads = run()
    counts = read_flash_counts()
    real = attention._pallas_ok
    attention._pallas_ok = lambda *a, **k: False
    try:
        plain_loss, plain_grads = run()
    finally:
        attention._pallas_ok = real
    rel = max(flash_rel_l2(g, p) for g, p in zip(grads, plain_grads))
    res = {"loss": loss, "plain_loss": plain_loss, "grad_rel_l2_max": rel,
           "launches": counts}
    want = {"flash_f32tc_fwd": 2, "flash_f32tc_dkv": 2, "flash_f32tc_dq": 2,
            "flash_ref": 0, "route_pallas": 2, "route_xla": 0}
    expect_counts("bert_route", counts, want)
    if abs(loss - plain_loss) > 1e-5 * abs(plain_loss) or \
            rel > FLASH_REL_L2[torch.float32]:
        raise AssertionError(f"bert: the flash route differs from the plain "
                             f"route: {res}")
    return res


def bert_phase() -> dict:
    """``BertForSequenceClassification()`` at bert-base width,
    ``AdamW(5e-5)``, bf16 autocast, B 32 × S 128 ids from
    ``RandomState(0)`` with ``bert_inputs``' padding mask: the bench-form
    step graphed and eager (BERT_STEPS steps each) and ``Model.fit`` over
    BERT_FIT_BATCHES batches graphed and eager (ids and mask packed
    ``[B, 2, S]``); the launches of #5-#7 in every step of each run, all
    on the bf16 tensor-core bodies (12 a step each), the plain route 0;
    losses finite, graphed within BERT_LOSS_RTOL of eager; step p50 /
    p95, tokens/s, peak memory; then ``bert_route_check``."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text.models import BertForSequenceClassification

    pt.set_device(DEVICE)
    n = BERT_BATCH * BERT_FIT_BATCHES
    ids_np, mask_np, y_np = bert_inputs(np.random.RandomState(0), n)
    ids, mask, y = (torch.from_numpy(a[:BERT_BATCH]).to(DEVICE)
                    for a in (ids_np, mask_np, y_np))

    make = seeded(BertForSequenceClassification, num_classes=2)

    def opt(m):
        return AdamW(5e-5, parameters=m.parameters())

    layers = 12
    runs = {}
    for mode, graphed in (("bench_graphed", True), ("bench_eager", False)):
        reset_flash_counts()
        model, step, state, res = bench_run(make, opt, (ids, None, mask, y),
                                            BERT_STEPS, graphed)
        res.update(read_flash_counts())
        res["steps"] = BERT_STEPS
        runs[mode] = res
        if graphed:
            prof = profile_families(
                lambda: float(step(state, ids, None, mask, y)), bert_family)
        del model, step, state
    packed = np.stack([ids_np, mask_np], axis=1)
    for mode, accelerate in (("fit_graphed", True), ("fit_eager", False)):
        reset_flash_counts()
        model, res = fit_bench_run(make, opt, autocast_wrapper(True),
                                   [packed, y_np], BERT_BATCH, accelerate)
        res.update(read_flash_counts())
        res["steps"] = BERT_FIT_BATCHES
        runs[mode] = res
        del model
    free_cuda()
    for mode, r in runs.items():
        r["tokens_per_s"] = BERT_BATCH * BERT_SEQ / (r["step_ms_p50"] / 1e3)
        k = layers * r["steps"]
        expect_counts(f"bert_{mode}", r, {
            "flash_fwd": k, "flash_dkv": k, "flash_dq": k, "flash_ref": 0,
            "flash_tc_fwd": k, "flash_tc_dkv": k, "flash_tc_dq": k,
            "route_pallas": k, "route_xla": 0})
    res = {"batch": BERT_BATCH, "seq": BERT_SEQ, "layers": layers,
           "padded_rows": BERT_BATCH // 2, "padded_tokens": BERT_SEQ // 4,
           **runs, "profile_graphed_step": prof,
           "route_check": bert_route_check()}
    for kind in ("bench", "fit"):
        g, e = res[f"{kind}_graphed"], res[f"{kind}_eager"]
        res[f"{kind}_bit_equal_losses"] = g["losses"] == e["losses"]
    log("bert", **res)
    for kind in ("bench", "fit"):
        g, e = res[f"{kind}_graphed"], res[f"{kind}_eager"]
        if not all(math.isfinite(v) for v in g["losses"] + e["losses"]):
            raise AssertionError(f"bert: non-finite {kind} losses")
        if not close_losses(g["losses"], e["losses"], BERT_LOSS_RTOL):
            raise AssertionError(f"bert: {kind} graphed losses {g['losses']}"
                                 f" vs eager {e['losses']}")
    if res["fit_graphed"]["captures"] != 1:
        raise AssertionError(f"bert: fit captured "
                             f"{res['fit_graphed']['captures']} times")
    return res


# --------------------------------------------------------------------------
# numerical self-healing and mixed precision: fit(anomaly=), GradScaler,
# decorate / O2
# --------------------------------------------------------------------------
ANOMALY_BATCHES = 7
ANOMALY_SKIP = 3                   # the batch a chaos nan_grad poisons
ANOMALY_CORRUPT_AT = 4             # the train.step visit corrupt_param hits
ANOMALY_CKPT_INTERVAL = 2
ANOMALY_LEAF = "net.layer3.0.conv2.weight"


def _train_state(model) -> dict:
    """Copies of a hapi Model's parameters, buffers and optimizer
    accumulators (``opt/param_{i}_{kind}``), by name."""
    out = state_snapshot(model.network)
    out.update({f"opt/{k}": v for k, v in
                model._optimizer.state_dict().items() if torch.is_tensor(v)})
    return out


def _bit_equal(a, b):
    """The first name whose tensor differs (None: every tensor equal)."""
    if a.keys() != b.keys():
        return sorted(set(a) ^ set(b))[0]
    return next((k for k in a if not torch.equal(a[k], b[k])), None)


def anomaly_phase() -> dict:
    """ResNet-50 at the ``resnet`` phase's settings (NHWC, bf16 autocast,
    ``Momentum(0.1, 0.9)``, B 128 × 224², ANOMALY_BATCHES batches from
    ``RandomState(0)``) through a graphed ``Model.fit(anomaly=...)`` with
    ``cudnn.deterministic`` on (restored after):
    (a) a chaos ``nan_grad`` at batch ANOMALY_SKIP under a skip-only
    policy skips exactly one step, and the parameters, running
    statistics and Momentum's velocities then equal, bit for bit, a
    guarded fit over the same batches without that batch; one capture;
    (b) a ``corrupt_param`` of ANOMALY_LEAF (train.step visit
    ANOMALY_CORRUPT_AT) is named by the audit (the flight recorder's
    ``train.corruption`` target), the fit rolls back to the newest
    verified checkpoint (every ANOMALY_CKPT_INTERVAL steps) and ends bit-
    equal to the same fit without the fault; still one capture;
    (c) the guarded step p50 against an unguarded fit's, the discard (the
    pre-step copy copied back) and the rollback's restore in ms, and the
    audit's ms (median of 5 on the trained model)."""
    import tempfile

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.framework.monitor import stat_get
    from paddle_tpu_torch.hapi import AnomalyPolicy, Model, ParameterAudit
    from paddle_tpu_torch.hapi import checkpoint as hckpt
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.profiler.flight_recorder import recorder
    from paddle_tpu_torch.testing import chaos
    from paddle_tpu_torch.vision.models import resnet50

    pt.set_device(DEVICE)
    rng = np.random.RandomState(0)
    n = RESNET_BATCH * ANOMALY_BATCHES
    x_np = rng.randn(n, RESNET_SIZE, RESNET_SIZE, 3).astype(np.float32)
    y_np = rng.randint(0, 1000, (n,)).astype(np.int64)
    keep = np.ones(n, bool)
    keep[ANOMALY_SKIP * RESNET_BATCH:(ANOMALY_SKIP + 1) * RESNET_BATCH] = 0
    make = seeded(resnet50, num_classes=1000, data_format="NHWC")

    def opt(m):
        return Momentum(0.1, 0.9, parameters=m.parameters())

    def run(arrays, **kw):
        model, res = fit_bench_run(make, opt, autocast_wrapper(), arrays,
                                   RESNET_BATCH, True, **kw)
        state = _train_state(model)
        return model, res, state

    skip_only = AnomalyPolicy(rollback_after=None, spike_window=0)
    timed = {"discard": [], "restore": []}
    real_discard, real_restore = Model._discard_step, \
        hckpt.restore_train_state

    def discard(self):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        real_discard(self)
        torch.cuda.synchronize()
        timed["discard"].append((time.perf_counter() - t0) * 1e3)

    def restore(model, state):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_restore(model, state)
        torch.cuda.synchronize()
        timed["restore"].append((time.perf_counter() - t0) * 1e3)
        return out

    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    Model._discard_step = discard
    hckpt.restore_train_state = restore
    try:
        model, plain, _ = run([x_np, y_np])
        del model
        skipped0 = stat_get("train.anomaly.skipped_steps")
        plan = chaos.ChaosPlan([chaos.Fault(
            "train.step", at=ANOMALY_SKIP + 1, action=chaos.NAN_GRAD)])
        model, skip, skip_state = run([x_np, y_np], plan=plan,
                                      anomaly=skip_only)
        skip["skipped_steps"] = stat_get(
            "train.anomaly.skipped_steps") - skipped0
        skip["fired"] = plan.fired_log()
        skip["discard_ms"] = list(timed["discard"])
        del model
        _, clean, clean_state = run([x_np[keep], y_np[keep]],
                                    anomaly=skip_only)
        skip_diff = _bit_equal(skip_state, clean_state)
        del skip_state, clean_state
        free_cuda()
        pol = AnomalyPolicy(rollback_after=10, rollback_window=32,
                            rollback_budget=2, audit_interval=2,
                            spike_window=0)
        ckpt = dict(checkpoint_interval=ANOMALY_CKPT_INTERVAL,
                    checkpoint_async=False)
        with tempfile.TemporaryDirectory() as d:
            rb0 = stat_get("train.anomaly.rollbacks")
            recorder.reset()
            plan = chaos.ChaosPlan([chaos.Fault(
                "train.step", at=ANOMALY_CORRUPT_AT,
                action=chaos.CORRUPT_PARAM, leaf=ANOMALY_LEAF)])
            model, rb, rb_state = run([x_np, y_np], plan=plan, anomaly=pol,
                                      checkpoint_dir=f"{d}/faulted", **ckpt)
            rb["rollbacks"] = stat_get("train.anomaly.rollbacks") - rb0
            trans = recorder.build_bundle("anomaly")["transitions"]
            rb["corruption_named"] = [t["target"] for t in trans
                                      if t["kind"] == "train.corruption"]
            del model
            model, ref, ref_state = run([x_np, y_np], anomaly=pol,
                                        checkpoint_dir=f"{d}/clean", **ckpt)
        rb_diff = _bit_equal(rb_state, ref_state)
        del rb_state, ref_state
        audit_ms = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ParameterAudit().corrupted_leaf(model)
            audit_ms.append((time.perf_counter() - t0) * 1e3)
        del model
    finally:
        torch.backends.cudnn.deterministic = prev
        Model._discard_step = real_discard
        hckpt.restore_train_state = real_restore
    del x_np, y_np
    free_cuda()
    res = {"batch": RESNET_BATCH, "size": RESNET_SIZE, "layout": "NHWC",
           "batches": ANOMALY_BATCHES, "skip_batch": ANOMALY_SKIP,
           "corrupt_leaf": ANOMALY_LEAF, "unguarded": plain,
           "skip": skip, "clean_minus_batch": clean,
           "skip_first_difference": skip_diff, "rollback": rb,
           "rollback_reference": ref, "rollback_first_difference": rb_diff,
           "guarded_step_ms_p50": clean["step_ms_p50"],
           "unguarded_step_ms_p50": plain["step_ms_p50"],
           "guard_overhead_ms": clean["step_ms_p50"] - plain["step_ms_p50"],
           "discard_ms": timed["discard"], "restore_ms": timed["restore"],
           "audit_ms_p50": float(np.median(audit_ms)), "audit_ms": audit_ms}
    log("anomaly", **res)
    if skip["skipped_steps"] != 1 or len(skip["fired"]) != 1 \
            or len(skip["discard_ms"]) != 1:
        raise AssertionError(f"anomaly: the nan_grad fit skipped "
                             f"{skip['skipped_steps']} steps: {skip['fired']}")
    if skip_diff is not None:
        raise AssertionError(f"anomaly: the skip run differs from the run "
                             f"without batch {ANOMALY_SKIP} at {skip_diff}")
    if rb["rollbacks"] != 1 or rb["corruption_named"][:1] != [ANOMALY_LEAF] \
            or len(timed["restore"]) != 1:
        raise AssertionError(f"anomaly: rollback {rb['rollbacks']}, audit "
                             f"named {rb['corruption_named']}")
    if rb_diff is not None:
        raise AssertionError(f"anomaly: the rolled-back fit differs from "
                             f"the clean one at {rb_diff}")
    for name, r in (("unguarded", plain), ("skip", skip), ("clean", clean),
                    ("rollback", rb), ("reference", ref)):
        if r["captures"] != 1:
            raise AssertionError(f"anomaly: the {name} fit captured "
                                 f"{r['captures']} times")
        if not all(math.isfinite(v) for v in r["losses"]):
            raise AssertionError(f"anomaly: {name} logged non-finite "
                                 f"losses {r['losses']}")
    return res


AMP_FP16_STEPS = 6
AMP_OVERFLOW_STEPS, AMP_OVERFLOW_SCALE = 10, 2.0 ** 24
# fp16 against bf16 autocast, the same BERT steps from the same weights
# and dropout draws: the products round to 11 significant bits in one and
# 8 in the other, so a loss of ~0.7 moves by a few bf16 ulps (2^-8
# relative each) over 6 AdamW steps at 5e-5; 2e-2 relative holds that,
# and fails a step that went wrong (a skipped or doubled update moves the
# loss by the step's whole change)
AMP_FP16_LOSS_RTOL = 2e-2


def amp_loop(dtype, scaler, steps, inputs, until_finite=False):
    """The bare dygraph loop on a seeded ``BertForSequenceClassification``
    (bert-base, ``AdamW(5e-5)``): each step ``auto_cast(dtype=dtype)``
    forward, ``scaler.scale(loss).backward(); scaler.step(opt);
    scaler.update(); opt.clear_grad()``, counted under
    ``set_sync_debug_mode("warn")``.  Per step: the loss, the scale it
    ran at, whether the scaler found an inf, whether every parameter kept
    its bits, the fp16-body launches of #5-#7 and the host syncs.
    ``until_finite``: stop after the first step the scaler found
    finite."""
    import warnings

    import paddle_tpu_torch as pt
    from paddle_tpu_torch import amp, nn
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text.models import BertForSequenceClassification

    ids, mask, y = (pt.Tensor(t) for t in inputs)
    pt.set_device(DEVICE)
    model = seeded(BertForSequenceClassification, num_classes=2)()
    opt = AdamW(5e-5, parameters=model.parameters())
    loss_fn = nn.CrossEntropyLoss()
    params = [p._value for p in model.parameters()]
    pt.seed(1)
    out, ms = [], []
    for _ in range(steps):
        before = [p.detach().clone() for p in params]
        scale = scaler.get_loss_scaling()
        reset_flash_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                with amp.auto_cast(dtype=dtype):
                    loss = loss_fn(model(ids, None, mask), y)
                scaler.scale(loss).backward()
                scaler.step(opt)
                scaler.update()
                opt.clear_grad()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        lossf = float(loss)
        ms.append((time.perf_counter() - t0) * 1e3)
        counts = read_flash_counts()
        found_inf = bool(scaler._found_inf) if scaler.is_enable() else False
        out.append({
            "loss": lossf, "scale": scale, "found_inf": found_inf,
            "params_unchanged": all(torch.equal(b, p)
                                    for b, p in zip(before, params)),
            "flash_fp16": {k: counts[f"flash_fp16_{k}"]
                           for k in ("fwd", "dkv", "dq")},
            "flash_tc": {k: counts[f"flash_tc_{k}"]
                         for k in ("fwd", "dkv", "dq")},
            "host_syncs": sum("synchroniz" in str(w.message) for w in seen)})
        del before
        if until_finite and not found_inf:
            break
    del model, opt, params
    free_cuda()
    return out, _steady(ms)


def amp_fp16_phase() -> dict:
    """BERT-base, B 32 × S 128 (``bert_inputs`` from ``RandomState(0)``),
    under ``auto_cast(dtype="float16")`` with ``GradScaler`` in the bare
    dygraph loop, AMP_FP16_STEPS steps: every step launches #5-#7 12
    times each on the fp16 bodies (no ``TypeError``), none skipped, the
    losses within AMP_FP16_LOSS_RTOL of the same loop under bf16 autocast
    (the scaler off); then from ``init_loss_scaling=2**24``: the first
    steps overflow, each skipped with every parameter bit-unchanged and
    the scale halved, until the first finite step (at most
    AMP_OVERFLOW_STEPS).  The host syncs a step are counted (the
    scaler's one read included)."""
    from paddle_tpu_torch.amp import GradScaler

    rng = np.random.RandomState(0)
    inputs = tuple(torch.from_numpy(a).to(DEVICE)
                   for a in bert_inputs(rng, BERT_BATCH))
    fp16, fp16_ms = amp_loop("float16", GradScaler(), AMP_FP16_STEPS,
                             inputs)
    bf16, bf16_ms = amp_loop("bfloat16", GradScaler(enable=False),
                             AMP_FP16_STEPS, inputs)
    over, _ = amp_loop("float16",
                       GradScaler(init_loss_scaling=AMP_OVERFLOW_SCALE),
                       AMP_OVERFLOW_STEPS, inputs, until_finite=True)
    layers = 12
    res = {"batch": BERT_BATCH, "seq": BERT_SEQ, "steps": fp16,
           "step_ms": fp16_ms, "bf16_steps": bf16, "bf16_step_ms": bf16_ms,
           "overflow_steps": over,
           "host_syncs_per_step": [s["host_syncs"] for s in fp16],
           "skipped": sum(s["found_inf"] for s in fp16),
           "overflow_skipped": sum(s["found_inf"] for s in over),
           "launches": {f"flash_fp16_{k}": sum(s["flash_fp16"][k]
                                                for s in fp16)
                        for k in ("fwd", "dkv", "dq")}}
    log("amp_fp16", **res)
    want = {"fwd": layers, "dkv": layers, "dq": layers}
    for s in fp16 + over:
        if s["flash_fp16"] != want or any(s["flash_tc"].values()):
            raise AssertionError(f"amp_fp16: a step launched {s}, expected "
                                 f"{want} fp16-body launches")
    if any(s["found_inf"] != s["params_unchanged"] for s in fp16 + over) \
            or all(s["found_inf"] for s in fp16):
        raise AssertionError(f"amp_fp16: a step skipped without an "
                             f"overflow, or updated with one: {fp16}")
    if not close_losses([s["loss"] for s in fp16],
                        [s["loss"] for s in bf16], AMP_FP16_LOSS_RTOL):
        raise AssertionError(f"amp_fp16: fp16 losses "
                             f"{[s['loss'] for s in fp16]} vs bf16 "
                             f"{[s['loss'] for s in bf16]}")
    if len(over) < 2 or not all(s["found_inf"] for s in over[:-1]) \
            or over[-1]["found_inf"]:
        raise AssertionError(f"amp_fp16: the overflow run did not start "
                             f"skipping and end finite: {over}")
    for a, b in zip(fp16 + over, fp16[1:] + [None] + over[1:]):
        if b is None:
            continue
        want_scale = a["scale"] * (0.5 if a["found_inf"] else 1.0)
        if b["scale"] != want_scale:
            raise AssertionError(f"amp_fp16: scale {a['scale']} -> "
                                 f"{b['scale']} after found_inf "
                                 f"{a['found_inf']}")
    if not all(math.isfinite(s["loss"]) for s in fp16 + bf16 + over):
        raise AssertionError("amp_fp16: a non-finite loss")
    return res


# O2 (bf16 weights, no master copy) against O1 (f32 master weights, bf16
# products), the same 6 fit steps of GPT-2-small from the same weights: at
# a loss of ~10.8 the two differ by the weights' bf16 rounding (2^-9
# relative) and its effect on 6 AdamW updates of up to 6e-4; 2e-2
# relative holds that and fails a step that skipped its update or ran in
# another precision than asked
O2_LOSS_RTOL = 2e-2


def o2_phase(fit) -> dict:
    """GPT-2-small at the ``fit`` phase's widths, data and schedule (12
    layers, B 8 × S 1024, FIT_STEPS steps, the ids of
    ``RandomState(10)``), ``decorate(level="O2", dtype="bfloat16")`` then
    a graphed ``Model.fit`` under ``auto_cast(level="O2")``, and the same
    fit at O1 (f32 weights): one capture each; every parameter and AdamW
    moment bf16 after O2; #5-#7 on the bf16 bodies, 12 a step; losses
    finite and O2 within O2_LOSS_RTOL of O1; step p50 and peak memory
    beside the ``fit`` phase's f32 figures."""
    from paddle_tpu_torch.profiler.jit_cost import compile_budget

    ids = np.random.RandomState(10).randint(
        0, GPT2_SMALL["vocab_size"], (FIT_SEQS, TRAIN_SEQ + 1)).astype(
            np.int64)
    runs = {}
    for level in ("O2", "O1"):
        free_cuda()
        torch.cuda.reset_peak_memory_stats()
        reset_flash_counts()
        with compile_budget(None, names=("hapi/train_step",)) as cb:
            model, net, losses, step_ms, _ = fit_run(ids, 12, True,
                                                     amp_level=level)
        torch.cuda.synchronize()
        counts = read_flash_counts()
        r = {"losses": losses, **_steady(step_ms),
             "tokens_per_s": FIT_BATCH * TRAIN_SEQ / (
                 np.percentile(step_ms[1:], 50) / 1e3),
             "max_memory_allocated": torch.cuda.max_memory_allocated(),
             "captures": cb.compiles().get("hapi/train_step", 0),
             "param_dtypes": sorted({str(p.dtype)
                                     for p in net.parameters()}),
             "moment_dtypes": sorted({
                 str(v.dtype) for v in model._optimizer.state_dict()
                 .values() if torch.is_tensor(v)}), **counts}
        runs[level] = r
        del model, net
    free_cuda()
    o2, o1 = runs["O2"], runs["O1"]
    res = {"layers": 12, "batch": FIT_BATCH, "seq": TRAIN_SEQ,
           "steps": FIT_STEPS, "O2": o2, "O1": o1,
           "fit_f32_step_ms_p50": fit["graphed"]["step_ms_p50"],
           "fit_f32_max_memory_allocated":
               fit["graphed"]["max_memory_allocated"]}
    log("o2", **res)
    n = 12 * FIT_STEPS
    for level, r in runs.items():
        expect_counts(f"o2_{level}", r, {
            "flash_tc_fwd": n, "flash_tc_dkv": n, "flash_tc_dq": n,
            "flash_ref": 0, "flash_f32tc_fwd": 0, "flash_fp16_fwd": 0})
        if r["captures"] != 1:
            raise AssertionError(f"o2: {level} captured {r['captures']} "
                                 f"times")
        if not all(math.isfinite(v) for v in r["losses"]):
            raise AssertionError(f"o2: {level} losses {r['losses']}")
    if o2["param_dtypes"] != ["torch.bfloat16"] or \
            o2["moment_dtypes"] != ["torch.bfloat16"]:
        raise AssertionError(f"o2: parameters {o2['param_dtypes']}, "
                             f"moments {o2['moment_dtypes']}")
    if o1["param_dtypes"] != ["torch.float32"]:
        raise AssertionError(f"o2: O1 parameters {o1['param_dtypes']}")
    if not close_losses(o2["losses"], o1["losses"], O2_LOSS_RTOL):
        raise AssertionError(f"o2: O2 losses {o2['losses']} vs O1 "
                             f"{o1['losses']}")
    return res


# --------------------------------------------------------------------------
# phase 36: the eager framework's public surface
# --------------------------------------------------------------------------
EAGER_EXACT = "exact"
EAGER_F32 = (1e-6, 1e-6)
# the special functions and the linear algebra: other polynomial
# approximations and other orders of summation (LAPACK / cuSOLVER)
EAGER_SPECIAL = (1e-5, 1e-5)
EAGER_LINALG = (1e-4, 1e-5)
EAGER_RANDOM_N = 20000
EAGER_MLP_STEPS = 20
EAGER_MLP_RTOL = 1e-5
EAGER_HOST_CALLS = 1000


class _EagerInputs:
    """The phase's seeded inputs as one device's tensors."""

    def __init__(self, P, arrays, device):
        for k, v in arrays.items():
            setattr(self, k, P.to_tensor(v, place=device))


def eager_arrays():
    r = np.random.RandomState(36)

    def u(shape, lo=-2.0, hi=2.0):
        return r.uniform(lo, hi, shape).astype(np.float32)

    A = u((6, 6), -1, 1)
    return {
        "X": u((8, 16)), "Y": u((8, 16)), "POS": u((8, 16), 0.1, 3.0),
        "UNIT": u((8, 16), -0.9, 0.9), "BIG": u((8, 16), 1.1, 4.0),
        "I": r.randint(-9, 10, (8, 16)).astype(np.int32),
        "J": r.randint(1, 7, (8, 16)).astype(np.int32),
        "B": r.rand(8, 16) > 0.5, "C": r.rand(8, 16) > 0.3,
        "V": u((16,)), "W": u((16,)), "V3": u((4, 3)), "U3": u((4, 3)),
        "A": A, "SPD": (A @ A.T + 6 * np.eye(6)).astype(np.float32),
        "TRI": (np.triu(A) + 3 * np.eye(6)).astype(np.float32),
        "CHOL": np.linalg.cholesky(A @ A.T + 6 * np.eye(6)).astype(
            np.float32),
        "RHS": u((6, 3)), "TALL": u((10, 4)), "Y10": u((10, 2)),
        "X3": u((2, 8, 16)),
        "TIES": np.array([[3, 1, 3, 2, 3, 1], [0, 5, 5, -1, 0, 5]],
                         np.float32),
        "MODES": np.array([[1, 2, 2, 3, 3, 1], [4, 4, 4, 0, 0, 0]],
                          np.int32),
        "U": np.array([3, 1, 3, 2, 1, 1, 5, 2], np.int32),
        "SORTED": np.sort(u((32,))), "IDX3": np.array([5, 0, 2], np.int32),
        "ROWS": r.randint(0, 16, (8, 4)).astype(np.int32),
        "ND": np.array([[0, 1], [7, 15], [3, 3]], np.int32),
        "NANS": np.array([[1.0, np.nan, np.inf], [-np.inf, 0.5, np.nan]],
                         np.float32),
        "P": np.full((EAGER_RANDOM_N,), 0.3, np.float32),
        "LAM": np.full((EAGER_RANDOM_N,), 2.5, np.float32),
        "PROBS": np.array([0.1, 0.2, 0.7], np.float32),
        "Z": np.zeros((EAGER_RANDOM_N,), np.float32),
        "CPLX": u((4, 3, 2)),
    }


def _eager_calls():
    """``{op name: (call(P, a), tolerance)}`` for every op the slice
    exports (``a``: the inputs on the device the call runs on).  The
    decompositions are compared by their invariants (``key``)."""
    unary = {n: "X" for n in (
        "exp", "expm1", "square", "abs", "sign", "neg", "floor", "ceil",
        "round", "trunc", "frac", "sin", "cos", "atan", "sinh", "cosh",
        "tanh", "asinh", "erf", "sigmoid", "angle", "conj", "real", "imag",
        "deg2rad", "rad2deg", "stanh")}
    unary.update({n: "POS" for n in ("log", "log2", "log10", "log1p", "sqrt",
                                     "rsqrt", "reciprocal", "digamma",
                                     "lgamma")})
    unary.update({n: "UNIT" for n in ("tan", "asin", "acos", "atanh",
                                      "erfinv")})
    unary.update({"acosh": "BIG", "isfinite": "NANS", "isinf": "NANS",
                  "isnan": "NANS", "nan_to_num": "NANS",
                  "logical_not": "B", "bitwise_not": "I"})
    calls = {}
    for n, src in unary.items():
        tol = (EAGER_SPECIAL if n in ("digamma", "lgamma", "erfinv", "tan")
               else EAGER_EXACT if src in ("B", "I", "NANS") or n in (
                   "abs", "sign", "neg", "floor", "ceil", "round", "trunc",
                   "conj", "real", "imag", "angle") else EAGER_F32)
        calls[n] = (lambda P, a, n=n, src=src: getattr(P, n)(
            getattr(a, src)), tol)
    binary = {n: ("X", "Y", EAGER_F32) for n in (
        "add", "subtract", "multiply", "atan2", "hypot", "logaddexp",
        "isclose", "allclose", "kron", "inner", "outer")}
    binary.update({n: ("X", "Y", EAGER_EXACT) for n in (
        "maximum", "minimum", "fmax", "fmin", "heaviside", "nextafter",
        "copysign", "greater_than", "less_than", "equal_all")})
    binary.update({n: ("I", "J", EAGER_EXACT) for n in (
        "gcd", "lcm", "bitwise_and", "bitwise_or", "bitwise_xor", "equal",
        "not_equal", "greater_equal", "less_equal", "floor_divide", "mod",
        "remainder", "floor_mod")})
    binary.update({n: ("B", "C", EAGER_EXACT) for n in (
        "logical_and", "logical_or", "logical_xor")})
    binary.update({"divide": ("X", "POS", EAGER_F32),
                   "pow": ("POS", "Y", EAGER_F32)})
    for n, (s1, s2, tol) in binary.items():
        calls[n] = (lambda P, a, n=n, s1=s1, s2=s2: getattr(P, n)(
            getattr(a, s1), getattr(a, s2)), tol)
    for n in ("sum", "mean", "prod", "logsumexp", "var", "std", "median",
              "nanmean", "nansum"):
        calls[n] = (lambda P, a, n=n: getattr(P, n)(a.X, axis=1), EAGER_F32)
    for n in ("max", "min", "amax", "amin"):
        calls[n] = (lambda P, a, n=n: getattr(P, n)(a.X, axis=0),
                    EAGER_EXACT)
    for n in ("reduce_sum", "reduce_mean", "reduce_max", "reduce_min",
              "reduce_prod"):
        calls[n] = (lambda P, a, n=n: getattr(P, n)(a.X, dim=1), EAGER_F32)
    for n in ("elementwise_add", "elementwise_sub", "elementwise_mul"):
        calls[n] = (lambda P, a, n=n: getattr(P, n)(a.X, a.Y), EAGER_F32)
    for n in ("elementwise_div", "elementwise_pow", "elementwise_mod",
              "elementwise_floordiv"):
        calls[n] = (lambda P, a, n=n: getattr(P, n)(a.POS, a.POS * 0.3 + 1),
                    EAGER_F32)
    E, F, L, S = EAGER_EXACT, EAGER_F32, EAGER_LINALG, EAGER_SPECIAL
    calls.update({
        # math
        "scale": (lambda P, a: P.scale(a.X, 2.0, 1.0), F),
        "increment": (lambda P, a: P.increment(a.X.clone(), 2.0), F),
        "clip": (lambda P, a: P.clip(a.X, -0.5, 0.7), E),
        "lerp": (lambda P, a: P.lerp(a.X, a.Y, 0.3), F),
        "multiplex": (lambda P, a: P.multiplex(
            [a.X, a.Y], P.cast(a.J[:, :1] % 2, "int32")), E),
        "all": (lambda P, a: P.all(a.B, axis=1), E),
        "any": (lambda P, a: P.any(a.B, axis=0), E),
        "quantile": (lambda P, a: P.quantile(a.X, 0.3, axis=1), F),
        "cumsum": (lambda P, a: P.cumsum(a.X, axis=1), F),
        "cumprod": (lambda P, a: P.cumprod(a.UNIT, dim=1), F),
        "cummax": (lambda P, a: P.cummax(a.TIES, axis=1), E),
        "cummin": (lambda P, a: P.cummin(a.TIES, axis=1), E),
        "logcumsumexp": (lambda P, a: P.logcumsumexp(a.X, axis=1), F),
        "add_n": (lambda P, a: P.add_n([a.X, a.Y, a.POS]), F),
        "count_nonzero": (lambda P, a: P.count_nonzero(a.I, axis=1), E),
        "diff": (lambda P, a: P.diff(a.X, axis=1), F),
        "trace": (lambda P, a: P.trace(a.A), F),
        # creation
        "to_tensor": (lambda P, a: P.to_tensor([[1.5, 2.0], [3.0, 4.0]]), E),
        "zeros": (lambda P, a: P.zeros([2, 3]), E),
        "ones": (lambda P, a: P.ones([2, 3], "int32"), E),
        "full": (lambda P, a: P.full([2, 2], 1.5), E),
        "zeros_like": (lambda P, a: P.zeros_like(a.X), E),
        "ones_like": (lambda P, a: P.ones_like(a.I), E),
        "full_like": (lambda P, a: P.full_like(a.X, 3.0), E),
        "empty": (lambda P, a: P.empty([2, 1]), E),
        "empty_like": (lambda P, a: P.empty_like(a.X), E),
        "arange": (lambda P, a: P.arange(0.0, 1.0, 0.125), E),
        "linspace": (lambda P, a: P.linspace(0.0, 1.0, 7), F),
        "logspace": (lambda P, a: P.logspace(0.0, 2.0, 5), F),
        "eye": (lambda P, a: P.eye(3, 4), E),
        "diag": (lambda P, a: P.diag(a.V, 1), E),
        "diagflat": (lambda P, a: P.diagflat(a.V3), E),
        "tril": (lambda P, a: P.tril(a.A, 1), E),
        "triu": (lambda P, a: P.triu(a.A, -1), E),
        "meshgrid": (lambda P, a: P.meshgrid(a.V, a.W), E),
        "assign": (lambda P, a: P.assign(a.X), E),
        "clone": (lambda P, a: P.clone(a.X), E),
        "numel": (lambda P, a: P.numel(a.X3), E),
        "create_parameter": (lambda P, a: P.create_parameter(
            [2, 3], "float32", default_initializer=P.nn.initializer.Constant(
                0.5)), E),
        "create_global_var": (lambda P, a: P.create_global_var(
            [2, 3], 1.5, "float32"), E),
        "fill_constant": (lambda P, a: P.fill_constant([2, 2], "int64", 7),
                          E),
        # manipulation
        "reshape": (lambda P, a: P.reshape(a.X, [4, 32]), E),
        "reshape_": (lambda P, a: P.reshape_(a.X.clone(), [32, 4]), E),
        "transpose": (lambda P, a: P.transpose(a.X3, [2, 0, 1]), E),
        "transpose_": (lambda P, a: P.transpose_(a.X, [1, 0]), E),
        "t": (lambda P, a: P.t(a.X), E),
        "moveaxis": (lambda P, a: P.moveaxis(a.X3, 0, 2), E),
        "swapaxes": (lambda P, a: P.swapaxes(a.X3, 0, 2), E),
        "concat": (lambda P, a: P.concat([a.X, a.Y], axis=1), E),
        "stack": (lambda P, a: P.stack([a.X, a.Y]), E),
        "unstack": (lambda P, a: P.unstack(a.X3), E),
        "split": (lambda P, a: P.split(a.X, [3, -1], axis=1), E),
        "chunk": (lambda P, a: P.chunk(a.X, 4, axis=0), E),
        "squeeze": (lambda P, a: P.squeeze(a.X3[:1], 0), E),
        "squeeze_": (lambda P, a: P.squeeze_(a.X3[:1].clone(), 0), E),
        "unsqueeze": (lambda P, a: P.unsqueeze(a.X, [0, 2]), E),
        "unsqueeze_": (lambda P, a: P.unsqueeze_(a.X.clone(), 1), E),
        "flatten": (lambda P, a: P.flatten(a.X3, 1), E),
        "gather": (lambda P, a: P.gather(a.X, a.IDX3), E),
        "gather_nd": (lambda P, a: P.gather_nd(a.X, a.ND), E),
        "take_along_axis": (lambda P, a: P.take_along_axis(a.X, a.ROWS, 1),
                            E),
        "put_along_axis": (lambda P, a: P.put_along_axis(
            a.X, a.ROWS[:, :1], a.Y[:, :1], 1), E),
        "scatter": (lambda P, a: P.scatter(a.X, a.IDX3, a.Y[:3]), E),
        "scatter_": (lambda P, a: P.scatter_(a.X.clone(), a.IDX3, a.Y[:3]),
                     E),
        "scatter_nd_add": (lambda P, a: P.scatter_nd_add(
            a.X, a.ND, a.V[:3]), F),
        "scatter_nd": (lambda P, a: P.scatter_nd(a.ND, a.V[:3], [8, 16]), F),
        "index_select": (lambda P, a: P.index_select(a.X, a.IDX3, 1), E),
        "index_sample": (lambda P, a: P.index_sample(a.X, a.ROWS), E),
        "take": (lambda P, a: P.take(a.X, a.IDX3, mode="clip"), E),
        "expand": (lambda P, a: P.expand(a.X[:1], [3, 16]), E),
        "expand_as": (lambda P, a: P.expand_as(a.X[:1], a.X), E),
        "broadcast_to": (lambda P, a: P.broadcast_to(a.X[:, :1], [8, 16]),
                         E),
        "broadcast_tensors": (lambda P, a: P.broadcast_tensors(
            [a.X[:1], a.X[:, :1]]), E),
        "broadcast_shape": (lambda P, a: P.to_tensor(P.broadcast_shape(
            [8, 1], [1, 16])), E),
        "tile": (lambda P, a: P.tile(a.X, [2, 1]), E),
        "roll": (lambda P, a: P.roll(a.X, 3, 1), E),
        "flip": (lambda P, a: P.flip(a.X3, [0, 2]), E),
        "rot90": (lambda P, a: P.rot90(a.X), E),
        "slice": (lambda P, a: P.slice(a.X3, [1, 2], [1, -5], [6, 100]), E),
        "strided_slice": (lambda P, a: P.strided_slice(
            a.X3, [1, 2], [7, 15], [0, 0], [-2, -3]), E),
        "pad": (lambda P, a: P.pad(a.X3[None], [1, 2, 0, 1],
                                   mode="reflect"), E),
        "repeat_interleave": (lambda P, a: P.repeat_interleave(a.X, 2, 1),
                              E),
        "unbind": (lambda P, a: P.unbind(a.X3, 1), E),
        "unique": (lambda P, a: P.unique(a.U, return_index=True,
                                         return_inverse=True,
                                         return_counts=True), E),
        "unique_consecutive": (lambda P, a: P.unique_consecutive(
            a.U, return_inverse=True, return_counts=True), E),
        "as_complex": (lambda P, a: P.as_real(P.as_complex(a.CPLX)), E),
        "as_real": (lambda P, a: P.as_real(P.as_complex(a.CPLX)), E),
        "crop": (lambda P, a: P.crop(a.X3, [1, 3, 4], [1, 2, 3]), E),
        "crop_tensor": (lambda P, a: P.crop_tensor(a.X, [2, -1], [1, 1]),
                        E),
        "shard_index": (lambda P, a: P.shard_index(
            P.abs(a.I) * 2, 20, 2, 1), E),
        "tensordot": (lambda P, a: P.tensordot(a.X3, a.X, [[1, 2], [0, 1]]),
                      F),
        # logic and search
        "is_empty": (lambda P, a: P.is_empty(a.X), E),
        "is_tensor": (lambda P, a: P.to_tensor(P.is_tensor(a.X)), E),
        "where": (lambda P, a: P.where(a.B, a.X, a.Y), E),
        "cond": (lambda P, a: P.cond(P.greater_than(P.sum(a.X), 0.0),
                                     lambda: a.X, lambda: a.Y), E),
        "argmax": (lambda P, a: P.argmax(a.X, axis=1), E),
        "argmin": (lambda P, a: P.argmin(a.TIES, axis=1), E),
        "argsort": (lambda P, a: P.argsort(a.TIES, descending=True), E),
        "sort": (lambda P, a: P.sort(a.X, axis=0, descending=True), E),
        "topk": (lambda P, a: P.topk(a.TIES, 3), E),
        "kthvalue": (lambda P, a: P.kthvalue(a.TIES, 2), E),
        "mode": (lambda P, a: P.mode(a.MODES), E),
        "nonzero": (lambda P, a: P.nonzero(a.I), E),
        "masked_select": (lambda P, a: P.masked_select(a.X, a.B), E),
        "masked_fill": (lambda P, a: P.masked_fill(a.X, a.B, -7.0), E),
        "searchsorted": (lambda P, a: P.searchsorted(a.SORTED, a.X), E),
        "bucketize": (lambda P, a: P.bucketize(a.X, a.SORTED, right=True), E),
        "index_put": (lambda P, a: P.index_put(
            a.X, (a.IDX3, a.IDX3), a.V[:3], accumulate=True), F),
        # linear algebra
        "matmul": (lambda P, a: P.matmul(a.X, a.Y, transpose_y=True), L),
        "mm": (lambda P, a: P.mm(a.A, a.SPD), L),
        "bmm": (lambda P, a: P.bmm(a.X3, P.transpose(a.X3, [0, 2, 1])), L),
        "dot": (lambda P, a: P.dot(a.X, a.Y), L),
        "mv": (lambda P, a: P.mv(a.X, a.V), L),
        "addmm": (lambda P, a: P.addmm(a.A, a.A, a.SPD, 0.5, 2.0), L),
        "matmul_with_flatten": (lambda P, a: P.matmul_with_flatten(
            a.X3, P.transpose(a.X, [1, 0]), 2), L),
        "norm": (lambda P, a: P.norm(a.X, p=3, axis=1), L),
        "dist": (lambda P, a: P.dist(a.X, a.Y), L),
        "cross": (lambda P, a: P.cross(a.V3, a.U3), L),
        "cholesky": (lambda P, a: P.cholesky(a.SPD), L),
        "cholesky_solve": (lambda P, a: P.cholesky_solve(a.RHS, a.CHOL), L),
        "triangular_solve": (lambda P, a: P.triangular_solve(a.TRI, a.RHS),
                             L),
        "inverse": (lambda P, a: P.inverse(a.SPD), L),
        "pinv": (lambda P, a: P.pinv(a.TALL), L),
        "solve": (lambda P, a: P.solve(a.SPD, a.RHS), L),
        "lstsq": (lambda P, a: P.lstsq(a.TALL, a.Y10)[0], L),
        "det": (lambda P, a: P.det(a.SPD), (1e-4, 1e-3)),
        "slogdet": (lambda P, a: P.slogdet(a.A), L),
        "svd": (lambda P, a: P.svd(a.TALL)[1], L),
        "qr": (lambda P, a: P.abs(P.diag(P.qr(a.TALL)[1])), L),
        "eig": (lambda P, a: P.sort(P.abs(P.eig(a.A)[0])), L),
        "eigh": (lambda P, a: P.eigh(a.SPD)[0], L),
        "eigvals": (lambda P, a: P.sort(P.abs(P.eigvals(a.A))), L),
        "eigvalsh": (lambda P, a: P.eigvalsh(a.SPD), L),
        "matrix_rank": (lambda P, a: P.matrix_rank(a.A), E),
        "matrix_power": (lambda P, a: P.matrix_power(a.A, 3), L),
        "multi_dot": (lambda P, a: P.multi_dot([a.A, a.SPD, a.RHS]), L),
        "histogram": (lambda P, a: P.histogram(a.X, 8, -2, 2), E),
        "bincount": (lambda P, a: P.bincount(a.J[0]), E),
        "corrcoef": (lambda P, a: P.corrcoef(a.V3), L),
        "cov": (lambda P, a: P.cov(a.X), L),
        "einsum": (lambda P, a: P.einsum("bij,kj->bik", a.X3, a.X), L),
        # compat
        "cast": (lambda P, a: P.cast(a.X, "int32"), E),
        "rank": (lambda P, a: P.rank(a.X3), E),
        "shape": (lambda P, a: P.shape(a.X3), E),
        "has_inf": (lambda P, a: P.has_inf(a.NANS), E),
        "has_nan": (lambda P, a: P.has_nan(a.X), E),
        # a row-sparse gradient of rows ROWS[0] (duplicates summed)
        "get_tensor_from_selected_rows": (
            lambda P, a: P.get_tensor_from_selected_rows(
                P.sparse_grad.IndexedSlices(a.ROWS._value[0].long(),
                                            a.X._value[:4], (16, 16))), F),
        "tanh_": (lambda P, a: P.tanh_(a.X.clone()), F),
    })
    return calls


EAGER_RANDOM = {
    "rand": lambda P, a: P.rand([EAGER_RANDOM_N]),
    "randn": lambda P, a: P.randn([EAGER_RANDOM_N]),
    "standard_normal": lambda P, a: P.standard_normal([EAGER_RANDOM_N]),
    "uniform": lambda P, a: P.uniform([EAGER_RANDOM_N], min=-2.0, max=5.0),
    "normal": lambda P, a: P.normal(1.5, 0.5, [EAGER_RANDOM_N]),
    "randint": lambda P, a: P.randint(-3, 9, [EAGER_RANDOM_N]),
    "randint_like": lambda P, a: P.randint_like(a.Z, 0, 10),
    "randperm": lambda P, a: P.randperm(EAGER_RANDOM_N),
    "multinomial": lambda P, a: P.multinomial(a.PROBS, EAGER_RANDOM_N,
                                              replacement=True),
    "bernoulli": lambda P, a: P.bernoulli(a.P),
    "poisson": lambda P, a: P.poisson(a.LAM),
    "uniform_": lambda P, a: P.uniform_(a.Z.clone(), -1.0, 3.0),
    "normal_": lambda P, a: P.normal_(a.Z.clone(), 2.0, 3.0),
    "exponential_": lambda P, a: P.exponential_(a.Z.clone(), 2.0),
}


def _eager_numpy(out):
    if isinstance(out, (tuple, list)):
        return [_eager_numpy(o) for o in out]
    v = getattr(out, "_value", out)
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        return (v.float() if v.dtype == torch.bfloat16 else v).numpy()
    return np.asarray(v)


def _eager_close(name, got, want, tol):
    """The card's result against the CPU's: the same structure, shapes
    and dtypes; equal values, or within ``tol = (rtol, atol)``."""
    if isinstance(want, list):
        if not isinstance(got, list) or len(got) != len(want):
            raise AssertionError(f"eager_api/{name}: structure differs")
        return max([_eager_close(name, g, w, tol)
                    for g, w in zip(got, want)] + [0.0])
    g, w = np.asarray(got), np.asarray(want)
    if g.shape != w.shape or g.dtype != w.dtype:
        raise AssertionError(f"eager_api/{name}: {g.shape} {g.dtype} on the "
                             f"card, {w.shape} {w.dtype} on the CPU")
    if tol == EAGER_EXACT:
        if not np.array_equal(g, w, equal_nan=g.dtype.kind in "fc"):
            raise AssertionError(f"eager_api/{name}: not equal to the CPU")
        return 0.0
    np.testing.assert_allclose(g, w, rtol=tol[0], atol=tol[1],
                               equal_nan=True, err_msg=f"eager_api/{name}")
    diff = np.abs(g.astype(np.complex128) - w.astype(np.complex128))
    return float(np.nanmax(np.where(np.isfinite(diff), diff, 0.0))
                 if diff.size else 0.0)


def _synced(fn):
    """``fn()`` and the number of times it synchronised the host with the
    card (``torch.cuda.set_sync_debug_mode("warn")``'s warnings, one a
    sync)."""
    import warnings

    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in seen)


def eager_mlp(P, device, arrays, clear_grad):
    """The 3-layer MLP regression in the top-level API only: the
    weights and data (made by ``paddle.randn`` on the card) moved to
    ``device``, 20 steps of ``opt.minimize(loss)`` with or without
    ``clear_grad``; returns (losses, the model's state_dict)."""
    P.set_device(device)
    t = {k: P.to_tensor(v, place=device) for k, v in arrays.items()}
    w1 = P.create_parameter([16, 32], "float32")
    w1.set_value(t["w1"])
    lin = P.nn.Linear(32, 32, weight_attr=P.ParamAttr(
        learning_rate=0.5, regularizer=P.regularizer.L2Decay(1e-3)))
    lin.weight.set_value(t["w2"])
    lin.bias.set_value(t["b2"])
    w3 = P.create_parameter([32, 4], "float32",
                            attr=P.ParamAttr(need_clip=False))
    w3.set_value(t["w3"])
    params = [w1] + lin.parameters() + [w3]
    opt = P.optimizer.Momentum(0.02, 0.9, parameters=params,
                               grad_clip=P.nn.ClipGradByGlobalNorm(1.0))
    losses = []
    for _ in range(EAGER_MLP_STEPS):
        h = P.tanh(P.matmul(t["x"], w1))
        h = P.tanh(lin(h))
        err = P.matmul(h, w3) - t["y"]
        loss = P.mean(err * err)
        opt.minimize(loss)
        if clear_grad:
            opt.clear_grad()
        losses.append(float(loss))
    state = {"w1": w1, "w3": w3, **{f"lin.{k}": v for k, v in
                                    lin.state_dict().items()}}
    return losses, state


def _host_us(fn, n=EAGER_HOST_CALLS):
    """Median host microseconds of one call (no sync: the dispatch)."""
    for _ in range(20):
        fn()
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return float(np.median(ts) * 1e6)


# exported names that are no tensor op (types, state and print helpers)
EAGER_NOT_OPS = ("VarBase", "LoDTensor", "LoDTensorArray", "flops",
                 "get_cuda_rng_state", "set_cuda_rng_state",
                 "get_cudnn_version", "set_printoptions",
                 "monkey_patch_math_varbase", "monkey_patch_variable",
                 "enable_dygraph", "disable_dygraph", "in_dygraph_mode")


def eager_op_names():
    """Every op name the slice exports at the top level."""
    from paddle_tpu_torch import compat
    from paddle_tpu_torch.ops import (creation, linalg, logic, manipulation,
                                      math as ops_math, random_ops, search)

    names = set()
    for mod in (creation, ops_math, manipulation, logic, search, linalg,
                random_ops, compat):
        names |= set(mod.__all__)
    return names - set(EAGER_NOT_OPS)


def eager_api_phase() -> dict:
    """Phase 36: ``import paddle_tpu_torch as paddle`` on the card."""
    import tempfile

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.framework import place
    from paddle_tpu_torch.ops.quantized_matmul import (QMM_ROUTE_STATS,
                                                       quantized_matmul_ref)

    t_phase = time.perf_counter()
    prev = place._DEFAULT["device"]
    place._DEFAULT["device"] = None                 # the default: the card
    res = {}
    try:
        z = paddle.zeros([2, 3])
        if z.place.type != "cuda" or paddle.get_device() != "gpu:0":
            raise AssertionError(f"eager_api: default place {z.place}, "
                                 f"get_device {paddle.get_device()}")
        res["default_place"] = {"zeros_place": str(z.place),
                                "get_device": paddle.get_device()}
        arrays = eager_arrays()
        cpu_in = _EagerInputs(paddle, arrays, "cpu")
        gpu_in = _EagerInputs(paddle, arrays, "gpu")
        torch.cuda.synchronize()
        calls = _eager_calls()
        uncovered = eager_op_names() - set(calls) - set(EAGER_RANDOM) - {
            "weight_only_matmul"}
        if uncovered:
            raise AssertionError(f"eager_api: no card call for "
                                 f"{sorted(uncovered)}")
        synced, errs = [], {}
        # the first switch of the sync debug mode warns by itself
        _synced(lambda: None)
        for name, (call, tol) in sorted(calls.items()):
            paddle.set_device("gpu")
            # a first call loads its kernels' modules and the libraries'
            # handles (a one-time sync); the second is the one read
            call(paddle, gpu_in)
            out, sync = _synced(lambda: call(paddle, gpu_in))
            got = _eager_numpy(out)
            paddle.set_device("cpu")
            want = _eager_numpy(call(paddle, cpu_in))
            errs[name] = _eager_close(name, got, want, tol)
            if sync:
                synced.append(name)
        random_stats = {}
        for name, call in sorted(EAGER_RANDOM.items()):
            paddle.set_device("gpu")
            call(paddle, gpu_in)
            paddle.seed(36)
            out, sync = _synced(lambda: call(paddle, gpu_in))
            got = _eager_numpy(out).astype(np.float64)
            paddle.set_device("cpu")
            paddle.seed(36)
            want = _eager_numpy(call(paddle, cpu_in)).astype(np.float64)
            se = want.std() / math.sqrt(want.size)
            if (got.shape != want.shape
                    or abs(got.mean() - want.mean()) > 5 * math.sqrt(2) * se
                    + 1e-6 or abs(got.std() - want.std())
                    > 0.03 * want.std() + 1e-6):
                raise AssertionError(
                    f"eager_api/{name}: card mean {got.mean()} std "
                    f"{got.std()} against the CPU's {want.mean()} "
                    f"{want.std()}")
            random_stats[name] = {"mean": got.mean(), "cpu_mean": want.mean(),
                                  "std": got.std(), "cpu_std": want.std()}
            if sync:
                synced.append(name)
        res.update(ops_compared=len(errs) + len(random_stats),
                   max_abs_err=errs, random=random_stats,
                   synced=sorted(synced), n_synced=len(synced))
        paddle.set_device("gpu")

        # weight_only_matmul at GPT-2-small's fc1: kernel #4, never plain
        r = np.random.RandomState(4)
        wq = torch.as_tensor(r.randint(-127, 128, (768, 3072)).astype(
            np.int8), device="cuda")
        ws = torch.as_tensor(r.uniform(0.001, 0.02, (3072,)).astype(
            np.float32), device="cuda")
        x32 = torch.as_tensor(r.uniform(-1, 1, (8, 768)).astype(np.float32),
                              device="cuda")
        qmm = {}
        for key in QMM_ROUTE_STATS:
            QMM_ROUTE_STATS[key] = 0
        for dtype in (torch.float32, torch.bfloat16):
            x = x32.to(dtype)
            out = paddle.weight_only_matmul(paddle.Tensor(x),
                                            paddle.Tensor(wq),
                                            paddle.Tensor(ws))
            torch.cuda.synchronize()
            ref = quantized_matmul_ref(x, wq, ws)
            err = float((out._value.float() - ref.float()).abs().max())
            if err > QMM_TOL[dtype] or out.dtype != dtype:
                raise AssertionError(f"eager_api/weight_only_matmul {dtype}:"
                                     f" max abs err {err}")
            qmm[str(dtype)] = {"max_abs_err": err}
        launches = dict(QMM_ROUTE_STATS)
        if launches != {"cuda": 2, "ref": 0}:
            raise AssertionError(f"eager_api/weight_only_matmul: launches "
                                 f"{launches}")
        res["weight_only_matmul"] = {"shape": "x [8, 768], w [768, 3072]",
                                     **qmm, "launches": launches}

        # the MLP in the top-level API, with and without clear_grad
        paddle.seed(21)
        init = {"x": paddle.randn([64, 16]), "y": paddle.randn([64, 4]),
                "w1": paddle.randn([16, 32]) * 0.3,
                "w2": paddle.randn([32, 32]) * 0.2,
                "b2": paddle.zeros([32]), "w3": paddle.randn([32, 4]) * 0.3}
        init = {k: v.numpy() for k, v in init.items()}
        mlp = {}
        for clear in (True, False):
            arm = "clear_grad" if clear else "no_clear_grad"
            card, state = eager_mlp(paddle, "gpu", init, clear)
            cpu, _ = eager_mlp(paddle, "cpu", init, clear)
            paddle.set_device("gpu")
            rel = max(abs(a - b) / max(abs(b), 1e-12)
                      for a, b in zip(card, cpu))
            # without clear_grad the gradients accumulate (M1), so only
            # the arm that clears them is held to a falling loss
            if rel > EAGER_MLP_RTOL or (clear and not card[-1] < card[0]):
                raise AssertionError(f"eager_api/mlp/{arm}: losses {card} "
                                     f"against the CPU's {cpu}")
            mlp[arm] = {"first_loss": card[0], "last_loss": card[-1],
                        "max_rel_diff_to_cpu": rel}
            if clear:
                with tempfile.TemporaryDirectory() as d:
                    path = os.path.join(d, "mlp.pdparams")
                    paddle.save(state, path)
                    back = paddle.load(path)
                same = all(
                    back[k].place.type == "cuda" and torch.equal(
                        back[k]._value, v._value) for k, v in state.items())
                if not same:
                    raise AssertionError("eager_api: load is not bit-exact "
                                         "on the card")
                mlp["save_load_bit_exact_on_card"] = same
        res["mlp"] = mlp

        # the dispatch layer's host cost beside torch's own call
        a, b = paddle.randn([1024]), paddle.randn([1024])
        m = paddle.randn([64, 64])
        av, bv, mv = a._value, b._value, m._value
        res["host_us_per_call"] = {
            "paddle.add[1024]": _host_us(lambda: paddle.add(a, b)),
            "torch.add[1024]": _host_us(lambda: torch.add(av, bv)),
            "paddle.matmul[64,64]": _host_us(lambda: paddle.matmul(m, m)),
            "torch.matmul[64,64]": _host_us(lambda: torch.matmul(mv, mv)),
            "calls": EAGER_HOST_CALLS, "clock": "host, median"}
    finally:
        place._DEFAULT["device"] = prev
    res["seconds"] = time.perf_counter() - t_phase
    log("eager_api", **res)
    return res


# --------------------------------------------------------------------------
# phase 37: the rest of the eager nn surface
# --------------------------------------------------------------------------
NN_VOCAB, NN_DIM, NN_B, NN_S = 50257, 768, 8, 1024
NN_STEPS = 10
NN_EXACT = "exact"
NN_F32 = (1e-6, 1e-6)
NN_ALIGN = (1e-5, 1e-5)
# a gradient that reduces a whole batch of products into each entry
NN_REDUCED = (1e-4, 1e-6)
NN_DENSE_GRAD_MB = NN_VOCAB * NN_DIM * 4 / 1e6


def nn_bag(P, device, table, head_w, head_b, sparse):
    """Embedding(50257, 768) -> mean over S -> Linear(768, 2), the
    weights copied in on ``device``."""
    P.set_device(device)

    class Bag(P.nn.Layer):
        def __init__(self):
            super().__init__()
            self.emb = P.nn.Embedding(NN_VOCAB, NN_DIM, sparse=sparse)
            self.head = P.nn.Linear(NN_DIM, 2)

        def forward(self, ids):
            return self.head(self.emb(ids).mean(axis=1))

    net = Bag()
    net.emb.weight.set_value(table)
    net.head.weight.set_value(head_w)
    net.head.bias.set_value(head_b)
    return net


def nn_zipf_batch():
    r = np.random.RandomState(37)
    ids = np.minimum(r.zipf(1.1, (NN_B, NN_S)), NN_VOCAB) - 1
    return ids.astype(np.int64), r.randint(0, 2, (NN_B,)).astype(np.int64)


def nn_train(P, device, init, sparse, ids, y, probe=None):
    """10 steps of ``Adam(lazy_mode=True)``; returns the losses, the
    final table, each step's host ms (after a sync), and what ``probe``
    saw at step 1 (before the update)."""
    net = nn_bag(P, device, *init, sparse=sparse)
    opt = P.optimizer.Adam(1e-3, parameters=net.parameters(),
                           lazy_mode=True)
    loss_fn = P.nn.CrossEntropyLoss()
    tid, ty = P.to_tensor(ids, place=device), P.to_tensor(y, place=device)
    losses, ms, seen = [], [], None
    for i in range(NN_STEPS):
        if device != "cpu":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = loss_fn(net(tid), ty)
        loss.backward()
        if i == 0 and probe is not None:
            seen = probe(net)
        opt.step()
        opt.clear_grad()
        if device != "cpu":
            torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
        if i == 0 and probe is not None:
            seen["table_after_1"] = net.emb.weight.numpy()
    return losses, net.emb.weight.numpy(), ms, seen


def nn_step_peak(P, init, sparse, ids, y):
    """Peak device bytes of one training step after a warm one (the
    accumulators made), and whether the step synchronised the host."""
    net = nn_bag(P, "gpu", *init, sparse=sparse)
    opt = P.optimizer.Adam(1e-3, parameters=net.parameters(),
                           lazy_mode=True)
    loss_fn = P.nn.CrossEntropyLoss()
    tid, ty = P.to_tensor(ids, place="gpu"), P.to_tensor(y, place="gpu")

    def step():
        loss = loss_fn(net(tid), ty)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    step()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _, sync = _synced(step)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    del net, opt
    return {"peak_mb": peak / 1e6, "over_resident_mb": (peak - base) / 1e6,
            "synced": sync > 0}


def nn_sparse_embedding(P) -> dict:
    """The sparse arm against the dense arm and its own CPU run."""
    g = torch.Generator().manual_seed(37)
    table = (torch.randn(NN_VOCAB, NN_DIM, generator=g) * 0.02).numpy()
    head_w = (torch.randn(NN_DIM, 2, generator=g) * 0.05).numpy()
    head_b = np.zeros((2,), np.float32)
    init = (table, head_w, head_b)
    ids, y = nn_zipf_batch()
    touched = np.unique(ids)
    untouched = np.setdiff1d(np.arange(NN_VOCAB), touched)

    def probe_sparse(net):
        g = net.emb.weight.grad
        if not isinstance(g, P.sparse_grad.IndexedSlices) \
                or g.values.shape[0] != NN_B * NN_S:
            raise AssertionError(f"eager_nn: the sparse gradient is {g!r}")
        # each entry's summed magnitude, in f64: the scale of the
        # rounding of a sum of its terms in any order
        mag = torch.zeros(g.dense_shape, dtype=torch.float64).index_add_(
            0, g.rows.cpu(), g.values.detach().cpu().double().abs())
        return {"grad": P.get_tensor_from_selected_rows(g).numpy(),
                "n_rows": int(g.values.shape[0]), "magnitude": mag.numpy()}

    def probe_dense(net):
        return {"grad": net.emb.weight.grad.numpy()}

    s_loss, s_table, s_ms, s_seen = nn_train(P, "gpu", init, True, ids, y,
                                             probe_sparse)
    d_loss, _, d_ms, d_seen = nn_train(P, "gpu", init, False, ids, y,
                                       probe_dense)
    c_loss, c_table, _, _ = nn_train(P, "cpu", init, True, ids, y)
    P.set_device("gpu")
    res = {"ids": f"[{NN_B}, {NN_S}] Zipf(1.1) over {NN_VOCAB}",
           "distinct_ids": int(touched.size), "grad_rows": s_seen["n_rows"]}
    # step 1: the touched rows as the dense arm's, the others untouched
    s1 = s_seen["table_after_1"]
    d1 = d_seen["table_after_1"]
    np.testing.assert_allclose(s1[touched], d1[touched], rtol=1e-5,
                               atol=1e-7, err_msg="eager_nn: step 1 rows")
    if not np.array_equal(s1[untouched], table[untouched]):
        raise AssertionError("eager_nn: an untouched row moved")
    # the two sum each entry's n terms in another order: beside 1e-6
    # relative, the bound of recursive summation, 2 (n - 1) u sum|terms|
    n_terms = np.bincount(ids.ravel(), minlength=NN_VOCAB)[:, None]
    bound = 2 * np.maximum(n_terms - 1, 0) * 2.0 ** -24 * s_seen["magnitude"]
    sg, dg = s_seen["grad"], d_seen["grad"]
    over = np.abs(sg - dg) > 1e-6 * np.abs(dg) + bound
    if over.any():
        raise AssertionError(
            f"eager_nn: get_tensor_from_selected_rows differs from the dense "
            f"gradient at {int(over.sum())} entries (max abs "
            f"{float(np.abs(sg - dg).max())})")
    np.testing.assert_allclose(s_loss, c_loss, rtol=1e-5,
                               err_msg="eager_nn: losses against the CPU")
    # beside 1e-5 relative, 1e-3 of the learning rate: an Adam step moves
    # an entry by at most lr, in the direction m / sqrt(v), which turns
    # with the gradient's summation order where a gradient cancels to
    # near zero (2.4e-7 at 20 of 38.6M entries on the card)
    np.testing.assert_allclose(s_table, c_table, rtol=1e-5, atol=1e-6,
                               err_msg="eager_nn: table against the CPU")
    if not s_loss[-1] < s_loss[0]:
        raise AssertionError(f"eager_nn: loss did not fall: {s_loss}")
    res.update(
        step1_max_abs_diff_to_dense=float(np.abs(
            s1[touched] - d1[touched]).max()),
        grad_max_abs_diff_to_dense=float(np.abs(sg - dg).max()),
        grad_max_rel_diff_to_dense=float(
            (np.abs(sg - dg) / np.maximum(np.abs(dg), 1e-30)).max()),
        grad_max_terms_an_entry=int(n_terms.max()),
        losses=s_loss, max_rel_loss_diff_to_cpu=max(
            abs(a - b) / abs(b) for a, b in zip(s_loss, c_loss)),
        table_max_abs_diff_to_cpu=float(np.abs(s_table - c_table).max()),
        dense_losses=d_loss,
        step_ms={"sparse_p50": float(np.median(s_ms)),
                 "dense_p50": float(np.median(d_ms)),
                 "clock": "host, after a sync, median of 10"})
    free_cuda()
    sparse_peak = nn_step_peak(P, init, True, ids, y)
    free_cuda()
    dense_peak = nn_step_peak(P, init, False, ids, y)
    free_cuda()
    saved = dense_peak["peak_mb"] - sparse_peak["peak_mb"]
    res["memory"] = {"sparse": sparse_peak, "dense": dense_peak,
                     "saved_mb": saved,
                     "dense_grad_mb": NN_DENSE_GRAD_MB}
    if saved < NN_DENSE_GRAD_MB:
        raise AssertionError(f"eager_nn: a sparse step saves {saved} MB, "
                             f"less than the dense gradient's "
                             f"{NN_DENSE_GRAD_MB}")
    res["sparse_step_synced"] = sparse_peak["synced"]
    return res


def _nn_functional_cases():
    """``{name: (call(F, *tensors), arrays, tol, grad_tol)}`` at the
    shapes users run them at."""
    r = np.random.RandomState(370)

    def u(*shape):
        return r.standard_normal(shape).astype(np.float32)

    fpn, img448 = u(8, 256, 64, 64), u(8, 3, 448, 448)
    img112, feat = u(8, 3, 112, 112), u(8, 64, 112, 112)
    x64, x56 = u(8, 64, 64, 64), u(8, 64, 56, 56)
    theta = (np.tile(np.array([[0.9, 0.1, 0.05], [-0.1, 0.9, -0.05]],
                              np.float32), (8, 1, 1))
             + 0.05 * u(8, 2, 3))
    cols = u(8, 64 * 9, 56 * 56)
    ids = r.randint(0, 1000, (8, 1024)).astype(np.int64)
    return {
        "interpolate_bilinear_x2": (
            lambda F, x: F.interpolate(x, scale_factor=2, mode="bilinear"),
            [fpn], NN_F32, NN_F32),
        "interpolate_bilinear_x2_align": (
            lambda F, x: F.interpolate(x, scale_factor=2, mode="bilinear",
                                       align_corners=True),
            [fpn], NN_ALIGN, NN_ALIGN),
        "interpolate_nearest_x2": (
            lambda F, x: F.interpolate(x, scale_factor=2), [fpn], NN_EXACT,
            NN_F32),
        "interpolate_bilinear_half": (
            lambda F, x: F.interpolate(x, size=[224, 224], mode="bilinear"),
            [img448], NN_F32, NN_F32),
        "interpolate_bicubic_x2": (
            lambda F, x: F.interpolate(x, scale_factor=2, mode="bicubic"),
            [img112], NN_F32, NN_F32),
        "pad_reflect": (lambda F, x: F.pad(x, [1, 1, 1, 1], "reflect"),
                        [feat], NN_EXACT, NN_F32),
        "pad_replicate": (lambda F, x: F.pad(x, [1, 1, 1, 1], "replicate"),
                          [feat], NN_EXACT, NN_F32),
        "pad_circular": (lambda F, x: F.pad(x, [1, 1, 1, 1], "circular"),
                         [feat], NN_EXACT, NN_F32),
        "pixel_shuffle": (lambda F, x: F.pixel_shuffle(x, 2), [fpn],
                          NN_EXACT, NN_EXACT),
        "pixel_unshuffle": (
            lambda F, x: F.pixel_unshuffle(F.pixel_shuffle(x, 2), 2), [fpn],
            NN_EXACT, NN_EXACT),
        # theta's gradient sums 262,144 products an entry
        "affine_grid_grid_sample": (
            lambda F, x, t: F.grid_sample(
                x, F.affine_grid(t, [8, 64, 64, 64], align_corners=False),
                align_corners=False), [x64, theta], NN_F32,
            [NN_F32, NN_REDUCED]),
        "unfold_3x3": (lambda F, x: F.unfold(x, 3, paddings=1), [x56],
                       NN_EXACT, NN_F32),
        "fold_3x3": (lambda F, c: F.fold(c, [56, 56], 3, paddings=1),
                     [cols], NN_EXACT, NN_EXACT),
        "one_hot": (lambda F, i: F.one_hot(i, 1000), [ids], NN_EXACT,
                    NN_EXACT),
    }


def _nn_inputs(P, device, arrays):
    P.set_device(device)
    return [P.to_tensor(a, place=device, stop_gradient=a.dtype.kind != "f")
            for a in arrays]


def _nn_run(P, fn, xs):
    """The call's output and, for float inputs, the gradients of a fixed
    weighted sum of it (its weight made on the device, no host copy)."""
    out = fn(P.nn.functional, *xs)
    grads = []
    if not all(x.stop_gradient for x in xs):
        # integer arithmetic: the same weights on either device
        n = out.size
        w = ((torch.remainder(torch.arange(n, device=out.place), 7) - 3)
             .float() * 0.25).reshape(out.shape)
        (out * P.Tensor(w)).sum().backward()
        grads = [x.grad for x in xs if not x.stop_gradient]
    return [out] + grads


def _nn_close(name, got, want, tol):
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"eager_nn/{name}: {got.shape} {got.dtype} on "
                             f"the card, {want.shape} {want.dtype} on the "
                             "CPU")
    if tol == NN_EXACT:
        if not np.array_equal(got, want):
            raise AssertionError(f"eager_nn/{name}: not equal to the CPU")
    else:
        np.testing.assert_allclose(got, want, rtol=tol[0], atol=tol[1],
                                   err_msg=f"eager_nn/{name}")
    return float(np.abs(got.astype(np.float64) - want).max()) \
        if got.size else 0.0


def nn_functionals(P) -> dict:
    errs, synced, ms, failed = {}, [], {}, {}
    for name, (fn, arrays, tol, gtol) in sorted(
            _nn_functional_cases().items()):
        _nn_run(P, fn, _nn_inputs(P, "gpu", arrays))    # loads the kernels
        xs = _nn_inputs(P, "gpu", arrays)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs, sync = _synced(lambda: _nn_run(P, fn, xs))
        torch.cuda.synchronize()
        ms[name] = (time.perf_counter() - t0) * 1e3
        got = [o.numpy() for o in outs]
        want = [o.numpy() for o in _nn_run(P, fn, _nn_inputs(P, "cpu",
                                                             arrays))]
        tols = [tol] + (gtol if isinstance(gtol, list)
                        else [gtol] * (len(got) - 1))
        try:
            errs[name] = max(_nn_close(name, g, w, t)
                             for g, w, t in zip(got, want, tols))
        except AssertionError as e:
            failed[name] = str(e)[:400]
        if sync:
            synced.append(name)
        P.set_device("gpu")
        del xs, outs
        free_cuda()
    if failed:
        raise AssertionError(f"eager_nn: the card differs from the CPU: "
                             f"{failed}")
    return {"max_abs_err": errs, "synced": synced,
            "forward_backward_ms": ms,
            "clock": "host, forward + backward, after a sync, one call"}


def nn_tape(P) -> dict:
    a = P.to_tensor(np.array([1, 2, 3], np.int64), place="gpu")
    b = P.to_tensor(np.array([1, 0, 3], np.int64), place="gpu")
    cmp = {"eq": a == b, "ne": a != b, "lt": a < b, "le": a <= b,
           "gt": a > b, "ge": a >= b}
    want = {"eq": [True, False, True], "ne": [False, True, False],
            "lt": [False, False, False], "le": [True, False, True],
            "gt": [False, True, False], "ge": [True, True, True]}
    for k, t in cmp.items():
        if t.place.type != "cuda" or t.dtype != torch.bool \
                or t.numpy().tolist() != want[k]:
            raise AssertionError(f"eager_nn/tape: {k} gave {t!r}")
    x = P.to_tensor(np.array([1.0, 2.0], np.float32), place="gpu",
                    stop_gradient=False)
    y = x * 2
    z = y.exp()
    y.add_(y)
    try:
        z.sum().backward()
        raise AssertionError("eager_nn/tape: the in-place guard did not "
                             "raise")
    except RuntimeError as e:
        if "in-place" not in str(e):
            raise
    x.clear_grad()
    w = P.to_tensor(np.array([0.5, -1.5], np.float32), place="gpu",
                    stop_gradient=False)
    loss = ((x * w).exp() * w).sum()
    P.autograd.run_backward([loss], retain_graph=True)
    g1 = (x.grad.numpy(), w.grad.numpy())
    x.clear_grad()
    w.clear_grad()
    loss.backward()
    if not (np.array_equal(x.grad.numpy(), g1[0])
            and np.array_equal(w.grad.numpy(), g1[1])):
        raise AssertionError("eager_nn/tape: run_backward differs from "
                             "backward")
    return {"comparisons_on_card": sorted(cmp), "inplace_guard_raised": True,
            "run_backward_equals_backward": True}


def eager_nn_phase() -> dict:
    """Phase 37: the rest of the eager ``nn`` surface on the card."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.framework import place

    t_phase = time.perf_counter()
    prev = place._DEFAULT["device"]
    place._DEFAULT["device"] = None                 # the default: the card
    res = {}
    try:
        _synced(lambda: None)
        res["tape"] = nn_tape(paddle)
        res["sparse_embedding"] = nn_sparse_embedding(paddle)
        free_cuda()
        res["functionals"] = nn_functionals(paddle)
    finally:
        place._DEFAULT["device"] = prev
    res["seconds"] = time.perf_counter() - t_phase
    log("eager_nn", **res)
    return res


# --------------------------------------------------------------------------
# phase 38: the declarative half — to_static, jit.save + create_predictor,
# static Program / Executor, hapi's static adapter, dy2static control flow
# --------------------------------------------------------------------------
DECL_STEPS = 6
DECL_SERVE_BATCHES = (32, 8)        # the exported bucket, and a padded one
DECL_SERVE_REPS = 5
DECL_LENET_STEPS = 20
DECL_FIT_BATCHES = 4
# the served logits against the eager model's: the same flash (3xTF32)
# and cuBLAS kernels on the same inputs, so they are expected equal; held
# to 1e-4 of the logits' largest magnitude
DECL_SERVE_TOL = 1e-4
DECL_TRAIN_LAYERS = 2
DECL_TRAIN_BATCH = 4
DECL_TRAIN_STEPS = 3
# the reloaded train step against the Executor's replay: the same kernels
# (the recompute gives the forward's o and lse again), the make_fx graph's
# aten ops against the eager ones
DECL_TRAIN_RTOL = 1e-4

DECL_PREDICTOR = r'''
import json, os, sys, time
import numpy as np
import torch
sys.path.insert(0, sys.argv[1])
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
from paddle_tpu_torch import inference
from paddle_tpu_torch.ops.attention import ROUTE_STATS
from paddle_tpu_torch.ops.flash_attention import (FLASH_F32TC_STATS,
                                                  FLASH_ROUTE_STATS)
args = json.loads(sys.argv[2])
feeds = [np.load(os.path.join(args["dir"], f + ".npy"))
         for f in ("ids", "types", "mask")]
stats = (ROUTE_STATS, FLASH_ROUTE_STATS, FLASH_F32TC_STATS)
out = {"modules": sorted({m.split(".")[0] for m in sys.modules})}
for tag, prefix in args["artifacts"].items():
    p = inference.create_predictor(inference.Config(prefix))
    res = {}
    for n in args["batches"]:
        ms = []
        for s in stats:
            for k in s:
                s[k] = 0
        for _ in range(args["reps"]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            o, = p.run([f[:n] for f in feeds])
            ms.append((time.perf_counter() - t0) * 1e3)
        np.save(os.path.join(args["dir"], f"{tag}_{n}.npy"), o)
        res[str(n)] = {"ms": ms, "route": dict(ROUTE_STATS),
                       "flash": dict(FLASH_ROUTE_STATS),
                       "flash_f32tc": dict(FLASH_F32TC_STATS)}
    out[tag] = res
cfg = inference.Config(args["artifacts"]["card_saved"])
cfg.disable_gpu()
n = args["batches"][-1]
o, = inference.create_predictor(cfg).run([f[:n] for f in feeds])
np.save(os.path.join(args["dir"], "card_saved_on_cpu.npy"), o)
print(json.dumps(out))
'''


def decl_control_flow(x):
    """Phase 38 (d): a tensor ``if`` and a tensor ``while`` that the
    dy2static pass converts."""
    if x.sum() > 0:
        y = x * 2.0
    else:
        y = -x
    while y.sum() < 100.0:
        y = y + 1.0
    return y


def decl_to_static_train(inputs, static) -> dict:
    """The bare bf16 autocast loop on a seeded bert-base
    ``BertForSequenceClassification`` (``AdamW(5e-5)``, dropout as
    built, the draws from ``seed(1)``), the model wrapped by
    ``jit.to_static`` when ``static``: DECL_STEPS steps, each one's loss,
    host ms (synced) and flash launches."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import amp, jit, nn
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text.models import BertForSequenceClassification

    ids, mask, y = (pt.Tensor(t) for t in inputs)
    model = seeded(BertForSequenceClassification, num_classes=2)()
    if static:
        model = jit.to_static(model)
    opt = AdamW(5e-5, parameters=model.parameters())
    loss_fn = nn.CrossEntropyLoss()
    pt.seed(1)
    losses, ms, launches = [], [], []
    for _ in range(DECL_STEPS):
        reset_flash_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with amp.auto_cast(dtype="bfloat16"):
            loss = loss_fn(model(ids, None, mask), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        launches.append(read_flash_counts())
    res = {"losses": losses, **_steady(ms), "launches": launches}
    if static:
        res["signatures"] = len(model.forward.concrete_programs)
    del model, opt
    free_cuda()
    return res


def decl_serve(inputs) -> dict:
    """``jit.save`` of a seeded bert-base classifier in eval mode at an
    ``InputSpec`` of batch 32 (ids, token types, mask), once traced on
    the CPU and once on the card, then ``create_predictor`` on each in a
    fresh process (``DECL_PREDICTOR``: no model class, no JAX), batches
    of 32 and a padded 8, against the eager model on the card."""
    import tempfile

    import paddle_tpu_torch as pt
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.static import InputSpec
    from paddle_tpu_torch.text.models import BertForSequenceClassification

    ids, types, mask = inputs
    specs = [InputSpec([DECL_SERVE_BATCHES[0], BERT_SEQ], "int64", name=n)
             for n in ("input_ids", "token_type_ids", "attention_mask")]
    res = {}
    with tempfile.TemporaryDirectory() as d:
        def build():
            pt.seed(0)
            m = BertForSequenceClassification(num_classes=2)
            m.eval()
            return m

        model = _on_device("cpu", build)
        t0 = time.perf_counter()
        jit.save(model, os.path.join(d, "cpu_saved"), input_spec=specs)
        res["save_cpu_s"] = time.perf_counter() - t0
        model.to(DEVICE)
        t0 = time.perf_counter()
        jit.save(model, os.path.join(d, "card_saved"), input_spec=specs)
        res["save_card_s"] = time.perf_counter() - t0
        want = {}
        with torch.no_grad():
            for n in DECL_SERVE_BATCHES:
                want[n] = model(*(pt.Tensor(torch.from_numpy(a[:n]).to(
                    DEVICE)) for a in (ids, types, mask))).numpy()
        del model
        free_cuda()
        for name, a in (("ids", ids), ("types", types), ("mask", mask)):
            np.save(os.path.join(d, name + ".npy"), a)
        arg = json.dumps({"dir": d, "batches": list(DECL_SERVE_BATCHES),
                          "reps": DECL_SERVE_REPS, "artifacts": {
                              t: os.path.join(d, t)
                              for t in ("cpu_saved", "card_saved")}})
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", DECL_PREDICTOR,
             os.path.dirname(os.path.abspath(__file__)), arg],
            capture_output=True, text=True, timeout=600)
        res["subprocess_s"] = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"declarative: the predictor process "
                                 f"failed: {proc.stderr[-3000:]}")
        sub = json.loads(proc.stdout.strip().splitlines()[-1])
        res["foreign_modules"] = [m for m in sub.pop("modules")
                                  if m in ("jax", "jaxlib", "paddle_tpu")]
        for tag, runs in sub.items():
            for n in DECL_SERVE_BATCHES:
                r = runs[str(n)]
                got = np.load(os.path.join(d, f"{tag}_{n}.npy"))
                err = float(np.max(np.abs(got - want[n])))
                res[f"{tag}/{n}"] = {
                    "shape": list(got.shape), "max_abs_err": err,
                    "scale": float(np.max(np.abs(want[n]))),
                    "latency_ms_p50": float(np.percentile(r["ms"][1:], 50)),
                    "latency_ms": r["ms"], "route": r["route"],
                    "flash": r["flash"], "flash_f32tc": r["flash_f32tc"]}
        n = DECL_SERVE_BATCHES[-1]
        got = np.load(os.path.join(d, "card_saved_on_cpu.npy"))
        res["card_saved_on_cpu"] = {
            "batch": n, "max_abs_err": float(np.max(np.abs(got - want[n])))}
    return res


def decl_static_lenet() -> dict:
    """Static-mode LeNet: a Program (``Adam(1e-3)`` minimize) built on
    the card and run DECL_LENET_STEPS steps through ``Executor`` on the
    synthetic MNIST batches of LENET_BATCH, the first LENET_PARITY_STEPS
    losses against the same Program on the CPU from the same weights;
    then hapi's static adapter: ``Model.fit`` (``enable_static``) over
    DECL_FIT_BATCHES batches and ``evaluate`` on the card and the
    CPU."""
    import paddle_tpu_torch as pt
    import paddle_tpu_torch.nn.functional as F
    from paddle_tpu_torch import optimizer, static
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.nn.layer import state_from_numpy
    from paddle_tpu_torch.vision.datasets import MNIST
    from paddle_tpu_torch.vision.models import LeNet

    ds = MNIST(mode="train")
    batches = [ds.batch(i * LENET_BATCH, LENET_BATCH)
               for i in range(DECL_LENET_STEPS)]
    pt.seed(0)
    state = {k: v.numpy() for k, v in
             _on_device("cpu", LeNet).state_dict().items()}

    def program_run(device, n):
        def build():
            main = static.Program()
            with static.program_guard(main):
                x = static.data("x", [LENET_BATCH, 1, 28, 28], "float32")
                y = static.data("y", [LENET_BATCH, 1], "int64")
                net = LeNet()
                net.set_state_dict(state_from_numpy(state, device))
                loss = F.cross_entropy(net(x), y)
                optimizer.Adam(1e-3,
                               parameters=net.parameters()).minimize(loss)
            return main, loss

        main, loss = _on_device(device, build)
        exe = static.Executor(device)
        losses, ms = [], []
        for x, y in batches[:n]:
            t0 = time.perf_counter()
            losses.append(float(exe.run(main, feed={"x": x, "y": y},
                                        fetch_list=[loss])[0]))
            ms.append((time.perf_counter() - t0) * 1e3)
        return losses, ms

    def fit_run(device):
        def run():
            pt.enable_static()
            try:
                net = LeNet()
                net.set_state_dict(state_from_numpy(state, device))
                model = Model(
                    net, [static.InputSpec([None, 1, 28, 28], "float32",
                                           "img")],
                    [static.InputSpec([None, 1], "int64", "lbl")])
                model.prepare(optimizer.Adam(1e-3,
                                             parameters=net.parameters()),
                              loss=F.cross_entropy)
                model.fit(MNIST(mode="train"), batch_size=LENET_BATCH,
                          epochs=1, num_iters=DECL_FIT_BATCHES,
                          shuffle=False, verbose=0)
                logs = model.evaluate(MNIST(mode="test"),
                                      batch_size=LENET_BATCH, num_iters=2,
                                      verbose=0)
                return float(np.asarray(logs["loss"]).ravel()[0]), \
                    model._adapter._exe._device.type
            finally:
                pt.disable_static()

        return _on_device(device, run)

    losses, ms = program_run(DEVICE, DECL_LENET_STEPS)
    cpu_losses, _ = program_run("cpu", LENET_PARITY_STEPS)
    rel = float(np.max(np.abs(np.subtract(losses[:LENET_PARITY_STEPS],
                                          cpu_losses))
                       / np.abs(cpu_losses)))
    fit_loss, fit_dev = fit_run(DEVICE)
    fit_cpu_loss, _ = fit_run("cpu")
    return {"losses": losses, "cpu_losses": cpu_losses,
            "max_rel_diff_vs_cpu": rel, "step_ms_p50": float(
                np.percentile(ms[1:], 50)), "first_step_ms": ms[0],
            "fit_eval_loss": fit_loss, "fit_eval_loss_cpu": fit_cpu_loss,
            "fit_device": fit_dev}


def decl_saved_ops() -> dict:
    """Phase 38 (e): the kernel entries as operators in saved programs
    (module docstring)."""
    import tempfile

    import paddle_tpu_torch as pt
    import paddle_tpu_torch.nn.functional as F
    from paddle_tpu_torch import jit, nn, optimizer, static
    from paddle_tpu_torch.ops import quantized_matmul as qmm
    from paddle_tpu_torch.ops import scale_shift as ss
    from paddle_tpu_torch.text.models import BertForSequenceClassification
    from paddle_tpu_torch.utils import register_op

    class QuantLayer(nn.Layer):
        def __init__(self):
            super().__init__()
            rng = np.random.RandomState(0)
            self.fc = nn.Linear(768, 768)
            self.register_buffer("wq", pt.to_tensor(
                rng.randint(-127, 128, (768, 3072)).astype(np.int8)))
            self.register_buffer("ws", pt.to_tensor(
                (rng.rand(3072) * 0.01).astype(np.float32)))
            self.register_buffer("scale", pt.to_tensor(np.float32([1.5])))
            self.register_buffer("shift", pt.to_tensor(np.float32([0.25])))
            self.op = register_op("decl_scale_shift", ss.scale_shift,
                                  vjp=ss.scale_shift_vjp, exist_ok=True)

        def forward(self, x):
            h = pt.weight_only_matmul(self.fc(x), self.wq, self.ws)
            return self.op(h, self.scale, self.shift)

    res = {}
    x = np.random.RandomState(1).randn(8, 128, 768).astype(np.float32)
    with tempfile.TemporaryDirectory() as d:
        def save_on_cpu():
            pt.seed(0)
            layer = QuantLayer()
            layer.eval()
            jit.save(layer, os.path.join(d, "quant"), input_spec=[
                static.InputSpec(list(x.shape), "float32")])
            return layer(pt.to_tensor(x)).numpy()

        want = _on_device("cpu", save_on_cpu)
        loaded = jit.load(os.path.join(d, "quant"), device=DEVICE)
        targets = [str(n.target) for n in loaded.program().graph.nodes]
        stats = (qmm.QMM_ROUTE_STATS, ss.SCALE_SHIFT_ROUTE_STATS)
        for st in stats:
            for k in st:
                st[k] = 0
        got = loaded(x).numpy()
        res["quant_artifact"] = {
            "ops": sorted({t for t in targets if "paddle_tpu_torch" in t}),
            "qmm": dict(stats[0]), "scale_shift": dict(stats[1]),
            "max_abs_err": float(np.max(np.abs(got - want))),
            "scale": float(np.max(np.abs(want)))}

        B, S, L = DECL_TRAIN_BATCH, BERT_SEQ, DECL_TRAIN_LAYERS
        rng = np.random.RandomState(2)
        feeds = [{"ids": rng.randint(0, 30522, (B, S)).astype(np.int64),
                  "labels": rng.randint(0, 2, (B,)).astype(np.int64)}
                 for _ in range(DECL_TRAIN_STEPS + 1)]
        pt.seed(0)
        main = static.Program()
        with static.program_guard(main):
            ids = static.data("ids", [B, S], "int64")
            labels = static.data("labels", [B], "int64")
            net = BertForSequenceClassification(
                num_classes=2, num_hidden_layers=L, dropout=0.0,
                hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
            loss = F.cross_entropy(net(ids), labels)
            optimizer.Adam(1e-4, parameters=net.parameters()).minimize(loss)
        exe = static.Executor(DEVICE)
        exe.run(main, feed=feeds[0], fetch_list=[loss])
        t0 = time.perf_counter()
        main.save_train(os.path.join(d, "bert"), fetch_list=[loss])
        res["save_train_s"] = time.perf_counter() - t0
        trained = static.load_train_program(os.path.join(d, "bert"),
                                            device=DEVICE)
        want_l, got_l, launches = [], [], []
        for fd in feeds[1:]:
            want_l.append(float(exe.run(main, feed=fd,
                                        fetch_list=[loss])[0]))
            reset_flash_counts()
            got_l.append(float(trained.run(fd)[0]))
            launches.append(read_flash_counts())
        res["train_program"] = {"layers": L, "batch": B, "seq": S,
                                "losses": got_l, "executor_losses": want_l,
                                "launches": launches}
    del exe, main, trained
    free_cuda()
    return res


def declarative_phase() -> dict:
    """Phase 38: the declarative half on the card (module docstring)."""
    import paddle_tpu_torch as pt

    from paddle_tpu_torch.framework import place

    t_phase = time.perf_counter()
    prev = place._DEFAULT["device"]
    pt.set_device(DEVICE)
    try:
        res = _declarative_runs(t_phase)
    finally:
        place._DEFAULT["device"] = prev
    log("declarative", **res)
    _check_declarative(res)
    return res


def _declarative_runs(t_phase) -> dict:
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.profiler.jit_cost import compile_ledger

    rng = np.random.RandomState(0)
    ids, mask, y = bert_inputs(rng, BERT_BATCH)
    inputs = tuple(torch.from_numpy(a).to(DEVICE) for a in (ids, mask, y))
    before = compile_ledger.total("jit/to_static")
    eager = decl_to_static_train(inputs, False)
    conv = decl_to_static_train(inputs, True)
    layers = 12
    want = {"flash_fwd": layers, "flash_dkv": layers, "flash_dq": layers,
            "flash_tc_fwd": layers, "flash_tc_dkv": layers,
            "flash_tc_dq": layers, "flash_ref": 0, "route_pallas": layers,
            "route_xla": 0}
    for tag, run in (("eager", eager), ("to_static", conv)):
        for step, counts in enumerate(run["launches"]):
            expect_counts(f"declarative/{tag}/step{step}", counts, want)
    train = {"eager": eager, "to_static": conv,
             "bit_equal_losses": eager["losses"] == conv["losses"],
             "to_static_compiles": compile_ledger.total("jit/to_static")
             - before}

    types = np.zeros_like(ids)
    serve = decl_serve((ids, types, mask))
    lenet = decl_static_lenet()
    saved_ops = decl_saved_ops()

    xs = [np.asarray(v, np.float32) for v in
          ([1.0, 2.0, 3.0], [-4.0, 1.0, -2.0], [50.0, 60.0, 1.0])]
    f = jit.to_static(decl_control_flow)
    card = [f(pt.to_tensor(x)).numpy() for x in xs]
    cpu = _on_device("cpu", lambda: [f(pt.to_tensor(x)).numpy()
                                     for x in xs])
    flow = {"card": [c.tolist() for c in card],
            "equal_cpu": all(np.array_equal(a, b)
                             for a, b in zip(card, cpu))}
    return {"batch": BERT_BATCH, "seq": BERT_SEQ, "layers": layers,
            "to_static_train": train, "serve": serve, "static_lenet": lenet,
            "control_flow": flow, "saved_ops": saved_ops,
            "seconds": time.perf_counter() - t_phase}


def _check_declarative(res):
    layers = res["layers"]
    train, serve = res["to_static_train"], res["serve"]
    lenet, flow = res["static_lenet"], res["control_flow"]
    eager, conv = train["eager"], train["to_static"]
    if not all(math.isfinite(v) for v in eager["losses"] + conv["losses"]):
        raise AssertionError("declarative: non-finite to_static losses")
    if not close_losses(conv["losses"], eager["losses"], BERT_LOSS_RTOL):
        raise AssertionError(f"declarative: to_static losses "
                             f"{conv['losses']} vs eager {eager['losses']}")
    if conv["signatures"] != 1 or train["to_static_compiles"] != 1:
        raise AssertionError(f"declarative: to_static made "
                             f"{conv['signatures']} signatures")
    if serve["foreign_modules"]:
        raise AssertionError(f"declarative: the predictor process imported "
                             f"{serve['foreign_modules']}")
    for tag in ("cpu_saved", "card_saved"):
        for n in DECL_SERVE_BATCHES:
            r = serve[f"{tag}/{n}"]
            calls = DECL_SERVE_REPS
            if r["flash"]["fwd"] != layers * calls or r["flash"]["ref"] \
                    or r["route"]["xla"] or r["flash_f32tc"]["fwd"] \
                    != layers * calls:
                raise AssertionError(f"declarative: {tag} batch {n} did not "
                                     f"launch #5 at every layer: {r}")
            if r["shape"] != [n, 2] or not r["max_abs_err"] <= \
                    DECL_SERVE_TOL * max(1.0, r["scale"]):
                raise AssertionError(f"declarative: {tag} batch {n} served "
                                     f"{r} against the eager model")
    if not serve["card_saved_on_cpu"]["max_abs_err"] <= 1e-3:
        raise AssertionError(f"declarative: the card-saved artifact on the "
                             f"CPU: {serve['card_saved_on_cpu']}")
    if not lenet["max_rel_diff_vs_cpu"] <= TRAIN_CPU_RTOL or not \
            np.mean(lenet["losses"][-5:]) < np.mean(lenet["losses"][:5]):
        raise AssertionError(f"declarative: static LeNet {lenet}")
    if lenet["fit_device"] != "cuda" or not abs(
            lenet["fit_eval_loss"] - lenet["fit_eval_loss_cpu"]) <= \
            TRAIN_CPU_RTOL * abs(lenet["fit_eval_loss_cpu"]):
        raise AssertionError(f"declarative: hapi static fit {lenet}")
    if not flow["equal_cpu"]:
        raise AssertionError(f"declarative: converted control flow {flow}")
    quant = res["saved_ops"]["quant_artifact"]
    if quant["qmm"] != {"cuda": 1, "ref": 0} or \
            quant["scale_shift"] != {"cuda": 1, "ref": 0} or not \
            quant["max_abs_err"] <= 1e-3 * max(1.0, quant["scale"]):
        raise AssertionError(f"declarative: the CPU-saved artifact did not "
                             f"run #4 and t on the card: {quant}")
    tp = res["saved_ops"]["train_program"]
    L = tp["layers"]
    for step, counts in enumerate(tp["launches"]):
        expect_counts(f"declarative/train_program/step{step}", counts, {
            "flash_fwd": 2 * L, "flash_dkv": L, "flash_dq": L,
            "flash_f32tc_fwd": 2 * L, "flash_ref": 0, "route_pallas": L,
            "route_xla": 0})
    if not close_losses(tp["losses"], tp["executor_losses"],
                        DECL_TRAIN_RTOL):
        raise AssertionError(f"declarative: the reloaded train program "
                             f"{tp['losses']} vs the Executor "
                             f"{tp['executor_losses']}")


# --------------------------------------------------------------------------
# phase 39: collective training on one card's slots (distributed/)
# --------------------------------------------------------------------------
# bert-base with bench.py's settings but no dropout: the parity with the
# one-slot step needs the same dropout draws, and each slot draws its own
DIST_BERT = dict(num_classes=2, vocab_size=30522, hidden_size=768,
                 num_hidden_layers=12, num_attention_heads=12,
                 intermediate_size=3072, max_position_embeddings=512,
                 hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
                 dropout=0.0)
DIST_BERT_BATCH = 32
DIST_STEPS = 4
DIST_LR = 5e-5
# f32 (TF32 off) losses of the sharded step against the one-slot step:
# the mp partial sums and the dp mean change only the summation order
DIST_LOSS_RTOL = 1e-5
# parameters after DIST_STEPS AdamW steps: Adam moves a weight whose
# gradient is rounding noise (the attention's k bias: exactly 0 in exact
# arithmetic, as softmax is shift-invariant) by up to about lr a step, so
# the bound is DIST_STEPS * lr; every other weight is reported apart
DIST_PARAM_ATOL = DIST_STEPS * DIST_LR
DIST_RING = dict(B=2, S=2048, H=12, D=64)
DIST_RING_MESHES = (("sp2_dp2", {"sp": 2, "dp": 2}), ("sp4", {"sp": 4}))
# the JAX entry's toy step takes lr 1e-2; at d_model 768 / d_ff 3072 an
# Adam step of 1e-2 moves all 2.4M entries of a stage's matrices by that
# much and the loss diverges (5.4 -> 1636 on the card); 1e-5 falls
DIST_HYBRID = dict(vocab=50304, d_model=768, d_ff=3072, n_classes=4, seq=8,
                   micro_batch=1, lr=1e-5)
DIST_HYBRID_STEPS = 3
DIST_HYBRID_RTOL = 2e-4            # tests/test_hybrid_step.py:79
DIST_1F1B = dict(pp=4, d=768, B=32, mbs=4)
DIST_1F1B_RTOL = 1e-5


def _slot_bytes(state, mesh) -> dict:
    """Bytes each slot holds of a sharded step's state (parameters,
    optimizer state, buffers): a tensor that slots on one card share is
    counted for each of them, and once in ``distinct``."""
    per = [0] * mesh.size
    seen = {}
    groups = [state["params"], state["buffers"],
              *state["opt"].values()]
    for d in groups:
        for sa in d.values():
            for i, t in enumerate(sa.shards):
                b = t.numel() * t.element_size()
                per[i] += b
                seen[id(t)] = b
    return {"per_slot": per, "distinct": sum(seen.values())}


def dist_bert_arm() -> dict:
    """(a) ``make_sharded_train_step`` on bert-base at dp 2 x mp 2 (4
    slots of cuda:0, 6 heads a slot) against the same step on one slot,
    from the same weights: DIST_STEPS AdamW steps, f32."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import nn, optimizer
    from paddle_tpu_torch.distributed import mesh as dmesh
    from paddle_tpu_torch.distributed.parallel import make_sharded_train_step
    from paddle_tpu_torch.text.models import BertForSequenceClassification

    pt.set_device(DEVICE)
    ids, mask, y = bert_inputs(np.random.RandomState(0), DIST_BERT_BATCH)
    pt.seed(0)
    model = BertForSequenceClassification(**DIST_BERT)
    loss_fn = nn.CrossEntropyLoss()
    runs, finals = {}, {}
    prev = dmesh.force_device_count(4)
    try:
        for tag, axes in (("one_slot", {"dp": 1}),
                          ("dp2_mp2", {"dp": 2, "mp": 2})):
            mesh = dmesh.init_mesh(axes)
            opt = optimizer.AdamW(DIST_LR, parameters=model.parameters())
            torch.cuda.reset_peak_memory_stats()
            step, state = make_sharded_train_step(
                model, lambda o, t: loss_fn(o, t), opt, mesh=mesh)
            losses, ms, launches = [], [], []
            for _ in range(DIST_STEPS):
                reset_flash_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, loss = step(state, (ids, None, mask), y)
                losses.append(float(loss))
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                launches.append(read_flash_counts())
            runs[tag] = {"losses": losses, "step_ms": ms,
                         "step_ms_p50": float(np.median(ms[1:])),
                         "slots": mesh.size,
                         "slot_bytes": _slot_bytes(state, mesh),
                         "peak_bytes": torch.cuda.max_memory_allocated(),
                         "launches_per_step": launches}
            finals[tag] = {n: sa.global_tensor().detach()
                           for n, sa in state["params"].items()}
            del step, state
            free_cuda()
    finally:
        dmesh.force_device_count(prev)
    layers = DIST_BERT["num_hidden_layers"]
    for tag, n_slots in (("one_slot", 1), ("dp2_mp2", 4)):
        k = layers * n_slots
        for i, c in enumerate(runs[tag]["launches_per_step"]):
            expect_counts(f"distributed_bert_{tag}_step{i}", c, {
                "flash_fwd": k, "flash_dkv": k, "flash_dq": k,
                "flash_ref": 0, "flash_f32tc_fwd": k,
                "flash_f32tc_dkv": k, "flash_f32tc_dq": k})
    a, b = finals["one_slot"], finals["dp2_mp2"]
    diffs = {n: float((a[n] - b[n]).abs().max()) for n in a}
    worst = max(diffs, key=diffs.get)
    others = {n: d for n, d in diffs.items() if "k_proj.bias" not in n}
    res = {"batch": DIST_BERT_BATCH, "seq": BERT_SEQ, "steps": DIST_STEPS,
           **runs, "loss_rtol": DIST_LOSS_RTOL,
           "param_max_abs_diff": diffs[worst], "param_worst": worst,
           "param_max_abs_diff_but_k_bias": max(others.values()),
           "param_atol": DIST_PARAM_ATOL,
           "heads_per_slot": DIST_BERT["num_attention_heads"] // 2}
    if not close_losses(runs["dp2_mp2"]["losses"], runs["one_slot"]["losses"],
                        DIST_LOSS_RTOL):
        raise AssertionError(f"distributed bert: dp2 x mp2 losses "
                             f"{runs['dp2_mp2']['losses']} vs one slot "
                             f"{runs['one_slot']['losses']}")
    if not diffs[worst] <= DIST_PARAM_ATOL:
        raise AssertionError(f"distributed bert: {worst} differs by "
                             f"{diffs[worst]} from the one-slot step")
    return res


def _ring_inputs(dtype, seed):
    g = torch.Generator(device=DEVICE)
    g.manual_seed(seed)
    B, S, H, D = (DIST_RING[k] for k in ("B", "S", "H", "D"))
    return [torch.randn((B, S, H, D), generator=g, device=DEVICE).to(dtype)
            for _ in range(4)]


def _attn_grads(fn, q, k, v, cot):
    """``fn``'s output and (dq, dk, dv) for the cotangent ``cot``, with
    the wall time of the forward and backward (synchronized)."""
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*leaves)
    grads = torch.autograd.grad(out, leaves, grad_outputs=cot)
    torch.cuda.synchronize()
    return out.detach(), grads, (time.perf_counter() - t0) * 1e3


def _close(tag, name, got, want, dtype) -> dict:
    want = want.float()
    err = float((got.float() - want).abs().max())
    limit = FLASH_TOL[dtype] * max(1.0, float(want.abs().max()))
    rel = flash_rel_l2(got, want)
    ok = math.isfinite(err) and err <= limit and rel <= FLASH_REL_L2[dtype]
    if not ok:
        raise AssertionError(f"distributed ring {tag}: {name} max_abs_err "
                             f"{err} (limit {limit}), relative L2 {rel} "
                             f"(limit {FLASH_REL_L2[dtype]})")
    return {"max_abs_err": err, "rel_l2": rel}


def dist_ring_arm() -> dict:
    """(b) ring attention at GPT-2-small's attention width (H 12, D 64,
    causal, S 2048, B 2) over sp 2 x dp 2 and sp 4, f32 and bf16: output
    and dq/dk/dv against ``flash_attention_bshd`` over the whole sequence
    on one slot and against the plain ring; #5-#7 launches per ring; then
    ``_dryrun_sequence_parallel``'s three training steps at this width."""
    from paddle_tpu_torch.distributed import mesh as dmesh
    from paddle_tpu_torch.distributed.ring_attention import (
        ring_attention, sequence_parallel_attention)
    from paddle_tpu_torch.ops.flash_attention import flash_attention_bshd

    res = {}
    prev = dmesh.force_device_count(4)
    try:
        for dtype, dname in ((torch.float32, "float32"),
                             (torch.bfloat16, "bfloat16")):
            q, k, v, cot = _ring_inputs(dtype, 39)
            _attn_grads(lambda a, b, c: flash_attention_bshd(
                a, b, c, causal=True), q, k, v, cot)      # warm-up
            ref_o, ref_g, ref_ms = _attn_grads(
                lambda a, b, c: flash_attention_bshd(a, b, c, causal=True),
                q, k, v, cot)
            for tag, axes in DIST_RING_MESHES:
                mesh = dmesh.init_mesh(axes)
                sp = axes["sp"]
                rings = mesh.size // sp
                def ring(a, b, c):
                    return sequence_parallel_attention(
                        a, b, c, mesh=mesh, axis_name="sp", causal=True)

                _attn_grads(ring, q, k, v, cot)           # warm-up
                reset_flash_counts()
                o, g, ms = _attn_grads(ring, q, k, v, cot)
                counts = read_flash_counts()
                per_ring = sp * (sp + 1) // 2
                expect_counts(f"distributed_ring_{tag}_{dname}", counts, {
                    "flash_fwd": rings * per_ring,
                    "flash_dkv": rings * per_ring,
                    "flash_dq": rings * per_ring, "flash_ref": 0})
                spec = dmesh.PartitionSpec(None, "sp", None, None)
                plain = dmesh.shard_map(
                    lambda a, b, c: ring_attention(a, b, c, "sp", True,
                                                   use_flash=False),
                    mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec)
                _attn_grads(plain, q, k, v, cot)          # warm-up
                po, pg, pms = _attn_grads(plain, q, k, v, cot)
                case = f"{tag}/{dname}"
                res[case] = {
                    "rings": rings, "slots": mesh.size, "ms": ms,
                    "plain_ring_ms": pms, "one_slot_flash_ms": ref_ms,
                    "launches": counts,
                    "launches_per_ring": {kk: counts[f"flash_{kk}"] // rings
                                          for kk in ("fwd", "dkv", "dq")},
                    "vs_one_slot": {
                        "out": _close(case, "out", o, ref_o, dtype),
                        **{n: _close(case, n, a, b, dtype)
                           for n, a, b in zip(("dq", "dk", "dv"), g, ref_g)}},
                    "vs_plain_ring": {
                        "out": _close(case, "out/plain", o, po, dtype),
                        **{n: _close(case, f"{n}/plain", a, b, dtype)
                           for n, a, b in zip(("dq", "dk", "dv"), g, pg)}}}
                del o, g, po, pg
            free_cuda()
        res["train"] = dist_ring_train()
    finally:
        dmesh.force_device_count(prev)
    return res


def dist_ring_train() -> dict:
    """``_dryrun_sequence_parallel`` (``__graft_entry__.py:154-200``) at
    DIST_RING's width over dp 2 x sp 2, f32: q = x @ w, ring attention
    of (q, x, x), MSE to a target, three steps of w -= 0.1 g."""
    from paddle_tpu_torch.distributed import mesh as dmesh
    from paddle_tpu_torch.distributed.ring_attention import (
        sequence_parallel_attention)

    mesh = dmesh.init_mesh({"dp": 2, "sp": 2})
    B, S, H, D = (DIST_RING[k] for k in ("B", "S", "H", "D"))
    rng = np.random.RandomState(0)
    w = torch.tensor(rng.randn(D, D).astype(np.float32) * 0.1, device=DEVICE)
    x = torch.tensor(rng.randn(B, S, H, D).astype(np.float32), device=DEVICE)
    tgt = torch.tensor(rng.randn(B, S, H, D).astype(np.float32),
                       device=DEVICE)
    losses = []
    reset_flash_counts()
    for _ in range(3):
        wl = w.detach().requires_grad_(True)
        out = sequence_parallel_attention(x @ wl, x, x, mesh=mesh,
                                          axis_name="sp", causal=True)
        loss = torch.mean((out - tgt) ** 2)
        (g,) = torch.autograd.grad(loss, [wl])
        w = w - 0.1 * g
        losses.append(float(loss))
    res = {"losses": losses, "launches": read_flash_counts()}
    if not (all(math.isfinite(v) for v in losses)
            and losses[-1] < losses[0]):
        raise AssertionError(f"distributed ring train: losses {losses}")
    return res


def hybrid_reference(params0, x, y, steps, lr):
    """``tests/test_hybrid_step.py``'s one-device reference in torch, f64:
    the stages in sequence, plain bias-corrected Adam."""
    p = {k: torch.as_tensor(v, dtype=torch.float64, device=DEVICE)
         for k, v in params0.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    s = {k: torch.zeros_like(v) for k, v in p.items()}
    xt = torch.as_tensor(x, device=DEVICE).long()
    yt = torch.as_tensor(y, device=DEVICE).long()
    losses = []
    for t in range(1, steps + 1):
        leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        h = leaves["emb"][xt]
        for st in range(leaves["w1"].shape[0]):
            a = torch.nn.functional.gelu(
                torch.einsum("btd,df->btf", h, leaves["w1"][st])
                + leaves["b1"][st], approximate="tanh")
            h = h + torch.einsum("btf,fd->btd", a, leaves["w2"][st]) \
                + leaves["b2"][st]
        logits = h.mean(dim=1) @ leaves["head"]
        loss = torch.mean(torch.logsumexp(logits, dim=-1)
                          - logits.gather(-1, yt[:, None])[:, 0])
        grads = torch.autograd.grad(loss, list(leaves.values()))
        with torch.no_grad():
            for (k, _), g in zip(leaves.items(), grads):
                m[k] = 0.9 * m[k] + 0.1 * g
                s[k] = 0.999 * s[k] + 0.001 * g * g
                p[k] = p[k] - lr * (m[k] / (1 - 0.9 ** t)) / (
                    torch.sqrt(s[k] / (1 - 0.999 ** t)) + 1e-8)
        losses.append(float(loss))
    return losses


def dist_hybrid_arm() -> dict:
    """(c) ``make_hybrid_step`` on 8 slots (dp 2 x pp 2 x mp 2) at vocab
    50304, d_model 768, d_ff 3072: DIST_HYBRID_STEPS steps, each loss
    against :func:`hybrid_reference` from the same weights."""
    from paddle_tpu_torch.distributed import mesh as dmesh
    from paddle_tpu_torch.distributed.hybrid_step import make_hybrid_step

    prev = dmesh.force_device_count(8)
    try:
        mesh = dmesh.init_mesh({"dp": 2, "pp": 2, "mp": 2})
        step, state = make_hybrid_step(mesh, seed=0, **DIST_HYBRID)
        params0 = {k: sa.numpy() for k, sa in state[0].items()}
        rng = np.random.RandomState(1)
        x = rng.randint(0, DIST_HYBRID["vocab"],
                        (4, DIST_HYBRID["seq"])).astype(np.int64)
        y = rng.randint(0, DIST_HYBRID["n_classes"], (4,)).astype(np.int64)
        losses, ms = [], []
        for _ in range(DIST_HYBRID_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, loss = step(state, x, y)
            losses.append(float(loss))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        zm = state[1]["m"]["emb"]
        del step, state
    finally:
        dmesh.force_device_count(prev)
    ref = hybrid_reference(params0, x, y, DIST_HYBRID_STEPS,
                           DIST_HYBRID["lr"])
    res = {"losses": losses, "reference_losses": ref, "step_ms": ms,
           "rtol": DIST_HYBRID_RTOL, "zero_m_emb_shape": list(zm.shape)}
    if not close_losses(losses, ref, DIST_HYBRID_RTOL):
        raise AssertionError(f"distributed hybrid: losses {losses} vs the "
                             f"reference {ref}")
    if not losses[-1] < losses[0] or zm.shape[-2] != 2:
        raise AssertionError(f"distributed hybrid: losses {losses}, ZeRO "
                             f"state {zm.shape}")
    return res


def dist_1f1b_arm() -> dict:
    """(d) ``pipeline_train_step`` (interleaved 1F1B) at pp 4 on 4 slots,
    d 768, B 32, micro-batches of 4: loss and gradients against the
    stages run in sequence on one slot."""
    from paddle_tpu_torch.distributed import mesh as dmesh
    from paddle_tpu_torch.distributed.pipeline import (
        build_1f1b_schedule, pipeline_train_step, schedule_peak_in_flight,
        stack_stage_params)

    pp, d, B, mbs = (DIST_1F1B[k] for k in ("pp", "d", "B", "mbs"))
    g = torch.Generator(device=DEVICE)
    g.manual_seed(41)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=DEVICE) * scale

    stages = [{"w": randn(d, d, scale=d ** -0.5)} for _ in range(pp)]
    head = {"w": randn(8, d, scale=8 ** -0.5)}
    x, y = randn(B, 8), randn(B, d)

    def stage_fn(p, h):
        return torch.tanh(h @ p["w"])

    def head_fn(hp, xb):
        return xb @ hp["w"]

    def loss_fn(out, tgt):
        return ((out - tgt) ** 2).sum()

    prev = dmesh.force_device_count(pp)
    try:
        mesh = dmesh.init_mesh({"pp": pp})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, g_st, g_hp = pipeline_train_step(
            mesh, stage_fn, stack_stage_params(stages), x, y, mbs, loss_fn,
            head_fn=head_fn, head_params=head)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    finally:
        dmesh.force_device_count(prev)
    leaves = [s["w"].clone().requires_grad_(True) for s in stages]
    hw = head["w"].clone().requires_grad_(True)
    M = B // mbs
    total = 0.0
    for j in range(M):
        h = x[j * mbs:(j + 1) * mbs] @ hw
        for w in leaves:
            h = torch.tanh(h @ w)
        total = total + loss_fn(h, y[j * mbs:(j + 1) * mbs])
    total = total / M
    ref = torch.autograd.grad(total, leaves + [hw])
    errs = {}
    for name, got, want in ([(f"stage{i}", g_st["w"][i], ref[i])
                             for i in range(pp)]
                            + [("head", g_hp["w"], ref[-1])]):
        err = float((got - want).abs().max())
        limit = DIST_1F1B_RTOL * max(1.0, float(want.abs().max()))
        errs[name] = err
        if not err <= limit:
            raise AssertionError(f"distributed 1f1b: {name} gradient "
                                 f"max_abs_err {err} (limit {limit})")
    f_tab, b_tab = build_1f1b_schedule(M, pp)
    res = {"loss": float(loss), "reference_loss": float(total), "ms": ms,
           "grad_max_abs_err": errs, "ticks": int(f_tab.shape[0]),
           "peak_in_flight": schedule_peak_in_flight(f_tab, b_tab)}
    if not abs(res["loss"] - res["reference_loss"]) <= \
            DIST_1F1B_RTOL * abs(res["reference_loss"]):
        raise AssertionError(f"distributed 1f1b: loss {res['loss']} vs "
                             f"{res['reference_loss']}")
    return res


def _localsgd_data(n_batches, B=16, seed=0):
    """``tests/test_localsgd.py``'s batches."""
    rng = np.random.RandomState(seed)
    w = rng.randn(6, 1).astype(np.float32)
    out = []
    for _ in range(n_batches):
        xv = rng.randn(B, 6).astype(np.float32)
        out.append((xv, (xv @ w).astype(np.float32)))
    return out


def localsgd_child(out_dir) -> int:
    """One trainer of arm (e), started by ``distributed.launch``: its half
    of each batch, an SGD step, the parameters averaged over the trainers
    through the host backend after every step (LocalSGD at k 1), and the
    full-batch SGD step beside it; writes ``rank{r}.json``."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import nn, optimizer
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.nn import functional as F

    dist.init_parallel_env()
    rank, world = dist.get_rank(), dist.get_world_size()
    pt.set_device(DEVICE)
    pt.seed(0)
    model = nn.Linear(6, 1)
    pt.seed(0)
    ref = nn.Linear(6, 1)
    opt = optimizer.SGD(0.1, parameters=model.parameters())
    ref_opt = optimizer.SGD(0.1, parameters=ref.parameters())
    half = 16 // world
    errs = []
    for xv, yv in _localsgd_data(6):
        part = slice(rank * half, (rank + 1) * half)
        loss = F.mse_loss(model(pt.to_tensor(xv[part])),
                          pt.to_tensor(yv[part]))
        loss.backward()
        opt.step()
        opt.clear_grad()
        with pt.no_grad():
            for p in model.parameters():
                dist.all_reduce(p, op=dist.ReduceOp.AVG)
        full = F.mse_loss(ref(pt.to_tensor(xv)), pt.to_tensor(yv))
        full.backward()
        ref_opt.step()
        ref_opt.clear_grad()
        errs.append(max(float((p._value - q._value).abs().max())
                        for p, q in zip(model.parameters(),
                                        ref.parameters())))
    total = dist.all_reduce(pt.to_tensor(np.float32(rank + 1)))
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump({"rank": rank, "world": world, "max_abs_err": max(errs),
                   "sum": float(total._value),
                   "device": str(model.weight._value.device),
                   "endpoint": os.environ.get("PADDLE_CURRENT_ENDPOINT")}, f)
    return 0


def _free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def dist_launch_arm() -> dict:
    """(e) two trainer processes on cuda:0, started by the port's
    ``distributed.launch`` on this script's ``--localsgd-child``: the
    eager host-backend path; each must end within 2e-5 of full-batch
    SGD (``tests/test_localsgd.py:36``)."""
    import tempfile

    root = os.path.dirname(os.path.abspath(__file__))
    out = tempfile.mkdtemp(prefix="chip_smoke_launch_")
    env = dict(os.environ, PADDLE_DIST_BACKEND="gloo",
               PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    for k in ("PADDLE_TRAINER_ENDPOINTS", "PADDLE_TRAINERS_NUM",
              "PADDLE_TRAINER_ID"):
        env.pop(k, None)
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nproc_per_node=2", f"--started_port={_free_port()}",
         f"--gloo_port={_free_port()}", "--log_dir",
         os.path.join(out, "logs"), os.path.abspath(__file__),
         "--localsgd-child", out],
        env=env, cwd=root, capture_output=True, text=True, timeout=300)
    wall = time.perf_counter() - t0
    logs = ""
    logdir = os.path.join(out, "logs")
    if os.path.isdir(logdir):
        for name in sorted(os.listdir(logdir)):
            with open(os.path.join(logdir, name)) as f:
                logs += f"\n--- {name}\n{f.read()[-3000:]}"
    if r.returncode != 0:
        raise AssertionError(f"distributed launch: rc {r.returncode}\n"
                             f"{r.stdout[-2000:]}\n{r.stderr[-2000:]}{logs}")
    ranks = []
    for rank in range(2):
        with open(os.path.join(out, f"rank{rank}.json")) as f:
            ranks.append(json.load(f))
    res = {"ranks": ranks, "wall_s": wall}
    ok = (all(o["world"] == 2 and o["sum"] == 3.0 and o["max_abs_err"] <= 2e-5
              and o["device"].startswith("cuda") for o in ranks)
          and ranks[0]["endpoint"] != ranks[1]["endpoint"])
    if not ok:
        raise AssertionError(f"distributed launch: {ranks}")
    return res


def distributed_phase() -> dict:
    """Phase 39: arms (a)-(e) (the module docstring)."""
    res = {}
    for name, arm in (("bert", dist_bert_arm), ("ring", dist_ring_arm),
                      ("hybrid", dist_hybrid_arm), ("pipeline_1f1b",
                                                    dist_1f1b_arm),
                      ("launch_localsgd", dist_launch_arm)):
        t0 = time.perf_counter()
        res[name] = arm()
        res[name]["seconds"] = time.perf_counter() - t0
        log("distributed", arm=name, **res[name])
        free_cuda()
    return res


# --------------------------------------------------------------------------
# phase 40: fleet and the parameter server on the card (distributed/fleet,
# distributed/ps, io/multislot.py, io/native_feed.py)
# --------------------------------------------------------------------------
# PaddleRec models/rank/dnn on Criteo: 26 categorical slots of one id each
# hashed into 1,000,001 ids, embedding dim 9, the 13 dense features as one
# dense slot, fc 512-256-128-32, batch 512
CTR_VOCAB = 1_000_001
CTR_DIM = 9
CTR_SPARSE = 26
CTR_DENSE = 13
CTR_FC = (512, 256, 128, 32)
CTR_BATCH = 512
CTR_RECORDS = 131_072
CTR_FILES = 4
CTR_CACHE_ROWS = 1 << 18
CTR_THREADS = 2
CTR_EMB_LR = 0.05                 # adagrad on the table
CTR_DENSE_LR = 0.1                # SGD on the tower
CTR_ZIPF = 1.2
CTR_PARITY_BATCHES = 32
# the table after the same CTR_PARITY_BATCHES one-thread sync steps on the
# card and on the CPU, its rows made zero (so a row is its movement) and
# updated by the sgd rule, under a logistic head (CTR_PARITY_FC = ()).
# The dense sums (TF32 off) run in another order on each device, and the
# gather's backward sums duplicate ids with atomics on the card, so the
# gradients part at rounding.  A ReLU tower turns that into more: a unit
# whose input is within rounding of 0 is on for one device and off for
# the other, which reroutes that example's gradient, and the trained
# tower carries the change into every later step (runs on an H100 of
# the dnn tower: rows 2.3e-10 apart in one run, 9.0e-6 of 1.2e-3 in
# another).  Adagrad's step lr * g / (sqrt(g2) + eps) does the same
# where a hot id's gradient cancels (rows 0.058 and 0.086 apart).  The
# logistic head and sgd are smooth, so the two devices part at rounding
# only.  The rules' arithmetic is host numpy, the same on both devices
# (held against the JAX package on the CPU), so this holds the card's
# path (cache, gather, row-gradient hook, pushes) to the CPU's: a fault
# there (a stale or wrong row, a lost push) moves a row by a step's
# size or more.  So each row is held on its own: no element of it may
# be further apart than 1e-4 of the largest element of the CPU's table;
# an aggregate over 65,740 rows would let a few wrong rows through.  The
# hogwild drive trains the dnn tower
CTR_PARITY_REL = 1e-4
CTR_PARITY_FC = ()
PS_STEPS = 50                      # arm (b): steps of each trainer
PS_K_STEPS = 4
FLEET_BERT_MICRO = 4               # arm (c): gradient merge micro-steps
FLEET_GM_K = 2
# bf16 losses of the merged run against plain AdamW on the averaged
# gradients: the same kernels, but the word-embedding gradient is summed
# with atomics, so the two runs part at rounding, and AdamW moves a
# weight whose gradient is rounding noise by up to lr a step
FLEET_GM_LOSS_RTOL = 2e-3
FLEET_GM_PARAM_ATOL = 2 * (FLEET_BERT_MICRO // FLEET_GM_K) * DIST_LR
# gradients of the recomputed backward against the plain one: relative L2
FLEET_RECOMPUTE_REL_L2 = 1e-2
FLEET_DGC_SPARSITY = 0.999
STATIC_DS_RECORDS = 4096


def _ctr_slots():
    from paddle_tpu_torch.io.multislot import Slot

    return ([Slot("label", "float32", is_dense=True, dim=1),
             Slot("dense", "float32", is_dense=True, dim=CTR_DENSE)]
            + [Slot(f"C{i + 1}", "int64") for i in range(CTR_SPARSE)])


def _ctr_ids(rng, n):
    """[n, CTR_SPARSE] hashed ids: a Zipf rank within each slot's range,
    scrambled over the id space."""
    span = (CTR_VOCAB - 1) // CTR_SPARSE
    rank = np.minimum(rng.zipf(CTR_ZIPF, (n, CTR_SPARSE)), span) - 1
    local = rank + np.arange(CTR_SPARSE)[None, :] * span
    return (local * 2654435761) % CTR_VOCAB


def ctr_records(seed, n, id_offset=0):
    """n synthetic Criteo-layout records: ids, dense features and labels
    from a planted logistic rule over hidden per-id weights and the dense
    features (so a model can learn them)."""
    rng = np.random.RandomState(seed)
    hidden = np.random.RandomState(1234).randn(CTR_VOCAB).astype(
        np.float32) * 0.6
    w_dense = np.random.RandomState(1235).randn(CTR_DENSE).astype(
        np.float32) * 0.5
    ids = (_ctr_ids(rng, n) + id_offset) % CTR_VOCAB
    dense = np.log1p(rng.exponential(2.0, (n, CTR_DENSE))).astype(
        np.float32)
    logit = hidden[ids].sum(1) + (dense - 1.0) @ w_dense - 0.8
    label = (rng.rand(n) < 1 / (1 + np.exp(-logit))).astype(np.float32)
    return ids, dense, label


def _write_ctr_file(args):
    """Write one multislot file of CTR records (a worker process)."""
    from paddle_tpu_torch.io.multislot import write_multislot_file

    path, seed, n = args
    ids, dense, label = ctr_records(seed, n)
    dense_s = np.char.mod("%.4f", dense).tolist()
    ids_l = ids.tolist()
    rows = ({"label": [int(label[i])], "dense": dense_s[i],
             **{f"C{j + 1}": [ids_l[i][j]] for j in range(CTR_SPARSE)}}
            for i in range(n))
    write_multislot_file(path, rows, _ctr_slots())
    return path


def write_ctr_files(out_dir, seed=0):
    """CTR_FILES files of CTR_RECORDS / CTR_FILES records each, written
    in parallel processes."""
    import concurrent.futures
    import multiprocessing

    per = CTR_RECORDS // CTR_FILES
    jobs = [(os.path.join(out_dir, f"part-{i}.txt"), seed + i, per)
            for i in range(CTR_FILES)]
    with concurrent.futures.ProcessPoolExecutor(
            CTR_FILES, mp_context=multiprocessing.get_context("spawn")) as ex:
        return list(ex.map(_write_ctr_file, jobs))


class CTRTower:
    """The dense tower of PaddleRec's dnn: [26 x 9 embeddings, 13 dense]
    -> fc 512-256-128-32 (ReLU) -> 1 logit, port ``nn.Linear``s; with
    ``fc=()`` one ``Linear``, a logistic regression."""

    def __init__(self, seed, fc=CTR_FC):
        import paddle_tpu_torch as pt
        from paddle_tpu_torch import nn

        pt.seed(seed)
        dims = (CTR_SPARSE * CTR_DIM + CTR_DENSE,) + tuple(fc) + (1,)
        self.layers = [nn.Linear(a, b) for a, b in zip(dims, dims[1:])]

    def parameters(self):
        return [p for lin in self.layers for p in lin.parameters()]

    def __call__(self, x):
        from paddle_tpu_torch.nn import functional as F

        for i, lin in enumerate(self.layers):
            x = lin(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


def ctr_step_fn(emb, tower, opt, device, times=None):
    """One CTR training step on a multislot batch: returns the loss (a
    host float: the step's sync).  Hogwild workers run it with no lock:
    the trainer makes the tower's shared gradients safe to clear."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.nn import functional as F

    def step(batch):
        t0 = time.perf_counter()
        ids = np.concatenate([batch[f"C{i + 1}"]
                              for i in range(CTR_SPARSE)], axis=1)
        e = emb(ids).reshape([ids.shape[0], CTR_SPARSE * CTR_DIM])
        x = pt.concat([e, pt.to_tensor(batch["dense"], place=device)],
                      axis=1)
        loss = F.binary_cross_entropy_with_logits(
            tower(x), pt.to_tensor(batch["label"], place=device))
        loss.backward()
        opt.step()
        opt.clear_grad()
        out = float(loss.numpy())
        if times is not None:
            times.append(time.perf_counter() - t0)
        return out

    return step


def ctr_model(device, name, cache=True, strategy=None, rule="adagrad",
              initializer="uniform", fc=CTR_FC):
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed import fleet

    fleet.init(strategy=strategy)
    emb = fleet.sparse_embedding(name, CTR_DIM, rule=rule,
                                 lr=CTR_EMB_LR, device=device,
                                 cache_rows=CTR_CACHE_ROWS if cache else 0,
                                 initializer=initializer)
    tower = CTRTower(seed=3, fc=fc)
    if device == "cpu":        # the same weights, moved
        for p in tower.parameters():
            p._value = p._value.detach().cpu().requires_grad_()
    opt = optimizer.SGD(CTR_DENSE_LR, parameters=tower.parameters())
    return emb, tower, opt


def base_entropy(labels) -> float:
    p = float(np.mean(labels))
    return -(p * math.log(p) + (1 - p) * math.log(1 - p))


def ctr_parity(batches, fc=CTR_PARITY_FC):
    """One-thread sync parity: ``batches`` on the card and on the CPU,
    the table zero-initialised on the sgd rule, the touched rows of the
    two host tables compared row by row against CTR_PARITY_REL of the
    CPU table's largest element; and the host syncs of one steady step
    on the card."""
    from paddle_tpu_torch.distributed.ps import runtime

    tables, losses, syncs = {}, {}, None
    for tag, dev in (("card", DEVICE), ("cpu", "cpu")):
        runtime.reset()
        emb, tower, opt = ctr_model(dev, f"parity_{tag}", rule="sgd",
                                    initializer="zeros", fc=fc)
        step = ctr_step_fn(emb, tower, opt, dev)
        got = losses[tag] = [step(batches[0])]
        if tag == "card":       # the syncs of one steady step
            torch.cuda.synchronize()
            syncs = _synced(lambda: got.append(step(batches[1])))[1]
        got += [step(b) for b in batches[len(got):]]
        tables[tag] = emb.table.table.state_dict()
    runtime.reset()
    a, b = tables["card"], tables["cpu"]
    oa, ob = np.argsort(a["ids"]), np.argsort(b["ids"])
    if not np.array_equal(a["ids"][oa], b["ids"][ob]):
        raise AssertionError("fleet_ps ctr: the card's and the CPU's "
                             "tables touched other ids")
    ra, rb = a["rows"][oa], b["rows"][ob]
    row_diff = np.abs(ra - rb).max(axis=1)
    bound = CTR_PARITY_REL * float(np.abs(rb).max())
    return {"fc": list(fc),
            "rows_max_abs_diff": float(row_diff.max()),
            "rows_max_abs": float(np.abs(rb).max()),
            "rel_l2": float(np.linalg.norm(ra - rb)
                            / max(np.linalg.norm(rb), 1e-30)),
            "row_bound": bound,
            "rows_over_bound": int((row_diff > bound).sum()),
            "touched_rows": int(len(ra)),
            "losses_last3": {k: v[-3:] for k, v in losses.items()}}, syncs


def fleet_ctr_arm(work) -> dict:
    """(a) CTR over the parameter server at PaddleRec dnn's widths."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.ps import runtime
    from paddle_tpu_torch.framework import concurrency as cc
    from paddle_tpu_torch.io import native_feed

    t0 = time.perf_counter()
    native_feed.load_library()
    build = dict(native_feed.build_log)
    paths = write_ctr_files(work)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ds = fleet.InMemoryDataset()
    ds.set_slots(_ctr_slots())
    ds.set_filelist(paths)
    ds.set_batch_size(CTR_BATCH)
    ds.set_thread(CTR_THREADS)
    ds.load_into_memory()
    ds.set_shuffle_seed(7)
    ds.local_shuffle()
    load_s = time.perf_counter() - t0
    labels = np.concatenate([r.slots["label"] for r in ds._records])
    entropy = base_entropy(labels)

    first = list(itertools.islice(ds.iter_batches(0, 1),
                                  CTR_PARITY_BATCHES))
    parity, syncs = ctr_parity(first)
    parity_ok = parity["rows_over_bound"] == 0 and parity["row_bound"] > 0

    # the drive: two hogwild workers over the whole dataset
    emb, tower, opt = ctr_model(DEVICE, "ctr")
    times = []
    step = ctr_step_fn(emb, tower, opt, DEVICE, times)
    torch.cuda.reset_peak_memory_stats()
    with cc.witness(raise_on_violation=False):
        t0 = time.perf_counter()
        out = fleet.train_from_dataset(ds, step, thread_num=CTR_THREADS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        violations = [v.format() for v in cc.violations()]
    n = out["batches"]
    per = [w for w in out["per_worker_losses"]]
    tail = [x for w in per for x in w[-16:]]
    head = [x for w in per for x in w[:16]]
    res = {"records": CTR_RECORDS, "files": CTR_FILES, "vocab": CTR_VOCAB,
           "dim": CTR_DIM, "fc": CTR_FC, "batch": CTR_BATCH,
           "threads": CTR_THREADS, "native_build": build,
           "write_s": write_s, "load_s": load_s, "train_s": wall,
           "batches": n, "examples_per_s": CTR_RECORDS / wall,
           "step_ms_p50": float(np.percentile(times, 50) * 1e3),
           "step_ms_p95": float(np.percentile(times, 95) * 1e3),
           "loss_first16": float(np.mean(head)),
           "loss_last16": float(np.mean(tail)),
           "base_rate_entropy": entropy,
           "label_rate": float(labels.mean()),
           "cache_hit_rate": emb.table.hit_rate,
           "cached_rows": emb.table.cached_rows,
           "host_table_rows": emb.table.size,
           "host_pull_ms_per_step": emb.stats["pull_s"] / n * 1e3,
           "host_push_ms_per_step": emb.stats["push_s"] / n * 1e3,
           "host_syncs_per_step": syncs,
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "witness_violations": violations,
           "parity_batches": CTR_PARITY_BATCHES,
           "parity": parity,
           "parity_rule": "sgd", "parity_init": "zeros",
           "parity_row_limit": CTR_PARITY_REL}
    runtime.reset()
    if not (build.get("path") and os.path.exists(build["path"])):
        raise AssertionError(f"fleet_ps ctr: native feed not built {build}")
    if n != CTR_RECORDS // CTR_BATCH:
        raise AssertionError(f"fleet_ps ctr: {n} batches")
    if not res["loss_last16"] < entropy:
        raise AssertionError(f"fleet_ps ctr: loss {res['loss_last16']} not "
                             f"below the base-rate entropy {entropy}")
    if not parity_ok:
        raise AssertionError(f"fleet_ps ctr: card vs CPU table {parity}")
    if violations:
        raise AssertionError(f"fleet_ps ctr: witness {violations}")
    return res


def ps_child(mode, out_dir) -> int:
    """Arm (b)'s processes: ``server`` (host only, no CUDA context) or
    ``trainer`` (started by ``distributed.launch``; CTR at arm (a)'s
    widths on the card in geo mode, PS_STEPS steps on ids of its own half
    of the id space)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.ps import runtime

    if mode == "server":
        fleet.init(fleet.PaddleCloudRoleMaker())
        fleet.init_server()
        fleet.run_server()
        sid = os.environ["PADDLE_PSERVER_ID"]
        with open(os.path.join(out_dir, f"server{sid}.json"), "w") as f:
            json.dump({"cuda_initialized": torch.cuda.is_initialized()}, f)
        return 0
    rank = int(os.environ["PADDLE_TRAINER_ID"])
    pt.set_device(DEVICE)
    strategy = fleet.DistributedStrategy()
    strategy.a_sync = True
    strategy.a_sync_configs.k_steps = PS_K_STEPS
    fleet.init(fleet.PaddleCloudRoleMaker(), strategy=strategy)
    fleet.init_worker()
    emb, tower, opt = ctr_model(DEVICE, "ctr", cache=False,
                                strategy=strategy)
    step = ctr_step_fn(emb, tower, opt, DEVICE)
    ids, dense, label = ctr_records(100 + rank, PS_STEPS * CTR_BATCH,
                                    id_offset=rank * (CTR_VOCAB // 2))
    losses = []
    for i in range(PS_STEPS):
        sl = slice(i * CTR_BATCH, (i + 1) * CTR_BATCH)
        batch = {"dense": dense[sl], "label": label[sl, None],
                 **{f"C{j + 1}": ids[sl, j:j + 1]
                    for j in range(CTR_SPARSE)}}
        losses.append(step(batch))
        emb.step()
    fleet.stop_worker()
    dist.collective.barrier()
    res = {"rank": rank, "losses": losses,
           "device": str(tower.parameters()[0]._value.device)}
    if rank == 0:
        other, _, _ = ctr_records(101, CTR_BATCH,
                                  id_offset=CTR_VOCAB // 2)
        rows = runtime.get_client().pull_sparse("ctr", np.unique(other),
                                                create=False)
        res["other_rows_nonzero"] = float((np.abs(rows).sum(1) > 0).mean())
        res["table_size"] = runtime.get_client().table_size("ctr")
    dist.collective.barrier()
    if rank == 0:
        runtime.shutdown_servers()
    with open(os.path.join(out_dir, f"trainer{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.gloo.shutdown()
    return 0


def fleet_ps_service_arm(work) -> dict:
    """(b) 2 PSServer processes on the host, 2 trainers on the card
    started by ``distributed.launch`` (geo, k PS_K_STEPS)."""
    root = os.path.dirname(os.path.abspath(__file__))
    me = os.path.abspath(__file__)
    servers = ",".join(f"127.0.0.1:{_free_port()}" for _ in range(2))
    env = dict(os.environ, PADDLE_PSERVERS_IP_PORT_LIST=servers,
               PADDLE_DIST_BACKEND="gloo",
               PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    for k in ("PADDLE_TRAINER_ENDPOINTS", "PADDLE_TRAINERS_NUM",
              "PADDLE_TRAINER_ID"):
        env.pop(k, None)
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, me, "--ps-child", "server", work],
        env=dict(env, TRAINING_ROLE="PSERVER", PADDLE_PSERVER_ID=str(i)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(2)]
    try:
        r = subprocess.run(
            [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
             "--nproc_per_node=2", f"--started_port={_free_port()}",
             f"--gloo_port={_free_port()}", "--log_dir",
             os.path.join(work, "logs"), me, "--ps-child", "trainer", work],
            env=dict(env, TRAINING_ROLE="TRAINER"), cwd=root,
            capture_output=True, text=True, timeout=600)
        logs = ""
        logdir = os.path.join(work, "logs")
        if os.path.isdir(logdir):
            for name in sorted(os.listdir(logdir)):
                with open(os.path.join(logdir, name)) as f:
                    logs += f"\n--- {name}\n{f.read()[-3000:]}"
        if r.returncode != 0:
            raise AssertionError(f"fleet_ps service: launch rc "
                                 f"{r.returncode}\n{r.stderr[-2000:]}{logs}")
        for p in procs:
            _, err = p.communicate(timeout=120)
            if p.returncode != 0:
                raise AssertionError(f"fleet_ps service: server rc "
                                     f"{p.returncode}\n{err[-2000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    wall = time.perf_counter() - t0
    ranks, srv = [], []
    for i in range(2):
        with open(os.path.join(work, f"trainer{i}.json")) as f:
            ranks.append(json.load(f))
        with open(os.path.join(work, f"server{i}.json")) as f:
            srv.append(json.load(f))
    res = {"wall_s": wall, "steps": PS_STEPS, "k_steps": PS_K_STEPS,
           "servers": srv,
           "trainers": [{"rank": t["rank"], "device": t["device"],
                         "loss_first10": float(np.mean(t["losses"][:10])),
                         "loss_last10": float(np.mean(t["losses"][-10:]))}
                        for t in ranks],
           "rank0_reads_rank1_rows_nonzero": ranks[0]["other_rows_nonzero"],
           "table_size": ranks[0]["table_size"]}
    for t in res["trainers"]:
        if not (t["loss_last10"] < t["loss_first10"]
                and t["device"].startswith(DEVICE)):
            raise AssertionError(f"fleet_ps service: trainer {t}")
    if not ranks[0]["other_rows_nonzero"] > 0.9:
        raise AssertionError(f"fleet_ps service: rank 0 read rank 1's rows "
                             f"{ranks[0]['other_rows_nonzero']}")
    if any(s["cuda_initialized"] for s in srv):
        raise AssertionError("fleet_ps service: a server made a CUDA context")
    return res


def _bert_loss(model, ids, mask, y):
    from paddle_tpu_torch.nn import functional as F

    with amp_context("bfloat16"):
        logits = model(ids, None, mask)
    return F.cross_entropy(logits.astype("float32"), y)


def _bert_params(model):
    return {n: p._value.detach().float().clone()
            for n, p in model.named_parameters()}


def fleet_collective_arm() -> dict:
    """(c) bert-base B 32 x S 128, bf16 under auto_cast: fleet.init
    (collective), distributed_model, distributed_optimizer(AdamW) with
    gradient merge, RecomputeSequential, DGC."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import nn, optimizer
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet.meta_optimizers import \
        DGCOptimizer
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.distributed.fleet.recompute import \
        RecomputeSequential
    from paddle_tpu_torch.text.models import BertForSequenceClassification

    pt.set_device(DEVICE)
    n = BERT_BATCH * FLEET_BERT_MICRO
    ids_np, mask_np, y_np = bert_inputs(np.random.RandomState(3), n)
    micro = [tuple(pt.to_tensor(a[i * BERT_BATCH:(i + 1) * BERT_BATCH])
                   for a in (ids_np, mask_np, y_np))
             for i in range(FLEET_BERT_MICRO)]
    make = seeded(BertForSequenceClassification, **DIST_BERT)
    layers = DIST_BERT["num_hidden_layers"]
    res = {}

    # gradient merge through the facade against plain AdamW on the
    # gradients averaged by hand
    strategy = fleet.DistributedStrategy()
    strategy.gradient_merge = True
    strategy.gradient_merge_configs.k_steps = FLEET_GM_K
    strategy.gradient_merge_configs.avg = True
    fleet.init(is_collective=True, strategy=strategy)
    model = fleet.distributed_model(make())
    opt = fleet.distributed_optimizer(
        optimizer.AdamW(DIST_LR, parameters=model.parameters()))
    gm_losses, launches = [], []
    for ids, mask, y in micro:
        reset_flash_counts()
        loss = _bert_loss(model, ids, mask, y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        gm_losses.append(float(loss.numpy()))
        launches.append(read_flash_counts())
    gm_params = _bert_params(model)
    del model, opt
    free_cuda()
    ref = make()
    ref_opt = optimizer.AdamW(DIST_LR, parameters=ref.parameters())
    ref_losses = []
    for i, (ids, mask, y) in enumerate(micro):
        loss = _bert_loss(ref, ids, mask, y)
        loss.backward()
        ref_losses.append(float(loss.numpy()))
        if (i + 1) % FLEET_GM_K == 0:
            with torch.no_grad():
                for p in ref.parameters():
                    if p._value.grad is not None:
                        p._value.grad.mul_(1.0 / FLEET_GM_K)
            ref_opt.step()
            ref_opt.clear_grad()
    diffs = {k: float((v - gm_params[k]).abs().max())
             for k, v in _bert_params(ref).items()}
    worst = max(diffs, key=diffs.get)
    res["gradient_merge"] = {
        "losses": gm_losses, "plain_losses": ref_losses,
        "param_max_abs_diff": diffs[worst], "param_worst": worst,
        "param_atol": FLEET_GM_PARAM_ATOL,
        "loss_rtol": FLEET_GM_LOSS_RTOL, "launches_per_micro_step": launches}
    for i, c in enumerate(launches):
        expect_counts(f"fleet_ps_gm_micro{i}", c, {
            "flash_fwd": layers, "flash_dkv": layers, "flash_dq": layers,
            "flash_ref": 0, "flash_tc_fwd": layers, "flash_tc_dkv": layers,
            "flash_tc_dq": layers})
    if not close_losses(gm_losses, ref_losses, FLEET_GM_LOSS_RTOL):
        raise AssertionError(f"fleet_ps gradient merge: {gm_losses} vs "
                             f"{ref_losses}")
    if not diffs[worst] <= FLEET_GM_PARAM_ATOL:
        raise AssertionError(f"fleet_ps gradient merge: {worst} differs by "
                             f"{diffs[worst]}")

    # RecomputeSequential over the encoder layers against the plain
    # backward (no padding mask: the sequential hands each layer x only)
    ids, _, y = micro[0]
    grads, counts = {}, {}
    for tag in ("plain", "recompute"):
        reset_flash_counts()
        bert = ref.bert
        with amp_context("bfloat16"):
            x = bert.embeddings(ids)
            stack = nn.Sequential(*bert.encoder.layers)
            x = stack(x) if tag == "plain" else RecomputeSequential(stack)(x)
            logits = ref.classifier(F.tanh(bert.pooler(x[:, 0])))
        F.cross_entropy(logits.astype("float32"), y).backward()
        counts[tag] = read_flash_counts()
        grads[tag] = {n: p._value.grad.float().clone()
                      for n, p in ref.named_parameters()
                      if p._value.grad is not None}
        ref_opt.clear_grad()
    rel = {n: float((grads["recompute"][n] - g).norm()
                    / max(float(g.norm()), 1e-12))
           for n, g in grads["plain"].items()}
    worst = max(rel, key=rel.get)
    res["recompute"] = {"launches": counts, "grad_rel_l2_max": rel[worst],
                        "grad_worst": worst,
                        "rel_l2_limit": FLEET_RECOMPUTE_REL_L2}
    expect_counts("fleet_ps_recompute", counts["recompute"], {
        "flash_fwd": 2 * layers, "flash_dkv": layers, "flash_dq": layers,
        "flash_ref": 0, "flash_tc_fwd": 2 * layers})
    expect_counts("fleet_ps_plain_backward", counts["plain"], {
        "flash_fwd": layers, "flash_dkv": layers, "flash_dq": layers,
        "flash_ref": 0})
    if set(grads["plain"]) != set(grads["recompute"]) or \
            rel[worst] > FLEET_RECOMPUTE_REL_L2:
        raise AssertionError(f"fleet_ps recompute: {worst} {rel[worst]}")

    # DGC: kept + residual = the accumulated gradient, no host sync
    dgc = DGCOptimizer(optimizer.AdamW(DIST_LR, parameters=ref.parameters()),
                       sparsity=FLEET_DGC_SPARSITY)
    owners = dgc.inner._owners()
    worst_err, kept_frac, step_syncs = 0.0, [], []
    for ids, mask, y in micro[:2]:
        _bert_loss(ref, ids, mask, y).backward()
        params = [p for p in dgc.inner._param_list() if p.grad is not None]
        acc = [p.grad + dgc._residual.get(owners[id(p)].name,
                                          torch.zeros_like(p.grad))
               for p in params]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            pairs = [dgc.sparsify(p.grad, dgc._residual.get(
                owners[id(p)].name, torch.zeros_like(p.grad)))
                for p in params]
        finally:
            torch.cuda.set_sync_debug_mode(0)
        for p, a, (kept, r) in zip(params, acc, pairs):
            worst_err = max(worst_err, float((kept + r - a).abs().max()))
            kept_frac.append(float((kept != 0).float().mean()))
        # the whole step (the sparsify pass, then AdamW): no sync either
        step_syncs.append(_synced(dgc.step)[1])
        dgc.clear_grad()
    res["dgc"] = {"sparsity": FLEET_DGC_SPARSITY,
                  "kept_plus_residual_max_abs_err": worst_err,
                  "kept_fraction_mean": float(np.mean(kept_frac)),
                  "syncs_in_whole_step": step_syncs}
    if worst_err != 0.0:
        raise AssertionError(f"fleet_ps dgc: kept + residual off by "
                             f"{worst_err}")
    if any(step_syncs):
        raise AssertionError(f"fleet_ps dgc: the step synced the host "
                             f"{step_syncs} times")
    del ref, ref_opt, dgc
    free_cuda()
    return res


def fleet_sharding_arm() -> dict:
    """(d) ShardingOptimizer over dp 4 on 4 slots of the card: bert-base's
    AdamW accumulators split over dp where dim 0 divides."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed import mesh as dmesh
    from paddle_tpu_torch.text.models import BertForSequenceClassification

    model = seeded(BertForSequenceClassification, **DIST_BERT)()
    strategy = fleet.DistributedStrategy()
    strategy.sharding = True
    fleet.init(is_collective=True, strategy=strategy)
    prev = dmesh.force_device_count(4)
    try:
        dmesh.init_mesh({"dp": 4})
        opt = fleet.distributed_optimizer(
            optimizer.AdamW(DIST_LR, parameters=model.parameters()))
        state = opt.init_opt_state({n: p._value for n, p in
                                    model.named_parameters()})
        split = replicated = 0
        bad = []
        slot_bytes = [0, 0, 0, 0]
        for kind, accs in state.items():
            for name, sa in accs.items():
                d0 = sa.shape[0] if len(sa.shape) else 1
                want = ("dp",) if len(sa.shape) and d0 % 4 == 0 else ()
                shard0 = tuple(sa.shards[0].shape)
                ok = (tuple(sa.spec) == want and len(sa.shards) == 4
                      and all(s.device.type == DEVICE for s in sa.shards)
                      and (shard0[0] == d0 // 4 if want else
                           shard0 == tuple(sa.shape)))
                if not ok:
                    bad.append((kind, name, tuple(sa.spec), sa.shape))
                split += bool(want)
                replicated += not want
                for i, s in enumerate(sa.shards):
                    slot_bytes[i] += s.numel() * s.element_size()
    finally:
        dmesh.force_device_count(prev)
    res = {"accumulators_split": split, "accumulators_replicated":
           replicated, "slot_bytes": slot_bytes}
    if bad or not split or not replicated:
        raise AssertionError(f"fleet_ps sharding: {bad[:5]} {res}")
    del model, opt, state
    free_cuda()
    return res


def fleet_static_arm(work) -> dict:
    """(e) Executor.train_from_dataset on a recorded Program (the dense
    features' linear regression of the label, SGD) fed by an
    InMemoryDataset, against the port's eager loop on the same batches."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import nn, optimizer, static
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.io.multislot import Slot, write_multislot_file
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.nn import state_from_numpy

    pt.set_device(DEVICE)
    _, dense, label = ctr_records(77, STATIC_DS_RECORDS)
    slots = [Slot("dense", "float32", is_dense=True, dim=CTR_DENSE),
             Slot("label", "float32", is_dense=True, dim=1)]
    path = os.path.join(work, "static.txt")
    write_multislot_file(path, ({"dense": d, "label": [lab]} for d, lab in
                                zip(np.char.mod("%.4f", dense).tolist(),
                                    label.tolist())), slots)
    ds = fleet.InMemoryDataset()
    ds.set_slots(slots)
    ds.set_filelist([path])
    ds.set_batch_size(CTR_BATCH)
    ds.load_into_memory()
    pt.seed(5)
    lin = nn.Linear(CTR_DENSE, 1)
    state = {k: v.numpy() for k, v in lin.state_dict().items()}
    main = static.Program()
    with static.program_guard(main):
        x = static.data("dense", [CTR_BATCH, CTR_DENSE], "float32")
        y = static.data("label", [CTR_BATCH, 1], "float32")
        loss = F.mse_loss(lin(x), y)
        optimizer.SGD(0.05, parameters=lin.parameters()).minimize(loss)
    got = static.Executor().train_from_dataset(main, ds,
                                               fetch_list=[loss])["losses"]
    pt.seed(5)
    eager = nn.Linear(CTR_DENSE, 1)
    eager.set_state_dict(state_from_numpy(state, DEVICE))
    opt = optimizer.SGD(0.05, parameters=eager.parameters())
    want = []
    for b in ds.iter_batches():
        out = F.mse_loss(eager(pt.to_tensor(b["dense"])),
                         pt.to_tensor(b["label"]))
        out.backward()
        opt.step()
        opt.clear_grad()
        want.append(float(out.numpy()))
    res = {"batches": len(got), "losses_first3": got[:3],
           "losses_last3": got[-3:],
           "max_abs_diff": float(np.max(np.abs(np.subtract(got, want))))}
    if len(got) != len(want) or not close_losses(got, want, 1e-5):
        raise AssertionError(f"fleet_ps static: {got} vs {want}")
    return res


def fleet_ps_phase() -> dict:
    """Phase 40: arms (a)-(e) (the module docstring)."""
    import shutil
    import tempfile

    work = tempfile.mkdtemp(prefix="chip_smoke_fleet_")
    res = {}
    try:
        for name, arm in (("ctr", lambda: fleet_ctr_arm(work)),
                          ("ps_service",
                           lambda: fleet_ps_service_arm(work)),
                          ("collective", fleet_collective_arm),
                          ("sharding", fleet_sharding_arm),
                          ("static_dataset", lambda: fleet_static_arm(work))):
            t0 = time.perf_counter()
            res[name] = arm()
            res[name]["seconds"] = time.perf_counter() - t0
            log("fleet_ps", arm=name, **res[name])
            free_cuda()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return res


# the prefill form's layout, shared by #1 / #1q (Qb >= 16) and the stats
# kernel
PREFILL_FORM = ("prefill form: a block of 16 rows of a (lane, head), 8 warps "
                "in 4 groups of 64 threads, tiles of 64 positions (32 at "
                "D > 64) staged once a block by cp.async into a two-stage "
                "ring, S = QK^T and O += PV in 4 x 4 register micro-tiles; "
                "#1 walks the lane's table, #3 its owned pages")


def decode_form(D, item, Qb, M, P) -> dict:
    """The decode form's layout for a call, as the kernel library reports
    it (``ptt_paged_decode_layout``, the launch's own rule)."""
    import ctypes

    from paddle_tpu_torch.ops import _build

    vals = [ctypes.c_int() for _ in range(3)]
    _build.load_library("paged_attention").ptt_paged_decode_layout(
        D, item, Qb, M, P, *map(ctypes.byref, vals))
    cs, warps, rows = (v.value for v in vals)
    return {"form": "decode", "D": D, "pool_item_bytes": item, "Qb": Qb,
            "M": M, "P": P, "cluster_ctas": cs, "warps_per_cta": warps,
            "rows_per_cta": rows,
            "grid": f"(G x {cs}, H, ceil(Qb / {rows}))",
            "block_threads": 32 * warps}


def record(name, source, replaces, launches, t, **extra):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            **{k: t[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                 "bound_by", "library_ms")}, **extra}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="also write every phase's result to this JSON file")
    ap.add_argument("--localsgd-child", default=None, metavar="DIR",
                    help=argparse.SUPPRESS)
    ap.add_argument("--ps-child", nargs=2, default=None,
                    metavar=("MODE", "DIR"), help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.ps_child and args.ps_child[0] == "server":
        # a PS server holds host memory only: no CUDA call at all
        return ps_child(*args.ps_child)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    if args.localsgd_child:
        return localsgd_child(args.localsgd_child)
    if args.ps_child:
        return ps_child(*args.ps_child)

    # f32 parity: no TF32 anywhere (matmuls and cuDNN)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.text.models import GPTModel

    card = card_line()
    t0 = time.perf_counter()
    _build.load_libraries()
    log("env", card=card, torch=torch.__version__, cuda=torch.version.cuda,
        device=torch.cuda.get_device_name(0),
        build_s=time.perf_counter() - t0,
        builds={name: {"seconds": b["seconds"], "cached": b["cached"],
                       "ptxas": [ln for ln in b["ptxas"]
                                 if "registers" in ln or "spill" in ln]}
                for name, b in _build.build_log.items()},
        stats_prefill_ptxas=entry_ptxas(
            _build.build_log["paged_attention_stats"]["ptxas"],
            "stats_prefill_kernel"),
        flash_f32tc_ptxas=entry_ptxas(
            _build.build_log["flash_attention"]["ptxas"], "f32tc_kernel"),
        # the paged kernels' D 256 instances (DC 8: "Li8ELb" in the warp
        # form's mangled name, "Li8EEEv" in the per-row kernel's and the
        # prefill form's)
        paged_dc8_ptxas={
            name: {k: v for k, v in entry_ptxas(
                _build.build_log[name]["ptxas"], "kernel").items()
                   if "Li8ELb" in k or "Li8EEEv" in k}
            for name in ("paged_attention", "paged_decode",
                         "paged_attention_stats")})

    rng = np.random.RandomState(0)
    report = {"card": card}
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32,
                        device="cuda")                     # 256 MB
    report["kernel"] = native_t = kernel_phase(rng, flush)
    report["kernel_int8"] = int8_t = int8_kernel_phase(rng, flush)
    report["kernel_qmm"] = qmm_t = qmm_phase(rng, flush)
    report["kernel_flash"] = flash_t = flash_kernel_phase(rng, flush)
    report["kernel_decode"] = decode_t = decode_kernel_phase(rng, flush)
    report["kernel_stats"] = stats_t = stats_kernel_phase(rng, flush)
    # row t draws from its own seed, so the phases after it see the same
    # draws as before it existed
    report["kernel_scale_shift"] = ss_t = scale_shift_kernel_phase(
        np.random.RandomState(6), flush)
    del flush
    free_cuda()
    # the training drive's batch comes from its own seed, so its loss
    # trajectory does not depend on what the phases before it drew
    report["train"] = train = train_phase(np.random.RandomState(0))
    free_cuda()
    report["train_bf16"] = train_bf16 = train_phase(
        np.random.RandomState(0), "bfloat16", "train_bf16")
    free_cuda()
    report["train_parity"] = train_parity_phase(rng)
    free_cuda()
    # its own seed, so the phases after it see the draws of before
    report["train_parity_bf16"] = train_parity_bf16_phase(
        np.random.RandomState(7))
    free_cuda()
    report["custom_op"] = custom = custom_op_phase()
    report["lenet"] = lenet_phase()
    free_cuda()
    # its own seed, so the phases after it see the draws of before
    report["fit"] = fit = fit_phase(np.random.RandomState(10))
    free_cuda()
    report["resnet"] = resnet_phase()
    free_cuda()
    report["bert"] = bert = bert_phase()
    free_cuda()
    new_phase_s = {}
    for name, phase in (("anomaly", anomaly_phase),
                        ("amp_fp16", amp_fp16_phase),
                        ("o2", lambda: o2_phase(fit)),
                        ("eager_api", eager_api_phase),
                        ("eager_nn", eager_nn_phase),
                        ("declarative", declarative_phase),
                        ("distributed", distributed_phase),
                        ("fleet_ps", fleet_ps_phase)):
        t0 = time.perf_counter()
        report[name] = phase()
        new_phase_s[name] = time.perf_counter() - t0
        free_cuda()
    log("phase_seconds", **new_phase_s, total=sum(new_phase_s.values()))
    amp16 = report["amp_fp16"]
    dist = report["distributed"]
    fleet = report["fleet_ps"]

    t0 = time.perf_counter()
    model = GPTModel(**GPT2_SMALL, device="cuda", seed=1234)
    torch.cuda.synchronize()
    log("model", init_s=time.perf_counter() - t0)
    prompts = [rng.randint(1, GPT2_SMALL["vocab_size"], (n,)).astype(
        np.int32) for n in PROMPT_LENS]
    report["e2e"] = e2e = e2e_phase(model, prompts)
    free_cuda()
    report["e2e_int8_static"], export = e2e_int8_static_phase(
        model, prompts, rng, e2e)
    st = report["e2e_int8_static"]
    free_cuda()
    report["e2e_int8_dynamic"] = e2e_int8_dynamic_phase(model, prompts[:4])
    free_cuda()
    report["e2e_split"] = split = e2e_split_phase(
        model, prompts, export, e2e["step_ms"]["p50"])
    report["e2e_spec"] = e2e_spec_phase(model, spec_prompts(rng))
    free_cuda()
    report["e2e_mesh"] = mesh = e2e_mesh_phase(model, rng, export)
    free_cuda()
    # both draw from their own seeds, so the phases after them see the
    # draws of before
    report["e2e_prefix"] = prefix = e2e_prefix_phase(model, export)
    free_cuda()
    report["e2e_tiers"] = tiers = e2e_tiers_phase(model, export)
    free_cuda()
    report["e2e_snapshot"] = snap = e2e_snapshot_phase(model, prompts,
                                                       export)
    free_cuda()
    report["sync_free"] = sync_free_phase(model, prompts, export)
    free_cuda()
    report["e2e_frontend"] = front = e2e_frontend_phase(
        model, prompts, export,
        [np.asarray(x, np.int32) for x in e2e["streams"]],
        [np.asarray(x, np.int32) for x in st["streams"]])
    free_cuda()
    report["e2e_profile"] = e2e_profile_phase(
        model, prompts, [np.asarray(x, np.int32) for x in e2e["streams"]])
    free_cuda()
    # its own seed, as row t's phase
    report["e2e_beam"] = beam = e2e_beam_phase(model,
                                               np.random.RandomState(9))
    del model
    free_cuda()
    # its own seed, as row t's phase
    report["e2e_wide"] = wide = e2e_wide_phase(np.random.RandomState(8))
    free_cuda()
    report["seq_layers"] = seq = seq_layers_phase()
    seq_launches = {
        "fwd": {"transformer_forward": seq["transformer"]["launches"][
            "flash_fwd"], "encoder_layer_forward": seq["encoder_backward"][
            "launches"]["flash_fwd"]},
        "dkv": {"encoder_layer_backward": seq["encoder_backward"][
            "launches"]["flash_dkv"]},
        "dq": {"encoder_layer_backward": seq["encoder_backward"][
            "launches"]["flash_dq"]}}

    dec = native_t["gpt2_decode/float32/Qb1"]
    idec = int8_t["gpt2_decode/float32/Qb1/fused_dequant=1"]
    qdec = qmm_t["fc1_768x3072/M8/float32"]
    flash_src = "paddle_tpu_torch/ops/csrc/flash_attention.cu"
    flash_tpu = "paddle_tpu/ops/pallas_ops/flash_attention.py"
    kernels = [
        record("ragged_paged_attention",
               "paddle_tpu_torch/ops/csrc/paged_attention.cu",
               "paddle_tpu/ops/pallas_ops/paged_attention.py:520",
               e2e["attention_cuda"], dec,
               launches_prefix=prefix["native"]["on"]["launches"][
                   "attention_cuda"],
               launches_snapshot_restore=snap["native"]["launches"][
                   "attention_cuda"],
               launches_frontend_fleet=front["fleet"]["launches"][
                   "attention_cuda"],
               launches_tiers={k: tiers[k]["on"]["launches"][
                   "attention_cuda"] for k in ("native_host",
                                               "native_disk")},
               bf16_max_abs_err=native_t["bf16_max_abs_err"],
               d256_decode=native_t["d256_decode/float32/Qb1"],
               d256_prefill=native_t["d256_prefill/float32/Qb64"],
               launches_d256=wide["native"]["attention_cuda"],
               prefill=native_t["gpt2_prefill/float32/Qb64"],
               forms={"decode": decode_form(64, 4, 1, 64, 16),
                      "decode_d256": decode_form(256, 4, 1, 64, 16),
                      "prefill": PREFILL_FORM},
               lane_equal_alone={k: v["lane_equal_alone"]
                                 for k, v in native_t.items()
                                 if isinstance(v, dict)}),
        record("ragged_paged_attention_int8",
               "paddle_tpu_torch/ops/csrc/paged_attention.cu",
               "paddle_tpu/ops/pallas_ops/paged_attention.py:461",
               st["attention_cuda_int8"], idec, fused_dequant=1,
               launches_prefix=prefix["int8_static"]["on"]["launches"][
                   "attention_cuda_int8"],
               launches_frontend_disaggregated=front["disaggregated_int8"][
                   "launches"]["attention_cuda_int8"],
               launches_tiers=tiers["int8_static_host"]["on"]["launches"][
                   "attention_cuda_int8"],
               settings={k: v for k, v in int8_t.items()
                         if "fused_dequant=" in k},
               nan_scale_ok=int8_t["nan_scale_ok"],
               bf16_max_abs_err=int8_t["bf16_max_abs_err"],
               d256_decode=int8_t["d256_decode/float32/Qb1/fused_dequant=1"],
               d256_prefill=int8_t[
                   "d256_prefill/float32/Qb64/fused_dequant=1"],
               launches_d256=wide["int8_static"]["attention_cuda_int8"],
               forms={"decode": decode_form(64, 1, 1, 64, 16),
                      "decode_d256": decode_form(256, 1, 1, 64, 16),
                      "prefill": PREFILL_FORM},
               lane_equal_alone={k: v["lane_equal_alone"]
                                 for k, v in int8_t.items()
                                 if isinstance(v, dict)}),
        record("quantized_matmul",
               "paddle_tpu_torch/ops/csrc/quantized_matmul.cu",
               "paddle_tpu/ops/pallas_ops/quantized_matmul.py:104",
               st["qmm_cuda"], qdec, case="fc1_768x3072/M8/float32",
               launches_frontend_disaggregated=front["disaggregated_int8"][
                   "launches"]["qmm_cuda"],
               launches_e2e_beam=beam["int8"]["qmm_cuda"],
               launches_eager_api=report["eager_api"]["weight_only_matmul"][
                   "launches"]["cuda"],
               cases=qmm_t),
    ] + [
        record(f"flash_attention_{kname}", flash_src, f"{flash_tpu}:{line}",
               train[f"flash_{kname}"], flash_t[f"{kname}/train/float32"],
               case="B8 H12 S1024 D64 causal, float32",
               design=FLASH_F32TC_DESIGN[kname],
               launches_f32tc=train[f"flash_f32tc_{kname}"],
               launches_seq_layers=seq_launches[kname],
               launches_fit={mode: fit[mode][f"flash_f32tc_{kname}"]
                             for mode in ("graphed", "eager")},
               launches_bert_route_check=bert["route_check"]["launches"][
                   f"flash_f32tc_{kname}"],
               launches_distributed={
                   "bert_dp2_mp2_a_step": dist["bert"]["dp2_mp2"][
                       "launches_per_step"][-1][f"flash_f32tc_{kname}"],
                   "ring": {c: r["launches"][f"flash_f32tc_{kname}"]
                            for c, r in dist["ring"].items()
                            if c.endswith("float32")},
                   "ring_train": dist["ring"]["train"]["launches"][
                       f"flash_f32tc_{kname}"]},
               bound_cuda_core_ms=flash_t[f"{kname}/train/float32"][
                   "bound_cuda_core_ms"],
               launches_predictor={
                   k: v["flash_f32tc"][kname]
                   for k, v in report["declarative"]["serve"].items()
                   if isinstance(v, dict) and "flash_f32tc" in v},
               bfloat16=dict(flash_t[f"{kname}/train/bfloat16"],
                             launches_train_bf16=train_bf16[
                                 f"flash_{kname}"]),
               max_abs_err_by_case={c: e[kname] for c, e in
                                    flash_t["max_abs_err"].items()},
               dropout_bits_exact=flash_t["bits_exact"][kname])
        for kname, line in (("fwd", 289), ("dkv", 332), ("dq", 377))] + [
        record(f"flash_attention_{kname}_bf16_tc", flash_src,
               f"{flash_tpu}:{line}", train_bf16[f"flash_tc_{kname}"],
               flash_t[f"{kname}/train/bfloat16"],
               case="B8 H12 S1024 D64 causal, bfloat16",
               design=FLASH_TC_DESIGN[kname],
               launches_bert={mode: bert[mode][f"flash_tc_{kname}"]
                              for mode in ("bench_graphed", "bench_eager",
                                           "fit_graphed", "fit_eager")},
               launches_distributed_ring={
                   c: r["launches"][f"flash_tc_{kname}"]
                   for c, r in dist["ring"].items()
                   if c.endswith("bfloat16")},
               bert_base_s128=flash_t[f"{kname}/bert_base_s128/bfloat16"],
               launches_to_static=sum(
                   c[f"flash_tc_{kname}"] for c in report["declarative"][
                       "to_static_train"]["to_static"]["launches"]),
               launches_fleet_ps={
                   "gradient_merge_micro_step": fleet["collective"][
                       "gradient_merge"]["launches_per_micro_step"][-1][
                       f"flash_tc_{kname}"],
                   "recompute_backward": fleet["collective"]["recompute"][
                       "launches"]["recompute"][f"flash_tc_{kname}"]},
               max_abs_err_by_case={c: e[kname] for c, e in
                                    flash_t["max_abs_err"].items()
                                    if c.endswith("bfloat16")},
               dropout_bits_exact=flash_t["bits_exact_bf16"][kname])
        for kname, line in (("fwd", 289), ("dkv", 332), ("dq", 377))] + [
        record(f"flash_attention_{kname}_fp16_tc", flash_src,
               f"{flash_tpu}:{line}", amp16["launches"][f"flash_fp16_{kname}"],
               flash_t[f"{kname}/train/float16"],
               case="B8 H12 S1024 D64 causal, float16",
               design=FLASH_FP16_DESIGN[kname],
               launches_is="BERT-base B32 x S128 under auto_cast(float16) "
                           "with GradScaler, the amp_fp16 phase's main run",
               bert_base_s128=flash_t[f"{kname}/bert_base_s128/float16"],
               max_abs_err_by_case={c: e[kname] for c, e in
                                    flash_t["max_abs_err"].items()
                                    if c.endswith("float16")},
               dropout_bits_exact=flash_t["bits_exact_fp16"][kname])
        for kname, line in (("fwd", 289), ("dkv", 332), ("dq", 377))] + [
        record("paged_attention",
               "paddle_tpu_torch/ops/csrc/paged_decode.cu",
               "paddle_tpu/ops/pallas_ops/paged_attention.py:122",
               split["split"]["attention_cuda_decode"],
               decode_t["gpt2_decode/float32"],
               case="gpt2_decode/float32",
               launches_prefix=prefix["split"]["on"]["launches"][
                   "attention_cuda_decode"],
               prefill_chunk=decode_t["gpt2_chunk/float32"],
               d256_decode=decode_t["d256_decode/float32"],
               bf16_max_abs_err=decode_t["bf16_max_abs_err"],
               launches_by_drive={k: v["attention_cuda_decode"]
                                  for k, v in split.items()},
               forms={"decode": decode_form(64, 4, 1, 64, 16),
                      "decode_d256": decode_form(256, 4, 1, 64, 16),
                      "is": "#1's decode form at one row a lane (G = B, "
                            "Qb = 1, row_lens = seq_lens)"},
               lane_equal_alone={k: v["lane_equal_alone"]
                                 for k, v in decode_t.items()
                                 if isinstance(v, dict)}),
        record("paged_attention_int8",
               "paddle_tpu_torch/ops/csrc/paged_decode.cu",
               "paddle_tpu/ops/pallas_ops/paged_attention.py:173",
               split["split_int8"]["attention_cuda_decode_int8"],
               decode_t["gpt2_decode/float32/int8/fused_dequant=1"],
               case="gpt2_decode/float32/int8", fused_dequant=1,
               settings={k: v for k, v in decode_t.items()
                         if "/int8/" in k},
               nan_scale_ok=decode_t["nan_scale_ok"],
               bf16_max_abs_err=decode_t["int8_bf16_max_abs_err"],
               d256_decode=decode_t[
                   "d256_decode/float32/int8/fused_dequant=1"],
               launches_spec_int8_dynamic=report["e2e_spec"][
                   "ragged_int8_dynamic"]["attention_cuda_decode_int8"],
               forms={"decode": decode_form(64, 1, 1, 64, 16),
                      "decode_d256": decode_form(256, 1, 1, 64, 16),
                      "is": "#1q's decode form at one row a lane"}),
        record("ragged_paged_attention_stats",
               "paddle_tpu_torch/ops/csrc/paged_attention_stats.cu",
               "paddle_tpu/ops/pallas_ops/paged_attention.py:681",
               mesh["native"]["attention_cuda_stats"],
               stats_t["decode_h12/float32"], case="decode_h12/float32",
               launches_snapshot_restore=snap["single_to_mesh"]["launches"][
                   "attention_cuda_stats"],
               prefill=stats_t["prefill_h12/float32"],
               prefill_h6=stats_t["prefill_h6/float32"],
               d256_decode=stats_t["d256_decode/float32"],
               d256_prefill=stats_t["d256_prefill/float32"],
               forms="warp form below 16 rows a lane, prefill form from 16; "
                     "both walk the lane's owned pages",
               bf16_max_abs_err=stats_t["bf16_max_abs_err"],
               max_abs_err_by_case={
                   k: v for k, v in stats_t["max_abs_err_by_case"].items()
                   if "int8" not in k},
               library_is="aten._scaled_dot_product_efficient_attention "
                          "with its log-sum-exp, on the gathered owned KV"),
        record("ragged_paged_attention_stats_int8",
               "paddle_tpu_torch/ops/csrc/paged_attention_stats.cu",
               "paddle_tpu/ops/pallas_ops/paged_attention.py:737",
               mesh["int8_static"]["attention_cuda_stats_int8"],
               stats_t["decode_h12/float32/int8/fused_dequant=1"],
               case="decode_h12/float32/int8", fused_dequant=1,
               settings={k: v for k, v in stats_t.items()
                         if "/int8/" in k},
               nan_scale_ok=stats_t["nan_scale_ok"],
               bf16_max_abs_err=stats_t["int8_bf16_max_abs_err"],
               d256_decode=stats_t[
                   "d256_decode/float32/int8/fused_dequant=1"],
               d256_prefill=stats_t[
                   "d256_prefill/float32/int8/fused_dequant=1"],
               max_abs_err_by_case={
                   k: v for k, v in stats_t["max_abs_err_by_case"].items()
                   if "int8" in k},
               library_is="aten._scaled_dot_product_efficient_attention "
                          "with its log-sum-exp, on the gathered owned, "
                          "dequantized KV"),
        record("scale_shift", "paddle_tpu_torch/ops/csrc/scale_shift.cu",
               "tests/test_custom_op.py:94",
               custom["scale_shift_launches"]["cuda"],
               ss_t["16x8/float32"], case="16x8/float32",
               large={k: v for k, v in ss_t.items() if "8192" in k},
               bf16=ss_t["16x8/bfloat16"],
               library_is="torch.addcmul(shift, x, scale)")]
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({**report, "kernels": kernels}, f, indent=1,
                      default=str)
    print(card)
    print(json.dumps({"kernels": kernels}, default=str))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
