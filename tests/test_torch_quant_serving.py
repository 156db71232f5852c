"""paddle_tpu_torch int8 serving (int8 KV pages + weight-only int8) vs the
JAX package.

- the slim bridge: the port quantizes weights to the JAX export's exact
  bytes and calibrates the same KV scales; a JAX export loads unchanged;
- one int8 ragged step (static and dynamic scales) against paddle_tpu's
  step on identical inputs;
- ``generate(quant=...)`` and the int8 engine (static and dynamic, sync
  and pipelined, under forced preemption) stream what paddle_tpu streams;
- knob errors, ``stats()["quant"]``, the KV byte ratio, and the numeric
  quarantine under int8.

Tolerances: tokens and streams exact; the weight export exact (the same
numpy recipe); calibrated KV scales rtol 1e-5 (the same f32 caches up to
backend summation order, 2 layers); one step's int8 pools within one
quantum (a K/V value that differs by a few f32 ulps between the backends
may round to the neighbouring int8), its scales exact (static: never
written) or rtol 1e-6 (dynamic: abs-max / 127 of those values).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.jit.functional import get_state
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu.slim import calibrate_kv_scales as jax_calibrate
from paddle_tpu.slim import export_serving_quant as jax_export
from paddle_tpu.slim import quantize_gpt_weights as jax_quantize
from paddle_tpu.text.generation import (
    make_gpt_paged_ragged_step as jax_ragged_step)
from paddle_tpu_torch.framework.errors import InvalidArgumentError
from paddle_tpu_torch.ops import quantized_matmul as qm
from paddle_tpu_torch.serving import ServingEngine
from paddle_tpu_torch.serving.kv_cache import KV_SCALE_EPS, kv_page_bytes
from paddle_tpu_torch.slim import (calibrate_kv_scales, export_serving_quant,
                                   quantize_gpt_weights)
from paddle_tpu_torch.testing import chaos
from paddle_tpu_torch.text.generation import (RAGGED_NO_LIMIT, generate,
                                              make_gpt_decode_step,
                                              make_gpt_paged_ragged_step)
from paddle_tpu_torch.text.models import GPTModel, load_numpy_state

VOCAB, LAYERS, HEADS, D = 50, 2, 2, 16
ENGINE = dict(page_size=4, max_batch_size=4, prefill_chunk=4, eos_id=0)
LENS = (3, 9, 5, 2, 1, 12)
BUDGET = 10
QUANT_KEY = "torch_quant_serving-calib5"


@pytest.fixture(scope="module")
def port(shared_gpt_small):
    state = {k: np.asarray(v)
             for k, v in get_state(shared_gpt_small)[0].items()}
    m = GPTModel(vocab_size=VOCAB, hidden_size=32, num_layers=LAYERS,
                 num_heads=HEADS, ffn_size=64, max_seq_len=64, device="cpu")
    return load_numpy_state(m, state)


@pytest.fixture(scope="module")
def calib():
    return np.random.RandomState(5).randint(1, VOCAB, (4, 16))


@pytest.fixture(scope="module")
def quant(shared_gpt_small, calib):
    """The JAX package's export: what the port loads unchanged."""
    return jax_export(shared_gpt_small, calib_prompts=calib)


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.RandomState(3)
    return [rng.randint(1, VOCAB, (n,)).astype(np.int32) for n in LENS]


def _truncate(want, end_id=0):
    if (want == end_id).any():
        want = want[: int(np.argmax(want == end_id)) + 1]
    return want


@pytest.fixture(scope="module")
def jax_quant_refs(shared_gpt_small, greedy_ref_memo, quant, prompts):
    """paddle_tpu's ``generate(quant=...)``, truncated after EOS."""
    return [_truncate(greedy_ref_memo(shared_gpt_small, p, BUDGET,
                                      end_id=0, quant=quant,
                                      quant_key=QUANT_KEY))
            for p in prompts]


def _drive(eng, prompts, budget=BUDGET):
    ids = [eng.add_request(p, max_new_tokens=budget) for p in prompts]
    outs = eng.drain()
    return [outs[r] for r in ids]


# =============================================================================
# the slim bridge
# =============================================================================
def test_quantize_gpt_weights_equals_jax_exactly(shared_gpt_small, port,
                                                 quant):
    got = quantize_gpt_weights(port)
    want = jax_quantize(shared_gpt_small)
    assert sorted(got) == sorted(want) == sorted(quant["weights"])
    assert len(got) == 6 * LAYERS
    for name in want:
        assert got[name][0].dtype == np.int8
        assert got[name][0].tobytes() == np.asarray(want[name][0]).tobytes()
        assert got[name][1].tobytes() == np.asarray(want[name][1]).tobytes()


def test_calibrate_kv_scales_matches_jax(shared_gpt_small, port, calib):
    got = calibrate_kv_scales(port, calib, margin=1.5)
    want = jax_calibrate(shared_gpt_small, calib, margin=1.5)
    for side in ("k", "v"):
        assert len(got[side]) == LAYERS
        for g, w in zip(got[side], want[side]):
            assert g.dtype == np.float32 and g.shape == (HEADS,)
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=0)


def test_export_shapes_and_uncalibrated_export_is_dynamic(port, calib):
    ex = export_serving_quant(port, calib_prompts=calib)
    assert ex["weight_dtype"] == ex["kv_cache_dtype"] == "int8"
    assert len(ex["kv_scales"]["k"]) == LAYERS
    bare = export_serving_quant(port)
    assert bare["kv_scales"] is None and bare["weights"] is not None
    assert export_serving_quant(port, weight_dtype=None)["weights"] is None
    with pytest.raises(ValueError, match="weight_dtype"):
        export_serving_quant(port, weight_dtype="int4")


# =============================================================================
# one int8 ragged step vs paddle_tpu's
# =============================================================================
PAGE, PPS, NPAGES = 4, 16, 24


def _step_inputs(mode, kv_scales):
    """The native step test's mixed batch (decode lane, padded prefill
    chunk, a lane reading a NaN K scale row, an idle lane) over int8
    pools with their [N, H] scale rows."""
    rng = np.random.RandomState(7)
    B, Q = 4, 8
    pools = {side: [rng.randint(-127, 128, (NPAGES, PAGE, HEADS, D)).astype(
        np.int8) for _ in range(LAYERS)] for side in ("k", "v")}
    for side in ("k", "v"):
        pools[f"{side}_scale"] = [
            (np.broadcast_to(np.asarray(kv_scales[side][i], np.float32),
                             (NPAGES, HEADS)).copy()
             if mode == "static" else
             (rng.rand(NPAGES, HEADS) * 0.05 + 1e-3).astype(np.float32))
            for i in range(LAYERS)]
    for arr in pools["k_scale"]:
        arr[9] = np.nan                 # lane 2 reads page 9
    tables = np.zeros((B, PPS), np.int32)
    tables[0, :3] = [3, 7, 11]
    tables[1, :2] = [5, 2]
    tables[2, :2] = [9, 14]
    state_tok = np.array([17, 0, 23, 0], np.int32)
    state_pos = np.array([9, 0, 5, 0], np.int32)
    rows_tok = np.zeros((B, Q), np.int32)
    rows_pos = np.zeros((B, Q), np.int32)
    row_valid = np.zeros((B, Q), np.int32)
    row_valid[:, 0] = RAGGED_NO_LIMIT
    rows_tok[1] = rng.randint(1, VOCAB, Q)
    rows_pos[1] = 4 + np.arange(Q)
    row_valid[1] = 7
    advance = np.array([1, 0, 1, 1], np.int32)
    return (state_tok, state_pos, tables, rows_tok, rows_pos, row_valid,
            advance), pools


@pytest.mark.parametrize("mode", ["static", "dynamic"])
def test_int8_ragged_step_matches_jax(shared_gpt_small, port, quant, mode):
    kv_scales = quant["kv_scales"] if mode == "static" else None
    rows, pools = _step_inputs(mode, quant["kv_scales"])
    qkw = dict(kv_cache_dtype="int8", kv_scales=kv_scales,
               weight_quant=quant["weights"])
    jfn, _ = jax_ragged_step(shared_gpt_small, PAGE, PPS, with_guard=True,
                             **qkw)
    jout = jfn(*(jnp.asarray(a) for a in rows),
               {k: [jnp.asarray(a) for a in v] for k, v in pools.items()})
    tfn, _ = make_gpt_paged_ragged_step(port, PAGE, PPS, with_guard=True,
                                        **qkw)
    tkv = {k: [torch.from_numpy(a.copy()) for a in v]
           for k, v in pools.items()}
    tout = tfn(*(torch.from_numpy(a) for a in rows), tkv)
    for t, j in zip(tout[:4], jout[:4]):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert tout[1].numpy()[2] < 0       # the NaN-scale lane is packed
    jkv, tkv = jout[4], tout[4]
    for side in ("k", "v"):
        for i in range(LAYERS):
            got = tkv[side][i].numpy()[1:].astype(np.int16)
            want = np.asarray(jkv[side][i])[1:].astype(np.int16)
            assert np.abs(got - want).max() <= 1
            sg = tkv[f"{side}_scale"][i].numpy()[1:]
            sw = np.asarray(jkv[f"{side}_scale"][i])[1:]
            if mode == "static":
                assert sg.tobytes() == sw.tobytes()
            else:
                np.testing.assert_allclose(sg, sw, rtol=1e-6, atol=0)
                # scales only grow (the NaN lane's layer-1 K/V are NaN)
                orig = pools[f"{side}_scale"][i][1:]
                fin = np.isfinite(sg) & np.isfinite(orig)
                assert (sg[fin] >= orig[fin]).all()


# =============================================================================
# generate(quant=...) and the engine
# =============================================================================
def test_generate_quant_equals_jax(port, quant, prompts, jax_quant_refs):
    for p, want in zip(prompts, jax_quant_refs):
        got = _truncate(generate(port, p[None], max_new_tokens=BUDGET,
                                 end_id=0, quant=quant)[0][0].numpy())
        np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def jax_dynamic_streams(shared_gpt_small, prompts):
    """paddle_tpu's int8_dynamic engine under the same forced
    preemption (dynamic scales have no dense reference)."""
    eng = JaxEngine(shared_gpt_small, num_pages=9, kv_cache_dtype="int8",
                    weight_dtype="int8", sync_mode=True, **ENGINE)
    return _drive(eng, prompts)


@pytest.mark.parametrize("sync_mode", [True, False],
                         ids=["sync", "pipelined"])
@pytest.mark.parametrize("mode", ["static", "dynamic"])
def test_int8_engine_streams_equal_jax_under_preemption(
        port, quant, prompts, jax_quant_refs, jax_dynamic_streams, mode,
        sync_mode):
    # 8 allocatable pages for 4 lanes of up to 21 positions: recompute
    # preemption strikes and replays
    eng = ServingEngine(port, num_pages=9, kv_cache_dtype="int8",
                        weight_dtype="int8", sync_mode=sync_mode,
                        quant_scales=quant if mode == "static" else None,
                        device="cpu", **ENGINE)
    got = _drive(eng, prompts)
    assert eng.scheduler.num_preemptions > 0
    assert eng.kv_mode() == f"int8_{mode}"
    refs = jax_quant_refs if mode == "static" else jax_dynamic_streams
    for g, want in zip(got, refs):
        np.testing.assert_array_equal(g, want)
    assert eng.cache.pages_in_use == 0


def test_weight_only_int8_quantizes_data_free(port, prompts):
    eng = ServingEngine(port, weight_dtype="int8", device="cpu", **ENGINE)
    assert eng.kv_mode() == "native"
    got = _drive(eng, prompts[:3])
    ex = {"weight_dtype": "int8", "weights": quantize_gpt_weights(port)}
    for p, g in zip(prompts[:3], got):
        want = generate(port, p[None], max_new_tokens=BUDGET, end_id=0,
                        quant=ex)[0][0].numpy()
        np.testing.assert_array_equal(g, _truncate(want))


# =============================================================================
# knobs, stats, bytes
# =============================================================================
@pytest.mark.parametrize("knob", [{"kv_cache_dtype": "int4"},
                                  {"weight_dtype": "fp8"},
                                  {"kv_cache_dtype": "bfloat16"}],
                         ids=["kv-int4", "weight-fp8", "kv-bf16"])
def test_engine_rejects_unknown_dtypes(port, knob):
    with pytest.raises(InvalidArgumentError, match="must be None or 'int8'"):
        ServingEngine(port, device="cpu", **knob)


def test_engine_rejects_orphan_quant_scales(port, quant):
    with pytest.raises(InvalidArgumentError, match="quant_scales"):
        ServingEngine(port, quant_scales=quant, device="cpu")


def test_dense_int8_requires_calibration(port):
    with pytest.raises(ValueError, match="calibrated kv_scales"):
        make_gpt_decode_step(port, 8, kv_cache_dtype="int8")
    with pytest.raises(ValueError, match="calibrated kv_scales"):
        generate(port, np.ones((1, 3), np.int32), max_new_tokens=2,
                 quant=export_serving_quant(port))
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        make_gpt_decode_step(port, 8, kv_cache_dtype="int4")


def test_stats_quant_section_and_kv_bytes(port, quant):
    native = ServingEngine(port, num_pages=20, device="cpu", **ENGINE)
    eng = ServingEngine(port, num_pages=20, kv_cache_dtype="int8",
                        weight_dtype="int8", quant_scales=quant,
                        device="cpu", **ENGINE)
    before = qm.QMM_ROUTE_STATS["ref"]
    eng.add_request(np.array([3, 5], np.int32), max_new_tokens=4)
    eng.drain()
    q = eng.stats()["quant"]
    assert q["kv_cache_dtype"] == q["weight_dtype"] == "int8"
    assert q["kv_scale_mode"] == "static"
    assert q["kv_cache_bytes"] == eng.kv_cache_bytes()
    assert q["quant_weight_bytes"] == sum(
        a.nbytes + s.nbytes for a, s in quant["weights"].values())
    assert q["matmul_route"]["ref"] > before
    assert native.stats()["quant"]["kv_cache_dtype"] == "native"
    assert native.stats()["quant"]["kv_scale_mode"] is None
    dyn = ServingEngine(port, kv_cache_dtype="int8", device="cpu", **ENGINE)
    assert dyn.stats()["quant"]["kv_scale_mode"] == "dynamic"
    assert dyn.stats()["quant"]["weight_dtype"] == "native"
    # int8 pages + their scale rows against f32 pages, same page count
    ratio = eng.kv_cache_bytes() / native.kv_cache_bytes()
    assert ratio == kv_page_bytes(4, HEADS, D, "int8") / kv_page_bytes(
        4, HEADS, D, "float32")
    assert native.kv_cache_bytes() / eng.kv_cache_bytes() >= 1.8
    assert eng.kv_bytes_per_token() == 2 * LAYERS * kv_page_bytes(
        4, HEADS, D, "int8") / 4


# =============================================================================
# numeric quarantine under int8
# =============================================================================
@pytest.mark.parametrize("mode", ["static", "dynamic"])
def test_nan_logits_poisons_the_scale_row_and_quarantines(
        port, quant, prompts, jax_quant_refs, mode):
    def build():
        return ServingEngine(
            port, kv_cache_dtype="int8", weight_dtype="int8",
            quant_scales=quant if mode == "static" else None,
            sync_mode=True, device="cpu", **ENGINE)

    # dynamic streams depend on each page's write history, so the
    # survivors' reference is the same drive without the fault
    clean = _drive(build(), prompts[:3])
    if mode == "static":
        for g, want in zip(clean, jax_quant_refs):
            np.testing.assert_array_equal(g, want)
    eng = build()
    ids = [eng.add_request(p, max_new_tokens=BUDGET) for p in prompts[:3]]
    victim = ids[1]
    plan = chaos.ChaosPlan([chaos.Fault("serving.logits", at=5,
                                        action="nan_logits", match=victim)])
    faulted, freed = [], []
    with chaos.running(plan):
        while eng.scheduler.has_work() or eng._pending:
            pages = eng.cache.seq_page_ids(victim)
            eng.step()
            if not faulted:
                faulted = eng.take_faulted()
                if faulted:
                    freed = pages
                    # the scale rows of the freed pages are healed at once
                    for side in ("k", "v"):
                        for i, sc in enumerate(eng._kv[f"{side}_scale"]):
                            rows = sc[freed].numpy()
                            if mode == "static":
                                want = np.asarray(
                                    quant["kv_scales"][side][i], np.float32)
                                assert (rows == want[None, :]).all()
                            else:
                                assert (rows == np.float32(
                                    KV_SCALE_EPS)).all()
    outs, eng.outputs = eng.outputs, {}
    assert faulted == [victim] and freed and victim not in outs
    assert eng.stats()["metrics"]["guard"]["quarantines"] == 1
    for rid, want in ((ids[0], clean[0]), (ids[2], clean[2])):
        np.testing.assert_array_equal(outs[rid], want)
    assert eng.cache.pages_in_use == 0
    assert all(torch.isfinite(t).all() for side in eng._kv.values()
               for t in side)
