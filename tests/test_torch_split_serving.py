"""paddle_tpu_torch split serving programs and the ``ragged=False`` /
``fused_steps`` engine vs the JAX package and the port's own references.

- the split builders (``make_gpt_paged_{decode,prefill,fused_decode,
  spec_verify}_step``, both verify schedules) against paddle_tpu's on the
  same weights (``load_numpy_state``) and inputs, chained as the engine
  chains them: prefill chunks, a decode step, a fused K-step, a verify —
  native, int8_static and int8_dynamic KV;
- the split engine (sync, pipelined, ``fused_steps=4``) in every KV mode
  streams what the port's ``generate`` (native, int8_static) and the
  port's ragged engine stream, with no page leaked; one drive against
  paddle_tpu's ``ServingEngine(ragged=False)``;
- knob validation and ``stats()``.

Tolerances: tokens and streams exact.  Logits 1e-4 and native pools 1e-5
(f32, the same products summed in another order through 2 layers);
int8 pools within one quantum (a K/V value a few f32 ulps apart between
the backends may round to the neighbouring int8), their scales rtol 1e-6
(dynamic: abs-max / 127 of those values; static: never written).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.jit.functional import get_state
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu.slim import export_serving_quant as jax_export
from paddle_tpu.text import generation as jgen
from paddle_tpu_torch.framework.errors import InvalidArgumentError
from paddle_tpu_torch.ops.paged_attention import PAGED_ROUTE_STATS
from paddle_tpu_torch.serving import ServingEngine, create_serving_engine
from paddle_tpu_torch.text import generation as tgen
from paddle_tpu_torch.text.models import GPTModel, load_numpy_state

VOCAB, LAYERS, HEADS = 50, 2, 2
PAGE, PPS, NPAGES = 4, 16, 24
ENGINE = dict(page_size=4, max_batch_size=4, prefill_chunk=4, eos_id=0)
LENS = (3, 9, 5, 2, 1, 12)
BUDGET = 10
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
POOL_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def port(shared_gpt_small):
    state = {k: np.asarray(v)
             for k, v in get_state(shared_gpt_small)[0].items()}
    m = GPTModel(vocab_size=VOCAB, hidden_size=32, num_layers=LAYERS,
                 num_heads=HEADS, ffn_size=64, max_seq_len=64, device="cpu")
    return load_numpy_state(m, state)


@pytest.fixture(scope="module")
def quant(shared_gpt_small):
    calib = np.random.RandomState(5).randint(1, VOCAB, (4, 16))
    return jax_export(shared_gpt_small, calib_prompts=calib)


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.RandomState(3)
    return [rng.randint(1, VOCAB, (n,)).astype(np.int32) for n in LENS]


def _qkw(mode, quant):
    """Builder keywords of a KV mode (int8_static also quantizes the
    weights, as the int8 engine arm does)."""
    if mode == "native":
        return {}
    if mode == "int8_static":
        return dict(kv_cache_dtype="int8", kv_scales=quant["kv_scales"],
                    weight_quant=quant["weights"])
    return dict(kv_cache_dtype="int8")


# =============================================================================
# the split programs, chained, against paddle_tpu's
# =============================================================================
class _Pair:
    """One builder of each package over the same weights and the same
    starting pools; ``run`` feeds both the same numpy inputs."""

    def __init__(self, jax_model, port, mode, quant):
        self.kw = _qkw(mode, quant)
        self.jax_model, self.port = jax_model, port
        _, jinit = jgen.make_gpt_paged_decode_step(jax_model, PAGE, PPS,
                                                   **self.kw)
        _, tinit = tgen.make_gpt_paged_decode_step(port, PAGE, PPS,
                                                   **self.kw)
        self.jkv, self.tkv = jinit(NPAGES), tinit(NPAGES)

    def build(self, name, *args, **kw):
        return (getattr(jgen, name)(self.jax_model, PAGE, PPS, *args,
                                    **kw, **self.kw)[0],
                getattr(tgen, name)(self.port, PAGE, PPS, *args,
                                    **kw, **self.kw)[0])

    def run(self, fns, *inputs):
        jfn, tfn = fns
        jout = jfn(*(jnp.asarray(a) for a in inputs), self.jkv)
        tout = tfn(*(torch.as_tensor(np.array(a)) for a in inputs),
                   self.tkv)
        return jout, tout

    def check_pools(self):
        """Every layer's pools outside the trash page 0 (where padded
        rows' duplicate writes land in an unspecified order)."""
        for side in self.jkv:
            for j, t in zip(self.jkv[side], self.tkv[side]):
                want, got = np.asarray(j)[1:], t.numpy()[1:]
                if side in ("k_scale", "v_scale"):
                    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
                elif got.dtype == np.int8:
                    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
                    assert diff.max() <= 1, f"{side}: {diff.max()} quanta"
                else:
                    np.testing.assert_allclose(got, want, **POOL_TOL)


# lane 0 pages 1..6, lane 1 pages 7..12, lane 2 idle (pos 0, all-trash)
TABLES = np.zeros((3, PPS), np.int32)
TABLES[0, :6] = np.arange(1, 7)
TABLES[1, :6] = np.arange(7, 13)


def _chain(pair, rng):
    """prefill both lanes, one decode step, one fused 3-step; returns
    (token, pos) after them.  Compares every output on the way."""
    prefill = pair.build("make_gpt_paged_prefill_step")
    # lane 0: an 8-row chunk of a 7-token prefix (row 7 is padding);
    # lane 1: two 4-row chunks of an 8-token prefix
    for lane, off, size, n in ((0, 0, 8, 7), (1, 0, 4, 8), (1, 4, 4, 8)):
        toks = rng.randint(1, VOCAB, size).astype(np.int32)
        pos = (off + np.arange(size)).astype(np.int32)
        pair.jkv, _ = pair.run(prefill, toks, pos, TABLES[lane],
                               np.int32(n))
        pair.check_pools()
    tok = np.array([11, 23, 0], np.int32)
    pos = np.array([7, 8, 0], np.int32)
    decode = pair.build("make_gpt_paged_decode_step")
    (jl, pair.jkv), (tl, _) = pair.run(decode, tok, pos, TABLES)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    nxt = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
    np.testing.assert_array_equal(
        torch.argmax(tl, dim=-1).numpy(), nxt)
    pair.check_pools()
    fused = pair.build("make_gpt_paged_fused_decode_step", 3,
                       with_guard=True)
    jo, to = pair.run(fused, nxt, pos + 1, TABLES)
    pair.jkv = jo[3]
    for j, t in zip(jo[:3], to[:3]):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    pair.check_pools()
    return np.asarray(jo[1]), np.asarray(jo[2])


@pytest.mark.parametrize("mode", ["native", "int8_static", "int8_dynamic"])
@pytest.mark.parametrize("sequential", [False, True],
                         ids=["one-forward", "sequential"])
def test_split_programs_match_jax(shared_gpt_small, port, quant, mode,
                                  sequential):
    pair = _Pair(shared_gpt_small, port, mode, quant)
    rng = np.random.RandomState(11)
    tok, pos = _chain(pair, rng)
    assert pos.tolist() == [11, 12, 4]
    K = 4
    verify = pair.build("make_gpt_paged_spec_verify_step", K,
                        sequential=sequential, with_guard=True)
    draft = np.concatenate([tok[None], rng.randint(1, VOCAB, (K - 1, 3))]
                           ).astype(np.int32)
    (jo, pair.jkv), (to, _) = pair.run(verify, draft, pos, TABLES)
    assert to.shape == (K, 3) and to.dtype == torch.int32
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    pair.check_pools()


def test_verify_equals_k_single_steps(port):
    """One verify dispatch's outputs equal K single decode steps fed the
    same inputs (native KV: both schedules)."""
    K = 4
    step, init = tgen.make_gpt_paged_decode_step(port, PAGE, PPS)
    rng = np.random.RandomState(5)
    toks = torch.as_tensor(rng.randint(1, VOCAB, (K, 2)).astype(np.int32))
    pos0 = torch.tensor([0, 3], dtype=torch.int32)
    tables = torch.as_tensor(TABLES[:2])
    kv = init(NPAGES)
    want = []
    for j in range(K):
        logits, kv = step(toks[j], pos0 + j, tables, kv)
        want.append(torch.argmax(logits, dim=-1).to(torch.int32))
    for sequential in (False, True):
        verify, _ = tgen.make_gpt_paged_spec_verify_step(
            port, PAGE, PPS, K, sequential=sequential)
        out, _ = verify(toks, pos0, tables, init(NPAGES))
        torch.testing.assert_close(out, torch.stack(want), rtol=0, atol=0)


def test_guard_packs_non_finite_rows(port):
    """A row whose KV is NaN comes back ``-1 - tok`` from the fused and
    verify programs; the clean argmax still feeds the fused loop."""
    fused, init = tgen.make_gpt_paged_fused_decode_step(
        port, PAGE, PPS, 2, with_guard=True)
    kv = init(NPAGES)
    kv["k"][0][7] = float("nan")        # lane 1's first page
    tok = torch.tensor([5, 6, 0], dtype=torch.int32)
    pos = torch.tensor([2, 2, 0], dtype=torch.int32)
    tables = torch.as_tensor(TABLES)
    out, nxt, p, _ = fused(tok, pos, tables, kv)
    assert (out[:, 1] < 0).all() and (out[:, 0] >= 0).all()
    assert nxt[1] == -1 - out[1, 1] and p.tolist() == [4, 4, 2]
    verify, _ = tgen.make_gpt_paged_spec_verify_step(
        port, PAGE, PPS, 2, with_guard=True)
    out, _ = verify(torch.stack([tok, tok]), pos, tables, kv)
    assert (out[:, 1] < 0).all() and (out[:, 0] >= 0).all()


def test_builder_validation(port):
    with pytest.raises(ValueError, match=">= 2"):
        tgen.make_gpt_paged_spec_verify_step(port, PAGE, PPS, 1)
    with pytest.raises(ValueError, match=">= 1"):
        tgen.make_gpt_paged_fused_decode_step(port, PAGE, PPS, 0)


def test_split_programs_route_to_the_per_row_kernel(port):
    """The core's ``qgroup=None`` form calls the per-row routing entry
    once per layer (its plain version here); the ragged step stays on
    the ragged entry."""
    step, init = tgen.make_gpt_paged_decode_step(port, PAGE, PPS)
    calls = []
    orig = tgen.paged_attention

    def spy(q, *args, **kw):
        calls.append(tuple(q.shape))
        return orig(q, *args, **kw)

    tgen.paged_attention = spy
    try:
        step(torch.tensor([1, 2, 0], dtype=torch.int32),
             torch.tensor([3, 0, 0], dtype=torch.int32),
             torch.as_tensor(TABLES), init(NPAGES))
        ragged, _ = tgen.make_gpt_paged_ragged_step(port, PAGE, PPS)
        z = torch.zeros((3, 1), dtype=torch.int32)
        ragged(torch.zeros(3, dtype=torch.int32),
               torch.zeros(3, dtype=torch.int32), torch.as_tensor(TABLES),
               z, z, z + tgen.RAGGED_NO_LIMIT,
               torch.ones(3, dtype=torch.int32), init(NPAGES))
    finally:
        tgen.paged_attention = orig
    assert calls == [(3, HEADS, 16)] * LAYERS


# =============================================================================
# the split engine
# =============================================================================
def _drive(eng, prompts, budget=BUDGET):
    ids = [eng.add_request(p, max_new_tokens=budget) for p in prompts]
    outs = eng.drain()
    return [outs[r] for r in ids]


def _truncate(want, end_id=0):
    if (want == end_id).any():
        want = want[: int(np.argmax(want == end_id)) + 1]
    return want


def _engine_kw(mode, quant):
    if mode == "native":
        return {}
    return dict(kv_cache_dtype="int8", weight_dtype="int8",
                quant_scales=quant if mode == "int8_static" else None)


@pytest.fixture(scope="module")
def references(port, quant, prompts):
    """Per KV mode: the port's ragged engine's streams and, where the
    dense ring has the mode, the port's ``generate``."""
    out = {}
    for mode in ("native", "int8_static", "int8_dynamic"):
        ragged = _drive(ServingEngine(port, device="cpu", **ENGINE,
                                      **_engine_kw(mode, quant)), prompts)
        gen = None
        if mode != "int8_dynamic":
            q = quant if mode == "int8_static" else None
            gen = [_truncate(tgen.generate(port, p[None],
                                           max_new_tokens=BUDGET, end_id=0,
                                           quant=q)[0][0].numpy())
                   for p in prompts]
        out[mode] = (ragged, gen)
    return out


@pytest.mark.parametrize("mode", ["native", "int8_static", "int8_dynamic"])
@pytest.mark.parametrize("knobs", [dict(ragged=False, sync_mode=True),
                                   dict(ragged=False), dict(fused_steps=4)],
                         ids=["sync", "pipelined", "fused4"])
def test_split_engine_streams_equal_references(port, quant, prompts,
                                               references, mode, knobs):
    eng = create_serving_engine(port, device="cpu", **ENGINE, **knobs,
                                **_engine_kw(mode, quant))
    assert not eng.ragged and eng.kv_mode() == mode
    for k in PAGED_ROUTE_STATS:
        PAGED_ROUTE_STATS[k] = 0
    got = _drive(eng, prompts)
    ragged, gen = references[mode]
    for i, g in enumerate(got):
        np.testing.assert_array_equal(g, ragged[i])
        if gen is not None:
            np.testing.assert_array_equal(g, gen[i])
    assert eng.cache.pages_in_use == 0
    assert eng.cache.total_allocs == eng.cache.total_frees
    calls = eng.stats()["programs"]
    assert calls["ragged_step"] == 0 and calls["prefill"] > 0
    forwards = (calls["decode"] + calls["prefill"]
                + eng.fused_steps * calls["decode_fused"])
    assert PAGED_ROUTE_STATS["ref"] == LAYERS * forwards
    if "fused_steps" in knobs:
        assert calls["decode_fused"] > 0
    snap = eng.stats()["metrics"]
    assert snap["ragged"]["steps"] == 0 and snap["prefill_tokens"] > 0


def test_split_engine_matches_jax_split_engine(shared_gpt_small, port,
                                               prompts):
    """The same prompts through paddle_tpu's ``ServingEngine(ragged=
    False)`` and the port's: byte for byte, pipelined and fused."""
    want = _drive(JaxEngine(shared_gpt_small, ragged=False, **ENGINE),
                  prompts)
    for knobs in (dict(ragged=False), dict(fused_steps=4)):
        got = _drive(ServingEngine(port, device="cpu", **ENGINE, **knobs),
                     prompts)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_split_engine_preemption_keeps_streams(port, prompts, references):
    # 8 allocatable pages for 4 lanes: recompute preemption strikes
    eng = ServingEngine(port, num_pages=9, ragged=False, device="cpu",
                        **ENGINE)
    got = _drive(eng, prompts)
    assert eng.scheduler.num_preemptions > 0
    for g, w in zip(got, references["native"][0]):
        np.testing.assert_array_equal(g, w)
    assert eng.cache.pages_in_use == 0


def test_split_engine_numeric_guard_quarantines(port, prompts, references):
    eng = ServingEngine(port, ragged=False, sync_mode=True, device="cpu",
                        **ENGINE)
    ids = [eng.add_request(p, max_new_tokens=BUDGET) for p in prompts[:2]]
    eng.step()
    eng.step()
    victim = next(s for s in eng.scheduler.running if s.seq_id == ids[1])
    eng._poison_lane(victim)
    outs = eng.drain()
    assert eng.take_faulted() == [ids[1]] and ids[1] not in outs
    np.testing.assert_array_equal(outs[ids[0]], references["native"][0][0])
    assert eng.cache.pages_in_use == 0


# =============================================================================
# knobs
# =============================================================================
@pytest.mark.parametrize("knobs,match", [
    (dict(ragged=True, fused_steps=2), "incompatible"),
    (dict(ragged=1), "bool"),
    (dict(spec_decode=1), ">= 2"),
    (dict(spec_decode="4"), "bool or an int"),
    (dict(spec_drafter=object()), "spec_decode is off")],
    ids=["ragged-fused", "ragged-int", "spec1", "spec-str", "drafter-only"])
def test_knob_validation(port, knobs, match):
    with pytest.raises(InvalidArgumentError, match=match):
        ServingEngine(port, device="cpu", **knobs)


def test_stats_report_the_pipeline(port):
    st = ServingEngine(port, device="cpu", fused_steps=4).stats()
    assert st["pipeline"]["fused_steps"] == 4
    assert st["pipeline"]["ragged"] is False
    assert st["spec"] == {"enabled": False}
    st = ServingEngine(port, device="cpu").stats()
    assert st["pipeline"]["fused_steps"] == 1 and st["pipeline"]["ragged"]
    assert ServingEngine(port, device="cpu", ragged=False,
                         fused_steps=1).ragged is False
