"""paddle_tpu_torch beam search (``nn/decode.py``, ``generate(decode_
strategy="beam_search")``) against the JAX package, on the same inputs.

Twins of ``tests/test_sequence_decode.py``'s ``TestBeamSearch`` and
``TestDynamicDecodeAPI`` and of the seq2seq decoder of
``tests/test_seq2seq_decode.py`` (seeded, untrained weights), plus beam
``generate`` on the suite's ``shared_gpt_small`` with its weights bridged
(``load_numpy_state``), native and with the JAX package's int8 exports.

Tolerances: ids, parents and lengths must be equal; lattice scores
within 1e-5 (the same f32 sums in the same order, on two backends);
``generate``'s scores within 1e-4 (the model's logits differ by a few
f32 ulps over 2 layers, ``tests/test_torch_gpt.py``).  A beam may leave
paddle_tpu's only where the two candidates at its top-K boundary lie
closer than 1e-5; none does in these cases.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.jit.functional import get_state
from paddle_tpu.nn import decode as jdec
from paddle_tpu.slim import export_serving_quant as jax_export
from paddle_tpu.text.generation import generate as jax_generate
import paddle_tpu_torch as pt
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.nn import decode as tdec
from paddle_tpu_torch.nn import state_from_numpy
from paddle_tpu_torch.text.generation import generate
from paddle_tpu_torch.text.models import GPTModel, load_numpy_state

VOCAB = 50
SCORE_TOL = 1e-5
GEN_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The decode loops are long runs of small tensor ops: one torch
    thread per test worker, or the workers' OpenMP teams oversubscribe
    the CPU."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    pt.set_device("cpu")
    yield
    torch.set_num_threads(prev)


def _j(a):
    return jnp.asarray(np.asarray(a))


def _t(a):
    return torch.from_numpy(np.array(a))


def _bridge(jax_layer, port_layer):
    """Copy a paddle_tpu layer's weights into the port's twin; their
    ``state_dict`` names must be equal."""
    state = {k: np.asarray(v._value) for k, v in
             jax_layer.state_dict().items()}
    assert list(state) == list(port_layer.state_dict())
    port_layer.set_state_dict(state_from_numpy(state, "cpu"))
    return port_layer


def _table(seed=0, V=6):
    rng = np.random.RandomState(seed)
    t = rng.rand(V, V).astype(np.float64) + 0.05
    return t / t.sum(axis=1, keepdims=True)


def _jax_table_step(table):
    logt = jnp.asarray(np.log(table))

    def step_fn(tokens, state):
        return logt[tokens], state

    return step_fn


def _torch_table_step(table):
    logt = torch.from_numpy(np.log(table))

    def step_fn(tokens, state):
        return logt[tokens.long()], state

    return step_fn


def _step_both(pre, lp, fin, K, end_id, **kw):
    jr = jdec.beam_search_step(_j(pre), _j(lp), _j(fin), K, end_id, **kw)
    tr = tdec.beam_search_step(_t(pre), _t(lp), _t(fin), K, end_id, **kw)
    j = [np.asarray(x) for x in jr]
    t = [x.numpy() for x in tr]
    np.testing.assert_array_equal(t[1], j[1])          # tokens
    np.testing.assert_array_equal(t[2], j[2])          # parents
    np.testing.assert_allclose(t[0], j[0], rtol=SCORE_TOL, atol=SCORE_TOL)
    assert t[1].dtype == np.int32 and t[2].dtype == np.int32
    return t


# --- twins of test_sequence_decode.py TestBeamSearch -----------------------
def test_step_topk_math():
    lp = np.log(np.asarray([[[0.7, 0.2, 0.1], [0.1, 0.1, 0.8]]],
                           np.float32))
    pre = np.asarray([[0.0, -0.5]], np.float32)
    scores, tok, par = _step_both(pre, lp, np.zeros((1, 2), bool), 2, 0)
    np.testing.assert_allclose(scores[0], [np.log(0.7), -0.5 + np.log(0.8)],
                               rtol=1e-5)
    assert tok[0].tolist() == [0, 2] and par[0].tolist() == [0, 1]


def test_finished_beam_frozen():
    lp = np.log(np.full((1, 2, 3), 1 / 3, np.float32))
    pre = np.asarray([[-0.1, -4.0]], np.float32)
    scores, tok, par = _step_both(pre, lp, np.asarray([[True, False]]), 2, 1)
    assert int(tok[0, 0]) == 1 and int(par[0, 0]) == 0
    np.testing.assert_allclose(scores[0, 0], -0.1, rtol=1e-5)


def test_length_penalty_prefers_longer():
    lp = np.log(np.asarray([[[0.6, 0.4]]], np.float32))
    pre = np.asarray([[-2.0]], np.float32)
    fin = np.zeros((1, 1), bool)
    _, tok, _ = _step_both(pre, lp, fin, 1, 0)
    assert int(tok[0, 0]) == 0
    sc, _, _ = _step_both(pre, lp, fin, 1, 0, length_penalty=1.0, step=5)
    np.testing.assert_allclose(sc[0, 0], -2.0 + np.log(0.6), rtol=1e-5)


@pytest.mark.parametrize("seed", range(6))
def test_step_on_random_lattices_with_penalty(seed):
    """Random scores, finished beams and steps, with and without the
    length penalty: the same selection as paddle_tpu's."""
    rng = np.random.RandomState(seed)
    B, K, V = 3, 4, 7
    lp = np.log(rng.dirichlet(np.ones(V), (B, K))).astype(np.float32)
    pre = (-rng.rand(B, K) * 5).astype(np.float32)
    pre[0, 1:] = -1e9                          # t = 0 beams
    fin = rng.rand(B, K) < 0.4
    for alpha in (0.0, 0.6, 1.3):
        _step_both(pre, lp, fin, K, seed % V, length_penalty=alpha,
                   step=int(rng.randint(1, 40)))


def test_ties_break_to_the_lower_index_where_topk_does_not():
    """Ties decide the top K: at t = 0 the K-1 dead beams, and a
    finished beam, put many candidates at ``-1e9 + score`` (f32 steps by
    64 there, so they are equal).  The port keeps the lower flat index,
    as ``jax.lax.top_k``; ``torch.topk`` picks others here."""
    B, K, V = 2, 4, 40
    rng = np.random.RandomState(3)
    lp = np.log(rng.dirichlet(np.ones(V), (B, K))).astype(np.float32)
    pre = np.full((B, K), -1e9, np.float32)
    pre[:, 0] = -1e9                         # every beam dead: all tie
    pre[1, 0] = -0.25
    fin = np.zeros((B, K), bool)
    fin[1, 0] = True                          # one finished live beam
    scores, tok, par = _step_both(pre, lp, fin, K, 0)
    flat = (pre[..., None] + np.where(fin[..., None], -1e9, lp))
    flat[..., 0] = np.where(fin, pre, flat[..., 0])
    flat = flat.reshape(B, K * V).astype(np.float32)
    ours = par.astype(np.int64) * V + tok
    _, tk = torch.topk(torch.from_numpy(flat), K)
    assert not np.array_equal(tk.numpy(), ours), (
        "torch.topk happened to pick the lower indices: the case no longer "
        "shows the tie rule")
    # row 0: every candidate ties; the lowest K flat indices win
    assert ours[0].tolist() == list(range(K))


def test_beam_matches_exhaustive_and_jax():
    table = _table(3)
    T = 4
    kw = dict(batch_size=1, beam_size=6, max_len=T, bos_id=0, end_id=99,
              logits_normalized=True)
    j = jdec.beam_search_decode(_jax_table_step(table), jnp.zeros((6,)),
                                **kw)
    t = tdec.beam_search_decode(_torch_table_step(table), torch.zeros(6),
                                **kw)
    np.testing.assert_array_equal(t.ids.numpy(), np.asarray(j.ids))
    np.testing.assert_array_equal(t.lengths.numpy(), np.asarray(j.lengths))
    np.testing.assert_allclose(t.scores.numpy(), np.asarray(j.scores),
                               rtol=SCORE_TOL, atol=SCORE_TOL)
    # beam == vocab: exact search on a Markov chain
    best = {(0,): 0.0}
    for _ in range(T):
        best = {p + (v,): s + np.log(table[p[-1], v])
                for p, s in best.items() for v in range(6)}
    np.testing.assert_allclose(float(t.scores[0, 0]), max(best.values()),
                               rtol=1e-4)


@pytest.mark.parametrize("end_id", [2, 99])
def test_greedy_parity_beam1(end_id):
    table = _table(5)
    kw = dict(batch_size=2, max_len=6, bos_id=1, end_id=end_id)
    ids_g, score_g = tdec.greedy_search_decode(
        _torch_table_step(table), torch.zeros(2), **kw)
    res = tdec.beam_search_decode(_torch_table_step(table), torch.zeros(2),
                                  beam_size=1, logits_normalized=True, **kw)
    jres = jdec.beam_search_decode(_jax_table_step(table), jnp.zeros((2,)),
                                   beam_size=1, logits_normalized=True, **kw)
    np.testing.assert_array_equal(res.ids[:, 0].numpy(), ids_g.numpy())
    np.testing.assert_array_equal(res.ids.numpy(), np.asarray(jres.ids))
    np.testing.assert_array_equal(res.lengths.numpy(),
                                  np.asarray(jres.lengths))
    np.testing.assert_allclose(res.scores[:, 0].numpy(), score_g.numpy(),
                               rtol=1e-5)


def test_decode_with_zero_steps():
    res = tdec.beam_search_decode(_torch_table_step(_table()),
                                  torch.zeros(4), batch_size=2, beam_size=2,
                                  max_len=0, bos_id=0, end_id=1)
    assert tuple(res.ids.shape) == (2, 2, 0)


def test_dynamic_decode_requires_inits():
    dec = tdec.BeamSearchDecoder(tnn.GRUCell(4, 4), 0, 1, 2)
    with pytest.raises(ValueError, match="requires inits"):
        tdec.dynamic_decode(dec)


def test_gather_tree():
    ids = np.asarray([[[5, 6]], [[7, 8]]], np.int32)
    par = np.asarray([[[0, 1]], [[1, 0]]], np.int32)
    full = tdec.gather_tree(_t(ids), _t(par)).numpy()
    np.testing.assert_array_equal(full[:, 0, 0], [6, 7])
    np.testing.assert_array_equal(full[:, 0, 1], [5, 8])
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 9, (5, 3, 4)).astype(np.int32)
    par = rng.randint(0, 4, (5, 3, 4)).astype(np.int32)
    want = jdec.gather_tree(paddle.to_tensor(ids), paddle.to_tensor(par))
    np.testing.assert_array_equal(tdec.gather_tree(ids, par).numpy(),
                                  want.numpy())


def test_tree_map_keeps_containers():
    cache = tnn.MultiHeadAttention.Cache(torch.ones(2), [torch.zeros(1)])
    out = tdec.tree_map(lambda s: s + 1, {"c": cache, "t": (torch.ones(1),)})
    assert isinstance(out["c"], tnn.MultiHeadAttention.Cache)
    assert isinstance(out["t"], tuple) and isinstance(out["c"].v, list)
    assert float(out["c"].k[0]) == 2.0


# --- twin of TestDynamicDecodeAPI: a cell-based decoder --------------------
@pytest.mark.parametrize("K,length_penalty", [(3, 0.0), (2, 0.8)])
def test_cell_based_decoder_equals_jax(K, length_penalty):
    V, H, B, T = 8, 16, 2, 5
    paddle.seed(0)
    jcell, jemb, jproj = jnn.GRUCell(H, H), jnn.Embedding(V, H), \
        jnn.Linear(H, V)
    cell = _bridge(jcell, tnn.GRUCell(H, H))
    emb = _bridge(jemb, tnn.Embedding(V, H))
    proj = _bridge(jproj, tnn.Linear(H, V))
    h0 = np.random.RandomState(1).randn(B, H).astype(np.float32)

    jdecoder = jdec.BeamSearchDecoder(jcell, start_token=1, end_token=2,
                                      beam_size=K, embedding_fn=jemb,
                                      output_fn=jproj)
    jids, jscores = jdec.dynamic_decode(
        jdecoder, inits=jdec.BeamSearchDecoder.tile_beam_merge_with_batch(
            paddle.to_tensor(h0), K), max_step_num=T,
        length_penalty=length_penalty)
    decoder = tdec.BeamSearchDecoder(cell, start_token=1, end_token=2,
                                     beam_size=K, embedding_fn=emb,
                                     output_fn=proj)
    ids, scores = tdec.dynamic_decode(
        decoder, inits=tdec.BeamSearchDecoder.tile_beam_merge_with_batch(
            pt.to_tensor(h0), K), max_step_num=T,
        length_penalty=length_penalty)
    assert ids.shape == [B, K, T]
    np.testing.assert_array_equal(ids.numpy(), jids.numpy())
    np.testing.assert_allclose(scores.numpy(), jscores.numpy(),
                               rtol=SCORE_TOL, atol=SCORE_TOL)
    s = scores.numpy()
    assert np.isfinite(s[:, 0]).all() and (np.diff(s, axis=1) <= 1e-5).all()


def test_tile_beam_merge_repeats_rows():
    x = np.arange(6, dtype=np.float32).reshape(3, 2)
    got = tdec.BeamSearchDecoder.tile_beam_merge_with_batch(x, 2).numpy()
    np.testing.assert_array_equal(got, np.repeat(x, 2, axis=0))


# --- the seq2seq decoder of test_seq2seq_decode.py, untrained --------------
S2S_VOCAB, S2S_HID, BOS, EOS, SEQ = 12, 48, 1, 2, 5


class _JaxCopyNet(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.emb = jnn.Embedding(S2S_VOCAB, S2S_HID)
        self.enc = jnn.GRUCell(S2S_HID, S2S_HID)
        self.dec = jnn.GRUCell(S2S_HID, S2S_HID)
        self.proj = jnn.Linear(S2S_HID, S2S_VOCAB)


class _TorchCopyNet(tnn.Layer):
    def __init__(self):
        super().__init__()
        self.emb = tnn.Embedding(S2S_VOCAB, S2S_HID)
        self.enc = tnn.GRUCell(S2S_HID, S2S_HID)
        self.dec = tnn.GRUCell(S2S_HID, S2S_HID)
        self.proj = tnn.Linear(S2S_HID, S2S_VOCAB)


def _encode(net, src, wrap):
    h = wrap(np.zeros((src.shape[0], S2S_HID), np.float32))
    for t in range(src.shape[1]):
        _, h = net.enc(net.emb(wrap(src[:, t])), h)
    return h


@pytest.fixture(scope="module")
def copynets():
    paddle.seed(3)
    jnet = _JaxCopyNet()
    return jnet, _bridge(jnet, _TorchCopyNet())


def _jax_step(net):
    from paddle_tpu.tensor import Tensor

    def step_fn(tokens, h):
        out, h = net.dec(net.emb(Tensor(tokens)), Tensor(h))
        return net.proj(out)._value, h._value

    return step_fn


def _torch_step(net):
    def step_fn(tokens, h):
        out, h = net.dec(net.emb(pt.Tensor(tokens)), pt.Tensor(h))
        return net.proj(out)._value, h._value

    return step_fn


@pytest.mark.parametrize("K", [1, 3])
def test_seq2seq_greedy_and_beam_equal_jax(copynets, K):
    jnet, tnet = copynets
    src = np.random.RandomState(8).randint(3, S2S_VOCAB, (6, SEQ))
    jh = _encode(jnet, src, paddle.to_tensor)._value
    th = _encode(tnet, src, pt.to_tensor)._value.detach()
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-5,
                               atol=1e-5)
    kw = dict(batch_size=6, max_len=SEQ + 1, bos_id=BOS, end_id=EOS)
    with torch.no_grad():
        gi, gs = tdec.greedy_search_decode(_torch_step(tnet), th, **kw)
        res = tdec.beam_search_decode(
            _torch_step(tnet), torch.repeat_interleave(th, K, dim=0),
            beam_size=K, **kw)
    jgi, jgs = jdec.greedy_search_decode(_jax_step(jnet), jh, **kw)
    jres = jdec.beam_search_decode(_jax_step(jnet),
                                   jnp.repeat(jh, K, axis=0), beam_size=K,
                                   **kw)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(jgi))
    np.testing.assert_allclose(gs.numpy(), np.asarray(jgs), rtol=SCORE_TOL,
                               atol=SCORE_TOL)
    np.testing.assert_array_equal(res.ids.numpy(), np.asarray(jres.ids))
    np.testing.assert_array_equal(res.lengths.numpy(),
                                  np.asarray(jres.lengths))
    np.testing.assert_allclose(res.scores.numpy(), np.asarray(jres.scores),
                               rtol=SCORE_TOL, atol=SCORE_TOL)
    # the best beam scores at least greedy's
    assert (res.scores[:, 0].numpy() >= gs.numpy() - 1e-4).all()


# --- generate(decode_strategy="beam_search") on shared_gpt_small -----------
@pytest.fixture(scope="module")
def port(shared_gpt_small):
    state = {k: np.asarray(v)
             for k, v in get_state(shared_gpt_small)[0].items()}
    m = GPTModel(vocab_size=VOCAB, hidden_size=32, num_layers=2,
                 num_heads=2, ffn_size=64, max_seq_len=64, device="cpu")
    return load_numpy_state(m, state)


@pytest.fixture(scope="module")
def exports(shared_gpt_small):
    calib = np.random.RandomState(5).randint(1, VOCAB, (4, 16))
    return {"int8_weights": jax_export(shared_gpt_small,
                                       kv_cache_dtype=None),
            "int8_static": jax_export(shared_gpt_small,
                                      calib_prompts=calib)}


def _lengths(ids, end_id):
    is_end = ids == end_id
    return np.where(is_end.any(-1), np.argmax(is_end, -1) + 1,
                    ids.shape[-1])


def _check_beams(jax_model, port_model, prompt, T, K, alpha, quant=None):
    jids, jscores = jax_generate(jax_model, prompt, max_new_tokens=T,
                                 end_id=0, decode_strategy="beam_search",
                                 num_beams=K, length_penalty=alpha,
                                 quant=quant)
    ids, scores = generate(port_model, prompt, max_new_tokens=T, end_id=0,
                           decode_strategy="beam_search", num_beams=K,
                           length_penalty=alpha, quant=quant)
    assert tuple(ids.shape) == (prompt.shape[0], K, T)
    assert ids.dtype == torch.int32
    np.testing.assert_array_equal(ids.numpy(), jids.numpy())
    np.testing.assert_array_equal(_lengths(ids.numpy(), 0),
                                  _lengths(jids.numpy(), 0))
    np.testing.assert_allclose(scores.numpy(), jscores.numpy(),
                               rtol=GEN_TOL, atol=GEN_TOL)
    if not alpha:
        assert (np.diff(scores.numpy(), axis=1) <= 1e-5).all()
    return ids, scores


@pytest.mark.parametrize("K", [1, 3, 4])
@pytest.mark.parametrize("alpha", [0.0, 0.6])
@pytest.mark.parametrize("seed,shape,T", [(2, (2, 5), 6), (4, (3, 4), 8)])
def test_generate_beam_equals_jax(shared_gpt_small, port, seed, shape, T,
                                  alpha, K):
    prompt = np.random.RandomState(seed).randint(1, VOCAB, shape).astype(
        np.int32)
    _check_beams(shared_gpt_small, port, prompt, T, K, alpha)


@pytest.mark.parametrize("arm", ["int8_weights", "int8_static"])
@pytest.mark.parametrize("alpha", [0.0, 0.6])
def test_generate_beam_quant_equals_jax(shared_gpt_small, port, exports,
                                        arm, alpha):
    prompt = np.random.RandomState(6).randint(1, VOCAB, (2, 6)).astype(
        np.int32)
    _check_beams(shared_gpt_small, port, prompt, 7, 3, alpha,
                 quant=exports[arm])


def test_beam1_is_greedy_and_model_generate_is_generate(port):
    prompt = np.random.RandomState(1).randint(1, VOCAB, (3, 6)).astype(
        np.int32)
    g_ids, g_scores = generate(port, prompt, max_new_tokens=7, end_id=0)
    b_ids, b_scores = port.generate(prompt, max_new_tokens=7, end_id=0,
                                    decode_strategy="beam_search",
                                    num_beams=1)
    np.testing.assert_array_equal(b_ids[:, 0].numpy(), g_ids.numpy())
    np.testing.assert_allclose(b_scores[:, 0].numpy(), g_scores.numpy(),
                               rtol=1e-5, atol=1e-5)
    m_ids, _ = port.generate(prompt, max_new_tokens=7)
    np.testing.assert_array_equal(m_ids.numpy(), g_ids.numpy())


def test_beam_scores_are_the_sum_of_their_tokens_log_probs(port):
    """Each beam's score is the log-prob of its own tokens (up to and
    including its first end_id) under one full-sequence forward."""
    prompt = np.random.RandomState(9).randint(1, VOCAB, (2, 5)).astype(
        np.int32)
    T, K = 6, 3
    ids, scores = generate(port, prompt, max_new_tokens=T, end_id=0,
                           decode_strategy="beam_search", num_beams=K)
    lens = _lengths(ids.numpy(), 0)
    for b in range(2):
        for k in range(K):
            seq = np.concatenate([prompt[b], ids[b, k].numpy()])
            with torch.no_grad():
                lp = torch.log_softmax(port(seq[None].astype(np.int64))[0],
                                       -1).numpy()
            P = prompt.shape[1]
            want = sum(lp[P - 1 + t, seq[P + t]] for t in range(lens[b, k]))
            np.testing.assert_allclose(float(scores[b, k]), want,
                                       rtol=1e-4, atol=1e-4)


def _span_shape(spans):
    """(name, depth, parent's name, args) of each span, in start order."""
    by_id = {s.span_id: s for s in spans}
    return [(s.name, s.depth,
             by_id[s.parent_id].name if s.parent_id in by_id else None,
             s.args) for s in sorted(spans, key=lambda s: s.start_ns)]


def test_generate_beam_spans_match_jax(shared_gpt_small, port):
    from paddle_tpu import profiler as jax_profiler
    from paddle_tpu_torch import profiler

    prompt = np.ones((2, 4), np.int32)
    kw = dict(max_new_tokens=3, decode_strategy="beam_search", num_beams=2)
    jax_profiler.enable_tracing()
    try:
        jax_generate(shared_gpt_small, prompt, **kw)
        want = _span_shape(jax_profiler.get_spans())
    finally:
        jax_profiler.disable_tracing()
        jax_profiler.clear_spans()
    profiler.enable_tracing()
    try:
        generate(port, prompt, **kw)
        got = _span_shape(profiler.get_spans())
    finally:
        profiler.disable_tracing()
        profiler.clear_spans()
    assert got == want
    assert got[0] == ("text.generation", 0, None, {
        "strategy": "beam_search", "batch": 2, "prompt_len": 4,
        "num_beams": 2})
    assert [n for n, *_ in got] == ["text.generation",
                                    "text.generation/prefill",
                                    "text.generation/decode"]
