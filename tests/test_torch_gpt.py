"""paddle_tpu_torch GPT weights and dense decoding vs the JAX package.

The JAX model is the suite-wide fixture ``shared_gpt_small`` (vocab 50,
hidden 32, 2 layers, 2 heads, ffn 64, max_seq_len 64); its weights reach
the port through the numpy bridge ``load_numpy_state``.

Tolerance for logits: 1e-4 absolute/relative.  Both sides run the same
f32 ops in the same association order on the CPU; they differ only in
the backends' summation order inside matmuls (hidden 32, ffn 64) and
softmax, a few f32 ulps per op over 2 layers.  Greedy streams must be
equal token for token.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.jit.functional import get_state
from paddle_tpu.text.generation import make_gpt_decode_step as jax_step
from paddle_tpu_torch.text import generation as tgen
from paddle_tpu_torch.text.models import (GPTModel, load_numpy_state,
                                          numpy_state)

VOCAB = 50
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def state(shared_gpt_small):
    return {k: np.asarray(v)
            for k, v in get_state(shared_gpt_small)[0].items()}


@pytest.fixture(scope="module")
def port(state):
    m = GPTModel(vocab_size=VOCAB, hidden_size=32, num_layers=2,
                 num_heads=2, ffn_size=64, max_seq_len=64, device="cpu")
    return load_numpy_state(m, state)


def test_bridge_round_trip_and_linear_layout(state, port):
    back = numpy_state(port)
    assert set(back) == set(state)
    for k in state:
        np.testing.assert_array_equal(back[k], state[k])
    # JAX Linear weights are [in, out] used as x @ W; nn.Linear stores
    # [out, in] — the bridge transposes, so both compute the same product
    w = state["layers.0.fc1.weight"]                       # [32, 64]
    assert tuple(port.layers[0].fc1.weight.shape) == (64, 32)
    x = np.random.RandomState(0).randn(3, 32).astype(np.float32)
    got = torch.nn.functional.linear(
        torch.from_numpy(x), port.layers[0].fc1.weight).detach().numpy()
    np.testing.assert_allclose(got, x @ w, rtol=1e-5, atol=1e-6)


def test_bridge_rejects_mismatched_state(state):
    m = GPTModel(vocab_size=VOCAB, hidden_size=32, num_layers=2,
                 num_heads=2, ffn_size=64, max_seq_len=64, device="cpu")
    bad = dict(state)
    bad.pop("ln_f.bias")
    with pytest.raises(KeyError, match="ln_f.bias"):
        load_numpy_state(m, bad)
    bad = dict(state)
    bad["wpe.weight"] = bad["wpe.weight"][:10]
    with pytest.raises(ValueError, match="wpe.weight"):
        load_numpy_state(m, bad)


def test_seeded_init_is_deterministic():
    kw = dict(vocab_size=VOCAB, hidden_size=32, num_layers=1, num_heads=2,
              ffn_size=64, max_seq_len=16, device="cpu")
    a, b = GPTModel(seed=5, **kw), GPTModel(seed=5, **kw)
    c = GPTModel(seed=6, **kw)
    for (n, pa), (_, pb), (_, pc) in zip(a.named_parameters(),
                                         b.named_parameters(),
                                         c.named_parameters()):
        assert torch.equal(pa, pb), n
    assert not torch.equal(a.wte.weight, c.wte.weight)
    assert torch.equal(a.layers[0].ln1.weight, torch.ones(32))


def test_decode_step_logits_match_jax(shared_gpt_small, port):
    """Teacher-forced prompt: the port's dense ring step emits the same
    per-step logits as paddle_tpu's ``make_gpt_decode_step``."""
    rng = np.random.RandomState(0)
    B, S = 2, 10
    ids = rng.randint(0, VOCAB, (B, S)).astype(np.int32)
    j_step, j_init = jax_step(shared_gpt_small, max_len=S + 1)
    t_step, t_init = tgen.make_gpt_decode_step(port, max_len=S + 1)
    js, ts = j_init(B), t_init(B)
    for t in range(S):
        jl, js = j_step(jnp.asarray(ids[:, t]), js)
        tl, ts = t_step(torch.from_numpy(ids[:, t]), ts)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert ts["pos"].tolist() == [S, S]


def test_layer_norm_and_gelu_primitives():
    """_ln: f32 statistics with POPULATION variance, eps 1e-5; _gelu:
    exact erf form."""
    x = torch.from_numpy(np.random.RandomState(1).randn(4, 32)
                         .astype(np.float32))
    w, b = torch.ones(32), torch.zeros(32)
    want = (x - x.mean(-1, keepdim=True)) / torch.sqrt(
        x.var(-1, unbiased=False, keepdim=True) + 1e-5)
    torch.testing.assert_close(tgen._ln(x, w, b), want, rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(
        tgen._gelu(x), torch.nn.functional.gelu(x, approximate="none"),
        rtol=1e-6, atol=1e-6)


# the prompt sets of tests/test_gpt_generation.py (seed, shape, budget)
_PROMPTS = [(2, (2, 5), 6), (3, (2, 4), 5), (4, (2, 4), 5), (5, (2, 4), 8),
            (1, (3, 6), 4)]


@pytest.mark.parametrize("seed,shape,T", _PROMPTS)
def test_generate_streams_equal_jax_generate(shared_gpt_small, port,
                                             greedy_ref_memo, seed, shape,
                                             T):
    prompt = np.random.RandomState(seed).randint(1, VOCAB, shape).astype(
        np.int32)
    want = greedy_ref_memo(shared_gpt_small, prompt, T, end_id=0)
    got, scores = tgen.generate(port, prompt, max_new_tokens=T, end_id=0)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int32 and tuple(scores.shape) == (shape[0],)


def test_generate_guards(port):
    with pytest.raises(ValueError, match="max_seq_len"):
        tgen.generate(port, np.ones((1, 60), np.int32), max_new_tokens=10)
    with pytest.raises(ValueError, match="ROADMAP"):
        tgen.generate(port, np.ones((1, 3), np.int32),
                      decode_strategy="beam_search")
