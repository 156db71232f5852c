"""Wide heads: the port's ragged serving engine on GPT models whose head
dim is above 128 (D 160 and D 256, the widest the paged kernels take)
against paddle_tpu's ``generate``, and the paged wrappers' head-dim check.

The models are 2-layer GPTs built by paddle_tpu from a seed (hidden 640
over 4 heads, and 1024 over 4 heads); their weights reach the port
through the numpy bridge.  On the CPU the engine runs the plain route of
the paged attention, the twin of the kernels' function, so these streams
are what the card's kernels are held to.  Greedy streams must equal
``generate(greedy)`` token for token; a stream may leave it only at a
near-tie, where paddle_tpu's own top-2 logit gap at that position is
below NEAR_TIE (f32 on both sides, summed in another order over hidden
widths up to 1024: logits move by about 1e-6), and such a divergence is
recorded in the assertion's message, never skipped.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu
from paddle_tpu.jit.functional import get_state
from paddle_tpu.text.generation import make_gpt_decode_step as jax_step
from paddle_tpu.text.models import GPTModel as JaxGPT
from paddle_tpu_torch.ops import paged_attention as pa
from paddle_tpu_torch.serving import create_serving_engine
from paddle_tpu_torch.text.models import GPTModel, load_numpy_state

VOCAB = 64
NEW_TOKENS = 6
NEAR_TIE = 1e-4
# (hidden, heads): head dims 160 and 256
WIDE = {"d160": (640, 4), "d256": (1024, 4)}
PROMPT_LENS = (1, 5, 11, 18)


def _models(hidden, heads, seed):
    paddle_tpu.seed(seed)
    jm = JaxGPT(vocab_size=VOCAB, hidden_size=hidden, num_layers=2,
                num_heads=heads, ffn_size=2 * hidden, max_seq_len=64,
                dropout=0.0)
    jm.eval()
    state = {k: np.asarray(v) for k, v in get_state(jm)[0].items()}
    tm = GPTModel(vocab_size=VOCAB, hidden_size=hidden, num_layers=2,
                  num_heads=heads, ffn_size=2 * hidden, max_seq_len=64,
                  device="cpu")
    return jm, load_numpy_state(tm, state)


def _top2_gap(jm, ids):
    """paddle_tpu's top-2 logit gap after teacher-forcing ``ids``."""
    step, init = jax_step(jm, max_len=len(ids) + 1)
    state = init(1)
    logits = None
    for tok in ids:
        logits, state = step(jnp.asarray([int(tok)], jnp.int32), state)
    top = np.sort(np.asarray(logits)[0])[-2:]
    return float(top[1] - top[0])


@pytest.mark.parametrize("name", sorted(WIDE))
def test_wide_head_engine_streams_equal_jax_generate(name, greedy_ref_memo):
    hidden, heads = WIDE[name]
    jm, tm = _models(hidden, heads, seed=hidden)
    assert hidden // heads > 128
    rng = np.random.RandomState(hidden)
    prompts = [rng.randint(1, VOCAB, (n,)).astype(np.int32)
               for n in PROMPT_LENS]
    eng = create_serving_engine(tm, page_size=4, max_batch_size=4,
                                prefill_chunk=4, eos_id=-1, device="cpu")
    for key in pa.PAGED_ROUTE_STATS:
        pa.PAGED_ROUTE_STATS[key] = 0
    ids = [eng.add_request(p, max_new_tokens=NEW_TOKENS) for p in prompts]
    outs = eng.drain()
    assert eng.cache.pages_in_use == 0
    # every attention call of every dispatch went through the plain route
    steps = eng.stats()["metrics"]["ragged"]["steps"]
    assert steps > 0 and pa.PAGED_ROUTE_STATS["ref"] == 2 * steps
    near_ties = []
    for p, rid in zip(prompts, ids):
        want = greedy_ref_memo(jm, p, NEW_TOKENS, end_id=-1)
        got = np.asarray(outs[rid])
        assert got.shape == want.shape
        diff = np.nonzero(got != want)[0]
        if diff.size:
            k = int(diff[0])
            gap = _top2_gap(jm, np.concatenate([p, want[:k]]))
            near_ties.append((len(p), k, gap))
            assert gap < NEAR_TIE, (
                f"prompt of {len(p)}: the stream leaves generate at "
                f"{k} where its top-2 gap is {gap} (near-ties {near_ties})")


@pytest.mark.parametrize("D", [160, 256, 257])
@pytest.mark.parametrize("kind", ["ragged", "decode", "stats"])
def test_paged_wrappers_take_head_dims_up_to_256(kind, D):
    """The kernel wrappers' shape check, reached on the CPU: D 160 and 256
    pass it (the wrapper then asks for CUDA tensors), D 257 is refused
    with the kernels' bound."""
    G, M, P, H = 2, 3, 4, 1
    pools = torch.zeros(8, P, H, D)
    pt = torch.zeros(G, M, dtype=torch.int32)
    if kind == "decode":
        call = lambda: pa.paged_attention_cuda(   # noqa: E731
            torch.zeros(G, H, D), pools, pools, pt,
            torch.ones(G, dtype=torch.int32))
    else:
        q = torch.zeros(G, 1, H, D)
        rl = torch.ones(G, 1, dtype=torch.int32)
        call = (lambda: pa.ragged_paged_attention_cuda(  # noqa: E731
            q, pools, pools, pt, rl)) if kind == "ragged" else (
            lambda: pa.ragged_paged_attention_stats_cuda(
                q, pools, pools, pt, rl, torch.ones_like(pt)))
    want = "head_dim 257 > 256" if D > pa.MAX_HEAD_DIM else "CUDA"
    with pytest.raises(ValueError, match=want):
        call()
