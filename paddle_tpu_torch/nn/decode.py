"""Decoding: fixed-width beam search, ``dynamic_decode`` and the greedy
loop — twin of ``paddle_tpu/nn/decode.py``.

The lattice is the JAX package's: ``[batch, beam]`` lanes of fixed
width, a finished beam emits ``end_id`` at a frozen score, only beam 0
is live at t = 0.  Where the JAX package runs one ``lax.scan``, the port
runs a Python loop whose every step is a few device ops on the lanes'
tensors, with no host sync: nothing is read back until the caller reads
the result.

Its arithmetic follows the JAX package's in f32 step for step: the
candidates ``pre_scores[..., None] + cont`` with the ``-1e9`` sentinel,
the length penalty ``((5 + step) / 6) ** alpha`` in f32, selection on
``flat / lp`` with the carried score gathered from ``flat``.  Top-k
breaks ties as ``jax.lax.top_k`` does, by the lower flat index (a stable
descending sort keeping the first K; ``torch.topk`` promises no order
for ties, and ties are common: a finished beam's continuations and the
dead beams of t = 0 all sit at ``-1e9 + score``, where f32 steps by 64).

The state is a tree of tensors (dicts, lists, tuples, namedtuples such
as ``MultiHeadAttention.Cache``); each step reorders it along the
parent beams by indexing, so every lane owns its storage and a step
function that writes its caches in place writes only its own lane's."""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..ops._helpers import to_tensor_like
from ..ops.dispatch import apply
from ..tensor import Tensor

__all__ = ["beam_search_step", "beam_search_decode", "BeamSearchDecoder",
           "dynamic_decode", "gather_tree", "greedy_search_decode"]

_NEG_INF = -1e9


def tree_map(fn, tree):
    """``fn`` over the leaves of ``tree`` (anything but a dict, list or
    tuple); namedtuples keep their type."""
    if isinstance(tree, dict):
        return type(tree)((k, tree_map(fn, v)) for k, v in tree.items())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree):
    out = []
    tree_map(out.append, tree)
    return out


def _top_k(x, k):
    """The ``k`` largest of each row of ``x`` ``[B, N]`` and their
    indices, ties to the lower index (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(x, dim=1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def _length_penalty(step, alpha) -> float:
    """``((5 + step) / 6) ** alpha`` in f32, as the JAX package computes
    it from its f32 step counter."""
    base = (np.float32(5.0) + np.float32(step)) / np.float32(6.0)
    return float(np.power(base, np.float32(alpha), dtype=np.float32))


def beam_search_step(pre_scores, log_probs, finished, beam_size, end_id,
                     length_penalty: float = 0.0, step: int = 1):
    """One lattice step.

    ``pre_scores`` [B, K] cumulative log-probs, ``log_probs`` [B, K, V]
    this step's, ``finished`` [B, K] bool.  Returns ``(next_scores [B,
    K], token_ids [B, K] int32, parent_idx [B, K] int32)``; the scores
    stay cumulative.  With ``length_penalty`` alpha != 0 the candidates
    are ranked by ``cum / ((5 + step) / 6) ** alpha`` (selection only).
    A finished beam continues only by ``end_id``, at its score (an
    ``end_id`` of -1 is the last vocab entry, and one outside the vocab
    is never emitted, as ``.at[..., end_id]`` reads them in JAX)."""
    B, K, V = log_probs.shape
    cont = torch.where(finished[..., None], _NEG_INF, log_probs)
    if -V <= end_id < V:     # JAX drops an update out of range
        cont[..., end_id] = torch.where(finished, 0.0, cont[..., end_id])
    flat = (pre_scores[..., None] + cont).reshape(B, K * V)
    if length_penalty:
        _, top_idx = _top_k(flat / _length_penalty(step, length_penalty), K)
        top_scores = torch.gather(flat, 1, top_idx)
    else:
        top_scores, top_idx = _top_k(flat, K)
    parent = torch.div(top_idx, V, rounding_mode="floor").to(torch.int32)
    return top_scores, (top_idx % V).to(torch.int32), parent


def _gather_tree_impl(ids, parents):
    """``ids``, ``parents`` [T, B, K] -> the sequences [T, B, K], each
    leaf's path read back from the last step to the first."""
    T, B, K = ids.shape
    beam = torch.arange(K, device=ids.device).expand(B, K)
    out = [None] * T
    for t in range(T - 1, -1, -1):
        out[t] = torch.gather(ids[t], 1, beam)
        beam = torch.gather(parents[t], 1, beam).long()
    return torch.stack(out) if T else ids.clone()


def gather_tree(ids, parents):
    """Backtrack the beam lattice: ``ids``, ``parents`` [T, B, K] ->
    the full sequences [T, B, K] read root to leaf."""
    return apply("gather_tree", _gather_tree_impl, to_tensor_like(ids),
                 to_tensor_like(parents))


class _DecodeOut(NamedTuple):
    ids: torch.Tensor          # [B, K, T]
    scores: torch.Tensor       # [B, K]
    lengths: torch.Tensor      # [B, K]


def _device_of(state, bos_id):
    for leaf in tree_leaves(state) + [bos_id]:
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    from ..framework.place import default_device

    return default_device()


def _start_tokens(bos_id, shape, device):
    """int32 start tokens of ``shape`` from an int (filled on the device:
    no host copy, so no sync) or from ids broadcastable to ``shape``."""
    if isinstance(bos_id, (int, np.integer)):
        return torch.full(shape, int(bos_id), dtype=torch.int32,
                          device=device)
    ids = torch.as_tensor(bos_id).to(device=device, dtype=torch.int32)
    return ids.expand(shape).clone()


def beam_search_decode(step_fn: Callable, init_state, batch_size: int,
                       beam_size: int, max_len: int, bos_id, end_id: int,
                       logits_normalized: bool = False,
                       length_penalty: float = 0.0):
    """Beam search over ``max_len`` steps.

    ``step_fn(tokens [B*K], state) -> (logits [B*K, V], state)``; the
    logits are log-softmax normalized here unless ``logits_normalized``.
    ``init_state``: a tree of tensors with leading dim B*K (tile it with
    ``BeamSearchDecoder.tile_beam_merge_with_batch``).  ``bos_id``: an
    int, or ids broadcastable to [B, K].  Returns ``_DecodeOut(ids [B, K,
    T] int32, scores [B, K], lengths [B, K] int32)``, best first; a
    length is the position of the first ``end_id`` plus one, or T."""
    B, K = int(batch_size), int(beam_size)
    device = _device_of(init_state, bos_id)
    tokens = _start_tokens(bos_id, (B, K), device)
    # only beam 0 is live at t = 0: identical beams would fill the top-k
    scores = torch.full((B, K), _NEG_INF, dtype=torch.float32, device=device)
    scores[:, 0] = 0.0
    finished = torch.zeros((B, K), dtype=torch.bool, device=device)
    lane0 = torch.arange(B, device=device)[:, None] * K
    state = init_state
    toks, parents = [], []
    for t in range(int(max_len)):
        logits, state = step_fn(tokens.reshape(B * K), state)
        V = logits.shape[-1]
        lp = logits.reshape(B, K, V)
        if not logits_normalized:
            lp = torch.log_softmax(lp, dim=-1)
        scores, token, parent = beam_search_step(
            scores, lp, finished, K, end_id, length_penalty=length_penalty,
            step=t + 1)
        flat_parent = (parent + lane0).reshape(-1)
        state = tree_map(lambda s: s[flat_parent], state)
        finished = torch.gather(finished, 1, parent.long()) | (token == end_id)
        tokens = token
        toks.append(token)
        parents.append(parent)
    if not toks:
        empty = torch.zeros((B, K, 0), dtype=torch.int32, device=device)
        return _DecodeOut(empty, scores, torch.zeros_like(tokens))
    ids = _gather_tree_impl(torch.stack(toks), torch.stack(parents))
    ids = ids.permute(1, 2, 0).contiguous()                   # [B, K, T]
    is_end = (ids == end_id).to(torch.int32)
    first_end = torch.argmax(is_end, dim=-1)
    lengths = torch.where(is_end.amax(dim=-1) > 0, first_end + 1,
                          int(max_len)).to(torch.int32)
    return _DecodeOut(ids=ids, scores=scores, lengths=lengths)


def greedy_search_decode(step_fn, init_state, batch_size: int,
                         max_len: int, bos_id, end_id: int):
    """Greedy argmax decode.

    ``step_fn(tokens [B], state) -> (logits [B, V], state)``.  Each step
    takes the argmax of ``log_softmax(logits)`` (ties to the first index,
    as ``jnp.argmax``); a lane that has emitted ``end_id`` keeps emitting
    ``end_id`` and adds nothing to its score.  Returns ``(ids [B, T]
    int32, scores [B] f32)``."""
    state = init_state
    device = _device_of(state, bos_id)
    tokens = _start_tokens(bos_id, (batch_size,), device)
    score = torch.zeros(batch_size, dtype=torch.float32, device=device)
    finished = torch.zeros(batch_size, dtype=torch.bool, device=device)
    end = torch.full_like(tokens, int(end_id))
    out = []
    for _ in range(int(max_len)):
        logits, state = step_fn(tokens, state)
        lp = torch.log_softmax(logits.float(), dim=-1)
        nxt = torch.argmax(lp, dim=-1).to(torch.int32)
        step_lp = torch.gather(lp, 1, nxt[:, None].long())[:, 0]
        nxt = torch.where(finished, end, nxt)
        score = score + torch.where(finished, torch.zeros_like(step_lp),
                                    step_lp)
        finished = finished | (nxt == end)
        out.append(nxt)
        tokens = nxt
    if not out:
        return (torch.zeros(batch_size, 0, dtype=torch.int32,
                            device=device), score)
    return torch.stack(out, dim=1), score


class BeamSearchDecoder:
    """A cell (with an optional embedding and output layer) in the
    ``step_fn`` form, and ``tile_beam_merge_with_batch``."""

    def __init__(self, cell, start_token, end_token, beam_size,
                 embedding_fn=None, output_fn=None):
        self.cell = cell
        self.start_token = int(start_token)
        self.end_token = int(end_token)
        self.beam_size = int(beam_size)
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn

    @staticmethod
    def tile_beam_merge_with_batch(x, beam_size):
        """[B, ...] -> [B*beam, ...], each row repeated beam times."""
        return apply("tile_beam_merge", lambda v: torch.repeat_interleave(
            v, beam_size, dim=0), to_tensor_like(x))

    def _step_fn(self):
        def step_fn(tokens, state):
            inp = tokens
            if self.embedding_fn is not None:
                inp = self.embedding_fn(inp)
            out, state = self.cell(inp, state)
            if self.output_fn is not None:
                out = self.output_fn(out)
            return out, state

        return step_fn


def _unwrap(x):
    return x._value if isinstance(x, Tensor) else x


def dynamic_decode(decoder: BeamSearchDecoder, inits=None, max_step_num=32,
                   batch_size=None, length_penalty: float = 0.0,
                   logits_normalized: bool = False):
    """Run ``decoder`` for ``max_step_num`` steps from ``inits`` (its
    cell's state, tiled to [batch*beam, ...]).  Returns ``(ids Tensor [B,
    K, T], scores Tensor [B, K])``.  The decode records no autograd
    graph."""
    if inits is None:
        raise ValueError(
            "dynamic_decode requires inits (the decoder cell's initial "
            "state, tiled to [batch*beam, ...] with "
            "BeamSearchDecoder.tile_beam_merge_with_batch)")
    state = tree_map(lambda s: _unwrap(to_tensor_like(s)), inits)
    if batch_size is None:
        batch_size = tree_leaves(state)[0].shape[0] // decoder.beam_size
    step_fn_raw = decoder._step_fn()

    def step_fn(tokens, st):
        out, st = step_fn_raw(Tensor(tokens), tree_map(Tensor, st))
        return _unwrap(out), tree_map(_unwrap, st)

    with torch.no_grad():
        res = beam_search_decode(
            step_fn, state, batch_size, decoder.beam_size, max_step_num,
            decoder.start_token, decoder.end_token,
            logits_normalized=logits_normalized,
            length_penalty=length_penalty)
    return Tensor(res.ids), Tensor(res.scores)
