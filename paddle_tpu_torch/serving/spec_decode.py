"""Speculative decoding: n-gram drafter + K-token verifier — a copy of
``paddle_tpu/serving/spec_decode.py`` (host-side numpy only; the device
half is the engine's verify dispatch).

- **Drafter** (:class:`NgramDrafter`, pluggable via :class:`Drafter`):
  per lane it indexes the lane's own prompt+generated history by n-gram
  and proposes the continuation of the most recent earlier occurrence of
  the current suffix (prompt-lookup decoding); a bounded shared corpus of
  retired streams backs it up across requests.  A per-lane cooldown backs
  off exponentially after fully-rejected drafts.
- **Verifier** (``text.generation.make_gpt_paged_spec_verify_step``, or
  the ragged step on a ragged engine): one dispatch scores K tokens per
  lane causally and returns the greedy argmax at every position.
- **Accept rule** (:meth:`SpecDecoder.accept_len`): emit the verifier's
  token at every position whose INPUT was correct — the drafted prefix
  that matches the verifier's own outputs, then the verifier's next
  token at the first mismatch.  The emitted stream is exactly the greedy
  stream whatever the drafter proposed.
- **Rollback** (``ServingEngine._spec_step``): rejected positions hold
  junk K/V that ``seq_lens`` masks until the next real write overwrites
  it, so native and int8_static KV unwind for free.  int8_dynamic KV is
  the exception: junk writes grow per-page scales, so the engine gathers
  the touched pages before the dispatch, restores them on rejection and
  replays the accepted tokens one at a time, and the verifier runs the
  ``sequential=True`` schedule.

Threading: instances are owned by the engine's driving thread, like the
scheduler — no locks, no device calls.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..framework.errors import InvalidArgumentError

__all__ = ["Drafter", "NgramDrafter", "SpecDecoder"]

_EMPTY = np.zeros((0,), np.int32)


class Drafter:
    """The pluggable draft-source protocol.

    The engine feeds every lane's token stream through ``begin_lane`` /
    ``observe`` and asks ``propose`` for up to N continuation tokens
    before each speculative step; ``on_result`` reports how many
    survived verification so adaptive drafters can throttle.  The
    default is the model-free :class:`NgramDrafter`; a small draft
    MODEL slots in by implementing this interface (propose = run the
    draft model over the lane history) — the engine, accept rule and
    rollback are draft-source-agnostic.

    ``export_lane`` / ``import_lane`` carry a lane's adaptive state as
    plain python scalars: an ``EngineSnapshot``'s ``spec`` field carries
    it across a failover, so the lane resumes speculating on the
    survivor.
    """

    def begin_lane(self, seq_id: str, tokens) -> None:
        """A lane was admitted with ``tokens`` of history (its prompt,
        plus any tokens it already generated)."""

    def observe(self, seq_id: str, token: int) -> None:
        """One token was emitted on the lane's stream."""

    def propose(self, seq_id: str, max_tokens: int,
                tick: bool = True) -> np.ndarray:
        """Up to ``max_tokens`` drafted continuation tokens (int32, may
        be empty).  ``tick=True`` marks the once-per-engine-step
        throttle clock (the engine's pre-pipeline-collapse probe);
        ``tick=False`` calls are side-effect-free re-reads."""
        return _EMPTY

    def on_result(self, seq_id: str, drafted: int, accepted: int) -> None:
        """``accepted`` of ``drafted`` proposed tokens survived one
        verify dispatch."""

    def forget(self, seq_id: str) -> None:
        """The lane retired / aborted / was preempted — drop its state
        (a preempted request is re-admitted through ``begin_lane`` and
        deterministically replays)."""

    def ingest(self, tokens) -> None:
        """Publish a finished stream into the shared cross-request
        store (the engine feeds the same chains the prefix cache
        seals)."""

    def export_lane(self, seq_id: str) -> dict:
        return {}

    def import_lane(self, seq_id: str, state: dict) -> None:
        pass

    def stats(self) -> dict:
        return {}


class _LaneState:
    """Per-lane prompt-lookup index + adaptive throttle."""

    __slots__ = ("hist", "idx", "prev", "prompt_len", "miss_streak",
                 "cooldown")

    def __init__(self):
        self.hist: List[int] = []
        # n-gram -> continuation start of its MOST RECENT occurrence;
        # prev holds the occurrence before that (the most recent one is
        # usually the live suffix itself, which has no continuation yet)
        self.idx: Dict[Tuple[int, ...], int] = {}
        self.prev: Dict[Tuple[int, ...], int] = {}
        self.prompt_len = 0
        self.miss_streak = 0
        self.cooldown = 0


class NgramDrafter(Drafter):
    """Model-free n-gram / prompt-lookup drafter.

    ``propose`` matches the lane's most recent ``max_ngram..min_ngram``
    tokens against (a) the lane's OWN prompt+generated history —
    repetition and copy spans, the classic prompt-lookup signal — and
    (b) a bounded shared corpus of retired streams (system prompts,
    multi-turn history: exactly the content the prefix-cache radix
    index holds as pages, indexed here by n-gram instead of by page
    chunk).  Longest match wins; the continuation after the matched
    occurrence is the draft.  All dict lookups on host ints —
    deterministic and O(max_ngram) per call.

    After a draft is FULLY rejected the lane backs off exponentially
    (``cooldown = 2^miss_streak`` speculative steps, capped), so a
    stream with no exploitable structure converges to plain decode
    with a vanishing drafting tax.
    """

    COOLDOWN_CAP = 32

    def __init__(self, max_ngram: int = 8, min_ngram: int = 3,
                 max_corpora: int = 128):
        if not (1 <= int(min_ngram) <= int(max_ngram)):
            raise InvalidArgumentError(
                f"need 1 <= min_ngram <= max_ngram, got "
                f"min_ngram={min_ngram!r} max_ngram={max_ngram!r}")
        if int(max_corpora) < 0:
            raise InvalidArgumentError(
                f"max_corpora must be >= 0, got {max_corpora!r}")
        self.max_ngram = int(max_ngram)
        self.min_ngram = int(min_ngram)
        self.max_corpora = int(max_corpora)
        self._lanes: Dict[str, _LaneState] = {}
        # shared corpus: id -> token list, plus the n-gram view
        # (ngram -> (corpus id, continuation start), newest ingest
        # wins; eviction sweeps the victim's surviving entries so the
        # index stays bounded by the LIVE corpora — the lookup's
        # missing-corpus branch is only a defensive backstop)
        self._corpora: Dict[int, List[int]] = {}
        self._corpus_idx: Dict[Tuple[int, ...], Tuple[int, int]] = {}
        self._corpus_seen: Dict[int, int] = {}   # stream hash -> id
        self._next_corpus_id = 0
        self.proposals = 0
        self.proposed_tokens = 0
        self.cooldown_skips = 0

    # --- lane lifecycle -----------------------------------------------------
    def _lane(self, seq_id: str) -> _LaneState:
        st = self._lanes.get(seq_id)
        if st is None:
            st = self._lanes[seq_id] = _LaneState()
        return st

    def begin_lane(self, seq_id: str, tokens) -> None:
        st = self._lanes[seq_id] = _LaneState()
        for t in np.asarray(tokens).reshape(-1):
            self._push(st, int(t))
        st.prompt_len = len(st.hist)

    def observe(self, seq_id: str, token: int) -> None:
        self._push(self._lane(seq_id), int(token))

    def forget(self, seq_id: str) -> None:
        self._lanes.pop(seq_id, None)

    def _push(self, st: _LaneState, token: int):
        st.hist.append(token)
        L = len(st.hist)
        for n in range(self.min_ngram, self.max_ngram + 1):
            if L < n:
                break
            key = tuple(st.hist[-n:])
            old = st.idx.get(key)
            if old is not None:
                st.prev[key] = old
            st.idx[key] = L

    # --- shared corpus ------------------------------------------------------
    def ingest(self, tokens) -> None:
        if self.max_corpora == 0:
            return
        toks = [int(t) for t in np.asarray(tokens).reshape(-1)]
        if len(toks) <= self.min_ngram:
            return
        h = hash(tuple(toks))
        if h in self._corpus_seen:
            return                      # a re-retired identical stream
        cid = self._next_corpus_id
        self._next_corpus_id += 1
        self._corpora[cid] = toks
        self._corpus_seen[h] = cid
        for n in range(self.min_ngram, self.max_ngram + 1):
            for i in range(n, len(toks)):
                self._corpus_idx[tuple(toks[i - n:i])] = (cid, i)
        if len(self._corpora) > self.max_corpora:
            victim = min(self._corpora)          # oldest ingest
            dead = self._corpora.pop(victim)
            self._corpus_seen.pop(hash(tuple(dead)), None)
            # sweep the victim's surviving index entries (keys a newer
            # corpus overwrote stay) — the index stays bounded by the
            # live corpora's token count, not by total tokens served
            self._corpus_idx = {k: v for k, v in self._corpus_idx.items()
                                if v[0] != victim}

    def _corpus_lookup(self, key: Tuple[int, ...]
                       ) -> Optional[Tuple[List[int], int]]:
        ent = self._corpus_idx.get(key)
        if ent is None:
            return None
        toks = self._corpora.get(ent[0])
        if toks is None:
            del self._corpus_idx[key]            # evicted corpus: lazy GC
            return None
        return toks, ent[1]

    # --- drafting -----------------------------------------------------------
    def propose(self, seq_id: str, max_tokens: int,
                tick: bool = True) -> np.ndarray:
        st = self._lanes.get(seq_id)
        if st is None or max_tokens < 1:
            return _EMPTY
        if st.cooldown > 0:
            if tick:
                st.cooldown -= 1
                self.cooldown_skips += 1
            return _EMPTY
        L = len(st.hist)
        for n in range(min(self.max_ngram, L), self.min_ngram - 1, -1):
            key = tuple(st.hist[-n:])
            c = st.idx.get(key)
            if c == L:                  # the live suffix itself
                c = st.prev.get(key)
            # a self-match continuing from the GENERATED region is the
            # strongest signal there is (the stream is repeating its
            # own output — a greedy cycle); a self-match still inside
            # the PROMPT only predicts that the prompt's pattern keeps
            # going, which the prompt->generation boundary routinely
            # breaks — there, a shared-corpus stream that matched (a
            # previous completion of the same context, continuation
            # included) outranks it
            lane_hit = c is not None and c < L
            if lane_hit and c <= st.prompt_len:
                hit = self._corpus_lookup(key)
                if hit is not None:
                    toks, start = hit
                    draft = toks[start: start + max_tokens]
                    if draft:
                        if tick:
                            self.proposals += 1
                            self.proposed_tokens += len(draft)
                        return np.asarray(draft, np.int32)
            if lane_hit:
                # self-extension: when the continuation runs off the end
                # of history, the proposal wraps onto itself — for a
                # periodic stream (the common greedy attractor) this
                # predicts whole cycles, not just the tail fragment
                draft = []
                for j in range(max_tokens):
                    i = c + j
                    draft.append(st.hist[i] if i < L
                                 else draft[i - L])
            else:
                hit = self._corpus_lookup(key)
                if hit is None:
                    continue
                toks, start = hit
                draft = toks[start: start + max_tokens]
            if draft:
                if tick:
                    self.proposals += 1
                    self.proposed_tokens += len(draft)
                return np.asarray(draft, np.int32)
        return _EMPTY

    def on_result(self, seq_id: str, drafted: int, accepted: int) -> None:
        st = self._lanes.get(seq_id)
        if st is None or drafted <= 0:
            return
        if accepted > 0:
            st.miss_streak = 0
        else:
            st.miss_streak += 1
            st.cooldown = min(2 ** st.miss_streak, self.COOLDOWN_CAP)

    # --- adaptive lane state ------------------------------------------------
    def export_lane(self, seq_id: str) -> dict:
        st = self._lanes.get(seq_id)
        if st is None:
            return {}
        return {"miss_streak": int(st.miss_streak),
                "cooldown": int(st.cooldown)}

    def import_lane(self, seq_id: str, state: dict) -> None:
        st = self._lane(seq_id)
        st.miss_streak = int(state.get("miss_streak", 0))
        st.cooldown = int(state.get("cooldown", 0))

    def stats(self) -> dict:
        return {
            "kind": "ngram",
            "max_ngram": self.max_ngram,
            "min_ngram": self.min_ngram,
            "lanes": len(self._lanes),
            "corpora": len(self._corpora),
            "corpus_ngrams": len(self._corpus_idx),
            "proposals": self.proposals,
            "proposed_tokens": self.proposed_tokens,
            "cooldown_skips": self.cooldown_skips,
        }


class SpecDecoder:
    """Host-side orchestration glue between the engine and a Drafter.

    Owns the accept rule, the speculative-step counters and the
    drafter's lifecycle hooks; the ENGINE owns all device state (the
    verify dispatch, page reservation and rollback live in
    ``ServingEngine._spec_step``).  ``k`` is the verify dispatch width:
    one input position for the lane's real next token plus up to
    ``k - 1`` drafted tokens.
    """

    def __init__(self, k: int, drafter: Optional[Drafter] = None,
                 metrics=None, sequential: bool = False):
        if int(k) < 2:
            raise InvalidArgumentError(
                f"spec_decode horizon k must be >= 2 (k=1 is plain "
                f"decode), got {k!r}")
        if drafter is not None and not callable(
                getattr(drafter, "propose", None)):
            raise InvalidArgumentError(
                f"spec_drafter must implement the serving.spec_decode."
                f"Drafter protocol (propose/observe/...), got "
                f"{type(drafter).__name__}")
        self.k = int(k)
        self.drafter = drafter if drafter is not None else NgramDrafter()
        self.metrics = metrics
        # int8_dynamic engines verify on the sequential schedule and
        # roll junk pages back via gather/restore/replay (the engine
        # keys both behaviors off this flag)
        self.sequential = bool(sequential)
        self.steps = 0              # verify dispatches issued
        self.drafted = 0            # drafted tokens submitted to verify
        self.accepted = 0           # drafted tokens that survived
        self.rejected = 0
        self.rollbacks = 0          # lanes whose draft was cut short
        self.degraded = 0           # spec steps denied (chaos / pages)

    # --- lane lifecycle (engine hooks) --------------------------------------
    def on_admit(self, seq) -> None:
        """An admitted (or snapshot-resumed) sequence: seed the drafter
        with its full history (the prompt, plus any tokens it already
        generated) and, when resuming, restore the lane's adaptive state
        from the snapshot."""
        hist = seq.request.prompt
        if seq.generated:
            hist = np.concatenate(
                [hist, np.asarray(seq.generated, np.int32)])
        self.drafter.begin_lane(seq.seq_id, hist)
        resume = seq.request.resume
        spec_state = getattr(resume, "spec", None) if resume is not None \
            else None
        if spec_state:
            self.drafter.import_lane(seq.seq_id, spec_state)

    def on_token(self, seq_id: str, token: int) -> None:
        self.drafter.observe(seq_id, token)

    def on_retire(self, seq) -> None:
        """Retirement publishes the finished stream into the shared
        corpus — the same chain the prefix cache seals as pages."""
        self.drafter.ingest(np.concatenate(
            [seq.request.prompt, np.asarray(seq.generated, np.int32)]))
        self.drafter.forget(seq.seq_id)

    def on_drop(self, seq_id: str) -> None:
        """Abort / preemption / expiry: nothing publishable."""
        self.drafter.forget(seq_id)

    def on_degraded(self) -> None:
        self.degraded += 1

    # --- drafting -----------------------------------------------------------
    def propose(self, active, tick: bool = True) -> Dict[int, np.ndarray]:
        """Per-lane drafts (lane index -> up to k-1 tokens; empty-draft
        lanes ride the verify dispatch as plain decode).  ``tick=False``
        probes without mutating cooldowns."""
        return {lane: self.drafter.propose(seq.seq_id, self.k - 1,
                                           tick=tick)
                for lane, seq in active}

    def accept_len(self, draft: np.ndarray, out_col: np.ndarray) -> int:
        """The exact-greedy accept rule: emit ``out_col[:accept_len]``.

        ``out_col[j]`` is the verifier's argmax at position pos+j,
        whose input was ``draft[j-1]`` (j>=1; input 0 is the lane's
        real next token, always correct).  A drafted token is accepted
        iff it EQUALS the verifier's previous output — i.e. the
        verifier, fed the true prefix, would have produced it itself —
        and the verifier's own token at the first mismatch is emitted
        in its place.  The emitted stream is therefore byte-identical
        to plain greedy decode by construction.
        """
        a = 1
        for j in range(len(draft)):
            if int(draft[j]) != int(out_col[j]):
                break
            a += 1
        return a

    def on_verify(self, results) -> None:
        """Aggregate one verify dispatch's outcome.  ``results`` is
        ``[(seq_id, drafted, accepted_drafted), ...]`` per lane that
        carried a draft."""
        self.steps += 1
        drafted = accepted = rejected = rollbacks = 0
        for seq_id, d, a in results:
            self.drafter.on_result(seq_id, d, a)
            drafted += d
            accepted += a
            rejected += d - a
            if a < d:
                rollbacks += 1
        self.drafted += drafted
        self.accepted += accepted
        self.rejected += rejected
        self.rollbacks += rollbacks
        if self.metrics is not None and drafted:
            self.metrics.on_spec(drafted, accepted, rejected, rollbacks)

    # --- observability ------------------------------------------------------
    @property
    def accept_rate(self) -> float:
        return self.accepted / self.drafted if self.drafted else 0.0

    def stats(self) -> dict:
        return {
            "enabled": True,
            "k": self.k,
            "sequential": self.sequential,
            "steps": self.steps,
            "drafted": self.drafted,
            "accepted": self.accepted,
            "rejected": self.rejected,
            "rollbacks": self.rollbacks,
            "degraded": self.degraded,
            "accept_rate": self.accept_rate,
            "drafter": self.drafter.stats(),
        }
