"""Admission + token-budgeted step planning (Sarathi-style stall-free
batching).

Two planners share the admission/preemption machinery:

``plan_flat`` (the default ``flat`` engine policy) packs every step into ONE
flat ``(T,)`` token vector with per-token slot/position indices, budgeted
purely in tokens (``T = token_budget``, static):

* each *decoding* slot contributes its single last-sampled token first
  (decode is never starved — the TPOT side of the knob),
* the REMAINING budget is fair-shared across ALL concurrent prefilling
  slots — each live prefiller gets ``max(1, budget_left // n_live)`` tokens
  per round, oldest admission first, until the budget or the prompts run
  out (the TTFT side: no prefiller waits for an earlier one to finish),
* leftover rows are padding (slot sentinel ``B``; their KV writes are
  routed to a scratch row and never attended).

``token_budget`` is therefore the TTFT-vs-TPOT knob: a larger budget lands
more prefill tokens per step (lower TTFT) at the cost of a wider — slower —
step for the decoders riding along (higher TPOT).  When no slot is
prefilling the width collapses to ``T == slots``, a pure decode step.

``plan`` (the legacy ``chunked`` policy, kept as the equivalence reference)
is the rectangular ``(B, C)`` layout: each decoding slot contributes one
token, and at most ONE prefilling slot — strict FIFO by admission order,
served until its prompt is done — advances by up to ``prefill_chunk``
tokens; other prefillers wait as padding rows.  Per-step real work is
bounded by ``prefill_chunk + slots`` tokens, but every idle row is padding
the jitted matmuls multiply for nothing — the padding waste the flat
layout removes.

The planner also reserves KV blocks with the :class:`PagedKVCache` allocator;
if the pool cannot cover this step's growth it returns a :class:`Preempt`
directive naming a victim (youngest admission first, vLLM's recompute-style
preemption) instead of a plan.  Preemption frees the victim THROUGH the
refcount API (``kv.free_slot`` -> ``release``): blocks the victim forked
from the prefix cache — or that the cache registered from the victim — are
shared, and a direct free-list append would hand another request's live
blocks to new writers.

With a :class:`PrefixCache (not ported yet)` attached (see
``admit``), each admitted prompt starts its prefill at ``cached_len``: the
fully-cached leading blocks are forked, the partial last block (and always
at least the final prompt token) is recomputed, and the skipped tokens are
accounted in both the admission block budget and the step token budget.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from repro_torch.obs import NULL_TRACER


@dataclass
class SlotState:
    """Engine-side per-slot request progress."""
    req: object                       # serving.engine.Request
    prompt: np.ndarray                # tokens still to prefill (incl. resume)
    cursor: int = 0                   # prompt tokens already in the cache
    last_tok: int = 0                 # feeds the next decode step
    admitted_at: int = 0              # admission counter (preemption order)
    extra: int = 0                    # non-token cache positions (VLM patches)
    cached_len: int = 0               # prompt tokens served by the prefix cache

    @property
    def prefilling(self) -> bool:
        return self.cursor < len(self.prompt)


@dataclass
class StepPlan:
    """One static-shape batched step, host-side arrays ready for device."""
    tokens: np.ndarray                # (B, C) int32
    pos: np.ndarray                   # (B, C) int32 absolute positions
    lengths: np.ndarray               # (B,) int32 pre-step write offsets
    n_real: np.ndarray                # (B,) real (non-padding) tokens per slot
    emit: np.ndarray                  # (B,) bool — slot samples a token
    emit_idx: np.ndarray              # (B,) row offset of the emitting logit
    chunk: int                        # C, static step width
    view_blocks: int                  # block-table view width for this step
    prefill_slot: int = -1            # slot advancing its prefill (-1: none)
    prefill_tokens: int = 0
    decode_tokens: int = 0

    @property
    def real_tokens(self) -> int:
        return int(self.n_real.sum())

    def advances_prefill(self, i: int) -> bool:
        """Did slot ``i`` land prefill tokens this step?"""
        return i == self.prefill_slot


@dataclass
class FlatStepPlan:
    """One flat token-packed step: ``width`` rows, each a (token, slot, pos)
    triple.  Rows are grouped per slot in ascending slot order, positions
    ascending within a slot; padding rows carry the slot sentinel ``B``
    (their KV writes are routed to a scratch row and they are fully masked
    in attention)."""
    tokens: np.ndarray                # (T,) int32
    slot: np.ndarray                  # (T,) int32; padding rows == n_slots
    pos: np.ndarray                   # (T,) int32 absolute positions
    lengths: np.ndarray               # (B,) int32 pre-step write offsets
    n_real: np.ndarray                # (B,) real tokens landed per slot
    emit: np.ndarray                  # (B,) bool — slot samples a token
    emit_row: np.ndarray              # (B,) flat row of the emitting logit
    width: int                        # T, static step width (== planned)
    view_blocks: int                  # block-table view width for this step
    prefill_mask: np.ndarray = None   # (B,) bool — slot landed prefill tokens
    prefill_tokens: int = 0
    decode_tokens: int = 0

    @property
    def real_tokens(self) -> int:
        return int(self.n_real.sum())

    def advances_prefill(self, i: int) -> bool:
        """Did slot ``i`` land prefill tokens this step?"""
        return bool(self.prefill_mask[i])


@dataclass
class Preempt:
    """Free ``slot`` (recompute-style) so the step can get KV blocks."""
    slot: int


@dataclass
class ChunkedScheduler:
    prefill_chunk: int = 16
    _admissions: int = field(default=0, init=False)
    # Cumulative planning telemetry: chunk-tokens actually scheduled for
    # prefill vs prompt tokens the prefix cache served without scheduling.
    # The acceptance contract for prefix caching is asserted against these —
    # a warm cache must schedule strictly fewer prefill chunk-tokens.
    prefill_tokens_planned: int = field(default=0, init=False)
    cached_tokens_skipped: int = field(default=0, init=False)
    # Admissions of previously-preempted requests (recompute re-admissions);
    # the workload harness reports this alongside ``preemptions`` so a
    # preemption storm's recompute churn is visible per run.
    readmissions: int = field(default=0, init=False)
    # Prompt-too-long rejections (finished-ignored at admission).  Counted
    # here — not just trace-marked — so goodput denominators stay honest:
    # the engine mirrors this into its metrics registry and ``stats``.
    rejections: int = field(default=0, init=False)
    # Event tracer (repro_torch.obs.trace); the owning engine swaps in its own.
    # Admission events are emitted HERE because only the scheduler sees the
    # decision and its inputs (slot, cached fork length, rejections).
    tracer: object = field(default=NULL_TRACER, init=False, repr=False)

    # -- admission -----------------------------------------------------------

    def admit(self, slots: list, queue: list, kv, extra_positions: int = 0,
              reserve_full: bool = False,
              prefix_cache=None) -> list[tuple[int, SlotState]]:
        """Fill empty slots from the FIFO queue.

        ``reserve_full`` (whole-prefill policy) reserves the full prompt's KV
        blocks (+1 headroom token) at admission; the chunked policy instead
        allocates block-by-block as chunks land (``plan`` below), so blocks
        in use track live tokens, and only a first chunk's worth is gated
        here.  ``extra_positions`` are non-token cache positions every
        request carries (VLM patch tokens).  Returns the newly admitted
        (slot, state) pairs; the engine decides whether each prefills chunked
        or whole.

        ``prefix_cache`` (chunked policy only, and only when the request
        carries no non-token positions — a cached block's absolute positions
        must mean the same thing to every consumer): the longest cached
        full-block prefix of the prompt is FORKED into the slot at
        admission.  The slot starts with ``cached_len`` tokens already live
        (``cursor`` advanced past them), so ``plan`` below schedules only
        the uncached tail — cache hits are accounted in the admission block
        budget (the gate shrinks by the forked prefix) and in the step token
        budget (skipped tokens never occupy chunk width)."""
        admitted = []
        for i in range(len(slots)):
            if slots[i] is None:
                while queue:
                    req = queue[0]
                    prompt = np.concatenate(
                        [np.asarray(req.prompt, np.int32),
                         np.asarray(req.out_tokens, np.int32)])  # resume after preempt
                    total = len(prompt) + extra_positions + 1
                    if total > kv.max_len:
                        # Finished-ignored (vLLM semantics): can never fit.
                        # Retry this slot with the next queued request.
                        queue.pop(0)
                        req.done = True
                        req.t_done = time.perf_counter()
                        self.rejections += 1
                        if self.tracer.enabled:
                            self.tracer.end(req.uid, "queued")
                            self.tracer.mark(req.uid, "cancelled",
                                             reason="prompt_too_long",
                                             total_positions=total)
                            self.tracer.end(req.uid, "req")
                        continue
                    use_prefix = (prefix_cache is not None and not reserve_full
                                  and extra_positions == 0)
                    cached = prefix_cache.match(prompt)[0] if use_prefix else 0
                    gate = (total if reserve_full
                            else min(total - cached, self.prefill_chunk + 1))
                    if not kv.can_allocate(gate):
                        # FIFO: don't let short requests starve long ones.
                        return admitted
                    queue.pop(0)
                    st = SlotState(req=req, prompt=prompt, extra=extra_positions,
                                   admitted_at=self._admissions)
                    self._admissions += 1
                    if getattr(req, "n_preempted", 0) > 0:
                        self.readmissions += 1
                    if reserve_full:
                        kv.ensure(i, total)
                    if use_prefix:
                        # Fork takes the block references and advances
                        # kv.lengths; telemetry (hit/miss tokens) is counted
                        # exactly once per admission inside fork().
                        st.cached_len = prefix_cache.fork(i, prompt)
                        st.cursor = st.cached_len
                        self.cached_tokens_skipped += st.cached_len
                    if self.tracer.enabled:
                        self.tracer.end(req.uid, "queued")
                        self.tracer.mark(
                            req.uid, "admitted", slot=i,
                            cached_len=st.cached_len,
                            readmission=getattr(req, "n_preempted", 0) > 0)
                        if st.cached_len:
                            self.tracer.mark(req.uid, "prefix_hit",
                                             cached_len=st.cached_len)
                    slots[i] = st
                    admitted.append((i, st))
                    break
        return admitted

    # -- step planning -------------------------------------------------------

    def plan(self, slots: list, kv) -> StepPlan | Preempt | None:
        b = len(slots)
        active = [i for i in range(b) if slots[i] is not None]
        if not active:
            return None

        prefillers = sorted((i for i in active if slots[i].prefilling),
                            key=lambda i: slots[i].admitted_at)
        pf = prefillers[0] if prefillers else -1
        chunk = self.prefill_chunk if pf >= 0 else 1

        tokens = np.zeros((b, chunk), np.int32)
        pos = np.zeros((b, chunk), np.int32)
        lengths = np.zeros(b, np.int32)
        n_real = np.zeros(b, np.int32)
        emit = np.zeros(b, bool)
        emit_idx = np.zeros(b, np.int32)
        n_prefill = n_decode = 0

        for i in active:
            st = slots[i]
            ln = int(kv.lengths[i])
            lengths[i] = ln
            if i == pf:
                c = min(chunk, len(st.prompt) - st.cursor)
                if not kv.ensure(i, ln + c):
                    return Preempt(self._victim(slots, active))
                tokens[i, :c] = st.prompt[st.cursor:st.cursor + c]
                pos[i] = ln + np.minimum(np.arange(chunk), c - 1)
                n_real[i] = c
                emit[i] = st.cursor + c == len(st.prompt)  # prompt done: TTFT
                emit_idx[i] = c - 1
                n_prefill += c
            elif st.prefilling:
                # Waits its turn; padding row (writes land past its live
                # length / in scratch, never attended).
                pos[i] = max(ln - 1, 0)
            else:
                if not kv.ensure(i, ln + 1):
                    return Preempt(self._victim(slots, active))
                tokens[i, 0] = st.last_tok
                pos[i] = ln
                n_real[i] = 1
                emit[i] = True
                n_decode += 1

        needed = int(max(kv.lengths[i] for i in active)) + chunk
        self.prefill_tokens_planned += n_prefill
        return StepPlan(tokens=tokens, pos=pos, lengths=lengths, n_real=n_real,
                        emit=emit, emit_idx=emit_idx, chunk=chunk,
                        view_blocks=kv.view_blocks(needed),
                        prefill_slot=pf, prefill_tokens=n_prefill,
                        decode_tokens=n_decode)

    def plan_flat(self, slots: list, kv,
                  token_budget: int) -> FlatStepPlan | Preempt | None:
        """Token-budget fair-share planning into a flat ``(T,)`` layout.

        Decode slots are served first (one token each, never starved); the
        remaining budget is split across ALL concurrent prefillers in
        fair-share rounds (``max(1, left // n_live)`` each, oldest admission
        first) until the budget or the prompts run out.  Waiting prefillers
        simply contribute zero rows — the flat layout has no per-slot
        padding.  Invariant (property-tested): ``sum(n_real) ==
        min(token_budget, available tokens)`` and each slot's rows appear in
        ascending position order."""
        b = len(slots)
        active = [i for i in range(b) if slots[i] is not None]
        if not active:
            return None

        decoders = [i for i in active if not slots[i].prefilling]
        prefillers = sorted((i for i in active if slots[i].prefilling),
                            key=lambda i: slots[i].admitted_at)

        take = dict.fromkeys(active, 0)
        for i in decoders:
            take[i] = 1
        left = token_budget - len(decoders)
        need = {i: len(slots[i].prompt) - slots[i].cursor for i in prefillers}
        live = [i for i in prefillers if need[i] > 0]
        while left > 0 and live:
            share = max(1, left // len(live))
            for i in list(live):
                c = min(share, need[i], left)
                take[i] += c
                need[i] -= c
                left -= c
                if need[i] == 0:
                    live.remove(i)
                if left == 0:
                    break

        n_prefill = sum(take[i] for i in prefillers)
        # Pure-decode steps collapse to T == slots (the cheap second trace);
        # any prefill work runs at the full static budget width.
        width = token_budget if n_prefill else b

        tokens = np.zeros(width, np.int32)
        slot = np.full(width, b, np.int32)        # sentinel: padding row
        pos = np.zeros(width, np.int32)
        lengths = np.zeros(b, np.int32)
        n_real = np.zeros(b, np.int32)
        emit = np.zeros(b, bool)
        emit_row = np.zeros(b, np.int32)
        prefill_mask = np.zeros(b, bool)

        row = 0
        for i in active:
            st = slots[i]
            ln = int(kv.lengths[i])
            lengths[i] = ln
            c = take[i]
            if c == 0:
                continue                          # prefiller waiting its turn
            if not kv.ensure(i, ln + c):
                return Preempt(self._victim(slots, active))
            if st.prefilling:
                tokens[row:row + c] = st.prompt[st.cursor:st.cursor + c]
                emit[i] = st.cursor + c == len(st.prompt)  # prompt done: TTFT
                prefill_mask[i] = True
            else:
                tokens[row] = st.last_tok
                emit[i] = True
            slot[row:row + c] = i
            pos[row:row + c] = ln + np.arange(c)
            n_real[i] = c
            emit_row[i] = row + c - 1
            row += c

        needed = max(int(kv.lengths[i]) + take[i] for i in active)
        self.prefill_tokens_planned += n_prefill
        return FlatStepPlan(tokens=tokens, slot=slot, pos=pos,
                            lengths=lengths, n_real=n_real, emit=emit,
                            emit_row=emit_row, width=width,
                            view_blocks=kv.view_blocks(needed),
                            prefill_mask=prefill_mask,
                            prefill_tokens=n_prefill,
                            decode_tokens=len(decoders))

    @staticmethod
    def _victim(slots: list, active: list[int]) -> int:
        if len(active) <= 1:
            raise RuntimeError(
                "KV block pool too small for a single request; "
                "raise num_blocks / lower max_len")
        return max(active, key=lambda i: slots[i].admitted_at)
