"""Distributed stable sort over a 1-D device mesh (shard_map + collectives).

All new design (the reference is single-GPU; SURVEY.md §2/§7.5). Algorithm —
sample sort with index-tie-broken splitters, expressed with static shapes
throughout:

0. **Mod-P interleaved pre-exchange**: one exact ``all_to_all`` (with a
   free local transpose) redistributes the contiguous input shards so
   chip j holds exactly the global positions ≡ j (mod P). Combined with
   step 2's index tie-break this bounds every (src,dst) exchange segment
   near ``B/P`` even for already-sorted, constant, dense-duplicate, or
   Zipf-skewed keys (position-contiguous masses split with deviation
   <= 1 per chip) — the static-capacity analogue of a ragged all_to_all.
1. **Local sort** of the shard (``jnp.lexsort`` over the u32 word
   tuple). The compare tuple ends with the original
   global index word, so local sorts are stable and all tuples are
   globally distinct. For keys-only sorts whose output is rebuilt from the
   key bits, the index word(s) are *local-only*: synthesized after the
   (deterministic) stride pre-exchange from ``iota`` + ``axis_index`` and
   dropped again before the ring exchange, so they never touch the wire
   (``idx_synth`` — 3x exchange-wire cut in the wide-index regime).
2. **Splitters**: each chip all_gathers ``s`` evenly spaced sample tuples
   from its sorted shard (``s = oversample*P``); a replicated lexsort of
   the sample picks the P-1 global splitter tuples. Ties in key split by
   original index — equal-key masses spread evenly over destination
   chips. Then **exact-rank refinement** (``_refine_cuts``, default on):
   a few rounds of [all_gather k rank-evenly-spaced candidate tuples per
   chip per boundary -> exact global ranks via vectorized searchsorted +
   psum -> shrink the bracket (k+1)-fold], driving the splitter rank
   error from O(B*P/s) down to W_f = O(P). This is what lets the
   exchange capacity sit at ~B/P instead of 1.5*B/P, and removes the
   old _SAMPLE_BUDGET precision cliff at P > 128 (cf. PAPERS.md
   "Histogram Sort with Sampling" — refinement here is sample-based
   because tuples with index tie-breaks rank exactly on every
   distribution, where bucket histograms lose precision on duplicates;
   see docs/DESIGN.md §3b).
3. **Partition**: local cuts = vectorized binary search of splitter tuples
   in the sorted shard (refined mode: the tracked hi-bracket positions).
4. **Exchange + merge, overlapped**: P-1 ``ppermute`` ring rounds of one
   static ``(cap,)`` sentinel-padded buffer per word, cap =
   max(slack*B/P, B/P + 2*W_f + margin) + 8 where margin =
   max(8*sqrt(B/P), B/P/16) cushions hypergeometric stride-granularity
   fluctuations (with ``refine=False``: the classic
   B/P + 2*ceil(B*P*/s) sampling bound with slack 1.5 and the
   _SAMPLE_BUDGET cap on s); received sorted runs fold into a
   binary-counter merge tree *between* rounds, so XLA's scheduler can
   overlap the merges with the in-flight collective-permutes
   (``_ring_exchange_merge``). Any
   capacity violation raises (or returns the ``check=True`` flag) — never
   silent truncation. Entry pads (all-sentinel tuples) are never
   exchanged: cuts clip at the real-element count.
6. **Boundary rebalance**: exact output ranks from an all_gather of counts;
   each chip keeps the bulk of its run locally (a static-size dynamic
   slice) and ships only the boundary pieces — bounded by the cumulative
   splitter drift, so they travel to *ring neighbors* only: 2R ppermutes
   of one (cap3,) buffer each (an all_to_all of (P, cap3) rows would ship
   (P-1)x padding); a final local sort compacts. Output: exactly B
   elements per chip, i.e. the input's own sharding.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from .. import keybits
from ..config import SortOrder
from ..ops import words
from ..ops.words import SENTINEL

AXIS = "shards"


def make_sort_mesh(devices=None) -> Mesh:
    devices = jax.devices() if devices is None else devices
    return Mesh(np.array(devices), (AXIS,))


# ---------------------------------------------------------------------------
# word-tuple helpers (shard-local)
# ---------------------------------------------------------------------------


def _tuple_lt(a_words, b_words):
    """a <lex b for equal-length lists of u32 arrays (broadcasting ok)."""
    lt = a_words[-1] < b_words[-1]
    for aw, bw in zip(reversed(a_words[:-1]), reversed(b_words[:-1])):
        lt = (aw < bw) | ((aw == bw) & lt)
    return lt


def _local_sort_words(cmp_words, carry_words):
    # lexsort is stable; primary key must come last
    perm = jnp.lexsort(tuple(reversed(cmp_words)))
    return ([w[perm] for w in cmp_words], [w[perm] for w in carry_words])


def _searchsorted_words(sorted_words, query_words):
    """Left insertion points of query tuples in sorted word tuples.

    sorted_words: list of (B,) u32; query_words: list of (Q,) or (Q, M)
    u32 (any shape — the search is elementwise over the query shape).
    """
    B = sorted_words[0].shape[0]
    qshape = query_words[0].shape
    lo = jnp.zeros(qshape, jnp.int32)
    hi = jnp.full(qshape, B, jnp.int32)
    steps = max(int(math.ceil(math.log2(max(B, 1)))) + 1, 1)
    for _ in range(steps):
        mid = (lo + hi) // 2
        mid_c = jnp.minimum(mid, B - 1)
        vals = [w[mid_c] for w in sorted_words]
        go_right = _tuple_lt(vals, query_words) & (mid < B)  # sorted[mid] < q
        lo = jnp.where(go_right, mid + 1, lo)
        hi = jnp.where(go_right, hi, mid)
    return lo


def refine_plan(B: int, P_: int, s: int, k: int = 8):
    """Static (rounds, W_f) for the exact-rank splitter refinement.

    E0 = ceil(B*P/s) bounds a round-A sample splitter's global rank error
    (regular-sampling drift, docs/DESIGN.md §3), so each chip's local
    candidate window is 2*E0 wide and the total candidate space is
    W_0 = 2*P*E0 elements. Each refinement round gathers k
    rank-evenly-spaced candidate tuples per chip per boundary with
    *exact* global ranks (all_gather + vectorized searchsorted + psum),
    shrinking the bracket to W' <= W/(k+1) + P + 2 (no candidate lies
    strictly inside the new bracket, so on each chip it spans at most
    one inter-candidate gap <= w_p/(k+1) + 1; sum over chips). Iterate
    to the fixed point ~1.1*P: the capacity floor becomes B/P + 2*W_f —
    O(P) instead of O(B*P/s), so the _SAMPLE_BUDGET cap at P > 128 no
    longer widens buffers (the pod-scale precision cliff is closed).
    Round count is ~log_{k+1}(B/16), independent of P.
    """
    W = 2 * P_ * int(math.ceil(B * P_ / max(s, 1))) + 2 * P_
    rounds = 0
    while rounds < 16 and W > P_ + 16:
        Wn = W // (k + 1) + P_ + 2
        if Wn >= W:
            break
        W, rounds = Wn, rounds + 1
    return rounds, W


def _refine_cuts(cmp_words, nreal, cuts0, E0: int, rounds: int, k: int,
                 targets, rank_dt, P_: int):
    """Refine round-A splitter cuts to near-exact global target ranks.

    cmp_words: full sorted local tuple (bits + index words — all tuples
    globally distinct, so ranks are unambiguous on every distribution,
    duplicates included; this is why refinement is sample-based rather
    than bucket-histogram-based, see docs/DESIGN.md §3b). cuts0: (Q,)
    initial local insertion points of the sample splitters; targets: (Q,)
    static global target ranks (rank_dt). Returns refined (Q,) local cuts
    whose global rank error is <= W_f of refine_plan. Invariant each
    round: the true rank-target splitter's local insertion point t_p lies
    in [l_p, h_p] on every chip (a local shift never exceeds the global
    rank shift).
    """
    Q = cuts0.shape[0]
    l = jnp.maximum(cuts0 - E0, 0)
    h = jnp.minimum(cuts0 + E0, nreal)
    big = jnp.asarray(jnp.iinfo(rank_dt).max, rank_dt)
    # global ranks of the current brackets (unknown until a candidate is
    # adopted): a bracket may only ever be replaced by a strictly BETTER
    # candidate — small windows cannot re-propose the element sitting
    # exactly at h (positions are strictly inside (l, h)), so an
    # unconditional update could swap a tight bracket for a worse one
    r_lo_cur = jnp.full((Q,), rank_dt(-1))
    r_hi_cur = jnp.full((Q,), big)
    for _ in range(rounds):
        # k candidates per chip per boundary, rank-evenly spaced in (l, h)
        j = jnp.arange(1, k + 1, dtype=jnp.int32)
        pos = l[:, None] + ((h - l)[:, None] * j[None, :]) // (k + 1)
        pos_c = jnp.minimum(pos, jnp.maximum(nreal - 1, 0))  # (Q, k)
        cand = [jax.lax.all_gather(w[pos_c], AXIS, axis=1).reshape(Q, -1)
                for w in cmp_words]  # (Q, P*k) per word, replicated
        ins = _searchsorted_words(cmp_words, cand)  # (Q, P*k) local
        ranks = jax.lax.psum(ins.astype(rank_dt), AXIS)  # exact global
        t = targets[:, None]
        # best lo: max rank <= target; best hi: min rank > target
        rank_lo = jnp.where(ranks <= t, ranks, -1)
        rank_hi = jnp.where(ranks > t, ranks, big)
        i_lo = jnp.argmax(rank_lo, axis=1)
        i_hi = jnp.argmin(rank_hi, axis=1)
        r_lo = jnp.take_along_axis(rank_lo, i_lo[:, None], 1)[:, 0]
        r_hi = jnp.take_along_axis(rank_hi, i_hi[:, None], 1)[:, 0]
        better_lo = r_lo > r_lo_cur
        better_hi = r_hi < r_hi_cur
        l_new = jnp.take_along_axis(ins, i_lo[:, None], 1)[:, 0]
        h_new = jnp.take_along_axis(ins, i_hi[:, None], 1)[:, 0]
        l = jnp.where(better_lo, l_new, l)
        h = jnp.where(better_hi, h_new, h)
        r_lo_cur = jnp.where(better_lo, r_lo, r_lo_cur)
        r_hi_cur = jnp.where(better_hi, r_hi, r_hi_cur)
    # Cut at the hi bracket: h is the local *left* insertion point of the
    # smallest candidate with global rank > target (or the clipped
    # initial window if no such candidate exists — which happens exactly
    # when the target rank is at/past the real count, where cut = nreal
    # is the correct answer). Cutting below the hi candidate sends every
    # element of rank < rank(hi) left: global rank error in (0, W_f],
    # and an element lands at most ceil(W_f/B)+1 chips from its true
    # chip even when W_f >= B (degenerate tiny shards) — the lo bracket
    # would instead let the boundary-sitting element itself skip right
    # across every repeated boundary, blowing the rebalance radius.
    # cummax: independent per-boundary selections can cross by < W_f.
    return jax.lax.cummax(jnp.minimum(h, nreal))


def _a2a(x):
    return jax.lax.all_to_all(x, AXIS, split_axis=0, concat_axis=0, tiled=True)


def _synth_index_words(B: int, P_: int, me, n: int, n_idx: int):
    """Global-index word(s) of the post-pre-exchange local shard, built
    locally from ``iota`` + ``axis_index`` — zero wire cost.

    The mod-P interleaved pre-exchange is a *deterministic* permutation:
    local slot ``p = i*sub + t`` on chip ``me`` (sub = B/P) holds the
    element that chip ``i`` held at local offset ``t*P + me``, i.e.
    global position ``i*B + t*P + me``. Entry pads (global position
    >= n) get all-ones index words so they sort to the local tail exactly
    as entry-materialized index words would (pad detection + clipped cuts
    rely on this).
    """
    sub = B // P_
    if n_idx == 2:
        pos = jax.lax.iota(jnp.uint64, B)
        sub64 = jnp.uint64(sub)
        g = ((pos // sub64) * jnp.uint64(B)
             + (pos % sub64) * jnp.uint64(P_) + me.astype(jnp.uint64))
        pad = g >= jnp.uint64(n)
        hi, lo = words.split_u64(g)
        return [jnp.where(pad, SENTINEL, hi), jnp.where(pad, SENTINEL, lo)]
    pos = jax.lax.iota(jnp.uint32, B)
    sub32 = jnp.uint32(sub)
    g = ((pos // sub32) * jnp.uint32(B)
         + (pos % sub32) * jnp.uint32(P_) + me.astype(jnp.uint32))
    return [jnp.where(g >= jnp.uint32(n), SENTINEL, g)]


# ---------------------------------------------------------------------------
# the shard-local pipeline
# ---------------------------------------------------------------------------


def _merge_two_runs(a_words, b_words, ncmp):
    """Merge two sorted sentinel-padded runs (word lists) into one."""
    merged = [jnp.concatenate([aw, bw]) for aw, bw in zip(a_words, b_words)]
    cw, kw = _local_sort_words(merged[:ncmp], merged[ncmp:])
    return list(cw) + list(kw)


def _ring_exchange_merge(words, ncmp, cuts, lens, cap, P_, me):
    """Main exchange as P-1 ``ppermute`` rounds with an overlapped merge.

    Equivalent in bytes and result to the all_to_all + merge-tree pair, but
    round r's collective-permute has no data dependency on the merges of
    rounds < r, so XLA's latency-hiding scheduler can run the
    collective-permute-start/done of the next round concurrently with the
    merges of the previous ones. Received runs fold into a
    binary-counter merge tree (amortized one merge per round, total work
    identical to the post-hoc tree). Graph size is O(P) — fine for the
    pod-scale meshes psort targets (P <= a few hundred).

    words: full sorted local words (cmp+carry); cuts/lens: (P+1,)/(P,)
    partition of the real prefix. Returns (merged words, real count).
    """
    fills = [SENTINEL if i < ncmp else jnp.uint32(0)
             for i in range(len(words))]
    # pad once (not per round): extract's dynamic slices stay in bounds
    padded = [jnp.concatenate([w, jnp.full((cap,), f, jnp.uint32)])
              for w, f in zip(words, fills)]

    def extract(q, ln):
        keep = jax.lax.broadcasted_iota(jnp.int32, (cap,), 0) < ln
        return [jnp.where(keep,
                          jax.lax.dynamic_slice(w, (cuts[q],), (cap,)), f)
                for w, f in zip(padded, fills)]

    levels: dict = {}

    def push(run):
        k = 0
        while k in levels:
            run = _merge_two_runs(levels.pop(k), run, ncmp)
            k += 1
        levels[k] = run

    count = jnp.minimum(cuts[me + 1] - cuts[me], cap)
    push(extract(me, count))
    for r in range(1, P_):
        perm = [(s, (s + r) % P_) for s in range(P_)]
        q = (me + jnp.int32(r)) % P_
        ln = lens[q]
        sent = extract(q, ln)
        ln_r = jax.lax.ppermute(ln.reshape(1), AXIS, perm)[0]
        run = [jax.lax.ppermute(w, AXIS, perm) for w in sent]
        count = count + ln_r
        push(run)
    runs = [levels[k] for k in sorted(levels)]
    acc = runs[0]
    for run in runs[1:]:
        acc = _merge_two_runs(run, acc, ncmp)
    return acc, count


def _psort_shard(cmp_words, carry_words, *, P_, cap, cap3, sample_s,
                 n_idx=1, idx_synth=None, refine=None):
    """Runs inside shard_map; all words are (B,) u32 local shards.

    The last cmp word must be the original global index (distinct tuples) —
    unless ``idx_synth`` is set (the keys-only fast path): then the entry
    never materialized index words, the pre-exchange ships key bits only,
    ``n_idx`` index word(s) are synthesized here from iota + axis_index
    (``_synth_index_words``), used for the stable local sort / tie-broken
    splitter cuts / pad detection, and dropped again before the ring
    exchange — tie-swaps among equal key bits are unobservable when keys
    are rebuilt from bits, and every downstream count is length-tracked,
    never sentinel-scanned. This cuts main-exchange + pre-exchange +
    rebalance wire W-fold (3x for u32 keys at n >= 2**32).
    ``idx_synth`` is the static global real-element count n.
    Returns (cmp_words, carry_words, overflow): exactly B sorted elements
    per chip — chip p holds global sorted ranks [p*B, (p+1)*B).
    """
    me = jax.lax.axis_index(AXIS).astype(jnp.int32)
    B = cmp_words[0].shape[0]
    ncmp = len(cmp_words)

    # 0. stride pre-exchange with mod-P interleave: local position
    # t*P + j (global i*B + t*P + j) rides row j of the all_to_all, so
    # chip j ends up holding exactly the global positions ≡ j (mod P).
    # Any position-contiguous element mass (constant keys, presorted
    # runs, dense duplicate blocks) then splits across chips with count
    # deviation <= 1 per chip — a sub-block (non-interleaved) exchange
    # instead leaves block-granularity deviations up to ~B/P per chip
    # for masses at density < 1 (measured: +37% segment excess on a 95%
    # two-value input), which no sub-2x capacity could bound. Wire cost
    # is identical; the transpose is local.
    sub = B // P_
    words = [(_a2a(w.reshape(sub, P_).T)).reshape(-1)
             for w in list(cmp_words) + list(carry_words)]

    sort_cmp, sort_carry = words[:ncmp], words[ncmp:]
    if idx_synth is not None:
        sort_cmp = sort_cmp + _synth_index_words(B, P_, me, idx_synth, n_idx)
    ncmp_s = len(sort_cmp)  # cmp width during local sort/splitters/cuts

    # 1. local stable sort
    cmp_words, carry_words = _local_sort_words(sort_cmp, sort_carry)

    # 2. sample + replicated splitter selection (s per chip, P*s replicated;
    # s is budget-capped by the entry — see _psort_entry)
    s = sample_s
    pos = np.asarray([(i * B) // s for i in range(s)], np.int32)
    samples = [jax.lax.all_gather(w[pos], AXIS).reshape(-1)
               for w in cmp_words]  # each (P*s,)
    order = jnp.lexsort(tuple(reversed(samples)))
    ranks = np.asarray([q * (P_ * s) // P_ for q in range(1, P_)], np.int32)
    sel = order[ranks]
    splitters = [w[sel] for w in samples]  # (P-1,) per cmp word

    # 3. cuts (distinct tuples: left == right insertion point). Entry pads
    # are all-sentinel tuples that sort to the local tail (a real tuple's
    # index words are never all-ones); they are *identical* — exchanging
    # them would both waste bandwidth and, bunching onto the last chip,
    # falsely trip the capacity check at small n — so clip every cut to the
    # real-element count and never ship a pad: receivers re-synthesize
    # sentinel fill for free.
    pad_mask = cmp_words[ncmp_s - n_idx] == SENTINEL
    for w in cmp_words[ncmp_s - n_idx + 1:ncmp_s]:
        pad_mask &= w == SENTINEL
    nreal = B - jnp.sum(pad_mask.astype(jnp.int32))
    cut = jnp.minimum(_searchsorted_words(cmp_words, splitters), nreal)
    if refine is not None and refine[0] > 0:
        # 2b. exact-rank splitter refinement (_refine_cuts): shrinks the
        # splitter rank error from O(B*P/s) to W_f = O(P), which is what
        # lets cap sit at ~B/P instead of 1.5*B/P (and closes the
        # P > 128 sample-budget precision cliff, docs/DESIGN.md §3b).
        # Targets are the *padded* quantiles q*B (chip q outputs global
        # ranks [q*B, (q+1)*B) with entry pads at the global tail), so a
        # target past the real count just converges the cut to nreal —
        # real-count quantiles would instead strand the pad deficit on
        # far chips and blow the rebalance radius at small n.
        rounds, E0, k_ref = refine
        rank_dt = jnp.int64 if P_ * B >= (1 << 31) else jnp.int32
        targets = jnp.asarray([q * B for q in range(1, P_)], rank_dt)
        cut = jnp.minimum(_refine_cuts(cmp_words, nreal, cut, E0, rounds,
                                       k_ref, targets, rank_dt, P_), nreal)
    cuts = jnp.concatenate([jnp.zeros((1,), jnp.int32), cut,
                            nreal.reshape(1)])
    seg = cuts[1:] - cuts[:-1]
    overflow = jnp.any(seg > cap)
    if idx_synth is not None:
        # drop the synthesized index word(s): from here on only length-
        # tracked counts matter, and equal-bits tie order is unobservable
        # in the keys-from-bits output (sentinel fill colliding with real
        # all-ones key bits is likewise harmless: identical words).
        cmp_words = cmp_words[:ncmp]

    # 4+5. main exchange and merge, fused as a ring with overlapped merges
    # (see _ring_exchange_merge)
    merged, count = _ring_exchange_merge(
        list(cmp_words) + list(carry_words), ncmp, cuts,
        jnp.minimum(seg, cap), cap, P_, me)
    cmp_words, carry_words = merged[:ncmp], merged[ncmp:]
    count = count.astype(jnp.int32)

    # 6. boundary rebalance to exactly B per chip. Global ranks (tgt,
    # start_me) reach n_pad = P*B and overflow int32 once n >= 2**31 —
    # promote the *global* arithmetic to i64 there; the clipped local cuts
    # always fit i32 (<= count <= P*cap).
    rank_dt = jnp.int64 if P_ * B >= (1 << 31) else jnp.int32
    counts = jax.lax.all_gather(count, AXIS).astype(rank_dt)  # (P,)
    start_me = (jnp.cumsum(counts) - counts)[me]
    tgt = jnp.arange(P_ + 1, dtype=rank_dt) * B
    cuts3 = jnp.clip(tgt - start_me, 0, count.astype(rank_dt)).astype(jnp.int32)
    seg3 = cuts3[1:] - cuts3[:-1]
    # the piece destined to myself stays local (it can be ~B long); only the
    # boundary drift travels — and it travels to *nearby* chips only (the
    # boundary shift is the cumulative count drift). An all_to_all of
    # (P, cap3) buffers would ship P-1 rows of padding per chip (~2B words
    # of wire for ~B*P/s of payload, s = budget-capped sample count);
    # instead ship one (cap3,) buffer to each of the 2R ring neighbors via
    # ppermute — wire drops (P-1)/2R-fold. Pieces beyond the
    # radius or over cap3 raise the overflow flag (error, never silent).
    remote = jnp.arange(P_, dtype=jnp.int32) != me
    R = min(P_ - 1, 4)
    beyond = remote & (jnp.abs(jnp.arange(P_, dtype=jnp.int32) - me) > R)
    overflow = (overflow | jnp.any(beyond & (seg3 > 0))
                | jnp.any(remote & (seg3 > cap3)))
    send3 = jnp.where(remote, jnp.minimum(seg3, cap3), 0)
    allw = list(cmp_words) + list(carry_words)
    pieces = [[] for _ in allw]
    for d in [s * r for r in range(1, R + 1) for s in (1, -1)]:
        perm = [(s, (s + d) % P_) for s in range(P_)]
        q = me + d  # my piece destined to chip q rides offset d
        valid = (q >= 0) & (q < P_)
        qc = jnp.clip(q, 0, P_ - 1)
        ln = jnp.where(valid, send3[qc], 0)
        for i, w in enumerate(allw):
            fill = SENTINEL if i < ncmp else jnp.uint32(0)
            chunk = jax.lax.dynamic_slice(
                jnp.concatenate([w, jnp.full((cap3,), fill, jnp.uint32)]),
                (cuts3[qc],), (cap3,))
            keep = jax.lax.broadcasted_iota(jnp.int32, (cap3,), 0) < ln
            pieces[i].append(jax.lax.ppermute(
                jnp.where(keep, chunk, fill), AXIS, perm))
    recv3 = [jnp.concatenate(pl) if pl else
             jnp.zeros((0,), jnp.uint32) for pl in pieces]

    k0, k1 = cuts3[me], cuts3[me + 1]
    kept_mask_len = k1 - k0
    kept_words = []
    for i, w in enumerate(list(cmp_words) + list(carry_words)):
        fill = SENTINEL if i < ncmp else jnp.uint32(0)
        slack = jnp.full((B,), fill, jnp.uint32)
        kept = jax.lax.dynamic_slice(jnp.concatenate([w, slack]), (k0,), (B,))
        keep = jax.lax.broadcasted_iota(jnp.int32, (B,), 0) < kept_mask_len
        kept_words.append(jnp.where(keep, kept, fill))

    final_words = [jnp.concatenate([kw, r3])
                   for kw, r3 in zip(kept_words, recv3)]
    cmp_words, carry_words = _local_sort_words(
        final_words[:ncmp], final_words[ncmp:])
    cmp_words = tuple(w[:B] for w in cmp_words)
    carry_words = tuple(w[:B] for w in carry_words)
    overflow = jax.lax.psum(overflow.astype(jnp.int32), AXIS) > 0
    return cmp_words, carry_words, overflow


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


_METHODS = ("auto", "lexsort")


def _check_method(method: str) -> None:
    """The shard-local sort is always ``jnp.lexsort``; ``method`` is kept
    for API symmetry with :func:`..sort.sort_keys`."""
    if method not in _METHODS:
        raise ValueError(f"unknown method {method!r}; expected one of {_METHODS}")


def _pad_global(x, n_pad, fill):
    n = x.shape[0]
    if n == n_pad:
        return x
    pad = [(0, n_pad - n)] + [(0, 0)] * (x.ndim - 1)
    return jnp.pad(x, pad, constant_values=fill)


def split_index64(n):
    """Global index 0..n-1 as (hi, lo) u32 words (wide-index tie-break)."""
    gidx = jax.lax.iota(jnp.uint64, n)
    return words.split_u64(gidx)


def _raise_on_overflow(flag):
    if bool(flag):
        raise RuntimeError(
            "psort splitter-capacity overflow: a (src,dst) exchange segment "
            "exceeded the static buffer capacity and elements would have "
            "been dropped. Raise slack/oversample, or pass check=True to "
            "receive the flag instead of this error.")


def _consume_overflow(out, check):
    """Overflow must never reach a caller as silently-truncated data.
    check=True returns the flag; otherwise: eager calls sync the scalar and raise a clean RuntimeError;
    under an outer trace (flag is a tracer) a debug callback traps at
    runtime — the reference's THRS_ASSERT/__debugbreak philosophy
    (hpp:14-15): a hard stop beats corrupted output.

    Caveat: JAX delivers callback exceptions best-effort — the
    process stops, but possibly after downstream ops consumed the (clipped)
    results. Traced callers that need a deterministic, ordered error path
    must pass check=True and branch on the returned flag themselves (e.g.
    via jax.lax.cond or checkify at their own boundary); overflow is
    impossible at default oversample/slack in any case (analytic capacity
    floor, see _psort_entry).
    """
    out = list(out)
    overflow = out.pop()
    if check:
        return tuple(out) + (overflow,)
    if isinstance(overflow, jax.core.Tracer):
        jax.debug.callback(_raise_on_overflow, overflow)
    else:
        _raise_on_overflow(overflow)
    return tuple(out)


# Replicated-sample budget (tuples): each chip all_gathers P*s sample
# tuples, s = oversample*P samples per chip. With the auto oversample (4P)
# and no cap, the replicated sample is 4P^3 tuples — a cubic-in-P
# memory/compute cliff (~0.8 GB at P=256). Auto mode caps s at
# _SAMPLE_BUDGET/P (total replicated sample <= _SAMPLE_BUDGET tuples,
# 32 MB/word — full splitter precision holds through P = 128; beyond that
# the capacity floor grows as ~2P^2/_SAMPLE_BUDGET * B, a documented
# pod-scale limit) and compensates by computing the
# capacity floor from the *actual* s, so precision loss only ever raises
# buffer capacity, never risks overflow. An explicit oversample= is never
# capped.
_SAMPLE_BUDGET = 1 << 23


_PSORT_STATIC = (
    "mesh", "descending", "oversample", "slack", "want", "check",
    "zeros_exact", "start_bit", "end_bit", "refine", "_unsafe_cap",
    "_force_wide")


@functools.partial(jax.jit, static_argnames=_PSORT_STATIC)
def _psort_entry(keys, values, *, mesh, descending, oversample,
                 slack, want, check, zeros_exact=True, start_bit=0,
                 end_bit=None, refine=True, _unsafe_cap=None,
                 _force_wide=False):
    P_ = mesh.shape[AXIS]
    refine = refine and P_ > 1
    auto_oversample = oversample is None
    if auto_oversample:
        if refine:
            # refinement decouples capacity from sample precision: the
            # sample only seeds the refinement window, so a flat
            # oversample suffices (cuts splitter-phase wire ~P/8-fold at
            # pod scale vs the 4P scaling below)
            oversample = 32
        else:
            # auto: scale with P so the capacity floor B/P + 2*B*P/s stays
            # ~1.5B/P (== the slack default: buffers sized exactly at the
            # analytic bound) until the sample budget binds (P ~ 100 at
            # the default budget)
            oversample = max(32, 4 * P_)
    if slack is None:
        # refined splitters have O(P) rank error: the analytic bound sits
        # at ~B/P and the slack floor should not re-widen it
        slack = 1.0 if refine else 1.5
    if keys.ndim != 1:
        raise ValueError(f"keys must be 1-D, got shape {keys.shape}")
    n = keys.shape[0]
    # n >= 2**32 (the BASELINE 16B-key regime) switches the stability/rank
    # tie-break to a two-u32-word (u64) global index; the narrow single-word
    # form is kept below because one fewer word rides every local sort and
    # exchange. _force_wide exercises the wide path at test sizes.
    wide_index = _force_wide or n >= (1 << 32)
    # B must divide by P (stride pre-exchange reshape) and by 8 (layout)
    quantum = P_ * math.lcm(P_, 8)
    n_pad = -(-max(n, quantum) // quantum) * quantum
    B = n_pad // P_

    bits = keybits.key_bits(keys, descending=descending)
    dtype = np.dtype(keys.dtype)
    # bit-window sorts (reference hpp:845-852 startBit/endBit): compare
    # only [start_bit, end_bit) of the transformed key bits; equal window
    # bits preserve input order (the index tie-break IS the stability
    # contract, mirroring tests/test_startbits.py's single-chip contract)
    width = dtype.itemsize * 8
    start_bit = 0 if start_bit is None else start_bit
    end_bit = width if end_bit is None else end_bit
    full_window = (start_bit, end_bit) == (0, width)
    cmp_words = words.bits_to_cmp_words(bits, start_bit, end_bit)
    cmp_words = [_pad_global(w, n_pad, SENTINEL) for w in cmp_words]

    kkind = keybits.dtype_kind(dtype)
    # a window hides key bits -> keys can't be rebuilt from the cmp words;
    # they must ride as carry (and the index word stays on the wire)
    keys_from_bits = full_window and (kkind in "iu"
                                      or (kkind == "f" and not zeros_exact))
    # keys-only + keys-rebuilt-from-bits: the global index is needed only
    # *locally* (stable local sort, tie-broken splitter cuts, pad
    # detection) — never in the output and never to pair up carry words.
    # Synthesize it inside the shard after the (deterministic) stride
    # pre-exchange and drop it before the ring exchange: the index word(s)
    # never touch the wire, cutting exchange bytes 2x (narrow) / 3x (wide,
    # the n >= 2**32 BASELINE regime). See _psort_shard.
    idx_local = keys_from_bits and want == ("keys",)
    # global-index word(s): stability tie-break, splitter balance, and the
    # indices output all in one (pad indices sort to the global tail)
    if not idx_local:
        if wide_index:
            gi_hi, gi_lo = split_index64(n)
            cmp_words.append(_pad_global(gi_hi, n_pad, SENTINEL))
            cmp_words.append(_pad_global(gi_lo, n_pad, SENTINEL))
        else:
            cmp_words.append(_pad_global(jnp.arange(n, dtype=jnp.uint32),
                                         n_pad, SENTINEL))
    ncmp = len(cmp_words)

    need_keys_carry = ("keys" in want) and not keys_from_bits

    carry_words, recipes = [], []
    if need_keys_carry:
        ws, recipe = words.array_to_words(keys)
        recipe["nwords"] = len(ws)
        carry_words += [_pad_global(w, n_pad, jnp.uint32(0)) for w in ws]
        recipes.append(recipe)
    if "values" in want:
        for leaf in values:
            ws, recipe = words.array_to_words(leaf)
            recipe["nwords"] = len(ws)
            carry_words += [_pad_global(w, n_pad, jnp.uint32(0)) for w in ws]
            recipes.append(recipe)

    # Per-chip sample count: s regularly spaced tuples from the sorted
    # shard; the splitter rank error under regular sampling is <= B*P/s
    # per boundary. Auto mode budget-caps s (see _SAMPLE_BUDGET).
    s = min(B, oversample * P_)
    if auto_oversample:
        s = min(s, max(P_, _SAMPLE_BUDGET // P_))

    # Static exchange capacity. The worst-case (src,dst) segment under
    # stride pre-exchange + regular sampling is B/P plus the splitter drift
    # (<= B*P/s per boundary, docs/DESIGN.md §3) on each side, so the
    # analytic bound B/P + 2*ceil(B*P/s) is enforced as a floor — slack
    # only ever *raises* capacity. This closes the silent-truncation
    # window at P > slack*oversample/4:
    # overflow is now impossible at defaults, and if a capacity violation
    # does occur (e.g. a caller-forced tiny cap) it raises at runtime
    # instead of returning silently dropped elements (check=True instead
    # returns the flag for the caller to handle).
    refine_arg = None
    drift = int(math.ceil(B * P_ / s))  # round-A splitter rank error
    margin = 0
    if refine:
        k_ref = 8
        rounds_ref, W_f = refine_plan(B, P_, s, k_ref)
        if rounds_ref > 0:
            refine_arg = (rounds_ref, drift + 1, k_ref)
            drift = W_f  # post-refinement rank error is O(P)
            # Per-(src,dst) segments fluctuate around B/P with
            # hypergeometric stride-granularity noise (sigma ~
            # sqrt(B/P)) that the unrefined mode hides inside its much
            # larger drift term; with O(P) drift the margin must be
            # explicit: 8 sigma, floored at B/P/16 (6.25%) so the
            # relative cushion never vanishes. Value-position
            # correlations engineered to defeat the stride spread can
            # exceed any sub-B bound — in both modes that raises the
            # overflow trap rather than truncating.
            margin = max(8 * math.isqrt(B // P_ + 1), (B // P_) // 16)
    bound = B // P_ + 2 * drift + margin
    cap = max(int(math.ceil(slack * B / P_)), bound) + 8
    if _unsafe_cap is not None:
        cap = int(_unsafe_cap)
    cap = min(cap, B)
    # rebalance boundary pieces: splitter drift on both sides plus the
    # entry-pad deficit (output targets are q*B ranks of the padded
    # global array while counts track the n real elements)
    cap3 = min(4 * drift + (n_pad - n) + 16, B)

    shard = functools.partial(
        _psort_shard, P_=P_, cap=cap, cap3=cap3, sample_s=s,
        n_idx=2 if wide_index else 1, idx_synth=n if idx_local else None,
        refine=refine_arg)
    spec_w = P(AXIS)
    fn = jax.shard_map(
        lambda c, k: shard(c, k),
        mesh=mesh,
        in_specs=(tuple([spec_w] * ncmp), tuple([spec_w] * len(carry_words))),
        out_specs=(tuple([spec_w] * ncmp), tuple([spec_w] * len(carry_words)),
                   P()),
        check_vma=False,
    )
    cmp_out, carry_out, overflow = fn(tuple(cmp_words), tuple(carry_words))
    cmp_out, carry_out = list(cmp_out), list(carry_out)

    result = []
    pos = rpos = 0
    if "keys" in want:
        if keys_from_bits:
            if np.dtype(bits.dtype) == np.uint32:
                sbits = cmp_out[0]
            else:
                sbits = words.join_u64(cmp_out[0], cmp_out[1])
            result.append(keybits.key_bits_inverse(
                sbits, dtype, descending=descending)[:n])
        else:
            k = recipes[rpos]["nwords"]
            result.append(words.words_to_array(
                [w[:n] for w in carry_out[pos:pos + k]], recipes[rpos]))
            pos += k
            rpos += 1
    if "values" in want:
        leaves = []
        for _ in values:
            k = recipes[rpos]["nwords"]
            leaves.append(words.words_to_array(
                [w[:n] for w in carry_out[pos:pos + k]], recipes[rpos]))
            pos += k
            rpos += 1
        result.append(leaves)
    if "indices" in want:
        if wide_index:
            result.append(words.join_u64(
                cmp_out[-2][:n], cmp_out[-1][:n]).astype(jnp.int64))
        else:
            idx_dt = jnp.int32 if n < 2**31 else jnp.int64
            result.append(cmp_out[-1][:n].astype(idx_dt))
    result.append(overflow)  # wrappers consume (or return, check=True) it
    return tuple(result)


# donating variant: the caller's sharded key/value buffers are reused in
# place — the functional spelling of the reference's result-replaces-input
# contract (hpp:936-943), same as sort.py's _sort_entry_donated; it frees
# one input-sized buffer per device at the largest sizes.
_psort_entry_donated = jax.jit(
    _psort_entry.__wrapped__, static_argnames=_PSORT_STATIC,
    donate_argnums=(0, 1))


def _psort_window(keys, start_bit, end_bit):
    from ..ops import common
    return common.resolve_window(keys.dtype, start_bit, end_bit)


def psort_keys(keys, *, mesh=None, order="ascending", method="auto",
               start_bit=0, end_bit=None, oversample=None, slack=None,
               check=False, zeros_exact=True, donate=False, refine=True,
               _unsafe_cap=None, _force_wide=False):
    """Globally sorted keys over the mesh axis; same global shape as input.

    The result is sharded contiguously over the mesh: chip p holds global
    ranks [p*n/P, (p+1)*n/P). With ``check=True`` also returns a boolean
    overflow flag (True means a splitter segment exceeded the static
    capacity and elements were dropped — raise ``slack``/``oversample``
    and retry).

    ``start_bit``/``end_bit`` sort by the bit window [start_bit, end_bit)
    of the transformed key bits with input order preserved among equal
    window bits (reference hpp:845-852; same contract as
    :func:`..sort.sort_keys`). ``donate=True`` reuses the input buffers in
    place (they become invalid) — required headroom at the tight BASELINE
    memory points. ``zeros_exact=False`` lets float keys rebuild from bits
    (every -0.0 returns +0.0), which also sheds the index word from the
    exchange wire (the keys-only W=1 fast path).
    """
    mesh = mesh or make_sort_mesh()
    keys = jnp.asarray(keys)
    descending = SortOrder.parse(order).descending
    start_bit, end_bit = _psort_window(keys, start_bit, end_bit)
    _check_method(method)
    entry = _psort_entry_donated if donate else _psort_entry
    out = entry(keys, (), mesh=mesh, descending=descending,
                oversample=oversample, slack=slack,
                want=("keys",), check=check, zeros_exact=zeros_exact,
                start_bit=start_bit, end_bit=end_bit, refine=refine,
                _unsafe_cap=_unsafe_cap, _force_wide=_force_wide)
    out = _consume_overflow(out, check)
    return out if check else out[0]


def psort_pairs(keys, values, *, mesh=None, order="ascending", method="auto",
                start_bit=0, end_bit=None, oversample=None, slack=None,
                check=False, zeros_exact=True, donate=False, refine=True,
                _force_wide=False):
    """Distributed stable key-value sort; values may be a pytree.

    ``start_bit``/``end_bit``/``donate``/``zeros_exact`` have
    :func:`psort_keys` semantics (``zeros_exact`` only affects whether the
    returned *keys* normalize -0.0 to +0.0; payloads always pair exactly —
    the index word stays on the wire for pairs either way).
    """
    mesh = mesh or make_sort_mesh()
    keys = jnp.asarray(keys)
    values = jax.tree.map(jnp.asarray, values)
    leaves, treedef = jax.tree.flatten(values)
    descending = SortOrder.parse(order).descending
    start_bit, end_bit = _psort_window(keys, start_bit, end_bit)
    _check_method(method)
    entry = _psort_entry_donated if donate else _psort_entry
    out = entry(keys, tuple(leaves), mesh=mesh, descending=descending,
                oversample=oversample, slack=slack,
                want=("keys", "values"), check=check,
                zeros_exact=zeros_exact, start_bit=start_bit,
                end_bit=end_bit, refine=refine,
                _force_wide=_force_wide)
    out = _consume_overflow(out, check)
    k, v = out[0], jax.tree.unflatten(treedef, out[1])
    return (k, v, out[2]) if check else (k, v)


def psort_indices(keys, *, mesh=None, order="ascending", method="auto",
                  start_bit=0, end_bit=None, oversample=None, slack=None,
                  check=False, donate=False, refine=True,
                  _force_wide=False):
    """Distributed stable argsort (global permutation, sharded).

    ``start_bit``/``end_bit``/``donate`` have :func:`psort_keys` semantics.
    """
    mesh = mesh or make_sort_mesh()
    keys = jnp.asarray(keys)
    descending = SortOrder.parse(order).descending
    start_bit, end_bit = _psort_window(keys, start_bit, end_bit)
    _check_method(method)
    entry = _psort_entry_donated if donate else _psort_entry
    out = entry(keys, (), mesh=mesh, descending=descending,
                oversample=oversample, slack=slack,
                want=("indices",), check=check, start_bit=start_bit,
                end_bit=end_bit, refine=refine,
                _force_wide=_force_wide)
    out = _consume_overflow(out, check)
    return out if check else out[0]
