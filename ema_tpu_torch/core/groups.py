"""Per-barcode-group processing: clouds, EM, selection, duplicate marking.

This is the equivalent of the heart of the reference
(find_clouds_and_align, src/align.c:214-630, plus samdict.c).  The
pointer-chasing dict/linked-list design becomes: a single sweep that builds
padded [entries x candidates] arrays, a union-find over clouds replacing
the parent/child chains (samdict.c:91-112), and EM iterations as batched
float64 array ops.

Faithfulness notes:
  - The reference updates entry gammas *in place* while iterating entries
    in reverse-insertion order, so within a mate pair the later-inserted
    entry is recomputed first and its partner then sees the *new* gammas
    (align.c:444-521).  We replicate this exactly with a two-phase update
    (phase A: later-inserted/unpaired entries, phase B: earlier-inserted).
  - Collision handling (a read appearing twice in one cloud) re-adds the
    cloud's records in name-sorted order with force, after dropping the
    earlier additions (align.c:369-404, samdict.c:76-148).
  - EM runs only for groups of >= 30 pairs (align.c:345); gamma init is
    score-normalized per entry either way.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from ema_tpu_torch import config
from ema_tpu_torch.utils.logprobs import normalize_log_probs, normalize_log_probs_batch


@dataclasses.dataclass
class GroupResult:
    """Selection output for one barcode group.

    All index arrays refer to ``records`` (the sweep-sorted, possibly
    mutated copy of the caller's group records).  ``emit_pairs``: list of
    (rec_idx, mate_rec_idx) with -1 for an unmapped side.
    """

    records: np.ndarray         # sweep-sorted records (active/dup mutated)
    idents: np.ndarray          # matching read-name array
    order: np.ndarray           # records == input[order]
    emit_pairs: List[tuple]
    gamma: np.ndarray           # float64 per record (selected records only)
    cloud_id: np.ndarray        # int64 per record
    cloud_bad: np.ndarray       # int8 per record
    alt_idx: np.ndarray         # int64 per record: second-best record or -1
    selected_mate: np.ndarray   # int64 per record: chosen mate record or -1
    n_clouds: int = 0


class _UnionFind:
    __slots__ = ("parent",)

    def __init__(self):
        self.parent: dict = {}

    def find(self, x: int) -> int:
        p = self.parent
        root = x
        while p.get(root, root) != root:
            root = p[root]
        while p.get(x, x) != x:
            p[x], x = root, p[x]
        return root

    def union(self, a: int, b: int) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[rb] = ra


@dataclasses.dataclass
class GroupState:
    """Intermediate state between the cloud sweep and the selection phase.

    Produced by ``sweep_group``; EM (host or device, possibly batched
    across many groups) updates ``gammas``/``weights`` in place;
    ``finish_group`` turns it into a GroupResult.
    """

    R: np.ndarray
    RI: np.ndarray
    order: np.ndarray
    n: int
    n_entries: int
    n_clouds: int
    cand_rec: np.ndarray        # int64 [E, C]
    cand_cloud: np.ndarray      # int64 [E, C]
    cmask: np.ndarray           # bool [E, C]
    mate_entry: np.ndarray      # int64 [E]
    comp: np.ndarray            # int64 [NC]
    cloud_bad: List[int]
    many: bool
    gammas: np.ndarray          # f64 [E, C]
    weights: np.ndarray         # f64 [NC]
    needs_em: bool


def sweep_group(records: np.ndarray, idents: np.ndarray,
                profile: config.PlatformProfile,
                apply_opt: bool = False,
                rng: Optional[np.random.Generator] = None,
                n_pairs_in_group: Optional[int] = None) -> GroupState:
    """Cloud sweep + entry construction + gamma init for one barcode."""
    n = records.shape[0]
    many = profile.many_clouds

    # --- sort sweep order: (chrom, pos, ident) — record_cmp semantics ----
    order = np.lexsort((idents, records["pos"], records["chrom"]))
    R = records[order]
    RI = idents[order]

    # --- vectorized fast path (no same-cloud collisions) -----------------
    # Cloud boundaries, entry numbering, candidate placement and the
    # entry-cloud union edges are all array ops; only groups where some
    # read appears twice in one cloud (a "bad" cloud, align.c:369-404)
    # take the per-record loop below, which replicates the reference's
    # drop + name-sorted re-add protocol exactly.
    fast = None if n == 0 else _sweep_fast(R, profile)
    if fast is not None:
        (entry_keys_arr, cand_rec, cand_cloud, cmask, mate_entry, comp,
         n_entries, n_clouds) = fast
        cloud_bad = [0] * n_clouds
        scores = np.where(cmask, R["score"][cand_rec], 0.0)
        gammas = normalize_log_probs_batch(scores, cmask)
        exp_cov = np.zeros(n_clouds, np.float64)
        np.add.at(exp_cov, cand_cloud[cmask], gammas[cmask])
        weights = exp_cov.copy()
        if not many and n_clouds:
            weights = _normalize_chains(weights, comp)
        n_pairs = (n_pairs_in_group if n_pairs_in_group is not None
                   else np.unique(R["pair"]).shape[0])
        needs_em = n_pairs >= config.MIN_PAIRS_FOR_EM and n_entries > 0
        return GroupState(
            R=R, RI=RI, order=order, n=n, n_entries=n_entries,
            n_clouds=n_clouds, cand_rec=cand_rec, cand_cloud=cand_cloud,
            cmask=cmask, mate_entry=mate_entry, comp=comp,
            cloud_bad=cloud_bad, many=many, gammas=gammas,
            weights=weights, needs_em=needs_em)

    # --- cloud sweep with collision handling -----------------------------
    # entry key: (pair, mate).  Candidates are (sorted-record-index, cloud).
    entries: dict = {}
    entry_keys: List[tuple] = []      # insertion order
    cands_rec: List[List[int]] = []
    cands_cloud: List[List[int]] = []
    uf = _UnionFind()
    cloud_bad: List[int] = []

    def add(sorted_idx: int, cloud: int, force: bool) -> bool:
        """Returns True on same-cloud collision (nothing added)."""
        key = (int(R["pair"][sorted_idx]), int(R["mate"][sorted_idx]))
        eid = entries.get(key)
        if eid is not None:
            cl = cands_cloud[eid]
            if cl:
                last = cl[-1]
                if last == cloud and not force:
                    return True
                if not many and last != cloud:
                    uf.union(last, cloud)
            if len(cl) < config.MAX_CANDIDATES:
                cands_rec[eid].append(sorted_idx)
                cl.append(cloud)
        else:
            eid = len(entry_keys)
            entries[key] = eid
            entry_keys.append(key)
            cands_rec.append([sorted_idx])
            cands_cloud.append([cloud])
        return False

    chrom = R["chrom"]
    pos = R["pos"]
    i = 0
    while i < n:
        cloud = len(cloud_bad)
        cloud_bad.append(0)
        add(i, cloud, False)
        j = i
        collision = False
        while (j + 1 < n and chrom[j + 1] == chrom[j]
               and pos[j + 1] - pos[j] <= profile.dist_thresh):
            j += 1
            if not collision and add(j, cloud, False):
                collision = True
                # drop the earlier additions of this cloud (samdict del)
                for k in range(i, j):
                    key = (int(R["pair"][k]), int(R["mate"][k]))
                    eid = entries[key]
                    cands_rec[eid].pop()
                    cands_cloud[eid].pop()
        if collision:
            cloud_bad[cloud] = 1
            members = list(range(i, j + 1))
            # name order: (ident, mate) — align.c name_cmp
            members.sort(key=lambda k: (RI[k], int(R["mate"][k])))
            if apply_opt:
                from ema_tpu_torch.core.split import mark_optimal_alignments_in_cloud
                mark_optimal_alignments_in_cloud(R, RI, members, profile, rng)
            for k in members:
                add(k, cloud, True)
        i = j + 1

    n_entries = len(entry_keys)
    n_clouds = len(cloud_bad)

    # --- pad to [E, C] arrays -------------------------------------------
    C = max((len(c) for c in cands_rec), default=1)
    cand_rec = np.zeros((n_entries, C), np.int64)
    cand_cloud = np.zeros((n_entries, C), np.int64)
    cmask = np.zeros((n_entries, C), bool)
    for e in range(n_entries):
        k = len(cands_rec[e])
        cand_rec[e, :k] = cands_rec[e]
        cand_cloud[e, :k] = cands_cloud[e]
        cmask[e, :k] = True

    # mate links: entry with same pair, other mate
    mate_entry = np.full(n_entries, -1, np.int64)
    for e, (pair, mate) in enumerate(entry_keys):
        other = entries.get((pair, 1 - mate))
        if other is not None:
            mate_entry[e] = other
            mate_entry[other] = e

    # cloud chain components for weight normalization
    comp = np.array([uf.find(c) for c in range(n_clouds)], np.int64) \
        if n_clouds else np.zeros(0, np.int64)

    # --- gamma init (align.c:410-429) ------------------------------------
    scores = np.where(cmask, R["score"][cand_rec], 0.0)
    gammas = normalize_log_probs_batch(scores, cmask)

    exp_cov = np.zeros(n_clouds, np.float64)
    np.add.at(exp_cov, cand_cloud[cmask], gammas[cmask])
    weights = exp_cov.copy()
    if not many and n_clouds:
        weights = _normalize_chains(weights, comp)

    n_pairs = (n_pairs_in_group if n_pairs_in_group is not None
               else len({int(p) for p, _ in entry_keys}))
    needs_em = n_pairs >= config.MIN_PAIRS_FOR_EM and n_entries > 0

    return GroupState(
        R=R, RI=RI, order=order, n=n, n_entries=n_entries,
        n_clouds=n_clouds, cand_rec=cand_rec, cand_cloud=cand_cloud,
        cmask=cmask, mate_entry=mate_entry, comp=comp, cloud_bad=cloud_bad,
        many=many, gammas=gammas, weights=weights, needs_em=needs_em)


def _sweep_fast(R: np.ndarray, profile: config.PlatformProfile):
    """Vectorized cloud sweep for collision-free groups; None on collision.

    Produces exactly what the per-record loop produces when no read
    appears twice in one cloud: same entry insertion order (first
    occurrence in sweep order), same candidate order within entries,
    same MAX_CANDIDATES capping, and the same entry-cloud union
    components (transition edges instead of last-vs-new unions connect
    the identical partition).
    """
    n = R.shape[0]
    chrom = R["chrom"]
    pos = R["pos"]
    new_cloud = np.ones(n, bool)
    new_cloud[1:] = ((chrom[1:] != chrom[:-1])
                     | (pos[1:] - pos[:-1] > profile.dist_thresh))
    cloud_ids = np.cumsum(new_cloud) - 1
    n_clouds = int(cloud_ids[-1]) + 1

    keys = R["pair"].astype(np.int64) * 2 + R["mate"]
    uniq, first_idx, inv = np.unique(keys, return_index=True,
                                     return_inverse=True)
    E = uniq.shape[0]
    rank = np.empty(E, np.int64)
    rank[np.argsort(first_idx, kind="stable")] = np.arange(E)
    eid = rank[inv]

    # same-cloud duplicate for an entry = the loop path's collision
    ec = np.sort(eid * np.int64(n_clouds) + cloud_ids)
    if n > 1 and (ec[1:] == ec[:-1]).any():
        return None

    order_c = np.lexsort((np.arange(n), eid))   # stable: sweep order kept
    eid_s = eid[order_c]
    cl_s = cloud_ids[order_c]
    firstc = np.ones(n, bool)
    firstc[1:] = eid_s[1:] != eid_s[:-1]
    idxs = np.arange(n)
    pos_in = idxs - np.maximum.accumulate(np.where(firstc, idxs, 0))
    keep = pos_in < config.MAX_CANDIDATES

    C = int(pos_in[keep].max()) + 1 if n else 1
    cand_rec = np.zeros((E, C), np.int64)
    cand_cloud = np.zeros((E, C), np.int64)
    cmask = np.zeros((E, C), bool)
    cand_rec[eid_s[keep], pos_in[keep]] = order_c[keep]
    cand_cloud[eid_s[keep], pos_in[keep]] = cl_s[keep]
    cmask[eid_s[keep], pos_in[keep]] = True

    # mate links: entry of (pair, 1 - mate)
    key_of = np.empty(E, np.int64)
    key_of[rank] = uniq
    other = key_of ^ 1
    loc = np.clip(np.searchsorted(uniq, other), 0, E - 1)
    found = uniq[loc] == other
    mate_entry = np.where(found, rank[loc], -1).astype(np.int64)

    comp = np.arange(n_clouds, dtype=np.int64)
    if not profile.many_clouds:
        tr = np.zeros(n, bool)
        tr[1:] = (~firstc[1:]) & (cl_s[1:] != cl_s[:-1])
        if tr.any():
            uf = _UnionFind()
            at = np.nonzero(tr)[0]
            for a, b in zip(cl_s[at - 1], cl_s[at]):
                uf.union(int(a), int(b))
            comp = np.array([uf.find(c) for c in range(n_clouds)],
                            np.int64)

    entry_keys_arr = key_of
    return (entry_keys_arr, cand_rec, cand_cloud, cmask, mate_entry, comp,
            E, n_clouds)


# batched-sweep deep-group valve: a group whose deepest entry keeps more
# than this many candidates is swept by the per-group loop path instead,
# so one dispersed-repeat read cannot widen every group's padded arrays
DEEP_SWEEP_C = 256


def sweep_groups_batch(recs: np.ndarray, idents, starts: np.ndarray,
                       profile: config.PlatformProfile,
                       apply_opt: bool = False,
                       rng: Optional[np.random.Generator] = None,
                       n_pairs_list: Optional[List[int]] = None
                       ) -> List[GroupState]:
    """Cloud sweep for MANY barcode groups in one set of array ops.

    ``recs[:starts[-1]]`` must be bc-sorted with ``starts`` the group
    boundaries, and record ``pair`` ids must be unique across the whole
    array (the pipeline's ``pair_offset`` guarantees this).  Produces
    the same GroupStates ``sweep_group`` would produce per group — the
    global lexsort/unique/segment ops replace hundreds of small per-
    group numpy calls, which dominated the host sweep phase.  Groups
    with same-cloud collisions (bad clouds) fall back to the per-group
    loop path (exact drop/re-add protocol + optional SA).
    """
    starts = np.unique(np.asarray(starts, np.int64))  # drops empty groups
    end = int(starts[-1])
    n_grp = len(starts) - 1
    if end == 0 or n_grp == 0:
        return []
    bcs = recs["bc"][:end]
    idents_str = idents[:end].astype(str)

    # one global sweep sort: bc (outer; input is bc-sorted so each group
    # keeps its [s, e) range), then record_cmp (chrom, pos, ident)
    order = np.lexsort((idents_str, recs["pos"][:end],
                        recs["chrom"][:end], bcs))
    R = recs[:end][order]
    RI = idents_str[order]
    chrom, pos = R["chrom"], R["pos"]

    grp_of_row = np.searchsorted(starts, np.arange(end), side="right") - 1
    first_of_grp = np.zeros(end, bool)
    first_of_grp[starts[:-1]] = True

    # global cloud ids (per-group bases recovered below)
    new_cloud = first_of_grp.copy()
    new_cloud[1:] |= ((chrom[1:] != chrom[:-1])
                      | (pos[1:] - pos[:-1] > profile.dist_thresh))
    cloud_ids = np.cumsum(new_cloud) - 1
    n_clouds_total = int(cloud_ids[-1]) + 1
    cloud_base = cloud_ids[starts[:-1]]
    cloud_cnt = np.empty(n_grp, np.int64)
    cloud_cnt[:-1] = np.diff(cloud_base)
    cloud_cnt[-1] = n_clouds_total - cloud_base[-1]

    # entries: (pair, mate) keys, globally unique -> per-group contiguous
    # rank ranges once ordered by first occurrence
    keys = R["pair"].astype(np.int64) * 2 + R["mate"]
    uniq, first_idx, inv = np.unique(keys, return_index=True,
                                     return_inverse=True)
    E = uniq.shape[0]
    rank = np.empty(E, np.int64)
    order_e = np.argsort(first_idx, kind="stable")
    rank[order_e] = np.arange(E)
    eid = rank[inv]
    grp_of_entry = np.empty(E, np.int64)
    grp_of_entry[rank] = grp_of_row[first_idx]
    # grp_of_entry is non-decreasing along rank order (groups are
    # contiguous in sweep order), so the per-group base is a searchsorted
    entry_base = np.searchsorted(grp_of_entry, np.arange(n_grp),
                                 side="left")
    entry_cnt = np.empty(n_grp, np.int64)
    entry_cnt[:-1] = np.diff(entry_base)
    entry_cnt[-1] = E - entry_base[-1]

    # same-cloud duplicate for an entry = a collision -> that group takes
    # the exact per-group loop path
    bad_grp = np.zeros(n_grp, bool)
    ec = eid * np.int64(n_clouds_total) + cloud_ids
    ecs = np.sort(ec)
    dup = np.nonzero(ecs[1:] == ecs[:-1])[0]
    if dup.shape[0]:
        bad_eids = (ecs[dup] // np.int64(n_clouds_total)).astype(np.int64)
        bad_grp[grp_of_entry[bad_eids]] = True

    # candidate placement (sweep order preserved per entry)
    order_c = np.lexsort((np.arange(end), eid))
    eid_s = eid[order_c]
    cl_s = cloud_ids[order_c]
    firstc = np.ones(end, bool)
    firstc[1:] = eid_s[1:] != eid_s[:-1]
    idxs = np.arange(end)
    pos_in = idxs - np.maximum.accumulate(np.where(firstc, idxs, 0))
    keep = pos_in < config.MAX_CANDIDATES

    # per-group candidate depth; one deep entry must not widen every
    # group's padded arrays (RSS) nor flip their EM routing (the deep-
    # group tests read cmask.shape[1]) — deep groups take the loop path
    depth = np.bincount(eid_s[keep], minlength=E)
    grp_depth = np.zeros(n_grp, np.int64)
    np.maximum.at(grp_depth, grp_of_entry, depth)
    bad_grp |= grp_depth > DEEP_SWEEP_C
    bad_entry = bad_grp[grp_of_entry]
    keep &= ~bad_entry[eid_s]

    C = int(pos_in[keep].max()) + 1 if keep.any() else 1
    cand_rec = np.zeros((E, C), np.int64)      # global sorted-row indices
    cand_cloud = np.zeros((E, C), np.int64)    # global cloud ids
    cmask = np.zeros((E, C), bool)
    cand_rec[eid_s[keep], pos_in[keep]] = order_c[keep]
    cand_cloud[eid_s[keep], pos_in[keep]] = cl_s[keep]
    cmask[eid_s[keep], pos_in[keep]] = True

    # mate links (same pair, other mate; always within the same group)
    key_of = np.empty(E, np.int64)
    key_of[rank] = uniq
    other = key_of ^ 1
    loc = np.clip(np.searchsorted(uniq, other), 0, E - 1)
    found = uniq[loc] == other
    mate_entry = np.where(found, rank[loc], -1).astype(np.int64)

    # cloud chain components (transition edges; never cross groups)
    comp = np.arange(n_clouds_total, dtype=np.int64)
    if not profile.many_clouds:
        tr = np.zeros(end, bool)
        tr[1:] = (~firstc[1:]) & (cl_s[1:] != cl_s[:-1])
        if tr.any():
            uf = _UnionFind()
            at = np.nonzero(tr)[0]
            for a, b in zip(cl_s[at - 1], cl_s[at]):
                uf.union(int(a), int(b))
            for c in uf.parent:
                comp[c] = uf.find(c)

    # gamma init + cloud weights, one padded pass for every group
    scores = np.where(cmask, R["score"][cand_rec], 0.0)
    gammas = normalize_log_probs_batch(scores, cmask)
    exp_cov = np.zeros(n_clouds_total, np.float64)
    np.add.at(exp_cov, cand_cloud[cmask], gammas[cmask])
    weights = exp_cov
    if not profile.many_clouds and n_clouds_total:
        weights = _normalize_chains(weights, comp)

    # localize the global arrays in bulk (indices relative to each
    # entry's own group)
    ebase_of_entry = entry_base[grp_of_entry]
    rstart_of_entry = starts[grp_of_entry]
    cbase_of_entry = cloud_base[grp_of_entry]
    cand_rec = np.where(cmask, cand_rec - rstart_of_entry[:, None], 0)
    cand_cloud = np.where(cmask, cand_cloud - cbase_of_entry[:, None], 0)
    mate_entry = np.where(mate_entry >= 0,
                          mate_entry - ebase_of_entry, -1)

    states: List[GroupState] = []
    for g in range(n_grp):
        s, e = int(starts[g]), int(starts[g + 1])
        n_pairs = n_pairs_list[g] if n_pairs_list is not None else None
        if bad_grp[g]:
            states.append(sweep_group(
                recs[s:e], idents_str[s:e], profile, apply_opt, rng,
                n_pairs_in_group=n_pairs))
            continue
        eb, ee = int(entry_base[g]), int(entry_base[g] + entry_cnt[g])
        cb, nc = int(cloud_base[g]), int(cloud_cnt[g])
        n_g = e - s
        E_g = ee - eb
        if n_pairs is None:
            n_pairs = np.unique(R["pair"][s:e]).shape[0]
        needs_em = n_pairs >= config.MIN_PAIRS_FOR_EM and E_g > 0
        # column-slice to the group's OWN candidate depth: EM routing
        # reads cmask.shape[1] and must not see the flush-global pad
        C_g = max(int(grp_depth[g]), 1)
        states.append(GroupState(
            R=R[s:e], RI=RI[s:e], order=order[s:e] - s, n=n_g,
            n_entries=E_g, n_clouds=nc,
            cand_rec=cand_rec[eb:ee, :C_g],
            cand_cloud=cand_cloud[eb:ee, :C_g],
            cmask=cmask[eb:ee, :C_g], mate_entry=mate_entry[eb:ee],
            comp=comp[cb:cb + nc] - cb, cloud_bad=[0] * nc,
            many=profile.many_clouds, gammas=gammas[eb:ee, :C_g],
            weights=weights[cb:cb + nc], needs_em=needs_em))
    return states


def _em_fields(st: GroupState):
    R, cand_rec = st.R, st.cand_rec
    active = R["active"][cand_rec] & ~R["duplicate"][cand_rec] & st.cmask
    return (active, R["chrom"][cand_rec], R["pos"][cand_rec],
            R["rev"][cand_rec], R["score"][cand_rec])


# candidate-depth threshold: beyond this the vectorized mate term's
# [C, C_mate] broadcast is quadratic *memory* (reference-scale repeat
# groups reach MAX_CANDIDATES = 5000), so deep groups run the C++ flat
# EM (same math, the reference's own O(C*C') loop shape, O(C) memory)
EM_NATIVE_C = 64


def run_em_native(st: GroupState) -> None:
    """C++ EM over flat candidate arrays (native.em_run_flat)."""
    from ema_tpu_torch import native
    cm = st.cmask
    counts = cm.sum(axis=1)
    cand_off = np.zeros(st.n_entries + 1, np.int64)
    np.cumsum(counts, out=cand_off[1:])
    flat_idx = st.cand_rec[cm]
    R = st.R
    gflat = st.gammas[cm].astype(np.float64)
    weights = np.ascontiguousarray(st.weights, np.float64).copy()
    active = (R["active"][flat_idx]
              & ~R["duplicate"][flat_idx]).astype(np.uint8)
    comp = st.comp if st.n_clouds else np.zeros(0, np.int64)
    native.em_run_flat(
        cand_off, st.cand_cloud[cm], R["chrom"][flat_idx],
        R["pos"][flat_idx], R["rev"][flat_idx], R["score"][flat_idx],
        active, gflat, weights, st.mate_entry, comp,
        st.many, config.EM_ITERS,
        config.INSERT_MIN, config.INSERT_MAX, config.UNPAIRED_PENALTY)
    g = np.zeros_like(st.gammas)
    g[cm] = gflat
    st.gammas = g
    st.weights = weights


def run_em_host(st: GroupState) -> None:
    """The reference EM loop (align.c:431-543), float64 numpy."""
    if st.cmask.shape[1] > EM_NATIVE_C:
        return run_em_native(st)
    active, rec_chrom, rec_pos, rec_rev, raw_score = _em_fields(st)
    gammas, weights = st.gammas, st.weights
    exp_cov = np.zeros(st.n_clouds, np.float64)
    # phase split: later-inserted mate-pair member updates first
    e_idx = np.arange(st.n_entries)
    phase_b = (st.mate_entry >= 0) & (e_idx < st.mate_entry)
    phase_a = ~phase_b
    for _ in range(config.EM_ITERS):
        for phase in (phase_a, phase_b):
            if not phase.any():
                continue
            sel = np.nonzero(phase)[0]
            gammas[sel] = _recompute_gammas(
                sel, gammas, weights, st.mate_entry, st.cand_cloud,
                st.cmask, rec_chrom, rec_pos, rec_rev, raw_score, st.many)
        exp_cov[:] = 0.0
        np.add.at(exp_cov, st.cand_cloud[active], gammas[active])
        weights = exp_cov.copy()
        if not st.many and st.n_clouds:
            weights = _normalize_chains(weights, st.comp)
    st.gammas, st.weights = gammas, weights


def _pack_states(states: List[GroupState], f_dtype=np.float64):
    """Pad a batch of GroupStates to common [G, E, C] arrays."""
    G = len(states)
    E = _round_up_pow2(max(st.n_entries for st in states))
    C = _round_up_pow2(max(st.cmask.shape[1] for st in states), 2)
    NC = _round_up_pow2(max(max(st.n_clouds, 1) for st in states))

    def pad2(x, fill, dtype):
        out = np.full((G, E, C), fill, dtype)
        for g, st in enumerate(states):
            e, c = st.cmask.shape
            out[g, :e, :c] = x(st)
        return out

    d = dict(
        score=pad2(lambda st: np.where(st.cmask, st.R["score"][st.cand_rec],
                                       0.0), 0.0, f_dtype),
        cmask=pad2(lambda st: st.cmask, False, bool),
        active=pad2(lambda st: st.R["active"][st.cand_rec]
                    & ~st.R["duplicate"][st.cand_rec] & st.cmask,
                    False, bool),
        cand_cloud=pad2(lambda st: st.cand_cloud, 0, np.int32),
        rec_chrom=pad2(lambda st: st.R["chrom"][st.cand_rec], 0, np.int32),
        rec_pos=pad2(lambda st: st.R["pos"][st.cand_rec], 0, np.int32),
        rec_rev=pad2(lambda st: st.R["rev"][st.cand_rec], 0, np.int32),
    )
    mate_entry = np.full((G, E), -1, np.int32)
    emask = np.zeros((G, E), bool)
    comp = np.broadcast_to(np.arange(NC, dtype=np.int32), (G, NC)).copy()
    many = states[0].many
    for g, st in enumerate(states):
        mate_entry[g, :st.n_entries] = st.mate_entry
        emask[g, :st.n_entries] = True
        if not many and st.n_clouds:
            comp[g, :st.n_clouds] = st.comp
    d.update(mate_entry=mate_entry, emask=emask, comp=comp)
    return d, (G, E, C, NC)


def run_em_host_batch(states: List[GroupState]) -> None:
    """One padded numpy EM pass over many groups (same math as
    run_em_host per group; batching amortizes the numpy dispatch
    overhead of small [E, C] arrays)."""
    states = [st for st in states if st.needs_em]
    if not states:
        return
    # large groups pay more for the all-entries-per-phase recompute and
    # pow2 padding than they save in dispatch overhead — keep those on the
    # per-group path; deep-candidate groups go to the C++ flat EM
    big = [st for st in states
           if st.n_entries > 256 or st.cmask.shape[1] > EM_NATIVE_C]
    for st in big:
        run_em_host(st)
    states = [st for st in states
              if st.n_entries <= 256 and st.cmask.shape[1] <= EM_NATIVE_C]
    if not states:
        return
    if len(states) == 1:
        run_em_host(states[0])
        return
    many = states[0].many
    assert all(st.many == many for st in states)
    d, (G, E, C, NC) = _pack_states(states)
    score, cmask, active = d["score"], d["cmask"], d["active"]
    cand_cloud, mate_entry, emask = d["cand_cloud"], d["mate_entry"], d["emask"]
    comp = d["comp"]
    rec_chrom, rec_pos, rec_rev = d["rec_chrom"], d["rec_pos"], d["rec_rev"]

    gammas = normalize_log_probs_batch(
        score.reshape(G * E, C), cmask.reshape(G * E, C)).reshape(G, E, C)
    g_idx = np.arange(G)[:, None, None]
    gi = np.arange(G)[:, None]

    def cloud_weights(weight_mask):
        exp_cov = np.zeros((G, NC), np.float64)
        np.add.at(exp_cov, (g_idx, cand_cloud),
                  np.where(weight_mask, gammas, 0.0))
        if many:
            return exp_cov
        totals = np.zeros((G, NC), np.float64)
        np.add.at(totals, (gi, comp), exp_cov)
        t = np.take_along_axis(totals, comp, axis=1)
        return np.where(t > 0, exp_cov / np.where(t > 0, t, 1.0), exp_cov)

    weights = cloud_weights(cmask)

    e_idx = np.arange(E)[None, :]
    phase_b = (mate_entry >= 0) & (e_idx < mate_entry) & emask
    phase_a = emask & ~phase_b
    me = np.maximum(mate_entry, 0)[:, :, None]
    has_mate = (mate_entry >= 0)[:, :, None]

    def mg(arr):
        return np.take_along_axis(
            arr, np.broadcast_to(me, (G, E, arr.shape[2])), axis=1)

    m_chrom = mg(rec_chrom)[:, :, None, :]
    m_pos = mg(rec_pos)[:, :, None, :]
    m_rev = mg(rec_rev)[:, :, None, :]
    m_cloud = mg(cand_cloud)[:, :, None, :]
    m_cmask = mg(cmask)[:, :, None, :] & has_mate[..., None]
    i_chrom = rec_chrom[..., None]
    i_pos = rec_pos[..., None]
    i_rev = rec_rev[..., None]
    i_cloud = cand_cloud[..., None]
    ok_static = (m_cmask & (m_chrom == i_chrom) & (m_rev != i_rev)
                 & (m_cloud == i_cloud))
    dd = np.where(i_rev == 1, i_pos - m_pos, m_pos - i_pos)
    pen = np.where((dd >= config.INSERT_MIN) & (dd <= config.INSERT_MAX),
                   0.0, config.UNPAIRED_PENALTY)

    def recompute():
        cloud_w = np.take_along_axis(
            weights[:, None, :],
            np.broadcast_to(cand_cloud, (G, E, C)), axis=2)
        if many:
            tot = np.where(cmask, cloud_w, 0.0).sum(axis=-1, keepdims=True)
            cloud_w = np.where(tot > 0,
                               cloud_w / np.where(tot > 0, tot, 1.0), 0.0)
        with np.errstate(divide="ignore"):
            log_w = np.log(np.where(cloud_w > 0, cloud_w, 1e-300))
        m_gamma = mg(gammas)[:, :, None, :]
        ok = ok_static & (m_gamma != 0.0)
        with np.errstate(divide="ignore", invalid="ignore"):
            ms = pen + np.log(np.where(ok & (m_gamma > 0), m_gamma, 1.0))
        ms = np.where(ok, ms, -np.inf)
        best_mate = np.maximum(ms.max(axis=-1), config.UNPAIRED_PENALTY)
        best_mate = np.where(has_mate, best_mate, config.UNPAIRED_PENALTY)
        new = score + log_w + best_mate
        return normalize_log_probs_batch(
            np.where(cmask, new, 0.0).reshape(G * E, C),
            cmask.reshape(G * E, C)).reshape(G, E, C)

    for _ in range(config.EM_ITERS):
        for phase in (phase_a, phase_b):
            new = recompute()
            gammas = np.where(phase[..., None] & cmask, new, gammas)
        weights = cloud_weights(active)

    for g, st in enumerate(states):
        e, c = st.cmask.shape
        st.gammas = gammas[g, :e, :c]


def _round_up_pow2(x: int, lo: int = 8) -> int:
    v = lo
    while v < x:
        v *= 2
    return v


def finish_group(st: GroupState, cloud_id_start: int = 0) -> GroupResult:
    """Selection + duplicate marking (align.c:545-585, samdict.c:166-243)."""
    R, RI = st.R, st.RI
    n, n_entries, n_clouds = st.n, st.n_entries, st.n_clouds
    cand_rec, cand_cloud, cmask = st.cand_rec, st.cand_cloud, st.cmask
    mate_entry, gammas = st.mate_entry, st.gammas

    gamma_out = np.zeros(n, np.float64)
    cloud_out = np.zeros(n, np.int64)
    alt_out = np.full(n, -1, np.int64)
    selected_mate = np.full(n, -1, np.int64)
    emit_pairs: List[tuple] = []

    masked_g = np.where(cmask & R["active"][cand_rec], gammas, -np.inf)

    # vectorized per-entry argmax/second (the emit loop below only sets
    # outputs in reverse-insertion order; the choices are independent)
    if n_entries:
        e_arange = np.arange(n_entries)
        b_idx = np.argmax(masked_g, axis=1)          # first max wins
        b_gam = masked_g[e_arange, b_idx]
        dead = ~np.isfinite(b_gam)
        b_idx = np.where(dead, 0, b_idx)
        b_gam = np.where(dead, -1.0, b_gam)
        mg2 = masked_g.copy()
        mg2[e_arange, np.argmax(masked_g, axis=1)] = -np.inf
        s_idx = np.argmax(mg2, axis=1)
        s_val = mg2[e_arange, s_idx]

    # head order = reverse insertion order.  Mate links are SYMMETRIC by
    # construction (both constructors set/derive e <-> mate together), so the
    # reference's visited-loop reduces to: entry e emits iff its mate is
    # absent or earlier; everything vectorizes.
    if n_entries:
        e_all = np.arange(n_entries)
        me = mate_entry[:n_entries]
        emit_e = e_all[(me < 0) | (me < e_all)][::-1]
        m_e = me[emit_e]

        r_of = cand_rec[e_arange, b_idx]
        gam_of = np.where(b_gam > -1.0, b_gam, -1.0)
        cl_of = cand_cloud[e_arange, b_idx]
        want_alt = (b_gam <= config.SECONDARY_ALIGN_THRESH) & (s_val > 0)
        alt_of = np.where(want_alt, cand_rec[e_arange, s_idx], -1)

        ents = np.concatenate([emit_e, m_e[m_e >= 0]])
        rids = r_of[ents]
        gamma_out[rids] = gam_of[ents]
        cloud_out[rids] = cl_of[ents]
        alt_out[rids] = alt_of[ents]

        best_a = r_of[emit_e]
        best_b = np.where(m_e >= 0, r_of[np.maximum(m_e, 0)], -1)
        emit_pairs = list(zip(best_a.tolist(), best_b.tolist()))
        paired = best_b >= 0
        selected_mate[best_a[paired]] = best_b[paired]
        selected_mate[best_b[paired]] = best_a[paired]

    # --- duplicate marking (align.c:574-585) -----------------------------
    if not st.many and emit_pairs:
        finals: List[int] = []
        for a, b in emit_pairs:
            finals.append(a)
            if b >= 0:
                finals.append(b)
        fa = np.array(finals, np.int64)
        mates = selected_mate[fa]
        has_mate = mates >= 0
        mchrom = np.where(has_mate, R["chrom"][np.maximum(mates, 0)],
                          np.iinfo(np.int64).max)
        mpos = np.where(has_mate, R["pos"][np.maximum(mates, 0)],
                        np.iinfo(np.int64).max)
        keys = np.stack([
            R["mate"][fa], R["rev"][fa], R["chrom"][fa], R["pos"][fa],
            mchrom, mpos], axis=1)
        order2 = np.lexsort(tuple(keys.T[::-1]))
        sk = keys[order2]
        same = np.zeros(len(fa), bool)
        same[1:] = (sk[1:] == sk[:-1]).all(axis=1)
        R["duplicate"][fa[order2[same]]] = True

    return GroupResult(
        records=R,
        idents=RI,
        order=st.order,
        emit_pairs=emit_pairs,
        gamma=gamma_out,
        cloud_id=cloud_out + cloud_id_start,
        cloud_bad=np.array(st.cloud_bad, np.int8)[
            np.clip(cloud_out, 0, max(n_clouds - 1, 0))] if n_clouds
        else np.zeros(n, np.int8),
        alt_idx=alt_out,
        selected_mate=selected_mate,
        n_clouds=n_clouds,
    )


def finish_groups_batch(states: List[GroupState],
                        bases: List[int]) -> List[GroupResult]:
    """finish_group for MANY groups in one set of array ops.

    Stacks the per-group candidate arrays (padded to the batch's max
    candidate depth, bounded by DEEP_SWEEP_C) and runs the selection
    argmax/second, emit ordering, scatter outputs and duplicate marking
    globally; groups too deep for the stack (loop-path fallbacks) or
    empty keep the per-group path.  Produces exactly finish_group's
    results per group (equivalence-tested)."""
    out: List[Optional[GroupResult]] = [None] * len(states)
    sel = [i for i, st in enumerate(states)
           if st.n and st.n_entries
           and st.cmask.shape[1] <= DEEP_SWEEP_C]
    sel_set = set(sel)
    for i, st in enumerate(states):
        if i not in sel_set:
            out[i] = finish_group(st, bases[i])
    if not sel:
        return out
    sts = [states[i] for i in sel]
    K = len(sts)
    E_g = np.array([st.n_entries for st in sts], np.int64)
    N_g = np.array([st.n for st in sts], np.int64)
    ent_base = np.concatenate([[0], np.cumsum(E_g)])
    rec_base = np.concatenate([[0], np.cumsum(N_g)])
    E_tot, N_tot = int(ent_base[-1]), int(rec_base[-1])
    C = max(st.cmask.shape[1] for st in sts)

    G = np.full((E_tot, C), -np.inf)
    CM = np.zeros((E_tot, C), bool)
    CR = np.zeros((E_tot, C), np.int64)
    CC = np.zeros((E_tot, C), np.int64)
    for k, st in enumerate(sts):
        eb, ee = ent_base[k], ent_base[k + 1]
        c = st.cmask.shape[1]
        G[eb:ee, :c] = st.gammas
        CM[eb:ee, :c] = st.cmask
        CR[eb:ee, :c] = st.cand_rec + rec_base[k]
        CC[eb:ee, :c] = st.cand_cloud
    ACT = np.concatenate([st.R["active"] for st in sts])
    ME = np.concatenate([st.mate_entry for st in sts])
    e_local = np.concatenate([np.arange(e) for e in E_g])
    grp_of_e = np.repeat(np.arange(K), E_g)

    masked_g = np.where(CM & ACT[CR], G, -np.inf)
    e_ar = np.arange(E_tot)
    am = np.argmax(masked_g, axis=1)
    b_gam = masked_g[e_ar, am]
    dead = ~np.isfinite(b_gam)
    b_idx = np.where(dead, 0, am)
    b_gam = np.where(dead, -1.0, b_gam)
    mg2 = masked_g.copy()
    mg2[e_ar, am] = -np.inf
    s_idx = np.argmax(mg2, axis=1)
    s_val = mg2[e_ar, s_idx]

    r_of = CR[e_ar, b_idx]
    gam_of = np.where(b_gam > -1.0, b_gam, -1.0)
    cl_of = CC[e_ar, b_idx]
    want_alt = (b_gam <= config.SECONDARY_ALIGN_THRESH) & (s_val > 0)
    alt_of = np.where(want_alt, CR[e_ar, s_idx], -1)

    # head order = reverse insertion order per group
    emit_m = (ME < 0) | (ME < e_local)
    eidx = np.nonzero(emit_m)[0]
    order_e = eidx[np.lexsort((-e_local[eidx], grp_of_e[eidx]))]
    m_e = ME[order_e]
    m_glob = np.where(m_e >= 0, ent_base[grp_of_e[order_e]] + m_e, -1)

    gamma_out = np.zeros(N_tot, np.float64)
    cloud_out = np.zeros(N_tot, np.int64)
    alt_out = np.full(N_tot, -1, np.int64)
    selected_mate = np.full(N_tot, -1, np.int64)
    ents = np.concatenate([order_e, m_glob[m_glob >= 0]])
    rids = r_of[ents]
    gamma_out[rids] = gam_of[ents]
    cloud_out[rids] = cl_of[ents]
    alt_out[rids] = alt_of[ents]

    best_a = r_of[order_e]
    best_b = np.where(m_glob >= 0, r_of[np.maximum(m_glob, 0)], -1)
    paired = best_b >= 0
    selected_mate[best_a[paired]] = best_b[paired]
    selected_mate[best_b[paired]] = best_a[paired]

    # duplicate marking (align.c:574-585), group-segmented lexsort
    many = sts[0].many
    RC = {f: np.concatenate([st.R[f] for st in sts])
          for f in ("mate", "rev", "chrom", "pos")}
    dup_local: List[np.ndarray] = [np.zeros(0, np.int64)] * K
    if not many and order_e.shape[0]:
        fa = np.stack([best_a,
                       np.where(paired, best_b, -1)], axis=1).ravel()
        fa = fa[fa >= 0]
        g_of_f = np.searchsorted(rec_base, fa, side="right") - 1
        mates = selected_mate[fa]
        has_mate = mates >= 0
        mchrom = np.where(has_mate, RC["chrom"][np.maximum(mates, 0)],
                          np.iinfo(np.int64).max)
        mpos = np.where(has_mate, RC["pos"][np.maximum(mates, 0)],
                        np.iinfo(np.int64).max)
        keys = np.stack([
            g_of_f, RC["mate"][fa], RC["rev"][fa], RC["chrom"][fa],
            RC["pos"][fa], mchrom, mpos], axis=1)
        order2 = np.lexsort(tuple(keys.T[::-1]))
        sk = keys[order2]
        same = np.zeros(fa.shape[0], bool)
        same[1:] = (sk[1:] == sk[:-1]).all(axis=1)
        dups = fa[order2[same]]
        gd = g_of_f[order2[same]]
        o3 = np.argsort(gd, kind="stable")
        dups, gd = dups[o3], gd[o3]
        cuts = np.searchsorted(gd, np.arange(K + 1))
        for k in range(K):
            dup_local[k] = dups[cuts[k]:cuts[k + 1]] - rec_base[k]

    # per-group emit_pairs segmentation (localized record ids)
    ge = grp_of_e[order_e]
    cuts_e = np.searchsorted(ge, np.arange(K + 1))
    for k, (i, st) in enumerate(zip(sel, sts)):
        s0, e0 = int(cuts_e[k]), int(cuts_e[k + 1])
        rb = rec_base[k]
        a_l = best_a[s0:e0] - rb
        b_l = np.where(best_b[s0:e0] >= 0, best_b[s0:e0] - rb, -1)
        if dup_local[k].shape[0]:
            st.R["duplicate"][dup_local[k]] = True
        r0, r1 = int(rec_base[k]), int(rec_base[k + 1])
        nc = st.n_clouds
        cl = cloud_out[r0:r1]
        sm = selected_mate[r0:r1]
        al = alt_out[r0:r1]
        out[i] = GroupResult(
            records=st.R,
            idents=st.RI,
            order=st.order,
            emit_pairs=list(zip(a_l.tolist(), b_l.tolist())),
            gamma=gamma_out[r0:r1],
            cloud_id=cl + bases[i],
            cloud_bad=np.array(st.cloud_bad, np.int8)[
                np.clip(cl, 0, max(nc - 1, 0))] if nc
            else np.zeros(st.n, np.int8),
            alt_idx=np.where(al >= 0, al - rb, -1),
            selected_mate=np.where(sm >= 0, sm - rb, -1),
            n_clouds=nc,
        )
    return out


def process_barcode_group(records: np.ndarray, idents: np.ndarray,
                          profile: config.PlatformProfile,
                          cloud_id_start: int = 0,
                          apply_opt: bool = False,
                          rng: Optional[np.random.Generator] = None,
                          n_pairs_in_group: Optional[int] = None) -> GroupResult:
    """Run clouds+EM+selection for all records of one barcode.

    records: RECORD_DTYPE array (all same bc); idents: per-record read-name
    strings (np.ndarray of str) used for ordering and entry identity.
    ``n_pairs_in_group``: total read pairs in the barcode group including
    unaligned ones — gates EM like the reference's n_fq1_recs >= 30
    (align.c:345); defaults to the number of pairs holding records.
    """
    st = sweep_group(records, idents, profile, apply_opt, rng,
                     n_pairs_in_group)
    if st.needs_em:
        run_em_host(st)
    return finish_group(st, cloud_id_start)


def _normalize_chains(weights: np.ndarray, comp: np.ndarray) -> np.ndarray:
    """Normalize cloud weights within each disjoint-set chain
    (align.c:125-143)."""
    totals = np.zeros(comp.max() + 1, np.float64)
    np.add.at(totals, comp, weights)
    t = totals[comp]
    return np.where(t > 0, weights / np.where(t > 0, t, 1.0), weights)


def _recompute_gammas(sel, gammas, weights, mate_entry, cand_cloud, cmask,
                      rec_chrom, rec_pos, rec_rev, raw_score, many):
    """Vectorized gamma update for a set of entries (align.c:444-521)."""
    E = sel.shape[0]
    C = gammas.shape[1]
    mask = cmask[sel]

    cloud_w = weights[cand_cloud[sel]]
    if many:
        tot = np.where(mask, cloud_w, 0.0).sum(axis=1, keepdims=True)
        cloud_w = np.where(tot > 0, cloud_w / np.where(tot > 0, tot, 1.0), 0.0)
    with np.errstate(divide="ignore"):
        log_w = np.log(np.where(cloud_w > 0, cloud_w, 1e-300))

    # best mate score
    best_mate = np.full((E, C), config.UNPAIRED_PENALTY)
    has_mate = mate_entry[sel] >= 0
    if has_mate.any():
        hm = np.nonzero(has_mate)[0]
        me = mate_entry[sel][hm]
        m_chrom = rec_chrom[me][:, None, :]      # [H, 1, C]
        m_pos = rec_pos[me][:, None, :]
        m_rev = rec_rev[me][:, None, :]
        m_cloud = cand_cloud[me][:, None, :]
        m_gamma = gammas[me][:, None, :]
        m_mask = cmask[me][:, None, :]

        i_chrom = rec_chrom[sel][hm][:, :, None]  # [H, C, 1]
        i_pos = rec_pos[sel][hm][:, :, None]
        i_rev = rec_rev[sel][hm][:, :, None]
        i_cloud = cand_cloud[sel][hm][:, :, None]

        ok = (m_mask & (m_chrom == i_chrom) & (m_rev != i_rev)
              & (m_cloud == i_cloud) & (m_gamma != 0.0))
        d = np.where(i_rev == 1, i_pos - m_pos, m_pos - i_pos)
        pen = np.where((d >= config.INSERT_MIN) & (d <= config.INSERT_MAX),
                       0.0, config.UNPAIRED_PENALTY)
        with np.errstate(divide="ignore", invalid="ignore"):
            ms = pen + np.log(np.where(ok & (m_gamma > 0), m_gamma, 1.0))
        ms = np.where(ok, ms, -np.inf)
        best = ms.max(axis=2)
        best_mate[hm] = np.maximum(best, config.UNPAIRED_PENALTY)

    new = raw_score[sel] + log_w + best_mate
    return normalize_log_probs_batch(np.where(mask, new, 0.0), mask)
