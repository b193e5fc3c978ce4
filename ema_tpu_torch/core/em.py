"""The cloud EM: its plain version as batched torch ops, and its dispatch
to the card's kernel.

The counterpart of ema_tpu/core/em_jax.py (the model) and of
groups.dispatch_em_device_batch (ema_tpu/core/groups.py:736-823, the
batching and the asynchronous readback).  Same semantics as the host EM of
``core/groups.py`` (the reference's align.c:431-543):

  - gammas over padded [G, E, C] tensors (G barcode groups, E entries =
    (pair, mate) keys, C candidates per entry);
  - cloud weights by a scatter-add over local cloud ids, renormalized
    within disjoint-set chains, or per entry for many_clouds platforms;
  - the two-phase update order (the later-inserted mate first) as phase
    masks;
  - ``normalize_log_probs``: max shift, the log(1e-50) - log(n) floor,
    exactly 1.0 for single-candidate rows (src/util.c:129-163).

``em_run`` is the plain version and the tests' reference.  The dispatch
packs its groups flat and unpadded (``pack_states``); on a card one launch
of csrc/em_cloud.cu runs the whole EM of every group (ops/em_cloud.py),
on the CPU ``em_run_flat`` unflattens the same pack for ``em_run``.

Always float64, on an explicit device: em_jax is float64 only under x64,
and the golden SAM was frozen under x64.  The scatter-adds are
deterministic (``_scatter_sum``; the kernel sums each cloud in a fixed
order), so two runs on the same inputs give the same bits.
"""

from __future__ import annotations

import contextlib
import math
import time
from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch

from ema_tpu_torch import config
from ema_tpu_torch.core.groups import (EM_NATIVE_C, GroupState,
                                       _round_up_pow2, run_em_native)
from ema_tpu_torch.ops import em_cloud
from ema_tpu_torch.utils.logprobs import _LOG_EPSILON
from ema_tpu_torch.utils.metrics import Metrics

F64 = torch.float64


class EMInputs(NamedTuple):
    """Padded EM problem, batched over G groups (em_jax.EMInputs).

    Shapes: [G, E, C] unless noted.  Invalid slots are masked out in
    ``cmask`` / ``emask``; ``cand_cloud`` / ``comp`` stay in [0, NC) even
    for padding.  Integer planes may arrive narrowed (int16/int8).
    """

    score: torch.Tensor        # f64 raw log-prob alignment scores
    cmask: torch.Tensor        # bool candidate validity
    active: torch.Tensor       # bool record active & not duplicate
    cand_cloud: torch.Tensor   # int local cloud ids
    rec_chrom: torch.Tensor    # int
    rec_pos: torch.Tensor      # int
    rec_rev: torch.Tensor      # int (0/1)
    mate_entry: torch.Tensor   # int [G, E]: index of the mate entry or -1
    emask: torch.Tensor        # bool [G, E] entry validity
    comp: torch.Tensor         # int [G, NC] chain component of each cloud
    run_em: torch.Tensor       # bool [G]: the group meets the >=30-pair gate


def normalize_log_probs(p: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Batched reference normalize_log_probs over the last axis, float64
    (em_jax.normalize_log_probs_jnp)."""
    p = p.to(F64)
    counts = mask.sum(dim=-1)
    pm = torch.where(mask, p, -math.inf)
    pmax = pm.amax(dim=-1, keepdim=True)
    pmax = torch.where(torch.isfinite(pmax), pmax, 0.0)
    shifted = torch.where(mask, pm - pmax, 0.0)
    thresh = (_LOG_EPSILON - torch.log(counts.clamp(min=1).to(F64)))[..., None]
    vals = torch.where(mask & (shifted >= thresh), torch.exp(shifted), 0.0)
    totals = vals.sum(dim=-1, keepdim=True)
    out = torch.where(totals > 0,
                      vals / torch.where(totals > 0, totals, 1.0), 0.0)
    single = (counts == 1)[..., None]
    return torch.where(single, mask.to(F64), out)


def _scatter_sum(n: int, idx: torch.Tensor, vals: torch.Tensor
                 ) -> torch.Tensor:
    """out[i] = sum of vals[j] with idx[j] == i, in a fixed order.

    ``index_put_(accumulate=True)`` is sort-based on CUDA (no atomics) and
    serial on the CPU, so two runs on the same inputs give the same bits.
    """
    out = torch.zeros(n, dtype=vals.dtype, device=vals.device)
    return out.index_put_((idx,), vals, accumulate=True)


def _cloud_weights(gammas, weight_mask, cand_cloud, comp, nc: int,
                   many: bool) -> torch.Tensor:
    """Scatter-add expected coverage per cloud; chain-normalize
    (em_jax._cloud_weights)."""
    G = gammas.shape[0]
    g_base = torch.arange(G, device=gammas.device)[:, None] * nc
    exp_cov = _scatter_sum(
        G * nc, (g_base[..., None] + cand_cloud).reshape(-1),
        torch.where(weight_mask, gammas, 0.0).reshape(-1)).view(G, nc)
    if many:
        return exp_cov
    totals = _scatter_sum(G * nc, (g_base + comp).reshape(-1),
                          exp_cov.reshape(-1)).view(G, nc)
    t = torch.gather(totals, 1, comp)
    return torch.where(t > 0, exp_cov / torch.where(t > 0, t, 1.0), exp_cov)


def _mate_terms(inp: EMInputs):
    """The parts of the mate term that do not change across iterations:
    (me, has_mate, ok_static, pen), with [G, E, C(self), C(mate)] planes
    (em_jax._recompute:104-130)."""
    G, E, C = inp.score.shape
    me = inp.mate_entry.clamp(min=0)[..., None].expand(G, E, C)
    has_mate = (inp.mate_entry >= 0)[..., None]                 # [G, E, 1]

    def mg(arr):            # arr[g, mate_entry[g, e], :] as [G, E, 1, C]
        return torch.gather(arr, 1, me)[:, :, None, :]

    i_chrom = inp.rec_chrom[..., None]                           # [G,E,C,1]
    i_pos = inp.rec_pos[..., None]
    i_rev = inp.rec_rev[..., None]
    i_cloud = inp.cand_cloud[..., None]
    m_pos, m_rev = mg(inp.rec_pos), mg(inp.rec_rev)
    ok_static = (mg(inp.cmask) & has_mate[..., None]
                 & (mg(inp.rec_chrom) == i_chrom) & (m_rev != i_rev)
                 & (mg(inp.cand_cloud) == i_cloud))
    d = torch.where(i_rev == 1, i_pos - m_pos, m_pos - i_pos)
    pen = torch.where((d >= config.INSERT_MIN) & (d <= config.INSERT_MAX),
                      0.0, config.UNPAIRED_PENALTY).to(F64)
    return me, has_mate, ok_static, pen


def _recompute(inp: EMInputs, gammas, weights, many: bool, mate_terms):
    """One full-entry gamma recompute (align.c:444-521), all entries
    (em_jax._recompute); ``mate_terms`` is ``_mate_terms(inp)``."""
    me, has_mate, ok_static, pen = mate_terms
    G, E, C = inp.score.shape
    cloud_w = torch.gather(weights[:, None, :].expand(G, E, -1), 2,
                           inp.cand_cloud)
    if many:
        tot = torch.where(inp.cmask, cloud_w, 0.0).sum(dim=-1, keepdim=True)
        cloud_w = torch.where(tot > 0,
                              cloud_w / torch.where(tot > 0, tot, 1.0), 0.0)
    log_w = torch.log(torch.where(cloud_w > 0, cloud_w, 1e-300))

    m_gamma = torch.gather(gammas, 1, me)[:, :, None, :]        # [G,E,1,C]
    ok = ok_static & (m_gamma != 0.0)
    ms = pen + torch.log(torch.where(ok & (m_gamma > 0), m_gamma, 1.0))
    ms = torch.where(ok, ms, -math.inf)
    best_mate = ms.amax(dim=-1).clamp(min=config.UNPAIRED_PENALTY)
    best_mate = torch.where(has_mate, best_mate, config.UNPAIRED_PENALTY)

    new = inp.score + log_w + best_mate
    return normalize_log_probs(torch.where(inp.cmask, new, 0.0), inp.cmask)


def em_run(inp: EMInputs, *, many: bool = False,
           em_iters: int = config.EM_ITERS):
    """Full EM: init gammas from scores, iterate, return (gammas, weights)
    (em_jax.em_run).

    Groups with ``run_em`` False keep their score-normalized init gammas
    (the reference's < 30 pairs gate, align.c:345) but still produce
    weights.  Integer planes are upcast to int64 (gather indices) on the
    tensors' device.
    """
    inp = inp._replace(
        score=inp.score.to(F64),
        cand_cloud=inp.cand_cloud.long(), rec_chrom=inp.rec_chrom.long(),
        rec_pos=inp.rec_pos.long(), rec_rev=inp.rec_rev.long(),
        mate_entry=inp.mate_entry.long(), comp=inp.comp.long())
    nc = inp.comp.shape[1]
    gammas = normalize_log_probs(inp.score, inp.cmask)
    init_gammas = gammas
    weights = _cloud_weights(gammas, inp.cmask, inp.cand_cloud, inp.comp,
                             nc, many)
    init_weights = weights

    e_idx = torch.arange(inp.mate_entry.shape[1],
                         device=inp.mate_entry.device)[None, :]
    phase_b = (inp.mate_entry >= 0) & (e_idx < inp.mate_entry) & inp.emask
    phase_a = inp.emask & ~phase_b
    wmask = inp.active & inp.cmask
    mate_terms = _mate_terms(inp)
    for _ in range(em_iters):
        for phase in (phase_a, phase_b):
            new = _recompute(inp, gammas, weights, many, mate_terms)
            gammas = torch.where(phase[..., None] & inp.cmask, new, gammas)
        weights = _cloud_weights(gammas, wmask, inp.cand_cloud, inp.comp,
                                 nc, many)

    run = inp.run_em
    gammas = torch.where(run[:, None, None], gammas, init_gammas)
    weights = torch.where(run[:, None], weights, init_weights)
    return gammas, weights


class EMPack(NamedTuple):
    """The EM-gated groups of one dispatch, flat and unpadded: the layout
    of csrc/em_cloud.cu (ops/em_cloud.FIELDS, in its argument order).
    Group g owns entries [e_off[g], e_off[g+1]) and clouds [k_off[g],
    k_off[g+1]); entry e owns candidates [cand_off[e], cand_off[e+1]), its
    cmask-selected ones in column order."""

    e_off: np.ndarray            # int32 [G + 1]
    k_off: np.ndarray            # int32 [G + 1]
    cand_off: np.ndarray         # int32 [E + 1]
    mate: np.ndarray             # int32 [E]: mate entry in the group, or -1
    score: np.ndarray            # f64 [N]
    cloud: np.ndarray            # int32 [N]: cloud in the group
    chrom: np.ndarray            # int32 [N]
    pos: np.ndarray              # int64 [N]
    flags: np.ndarray            # uint8 [N]: 1 reverse, 2 active
    comp: np.ndarray             # int32 [K]: chain of each cloud in the group
    cloud_cand_off: np.ndarray   # int32 [K + 1]
    cloud_cands: np.ndarray      # int32 [N]: each cloud's candidates, ascending
    comp_cloud_off: np.ndarray   # int32 [K + 1]
    comp_clouds: np.ndarray      # int32 [K]: each chain's clouds, ascending


def _offsets(counts: np.ndarray) -> np.ndarray:
    """int32 [len(counts) + 1]: 0 and the running sums of ``counts``."""
    off = np.zeros(len(counts) + 1, np.int32)
    np.cumsum(counts, out=off[1:])
    return off


def _csr(keys: np.ndarray, base: np.ndarray, n: int):
    """(offsets [n + 1], members) of the global ``keys``: the indices i
    with keys[i] == k, ascending, as ``i - base[i]``."""
    order = np.argsort(keys, kind="stable")
    return (_offsets(np.bincount(keys, minlength=n)),
            (order - base[order]).astype(np.int32))


def pack_states(states: List[GroupState]) -> EMPack:
    """The flat pack of ``states`` in one pass over the groups."""
    n_ent = np.array([st.n_entries for st in states], np.int64)
    n_k = np.array([st.n_clouds for st in states], np.int64)
    cols = {k: [] for k in ("counts", "mate", "cloud", "comp", "score",
                            "chrom", "pos", "rev", "active", "duplicate")}
    for st in states:
        cm, R = st.cmask, st.R
        idx = st.cand_rec[cm]
        cols["counts"].append(cm.sum(axis=1))
        cols["mate"].append(st.mate_entry)
        cols["cloud"].append(st.cand_cloud[cm])
        cols["comp"].append(st.comp)
        for f in ("score", "chrom", "pos", "rev", "active", "duplicate"):
            cols[f].append(R[f][idx])
    c = {k: np.concatenate(v) for k, v in cols.items()}
    e_off, k_off, cand_off = (_offsets(n_ent), _offsets(n_k),
                              _offsets(c["counts"]))
    K = int(k_off[-1])
    cloud = c["cloud"].astype(np.int32)
    comp = c["comp"].astype(np.int32)
    c_start = cand_off[e_off[:-1]]
    n_cand = cand_off[e_off[1:]] - c_start
    cloud_k0 = np.repeat(k_off[:-1], n_k)
    cloud_cand_off, cloud_cands = _csr(
        cloud + np.repeat(k_off[:-1], n_cand), np.repeat(c_start, n_cand), K)
    comp_cloud_off, comp_clouds = _csr(comp + cloud_k0, cloud_k0, K)
    flags = ((c["rev"] == 1)
             | ((c["active"] & ~c["duplicate"]) << 1)).astype(np.uint8)
    return EMPack(
        e_off=e_off, k_off=k_off, cand_off=cand_off,
        mate=c["mate"].astype(np.int32),
        score=c["score"].astype(np.float64, copy=False), cloud=cloud,
        chrom=c["chrom"].astype(np.int32, copy=False),
        pos=c["pos"].astype(np.int64, copy=False), flags=flags, comp=comp,
        cloud_cand_off=cloud_cand_off, cloud_cands=cloud_cands,
        comp_cloud_off=comp_cloud_off, comp_clouds=comp_clouds)


def em_run_flat(pack: EMPack, many: bool) -> np.ndarray:
    """The plain version of csrc/em_cloud.cu: the pack unflattened to
    padded [G, E, C] planes (E, C and NC rounded up as
    groups._pack_states rounds them), ``em_run`` on CPU tensors, and every
    candidate's gamma in the pack's order."""
    e_off = pack.e_off.astype(np.int64)
    k_off = pack.k_off.astype(np.int64)
    cand_off = pack.cand_off.astype(np.int64)
    G, n_e, K = e_off.size - 1, int(e_off[-1]), int(k_off[-1])
    counts, n_k = np.diff(cand_off), np.diff(k_off)
    E = _round_up_pow2(int(np.diff(e_off).max()))
    C = _round_up_pow2(int(counts.max()), 2)
    NC = _round_up_pow2(max(int(n_k.max()), 1))
    ent_g = np.repeat(np.arange(G), np.diff(e_off))
    ent_l = np.arange(n_e) - e_off[ent_g]
    cand_e = np.repeat(np.arange(n_e), counts)
    at = (ent_g[cand_e], ent_l[cand_e],
          np.arange(cand_off[-1]) - cand_off[cand_e])

    def plane(vals, dtype):
        out = np.zeros((G, E, C), dtype)
        out[at] = vals
        return out

    mate = np.full((G, E), -1, np.int64)
    mate[ent_g, ent_l] = pack.mate
    emask = np.zeros((G, E), bool)
    emask[ent_g, ent_l] = True
    comp = np.broadcast_to(np.arange(NC), (G, NC)).copy()
    if not many:
        k_g = np.repeat(np.arange(G), n_k)
        comp[k_g, np.arange(K) - k_off[k_g]] = pack.comp
    planes = dict(
        score=plane(pack.score, np.float64), cmask=plane(True, bool),
        active=plane(pack.flags & 2 != 0, bool),
        cand_cloud=plane(pack.cloud, np.int64),
        rec_chrom=plane(pack.chrom, np.int64),
        rec_pos=plane(pack.pos, np.int64),
        rec_rev=plane(pack.flags & 1, np.int64), mate_entry=mate,
        emask=emask, comp=comp, run_em=np.ones(G, bool))
    gammas, _ = em_run(EMInputs(**{k: torch.from_numpy(v)
                                   for k, v in planes.items()}), many=many)
    return gammas.numpy()[at]


def _write_back(states: List[GroupState], pack: EMPack,
                flat: np.ndarray) -> None:
    """Each state's [e, c] gammas from its slice of the flat gammas."""
    c_start = pack.cand_off[pack.e_off]
    for g, st in enumerate(states):
        gam = np.zeros(st.cmask.shape, np.float64)
        gam[st.cmask] = flat[c_start[g]:c_start[g + 1]]
        st.gammas = gam


def dispatch_em_batch(states: List[GroupState], device: torch.device,
                      stream: Optional[torch.cuda.Stream] = None,
                      metrics: Optional[Metrics] = None
                      ) -> Callable[[], None]:
    """Launch the EM of the EM-gated groups on ``device``; return
    ``wait``, which blocks on the result and writes each state's gammas
    (groups.dispatch_em_device_batch).

    The groups are packed flat (``pack_states``).  On a CUDA device one
    upload, one launch of csrc/em_cloud.cu and one readback into pinned
    host memory are queued on ``stream`` (a side stream from torch's pool
    when None) with an event behind them (ops/em_cloud.launch), so the
    host work done between dispatch and ``wait`` (the previous emit
    batch's selection and emission) overlaps the device.  Pool streams are
    created non-blocking, so they do not serialise with the default stream
    on which chunk workers launch the SW kernels.  On the CPU the plain
    version (``em_run_flat``) runs here and ``wait`` only writes the
    gammas.  With ``metrics``, ``em.pack`` and ``em.launch`` time the two
    steps inside the caller's span and ``em.kernel`` counts the groups of
    the launch.

    Groups must share ``many``.  Groups deeper than EM_NATIVE_C
    candidates run through the native flat EM here, as in the reference.
    """
    states = [st for st in states if st.needs_em]
    for st in states:
        if st.cmask.shape[1] > EM_NATIVE_C:
            run_em_native(st)
    states = [st for st in states if st.cmask.shape[1] <= EM_NATIVE_C]
    if not states:
        return lambda: None
    many = states[0].many
    if any(st.many != many for st in states):
        raise ValueError("dispatch_em_batch: groups must share many_clouds")

    def span(name):
        return (metrics.stage(name) if metrics is not None
                else contextlib.nullcontext())

    with span("em.pack"):
        pack = pack_states(states)
    with span("em.launch"):
        if device.type == "cuda":
            pending = em_cloud.launch(pack, many, device,
                                      stream or torch.cuda.Stream(device))
        else:
            flat = em_run_flat(pack, many)
    if metrics is not None:
        now = time.time_ns()
        metrics.record("em.kernel", now, now, len(states))
    if device.type != "cuda":
        return lambda: _write_back(states, pack, flat)

    def wait() -> None:
        _write_back(states, pack, pending.wait())
        pending.release()

    return wait
