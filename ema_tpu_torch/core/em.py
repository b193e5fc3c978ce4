"""The cloud EM as batched torch ops on one device, and its dispatch.

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

Always float64, on an explicit device: em_jax is float64 only under x64,
and the golden SAM was frozen under x64.  The scatter-adds are
deterministic on both devices (``_scatter_sum``), so two runs on the same
inputs give the same bits.
"""

from __future__ import annotations

import math
from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch

from ema_tpu_torch import config
from ema_tpu_torch.core.groups import (EM_NATIVE_C, GroupState,
                                       _pack_states, run_em_native)
from ema_tpu_torch.utils.logprobs import _LOG_EPSILON

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


def _narrow(a: np.ndarray) -> np.ndarray:
    """int16 for the upload when every value fits (groups.py:795-798):
    cloud, entry and chrom indices virtually always do."""
    if a.size and (a.max() >= (1 << 15) or a.min() < -(1 << 15)):
        return a
    return a.astype(np.int16)


def dispatch_em_batch(states: List[GroupState], device: torch.device,
                      stream: Optional[torch.cuda.Stream] = None
                      ) -> Callable[[], None]:
    """Launch one padded [G, E, C] EM for the EM-gated groups on
    ``device``; return ``wait``, which blocks on the result and writes
    each state's gammas (groups.dispatch_em_device_batch).

    On a CUDA device the upload, ``em_run`` and the readback into pinned
    host memory are queued on ``stream`` (a side stream from torch's pool
    when None) with an event behind them, so the host work done between
    dispatch and ``wait`` (the previous emit batch's selection and
    emission) overlaps the device.  Pool streams are created non-blocking,
    so they do not serialise with the default stream on which chunk
    workers launch the SW kernels.  On the CPU the EM runs here and
    ``wait`` only writes the gammas.

    Groups must share ``many``.  Groups deeper than EM_NATIVE_C
    candidates run through the native flat EM here, as in the reference
    ([G, E, C, C] mate terms would explode).  G is not padded to a power
    of two: that served XLA's compile cache, and torch compiles nothing.
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
    d, (G, E, C, NC) = _pack_states(states)
    planes = dict(
        score=d["score"], cmask=d["cmask"], active=d["active"],
        cand_cloud=_narrow(d["cand_cloud"]),
        rec_chrom=_narrow(d["rec_chrom"]), rec_pos=d["rec_pos"],
        rec_rev=d["rec_rev"].astype(np.int8),
        mate_entry=_narrow(d["mate_entry"]), emask=d["emask"],
        comp=_narrow(d["comp"]), run_em=np.ones(G, bool))

    def write(gh: np.ndarray) -> None:
        for g, st in enumerate(states):
            e, c = st.cmask.shape
            st.gammas = gh[g, :e, :c]

    if device.type != "cuda":
        gammas, _ = em_run(EMInputs(**{
            k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in planes.items()}), many=many)
        gh = gammas.numpy()
        return lambda: write(gh)

    stream = stream or torch.cuda.Stream(device)
    with torch.cuda.stream(stream):
        inp = EMInputs(**{
            k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
            .to(device, non_blocking=True) for k, v in planes.items()})
        gammas, _ = em_run(inp, many=many)
        host = torch.empty(gammas.shape, dtype=F64, pin_memory=True)
        host.copy_(gammas, non_blocking=True)
        done = torch.cuda.Event()
        done.record(stream)

    def wait() -> None:
        done.synchronize()
        write(host.numpy())

    return wait
