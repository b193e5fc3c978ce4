"""The sharded candidate-generation step (ema_tpu/parallel/step.py).

One program per batch of oriented reads:

    seed (FM backward search)  ->  locate (LF-walk)  ->  window gather
    ->  banded-SW scoring  ->  per-read best reduction

over a ('data', 'cand') ``DeviceMesh``: reads split along ``data`` in
contiguous row blocks; each read's candidate slots (sampled SA-interval
hits) split along ``cand``, recombined by an argmax over the stacked
per-cell bests.  The batch statistics are summed over the ``data``
blocks, the counterpart of the JAX step's psums.

Each cell runs ``candidate_core`` on its own device and stream; the
scorer is ``ops/sw.gather_score`` with the banded scorer, so on a card
every cell launches the ``sw_banded`` CUDA kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ema_tpu_torch.index import fm as fm_mod
from ema_tpu_torch.ops.sw import gather_score
from ema_tpu_torch.parallel.mesh import CAND_AXIS, DATA_AXIS, DeviceMesh

NEG = -(1 << 28)
I32 = torch.int32


class StepOut(NamedTuple):
    best_score: torch.Tensor  # int32 [B] clip-adjusted best SW score
    best_gpos: torch.Tensor   # int32 [B] global text pos of best window start
    n_aligned: torch.Tensor   # int32 [] reads with a positive-score candidate
    sum_score: torch.Tensor   # int32 [] sum of positive best scores


def _expand_hits_shard(s_lo: torch.Tensor, s_hi: torch.Tensor, k_local: int,
                       shard: int, n_shards: int):
    """Shard-local slice of ``fm.expand_seed_hits``.

    Hit slots are numbered globally 0..k_local*n_shards-1 and sampled
    evenly across the SA interval (BWA max_occ-style capping,
    src/align.c:185); shard ``i`` materializes slots
    [i*k_local, (i+1)*k_local).  The stride is the JAX package's split
    form, ``i*(w//t) + (i*(w%t))//t``, which equals ``(i*w)//t``.
    """
    dev = s_lo.device
    width = (s_hi.to(torch.int64) - s_lo.to(torch.int64))[..., None]
    total = k_local * n_shards
    i = shard * k_local + torch.arange(k_local, dtype=torch.int64,
                                       device=dev)
    take = width.clamp(max=total)
    stride = (i * torch.div(width, total, rounding_mode="floor")
              + torch.div(i * torch.remainder(width, total), total,
                          rounding_mode="floor"))
    idx = torch.where(width > total, stride, i)
    rows = s_lo.to(torch.int64)[..., None] + idx
    valid = i < take
    return torch.where(valid, rows, 0), valid


def candidate_core(fm: fm_mod.FMIndexArrays, text: torch.Tensor,
                   reads: torch.Tensor, lens: torch.Tensor,
                   cand_index: int = 0,
                   *, max_seeds: int = 8, hits_per_seed: int = 4,
                   window_pad: int = 16, min_seed_len: int = 19,
                   n_cand_shards: int = 1,
                   match: int = 1, mismatch: int = 4,
                   gap_open: int = 6, gap_extend: int = 1, clip: int = 5):
    """Device align step for one cell: [B, L] oriented reads -> best hits.

    ``text``: uint8 [n] 2-bit forward genome on the cell's device, ``fm``
    the FM arrays there (both strands, 2n).  Returns (best_score int32
    [B], best_gpos int32 [B]) over this cell's candidate slots.
    """
    B, L = reads.shape
    S, K = max_seeds, hits_per_seed
    W = L + 2 * window_pad
    n = text.shape[0]
    dev = text.device

    s_lo, s_hi, s_qb, s_len, _ = fm_mod.seed_reads(
        fm, reads, lens, max_seeds=S, min_seed_len=min_seed_len)
    rows, valid = _expand_hits_shard(s_lo, s_hi, K, int(cand_index),
                                     n_cand_shards)
    pos = fm_mod.locate(fm, rows)                        # [B, S, K]
    # reverse-strand hits (upper half of the fm space) are dropped in this
    # step, as in the JAX package's
    valid = valid & (pos + s_len.to(torch.int64)[..., None] <= n)

    win_lo = pos - s_qb.to(torch.int64)[..., None] - window_pad
    win_lo = win_lo.clamp(0, max(n - W, 0))
    flat_lo = win_lo.reshape(B, S * K)
    vmask = valid.reshape(B, S * K)

    # the JAX step clamps window columns to text[n - 1] where gather_score
    # reads the sentinel 5 past the text; they differ only when n < W,
    # so there the text is extended by copies of its last base
    if n < W:
        text = torch.cat([text, text[-1:].expand(W - n)])
    score = torch.full((B, S * K), NEG, dtype=I32, device=dev)
    if B * S * K:
        owners = torch.arange(B, dtype=I32, device=dev).repeat_interleave(
            S * K)
        win_len = torch.where(vmask, W, 0).to(I32).reshape(-1)
        # the window is built around the seed diagonal, so a corridor of
        # the smallest multiple of 128 lanes above 2 * pad + 2 covers
        # every candidate (the JAX step's w_band)
        w_band = ((2 * window_pad + 2 + 127) // 128) * 128
        wl = torch.full((B * S * K,), w_band, dtype=I32, device=dev)
        out = gather_score(
            text, reads.to(torch.uint8).contiguous(), lens.to(I32),
            owners, flat_lo.reshape(-1), win_len, wl, scorer="banded",
            match=match, mismatch=mismatch, gap_open=gap_open,
            gap_extend=gap_extend, clip=clip)
        score = torch.where(vmask, out[:, 0].reshape(B, S * K), NEG)
    k = torch.argmax(score, dim=1, keepdim=True)
    best = torch.take_along_dim(score, k, dim=1)[:, 0].to(I32)
    best_gpos = torch.take_along_dim(flat_lo, k, dim=1)[:, 0].to(I32)
    return best, best_gpos


def make_sharded_candidate_step(mesh: DeviceMesh, fm: fm_mod.FMIndexArrays,
                                text: torch.Tensor, **static):
    """Build the multi-cell step over ``mesh``.

    Returned fn: (reads [B, L], lens [B]) -> StepOut on the mesh's first
    device, with B divisible by the data-axis size.  The FM index and text
    are copied once to each distinct device (the reference likewise holds
    one full BWA index per process, src/bwabridge.c:77-96); reads are split
    along ``data``, candidate slots along ``cand``.  The function records
    what it did on itself: ``cell_rows`` (rows per cell of the last call)
    and ``collectives`` (the cross-cell reductions it performed:
    ``cand-argmax``, ``data-sum``).
    """
    n_data, n_cand = mesh.shape[DATA_AXIS], mesh.shape[CAND_AXIS]
    static.setdefault("n_cand_shards", n_cand)
    state = {d: (fm.to(d), text.to(d)) for d in mesh.distinct_devices}
    home = mesh.grid[0][0]

    def step(reads: torch.Tensor, lens: torch.Tensor) -> StepOut:
        B = reads.shape[0]
        if B % n_data:
            raise ValueError(f"batch of {B} reads is not divisible by the "
                             f"data axis ({n_data})")
        b = B // n_data
        cells = {}
        for d in range(n_data):
            for c in range(n_cand):
                with mesh.cell(d, c) as dev:
                    fm_d, text_d = state[dev]
                    cells[d, c] = candidate_core(
                        fm_d, text_d, reads[d * b:(d + 1) * b].to(dev),
                        lens[d * b:(d + 1) * b].to(dev), c, **static)
                step.cell_rows[d, c] = b
        bests, gposs, n_al, s_sc = [], [], [], []
        for d in range(n_data):
            for c in range(n_cand):
                mesh.join(d, c, *cells[d, c])
            # recombine candidate shards: stack the per-cell bests, argmax
            # (the first maximum, as jnp.argmax takes)
            alls = torch.stack([cells[d, c][0].to(home)
                                for c in range(n_cand)])
            allg = torch.stack([cells[d, c][1].to(home)
                                for c in range(n_cand)])
            w = torch.argmax(alls, dim=0, keepdim=True)
            best = torch.take_along_dim(alls, w, dim=0)[0]
            bests.append(best)
            gposs.append(torch.take_along_dim(allg, w, dim=0)[0])
            pos_mask = best > 0
            n_al.append(pos_mask.sum().to(I32))
            s_sc.append(torch.where(pos_mask, best, 0).sum().to(I32))
        step.collectives[:] = ((["cand-argmax"] if n_cand > 1 else [])
                               + (["data-sum"] if n_data > 1 else []))
        return StepOut(torch.cat(bests), torch.cat(gposs),
                       torch.stack(n_al).sum().to(I32),
                       torch.stack(s_sc).sum().to(I32))

    step.cell_rows = {}
    step.collectives = []
    return step

