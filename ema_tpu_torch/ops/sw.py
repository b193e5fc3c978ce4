"""Smith-Waterman scoring: the four CUDA kernels' wrappers and their plain
PyTorch versions.

``gather_score`` is what the Aligner calls: for candidate b it scores
oriented read ``owners[b]`` against the text window
``[win_lo[b], win_lo[b] + win_len[b])`` and returns int32 [N, 4] columns
(score, qb, qe, ref_end).  ``scorer`` picks the recurrence, each the port
of one Pallas kernel of ema_tpu/ops/sw_pallas.py with the gather of
ema_tpu/core/pipeline.py:_gather_score fused in:

  banded    csrc/sw_banded.cu         _banded_kernel          corridor k < wl
  banded16  csrc/sw_banded16.cu       _banded_kernel16        the same, int16
  packed    csrc/sw_banded_packed.cu  _banded_kernel_packed   wl <= 64
  scan      csrc/sw_batch.cu          _kernel                 whole window

On CUDA tensors the scorer's kernel launches (``banded`` and ``banded16``
once per corridor-width class of the call, see ``plan_class_launches``,
each class in the thread form its width and the call's size call for;
``scan`` with the threads a candidate that the call's longest read and
its size call for; ``packed`` once, 16 threads x 4 lanes or, for a call
of more than 8 candidates an SM, 8 x 8); on CPU tensors its plain
version runs.  A CUDA tensor never runs the plain version, and a failed
build or launch raises.  All four are one-pass kernels of their own that
look the substitution score up as a signed byte; ``sw_banded`` and
``sw_batch`` also take any other int32 scoring (in the mask form of their
lookups), as the JAX banded and scan scorers do.

The plain versions follow the JAX package exactly: ``sw_score_banded_ref``
is ema_tpu/ops/sw.py:sw_score_banded, ``sw_score_banded16_ref`` the same
sweep in int16 state as sw_pallas.py:_banded_kernel16,
``sw_score_banded_packed_ref`` the contract of
sw_pallas.py:sw_score_banded_pallas_packed (the sweep at w_band = 64; its
8-bit start-row packing, which wraps for reads past 256 bp, is not
copied), and ``sw_score_batch_ref`` ema_tpu/ops/sw.py:sw_score_batch.
``gather_score_ref`` adds the window gather of pipeline.py:95-109
(columns outside the text read the sentinel 5; win_lo may be negative).
"""

from __future__ import annotations

import bisect
import threading

import torch

NEG = -(1 << 28)
NEG16 = -16384            # int16 sentinel of sw_pallas.py:466
PACKED_MAX_WL = 64        # one 64-lane segment per candidate
MAX_READ = 1023           # the d_key tie packing keeps rows in 10 bits


class LaunchCounter:
    """Thread-safe counter (chunks score on a thread pool, so a bare
    ``+= 1`` could lose updates)."""

    def __init__(self) -> None:
        self._n = 0
        self._lock = threading.Lock()

    def add(self) -> None:
        with self._lock:
            self._n += 1

    def reset(self) -> None:
        with self._lock:
            self._n = 0

    @property
    def value(self) -> int:
        with self._lock:
            return self._n


# scorer -> the CUDA kernel (and csrc/<kernel>.cu) that serves it
KERNEL_OF = {"banded": "sw_banded", "banded16": "sw_banded16",
             "packed": "sw_banded_packed", "scan": "sw_batch"}
# kernel -> its __global__ function, the name by which SASS listings
# (tools/bench_sw.py, tools/ab_smoke.py) and profiler traces
# (chip_smoke.py) find it
KERNEL_SYMBOL = {"sw_banded": "sw_banded_kernel",
                 "sw_banded16": "sw_banded16_kernel",
                 "sw_banded_packed": "sw_banded_packed_kernel",
                 "sw_batch": "sw_batch_kernel"}
# launches of each kernel by gather_score (CUDA tensors only)
LAUNCHES = {k: LaunchCounter() for k in KERNEL_OF.values()}
# gather_score calls per scorer, on any device
CALLS = {s: LaunchCounter() for s in KERNEL_OF}
# callables (kernel, stream, tensors read, tensors written) told of every
# kernel launch once it is queued, by this module and ops/probe.py.  A
# launch reads and writes its tensors on ``stream``, the calling thread's
# current stream, which torch's stream sanitizer cannot see for a ctypes
# launch: chip_smoke.py's stream-sanitizer phase hands each launch to it
# through one of these.
LAUNCH_OBSERVERS: list = []


# the thread forms that ``_plan_kernel``'s ``group`` may ask of a scorer's
# kernel; 0 leaves the choice to the launch.  scan and packed: threads a
# candidate; banded and banded16: 8 takes each class's large-call form and
# 32 its small-call form (the tables in csrc/sw_banded.cu and
# csrc/sw_banded16.cu)
FORM_GROUPS = {"scan": (8, 32), "banded": (8, 32), "banded16": (8, 32),
               "packed": (8, 16)}


def reset_counts() -> None:
    for c in (*LAUNCHES.values(), *CALLS.values()):
        c.reset()


def _check_read_len(m: int) -> None:
    if m > MAX_READ:
        raise ValueError(f"banded SW tie-break packing requires read "
                         f"length < 1024 (got m={m})")


def _check_int16_range(m, w_band, match, mismatch, gap_open, gap_extend,
                       clip) -> None:
    """int16 state must not wrap: scores stay within m * match, the
    diagonal offsets within w_band * gap_extend, NEG16 minus both gaps and
    the clip stays above -32768."""
    top = (m * max(match, 1) + w_band * gap_extend + gap_open + gap_extend
           + clip + mismatch)
    if top >= -NEG16 // 2:
        raise ValueError(f"banded16: scores would leave the int16 range "
                         f"(m={m}, w_band={w_band})")


def _check_int32_range(m, match, mismatch, gap_open, gap_extend,
                       clip) -> None:
    """sw_batch holds the plain version's int32 arithmetic while every
    score stays within (NEG / 2, -NEG / 2): a cell scores at most m *
    match and, from its first column on, at least -(clip + mismatch), and
    the sentinel NEG minus both gaps must not wrap.  Its packed keys
    (column << 10 | start row) depend on the window and the read, never on
    the scoring."""
    top = (m * max(abs(match), 1) + abs(mismatch) + abs(gap_open)
           + abs(gap_extend) + abs(clip))
    if top >= -NEG // 2:
        raise ValueError(f"scan: scores would come within half of the "
                         f"int32 sentinel NEG (m={m}, match={match}, "
                         f"mismatch={mismatch})")


def _check_byte_scores(name, match, mismatch) -> None:
    """sw_banded16 and sw_banded_packed look the substitution score up as
    a signed byte; gather_score holds the CPU to the same limit."""
    if not (-127 <= match <= 127 and -127 <= mismatch <= 127):
        raise ValueError(f"{name}: match and mismatch must fit a signed "
                         f"byte (got {match}, {mismatch})")


def _row_sweep(reads, read_lens, refs, ref_lens, W, wl, dtype, neg, *,
               match, mismatch, gap_open, gap_extend, clip):
    """Banded row sweep over diagonal lanes k in [0, W), state in
    ``dtype`` with sentinel ``neg``; returns the per-lane bests (value,
    row, start row), int32 [B, W] each.  Line for line the recurrences of
    ema_tpu/ops/sw.py:240-289 (sw_pallas.py:513-567 for int16): scalars
    are cast to ``dtype`` per row, as the Pallas kernel builds its [B, 1]
    columns, so no operation widens the state."""
    B, m = reads.shape
    dev = reads.device
    i32 = torch.int32

    def const(v):
        return torch.tensor(v, dtype=dtype, device=dev)

    goe = gap_open + gap_extend
    reads = reads.to(i32)
    k_idx = torch.arange(W, dtype=i32, device=dev)[None, :]
    rl = read_lens.to(i32)[:, None]
    nl = ref_lens.to(i32)[:, None]
    kmask = k_idx < wl.to(i32)[:, None]
    ref_pad = torch.nn.functional.pad(refs.to(i32), (0, m + W), value=5)
    ke = (k_idx * gap_extend).to(dtype)
    neg_t, zero_t = const(neg), const(0)

    def full(fill, cols=W):
        return torch.full((B, cols), fill, dtype=dtype, device=dev)

    def shift_left(x, fill):
        return torch.cat([x[:, 1:], full(fill, 1)], dim=1)

    def shift_right(x, s, fill):
        return torch.cat([full(fill, s), x[:, :-s]], dim=1)

    Hp, Fp, SHp, SFp = full(neg), full(neg), full(0), full(0)
    bestv, besti, bests = full(neg), full(0), full(0)
    for i in range(1, m + 1):
        ref_row = ref_pad[:, i - 1:i - 1 + W]
        read_col = reads[:, i - 1:i]
        valid = (i <= rl) & (i + k_idx <= nl) & kmask
        row = const(i)

        sub = torch.where((read_col >= 4) | (ref_row >= 4), -1,
                          torch.where(read_col == ref_row, match,
                                      -mismatch)).to(dtype)
        fresh = const(0 if i == 1 else -clip)
        Hd = torch.maximum(Hp, fresh) + sub
        Sd = torch.where(Hp >= fresh, SHp, row - const(1))

        f_open = shift_left(Hp, neg) - const(goe)
        f_ext = shift_left(Fp, neg) - const(gap_extend)
        F = torch.maximum(f_open, f_ext)
        SF = torch.where(f_open >= f_ext, shift_left(SHp, 0),
                         shift_left(SFp, 0))

        # horizontal gaps: exclusive max-plus prefix scan over the row;
        # ties keep the nearer source (strict > takes the farther one)
        H0 = torch.maximum(Hd, F)
        S0 = torch.where(Hd >= F, Sd, SF)
        A = torch.where(valid, H0 + ke, neg_t)
        P = shift_right(A, 1, neg)
        PS = shift_right(S0, 1, 0)
        s = 1
        while s < W:
            P2 = shift_right(P, s, neg)
            PS2 = shift_right(PS, s, 0)
            PS = torch.where(P2 > P, PS2, PS)
            P = torch.maximum(P, P2)
            s *= 2
        E = P - ke - const(gap_open)
        # merge with the reference tie priority: diag >= horizontal >= vert
        H = torch.maximum(H0, E)
        SH = torch.where(Hd >= torch.maximum(E, F), Sd,
                         torch.where(E >= F, PS, SF))
        H = torch.where(valid, H, neg_t)
        F = torch.where(valid, F, neg_t)

        end_adj = torch.where(rl == i, zero_t, const(-clip))
        cand = torch.where(valid, H + end_adj, neg_t)
        improve = cand > bestv
        bestv = torch.where(improve, cand, bestv)
        besti = torch.where(improve, row, besti)
        bests = torch.where(improve, SH, bests)
        Hp, Fp, SHp, SFp = H, F, SH, SF
    return bestv.to(i32), besti.to(i32), bests.to(i32)


def _pick_lane(bestv, besti, bests) -> torch.Tensor:
    """Best lane; ties minimise d = 2i + k, then i (sw.py:296-303)."""
    W = bestv.shape[1]
    k_idx = torch.arange(W, dtype=torch.int32, device=bestv.device)[None, :]
    maxv = bestv.max(dim=1, keepdim=True).values
    d_key = (2 * besti + k_idx) * 1024 + besti
    key = torch.where(bestv == maxv, d_key, 1 << 30)
    bk = key.argmin(dim=1, keepdim=True)
    bi = besti.gather(1, bk)[:, 0]
    bs = bests.gather(1, bk)[:, 0]
    return torch.stack([maxv[:, 0], bs, bi, bi + bk[:, 0].to(torch.int32)],
                       dim=1).to(torch.int32)


def sw_score_banded_ref(reads: torch.Tensor, read_lens: torch.Tensor,
                        refs: torch.Tensor, ref_lens: torch.Tensor,
                        w_band: int, match: int = 1, mismatch: int = 4,
                        gap_open: int = 6, gap_extend: int = 1,
                        clip: int = 5, *,
                        wl: torch.Tensor) -> torch.Tensor:
    """Banded row sweep over diagonal lanes k in [0, w_band).

    reads int [B, m] (codes 0-3, >= 4 scores -1), refs int [B, n];
    returns int32 [B, 4] = (score, qb, qe, ref_end).  Line for line the
    recurrences of ema_tpu/ops/sw.py:174-310; ``wl`` masks lanes
    k >= wl[b] so the result does not depend on w_band.
    """
    _check_read_len(reads.shape[1])
    best = _row_sweep(reads, read_lens, refs, ref_lens, int(w_band), wl,
                      torch.int32, NEG, match=match, mismatch=mismatch,
                      gap_open=gap_open, gap_extend=gap_extend, clip=clip)
    return _pick_lane(*best)


def sw_score_banded16_ref(reads: torch.Tensor, read_lens: torch.Tensor,
                          refs: torch.Tensor, ref_lens: torch.Tensor,
                          w_band: int, match: int = 1, mismatch: int = 4,
                          gap_open: int = 6, gap_extend: int = 1,
                          clip: int = 5, *,
                          wl: torch.Tensor) -> torch.Tensor:
    """The row sweep in torch.int16 state, as sw_pallas.py:_banded_kernel16:
    the sentinel NEG16, int16 per-row columns, the final reduction in
    int32 and a no-alignment score (<= NEG16 // 2) reported as NEG
    (sw_pallas.py:643-645)."""
    m = reads.shape[1]
    _check_read_len(m)
    _check_int16_range(m, int(w_band), match, mismatch, gap_open,
                       gap_extend, clip)
    best = _row_sweep(reads, read_lens, refs, ref_lens, int(w_band), wl,
                      torch.int16, NEG16, match=match, mismatch=mismatch,
                      gap_open=gap_open, gap_extend=gap_extend, clip=clip)
    out = _pick_lane(*best)
    out[:, 0] = torch.where(out[:, 0] <= NEG16 // 2, NEG, out[:, 0])
    return out


def sw_score_banded_packed_ref(reads: torch.Tensor, read_lens: torch.Tensor,
                               refs: torch.Tensor, ref_lens: torch.Tensor,
                               wl: torch.Tensor, match: int = 1,
                               mismatch: int = 4, gap_open: int = 6,
                               gap_extend: int = 1,
                               clip: int = 5) -> torch.Tensor:
    """The pair-packed tier's contract: candidates 2b and 2b+1 share one
    128-lane row as two 64-lane segments, and each segment is the row
    sweep at w_band = 64 (sw_pallas.py:796-868).  An odd batch gains the
    wrapper's dummy tail candidate (read and window length 0, wl 0),
    which is scored and dropped.  Start rows are kept whole, so reads
    past 256 bp get the sw_score_banded result, not the JAX kernel's
    start row modulo 256 (its P & 255 at sw_pallas.py:754)."""
    B, m = reads.shape
    _check_read_len(m)
    if B and int(wl.max()) > PACKED_MAX_WL:
        raise ValueError(f"the packed tier takes wl <= {PACKED_MAX_WL} "
                         f"(got {int(wl.max())})")
    if B % 2:
        def tail(x, fill):
            pad = torch.full((1, *x.shape[1:]), fill, dtype=x.dtype,
                             device=x.device)
            return torch.cat([x, pad])
        reads, refs = tail(reads, 4), tail(refs, 5)
        read_lens, ref_lens, wl = (tail(read_lens, 0), tail(ref_lens, 0),
                                   tail(wl, 0))
    # row 2b is segment 0 of pair b, row 2b + 1 segment 1: a segment's
    # shifts and its scan (which stops at 32) never cross into the other
    best = _row_sweep(reads, read_lens, refs, ref_lens, PACKED_MAX_WL, wl,
                      torch.int32, NEG, match=match, mismatch=mismatch,
                      gap_open=gap_open, gap_extend=gap_extend, clip=clip)
    return _pick_lane(*best)[:B]


def sw_score_batch_ref(reads: torch.Tensor, read_lens: torch.Tensor,
                       refs: torch.Tensor, ref_lens: torch.Tensor,
                       match: int = 1, mismatch: int = 4,
                       gap_open: int = 6, gap_extend: int = 1,
                       clip: int = 5) -> torch.Tensor:
    """Unbanded anti-diagonal sweep over the whole window: lanes are read
    rows 0..m, d = i + j runs 1..m+n.  Line for line
    ema_tpu/ops/sw.py:37-168; returns int32 [B, 4] with qe = the best
    row and ref_end = its d minus its row."""
    B, m = reads.shape
    n = refs.shape[1]
    dev = reads.device
    i32 = torch.int32
    goe = gap_open + gap_extend
    reads = reads.to(i32)
    i_idx = torch.arange(m + 1, dtype=i32, device=dev)[None, :]

    def init(fill):
        return torch.full((B, m + 1), fill, dtype=i32, device=dev)

    H1 = torch.where(i_idx == 0, 0, NEG).to(i32).expand(B, -1).clone()
    H2, V1, D1 = init(NEG), init(NEG), init(NEG)
    S_H1, S_H2, S_V1, S_D1 = init(0), init(0), init(0), init(0)
    bestv, bestd, bests = init(NEG), init(0), init(0)
    read_pad = torch.nn.functional.pad(reads, (1, 0), value=4)
    ref_pad = torch.nn.functional.pad(refs.to(i32), (0, m + 1), value=5)
    rdiag = init(5)
    rlen = read_lens.to(i32)[:, None]
    valid_i = (i_idx >= 1) & (i_idx <= rlen)
    end_adj = torch.where(i_idx == rlen, 0, -clip).to(i32)
    fresh = torch.where(i_idx == 1, 0, -clip).to(i32)
    fresh_sh = i_idx - 1
    nl = ref_lens.to(i32)[:, None]
    neg_col = torch.full((B, 1), NEG, dtype=i32, device=dev)
    zero_col = torch.zeros((B, 1), dtype=i32, device=dev)
    neg_t = torch.tensor(NEG, dtype=i32, device=dev)

    def shift_down(x, fill):
        return torch.cat([fill, x[:, :-1]], dim=1)

    for d in range(1, m + n + 1):
        j_idx = d - i_idx
        valid = valid_i & (j_idx >= 1) & (j_idx <= nl)
        rdiag = shift_down(rdiag, ref_pad[:, d - 1:d])

        v_open = shift_down(H1, neg_col) - goe
        v_ext = shift_down(V1, neg_col) - gap_extend
        V = torch.maximum(v_open, v_ext)
        S_V = torch.where(v_open >= v_ext, shift_down(S_H1, zero_col),
                          shift_down(S_V1, zero_col))

        d_open = H1 - goe
        d_ext = D1 - gap_extend
        D = torch.maximum(d_open, d_ext)
        S_D = torch.where(d_open >= d_ext, S_H1, S_D1)

        H2_up = shift_down(H2, neg_col)
        sub = torch.where((read_pad >= 4) | (rdiag >= 4), -1,
                          torch.where(read_pad == rdiag, match,
                                      -mismatch)).to(i32)
        Hdiag = torch.maximum(H2_up, fresh) + sub
        diag_s = torch.where(H2_up >= fresh, shift_down(S_H2, zero_col),
                             fresh_sh)

        H = torch.maximum(torch.maximum(Hdiag, D), V)
        S_H = torch.where(Hdiag >= torch.maximum(D, V), diag_s,
                          torch.where(D >= V, S_D, S_V))
        H = torch.where(valid, H, neg_t)
        V = torch.where(valid, V, neg_t)
        D = torch.where(valid, D, neg_t)

        cand = torch.where(valid, H + end_adj, neg_t)
        improve = cand > bestv
        bestv = torch.where(improve, cand, bestv)
        bestd = torch.where(improve, d, bestd)
        bests = torch.where(improve, S_H, bests)
        H2, H1, V1, D1 = H1, H, V, D
        S_H2, S_H1, S_V1, S_D1 = S_H1, S_H, S_V, S_D

    # best row; ties at equal score pick the smallest d, then the
    # smallest row (argmax of the first maximum)
    maxv = bestv.max(dim=1, keepdim=True).values
    tie = torch.where(bestv == maxv, (m + n + 1) - bestd, -1)
    bi = tie.argmax(dim=1, keepdim=True)
    bd = bestd.gather(1, bi)[:, 0]
    bs = bests.gather(1, bi)[:, 0]
    bi = bi[:, 0].to(i32)
    return torch.stack([maxv[:, 0], bs, bi, bd - bi], dim=1).to(i32)


def gather_score_ref(text, oriented, olens, owners, win_lo, win_len, wl, *,
                     scorer="banded", match=1, mismatch=4, gap_open=6,
                     gap_extend=1, clip=5) -> torch.Tensor:
    """Plain version of the fused kernels: gather, then the scorer.

    Read rows come by owner; window columns outside [0, n) read the
    sentinel 5 (ema_tpu/core/pipeline.py:95-109).  The banded band is the
    widest corridor of the call; ``wl`` makes the result independent of
    it.  ``scan`` ignores ``wl`` and scores the whole window, as
    pipeline.py:124-126 does.
    """
    if scorer not in KERNEL_OF:
        raise ValueError(f"gather_score: unknown scorer {scorer!r}")
    N = owners.shape[0]
    dev = text.device
    if N == 0:
        return torch.zeros((0, 4), dtype=torch.int32, device=dev)
    n = text.shape[0]
    owners = owners.long()
    reads = oriented[owners].to(torch.int32)
    rlens = olens[owners]
    w_max = int(win_len.max())
    cols = win_lo.long()[:, None] + torch.arange(w_max, device=dev)[None, :]
    gathered = text[cols.clamp(0, n - 1)].to(torch.int32)
    wins = torch.where((cols < 0) | (cols >= n), 5, gathered)
    kw = dict(match=match, mismatch=mismatch, gap_open=gap_open,
              gap_extend=gap_extend, clip=clip)
    if scorer == "scan":
        return sw_score_batch_ref(reads, rlens, wins, win_len, **kw)
    if scorer == "packed":
        return sw_score_banded_packed_ref(reads, rlens, wins, win_len, wl,
                                          **kw)
    fn = sw_score_banded16_ref if scorer == "banded16" else \
        sw_score_banded_ref
    return fn(reads, rlens, wins, win_len, max(int(wl.max()), 1), wl=wl,
              **kw)


def _check(name, t, dtype, ndim, dev):
    if t.dtype != dtype or t.dim() != ndim or t.device != dev:
        raise ValueError(f"gather_score: {name} must be a {ndim}-d {dtype} "
                         f"tensor on {dev} (got {t.dim()}-d {t.dtype} on "
                         f"{t.device})")


# Upper corridor widths of the width classes of sw_banded and sw_banded16
# (the tables in csrc/sw_banded.cu and csrc/sw_banded16.cu, which also
# pick each class's thread form from the call's size).  The usual chained
# corridor is 2 x 24 + 2 lanes plus the
# chain's diagonal spread, 50 to about 60 with small indels: one class
# holds 33..64, so such a call stays one class.  96 splits the 65..128
# range, whose narrow half runs faster on 16 threads x 6 lanes than on a
# whole warp.
BANDED_CLASS_EDGES = (32, 64, 96, 128, 256, 512, 768, 1024, 2048, 4096)
# A call that spans several classes is sorted only where that pays: the
# sort (class sizes read back, bucketize, a stable argsort) costs about as
# much as the kernel takes for a few thousand chained candidates, so it
# must save at least this many lane slots (candidates x class edge)
# against one launch of the whole call at its widest class.
SORT_PAYS_SLOTS = 1 << 20


def _edges_on(wl: torch.Tensor, edges) -> torch.Tensor:
    return torch.as_tensor(edges, dtype=wl.dtype, device=wl.device)


def class_counts(wl: torch.Tensor, edges=BANDED_CLASS_EDGES) -> torch.Tensor:
    """Sizes of the corridor-width classes of ``wl``, int64 [len(edges)]
    on ``wl``'s device, with no host synchronisation: class ``i`` holds
    the candidates with ``edges[i-1] < wl <= edges[i]``.  A ``wl`` past
    ``edges[-1]`` is in no class (the caller refuses it).  ``edges`` may
    be a tensor on ``wl``'s device already."""
    below = (wl[:, None] <= _edges_on(wl, edges)[None, :]).sum(dim=0)
    return torch.diff(below, prepend=below.new_zeros(1))


def class_permutation(wl: torch.Tensor,
                      edges=BANDED_CLASS_EDGES) -> torch.Tensor:
    """int32 [N]: the candidates listed class by class, in the caller's
    order within a class (a stable sort on one-byte class ids), so class
    ``i`` is the span of ``class_counts(wl)[i]`` entries after those of
    the classes below."""
    cls = torch.bucketize(wl, _edges_on(wl, edges)).to(torch.uint8)
    return torch.argsort(cls, stable=True).to(torch.int32)


def class_spans(counts, edges=BANDED_CLASS_EDGES) -> list:
    """``(edge, offset, n)`` of each non-empty class, from the class
    sizes read back to the host: one kernel launch each."""
    spans, off = [], 0
    for edge, n in zip(edges, counts):
        if n:
            spans.append((edge, off, int(n)))
        off += int(n)
    return spans


def plan_class_launches(wl: torch.Tensor, w_lo: int, w_hi: int,
                        edges=BANDED_CLASS_EDGES, sort_pays=None):
    """``(perm, spans)`` for a call whose corridors span ``[w_lo, w_hi]``
    (read back already, with the bounds check).  When both ends fall in
    one class, as in the pipeline's usual chained or rescue call, that is
    one span over the caller's own order and no permutation (None): no
    sort, no second readback.  Otherwise the class sizes are read back;
    if launching class by class saves fewer than ``sort_pays`` lane slots
    (SORT_PAYS_SLOTS) against one launch at the widest class, the call
    stays one unsorted span at that class, else the candidates are sorted
    on the device."""
    if sort_pays is None:
        sort_pays = SORT_PAYS_SLOTS
    lo, hi = bisect.bisect_left(edges, w_lo), bisect.bisect_left(edges, w_hi)
    N = wl.shape[0]
    if lo == hi:
        return None, [(edges[hi], 0, N)]
    e = _edges_on(wl, edges)            # one upload for both
    spans = class_spans(class_counts(wl, e).tolist(), edges)
    if N * edges[hi] - sum(edge * n for edge, _, n in spans) < sort_pays:
        return None, [(edges[hi], 0, N)]
    return class_permutation(wl, e), spans


def gather_score_by_class_ref(text, oriented, olens, owners, win_lo,
                              win_len, wl, *, edges=BANDED_CLASS_EDGES,
                              sort_pays=None, **kw) -> torch.Tensor:
    """Plain version of the class launches of sw_banded and sw_banded16
    (``scorer`` in ``kw``): the candidates go
    through ``plan_class_launches`` as the kernel's do, each class is
    scored by ``gather_score_ref`` on its own, and row ``perm[c]`` of the
    result takes slot ``c``'s output, so the result is in the caller's
    order and equals one ``gather_score_ref`` call."""
    N = owners.shape[0]
    out = torch.empty((N, 4), dtype=torch.int32, device=text.device)
    if N == 0:
        return out
    perm, spans = plan_class_launches(wl, int(wl.min()), int(wl.max()),
                                      edges, sort_pays)
    perm = (torch.arange(N, device=text.device) if perm is None
            else perm.long())
    for _, off, n in spans:
        idx = perm[off:off + n]
        out[idx] = gather_score_ref(text, oriented, olens, owners[idx],
                                    win_lo[idx], win_len[idx], wl[idx], **kw)
    return out


def _plan_kernel(text, oriented, olens, owners, win_lo, win_len, wl, *,
                 scorer, match=1, mismatch=4, gap_open=6, gap_extend=1,
                 clip=5, group=0):
    """``(out, launch)`` for CUDA tensors: the checks, the one readback of
    the bounds the kernel trusts and the plan of the scorer's launches are
    made here; ``launch()`` queues the kernel launches that fill ``out``
    (int32 [N, 4]) on the current stream, adds them to ``LAUNCHES`` and may
    be called again.  ``gather_score`` is ``_plan_kernel`` then
    ``launch()``.  chip_smoke.py times ``launch`` alone, without the plan's
    readback, and passes ``group`` (one of ``FORM_GROUPS[scorer]``) to
    time one thread form against the other; 0 leaves the choice to the
    launch, and nothing else passes another value."""
    from ema_tpu_torch.ops import _build

    name = KERNEL_OF[scorer]
    dev = text.device
    N = owners.shape[0]
    R, L = oriented.shape
    lib = _build.load_library(name)
    out = torch.empty((N, 4), dtype=torch.int32, device=dev)
    if N == 0:
        return out, lambda: None
    _check_read_len(L)
    owners = owners.to(torch.int32).contiguous()
    win_lo = win_lo.to(torch.int64).contiguous()
    win_len = win_len.to(torch.int32).contiguous()
    wl = wl.to(torch.int32).contiguous()
    oriented = oriented.contiguous()
    olens = olens.to(torch.int32).contiguous()
    # bounds the kernel trusts: one readback, checked here, on the host,
    # before launch
    host = [*torch.aminmax(owners)]
    if scorer == "scan":           # scores the whole window: wl unread
        host.append(olens.max())   # the longest read picks the thread form
    else:
        max_wl = lib.max_wl()
        host += torch.aminmax(wl)
    host = torch.stack(host).tolist()
    o_lo, o_hi = host[:2]
    if o_lo < 0 or o_hi >= R:
        raise ValueError(f"gather_score: owners out of range [0, {R})")
    if scorer == "scan":
        max_rl = min(max(host[2], 0), L)
    else:
        w_lo, w_hi = host[2:4]
        if w_lo < 1 or w_hi > max_wl:
            raise ValueError(f"gather_score: wl must lie in [1, {max_wl}] "
                             f"for the {name} kernel (got [{w_lo}, "
                             f"{w_hi}])")
        if scorer == "banded16":
            _check_int16_range(L, w_hi, match, mismatch, gap_open,
                               gap_extend, clip)
    if group and group not in FORM_GROUPS.get(scorer, ()):
        raise ValueError(f"gather_score: {name} takes no thread form of "
                         f"{group} threads")
    perm = None
    if scorer in ("banded", "banded16"):
        # one launch per non-empty width class, each on its span of the
        # permutation (the kernel writes out[perm[slot]])
        perm, spans = plan_class_launches(wl, w_lo, w_hi)
        perm_ptr = None if perm is None else perm.data_ptr()
        launches = [(perm_ptr, off, n, edge, group)
                    for edge, off, n in spans]
    elif scorer == "scan":
        launches = [(N, max_rl, group)]
    else:
        launches = [(N, w_hi, group)]
    # the tensors whose pointers the launches carry stay alive with it
    read = (text, oriented, olens, owners, win_lo, win_len, wl)
    if perm is not None:
        read += (perm,)
    held = (read, (out,))
    head = (text.data_ptr(), text.shape[0], oriented.data_ptr(), L,
            olens.data_ptr(), owners.data_ptr(), win_lo.data_ptr(),
            win_len.data_ptr(), wl.data_ptr())
    tail = (match, mismatch, gap_open, gap_extend, clip, out.data_ptr())

    def launch(_held=held) -> None:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            for args in launches:
                rc = lib.launch(*head, *args, *tail, stream)
                if rc != 0:
                    raise RuntimeError(f"{name} kernel launch failed: CUDA "
                                       f"error {rc}")
                LAUNCHES[name].add()
                for observe in LAUNCH_OBSERVERS:
                    observe(name, stream, *_held)

    return out, launch


def gather_score(text, oriented, olens, owners, win_lo, win_len, wl, *,
                 scorer="banded", match=1, mismatch=4, gap_open=6,
                 gap_extend=1, clip=5) -> torch.Tensor:
    """Score candidates; int32 [N, 4] = (score, qb, qe, ref_end).

    text uint8 [n] (2-bit codes), oriented uint8 [R, L], olens int32 [R];
    owners int32 [N], win_lo int64 [N], win_len int32 [N], wl int32 [N],
    all on one device.  ``scorer`` is one of banded, banded16, packed
    (wl <= 64) or scan (wl ignored).  CUDA: the scorer's kernel; CPU: its
    plain version.  banded and scan take any int32 scoring (scan while
    no score nears the sentinel, ``_check_int32_range``): their kernels
    switch to the mask form of the lookup past a signed byte.  Under
    banded16 and packed ``match`` and ``mismatch`` must lie within +-127 on
    either device: their kernels look the substitution score up as a
    signed byte, and a scoring past it gains nothing there, since on reads
    over 64 bp it already leaves the int16 range (``_check_int16_range``)
    or the JAX pair-packed kernel's own key range (m * match + 64 *
    gap_extend < 8191, ema_tpu/ops/sw_pallas.py:743-744).
    """
    if scorer not in KERNEL_OF:
        raise ValueError(f"gather_score: unknown scorer {scorer!r} (one of "
                         f"{', '.join(KERNEL_OF)})")
    dev = text.device
    _check("text", text, torch.uint8, 1, dev)
    _check("oriented", oriented, torch.uint8, 2, dev)
    _check("olens", olens, torch.int32, 1, dev)
    _check("owners", owners, torch.int32, 1, dev)
    _check("win_lo", win_lo, torch.int64, 1, dev)
    _check("win_len", win_len, torch.int32, 1, dev)
    _check("wl", wl, torch.int32, 1, dev)
    kw = dict(scorer=scorer, match=match, mismatch=mismatch,
              gap_open=gap_open, gap_extend=gap_extend, clip=clip)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"gather_score: unsupported device {dev}")
    if scorer in ("banded16", "packed"):
        _check_byte_scores(KERNEL_OF[scorer], match, mismatch)
    elif scorer == "scan":
        _check_int32_range(oriented.shape[1], match, mismatch, gap_open,
                           gap_extend, clip)
    CALLS[scorer].add()
    if dev.type == "cuda":
        out, launch = _plan_kernel(text, oriented, olens, owners, win_lo,
                                   win_len, wl, **kw)
        launch()
        return out
    return gather_score_ref(text, oriented, olens, owners, win_lo,
                            win_len, wl, **kw)
