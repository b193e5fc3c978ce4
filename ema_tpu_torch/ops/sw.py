"""Banded Smith-Waterman scoring: the CUDA kernel's wrapper and its plain
PyTorch version.

``gather_score`` is what the Aligner calls: for candidate b it scores
oriented read ``owners[b]`` against the text window
``[win_lo[b], win_lo[b] + win_len[b])`` inside the diagonal corridor
``k < wl[b]``, and returns int32 [N, 4] columns (score, qb, qe, ref_end).
On CUDA tensors it launches the hand-written kernel
(``csrc/sw_banded.cu``, the port of ema_tpu/ops/sw_pallas.py:
_banded_kernel with the gather of ema_tpu/core/pipeline.py:_gather_score
fused in); on CPU tensors it runs the plain version.  A CUDA tensor never
runs the plain version, and a failed build or launch raises.

The plain versions follow the JAX package exactly:
``sw_score_banded_ref`` is ema_tpu/ops/sw.py:sw_score_banded (the same
recurrences, log-step max-plus scan and tie rules) and
``gather_score_ref`` adds the window gather of pipeline.py:95-109
(columns outside the text read the sentinel 5; win_lo may be negative).
"""

from __future__ import annotations

import threading

import torch

NEG = -(1 << 28)


class LaunchCounter:
    """Thread-safe count of kernel launches (chunks score on a thread
    pool, so a bare ``+= 1`` could lose updates)."""

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


# launches of the sw_banded kernel by gather_score
SW_LAUNCHES = LaunchCounter()


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
    B, m = reads.shape
    W = int(w_band)
    if m >= 1024:
        raise ValueError(f"banded SW tie-break packing requires read "
                         f"length < 1024 (got m={m})")
    dev = reads.device
    i32 = torch.int32
    goe = gap_open + gap_extend
    reads = reads.to(i32)
    k_idx = torch.arange(W, dtype=i32, device=dev)[None, :]
    rl = read_lens.to(i32)[:, None]
    nl = ref_lens.to(i32)[:, None]
    kmask = k_idx < wl.to(i32)[:, None]
    ref_pad = torch.nn.functional.pad(refs.to(i32), (0, m + W), value=5)

    def full(fill, cols=W):
        return torch.full((B, cols), fill, dtype=i32, device=dev)

    def shift_left(x, fill):
        return torch.cat([x[:, 1:], full(fill, 1)], dim=1)

    def shift_right(x, s, fill):
        return torch.cat([full(fill, s), x[:, :-s]], dim=1)

    ke = k_idx * gap_extend
    # int32 scalars: a where() of two Python scalars would widen to int64
    match_t = torch.tensor(match, dtype=i32, device=dev)
    zero_t = torch.tensor(0, dtype=i32, device=dev)
    Hp, Fp, SHp, SFp = full(NEG), full(NEG), full(0), full(0)
    bestv, besti, bests = full(NEG), full(0), full(0)
    for i in range(1, m + 1):
        ref_row = ref_pad[:, i - 1:i - 1 + W]
        read_col = reads[:, i - 1:i]
        valid = (i <= rl) & (i + k_idx <= nl) & kmask

        sub = torch.where((read_col >= 4) | (ref_row >= 4), -1,
                          torch.where(read_col == ref_row, match_t,
                                      -mismatch))
        fresh = 0 if i == 1 else -clip
        Hd = torch.clamp(Hp, min=fresh) + sub
        Sd = torch.where(Hp >= fresh, SHp, i - 1)

        f_open = shift_left(Hp, NEG) - goe
        f_ext = shift_left(Fp, NEG) - gap_extend
        F = torch.maximum(f_open, f_ext)
        SF = torch.where(f_open >= f_ext, shift_left(SHp, 0),
                         shift_left(SFp, 0))

        # horizontal gaps: exclusive max-plus prefix scan over the row;
        # ties keep the nearer source (strict > takes the farther one)
        H0 = torch.maximum(Hd, F)
        S0 = torch.where(Hd >= F, Sd, SF)
        A = torch.where(valid, H0 + ke, NEG)
        P = shift_right(A, 1, NEG)
        PS = shift_right(S0, 1, 0)
        s = 1
        while s < W:
            P2 = shift_right(P, s, NEG)
            PS2 = shift_right(PS, s, 0)
            PS = torch.where(P2 > P, PS2, PS)
            P = torch.maximum(P, P2)
            s *= 2
        E = P - ke - gap_open
        # merge with the reference tie priority: diag >= horizontal >= vert
        H = torch.maximum(H0, E)
        SH = torch.where(Hd >= torch.maximum(E, F), Sd,
                         torch.where(E >= F, PS, SF))
        H = torch.where(valid, H, NEG)
        F = torch.where(valid, F, NEG)

        end_adj = torch.where(rl == i, zero_t, -clip)
        cand = torch.where(valid, H + end_adj, NEG)
        improve = cand > bestv
        bestv = torch.where(improve, cand, bestv)
        besti = torch.where(improve, i, besti)
        bests = torch.where(improve, SH, bests)
        Hp, Fp, SHp, SFp = H, F, SH, SF

    # best lane; ties minimise d = 2i + k, then i
    maxv = bestv.max(dim=1, keepdim=True).values
    d_key = (2 * besti + k_idx) * 1024 + besti
    key = torch.where(bestv == maxv, d_key, 1 << 30)
    bk = key.argmin(dim=1, keepdim=True)
    bi = besti.gather(1, bk)[:, 0]
    bs = bests.gather(1, bk)[:, 0]
    return torch.stack([maxv[:, 0], bs, bi, bi + bk[:, 0].to(i32)],
                       dim=1).to(i32)


def gather_score_ref(text, oriented, olens, owners, win_lo, win_len, wl, *,
                     match=1, mismatch=4, gap_open=6, gap_extend=1,
                     clip=5) -> torch.Tensor:
    """Plain version of the fused kernel: gather, then the row sweep.

    Read rows come by owner; window columns outside [0, n) read the
    sentinel 5 (ema_tpu/core/pipeline.py:95-109).  The band is the widest
    corridor of the call; ``wl`` makes the result independent of it.
    """
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
    return sw_score_banded_ref(reads, rlens, wins, win_len,
                               max(int(wl.max()), 1), match=match,
                               mismatch=mismatch, gap_open=gap_open,
                               gap_extend=gap_extend, clip=clip, wl=wl)


def _check(name, t, dtype, ndim, dev):
    if t.dtype != dtype or t.dim() != ndim or t.device != dev:
        raise ValueError(f"gather_score: {name} must be a {ndim}-d {dtype} "
                         f"tensor on {dev} (got {t.dim()}-d {t.dtype} on "
                         f"{t.device})")


def _launch_kernel(text, oriented, olens, owners, win_lo, win_len, wl, *,
                   match, mismatch, gap_open, gap_extend, clip):
    from ema_tpu_torch.ops import _build

    dev = text.device
    N = owners.shape[0]
    R, L = oriented.shape
    lib = _build.load_library()
    out = torch.empty((N, 4), dtype=torch.int32, device=dev)
    if N == 0:
        return out
    if L >= 1024:
        raise ValueError(f"banded SW tie-break packing requires read "
                         f"length < 1024 (got L={L})")
    owners = owners.to(torch.int32).contiguous()
    win_lo = win_lo.to(torch.int64).contiguous()
    win_len = win_len.to(torch.int32).contiguous()
    wl = wl.to(torch.int32).contiguous()
    oriented = oriented.contiguous()
    olens = olens.to(torch.int32).contiguous()
    # bounds the kernel trusts: checked here, on the host, before launch
    w_lo, w_hi = (int(v) for v in torch.aminmax(wl))
    o_lo, o_hi = (int(v) for v in torch.aminmax(owners))
    max_wl = lib.sw_banded_max_wl()
    if w_lo < 1 or w_hi > max_wl:
        raise ValueError(f"gather_score: wl must lie in [1, {max_wl}] for "
                         f"the sw_banded kernel (got [{w_lo}, {w_hi}])")
    if o_lo < 0 or o_hi >= R:
        raise ValueError(f"gather_score: owners out of range [0, {R})")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.sw_banded_launch(
            text.data_ptr(), text.shape[0], oriented.data_ptr(), L,
            olens.data_ptr(), owners.data_ptr(), win_lo.data_ptr(),
            win_len.data_ptr(), wl.data_ptr(), N, w_hi, match, mismatch,
            gap_open, gap_extend, clip, out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"sw_banded kernel launch failed: CUDA error "
                           f"{rc}")
    SW_LAUNCHES.add()
    return out


def gather_score(text, oriented, olens, owners, win_lo, win_len, wl, *,
                 match=1, mismatch=4, gap_open=6, gap_extend=1,
                 clip=5) -> torch.Tensor:
    """Score candidates; int32 [N, 4] = (score, qb, qe, ref_end).

    text uint8 [n] (2-bit codes), oriented uint8 [R, L], olens int32 [R];
    owners int32 [N], win_lo int64 [N], win_len int32 [N], wl int32 [N],
    all on one device.  CUDA: the sw_banded kernel; CPU: the plain
    version.
    """
    dev = text.device
    _check("text", text, torch.uint8, 1, dev)
    _check("oriented", oriented, torch.uint8, 2, dev)
    _check("olens", olens, torch.int32, 1, dev)
    _check("owners", owners, torch.int32, 1, dev)
    _check("win_lo", win_lo, torch.int64, 1, dev)
    _check("win_len", win_len, torch.int32, 1, dev)
    _check("wl", wl, torch.int32, 1, dev)
    kw = dict(match=match, mismatch=mismatch, gap_open=gap_open,
              gap_extend=gap_extend, clip=clip)
    if dev.type == "cuda":
        return _launch_kernel(text, oriented, olens, owners, win_lo,
                              win_len, wl, **kw)
    if dev.type == "cpu":
        return gather_score_ref(text, oriented, olens, owners, win_lo,
                                win_len, wl, **kw)
    raise ValueError(f"gather_score: unsupported device {dev}")
