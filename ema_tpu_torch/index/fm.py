"""Batched FM-index operations in torch, on the index's device.

The counterpart of ema_tpu/index/fmindex.py: ``rank`` is one occ-block
row gather plus 2-bit equality popcounts per query; ``seed_reads`` is the
greedy maximal-suffix chop as a loop over read positions (right to left)
carrying one SA interval per read; ``locate`` the fixed sa_rate - 1 step
LF walk to the nearest value-sampled row; ``seed_locate_reads`` fuses the
seeding, the hit compaction and the locate.

Every output equals the JAX package's bit for bit.  What differs inside:

  - the packed words (occ words, ``sa_mark_words``) are stored as int32
    and widened to int64 masked to 32 bits where they are gathered, so
    every shift is a logical one (torch has no uint32 arithmetic, and
    ``>>`` on int32 is arithmetic);
  - popcounts are SWAR bit arithmetic (torch has no popcount);
  - rows, counts and the hit sampling are int64: ``(i * w) // t`` cannot
    overflow, where the JAX package splits it to stay in int32;
  - gather indices that JAX would clamp (lookups whose result is masked
    off) are clamped here too: an out-of-range index is an error in torch.
"""

from __future__ import annotations

import dataclasses

import torch

I64 = torch.int64
M32 = 0xFFFFFFFF
M55 = 0x55555555


@dataclasses.dataclass(frozen=True)
class FMIndexArrays:
    """The FM-index on a torch device (see ema_tpu.index.build.
    ReferenceIndex; fmindex.FMIndexArrays)."""

    occ_blocks: torch.Tensor     # int32 [n_blocks, 12]
    counts: torch.Tensor         # int64 [5]
    sa_mark_words: torch.Tensor  # int32 [n_words]: the uint32 bitmap's bits
    sa_mark_rank: torch.Tensor   # int32 [n_words] marked rows before a word
    sa_values: torch.Tensor      # int32 [n_marked] SA values of marked rows
    primary: int
    sa_rate: int
    n: int                       # FM text length (both strands)

    @classmethod
    def from_index(cls, idx, device) -> "FMIndexArrays":
        def put(a, dtype=None):
            t = torch.from_numpy(a)
            return t.to(device=device, dtype=dtype).contiguous()

        return cls(
            occ_blocks=put(idx.occ_blocks, torch.int32),
            counts=put(idx.counts, I64),
            sa_mark_words=put(idx.sa_mark_words.view("int32")),
            sa_mark_rank=put(idx.sa_mark_rank, torch.int32),
            sa_values=put(idx.sa_values, torch.int32),
            primary=int(idx.primary), sa_rate=int(idx.sa_rate),
            n=int(idx.fm_n))

    def to(self, device) -> "FMIndexArrays":
        """The same arrays on ``device`` (self where they are there)."""
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})


def _u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bits -> int64 in [0, 2^32)."""
    return x.to(I64) & M32


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of int64 values in [0, 2^32) (SWAR)."""
    x = x - ((x >> 1) & M55)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = x + (x >> 8)
    return (x + (x >> 16)) & 0x3F


def rank(fm: FMIndexArrays, c: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """occ(c, k): occurrences of char c in the first k rows of the full
    BWT (fmindex.rank).  c, k: broadcastable integer tensors; valid for
    0 <= k <= n + 1.  Returns int64."""
    c, k = torch.broadcast_tensors(c.to(I64), k.to(I64))
    adj = k - (k > fm.primary).to(I64)
    blk = adj >> 7
    off = adj & 127
    row = fm.occ_blocks[blk]                                   # [..., 12]
    base = torch.gather(row[..., :4], -1, c[..., None])[..., 0].to(I64)
    x = _u32(row[..., 4:12]) ^ (c * M55)[..., None]             # [..., 8]
    eq = ~(x | (x >> 1)) & M55          # one bit per base equal to c
    # keep the bases strictly before ``off`` within the block
    nbase = (off[..., None] - 16 * torch.arange(8, device=k.device)
             ).clamp(0, 16)
    wordmask = torch.where(nbase >= 16, M32, (1 << (2 * nbase)) - 1)
    return base + _popcount32(eq & wordmask).sum(dim=-1)


def extend_backward(fm: FMIndexArrays, lo, hi, c):
    """One backward-search step: prepend char c to the pattern whose
    half-open SA-row interval is (lo, hi) (fmindex.extend_backward)."""
    cc = fm.counts[c.long()]
    return cc + rank(fm, c, lo), cc + rank(fm, c, hi)


def seed_reads(fm: FMIndexArrays, reads: torch.Tensor, lens: torch.Tensor,
               max_seeds: int = 16, min_seed_len: int = 19):
    """Greedy maximal-suffix seeding over a batch of reads
    (fmindex.seed_reads).

    reads: integer [B, L] base codes (0-3; >= 4 = N, breaks seeds); lens
    [B].  Scans right to left; at each step extends the current interval
    by the next char, and on failure emits the current seed (if long
    enough) and restarts at that char.  Returns int32 [B, max_seeds]
    seed_lo, seed_hi (SA-row interval), seed_qb (read offset of the seed
    start), seed_len, and int32 [B] seed counts.
    """
    B, L = reads.shape
    dev = reads.device
    reads = reads.to(I64)
    lens = lens.to(I64)
    b_idx = torch.arange(B, device=dev)
    zero = torch.zeros(B, dtype=I64, device=dev)
    lo, hi, span, n_seeds = zero, zero, zero, zero
    seeds = torch.zeros((4, B, max_seeds), dtype=I64, device=dev)

    def put(emit, vals) -> None:
        """seeds[:, b, n_seeds[b]] = vals[:, b] where emit[b]."""
        slot = n_seeds.clamp(max=max_seeds - 1)
        cur = seeds[:, b_idx, slot]
        seeds[:, b_idx, slot] = torch.where(emit, vals, cur)

    for t in range(L):
        pos = lens - 1 - t                  # per-read position, right-aligned
        active = pos >= 0
        c = torch.where(active,
                        reads[b_idx, pos.clamp(0, L - 1)], 4)
        valid_c = c < 4
        c_safe = torch.where(valid_c, c, 0)

        has_interval = span > 0
        nlo, nhi = extend_backward(fm, lo, hi, c_safe)
        ext_ok = valid_c & has_interval & (nhi > nlo)
        # a fresh interval for restarts
        flo = torch.where(valid_c, fm.counts[c_safe], 0)
        fhi = torch.where(valid_c, fm.counts[c_safe + 1], 0)
        fresh_ok = valid_c & (fhi > flo)

        # emit the previous seed when the extension fails while a seed is
        # live
        emit = (active & has_interval & ~ext_ok & (span >= min_seed_len)
                & (n_seeds < max_seeds))
        put(emit, torch.stack([lo, hi, pos + 1, span]))
        n_seeds = n_seeds + emit.to(I64)

        keep = ~active
        lo = torch.where(keep, lo, torch.where(
            ext_ok, nlo, torch.where(fresh_ok, flo, 0)))
        hi = torch.where(keep, hi, torch.where(
            ext_ok, nhi, torch.where(fresh_ok, fhi, 0)))
        span = torch.where(keep, span, torch.where(
            ext_ok, span + 1, torch.where(fresh_ok, 1, 0)))

    # final flush: emit the live seed at the read start
    emit = (span >= min_seed_len) & (n_seeds < max_seeds)
    put(emit, torch.stack([lo, hi, zero, span]))
    n_seeds = n_seeds + emit.to(I64)
    s = seeds.to(torch.int32)
    return s[0], s[1], s[2], s[3], n_seeds.to(torch.int32)


def _is_marked(fm: FMIndexArrays, rows: torch.Tensor) -> torch.Tensor:
    w = _u32(fm.sa_mark_words[rows >> 5])
    return ((w >> (rows & 31)) & 1) != 0


def _marked_value(fm: FMIndexArrays, rows: torch.Tensor) -> torch.Tensor:
    """SA value of a *marked* row via the bitmap rank into sa_values (for
    other rows the index is clamped and the value meaningless)."""
    wi = rows >> 5
    below = _u32(fm.sa_mark_words[wi]) & ((1 << (rows & 31)) - 1)
    idx = fm.sa_mark_rank[wi].to(I64) + _popcount32(below)
    return fm.sa_values[idx.clamp(0, fm.sa_values.shape[0] - 1)].to(I64)


def locate(fm: FMIndexArrays, rows: torch.Tensor) -> torch.Tensor:
    """Batched SA lookup: BWT rows -> text positions by the LF walk
    (fmindex.locate).  rows: integer [...], each in [0, n]; int64 out.

    Each LF step decrements the SA value by one, so a row whose value is
    divisible by sa_rate is reached within sa_rate - 1 steps.
    """
    rows = rows.to(I64)
    steps = torch.zeros_like(rows)
    done = _is_marked(fm, rows)
    val = torch.where(done, _marked_value(fm, rows), 0)
    for _ in range(fm.sa_rate - 1):
        # BWT char of the current row (marked rows, the $ row among them,
        # are already done)
        adj = rows - (rows > fm.primary).to(I64)
        blk, off = adj >> 7, adj & 127
        w = _u32(fm.occ_blocks[blk, 4 + (off >> 4)])
        ch = (w >> (2 * (off & 15))) & 3
        nrows = torch.where(done, rows, fm.counts[ch] + rank(fm, ch, rows))
        steps = torch.where(done, steps, steps + 1)
        fresh = ~done & _is_marked(fm, nrows)
        val = torch.where(fresh, _marked_value(fm, nrows) + steps, val)
        rows, done = nrows, done | fresh
    return val


def expand_seed_hits(s_lo: torch.Tensor, s_hi: torch.Tensor, max_hits: int):
    """Expand SA intervals into up to ``max_hits`` rows each, evenly
    sampled past the cap (fmindex.expand_seed_hits; BWA's max_occ capping,
    src/align.c:185).  Returns (rows [..., max_hits], valid mask); rows
    are int64 and the sampling ``(i * width) // max_hits`` is exact."""
    width = (s_hi.to(I64) - s_lo.to(I64))[..., None]
    i = torch.arange(max_hits, device=s_lo.device)
    idx = torch.where(width > max_hits, (i * width) // max_hits, i)
    valid = i < width.clamp(max=max_hits)
    return torch.where(valid, s_lo.to(I64)[..., None] + idx, 0), valid


def seed_locate_reads(fm: FMIndexArrays, reads: torch.Tensor,
                      lens: torch.Tensor, *, max_seeds: int = 16,
                      min_seed_len: int = 19, max_hits: int = 3000,
                      budget: int = 32768, max_occ: int = 3000):
    """Greedy seeding -> hit compaction -> SA locate in one call on the
    device (fmindex.seed_locate_reads).

    The compaction (a prefix sum over the per-seed hit counts, then
    searchsorted, with the even max_occ sampling) equals the host
    ``_compact_seed_hits`` value for value.  Returns (packed int32
    [4, budget] = (owner, qb, seed_len, text_pos), total hits as an int64
    scalar tensor, frac_rep float32 [B]).  Slots >= total hold what the
    JAX program puts there; when total > budget the caller takes the
    two-step path (seed_reads, host compaction, locate).
    """
    B, L = reads.shape
    dev = reads.device
    s_lo, s_hi, s_qb, s_len, n_seeds = seed_reads(
        fm, reads, lens, max_seeds=max_seeds, min_seed_len=min_seed_len)
    S = max_seeds
    s_lo, s_hi, s_qb, s_len = (a.to(I64) for a in (s_lo, s_hi, s_qb, s_len))
    live = torch.arange(S, device=dev)[None, :] < n_seeds[:, None]
    width = torch.where(live, (s_hi - s_lo).clamp(min=0), 0)

    # BWA frac_rep: the share of read bases covered by over-max_occ seeds
    # (greedy seeds are disjoint in read coordinates; clipped all the same)
    l_rep = torch.where(width > max_occ, s_len, 0).sum(dim=1)
    frac_rep = (l_rep.to(torch.float64)
                / lens.to(I64).clamp(min=1)).clamp(max=1.0).to(torch.float32)

    if B * S == 0:
        return (torch.zeros((4, budget), dtype=torch.int32, device=dev),
                torch.zeros((), dtype=I64, device=dev), frac_rep)
    take = width.clamp(max=max_hits).reshape(-1)                 # [B*S]
    offs = torch.cumsum(take, 0)                                 # inclusive
    total = offs[-1]
    h = torch.arange(budget, device=dev)
    src = torch.searchsorted(offs, h, right=True).clamp(max=B * S - 1)
    start = offs[src] - take[src]
    i_loc = h - start
    w = width.reshape(-1)[src]
    t = take[src].clamp(min=1)
    rows = s_lo.reshape(-1)[src] + torch.where(w > t, (i_loc * w) // t, i_loc)
    rows = torch.where(h < total, rows, 0)
    pos = locate(fm, rows)
    packed = torch.stack([src // S, s_qb.reshape(-1)[src],
                          s_len.reshape(-1)[src], pos]).to(torch.int32)
    return packed, total, frac_rep
