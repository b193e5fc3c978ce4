"""sw_banded's launch by corridor-width class, on the CPU.

The CUDA kernel cannot run here, so two things are held instead:

* the host side of ``ops/sw._plan_kernel``: ``plan_class_launches``
  (one span and no sort when the call's corridors fall in one class, or
  when a sort would save too few lane slots to pay; else
  ``class_counts``, ``class_spans`` and the device sort
  ``class_permutation``) and the scatter-back, driven with the plain
  version in place of the kernel (``gather_score_by_class_ref``), against one
  ``gather_score_ref`` call and against the JAX package's ``_gather_score``;
* every form of ``csrc/sw_banded.cu``'s launch table (8-, 16- and
  32-thread segments, and 2 to 16 warps a candidate), in both forms of
  its substitution lookups (byte scores, and any other int32 scoring):
  ``emulate_banded``, a numpy emulation of the one-pass kernel body,
  thread by thread, shuffle by shuffle and warp by warp, against
  ``sw_score_banded_ref`` through the gather, on the tie sets of
  chip_smoke.py (``TIE_SETS``, and ``WARP_TIE_SET``, which the carry
  between warps decides) and against the JAX package's banded Pallas
  kernel in interpret mode; and ``gather_score(scorer="banded")`` with
  scores past a byte against the JAX package's gather.

All comparisons are exact (int32).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import (TIE_SETS, WARP_TIE_SET, cand_inputs, tie_batch,
                        warp_tie_batch)
from ema_tpu.core.pipeline import _gather_score
from ema_tpu.ops.sw_pallas import sw_score_banded_pallas
from ema_tpu_torch.ops.sw import (BANDED_CLASS_EDGES, NEG,
                                  SORT_PAYS_SLOTS, class_counts,
                                  class_permutation, class_spans,
                                  gather_score, gather_score_by_class_ref,
                                  gather_score_ref, plan_class_launches)

SW = dict(match=1, mismatch=4, gap_open=6, gap_extend=1, clip=5)


def _inputs(rng, wl, L=48):
    """gather_score inputs for the corridors ``wl``: reads planted in a
    random text, windows around their origin."""
    N = len(wl)
    n, R = 6000, 24
    text = rng.integers(0, 4, n).astype(np.uint8)
    pos = rng.integers(100, n - 3000, R)
    olens = rng.integers(20, L + 1, R).astype(np.int32)
    oriented = np.full((R, L), 4, np.uint8)
    for r in range(R):
        seg = text[pos[r]:pos[r] + olens[r]].copy()
        mut = rng.random(olens[r]) < 0.05
        seg[mut] = rng.integers(0, 4, int(mut.sum()))
        oriented[r, :olens[r]] = seg
    owners = rng.integers(0, R, N).astype(np.int32)
    wl = np.asarray(wl, np.int32)
    win_lo = (pos[owners] - rng.integers(0, 30, N)).astype(np.int64)
    win_len = (olens[owners] + np.minimum(wl, 400) + 20).astype(np.int32)
    return dict(text=text, oriented=oriented, olens=olens, owners=owners,
                win_lo=win_lo, win_len=win_len, wl=wl)


def _t(c):
    return [torch.from_numpy(c[k]) for k in (
        "text", "oriented", "olens", "owners", "win_lo", "win_len", "wl")]


# name -> corridors of one call
WIDTH_SETS = {
    # most near 50, a tail to 250, a few past 1024; classes 512, 768 and
    # 4096 stay empty
    "mixed": lambda rng: np.concatenate([
        50 + rng.geometric(0.35, 150) - 1, rng.integers(64, 251, 20),
        rng.integers(1025, 1301, 3),
        [1, 32, 33, 56, 57, 64, 65, 96, 97, 128, 129, 1024]]),
    "one_candidate": lambda rng: np.array([77]),
    "one_class": lambda rng: rng.integers(57, 65, 40),
    "every_edge": lambda rng: np.array(
        [e + d for e in BANDED_CLASS_EDGES for d in (0, 1)][:-1]),
    "empty": lambda rng: np.zeros(0, np.int64),
}


@pytest.mark.parametrize("name", list(WIDTH_SETS))
def test_width_classes_partition_the_call(name):
    """perm lists every candidate once, class by class, in the caller's
    order within a class; the spans cover it with no gap; every member of
    a span fits its class edge and not the one below."""
    rng = np.random.default_rng(3)
    wl = np.asarray(WIDTH_SETS[name](rng), np.int32)
    rng.shuffle(wl)
    perm = class_permutation(torch.from_numpy(wl))
    counts = class_counts(torch.from_numpy(wl))
    assert perm.dtype == torch.int32 and counts.shape == (
        len(BANDED_CLASS_EDGES),)
    perm, counts = perm.numpy(), counts.tolist()
    assert sorted(perm.tolist()) == list(range(len(wl)))
    spans = class_spans(counts)
    assert sum(n for _, _, n in spans) == len(wl)
    assert all(n > 0 for _, _, n in spans)
    end = 0
    edges = (0, *BANDED_CLASS_EDGES)
    for edge, off, n in spans:
        assert off == end
        end = off + n
        members = perm[off:end]
        assert (np.diff(members) > 0).all()          # stable
        lower = edges[edges.index(edge) - 1]
        assert ((wl[members] > lower) & (wl[members] <= edge)).all()
    if name == "one_class":
        assert [e for e, _, _ in spans] == [64]
    if name == "mixed":
        assert {512, 768, 4096}.isdisjoint(e for e, _, _ in spans)
        assert len(spans) == 7
    if name == "every_edge":
        assert [e for e, _, _ in spans] == list(BANDED_CLASS_EDGES)


@pytest.mark.parametrize("name", [n for n in WIDTH_SETS if n != "empty"])
def test_plan_sorts_only_a_mixed_call(name):
    """A call whose corridors fall in one class is one span in the
    caller's order with no permutation; a mixed call (here with the
    sort's price set to 0) gets the sort and the spans of its class
    sizes."""
    rng = np.random.default_rng(5)
    wl = torch.from_numpy(np.asarray(WIDTH_SETS[name](rng), np.int32))
    perm, spans = plan_class_launches(wl, int(wl.min()), int(wl.max()),
                                      sort_pays=0)
    if name in ("one_candidate", "one_class"):
        assert perm is None
        assert spans == [(96 if name == "one_candidate" else 64, 0,
                          len(wl))]
    else:
        np.testing.assert_array_equal(perm.numpy(),
                                      class_permutation(wl).numpy())
        assert spans == class_spans(class_counts(wl).tolist())
        assert len(spans) > 1


# name -> (corridors of one call, whether the sort pays at the default
# price): the usual chained call with small indels, the same straddling
# an edge, that with a thin wide tail, and a large uniform call
def _spread(rng, N, hi):
    return rng.integers(50, hi + 1, N)


PAY_SETS = {
    "chained_50_60": (lambda rng: _spread(rng, 8192, 60), False),
    "chained_50_70": (lambda rng: _spread(rng, 8192, 70), False),
    "chained_wide_tail": (lambda rng: np.concatenate(
        [_spread(rng, 7700, 60), rng.integers(64, 251, 492)]), True),
    "uniform_1_128": (lambda rng: rng.integers(1, 129, 65536), True),
    "few_mixed": (lambda rng: np.array([1, 50, 700, 3000]), False),
}


@pytest.mark.parametrize("name", list(PAY_SETS))
def test_plan_sorts_only_where_it_pays(name):
    """At the default price a mixed call is sorted only if launching it
    class by class saves SORT_PAYS_SLOTS lane slots against one launch at
    its widest class; else it is one unsorted span at that class."""
    draw, pays = PAY_SETS[name]
    wl = torch.from_numpy(np.asarray(draw(np.random.default_rng(8)),
                                     np.int32))
    perm, spans = plan_class_launches(wl, int(wl.min()), int(wl.max()))
    by_class = class_spans(class_counts(wl).tolist())
    top = by_class[-1][0]
    saved = len(wl) * top - sum(e * n for e, _, n in by_class)
    assert (saved >= SORT_PAYS_SLOTS) == pays or len(by_class) == 1
    if pays:
        assert spans == by_class and len(spans) > 1
        np.testing.assert_array_equal(perm.numpy(),
                                      class_permutation(wl).numpy())
    else:
        assert perm is None and spans == [(top, 0, len(wl))]


@pytest.mark.parametrize("sort_pays", [0, None], ids=["sorted", "default"])
@pytest.mark.parametrize("name", list(WIDTH_SETS))
def test_class_launches_give_the_one_call_result(name, sort_pays):
    """The plain version run class by class through the launch's
    permutation, spans and scatter-back equals one plain call, row for
    row in the caller's order, with the sort forced and at its default
    price."""
    rng = np.random.default_rng(4)
    wl = np.asarray(WIDTH_SETS[name](rng), np.int32)
    rng.shuffle(wl)
    c = _inputs(rng, wl)
    got = gather_score_by_class_ref(*_t(c), sort_pays=sort_pays, **SW)
    want = gather_score_ref(*_t(c), **SW)
    assert got.dtype == torch.int32 and got.shape == (len(wl), 4)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_class_launches_equal_the_jax_gather():
    """The same candidates through the JAX package's _gather_score
    (banded, one band for the whole call)."""
    rng = np.random.default_rng(6)
    wl = np.concatenate([50 + rng.geometric(0.35, 60) - 1,
                         rng.integers(64, 251, 12), [1, 32, 33, 300]])
    c = _inputs(rng, wl.astype(np.int32))
    got = gather_score_by_class_ref(*_t(c), sort_pays=0, **SW).numpy()
    w_max = -(-int(c["win_len"].max()) // 64) * 64
    w_band = -(-int(c["wl"].max()) // 128) * 128
    want = _gather_score(
        jnp.asarray(c["text"]), jnp.asarray(c["oriented"]),
        jnp.asarray(c["olens"]), jnp.asarray(c["owners"]),
        jnp.asarray(c["win_lo"]), jnp.asarray(c["win_len"]),
        jnp.asarray(c["wl"]), w_max=w_max, w_band=w_band, sw_impl="banded",
        **SW)
    for col, k in enumerate(("score", "qb", "qe", "ref_end")):
        np.testing.assert_array_equal(got[:, col], np.asarray(want[k]), k)


# ----------------------------------------------------------------------
# numpy emulation of csrc/sw_banded.cu: sw_banded_kernel<LPT, SEGW, WARPS,
# BYTE> on one warp of 32 / SEGW candidates or on the block of one
# several-warp candidate, thread by thread: every shuffle, the hand-offs
# between warps through shared memory, the prmt lookups and the funnel
# shifts of the selector words
# ----------------------------------------------------------------------

T = 32
U32 = np.uint32


def _shfl_down(x, delta, width):
    t = np.arange(len(x))
    ok = (t % width) + delta < width
    return np.where(ok, x[np.minimum(t + delta, len(x) - 1)], x)


def _shfl_up(x, delta, width):
    t = np.arange(len(x))
    ok = (t % width) >= delta
    return np.where(ok, x[np.maximum(t - delta, 0)], x)


def _shfl_xor(x, mask):
    return x[np.arange(len(x)) ^ mask]


def _shfl_idx(x, src, width):
    """__shfl_sync(x, src, width): lane ``src`` of the caller's group."""
    t = np.arange(len(x))
    return x[(t // width) * width + (np.asarray(src) % width)]


def _better(v, d, i, bv, bd, bi):
    return (v > bv) | ((v == bv) & ((d < bd) | ((d == bd) & (i < bi))))


def prmt(x, y, s):
    """prmt.b32 (generic form) on uint32 arrays: nibble n of ``s`` picks the
    source byte of output byte n from (x bytes 0-3, y bytes 4-7); its bit 3
    spreads the byte's sign instead."""
    x, y, s = np.broadcast_arrays(*(np.asarray(a, np.uint64)
                                    for a in (x, y, s)))
    src = x | (y << np.uint64(32))
    out = np.zeros(x.shape, np.uint64)
    for n in range(4):
        nib = (s >> np.uint64(4 * n)) & np.uint64(0xf)
        byte = (src >> ((nib & np.uint64(7)) * np.uint64(8))) & np.uint64(255)
        sign = np.where(byte & np.uint64(0x80), 255, 0).astype(np.uint64)
        out |= np.where(nib & np.uint64(8), sign, byte) << np.uint64(8 * n)
    return out.astype(U32)


def _i32(x):
    """uint32 bits as signed 32-bit values (in int64)."""
    return np.asarray(x, U32).astype(np.int32).astype(np.int64)


def score_word(fc, match, mismatch):
    """The four score bytes of a base, one per partner base 0..3; all -1
    for an N (code >= 4)."""
    all_mm = (0x01010101 * ((-mismatch) & 0xff)) & 0xffffffff
    delta = ((-mismatch) ^ match) & 0xff
    fc = np.asarray(fc, np.int64)
    word = all_mm ^ (delta << (8 * np.minimum(fc, 3)))
    return np.where(fc >= 4, 0xffffffff, word).astype(U32)


def _funnel_r(lo, hi, s):
    """__funnelshift_r(lo, hi, s): the low word of (hi:lo) >> s."""
    v = (np.asarray(hi, np.uint64) << np.uint64(32)) | np.asarray(
        lo, np.uint64)
    return ((v >> np.uint64(s)) & np.uint64(0xffffffff)).astype(U32)


def _sext_byte(b):
    """The prmt selector that sign-spreads byte b over 32 bits."""
    return b | ((8 | b) * 0x1110)


def emulate_banded(LPT, SEGW, WARPS, text, cands, match, mismatch, gap_open,
                   gap_extend, clip, flip=()):
    """``cands``: up to 32 / SEGW tuples (read codes, win_lo, win_len, wl)
    over ``text`` (columns outside it read 5), one for a several-warp form;
    returns their (score, qb, qe, ref_end) rows as csrc/sw_banded.cu
    writes them: the byte lookups where match and mismatch fit a signed
    byte, else the mask form.  ``flip`` names tie rules to reverse
    ("warp_carry": the earlier warps' carry wins ties), so that a test can
    show which rule decides a set."""
    kW = WARPS if WARPS > 1 else 1
    nT = 32 * kW                          # one warp, or the whole block
    assert len(cands) <= (1 if WARPS > 1 else T // SEGW)
    t = np.arange(nT)
    lane, sl = t % 32, t % SEGW
    wc = t // 32 if WARPS > 1 else np.zeros(nT, np.int64)
    tc = t if WARPS > 1 else sl           # thread of the candidate
    seg = np.zeros(nT, np.int64) if WARPS > 1 else t // SEGW
    live = seg < len(cands)
    byte = -127 <= match <= 127 and -127 <= mismatch <= 127
    n_lanes = LPT * SEGW * kW
    words = (LPT + 7) // 8
    off = 8 * words - LPT                 # lane j is nibble off + j
    quads = range(off // 4, 2 * words)

    def per(i):
        return np.array([(len(cands[s][0]) if i < 0 else cands[s][i])
                         if live[th] else 0 for th, s in enumerate(seg)],
                        np.int64)

    rl, lo, nl, wl = per(-1), per(1), per(2), per(3)
    ge, goe = gap_extend, gap_open + gap_extend
    lanes = tc[:, None] * LPT + np.arange(LPT)[None, :]       # k, [nT, LPT]
    last_row = np.minimum(rl, nl)
    full_rows = np.minimum(nl - wl + 1, last_row)
    rows = last_row.copy()
    o = SEGW
    while o < 32:
        rows = np.maximum(rows, _shfl_xor(rows, o))
        o <<= 1
    assert (rows == rows[0]).all()

    def text_at(col):
        ok = (col >= 0) & (col < len(text))
        return np.where(ok, text[np.clip(col, 0, len(text) - 1)], 5)

    def nibble(c):
        return np.minimum(c, 4).astype(U32)

    def read_base(r):                     # 0-based read rows
        return np.array([cands[seg[th]][0][r[th]]
                         if live[th] and r[th] < last_row[th] else 4
                         for th in range(nT)], np.int64)

    def entering(i):                      # the base entering the last lane
        return nibble(text_at(lo + i + n_lanes - 1))

    # the segment's last thread; a several-warp candidate's last warp
    edge = (sl == SEGW - 1) & ~((WARPS > 1) & (wc + 1 < WARPS))

    def hand(x, fill):
        """Lane k0 + LPT's value: a shuffle down the segment, lane 0 of the
        next warp from shared memory, ``fill`` past the candidate."""
        y = _shfl_down(x, 1, SEGW)
        if WARPS > 1:
            bnd = x[32 * np.minimum(wc + 1, WARPS - 1)]        # sh_bnd
            y = np.where((sl == SEGW - 1) & (wc + 1 < WARPS), bnd, y)
        return np.where(edge, fill, y)

    Hp, Fp = (np.full((nT, LPT), NEG, np.int64) for _ in range(2))
    SHp, SFp = (np.zeros((nT, LPT), np.int64) for _ in range(2))
    BV = np.full((nT, LPT), NEG, np.int64)
    BI, BS = (np.zeros((nT, LPT), np.int64) for _ in range(2))
    KE = lanes * ge
    VM = lanes < wl[:, None]
    sel = np.zeros((nT, words), U32)
    for j in range(LPT):
        n = off + j
        sel[:, n >> 3] |= nibble(text_at(lo + lanes[:, j])) << U32(
            4 * (n & 7))
    r_cur, w_cur = np.full(nT, 4, np.int64), np.full(nT, 4, U32)
    r_next, w_next = read_base(sl), entering(1 + sl)

    for i in range(1, int(rows[0]) + 1):
        phase = (i - 1) % SEGW
        if phase == 0:                    # the staged bases, a period ahead
            r_cur, w_cur = r_next, w_next
            r_next = read_base(i - 1 + SEGW + sl)
            w_next = entering(i + SEGW + sl)
        sel0 = sel[:, 0] >> U32(4 * off)
        rc = _shfl_idx(r_cur, phase, SEGW)
        s_in = _shfl_idx(w_cur, phase, SEGW)
        nH, nF = hand(Hp[:, 0], NEG), hand(Fp[:, 0], NEG)
        nSH, nSF = hand(SHp[:, 0], 0), hand(SFp[:, 0], 0)
        nsel = hand(sel0, s_in).astype(U32)

        if byte:
            lut, second = score_word(rc, match, mismatch), 0xffffffff
        else:
            lut = np.where(rc >= 4, 0, 0xff << (8 * np.minimum(rc, 3)))
            mmr = np.where(rc >= 4, -1, -mismatch)
            xr = np.where(rc >= 4, 0, match ^ -mismatch)
            second = 0
        qa, qn = {}, {}
        for q in quads:
            s = sel[:, q >> 1] >> U32(16 * (q & 1))
            qa[q] = prmt(lut, second, s)
            qn[q] = prmt(0, 0xffffffff, s)
        slid = sel.copy()                 # every lane takes its neighbour's
        for w in range(words):
            hi = sel[:, w + 1] if w + 1 < words else nsel
            slid[:, w] = _funnel_r(sel[:, w], hi, 4)
        sel = slid
        row_ok = i <= last_row
        fresh = 0 if i == 1 else -clip
        endp = np.where(i == rl, 0, -clip)
        lim = np.where(row_ok, np.minimum(nl - i + 1, wl), 0)
        VM = np.where((i > full_rows)[:, None], lanes < lim[:, None], VM)

        HD, SD, H0, S0 = (np.zeros((nT, LPT), np.int64) for _ in range(4))
        aggP, aggS = np.full(nT, NEG, np.int64), np.zeros(nT, np.int64)
        for j in range(LPT):                     # part 1
            n = off + j
            sx = _sext_byte(n & 3)
            if byte:
                sub = _i32(prmt(qa[n >> 2], 0, sx))
            else:
                eq = _i32(prmt(qa[n >> 2], 0, sx))
                isn = _i32(prmt(qn[n >> 2], 0, sx))
                sub = ((eq & xr) ^ mmr) | isn
            last = j + 1 == LPT
            hn = nH if last else Hp[:, j + 1]
            fn = nF if last else Fp[:, j + 1]
            shn = nSH if last else SHp[:, j + 1]
            sfn = nSF if last else SFp[:, j + 1]
            fo, fe = hn - goe, fn - ge
            f = np.where(fo >= fe, fo, fe)
            sf = np.where(fo >= fe, shn, sfn)
            Fp[:, j], SFp[:, j] = f, sf
            ph = Hp[:, j]
            hd = np.where(ph >= fresh, ph, fresh) + sub
            sd = np.where(ph >= fresh, SHp[:, j], i - 1)
            h0, s0 = np.where(hd >= f, hd, f), np.where(hd >= f, sd, sf)
            a = h0 + KE[:, j]
            HD[:, j], SD[:, j], H0[:, j], S0[:, j] = hd, sd, h0, s0
            take = a >= aggP
            aggP, aggS = np.where(take, a, aggP), np.where(take, s0, aggS)

        o = 1                                    # scan_carries<SEGW>
        while o < SEGW:
            oP, oS = _shfl_up(aggP, o, SEGW), _shfl_up(aggS, o, SEGW)
            take = (sl >= o) & (oP > aggP)
            aggP, aggS = np.where(take, oP, aggP), np.where(take, oS, aggS)
            o <<= 1
        cP, cS = np.full(nT, NEG, np.int64), np.zeros(nT, np.int64)
        if WARPS > 1:
            # sh_agg: each warp's total at its lane 31; lane w of every warp
            # scans warp w's, the nearer winning ties
            tot = 32 * np.arange(WARPS) + 31
            pick = np.minimum(lane, WARPS - 1)
            wP = np.where(lane < WARPS, aggP[tot][pick], NEG)
            wS = np.where(lane < WARPS, aggS[tot][pick], 0)
            o = 1
            while o < WARPS:
                oP, oS = _shfl_up(wP, o, 32), _shfl_up(wS, o, 32)
                wins = oP >= wP if "warp_carry" in flip else oP > wP
                take = (lane >= o) & wins
                wP, wS = np.where(take, oP, wP), np.where(take, oS, wS)
                o <<= 1
            src = np.where(wc > 0, wc - 1, 0)
            has = wc > 0
            cP = np.where(has, _shfl_idx(wP, src, 32), NEG)
            cS = np.where(has, _shfl_idx(wS, src, 32), 0)
            wins = cP >= aggP if "warp_carry" in flip else cP > aggP
            take = has & wins
            aggP, aggS = np.where(take, cP, aggP), np.where(take, cS, aggS)
        P = np.where(sl == 0, cP, _shfl_up(aggP, 1, SEGW))
        PS = np.where(sl == 0, cS, _shfl_up(aggS, 1, SEGW))

        for j in range(LPT):                     # part 2
            f, sf = Fp[:, j].copy(), SFp[:, j]
            e = P - KE[:, j] - gap_open
            ef = np.where(e >= f, e, f)
            h = np.where(H0[:, j] >= e, H0[:, j], e)
            sh = np.where(HD[:, j] >= ef, SD[:, j], np.where(e >= f, PS, sf))
            a = H0[:, j] + KE[:, j]
            take = a >= P
            P, PS = np.where(take, a, P), np.where(take, S0[:, j], PS)
            Hp[:, j] = np.where(VM[:, j], h, NEG)
            Fp[:, j] = np.where(VM[:, j], f, NEG)
            SHp[:, j] = sh
            cand = Hp[:, j] + endp
            up = cand > BV[:, j]
            BV[:, j] = np.where(up, cand, BV[:, j])
            BI[:, j] = np.where(up, i, BI[:, j])
            BS[:, j] = np.where(up, sh, BS[:, j])

    best = [np.full(nT, NEG, np.int64)] + [np.zeros(nT, np.int64)
                                           for _ in range(4)]  # v d i x s
    for j in range(LPT):
        k = lanes[:, j]
        offer = [BV[:, j], 2 * BI[:, j] + k, BI[:, j], k, BS[:, j]]
        take = _better(offer[0], offer[1], offer[2], *best[:3])
        best = [np.where(take, o_, b) for o_, b in zip(offer, best)]
    o = SEGW // 2                                # reduce_best<SEGW>
    while o > 0:
        other = [_shfl_xor(b, o) for b in best]
        take = _better(other[0], other[1], other[2], *best[:3])
        best = [np.where(take, o_, b) for o_, b in zip(other, best)]
        o >>= 1
    if WARPS > 1:                                # thread 0 joins sh_best
        v, d, bi, bx, bs = (int(b[0]) for b in best)
        for w in range(1, WARPS):
            ov, od, oi, ox, os_ = (int(b[32 * w]) for b in best)
            if _better(ov, od, oi, v, d, bi):
                v, d, bi, bx, bs = ov, od, oi, ox, os_
        return np.array([[v, bs, bi, bi + bx]], np.int64)
    v, _, bi, bx, bs = best
    return np.array([[v[s * SEGW], bs[s * SEGW], bi[s * SEGW],
                      bi[s * SEGW] + bx[s * SEGW]]
                     for s in range(len(cands))], np.int64)


def emulate_call(form, text, cands, **scoring):
    """``emulate_banded`` over any number of candidates: one warp or one
    block after another, as the launch lays them out."""
    LPT, SEGW, WARPS = form
    per = 1 if WARPS > 1 else T // SEGW
    return np.concatenate([
        emulate_banded(LPT, SEGW, WARPS, text, cands[s:s + per], **scoring)
        for s in range(0, len(cands), per)])


def _warp_candidates(rng, n_cands, lanes, m_max=36):
    """Candidates for one warp: reads of mixed lengths (one of length 0)
    planted on a diagonal inside their corridor, with a substitution, a
    deletion and N bases; windows that end before or after the read."""
    cands = []
    for c in range(n_cands):
        m = 0 if c == 1 else int(rng.integers(14, m_max + 1))
        wl = int(rng.integers(1, lanes + 1)) if c else lanes
        o = int(rng.integers(0, wl))
        n = max(o + m + int(rng.integers(-3, 11)), 1)
        win = rng.integers(0, 4, n + m_max).astype(np.int64)
        read = win[o:o + m].copy()
        win = win[:n]
        if m:
            read[int(rng.integers(0, m))] ^= 1
        if m and c % 2:
            cut = int(rng.integers(4, m - 4))
            read = np.concatenate([read[:cut], read[cut + 1:],
                                   rng.integers(0, 4, 1)])
        if c == 2:
            read[m // 2] = 4
        if c == 0:
            win[n // 3] = 5
        cands.append((read, win, wl))
    return cands


def _banded_text(rng, n=1500):
    text = rng.integers(0, 4, n).astype(np.uint8)
    text[n // 2:n // 2 + 12] = 4                        # a run of N bases
    return text


def _banded_candidates(rng, text, n_cands, lanes, m_max, m_min=None):
    """Candidates over ``text`` for a form of ``lanes`` lanes: reads of
    mixed lengths (one of length 0) planted with a substitution, a
    deletion and an N; corridors of every lane, of 1, of five eighths and
    drawn; windows short enough for tail rows (win_len < rl + wl - 1) and
    windows that run off either end of the text."""
    n = len(text)
    if m_min is None:
        m_min = max(m_max // 3, 2)
    cands = []
    for c in range(n_cands):
        m = 0 if c == 1 else int(rng.integers(m_min, m_max + 1))
        wl = (lanes, max(lanes * 5 // 8, 1), 1,
              int(rng.integers(1, lanes + 1)))[c % 4]
        o = int(rng.integers(0, min(wl, 40)))
        where = c % 3                      # 0 inside, 1 at the start, 2 end
        if where == 1:
            p = int(rng.integers(0, 6))
            o = max(o, p + 1)              # the window starts before 0
        elif where == 2:
            p = n - m - int(rng.integers(0, 4))
        else:
            p = int(rng.integers(40, n - m - 80))
        read = text[p:p + m].astype(np.int64).copy()
        if m > 4:
            read[int(rng.integers(0, m))] ^= 1
        if m > 12 and c % 2:
            cut = int(rng.integers(4, m - 4))
            read = np.concatenate([read[:cut], read[cut + 1:], [2]])
        if m > 6 and c % 5 == 0:
            read[m // 2] = 4
        nl = m + min(wl, 80) + int(rng.integers(-2, 30))
        if c % 4 == 2 or c % 7 == 3:       # tail rows
            nl = max(m + wl - 1 - int(rng.integers(1, 25)), 1)
        cands.append((read, p - o, max(nl, 1), wl))
    return cands


# csrc/sw_banded.cu's launch table: corridor class -> (the candidates an
# SM up to which a call takes the small call's form, that form, the large
# call's form), each form (lanes a thread, threads a warp segment, warps);
# test_banded_forms_mirror_the_launch_table reads it back from the source
BANDED_FORMS = {
    32: (16, (2, 16, 1), (4, 8, 1)), 64: (12, (2, 32, 1), (8, 8, 1)),
    96: (4, (3, 32, 1), (6, 16, 1)), 128: (8, (4, 32, 1), (8, 16, 1)),
    256: (None, (8, 32, 1), (8, 32, 1)),
    512: (2, (4, 32, 4), (16, 32, 1)), 768: (1, (3, 32, 8), (12, 32, 2)),
    1024: (2, (8, 32, 4), (16, 32, 2)), 2048: (1, (8, 32, 8), (16, 32, 4)),
    4096: (None, (16, 32, 8), (16, 32, 8))}
FORMS = sorted({f for _, *pair in BANDED_FORMS.values() for f in pair},
               key=lambda f: (f[0] * f[1] * f[2], f))
FORM_IDS = [f"{w}w{s}x{lpt}" if w > 1 else f"{s}x{lpt}"
            for lpt, s, w in FORMS]
SRC = Path(__file__).resolve().parents[1] / "ema_tpu_torch" / "ops" / \
    "csrc" / "sw_banded.cu"


def _lanes(form):
    return form[0] * form[1] * form[2]


def test_banded_forms_mirror_the_launch_table():
    """BANDED_FORMS is the table that sw_banded_launch picks from, class
    by class, and its classes are ops/sw.BANDED_CLASS_EDGES; every form
    covers its class."""
    body = SRC.read_text().split("int sw_banded_launch(")[1]
    table = {}
    for line in body.splitlines():
        if "SW_FORM(" not in line or "#define" in line:
            continue
        edge = re.search(r"max_wl <= (\d+)", line)
        per_sm = re.search(r"small\((\d+)\)", line)
        forms = [tuple(map(int, f)) for f in
                 re.findall(r"SW_FORM\((\d+), (\d+), (\d+)\)", line)]
        table[int(edge.group(1)) if edge else BANDED_CLASS_EDGES[-1]] = (
            int(per_sm.group(1)) if per_sm else None, forms[0], forms[-1])
    assert table == BANDED_FORMS
    assert tuple(table) == BANDED_CLASS_EDGES
    for edge, (_, *pair) in table.items():
        assert all(_lanes(f) >= edge for f in pair)


def _emulated_and_plain(form, text, cands, **scoring):
    got = emulate_call(form, text, cands, **scoring)
    want = gather_score_ref(*_t(cand_inputs(text, cands)), scorer="banded",
                            **scoring).numpy()
    return got, want


def _form_candidates(rng, form):
    """A call's candidates for one form: a whole warp of segments and one
    with a segment past N, or four several-warp candidates (corridors of
    every lane, of 1 and narrower than one warp's lanes)."""
    lanes = _lanes(form)
    text = _banded_text(rng, 1500 if lanes <= 512 else 6000)
    if form[2] > 1:
        return text, [_banded_candidates(rng, text, 4, lanes, 60)]
    nseg = T // form[1]
    return text, [_banded_candidates(rng, text, n, lanes, 60)
                  for n in sorted({nseg, max(nseg - 1, 1)})]


@pytest.mark.parametrize("form", FORMS, ids=FORM_IDS)
@pytest.mark.parametrize("seed", [0, 1])
def test_banded_row_sweep_emulation(form, seed):
    """Every form of sw_banded's launch table against the plain row sweep
    through the gather: mixed read lengths, N bases, windows off both ends
    of the text, tail rows, corridors of 1 to every lane."""
    rng = np.random.default_rng(500 + 7 * _lanes(form) + seed)
    text, calls = _form_candidates(rng, form)
    top = 0
    for cands in calls:
        got, want = _emulated_and_plain(form, text, cands, **SW)
        np.testing.assert_array_equal(got, want)
        top = max(top, int(want[:, 0].max()))
    assert top >= 10                     # real alignments were scored


@pytest.mark.parametrize("form", FORMS, ids=FORM_IDS)
def test_banded_row_sweep_emulation_int32_scores(form):
    """The mask form of the lookups (match and mismatch past a signed
    byte) in every form, against the plain row sweep."""
    rng = np.random.default_rng(900 + _lanes(form))
    text, calls = _form_candidates(rng, form)
    scoring = dict(SW, match=200, mismatch=150)
    for cands in calls:
        got, want = _emulated_and_plain(form, text, cands, **scoring)
        np.testing.assert_array_equal(got, want)
        assert int(want[:, 0].max()) >= 2000


@pytest.mark.parametrize("form", [f for f in FORMS if _lanes(f) >= 64],
                         ids=[i for f, i in zip(FORMS, FORM_IDS)
                              if _lanes(f) >= 64])
def test_banded_row_sweep_emulation_keeps_the_tie_rules(form):
    """The candidates whose outputs the tie rules decide (TIE_SETS:
    corridors of at most 64 lanes) in every form of at least 64 lanes."""
    for scoring, B, picks in TIE_SETS:
        text, cands = tie_batch(B, picks)
        got, want = _emulated_and_plain(form, text, cands, **scoring)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("form", [(4, 32, 4), (16, 32, 1), (3, 32, 8),
                                  (12, 32, 2), (8, 32, 4)],
                         ids=["4w32x4", "32x16", "8w32x3", "2w32x12",
                              "4w32x8"])
def test_banded_row_sweep_emulation_keeps_the_warp_tie_rule(form):
    """WARP_TIE_SET: a gap's two sources of one value lie in two warps of
    the 4-warp form of 4 lanes a thread, and the nearer must win there as
    in the plain sweep; reversing the warp carry's rule changes every
    pick's start row."""
    scoring, B, picks = WARP_TIE_SET
    text, cands = warp_tie_batch(B, picks)
    got, want = _emulated_and_plain(form, text, cands, **scoring)
    np.testing.assert_array_equal(got, want)
    if form == (4, 32, 4):
        flipped = emulate_call(form, text, cands, flip=("warp_carry",),
                               **scoring)
        assert (flipped[:, 1] != want[:, 1]).all()


def test_banded_row_sweep_emulation_equals_pallas():
    """A one-warp and a several-warp form on one set against the JAX
    package's banded Pallas kernel in interpret mode, fed by the gather
    of ema_tpu/core/pipeline.py:_gather_score."""
    rng = np.random.default_rng(12)
    text = _banded_text(rng)
    cands = _banded_candidates(rng, text, 8, 256, 70)
    c = cand_inputs(text, cands)
    w_max = int(c["win_len"].max())
    cols = c["win_lo"][:, None] + np.arange(w_max)[None, :]
    wins = np.where((cols < 0) | (cols >= len(text)), 5,
                    text[np.clip(cols, 0, len(text) - 1)]).astype(np.int32)
    want = sw_score_banded_pallas(
        jnp.asarray(c["oriented"].astype(np.int32)),
        jnp.asarray(c["olens"]), jnp.asarray(wins),
        jnp.asarray(c["win_len"]), 256, interpret=True,
        wl=jnp.asarray(c["wl"]), **SW)
    for form in (BANDED_FORMS[256][1], BANDED_FORMS[512][1]):
        got = emulate_call(form, text, cands, **SW)
        for col, k in enumerate(("score", "qb", "qe", "ref_end")):
            np.testing.assert_array_equal(got[:, col], np.asarray(want[k]),
                                          f"{form} {k}")
    assert int(np.asarray(want["score"]).max()) >= 20


def test_banded_scorer_takes_any_int32_scoring():
    """gather_score(scorer="banded") refuses no scoring the JAX banded
    scorer takes: match 200 and mismatch 150 on the CPU equal the JAX
    package's _gather_score (XLA's sw_score_banded) on the same call."""
    rng = np.random.default_rng(13)
    wl = np.concatenate([rng.integers(40, 65, 20), [1, 128, 300]])
    c = _inputs(rng, wl.astype(np.int32))
    scoring = dict(SW, match=200, mismatch=150)
    got = gather_score(*_t(c), scorer="banded", **scoring).numpy()
    want = _gather_score(
        jnp.asarray(c["text"]), jnp.asarray(c["oriented"]),
        jnp.asarray(c["olens"]), jnp.asarray(c["owners"]),
        jnp.asarray(c["win_lo"]), jnp.asarray(c["win_len"]),
        jnp.asarray(c["wl"]), w_max=int(c["win_len"].max()),
        w_band=384, sw_impl="banded", **scoring)
    for col, k in enumerate(("score", "qb", "qe", "ref_end")):
        np.testing.assert_array_equal(got[:, col], np.asarray(want[k]), k)
    assert got[:, 0].max() >= 4000
