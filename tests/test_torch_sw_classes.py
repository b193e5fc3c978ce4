"""sw_banded's launch by corridor-width class, on the CPU.

The CUDA kernel cannot run here, so two things are held instead:

* the host side of ``ops/sw._plan_kernel``: ``plan_class_launches``
  (one span and no sort when the call's corridors fall in one class, or
  when a sort would save too few lane slots to pay; else
  ``class_counts``, ``class_spans`` and the device sort
  ``class_permutation``) and the scatter-back, driven with the plain
  version in place of the kernel (``gather_score_by_class_ref``), against one
  ``gather_score_ref`` call and against the JAX package's ``_gather_score``;
* the forms of ``csrc/sw_rowsweep.cuh`` that the narrow classes take
  (8- and 16-thread segments, 4 and 2 candidates a warp, and a whole
  warp at 1, 2 and 4 lanes a thread): a numpy emulation of the kernel
  body, thread by thread and shuffle by shuffle, against
  ``sw_score_banded_ref``.

All comparisons are exact (int32).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ema_tpu.core.pipeline import _gather_score
from ema_tpu_torch.ops.sw import (BANDED_CLASS_EDGES, NEG,
                                  SORT_PAYS_SLOTS, class_counts,
                                  class_permutation, class_spans,
                                  gather_score_by_class_ref, gather_score_ref,
                                  plan_class_launches, sw_score_banded_ref)

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
# numpy emulation of rowsweep_kernel<LPT, SEGW, 1>: one warp of 32
# threads, 32 / SEGW candidates, each thread's state in row t of [32, LPT]
# arrays, every __shfl_*_sync written out
# ----------------------------------------------------------------------

T = 32
INT32_MIN = -(1 << 31)


def _shfl_down(x, delta, width):
    t = np.arange(T)
    ok = (t % width) + delta < width
    return np.where(ok, x[np.minimum(t + delta, T - 1)], x)


def _shfl_up(x, delta, width):
    t = np.arange(T)
    ok = (t % width) >= delta
    return np.where(ok, x[np.maximum(t - delta, 0)], x)


def _shfl_xor(x, mask):
    return x[np.arange(T) ^ mask]


def _better(v, d, i, bv, bd, bi):
    return (v > bv) | ((v == bv) & ((d < bd) | ((d == bd) & (i < bi))))


def emulate_rowsweep(LPT, SEGW, cands, match, mismatch, gap_open,
                     gap_extend, clip):
    """``cands``: up to 32 / SEGW tuples (read codes, window codes, wl);
    returns their (score, qb, qe, ref_end) rows as the kernel writes them
    (a missing candidate is a segment past N: no rows, no lanes)."""
    nseg = T // SEGW
    assert len(cands) <= nseg
    t = np.arange(T)
    sl, seg = t % SEGW, t // SEGW
    live = seg < len(cands)
    rl = np.array([len(cands[s][0]) if s < len(cands) else 0 for s in seg])
    nl = np.array([len(cands[s][1]) if s < len(cands) else 0 for s in seg])
    wl = np.array([cands[s][2] if s < len(cands) else 0 for s in seg])
    goe, ge = gap_open + gap_extend, gap_extend
    k0 = sl * LPT
    last_row = np.minimum(rl, nl)
    rows = last_row.copy()
    off = SEGW
    while off < 32:                      # the longest row count of the warp
        rows = np.maximum(rows, _shfl_xor(rows, off))
        off <<= 1
    assert (rows == rows[0]).all()

    def read_at(i):
        return np.array([cands[s][0][i - 1] if live[th] and i <= last_row[th]
                         else 4 for th, s in enumerate(seg)])

    def win_at(i, k):
        c = i - 1 + k
        return np.array([cands[s][1][c[th]] if live[th] and c[th] < nl[th]
                         else 5 for th, s in enumerate(seg)])

    def sub(rc, fb):
        return np.where((rc >= 4) | (fb >= 4), -1,
                        np.where(rc == fb, match, -mismatch))

    Hp = np.full((T, LPT), NEG, np.int64)
    Fp = np.full((T, LPT), NEG, np.int64)
    SHp = np.zeros((T, LPT), np.int64)
    SFp = np.zeros((T, LPT), np.int64)
    rb = np.full((T, LPT), 5, np.int64)
    best = [np.full(T, NEG, np.int64)] + [np.zeros(T, np.int64)
                                          for _ in range(4)]  # v d i x s

    for i in range(1, int(rows[0]) + 1):
        nH = _shfl_down(Hp[:, 0], 1, SEGW)
        nF = _shfl_down(Fp[:, 0], 1, SEGW)
        nSH = _shfl_down(SHp[:, 0], 1, SEGW)
        nSF = _shfl_down(SFp[:, 0], 1, SEGW)
        edge = sl == SEGW - 1
        nH, nF = np.where(edge, NEG, nH), np.where(edge, NEG, nF)
        nSH, nSF = np.where(edge, 0, nSH), np.where(edge, 0, nSF)
        row_ok = i <= last_row
        rc = read_at(i)
        fresh = 0 if i == 1 else -clip
        end_adj = np.where(i == rl, 0, -clip)

        aggP = np.full(T, INT32_MIN, np.int64)
        aggS = np.zeros(T, np.int64)
        for j in range(LPT):             # pass 1
            k = k0 + j
            act = k < wl
            rb[:, j] = np.where(act, win_at(i, k), rb[:, j])
            last = j + 1 == LPT
            hn = nH if last else Hp[:, j + 1]
            fn = nF if last else Fp[:, j + 1]
            shn = nSH if last else SHp[:, j + 1]
            sfn = nSF if last else SFp[:, j + 1]
            fo, fe = hn - goe, fn - ge
            f = np.where(fo >= fe, fo, fe)
            sf = np.where(fo >= fe, shn, sfn)
            Fp[:, j] = np.where(act, f, Fp[:, j])
            SFp[:, j] = np.where(act, sf, SFp[:, j])
            ph = Hp[:, j]
            hd = np.where(ph >= fresh, ph, fresh) + sub(rc, rb[:, j])
            sd = np.where(ph >= fresh, SHp[:, j], i - 1)
            valid = row_ok & (i + k <= nl)
            h0 = np.where(hd >= f, hd, f)
            s0 = np.where(hd >= f, sd, sf)
            a = np.where(valid, h0 + k * ge, NEG)
            take = act & (a >= aggP)
            aggP, aggS = np.where(take, a, aggP), np.where(take, s0, aggS)

        off = 1                          # scan_carries<SEGW>
        while off < SEGW:
            oP, oS = _shfl_up(aggP, off, SEGW), _shfl_up(aggS, off, SEGW)
            take = (sl >= off) & (oP > aggP)
            aggP, aggS = np.where(take, oP, aggP), np.where(take, oS, aggS)
            off <<= 1
        P = np.where(sl == 0, NEG, _shfl_up(aggP, 1, SEGW))
        PS = np.where(sl == 0, 0, _shfl_up(aggS, 1, SEGW))

        for j in range(LPT):             # pass 2
            k = k0 + j
            act = k < wl
            ph = Hp[:, j]
            hd = np.where(ph >= fresh, ph, fresh) + sub(rc, rb[:, j])
            sd = np.where(ph >= fresh, SHp[:, j], i - 1)
            f, sf = Fp[:, j], SFp[:, j]
            valid = row_ok & (i + k <= nl)
            h0 = np.where(hd >= f, hd, f)
            s0 = np.where(hd >= f, sd, sf)
            e = P - k * ge - gap_open
            ef = np.where(e >= f, e, f)
            h = np.where(h0 >= e, h0, e)
            sh = np.where(hd >= ef, sd, np.where(e >= f, PS, sf))
            a = np.where(valid, h0 + k * ge, NEG)
            take = act & (a >= P)
            P, PS = np.where(take, a, P), np.where(take, s0, PS)
            Hp[:, j] = np.where(act, np.where(valid, h, NEG), Hp[:, j])
            Fp[:, j] = np.where(act, np.where(valid, f, NEG), Fp[:, j])
            SHp[:, j] = np.where(act, sh, SHp[:, j])
            offer = [h + end_adj, 2 * i + k, np.full(T, i), k, sh]
            take = act & valid & _better(offer[0], offer[1], offer[2],
                                         best[0], best[1], best[2])
            best = [np.where(take, o, b) for o, b in zip(offer, best)]

    off = SEGW // 2                      # reduce_best<SEGW>
    while off > 0:
        other = [_shfl_xor(b, off) for b in best]
        take = _better(other[0], other[1], other[2], best[0], best[1],
                       best[2])
        best = [np.where(take, o, b) for o, b in zip(other, best)]
        off >>= 1
    v, _, bi, bx, bs = best
    return np.array([[v[s * SEGW], bs[s * SEGW], bi[s * SEGW],
                      bi[s * SEGW] + bx[s * SEGW]]
                     for s in range(len(cands))], np.int64)


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


@pytest.mark.parametrize("LPT,SEGW", [(4, 8), (7, 8), (8, 8), (6, 16),
                                      (4, 16), (1, 32), (2, 32), (4, 32)],
                         ids=["8x4", "8x7", "8x8", "16x6", "16x4", "32x1",
                              "32x2", "32x4"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_part_warp_row_sweep_emulation(LPT, SEGW, seed):
    """The kernel body at 8, 16 and 32 threads a candidate (every form
    the classes of at most 128 lanes take, an odd 8 x 7 and a 16 x 4
    besides),
    a full warp and one with a missing last candidate, against the plain
    row sweep."""
    rng = np.random.default_rng(100 * SEGW + seed)
    nseg = T // SEGW
    top = 0
    for n_cands in {nseg, max(nseg - 1, 1)}:
        cands = _warp_candidates(rng, n_cands, LPT * SEGW)
        got = emulate_rowsweep(LPT, SEGW, cands, **SW)
        m = max(max(len(c[0]) for c in cands), 1)
        n = max(len(c[1]) for c in cands)
        reads = np.full((n_cands, m), 4, np.int32)
        refs = np.full((n_cands, n), 5, np.int32)
        for b, (r, w, _) in enumerate(cands):
            reads[b, :len(r)] = r
            refs[b, :len(w)] = w
        want = sw_score_banded_ref(
            torch.from_numpy(reads),
            torch.tensor([len(c[0]) for c in cands], dtype=torch.int32),
            torch.from_numpy(refs),
            torch.tensor([len(c[1]) for c in cands], dtype=torch.int32),
            LPT * SEGW,
            wl=torch.tensor([c[2] for c in cands], dtype=torch.int32),
            **SW).numpy()
        np.testing.assert_array_equal(got, want)
        top = max(top, int(want[:, 0].max()))
    assert top >= 10                     # real alignments were scored
