"""The thread forms of sw_batch, sw_banded16 and sw_banded_packed, on the
CPU.

The CUDA kernels cannot run here, so each form is held as a numpy
emulation of the kernel body, thread by thread and shuffle by shuffle
(one warp of 32 threads, 32 / G candidates), against the plain PyTorch
version and, on a subset, against the Pallas kernels in interpret mode:

* ``emulate_batch(R, G)``: csrc/sw_batch.cu's part-warp wavefront with the
  per-row best by a strict >, the end-of-read penalty added at the merge,
  rows past the read left unmasked, the substitution score as one
  byte permute (``prmt``) of a column's score word by a row's selector, the window
  loaded G columns at a time and handed down the wavefront with the row
  state (start rows packed in one word);
* ``emulate_banded16(H, SEGW)``: csrc/sw_banded16.cu's s16x2 row sweep in
  one pass, with the static lane mask, the tail-row mask, base selectors
  that slide with a byte permute and every s16x2 operation wrapping at
  16 bits and every select mask taken from the sign of the wrapped
  difference;
* ``emulate_packed(LPT, SEGW)``: csrc/sw_banded_packed.cu's one-pass int32
  row sweep at 16 x 4 and 8 x 8 lanes (two and four candidates a warp),
  with selector nibbles that slide by a funnel shift, four scores a prmt,
  one sign-spreading prmt a lane, the static and tail-row lane masks and
  per-lane bests, over a text that windows run off at either end.

``banded16`` through ``plan_class_launches`` equals the one-call result and
the JAX package's gather and Pallas int16 kernel; ``packed``'s emulation
equals the JAX package's pair-packed Pallas kernel.  All comparisons are
exact (integers).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ema_tpu.ops.sw_pallas import (sw_score_banded_pallas16,
                                   sw_score_banded_pallas_packed,
                                   sw_score_batch_pallas)
from ema_tpu_torch.ops.sw import (NEG, NEG16, gather_score,
                                  gather_score_by_class_ref,
                                  gather_score_ref, sw_score_banded16_ref,
                                  sw_score_batch_ref)
from chip_smoke import TIE_SETS
from chip_smoke import cand_inputs as _packed_inputs
from chip_smoke import tie_batch as _tie_batch
from test_torch_sw_classes import (T, U32, WIDTH_SETS, _better, _funnel_r,
                                   _i32, _inputs, _sext_byte, _shfl_down,
                                   _shfl_idx, _shfl_up, _shfl_xor, _t,
                                   _warp_candidates, prmt, score_word)

SW = dict(match=1, mismatch=4, gap_open=6, gap_extend=1, clip=5)
KEYS = ("score", "qb", "qe", "ref_end")


def test_prmt_looks_up_signed_scores():
    """The selectors of both kernels: a base's byte of the score word,
    sign-extended; an N picks a -1 byte of the second operand."""
    for fc in range(6):
        word = score_word(fc, 2, 4)
        for rc in range(6):
            byte = min(rc, 4)
            sel = byte | ((8 | byte) * 0x1110)
            want = -1 if fc >= 4 or rc >= 4 else (2 if rc == fc else -4)
            assert _i32(prmt(word, 0xffffffff, sel)) == want
            # two lanes a register: the selector byte in each half
            lane = byte | ((8 | byte) << 4)
            got = prmt(word, 0xffffffff, lane | (lane << 8))
            assert got == ((want & 0xffff) | ((want & 0xffff) << 16))


# ----------------------------------------------------------------------
# sw_batch_kernel<R, G>
# ----------------------------------------------------------------------

def emulate_batch(R, G, cands, match, mismatch, gap_open, gap_extend, clip):
    """``cands``: up to 32 / G tuples (read codes, window codes); returns
    their (score, qb, qe, ref_end) rows as the kernel writes them."""
    nseg = T // G
    assert len(cands) <= nseg
    t = np.arange(T)
    sl, seg = t % G, t // G
    live = seg < len(cands)
    rl = np.array([len(cands[s][0]) if s < len(cands) else 0 for s in seg])
    nl = np.array([len(cands[s][1]) if s < len(cands) else 0 for s in seg])
    goe, ge = gap_open + gap_extend, gap_extend
    i0 = sl * R + 1

    def read_at(i):
        return np.array([cands[s][0][i[th] - 1] if live[th]
                         and i[th] <= rl[th] else 4
                         for th, s in enumerate(seg)])

    def text_at(c):                      # window column c, 0-based
        return np.array([cands[s][1][c[th]] if live[th]
                         and 0 <= c[th] < nl[th] else 5
                         for th, s in enumerate(seg)])

    sel = np.zeros((T, R), U32)
    for r in range(R):
        byte = np.minimum(read_at(i0 + r), 4).astype(np.int64)
        sel[:, r] = byte | ((8 | byte) * 0x1110)
    H = np.full((T, R), NEG, np.int64)
    D = np.full((T, R), NEG, np.int64)
    SH = np.zeros((T, R), np.int64)
    SD = np.zeros((T, R), np.int64)
    BV = np.full((T, R), NEG, np.int64)
    BP = np.zeros((T, R), np.int64)
    uH, uV = np.full(T, NEG, np.int64), np.full(T, NEG, np.int64)
    uSH, uSV = np.zeros(T, np.int64), np.zeros(T, np.int64)
    gH, gSH = np.full(T, NEG, np.int64), np.zeros(T, np.int64)
    oH, oV = np.full(T, NEG, np.int64), np.full(T, NEG, np.int64)
    oS = np.zeros(T, np.int64)
    word = np.full(T, 0xffffffff, U32)
    buf = np.full(T, 0xffffffff, U32)

    active = (rl + R - 1) // R
    steps = np.where((rl > 0) & (nl > 0), nl + active - 1, 0)
    off = G
    while off < 32:
        steps = np.maximum(steps, _shfl_xor(steps, off))
        off <<= 1
    assert (steps == steps[0]).all()

    for s in range(int(steps[0])):
        if s % G == 0:
            buf = score_word(text_at(s + sl), match, mismatch)
        w0 = _shfl_idx(buf, s % G, G)
        word = np.where(sl == 0, w0, word)
        j = s - sl + 1
        act = (j >= 1) & (j <= nl) & (sl < active)
        jp = j << 10
        upH, upV, upSH, upSV = uH, uV, uSH, uSV
        dgH, dgSH = gH, gSH
        for r in range(R):
            fresh = np.where((r == 0) & (sl == 0), 0, -clip)
            sub = _i32(prmt(word, 0xffffffff, sel[:, r]))
            pd = dgH >= fresh
            hdg = np.where(pd, dgH, fresh) + sub
            sdg = np.where(pd, dgSH, i0 + r - 1)
            vo, ve = upH - goe, upV - ge
            v = np.maximum(vo, ve)
            sv = np.where(vo >= ve, upSH, upSV)
            do, de = H[:, r] - goe, D[:, r] - ge
            dd = np.maximum(do, de)
            sdd = np.where(do >= de, SH[:, r], SD[:, r])
            dv = np.maximum(dd, v)
            sdv = np.where(dd >= v, sdd, sv)
            h = np.maximum(hdg, dv)
            sh = np.where(hdg >= dv, sdg, sdv)
            dgH, dgSH = H[:, r].copy(), SH[:, r].copy()
            H[:, r] = np.where(act, h, H[:, r])
            D[:, r] = np.where(act, dd, D[:, r])
            SH[:, r] = np.where(act, sh, SH[:, r])
            SD[:, r] = np.where(act, sdd, SD[:, r])
            upH, upV, upSH, upSV = h, v, sh, sv
            keep = BV[:, r] >= h
            BP[:, r] = np.where(act & ~keep, jp | sh, BP[:, r])
            BV[:, r] = np.where(act, np.maximum(BV[:, r], h), BV[:, r])
            assert (sh[act] >= 0).all() and (sh[act] < 1024).all()
        oH, oV = np.where(act, upH, oH), np.where(act, upV, oV)
        oS = np.where(act, upSH | (upSV << 10), oS)
        gH, gSH = uH, uSH
        uH, uV = _shfl_up(oH, 1, G), _shfl_up(oV, 1, G)
        uS = _shfl_up(oS, 1, G)
        word = _shfl_up(word, 1, G)
        uSH, uSV = uS & 1023, uS >> 10
        uH, uV = np.where(sl == 0, NEG, uH), np.where(sl == 0, NEG, uV)
        uSH, uSV = np.where(sl == 0, 0, uSH), np.where(sl == 0, 0, uSV)

    best = [np.full(T, NEG, np.int64)] + [np.zeros(T, np.int64)
                                          for _ in range(3)]   # v d i s
    for r in range(R):
        i = i0 + r
        ok = (i <= rl) & (nl > 0)
        offer = [BV[:, r] + np.where(i == rl, 0, -clip),
                 i + (BP[:, r] >> 10), i, BP[:, r] & 1023]
        take = ok & _better(offer[0], offer[1], offer[2], *best[:3])
        best = [np.where(take, o, b) for o, b in zip(offer, best)]
    off = G // 2
    while off > 0:
        other = [_shfl_xor(b, off) for b in best]
        take = _better(other[0], other[1], other[2], *best[:3])
        best = [np.where(take, o, b) for o, b in zip(other, best)]
        off >>= 1
    v, d, bi, bs = best
    return np.array([[v[s * G], bs[s * G], bi[s * G], d[s * G] - bi[s * G]]
                     for s in range(len(cands))], np.int64)


def _batch_candidates(rng, n_cands, rows):
    """Whole-window candidates for one warp: reads up to ``rows`` bases
    (one of length 0, one of length 1, one of exactly ``rows``) planted in
    windows with a substitution, a deletion and N bases; one window of
    length 0 and one shorter than its read."""
    cands = []
    for c in range(n_cands):
        m = (rows, 0, 1)[c] if c < 3 else int(rng.integers(2, rows + 1))
        n = int(rng.integers(m + 1, m + 40))
        if c == 4:
            n = max(m // 2, 1)
        if c == 5:
            n = 0
        win = rng.integers(0, 4, max(n, m) + 1).astype(np.int64)
        o = int(rng.integers(0, max(n - m, 0) + 1))
        read = win[o:o + m].copy()
        win = win[:n]
        if m > 3:
            read[int(rng.integers(0, m))] ^= 1
        if m > 12 and c % 2:
            cut = int(rng.integers(4, m - 4))
            read = np.concatenate([read[:cut], read[cut + 1:],
                                   rng.integers(0, 4, 1)])
        if m > 6 and c % 3 == 0:
            read[m // 2] = 4
        if n > 3 and c % 4 == 0:
            win[n // 3] = 5
        cands.append((read, win))
    return cands


def _batch_plain(cands):
    B = len(cands)
    m = max(max(len(c[0]) for c in cands), 1)
    n = max(max(len(c[1]) for c in cands), 1)
    reads = np.full((B, m), 4, np.int32)
    refs = np.full((B, n), 5, np.int32)
    for b, (r, w) in enumerate(cands):
        reads[b, :len(r)] = r
        refs[b, :len(w)] = w
    rl = np.array([len(c[0]) for c in cands], np.int32)
    nl = np.array([len(c[1]) for c in cands], np.int32)
    return reads, rl, refs, nl


BATCH_FORMS = [(4, 8), (7, 8), (10, 8), (13, 8), (4, 32), (8, 32), (16, 32),
               (24, 32), (32, 32)]


@pytest.mark.parametrize("R,G", BATCH_FORMS,
                         ids=[f"{g}x{r}" for r, g in BATCH_FORMS])
@pytest.mark.parametrize("seed", [0, 1])
def test_batch_wavefront_emulation(R, G, seed):
    """Every thread form of sw_batch, at 8 threads a candidate and at a
    whole warp, a full warp and one with a missing last candidate, reads
    from 0 bases to the form's R x G rows (150 at the most), against the
    plain anti-diagonal sweep."""
    rng = np.random.default_rng(1000 * G + 10 * R + seed)
    nseg = T // G
    rows = min(R * G, 150)
    top = 0
    for n_cands in sorted({nseg, max(nseg - 1, 1)}):
        cands = _batch_candidates(rng, n_cands, rows)
        got = emulate_batch(R, G, cands, **SW)
        reads, rl, refs, nl = _batch_plain(cands)
        want = sw_score_batch_ref(*(torch.from_numpy(a) for a in (
            reads, rl, refs, nl)), **SW).numpy()
        np.testing.assert_array_equal(got, want)
        top = max(top, int(want[:, 0].max()))
    assert top >= min(rows, 10) - 4      # real alignments were scored


@pytest.mark.parametrize("R,G", [(13, 8), (4, 32)], ids=["8x13", "32x4"])
def test_batch_wavefront_emulation_equals_pallas(R, G):
    """The two forms a 100 bp read takes, 100 bp reads in 150-column
    windows, against the Pallas anti-diagonal kernel in interpret mode."""
    rng = np.random.default_rng(77 + G)
    cands = []
    for c in range(T // G):
        win = rng.integers(0, 4, 150).astype(np.int64)
        o = int(rng.integers(0, 50))
        read = win[o:o + 100].copy()
        read[rng.integers(0, 100, 3)] ^= 2
        if c % 2:
            read = np.concatenate([read[:40], read[42:], [1, 2]])
        cands.append((read, win))
    got = emulate_batch(R, G, cands, **SW)
    reads, rl, refs, nl = _batch_plain(cands)
    want = sw_score_batch_pallas(*(jnp.asarray(a) for a in (
        reads, rl, refs, nl)), interpret=True, **SW)
    for col, k in enumerate(KEYS):
        np.testing.assert_array_equal(got[:, col], np.asarray(want[k]), k)
    assert int(got[:, 0].min()) >= 60


# ----------------------------------------------------------------------
# sw_banded16_kernel<H, SEGW, 1>
# ----------------------------------------------------------------------

def _pk(lo, hi):
    return ((np.asarray(lo, np.int64) & 0xffff)
            | ((np.asarray(hi, np.int64) & 0xffff) << 16)).astype(U32)


def _lo16(x):
    return (np.asarray(x, U32) & 0xffff).astype(np.uint16).astype(
        np.int16).astype(np.int64)


def _hi16(x):
    return (np.asarray(x, U32) >> 16).astype(np.uint16).astype(
        np.int16).astype(np.int64)


def _vadd2(a, b):
    """Per-half add, wrapping at 16 bits."""
    return _pk(_lo16(a) + _lo16(b), _hi16(a) + _hi16(b))


def _vsub2(a, b):
    return _pk(_lo16(a) - _lo16(b), _hi16(a) - _hi16(b))


def _sel(m, a, b):
    m = np.asarray(m, U32)
    return (np.asarray(a, U32) & m) | (np.asarray(b, U32) & ~m)


def _vmaxs2(a, b):
    return _pk(np.maximum(_lo16(a), _lo16(b)), np.maximum(_hi16(a), _hi16(b)))


def _max_ge(a, b):
    """max_ge of csrc/sw_banded16.cu: (per-half max, 0xffff where a >= b
    by the sign of the wrapped difference, spread by a byte permute)."""
    return _vmaxs2(a, b), ~prmt(_vsub2(a, b), 0, 0xbb99)


def _ge_mask(a, b):
    """0xffff in each half where a >= b, by the compare."""
    return _pk(np.where(_lo16(a) >= _lo16(b), -1, 0),
               np.where(_hi16(a) >= _hi16(b), -1, 0))


def _base_selector(c):
    byte = np.minimum(np.asarray(c, np.int64), 4)
    return (byte | ((8 | byte) << 4)).astype(U32)


def emulate_banded16(H, SEGW, cands, match, mismatch, gap_open, gap_extend,
                     clip):
    """``cands``: up to 32 / SEGW tuples (read codes, window codes, wl);
    returns their (score, qb, qe, ref_end) rows as the kernel writes
    them."""
    nseg = T // SEGW
    assert len(cands) <= nseg
    t = np.arange(T)
    sl, seg = t % SEGW, t // SEGW
    live = seg < len(cands)
    rl = np.array([len(cands[s][0]) if s < len(cands) else 0 for s in seg])
    nl = np.array([len(cands[s][1]) if s < len(cands) else 0 for s in seg])
    wl = np.array([cands[s][2] if s < len(cands) else 0 for s in seg])
    ge = gap_extend
    k0 = sl * 2 * H
    lanes = 2 * H * SEGW

    mx = _max_ge

    def read_at(i):
        return np.array([cands[s][0][i - 1] if live[th] and i <= rl[th]
                         else 4 for th, s in enumerate(seg)])

    def text_at(c):
        return np.array([cands[s][1][c[th]] if live[th]
                         and 0 <= c[th] < nl[th] else 5
                         for th, s in enumerate(seg)])

    NEGP = _pk(NEG16, NEG16)
    ngoep = _pk(-gap_open - ge, -gap_open - ge)
    ngep = _pk(-ge, -ge)
    clipp = _pk(-clip, -clip)
    last_row = np.minimum(rl, nl)
    rows = last_row.copy()
    off = SEGW
    while off < 32:
        rows = np.maximum(rows, _shfl_xor(rows, off))
        off <<= 1
    full_rows = np.minimum(nl - wl + 1, last_row)

    def arr(fill):
        return np.full((T, H), fill, U32)

    Hp, Fp, SHp, SFp = arr(NEGP), arr(NEGP), arr(0), arr(0)
    BV, BI, BS = arr(NEGP), arr(0), arr(0)
    S, VK, KEP, NKEG = arr(0), arr(0), arr(0), arr(0)
    for j in range(H):
        kl, kh = k0 + j, k0 + H + j
        VK[:, j] = _pk(np.where(kl < wl, -1, 0), np.where(kh < wl, -1, 0))
        KEP[:, j] = _pk(kl * ge, kh * ge)
        NKEG[:, j] = _pk(-kl * ge - gap_open, -kh * ge - gap_open)
        S[:, j] = _base_selector(text_at(kl)) | (
            _base_selector(text_at(kh)) << 8)
    VM = VK.copy()
    nbuf = np.zeros(T, U32)

    for i in range(1, int(rows[0]) + 1):
        if (i - 1) % SEGW == 0:
            nbuf = _base_selector(text_at(i + sl + lanes - 1))
        s_in = _shfl_idx(nbuf, (i - 1) % SEGW, SEGW)
        nH, nF = _shfl_down(Hp[:, 0], 1, SEGW), _shfl_down(Fp[:, 0], 1, SEGW)
        nSH = _shfl_down(SHp[:, 0], 1, SEGW)
        nSF = _shfl_down(SFp[:, 0], 1, SEGW)
        nS = _shfl_down(S[:, 0], 1, SEGW)
        edge = sl == SEGW - 1
        nH, nF = np.where(edge, NEGP, nH), np.where(edge, NEGP, nF)
        nSH, nSF = np.where(edge, 0, nSH), np.where(edge, 0, nSF)
        nS = np.where(edge, s_in, nS).astype(U32)
        F0, SF0, S0 = Fp[:, 0].copy(), SFp[:, 0].copy(), S[:, 0].copy()
        row_ok = i <= last_row
        rc = np.where(row_ok, read_at(i), 4)
        lut = score_word(rc, match, mismatch)
        freshp = 0 if i == 1 else clipp
        endp = np.where(i == rl, 0, clipp).astype(U32)
        rowp, prevp = _pk(i, i), _pk(i - 1, i - 1)
        tail = i > full_rows
        lim = np.where(row_ok, nl - i + 1, 0)
        for j in range(H):
            kl, kh = k0 + j, k0 + H + j
            vm = VK[:, j] & _pk(np.where(kl < lim, -1, 0),
                                np.where(kh < lim, -1, 0))
            VM[:, j] = np.where(tail, vm, VM[:, j])

        HD, SD, H0, S0s, A = arr(0), arr(0), arr(0), arr(0), arr(0)
        aggP, aggS = np.full(T, NEGP, U32), np.zeros(T, U32)
        for j in range(H):                      # part 1
            sub = prmt(lut, 0xffffffff, S[:, j])
            if j + 1 < H:
                hn, fn = Hp[:, j + 1], Fp[:, j + 1]
                shn, sfn = SHp[:, j + 1], SFp[:, j + 1]
                S[:, j] = S[:, j + 1]
            else:
                hn, fn = prmt(Hp[:, 0], nH, 0x5432), prmt(
                    F0, nF, 0x5432)
                shn = prmt(SHp[:, 0], nSH, 0x5432)
                sfn = prmt(SF0, nSF, 0x5432)
                S[:, j] = prmt(S0, nS, 0x0041)
            f, mf = mx(_vadd2(hn, ngoep), _vadd2(fn, ngep))
            sf = _sel(mf, shn, sfn)
            Fp[:, j], SFp[:, j] = f, sf
            m, md = mx(Hp[:, j], freshp)
            hd = _vadd2(m, sub)
            sd = _sel(md, SHp[:, j], prevp)
            h0, mh = mx(hd, f)
            s0 = _sel(mh, sd, sf)
            a = _vadd2(h0, KEP[:, j])
            HD[:, j], SD[:, j], H0[:, j], S0s[:, j] = hd, sd, h0, s0
            A[:, j] = a
            aggP, ma = mx(a, aggP)
            aggS = _sel(ma, s0, aggS)

        aLo, aHi = _lo16(aggP), _hi16(aggP)
        tP = np.where(aHi >= aLo, aHi, aLo)
        tS = np.where(aHi >= aLo, _hi16(aggS), _lo16(aggS))
        off = 1                                  # scan_carries<SEGW>
        while off < SEGW:
            oP, oS = _shfl_up(tP, off, SEGW), _shfl_up(tS, off, SEGW)
            take = (sl >= off) & (oP > tP)
            tP, tS = np.where(take, oP, tP), np.where(take, oS, tS)
            off <<= 1
        XP = np.where(sl == 0, NEG16, _shfl_up(tP, 1, SEGW))
        XS = np.where(sl == 0, 0, _shfl_up(tS, 1, SEGW))
        YP = np.where(XP > aLo, XP, aLo)
        YS = np.where(XP > aLo, XS, _lo16(aggS))
        P, PS = _pk(XP, YP), _pk(XS, YS)

        for j in range(H):                      # part 2
            f, sf = Fp[:, j].copy(), SFp[:, j]
            e = _vadd2(P, NKEG[:, j])
            ef, m1 = mx(e, f)
            _, m2 = mx(HD[:, j], ef)
            h = _vmaxs2(H0[:, j], e)
            sh = _sel(m2, SD[:, j], _sel(m1, PS, sf))
            P, ma = mx(A[:, j], P)
            PS = _sel(ma, S0s[:, j], PS)
            Hp[:, j] = _sel(VM[:, j], h, NEGP)
            Fp[:, j] = _sel(VM[:, j], f, NEGP)
            SHp[:, j] = sh
            cand = _sel(VM[:, j], _vadd2(h, endp), NEGP)
            BV[:, j], keep = mx(BV[:, j], cand)
            BI[:, j] = _sel(keep, BI[:, j], rowp)
            BS[:, j] = _sel(keep, BS[:, j], sh)

    best = [np.full(T, NEG16, np.int64)] + [np.zeros(T, np.int64)
                                            for _ in range(4)]  # v d i x s
    for j in range(H):
        for half, k in ((_lo16, k0 + j), (_hi16, k0 + H + j)):
            bi = half(BI[:, j])
            offer = [half(BV[:, j]), 2 * bi + k, bi, k, half(BS[:, j])]
            take = _better(offer[0], offer[1], offer[2], *best[:3])
            best = [np.where(take, o, b) for o, b in zip(offer, best)]
    off = SEGW // 2
    while off > 0:
        other = [_shfl_xor(b, off) for b in best]
        take = _better(other[0], other[1], other[2], *best[:3])
        best = [np.where(take, o, b) for o, b in zip(other, best)]
        off >>= 1
    v, _, bi, bx, bs = best
    v = np.where(v <= NEG16 // 2, NEG, v)
    return np.array([[v[s * SEGW], bs[s * SEGW], bi[s * SEGW],
                      bi[s * SEGW] + bx[s * SEGW]]
                     for s in range(len(cands))], np.int64)


def _banded_plain(cands, W):
    n_cands = len(cands)
    m = max(max(len(c[0]) for c in cands), 1)
    n = max(len(c[1]) for c in cands)
    reads = np.full((n_cands, m), 4, np.int32)
    refs = np.full((n_cands, n), 5, np.int32)
    for b, (r, w, _) in enumerate(cands):
        reads[b, :len(r)] = r
        refs[b, :len(w)] = w
    rl = np.array([len(c[0]) for c in cands], np.int32)
    nl = np.array([len(c[1]) for c in cands], np.int32)
    wl = np.array([c[2] for c in cands], np.int32)
    return reads, rl, refs, nl, wl


BANDED16_FORMS = [(1, 16), (2, 8), (1, 32), (4, 8), (2, 32), (3, 16),
                  (4, 32)]


@pytest.mark.parametrize("H,SEGW", BANDED16_FORMS,
                         ids=[f"{s}x{2 * h}" for h, s in BANDED16_FORMS])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_banded16_row_sweep_emulation(H, SEGW, seed):
    """Every one-warp form the classes of at most 256 lanes take (8, 16
    and 32 threads a candidate), a full warp
    and one with a missing last candidate, against the plain int16 row
    sweep."""
    rng = np.random.default_rng(100 * SEGW + 10 * H + seed)
    nseg = T // SEGW
    W = 2 * H * SEGW
    top = 0
    for n_cands in sorted({nseg, max(nseg - 1, 1)}):
        cands = _warp_candidates(rng, n_cands, W)
        got = emulate_banded16(H, SEGW, cands, **SW)
        reads, rl, refs, nl, wl = _banded_plain(cands, W)
        want = sw_score_banded16_ref(
            *(torch.from_numpy(a) for a in (reads, rl, refs, nl)), W,
            wl=torch.from_numpy(wl), **SW).numpy()
        np.testing.assert_array_equal(got, want)
        top = max(top, int(want[:, 0].max()))
    assert top >= 6                      # real alignments were scored


def test_banded16_row_sweep_emulation_equals_pallas16():
    """The form of the usual chained call (8 threads x 8 lanes, corridors
    of 50) against the Pallas int16 kernel in interpret mode, with windows
    of rl + wl columns (no tail row) and shorter ones (tail rows)."""
    rng = np.random.default_rng(5)
    cands = []
    for c in range(4):
        m, wl = 60, 50
        win = rng.integers(0, 4, m + wl + 8).astype(np.int64)
        o = int(rng.integers(0, wl - 2))
        read = win[o:o + m].copy()
        read[rng.integers(0, m, 2)] ^= 1
        if c == 1:
            read = np.concatenate([read[:30], read[31:], [3]])
        n = m + wl if c < 2 else m + wl - 25
        cands.append((read, win[:n], wl))
    got = emulate_banded16(4, 8, cands, **SW)
    reads, rl, refs, nl, wl = _banded_plain(cands, 64)
    want = sw_score_banded_pallas16(
        *(jnp.asarray(a) for a in (reads, rl, refs, nl)), 128,
        interpret=True, wl=jnp.asarray(wl), **SW)
    for col, k in enumerate(KEYS):
        np.testing.assert_array_equal(got[:, col], np.asarray(want[k]), k)
    assert int(got[:, 0].min()) >= 20


def test_sign_mask_needs_the_range_check():
    """The sign-of-difference mask is the compare only while the halves'
    difference stays within int16, which the host's range check
    (ops/sw._check_int16_range) guarantees; past it the subtraction wraps
    and the two part."""
    a, b = _pk(100, -20000), _pk(-16391, 8191)
    assert (_max_ge(a, b)[1] == _ge_mask(a, b)).all()
    a, b = _pk(20000, -5), _pk(-20000, 7)
    assert (_lo16(_max_ge(a, b)[1]) != _lo16(_ge_mask(a, b))).all()
    assert (_hi16(_max_ge(a, b)[1]) == _hi16(_ge_mask(a, b))).all()


@pytest.mark.parametrize("scorer", ["scan", "banded16", "packed"])
@pytest.mark.parametrize("scores", [dict(match=128), dict(mismatch=128),
                                    dict(match=-128)],
                         ids=["match128", "mismatch128", "match-128"])
def test_byte_scores_are_checked_on_either_device(scorer, scores):
    """sw_batch, sw_banded16 and sw_banded_packed look the substitution
    score up as a signed byte, so gather_score refuses a match or mismatch
    beyond +-127 under their scorers wherever the tensors lie; +-127
    itself and the banded scorer pass."""
    rng = np.random.default_rng(5)
    c = _t(_inputs(rng, np.full(6, 8, np.int32)))
    kw = dict(SW, **scores)
    with pytest.raises(ValueError, match="signed byte"):
        gather_score(*c, scorer=scorer, **kw)
    edge = {k: 127 if v > 0 else -127 for k, v in scores.items()}
    gather_score(*c, scorer="scan", **dict(SW, **edge))
    want = gather_score_ref(*c, scorer="banded", **kw)
    np.testing.assert_array_equal(
        gather_score(*c, scorer="banded", **kw).numpy(), want.numpy())


# ----------------------------------------------------------------------
# banded16 by corridor-width class
# ----------------------------------------------------------------------

@pytest.mark.parametrize("sort_pays", [0, None], ids=["sorted", "default"])
@pytest.mark.parametrize("name", list(WIDTH_SETS))
def test_banded16_class_launches_give_the_one_call_result(name, sort_pays):
    """The plain int16 version run class by class through the launch's
    permutation, spans and scatter-back equals one plain call, row for
    row in the caller's order."""
    rng = np.random.default_rng(14)
    wl = np.asarray(WIDTH_SETS[name](rng), np.int32)
    rng.shuffle(wl)
    c = _inputs(rng, wl)
    got = gather_score_by_class_ref(*_t(c), sort_pays=sort_pays,
                                    scorer="banded16", **SW)
    want = gather_score_ref(*_t(c), scorer="banded16", **SW)
    assert got.dtype == torch.int32 and got.shape == (len(wl), 4)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_banded16_class_launches_equal_the_jax_gather():
    """The same candidates through the JAX package's gather
    (ema_tpu/core/pipeline.py:_gather_score, whose banded16 branch calls
    the Pallas int16 kernel; run here in interpret mode, one band for the
    whole call)."""
    rng = np.random.default_rng(16)
    wl = np.concatenate([50 + rng.geometric(0.35, 60) - 1,
                         rng.integers(64, 251, 12), [1, 32, 33, 300]])
    c = _inputs(rng, wl.astype(np.int32))
    got = gather_score_by_class_ref(*_t(c), sort_pays=0, scorer="banded16",
                                    **SW).numpy()
    w_max = -(-int(c["win_len"].max()) // 64) * 64
    w_band = -(-int(c["wl"].max()) // 128) * 128
    # the gather of _gather_score, line for line
    text, n = jnp.asarray(c["text"]), c["text"].shape[0]
    reads = jnp.asarray(c["oriented"])[c["owners"]].astype(jnp.int32)
    cols = jnp.asarray(c["win_lo"])[:, None] + jnp.arange(w_max)
    wins = jnp.where((cols < 0) | (cols >= n), 5,
                     text[jnp.clip(cols, 0, n - 1)].astype(jnp.int32))
    want = sw_score_banded_pallas16(
        reads, jnp.asarray(c["olens"][c["owners"]]), wins,
        jnp.asarray(c["win_len"]), w_band=w_band, wl=jnp.asarray(c["wl"]),
        interpret=True, **SW)
    for col, k in enumerate(KEYS):
        np.testing.assert_array_equal(got[:, col], np.asarray(want[k]), k)


# ----------------------------------------------------------------------
# sw_banded_packed_kernel<LPT, SEGW>
# ----------------------------------------------------------------------

def emulate_packed(LPT, SEGW, text, cands, match, mismatch, gap_open,
                   gap_extend, clip):
    """``cands``: up to 32 / SEGW tuples (read codes, win_lo, win_len, wl)
    over ``text`` (columns outside it read 5); returns their (score, qb,
    qe, ref_end) rows as csrc/sw_banded_packed.cu writes them: selector
    nibbles that slide by a funnel shift, four scores a prmt and one
    sign-spreading prmt a lane, shuffles at the segment's width, the
    static and tail-row lane masks and per-lane bests."""
    nseg = T // SEGW
    assert LPT * SEGW == 64 and len(cands) <= nseg
    t = np.arange(T)
    sl, seg = t % SEGW, t // SEGW
    live = seg < len(cands)

    def per(i, fill=0):
        return np.array([(len(cands[s][0]) if i < 0 else cands[s][i])
                         if live[th] else fill for th, s in enumerate(seg)],
                        np.int64)

    rl, lo, nl, wl = per(-1), per(1), per(2), per(3)
    ge, goe = gap_extend, gap_open + gap_extend
    lanes = sl[:, None] * LPT + np.arange(LPT)[None, :]       # k, [T, LPT]
    nib0 = 8 - LPT

    def text_at(col):
        ok = (col >= 0) & (col < len(text))
        return np.where(ok, text[np.clip(col, 0, len(text) - 1)], 5)

    def nibble(c):
        return np.minimum(c, 4).astype(U32)

    def read_at(i):
        return np.array([cands[s][0][i - 1] if live[th] and i <= rl[th]
                         else 4 for th, s in enumerate(seg)])

    last_row = np.minimum(rl, nl)
    rows = last_row.copy()
    off = SEGW
    while off < 32:
        rows = np.maximum(rows, _shfl_xor(rows, off))
        off <<= 1
    full_rows = np.minimum(nl - wl + 1, last_row)

    Hp, Fp = np.full((T, LPT), NEG, np.int64), np.full((T, LPT), NEG, np.int64)
    SHp, SFp = np.zeros((T, LPT), np.int64), np.zeros((T, LPT), np.int64)
    BV = np.full((T, LPT), NEG, np.int64)
    BI, BS = np.zeros((T, LPT), np.int64), np.zeros((T, LPT), np.int64)
    KE, NKEG = lanes * ge, -lanes * ge - gap_open
    VK = lanes < wl[:, None]
    VM = VK.copy()
    sel = np.zeros(T, U32)
    for j in range(LPT):
        sel |= nibble(text_at(lo + lanes[:, j])) << U32(4 * (nib0 + j))
    nbuf = np.full(T, 4, U32)

    for i in range(1, int(rows[0]) + 1):
        if (i - 1) % SEGW == 0:
            nbuf = nibble(text_at(lo + i + sl + 63))
        s_in = _shfl_idx(nbuf, (i - 1) % SEGW, SEGW)
        sel_lo = sel >> U32(16) if LPT == 4 else sel
        nH, nF = _shfl_down(Hp[:, 0], 1, SEGW), _shfl_down(Fp[:, 0], 1, SEGW)
        nSH = _shfl_down(SHp[:, 0], 1, SEGW)
        nSF = _shfl_down(SFp[:, 0], 1, SEGW)
        nsel = _shfl_down(sel_lo, 1, SEGW)
        edge = sl == SEGW - 1
        nH, nF = np.where(edge, NEG, nH), np.where(edge, NEG, nF)
        nSH, nSF = np.where(edge, 0, nSH), np.where(edge, 0, nSF)
        nsel = np.where(edge, s_in, nsel).astype(U32)
        row_ok = i <= last_row
        lut = score_word(np.where(row_ok, read_at(i), 4), match, mismatch)
        sub4 = [prmt(lut, 0xffffffff, sel_lo)]
        if LPT == 8:
            sub4.append(prmt(lut, 0xffffffff, sel >> U32(16)))
        sel = _funnel_r(sel, nsel, 4)
        fresh = 0 if i == 1 else -clip
        endp = np.where(i == rl, 0, -clip)
        lim = np.where(row_ok, nl - i + 1, 0)
        VM = np.where((i > full_rows)[:, None], VK & (lanes < lim[:, None]),
                      VM)

        HD, SD, H0, S0, A = (np.zeros((T, LPT), np.int64) for _ in range(5))
        aggP, aggS = np.full(T, NEG, np.int64), np.zeros(T, np.int64)
        for j in range(LPT):                     # part 1
            sub = _i32(prmt(sub4[j >> 2], 0, _sext_byte(j & 3)))
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
            HD[:, j], SD[:, j], H0[:, j], S0[:, j], A[:, j] = hd, sd, h0, s0, a
            take = a >= aggP
            aggP, aggS = np.where(take, a, aggP), np.where(take, s0, aggS)

        off = 1                                  # scan_carries<SEGW>
        while off < SEGW:
            oP, oS = _shfl_up(aggP, off, SEGW), _shfl_up(aggS, off, SEGW)
            take = (sl >= off) & (oP > aggP)
            aggP, aggS = np.where(take, oP, aggP), np.where(take, oS, aggS)
            off <<= 1
        P = np.where(sl == 0, NEG, _shfl_up(aggP, 1, SEGW))
        PS = np.where(sl == 0, 0, _shfl_up(aggS, 1, SEGW))

        for j in range(LPT):                     # part 2
            f, sf = Fp[:, j].copy(), SFp[:, j]
            e = P + NKEG[:, j]
            ef = np.where(e >= f, e, f)
            h = np.where(H0[:, j] >= e, H0[:, j], e)
            sh = np.where(HD[:, j] >= ef, SD[:, j], np.where(e >= f, PS, sf))
            take = A[:, j] >= P
            P, PS = np.where(take, A[:, j], P), np.where(take, S0[:, j], PS)
            Hp[:, j] = np.where(VM[:, j], h, NEG)
            Fp[:, j] = np.where(VM[:, j], f, NEG)
            SHp[:, j] = sh
            cand = Hp[:, j] + endp
            up = cand > BV[:, j]
            BV[:, j] = np.where(up, cand, BV[:, j])
            BI[:, j] = np.where(up, i, BI[:, j])
            BS[:, j] = np.where(up, sh, BS[:, j])

    best = [np.full(T, NEG, np.int64)] + [np.zeros(T, np.int64)
                                          for _ in range(4)]  # v d i x s
    for j in range(LPT):
        k = lanes[:, j]
        offer = [BV[:, j], 2 * BI[:, j] + k, BI[:, j], k, BS[:, j]]
        take = _better(offer[0], offer[1], offer[2], *best[:3])
        best = [np.where(take, o, b) for o, b in zip(offer, best)]
    off = SEGW // 2
    while off > 0:
        other = [_shfl_xor(b, off) for b in best]
        take = _better(other[0], other[1], other[2], *best[:3])
        best = [np.where(take, o, b) for o, b in zip(other, best)]
        off >>= 1
    v, _, bi, bx, bs = best
    return np.array([[v[s * SEGW], bs[s * SEGW], bi[s * SEGW],
                      bi[s * SEGW] + bx[s * SEGW]]
                     for s in range(len(cands))], np.int64)


def _packed_text(rng, n=1500):
    text = rng.integers(0, 4, n).astype(np.uint8)
    text[n // 2:n // 2 + 12] = 4                        # a run of N bases
    return text


def _packed_candidates(rng, text, n_cands, m_max, m_min=None):
    """Candidates for one warp over ``text``: reads of mixed lengths (one
    of length 0) planted with a substitution, a deletion and an N, corridors
    of 64 and 1 among them, windows short enough for tail rows
    (win_len < rl + wl - 1) and windows that run off either end of the
    text."""
    n = len(text)
    cands = []
    for c in range(n_cands):
        if m_min is None:
            m_min = max(m_max // 3, 2)
        m = 0 if c == 1 else int(rng.integers(m_min, m_max + 1))
        wl = (64, 40, 1, int(rng.integers(1, 65)))[c % 4]
        o = int(rng.integers(0, wl))
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
        nl = m + wl + int(rng.integers(-2, 30))
        if c % 4 == 2 or c % 7 == 3:       # tail rows
            nl = max(m + wl - 1 - int(rng.integers(1, 25)), 1)
        cands.append((read, p - o, max(nl, 1), wl))
    return cands


PACKED_FORMS = [(4, 16), (8, 8)]


@pytest.mark.parametrize("LPT,SEGW", PACKED_FORMS,
                         ids=[f"{s}x{lpt}" for lpt, s in PACKED_FORMS])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_packed_row_sweep_emulation(LPT, SEGW, seed):
    """Both thread forms of sw_banded_packed, a full warp and one with a
    missing last candidate (an odd N: a half-filled last warp), against
    the plain packed tier through the gather."""
    rng = np.random.default_rng(300 + 10 * SEGW + seed)
    text = _packed_text(rng)
    nseg = T // SEGW
    top = 0
    for n_cands in (nseg, nseg - 1):
        cands = _packed_candidates(rng, text, n_cands, 60)
        got = emulate_packed(LPT, SEGW, text, cands, **SW)
        want = gather_score_ref(*_t(_packed_inputs(text, cands)),
                                scorer="packed", **SW).numpy()
        np.testing.assert_array_equal(got, want)
        top = max(top, int(want[:, 0].max()))
    assert top >= 20                     # real alignments were scored


@pytest.mark.parametrize("LPT,SEGW", PACKED_FORMS,
                         ids=[f"{s}x{lpt}" for lpt, s in PACKED_FORMS])
def test_packed_row_sweep_emulation_past_256(LPT, SEGW):
    """Reads of up to 300 bases whose alignments start past row 256:
    start rows are kept whole (the JAX kernel keeps them modulo 256), as
    the plain packed tier keeps them."""
    rng = np.random.default_rng(40 + SEGW)
    text = _packed_text(rng, 2500)
    cands = _packed_candidates(rng, text, T // SEGW, 300, m_min=280)
    for read, *_ in cands:
        read[:262] = rng.integers(0, 4, min(len(read), 262))  # tails align
    got = emulate_packed(LPT, SEGW, text, cands, **SW)
    want = gather_score_ref(*_t(_packed_inputs(text, cands)),
                            scorer="packed", **SW).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[:, 1] > 256).any()       # a start row past 256 was kept


def test_packed_row_sweep_emulation_equals_pallas_packed():
    """Both forms on one set (reads under 256 bases) against the JAX
    package's pair-packed Pallas kernel in interpret mode, fed by the
    gather of ema_tpu/core/pipeline.py:_gather_score."""
    rng = np.random.default_rng(9)
    text = _packed_text(rng)
    cands = _packed_candidates(rng, text, 4, 80)
    c = _packed_inputs(text, cands)
    w_max = int(c["win_len"].max())
    cols = c["win_lo"][:, None] + np.arange(w_max)[None, :]
    wins = np.where((cols < 0) | (cols >= len(text)), 5,
                    text[np.clip(cols, 0, len(text) - 1)]).astype(np.int32)
    want = sw_score_banded_pallas_packed(
        jnp.asarray(c["oriented"].astype(np.int32)),
        jnp.asarray(c["olens"]), jnp.asarray(wins),
        jnp.asarray(c["win_len"]), jnp.asarray(c["wl"]), interpret=True,
        **SW)
    for LPT, SEGW in PACKED_FORMS:
        got = np.concatenate([
            emulate_packed(LPT, SEGW, text, cands[s:s + T // SEGW], **SW)
            for s in range(0, len(cands), T // SEGW)])
        for col, k in enumerate(KEYS):
            np.testing.assert_array_equal(got[:, col], np.asarray(want[k]),
                                          f"{SEGW}x{LPT} {k}")
    assert int(np.asarray(want["score"]).max()) >= 20


@pytest.mark.parametrize("LPT,SEGW", PACKED_FORMS,
                         ids=[f"{s}x{lpt}" for lpt, s in PACKED_FORMS])
def test_packed_row_sweep_emulation_keeps_the_tie_rules(LPT, SEGW):
    """Both forms on the candidates whose outputs the tie rules decide."""
    for scoring, B, picks in TIE_SETS:
        text, cands = _tie_batch(B, picks)
        got = np.concatenate([
            emulate_packed(LPT, SEGW, text, cands[s:s + T // SEGW],
                           **scoring)
            for s in range(0, len(cands), T // SEGW)])
        want = gather_score_ref(*_t(_packed_inputs(text, cands)),
                                scorer="packed", **scoring).numpy()
        np.testing.assert_array_equal(got, want)
