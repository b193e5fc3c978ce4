"""The align pipeline on one torch device: batched candidate generation +
per-barcode EM.  The counterpart of ema_tpu/core/pipeline.py:191-1311.

Stage layout (stage names as in the JAX package's Metrics):

  1. encode reads (host); revcomp rows derived on the device
  2. seed: seed[smem,host] (SMEM enumeration + re-seeding, native C++), or
     greedy seeding as seed[native,host] or seed+locate[device]
     (index/fm.seed_locate_reads; seed[device] when the hits overflow
     its budget)
  3. locate: locate[native,host] (native C++) or locate[device]
     (index/fm.locate)
  4. chain[host]: ops/chaining.py
  5. sw[device]: banded SW of every candidate window (ops/sw.gather_score:
     the CUDA kernel on a GPU, its plain version on the CPU)
  6. mate rescue windows + a second sw[device] pass
  7. traceback+finalize[host]: CIGARs for survivors (native C++)
  8. em[device] (core/em.dispatch_em_batch: em.pack, then em.launch of
     the cloud-EM kernel, queued before the previous batch's emission and
     waited for after it) or em[host] (groups.run_em_host_batch)
  9. select+emit[host]: selection + SAM emission

The Aligner takes the JAX Aligner's choices (pipeline.py:198-386):
``RunConfig(device_em=...)`` (``resolve_device_em``),
``RunConfig(aligner=AlignerParams(seeding="smem"|"greedy"))``,
``Aligner(seed_impl=...)`` or EMA_TPU_SEED_IMPL=native|device for where
greedy seeding and locate run (``resolve_seed_impl``), and
``Aligner(sw_impl=...)`` or EMA_TPU_SW_IMPL / EMA_TPU_SW_TIER64 for the
SW scorer (``resolve_sw_impl``).  The device defaults to ``"cuda"`` and
raises where there is no card; with ``device="cpu"`` the device paths
run their torch code on the CPU.

Everything but the device code is the port's own copy of the JAX
package's host code (``native``, ``core/groups.py``, ``core/samout.py``,
``ops/chaining.py``, ...); the numpy helpers that live in
ema_tpu/core/pipeline.py are copied here under their names, and so are
the hooks of the -x CLI (``cloud_id_base``, ``group_sink``,
``replay_sink``) and the contig-sharded ``ShardedAligner``.  Dropped from
the JAX Aligner: compile-shape bucketing and the padded row layout with
its ``row_map`` (torch runs eagerly, so owners index the oriented rows
directly), the CPU placement of the jitted EM and the 128 MB occ rule for
device locate (``resolve_seed_impl``).

``Aligner(devices=[...])`` splits the three batched device calls (the
fused seed+locate, device locate and the SW scoring) over a data mesh
(``_init_mesh``, ema_tpu/core/pipeline.py:278-309): the rows go in
contiguous blocks, of sizes that differ by at most one, to the mesh's
cells, each on its device and stream, and come back in row order, so the
output equals the one-device run's byte for byte.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import time
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from ema_tpu_torch import config, native
from ema_tpu_torch.core import groups as groups_mod
from ema_tpu_torch.core import samout
from ema_tpu_torch.core import score as score_mod
from ema_tpu_torch.core.records import empty_records
from ema_tpu_torch.ops import chaining
from ema_tpu_torch.core.batch import CandidateSet, ReadBatch
from ema_tpu_torch.core.em import dispatch_em_batch
from ema_tpu_torch.index import fm
from ema_tpu_torch.index.device import DeviceState, to_device_state
from ema_tpu_torch.ops.sw import PACKED_MAX_WL, gather_score
from ema_tpu_torch.parallel.mesh import DATA_AXIS, make_mesh
from ema_tpu_torch.utils.backend import _tune_malloc, resolve_device
from ema_tpu_torch.utils.metrics import new_batch_id

WINDOW_PAD = 24          # slack around the chain diagonal for the SW window
MAX_CIGAR_OPS = 64
SW_CHUNK = 16 * 4096     # max candidate pairs per SW device call
TIER64_MIN = 256         # fewest small corridors worth a split call
LOCATE_CHUNK = 8 * 8192  # max rows per device locate call
MAX_SEEDS = 16           # greedy seeds per read
SEED_IMPLS = ("native", "device")
SEEDINGS = ("smem", "greedy")

# Aligner scorer -> gather_score scorer (native scores on the host)
SW_IMPLS = {"banded": "banded", "tier64": "banded", "banded16": "banded16",
            "scan": "scan", "native": None}


def resolve_sw_impl(sw_impl: Optional[str] = None) -> str:
    """The Aligner's SW scorer: banded, tier64, banded16, scan or native.

    ``None`` reads the JAX package's switches (ema_tpu/core/pipeline.py:
    311-340 and 262-274): EMA_TPU_SW_IMPL=scan|banded|banded_pallas|
    banded16|native (any other value, or none, means banded), then
    EMA_TPU_SW_TIER64=1 turns the banded scorer into tier64.  banded and
    banded_pallas both mean the sw_banded kernel, which is the default on
    every device.
    """
    if sw_impl is None:
        env = os.environ.get("EMA_TPU_SW_IMPL")
        sw_impl = env if env in ("scan", "banded", "banded_pallas",
                                 "banded16", "native") else "banded"
        if sw_impl in ("banded", "banded_pallas") \
                and os.environ.get("EMA_TPU_SW_TIER64", "0") == "1":
            sw_impl = "tier64"
    if sw_impl == "banded_pallas":
        sw_impl = "banded"
    if sw_impl not in SW_IMPLS:
        raise ValueError(f"unknown sw_impl {sw_impl!r} (one of "
                         f"{', '.join(SW_IMPLS)}, banded_pallas)")
    return sw_impl


def resolve_seed_impl(seed_impl: Optional[str] = None) -> str:
    """Where greedy seeding and locate run: native (host C++) or device
    (index/fm on the Aligner's device).

    ``None`` reads EMA_TPU_SEED_IMPL=native|device; anything else, or
    nothing, means native on every device.  The JAX package moves to the
    device once the occ table passes 128 MB (ema_tpu/core/pipeline.py:
    366-386), but on an H100 80GB HBM3 at 700 W the torch locate, with
    its upload and readback, was slower than native at sa_rate 4, the
    rate of every index that large: 5.61 ms against 4.95 ms for 46,171
    rows of a 200 Mbp index with 150 MB of occ (PERF.md).  So the device
    is an explicit choice.  SMEM seeding always runs on the host; only
    its locate follows this choice.
    """
    if seed_impl is None:
        env = os.environ.get("EMA_TPU_SEED_IMPL")
        seed_impl = env if env in SEED_IMPLS else "native"
    if seed_impl not in SEED_IMPLS:
        raise ValueError(f"unknown seed_impl {seed_impl!r} (one of "
                         f"{', '.join(SEED_IMPLS)})")
    return seed_impl


def resolve_device_em(device_em: Optional[bool],
                      device: torch.device) -> bool:
    """``RunConfig.device_em``: True runs the torch EM on the Aligner's
    device (the CPU too), False the numpy host EM.  ``None`` is the device
    EM on a card, where the in-turn bench-world runs of chip_smoke.py on
    an H100 80GB HBM3 at 700 W gave a median of 25,944 pairs/s with it
    against 17,613 with host EM (PERF.md), and the host EM on the CPU."""
    if device_em is None:
        return device.type == "cuda"
    return bool(device_em)


def orient_device(codes: torch.Tensor, lens: torch.Tensor):
    """[R, L] forward codes -> [2R, L] forward + revcomp rows, on the
    tensors' device (ema_tpu/core/pipeline.py:74-89, _orient_device).

    Only the forward rows cross to the device; the reverse complement the
    SW scorer needs is derived there.  Positions past a read's length
    hold 4, row by row (mixed read lengths stay unscrambled).
    """
    L = codes.shape[1]
    pos = (lens.to(torch.int64)[:, None] - 1
           - torch.arange(L, device=codes.device)[None, :])
    valid = pos >= 0
    src = torch.gather(codes, 1, pos.clamp(min=0))
    rc = torch.where(src < 4, 3 - src.clamp(max=3), 4).to(codes.dtype)
    rc = torch.where(valid, rc, 4).to(codes.dtype)
    return torch.cat([codes, rc], dim=0), torch.cat([lens, lens])


class Aligner:
    """Holds the index state on ``device`` (the card unless the caller
    names the CPU) and runs batched alignment; with several ``devices``
    its batched device calls are split over them (``_init_mesh``)."""

    def __init__(self, index, cfg: Optional[config.RunConfig] = None, *,
                 device="cuda", sw_impl: Optional[str] = None,
                 seed_impl: Optional[str] = None, devices=None):
        _tune_malloc()
        self.device = resolve_device(device)
        self.sw_impl = resolve_sw_impl(sw_impl)
        self.seed_impl = resolve_seed_impl(seed_impl)
        self.index = index
        cfg = cfg or config.RunConfig()
        seeding = cfg.aligner.seeding or "smem"
        if seeding not in SEEDINGS:
            raise ValueError(f"unknown seeding {seeding!r} (one of "
                             f"{', '.join(SEEDINGS)})")
        # batch size and in-flight chunks start at the JAX package's TPU
        # values (ema_tpu/core/pipeline.py:209-215); untuned on the GPU
        self.cfg = dataclasses.replace(
            cfg, batch_size=cfg.batch_size or 4096,
            inflight_chunks=cfg.inflight_chunks or 4,
            device_em=resolve_device_em(cfg.device_em, self.device),
            aligner=dataclasses.replace(cfg.aligner, seeding=seeding))
        self.text_dev, self.fma = to_device_state(
            index, self.device, fm=self.seed_impl == "device")
        self._init_mesh(devices)
        # the EM's side stream (core/em.dispatch_em_batch)
        self._em_stream = (torch.cuda.Stream(self.device)
                           if self.cfg.device_em and self.device.type == "cuda"
                           else None)
        self._cloud_id = 0
        self._id_lock = threading.Lock()   # MI ids under concurrent chunks
        self._contig_blob = None
        # set on the shards of a ShardedAligner: the edit-distance window
        # is applied after the cross-shard merge
        self._defer_dist_window = False
        # optional (batch, CandidateSet) tap for the reference-oracle
        # replay (ema_tpu_torch/utils/replay.ReplayWriter.add); called from the
        # chunk workers, so a sink must be thread-safe
        self.replay_sink = None
        # optional fine-grained stage timers (utils/metrics.Metrics);
        # chunk workers run concurrently, so stage sums are thread-seconds
        self.metrics = None

    def _init_mesh(self, devices) -> None:
        """Multi-device: split the batched device calls over a data mesh
        (ema_tpu/core/pipeline.py:278-309).

        ``devices`` None is every visible card when
        ``cfg.data_parallel_chips`` is on and the Aligner's device is a
        card, else the Aligner's device alone.  With more than one, the
        index state is copied once to each distinct device and
        ``_on_blocks`` runs each batched call's rows in blocks along
        ``data``.  One device: plain dispatch.
        """
        self.mesh = None
        self._state_on = {self.device: DeviceState(self.text_dev, self.fma)}
        if devices is None:
            devices = ([f"cuda:{i}" for i in range(torch.cuda.device_count())]
                       if self.cfg.data_parallel_chips
                       and self.device.type == "cuda" else [self.device])
        if len(devices) <= 1:
            return
        self.mesh = make_mesh(len(devices), 1, devices)
        for d in self.mesh.distinct_devices:
            if d not in self._state_on:
                self._state_on[d] = DeviceState(
                    self.text_dev.to(d),
                    None if self.fma is None else self.fma.to(d))

    def _blocks(self, n: int) -> list:
        """(lo, hi, data index) of the row blocks of ``n`` rows, in row
        order: contiguous, of sizes that differ by at most one, empty ones
        skipped (the first kept when ``n`` is 0).  Unmeshed: one block,
        index None."""
        if self.mesh is None:
            return [(0, n, None)]
        k = self.mesh.shape[DATA_AXIS]
        out = [(n * d // k, n * (d + 1) // k, d) for d in range(k)]
        return [b for b in out if b[1] > b[0]] or out[:1]

    @contextlib.contextmanager
    def _cell(self, d):
        """Data cell ``d``'s device, its stream current (the Aligner's
        device when ``d`` is None)."""
        if d is None:
            yield self.device
        else:
            with self.mesh.cell(d) as dev:
                yield dev

    def _on_blocks(self, n: int, fn) -> list:
        """``[fn(lo, hi, device) for each block of n rows]``, each on its
        cell.  ``fn`` returns host arrays, so every block's work is done
        when it returns."""
        outs = []
        for lo, hi, d in self._blocks(n):
            with self._cell(d) as dev:
                outs.append(fn(lo, hi, dev))
        return outs

    def _smem_kmer_tab(self):
        """Per-index k-mer bi-interval table for SMEM round 3 (lazy).

        Built once and shared by every chunk's smem_seed_batch call;
        output-identical to seeding without it.  EMA_TPU_SMEM_KMER sets k
        (0 disables); k < 1 is never passed to native.smem_kmer_table,
        which would overrun its buffer.
        """
        tab = getattr(self, "_smem_ktab", False)
        if tab is False:
            with self._id_lock:    # chunk workers race the first build
                tab = getattr(self, "_smem_ktab", False)
                if tab is False:
                    import os as _os
                    k = int(_os.environ.get("EMA_TPU_SMEM_KMER", "10"))
                    tab = None
                    if k > 0:
                        idx = self.index
                        with self._mst("kmer_table"):
                            tab = native.smem_kmer_table(
                                idx.occ_blocks, idx.counts, idx.primary,
                                idx.fm_n, k=k)
                    self._smem_ktab = tab
        return tab

    # ------------------------------------------------------------------
    # candidate generation
    # ------------------------------------------------------------------

    def _mst(self, name: str, n_items: int = 0, **span):
        return (self.metrics.stage(name, n_items, **span) if self.metrics
                else contextlib.nullcontext())

    def generate_candidates(self, batch: ReadBatch) -> CandidateSet:
        params = self.cfg.aligner
        idx = self.index
        codes, lens = batch.codes, batch.lens
        n_reads, L = codes.shape

        # orient on the host for traceback: rows [0, n_reads) forward,
        # [n_reads, 2n) reverse-complement (not np.putmask — its values
        # are indexed by flat position modulo len(values), which scrambles
        # rows when reads have different lengths)
        pos = lens[:, None] - 1 - np.arange(L)[None, :]
        valid = pos >= 0
        src = np.take_along_axis(codes, np.maximum(pos, 0), axis=1)
        rc_vals = np.where(src < 4, 3 - np.minimum(src, 3), 4).astype(np.uint8)
        rc = np.where(valid, rc_vals, np.uint8(4))
        oriented = np.concatenate([codes, rc], axis=0)
        olens = np.concatenate([lens, lens])
        # forward rows uploaded once: device seeding reads them, and the SW
        # scorer's revcomp rows are derived from them on the device; row r
        # of the oriented copy is oriented read r
        codes_dev = torch.from_numpy(codes).to(self.device)
        lens_dev = torch.from_numpy(
            np.ascontiguousarray(lens, np.int32)).to(self.device)
        oriented_dev, olens_dev = orient_device(codes_dev, lens_dev)

        # --- seed (ema_tpu/core/pipeline.py:441-531).  Both strands live
        # in the FM text, so only the forward read is seeded.
        seed_stack = nsd = hp = None
        if params.seeding == "smem":
            # full SMEM enumeration + re-seeding in threaded host C++
            # (bwt_smem1 semantics)
            with self._mst("seed[smem,host]", n_reads):
                sm = native.smem_seed_batch(
                    idx.occ_blocks, idx.counts, idx.primary, idx.fm_n,
                    codes, lens,
                    min_seed_len=params.min_seed_len,
                    split_len=int(params.min_seed_len * 1.5 + 0.499),
                    split_width=params.split_width,
                    max_mem_intv=params.max_mem_intv,
                    kmer_tab=self._smem_kmer_tab())
                seed_stack = sm[:4]
                nsd = sm[4]
        elif self.seed_impl == "native":
            # greedy chop in host C++ (value-identical to fm.seed_reads)
            with self._mst("seed[native,host]", n_reads):
                sm = native.greedy_seed_batch(
                    idx.occ_blocks, idx.counts, idx.primary, idx.fm_n,
                    codes, lens, min_seed_len=params.seed_len,
                    max_seeds=MAX_SEEDS)
                seed_stack = sm[:4]
                nsd = sm[4]
        else:
            # greedy chop, hit compaction and locate in one device call
            with self._mst("seed+locate[device]", n_reads):
                got = self._seed_locate(codes_dev, lens_dev, params)
            if got is not None:
                owner, qb, slen, hp, frac_rep_read = got
            else:
                # more hits than the budget (a deep-repeat chunk): the
                # unbounded two-step path, still on the device
                def seed(lo, hi, dev):
                    sd = fm.seed_reads(self._state_on[dev].fm,
                                       codes_dev[lo:hi].to(dev),
                                       lens_dev[lo:hi].to(dev),
                                       max_seeds=MAX_SEEDS,
                                       min_seed_len=params.seed_len)
                    return [a.cpu().numpy() for a in sd]

                with self._mst("seed[device]", n_reads):
                    sd = [np.concatenate(p) for p in
                          zip(*self._on_blocks(n_reads, seed))]
                    seed_stack, nsd = tuple(sd[:4]), sd[4]

        if hp is None:
            # repeat fraction per physical read: fraction of read bases
            # covered by seeds whose SA interval exceeds max_occ (BWA's
            # l_rep/frac_rep, consumed by the mapq formula).  SMEMs may
            # overlap, so the sum over-counts — clip to 1.
            n_s = seed_stack[0].shape[1]
            s_live = np.arange(n_s)[None, :] < nsd[:, None]
            s_width = np.where(s_live, seed_stack[1] - seed_stack[0], 0)
            l_rep = np.where(s_width > params.max_occ,
                             seed_stack[3], 0).sum(axis=1)
            frac_rep_read = np.minimum(
                l_rep / np.maximum(lens, 1), 1.0).astype(np.float32)

            owner, qb, slen, rows_flat = _compact_seed_hits(
                seed_stack, nsd, params.max_hits_per_seed)
            if self.seed_impl == "native":
                with self._mst("locate[native,host]", rows_flat.shape[0]):
                    hp = native.locate_batch(idx, rows_flat)
            else:
                with self._mst("locate[device]", rows_flat.shape[0]):
                    hp = np.concatenate(self._on_blocks(
                        rows_flat.shape[0],
                        lambda lo, hi, dev: locate_rows(
                            self._state_on[dev].fm, rows_flat[lo:hi])))

        # map both-strands hits to (oriented read, forward-text pos):
        # a hit at fm pos p >= n is the reverse strand — the REVCOMP of the
        # read matches the forward text at 2n - p - seed_len, and the seed's
        # read offset flips to the rc-read frame (bwabridge.c:319-332)
        n_fwd = idx.n
        strand = hp >= n_fwd
        # drop hits crossing the fw|rc boundary; anything else is fully on
        # one strand and tpos is non-negative by construction
        keep = strand | (hp + slen <= n_fwd)
        tpos = np.where(strand, 2 * n_fwd - hp - slen, hp)
        rl = lens[owner].astype(np.int64)
        qb2 = np.where(strand, rl - qb - slen, qb)
        owner2 = owner + strand * n_reads
        owner2, qb2, slen, tpos = (owner2[keep], qb2[keep], slen[keep],
                                   tpos[keep])

        read_lens2 = olens.astype(np.int64)
        with self._mst("chain[host]", owner2.shape[0]):
            cands = chaining.chain_hits(
                owner2, qb2, slen, tpos, 2 * n_reads, read_lens2, idx.n,
                band_width=params.band_width, pad=WINDOW_PAD,
                max_candidates=params.max_candidates_per_read)

        co = cands.owner
        win_lo = cands.win_lo
        win_len = cands.win_len
        seedcov = cands.seedcov
        weight = cands.weight

        # --- device: score all candidate windows -----------------------
        with self._mst("sw[device]", co.shape[0]):
            sw = self._score_windows(oriented_dev, olens_dev, co, win_lo,
                                     win_len, wl=cands.wl,
                                     host=(oriented, olens))

        # --- mate rescue ------------------------------------------------
        ro, rlo, rlen = self._rescue_windows(
            n_reads, olens, co, win_lo, sw["score"], params)
        if ro.shape[0]:
            with self._mst("sw[device]", ro.shape[0]):
                # rescue = full SW over the insert window (mem_matesw):
                # the corridor is the whole window, no chain constraint
                rsw = self._score_windows(oriented_dev, olens_dev, ro, rlo,
                                          rlen, wl=rlen.astype(np.int32),
                                          host=(oriented, olens))
            min_rescue = params.min_seed_len * params.match
            keep_r = rsw["score"] >= min_rescue
            co = np.concatenate([co, ro[keep_r]])
            win_lo = np.concatenate([win_lo, rlo[keep_r]])
            win_len = np.concatenate([win_len, rlen[keep_r]])
            seedcov = np.concatenate(
                [seedcov, (rsw["qe"] - rsw["qb"])[keep_r].astype(np.int32)])
            weight = np.concatenate(
                [weight, rsw["score"][keep_r].astype(np.int32)])
            sw = {k: np.concatenate([sw[k], rsw[k][keep_r]]) for k in sw}

        with self._mst("traceback+finalize[host]", co.shape[0]):
            return self._finalize_candidates(
                batch, oriented, olens, n_reads, co, win_lo, win_len,
                seedcov, weight, sw, params, frac_rep_read)

    def _seed_locate(self, codes_dev, lens_dev, params):
        """Greedy seeding, hit compaction and locate on the device
        (``fm.seed_locate_reads``) with the budget of 4 hits a read:
        (owner, qb, seed_len, text_pos, frac_rep) as host arrays, or None
        when the batch has more hits than that.

        On a mesh each data block runs the fused call with a budget of 4
        hits a row of its own; the blocks' hits, in row order, are the
        single call's, and the overflow decision is the single call's: the
        sum of the blocks' totals against the batch's budget.  A block
        that overflows its own budget while the batch does not is run
        again with a budget of its total.
        """
        n_reads = codes_dev.shape[0]

        def block(lo, hi, dev, budget=None):
            budget = budget or 4 * (hi - lo)
            packed, total, frd = fm.seed_locate_reads(
                self._state_on[dev].fm, codes_dev[lo:hi].to(dev),
                lens_dev[lo:hi].to(dev), max_seeds=MAX_SEEDS,
                min_seed_len=params.seed_len,
                max_hits=params.max_hits_per_seed, budget=budget,
                max_occ=params.max_occ)
            total = int(total)
            hits = (packed[:, :total].to(torch.int64).cpu().numpy()
                    if total <= budget else None)
            return total, hits, frd.cpu().numpy()

        outs = self._on_blocks(n_reads, block)
        if sum(o[0] for o in outs) > 4 * n_reads:
            return None
        parts = []
        for (total, hits, _), (lo, hi, d) in zip(outs,
                                                 self._blocks(n_reads)):
            if hits is None:
                with self._cell(d) as dev:
                    _, hits, _ = block(lo, hi, dev, budget=total)
            hits[0] += lo
            parts.append(hits)
        owner, qb, slen, hp = np.concatenate(parts, axis=1)
        return owner, qb, slen, hp, np.concatenate([o[2] for o in outs])

    def _score_windows(self, oriented_dev, olens_dev, owners, win_lo,
                       win_len, wl=None, host=None,
                       scorer=None) -> Dict[str, np.ndarray]:
        """Score candidate (oriented read, window) pairs with the chosen
        scorer (ema_tpu/core/pipeline.py:596-705).

        ``oriented_dev``/``olens_dev`` are the device copies of the
        oriented reads (row r = oriented read r); only the per-candidate
        index vectors cross to the device, and the kernel reads the reads
        and the windows from there (the text lives in ``self.text_dev``).
        ``host`` = (oriented, olens) as numpy is what ``native`` scores.
        ``wl`` (int32 [N]) is the per-candidate logical corridor (None =
        the full window): diagonals k >= wl[b] are excluded, so a
        candidate's result depends only on its own chain geometry; scan
        scores the whole window.  tier64 sends the corridors of at most
        64 lanes to the packed kernel and the rest to the banded one (all
        small: packed; at least 256 small: split; else banded), before
        large sets run in SW_CHUNK pieces.  ``scorer`` fixes the
        gather_score scorer of this call (the split's halves).
        """
        N = owners.shape[0]
        if N == 0:
            z = np.zeros(0, np.int32)
            return {"score": z, "qb": z, "qe": z, "ref_end": z}
        wl_cand = np.maximum(wl if wl is not None else win_len,
                             1).astype(np.int32)
        p = self.cfg.aligner
        kw = dict(match=p.match, mismatch=p.mismatch, gap_open=p.gap_open,
                  gap_extend=p.gap_extend, clip=p.clip_penalty)
        if self.sw_impl == "native":
            # the threaded host C++ banded DP straight off the packed text
            oriented, olens = host
            return native.sw_banded_native(
                oriented, olens, self.index.text, owners, win_lo, win_len,
                int(wl_cand.max()), wl=wl_cand, **kw)
        if scorer is None:
            scorer = SW_IMPLS[self.sw_impl]
            if self.sw_impl == "tier64":
                small = wl_cand <= PACKED_MAX_WL
                ns = int(small.sum())
                if ns == N:
                    scorer = "packed"
                elif ns >= TIER64_MIN:
                    out = {k: np.zeros(N, np.int32)
                           for k in ("score", "qb", "qe", "ref_end")}
                    for part, sc in ((small, "packed"), (~small, "banded")):
                        idx = np.nonzero(part)[0]
                        sub = self._score_windows(
                            oriented_dev, olens_dev, owners[idx],
                            win_lo[idx], win_len[idx], wl=wl_cand[idx],
                            host=host, scorer=sc)
                        for k in out:
                            out[k][idx] = sub[k]
                    return out
        if N > SW_CHUNK:
            outs = [self._score_windows(
                        oriented_dev, olens_dev, owners[s:s + SW_CHUNK],
                        win_lo[s:s + SW_CHUNK], win_len[s:s + SW_CHUNK],
                        wl=wl_cand[s:s + SW_CHUNK], host=host,
                        scorer=scorer)
                    for s in range(0, N, SW_CHUNK)]
            return {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}

        def score(lo, hi, dev):
            def put(a, dtype):
                return torch.from_numpy(
                    np.ascontiguousarray(a[lo:hi], dtype)).to(dev)

            return gather_score(
                self._state_on[dev].text, oriented_dev.to(dev),
                olens_dev.to(dev), put(owners, np.int32),
                put(win_lo, np.int64), put(win_len, np.int32),
                put(wl_cand, np.int32), scorer=scorer, **kw).cpu().numpy()

        out = np.concatenate(self._on_blocks(N, score))
        return {k: np.ascontiguousarray(out[:, c])
                for c, k in enumerate(("score", "qb", "qe", "ref_end"))}

    def _rescue_windows(self, n_reads, olens, co, win_lo, sw_score, params):
        """Mate-rescue windows, fully vectorized (reference
        pes = {-35, 500, 200, 100}, FR orientation only —
        bwabridge.c:213-231).  Copied from ema_tpu/core/pipeline.py:707-780.
        """
        if co.shape[0] == 0:
            return (np.zeros(0, np.int64),) * 3
        olens = olens.astype(np.int64)
        # best score per oriented read
        best = np.zeros(2 * n_reads, np.int64)
        np.maximum.at(best, co, sw_score)

        # candidate anchor ~ window start + pad
        anchor = win_lo + WINDOW_PAD
        good = np.nonzero(sw_score >= best[co] - params.rescue_score_delta)[0]
        pad2 = WINDOW_PAD

        r = co[good]
        fwd = r < n_reads
        read = np.where(fwd, r, r - n_reads)
        pair, mate = read // 2, read % 2
        mread = pair * 2 + (1 - mate)
        # FR: mate aligns in the opposite orientation
        ro = mread + np.where(fwd, n_reads, 0)
        g = anchor[good]
        lb = olens[mread]
        g_end = g + olens[read]
        lo = np.where(fwd, g + params.pes_low - pad2,
                      g_end - params.pes_high - lb - pad2)
        hi = np.where(fwd, g + params.pes_high + lb + pad2,
                      g_end - params.pes_low + pad2)
        # lo unclamped: out-of-text columns mask to a sentinel in the
        # window gathers (keeps window diagonals >= 0 for the banded SW)
        hi = np.minimum(hi, self.index.n)
        rlen = (hi - lo).astype(np.int32)
        ok = rlen > params.min_seed_len
        ro, rlo, rlen = ro[ok].astype(np.int64), lo[ok], rlen[ok]
        if ro.shape[0] == 0:
            return (np.zeros(0, np.int64),) * 3

        # cap rescue attempts per mate side, best-scoring triggers first
        # (the reference attempts at most ~50 mate-SWs per side,
        # bwabridge.c:263-283)
        sc = sw_score[good][ok]
        n_k = ro.shape[0]
        order_r = np.lexsort((-sc, ro))
        ro_s = ro[order_r]
        firstr = np.ones(n_k, bool)
        firstr[1:] = ro_s[1:] != ro_s[:-1]
        idxr = np.arange(n_k)
        rankr = idxr - np.maximum.accumulate(np.where(firstr, idxr, 0))
        keep_cap = np.zeros(n_k, bool)
        keep_cap[order_r] = rankr < params.rescue_max_per_side
        ro, rlo, rlen = ro[keep_cap], rlo[keep_cap], rlen[keep_cap]
        if ro.shape[0] == 0:
            return (np.zeros(0, np.int64),) * 3

        # dedupe 1: skip a rescue whose window already holds a candidate of
        # the same oriented read (within band).  Existing windows sorted by
        # a composite (owner, pos) key; overlap = non-empty range query.
        span = np.int64(self.index.n) + 701
        ekeys = np.sort(co.astype(np.int64) * span + win_lo)
        lo_k = ro * span + (rlo - 600)
        hi_k = ro * span + (rlo + rlen)
        keep = np.searchsorted(ekeys, hi_k, side="right") \
            <= np.searchsorted(ekeys, lo_k, side="left")

        # dedupe 2: identical rescue windows (first occurrence wins)
        rkey = ro * span + (rlo // 64)
        _, first_idx = np.unique(rkey, return_index=True)
        uniq = np.zeros(ro.shape[0], bool)
        uniq[first_idx] = True
        keep &= uniq
        return ro[keep], rlo[keep], rlen[keep]

    def _finalize_candidates(self, batch, oriented, olens, n_reads,
                             co, win_lo, win_len, seedcov, weight, sw,
                             params, frac_rep_read=None) -> CandidateSet:
        """Order, filter, traceback, and assemble per-candidate arrays.
        Copied from ema_tpu/core/pipeline.py:782-897."""
        idx = self.index
        L_arr = olens[co] if co.shape[0] else np.zeros(0, np.int32)
        clip = (L_arr - (sw["qe"] - sw["qb"])).astype(np.int32)

        # order: per oriented read by score desc (reference: mem returns
        # score-sorted; best_dist comes from the first candidate)
        ord1 = np.lexsort((win_lo, -sw["score"], co))
        co, win_lo, win_len = co[ord1], win_lo[ord1], win_len[ord1]
        seedcov, weight, clip = seedcov[ord1], weight[ord1], clip[ord1]
        sw = {k: v[ord1] for k, v in sw.items()}

        # drop non-positive scores and heavy clipping (align.c:1015-1017)
        ok = (sw["score"] > 0) & (clip < L_arr[ord1] // 2)
        # pre-traceback survivors: a *score*-window bound on the later
        # edit-distance window (align.c:1020-1024) instead of a fixed
        # per-read rank cap.  One extra edit-distance unit costs at most
        # max(match+mismatch, gap_open+gap_extend+match) SW score vs the
        # leader, so anything below this margin cannot pass the
        # EXTRA_SEARCH_DEPTH filter.  MAX_CANDIDATES (samdict.h:9) stays
        # as the hard valve.
        n_rows_o = oriented.shape[0]
        lead_score = np.full(n_rows_o, np.iinfo(np.int32).min, np.int64)
        np.maximum.at(lead_score, co[ok], sw["score"][ok].astype(np.int64))
        per_edit = max(params.match + params.mismatch,
                       params.gap_open + params.gap_extend + params.match)
        margin = (config.EXTRA_SEARCH_DEPTH * per_edit
                  + 2 * params.gap_open + 2 * params.clip_penalty)
        ok &= sw["score"] >= lead_score[co] - margin
        # rank among surviving candidates per read (array is score-sorted)
        first = np.ones(co.shape[0], bool)
        first[1:] = co[1:] != co[:-1]
        c_ok = np.cumsum(ok.astype(np.int64))
        seg_base = np.maximum.accumulate(
            np.where(first, c_ok - ok.astype(np.int64), 0))
        ok &= (c_ok - 1 - seg_base) < config.MAX_CANDIDATES
        co, win_lo, win_len = co[ok], win_lo[ok], win_len[ok]
        seedcov, weight, clip = seedcov[ok], weight[ok], clip[ok]
        sw = {k: v[ok] for k, v in sw.items()}

        if co.shape[0] == 0:
            return _empty_candidate_set()

        # --- traceback for survivors: gapless shortcut + C++ DP, one
        # threaded native call reading windows off the packed text
        nat = native.traceback_batch(
            oriented, olens, co, idx.text, win_lo, win_len, sw,
            match=params.match, mismatch=params.mismatch,
            gap_open=params.gap_open, gap_extend=params.gap_extend,
            clip_penalty=params.clip_penalty, max_cigar=MAX_CIGAR_OPS)

        gpos = win_lo + nat["pos"]
        nm = nat["nm"].astype(np.int32)
        dist = nm + clip

        # edit-distance window filter vs the physical read's best-scoring
        # candidate across both strands (align.c:1020-1024).  As a shard
        # of a ShardedAligner the filter is deferred to the cross-shard
        # merge: a per-shard leader's window could drop candidates the
        # global leader's window keeps.
        phys = np.where(co >= n_reads, co - n_reads, co)
        if self._defer_dist_window:
            ok = np.ones(co.shape[0], bool)
        else:
            ok = _dist_window_keep(phys, sw["score"], dist, n_reads)
        # contig containment: alignment must not cross a contig boundary
        chrom = idx.contig_of(gpos).astype(np.int32)
        ref_len = _cigar_ref_len(nat["cigars"], nat["n_cigar"])
        ends = gpos + ref_len - 1
        ok &= (gpos >= 0) & (chrom == idx.contig_of(np.maximum(ends, gpos))) \
            & (nat["pos"] >= 0)

        co, win_lo = co[ok], win_lo[ok]
        seedcov, weight, clip = seedcov[ok], weight[ok], clip[ok]
        sw = {k: v[ok] for k, v in sw.items()}
        gpos, nm, chrom = gpos[ok], nm[ok], chrom[ok]
        cigars, n_cigar = nat["cigars"][ok], nat["n_cigar"][ok]

        # uniqueness + sub stats per oriented read.  ``sub`` (the best score
        # among the read's *other* candidates) feeds the BWA-shaped mapq;
        # both orientations of one read share the statistics.
        N = co.shape[0]
        phys = np.where(co >= n_reads, co - n_reads, co)
        n_per = np.bincount(phys, minlength=n_reads)
        unique = n_per[phys] == 1
        _, sub = _best_and_sub(phys, sw["score"], n_reads)
        sub_n = np.maximum(n_per[phys] - 2, 0)

        rev = (co >= n_reads).astype(np.int8)
        pos_local = gpos - idx.offsets[chrom] + 1
        frac_rep = (frac_rep_read[phys].astype(np.float32)
                    if frac_rep_read is not None
                    else np.zeros(N, np.float32))

        return CandidateSet(
            owner=np.where(rev == 1, co - n_reads, co).astype(np.int64),
            rev=rev, gpos=gpos, chrom=chrom, pos_local=pos_local,
            sw=sw["score"].astype(np.int32),
            qb=sw["qb"].astype(np.int32), qe=sw["qe"].astype(np.int32),
            clip=clip.astype(np.int32), nm=nm,
            cigars=cigars, n_cigar=n_cigar.astype(np.int32),
            seedcov=seedcov.astype(np.int32),
            sub=sub.astype(np.int32), sub_n=sub_n.astype(np.int32),
            frac_rep=frac_rep,
            unique=unique)

    # ------------------------------------------------------------------
    # record assembly + group processing
    # ------------------------------------------------------------------

    def candidates_to_records(self, batch: ReadBatch, cs: CandidateSet,
                              pair_offset: int = 0):
        """CandidateSet -> RECORD_DTYPE array + ident array + cigar pool.
        Copied from ema_tpu/core/pipeline.py:903-938."""
        N = cs.owner.shape[0]
        recs = empty_records(N)
        pairs = cs.owner // 2
        mates = cs.owner % 2
        recs["bc"] = batch.bc[pairs]
        recs["chrom"] = cs.chrom
        recs["pos"] = cs.pos_local
        recs["pair"] = pairs + pair_offset
        recs["mate"] = mates.astype(np.int8)
        recs["rev"] = cs.rev
        score, score_mapq = score_mod.score_alignments(
            cs.cigars, cs.n_cigar, cs.nm, self.cfg.platform.error_rate)
        recs["score"] = score
        recs["score_mapq"] = score_mapq
        recs["mapq"] = score_mod.approx_mapq(
            cs.sw.astype(np.int64), cs.sub.astype(np.int64),
            (cs.qe - cs.qb).astype(np.int64), cs.seedcov.astype(np.int64),
            cs.sub_n.astype(np.int64), cs.frac_rep.astype(np.float64),
            self.cfg.aligner,
            rspan=_cigar_ref_len(cs.cigars, cs.n_cigar).astype(np.int64))
        recs["clip"] = cs.clip
        recs["clip_edit_dist"] = cs.nm + cs.clip
        recs["edit_dist"] = cs.nm
        recs["sw_score"] = cs.sw
        recs["unique"] = cs.unique
        recs["aln_pos0"] = cs.pos_local - 1

        pool = cs.cigars.reshape(-1)
        recs["cig_off"] = np.arange(N, dtype=np.int64) * cs.cigars.shape[1]
        recs["cig_len"] = cs.n_cigar

        idents = np.array([batch.ids[p] for p in pairs], dtype=object)
        return recs, idents, pool

    def align_batch_to_sam(self, batch: ReadBatch,
                           cloud_id_base: Optional[int] = None) -> List[str]:
        """Full pipeline for one ReadBatch; returns all SAM lines."""
        out: List[str] = []
        for chunk_lines in self.iter_batch_sam(batch, cloud_id_base):
            out.extend(chunk_lines)
        return out

    def iter_batch_sam(self, batch: ReadBatch, cloud_id_base=None,
                       group_sink=None, *, batch_id: Optional[int] = None,
                       pulled: Optional[Dict[int, int]] = None
                       ) -> Iterator[List[str]]:
        """Full pipeline for one ReadBatch whose barcodes are complete
        (ema_tpu/core/pipeline.py:948-1142).

        Candidate generation runs in cfg.batch_size-pair chunks with
        cfg.inflight_chunks in flight on a thread pool; barcode groups
        are processed as soon as all their chunks have landed, so the
        EM/selection/SAM phase of early barcodes overlaps later chunks'
        seeding and device time, and a batch's device EM overlaps the
        previous batch's selection and emission.  Yields lists of SAM
        lines as groups complete.

        ``cloud_id_base``: start of a private MI (cloud id) namespace for
        this call, so that -x gives each bucket ids that do not depend on
        bucket concurrency or resume order; a callable
        ``(bc, n_clouds) -> base`` allocates per group (bucket-coalesced
        -x); None draws from the aligner-wide counter.

        ``group_sink``: optional ``(bc, lines)`` callback; when given,
        each barcode group's lines go to the sink instead of being
        yielded (coalesced -x routes them to per-bucket parts).

        With ``metrics`` set, the call is one ``batch`` span whose id
        (``batch_id``, or a new one) every span under it carries, and
        ``pulled`` ({bc: time.time_ns() when the group's last pair was
        read}, align_stream's) gives each such group a ``stream.group``
        span that ends when its lines are handed on.
        """
        if self.metrics is None:
            pulled = None
        elif batch_id is None:
            batch_id = new_batch_id()
        with self._mst("batch", len(batch.ids), batch=batch_id) as root:
            yield from self._batch_sam(batch, cloud_id_base, group_sink,
                                       root, pulled)

    def _batch_sam(self, batch, cloud_id_base, group_sink, root, pulled
                   ) -> Iterator[List[str]]:
        """iter_batch_sam's body; ``root`` is its ``batch`` span (None
        without metrics)."""
        P = len(batch.ids)
        B = max(self.cfg.batch_size, 1)

        with self._mst("batch.prep", P):
            # pre-sort pairs by barcode so chunk records are bc-monotone
            # and every barcode is contiguous across at most adjacent
            # chunks
            order = np.argsort(batch.bc, kind="stable")
            if not np.array_equal(order, np.arange(P)):
                batch = _reorder_batch(batch, order)
            if not isinstance(batch.seqs, np.ndarray):
                # object ndarrays: emission fancy-indexes the FULL batch's
                # read strings once per barcode group
                batch = dataclasses.replace(
                    batch, seqs=np.asarray(batch.seqs, dtype=object),
                    quals=np.asarray(batch.quals, dtype=object))
            pair_bc: Dict[int, int] = {}
            for b in batch.bc:
                pair_bc[int(b)] = pair_bc.get(int(b), 0) + 1

        def work(s: int):
            e = min(s + B, P)
            with self._mst("chunk", e - s, parent=root):
                sub = ReadBatch(
                    ids=batch.ids[s:e], bc=batch.bc[s:e],
                    seqs=batch.seqs[2 * s:2 * e],
                    quals=batch.quals[2 * s:2 * e],
                    codes=batch.codes[2 * s:2 * e],
                    lens=batch.lens[2 * s:2 * e])
                cs = self.generate_candidates(sub)
                if self.replay_sink is not None:
                    self.replay_sink(sub, cs)
                recs, idents, part_pool = self.candidates_to_records(
                    sub, cs, s)
                # bc-sort within the chunk (candidate order interleaves
                # the forward and reverse orientations); stable, so within
                # one barcode the chunk-position order is preserved
                o = np.argsort(recs["bc"], kind="stable")
                return recs[o], idents[o], part_pool

        lines: List[str] = []
        alloc_base = cloud_id_base if callable(cloud_id_base) else None
        local_cloud_id = (None if cloud_id_base is None or alloc_base
                          else [int(cloud_id_base)])
        rng = np.random.default_rng(self.cfg.seed)
        chunk_starts = list(range(0, P, B))
        pend_recs = empty_records(0)
        pend_ids = np.zeros(0, dtype=object)
        # geometric-growth CIGAR pool (appending a chunk is amortized O(1))
        pool = np.zeros(1 << 16, np.uint32)
        pool_len = 0

        def pool_append(part: np.ndarray) -> None:
            nonlocal pool, pool_len
            need = pool_len + part.shape[0]
            if need > pool.shape[0]:
                grown = np.zeros(max(need, 2 * pool.shape[0]), np.uint32)
                grown[:pool_len] = pool[:pool_len]
                pool = grown
            pool[pool_len:need] = part
            pool_len = need

        def sweep_and_dispatch(recs, idents, up_to_bc):
            """Sweep complete barcode groups (bc < up_to_bc) and launch
            their batched EM; returns (end, (states, wait)).  On the
            device the EM runs while ``finish_and_emit`` handles the
            previous batch (ema_tpu/core/pipeline.py:1030-1069)."""
            bcs = recs["bc"]
            if up_to_bc is None:
                end = recs.shape[0]
            else:
                end = int(np.searchsorted(bcs, up_to_bc, side="left"))
            starts = np.concatenate(
                [[0], np.nonzero(np.diff(bcs[:end]))[0] + 1, [end]])
            if end > 0:
                n_pairs_list = [pair_bc.get(int(bcs[s]), 0)
                                for s in starts[:-1]]
                with self._mst("sweep[host]", len(n_pairs_list)):
                    states = groups_mod.sweep_groups_batch(
                        recs, idents, starts, self.cfg.platform,
                        apply_opt=self.cfg.apply_density_opt, rng=rng,
                        n_pairs_list=n_pairs_list)
            else:
                states = []
            em_wait = None
            with self._mst("em[device]" if self.cfg.device_em
                           else "em[host]", len(states)):
                if self.cfg.device_em:
                    if self.metrics is not None:
                        # counts: the groups dispatch_em_batch sends to
                        # the card, and those too deep for it, run natively
                        depth = [st.cmask.shape[1] for st in states
                                 if st.needs_em]
                        deep = sum(c > groups_mod.EM_NATIVE_C for c in depth)
                        now = time.time_ns()
                        self.metrics.record("em.groups", now, now,
                                            len(depth) - deep)
                        self.metrics.record("em.native_groups", now, now,
                                            deep)
                    # one flat launch for all EM-gated groups
                    em_wait = dispatch_em_batch(states, self.device,
                                                self._em_stream,
                                                self.metrics)
                else:
                    # one padded numpy pass for all EM-gated groups
                    groups_mod.run_em_host_batch(states)
            return end, (states, em_wait)

        def finish_and_emit(emit_state) -> None:
            states, em_wait = emit_state
            if em_wait is not None:
                with self._mst("em[device]"), self._mst("em.wait"):
                    em_wait()
            finished = []
            with self._mst("select+emit[host]",
                           sum(st.n for st in states)):
                for st in states:
                    # reserve a cloud-id range atomically: concurrent
                    # batches never produce duplicate MI ids
                    g_bc = int(st.R["bc"][0]) if st.n else 0
                    if alloc_base is not None:
                        base = alloc_base(g_bc, st.n_clouds)
                    elif local_cloud_id is not None:
                        base = local_cloud_id[0]
                        local_cloud_id[0] += st.n_clouds
                    else:
                        with self._id_lock:
                            base = self._cloud_id
                            self._cloud_id += st.n_clouds
                    finished.append((g_bc, base))
                results = groups_mod.finish_groups_batch(
                    states, [b for _, b in finished])
                line_lists = self._emit_groups(batch, results, pool)
            for (g_bc, _), glines in zip(finished, line_lists):
                if group_sink is not None:
                    group_sink(g_bc, glines)
                else:
                    lines.extend(glines)
                t0 = pulled.pop(g_bc, None) if pulled is not None else None
                if t0 is not None:
                    self.metrics.record("stream.group", t0, time.time_ns(),
                                        pair_bc.get(g_bc, 0),
                                        batch=root.batch)

        from collections import deque
        from concurrent.futures import ThreadPoolExecutor
        workers = max(self.cfg.inflight_chunks, 1)
        with ThreadPoolExecutor(max_workers=workers) as ex:
            # bounded submission window: at most ``workers`` chunk results
            # buffered at once
            futs = deque()
            next_submit = 0
            while next_submit < len(chunk_starts) and len(futs) < workers:
                futs.append(ex.submit(work, chunk_starts[next_submit]))
                next_submit += 1
            k = 0
            pending = None          # one emit batch with its EM in flight
            while futs:
                with self._mst("pool.wait"):
                    recs, idents, part_pool = futs.popleft().result()
                if next_submit < len(chunk_starts):
                    futs.append(ex.submit(work, chunk_starts[next_submit]))
                    next_submit += 1
                recs["cig_off"] += pool_len
                pool_append(part_pool)
                pend_recs = np.concatenate([pend_recs, recs])
                pend_ids = np.concatenate([pend_ids, idents])
                last = k + 1 >= len(chunk_starts)
                limit = None if last else int(batch.bc[chunk_starts[k + 1]])
                done, bstate = sweep_and_dispatch(pend_recs, pend_ids,
                                                  limit)
                pend_recs = pend_recs[done:]
                pend_ids = pend_ids[done:]
                if pending is not None:
                    finish_and_emit(pending)
                pending = bstate
                k += 1
                if lines:
                    yield lines
                    lines = []
            if pending is not None:
                finish_and_emit(pending)
        if lines:
            yield lines

    def align_stream(self, groups, flush_pairs: Optional[int] = None
                     ) -> Iterator[List[str]]:
        """Streaming alignment over an iterator of whole barcode groups.

        ``groups`` yields (ids, bcs, s1, q1, s2, q2) tuples, one complete
        barcode each (io.iter_fastq_pair_groups).  Groups accumulate into
        bounded flush batches (``flush_pairs``, by default 8 chunks) and
        SAM lines are yielded as they are produced, so RSS stays flat
        regardless of input size.  Copied from
        ema_tpu/core/pipeline.py:1144-1179.

        With ``metrics`` set, the fill of each flush batch is a
        ``stream.read`` span and each group a ``stream.group`` span.
        """
        flush = flush_pairs or 8 * max(self.cfg.batch_size, 1)
        ids: List[str] = []
        bcs: List[int] = []
        s1: List[str] = []
        q1: List[str] = []
        s2: List[str] = []
        q2: List[str] = []
        traced = self.metrics is not None
        pulled: Optional[Dict[int, int]] = {} if traced else None

        def drain():
            bid = new_batch_id() if traced else None
            with self._mst("batch.prep", len(ids), batch=bid):
                batch = ReadBatch.from_pairs(ids, bcs, s1, q1, s2, q2)
            yield from self.iter_batch_sam(batch, batch_id=bid,
                                           pulled=pulled)
            for lst in (ids, bcs, s1, q1, s2, q2):
                lst.clear()

        groups = iter(groups)
        while True:
            with self._mst("stream.read") as read:
                for g in groups:
                    if traced and len(g[1]):
                        pulled[int(g[1][0])] = time.time_ns()
                    ids.extend(g[0])
                    bcs.extend(g[1])
                    s1.extend(g[2])
                    q1.extend(g[3])
                    s2.extend(g[4])
                    q2.extend(g[5])
                    if len(ids) >= flush:
                        break
                if traced:
                    read.n_items = len(ids)
            if not ids:
                return
            yield from drain()

    def _emit_groups(self, batch: ReadBatch, results, pool
                     ) -> List[List[str]]:
        """SAM lines for many GroupResults: one batched native emission
        (samout.emit_groups_lines) on the fast path; the scalar
        format_record path (bx_index != "1") stays per-group.  Copied
        from ema_tpu/core/pipeline.py:1181-1216."""
        if self.cfg.bx_index != "1":
            return [self._emit_group(batch, res, pool) for res in results]
        rg_id = None
        if self.cfg.read_group:
            at = self.cfg.read_group.find("ID:")
            if at >= 0:
                rg_id = self.cfg.read_group[at + 3:].split("\t")[0]
        is_hap = self.cfg.platform.name == "haplotag"
        bc_len = self.cfg.platform.bc_len
        lr_tags = not self.cfg.nobc
        if self._contig_blob is None:
            with self._id_lock:     # -x -j N emits from N threads
                if self._contig_blob is None:
                    self._contig_blob = samout.make_contig_blob(
                        self.index.names)
        blob, coff = self._contig_blob
        rg_tag = rg_id.split()[0] if rg_id else None

        from ema_tpu_torch.utils.barcodes import decode_bc
        groups = []
        for res in results:
            R = res.records
            if lr_tags and len(R):
                bc_str = decode_bc(int(R["bc"][0]), bc_len, is_hap)
            else:
                bc_str = ""
            bx_full = bc_str if is_hap else (
                f"{bc_str}-1" if lr_tags and len(R) else "")
            mapqs = score_mod.final_mapq(res.gamma, R["score_mapq"],
                                         R["mapq"])
            groups.append((res, bx_full, mapqs))
        return samout.emit_groups_lines(
            groups, pool, MAX_CIGAR_OPS, batch.seqs, batch.quals,
            blob, coff, rg_tag, self.cfg.nobc)

    def _emit_group(self, batch: ReadBatch, res, pool) -> List[str]:
        """SAM lines for one processed barcode group (GroupResult) on the
        scalar path (bx_index != "1", whose unmapped-mate BX suffix
        samout.format_record hardwires).  Copied from
        ema_tpu/core/pipeline.py:1257-1310."""
        R = res.records
        RI = res.idents

        names = self.index.names
        rg_id = None
        if self.cfg.read_group:
            at = self.cfg.read_group.find("ID:")
            if at >= 0:
                rg_id = self.cfg.read_group[at + 3:].split("\t")[0]
        is_hap = self.cfg.platform.name == "haplotag"
        # bc_len 0 (tru/cpt) decodes to an empty string, so BX becomes a
        # literal "-1" — the reference's own output for these platforms
        bc_len = self.cfg.platform.bc_len
        lr_tags = not self.cfg.nobc
        if lr_tags and len(R):
            from ema_tpu_torch.utils.barcodes import decode_bc
            bc_str = decode_bc(int(R["bc"][0]), bc_len, is_hap)
        else:
            bc_str = ""
        mapqs = score_mod.final_mapq(res.gamma, R["score_mapq"], R["mapq"])

        def cigar_of(i):
            off = int(R["cig_off"][i])
            return pool[off:off + int(R["cig_len"][i])]

        def read_of(i):
            r = int(R["pair"][i]) * 2 + int(R["mate"][i])
            return batch.seqs[r], batch.quals[r]

        def alt_of(i):
            a = int(res.alt_idx[i])
            if a < 0:
                return None
            return {
                "chrom": names[int(R["chrom"][a])],
                "pos": int(R["pos"][a]),
                "cigar": cigar_of(a),
                "edit_dist": int(R["edit_dist"][a]),
                "rev": int(R["rev"][a]),
            }

        lines = []
        for a, b in res.emit_pairs:
            ra = R[a]
            rb = R[b] if b >= 0 else None
            seq_a, qual_a = read_of(a)
            ident = str(RI[a])
            lines.append(samout.format_record(
                ra, rb, ident, names[int(ra["chrom"])],
                names[int(rb["chrom"])] if rb is not None else None,
                seq_a, qual_a, cigar_of(a),
                cigar_of(b) if b >= 0 else None,
                float(res.gamma[a]), int(res.cloud_id[a]),
                int(res.cloud_bad[a]), alt_of(a),
                rg_id, self.cfg.bx_index, is_hap, bc_len,
                mapq=int(mapqs[a]), bc_str=bc_str, lr_tags=lr_tags))
            if rb is not None:
                seq_b, qual_b = read_of(b)
                lines.append(samout.format_record(
                    rb, ra, ident, names[int(rb["chrom"])],
                    names[int(ra["chrom"])],
                    seq_b, qual_b, cigar_of(b), cigar_of(a),
                    float(res.gamma[b]), int(res.cloud_id[b]),
                    int(res.cloud_bad[b]), alt_of(b),
                    rg_id, self.cfg.bx_index, is_hap, bc_len,
                    mapq=int(mapqs[b]), bc_str=bc_str, lr_tags=lr_tags))
            else:
                # unmapped mate record (samrecord.c:157-174)
                r = int(ra["pair"]) * 2 + (1 - int(ra["mate"]))
                lines.append(samout.format_record(
                    None, ra, ident, "*", names[int(ra["chrom"])],
                    batch.seqs[r], batch.quals[r], None, cigar_of(a),
                    0.0, 0, 0, None, rg_id, self.cfg.bx_index,
                    is_hap, bc_len, bc_str=bc_str, lr_tags=lr_tags))
        return lines


class ShardedAligner(Aligner):
    """Aligner over a contig-sharded index (``ShardedIndex``), the port of
    ema_tpu/core/pipeline.py:1313-1345.

    One sub-``Aligner`` per shard holds that shard's device state; each
    chunk's candidates come from every shard and are merged with global
    contig numbers (``contig_base``), re-applying the cross-shard
    edit-distance window and the uniqueness and second-best statistics
    that a single index gives for free.  Like the JAX facade it does not
    run ``Aligner.__init__``: what ``iter_batch_sam`` reads from ``self``
    (the device, the scorer and seeder choices, the resolved cfg, the
    stage timers) comes from the first sub-aligner.  The facade
    dispatches every EM, on the one EM stream it keeps; the subs never
    do.
    """

    def __init__(self, index, cfg: Optional[config.RunConfig] = None, *,
                 device="cuda", sw_impl: Optional[str] = None,
                 seed_impl: Optional[str] = None, devices=None):
        if not index.shards:
            raise ValueError("ShardedAligner: the index has no shards")
        self.index = index                    # ShardedIndex facade
        self.subs = [Aligner(sh, cfg, device=device, sw_impl=sw_impl,
                             seed_impl=seed_impl, devices=devices)
                     for sh in index.shards]
        first = self.subs[0]
        self.device, self.sw_impl = first.device, first.sw_impl
        self.mesh = first.mesh
        self.seed_impl = first.seed_impl
        self.cfg = first.cfg                  # auto defaults resolved
        self._em_stream = first._em_stream
        for sub in self.subs:
            sub._defer_dist_window = True     # window applied at merge
            sub._em_stream = None             # the subs never dispatch EM
        self._cloud_id = 0
        self._id_lock = threading.Lock()
        self._contig_blob = None
        self._defer_dist_window = False
        self.replay_sink = None
        self.metrics = None

    def generate_candidates(self, batch: ReadBatch) -> CandidateSet:
        css = [sub.generate_candidates(batch) for sub in self.subs]
        return _merge_candidate_sets(css, self.index.contig_base,
                                     2 * len(batch.ids))


def _merge_candidate_sets(css: List[CandidateSet], contig_base: List[int],
                          n_reads: int) -> CandidateSet:
    """Concatenate per-shard candidates; redo the global filters and
    statistics.  Copied from ema_tpu/core/pipeline.py:1348-1377."""
    if not css:
        return _empty_candidate_set()
    parts = {}
    for f in CandidateSet.__dataclass_fields__:
        vals = [getattr(cs, f) for cs in css]
        if f == "chrom":
            vals = [v + np.int32(contig_base[i]) for i, v in enumerate(vals)]
        parts[f] = np.concatenate(vals)
    cs = CandidateSet(**parts)
    if cs.owner.shape[0] == 0:
        return cs

    # global edit-distance window vs the best-scoring candidate per read
    # (align.c:1020-1024; per-shard filtering used per-shard bests)
    keep = _dist_window_keep(cs.owner, cs.sw, cs.nm + cs.clip, n_reads)
    cs = CandidateSet(**{
        f: getattr(cs, f)[keep] for f in CandidateSet.__dataclass_fields__})

    # global uniqueness + sub stats (mirrors _finalize_candidates)
    n_per = np.bincount(cs.owner, minlength=n_reads)
    cs.unique[:] = n_per[cs.owner] == 1
    _, sub = _best_and_sub(cs.owner, cs.sw, n_reads)
    cs.sub[:] = sub
    cs.sub_n[:] = np.maximum(n_per[cs.owner] - 2, 0)
    return cs


# ----------------------------------------------------------------------
# numpy helpers, copied from ema_tpu/core/pipeline.py:1380-1524
# ----------------------------------------------------------------------

def _dist_window_keep(owner: np.ndarray, scores: np.ndarray,
                      dist: np.ndarray, n_owners: int) -> np.ndarray:
    """Keep candidates within EXTRA_SEARCH_DEPTH of the owner's leader.

    Leader = the owner's highest-scoring candidate (first in array order
    on ties), whose clip+edit distance anchors the window — the
    reference's regs.a[0] (align.c:1020-1024).
    """
    N = owner.shape[0]
    if N == 0:
        return np.zeros(0, bool)
    order = np.lexsort((np.arange(N), -scores.astype(np.int64), owner))
    o_sorted = owner[order]
    lead = np.ones(N, bool)
    lead[1:] = o_sorted[1:] != o_sorted[:-1]
    li = order[lead]
    leader_of = np.zeros(n_owners, np.int64)
    leader_of[owner[li]] = li
    best_dist = dist[leader_of[owner]]
    is_leader = np.zeros(N, bool)
    is_leader[li] = True
    return is_leader | (dist - best_dist <= config.EXTRA_SEARCH_DEPTH)


def _best_and_sub(owner: np.ndarray, scores: np.ndarray, n_owners: int):
    """Per-candidate (best, second-best-as-sub) over owner groups.

    ``sub`` for a best-scoring candidate is the max among the owner's
    *other* candidates (one occurrence of the max masked out, first in
    array order); for a non-best candidate it is the owner's best.
    """
    N = owner.shape[0]
    best = np.zeros(n_owners, np.int64)
    np.maximum.at(best, owner, scores)
    is_best = scores == best[owner]
    first_best = np.zeros(N, bool)
    if N:
        # sort each owner's best entries first (stably by index): the
        # group leader is that owner's first best candidate in array order
        order = np.lexsort((np.arange(N), ~is_best, owner))
        o_sorted = owner[order]
        lead = np.ones(N, bool)
        lead[1:] = o_sorted[1:] != o_sorted[:-1]
        first_best[order[lead]] = True
    second = np.zeros(n_owners, np.int64)
    np.maximum.at(second, owner[~first_best], scores[~first_best])
    sub = np.where(is_best, second[owner], best[owner])
    return best, sub


def _compact_seed_hits(seed_stack, n_seeds: np.ndarray, max_hits: int):
    """Dense per-seed SA intervals -> flat hit rows (host, vectorized).

    seed_stack: 4 planes (lo, hi, qb, len), each [B, S] int32 — kept
    narrow until after the compacting gathers.  Intervals wider than
    ``max_hits`` are evenly sampled (BWA max_occ capping,
    src/align.c:185).  Returns (owner [H], qb [H], seed_len [H],
    sa_rows [H]) int64 arrays.
    """
    s_lo, s_hi, s_qb, s_len = seed_stack
    B, S = s_lo.shape
    live = np.arange(S)[None, :] < n_seeds[:, None]
    width = np.where(live, np.maximum(s_hi - s_lo, 0), 0)
    take = np.minimum(width, max_hits)
    b_idx, s_idx = np.nonzero(take)
    take_f = take[b_idx, s_idx].astype(np.int64)
    total = int(take_f.sum())
    if total == 0:
        z = np.zeros(0, np.int64)
        return z, z, z, z
    off = np.zeros(take_f.shape[0], np.int64)
    np.cumsum(take_f[:-1], out=off[1:])
    rep = np.repeat(np.arange(take_f.shape[0]), take_f)
    i_loc = np.arange(total, dtype=np.int64) - off[rep]
    w = width[b_idx, s_idx].astype(np.int64)[rep]
    t = take_f[rep]
    rows = (s_lo[b_idx, s_idx].astype(np.int64)[rep]
            + np.where(w > t, (i_loc * w) // t, i_loc))
    return (b_idx[rep].astype(np.int64),
            s_qb[b_idx, s_idx].astype(np.int64)[rep],
            s_len[b_idx, s_idx].astype(np.int64)[rep], rows)


def locate_rows(fma, rows: np.ndarray) -> np.ndarray:
    """Device locate over a flat row list (ema_tpu/core/pipeline.py:
    1468-1495), in LOCATE_CHUNK windows that bound the device memory of
    one call (torch compiles nothing, so no shape buckets).  int64 out."""
    H = rows.shape[0]
    out = np.empty(H, np.int64)
    dev = fma.occ_blocks.device
    for s in range(0, H, LOCATE_CHUNK):
        r = torch.from_numpy(
            np.ascontiguousarray(rows[s:s + LOCATE_CHUNK], np.int64))
        out[s:s + r.shape[0]] = fm.locate(fma, r.to(dev)).cpu().numpy()
    return out


def _reorder_batch(batch: ReadBatch, order: np.ndarray) -> ReadBatch:
    """Reorder a ReadBatch's pairs by ``order``."""
    rows = np.stack([2 * order, 2 * order + 1], axis=1).reshape(-1)
    return ReadBatch(
        ids=[batch.ids[i] for i in order],
        bc=batch.bc[order],
        seqs=[batch.seqs[r] for r in rows],
        quals=[batch.quals[r] for r in rows],
        codes=batch.codes[rows],
        lens=batch.lens[rows])


def _cigar_ref_len(cigars: np.ndarray, n_cigar: np.ndarray) -> np.ndarray:
    B, max_ops = cigars.shape
    off = np.arange(B, dtype=np.int64) * max_ops
    return native.cigar_stats_pool(cigars, off, n_cigar)[4]


def _empty_candidate_set() -> CandidateSet:
    z = np.zeros(0, np.int64)
    z32 = np.zeros(0, np.int32)
    return CandidateSet(
        owner=z, rev=np.zeros(0, np.int8), gpos=z, chrom=z32, pos_local=z,
        sw=z32, qb=z32, qe=z32, clip=z32, nm=z32,
        cigars=np.zeros((0, MAX_CIGAR_OPS), np.uint32), n_cigar=z32,
        seedcov=z32, sub=z32, sub_n=z32,
        frac_rep=np.zeros(0, np.float32), unique=np.zeros(0, bool))
