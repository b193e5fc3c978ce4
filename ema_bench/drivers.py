"""The two ways a cell drives the port, chosen by its configuration's
``driver``:

- ``stream``: ``Aligner.align_stream`` over
  ``ema_tpu_torch.io.iter_fastq_pair_groups`` on barcode-sorted FASTQs,
  as ``align -1/-2`` runs it, its SAM lines written to a file; one unit
  is one pass over the pool.
- ``x``: ``ema_tpu_torch.cli.main(["align", "-x", "-d", ...])`` in this
  process over bucket files that the port's ``count`` and ``preproc``
  made in set-up; one unit is one call over ``buckets_per_call``
  buckets, cycling (the warm-up call takes the first ``warm_buckets``).

Each driver has ``setup`` (everything before the first timed unit, a
warm-up unit included) and ``window`` (units until ``seconds`` have
passed, ending at the first boundary after them: a yielded list of SAM
lines for ``stream``, a call for ``x``).
"""

from __future__ import annotations

import contextlib
import os
import shutil
import time

import numpy as np

from ema_bench import buckets, generate, samcheck


@contextlib.contextmanager
def _stage_tables(into: list):
    """The stage table of each ``Metrics`` that reports in the block
    (the CLI's, once per call), kept in ``into`` as {stage: seconds}
    at full precision and not printed."""
    from ema_tpu_torch.utils import metrics as pmetrics
    real = pmetrics.Metrics.report

    def report(self, stream=None):
        into.append(dict(self.wall))
    pmetrics.Metrics.report = report
    try:
        yield
    finally:
        pmetrics.Metrics.report = real


def _qname_group(line: str) -> int:
    """The group of a SAM line's pair: the ``g<group>p<k>`` of
    ``generate.read_name``, wherever it stands in the QNAME (the QNAME
    leads the line, and a well number holds no ``g``)."""
    i = line.index("g")
    return int(line[i + 1:line.index("p", i)])


def take_lines(lines, got, need, sampled, kept) -> list:
    """The groups whose last SAM line is in ``lines``, counted in ``got``
    against the lines each group is due (``need``); the lines of groups
    marked in ``sampled`` go to ``kept``.  Where ``lines`` is whole groups
    in order, as the port emits them, only its first and last lines are
    read."""
    a, b = _qname_group(lines[0]), _qname_group(lines[-1])
    if a <= b and not got[a:b + 1].any() and \
            int(need[a:b + 1].sum()) == len(lines):
        got[a:b + 1] = need[a:b + 1]
        off = np.concatenate([[0], np.cumsum(need[a:b + 1])])
        for j in np.flatnonzero(sampled[a:b + 1]).tolist():
            kept.extend(lines[off[j]:off[j + 1]])
        return range(a, b + 1)
    done = []
    for ln in lines:
        g = _qname_group(ln)
        got[g] += 1
        if sampled[g]:
            kept.append(ln)
        if got[g] == need[g]:
            done.append(g)
    return done


class StreamDriver:
    def __init__(self, run):
        self.run = run
        # (kept lines, completed, sampled: bool per group) of each pass
        self.units = []
        self.latencies = []

    def setup(self) -> None:
        run = self.run
        cfg = run.config
        from ema_tpu_torch import config as pconfig
        from ema_tpu_torch.core.pipeline import Aligner
        from ema_tpu_torch.index import ReferenceIndex

        self.f1 = os.path.join(run.tmp, "r1.fq")
        self.f2 = os.path.join(run.tmp, "r2.fq")
        generate.write_pair_fastqs(run.pool, self.f1, self.f2)
        # the warm-up unit: the pool's first flush batch of whole groups
        flush = int(cfg["aligner"]["flush_pairs"])
        g = run.pool.group
        n_warm = int(np.searchsorted(g, g[min(flush, run.pool.n - 1)],
                                     side="right"))
        self.w1 = os.path.join(run.tmp, "w1.fq")
        self.w2 = os.path.join(run.tmp, "w2.fq")
        for src, dst in ((self.f1, self.w1), (self.f2, self.w2)):
            with open(src) as a, open(dst, "w") as b:
                for i, ln in enumerate(a):
                    if i >= 4 * n_warm:
                        break
                    b.write(ln)
        idx = ReferenceIndex.load(run.ref.index)
        self.aligner = Aligner(
            idx, pconfig.RunConfig(platform=pconfig.get_platform_profile(
                cfg["platform"])), device=run.device)
        self.flush = flush
        # SAM lines each group is due: one record per mate
        self.lines_of_group = 2 * np.bincount(g)
        self._pass(self.w1, self.w2, None, self._sample(-1))

    def _sample(self, k: int) -> np.ndarray:
        """The groups whose lines the check reads in pass ``k``, drawn
        from the seed anew for each pass, so that the passes over the
        one pool check different groups."""
        share = float(self.run.config["check_group_share"])
        rng = np.random.default_rng([self.run.seed, 5, k + 1])
        return rng.random(self.lines_of_group.shape[0]) < share

    def _pass(self, f1, f2, deadline, sampled):
        """One ``align_stream`` over ``f1``/``f2`` into a counting sink
        that keeps the lines of the ``sampled`` groups.  Returns (stopped
        at the deadline, bool per group: completed, the kept lines)."""
        from ema_tpu_torch import io as pio
        spans = self.run.spans
        pulled = []

        def groups():
            it = pio.iter_fastq_pair_groups(f1, f2, self.run.config[
                "platform"])
            while True:
                t0 = time.time_ns()
                g = next(it, None)
                if g is None:
                    return
                t1 = time.time_ns()
                spans.add("iter_fastq_pair_groups", t0, t1)
                pulled.append(t1)
                yield g

        need = self.lines_of_group
        got = np.zeros(need.shape[0], np.int64)
        kept = []
        stopped = False
        stream = self.aligner.align_stream(groups(), flush_pairs=self.flush)
        try:
            while True:
                t0 = time.time_ns()
                lines = next(stream, None)
                t1 = time.time_ns()
                spans.add("align_stream", t0, t1)
                if lines is None:
                    break
                if lines:
                    for g in take_lines(lines, got, need, sampled, kept):
                        self.latencies.append((t1 - pulled[g]) / 1e9)
                spans.add("sink", t1, time.time_ns())
                if deadline is not None and t1 >= deadline:
                    stopped = True
                    break
        finally:
            if stopped:
                self.run.close_window()
            stream.close()
        return stopped, got == need, kept

    def window(self, seconds: float) -> None:
        run = self.run
        deadline = run.window_start + int(seconds * 1e9)
        stopped = False
        ends = []
        while not stopped:
            sampled = self._sample(len(self.units))
            stopped, done, kept = self._pass(self.f1, self.f2, deadline,
                                             sampled)
            self.units.append((kept, done, sampled))
            ends.append((time.time_ns() - run.window_start) / 1e9)
        run.log("passes end at (s): " + " ".join(f"{t:.3f}" for t in ends))

    def collect(self, recs: samcheck.Records) -> int:
        """Feed the sampled groups' lines to ``recs``; returns the pairs
        of every group completed in the window."""
        g = self.run.pool.group
        n_lines = 0
        for kept, done, sampled in self.units:
            n_lines += int(self.lines_of_group[done].sum())
            recs.add_unit(kept, (done & sampled)[g])
        self.units = []
        return n_lines // 2


class XDriver:
    def __init__(self, run):
        cfg = run.config
        if cfg["platform"] != "10x":
            raise SystemExit(
                f"ema_bench: configuration {cfg['name']!r} is "
                f"{cfg['platform']}; the x driver's buckets come from the "
                "port's preproc, which is 10x-only (16 bp barcodes): run "
                "it with the stream driver")
        self.run = run
        self.calls = []     # (bucket indices, out path, wall s, stages)

    def setup(self) -> None:
        run = self.run
        cfg = run.config
        from ema_tpu_torch.preproc.correct import correct
        from ema_tpu_torch.preproc.count import count

        rng = np.random.default_rng([run.seed, 3])
        fq = os.path.join(run.tmp, "inter.fq")
        wl = os.path.join(run.tmp, "whitelist.txt")
        generate.write_interleaved_fastq(rng, run.pool, fq,
                                         int(cfg["reads"]["spacer"]))
        generate.write_whitelist(rng, run.pool, wl,
                                 int(run.traffic["whitelist_decoys"]))
        prefix = os.path.join(run.tmp, "cnt")
        with open(fq, "rb") as f:
            count(wl, prefix, f)
        self.bdir = os.path.join(run.tmp, "bkt")
        n_b = int(cfg["buckets"])
        with open(fq, "rb") as f:
            correct(wl, [prefix + ".ema-ncnt"], self.bdir, f,
                    n_buckets=n_b)
        os.unlink(fq)
        names = sorted(n for n in os.listdir(self.bdir)
                       if n.startswith("ema-bin-"))
        self.buckets = [os.path.join(self.bdir, n) for n in names]
        self.whitelist = wl
        self.per_call = int(run.traffic["buckets_per_call"])
        self.next = 0
        self._call(list(range(int(run.traffic["warm_buckets"]))), warm=True)

    def _call(self, idx: list, warm: bool = False) -> None:
        """One ``align -x -d`` call over the buckets ``idx``; a warm-up
        call's output is dropped, a timed one's kept for the check."""
        run = self.run
        from ema_tpu_torch import cli
        out = os.path.join(run.tmp, f"x{len(self.calls)}.sam")
        args = ["align", "-r", run.ref.fasta, "--device", str(run.device),
                "-x", "-d", "-o", out] + [self.buckets[i] for i in idx]
        tables = []
        t0 = time.time_ns()
        with _stage_tables(tables):
            rc = cli.main(args)
        t1 = time.time_ns()
        run.spans.add("cli.main align -x", t0, t1)
        if rc != 0 or len(tables) != 1:
            raise RuntimeError(f"align -x exited {rc}")
        if warm:
            os.unlink(out)
            shutil.rmtree(out + ".parts", ignore_errors=True)
            return
        self.calls.append((idx, out, (t1 - t0) / 1e9, tables[0]))

    def _next_buckets(self) -> list:
        nb = len(self.buckets)
        idx = [(self.next + i) % nb for i in range(self.per_call)]
        self.next = (self.next + self.per_call) % nb
        return idx

    def window(self, seconds: float) -> None:
        run = self.run
        deadline = run.window_start + int(seconds * 1e9)
        while True:
            self._call(self._next_buckets())
            if time.time_ns() >= deadline:
                break
        run.close_window()
        run.log("calls (buckets, wall s, align s, index_load s): " + "; ".join(
            f"{idx} {wall:.3f} {st.get('align', 0):.3f} "
            f"{st.get('index_load', 0):.3f}"
            for idx, _, wall, st in self.calls))

    def collect(self, recs: samcheck.Records) -> int:
        """The check's expectation of each pair's bucket comes from the
        generator's barcodes and whitelist by preproc's rule
        (``buckets.expected``); the program's bucket files are held
        against it, and each call's due pairs and MI namespaces follow
        from it."""
        pool = self.run.pool
        with open(self.whitelist) as f:
            wl = [ln.strip() for ln in f if ln.strip()]
        want = buckets.expected(wl, pool.bcs, len(self.buckets))
        recs.bucket_wrong += buckets.misplaced(want, pool.names,
                                               self.buckets)
        n_lines = 0
        for idx, out, _, _ in self.calls:
            pos = np.full(want.shape[0], -1, np.int64)
            for j, b in enumerate(idx):
                pos[want == b] = j
            due = pos >= 0
            with open(out) as f:
                lines = f.readlines()
            n_lines += sum(1 for ln in lines if not ln.startswith("@"))
            recs.add_unit(lines, due, mi_ns=pos,
                          mi_shift=max(31 - max(len(idx) - 1, 1)
                                       .bit_length(), 10))
            del lines
            os.unlink(out)
            shutil.rmtree(out + ".parts", ignore_errors=True)
        return n_lines // 2

    def stages(self) -> dict:
        out = {}
        for _, _, _, table in self.calls:
            for k, v in table.items():
                out[k] = out.get(k, 0.0) + v
        return out


DRIVERS = {"stream": StreamDriver, "x": XDriver}
