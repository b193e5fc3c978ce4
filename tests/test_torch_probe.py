"""The port's int32 ALU probe and SW micro-benchmark against the JAX
tool (tools/bench_sw.py), on the CPU.

The probe's plain version must give the bits of the Pallas kernel of
tools/bench_sw.py:193-206 (run here in interpret mode, its TPU memory
spaces dropped: child_vpu_probe itself exits off a TPU) and of a numpy
transcription of it.  The micro-benchmark's gather layout must score as
the raw [B, n] arrays do, and its `cpu` mode must find every variant
bit-exact.  The CUDA forms run on the card in chip_smoke.py.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from ema_tpu.ops import sw as jax_sw
from ema_tpu_torch.ops import probe
from ema_tpu_torch.ops.sw import (gather_score, sw_score_banded16_ref,
                                  sw_score_banded_packed_ref,
                                  sw_score_banded_ref, sw_score_batch_ref)
from ema_tpu_torch.tools import bench_sw

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHAINS = 8


def _numpy_probe(x, K, UNROLL):
    """tools/bench_sw.py:193-206 in numpy int32."""
    accs = [x + np.int32(j) for j in range(CHAINS)]
    for i in range(1, K + 1):
        for u in range(UNROLL):
            accs = [np.maximum(a ^ np.int32(i + u), a + np.int32(j))
                    for j, a in enumerate(accs)]
    tot = accs[0]
    for a in accs[1:]:
        tot = tot ^ a
    return tot


def _pallas_probe(x, K, UNROLL):
    """The Pallas kernel of tools/bench_sw.py:193-213 in interpret mode,
    without the TPU memory-space BlockSpecs."""
    def kern(x_ref, o_ref):
        accs = [x_ref[:] + j for j in range(CHAINS)]

        def body(i, accs):
            for u in range(UNROLL):
                accs = tuple(jnp.maximum(a ^ (i + u), a + j)
                             for j, a in enumerate(accs))
            return accs

        accs = jax.lax.fori_loop(np.int32(1), np.int32(K + 1), body,
                                 tuple(accs))
        tot = accs[0]
        for a in accs[1:]:
            tot = tot ^ a
        o_ref[:] = tot

    return np.asarray(pl.pallas_call(
        kern, out_shape=jax.ShapeDtypeStruct(x.shape, jnp.int32),
        interpret=True)(jnp.asarray(x)))


# (K, UNROLL, shape): the TPU tool's [8, 128] block and a ragged one
PROBE_CASES = [(64, 4, (8, 128)), (16, 32, (8, 128)), (9, 2, (3, 40)),
               (0, 1, (8, 128))]


@pytest.mark.parametrize("K,unroll,shape", PROBE_CASES)
def test_probe_ref_equals_pallas_and_numpy(K, unroll, shape):
    x = np.arange(np.prod(shape), dtype=np.int32).reshape(shape)
    want = _numpy_probe(x, K, unroll)
    np.testing.assert_array_equal(_pallas_probe(x, K, unroll), want)
    got = probe.alu_probe_ref(torch.from_numpy(x), K, unroll)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # the wrapper runs the plain version on a CPU tensor, in either form
    for form in ("alu", "dpx"):
        np.testing.assert_array_equal(
            probe.alu_probe(torch.from_numpy(x), K, unroll, form).numpy(),
            want)


def _numpy_probe_s16x2(x, K, unroll):
    """The s16x2 form as a loop over the int16 halves of every element:
    python ints wrapped to 16 bits after every add."""
    def wrap(v):
        return (v + 0x8000) % 0x10000 - 0x8000

    halves = x.reshape(-1).view(np.int16)
    out = np.empty_like(halves)
    for e, h in enumerate(halves.tolist()):
        acc = [wrap(h + j) for j in range(probe.CHAINS)]
        for i in range(1, K + 1):
            for u in range(unroll):
                c = wrap(i + u)
                acc = [max(a ^ c, wrap(a + j)) for j, a in enumerate(acc)]
        tot = 0
        for a in acc:
            tot ^= a
        out[e] = tot
    return out.view(np.int32).reshape(x.shape)


@pytest.mark.parametrize("K,unroll,shape", [(64, 4, (4, 16)), (16, 32, (32,)),
                                            (9, 2, (3, 5)), (0, 1, (8,))])
def test_probe_s16x2_ref_equals_numpy(K, unroll, shape):
    """The plain version of the probe's s16x2 form against a numpy loop,
    on halves near both ends of int16 (so that adds wrap) and small ones;
    the wrapper runs it on a CPU tensor."""
    rng = np.random.default_rng(K + unroll)
    n = int(np.prod(shape))
    halves = rng.integers(-40, 40, 2 * n).astype(np.int16)
    edge = rng.random(2 * n) < 0.3
    halves[edge] = rng.choice([32767, 32760, -32768, -32761, 16384],
                              int(edge.sum())).astype(np.int16)
    x = halves.view(np.int32).reshape(shape)
    want = _numpy_probe_s16x2(x, K, unroll)
    got = probe.alu_probe_s16x2_ref(torch.from_numpy(x), K, unroll)
    assert got.dtype == torch.int32 and got.shape == x.shape
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        probe.alu_probe(torch.from_numpy(x), K, unroll, "s16x2").numpy(),
        want)
    if K:
        assert not np.array_equal(
            want, probe.alu_probe_ref(torch.from_numpy(x), K,
                                      unroll).numpy())


def test_probe_ops_and_refusals():
    """The op count is the TPU tool's OPS at its constants (:190-191);
    the wrapper refuses what the kernel does not take."""
    assert probe.probe_ops(8 * 128, probe.K_TPU, probe.UNROLL_TPU) == \
        8 * 128 * (1 << 14) * 8 * 32 * 3
    x = torch.arange(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="unroll"):
        probe.alu_probe(x, 4, 3)
    with pytest.raises(ValueError, match="form"):
        probe.alu_probe(x, 4, 4, "vpu")
    with pytest.raises(ValueError, match="int32"):
        probe.alu_probe(x.long(), 4, 4)


@pytest.fixture(scope="module")
def case():
    B, m, n, W = 48, *bench_sw.SHAPE[1:]
    reads, rlens, refs, nlens = bench_sw.make_case(B, m, n, W)
    return reads, rlens, refs, nlens, W


@pytest.mark.parametrize("scorer", ["banded", "banded16", "packed", "scan"])
def test_gather_layout_equals_raw_arrays(scorer, case):
    """The B windows laid end to end as the text, scored through
    gather_score, give the plain scorer's result on the raw [B, n] refs
    (and the JAX package's XLA sweeps)."""
    reads, rlens, refs, nlens, W = case
    B = reads.shape[0]
    wl = bench_sw._case_wl(B) if scorer == "packed" else np.full(B, W,
                                                                 np.int32)
    lay = bench_sw.gather_layout(reads, rlens, refs, nlens, wl,
                                 torch.device("cpu"))
    got = gather_score(lay["text"], lay["oriented"], lay["olens"],
                       lay["owners"], lay["win_lo"], lay["win_len"],
                       lay["wl"], scorer=scorer, **bench_sw.SW_KW).numpy()
    raw = [torch.from_numpy(a) for a in (reads, rlens, refs, nlens)]
    wl_t = torch.from_numpy(wl)
    if scorer == "scan":
        want = sw_score_batch_ref(*raw, **bench_sw.SW_KW)
        jx = jax_sw.sw_score_batch(*map(jnp.asarray, (reads, rlens, refs,
                                                      nlens)))
    elif scorer == "packed":
        want = sw_score_banded_packed_ref(*raw, wl_t, **bench_sw.SW_KW)
        jx = jax_sw.sw_score_banded(*map(jnp.asarray, (reads, rlens, refs,
                                                       nlens)), W,
                                    wl=jnp.asarray(wl))
    else:
        fn = sw_score_banded16_ref if scorer == "banded16" else \
            sw_score_banded_ref
        want = fn(*raw, W, wl=wl_t, **bench_sw.SW_KW)
        jx = jax_sw.sw_score_banded(*map(jnp.asarray, (reads, rlens, refs,
                                                       nlens)), W)
    np.testing.assert_array_equal(got, want.numpy())
    for c, k in enumerate(bench_sw.OUTS):
        np.testing.assert_array_equal(got[:, c], np.asarray(jx[k]))


def test_bench_sw_cpu_mode(tmp_path):
    """`python -m ema_tpu_torch.tools.bench_sw cpu` at a small B: every
    variant bit-exact, packed against its wl-masked plain version, no
    probe step, no card numbers."""
    out = tmp_path / "bench_sw.json"
    env = dict(os.environ, EMA_TPU_BENCH_SW_B="32")
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    r = subprocess.run([sys.executable, "-m", "ema_tpu_torch.tools.bench_sw",
                        "cpu", "--json", str(out)], cwd=str(tmp_path),
                       env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr
    art = json.loads(out.read_text())
    assert art["shape"] == {"B": 32, "m": 100, "n": 192, "W": 128}
    assert art["bit_exact_across_variants"] is True
    assert art["packed_bit_exact_vs_wl_masked_ref"] is True
    assert set(art["variants"]) == {"banded-pallas", "banded-packed",
                                    "banded16", "pallas", "banded-scan",
                                    "scan"}
    assert art["device"] == "cpu" and "vpu_int32_tops_measured" not in art
    assert "banded_roofline_pct" not in art
    assert art["pipeline_wl_samples"] > 0
