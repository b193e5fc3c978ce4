// Peak int32 ALU probe for Hopper (sm_90a): the denominator of the banded
// SW kernels' roofline share.  Built by ema_tpu_torch/ops/_build.py with
// nvcc into a shared library with a plain C interface, called through
// ctypes (wrapper and plain version: ema_tpu_torch/ops/probe.py).
//
// Replaces the TPU kernel `kern` of tools/bench_sw.py:child_vpu_probe
// (:193-206, pallas_call at :209).  There one (8, 128) int32 vector
// register per chain ran K = 16384 rounds x UNROLL 32 of
//     acc_j = max(acc_j ^ (i + u), acc_j + j)      j = 0..7
// starting from acc_j = x + j, and the 8 chains were xor-folded into the
// output.  Here every thread runs that recurrence on its own element, with
// the same constants, the same 8 chains, the same order and the same fold;
// the wrapper sizes the grid to fill the card (every SM at its resident
// thread limit), not to the TPU's [8, 128] block.
//
// What bounds it: nothing but the integer pipes.  Eight independent
// chains give each thread 8-way instruction-level parallelism, the state
// is 8 registers, and memory is touched once per thread.  The xor with the
// loop index keeps the compiler from folding the rounds; the add is done
// in uint32 and reinterpreted, so no signed overflow licenses a rewrite (at
// the TPU constants the chains peak near 4.2e7 and never wrap anyway).
// Chain 0 adds 0, which the compiler drops, as the TPU's did: the op count
// (elements x K x 8 x UNROLL x 3) is the TPU tool's.
//
// Three forms, chosen by the `form` launch argument:
//   0 alu    xor, add and max written as three operations;
//   1 dpx    __viaddmax_s32(acc, j, acc ^ (i + u)) = max(acc + j, acc ^ c),
//            the DPX intrinsic for the add and the max;
//   2 s16x2  the same recurrence on the two int16 halves of every element
//            and chain, each half wrapping at 16 bits:
//            __viaddmax_s16x2(acc, (j, j), acc ^ (c, c)).  It reads the
//            card's rate for the packed instructions that the int16 SW
//            kernel (sw_banded16.cu) is built from.
// alu and dpx are counted at 3 ops per step, so that the two rates
// compare.  For sm_90a ptxas fuses the alu form's add and max into the
// same VIADDMNMX the dpx form asks for, so the two compile to one SASS
// body: a LOP3 and a VIADDMNMX per chain step (chain 0: LOP3 and VIMNMX).
// bench_sw records the opcode counts of all three with cuobjdump.

#include "sw_common.cuh"

namespace {

constexpr int kChains = 8;
constexpr int kThreads = 256;

__device__ __forceinline__ int32_t add_wrap(int32_t a, int32_t b) {
    return (int32_t)((uint32_t)a + (uint32_t)b);
}

__device__ __forceinline__ uint32_t pair(int32_t v) {
    return ((uint32_t)v & 0xffffu) * 0x00010001u;
}

template <int UNROLL, int FORM>
__global__ void __launch_bounds__(kThreads)
alu_probe_kernel(const int32_t *__restrict__ x, int32_t *__restrict__ out,
                 int64_t n, int32_t K) {
    const int64_t e = (int64_t)blockIdx.x * kThreads + threadIdx.x;
    if (e >= n) return;
    const int32_t x0 = x[e];
    int32_t acc[kChains];
#pragma unroll
    for (int j = 0; j < kChains; ++j)
        acc[j] = FORM == 2 ? (int32_t)__vadd2((uint32_t)x0, pair(j))
                           : add_wrap(x0, j);
    for (int32_t i = 1; i <= K; ++i) {
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            const int32_t c = add_wrap(i, u);
#pragma unroll
            for (int j = 0; j < kChains; ++j) {
                if constexpr (FORM == 2) {
                    const uint32_t a = (uint32_t)acc[j];
                    acc[j] = (int32_t)__viaddmax_s16x2(a, pair(j),
                                                       a ^ pair(c));
                } else if constexpr (FORM == 1) {
                    acc[j] = __viaddmax_s32(acc[j], j, acc[j] ^ c);
                } else {
                    const int32_t t = acc[j] ^ c;
                    const int32_t s = add_wrap(acc[j], j);
                    acc[j] = t > s ? t : s;
                }
            }
        }
    }
    int32_t tot = acc[0];
#pragma unroll
    for (int j = 1; j < kChains; ++j) tot ^= acc[j];
    out[e] = tot;
}

template <int UNROLL>
void launch(const int32_t *x, int32_t *out, int64_t n, int32_t K, int form,
            cudaStream_t stream) {
    const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
    if (form == 2)
        alu_probe_kernel<UNROLL, 2><<<blocks, kThreads, 0, stream>>>(
            x, out, n, K);
    else if (form == 1)
        alu_probe_kernel<UNROLL, 1><<<blocks, kThreads, 0, stream>>>(
            x, out, n, K);
    else
        alu_probe_kernel<UNROLL, 0><<<blocks, kThreads, 0, stream>>>(
            x, out, n, K);
}

}  // namespace

// One small kernel per s16x2 operation of sw_banded16.cu, never launched:
// bench_sw reads from their SASS (cuobjdump) what each operation compiles
// to on this architecture, against `base` (two loads, an xor, a store).
#define S16X2_FORM(name, expr)                                              \
    extern "C" __global__ void s16x2_form_##name(                           \
        const uint32_t *__restrict__ a, const uint32_t *__restrict__ b,     \
        uint32_t *__restrict__ o) {                                         \
        const uint32_t x = a[threadIdx.x], y = b[threadIdx.x];              \
        o[threadIdx.x] = (expr);                                            \
    }

__device__ __forceinline__ uint32_t vibmax_mask(uint32_t x, uint32_t y) {
    bool hi, lo;
    const uint32_t m = __vibmax_s16x2(x, y, &hi, &lo);
    return m ^ ((lo ? 0x0000ffffu : 0u) | (hi ? 0xffff0000u : 0u));
}

S16X2_FORM(base, x ^ y)
S16X2_FORM(vcmpges2, __vcmpges2(x, y))
S16X2_FORM(vcmpgts2, __vcmpgts2(x, y))
S16X2_FORM(vadd2, __vadd2(x, y))
S16X2_FORM(vsub2, __vsub2(x, y))
S16X2_FORM(vmaxs2, __vmaxs2(x, y))
S16X2_FORM(vibmax_s16x2, vibmax_mask(x, y))
S16X2_FORM(viaddmax_s16x2, __viaddmax_s16x2(x, y, x ^ y))
S16X2_FORM(vimax3_s16x2, __vimax3_s16x2(x, y, x ^ y))
S16X2_FORM(sign_mask, sw::prmt(__vsub2(x, y), 0, 0xbb99))
#undef S16X2_FORM

extern "C" {

// out[e] = the probe of x[e] (both int32 [n]) for K rounds of `unroll`
// steps (unroll in 1, 2, 4, 8, 16, 32), in the alu (form 0), the dpx (1)
// or the s16x2 (2) form, on `stream`.  Returns the launch's cudaGetLastError() (0 on
// success); does not synchronise.
int alu_probe_launch(const void *x, void *out, int64_t n, int32_t K,
                     int32_t unroll, int32_t form, void *stream) {
    if (n <= 0) return 0;
    if (K < 0 || form < 0 || form > 2) return (int)cudaErrorInvalidValue;
    const auto *xi = static_cast<const int32_t *>(x);
    auto *o = static_cast<int32_t *>(out);
    auto s = static_cast<cudaStream_t>(stream);
    switch (unroll) {
        case 1: launch<1>(xi, o, n, K, form, s); break;
        case 2: launch<2>(xi, o, n, K, form, s); break;
        case 4: launch<4>(xi, o, n, K, form, s); break;
        case 8: launch<8>(xi, o, n, K, form, s); break;
        case 16: launch<16>(xi, o, n, K, form, s); break;
        case 32: launch<32>(xi, o, n, K, form, s); break;
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
