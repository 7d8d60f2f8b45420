// Fused Ed25519 comb accumulation: [S]B + [k](-A) for a batch of signatures,
// as 64 ref10 mixed additions of rows read from the per-key fused tables.
//
// Replaces: the Pallas kernel simple_pbft_tpu/ops/comb.py:452-491
// (_madd_loop_kernel / _madd_loop_pallas), and fuses the gather that fed it
// (_gather_rows, comb.py:342-352): rows are read straight from the table
// bank, so the (npos, 64, B) staging tensor of gathered rows is never built.
//
// Contract (plain PyTorch version: ops/comb.py madd_loop_plain):
//   idx    (npos, B) int32, idx[pos, lane] = row of f_flat for that position
//   f_flat (M, 64)   int32, dense Niels rows [y+x | y-x | 2dxy | 13 pad]
//   out    (4*17, B) int32, extended X, Y, Z, T limbs, batch-minor
// The arithmetic is the JAX package's 17 x 15-bit pad-accumulate field
// multiply with its two parallel carry passes (field25519.mul_padacc,
// _carry_pass, mul_small, _two_p), so the output is limb-for-limb equal to
// the plain version, not merely equal mod p.
//
// What bounds it on an H100 (per signature lane, npos = 64):
//   bytes:      64 row reads of 204 payload bytes (13,056 B) + 64 indices
//               (256 B) + 68 output limbs (272 B) = 13,584 B; at B = 8192
//               and 3.35 TB/s, 0.033 ms if every row were distinct.
//   operations: 64 x (7 field muls x 289 limb products + 17 for mul_small)
//               = 130,560 int32 multiplies; at B = 8192 that is 1.07e9,
//               and Hopper issues 64 int32 multiplies per SM per clock
//               (132 SMs x 1.98 GHz = 16.7e12/s): 0.064 ms. The split,
//               mask and column adds of every product add ~3x more int32
//               ALU work on top. So the kernel is bound by integer
//               operations, not by memory.
// What the design does about it: one thread per lane keeps the four
// 17-limb coordinates and every field-mul temporary in registers across all
// 64 dependent mixed adds (no device-memory traffic but the rows), every
// limb loop is fully unrolled so the arrays stay in registers, and each row
// arrives as 13 16-byte vector loads. Output stores are batch-minor, so a
// warp's stores coalesce. Blocks are 128 threads.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NL = 17;                 // limbs per field element
constexpr int RADIX = 15;
constexpr int32_t MASK = (1 << RADIX) - 1;
constexpr int ROW = 64;                // int32 words per table row
constexpr int ROW_VEC = 13;            // 16-byte loads covering 51 payload words
constexpr int THREADS = 128;
constexpr int32_t TWO_P0 = 2 * ((1 << RADIX) - 19);  // 2p, limb 0
constexpr int32_t TWO_P = 2 * MASK;                  // 2p, limbs 1..16

// One parallel carry pass: every limb sheds its carry to the next; the top
// carry folds into limb 0 times 19 (2^255 = 19 mod p). `>>` is arithmetic.
__device__ __forceinline__ void carry_pass(int32_t x[NL]) {
  int32_t c[NL];
#pragma unroll
  for (int i = 0; i < NL; ++i) c[i] = x[i] >> RADIX;
  x[0] = (x[0] & MASK) + 19 * c[NL - 1];
#pragma unroll
  for (int i = 1; i < NL; ++i) x[i] = (x[i] & MASK) + c[i - 1];
}

__device__ __forceinline__ void fe_add(int32_t r[NL], const int32_t a[NL],
                                       const int32_t b[NL]) {
#pragma unroll
  for (int i = 0; i < NL; ++i) r[i] = a[i] + b[i];
  carry_pass(r);
}

// a - b as a + 2p - b (stays nonnegative), one carry pass.
__device__ __forceinline__ void fe_sub(int32_t r[NL], const int32_t a[NL],
                                       const int32_t b[NL]) {
  r[0] = a[0] + TWO_P0 - b[0];
#pragma unroll
  for (int i = 1; i < NL; ++i) r[i] = a[i] + TWO_P - b[i];
  carry_pass(r);
}

// Schoolbook 17 x 17 product, each 30-bit limb product split into its low
// and high 15 bits before it is added into its columns; columns 17..33 fold
// back times 19; two carry passes. r may alias a or b.
__device__ __forceinline__ void fe_mul(int32_t r[NL], const int32_t a[NL],
                                       const int32_t b[NL]) {
  int32_t acc[2 * NL];
#pragma unroll
  for (int k = 0; k < 2 * NL; ++k) acc[k] = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
#pragma unroll
    for (int j = 0; j < NL; ++j) {
      const int32_t p = a[i] * b[j];
      acc[i + j] += p & MASK;
      acc[i + j + 1] += p >> RADIX;
    }
  }
#pragma unroll
  for (int k = 0; k < NL; ++k) r[k] = acc[k] + 19 * acc[NL + k];
  carry_pass(r);
  carry_pass(r);
}

// ref10 ge_madd: (x, y, z, t) += affine Niels (ypx, ymx, xy2d), in place.
__device__ __forceinline__ void madd(int32_t x[NL], int32_t y[NL],
                                     int32_t z[NL], int32_t t[NL],
                                     const int32_t ypx[NL],
                                     const int32_t ymx[NL],
                                     const int32_t xy2d[NL]) {
  int32_t s[NL], a[NL], b[NL], c[NL], d[NL], e[NL], f[NL], g[NL], h[NL];
  fe_add(s, y, x);
  fe_mul(a, s, ypx);
  fe_sub(s, y, x);
  fe_mul(b, s, ymx);
  fe_mul(c, xy2d, t);
#pragma unroll
  for (int i = 0; i < NL; ++i) d[i] = z[i] * 2;  // mul_small(z, 2)
  carry_pass(d);
  carry_pass(d);
  fe_sub(e, a, b);
  fe_sub(f, d, c);
  fe_add(g, d, c);
  fe_add(h, a, b);
  fe_mul(x, e, f);
  fe_mul(y, g, h);
  fe_mul(z, f, g);
  fe_mul(t, e, h);
}

__global__ void __launch_bounds__(THREADS)
fused_accumulate_kernel(const int32_t* __restrict__ idx,
                        const int32_t* __restrict__ f_flat,
                        int32_t* __restrict__ out, int npos, int batch,
                        long long m_rows) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= batch) return;

  int32_t x[NL], y[NL], z[NL], t[NL];  // identity (0, 1, 1, 0)
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    x[i] = 0;
    y[i] = 0;
    z[i] = 0;
    t[i] = 0;
  }
  y[0] = 1;
  z[0] = 1;

  for (int pos = 0; pos < npos; ++pos) {
    const int r = __ldg(idx + (size_t)pos * batch + lane);
    // an index outside the bank is a caller bug: fail loudly, never read
    // another allocation's bytes
    if (r < 0 || (long long)r >= m_rows) __trap();
    const int4* row = reinterpret_cast<const int4*>(f_flat + (size_t)r * ROW);
    int32_t w[4 * ROW_VEC];
#pragma unroll
    for (int q = 0; q < ROW_VEC; ++q) {
      const int4 v = __ldg(row + q);
      w[4 * q + 0] = v.x;
      w[4 * q + 1] = v.y;
      w[4 * q + 2] = v.z;
      w[4 * q + 3] = v.w;
    }
    madd(x, y, z, t, w, w + NL, w + 2 * NL);
  }

#pragma unroll
  for (int i = 0; i < NL; ++i) {
    out[(size_t)(0 * NL + i) * batch + lane] = x[i];
    out[(size_t)(1 * NL + i) * batch + lane] = y[i];
    out[(size_t)(2 * NL + i) * batch + lane] = z[i];
    out[(size_t)(3 * NL + i) * batch + lane] = t[i];
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int fused_accumulate_launch(const int32_t* idx, const int32_t* f_flat,
                                       int32_t* out, int npos, int batch,
                                       long long m_rows, void* stream) {
  if (npos <= 0 || batch <= 0 || m_rows <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((batch + THREADS - 1) / THREADS);
  fused_accumulate_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      idx, f_flat, out, npos, batch, m_rows);
  return (int)cudaGetLastError();
}
