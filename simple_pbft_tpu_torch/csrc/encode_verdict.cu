// Ed25519 verdicts from the accumulated points: affine-normalise each lane's
// [S]B + [k](-A) and compare its canonical encoding with R's wire bytes.
//
// Replaces: the XLA tail of the JAX package's device pass,
// simple_pbft_tpu/ops/comb.py:506 batch_invert and :529 _encode_and_compare,
// with their field helpers field25519.py:319 invert and :149 to_canonical.
// It is not a Pallas kernel there; here it is the second of the two
// launches of a device pass.
//
// Contract (plain PyTorch version: ops/comb.py encode_and_compare_plain):
//   acc      (4*17, B) int32  extended X, Y, Z, T in 17 x 15 limbs (weak form)
//   R, by one of two entries:
//     wire   (B, 96) uint8    S || k || R; R.y is bytes 64..95 without bit
//                             255, R's sign is bit 255 (the fused path)
//     r_y    (17, B) int32    R.y as 17 x 15 limbs, and
//     r_sign (B,) int32       R's sign, as the comb path stages them
//                             (JAX prepare_comb_batch)
//   precheck (B,) bool        the host's validity mask
//   verdict  (B,) bool        canonical(X/Z) parity == sign, canonical(Y/Z)
//                             == canonical(R.y), and precheck
//   affine   (2*17, B) int32  optional: canonical x and y in 17 x 15 limbs
//
// Per lane, one thread: Z^-1 by ref10's Fermat chain (254 squarings, 11
// multiplies), two multiplies, canonical reductions, the compare. The JAX
// package batches the inversion (Montgomery's trick, about 3 multiplies a
// lane plus one chain per 128 lanes); a per-lane chain needs no
// power-of-two batch and no exchange between lanes, and at the committee's
// usual passes of 8 to 512 lanes the card is nearly empty, so one chain's
// latency sets the time whichever way the inversion is organised.
//
// What bounds it on an H100: the work of the JAX function is about 7 field
// multiplies a lane (700 wide products) and 306 bytes a lane; at B = 8192
// that is 0.35 us of multiplies at 64 issues per SM per clock against
// 0.75 us of bytes at 3.35 TB/s, so bytes. This design spends 267
// multiplies a lane (254 of them squarings of 55 products), and its time
// is one lane's chain of 265 dependent multiplies: latency, not either
// bound, sets it.

#include "field25519.cuh"

namespace tail {

using fe25519::fe;

constexpr int NL = 17;
constexpr int WIRE = 96;

// One lane: `x15`, `y15`, `z15` the accumulator's coordinates, `ry` R.y
// (carried limbs), `r_sign` R's sign. Writes the canonical affine x, y as
// 17 x 15 limbs.
FE_FN bool verdict_lane(const int32_t x15[NL], const int32_t y15[NL], const int32_t z15[NL],
                        const fe25519::fe& ry, int r_sign, bool precheck, int32_t x_out[NL],
                        int32_t y_out[NL]) {
  using namespace fe25519;
  const fe zinv = fe_invert(from15(z15));
  const fe x = fe_canonical(fe_mul(from15(x15), zinv));
  const fe y = fe_canonical(fe_mul(from15(y15), zinv));
  to15(x, x_out);
  to15(y, y_out);
  return precheck && fe_equal_canonical(y, fe_canonical(ry)) &&
         fe_parity_canonical(x) == r_sign;
}

// The fused path's lane: `r` R's 32 wire bytes.
FE_FN bool encode_verdict_lane(const int32_t x15[NL], const int32_t y15[NL],
                               const int32_t z15[NL], const uint8_t r[32],
                               bool precheck, int32_t x_out[NL], int32_t y_out[NL]) {
  return verdict_lane(x15, y15, z15, fe25519::from_bytes(r), r[31] >> 7, precheck, x_out,
                      y_out);
}

// The comb path's lane: `ry15` R.y's 17 x 15 limbs, `r_sign` its sign.
FE_FN bool encode_verdict_limbs_lane(const int32_t x15[NL], const int32_t y15[NL],
                                     const int32_t z15[NL], const int32_t ry15[NL],
                                     int r_sign, bool precheck, int32_t x_out[NL],
                                     int32_t y_out[NL]) {
  return verdict_lane(x15, y15, z15, fe25519::from15(ry15), r_sign, precheck, x_out, y_out);
}

}  // namespace tail

#ifdef __CUDACC__

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int NL = tail::NL;

__device__ __forceinline__ void load15(const int32_t* __restrict__ acc, int q, int batch,
                                       int lane, int32_t l[NL]) {
#pragma unroll
  for (int i = 0; i < NL; ++i) l[i] = __ldg(acc + (long long)(q * NL + i) * batch + lane);
}

__device__ __forceinline__ void store_affine(int32_t* __restrict__ affine, int batch,
                                             int lane, const int32_t xo[NL],
                                             const int32_t yo[NL]) {
  if (affine == nullptr) return;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    affine[(long long)i * batch + lane] = xo[i];
    affine[(long long)(NL + i) * batch + lane] = yo[i];
  }
}

__global__ void __launch_bounds__(THREADS)
encode_verdict_kernel(const int32_t* __restrict__ acc, const uint8_t* __restrict__ wire,
                      const bool* __restrict__ precheck, bool* __restrict__ verdict,
                      int32_t* __restrict__ affine, int batch) {
  const int lane = blockIdx.x * THREADS + threadIdx.x;
  if (lane >= batch) return;
  int32_t x15[NL], y15[NL], z15[NL];
  load15(acc, 0, batch, lane, x15);
  load15(acc, 1, batch, lane, y15);
  load15(acc, 2, batch, lane, z15);
  // R is the last 32 bytes of the lane's 96: two 16-byte loads
  const uint4* src = reinterpret_cast<const uint4*>(wire + (long long)lane * tail::WIRE + 64);
  const uint4 lo = __ldg(src), hi = __ldg(src + 1);
  const uint32_t words[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  uint8_t r[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) r[i] = (uint8_t)(words[i / 4] >> (8 * (i % 4)));
  int32_t xo[NL], yo[NL];
  verdict[lane] = tail::encode_verdict_lane(x15, y15, z15, r, precheck[lane], xo, yo);
  store_affine(affine, batch, lane, xo, yo);
}

// The comb path's entry: R.y as (17, B) limbs and R's sign as (B,) int32.
__global__ void __launch_bounds__(THREADS)
encode_verdict_limbs_kernel(const int32_t* __restrict__ acc, const int32_t* __restrict__ r_y,
                            const int32_t* __restrict__ r_sign,
                            const bool* __restrict__ precheck, bool* __restrict__ verdict,
                            int32_t* __restrict__ affine, int batch) {
  const int lane = blockIdx.x * THREADS + threadIdx.x;
  if (lane >= batch) return;
  int32_t x15[NL], y15[NL], z15[NL], ry15[NL];
  load15(acc, 0, batch, lane, x15);
  load15(acc, 1, batch, lane, y15);
  load15(acc, 2, batch, lane, z15);
  load15(r_y, 0, batch, lane, ry15);
  int32_t xo[NL], yo[NL];
  verdict[lane] = tail::encode_verdict_limbs_lane(x15, y15, z15, ry15, __ldg(r_sign + lane),
                                                  precheck[lane], xo, yo);
  store_affine(affine, batch, lane, xo, yo);
}

// Test entry for the header's arithmetic on the card: a and b are (17, n)
// limb-major 17 x 15 elements, out gets canonical 17 x 15 limbs of
//   op 0: a * b   op 1: a^2   op 2: a^-1   op 3: a (canonical reduction)
//   op 4: a^(2^252 - 3)   op 5: -a
__global__ void field_op_kernel(int op, const int32_t* __restrict__ a,
                                const int32_t* __restrict__ b, int32_t* __restrict__ out,
                                int n) {
  using namespace fe25519;
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  int32_t la[NL], lb[NL], lo[NL];
  load15(a, 0, n, lane, la);
  load15(b, 0, n, lane, lb);
  const fe x = from15(la);
  fe r;
  switch (op) {
    case 0: r = fe_mul(x, from15(lb)); break;
    case 1: r = fe_sq(x); break;
    case 2: r = fe_invert(x); break;
    case 4: r = fe_pow22523(x); break;
    case 5: r = fe_reduce(fe_neg(x)); break;  // fe_canonical takes a carried element
    default: r = x; break;
  }
  to15(fe_canonical(r), lo);
#pragma unroll
  for (int i = 0; i < NL; ++i) out[(long long)i * n + lane] = lo[i];
}

}  // namespace

// Launches on `stream`; affine may be null. Returns cudaGetLastError().
extern "C" int encode_verdict_launch(const int32_t* acc, const uint8_t* wire,
                                     const bool* precheck, bool* verdict,
                                     int32_t* affine, int batch, void* stream) {
  if (batch <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((batch + THREADS - 1) / THREADS);
  encode_verdict_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      acc, wire, precheck, verdict, affine, batch);
  return (int)cudaGetLastError();
}

// The comb path's launch: R.y limbs and sign in place of the wire bytes.
extern "C" int encode_verdict_limbs_launch(const int32_t* acc, const int32_t* r_y,
                                           const int32_t* r_sign, const bool* precheck,
                                           bool* verdict, int32_t* affine, int batch,
                                           void* stream) {
  if (batch <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((batch + THREADS - 1) / THREADS);
  encode_verdict_limbs_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      acc, r_y, r_sign, precheck, verdict, affine, batch);
  return (int)cudaGetLastError();
}

extern "C" int field_op_launch(int op, const int32_t* a, const int32_t* b, int32_t* out,
                               int n, void* stream) {
  if (n <= 0 || op < 0 || op > 5) return (int)cudaErrorInvalidValue;
  field_op_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0, (cudaStream_t)stream>>>(
      op, a, b, out, n);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
