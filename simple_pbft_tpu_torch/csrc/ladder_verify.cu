// Keyless Ed25519 batch verification: per lane, decompress A and R on the
// card and check [S]B + [k](-A) == R with a 256-step Straus ladder.
//
// Replaces: the XLA program simple_pbft_tpu/crypto/tpu_verifier.py:197
// verify_kernel (the JAX package's ladder mode), with what it calls:
// ops/edwards.py:150 decompress (field25519.py:325 pow22523), :93
// point_neg, :112 double_scalar_mul_base (:80 point_double, :60 point_add,
// :99 point_select) and the projective comparison. It is not a Pallas
// kernel there; here it is the one launch of a ladder-mode device pass.
//
// Contract (plain PyTorch version: crypto/gpu_verifier.py
// verify_kernel_plain; the arrays are the JAX package's prepare_batch
// staging, unchanged):
//   a_y, r_y        (17, B) int32  A.y and R.y as 17 x 15 limbs
//   a_sign, r_sign  (B,) int32     x's sign bit of A and of R
//   s_bits, k_bits  (256, B) int32 S's and k's bits, most significant first
//   precheck        (B,) bool      the host's validity mask
//   verdict         (B,) bool      X == x_R Z and Y == y_R Z for the ladder's
//                                  (X, Y, Z), A and R valid, and precheck
//   affine          (2*17, B) int32 optional: the ladder's canonical affine
//                                  x and y in 17 x 15 limbs
//
// Per lane, one thread: RFC 8032 §5.1.3 decompression of A (x from one
// pow22523 chain, ok False for a non-residue and for x = 0 with sign 1,
// the sign matched by negation), Q = -A and B + Q, then 256 steps of one
// doubling and one unified addition of {identity, B, Q, B+Q}[s_i + 2 k_i];
// R decompressed after the ladder (fewer live registers across it), the
// projective comparison, the AND with both ok flags and the precheck.
// Cofactorless, as the JAX package and the CPU oracle verify. The
// formulas are edwards25519.cuh's, the plain version's, so the two agree
// after canonical reduction also on lanes whose A is no curve point.
//
// What bounds it on an H100: per lane, the ladder's 256 steps at their
// least, a doubling (4 squares and 4 multiplies) and an addition of a
// cached addend (7 multiplies), 1,320 wide products a step, and two
// decompressions of about 16,000 (almost all the pow22523 chain): about
// 371,000 products. At B = 8192 that is 0.18 ms at 64 products an SM a
// clock on 132 SMs at 1.98 GHz, against 18 MB (the bit arrays are 2 KB a
// lane) in 0.005 ms at 3.35 TB/s: operations. The unified formulas below
// spend 1,520 products a step (4 squares, 13 multiplies). What the
// design does about it: the radix-2^25.5 field (100 products a multiply,
// 55 a square), every point in registers, the base point in constant
// memory; 32-thread blocks, so that B = 8192 puts 256 blocks on the 132
// SMs. One thread a lane leaves each lane's chain of about 4,900 dependent
// field operations as the time; splitting a lane over threads is later
// work.

#include "edwards25519.cuh"

// Called once or twice a lane: kept out of line on the card, which halves
// the code nvcc compiles (two pow22523 chains and an inversion otherwise).
#ifdef __CUDACC__
#define LADDER_OUTLINE __host__ __device__ __noinline__
#else
#define LADDER_OUTLINE inline
#endif

namespace ladder {

using ed25519::point;
using fe25519::fe;

constexpr int NL = 17;
constexpr int NBITS = 256;

// d and sqrt(-1) mod p in radix 2^25.5 (ref10's d and sqrtm1).
FE_FN fe d() {
  return {{-10913610, 13857413, -15372611, 6949391, 114729, -8787816, -6275908,
           -3247719, -18696448, -12055116}};
}

FE_FN fe sqrt_m1() {
  return {{-32595792, -7943725, 9377950, 3500415, 12389472, -272473, -25146209,
           -2005654, 326686, 11406482}};
}

// The base point B = (x, y, 1, xy), carried radix-2^25.5 limbs: in constant
// memory on the card, where every lane of a warp reads the same word.
#define LADDER_BASE_LIMBS                                                          \
  {{-14297830, -7645148, 16144683, -16471763, 27570974, -2696100, -26142465,     \
    8378389, 20764389, 8758491},                                                  \
   {-26843541, -6710886, 13421773, -13421773, 26843546, 6710886, -13421773,      \
    13421773, -26843546, -6710886},                                               \
   {1, 0, 0, 0, 0, 0, 0, 0, 0, 0},                                                \
   {28827062, -6116119, -27349572, 244363, 8635006, 11264893, 19351346, 13413597, \
    16611511, -6414980}}

#ifdef __CUDACC__
__constant__ int32_t c_base[4][10] = LADDER_BASE_LIMBS;
#endif
#ifndef __CUDA_ARCH__
static const int32_t h_base[4][10] = LADDER_BASE_LIMBS;
#endif

FE_FN int32_t base_limb(int c, int k) {
#ifdef __CUDA_ARCH__
  return c_base[c][k];
#else
  return h_base[c][k];
#endif
}

FE_FN point base() {
  point b;
#pragma unroll
  for (int k = 0; k < 10; ++k) {
    b.x.v[k] = base_limb(0, k);
    b.y.v[k] = base_limb(1, k);
    b.z.v[k] = base_limb(2, k);
    b.t.v[k] = base_limb(3, k);
  }
  return b;
}

// A read-only load: through the read-only data cache on the card.
template <typename T>
FE_FN T ld(const T* p) {
#ifdef __CUDA_ARCH__
  return __ldg(p);
#else
  return *p;
#endif
}

// 17 limbs `stride` apart (one lane's column of a (17, B) array).
FE_FN fe load15(const int32_t* p, long long stride) {
  int32_t l[NL];
#pragma unroll
  for (int i = 0; i < NL; ++i) l[i] = ld(p + i * stride);
  return fe25519::from15(l);
}

// Both canonical after a carry: equality in the field.
FE_FN bool equal(const fe& a, const fe& b) {
  using namespace fe25519;
  return fe_equal_canonical(fe_canonical(fe_reduce(a)), fe_canonical(fe_reduce(b)));
}

// RFC 8032 §5.1.3, as ops/edwards.py decompress: (x, y, 1, xy) from y and
// x's sign, x = u v^3 (u v^7)^((p-5)/8) with u = y^2 - 1, v = d y^2 + 1,
// times sqrt(-1) when v x^2 = -u. `ok` is False when neither v x^2 = u nor
// v x^2 = -u (x^2 a non-residue), and when x = 0 with sign 1.
LADDER_OUTLINE point decompress(const fe& y, int sign, bool& ok) {
  using namespace fe25519;
  const fe one = fe_one();
  const fe yy = fe_sq(y);
  const fe u = fe_sub(yy, one);
  const fe v = fe_add(fe_mul(yy, d()), one);
  const fe v3 = fe_mul(fe_sq(v), v);
  const fe v7 = fe_mul(fe_sq(v3), v);
  fe x = fe_mul(fe_mul(u, v3), fe_pow22523(fe_mul(u, v7)));
  const fe vxx = fe_mul(v, fe_sq(x));
  const bool ok_direct = equal(vxx, u);
  const bool ok_twist = equal(vxx, fe_neg(u));
  if (ok_twist) x = fe_mul(x, sqrt_m1());
  x = fe_canonical(x);
  ok = (ok_direct || ok_twist) && !(fe_equal_canonical(x, fe_zero()) && sign == 1);
  if ((x.v[0] & 1) != sign) x = fe_neg(x);
  x = fe_reduce(x);
  return {x, y, one, fe_mul(x, y)};
}

// {identity, B, Q, B+Q}[idx] limb by limb, as ops/edwards.py point_select:
// an idx outside 1..3 gives the identity.
FE_FN fe pick(int idx, const fe& ident, int c, const fe& q, const fe& bq) {
  fe r;
#pragma unroll
  for (int k = 0; k < 10; ++k)
    r.v[k] = idx == 1 ? base_limb(c, k) : idx == 2 ? q.v[k] : idx == 3 ? bq.v[k] : ident.v[k];
  return r;
}

FE_FN point addend(int idx, const point& q, const point& bq) {
  const fe zero = fe25519::fe_zero(), one = fe25519::fe_one();
  return {pick(idx, zero, 0, q.x, bq.x), pick(idx, one, 1, q.y, bq.y),
          pick(idx, one, 2, q.z, bq.z), pick(idx, zero, 3, q.t, bq.t)};
}

// The canonical affine x and y of `p` as 17 x 15 limbs into rows 0..33 of
// `xy`, `stride` apart.
LADDER_OUTLINE void store_affine(const point& p, int32_t* xy, long long stride) {
  using namespace fe25519;
  const fe zinv = fe_invert(p.z);
  int32_t xo[NL], yo[NL];
  to15(fe_canonical(fe_mul(p.x, zinv)), xo);
  to15(fe_canonical(fe_mul(p.y, zinv)), yo);
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    xy[i * stride] = xo[i];
    xy[(NL + i) * stride] = yo[i];
  }
}

// One lane. Every pointer is at this lane's first element, the next one
// `stride` (the batch) further: a_y, r_y 17 limbs; s_bits, k_bits 256 bits.
// `xy` (or null): the canonical affine x and y of [S]B + [k](-A), 34 rows.
FE_FN bool verify_lane(const int32_t* a_y, int a_sign, const int32_t* r_y, int r_sign,
                       const int32_t* s_bits, const int32_t* k_bits, long long stride,
                       bool precheck, int32_t* xy) {
  using namespace fe25519;
  bool ok_a, ok_r;
  const point q = ed25519::point_neg(decompress(load15(a_y, stride), a_sign, ok_a));
  const point bq = ed25519::point_add(base(), q);
  point acc = ed25519::identity();
#pragma unroll 1
  for (int i = 0; i < NBITS; ++i) {
    acc = ed25519::point_double(acc);
    const int idx = ld(s_bits + i * stride) + 2 * ld(k_bits + i * stride);
    acc = ed25519::point_add(acc, addend(idx, q, bq));
  }
  // R has Z = 1: X == x_R Z and Y == y_R Z
  const point r = decompress(load15(r_y, stride), r_sign, ok_r);
  const bool eq = equal(acc.x, fe_mul(r.x, acc.z)) && equal(acc.y, fe_mul(r.y, acc.z));
  if (xy != nullptr) store_affine(acc, xy, stride);
  return eq && ok_a && ok_r && precheck;
}

}  // namespace ladder

#ifdef __CUDACC__

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 32;

__global__ void __launch_bounds__(THREADS)
ladder_verify_kernel(const int32_t* __restrict__ a_y, const int32_t* __restrict__ a_sign,
                     const int32_t* __restrict__ r_y, const int32_t* __restrict__ r_sign,
                     const int32_t* __restrict__ s_bits, const int32_t* __restrict__ k_bits,
                     const bool* __restrict__ precheck, bool* __restrict__ verdict,
                     int32_t* __restrict__ affine, int batch) {
  const int lane = blockIdx.x * THREADS + threadIdx.x;
  if (lane >= batch) return;
  verdict[lane] = ladder::verify_lane(
      a_y + lane, __ldg(a_sign + lane), r_y + lane, __ldg(r_sign + lane), s_bits + lane,
      k_bits + lane, batch, precheck[lane], affine == nullptr ? nullptr : affine + lane);
}

}  // namespace

// Launches on `stream`; affine may be null. Returns cudaGetLastError().
extern "C" int ladder_verify_launch(const int32_t* a_y, const int32_t* a_sign,
                                    const int32_t* r_y, const int32_t* r_sign,
                                    const int32_t* s_bits, const int32_t* k_bits,
                                    const bool* precheck, bool* verdict, int32_t* affine,
                                    int batch, void* stream) {
  if (batch <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((batch + THREADS - 1) / THREADS);
  ladder_verify_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      a_y, a_sign, r_y, r_sign, s_bits, k_bits, precheck, verdict, affine, batch);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
