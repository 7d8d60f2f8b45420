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
// Per lane, a group of G = 5 threads (csrc/field25519_coop.cuh: thread j
// holds limbs 2j and 2j + 1 of every field element): Z^-1 by ref10's
// Fermat chain (254 squarings, 11 multiplies), the two multiplies by Z^-1,
// each multiply's operands gathered by warp shuffles, its columns split
// over the group and its carries run on all limbs at once; then every
// thread holds x and y whole and reduces them to canonical form, and the
// group's thread 0 compares and stores. The JAX package batches the
// inversion (Montgomery's trick, about 3 multiplies a lane plus one chain
// per 128 lanes); a per-lane chain needs no power-of-two batch and no
// exchange between lanes, and at the committee's usual passes of 8 to 512
// lanes the card is nearly empty, so one chain's latency sets the time
// whichever way the inversion is organised. The group shortens that
// chain: a multiply is a thread's 20 products (in place of 100, or 55 for
// a square) and two parallel carry rounds (in place of ref10's serial
// chain of 12 steps), at the cost of 21 shuffles a thread.
//
// What bounds it on an H100: the work of the JAX function is about 7 field
// multiplies a lane (700 wide products) and 306 bytes a lane; at B = 8192
// that is 0.35 us of multiplies at 64 issues per SM per clock against
// 0.75 us of bytes at 3.35 TB/s, so bytes. This design spends 267
// multiplies of 100 products a lane (the squares too: the columns are
// split over the group, which leaves a square's symmetry unused), and
// its time is one group's chain of 267 dependent multiplies and the
// warp shuffles between them: latency and shuffle issue, not either
// bound, set it.
//
// Block: 128 threads, 4 warps of 6 groups each (lanes 30 and 31 of a warp
// idle), 24 lanes a block. No group straddles a warp, and no thread
// returns before the group's last shuffle: a lane past the batch runs the
// chain on Z = 1 and stores nothing.

#include "field25519_coop.cuh"

namespace tail {

using fe25519::fe;

constexpr int NL = 17;
constexpr int WIRE = 96;

// A read-only load, through the non-coherent cache on the card.
template <class T>
FE_FN T ldg(const T* p) {
#ifdef __CUDA_ARCH__
  return __ldg(p);
#else
  return *p;
#endif
}

// Row q of a (rows, batch) limb-major tensor as 17 x 15 limbs; outside the
// batch (`valid` false) the element 1, a harmless input to every op.
FE_FN void load15(const int32_t* t, int q, int batch, int lane, bool valid, int32_t l[NL]) {
#pragma unroll
  for (int i = 0; i < NL; ++i)
    l[i] = valid ? ldg(t + (long long)(q * NL + i) * batch + lane) : (i == 0);
}

// A lane's inputs where the kernels keep them: `acc` (4*17, batch)
// limb-major, and R either as wire bytes (`wire`, (batch, 96): R.y is
// bytes 64..95 without bit 255, its sign bit 255) or, when `wire` is null,
// as the comb path's (17, batch) limbs `r_y` and (batch,) signs `r_sign`.
// Outside the batch (`valid` false) every coordinate is the element 1 and
// R is 0.
struct lane_src {
  const int32_t* acc;
  const uint8_t* wire;
  const int32_t* r_y;
  const int32_t* r_sign;
  int batch, lane;
  bool valid;

  // The accumulator's coordinate q: 0 X, 1 Y, 2 Z.
  FE_FN void coord(int q, int32_t l[NL]) const { load15(acc, q, batch, lane, valid, l); }

  // R.y (carried) and R's sign.
  FE_FN fe r(int& sign) const {
    using namespace fe25519;
    if (wire == nullptr) {
      int32_t l[NL];
      load15(r_y, 0, batch, lane, valid, l);
      sign = valid ? ldg(r_sign + lane) : 0;
      return from15(l);
    }
    uint8_t b[32] = {};
    if (valid) {
      const uint8_t* src = wire + (long long)lane * WIRE + 64;
#ifdef __CUDA_ARCH__
      // two 16-byte loads
      const uint4 lo = ldg(reinterpret_cast<const uint4*>(src));
      const uint4 hi = ldg(reinterpret_cast<const uint4*>(src) + 1);
      const uint32_t words[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
      for (int i = 0; i < 32; ++i) b[i] = (uint8_t)(words[i / 4] >> (8 * (i % 4)));
#else
      for (int i = 0; i < 32; ++i) b[i] = src[i];
#endif
    }
    sign = b[31] >> 7;
    return from_bytes(b);
  }
};

// One lane, run by every thread of its group `grp`. Every thread ends with
// the canonical affine x, y as 17 x 15 limbs and the verdict; the caller
// stores one thread's. Z is loaded before the chain and X, Y and R only
// after it, one at a time, so that across the chain a thread holds its
// pair of Z's limbs and nothing else of the lane.
template <class Grp>
FE_FN bool verdict_lane(Grp& grp, const lane_src& src, bool precheck, int32_t x_out[NL],
                        int32_t y_out[NL]) {
  using namespace fe25519;
  int32_t l[NL];
  src.coord(2, l);
  const auto zinv = coop::coop_invert(grp, grp.pick(from15(l)));
  src.coord(0, l);
  const fe x = fe_canonical(fe_reduce(grp.full(grp.mul(grp.pick(from15(l)), zinv))));
  src.coord(1, l);
  const fe y = fe_canonical(fe_reduce(grp.full(grp.mul(grp.pick(from15(l)), zinv))));
  to15(x, x_out);
  to15(y, y_out);
  int r_sign;
  const fe ry = src.r(r_sign);
  return precheck && fe_equal_canonical(y, fe_canonical(ry)) &&
         fe_parity_canonical(x) == r_sign;
}

// The test entry's cooperative ops, for either group: op 6 a * b, 7 a^2,
// 8 a^-1, 9 a^(2^252 - 3), gathered whole into every thread and carried.
template <class Grp>
FE_FN fe coop_field_op(Grp& grp, int op, const fe& a, const fe& b) {
  const auto x = grp.pick(a);
  const auto r = op == 6   ? grp.mul(x, grp.pick(b))
                 : op == 7 ? grp.sq(x)
                 : op == 8 ? coop::coop_invert(grp, x)
                           : coop::coop_pow22523(grp, x);
  return fe25519::fe_reduce(grp.full(r));
}

}  // namespace tail

#ifdef __CUDACC__

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int LANES = THREADS / 32 * coop::GROUPS_PER_WARP;  // 24 lanes a block
constexpr int NL = tail::NL;
using tail::load15;

// The lane of this thread's group, and whether it is one of the batch's.
__device__ __forceinline__ int lane_of(const coop::warp_group& grp) {
  return (blockIdx.x * (THREADS / 32) + threadIdx.x / 32) * coop::GROUPS_PER_WARP + grp.group();
}

__device__ __forceinline__ bool in_batch(const coop::warp_group& grp, int lane, int batch) {
  return grp.group() < coop::GROUPS_PER_WARP && lane < batch;
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
  coop::warp_group grp = coop::warp_group::of_thread();
  const int lane = lane_of(grp);
  const bool valid = in_batch(grp, lane, batch);
  const tail::lane_src src{acc, wire, nullptr, nullptr, batch, lane, valid};
  int32_t xo[NL], yo[NL];
  const bool ok = tail::verdict_lane(grp, src, valid && precheck[lane], xo, yo);
  if (!valid || grp.j != 0) return;
  verdict[lane] = ok;
  store_affine(affine, batch, lane, xo, yo);
}

// The comb path's entry: R.y as (17, B) limbs and R's sign as (B,) int32.
__global__ void __launch_bounds__(THREADS)
encode_verdict_limbs_kernel(const int32_t* __restrict__ acc, const int32_t* __restrict__ r_y,
                            const int32_t* __restrict__ r_sign,
                            const bool* __restrict__ precheck, bool* __restrict__ verdict,
                            int32_t* __restrict__ affine, int batch) {
  coop::warp_group grp = coop::warp_group::of_thread();
  const int lane = lane_of(grp);
  const bool valid = in_batch(grp, lane, batch);
  const tail::lane_src src{acc, nullptr, r_y, r_sign, batch, lane, valid};
  int32_t xo[NL], yo[NL];
  const bool ok = tail::verdict_lane(grp, src, valid && precheck[lane], xo, yo);
  if (!valid || grp.j != 0) return;
  verdict[lane] = ok;
  store_affine(affine, batch, lane, xo, yo);
}

// Test entry for the header's arithmetic on the card: a and b are (17, n)
// limb-major 17 x 15 elements, out gets canonical 17 x 15 limbs of
//   op 0: a * b   op 1: a^2   op 2: a^-1   op 3: a (canonical reduction)
//   op 4: a^(2^252 - 3)   op 5: -a
// one thread an element (field25519.cuh, which K1 and K9 run).
__global__ void field_op_kernel(int op, const int32_t* __restrict__ a,
                                const int32_t* __restrict__ b, int32_t* __restrict__ out,
                                int n) {
  using namespace fe25519;
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  int32_t la[NL], lb[NL], lo[NL];
  load15(a, 0, n, lane, true, la);
  load15(b, 0, n, lane, true, lb);
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

// The cooperative ops (field25519_coop.cuh, which the verdict and ladder
// kernels run), G threads an element as in the verdict kernel:
//   op 6: a * b   op 7: a^2   op 8: a^-1   op 9: a^(2^252 - 3)
__global__ void __launch_bounds__(THREADS)
field_op_coop_kernel(int op, const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                     int32_t* __restrict__ out, int n) {
  using namespace fe25519;
  coop::warp_group grp = coop::warp_group::of_thread();
  const int lane = lane_of(grp);
  const bool valid = in_batch(grp, lane, n);
  int32_t la[NL], lb[NL], lo[NL];
  load15(a, 0, n, lane, valid, la);
  load15(b, 0, n, lane, valid, lb);
  const fe r = tail::coop_field_op(grp, op, from15(la), from15(lb));
  if (!valid || grp.j != 0) return;
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
  const dim3 grid((batch + LANES - 1) / LANES);
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
  const dim3 grid((batch + LANES - 1) / LANES);
  encode_verdict_limbs_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      acc, r_y, r_sign, precheck, verdict, affine, batch);
  return (int)cudaGetLastError();
}

// Ops 0-5 one thread an element, 6-9 a group of G threads.
extern "C" int field_op_launch(int op, const int32_t* a, const int32_t* b, int32_t* out,
                               int n, void* stream) {
  if (n <= 0 || op < 0 || op > 9) return (int)cudaErrorInvalidValue;
  if (op >= 6)
    field_op_coop_kernel<<<(n + LANES - 1) / LANES, THREADS, 0, (cudaStream_t)stream>>>(
        op, a, b, out, n);
  else
    field_op_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0, (cudaStream_t)stream>>>(
        op, a, b, out, n);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
