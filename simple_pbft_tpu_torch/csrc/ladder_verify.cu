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
// Contract (plain PyTorch version: ops/ladder.py verify_kernel_plain; the
// arrays are the JAX package's prepare_batch staging, unchanged):
//   a_y, r_y        (17, B) int32  A.y and R.y as 17 x 15 limbs
//   a_sign, r_sign  (B,) int32     x's sign bit of A and of R
//   s_bits, k_bits  (256, B) int32 S's and k's bits, most significant first
//   precheck        (B,) bool      the host's validity mask
//   verdict         (B,) bool      X == x_R Z and Y == y_R Z for the ladder's
//                                  (X, Y, Z), A and R valid, and precheck
//   affine          (2*17, B) int32 optional: the ladder's canonical affine
//                                  x and y in 17 x 15 limbs
//
// Per lane, a group of G = 5 threads (csrc/field25519_coop.cuh: thread j
// holds limbs 2j and 2j + 1 of every field element, so a point is four
// shares, 8 registers): RFC 8032 §5.1.3 decompression of A (x from one
// pow22523 chain; ok False for a non-residue and for x = 0 with sign 1,
// decided by all five threads on gathered canonical values; the multiply
// by sqrt(-1) and the sign's negation are selects), the table {identity,
// B, Q = -A, B + Q}, then 256 steps of one doubling and one addition of
// the entry s_i + 2 k_i; R decompressed after the ladder, the projective
// comparison, the AND with both ok flags and the precheck. Cofactorless,
// as the JAX package and the CPU oracle verify.
//
// The formulas are the plain version's, dbl-2008-hwcd and add-2008-hwcd-3
// with 2d, regrouped in two ways that leave every X, Y and Z equal mod p
// (also on lanes whose A is no curve point): each table entry is cached
// once a lane as (Y - X, Y + X, Z, 2d T), so the addition's C is
// T1 (2d T2); and the addition does not compute T3, which nothing reads
// (the next doubling, the comparison and the affine output read X, Y and
// Z). A step is then 4 squares and 11 multiplies in four rounds of
// independent products: the doubling's 4 squares, then its 4 multiplies;
// the addition's 4, then its 3. Each round's products are issued
// together (`mul_n`): their gathers, columns and carry rounds
// interleaved, so a multiply's serial shuffle latencies are paid once a
// round.
//
// What bounds it on an H100: per lane, the least work a verify needs is
// the ladder's 256 steps of 4 squares and 11 multiplies (1,320 wide
// products a step) and two decompressions of about 16,000 (almost all the
// pow22523 chain): about 371,000 products. At B = 8192 that is 0.182 ms at
// 64 products an SM a clock on 132 SMs at 1.98 GHz, against 18 MB (the
// bit arrays are 2 KB a lane) in 0.005 ms at 3.35 TB/s: operations. The
// group spends more: a square's columns are split over the group like a
// multiply's, so it costs 100 products, not 55 (4,402 multiplies of 100
// products a lane in all). The warp shuffles were the expected limit at
// B = 8192: about 21 a thread a multiply, 15 multiplies a step, 6 lanes a
// warp, about 126 M warp shuffles, about 0.48 ms at one a clock per SM.
// Measured on an H100 (chip_smoke.py): 1.21 ms at B = 8192 and 0.65 ms
// at B <= 512. Variant builds measured beside it: one product after the
// other costs 1-6% more, and a variant that gathered the last rounds' shared
// operands once (17% fewer shuffles) gained about 2%. So neither
// shuffle latency nor shuffle count sets the time. The likelier limit is each
// thread's instruction stream: 20 wide products, 21 shuffles and about
// 40 other instructions a multiply. At small B, one lane's 1,024 rounds
// take about 1,000 clocks each, and its two pow22523 chains add to that.
//
// Block: 128 threads, 4 warps of 6 groups each (lanes 30 and 31 of a warp
// idle), 24 lanes a block. No group straddles a warp, and no thread
// returns before the group's last shuffle: a lane past the batch, and
// lanes 30-31, run the whole chain on fixed valid inputs (y = 1, zero
// bits) and skip their stores.

#include "edwards25519.cuh"
#include "field25519_coop.cuh"

namespace ladder {

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
// memory on the card, where every thread reads the same word (a thread
// takes its pair by selects, `coop::pick`, never by indexing with j).
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

// Coordinate c (0 x, 1 y, 3 t) of B.
FE_FN fe base(int c) {
  fe r;
#pragma unroll
  for (int k = 0; k < 10; ++k) {
#ifdef __CUDA_ARCH__
    r.v[k] = c_base[c][k];
#else
    r.v[k] = h_base[c][k];
#endif
  }
  return r;
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

// Both carried (fe_reduce of a gathered share): equality in the field.
FE_FN bool equal(const fe& a, const fe& b) {
  using namespace fe25519;
  return fe_equal_canonical(fe_canonical(a), fe_canonical(b));
}

// A point's shares: (X, Y, Z), and T where the addition reads it.
template <class E>
struct xyzt {
  E x, y, z, t;
};

// A table entry as the addition reads it: (Y - X, Y + X, Z, 2d T).
template <class E>
struct cached {
  E ym, yp, z, t2d;
};

template <class Grp, class E = typename Grp::elem>
FE_FN cached<E> to_cached(Grp& grp, const xyzt<E>& p, const E& t2d) {
  return {grp.sub(p.y, p.x), grp.add(p.y, p.x), p.z, t2d};
}

// Doubling dbl-2008-hwcd of (X, Y, Z), as ops/edwards.py point_double, in
// two rounds: the 4 squares, then the 4 multiplies. 2 Z^2 is carried
// (`reduce`) before it enters F = 2 Z^2 + (X^2 - Y^2): F stays a sum of
// three bounded terms.
template <class Grp, class E = typename Grp::elem>
FE_FN xyzt<E> point_double(Grp& grp, const E& x, const E& y, const E& z) {
  const E in[4] = {x, y, z, grp.add(x, y)};
  E s[4];
  grp.template mul_n<4>(in, in, s);
  const E c = grp.reduce(grp.add(s[2], s[2]));
  const E h = grp.add(s[0], s[1]);
  const E e = grp.sub(h, s[3]);
  const E g = grp.sub(s[0], s[1]);
  const E f = grp.add(c, g);
  const E l[4] = {e, g, f, e}, r[4] = {f, h, g, h};
  E o[4];
  grp.template mul_n<4>(l, r, o);
  return {o[0], o[1], o[2], o[3]};
}

// Addition add-2008-hwcd-3 of a cached entry, as ops/edwards.py point_add
// with C = T1 (2d T2), in two rounds: A, B, C and Z1 Z2, then X3, Y3, Z3
// and, WITH_T, T3. The ladder's steps leave T3 out: the result's `t`
// then repeats Y3 and is not read.
template <bool WITH_T, class Grp, class E = typename Grp::elem>
FE_FN xyzt<E> point_add(Grp& grp, const xyzt<E>& p, const cached<E>& q) {
  const E l[4] = {grp.sub(p.y, p.x), grp.add(p.y, p.x), p.t, p.z};
  const E r[4] = {q.ym, q.yp, q.t2d, q.z};
  E m[4];
  grp.template mul_n<4>(l, r, m);
  const E dd = grp.add(m[3], m[3]);
  const E e = grp.sub(m[1], m[0]);
  const E f = grp.sub(dd, m[2]);
  const E g = grp.add(dd, m[2]);
  const E h = grp.add(m[1], m[0]);
  const E l2[4] = {e, g, f, e}, r2[4] = {f, h, g, h};
  E o[4];
  grp.template mul_n<WITH_T ? 4 : 3>(l2, r2, o);
  return {o[0], o[1], o[2], o[WITH_T ? 3 : 1]};
}

// RFC 8032 §5.1.3, as ops/edwards.py decompress: x's shares (carried)
// from y's and x's sign, x = u v^3 (u v^7)^((p-5)/8) with u = y^2 - 1,
// v = d y^2 + 1, times sqrt(-1) when v x^2 = -u. `ok` is False when
// neither v x^2 = u nor v x^2 = -u, and when x = 0 with sign 1. Every
// thread decides from gathered canonical values, so the group agrees; the
// multiply by sqrt(-1) runs on every lane and is selected.
template <class Grp, class E = typename Grp::elem>
FE_FN E decompress_x(Grp& grp, const E& y, int sign, bool& ok) {
  using namespace fe25519;
  const E one = grp.pick(fe_one());
  const E yy = grp.sq(y);
  const E u = grp.sub(yy, one);
  const E v = grp.add(grp.mul(yy, grp.pick(d())), one);
  const E v3 = grp.mul(grp.sq(v), v);
  const E v7 = grp.mul(grp.sq(v3), v);
  const E ul[2] = {u, u}, vr[2] = {v3, v7};
  E uv[2];
  grp.template mul_n<2>(ul, vr, uv);
  E x = grp.mul(uv[0], coop::coop_pow22523(grp, uv[1]));
  const fe vxx = fe_reduce(grp.full(grp.mul(v, grp.sq(x))));
  const fe uf = fe_reduce(grp.full(u));
  const bool ok_direct = equal(vxx, uf);
  const bool ok_twist = equal(vxx, fe_reduce(fe_neg(uf)));
  x = grp.select(ok_twist, grp.mul(x, grp.pick(sqrt_m1())), x);
  const fe xc = fe_canonical(fe_reduce(grp.full(x)));
  ok = (ok_direct || ok_twist) && !(fe_equal_canonical(xc, fe_zero()) && sign == 1);
  const fe xn = fe_neg(xc);
  fe xs;
#pragma unroll
  for (int k = 0; k < 10; ++k) xs.v[k] = fe_parity_canonical(xc) != sign ? xn.v[k] : xc.v[k];
  return grp.pick(fe_reduce(xs));
}

// One lane's inputs. Pointers are at the lane's first element, the next
// one `stride` (the batch) further: a_y, r_y 17 limbs; s_bits, k_bits 256
// bits. Outside the batch (`valid` false) nothing is read: y = 1 and the
// bits are 0, which run the whole chain on a valid point.
struct lane_src {
  const int32_t* a_y;
  const int32_t* r_y;
  const int32_t* s_bits;
  const int32_t* k_bits;
  int a_sign, r_sign;
  long long stride;
  bool valid;

  FE_FN fe y(const int32_t* p) const {
    int32_t l[NL];
#pragma unroll
    for (int i = 0; i < NL; ++i) l[i] = valid ? ld(p + i * stride) : (i == 0);
    return fe25519::from15(l);
  }

  // The table index of step i, s_i + 2 k_i.
  FE_FN int step(int i) const {
    return valid ? ld(s_bits + i * stride) + 2 * ld(k_bits + i * stride) : 0;
  }
};

// The table's entries {B, Q, B + Q} in cached form, from Q's shares.
template <class Grp, class E = typename Grp::elem>
FE_FN void table(Grp& grp, const xyzt<E>& q, cached<E> t[3]) {
  const E one = grp.pick(fe25519::fe_one());
  const E d2 = grp.pick(ed25519::d2());
  const xyzt<E> b = {grp.pick(base(0)), grp.pick(base(1)), one, grp.pick(base(3))};
  const E tl[2] = {b.t, q.t}, dr[2] = {d2, d2};
  E t2d[2];
  grp.template mul_n<2>(tl, dr, t2d);
  t[0] = to_cached(grp, b, t2d[0]);
  t[1] = to_cached(grp, q, t2d[1]);
  const xyzt<E> bq = point_add<true>(grp, b, t[1]);
  t[2] = to_cached(grp, bq, grp.mul(bq.t, d2));
}

// {identity, B, Q, B+Q}[idx], as ops/edwards.py point_select: an idx
// outside 1..3 gives the identity, whose cached form is (1, 1, 1, 0).
template <class Grp, class E = typename Grp::elem>
FE_FN cached<E> entry(Grp& grp, int idx, const cached<E> t[3]) {
  const E one = grp.pick(fe25519::fe_one());
  const E zero = grp.pick(fe25519::fe_zero());
  const cached<E> id = {one, one, one, zero};
  const cached<E>& a = t[0];
  const cached<E>& b = t[1];
  const cached<E>& c = t[2];
  const bool s1 = idx == 1, s2 = idx == 2, s3 = idx == 3;
  return {grp.select(s1, a.ym, grp.select(s2, b.ym, grp.select(s3, c.ym, id.ym))),
          grp.select(s1, a.yp, grp.select(s2, b.yp, grp.select(s3, c.yp, id.yp))),
          grp.select(s1, a.z, grp.select(s2, b.z, grp.select(s3, c.z, id.z))),
          grp.select(s1, a.t2d, grp.select(s2, b.t2d, grp.select(s3, c.t2d, id.t2d)))};
}

// 256 steps from `acc`: double, then add the entry of step i. The next
// step's index is loaded a step ahead, behind the doubling.
template <class Grp, class E = typename Grp::elem>
FE_FN void steps(Grp& grp, E acc[3], const cached<E> t[3], const lane_src& src) {
  int idx = src.step(0);
#pragma unroll 1
  for (int i = 0; i < NBITS; ++i) {
    const int next = i + 1 < NBITS ? src.step(i + 1) : 0;
    const xyzt<E> sum = point_add<false>(grp, point_double(grp, acc[0], acc[1], acc[2]),
                                         entry(grp, idx, t));
    acc[0] = sum.x, acc[1] = sum.y, acc[2] = sum.z;
    idx = next;
  }
}

// One lane, run by every thread of its group. Returns the verdict; with
// `affine`, x_out and y_out get the canonical affine x and y of the
// ladder's [S]B + [k](-A) as 17 x 15 limbs. The caller stores one
// thread's.
template <class Grp>
FE_FN bool verify_lane(Grp& grp, const lane_src& src, bool precheck, bool affine,
                       int32_t x_out[NL], int32_t y_out[NL]) {
  using namespace fe25519;
  using E = typename Grp::elem;
  bool ok_a, ok_r;
  cached<E> t[3];
  {
    const E ya = grp.pick(src.y(src.a_y));
    const E xa = decompress_x(grp, ya, src.a_sign, ok_a);
    // Q = -A = (-x, y, 1, -xy)
    const xyzt<E> q = {grp.neg(xa), ya, grp.pick(fe_one()), grp.neg(grp.mul(xa, ya))};
    table(grp, q, t);
  }
  E acc[3] = {grp.pick(fe_zero()), grp.pick(fe_one()), grp.pick(fe_one())};
  steps(grp, acc, t, src);
  // R has Z = 1: X == x_R Z and Y == y_R Z; every gather runs on every lane
  const E yr = grp.pick(src.y(src.r_y));
  const E xr = decompress_x(grp, yr, src.r_sign, ok_r);
  const E rl[2] = {xr, yr}, zr[2] = {acc[2], acc[2]};
  E rz[2];
  grp.template mul_n<2>(rl, zr, rz);
  const fe ax = fe_reduce(grp.full(acc[0])), ay = fe_reduce(grp.full(acc[1]));
  const fe rx = fe_reduce(grp.full(rz[0])), ry = fe_reduce(grp.full(rz[1]));
  const bool eq = equal(ax, rx) & equal(ay, ry);
  if (affine) {  // uniform over the launch
    const E zinv = coop::coop_invert(grp, acc[2]);
    const E zl[2] = {zinv, zinv};
    E xy[2];
    grp.template mul_n<2>(acc, zl, xy);
    to15(fe_canonical(fe_reduce(grp.full(xy[0]))), x_out);
    to15(fe_canonical(fe_reduce(grp.full(xy[1]))), y_out);
  }
  return eq && ok_a && ok_r && precheck;
}

// The test entry's point operations, for either group, on whole points
// p and q (carried limbs) -> out, carried (the callers take it to
// canonical form):
//   op 0: double p (X, Y, Z, T)   op 1: p + q with q cached (X, Y, Z, T)
//   op 2: decompress p's y with `sign` (x, y, 1, xy); returns ok
template <class Grp>
FE_FN bool point_op(Grp& grp, int op, const fe p[4], const fe q[4], int sign, fe out[4]) {
  using E = typename Grp::elem;
  xyzt<E> r;
  bool ok = true;
  if (op == 0) {
    r = point_double(grp, grp.pick(p[0]), grp.pick(p[1]), grp.pick(p[2]));
  } else if (op == 1) {
    const xyzt<E> a = {grp.pick(p[0]), grp.pick(p[1]), grp.pick(p[2]), grp.pick(p[3])};
    const xyzt<E> b = {grp.pick(q[0]), grp.pick(q[1]), grp.pick(q[2]), grp.pick(q[3])};
    r = point_add<true>(grp, a, to_cached(grp, b, grp.mul(b.t, grp.pick(ed25519::d2()))));
  } else {
    r.y = grp.pick(p[1]);
    r.x = decompress_x(grp, r.y, sign, ok);
    r.z = grp.pick(fe25519::fe_one());
    r.t = grp.mul(r.x, r.y);
  }
  const E o[4] = {r.x, r.y, r.z, r.t};
#pragma unroll
  for (int c = 0; c < 4; ++c) out[c] = fe25519::fe_reduce(grp.full(o[c]));
  return ok;
}

}  // namespace ladder

#ifdef __CUDACC__

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int LANES = THREADS / 32 * coop::GROUPS_PER_WARP;  // 24 lanes a block
constexpr int NL = ladder::NL;

// The lane of this thread's group, and whether it is one of the batch's.
__device__ __forceinline__ int lane_of(const coop::warp_group& grp) {
  return (blockIdx.x * (THREADS / 32) + threadIdx.x / 32) * coop::GROUPS_PER_WARP + grp.group();
}

__device__ __forceinline__ bool in_batch(const coop::warp_group& grp, int lane, int batch) {
  return grp.group() < coop::GROUPS_PER_WARP && lane < batch;
}

__global__ void __launch_bounds__(THREADS)
ladder_verify_kernel(const int32_t* __restrict__ a_y, const int32_t* __restrict__ a_sign,
                     const int32_t* __restrict__ r_y, const int32_t* __restrict__ r_sign,
                     const int32_t* __restrict__ s_bits, const int32_t* __restrict__ k_bits,
                     const bool* __restrict__ precheck, bool* __restrict__ verdict,
                     int32_t* __restrict__ affine, int batch) {
  coop::warp_group grp = coop::warp_group::of_thread();
  const int lane = lane_of(grp);
  const bool valid = in_batch(grp, lane, batch);
  const int at = valid ? lane : 0;
  const ladder::lane_src src{a_y + at,  r_y + at, s_bits + at, k_bits + at,
                             valid ? __ldg(a_sign + lane) : 0,
                             valid ? __ldg(r_sign + lane) : 0, batch, valid};
  int32_t xo[NL], yo[NL];
  const bool ok = ladder::verify_lane(grp, src, valid && precheck[at], affine != nullptr, xo, yo);
  if (!valid || grp.j != 0) return;
  verdict[lane] = ok;
  if (affine == nullptr) return;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    affine[(long long)i * batch + lane] = xo[i];
    affine[(long long)(NL + i) * batch + lane] = yo[i];
  }
}

// Test entry for the point operations on the card (`ladder::point_op`),
// a group of G threads a point as in the ladder kernel: p, q (4*17, n)
// int32 points in 17 x 15 limbs, sign (n,) int32; out (4*17, n) canonical
// limbs, ok (n,) int32.
__global__ void __launch_bounds__(THREADS)
point_op_kernel(int op, const int32_t* __restrict__ p, const int32_t* __restrict__ q,
                const int32_t* __restrict__ sign, int32_t* __restrict__ out,
                int32_t* __restrict__ ok, int n) {
  using namespace fe25519;
  coop::warp_group grp = coop::warp_group::of_thread();
  const int lane = lane_of(grp);
  const bool valid = in_batch(grp, lane, n);
  fe a[4], b[4], r[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    int32_t la[NL], lb[NL];
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      la[i] = valid ? __ldg(p + (long long)(c * NL + i) * n + lane) : (i == 0);
      lb[i] = valid ? __ldg(q + (long long)(c * NL + i) * n + lane) : (i == 0);
    }
    a[c] = from15(la);
    b[c] = from15(lb);
  }
  const bool good = ladder::point_op(grp, op, a, b, valid ? __ldg(sign + lane) : 0, r);
  if (!valid || grp.j != 0) return;
  ok[lane] = good;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    int32_t lo[NL];
    to15(fe_canonical(r[c]), lo);
#pragma unroll
    for (int i = 0; i < NL; ++i) out[(long long)(c * NL + i) * n + lane] = lo[i];
  }
}

}  // namespace

// Launches on `stream`; affine may be null. Returns cudaGetLastError().
extern "C" int ladder_verify_launch(const int32_t* a_y, const int32_t* a_sign,
                                    const int32_t* r_y, const int32_t* r_sign,
                                    const int32_t* s_bits, const int32_t* k_bits,
                                    const bool* precheck, bool* verdict, int32_t* affine,
                                    int batch, void* stream) {
  if (batch <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((batch + LANES - 1) / LANES);
  ladder_verify_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      a_y, a_sign, r_y, r_sign, s_bits, k_bits, precheck, verdict, affine, batch);
  return (int)cudaGetLastError();
}

// The point operations' test entry (ops 0-2 of ladder::point_op).
extern "C" int ladder_point_op_launch(int op, const int32_t* p, const int32_t* q,
                                      const int32_t* sign, int32_t* out, int32_t* ok, int n,
                                      void* stream) {
  if (n <= 0 || op < 0 || op > 2) return (int)cudaErrorInvalidValue;
  point_op_kernel<<<(n + LANES - 1) / LANES, THREADS, 0, (cudaStream_t)stream>>>(
      op, p, q, sign, out, ok, n);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
