// GF(2^255 - 19) arithmetic shared by a group of G = 5 threads: one field
// element's ten radix-2^25.5 limbs (field25519.cuh's layout) spread over
// the group, thread j owning limbs 2j and 2j + 1 (a 51-bit chunk). A
// multiply's latency is then one gather of the operands, a thread's two
// column sums (20 wide products in place of 100, or 55 for a square) and
// two carry rounds that run on all limbs at once in place of ref10's
// serial chain.
//
// Why G = 5 and not 10 (one limb a thread, in groups of 16 for simple
// shuffle widths): 6 groups fit a warp, with 2 threads idle, against 2 or
// 3; a thread gathers 18 limbs (8 rotated + 10 in place) and moves 3
// carry words a multiply at G = 5, about as many at G = 10, so G = 10
// spends 2-3x the warp shuffles a lane for a product phase of 10 products
// a thread in place of 20. Reckoning at B = 8192 on an H100 (132
// SMs, a warp shuffle issuing once a clock per SM): 267 multiplies x 21
// shuffles over 6 lanes a warp is 7.6 M warp shuffles, about 0.03 ms at
// 1.98 GHz, and the products (20 wide ones a thread, 5 threads a lane)
// about as much again; the chain's latency is about 200-250 clocks a
// multiply, about 0.03 ms for 267 of them at any B.
//
// Layout of a multiply f * g, thread j (column c = 2j + d, d = 0, 1):
//   c = sum over m of f[(2j + m) % 10] * g[(d - m) % 10]
// so each thread gathers f rotated by 2j (its own pair first) and g in
// place, and every index below is static: only the x19 fold of a product
// past limb 9 depends on j (2j + m < 10 while m > d), which `columns`
// selects on the rotated operand. ref10's factors: odd x odd products
// count twice (taken on g), products past limb 9 times 19 (taken on f);
// every factor stays within int32 (19 * 1.65 * 2^26 < 2^31, and
// 2 * 1.65 * 2^25 on the other side).
//
// Bound argument (inputs within fe_mul's 1.65 * 2^26 / 1.65 * 2^25):
// - column sums are ref10's, at most 2^60.41 (column 0; the others less);
// - carry round 1, every limb at once: each limb keeps its rounded
//   remainder (at most 2^(w-1)) and takes its lower neighbour's carry, at
//   most 2^34.8 (19 * 2^30.8 = 2^35.1 into limb 0), so limbs stay within
//   2^35.1;
// - carry round 2: carries at most 679 (2^9.5), 19 * 91 = 1729 (2^10.8)
//   into limb 0, so they fit int32 and round 2 moves them in one 32-bit
//   shuffle;
// - the result: limbs within 2^(w-1) + 1729, far inside fe_mul's input
//   bounds, so a square's output is a valid input to the next for all 254
//   steps of the inversion. The host tests compute these bounds from the
//   input bounds, and run a multiply and a 254-square chain from limbs at
//   their extremes, checking every step's column sums, limbs and round-2
//   carries against them.
// The result is carried, not ref10-carried: fe_reduce once after the
// final gather brings it to what fe_canonical expects.
//
// The point formulas (the ladder kernel's) add and subtract shares
// between multiplies. Every multiply input there is a sum or difference
// of at most three terms, each a multiply's output, a `reduce` output or
// a carried constant or load, so each within 2^(w-1) + 1729: the input
// is within 1.5 * 2^w + 5187, inside fe_mul's 1.65 * 2^w. A sum of four
// is not (2^(w+1)), which is why the doubling's 2 Z^2 goes through `reduce`:
// one carry round on all limbs at once, whose input (2 Z^2, within
// 2^w + 3458) gives carries of at most 1 (19 into limb 0) and limbs
// within 2^(w-1) + 19. The host tests run a 256-step ladder from limbs
// at these extremes and check every multiply's inputs, column sums,
// round-2 carries and outputs against the bounds above.
//
// The arithmetic each thread does between exchanges is in phase functions
// (`columns`, `carry_out`, `carry_in`, `pick`, and the share-wise `add`,
// `sub`, `neg`, `select`), __host__ __device__ like field25519.cuh. Two
// group types move the limbs between them: `warp_group` with warp
// shuffles on the card, and `host_group`, which runs the same phase
// functions for j = 0..G-1 in lockstep over arrays (the host tests'
// emulation). Both offer the same operations (`mul`, `sq`, `mul_n`,
// `reduce`, `pick`, `full` and the share-wise ones), so the chains
// (`coop_invert`, `coop_pow22523`) and the kernels' lanes are written
// once, for either group.

#pragma once

#include <algorithm>
#include <cstdlib>

#include "field25519.cuh"

namespace coop {

using fe25519::fe;

constexpr int G = 5;             // threads a field element
constexpr int GROUPS_PER_WARP = 32 / G;

// One thread's share of an element: limbs 2j and 2j + 1.
struct cfe {
  int32_t v[2];
};

// --- phase functions: what thread j computes between exchanges ---------

// Thread j's two column sums of f * g. `fr` is f rotated by 2j
// (fr[m] = f[(2j + m) % 10]), `g` in place.
FE_FN void columns(int j, const int32_t fr[10], const int32_t g[10], int64_t h[2]) {
  int32_t f19[10], g2[10];
#pragma unroll
  for (int m = 0; m < 10; ++m) {
    f19[m] = (2 * j + m < 10) ? 19 * fr[m] : fr[m];
    g2[m] = (m & 1) ? 2 * g[m] : g[m];
  }
#pragma unroll
  for (int d = 0; d < 2; ++d) {
    int64_t s = 0;
#pragma unroll
    for (int m = 0; m < 10; ++m) {
      const int n = (d - m + 10) % 10;
      const int32_t a = (m > d) ? f19[m] : fr[m];
      const int32_t b = (m & 1) ? g2[n] : g[n];  // g2 doubles odd n only
      s += (int64_t)a * b;
    }
    h[d] = s;
  }
}

// The carry that leaves thread j's upper limb (2j + 1, 25 bits) in a
// round: rounded, as ref10's.
FE_FN int64_t carry_out(const int64_t h[2]) { return (h[1] + ((int64_t)1 << 24)) >> 25; }

// One carry round on thread j's limbs, all limbs at once: each keeps its
// rounded remainder and takes the carry from below, `c_prev` from the
// previous thread's upper limb (limb 9's, times 19, into thread 0).
FE_FN void carry_in(int j, int64_t h[2], int64_t c_prev) {
  const int64_t c0 = (h[0] + ((int64_t)1 << 25)) >> 26;
  const int64_t c1 = carry_out(h);
  h[0] += (j == 0 ? 19 : 1) * c_prev - c0 * ((int64_t)1 << 26);
  h[1] += c0 - c1 * ((int64_t)1 << 25);
}

// Thread j's pair of a whole element.
FE_FN cfe pick(int j, const fe& a) {
  cfe r = {{a.v[0], a.v[1]}};
#pragma unroll
  for (int t = 1; t < G; ++t) {
    if (j == t) {
      r.v[0] = a.v[2 * t];
      r.v[1] = a.v[2 * t + 1];
    }
  }
  return r;
}

// Share-wise sums, differences and negation: a thread's pair alone.
FE_FN cfe add(const cfe& a, const cfe& b) { return {{a.v[0] + b.v[0], a.v[1] + b.v[1]}}; }
FE_FN cfe sub(const cfe& a, const cfe& b) { return {{a.v[0] - b.v[0], a.v[1] - b.v[1]}}; }
FE_FN cfe neg(const cfe& a) { return {{-a.v[0], -a.v[1]}}; }

// `c ? a : b` by selects. The group's threads agree on c, the warp's
// other groups need not: a branch around a shuffle would split the warp.
FE_FN cfe select(bool c, const cfe& a, const cfe& b) {
  return {{c ? a.v[0] : b.v[0], c ? a.v[1] : b.v[1]}};
}

// fe_mul's input bound on limb k (1.65 * 2^width), for the host tests.
inline int64_t in_bound(int k) { return (int64_t)(1.65 * (double)(1 << fe25519::width(k))); }

// --- the groups: how the limbs move between the phases -----------------

// The host emulation: all G threads' pairs in one value, every phase run
// for j = 0..G-1 before the next. The exchanges a shuffle makes on the
// card are array reads here; round 2's carry passes through int32, as its
// shuffle does. For the tests of the bound argument, `max_column` and
// `max_carry2` record the largest column sum and round-2 carry seen,
// `in_excess` the largest excess of a multiply input's limb over
// `in_bound`, `out_excess` of an output's limb over 2^(width - 1).
struct host_group {
  struct elem {
    cfe t[G];
  };
  int64_t max_column = 0;
  int64_t max_carry2 = 0;
  int64_t in_excess = INT64_MIN;
  int64_t out_excess = INT64_MIN;

  template <class Op>
  static elem each(Op op) {
    elem r;
    for (int j = 0; j < G; ++j) r.t[j] = op(j);
    return r;
  }
  elem add(const elem& a, const elem& b) const {
    return each([&](int j) { return coop::add(a.t[j], b.t[j]); });
  }
  elem sub(const elem& a, const elem& b) const {
    return each([&](int j) { return coop::sub(a.t[j], b.t[j]); });
  }
  elem neg(const elem& a) const { return each([&](int j) { return coop::neg(a.t[j]); }); }
  elem select(bool c, const elem& a, const elem& b) const { return c ? a : b; }

  // One carry round on every limb at once; the carry passes through int32.
  elem reduce(const elem& a) const {
    int64_t h[G][2], c[G];
    for (int j = 0; j < G; ++j) {
      h[j][0] = a.t[j].v[0];
      h[j][1] = a.t[j].v[1];
      c[j] = (int32_t)carry_out(h[j]);
    }
    return each([&](int j) {
      carry_in(j, h[j], c[(j + G - 1) % G]);
      return cfe{{(int32_t)h[j][0], (int32_t)h[j][1]}};
    });
  }

  elem pick(const fe& a) const {
    elem r;
    for (int j = 0; j < G; ++j) r.t[j] = coop::pick(j, a);
    return r;
  }

  fe full(const elem& a) const {
    fe r;
    for (int k = 0; k < 10; ++k) r.v[k] = a.t[k / 2].v[k % 2];
    return r;
  }

  void track_inputs(const elem& a) {
    for (int k = 0; k < 10; ++k)
      in_excess = std::max(in_excess, (int64_t)std::abs(a.t[k / 2].v[k % 2]) - in_bound(k));
  }

  elem mul(const elem& f, const elem& g) {
    track_inputs(f);
    track_inputs(g);
    int64_t h[G][2];
    for (int j = 0; j < G; ++j) {
      int32_t fr[10], ga[10];
      for (int t = 0; t < G; ++t) {
        fr[2 * t] = f.t[(j + t) % G].v[0];
        fr[2 * t + 1] = f.t[(j + t) % G].v[1];
        ga[2 * t] = g.t[t].v[0];
        ga[2 * t + 1] = g.t[t].v[1];
      }
      columns(j, fr, ga, h[j]);
      for (int d = 0; d < 2; ++d) max_column = std::max(max_column, std::abs(h[j][d]));
    }
    for (int round = 0; round < 2; ++round) {
      int64_t c[G];
      for (int j = 0; j < G; ++j) c[j] = carry_out(h[j]);
      if (round == 1) {
        for (int j = 0; j < G; ++j) {
          max_carry2 = std::max(max_carry2, std::abs(c[j]));
          c[j] = (int32_t)c[j];
        }
      }
      for (int j = 0; j < G; ++j) carry_in(j, h[j], c[(j + G - 1) % G]);
    }
    elem r;
    for (int j = 0; j < G; ++j) r.t[j] = {{(int32_t)h[j][0], (int32_t)h[j][1]}};
    for (int k = 0; k < 10; ++k)
      out_excess = std::max(out_excess, (int64_t)std::abs(r.t[k / 2].v[k % 2]) -
                                            ((int64_t)1 << (fe25519::width(k) - 1)));
    return r;
  }

  elem sq(const elem& f) { return mul(f, f); }

  // N independent products (the card issues them together).
  template <int N>
  void mul_n(const elem* f, const elem* g, elem* r) {
    for (int i = 0; i < N; ++i) r[i] = mul(f[i], g[i]);
  }
};

#ifdef __CUDACC__

// The card: thread j of the group at warp lanes base .. base + G - 1.
// Every thread of the warp runs every exchange with the full mask; the
// two threads past the warp's last group (lanes 30 and 31) run as a
// group at base 30 on whatever their shuffles bring and store nothing.
// Its methods are __host__ __device__ only so that the chain's template
// can call them from either side; they run on the card alone, and a host
// call of an exchange aborts.
struct warp_group {
  using elem = cfe;
  int j;
  int base;
  int rot[G - 1];  // lanes of the pairs (j + t) % G, t = 1..G-1; rot[G-2] is the previous

  __device__ static warp_group of_thread() {
    warp_group w;
    const int lane = threadIdx.x & 31;
    w.base = lane / G * G;
    w.j = lane - w.base;
#pragma unroll
    for (int t = 1; t < G; ++t) w.rot[t - 1] = w.base + (w.j + t) % G;
    return w;
  }

  // the group's index within its warp (GROUPS_PER_WARP for lanes 30, 31)
  FE_FN int group() const { return base / G; }

  FE_FN static int32_t shfl(int32_t v, int src) {
#ifdef __CUDA_ARCH__
    return __shfl_sync(0xffffffffu, v, src);
#else
    (void)v;
    (void)src;
    std::abort();  // the host runs host_group
#endif
  }

  FE_FN static int64_t shfl64(int64_t v, int src) {
    const uint32_t lo = (uint32_t)shfl((int32_t)(uint32_t)(uint64_t)v, src);
    const uint32_t hi = (uint32_t)shfl((int32_t)((uint64_t)v >> 32), src);
    return (int64_t)(((uint64_t)hi << 32) | lo);
  }

  FE_FN elem pick(const fe& a) const { return coop::pick(j, a); }

  FE_FN fe full(const elem& a) const {
    fe r;
#pragma unroll
    for (int t = 0; t < G; ++t) {
      r.v[2 * t] = shfl(a.v[0], base + t);
      r.v[2 * t + 1] = shfl(a.v[1], base + t);
    }
    return r;
  }

  FE_FN elem add(const elem& a, const elem& b) const { return coop::add(a, b); }
  FE_FN elem sub(const elem& a, const elem& b) const { return coop::sub(a, b); }
  FE_FN elem neg(const elem& a) const { return coop::neg(a); }
  FE_FN elem select(bool c, const elem& a, const elem& b) const { return coop::select(c, a, b); }

  // One carry round on every limb at once (one 32-bit shuffle).
  FE_FN elem reduce(const elem& a) const {
    int64_t h[2] = {a.v[0], a.v[1]};
    carry_in(j, h, shfl((int32_t)carry_out(h), rot[G - 2]));
    return {{(int32_t)h[0], (int32_t)h[1]}};
  }

  // N independent products r[i] = f[i] * g[i], issued together: every
  // gather, then every product's columns, then each carry round for all
  // N, so that a multiply's three shuffle latencies in series are paid
  // once for the N (on an H100 the ladder runs 1-6% faster so than with
  // one product after the other).
  template <int N>
  FE_FN void mul_n(const elem* f, const elem* g, elem* r) const {
    int32_t fr[N][10], ga[N][10];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      fr[i][0] = f[i].v[0];
      fr[i][1] = f[i].v[1];
#pragma unroll
      for (int t = 1; t < G; ++t) {
        fr[i][2 * t] = shfl(f[i].v[0], rot[t - 1]);
        fr[i][2 * t + 1] = shfl(f[i].v[1], rot[t - 1]);
      }
#pragma unroll
      for (int t = 0; t < G; ++t) {
        ga[i][2 * t] = shfl(g[i].v[0], base + t);
        ga[i][2 * t + 1] = shfl(g[i].v[1], base + t);
      }
    }
    int64_t h[N][2], c[N];
#pragma unroll
    for (int i = 0; i < N; ++i) columns(j, fr[i], ga[i], h[i]);
#pragma unroll
    for (int i = 0; i < N; ++i) c[i] = shfl64(carry_out(h[i]), rot[G - 2]);  // round 1: up to 2^35.4
#pragma unroll
    for (int i = 0; i < N; ++i) {
      carry_in(j, h[i], c[i]);
      c[i] = shfl((int32_t)carry_out(h[i]), rot[G - 2]);  // round 2: within int32
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
      carry_in(j, h[i], c[i]);
      r[i] = {{(int32_t)h[i][0], (int32_t)h[i][1]}};
    }
  }

  // One product. `mul_n<1>` computes the same, but the verdict kernel,
  // which runs single products only, compiles to 2-5% faster code at
  // small B (an H100) with this body.
  FE_FN elem mul(const elem& f, const elem& g) const {
    int32_t fr[10];
    fr[0] = f.v[0];
    fr[1] = f.v[1];
#pragma unroll
    for (int t = 1; t < G; ++t) {
      fr[2 * t] = shfl(f.v[0], rot[t - 1]);
      fr[2 * t + 1] = shfl(f.v[1], rot[t - 1]);
    }
    const fe ga = full(g);
    int64_t h[2];
    columns(j, fr, ga.v, h);
    carry_in(j, h, shfl64(carry_out(h), rot[G - 2]));          // round 1: up to 2^35.4
    carry_in(j, h, shfl((int32_t)carry_out(h), rot[G - 2]));   // round 2: within int32
    return {{(int32_t)h[0], (int32_t)h[1]}};
  }

  FE_FN elem sq(const elem& f) const { return mul(f, f); }
};

#endif  // __CUDACC__

// --- the chain, for either group ---------------------------------------

template <class Grp>
FE_FN typename Grp::elem coop_sqn(Grp& grp, typename Grp::elem x, int n) {
#pragma unroll 1
  for (int i = 0; i < n; ++i) x = grp.sq(x);
  return x;
}

// z^(2^250 - 1), and z^11 in `z11`: field25519.cuh's fe_chain250 on the
// group's shares.
template <class Grp>
FE_FN typename Grp::elem coop_chain250(Grp& grp, const typename Grp::elem& z,
                                       typename Grp::elem& z11) {
  using E = typename Grp::elem;
  const E z2 = grp.sq(z);                                  // 2
  const E z9 = grp.mul(z, coop_sqn(grp, z2, 2));           // 9
  z11 = grp.mul(z2, z9);                                   // 11
  const E z5 = grp.mul(z9, grp.sq(z11));                   // 2^5 - 1
  const E z10 = grp.mul(coop_sqn(grp, z5, 5), z5);         // 2^10 - 1
  const E z20 = grp.mul(coop_sqn(grp, z10, 10), z10);      // 2^20 - 1
  const E z40 = grp.mul(coop_sqn(grp, z20, 20), z20);      // 2^40 - 1
  const E z50 = grp.mul(coop_sqn(grp, z40, 10), z10);      // 2^50 - 1
  const E z100 = grp.mul(coop_sqn(grp, z50, 50), z50);     // 2^100 - 1
  const E z200 = grp.mul(coop_sqn(grp, z100, 100), z100);  // 2^200 - 1
  return grp.mul(coop_sqn(grp, z200, 50), z50);            // 2^250 - 1
}

// x^(p - 2): fe_invert's chain, 254 squarings and 11 multiplies (0 -> 0).
template <class Grp>
FE_FN typename Grp::elem coop_invert(Grp& grp, const typename Grp::elem& z) {
  typename Grp::elem z11;
  const auto z250 = coop_chain250(grp, z, z11);
  return grp.mul(coop_sqn(grp, z250, 5), z11);  // 2^255 - 21
}

// x^((p - 5) / 8) = x^(2^252 - 3): fe_pow22523's chain, 251 squarings and
// 11 multiplies.
template <class Grp>
FE_FN typename Grp::elem coop_pow22523(Grp& grp, const typename Grp::elem& z) {
  typename Grp::elem z11;
  const auto z250 = coop_chain250(grp, z, z11);
  return grp.mul(coop_sqn(grp, z250, 2), z);  // 2^252 - 3
}

}  // namespace coop
