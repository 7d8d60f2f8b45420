// GF(2^255 - 19) arithmetic for the port's CUDA kernels, in ref10's radix
// 2^25.5: ten signed int32 limbs of alternately 26 and 25 bits (limb k at
// bit offset ceil(25.5 k)), multiplied with 32 x 32 -> 64-bit products.
//
// Why this radix on Hopper: the JAX package's 17 x 15-bit limbs suit a
// vector unit without a wide multiply (every 30-bit product is split, masked
// and added into two columns: about 1,450 int32 instructions a multiply).
// Hopper multiplies 32 x 32 -> 64 in one instruction (IMAD.WIDE), so a field
// multiply here is 100 wide products (55 for a square) and one carry chain.
// Both kernels that include this header are latency-bound chains of field
// multiplies, so fewer instructions on the chain is what makes them faster.
//
// The 17 x 15 layout stays the layout of the key bank and of every tensor
// between kernels; `from15` and `to15` convert at the kernels' edges.
//
// Bounds (ref10's): fe_mul and fe_sq take limbs up to 1.65 * 2^26 (even k)
// and 1.65 * 2^25 (odd k) in magnitude and return limbs up to about 2^25 and
// 2^24. A sum or difference of up to three such outputs is a valid input,
// which is all the point formulas need.
//
// Every function is __host__ __device__ under nvcc and plain inline C++
// otherwise, so the same arithmetic also compiles with a host compiler.

#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define FE_FN __host__ __device__ __forceinline__
#else
#define FE_FN inline
#endif

namespace fe25519 {

constexpr int NL15 = 17;            // limbs of the 17 x 15 layout
constexpr int32_t MASK15 = (1 << 15) - 1;

// bit offset of limb k (k = 10 is the 2^255 boundary)
FE_FN constexpr int off(int k) { return (51 * k + 1) / 2; }
FE_FN constexpr int width(int k) { return off(k + 1) - off(k); }

struct fe {
  int32_t v[10];
};

FE_FN fe fe_zero() {
  fe r;
#pragma unroll
  for (int k = 0; k < 10; ++k) r.v[k] = 0;
  return r;
}

FE_FN fe fe_one() {
  fe r = fe_zero();
  r.v[0] = 1;
  return r;
}

FE_FN fe fe_add(const fe& a, const fe& b) {
  fe r;
#pragma unroll
  for (int k = 0; k < 10; ++k) r.v[k] = a.v[k] + b.v[k];
  return r;
}

FE_FN fe fe_sub(const fe& a, const fe& b) {
  fe r;
#pragma unroll
  for (int k = 0; k < 10; ++k) r.v[k] = a.v[k] - b.v[k];
  return r;
}

// -a: the limbs negated, so the bounds are a's.
FE_FN fe fe_neg(const fe& a) {
  fe r;
#pragma unroll
  for (int k = 0; k < 10; ++k) r.v[k] = -a.v[k];
  return r;
}

// ref10's carry chain over 64-bit column sums: rounding carries, two
// independent chains interleaved (0..4 and 4..9), the top carry folded back
// times 19 (2^255 = 19 mod p). Output limbs up to about 2^25 / 2^24.
FE_FN fe fe_carry(int64_t h[10]) {
  int64_t c;
#define FE_CARRY(k, next, scale)                                   \
  c = (h[k] + ((int64_t)1 << (width(k) - 1))) >> width(k);        \
  h[next] += c * (scale);                                          \
  h[k] -= c * ((int64_t)1 << width(k));
  FE_CARRY(0, 1, 1)
  FE_CARRY(4, 5, 1)
  FE_CARRY(1, 2, 1)
  FE_CARRY(5, 6, 1)
  FE_CARRY(2, 3, 1)
  FE_CARRY(6, 7, 1)
  FE_CARRY(3, 4, 1)
  FE_CARRY(7, 8, 1)
  FE_CARRY(4, 5, 1)
  FE_CARRY(8, 9, 1)
  FE_CARRY(9, 0, 19)
  FE_CARRY(0, 1, 1)
#undef FE_CARRY
  fe r;
#pragma unroll
  for (int k = 0; k < 10; ++k) r.v[k] = (int32_t)h[k];
  return r;
}

// a with its limbs carried: a sum or difference of a few carried elements,
// or a canonical one, back to the carried bounds.
FE_FN fe fe_reduce(const fe& a) {
  int64_t h[10];
#pragma unroll
  for (int k = 0; k < 10; ++k) h[k] = a.v[k];
  return fe_carry(h);
}

// Schoolbook 10 x 10 product. Limb i times limb j lands on column i + j;
// when i and j are both odd the offsets add up one bit short, so the
// product counts twice; columns past 9 fold back times 19. The doubled and
// the 19-fold factors are taken onto the operands, as ref10 does, so every
// factor stays within int32.
FE_FN fe fe_mul(const fe& f, const fe& g) {
  int32_t g19[10], f2[10];
#pragma unroll
  for (int k = 0; k < 10; ++k) {
    g19[k] = 19 * g.v[k];
    f2[k] = (k & 1) ? 2 * f.v[k] : f.v[k];
  }
  int64_t h[10];
#pragma unroll
  for (int k = 0; k < 10; ++k) h[k] = 0;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
#pragma unroll
    for (int j = 0; j < 10; ++j) {
      const int32_t a = (i & j & 1) ? f2[i] : f.v[i];
      const int32_t b = (i + j >= 10) ? g19[j] : g.v[j];
      h[(i + j) % 10] += (int64_t)a * b;
    }
  }
  return fe_carry(h);
}

// Square: the 45 off-diagonal products once, doubled on the left operand.
FE_FN fe fe_sq(const fe& f) {
  int64_t h[10];
#pragma unroll
  for (int k = 0; k < 10; ++k) h[k] = 0;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
#pragma unroll
    for (int j = i; j < 10; ++j) {
      const int32_t a = (i == j) ? f.v[i] : 2 * f.v[i];
      const int32_t b = ((i & j & 1) ? 2 : 1) * ((i + j >= 10) ? 19 : 1) * f.v[j];
      h[(i + j) % 10] += (int64_t)a * b;
    }
  }
  return fe_carry(h);
}

FE_FN fe fe_sqn(fe x, int n) {
#pragma unroll 1
  for (int i = 0; i < n; ++i) x = fe_sq(x);
  return x;
}

// ref10's shared prefix of the two exponentiation chains: z^(2^250 - 1),
// and z^11 in `z11`.
FE_FN fe fe_chain250(const fe& z, fe& z11) {
  const fe z2 = fe_sq(z);                           // 2
  const fe z9 = fe_mul(z, fe_sqn(z2, 2));           // 9
  z11 = fe_mul(z2, z9);                             // 11
  const fe z5 = fe_mul(z9, fe_sq(z11));             // 2^5 - 1
  const fe z10 = fe_mul(fe_sqn(z5, 5), z5);         // 2^10 - 1
  const fe z20 = fe_mul(fe_sqn(z10, 10), z10);      // 2^20 - 1
  const fe z40 = fe_mul(fe_sqn(z20, 20), z20);      // 2^40 - 1
  const fe z50 = fe_mul(fe_sqn(z40, 10), z10);      // 2^50 - 1
  const fe z100 = fe_mul(fe_sqn(z50, 50), z50);     // 2^100 - 1
  const fe z200 = fe_mul(fe_sqn(z100, 100), z100);  // 2^200 - 1
  return fe_mul(fe_sqn(z200, 50), z50);             // 2^250 - 1
}

// x^(p - 2) = x^(2^255 - 21): ref10's chain of 254 squarings and 11
// multiplies (0 -> 0).
FE_FN fe fe_invert(const fe& z) {
  fe z11;
  const fe z250 = fe_chain250(z, z11);
  return fe_mul(fe_sqn(z250, 5), z11);  // 2^255 - 21
}

// x^((p - 5) / 8) = x^(2^252 - 3), the square-root helper exponent:
// ref10's fe_pow22523, 251 squarings and 11 multiplies.
FE_FN fe fe_pow22523(const fe& z) {
  fe z11;
  const fe z250 = fe_chain250(z, z11);
  return fe_mul(fe_sqn(z250, 2), z);  // 2^252 - 3
}

// The unique representative in [0, p), every limb in [0, 2^width): ref10's
// fe_tobytes reduction. Input: carried limbs (a fe_mul / fe_sq / from15
// output).
FE_FN fe fe_canonical(const fe& a) {
  int32_t h[10];
#pragma unroll
  for (int k = 0; k < 10; ++k) h[k] = a.v[k];
  // q = floor(h / 2^255), 0 or 1 for a carried input; then h - q p is the
  // representative, computed as h + 19 q with the 2^255 bit dropped
  int32_t q = (19 * h[9] + (1 << 24)) >> 25;
#pragma unroll
  for (int k = 0; k < 10; ++k) q = (h[k] + q) >> width(k);
  h[0] += 19 * q;
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const int32_t c = h[k] >> width(k);
    h[k + 1] += c;
    h[k] -= c * (1 << width(k));
  }
  h[9] &= (1 << width(9)) - 1;
  fe r;
#pragma unroll
  for (int k = 0; k < 10; ++k) r.v[k] = h[k];
  return r;
}

// Both canonical: limb-wise equality is equality in the field.
FE_FN bool fe_equal_canonical(const fe& a, const fe& b) {
  int32_t d = 0;
#pragma unroll
  for (int k = 0; k < 10; ++k) d |= a.v[k] ^ b.v[k];
  return d == 0;
}

// Low bit of the canonical representative (an Edwards x's sign bit).
FE_FN int fe_parity_canonical(const fe& a) { return a.v[0] & 1; }

// 17 x 15 limbs (any nonnegative limbs below 2^17: the weak form of the
// JAX package's field, with limb 0 up to 2^15 + 38 and the others up to
// 2^15 + 2^11, is well inside) -> carried radix-2^25.5 limbs. Each 15-bit
// limb adds into the ref10 limb holding its low bit; one that straddles a
// boundary is split there. A limb's bits above 15 simply add into the
// next limb's range, and the carry chain then brings every limb in range.
FE_FN fe from15(const int32_t l[NL15]) {
  int64_t h[10];
#pragma unroll
  for (int k = 0; k < 10; ++k) h[k] = 0;
#pragma unroll
  for (int i = 0; i < NL15; ++i) {
    const int s = 15 * i;
    int k = 0;
#pragma unroll
    for (int t = 1; t < 10; ++t) k = (off(t) <= s) ? t : k;
    const int room = off(k + 1) - s;
    if (room >= 15 || k == 9) {
      h[k] += (int64_t)l[i] << (s - off(k));
    } else {
      h[k] += (int64_t)(l[i] & ((1 << room) - 1)) << (s - off(k));
      h[k + 1] += (int64_t)(l[i] >> room);
    }
  }
  return fe_carry(h);
}

// Canonical limbs -> the canonical 17 x 15 limbs of the same value.
FE_FN void to15(const fe& c, int32_t out[NL15]) {
#pragma unroll
  for (int i = 0; i < NL15; ++i) {
    const int s = 15 * i;
    int k = 0;
#pragma unroll
    for (int t = 1; t < 10; ++t) k = (off(t) <= s) ? t : k;
    uint32_t v = (uint32_t)c.v[k] >> (s - off(k));
    if (k < 9 && off(k + 1) - s < 15) v |= (uint32_t)c.v[k + 1] << (off(k + 1) - s);
    out[i] = (int32_t)(v & MASK15);
  }
}

// 32 little-endian bytes -> limbs of the low 255 bits (bit 255, the sign of
// an encoded point's x, is left out).
FE_FN fe from_bytes(const uint8_t b[32]) {
  int64_t h[10];
#pragma unroll
  for (int k = 0; k < 10; ++k) {
    uint64_t w = 0;
#pragma unroll
    for (int t = 0; t < 5; ++t) {
      const int byte = off(k) / 8 + t;
      if (byte < 32) w |= (uint64_t)b[byte] << (8 * t);
    }
    h[k] = (int64_t)((w >> (off(k) % 8)) & ((1u << width(k)) - 1));
  }
  return fe_carry(h);
}

}  // namespace fe25519
