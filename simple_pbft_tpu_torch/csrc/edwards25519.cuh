// Edwards25519 points in extended coordinates (X, Y, Z, T), x = X/Z,
// y = Y/Z, T = XY/Z, on the radix-2^25.5 field of field25519.cuh, for the
// port's CUDA kernels.
//
// The formulas are the JAX package's (ops/edwards.py) and the CPU oracle's:
// unified addition add-2008-hwcd-3 with 2d and doubling dbl-2008-hwcd, so a
// kernel and the plain PyTorch versions compute the same rational functions
// of their inputs and agree after canonical reduction, also on inputs that
// are not curve points.
//
// Bounds: every coordinate a function here returns is a carried element (a
// fe_mul / fe_sq / fe_reduce output); given such inputs, every fe_mul and
// fe_sq operand below is a sum or difference of at most three of them,
// which field25519.cuh's bounds allow.
//
// Every function is __host__ __device__ under nvcc and plain inline C++
// otherwise.

#pragma once

#include "field25519.cuh"

namespace ed25519 {

using fe25519::fe;

struct point {
  fe x, y, z, t;
};

FE_FN point identity() {
  return {fe25519::fe_zero(), fe25519::fe_one(), fe25519::fe_one(), fe25519::fe_zero()};
}

// 2d mod p in radix 2^25.5 (ref10's d2).
FE_FN fe d2() {
  return {{-21827239, -5839606, -30745221, 13898782, 229458, 15978800, -12551817,
           -6495438, 29715968, 9444199}};
}

// Unified extended addition add-2008-hwcd-3 with 2d (complete on Ed25519),
// as ops/edwards.py point_add.
FE_FN point point_add(const point& p, const point& q) {
  using namespace fe25519;
  const fe a = fe_mul(fe_sub(p.y, p.x), fe_sub(q.y, q.x));
  const fe b = fe_mul(fe_add(p.y, p.x), fe_add(q.y, q.x));
  const fe c = fe_mul(fe_mul(p.t, d2()), q.t);
  const fe zz = fe_mul(p.z, q.z);
  const fe d = fe_add(zz, zz);
  const fe e = fe_sub(b, a);
  const fe f = fe_sub(d, c);
  const fe g = fe_add(d, c);
  const fe h = fe_add(b, a);
  return {fe_mul(e, f), fe_mul(g, h), fe_mul(f, g), fe_mul(e, h)};
}

// Doubling dbl-2008-hwcd, as ops/edwards.py point_double. 2 Z^2 is carried
// before it enters F = 2 Z^2 + (X^2 - Y^2), which keeps F within three
// carried elements.
FE_FN point point_double(const point& p) {
  using namespace fe25519;
  const fe a = fe_sq(p.x);
  const fe b = fe_sq(p.y);
  const fe zz = fe_sq(p.z);
  const fe c = fe_reduce(fe_add(zz, zz));
  const fe h = fe_add(a, b);
  const fe e = fe_sub(h, fe_sq(fe_add(p.x, p.y)));
  const fe g = fe_sub(a, b);
  const fe f = fe_add(c, g);
  return {fe_mul(e, f), fe_mul(g, h), fe_mul(f, g), fe_mul(e, h)};
}

// -(x, y) = (-x, y); T = xy negates too.
FE_FN point point_neg(const point& p) {
  return {fe25519::fe_neg(p.x), p.y, p.z, fe25519::fe_neg(p.t)};
}

}  // namespace ed25519
