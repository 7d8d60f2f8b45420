"""The CUDA kernels' arithmetic, compiled for the host, against the port's
plain PyTorch versions and Python bigints.

Everything in ``csrc/field25519.cuh``, ``csrc/field25519_coop.cuh`` and
``csrc/edwards25519.cuh`` and the per-lane functions of
``csrc/fused_accumulate.cu``, ``csrc/encode_verdict.cu`` and
``csrc/ladder_verify.cu`` are ``__host__ __device__``: without nvcc the
kernels and launchers drop out and a host C++ compiler builds the rest. A
small harness below drives those functions the way the kernels do (a
lane's positions split over P parts, the pairwise combine tree, the
verdict lane of a group of 5 threads, whose exchanges
``coop::host_group`` emulates in lockstep over arrays with the same phase
functions the card runs between its shuffles) and the results are held
against:

- Python bigints, for the field operations, on edge values (0, 1, p-1,
  p, 2^255-1, limbs at their weak-form maxima) and random ones;
- `madd_loop_plain(parts=P)`, exactly after canonical reduction, for
  P in {1, 2, 4, 8, 16}, in index mode and in wire mode;
- the same at 5- and 6-bit windows (52 and 43 positions, which most P
  do not divide), in dense and packed rows, and `comb_accumulate_plain`
  in comb mode;
- `wire_index_plain`, on edge bytes, at every window width;
- Python bigints, for the group's multiply, square and inversion, and
  the bounds the header argues for (column sums, round-2 carries, the
  result's limbs) on limbs at fe_mul's input bounds, for one multiply and
  for a chain of 254 squarings;
- `encode_and_compare_plain`, verdicts and canonical affine (x, y), with R
  as wire bytes and as the comb path's staged limbs and sign, through the
  group's verdict lane, also on Z = 0, 1, p - 1, p and the weak form's
  maxima;
- `verify_kernel_plain`, for the ladder kernel's lane (decompression,
  256-step ladder, projective comparison): verdicts and canonical affine
  (x, y) of the accumulator, on the smoke's adversarial rows and on
  signed items.

What only the card can show (the shuffles, cp.async, the launch) is in
``chip_smoke.py`` and the tests marked ``cuda``.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from simple_pbft_tpu_torch.crypto import ed25519_cpu as ref
from simple_pbft_tpu_torch.ops import comb
from simple_pbft_tpu_torch.ops import field25519 as fe

CSRC = os.path.join(os.path.dirname(__file__), os.pardir, "simple_pbft_tpu_torch", "csrc")
P = fe.P_INT
RPK = comb.NPOS * comb.FWINDOW

HARNESS = r"""
#include <vector>
#include "fused_accumulate.cu"
#include "encode_verdict.cu"
#include "ladder_verify.cu"

extern "C" void h_field_op(int op, const int32_t* a, const int32_t* b, int32_t* out, int n) {
  using namespace fe25519;
  for (int lane = 0; lane < n; ++lane) {
    int32_t la[17], lb[17], lo[17];
    for (int i = 0; i < 17; ++i) { la[i] = a[i * n + lane]; lb[i] = b[i * n + lane]; }
    const fe x = from15(la);
    fe r = x;
    coop::host_group grp;
    if (op == 0) r = fe_mul(x, from15(lb));
    if (op == 1) r = fe_sq(x);
    if (op == 2) r = fe_invert(x);
    if (op == 4) r = fe_pow22523(x);
    if (op == 5) r = fe_reduce(fe_neg(x));
    if (op >= 6) r = tail::coop_field_op(grp, op, x, from15(lb));
    to15(fe_canonical(r), lo);
    for (int i = 0; i < 17; ++i) out[i * n + lane] = lo[i];
  }
}

// The group's multiply (op 6) or `steps` squarings (op 7) on raw
// radix-2^25.5 limbs, (10, n) limb-major, emulated at G threads. stats
// gets the largest column sum, round-2 carry and limb excess over
// 2^(width - 1) seen at any step.
extern "C" void h_coop_raw(int op, const int32_t* a, const int32_t* b, int steps, int32_t* out,
                           long long* stats, int n) {
  using namespace fe25519;
  coop::host_group grp;
  for (int lane = 0; lane < n; ++lane) {
    fe x, y;
    for (int k = 0; k < 10; ++k) { x.v[k] = a[k * n + lane]; y.v[k] = b[k * n + lane]; }
    coop::host_group::elem r = grp.pick(x);
    for (int s = 0; s < (op == 6 ? 1 : steps); ++s)
      r = op == 6 ? grp.mul(r, grp.pick(y)) : grp.sq(r);
    const fe w = grp.full(r);
    for (int k = 0; k < 10; ++k) out[k * n + lane] = w.v[k];
  }
  stats[0] = grp.max_column;
  stats[1] = grp.max_carry2;
  stats[2] = grp.out_excess;
}

extern "C" int h_accumulate(int mode, int packed, const int32_t* idx, const uint8_t* wire,
                            const int32_t* lane_key, const int32_t* s_win,
                            const int32_t* k_win, const int32_t* table, long long m_rows,
                            const int32_t* b_table, long long m_b_rows, int32_t* out,
                            int npos, int batch, int parts, int wbits) {
  using namespace k1;
  int lp = 0;
  while ((1 << lp) < parts) ++lp;
  const args a{mode, idx, wire, lane_key, s_win, k_win, table, m_rows, b_table, m_b_rows,
               out, npos, batch, lp, wbits};
  const int row = packed ? ROW_PACKED : ROW_DENSE;
  for (int lane = 0; lane < batch; ++lane) {
    const int key = mode == MODE_INDEX ? 0 : lane_key[lane];
    std::vector<point> acc(parts);
    for (int j = 0; j < parts; ++j) {
      acc[j] = identity();
      const int spp = steps_per_pos(a);
      for (int t = spp * ((j * npos) >> lp); t < spp * (((j + 1) * npos) >> lp); ++t) {
        bool inside;
        const int32_t* r = step_row(a, row, lane, key, t, inside);
        if (!inside) return 1;
        if (packed)
          madd_row<ROW_PACKED>(acc[j], r, step_negated(a, t));
        else
          madd_row<ROW_DENSE>(acc[j], r, step_negated(a, t));
      }
    }
    for (int s = 1; s < parts; s <<= 1) {
      std::vector<point> next(parts);
      for (int j = 0; j < parts; ++j) next[j] = point_add(acc[j], acc[j ^ s]);
      acc = next;
    }
    store_point(acc[0], out, batch, lane);
  }
  return 0;
}

extern "C" void h_wire_rows(const uint8_t* wire, const int32_t* a_index, long long* out,
                            int npos, int batch, int wbits) {
  for (int lane = 0; lane < batch; ++lane)
    for (int pos = 0; pos < npos; ++pos)
      out[(long long)pos * batch + lane] =
          k1::wire_row(wire + 96LL * lane, a_index[lane], npos, pos, wbits);
}

extern "C" void h_encode_verdict_limbs(const int32_t* acc, const int32_t* r_y,
                                       const int32_t* r_sign, const uint8_t* pre,
                                       uint8_t* verdict, int32_t* affine, int batch) {
  for (int lane = 0; lane < batch; ++lane) {
    int32_t xo[17], yo[17];
    const tail::lane_src src{acc, nullptr, r_y, r_sign, batch, lane, true};
    coop::host_group grp;
    verdict[lane] = tail::verdict_lane(grp, src, pre[lane] != 0, xo, yo);
    for (int i = 0; i < 17; ++i) {
      affine[i * batch + lane] = xo[i];
      affine[(17 + i) * batch + lane] = yo[i];
    }
  }
}

extern "C" void h_ladder(const int32_t* a_y, const int32_t* a_sign, const int32_t* r_y,
                         const int32_t* r_sign, const int32_t* s_bits, const int32_t* k_bits,
                         const uint8_t* pre, uint8_t* verdict, int32_t* affine, int batch) {
  for (int lane = 0; lane < batch; ++lane) {
    coop::host_group grp;
    const ladder::lane_src src{a_y + lane,   r_y + lane,   s_bits + lane, k_bits + lane,
                               a_sign[lane], r_sign[lane], batch,         true};
    int32_t xo[17], yo[17];
    verdict[lane] = ladder::verify_lane(grp, src, pre[lane] != 0, true, xo, yo);
    for (int i = 0; i < 17; ++i) {
      affine[i * batch + lane] = xo[i];
      affine[(17 + i) * batch + lane] = yo[i];
    }
  }
}

// ladder::point_op through the group, (4*17, n) points in 17 x 15 limbs.
extern "C" void h_point_op(int op, const int32_t* p, const int32_t* q, const int32_t* sign,
                           int32_t* out, int32_t* ok, int n) {
  using namespace fe25519;
  for (int lane = 0; lane < n; ++lane) {
    coop::host_group grp;
    fe a[4], b[4], r[4];
    for (int c = 0; c < 4; ++c) {
      int32_t la[17], lb[17];
      for (int i = 0; i < 17; ++i) {
        la[i] = p[(c * 17 + i) * n + lane];
        lb[i] = q[(c * 17 + i) * n + lane];
      }
      a[c] = from15(la);
      b[c] = from15(lb);
    }
    ok[lane] = ladder::point_op(grp, op, a, b, sign[lane], r);
    for (int c = 0; c < 4; ++c) {
      int32_t lo[17];
      to15(fe_canonical(r[c]), lo);
      for (int i = 0; i < 17; ++i) out[(c * 17 + i) * n + lane] = lo[i];
    }
  }
}

// The ladder's table and 256 steps on raw radix-2^25.5 limbs: Q (4*10, n)
// and the starting accumulator (3*10, n), the bits (256, n); out gets the
// accumulator's raw limbs (3*10, n), stats the group's largest column
// sum, round-2 carry, input excess and output excess over all lanes.
extern "C" void h_ladder_raw(const int32_t* q, const int32_t* acc, const int32_t* s_bits,
                             const int32_t* k_bits, int32_t* out, long long* stats, int n) {
  using E = coop::host_group::elem;
  using fe25519::fe;
  coop::host_group grp;
  for (int lane = 0; lane < n; ++lane) {
    fe f[7];
    for (int c = 0; c < 7; ++c)
      for (int k = 0; k < 10; ++k)
        f[c].v[k] = c < 4 ? q[(c * 10 + k) * n + lane] : acc[((c - 4) * 10 + k) * n + lane];
    const ladder::xyzt<E> qp = {grp.pick(f[0]), grp.pick(f[1]), grp.pick(f[2]), grp.pick(f[3])};
    ladder::cached<E> t[3];
    ladder::table(grp, qp, t);
    E a[3] = {grp.pick(f[4]), grp.pick(f[5]), grp.pick(f[6])};
    const ladder::lane_src src{nullptr, nullptr, s_bits + lane, k_bits + lane, 0, 0, n, true};
    ladder::steps(grp, a, t, src);
    for (int c = 0; c < 3; ++c) {
      const fe w = grp.full(a[c]);
      for (int k = 0; k < 10; ++k) out[(c * 10 + k) * n + lane] = w.v[k];
    }
  }
  stats[0] = grp.max_column;
  stats[1] = grp.max_carry2;
  stats[2] = grp.in_excess;
  stats[3] = grp.out_excess;
}

extern "C" void h_encode_verdict(const int32_t* acc, const uint8_t* wire, const uint8_t* pre,
                                 uint8_t* verdict, int32_t* affine, int batch) {
  for (int lane = 0; lane < batch; ++lane) {
    int32_t xo[17], yo[17];
    const tail::lane_src src{acc, wire, nullptr, nullptr, batch, lane, true};
    coop::host_group grp;
    verdict[lane] = tail::verdict_lane(grp, src, pre[lane] != 0, xo, yo);
    for (int i = 0; i < 17; ++i) {
      affine[i * batch + lane] = xo[i];
      affine[(17 + i) * batch + lane] = yo[i];
    }
  }
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler")
    d = tmp_path_factory.mktemp("csrc_host")
    src = d / "harness.cpp"
    src.write_text(HARNESS)
    so = d / "harness.so"
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-I", CSRC, "-o", str(so),
                    str(src)], check=True, capture_output=True, timeout=300)
    h = ctypes.CDLL(str(so))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    h.h_field_op.argtypes = [ci, vp, vp, vp, ci]
    cl = ctypes.c_longlong
    h.h_accumulate.argtypes = [ci, ci, vp, vp, vp, vp, vp, vp, cl, vp, cl, vp,
                               ci, ci, ci, ci]
    h.h_accumulate.restype = ci
    h.h_wire_rows.argtypes = [vp, vp, vp, ci, ci, ci]
    h.h_encode_verdict.argtypes = [vp, vp, vp, vp, vp, ci]
    h.h_encode_verdict_limbs.argtypes = [vp, vp, vp, vp, vp, vp, ci]
    h.h_ladder.argtypes = [vp] * 9 + [ci]
    h.h_point_op.argtypes = [ci] + [vp] * 5 + [ci]
    h.h_ladder_raw.argtypes = [vp] * 6 + [ci]
    h.h_coop_raw.argtypes = [ci, vp, vp, ci, vp, vp, ci]
    return h


def _ptr(a):
    return None if a is None else a.ctypes.data


def _limbs(vals) -> np.ndarray:
    """ints < 2^255 -> (17, n) int32 15-bit limbs (not reduced mod p)."""
    return np.ascontiguousarray(np.stack([fe._int_to_limbs_np(v) for v in vals], axis=1))


def _value(limbs: np.ndarray, i: int) -> int:
    return sum(int(limbs[k, i]) << (15 * k) for k in range(fe.NLIMB))


def _field_op(lib, op, a, b=None):
    b = a if b is None else b
    out = np.zeros_like(a)
    lib.h_field_op(op, _ptr(a), _ptr(b), _ptr(out), a.shape[1])
    return out


def _edge_operands():
    """Edge values as 15-bit limbs plus weak-form limb patterns at their
    maxima (limb 0 up to 2^15 + 38, the others up to 2^15 + 2^11)."""
    rng = np.random.default_rng(25519)
    vals = [0, 1, 2, 19, P - 1, P, P + 1, P + 18, 2**255 - 1, 2**254, 2**255 - 20]
    vals += [int.from_bytes(bytes(r), "little") % 2**255
             for r in rng.integers(0, 256, (21, 32), dtype=np.uint8)]
    a = _limbs(vals)
    weak = rng.integers(0, (1 << 15) + (1 << 11), (17, 16), dtype=np.int32)
    weak[0] = rng.integers(0, (1 << 15) + 39, 16, dtype=np.int32)
    top = np.full((17, 2), (1 << 15) + (1 << 11) - 1, np.int32)
    top[0] = (1 << 15) + 38
    top[:, 1] = (1 << 15) - 1  # every limb all ones
    return np.ascontiguousarray(np.concatenate([a, weak, top], axis=1))


@pytest.mark.parametrize("op", ["mul", "sq", "invert", "canonical", "pow22523", "neg"])
def test_header_field_ops_match_bigints(lib, op):
    a = _edge_operands()
    b = np.ascontiguousarray(a[:, ::-1])
    code = {"mul": 0, "sq": 1, "invert": 2, "canonical": 3, "pow22523": 4, "neg": 5}[op]
    out = _field_op(lib, code, a, b)
    assert out.min() >= 0 and out.max() <= fe.MASK
    for i in range(a.shape[1]):
        x, y = _value(a, i), _value(b, i)
        want = {"mul": x * y, "sq": x * x, "invert": pow(x, P - 2, P), "canonical": x,
                "pow22523": pow(x, 2**252 - 3, P), "neg": -x}[op] % P
        assert _value(out, i) == want, (op, i)


def test_header_mul_matches_plain_field(lib):
    """Against the port's own field on weak-form inputs: the same value,
    canonical limbs equal."""
    a = _edge_operands()
    b = np.ascontiguousarray(np.roll(a, 3, axis=1))
    want = fe.to_canonical(fe.mul(torch.from_numpy(a), torch.from_numpy(b))).numpy()
    np.testing.assert_array_equal(_field_op(lib, 0, a, b), want)


@pytest.mark.parametrize("op", ["coop_mul", "coop_sq", "coop_invert", "coop_pow22523"])
def test_coop_field_ops_match_bigints(lib, op):
    """csrc/field25519_coop.cuh's multiply, square, inversion and
    pow22523, emulated at G = 5 threads through the phase functions the
    card runs, on edge values and weak-form limbs at their maxima."""
    a = _edge_operands()
    b = np.ascontiguousarray(a[:, ::-1])
    out = _field_op(lib, comb.EncodeVerdictKernel.FIELD_OPS[op], a, b)
    assert out.min() >= 0 and out.max() <= fe.MASK
    for i in range(a.shape[1]):
        x, y = _value(a, i), _value(b, i)
        want = {"coop_mul": x * y, "coop_sq": x * x, "coop_invert": pow(x, P - 2, P),
                "coop_pow22523": pow(x, 2**252 - 3, P)}[op] % P
        assert _value(out, i) == want, (op, i)


# radix 2^25.5: limb k at bit OFF[k]; fe_mul's input bounds 1.65 * 2^26
# (even k) and 1.65 * 2^25 (odd k)
OFF = [(51 * k + 1) // 2 for k in range(11)]
WIDTH = [OFF[k + 1] - OFF[k] for k in range(10)]
IN_BOUND = [int(1.65 * 2 ** (w)) for w in WIDTH]


def _extreme_raw_limbs() -> np.ndarray:
    """(10, n) signed radix-2^25.5 limbs at the input bounds' extremes:
    all at +bound, all at -bound, alternating signs both ways, and seeded
    random signs and values within the bounds."""
    rng = np.random.default_rng(2552)
    bound = np.array(IN_BOUND, np.int64)[:, None]
    signs = [np.ones((10, 1)), -np.ones((10, 1)), np.array([[1, -1] * 5]).T,
             np.array([[-1, 1] * 5]).T, rng.choice([-1, 1], (10, 4))]
    cols = [bound * sg for sg in signs]
    cols.append(rng.integers(-bound, bound + 1, (10, 4)))
    return np.ascontiguousarray(np.concatenate(cols, axis=1).astype(np.int32))


def _bound_argument():
    """The header's bound argument, computed from IN_BOUND: the largest
    column sum, round-2 carry (between threads) and result limb excess
    over 2^(w-1) a multiply of inputs within the bounds can give."""
    cols = []
    for c in range(10):
        s = 0
        for i in range(10):
            n = (c - i) % 10
            s += (2 if i & n & 1 else 1) * (19 if i + n >= 10 else 1) * IN_BOUND[i] * IN_BOUND[n]
        cols.append(s)
    c1 = [(cols[k] + 2 ** (WIDTH[k] - 1)) >> WIDTH[k] for k in range(10)]
    h1 = [2 ** (WIDTH[k] - 1) + (19 * c1[9] if k == 0 else c1[k - 1]) for k in range(10)]
    c2 = [(h1[k] + 2 ** (WIDTH[k] - 1)) >> WIDTH[k] for k in range(10)]
    excess = max([19 * c2[9]] + c2[:9])
    return max(cols), max(c2[1::2]), excess


def _raw_value(limbs: np.ndarray, i: int) -> int:
    return sum(int(limbs[k, i]) << OFF[k] for k in range(10)) % P


def _coop_raw(lib, op, a, b, steps=1):
    out = np.zeros_like(a)
    stats = np.zeros(3, np.int64)
    lib.h_coop_raw(op, _ptr(a), _ptr(b), steps, _ptr(out), _ptr(stats), a.shape[1])
    return out, stats


def test_coop_mul_at_input_bounds(lib):
    """The group's multiply on operands at fe_mul's input bounds: the
    product mod p, column sums under 2^60.41, round 2's carries within
    int32 (at most 679) and the result's limbs within 2^(w-1) + 1729, as
    the header's bound argument says."""
    a = _extreme_raw_limbs()
    b = np.ascontiguousarray(np.roll(a, 1, axis=1))
    out, (max_column, max_carry2, excess) = _coop_raw(lib, 6, a, b)
    for i in range(a.shape[1]):
        assert _raw_value(out, i) == _raw_value(a, i) * _raw_value(b, i) % P, i
    column_bound, carry_bound, excess_bound = _bound_argument()
    assert max_column <= column_bound < 2 ** 60.41
    assert max_carry2 <= carry_bound <= 679 and excess <= excess_bound <= 1729


def test_coop_square_chain_from_extreme_limbs(lib):
    """254 squarings in a row, the inversion chain's length, from limbs
    at the input bounds' extremes: every step's output is a valid input to
    the next (its limbs and round-2 carries stay inside the bounds) and
    the end is x^(2^254) mod p."""
    a = _extreme_raw_limbs()
    out, (max_column, max_carry2, excess) = _coop_raw(lib, 7, a, a, steps=254)
    for i in range(a.shape[1]):
        assert _raw_value(out, i) == pow(_raw_value(a, i), 2 ** 254, P), i
    column_bound, carry_bound, excess_bound = _bound_argument()
    assert max_column <= column_bound
    assert max_carry2 <= carry_bound and excess <= excess_bound


@pytest.fixture(scope="module")
def tables():
    pts = [ref.point_decompress(ref.public_key(bytes([i + 1]) * 32)) for i in range(3)]
    return np.ascontiguousarray(np.concatenate([comb.fused_table_np(p, 4) for p in pts]))


def _wire(seed: int, batch: int):
    rng = np.random.default_rng(seed)
    wire = rng.integers(0, 256, (batch, 96), dtype=np.uint8)
    wire[0, :64] = 0x00
    wire[1, :64] = 0xFF
    wire[2, :64] = 0x80
    a_index = rng.integers(0, 3, batch).astype(np.int32)
    return np.ascontiguousarray(wire), a_index


def _accumulate(lib, mode, table, out, npos, batch, parts, wbits, idx=None, wire=None,
                lane_key=None, s_win=None, k_win=None, b_table=None):
    """The harness's K1 loop: mode 0 index, 1 wire, 2 comb; the layout is
    the table's width."""
    return lib.h_accumulate(
        mode, int(table.shape[1] == comb.ROW_PACKED), _ptr(idx), _ptr(wire), _ptr(lane_key),
        _ptr(s_win), _ptr(k_win), _ptr(table), table.shape[0], _ptr(b_table),
        0 if b_table is None else b_table.shape[0], _ptr(out), npos, batch, parts, wbits)


def _canonical_point(p: torch.Tensor) -> torch.Tensor:
    """(4, 17, ...) -> the same with every coordinate canonical."""
    return fe.to_canonical(p.transpose(0, 1)).transpose(0, 1)


@pytest.mark.parametrize("parts", [1, 2, 4, 8, 16])
def test_split_accumulate_equals_plain(lib, tables, parts):
    batch = 8
    wire, a_index = _wire(parts, batch)
    idx = comb.wire_index_plain(torch.from_numpy(wire), torch.from_numpy(a_index)).numpy()
    want = _canonical_point(comb.madd_loop_plain(
        torch.from_numpy(idx), torch.from_numpy(tables), parts=parts)).numpy()
    for mode in ("index", "wire"):
        out = np.zeros((4 * fe.NLIMB, batch), np.int32)
        idx_c = np.ascontiguousarray(idx)
        if mode == "index":
            rc = _accumulate(lib, 0, tables, out, comb.NPOS, batch, parts, 4, idx=idx_c)
        else:
            rc = _accumulate(lib, 1, tables, out, comb.NPOS, batch, parts, 4, wire=wire,
                             lane_key=a_index)
        assert rc == 0
        np.testing.assert_array_equal(out.reshape(4, fe.NLIMB, batch), want, err_msg=mode)


def test_wire_rows_equal_plain_index(lib):
    wire, a_index = _wire(3, 32)
    wire[3, :64] = 0x0F
    wire[4, :64] = 0xF0
    want = comb.wire_index_plain(torch.from_numpy(wire), torch.from_numpy(a_index)).numpy()
    out = np.zeros((comb.NPOS, 32), np.int64)
    lib.h_wire_rows(_ptr(wire), _ptr(a_index), _ptr(out), comb.NPOS, 32, 4)
    np.testing.assert_array_equal(out, want)


def _signed_batch(batch: int, tables):
    """Honest, corrupted and precheck-false lanes -> (acc, wire, pre)."""
    seeds = [bytes([i + 1]) * 32 for i in range(3)]
    rows, keys = [], []
    for j in range(batch):
        key = j % 3
        msg = b"host %d" % j
        sig = bytearray(ref.sign(seeds[key], msg))
        if j % 5 == 1:
            sig[2] ^= 4  # corrupt R.y
        if j % 5 == 2:
            sig[31] ^= 0x80  # flip R's sign bit
        k = ref.challenge_scalar(bytes(sig[:32]), ref.public_key(seeds[key]), msg)
        rows.append(bytes(sig[32:]) + k.to_bytes(32, "little") + bytes(sig[:32]))
        keys.append(key)
    wire = np.frombuffer(b"".join(rows), np.uint8).reshape(batch, 96).copy()
    a_index = np.array(keys, np.int32)
    pre = np.ones(batch, bool)
    pre[3] = False
    acc = comb.fused_accumulate_wire(torch.from_numpy(wire), torch.from_numpy(a_index),
                                     torch.from_numpy(tables))
    return acc, wire, pre


def test_verdict_lane_equals_plain(lib, tables):
    batch = 8
    acc, wire, pre = _signed_batch(batch, tables)
    want_ok, want_xy = comb.encode_and_compare_plain(
        acc, *comb.r_from_wire(torch.from_numpy(wire)), torch.from_numpy(pre), affine=True)
    acc_np = np.ascontiguousarray(acc.numpy().reshape(4 * fe.NLIMB, batch))
    pre_u8 = pre.astype(np.uint8)
    verdict = np.zeros(batch, np.uint8)
    xy = np.zeros((2 * fe.NLIMB, batch), np.int32)
    lib.h_encode_verdict(_ptr(acc_np), _ptr(wire), _ptr(pre_u8), _ptr(verdict), _ptr(xy), batch)
    assert verdict.astype(bool).tolist() == want_ok.tolist()
    assert want_ok.tolist() == [True, False, False, False, True, True, False, False]
    np.testing.assert_array_equal(xy, want_xy.numpy())


CONFIGS = [("fused", w, name) for w in (4, 5, 6) for name in ("dense", "packed")]
CONFIGS.append(("comb", 4, "dense"))


@pytest.mark.parametrize("parts", [1, 4, 16])
@pytest.mark.parametrize("mode,wbits,name", CONFIGS)
def test_every_configuration_equals_plain(lib, mode, wbits, name, parts):
    """The kernel's per-lane loop in every configuration, with the split
    over P threads, against the plain version with the same P."""
    batch = 8
    pts = [ref.point_decompress(ref.public_key(bytes([i + 1]) * 32)) for i in range(2)]
    comb.use_row_packing(name == "packed")
    try:
        out = np.zeros((4 * fe.NLIMB, batch), np.int32)
        if mode == "comb":
            a_flat = np.ascontiguousarray(np.concatenate([comb.comb_table_np(p) for p in pts]))
            b_flat = np.ascontiguousarray(comb.base_table())
            rng = np.random.default_rng(parts)
            s_w = rng.integers(0, 16, (comb.NPOS, batch), dtype=np.int32)
            k_w = rng.integers(0, 16, (comb.NPOS, batch), dtype=np.int32)
            s_w[:, 0], k_w[:, 1] = 15, 15
            base = (rng.integers(0, 2, batch) * comb.NPOS * comb.WINDOW).astype(np.int32)
            want = comb.comb_accumulate_plain(
                *[torch.from_numpy(x) for x in (s_w, k_w, base, a_flat, b_flat)], parts=parts)
            rc = _accumulate(lib, 2, a_flat, out, comb.NPOS, batch, parts, 4, s_win=s_w,
                             k_win=k_w, lane_key=base, b_table=b_flat)
            assert rc == 0
            np.testing.assert_array_equal(out.reshape(4, fe.NLIMB, batch),
                                          _canonical_point(want).numpy())
            return
        table = np.ascontiguousarray(np.concatenate([comb.fused_table_np(p, wbits) for p in pts]))
        npos = comb.npos_for(wbits)
        wire, a_index = _wire(parts + wbits, batch)
        a_index %= 2
        idx = comb.wire_index_plain(torch.from_numpy(wire), torch.from_numpy(a_index),
                                    1 << wbits)
        want = _canonical_point(comb.madd_loop_plain(
            idx, torch.from_numpy(table), parts=parts)).numpy()
        idx_c = np.ascontiguousarray(idx.numpy())
        assert _accumulate(lib, 0, table, out, npos, batch, parts, wbits, idx=idx_c) == 0
        np.testing.assert_array_equal(out.reshape(4, fe.NLIMB, batch), want, err_msg="index")
        out[:] = 0
        assert _accumulate(lib, 1, table, out, npos, batch, parts, wbits, wire=wire,
                           lane_key=a_index) == 0
        np.testing.assert_array_equal(out.reshape(4, fe.NLIMB, batch), want, err_msg="wire")
    finally:
        comb.use_row_packing(False)


def test_row_outside_its_table_is_refused(lib, tables):
    """A row index past the bank is reported (the kernel traps on it)."""
    out = np.zeros((4 * fe.NLIMB, 8), np.int32)
    idx = np.zeros((comb.NPOS, 8), np.int32)
    idx[5, 3] = tables.shape[0]
    assert _accumulate(lib, 0, tables, out, comb.NPOS, 8, 1, 4, idx=idx) == 1


@pytest.mark.parametrize("wbits", [4, 5, 6])
def test_wire_rows_every_window_equal_plain(lib, wbits):
    """Rows from the wire bytes at every width; lanes whose S and k are all
    ones put 0xff in byte 32 of S (k's first byte) and of k (R's): the top
    window must stop at bit 255."""
    wire, a_index = _wire(40 + wbits, 32)
    wire[3, :64] = 0xFF
    wire[4, :64] = 0xF0
    wire[5, 32:64] = 0x00
    wire[5, 31] = 0x80
    npos = comb.npos_for(wbits)
    want = comb.wire_index_plain(torch.from_numpy(wire), torch.from_numpy(a_index),
                                 1 << wbits).numpy()
    out = np.zeros((npos, 32), np.int64)
    lib.h_wire_rows(_ptr(wire), _ptr(a_index), _ptr(out), npos, 32, wbits)
    np.testing.assert_array_equal(out, want)
    fw = 1 << 2 * wbits
    top = (1 << (256 - wbits * (npos - 1))) - 1
    assert out[npos - 1, 3] % fw == top * (1 << wbits) + top


def test_verdict_limbs_lane_equals_plain(lib, tables):
    """The comb path's lane: R.y as 17 x 15 limbs and its sign."""
    batch = 8
    acc, wire, pre = _signed_batch(batch, tables)
    r_y, r_sign = comb.r_from_wire(torch.from_numpy(wire))
    want_ok, want_xy = comb.encode_and_compare_plain(acc, r_y, r_sign, torch.from_numpy(pre),
                                                     affine=True)
    acc_np = np.ascontiguousarray(acc.numpy().reshape(4 * fe.NLIMB, batch))
    verdict = np.zeros(batch, np.uint8)
    xy = np.zeros((2 * fe.NLIMB, batch), np.int32)
    lib.h_encode_verdict_limbs(_ptr(acc_np), _ptr(np.ascontiguousarray(r_y.numpy())),
                               _ptr(np.ascontiguousarray(r_sign.numpy())),
                               _ptr(pre.astype(np.uint8)), _ptr(verdict), _ptr(xy), batch)
    assert verdict.astype(bool).tolist() == want_ok.tolist()
    assert want_ok.tolist() == [True, False, False, False, True, True, False, False]
    np.testing.assert_array_equal(xy, want_xy.numpy())



@pytest.mark.parametrize("entry", ["wire", "limbs"])
def test_coop_verdict_lane_edge_accumulators(lib, entry):
    """The group's verdict lane, both entries, against
    encode_and_compare_plain on accumulators the main path does not make:
    Z = 0 (the inversion's 0 -> 0), Z = 1 (the filler of a lane past the
    batch), Z = p - 1 and p, and X, Y, Z at the weak form's maxima, with
    every other lane's R its own point's encoding."""
    batch = 12
    rng = np.random.default_rng(7 if entry == "wire" else 8)
    acc = rng.integers(0, (1 << 15) + (1 << 11), (4, fe.NLIMB, batch), dtype=np.int32)
    acc[:, 0] = rng.integers(0, (1 << 15) + 39, (4, batch), dtype=np.int32)
    for lane, z in enumerate([0, 1, P - 1, P]):
        acc[2, :, lane] = fe._int_to_limbs_np(z)
    acc[:3, :, 4] = (1 << 15) + (1 << 11) - 1
    acc[:3, 0, 4] = (1 << 15) + 38
    p = torch.from_numpy(acc)
    pre = torch.from_numpy(rng.random(batch) < 0.8)
    pre[0::2] = True
    r_y = torch.from_numpy(rng.integers(0, 1 << 15, (fe.NLIMB, batch), dtype=np.int32))
    r_sign = torch.from_numpy(rng.integers(0, 2, batch).astype(np.int32))
    _, xy = comb.encode_and_compare_plain(p, r_y, r_sign, pre, affine=True)
    r_y[:, 0::2] = xy[fe.NLIMB:, 0::2]
    r_sign[0::2] = xy[0, 0::2] & 1
    want_ok, want_xy = comb.encode_and_compare_plain(p, r_y, r_sign, pre, affine=True)
    assert want_ok[0::2].all()
    acc_np = np.ascontiguousarray(acc.reshape(4 * fe.NLIMB, batch))
    verdict = np.zeros(batch, np.uint8)
    got_xy = np.zeros((2 * fe.NLIMB, batch), np.int32)
    pre_u8 = pre.numpy().astype(np.uint8)
    if entry == "wire":
        wire = np.zeros((batch, 96), np.uint8)
        for lane in range(batch):
            y = fe._limbs_to_int_np(r_y[:, lane:lane + 1].numpy())
            wire[lane, 64:] = np.frombuffer((y | int(r_sign[lane]) << 255).to_bytes(32, "little"),
                                            np.uint8)
        lib.h_encode_verdict(_ptr(acc_np), _ptr(wire), _ptr(pre_u8), _ptr(verdict),
                             _ptr(got_xy), batch)
    else:
        lib.h_encode_verdict_limbs(_ptr(acc_np), _ptr(np.ascontiguousarray(r_y.numpy())),
                                   _ptr(np.ascontiguousarray(r_sign.numpy())), _ptr(pre_u8),
                                   _ptr(verdict), _ptr(got_xy), batch)
    assert verdict.astype(bool).tolist() == want_ok.tolist()
    np.testing.assert_array_equal(got_xy, want_xy.numpy())


def test_ladder_lane_equals_plain(lib):
    """The ladder kernel's lane, compiled for the host, against
    verify_kernel_plain on the 8 adversarial rows of crypto/adversarial.py and 8 signed
    items (one corrupted in four): the same verdicts and, exactly, the same
    canonical affine (x, y) of [S]B + [k](-A), also where A is no point."""
    from simple_pbft_tpu_torch.crypto import gpu_verifier as gv
    from simple_pbft_tpu_torch.crypto.adversarial import ladder_adversarial_items
    from simple_pbft_tpu_torch.crypto.verifier import BatchItem

    items = [it for _, it in ladder_adversarial_items()]
    for j in range(8):
        seed, msg = bytes([j + 1]) * 32, b"host ladder %d" % j
        sig = bytearray(ref.sign(seed, msg))
        if j % 4 == 3:
            sig[40] ^= 8
        items.append(BatchItem(ref.public_key(seed), msg, bytes(sig)))
    arrays = [np.ascontiguousarray(a) for a in gv.prepare_batch(items).arrays()]
    batch = len(items)
    verdict = np.zeros(batch, np.uint8)
    xy = np.zeros((2 * fe.NLIMB, batch), np.int32)
    lib.h_ladder(*[_ptr(a) for a in arrays[:6]], _ptr(arrays[6].astype(np.uint8)),
                 _ptr(verdict), _ptr(xy), batch)
    want_ok, want_xy = gv.verify_kernel_plain(*[torch.from_numpy(a) for a in arrays],
                                              affine=True)
    assert verdict.astype(bool).tolist() == want_ok.tolist()
    assert want_ok.tolist() == [ref.verify(i.pubkey, i.msg, i.sig) for i in items]
    assert sum(want_ok.tolist()) == 8  # two adversarial rows and six signed
    np.testing.assert_array_equal(xy, want_xy.numpy())


def _point_op(lib, op, p, q=None, sign=None):
    n = p.shape[1]
    q = p if q is None else q
    sign = np.zeros(n, np.int32) if sign is None else sign
    out = np.zeros_like(p)
    ok = np.zeros(n, np.int32)
    lib.h_point_op({"double": 0, "add": 1, "decompress": 2}[op], _ptr(p), _ptr(q), _ptr(sign),
                   _ptr(out), _ptr(ok), n)
    return out.reshape(4, fe.NLIMB, n), ok.astype(bool)


def _points(seed: int, n: int) -> np.ndarray:
    """(4·17, n) limbs: curve points (multiples of B in extended form, Z
    not 1) first, then random field elements in every coordinate, as the
    ladder meets on lanes whose A is no point; the last column at the
    weak form's maxima."""
    rng = np.random.default_rng(seed)
    cols = []
    for i in range(n):
        if i < n // 2:
            x, y, z, t = ref.point_mul(i + 2, ref.B)
            z2 = int(rng.integers(2, 1 << 62))
            pt = [c * z2 % P for c in (x, y, z, t)]
        else:
            pt = [int.from_bytes(bytes(r), "little") % 2**255
                  for r in rng.integers(0, 256, (4, 32), dtype=np.uint8)]
        cols.append(np.concatenate([fe._int_to_limbs_np(c) for c in pt]))
    out = np.stack(cols, axis=1).astype(np.int32)
    top = np.full((4, fe.NLIMB), (1 << 15) + (1 << 11) - 1, np.int32)
    top[:, 0] = (1 << 15) + 38
    out[:, -1] = top.reshape(-1)
    return np.ascontiguousarray(out)


@pytest.mark.parametrize("op", ["double", "add"])
def test_coop_point_ops_equal_plain(lib, op):
    """The ladder kernel's doubling and its addition of a cached addend
    ((Y - X, Y + X, Z, 2d T), C = T1 (2d T2)), through the group's shares,
    against ops/edwards.py point_double / point_add after canonical
    reduction: X, Y, Z and T, on curve points and on random elements."""
    from simple_pbft_tpu_torch.ops import edwards as ed

    n = 12
    p = _points(31, n)
    q = np.ascontiguousarray(np.roll(_points(32, n), 3, axis=1))
    got, _ = _point_op(lib, op, p, q)
    pt, qt = torch.from_numpy(p.reshape(4, fe.NLIMB, n)), torch.from_numpy(q.reshape(4, fe.NLIMB, n))
    want = ed.point_double(pt) if op == "double" else ed.point_add(pt, qt)
    np.testing.assert_array_equal(got, _canonical_point(want).numpy())


def test_coop_decompress_edge_values_equal_plain(lib):
    """The group's decompression (coop_pow22523, the ok flags decided on
    gathered values, sqrt(-1) and the sign by selects) against
    ops/edwards.py decompress: y = 0, 1, p - 1, a non-residue, x = 0 with
    sign 1, keys' y with both signs and random y; the point (x, y, 1, xy)
    and ok."""
    from simple_pbft_tpu_torch.ops import edwards as ed

    non_residue = next(y for y in range(2, 64) if ref._recover_x(y, 0) is None)
    keys = [ref.point_to_affine(ref.point_mul(i + 3, ref.B))[1] for i in range(3)]
    rng = np.random.default_rng(5)
    rand = [int.from_bytes(bytes(r), "little") % P for r in rng.integers(0, 256, (4, 32),
                                                                           dtype=np.uint8)]
    rows = [(0, 0), (0, 1), (1, 0), (1, 1), (P - 1, 0), (P - 1, 1), (non_residue, 0),
            (non_residue, 1)] + [(y, s) for y in keys for s in (0, 1)] + [(y, 0) for y in rand]
    n = len(rows)
    p = np.zeros((4, fe.NLIMB, n), np.int32)
    p[1] = _limbs([y for y, _ in rows])
    p = np.ascontiguousarray(p.reshape(4 * fe.NLIMB, n))
    sign = np.array([s for _, s in rows], np.int32)
    got, ok = _point_op(lib, "decompress", p, sign=sign)
    want, want_ok = ed.decompress(torch.from_numpy(p[fe.NLIMB:2 * fe.NLIMB]),
                                  torch.from_numpy(sign))
    assert ok.tolist() == want_ok.tolist()
    assert want_ok.tolist()[:8] == [True, True, True, False, True, False, False, False]
    assert all(want_ok.tolist()[8:14])
    np.testing.assert_array_equal(got, _canonical_point(want).numpy())


# a coop multiply's output limbs: within 2^(w - 1) + 1729 (the header's bound)
OUT_BOUND = [2 ** (w - 1) + 1729 for w in WIDTH]


def _ladder_bigint(q, acc, s_bits, k_bits):
    """The plain ladder's formulas on integers mod p from any (X, Y, Z, T)
    Q and starting (X, Y, Z): the table {identity, B, Q, B + Q}, 256
    doublings and additions."""
    table = [ref.IDENTITY, ref.B, q, ref.point_add(ref.B, q)]
    acc = tuple(acc) + (0,)
    for i in range(256):
        acc = ref.point_add(ref.point_double(acc), table[s_bits[i] + 2 * k_bits[i]])
    return acc[:3]


def test_coop_ladder_from_extreme_limbs_within_bounds(lib):
    """The ladder kernel's table and all 256 steps through the group, with
    Q and the starting accumulator at the extremes of a multiply's output
    (every limb at +-(2^(w-1) + 1729) in several sign patterns, and random
    limbs within it): every multiply's inputs stay within fe_mul's input
    bounds, its column sums and round-2 carries within the header's
    bounds, its outputs within 2^(w-1) + 1729, and the result equals the
    plain formulas mod p."""
    rng = np.random.default_rng(9)
    bound = np.array(OUT_BOUND, np.int64)[:, None]
    signs = [np.ones((10, 1)), -np.ones((10, 1)), np.array([[1, -1] * 5]).T,
             np.array([[-1, 1] * 5]).T]
    cols = [bound * sg for sg in signs] + [bound * rng.choice([-1, 1], (10, 3)),
                                           rng.integers(-bound, bound + 1, (10, 3))]
    ext = np.concatenate(cols, axis=1).astype(np.int32)
    n = ext.shape[1]
    q = np.ascontiguousarray(np.concatenate([np.roll(ext, c, axis=1) for c in range(4)]))
    acc = np.ascontiguousarray(np.concatenate([np.roll(ext, -c - 1, axis=1) for c in range(3)]))
    s_bits = rng.integers(0, 2, (256, n), dtype=np.int32)
    k_bits = rng.integers(0, 2, (256, n), dtype=np.int32)
    s_bits[:4, 0], k_bits[:4, 0] = [0, 1, 0, 1], [0, 0, 1, 1]
    out = np.zeros((30, n), np.int32)
    stats = np.zeros(4, np.int64)
    lib.h_ladder_raw(_ptr(q), _ptr(acc), _ptr(s_bits), _ptr(k_bits), _ptr(out), _ptr(stats), n)
    max_column, max_carry2, in_excess, out_excess = stats.tolist()
    column_bound, carry_bound, excess_bound = _bound_argument()
    assert in_excess <= 0, "a multiply input exceeds fe_mul's bounds"
    assert max_column <= column_bound and max_carry2 <= carry_bound
    assert out_excess <= excess_bound <= 1729
    for i in range(n):
        qv = [_raw_value(q[10 * c:10 * c + 10], i) for c in range(4)]
        av = [_raw_value(acc[10 * c:10 * c + 10], i) for c in range(3)]
        want = _ladder_bigint(qv, av, s_bits[:, i].tolist(), k_bits[:, i].tolist())
        assert [_raw_value(out[10 * c:10 * c + 10], i) for c in range(3)] == list(want), i
