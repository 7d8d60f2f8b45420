// Comb accumulation of Ed25519 verification: [S]B + [k](-A) for a batch of
// signatures, as ref10 mixed additions of rows read from comb tables.
//
// Replaces: the Pallas kernel simple_pbft_tpu/ops/comb.py:452-491
// (_madd_loop_kernel / _madd_loop_pallas) in every configuration the JAX
// package ships (4-, 5- and 6-bit windows, dense or packed rows), and the
// XLA loop of the comb mode (comb_accumulate, comb.py:355-378); it folds in
// what fed them: the row gather and its index math (_gather_rows and
// fused_accumulate, comb.py:342-352, :381-413), the rows' unpacking
// (_row_niels / _unpack_element, :256-276) and negation (negate_rows,
// :279-295) and, in wire mode, the scalar-window extraction (field25519.py
// extract_windows_dev). Rows are read straight from the table bank; no
// staging tensor is built.
//
// Contract (plain PyTorch versions: ops/comb.py madd_loop_plain and
// comb_accumulate_plain, with the same `parts`, and wire_index_plain for
// wire mode):
//   index mode: idx (npos, B) int32, idx[pos, lane] = row of `table`
//   wire mode:  wire (B, 96) uint8 = S || k || R, lane_key (B,) int32 key
//               index; with w = wbits (4, 5 or 6), npos = ceil(256 / w):
//               row = key * npos * 4^w + pos * 4^w + s * 2^w + k, s and k
//               the w-bit windows of S and k at bits [pos w, pos w + w),
//               the top one cut at bit 255
//   comb mode:  s_win, k_win (64, B) int32 nibbles, lane_key (B,) int32
//               key row base (key * 1024); at each position two rows and
//               two mixed adds: b_table's row pos * 16 + s, then table's
//               row base + pos * 16 + k, negated
//   table, b_table (M, ROW) int32 Niels rows [y+x | y-x | 2dxy | pad] in
//               canonical 17 x 15 limbs: dense (ROW = 64, a limb a word)
//               or packed (ROW = 32, limbs 2i and 2i+1 in one word as
//               lo | hi << 15, limb 16 alone: 9 words an element)
//   out         (4*17, B) int32 extended X, Y, Z, T as canonical 17 x 15
//               limbs
//
// Work split: the P = 2^log2_parts threads of a lane sit in adjacent lanes
// of one warp. Thread j accumulates positions [floor(j npos / P),
// floor((j+1) npos / P)) from the identity (when P does not divide npos,
// threads differ by one position); the P partial sums then combine
// pairwise in a fixed tree, (0+1), (2+3), ... then level by level, with the
// complete extended addition (point_add), exchanging coordinates through
// __shfl_xor_sync. The result is the same point as the sequential loop's,
// in another projective representation, and equal after canonical
// reduction to the plain version run with the same P (the same formulas in
// the same order).
//
// Prefetch: each thread copies the next step's row (13 x 16 B dense, 7 x
// 16 B packed) into its own slot of a double-buffered shared-memory ring
// with cp.async before it computes the current step, so the gather's
// latency is off the chain and the copy costs no registers. A packed row's
// limb pairs are split in registers before the radix conversion.
//
// What bounds it on an H100, per lane and mixed add: 7 field multiplies of
// 100 wide products, and one row of 204 payload bytes dense or 108 packed.
// At B = 8192 and w = 4 (64 adds a lane) the multiplies take 0.022 ms at 64
// issues per SM per clock on 132 SMs at 1.98 GHz, and the rows, if all
// distinct, 0.032 ms at 3.35 TB/s dense or 0.017 ms packed; wider windows
// cut the adds (52, 43) but spread the same batch over more distinct rows
// of bigger tables; the comb mode does 128 adds. What the design does about
// it: the radix-2^25.5 field (field25519.cuh) cuts a multiply's
// instructions about sixfold against the 17 x 15 form; the split over P
// threads shortens each thread's dependent chain from npos mixed adds to
// npos/P plus log2 P additions, and puts P times as many warps on the
// schedulers.

#include "edwards25519.cuh"

namespace k1 {

using fe25519::fe;

constexpr int NL = 17;
constexpr int ROW_DENSE = 64;    // int32 words of a dense row
constexpr int ROW_PACKED = 32;   // int32 words of a packed row
constexpr int PACKED_WORDS = 9;  // words of one packed element
constexpr int WIRE = 96;         // bytes per wire row: S || k || R
constexpr int MODE_INDEX = 0, MODE_WIRE = 1, MODE_COMB = 2;

// 16-byte pieces covering a row's payload: 51 words dense, 27 packed.
template <int ROW>
constexpr int ROW_VEC = ROW == ROW_DENSE ? 13 : 7;

using ed25519::identity;
using ed25519::point;
using ed25519::point_add;

// ref10 ge_madd: p += the affine Niels point (y+x, y-x, 2dxy).
FE_FN void madd(point& p, const fe& ypx, const fe& ymx, const fe& xy2d) {
  using namespace fe25519;
  const fe a = fe_mul(fe_add(p.y, p.x), ypx);
  const fe b = fe_mul(fe_sub(p.y, p.x), ymx);
  const fe c = fe_mul(xy2d, p.t);
  const fe d = fe_add(p.z, p.z);
  const fe e = fe_sub(a, b);
  const fe f = fe_sub(d, c);
  const fe g = fe_add(d, c);
  const fe h = fe_add(a, b);
  p.x = fe_mul(e, f);
  p.y = fe_mul(g, h);
  p.z = fe_mul(f, g);
  p.t = fe_mul(e, h);
}

// One packed element (9 words) -> its field element.
FE_FN fe from_packed(const int32_t w[PACKED_WORDS]) {
  int32_t l[NL];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    l[2 * i] = w[i] & fe25519::MASK15;
    l[2 * i + 1] = (w[i] >> 15) & fe25519::MASK15;
  }
  l[16] = w[8];
  return fe25519::from15(l);
}

// One table row's payload words -> its three field elements, then the add;
// `negate` adds the negated point (y+x and y-x swapped, 2dxy negated).
template <int ROW>
FE_FN void madd_row(point& p, const int32_t* w, bool negate) {
  using namespace fe25519;
  fe ypx, ymx, xy2d;
  if constexpr (ROW == ROW_PACKED) {
    ypx = from_packed(w);
    ymx = from_packed(w + PACKED_WORDS);
    xy2d = from_packed(w + 2 * PACKED_WORDS);
  } else {
    ypx = from15(w);
    ymx = from15(w + NL);
    xy2d = from15(w + 2 * NL);
  }
  if (negate) {
    const fe swap = ypx;
    ypx = ymx;
    ymx = swap;
    xy2d = fe_sub(fe_zero(), xy2d);
  }
  madd(p, ypx, ymx, xy2d);
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

// The w-bit window at position pos of a little-endian 32-byte scalar: bits
// [pos w, pos w + w), cut at bit 255. For w <= 6 it lies in at most two
// bytes; the byte past the scalar (the next field's first) is never read.
FE_FN int scalar_window(const uint8_t* scalar, int pos, int wbits) {
  const int bit = pos * wbits, byte = bit >> 3;
  unsigned v = ld(scalar + byte);
  if (byte + 1 < 32) v |= (unsigned)ld(scalar + byte + 1) << 8;
  return (int)(v >> (bit & 7)) & ((1 << wbits) - 1);
}

// Wire mode's table row of (lane, pos).
FE_FN long long wire_row(const uint8_t* wire_lane, int key, int npos, int pos, int wbits) {
  const int s = scalar_window(wire_lane, pos, wbits);
  const int k = scalar_window(wire_lane + 32, pos, wbits);
  const long long fw = 1LL << (2 * wbits);
  return (long long)key * npos * fw + (long long)pos * fw + (s << wbits) + k;
}

// A launch's inputs; the pointers a mode does not read are null.
struct args {
  int mode;
  const int32_t* idx;       // index mode
  const uint8_t* wire;      // wire mode
  const int32_t* lane_key;  // wire mode: key index; comb mode: key row base
  const int32_t* s_win;     // comb mode
  const int32_t* k_win;     // comb mode
  const int32_t* table;
  long long m_rows;
  const int32_t* b_table;  // comb mode
  long long m_b_rows;
  int32_t* out;
  int npos, batch, log2_parts, wbits;
};

// Steps a position takes: two rows in comb mode, one otherwise.
FE_FN int steps_per_pos(const args& a) { return a.mode == MODE_COMB ? 2 : 1; }

// Whether step t adds its row negated: the key's row of each position in
// comb mode.
FE_FN bool step_negated(const args& a, int t) { return a.mode == MODE_COMB && (t & 1); }

// The row that step t of `lane` adds (step t is position t in index and wire
// mode, position t / 2 in comb mode, its base row first), and whether it
// lies inside its table.
FE_FN const int32_t* step_row(const args& a, int row_words, int lane, int key, int t,
                              bool& inside) {
  long long r;
  const int32_t* table = a.table;
  long long m = a.m_rows;
  if (a.mode == MODE_INDEX) {
    r = ld(a.idx + (long long)t * a.batch + lane);
  } else if (a.mode == MODE_WIRE) {
    r = wire_row(a.wire + (long long)lane * WIRE, key, a.npos, t, a.wbits);
  } else {
    const int pos = t >> 1;
    const long long at = (long long)pos * a.batch + lane;
    if ((t & 1) == 0) {
      r = (long long)pos * (1 << a.wbits) + ld(a.s_win + at);
      table = a.b_table;
      m = a.m_b_rows;
    } else {
      r = (long long)key + (long long)pos * (1 << a.wbits) + ld(a.k_win + at);
    }
  }
  inside = r >= 0 && r < m;
  return table + (inside ? r : 0) * row_words;
}

// Canonical 17 x 15 limbs of one coordinate into rows [17 q, 17 q + 17)
// of the batch-minor output.
FE_FN void store_fe(const fe& a, int q, int32_t* out, int batch, int lane) {
  int32_t l[NL];
  fe25519::to15(fe25519::fe_canonical(a), l);
#pragma unroll
  for (int i = 0; i < NL; ++i) out[(long long)(q * NL + i) * batch + lane] = l[i];
}

FE_FN void store_point(const point& p, int32_t* out, int batch, int lane) {
  store_fe(p.x, 0, out, batch, lane);
  store_fe(p.y, 1, out, batch, lane);
  store_fe(p.z, 2, out, batch, lane);
  store_fe(p.t, 3, out, batch, lane);
}

}  // namespace k1

#ifdef __CUDACC__

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

using namespace k1;

constexpr int THREADS = 64;  // 2 warps; the shared ring is 26,624 B dense

__device__ __forceinline__ fe shfl_fe(const fe& a, int mask) {
  fe r;
#pragma unroll
  for (int k = 0; k < 10; ++k) r.v[k] = __shfl_xor_sync(0xffffffffu, a.v[k], mask);
  return r;
}

template <int ROW>
__global__ void __launch_bounds__(THREADS) fused_accumulate_kernel(const args a) {
  constexpr int VEC = ROW_VEC<ROW>;
  __shared__ int4 ring[2][VEC][THREADS];

  const long long tid = (long long)blockIdx.x * THREADS + threadIdx.x;
  const int parts = 1 << a.log2_parts;
  const int lane = (int)(tid >> a.log2_parts);
  const int part = (int)(tid & (parts - 1));
  const bool live = lane < a.batch;
  const int spp = steps_per_pos(a);
  const int begin = live ? spp * ((part * a.npos) >> a.log2_parts) : 0;
  const int end = live ? spp * (((part + 1) * a.npos) >> a.log2_parts) : 0;
  const int key = (a.mode != MODE_INDEX && live) ? ld(a.lane_key + lane) : 0;

  auto fetch = [&](int t, int buf) {
    bool inside;
    const int32_t* row = step_row(a, ROW, lane, key, t, inside);
    // an index outside the bank is a caller bug: fail loudly, never read
    // another allocation's bytes
    if (!inside) __trap();
    const int4* src = reinterpret_cast<const int4*>(row);
#pragma unroll
    for (int q = 0; q < VEC; ++q)
      __pipeline_memcpy_async(&ring[buf][q][threadIdx.x], src + q, sizeof(int4));
  };

  point acc = identity();
  if (begin < end) fetch(begin, 0);
  __pipeline_commit();
#pragma unroll 1
  for (int t = begin; t < end; ++t) {
    const int buf = (t - begin) & 1;
    if (t + 1 < end) fetch(t + 1, buf ^ 1);
    __pipeline_commit();
    __pipeline_wait_prior(1);  // this step's row has landed
    int32_t w[4 * VEC];
#pragma unroll
    for (int q = 0; q < VEC; ++q) {
      const int4 v = ring[buf][q][threadIdx.x];
      w[4 * q + 0] = v.x;
      w[4 * q + 1] = v.y;
      w[4 * q + 2] = v.z;
      w[4 * q + 3] = v.w;
    }
    madd_row<ROW>(acc, w, step_negated(a, t));
  }

  // combine tree: every thread of the warp takes part in each exchange
  for (int s = 1; s < parts; s <<= 1) {
    point other;
    other.x = shfl_fe(acc.x, s);
    other.y = shfl_fe(acc.y, s);
    other.z = shfl_fe(acc.z, s);
    other.t = shfl_fe(acc.t, s);
    acc = point_add(acc, other);
  }
  if (live && part == 0) store_point(acc, a.out, a.batch, lane);
}

}  // namespace

// Launches on `stream`: mode 0 index, 1 wire, 2 comb; packed != 0 reads
// 32-word rows. Returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue for arguments the mode cannot take.
extern "C" int fused_accumulate_launch(int mode, int packed, const int32_t* idx,
                                       const uint8_t* wire, const int32_t* lane_key,
                                       const int32_t* s_win, const int32_t* k_win,
                                       const int32_t* table, long long m_rows,
                                       const int32_t* b_table, long long m_b_rows,
                                       int32_t* out, int npos, int batch, int log2_parts,
                                       int wbits, void* stream) {
  bool ok = npos > 0 && npos <= 64 && batch > 0 && m_rows > 0 && table && out &&
            log2_parts >= 0 && log2_parts <= 4 && (1 << log2_parts) <= npos;
  if (mode == MODE_INDEX) {
    ok = ok && idx;
  } else if (mode == MODE_WIRE) {
    ok = ok && wire && lane_key && wbits >= 4 && wbits <= 6 &&
         npos == (256 + wbits - 1) / wbits;
  } else if (mode == MODE_COMB) {
    ok = ok && s_win && k_win && lane_key && b_table && m_b_rows > 0 && wbits == 4 &&
         npos == 64;
  } else {
    ok = false;
  }
  if (!ok) return (int)cudaErrorInvalidValue;
  const args a{mode, idx, wire, lane_key, s_win, k_win, table, m_rows, b_table, m_b_rows,
               out, npos, batch, log2_parts, wbits};
  const long long threads = (long long)batch << log2_parts;
  const dim3 grid((unsigned)((threads + THREADS - 1) / THREADS));
  if (packed)
    fused_accumulate_kernel<ROW_PACKED><<<grid, THREADS, 0, (cudaStream_t)stream>>>(a);
  else
    fused_accumulate_kernel<ROW_DENSE><<<grid, THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// Threads of the kernel for one row layout that the current device holds
// resident at once; the wrapper sizes P from it. Negative on a CUDA error.
extern "C" long long fused_accumulate_resident_threads(int packed) {
  int dev = 0, sms = 0, blocks = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return -1;
  const cudaError_t rc =
      packed ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                   &blocks, fused_accumulate_kernel<ROW_PACKED>, THREADS, 0)
             : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                   &blocks, fused_accumulate_kernel<ROW_DENSE>, THREADS, 0);
  if (rc != cudaSuccess) return -1;
  return (long long)sms * blocks * THREADS;
}

#endif  // __CUDACC__
