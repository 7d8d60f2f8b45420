// The quorum tally of a shard: per consensus instance, the sum of its
// one-hot column over the votes whose signature verified, added into a
// counts vector that the caller zeroed.
//
// Replaces: the tally of the JAX package's quorum steps,
// simple_pbft_tpu/parallel/sharded_verify.py:133 (make_comb_quorum_step)
// and :163-165 (make_quorum_step),
//   jnp.sum(onehot * verdict[:, None].astype(int32), axis=0),
// which XLA fuses into the shard_map program that the psum (:134, :166)
// then reduces over the mesh. It is not a Pallas kernel there; here it is
// the launch that follows each shard's verify.
//
// Contract (plain PyTorch version: ops/quorum.py quorum_tally_plain):
//   onehot  (B, n_inst) int32  row r maps vote r to its instance (all-zero
//                              rows are padding); any int32 weights work
//   verdict (B,) bool          the shard's verdicts
//   counts  (n_inst,) int32    counts[c] += sum over r of onehot[r, c] *
//                              verdict[r], modulo 2^32 as JAX's int32
//                              sum wraps
// The kernel accumulates and does not own `counts`: every shard of a
// quorum step on one device adds into the one vector that the step zeroed
// (parallel/sharded_verify.py), so k shards on a card cost one zeroing, k
// launches and no add between shards. Integer addition is associative
// modulo 2^32, so the result is exact and does not depend on the order in
// which shards run or atomics land.
//
// What bounds it on an H100: bytes. At B = 8192 and n_inst = 128 the
// function reads 8,192 bytes of verdicts and 512 bytes of one-hot for each
// vote whose verdict is set, at most 4,194,304 bytes, about 1.25 us at
// 3.35 TB/s, against at most about a million adds (0.06 us at 64 int32
// operations per SM per clock). Two memory latencies in series (the
// verdicts, then the rows they select) and the launch itself set its time
// (chip_smoke.py's phase `mesh` times a fill of 128 int32 beside it as the
// least a kernel takes), so the design puts every row load of a block in
// flight at once and spreads the rows over many blocks:
//
// - A warp holds 16 rows (RPW). Lanes 0-15 load the 16 verdicts, and a
//   ballot turns them into a bit mask in a register; a row whose verdict
//   is false is never read (each load is predicated on its bit).
// - A block is 4 warps, 64 rows by 32 instance columns. At B = 8192 and
//   n_inst = 128 the grid is 4 column blocks by 128 row blocks, 512
//   blocks of 128 threads on 132 SMs, so the whole 4 MB is requested at
//   once.
// - Where n_inst % 4 == 0 and the one-hot's base is 16-byte aligned (the
//   wrapper checks both), a lane reads an int4 of 4 columns (VEC = 4): 8
//   lanes span a row's 32 columns and the warp reads 4 rows, 4 times 128
//   contiguous bytes, in one instruction, 4 loads a lane. Otherwise a lane
//   reads one int32 (VEC = 1): the warp reads 1 row an instruction, 16
//   loads a lane. A lane's loads are independent and unrolled, all issued
//   before the first add. ptxas reports 32 registers and no spill for both
//   (sm_90a, -O3); 512 and 2,048 bytes of shared memory.
// - Each lane's sums meet the other rows' in shared memory (WARPS * VEC
//   partials a column), and the block adds each column's sum into
//   `counts` with one atomicAdd, skipped where the sum is 0: 128 atomics
//   a column at the shape above. The 4 row groups of a VEC = 4 warp meet
//   there too, behind the one barrier, with no shuffle rounds before it.
// At n_inst < 32 most lanes of a warp idle; the tally is small beside the
// verify that precedes it either way.

#include <cstdint>

namespace quorum {

constexpr int WARPS = 4;               // warps a block
constexpr int THREADS = 32 * WARPS;    // 128
constexpr int COLS = 32;               // instance columns a block
constexpr int RPW = 16;                // rows a warp: one ballot of 16 verdicts
constexpr int ROWS = RPW * WARPS;      // rows a block: 64
constexpr int MAX_ROW_BLOCKS = 65535;  // grid.y limit

// A predicated non-coherent load: `v` keeps its value where `take` is 0,
// and no address is touched.
__device__ __forceinline__ void load_if(int32_t& v, const int32_t* q, unsigned take) {
  asm volatile("{ .reg .pred p; setp.ne.u32 p, %1, 0; @p ld.global.nc.s32 %0, [%2]; }"
               : "+r"(v) : "r"(take), "l"(q));
}
__device__ __forceinline__ void load_if(int4& v, const int4* q, unsigned take) {
  asm volatile(
      "{ .reg .pred p; setp.ne.u32 p, %4, 0; @p ld.global.nc.v4.s32 {%0, %1, %2, %3}, [%5]; }"
      : "+r"(v.x), "+r"(v.y), "+r"(v.z), "+r"(v.w) : "r"(take), "l"(q));
}

template <int VEC>
struct Vec;

template <>
struct Vec<1> {
  using T = int32_t;
  static __device__ __forceinline__ T zero() { return 0; }
  static __device__ __forceinline__ void add(uint32_t (&acc)[1], T v) { acc[0] += (uint32_t)v; }
};

template <>
struct Vec<4> {
  using T = int4;
  static __device__ __forceinline__ T zero() { return make_int4(0, 0, 0, 0); }
  static __device__ __forceinline__ void add(uint32_t (&acc)[4], T v) {
    acc[0] += (uint32_t)v.x;
    acc[1] += (uint32_t)v.y;
    acc[2] += (uint32_t)v.z;
    acc[3] += (uint32_t)v.w;
  }
};

// A warp's 32 lanes as LANES = 32 / VEC lanes across a row's 32 columns
// (VEC columns a lane) by VEC rows at once: lane l reads columns
// (l % LANES) * VEC .. + VEC - 1 of rows l / LANES, + VEC, + 2 VEC, ...
// of the warp's 16.
template <int VEC>
__global__ void __launch_bounds__(THREADS)
quorum_tally_kernel(const int32_t* __restrict__ onehot, const bool* __restrict__ verdict,
                    uint32_t* __restrict__ counts, int batch, int n_inst) {
  using V = Vec<VEC>;
  using T = typename V::T;
  constexpr int LANES = COLS / VEC;  // lanes across a row
  constexpr int LOADS = RPW / VEC;   // loads a lane
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int sub = lane / LANES;                                // the lane's first row
  const int col = (int)blockIdx.x * COLS + (lane % LANES) * VEC;  // its first column
  const int row0 = (int)blockIdx.y * ROWS + warp * RPW;        // the warp's first row
  const bool valid = lane < RPW && row0 + lane < batch && verdict[row0 + lane];
  const unsigned mask = __ballot_sync(0xffffffffu, valid);
  // unsigned: the wrap modulo 2^32 is defined, and equals int32's
  uint32_t acc[VEC] = {};
  // at VEC = 4, n_inst % 4 == 0: a lane's 4 columns exist together or not
  const unsigned mine = col < n_inst ? mask >> sub : 0u;
  const size_t stride = (size_t)n_inst;  // VEC rows, in T
  const T* p = reinterpret_cast<const T*>(onehot + (size_t)(row0 + sub) * n_inst + col);
  T v[LOADS];
#pragma unroll
  for (int j = 0; j < LOADS; ++j) {
    v[j] = V::zero();
    load_if(v[j], p + j * stride, (mine >> (j * VEC)) & 1u);
  }
#pragma unroll
  for (int j = 0; j < LOADS; ++j) V::add(acc, v[j]);
  __shared__ uint32_t part[WARPS * VEC][COLS];
#pragma unroll
  for (int c = 0; c < VEC; ++c) part[warp * VEC + sub][(lane % LANES) * VEC + c] = acc[c];
  __syncthreads();
  const int gc = (int)blockIdx.x * COLS + threadIdx.x;
  if (threadIdx.x < COLS && gc < n_inst) {
    uint32_t sum = 0;
#pragma unroll
    for (int w = 0; w < WARPS * VEC; ++w) sum += part[w][threadIdx.x];
    if (sum != 0) atomicAdd(counts + gc, sum);
  }
}

}  // namespace quorum

// Adds the shard's tally into `counts` on `stream`, on CUDA device `device`
// (made current for the launch and restored after). vec = 4 takes the
// 16-byte loads and requires n_inst % 4 == 0 and a 16-byte aligned
// `onehot`; vec = 1 takes any.
extern "C" int quorum_tally_launch(const int32_t* onehot, const bool* verdict, int32_t* counts,
                                   int batch, int n_inst, int vec, int device, void* stream) {
  using namespace quorum;
  if (batch <= 0 || n_inst <= 0) return (int)cudaErrorInvalidValue;
  if (vec != 1 && vec != 4) return (int)cudaErrorInvalidValue;
  if (vec == 4 && (n_inst % 4 != 0 || reinterpret_cast<uintptr_t>(onehot) % 16 != 0))
    return (int)cudaErrorMisalignedAddress;
  const int row_blocks = (batch + ROWS - 1) / ROWS;
  if (row_blocks > MAX_ROW_BLOCKS) return (int)cudaErrorInvalidValue;
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  uint32_t* out = reinterpret_cast<uint32_t*>(counts);
  const dim3 grid((n_inst + COLS - 1) / COLS, row_blocks);
  if (vec == 4)
    quorum_tally_kernel<4><<<grid, THREADS, 0, s>>>(onehot, verdict, out, batch, n_inst);
  else
    quorum_tally_kernel<1><<<grid, THREADS, 0, s>>>(onehot, verdict, out, batch, n_inst);
  err = cudaGetLastError();
  if (current != device) cudaSetDevice(current);
  return (int)err;
}
