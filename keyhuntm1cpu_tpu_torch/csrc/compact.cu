// Hit compaction and summary of the fused brute chunk for Hopper (sm_90a):
//   kh_compact_hits replaces the XLA glue after the brute kernel in
//   keyhuntm1cpu_tpu/curve/pbrute.py pallas_brute_chunk (:300-344).
// Wrapper and plain torch version: keyhuntm1cpu_tpu_torch/curve/pbrute.py
// compact_hits / compact_hits_ref.
//
// Input: K4's (K, U) hit words (U % 128 == 0; query bits 0..29, bit 30 the
// degenerate flag) and K1's (K,) advance flags. Output: the chunk's
// (2C + 3K + 1,) int32 summary, written in place:
//   [0, C)          the first C positions (flat k*U + u) of the non-zero
//                   query words of the picked rows, ascending, padded K*U
//   [C, 2C)         their query bits, padded 0
//   [2C, 2C+K)      n_deg: words of step k with bit 30 set
//   [2C+K, 2C+2K)   first_deg: the first such u of step k, 0 when none
//   [2C+2K, 2C+3K)  the advance flags as 0/1
//   [2C+3K]         n: the non-zero query words of the picked rows, or
//                   C + 1 when more than R rows are flagged
// where a row is 128 consecutive words, a row is flagged when one of its
// query words is non-zero, and the picked rows are the first
// R = max(8, C / 32) flagged rows in ascending order.
//
// Bound on the H100: the 4*K*U bytes of hit words (16 MB at K = 256,
// U = 16384: 5 us at 3.35 TB/s; K4 has just written them, so most reads hit
// L2). The JAX code runs ~20 XLA ops over them (a row reduction, two
// nonzero compactions, gathers, a sum and an argmax per step, a concat);
// the port's torch version ran as many kernels. Here one launch does it:
// block k reads step k's U words as 16-byte vectors (a warp a 128-word
// row, kBatch rows in flight a warp) and writes its row flags (a bit a
// row), its count of flagged rows and its n_deg, first_deg and advance
// flag. A block's ticket (a 64-bit atomic add) counts the blocks done in
// its high word and sums their flagged rows in its low word, so the last
// block to finish knows the chunk's flagged rows without another read.
// Where no row is flagged, the last block writes the padding and is
// done; else it scans the K counts, expands the first R flagged rows in
// order and compacts their non-zero words by block scans, the first
// kPrefetch flag words of each step loaded beside its count (one round
// trip; all of them at U = 16384). A chunk over a few targets in
// intervals holds a hit only where it holds a target, but the bucketed
// table matches 39 bits of a key (its lane and high word), so at its
// 2^16 targets a chunk of 2^22 keys has ~T K U / 2^39 = 0.5 false hits a
// query set, and most chunks take the scans.
// scripts/torch_pbrute_shapes.py times other forms (2 and 4 blocks a step,
// other kBatch and kPrefetch); PERF.md has their times.
//
// No memset comes before a launch. The scratch holds the ticket, the
// steps' counts (step_rows) and the row flags (rowbits); every launch
// rewrites step_rows and rowbits whole before its last block reads them,
// so only the ticket (the first 8 bytes) must be zero on entry. The
// wrapper keeps two scratches a stream and alternates them: each launch
// uses one and zeroes the other's ticket, which the launch before it
// (done: launches on one stream do not overlap) used.
//
// The entry point launches on the given stream, does not synchronise, and
// returns a cudaError_t.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kLanes = 128;  // words of a hit row
constexpr int kBatch = 4;    // rows a warp loads before it reduces them
constexpr int kPrefetch = 4;  // flag words the last block loads beside a step's count
constexpr uint32_t kQueryMask = (1u << 30) - 1;

struct CompactArgs {
  const uint32_t* hits;   // (K, U)
  const uint8_t* adeg;    // (K,)
  int32_t* out;           // (2C + 3K + 1,)
  unsigned long long* ticket;  // zero on entry: blocks done << 32 | their flagged rows
  unsigned long long* next;    // the next launch's ticket, zeroed here
  uint32_t* step_rows;    // (K,) flagged rows of each step
  uint32_t* rowbits;      // (K, W) the flags of step k's rows, bit r % 32 of word r / 32
  int K, U, C, R, W;
};

// The block's exclusive scan of one value a thread; *total gets the sum.
// Every thread must call it.
__device__ __forceinline__ uint32_t block_scan(uint32_t v, uint32_t* s_warp, uint32_t* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(0xFFFFFFFFu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  uint32_t before = 0, agg = 0;
#pragma unroll
  for (int w = 0; w < kWarps; w++) {
    const uint32_t x = s_warp[w];
    before += w < warp ? x : 0u;
    agg += x;
  }
  __syncthreads();  // s_warp is reused
  *total = agg;
  return before + incl - v;
}

// Block k: step k's row flags, flagged-row count and degenerate summary.
// Returns the flagged-row count (in thread 0).
__device__ uint32_t step_summary(const CompactArgs& a, int k, uint32_t* s_bits,
                                 uint32_t* s_red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rows = a.U / kLanes;
  const uint4* step = reinterpret_cast<const uint4*>(a.hits + (long long)k * a.U);
  for (int j = threadIdx.x; j < a.W; j += kThreads) s_bits[j] = 0;
  __syncthreads();
  uint32_t n_deg = 0, n_flag = 0;
  int first = a.U;
  for (int r0 = warp; r0 < rows; r0 += kWarps * kBatch) {
    uint4 w[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; b++) {
      const int r = r0 + b * kWarps;
      w[b] = r < rows ? __ldg(step + (long long)r * 32 + lane) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int b = 0; b < kBatch; b++) {
      const int r = r0 + b * kWarps;  // warp-uniform
      if (r < rows) {
        const bool flag = __any_sync(0xFFFFFFFFu, ((w[b].x | w[b].y | w[b].z | w[b].w) &
                                                   kQueryMask) != 0);
        if (lane == 0 && flag) atomicOr(s_bits + r / 32, 1u << (r % 32));
        n_flag += flag;
        const uint32_t d = ((w[b].x >> 30) & 1u) | ((w[b].y >> 29) & 2u) |
                           ((w[b].z >> 28) & 4u) | ((w[b].w >> 27) & 8u);
        n_deg += __popc(d);
        if (d) first = min(first, r * kLanes + 4 * lane + __ffs(d) - 1);
      }
    }
  }
  n_deg = __reduce_add_sync(0xFFFFFFFFu, n_deg);
  first = __reduce_min_sync(0xFFFFFFFFu, first);
  if (lane == 0) {
    s_red[warp] = n_deg;
    s_red[kWarps + warp] = (uint32_t)first;
    s_red[2 * kWarps + warp] = n_flag;  // the same in every lane
  }
  __syncthreads();
  for (int j = threadIdx.x; j < a.W; j += kThreads) a.rowbits[(long long)k * a.W + j] = s_bits[j];
  uint32_t nf = 0;
  if (threadIdx.x == 0) {
    uint32_t nd = 0;
    int f = a.U;
    for (int i = 0; i < kWarps; i++) {
      nd += s_red[i];
      f = min(f, (int)s_red[kWarps + i]);
      nf += s_red[2 * kWarps + i];
    }
    a.step_rows[k] = nf;
    a.out[2 * a.C + k] = (int32_t)nd;
    a.out[2 * a.C + a.K + k] = f < a.U ? f : 0;
    a.out[2 * a.C + 2 * a.K + k] = a.adeg[k] != 0;
  }
  return nf;
}

// The last block, n_rows flagged rows in all: the first R of them, then
// the first C non-zero query words in them. Step counts and row flags come
// from other blocks (through L2: __ldcg).
__device__ void compact(const CompactArgs& a, uint32_t n_rows, int* s_rsel, uint32_t* s_warp) {
  const int t = threadIdx.x;
  const int rows = a.U / kLanes;
  uint32_t n = 0;
  if (n_rows) {  // block-uniform
    // 1. rank the steps' flagged rows; a step with rows to give expands
    // its flag words
    uint32_t base = 0;
    for (int k0 = 0; k0 < a.K; k0 += kThreads) {
      const int k = k0 + t;
      const uint32_t* bits = a.rowbits + (long long)k * a.W;
      // the count and the first flag words, loaded together
      const uint32_t c = k < a.K ? __ldcg(a.step_rows + k) : 0u;
      uint32_t pre[kPrefetch];
#pragma unroll
      for (int j = 0; j < kPrefetch; j++) pre[j] = k < a.K && j < a.W ? __ldcg(bits + j) : 0u;
      uint32_t tot;
      uint32_t rank = base + block_scan(c, s_warp, &tot);
      if (c && rank < (uint32_t)a.R) {
#pragma unroll
        for (int j = 0; j < kPrefetch; j++) {
          for (uint32_t b = pre[j]; b && rank < (uint32_t)a.R; b &= b - 1)
            s_rsel[rank++] = k * rows + 32 * j + __ffs(b) - 1;
        }
        for (int j = kPrefetch; j < a.W && rank < (uint32_t)a.R; j++) {
          for (uint32_t b = __ldcg(bits + j); b && rank < (uint32_t)a.R; b &= b - 1)
            s_rsel[rank++] = k * rows + 32 * j + __ffs(b) - 1;
        }
      }
      base += tot;
    }
    const int picked = (int)min(base, (uint32_t)a.R);  // base == n_rows
    __syncthreads();
    // 2. the non-zero query words of the picked rows, in order (the rows
    // past the flagged ones are padding and hold none)
    for (int i0 = 0; i0 < picked * kLanes; i0 += kThreads) {
      const int i = i0 + t;
      uint32_t q = 0;
      int p = 0;
      if (i < picked * kLanes) {
        p = s_rsel[i / kLanes] * kLanes + i % kLanes;
        q = __ldcg(a.hits + p) & kQueryMask;
      }
      uint32_t tot;
      const uint32_t r = n + block_scan(q != 0, s_warp, &tot);
      if (q && r < (uint32_t)a.C) {
        a.out[r] = p;
        a.out[a.C + r] = (int32_t)q;
      }
      n += tot;
    }
  }
  for (int j = (int)min(n, (uint32_t)a.C) + t; j < a.C; j += kThreads) {
    a.out[j] = a.K * a.U;
    a.out[a.C + j] = 0;
  }
  if (t == 0) a.out[2 * a.C + 3 * a.K] = n_rows > (uint32_t)a.R ? a.C + 1 : (int32_t)n;
}

__global__ void __launch_bounds__(kThreads) compact_hits_kernel(CompactArgs a) {
  // max(W, R) words: step k's row flags, then (the last block) the R
  // picked rows
  extern __shared__ uint32_t s_dyn[];
  __shared__ uint32_t s_red[3 * kWarps];
  __shared__ bool s_last;
  __shared__ uint32_t s_rows;
  if (blockIdx.x == 0 && threadIdx.x == 0) *a.next = 0;
  const uint32_t nf = step_summary(a, blockIdx.x, s_dyn, s_red);
  __threadfence();  // this block's flags and counts before its ticket
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned long long old = atomicAdd(a.ticket, 1ull << 32 | nf);
    s_last = old >> 32 == gridDim.x - 1;
    s_rows = (uint32_t)old + nf;  // every block's, in the last one
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  compact(a, s_rows, reinterpret_cast<int*>(s_dyn), s_red);
}

}  // namespace

// scratch: (2 + K + K * W) u32, W = ceil(U / 128 / 32), 8-byte aligned: the
// ticket (two u32, zero on entry), each step's flagged rows and each
// step's row flags; next: the other scratch of the stream, whose ticket
// this launch zeroes for the next one.
extern "C" int kh_compact_hits(const void* hits, const void* adeg, void* out, void* scratch,
                               void* next, int K, int U, int C, void* stream) {
  if (K < 1 || U < kLanes || U % kLanes || C < 1 || (long long)K * U >= 0x7FFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  const int R = C / 32 > 8 ? C / 32 : 8;
  const int W = (U / kLanes + 31) / 32;
  const size_t smem = (size_t)(R > W ? R : W) * sizeof(uint32_t);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  uint32_t* w = (uint32_t*)scratch;
  const CompactArgs a{(const uint32_t*)hits, (const uint8_t*)adeg, (int32_t*)out,
                      (unsigned long long*)w, (unsigned long long*)next, w + 2, w + 2 + K,
                      K, U, C, R, W};
  compact_hits_kernel<<<(unsigned)K, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
