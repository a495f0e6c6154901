// Exact lookup and summary of one walker step for Hopper (sm_90a):
//   kh_lookup_summary replaces the XLA glue that follows the filtered
//   lookup in keyhuntm1cpu_tpu/engine/brute.py _brute_chunk_impl
//   (:1064-1093: the degenerate mask, the hit mask, the candidate
//   positions and rows, the per-walker degenerate summary, the row's
//   concatenation) and the lock-step lower-bound search it calls,
//   keyhuntm1cpu_tpu/filter/sorted_table.py lookup (:68).
// Wrapper and plain torch version: keyhuntm1cpu_tpu_torch/filter/
// sorted_table.py lookup_summary / lookup_summary_ref.
//
// Inputs: the probe's C compacted survivors (pos, and the (hi, lo) words
// of each key; pos == total is padding) and their count; the sorted table
// (m keys, the packed (hi << 32 | lo) with bit 63 flipped, so the signed
// int64 order is the unsigned one, and m int32 payloads); the step's
// degenerate flags (W, U) and advance flags (W,) as bytes; total =
// nq*W*npts with npts = 2U+1. Output: one int32 row of 2C + 3W + 1 words,
// written in place (a row of the chunk's (K, 2C + 3W + 1) summary):
//   [0, C)        cand_pos = hit ? pos : total
//   [C, 2C)       cand_row = hit ? idx[min(lb, m-1)] : 0
//   [2C, 2C+W)    n_deg: set flags of walker w
//   [2C+W, 2C+2W) first_deg: the first set flag of walker w, 0 if none
//   [2C+2W, ..)   adv_deg, then the survivor count (passed through)
// where lb is the lower bound of the key in the table (torch.searchsorted,
// the JAX search), found = lb < m and key[lb] == q, found2 = lb+1 < m and
// key[lb+1] == q (a duplicated truncated key), and hit = (found | found2)
// & pos < total & the lane is live: lanes +u and -u of walker w share
// deg[w][u-1] (the center has no flag), read at min(pos, total-1) mod
// W*npts, as the JAX code does.
//
// One block a step: thread c searches candidate c (a binary search of
// ceil(log2(m+1)) dependent 8-byte reads; the top levels, which every
// thread reads, hit in L1 and L2), then warp w reduces walker w's U flags (16 bytes a lane a
// load when the rows are 16-byte aligned, else a byte a lane). Bound on the
// H100: the latency of one search (~23 dependent reads at m = 2^22), not
// bytes (~2 KB of keys read per candidate) nor operations; a cached upper
// tree of the table would cut the dependent DRAM reads.
// The entry point launches on the given stream, does not synchronise, and
// returns cudaGetLastError().
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

struct LookupArgs {
  const int32_t* pos;
  const uint32_t* qhi;
  const uint32_t* qlo;
  const int32_t* count;
  const long long* key;
  const int32_t* idx;
  const uint8_t* deg;
  const uint8_t* adeg;
  long long m;
  int C, W, U, total;
};

// the first position of key[0, m) not less than q (signed int64 order)
__device__ __forceinline__ long long lower_bound(const long long* __restrict__ key, long long m,
                                                 long long q) {
  long long lo = 0, hi = m;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (__ldg(key + mid) < q) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__device__ __forceinline__ void candidate(const LookupArgs& a, int c, int32_t* __restrict__ out) {
  const int p = a.pos[c];
  const unsigned long long packed =
      ((unsigned long long)a.qhi[c] << 32 | a.qlo[c]) ^ (1ull << 63);
  const long long q = (long long)packed;
  const long long lb = lower_bound(a.key, a.m, q);
  const bool found = lb < a.m && a.key[lb] == q;
  const bool found2 = lb + 1 < a.m && a.key[lb + 1] == q;
  const long long npts = 2LL * a.U + 1;
  const long long r = (long long)min(p, a.total - 1) % (a.W * npts);
  const long long w = r / npts, lane = r % npts;
  const bool degenerate = lane < 2LL * a.U && a.deg[w * a.U + (lane < a.U ? lane : lane - a.U)];
  const bool hit = (found || found2) && p < a.total && !degenerate;
  out[c] = hit ? p : a.total;
  out[a.C + c] = hit ? a.idx[lb < a.m ? lb : a.m - 1] : 0;
}

// walker w's flags: (set count, first set lane or U when none) over this
// lane's share; the warp reduces them
__device__ __forceinline__ void walker(const LookupArgs& a, int w, int lane,
                                       int32_t* __restrict__ out) {
  const uint8_t* row = a.deg + (long long)w * a.U;
  int n = 0, first = a.U;
  if (a.U % 16 == 0 && ((uintptr_t)a.deg & 15) == 0) {  // rows 16-byte aligned: a uint4 a lane
    const uint4* v = reinterpret_cast<const uint4*>(row);
#pragma unroll 4
    for (int k = lane; k < a.U / 16; k += 32) {
      const uint4 x = v[k];
      const uint32_t words[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int j = 0; j < 4; j++) {
        const uint32_t nz = __vcmpne4(words[j], 0u);  // 0xFF per non-zero byte
        n += __popc(nz) >> 3;
        if (nz) first = min(first, 16 * k + 4 * j + ((__ffs(nz) - 1) >> 3));
      }
    }
  } else {
    for (int u = lane; u < a.U; u += 32) {
      if (row[u]) {
        n++;
        first = min(first, u);
      }
    }
  }
  n = __reduce_add_sync(0xFFFFFFFFu, n);
  first = __reduce_min_sync(0xFFFFFFFFu, first);
  if (lane == 0) {
    out[2 * a.C + w] = n;
    out[2 * a.C + a.W + w] = first < a.U ? first : 0;
    out[2 * a.C + 2 * a.W + w] = a.adeg[w] != 0;
  }
}

__global__ void __launch_bounds__(kThreads)
lookup_summary_kernel(LookupArgs a, int32_t* __restrict__ out) {
  for (int c = threadIdx.x; c < a.C; c += kThreads) candidate(a, c, out);
  const int lane = threadIdx.x & 31;
  for (int w = threadIdx.x >> 5; w < a.W; w += kThreads / 32) walker(a, w, lane, out);
  if (threadIdx.x == 0) out[2 * a.C + 3 * a.W] = *a.count;
}

}  // namespace

extern "C" int kh_lookup_summary(const void* pos, const void* qhi, const void* qlo,
                                 const void* count, const void* key, const void* idx,
                                 const void* deg, const void* adeg, void* out, long long m,
                                 int C, int W, int U, int total, void* stream) {
  if (m < 1 || C < 1 || W < 1 || U < 1 || total < 1) return (int)cudaErrorInvalidValue;
  const LookupArgs a{(const int32_t*)pos, (const uint32_t*)qhi, (const uint32_t*)qlo,
                     (const int32_t*)count, (const long long*)key, (const int32_t*)idx,
                     (const uint8_t*)deg, (const uint8_t*)adeg, m, C, W, U, total};
  lookup_summary_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(a, (int32_t*)out);
  return (int)cudaGetLastError();
}
