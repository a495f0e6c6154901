// Exact lookup and summaries for Hopper (sm_90a):
//   kh_lookup_summary replaces the XLA glue that follows the filtered
//   lookup in keyhuntm1cpu_tpu/engine/brute.py _brute_chunk_impl
//   (:1064-1093: the degenerate mask, the hit mask, the candidate
//   positions and rows, the per-walker degenerate summary, the row's
//   concatenation) and the lock-step lower-bound search it calls,
//   keyhuntm1cpu_tpu/filter/sorted_table.py lookup (:68).
//   kh_bsgs_summary replaces what follows the cascade in the BSGS chunk,
//   keyhuntm1cpu_tpu/engine/bsgs.py _pallas_chunk_impl (:1662-1708, the
//   exact search of the survivors in the sorted baby table) and
//   _pallas_chunk_impl_host (:1711-1752, the survivors' keys passed
//   through): the lane U - 1 fix-up of the degenerate flags, the live
//   mask, the candidate words, the per-row degenerate summary and the
//   packed (3C + 3R + 1,) summary.
// Wrappers and plain torch versions: keyhuntm1cpu_tpu_torch/filter/
// sorted_table.py lookup_summary / lookup_summary_ref and
// keyhuntm1cpu_tpu_torch/engine/bsgs.py chunk_summary(_host) /
// chunk_summary_ref.
//
// Both search the sorted table (m keys, the packed (hi << 32 | lo) with
// bit 63 flipped, so the signed int64 order is the unsigned one, and m
// int32 payloads) for the lower bound lb of each survivor's key
// (torch.searchsorted, the JAX search): found = lb < m and key[lb] == q,
// found2 = lb+1 < m and key[lb+1] == q (a duplicated truncated key).
//
// kh_lookup_summary, inputs: the probe's C compacted survivors (pos, and
// the (hi, lo) words of each key; pos == total is padding) and their
// count; the step's degenerate flags (W, U) and advance flags (W,) as
// bytes; total = nq*W*npts with npts = 2U+1. Output: one int32 row of
// 2C + 3W + 1 words, written in place (a row of the chunk's
// (K, 2C + 3W + 1) summary):
//   [0, C)        cand_pos = hit ? pos : total
//   [C, 2C)       cand_row = hit ? idx[min(lb, m-1)] : 0
//   [2C, 2C+W)    n_deg: set flags of walker w
//   [2C+W, 2C+2W) first_deg: the first set flag of walker w, 0 if none
//   [2C+2W, ..)   adv_deg, then the survivor count (passed through)
// where hit = (found | found2) & pos < total & the lane is live: lanes +u
// and -u of walker w share deg[w][u-1] (the center has no flag), read at
// min(pos, total-1) mod W*npts, as the JAX code does.
//
// kh_bsgs_summary, inputs: the cascade's C survivors (pos, their key words,
// their count; pos == B is padding), the flags of the B = Rc*U queries
// they index (cdeg (Rc, U) bytes, and cadv (Rc,), the advance flag that
// also marks lane U - 1 of its row), the R summary rows' flags
// (rdeg (R, U), radv (R,)), and the table (none: host resolve). A
// survivor is live where p < B and neither cdeg[p'] nor, on lane U - 1,
// cadv of its row is set, p' = min(p, B - 1). Output, (3C + 3R + 1,):
//   [0, C)        device: (found | found2) & live ? p : B; host: live ? p : B
//   [C, 2C)       device: found & live ? idx[min(lb, m-1)] : 0; host: qhi
//   [2C, 3C)      device: found2 & live ? idx[min(lb+1, m-1)] : 0; host: qlo
//   [3C, 3C+R)    the set flags of row r, lane U - 1 or'ed with radv[r]
//   [3C+R, 3C+2R) the first of them (0 when none: argmax)
//   [3C+2R, 3C+3R) radv, then the (poisoned) survivor count
// Blocks of two roles in one launch: the first ceil(C / kThreads) a thread
// a survivor, the rest a warp a row.
//
// kh_lookup_summary runs one block a step: thread c searches candidate c (a
// binary search of ceil(log2(m+1)) dependent 8-byte reads; the top levels,
// which every thread reads, hit in L1 and L2), then warp w reduces walker
// w's U flags (16 bytes a lane a load when the rows are 16-byte aligned,
// else a byte a lane). Bound on the H100: the latency of one search (~23
// dependent reads at m = 2^22), not bytes (~2 KB of keys read per
// candidate) nor operations; a cached upper tree of the table would cut
// the dependent DRAM reads. kh_bsgs_summary's rows are 4 MB of flags at
// the main path's R = 256, U = 16,384 (bytes: ~1.3 us at 3.35 TB/s), its
// C2 = 1,536 searches 29 dependent reads each over 2^28 keys: latency
// again, so padding and dead survivors skip the search, and the two
// roles run side by side.
// The entry points launch on the given stream, do not synchronise, and
// return cudaGetLastError().
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

// the survivor's key against the table: lb, found, found2
struct Match {
  long long lb;
  bool found, found2;
};

__device__ __forceinline__ Match match(const long long* __restrict__ key, long long m,
                                       uint32_t qhi, uint32_t qlo) {
  const long long q = (long long)(((unsigned long long)qhi << 32 | qlo) ^ (1ull << 63));
  const long long lb = lower_bound(key, m, q);
  return {lb, lb < m && key[lb] == q, lb + 1 < m && key[lb + 1] == q};
}

__device__ __forceinline__ void candidate(const LookupArgs& a, int c, int32_t* __restrict__ out) {
  const int p = a.pos[c];
  const Match r = match(a.key, a.m, a.qhi[c], a.qlo[c]);
  const long long npts = 2LL * a.U + 1;
  const long long q = (long long)min(p, a.total - 1) % (a.W * npts);
  const long long w = q / npts, lane = q % npts;
  const bool degenerate = lane < 2LL * a.U && a.deg[w * a.U + (lane < a.U ? lane : lane - a.U)];
  const bool hit = (r.found || r.found2) && p < a.total && !degenerate;
  out[c] = hit ? p : a.total;
  out[a.C + c] = hit ? a.idx[r.lb < a.m ? r.lb : a.m - 1] : 0;
}

// A row of U flag bytes: (set count, first set lane or U when none),
// reduced over the warp; 16 bytes a lane a load when the rows are 16-byte
// aligned (vec), else a byte a lane.
__device__ __forceinline__ void row_flags(const uint8_t* __restrict__ row, int U, bool vec,
                                          int lane, int& n_set, int& first_set) {
  int n = 0, first = U;
  if (vec) {
    const uint4* v = reinterpret_cast<const uint4*>(row);
#pragma unroll 4
    for (int k = lane; k < U / 16; k += 32) {
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
    for (int u = lane; u < U; u += 32) {
      if (row[u]) {
        n++;
        first = min(first, u);
      }
    }
  }
  n_set = __reduce_add_sync(0xFFFFFFFFu, n);
  first_set = __reduce_min_sync(0xFFFFFFFFu, first);
}

__device__ __forceinline__ bool rows_aligned(const uint8_t* deg, int U) {
  return U % 16 == 0 && ((uintptr_t)deg & 15) == 0;
}

// walker w's words
__device__ __forceinline__ void walker(const LookupArgs& a, int w, int lane,
                                       int32_t* __restrict__ out) {
  int n, first;
  row_flags(a.deg + (long long)w * a.U, a.U, rows_aligned(a.deg, a.U), lane, n, first);
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

struct BsgsArgs {
  const int32_t* pos;
  const uint32_t* qhi;
  const uint32_t* qlo;
  const int32_t* count;
  const long long* key;  // null: host resolve
  const int32_t* idx;
  const uint8_t* cdeg;  // (Rc, U): the flags of the B = Rc*U queries
  const uint8_t* cadv;  // (Rc,)
  const uint8_t* rdeg;  // (R, U): the summary rows
  const uint8_t* radv;  // (R,)
  long long m, B;
  int C, R, U;
};

__device__ __forceinline__ void bsgs_candidate(const BsgsArgs& a, int c,
                                               int32_t* __restrict__ out) {
  const int p = a.pos[c];
  const long long q = min((long long)p, a.B - 1);
  const bool dead = a.cdeg[q] || (q % a.U == a.U - 1 && a.cadv[q / a.U]);
  const bool live = p < a.B && !dead;
  const int32_t none = (int32_t)a.B;
  if (a.key == nullptr) {  // host resolve: the keys go to the host
    out[c] = live ? p : none;
    out[a.C + c] = (int32_t)a.qhi[c];
    out[2 * a.C + c] = (int32_t)a.qlo[c];
    return;
  }
  Match r{0, false, false};
  if (live) r = match(a.key, a.m, a.qhi[c], a.qlo[c]);  // else every word is its "none"
  out[c] = r.found || r.found2 ? p : none;
  out[a.C + c] = r.found ? a.idx[r.lb] : 0;
  out[2 * a.C + c] = r.found2 ? a.idx[r.lb + 1] : 0;
}

__global__ void __launch_bounds__(kThreads) bsgs_summary_kernel(BsgsArgs a, int cand_blocks,
                                                                int32_t* __restrict__ out) {
  if ((int)blockIdx.x < cand_blocks) {
    const int c = blockIdx.x * kThreads + threadIdx.x;
    if (c < a.C) bsgs_candidate(a, c, out);
  } else {
    const int lane = threadIdx.x & 31;
    const int r = (blockIdx.x - cand_blocks) * (kThreads / 32) + (threadIdx.x >> 5);
    if (r < a.R) {
      const uint8_t* row = a.rdeg + (long long)r * a.U;
      int n, first;
      row_flags(row, a.U, rows_aligned(a.rdeg, a.U), lane, n, first);
      if (lane == 0) {
        const bool adv = a.radv[r] != 0;
        if (adv && !row[a.U - 1]) {  // the advance flag marks lane U - 1 too
          n++;
          first = min(first, a.U - 1);
        }
        int32_t* w = out + 3 * a.C;
        w[r] = n;
        w[a.R + r] = first < a.U ? first : 0;
        w[2 * a.R + r] = adv;
      }
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) out[3 * a.C + 3 * a.R] = *a.count;
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

extern "C" int kh_bsgs_summary(const void* pos, const void* qhi, const void* qlo,
                               const void* count, const void* key, const void* idx,
                               const void* cdeg, const void* cadv, const void* rdeg,
                               const void* radv, void* out, long long m, long long B, int C,
                               int R, int U, void* stream) {
  if (C < 0 || R < 0 || U < 1 || B < 1 || B > 0x7FFFFFFFLL || B % U || (key && m < 1))
    return (int)cudaErrorInvalidValue;
  const BsgsArgs a{(const int32_t*)pos, (const uint32_t*)qhi, (const uint32_t*)qlo,
                   (const int32_t*)count, (const long long*)key, (const int32_t*)idx,
                   (const uint8_t*)cdeg, (const uint8_t*)cadv, (const uint8_t*)rdeg,
                   (const uint8_t*)radv, m, B, C, R, U};
  const int cand_blocks = (C + kThreads - 1) / kThreads;
  const int row_blocks = (R + kThreads / 32 - 1) / (kThreads / 32);
  const int blocks = cand_blocks + row_blocks > 0 ? cand_blocks + row_blocks : 1;
  bsgs_summary_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(a, cand_blocks,
                                                                      (int32_t*)out);
  return (int)cudaGetLastError();
}
