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
// Blocks of two roles in one launch, the candidates' first.
//
// kh_lookup_summary runs one block a step: thread c searches candidate c (a
// binary search of ceil(log2(m+1)) dependent 8-byte reads; the top levels,
// which every thread reads, hit in L1 and L2), then warp w reduces walker
// w's U flags (16 bytes a lane a load when the rows are 16-byte aligned,
// else a byte a lane). Bound on the H100: the latency of one search (~23
// dependent reads at m = 2^22), not bytes (~2 KB of keys read per
// candidate) nor operations; a cached upper tree of the table would cut
// the dependent DRAM reads.
// kh_bsgs_summary's bound is bytes: 4 MB of row flags at the main path's
// R = 256, U = 16,384 (~1.3 us at 3.35 TB/s). It reads each row with one
// round trip: a group of kThreads threads a row (fewer, down to a warp,
// for short rows, several rows a block), each thread with its
// kRowLoads 16-byte loads issued before any is tested, then a block
// reduction of the count and the first set lane; the lane U - 1 fix-up's
// two bytes are loaded beside them. So all 4 MB are in flight at once on
// 256 blocks over the card's 132 SMs (a warp a row on 32 blocks kept 16 KB
// in flight an SM and took ~8 round trips). The C2 = 1,536 survivors
// (512 real at m = 2^28) are searched in the 2^28-key table a warp each,
// 32-ary: 32 keys read at once a level and a ballot, 6 dependent reads at
// m = 2^28 and 2^30 where the binary search takes 29. Wider levels
// (kSearchP = 2, 4 keys a lane: 5 and 4 reads) were slower, warm and cold
// (scripts/torch_cascade_shapes.py times them). The searches' blocks come
// first in the grid, so their chains start first; padding and dead
// survivors skip the search, and the keys and payloads at lb and lb + 1
// are read together, one more round trip. Host resolve searches nothing:
// a thread a survivor.
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
  int tpr;   // threads a summary row: 32, 64, 128 or kThreads
  bool vec;  // the rows are 16-byte aligned: 16 bytes a load
};

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kWarps = kThreads / 32;
constexpr int kRowLoads = 4;  // 16-byte loads a thread has in flight on a row
constexpr int kSearchP = 1;   // keys a lane reads a level of the warp search (32-ary)

// The lower bound of q in key[0, m), by a warp (every lane passes the same
// q and gets the same answer): each level reads D - 1 = 32 * kSearchP keys
// at once (kSearchP a lane, issued together), splitting the range D ways,
// and ballots count the keys below q (a prefix of the pivots: pivot i is
// lane i / kSearchP's i % kSearchP-th); the last level reads the <= D - 1
// keys left. Every lane computes the pivots' indices, so no shuffle moves
// them.
__device__ __forceinline__ long long warp_lower_bound(const long long* __restrict__ key,
                                                      long long m, long long q, int lane) {
  constexpr int P = kSearchP, D = 32 * P + 1;
  long long lo = 0, hi = m;  // key[lo - 1] < q <= key[hi], where they exist
  while (hi - lo >= D) {
    const long long n = hi - lo;  // pivot i at lo + n * (i + 1) / D, distinct, in [lo, hi)
    bool less[P];
#pragma unroll
    for (int j = 0; j < P; j++) less[j] = __ldg(key + lo + n * (P * lane + j + 1) / D) < q;
    int k = 0;
#pragma unroll
    for (int j = 0; j < P; j++) k += __popc(__ballot_sync(kFull, less[j]));
    const long long base = lo;
    if (k > 0) lo = base + n * k / D + 1;
    if (k < D - 1) hi = base + n * (k + 1) / D;
  }
  bool less[P];
#pragma unroll
  for (int j = 0; j < P; j++) {
    const long long i = lo + P * lane + j;
    less[j] = i < hi && __ldg(key + i) < q;
  }
  int k = 0;
#pragma unroll
  for (int j = 0; j < P; j++) k += __popc(__ballot_sync(kFull, less[j]));
  return lo + k;
}

// Whether survivor c is live: a real position whose lane is not degenerate
// (its flag, or on lane U - 1 its row's advance flag).
__device__ __forceinline__ bool bsgs_live(const BsgsArgs& a, int p) {
  const long long q = min((long long)p, a.B - 1);
  const bool dead = a.cdeg[q] || (q % a.U == a.U - 1 && a.cadv[q / a.U]);
  return p < a.B && !dead;
}

// Host resolve, a thread a survivor: the keys go to the host.
__device__ __forceinline__ void host_candidate(const BsgsArgs& a, int c,
                                               int32_t* __restrict__ out) {
  const int p = a.pos[c];
  out[c] = bsgs_live(a, p) ? p : (int32_t)a.B;
  out[a.C + c] = (int32_t)a.qhi[c];
  out[2 * a.C + c] = (int32_t)a.qlo[c];
}

// Device resolve, a warp a survivor: the 32-ary search, then the keys and
// payloads at lb and lb + 1 read at once (lanes 0-3).
__device__ __forceinline__ void table_candidate(const BsgsArgs& a, int c, int lane,
                                                int32_t* __restrict__ out) {
  const int p = a.pos[c];
  int32_t w[3] = {(int32_t)a.B, 0, 0};  // every word's "none"
  if (bsgs_live(a, p)) {  // the same on every lane
    const long long q = (long long)(((unsigned long long)a.qhi[c] << 32 | a.qlo[c]) ^ (1ull << 63));
    const long long lb = warp_lower_bound(a.key, a.m, q, lane);
    const long long at = lb + (lane & 1);
    long long v = 0;
    if (lane < 4 && at < a.m) v = lane < 2 ? __ldg(a.key + at) : (long long)__ldg(a.idx + at);
    const bool found = lb < a.m && __shfl_sync(kFull, v, 0) == q;
    const bool found2 = lb + 1 < a.m && __shfl_sync(kFull, v, 1) == q;
    const int32_t j = (int32_t)__shfl_sync(kFull, v, 2), j2 = (int32_t)__shfl_sync(kFull, v, 3);
    w[0] = found || found2 ? p : (int32_t)a.B;
    w[1] = found ? j : 0;
    w[2] = found2 ? j2 : 0;
  }
  if (lane == 0) {
    out[c] = w[0];
    out[a.C + c] = w[1];
    out[2 * a.C + c] = w[2];
  }
}

// The set count and first set lane of a group's row, this thread's part:
// kRowLoads loads issued before any is tested (16 bytes each when vec,
// else a byte each).
__device__ __forceinline__ void row_part(const uint8_t* __restrict__ row, int U, bool vec,
                                         int tpr, int g, int& n, int& first) {
  if (vec) {
    const uint4* v = reinterpret_cast<const uint4*>(row);
    const int nv = U / 16;
    for (int k0 = g; k0 < nv; k0 += kRowLoads * tpr) {
      uint4 x[kRowLoads];
#pragma unroll
      for (int j = 0; j < kRowLoads; j++) {
        const int k = k0 + j * tpr;
        x[j] = k < nv ? __ldg(v + k) : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int j = 0; j < kRowLoads; j++) {
        const uint32_t words[4] = {x[j].x, x[j].y, x[j].z, x[j].w};
#pragma unroll
        for (int i = 0; i < 4; i++) {
          const uint32_t nz = __vcmpne4(words[i], 0u);  // 0xFF per non-zero byte
          n += __popc(nz) >> 3;
          if (nz) first = min(first, 16 * (k0 + j * tpr) + 4 * i + ((__ffs(nz) - 1) >> 3));
        }
      }
    }
  } else {
    for (int k0 = g; k0 < U; k0 += kRowLoads * tpr) {
      uint8_t x[kRowLoads];
#pragma unroll
      for (int j = 0; j < kRowLoads; j++) {
        const int k = k0 + j * tpr;
        x[j] = k < U ? __ldg(row + k) : 0;
      }
#pragma unroll
      for (int j = 0; j < kRowLoads; j++) {
        if (x[j]) {
          n++;
          first = min(first, k0 + j * tpr);
        }
      }
    }
  }
}

// Rows of block b of the row role: kThreads / tpr of them, a group of tpr
// threads each; the group's count and first set lane by warp reductions,
// then (tpr > 32) over the group's warps in shared memory.
__device__ __forceinline__ void bsgs_rows(const BsgsArgs& a, int b, int32_t* __restrict__ out) {
  __shared__ int s_n[kWarps], s_first[kWarps];
  const int grp = threadIdx.x / a.tpr, g = threadIdx.x % a.tpr;
  const int r = b * (kThreads / a.tpr) + grp;
  int n = 0, first = a.U;
  bool adv = false, last = false;
  if (r < a.R) {
    const uint8_t* row = a.rdeg + (long long)r * a.U;
    if (g == 0) {  // the fix-up's bytes, read beside the row
      adv = __ldg(a.radv + r) != 0;
      last = __ldg(row + a.U - 1) != 0;
    }
    row_part(row, a.U, a.vec, a.tpr, g, n, first);
  }
  n = __reduce_add_sync(kFull, n);
  first = __reduce_min_sync(kFull, first);
  if (a.tpr > 32) {  // block-uniform
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) {
      s_n[warp] = n;
      s_first[warp] = first;
    }
    __syncthreads();
    if (g == 0) {
      for (int w = warp + 1; w < warp + a.tpr / 32; w++) {
        n += s_n[w];
        first = min(first, s_first[w]);
      }
    }
  }
  if (g == 0 && r < a.R) {
    if (adv && !last) {  // the advance flag marks lane U - 1 too
      n++;
      first = min(first, a.U - 1);
    }
    int32_t* w = out + 3 * a.C;
    w[r] = n;
    w[a.R + r] = first < a.U ? first : 0;
    w[2 * a.R + r] = adv;
  }
}

__global__ void __launch_bounds__(kThreads) bsgs_summary_kernel(BsgsArgs a, int cand_blocks,
                                                                int32_t* __restrict__ out) {
  if ((int)blockIdx.x < cand_blocks) {
    if (a.key == nullptr) {
      const int c = blockIdx.x * kThreads + threadIdx.x;
      if (c < a.C) host_candidate(a, c, out);
    } else {
      const int c = blockIdx.x * kWarps + (threadIdx.x >> 5);
      if (c < a.C) table_candidate(a, c, threadIdx.x & 31, out);
    }
  } else {
    bsgs_rows(a, blockIdx.x - cand_blocks, out);
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
  const bool vec = U % 16 == 0 && ((uintptr_t)rdeg & 15) == 0;
  const int units = vec ? U / 16 : U;  // loads a row
  int tpr = 32;
  while (tpr < kThreads && tpr * kRowLoads < units) tpr *= 2;
  const BsgsArgs a{(const int32_t*)pos, (const uint32_t*)qhi, (const uint32_t*)qlo,
                   (const int32_t*)count, (const long long*)key, (const int32_t*)idx,
                   (const uint8_t*)cdeg, (const uint8_t*)cadv, (const uint8_t*)rdeg,
                   (const uint8_t*)radv, m, B, C, R, U, tpr, vec};
  const int per_block = key ? kWarps : kThreads;  // survivors a block
  const int cand_blocks = (C + per_block - 1) / per_block;
  const int rows = kThreads / tpr;  // rows a block
  const int row_blocks = (R + rows - 1) / rows;
  const int blocks = cand_blocks + row_blocks > 0 ? cand_blocks + row_blocks : 1;
  bsgs_summary_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(a, cand_blocks,
                                                                      (int32_t*)out);
  return (int)cudaGetLastError();
}
