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
// Both kernels run blocks of two roles in one launch, the candidates'
// first, and share the survivor's search and the row reduction.
//
// Both are bound by latency at the main paths' shapes, not by bytes or
// operations (kh_lookup_summary: ~2 KB of keys a survivor and 32 KB of
// flags; kh_bsgs_summary: 4 MB of row flags at R = 256, U = 16,384,
// ~1.3 us at 3.35 TB/s), so each spreads its work over the card and
// keeps the dependent reads few:
// - A survivor is searched by a warp, 32-ary: each level reads 32 keys at
//   once and a ballot counts those below the query, so a search takes
//   ceil(log33(m)) + 1 dependent reads (5 at m = 2^22, 6 at 2^28 and 2^30)
//   where the binary search took ceil(log2(m + 1)) (23, 29). Wider levels
//   (kSearchP = 2, 4 keys a lane: 64- and 128-ary) were slower, warm and
//   cold (scripts/torch_cascade_shapes.py and scripts/torch_walker_shapes.py
//   time them, and the binary search). Padding and dead survivors skip the
//   search; the keys and payloads at lb and lb + 1 are then read together,
//   one more round trip.
// - A row of flags is read with one round trip: a group of tpr threads a
//   row (kThreads, fewer down to a warp for short rows, several rows a
//   block), each thread with its kRowLoads 16-byte loads issued before any
//   is tested, then a reduction of the count and the first set lane over
//   the group. So kh_bsgs_summary has all 4 MB in flight at once on 256
//   blocks over the card's 132 SMs (a warp a row on 32 blocks kept 16 KB
//   in flight an SM and took ~8 round trips).
// - The search blocks (a warp a survivor, kWarps a block) come first in the
//   grid, so their chains start first; the row blocks follow. Host resolve
//   searches nothing: a thread a survivor.
// On an H100 (scripts/torch_walker_shapes.py), kh_lookup_summary at C = 256
// over 2^22 keys, W = 8, U = 4,096 takes ~0.0046 ms (0.0070 with a cold
// L2), one survivor and one row ~0.0044: a binary search in each lane on
// the same grid took 0.0069, and the one-block design before (a thread a
// survivor with the binary search, a warp a walker row, on one SM) 0.0089.
// The entry points launch on the given stream, do not synchronise, and
// return cudaGetLastError().
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kWarps = kThreads / 32;
constexpr int kRowLoads = 4;  // 16-byte loads a thread has in flight on a row
constexpr int kSearchP = 1;   // keys a lane reads a level of the warp search (32-ary)

// A survivor's (hi, lo) words as the table's key: bit 63 flipped, so the
// signed order is the unsigned one.
__device__ __forceinline__ long long query_key(uint32_t qhi, uint32_t qlo) {
  return (long long)(((unsigned long long)qhi << 32 | qlo) ^ (1ull << 63));
}

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

// A survivor's key q against the table, by a warp: found = key[lb] == q,
// found2 = key[lb + 1] == q, and the payloads j = idx[lb], j2 = idx[lb + 1]
// (0 past the table), lb the lower bound. The four words are read at once
// (lanes 0-3) after the search.
struct Match {
  bool found, found2;
  int32_t j, j2;
};

__device__ __forceinline__ Match warp_match(const long long* __restrict__ key,
                                            const int32_t* __restrict__ idx, long long m,
                                            long long q, int lane) {
  const long long lb = warp_lower_bound(key, m, q, lane);
  const long long at = lb + (lane & 1);
  long long v = 0;
  if (lane < 4 && at < m) v = lane < 2 ? __ldg(key + at) : (long long)__ldg(idx + at);
  return {lb < m && __shfl_sync(kFull, v, 0) == q, lb + 1 < m && __shfl_sync(kFull, v, 1) == q,
          (int32_t)__shfl_sync(kFull, v, 2), (int32_t)__shfl_sync(kFull, v, 3)};
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

// The group's count and first set lane from its threads' parts, complete
// in the group's first thread (g == 0): warp reductions, then (tpr > 32)
// over the group's warps in shared memory. Every thread of the block calls
// it (tpr is the same for the whole launch).
__device__ __forceinline__ void group_reduce(int tpr, int g, int& n, int& first) {
  __shared__ int s_n[kWarps], s_first[kWarps];
  n = __reduce_add_sync(kFull, n);
  first = __reduce_min_sync(kFull, first);
  if (tpr > 32) {
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) {
      s_n[warp] = n;
      s_first[warp] = first;
    }
    __syncthreads();
    if (g == 0) {
      for (int w = warp + 1; w < warp + tpr / 32; w++) {
        n += s_n[w];
        first = min(first, s_first[w]);
      }
    }
  }
}

// Threads a row group: the fewest, from a warp up, that hold a row of
// U flags in kRowLoads loads each (16 bytes a load when vec, else a byte).
int row_threads(int U, bool vec) {
  const int units = vec ? U / 16 : U;
  int tpr = 32;
  while (tpr < kThreads && tpr * kRowLoads < units) tpr *= 2;
  return tpr;
}

bool rows_aligned(const void* rows, int U) { return U % 16 == 0 && ((uintptr_t)rows & 15) == 0; }

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
  int tpr;   // threads a walker row
  bool vec;  // the rows are 16-byte aligned: 16 bytes a load
};

// Whether a walker survivor is live: a real position whose lane is not
// degenerate. Lanes +u and -u of walker w share deg[w][u - 1], the center
// has no flag; read at min(p, total - 1) mod W*npts, as the JAX code does.
__device__ __forceinline__ bool lookup_live(const LookupArgs& a, int p) {
  const long long npts = 2LL * a.U + 1;
  const long long q = (long long)min(p, a.total - 1) % (a.W * npts);
  const long long w = q / npts, lane = q % npts;
  const bool degenerate = lane < 2LL * a.U && a.deg[w * a.U + (lane < a.U ? lane : lane - a.U)];
  return p < a.total && !degenerate;
}

// Survivor c, a warp: the search where it is live, then its two words
// (the position, the payload at lb; total and 0 where no live hit).
__device__ __forceinline__ void lookup_candidate(const LookupArgs& a, int c, int lane,
                                                 int32_t* __restrict__ out) {
  const int p = a.pos[c];
  int32_t w[2] = {a.total, 0};
  if (lookup_live(a, p)) {  // the same on every lane
    const Match r = warp_match(a.key, a.idx, a.m, query_key(a.qhi[c], a.qlo[c]), lane);
    if (r.found || r.found2) {
      w[0] = p;
      w[1] = r.j;  // idx[min(lb, m - 1)]: a hit has lb < m
    }
  }
  if (lane == 0) {
    out[c] = w[0];
    out[a.C + c] = w[1];
  }
}

// Walkers of block b of the row role, a group of tpr threads each: the
// count, the first set lane (0 when none) and the advance flag.
__device__ __forceinline__ void lookup_rows(const LookupArgs& a, int b,
                                            int32_t* __restrict__ out) {
  const int g = threadIdx.x % a.tpr;
  const int w = b * (kThreads / a.tpr) + threadIdx.x / a.tpr;
  int n = 0, first = a.U;
  bool adv = false;
  if (w < a.W) {
    if (g == 0) adv = __ldg(a.adeg + w) != 0;
    row_part(a.deg + (long long)w * a.U, a.U, a.vec, a.tpr, g, n, first);
  }
  group_reduce(a.tpr, g, n, first);
  if (g == 0 && w < a.W) {
    int32_t* o = out + 2 * a.C;
    o[w] = n;
    o[a.W + w] = first < a.U ? first : 0;
    o[2 * a.W + w] = adv;
  }
}

__global__ void __launch_bounds__(kThreads) lookup_summary_kernel(LookupArgs a, int cand_blocks,
                                                                  int32_t* __restrict__ out) {
  if ((int)blockIdx.x < cand_blocks) {
    const int c = blockIdx.x * kWarps + (threadIdx.x >> 5);
    if (c < a.C) lookup_candidate(a, c, threadIdx.x & 31, out);
  } else {
    lookup_rows(a, blockIdx.x - cand_blocks, out);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) out[2 * a.C + 3 * a.W] = *a.count;
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
  int tpr;   // threads a summary row
  bool vec;  // the rows are 16-byte aligned: 16 bytes a load
};

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

// Device resolve, a warp a survivor.
__device__ __forceinline__ void table_candidate(const BsgsArgs& a, int c, int lane,
                                                int32_t* __restrict__ out) {
  const int p = a.pos[c];
  int32_t w[3] = {(int32_t)a.B, 0, 0};  // every word's "none"
  if (bsgs_live(a, p)) {  // the same on every lane
    const Match r = warp_match(a.key, a.idx, a.m, query_key(a.qhi[c], a.qlo[c]), lane);
    w[0] = r.found || r.found2 ? p : (int32_t)a.B;
    w[1] = r.found ? r.j : 0;
    w[2] = r.found2 ? r.j2 : 0;
  }
  if (lane == 0) {
    out[c] = w[0];
    out[a.C + c] = w[1];
    out[2 * a.C + c] = w[2];
  }
}

// Rows of block b of the row role, a group of tpr threads each.
__device__ __forceinline__ void bsgs_rows(const BsgsArgs& a, int b, int32_t* __restrict__ out) {
  const int g = threadIdx.x % a.tpr;
  const int r = b * (kThreads / a.tpr) + threadIdx.x / a.tpr;
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
  group_reduce(a.tpr, g, n, first);
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
  const bool vec = rows_aligned(deg, U);
  const int tpr = row_threads(U, vec);
  const LookupArgs a{(const int32_t*)pos, (const uint32_t*)qhi, (const uint32_t*)qlo,
                     (const int32_t*)count, (const long long*)key, (const int32_t*)idx,
                     (const uint8_t*)deg, (const uint8_t*)adeg, m, C, W, U, total, tpr, vec};
  const int cand_blocks = (C + kWarps - 1) / kWarps;
  const int rows = kThreads / tpr;  // walkers a block
  const int row_blocks = (W + rows - 1) / rows;
  lookup_summary_kernel<<<cand_blocks + row_blocks, kThreads, 0, (cudaStream_t)stream>>>(
      a, cand_blocks, (int32_t*)out);
  return (int)cudaGetLastError();
}

extern "C" int kh_bsgs_summary(const void* pos, const void* qhi, const void* qlo,
                               const void* count, const void* key, const void* idx,
                               const void* cdeg, const void* cadv, const void* rdeg,
                               const void* radv, void* out, long long m, long long B, int C,
                               int R, int U, void* stream) {
  if (C < 0 || R < 0 || U < 1 || B < 1 || B > 0x7FFFFFFFLL || B % U || (key && m < 1))
    return (int)cudaErrorInvalidValue;
  const bool vec = rows_aligned(rdeg, U);
  const int tpr = row_threads(U, vec);
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
