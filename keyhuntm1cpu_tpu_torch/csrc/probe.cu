// Filter probe for Hopper (sm_90a):
//   kh_probe           replaces keyhuntm1cpu_tpu/filter/bitmap.py _dma_gather_kernel / dma_gather
//                      (words[idx]) fused with the bit test of probe / probe_bloom2
//   kh_probe_compact   the same probe (level-1 form) fused with the ordered
//                      compaction of its survivors (compact_positions and the
//                      key gathers of filtered_survivors / filtered_lookup)
//   kh_bloom2_compact  the cascade's bloom2 stage: the bloom2 probe of the C1
//                      stage-1 survivors fused with their ordered compaction
//                      to C2 (keyhuntm1cpu_tpu/filter/bitmap.py filtered_lookup
//                      :721 and filtered_survivors :788 after the level-1
//                      compaction: the probe, the pos1 < B mask, the count,
//                      jnp.nonzero, the clamps and gathers, the poison)
// Wrappers and plain torch versions: keyhuntm1cpu_tpu_torch/filter/bitmap.py.
//
// For each 64-bit key (qhi, qlo) the probe reads the filter word(s) the key
// maps to and tests the key's bit: the level-1 direct-address bitmap (the
// key's low bits_log2 bits), or, in bloom2 form, both of its k = 2 hashed
// bits (fmix32 mixes of the key, with index-extension mixes past 2^32
// bits). Index math is bitmap.py's, bit for bit. kh_probe writes one mask
// byte a key. kh_probe_compact writes the first C survivor positions in
// ascending order with their keys, padded with (n, the last key), and the
// true survivor count. kh_bloom2_compact takes the C1 stage-1 survivors
// (positions, keys, count; an entry is live where its position is below
// the query count B), and writes the first C2 bloom2 survivors' positions
// and keys in ascending order, padded with (B, stage-1 entry C1 - 1's key),
// and their count, poisoned to n1 + C2 where the stage-1 count n1 passed
// C1 (one overflow check then covers both stages).
//
// Bound on the H100: memory. Each probe reads one random word of a filter
// far larger than the 50 MB L2 (2^34 and 2^35 bits: 2 and 4 GiB), and DRAM
// serves at least one 32-byte sector per random read. The card's ceiling
// for such reads, measured by scripts/torch_probe_shapes.py (a gather that
// does nothing else, 1 to 16 reads in flight a thread), is ~31 G reads/s
// at 2^34 and 2^35 bits (0.136 ms for 4,194,304 reads), about a third of
// the bytes bound at one sector a read; reads in flight beyond one a
// thread gained that gather 8 %. The TPU kernel kept many reads in flight
// by issuing one 4-byte DMA per query from a scalar loop; here the mask
// form runs one thread per key (at the 34,816 and 131,088 keys it serves,
// more keys a thread left SMs idle), and the fused form has each thread
// take kProbeQ consecutive keys, load them as 16-byte vectors and issue
// all its word reads before it tests any.
// The compaction: the level-1 stage of the BSGS cascade used to write a
// 4 MB mask, then run a cumsum over all 4,194,304 queries, a searchsorted
// of C1 = 34,816 ranks and three gathers. Here a block takes a tile of
// kProbeThreads * kProbeQ keys by ticket (an atomic counter, so a tile
// only ever waits on tiles that running blocks hold), counts its survivors
// with a block scan, publishes that count, and finds the survivors before
// it by a decoupled look-back (one warp reads the 32 preceding tiles'
// status words: a count, or the inclusive prefix that ends the walk). Each
// survivor's rank is then exact, so the output is in ascending order, as
// the JAX package's sort-based compaction has it; atomic appends would not
// be. The keys go out from the registers that probed them. The bloom2
// stage is the same kernel over the C1 = 34,816 stage-1 survivors (34
// tiles at the main path's shape), their positions loaded beside the keys:
// it replaced a mask, a C1-long cumsum, a searchsorted, the clamps, five
// gathers and the poison's two where()s, about a dozen launches.
// Word offsets are 64-bit (a 2^35-bit filter has 2^30 words). The entry
// points launch on the given stream, do not synchronise, and return
// cudaGetLastError().
#include <cuda_runtime.h>

#include <cstdint>

namespace {

// the fused form's keys per thread and threads per block (the mask form:
// one key a thread, kMaskThreads a block); scripts/torch_probe_shapes.py
// builds other values
constexpr int kProbeQ = 8;
constexpr int kProbeThreads = 128;
constexpr int kMaskThreads = 256;
constexpr int kTile = kProbeQ * kProbeThreads;  // keys a block takes at a time
constexpr int kWarps = kProbeThreads / 32;
constexpr unsigned long long kCount = 1ull << 32;   // status: the tile's own count
constexpr unsigned long long kPrefix = 2ull << 32;  // status: the inclusive prefix

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// One filter word through the read-only path; with NO_L1 not kept in L1
// (the reads have no reuse: the fused form at 4,194,304 keys ran 2.6 %
// faster so, but the mask form at 131,088 keys 40 % slower, so it keeps
// __ldg; scripts/torch_probe_shapes.py times both).
template <bool NO_L1>
__device__ __forceinline__ uint32_t ld_word(const uint32_t* p) {
  if constexpr (NO_L1) {
    uint32_t v;
    asm("ld.global.nc.L1::no_allocate.u32 %0, [%1];" : "=r"(v) : "l"(p));
    return v;
  } else {
    return __ldg(p);
  }
}

// Word and bit of bit (ext:h) mod 2^bits: word = low bits of ext:h >> 5,
// bit = h & 31 (bitmap.py _low_bits_index).
__device__ __forceinline__ unsigned long long word_of(uint32_t h, uint32_t ext, int bits) {
  if (bits > 32) {
    const uint32_t emask = (1u << (bits - 32)) - 1u;
    return (unsigned long long)(h >> 5) | ((unsigned long long)(ext & emask) << 27);
  }
  return (bits == 32 ? h : (h & ((1u << bits) - 1u))) >> 5;
}

// The kProbeQ keys from i0 (those below n): 16-byte loads when VEC (the
// caller checked the alignment) and the chunk is whole. Returns how many.
template <bool VEC>
__device__ __forceinline__ int load_keys(const uint32_t* __restrict__ qhi,
                                         const uint32_t* __restrict__ qlo, long long i0,
                                         long long n, uint32_t (&hi)[kProbeQ],
                                         uint32_t (&lo)[kProbeQ]) {
  const long long left = n - i0;
  const int cnt = left >= kProbeQ ? kProbeQ : (left > 0 ? (int)left : 0);
  if (VEC && kProbeQ % 4 == 0 && cnt == kProbeQ) {
#pragma unroll
    for (int j = 0; j < kProbeQ; j += 4) {
      const uint4 h = __ldg(reinterpret_cast<const uint4*>(qhi + i0 + j));
      const uint4 l = __ldg(reinterpret_cast<const uint4*>(qlo + i0 + j));
      hi[j] = h.x; hi[j + 1] = h.y; hi[j + 2] = h.z; hi[j + 3] = h.w;
      lo[j] = l.x; lo[j + 1] = l.y; lo[j + 2] = l.z; lo[j + 3] = l.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kProbeQ; j++) {
      hi[j] = j < cnt ? __ldg(qhi + i0 + j) : 0u;
      lo[j] = j < cnt ? __ldg(qlo + i0 + j) : 0u;
    }
  }
  return cnt;
}

// Bit j of the result: key j (j < cnt) passes the filter. Every word read
// is issued before any is tested.
template <bool BLOOM2, int Q, bool NO_L1>
__device__ __forceinline__ uint32_t probe_keys(const uint32_t* __restrict__ words,
                                               const uint32_t (&hi)[Q], const uint32_t (&lo)[Q],
                                               int cnt, int bits) {
  constexpr int R = BLOOM2 ? 2 : 1;  // reads per key
  uint32_t w[R * Q], b[R * Q];
#pragma unroll
  for (int j = 0; j < Q; j++) {
    uint32_t h[R], e[R];
    if constexpr (BLOOM2) {
      h[0] = fmix32(lo[j] ^ (hi[j] * 0x9E3779B1u) ^ 0x2545F491u);
      h[1] = fmix32(hi[j] ^ (lo[j] * 0x85EBCA77u) ^ 0x633D9ABDu);
      e[0] = e[1] = 0;
      if (bits > 32) {  // index-extension mixes (bitmap.bloom2_ext_hashes)
        e[0] = fmix32(hi[j] ^ (lo[j] * 0xC2B2AE3Du) ^ 0x27D4EB2Fu);
        e[1] = fmix32(lo[j] ^ (hi[j] * 0x165667B1u) ^ 0x9E3779B9u);
      }
    } else {
      h[0] = lo[j];  // direct address: the key's low bits
      e[0] = hi[j];
    }
#pragma unroll
    for (int r = 0; r < R; r++) {
      b[R * j + r] = h[r] & 31u;
      w[R * j + r] = j < cnt ? ld_word<NO_L1>(words + word_of(h[r], e[r], bits)) : 0u;
    }
  }
  uint32_t hit = 0;
#pragma unroll
  for (int j = 0; j < Q; j++) {
    uint32_t all = 1u;
#pragma unroll
    for (int r = 0; r < R; r++) all &= w[R * j + r] >> b[R * j + r];
    hit |= (all & 1u) << j;
  }
  return hit;
}

template <bool BLOOM2>
__global__ void __launch_bounds__(kMaskThreads)
probe_kernel(const uint32_t* __restrict__ words, const uint32_t* __restrict__ qhi,
             const uint32_t* __restrict__ qlo, uint8_t* __restrict__ mask, long long n,
             int bits) {
  const long long i = (long long)blockIdx.x * kMaskThreads + threadIdx.x;
  if (i >= n) return;
  const uint32_t hi[1] = {__ldg(qhi + i)}, lo[1] = {__ldg(qlo + i)};
  mask[i] = (uint8_t)probe_keys<BLOOM2, 1, false>(words, hi, lo, 1, bits);
}

__device__ __forceinline__ unsigned long long ld_status(const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

// The survivors of the tiles before `tile` (warp 0, every lane): walks back
// 32 tiles at a time, adding counts until a tile whose inclusive prefix is
// published.
__device__ uint32_t look_back(const unsigned long long* status, long long tile, int lane) {
  uint32_t prefix = 0;
  for (long long last = tile - 1;; last -= 32) {
    const long long k = last - lane;
    unsigned long long s = k >= 0 ? ld_status(status + k) : kPrefix;  // before tile 0: 0
    while (__any_sync(0xFFFFFFFFu, (s >> 32) == 0)) {  // wait until all 32 are published
      __nanosleep(32);
      if ((s >> 32) == 0) s = ld_status(status + k);
    }
    const uint32_t done = __ballot_sync(0xFFFFFFFFu, (s & ~0xFFFFFFFFull) == kPrefix);
    const int stop = done ? __ffs(done) - 1 : 31;  // the nearest tile with a prefix
    uint32_t v = lane <= stop ? (uint32_t)s : 0u;
#pragma unroll
    for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, o);
    prefix += v;
    if (done) return prefix;
  }
}

// The compaction's operands. Level 1 (kh_probe_compact): the n query keys
// against the bitmap, a survivor written at its own index, padding = n.
// The bloom2 stage (kh_bloom2_compact): the n = C1 stage-1 survivors against
// the bloom2, entry i live where pos_in[i] < fill and written at pos_in[i],
// padding = fill; its count poisoned where the stage-1 count *n_in passed n.
struct CompactArgs {
  const uint32_t* words;
  const uint32_t* qhi;
  const uint32_t* qlo;
  const int32_t* pos_in;  // the bloom2 stage only
  const int32_t* n_in;    // the bloom2 stage only
  int32_t* pos;
  uint32_t* ohi;
  uint32_t* olo;
  int32_t* n_out;
  unsigned long long* scratch;  // [0] the ticket counter, [1 + t] tile t's
  // status (0: not yet, kCount | count, kPrefix | inclusive prefix); zeroed
  // before the launch
  long long n;
  int bits, C, fill;
};

// The kProbeQ stage-1 positions from i0 (the first cnt of them), as
// load_keys loads the keys.
template <bool VEC>
__device__ __forceinline__ void load_positions(const int32_t* __restrict__ p, long long i0,
                                               int cnt, int32_t (&at)[kProbeQ]) {
  if (VEC && kProbeQ % 4 == 0 && cnt == kProbeQ) {
#pragma unroll
    for (int j = 0; j < kProbeQ; j += 4) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(p + i0 + j));
      at[j] = v.x; at[j + 1] = v.y; at[j + 2] = v.z; at[j + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kProbeQ; j++) at[j] = j < cnt ? __ldg(p + i0 + j) : 0;
  }
}

template <bool VEC, bool STAGE2>
__global__ void __launch_bounds__(kProbeThreads) probe_compact_kernel(const CompactArgs a) {
  __shared__ long long s_tile;
  __shared__ uint32_t s_warp[kWarps];
  __shared__ uint32_t s_prefix;
  unsigned long long* status = a.scratch + 1;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const long long n = a.n, n_tiles = (n + kTile - 1) / kTile;
  for (;;) {
    if (t == 0) s_tile = (long long)atomicAdd(a.scratch, 1ull);
    __syncthreads();
    const long long tile = s_tile;
    if (tile >= n_tiles) return;
    const long long i0 = tile * kTile + (long long)t * kProbeQ;
    uint32_t hi[kProbeQ], lo[kProbeQ];
    int32_t at[kProbeQ];  // where each survivor's position word comes from
    const int cnt = load_keys<VEC>(a.qhi, a.qlo, i0, n, hi, lo);
    uint32_t hit;
    if constexpr (STAGE2) {
      load_positions<VEC>(a.pos_in, i0, cnt, at);
      hit = probe_keys<true, kProbeQ, true>(a.words, hi, lo, cnt, a.bits);
#pragma unroll
      for (int j = 0; j < kProbeQ; j++) {
        if (j >= cnt || at[j] >= a.fill) hit &= ~(1u << j);  // stage-1 padding
      }
    } else {
      hit = probe_keys<false, kProbeQ, true>(a.words, hi, lo, cnt, a.bits);
#pragma unroll
      for (int j = 0; j < kProbeQ; j++) at[j] = (int32_t)(i0 + j);
    }
    // the block's exclusive scan of the threads' survivor counts
    const uint32_t c = __popc(hit);
    uint32_t incl = c;
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
    if (warp == 0) {
      uint32_t prefix = 0;
      if (tile == 0) {
        if (lane == 0) atomicExch(status, kPrefix | agg);
      } else {
        if (lane == 0) atomicExch(status + tile, kCount | agg);
        prefix = look_back(status, tile, lane);
        if (lane == 0) atomicExch(status + tile, kPrefix | (prefix + agg));
      }
      if (lane == 0) s_prefix = prefix;
    }
    __syncthreads();
    const uint32_t prefix = s_prefix;
    uint32_t rank = prefix + before + incl - c;
#pragma unroll
    for (int j = 0; j < kProbeQ; j++) {
      if ((hit >> j) & 1u) {
        if (rank < (uint32_t)a.C) {
          a.pos[rank] = at[j];
          a.ohi[rank] = hi[j];
          a.olo[rank] = lo[j];
        }
        rank++;
      }
    }
    if (tile == n_tiles - 1) {  // every count is in: the total, and the padding
      const uint32_t total = prefix + agg;
      if (t == 0) {
        int32_t out = (int32_t)total;
        if constexpr (STAGE2) {  // a stage-1 overflow trips the caller's check too
          const int32_t n1 = *a.n_in;
          if (n1 > n) out = (int32_t)((uint32_t)n1 + (uint32_t)a.C);
        }
        *a.n_out = out;
      }
      const uint32_t fill_hi = __ldg(a.qhi + n - 1), fill_lo = __ldg(a.qlo + n - 1);
      for (long long k = (long long)min(total, (uint32_t)a.C) + t; k < a.C; k += kProbeThreads) {
        a.pos[k] = a.fill;
        a.ohi[k] = fill_hi;
        a.olo[k] = fill_lo;
      }
    }
    __syncthreads();  // s_tile, s_warp and s_prefix are reused
  }
}

// A persistent grid: as many blocks as the card holds at once (counted
// once), each taking tiles until the tickets run out.
template <bool VEC, bool STAGE2>
void launch_compact(const CompactArgs& a, cudaStream_t s) {
  static int resident = 0;
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, probe_compact_kernel<VEC, STAGE2>,
                                                  kProbeThreads, 0);
    resident = sms * (per_sm > 0 ? per_sm : 1);
  }
  const long long n_tiles = (a.n + kTile - 1) / kTile;
  probe_compact_kernel<VEC, STAGE2>
      <<<(unsigned)(n_tiles < resident ? n_tiles : resident), kProbeThreads, 0, s>>>(a);
}

// Zero the scratch, then launch the form the pointers' alignment allows.
template <bool STAGE2>
int compact(const CompactArgs& a, cudaStream_t s) {
  const long long n_tiles = (a.n + kTile - 1) / kTile;
  const cudaError_t rc = cudaMemsetAsync(a.scratch, 0, (size_t)(1 + n_tiles) * 8, s);
  if (rc != cudaSuccess) return (int)rc;
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(a.qhi) | reinterpret_cast<uintptr_t>(a.qlo) |
                         reinterpret_cast<uintptr_t>(a.pos_in);
  (ptrs & 15u) == 0 ? launch_compact<true, STAGE2>(a, s) : launch_compact<false, STAGE2>(a, s);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int kh_probe(const void* words, const void* qhi, const void* qlo, void* mask,
                        long long n, int bits, int bloom2, void* stream) {
  if (n < 1 || bits < 5 || bits > 35) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((n + kMaskThreads - 1) / kMaskThreads);
  cudaStream_t s = (cudaStream_t)stream;
  if (bloom2) {
    probe_kernel<true><<<blocks, kMaskThreads, 0, s>>>(
        (const uint32_t*)words, (const uint32_t*)qhi, (const uint32_t*)qlo, (uint8_t*)mask, n,
        bits);
  } else {
    probe_kernel<false><<<blocks, kMaskThreads, 0, s>>>(
        (const uint32_t*)words, (const uint32_t*)qhi, (const uint32_t*)qlo, (uint8_t*)mask, n,
        bits);
  }
  return (int)cudaGetLastError();
}

// Keys a tile holds: the compact form's scratch is 1 + ceil(n / tile) u64.
extern "C" int kh_probe_tile() { return kTile; }

extern "C" int kh_probe_compact(const void* words, const void* qhi, const void* qlo, void* pos,
                                void* ohi, void* olo, void* n_out, void* scratch, long long n,
                                int bits, int C, void* stream) {
  if (n < 1 || n > 0x7FFFFFFFLL || C < 0 || bits < 5 || bits > 35)
    return (int)cudaErrorInvalidValue;
  const CompactArgs a{(const uint32_t*)words, (const uint32_t*)qhi, (const uint32_t*)qlo,
                      nullptr, nullptr, (int32_t*)pos, (uint32_t*)ohi, (uint32_t*)olo,
                      (int32_t*)n_out, (unsigned long long*)scratch, n, bits, C, (int)n};
  return compact<false>(a, (cudaStream_t)stream);
}

// The bloom2 stage over n = C1 stage-1 survivors (pos_in, qhi, qlo, and
// their count n_in), each live where its position is below fill = B.
extern "C" int kh_bloom2_compact(const void* words, const void* qhi, const void* qlo,
                                 const void* pos_in, const void* n_in, void* pos, void* ohi,
                                 void* olo, void* n_out, void* scratch, long long n, int bits,
                                 int C, int fill, void* stream) {
  if (n < 1 || n > 0x7FFFFFFFLL || C < 0 || fill < 1 || bits < 5 || bits > 35)
    return (int)cudaErrorInvalidValue;
  const CompactArgs a{(const uint32_t*)words, (const uint32_t*)qhi, (const uint32_t*)qlo,
                      (const int32_t*)pos_in, (const int32_t*)n_in, (int32_t*)pos,
                      (uint32_t*)ohi, (uint32_t*)olo, (int32_t*)n_out,
                      (unsigned long long*)scratch, n, bits, C, fill};
  return compact<true>(a, (cudaStream_t)stream);
}
