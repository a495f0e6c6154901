// Filter probe for Hopper (sm_90a):
//   kh_probe           replaces keyhuntm1cpu_tpu/filter/bitmap.py _dma_gather_kernel / dma_gather
//                      (words[idx]) fused with the bit test of probe / probe_bloom2
//   kh_probe_compact   the same probe (level-1 form) fused with the ordered
//                      compaction of its survivors (compact_positions and the
//                      key gathers of filtered_survivors / filtered_lookup)
//   kh_mask_compact    the level-1 compaction of the BSGS chunk, whose probe
//                      runs inside K2 (csrc/pwalk.cu): the ordered compaction
//                      of K2's survivor mask, with the same output as
//                      kh_probe_compact's over the same keys
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
// kProbeThreads * Q keys, counts its survivors with a block scan,
// publishes that count, and finds the survivors before it by a decoupled
// look-back (one warp reads the preceding tiles' status words: a count,
// or the inclusive prefix that ends the walk). Each survivor's rank is
// then exact, so the output is in ascending order, as the JAX package's
// sort-based compaction has it; atomic appends would not be. The keys go
// out from the registers that probed them. The bloom2 stage is the same
// kernel over the C1 stage-1 survivors, their positions loaded beside the
// keys: it replaced a mask, a C1-long cumsum, a searchsorted, the clamps,
// five gathers and the poison's two where()s, about a dozen launches. Its
// bound is bytes (~0.8 us at C1 = 34,816: 65,536 random sectors and the
// survivors); at m = 2^30's C1 = 134,656 its 262,144 random reads take
// ~8.5 us at the card's random-read ceiling. What sets its pace at the
// main path's shape is latency: the key loads, one random read, the
// look-back and the stores, each a DRAM or L2 round trip, and the launch.
// So its tile is small, Q = kStage2Q = 2 keys a thread (256 keys a tile,
// four reads in flight a thread): C1 = 34,816 is 136 tiles on the card's
// 132 SMs, where kProbeQ = 8 gave 34 tiles and left 98 SMs idle; and a
// block takes one tile, by its index, with no ticket. A wider look-back
// (kStage2Window = 4 status words a lane, 128 tiles a step) was slower:
// a step waits for all its tiles to publish
// (scripts/torch_cascade_shapes.py times both). The level-1 form keeps
// kProbeQ = 8 and its persistent grid of ticketed tiles (4,096 tiles of
// 1,024 keys at 4,194,304 queries).
// No memset comes before a launch: the scratch (a ticket and a status
// word a tile) is zero on entry because the launch before it zeroed it.
// The wrapper keeps two scratches a stream and alternates them: each
// launch uses one and, from all its blocks at the start, zeroes the other,
// which the launch before it used and which the launch after it will use.
// Launches on one stream never overlap, so this is safe, and no launch
// waits on an exit counter or clears its own status words at the end.
// kh_mask_compact: K2 probes each key as it emits it and writes a
// survivor mask of 32 positions a word, so the chunk's level-1 stage is
// left with the compaction alone: a 512 KB mask read in order, the
// look-back, and the gathers of ~32,768 survivors' keys from qhi / qlo,
// bound by latency (a few DRAM or L2 round trips). Its tile is
// kMaskCompactQ = 2 mask words a thread, 8,192 positions a block, a block
// a tile by its index as the bloom2 stage's, one status word a lane a
// step of the look-back: 512 tiles at 4,194,304 positions, 0.0066 ms on
// an H100 (700 W) against 0.0074 at 1 word a thread, 0.0069 at 4, 0.0083
// at 8, and 0.0089-0.0111 with 4 status words a lane
// (scripts/torch_fused_probe_shapes.py times them); kh_probe_compact
// took 0.150 ms for the probe and compaction of the same keys.
// Word offsets are 64-bit (a 2^35-bit filter has 2^30 words). The entry
// points launch on the given stream, do not synchronise, and return
// cudaGetLastError().
#include <cuda_runtime.h>

#include <cstdint>

#include "probe.cuh"

namespace {

using kh::ld_word;
using kh::word_of;

// the fused form's keys per thread (level 1; the bloom2 stage's
// kStage2Q) and threads per block (the mask form: one key a thread,
// kMaskThreads a block); scripts/torch_probe_shapes.py builds other values
constexpr int kProbeQ = 8;
constexpr int kStage2Q = 2;
constexpr int kStage2Window = 1;  // status words a lane reads a step of the look-back
constexpr int kMaskCompactQ = 2;  // kh_mask_compact's mask words a thread
constexpr int kMaskCompactWindow = 1;  // and status words a lane a step
constexpr int kProbeThreads = 128;
constexpr int kMaskThreads = 256;
constexpr int kWarps = kProbeThreads / 32;
// keys a block takes at a time
__host__ __device__ constexpr int tile_keys(bool stage2) {
  return (stage2 ? kStage2Q : kProbeQ) * kProbeThreads;
}
// kh_mask_compact's mask words a tile
constexpr int kMaskCompactTile = kMaskCompactQ * kProbeThreads;
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

// Q 32-bit words from p + i0, the first cnt of them (0 past those): 16- or
// 8-byte loads when VEC (the caller checked the alignment) and all Q are
// there.
template <bool VEC, int Q>
__device__ __forceinline__ void load_q(const uint32_t* __restrict__ p, long long i0, int cnt,
                                       uint32_t (&v)[Q]) {
  if constexpr (VEC && Q % 4 == 0) {
    if (cnt == Q) {
#pragma unroll
      for (int j = 0; j < Q; j += 4) {
        const uint4 x = __ldg(reinterpret_cast<const uint4*>(p + i0 + j));
        v[j] = x.x; v[j + 1] = x.y; v[j + 2] = x.z; v[j + 3] = x.w;
      }
      return;
    }
  } else if constexpr (VEC && Q == 2) {
    if (cnt == Q) {
      const uint2 x = __ldg(reinterpret_cast<const uint2*>(p + i0));
      v[0] = x.x; v[1] = x.y;
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < Q; j++) v[j] = j < cnt ? __ldg(p + i0 + j) : 0u;
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
// 32 * W tiles at a time (lane l reads the W status words from tile - 1 -
// W * l on, all issued together), adding counts until a tile whose
// inclusive prefix is published.
template <int W>
__device__ uint32_t look_back(const unsigned long long* status, long long tile, int lane) {
  uint32_t prefix = 0;
  for (long long last = tile - 1;; last -= 32 * W) {
    unsigned long long s[W];
#pragma unroll
    for (int j = 0; j < W; j++) {  // before tile 0: a prefix of 0
      const long long k = last - W * lane - j;
      s[j] = k >= 0 ? ld_status(status + k) : kPrefix;
    }
    for (;;) {  // wait until all are published
      bool wait = false;
#pragma unroll
      for (int j = 0; j < W; j++) wait |= (s[j] >> 32) == 0;
      if (!__any_sync(0xFFFFFFFFu, wait)) break;
      __nanosleep(32);
#pragma unroll
      for (int j = 0; j < W; j++) {
        if ((s[j] >> 32) == 0) s[j] = ld_status(status + last - W * lane - j);
      }
    }
    int near = W;  // this lane's nearest tile with a prefix (W: none)
#pragma unroll
    for (int j = W - 1; j >= 0; j--) {
      if ((s[j] & ~0xFFFFFFFFull) == kPrefix) near = j;
    }
    const uint32_t done = __ballot_sync(0xFFFFFFFFu, near < W);
    const int stop = done ? __ffs(done) - 1 : 31;  // the lane of the nearest prefix
    uint32_t v = 0;
#pragma unroll
    for (int j = 0; j < W; j++) {
      if (lane < stop || (lane == stop && j <= near)) v += (uint32_t)s[j];
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, o);
    prefix += v;
    if (done) return prefix;
  }
}

// Zero the next launch's scratch (from every block of the grid): the
// launch before this one (done, as launches on one stream do not overlap)
// used it.
__device__ __forceinline__ void zero_next(unsigned long long* next, long long words) {
  for (long long k = (long long)blockIdx.x * kProbeThreads + threadIdx.x; k < words;
       k += (long long)gridDim.x * kProbeThreads) {
    next[k] = 0;
  }
}

// A tile's place in the ordered output, from its threads' survivor counts
// c (every thread of the block calls it): the block's exclusive scan of the
// counts, the tile's count published, the survivors of the tiles before
// it by the look-back (warp 0, W status words a lane a step) and its
// inclusive prefix published. Returns this thread's first rank; prefix
// gets the survivors before the tile, agg the tile's own.
template <int W>
__device__ __forceinline__ uint32_t tile_rank(uint32_t c, unsigned long long* status,
                                              long long tile, uint32_t (&s_warp)[kWarps],
                                              uint32_t& s_prefix, uint32_t& prefix,
                                              uint32_t& agg) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  uint32_t incl = c;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(0xFFFFFFFFu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  uint32_t before = 0;
  agg = 0;
#pragma unroll
  for (int w = 0; w < kWarps; w++) {
    const uint32_t x = s_warp[w];
    before += w < warp ? x : 0u;
    agg += x;
  }
  if (warp == 0) {
    uint32_t p = 0;
    if (tile == 0) {
      if (lane == 0) atomicExch(status, kPrefix | agg);
    } else {
      if (lane == 0) atomicExch(status + tile, kCount | agg);
      p = look_back<W>(status, tile, lane);
      if (lane == 0) atomicExch(status + tile, kPrefix | (p + agg));
    }
    if (lane == 0) s_prefix = p;
  }
  __syncthreads();
  prefix = s_prefix;
  return prefix + before + incl - c;
}

// The last tile's padding, once every count is in: entries min(total, C)
// to C - 1 get (fill, the fill key).
__device__ __forceinline__ void pad_tail(int32_t* pos, uint32_t* ohi, uint32_t* olo,
                                         uint32_t total, int C, int32_t fill, uint32_t fill_hi,
                                         uint32_t fill_lo) {
  for (long long k = (long long)min(total, (uint32_t)C) + threadIdx.x; k < C;
       k += kProbeThreads) {
    pos[k] = fill;
    ohi[k] = fill_hi;
    olo[k] = fill_lo;
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
  unsigned long long* scratch;  // zero: [0] the ticket counter (level 1),
  // [1 + t] tile t's status (0: not yet, kCount | count, kPrefix |
  // inclusive prefix)
  unsigned long long* next;  // the next launch's scratch, zeroed here
  long long next_words;
  long long n;
  int bits, C, fill;
};

// Level 1 takes tiles by ticket from a persistent grid (an atomic counter,
// so a tile only ever waits on tiles that running blocks hold); the bloom2
// stage has a block a tile, tile = blockIdx.x (blocks are dispatched in
// index order, so the tiles a block waits on are running or done), which
// spares it the ticket's two atomic round trips.
template <bool VEC, bool STAGE2>
__global__ void __launch_bounds__(kProbeThreads) probe_compact_kernel(const CompactArgs a) {
  constexpr int Q = STAGE2 ? kStage2Q : kProbeQ;
  constexpr int kTile = tile_keys(STAGE2);
  __shared__ long long s_tile;
  __shared__ uint32_t s_warp[kWarps];
  __shared__ uint32_t s_prefix;
  const int t = threadIdx.x;
  const long long n = a.n, n_tiles = (n + kTile - 1) / kTile;
  zero_next(a.next, a.next_words);
  for (int round = 0;; round++) {
    long long tile;
    if constexpr (STAGE2) {
      if (round) break;
      tile = blockIdx.x;
    } else {
      if (t == 0) s_tile = (long long)atomicAdd(a.scratch, 1ull);
      __syncthreads();
      tile = s_tile;
      if (tile >= n_tiles) break;
    }
    const long long i0 = tile * kTile + (long long)t * Q;
    const long long left = n - i0;
    const int cnt = left >= Q ? Q : (left > 0 ? (int)left : 0);
    uint32_t hi[Q], lo[Q], at[Q];  // at: where each survivor's position word comes from
    load_q<VEC>(a.qhi, i0, cnt, hi);
    load_q<VEC>(a.qlo, i0, cnt, lo);
    uint32_t hit;
    if constexpr (STAGE2) {
      load_q<VEC>(reinterpret_cast<const uint32_t*>(a.pos_in), i0, cnt, at);
      hit = probe_keys<true, Q, true>(a.words, hi, lo, cnt, a.bits);
#pragma unroll
      for (int j = 0; j < Q; j++) {
        if (j >= cnt || (int32_t)at[j] >= a.fill) hit &= ~(1u << j);  // stage-1 padding
      }
    } else {
      hit = probe_keys<false, Q, true>(a.words, hi, lo, cnt, a.bits);
#pragma unroll
      for (int j = 0; j < Q; j++) at[j] = (uint32_t)(i0 + j);
    }
    uint32_t prefix, agg;
    uint32_t rank = tile_rank<STAGE2 ? kStage2Window : 1>(__popc(hit), a.scratch + 1, tile,
                                                         s_warp, s_prefix, prefix, agg);
#pragma unroll
    for (int j = 0; j < Q; j++) {
      if ((hit >> j) & 1u) {
        if (rank < (uint32_t)a.C) {
          a.pos[rank] = (int32_t)at[j];
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
      pad_tail(a.pos, a.ohi, a.olo, total, a.C, a.fill, __ldg(a.qhi + n - 1),
               __ldg(a.qlo + n - 1));
    }
    __syncthreads();  // s_tile, s_warp and s_prefix are reused
  }
}

// The mask form's operands (kh_mask_compact): the (rows, W) survivor mask
// of rows * U queries, W = ceil(U / 32) words a row (bit b of word w of
// row r: position r * U + 32 w + b), their keys qhi / qlo, padding = rows *
// U; scratch and next as CompactArgs' (the ticket word unused).
struct MaskArgs {
  const uint32_t* mask;
  const uint32_t* qhi;
  const uint32_t* qlo;
  int32_t* pos;
  uint32_t* ohi;
  uint32_t* olo;
  int32_t* n_out;
  unsigned long long* scratch;
  unsigned long long* next;
  long long next_words;
  uint32_t words;  // rows * W
  int U, W, C;
};

// A block a tile of kMaskCompactQ mask words a thread, tile = blockIdx.x
// (as the bloom2 stage's): the words' survivors counted, ranked by
// tile_rank, and written in ascending position with their keys gathered
// from qhi / qlo, the first C of them.
template <bool VEC>
__global__ void __launch_bounds__(kProbeThreads) mask_compact_kernel(const MaskArgs a) {
  constexpr int Q = kMaskCompactQ;
  __shared__ uint32_t s_warp[kWarps];
  __shared__ uint32_t s_prefix;
  zero_next(a.next, a.next_words);
  const uint32_t n_tiles = (a.words + kMaskCompactTile - 1) / kMaskCompactTile;
  const uint32_t tile = blockIdx.x, k0 = tile * kMaskCompactTile + threadIdx.x * Q;
  const int cnt = k0 + Q <= a.words ? Q : (k0 < a.words ? (int)(a.words - k0) : 0);
  uint32_t m[Q];
  load_q<VEC>(a.mask, k0, cnt, m);
  uint32_t c = 0;
#pragma unroll
  for (int j = 0; j < Q; j++) c += __popc(m[j]);
  uint32_t prefix, agg;
  uint32_t rank = tile_rank<kMaskCompactWindow>(c, a.scratch + 1, tile, s_warp, s_prefix,
                                                prefix, agg);
#pragma unroll
  for (int j = 0; j < Q; j++) {
    uint32_t bits = m[j];
    if (!bits || rank >= (uint32_t)a.C) continue;
    const uint32_t k = k0 + j, r = k / a.W;
    const uint32_t p0 = r * (uint32_t)a.U + (k - r * a.W) * 32u;  // the word's first position
    while (bits && rank < (uint32_t)a.C) {
      const uint32_t p = p0 + __ffs(bits) - 1;
      bits &= bits - 1;
      a.pos[rank] = (int32_t)p;
      a.ohi[rank] = __ldg(a.qhi + p);
      a.olo[rank] = __ldg(a.qlo + p);
      rank++;
    }
  }
  if (tile == n_tiles - 1) {  // every count is in: the total, and the padding
    const uint32_t total = prefix + agg, n = (a.words / a.W) * (uint32_t)a.U;
    if (threadIdx.x == 0) *a.n_out = (int32_t)total;
    pad_tail(a.pos, a.ohi, a.olo, total, a.C, (int32_t)n, __ldg(a.qhi + n - 1),
             __ldg(a.qlo + n - 1));
  }
}

// Level 1: a persistent grid, as many blocks as the card holds at once
// (counted once), each taking tiles until the tickets run out. The bloom2
// stage: a block a tile.
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
  const long long n_tiles = (a.n + tile_keys(STAGE2) - 1) / tile_keys(STAGE2);
  const long long grid = STAGE2 || n_tiles < resident ? n_tiles : resident;
  probe_compact_kernel<VEC, STAGE2><<<(unsigned)grid, kProbeThreads, 0, s>>>(a);
}

// Launch the form the pointers' alignment allows (no memset: the scratch
// is zero on entry).
template <bool STAGE2>
int compact(const CompactArgs& a, cudaStream_t s) {
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(a.qhi) | reinterpret_cast<uintptr_t>(a.qlo) |
                         reinterpret_cast<uintptr_t>(a.pos_in);
  (ptrs & 15u) == 0 ? launch_compact<true, STAGE2>(a, s) : launch_compact<false, STAGE2>(a, s);
  return (int)cudaGetLastError();
}

// kh_mask_compact: a block a tile, with vector loads where the mask allows.
int mask_compact(const MaskArgs& a, cudaStream_t s) {
  const unsigned grid = (a.words + kMaskCompactTile - 1) / kMaskCompactTile;
  if ((reinterpret_cast<uintptr_t>(a.mask) & 15u) == 0) {
    mask_compact_kernel<true><<<grid, kProbeThreads, 0, s>>>(a);
  } else {
    mask_compact_kernel<false><<<grid, kProbeThreads, 0, s>>>(a);
  }
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

// Keys a tile holds, in the level-1 form (form 0) or the bloom2 stage's
// (1), or kh_mask_compact's mask words a tile (2): a compact form's scratch
// is 1 + ceil(n / tile) u64.
extern "C" int kh_probe_tile(int form) {
  return form == 2 ? kMaskCompactTile : tile_keys(form != 0);
}

// scratch: zero on entry (this launch's tickets and status words); next:
// next_words u64 that this launch zeroes, for the next launch on the
// stream (the caller alternates two scratches: each launch uses one and
// clears the other, which the launch before it used).
extern "C" int kh_probe_compact(const void* words, const void* qhi, const void* qlo, void* pos,
                                void* ohi, void* olo, void* n_out, void* scratch, void* next,
                                long long next_words, long long n, int bits, int C,
                                void* stream) {
  if (n < 1 || n > 0x7FFFFFFFLL || C < 0 || bits < 5 || bits > 35 || next_words < 0)
    return (int)cudaErrorInvalidValue;
  const CompactArgs a{(const uint32_t*)words, (const uint32_t*)qhi, (const uint32_t*)qlo,
                      nullptr, nullptr, (int32_t*)pos, (uint32_t*)ohi, (uint32_t*)olo,
                      (int32_t*)n_out, (unsigned long long*)scratch,
                      (unsigned long long*)next, next_words, n, bits, C, (int)n};
  return compact<false>(a, (cudaStream_t)stream);
}

// The level-1 stage of a chunk whose keys K2 probed (csrc/pwalk.cu): the
// ordered compaction of mask, (rows, ceil(U / 32)) u32 survivor words of
// the rows * U keys qhi / qlo; writes what kh_probe_compact writes over
// those keys. scratch and next as kh_probe_compact's.
extern "C" int kh_mask_compact(const void* mask, const void* qhi, const void* qlo, void* pos,
                               void* ohi, void* olo, void* n_out, void* scratch, void* next,
                               long long next_words, long long rows, int U, int C,
                               void* stream) {
  if (rows < 1 || U < 1 || rows * U > 0x7FFFFFFFLL || C < 0 || next_words < 0)
    return (int)cudaErrorInvalidValue;
  const int W = (U + 31) / 32;
  const MaskArgs a{(const uint32_t*)mask, (const uint32_t*)qhi, (const uint32_t*)qlo,
                   (int32_t*)pos, (uint32_t*)ohi, (uint32_t*)olo, (int32_t*)n_out,
                   (unsigned long long*)scratch, (unsigned long long*)next, next_words,
                   (uint32_t)(rows * W), U, W, C};
  return mask_compact(a, (cudaStream_t)stream);
}

// The bloom2 stage over n = C1 stage-1 survivors (pos_in, qhi, qlo, and
// their count n_in), each live where its position is below fill = B;
// scratch and next as kh_probe_compact's.
extern "C" int kh_bloom2_compact(const void* words, const void* qhi, const void* qlo,
                                 const void* pos_in, const void* n_in, void* pos, void* ohi,
                                 void* olo, void* n_out, void* scratch, void* next,
                                 long long next_words, long long n, int bits, int C, int fill,
                                 void* stream) {
  if (n < 1 || n > 0x7FFFFFFFLL || C < 0 || fill < 1 || bits < 5 || bits > 35 ||
      next_words < 0)
    return (int)cudaErrorInvalidValue;
  const CompactArgs a{(const uint32_t*)words, (const uint32_t*)qhi, (const uint32_t*)qlo,
                      (const int32_t*)pos_in, (const int32_t*)n_in, (int32_t*)pos,
                      (uint32_t*)ohi, (uint32_t*)olo, (int32_t*)n_out,
                      (unsigned long long*)scratch, (unsigned long long*)next, next_words, n,
                      bits, C, fill};
  return compact<true>(a, (cudaStream_t)stream);
}
