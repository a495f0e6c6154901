// Minikey kernels for Hopper (sm_90a):
//   K5 kh_minikey_valid          replaces keyhuntm1cpu_tpu/hash/pminikey.py
//                                _minikey_valid_kernel
//   kh_minikey_compact_keys      replaces the XLA compaction and key derivation
//                                of keyhuntm1cpu_tpu/engine/minikeys.py:458-479
//                                (valid.sum, compact_positions_dense, sha256)
// Wrappers and plain torch versions: keyhuntm1cpu_tpu_torch/hash/pminikey.py.
//
// A minikey is 'S' + 16 prefix characters + 5 counter digits (22 bytes); the
// host packs the padded SHA-256 block of the 22-byte message (key) and of the
// 23-byte message + '?' (validity) with the digit bytes 17..21 zeroed, and
// each lane ORs its digits into message words 4 and 5. The alphabet reaches
// the kernel as its runs of consecutive ASCII codes (pminikey.b58_runs), by
// value, so a custom -8 alphabet costs nothing but a longer select loop.
//
// Bound on the H100: 32-bit integer issue. K5 is one SHA-256 compression
// (~1400 instructions) per lane over B = 2^23 lanes and writes one byte per
// lane; the digits are a division by the constant 58 (a multiply-high) and a
// few selects. The design keeps everything in registers, reads the 16 block
// words through the read-only path and writes a byte mask (8 MiB at 2^23).
//
// kh_minikey_compact_keys reads that mask once and writes the exact count
// of valid lanes, the first V valid lanes in ascending order (fill B) and
// their private keys sha256(minikey) as (8, V) limbs (a fill slot hashes
// lane B - 1). Its bound is the larger of the mask's bytes (8 MiB, 2.5 us)
// and V compressions (~3 us): at a density of 2^-8 a tile of 16,384 lanes
// holds ~64 valid ones. The port used to run this as torch ops (a sum, a
// cumsum over B, a searchsorted of V ranks, a where) and then one thread a
// compacted lane. Here a block takes a tile by ticket, turns each thread's 64
// mask bytes (four 16-byte loads) into a 64-bit word of flags, ranks them by
// a block scan of their popcounts, finds the valid lanes before its tile by
// the decoupled look-back of csrc/probe.cu (one warp reads the 32 preceding
// tiles' status words), then hashes its valid lanes whose rank is below V,
// one lane a thread in rounds of a block's width, and writes each at its
// rank. The last tile writes the count and the fill slots, whose one hash it
// computes once. scripts/torch_filter_shapes.py times other tile widths.
// Each entry point launches on the given stream, does not synchronise, and
// returns cudaGetLastError().
#include <cuda_runtime.h>

#include "hash.cuh"

namespace {

constexpr int kMaxRuns = 58;
constexpr int kThreads = 256;
// kh_minikey_compact_keys: threads a block and mask bytes a thread (one
// 64-bit word of flags); scripts/torch_filter_shapes.py builds other widths
constexpr int kCkThreads = 256;
constexpr int kCkLanes = 64;
constexpr int kCkTile = kCkThreads * kCkLanes;  // lanes a block takes at a time
constexpr int kCkWarps = kCkThreads / 32;
constexpr unsigned long long kCount = 1ull << 32;   // status: the tile's own count
constexpr unsigned long long kPrefix = 2ull << 32;  // status: the inclusive prefix

// Digit d in [lo[r], hi[r]] maps to the character d + off[r] (mod 2^32).
struct Runs {
  int n;
  int lo[kMaxRuns];
  int hi[kMaxRuns];
  uint32_t off[kMaxRuns];
};

__device__ __forceinline__ uint32_t b58_char(uint32_t d, const Runs& runs) {
  uint32_t c = 0;
  for (int r = 0; r < runs.n; r++) {
    if (d >= (uint32_t)runs.lo[r] && d <= (uint32_t)runs.hi[r]) c = d + runs.off[r];
  }
  return c;
}

// Load the 16 block words and OR in the five digit characters of counter v
// (most significant digit first at byte 17).
__device__ __forceinline__ void message_words(const uint32_t* __restrict__ base, uint32_t v,
                                              const Runs& runs, uint32_t (&w)[16]) {
#pragma unroll
  for (int j = 0; j < 16; j++) w[j] = __ldg(base + j);
  uint32_t ch[5];
#pragma unroll
  for (int i = 4; i >= 0; i--) {
    const uint32_t q = v / 58u;
    ch[i] = b58_char(v - q * 58u, runs);
    v = q;
  }
  w[4] |= (ch[0] << 16) | (ch[1] << 8) | ch[2];
  w[5] |= (ch[3] << 24) | (ch[4] << 16);
}

// K5: one thread per lane; mask[i] = sha256(block of base_lo + i)[0] == 0.
__global__ void __launch_bounds__(kThreads)
minikey_valid_kernel(const uint32_t* __restrict__ w23, uint8_t* __restrict__ mask,
                     uint32_t base_lo, long long B, const __grid_constant__ Runs runs) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= B) return;
  uint32_t w[16], st[8];
  message_words(w23, base_lo + (uint32_t)i, runs, w);
  kh::sha256_init(st);
  kh::sha256_compress(st, w);
  mask[i] = (st[0] >> 24) == 0 ? 1 : 0;
}

// The message of counter base_lo + lane, hashed: the private key's digest.
__device__ __forceinline__ void minikey_digest(const uint32_t* __restrict__ w22, uint32_t v,
                                               const Runs& runs, uint32_t (&st)[8]) {
  uint32_t w[16];
  message_words(w22, v, runs, w);
  kh::sha256_init(st);
  kh::sha256_compress(st, w);
}

// Bit j: mask byte i0 + j is set (bytes past B read as 0). VEC: the 64
// bytes are in range and 16-byte aligned.
__device__ __forceinline__ unsigned long long load_flags(const uint8_t* __restrict__ valid,
                                                         long long i0, long long B, bool vec) {
  unsigned long long f = 0;
  if (vec && i0 + kCkLanes <= B) {
    const uint4* p = reinterpret_cast<const uint4*>(valid + i0);
#pragma unroll
    for (int q = 0; q < kCkLanes / 16; q++) {
      const uint4 v = __ldg(p + q);
      const uint32_t x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int h = 0; h < 4; h++)  // four 0/1 bytes -> four bits, byte 0 lowest
        f |= (unsigned long long)(((x[h] & 0x01010101u) * 0x01020408u) >> 24)
             << (16 * q + 4 * h);
    }
  } else {
    for (int j = 0; j < kCkLanes; j++)
      if (i0 + j < B && valid[i0 + j]) f |= 1ull << j;
  }
  return f;
}

__device__ __forceinline__ unsigned long long ld_status(const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

// The valid lanes of the tiles before `tile` (warp 0, every lane): walks back
// 32 tiles at a time, adding counts until a tile whose inclusive prefix is
// published (csrc/probe.cu look_back).
__device__ uint32_t look_back(const unsigned long long* status, long long tile, int lane) {
  uint32_t prefix = 0;
  for (long long last = tile - 1;; last -= 32) {
    const long long j = last - lane;
    unsigned long long s = j >= 0 ? ld_status(status + j) : kPrefix;  // before tile 0: 0
    while (__any_sync(0xFFFFFFFFu, (s >> 32) == 0)) {  // wait until all 32 are published
      __nanosleep(32);
      if ((s >> 32) == 0) s = ld_status(status + j);
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

// scratch: [0] the ticket counter, [1 + t] tile t's status (0: not yet,
// kCount | count, kPrefix | inclusive prefix); zeroed before the launch.
__global__ void __launch_bounds__(kCkThreads)
minikey_compact_keys_kernel(const uint8_t* __restrict__ valid, const uint32_t* __restrict__ w22,
                            int32_t* __restrict__ n_valid, int32_t* __restrict__ vidx,
                            uint32_t* __restrict__ k, unsigned long long* __restrict__ scratch,
                            uint32_t base_lo, long long B, int V, bool vec,
                            const __grid_constant__ Runs runs) {
  __shared__ long long s_tile;
  __shared__ uint32_t s_warp[kCkWarps];
  __shared__ uint32_t s_prefix;
  __shared__ int32_t s_lane[kCkThreads];  // a round's lanes, by rank
  __shared__ uint32_t s_fill[8];
  unsigned long long* status = scratch + 1;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const long long n_tiles = (B + kCkTile - 1) / kCkTile;
  for (;;) {
    if (t == 0) s_tile = (long long)atomicAdd(scratch, 1ull);
    __syncthreads();
    const long long tile = s_tile;
    if (tile >= n_tiles) return;
    const long long i0 = tile * kCkTile + (long long)t * kCkLanes;
    const unsigned long long flags = load_flags(valid, i0, B, vec);
    // the block's exclusive scan of the threads' counts
    const uint32_t c = __popcll(flags);
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
    for (int w = 0; w < kCkWarps; w++) {
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
    const uint32_t excl = before + incl - c;  // the tile's valid lanes before this thread's
    // the tile's ranks [0, lim) land in slots prefix + rank < V
    const uint32_t lim = prefix >= (uint32_t)V ? 0u : min(agg, (uint32_t)V - prefix);
    for (uint32_t r0 = 0; r0 < lim; r0 += kCkThreads) {
      unsigned long long f = flags;
      for (uint32_t rank = excl; f && rank < r0 + kCkThreads; rank++) {
        const int j = __ffsll((long long)f) - 1;
        f &= f - 1;
        if (rank >= r0) s_lane[rank - r0] = (int32_t)(i0 + j);
      }
      __syncthreads();
      if (r0 + t < lim) {
        const int32_t ln = s_lane[t];
        uint32_t st[8];
        minikey_digest(w22, base_lo + (uint32_t)ln, runs, st);
        const long long slot = prefix + r0 + t;
        vidx[slot] = ln;
#pragma unroll
        for (int j = 0; j < 8; j++) k[(long long)j * V + slot] = st[7 - j];
      }
      __syncthreads();  // s_lane is reused
    }
    if (tile == n_tiles - 1) {  // every count is in: the total, and the fill
      const uint32_t total = prefix + agg;
      if (t == 0) *n_valid = (int32_t)total;
      if (total < (uint32_t)V) {
        if (t == 0) {
          uint32_t st[8];
          minikey_digest(w22, base_lo + (uint32_t)(B - 1), runs, st);
#pragma unroll
          for (int j = 0; j < 8; j++) s_fill[j] = st[7 - j];
        }
        __syncthreads();
        for (long long slot = total + t; slot < V; slot += kCkThreads) {
          vidx[slot] = (int32_t)B;
#pragma unroll
          for (int j = 0; j < 8; j++) k[(long long)j * V + slot] = s_fill[j];
        }
      }
    }
    __syncthreads();  // s_tile, s_warp, s_prefix are reused
  }
}

// runs_host: (3, n_runs) int32 on the host: lo, hi, off.
bool make_runs(const int* runs_host, int n_runs, Runs& r) {
  if (n_runs < 1 || n_runs > kMaxRuns) return false;
  r.n = n_runs;
  for (int j = 0; j < n_runs; j++) {
    r.lo[j] = runs_host[j];
    r.hi[j] = runs_host[n_runs + j];
    r.off[j] = (uint32_t)runs_host[2 * n_runs + j];
  }
  return true;
}

}  // namespace

extern "C" int kh_minikey_valid(const void* w23, void* mask, unsigned base_lo, long long B,
                                const void* runs_host, int n_runs, void* stream) {
  Runs runs;
  if (B < 1 || !make_runs((const int*)runs_host, n_runs, runs)) return (int)cudaErrorInvalidValue;
  minikey_valid_kernel<<<(unsigned)((B + kThreads - 1) / kThreads), kThreads, 0,
                         (cudaStream_t)stream>>>((const uint32_t*)w23, (uint8_t*)mask, base_lo,
                                                 B, runs);
  return (int)cudaGetLastError();
}

// Lanes a tile holds: the compact form's scratch is 1 + ceil(B / tile) u64.
extern "C" int kh_minikey_tile() { return kCkTile; }

extern "C" int kh_minikey_compact_keys(const void* valid, const void* w22, void* n_valid,
                                       void* vidx, void* k, void* scratch, unsigned base_lo,
                                       long long B, int V, const void* runs_host, int n_runs,
                                       void* stream) {
  Runs runs;
  if (B < 1 || B > 0x7FFFFFFFLL || V < 1 || !make_runs((const int*)runs_host, n_runs, runs))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long n_tiles = (B + kCkTile - 1) / kCkTile;
  const cudaError_t rc = cudaMemsetAsync(scratch, 0, (size_t)(1 + n_tiles) * 8, s);
  if (rc != cudaSuccess) return (int)rc;
  static int resident = 0;  // a persistent grid: the blocks the card holds at once
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, minikey_compact_keys_kernel,
                                                  kCkThreads, 0);
    resident = sms * (per_sm > 0 ? per_sm : 1);
  }
  const bool vec = (reinterpret_cast<uintptr_t>(valid) & 15u) == 0;
  minikey_compact_keys_kernel<<<(unsigned)(n_tiles < resident ? n_tiles : resident),
                                kCkThreads, 0, s>>>(
      (const uint8_t*)valid, (const uint32_t*)w22, (int32_t*)n_valid, (int32_t*)vidx,
      (uint32_t*)k, (unsigned long long*)scratch, base_lo, B, V, vec, runs);
  return (int)cudaGetLastError();
}
