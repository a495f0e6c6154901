// Minikey kernels for Hopper (sm_90a):
//   K5 kh_minikey_valid  replaces keyhuntm1cpu_tpu/hash/pminikey.py _minikey_valid_kernel
//   kh_minikey_keys      replaces the XLA key derivation of
//                        keyhuntm1cpu_tpu/engine/minikeys.py:476-479
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
// The key derivation is the same work on the V compacted lanes only.
// Each entry point launches on the given stream, does not synchronise, and
// returns cudaGetLastError().
#include <cuda_runtime.h>

#include "hash.cuh"

namespace {

constexpr int kMaxRuns = 58;
constexpr int kThreads = 256;

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

// Key derivation: lane i of the V compacted lanes (vidx, fill B) gets the
// scalar sha256(minikey of base_lo + min(vidx, B - 1)) as 8 little-endian
// limbs, limb-major: limb j is digest word 7 - j.
__global__ void __launch_bounds__(kThreads)
minikey_keys_kernel(const int* __restrict__ vidx, const uint32_t* __restrict__ w22,
                    uint32_t* __restrict__ k, uint32_t base_lo, long long B, int V,
                    const __grid_constant__ Runs runs) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= V) return;
  const long long lane = min((long long)vidx[i], B - 1);
  uint32_t w[16], st[8];
  message_words(w22, base_lo + (uint32_t)lane, runs, w);
  kh::sha256_init(st);
  kh::sha256_compress(st, w);
#pragma unroll
  for (int j = 0; j < 8; j++) k[(long long)j * V + i] = st[7 - j];
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

extern "C" int kh_minikey_keys(const void* vidx, const void* w22, void* k, unsigned base_lo,
                               long long B, int V, const void* runs_host, int n_runs,
                               void* stream) {
  Runs runs;
  if (B < 1 || V < 1 || !make_runs((const int*)runs_host, n_runs, runs))
    return (int)cudaErrorInvalidValue;
  minikey_keys_kernel<<<(V + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)vidx, (const uint32_t*)w22, (uint32_t*)k, base_lo, B, V, runs);
  return (int)cudaGetLastError();
}
