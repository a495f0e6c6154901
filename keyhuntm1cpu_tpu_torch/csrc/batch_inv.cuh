// One field inversion shared by a whole block (sm_90a), used by K2
// (pwalk.cu) and K4 (pbrute.cu): each thread's Montgomery chain total
// goes into a shared-memory product tree with ONE inversion on thread 0.
#pragma once

#include "fe.cuh"

namespace kh {

// Inverts the n = blockDim.x (a power of two) elements tree[n + i] in
// place: a heap-ordered product tree (node k = node 2k * node 2k+1, root
// at 1; n - 1 products up), ONE inversion INV on thread 0, then n - 1 steps
// down (each node's inverse times its sibling gives the child's inverse).
// Every thread of the block must call it; none of the leaves may be zero.
template <Fe (*INV)(const Fe&)>
static __device__ void block_batch_inv(Fe* tree) {
  const int n = blockDim.x, i = threadIdx.x;
  __syncthreads();
  for (int s = n / 2; s >= 1; s >>= 1) {
    if (i < s) tree[s + i] = fe_mul(tree[2 * (s + i)], tree[2 * (s + i) + 1]);
    __syncthreads();
  }
  if (i == 0) tree[1] = INV(tree[1]);
  __syncthreads();
  for (int s = 1; s < n; s <<= 1) {
    if (i < s) {
      const int k = s + i;
      const Fe inv = tree[k], a = tree[2 * k], b = tree[2 * k + 1];
      tree[2 * k] = fe_mul(inv, b);
      tree[2 * k + 1] = fe_mul(inv, a);
    }
    __syncthreads();
  }
}

}  // namespace kh
