// Cross-segment completion gather for Hopper (sm_90a): resolve each planned
// (segment, global id) pair to its local block row by binary search over
// the engine's sorted inverse maps, then copy that row of the stacked block
// pool and its length.
//
// Replaces the TPU kernel of src/repro/kernels/completion_gather.py:
//   resolve_gather_kernel <- _gather_kernel, launched there through
//                            _resolve_gather_pallas (pl.pallas_call).
//
// What bounds it on this card. Each pair costs about log2(K) dependent
// loads from the inverse maps (K = 10.1 M tet appearances at 96^3, so 24
// steps reading seg and gid, 121 MB of maps in all) and one degp-wide row
// copy. The TPU kernel kept the maps in VMEM; here they do not fit in
// shared memory (or the 50 MB L2), so they stay in device memory and the
// search is bound by the latency of its chain of dependent loads, not by
// bytes or operations: a chunk of P = 4096 pairs touches at most
// 4096 * 24 * 8 bytes of the maps. The top of every search reads the same
// few lines, which stay in L2.
//
// What the design does about it. One thread per pair runs its own search,
// so a block keeps 256 independent load chains in flight and many blocks
// overlap their latencies; the resolved flat rows go to shared memory and
// the block then copies the rows cooperatively (consecutive threads on
// consecutive words of the output). Making it faster (a shared-memory
// top-of-tree cache, prefetching several levels) is later work.
//
// Semantics (identical to the plain torch arm and the reference): with
// inv_key (combined key seg * n_global + gid, int32, staged only when it
// fits) the search is a lower bound on that key; otherwise a lexicographic
// lower bound on (seg, gid). Not found gives row -1. A pair is ok when its
// slot >= 0 and its row >= 0; flat = max(slot, 0) * R + clamp(row, 0, R-1);
// cand = pool_M[flat] for every pair, clen = ok ? pool_L[flat] : 0.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kPairsPerBlock = 256;

__device__ __forceinline__ int resolve_lex(const int* __restrict__ inv_seg,
                                           const int* __restrict__ inv_gid,
                                           const int* __restrict__ inv_row,
                                           int K, int qs, int qg) {
  int lo = 0;
  int hi = K;
  while (lo < hi) {
    const int mid = (int)(((unsigned)lo + (unsigned)hi) >> 1);
    const int ks = inv_seg[mid];
    const bool less = ks < qs || (ks == qs && inv_gid[mid] < qg);
    if (less) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  if (lo < K && inv_seg[lo] == qs && inv_gid[lo] == qg) return inv_row[lo];
  return -1;
}

__device__ __forceinline__ int resolve_key(const int* __restrict__ inv_key,
                                           const int* __restrict__ inv_row,
                                           int K, int q) {
  int lo = 0;
  int hi = K;
  while (lo < hi) {
    const int mid = (int)(((unsigned)lo + (unsigned)hi) >> 1);
    if (inv_key[mid] < q) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  const int pos = lo < K ? lo : K - 1;
  return inv_key[pos] == q ? inv_row[pos] : -1;
}

__global__ void __launch_bounds__(kPairsPerBlock)
resolve_gather_kernel(const int* __restrict__ pool_M,
                      const int* __restrict__ pool_L,
                      const int* __restrict__ inv_seg,
                      const int* __restrict__ inv_gid,
                      const int* __restrict__ inv_row,
                      const int* __restrict__ inv_key,
                      const int* __restrict__ pair_slot,
                      const int* __restrict__ pair_seg,
                      const int* __restrict__ pair_gid,
                      int* __restrict__ cand, int* __restrict__ clen, int P,
                      int K, int R, int degp, int n_global) {
  __shared__ long long flat_s[kPairsPerBlock];
  const int base = blockIdx.x * kPairsPerBlock;
  const int p = base + threadIdx.x;
  if (p < P) {
    const int qs = pair_seg[p];
    const int qg = pair_gid[p];
    int row = -1;
    if (K > 0) {
      if (inv_key != nullptr) {
        // int32 arithmetic that wraps, as the reference's
        const int q = (int)((unsigned)qs * (unsigned)n_global + (unsigned)qg);
        row = resolve_key(inv_key, inv_row, K, q);
      } else {
        row = resolve_lex(inv_seg, inv_gid, inv_row, K, qs, qg);
      }
    }
    const int slot = pair_slot[p];
    const bool ok = slot >= 0 && row >= 0;
    const long long flat = (long long)max(slot, 0) * R + min(max(row, 0), R - 1);
    flat_s[threadIdx.x] = flat;
    clen[p] = ok ? pool_L[flat] : 0;
  }
  __syncthreads();
  const int n = min(kPairsPerBlock, P - base);
  const long long total = (long long)n * degp;
  int* out = cand + (size_t)base * degp;
  for (long long i = threadIdx.x; i < total; i += blockDim.x) {
    const int q = (int)(i / degp);
    const int d = (int)(i - (long long)q * degp);
    out[i] = pool_M[flat_s[q] * degp + d];
  }
}

}  // namespace

extern "C" const char* cg_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Plain C interface, bound with ctypes; returns cudaGetLastError() after
// the launch. inv_key is null for the lexicographic search.
extern "C" int cg_resolve_gather(int device, const void* pool_M,
                                 const void* pool_L, const void* inv_seg,
                                 const void* inv_gid, const void* inv_row,
                                 const void* inv_key, const void* pair_slot,
                                 const void* pair_seg, const void* pair_gid,
                                 void* cand, void* clen, int P, int K, int R,
                                 int degp, int n_global, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (P == 0) return (int)cudaSuccess;
  const int blocks = (P + kPairsPerBlock - 1) / kPairsPerBlock;
  resolve_gather_kernel<<<blocks, kPairsPerBlock, 0,
                          (cudaStream_t)stream>>>(
      (const int*)pool_M, (const int*)pool_L, (const int*)inv_seg,
      (const int*)inv_gid, (const int*)inv_row, (const int*)inv_key,
      (const int*)pair_slot, (const int*)pair_seg, (const int*)pair_gid,
      (int*)cand, (int*)clen, P, K, R, degp, n_global);
  return (int)cudaGetLastError();
}
