// Cross-segment completion gather for Hopper (sm_90a): resolve each planned
// (segment, global id) pair to its local block row in the engine's sorted
// inverse maps, then copy that row of the stacked block pool and its length.
//
// Replaces the TPU kernel of src/repro/kernels/completion_gather.py:
//   resolve_gather_kernel <- _gather_kernel, launched there through
//                            _resolve_gather_pallas (pl.pallas_call).
//
// What bounds it on this card. The bytes are few (a chunk of 2048 pairs
// moves about 0.6 MB), so the kernel is bound by the latency of the loads
// that depend on each other. A binary search over the whole maps (K = 10.1 M
// tet appearances at 96^3, 121 MB, past the 50 MB L2) is about 24 such
// steps, each reading the segment and often the gid column.
//
// What the design does about it. The maps are sorted by segment first, and
// the engine stages a start table beside them (inv_start, S + 1 int32): the
// pair's segment alone narrows its search to that segment's own run of
// gids, at most NT = 896 long for tets. One warp takes one pair: it reads
// the run's bounds, then narrows the run with 32 evenly spaced reads of
// inv_gid and a __ballot_sync until at most 32 gids are left, and reads
// those in one coalesced load. That is two rounds for a run of up to 1024,
// about five dependent round trips in all with the row and pool reads.
// A block of 8 warps takes 8 pairs, so a chunk of 2048 pairs is 256 blocks
// on the 132 SMs. The resolved flat rows go to shared memory and the block
// copies its rows cooperatively (consecutive threads on consecutive words).
// Pairs outside the start table's domain (segment < 0 or >= S; on the
// inv_key arm also gid outside [0, n_global) or a key that wraps int32)
// keep the full binary search over the maps, in the same kernel, so every
// answer is the plain arm's.
//
// Semantics (identical to the plain torch arm and the reference): with
// inv_key (combined key seg * n_global + gid, int32, staged only when it
// fits) the search is a lower bound on that key; otherwise a lexicographic
// lower bound on (seg, gid). Not found gives row -1. A pair is ok when its
// slot >= 0 and its row >= 0; flat = max(slot, 0) * R + clamp(row, 0, R-1);
// cand = pool_M[flat] for every pair, clen = ok ? pool_L[flat] : 0. With
// mask set (one shard's half of the sharded completion exchange,
// gather_candidates) cand is 0 on the rows of pairs that are not ok, so an
// integer sum over the shards' halves gives the single-pool cand; clen == 0
// cannot stand in for that, since a resolved row may have no entries. Inside
// a segment's run the gids ascend, and in the domain both searches find
// the first entry of the run at or past qg, so the run's search gives the
// same row. The run's bounds are clamped to [0, K], so maps cut short keep
// their answers.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;

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

// The warp's lower bound of qg in the ascending gids[lo, hi): every lane
// gets the same answer. While more than 32 are left, lane i reads position
// lo + i * step (step = ceil(n / 32)); the lanes that read a gid below qg
// form a prefix of c lanes, so the bound lies after lane c - 1's position
// and at or before lane c's.
__device__ __forceinline__ int warp_lower_bound(const int* __restrict__ gids,
                                                int lo, int hi, int qg) {
  const int lane = threadIdx.x & 31;
  while (hi - lo > 32) {
    const int step = (hi - lo + 31) >> 5;
    const int pos = lo + lane * step;
    const bool less = pos < hi && gids[pos] < qg;
    const int c = __popc(__ballot_sync(kFull, less));
    if (c == 0) return lo;
    hi = min(lo + c * step, hi);
    lo += (c - 1) * step + 1;
  }
  const int pos = lo + lane;
  const bool less = pos < hi && gids[pos] < qg;
  return lo + __popc(__ballot_sync(kFull, less));
}

__global__ void __launch_bounds__(32 * kWarpsPerBlock)
resolve_gather_kernel(const int* __restrict__ pool_M,
                      const int* __restrict__ pool_L,
                      const int* __restrict__ inv_seg,
                      const int* __restrict__ inv_gid,
                      const int* __restrict__ inv_row,
                      const int* __restrict__ inv_key,
                      const int* __restrict__ inv_start,
                      const int* __restrict__ pair_slot,
                      const int* __restrict__ pair_seg,
                      const int* __restrict__ pair_gid,
                      int* __restrict__ cand, int* __restrict__ clen, int P,
                      int K, int R, int degp, int n_global, int n_seg,
                      int mask) {
  __shared__ long long flat_s[kWarpsPerBlock];
  __shared__ bool ok_s[kWarpsPerBlock];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int base = blockIdx.x * kWarpsPerBlock;
  const int p = base + warp;
  if (p < P) {                       // warp-uniform
    const int qs = pair_seg[p];
    const int qg = pair_gid[p];
    int row = -1;
    if (K > 0) {
      bool in_domain = qs >= 0 && qs < n_seg;
      if (inv_key != nullptr) {
        in_domain = in_domain && qg >= 0 && qg < n_global &&
                    (long long)qs * n_global + qg <= 0x7fffffffLL;
      }
      if (in_domain) {
        const int lo = min(max(inv_start[qs], 0), K);
        const int hi = min(max(inv_start[qs + 1], 0), K);
        const int pos = warp_lower_bound(inv_gid, lo, hi, qg);
        if (pos < hi && inv_gid[pos] == qg) row = inv_row[pos];
      } else if (inv_key != nullptr) {
        // int32 arithmetic that wraps, as the reference's
        const int q = (int)((unsigned)qs * (unsigned)n_global + (unsigned)qg);
        row = resolve_key(inv_key, inv_row, K, q);
      } else {
        row = resolve_lex(inv_seg, inv_gid, inv_row, K, qs, qg);
      }
    }
    if (lane == 0) {
      const int slot = pair_slot[p];
      const bool ok = slot >= 0 && row >= 0;
      const long long flat =
          (long long)max(slot, 0) * R + min(max(row, 0), R - 1);
      flat_s[warp] = flat;
      ok_s[warp] = ok;
      clen[p] = ok ? pool_L[flat] : 0;
    }
  }
  __syncthreads();
  const int n = min(kWarpsPerBlock, P - base);
  const int total = n * degp;
  int* out = cand + (size_t)base * degp;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int q = i / degp;
    const int d = i - q * degp;
    out[i] = (mask && !ok_s[q]) ? 0 : pool_M[flat_s[q] * degp + d];
  }
}

}  // namespace

extern "C" const char* cg_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Plain C interface, bound with ctypes; returns cudaGetLastError() after
// the launch. inv_key is null for the lexicographic search; inv_start holds
// n_seg + 1 run starts; mask != 0 zeroes the cand rows of pairs not ok.
extern "C" int cg_resolve_gather(int device, const void* pool_M,
                                 const void* pool_L, const void* inv_seg,
                                 const void* inv_gid, const void* inv_row,
                                 const void* inv_key, const void* inv_start,
                                 const void* pair_slot, const void* pair_seg,
                                 const void* pair_gid, void* cand, void* clen,
                                 int P, int K, int R, int degp, int n_global,
                                 int n_seg, int mask, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (P == 0) return (int)cudaSuccess;
  const int blocks = (P + kWarpsPerBlock - 1) / kWarpsPerBlock;
  resolve_gather_kernel<<<blocks, 32 * kWarpsPerBlock, 0,
                          (cudaStream_t)stream>>>(
      (const int*)pool_M, (const int*)pool_L, (const int*)inv_seg,
      (const int*)inv_gid, (const int*)inv_row, (const int*)inv_key,
      (const int*)inv_start, (const int*)pair_slot, (const int*)pair_seg,
      (const int*)pair_gid, (int*)cand, (int*)clen, P, K, R, degp, n_global,
      n_seg, mask);
  return (int)cudaGetLastError();
}
