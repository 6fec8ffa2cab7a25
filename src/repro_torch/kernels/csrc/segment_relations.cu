// Sparse relation-entry assembly for Hopper (sm_90a): one thread block per
// batched segment emits that segment's padded (M, L) relation block.
//
// Replaces the TPU kernels of src/repro/kernels/segment_relations.py:
//   vv_entries_kernel     <- _vv_entries_kernel     (+ _emit_entries)
//   member_entries_kernel <- _member_entries_kernel (+ _emit_entries)
// both launched there through relation_entries_pallas (pl.pallas_call).
//
// What bounds it on this card. The bytes a launch must move are small (VV
// at B=64, NT=896: 0.9 MB of tets in, 2.1 MB of M out), so the byte bound
// is about a microsecond. The work is a comparison sort of the entry lanes:
// E = next_pow2(12*NT) = 16384 lanes for VV, sorted twice by a bitonic
// network of log2(E)*(log2(E)+1)/2 = 105 block-wide passes, each ending in
// a __syncthreads(). The kernel is bound by those barrier-separated
// shared-memory passes and by occupancy: a VV block takes 128 KB of shared
// memory, so one block runs per SM and a 64-segment launch fills 64 of the
// 132 SMs.
//
// What the design does about it. The lanes (int32 key + int32 value, 8*E
// bytes) never leave shared memory between the entry generation and the
// store of M: device memory sees each table row once and each M row once.
// Nothing is staged through device memory between the phases (the TPU
// kernel's VMEM-resident lane vectors, kept on-chip here the same way).
// When 8*E exceeds the per-block opt-in limit (227 KB, NT > 1365 for VV)
// the same code runs with its lanes in a workspace in device memory that
// the wrapper allocates; it never falls back to another implementation.
// Making it fast (warp-level sorting of short strides in registers, several
// segments per SM) is later work; this version is the simple one that is
// right.
//
// Key encoding (identical to the plain torch arm and the reference): an
// entry's key is row * O + order in int32 (the wrapper's callers guarantee
// R * O + O < 2^31), invalid lanes carry INT32_MAX and value 0. Every key
// family is tie-insensitive (equal keys carry equal values), so the
// unstable bitonic network gives the same blocks as any stable sort.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kBig = 0x7fffffff;

// the 12 ordered vertex pairs (a, b), a != b, of a tet, in the reference's
// order: for a in 0..3, for b in 0..3
__constant__ int kPairA[12] = {0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 3};
__constant__ int kPairB[12] = {1, 2, 3, 0, 2, 3, 0, 1, 3, 0, 1, 2};

// Block-wide bitonic sort of E (a power of two) lanes by key, ascending;
// the values ride along. Callers synchronise before the first pass.
__device__ __forceinline__ void bitonic_sort(int* key, int* val, int E) {
  const int half = E >> 1;
  for (int k = 2; k <= E; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < half; i += blockDim.x) {
        const int lo = ((i & ~(j - 1)) << 1) | (i & (j - 1));
        const int hi = lo + j;
        const bool up = (lo & k) == 0;
        const int a = key[lo];
        const int b = key[hi];
        if ((a > b) == up) {
          key[lo] = b;
          key[hi] = a;
          const int t = val[lo];
          val[lo] = val[hi];
          val[hi] = t;
        }
      }
      __syncthreads();
    }
  }
}

// Entry lanes -> one segment's (M (R, deg), L (R)) block: sort, re-key the
// duplicates of their left neighbour to the sentinel, sort again, find the
// R + 1 row starts r * O by lower-bound search, and place by gather.
// ``starts`` holds R + 1 ints next to the lanes.
__device__ __forceinline__ void emit_entries(int* key, int* val, int* starts,
                                             int E, int R, int O, int deg,
                                             int* M, int* L) {
  bitonic_sort(key, val, E);

  // Duplicate mask against the left neighbour. A lane is only re-keyed
  // after every lane of its round has been compared, and rounds run from
  // the top down, so no comparison ever reads a lane already re-keyed.
  const int round = 32 * blockDim.x;
  for (int base = ((E - 1) / round) * round; base >= 0; base -= round) {
    unsigned dup = 0;
    for (int s = 0; s < 32; ++s) {
      const int i = base + s * blockDim.x + threadIdx.x;
      if (i > 0 && i < E && key[i] == key[i - 1]) dup |= 1u << s;
    }
    __syncthreads();
    for (int s = 0; s < 32; ++s) {
      if (dup & (1u << s)) key[base + s * blockDim.x + threadIdx.x] = kBig;
    }
    __syncthreads();
  }

  bitonic_sort(key, val, E);

  // One lower-bound search per row boundary. The loop exits as soon as
  // the interval closes, so a fully valid lane vector never reads past E.
  for (int r = threadIdx.x; r <= R; r += blockDim.x) {
    const int q = r * O;
    int lo = 0;
    int hi = E;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (key[mid] < q) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    starts[r] = lo;
  }
  __syncthreads();

  // L is the TRUE row count (it may exceed deg: the engine's width check).
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    L[r] = starts[r + 1] - starts[r];
  }
  const int n = R * deg;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int r = i / deg;
    const int d = i - r * deg;
    const int s = starts[r];
    const int cnt = min(starts[r + 1] - s, deg);
    M[i] = d < cnt ? val[s + d] : -1;
  }
}

// This block's lanes: dynamic shared memory, or its slice of the device
// workspace. A template flag, so the shared variant's accesses compile to
// shared-memory loads and stores.
template <bool kGlobalLanes>
__device__ __forceinline__ int* segment_lanes(int* work, int b, size_t per) {
  extern __shared__ int smem[];
  if (kGlobalLanes) return work + (size_t)b * per;
  return smem;
}

// VV: the 12 ordered vertex pairs of each local tet are the entries,
// key va * nvl + vb, value col_global[vb]. tet is (B, NT, 4), colg (B, NV).
template <bool kGlobalLanes>
__global__ void __launch_bounds__(1024)
vv_entries_kernel(const int* __restrict__ tet, const int* __restrict__ colg,
                  int* __restrict__ M, int* __restrict__ L, int* work,
                  int NT, int NV, int nvl, int deg, int E) {
  const int b = blockIdx.x;
  const size_t per = 2 * (size_t)E + nvl + 1;
  int* key = segment_lanes<kGlobalLanes>(work, b, per);
  int* val = key + E;
  int* starts = val + E;
  const int* tb = tet + (size_t)b * NT * 4;
  const int* cg = colg + (size_t)b * NV;
  const int n = 12 * NT;
  for (int i = threadIdx.x; i < E; i += blockDim.x) {
    int k = kBig;
    int v = 0;
    if (i < n) {
      const int p = i / NT;           // pair-major, as the reference
      const int t = i - p * NT;
      const int va = tb[t * 4 + kPairA[p]];
      const int vb = tb[t * 4 + kPairB[p]];
      if (va >= 0 && vb >= 0) {
        k = va * nvl + vb;
        v = vb < NV ? cg[vb] : 0;
      }
    }
    key[i] = k;
    val[i] = v;
  }
  __syncthreads();
  emit_entries(key, val, starts, E, nvl, nvl, deg,
               M + (size_t)b * nvl * deg, L + (size_t)b * nvl);
}

// VE/VF/VT: the (NY, ay) table is the entry list, key v * NY + y, value
// col_global[y]. taby is (B, NY, ay), colg (B, NY).
template <bool kGlobalLanes>
__global__ void __launch_bounds__(1024)
member_entries_kernel(const int* __restrict__ taby,
                      const int* __restrict__ colg, int* __restrict__ M,
                      int* __restrict__ L, int* work, int NY, int ay,
                      int nvl, int deg, int E) {
  const int b = blockIdx.x;
  const size_t per = 2 * (size_t)E + nvl + 1;
  int* key = segment_lanes<kGlobalLanes>(work, b, per);
  int* val = key + E;
  int* starts = val + E;
  const int* tb = taby + (size_t)b * NY * ay;
  const int* cg = colg + (size_t)b * NY;
  const int n = NY * ay;
  for (int i = threadIdx.x; i < E; i += blockDim.x) {
    int k = kBig;
    int v = 0;
    if (i < n) {
      const int y = i / ay;           // row-major table walk, coalesced
      const int vert = tb[i];
      if (vert >= 0) {
        k = vert * NY + y;
        v = cg[y];
      }
    }
    key[i] = k;
    val[i] = v;
  }
  __syncthreads();
  emit_entries(key, val, starts, E, nvl, NY, deg,
               M + (size_t)b * nvl * deg, L + (size_t)b * nvl);
}

int threads_for(int E) {
  int t = E / 2;
  if (t < 128) t = 128;
  if (t > 1024) t = 1024;
  return t;
}

// Shared-memory lanes above 48 KB need the per-kernel opt-in.
cudaError_t allow_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace

// Plain C interface, bound with ctypes. Every entry returns a cudaError_t
// (0 on success), read with cudaGetLastError() right after the launch.
// ``work`` is null for the shared-memory variant, else a device workspace
// of B * (2E + nvl + 1) int32 for the lanes.

extern "C" int sr_smem_optin_limit(int device, int* out) {
  return (int)cudaDeviceGetAttribute(
      out, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
}

extern "C" const char* sr_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

extern "C" int sr_vv_entries(int device, const void* tet, const void* colg,
                             void* M, void* L, void* work, int B, int NT,
                             int NV, int nvl, int deg, int E, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const int threads = threads_for(E);
  cudaStream_t s = (cudaStream_t)stream;
  if (work != nullptr) {
    vv_entries_kernel<true><<<B, threads, 0, s>>>(
        (const int*)tet, (const int*)colg, (int*)M, (int*)L, (int*)work, NT,
        NV, nvl, deg, E);
  } else {
    const size_t bytes = (2 * (size_t)E + nvl + 1) * sizeof(int);
    e = allow_smem((const void*)vv_entries_kernel<false>, bytes);
    if (e != cudaSuccess) return (int)e;
    vv_entries_kernel<false><<<B, threads, bytes, s>>>(
        (const int*)tet, (const int*)colg, (int*)M, (int*)L, nullptr, NT,
        NV, nvl, deg, E);
  }
  return (int)cudaGetLastError();
}

extern "C" int sr_member_entries(int device, const void* taby,
                                 const void* colg, void* M, void* L,
                                 void* work, int B, int NY, int ay, int nvl,
                                 int deg, int E, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const int threads = threads_for(E);
  cudaStream_t s = (cudaStream_t)stream;
  if (work != nullptr) {
    member_entries_kernel<true><<<B, threads, 0, s>>>(
        (const int*)taby, (const int*)colg, (int*)M, (int*)L, (int*)work,
        NY, ay, nvl, deg, E);
  } else {
    const size_t bytes = (2 * (size_t)E + nvl + 1) * sizeof(int);
    e = allow_smem((const void*)member_entries_kernel<false>, bytes);
    if (e != cudaSuccess) return (int)e;
    member_entries_kernel<false><<<B, threads, bytes, s>>>(
        (const int*)taby, (const int*)colg, (int*)M, (int*)L, nullptr, NY,
        ay, nvl, deg, E);
  }
  return (int)cudaGetLastError();
}
