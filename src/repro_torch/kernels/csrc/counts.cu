// Dense relation counts for Hopper (sm_90a): the count blocks of the dense
// fallback arm (EE/FF, keys too wide for the sparse entry assembly, and
// assembly="dense"), from which ops.py's predicate and compaction build
// the padded (M, L) relation block.
//
// Replaces the TPU kernels of src/repro/kernels/segment_relations.py:
//   meet_counts_kernel <- _meet_kernel (relation_counts_meet_pallas)
//   vv_counts_kernel   <- _vv_kernel   (relation_counts_vv_pallas)
// both launched there through pl.pallas_call.
//
// meet_counts_kernel: C[b, x, y] = number of valid slots of tabX[b, x]
// whose vertex appears among the slots of tabY[b, y] (-1 slots never
// count). The TPU kernel builds nvl-wide one-hot tiles and contracts them
// on the MXU; here the count is taken by direct slot comparison (ax * ay
// compares per output), so C does not depend on nvl and any nvl works.
// What bounds it on this card: the output. FF at 96^3 and B = 64 writes
// 64 * 1920 * 1920 int32 = 943.7 MB against 4.7 MB of tables read, so the
// least time is the write at 3.35 TB/s, 0.28 ms; the compares (9 per output
// for FF) are far below the issue rate. What the design does about it:
// each block stages a 64-row X tile and a 128-column Y tile in shared
// memory, each thread keeps its four Y columns' slots in registers and
// walks the tile's rows, and each warp store writes 32 consecutive ints of
// one C row (128 bytes, coalesced along y). Ragged tiles are masked here:
// nothing is padded to a tile multiple.
//
// vv_counts_kernel: C[b, i, j] = number of local tets of segment b that
// contain both local vertices i and j, diagonal included (C[i, i] counts
// the tets containing i), for i, j < nvl. The TPU kernel contracts two
// one-hot (vertex, tet) tiles; here one block owns a tile of ROWS rows of
// C for one segment and a chunk of up to 256 columns in shared memory: it
// zeroes the tile, walks the segment's tets, and for each ordered slot
// pair (a in the row tile, b in the column chunk, both valid) adds one
// with a shared-memory atomic, then writes the tile out. Integer atomics
// are exact, so the result does not depend on their order. Columns past
// the chunk are covered by looping over chunks (nvl = 257 takes two); ids
// outside [0, nvl) count nowhere.
// What bounds it: the output, 64 * 256 * 256 int32 = 16.8 MB at B = 64,
// 5 us; at the fused extrema loop's batch (B = 8, NV 256, NT 896) 2.1 MB,
// 0.66 us, below the ~3 us a graph-replayed launch takes on this card. So
// at small B it is latency within a block and how many SMs work. What the
// design does about it: the grid is sized by B (vv_count_rows in the
// wrapper): the tallest tile, 32 or 16 rows, whose blocks occupy at least
// half the SMs, else 8 rows (B = 8: 128 blocks of 16 rows, where 32-row
// tiles gave 64 blocks on 132 SMs; on an H100 0.0046 ms against 0.0069);
// the segment's tets are staged into shared memory once with 16-byte
// loads (1024 at a time), issued together rather than one L2 round trip
// per loop step; the tile is zeroed and stored with int4 accesses, each
// warp writing 512 contiguous bytes of one row, where nvl is a multiple of
// 4 (C's rows are then 16-byte aligned), and with scalar stores without a
// divide otherwise.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kMeetTX = 64;       // rows of C per block
constexpr int kMeetTY = 128;      // columns of C per block (4 per lane)
constexpr int kMeetThreads = 256;
constexpr int kVvCols = 256;      // columns per shared-memory chunk
constexpr int kVvStage = 1024;    // tets staged in shared memory at a time
constexpr int kVvThreads = 256;

template <int AX, int AY>
__global__ void __launch_bounds__(kMeetThreads)
meet_counts_kernel(const int* __restrict__ tabx, const int* __restrict__ taby,
                   int* __restrict__ C, int NX, int NY) {
  __shared__ int sx[kMeetTX * AX];
  __shared__ int sy[kMeetTY * AY];
  const int b = blockIdx.z;
  const int x0 = blockIdx.y * kMeetTX;
  const int y0 = blockIdx.x * kMeetTY;
  const int* X = tabx + ((size_t)b * NX + x0) * AX;
  const int* Y = taby + ((size_t)b * NY + y0) * AY;
  const int nx = min(kMeetTX, NX - x0);
  const int ny = min(kMeetTY, NY - y0);
  for (int i = threadIdx.x; i < kMeetTX * AX; i += kMeetThreads)
    sx[i] = i < nx * AX ? X[i] : -1;
  for (int i = threadIdx.x; i < kMeetTY * AY; i += kMeetThreads)
    sy[i] = i < ny * AY ? Y[i] : -1;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int yv[4][AY];
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int j = 0; j < AY; ++j) yv[k][j] = sy[(lane + 32 * k) * AY + j];

  for (int r = warp; r < nx; r += kMeetThreads / 32) {
    int xs[AX];
#pragma unroll
    for (int i = 0; i < AX; ++i) xs[i] = sx[r * AX + i];
    int* row = C + ((size_t)b * NX + x0 + r) * NY + y0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int y = lane + 32 * k;
      if (y < ny) {
        int c = 0;
#pragma unroll
        for (int i = 0; i < AX; ++i) {
          bool hit = false;
#pragma unroll
          for (int j = 0; j < AY; ++j) hit |= xs[i] == yv[k][j];
          c += (hit && xs[i] >= 0) ? 1 : 0;
        }
        row[y] = c;
      }
    }
  }
}

template <int ROWS, bool VEC>
__global__ void __launch_bounds__(kVvThreads)
vv_counts_kernel(const int4* __restrict__ tet, int* __restrict__ C, int NT,
                 int nvl) {
  __shared__ int4 stage[kVvStage];
  __shared__ __align__(16) int tile[ROWS * kVvCols];
  int4* tile4 = reinterpret_cast<int4*>(tile);
  const int b = blockIdx.y;
  const int i0 = blockIdx.x * ROWS;
  const int rows = min(ROWS, nvl - i0);
  const int4* T = tet + (size_t)b * NT;
  const bool once = NT <= kVvStage;    // staged once for every chunk
  for (int c0 = 0; c0 < nvl; c0 += kVvCols) {
    const int cols = min(kVvCols, nvl - c0);
    for (int i = threadIdx.x; i < ROWS * kVvCols / 4; i += kVvThreads)
      tile4[i] = make_int4(0, 0, 0, 0);
    for (int t0 = 0; t0 < NT; t0 += kVvStage) {
      const int nt = min(kVvStage, NT - t0);
      if (!once || c0 == 0) {
        if (t0 > 0) __syncthreads();   // the last walk has read the stage
        for (int t = threadIdx.x; t < nt; t += kVvThreads)
          stage[t] = T[t0 + t];
      }
      __syncthreads();
      for (int t = threadIdx.x; t < nt; t += kVvThreads) {
        const int4 q = stage[t];
        const int v[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int ra = v[a] - i0;
          if (v[a] < 0 || ra < 0 || ra >= rows) continue;
#pragma unroll
          for (int bb = 0; bb < 4; ++bb) {
            const int cb = v[bb] - c0;
            if (v[bb] >= 0 && cb >= 0 && cb < cols)
              atomicAdd(&tile[ra * kVvCols + cb], 1);
          }
        }
      }
    }
    __syncthreads();
    int* out = C + ((size_t)b * nvl + i0) * nvl + c0;
    if (VEC) {
      // nvl % 4 == 0: rows of C and the chunk's start are 16-byte aligned
      for (int i = threadIdx.x; i < rows * (kVvCols / 4); i += kVvThreads) {
        const int r = i / (kVvCols / 4);
        const int c = 4 * (i % (kVvCols / 4));
        if (c < cols)
          *reinterpret_cast<int4*>(out + (size_t)r * nvl + c) = tile4[i];
      }
    } else {
      for (int i = threadIdx.x; i < rows * kVvCols; i += kVvThreads) {
        const int r = i / kVvCols;
        const int c = i % kVvCols;
        if (c < cols) out[(size_t)r * nvl + c] = tile[i];
      }
    }
    if (c0 + kVvCols < nvl) __syncthreads();   // stored before re-zeroing
  }
}

template <int ROWS>
cudaError_t launch_vv_counts(const void* tet, void* C, int B, int NT,
                             int nvl, cudaStream_t s) {
  const dim3 grid((nvl + ROWS - 1) / ROWS, B);
  if (nvl % 4 == 0)
    vv_counts_kernel<ROWS, true><<<grid, kVvThreads, 0, s>>>(
        (const int4*)tet, (int*)C, NT, nvl);
  else
    vv_counts_kernel<ROWS, false><<<grid, kVvThreads, 0, s>>>(
        (const int4*)tet, (int*)C, NT, nvl);
  return cudaGetLastError();
}

template <int AX, int AY>
cudaError_t launch_meet(const void* tabx, const void* taby, void* C, int B,
                        int NX, int NY, cudaStream_t s) {
  const dim3 grid((NY + kMeetTY - 1) / kMeetTY, (NX + kMeetTX - 1) / kMeetTX,
                  B);
  meet_counts_kernel<AX, AY><<<grid, kMeetThreads, 0, s>>>(
      (const int*)tabx, (const int*)taby, (int*)C, NX, NY);
  return cudaGetLastError();
}

template <int AX>
cudaError_t launch_meet_ay(int ay, const void* tabx, const void* taby,
                           void* C, int B, int NX, int NY, cudaStream_t s) {
  switch (ay) {
    case 1: return launch_meet<AX, 1>(tabx, taby, C, B, NX, NY, s);
    case 2: return launch_meet<AX, 2>(tabx, taby, C, B, NX, NY, s);
    case 3: return launch_meet<AX, 3>(tabx, taby, C, B, NX, NY, s);
    case 4: return launch_meet<AX, 4>(tabx, taby, C, B, NX, NY, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" const char* ct_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// C (B, NX, NY) int32 from tabX (B, NX, ax) and tabY (B, NY, ay) int32,
// arities 1..4; the wrapper checks shapes and the grid's limits.
extern "C" int ct_meet_counts(int device, const void* tabx, const void* taby,
                              void* C, int B, int NX, int ax, int NY, int ay,
                              void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = (cudaStream_t)stream;
  switch (ax) {
    case 1: return (int)launch_meet_ay<1>(ay, tabx, taby, C, B, NX, NY, s);
    case 2: return (int)launch_meet_ay<2>(ay, tabx, taby, C, B, NX, NY, s);
    case 3: return (int)launch_meet_ay<3>(ay, tabx, taby, C, B, NX, NY, s);
    case 4: return (int)launch_meet_ay<4>(ay, tabx, taby, C, B, NX, NY, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// C (B, nvl, nvl) int32 from the tet table (B, NT, 4) int32 (16-byte rows),
// in tiles of ``rows`` (8, 16 or 32) rows of C a block.
extern "C" int ct_vv_counts(int device, const void* tet, void* C, int B,
                            int NT, int nvl, int rows, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = (cudaStream_t)stream;
  switch (rows) {
    case 8: return (int)launch_vv_counts<8>(tet, C, B, NT, nvl, s);
    case 16: return (int)launch_vv_counts<16>(tet, C, B, NT, nvl, s);
    case 32: return (int)launch_vv_counts<32>(tet, C, B, NT, nvl, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
