// Sparse relation-entry assembly for Hopper (sm_90a): each launch emits the
// padded (M, L) relation blocks of its batched segments.
//
// Replaces the TPU kernels of src/repro/kernels/segment_relations.py:
//   vv_bits_kernel, vv_entries_kernel         <- _vv_entries_kernel
//                                                (+ _emit_entries)
//   member_bits_kernel, member_entries_kernel <- _member_entries_kernel
//                                                (+ _emit_entries)
//   tt_entries_kernel                         <- _tt_entries_kernel
//                                                (+ _emit_entries)
//   sub_bits_kernel, sub_entries_kernel       <- _sub_entries_kernel
//                                                (+ _cummax_lanes,
//                                                 _emit_entries)
// all launched there through relation_entries_pallas (pl.pallas_call).
//
// VV, VE/VF/VT and EF/ET/FT: row bitmasks (vv_bits_kernel,
// member_bits_kernel, sub_bits_kernel). A VV row is the ascending set of
// local vertices that share a tet with its vertex; a member row the
// ascending set of simplices y whose table row holds its vertex; a sub-join
// row the ascending set of cofaces y that hold every vertex of its subject
// x. None needs a sort: a block keeps rows [r0, r0 + nr) of one segment's
// (row, order) relation in shared memory as nr rows of W = ceil(O / 32)
// words (O = nvl for VV, NY otherwise; at 96^3 a whole VV mask is 8 KB, VT
// 28 KB, VF 60 KB, FT 215 KB, EF 307 KB). It zeroes its rows' mask, walks
// the table once, coalesced, setting bit (row, order) by a shared atomicOr,
// and emits its rows. VV and member rows hold up to deg (64-96) entries:
// one warp a row, the lanes count the set bits of the row's words, a warp
// scan gives each word its first rank, and lane d finds the d-th set bit
// by a search of those ranks and a select in the word, so a row's deg ints
// go out as contiguous warp stores. Setting a bit is
// idempotent and commutes, so the blocks do not depend on the order of the
// atomics and duplicate entries need no pass. What bounds it then: three
// barrier-separated phases within a block (the sort kernels took some 210
// passes for VV at NT = 896), the shared atomics of the walk, and the
// latency of each warp's row emission. So a segment's rows are split over
// several blocks (row shares), each walking the whole table, which L2
// serves after the first, and keeping only its own rows.
//
// The sub-join's walk needs its subjects by key: each block first builds a
// lookup of ITS OWN valid x rows in shared memory, sorted vertex key (base
// nvl, without the sort join's parity bit) -> x, by open addressing over
// sub_slots(rows) = next_pow2(4 * rows) slots (load at most a quarter)
// filled by atomicCAS on the key. The walk then sorts each valid y row's AY
// ids in registers and probes the key of each of its C(AY, AX) vertex
// subsets; a hit x among the block's rows sets bit y of row x. A sub-join
// row holds a few entries (a face lies in at most two tets, an edge in a
// handful of faces), so one THREAD emits a row (emit_sparse_rows): it
// walks the row's words in order and writes each set bit's col_global[y],
// four at a time as int4 stores. On an H100 at 96^3 (B = 64) the
// warp-per-row emission of the other bitmask kernels took 0.034-0.047 ms
// (~30 rows a warp, each a chain of scan, search and global load); one
// thread a row, 1024 threads a block, 0.013-0.017 ms. Where a block holds
// so few rows that most threads would idle (2 * rows <= 1024), g lanes
// share a row (emit_wide_rows): they read g words at a time and a scan of
// the words' bit counts places each bit. The rows come out in ascending
// y, as the sort join's entry key x * NY + y orders them. What bounds it
// then: each block walks the whole y table, so the wrapper gives a segment
// as few shares as fill the card in one wave (sub_row_blocks: 2 at B =
// 64), or as its mask rows need. Tie rule: equal x keys lie outside the
// arm's precondition (a table lists each simplex once); there the LARGEST
// x index holds the key, so its row gets every entry and the others none,
// on every run and at every share count: after its own rows, a block walks
// the segment's later x rows (the only ones that can be larger) and lets
// each whose key its lookup holds raise the slot's x (atomicMax), so a key
// some later share's row repeats resolves to that row and sets no bit here.
//
// Why the lookup holds only the block's rows: one of the WHOLE segment's
// NX keys in each block takes 8 * next_pow2(2 * NX) bytes, 256 KB at NE
// 11,520, past the 227 KB opt-in limit, and would send every table past
// NX 8192 to the sort kernel. Sized by the block's rows, the limit is one
// mask row, as for member: ceil(NY / 32) | 1 words, four slots and the
// key range. At the 48^3 tables of capacity 1024 (NE 11,520, NF 18,048)
// that is 101 EF rows of 565 words a block, 115 blocks a segment, each
// walking the segment's 18,048 faces from L2: on an H100, 1.56 ms for 64
// segments against the sort kernel's 33.9 (chip_smoke.py phase 4b).
//
// Routing (the wrapper's entry_route, decided in Python before the launch):
// a table takes its bitmask kernel while ONE mask row and the 16 warps'
// rank rows (VV, member) or one row's lookup (sub-join) fit the per-block
// opt-in limit (227 KB); the wrapper then launches max(its share rule,
// ceil(R / rows that fit)) shares of a segment's R rows. On an H100 that
// takes every VV table the int32 key guard admits, member tables up to NY
// = 109,376, and sub-join tables up to NY = 1,859,232 whatever their NX.
// Ids outside [0, nvl) are dropped, and no bit past O is ever set.
//
// The sort route serves the tables past that, and callers that force it.
// VV and VE/VF/VT (vv_entries_kernel, member_entries_kernel) build each
// segment's relation as CSR rows over four passes, each a launch of the
// arm's kernel template on a grid that spreads a segment's table over many
// blocks (see "CSR rows" below): count the entries of each row (a block a
// tile of the table, in a shared-memory histogram of nvl ints), scan the
// counts into row starts, place each entry's order key in its row by an
// atomic cursor, then one warp a row sorts the row's keys (in registers up
// to 128 keys, in the workspace past that), drops duplicates and emits. No
// combined row * O + order key is ever formed, and the order of the
// atomics cannot change a block: a row's keys are sorted before they are
// read, and a value is a function of its order key. What bounds it: the
// place pass's one device-memory atomic and scattered 4-byte store an
// entry, and the latency of each warp's row. The sub-join
// (sub_entries_kernel) keeps the block-a-segment design: its join lanes
// are generated, sorted by a block-wide bitonic network, each y lane
// resolves its x by a running max, and the entries are deduplicated and
// inverted (emit_entries); three sorts of E = 8192 lanes at 96^3, bound by
// those barrier-separated passes and by occupancy.
//
// TT is designed apart (tt_entries_kernel below). It sorts only its EJ face
// lanes (4096 at NT = 896) and never inverts a list of entries: under the
// arm's precondition a tet has at most four TT neighbours, the partners of
// its own four face lanes, so each lane records its sorted neighbours' tets
// in two slots of its own and one thread per tet builds its row from those
// 8 slots in registers. The face sort keeps each warp's 128 lanes in
// registers for strides below 128 (register compare-exchange and warp
// shuffles), so a segment takes about 20 barrier-separated passes over
// 32 KB of lanes where the entry-inversion design took about 270 over
// 64 KB. What bounds it then is the latency of those passes within one
// block per segment (64 blocks at B = 64), not bytes or operations. Its
// lanes, slots and staged M rows (tt_lane_ints: 60 KB at NT = 896) move to
// the device workspace past the opt-in limit (NT > 3168 at deg 8), as
// below.
//
// Lanes of the sub-join's sort kernel (int32 key + int32 value, 8*E bytes)
// never leave shared memory between the entry generation and the store of
// M: device memory sees each table row once and each M row once. When 8*E
// exceeds the per-block opt-in limit (227 KB) the same code runs with its
// lanes in a workspace in device memory that the wrapper allocates; no
// kernel ever falls back to another implementation.
//
// Key encoding of the sub-join's sort kernel (identical to the plain torch
// arm and the reference): an entry's key is row * O + order in int32 (the
// wrapper's callers guarantee R * O + O < 2^31), invalid lanes carry
// INT32_MAX and value 0. Every key family is tie-insensitive (equal keys
// carry equal values), so the unstable bitonic network gives the same
// blocks as any stable sort.

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
  extern __shared__ __align__(16) int smem[];
  if (kGlobalLanes) return work + (size_t)b * per;
  return smem;
}

// -- VV and VE/VF/VT as row bitmasks ----------------------------------------
//
// A block owns rows [r0, r0 + nr) of one segment: a mask of nr rows of W
// words (bit j of word w is order 32 * w + j), then one row of W ints per
// warp for the words' first ranks, all in dynamic shared memory
// (bits_smem_ints).

constexpr int kBitsThreads = 512;
constexpr int kBitsWarps = kBitsThreads / 32;

__host__ __device__ __forceinline__ size_t bits_smem_ints(int rows, int W) {
  return ((size_t)rows + kBitsWarps) * (size_t)W;
}

// Position of the k-th (from 0) set bit of x, which has more than k: five
// halvings of the window, each keeping the half that holds it.
__device__ __forceinline__ int select_bit(unsigned x, int k) {
  int pos = 0;
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    const int c = __popc(x & ((1u << s) - 1u));
    if (k >= c) {
      k -= c;
      x >>= s;
      pos += s;
    }
  }
  return pos;
}

// M's value of VV order o (a local vertex): its global id, 0 past the map.
struct VVValue {
  const int* cg;
  int NV;
  __device__ int operator()(int o) const { return o < NV ? cg[o] : 0; }
};

// M's value of member order o (a local simplex): its global id.
struct MemberValue {
  const int* cg;
  __device__ int operator()(int o) const { return cg[o]; }
};

// Rows [r0, r0 + nr) of the mask -> their M rows (deg ints each) and L,
// one warp a row. The lanes count the set bits of the row's words 32 at a
// time, a warp scan writes each word's first rank to the warp's pre row,
// and L[r] is the TRUE count (it may exceed deg: the engine's width
// check). Lane d then writes M[r, d]: the word holding rank d is the last
// one whose first rank is <= d (a binary search of pre), the order is that
// word's (d - pre)-th set bit, and -1 from min(L, deg) on.
template <class Value>
__device__ __forceinline__ void emit_bit_rows(const unsigned* mask,
                                              int* pre_rows, int r0, int nr,
                                              int W, int deg,
                                              const Value& value, int* M,
                                              int* L) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int* pre = pre_rows + (size_t)warp * W;
  for (int r = warp; r < nr; r += kBitsWarps) {
    const unsigned* row = mask + (size_t)r * W;
    int total = 0;
    for (int w0 = 0; w0 < W; w0 += 32) {
      const int w = w0 + lane;
      const int c = w < W ? __popc(row[w]) : 0;
      int incl = c;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int o = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += o;
      }
      if (w < W) pre[w] = total + incl - c;
      total += __shfl_sync(0xffffffffu, incl, 31);
    }
    __syncwarp();
    if (lane == 0) L[r0 + r] = total;
    int* Mr = M + (size_t)(r0 + r) * deg;
    const int n = min(total, deg);
    for (int d = lane; d < deg; d += 32) {
      int out = -1;
      if (d < n) {
        int lo = 0;
        int hi = W - 1;
        while (lo < hi) {
          const int mid = (lo + hi + 1) >> 1;
          if (pre[mid] <= d) {
            lo = mid;
          } else {
            hi = mid - 1;
          }
        }
        out = value(lo * 32 + select_bit(row[lo], d - pre[lo]));
      }
      Mr[d] = out;
    }
    __syncwarp();                      // pre is the next row's
  }
}

// VV: each tet's 12 ordered pairs (va, vb) of valid ids set bit vb of row
// va. tet is (B, NT, 4), colg (B, NV); grid (B, ceil(nvl / rows)).
__global__ void __launch_bounds__(kBitsThreads)
vv_bits_kernel(const int* __restrict__ tet, const int* __restrict__ colg,
               int* __restrict__ M, int* __restrict__ L, int NT, int NV,
               int nvl, int deg, int rows) {
  extern __shared__ __align__(16) unsigned bits_smem[];
  const int b = blockIdx.x;
  const int r0 = blockIdx.y * rows;
  const int nr = min(rows, nvl - r0);
  const int W = (nvl + 31) >> 5;
  unsigned* mask = bits_smem;
  int* pre = reinterpret_cast<int*>(bits_smem + (size_t)rows * W);
  for (int i = threadIdx.x; i < nr * W; i += blockDim.x) mask[i] = 0u;
  __syncthreads();
  const int* tb = tet + (size_t)b * NT * 4;
  const bool vec = (reinterpret_cast<size_t>(tet) & 15) == 0;
  for (int t = threadIdx.x; t < NT; t += blockDim.x) {
    const int4 q = vec ? reinterpret_cast<const int4*>(tb)[t]
                       : make_int4(tb[4 * t], tb[4 * t + 1], tb[4 * t + 2],
                                   tb[4 * t + 3]);
    const int v[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int ra = v[a] - r0;
      if ((unsigned)v[a] >= (unsigned)nvl || (unsigned)ra >= (unsigned)nr)
        continue;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (c == a || (unsigned)v[c] >= (unsigned)nvl) continue;
        atomicOr(&mask[(size_t)ra * W + (v[c] >> 5)], 1u << (v[c] & 31));
      }
    }
  }
  __syncthreads();
  emit_bit_rows(mask, pre, r0, nr, W, deg, VVValue{colg + (size_t)b * NV, NV},
                M + (size_t)b * nvl * deg, L + (size_t)b * nvl);
}

// VE/VF/VT: each valid slot v of taby[y] sets bit y of row v. taby is
// (B, NY, ay), colg (B, NY); grid (B, ceil(nvl / rows)).
__global__ void __launch_bounds__(kBitsThreads)
member_bits_kernel(const int* __restrict__ taby, const int* __restrict__ colg,
                   int* __restrict__ M, int* __restrict__ L, int NY, int ay,
                   int nvl, int deg, int rows) {
  extern __shared__ __align__(16) unsigned bits_smem[];
  const int b = blockIdx.x;
  const int r0 = blockIdx.y * rows;
  const int nr = min(rows, nvl - r0);
  const int W = (NY + 31) >> 5;
  unsigned* mask = bits_smem;
  int* pre = reinterpret_cast<int*>(bits_smem + (size_t)rows * W);
  for (int i = threadIdx.x; i < nr * W; i += blockDim.x) mask[i] = 0u;
  __syncthreads();
  const int* tb = taby + (size_t)b * NY * ay;
  const int n = NY * ay;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {   // coalesced walk
    const int v = tb[i];
    const int r = v - r0;
    if ((unsigned)v < (unsigned)nvl && (unsigned)r < (unsigned)nr) {
      const int y = i / ay;
      atomicOr(&mask[(size_t)r * W + (y >> 5)], 1u << (y & 31));
    }
  }
  __syncthreads();
  emit_bit_rows(mask, pre, r0, nr, W, deg, MemberValue{colg + (size_t)b * NY},
                M + (size_t)b * nvl * deg, L + (size_t)b * nvl);
}

// Sorts four values ascending in registers: the 5-comparator network.
__device__ __forceinline__ void sort4(int& a, int& b, int& c, int& d) {
  int t;
#define SR_CSWAP(x, y) if (x > y) { t = x; x = y; y = t; }
  SR_CSWAP(a, b) SR_CSWAP(c, d) SR_CSWAP(a, c) SR_CSWAP(b, d) SR_CSWAP(b, c)
#undef SR_CSWAP
}

// Sorts the first n values of v ascending (insertion, in registers).
template <int n>
__device__ __forceinline__ void sort_small(int* v) {
#pragma unroll
  for (int i = 1; i < n; ++i) {
#pragma unroll
    for (int j = i; j > 0; --j) {
      if (v[j - 1] > v[j]) {
        const int t = v[j - 1];
        v[j - 1] = v[j];
        v[j] = t;
      }
    }
  }
}

// TT. Each valid local tet t gives its four sorted vertex triples as face
// keys (a * nvl + b) * nvl + c at face lanes f * NT + t (face-major, as the
// reference); padding tets and the lanes past 4 * NT carry kBig. One block
// sorts the EJ lanes of its segment as 64-bit composites (face_key << 32) |
// lane: equal faces are ordered by lane, so the order of a face's cofacets
// does not depend on the sort network, and the lane rides in the key.
//
// Sort: bitonic, with the lanes of one warp's 128-lane chunk held in
// registers (chunk element r * 32 + lane in v[r]): strides of 32 and 64 are
// compare-exchanged inside a thread, strides below 32 through
// __shfl_xor_sync. Only strides of 128 and more go through the lane array
// (shared memory, or the device workspace) with a __syncthreads() each.
//
// Partner slots: each sorted position with a valid key compares its face
// with its two neighbours and writes the neighbour's tet, or -1, into the
// (previous, next) slots of its own lane: every lane writes only its own
// slots. Under the arm's precondition (a face has at most two cofacet tets)
// these are exactly the directed entries of the reference's adjacent-pair
// construction, both ways round.
//
// Row pass: one thread per local tet reads the 8 slots of its four face
// lanes, sorts them in registers, drops -1 and duplicates, and writes the
// true count L[t] and M[t, d] = col_global[t1_d] (-1 past min(L, deg)) into
// the block's staged M rows, which are then stored contiguously.
constexpr int kTTPer = 4;                    // lanes a thread holds
constexpr int kTTChunk = 32 * kTTPer;        // lanes a warp sorts alone

typedef unsigned long long u64;

template <class T>
__device__ __forceinline__ void cswap(T& a, T& b, bool up) {
  if ((a > b) == up) {
    const T t = a;
    a = b;
    b = t;
  }
}

// The bitonic passes of merge size k with strides jmax..1 (jmax < 32 * R)
// over one warp's chunk of 32 * R lanes, starting at lane index base, held
// in registers (lane i of the chunk in v[i / 32] of lane i % 32): the TT
// kernel's 64-bit face lanes (R = kTTPer), the CSR rows' 32-bit order keys.
template <class T, int R>
__device__ __forceinline__ void warp_passes(T (&v)[R], int base, int k,
                                            int jmax) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 16 * R; j > 0; j >>= 1) {
    if (j > jmax) continue;
    if (j >= 32) {
      const int rj = j >> 5;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if ((r & rj) == 0) {
          cswap(v[r], v[r | rj], ((base + r * 32 + lane) & k) == 0);
        }
      }
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const T o = __shfl_xor_sync(0xffffffffu, v[r], j);
        const bool up = ((base + r * 32 + lane) & k) == 0;
        const bool lower = (lane & j) == 0;
        const bool keep_min = lower == up;
        v[r] = (keep_min == (o < v[r])) ? o : v[r];
      }
    }
  }
}

// int32 words of one TT segment's working set, as the wrapper's
// tt_lane_ints: the EJ sorted 64-bit lanes (the staged M rows reuse them
// once the slots are written), then two partner slots per face lane.
__host__ __device__ __forceinline__ size_t tt_lane_ints(int NT, int deg,
                                                        int EJ) {
  size_t a = 2 * (size_t)EJ;
  size_t m = (size_t)NT * deg;
  m += m & 1;
  return (a > m ? a : m) + 8 * (size_t)NT;
}

// tet is (B, NT, 4), colg (B, NT); EJ = max(128, next_pow2(4 * NT)) and
// blockDim.x = min(1024, EJ / kTTPer).
template <bool kGlobalLanes>
__global__ void __launch_bounds__(1024)
tt_entries_kernel(const int* __restrict__ tet, const int* __restrict__ colg,
                  int* __restrict__ M, int* __restrict__ L, int* work, int NT,
                  int nvl, int deg, int EJ) {
  const int b = blockIdx.x;
  const size_t per = tt_lane_ints(NT, deg, EJ);
  int* base_ints = segment_lanes<kGlobalLanes>(work, b, per);
  u64* lanes = reinterpret_cast<u64*>(base_ints);
  int* Ms = base_ints;
  const size_t lane_words = per - 8 * (size_t)NT;
  int2* slots = reinterpret_cast<int2*>(base_ints + lane_words);
  const int* tb = tet + (size_t)b * NT * 4;
  const int* cg = colg + (size_t)b * NT;
  const int n4 = 4 * NT;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const int nchunk = EJ / kTTChunk;

  // face lanes, each chunk sorted in registers (merge sizes up to 128)
  for (int c = warp; c < nchunk; c += nwarps) {
    const int base = c * kTTChunk;
    u64 v[kTTPer];
#pragma unroll
    for (int r = 0; r < kTTPer; ++r) {
      const int i = base + r * 32 + lane;
      unsigned k = (unsigned)kBig;
      if (i < n4) {
        const int f = i / NT;
        const int t = i - f * NT;
        int w0 = tb[t * 4 + 0], w1 = tb[t * 4 + 1];
        int w2 = tb[t * 4 + 2], w3 = tb[t * 4 + 3];
        sort4(w0, w1, w2, w3);
        if (w0 >= 0) {                 // -1 padding sorts first
          // faces (0,1,2), (0,1,3), (0,2,3), (1,2,3) of the sorted tet
          const int a = f == 3 ? w1 : w0;
          const int bb = f >= 2 ? w2 : w1;
          const int cc = f == 0 ? w2 : w3;
          k = (unsigned)((a * nvl + bb) * nvl + cc);
        }
      }
      v[r] = ((u64)k << 32) | (unsigned)i;
    }
#pragma unroll
    for (int k = 2; k <= kTTChunk; k <<= 1) warp_passes(v, base, k, k >> 1);
#pragma unroll
    for (int r = 0; r < kTTPer; ++r) lanes[base + r * 32 + lane] = v[r];
  }
  __syncthreads();

  // merge sizes past one chunk: strides >= 128 through the lane array,
  // then the rest of each merge in registers
  for (int k = 2 * kTTChunk; k <= EJ; k <<= 1) {
    for (int j = k >> 1; j >= kTTChunk; j >>= 1) {
      for (int i = threadIdx.x; i < (EJ >> 1); i += blockDim.x) {
        const int lo = ((i & ~(j - 1)) << 1) | (i & (j - 1));
        u64 a = lanes[lo];
        u64 c = lanes[lo + j];
        if ((a > c) == ((lo & k) == 0)) {
          lanes[lo] = c;
          lanes[lo + j] = a;
        }
      }
      __syncthreads();
    }
    for (int c = warp; c < nchunk; c += nwarps) {
      const int base = c * kTTChunk;
      u64 v[kTTPer];
#pragma unroll
      for (int r = 0; r < kTTPer; ++r) v[r] = lanes[base + r * 32 + lane];
      warp_passes(v, base, k, kTTChunk / 2);
#pragma unroll
      for (int r = 0; r < kTTPer; ++r) lanes[base + r * 32 + lane] = v[r];
    }
    __syncthreads();
  }

  // partner slots: each face lane's (previous, next) cofacet tet, or -1
  for (int p = threadIdx.x; p < EJ; p += blockDim.x) {
    const u64 me = lanes[p];
    const int ln = (int)(unsigned)me;
    if (ln >= n4) continue;            // a lane past 4 * NT: no slots
    const unsigned f = (unsigned)(me >> 32);
    int prev = -1;
    int next = -1;
    if (f != (unsigned)kBig) {
      if (p > 0) {
        const u64 o = lanes[p - 1];
        if ((unsigned)(o >> 32) == f) prev = (int)((unsigned)o % NT);
      }
      if (p + 1 < EJ) {
        const u64 o = lanes[p + 1];
        if ((unsigned)(o >> 32) == f) next = (int)((unsigned)o % NT);
      }
    }
    slots[ln] = make_int2(prev, next);
  }
  __syncthreads();

  // row pass: the 8 slots of each tet's face lanes -> L and staged M rows
  for (int t = threadIdx.x; t < NT; t += blockDim.x) {
    int s[8];
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const int2 q = slots[f * NT + t];
      s[2 * f] = q.x;
      s[2 * f + 1] = q.y;
    }
    sort_small<8>(s);
    int* row = Ms + (size_t)t * deg;
    int n = 0;
    int last = -1;
#pragma unroll
    for (int d = 0; d < 8; ++d) {
      if (s[d] >= 0 && s[d] != last) {
        if (n < deg) row[n] = cg[s[d]];
        ++n;
      }
      last = s[d];
    }
    for (int d = n; d < deg; ++d) row[d] = -1;
    L[(size_t)b * NT + t] = n;         // the TRUE count
  }
  __syncthreads();
  const int total = NT * deg;
  int* Mb = M + (size_t)b * total;
  for (int i = threadIdx.x; i < total; i += blockDim.x) Mb[i] = Ms[i];
}

// -- VV and VE/VF/VT on the sort route: CSR rows ----------------------------
//
// One launch of the wrapper runs four passes over its B segments, each a
// launch of the arm's kernel template (vv_entries_kernel<kPass>,
// member_entries_kernel<kPass>), after the segments' row counts are zeroed:
//   kCsrCount  grid (B, tiles): a block counts its tile of the table's
//              entries per row in a shared-memory histogram of nvl ints
//              (in device memory where nvl ints pass the opt-in limit),
//              then adds the nonzero counts into its segment's row counts;
//   kCsrScan   grid B: an exclusive scan of a segment's nvl counts gives
//              its row starts, and the counts return to 0 as cursors
//              (staged in shared memory where nvl ints fit);
//   kCsrPlace  grid (B, tiles): each entry takes a slot in its row by an
//              atomic cursor and writes its order key there (the order
//              within a row does not matter): a block counts its tile per
//              row again in shared memory, reserves each row's run of
//              slots with one atomic on the row's device cursor, and hands
//              the run out by shared-memory atomics on a second walk;
//   kCsrRows   one warp a row: the row's keys are sorted (up to
//              kCsrShort in registers, past that in place in the
//              workspace), duplicates dropped (VV always has them: a pair
//              repeats in every tet that holds both vertices), and the warp
//              writes L, the TRUE count (it may exceed deg: the engine's
//              width check), and M, the value of each of the first deg
//              keys, -1 after.
// An entry is (row, order) with both ids inside their ranges: VV a tet's
// ordered pair (va, vb) of ids in [0, nvl); member the slot v of table row
// y, v in [0, nvl). Anything else (-1 padding, ids past nvl) is dropped
// before it touches a counter. Its value is a function of its order key
// (VVValue, MemberValue), so the workspace holds keys only, and since every
// row is sorted before it is read the blocks do not depend on the order of
// the atomics. The workspace (csr_ints ints a segment): the B segments'
// nvl row counts, then their nvl + 1 row starts, then their n = 12 * NT
// (VV) or ay * NY (member) order keys.

constexpr int kCsrThreads = 512;
constexpr int kCsrWarps = kCsrThreads / 32;
constexpr int kCsrShort = 32 * kTTPer;       // rows sorted in registers
constexpr int kCsrCount = 0;
constexpr int kCsrScan = 1;
constexpr int kCsrPlace = 2;
constexpr int kCsrRows = 3;

struct CsrArgs {
  int* M;
  int* L;
  int* work;
  int B;
  int nvl;
  int deg;
  int tile;          // units of the table a count or place block walks
  int shared_hist;   // the count pass's histogram is in shared memory
};

// VV: a unit is a local tet, its entries the 12 ordered pairs (va, vb) of
// its ids in [0, nvl): row va, order vb. tet is (B, NT, 4), colg (B, NV).
struct VVEntries {
  const int* tet;
  const int* colg;
  int NT;
  int NV;
  __host__ __device__ int units() const { return NT; }
  __host__ __device__ size_t entries() const { return 12 * (size_t)NT; }
  template <class F>
  __device__ __forceinline__ void walk(int b, int t, int nvl, F f) const {
    const int* tb = tet + ((size_t)b * NT + t) * 4;
    const int4 q = (reinterpret_cast<size_t>(tb) & 15) == 0
                       ? *reinterpret_cast<const int4*>(tb)
                       : make_int4(tb[0], tb[1], tb[2], tb[3]);
    const int v[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      if ((unsigned)v[a] >= (unsigned)nvl) continue;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (c != a && (unsigned)v[c] < (unsigned)nvl) f(v[a], v[c]);
      }
    }
  }
  __device__ VVValue value(int b) const {
    return VVValue{colg + (size_t)b * NV, NV};
  }
};

// VE/VF/VT: a unit is a slot of the (NY, ay) table, walked row-major
// (coalesced); slot v of row y is the entry row v, order y. taby is
// (B, NY, ay), colg (B, NY).
struct MemberEntries {
  const int* taby;
  const int* colg;
  int NY;
  int ay;
  __host__ __device__ int units() const { return NY * ay; }
  __host__ __device__ size_t entries() const { return (size_t)NY * ay; }
  template <class F>
  __device__ __forceinline__ void walk(int b, int i, int nvl, F f) const {
    const int v = taby[(size_t)b * NY * ay + i];
    if ((unsigned)v < (unsigned)nvl) f(v, i / ay);
  }
  __device__ MemberValue value(int b) const {
    return MemberValue{colg + (size_t)b * NY};
  }
};

// Segment b's view of the workspace.
struct CsrView {
  int* cnt;      // nvl row counts, then the place pass's cursors
  int* start;    // nvl + 1 row starts
  int* keys;     // n order keys, row by row
};

__device__ __forceinline__ CsrView csr_view(const CsrArgs& a, size_t n,
                                            int b) {
  int* start = a.work + (size_t)a.B * a.nvl;
  int* keys = start + (size_t)a.B * (a.nvl + 1);
  return {a.work + (size_t)b * a.nvl, start + (size_t)b * (a.nvl + 1),
          keys + (size_t)b * n};
}

template <class Arm>
__device__ __forceinline__ void csr_count(const Arm& arm, const CsrArgs& a) {
  extern __shared__ __align__(16) int csr_hist[];
  const int b = blockIdx.x;
  const CsrView w = csr_view(a, arm.entries(), b);
  const int u0 = blockIdx.y * a.tile;
  const int u1 = min(arm.units(), u0 + a.tile);
  if (!a.shared_hist) {
    for (int u = u0 + threadIdx.x; u < u1; u += blockDim.x)
      arm.walk(b, u, a.nvl, [&](int r, int) { atomicAdd(&w.cnt[r], 1); });
    return;
  }
  for (int r = threadIdx.x; r < a.nvl; r += blockDim.x) csr_hist[r] = 0;
  __syncthreads();
  for (int u = u0 + threadIdx.x; u < u1; u += blockDim.x)
    arm.walk(b, u, a.nvl, [&](int r, int) { atomicAdd(&csr_hist[r], 1); });
  __syncthreads();
  for (int r = threadIdx.x; r < a.nvl; r += blockDim.x) {
    const int c = csr_hist[r];
    if (c != 0) atomicAdd(&w.cnt[r], c);
  }
}

// Each thread scans a contiguous chunk of the counts; a block-wide scan of
// the chunks' sums gives each chunk its first start. Where nvl ints fit in
// shared memory (as the count pass's histogram), the counts are staged
// there first by coalesced loads, all in flight at once, and the starts go
// back out the same way: a thread's own chunk would be a chain of
// dependent device-memory round trips (22 of them at nvl 11,008).
template <class Arm>
__device__ __forceinline__ void csr_scan(const Arm& arm, const CsrArgs& a) {
  extern __shared__ __align__(16) int csr_hist[];
  __shared__ int warp_sum[kCsrWarps];
  const CsrView w = csr_view(a, arm.entries(), blockIdx.x);
  const int nvl = a.nvl;
  const bool staged = a.shared_hist;
  int* cnt = w.cnt;
  if (staged) {
#pragma unroll 8
    for (int r = threadIdx.x; r < nvl; r += kCsrThreads)
      csr_hist[r] = w.cnt[r];
    __syncthreads();
    cnt = csr_hist;
  }
  const int chunk = (nvl + kCsrThreads - 1) / kCsrThreads;
  const int lo = min(nvl, (int)threadIdx.x * chunk);
  const int hi = min(nvl, lo + chunk);
  int sum = 0;
  for (int r = lo; r < hi; ++r) sum += cnt[r];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int incl = sum;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += o;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int v = lane < kCsrWarps ? warp_sum[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int o = __shfl_up_sync(0xffffffffu, v, d);
      if (lane >= d) v += o;
    }
    if (lane < kCsrWarps) warp_sum[lane] = v;      // inclusive over warps
  }
  __syncthreads();
  int run = incl - sum + (warp > 0 ? warp_sum[warp - 1] : 0);
  for (int r = lo; r < hi; ++r) {
    const int c = cnt[r];
    if (staged) {
      cnt[r] = run;
    } else {
      w.start[r] = run;
      w.cnt[r] = 0;
    }
    run += c;
  }
  if (threadIdx.x == 0) w.start[nvl] = warp_sum[kCsrWarps - 1];
  if (staged) {
    __syncthreads();
#pragma unroll 8
    for (int r = threadIdx.x; r < nvl; r += kCsrThreads) {
      w.start[r] = csr_hist[r];
      w.cnt[r] = 0;
    }
  }
}

// With the shared histogram, a block counts its tile's entries per row
// again, reserves each row's run of slots with one device-memory atomic,
// and hands the slots out by shared-memory atomics on a second walk of its
// tile (L2 serves it), so the device-memory atomics are one a row the tile
// touches, not one an entry.
template <class Arm>
__device__ __forceinline__ void csr_place(const Arm& arm, const CsrArgs& a) {
  extern __shared__ __align__(16) int csr_hist[];
  const int b = blockIdx.x;
  const CsrView w = csr_view(a, arm.entries(), b);
  const int u0 = blockIdx.y * a.tile;
  const int u1 = min(arm.units(), u0 + a.tile);
  if (!a.shared_hist) {
    for (int u = u0 + threadIdx.x; u < u1; u += blockDim.x)
      arm.walk(b, u, a.nvl, [&](int r, int o) {
        w.keys[w.start[r] + atomicAdd(&w.cnt[r], 1)] = o;
      });
    return;
  }
  for (int r = threadIdx.x; r < a.nvl; r += blockDim.x) csr_hist[r] = 0;
  __syncthreads();
  for (int u = u0 + threadIdx.x; u < u1; u += blockDim.x)
    arm.walk(b, u, a.nvl, [&](int r, int) { atomicAdd(&csr_hist[r], 1); });
  __syncthreads();
  for (int r = threadIdx.x; r < a.nvl; r += blockDim.x) {
    const int c = csr_hist[r];
    if (c != 0) csr_hist[r] = w.start[r] + atomicAdd(&w.cnt[r], c);
  }
  __syncthreads();
  for (int u = u0 + threadIdx.x; u < u1; u += blockDim.x)
    arm.walk(b, u, a.nvl, [&](int r, int o) {
      w.keys[atomicAdd(&csr_hist[r], 1)] = o;
    });
}

// One chunk of 32 keys of a sorted row: lane's key x is new where ``uniq``;
// the new keys take the next ranks in lane order, and those below deg write
// their values to the M row.
template <class Value>
__device__ __forceinline__ void csr_emit(bool uniq, int x, int& n, int deg,
                                         const Value& value, int* Mr) {
  const unsigned bal = __ballot_sync(0xffffffffu, uniq);
  const int rank = n + __popc(bal & ((1u << (threadIdx.x & 31)) - 1u));
  if (uniq && rank < deg) Mr[rank] = value(x);
  n += __popc(bal);
}

// Sorts keys[0, c) ascending in place, one warp, by the bitonic network
// whose first comparator of each merge pairs mirror images (lo, lo ^ (k -
// 1)) and whose others are half-cleaners (lo, lo + j), every comparator
// keeping the smaller key at the lower index. Virtual keys past c, larger
// than any, would never move, so a comparator reaching past c is skipped
// and the row needs no padding.
__device__ __forceinline__ void warp_sort_in_place(int* keys, int c) {
  const int lane = threadIdx.x & 31;
  int P = 1;
  while (P < c) P <<= 1;
  for (int k = 2; k <= P; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = lane; i < (P >> 1); i += 32) {
        const int lo = ((i & ~(j - 1)) << 1) | (i & (j - 1));
        const int hi = j == (k >> 1) ? lo ^ (k - 1) : lo + j;
        if (hi >= c) continue;
        const int x = keys[lo];
        const int y = keys[hi];
        if (x > y) {
          keys[lo] = y;
          keys[hi] = x;
        }
      }
      __syncwarp();
    }
  }
}

// A row of c <= 32 * R keys, sorted in R registers a lane (key i in v[i /
// 32] of lane i % 32, padded with kBig) and emitted.
template <int R, class Value>
__device__ __forceinline__ void csr_short_row(const int* keys, int c,
                                              int deg, const Value& value,
                                              int* Mr, int& n) {
  const int lane = threadIdx.x & 31;
  int v[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int i = k * 32 + lane;
    v[k] = i < c ? keys[i] : kBig;
  }
#pragma unroll
  for (int k = 2; k <= 32 * R; k <<= 1) warp_passes(v, 0, k, k >> 1);
#pragma unroll
  for (int k = 0; k < R; ++k) {
    if (k * 32 < c) {                              // the same in every lane
      const int x = v[k];
      int prev = __shfl_up_sync(0xffffffffu, x, 1);
      const int carry = __shfl_sync(0xffffffffu, v[k > 0 ? k - 1 : 0], 31);
      if (lane == 0) prev = k > 0 ? carry : -1;    // keys are >= 0
      csr_emit(x != kBig && x != prev, x, n, deg, value, Mr);
    }
  }
}

template <class Arm>
__device__ __forceinline__ void csr_rows(const Arm& arm, const CsrArgs& a) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kCsrWarps + (threadIdx.x >> 5);
  if (row >= (long long)a.B * a.nvl) return;       // the whole warp
  const int b = (int)(row / a.nvl);
  const int r = (int)(row - (long long)b * a.nvl);
  const CsrView w = csr_view(a, arm.entries(), b);
  const int s = w.start[r];
  const int c = w.start[r + 1] - s;
  int* keys = w.keys + s;
  const auto value = arm.value(b);
  int* Mr = a.M + (size_t)row * a.deg;
  int n = 0;                                       // distinct keys so far
  if (c <= 32) {
    csr_short_row<1>(keys, c, a.deg, value, Mr, n);
  } else if (c <= 64) {
    csr_short_row<2>(keys, c, a.deg, value, Mr, n);
  } else if (c <= kCsrShort) {
    csr_short_row<4>(keys, c, a.deg, value, Mr, n);
  } else {
    warp_sort_in_place(keys, c);
    for (int i0 = 0; i0 < c; i0 += 32) {
      const int i = i0 + lane;
      const int x = i < c ? keys[i] : kBig;
      const int prev = i > 0 && i < c ? keys[i - 1] : -1;
      csr_emit(i < c && x != prev, x, n, a.deg, value, Mr);
    }
  }
  for (int d = min(n, a.deg) + lane; d < a.deg; d += 32) Mr[d] = -1;
  if (lane == 0) a.L[row] = n;
}

template <int kPass, class Arm>
__device__ __forceinline__ void csr_pass(const Arm& arm, const CsrArgs& a) {
  if constexpr (kPass == kCsrCount) {
    csr_count(arm, a);
  } else if constexpr (kPass == kCsrScan) {
    csr_scan(arm, a);
  } else if constexpr (kPass == kCsrPlace) {
    csr_place(arm, a);
  } else {
    csr_rows(arm, a);
  }
}

// Blocks a multiprocessor keeps of each pass: the rows pass is bound by
// the latency of each warp's row, so it asks for the most warps (4 blocks of
// 512 threads, at most 32 registers a thread).
template <int kPass>
constexpr int csr_min_blocks() {
  return kPass == kCsrRows ? 4 : 1;
}

template <int kPass>
__global__ void __launch_bounds__(kCsrThreads, csr_min_blocks<kPass>())
vv_entries_kernel(const VVEntries arm, const CsrArgs a) {
  csr_pass<kPass>(arm, a);
}

template <int kPass>
__global__ void __launch_bounds__(kCsrThreads, csr_min_blocks<kPass>())
member_entries_kernel(const MemberEntries arm, const CsrArgs a) {
  csr_pass<kPass>(arm, a);
}

// The arity-AX vertex subsets of an arity-AY simplex, as slot indices, in
// itertools.combinations order: (2 of 3) EF, (2 of 4) ET, (3 of 4) FT.
__constant__ int kComb23[3][3] = {{0, 1, -1}, {0, 2, -1}, {1, 2, -1}};
__constant__ int kComb24[6][3] = {{0, 1, -1}, {0, 2, -1}, {0, 3, -1},
                                  {1, 2, -1}, {1, 3, -1}, {2, 3, -1}};
__constant__ int kComb34[4][3] = {{0, 1, 2}, {0, 1, 3}, {0, 2, 3},
                                  {1, 2, 3}};

template <int AX, int AY>
struct Combos;
template <>
struct Combos<2, 3> {
  static constexpr int n = 3;
  __device__ static int slot(int c, int j) { return kComb23[c][j]; }
};
template <>
struct Combos<2, 4> {
  static constexpr int n = 6;
  __device__ static int slot(int c, int j) { return kComb24[c][j]; }
};
template <>
struct Combos<3, 4> {
  static constexpr int n = 4;
  __device__ static int slot(int c, int j) { return kComb34[c][j]; }
};

// EF/ET/FT: a sort join. Each valid x row contributes its sorted vertex key
// times 2 (even) with payload x; each valid y row contributes the keys of
// its AX-vertex subsets times 2, plus 1 (odd), with payload y. After one
// lane sort an x key sits right before the equal y keys (key - 1 == x key),
// so every y lane resolves its x row from the latest x lane at or before
// it: a block-wide inclusive running max of x lane indices (the
// reference's _cummax_lanes), done here as a carried "last x" scan, with
// the key re-checked. The entries (key x * NY + y, value col_global[y]) go
// through emit_entries with R = NX and O = NY. INT32_MAX, the sentinel, is
// odd, so it is excluded before the parity test.
// tabx is (B, NX, AX), taby (B, NY, AY), colg (B, NY).
template <int AX, int AY, bool kGlobalLanes>
__global__ void __launch_bounds__(1024)
sub_entries_kernel(const int* __restrict__ tabx, const int* __restrict__ taby,
                   const int* __restrict__ colg, int* __restrict__ M,
                   int* __restrict__ L, int* work, int NX, int NY, int nvl,
                   int deg, int E) {
  __shared__ int warp_last[32];
  const int b = blockIdx.x;
  const size_t per = 2 * (size_t)E + NX + 1;
  int* key = segment_lanes<kGlobalLanes>(work, b, per);
  int* val = key + E;
  int* starts = val + E;
  const int* xb = tabx + (size_t)b * NX * AX;
  const int* yb = taby + (size_t)b * NY * AY;
  const int* cg = colg + (size_t)b * NY;
  constexpr int NYK = Combos<AX, AY>::n;
  const int n = NX + NY * NYK;
  for (int i = threadIdx.x; i < E; i += blockDim.x) {
    int k = kBig;
    int p = 0;
    if (i < NX) {
      int w[AX];
#pragma unroll
      for (int j = 0; j < AX; ++j) w[j] = xb[i * AX + j];
      sort_small<AX>(w);
      if (w[0] >= 0) {
        int kx = w[0];
#pragma unroll
        for (int j = 1; j < AX; ++j) kx = kx * nvl + w[j];
        k = kx * 2;
        p = i;
      }
    } else if (i < n) {
      const int jj = i - NX;
      const int y = jj / NYK;          // y-major, as the plain arm
      const int c = jj - y * NYK;
      int w[AY];
#pragma unroll
      for (int j = 0; j < AY; ++j) w[j] = yb[y * AY + j];
      sort_small<AY>(w);
      if (w[0] >= 0) {
        int ky = w[Combos<AX, AY>::slot(c, 0)];
#pragma unroll
        for (int j = 1; j < AX; ++j)
          ky = ky * nvl + w[Combos<AX, AY>::slot(c, j)];
        k = ky * 2 + 1;
        p = y;
      }
    }
    key[i] = k;
    val[i] = p;
  }
  __syncthreads();
  bitonic_sort(key, val, E);

  // Running "last x lane" over contiguous per-thread chunks: each thread
  // finds the last x lane of its chunk, a block-wide max scan gives the
  // last x lane before the chunk, and each thread then walks its chunk
  // with that carry, rewriting its own lanes in place.
  const int chunk = (E + blockDim.x - 1) / blockDim.x;
  const int lo = min(E, (int)threadIdx.x * chunk);
  const int hi = min(E, lo + chunk);
  int mine = -1;
  for (int i = lo; i < hi; ++i) {
    const int k = key[i];
    if (k != kBig && (k & 1) == 0) mine = i;
  }
  // inclusive max scan over the threads of the block
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  int incl = mine;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl = max(incl, o);
  }
  if (lane == 31) warp_last[wid] = incl;
  __syncthreads();
  if (wid == 0) {
    const int nw = (blockDim.x + 31) >> 5;
    int v = lane < nw ? warp_last[lane] : -1;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int o = __shfl_up_sync(0xffffffffu, v, d);
      if (lane >= d) v = max(v, o);
    }
    if (lane < nw) warp_last[lane] = v;      // inclusive over warps
  }
  __syncthreads();
  int before = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) before = -1;
  if (wid > 0) before = max(before, warp_last[wid - 1]);
  // the carry: key and payload of the last x lane before this chunk
  int cur_key = before >= 0 ? key[before] : kBig;
  int cur_row = before >= 0 ? val[before] : 0;
  bool have = before >= 0;
  __syncthreads();                 // every carry read before any rewrite
  for (int i = lo; i < hi; ++i) {
    const int k = key[i];
    const int p = val[i];
    int ek = kBig;
    int ev = 0;
    if (k != kBig && (k & 1) == 0) {
      cur_key = k;
      cur_row = p;
      have = true;
    } else if (k != kBig && have && cur_key == k - 1) {
      ek = cur_row * NY + p;
      ev = cg[p];
    }
    key[i] = ek;
    val[i] = ev;
  }
  __syncthreads();
  emit_entries(key, val, starts, E, NX, NY, deg,
               M + (size_t)b * NX * deg, L + (size_t)b * NX);
}

// EF/ET/FT as a keyed row bitmask (see the header): the block's lookup of
// its own rows' x keys, a walk of the segment's larger x rows that lets a
// larger x take a key it repeats, then one walk of the y table probing
// each subset key, then the emission (emit_sparse_rows, or emit_wide_rows
// for few wide rows); kSubThreads threads. tabx is (B, NX, AX), taby (B,
// NY, AY), colg (B, NY); grid (B, ceil(NX / rows)). Shared memory
// (sub_bits_smem_ints): the block's mask rows at a stride of Ws = W | 1
// words, odd, so that the 32 threads of a warp reading their rows' word w
// fall in 32 banks; then the lookup's keys and x indices, sub_slots(rows)
// slots, the same in every block of a launch; then the least and the
// largest key the lookup holds.
//
// Nearly every subset key the walk probes is some other block's (at
// capacity 1024 a block holds ~100 of 11,520 edges), so a probe usually
// ends at an empty slot. Two things keep that cheap: the lookup runs at a
// load of at most one quarter (sub_slots = next_pow2(4 * rows)), so a
// miss reads ~1.3 slots; and a key outside the block's [least, largest]
// key range is not probed at all (a segment's subject rows come in global
// id order, so a block's keys span a narrow range: on the 24^3 tables at
// capacity 1024 ~15% of EF's subset keys fall in a block's range). On an
// H100 at the capacity-1024 EF tables the lower load alone took 2.064 ms
// against 2.449 at a load of one half (tools/time_entries.py, B = 64).
__host__ __device__ __forceinline__ int sub_slots(int rows) {
  int s = 4;
  while (s < 4 * rows) s <<= 1;
  return s;
}

__host__ __device__ __forceinline__ size_t sub_bits_smem_ints(int rows,
                                                              int W) {
  return (size_t)rows * (W | 1) + 2 * (size_t)sub_slots(rows) + 2;
}

// Fibonacci hashing of a key to one of 2^lg slots.
__device__ __forceinline__ unsigned sub_hash(int key, int lg) {
  return ((unsigned)key * 2654435761u) >> (32 - lg);
}

// f(key) for the sorted vertex key (base nvl) of each AX-id subset of the
// sorted ids w: pairs (EF, ET) or the triples that omit one id (FT). The
// loops unroll to register indices; the order does not matter (setting a
// bit commutes).
template <int AX, int AY, class F>
__device__ __forceinline__ void for_subset_keys(const int (&w)[AY], int nvl,
                                                F f) {
  static_assert(AX == 2 || (AX == 3 && AY == 4), "EF, ET or FT");
  if constexpr (AX == 2) {
#pragma unroll
    for (int i = 0; i < AY; ++i) {
#pragma unroll
      for (int j = i + 1; j < AY; ++j) f(w[i] * nvl + w[j]);
    }
  } else {
#pragma unroll
    for (int o = 0; o < AY; ++o) {
      int k = 0;
#pragma unroll
      for (int i = 0; i < AY; ++i) k = i == o ? k : k * nvl + w[i];
      f(k);
    }
  }
}

// Rows [r0, r0 + nr) of a mask whose rows hold few bits (a subject lies in
// a handful of cofaces) -> M and L, one thread a row: the thread walks its
// row's W words in order, writes the value of each set bit while fewer
// than deg are written, counts the rest by popcount (L is the TRUE count),
// and pads M with -1. Rows are Ws words apart.
template <class Value>
__device__ __forceinline__ void emit_sparse_rows(const unsigned* mask,
                                                 int r0, int nr, int W,
                                                 int Ws, int deg,
                                                 const Value& value, int* M,
                                                 int* L) {
  const bool vec = (deg & 3) == 0;     // rows of whole int4 groups
  for (int r = threadIdx.x; r < nr; r += blockDim.x) {
    const unsigned* row = mask + (size_t)r * Ws;
    int* Mr = M + (size_t)(r0 + r) * deg;
    int n = 0;
    int4 q = make_int4(-1, -1, -1, -1);
    for (int w = 0; w < W; ++w) {
      unsigned bits = row[w];
      while (bits != 0u && n < deg) {
        const int v = value(32 * w + __ffs(bits) - 1);
        bits &= bits - 1u;
        if (!vec) {
          Mr[n++] = v;
          continue;
        }
        const int s = n++ & 3;         // the int4 group fills in registers
        q.x = s == 0 ? v : q.x;
        q.y = s == 1 ? v : q.y;
        q.z = s == 2 ? v : q.z;
        q.w = s == 3 ? v : q.w;
        if (s == 3) {
          reinterpret_cast<int4*>(Mr)[n / 4 - 1] = q;
          q = make_int4(-1, -1, -1, -1);
        }
      }
      n += __popc(bits);
    }
    if (vec) {
      // the groups past those stored: q (the partial group, whose unset
      // slots kept their -1), then groups of -1
      for (int g = min(n, deg) >> 2; g < deg / 4; ++g) {
        reinterpret_cast<int4*>(Mr)[g] = q;
        q = make_int4(-1, -1, -1, -1);
      }
    } else {
      for (int d = n; d < deg; ++d) Mr[d] = -1;
    }
    L[r0 + r] = n;
  }
}

// The same rows -> M and L where a block holds few rows of many words (the
// sub-join past NX 8192: ~100 rows of 565 words for EF at capacity 1024),
// g lanes a row (g a power of two, 2..32, so that g * rows <= blockDim.x):
// the g lanes read g consecutive words at a time, an inclusive scan over
// the g lanes of their words' bit counts gives each lane the rank of its
// word's first set bit, and each lane writes its bits' values at those
// ranks while below deg. The rows come out as emit_sparse_rows writes them.
// Every thread of the block runs the same number of steps (rows past nr
// read no word), so the shuffles see whole warps.
template <class Value>
__device__ __forceinline__ void emit_wide_rows(const unsigned* mask, int r0,
                                               int nr, int W, int Ws,
                                               int deg, int g,
                                               const Value& value, int* M,
                                               int* L) {
  const int lane = threadIdx.x & (g - 1);
  const int per = blockDim.x / g;          // rows emitted at a time
  for (int rb = 0; rb < nr; rb += per) {
    const int r = rb + threadIdx.x / g;
    const bool live = r < nr;
    const unsigned* row = mask + (size_t)r * Ws;
    int* Mr = M + (size_t)(r0 + r) * deg;
    int n = 0;                             // the row's set bits so far
    for (int w0 = 0; w0 < W; w0 += g) {
      const int w = w0 + lane;
      unsigned bits = live && w < W ? row[w] : 0u;
      const int c = __popc(bits);
      int incl = c;
      for (int d = 1; d < g; d <<= 1) {
        const int o = __shfl_up_sync(0xffffffffu, incl, d, g);
        if (lane >= d) incl += o;
      }
      int pos = n + incl - c;
      while (bits != 0u && pos < deg) {
        Mr[pos++] = value(32 * w + __ffs(bits) - 1);
        bits &= bits - 1u;
      }
      n += __shfl_sync(0xffffffffu, incl, g - 1, g);
    }
    if (live) {
      for (int d = min(n, deg) + lane; d < deg; d += g) Mr[d] = -1;
      if (lane == 0) L[r0 + r] = n;
    }
  }
}

constexpr int kSubThreads = 1024;
constexpr int kSubUnroll = 2;          // table rows a thread loads at once

// Rows i, i + blockDim.x, ... (kSubUnroll of them, from i) of a (n, A)
// table, ids sorted; rows past n read as -1. The loads are issued together,
// ahead of the lookups that use them.
template <int A>
__device__ __forceinline__ void load_sorted_rows(const int* tab, int i, int n,
                                                 int (&w)[kSubUnroll][A]) {
#pragma unroll
  for (int u = 0; u < kSubUnroll; ++u) {
    const int row = i + u * (int)blockDim.x;
#pragma unroll
    for (int j = 0; j < A; ++j)
      w[u][j] = row < n ? tab[(size_t)row * A + j] : -1;
  }
#pragma unroll
  for (int u = 0; u < kSubUnroll; ++u) sort_small<A>(w[u]);
}

// The sorted vertex key (base nvl) of sorted ids w, or -1 where the row is
// padding or holds an id outside [0, nvl).
template <int A>
__device__ __forceinline__ int sorted_key(const int (&w)[A], int nvl) {
  if (w[0] < 0 || w[A - 1] >= nvl) return -1;
  int key = w[0];
#pragma unroll
  for (int j = 1; j < A; ++j) key = key * nvl + w[j];
  return key;
}

template <int AX, int AY>
__global__ void __launch_bounds__(kSubThreads)
sub_bits_kernel(const int* __restrict__ tabx, const int* __restrict__ taby,
                const int* __restrict__ colg, int* __restrict__ M,
                int* __restrict__ L, int NX, int NY, int nvl, int deg,
                int rows) {
  extern __shared__ __align__(16) unsigned bits_smem[];
  const int b = blockIdx.x;
  const int r0 = blockIdx.y * rows;
  const int nr = min(rows, NX - r0);
  const int W = (NY + 31) >> 5;
  const int Ws = W | 1;
  const int S = sub_slots(rows);
  const int lg = 31 - __clz(S);
  unsigned* mask = bits_smem;
  int* hkey = reinterpret_cast<int*>(bits_smem + (size_t)rows * Ws);
  int* hx = hkey + S;
  int* span = hx + S;                  // the least and the largest key held
  const int words = nr * Ws;
  uint4* mask4 = reinterpret_cast<uint4*>(mask);
  for (int i = threadIdx.x; i < words / 4; i += blockDim.x)
    mask4[i] = make_uint4(0u, 0u, 0u, 0u);
  for (int i = (words & ~3) + threadIdx.x; i < words; i += blockDim.x)
    mask[i] = 0u;
  for (int i = threadIdx.x; i < S; i += blockDim.x) {
    hkey[i] = -1;                      // keys are >= 0: -1 is an empty slot
    hx[i] = -1;
  }
  if (threadIdx.x == 0) {
    span[0] = 0x7fffffff;
    span[1] = -1;
  }
  __syncthreads();

  // the lookup: the block's own valid x rows, the largest x per key
  const int* xb = tabx + (size_t)b * NX * AX;
  int lo = 0x7fffffff;
  int hi = -1;
  for (int x0 = r0 + threadIdx.x; x0 < r0 + nr;
       x0 += kSubUnroll * blockDim.x) {
    int w[kSubUnroll][AX];
    load_sorted_rows<AX>(xb, x0, r0 + nr, w);
#pragma unroll
    for (int u = 0; u < kSubUnroll; ++u) {
      const int key = sorted_key<AX>(w[u], nvl);
      if (key < 0) continue;
      lo = min(lo, key);
      hi = max(hi, key);
      unsigned h = sub_hash(key, lg);
      while (true) {
        const int prev = atomicCAS(&hkey[h], -1, key);
        if (prev == -1 || prev == key) {
          atomicMax(&hx[h], x0 + u * (int)blockDim.x);
          break;
        }
        h = (h + 1) & (S - 1);
      }
    }
  }
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  if ((threadIdx.x & 31) == 0 && hi >= 0) {
    atomicMin(&span[0], lo);
    atomicMax(&span[1], hi);
  }
  __syncthreads();
  lo = span[0];
  hi = span[1];

  // the tie rule across shares: a larger x of the segment (a later share's
  // row) whose key the lookup holds takes it, so that the key's entries go
  // to the segment's largest x in whichever block holds its rows
  for (int x0 = r0 + nr + threadIdx.x; x0 < NX;
       x0 += kSubUnroll * blockDim.x) {
    int w[kSubUnroll][AX];
    load_sorted_rows<AX>(xb, x0, NX, w);
#pragma unroll
    for (int u = 0; u < kSubUnroll; ++u) {
      const int key = sorted_key<AX>(w[u], nvl);
      if (key < lo || key > hi) continue;      // padding, or not held here
      unsigned h = sub_hash(key, lg);
      while (true) {
        const int k = hkey[h];
        if (k == key) {
          atomicMax(&hx[h], x0 + u * (int)blockDim.x);
          break;
        }
        if (k == -1) break;
        h = (h + 1) & (S - 1);
      }
    }
  }
  __syncthreads();

  // the walk: each valid y's subsets probed, bit y set in the hit x's row
  // when the block holds it
  const int* yb = taby + (size_t)b * NY * AY;
  for (int y0 = threadIdx.x; y0 < NY; y0 += kSubUnroll * blockDim.x) {
    int w[kSubUnroll][AY];
    load_sorted_rows<AY>(yb, y0, NY, w);
#pragma unroll
    for (int u = 0; u < kSubUnroll; ++u) {
      if (w[u][0] < 0 || w[u][AY - 1] >= nvl) continue;
      const int y = y0 + u * (int)blockDim.x;
      for_subset_keys<AX, AY>(w[u], nvl, [&](int key) {
        if (key < lo || key > hi) return;      // not held here
        unsigned h = sub_hash(key, lg);
        int x = -1;
        while (true) {
          const int k = hkey[h];
          if (k == key) {
            x = hx[h];
            break;
          }
          if (k == -1) break;
          h = (h + 1) & (S - 1);
        }
        const int r = x - r0;
        if (x >= 0 && (unsigned)r < (unsigned)nr)
          atomicOr(&mask[(size_t)r * Ws + (y >> 5)], 1u << (y & 31));
      });
    }
  }
  __syncthreads();
  int g = 1;                           // lanes a row, the same in each block
  while (g < 32 && 2 * g * rows <= (int)blockDim.x) g <<= 1;
  const MemberValue value{colg + (size_t)b * NY};
  if (g == 1)
    emit_sparse_rows(mask, r0, nr, W, Ws, deg, value,
                     M + (size_t)b * NX * deg, L + (size_t)b * NX);
  else
    emit_wide_rows(mask, r0, nr, W, Ws, deg, g, value,
                   M + (size_t)b * NX * deg, L + (size_t)b * NX);
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
// (0 on success), read with cudaGetLastError() right after each launch.
// For TT and the sub-join ``work`` is null for the shared-memory variant,
// else a device workspace of B segments' lanes: 2E + R + 1 int32 each
// (tt_lane_ints for TT); VV and member always take one (csr_ints).

extern "C" int sr_smem_optin_limit(int device, int* out) {
  return (int)cudaDeviceGetAttribute(
      out, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
}

extern "C" const char* sr_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

namespace {

// The passes of one sort-route launch of VV or member, on stream s, each
// launch checked: the row counts zeroed, then count, scan, place and rows.
template <class Arm>
cudaError_t launch_csr(void (*const pass[4])(Arm, CsrArgs), const Arm& arm,
                       CsrArgs a, int device, cudaStream_t s) {
  if (a.B < 1 || a.nvl < 1 || a.deg < 1 || a.tile < 1)
    return cudaErrorInvalidValue;
  const int tiles = arm.units() > 0 ? (arm.units() - 1) / a.tile + 1 : 1;
  if (tiles > 65535) return cudaErrorInvalidValue;
  const dim3 grid(a.B, tiles);
  cudaError_t e =
      cudaMemsetAsync(a.work, 0, (size_t)a.B * a.nvl * sizeof(int), s);
  if (e != cudaSuccess) return e;
  int optin = 0;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device);
  if (e != cudaSuccess) return e;
  const size_t hist = (size_t)a.nvl * sizeof(int);
  a.shared_hist = hist <= (size_t)optin;
  if (a.shared_hist) {
    e = allow_smem((const void*)pass[kCsrCount], hist);
    if (e != cudaSuccess) return e;
  }
  pass[kCsrCount]<<<grid, kCsrThreads, a.shared_hist ? hist : 0, s>>>(arm,
                                                                        a);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  if (a.shared_hist) {
    e = allow_smem((const void*)pass[kCsrScan], hist);
    if (e != cudaSuccess) return e;
  }
  pass[kCsrScan]<<<a.B, kCsrThreads, a.shared_hist ? hist : 0, s>>>(arm, a);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  if (a.shared_hist) {
    e = allow_smem((const void*)pass[kCsrPlace], hist);
    if (e != cudaSuccess) return e;
  }
  pass[kCsrPlace]<<<grid, kCsrThreads, a.shared_hist ? hist : 0, s>>>(arm,
                                                                        a);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const long long rows = (long long)a.B * a.nvl;
  const long long blocks = (rows + kCsrWarps - 1) / kCsrWarps;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  pass[kCsrRows]<<<(unsigned)blocks, kCsrThreads, 0, s>>>(arm, a);
  return cudaGetLastError();
}

}  // namespace

// ``tile``: units of the table (VV tets, member table slots) a block of the
// count and place passes walks; the grid is (B, ceil(units / tile)).
// ``work``: csr_ints(n, nvl) int32 a segment (the wrapper's csr_ints).
extern "C" int sr_vv_entries(int device, const void* tet, const void* colg,
                             void* M, void* L, void* work, int B, int NT,
                             int NV, int nvl, int deg, int tile,
                             void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  static void (*const pass[4])(VVEntries, CsrArgs) = {
      vv_entries_kernel<kCsrCount>, vv_entries_kernel<kCsrScan>,
      vv_entries_kernel<kCsrPlace>, vv_entries_kernel<kCsrRows>};
  const VVEntries arm{(const int*)tet, (const int*)colg, NT, NV};
  const CsrArgs a{(int*)M, (int*)L, (int*)work, B, nvl, deg, tile, 0};
  return (int)launch_csr(pass, arm, a, device, (cudaStream_t)stream);
}

extern "C" int sr_member_entries(int device, const void* taby,
                                 const void* colg, void* M, void* L,
                                 void* work, int B, int NY, int ay, int nvl,
                                 int deg, int tile, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  static void (*const pass[4])(MemberEntries, CsrArgs) = {
      member_entries_kernel<kCsrCount>, member_entries_kernel<kCsrScan>,
      member_entries_kernel<kCsrPlace>, member_entries_kernel<kCsrRows>};
  const MemberEntries arm{(const int*)taby, (const int*)colg, NY, ay};
  const CsrArgs a{(int*)M, (int*)L, (int*)work, B, nvl, deg, tile, 0};
  return (int)launch_csr(pass, arm, a, device, (cudaStream_t)stream);
}

namespace {

// Grid and shared memory of a bitmask launch: B segments by ceil(R /
// rows) row shares, ``ints`` of shared memory a block.
cudaError_t bits_launch_shape(const void* fn, int R, int rows, int B,
                              size_t ints, dim3* grid, size_t* bytes) {
  if (rows < 1 || B < 1 || R < 1) return cudaErrorInvalidValue;
  const int shares = (R + rows - 1) / rows;
  if (shares > 65535) return cudaErrorInvalidValue;
  *grid = dim3(B, shares);
  *bytes = ints * sizeof(int);
  return allow_smem(fn, *bytes);
}

}  // namespace

extern "C" int sr_vv_bits(int device, const void* tet, const void* colg,
                          void* M, void* L, int B, int NT, int NV, int nvl,
                          int deg, int rows, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  dim3 grid;
  size_t bytes;
  e = bits_launch_shape((const void*)vv_bits_kernel, nvl, rows, B,
                        bits_smem_ints(rows, (nvl + 31) >> 5), &grid, &bytes);
  if (e != cudaSuccess) return (int)e;
  vv_bits_kernel<<<grid, kBitsThreads, bytes, (cudaStream_t)stream>>>(
      (const int*)tet, (const int*)colg, (int*)M, (int*)L, NT, NV, nvl, deg,
      rows);
  return (int)cudaGetLastError();
}

extern "C" int sr_member_bits(int device, const void* taby, const void* colg,
                              void* M, void* L, int B, int NY, int ay,
                              int nvl, int deg, int rows, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  dim3 grid;
  size_t bytes;
  e = bits_launch_shape((const void*)member_bits_kernel, nvl, rows, B,
                        bits_smem_ints(rows, (NY + 31) >> 5), &grid, &bytes);
  if (e != cudaSuccess) return (int)e;
  member_bits_kernel<<<grid, kBitsThreads, bytes, (cudaStream_t)stream>>>(
      (const int*)taby, (const int*)colg, (int*)M, (int*)L, NY, ay, nvl, deg,
      rows);
  return (int)cudaGetLastError();
}

extern "C" int sr_tt_entries(int device, const void* tet, const void* colg,
                             void* M, void* L, void* work, int B, int NT,
                             int nvl, int deg, int EJ, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (EJ < kTTChunk || (EJ & (EJ - 1)) != 0 || EJ < 4 * NT)
    return (int)cudaErrorInvalidValue;
  const int threads = EJ / kTTPer < 1024 ? EJ / kTTPer : 1024;
  cudaStream_t s = (cudaStream_t)stream;
  if (work != nullptr) {
    tt_entries_kernel<true><<<B, threads, 0, s>>>(
        (const int*)tet, (const int*)colg, (int*)M, (int*)L, (int*)work, NT,
        nvl, deg, EJ);
  } else {
    const size_t bytes = tt_lane_ints(NT, deg, EJ) * sizeof(int);
    e = allow_smem((const void*)tt_entries_kernel<false>, bytes);
    if (e != cudaSuccess) return (int)e;
    tt_entries_kernel<false><<<B, threads, bytes, s>>>(
        (const int*)tet, (const int*)colg, (int*)M, (int*)L, nullptr, NT,
        nvl, deg, EJ);
  }
  return (int)cudaGetLastError();
}

namespace {

template <int AX, int AY>
cudaError_t launch_sub(const void* tabx, const void* taby, const void* colg,
                       void* M, void* L, void* work, int B, int NX, int NY,
                       int nvl, int deg, int E, cudaStream_t s) {
  const int threads = threads_for(E);
  if (work != nullptr) {
    sub_entries_kernel<AX, AY, true><<<B, threads, 0, s>>>(
        (const int*)tabx, (const int*)taby, (const int*)colg, (int*)M,
        (int*)L, (int*)work, NX, NY, nvl, deg, E);
  } else {
    const size_t bytes = (2 * (size_t)E + NX + 1) * sizeof(int);
    cudaError_t e =
        allow_smem((const void*)sub_entries_kernel<AX, AY, false>, bytes);
    if (e != cudaSuccess) return e;
    sub_entries_kernel<AX, AY, false><<<B, threads, bytes, s>>>(
        (const int*)tabx, (const int*)taby, (const int*)colg, (int*)M,
        (int*)L, nullptr, NX, NY, nvl, deg, E);
  }
  return cudaGetLastError();
}

}  // namespace

// ax/ay select the arm: (2, 3) EF, (2, 4) ET, (3, 4) FT.
extern "C" int sr_sub_entries(int device, const void* tabx, const void* taby,
                              const void* colg, void* M, void* L, void* work,
                              int B, int NX, int ax, int NY, int ay, int nvl,
                              int deg, int E, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = (cudaStream_t)stream;
  if (ax == 2 && ay == 3)
    return (int)launch_sub<2, 3>(tabx, taby, colg, M, L, work, B, NX, NY,
                                 nvl, deg, E, s);
  if (ax == 2 && ay == 4)
    return (int)launch_sub<2, 4>(tabx, taby, colg, M, L, work, B, NX, NY,
                                 nvl, deg, E, s);
  if (ax == 3 && ay == 4)
    return (int)launch_sub<3, 4>(tabx, taby, colg, M, L, work, B, NX, NY,
                                 nvl, deg, E, s);
  return (int)cudaErrorInvalidValue;
}

namespace {

template <int AX, int AY>
cudaError_t launch_sub_bits(const void* tabx, const void* taby,
                            const void* colg, void* M, void* L, int B,
                            int NX, int NY, int nvl, int deg, int rows,
                            cudaStream_t s) {
  const void* fn = (const void*)sub_bits_kernel<AX, AY>;
  dim3 grid;
  size_t bytes;
  cudaError_t e = bits_launch_shape(
      fn, NX, rows, B, sub_bits_smem_ints(rows, (NY + 31) >> 5), &grid,
      &bytes);
  if (e != cudaSuccess) return e;
  sub_bits_kernel<AX, AY><<<grid, kSubThreads, bytes, s>>>(
      (const int*)tabx, (const int*)taby, (const int*)colg, (int*)M,
      (int*)L, NX, NY, nvl, deg, rows);
  return cudaGetLastError();
}

}  // namespace

// ax/ay select the arm: (2, 3) EF, (2, 4) ET, (3, 4) FT.
extern "C" int sr_sub_bits(int device, const void* tabx, const void* taby,
                           const void* colg, void* M, void* L, int B, int NX,
                           int ax, int NY, int ay, int nvl, int deg, int rows,
                           void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = (cudaStream_t)stream;
  if (ax == 2 && ay == 3)
    return (int)launch_sub_bits<2, 3>(tabx, taby, colg, M, L, B, NX, NY, nvl,
                                      deg, rows, s);
  if (ax == 2 && ay == 4)
    return (int)launch_sub_bits<2, 4>(tabx, taby, colg, M, L, B, NX, NY, nvl,
                                      deg, rows, s);
  if (ax == 3 && ay == 4)
    return (int)launch_sub_bits<3, 4>(tabx, taby, colg, M, L, B, NX, NY, nvl,
                                      deg, rows, s);
  return (int)cudaErrorInvalidValue;
}
