// Split-Dp matvecs of the phasing ascent, written by hand for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of longcallr_tpu/phasing/pallas_kernels.py:
//   dual_matvec_rows (:190-227, body _rows_kernel :136-157)  -> split_dual_matvec_rows
//   matvec_cols      (:230-265, body _cols_kernel :160-179)  -> split_matvec_cols
//
// Dp = hi + lo is the emission matrix m∘(l1m−lerr)∘p of one region, stored as an
// exact two-term f32 split of its f64 values ([K reads, I SNPs], row-major).
//   rows: out[b,k,c] = Σ_i (hi+lo)[b,k,i] · x[b,i,c]   for c ∈ {0,1}   (Dp·[u v])
//   cols: out[b,i]   = Σ_k s[b,k] · (hi+lo)[b,k,i]                     (Dpᵀ·σ)
// The batch is B members (state vectors) over B/g tables: member b reads table
// b / g ("members per table"). g = 1 is one table per member (a bucket of
// regions), g = B one table for all (one region's enumeration configs), and
// 1 < g < B a bucket of regions with g configs each.
//
// The TPU kernel accumulated in double-f32 (TwoSum) because its vector units have
// no f64. This card has native FP64, so each element is widened to f64 as
// (double)hi + (double)lo and the sums are kept in f64 registers: x and s hold
// values in {−1, 0, +1}, so every term is exact and only the summation order
// differs from the plain f64 contraction. Reductions run in a fixed order and no
// atomics touch the sums, so a launch's result is bit-stable from run to run.
//
// What bounds both: device memory. Each cell is read once (8 bytes of hi+lo) for
// about 4 flops, far below the H100's f64 ridge point; there is no use for tensor
// cores (the operand has 1 or 2 columns) and none for TF32.
//
// rows: a block owns a tile of rows of ONE table, reads those cells once and
// serves every member of the table from on-chip storage. The members are
// walked inside the block, so their number meets no limit of the grid: the
// grid is (row tiles, chunks of a table's members, tables), and the caller
// cuts a table's members into no more chunks than fill the card (a few per
// SM). More than 65,535 tables go in further launches.
//   I <= 32 (the enumeration path: I = 8 or 16, 2 to 1,024 members per table):
//   one thread keeps a whole row, widened to f64 once, in registers. A block is
//   RT row threads by W member ways; the members' x is staged in shared memory
//   a slab of 64 at a time, each thread reads it back as broadcasts, computes
//   both columns for its row and one member after another, and stores
//   out[m,k,0:2] as one 16-byte store, adjacent threads on adjacent rows. No
//   shuffle at all; the sum over i is a chain i = 0..I-1.
//   I > 32 (iterative buckets, one member per table as a rule): one warp per
//   row, lane j on columns j, j+32, ..., a fixed shuffle tree over the lanes.
//   A block that walks more than one member first widens its 8 rows into
//   shared memory and then reads them from there for every member.
// Either way the order of a member's sum depends on I alone: not on the
// members per table, the member's place, or the block that ran. A member's
// result among g members is its result alone on its table, bit for bit.
//
// cols: one launch. A block of 256 threads is TX column threads by 256/TX row
// lanes; each thread owns VEC adjacent columns (VEC = 4: one 16-byte load of hi
// and one of lo per row; VEC = 1 for shapes that are not 16-byte aligned) and
// unrolls 4 rows, so 8 independent loads are outstanding per thread. The grid is
// (column blocks, K chunks, batch; a batch over 65,535 members goes in as many
// launches as grid.z needs) with the K chunk sized by the caller so that
// the card holds at least two blocks per SM. σ for the chunk is staged in shared
// memory, and a row whose σ is 0 is not read at all (its term is exactly 0).
// The row lanes reduce in shared memory in a fixed tree. Each block writes its
// partial sum; a ticket (one integer per column block, the only atomic) tells
// the block that finishes last, which then adds the partials in chunk order —
// an order that does not depend on which block that was — and resets the
// ticket for the next launch. partial and tickets are caller-owned scratch;
// launches that share them must be ordered on one stream.
//
// C interface (loaded with ctypes): each entry point launches on the given
// device and stream, allocates nothing, and returns cudaGetLastError(). The
// launches may be captured into a CUDA graph by PyTorch (phasing/graphs.py):
// this library links its own copy of the CUDA runtime, but streams and
// graphs belong to the CUDA context that every runtime of the process
// shares, so a launch onto a capturing stream becomes a node of that graph;
// graph_kernel_nodes counts such nodes to show it.

#include <cuda/atomic>
#include <cuda_runtime.h>
#include <stdint.h>

#include <vector>

namespace {

constexpr int kRowsThreads = 256;   // most threads of a rows block
constexpr int kWalkSlab = 64;       // members whose x is staged at a time
constexpr int kLaneRows = 8;        // rows of a lanes block, one warp each
constexpr int kMaxDynShared = 227 * 1024;
constexpr int kColsThreads = 256;
constexpr int kColsUnroll = 4;     // rows in flight per thread
constexpr int kColsMaxChunk = 1024;  // rows of σ staged per block
constexpr int kGridYZMax = 65535;    // CUDA's limit on grid.y and grid.z

// Both rows kernels: grid (row tiles, chunks of a table's members, tables
// t0 .. t0 + gridDim.z - 1); a chunk is mb members of the table.
//
// One thread per row, I <= IP cells in registers; FULL: I == IP. Block: RT =
// 1 << rt_log2 row threads by blockDim.x / RT member ways.
template <int IP, bool FULL>
__global__ void __launch_bounds__(kRowsThreads)
rows_walk_kernel(const float* __restrict__ hi, const float* __restrict__ lo,
                 int g, const double2* __restrict__ x, double2* __restrict__ out,
                 int K, int I, int rt_log2, int mb, int vec, int t0) {
  // one more slot per member: ways of one warp then fall on different banks
  __shared__ double2 xs[kWalkSlab * (IP + 1)];

  const int r = threadIdx.x & ((1 << rt_log2) - 1);
  const int w = threadIdx.x >> rt_log2;
  const int ways = blockDim.x >> rt_log2;
  const int table = t0 + blockIdx.z;
  const int k = (blockIdx.x << rt_log2) + r;
  const bool live = k < K;

  // the row, read once: the loads start here and are first used after the
  // first slab of x is on its way, so that the two latencies overlap
  float hr[IP], lr[IP];
#pragma unroll
  for (int i = 0; i < IP; ++i) hr[i] = lr[i] = 0.f;
  if (live) {
    const size_t row = ((size_t)table * K + k) * I;
    const float* h = hi + row;
    const float* l = lo + row;
    if (vec) {                                // I % 4 == 0, 16-byte aligned rows
#pragma unroll
      for (int i = 0; i < IP; i += 4) {
        if (FULL || i < I) {
          const float4 a = __ldg(reinterpret_cast<const float4*>(h + i));
          const float4 b = __ldg(reinterpret_cast<const float4*>(l + i));
          hr[i] = a.x; hr[i + 1] = a.y; hr[i + 2] = a.z; hr[i + 3] = a.w;
          lr[i] = b.x; lr[i + 1] = b.y; lr[i + 2] = b.z; lr[i + 3] = b.w;
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < IP; ++i) {
        if (FULL || i < I) {
          hr[i] = __ldg(h + i);
          lr[i] = __ldg(l + i);
        }
      }
    }
  }

  const int j0 = blockIdx.y * mb;
  const int j1 = min(g, j0 + mb);
  const int stride = I + 1;
  const size_t first = (size_t)table * g;       // the table's first member
  auto stage = [&](int s0, int n) {             // x of members s0 .. s0 + n - 1
    const double2* src = x + (first + s0) * I;
    for (int e = threadIdx.x; e < n * I; e += blockDim.x) {
      const int mm = e / I;
      xs[mm * stride + (e - mm * I)] = src[e];
    }
  };
  int s0 = j0;
  int n = min(kWalkSlab, j1 - s0);
  stage(s0, n);
  double d[IP];                                 // widened once
#pragma unroll
  for (int i = 0; i < IP; ++i) d[i] = (double)hr[i] + (double)lr[i];
  __syncthreads();
  for (;;) {
    if (live) {
      for (int mm = w; mm < n; mm += ways) {
        const double2* xm = xs + mm * stride;
        double a0 = 0.0, a1 = 0.0;
#pragma unroll
        for (int i = 0; i < IP; ++i) {
          if (FULL || i < I) {
            const double2 xi = xm[i];
            a0 = fma(d[i], xi.x, a0);
            a1 = fma(d[i], xi.y, a1);
          }
        }
        out[(first + s0 + mm) * K + k] = make_double2(a0, a1);
      }
    }
    s0 += kWalkSlab;
    if (s0 >= j1) break;
    n = min(kWalkSlab, j1 - s0);
    __syncthreads();                            // the slab before is read out
    stage(s0, n);
    __syncthreads();
  }
}

// One warp per row, kLaneRows rows a block, and one member a block:
// blockIdx.y is its place in the table. Each cell comes straight from hi and
// lo: the stream of an iterative bucket, one member per table.
__global__ void __launch_bounds__(kRowsThreads)
rows_lanes_kernel(const float* __restrict__ hi, const float* __restrict__ lo,
                  int g, const double* __restrict__ x,
                  double* __restrict__ out, int K, int I, int t0) {
  const int lane = threadIdx.x & 31;
  const int table = t0 + blockIdx.z;
  const int k = blockIdx.x * kLaneRows + (threadIdx.x >> 5);
  const size_t m = (size_t)table * g + blockIdx.y;
  // every lane stays for the shuffles; rows past K read nothing
  const bool live = k < K;
  double acc0 = 0.0, acc1 = 0.0;
  if (live) {
    const size_t row = ((size_t)table * K + k) * I;
    const float* h = hi + row;
    const float* l = lo + row;
    const double2* xb = reinterpret_cast<const double2*>(x + m * I * 2);
    for (int i = lane; i < I; i += 32) {
      const double d = (double)h[i] + (double)l[i];
      const double2 xi = xb[i];
      acc0 += d * xi.x;
      acc1 += d * xi.y;
    }
  }
  // fixed-order tree over the warp's lanes
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc0 += __shfl_down_sync(0xffffffffu, acc0, off);
    acc1 += __shfl_down_sync(0xffffffffu, acc1, off);
  }
  if (live && lane == 0) {
    double* o = out + (m * K + k) * 2;
    o[0] = acc0;
    o[1] = acc1;
  }
}

// The same rows and the same sums for a block that serves the mb members of a
// chunk: its rows are widened into shared memory ([kLaneRows][I] f64) once,
// and every member reads them there.
__global__ void __launch_bounds__(kRowsThreads)
rows_lanes_tiled_kernel(const float* __restrict__ hi,
                        const float* __restrict__ lo, int g,
                        const double2* __restrict__ x,
                        double2* __restrict__ out, int K, int I, int mb,
                        int t0) {
  extern __shared__ double tile_rows[];
  const int lane = threadIdx.x & 31;
  const int wrow = threadIdx.x >> 5;
  const int table = t0 + blockIdx.z;
  const int k = blockIdx.x * kLaneRows + wrow;
  if (k >= K) return;                         // a whole warp; no block barrier below
  const float* h = hi + ((size_t)table * K + k) * I;
  const float* l = lo + ((size_t)table * K + k) * I;
  double* mine = tile_rows + (size_t)wrow * I;
  for (int i = lane; i < I; i += 32)
    mine[i] = (double)__ldg(h + i) + (double)__ldg(l + i);
  __syncwarp();
  const int j0 = blockIdx.y * mb;
  const int j1 = min(g, j0 + mb);
  for (int j = j0; j < j1; ++j) {
    const size_t m = (size_t)table * g + j;
    const double2* xb = x + m * I;
    double acc0 = 0.0, acc1 = 0.0;
    for (int i = lane; i < I; i += 32) {
      const double2 xi = xb[i];
      acc0 = fma(mine[i], xi.x, acc0);
      acc1 = fma(mine[i], xi.y, acc1);
    }
    // the same tree
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      acc0 += __shfl_down_sync(0xffffffffu, acc0, off);
      acc1 += __shfl_down_sync(0xffffffffu, acc1, off);
    }
    if (lane == 0) out[m * K + k] = make_double2(acc0, acc1);
  }
}

template <int VEC> struct Cells;
template <> struct Cells<1> {
  float v[1];
  __device__ void zero() { v[0] = 0.f; }
  __device__ void load(const float* p) { v[0] = __ldg(p); }
};
template <> struct Cells<4> {
  float v[4];
  __device__ void zero() { v[0] = v[1] = v[2] = v[3] = 0.f; }
  __device__ void load(const float* p) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  }
};

// Tree over the row lanes of red[ly][column], fixed order; lane 0 ends with the
// block's sum in acc.
template <int VEC>
__device__ void reduce_row_lanes(double (&acc)[VEC], double* red, int lx,
                                 int ly, int ty_n, int width) {
#pragma unroll
  for (int j = 0; j < VEC; ++j) red[ly * width + lx * VEC + j] = acc[j];
  __syncthreads();
  for (int half = ty_n >> 1; half > 0; half >>= 1) {
    if (ly < half) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        acc[j] += red[(ly + half) * width + lx * VEC + j];
        red[ly * width + lx * VEC + j] = acc[j];
      }
    }
    __syncthreads();
  }
}

// Thread coordinates of one cols block: TX column threads (TX = 1 << tx_log2)
// by kColsThreads/TX row lanes, each thread on VEC adjacent columns.
template <int VEC>
struct ColsBlock {
  int ty_n, lx, ly, width, col;
  bool live;
  __device__ ColsBlock(int tx_log2, int I) {
    const int tx = 1 << tx_log2;
    ty_n = kColsThreads >> tx_log2;
    lx = threadIdx.x & (tx - 1);
    ly = threadIdx.x >> tx_log2;
    width = tx * VEC;                       // columns of this block
    col = blockIdx.x * width + lx * VEC;    // first of this thread's columns
    live = col < I;                         // VEC = 4 only when I % 4 == 0
  }
};

// From every thread's sum over its rows to out[b, columns of the block]: the
// row lanes reduce, the block stores its partial and takes a ticket, and the
// block with the last ticket adds the partials in chunk order.
template <int VEC>
__device__ void cols_finish(const ColsBlock<VEC>& t, double (&acc)[VEC],
                            double* red, double* partial,
                            unsigned int* tickets, double* __restrict__ out,
                            int I, int b0 = 0) {
  __shared__ bool is_last;
  const int cb = blockIdx.x, c = blockIdx.y, b = b0 + blockIdx.z;
  const int nch = gridDim.y;
  reduce_row_lanes<VEC>(acc, red, t.lx, t.ly, t.ty_n, t.width);

  double* dst = out + (size_t)b * I + t.col;
  if (nch == 1) {                           // one chunk: the block's sum is the result
    if (t.live && t.ly == 0) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) dst[j] = acc[j];
    }
    return;
  }

  double* pb = partial + (size_t)b * nch * I + t.col;
  if (t.live && t.ly == 0) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) pb[(size_t)c * I + j] = acc[j];
  }
  // publish the partial, then take a ticket; the last ticket combines. One
  // thread takes it for the block, with release and acquire in the one atomic:
  // the barrier orders the block's stores before it, and release is
  // cumulative (the form a grid-wide barrier uses)
  __syncthreads();
  unsigned int* ticket = tickets + (size_t)b * gridDim.x + cb;
  if (threadIdx.x == 0) {
    cuda::atomic_ref<unsigned int, cuda::thread_scope_device> t_ref(*ticket);
    is_last = t_ref.fetch_add(1u, cuda::memory_order_acq_rel) ==
              (unsigned int)(nch - 1);
  }
  __syncthreads();
  if (!is_last) return;

  // row lane ly adds chunks ly, ly + ty_n, ... in that order; then the same
  // fixed tree over the lanes: the order is a function of the shape alone
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] = 0.0;
  if (t.live) {
    for (int cc = t.ly; cc < nch; cc += t.ty_n)
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[j] += __ldcg(pb + (size_t)cc * I + j);
  }
  reduce_row_lanes<VEC>(acc, red, t.lx, t.ly, t.ty_n, t.width);
  if (t.live && t.ly == 0) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) dst[j] = acc[j];
  }
  if (threadIdx.x == 0) *ticket = 0u;       // ready for the next launch
}

// grid (column blocks, K chunks, members b0 .. b0 + gridDim.z - 1 of the
// batch); block kColsThreads.
template <int VEC>
__global__ void __launch_bounds__(kColsThreads)
cols_kernel(const float* __restrict__ hi, const float* __restrict__ lo,
            int g, const double* __restrict__ s,
            double* partial, unsigned int* tickets, double* __restrict__ out,
            int K, int I, int kc, int tx_log2, int b0) {
  __shared__ double s_chunk[kColsMaxChunk];
  __shared__ double red[kColsThreads * VEC];

  const ColsBlock<VEC> t(tx_log2, I);
  const int b = b0 + blockIdx.z;
  const int k0 = blockIdx.y * kc;
  const int n = min(K, k0 + kc) - k0;       // rows of this chunk

  const double* sb = s + (size_t)b * K + k0;
  for (int r = threadIdx.x; r < n; r += kColsThreads) s_chunk[r] = sb[r];
  __syncthreads();

  double acc[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] = 0.0;
  if (t.live) {
    const size_t base = ((size_t)(b / g) * K + k0) * I + t.col;
    const float* h = hi + base;
    const float* l = lo + base;
    for (int r0 = t.ly * kColsUnroll; r0 < n; r0 += t.ty_n * kColsUnroll) {
      double sv[kColsUnroll];
      Cells<VEC> hv[kColsUnroll], lv[kColsUnroll];
#pragma unroll
      for (int u = 0; u < kColsUnroll; ++u)
        sv[u] = (r0 + u < n) ? s_chunk[r0 + u] : 0.0;
#pragma unroll
      for (int u = 0; u < kColsUnroll; ++u) {
        if (sv[u] != 0.0) {                 // a row with σ = 0 is never read
          hv[u].load(h + (size_t)(r0 + u) * I);
          lv[u].load(l + (size_t)(r0 + u) * I);
        } else {
          hv[u].zero();
          lv[u].zero();
        }
      }
#pragma unroll
      for (int u = 0; u < kColsUnroll; ++u)
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          acc[j] += sv[u] * ((double)hv[u].v[j] + (double)lv[u].v[j]);
    }
  }
  cols_finish<VEC>(t, acc, red, partial, tickets, out, I, b0);
}

// Launches on `device` whatever the calling thread's current device is.
struct OnDevice {
  int prev = -1;
  bool moved = false;
  explicit OnDevice(int device) {
    cudaGetDevice(&prev);
    if (prev != device) moved = cudaSetDevice(device) == cudaSuccess;
  }
  ~OnDevice() {
    if (moved) cudaSetDevice(prev);
  }
};

}  // namespace

extern "C" {

// hi, lo: f32 [B/g,K,I] contiguous, member b on table b / g (g: members per
// table, >= 1, B a multiple of it); x: f64 [B,I,2] contiguous and 16-byte
// aligned; out: f64 [B,K,2]. A block takes 1 << rt_log2 rows (at most 256; for
// I > 32 it is 8, one warp each, and rt_log2 is not read) by 1 << ways_log2
// member ways, and walks mb members of its table (I <= 32: mb over its ways;
// I > 32: where mb > 1 and its 8 rows fit into shared memory, else a block
// serves one member); the chunks of a table, ceil(g / mb), may not exceed
// 65,535, whatever g is. vec: rows may be read 16
// bytes at a time (I % 4 == 0, hi and lo aligned). Tables lie on grid.z,
// 65,535 a launch: more tables are as many launches on the stream.
int split_dual_matvec_rows(const float* hi, const float* lo, int g,
                           const double* x, double* out, int B, int K, int I,
                           int rt_log2, int ways_log2, int mb, int vec,
                           int device, void* stream) {
  if (g < 1 || B % g || mb < 1 || rt_log2 < 0 || ways_log2 < 0 ||
      rt_log2 + ways_log2 > 8 || ((uintptr_t)x | (uintptr_t)out) % 16)
    return (int)cudaErrorInvalidValue;
  if (vec && (I % 4 || ((uintptr_t)hi | (uintptr_t)lo) % 16))
    return (int)cudaErrorInvalidValue;
  const bool walk = I <= 32;
  // rows of a lanes block in shared memory, where the block serves more than
  // one member and they fit; else it serves one member
  size_t tile_bytes = (size_t)kLaneRows * I * sizeof(double);
  if (walk || mb == 1 || tile_bytes > (size_t)kMaxDynShared) tile_bytes = 0;
  if (!walk && !tile_bytes) mb = 1;
  const int chunks = (g + mb - 1) / mb;
  if (chunks > kGridYZMax) return (int)cudaErrorInvalidValue;
  const int row_tiles = walk ? (K + (1 << rt_log2) - 1) >> rt_log2
                             : (K + kLaneRows - 1) / kLaneRows;
  const int threads = walk ? 1 << (rt_log2 + ways_log2) : kRowsThreads;
  OnDevice on(device);
  if (tile_bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        rows_lanes_tiled_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)tile_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  cudaStream_t st = (cudaStream_t)stream;
  const double2* x2 = reinterpret_cast<const double2*>(x);
  double2* out2 = reinterpret_cast<double2*>(out);
  const int tables = B / g;
  for (int t0 = 0; t0 < tables; t0 += kGridYZMax) {
    dim3 grid(row_tiles, chunks, min(tables - t0, kGridYZMax));
#define WALK(IP)                                                           \
  if (I == IP)                                                             \
    rows_walk_kernel<IP, true><<<grid, threads, 0, st>>>(                  \
        hi, lo, g, x2, out2, K, I, rt_log2, mb, vec, t0);                  \
  else                                                                     \
    rows_walk_kernel<IP, false><<<grid, threads, 0, st>>>(                 \
        hi, lo, g, x2, out2, K, I, rt_log2, mb, vec, t0)
    if (I <= 8) { WALK(8); }
    else if (I <= 16) { WALK(16); }
    else if (I <= 32) { WALK(32); }
#undef WALK
    else if (tile_bytes)
      rows_lanes_tiled_kernel<<<grid, threads, tile_bytes, st>>>(
          hi, lo, g, x2, out2, K, I, mb, t0);
    else
      rows_lanes_kernel<<<grid, threads, 0, st>>>(hi, lo, g, x, out, K, I,
                                                  t0);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}

// hi, lo and g as above; s: f64 [B,K] contiguous; out: f64 [B,I]. vec: columns
// per thread, 4 (needs I % 4 == 0 and 16-byte aligned hi, lo) or 1; the block
// covers (1 << tx_log2) * vec columns; kc: rows per block, <= 1024. With more
// than one K chunk, partial is f64 scratch [B, ceil(K/kc), I] and tickets is
// zeroed unsigned scratch [B, column blocks] that the kernel leaves zeroed.
// The batch lies on grid.z, 65,535 members a launch: a larger batch is as
// many launches on the stream, each member computed as in one.
int split_matvec_cols(const float* hi, const float* lo, int g,
                      const double* s, double* partial, unsigned int* tickets,
                      double* out, int B, int K, int I, int vec, int tx_log2,
                      int kc, int device, void* stream) {
  if (g < 1 || kc < 1 || kc > kColsMaxChunk || tx_log2 < 0 || tx_log2 > 5 ||
      (vec != 1 && vec != 4))
    return (int)cudaErrorInvalidValue;
  if (vec == 4 && (I % 4 || ((uintptr_t)hi | (uintptr_t)lo) % 16))
    return (int)cudaErrorInvalidValue;
  const int width = (1 << tx_log2) * vec;
  const int nch = (K + kc - 1) / kc;
  if (nch > kGridYZMax) return (int)cudaErrorInvalidValue;
  OnDevice on(device);
  cudaStream_t st = (cudaStream_t)stream;
  for (int b0 = 0; b0 < B; b0 += kGridYZMax) {
    dim3 grid((I + width - 1) / width, nch, min(B - b0, kGridYZMax));
    if (vec == 4)
      cols_kernel<4><<<grid, kColsThreads, 0, st>>>(
          hi, lo, g, s, partial, tickets, out, K, I, kc, tx_log2, b0);
    else
      cols_kernel<1><<<grid, kColsThreads, 0, st>>>(
          hi, lo, g, s, partial, tickets, out, K, I, kc, tx_log2, b0);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}

// The kernel nodes of a CUDA graph (a cudaGraph_t) into *n.
int graph_kernel_nodes(void* graph, int* n) {
  cudaGraph_t g = (cudaGraph_t)graph;
  size_t count = 0;
  cudaError_t e = cudaGraphGetNodes(g, nullptr, &count);
  if (e != cudaSuccess) return (int)e;
  std::vector<cudaGraphNode_t> nodes(count);
  if (count) {
    e = cudaGraphGetNodes(g, nodes.data(), &count);
    if (e != cudaSuccess) return (int)e;
  }
  int kernels = 0;
  for (size_t i = 0; i < count; ++i) {
    cudaGraphNodeType type;
    e = cudaGraphNodeGetType(nodes[i], &type);
    if (e != cudaSuccess) return (int)e;
    kernels += type == cudaGraphNodeTypeKernel;
  }
  *n = kernels;
  return (int)cudaSuccess;
}

}  // extern "C"
