// Split-Dp matvecs of the phasing ascent, written by hand for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of longcallr_tpu/phasing/pallas_kernels.py:
//   dual_matvec_rows (:190-227, body _rows_kernel :136-157)  -> split_dual_matvec_rows
//   matvec_cols      (:230-265, body _cols_kernel :160-179)  -> split_matvec_cols
//                                                                split_matvec_cols_walk
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
// What bounds both: device memory, as a rule. Each cell is read once (8 bytes
// of hi+lo) for about 4 flops, far below the H100's f64 ridge point; there is
// no use for tensor cores (the operand has 1 or 2 columns) and none for TF32.
// Where members share a table, the cols contraction is 2·I flops per 8 bytes
// of σ: 4 flop/B at I = 16, below the f64 ridge of about 10 flop/B (33.5
// TFLOP/s over 3.35 TB/s). wgmma has no f64, and DMMA (mma.sync f64) would not
// move a byte bound; it would also sum inside the instruction in an order of
// its own, where the walk below fixes its order row by row. Measured, the walk
// is bound by its shared-memory traffic rather than by device memory (PERF.md,
// Findings, the cols walk).
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
// cols, I <= 32 (the walk; the enumeration path: I = 8 or 16, 2 to 1,024
// members per table, and regions of up to 32 SNPs): a block walks mb members
// of ONE table and reads the table once, not once a member. The grid is
// (chunks of a table's members, tables); the caller cuts a table's members
// into about as many chunks as fill the card, and more than 65,535 tables go
// in further launches. The table streams through shared memory in stages of
// 64-row tiles: bulk copies (cp.async.bulk with an mbarrier a buffer; 4- and
// 8-byte cp.async where the operands are not aligned for them) bring a stage's
// hi, lo and the members' σ ([member][row], two pad doubles a member, so that
// members fall on different banks) while an earlier stage is widened once to
// f64 and summed. A thread keeps V columns of R members in f64 registers
// (each row pair it reads serves R members); the threads of a way sum chains
// of 16 rows, each an fma chain from 0 in row order, and the chains are added
// into tiles of 64 rows and the tiles into the sums in row order, by the
// thread itself where the block has one way, else by one thread a (member,
// column) from the chain partials in shared memory. No shuffle, no tree, no
// ticket, no workspace. A launch whose plan has one member a block (one
// member per table) takes the direct form: a cluster of up to 16 CTAs
// splits the member's rows into stages, a stage a CTA, each copied whole
// (one bulk copy a table, so that its bytes are all in flight at once) and
// summed as the staged walk sums a stage, and the tiles' partials are
// gathered in the shared memory of the cluster's first CTA, which adds them
// in row order. (A table's last chunk of one member, in a launch of more
// members a block, stays in the staged kernel.) The order of a
// member's sum depends on K alone (chains, tiles, sums): not on g, the
// member's place, the block, the form or the plan, so a member's result among
// g is its result alone on its table, bit for bit, and two launches are
// bit-identical.
//
// cols, I > 32 (the strip; iterative buckets, one member per table as a rule):
// one launch. A block of 256 threads is TX column threads by 256/TX row
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

#include <atomic>
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
constexpr int kWalkMaxI = 32;        // widest table the cols walk takes
// the walk's order: a member's chains of 16 rows, each an fma chain from 0,
// added in row order into tiles of 64 rows, the tiles added in row order
constexpr int kWalkChain = 16;
constexpr int kWalkTile = 64;
constexpr int kWalkThreads = 256;    // most threads of a cols walk block
constexpr int kWalkMaxBufs = 4;      // most stage buffers of a walk block
constexpr int kWalkOuts = 16;        // most sums a thread folds (mb*I/threads)
constexpr int kWalkMaxCluster = 16;  // most CTAs of a direct form's cluster
// the direct form's static shared memory: a chain's partials for each
// thread (V <= 2 columns), and a round's tiles for each CTA of a cluster
constexpr int kWalkDirectPartials = kWalkThreads * 2;
constexpr int kWalkDirectTiles = kWalkMaxCluster * kWalkDirectPartials / 4;
// ... and an mbarrier for each tile of a stage (at most a way a thread)
constexpr int kWalkDirectBars = kWalkThreads / 4;

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

// ---------------------------------------------------------------------------
// cols, walk: a block walks mb members of one table (I <= kWalkMaxI)
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   smem_addr(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)), "l"(src) : "memory");
}
// the mbarrier counts one arrival once this thread's cp.asyncs are done
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               unsigned bytes) {
  asm volatile(
      "{\n\t.reg .b64 state;\n\t"
      "mbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n\t}\n" ::"r"(
          smem_addr(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "LAB_WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n\t"
      "@!p bra LAB_WAIT;\n\t}\n" ::"r"(smem_addr(bar)), "r"(parity) : "memory");
}
// bytes (a multiple of 16, both ends 16-byte aligned) from device memory
// into this block's shared memory; the mbarrier counts them in
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)), "l"(src), "r"(bytes),
      "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// every thread of every CTA of the cluster; orders shared memory accesses
// before it against those after it, across the cluster
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n\t"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// v into CTA rank's shared memory, at p's offset
__device__ __forceinline__ void store_remote(double* p, unsigned rank,
                                             double v) {
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote)
               : "r"(smem_addr(p)), "r"(rank));
  asm volatile("st.shared::cluster.f64 [%0], %1;\n" ::"r"(remote), "d"(v)
               : "memory");
}

__host__ __device__ inline size_t round_even(size_t n) {
  return (n + 1) & ~(size_t)1;
}

// The walk's dynamic shared memory, offsets in doubles (each a multiple of
// 16 bytes): the stage's rows widened to f64, [SR][I]; the chain partials,
// [stage chains][mb * I + 2] (the two pad doubles put neighbouring chains
// on different banks), where the block has more than one way; per stage
// buffer the members' σ, [mb][SR + 2] (so too for members), and the raw
// f32 rows, hi [SR][I] then lo; and one mbarrier a buffer. SR: the rows of
// a stage, K itself (rounded up to even) where one stage holds it; nb: the
// stage buffers, no more than there are stages. widened: false where the
// rows are summed from their raw f32 values (the direct form), with no
// widened copy.
struct WalkLayout {
  int SR, SST, nb;
  size_t d, pt, pts, buf0, buf, raw, bar, total;
  __host__ __device__ WalkLayout(int K, int I, int mb, int ways,
                                 int stage_tiles, int bufs,
                                 bool widened = true) {
    SR = stage_tiles * kWalkTile;
    if (K <= SR) SR = (int)round_even((size_t)K);
    SST = SR + 2;
    nb = min(bufs, (K + SR - 1) / SR);
    d = 0;
    pt = widened ? round_even((size_t)SR * I) : 0;
    pts = (size_t)mb * I + 2;
    const size_t chains = (size_t)stage_tiles * (kWalkTile / kWalkChain);
    buf0 = pt + (ways > 1 ? round_even(chains * pts) : 0);
    raw = (size_t)mb * SST;                    // within a buffer
    buf = raw + round_even((size_t)SR * I);    // a buffer's doubles
    bar = buf0 + nb * buf;
    total = bar + round_even((size_t)nb);
  }
  __host__ __device__ size_t s(int b) const { return buf0 + b * buf; }
  __host__ __device__ size_t rw(int b) const { return buf0 + b * buf + raw; }
};

template <int V> __device__ __forceinline__ void load_cols(const double* p,
                                                           double (&a)[V]);
template <> __device__ __forceinline__ void load_cols<1>(const double* p,
                                                         double (&a)[1]) {
  a[0] = p[0];
}
template <> __device__ __forceinline__ void load_cols<2>(const double* p,
                                                         double (&a)[2]) {
  const double2 t = *reinterpret_cast<const double2*>(p);
  a[0] = t.x; a[1] = t.y;
}

template <int V, int R>
__device__ __forceinline__ void zero(double (&x)[R][V]) {
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int v = 0; v < V; ++v) x[r][v] = 0.0;
}
template <int V, int R>
__device__ __forceinline__ void add_to(double (&x)[R][V],
                                       const double (&y)[R][V]) {
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int v = 0; v < V; ++v) x[r][v] += y[r][v];
}

// Two rows into V columns of R members: each member's chain takes σ0·d0,
// then σ1·d1; the row pair is read once for the R members.
template <int V, int R>
__device__ __forceinline__ void pair_step(const double2* const (&s2)[R],
                                          int kk, const double* d, int I,
                                          double (&p)[R][V]) {
  double a0[V], a1[V];
  double2 sv[R];
#pragma unroll
  for (int r = 0; r < R; ++r) sv[r] = s2[r][kk];
  load_cols<V>(d, a0);
  load_cols<V>(d + I, a1);
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int v = 0; v < V; ++v) p[r][v] = fma(sv[r].x, a0[v], p[r][v]);
#pragma unroll
    for (int v = 0; v < V; ++v) p[r][v] = fma(sv[r].y, a1[v], p[r][v]);
  }
}

// One chain's partials for V columns of R members: its rows in order, one
// fma chain from 0 a member and column. pairs: the chain's rows / 2,
// rounded up (a row past K has σ 0 and adds an exact 0). s2[r]: member r's
// σ for the chain, two rows a read; d: the chain's first row at the
// thread's first column, rows I doubles apart.
template <int V, int R>
__device__ __forceinline__ void chain_sum(const double2* const (&s2)[R],
                                          const double* __restrict__ d, int I,
                                          int pairs, double (&p)[R][V]) {
  constexpr int kPairs = kWalkChain / 2;
  zero<V, R>(p);
  if (pairs == kPairs) {
#pragma unroll
    for (int kk = 0; kk < kPairs; ++kk)
      pair_step<V, R>(s2, kk, d + (size_t)(2 * kk) * I, I, p);
  } else {
    for (int kk = 0; kk < pairs; ++kk)
      pair_step<V, R>(s2, kk, d + (size_t)(2 * kk) * I, I, p);
  }
}

// What a walk block works on: its table, its chunk of members, the shape.
struct WalkArgs {
  const float* __restrict__ ht;       // the table's hi and lo
  const float* __restrict__ lt;
  const double* __restrict__ s;       // σ of the chunk's first member
  int K, I, nvalid, bulk, tvec;
};

// Stage st's σ of the chunk's members and its raw rows into buffer b, and
// their arrival on the buffer's mbarrier: with bulk copies, one warp copies
// each member's σ rows and the two tables' rows whole (the mbarrier counts
// their bytes); else every thread copies 4 to 16 bytes at a time and
// arrives once its copies are done.
__device__ __forceinline__ void walk_issue(const WalkArgs& a,
                                           const WalkLayout& L, double* smem,
                                           uint64_t* bar, int st, int b) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int r0 = st * L.SR;
  const int rows = min(L.SR, a.K - r0);
  double* S = smem + L.s(b);
  float* rh = reinterpret_cast<float*>(smem + L.rw(b));
  float* rl = rh + (size_t)L.SR * a.I;
  const size_t at = (size_t)r0 * a.I;
  if (a.bulk) {                     // I % 4 == 0, K even, all 16-byte aligned
    if (tid >= 32) return;
    const unsigned tb = (unsigned)rows * a.I * 4;
    if (tid == 0) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_expect_tx(bar + b, 2 * tb + (unsigned)a.nvalid * rows * 8);
    }
    __syncwarp();
    if (tid == 0) bulk_copy(rh, a.ht + at, tb, bar + b);
    if (tid == 1) bulk_copy(rl, a.lt + at, tb, bar + b);
    for (int j = tid; j < a.nvalid; j += 32)
      bulk_copy(S + (size_t)j * L.SST, a.s + (size_t)j * a.K + r0,
                (unsigned)rows * 8, bar + b);
    return;
  }
  for (int e = tid; e < a.nvalid * rows; e += nt) {
    const int j = e / rows, r = e - j * rows;
    cp_async8(S + (size_t)j * L.SST + r, a.s + (size_t)j * a.K + r0 + r);
  }
  const int n = rows * a.I;
  if (a.tvec) {                                 // I % 4 == 0, aligned tables
    for (int e = tid; e < n / 4; e += nt) {
      cp_async16(rh + 4 * e, a.ht + at + 4 * e);
      cp_async16(rl + 4 * e, a.lt + at + 4 * e);
    }
  } else {
    for (int e = tid; e < n; e += nt) {
      cp_async4(rh + e, a.ht + at + e);
      cp_async4(rl + e, a.lt + at + e);
    }
  }
  cp_async_arrive(bar + b);
}

// The stage's raw rows widened once into D; an odd last row's pair partner
// is 0, in D and in each member's σ.
__device__ __forceinline__ void walk_widen(const WalkArgs& a,
                                           const WalkLayout& L, double* smem,
                                           int b, int rows) {
  const int tid = threadIdx.x, nt = blockDim.x;
  double* D = smem + L.d;
  const float* rh = reinterpret_cast<const float*>(smem + L.rw(b));
  const float* rl = rh + (size_t)L.SR * a.I;
  if (a.I % 4 == 0) {
    for (int e = tid; e < rows * a.I / 4; e += nt) {
      const float4 h = reinterpret_cast<const float4*>(rh)[e];
      const float4 l = reinterpret_cast<const float4*>(rl)[e];
      double2* dst = reinterpret_cast<double2*>(D) + 2 * e;
      dst[0] = make_double2((double)h.x + (double)l.x,
                            (double)h.y + (double)l.y);
      dst[1] = make_double2((double)h.z + (double)l.z,
                            (double)h.w + (double)l.w);
    }
  } else {
    for (int e = tid; e < rows * a.I; e += nt)
      D[e] = (double)rh[e] + (double)rl[e];
  }
  if (rows & 1) {
    for (int e = tid; e < a.I; e += nt) D[(size_t)rows * a.I + e] = 0.0;
    for (int j = tid; j < a.nvalid; j += nt)
      smem[L.s(b) + (size_t)j * L.SST + rows] = 0.0;
  }
}

// The ways' chain partials of a stage, [chains][stride], added into tiles
// and the tiles into the sums, in row order: every thread folds the sums o
// = tid, tid + threads, ... (member o / I, column o % I), up to kWalkOuts
// of them.
__device__ __forceinline__ void walk_combine(const double* PT, int chains,
                                             size_t stride, int n_out,
                                             double (&tot)[kWalkOuts]) {
  constexpr int kChains = kWalkTile / kWalkChain;
#pragma unroll
  for (int q = 0; q < kWalkOuts; ++q) {
    const int o = threadIdx.x + q * blockDim.x;
    if (o >= n_out) break;
    for (int x0 = 0; x0 < chains; x0 += kChains) {
      double tile = 0.0;
      for (int x = x0; x < min(chains, x0 + kChains); ++x)
        tile += PT[x * stride + o];
      tot[q] += tile;
    }
  }
}

// grid (chunks of a table's members, tables t0 .. t0 + gridDim.y - 1); a
// block of ways * mb/R * I/V threads walks the mb members of its chunk.
// Thread (w, jg, c): way w; members jg, jg + mb/R, ... (R of them);
// columns c*V .. c*V+V-1. The table streams through shared memory a stage
// of stage_tiles tiles at a time into nb buffers, the copies of the next
// nb - 1 stages in flight while one is widened and summed; way w sums
// chains w, w + ways, ... of each stage. With one way a thread adds its
// chains into tiles and the tiles into its sums; with more, the chain
// partials go to shared memory and every thread folds some (member,
// column) sums, in row order. MODE is 0 here; the parts that
// csrc/tune/cols_walk_parts.cu times leave work out (MODE 1: no sums; 2:
// copies only; 3: no copies and no widening after the first stage; 4: the
// launch and the mbarriers' set-up), and their results are not the
// contraction.
template <int V, int R, int MODE = 0>
__global__ void __launch_bounds__(kWalkThreads)
cols_walk_kernel(const float* __restrict__ hi, const float* __restrict__ lo,
                 int g, const double* __restrict__ s,
                 double* __restrict__ out, int K, int I, int mb, int ways,
                 int stage_tiles, int bufs, int bulk, int tvec, int t0) {
  constexpr int kChains = kWalkTile / kWalkChain;
  extern __shared__ __align__(16) double walk_smem[];
  const WalkLayout L(K, I, mb, ways, stage_tiles, bufs);
  const int cg = I / V;
  const int mg = mb / R;
  const int tid = threadIdx.x;
  const int c = tid % cg;
  const int jg = (tid / cg) % mg;
  const int w = tid / (cg * mg);
  const int table = t0 + blockIdx.y;
  const int j0 = blockIdx.x * mb;
  const size_t first = (size_t)table * g + j0;   // the chunk's first member
  WalkArgs a;
  a.ht = hi + (size_t)table * K * I;
  a.lt = lo + (size_t)table * K * I;
  a.s = s + first * K;
  a.K = K;
  a.I = I;
  a.nvalid = min(mb, g - j0);
  a.bulk = bulk;
  a.tvec = tvec;
  const double* D = walk_smem + L.d;
  double* PT = walk_smem + L.pt;
  uint64_t* bar = reinterpret_cast<uint64_t*>(walk_smem + L.bar);
  const int n_stages = (K + L.SR - 1) / L.SR;

  if (tid == 0) {
    for (int b = 0; b < L.nb; ++b) mbar_init(bar + b, bulk ? 1 : blockDim.x);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (MODE == 4) return;
  for (int st = 0; st < (MODE == 3 ? 1 : L.nb); ++st)
    walk_issue(a, L, walk_smem, bar, st, st);

  // one way: the sums by the thread that computes them; more: by (member,
  // column), folded from the chain partials (walk_combine)
  double tot[R][V], tile[R][V], sums[kWalkOuts];
  zero<V, R>(tot);
  zero<V, R>(tile);
#pragma unroll
  for (int q = 0; q < kWalkOuts; ++q) sums[q] = 0.0;
  for (int st = 0; st < n_stages; ++st) {
    const int b = MODE == 3 ? 0 : st % L.nb;
    if (MODE != 3 || st == 0) mbar_wait(bar + b, (unsigned)(st / L.nb) & 1u);
    const int rows = min(L.SR, K - st * L.SR);
    const int chains = (rows + kWalkChain - 1) / kWalkChain;
    if (MODE != 2 && (MODE != 3 || st == 0))
      walk_widen(a, L, walk_smem, b, rows);
    __syncthreads();
    const double* Sb = walk_smem + L.s(b);
    for (int x = w; x < (MODE == 1 || MODE == 2 ? 0 : chains); x += ways) {
      const double2* s2[R];
#pragma unroll
      for (int r = 0; r < R; ++r)
        s2[r] = reinterpret_cast<const double2*>(
            Sb + (size_t)(jg + r * mg) * L.SST + x * kWalkChain);
      double part[R][V];
      const int pairs = (min(kWalkChain, rows - x * kWalkChain) + 1) / 2;
      chain_sum<V, R>(s2, D + (size_t)x * kWalkChain * I + c * V, I, pairs,
                      part);
      if (ways == 1) {              // chains into the tile, tiles into tot
        add_to<V, R>(tile, part);
        if (x % kChains == kChains - 1 || x == chains - 1) {
          add_to<V, R>(tot, tile);
          zero<V, R>(tile);
        }
      } else {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          double* p = PT + x * L.pts + (size_t)(jg + r * mg) * I + c * V;
#pragma unroll
          for (int v = 0; v < V; ++v) p[v] = part[r][v];
        }
      }
    }
    // every thread is done with D, with buffer b and with the partials
    __syncthreads();
    if (ways > 1) walk_combine(PT, chains, L.pts, a.nvalid * I, sums);
    if (MODE != 3 && st + L.nb < n_stages)
      walk_issue(a, L, walk_smem, bar, st + L.nb, b);
  }
  if (ways > 1) {
#pragma unroll
    for (int q = 0; q < kWalkOuts; ++q) {
      const int o = tid + q * blockDim.x;
      if (o >= a.nvalid * I) break;
      out[first * I + o] = sums[q];
    }
    return;
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (jg + r * mg >= a.nvalid) continue;
    double* o = out + (first + jg + r * mg) * I + c * V;
#pragma unroll
    for (int v = 0; v < V; ++v) o[v] = tot[r][v];
  }
}

// A stage of the direct form by tiles (bulk copies only): lane t of warp 0
// copies tile t's hi, lo and σ rows onto tile t's mbarrier, so that the
// ways of a tile start on it as soon as it is in, while later tiles are
// still on their way.
__device__ __forceinline__ void direct_issue(const WalkArgs& a,
                                             const WalkLayout& L,
                                             double* smem, uint64_t* tbar,
                                             int st, int rows) {
  if (threadIdx.x >= 32) return;
  const size_t r0 = (size_t)st * L.SR;
  double* S = smem + L.s(0);
  float* rh = reinterpret_cast<float*>(smem + L.rw(0));
  float* rl = rh + (size_t)L.SR * a.I;
  for (int t = threadIdx.x; t * kWalkTile < rows; t += 32) {
    const int n = min(kWalkTile, rows - t * kWalkTile);
    const size_t at = (size_t)t * kWalkTile * a.I;   // within the stage
    const unsigned tb = (unsigned)n * a.I * 4;
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_expect_tx(tbar + t, 2 * tb + (unsigned)n * 8);
    bulk_copy(rh + at, a.ht + r0 * a.I + at, tb, tbar + t);
    bulk_copy(rl + at, a.lt + r0 * a.I + at, tb, tbar + t);
    bulk_copy(S + t * kWalkTile, a.s + r0 + t * kWalkTile, (unsigned)n * 8,
              tbar + t);
  }
}

// One chain of the direct form straight from a stage's raw rows: its n <=
// 16 rows in order, each widened as walk_widen widens it, one fma chain
// from 0 (the bits chain_sum gives from the widened rows). S: the chain's
// σ; rh, rl: its first row's hi and lo at the thread's first column, rows
// I floats apart.
template <int V>
__device__ __forceinline__ void raw_chain(const double* S, const float* rh,
                                          const float* rl, int I, int n,
                                          double (&p)[V]) {
#pragma unroll
  for (int v = 0; v < V; ++v) p[v] = 0.0;
  auto row = [&](int j) {
#pragma unroll
    for (int v = 0; v < V; ++v)
      p[v] = fma(S[j], (double)rh[j * I + v] + (double)rl[j * I + v], p[v]);
  };
  if (n == kWalkChain) {
#pragma unroll
    for (int j = 0; j < kWalkChain; ++j) row(j);
  } else {
    for (int j = 0; j < n; ++j) row(j);
  }
}

// One member at a time (launches whose plan has mb = 1: one member per
// table). A cluster of cl CTAs splits the member's rows: CTA r takes stages
// r, r + cl, ... of ways * 16 rows (WalkLayout with ways / 4 tiles a stage,
// one buffer and no widened copy), copies each into its shared memory whole
// (direct_issue: bulk copies a tile, so that all of a stage's bytes are in
// flight at once and a tile is summed as soon as it is in; walk_issue where
// the operands are not aligned for them); thread (w, c) sums
// chain w of the stage from the raw rows (raw_chain: each cell is read once,
// so it is widened where it is used), the first thread of each tile adds
// the tile's chains into its partial and stores it into CTA 0's shared
// memory, and CTA 0 adds a round's tiles into the sum in row order: the
// staged walk's order, so the same bits. grid (the table's
// members * cl, tables t0 .. t0 + gridDim.y - 1), member blockIdx.x / cl; a
// block of ways * I/V threads, ways a multiple of a tile's chains.
template <int V>
__global__ void __launch_bounds__(kWalkThreads)
cols_walk_direct_kernel(const float* __restrict__ hi,
                        const float* __restrict__ lo, int g,
                        const double* __restrict__ s,
                        double* __restrict__ out, int K, int I, int ways,
                        int bulk, int tvec, int cl, int t0) {
  constexpr int kChains = kWalkTile / kWalkChain;
  extern __shared__ __align__(16) double walk_smem[];
  __shared__ double pt[kWalkDirectPartials];      // the chains' partials
  __shared__ double tp[kWalkDirectTiles];         // the round's tiles
  __shared__ uint64_t tbar[kWalkDirectBars];      // a tile's mbarrier
  const int tpc = ways / kChains;                 // tiles a stage
  const WalkLayout L(K, I, 1, 1, tpc, 1, false);
  const int cg = I / V;
  const int tid = threadIdx.x;
  const int c = tid % cg;
  const int w = tid / cg;
  const unsigned rank = cl > 1 ? cluster_rank() : 0;
  const size_t table = t0 + blockIdx.y;
  const size_t m = table * g + blockIdx.x / cl;
  WalkArgs a;
  a.ht = hi + table * K * I;
  a.lt = lo + table * K * I;
  a.s = s + m * K;
  a.K = K;
  a.I = I;
  a.nvalid = 1;
  a.bulk = bulk;
  a.tvec = tvec;
  const float* rh = reinterpret_cast<const float*>(walk_smem + L.rw(0));
  const float* rl = rh + (size_t)L.SR * I;
  uint64_t* bar = reinterpret_cast<uint64_t*>(walk_smem + L.bar);
  const int n_stages = (K + L.SR - 1) / L.SR;
  const int n_chains = (K + kWalkChain - 1) / kWalkChain;

  if (tid == 0) {
    if (bulk)
      for (int t = 0; t < tpc; ++t) mbar_init(tbar + t, 1);
    else
      mbar_init(bar, blockDim.x);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  double tot[V];
#pragma unroll
  for (int v = 0; v < V; ++v) tot[v] = 0.0;
  unsigned parity = 0;
  for (int q = 0; q < n_stages; q += cl) {      // a round: cl stages
    const int st = q + (int)rank;
    const int rows = st < n_stages ? min(L.SR, K - st * L.SR) : 0;
    const int chains = (rows + kWalkChain - 1) / kWalkChain;
    if (rows > 0) {
      if (bulk) {                       // a way waits for its tile only
        direct_issue(a, L, walk_smem, tbar, st, rows);
        if (w < chains) mbar_wait(tbar + w / kChains, parity);
      } else {
        walk_issue(a, L, walk_smem, bar, st, 0);
        mbar_wait(bar, parity);
      }
      parity ^= 1u;
    }
    if (w < chains) {
      const size_t at = (size_t)w * kWalkChain * I + c * V;
      double part[V];
      raw_chain<V>(walk_smem + L.s(0) + w * kWalkChain, rh + at, rl + at, I,
                   min(kWalkChain, rows - w * kWalkChain), part);
#pragma unroll
      for (int v = 0; v < V; ++v) pt[w * I + c * V + v] = part[v];
    }
    __syncthreads();
    if (w % kChains == 0 && w < chains) {       // the tile's chains in order
      double tile[V];
#pragma unroll
      for (int v = 0; v < V; ++v) tile[v] = 0.0;
      for (int x = w; x < min(w + kChains, chains); ++x)
#pragma unroll
        for (int v = 0; v < V; ++v) tile[v] += pt[x * I + c * V + v];
      double* dst = tp + ((int)rank * tpc + w / kChains) * I + c * V;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        if (cl > 1)
          store_remote(dst + v, 0, tile[v]);
        else
          dst[v] = tile[v];
      }
    }
    if (cl > 1)
      cluster_sync();
    else
      __syncthreads();
    if (rank == 0 && w == 0) {          // the round's tiles, in row order
      const int n = min((n_chains - q * ways + kChains - 1) / kChains,
                        cl * tpc);
      for (int u = 0; u < n; ++u)
#pragma unroll
        for (int v = 0; v < V; ++v) tot[v] += tp[u * I + c * V + v];
    }
    if (q + cl >= n_stages) break;      // CTA 0 reads only its own tp
    if (cl > 1)                         // tp, D and the buffer are free
      cluster_sync();
    else
      __syncthreads();
  }
  if (rank == 0 && w == 0) {
    double* o = out + m * I + c * V;
#pragma unroll
    for (int v = 0; v < V; ++v) o[v] = tot[v];
  }
}

// The dynamic shared memory granted to each staged walk kernel, per device
// (index: rm 1, 2, 4 by vec 1, 2, then the direct form by vec 1, 2).
constexpr int kMaxDevices = 64;
std::atomic<int> g_walk_granted[kMaxDevices][8];
// the direct form's clusters of more than 8 CTAs allowed, per device (index:
// vec 1, 2)
std::atomic<int> g_walk_wide_cluster[kMaxDevices][2];

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

// The cols walk for tables of I <= 32 columns. hi, lo and g as above; s: f64
// [B,K] contiguous, 8-byte aligned; out: f64 [B,I]. vec: columns per thread
// (1 or 2, dividing I). mb members of one table a block: mb > 1 is the
// staged walk, a block of ways * mb/rm * I/vec threads (at most 256; rm:
// members a thread, 1, 2 or 4, dividing mb; ways: at most 4 * stage_tiles,
// a way a chain of 16 rows at a time, and with more than one way each
// thread folds at most 16 of the mb * I sums) in stages of 64 *
// stage_tiles rows through bufs stage buffers (1 to 4); mb = 1 is the
// direct form, clusters of cl CTAs (a power of 2 up to 16), each a block of
// ways * I/vec threads (ways: the chains of a CTA's stage, a multiple of 4; rm,
// stage_tiles and bufs not read). tvec: the table may be copied 16 bytes at
// a time (I % 4 == 0, hi and lo 16-byte aligned); svec: σ too (K even, s
// 16-byte aligned); with both, the stages are bulk copies. Dynamic shared
// memory over 48 KB is granted per launch; where the card refuses it, its
// error is returned. Tables lie on grid.y, 65,535 a launch: more tables are
// as many launches on the stream. No scratch.
int split_matvec_cols_walk(const float* hi, const float* lo, int g,
                           const double* s, double* out, int B, int K, int I,
                           int vec, int rm, int mb, int ways,
                           int stage_tiles, int bufs, int cl, int tvec,
                           int svec, int device, void* stream) {
  if (g < 1 || B % g || K < 1 || I < 1 || I > kWalkMaxI || mb < 1 ||
      ways < 1 || (vec != 1 && vec != 2) || I % vec)
    return (int)cudaErrorInvalidValue;
  const int cg = I / vec;
  const bool direct = mb == 1;
  const long long threads = (long long)ways * (direct ? 1 : mb / rm) * cg;
  if (threads > kWalkThreads) return (int)cudaErrorInvalidValue;
  if (direct ? (ways % (kWalkTile / kWalkChain) != 0 ||
                (cl < 1 || cl > kWalkMaxCluster || (cl & (cl - 1))))
             : ((rm != 1 && rm != 2 && rm != 4) || mb % rm || cl != 1 ||
                stage_tiles < 1 || bufs < 1 || bufs > kWalkMaxBufs ||
                ways > stage_tiles * (kWalkTile / kWalkChain) ||
                (ways > 1 && (long long)mb * I > threads * kWalkOuts)))
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)hi | (uintptr_t)lo) % 4 ||
      ((uintptr_t)s | (uintptr_t)out) % 8)
    return (int)cudaErrorInvalidValue;
  if (tvec && (I % 4 || ((uintptr_t)hi | (uintptr_t)lo) % 16))
    return (int)cudaErrorInvalidValue;
  if (svec && (K % 2 || (uintptr_t)s % 16))
    return (int)cudaErrorInvalidValue;
  // direct: a stage of ways chains in one buffer, beside the static arrays
  const WalkLayout lay =
      direct ? WalkLayout(K, I, 1, 1, ways / (kWalkTile / kWalkChain), 1,
                          false)
             : WalkLayout(K, I, mb, ways, max(stage_tiles, 1), max(bufs, 1));
  const size_t bytes = lay.total * sizeof(double);
  const size_t fixed = direct ? (kWalkDirectPartials + kWalkDirectTiles +
                                 kWalkDirectBars) * sizeof(double)
                              : 0;
  if (bytes + fixed > (size_t)kMaxDynShared)
    return (int)cudaErrorInvalidValue;
  // direct: a cluster a member; staged: the chunks
  const unsigned chunks =
      direct ? (unsigned)g * cl : (unsigned)((g + mb - 1) / mb);
  int bulk = tvec && svec;
  OnDevice on(device);
  const int k = direct ? 6 + vec - 1 : (rm == 4 ? 2 : rm - 1) * 2 + vec - 1;
  const void* staged_fn[] = {
      (const void*)cols_walk_kernel<1, 1>, (const void*)cols_walk_kernel<2, 1>,
      (const void*)cols_walk_kernel<1, 2>, (const void*)cols_walk_kernel<2, 2>,
      (const void*)cols_walk_kernel<1, 4>, (const void*)cols_walk_kernel<2, 4>};
  const void* direct_fn[] = {(const void*)cols_walk_direct_kernel<1>,
                             (const void*)cols_walk_direct_kernel<2>};
  const void* fn = direct ? direct_fn[vec - 1] : staged_fn[k];
  if (bytes + fixed > 48 * 1024) {
    // granted once per device and kernel for the most a launch asked
    const int want = (int)bytes;
    std::atomic<int>* got = device >= 0 && device < kMaxDevices
                                ? &g_walk_granted[device][k]
                                : nullptr;
    if (!got || got->load() < want) {
      cudaError_t e = cudaFuncSetAttribute(
          fn, cudaFuncAttributeMaxDynamicSharedMemorySize, want);
      if (e != cudaSuccess) return (int)e;
      if (got) {
        int have = got->load();
        while (have < want && !got->compare_exchange_weak(have, want)) {
        }
      }
    }
  }
  if (direct && cl > 8) {
    // more than 8 CTAs a cluster is not portable: allowed once per device
    std::atomic<int>* ok = device >= 0 && device < kMaxDevices
                               ? &g_walk_wide_cluster[device][vec - 1]
                               : nullptr;
    if (!ok || !ok->load()) {
      cudaError_t e = cudaFuncSetAttribute(
          fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (e != cudaSuccess) return (int)e;
      if (ok) ok->store(1);
    }
  }
  cudaStream_t st = (cudaStream_t)stream;
  const int tables = B / g;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = (unsigned)cl;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  for (int t0 = 0; t0 < tables; t0 += kGridYZMax) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(chunks, min(tables - t0, kGridYZMax));
    cfg.blockDim = dim3((unsigned)threads);
    cfg.dynamicSmemBytes = bytes;
    cfg.stream = st;
    cfg.attrs = &cluster;
    cfg.numAttrs = cl > 1 ? 1 : 0;
    void* staged[] = {(void*)&hi, (void*)&lo, (void*)&g, (void*)&s,
                      (void*)&out, (void*)&K, (void*)&I, (void*)&mb,
                      (void*)&ways, (void*)&stage_tiles, (void*)&bufs,
                      (void*)&bulk, (void*)&tvec, (void*)&t0};
    void* one[] = {(void*)&hi, (void*)&lo, (void*)&g, (void*)&s,
                   (void*)&out, (void*)&K, (void*)&I, (void*)&ways,
                   (void*)&bulk, (void*)&tvec, (void*)&cl, (void*)&t0};
    cudaError_t e = cudaLaunchKernelExC(&cfg, fn, direct ? one : staged);
    if (e != cudaSuccess) return (int)e;
    e = cudaGetLastError();
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
