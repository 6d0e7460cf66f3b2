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
// rows: a group of L lanes (L = 4..32, chosen from I) strides one row, so a warp
// covers 32/L rows and no lane idles when I < 32; a fixed-order shuffle tree
// reduces each group.
//
// cols: one launch. A block of 256 threads is TX column threads by 256/TX row
// lanes; each thread owns VEC adjacent columns (VEC = 4: one 16-byte load of hi
// and one of lo per row; VEC = 1 for shapes that are not 16-byte aligned) and
// unrolls 4 rows, so 8 independent loads are outstanding per thread. The grid is
// (column blocks, K chunks, batch) with the K chunk sized by the caller so that
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
// device and stream, allocates nothing, and returns cudaGetLastError().

#include <cuda/atomic>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowsThreads = 256;
constexpr int kColsThreads = 256;
constexpr int kColsUnroll = 4;     // rows in flight per thread
constexpr int kColsMaxChunk = 1024;  // rows of σ staged per block

template <int L>
__global__ void __launch_bounds__(kRowsThreads)
rows_kernel(const float* __restrict__ hi, const float* __restrict__ lo,
            int g, const double* __restrict__ x,
            double* __restrict__ out, int K, int I) {
  const int lane = threadIdx.x & (L - 1);
  const int k = blockIdx.x * (kRowsThreads / L) + threadIdx.x / L;
  const int b = blockIdx.y;
  // every lane stays for the shuffles; rows past K read nothing
  const bool live = k < K;
  double acc0 = 0.0, acc1 = 0.0;
  if (live) {
    const size_t row = ((size_t)(b / g) * K + k) * I;
    const float* h = hi + row;
    const float* l = lo + row;
    const double2* xb = reinterpret_cast<const double2*>(x + (size_t)b * I * 2);
    for (int i = lane; i < I; i += L) {
      const double d = (double)h[i] + (double)l[i];
      const double2 xi = xb[i];
      acc0 += d * xi.x;
      acc1 += d * xi.y;
    }
  }
  // fixed-order tree reduction across the group's L lanes
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1) {
    acc0 += __shfl_down_sync(0xffffffffu, acc0, off, L);
    acc1 += __shfl_down_sync(0xffffffffu, acc1, off, L);
  }
  if (live && lane == 0) {
    double* o = out + ((size_t)b * K + k) * 2;
    o[0] = acc0;
    o[1] = acc1;
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
                            int I) {
  __shared__ bool is_last;
  const int cb = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
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

// grid (column blocks, K chunks, batch); block kColsThreads.
template <int VEC>
__global__ void __launch_bounds__(kColsThreads)
cols_kernel(const float* __restrict__ hi, const float* __restrict__ lo,
            int g, const double* __restrict__ s,
            double* partial, unsigned int* tickets, double* __restrict__ out,
            int K, int I, int kc, int tx_log2) {
  __shared__ double s_chunk[kColsMaxChunk];
  __shared__ double red[kColsThreads * VEC];

  const ColsBlock<VEC> t(tx_log2, I);
  const int b = blockIdx.z;
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
  cols_finish<VEC>(t, acc, red, partial, tickets, out, I);
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

// hi, lo: f32 [ceil(B/g),K,I] contiguous, member b on table b / g (g: members
// per table, >= 1); x: f64 [B,I,2] contiguous; out: f64 [B,K,2]. lanes: lanes
// per row, a power of two in 4..32.
int split_dual_matvec_rows(const float* hi, const float* lo, int g,
                           const double* x, double* out, int B, int K, int I,
                           int lanes, int device, void* stream) {
  if (g < 1) return (int)cudaErrorInvalidValue;
  OnDevice on(device);
  const int rows_per_block = kRowsThreads / lanes;
  dim3 grid((K + rows_per_block - 1) / rows_per_block, B);
  cudaStream_t st = (cudaStream_t)stream;
  switch (lanes) {
    case 4: rows_kernel<4><<<grid, kRowsThreads, 0, st>>>(hi, lo, g, x, out, K, I); break;
    case 8: rows_kernel<8><<<grid, kRowsThreads, 0, st>>>(hi, lo, g, x, out, K, I); break;
    case 16: rows_kernel<16><<<grid, kRowsThreads, 0, st>>>(hi, lo, g, x, out, K, I); break;
    case 32: rows_kernel<32><<<grid, kRowsThreads, 0, st>>>(hi, lo, g, x, out, K, I); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// hi, lo and g as above; s: f64 [B,K] contiguous; out: f64 [B,I]. vec: columns
// per thread, 4 (needs I % 4 == 0 and 16-byte aligned hi, lo) or 1; the block
// covers (1 << tx_log2) * vec columns; kc: rows per block, <= 1024. With more
// than one K chunk, partial is f64 scratch [B, ceil(K/kc), I] and tickets is
// zeroed unsigned scratch [B, column blocks] that the kernel leaves zeroed.
int split_matvec_cols(const float* hi, const float* lo, int g,
                      const double* s, double* partial, unsigned int* tickets,
                      double* out, int B, int K, int I, int vec, int tx_log2,
                      int kc, int device, void* stream) {
  if (g < 1 || kc < 1 || kc > kColsMaxChunk || tx_log2 < 0 || tx_log2 > 5)
    return (int)cudaErrorInvalidValue;
  OnDevice on(device);
  const int width = (1 << tx_log2) * vec;
  dim3 grid((I + width - 1) / width, (K + kc - 1) / kc, B);
  cudaStream_t st = (cudaStream_t)stream;
  if (vec == 4) {
    if (I % 4 || ((uintptr_t)hi | (uintptr_t)lo) % 16)
      return (int)cudaErrorInvalidValue;
    cols_kernel<4><<<grid, kColsThreads, 0, st>>>(hi, lo, g, s, partial, tickets,
                                                  out, K, I, kc, tx_log2);
  } else if (vec == 1) {
    cols_kernel<1><<<grid, kColsThreads, 0, st>>>(hi, lo, g, s, partial, tickets,
                                                  out, K, I, kc, tx_log2);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
