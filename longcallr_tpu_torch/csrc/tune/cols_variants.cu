// Variants of the cols kernel's row stream, kept for measurement only
// (experiments/torch_cols_variants.py builds and times them beside the kernel
// of ../split_matvec.cu; the package never loads this file).
//
//   cols_cpasync: every thread copies its 4 rows of hi and lo into shared
//                 memory with cp.async (16 bytes each), waits, and reads them
//                 back — the staged form of the same single pass;
//   cols_noskip:  σ is read straight from device memory and every row is
//                 loaded whatever its σ, so the loads of hi and lo do not wait
//                 for σ.
// Both take VEC = 4 shapes only and end in the production cols_finish.
//
// Two more launches split the kernel's time into its parts (their results are
// not the contraction):
//   cols_notail:  the production row stream and the block's own reduction,
//                 the partial stored, and no ticket and no combine;
//   cols_empty:   a kernel of the same grid that does nothing.

#include "../split_matvec.cu"

#include <cuda_pipeline.h>

namespace {

constexpr int kStagedMaxChunk = 256;   // keeps cols_cpasync under 48 KB static

__global__ void __launch_bounds__(kColsThreads)
cols_cpasync(const float* __restrict__ hi, const float* __restrict__ lo,
             int64_t hl_bstride, const double* __restrict__ s, double* partial,
             unsigned int* tickets, double* __restrict__ out, int K, int I,
             int kc, int tx_log2) {
  __shared__ double s_chunk[kStagedMaxChunk];
  __shared__ double red[kColsThreads * 4];
  __shared__ float4 stage[2 * kColsUnroll * kColsThreads];   // 32 KB

  const ColsBlock<4> t(tx_log2, I);
  const int b = blockIdx.z;
  const int k0 = blockIdx.y * kc;
  const int n = min(K, k0 + kc) - k0;
  const double* sb = s + (size_t)b * K + k0;
  for (int r = threadIdx.x; r < n; r += kColsThreads) s_chunk[r] = sb[r];
  __syncthreads();

  double acc[4] = {0.0, 0.0, 0.0, 0.0};
  if (t.live) {
    const size_t base = (size_t)b * hl_bstride + (size_t)k0 * I + t.col;
    const float* h = hi + base;
    const float* l = lo + base;
    float4* mine = stage + threadIdx.x;
    for (int r0 = t.ly * kColsUnroll; r0 < n; r0 += t.ty_n * kColsUnroll) {
      double sv[kColsUnroll];
#pragma unroll
      for (int u = 0; u < kColsUnroll; ++u)
        sv[u] = (r0 + u < n) ? s_chunk[r0 + u] : 0.0;
#pragma unroll
      for (int u = 0; u < kColsUnroll; ++u) {
        if (sv[u] != 0.0) {
          __pipeline_memcpy_async(mine + (2 * u) * kColsThreads,
                                  h + (size_t)(r0 + u) * I, 16);
          __pipeline_memcpy_async(mine + (2 * u + 1) * kColsThreads,
                                  l + (size_t)(r0 + u) * I, 16);
        }
      }
      __pipeline_commit();
      __pipeline_wait_prior(0);
#pragma unroll
      for (int u = 0; u < kColsUnroll; ++u) {
        if (sv[u] != 0.0) {
          const float4 hv = mine[(2 * u) * kColsThreads];
          const float4 lv = mine[(2 * u + 1) * kColsThreads];
          acc[0] += sv[u] * ((double)hv.x + (double)lv.x);
          acc[1] += sv[u] * ((double)hv.y + (double)lv.y);
          acc[2] += sv[u] * ((double)hv.z + (double)lv.z);
          acc[3] += sv[u] * ((double)hv.w + (double)lv.w);
        }
      }
    }
  }
  cols_finish<4>(t, acc, red, partial, tickets, out, I);
}

__global__ void __launch_bounds__(kColsThreads)
cols_noskip(const float* __restrict__ hi, const float* __restrict__ lo,
            int64_t hl_bstride, const double* __restrict__ s, double* partial,
            unsigned int* tickets, double* __restrict__ out, int K, int I,
            int kc, int tx_log2) {
  __shared__ double red[kColsThreads * 4];

  const ColsBlock<4> t(tx_log2, I);
  const int b = blockIdx.z;
  const int k0 = blockIdx.y * kc;
  const int n = min(K, k0 + kc) - k0;
  const double* sb = s + (size_t)b * K + k0;

  double acc[4] = {0.0, 0.0, 0.0, 0.0};
  if (t.live) {
    const size_t base = (size_t)b * hl_bstride + (size_t)k0 * I + t.col;
    const float* h = hi + base;
    const float* l = lo + base;
    for (int r0 = t.ly * kColsUnroll; r0 < n; r0 += t.ty_n * kColsUnroll) {
      double sv[kColsUnroll];
      Cells<4> hv[kColsUnroll], lv[kColsUnroll];
#pragma unroll
      for (int u = 0; u < kColsUnroll; ++u) {
        const int r = min(r0 + u, n - 1);
        sv[u] = (r0 + u < n) ? __ldg(sb + r) : 0.0;
        hv[u].load(h + (size_t)r * I);
        lv[u].load(l + (size_t)r * I);
      }
#pragma unroll
      for (int u = 0; u < kColsUnroll; ++u)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[j] += sv[u] * ((double)hv[u].v[j] + (double)lv[u].v[j]);
    }
  }
  cols_finish<4>(t, acc, red, partial, tickets, out, I);
}

__global__ void __launch_bounds__(kColsThreads)
cols_notail(const float* __restrict__ hi, const float* __restrict__ lo,
            int64_t hl_bstride, const double* __restrict__ s, double* partial,
            int K, int I, int kc, int tx_log2) {
  __shared__ double s_chunk[kColsMaxChunk];
  __shared__ double red[kColsThreads * 4];

  const ColsBlock<4> t(tx_log2, I);
  const int b = blockIdx.z;
  const int k0 = blockIdx.y * kc;
  const int n = min(K, k0 + kc) - k0;
  const double* sb = s + (size_t)b * K + k0;
  for (int r = threadIdx.x; r < n; r += kColsThreads) s_chunk[r] = sb[r];
  __syncthreads();

  double acc[4] = {0.0, 0.0, 0.0, 0.0};
  if (t.live) {
    const size_t base = (size_t)b * hl_bstride + (size_t)k0 * I + t.col;
    const float* h = hi + base;
    const float* l = lo + base;
    for (int r0 = t.ly * kColsUnroll; r0 < n; r0 += t.ty_n * kColsUnroll) {
      double sv[kColsUnroll];
      Cells<4> hv[kColsUnroll], lv[kColsUnroll];
#pragma unroll
      for (int u = 0; u < kColsUnroll; ++u)
        sv[u] = (r0 + u < n) ? s_chunk[r0 + u] : 0.0;
#pragma unroll
      for (int u = 0; u < kColsUnroll; ++u) {
        if (sv[u] != 0.0) {
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
        for (int j = 0; j < 4; ++j)
          acc[j] += sv[u] * ((double)hv[u].v[j] + (double)lv[u].v[j]);
    }
  }
  reduce_row_lanes<4>(acc, red, t.lx, t.ly, t.ty_n, t.width);
  if (t.live && t.ly == 0) {
    double* pb = partial + ((size_t)b * gridDim.y + blockIdx.y) * I + t.col;
#pragma unroll
    for (int j = 0; j < 4; ++j) pb[j] = acc[j];
  }
}

__global__ void __launch_bounds__(kColsThreads) cols_empty() {}

}  // namespace

extern "C" int cols_variant(int which, const float* hi, const float* lo,
                            long long hl_bstride, const double* s,
                            double* partial, unsigned int* tickets,
                            double* out, int B, int K, int I, int tx_log2,
                            int kc, void* stream) {
  if (I % 4 || kc < 1 || kc > kStagedMaxChunk) return (int)cudaErrorInvalidValue;
  const int width = (1 << tx_log2) * 4;
  dim3 grid((I + width - 1) / width, (K + kc - 1) / kc, B);
  cudaStream_t st = (cudaStream_t)stream;
  if (which == 1)
    cols_cpasync<<<grid, kColsThreads, 0, st>>>(hi, lo, hl_bstride, s, partial,
                                                tickets, out, K, I, kc, tx_log2);
  else if (which == 2)
    cols_noskip<<<grid, kColsThreads, 0, st>>>(hi, lo, hl_bstride, s, partial,
                                               tickets, out, K, I, kc, tx_log2);
  else if (which == 3)
    cols_notail<<<grid, kColsThreads, 0, st>>>(hi, lo, hl_bstride, s, partial,
                                               K, I, kc, tx_log2);
  else if (which == 4)
    cols_empty<<<grid, kColsThreads, 0, st>>>();
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
