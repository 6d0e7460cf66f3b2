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
// A batch stride of 0 on hi/lo lets a batch of state vectors share one Dp (the
// enumeration path's configs).
//
// The TPU kernel accumulated in double-f32 (TwoSum) because its vector units have
// no f64. This card has native FP64, so each element is widened to f64 as
// (double)hi + (double)lo and the sums are kept in f64 registers: x and s hold
// values in {−1, 0, +1}, so every term is exact and only the summation order
// differs from the plain f64 contraction. Reductions run in a fixed order and no
// atomics are used, so a launch's result is bit-stable from run to run.
//
// What bounds it: device memory. Each cell is read once (8 bytes of hi+lo) for
// about 4 flops, far below the H100's f64 ridge point; there is no use for tensor
// cores (the operand has 2 columns) and none for TF32. Layout keeps the loads
// coalesced: in the rows kernel the 32 lanes of a warp stride one row; in the cols
// kernel each thread owns one column and consecutive threads read consecutive
// columns. Later work to make it fast: 16-byte vector loads, several rows per
// warp, a CUDA graph over the ascent's iterations, and matvecs that read the
// 2-byte (p, q) cells instead of the 8-byte split Dp.
//
// C interface (loaded with ctypes): each entry point launches on the given stream,
// allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowsWarps = 8;      // rows (one warp each) per block
constexpr int kColsThreads = 128;  // columns per block in the cols kernel

__global__ void rows_kernel(const float* __restrict__ hi,
                            const float* __restrict__ lo, int64_t hl_bstride,
                            const double* __restrict__ x,
                            double* __restrict__ out, int K, int I) {
  const int lane = threadIdx.x & 31;
  const int k = blockIdx.x * kRowsWarps + (threadIdx.x >> 5);
  const int b = blockIdx.y;
  if (k >= K) return;
  const size_t row = (size_t)b * hl_bstride + (size_t)k * I;
  const float* h = hi + row;
  const float* l = lo + row;
  const double2* xb = reinterpret_cast<const double2*>(x + (size_t)b * I * 2);
  double acc0 = 0.0, acc1 = 0.0;
  for (int i = lane; i < I; i += 32) {
    const double d = (double)h[i] + (double)l[i];
    const double2 xi = xb[i];
    acc0 += d * xi.x;
    acc1 += d * xi.y;
  }
  // fixed-order tree reduction across the warp
  for (int off = 16; off > 0; off >>= 1) {
    acc0 += __shfl_down_sync(0xffffffffu, acc0, off);
    acc1 += __shfl_down_sync(0xffffffffu, acc1, off);
  }
  if (lane == 0) {
    double* o = out + ((size_t)b * K + k) * 2;
    o[0] = acc0;
    o[1] = acc1;
  }
}

// pass 1: partial[b, c, i] = Σ_{k in chunk c} s[b,k]·(hi+lo)[b,k,i]
__global__ void cols_partial_kernel(const float* __restrict__ hi,
                                    const float* __restrict__ lo,
                                    int64_t hl_bstride,
                                    const double* __restrict__ s,
                                    double* __restrict__ partial, int K, int I,
                                    int kc) {
  const int i = blockIdx.x * kColsThreads + threadIdx.x;
  const int c = blockIdx.y;
  const int b = blockIdx.z;
  if (i >= I) return;
  const int k0 = c * kc;
  const int k1 = min(K, k0 + kc);
  const size_t base = (size_t)b * hl_bstride;
  const double* sb = s + (size_t)b * K;
  double acc = 0.0;
  for (int k = k0; k < k1; ++k) {
    const size_t at = base + (size_t)k * I + i;
    acc += sb[k] * ((double)hi[at] + (double)lo[at]);
  }
  partial[((size_t)b * gridDim.y + c) * I + i] = acc;
}

// pass 2: out[b, i] = Σ_c partial[b, c, i], chunks in order
__global__ void cols_combine_kernel(const double* __restrict__ partial,
                                    double* __restrict__ out, int B, int I,
                                    int nch) {
  const size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (size_t)B * I) return;
  const size_t b = t / I, i = t % I;
  const double* p = partial + b * nch * I + i;
  double acc = 0.0;
  for (int c = 0; c < nch; ++c) acc += p[(size_t)c * I];
  out[t] = acc;
}

}  // namespace

extern "C" {

// hi, lo: f32, element (b,k,i) at b*hl_bstride + k*I + i; x: f64 [B,I,2]
// contiguous; out: f64 [B,K,2].
int split_dual_matvec_rows(const float* hi, const float* lo,
                           long long hl_bstride, const double* x, double* out,
                           int B, int K, int I, void* stream) {
  dim3 grid((K + kRowsWarps - 1) / kRowsWarps, B);
  rows_kernel<<<grid, kRowsWarps * 32, 0, (cudaStream_t)stream>>>(
      hi, lo, (int64_t)hl_bstride, x, out, K, I);
  return (int)cudaGetLastError();
}

// s: f64 [B,K] contiguous; partial: f64 scratch [B, ceil(K/kc), I];
// out: f64 [B,I].
int split_matvec_cols(const float* hi, const float* lo, long long hl_bstride,
                      const double* s, double* partial, double* out, int B,
                      int K, int I, int kc, void* stream) {
  const int nch = (K + kc - 1) / kc;
  dim3 grid((I + kColsThreads - 1) / kColsThreads, nch, B);
  cols_partial_kernel<<<grid, kColsThreads, 0, (cudaStream_t)stream>>>(
      hi, lo, (int64_t)hl_bstride, s, partial, K, I, kc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t n = (size_t)B * I;
  const int threads = 256;
  cols_combine_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0,
                        (cudaStream_t)stream>>>(partial, out, B, I, nch);
  return (int)cudaGetLastError();
}

}  // extern "C"
