// Variants of the rows kernel, kept for measurement only
// (experiments/torch_rows_variants.py builds and times them beside the kernel
// of ../split_matvec.cu; the package never loads this file).
//
//   rows_members_grid: the design the package had before a block walked the
//                 members of its table: the grid is (row groups, members), a
//                 group of L lanes (4..32, from I) strides one row, and every
//                 member's blocks read their rows of the table again. The
//                 members lie on grid.y, so at most 65,535 of them.
//   rows_stream:  the wide-row stream (one member per table) with VEC cells
//                 per lane and step (4: one 16-byte load of hi and one of lo)
//                 and ROWS rows of the warp in flight at once. VEC = 1 and
//                 ROWS = 1 is the stream of the package's kernel.
//
// out = (hi + lo) x, as in ../split_matvec.cu: hi, lo f32 [B/g,K,I], x f64
// [B,I,2], out f64 [B,K,2], member b on table b / g.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <int L>
__global__ void __launch_bounds__(kThreads)
rows_members_grid(const float* __restrict__ hi, const float* __restrict__ lo,
                  int g, const double* __restrict__ x,
                  double* __restrict__ out, int K, int I) {
  const int lane = threadIdx.x & (L - 1);
  const int k = blockIdx.x * (kThreads / L) + threadIdx.x / L;
  const int b = blockIdx.y;
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

// One member per table (table b = blockIdx.y); a warp takes ROWS adjacent rows.
template <int VEC, int ROWS>
__global__ void __launch_bounds__(kThreads)
rows_stream(const float* __restrict__ hi, const float* __restrict__ lo,
            const double2* __restrict__ x, double2* __restrict__ out, int K,
            int I) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const int k0 = (blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5)) * ROWS;
  if (k0 >= K) return;
  const float* h = hi + ((size_t)b * K + k0) * I;
  const float* l = lo + ((size_t)b * K + k0) * I;
  const double2* xb = x + (size_t)b * I;
  double acc0[ROWS], acc1[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) acc0[r] = acc1[r] = 0.0;
  for (int i = lane * VEC; i < I; i += 32 * VEC) {
    float hv[ROWS][VEC], lv[ROWS][VEC];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const size_t at = (size_t)min(r, K - 1 - k0) * I + i;
      if constexpr (VEC == 4) {
        const float4 a = __ldg(reinterpret_cast<const float4*>(h + at));
        const float4 c = __ldg(reinterpret_cast<const float4*>(l + at));
        hv[r][0] = a.x; hv[r][1] = a.y; hv[r][2] = a.z; hv[r][3] = a.w;
        lv[r][0] = c.x; lv[r][1] = c.y; lv[r][2] = c.z; lv[r][3] = c.w;
      } else {
        hv[r][0] = __ldg(h + at);
        lv[r][0] = __ldg(l + at);
      }
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const double2 xi = xb[i + j];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const double d = (double)hv[r][j] + (double)lv[r][j];
        acc0[r] = fma(d, xi.x, acc0[r]);
        acc1[r] = fma(d, xi.y, acc1[r]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      acc0[r] += __shfl_down_sync(0xffffffffu, acc0[r], off);
      acc1[r] += __shfl_down_sync(0xffffffffu, acc1[r], off);
    }
    if (lane == 0 && k0 + r < K)
      out[(size_t)b * K + k0 + r] = make_double2(acc0[r], acc1[r]);
  }
}

}  // namespace

// which 0: rows_members_grid with `lanes` lanes per row (4, 8, 16 or 32) and
// g members per table; which 1..4: rows_stream for one member per table with
// (VEC, ROWS) = (1, 1), (4, 1), (1, 2), (4, 2); VEC = 4 needs I % 4 == 0 and
// 16-byte aligned hi and lo.
extern "C" int rows_variant(int which, const float* hi, const float* lo, int g,
                            const double* x, double* out, int B, int K, int I,
                            int lanes, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (B > 65535) return (int)cudaErrorInvalidValue;
  if (which == 0) {
    const int rows_per_block = kThreads / lanes;
    dim3 grid((K + rows_per_block - 1) / rows_per_block, B);
    switch (lanes) {
      case 4: rows_members_grid<4><<<grid, kThreads, 0, st>>>(hi, lo, g, x, out, K, I); break;
      case 8: rows_members_grid<8><<<grid, kThreads, 0, st>>>(hi, lo, g, x, out, K, I); break;
      case 16: rows_members_grid<16><<<grid, kThreads, 0, st>>>(hi, lo, g, x, out, K, I); break;
      case 32: rows_members_grid<32><<<grid, kThreads, 0, st>>>(hi, lo, g, x, out, K, I); break;
      default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
  }
  if (g != 1) return (int)cudaErrorInvalidValue;
  const bool vec = which == 2 || which == 4;
  const int rows = which >= 3 ? 2 : 1;
  if (vec && (I % 4 || ((uintptr_t)hi | (uintptr_t)lo) % 16))
    return (int)cudaErrorInvalidValue;
  const int per_block = (kThreads / 32) * rows;
  dim3 grid((K + per_block - 1) / per_block, B);
  const double2* x2 = reinterpret_cast<const double2*>(x);
  double2* o2 = reinterpret_cast<double2*>(out);
  if (which == 1) rows_stream<1, 1><<<grid, kThreads, 0, st>>>(hi, lo, x2, o2, K, I);
  else if (which == 2) rows_stream<4, 1><<<grid, kThreads, 0, st>>>(hi, lo, x2, o2, K, I);
  else if (which == 3) rows_stream<1, 2><<<grid, kThreads, 0, st>>>(hi, lo, x2, o2, K, I);
  else if (which == 4) rows_stream<4, 2><<<grid, kThreads, 0, st>>>(hi, lo, x2, o2, K, I);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
