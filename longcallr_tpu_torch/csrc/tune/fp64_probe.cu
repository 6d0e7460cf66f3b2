// Rates of the card that the cols walk's design rests on, kept for
// measurement only (experiments/torch_cols_variants.py --rates builds and
// times it; the package never loads this file):
//   fma_chains<ILP>: each thread ILP independent f64 fma chains, n steps;
//   lds_pairs<MODE>: each thread reads a double2 from shared memory and
//     adds it into two chains, n times; MODE 0: every thread of a warp the
//     same address, 1: eight addresses (one per quarter-warp pair of
//     threads... a quarter-warp shares one), 2: 32 addresses.

#include <cuda_runtime.h>

namespace {

template <int ILP>
__global__ void __launch_bounds__(256) fma_chains(double* out, int n,
                                                  double a) {
  double acc[ILP];
#pragma unroll
  for (int i = 0; i < ILP; ++i) acc[i] = threadIdx.x + i;
  for (int it = 0; it < n; ++it)
#pragma unroll
    for (int i = 0; i < ILP; ++i) acc[i] = fma(acc[i], a, 1.0);
  double s = 0.0;
#pragma unroll
  for (int i = 0; i < ILP; ++i) s += acc[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <int MODE>
__global__ void __launch_bounds__(256) lds_pairs(double* out, int n) {
  __shared__ double2 buf[256];
  buf[threadIdx.x] = make_double2(threadIdx.x, 1.0);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int at = MODE == 0 ? 0 : MODE == 1 ? lane / 4 : lane;
  double a0 = 0.0, a1 = 0.0, a2 = 0.0, a3 = 0.0;
  for (int it = 0; it < n; ++it) {
    const double2 v = buf[(at + it) & 255];
    a0 = fma(v.x, 1.000001, a0);
    a1 = fma(v.y, 1.000001, a1);
    a2 = fma(v.x, 0.999999, a2);
    a3 = fma(v.y, 0.999999, a3);
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] = a0 + a1 + a2 + a3;
}

}  // namespace

extern "C" int fp64_probe(int which, double* out, int blocks, int n,
                          void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (which) {
    case 1: fma_chains<1><<<blocks, 256, 0, st>>>(out, n, 1.0000001); break;
    case 2: fma_chains<2><<<blocks, 256, 0, st>>>(out, n, 1.0000001); break;
    case 4: fma_chains<4><<<blocks, 256, 0, st>>>(out, n, 1.0000001); break;
    case 8: fma_chains<8><<<blocks, 256, 0, st>>>(out, n, 1.0000001); break;
    case 16: fma_chains<16><<<blocks, 256, 0, st>>>(out, n, 1.0000001); break;
    case 100: lds_pairs<0><<<blocks, 256, 0, st>>>(out, n); break;
    case 101: lds_pairs<1><<<blocks, 256, 0, st>>>(out, n); break;
    case 102: lds_pairs<2><<<blocks, 256, 0, st>>>(out, n); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
