// Parts of the cols walk's time, kept for measurement only
// (experiments/torch_cols_variants.py --parts builds and times them beside
// the walk of ../split_matvec.cu; the package never loads this file). They
// are the walk kernel itself, cols_walk_kernel<V, R, MODE>, with some of its
// work left out (results not the contraction):
//   MODE 1: no sums (the stages are copied and widened);
//   MODE 2: no widening and no sums (the stages are copied only);
//   MODE 3: no copies and no widening after the first stage (every stage
//           summed from it);
//   MODE 4: the launch, the mbarriers' set-up and nothing else.

#include "../split_matvec.cu"

extern "C" int cols_walk_part(int mode, const float* hi, const float* lo,
                              int g, const double* s, double* out, int B,
                              int K, int I, int vec, int rm, int mb, int ways,
                              int stage_tiles, int bufs, void* stream) {
  const WalkLayout lay(K, I, mb, ways, stage_tiles, bufs);
  const size_t bytes = lay.total * sizeof(double);
  const int threads = ways * (mb / rm) * (I / vec);
  dim3 grid((g + mb - 1) / mb, B / g);
  cudaStream_t st = (cudaStream_t)stream;
#define PART(V, R, M)                                                       \
  if (vec == V && rm == R && mode == M) {                                   \
    cudaFuncSetAttribute(cols_walk_kernel<V, R, M>,                         \
                         cudaFuncAttributeMaxDynamicSharedMemorySize,       \
                         (int)bytes);                                       \
    cols_walk_kernel<V, R, M><<<grid, threads, bytes, st>>>(                \
        hi, lo, g, s, out, K, I, mb, ways, stage_tiles, bufs, 1, 1, 0);     \
  }
  PART(2, 4, 0) PART(2, 4, 1) PART(2, 4, 2) PART(2, 4, 3) PART(2, 4, 4)
#undef PART
  return (int)cudaGetLastError();
}
